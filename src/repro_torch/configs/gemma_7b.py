"""gemma-7b  [dense] — GeGLU, head_dim=256.

28L d_model=3072 16H (GQA kv=16) d_ff=24576 vocab=256000.  [arXiv:2403.08295]
"""
from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b",
        family="dense",
        n_layers=28,
        d_model=3072,
        n_heads=16,
        n_kv_heads=16,
        head_dim=256,
        d_ff=24576,
        vocab_size=256_000,
        mlp_act="gelu",
        tie_embeddings=True,
        source="arXiv:2403.08295",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b",
        family="dense",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        head_dim=32,
        d_ff=512,
        vocab_size=512,
        mlp_act="gelu",
        tie_embeddings=True,
        q_chunk=32,
        kv_chunk=32,
        dtype="float32",
        source="arXiv:2403.08295 (reduced)",
    )
