"""granite-3-2b  [dense] — GQA.

40L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=49155.
[hf:ibm-granite/granite-3.0-2b-base]
"""
from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-2b",
        family="dense",
        n_layers=40,
        d_model=2048,
        n_heads=32,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=49_155,
        tie_embeddings=True,
        source="hf:ibm-granite/granite-3.0-2b-base",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-2b",
        family="dense",
        n_layers=2,
        d_model=128,
        n_heads=8,
        n_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        tie_embeddings=True,
        q_chunk=32,
        kv_chunk=32,
        dtype="float32",
        source="(reduced)",
    )
