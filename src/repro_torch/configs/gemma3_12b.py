"""gemma3-12b  [dense] — 5:1 local:global interleave, 128k context.

48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144.
[hf:google/gemma-3-1b-pt]
head_dim=256 per the gemma3 model card (not d_model/n_heads).
sliding_window=1024 (gemma3 local layers).
"""
from repro_torch.configs.base import ModelConfig

_PATTERN = tuple(("local",) * 5 + ("attn",)) * 8  # 48 layers, 5:1


def full_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b",
        family="dense",
        n_layers=48,
        d_model=3840,
        n_heads=16,
        n_kv_heads=8,
        head_dim=256,
        d_ff=15360,
        vocab_size=262_144,
        mlp_act="gelu",
        layer_pattern=_PATTERN,
        sliding_window=1024,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        source="hf:google/gemma-3-1b-pt",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b",
        family="dense",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        mlp_act="gelu",
        layer_pattern=("local", "attn"),
        sliding_window=64,
        q_chunk=32,
        kv_chunk=32,
        tie_embeddings=True,
        dtype="float32",
        source="hf:google/gemma-3-1b-pt (reduced)",
    )
