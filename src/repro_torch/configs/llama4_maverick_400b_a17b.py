"""llama4-maverick-400b-a17b  [moe] — MoE 128 experts top-1, early fusion.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, 128e top-1.
[hf:meta-llama/Llama-4-Scout-17B-16E] (assigned citation; maverick variant)
"""
from repro_torch.configs.base import ModelConfig

_PATTERN = tuple(("local", "local", "local", "attn") * 12)  # 48 layers


def full_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=202_048,
        n_experts=128,
        top_k=1,
        layer_pattern=_PATTERN,
        sliding_window=8192,
        rope_theta=500_000.0,
        source="hf:meta-llama/Llama-4-Scout-17B-16E (maverick 128e)",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b",
        family="moe",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        n_experts=4,     # reduced (<=4 experts per smoke rules)
        top_k=1,
        layer_pattern=("local", "attn"),
        sliding_window=64,
        q_chunk=32,
        kv_chunk=32,
        moe_group=32,
        dtype="float32",
        source="(reduced)",
    )
