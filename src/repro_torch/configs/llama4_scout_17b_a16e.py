"""llama4-scout-17b-a16e  [moe]  — MoE 16 experts top-1, early fusion.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048.
[hf:meta-llama/Llama-4-Scout-17B-16E]

Llama-4 uses iRoPE: 3 of every 4 layers use chunked local attention
(8192-token chunks), every 4th layer is global (NoPE).  That pattern is what
makes long_500k decode feasible (bounded KV on 3/4 of layers).
"""
from repro_torch.configs.base import ModelConfig

_PATTERN = tuple(("local", "local", "local", "attn") * 12)  # 48 layers


def full_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=202_048,
        n_experts=16,
        top_k=1,
        layer_pattern=_PATTERN,
        sliding_window=8192,
        rope_theta=500_000.0,
        source="hf:meta-llama/Llama-4-Scout-17B-16E",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        n_experts=4,
        top_k=1,
        layer_pattern=("local", "attn"),
        sliding_window=64,
        q_chunk=32,
        kv_chunk=32,
        moe_group=32,
        dtype="float32",
        source="hf:meta-llama/Llama-4-Scout-17B-16E (reduced)",
    )
