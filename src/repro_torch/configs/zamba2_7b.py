"""zamba2-7b  [hybrid] — Mamba2 backbone + weight-SHARED attention blocks.

81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000 ssm_state=64.
[arXiv:2411.15242]

Zamba2's hallmark: the attention(+MLP) block's weights are SHARED across all
its applications, interleaved into the mamba2 stack.  We interleave one
shared-attn block after every 6 mamba blocks: 11 x (6 mamba + shared_attn)
+ 4 mamba = 81 layers.  The shared block's params are stored once.
"""
from repro_torch.configs.base import ModelConfig

_PATTERN = tuple((("mamba",) * 6 + ("shared_attn",)) * 11 + ("mamba",) * 4)
assert len(_PATTERN) == 81


def full_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b",
        family="hybrid",
        n_layers=81,
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,
        d_ff=14336,
        vocab_size=32_000,
        ssm_state=64,
        ssm_expand=2,
        ssm_head_dim=64,
        layer_pattern=_PATTERN,
        source="arXiv:2411.15242",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b",
        family="hybrid",
        n_layers=3,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        ssm_state=16,
        ssm_expand=2,
        ssm_head_dim=32,
        layer_pattern=("mamba", "shared_attn", "mamba"),
        q_chunk=32,
        kv_chunk=32,
        dtype="float32",
        source="arXiv:2411.15242 (reduced)",
    )
