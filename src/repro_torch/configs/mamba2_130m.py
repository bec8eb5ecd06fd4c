"""mamba2-130m  [ssm] — SSD (state-space duality), attention-free.

24L d_model=768 vocab=50280 ssm_state=128.  [arXiv:2405.21060]
d_inner = 2*d_model = 1536, head_dim 64 -> 24 SSD heads.
"""
from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m",
        family="ssm",
        n_layers=24,
        d_model=768,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab_size=50_280,
        ssm_state=128,
        ssm_expand=2,
        ssm_head_dim=64,
        layer_pattern=("mamba",) * 24,
        tie_embeddings=True,
        source="arXiv:2405.21060",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m",
        family="ssm",
        n_layers=2,
        d_model=128,
        vocab_size=512,
        ssm_state=16,
        ssm_expand=2,
        ssm_head_dim=32,
        layer_pattern=("mamba",) * 2,
        tie_embeddings=True,
        dtype="float32",
        source="arXiv:2405.21060 (reduced)",
    )
