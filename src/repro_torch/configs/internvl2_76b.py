"""internvl2-76b  [vlm] — InternViT (STUB) + LLM backbone (implemented).

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.  [arXiv:2404.16821]

Backbone only: the InternViT-6B vision encoder + MLP projector is a stub;
``input_specs()`` supplies precomputed patch embeddings (batch, frontend_seq,
d_model) prepended to the text sequence (1024 visual tokens ~ 4 tiles x 256).
"""
from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-76b",
        family="vlm",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=28672,
        vocab_size=128_256,
        frontend_seq=1024,
        rope_theta=1_000_000.0,
        source="arXiv:2404.16821",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-76b",
        family="vlm",
        n_layers=2,
        d_model=128,
        n_heads=8,
        n_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        frontend_seq=16,
        q_chunk=32,
        kv_chunk=32,
        dtype="float32",
        source="arXiv:2404.16821 (reduced)",
    )
