"""stablelm-1.6b  [dense] — MHA (kv=heads).

24L d_model=2048 32H (GQA kv=32) d_ff=5632 vocab=100352.
[hf:stabilityai/stablelm-2-1_6b]
"""
from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-1.6b",
        family="dense",
        n_layers=24,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=5632,
        vocab_size=100_352,
        source="hf:stabilityai/stablelm-2-1_6b",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-1.6b",
        family="dense",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        q_chunk=32,
        kv_chunk=32,
        dtype="float32",
        source="(reduced)",
    )
