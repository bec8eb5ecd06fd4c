"""whisper-medium  [audio] — encoder-decoder, conv frontend (STUB).

24L d_model=1024 16H (kv=16) d_ff=4096 vocab=51865.  [arXiv:2212.04356]

Backbone only: the mel-spectrogram + conv feature extractor is a stub;
``input_specs()`` supplies precomputed frame embeddings of shape
(batch, enc_seq=1500, d_model) (whisper's 30 s @ 50 Hz post-conv frames).
Decoder self-attn + cross-attn to the encoder output.
"""
from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium",
        family="audio",
        n_layers=24,          # decoder layers
        n_enc_layers=24,      # encoder layers
        enc_seq=1500,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=4096,
        vocab_size=51_865,
        mlp_act="gelu",
        source="arXiv:2212.04356",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium",
        family="audio",
        n_layers=2,
        n_enc_layers=2,
        enc_seq=64,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        mlp_act="gelu",
        q_chunk=32,
        kv_chunk=32,
        dtype="float32",
        source="arXiv:2212.04356 (reduced)",
    )
