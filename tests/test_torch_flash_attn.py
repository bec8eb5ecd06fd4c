"""The port's flash attention against the live reference: the grid of
tests/test_flash_attn.py (plus a window that is not a multiple of the
tile, MHA beside its GQA 4/2, and every head dim the port's kernels
take from 32 up), run through the reference wrapper's
Pallas kernel in interpret mode and its oracle, and through the port's
``flash_attention`` (on these CPU tensors the kernel path takes the
plain version) and its ``ref.py``.  Tolerances: 2e-5 (f32) and 3e-2
(bf16), those of tests/test_flash_attn.py; 3e-5 against the reference
model's chunked path.  The CUDA kernel is held against the plain version
on the card by chip_smoke.py and tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attn.ops import flash_attention as jax_flash  # noqa: E402
from repro.models.layers import chunked_causal_attention  # noqa: E402

from repro_torch.kernels.flash_attn import ops  # noqa: E402
from repro_torch.kernels.flash_attn.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attn.ref import flash_attention_ref  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

DT = {"float32": (jnp.float32, torch.float32, 2e-5),
      "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _inputs(rng, b, s, hq, hkv, d):
    return [rng.normal(size=(b, s, h, d)).astype(np.float32)
            for h in (hq, hkv, hkv)]


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol, rtol=tol)


SHAPES = [
    (128, 32, 32, 0, 4, 2),
    (128, 32, 64, 0, 4, 2),
    (256, 64, 64, 64, 4, 2),     # sliding-window banding
    (64, 64, 64, 0, 4, 2),       # single block
    (192, 64, 64, 100, 4, 2),    # window not a multiple of the tile
    (128, 32, 32, 48, 4, 4),     # MHA
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,qb,kb,window,hq,hkv,d", [
    # head dim 32 (the reference test's), then those of the port's
    # tensor-core kernel, with 16 query heads a KV head at 256
    *(pytest.param(*x, 32, id="-".join(map(str, x))) for x in SHAPES),
    *((*x, d) for d in (64, 128, 256) for x in SHAPES),
    (128, 64, 64, 0, 16, 1, 256),
])
def test_flash_matches_reference_kernel_and_oracle(s, qb, kb, window, hq,
                                                   hkv, dtype, d, rng):
    jdt, tdt, tol = DT[dtype]
    q, k, v = _inputs(rng, 2, s, hq, hkv, d)
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    ker = jax_flash(jq, jk, jv, window=window, use_kernel=True,
                    interpret=True, q_block=qb, k_block=kb)
    oracle = jax_flash(jq, jk, jv, window=window, use_kernel=False)
    tq, tk, tv = (torch.tensor(x).to(tdt) for x in (q, k, v))
    before = ops.launches
    got = flash_attention(tq, tk, tv, window=window, use_kernel=True)
    plain = flash_attention(tq, tk, tv, window=window, use_kernel=False)
    assert ops.launches == before          # CPU tensors: no launch
    assert got.dtype == tdt and got.shape == tq.shape
    for port in (got, plain):
        _close(port.float(), ker, tol)
        _close(port.float(), oracle, tol)


@pytest.mark.parametrize("window", [0, 64])
def test_ref_matches_reference_oracle_in_kernel_layout(window, rng):
    """``ref.flash_attention_ref`` itself, on [B, H, S, D]."""
    from repro.kernels.flash_attn.ref import flash_attention_ref as jax_ref
    q, k, v = (rng.normal(size=(2, 3, 96, 16)).astype(np.float32)
               for _ in range(3))
    _close(flash_attention_ref(*(torch.tensor(x) for x in (q, k, v)),
                               window=window),
           jax_ref(*(jnp.asarray(x) for x in (q, k, v)), window=window),
           2e-5)


@pytest.mark.parametrize("window", [0, 40])
def test_flash_matches_model_chunked_path(window, rng):
    """The port's flash op agrees with the reference model's
    ``chunked_causal_attention`` and with the port's copy of it."""
    q, k, v = _inputs(rng, 1, 128, 2, 2, 16)
    want = chunked_causal_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                    q_chunk=32, window=window)
    t = [torch.tensor(x) for x in (q, k, v)]
    _close(flash_attention(*t, window=window, use_kernel=True), want, 3e-5)
    _close(L.chunked_causal_attention(*t, q_chunk=32, window=window), want,
           3e-5)


def test_kernel_argument_checks_hold_on_cpu():
    q = torch.zeros(1, 16, 4, 32)
    k = torch.zeros(1, 16, 2, 32)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2),
                        k, use_kernel=True)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention(q.double(), k.double(), k.double(), use_kernel=True)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(torch.zeros(1 + q.numel())[1:].view(q.shape), k, k,
                        use_kernel=True)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(torch.zeros(1, 16, 4, 40), torch.zeros(1, 16, 2, 40),
                        torch.zeros(1, 16, 2, 40), use_kernel=True)
    with pytest.raises(ValueError, match="multiple of KV heads"):
        flash_attention(q, torch.zeros(1, 16, 3, 32),
                        torch.zeros(1, 16, 3, 32))
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, k, window=-1)
