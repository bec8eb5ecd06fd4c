"""Flash attention at head dim 112 (zamba2-7b's shared attention: 3584
/ 32 heads), which the port's kernels take since the hybrid family was
ported: the route (bf16 on the tensor-core kernel, f32 on the f32
kernel), and the port's plain version at D = 112 against the
reference's Pallas kernel in interpret mode and its oracle, as
tests/test_flash_attn.py runs them (2e-5 f32, 3e-2 bf16), GQA and MHA,
with and without a window.  On these CPU tensors the kernel path takes
the plain version and counts no launch; the CUDA kernels are held to it
at D = 112 on the card (tests/test_torch_cuda.py, chip_smoke.py phase
14)."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attn.ops import flash_attention as jax_flash  # noqa: E402
from repro.kernels.flash_attn.ref import flash_attention_ref as jax_ref  # noqa: E402

from repro_torch.kernels.flash_attn import ops  # noqa: E402
from repro_torch.kernels.flash_attn.ref import flash_attention_ref  # noqa: E402

DT = {"float32": (jnp.float32, torch.float32, 2e-5),
      "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma"),
                                         (torch.float32, "tf32x3")])
def test_head_dim_112_routes_to_a_kernel(dtype, route):
    assert 112 in ops.HEAD_DIMS
    assert ops.kernel_route(dtype, 112) == route


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,qb,kb,window,hq,hkv", [
    (128, 32, 32, 0, 4, 2), (256, 64, 64, 64, 4, 2), (192, 64, 64, 100, 4, 4),
    (64, 64, 64, 0, 8, 1),
])
def test_plain_version_at_d112_matches_reference_kernel_and_oracle(
        s, qb, kb, window, hq, hkv, dtype, rng):
    jdt, tdt, tol = DT[dtype]
    q, k, v = (rng.normal(size=(2, s, h, 112)).astype(np.float32)
               for h in (hq, hkv, hkv))
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    ker = jax_flash(jq, jk, jv, window=window, use_kernel=True,
                    interpret=True, q_block=qb, k_block=kb)
    oracle = jax_flash(jq, jk, jv, window=window, use_kernel=False)
    tq, tk, tv = (torch.tensor(x).to(tdt) for x in (q, k, v))
    counts = ops.launch_counts()
    got = ops.flash_attention(tq, tk, tv, window=window, use_kernel=True)
    plain = ops.flash_attention(tq, tk, tv, window=window, use_kernel=False)
    assert ops.launch_counts() == counts       # CPU tensors: no launch
    assert got.dtype == tdt and got.shape == tq.shape
    for port in (got, plain):
        _close(port.float(), ker, tol)
        _close(port.float(), oracle, tol)


@pytest.mark.parametrize("window", [0, 40])
def test_ref_at_d112_matches_reference_oracle_in_kernel_layout(window, rng):
    q, k, v = (rng.normal(size=(2, 3, 96, 112)).astype(np.float32)
               for _ in range(3))
    _close(flash_attention_ref(*(torch.tensor(x) for x in (q, k, v)),
                               window=window),
           jax_ref(*(jnp.asarray(x) for x in (q, k, v)), window=window),
           2e-5)
