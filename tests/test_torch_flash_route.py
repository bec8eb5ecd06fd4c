"""Which CUDA kernel the port's flash attention launches, checked on the
CPU: ``kernel_route`` for every (dtype, head dim) the wrapper takes, the
argument checks, and the per-kernel launch counters, which must not move
on CPU tensors (there the kernel path takes the plain version); and the
row error the tensor-core kernel is held to on the card.  The kernels
themselves run on the card: chip_smoke.py and tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attn import ops
from repro_torch.kernels.flash_attn.ops import flash_attention, kernel_route
from repro_torch.kernels.flash_attn.ref import BF16_ROW_TOL, row_rel_err

ROUTE = {(torch.float32, d): "tf32x3" for d in ops.HEAD_DIMS}
ROUTE.update({(torch.bfloat16, 16): "tf32x3",
              (torch.bfloat16, 32): "tf32x3",
              (torch.bfloat16, 64): "wgmma", (torch.bfloat16, 128): "wgmma",
              (torch.bfloat16, 256): "wgmma"})


@pytest.mark.parametrize("dtype,d", sorted(ROUTE, key=str))
def test_route_for_every_input_the_wrapper_takes(dtype, d):
    assert kernel_route(dtype, d) == ROUTE[(dtype, d)]


@pytest.mark.parametrize("dtype,d,match", [
    (torch.float16, 64, "dtype"), (torch.float64, 256, "dtype"),
    (torch.bfloat16, 48, "head dim"), (torch.float32, 512, "head dim"),
    (torch.bfloat16, 8, "head dim"),
])
def test_route_refuses_what_no_kernel_takes(dtype, d, match):
    with pytest.raises(ValueError, match=match):
        kernel_route(dtype, d)


def _qkv(b, s, hq, hkv, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.normal(size=(b, s, h, d)).astype(np.float32)
                         ).to(dtype) for h in (hq, hkv, hkv)]


@pytest.mark.parametrize("d", [64, 128, 256])
def test_counters_do_not_move_on_cpu_tensors(d):
    q, k, v = _qkv(1, 70, 4, 2, d, torch.bfloat16)
    before, counts = ops.launches, ops.launch_counts()
    got = flash_attention(q, k, v, window=20, use_kernel=True)
    assert ops.launches == before and ops.launch_counts() == counts
    torch.testing.assert_close(
        got, flash_attention(q, k, v, window=20, use_kernel=False),
        atol=0, rtol=0)


@pytest.mark.parametrize("dtype,d", [(torch.float32, 32),
                                     (torch.float32, 256),
                                     (torch.bfloat16, 16)])
def test_simt_routes_do_not_move_counters_on_cpu(dtype, d):
    """The ``"tf32x3"`` route (``csrc/flash_attn.cu``, once an f32-FMA
    kernel named ``"simt"``, hence the test's name)."""
    q, k, v = _qkv(2, 33, 4, 4, d, dtype)
    counts = ops.launch_counts()
    flash_attention(q, k, v, use_kernel=True)
    assert ops.launch_counts() == counts


def test_reset_sets_every_counter_to_zero():
    ops._count("wgmma")
    ops._count("tf32x3")
    assert ops.launches >= 2 and min(ops.launch_counts().values()) >= 1
    ops.reset_launches()
    assert ops.launches == 0
    assert ops.launch_counts() == {r: 0 for r in ops.ROUTES}


@pytest.mark.parametrize("dtype,d,match", [
    (torch.float16, 64, "dtype"), (torch.bfloat16, 48, "head dim"),
])
def test_wrapper_refuses_what_no_kernel_takes(dtype, d, match):
    q, k, v = _qkv(1, 16, 2, 1, d, dtype)
    with pytest.raises(ValueError, match=match):
        flash_attention(q, k, v, use_kernel=True)


def test_argument_checks_hold_for_the_wgmma_route():
    q, k, v = _qkv(1, 16, 4, 2, 64, torch.bfloat16)
    assert kernel_route(q.dtype, 64) == "wgmma"
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v,
                        use_kernel=True)
    with pytest.raises(ValueError, match="16-byte"):
        flat = torch.zeros(1 + q.numel(), dtype=q.dtype)
        flash_attention(flat[1:].view(q.shape), k, v, use_kernel=True)
    with pytest.raises(ValueError, match="share a dtype"):
        flash_attention(q, k.float(), v, use_kernel=True)
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, v, window=-1, use_kernel=True)


@pytest.mark.parametrize("d", [64, 256])
def test_row_error_reads_rounding_and_faults(d):
    """``ref.row_rel_err``, the tensor-core kernel's limit on the card:
    0 for the same output, the share of a row's norm it is off by, and
    no reading for a row of zeros in both."""
    q, k, v = _qkv(2, 130, 4, 2, d, torch.float32, seed=d)
    ref = flash_attention(q, k, v, window=30)
    assert row_rel_err(ref, ref) == 0.0
    bad = ref.clone()
    bad[1, 100:, 3] *= 1.02
    assert row_rel_err(bad, ref) == pytest.approx(0.02, rel=1e-5)
    assert row_rel_err(bad, ref) > BF16_ROW_TOL
    # a row within one bf16 rounding of the f32 one reads at most u = 2^-8
    assert row_rel_err(ref.bfloat16(), ref) <= 2.0 ** -8
    ref[0, 5, 1] = 0.0
    bad = ref.clone()
    assert row_rel_err(bad, ref) == 0.0
    bad[0, 5, 1, 0] = 1e-3
    assert row_rel_err(bad, ref) > 1.0
    assert row_rel_err(ref[:, :0], ref[:, :0]) == 0.0
