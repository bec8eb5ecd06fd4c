"""The arithmetic of the f32 flash kernel (``csrc/flash_attn.cu``, route
``"tf32x3"``), emulated in torch on the CPU and held to the reference.

The kernel takes both products on the tensor cores in TF32: each f32
operand x is split into big = tf32(x) and small = tf32(x - big), rounded
as ``cvt.rna.tf32.f32`` does (to nearest, ties away from zero: add half a
TF32 unit, 0x1000, to the bit pattern and clear the 13 low bits), and a
product a.b is taken as small(a).big(b) + big(a).small(b) + big(a).big(b),
summed in f32.  The emulation follows the kernel's loop: key tiles of
32, scores scaled by scale * log2(e), the online softmax in base 2, P
split like any operand.  It is held to the JAX
reference's oracle at the f32 tolerance of tests/test_flash_attn.py
(2e-5) at every head dim the kernel is built for, and the same loop with
the big parts alone (plain TF32) is shown to miss that tolerance, so the
tolerance tells the two apart.  The kernel itself is held to the plain
version on the card (tests/test_torch_cuda.py, chip_smoke.py)."""
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attn.ops import flash_attention as jax_flash  # noqa: E402

from repro_torch.kernels.flash_attn import ops  # noqa: E402

TOL = 2e-5        # f32, tests/test_flash_attn.py
LOG2E = 1.4426950408889634


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` of finite f32 values: round to the nearest
    value with a 10-bit mantissa, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32(x)
    return big, tf32(x - big)


def product(a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """a @ b on TF32 parts, summed in f32: three terms, or the big parts
    alone.  A product of two TF32 values is exact in f32, so a CPU f32
    matmul of the parts is the tensor core's arithmetic up to the order
    of the f32 sums."""
    ab, a_s = split(a)
    bb, b_s = split(b)
    if terms == 1:
        return ab @ bb
    return a_s @ bb + ab @ b_s + ab @ bb


def emulate(q, k, v, window: int, terms: int = 3) -> torch.Tensor:
    """The kernel's arithmetic on q [B, S, Hq, D], k, v [B, S, Hkv, D]
    (f32); returns [B, S, Hq, D]."""
    b, s, hq, d = q.shape
    g = hq // k.shape[2]
    q, k, v = (x.movedim(2, 1) for x in (q, k.repeat_interleave(g, 2),
                                         v.repeat_interleave(g, 2)))
    tile = 32
    c = (torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
         * torch.tensor(LOG2E, dtype=torch.float32))
    pos = torch.arange(s)
    m = torch.full((b, hq, s), -math.inf)
    l = torch.zeros(b, hq, s)
    acc = torch.zeros(b, hq, s, d)
    for k0 in range(0, s, tile):
        keys = pos[k0:k0 + tile]
        sc = product(q, k[:, :, k0:k0 + tile].transpose(-1, -2), terms) * c
        keep = keys[None, :] <= pos[:, None]
        if window:
            keep &= keys[None, :] > pos[:, None] - window
        sc = sc.masked_fill(~keep, -math.inf)
        m_new = torch.maximum(m, sc.amax(-1))
        none = m_new == -math.inf          # no key of the row kept so far
        alpha = torch.where(none, 1.0, torch.exp2(m - m_new))
        p = torch.exp2(sc - torch.where(none, 0.0, m_new)[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + product(p, v[:, :, k0:k0 + tile],
                                               terms)
        m = m_new
    return (acc / l[..., None]).movedim(1, 2)


def _from_bits(u: int) -> torch.Tensor:
    return torch.tensor([u], dtype=torch.int64).to(torch.int32).view(
        torch.float32)


@pytest.mark.parametrize("bits,want", [
    (0x3F800000, 0x3F800000),   # 1.0 is a TF32 value
    (0x3F800FFF, 0x3F800000),   # below half a unit: down
    (0x3F801000, 0x3F802000),   # a tie on an even unit: away (rn: down)
    (0x3F803000, 0x3F804000),   # a tie on an odd unit: away
    (0xBF801000, 0xBF802000),   # a negative tie: away from zero
    (0x3F801001, 0x3F802000),   # above half a unit: up
    (0x3FFFF000, 0x40000000),   # the carry reaches the exponent: 2.0
    (0x00001000, 0x00002000),   # a subnormal tie
])
def test_tf32_rounds_to_nearest_ties_away(bits, want):
    got = tf32(_from_bits(bits)).view(torch.int32).item() & 0xFFFFFFFF
    assert got == want, (hex(got), hex(want))


def test_split_keeps_f32_accuracy():
    """big has a 10-bit mantissa, small takes the rest: big + small is x
    to 2^-22 of it; the big part alone is 2^-11 of it."""
    x = torch.tensor(np.random.default_rng(0).normal(size=4096)
                     .astype(np.float32))
    big, small = split(x)
    for part in (big, small):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    rel = ((big.double() + small.double() - x.double()).abs()
           / x.double().abs())
    assert float(rel.max()) <= 2.0 ** -22
    assert float(((big.double() - x.double()).abs()
                  / x.double().abs()).max()) <= 2.0 ** -11


def _inputs(d: int, seed: int):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(1, 160, h, d)).astype(np.float32)
            for h in (4, 2, 2)]


def _emulated_and_reference(d: int, window: int, terms: int):
    q, k, v = _inputs(d, seed=d + window)
    want = np.asarray(jax_flash(*(jnp.asarray(x) for x in (q, k, v)),
                                window=window, use_kernel=False))
    got = emulate(*(torch.tensor(x) for x in (q, k, v)), window, terms)
    return got.numpy(), want


@pytest.mark.parametrize("window", [0, 50])
@pytest.mark.parametrize("d", ops.HEAD_DIMS)
def test_three_term_tf32_meets_the_f32_tolerance(d, window):
    got, want = _emulated_and_reference(d, window, terms=3)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("d", [x for x in ops.HEAD_DIMS if x >= 64])
def test_plain_tf32_misses_the_f32_tolerance(d):
    got, want = _emulated_and_reference(d, 0, terms=1)
    err = float(np.abs(got - want).max())
    assert TOL < err < 1e-2, err
