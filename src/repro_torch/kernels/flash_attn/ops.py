"""Public wrapper of causal (sliding-window) flash attention.

``flash_attention`` mirrors the reference wrapper
(``repro/kernels/flash_attn/ops.py:18-37``): q ``[B, S, Hq, D]``, k and v
``[B, S, Hkv, D]``, returns ``[B, S, Hq, D]``.

* ``use_kernel=False`` — the plain version (``ref.flash_attention_ref``)
  after the reference's GQA repeat and ``[B,S,H,D] -> [B,H,S,D]`` move.
* ``use_kernel=True`` — on a CUDA tensor, a hand-written CUDA kernel,
  which reads the ``[B,S,H,D]`` tensors in place and query head h's KV
  head h // (Hq/Hkv) directly; it launches or raises, never a quiet
  fallback.  On a CPU tensor, the plain version, because the tensor
  lies on the CPU.

Two kernels compute the function; ``kernel_route(dtype, head_dim)``
picks one, by those two alone:

* ``"wgmma"`` (``csrc/flash_attn_wgmma.cu``) for bf16 at head dims 64,
  112, 128 and 256: both products on the tensor cores, K/V tiles by TMA
  in a ring of shared memory (112, zamba2-7b's head dim, in the 128
  layout with TMA's zero fill past column 112);
* ``"tf32x3"`` (``csrc/flash_attn.cu``) for f32, and for bf16 at head
  dims 16 and 32: both products on the tensor cores by ``mma.sync`` in
  three-term TF32 (each f32 operand split into a TF32 big and small part,
  three products summed in f32), which keeps f32 accuracy.

The reference's ``q_block``/``k_block``/``interpret`` are the TPU
kernel's tiling and have no meaning here; the CUDA kernels tile by
themselves and take any S.  Shape-only tensors (fake or meta, which the
dry-run traces) take the kernel path up to the launch, where a stand-in
returns the empty output and adds the call's bytes and FLOPs
(``kernels.cost.flash_cost``) to the active trace counters; a real
tensor never reaches it, and it counts no launch.  ``launches`` counts
the launches of both kernels, ``launch_counts()`` each one's; both
change only where a kernel launches.
"""
from __future__ import annotations

import math
import threading

import torch

from repro_torch.device import is_shape_only
from repro_torch.kernels import cost
from repro_torch.kernels.flash_attn.ref import flash_attention_ref

#: launches of the flash-attention kernels, both routes together
launches = 0
_counts = {"wgmma": 0, "tf32x3": 0}
_count_lock = threading.Lock()

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the kernels are compiled for
HEAD_DIMS = (16, 32, 64, 112, 128, 256)
#: head dims of the tensor-core kernel (bf16 only)
WGMMA_HEAD_DIMS = (64, 112, 128, 256)
ROUTES = tuple(_counts)


def kernel_route(dtype: torch.dtype, head_dim: int) -> str:
    """The CUDA kernel that serves inputs of ``dtype`` and ``head_dim``:
    ``"wgmma"`` for bf16 at head dims 64, 112, 128 and 256, ``"tf32x3"``
    for the rest of what the kernels take.  Raises ``ValueError`` for a
    dtype or head dim that neither kernel takes."""
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_attention kernel: dtype must be float32 or "
                         f"bfloat16, got {dtype}")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head dim must be one of "
                         f"{HEAD_DIMS}, got {head_dim}")
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "tf32x3"


def launch_counts() -> dict:
    """Launches of each kernel since the last reset, by route."""
    with _count_lock:
        return dict(_counts)


def reset_launches() -> None:
    """Set the launch counters to 0."""
    global launches
    with _count_lock:
        launches = 0
        for r in _counts:
            _counts[r] = 0


def _count(route: str) -> None:
    global launches
    with _count_lock:
        launches += 1
        _counts[route] += 1


def _check_shapes(q, k, v, window) -> None:
    def req(cond, msg):
        if not cond:
            raise ValueError(f"flash_attention: {msg}")
    req(q.dim() == 4 and k.dim() == 4 and v.dim() == 4,
        f"q, k, v must be [B, S, H, D], got {tuple(q.shape)}, "
        f"{tuple(k.shape)}, {tuple(v.shape)}")
    req(k.shape == v.shape, f"k {tuple(k.shape)} and v {tuple(v.shape)} "
        f"differ")
    b, s, hq, d = q.shape
    req(k.shape[0] == b and k.shape[1] == s and k.shape[3] == d,
        f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    req(k.shape[2] > 0 and hq % k.shape[2] == 0,
        f"query heads {hq} are not a multiple of KV heads {k.shape[2]}")
    req(window >= 0, f"window must be >= 0, got {window}")


def _check_kernel_args(q, k, v) -> str:
    """Raise on anything the kernels do not take (checked on every
    device, so the CPU tests hold the same contract as the card); returns
    ``kernel_route``'s choice."""
    def req(cond, msg):
        if not cond:
            raise ValueError(f"flash_attention kernel: {msg}")
    route = kernel_route(q.dtype, q.shape[3])
    req(k.dtype == q.dtype and v.dtype == q.dtype,
        f"q, k, v must share a dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    req(q.device == k.device == v.device,
        "all operands must be on one device")
    req(q.is_contiguous() and k.is_contiguous() and v.is_contiguous(),
        "operands must be contiguous")
    req(is_shape_only(q) or all(t.data_ptr() % 16 == 0 for t in (q, k, v)),
        "operands must start on a 16-byte boundary (the kernel loads "
        "16 bytes at a time)")
    req(q.shape[0] <= 65535 and q.shape[1] <= 65535 * 64,
        f"batch must be <= 65535 and S <= {65535 * 64}, got "
        f"{tuple(q.shape)}")
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"flash_attention kernel: unsupported device "
                         f"{q.device}")
    return route


def _plain(q, k, v, window):
    """The reference's wrapper around its oracle: GQA repeat, move heads
    in front, attend, move back."""
    hq, hkv = q.shape[2], k.shape[2]
    if hq != hkv:
        k = torch.repeat_interleave(k, hq // hkv, dim=2)
        v = torch.repeat_interleave(v, hq // hkv, dim=2)
    out = flash_attention_ref(q.movedim(2, 1), k.movedim(2, 1),
                              v.movedim(2, 1), causal=True, window=window)
    return out.movedim(1, 2)


def _launch(q, k, v, window, route):
    """Launch the kernel ``route`` names on CUDA tensors the checks have
    passed (``chip_smoke.py`` also calls it with ``"tf32x3"`` on bf16
    inputs, to time the two kernels on the same inputs)."""
    from repro_torch.kernels.flash_attn.build import load_library
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    out = torch.empty_like(q)
    if b == 0 or s == 0 or hq == 0:           # nothing to compute
        return out
    if is_shape_only(q):
        cost.note_kernel("flash_" + route, *cost.flash_cost(
            b, s, hq, hkv, d, window, q.element_size()),
            "bfloat16" if route == "wgmma" else cost.TF32X3)
        return out
    lib = load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    with torch.cuda.device(q.device):         # launch on the tensors' card
        if route == "wgmma":
            err = lib.flash_attn_wgmma_forward(
                *ptrs, b, s, hq, hkv, d, window, 1.0 / math.sqrt(d), stream)
        else:
            err = lib.flash_attn_forward(
                _DTYPE_CODE[q.dtype], *ptrs, b, s, hq, hkv, d, window,
                1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention CUDA kernel ({route}) launch failed with error "
            f"{err} (B={b}, S={s}, Hq={hq}, Hkv={hkv}, D={d}, "
            f"window={window}, dtype={q.dtype})")
    _count(route)
    return out


def flash_attention(q, k, v, *, window: int = 0, use_kernel: bool = False):
    """q: [B, S, Hq, D]; k, v: [B, S, Hkv, D] (Hq a multiple of Hkv).
    Causal, with sliding-window banding when ``window > 0`` (keys in
    (s - window, s]).  Returns [B, S, Hq, D] in q's dtype."""
    _check_shapes(q, k, v, window)
    if not use_kernel:
        return _plain(q, k, v, window)
    route = _check_kernel_args(q, k, v)
    if q.device.type == "cpu":
        return _plain(q, k, v, window)
    return _launch(q, k, v, window, route)
