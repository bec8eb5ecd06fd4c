"""PyTorch/CUDA port of the reference JAX package ``repro``.

Same module layout and names as ``repro`` so each part has an obvious
counterpart; imports ``torch`` and never ``jax`` or ``repro``.  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
