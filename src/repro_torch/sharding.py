"""The padding rules of the reference's sharding (``repro/sharding.py:24-42``),
which fix the LM parameter shapes: the vocab is padded to a multiple of
``MODEL_PAR`` and query heads are padded when there are at least
``MODEL_PAR`` of them.  Copied, since that module imports jax; the port
has no mesh yet (slice 4), so nothing here shards."""
from __future__ import annotations

# The reference's production tensor-parallel degree.  Head and vocab dims
# are padded against it so parameter shapes equal the reference's.
MODEL_PAR = 16


def pad_to(n: int, m: int = MODEL_PAR) -> int:
    return ((n + m - 1) // m) * m


def padded_heads(n: int) -> int:
    """Query heads are padded up to a MODEL_PAR multiple when big enough to
    shard (llama4: 40 -> 48); small head counts stay as they are."""
    if n % MODEL_PAR == 0 or n < MODEL_PAR:
        return n
    return pad_to(n)
