"""The scalar-atomics variant that ``ablate_atomics`` builds beside the
backward kernel's general mode: its source differs from the checkout's
only in ``red_add``, which becomes one scalar ``atomicAdd`` a column.  The
timing itself needs the card (``python -m
repro_torch.kernels.neighbor_agg.ablate_atomics``)."""
import difflib
import os

import pytest

from repro_torch.kernels.neighbor_agg import ablate_atomics as A

BWD = os.path.join(os.path.dirname(A.__file__), "csrc", "neighbor_agg_bwd.cu")


def test_scalar_variant_rewrites_red_add_only():
    with open(BWD) as f:
        src = f.read()
    assert "atomicAdd(reinterpret_cast<float4*>" in src
    out = A.scalar_red_add_source(src)
    assert "float4" not in out.split("red_add(float* p")[1].split("\n}\n")[0]
    assert "for (int i = 0; i < V; ++i) atomicAdd(p + i, v[i]);" in out
    changed = [ln for ln in difflib.ndiff(src.splitlines(), out.splitlines())
               if ln[:1] in "+-"]
    first = src.index("void red_add(")
    body = src[first:src.index("\n}\n", first)]
    assert all(ln[2:] in body or ln[2:] in A._SCALAR for ln in changed)


@pytest.mark.parametrize("src", ["", "template <int V>\nvoid other() {}\n"])
def test_scalar_variant_refuses_a_source_without_red_add(src):
    with pytest.raises(RuntimeError, match="found 0 times"):
        A.scalar_red_add_source(src)
