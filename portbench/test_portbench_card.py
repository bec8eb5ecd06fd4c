"""The check's card half: at 262,144 nodes of each cell's configuration
(its widths, ELL cap and traffic dtype), the program's first steps pass
the cell's limits and the control, the reference with its products on
the card's TF32 path in the program's place, fails them.  Skipped
without a card.

    PYTHONPATH=src python -m pytest -q portbench/test_portbench_card.py
"""
import pytest
import torch

from portbench import harness as H
from portbench.reference import gnn as ref

CELLS = ("gnn-papers100m.fullgraph", "gcn-ogbn-products.fullgraph")
N = 262_144


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the port's kernels have no CPU mode "
                    "and TF32 is the card's)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


@pytest.mark.parametrize("name", CELLS)
def test_program_passes_and_control_fails_on_the_card(name, cuda):
    cell = H.load_cell(name)
    cfg = cell.config
    cfg["n_nodes"] = N
    seed = 2 ** 31 + 17
    out = H.run_cell(cell, seed, None, False, device=cuda, steps_only=True)
    assert out["correct"], out["checks"]
    host, p0 = H.make_inputs(cfg, seed, cuda)
    edges = ref.build_edges(host.indptr, host.indices, cfg["max_degree"],
                            cuda)
    model = H.reference_model(cfg)
    base = H.reference_readings(ref.follow(host, edges, model, cfg["plan"],
                                           p0, device=cuda))
    ctl = H.reference_readings(ref.follow(host, edges, model, cfg["plan"],
                                          p0, precision="tf32", device=cuda))
    ok, checks = H.judge(H.gaps(ctl, base), cell.workload["limits"])
    assert not ok, checks
