"""The check that decides ``correct``, on the CPU at a small size with the
cells' own limits: a sound run passes; the control (the reference with
its products rounded to TF32, put in the program's place) and each fault
a full-graph training cell can have, planted in the program's timed
path, fail.  The card's half (real TF32, a larger size) is in
``test_portbench_card.py``.

    PYTHONPATH=src python -m pytest -q portbench/test_portbench_check.py
"""
import pytest
import torch

from portbench import harness as H
from portbench.reference import gnn as ref

CELLS = ("gnn-papers100m.fullgraph", "gcn-ogbn-products.fullgraph")
N = 1500


def _cell(name):
    cell = H.load_cell(name)
    cell.config["n_nodes"] = N
    return cell


def _steps(cell, seed=2 ** 31 + 3):
    return H.run_cell(cell, seed, None, False, device="cpu", steps_only=True)


@pytest.mark.parametrize("name", CELLS)
def test_limits_are_set(name):
    limits = H.load_cell(name).workload["limits"]
    assert any(v is not None for v in limits.values())


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    out = _steps(_cell(name))
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    """The reference with TF32 products (rounded operands, as the card's
    TF32 path takes them) in the program's place fails the limits."""
    cell = _cell(name)
    cfg = cell.config
    host, p0 = H.make_inputs(cfg, 11, "cpu")
    edges = ref.build_edges(host.indptr, host.indices, cfg["max_degree"],
                            "cpu")
    model = H.reference_model(cfg)
    base = H.reference_readings(ref.follow(host, edges, model, cfg["plan"],
                                           p0, device="cpu"))
    ctl = H.reference_readings(ref.follow(host, edges, model, cfg["plan"],
                                          p0, precision="tf32",
                                          device="cpu"))
    ok, checks = H.judge(H.gaps(ctl, base), cell.workload["limits"])
    assert not ok, checks


def _unchanged(monkeypatch):
    """A step that returns its state unchanged."""
    from repro_torch.core import engine

    def update(opt, params, opt_state, loss, grads, inplace):
        return params, opt_state, torch.isfinite(loss)
    monkeypatch.setattr(engine, "_guarded_update", update)


def _half_batch(monkeypatch):
    """Half of the training nodes left out, the mean over the rest."""
    from repro_torch.core.engine import FullGraphSource
    bind = FullGraphSource.bind

    def half(self, *a, **kw):
        out = bind(self, *a, **kw)
        self._loss_rows = self._loss_rows[:self._loss_rows.numel() // 2]
        return out
    monkeypatch.setattr(FullGraphSource, "bind", half)


def _altered_rows(monkeypatch):
    """The aggregation kernel's output altered where it is produced:
    rows 127 mod 128 zeroed."""
    from repro_torch.core import gnn
    agg = gnn._kernel_agg

    def altered(*a, **kw):
        out = agg(*a, **kw)
        keep = torch.ones(out.shape[0], 1, dtype=out.dtype)
        keep[127::128] = 0
        return out * keep
    monkeypatch.setattr(gnn, "_kernel_agg", altered)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered_rows],
                         ids=["unchanged", "half_batch", "altered_rows"])
@pytest.mark.parametrize("name", CELLS)
def test_a_fault_in_the_timed_path_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    out = _steps(_cell(name))
    assert not out["correct"], out["checks"]


def _adam_reset(monkeypatch):
    """AdamW's moments not carried past the first update: the second
    update starts from zero moments."""
    from repro_torch.core import engine
    update = engine._guarded_update

    def reset(opt, params, opt_state, loss, grads, inplace):
        if int(opt_state["step"]) == 1:
            for tree in (opt_state["mu"], opt_state["nu"]):
                for layer in tree:
                    for m in layer.values():
                        m.zero_()
        return update(opt, params, opt_state, loss, grads, inplace)
    monkeypatch.setattr(engine, "_guarded_update", reset)


def _adam_t1(monkeypatch):
    """AdamW's step count held at 1, so every update takes the first
    one's bias correction."""
    from repro_torch.core import engine
    update = engine._guarded_update

    def held(opt, params, opt_state, loss, grads, inplace):
        opt_state["step"].zero_()
        return update(opt, params, opt_state, loss, grads, inplace)
    monkeypatch.setattr(engine, "_guarded_update", held)


@pytest.mark.parametrize("fault", [_adam_reset, _adam_t1],
                         ids=["adam_reset", "adam_t1"])
def test_a_fault_of_the_later_adamw_updates_is_not_correct(fault,
                                                           monkeypatch):
    """The first update is sound, so the first step's numbers pass; the
    losses and the change after three steps catch the fault."""
    fault(monkeypatch)
    out = _steps(_cell("gcn-ogbn-products.fullgraph"))
    checks = out["checks"]
    assert not out["correct"], checks
    for name in ("loss0_gap", "grad_gap"):
        assert checks[name]["value"] <= checks[name]["limit"], checks


def test_kept_edges_follow_the_ports_ell_with_ties():
    """The reference's re-derived ELL keeps, row by row, the same
    neighbours as the port's ``to_ell`` under a cap that cuts through
    ties of equal weight, whatever the blocks of rows."""
    import numpy as np
    from repro_torch.core.graph import to_ell
    from portbench.traffic.generator import make_graph
    host = make_graph({"avg_degree": 12.0, "homophily": 0.5,
                       "split": {"train": 1, "val": 1, "test": 1,
                                 "total": 3}},
                      3000, 4, 3, seed=5, device="cpu")
    g = H._graph(host)
    cap = 6
    idx, w, _ = to_ell(g, max_deg=cap)
    port = {(r, int(c)) for r in range(g.n) for c, x in zip(idx[r], w[r])
            if x > 0}
    edges = ref.build_edges(host.indptr, host.indices, cap, "cpu")
    crow = edges.a.crow_indices()
    rows = torch.repeat_interleave(torch.arange(g.n), crow[1:] - crow[:-1])
    kept = set(zip(rows.tolist(), edges.a.col_indices().tolist()))
    assert kept == port
    deg = np.diff(host.indptr)
    assert (deg > cap).sum() > 1000     # the cap cuts most rows
    # the choice does not depend on how the rows are blocked
    a = ref.over_cap_choice(host.indptr, host.indices, cap, block=7)
    b = ref.over_cap_choice(host.indptr, host.indices, cap)
    assert np.array_equal(np.sort(a), np.sort(b))
