"""The port's crash-safe checkpoint layer (``repro_torch.checkpoint``):
the reference's cases (tests/test_checkpoint.py) on trees of tensors —
manifest + checksums, atomic write order (a kill at any failpoint leaves
the directory restorable at the previous step), retention, stale-tmp GC,
the typed restore errors — and the file format shared with the live
reference: a checkpoint written by either package restores the other's
trees by leaf name, values equal."""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import (CheckpointCorruptError,
                                    CheckpointDtypeError,
                                    CheckpointKeyError,
                                    CheckpointShapeError, available_steps,
                                    latest_step, load_metadata,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.checkpoint.ckpt import MANIFEST
from repro_torch.core import faults


def _tree(seed=0, shape=(4, 3)):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.normal(size=shape).astype(np.float32)),
            "b": torch.from_numpy(
                rng.normal(size=shape[1:]).astype(np.float32))}


def _equal(a, b) -> bool:
    return torch.equal(torch.as_tensor(a), torch.as_tensor(b))


@pytest.fixture(autouse=True)
def _no_armed_failpoints():
    yield
    faults.disarm()


# ---------------------------------------------------------------------------
# Manifest + checksums
# ---------------------------------------------------------------------------

def test_manifest_records_completed_steps(tmp_path):
    d = str(tmp_path)
    for step in (1, 2, 5):
        save_checkpoint(d, step, _tree(step), {"step": step})
    assert available_steps(d) == [1, 2, 5]
    assert latest_step(d) == 5
    m = json.load(open(os.path.join(d, MANIFEST)))
    assert sorted(m["steps"]) == ["1", "2", "5"]
    for entry in m["steps"].values():
        assert len(entry["sha256"]) == 64 and entry["has_meta"]
    assert load_metadata(d) == {"step": 5}
    assert load_metadata(d, 1) == {"step": 1}


def test_restore_verifies_checksum(tmp_path):
    d = str(tmp_path)
    t = _tree()
    save_checkpoint(d, 1, t)
    path = os.path.join(d, "ckpt_00000001.npz")
    with open(path, "r+b") as f:        # flip one byte -> corrupt
        f.seek(20)
        b = f.read(1)
        f.seek(20)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(CheckpointCorruptError, match="checksum mismatch"):
        restore_checkpoint(d, t)


def test_latest_step_ignores_orphan_npz(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, _tree())
    np.savez(os.path.join(d, "ckpt_00000009.npz"), junk=np.zeros(3))
    assert latest_step(d) == 1


def test_adopts_pre_manifest_directory(tmp_path):
    d = str(tmp_path)
    t = _tree()
    save_checkpoint(d, 1, t)
    os.unlink(os.path.join(d, MANIFEST))
    assert latest_step(d) == 1                 # scan fallback
    out = restore_checkpoint(d, t)             # no recorded sha: no verify
    assert _equal(out["w"], t["w"])
    save_checkpoint(d, 2, _tree(2))
    assert available_steps(d) == [1, 2]        # step 1 adopted, not hidden


def test_tensors_are_copied_to_the_host_at_save(tmp_path):
    """An in-place update after the save (the engine's donated update)
    does not reach the file; restored tensors land on the target's
    device with its dtype, in its structure (lists and tuples kept)."""
    d = str(tmp_path)
    t = {"params": [{"w": torch.ones(2, 2, requires_grad=True)}],
         "opt_state": {"step": torch.zeros((), dtype=torch.int32),
                       "vel": ({"w": torch.full((2, 2), 3.0)},)}}
    save_checkpoint(d, 1, t)
    with torch.no_grad():
        t["params"][0]["w"].add_(5.0)
    out = restore_checkpoint(d, t)
    assert isinstance(out["params"], list)
    assert isinstance(out["opt_state"]["vel"], tuple)
    assert _equal(out["params"][0]["w"], torch.ones(2, 2))
    assert out["opt_state"]["step"].dtype == torch.int32
    with np.load(os.path.join(d, "ckpt_00000001.npz")) as z:
        assert sorted(z.files) == ["opt_state/step", "opt_state/vel/0/w",
                                   "params/0/w"]


# ---------------------------------------------------------------------------
# Typed restore errors
# ---------------------------------------------------------------------------

def test_restore_key_mismatch_names_leaves(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, _tree())
    with pytest.raises(CheckpointKeyError) as ei:
        restore_checkpoint(d, {"w": _tree()["w"], "extra": torch.zeros(2)})
    assert "extra" in str(ei.value) and "b" in str(ei.value)


def test_restore_shape_mismatch_names_leaf(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, _tree())
    bad = _tree()
    bad["w"] = torch.zeros(2, 2)
    with pytest.raises(CheckpointShapeError, match="'w'"):
        restore_checkpoint(d, bad)


@pytest.mark.parametrize("like", [np.float64, torch.float64, torch.int32])
def test_restore_dtype_mismatch_names_leaf(tmp_path, like):
    d = str(tmp_path)
    save_checkpoint(d, 1, _tree())
    bad = _tree()
    bad["b"] = (np.zeros(bad["b"].shape, like) if like is np.float64
                else torch.zeros(bad["b"].shape, dtype=like))
    with pytest.raises(CheckpointDtypeError, match="'b'"):
        restore_checkpoint(d, bad)


# ---------------------------------------------------------------------------
# Retention + tmp GC
# ---------------------------------------------------------------------------

def test_keep_last_retention(tmp_path):
    d = str(tmp_path)
    for step in range(1, 6):
        save_checkpoint(d, step, _tree(step), {"s": step}, keep_last=2)
    assert available_steps(d) == [4, 5]
    files = sorted(os.listdir(d))
    assert "ckpt_00000004.npz" in files and "ckpt_00000005.npz" in files
    assert not any(f.startswith(("ckpt_00000001", "meta_00000001",
                                 "ckpt_00000002", "ckpt_00000003"))
                   for f in files)
    out = restore_checkpoint(d, _tree(), step=4)
    assert _equal(out["w"], _tree(4)["w"])


def test_stale_tmp_gc(tmp_path):
    d = str(tmp_path)
    stale = os.path.join(d, "deadbeef.tmp")
    open(stale, "w").write("leftover")
    save_checkpoint(d, 1, _tree())
    assert not os.path.exists(stale)


# ---------------------------------------------------------------------------
# Crash failpoints: kill at every stage, directory stays consistent
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("site", ["ckpt.before_npz_rename",
                                  "ckpt.after_npz_rename",
                                  "ckpt.after_meta"])
def test_kill_mid_save_restorable_at_previous_step(tmp_path, site):
    d = str(tmp_path)
    t1, t2 = _tree(1), _tree(2)
    save_checkpoint(d, 1, t1, {"s": 1})
    with faults.armed(site):
        with pytest.raises(faults.SimulatedCrash):
            save_checkpoint(d, 2, t2, {"s": 2})
    assert latest_step(d) == 1
    out = restore_checkpoint(d, t1)
    assert _equal(out["w"], t1["w"])
    assert load_metadata(d) == {"s": 1}
    save_checkpoint(d, 2, t2, {"s": 2})
    assert latest_step(d) == 2
    assert not any(f.endswith(".tmp") for f in os.listdir(d))


def test_kill_before_rename_leaves_tmp_for_gc(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, _tree(1))
    with faults.armed("ckpt.before_npz_rename"):
        with pytest.raises(faults.SimulatedCrash):
            save_checkpoint(d, 2, _tree(2))
    assert any(f.endswith(".tmp") for f in os.listdir(d))
    save_checkpoint(d, 2, _tree(2))
    assert not any(f.endswith(".tmp") for f in os.listdir(d))


def test_corrupt_manifest_is_loud(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, _tree())
    open(os.path.join(d, MANIFEST), "w").write("{not json")
    with pytest.raises(CheckpointCorruptError, match="manifest"):
        latest_step(d)


# ---------------------------------------------------------------------------
# The format shared with the reference
# ---------------------------------------------------------------------------

def _ref_and_port_trees(optimizer):
    """The reference's initial GraphSAGE params and optimizer state after
    one update, and the port's same-structure tree (other values)."""
    jax = pytest.importorskip("jax")
    from repro.configs.base import GNNConfig as RefConfig
    from repro.core import gnn as RG
    from repro.optim import adamw as radamw, sgd as rsgd

    from repro_torch.configs.base import GNNConfig
    from repro_torch.core import gnn as TG
    from repro_torch.optim import adamw, sgd

    kw = dict(name="c", model="graphsage", n_nodes=50, feat_dim=8,
              hidden=16, n_classes=3, n_layers=2, fanout=(3, 2),
              batch_size=8, loss="ce")
    rp = RG.init_gnn(jax.random.key(0), RefConfig(**kw), 8)
    ropt = (rsgd(0.1, momentum=0.9) if optimizer == "sgd"
            else radamw(0.1))
    rstate = ropt.init(rp)
    rp, rstate = ropt.update(jax.tree.map(lambda x: x * 0.5, rp), rstate,
                             rp)
    tp = TG.init_gnn(torch.Generator().manual_seed(1), GNNConfig(**kw), 8,
                     device="cpu")
    topt = sgd(0.1, momentum=0.9) if optimizer == "sgd" else adamw(0.1)
    return ({"params": rp, "opt_state": rstate},
            {"params": tp, "opt_state": topt.init(tp)})


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_reference_checkpoint_restores_the_ports_tree(tmp_path, optimizer):
    from repro.checkpoint import save_checkpoint as ref_save
    from repro.checkpoint.ckpt import _flatten as ref_flatten

    from repro_torch.checkpoint.ckpt import _flatten_paths
    ref, port = _ref_and_port_trees(optimizer)
    ref_save(str(tmp_path), 3, ref, {"from": "reference"})
    out = restore_checkpoint(str(tmp_path), port)
    want = ref_flatten(ref)
    got = dict(_flatten_paths(out))
    assert sorted(got) == sorted(want)
    for name, v in got.items():
        assert isinstance(v, torch.Tensor)
        np.testing.assert_array_equal(v.numpy(), want[name], err_msg=name)


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_port_checkpoint_restores_the_references_tree(tmp_path, optimizer):
    from repro.checkpoint import restore_checkpoint as ref_restore
    ref, port = _ref_and_port_trees(optimizer)
    save_checkpoint(str(tmp_path), 3, port, {"from": "port"})
    out = ref_restore(str(tmp_path), ref)
    for p_ref, p_port in zip(out["params"], port["params"]):
        assert sorted(p_ref) == sorted(p_port)
        for k in p_ref:
            np.testing.assert_array_equal(np.asarray(p_ref[k]),
                                          p_port[k].numpy())
    np.testing.assert_array_equal(np.asarray(out["opt_state"]["step"]),
                                  port["opt_state"]["step"].numpy())
