"""The port's NODES mesh (``repro_torch.sharding``): the mesh and its
memoization, the row padding, ``row_owner`` and the three collectives
(``all_gather``, ``psum``, ``psum_scatter``) over per-shard tensors,
against numpy, and against the reference's own helpers where they take a
mesh this process can build (one CPU device).  Tolerance: exact (the
collectives sum in shard order in f32, as numpy does here)."""
import numpy as np
import pytest
import torch

from repro_torch import sharding as sh

CPU4 = ("cpu",) * 4


def test_mesh_holds_its_devices_in_order():
    mesh = sh.node_mesh(devices=CPU4)
    assert mesh.size == sh.nodes_shards(mesh) == 4
    assert mesh.devices == (torch.device("cpu"),) * 4
    assert mesh.device_type == "cpu"
    assert "cpu" in repr(mesh)


def test_mesh_is_memoized_per_device_tuple():
    assert sh.node_mesh(devices=CPU4) is sh.node_mesh(devices=["cpu"] * 4)
    assert sh.node_mesh(devices=CPU4) is not sh.node_mesh(devices=("cpu",))
    assert sh.node_mesh(4, devices=CPU4) is sh.node_mesh(devices=CPU4)


@pytest.mark.parametrize("bad,exc", [
    ((), ValueError), (("cpu", "meta"), ValueError)])
def test_mesh_refuses_bad_device_lists(bad, exc):
    with pytest.raises(exc):
        sh.NodeMesh(bad)


def test_node_mesh_count_must_match_devices():
    with pytest.raises(ValueError, match="n=3"):
        sh.node_mesh(3, devices=CPU4)


def test_node_mesh_without_cuda_asks_for_devices():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sh.node_mesh()


def test_row_owner_agrees_with_shard_rows():
    """Shard ``s`` holds, in ``shard_rows``'s blocks, exactly the rows
    ``row_owner`` gives to ``s``."""
    mesh = sh.node_mesh(devices=CPU4)
    x = torch.arange(12)
    owner = sh.row_owner(12, mesh.size)
    for s, block in enumerate(sh.shard_rows(x, mesh)):
        np.testing.assert_array_equal(block.numpy(),
                                      np.nonzero(owner == s)[0])


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_row_owner_is_contiguous_blocks(shards):
    owner = sh.row_owner(16, shards)
    assert owner.dtype == np.int32
    np.testing.assert_array_equal(owner, np.arange(16) // (16 // shards))
    if shards > 1:
        with pytest.raises(ValueError, match="pad first"):
            sh.row_owner(17, shards)


def test_row_owner_matches_reference_on_one_device():
    jax = pytest.importorskip("jax")
    from repro import sharding as rsh
    assert len(jax.devices()) >= 1
    np.testing.assert_array_equal(
        sh.row_owner(12, 1),
        rsh.row_owner(12, rsh.node_mesh(1)))


@pytest.mark.parametrize("rows,mult", [(7, 4), (8, 4), (1, 3), (5, 1)])
def test_pad_rows_matches_reference_pad(rows, mult):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.neighbor_agg.ops import _pad_to
    x = np.arange(rows * 3, dtype=np.float32).reshape(rows, 3) + 1
    want = np.asarray(_pad_to(jnp.asarray(x), 0, mult))
    np.testing.assert_array_equal(sh.pad_rows(x, mult), want)
    np.testing.assert_array_equal(
        sh.pad_rows(torch.tensor(x), mult).numpy(), want)
    ints = torch.arange(rows, dtype=torch.int32)
    got = sh.pad_rows(ints, mult)
    assert got.dtype == torch.int32 and got.shape[0] == want.shape[0]
    assert int(got[rows:].abs().sum()) == 0


def test_pad_rows_returns_the_input_when_divisible():
    x = torch.ones(8, 2)
    assert sh.pad_rows(x, 4) is x


def test_shard_rows_roundtrip():
    mesh = sh.node_mesh(devices=CPU4)
    x = torch.arange(24.).reshape(8, 3)
    parts = sh.shard_rows(x, mesh)
    assert [tuple(p.shape) for p in parts] == [(2, 3)] * 4
    assert parts[1].data_ptr() == x[2:4].data_ptr()     # views on one device
    assert torch.equal(sh.unshard_rows(parts, "cpu"), x)
    with pytest.raises(ValueError, match="do not divide"):
        sh.shard_rows(torch.ones(7, 3), mesh)


def _parts(seed=0, rows=8, cols=5, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.normal(size=(rows, cols)), dtype=dtype)
            for _ in range(4)]


def test_all_gather_concatenates_in_shard_order():
    mesh = sh.node_mesh(devices=CPU4)
    parts = _parts()
    want = np.concatenate([p.numpy() for p in parts], 0)
    got = sh.all_gather(parts, mesh)
    assert len(got) == 4
    for g in got:
        np.testing.assert_array_equal(g.numpy(), want)
    assert got[0] is got[3]          # one device: one shared result
    one = sh.all_gather(parts[:1], sh.node_mesh(devices=("cpu",)))
    assert one[0] is parts[0]


def test_psum_sums_in_shard_order():
    mesh = sh.node_mesh(devices=CPU4)
    parts = _parts(1)
    want = parts[0].numpy().copy()
    for p in parts[1:]:
        want = want + p.numpy()
    for g in sh.psum(parts, mesh):
        np.testing.assert_array_equal(g.numpy(), want)
    assert sh.psum(parts[:1], sh.node_mesh(devices=("cpu",)))[0] is parts[0]


def test_psum_of_bf16_rounds_once():
    mesh = sh.node_mesh(devices=CPU4)
    parts = _parts(2, dtype=torch.bfloat16)
    acc = parts[0].float()
    for p in parts[1:]:
        acc = acc + p.float()
    got = sh.psum(parts, mesh)[0]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, acc.to(torch.bfloat16))


def test_psum_scatter_gives_each_shard_its_block():
    mesh = sh.node_mesh(devices=CPU4)
    parts = _parts(3)
    total = parts[0].numpy().copy()
    for p in parts[1:]:
        total = total + p.numpy()
    got = sh.psum_scatter(parts, mesh)
    for s, g in enumerate(got):
        np.testing.assert_array_equal(g.numpy(), total[2 * s:2 * s + 2])
    with pytest.raises(ValueError, match="does not split"):
        sh.psum_scatter(_parts(5, rows=6), mesh)


def test_collectives_check_the_part_count():
    mesh = sh.node_mesh(devices=CPU4)
    for fn in (sh.all_gather, sh.psum, sh.psum_scatter):
        with pytest.raises(ValueError, match="parts"):
            fn(_parts()[:3], mesh)


def test_lm_padding_rules_stay():
    assert sh.pad_to(17) == 32 and sh.padded_heads(40) == 48
    assert sh.padded_heads(8) == 8
