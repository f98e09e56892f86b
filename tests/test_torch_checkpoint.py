"""The port's checkpoint manager and tree order against the JAX
reference's (``repro.checkpoint.manager``): the reference's four manager
properties on both managers, checkpoints crossing in both directions bit
for bit with an identical ``manifest.json``, the structure string equal to
``str(jax.tree.structure(...))``, and the traps of the port's trees: the
host copy at ``save``, Python-int step counters, bfloat16 leaves (numpy's
raw ``|V2``), ``None`` subtrees, NamedTuples, meta ``like`` leaves, the
restore checks and a failed write raised at the next call."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.optim.adamw import AdamWState as JAdamWState
from repro_torch import tree as T
from repro_torch.checkpoint import manager as mgr_mod
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.optim.adamw import AdamWState


SIDES = {"reference": (JManager, jnp.asarray, jax.tree.leaves),
         "port": (CheckpointManager, torch.as_tensor, T.sorted_leaves)}


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.dtype("V2"))
        return x.numpy()
    return np.asarray(x)


def _same_bits(a, b):
    a, b = np.asarray(_np(a)), np.asarray(_np(b))
    return a.shape == b.shape and a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# the reference's four manager tests, on both managers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("side", sorted(SIDES))
def test_checkpoint_roundtrip(tmp_path, side):
    Mgr, arr, leaves = SIDES[side]
    mgr = Mgr(str(tmp_path), keep=2, async_save=False)
    tree = {"a": arr(np.arange(6.0, dtype=np.float32).reshape(2, 3)),
            "b": {"c": arr(np.ones((4,), np.float32))}}
    mgr.save(10, tree, extra={"data": {"step": 10}})
    got, extra = mgr.restore(tree)
    for x, y in zip(leaves(tree), leaves(got)):
        np.testing.assert_array_equal(_np(x), _np(y))
    assert extra["data"]["step"] == 10


@pytest.mark.parametrize("side", sorted(SIDES))
def test_checkpoint_retention_and_latest(tmp_path, side):
    Mgr, arr, _ = SIDES[side]
    mgr = Mgr(str(tmp_path), keep=2, async_save=False)
    tree = {"a": arr(np.zeros((2,), np.float32))}
    for s in [1, 2, 3, 4]:
        mgr.save(s, tree)
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


@pytest.mark.parametrize("side", sorted(SIDES))
def test_checkpoint_async(tmp_path, side):
    Mgr, arr, _ = SIDES[side]
    mgr = Mgr(str(tmp_path), keep=3, async_save=True)
    tree = {"a": arr(np.ones((128, 128), np.float32))}
    for s in range(3):
        mgr.save(s, tree)
    mgr.wait()
    assert mgr.all_steps() == [0, 1, 2]


@pytest.mark.parametrize("side", sorted(SIDES))
def test_checkpoint_ignores_partial_tmp(tmp_path, side):
    Mgr, arr, _ = SIDES[side]
    mgr = Mgr(str(tmp_path), keep=3, async_save=False)
    mgr.save(1, {"a": arr(np.zeros((2,), np.float32))})
    os.makedirs(tmp_path / "step_0000000002.tmp")   # a crash mid-save
    assert mgr.latest_step() == 1


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------

def _values():
    rng = np.random.default_rng(0)
    f32 = rng.normal(size=(3, 5)).astype(np.float32)
    i32 = rng.integers(-50, 50, (4,)).astype(np.int32)
    bf = np.asarray(jnp.asarray(rng.normal(size=(2, 6)), jnp.bfloat16))
    mu = rng.normal(size=(3,)).astype(np.float32)
    nu = rng.random(size=(3,)).astype(np.float32)
    return f32, i32, bf, mu, nu


def _jax_tree():
    """Keys inserted unsorted, a NamedTuple, None, a 0-d int32 step and
    float32, int32 and bfloat16 leaves: the reference's side."""
    f32, i32, bf, mu, nu = _values()
    return {"trainable": {"w": jnp.asarray(f32), "ids": jnp.asarray(i32),
                          "emb": jnp.asarray(bf)},
            "opt": JAdamWState(step=jnp.asarray(7, jnp.int32),
                               mu={"z": jnp.asarray(mu), "a": None},
                               nu={"z": jnp.asarray(nu), "a": None}),
            "step": jnp.asarray(7, jnp.int32), "aux": None,
            "pair": (jnp.asarray(f32[0]), [jnp.asarray(i32[:2])])}


def _port_tree():
    """The same values in the port's types: Python-int step counters,
    torch tensors (the bfloat16 one carried over bit for bit)."""
    f32, i32, bf, mu, nu = _values()
    bf16 = torch.from_numpy(bf.view(np.int16).copy()).view(torch.bfloat16)
    return {"trainable": {"w": torch.from_numpy(f32.copy()),
                          "ids": torch.from_numpy(i32.copy()), "emb": bf16},
            "opt": AdamWState(step=7, mu={"z": torch.from_numpy(mu.copy()),
                                          "a": None},
                              nu={"z": torch.from_numpy(nu.copy()),
                                  "a": None}),
            "step": 7, "aux": None,
            "pair": (torch.from_numpy(f32[0].copy()),
                     [torch.from_numpy(i32[:2].copy())])}


def _files(d):
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = f.read()
    with open(os.path.join(d, "extra.json")) as f:
        extra = f.read()
    with np.load(os.path.join(d, "arrays.npz")) as z:
        arrays = {k: (z[k].dtype.str, z[k].shape, z[k].tobytes())
                  for k in z.files}
    return manifest, extra, arrays


def test_port_and_reference_write_the_same_checkpoint(tmp_path):
    """Leaves in jax's order, ``manifest.json`` and ``extra.json`` byte
    for byte, every array's shape, dtype and bytes equal (numpy writes a
    jax bfloat16 leaf as raw ``|V2``; the port writes those bits)."""
    extra = {"data": {"step": 7, "seed": 0}, "step": 7}
    JManager(str(tmp_path / "ref"), async_save=False).save(
        7, _jax_tree(), extra=extra)
    CheckpointManager(str(tmp_path / "port"), async_save=False).save(
        7, _port_tree(), extra=extra)
    ref = _files(tmp_path / "ref" / "step_0000000007")
    port = _files(tmp_path / "port" / "step_0000000007")
    assert port[0] == ref[0] and port[1] == ref[1]
    assert json.loads(port[0])["structure"] == str(
        jax.tree.structure(_jax_tree()))
    assert port[2] == ref[2]
    assert port[2]["a6"][0] == "|V2"              # trainable.emb


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    JManager(str(tmp_path), async_save=False).save(
        7, _jax_tree(), extra={"k": 1})
    got, extra = CheckpointManager(str(tmp_path)).restore(_port_tree())
    want = _port_tree()
    assert extra == {"k": 1}
    assert T.structure(got) == T.structure(want)
    assert got["step"] == 7 and type(got["step"]) is int
    assert type(got["opt"]) is AdamWState and got["opt"].step == 7
    assert got["aux"] is None and got["opt"].mu["a"] is None
    assert list(got["trainable"]) == ["w", "ids", "emb"]   # like's order
    assert got["trainable"]["emb"].dtype == torch.bfloat16
    assert got["trainable"]["ids"].dtype == torch.int32
    for a, b in zip(T.sorted_leaves(got), T.sorted_leaves(want)):
        assert _same_bits(a, b)


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    CheckpointManager(str(tmp_path), async_save=False).save(
        7, _port_tree(), extra={"k": 1})
    like = _jax_tree()
    got, extra = JManager(str(tmp_path)).restore(like)
    assert extra == {"k": 1}
    assert jax.tree.structure(got) == jax.tree.structure(like)
    assert got["step"].dtype == np.int32 and got["opt"].step == 7
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(like)):
        assert _same_bits(a, b)


STRUCTURES = {
    "nested": {"b": [1, {"y": 2, "x": (3,)}], "a": None},
    "empties": {"d": (), "e": [], "f": {}, "g": (None, 1)},
    "lists": [[1, 2], (3, [4, None]), 5],
    "leaf": 1,
    "none": None,
    "int_keys": {2: 1, 1: [2]},
    "namedtuple": {"opt": JAdamWState(1, {"q": 2}, None), "s": 3},
}


@pytest.mark.parametrize("name", sorted(STRUCTURES))
def test_structure_string_is_jax(name):
    tree = STRUCTURES[name]
    assert T.structure(tree) == str(jax.tree.structure(tree))
    assert T.sorted_leaves(tree) == jax.tree.leaves(tree)
    back = T.sorted_unflatten(tree, [f"v{i}" for i in range(
        len(jax.tree.leaves(tree)))])
    assert back == jax.tree.unflatten(jax.tree.structure(tree), [
        f"v{i}" for i in range(len(jax.tree.leaves(tree)))])


def test_sorted_unflatten_keeps_types_and_counts():
    tree = {"z": AdamWState(1, [2, 3], None), "a": (4,)}
    got = T.sorted_unflatten(tree, ["a", "s", "m0", "m1"])
    assert got == {"z": AdamWState("s", ["m0", "m1"], None), "a": ("a",)}
    assert list(got) == ["z", "a"] and type(got["z"]) is AdamWState
    with pytest.raises(ValueError, match="3 values for a tree of 4"):
        T.sorted_unflatten(tree, [1, 2, 3])


# ---------------------------------------------------------------------------
# the port's traps
# ---------------------------------------------------------------------------

def test_save_copies_to_the_host_before_returning(tmp_path, monkeypatch):
    """An in-place update after ``save`` (the next train step) must not
    change what the writer thread writes."""
    gate = __import__("threading").Event()
    write = CheckpointManager._write

    def slow_write(self, *a):
        gate.wait(10)
        write(self, *a)
    monkeypatch.setattr(CheckpointManager, "_write", slow_write)
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    x = torch.arange(8, dtype=torch.float32)
    mgr.save(1, {"x": x, "n": 3})
    x.add_(100.0)
    gate.set()
    mgr.wait()
    got, _ = mgr.restore({"x": x, "n": 0})
    assert torch.equal(got["x"], torch.arange(8, dtype=torch.float32))
    assert got["n"] == 3


def test_int_leaves_are_written_as_int32(tmp_path):
    CheckpointManager(str(tmp_path), async_save=False).save(
        3, {"step": 3, "opt": AdamWState(3, {}, {})})
    with np.load(tmp_path / "step_0000000003" / "arrays.npz") as z:
        assert [(z[k].dtype, z[k].shape) for k in sorted(z.files)] == [
            (np.dtype(np.int32), ())] * 2


def test_bf16_raw_leaf_needs_a_bf16_like(tmp_path):
    """A ``|V2`` leaf is read into a bfloat16 ``like`` leaf bit for bit
    and refused (never upcast) for any other dtype."""
    JManager(str(tmp_path), async_save=False).save(
        1, {"t": jnp.asarray([1.5, -2.25, 3e-3], jnp.bfloat16)})
    mgr = CheckpointManager(str(tmp_path))
    got, _ = mgr.restore({"t": torch.zeros(3, dtype=torch.bfloat16)})
    assert got["t"].dtype == torch.bfloat16
    assert got["t"].tolist() == [1.5, -2.25, pytest.approx(3e-3, rel=1e-2)]
    with pytest.raises(ValueError, match="bfloat16"):
        mgr.restore({"t": torch.zeros(3)})


def test_restore_checks_leaves_and_shapes(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, {"a": torch.zeros(2, 3), "b": torch.zeros(4)})
    with pytest.raises(ValueError, match="checkpoint has 2 leaves"):
        mgr.restore({"a": torch.zeros(2, 3)})
    with pytest.raises(ValueError, match=r"a0: checkpoint shape \(2, 3\)"):
        mgr.restore({"a": torch.zeros(3, 2), "b": torch.zeros(4)})
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        CheckpointManager(str(tmp_path / "empty")).restore({})


def test_meta_like_learns_shapes_without_data(tmp_path):
    """A meta ``like`` gives the saved dtype on the CPU (or ``device``);
    the restored values are the saved ones."""
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    table = torch.randn(2, 5, 3, generator=torch.Generator().manual_seed(0))
    mgr.save(1, {"table": table})
    like = {"table": torch.empty(2, 5, 3, dtype=torch.bfloat16,
                                 device="meta")}
    with pytest.raises(ValueError, match="meta"):
        mgr.save(2, like)
    got, _ = mgr.restore({"table": torch.empty(2, 5, 3, device="meta")})
    assert got["table"].device.type == "cpu"
    assert torch.equal(got["table"], table)
    got, _ = mgr.restore({"table": torch.empty(2, 5, 3, device="meta")},
                         device="cpu")
    assert torch.equal(got["table"], table)


def test_a_failed_write_is_raised_at_the_next_call(tmp_path, monkeypatch):
    def broken(*a, **kw):
        raise OSError("disk full")
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    monkeypatch.setattr(mgr_mod.np, "savez", broken)
    mgr.save(1, {"a": torch.zeros(2)})
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()                           # raised once
    mgr.save(2, {"a": torch.zeros(2)})
    mgr._q.join()                        # the write failed, not yet raised
    with pytest.raises(OSError, match="disk full"):
        mgr.save(3, {"a": torch.zeros(2)})
    assert mgr.all_steps() == []
