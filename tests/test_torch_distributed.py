"""The port's distribution layer across ranks, held against the JAX
reference (the scenarios of ``tests/test_distributed.py``): 8 gloo ranks
on the CPU, a (data 2, model 4) mesh, against the reference's 8 fake XLA
devices (``distrib_util``: one reference subprocess and one group of
ranks serve every test here).

- the sharded train step (reduced smollm, AoT fc rank 8) against the
  reference's single-device ``train_step``: trainable leaves within atol
  2e-5 / rtol 1e-4, the loss within 1e-4;
- sharded multi-task ``logits`` (fused stacked tables, the kernels'
  wrappers on local shards) against the reference's unsharded call, within
  2e-5 / 1e-4; smollm's 1 KV head stays replicated while its 4 query heads
  shard;
- expert parallelism against the reference's ``apply_moe_ep`` on its 2 x 4
  mesh: drop-free (capacity factor 8) within 1e-4 with a finite gradient,
  and with drops (factor 0.5, a router of zeros) within 1e-4 with the same
  dropped fraction;
- the gather path in G = 2 data groups against the reference's under
  ``use_rules``;
- ``all_reduce_compressed`` against ``psum_compressed``: bitwise, and
  within 2e-2 (one step) and 2e-3 (16 steps) of the true mean;
- ``reshard_tree``: 2 x 4, a checkpoint, 4 x 2, bit for bit, and the
  checkpoint loads in the reference's ``CheckpointManager``;
- ``launch.train --mesh 2x4`` against the same run without a mesh.
"""
import ast
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import distrib_util
from repro_torch import configs
from repro_torch.distrib import sharding as shlib
from repro_torch.models import moe as moe_mod

GROUP_S = 300


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("distrib")
    distrib_util.run_reference(out, timeout=GROUP_S)
    outs = distrib_util.run_ranks(8, ["port", out], timeout=GROUP_S)
    bad = [(r, rc, o[-4000:]) for r, (rc, o) in enumerate(outs) if rc]
    assert not bad, bad[0]
    with open(out / "reference.pkl", "rb") as f:
        ref = pickle.load(f)
    with open(out / "inputs.pkl", "rb") as f:
        inputs = pickle.load(f)
    with open(out / "port.pkl", "rb") as f:
        port = pickle.load(f)
    return out, inputs, ref, port


def _port(runs, name):
    port = runs[3]
    assert name not in port["errors"], port["errors"][name]
    return port["results"][name]


def test_sharded_train_step_matches_reference_single_device(runs):
    _, _, ref, _ = runs
    got = _port(runs, "train")
    want = ref["train"]
    a, b = jax.tree.leaves(want["trainable"]), jax.tree.leaves(
        got["trainable"])
    assert len(a) == len(b) == 4
    for x, y in zip(a, b):
        np.testing.assert_allclose(y, x, atol=2e-5, rtol=1e-4)
    assert abs(got["loss"] - want["loss"]) < 1e-4
    # the step moved the leaves it trains (AoT fc's w2 and b2 from zero)
    assert max(float(np.abs(x).max()) for x in b) > 1e-4


def test_sharded_multitask_logits_match_unsharded_reference(runs):
    _, _, ref, _ = runs
    got = _port(runs, "logits")
    np.testing.assert_allclose(got["logits"], ref["logits"], atol=2e-5,
                               rtol=1e-4)
    assert got["placements"] == "(Shard(dim=0), Shard(dim=2))"  # vocab
    # the fused tables: vocab rows over data, embed over model
    assert got["table"] == "(Shard(dim=2), Shard(dim=3))"
    # one task's table (L, V, d) through the single-table gather-add, and
    # no PEFT (the input RMSNorm alone)
    assert got["table_one"] == "(Shard(dim=1), Shard(dim=2))"
    for name in ("logits_one", "logits_none"):
        np.testing.assert_allclose(got[name], ref[name], atol=2e-5,
                                   rtol=1e-4)


def test_sharded_logits_run_the_kernels_on_local_shards(runs):
    """Each rank's flash call sees its 2 of 4 rows and 1 of 4 query heads
    with the 1 KV head it reads: wk's 16 columns shard over the model
    axis, as in the reference, but k's one KV head does not, so
    ``constrain`` leaves it replicated (the reference's non-divisible
    fallback). Each gather-add sees its 32 of 64 token rows and only the
    32 table rows they gather, never the (2, 128, 64) tables."""
    got = _port(runs, "logits")
    assert got["wq"] == got["wk"] == "(Replicate(), Shard(dim=1))"
    seen = got["seen"]
    L = configs.reduced(configs.get("smollm-360m"), repeats=2).num_layers
    # three logits calls: multi-task, one task, no PEFT
    assert seen["flash_attention_plain"] == [[(2, 16, 1, 16)] * 3] * 3 * L
    assert seen["aot_gather_add_multitask_plain"] == [
        [(32, 64), (1, 32, 64), (32,)]] * L
    assert seen["aot_gather_add_plain"] == [[(32, 64), (32, 64), (32,)]] * L
    assert seen["rms_norm_plain"][:L] == [[(2, 16, 64), (64,)]] * L


def test_ep_moe_drop_free_matches_reference_ep(runs):
    _, _, ref, _ = runs
    out, aux, finite = _port(runs, "ep")
    np.testing.assert_allclose(out, ref["ep"][0], atol=1e-4)
    assert finite
    assert aux["moe_dropped_frac"] == ref["ep"][1]["moe_dropped_frac"] == 0
    for k in ("moe_lb_loss", "moe_z_loss"):
        assert abs(aux[k] - ref["ep"][1][k]) < 1e-5


def test_ep_moe_with_drops_matches_reference(runs):
    _, _, ref, _ = runs
    out, aux, finite = _port(runs, "ep_drops")
    np.testing.assert_allclose(out, ref["ep_drops"][0], atol=1e-4)
    assert np.isfinite(out).all() and finite
    assert aux["moe_dropped_frac"] == ref["ep_drops"][1]["moe_dropped_frac"]
    assert aux["moe_dropped_frac"] > 0


def test_gspmd_moe_in_two_groups_matches_reference(runs):
    """Capacity is per data group, so drops change with G, as in the
    reference; the port reads G from the rules' mesh (sizes suffice)."""
    _, inputs, ref, _ = runs
    cfg = distrib_util._moe_cfg(configs, 1.0)
    p = {k: torch.from_numpy(np.array(v)) for k, v in inputs["moe"].items()}
    x = torch.from_numpy(inputs["moe_x"])
    for G, mesh in ((2, {"data": 2, "model": 4}), (1, None)):
        with shlib.use_rules(mesh, shlib.tp_dp_rules()):
            assert shlib.data_group_count() == G
            out, aux = moe_mod.apply_moe_gspmd(cfg, p, x, torch.float32)
        want, want_aux = ref["gspmd"][G]
        np.testing.assert_allclose(out.numpy(), want, atol=1e-5)
        for k, v in want_aux.items():
            assert abs(float(aux[k]) - v) < 1e-6, (G, k)
    assert ref["gspmd"][2][1]["moe_dropped_frac"] != \
        ref["gspmd"][1][1]["moe_dropped_frac"]


def test_compressed_all_reduce_matches_psum_compressed(runs):
    _, inputs, ref, _ = runs
    one, sixteen = _port(runs, "compressed")
    np.testing.assert_array_equal(one, ref["compressed"][0])
    np.testing.assert_array_equal(sixteen, ref["compressed"][1])
    true = inputs["grads"].mean(axis=0)
    np.testing.assert_allclose(one, true, atol=2e-2)
    np.testing.assert_allclose(sixteen, true, atol=2e-3)


def test_reshard_round_trip_2x4_checkpoint_4x2(runs):
    got = _port(runs, "reshard")
    assert got["bitwise"]
    # wq (2, 16, 32): heads over model on both meshes; tok (64, 16): vocab
    assert got["a"] == ["(Replicate(), Shard(dim=2))",
                        "(Replicate(), Shard(dim=0))"]
    assert got["local_b"] == [(2, 16, 16), (32, 16)]
    # replicate_tree: every rank holds every leaf whole
    assert got["replicated"] == ["(Replicate(), Replicate())"] * 2
    assert got["replicated_bitwise"]


def test_dtensor_checkpoint_loads_in_the_reference_manager(runs):
    from repro.checkpoint.manager import CheckpointManager
    out = runs[0]
    rng = np.random.default_rng(0)
    tree = {"groups": [{"b0": {"attn": {"wq": rng.normal(
                size=(2, 16, 32)).astype(np.float32)}}}],
            "embed": {"tok": rng.normal(size=(64, 16)).astype(np.float32)}}
    restored, _ = CheckpointManager(str(out / "ckpt"),
                                    async_save=False).restore(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(restored)):
        np.testing.assert_array_equal(a, np.asarray(b))


def _train(tmp_path, label, steps, extra=()):
    """``launch.train`` on the CPU at reduced widths into ``tmp_path /
    label``: (its logged metrics less the step time, its stdout)."""
    args = ["--device", "cpu", "--reduced", "--steps", str(steps), "--seq",
            "32", "--batch", "8", "--ckpt-dir", str(tmp_path / label)]
    env = dict(os.environ, PYTHONPATH=str(distrib_util.ROOT / "src"),
               OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args, *extra],
        capture_output=True, text=True, timeout=GROUP_S, env=env)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    logs = [ast.literal_eval(line) for line in res.stdout.splitlines()
            if line.startswith("{'loss'")]
    for h in logs:
        del h["step_time_s"]
    return logs, res.stdout


def _checkpoint(tmp_path, label, step):
    return np.load(tmp_path / label / "smollm-360m" / f"step_{step:010d}"
                   / "arrays.npz")


def _assert_close(a, b):
    assert a.files == b.files
    for name in a.files:
        np.testing.assert_allclose(a[name], b[name], atol=2e-5, rtol=1e-4)


def test_launch_train_mesh_matches_the_unsharded_run(tmp_path):
    """``--mesh 2x4`` spawns its 8 gloo ranks; its losses and final
    checkpoint (rank 0's, whole leaves) match the run without a mesh.
    Resumed for a third step on a 4 x 2 mesh, it still matches the
    unsharded run resumed (elastic: the checkpoint is mesh-agnostic)."""
    mesh, _ = _train(tmp_path, "mesh", 2, ["--mesh", "2x4"])
    plain, _ = _train(tmp_path, "plain", 2)
    assert len(mesh) == 2 and mesh == plain
    _assert_close(_checkpoint(tmp_path, "mesh", 2),
                  _checkpoint(tmp_path, "plain", 2))
    _, out = _train(tmp_path, "mesh", 3, ["--mesh", "4x2"])
    assert "events: [{'kind': 'resume', 'step': 2}]" in out
    _train(tmp_path, "plain", 3)
    _assert_close(_checkpoint(tmp_path, "mesh", 3),
                  _checkpoint(tmp_path, "plain", 3))
