"""ROADMAP C15: a batch sharded over (pod, data) stays sharded there
through every op of a train step, as the reference's GSPMD keeps it.

On a fake group of 8 ranks, reduced smollm-360m's train cell runs on a
(pod 2, data 2, model 2) mesh, as the production two-pod mesh is built
(``launch.mesh.pod_mesh``), and on a (data 4, model 2) mesh, which
split the batch into the same four row blocks. Each rank must then
compute the same local tensors in both (no op on more rows than its
own), hold the same peak, and gather the same bytes, and no all-gather
may run over a dim that splits the batch. The production cells
(smollm-360m train_4k over 512 and 256 fake ranks) hold pod2's per-rank
peak at or under pod1's.
"""
import collections
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch.distributed as dist

from repro_torch import configs
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import init_fake_group, make_mesh, pod_mesh

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"pod2": (lambda: pod_mesh(2, 2, 2, "cpu"), True),
          "pod1": (lambda: make_mesh((4, 2), ("data", "model"), "cpu"),
                   False)}
SHAPE = ShapeSpec("pod_batch", "train", 128, 8)


class _Recorder(dryrun.DryRunCounter):
    """The dry run's counter, also recording each local op's floating
    output shapes and each collective's mesh dim."""

    groups = {}

    def __init__(self):
        super().__init__()
        self.shapes = collections.Counter()
        self.gathers = collections.Counter()

    def _count(self, func, args, kwargs, out):
        ns, name = func.namespace, func._overloadpacket.__name__
        if ns in ("_c10d_functional", "c10d"):
            if "gather" in name:
                group = next((a for a in args if isinstance(a, str)), None)
                self.gathers[self.groups.get(group, group)] += 1
        else:
            for t in dryrun._tensors(out):
                if t.is_floating_point() and t.ndim >= 2:
                    self.shapes[(str(func), tuple(t.shape))] += 1
        super()._count(func, args, kwargs, out)


@pytest.fixture(scope="module")
def cells():
    """{mesh name: (counter, argument bytes, mesh)} of the reduced train
    cell on each mesh, in this process over a fake group of 8, destroyed
    after."""
    cfg = configs.reduced(configs.get("smollm-360m"), repeats=2)
    init_fake_group(8)
    out = {}
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(dryrun, "DryRunCounter", _Recorder)
            for name, (make, multi) in MESHES.items():
                mesh = make()
                _Recorder.groups = {mesh.get_group(a).group_name: a
                                    for a in mesh.mesh_dim_names}
                fn, args, mesh, rules, _, _ = dryrun.build_cell(
                    "smollm-360m", SHAPE.name, cfg_override=cfg,
                    shape_override=SHAPE, mesh=mesh, multi_pod=multi,
                    loss_chunk=64)
                counter, arg_bytes, _, _ = dryrun.count_cell(fn, args, mesh,
                                                             rules)
                out[name] = (counter, arg_bytes, mesh)
    finally:
        dist.destroy_process_group()
    return out


def test_each_rank_computes_the_same_rows(cells):
    """Every local floating tensor of the step, by op and shape, is the
    same on both meshes: no rank of the pod mesh computes its data
    neighbours' rows (on the nested (pod, data) split DTensor laid the
    cross entropy's logits gradient and its head product out over pod
    alone, twice the rows)."""
    pod2, pod1 = cells["pod2"][0].shapes, cells["pod1"][0].shapes
    assert pod2 and pod2 == pod1, (sorted((pod2 - pod1).items())[:8],
                                   sorted((pod1 - pod2).items())[:8])


def test_same_peak_arguments_and_gathers(cells):
    (c2, a2, _), (c1, a1, _) = cells["pod2"], cells["pod1"]
    assert a2 == a1
    assert c2.peak == c1.peak
    assert c2.collectives["all-gather"] == c1.collectives["all-gather"]


def test_no_gather_over_the_batch_dims(cells):
    """All-gathers run over the model dim only (weights and the sequence
    under sequence parallelism), never over the dim that splits the
    batch; the pod mesh splits it over one dim, pod and data flattened."""
    for name, (counter, _, _) in cells.items():
        assert set(counter.gathers) == {"model"}, (name, counter.gathers)
    mesh = cells["pod2"][2]
    assert tuple(mesh.mesh_dim_names) == ("pod_data", "model")
    assert tuple(mesh.mesh.shape) == (4, 2)


PROD = """
import json, sys
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import init_fake_group, make_production_mesh
multi = sys.argv[1] == "pod2"
init_fake_group(512 if multi else 256)
mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
fn, args, mesh, rules, _, _ = dryrun.build_cell(
    "smollm-360m", "train_4k", mesh=mesh, multi_pod=multi)
counter, arg_bytes, _, _ = dryrun.count_cell(fn, args, mesh, rules)
print("JSON" + json.dumps({"peak": counter.peak, "args": arg_bytes}))
"""


@pytest.mark.slow
def test_production_pod2_peak_at_or_under_pod1():
    """smollm-360m train_4k: each pod2 rank holds half a pod1 rank's rows,
    so its peak is at most pod1's (14.7 against 6.3 GB before the
    repair)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {m: subprocess.Popen([sys.executable, "-c", PROD, m], env=env,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for m in ("pod2", "pod1")}
    rec = {}
    for m, p in procs.items():
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
        rec[m] = json.loads(out.split("JSON")[-1])
    assert rec["pod2"]["peak"] <= rec["pod1"]["peak"], rec
