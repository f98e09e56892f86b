"""The dry run on the port's terms (``launch.specs``, ``launch.dryrun``,
``roofline``) held against the reference's:

* every registered config's init on ``meta``: the reference's tree
  (through the bridge's layout), shapes, dtypes and parameter count;
* every (arch x shape) pair of the assigned configs on both production
  meshes, over a fake process group of 256 or 512 ranks: each spec
  leaf's global shape and dtype equal the reference's specs at
  ``mesh=None``, each local shard the one the reference's ``spec_for``
  gives (a ``.shape`` stub mesh), one rank's argument bytes the
  reference's sum less the scalars the port keeps on the host, and the
  skipped pairs skip with the reference's reasons;
* ``model_flops``, ``roofline_report`` and ``format_row`` equal the
  reference's for every cell on the same inputs;
* one cell compiled by the reference on 8 XLA CPU devices (2 x 4, reduced
  smollm-360m) against the port's count on a fake 2 x 4 mesh;
* the production cell smollm-360m ``decode_32k`` through the port's
  launcher in a process of its own (the ``--all`` sweeps are ``slow``).
"""
import functools
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.distributed as dist

from repro import configs as jconfigs
from repro.core import aot as JA
from repro.core import peft as JP
from repro.distrib import axes as jaxes
from repro.distrib import sharding as jsh
from repro.launch import specs as jsp
from repro.models.model import Model as JModel
from repro.models.model import ModelOptions as JOpts
from repro.roofline import analysis as jroof
from repro.train import step as JS
from repro_torch import bridge, configs
from repro_torch.distrib import axes as axlib
from repro_torch.launch import dryrun
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import init_fake_group, make_production_mesh
from repro_torch.models.model import Model, ModelOptions
from repro_torch.roofline import analysis as roof

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
PAIRS = [(c.name, s.name) for c in jconfigs.ASSIGNED for s in c.shapes]
# the same hardware for both packages (the reference reads "ici_bw")
HW = dict(roof.HW_H100, ici_bw=roof.HW_H100["link_bw"])
SIZES = {False: {"data": 16, "model": 16},
         True: {"pod": 2, "data": 16, "model": 16}}


class _Stub:
    """A mesh for the reference's ``spec_for``: it reads ``.shape``."""

    def __init__(self, shape):
        self.shape = shape


def _np(tree):
    """ShapeDtypeStructs -> zero-stride numpy arrays of their shapes and
    dtypes (no memory), which the bridge's layout helpers can slice."""
    return jax.tree.map(lambda s: np.broadcast_to(
        np.zeros((), s.dtype), s.shape), tree)


def _dt(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _port_params_layout(cfg, tree):
    """The reference's grouped parameter tree in the port's layout."""
    out = {"embed": tree["embed"],
           "layers": bridge._ungroup(cfg, tree["groups"]),
           "final_norm": tree["final_norm"]}
    out.update({k: tree[k] for k in ("lm_head", "frontend") if k in tree})
    return out


def _shapes(tree):
    return {axlib.path_strings(p): (tuple(x.shape), _dt(x))
            for p, x in axlib.leaves_with_paths(tree)
            if hasattr(x, "shape")}


# ---------------------------------------------------------------------------
# 1. full-size trees on meta
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(configs.REGISTRY))
def test_meta_init_matches_reference_tree(name):
    """``Model(cfg, device="meta").init()`` allocates nothing and gives the
    reference's tree: leaf paths (through the bridge), shapes, dtypes and
    the parameter count."""
    cfg, jcfg = configs.get(name), jconfigs.get(name)
    params = Model(cfg, ModelOptions(), device="meta").init()
    leaves = [x for _, x in axlib.leaves_with_paths(params)]
    assert leaves and all(x.is_meta for x in leaves)
    ref = jax.eval_shape(JModel(jcfg).init, jax.random.PRNGKey(0))
    assert _shapes(params) == _shapes(_port_params_layout(cfg, _np(ref)))
    assert Model.param_count(params) == sum(
        math.prod(s.shape) for s in jax.tree.leaves(ref))


# ---------------------------------------------------------------------------
# 2. specs and shards on both production meshes
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_model(arch):
    cfg = jconfigs.get(arch)
    return JModel(cfg, JOpts(compute_dtype=jnp.bfloat16,
                             param_dtype=jnp.bfloat16, attn_impl="chunked"))


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return jsp.param_specs(_ref_model(arch))


@functools.lru_cache(maxsize=None)
def reference_specs(arch, shape_name):
    """The reference's specs of one cell at ``mesh=None``, as its
    ``build_cell`` makes them: {tree: (specs, names_fn)} and the leaves
    the port keeps on the host {name: bytes}."""
    cfg, model = jconfigs.get(arch), _ref_model(arch)
    shape = cfg.shape(shape_name)
    method = "aot" if cfg.aot_applicable else "bitfit"
    batch = jsp.input_specs(cfg, shape)
    bnames = lambda path, shp: jaxes.batch_axes_for(path[-1], shp)
    trees = {"params": (_ref_params(arch), jaxes.logical_axes_for),
             "batch": (batch, bnames)}
    host = {}
    if shape.kind == "train":
        popt = JP.PEFTOptions(method=method, aot=JA.AoTOptions(
            mode="fc", rank=64, dropout=0.0))
        init_state, _ = JS.make_train_step(
            model, JS.TrainConfig(peft=popt, loss_chunk=512))
        state = jsp.state_specs(init_state,
                                {"peft": jsp.peft_specs(model, popt)})
        host = {"step": 4, "opt.step": 4,
                "rng": math.prod(jsp.rng_spec().shape) * 4}
        state = {"trainable": state["trainable"], "opt": {
            "mu": state["opt"].mu, "nu": state["opt"].nu}}
        trees["state"] = (state, jaxes.logical_axes_for)
        return trees, host
    if cfg.aot_applicable:
        trees["table"] = (jsp.fused_table_specs(model, 1),
                          jaxes.logical_axes_for)
    if shape.kind == "decode":
        trees["cache"] = (jsp.cache_specs(model, shape.global_batch,
                                          shape.seq_len),
                          jaxes.cache_axes_for)
        host = {"pos": 4}
    return trees, host


def _ref_local(tree, names_fn, sizes, rules):
    """Each reference leaf's local shard shape under ``spec_for``, as
    zero-stride arrays in the leaf's dtype."""
    stub = _Stub(sizes)

    def local(kp, s):
        names = names_fn(jaxes.path_strings(kp), tuple(s.shape))
        spec = jsh.spec_for(names, s.shape, stub, rules)
        shape = list(s.shape)
        for i, ax in enumerate(spec):
            for a in () if ax is None else (ax,) if isinstance(ax, str) \
                    else ax:
                shape[i] //= sizes[a]
        return np.broadcast_to(np.zeros((), s.dtype), tuple(shape))
    return jax.tree_util.tree_map_with_path(local, tree)


def _ref_rules(cfg, shape, multi):
    if shape.kind == "decode" and shape.global_batch == 1:
        return jsh.long_context_rules(pod_axis=multi)
    return jsh.tp_dp_rules(pod_axis=multi,
                           sequence_parallel=shape.kind != "decode")


def _port_trees(cfg, args, kind):
    """The port's args of one cell by the reference's tree names."""
    if kind == "train":
        state, frozen, batch, _ = args
        return {"params": frozen["backbone"], "batch": batch,
                "state": {"trainable": state["trainable"], "opt": {
                    "mu": state["opt"].mu, "nu": state["opt"].nu}}}
    out = {"params": args[0]}
    if kind == "prefill":
        out["batch"] = args[-1]
        if len(args) == 3:
            out["table"] = args[1]
        return out
    out["batch"] = {"tokens": args[-3]}
    out["cache"] = args[-1]
    if len(args) == 5:
        out["table"] = args[1]
    return out


def _layout(cfg, name, tree):
    """A reference tree (numpy leaves) in the port's layout."""
    if name == "params":
        return _port_params_layout(cfg, tree)
    if name == "cache" and set(cfg.layer_kinds) != {"attn"}:
        return {"layers": bridge._ungroup(cfg, tree)}
    return tree


def _leafwise(tree):
    return {axlib.path_strings(p): x for p, x in axlib.leaves_with_paths(tree)
            if hasattr(x, "shape")}


def _check_stacked_cache(cfg, ref_g, ref_l, port):
    """An attention-only stack: the reference's grouped (R, ...) K / V
    leaves against the port's stacked (L, ...) ones, per layer."""
    for name in ("k", "v"):
        x = port[name]
        total = 0
        for g, l in zip(ref_g, ref_l):
            for u in g:
                a, b = g[u][name], l[u][name]
                assert tuple(a.shape[1:]) == tuple(x.shape[1:])
                assert tuple(b.shape[1:]) == tuple(x.to_local().shape[1:])
                assert str(a.dtype) == _dt(x)
                total += a.shape[0]
        assert total == x.shape[0] == cfg.num_layers


@pytest.fixture(scope="module", params=[False, True], ids=["pod1", "pod2"])
def production(request):
    """(multi_pod, the production mesh) over a fake group of 256 or 512
    ranks in this process, destroyed after the module's tests."""
    multi = request.param
    init_fake_group(512 if multi else 256)
    try:
        yield multi, make_production_mesh(multi_pod=multi,
                                          device_type="cpu")
    finally:
        dist.destroy_process_group()


def expected_argument_bytes(arch, shape_name, multi):
    """(One rank's argument bytes by the reference's specs and
    ``spec_for`` but for the scalars the port holds on the host, those
    scalars' bytes)."""
    cfg = jconfigs.get(arch)
    shape = cfg.shape(shape_name)
    trees, host = reference_specs(arch, shape_name)
    rules = _ref_rules(cfg, shape, multi)
    total = 0
    for name, (tree, names_fn) in trees.items():
        loc = _ref_local(tree, names_fn, SIZES[multi], rules)
        total += sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(loc))
    return total, sum(host.values())


@pytest.mark.parametrize("arch,shape_name", PAIRS,
                         ids=[f"{a}-{s}" for a, s in PAIRS])
def test_specs_and_shards_match_reference(production, arch, shape_name):
    multi, mesh = production
    jcfg, cfg = jconfigs.get(arch), configs.get(arch)
    fn, args, _, rules, _, meta = dryrun.build_cell(
        arch, shape_name, multi_pod=multi, mesh=mesh)
    reason = jcfg.shape_skip_reason(shape_name)
    if reason:
        assert fn is None and meta["skipped"] == reason
        return
    shape = jcfg.shape(shape_name)
    assert rules == _ref_rules(jcfg, shape, multi)
    trees, host = reference_specs(arch, shape_name)
    ports = _port_trees(cfg, args, shape.kind)
    assert sorted(ports) == sorted(trees)
    for name, (tree, names_fn) in trees.items():
        loc = _ref_local(tree, names_fn, SIZES[multi], rules)
        if name == "cache" and set(cfg.layer_kinds) == {"attn"}:
            _check_stacked_cache(cfg, _np(tree), loc, ports[name])
            continue
        want_g = _leafwise(_layout(cfg, name, _np(tree)))
        want_l = _leafwise(_layout(cfg, name, loc))
        got = _leafwise(ports[name])
        assert sorted(got) == sorted(want_g), name
        for path, x in got.items():
            assert (tuple(x.shape), _dt(x)) == (
                tuple(want_g[path].shape), str(want_g[path].dtype)), path
            assert tuple(x.to_local().shape) == tuple(
                want_l[path].shape), path
    want, _ = expected_argument_bytes(arch, shape_name, multi)
    assert sp.argument_bytes(args) == want


# ---------------------------------------------------------------------------
# 3. roofline arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape_name", [
    p for p in PAIRS if not jconfigs.get(p[0]).shape_skip_reason(p[1])])
def test_roofline_matches_reference(arch, shape_name):
    """The same counts through both packages' model_flops,
    roofline_report and format_row, on the same hardware dict."""
    jcfg, cfg = jconfigs.get(arch), configs.get(arch)
    n = Model.param_count(Model(cfg, ModelOptions(), "meta").init())
    rng = np.random.default_rng(len(arch) * 7 + len(shape_name))
    coll = {op: {"count": int(rng.integers(1, 99)),
                 "bytes": float(rng.uniform(1e6, 1e9)),
                 "wire_bytes": float(rng.uniform(1e6, 2e9))}
            for op in ("all-gather", "all-reduce", "all-to-all")}
    kw = dict(flops_per_device=float(rng.uniform(1e9, 1e15)),
              bytes_per_device=float(rng.uniform(1e8, 1e13)), coll=coll,
              n_chips=256, n_params_total=n)
    assert roof.model_flops(cfg, cfg.shape(shape_name), n) == \
        jroof.model_flops(jcfg, jcfg.shape(shape_name), n)
    mine = roof.roofline_report(cfg=cfg, shape=cfg.shape(shape_name), hw=HW,
                                **kw)
    ref = jroof.roofline_report(cfg=jcfg, shape=jcfg.shape(shape_name),
                                hw=HW, **kw)
    assert mine == ref
    assert roof.format_row(arch, shape_name, mine) == jroof.format_row(
        arch, shape_name, ref)
    assert roof.roofline_report(**kw)["memory_s"] == \
        kw["bytes_per_device"] / 3.35e12


def test_collective_record_wire_factors():
    out = {}
    roof.collective_record(out, "all-reduce", 100)
    roof.collective_record(out, "all-reduce", 50)
    roof.collective_record(out, "all-to-all", 10)
    assert out == {"all-reduce": {"count": 2, "bytes": 150.0,
                                  "wire_bytes": 300.0},
                   "all-to-all": {"count": 1, "bytes": 10.0,
                                  "wire_bytes": 10.0}}
    assert roof._WIRE_FACTOR == jroof._WIRE_FACTOR


# ---------------------------------------------------------------------------
# 4. a cell compiled by the reference against the port's count
# ---------------------------------------------------------------------------

REFERENCE_CELLS = """
import json
from unittest import mock
from repro import configs
from repro.launch import dryrun as D
from repro.launch.mesh import make_mesh
from repro.roofline.analysis import model_flops
cfg = configs.reduced(configs.get("smollm-360m"), repeats=2)
out = {}
with mock.patch("repro.launch.mesh.make_production_mesh",
                lambda multi_pod=False: make_mesh((2, 4), ("data", "model"))):
    for shape in ("smoke_train", "smoke_decode"):
        fn, args, mesh, rules, model, meta = D.build_cell(
            "smollm-360m", shape, cfg_override=cfg, scan_layers=False)
        donate = meta.pop("donate", ())
        from repro.distrib import sharding as shlib
        with mesh, shlib.use_rules(mesh, rules):
            c = jax.jit(fn, donate_argnums=donate).lower(*args).compile()
        cost = c.cost_analysis()
        cost = cost[0] if isinstance(cost, (list, tuple)) else cost
        out[shape] = {
            "args": int(c.memory_analysis().argument_size_in_bytes),
            "flops": float(cost.get("flops", 0.0))}
print("JSON" + json.dumps(out))
"""

PORT_CELLS = """
import json
from repro_torch import configs
from repro_torch.launch import dryrun as D, specs as sp
from repro_torch.launch.mesh import init_fake_group, make_mesh
from repro_torch.models.model import Model
from repro_torch.roofline.analysis import model_flops
init_fake_group(8)
mesh = make_mesh((2, 4), ("data", "model"), "cpu")
cfg = configs.reduced(configs.get("smollm-360m"), repeats=2)
out = {}
for shape in ("smoke_train", "smoke_decode"):
    fn, args, mesh, rules, model, meta = D.build_cell(
        "smollm-360m", shape, cfg_override=cfg, mesh=mesh)
    counter, arg_bytes, _, _ = D.count_cell(fn, args, mesh, rules)
    n = Model.param_count(model.init())
    out[shape] = {"args": arg_bytes, "flops": float(counter.flops),
                  "model_flops": model_flops(cfg, cfg.shape(shape), n) / 8}
print("JSON" + json.dumps(out))
"""


def _start(code: str, env=None):
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _result(proc, timeout=300):
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, f"stdout:\n{out}\nstderr:\n{err}"
    line = [x for x in out.splitlines() if x.startswith("JSON")][-1]
    return json.loads(line[4:])


def test_compiled_reference_cell_against_the_port():
    """Reduced smollm-360m on a 2 x 4 mesh: the reference's compiled
    argument bytes equal the port's plus the scalars the port keeps on
    the host (the train step's two counters, the decode position); XLA's
    FLOPs (elementwise work too) are at least the port's
    counted product FLOPs, which are at least the model FLOPs per rank."""
    procs = [_start(textwrap.dedent(f"""
        import os, sys
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        sys.path.insert(0, {SRC!r})
        import jax
    """) + REFERENCE_CELLS), _start(PORT_CELLS, dict(os.environ,
                                                     PYTHONPATH=SRC))]
    try:
        ref, port = (_result(p) for p in procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    # the train step's two int32 counters (its PRNG key, unused at
    # dropout 0, jit prunes) and the decode position
    host = {"smoke_train": 4 + 4, "smoke_decode": 4}
    for shape in ("smoke_train", "smoke_decode"):
        r, p = ref[shape], port[shape]
        print(f"{shape}: XLA flops / port flops "
              f"{r['flops'] / p['flops']:.3f}, port flops / model flops "
              f"{p['flops'] / p['model_flops']:.3f}")
        assert r["args"] == p["args"] + host[shape], (shape, r, p)
        assert r["flops"] >= p["flops"] >= p["model_flops"], (shape, r, p)


# ---------------------------------------------------------------------------
# 5. one production cell end to end, and the sweeps
# ---------------------------------------------------------------------------

def _launch(args, tmp_path, timeout):
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        *args, "--out-dir", str(tmp_path)], env=env,
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return r.stdout


def test_production_decode_cell(tmp_path):
    """smollm-360m decode_32k on pod1 through the launcher (the
    reference's slow test's cell): FLOPs counted, collectives counted,
    the argument bytes of the specs test."""
    out = _launch(["--arch", "smollm-360m", "--shape", "decode_32k"],
                  tmp_path, timeout=240)
    assert "OK smollm-360m x decode_32k" in out
    rec = json.loads((tmp_path / "smollm-360m__decode_32k__pod1.json")
                     .read_text())
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert sum(c["count"] for c in rec["collectives"].values()) > 0
    want, _ = expected_argument_bytes("smollm-360m", "decode_32k", False)
    assert rec["memory"]["argument_bytes"] == want
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"]
    assert rec["n_chips"] == 256 and rec["mesh"] == [16, 16]
    assert rec["roofline"]["n_chips"] == 256


@pytest.mark.slow
@pytest.mark.parametrize("multi", [False, True], ids=["pod1", "pod2"])
def test_all_cells_sweep(tmp_path, multi):
    """``--all``: one JSON per pair, 32 counted and 8 skipped."""
    _launch(["--all", "--jobs", "4"] + (["--multi-pod"] if multi else []),
            tmp_path, timeout=7200)
    recs = [json.loads(p.read_text()) for p in tmp_path.glob("*.json")]
    assert len(recs) == 40
    assert sum("skipped" in r for r in recs) == 8
    assert all(r["flops_per_device"] > 0 for r in recs if "skipped" not in r)
