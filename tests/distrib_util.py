"""The multi-rank scenarios of ``tests/test_torch_distributed.py``: the JAX
reference's side, run in one subprocess with 8 fake XLA devices (its
``tests/test_distributed.py`` setup), and the port's side, run once by 8
gloo ranks on the CPU. Inputs come from numpy seeds and the reference's
initialisers; the reference writes them (``inputs.pkl``) with its results
(``reference.pkl``), the port's rank 0 writes ``port.pkl``. A scenario
that raises on the port's side is recorded by name with its traceback,
so the others still report.

    python tests/distrib_util.py reference OUT      # XLA_FLAGS set inside
    RANK=r WORLD_SIZE=8 MASTER_ADDR=... MASTER_PORT=... \\
        python tests/distrib_util.py port OUT
"""
import os
import pickle
import socket
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
MESH_A, MESH_B = (2, 4), (4, 2)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(world: int, args, timeout: float):
    """``python tests/distrib_util.py *args`` as ``world`` gloo ranks on the
    CPU (one thread each); returns each rank's (exit code, output). A rank
    still running at ``timeout`` seconds is killed with the others."""
    port = free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT / "src"))
        procs.append(subprocess.Popen(
            [sys.executable, __file__, *map(str, args)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0,
                                               deadline - time.monotonic()))
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def run_reference(out: Path, timeout: float):
    """The reference's scenarios in a subprocess with 8 XLA CPU devices."""
    code = (f"import os\nos.environ['XLA_FLAGS'] = "
            "'--xla_force_host_platform_device_count=8'\n"
            f"import sys\nsys.path[:0] = [{str(ROOT / 'src')!r}, "
            f"{str(ROOT / 'tests')!r}]\n"
            f"import distrib_util\ndistrib_util.reference({str(out)!r})\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=timeout, env=env)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"


def _moe_cfg(configs, factor, experts=8, top_k=2):
    import dataclasses
    cfg = configs.reduced(configs.get("qwen3-moe-30b-a3b"))
    return cfg.replace(moe=dataclasses.replace(
        cfg.moe, num_experts=experts, top_k=top_k, capacity_factor=factor))


# ---------------------------------------------------------------------------
# the reference's side
# ---------------------------------------------------------------------------

def reference(out):
    import jax
    import jax.numpy as jnp
    from functools import partial
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    from repro import configs
    from repro.core import aot as A
    from repro.core import peft as PE
    from repro.distrib import sharding as shlib
    from repro.launch.mesh import make_mesh
    from repro.models import moe as moe_mod
    from repro.models.model import Model, ModelOptions
    from repro.optim.compression import psum_compressed
    from repro.train.step import TrainConfig, make_train_step, split_train

    host = jax.device_get
    inputs, ref = {}, {}
    rules = shlib.tp_dp_rules()
    mesh = make_mesh(MESH_A, ("data", "model"))

    # the train step on one device (tests/test_distributed.py's setup)
    cfg = configs.reduced(configs.get("smollm-360m"), repeats=2)
    model = Model(cfg, ModelOptions(chunk_q=16, chunk_kv=16))
    params = model.init(jax.random.PRNGKey(0))
    popt = PE.PEFTOptions(method="aot", aot=A.AoTOptions(mode="fc", rank=8,
                                                         dropout=0.0))
    pp = PE.init(jax.random.PRNGKey(1), cfg, popt)
    init_state, train_step = make_train_step(
        model, TrainConfig(peft=popt, lr=1e-3, loss_chunk=16))
    trainable, frozen = split_train(params, pp, "aot")
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab_size, (8, 32)).astype(np.int32)
             for k in ("tokens", "labels")}
    s_ref, m_ref = jax.jit(train_step)(
        init_state(trainable), frozen,
        {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    inputs.update(params=host(params), peft=host(pp), batch=batch)
    ref["train"] = {"trainable": host(s_ref["trainable"]),
                    "loss": float(m_ref["loss"])}

    # multi-task fused-AoT logits, unsharded
    tasks = []
    for t in range(2):
        opt = PE.PEFTOptions(method="aot", aot=A.AoTOptions(
            mode="fc", rank=4, dropout=0.0))
        tp = PE.init(jax.random.PRNGKey(t), cfg, opt)
        tp["aot"] = jax.tree.map(lambda x: jax.random.normal(
            jax.random.PRNGKey(5 + t), x.shape) * 0.05, tp["aot"])
        tasks.append(A.fuse(tp["aot"], cfg, opt.aot,
                            embed=params["embed"]["tok"], vocab_chunk=64))
    fopt = PE.PEFTOptions(method="aot", aot=A.AoTOptions(mode="fused"))
    bundle = PE.make({"aot": A.stack_tasks(tasks)}, fopt)
    tokens = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    task_ids = np.asarray([0, 1, 1, 0], np.int32)
    bundle["task_ids"] = jnp.asarray(task_ids)
    lg = model.logits(params, {"tokens": jnp.asarray(tokens)}, bundle)[0]
    inputs.update(tasks=host(tasks), tokens=tokens, task_ids=task_ids)
    ref["logits"] = np.asarray(lg)
    # one task's table (the single-table gather-add), and no PEFT (the
    # input norm alone)
    one = PE.make({"aot": tasks[1]}, fopt)
    ref["logits_one"] = np.asarray(model.logits(
        params, {"tokens": jnp.asarray(tokens)}, one)[0])
    ref["logits_none"] = np.asarray(model.logits(
        params, {"tokens": jnp.asarray(tokens)})[0])

    # expert parallelism on the 2 x 4 mesh: drop-free, then with drops
    def ep(cfg, p, x):
        with mesh, shlib.use_rules(mesh, rules):
            assert moe_mod._ep_applicable(cfg, x)
            o, aux = jax.jit(lambda p, x: moe_mod.apply_moe_ep(
                cfg, p, x, jnp.float32))(p, x)
        return np.asarray(o), {k: float(v) for k, v in aux.items()}

    mcfg = _moe_cfg(configs, 8.0)
    p = moe_mod.moe_init(jax.random.PRNGKey(0), mcfg)
    x = rng.normal(size=(4, 16, mcfg.d_model)).astype(np.float32)
    inputs.update(moe=host(p), moe_x=x)
    ref["ep"] = ep(mcfg, p, jnp.asarray(x))
    p0 = dict(p, router=jnp.zeros_like(p["router"]))
    ref["ep_drops"] = ep(_moe_cfg(configs, 0.5), p0, jnp.asarray(x))

    # the gather path in G = 2 groups (the data axis), and in one
    gcfg = _moe_cfg(configs, 1.0)
    with mesh, shlib.use_rules(mesh, rules):
        assert shlib.data_group_count() == 2
        o2, a2 = jax.jit(lambda p, x: moe_mod.apply_moe_gspmd(
            gcfg, p, x, jnp.float32))(p, jnp.asarray(x))
    o1, a1 = moe_mod.apply_moe_gspmd(gcfg, p, jnp.asarray(x), jnp.float32)
    ref["gspmd"] = {G: (np.asarray(o), {k: float(v) for k, v in a.items()})
                    for G, (o, a) in ((2, (o2, a2)), (1, (o1, a1)))}

    # the compressed mean over an 8-way data axis, 1 and 16 steps
    mesh8 = make_mesh((8,), ("data",))
    g = rng.normal(size=(8, 64)).astype(np.float32)

    @partial(shard_map, mesh=mesh8, in_specs=(P("data", None),
                                              P("data", None)),
             out_specs=(P("data", None), P("data", None)))
    def allred(gs, errs):
        mean, new_err = psum_compressed({"g": gs}, {"g": errs}, "data")
        return mean["g"], new_err["g"]

    err = jnp.zeros_like(g)
    mean1, err = allred(jnp.asarray(g), err)
    acc, errs = np.zeros(64), jnp.zeros_like(g)
    for _ in range(16):
        m, errs = allred(jnp.asarray(g), errs)
        acc += np.asarray(m)[0]
    inputs["grads"] = g
    ref["compressed"] = (np.asarray(mean1)[0], acc / 16)

    with open(Path(out) / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    with open(Path(out) / "reference.pkl", "wb") as f:
        pickle.dump(ref, f)


# ---------------------------------------------------------------------------
# the port's side, one process per rank
# ---------------------------------------------------------------------------

def _record_locals(ops, seen):
    """Wrap the plain versions the kernel wrappers call, recording the
    shapes each rank hands them (the local shards)."""
    for name in ("flash_attention_plain", "aot_gather_add_multitask_plain",
                 "aot_gather_add_plain", "rms_norm_plain"):
        fn = getattr(ops, name)

        def rec(*a, _fn=fn, _name=name, **kw):
            seen.setdefault(_name, []).append(
                [tuple(x.shape) for x in a[:3] if hasattr(x, "shape")])
            return _fn(*a, **kw)
        setattr(ops, name, rec)


def port(out):
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch import bridge, configs
    from repro_torch import tree as T
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.checkpoint.reshard import (gather_tree, replicate_tree,
                                                reshard_tree)
    from repro_torch.core import aot as A
    from repro_torch.core import peft as PE
    from repro_torch.distrib import axes as axlib
    from repro_torch.distrib import sharding as shlib
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.train import sharded_step
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.model import Model, ModelOptions
    from repro_torch.optim.compression import all_reduce_compressed
    from repro_torch.train.step import (TrainConfig, make_train_step,
                                        split_train)

    torch.set_num_threads(1)
    out = Path(out)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    mesh_mod.init_group(rank, world, "cpu", timeout_s=120)
    mesh = mesh_mod.make_mesh(MESH_A, ("data", "model"), "cpu")
    rules = shlib.tp_dp_rules()
    with open(out / "inputs.pkl", "rb") as f:
        inp = pickle.load(f)
    cfg = configs.reduced(configs.get("smollm-360m"), repeats=2)
    names = lambda path, x: axlib.logical_axes_for(path, tuple(x.shape))
    res, errors = {}, {}

    def put(x, names_):
        return distribute_tensor(x, mesh, shlib.placements_for(
            names_, x.shape, mesh, rules), src_data_rank=None)

    def train():
        model = Model(cfg, ModelOptions(attn_impl="ref"), device="cpu")
        params = bridge.params_from_jax(cfg, inp["params"], device="cpu")
        popt = PE.PEFTOptions(method="aot", aot=A.AoTOptions(
            mode="fc", rank=8, dropout=0.0))
        pp = bridge.peft_from_jax(inp["peft"], popt, device="cpu")["params"]
        init_state, train_step = make_train_step(
            model, TrainConfig(peft=popt, lr=1e-3, loss_chunk=16))
        trainable, frozen = split_train(params, pp, "aot")
        state = reshard_tree(init_state(trainable), mesh, rules, names)
        frozen = reshard_tree(frozen, mesh, rules, names)
        batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
        state, metrics = sharded_step(train_step, mesh, rules)(
            state, frozen, batch, None)
        placed = {".".join(map(str, p)): str(tuple(x.placements))
                  for p, x in axlib.leaves_with_paths(state["trainable"])}
        return {"trainable": bridge.to_numpy(gather_tree(
            state["trainable"])), "loss": float(metrics["loss"]),
            "placements": placed}

    def logits():
        model = Model(cfg, ModelOptions(attn_impl="kernel"), device="cpu")
        params = bridge.params_from_jax(cfg, inp["params"], device="cpu")
        tables = bridge.tables_from_jax(inp["tasks"], device="cpu")
        params = reshard_tree(params, mesh, rules, names)
        tables = reshard_tree({"aot": tables}, mesh, rules, names)["aot"]
        tokens = put(torch.from_numpy(inp["tokens"]), ("batch", None))
        task_ids = put(torch.from_numpy(inp["task_ids"]), ("batch",))
        opt = PE.PEFTOptions(method="aot", aot=A.AoTOptions(mode="fused"))
        bundle = dict(PE.make({"aot": tables}, opt), task_ids=task_ids)
        seen = {}
        _record_locals(ops, seen)
        with shlib.use_rules(mesh, rules):
            lg = model.logits(params, tokens, bundle)
            one = reshard_tree({"aot": {"table": tables["table"][:, 1]}},
                               mesh, rules, names)["aot"]
            lg_one = model.logits(params, tokens, PE.make({"aot": one}, opt))
            lg_none = model.logits(params, tokens)
        return {"logits": lg.full_tensor().numpy(), "seen": seen,
                "logits_one": lg_one.full_tensor().numpy(),
                "logits_none": lg_none.full_tensor().numpy(),
                "table_one": str(tuple(one["table"].placements)),
                "placements": str(tuple(lg.placements)),
                "table": str(tuple(tables["table"].placements)),
                "wk": str(tuple(params["layers"][0]["attn"]["wk"].placements)),
                "wq": str(tuple(params["layers"][0]["attn"]["wq"].placements))}

    def ep(factor, zero_router):
        mcfg = _moe_cfg(configs, factor)
        p = {k: torch.from_numpy(np.array(v)) for k, v in inp["moe"].items()}
        if zero_router:
            p["router"] = torch.zeros_like(p["router"])
        x = torch.from_numpy(inp["moe_x"]).requires_grad_(True)
        with shlib.use_rules(mesh, rules):
            assert moe_mod._ep_applicable(mcfg, x)
            o, aux = moe_mod.apply_moe_ep(mcfg, p, x, torch.float32)
            o.sum().backward()
        return (o.detach().numpy(), {k: float(v) for k, v in aux.items()},
                bool(torch.isfinite(x.grad).all()))

    def compressed():
        g = torch.from_numpy(inp["grads"][rank])
        mean1, _ = all_reduce_compressed({"g": g}, {"g": torch.zeros(64)})
        acc, err = torch.zeros(64, dtype=torch.float64), {
            "g": torch.zeros(64)}
        for _ in range(16):
            m, err = all_reduce_compressed({"g": g}, err)
            acc += m["g"].double()
        return mean1["g"].numpy(), (acc / 16).numpy()

    def reshard():
        rng = np.random.default_rng(0)
        tree = {"groups": [{"b0": {"attn": {"wq": torch.from_numpy(
                    rng.normal(size=(2, 16, 32)).astype(np.float32))}}}],
                "embed": {"tok": torch.from_numpy(
                    rng.normal(size=(64, 16)).astype(np.float32))}}
        tree_a = reshard_tree(tree, mesh, rules, names)
        mgr = CheckpointManager(str(out / "ckpt"), async_save=False,
                                writer=rank == 0)
        mgr.save(1, tree_a)
        dist.barrier()
        restored, _ = mgr.restore(tree)
        mesh_b = mesh_mod.make_mesh(MESH_B, ("data", "model"), "cpu")
        tree_b = reshard_tree(restored, mesh_b, rules, names)
        whole = gather_tree(tree_b)
        same = all(torch.equal(a, b) for a, b in
                   zip(T.leaves(tree), T.leaves(whole)))
        place = lambda t: [str(tuple(x.placements)) for x in T.leaves(t)]
        rep = replicate_tree(tree_b, mesh)
        same_rep = all(torch.equal(a, b.to_local()) for a, b in
                       zip(T.leaves(tree), T.leaves(rep)))
        return {"bitwise": same, "a": place(tree_a), "b": place(tree_b),
                "local_b": [tuple(x.to_local().shape)
                            for x in T.leaves(tree_b)],
                "replicated": place(rep), "replicated_bitwise": same_rep}

    for name, fn in (("train", train), ("logits", logits),
                     ("ep", lambda: ep(8.0, False)),
                     ("ep_drops", lambda: ep(0.5, True)),
                     ("compressed", compressed), ("reshard", reshard)):
        try:
            res[name] = fn()
        except Exception:       # noqa: BLE001 reported by name
            errors[name] = traceback.format_exc()
        dist.barrier()
    if rank == 0:
        with open(out / "port.pkl", "wb") as f:
            pickle.dump({"results": res, "errors": errors}, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    {"reference": reference, "port": port}[sys.argv[1]](sys.argv[2])
