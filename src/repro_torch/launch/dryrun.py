"""The dry run: every (arch x shape) cell on the production mesh, with no
device, as one rank of it sees the step.

The port's counterpart of ``repro.launch.dryrun``. Where the reference
lowers and compiles each cell on 256 or 512 fake XLA devices, the port
runs each cell's step eagerly on ``meta`` tensors (shapes and dtypes,
no storage) laid out as DTensors on a ``DeviceMesh`` over a fake process
group of 256 ranks (one pod, (data 16, model 16)) or 512 (two pods,
(pod 2, data 16, model 16)) held by one process (``launch.mesh.
init_fake_group``). Rules, options and step functions follow the
reference's: the long-context or batched-decode rules or the
(sequence-parallel) TP/DP rules, bf16, ``attn_impl="chunked"`` with one
kv chunk spanning the sequence, ``mlstm_chunk=1024``, layer remat on;
PEFT "auto" (AoT where ``aot_applicable``, else BitFit) in a train step
with AoT's fc reparametrization at rank 64, a prefill over one fused AoT
table (the bare forward for an encoder), and a decode step over the
contiguous cache.

A :class:`DryRunCounter` (a ``TorchDispatchMode``) sees the rank's local
aten ops (DTensor desugars each op into them first) and counts:

* ``flops_per_device``: the FLOPs of the local matrix products
  (``torch.utils.flop_counter``'s formulas on the local shards; a
  ``FlopCounterMode`` over DTensors would count the global op);
* ``bytes_per_device``: each local op's input and output bytes, an
  unfused count. Eager PyTorch does move those bytes (one kernel per
  op), so it is larger than XLA's fused ``bytes accessed``. Views move
  nothing; a gather reads the rows it gathers, an in-place scatter
  writes the rows it scatters;
* ``collectives``: the functional collectives (and the c10d ones the
  expert-parallel MoE issues) by kind, ``{count, bytes, wire_bytes}``;
* ``memory``: ``argument_bytes`` (exact, the local shards of the
  arguments), ``peak_bytes`` (the largest sum of live local storages
  over the step, each storage alive while a tensor holds it),
  ``temp_bytes`` (peak less arguments) and ``output_bytes`` (outputs
  that are not arguments).

The eager count covers every layer, so there is no depth extrapolation.
Each cell runs in a process of its own: one process holds one group.

Usage (no card needed):
    python -m repro_torch.launch.dryrun --arch smollm-360m --shape decode_32k
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--jobs 4]

One JSON per cell lands in ``--out-dir`` (default results/dryrun_torch).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import weakref
from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import tree as T
from repro_torch.roofline.analysis import (COLLECTIVES, HW_H100,
                                           collective_record, format_row,
                                           roofline_report)

# the c10d collectives the expert-parallel MoE issues (through
# torch.distributed.nn.functional) -> the reference's HLO op names; each
# writes its result into its first argument
_C10D = {"allreduce_": "all-reduce", "alltoall_base_": "all-to-all"}
# ops that move no bytes: allocation without a fill, and bookkeeping
_NO_BYTES = {"empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided", "detach", "alias", "lift_fresh"}
# gathers read the rows they gather, not their whole source
_GATHERS = {"index", "embedding", "index_select", "gather"}
# in-place scatters write the rows they scatter, not their whole target
_SCATTERS = {"index_put_", "_index_put_impl_", "index_copy_", "scatter_",
             "index_add_", "masked_scatter_"}


def _tensors(tree):
    return [x for x in T.leaves(tree) if isinstance(x, torch.Tensor)]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class DryRunCounter(TorchDispatchMode):
    """Counts FLOPs, bytes, collectives and live storages of the local ops
    run while it is active (module note). Ops on DTensors are handed back
    (``NotImplemented``) so that DTensor desugars them into local ops
    first; the ops DTensor runs on fake tensors to propagate shapes are
    not counted."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives = {}
        self.cur = self.peak = 0
        self._refs, self._sizes = {}, {}

    # ------------------------------------------------------------------
    def hold(self, t) -> None:
        """Track the storage of tensor ``t`` (a DTensor's local one) while
        ``t`` lives."""
        if isinstance(t, DTensor):
            t = t._local_tensor
        if not isinstance(t, torch.Tensor):
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._refs:
            self._refs[key] += 1
        else:
            self._refs[key] = 1
            self._sizes[key] = st.nbytes()
            self.cur += self._sizes[key]
            self.peak = max(self.peak, self.cur)
        weakref.finalize(t, self._release, key)

    def _release(self, key) -> None:
        self._refs[key] -= 1
        if not self._refs[key]:
            del self._refs[key]
            self.cur -= self._sizes.pop(key)

    # ------------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types) or \
                torch._C._get_dispatch_mode(
                    torch._C._TorchDispatchModeKey.FAKE) is not None:
            return out          # DTensor's shape propagation
        self._count(func, args, kwargs, out)
        for t in _tensors(out):
            self.hold(t)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        name = packet.__name__
        ns = func.namespace
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if ns == "_c10d_functional" and name in COLLECTIVES:
            collective_record(self.collectives, COLLECTIVES[name],
                              sum(map(_nbytes, _tensors(out))))
            return
        if ns == "c10d" and name in _C10D:
            collective_record(self.collectives, _C10D[name],
                              sum(map(_nbytes, _tensors(args[0]))))
            return
        if ns in ("c10d", "_c10d_functional") or func.is_view or \
                name in _NO_BYTES:
            return
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if name in _GATHERS:
            src = ins[0]
            self.bytes += 2 * sum(map(_nbytes, outs)) + sum(
                _nbytes(x) for x in ins if x is not src)
        elif name in _SCATTERS:
            dst = ins[0]
            self.bytes += 2 * sum(_nbytes(x) for x in ins if x is not dst)
        else:
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))


# ---------------------------------------------------------------------------
# cell construction
# ---------------------------------------------------------------------------

def build_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               sequence_parallel: bool = True, peft_method: str = "auto",
               aot_rank: int = 64, loss_chunk: int = 512,
               chunk_q: int = 2048, chunk_kv: int = 0, cfg_override=None,
               shape_override=None, remat_save=(), remat_policy: str = "",
               decode_cache_seq: bool = False, mesh="production",
               device="meta"):
    """Returns (fn, args, mesh, rules, model, meta); ``fn(*args)`` is the
    cell's step on the specs ``args`` (``launch.specs``). ``mesh``:
    "production" (the production mesh over the process group, which must
    have its 256 or 512 ranks), a ``DeviceMesh``, or None for plain meta
    specs and no rules. ``device``: the model's ("meta" for the dry run; the
    card to run the step on specs materialized there). A skipped pair
    returns Nones and meta with the reference's reason."""
    from repro_torch import configs
    from repro_torch.core import aot as aot_mod
    from repro_torch.core import peft as peft_mod
    from repro_torch.distrib import sharding as shlib
    from repro_torch.launch import specs as sp
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.model import Model, ModelOptions
    from repro_torch.train.step import TrainConfig, make_train_step

    cfg = cfg_override if cfg_override is not None else configs.get(arch)
    shape = shape_override or cfg.shape(shape_name)
    reason = None if shape_override else cfg.shape_skip_reason(shape_name)
    if reason:
        return None, None, None, None, None, {
            "skipped": reason, "arch": arch, "shape": shape_name,
            "multi_pod": multi_pod}

    if mesh == "production":
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    if shape.kind == "decode" and shape.global_batch == 1:
        rules = shlib.long_context_rules(pod_axis=multi_pod)
    elif shape.kind == "decode" and decode_cache_seq:
        rules = shlib.decode_rules(kv_heads=cfg.num_kv_heads,
                                   pod_axis=multi_pod)
    else:
        rules = shlib.tp_dp_rules(pod_axis=multi_pod,
                                  sequence_parallel=(sequence_parallel and
                                                     shape.kind != "decode"))
    if mesh is None:
        rules = None
    # one kv chunk over the whole span, as the reference's (its reason,
    # XLA costing a loop body once, does not apply to an eager count, but
    # the work and the chunk's memory are then the reference's)
    opts = ModelOptions(compute_dtype=torch.bfloat16,
                        param_dtype=torch.bfloat16, attn_impl="chunked",
                        chunk_q=chunk_q, chunk_kv=chunk_kv or shape.seq_len,
                        remat=True, remat_save_names=tuple(remat_save),
                        remat_policy_name=remat_policy, mlstm_chunk=1024)
    model = Model(cfg, opts, device=device)
    spec_model = model if device == "meta" else Model(cfg, opts, "meta")

    if peft_method == "auto":
        peft_method = "aot" if cfg.aot_applicable else "bitfit"

    params = sp.param_specs(spec_model, mesh, rules)
    meta = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
            "peft_method": peft_method, "kind": shape.kind,
            "mesh": list(mesh.mesh.shape) if mesh is not None else [],
            "n_chips": mesh.size() if mesh is not None else 1}

    if shape.kind == "train":
        popt = peft_mod.PEFTOptions(
            method=peft_method,
            aot=aot_mod.AoTOptions(mode="fc", rank=aot_rank, dropout=0.0))
        tcfg = TrainConfig(peft=popt, loss_chunk=loss_chunk)
        init_state, train_step = make_train_step(model, tcfg)
        trainable = {"peft": sp.peft_specs(spec_model, popt)}
        state = sp.state_specs(init_state, trainable, mesh, rules)
        frozen = {"backbone": params}
        batch = sp.input_specs(cfg, shape, mesh, rules)
        args = (state, frozen, batch, sp.rng_spec())
        return train_step, args, mesh, rules, model, meta

    # serving cells use the paper's zero-cost path: fused AoT tables
    use_aot = cfg.aot_applicable
    table = (sp.fused_table_specs(spec_model, 1, mesh, rules) if use_aot
             else None)
    fopt = peft_mod.PEFTOptions(method="aot",
                                aot=aot_mod.AoTOptions(mode="fused"))
    front = lambda batch: {k: batch[k] for k in ("patches",) if k in batch}

    if shape.kind == "prefill":
        batch = sp.input_specs(cfg, shape, mesh, rules)
        if cfg.is_encoder_only:
            def prefill_fn(params, batch):
                return model.forward(params, None, frames=batch["frames"])
            args = (params, batch)
        elif use_aot:
            def prefill_fn(params, table, batch):
                peft = peft_mod.make(table, fopt)
                return model.prefill(params, batch["tokens"], peft,
                                     max_len=shape.seq_len, **front(batch))
            args = (params, table, batch)
        else:
            def prefill_fn(params, batch):
                return model.prefill(params, batch["tokens"], None,
                                     max_len=shape.seq_len, **front(batch))
            args = (params, batch)
        return prefill_fn, args, mesh, rules, model, meta

    # decode: the step writes the cache in place (the reference donates it)
    cache = sp.cache_specs(spec_model, shape.global_batch, shape.seq_len,
                           mesh, rules)
    tokens = sp.input_specs(cfg, shape, mesh, rules)["tokens"]
    pos = sp.scalar_spec(shape.seq_len - 1)
    if use_aot:
        def serve_step(params, table, tokens, pos, cache):
            peft = peft_mod.make(table, fopt)
            return model.decode_step(params, tokens, pos, cache, peft)
        args = (params, table, tokens, pos, cache)
    else:
        def serve_step(params, tokens, pos, cache):
            return model.decode_step(params, tokens, pos, cache, None)
        args = (params, tokens, pos, cache)
    return serve_step, args, mesh, rules, model, meta


def count_cell(fn, args, mesh, rules):
    """Run ``fn(*args)`` under ``rules`` on ``mesh`` with a
    :class:`DryRunCounter`; returns (counter, argument bytes, output
    bytes, seconds)."""
    from repro_torch.distrib import sharding as shlib
    from repro_torch.launch import specs as sp
    counter = DryRunCounter()
    arg_bytes = sp.argument_bytes(args)
    for x in _tensors(args):
        counter.hold(x)
    t0 = time.perf_counter()
    ctx = (shlib.use_rules(mesh, rules) if mesh is not None
           else contextlib.nullcontext())
    with ctx, counter:
        out = fn(*args)
    secs = time.perf_counter() - t0
    ins = {(x.to_local() if hasattr(x, "to_local") else x
            ).untyped_storage()._cdata for x in _tensors(args)}
    outs = [x.to_local() if hasattr(x, "to_local") else x
            for x in _tensors(out)]
    seen, out_bytes = set(), 0
    for x in outs:
        key = x.untyped_storage()._cdata
        if key not in ins and key not in seen:
            seen.add(key)
            out_bytes += x.untyped_storage().nbytes()
    return counter, arg_bytes, out_bytes, secs


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             out_dir: Optional[str] = None, verbose: bool = True,
             mesh="production", hw=HW_H100, **kw) -> dict:
    """One cell: build it, count its step, and write the record (the
    reference's keys where they mean the same) into ``out_dir``. The
    process group must hold the mesh's ranks (:func:`main` starts a fake
    one of 256 or 512)."""
    from repro_torch import configs
    from repro_torch.models.model import Model

    fn, args, mesh, rules, model, meta = build_cell(
        arch, shape_name, multi_pod=multi_pod, mesh=mesh, **kw)
    if fn is None:
        result = dict(meta)
        if out_dir:
            _write(out_dir, arch, shape_name, multi_pod, result)
        if verbose:
            print(f"SKIP {arch} x {shape_name}: {meta['skipped']}")
        return result

    counter, arg_bytes, out_bytes, secs = count_cell(fn, args, mesh, rules)
    n_params = Model.param_count(Model(model.cfg, model.opts, "meta").init())
    cfg = kw.get("cfg_override") or configs.get(arch)
    shape = kw.get("shape_override") or cfg.shape(shape_name)
    mem = {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
           "temp_bytes": counter.peak - arg_bytes,
           "peak_bytes": counter.peak}
    result = dict(meta)
    result.update({
        "run_s": secs,
        "flops_per_device": float(counter.flops),
        "bytes_per_device": float(counter.bytes),
        "collectives": counter.collectives,
        "n_params_total": n_params,
        "memory": mem,
        "fits": counter.peak <= hw["hbm_bytes"],
    })
    result["roofline"] = roofline_report(
        flops_per_device=result["flops_per_device"],
        bytes_per_device=result["bytes_per_device"],
        coll=counter.collectives, n_chips=meta["n_chips"], cfg=cfg,
        shape=shape, n_params_total=n_params, hw=hw)
    if verbose:
        coll_s = ", ".join(f"{k}:{int(v['count'])}"
                           for k, v in counter.collectives.items())
        print(f"OK {arch} x {shape_name} mesh={meta['mesh']} "
              f"run={secs:.1f}s")
        print(f"   memory/device: args={arg_bytes / 1e9:.3f}GB "
              f"temp={mem['temp_bytes'] / 1e9:.3f}GB "
              f"peak={counter.peak / 1e9:.3f}GB "
              f"out={out_bytes / 1e9:.3f}GB fits={result['fits']}")
        print(f"   flops/device={counter.flops:.3e} "
              f"bytes/device={counter.bytes:.3e} "
              f"collectives={{{coll_s}}}")
        print("   " + format_row(arch, shape_name, result["roofline"]))
    if out_dir:
        _write(out_dir, arch, shape_name, multi_pod, result)
    return result


def _write(out_dir, arch, shape_name, multi_pod, result):
    os.makedirs(out_dir, exist_ok=True)
    tag = "pod2" if multi_pod else "pod1"
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{tag}.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)


# ---------------------------------------------------------------------------
# orchestration
# ---------------------------------------------------------------------------

def all_cells():
    from repro_torch import configs
    for cfg in configs.ASSIGNED:
        for s in cfg.shapes:
            yield cfg.name, s.name


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--out-dir", default="results/dryrun_torch")
    ap.add_argument("--no-sp", action="store_true",
                    help="disable sequence-parallel activation sharding")
    ap.add_argument("--opt", action="store_true",
                    help="beyond-paper options: save the attention and MoE "
                         "outputs under remat, decode cache-seq sharding")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    if args.all:
        return _sweep(args)

    assert args.arch and args.shape, "--arch and --shape (or --all)"
    kw = {}
    if args.opt:
        kw = dict(remat_save=("attn_mix", "moe_out"), decode_cache_seq=True)
    from repro_torch.launch.mesh import init_fake_group
    init_fake_group(512 if args.multi_pod else 256)
    run_cell(args.arch, args.shape, multi_pod=args.multi_pod,
             out_dir=args.out_dir, sequence_parallel=not args.no_sp, **kw)
    return 0


def _sweep(args) -> int:
    """Every cell not yet written (all with ``--force``), each in a process
    of its own, ``--jobs`` at a time; returns the number that failed."""
    tag = "pod2" if args.multi_pod else "pod1"
    pending = []
    for arch, shape in all_cells():
        path = os.path.join(args.out_dir, f"{arch}__{shape}__{tag}.json")
        if os.path.exists(path) and not args.force:
            print(f"cached {arch} x {shape}")
            continue
        pending.append((arch, shape))
    jobs, failed = [], 0
    for arch, shape in pending:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--out-dir", args.out_dir]
        cmd += [f for f, on in (("--multi-pod", args.multi_pod),
                                ("--no-sp", args.no_sp),
                                ("--opt", args.opt)) if on]
        while len(jobs) >= args.jobs:
            failed += _reap(jobs, block=False)
        print("launch", arch, shape, flush=True)
        os.makedirs(os.path.join(args.out_dir, "logs"), exist_ok=True)
        log = open(os.path.join(args.out_dir, "logs",
                                f"{arch}__{shape}__{tag}.log"), "w")
        jobs.append(((arch, shape), log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT)))
    while jobs:
        failed += _reap(jobs, block=True)
    return 1 if failed else 0


def _reap(jobs, block: bool) -> int:
    """Wait for one job of ``jobs`` to end (polling every 0.5 s), report
    it (the end of its log when it failed) and take it out; returns 1 if
    it failed."""
    while True:
        for i, (cell, log, p) in enumerate(jobs):
            if p.poll() is not None or block and i == 0:
                p.wait()
                log.close()
                jobs.pop(i)
                print(f"done {cell} rc={p.returncode}", flush=True)
                if p.returncode:
                    with open(log.name) as f:
                        print(f.read()[-2000:], flush=True)
                return int(p.returncode != 0)
        time.sleep(0.5)


if __name__ == "__main__":
    sys.exit(main())
