"""Carry the JAX reference's parameters, task tables, PEFT parameters and
KV caches into the port.

The input is the reference's pytree as nested dicts / lists of numpy arrays
(a caller holding JAX arrays turns them into numpy first, for instance with
``jax.device_get``); nothing here imports JAX.

The reference stacks each group of layers as ``params["groups"][gi]["b{u}"]``
with leaves ``(R, ...)``: group ``gi`` repeats its pattern unit ``R`` times,
and unit position ``u`` of repeat ``r`` is global layer
``start + r * U + u`` (``repro.models.model.layer_plan``). The port keeps
a list of per-layer dicts in global layer order.
"""
from __future__ import annotations

from dataclasses import fields
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from repro_torch.core import peft as peft_mod
from repro_torch.core.aot import AoTOptions
from repro_torch.device import resolve_device


def _layer_groups(cfg):
    """(start, repeats, unit length) of each reference layer group."""
    covered = cfg.pattern_repeats * len(cfg.pattern_unit)
    groups = [(0, cfg.pattern_repeats, len(cfg.pattern_unit))]
    if cfg.pattern_remainder:
        groups.append((covered, 1, len(cfg.pattern_remainder)))
    return groups


def _to_torch(tree, device, dtype, key=""):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device, dtype, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v, device, dtype, key) for v in tree]
    t = torch.from_numpy(np.array(tree))              # a writable copy
    # norm scales stay float32, as in Model.init
    if dtype is not None and key != "scale":
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(cfg, tree: Dict[str, Any], device="cuda",
                    dtype: torch.dtype = None) -> Dict[str, Any]:
    """The reference's parameter tree -> the port's parameters on
    ``device`` (matrices cast to ``dtype`` when given)."""
    dev = resolve_device(device)
    per_layer: List[Any] = [None] * cfg.num_layers
    for gi, (start, repeats, ulen) in enumerate(_layer_groups(cfg)):
        group = tree["groups"][gi]
        for r in range(repeats):
            for u in range(ulen):
                per_layer[start + r * ulen + u] = _take(group[f"b{u}"], r)
    out = {"embed": {"tok": tree["embed"]["tok"]},
           "layers": per_layer,
           "final_norm": tree["final_norm"]}
    return _to_torch(out, dev, dtype)


def _take(tree, r: int):
    if isinstance(tree, dict):
        return {k: _take(v, r) for k, v in tree.items()}
    return np.asarray(tree)[r]


def tables_from_jax(fused_list: Sequence[Dict[str, Any]], device="cuda",
                    dtype: torch.dtype = None) -> Dict[str, torch.Tensor]:
    """The reference's per-task fused tables ``[{'table': (L, V, d)}, ...]``
    -> the port's stacked ``{'table': (L, tasks, V, d)}`` on ``device``,
    layer-major as ``aot.stack_tasks`` stacks them."""
    dev = resolve_device(device)
    tables = [torch.from_numpy(np.array(f["table"]))
              for f in fused_list]
    return {"table": torch.stack(tables, dim=1).to(
        device=dev, dtype=dtype or tables[0].dtype)}


def cache_from_jax(cfg, cache: Sequence[Dict[str, Any]], device="cuda",
                   dtype: torch.dtype = None) -> Dict[str, torch.Tensor]:
    """The reference's grouped contiguous cache ``[{"b{u}": {"k": (R, b, S,
    kvh, hd), "v": ...}}, ...]`` (``Model.init_cache`` / ``prefill``) ->
    the port's ``{"k": (L, b, S, kvh, hd), "v": ...}`` in global layer
    order on ``device``."""
    dev = resolve_device(device)
    out = {}
    for name in ("k", "v"):
        per_layer: List[Any] = [None] * cfg.num_layers
        for gi, (start, repeats, ulen) in enumerate(_layer_groups(cfg)):
            for u in range(ulen):
                leaf = np.asarray(cache[gi][f"b{u}"][name])
                for r in range(repeats):
                    per_layer[start + r * ulen + u] = torch.from_numpy(
                        np.array(leaf[r]))
        stacked = torch.stack(per_layer)
        out[name] = stacked.to(device=dev, dtype=dtype or stacked.dtype)
    return out


def _options(cls, opt, **override):
    """A port dataclass ``cls`` with the same-named fields of ``opt`` (the
    reference's options, read by name, or the port's own)."""
    kw = {f.name: getattr(opt, f.name) for f in fields(cls)}
    kw.update(override)
    return cls(**kw)


def peft_from_jax(tree: Dict[str, Any], opt, device="cuda",
                  dtype: torch.dtype = None) -> Dict[str, Any]:
    """The reference's PEFT parameters (``repro.core.peft.init`` layout:
    numpy leaves stacked ``(L, ...)`` in global layer order, so an AoT
    ``{"aot": {"table": (L, V, d)}}`` too) and its ``PEFTOptions`` -> the
    port's bundle (``core.peft.make``) on ``device``, leaves cast to
    ``dtype`` when given."""
    port_opt = _options(peft_mod.PEFTOptions, opt,
                        aot=_options(AoTOptions, opt.aot))
    return peft_mod.make(_to_torch(tree, resolve_device(device), dtype),
                         port_opt)
