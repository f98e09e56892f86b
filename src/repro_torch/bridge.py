"""Carry the JAX reference's parameters, task tables, PEFT parameters and
KV caches into the port, and the port's trees back out as numpy (to hold a
trained port state against the reference's).

The input is the reference's pytree as nested dicts / lists of numpy arrays
(a caller holding JAX arrays turns them into numpy first, for instance with
``jax.device_get``); nothing here imports JAX.

The reference stacks each group of layers as ``params["groups"][gi]["b{u}"]``
with leaves ``(R, ...)``: group ``gi`` repeats its pattern unit ``R`` times,
and unit position ``u`` of repeat ``r`` is global layer
``start + r * U + u`` (``repro.models.model.layer_plan``; with MoE on every
``interleave``-th layer the unit is widened to ``lcm(len(pattern_unit),
interleave)`` layers, so llama4's is (dense, MoE): U = 2; a remainder
after the repeats is a second group of one repeat, recurrentgemma's
(rglru, rglru) after its (rglru, rglru, attn) units). The port keeps a
list of per-layer dicts in global layer order, whatever each layer's block
kind.
"""
from __future__ import annotations

import math
from dataclasses import fields
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from repro_torch.core import peft as peft_mod
from repro_torch.core.aot import AoTOptions
from repro_torch.device import resolve_device


def _layer_groups(cfg):
    """(start, repeats, unit length) of each reference layer group, as the
    reference's ``layer_plan`` groups them."""
    ulen = len(cfg.pattern_unit)
    if cfg.moe is not None and cfg.moe.interleave > 1:
        ulen = math.lcm(ulen, cfg.moe.interleave)
    covered = cfg.pattern_repeats * len(cfg.pattern_unit)
    assert covered % ulen == 0, (cfg.name, ulen, covered)
    groups = [(0, covered // ulen, ulen)]
    if cfg.pattern_remainder:
        groups.append((covered, 1, len(cfg.pattern_remainder)))
    return groups


# the subtrees whose leaves stay float32, as in ``Model.init``: the norms'
# (scale, LayerNorm's bias; none for the non-parametric norm), the QKV
# biases, the q/k norms, the MoE router (the reference routes in float32
# from a float32 router; a bf16 one would move near-tie routes) and
# RG-LRU's ``lam`` (it enters the gates uncast); in a cache, the m/sLSTM
# ``state``
FLOAT32 = ("ln1", "ln2", "final_norm", "bq", "bk", "bv", "q_norm", "k_norm",
           "router", "lam", "state")


def _to_torch(tree, device, dtype, norm=False):
    """numpy leaves -> tensors on ``device``, cast to ``dtype`` when given
    except under a key of ``FLOAT32`` (``norm`` on the way down), whose
    parameters stay float32 as in ``Model.init``."""
    if isinstance(tree, dict):
        return {k: _to_torch(v, device, dtype, norm or k in FLOAT32)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(v, device, dtype, norm) for v in tree)
    t = torch.from_numpy(np.array(tree))              # a writable copy
    if dtype is not None and not norm:
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(cfg, tree: Dict[str, Any], device="cuda",
                    dtype: torch.dtype = None) -> Dict[str, Any]:
    """The reference's parameter tree -> the port's parameters on
    ``device`` (every leaf but the norms' cast to ``dtype`` when given):
    the embeddings (tokens, none for audio frames, and learned positions
    where the config has them, as many rows as the reference's ``max_pos``
    drew), the layers, the final norm, the untied head ``lm_head`` and a
    front-end's ``frontend.proj``."""
    dev = resolve_device(device)
    out = {"embed": tree["embed"], "layers": _ungroup(cfg, tree["groups"]),
           "final_norm": tree["final_norm"]}
    for name in ("lm_head", "frontend"):
        if name in tree:
            out[name] = tree[name]
    return _to_torch(out, dev, dtype)


def _take(tree, r: int):
    """Repeat r of a grouped subtree (leaves (R, ...))."""
    if isinstance(tree, dict):
        return {k: _take(v, r) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_take(v, r) for v in tree)
    return np.asarray(tree)[r]


def _ungroup(cfg, groups) -> List[Any]:
    """The reference's grouped trees ``[{"b{u}": (R, ...) leaves}, ...]``
    -> one subtree per layer in global layer order."""
    per_layer: List[Any] = [None] * cfg.num_layers
    for gi, (start, repeats, ulen) in enumerate(_layer_groups(cfg)):
        for r in range(repeats):
            for u in range(ulen):
                per_layer[start + r * ulen + u] = _take(
                    groups[gi][f"b{u}"], r)
    return per_layer


def _group(cfg, per_layer):
    """The inverse of :func:`_ungroup`: per-layer numpy subtrees ->
    ``[{"b{u}": leaves stacked (R, ...)}, ...]``."""
    def stack(trees):
        t0 = trees[0]
        if isinstance(t0, dict):
            return {k: stack([t[k] for t in trees]) for k in t0}
        if isinstance(t0, (list, tuple)):
            return type(t0)(stack([t[i] for t in trees])
                            for i in range(len(t0)))
        return np.stack(trees)
    return [{f"b{u}": stack([per_layer[start + r * ulen + u]
                             for r in range(repeats)])
             for u in range(ulen)}
            for start, repeats, ulen in _layer_groups(cfg)]


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
    order on ``device``; for a stack with recurrent blocks, the port's
    per-layer ``{"layers": [...]}`` (every kind's entry, the m/sLSTM
    states kept float32, the rest cast to ``dtype`` when given)."""
    dev = resolve_device(device)
    if set(cfg.layer_kinds) != {"attn"}:
        return {"layers": _to_torch(_ungroup(cfg, cache), dev, dtype)}
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
    numpy leaves stacked ``(L, ...)`` in global layer order: every method's
    tree, AoT's fc / kron reparametrizations or fused ``{"table": (L, V,
    d)}``, the P-Tuning v1 prompt, the classification head) and its
    ``PEFTOptions`` -> the port's bundle (``core.peft.make``) on
    ``device``, leaves cast to ``dtype`` when given."""
    port_opt = _options(peft_mod.PEFTOptions, opt,
                        aot=_options(AoTOptions, opt.aot))
    return peft_mod.make(_to_torch(tree, resolve_device(device), dtype),
                         port_opt)


def to_numpy(tree):
    """A port tree (nested dicts / lists of tensors) as the same tree of
    numpy arrays (float32 for bfloat16 leaves, which numpy lacks): the PEFT
    parameters come out in the reference's layout as they are."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _numpy_keep(tree):
    """:func:`to_numpy` that keeps tuples tuples (the mLSTM state)."""
    if isinstance(tree, dict):
        return {k: _numpy_keep(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy_keep(v) for v in tree)
    return to_numpy(tree)


def cache_to_jax(cfg, cache) -> List[Dict[str, Any]]:
    """The port's contiguous cache (either layout) -> the reference's
    grouped one as numpy (float32 for bf16 leaves), the inverse of
    :func:`cache_from_jax`."""
    if "layers" in cache:
        per_layer = [_numpy_keep(c) for c in cache["layers"]]
    else:
        per_layer = [{"k": to_numpy(cache["k"][i]),
                      "v": to_numpy(cache["v"][i])}
                     for i in range(cfg.num_layers)]
    return _group(cfg, per_layer)


def params_to_jax(cfg, params) -> Dict[str, Any]:
    """The port's backbone parameters -> the reference's grouped layout
    (``params["groups"][gi]["b{u}"]`` with leaves ``(R, ...)``) as numpy,
    the inverse of :func:`params_from_jax`."""
    groups = _group(cfg, to_numpy(params["layers"]))
    out = {"embed": to_numpy(params["embed"]), "groups": groups,
           "final_norm": to_numpy(params["final_norm"])}
    for name in ("lm_head", "frontend"):
        if name in params:
            out[name] = to_numpy(params[name])
    return out
