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
interleave)`` layers, so llama4's is (dense, MoE): U = 2). The port keeps
a list of per-layer dicts in global layer order.
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
# biases, the q/k norms and the MoE router (the reference routes in float32
# from a float32 router; a bf16 one would move near-tie routes)
FLOAT32 = ("ln1", "ln2", "final_norm", "bq", "bk", "bv", "q_norm", "k_norm",
           "router")


def _to_torch(tree, device, dtype, norm=False):
    """numpy leaves -> tensors on ``device``, cast to ``dtype`` when given
    except under a key of ``FLOAT32`` (``norm`` on the way down), whose
    parameters stay float32 as in ``Model.init``."""
    if isinstance(tree, dict):
        return {k: _to_torch(v, device, dtype, norm or k in FLOAT32)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v, device, dtype, norm) for v in tree]
    t = torch.from_numpy(np.array(tree))              # a writable copy
    if dtype is not None and not norm:
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(cfg, tree: Dict[str, Any], device="cuda",
                    dtype: torch.dtype = None) -> Dict[str, Any]:
    """The reference's parameter tree -> the port's parameters on
    ``device`` (every leaf but the norms' cast to ``dtype`` when given):
    the embeddings (tokens, and learned positions where the config has
    them), the layers, the final norm and the untied head ``lm_head``."""
    dev = resolve_device(device)
    per_layer: List[Any] = [None] * cfg.num_layers
    for gi, (start, repeats, ulen) in enumerate(_layer_groups(cfg)):
        group = tree["groups"][gi]
        for r in range(repeats):
            for u in range(ulen):
                per_layer[start + r * ulen + u] = _take(group[f"b{u}"], r)
    out = {"embed": tree["embed"], "layers": per_layer,
           "final_norm": tree["final_norm"]}
    if "lm_head" in tree:
        out["lm_head"] = tree["lm_head"]
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


def params_to_jax(cfg, params) -> Dict[str, Any]:
    """The port's backbone parameters -> the reference's grouped layout
    (``params["groups"][gi]["b{u}"]`` with leaves ``(R, ...)``) as numpy,
    the inverse of :func:`params_from_jax`."""
    layers = to_numpy(params["layers"])
    stack = lambda trees: (np.stack(trees) if not isinstance(trees[0], dict)
                           else {k: stack([t[k] for t in trees])
                                 for k in trees[0]})
    groups = [{f"b{u}": stack([layers[start + r * ulen + u]
                               for r in range(repeats)])
               for u in range(ulen)}
              for start, repeats, ulen in _layer_groups(cfg)]
    out = {"embed": to_numpy(params["embed"]), "groups": groups,
           "final_norm": to_numpy(params["final_norm"])}
    if "lm_head" in params:
        out["lm_head"] = to_numpy(params["lm_head"])
    return out
