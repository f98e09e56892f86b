"""Shape-only stand-ins for every input of a dry-run cell: ``meta``
tensors, which carry a shape and a dtype and allocate nothing.

The port's counterpart of ``repro.launch.specs``, with its names and
trees: ``input_specs`` (a cell's batch), ``param_specs`` (the backbone,
every leaf in ``param_dtype``, as the reference keeps the frozen backbone
resident in bf16), ``peft_specs``, ``fused_table_specs`` (AoT's fused
tables), ``cache_specs`` (the contiguous decode cache), ``state_specs``
(the train step's state), ``rng_spec`` and ``scalar_spec``. The trees are
the port's: per-layer lists where the reference stacks layers.

On a mesh each leaf is a ``DTensor`` whose placements come from the
leaf's logical names (``distrib.axes``) through the rule set
(``distrib.sharding.placements_for``), and whose local tensor is the
shard one rank holds, on ``meta``. Without a mesh the leaves are plain
meta tensors of the global shape. :func:`argument_bytes` sums what one
rank holds, and :func:`materialize` turns the specs into real tensors on
a device (seeded normals for floating leaves, zeros for integer ones).

Three of the reference's device scalars are host values in the port's
eager step: the train step's counters (``state["step"]`` and AdamW's
``step``, Python ints), its randomness (``rng_spec``: a CPU
``torch.Generator``, which seeds AoT's dropout), and the decode position
(``scalar_spec``: an int). They hold no device bytes.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.distributed.tensor import DTensor

from repro_torch import tree as T
from repro_torch.core import peft as peft_mod
from repro_torch.distrib import axes as axlib
from repro_torch.distrib import sharding as shlib


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def place(x, names, mesh=None, rules=None):
    """A meta leaf ``x`` laid out on ``mesh`` by its logical ``names``: a
    DTensor whose local tensor is one rank's meta shard; ``x`` itself
    without a mesh."""
    if mesh is None:
        return x
    pl = shlib.placements_for(names, tuple(x.shape), mesh, rules)
    local = _meta(shlib.local_shape(x.shape, pl, mesh), x.dtype)
    return shlib.from_local(local, mesh, pl, tuple(x.shape))


def _with_sharding(tree, mesh, rules, names_fn):
    """Every tensor leaf of ``tree`` placed by ``names_fn(path, shape)``;
    other leaves (host scalars) as they are."""
    if mesh is None:
        return tree
    return axlib.map_with_path(
        lambda path, x: place(x, names_fn(path, tuple(x.shape)), mesh, rules)
        if isinstance(x, torch.Tensor) else x, tree)


def input_specs(cfg, shape, mesh=None, rules=None,
                dtype=torch.bfloat16) -> Dict[str, Any]:
    """The batch of one (arch x shape) cell: token ids (b, s) int32, or a
    decode step's (b, 1); a vision front-end's patches, an audio one's
    frames in ``dtype`` (an encoder takes no tokens and has no decode);
    the labels (b, s) int32 of a train cell."""
    b, s = shape.global_batch, shape.seq_len
    specs: Dict[str, Any] = {}
    if shape.kind == "decode":
        if cfg.frontend == "audio_frames":
            raise ValueError(f"{cfg.name} is encoder-only; no decode shapes")
        specs["tokens"] = _meta((b, 1), torch.int32)
    elif cfg.frontend == "audio_frames":
        specs["frames"] = _meta((b, s, cfg.frontend_dim), dtype)
        if shape.kind == "train":
            specs["labels"] = _meta((b, s), torch.int32)
    else:
        specs["tokens"] = _meta((b, s), torch.int32)
        if cfg.frontend == "vision_patches":
            specs["patches"] = _meta((b, cfg.frontend_len, cfg.frontend_dim),
                                     dtype)
        if shape.kind == "train":
            specs["labels"] = _meta((b, s), torch.int32)
    return _with_sharding(specs, mesh, rules,
                          lambda path, shp: axlib.batch_axes_for(path[-1],
                                                                 shp))


def param_specs(model, mesh=None, rules=None):
    """The backbone: ``Model.init``'s tree on meta (``model`` built with
    ``device="meta"``), every leaf in ``param_dtype``."""
    dt = model.opts.param_dtype
    shapes = T.map(lambda x: _meta(x.shape, dt), model.init())
    names = lambda path, shape: (
        axlib.per_layer(axlib.logical_axes_for)(path, shape)
        if path[0] == "layers" else axlib.logical_axes_for(path, shape))
    return _with_sharding(shapes, mesh, rules, names)


def peft_specs(model, popt: peft_mod.PEFTOptions, mesh=None, rules=None):
    """The PEFT parameters of ``popt`` (``core.peft.init`` on meta)."""
    shapes = peft_mod.init(model.cfg, popt, device="meta")
    return _with_sharding(shapes, mesh, rules, axlib.logical_axes_for)


def fused_table_specs(model, n_tasks: int = 1, mesh=None, rules=None,
                      dtype=torch.bfloat16):
    """AoT's fused tables ``{"aot": {"table": (L, V, d)}}`` for one task,
    (L, tasks, V, d) for more."""
    cfg = model.cfg
    L, V, d = cfg.num_layers, cfg.vocab_size, cfg.d_model
    shape = (L, V, d) if n_tasks == 1 else (L, n_tasks, V, d)
    spec = {"aot": {"table": _meta(shape, dtype)}}
    return _with_sharding(spec, mesh, rules, axlib.logical_axes_for)


def cache_specs(model, batch: int, max_len: int, mesh=None, rules=None):
    """The contiguous decode cache (``Model.cache_specs``): the stacked
    (L, b, S, kvh, hd) K and V, or a recurrent stack's per-layer
    entries, named as the reference's stacked leaves."""
    specs = _to_meta(model.cache_specs(batch, max_len))
    names = (axlib.per_layer(axlib.cache_axes_for) if model.layered
             else axlib.cache_axes_for)
    return _with_sharding(specs, mesh, rules, names)


def _to_meta(tree):
    """A tree of (shape, dtype) pairs -> the same tree of meta tensors."""
    if (isinstance(tree, tuple) and len(tree) == 2
            and isinstance(tree[1], torch.dtype)):
        return _meta(*tree)
    if isinstance(tree, dict):
        return {k: _to_meta(v) for k, v in tree.items()}
    return type(tree)(_to_meta(v) for v in tree)


def state_specs(init_state_fn, trainable_specs, mesh=None, rules=None):
    """The train step's state, ``init_state_fn`` (``make_train_step``'s)
    of the trainable tree: the trainable leaves and AdamW's float32
    moments, each laid out by its logical names; the step counters stay
    host ints."""
    plain = T.map(lambda x: _meta(x.shape, x.dtype), trainable_specs)
    state = init_state_fn(plain)
    return _with_sharding(state, mesh, rules, axlib.logical_axes_for)


def rng_spec(seed: int = 0) -> torch.Generator:
    """The train step's randomness: a CPU ``torch.Generator`` (the step
    seeds each layer's dropout from it); no device bytes."""
    return torch.Generator().manual_seed(seed)


def scalar_spec(value: int = 0) -> int:
    """The decode step's position: a host int (``Model.decode_step`` takes
    one for rows at one depth); no device bytes."""
    return int(value)


def argument_bytes(tree) -> int:
    """The bytes one rank holds for the tensor leaves of ``tree`` (a
    DTensor's local shard), each storage once."""
    seen, total = set(), 0
    for x in T.leaves(tree):
        if not isinstance(x, torch.Tensor):
            continue
        local = x.to_local() if isinstance(x, DTensor) else x
        st = local.untyped_storage()
        key = (st._cdata, local.device.type)
        if key not in seen:
            seen.add(key)
            total += st.nbytes()
    return total


def materialize(tree, device, seed: int = 0, scale: float = 0.02):
    """The specs of ``tree`` (plain meta tensors) as real tensors on
    ``device``: floating leaves ``scale`` times seeded standard normals
    drawn on the device, integer leaves zeros; other leaves as they
    are."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def real(x):
        if not isinstance(x, torch.Tensor):
            return x
        if x.dtype.is_floating_point:
            out = torch.empty(x.shape, dtype=x.dtype, device=device)
            return out.normal_(0.0, scale, generator=gen)
        return torch.zeros(x.shape, dtype=x.dtype, device=device)
    return axlib.map_with_path(lambda _, x: real(x), tree)
