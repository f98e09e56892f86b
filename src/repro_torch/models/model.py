"""Model assembly: init, the KV cache layouts, the whole-sequence forward
and ``classify``, whole-prompt prefill, the decode step and the unified
ragged mixed step, each with the PEFT methods of the paper's Fig. 3
(fused AoT tables, BitFit, LoRA, adapters, P-Tuning v2; ``core.peft``).

Three implementations (``ModelOptions.attn_impl``): ``"kernel"`` serves
through the hand-written kernels (``kernels.ops``: the fused gather-add +
norm or the norm alone before each block, flash / decode / paged / ragged
attention; a bidirectional prefix goes through ``ops.flash_attention`` to
``layers.attention_chunked``, as the reference's wrapper sends it to XLA);
``"ref"`` and ``"chunked"`` run the whole-sequence entry points with no
cache (``forward``, ``logits``, ``classify``) in differentiable plain
PyTorch (``layers.attention_ref`` or the blockwise
``layers.attention_chunked``, the reference's default, ``layers.apply_norm``,
``h + rows`` for AoT): the training paths, which also run what only
training uses, AoT's fc / kron reparametrizations and full fine-tuning.
P-Tuning v1 runs the whole-sequence entry points on all three.
``prefill`` and ``decode_step`` also run under ``"ref"`` and
``"chunked"``, in plain PyTorch (``attention_chunked`` or
``attention_ref``, then ``layers.attention_decode``), as the reference
runs its serving entry points under any ``attn_impl``: the dry run
(``launch.dryrun``) costs them so. ``mixed_step`` serves on the kernels
only.

Layer rematerialization (``ModelOptions.remat``; the reference turns it
on by default, the port leaves it off: a training step here is bound by
the host's launches, and the recompute runs every forward op twice, for
memory no training path of the port runs short of; the dry run turns it
on, as the reference's): while autograd records, the whole-sequence
entry points run each remat unit (:func:`layer_units`: the reference's
layer groups) under ``torch.utils.checkpoint``, so the backward keeps
only each unit's input and runs the unit again; ``remat_save_names`` and
``remat_policy_name`` keep what the reference's policies keep
(:func:`remat_policy`). The reference's ``scan_layers`` and
``unroll_scans`` tell XLA how to compile its layer scan and inner scans;
an eager loop runs and counts every layer and step as it is, so they
have no counterpart here.

Counterpart of ``repro.models.model.Model``: attention stacks, pre-norm
causal decoders (RMSNorm, SwiGLU, RoPE, tied embeddings: the
serving path's smollm-360m; olmo-1b's non-parametric LayerNorm,
qwen2.5-14b's QKV bias and untied head, h2o-danube-1.8b's sliding window;
GeGLU and the embeddings' ``sqrt(d)`` scale; the mixture-of-experts
decoders qwen3-moe-30b-a3b, with its per-head q/k norm, and
llama4-maverick-400b-a17b, MoE on every second layer with a shared
expert: ``models.moe``; paligemma-3b, whose stub SigLIP patches,
projected by ``frontend.proj``, replace the first ``frontend_len`` token
embeddings and are attended bidirectionally with the rest of the
``prefix_lm_len`` prefix) and the paper's post-LN
encoders (LayerNorm, the GELU MLP, learned positions, an untied head,
full attention: roberta-large, deberta-xl, and hubert-xlarge, fed by stub
audio frames through ``frontend.proj`` and no token table), which run the
whole-sequence entry points only (:func:`check_servable`), and the
recurrent stacks
(``models.recurrent``, ``models.xlstm``): recurrentgemma-9b, RG-LRU
blocks with a GeGLU FFN interleaved 2:1 with local MQA attention, and
xlstm-350m, seven mLSTM blocks to one sLSTM, no positions. Every block
takes AoT's rows before it. Recurrent stacks serve whole sequences,
prefill and the decode step over a contiguous cache; the paged pool and
the continuous scheduler refuse them, as the reference's do: bucket
padding would fold into their state. A sliding-window stack's
contiguous cache is a ring of ``sliding_window`` rows when the window is
shorter than the cache, as the reference's default: position ``pos``
lives in row ``pos % sliding_window``, and the paged paths refuse it, as
the reference's do. Parameters are a plain
dict of tensors with ``params["layers"]`` a list of per-layer dicts in
layer order (the bridge unpacks the reference's grouped ``(R, U, ...)``
stacking; eager PyTorch gains nothing from stacked leaves). The contiguous
cache of an attention-only stack is ``{"k", "v"}`` of shape ``(L, b, S,
kvh, hd)``; a stack with recurrent blocks holds one entry per layer,
``{"layers": [...]}``: an attention layer's ``{"k", "v"}`` (b, S, kvh,
hd), an RG-LRU layer's ``{"conv", "h"}``, an mLSTM layer's ``{"conv",
"state": (C, n, m)}`` and an sLSTM layer's ``{"conv", "state": {"h", "c",
"n", "m"}}`` (the reference's ``_block_cache_spec``). The paged KV pool is
``{"k", "v"}`` of shape ``(L, num_blocks, block_size, kvh, hd)``.
"""
from __future__ import annotations

import contextlib
import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import tree as T
from repro_torch.configs.base import (BLOCK_ATTN, BLOCK_MLSTM, BLOCK_RGLRU,
                                      BLOCK_SLSTM, ArchConfig)
from repro_torch.core import aot as aot_mod
from repro_torch.core.peft import lora_scale
from repro_torch.device import generator, resolve_device
from repro_torch.distrib import axes as axlib
from repro_torch.distrib import sharding as shlib
from repro_torch.distrib.sharding import constrain, write_rows
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import recurrent as rec_mod
from repro_torch.models import xlstm as xl_mod

# the PEFT methods the model serves (core.peft)
SERVED = ("none", "aot", "bitfit", "lora", "adapters", "ptv2")
# P-Tuning v1 runs whole sequences on every attn_impl (its prompt is a
# bidirectional prefix); the serving entry points refuse it, since the
# reference's prefill returns the wrong cache position for it (ROADMAP C12)
WHOLE = ("ptv1",)
# the methods (besides AoT's fc / kron reparametrizations) that run only
# whole-sequence under attn_impl="ref" or "chunked", the training paths
TRAINED = ("ft",)
_PTV2_PAGED = ("P-Tuning v2's prefix is not held in the paged pool; serve "
               "ptv2 with static batches over a contiguous cache (the "
               "reference's paged and ragged steps skip the prefix)")
# the reference's words (repro/models/model.py, _attention's paged branches)
SWA_PAGED_DECODE = ("paged decode has no sliding-window masking; serve SWA "
                    "models with the contiguous slot layout")
SWA_PAGED_TICK = ("paged serving has no sliding-window masking; serve SWA "
                  "models with the contiguous slot layout")
RECURRENT = (BLOCK_RGLRU, BLOCK_MLSTM, BLOCK_SLSTM)


@dataclass(frozen=True)
class ModelOptions:
    compute_dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32
    # "kernel" (reference: "pallas") | "chunked" | "ref"
    attn_impl: str = "kernel"
    chunk_q: int = 1024             # attention_chunked's chunks ("chunked")
    chunk_kv: int = 1024
    max_learned_pos: int = 0        # 0: from the config's shapes (max_pos)
    mlstm_chunk: int = 64           # mLSTM's chunk (xlstm.mlstm_chunkwise)
    # layer rematerialization while autograd records (_remat_unit)
    remat: bool = False
    remat_save_names: Tuple[str, ...] = ()  # "attn_mix", "moe_out" kept
    remat_policy_name: str = ""     # "" | "dots": keep products w/o batch


def remat_policy(opts: ModelOptions):
    """The selective remat policy of ``opts`` (None: recompute every op):
    keep what ``checkpoint_name`` tags with one of ``remat_save_names``
    and, under ``"dots"``, the outputs of products with no batch dimension
    (``mm``, ``addmm``; a ``bmm`` is recomputed), as the reference's
    ``checkpoint_dots_with_no_batch_dims``."""
    if opts.remat_policy_name not in ("", "dots"):
        raise ValueError(f"remat_policy_name {opts.remat_policy_name!r}: "
                         "'' or 'dots'")
    names, dots = set(opts.remat_save_names), opts.remat_policy_name
    if not names and not dots:
        return None
    keep = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

    def policy(ctx, op, *args, **kwargs):
        if L.tagged() in names or dots and op in keep:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    return policy


def layer_units(cfg: ArchConfig):
    """The (first, end) layers of each remat unit, the reference's layer
    groups (``layer_plan``): ``pattern_repeats`` units of the pattern
    (widened to ``lcm(len(pattern_unit), interleave)`` layers with MoE on
    every ``interleave``-th layer), then the remainder as one unit."""
    ulen = len(cfg.pattern_unit)
    if cfg.moe is not None and cfg.moe.interleave > 1:
        ulen = math.lcm(ulen, cfg.moe.interleave)
    covered = cfg.pattern_repeats * len(cfg.pattern_unit)
    units = [(lo, lo + ulen) for lo in range(0, covered, ulen)]
    if cfg.pattern_remainder:
        units.append((covered, cfg.num_layers))
    return units


def check_supported(cfg: ArchConfig) -> None:
    """Raise unless the whole-sequence entry points (``forward``,
    ``logits``, ``classify``: serving whole sequences and training) run
    ``cfg``: attention blocks, RG-LRU blocks (with the config's MLP when
    d_ff > 0), mLSTM and sLSTM blocks; pre-norm with RMSNorm, LayerNorm or
    the non-parametric norm, or (attention only) post-LN with LayerNorm, a
    SwiGLU, GeGLU or GELU MLP or a routed MoE FFN on the config's MoE
    layers, RoPE, learned or no positions (embeddings scaled by sqrt(d) or
    not), an optional QKV bias and q/k norm, causal (full or
    sliding-window, with or without a bidirectional prefix) or an
    encoder's full attention, with or without a softcap on the scores
    (plain attention only, as the reference routes it); token ids, with or without vision patches
    over the first positions, or audio frames (no token table, so an
    untied head)."""
    bad = []
    kinds = set(cfg.layer_kinds)
    if not kinds <= {BLOCK_ATTN, *RECURRENT}:
        bad.append(f"block kinds {sorted(kinds)}")
    if kinds & set(RECURRENT) and cfg.post_ln:
        bad.append("post-LN recurrent blocks")
    if kinds & set(RECURRENT) and cfg.prefix_lm_len:
        bad.append("a bidirectional prefix over recurrent blocks")
    if not (cfg.causal or cfg.is_encoder_only):
        bad.append("bidirectional attention outside an encoder")
    if not (cfg.attn_kind == "full" or (
            cfg.attn_kind == "swa" and cfg.causal and cfg.sliding_window)):
        bad.append(f"attention {cfg.attn_kind!r} (causal {cfg.causal}, "
                   f"window {cfg.sliding_window})")
    if cfg.frontend not in (None, "vision_patches", "audio_frames") or (
            cfg.frontend == "audio_frames" and cfg.tie_embeddings):
        bad.append(f"frontend {cfg.frontend!r}"
                   + (" with a head tied to a token table it lacks"
                      if cfg.frontend == "audio_frames" else ""))
    if cfg.norm_type not in ("rmsnorm", "layernorm", "nonparametric") or (
            cfg.post_ln and cfg.norm_type != "layernorm"):
        bad.append(f"{cfg.norm_type} {'post' if cfg.post_ln else 'pre'}-LN")
    if cfg.mlp_type not in ("swiglu", "geglu", "gelu") or (
            cfg.d_ff <= 0 and BLOCK_ATTN in kinds):
        bad.append(f"mlp {cfg.mlp_type!r} (d_ff {cfg.d_ff})")
    if cfg.pos_type not in ("rope", "learned", "none"):
        bad.append(f"positions {cfg.pos_type!r}")
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: not ported yet: {'; '.join(bad)}")


def check_servable(cfg: ArchConfig) -> None:
    """Raise unless the serving entry points (``prefill``, ``decode_step``,
    ``mixed_step``, ``ServeEngine``) serve ``cfg``: a causal stack with
    RoPE or no positions (xlstm-350m). An encoder (non-causal, learned
    positions) runs the whole-sequence entry points only. The reference
    asserts causality in its ``mixed_step`` but not in ``prefill`` /
    ``decode_step``; the port refuses all three (ROADMAP C6)."""
    check_supported(cfg)
    if not cfg.causal or cfg.pos_type not in ("rope", "none"):
        raise NotImplementedError(
            f"{cfg.name}: the serving entry points serve causal stacks "
            "with RoPE or no positions; an encoder runs Model.forward / "
            "logits / classify")


def refuse_prefix_lm(cfg: ArchConfig, what: str) -> None:
    """Raise NotImplementedError for ``what`` (the paged pool, paged
    decode, the mixed step) on a stack with a bidirectional prefix, in the
    reference's words (its ``mixed_step`` asserts causal masking): bucket
    padding and other requests' tokens would enter the prefix."""
    if cfg.prefix_lm_len:
        raise NotImplementedError(
            f"{cfg.name}: {what} relies on causal masking, and a "
            f"bidirectional prefix ({cfg.prefix_lm_len} tokens) is not; "
            "serve it with static batches over a contiguous cache")


def recurrent_kinds(cfg: ArchConfig):
    """The recurrent block kinds of ``cfg``'s stack (empty: attention
    only)."""
    return sorted(set(cfg.layer_kinds) & set(RECURRENT))


def refuse_recurrent(cfg: ArchConfig, what: str) -> None:
    """Raise NotImplementedError with the reference's reason for ``what``
    (the paged pool, the mixed step, continuous batching) on a stack with
    recurrent blocks: bucket padding folds into their state, and their
    state has no paged layout."""
    kinds = recurrent_kinds(cfg)
    if kinds:
        raise NotImplementedError(
            f"{cfg.name}: {what} needs attention-only stacks: recurrent "
            f"blocks ({set(kinds)}) fold bucket padding into their state; "
            "serve them with static batches (ServeEngine.generate)")


def ring_spans(n: int, rows: int):
    """The copies that put the last ``rows`` of positions ``[0, n)`` into a
    ring of ``rows`` rows, position j at row ``j % rows``: at most two
    (first position, end position, first row) runs."""
    lo = max(0, n - rows)
    cut = min(n, (lo // rows + 1) * rows)       # where the row index wraps
    spans = [(lo, cut, lo % rows)]
    if cut < n:
        spans.append((cut, n, 0))
    return spans


def check_table_reach(token_rows, token_pos, npages: int,
                      block_size: int) -> None:
    """Raise ValueError if a live token (position >= 0) lies past its
    slot's block table of ``npages`` pages of ``block_size`` positions.
    ``token_rows`` / ``token_pos``: host arrays (numpy or CPU tensors), so
    the check costs no wait on the card. The reference clamps the page
    index there and overwrites a resident row; the port refuses."""
    pos = np.asarray(token_pos)
    bad = np.flatnonzero(pos >= npages * block_size)
    if bad.size:
        t = int(bad[0])
        raise ValueError(
            f"token {t} of slot {int(np.asarray(token_rows)[t])} at position "
            f"{int(pos[t])} lies past its block table ({npages} pages of "
            f"{block_size} positions)")


def check_write_fresh(token_rows, token_pos, committed) -> None:
    """Raise ValueError if a live token would write K/V below its slot's
    committed depth ``committed[slot]`` (host arrays): the rows readers
    already trust, which a retried tick must not have changed (the
    write-fresh rule of :meth:`Model.mixed_step`)."""
    pos = np.asarray(token_pos)
    rows = np.asarray(token_rows)
    low = np.flatnonzero((pos >= 0) & (pos < np.asarray(committed)[rows]))
    if low.size:
        t = int(low[0])
        raise ValueError(
            f"token {t} of slot {int(rows[t])} writes position {int(pos[t])} "
            f"below the slot's committed depth "
            f"{int(np.asarray(committed)[rows[t]])}")


def check_write_exclusive(token_rows, token_pos, block_tables, refs,
                          block_size: int) -> None:
    """Raise ValueError if a live token would write K/V into a page that
    has another holder (``refs[page] > 1``: a forked sibling, the prefix
    cache, a compacted duplicate): the write-exclusive half of the
    write-fresh rule of :meth:`Model.mixed_step`. Host arrays, so the
    check costs no wait on the card."""
    pos = np.asarray(token_pos)
    rows = np.asarray(token_rows)
    tables = np.asarray(block_tables)
    # positions past the table are check_table_reach's to refuse
    live = np.flatnonzero((pos >= 0) & (pos < tables.shape[1] * block_size))
    pages = tables[rows[live], pos[live] // block_size]
    shared = np.flatnonzero(np.asarray(refs)[pages] > 1)
    if shared.size:
        t = int(live[shared[0]])
        page = int(pages[shared[0]])
        raise ValueError(
            f"token {t} of slot {int(rows[t])} writes position "
            f"{int(pos[t])} into page {page}, which has "
            f"{int(np.asarray(refs)[page])} holders")


class Model:
    def __init__(self, cfg: ArchConfig, opts: ModelOptions = ModelOptions(),
                 device="cuda"):
        check_supported(cfg)
        if opts.attn_impl not in ("kernel", "chunked", "ref"):
            raise ValueError(f"attn_impl {opts.attn_impl!r}: 'kernel', "
                             "'chunked' or 'ref'")
        self.cfg = cfg
        self.opts = opts
        self.device = resolve_device(device)
        self.kinds = cfg.layer_kinds    # each layer's block kind
        # a per-layer cache ({"layers": [...]}) for stacks with recurrent
        # blocks; attention-only stacks keep the stacked {"k", "v"}
        self.layered = bool(recurrent_kinds(cfg))
        self._routes = None         # the open record_routes() list, if any
        self._in_remat = False      # inside a remat unit (_remat_unit)

    # ------------------------------------------------------------------
    def max_pos(self) -> int:
        """Rows of the learned position table: ``max_learned_pos``, else
        the config's longest shape + 128 (the reference's ``max_pos``)."""
        if self.opts.max_learned_pos:
            return self.opts.max_learned_pos
        return max(s.seq_len for s in self.cfg.shapes) + 128

    def init(self, seed: int = 0) -> Dict[str, Any]:
        """Random parameters from a ``torch.Generator`` on the device, with
        the reference's distributions and tree: embeddings (the token
        table, learned positions ``(max_pos(), d)``) truncated-normal std
        0.02, dense weights (the untied head ``lm_head.w`` (d, V) too)
        truncated-normal std 1/sqrt(fan_in), norm scales 1 and biases 0,
        MLP and QKV biases 0, q/k norm scales 1. A MoE layer (the config's
        ``moe_layer_mask``) holds ``moe`` (``moe.moe_init``) where the
        others hold ``mlp``. An RG-LRU layer holds ``ln1`` and ``rglru``
        (``recurrent.rglru_init``), and ``ln2`` / ``mlp`` when d_ff > 0; an
        mLSTM or sLSTM layer ``ln1`` and ``core`` (``xlstm``'s block
        inits), as the reference's ``_block_init``. Norm parameters, the
        QKV biases, the q/k norms, the router and RG-LRU's ``lam`` stay
        float32 (the reference's ``attn_init``, ``moe_init`` and
        ``rglru_init``, whose ``lam`` enters the gates uncast); everything
        else is stored in ``param_dtype``. A front-end adds
        ``frontend.proj`` (frontend_dim, d), dense, drawn last; audio
        frames have no token table ``embed.tok`` (the reference's tree)."""
        cfg, dev, pdt = self.cfg, self.device, self.opts.param_dtype
        gen = generator(dev, seed)
        d, V = cfg.d_model, cfg.vocab_size

        dense = lambda *shape: L.dense_init(shape, gen, dev, pdt)
        norm = lambda: L.norm_init(cfg, dev)

        def layer(kind, moe):
            if kind == BLOCK_RGLRU:
                lp = {"ln1": norm(), "rglru": rec_mod.rglru_init(cfg, gen, dev,
                                                                 pdt)}
                if cfg.d_ff > 0:
                    lp.update(ln2=norm(), mlp=L.mlp_init(cfg, gen, dev, pdt))
                return lp
            if kind in (BLOCK_MLSTM, BLOCK_SLSTM):
                init = (xl_mod.mlstm_block_init if kind == BLOCK_MLSTM
                        else xl_mod.slstm_block_init)
                return {"ln1": norm(), "core": init(cfg, gen, dev, pdt)}
            lp = {"ln1": norm(), "attn": L.attn_init(cfg, gen, dev, pdt),
                  "ln2": norm()}
            if moe:
                lp["moe"] = moe_mod.moe_init(cfg, gen, dev, pdt)
            else:
                lp["mlp"] = L.mlp_init(cfg, gen, dev, pdt)
            return lp

        embed = {}
        if cfg.frontend != "audio_frames":
            embed["tok"] = L.embed_init((V, d), gen, dev, pdt)
        if cfg.pos_type == "learned":
            embed["pos"] = L.embed_init((self.max_pos(), d), gen, dev, pdt)
        params = {"embed": embed,
                  "layers": [layer(k, m) for k, m in
                             zip(self.kinds, cfg.moe_layer_mask())],
                  "final_norm": norm()}
        if not cfg.tie_embeddings:
            params["lm_head"] = {"w": dense(d, V)}
        if cfg.frontend:
            params["frontend"] = {"proj": dense(cfg.frontend_dim, d)}
        return params

    @staticmethod
    def param_count(params) -> int:
        def count(tree):
            if isinstance(tree, torch.Tensor):
                return tree.numel()
            items = tree.values() if isinstance(tree, dict) else tree
            return sum(count(v) for v in items)
        return count(params)

    # ------------------------------------------------------------------
    def window(self) -> int:
        """The attention's sliding window (0: full attention)."""
        cfg = self.cfg
        return cfg.sliding_window if cfg.attn_kind == "swa" else 0

    def _cache_len(self, max_len: int) -> int:
        """Rows of a contiguous cache for ``max_len`` tokens (the caller's
        rounded length): the window when the cache is a ring (SWA with a
        window shorter than ``max_len``), else ``max_len``, as the
        reference's."""
        w = self.window()
        if w and w < max_len:
            return w
        return max_len

    def is_ring(self, rows: int) -> bool:
        """Whether a contiguous cache of ``rows`` rows is the ring: position
        ``pos`` in row ``pos % rows``, every resident row inside the window
        (the reference's ``is_ring``)."""
        return bool(self.window() and rows == self.window())

    def cache_specs(self, batch: int, max_len: int):
        """Shape and dtype of each contiguous cache leaf: per layer a
        (batch, S, kvh, hd) K and V, stacked (L, batch, S, kvh, hd); with
        recurrent blocks, :meth:`init_cache`'s per-layer tree with a
        (shape, dtype) pair for each leaf."""
        cfg = self.cfg
        if self.layered:
            return _specs(self._layered_cache(batch, max_len, "meta"))
        shape = (cfg.num_layers, batch, self._cache_len(max_len),
                 cfg.num_kv_heads, cfg.head_dim)
        return {"k": (shape, self.opts.compute_dtype),
                "v": (shape, self.opts.compute_dtype)}

    def init_cache(self, batch: int, max_len: int):
        """A fresh contiguous cache (the stabilizers of m/sLSTM states at
        -1e30, everything else zeros). Under ``use_rules`` on a
        ``DeviceMesh`` each leaf is a DTensor laid out by the cache's
        logical names, and each rank allocates its shard only."""
        mesh, rules = shlib._current()
        if isinstance(mesh, DeviceMesh):
            return self._cache_on_mesh(batch, max_len, mesh, rules)
        if self.layered:
            return self._layered_cache(batch, max_len, self.device)
        return {name: torch.zeros(shape, dtype=dt, device=self.device)
                for name, (shape, dt) in
                self.cache_specs(batch, max_len).items()}

    def _cache_on_mesh(self, batch: int, max_len: int, mesh, rules):
        """:meth:`init_cache` on ``mesh``: shapes from a cache on ``meta``,
        each leaf's value from a fresh one-row cache on the CPU (every
        fresh leaf holds one value)."""
        if self.layered:
            shapes = self._layered_cache(batch, max_len, "meta")
            probe = self._layered_cache(1, 1, "cpu")
            names = axlib.per_layer(axlib.cache_axes_for)
        else:
            shapes = {name: torch.empty(shape, dtype=dt, device="meta")
                      for name, (shape, dt) in
                      self.cache_specs(batch, max_len).items()}
            probe = {name: torch.zeros(1) for name in shapes}
            names = axlib.cache_axes_for
        fills = {axlib.path_strings(p): float(x.reshape(-1)[0])
                 for p, x in axlib.leaves_with_paths(probe)}
        return axlib.map_with_path(
            lambda path, x: shlib.full_on_mesh(
                tuple(x.shape), fills[path], x.dtype, self.device,
                names(path, tuple(x.shape)), mesh, rules), shapes)

    def _layered_cache(self, batch: int, max_len: int, device):
        """The per-layer cache of a stack with recurrent blocks on
        ``device``, shaped as the reference's ``_block_cache_spec``: an
        attention layer's K and V (batch, S, kvh, hd), an RG-LRU layer's
        conv inputs and state, an m/sLSTM layer's conv inputs and float32
        state, the conv inputs and RG-LRU state in the compute dtype."""
        cfg, dt = self.cfg, self.opts.compute_dtype
        S = self._cache_len(max_len)
        init = {BLOCK_RGLRU: rec_mod.rglru_init_cache,
                BLOCK_MLSTM: xl_mod.mlstm_init_cache,
                BLOCK_SLSTM: xl_mod.slstm_init_cache}
        layers = []
        for kind in self.kinds:
            if kind == BLOCK_ATTN:
                kv = lambda: torch.zeros(batch, S, cfg.num_kv_heads,
                                         cfg.head_dim, dtype=dt,
                                         device=device)
                layers.append({"k": kv(), "v": kv()})
            else:
                layers.append(init[kind](cfg, batch, dt, device))
        return {"layers": layers}

    def kv(self, cache, i: int):
        """Layer i's contiguous K and V (b, S, kvh, hd), views that writes
        go through, in either cache layout."""
        if self.layered:
            return cache["layers"][i]["k"], cache["layers"][i]["v"]
        return cache["k"][i], cache["v"][i]

    def cache_rows(self, cache) -> int:
        """S, the rows of the attention layers' contiguous caches (0 for a
        stack with no attention layer)."""
        if not self.layered:
            return cache["k"].shape[2]
        for kind, c in zip(self.kinds, cache["layers"]):
            if kind == BLOCK_ATTN:
                return c["k"].shape[1]
        return 0

    def paged_cache_specs(self, num_blocks: int, block_size: int):
        """Shape and dtype of each paged pool leaf: a global
        (L, num_blocks, block_size, kvh, hd) K and V page pool shared by
        every request. Attention-only stacks: recurrent state has no paged
        layout (the reference asserts the same)."""
        cfg = self.cfg
        refuse_recurrent(cfg, "the paged KV pool")
        refuse_prefix_lm(cfg, "the paged KV pool")
        shape = (cfg.num_layers, num_blocks, block_size, cfg.num_kv_heads,
                 cfg.head_dim)
        return {"k": (shape, self.opts.compute_dtype),
                "v": (shape, self.opts.compute_dtype)}

    def init_paged_cache(self, num_blocks: int, block_size: int):
        return {name: torch.zeros(shape, dtype=dt, device=self.device)
                for name, (shape, dt) in
                self.paged_cache_specs(num_blocks, block_size).items()}

    def head_weight(self, params):
        """The unembedding (d, V) in the compute dtype: E^T when tied, else
        the untied head ``lm_head.w``."""
        dt = self.opts.compute_dtype
        if self.cfg.tie_embeddings:
            return params["embed"]["tok"].to(dt).T
        return params["lm_head"]["w"].to(dt)

    def unembed(self, params, h):
        """h @ :meth:`head_weight` in the compute dtype (under a mesh, vocab
        takes the model axis)."""
        logits = shlib.matmul(h.to(self.opts.compute_dtype),
                              self.head_weight(params))
        return constrain(logits, "batch", None, "vocab")

    # ------------------------------------------------------------------
    # PEFT: the per-layer hooks of every entry point (the reference's
    # _aot_bias, _attention and _ffn)
    # ------------------------------------------------------------------
    def _method(self, peft, whole: bool = False) -> str:
        """The bundle's method ("none" for no bundle); raises for one the
        model does not run: the served methods (AoT as fused tables) run
        everywhere, P-Tuning v1 (``WHOLE``) only ``whole``-sequence with no
        cache, the training-time ones (``TRAINED``, AoT's fc / kron) only
        so and under ``attn_impl="ref"`` or ``"chunked"``."""
        method = peft["method"] if peft else "none"
        reparam = method == "aot" and peft["opt"].aot.mode != "fused"
        if method in SERVED and not reparam:
            return method
        if whole and (method in WHOLE or (
                self.opts.attn_impl != "kernel" and (
                    reparam or method in TRAINED))):
            return method
        where = ("" if method in WHOLE else " with attn_impl='ref' or "
                 "'chunked' (the training paths)")
        raise NotImplementedError(
            f"peft {method!r} runs only through forward / logits / classify"
            f"{where}; the serving entry points serve {', '.join(SERVED)}, "
            "AoT as fused tables")

    def _serving(self, entry: str, kernels: bool = False) -> None:
        """Raise unless the serving entry point ``entry`` runs here: a
        servable backbone (:func:`check_servable`), and with ``kernels``
        (the mixed step) on the kernels."""
        check_servable(self.cfg)
        if kernels and self.opts.attn_impl != "kernel":
            raise NotImplementedError(
                f"{entry} runs the serving kernels only (attn_impl="
                f"'kernel'); attn_impl={self.opts.attn_impl!r} runs the "
                "whole-sequence entry points")

    def _layer_generators(self, rng):
        """One dropout generator per layer, seeded by draws from the step's
        generator ``rng`` (the reference folds the layer index into its
        key); None without ``rng``."""
        if rng is None:
            return None
        seeds = torch.randint(0, 2 ** 62, (self.cfg.num_layers,),
                              generator=rng, device=rng.device).tolist()
        return [generator(self.device, s)
                for s in seeds]

    def _aot_rows(self, peft, i, ids, task_ids, e_rows, gens):
        """Layer i's AoT rows (T, d) in the compute dtype for the flat token
        ``ids`` (T,), in plain PyTorch (the reference's ``_aot_bias``): from
        the fc reparametrization of ``e_rows`` = E[ids], the kron one of
        ids (each with dropout when ``gens`` holds layer i's generator), or
        the fused table (stacked tasks' by ``task_ids``)."""
        ao, pp, dt = peft["opt"].aot, peft["params"]["aot"], \
            self.opts.compute_dtype
        gen = gens[i] if gens is not None else None
        if ao.mode == "fc":
            return shlib.rowwise(lambda e, lp: aot_mod.rows_fc(
                lp, e, ao, dt, gen), e_rows, aot_mod.layer_params(pp, i))
        if ao.mode == "kron":
            return aot_mod.rows_kron(aot_mod.layer_params(pp, i), ids, ao,
                                     dt, gen)
        table = pp["table"][i]
        if table.dim() == 3:
            return aot_mod.rows_fused_multitask(table, task_ids,
                                                ids[:, None], dt)[:, 0]
        return aot_mod.rows_fused({"table": table}, ids, dt)

    def _aot_add(self, peft, i, lp, h, ids, task_ids=None):
        """h (b, s, d) plus layer i's AoT rows (the paper's Eq. 1) for the
        flat token ``ids`` (b s,) int32, and the attention's input x:
        (h, x), both (b, s, d). Pre-norm with RMSNorm, x is the block's
        input norm (``lp["ln1"]``) of the sum, fused into the launch; with
        LayerNorm or the non-parametric norm the plain gather-add runs and
        x is ``layers.apply_norm`` of the sum (plain PyTorch, as the
        reference's norms are XLA's); post-LN has no input norm, so the
        plain gather-add runs and x is the sum. The rows come from one
        task's table (V, d) through the single-table kernel, or from
        stacked tasks' tables (tasks, V, d) by ``task_ids`` (b s,) through
        the multi-task one."""
        cfg = self.cfg
        table = peft["params"]["aot"]["table"][i]
        fused = cfg.norm_type == "rmsnorm" and not cfg.post_ln
        norm = (lp["ln1"]["scale"], cfg.norm_eps) if fused else None
        flat = h.reshape(-1, h.shape[-1])
        if table.dim() == 3:
            res = ops.aot_gather_add_multitask(flat, table, task_ids, ids,
                                               norm=norm)
        else:
            res = ops.aot_gather_add(flat, table, ids, norm=norm)
        if fused:
            h_out, x = res
        else:
            h_out = x = res
            if not cfg.post_ln:
                x = L.apply_norm(cfg, lp["ln1"], h_out)
        return h_out.view(h.shape), x.view(h.shape)

    def _adapter(self, a, i, out):
        """A Houlsby adapter of layer i: ``out + gelu(out @ down + b1) @ up
        + b2`` (tanh-approximate gelu, ``jax.nn.gelu``'s default)."""
        dt = self.opts.compute_dtype
        z = F.gelu(out @ a["down"][i].to(dt) + a["b1"][i].to(dt),
                   approximate="tanh")
        return out + z @ a["up"][i].to(dt) + a["b2"][i].to(dt)

    @contextlib.contextmanager
    def record_routes(self):
        """Collect the routing of every MoE layer this model runs while
        open: a list that gains one record per layer per call
        (``moe.apply_moe``'s ``record``), in call and layer order."""
        prev, routes = self._routes, []
        self._routes = routes
        try:
            yield routes
        finally:
            self._routes = prev

    def _ffn(self, lp, x, aux):
        """The block's FFN on x (b, s, d): the MLP, or on a MoE layer
        ``moe.apply_moe`` over x's tokens flattened row-major (the call's
        order, in which they claim capacity), its aux values added into
        ``aux`` (a dict, or None to drop them) and its routing into an
        open :meth:`record_routes` list."""
        dt = self.opts.compute_dtype
        if "moe" not in lp:
            return L.apply_mlp(self.cfg, lp["mlp"], x, dt)
        out, layer_aux = moe_mod.apply_moe(self.cfg, lp["moe"], x, dt,
                                           record=self._routes)
        if aux is not None:
            for k, v in layer_aux.items():
                aux[k] = aux[k] + v if k in aux else v
        return out

    def _block(self, lp, h, sincos, attend, peft=None, i=0, aot=None,
               aux=None):
        """Layer i on h (b, s, d). Pre-norm: norm, Q/K/V projection with
        RoPE (``sincos``; None for learned positions), ``attend(q, k, v)``
        -> (b, s, H, hd) (which also writes the cache), output projection,
        the residual add, norm, the FFN (:meth:`_ffn`: the MLP or the MoE,
        whose aux values go into ``aux``), the residual add. Post-LN (the
        encoders, the reference's order): attention reads h itself, then
        ``h = ln1(h + att)``, the MLP on that h, ``h = ln2(h + ffn)``. With
        the PEFT hooks of ``peft``'s method: AoT's rows added to h first,
        for the flat tokens ``aot`` = (ids, task_ids[, e_rows,
        generators]), in the same launch as the input norm
        (:meth:`_aot_add`; post-LN or a norm other than RMSNorm: the plain
        gather-add), LoRA's deltas on q and v from the attention's input,
        BitFit's biases after the output projection and after the MLP, an
        adapter after each. (P-Tuning v2's prefix comes inside
        ``attend``.) Pre-norm without AoT, an RMSNorm input norm is one
        launch of its own (``ops.rms_norm``). Under ``attn_impl="ref"`` or
        ``"chunked"`` the rows (:meth:`_aot_rows`) and the norm are plain
        PyTorch; LayerNorm and the non-parametric norm are plain PyTorch on
        every path (the reference's norms are XLA's)."""
        cfg, dt = self.cfg, self.opts.compute_dtype
        method = peft["method"] if peft else "none"
        pp = peft["params"] if peft else {}
        post = cfg.post_ln
        h, x = self._block_input(lp, h, peft, i, aot)
        qkv = None
        if method == "lora":
            lo, sc = pp["lora"], lora_scale(peft["opt"])
            xd = x.to(dt)
            qkv = ((xd @ lo["qa"][i].to(dt)) @ lo["qb"][i].to(dt) * sc, None,
                   (xd @ lo["va"][i].to(dt)) @ lo["vb"][i].to(dt) * sc)
        q, k, v = L.attn_project_qkv(cfg, lp["attn"], x, None, dt,
                                     sincos=sincos, peft_qkv=qkv)
        bias = pp["bitfit"]["attn_out"][i] if method == "bitfit" else None
        o = attend(q, k, v)
        # the reference's "attn_mix": the block's attention output
        with (L.checkpoint_name("attn_mix") if self._in_remat and not post
              else contextlib.nullcontext()):
            out = L.attn_output(cfg, lp["attn"], o, dt, bias)
            if method == "adapters":
                out = self._adapter(pp["adapters"]["attn"], i, out)
        if post:
            h = x = L.apply_norm(cfg, lp["ln1"], h + out)
        else:
            h = h + out
            x = L.apply_norm(cfg, lp["ln2"], h)
        out = self._ffn_hooks(lp, x, peft, i, aux)
        return L.apply_norm(cfg, lp["ln2"], h + out) if post else h + out

    def _block_input(self, lp, h, peft, i, aot):
        """Layer i's input: (h, x) with h plus AoT's rows when ``peft`` is
        AoT (the paper's Eq. 1, for the flat tokens ``aot``) and x the
        block's input norm of it (post-LN: h itself). On the kernels the
        rows and an RMSNorm are one fused launch (:meth:`_aot_add`), an
        RMSNorm alone is ``ops.rms_norm``; under "ref" or "chunked" both
        are plain PyTorch, and LayerNorm and the non-parametric norm are
        plain PyTorch on both paths."""
        cfg, dt = self.cfg, self.opts.compute_dtype
        method = peft["method"] if peft else "none"
        ref = self.opts.attn_impl != "kernel"
        post = cfg.post_ln
        if method == "aot" and ref:              # the paper's Eq. 1
            h = h + self._aot_rows(peft, i, *aot).reshape(h.shape).to(dt)
            x = h if post else L.apply_norm(cfg, lp["ln1"], h)
        elif method == "aot":
            h, x = self._aot_add(peft, i, lp, h, *aot[:2])
        elif post:
            x = h
        elif ref or cfg.norm_type != "rmsnorm":
            x = L.apply_norm(cfg, lp["ln1"], h)
        else:
            x = ops.rms_norm(h, lp["ln1"]["scale"], cfg.norm_eps)
        return h, x

    def _ffn_hooks(self, lp, x, peft, i, aux):
        """:meth:`_ffn` on x with layer i's PEFT hooks after it: BitFit's
        ``mlp_out`` bias, then the MLP adapter."""
        dt = self.opts.compute_dtype
        method = peft["method"] if peft else "none"
        out = self._ffn(lp, x, aux)
        if method == "bitfit":
            out = out + peft["params"]["bitfit"]["mlp_out"][i].to(dt)
        if method == "adapters":
            out = self._adapter(peft["params"]["adapters"]["mlp"], i, out)
        return out

    def _recurrent_block(self, kind, lp, h, peft, i, aot, state):
        """Recurrent layer i (``kind``) on h (b, s, d), the reference's
        ``_block_apply``: AoT's rows and the input norm first
        (:meth:`_block_input`), the temporal mix (RG-LRU, mLSTM or sLSTM)
        from ``state`` (the layer's cache entry, or None for a fresh one),
        the residual add, and on an RG-LRU block with an MLP the second
        norm, the FFN with BitFit's ``mlp_out`` and the MLP adapter, the
        residual add. LoRA, BitFit's ``attn_out`` and the attention adapter
        act on attention layers only. Returns (h, the layer's new cache
        entry)."""
        cfg, dt = self.cfg, self.opts.compute_dtype
        h, x = self._block_input(lp, h, peft, i, aot)
        if kind == BLOCK_RGLRU:
            mix, new = rec_mod.apply_rglru(cfg, lp["rglru"], x, dt, state)
        elif kind == BLOCK_MLSTM:
            mix, new = xl_mod.apply_mlstm_block(cfg, lp["core"], x, dt, state,
                                                chunk=self.opts.mlstm_chunk)
        else:
            mix, new = xl_mod.apply_slstm_block(cfg, lp["core"], x, dt, state)
        h = h + mix
        if "mlp" in lp:                 # an RG-LRU block's FFN
            x = L.apply_norm(cfg, lp["ln2"], h)
            h = h + self._ffn_hooks(lp, x, peft, i, None)
        return h, new

    def _embed(self, params, ids, patches=None, frames=None):
        """(E[ids] as stored, which AoT's fc reads, and h (b, s, d): those
        rows in the compute dtype, the first ``patches.shape[1]`` of them
        replaced by ``patches @ frontend.proj`` (a vision front-end's
        patches (b, n, frontend_dim)), then times sqrt(d) where the config
        scales its embeddings, the factor rounded to the compute dtype
        first, as the reference's). Audio ``frames`` (b, s, frontend_dim):
        h is ``frames @ frontend.proj``, unscaled, and E[ids] None."""
        cfg, dt = self.cfg, self.opts.compute_dtype
        if frames is not None:
            return None, frames.to(dt) @ params["frontend"]["proj"].to(dt)
        e_rows = params["embed"]["tok"][ids.long()]
        h = e_rows.to(dt)
        if patches is not None:
            pe = patches.to(dt) @ params["frontend"]["proj"].to(dt)
            h = torch.cat([pe, h[:, pe.shape[1]:]], 1)
        if cfg.embed_scale:
            h = h * float(torch.tensor(math.sqrt(cfg.d_model), dtype=dt))
        return e_rows, h

    def _inputs(self, tokens, patches, frames, aot_ids):
        """Check the entry point's inputs against the config's front-end;
        returns the ids AoT indexes: the tokens, or with audio frames the
        optional unit ids ``aot_ids`` (the reference's unit-AoT)."""
        cfg = self.cfg
        if cfg.frontend == "audio_frames":
            if frames is None or tokens is not None:
                raise ValueError(f"{cfg.name} takes audio frames (b, s, "
                                 f"{cfg.frontend_dim}) and no tokens")
            return aot_ids
        if frames is not None or aot_ids is not None:
            raise ValueError(f"{cfg.name} takes token ids, not frames or "
                             "aot_ids")
        if patches is not None and not (
                cfg.frontend == "vision_patches"
                and patches.shape[1] <= tokens.shape[1]):
            raise ValueError(f"{cfg.name}: patches {tuple(patches.shape)} "
                             f"over {tuple(tokens.shape)} tokens")
        return tokens

    def _prompt(self, params, tokens, peft, cache=None, rng=None,
                max_len=0, real=None, aux=None, patches=None, frames=None,
                aot_ids=None):
        """Whole prompts through every layer; returns h (b, s, d) after the
        final norm and the prefix length p (P-Tuning v2's, else 0).
        ``tokens`` (b, s) int, or with an audio front-end ``frames`` (b, s,
        frontend_dim) and optional unit ids ``aot_ids`` (b, s) for a fused
        AoT table; a vision front-end's ``patches`` (b, n, frontend_dim)
        replace the first n token embeddings (:meth:`_embed`).

        Attention: the flash attention kernel (causal, with the config's
        sliding window, or full for an encoder); ``attn_impl="chunked"``:
        ``layers.attention_chunked``; ``"ref"``: ``layers.attention_ref``.
        Positions below ``prefix_len = prefix_lm_len + p1 + p`` (when the
        config has a prefix or P-Tuning v1 a prompt of p1 rows) are seen by
        every query, the reference's arithmetic; the kernel path then sends
        attention to ``attention_chunked`` through ``ops.flash_attention``.
        P-Tuning v2 puts its K/V prefix (no RoPE) before each layer's k
        and v, and its queries attend from position p. P-Tuning v1
        prepends its prompt to the embeddings (positions shifted by its
        length) and strips it after the final norm. Learned positions
        ``embed.pos[:p1 + s]`` are added to the embeddings after P-Tuning
        v1's prompt is prepended; more positions than the table holds raise
        ValueError. With ``cache`` (made for ``max_len`` positions), layer
        i's ``[prefix | k]`` and ``[prefix | v]`` are written into its rows
        ``[0, p + s)``; into a ring shorter than that, the last ring-length
        of the first ``p + real`` positions (``real``: the real tokens of
        right-padded prompts, default s), each at row ``position % rows``.
        ``rng``: the step's ``torch.Generator``, which seeds AoT's dropout
        (None: no dropout). ``aux``: a dict that gains the MoE layers' aux
        values, summed over layers."""
        cfg, dt = self.cfg, self.opts.compute_dtype
        method = self._method(peft, whole=cache is None)
        ids = self._inputs(tokens, patches, frames, aot_ids)
        b, s = (frames if frames is not None else tokens).shape[:2]
        p = peft["opt"].prompt_len if method == "ptv2" else 0
        spans = None
        if cache is not None:
            if p + s > max_len:
                raise ValueError(f"prompt length {s} (+ prefix {p}) exceeds "
                                 f"the cache's {max_len} positions")
            rows = self.cache_rows(cache)
            spans = (ring_spans(p + (s if real is None else real), rows)
                     if p + s > rows else [(0, p + s, 0)]) if rows else []
        if ids is not None:
            ids = ids.to(torch.int32)
        e_rows, h = self._embed(params, ids, patches, frames)    # (b, s, d)
        p1 = 0
        if method == "ptv1":
            prompt = peft["params"]["ptv1"]["prompt"].to(dt)
            p1 = prompt.shape[0]
            h = torch.cat([prompt.expand(b, -1, -1), h], 1)
        sincos = None
        if cfg.pos_type == "learned":
            pos = params["embed"]["pos"]
            if p1 + s > pos.shape[0]:
                raise ValueError(
                    f"{p1 + s} positions (P-Tuning v1's prompt {p1} + {s} "
                    f"tokens) exceed the {pos.shape[0]} learned positions")
            h = h + pos[:p1 + s].to(dt)[None]
        elif cfg.pos_type == "rope":
            sincos = L.rope_sincos(torch.arange(p1 + s, device=h.device),
                                   cfg.head_dim, cfg.rope_theta)
        h = constrain(h, "batch", "seq", "embed")
        aot = None
        if method == "aot":     # each row's task over its s tokens, flat
            if ids is None:
                raise ValueError(f"{cfg.name}: AoT over audio frames "
                                 "indexes unit ids: pass aot_ids")
            aot = (ids.reshape(-1).contiguous(),
                   peft["task_ids"].to(torch.int32).repeat_interleave(s)
                   if "task_ids" in peft else None,
                   # E[ids] (b, s, d), laid out as h (AoT's fc rows)
                   None if e_rows is None else constrain(
                       e_rows, "batch", "seq", "embed"),
                   self._layer_generators(rng))
        impl = self.opts.attn_impl
        kw = dict(causal=cfg.causal, window=self.window(), q_offset=p)
        if cfg.logit_softcap:           # the kernel path: attention_chunked
            kw["softcap"] = cfg.logit_softcap
        if cfg.prefix_lm_len or p1:     # the reference's arithmetic
            kw["prefix_len"] = cfg.prefix_lm_len + p1 + p
        def layer(i, h, aux):
            lp, kind = params["layers"][i], self.kinds[i]
            if kind != BLOCK_ATTN:      # a fresh cache's state, or none
                h, new = self._recurrent_block(
                    kind, lp, h, peft, i, aot,
                    None if cache is None else cache["layers"][i])
                if cache is not None:
                    cache["layers"][i] = new
                return constrain(h, "batch", "seq", "embed")

            def attend(q, k, v):
                if p:
                    pre = peft["params"]["ptv2"]
                    k = torch.cat([pre["pk"][i].to(k.dtype).expand(
                        b, -1, -1, -1), k], 1)
                    v = torch.cat([pre["pv"][i].to(v.dtype).expand(
                        b, -1, -1, -1), v], 1)
                if spans:
                    kc, vc = self.kv(cache, i)
                for lo, hi, at in spans or ():
                    if isinstance(kc, DTensor):     # on each rank's shards
                        write_rows(kc, 1, at, k[:, lo:hi])
                        write_rows(vc, 1, at, v[:, lo:hi])
                        continue
                    kc[:, at:at + hi - lo] = k[:, lo:hi]
                    vc[:, at:at + hi - lo] = v[:, lo:hi]
                if impl == "ref":       # on each rank's shards on a mesh
                    return shlib.attention_on_shards(L.attention_ref, q, k,
                                                     v, **kw)
                if impl == "chunked":
                    return shlib.attention_on_shards(
                        functools.partial(L.attention_chunked,
                                          chunk_q=self.opts.chunk_q,
                                          chunk_kv=self.opts.chunk_kv),
                        q, k, v, **kw)
                return ops.flash_attention(q, k, v, **kw)
            h = self._block(lp, h, sincos, attend, peft, i, aot, aux)
            return constrain(h, "batch", "seq", "embed")

        remat = (cache is None and self.opts.remat
                 and self._records(h, params, peft))
        for lo, hi in layer_units(cfg):
            auxs = [None if aux is None else {} for _ in range(lo, hi)]
            if remat:
                h, auxs = self._remat_unit(layer, lo, hi, h, auxs, aot)
            else:
                for i in range(lo, hi):
                    h = layer(i, h, auxs[i - lo])
            for layer_aux in auxs:          # summed in layer order
                for k, v in (layer_aux or {}).items():
                    aux[k] = aux[k] + v if k in aux else v
        return L.apply_norm(cfg, params["final_norm"], h)[:, p1:], p

    @staticmethod
    def _records(*trees) -> bool:
        """Whether autograd records: grad mode on and a tensor among
        ``trees`` requiring grad."""
        return torch.is_grad_enabled() and any(
            isinstance(x, torch.Tensor) and x.requires_grad
            for x in T.leaves(list(trees)))

    def _remat_unit(self, layer, lo, hi, h, auxs, aot):
        """Layers ``[lo, hi)`` (``layer(i, h, aux)``) on h under
        ``torch.utils.checkpoint`` (non-reentrant): only h enters the
        backward's saved tensors, and the unit's forward runs again in the
        backward, keeping what :func:`remat_policy` keeps. The recompute
        replays AoT's dropout generators from their states at the unit's
        start and records no MoE routes, so it is the forward's, bit for
        bit. Returns (h, the layers' aux dicts)."""
        gens = aot[3][lo:hi] if aot is not None and aot[3] else []
        states = [g.get_state() for g in gens]
        runs = []

        def body(h):
            again = bool(runs)
            runs.append(1)
            for g, st in zip(gens, states):
                g.set_state(st)
            routes, self._routes = self._routes, (
                None if again else self._routes)
            self._in_remat = True
            try:
                out = [None if a is None else {} for a in auxs]
                for i in range(lo, hi):
                    h = layer(i, h, out[i - lo])
                return h, out
            finally:
                self._routes, self._in_remat = routes, False

        policy = remat_policy(self.opts)
        kw = {} if policy is None else {"context_fn": functools.partial(
            create_selective_checkpoint_contexts, policy)}
        return checkpoint(body, h, use_reentrant=False,
                          preserve_rng_state=False, **kw)

    def forward(self, params, tokens, peft=None, rng=None, *, patches=None,
                frames=None, aot_ids=None):
        """Whole-sequence pass, no cache (the reference's
        ``forward``; ``benchmarks/speed_overhead.py`` times it per PEFT
        method). tokens: (b, s) int -> hidden states (b, s, d) after the
        final norm, plus BitFit's ``final`` bias, which only this entry
        point adds, as in the reference. ``rng``: the step's
        ``torch.Generator`` for AoT's dropout (None: none). A vision
        front-end takes ``patches`` (b, frontend_len, frontend_dim) beside
        the tokens; an audio one ``frames`` (b, s, frontend_dim) with
        ``tokens`` None, and optional unit ids ``aot_ids`` (b, s) for a
        fused AoT table (:meth:`_prompt`)."""
        return self.forward_aux(params, tokens, peft, rng, patches=patches,
                                frames=frames, aot_ids=aot_ids)[0]

    def forward_aux(self, params, tokens, peft=None, rng=None, *,
                    patches=None, frames=None, aot_ids=None):
        """:meth:`forward` and the MoE layers' aux values summed over
        layers (``moe_lb_loss``, ``moe_z_loss``, ``moe_dropped_frac``; an
        empty dict without MoE layers), the reference's ``(h, aux)``: what
        the training step adds to its loss."""
        aux = {}
        h, _ = self._prompt(params, tokens, peft, rng=rng, aux=aux,
                            patches=patches, frames=frames, aot_ids=aot_ids)
        if peft and peft["method"] == "bitfit":
            h = h + peft["params"]["bitfit"]["final"].to(h.dtype)
        return h, aux

    def logits(self, params, tokens, peft=None, rng=None, **inputs):
        """``unembed(forward(...))``: (b, s, V); ``inputs``: the front-end's
        keywords of :meth:`forward`."""
        return self.unembed(params, self.forward(params, tokens, peft, rng,
                                                 **inputs))

    def classify(self, params, tokens, peft, rng=None, **inputs):
        """The paper's GLUE protocol: the pooled representation (an
        encoder's mean over positions, a causal stack's last position)
        through the trainable head ``peft["params"]["head"]``: logits (b,
        num_classes); ``inputs`` as for :meth:`logits`."""
        h = self.forward(params, tokens, peft, rng, **inputs)
        pooled = h.mean(1) if self.cfg.is_encoder_only else h[:, -1]
        head, dt = peft["params"]["head"], self.opts.compute_dtype
        return pooled.to(dt) @ head["w"].to(dt) + head["b"].to(dt)

    def prefill(self, params, tokens, peft=None, *, max_len: int,
                last_pos=None, patches=None, frames=None, aot_ids=None):
        """Run whole prompts and build their contiguous cache.

        tokens: (b, s) int; peft: None or a bundle (``core.peft.make``):
        ``aot`` with one task's tables ``{"table": (L, V, d)}``, or with
        stacked tasks' ``(L, tasks, V, d)`` plus ``"task_ids"`` (b,) int32;
        ``bitfit``, ``lora``, ``adapters`` or ``ptv2``. max_len: the cache's
        length (>= s, plus P-Tuning v2's prefix). Every layer attends
        through the flash attention kernel (causal, with the config's
        window; a config's bidirectional prefix, paligemma's, through
        ``attention_chunked``; under ``attn_impl="chunked"`` / ``"ref"``
        the plain attention, norms and AoT rows of :meth:`forward`) and
        writes its K/V into rows ``[0, p + s)``
        of a fresh ``init_cache(b, max_len)`` (p: the P-Tuning v2 prefix,
        else 0). ``patches``, ``frames``, ``aot_ids``: the front-end's
        inputs (:meth:`forward`). ``last_pos`` (an int) picks the position
        whose logits are returned instead of the last one: the continuous
        scheduler right-pads prompts to a bucket, and causality keeps
        positions <= last_pos independent of the padding. A ring shorter
        than ``p + s`` takes the last ring-length of the real positions
        ``[0, p + last_pos]``, each at row ``position % rows`` (the
        reference keeps the padded tail there, which loses real rows:
        ROADMAP C7). Returns (logits (b, 1, V), cache, pos = s + p):
        BitFit's ``final`` bias is not added here, as in the reference."""
        self._serving("prefill")
        cache = self.init_cache(tokens.shape[0], max_len)
        h, p = self._prompt(params, tokens, peft, cache, max_len=max_len,
                            real=None if last_pos is None
                            else int(last_pos) + 1, patches=patches,
                            frames=frames, aot_ids=aot_ids)
        h_last = h[:, -1:] if last_pos is None else \
            h[:, int(last_pos):int(last_pos) + 1]
        return self.unembed(params, h_last), cache, tokens.shape[1] + p

    def decode_step(self, params, tokens, pos, cache, peft=None,
                    block_tables=None):
        """One decode step. tokens: (b, 1); pos: the cache row of the new
        token, an int (every row at one depth) or a per-row (b,) vector;
        cache: a contiguous cache (``init_cache``), or with ``block_tables``
        (b, npages) int32 the paged pool (``init_paged_cache``), in which
        case ``pos`` must be per-row. peft as in :meth:`prefill`, with
        ``"task_ids"`` (b,) for stacked tasks; P-Tuning v2 takes the
        contiguous cache only. A sliding-window config takes the
        contiguous cache only (the reference's words, ``SWA_PAGED_DECODE``).

        The new K/V is written into the cache IN PLACE (the reference
        returns a new cache): contiguous at row ``pos`` (``pos % rows`` in
        a ring), paged into the page ``block_tables`` maps for depth
        ``pos``. Attention then runs the decode kernel (contiguous) or the
        paged decode kernel (under ``attn_impl="chunked"`` / ``"ref"``, or
        with a softcap, the plain ``layers`` walks) over ``pos + 1``
        positions (``min(pos + 1, rows)`` in a ring: every resident row
        lies inside the window). On a mesh the cache's leaves are DTensors
        written on each rank's shards (``pos`` an int).
        RoPE takes ``pos`` as the position, as the reference does: after a
        P-Tuning v2 prefill (pos = s + p) the first decoded token sits p
        positions past the prompt's last. Returns (logits (b, 1, V),
        cache). Paged positions on the CPU are held to the block table
        first (:func:`check_table_reach`)."""
        cfg = self.cfg
        self._serving("decode_step")
        method = self._method(peft)
        if method == "ptv2" and block_tables is not None:
            raise NotImplementedError(_PTV2_PAGED)
        if block_tables is not None:
            refuse_recurrent(cfg, "paged decode")
            refuse_prefix_lm(cfg, "paged decode")
        if self.window() and block_tables is not None:
            raise NotImplementedError(SWA_PAGED_DECODE)
        dev = self.device
        # contiguous: tokens may be a column of a wider (b, steps) tensor
        ids = tokens[:, 0].to(torch.int32).contiguous()
        b = ids.shape[0]
        h = self._embed(params, ids)[1][:, None]                # (b, 1, d)
        rows = self.cache_rows(cache)
        ring = self.is_ring(rows)       # SWA has refused block_tables
        # Outside a ring the window masks nothing: every position is below
        # rows, which is at most the window, so the plain decode walk over
        # cur_len rows is the reference's windowed attention_decode.
        if getattr(pos, "ndim", 0) == 1:
            pos_t = torch.as_tensor(pos, device=dev).long()
            positions = pos_t[:, None]                          # (b, 1)
            cur = (pos_t + 1).clamp(max=rows) if ring else pos_t + 1
            cur = cur.to(torch.int32)
            where = (torch.arange(b, device=dev),               # each row's
                     pos_t % rows if ring else pos_t)
        else:
            if block_tables is not None:
                raise ValueError("a paged decode step needs per-row pos")
            # filled on the device: a host number uploaded here (or in each
            # layer's wrapper) would wait on the stream every step
            positions = torch.full((1,), int(pos), device=dev)  # every row's
            depth = min(int(pos) + 1, rows) if ring else int(pos) + 1
            cur = torch.full((b,), depth, dtype=torch.int32, device=dev)
            where = (slice(None), int(pos) % rows if ring else int(pos))
        sincos = (L.rope_sincos(positions, cfg.head_dim, cfg.rope_theta)
                  if cfg.pos_type == "rope" else None)
        if block_tables is not None:        # the page and offset of each row
            bs = cache["k"].shape[2]
            if pos_t.device.type == "cpu":
                check_table_reach(np.arange(b), pos_t, block_tables.shape[1],
                                  bs)
            where = (block_tables.long()[where[0], pos_t // bs], pos_t % bs)
        aot = ((ids, peft.get("task_ids"), None, None) if method == "aot"
               else None)
        softcap = cfg.logit_softcap
        plain = softcap or self.opts.attn_impl != "kernel"
        for i, lp in enumerate(params["layers"]):
            kind = self.kinds[i]
            if kind != BLOCK_ATTN:      # the state's step, stored back
                h, cache["layers"][i] = self._recurrent_block(
                    kind, lp, h, peft, i, aot, cache["layers"][i])
                continue
            kc, vc = self.kv(cache, i)

            def attend(q, k, v, kc=kc, vc=vc):
                if isinstance(kc, DTensor):     # one depth, on the shards
                    if not isinstance(where[1], int):
                        raise NotImplementedError(
                            "a cache on a mesh takes one int pos")
                    write_rows(kc, 1, where[1], k)
                    write_rows(vc, 1, where[1], v)
                else:
                    kc[where] = k[:, 0]
                    vc[where] = v[:, 0]
                if isinstance(kc, DTensor) and not any(
                        p.is_shard(1) for p in kc.placements):
                    # on each rank's rows and heads (a cache sharded along
                    # its sequence stays with DTensor's reductions)
                    return shlib.attention_on_shards(
                        lambda q, k, v, q_offset: L.attention_decode(
                            q, k, v, depth, softcap=softcap), q, kc, vc)
                if plain:       # the reference's XLA walks; no kernel
                    return (L.paged_attention_decode(
                        q, kc, vc, block_tables, cur, softcap=softcap)
                        if block_tables is not None else
                        L.attention_decode(q, kc, vc, cur, softcap=softcap))
                if block_tables is not None:
                    o = ops.paged_decode_attention(q[:, 0], kc, vc,
                                                   block_tables, cur)
                else:
                    o = ops.decode_attention(q[:, 0], kc, vc, cur)
                return o[:, None]
            h = self._block(lp, h, sincos, attend, peft, i, aot)
        h = L.apply_norm(cfg, params["final_norm"], h)
        return self.unembed(params, h), cache

    # ------------------------------------------------------------------
    def mixed_step(self, params, tokens, token_rows, token_pos, cache,
                   peft=None, block_tables=None, logit_idx=None, plan=None):
        """One unified ragged prefill + decode step against the paged pool:
        the serving tick's model call.

        tokens: (T, 1) int — the tick's packed token list (each decode row
        one fed-back token, every in-flight prefill its next chunk);
        token_rows: (T,) int32 each token's pool slot; token_pos: (T,) int32
        its absolute position, -1 marking a dead padding token (its output
        is zeros and its KV lands on scratch page 0); cache: the paged pool
        (``init_paged_cache``); peft: None or a bundle as in
        :meth:`prefill` (stacked tasks' AoT tables with ``"task_ids"`` (T,)
        int32, one per token), except P-Tuning v2, whose prefix the paged
        pool does not hold; block_tables: (num_slots, npages) int32;
        logit_idx: (num_slots,) per-slot index into the packed axis whose
        logits to report; plan: the ragged attention kernel's plan of
        token_rows / token_pos (``kernels.decode_attention.ragged_plan``) on
        the card, which ``ServeEngine.serve_step`` uploads with the tick's
        other arrays; None builds it here once, from host copies.

        The KV pool is updated IN PLACE (the reference returns a new cache
        from ``.at[].set``): every token's K/V is written into its slot's
        mapped page before attention, so chunk tokens see their
        lower-positioned chunk-mates and never another slot's chunk. Dead
        tokens all write page 0, offset 0; CUDA leaves the order of those
        duplicate writes undefined, which is harmless only because page 0
        is never read unmasked. Returns (logits (num_slots, V), cache).

        Write-fresh rule, which makes a failed tick safe to retry without a
        snapshot (the reference retries against its untouched old cache):
        a tick writes K/V only at (slot, pos) at or past what the slot has
        committed (a decode row at ``pos == cur_len``, a prefill chunk at
        ``pos >= done``; the scheduler holds every tick to it with
        ``check_write_fresh`` before the dispatch), dead tokens on scratch page 0, and within each layer the
        scatter runs before attention reads. So a tick that raised part
        way, or whose logits were poisoned, changed only rows that no
        reader has trusted yet, and its retry rewrites each of them before
        reading it: the pool is as good as untouched for every reader.
        Page sharing (fork, the prefix cache, compaction) keeps the rule
        by its write-exclusive half: a tick writes no page that has
        another holder. A shared page is copied before the tick that
        appends into it (copy-on-write in
        ``PagedKVPool.ensure_append_page``, before the dispatch and never
        inside the retry loop), a prefix-cache hit starts its chunk at
        the first uncached page, and cached prompt pages are never
        written; the scheduler checks it with ``check_write_exclusive``
        beside ``check_write_fresh``.
        Indices on the CPU are held to the block table first
        (:func:`check_table_reach`); on the card that check would wait on
        the stream, so ``ServeEngine.serve_step`` makes it on its host
        copies."""
        cfg = self.cfg
        refuse_recurrent(cfg, "the unified mixed step")
        refuse_prefix_lm(cfg, "the unified mixed step")
        assert block_tables is not None, "mixed_step serves paged pools only"
        self._serving("mixed_step", kernels=True)
        method = self._method(peft)
        if method == "ptv2":
            raise NotImplementedError(_PTV2_PAGED)
        if self.window():
            raise NotImplementedError(SWA_PAGED_TICK)
        ids = tokens[:, 0].to(torch.int32)
        h = self._embed(params, ids)[1][:, None]                # (T, 1, d)
        pos = token_pos.clamp(min=0).long()
        sincos = L.rope_sincos(pos[:, None], cfg.head_dim, cfg.rope_theta)
        bs_page = cache["k"].shape[2]
        if token_pos.device.type == "cpu":
            check_table_reach(token_rows, token_pos, block_tables.shape[1],
                              bs_page)
        page = torch.where(token_pos >= 0,
                           block_tables.long()[token_rows.long(),
                                               pos // bs_page], 0)
        row = page * bs_page + pos % bs_page      # pool row of each token
        kvh, hd = cfg.num_kv_heads, cfg.head_dim
        if plan is None:
            plan = ops.ragged_plan(token_rows, token_pos)
        aot = (ids, peft.get("task_ids")) if method == "aot" else None
        softcap = cfg.logit_softcap
        for i, lp in enumerate(params["layers"]):
            kc, vc = cache["k"][i], cache["v"][i]

            def attend(q, k, v, kc=kc, vc=vc):
                kc.view(-1, kvh, hd).index_copy_(0, row, k[:, 0].to(kc.dtype))
                vc.view(-1, kvh, hd).index_copy_(0, row, v[:, 0].to(vc.dtype))
                if softcap:     # the reference's XLA walk; no kernel
                    return L.ragged_paged_attention_decode(
                        q, kc, vc, block_tables, token_rows, token_pos,
                        softcap=softcap)
                return ops.ragged_paged_attention(
                    q[:, 0], kc, vc, block_tables, token_rows, token_pos,
                    plan)[:, None]
            h = self._block(lp, h, sincos, attend, peft, i, aot)
        h = L.apply_norm(cfg, params["final_norm"], h)
        if logit_idx is None:
            logit_idx = torch.arange(h.shape[0], device=h.device)
        h_sel = h[:, 0][logit_idx.long()]                         # (slots, d)
        return self.unembed(params, h_sel), cache


def _specs(tree):
    """A cache tree with each tensor replaced by its (shape, dtype)."""
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape), tree.dtype
    if isinstance(tree, dict):
        return {k: _specs(v) for k, v in tree.items()}
    return type(tree)(_specs(v) for v in tree)
