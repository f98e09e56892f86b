"""Model assembly for serving: init, the KV cache layouts, the whole-
sequence forward, whole-prompt prefill, the decode step and the unified
ragged mixed step, each with the PEFT methods of the paper's Fig. 3
(fused AoT tables, BitFit, LoRA, adapters, P-Tuning v2; ``core.peft``).

Counterpart of ``repro.models.model.Model`` for attention-only causal
stacks (the serving path). Parameters are a plain dict of tensors with
``params["layers"]`` a list of per-layer dicts in layer order (the bridge
unpacks the reference's grouped ``(R, U, ...)`` stacking; eager PyTorch
gains nothing from stacked leaves). A contiguous cache is ``{"k", "v"}`` of
shape ``(L, b, S, kvh, hd)``; the paged KV pool is ``{"k", "v"}`` of shape
``(L, num_blocks, block_size, kvh, hd)``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import BLOCK_ATTN, ArchConfig
from repro_torch.core.peft import lora_scale
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers as L

# the PEFT methods the model serves (core.peft)
SERVED = ("none", "aot", "bitfit", "lora", "adapters", "ptv2")
_PTV2_PAGED = ("P-Tuning v2's prefix is not held in the paged pool; serve "
               "ptv2 with static batches over a contiguous cache (the "
               "reference's paged and ragged steps skip the prefix)")


@dataclass(frozen=True)
class ModelOptions:
    compute_dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32


def check_supported(cfg: ArchConfig) -> None:
    """Raise unless ``cfg`` is a backbone the port can serve."""
    bad = []
    if set(cfg.layer_kinds) != {BLOCK_ATTN}:
        bad.append(f"block kinds {sorted(set(cfg.layer_kinds))}")
    if not cfg.causal or cfg.prefix_lm_len:
        bad.append("non-causal attention")
    if cfg.attn_kind != "full":
        bad.append(f"attention {cfg.attn_kind!r}")
    if cfg.moe is not None or cfg.frontend:
        bad.append("moe / frontend")
    if cfg.norm_type != "rmsnorm" or cfg.mlp_type != "swiglu":
        bad.append(f"{cfg.norm_type} / {cfg.mlp_type}")
    if cfg.pos_type != "rope" or cfg.embed_scale or cfg.post_ln:
        bad.append("positions / embedding scale / post-LN")
    if cfg.qkv_bias or cfg.qk_norm or cfg.logit_softcap:
        bad.append("qkv bias / qk norm / softcap")
    if not cfg.tie_embeddings or cfg.d_ff <= 0:
        bad.append("untied embeddings / no MLP")
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: not ported yet: {'; '.join(bad)}")


class Model:
    def __init__(self, cfg: ArchConfig, opts: ModelOptions = ModelOptions(),
                 device="cuda"):
        check_supported(cfg)
        self.cfg = cfg
        self.opts = opts
        self.device = resolve_device(device)

    # ------------------------------------------------------------------
    def init(self, seed: int = 0) -> Dict[str, Any]:
        """Random parameters from a ``torch.Generator`` on the device, with
        the reference's distributions: embeddings truncated-normal std 0.02,
        dense weights truncated-normal std 1/sqrt(fan_in), norm scales 1.
        Norm scales stay float32; matrices are stored in ``param_dtype``."""
        cfg, dev, pdt = self.cfg, self.device, self.opts.param_dtype
        gen = torch.Generator(device=dev).manual_seed(seed)
        n, d, f = cfg.num_layers, cfg.d_model, cfg.d_ff
        h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

        dense = lambda *shape: L.dense_init(shape, gen, dev, pdt)
        ones = lambda n: {"scale": torch.ones(n, dtype=torch.float32,
                                              device=dev)}

        def layer():
            return {"ln1": ones(d),
                    "attn": {"wq": dense(d, h * hd), "wk": dense(d, kvh * hd),
                             "wv": dense(d, kvh * hd), "wo": dense(h * hd, d)},
                    "ln2": ones(d),
                    "mlp": {"wg": dense(d, f), "wu": dense(d, f),
                            "wd": dense(f, d)}}

        return {
            "embed": {"tok": L.embed_init((cfg.vocab_size, d), gen, dev, pdt)},
            "layers": [layer() for _ in range(n)],
            "final_norm": ones(d),
        }

    @staticmethod
    def param_count(params) -> int:
        def count(tree):
            if isinstance(tree, torch.Tensor):
                return tree.numel()
            items = tree.values() if isinstance(tree, dict) else tree
            return sum(count(v) for v in items)
        return count(params)

    # ------------------------------------------------------------------
    def _cache_len(self, max_len: int) -> int:
        """Rows of a contiguous cache for ``max_len`` tokens (full attention
        only: ``check_supported`` refuses the reference's SWA ring)."""
        return max_len

    def cache_specs(self, batch: int, max_len: int):
        """Shape and dtype of each contiguous cache leaf: per layer a
        (batch, S, kvh, hd) K and V, stacked (L, batch, S, kvh, hd)."""
        cfg = self.cfg
        shape = (cfg.num_layers, batch, self._cache_len(max_len),
                 cfg.num_kv_heads, cfg.head_dim)
        return {"k": (shape, self.opts.compute_dtype),
                "v": (shape, self.opts.compute_dtype)}

    def init_cache(self, batch: int, max_len: int):
        return {name: torch.zeros(shape, dtype=dt, device=self.device)
                for name, (shape, dt) in
                self.cache_specs(batch, max_len).items()}

    def paged_cache_specs(self, num_blocks: int, block_size: int):
        """Shape and dtype of each paged pool leaf: a global
        (L, num_blocks, block_size, kvh, hd) K and V page pool shared by
        every request."""
        cfg = self.cfg
        shape = (cfg.num_layers, num_blocks, block_size, cfg.num_kv_heads,
                 cfg.head_dim)
        return {"k": (shape, self.opts.compute_dtype),
                "v": (shape, self.opts.compute_dtype)}

    def init_paged_cache(self, num_blocks: int, block_size: int):
        return {name: torch.zeros(shape, dtype=dt, device=self.device)
                for name, (shape, dt) in
                self.paged_cache_specs(num_blocks, block_size).items()}

    def unembed(self, params, h):
        """Tied unembedding: h @ E^T in the compute dtype."""
        dt = self.opts.compute_dtype
        return h.to(dt) @ params["embed"]["tok"].to(dt).T

    # ------------------------------------------------------------------
    # PEFT: the per-layer hooks of every entry point (the reference's
    # _aot_bias, _attention and _ffn)
    # ------------------------------------------------------------------
    @staticmethod
    def _method(peft) -> str:
        """The bundle's method ("none" for no bundle); raises for one the
        port does not serve."""
        method = peft["method"] if peft else "none"
        if method not in SERVED or (method == "aot" and
                                    peft["opt"].aot.mode != "fused"):
            raise NotImplementedError(f"peft {method!r} is not ported (the "
                                      f"port serves {', '.join(SERVED)}; "
                                      "AoT as fused tables)")
        return method

    @staticmethod
    def _aot_add(peft, i, h, ids, task_ids=None):
        """h (T, d) plus layer i's AoT rows (the paper's Eq. 1) for token
        ``ids`` (T,) int32: from one task's table (V, d) through the
        single-table kernel, or from stacked tasks' tables (tasks, V, d) by
        ``task_ids`` (T,) through the multi-task one."""
        table = peft["params"]["aot"]["table"][i]
        if table.dim() == 3:
            return ops.aot_gather_add_multitask(h, table, task_ids, ids)
        return ops.aot_gather_add(h, table, ids)

    def _adapter(self, a, i, out):
        """A Houlsby adapter of layer i: ``out + gelu(out @ down + b1) @ up
        + b2`` (tanh-approximate gelu, ``jax.nn.gelu``'s default)."""
        dt = self.opts.compute_dtype
        z = F.gelu(out @ a["down"][i].to(dt) + a["b1"][i].to(dt),
                   approximate="tanh")
        return out + z @ a["up"][i].to(dt) + a["b2"][i].to(dt)

    def _block(self, lp, h, sincos, attend, peft=None, i=0):
        """Layer i, one pre-norm block on h (b, s, d): norm, Q/K/V
        projection with RoPE (``sincos``), ``attend(q, k, v)`` -> (b, s, H,
        hd) (which also writes the cache), output projection, norm, SwiGLU;
        with the PEFT hooks of ``peft``'s method: LoRA's deltas on q and v,
        BitFit's biases after the output projection and after the MLP, an
        adapter after each. (AoT's bias comes before the block, P-Tuning
        v2's prefix inside ``attend``.)"""
        cfg, dt = self.cfg, self.opts.compute_dtype
        method = peft["method"] if peft else "none"
        pp = peft["params"] if peft else {}
        x = L.apply_norm(cfg, lp["ln1"], h)
        qkv = None
        if method == "lora":
            lo, sc = pp["lora"], lora_scale(peft["opt"])
            xd = x.to(dt)
            qkv = ((xd @ lo["qa"][i].to(dt)) @ lo["qb"][i].to(dt) * sc, None,
                   (xd @ lo["va"][i].to(dt)) @ lo["vb"][i].to(dt) * sc)
        q, k, v = L.attn_project_qkv(cfg, lp["attn"], x, None, dt,
                                     sincos=sincos, peft_qkv=qkv)
        bias = pp["bitfit"]["attn_out"][i] if method == "bitfit" else None
        out = L.attn_output(cfg, lp["attn"], attend(q, k, v), dt, bias)
        if method == "adapters":
            out = self._adapter(pp["adapters"]["attn"], i, out)
        h = h + out
        out = L.apply_mlp(cfg, lp["mlp"], L.apply_norm(cfg, lp["ln2"], h), dt)
        if method == "bitfit":
            out = out + pp["bitfit"]["mlp_out"][i].to(dt)
        if method == "adapters":
            out = self._adapter(pp["adapters"]["mlp"], i, out)
        return h + out

    def _prompt(self, params, tokens, peft, cache=None):
        """Whole prompts tokens (b, s) through every layer, attending
        through the flash attention kernel (causal); returns h (b, s, d)
        after the final norm and the prefix length p (P-Tuning v2's, else
        0). P-Tuning v2 puts its K/V prefix (no RoPE) before each layer's
        k and v, and its queries attend from position p. With ``cache``,
        layer i's ``[prefix | k]`` and ``[prefix | v]`` are written into
        its rows ``[0, p + s)``."""
        cfg, dt = self.cfg, self.opts.compute_dtype
        method = self._method(peft)
        b, s = tokens.shape
        p = peft["opt"].prompt_len if method == "ptv2" else 0
        if cache is not None and p + s > cache["k"].shape[2]:
            raise ValueError(f"prompt length {s} (+ prefix {p}) exceeds the "
                             f"cache's {cache['k'].shape[2]} rows")
        ids = tokens.to(torch.int32)
        h = params["embed"]["tok"][ids.long()].to(dt)             # (b, s, d)
        sincos = L.rope_sincos(torch.arange(s, device=h.device),
                               cfg.head_dim, cfg.rope_theta)
        if method == "aot":     # each row's task over its s tokens, flat
            flat_ids = ids.reshape(-1).contiguous()
            tids = (peft["task_ids"].to(torch.int32).repeat_interleave(s)
                    if "task_ids" in peft else None)
        for i, lp in enumerate(params["layers"]):
            if method == "aot":                      # the paper's Eq. 1
                h = self._aot_add(peft, i, h.reshape(b * s, -1), flat_ids,
                                  tids).view(b, s, -1)

            def attend(q, k, v, i=i):
                if p:
                    pre = peft["params"]["ptv2"]
                    k = torch.cat([pre["pk"][i].to(k.dtype).expand(
                        b, -1, -1, -1), k], 1)
                    v = torch.cat([pre["pv"][i].to(v.dtype).expand(
                        b, -1, -1, -1), v], 1)
                if cache is not None:
                    cache["k"][i, :, :p + s] = k
                    cache["v"][i, :, :p + s] = v
                return ops.flash_attention(q, k, v, causal=True, q_offset=p)
            h = self._block(lp, h, sincos, attend, peft, i)
        return L.apply_norm(cfg, params["final_norm"], h), p

    def forward(self, params, tokens, peft=None):
        """Whole-sequence causal pass, no cache (the reference's
        ``forward``; ``benchmarks/speed_overhead.py`` times it per PEFT
        method). tokens: (b, s) int -> hidden states (b, s, d) after the
        final norm, plus BitFit's ``final`` bias, which only this entry
        point adds, as in the reference."""
        h, _ = self._prompt(params, tokens, peft)
        if peft and peft["method"] == "bitfit":
            h = h + peft["params"]["bitfit"]["final"].to(h.dtype)
        return h

    def logits(self, params, tokens, peft=None):
        """``unembed(forward(...))``: (b, s, V)."""
        return self.unembed(params, self.forward(params, tokens, peft))

    def prefill(self, params, tokens, peft=None, *, max_len: int,
                last_pos=None):
        """Run whole prompts and build their contiguous cache.

        tokens: (b, s) int; peft: None or a bundle (``core.peft.make``):
        ``aot`` with one task's tables ``{"table": (L, V, d)}``, or with
        stacked tasks' ``(L, tasks, V, d)`` plus ``"task_ids"`` (b,) int32;
        ``bitfit``, ``lora``, ``adapters`` or ``ptv2``. max_len: the cache's
        length (>= s, plus P-Tuning v2's prefix). Every layer attends
        through the flash attention kernel (causal) and writes its K/V into
        rows ``[0, p + s)`` of a fresh ``init_cache(b, max_len)`` (p: the
        P-Tuning v2 prefix, else 0). ``last_pos`` (an int) picks the
        position whose logits are returned instead of the last one: the
        continuous scheduler right-pads prompts to a bucket, and causality
        keeps positions <= last_pos independent of the padding. Returns
        (logits (b, 1, V), cache, pos = s + p): BitFit's ``final`` bias is
        not added here, as in the reference."""
        cache = self.init_cache(tokens.shape[0], max_len)
        h, p = self._prompt(params, tokens, peft, cache)
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
        contiguous cache only.

        The new K/V is written into the cache IN PLACE (the reference
        returns a new cache): contiguous at row ``pos``, paged into the page
        ``block_tables`` maps for depth ``pos``. Attention then runs the
        decode kernel (contiguous) or the paged decode kernel over
        ``pos + 1`` positions. RoPE takes ``pos`` as the position, as the
        reference does: after a P-Tuning v2 prefill (pos = s + p) the first
        decoded token sits p positions past the prompt's last. Returns
        (logits (b, 1, V), cache)."""
        cfg, dt = self.cfg, self.opts.compute_dtype
        method = self._method(peft)
        if method == "ptv2" and block_tables is not None:
            raise NotImplementedError(_PTV2_PAGED)
        dev = self.device
        ids = tokens[:, 0].to(torch.int32)
        b = ids.shape[0]
        h = params["embed"]["tok"][ids.long()].to(dt)[:, None]   # (b, 1, d)
        if getattr(pos, "ndim", 0) == 1:
            pos_t = torch.as_tensor(pos, device=dev).long()
            positions = pos_t[:, None]                          # (b, 1)
            cur = (pos_t + 1).to(torch.int32)
            where = (torch.arange(b, device=dev), pos_t)     # each row's row
        else:
            if block_tables is not None:
                raise ValueError("a paged decode step needs per-row pos")
            # filled on the device: a host number uploaded here (or in each
            # layer's wrapper) would wait on the stream every step
            positions = torch.full((1,), int(pos), device=dev)  # every row's
            cur = torch.full((b,), int(pos) + 1, dtype=torch.int32,
                             device=dev)
            where = (slice(None), int(pos))
        sincos = L.rope_sincos(positions, cfg.head_dim, cfg.rope_theta)
        if block_tables is not None:        # the page and offset of each row
            bs = cache["k"].shape[2]
            where = (block_tables.long()[where[0], pos_t // bs], pos_t % bs)
        for i, lp in enumerate(params["layers"]):
            if method == "aot":                      # the paper's Eq. 1
                h = self._aot_add(peft, i, h[:, 0], ids,
                                  peft.get("task_ids"))[:, None]
            kc, vc = cache["k"][i], cache["v"][i]

            def attend(q, k, v, kc=kc, vc=vc):
                kc[where] = k[:, 0]
                vc[where] = v[:, 0]
                if block_tables is not None:
                    o = ops.paged_decode_attention(q[:, 0], kc, vc,
                                                   block_tables, cur)
                else:
                    o = ops.decode_attention(q[:, 0], kc, vc, cur)
                return o[:, None]
            h = self._block(lp, h, sincos, attend, peft, i)
        h = L.apply_norm(cfg, params["final_norm"], h)
        return self.unembed(params, h), cache

    # ------------------------------------------------------------------
    def mixed_step(self, params, tokens, token_rows, token_pos, cache,
                   peft=None, block_tables=None, logit_idx=None):
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
        logits to report.

        The KV pool is updated IN PLACE (the reference returns a new cache
        from ``.at[].set``): every token's K/V is written into its slot's
        mapped page before attention, so chunk tokens see their
        lower-positioned chunk-mates and never another slot's chunk. Dead
        tokens all write page 0, offset 0; CUDA leaves the order of those
        duplicate writes undefined, which is harmless only because page 0
        is never read unmasked. Returns (logits (num_slots, V), cache)."""
        cfg = self.cfg
        dt = self.opts.compute_dtype
        assert block_tables is not None, "mixed_step serves paged pools only"
        method = self._method(peft)
        if method == "ptv2":
            raise NotImplementedError(_PTV2_PAGED)
        ids = tokens[:, 0].to(torch.int32)
        h = params["embed"]["tok"][ids.long()].to(dt)[:, None]   # (T, 1, d)
        pos = token_pos.clamp(min=0).long()
        sincos = L.rope_sincos(pos[:, None], cfg.head_dim, cfg.rope_theta)
        bs_page = cache["k"].shape[2]
        page = torch.where(token_pos >= 0,
                           block_tables.long()[token_rows.long(),
                                               pos // bs_page], 0)
        row = page * bs_page + pos % bs_page      # pool row of each token
        kvh, hd = cfg.num_kv_heads, cfg.head_dim
        for i, lp in enumerate(params["layers"]):
            if method == "aot":                      # the paper's Eq. 1
                h = self._aot_add(peft, i, h[:, 0], ids,
                                  peft.get("task_ids"))[:, None]
            kc, vc = cache["k"][i], cache["v"][i]

            def attend(q, k, v, kc=kc, vc=vc):
                kc.view(-1, kvh, hd).index_copy_(0, row, k[:, 0].to(kc.dtype))
                vc.view(-1, kvh, hd).index_copy_(0, row, v[:, 0].to(vc.dtype))
                return ops.ragged_paged_attention(
                    q[:, 0], kc, vc, block_tables, token_rows,
                    token_pos)[:, None]
            h = self._block(lp, h, sincos, attend, peft, i)
        h = L.apply_norm(cfg, params["final_norm"], h)
        if logit_idx is None:
            logit_idx = torch.arange(h.shape[0], device=h.device)
        h_sel = h[:, 0][logit_idx.long()]                         # (slots, d)
        return self.unembed(params, h_sel), cache
