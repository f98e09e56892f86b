"""Multi-task serving engine: one frozen backbone serves many fused AoT
tasks in the same batch.

Counterpart of ``repro.serve.engine.ServeEngine``. Each request carries a
task id; the stacked fused tables ``(L, tasks, V, d)`` are indexed per
(task, token) in every layer at the cost of one gather-add. The engine
also serves one ready PEFT bundle (``core.peft.make``) with no task ids:
the baselines of the paper's Fig. 3 overhead comparison (one task's fused
AoT tables, BitFit, LoRA, adapters, P-Tuning v2) and the bare backbone.
Three ways to serve:

- :meth:`generate`, the static batch (the paper's benchmark setting): every
  prompt arrives together with one length, whole-prompt prefill, then
  greedy decode steps over a contiguous cache;
- the paged scheduler tick, one :meth:`serve_step` call: the ragged packed
  token list through ``Model.mixed_step`` plus the per-slot token draw;
- the slotted scheduler tick: :meth:`prefill_request` per admitted prompt,
  then one :meth:`decode_mixed` call over every slot of the contiguous pool.

:meth:`inject_fault` arms a one-shot fault for the next :meth:`serve_step`
(the fault-injection harness, ``serve.faults``): a raised
:class:`DispatchFault`, or a NaN logits row.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import peft as peft_mod
from repro_torch.core.aot import AoTOptions
from repro_torch.kernels.decode_attention import ragged_plan, round_kv_len
from repro_torch.models.model import check_table_reach
from repro_torch.serve.sampling import sample_tokens


@dataclass(frozen=True)
class ServeConfig:
    max_len: int = 2048


class DispatchFault(RuntimeError):
    """A serve_step dispatch that failed before reaching the model (an
    injected allocation failure); the scheduler's tick loop retries it."""


def _tensors(tree):
    """Every tensor in a nested dict."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)


def _pack_int32(arrays):
    """Host arrays -> one contiguous int32 buffer (float32 and uint32 by
    their bits) and the (offset, shape) of each, for a single upload."""
    flat, spans, at = [], [], 0
    for a in arrays:
        a = np.ascontiguousarray(a)
        if a.dtype != np.int32:
            a = a.astype(np.int32) if a.dtype.kind == "i" else a.view(np.int32)
        flat.append(a.ravel())
        spans.append((at, a.shape))
        at += a.size
    return np.concatenate(flat), spans


class ServeEngine:
    def __init__(self, model, params, cfg: ServeConfig = ServeConfig(),
                 fused_tasks=None, peft=None):
        """``fused_tasks``: the stacked fused task tables
        ``{'table': (L, tasks, V, d)}`` (``aot.stack_tasks``), served by
        task id; or ``peft``: one ready bundle (``core.peft.make``), used as
        given with no task ids (``num_tasks`` stays None, as in the
        reference). At most one of the two; neither serves the bare
        backbone. Their tensors must lie on the model's device."""
        if fused_tasks is not None and peft is not None:
            raise ValueError("give fused_tasks or peft, not both")
        self.model = model
        self.params = params
        self.cfg = cfg
        self.device = model.device
        self.tables = None
        self.num_tasks: Optional[int] = None
        self.peft = peft
        if fused_tasks is not None:
            self.tables = fused_tasks["table"]
            opt = peft_mod.PEFTOptions(method="aot",
                                       aot=AoTOptions(mode="fused"))
            self.peft = peft_mod.make({"aot": {"table": self.tables}}, opt)
            # task-id validity bound: the scheduler rejects task ids the
            # gather would clamp
            self.num_tasks = self.tables.shape[1]
        if self.peft is not None:
            model._method(self.peft)            # raises if not served
            for x in _tensors(self.peft["params"]):
                if x.device != self.device:
                    raise ValueError(f"PEFT parameters are on {x.device}, "
                                     f"the model on {self.device}")
        # KV allocations round up as the reference's do (rows past max_len
        # stay masked by cur_len)
        self.cache_len = round_kv_len(cfg.max_len)
        # serve_step, prefill_request, sample_first and decode_mixed calls:
        # the scheduler asserts one per paged tick
        self.dispatches = 0
        self._pending_fault: Optional[Tuple[str, int]] = None

    def inject_fault(self, kind: str, slot: int = -1) -> None:
        """Arm a one-shot fault that the next :meth:`serve_step` consumes
        (fault injection only). ``"alloc_failure"`` raises
        :class:`DispatchFault` before anything is uploaded; ``"nan"``
        writes NaN into slot ``slot``'s logits row on the device after the
        model's call and before the finiteness check, where a real
        numerical fault would surface."""
        if kind not in ("nan", "alloc_failure"):
            raise ValueError(f"unknown injected fault kind: {kind!r}")
        self._pending_fault = (kind, slot)

    def _peft(self, task_ids: torch.Tensor):
        """The model's peft argument for rows of ``task_ids``: the bundle
        with them for stacked tasks, the bundle as given otherwise (None for
        the bare backbone)."""
        if self.tables is None:
            return self.peft
        return dict(self.peft, task_ids=task_ids)

    def _upload(self, arrays):
        """Host arrays -> int32 device views, in one copy."""
        buf, spans = _pack_int32(arrays)
        dev_buf = torch.from_numpy(buf).to(self.device, non_blocking=True)
        return [dev_buf[at:at + int(np.prod(shape))].view(shape)
                for at, shape in spans]

    # ------------------------------------------------------------------
    # static-batch serving (the paper's benchmark setting)
    # ------------------------------------------------------------------
    def generate(self, prompts: np.ndarray, steps: int,
                 task_ids: Optional[np.ndarray] = None) -> np.ndarray:
        """prompts: (b, s) int32; task_ids: (b,) int32. Greedy decode:
        ``steps`` decode steps after the prefill, returning their (b, steps)
        tokens (the first from the prefill's logits)."""
        b = prompts.shape[0]
        if task_ids is None:
            task_ids = np.zeros(b, np.int32)
        toks, tids = self._upload([prompts, task_ids])
        peft = self._peft(tids)
        logits, cache, pos = self.model.prefill(self.params, toks, peft,
                                                max_len=self.cache_len)
        out = []
        tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
        for i in range(steps):
            out.append(tok)
            logits, cache = self.model.decode_step(self.params, tok, pos + i,
                                                   cache, peft)
            tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
        return torch.cat(out, dim=1).cpu().numpy()

    # ------------------------------------------------------------------
    # continuous-batching primitives (driven by serve.scheduler)
    # ------------------------------------------------------------------
    def prefill_request(self, tokens: np.ndarray, length: int, task_id: int,
                        sample=None):
        """Prefill one bucket-padded prompt. tokens: (1, bucket) int32;
        ``length``: real prompt tokens. Returns (first tokens, cache): one
        greedy token when ``sample`` is None, else one draw from the spec's
        (1,)-shaped vectors (temps, top_ks, top_ps, base_keys, steps).
        Padding is inert under causal attention: the logits at ``length -
        1`` and KV rows ``[0, length)`` are those of an unpadded prefill."""
        toks, tids = self._upload([tokens, np.full(1, task_id, np.int32)])
        logits, cache, _ = self.model.prefill(
            self.params, toks, self._peft(tids), max_len=self.cache_len,
            last_pos=length - 1)
        self.dispatches += 1
        return self._first_tokens(logits, sample), cache

    def _first_tokens(self, logits, sample) -> list:
        if sample is None:
            return [int(logits[0, -1].argmax())]
        return self.sample_first(logits[0, -1], sample)

    def sample_first(self, logits_row, sample) -> list:
        """Draw the spec's first tokens from ONE logits row, one per entry
        of the spec's vectors, each under its own stream."""
        temps, top_ks, top_ps, base_keys, steps = self._upload(
            [np.asarray(sample[0], np.float32), sample[1],
             np.asarray(sample[2], np.float32),
             np.asarray(sample[3], np.uint32), sample[4]])
        rows = logits_row[None, :].expand(temps.shape[0], -1)
        toks = sample_tokens(rows, temps.view(torch.float32), top_ks,
                             top_ps.view(torch.float32),
                             base_keys.long() & 0xFFFFFFFF, steps)
        self.dispatches += 1
        return [int(t) for t in toks.cpu()]

    def decode_mixed(self, tokens: np.ndarray, pos: np.ndarray, cache,
                     task_ids: np.ndarray, sample=None):
        """One decode step over every slot of a contiguous pool.

        tokens: (num_slots, 1) last token per slot; pos: (num_slots,) per-slot
        depths (== cur_len; the new KV row is written there, in place);
        task_ids: (num_slots,). Free slots ride along at pos 0 and are
        ignored by the caller. ``sample``: optional per-slot (temps, top_ks,
        top_ps, base_keys, steps); None takes the exact argmax.
        Returns (next token per slot (num_slots,) np, cache)."""
        self.dispatches += 1
        arrays = [tokens, pos, task_ids]
        if sample is not None:
            arrays += [np.asarray(sample[0], np.float32), sample[1],
                       np.asarray(sample[2], np.float32),
                       np.asarray(sample[3], np.uint32), sample[4]]
        t = self._upload(arrays)
        tok, pos_t, tids = t[:3]
        logits, cache = self.model.decode_step(self.params, tok, pos_t, cache,
                                               self._peft(tids))
        if sample is None:
            toks = logits[:, -1].argmax(dim=-1)
        else:
            tp, tk, pp, keys, steps = t[3:]
            toks = sample_tokens(logits[:, -1], tp.view(torch.float32), tk,
                                 pp.view(torch.float32),
                                 keys.long() & 0xFFFFFFFF, steps)
        return toks.cpu().numpy(), cache

    def serve_step(self, tokens: np.ndarray, token_rows: np.ndarray,
                   token_pos: np.ndarray, logit_idx: np.ndarray, cache,
                   block_tables: np.ndarray, token_tasks: np.ndarray, sample):
        """The unified ragged prefill + decode tick.

        tokens: (T, 1) the packed token list; token_rows / token_pos /
        token_tasks: (T,) each token's slot, absolute position (-1 = dead
        padding) and task; logit_idx: (num_slots,) per-slot index into the
        packed axis whose logits the slot reports; block_tables:
        (num_slots, npages); ``sample``: the per-slot (temps, top_ks, top_ps,
        base_keys, steps) vectors — a batch without a positive temperature
        takes the exact argmax. The host arrays, with the ragged attention
        kernel's plan of the packed list (``ragged_plan``), travel to the
        card in one copy, and the tokens and finite flags come back in one.
        Returns (next token per slot (num_slots,) np, per-slot logits
        (num_slots, V) on the device, the pool cache (updated in place),
        per-slot finite flags (num_slots,) bool np: False means that slot's
        logits row holds NaN/inf). Raises ValueError, before any upload, for
        a live token whose position lies past its slot's block table. An
        armed :meth:`inject_fault` is consumed here."""
        fault, self._pending_fault = self._pending_fault, None
        if fault is not None and fault[0] == "alloc_failure":
            raise DispatchFault(
                "injected allocation failure before dispatch (fault plan)")
        check_table_reach(token_rows, token_pos, block_tables.shape[1],
                          cache["k"].shape[2])
        temps = np.asarray(sample[0], np.float32)
        stochastic = bool(np.any(temps > 0.0))
        arrays = [tokens, token_rows, token_pos, logit_idx, token_tasks,
                  block_tables, ragged_plan(token_rows, token_pos)]
        if stochastic:
            arrays += [temps, sample[1], sample[2],
                       np.asarray(sample[3], np.uint32), sample[4]]
        t = self._upload(arrays)
        tok, rows, pos, lidx, tasks, bt, plan = t[:7]
        logits, cache = self.model.mixed_step(
            self.params, tok, rows, pos, cache, self._peft(tasks),
            block_tables=bt, logit_idx=lidx, plan=plan)
        if stochastic:
            tp, tk, pp, keys, steps = t[7:]
            toks = sample_tokens(logits, tp.view(torch.float32), tk,
                                 pp.view(torch.float32),
                                 keys.long() & 0xFFFFFFFF, steps)
        else:
            toks = logits.argmax(dim=-1)
        if fault is not None:       # "nan": after the model, before the check
            logits[fault[1]] = float("nan")
        finite = torch.isfinite(logits).all(dim=-1)
        out = torch.stack([toks.int(), finite.int()]).cpu().numpy()
        self.dispatches += 1
        return out[0], logits, cache, out[1].astype(bool)
