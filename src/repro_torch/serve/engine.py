"""Multi-task serving engine, paged half: one frozen backbone serves many
fused AoT tasks in the same batch.

Counterpart of the paged path of ``repro.serve.engine.ServeEngine``. Each
request carries a task id; the stacked fused tables ``(L, tasks, V, d)`` are
indexed per (task, token) in every layer at the cost of one gather-add. A
scheduler tick is one :meth:`serve_step` call: the ragged packed token list
through ``Model.mixed_step`` plus the per-slot token draw.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.serve.sampling import sample_tokens


@dataclass(frozen=True)
class ServeConfig:
    max_len: int = 2048


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
                 fused_tasks=None):
        """``fused_tasks``: the stacked fused task tables
        ``{'table': (L, tasks, V, d)}`` (``aot.stack_tasks``) on the model's
        device; None serves the bare backbone."""
        self.model = model
        self.params = params
        self.cfg = cfg
        self.device = model.device
        self.tables = None
        self.num_tasks: Optional[int] = None
        if fused_tasks is not None:
            self.tables = fused_tasks["table"]
            if self.tables.device != self.device:
                raise ValueError(f"task tables are on {self.tables.device}, "
                                 f"the model on {self.device}")
            # task-id validity bound: the scheduler rejects task ids the
            # gather would clamp
            self.num_tasks = self.tables.shape[1]
        # serve_step calls: the scheduler asserts one per tick
        self.dispatches = 0

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
        takes the exact argmax. The host arrays travel to the card in one
        copy, and the tokens and finite flags come back in one.
        Returns (next token per slot (num_slots,) np, per-slot logits
        (num_slots, V) on the device, the pool cache (updated in place),
        per-slot finite flags (num_slots,) bool np: False means that slot's
        logits row holds NaN/inf)."""
        temps = np.asarray(sample[0], np.float32)
        stochastic = bool(np.any(temps > 0.0))
        arrays = [tokens, token_rows, token_pos, logit_idx, token_tasks,
                  block_tables]
        if stochastic:
            arrays += [temps, sample[1], sample[2],
                       np.asarray(sample[3], np.uint32), sample[4]]
        buf, spans = _pack_int32(arrays)
        dev_buf = torch.from_numpy(buf).to(self.device, non_blocking=True)
        t = [dev_buf[at:at + int(np.prod(shape))].view(shape)
             for at, shape in spans]
        tok, rows, pos, lidx, tasks, bt = t[:6]
        peft = None
        if self.tables is not None:
            peft = {"method": "aot", "tables": self.tables, "task_ids": tasks}
        logits, cache = self.model.mixed_step(
            self.params, tok, rows, pos, cache, peft, block_tables=bt,
            logit_idx=lidx)
        if stochastic:
            tp, tk, pp, keys, steps = t[6:]
            toks = sample_tokens(logits, tp.view(torch.float32), tk,
                                 pp.view(torch.float32),
                                 keys.long() & 0xFFFFFFFF, steps)
        else:
            toks = logits.argmax(dim=-1)
        finite = torch.isfinite(logits).all(dim=-1)
        out = torch.stack([toks.int(), finite.int()]).cpu().numpy()
        self.dispatches += 1
        return out[0], logits, cache, out[1].astype(bool)
