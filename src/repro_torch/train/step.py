"""The training step: PEFT-partitioned parameters, chunked cross-entropy,
AdamW. Counterpart of ``repro.train.step``, in eager PyTorch with autograd
on the model's ``attn_impl="ref"`` or ``"chunked"`` path (the kernels have
no backward).

The parameter tree is split into (trainable, frozen) before the step sees
it: for the PEFT methods trainable = ``{"peft": ...}`` and frozen =
``{"backbone": ...}``; for ``ft`` trainable = ``{"backbone", "peft"}``
(peft may hold just the head). Frozen leaves have ``requires_grad`` off;
gradients and optimizer state exist for the trainable tree only.

Cross-entropy runs in sequence chunks, each under
``torch.utils.checkpoint``, so the (b, s, |V|) logits are never resident
for the backward pass. A MoE backbone adds its auxiliary losses, as the
reference: ``moe_lb_weight`` times the load-balance loss and
``moe_z_weight`` times the router z-loss, each averaged over the MoE
layers.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as T
from repro_torch.core import peft as peft_mod
from repro_torch.distrib.sharding import constrain, matmul
from repro_torch.optim import adamw, clip_by_global_norm
from repro_torch.optim.schedules import constant


@dataclass(frozen=True)
class TrainConfig:
    peft: peft_mod.PEFTOptions = field(default_factory=peft_mod.PEFTOptions)
    lr: float = 1e-3
    weight_decay: float = 0.0
    clip_norm: float = 1.0
    loss_chunk: int = 1024          # sequence chunk for CE (0 = unchunked)
    z_loss: float = 1e-4
    moe_lb_weight: float = 1e-2
    moe_z_weight: float = 1e-3
    schedule: Any = None            # callable(step) -> lr; None: constant(lr)


def _requires_grad(tree, on: bool):
    for x in T.leaves(tree):
        x.requires_grad_(on)
    return tree


def _like(g, p):
    """The gradient ``g`` of a DTensor leaf ``p`` redistributed to ``p``'s
    placements (a partial sum over the data axis becomes its all-reduce:
    the data-parallel gradient reduction); ``g`` itself otherwise."""
    if isinstance(p, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def split_train(params, peft_params, method: str):
    """(trainable, frozen) trees of the backbone ``params`` and the PEFT
    parameters; trainable leaves get ``requires_grad``, frozen ones lose
    it."""
    if method == "ft":
        trainable, frozen = {"backbone": params, "peft": peft_params}, {}
    else:
        trainable, frozen = {"peft": peft_params}, {"backbone": params}
    return _requires_grad(trainable, True), _requires_grad(frozen, False)


def merge_train(trainable, frozen):
    backbone = trainable.get("backbone", frozen.get("backbone"))
    return backbone, trainable["peft"]


def _ce_piece(hc, w, lc, mc, z_loss: float):
    # vocab, not seq, takes the model axis (the reference's constraint)
    logits = constrain(matmul(hc, w), "batch", None, "vocab").float()
    lse = torch.logsumexp(logits, dim=-1)
    if isinstance(logits, DTensor):
        # over vocab shards: each row's one gold logit among zeros, summed
        # (exact in any order); the prediction, argmax's first index of
        # the largest logit, as a max then a min over the shards
        ids = torch.arange(logits.shape[-1], device=lc.device)
        gold = torch.where(ids == lc[..., None], logits, 0.0).sum(-1)
        top = logits.amax(-1, keepdim=True)
        pred = torch.where(logits == top, ids, logits.shape[-1]).amin(-1)
    else:
        gold = logits.gather(-1, lc[..., None].long())[..., 0]
        pred = logits.argmax(-1)
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * lse.square()
    pred_ok = (pred == lc).float()
    return (nll * mc).sum(), (pred_ok * mc).sum(), mc.sum()


def chunked_ce(h, w, labels, *, chunk: int, z_loss: float, mask=None):
    """Cross entropy over the vocabulary without the full logits: h (b, s,
    d), w (d, V), labels (b, s), optional 0/1 ``mask`` (b, s). Each
    sequence chunk of ``chunk`` positions (0: one chunk) is recomputed in
    the backward pass. Returns (mean loss, accuracy) over the masked
    positions, with the z-loss ``z_loss * lse**2`` added per position."""
    b, s, _ = h.shape
    chunk = min(chunk or s, s)
    tot = correct = denom = torch.zeros((), device=h.device)
    for lo in range(0, s, chunk):
        hi = min(s, lo + chunk)
        mc = (mask[:, lo:hi].float() if mask is not None
              else torch.ones((b, hi - lo), device=h.device))
        t, c, dn = checkpoint(_ce_piece, h[:, lo:hi], w, labels[:, lo:hi],
                              mc, z_loss, use_reentrant=False)
        tot, correct, denom = tot + t, correct + c, denom + dn
    denom = torch.clamp(denom, min=1.0)
    return tot / denom, correct / denom


def frontend_inputs(batch):
    """The model's front-end keywords found in ``batch``: "patches" (a
    vision front-end's), "frames" and "aot_ids" (an audio one's), as the
    reference's step hands the model its whole batch."""
    return {k: batch[k] for k in ("patches", "frames", "aot_ids")
            if k in batch}


def make_loss_fn(model, tcfg: TrainConfig):
    """(trainable, frozen, batch, rng) -> (loss, metrics) for next-token
    prediction: ``batch`` holds "tokens" (or an audio front-end's
    "frames", :func:`frontend_inputs`) and "labels" (b, s) and
    optionally "loss_mask"; ``rng`` the step's generator (dropout). With
    MoE layers the loss adds their weighted aux losses and the metrics
    gain ``moe_lb`` and ``moe_drop`` (per MoE layer), as the
    reference's."""
    method = tcfg.peft.method

    def loss_fn(trainable, frozen, batch, rng):
        backbone, peft_params = merge_train(trainable, frozen)
        peft = peft_mod.make(peft_params, tcfg.peft) if method != "none" \
            else None
        h, aux = model.forward_aux(backbone, batch.get("tokens"), peft, rng,
                                   **frontend_inputs(batch))
        dt = model.opts.compute_dtype
        w = model.head_weight(backbone)     # E^T, or the untied lm_head
        loss, acc = chunked_ce(h.to(dt), w, batch["labels"],
                               chunk=tcfg.loss_chunk, z_loss=tcfg.z_loss,
                               mask=batch.get("loss_mask"))
        metrics = {"loss": loss, "acc": acc}
        if "moe_lb_loss" in aux:
            nmoe = max(sum(model.cfg.moe_layer_mask()), 1)
            loss = (loss + tcfg.moe_lb_weight * aux["moe_lb_loss"] / nmoe
                    + tcfg.moe_z_weight * aux["moe_z_loss"] / nmoe)
            metrics["moe_lb"] = aux["moe_lb_loss"] / nmoe
            metrics["moe_drop"] = aux["moe_dropped_frac"] / nmoe
        metrics["total_loss"] = loss
        return loss, metrics

    return loss_fn


def make_classify_loss_fn(model, tcfg: TrainConfig):
    """The paper's protocol: the classification head on the pooled
    representation (``Model.classify``); ``batch["labels"]`` (b,)."""

    def loss_fn(trainable, frozen, batch, rng):
        backbone, peft_params = merge_train(trainable, frozen)
        peft = peft_mod.make(peft_params, tcfg.peft)
        logits = model.classify(backbone, batch.get("tokens"), peft, rng,
                                **frontend_inputs(batch)).float()
        labels = batch["labels"].long()
        nll = torch.logsumexp(logits, -1) - logits.gather(
            -1, labels[:, None])[:, 0]
        acc = (logits.argmax(-1) == labels).float().mean()
        return nll.mean(), {"loss": nll.mean(), "acc": acc}

    return loss_fn


def make_train_step(model, tcfg: TrainConfig, *, classify: bool = False):
    """Returns (init_state, train_step). ``state = {"trainable", "opt",
    "step"}``; ``train_step(state, frozen, batch, rng)`` -> (new state,
    metrics): the loss's gradients with respect to the trainable leaves,
    clipped by global norm, one AdamW update. Metrics are 0-d tensors on
    the device (``loss``, ``acc``, ``total_loss`` in LM mode,
    ``grad_norm``, ``lr``); reading them waits for the device."""
    loss_fn = (make_classify_loss_fn if classify else make_loss_fn)(model,
                                                                    tcfg)
    sched = tcfg.schedule or constant(tcfg.lr)
    opt_init, opt_update = adamw(sched, weight_decay=tcfg.weight_decay)

    def init_state(trainable):
        """The state of ``trainable`` (``split_train``'s, whose leaves
        require grad) before the first step."""
        return {"trainable": trainable, "opt": opt_init(trainable),
                "step": 0}

    def train_step(state, frozen, batch, rng):
        # a state restored from a checkpoint holds plain tensors
        trainable = _requires_grad(state["trainable"], True)
        leaves = T.leaves(trainable)
        with torch.enable_grad():
            loss, metrics = loss_fn(trainable, frozen, batch, rng)
            # no trainable leaf may reach the loss (LoRA on a stack without
            # attention): every gradient is then zero, as jax.grad's
            grads = (torch.autograd.grad(loss, leaves, allow_unused=True)
                     if loss.requires_grad else [None] * len(leaves))
        grads = T.unflatten(trainable, [
            torch.zeros_like(p) if g is None else _like(g, p)
            for p, g in zip(leaves, grads)])
        metrics = {k: v.detach() for k, v in metrics.items()}
        if tcfg.clip_norm:
            grads, metrics["grad_norm"] = clip_by_global_norm(
                grads, tcfg.clip_norm)
        new_params, new_opt = opt_update(grads, state["opt"], trainable)
        metrics["lr"] = torch.tensor(sched(state["step"] + 1))
        return ({"trainable": _requires_grad(new_params, True),
                 "opt": new_opt, "step": state["step"] + 1}, metrics)

    return init_state, train_step
