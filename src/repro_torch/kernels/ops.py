"""Public wrappers of the port's kernels.

A wrapper given CPU tensors runs its kernel's plain PyTorch version; given
CUDA tensors it launches the CUDA kernel or raises. There is no fallback
from one to the other. Each wrapper carries ``launches``, a plain integer
that counts its kernel's launches (and nothing else), so that a run can
show that it went through the kernel; ``reset_launches`` zeroes them all.
A kernel function given an empty output returns it without a launch, so
a wrapper counts only a non-empty output.

A kernel's output carries no autograd history. So a wrapper about to
launch while grad mode is on and an input requires grad raises
RuntimeError before it builds or launches anything: training runs the
model with ``attn_impl="ref"``. The plain versions stay differentiable.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.aot_bias import (aot_gather_add_kernel,
                                          aot_gather_add_multitask_kernel,
                                          aot_gather_add_multitask_plain,
                                          aot_gather_add_plain,
                                          rms_norm_kernel, rms_norm_plain)
from repro_torch.kernels.decode_attention import (
    decode_attention_kernel, decode_attention_plain,
    paged_decode_attention_kernel, paged_decode_attention_plain, plan_tensor,
    ragged_paged_attention_kernel, ragged_paged_attention_plain)
from repro_torch.kernels.flash_attention import (attention_chunked,
                                                 flash_attention_kernel,
                                                 flash_attention_plain)


def _on_cpu(*xs) -> bool:
    """True when every tensor among ``xs`` lies on the CPU (plain numbers,
    such as a scalar ``cur_len``, lie nowhere)."""
    return all(x.device.type == "cpu" for x in xs
               if isinstance(x, torch.Tensor))


def _refuse_grad(name, *xs) -> None:
    """Raise before a kernel launch that would silently cut the autograd
    graph: grad mode on and a tensor among ``xs`` requiring grad."""
    if torch.is_grad_enabled() and any(
            isinstance(x, torch.Tensor) and x.requires_grad for x in xs):
        raise RuntimeError(
            f"ops.{name}: the CUDA kernel has no backward pass, and an "
            "input requires grad; train with ModelOptions(attn_impl='ref') "
            "(differentiable plain PyTorch), or call under torch.no_grad()")


def _count(wrapper, res):
    """Add one to ``wrapper.launches`` unless its kernel's output ``res``
    (a tensor, or the fused gather-add's (h, x) pair) is empty, which
    launches nothing; returns ``res``."""
    first = res[0] if isinstance(res, tuple) else res
    wrapper.launches += first.numel() > 0
    return res


def aot_gather_add(h, table, ids, *, norm=None):
    """h: (T, d) or (b, s, d); table: (V, d); ids: (T,) or (b, s) int32 ->
    ``h + table[ids]`` in h's dtype (the paper's Eq. 1 for one task; an id
    outside ``[-V, V)`` gives a NaN row, as ``jnp.take`` does). With
    ``norm`` = (scale (d,) float32, eps): the pair (that sum, its RMSNorm),
    from one launch."""
    if _on_cpu(h, table, ids, *(norm or ())):
        return aot_gather_add_plain(h, table, ids, norm=norm)
    _refuse_grad("aot_gather_add", h, table, ids, *(norm or ()))
    if h.dim() == 3:
        res = aot_gather_add(h.reshape(-1, h.shape[-1]), table,
                             ids.reshape(-1), norm=norm)
        return (res.view(h.shape) if norm is None
                else tuple(r.view(h.shape) for r in res))
    return _count(aot_gather_add,
                  aot_gather_add_kernel(h, table, ids, norm=norm))


def aot_gather_add_multitask(h, tables, task_ids, ids, *, norm=None):
    """h: (T, d); tables: (n_tasks, V, d); task_ids / ids: (T,) int32 ->
    ``h + tables[task_ids, ids]`` in h's dtype (the paper's Eq. 1); with
    ``norm`` as for :func:`aot_gather_add`."""
    if _on_cpu(h, tables, task_ids, ids, *(norm or ())):
        return aot_gather_add_multitask_plain(h, tables, task_ids, ids,
                                              norm=norm)
    _refuse_grad("aot_gather_add_multitask", h, tables, task_ids, ids,
             *(norm or ()))
    return _count(aot_gather_add_multitask, aot_gather_add_multitask_kernel(
        h, tables, task_ids, ids, norm=norm))


def rms_norm(h, scale, eps):
    """h: (..., d); scale: (d,) float32 -> h's RMSNorm in h's dtype
    (``layers.apply_norm``'s arithmetic): the fused gather-add's norm with
    no table, for a block whose input takes no AoT rows."""
    if _on_cpu(h, scale):
        return rms_norm_plain(h, scale, eps)
    _refuse_grad("rms_norm", h, scale)
    if h.dim() != 2:
        return rms_norm(h.reshape(-1, h.shape[-1]), scale, eps).view(h.shape)
    return _count(rms_norm, rms_norm_kernel(h, scale, eps))


def ragged_plan(token_rows, token_pos):
    """The ragged kernel's plan for a packed list on the card (see
    ``decode_attention.ragged_plan``), built from host copies of the
    indices: a wait on the stream, for calls outside the serving tick
    (which uploads its plan with its other arrays). None on the CPU, whose
    plain version needs no plan."""
    if _on_cpu(token_rows, token_pos):
        return None
    return plan_tensor(token_rows, token_pos)


def ragged_paged_attention(q, k_pages, v_pages, block_tables, token_rows,
                           token_pos, plan=None):
    """q: (T, h, hd) packed tokens; pages: (num_blocks, block_size, kvh,
    hd) with this step's KV already written; block_tables: (num_slots,
    npages); token_rows / token_pos: (T,) int32 (pos -1 = dead token);
    plan: the kernel's (n_items, 2) int32 plan of these indices on the
    card, or None to build it here (:func:`ragged_plan`); the plain
    version ignores it."""
    if _on_cpu(q, k_pages, v_pages, block_tables, token_rows, token_pos):
        return ragged_paged_attention_plain(q, k_pages, v_pages, block_tables,
                                            token_rows, token_pos)
    _refuse_grad("ragged_paged_attention", q, k_pages, v_pages)
    out = ragged_paged_attention_kernel(q, k_pages, v_pages, block_tables,
                                        token_rows, token_pos, plan)
    ragged_paged_attention.launches += out.numel() > 0
    return out


def flash_attention(q, k, v, *, causal=True, window=0, prefix_len=0,
                    softcap=0.0, q_offset=0):
    """q: (b, sq, h, hd); k / v: (b, skv, kvh, hd) -> (b, sq, h, hd): the
    reference's model-facing signature. Query row i sits at position
    ``q_offset + i``: P-Tuning v2 prepends its prefix to k and v and
    attends with ``q_offset`` = the prefix length, which the reference
    sends to XLA and the port to the flash kernel. A bidirectional
    ``prefix_len`` (paligemma's patches, P-Tuning v1's prompt) goes to
    ``flash_attention.attention_chunked``, plain PyTorch, as the
    reference's wrapper sends it to its chunked XLA path: counted in
    :func:`chunked_calls`, not as a launch. ``softcap`` is not ported and raises."""
    if softcap:
        raise NotImplementedError("flash_attention: softcap is not ported")
    if prefix_len:
        flash_attention.chunked += 1
        return attention_chunked(q, k, v, causal=causal, window=window,
                                 prefix_len=prefix_len, q_offset=q_offset)
    if _on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    _refuse_grad("flash_attention", q, k, v)
    out = flash_attention_kernel(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset)
    flash_attention.launches += out.numel() > 0
    return out


def decode_attention(q, k_cache, v_cache, cur_len):
    """q: (b, h, hd) one query per row; caches: (b, S, kvh, hd) with this
    step's KV already written; cur_len: scalar or (b,) visible lengths."""
    if _on_cpu(q, k_cache, v_cache, cur_len):
        return decode_attention_plain(q, k_cache, v_cache, cur_len)
    _refuse_grad("decode_attention", q, k_cache, v_cache)
    out = decode_attention_kernel(q, k_cache, v_cache, cur_len)
    decode_attention.launches += out.numel() > 0
    return out


def paged_decode_attention(q, k_pages, v_pages, block_tables, cur_len):
    """q: (b, h, hd); pages: (num_blocks, block_size, kvh, hd) with this
    step's KV already written; block_tables: (b, npages); cur_len: (b,)
    int32 visible lengths."""
    if _on_cpu(q, k_pages, v_pages, block_tables, cur_len):
        return paged_decode_attention_plain(q, k_pages, v_pages, block_tables,
                                            cur_len)
    _refuse_grad("paged_decode_attention", q, k_pages, v_pages)
    out = paged_decode_attention_kernel(q, k_pages, v_pages, block_tables,
                                        cur_len)
    paged_decode_attention.launches += out.numel() > 0
    return out


WRAPPERS = (aot_gather_add, aot_gather_add_multitask, rms_norm,
            ragged_paged_attention, flash_attention, decode_attention,
            paged_decode_attention)


def reset_launches() -> None:
    """Zero every kernel's launch count and :func:`chunked_calls`."""
    for fn in WRAPPERS:
        fn.launches = 0
    flash_attention.chunked = 0


def launches() -> Dict[str, int]:
    return {fn.__name__: fn.launches for fn in WRAPPERS}


def chunked_calls() -> int:
    """The :func:`flash_attention` calls sent to ``attention_chunked`` (a
    ``prefix_len``) since :func:`reset_launches`: no kernel launch."""
    return flash_attention.chunked


reset_launches()
