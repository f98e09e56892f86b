"""Public wrappers of the port's kernels.

A wrapper given CPU tensors runs its kernel's plain PyTorch version; given
CUDA tensors it launches the CUDA kernel or raises. There is no fallback
from one to the other. Each wrapper carries ``launches``, a plain integer
that counts its kernel's launches (and nothing else), so that a run can
show that it went through the kernel; ``reset_launches`` zeroes them all.
A kernel function given an empty output returns it without a launch, so
a wrapper counts only a non-empty output.

Under a mesh (``distrib.sharding``) the flash and gather-add wrappers
take DTensors: each runs its kernel (or, on the CPU, the plain version)
once per rank on that rank's local shards, laid out so that the kernel's
reductions stay whole, and wraps the result as a DTensor again; the
decode, paged and ragged wrappers take plain tensors only. A call on
shards counts one launch per rank, as the unsharded call does.

A kernel's output carries no autograd history. So a wrapper about to
launch while grad mode is on and an input requires grad raises
RuntimeError before it builds or launches anything: training runs the
model with ``attn_impl="ref"``. The plain versions stay differentiable.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.distrib import sharding as shlib
from repro_torch.kernels.aot_bias import (aot_gather_add_kernel,
                                          aot_gather_add_multitask_kernel,
                                          aot_gather_add_multitask_plain,
                                          aot_gather_add_plain,
                                          rms_norm_kernel, rms_norm_plain,
                                          sharded_rows)
from repro_torch.kernels.decode_attention import (
    decode_attention_kernel, decode_attention_plain,
    paged_decode_attention_kernel, paged_decode_attention_plain, plan_tensor,
    ragged_paged_attention_kernel, ragged_paged_attention_plain)
from repro_torch.kernels.flash_attention import (attention_chunked,
                                                 flash_attention_kernel,
                                                 flash_attention_plain,
                                                 kv_span)


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


def _mesh_of(*xs):
    """The mesh of the first DTensor among ``xs``, or None."""
    for x in xs:
        if isinstance(x, DTensor):
            return x.device_mesh
    return None


def _refuse_mesh(name, *xs) -> None:
    """Raise for a DTensor among ``xs``: wrapper ``name`` has no shard
    layout."""
    if _mesh_of(*xs) is not None:
        raise NotImplementedError(
            f"ops.{name} takes plain tensors; under a mesh only flash "
            "attention and the gather-adds run on shards")


def _local_rows(x, mesh, rows):
    """This rank's rows of ``x`` (a DTensor, or a plain tensor the same on
    every rank) under the row layout ``rows``, the rest of x whole."""
    return shlib.as_dtensor(x, mesh).redistribute(mesh, rows).to_local()


def _whole(x, mesh):
    """All of ``x`` on this rank (a parameter such as the norm's scale, or
    a plain tensor as it is)."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()


def _sharded_gather_add(wrapper, h, table, task_ids, ids, norm):
    """``wrapper`` (one of the gather-adds) on local shards. h (..., d)
    keeps the sharding of its leading dim and its embed dim is made whole
    (the norm needs all of d); the indices (h's leading shape) follow h's
    rows. A table this rank holds whole is handed to the kernel as it is;
    a table sharded on its vocab, task or embed dims gives only the rows
    this call gathers (``aot_bias.sharded_rows``), which the kernel then
    adds by position. The outputs are DTensors in h's layout."""
    mesh = _mesh_of(h, table, task_ids, ids)
    h = shlib.as_dtensor(h, mesh)
    rows = [Shard(0) if p.is_shard(0) else Replicate() for p in h.placements]
    h_l = h.redistribute(mesh, rows).to_local()
    flat = h_l.reshape(-1, h_l.shape[-1])
    ids_l = _local_rows(ids, mesh, rows).reshape(-1)
    tasks_l = None if task_ids is None else _local_rows(
        task_ids, mesh, rows).reshape(-1)
    norm_l = None if norm is None else (_whole(norm[0], mesh), norm[1])
    multi = task_ids is not None
    if not isinstance(table, DTensor) or shlib.whole_on_rank(table):
        tl = table.to_local() if isinstance(table, DTensor) else table
        args = (tl, tasks_l, ids_l) if multi else (tl, ids_l)
    else:
        whole = lambda x: _whole(shlib.as_dtensor(x, mesh), mesh).reshape(-1)
        got = sharded_rows(table, whole(task_ids) if multi else None,
                           whole(ids))
        got = got.redistribute(mesh, rows).to_local()     # (T_local, d)
        if got.shape[0] != flat.shape[0]:
            raise ValueError(f"h's rows {tuple(h.shape)} split unevenly over "
                             f"the mesh; the gathered rows do not align")
        if not multi:       # jnp.take's NaN row for an id outside [-V, V)
            vocab = table.shape[0]
            bad = (ids_l.long() < -vocab) | (ids_l.long() >= vocab)
            got = torch.where(bad[:, None], got.new_full((), float("nan")),
                              got)
        at = torch.arange(flat.shape[0], dtype=torch.int32,
                          device=flat.device)
        args = ((got[None], torch.zeros_like(at), at) if multi
                else (got, at))
    res = wrapper(flat, *args, norm=norm_l)
    wrap = lambda r: shlib.from_local(r.view(h_l.shape), mesh, rows,
                                      tuple(h.shape))
    return wrap(res) if norm is None else tuple(wrap(r) for r in res)


def _sharded_flash(q, k, v, kw):
    """:func:`flash_attention` on local shards: batch rows sharded alike
    in q, k and v; query heads sharded with the KV heads they read (KV
    heads that a mesh dim does not divide stay replicated, and each rank
    slices the span its query heads read); sequence and head_dim whole.
    The output is a DTensor in q's layout."""
    mesh = _mesh_of(q, k, v)
    q, k, v = (shlib.as_dtensor(x, mesh) for x in (q, k, v))
    b, h, kvh = q.shape[0], q.shape[2], k.shape[2]
    qp, kp = [], []
    for m in range(mesh.ndim):
        n, a, c = mesh.size(m), q.placements[m], k.placements[m]
        if (a.is_shard(0) or c.is_shard(0)) and b % n == 0:
            qp.append(Shard(0))
            kp.append(Shard(0))
        elif (a.is_shard(2) or c.is_shard(2)) and h % n == 0:
            qp.append(Shard(2))
            kp.append(Shard(2) if c.is_shard(2) and kvh % n == 0
                      else Replicate())
        else:
            qp.append(Replicate())
            kp.append(Replicate())
    q_off, q_len = shlib.shard_range(qp, mesh, 2, h)
    k_off, k_len = shlib.shard_range(kp, mesh, 2, kvh)
    span = kv_span(q_off, q_len, h // kvh)
    if span is None or span[0] < k_off or span[1] > k_off + k_len:
        # query heads that split a group unevenly: heads whole
        qp = [Replicate() if p.is_shard(2) else p for p in qp]
        kp = [Replicate() if p.is_shard(2) else p for p in kp]
        k_off, span = 0, (0, kvh)
    ql = q.redistribute(mesh, qp).to_local()
    kl, vl = (x.redistribute(mesh, kp).to_local()[
        :, :, span[0] - k_off:span[1] - k_off] for x in (k, v))
    out = flash_attention(ql, kl, vl, **kw)
    return shlib.from_local(out, mesh, qp, tuple(q.shape))


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
    if _mesh_of(h, table, ids, *(norm or ())) is not None:
        return _sharded_gather_add(aot_gather_add, h, table, None, ids, norm)
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
    if _mesh_of(h, tables, task_ids, ids, *(norm or ())) is not None:
        return _sharded_gather_add(aot_gather_add_multitask, h, tables,
                                   task_ids, ids, norm)
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
    mesh = _mesh_of(h, scale)
    if mesh is not None:        # rows as h has them, d whole
        h = shlib.as_dtensor(h, mesh)
        last = h.dim() - 1
        keep = [p if p.is_shard() and p.dim < last else Replicate()
                for p in h.placements]
        x = rms_norm(h.redistribute(mesh, keep).to_local(),
                     _whole(scale, mesh), eps)
        return shlib.from_local(x, mesh, keep, tuple(h.shape))
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
    _refuse_mesh("ragged_paged_attention", q, k_pages, v_pages, block_tables,
                 token_rows, token_pos)
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
    :func:`chunked_calls`, not as a launch; so does a ``softcap``, which the
    kernel does not take (the reference's wrapper sends it there too)."""
    if prefix_len or softcap:   # plain PyTorch, on DTensors too
        flash_attention.chunked += 1
        return attention_chunked(q, k, v, causal=causal, window=window,
                                 prefix_len=prefix_len, q_offset=q_offset,
                                 softcap=softcap)
    if _mesh_of(q, k, v) is not None:
        return _sharded_flash(q, k, v, dict(causal=causal, window=window,
                                            q_offset=q_offset))
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
    _refuse_mesh("decode_attention", q, k_cache, v_cache, cur_len)
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
    _refuse_mesh("paged_decode_attention", q, k_pages, v_pages, block_tables,
                 cur_len)
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
