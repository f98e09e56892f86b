"""Public wrappers of the port's kernels.

A wrapper given CPU tensors runs its kernel's plain PyTorch version; given
CUDA tensors it launches the CUDA kernel or raises. There is no fallback
from one to the other. Each wrapper carries ``launches``, a plain integer
that counts its kernel's launches (and nothing else), so that a run can
show that it went through the kernel; ``reset_launches`` zeroes them all.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels.aot_bias import (aot_gather_add_multitask_kernel,
                                          aot_gather_add_multitask_plain)
from repro_torch.kernels.decode_attention import (
    ragged_paged_attention_kernel, ragged_paged_attention_plain)


def _on_cpu(*xs) -> bool:
    return all(x.device.type == "cpu" for x in xs)


def aot_gather_add_multitask(h, tables, task_ids, ids):
    """h: (T, d); tables: (n_tasks, V, d); task_ids / ids: (T,) int32 ->
    ``h + tables[task_ids, ids]`` in h's dtype (the paper's Eq. 1)."""
    if _on_cpu(h, tables, task_ids, ids):
        return aot_gather_add_multitask_plain(h, tables, task_ids, ids)
    out = aot_gather_add_multitask_kernel(h, tables, task_ids, ids)
    aot_gather_add_multitask.launches += 1
    return out


def ragged_paged_attention(q, k_pages, v_pages, block_tables, token_rows,
                           token_pos):
    """q: (T, h, hd) packed tokens; pages: (num_blocks, block_size, kvh,
    hd) with this step's KV already written; block_tables: (num_slots,
    npages); token_rows / token_pos: (T,) int32 (pos -1 = dead token)."""
    if _on_cpu(q, k_pages, v_pages, block_tables, token_rows, token_pos):
        return ragged_paged_attention_plain(q, k_pages, v_pages, block_tables,
                                            token_rows, token_pos)
    out = ragged_paged_attention_kernel(q, k_pages, v_pages, block_tables,
                                        token_rows, token_pos)
    ragged_paged_attention.launches += 1
    return out


aot_gather_add_multitask.launches = 0
ragged_paged_attention.launches = 0

WRAPPERS = (aot_gather_add_multitask, ragged_paged_attention)


def reset_launches() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


def launches() -> Dict[str, int]:
    return {fn.__name__: fn.launches for fn in WRAPPERS}
