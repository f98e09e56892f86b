"""Device meshes over the ranks of a process group.

Counterpart of ``repro.launch.mesh``. The production meshes are the
reference's: one pod as (data 16, model 16), two as (pod 2, data 16,
model 16), the pod axis an outer data axis. Nothing here touches the
process group at import.

:func:`init_group` starts the process group: NCCL with one GPU per rank
when the device is CUDA (refused when the host has fewer GPUs than
ranks), gloo only for ``device="cpu"``. Nothing slides from one to the
other.
"""
from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.device import resolve_device


def init_group(rank: int, world: int, device="cuda", *,
               init_method: Optional[str] = None,
               timeout_s: float = 600.0) -> torch.device:
    """Join the process group as ``rank`` of ``world`` and return this
    rank's device. ``device``: "cuda" (NCCL, one GPU per rank: GPU
    ``LOCAL_RANK`` when set, as ``torchrun`` sets it, else GPU ``rank``)
    or "cpu" (gloo). ``init_method``: a ``tcp://host:port`` or ``file://``
    URL; None reads ``MASTER_ADDR`` / ``MASTER_PORT`` from the environment, as
    ``torchrun`` sets them. ``timeout_s`` bounds every collective."""
    kind = torch.device(device).type
    if kind == "cuda":
        resolve_device("cuda")          # refuses a host without a card
        if torch.cuda.device_count() < world:
            raise RuntimeError(
                f"{world} ranks need {world} GPUs (one each, NCCL); this "
                f"host has {torch.cuda.device_count()}")
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local)
        dev, backend = torch.device("cuda", local), "nccl"
    elif kind == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"device {device!r}: 'cuda' or 'cpu'")
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method or "env://", rank=rank,
            world_size=world, timeout=timedelta(seconds=timeout_s))
    return dev


def make_mesh(shape: Sequence[int], axes: Sequence[str], device_type=None):
    """A mesh of ``shape`` with dim names ``axes`` over the ranks of the
    initialised process group, whose size must equal the mesh's.
    ``device_type``: "cuda" or "cpu" (default: the group's backend's)."""
    n = int(np.prod(shape))
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"mesh {tuple(shape)} needs {n} ranks; the group "
                         f"has {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """(data 16, model 16), or (pod 2, data 16, model 16) with
    ``multi_pod``: 256 or 512 ranks, asserted as the reference asserts
    its device count."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    world = dist.get_world_size() if dist.is_initialized() else 1
    assert world == n, (f"mesh {shape} needs {n} ranks; the group has "
                        f"{world}")
    return make_mesh(shape, axes, device_type)


def parse_mesh(text: str):
    """"DxM" -> ((D, M), ("data", "model")); "D" -> ((D,), ("data",))."""
    shape = tuple(int(x) for x in text.lower().split("x"))
    if not 1 <= len(shape) <= 2 or min(shape) < 1:
        raise ValueError(f"--mesh {text!r}: DxM, for example 2x4")
    return shape, ("data", "model")[:len(shape)]


def env_rank():
    """(rank, world) from ``RANK`` / ``WORLD_SIZE`` (``torchrun`` sets
    them), or None outside such a launch."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    return None
