"""Atomic, retained, asynchronous checkpoints of trees of tensors: the
port's counterpart of ``repro.checkpoint.manager``, in its on-disk format
byte for byte, so a checkpoint crosses between the two packages in either
direction.

Layout: ``<dir>/step_<n:010d>/`` holds ``arrays.npz`` (leaves ``a0 ..
a{k-1}`` in jax's order: dict keys sorted, ``None`` an empty subtree),
``manifest.json`` (``{"step", "structure", "names"}``) and
``extra.json``. A save is written into ``step_<n>.tmp`` and renamed, so a
crash mid-save never corrupts the newest complete checkpoint; ``keep``
bounds how many stay.

Leaves cross as numpy does them: a Python ``int`` (the port's step
counters) is written as a 0-d ``int32``, as the reference holds its step,
and comes back as an ``int`` where ``like`` holds one; a bfloat16 tensor
is written as the raw 2-byte void (``|V2``) that numpy saves of a jax
bfloat16 array, and a ``|V2`` leaf is read back into a bfloat16 ``like``
leaf bit for bit (into anything else it raises).
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch import tree as T

BF16_RAW = np.dtype("V2")           # how numpy saves a bfloat16 leaf


def _host(x) -> np.ndarray:
    """A host numpy copy of one leaf (never a view of ``x``: a later
    in-place update must not change what is written). A DTensor leaf is
    written whole (``full_tensor``, a collective over its mesh), so a
    checkpoint has the reference's format whatever mesh wrote it."""
    if isinstance(x, DTensor):
        x = x.full_tensor()
    if isinstance(x, torch.Tensor):
        if x.device.type == "meta":
            raise ValueError("cannot save a meta tensor (it holds no data)")
        t = x.detach().contiguous().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(BF16_RAW)
        return t.numpy()
    if isinstance(x, int) and not isinstance(x, bool):
        return np.asarray(x, np.int32)    # the reference's 0-d int32 step
    return np.array(x, copy=True)


def _flatten(tree) -> Tuple[Dict[str, np.ndarray], str]:
    """(``a0..`` host copies of the leaves in jax's order, the tree's
    structure string)."""
    arrays = {f"a{i}": _host(x) for i, x in enumerate(T.sorted_leaves(tree))}
    return arrays, T.structure(tree)


def _shape(x) -> Tuple[int, ...]:
    return tuple(x.shape) if isinstance(x, torch.Tensor) else np.shape(x)


def _restore_leaf(arr: np.ndarray, like, device):
    """One saved leaf shaped as ``like``'s: a tensor of the saved dtype on
    ``device`` (default: ``like``'s, the CPU for a meta tensor), an
    ``int`` for an ``int``, else the numpy array."""
    if isinstance(like, torch.Tensor):
        if arr.dtype.kind == "V":
            if arr.dtype.itemsize != 2 or like.dtype != torch.bfloat16:
                raise ValueError(
                    f"a raw {arr.dtype.str} leaf (numpy's bfloat16) needs a "
                    f"bfloat16 leaf in like, got {like.dtype}")
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        if device is None:
            device = "cpu" if like.device.type == "meta" else like.device
        return t.to(device)
    if isinstance(like, int) and not isinstance(like, bool):
        return int(arr)
    return arr


class CheckpointManager:
    """``writer``: whether this process writes. Under a mesh every rank
    calls :meth:`save` (gathering a DTensor leaf is a collective) and one
    rank, made with ``writer=True``, writes."""

    def __init__(self, directory: str, keep: int = 3, async_save: bool = True,
                 writer: bool = True):
        self.dir = directory
        self.keep = keep
        self.writer = writer
        os.makedirs(directory, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue()
        self._err: Optional[BaseException] = None
        self._async = async_save
        if async_save:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    # ------------------------------------------------------------------
    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            try:
                self._write(*item)
            except BaseException as e:      # noqa: BLE001 raised at save/wait
                self._err = e
            finally:
                self._q.task_done()

    def _write(self, step: int, arrays: Dict[str, np.ndarray],
               structure: str, extra: Dict):
        tmp = os.path.join(self.dir, f"step_{step:010d}.tmp")
        final = os.path.join(self.dir, f"step_{step:010d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "structure": structure,
                       "names": sorted(arrays.keys())}, f)
        with open(os.path.join(tmp, "extra.json"), "w") as f:
            json.dump(extra, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    def _raise_pending(self):
        if self._err:
            err, self._err = self._err, None
            raise err

    # ------------------------------------------------------------------
    def save(self, step: int, tree, extra: Optional[Dict] = None):
        """Write ``tree`` as step ``step``: its leaves are copied to the
        host here (the writer thread sees only the copies), then written
        by the writer (``async_save``) or at once. A failed earlier
        write is raised here."""
        self._raise_pending()
        arrays, structure = _flatten(tree)
        if not self.writer:
            return
        if self._async:
            self._q.put((step, arrays, structure, extra or {}))
        else:
            self._write(step, arrays, structure, extra or {})

    def wait(self):
        """Wait for every pending write; raise the first that failed."""
        self._q.join()
        self._raise_pending()

    def all_steps(self) -> List[int]:
        out = []
        for n in os.listdir(self.dir):
            if n.startswith("step_") and not n.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, n, "manifest.json")):
                    out.append(int(n[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like, step: Optional[int] = None,
                device=None) -> Tuple[Any, Dict]:
        """Restore step ``step`` (default the newest) into the structure
        of ``like``, whose leaves may be ``meta`` tensors (only their
        shapes and dtypes are read). Returns (tree, extra): tensors of the
        saved dtype on ``device`` (default each ``like`` leaf's device),
        ints where ``like`` holds ints."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:010d}")
        flat = T.sorted_leaves(like)
        with np.load(os.path.join(path, "arrays.npz")) as data:
            if len(flat) != len(data.files):
                raise ValueError(f"checkpoint has {len(data.files)} leaves, "
                                 f"structure needs {len(flat)}")
            leaves = []
            for i, want in enumerate(flat):
                got = data[f"a{i}"]
                if tuple(got.shape) != _shape(want):
                    raise ValueError(f"leaf a{i}: checkpoint shape "
                                     f"{got.shape}, structure needs "
                                     f"{_shape(want)}")
                leaves.append(_restore_leaf(got, want, device))
                del got
        with open(os.path.join(path, "extra.json")) as f:
            extra = json.load(f)
        return T.sorted_unflatten(like, leaves), extra
