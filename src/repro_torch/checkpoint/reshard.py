"""Elastic resharding: place a host tree onto any mesh.

Counterpart of ``repro.checkpoint.reshard``. A checkpoint written from
mesh A holds whole leaves (``CheckpointManager`` saves a DTensor leaf as
its full tensor, the reference's mesh-agnostic format); restored, every
rank holds the same whole tree, and :func:`reshard_tree` lays each leaf
out on mesh B under the same logical rules. Mesh shapes may differ (2 x 4
to 4 x 2, or a shrunken mesh after losing ranks) as long as the dims
stay divisible; a dim that is not stays replicated, as ``constrain``
leaves it.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

from repro_torch.distrib import axes as axlib
from repro_torch.distrib import sharding as shlib


def _whole(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


def reshard_tree(tree, mesh, rules: Dict,
                 names_fn: Callable[[tuple, object], Sequence[Optional[str]]]):
    """``names_fn(path, leaf)`` -> the leaf's logical names; every tensor
    leaf becomes a DTensor on ``mesh`` with the placements they resolve
    to (a DTensor leaf is gathered whole first, on every rank); other
    leaves (a step counter) stay as they are. Each rank must hold the same
    whole values: nothing is sent, each keeps its own shard, and
    ``requires_grad`` carries over."""
    def one(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        x = _whole(leaf).detach()
        out = distribute_tensor(
            x, mesh, shlib.placements_for(names_fn(path, x), x.shape, mesh,
                                          rules), src_data_rank=None)
        return out.requires_grad_(leaf.requires_grad)
    return axlib.map_with_path(one, tree)


def replicate_tree(tree, mesh):
    """Every tensor leaf replicated on ``mesh``."""
    def one(_, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        x = _whole(leaf).detach()
        return distribute_tensor(x, mesh, [Replicate()] * mesh.ndim,
                                 src_data_rank=None).requires_grad_(
                                     leaf.requires_grad)
    return axlib.map_with_path(one, tree)


def gather_tree(tree):
    """Every DTensor leaf as its whole plain tensor (a collective: every
    rank of its mesh calls it)."""
    return axlib.map_with_path(lambda _, x: _whole(x), tree)
