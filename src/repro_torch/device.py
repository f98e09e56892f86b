"""Where the port runs: the card unless the caller asks for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``, refusing CUDA when there is none: the port
    never slides onto the CPU by itself (pass ``device="cpu"`` for that)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run the port on the CPU")
        if dev.index is None:       # "cuda" means the current device
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def generator(device, seed: int) -> torch.Generator:
    """A ``torch.Generator`` seeded with ``seed`` for draws into tensors on
    ``device``: on the device itself, or on the CPU for ``meta`` tensors,
    which take no draw (a meta init allocates and draws nothing, and
    gives the real init's shapes and dtypes)."""
    dev = torch.device(device)
    return torch.Generator(device="cpu" if dev.type == "meta" else dev
                           ).manual_seed(seed)
