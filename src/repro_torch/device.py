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
