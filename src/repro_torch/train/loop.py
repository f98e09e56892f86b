"""The training loop: the step, a straggler watchdog, scalar metrics.
Counterpart of ``repro.train.loop``; checkpoint / resume (the reference's
``CheckpointManager``) waits for ROADMAP A16's ``checkpoint/``, so
``ckpt`` must be None.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.device import resolve_device


class Watchdog:
    """Fires ``on_timeout`` if ``ping`` isn't called within ``timeout_s``."""

    def __init__(self, timeout_s: float, on_timeout: Callable[[float], None]):
        self.timeout_s = timeout_s
        self.on_timeout = on_timeout
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._fired = False
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def ping(self):
        self._last = time.monotonic()
        self._fired = False

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5.0)

    def _run(self):
        while not self._stop.wait(min(self.timeout_s / 4, 1.0)):
            dt = time.monotonic() - self._last
            if dt > self.timeout_s and not self._fired:
                self._fired = True
                self.on_timeout(dt)


def step_rng(seed: int, step: int) -> torch.Generator:
    """Step ``step``'s generator (a CPU ``torch.Generator``, so drawing
    the per-layer seeds from it waits for no device): the counterpart of
    the reference's ``fold_in(PRNGKey(seed), step)``."""
    return torch.Generator().manual_seed(seed * 2 ** 32 + step)


@dataclass
class TrainLoop:
    train_step: Callable            # (state, frozen, batch, rng) -> (state, metrics)
    frozen: Any
    stream: Any                     # LMStream-like (next / state / restore)
    ckpt: Optional[Any] = None      # ROADMAP A16: must be None
    log_every: int = 10
    step_timeout_s: float = 300.0
    seed: int = 0
    device: Any = "cuda"
    events: List[Dict] = field(default_factory=list)
    history: List[Dict] = field(default_factory=list)

    def __post_init__(self):
        if self.ckpt is not None:
            raise NotImplementedError(
                "checkpointing waits for the port of checkpoint/ (ROADMAP "
                "A16); pass ckpt=None")
        self.device = resolve_device(self.device)

    def run(self, state, num_steps: int):
        """Steps 0 .. ``num_steps - 1``, each on the stream's
        next batch (moved to the device) and ``step_rng(seed, i)``. Every
        ``log_every``-th step and the last append their metrics (floats,
        read after a synchronize) with ``step`` and ``step_time_s`` (host
        clock around the step and that read) to ``history``."""
        wd = Watchdog(self.step_timeout_s, lambda dt: self.events.append(
            {"kind": "straggler", "stalled_s": dt, "t": time.time()})).start()
        try:
            for i in range(num_steps):
                batch = {k: torch.from_numpy(v).to(self.device)
                         for k, v in self.stream.next().items()}
                t0 = time.monotonic()
                state, metrics = self.train_step(state, self.frozen, batch,
                                                 step_rng(self.seed, i))
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                metrics = {k: float(v) for k, v in metrics.items()}
                metrics["step"] = i
                metrics["step_time_s"] = time.monotonic() - t0
                wd.ping()
                if i % self.log_every == 0 or i == num_steps - 1:
                    self.history.append(metrics)
        finally:
            wd.stop()
        return state
