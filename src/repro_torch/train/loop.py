"""The training loop: the step, periodic asynchronous checkpoints of the
train state and the data stream's cursor, resume from the newest one, a
straggler watchdog, scalar metrics. Counterpart of ``repro.train.loop``.

A resumed run is the unbroken run: the state comes back bit for bit
(``checkpoint.manager``), the stream resumes at its cursor, and step
``i``'s generator is ``step_rng(seed, i)`` whatever process draws it.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
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
    ckpt: Optional[CheckpointManager] = None
    ckpt_every: int = 50
    log_every: int = 10
    step_timeout_s: float = 300.0
    seed: int = 0
    device: Any = "cuda"
    events: List[Dict] = field(default_factory=list)
    history: List[Dict] = field(default_factory=list)

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def resume(self, state):
        """Restore the newest checkpoint into ``state``'s structure (its
        tensors onto the loop's device) and the stream's cursor, if there
        is a checkpoint. Returns (state, the step to start at)."""
        if self.ckpt is None or self.ckpt.latest_step() is None:
            return state, 0
        restored, extra = self.ckpt.restore(state, device=self.device)
        self.stream.restore(extra["data"])
        start = int(extra["data"]["step"])
        self.events.append({"kind": "resume",
                            "step": extra.get("step", start)})
        return restored, int(restored["step"])

    def run(self, state, num_steps: int, *, start_step: int = 0):
        """Steps ``start_step`` .. ``num_steps - 1``, each on the stream's
        next batch (moved to the device) and ``step_rng(seed, i)``. Every
        ``log_every``-th step and the last append their metrics (floats,
        read after a synchronize) with ``step`` and ``step_time_s`` (host
        clock around the step and that read) to ``history``. With
        ``ckpt``, every ``ckpt_every``-th step and the last save the state
        and the stream's cursor as step ``i + 1``; pending saves are
        waited for before returning (or raising)."""
        wd = Watchdog(self.step_timeout_s, lambda dt: self.events.append(
            {"kind": "straggler", "stalled_s": dt, "t": time.time()})).start()
        try:
            for i in range(start_step, num_steps):
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
                if self.ckpt is not None and (
                        (i + 1) % self.ckpt_every == 0 or i == num_steps - 1):
                    self.ckpt.save(i + 1, state,
                                   extra={"data": self.stream.state(),
                                          "step": i + 1})
        finally:
            wd.stop()
            if self.ckpt is not None:
                self.ckpt.wait()
        return state
