"""Clean counterpart: injectable clock + relative timers only."""
import time


def export(path, snapshot, clock):
    rec = {"ts": clock(), "metrics": snapshot}
    return path, rec


def timed(fn):
    t0 = time.perf_counter()        # relative timer: fine
    out = fn()
    return out, time.perf_counter() - t0
