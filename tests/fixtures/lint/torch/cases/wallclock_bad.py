"""Seeded wallclock violation: epoch stamp in a determinism-scoped file."""
import time


def export(path, snapshot):
    rec = {"ts": time.time(), "metrics": snapshot}
    return path, rec
