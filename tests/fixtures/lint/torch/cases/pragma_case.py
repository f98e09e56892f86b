"""Pragma fixture: one justified suppression, one reasonless (ignored),
one pragma on the line above."""
import time


def suppressed(snapshot):
    # repro-lint: allow[wallclock] test fixture exercising suppression
    return {"ts": time.time(), "metrics": snapshot}


def reasonless(snapshot):
    return {"ts": time.time(), "metrics": snapshot}  # repro-lint: allow[wallclock]


def line_above(snapshot):
    # repro-lint: allow[wallclock] pragma on the preceding line counts too
    ts = time.time()
    return {"ts": ts, "metrics": snapshot}
