"""Seeded state-exhaustive violations: non-total terminal dispatch."""
FINISHED, SHED = "finished", "shed"
ABORTED, QUARANTINED = "aborted", "quarantined"
TERMINAL_STATES = (FINISHED, SHED, ABORTED, QUARANTINED)


def ladder(req):
    if req.state == FINISHED:       # misses QUARANTINED, no raising else
        return "done"
    elif req.state == SHED:
        return "shed"
    elif req.state == ABORTED:
        return "gone"
    return "???"


def membership(req):
    # hand-written tuple missing SHED and QUARANTINED
    return req.state in (FINISHED, ABORTED)


COUNTS_BY_STATE = {
    "live": 0,
    FINISHED: 0,                    # dict misses ABORTED + QUARANTINED
    SHED: 0,
}
