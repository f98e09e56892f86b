"""Clean counterpart: total dispatch, canonical tuple, raising else."""
FINISHED, SHED = "finished", "shed"
ABORTED, QUARANTINED = "aborted", "quarantined"
TERMINAL_STATES = (FINISHED, SHED, ABORTED, QUARANTINED)


def ladder(req):
    if req.state == FINISHED:
        return "done"
    elif req.state == SHED:
        return "shed"
    else:                           # raising else: future states explode
        raise ValueError(f"unhandled terminal state {req.state}")


def membership(req):
    return req.state in TERMINAL_STATES     # canonical spelling: total


def membership_enumerated(req):
    return req.state in (FINISHED, SHED, ABORTED, QUARANTINED)


COUNTS_BY_STATE = {
    "live": 0,
    FINISHED: 0,
    SHED: 0,
    ABORTED: 0,
    QUARANTINED: 0,
}
