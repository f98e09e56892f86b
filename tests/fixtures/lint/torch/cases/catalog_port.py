"""A registry that emits one name of the shared catalog and one that only
the port emits."""


def register(m):
    ticks = m.counter("fix_ticks_total", "ticks")
    port = m.counter("fix_port_only_total", "a name only the port emits")
    return ticks, port
