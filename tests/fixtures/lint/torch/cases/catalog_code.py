"""Metric-emitting fixture for the catalog-consistency rule."""


def register(m, reason):
    ticks = m.counter("fix_ticks_total", "ticks")
    depth = m.gauge("fix_queue_depth", "queue depth")
    m.counter(f"fix_shed_{reason}_total", "per-reason shed")
    m.histogram("fix_undocumented_ms", [1, 2], "not in any catalog")
    return ticks, depth
