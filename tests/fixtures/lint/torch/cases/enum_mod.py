"""Enum fixture: a reordered order-sensitive tuple (vs the pinned
manifest order exhaust/straggler/crash) plus one grown without a
manifest update."""
KINDS = ("straggler", "exhaust", "crash")

GROWN = ("alpha", "beta", "gamma")
