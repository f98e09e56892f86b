"""Enum fixture, clean: matches its manifest pins exactly (KINDS) and by
prefix after an append (GROWN is allowed to grow when the manifest grew
with it)."""
KINDS = ("exhaust", "straggler", "crash")

GROWN = ("alpha", "beta")
