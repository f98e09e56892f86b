"""AoT P-Tuning core of the port (inference half)."""
