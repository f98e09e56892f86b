"""Distribution of the port: logical axes, rules and placements on a
``DeviceMesh``."""
