"""Transformer model of the port: layers and the serving model."""
