"""Serving of the port: engine, paged KV pool, scheduler, sampling."""
