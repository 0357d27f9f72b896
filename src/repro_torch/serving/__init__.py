"""Serving plane: KV pool, batch scheduler, sampler and engine."""
