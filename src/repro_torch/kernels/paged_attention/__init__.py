"""Paged decode attention (stock and prefix-shared)."""
