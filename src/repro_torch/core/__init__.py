"""Valve control plane: a copy of the reference package's jax-free core."""
