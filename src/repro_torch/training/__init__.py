"""The trainer of the port: AdamW, the microbatched train step, atomic
checkpoints, and the jax-free data pipeline and fault-tolerance copies."""
