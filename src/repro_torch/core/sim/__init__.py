"""The colocation simulator: a copy of the reference package's jax-free
``core/sim`` (workload, strategies, colocation) over the port's copies of
the runtime planes."""
