"""The fleet planes: a copy of the reference package's jax-free
``core/cluster`` (performance model, cluster scheduler, placement, and the
harness that runs a fleet of colocation simulators)."""
