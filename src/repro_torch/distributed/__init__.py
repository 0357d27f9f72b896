"""Multi-device serving: the logical-axis sharding rules
(:mod:`~repro_torch.distributed.sharding`) and the tensor-parallel plane
(:mod:`~repro_torch.distributed.tp`)."""
