"""Fleet placement plane: heterogeneous GPU catalog, interconnect topology,
and pluggable placement policies over the §6 Eq. 1 performance model.

The greedy per-job path (``ClusterScheduler.place``) is registered as the
``greedy-eq1`` baseline; ``global-opt`` solves the whole batch jointly —
pruned (job × node × GPU-set) candidates, a greedy warm start, a min-cost
assignment core for the single-GPU jobs, and deterministic local-search
improvement — the Helix (ASPLOS'25) layout-synthesis recipe applied to
harvested-capacity placement.  Both policies consume identical measured
telemetry (``GPUTelemetry.source == 'nodesim'``).
"""
from repro_torch.core.cluster.placement.profiles import (      # noqa: F401
    GPU_CATALOG, GPUProfile, TopologyModel, make_fleet_profiles)
from repro_torch.core.cluster.placement.policy import (        # noqa: F401
    PLACEMENT_POLICIES, GreedyEq1Policy, PlacementPolicy, register_policy,
    resolve_policy, score_candidate)
from repro_torch.core.cluster.placement.globalopt import (     # noqa: F401
    GlobalOptConfig, GlobalPlacementPolicy, SolveReport)
