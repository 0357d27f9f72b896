"""Placement-policy strategy interface over the cluster scheduler.

A policy decides *where a batch of jobs goes*; the scheduler owns the
bookkeeping (busy GPUs, pending queue, eviction counters).  Both registered
policies score candidates through the same :func:`score_candidate` — the
Eq. 1 model plus the heterogeneity scalar and the topology lockstep factor
— so swapping policies never changes which telemetry fields are consumed
(asserted in tests/test_placement.py with an access-recording telemetry
proxy).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple, Type

from repro_torch.core.cluster.perfmodel import (
    NodeTelemetry, admissible, predict_normalized_throughput)
from repro_torch.core.cluster.scheduler import OfflineJob, Placement


def score_candidate(job: OfflineJob, node: NodeTelemetry,
                    gpu_indices: Tuple[int, ...], *, sla_slack: float = 0.0,
                    topology=None) -> Optional[float]:
    """Admissibility-gated Eq. 1 score of one (job, node, GPU-set)
    candidate; ``None`` = inadmissible or below the job's SLA.  The single
    scoring path every placement policy goes through."""
    gset = [node.gpus[i] for i in gpu_indices]
    if not admissible(job.profile, gset):
        return None
    pred = predict_normalized_throughput(job.profile, gset)
    if len(gset) > 1 and topology is not None:
        pred *= topology.intra_efficiency(node.name)
    if pred < job.sla + sla_slack:
        return None
    return pred


class PlacementPolicy:
    """Strategy interface: place a batch of jobs on a scheduler's fleet.

    Implementations must leave the scheduler consistent: commit successful
    placements (``sched._commit``) and queue failures (``sched.pending``).
    ``avoid`` maps job_id → node names that job must skip this round (the
    evicted-job one-shot avoid-list).
    """
    name = 'base'

    def place_batch(self, sched, jobs: Sequence[OfflineJob],
                    avoid: Optional[Dict[str, Set[str]]] = None
                    ) -> List[Placement]:
        raise NotImplementedError


PLACEMENT_POLICIES: Dict[str, Type[PlacementPolicy]] = {}


def register_policy(cls: Type[PlacementPolicy]) -> Type[PlacementPolicy]:
    PLACEMENT_POLICIES[cls.name] = cls
    return cls


def resolve_policy(policy) -> PlacementPolicy:
    """Accept a registered name, a policy class, or an instance."""
    if isinstance(policy, PlacementPolicy):
        return policy
    if isinstance(policy, type) and issubclass(policy, PlacementPolicy):
        return policy()
    return PLACEMENT_POLICIES[policy]()


@register_policy
class GreedyEq1Policy(PlacementPolicy):
    """The original per-job greedy path: each job independently takes the
    best-scoring admissible GPU set at submission time (first-come
    first-served over the shared free-GPU pool)."""
    name = 'greedy-eq1'

    def place_batch(self, sched, jobs, avoid=None):
        placed = []
        for job in jobs:
            bad = (avoid or {}).get(job.job_id)
            p = sched.place(job, avoid=bad)
            if p is not None:
                placed.append(p)
        return placed
