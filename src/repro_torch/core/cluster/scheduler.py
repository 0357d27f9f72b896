"""Cluster-level offline-job scheduler (paper §6 "Scheduling").

Placement: for each submitted offline job, score every candidate GPU set
with the Eq. 1 performance model, admit on the best node whose predicted
normalized throughput meets the job's SLA (a fraction of standalone
throughput) and whose multi-GPU alignment passes the 0.95 gate.

Monitoring: achieved throughput is reported periodically; jobs that
persistently violate their SLA are evicted and rescheduled elsewhere.

Placement strategy is pluggable (``placement.policy.PlacementPolicy``):
``place``/``_score``/``_candidate_sets`` are the per-job primitives every
policy builds on; ``place_all`` and ``retry_pending`` route through the
configured policy, so the greedy path ('greedy-eq1') and the global
optimizer ('global-opt') run on identical telemetry and bookkeeping.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.cluster.perfmodel import NodeTelemetry, WorkloadProfile


@dataclass
class OfflineJob:
    profile: WorkloadProfile
    sla: float                       # required fraction of Thrput_max
    job_id: str = ''

    def __post_init__(self):
        if not self.job_id:
            self.job_id = self.profile.name


@dataclass
class Placement:
    job: OfflineJob
    node: str
    gpu_indices: Tuple[int, ...]
    predicted: float
    achieved: Optional[float] = None     # last reported normalized thrput


@dataclass
class SchedulerConfig:
    violation_patience: int = 3      # consecutive violating reports → evict
    sla_slack: float = 0.0           # admit only if predicted ≥ sla + slack


class ClusterScheduler:
    def __init__(self, nodes: Sequence[NodeTelemetry],
                 cfg: Optional[SchedulerConfig] = None, *,
                 policy='greedy-eq1', topology=None):
        # runtime import: placement builds on this module's types
        from repro_torch.core.cluster.placement.policy import (
            resolve_policy, score_candidate)
        self._score_candidate = score_candidate
        self.policy = resolve_policy(policy)
        self.topology = topology                 # placement.TopologyModel
        self.nodes: Dict[str, NodeTelemetry] = {n.name: n for n in nodes}
        self.cfg = cfg or SchedulerConfig()
        self.placements: Dict[str, Placement] = {}
        self.pending: List[OfflineJob] = []
        self._busy_gpus: Dict[str, set] = {n: set() for n in self.nodes}
        self._violations: Dict[str, int] = {}
        self._evicted_from: Dict[str, str] = {}   # job → node, one-shot avoid
        self._awaiting_reschedule: set = set()    # evicted, not yet replaced
        self.evictions = 0
        self.reschedules = 0

    # ----------------------------------------------------------- telemetry
    def update_node(self, tele: NodeTelemetry) -> None:
        """Refresh (or register) one node's telemetry — the closed-loop
        harness calls this with freshly measured traces every epoch, so
        placement and retry decisions track what nodes actually did."""
        self.nodes[tele.name] = tele
        self._busy_gpus.setdefault(tele.name, set())

    # ------------------------------------------------------------- placing
    def _candidate_sets(self, node: NodeTelemetry, k: int
                        ) -> List[Tuple[int, ...]]:
        free = [i for i in range(len(node.gpus))
                if i not in self._busy_gpus[node.name]]
        if k == 1:
            return [(i,) for i in free]
        # bounded enumeration: contiguous groups first (rack locality), then
        # a few combinations — production uses topology-aware grouping
        cands = [tuple(free[i:i + k]) for i in range(len(free) - k + 1)]
        extra = list(itertools.islice(itertools.combinations(free, k), 16))
        return list(dict.fromkeys(cands + extra))

    def _score(self, job: OfflineJob, node: NodeTelemetry,
               gpus: Tuple[int, ...]) -> Optional[float]:
        return self._score_candidate(job, node, gpus,
                                     sla_slack=self.cfg.sla_slack,
                                     topology=self.topology)

    def place(self, job: OfflineJob,
              avoid: Optional[set] = None) -> Optional[Placement]:
        """Place on the best-scoring admissible GPU set.  ``avoid`` skips
        named nodes (a just-evicted job must not land straight back on the
        node it was violating on before fresh telemetry shows recovery)."""
        best: Optional[Placement] = None
        for node in self.nodes.values():
            if avoid and node.name in avoid:
                continue
            for gpus in self._candidate_sets(node, job.profile.n_gpus):
                score = self._score(job, node, gpus)
                if score is None:
                    continue
                if best is None or score > best.predicted:
                    best = Placement(job, node.name, gpus, score)
        if best is None:
            # compare by job_id: dataclass equality would compare the
            # profile's numpy arrays and raise on ambiguous truth value
            if all(j.job_id != job.job_id for j in self.pending):
                self.pending.append(job)
            return None
        self._commit(best)
        return best

    def place_all(self, jobs: Sequence[OfflineJob]) -> List[Placement]:
        """Place a submission batch through the configured policy (the
        global optimizer decides jointly; greedy falls back to per-job
        ``place`` in submission order)."""
        return self.policy.place_batch(self, jobs)

    def _commit(self, p: Placement) -> None:
        self.placements[p.job.job_id] = p
        self._busy_gpus[p.node].update(p.gpu_indices)
        self._violations[p.job.job_id] = 0

    def _release(self, job_id: str) -> Optional[Placement]:
        p = self.placements.pop(job_id, None)
        if p is not None:
            self._busy_gpus[p.node].difference_update(p.gpu_indices)
            self._violations.pop(job_id, None)
        return p

    # ------------------------------------------------------------ monitor
    def report_throughput(self, job_id: str, achieved_norm: float) -> None:
        """Periodic achieved-throughput report (normalized to standalone).
        Persistent violators are evicted for rescheduling."""
        p = self.placements.get(job_id)
        if p is None:
            return
        p.achieved = achieved_norm
        if achieved_norm + 1e-9 < p.job.sla:
            self._violations[job_id] = self._violations.get(job_id, 0) + 1
        else:
            self._violations[job_id] = 0
        if self._violations[job_id] >= self.cfg.violation_patience:
            self._release(job_id)
            self.evictions += 1
            self._evicted_from[job_id] = p.node
            self._awaiting_reschedule.add(job_id)
            self.pending.append(p.job)

    def retry_pending(self) -> List[Placement]:
        """Re-attempt pending jobs through the configured policy (called
        after telemetry refresh) — eviction/reschedule consults the same
        optimizer as submission.  Evicted jobs avoid the node they violated
        on for this one retry; the avoid is consumed whether or not
        placement succeeds — holding it forever would starve a job whose
        only viable node is the (possibly recovered) one it was evicted
        from."""
        todo, self.pending = self.pending, []
        avoid = {}
        for job in todo:
            bad_node = self._evicted_from.pop(job.job_id, None)
            if bad_node is not None:
                avoid[job.job_id] = {bad_node}
        placed = self.policy.place_batch(self, todo, avoid=avoid)
        for p in placed:
            if p.job.job_id in self._awaiting_reschedule:
                self._awaiting_reschedule.discard(p.job.job_id)
                self.reschedules += 1
        return placed

    # ------------------------------------------------------------- stats
    def _norm_thrput(self, p: Placement, measured: bool) -> float:
        if measured and p.achieved is not None:
            return p.achieved
        return p.predicted

    def utilization_gain(self, measured: bool = False) -> float:
        """Fraction of cluster GPU-time given to offline work — the paper's
        "improved GPU utilization" metric.  ``measured=True`` uses the last
        reported achieved throughput instead of the Eq. 1 prediction (the
        closed-loop harness reports sim-measured values)."""
        total = sum(len(n.gpus) for n in self.nodes.values())
        gained = sum(self._norm_thrput(p, measured) * p.job.profile.n_gpus
                     for p in self.placements.values())
        return gained / max(total, 1)

    def gpus_saved(self, measured: bool = False) -> float:
        """Σ offline throughput normalized by standalone — each unit is one
        GPU's worth of offline work done on harvested capacity."""
        return sum(self._norm_thrput(p, measured) * p.job.profile.n_gpus
                   for p in self.placements.values())
