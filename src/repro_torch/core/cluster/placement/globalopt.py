"""Global placement optimizer: joint assignment over (job × node × GPU-set).

The Helix layout-synthesis recipe (SNIPPETS.md) applied to harvested
capacity: admissibility pruning cuts the candidate space (top-k per job by
Eq. 1 score), a greedy warm start seeds the solution, a min-cost assignment
solve (``scipy.optimize.linear_sum_assignment``, gated — skipped if scipy
is absent) rearranges the single-GPU jobs optimally against the slots the
multi-GPU warm start left free, and deterministic local search
(upgrade / eject-relocate / displace) improves across GPU-set sizes.
Every move strictly increases the objective Σ score·n_gpus — exactly the
numerator of ``ClusterScheduler.utilization_gain`` — so the final solution
is ≥ the warm start by construction, and the greedy baseline can only be
matched or beaten on the predicted objective.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

try:
    from scipy.optimize import linear_sum_assignment
except ImportError:                                    # pragma: no cover
    linear_sum_assignment = None

from repro_torch.core.cluster.scheduler import Placement
from repro_torch.core.cluster.placement.policy import (
    PlacementPolicy, register_policy)

Cand = Tuple[float, str, Tuple[int, ...]]              # (score, node, gpus)


@dataclass
class GlobalOptConfig:
    """Pruning / effort knobs (the Helix ``ilp_args`` analog)."""
    max_candidates_per_job: int = 24   # top-k candidates kept per job
    score_floor: float = 0.0           # drop candidates scoring below this
    max_rounds: int = 8                # local-search improvement rounds
    use_assignment: bool = True        # scipy LSA core for single-GPU jobs


@dataclass
class SolveReport:
    jobs: int
    candidates: int                    # admissible candidates generated
    pruned: int                        # dropped by the top-k cut
    warm_start_value: float            # Σ score·n_gpus after greedy seed
    value: float                       # final objective (≥ warm start)
    placed: int
    rounds: int                        # local-search rounds used
    wall_time_s: float
    method: str


@register_policy
class GlobalPlacementPolicy(PlacementPolicy):
    name = 'global-opt'

    def __init__(self, cfg: Optional[GlobalOptConfig] = None):
        self.cfg = cfg or GlobalOptConfig()
        self.reports: List[SolveReport] = []

    @property
    def last_report(self) -> Optional[SolveReport]:
        return self.reports[-1] if self.reports else None

    # ------------------------------------------------------------------
    def place_batch(self, sched, jobs, avoid=None):
        t_start = time.perf_counter()
        cfg = self.cfg
        job_by_id = {j.job_id: j for j in jobs}

        # 1. pruned candidate generation (same scoring path as greedy)
        per_job: Dict[str, List[Cand]] = {}
        n_cands = n_pruned = 0
        for job in jobs:
            bad = (avoid or {}).get(job.job_id) or set()
            cl: List[Cand] = []
            for node in sched.nodes.values():
                if node.name in bad:
                    continue
                for gpus in sched._candidate_sets(node, job.profile.n_gpus):
                    s = sched._score(job, node, gpus)
                    if s is None or s < cfg.score_floor:
                        continue
                    cl.append((s, node.name, gpus))
            cl.sort(key=lambda c: (-c[0], c[1], c[2]))
            n_cands += len(cl)
            n_pruned += max(0, len(cl) - cfg.max_candidates_per_job)
            per_job[job.job_id] = cl[:cfg.max_candidates_per_job]

        assign: Dict[str, Cand] = {}
        taken: Dict[Tuple[str, int], str] = {}

        def wt(jid: str, cand: Cand) -> float:
            return cand[0] * job_by_id[jid].profile.n_gpus

        def conflicts(cand: Cand, jid: str) -> Set[str]:
            return {taken[(cand[1], g)] for g in cand[2]
                    if (cand[1], g) in taken and taken[(cand[1], g)] != jid}

        def unassign(jid: str) -> None:
            old = assign.pop(jid, None)
            if old is not None:
                for g in old[2]:
                    taken.pop((old[1], g), None)

        def do_assign(jid: str, cand: Cand) -> None:
            unassign(jid)
            assign[jid] = cand
            for g in cand[2]:
                taken[(cand[1], g)] = jid

        def value() -> float:
            return sum(wt(j, c) for j, c in assign.items())

        # 2. greedy warm start: heaviest (job, candidate) first
        flat = [(wt(jid, c), jid, c)
                for jid, cl in per_job.items() for c in cl]
        flat.sort(key=lambda x: (-x[0], x[1], x[2][1], x[2][2]))
        for _, jid, cand in flat:
            if jid not in assign and not conflicts(cand, jid):
                do_assign(jid, cand)
        # second seed: the EXACT greedy-eq1 baseline decision, obtained by
        # running the scheduler's own place path and rolling it back
        # (pruning to top-k can starve late jobs that full-scan greedy
        # would still place).  Keeping the better of the two seeds — and
        # only ever improving from there — guarantees the optimizer never
        # scores below the greedy baseline on identical telemetry.
        pend0 = list(sched.pending)
        greedy_placed = []
        for job in jobs:
            p = sched.place(job, avoid=(avoid or {}).get(job.job_id))
            if p is not None:
                greedy_placed.append(p)
        for p in greedy_placed:
            sched._release(p.job.job_id)
        sched.pending[:] = pend0
        greedy_value = sum(p.predicted * p.job.profile.n_gpus
                           for p in greedy_placed)
        if greedy_value > value():
            for jid in list(assign):
                unassign(jid)
            for p in greedy_placed:
                cand = (p.predicted, p.node, p.gpu_indices)
                if cand not in per_job[p.job.job_id]:
                    # below the top-k cut: append so local search can
                    # still move off it (scores ≤ every kept candidate,
                    # so the sorted-prefix early-exit stays valid)
                    per_job[p.job.job_id].append(cand)
                do_assign(p.job.job_id, cand)
        warm_value = value()

        # 3. assignment core: re-solve the single-GPU jobs optimally over
        # the slots the multi-GPU assignments left free
        method = 'warm'
        if cfg.use_assignment and linear_sum_assignment is not None:
            method += '+lsa'
            self._refine_singles(per_job, job_by_id, assign, taken,
                                 conflicts, unassign, do_assign)

        # 4. deterministic local search across GPU-set sizes
        rounds = self._local_search(per_job, job_by_id, assign,
                                    conflicts, unassign, do_assign, wt)
        method += '+ls'

        # 5. commit (scheduler bookkeeping identical to the greedy path)
        placed: List[Placement] = []
        for job in jobs:
            cand = assign.get(job.job_id)
            if cand is None:
                if all(j.job_id != job.job_id for j in sched.pending):
                    sched.pending.append(job)
                continue
            p = Placement(job, cand[1], cand[2], cand[0])
            sched._commit(p)
            placed.append(p)

        self.reports.append(SolveReport(
            jobs=len(jobs), candidates=n_cands, pruned=n_pruned,
            warm_start_value=warm_value, value=value(), placed=len(placed),
            rounds=rounds, wall_time_s=time.perf_counter() - t_start,
            method=method))
        return placed

    # ------------------------------------------------------------------
    def _refine_singles(self, per_job, job_by_id, assign, taken,
                        conflicts, unassign, do_assign) -> None:
        """Hungarian solve of single-GPU jobs × free single-GPU slots;
        adopted only if it beats the warm start's single-GPU portion."""
        singles = sorted(jid for jid, cl in per_job.items()
                         if cl and job_by_id[jid].profile.n_gpus == 1)
        multi_taken = {k for k, jid in taken.items()
                       if job_by_id[jid].profile.n_gpus > 1}
        slots = sorted({(c[1], c[2][0]) for jid in singles
                        for c in per_job[jid]} - multi_taken)
        if not singles or not slots:
            return
        mat = np.full((len(singles), len(slots)), -1.0)
        slot_idx = {s: k for k, s in enumerate(slots)}
        by_slot: Dict[Tuple[str, Tuple[str, int]], Cand] = {}
        for r, jid in enumerate(singles):
            for c in per_job[jid]:
                k = slot_idx.get((c[1], c[2][0]))
                if k is not None:
                    mat[r, k] = c[0]
                    by_slot[(jid, (c[1], c[2][0]))] = c
        rows, cols = linear_sum_assignment(mat, maximize=True)
        new: Dict[str, Cand] = {}
        for r, k in zip(rows, cols):
            if mat[r, k] > 0:          # admissible scores are > 0 (SLA > 0)
                new[singles[r]] = by_slot[(singles[r], slots[k])]
        lsa_value = sum(c[0] for c in new.values())
        old_value = sum(assign[j][0] for j in singles if j in assign)
        if lsa_value > old_value + 1e-12:
            for jid in singles:
                unassign(jid)
            for jid, cand in new.items():
                do_assign(jid, cand)

    # ------------------------------------------------------------------
    def _local_search(self, per_job, job_by_id, assign,
                      conflicts, unassign, do_assign, wt) -> int:
        """First-improvement moves, deterministic order, objective strictly
        increasing: upgrade (better free candidate), eject-relocate (bump a
        blocker to its best alternative), displace (replace a lighter
        blocker outright)."""
        rounds = 0
        improved = True
        while improved and rounds < self.cfg.max_rounds:
            improved = False
            rounds += 1
            # upgrade: move any job to a strictly better conflict-free slot
            for jid in sorted(per_job):
                cur = assign.get(jid)
                cur_w = wt(jid, cur) if cur is not None else 0.0
                for cand in per_job[jid]:
                    w = wt(jid, cand)
                    if w <= cur_w + 1e-12:
                        break                  # sorted: no better left
                    if not conflicts(cand, jid):
                        do_assign(jid, cand)
                        improved = True
                        break
            # eject-relocate / displace for still-unplaced jobs
            for jid in sorted(per_job):
                if jid in assign:
                    continue
                for cand in per_job[jid]:
                    blockers = conflicts(cand, jid)
                    if len(blockers) != 1:
                        continue
                    b = next(iter(blockers))
                    gain = wt(jid, cand)
                    b_w = wt(b, assign[b])
                    alt = next(
                        (a for a in per_job[b]
                         if not (a[1] == cand[1] and set(a[2]) & set(cand[2]))
                         and not conflicts(a, b)), None)
                    if alt is not None and gain + wt(b, alt) > b_w + 1e-12:
                        do_assign(b, alt)      # relocate the blocker…
                        do_assign(jid, cand)   # …and take its slot
                        improved = True
                        break
                    if alt is None and gain > b_w + 1e-12:
                        unassign(b)            # displace outright
                        do_assign(jid, cand)
                        improved = True
                        break
        return rounds
