"""Closed-loop cluster simulation harness — the §6 scheduler driven by
measured NodeSim telemetry (the repo's first end-to-end take on the paper's
top-line claim).

Before this harness, the ``ClusterScheduler`` scored placements against
hand-written synthetic telemetry and never saw what a colocated node
actually does.  Here the loop is closed:

1. **scout** — every GPU of every node runs one online-only ``NodeSim``
   epoch; its measured busy intervals and free-memory trace become the
   ``NodeTelemetry`` the Eq. 1 model scores (``source='nodesim'``, never
   hand-written).  Per-epoch runtime counters (preemptions, reclamations)
   are read from each sim's :class:`~repro.core.telemetry.TelemetryRegistry`
   — the fold over the typed event stream of :mod:`repro.core.events` —
   so the harness observes the same ordered facts as the live node;
2. **profile** — each offline workload's memory→throughput curve is
   measured by sweeping ``NodeSim`` at different pool sizes
   (:func:`profile_workload_from_sim`), not synthesized;
3. **place** — the scheduler places jobs with the Eq. 1 model over the
   measured telemetry;
4. **run an epoch** — every GPU runs a real colocated ``NodeSim`` over its
   epoch slice of the online trace, with the placed job's offline workload;
5. **report** — each job's achieved normalized throughput (actual offline
   tokens / measured standalone max) goes to ``report_throughput``;
   persistent SLA violators are evicted;
6. **refresh + retry** — node telemetry is replaced with this epoch's
   measurements and pending (incl. evicted) jobs are rescheduled.

Epoch after epoch, admission, monitoring, eviction and ``retry_pending``
all operate on *simulated-measured* data.  Non-stationary nodes (quiet when
scouted, hot afterwards — ``make_fleet_workloads``'s ramp nodes) exercise
the eviction/reschedule path the paper's production story depends on.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cluster.perfmodel import (
    GPUTelemetry, NodeTelemetry, WorkloadProfile, profile_workload_from_curve)
from repro_torch.core.cluster.placement.profiles import (
    GPUProfile, TopologyModel, make_fleet_profiles)
from repro_torch.core.cluster.scheduler import (
    ClusterScheduler, OfflineJob, Placement, SchedulerConfig)
from repro_torch.core.sim.colocation import (
    NodeSim, SimConfig, SimResult, run_offline_standalone,
    run_online_standalone)
from repro_torch.core.sim import strategies as S
from repro_torch.core.sim.strategies import OurMem
from repro_torch.core.sim.workload import (
    NodeWorkload, OfflineWorkload, OnlineWorkload, WorkloadPair,
    make_fleet_workloads, slice_trace)


# ---------------------------------------------------------------------------
# SimResult → perf-model telemetry
# ---------------------------------------------------------------------------

def telemetry_from_sim(res: SimResult, *,
                       window: Optional[float] = None) -> GPUTelemetry:
    """Extract the Eq. 1 inputs from a finished ``NodeSim`` run: measured
    online-busy intervals (P_compute, P_multi) and the measured
    not-held-by-online memory trace (P_memory)."""
    t1 = float(window if window is not None else res.horizon)
    return GPUTelemetry(list(res.busy_intervals),
                        np.asarray(res.mem_trace_t, dtype=float),
                        np.asarray(res.mem_trace_free, dtype=float),
                        window=(0.0, t1), source='nodesim')


def profile_workload_from_sim(off: OfflineWorkload, sim_cfg: SimConfig, *,
                              name: Optional[str] = None, n_gpus: int = 1,
                              fractions: Sequence[float] = (
                                  0.1, 0.2, 0.35, 0.55, 0.8, 1.0),
                              horizon_s: float = 15.0) -> WorkloadProfile:
    """Measure a workload's memory→throughput curve by running the offline
    engine standalone in ``NodeSim`` at swept pool sizes (the profiling run
    the paper performs once at job submission)."""
    mems, thrs = [], []
    for f in fractions:
        pages = max(int(sim_cfg.total_pages * f), 32)
        sub = replace(sim_cfg, total_pages=pages)
        pair = WorkloadPair(off.name, OnlineWorkload('empty', [], horizon_s),
                            off)
        res = run_offline_standalone(pair, sub)
        mems.append(float(pages))
        thrs.append(res.offline_throughput)
    return profile_workload_from_curve(name or off.name, mems, thrs,
                                       n_gpus=n_gpus)


# ---------------------------------------------------------------------------
# Jobs
# ---------------------------------------------------------------------------

@dataclass
class HarvestJob:
    """A schedulable offline job plus the actual workload its NodeSim runs
    (the scheduler sees only the profile; the harness runs the real thing)."""
    job: OfflineJob
    workload: OfflineWorkload


def make_harvest_jobs(n_jobs: int, sim_cfg: SimConfig, *, seed: int = 0,
                      gpus_per_node: int = 2,
                      multi_gpu_every: int = 4,
                      sla_range: Tuple[float, float] = (0.2, 0.35)
                      ) -> List[HarvestJob]:
    """A mix of single- and multi-GPU offline jobs over a few workload
    archetypes, each profiled from the sim (profiles cached per archetype —
    profiling is the expensive once-per-submission step).

    Seeding is isolated per job (``SeedSequence.spawn``): job *j*'s SLA
    depends only on ``(seed, j)``, so growing ``n_jobs`` never re-rolls
    existing jobs and a large submission batch is byte-reproducible."""
    children = np.random.SeedSequence(seed).spawn(max(n_jobs, 1))
    archetypes = [
        OfflineWorkload('arch-small', prompt_tokens=256, output_tokens=128,
                        max_batch=32),
        OfflineWorkload('arch-med', prompt_tokens=512, output_tokens=256,
                        max_batch=48),
        OfflineWorkload('arch-mixed', prompt_tokens=512, output_tokens=256,
                        max_batch=48, prompt_choices=(256, 512, 1024),
                        output_choices=(128, 256)),
        # HyGen-style dominant harvest shape: one system prompt shared by
        # the whole batch — exercises the memory plane's prefix sharing
        # and keeps the partial-invalidation surviving prefixes long
        OfflineWorkload('arch-prefix', prompt_tokens=512, output_tokens=192,
                        max_batch=48, shared_prefix_tokens=256),
    ]
    prof_cache: Dict[str, WorkloadProfile] = {}
    jobs: List[HarvestJob] = []
    for j in range(n_jobs):
        arch = archetypes[j % len(archetypes)]
        if arch.name not in prof_cache:
            prof_cache[arch.name] = profile_workload_from_sim(arch, sim_cfg)
        base = prof_cache[arch.name]
        n_gpus = gpus_per_node if (multi_gpu_every
                                   and j % multi_gpu_every == multi_gpu_every - 1) else 1
        prof = WorkloadProfile(f'job{j}', base.mem_points, base.thrput_points,
                               base.m_req, base.mac, n_gpus)
        sla = float(np.random.default_rng(children[j]).uniform(*sla_range))
        jobs.append(HarvestJob(OfflineJob(prof, sla, job_id=f'job{j}'), arch))
    return jobs


# ---------------------------------------------------------------------------
# The harness
# ---------------------------------------------------------------------------

@dataclass
class HarnessConfig:
    n_nodes: int = 8
    gpus_per_node: int = 2
    epoch_s: float = 60.0
    n_epochs: int = 4                 # colocated epochs after the scout
    seed: int = 0
    # strategy under test (run_strategy-compatible names)
    compute: str = 'Channel'
    memory: str = 'OurMem'
    eviction_policy: str = 'valve'
    sim: SimConfig = field(default_factory=lambda: SimConfig(
        total_pages=1024))
    sched: SchedulerConfig = field(default_factory=lambda: SchedulerConfig(
        violation_patience=2))
    # non-stationary fleet knobs (see make_fleet_workloads)
    n_ramp_nodes: int = 1
    ramp_mult: float = 60.0
    aligned_frac: float = 0.68
    # placement plane: policy name ('greedy-eq1' | 'global-opt' | any
    # registered PlacementPolicy) and an optional heterogeneous GPU mix
    # (catalog-name → weight, see placement.profiles.make_fleet_profiles);
    # None = homogeneous reference-GPU fleet, no topology model
    placement: str = 'greedy-eq1'
    gpu_mix: Optional[Tuple[Tuple[str, float], ...]] = None
    nodes_per_rack: int = 16
    # also run each colocated epoch slice online-standalone for TTFT/TPOT
    # interference deltas (doubles the sim count)
    measure_baseline: bool = True


@dataclass
class EpochReport:
    epoch: int
    placements: int
    pending: int
    evictions_total: int
    reschedules_total: int
    utilization_gain_measured: float
    gpus_saved_measured: float
    achieved: Dict[str, float] = field(default_factory=dict)
    predicted: Dict[str, float] = field(default_factory=dict)
    offline_tokens: float = 0.0
    recompute_tokens: float = 0.0     # Algorithm-1 vs FIFO victim cost
    compute_preemptions: int = 0
    reclamations: int = 0
    max_preempt_per_request: int = 0  # paper invariant: ≤ 1 (any GPU, epoch)
    solver_wall_s: float = 0.0        # placement-policy solve time (retry)
    ttft_delta: Optional[float] = None    # mean relative vs standalone
    tpot_delta: Optional[float] = None


class ClusterHarness:
    """Epoch-driven closed loop over a fleet of NodeSim-backed nodes."""

    def __init__(self, fleet: List[NodeWorkload], jobs: List[HarvestJob],
                 cfg: Optional[HarnessConfig] = None, *,
                 profiles: Optional[Dict[str, Tuple[GPUProfile, ...]]] = None,
                 topology: Optional[TopologyModel] = None):
        self.cfg = cfg or HarnessConfig()
        self.fleet = fleet
        self.jobs = jobs
        self.profiles = profiles        # node → per-GPU catalog entries
        self.topology = topology
        self._workload_of = {h.job.job_id: h.workload for h in jobs}
        self._thrput_max = {h.job.job_id: h.job.profile.thrput_max
                            for h in jobs}
        self.scheduler: Optional[ClusterScheduler] = None
        self.reports: List[EpochReport] = []
        self.scout_telemetry: Dict[str, NodeTelemetry] = {}

    # ------------------------------------------------------------ plumbing
    def _gpu_sim(self, node: str, gi: int) -> SimConfig:
        """The sim config this GPU actually runs: the base config scaled by
        its catalog profile (heterogeneous fleets), or the base as-is."""
        if self.profiles is None:
            return self.cfg.sim
        return self.profiles[node][gi].scale_sim(self.cfg.sim)

    def _gpu_profile(self, node: str, gi: int) -> Optional[GPUProfile]:
        return self.profiles[node][gi] if self.profiles is not None else None

    def _rack_of(self, node: str) -> int:
        return self.topology.rack_of.get(node, 0) if self.topology else 0

    def _mem_policy(self, sim_cfg: SimConfig):
        c = self.cfg
        if c.memory == 'OurMem':
            return OurMem(sim_cfg.total_pages, sim_cfg.page_tokens,
                          policy=c.eviction_policy)
        return S.MEMORY_POLICIES[c.memory](sim_cfg.total_pages,
                                           sim_cfg.page_tokens)

    def _run_gpu_epoch(self, trace: OnlineWorkload,
                       off: Optional[OfflineWorkload],
                       sim_cfg: SimConfig) -> SimResult:
        pair = WorkloadPair(trace.name, trace,
                            off or OfflineWorkload('idle'))
        cp = S.COMPUTE_POLICIES[self.cfg.compute]()
        sim = NodeSim(pair, cp, self._mem_policy(sim_cfg), sim_cfg,
                      offline_enabled=off is not None)
        return sim.run()

    def _job_on_gpu(self) -> Dict[Tuple[str, int], Placement]:
        out: Dict[Tuple[str, int], Placement] = {}
        for p in self.scheduler.placements.values():
            for gi in p.gpu_indices:
                out[(p.node, gi)] = p
        return out

    # ------------------------------------------------------------- phases
    def scout(self) -> ClusterScheduler:
        """Epoch 0: online-only runs measure every node's telemetry; the
        scheduler is constructed from those measurements alone."""
        c = self.cfg
        teles = []
        for node in self.fleet:
            gpus = []
            for gi, trace in enumerate(node.gpu_traces):
                sl = slice_trace(trace, 0.0, c.epoch_s)
                res = run_online_standalone(
                    WorkloadPair(sl.name, sl, OfflineWorkload('idle')),
                    self._gpu_sim(node.name, gi))
                g = telemetry_from_sim(res, window=c.epoch_s)
                g.profile = self._gpu_profile(node.name, gi)
                gpus.append(g)
            tele = NodeTelemetry(node.name, gpus,
                                 rack=self._rack_of(node.name))
            teles.append(tele)
            self.scout_telemetry[node.name] = tele
        self.scheduler = ClusterScheduler(teles, c.sched,
                                          policy=c.placement,
                                          topology=self.topology)
        return self.scheduler

    def submit_all(self) -> int:
        placed = self.scheduler.place_all([h.job for h in self.jobs])
        return len(placed)

    def run_epoch(self, epoch: int) -> EpochReport:
        """One closed-loop round: run every GPU's NodeSim over this epoch's
        trace slice (colocated where a job is placed), report measured
        achieved throughput, refresh telemetry, retry pending jobs."""
        c = self.cfg
        t0, t1 = epoch * c.epoch_s, (epoch + 1) * c.epoch_s
        on_gpu = self._job_on_gpu()
        rep = EpochReport(
            epoch=epoch, placements=len(self.scheduler.placements),
            pending=len(self.scheduler.pending),
            evictions_total=self.scheduler.evictions,
            reschedules_total=self.scheduler.reschedules,
            utilization_gain_measured=0.0, gpus_saved_measured=0.0)

        job_tokens: Dict[str, List[float]] = {}
        ttft_d, tpot_d = [], []
        new_teles = []
        for node in self.fleet:
            gpus = []
            for gi, trace in enumerate(node.gpu_traces):
                scfg = self._gpu_sim(node.name, gi)
                sl = slice_trace(trace, t0, t1)
                p = on_gpu.get((node.name, gi))
                off = self._workload_of[p.job.job_id] if p else None
                res = self._run_gpu_epoch(sl, off, scfg)
                g = telemetry_from_sim(res, window=c.epoch_s)
                g.profile = self._gpu_profile(node.name, gi)
                gpus.append(g)
                rep.offline_tokens += res.offline_tokens
                rep.recompute_tokens += res.recompute_tokens
                # counters come from the sim's TelemetryRegistry (the fold
                # over its typed event stream — the same surface the live
                # node exposes), not from per-policy stat objects
                tel = res.telemetry.counters
                rep.compute_preemptions += tel.preemptions
                rep.reclamations += tel.reclamations
                rep.max_preempt_per_request = max(
                    rep.max_preempt_per_request, res.max_preempt_per_request)
                if p is not None:
                    job_tokens.setdefault(p.job.job_id, []).append(
                        res.offline_tokens / max(res.horizon, 1e-9))
                if c.measure_baseline and sl.requests:
                    base = run_online_standalone(
                        WorkloadPair(sl.name, sl, OfflineWorkload('idle')),
                        scfg)
                    ttft_d += [(res.ttft[k] - base.ttft[k])
                               / max(base.ttft[k], 1e-9)
                               for k in base.ttft if k in res.ttft]
                    tpot_d += [(res.tpot[k] - base.tpot[k])
                               / max(base.tpot[k], 1e-9)
                               for k in base.tpot if k in res.tpot]
            new_teles.append(NodeTelemetry(node.name, gpus,
                                           rack=self._rack_of(node.name)))

        # report achieved normalized throughput (model-parallel jobs run in
        # lockstep → the slowest shard sets the job's rate)
        for job_id, rates in job_tokens.items():
            achieved = min(rates) / max(self._thrput_max[job_id], 1e-9)
            p = self.scheduler.placements.get(job_id)
            if p is not None:
                rep.achieved[job_id] = achieved
                rep.predicted[job_id] = p.predicted
            self.scheduler.report_throughput(job_id, achieved)

        rep.utilization_gain_measured = self.scheduler.utilization_gain(
            measured=True)
        rep.gpus_saved_measured = self.scheduler.gpus_saved(measured=True)

        # telemetry refresh + retry (evicted jobs avoid their old node);
        # every Eq. 1 input the policies consume must be sim-measured —
        # the provenance invariant policy swaps are asserted against
        for tele in new_teles:
            assert all(g.source == 'nodesim' for g in tele.gpus), \
                'placement must only ever see measured telemetry'
            self.scheduler.update_node(tele)
        n_reports = len(getattr(self.scheduler.policy, 'reports', []))
        self.scheduler.retry_pending()
        rep.solver_wall_s = sum(
            r.wall_time_s for r in
            getattr(self.scheduler.policy, 'reports', [])[n_reports:])

        rep.evictions_total = self.scheduler.evictions
        rep.reschedules_total = self.scheduler.reschedules
        if ttft_d:
            rep.ttft_delta = float(np.mean(ttft_d))
        if tpot_d:
            rep.tpot_delta = float(np.mean(tpot_d))
        self.reports.append(rep)
        return rep

    def run(self) -> List[EpochReport]:
        c = self.cfg
        self.scout()
        self.submit_all()
        for e in range(1, c.n_epochs + 1):
            self.run_epoch(e)
        return self.reports


def make_harness(cfg: Optional[HarnessConfig] = None,
                 n_jobs: Optional[int] = None) -> ClusterHarness:
    """Convenience: fleet + jobs + harness from one config (the benchmark
    and the CI smoke both build through here)."""
    cfg = cfg or HarnessConfig()
    horizon = cfg.epoch_s * (cfg.n_epochs + 1)
    fleet = make_fleet_workloads(
        cfg.n_nodes, cfg.gpus_per_node, horizon_s=horizon, seed=cfg.seed,
        n_ramp_nodes=cfg.n_ramp_nodes, ramp_at_s=cfg.epoch_s,
        ramp_mult=cfg.ramp_mult, aligned_frac=cfg.aligned_frac)
    if n_jobs is None:
        n_jobs = max(cfg.n_nodes * cfg.gpus_per_node // 2, 2)
    jobs = make_harvest_jobs(n_jobs, cfg.sim, seed=cfg.seed,
                             gpus_per_node=cfg.gpus_per_node)
    profiles = topo = None
    if cfg.gpu_mix is not None:
        profiles, topo = make_fleet_profiles(
            [n.name for n in fleet], cfg.gpus_per_node, mix=cfg.gpu_mix,
            nodes_per_rack=cfg.nodes_per_rack, seed=cfg.seed)
    return ClusterHarness(fleet, jobs, cfg, profiles=profiles, topology=topo)
