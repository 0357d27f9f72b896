"""The port's copy of the fleet planes (``core/cluster``: performance
model, cluster scheduler, placement policies and catalog, the closed-loop
harness) against the JAX package's, on the seeds and fixtures of the
reference's own tests (``tests/test_cluster.py``,
``tests/test_placement.py``): model values, placements, scheduler
counters and every epoch report must be equal (no tolerance; the solver's
wall time is the one field left out).  Also the port's ``api_surface()``
against the reference's snapshot with the package name mapped.
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest

from repro.core.cluster import harness as jh
from repro.core.cluster import perfmodel as jpm
from repro.core.cluster import placement as jpl
from repro.core.cluster import scheduler as jsc
from repro.core.sim import colocation as jcol
from repro.core.sim import workload as jwl
from repro_torch.core.api import api_surface
from repro_torch.core.cluster import harness as th
from repro_torch.core.cluster import perfmodel as tpm
from repro_torch.core.cluster import placement as tpl
from repro_torch.core.cluster import scheduler as tsc
from repro_torch.core.sim import colocation as tcol
from repro_torch.core.sim import workload as twl

SNAPSHOT = Path(__file__).resolve().parent / 'api_surface.txt'
# the reference's modules, and the port's, for each side of a comparison
J = dict(pm=jpm, pl=jpl, sc=jsc, h=jh, col=jcol, wl=jwl)
T = dict(pm=tpm, pl=tpl, sc=tsc, h=th, col=tcol, wl=twl)


def plain(x):
    """A structure of builtins that compares equal across the two packages:
    dataclasses and named tuples by type name and fields, arrays as lists,
    NaN as a marker."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, {f.name: plain(getattr(x, f.name))
                                   for f in dataclasses.fields(x)})
    if isinstance(x, tuple) and hasattr(x, '_fields'):
        return (type(x).__name__, tuple(plain(v) for v in x))
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, (set, frozenset)):
        return sorted(plain(v) for v in x)
    if isinstance(x, np.ndarray):
        return plain(x.tolist())
    if isinstance(x, np.generic):
        return plain(x.item())
    if isinstance(x, float) and x != x:
        return 'nan'
    return x


def _gpu(m, busy, free_frac=0.8, horizon=100.0, pool=4096, profile=None):
    ts = np.linspace(0, horizon, 16)
    return m['pm'].GPUTelemetry(busy, ts, np.full_like(ts, free_frac * pool),
                                window=(0, horizon), source='nodesim',
                                profile=profile)


def _job(m, name, sla=0.3, m_req=1024, n_gpus=1):
    return m['sc'].OfflineJob(m['pm'].profile_workload(
        name, thrput_max=10.0, m_req=m_req, n_gpus=n_gpus), sla)


def _model_values(m):
    """Eq. 1-2 and the measured-curve profile on the reference tests'
    inputs."""
    pm = m['pm']
    w = pm.profile_workload('w', thrput_max=100.0, m_req=2048)
    deficit = pm.profile_workload('w', thrput_max=100.0, m_req=4000)
    mp = pm.profile_workload('mp', thrput_max=100.0, m_req=1024, n_gpus=2)
    g = _gpu(m, [(0, 50.0)], free_frac=0.9)
    win = (0.0, 100.0)
    return [
        pm.p_compute(_gpu(m, [(0, 25.0), (50.0, 75.0)])),
        [pm.p_memory(w, _gpu(m, [], free_frac=f)) for f in (0.2, 0.5, 0.9)],
        [pm.p_memory(deficit, _gpu(m, [], free_frac=f)) for f in (0.5, 1.0)],
        [pm.p_multi([_gpu(m, a), _gpu(m, b)]) for a, b in (
            ([(0, 10.0), (20.0, 30.0)], [(0, 10.0), (20.0, 30.0)]),
            ([(0, 10.0)], [(10.0, 20.0)]), ([(0, 10.0)], [(5.0, 15.0)]),
            ([], []))],
        [pm.admissible(mp, [_gpu(m, [(0, 10.0)]), _gpu(m, b)])
         for b in ([(40.0, 50.0)], [(0, 10.0)])],
        pm.predict_normalized_throughput(w, [g]),
        pm.predict_normalized_throughput(
            w, [_gpu(m, [], profile=m['pl'].GPU_CATALOG['T4'])]),
        pm.profile_workload_from_curve('w', [100, 200, 400, 800, 1600],
                                       [50, 120, 190, 200, 198],
                                       sat_frac=0.95),
        [pm._union_intersection(a, b, win) for a, b in (
            ([], []), ([(10.0, 20.0)], []), ([(0.0, 5.0)], [(5.0, 10.0)]),
            ([(0.0, 10.0)], [(2.0, 4.0)]),
            ([(1.0, 3.0), (7.0, 9.0)], [(1.0, 3.0), (7.0, 9.0)]),
            ([(-5.0, 10.0)], [(5.0, 200.0)]))],
    ]


def test_performance_model_matches_reference():
    assert plain(_model_values(T)) == plain(_model_values(J))


def _catalog_values(m):
    pl, col = m['pl'], m['col']
    base = col.SimConfig(total_pages=1024)
    topo = pl.TopologyModel(rack_of={'a': 0, 'b': 0, 'c': 1},
                            intra_link_of={'a': 'nvlink', 'b': 'pcie'})
    pair_topo = pl.TopologyModel(rack_of={'a': 0, 'b': 1, 'c': 0})
    names = [f'node{i}' for i in range(8)]
    return [
        {k: g.scale_sim(base) for k, g in pl.GPU_CATALOG.items()},
        [(topo.link_tier(x, y), topo.link_cost(x, y))
         for x in 'abc' for y in 'abc'],
        [topo.intra_efficiency(x) for x in 'abc'],
        [pair_topo.cheapest_pair(s, d) for s, d in (
            (['a'], ['b', 'c']), (['a'], ['a']), (['a'], ['a', 'b']))],
        pl.make_fleet_profiles(names, 2, seed=5, nodes_per_rack=4),
        pl.make_fleet_profiles(names[:4], 2, seed=5, nodes_per_rack=4),
        pl.make_fleet_profiles(names, 2, mix=(('A100', 0.5), ('L4', 0.3),
                                              ('T4', 0.2)), seed=1),
        sorted(pl.PLACEMENT_POLICIES),
    ]


def test_placement_catalog_and_topology_match_reference():
    assert plain(_catalog_values(T)) == plain(_catalog_values(J))


def _placed(s):
    return {k: (p.node, p.gpu_indices, p.predicted)
            for k, p in s.placements.items()}


def _conflict(m):
    nodes = [m['pm'].NodeTelemetry('idle', [_gpu(m, [(0, 10.0)],
                                                  free_frac=0.9)]),
             m['pm'].NodeTelemetry('tight', [_gpu(m, [(0, 20.0)],
                                                   free_frac=0.125)])]
    jobs = [_job(m, 'a', sla=0.3, m_req=256), _job(m, 'b', sla=0.5,
                                                   m_req=2048),
            _job(m, 'c', sla=0.2, m_req=512), _job(m, 'd', sla=0.2)]
    return nodes, jobs


def _random_fleet(m, trial):
    rng = np.random.default_rng(trial)
    nodes = [m['pm'].NodeTelemetry(f'n{i}', [
        _gpu(m, [(0.0, float(rng.uniform(5, 60)))],
             free_frac=float(rng.uniform(0.2, 0.9))) for _ in range(2)])
        for i in range(4)]
    jobs = [_job(m, f'j{k}', sla=float(rng.uniform(0.1, 0.4)),
                 m_req=float(rng.choice([256, 1024, 3000])))
            for k in range(5)]
    jobs.append(_job(m, 'pair', n_gpus=2))
    return nodes, jobs


def _schedule(m, fixture, policy):
    nodes, jobs = fixture(m)
    s = m['sc'].ClusterScheduler(nodes, policy=policy)
    s.place_all(jobs)
    first = _placed(s)
    # three violating reports (the default patience) evict the first job;
    # its retry avoids the node
    victim = sorted(s.placements)[0] if s.placements else None
    if victim is not None:
        for _ in range(3):
            s.report_throughput(victim, 0.0)
    retried = [(p.job.job_id, p.node) for p in s.retry_pending()]
    report = getattr(s.policy, 'last_report', None)
    return [first, retried, _placed(s), s.evictions, s.reschedules,
            s.utilization_gain(), s.gpus_saved(),
            [j.job_id for j in s.pending],
            None if report is None else
            {f.name: getattr(report, f.name)
             for f in dataclasses.fields(report) if f.name != 'wall_time_s'}]


@pytest.mark.parametrize('policy', ['greedy-eq1', 'global-opt'])
@pytest.mark.parametrize('fixture', ['conflict', 'random0', 'random1',
                                     'random2'])
def test_scheduler_matches_reference(fixture, policy):
    """Placements, evictions, retries and the objective on the
    reference's conflict fixture and its random fleets."""
    fix = (_conflict if fixture == 'conflict'
           else lambda m: _random_fleet(m, int(fixture[-1])))
    got, want = _schedule(T, fix, policy), _schedule(J, fix, policy)
    assert plain(got) == plain(want)
    assert got[0], 'nothing placed'


def test_workloads_and_jobs_match_reference():
    def values(m):
        wl, h, col = m['wl'], m['h'], m['col']
        sim = col.SimConfig(total_pages=256)
        fleet = wl.make_fleet_workloads(4, 2, horizon_s=60.0, seed=1,
                                        n_ramp_nodes=1, ramp_at_s=20.0)
        return [fleet, wl.slice_trace(fleet[0].gpu_traces[0], 20.0, 40.0),
                wl.make_fleet_workloads(6, 2, horizon_s=50.0, seed=9),
                [(x.job.job_id, x.job.sla, x.job.profile, x.workload)
                 for x in h.make_harvest_jobs(6, sim, seed=4)]]
    assert plain(values(T)) == plain(values(J))


def test_measured_telemetry_and_profile_match_reference():
    def values(m):
        wl, h, col = m['wl'], m['h'], m['col']
        sim = col.SimConfig(total_pages=1024)
        trace = wl.make_online_trace(name='t', horizon_s=30.0, base_rate=0.3,
                                     burst_rate=3.0, prompt_mean=512, seed=3)
        res = col.run_online_standalone(
            wl.WorkloadPair('t', trace, wl.OfflineWorkload('idle')), sim)
        off = wl.OfflineWorkload('prof', prompt_tokens=256,
                                 output_tokens=128, max_batch=32)
        return [h.telemetry_from_sim(res, window=30.0),
                h.profile_workload_from_sim(off, sim, horizon_s=8.0,
                                            fractions=(0.1, 0.3, 0.6, 1.0))]
    assert plain(values(T)) == plain(values(J))


HARNESSES = {
    # tests/test_cluster.py: placement from measured telemetry
    'places': (dict(n_nodes=3, gpus_per_node=1, epoch_s=30.0, n_epochs=1,
                    n_ramp_nodes=0, measure_baseline=False, seed=2), 2),
    # tests/test_cluster.py: a ramping node's jobs evicted and rescheduled
    'evicts': (dict(n_nodes=4, gpus_per_node=2, epoch_s=40.0, n_epochs=4,
                    measure_baseline=False, seed=0), None),
    # the global policy on a heterogeneous fleet, interference measured
    'global_mix': (dict(n_nodes=4, gpus_per_node=2, epoch_s=40.0,
                        n_epochs=2, seed=1, placement='global-opt',
                        gpu_mix=(('A100', 0.5), ('L4', 0.3), ('T4', 0.2))),
                   None),
}


@pytest.mark.parametrize('case', sorted(HARNESSES))
def test_closed_loop_harness_matches_reference(case):
    """The whole closed loop -- scout, placement, colocated epochs,
    measured reports, eviction and retry -- gives the reference's epoch
    reports and final placements."""
    kw, n_jobs = HARNESSES[case]

    def run(m):
        cfg = m['h'].HarnessConfig(sim=m['col'].SimConfig(total_pages=1024),
                                   **kw)
        h = m['h'].make_harness(cfg, n_jobs=n_jobs)
        reports = h.run()
        return h, [dataclasses.replace(r, solver_wall_s=0.0)
                   for r in reports]
    (th_, got), (jh_, want) = run(T), run(J)
    assert plain(got) == plain(want)
    assert plain(_placed(th_.scheduler)) == plain(_placed(jh_.scheduler))
    assert plain(th_.scout_telemetry) == plain(jh_.scout_telemetry)
    assert all(r.max_preempt_per_request <= 1 for r in got)
    if case == 'evicts':
        assert th_.scheduler.evictions >= 1 and th_.scheduler.reschedules >= 1


def test_api_surface_matches_the_reference_snapshot():
    """The port's public control-plane API is the reference's, module for
    module, once ``repro.`` is read as ``repro_torch.``."""
    want = [line.replace('repro.', 'repro_torch.')
            for line in SNAPSHOT.read_text().splitlines()]
    assert api_surface() == want
