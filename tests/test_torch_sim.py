"""The port's copy of the colocation simulator (``core/sim``) against the
JAX package's, on the seeds and configurations of the reference's own
simulator tests (``tests/test_sim.py``, ``tests/test_sim_vectorized.py``):
every ``SimResult`` -- latencies, token counts, busy intervals, memory
traces, rejections, the typed event stream and the telemetry counters --
must be equal, field for field (the two are the same numpy code over
copied runtime planes; no tolerance).
"""
import dataclasses

import numpy as np
import pytest

from repro.core.sim import colocation as jcol
from repro.core.sim import strategies as jstr
from repro.core.sim import workload as jwl
from repro_torch.core.sim import colocation as tcol
from repro_torch.core.sim import strategies as tstr
from repro_torch.core.sim import workload as twl

COMBOS = [('Channel', 'OurMem'), ('GPreempt', 'UVM'), ('Channel', 'UVM'),
          ('Channel', 'Prism'), ('KernelPreempt', 'StaticMem')]


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
    if isinstance(x, np.ndarray):
        return plain(x.tolist())
    if isinstance(x, np.generic):
        return plain(x.item())
    if isinstance(x, float) and x != x:
        return 'nan'
    return x


def signature(res):
    """Everything observable about a run (the reference's vectorized-path
    test's signature, plus the memory and compute policies' stats)."""
    tel = None
    if res.telemetry is not None:
        t = res.telemetry.counters
        tel = {k: getattr(t, k) for k in dir(t) if not k.startswith('_')
               and isinstance(getattr(t, k), (int, float))}
    return plain(dict(
        ttft=res.ttft, tpot=res.tpot, off=res.offline_tokens,
        wasted=res.offline_tokens_wasted, rec=res.recompute_tokens,
        busy=res.busy_intervals, mt=res.mem_trace_t, mf=res.mem_trace_free,
        rej=res.rejected, mp=res.max_preempt_per_request, hz=res.horizon,
        ev=[repr(e) for e in res.events], tel=tel,
        mem=res.mem_stats, compute=res.compute_stats,
        thr=res.offline_throughput, busy_frac=res.online_busy_fraction()))


J_PAIRS = jwl.make_workload_pairs(4, horizon_s=120.0)
T_PAIRS = twl.make_workload_pairs(4, horizon_s=120.0)


def test_workload_pairs_equal():
    assert plain(T_PAIRS) == plain(J_PAIRS)
    assert plain(twl.make_online_trace(name='sp', horizon_s=120.0, seed=7)) \
        == plain(jwl.make_online_trace(name='sp', horizon_s=120.0, seed=7))


@pytest.mark.parametrize('compute,memory', COMBOS)
@pytest.mark.parametrize('i', [0, 1])
def test_strategy_matches_reference(i, compute, memory):
    """``run_strategy`` on the reference tests' pairs (``SimConfig()``)."""
    want = jcol.run_strategy(J_PAIRS[i], compute, memory, jcol.SimConfig())
    got = tcol.run_strategy(T_PAIRS[i], compute, memory, tcol.SimConfig())
    assert signature(got) == signature(want)
    if (compute, memory) == ('Channel', 'OurMem'):
        assert got.max_preempt_per_request <= 1
        assert set(got.ttft) == {q.req_id for q in T_PAIRS[i].online.requests}


@pytest.mark.parametrize('i', range(4))
def test_standalone_runs_match_reference(i):
    for run in ('run_online_standalone', 'run_offline_standalone'):
        want = getattr(jcol, run)(J_PAIRS[i], jcol.SimConfig())
        got = getattr(tcol, run)(T_PAIRS[i], tcol.SimConfig())
        assert signature(got) == signature(want), run


@pytest.mark.parametrize('policy', ['valve', 'fifo'])
def test_eviction_policies_match_reference(policy):
    want = jcol.run_strategy(J_PAIRS[0], 'Channel', 'OurMem',
                             jcol.SimConfig(), eviction_policy=policy)
    got = tcol.run_strategy(T_PAIRS[0], 'Channel', 'OurMem',
                            tcol.SimConfig(), eviction_policy=policy)
    assert signature(got) == signature(want)


def test_ourmem_pool_after_run_matches_reference():
    """The memory plane's state after a run, and its invariants."""
    cfg = jcol.SimConfig()
    jmp = jstr.OurMem(cfg.total_pages, cfg.page_tokens)
    jcol.NodeSim(J_PAIRS[0], jstr.Channel(), jmp, cfg).run()
    tmp = tstr.OurMem(cfg.total_pages, cfg.page_tokens)
    tcol.NodeSim(T_PAIRS[0], tstr.Channel(), tmp, tcol.SimConfig()).run()
    tmp.pool.check_invariants()
    assert tmp.reclaimer.stats.ordering_violations == 0
    assert plain(tmp.stats) == plain(jmp.stats)
    assert plain(tmp.reclaimer.stats) == plain(jmp.reclaimer.stats)
    for klass in ('online', 'offline'):
        assert tmp.pool.free_pages_for(klass) == \
            jmp.pool.free_pages_for(klass)


def test_oversized_request_rejected_as_the_reference():
    def run(col, stra, wl):
        cfg = col.SimConfig(total_pages=64)
        reqs = [wl.OnlineRequest('huge', 0.5, 4096, 8),
                wl.OnlineRequest('ok', 1.0, 256, 8)]
        pair = wl.WorkloadPair('rej', wl.OnlineWorkload('on', reqs, 5.0),
                               wl.OfflineWorkload('off'))
        return col.NodeSim(pair, stra.Channel(),
                           stra.Prism(cfg.total_pages, cfg.page_tokens),
                           cfg).run()
    got = run(tcol, tstr, twl)
    assert got.rejected == ['huge']
    assert signature(got) == signature(run(jcol, jstr, jwl))


def _vectorized(col):
    return dataclasses.replace(col.SimConfig(total_pages=2048),
                               vectorized=True)


@pytest.mark.parametrize('compute,memory', [('Channel', 'OurMem'),
                                            ('KernelPreempt', 'StaticMem')])
@pytest.mark.parametrize('i', range(3))
def test_vectorized_path_matches_reference(i, compute, memory):
    """The batched decode fast path on ``test_sim_vectorized.py``'s
    pairs: the port's equals the reference's, and its own scalar loop."""
    jp = jwl.make_workload_pairs(3, horizon_s=120.0)[i]
    tp = twl.make_workload_pairs(3, horizon_s=120.0)[i]
    want = jcol.run_strategy(jp, compute, memory, _vectorized(jcol))
    got = tcol.run_strategy(tp, compute, memory, _vectorized(tcol))
    scalar = tcol.run_strategy(tp, compute, memory,
                               tcol.SimConfig(total_pages=2048))
    assert signature(got) == signature(want) == signature(scalar)


def _shared_prefix_pair(wl):
    off = wl.OfflineWorkload('offmix', prompt_tokens=512, output_tokens=256,
                             max_batch=32, prompt_choices=(128, 512, 1024),
                             output_choices=(64, 256, 512),
                             shared_prefix_tokens=96)
    on = wl.make_online_trace(name='sp', horizon_s=120.0, base_rate=0.08,
                              burst_rate=4.0, seed=7)
    return wl.WorkloadPair('sp', on, off)


def _decode_heavy_pair(wl):
    off = wl.OfflineWorkload('long', prompt_tokens=256, output_tokens=2048,
                             max_batch=24)
    on = wl.make_online_trace(name='sparse', horizon_s=300.0, base_rate=0.02,
                              burst_rate=0.5, seed=11)
    return wl.WorkloadPair('dh', on, off)


@pytest.mark.parametrize('case', ['shared_prefix_channel',
                                  'shared_prefix_gpreempt', 'decode_heavy'])
def test_vectorized_hard_cases_match_reference(case):
    """Prefix-share publication with mixed sizes, and long decode bursts
    (the reference's hard cases for the fast path)."""
    def run(col, wl):
        if case == 'decode_heavy':
            cfg = dataclasses.replace(col.SimConfig(total_pages=8192),
                                      vectorized=True)
            return col.run_strategy(_decode_heavy_pair(wl), 'Channel',
                                    'OurMem', cfg)
        compute = 'Channel' if case.endswith('channel') else 'GPreempt'
        return col.run_strategy(_shared_prefix_pair(wl), compute, 'OurMem',
                                _vectorized(col))
    assert signature(run(tcol, twl)) == signature(run(jcol, jwl))
