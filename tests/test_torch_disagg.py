"""The port's disaggregated prefill/decode plane
(``repro_torch.serving.disagg``) on the CPU: the gates of
``tests/test_disagg.py`` on the port's nodes -- outputs bit-identical to a
colocated node with zero handoff recompute, a no-capacity refusal that
defers to the colocated fallback, offline backfill on both pools under the
preemption bound, cross-pool rescue of reclamation victims -- then the
port's plane against the reference's on the same virtual timeline (the
reference's weights bridged in f32, f32 KV pools on both sides), the KV
copy's rows bit-equal to their source, and ``pair_cheapest`` over a
stand-in topology.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.clock import VirtualClock
from repro_torch.core.events import PageMigration, PrefillHandoff, ReclamationEvent
from repro_torch.core.runtime import RuntimeConfig, ValveRuntime
from repro_torch.launch.node import NodeOrchestrator
from repro_torch.serving.disagg import DisaggPlane
from repro_torch.serving.engine import EngineConfig
from repro_torch.serving.kvpool import KVPool
from repro_torch.serving.scheduler import ReqState

ARCH = 'qwen3-0.6b'


def _ecfg(klass):
    return EngineConfig(max_batch=4, max_seq=48, prefill_chunk=8,
                        klass=klass)


def _prompt(vocab, n, seed):
    return np.random.default_rng(seed).integers(1, vocab, n).tolist()


def _valve_node(pool, clock, *, disaggregated=False, offline=True,
                prefix=''):
    rt = ValveRuntime(pool, RuntimeConfig(n_devices=1, t_cool_init=0.002),
                      clock=clock)
    node = NodeOrchestrator(rt, idle_advance=1e-3,
                            disaggregated=disaggregated)
    cfg = reduced(get_config(ARCH), page_size=4)
    node.add_engine(cfg, _ecfg('online'), seed=0, name=f'{prefix}online',
                    device='cpu')
    if offline:
        node.add_engine(cfg, _ecfg('offline'), seed=0,
                        name=f'{prefix}off', device='cpu')
    return node


def _plane(*, prefill_handles=8, prefill_reserved=4,
           decode_handles=8, decode_reserved=6, offline=True):
    """Two disaggregated Valve nodes sharing one virtual timeline.  The
    decode pool's reservation is sized generously: migrated online leases
    land via ``KVPool.alloc`` on the reserved region directly (no
    pressure-reclaim on that path), so a tight reservation turns handoffs
    into deferrals — which is exactly what the deferral test shrinks it
    for."""
    clock = VirtualClock()
    prefill = _valve_node(
        KVPool(prefill_handles, 4, page_size=4,
               reserved_handles=prefill_reserved, name='prefill'),
        clock, disaggregated=True, offline=offline, prefix='p-')
    decode = _valve_node(
        KVPool(decode_handles, 4, page_size=4,
               reserved_handles=decode_reserved, name='decode'),
        clock, disaggregated=True, offline=offline, prefix='d-')
    return DisaggPlane(prefill, decode)


def _colocated(*, offline=True):
    return _valve_node(
        KVPool(8, 4, page_size=4, reserved_handles=4, name='colo'),
        VirtualClock(), offline=offline)


def _online_trace(target, n=3):
    vocab = target.online.mcfg.vocab_size
    return [target.online.submit(_prompt(vocab, 12, 40 + i),
                                 max_new_tokens=8) for i in range(n)]


def _outputs(target, rids):
    out = []
    for rid in rids:
        eng = target.engine_of(rid) if hasattr(target, 'engine_of') \
            else target.online
        out.append(eng.output_tokens(rid))
    return out


# ---------------------------------------------------------------------------
# The headline contract: bit-identical, zero recompute
# ---------------------------------------------------------------------------

def test_handoff_bit_identical_zero_recompute():
    ref = _colocated()
    ref_rids = _online_trace(ref)
    ref.drain(max_steps=5000)
    ref_out = _outputs(ref, ref_rids)
    assert all(len(t) == 8 for t in ref_out)

    plane = _plane()
    rids = _online_trace(plane)
    plane.drain(max_steps=5000)

    # every request handed off exactly once, prefill → decode
    assert plane.stats.handoffs == len(rids)
    assert plane.stats.handoffs_deferred == 0
    assert [sp for _, sp, _ in plane.handoffs] == ['prefill'] * len(rids)
    assert [dp for _, _, dp in plane.handoffs] == ['decode'] * len(rids)

    # ... and finished ON the decode engine with the colocated outputs:
    # greedy decode would diverge on any lost or recomputed-from-wrong-
    # state token, so equality is the end-to-end correctness witness
    de = plane.decode.online
    for rid in rids:
        assert plane.engine_of(rid) is de
        assert de.requests[rid].state is ReqState.FINISHED
        assert de.requests[rid].recomputes == 0
    assert _outputs(plane, rids) == ref_out
    assert len(plane.prefill.online.finished) == 0

    # zero-recompute handoff, from every vantage point: the engine never
    # charged a recomputed token, the telemetry fold saw none, and each
    # PrefillHandoff event carried 0
    assert de.stats.tokens_recomputed == 0
    for node in (plane.prefill, plane.decode):
        snap = node.runtime.telemetry.snapshot()
        assert snap['prefill_handoffs'] == len(rids)
        assert snap['handoff_recompute_tokens'] == 0
        assert snap['handoff_pages'] == plane.stats.pages_copied
        assert snap['handoff_latency']['count'] == len(rids)
        evs = node.runtime.bus.events(PrefillHandoff)
        assert len(evs) == len(rids)
        for ev in evs:
            assert ev.recompute_tokens == 0
            assert ev.src_pool == 'prefill' and ev.dst_pool == 'decode'
            assert ev.pages_copied > 0 and ev.latency_s >= 0.0

    # the data plane actually moved pages (a 12-token prompt + first
    # token = 4 pages minimum per request)
    migs = [e for e in plane.prefill.runtime.bus.events(PageMigration)
            if e.cross_pool]
    assert len(migs) == len(rids)
    assert plane.stats.pages_copied == sum(e.n_pages for e in migs) > 0

    # nothing lingers on either pool: leases released, routes dead
    for node in (plane.prefill, plane.decode):
        assert node.runtime.memory.live_leases('online') == []
        assert node.runtime.invalidation_routes() == []
    plane.check_invariants()

    m = plane.metrics()
    assert m['online_finished'] == len(rids)
    assert m['handoffs'] == len(rids)
    assert m['handoff_recompute_tokens'] == 0
    assert m['max_preemptions_per_request'] <= 1


# ---------------------------------------------------------------------------
# Refusal == deferral (the colocated fallback)
# ---------------------------------------------------------------------------

def test_no_capacity_refusal_defers_to_colocated_fallback():
    """With the decode reservation too small for even one lease, every
    handoff attempt is refused ('no-capacity', source untouched) — the
    request completes on the prefill engine with the colocated output."""
    ref = _colocated()
    ref_rids = _online_trace(ref, n=1)
    ref.drain(max_steps=5000)
    ref_out = _outputs(ref, ref_rids)

    plane = _plane(decode_reserved=1)     # 4 reserved pages < 5 needed
    rids = _online_trace(plane, n=1)
    plane.drain(max_steps=5000)

    assert plane.stats.handoffs == 0
    assert plane.stats.handoffs_deferred > 0
    assert plane.prefill.runtime.memory.stats.migration_refusals == \
        plane.stats.handoffs_deferred
    pe = plane.prefill.online
    assert plane.engine_of(rids[0]) is pe
    assert pe.requests[rids[0]].state is ReqState.FINISHED
    assert _outputs(plane, rids) == ref_out
    assert pe.stats.tokens_recomputed == 0
    assert plane.decode.online.requests == {}
    for node in (plane.prefill, plane.decode):
        assert node.runtime.memory.live_leases('online') == []
        assert node.runtime.invalidation_routes() == []
    plane.check_invariants()


# ---------------------------------------------------------------------------
# Both pools backfill; the preemption bound holds per (request, device)
# ---------------------------------------------------------------------------

def test_offline_backfill_on_both_pools_under_preemption_bound():
    plane = _plane()
    vocab = plane.online.mcfg.vocab_size
    off_rids = []
    for node in (plane.prefill, plane.decode):
        eng = node.offline[0]
        off_rids.append((eng, eng.submit(_prompt(vocab, 8, 7),
                                         max_new_tokens=8)))
    for _ in range(4):                    # offline decode under way
        plane.step()
    rids = _online_trace(plane, n=2)
    plane.drain(max_steps=20000)

    assert plane.stats.handoffs == len(rids)
    assert all(len(plane.engine_of(r).output_tokens(r)) == 8 for r in rids)
    # offline work finished on BOTH pools — the prefill side harvested
    # its own post-handoff idleness, the decode side its pre-handoff one
    for eng, rid in off_rids:
        assert eng.requests[rid].state is ReqState.FINISHED
        assert len(eng.output_tokens(rid)) == 8
    assert all(e.stats.tokens_generated > 0 for e in plane.offline)

    # each runtime's gates closed for its own online phase and woke after
    # T_cool; the §4.2 bound holds per (request, device) — devices are
    # disjoint between the nodes, so per-runtime checks compose
    for node in (plane.prefill, plane.decode):
        snap = node.runtime.telemetry.snapshot()
        assert snap['compute_preemptions'] >= 1
        assert snap['offline_wakeups'] >= 1
        assert snap['max_preemptions_per_request'] <= 1
    plane.check_invariants()


# ---------------------------------------------------------------------------
# Cross-pool rescue between the nodes (reclamation victims migrate too)
# ---------------------------------------------------------------------------

def test_cross_rescue_between_disagg_pools_zero_recompute():
    """With cross-rescue enabled, an online burst on the tight prefill
    pool rescues its offline victims to the decode pool — whole lease,
    zero recompute, bit-equal continuation on the decode offline engine —
    and the reclamation log proves copy-before-reallocation."""
    def run(disturb):
        plane = _plane(prefill_handles=5, prefill_reserved=1,
                       decode_reserved=4)
        plane.enable_cross_rescue()
        vocab = plane.online.mcfg.vocab_size
        eng = plane.prefill.offline[0]
        rids = [eng.submit(_prompt(vocab, 12, 70 + i), max_new_tokens=8)
                for i in range(2)]
        for _ in range(4):
            plane.step()
        if disturb:
            # 28-token prompt + 12 new = 10 pages >> the 4-page prefill
            # reservation → reclamation takes offline handles → rescue
            on = plane.submit(_prompt(vocab, 28, 99), max_new_tokens=12)
            plane.drain(max_steps=20000)
            assert len(plane.engine_of(on).output_tokens(on)) == 12
        else:
            plane.drain(max_steps=20000)
        return plane, rids

    ref_plane, ref_rids = run(disturb=False)
    ref_out = _outputs(ref_plane, ref_rids)

    plane, rids = run(disturb=True)
    assert plane.stats.rescues >= 1
    rescued = {e.owner for e
               in plane.prefill.runtime.bus.events(PageMigration)
               if e.cross_pool and e.src_pool == 'prefill'
               and e.owner in set(rids)}
    assert rescued

    dst = plane.decode.offline[0]
    for rid in rescued:
        assert plane.engine_of(rid) is dst
        assert dst.requests[rid].recomputes == 0
    assert dst.stats.tokens_recomputed == 0
    assert _outputs(plane, rids) == ref_out

    # the ReclamationEvent names the rescued victims, and the ordering
    # check (inside check_invariants) proves each had its data-plane copy
    # published BEFORE the reclamation freed the source pages
    recl = plane.prefill.runtime.bus.events(ReclamationEvent)
    named = {r for ev in recl for r in ev.rescued}
    assert rescued <= named
    for ev in recl:
        assert not (set(ev.requests) & rescued)
    plane.check_invariants()


# ---------------------------------------------------------------------------
# The KV copy, the reference plane, and topology-aware pairing
# ---------------------------------------------------------------------------

def watch_first_handoff(plane):
    """Subscribers that hold the first handoff's copied KV rows against
    their source rows, read at its ``PrefillHandoff`` (the source pages
    are freed by then but not yet reused).  -> a list that takes one
    (pages, rows equal) pair."""
    migs, seen = {}, []

    def on_migration(ev):
        if ev.cross_pool:
            migs[ev.owner] = ev

    def on_handoff(ev):
        if seen:
            return
        mig = migs[ev.req_id]
        src = plane.prefill.online.cache
        dst = plane.decode.online.cache
        s = torch.tensor(mig.src_pages)
        d = torch.tensor(mig.dst_pages)
        seen.append((len(mig.src_pages),
                     all(torch.equal(dst[k].index_select(1, d),
                                     src[k].index_select(1, s))
                         for k in src)))

    plane.prefill.runtime.subscribe(on_migration, PageMigration)
    plane.decode.runtime.subscribe(on_handoff, PrefillHandoff)
    return seen


def test_copied_kv_rows_equal_their_source():
    plane = _plane()
    seen = watch_first_handoff(plane)
    rids = _online_trace(plane, n=2)
    plane.drain(max_steps=5000)
    assert plane.stats.handoffs == len(rids)
    (n_pages, equal), = seen
    assert n_pages > 0 and equal


def test_copy_pages_moves_page_axis_one():
    """``copy_pages`` writes the source's pages (page axis 1 of every pool)
    into the destination's pages in the order given, and nothing else."""
    from repro_torch.serving.disagg.plane import copy_pages
    gen = torch.Generator().manual_seed(0)
    src = {k: torch.randn((2, 6, 4, 2, 8), generator=gen) for k in 'kv'}
    dst = {k: torch.zeros((2, 5, 4, 2, 8)) for k in 'kv'}
    copy_pages(src, [4, 1, 5], dst, [2, 3, 1])
    for k in 'kv':
        for s, d in ((4, 2), (1, 3), (5, 1)):
            assert torch.equal(dst[k][:, d], src[k][:, s])
        assert not dst[k][:, [0, 4]].any()


def _j_plane(params):
    """The reference's plane over the same geometry as :func:`_plane`,
    every engine given ``params`` and an f32 cache."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as j_get_config
    from repro.configs import reduced as j_reduced
    from repro.core.clock import VirtualClock as JVirtualClock
    from repro.core.runtime import RuntimeConfig as JRuntimeConfig
    from repro.core.runtime import ValveRuntime as JValveRuntime
    from repro.launch.node import NodeOrchestrator as JNodeOrchestrator
    from repro.serving.disagg import DisaggPlane as JDisaggPlane
    from repro.serving.engine import EngineConfig as JEngineConfig
    from repro.serving.kvpool import KVPool as JKVPool

    clock = JVirtualClock()

    def side(name, reserved):
        rt = JValveRuntime(
            JKVPool(8, 4, page_size=4, reserved_handles=reserved, name=name),
            JRuntimeConfig(n_devices=1, t_cool_init=0.002), clock=clock)
        node = JNodeOrchestrator(rt, idle_advance=1e-3, disaggregated=True)
        for klass in ('online', 'offline'):
            eng = node.add_engine(
                j_reduced(j_get_config(ARCH), page_size=4),
                JEngineConfig(max_batch=4, max_seq=48, prefill_chunk=8,
                              klass=klass), params=params)
            eng.cache = jax.tree.map(lambda x: x.astype(jnp.float32),
                                     eng.cache)
        return node

    return JDisaggPlane(side('prefill', 4), side('decode', 6))


def _parity_run(plane):
    vocab = plane.online.mcfg.vocab_size
    off = [(node.offline[0], node.offline[0].submit(
        _prompt(vocab, 8, 60 + i), max_new_tokens=8))
        for i, node in enumerate((plane.prefill, plane.decode))]
    for _ in range(3):
        plane.step()
    rids = _online_trace(plane, n=3)
    plane.drain(max_steps=20000)
    plane.check_invariants()
    m = plane.metrics()
    return {'online': _outputs(plane, rids),
            'offline': [e.output_tokens(r) for e, r in off],
            'handoffs': list(plane.handoffs),
            'deferred': plane.stats.handoffs_deferred,
            'pages_copied': plane.stats.pages_copied,
            'clock': plane.clock.now(),
            'metrics': {k: m[k] for k in (
                'handoffs', 'handoff_pages', 'handoff_recompute_tokens',
                'max_preemptions_per_request', 'offline_finished')}}


def test_plane_matches_the_reference_plane():
    """The same online trace and offline work on both pools, through the
    reference's plane and the port's, the same weights in f32: equal
    outputs, handoffs, deferrals, pages copied and virtual end time."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as j_get_config
    from repro.configs import reduced as j_reduced
    from repro.models.api import build_model as j_build_model
    from repro_torch.bridge import params_from_jax

    params = jax.tree.map(
        lambda x: x.astype(jnp.float32),
        j_build_model(j_reduced(j_get_config(ARCH), page_size=4))
        .init_params(jax.random.PRNGKey(0)))
    want = _parity_run(_j_plane(params))

    plane = _plane()
    for node in (plane.prefill, plane.decode):
        for eng in node.engines:
            eng.params = params_from_jax(jax.tree.map(np.asarray, params))
            eng.cache = {k: v.float() for k, v in eng.cache.items()}
    got = _parity_run(plane)
    assert got['metrics']['handoffs'] == 3
    assert got['metrics']['handoff_recompute_tokens'] == 0
    assert got['pages_copied'] > 0
    assert got == want


class _StandInTopology:
    """``cheapest_pair`` over a fixed link-cost table, the duck type
    ``DisaggPlane.pair_cheapest`` reads (the cluster plane's
    ``TopologyModel`` is not ported yet)."""

    COST = {('pA', 'dX'): ('cross-rack', 8.0), ('pB', 'dX'): ('nvlink', 1.0)}

    def cheapest_pair(self, srcs, dsts):
        pairs = [(self.COST[s, d][1], s, d) for s in srcs for d in dsts]
        cost, s, d = min(pairs)
        return s, d, self.COST[s, d][0], cost


def test_pair_cheapest_picks_cheapest_link_and_records_it():
    clock = VirtualClock()

    def node(pool_name):
        return _valve_node(
            KVPool(8, 4, page_size=4, reserved_handles=4, name=pool_name),
            clock, disaggregated=True, offline=False,
            prefix=f'{pool_name}-')

    pre_far, pre_near, dec = node('pre-far'), node('pre-near'), node('dec')
    plane = DisaggPlane.pair_cheapest(
        {'pA': pre_far, 'pB': pre_near}, {'dX': dec}, _StandInTopology())
    assert plane.prefill is pre_near and plane.decode is dec
    assert plane.link == ('pB', 'dX', 'nvlink', 1.0)
    assert plane.metrics()['handoff_link'] == plane.link


def test_handed_off_requests_resume_as_decode_slots():
    """A lease handed off at its last sampled token resumes on the decode
    engine as a decode slot, not as a one-token prefill chunk: the decode
    side never runs the chunked-prefill entry, and every token there is
    the decode entry's, as in the colocated run."""
    plane = _plane(offline=False)
    rids = _online_trace(plane, n=3)
    plane.drain(max_steps=5000)
    de = plane.decode.online
    assert plane.stats.handoffs == len(rids)
    assert de.stats.mixed_dispatches == de.stats.prefill_chunks == 0
    assert de.stats.decode_iterations == de.stats.dispatches > 0
    assert all(de.requests[r].n_prefilled == 12 for r in rids)
