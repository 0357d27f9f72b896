"""The port's NodeOrchestrator on a VirtualClock, against the JAX package's:
heterogeneous colocation over one pool and runtime, an online burst that
reclaims handles in both offline engines, exact recompute, and at most one
compute preemption per online request.

The parity test gives both nodes the reference's weights in f32 and f32 KV
pools, so their drains must agree token for token and event for event.
"""
import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core.clock import VirtualClock as JVirtualClock
from repro.core.runtime import RuntimeConfig as JRuntimeConfig
from repro.core.runtime import ValveRuntime as JValveRuntime
from repro.launch.node import NodeOrchestrator as JNodeOrchestrator
from repro.models.api import build_model as j_build_model
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.kvpool import KVPool as JKVPool
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, reduced
from repro_torch.core.clock import VirtualClock
from repro_torch.core.runtime import RuntimeConfig, ValveRuntime
from repro_torch.launch.node import NodeOrchestrator
from repro_torch.launch.serve import serve_demo
from repro_torch.serving.engine import EngineConfig, ReqState
from repro_torch.serving.kvpool import KVPool

ONLINE_ARCH = 'qwen3-0.6b'
OFFLINE_ARCHS = ('internlm2-1.8b', 'qwen3-0.6b')
ARCHS = (ONLINE_ARCH,) + OFFLINE_ARCHS
SEEDS = (0, 10, 11)


def _f32(tree):
    return jax.tree.map(lambda x: x.astype(jnp.float32), tree)


def _jax_params():
    return [_f32(j_build_model(j_reduced(j_get_config(a), page_size=4))
                 .init_params(jax.random.PRNGKey(s)))
            for a, s in zip(ARCHS, SEEDS)]


def _klasses():
    return ['online'] + ['offline'] * len(OFFLINE_ARCHS)


def _jax_node(params):
    pool = JKVPool(5, 4, page_size=4, reserved_handles=1)
    rt = JValveRuntime(pool, JRuntimeConfig(n_devices=1, t_cool_init=0.002),
                       clock=JVirtualClock())
    node = JNodeOrchestrator(rt, idle_advance=1e-3)
    for arch, klass, p in zip(ARCHS, _klasses(), params):
        eng = node.add_engine(j_reduced(j_get_config(arch), page_size=4),
                              JEngineConfig(max_batch=4, max_seq=48,
                                            prefill_chunk=8, klass=klass),
                              params=p)
        eng.cache = _f32(eng.cache)
    return node


def _node(params=None, **ecfg):
    """The port's node; ``params`` (numpy trees) bridge the reference's
    weights, else each engine draws its own from its seed."""
    pool = KVPool(5, 4, page_size=4, reserved_handles=1)
    rt = ValveRuntime(pool, RuntimeConfig(n_devices=1, t_cool_init=0.002),
                      clock=VirtualClock())
    node = NodeOrchestrator(rt, idle_advance=1e-3)
    for i, (arch, klass, seed) in enumerate(zip(ARCHS, _klasses(), SEEDS)):
        p = None if params is None else params_from_jax(params[i])
        eng = node.add_engine(reduced(get_config(arch), page_size=4),
                              EngineConfig(max_batch=4, max_seq=48,
                                           prefill_chunk=8, klass=klass,
                                           **ecfg),
                              params=p, seed=seed, device='cpu')
        if params is not None:
            eng.cache = {k: v.float() for k, v in eng.cache.items()}
    return node


def _submit_offline(node, rng):
    """Two requests per offline engine: every offline handle holds live
    pages, so reclamation must invalidate."""
    return [(eng, eng.submit(rng.integers(1, eng.mcfg.vocab_size,
                                          12).tolist(), max_new_tokens=8))
            for eng in node.offline for _ in range(2)]


def _burst_run(node):
    rng = np.random.default_rng(7)
    rids = _submit_offline(node, rng)
    for _ in range(4):
        node.step()
    # 28-token prompt + 12 new tokens = 10 pages, far beyond the 4-page
    # reservation: reclaims offline handles (compute-first)
    on_rid = node.online.submit(
        rng.integers(1, node.online.mcfg.vocab_size, 28).tolist(),
        max_new_tokens=12)
    node.drain(max_steps=5000)
    return rids, on_rid


def test_heterogeneous_colocation_matches_reference_node():
    params = _jax_params()
    jnode = _jax_node(params)
    j_rids, j_on = _burst_run(jnode)
    node = _node([jax.tree.map(np.asarray, p) for p in params])
    rids, on = _burst_run(node)

    assert node.online.output_tokens(on) == jnode.online.output_tokens(j_on)
    assert [e.output_tokens(r) for e, r in rids] == \
        [e.output_tokens(r) for e, r in j_rids]
    for key in ('compute_preemptions', 'reclamations', 'offline_wakeups',
                'offline_recomputed_tokens', 'max_preemptions_per_request'):
        assert node.metrics()[key] == jnode.metrics()[key], key
    assert [e.stats.invalidations for e in node.offline] == \
        [e.stats.invalidations for e in jnode.offline]
    assert node.runtime.clock.now() == jnode.runtime.clock.now()


def test_burst_invalidates_both_offline_engines_and_recompute_is_exact():
    ref_node = _node()
    ref_rids = _submit_offline(ref_node, np.random.default_rng(7))
    ref_node.drain(max_steps=5000)
    ref_outputs = [e.output_tokens(r) for e, r in ref_rids]

    node = _node(fused_sampling=True)
    rids, on_rid = _burst_run(node)
    assert len(node.online.output_tokens(on_rid)) == 12
    node.runtime.check_invariants()      # <= 1 compute preemption / request
    assert node.runtime.stats.compute_preemptions <= 1
    assert node.metrics()['max_preemptions_per_request'] <= 1
    assert node.runtime.reclaimer.stats.reclamations >= 1
    assert all(e.stats.invalidations >= 1 for e in node.offline)
    assert [e.output_tokens(r) for e, r in rids] == ref_outputs
    assert {e.mcfg.name for e in node.offline} == \
        {a + '-reduced' for a in OFFLINE_ARCHS}
    assert node.runtime.invalidation_routes() == []
    node.pool.check_invariants()


def test_gate_driven_backfill_and_wakeup():
    node = _node()
    rng = np.random.default_rng(3)
    eng = node.offline[0]
    eng.submit(rng.integers(1, eng.mcfg.vocab_size, 8).tolist(),
               max_new_tokens=4)
    node.online.submit(rng.integers(1, node.online.mcfg.vocab_size,
                                    8).tolist(), max_new_tokens=4)
    node.step()
    assert node.stats.online_dispatches == 1
    assert node.stats.offline_dispatches == 0
    assert node.stats.gated_skips == 1
    node.drain(max_steps=2000)
    assert node.stats.offline_dispatches > 0
    assert node.runtime.stats.offline_wakeups >= 1
    assert len(eng.finished) == 1
    node.runtime.check_invariants()


def test_serve_demo_on_a_virtual_clock():
    """The node demo at reduced width on ``build_node``'s pool geometry and
    engines, fused sampling on every engine: every offline request
    finishes, <= 1 preemption per request."""
    pool = KVPool(24, 8, page_size=16, reserved_handles=2)
    rt = ValveRuntime(pool, RuntimeConfig(n_devices=1, t_cool_init=0.002),
                      clock=VirtualClock())
    node = NodeOrchestrator(rt, idle_advance=1e-3)
    for arch, klass, seed in (('qwen3-0.6b', 'online', 0),
                              ('qwen3-0.6b', 'offline', 0),
                              ('internlm2-1.8b', 'offline', 1)):
        node.add_engine(reduced(get_config(arch), page_size=16),
                        EngineConfig(max_batch=8, max_seq=96,
                                     prefill_chunk=16, klass=klass,
                                     fused_sampling=True),
                        seed=seed, device='cpu')
    m = serve_demo(node=node, steps=150, quiet=True)
    assert m['offline_finished'] == 12
    assert m['online_finished'] >= 3
    assert m['max_preemptions_per_request'] <= 1
    assert m['live_invalidation_routes'] == 0
    for eng in node.offline:             # lazy fused tokens all resolve
        outs = [eng.output_tokens(r) for r in eng.requests]
        assert all(len(o) == 24 and min(o) >= 0 for o in outs)
        assert eng.stats.token_flushes > 0


def _rescue_node():
    """Runtime pool A (tight) + auxiliary pool B, one architecture and one
    weight seed on every engine: a rescued request's KV rows stay valid
    under the destination engine's weights."""
    pool = KVPool(5, 4, page_size=4, reserved_handles=1, name='poolA')
    rt = ValveRuntime(pool, RuntimeConfig(n_devices=1, t_cool_init=0.002),
                      clock=VirtualClock())
    node = NodeOrchestrator(rt, idle_advance=1e-3)
    cfg = reduced(get_config(ONLINE_ARCH), page_size=4)
    for klass, name in (('online', 'online'), ('offline', 'offA')):
        node.add_engine(cfg, EngineConfig(max_batch=4, max_seq=48,
                                          prefill_chunk=8, klass=klass),
                        seed=0, name=name, device='cpu')
    pool_b = node.add_pool(KVPool(8, 4, page_size=4, name='poolB'))
    node.add_engine(cfg, EngineConfig(max_batch=4, max_seq=48,
                                      prefill_chunk=8, klass='offline'),
                    seed=0, name='offB', pool=pool_b, device='cpu')
    return node


def test_cross_pool_rescue_copies_kv_rows_and_recomputes_nothing():
    """A reclamation victim migrates to pool B: the orchestrator copies its
    KV rows in place (``index_copy_`` on the page axis) and generation
    resumes there with zero recomputed tokens and the undisturbed output."""
    outs = {}
    for disturb in (False, True):
        node = _rescue_node()
        rng = np.random.default_rng(7)
        eng = node.names['offA']
        rids = [eng.submit(rng.integers(1, eng.mcfg.vocab_size, 12).tolist(),
                           max_new_tokens=8) for _ in range(2)]
        for _ in range(4):
            node.step()
        if disturb:
            node.online.submit(
                rng.integers(1, node.online.mcfg.vocab_size, 28).tolist(),
                max_new_tokens=12)
        node.drain(max_steps=5000)
        outs[disturb] = [node.engine_of(r).output_tokens(r) for r in rids]
    assert node.stats.requests_rescued >= 1
    dst = node.names['offB']
    for rid, src, dst_pool in node.rescues:
        assert (src, dst_pool) == ('poolA', 'poolB')
        assert node.engine_of(rid) is dst
        assert dst.requests[rid].recomputes == 0
    assert dst.stats.tokens_recomputed == 0
    assert outs[True] == outs[False]
    node.runtime.check_invariants()
    for p in [node.pool] + node.pools:
        p.check_invariants()


def test_engine_cancel_keeps_drain_live_and_counts():
    """Cancelling a running and a queued online request: the node drains,
    the cancellations are counted and no lease or route is left behind."""
    node = _node(fused_sampling=True)
    eng = node.online
    rng = np.random.default_rng(2)
    rids = [eng.submit(rng.integers(1, eng.mcfg.vocab_size, 8).tolist(),
                       max_new_tokens=4) for _ in range(6)]
    for _ in range(3):
        node.step()
    running = [r for r in rids if r in eng.running]
    queued = [r for r in rids if r in eng.queue]
    assert running and queued
    assert eng.cancel(running[0]) and eng.cancel(queued[-1])
    assert eng.cancel(running[0]) is False
    assert eng.cancel('no-such-request') is False
    node.drain(max_steps=2000)
    assert not node.has_work()
    assert eng.stats.cancellations == 2 and len(eng.finished) == 4
    for rid in (running[0], queued[-1]):
        assert eng.requests[rid].state is ReqState.CANCELLED
        assert eng.requests[rid].lease is None
    assert node.metrics()['cancellations'] == 2
    assert node.runtime.invalidation_routes() == []
    node.runtime.check_invariants()
    node.pool.check_invariants()
