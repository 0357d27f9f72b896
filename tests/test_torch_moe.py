"""The port's MoE family against the JAX package's: ``moe_mlp`` (routing,
capacity drops, expert products, combine, aux loss), the model entry points
for phi3.5-moe (top-2) and llama4-scout (top-1, shared expert, qk_norm,
prefix embeddings), an MoE engine's drain and an offline-MoE node.

The parity cases run at 16 experts (``reduced(cfg, n_experts=16)``): at
the default reduced 4 experts the serving capacity (factor 2.0) is never
smaller than the tokens of a call, so nothing would drop.  The CLI's node
runs at the default, as the CLI builds it.

Tolerances: f32 outputs within atol 1e-4 of the reference (same
arithmetic, other summation order), routing and the dropped assignments
equal, greedy tokens equal; bf16 ``moe_mlp`` within 2e-2 of the largest
output (a few bf16 roundings of ~2 ulp each).
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core.clock import VirtualClock as JVirtualClock
from repro.core.memory import MemoryPlane as JMemoryPlane
from repro.core.runtime import RuntimeConfig as JRuntimeConfig
from repro.core.runtime import ValveRuntime as JValveRuntime
from repro.launch.node import NodeOrchestrator as JNodeOrchestrator
from repro.models import moe as jmoe
from repro.models.api import build_model as j_build_model
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.kvpool import KVPool as JKVPool
from repro_torch import configs as tconfigs
from repro_torch.bridge import cache_from_jax, params_from_jax
from repro_torch.core.clock import VirtualClock
from repro_torch.core.memory import MemoryPlane
from repro_torch.core.runtime import RuntimeConfig, ValveRuntime
from repro_torch.kernels.paged_attention.prefix import build_shared_runs
from repro_torch.launch.node import NodeOrchestrator
from repro_torch.models import moe as tmoe
from repro_torch.models.api import build_model
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.kvpool import KVPool

PHI, SCOUT = 'phi3.5-moe-42b-a6.6b', 'llama4-scout-17b-a16e'
E = 16
PG, MAXP, CHUNK, B = 4, 8, 8, 2
ATOL = 1e-4
BF16_TOL = 2e-2


def _f32(tree):
    return jax.tree.map(lambda x: x.astype(jnp.float32), tree)


def _configs(arch):
    jcfg = j_reduced(j_get_config(arch), n_experts=E, page_size=PG)
    tcfg = tconfigs.reduced(tconfigs.get_config(arch), n_experts=E,
                            page_size=PG)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _pair(arch, seed=1):
    jcfg, tcfg = _configs(arch)
    jparams = _f32(j_build_model(jcfg).init_params(jax.random.PRNGKey(seed)))
    return jcfg, tcfg, jparams, params_from_jax(jax.tree.map(np.asarray,
                                                             jparams))


def _layer0(jparams, tparams):
    return (jax.tree.map(lambda w: w[0], jparams['layers']),
            {k: w[0] for k, w in tparams['layers'].items()})


def _tokens_with_padding(cfg, rng):
    """(4, 8, D) inputs whose last two rows repeat one vector, as an
    engine's padding rows do: they all route to the same experts."""
    x = rng.normal(size=(4, 8, cfg.d_model)).astype(np.float32)
    x[2:] = x[2, 0]
    return x


def _reference_routing(jcfg, jlp, x, capacity_factor):
    """The reference's own routing lines (``repro.models.moe.moe_mlp``):
    each token-major assignment's expert, and whether it is kept."""
    e, k = jcfg.n_experts, jcfg.moe_top_k
    xf = jnp.asarray(x).reshape(-1, jcfg.d_model)
    probs = jax.nn.softmax(xf.astype(jnp.float32)
                           @ jlp['router'].astype(jnp.float32), axis=-1)
    _, top_i = jax.lax.top_k(probs, k)
    flat_e = top_i.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, e, dtype=jnp.int32)
    pos = (jnp.cumsum(onehot, axis=0) * onehot).sum(-1) - 1
    cap = int(math.ceil(k * xf.shape[0] / e * capacity_factor))
    return np.asarray(flat_e), np.asarray(pos < cap)


def _port_routing(tcfg, tlp, x, capacity_factor):
    xf = x.reshape(-1, tcfg.d_model)
    _, top_i, _, pos, cap = tmoe.route(tcfg, tlp, xf, capacity_factor)
    return top_i.reshape(-1).numpy(), (pos < cap).numpy()


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('capacity_factor', [1.25, 2.0])
@pytest.mark.parametrize('arch', [PHI, SCOUT])
def test_moe_mlp_matches_reference(arch, capacity_factor, dtype):
    """Same outputs and aux loss, the same experts chosen and the same
    assignments dropped -- and some are dropped, padding rows included."""
    jcfg, tcfg, jparams, tparams = _pair(arch)
    if dtype == 'bfloat16':
        jparams = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jparams)
        tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                                  dtype=torch.bfloat16)
    jlp, tlp = _layer0(jparams, tparams)
    x = _tokens_with_padding(jcfg, np.random.default_rng(0))
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jy, jaux = jmoe.moe_mlp(jcfg, jlp, jx, capacity_factor=capacity_factor)
    ty, taux = tmoe.moe_mlp(tcfg, tlp, tx, capacity_factor=capacity_factor)
    assert ty.dtype == tx.dtype and ty.shape == tx.shape
    want_e, want_keep = _reference_routing(jcfg, jlp, jx, capacity_factor)
    got_e, got_keep = _port_routing(tcfg, tlp, tx, capacity_factor)
    np.testing.assert_array_equal(got_e, want_e)
    np.testing.assert_array_equal(got_keep, want_keep)
    assert (~got_keep).sum() > 0                     # drops occur
    k = jcfg.moe_top_k
    assert (~got_keep[-16 * k:]).any()               # padding drops too
    jy = np.asarray(jy.astype(jnp.float32))
    tol = ATOL if dtype == 'float32' else BF16_TOL * np.abs(jy).max()
    np.testing.assert_allclose(ty.float().numpy(), jy, rtol=0, atol=tol)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


def test_top_k_ties_keep_the_lower_expert_first():
    """Equal router probabilities pick the lower expert id first, as
    ``jax.lax.top_k`` does: a zero router makes every expert tie."""
    _, tcfg = _configs(PHI)
    lp = {'router': torch.zeros(tcfg.d_model, E)}
    _, top_i, top_w, pos, _ = tmoe.route(tcfg, lp, torch.ones(3, tcfg.d_model),
                                         2.0)
    assert top_i.tolist() == [[0, 1]] * 3
    assert torch.equal(top_w, torch.full((3, 2), 0.5))
    assert pos.tolist() == [0, 0, 1, 1, 2, 2]


def _chunk_batch(prompts, lo, page_table):
    """The engine's mixed-dispatch layout for one chunk per row."""
    toks, poss, pids, offs = (np.zeros((B, CHUNK), np.int32)
                              for _ in range(4))
    kv_len, last = np.zeros(B, np.int32), np.zeros(B, np.int32)
    for r, prompt in enumerate(prompts):
        hi = min(lo + CHUNK, len(prompt))
        n, pos = hi - lo, np.arange(lo, hi)
        toks[r, :n] = prompt[lo:hi]
        poss[r, :n], poss[r, n:] = pos, hi - 1
        pids[r, :n] = page_table[r, pos // PG]
        offs[r, :n] = pos % PG
        kv_len[r], last[r] = hi, n - 1
    return {'tokens': toks, 'positions': poss, 'page_table': page_table,
            'page_ids': pids, 'offsets': offs, 'kv_len': kv_len,
            'last_idx': last}


def _batch(jcfg, entry, rng):
    pt = np.arange(1, 1 + B * MAXP, dtype=np.int32).reshape(B, MAXP)
    if entry == 'prefill':
        batch = {'tokens': rng.integers(1, jcfg.vocab_size, (B, 4 * PG))
                 .astype(np.int32), 'page_table': pt}
    elif entry == 'prefill_chunk':
        prompts = [rng.integers(1, jcfg.vocab_size, n).tolist()
                   for n in (CHUNK, CHUNK - 3)]
        batch = _chunk_batch(prompts, 0, pt)
    else:
        pt[1, :2] = pt[0, :2]                       # two shared full pages
        batch = {'tokens': rng.integers(1, jcfg.vocab_size, B)
                 .astype(np.int32),
                 'positions': np.array([13, 20], np.int32), 'page_table': pt}
    if jcfg.frontend is not None and entry != 'decode_step':
        batch['prefix_embeds'] = (rng.normal(size=(B, 3, jcfg.d_model))
                                  * 0.5).astype(np.float32)
    return batch


@pytest.mark.parametrize('entry', ['prefill', 'prefill_chunk', 'decode_step'])
@pytest.mark.parametrize('arch', [PHI, SCOUT])
def test_entry_points_match_reference(arch, entry):
    """Scores and the KV written equal the reference's; decode also through
    the prefix-shared path and the paged-decode kernel's plain version."""
    jcfg, tcfg, jparams, tparams = _pair(arch)
    rng = np.random.default_rng(6)
    kv = {k: (rng.normal(size=(jcfg.n_layers, 1 + B * MAXP, PG,
                               jcfg.n_kv_heads, jcfg.hd)) * 0.5)
          .astype(np.float32) for k in ('k', 'v')}
    batch = _batch(jcfg, entry, rng)
    jc, jscores = jax.jit(functools.partial(getattr(jmoe, entry), jcfg))(
        jparams, {k: jnp.asarray(v) for k, v in kv.items()},
        {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    runs = [getattr(tmoe, entry)(tcfg, tparams, cache_from_jax(kv), tb)]
    if entry == 'decode_step':
        runs.append(tmoe.decode_step(tcfg, tparams, cache_from_jax(kv), tb,
                                     use_kernel=True))
        shared = build_shared_runs(batch['page_table'],
                                   batch['positions'] + 1, PG)
        assert shared['n_slots'] == 2
        runs.append(tmoe.decode_step(tcfg, tparams, cache_from_jax(kv), dict(
            tb, shared={k: torch.from_numpy(shared[k]) for k in
                        ('pages', 'pos', 'mask', 'tail_pt', 'start')})))
    for tc, tscores in runs:
        assert tscores.dtype == torch.float32
        np.testing.assert_allclose(tscores.numpy(), np.asarray(jscores),
                                   rtol=0, atol=ATOL)
        for key in ('k', 'v'):
            np.testing.assert_allclose(tc[key][:, 1:].numpy(),
                                       np.asarray(jc[key])[:, 1:],
                                       rtol=0, atol=ATOL)


def test_model_refuses_what_the_reference_lacks():
    """No prefill kernel path and no fused sampling for MoE, as in the
    reference.  (Training is ported: ``loss_fn`` gives the loss and the aux
    loss; its parity is in ``tests/test_torch_train_grads.py``.)"""
    _, tcfg = _configs(PHI)
    model = build_model(tcfg)
    with pytest.raises(NotImplementedError):
        model.prefill_fn({}, {}, {}, use_kernel=True)
    with pytest.raises(NotImplementedError):
        model.decode_sample_fn({}, {}, {})
    params = model.init_params(0, device='cpu')
    assert tuple(params['layers']['we_down'].shape) == (
        tcfg.n_layers, E, tcfg.d_ff, tcfg.d_model)
    assert 'wg' not in params['layers']
    tokens = torch.arange(16).reshape(2, 8) % tcfg.vocab_size
    loss, aux = model.loss_fn(params, {'tokens': tokens, 'labels': tokens})
    assert torch.isfinite(loss) and set(aux) == {'tokens', 'aux_loss'}


class _Drops:
    """Counts the assignments the port's MoE layers drop (wraps
    ``moe.route``)."""

    def __init__(self, monkeypatch):
        self.n = 0
        route = tmoe.route

        def counted(*a, **kw):
            out = route(*a, **kw)
            self.n += int((out[3] >= out[4]).sum())
            return out
        monkeypatch.setattr(tmoe, 'route', counted)


def _moe_trace(vocab):
    rng = np.random.default_rng(3)
    return [rng.integers(1, vocab, n).tolist() for n in (5, 13, 9, 17, 6)]


def _drain(eng, prompts):
    """The first request decodes alone, then the rest arrive: their prompt
    chunks share mixed dispatches with its decode rows."""
    rids = [eng.submit(prompts[0], max_new_tokens=10)]
    for _ in range(20):
        eng.step()
        if len(eng.requests[rids[0]].generated) >= 2:
            break
    rids += [eng.submit(p, max_new_tokens=10) for p in prompts[1:]]
    eng.run_to_completion()
    return [eng.output_tokens(r) for r in rids]


@pytest.mark.parametrize('kernel', [False, True])
def test_engine_drain_matches_reference_engine(kernel, monkeypatch):
    """Piggybacked decode rows ride in the chunked dispatch, as the
    reference composes it: with capacity drops in the calls, greedy tokens
    equal the reference engine's token for token."""
    jcfg, tcfg, jparams, tparams = _pair(PHI, seed=0)
    jmodel, tmodel = j_build_model(jcfg), build_model(tcfg)
    prompts = _moe_trace(jcfg.vocab_size)
    ecfg = dict(max_batch=4, max_seq=40, prefill_chunk=8)

    jpool = JKVPool(16, 4, page_size=PG, reserved_handles=1)
    JMemoryPlane(jpool, sharing=True)
    jeng = JEngine(jmodel, jparams, jpool, JEngineConfig(**ecfg))
    jeng.cache = _f32(jeng.cache)
    want = _drain(jeng, prompts)

    drops = _Drops(monkeypatch)
    pool = KVPool(16, 4, page_size=PG, reserved_handles=1)
    MemoryPlane(pool, sharing=True)
    eng = Engine(tmodel, tparams, pool, EngineConfig(
        **ecfg, decode_kernel=kernel, prefix_shared_attention=kernel),
        device='cpu')
    eng.cache = {k: v.float() for k, v in eng.cache.items()}
    got = _drain(eng, prompts)
    assert got == want
    assert drops.n > 0
    assert eng.stats.mixed_dispatches == jeng.stats.mixed_dispatches
    assert eng.stats.dispatches == jeng.stats.dispatches
    assert eng.stats.decode_iterations == jeng.stats.decode_iterations
    assert eng.stats.mixed_dispatches > 1 and \
        eng.stats.decode_iterations > eng.stats.dispatches \
        - eng.stats.mixed_dispatches              # decode rode along
    MemoryPlane.of(pool).check_invariants()


ONLINE = 'qwen3-0.6b'


def _node_archs():
    return ((ONLINE, 'online', 0), (PHI, 'offline', 10))


def _node_cfg(arch, side):
    kw = dict(page_size=PG)
    if arch == PHI:
        kw['n_experts'] = E
    return (j_reduced(j_get_config(arch), **kw) if side == 'j'
            else tconfigs.reduced(tconfigs.get_config(arch), **kw))


def _burst(node):
    rng = np.random.default_rng(7)
    off = node.offline[0]
    rids = [off.submit(rng.integers(1, off.mcfg.vocab_size, 12).tolist(),
                       max_new_tokens=8) for _ in range(3)]
    for _ in range(4):
        node.step()
    on = node.online.submit(
        rng.integers(1, node.online.mcfg.vocab_size, 28).tolist(),
        max_new_tokens=12)
    node.drain(max_steps=5000)
    node.runtime.check_invariants()
    return [off.output_tokens(r) for r in rids], node.online.output_tokens(on)


def test_offline_moe_node_matches_reference_node():
    """Online qwen3-0.6b beside an offline phi3.5-moe engine on one pool:
    an online burst reclaims the MoE engine's handles; tokens, dispatch
    counts, the event census and the invariants equal the reference
    node's."""
    jparams = [_f32(j_build_model(_node_cfg(a, 'j')).init_params(
        jax.random.PRNGKey(s))) for a, _, s in _node_archs()]
    jnode = JNodeOrchestrator(JValveRuntime(
        JKVPool(5, 4, page_size=PG, reserved_handles=1),
        JRuntimeConfig(n_devices=1, t_cool_init=0.002),
        clock=JVirtualClock()), idle_advance=1e-3)
    node = NodeOrchestrator(ValveRuntime(
        KVPool(5, 4, page_size=PG, reserved_handles=1),
        RuntimeConfig(n_devices=1, t_cool_init=0.002), clock=VirtualClock()),
        idle_advance=1e-3)
    for (arch, klass, _), p in zip(_node_archs(), jparams):
        ecfg = dict(max_batch=4, max_seq=48, prefill_chunk=8, klass=klass)
        jeng = jnode.add_engine(_node_cfg(arch, 'j'), JEngineConfig(**ecfg),
                                params=p)
        jeng.cache = _f32(jeng.cache)
        eng = node.add_engine(_node_cfg(arch, 't'), EngineConfig(**ecfg),
                              params=params_from_jax(
                                  jax.tree.map(np.asarray, p)), device='cpu')
        eng.cache = {k: v.float() for k, v in eng.cache.items()}
    assert _burst(node) == _burst(jnode)
    m, jm = node.metrics(), jnode.metrics()
    for key in ('compute_preemptions', 'reclamations', 'offline_wakeups',
                'offline_recomputed_tokens', 'max_preemptions_per_request',
                'online_dispatches', 'offline_dispatches', 'gated_skips',
                'offline_finished'):
        assert m[key] == jm[key], key
    assert m['reclamations'] > 0 and m['max_preemptions_per_request'] <= 1
    assert dict(node.runtime.bus.published) == dict(jnode.runtime.bus.published)
    for name, em in m['engines'].items():
        for key in ('dispatches', 'mixed_dispatches', 'tokens'):
            assert em[key] == jm['engines'][name][key], (name, key)
    assert node.offline[0].stats.invalidations == \
        jnode.offline[0].stats.invalidations
    assert node.runtime.clock.now() == jnode.runtime.clock.now()


def test_serve_demo_with_an_offline_moe_engine():
    """``python -m repro_torch.launch.serve --offline-arch
    phi3.5-moe-42b-a6.6b``'s node (reduced widths, as the CLI builds it)
    on a virtual clock: invariants, at most one preemption per request,
    every offline request finished."""
    from repro_torch.launch.serve import serve_demo
    m = serve_demo(offline_archs=(PHI,), steps=50, seed=0,
                   clock=VirtualClock(), quiet=True, device='cpu')
    assert m['max_preemptions_per_request'] <= 1
    assert m['offline_finished'] == 6 and m['online_finished'] > 0
    em = m['engines'][f'offline0:{PHI}']
    assert em['arch'] == f'{PHI}-reduced' and em['mixed_dispatches'] > 0


def _rescue_nodes(jparams):
    """Runtime pool A (tight) + auxiliary pool B, as
    ``test_torch_node.py``'s rescue node, with offline phi3.5-moe engines
    on both pools (one weight set): the reference's node and the port's."""
    nodes = []
    for side, (KV, RT, RC, VC, NO, EC) in (
            ('j', (JKVPool, JValveRuntime, JRuntimeConfig, JVirtualClock,
                   JNodeOrchestrator, JEngineConfig)),
            ('t', (KVPool, ValveRuntime, RuntimeConfig, VirtualClock,
                   NodeOrchestrator, EngineConfig))):
        node = NO(RT(KV(5, 4, page_size=PG, reserved_handles=1,
                        name='poolA'),
                     RC(n_devices=1, t_cool_init=0.002), clock=VC()),
                  idle_advance=1e-3)
        pool_b = node.add_pool(KV(8, 4, page_size=PG, name='poolB'))
        for (arch, klass, _), p, name, pool in zip(
                _node_archs() + _node_archs()[1:], jparams + jparams[1:],
                ('online', 'offA', 'offB'), (None, None, pool_b)):
            kw = dict(params=p, name=name, pool=pool)
            if side == 't':
                kw.update(params=params_from_jax(jax.tree.map(np.asarray, p)),
                          device='cpu')
            eng = node.add_engine(_node_cfg(arch, side), EC(
                max_batch=4, max_seq=48, prefill_chunk=8, klass=klass), **kw)
            eng.cache = (_f32(eng.cache) if side == 'j' else
                         {k: v.float() for k, v in eng.cache.items()})
        nodes.append(node)
    return nodes


def test_cross_pool_rescue_of_an_moe_engine_matches_reference():
    """An online burst migrates the MoE engine's leases to pool B; the
    rescued requests resume there with a one-token chunk, as in the
    reference: the same outputs, rescues and dispatch counts, and nothing
    recomputed."""
    jparams = [_f32(j_build_model(_node_cfg(a, 'j')).init_params(
        jax.random.PRNGKey(s))) for a, _, s in _node_archs()]
    outs = []
    for node in _rescue_nodes(jparams):
        rng = np.random.default_rng(7)
        eng = node.names['offA']
        rids = [eng.submit(rng.integers(1, eng.mcfg.vocab_size, 12).tolist(),
                           max_new_tokens=8) for _ in range(2)]
        for _ in range(4):
            node.step()
        node.online.submit(
            rng.integers(1, node.online.mcfg.vocab_size, 28).tolist(),
            max_new_tokens=12)
        node.drain(max_steps=5000)
        node.runtime.check_invariants()
        dst = node.names['offB']
        outs.append(([node.engine_of(r).output_tokens(r) for r in rids],
                     list(node.rescues), dst.stats.tokens_recomputed,
                     dst.stats.mixed_dispatches, dst.stats.dispatches))
    assert outs[1] == outs[0]
    assert outs[1][1], 'no request was rescued'
    assert outs[1][2] == 0
