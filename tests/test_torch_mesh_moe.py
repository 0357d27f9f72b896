"""MoE serving over a mesh in the port (``EngineConfig.mesh``: experts over
``model``, rows over ``data``; ``models/moe.py``, ``distributed/tp.py``)
against the reference's MoE engine on the same virtual mesh and against
the port's meshless MoE engine, and ``moe_mlp(tp=)`` against
``repro.models.moe.moe_mlp``.

Ranks are processes (``launch.ranks.run_ranks``, gloo on the CPU); every
rank first runs the ``moe_mlp`` cases together (SPMD), then rank 0 drains
the engines and the others serve.  The configs run at 16 experts
(``reduced(cfg, n_experts=16)``): at the reduced default of 4 the serving
capacity never drops a token.  f32 throughout: greedy tokens equal,
``moe_mlp`` outputs within 1e-4 of the reference's (another summation
order), the aux loss within 1e-6 relative.  The ranks import no jax; the
reference runs in this process.
"""
import sys

import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_jax, shard_params
from repro_torch.configs import get_config, reduced
from repro_torch.core.clock import VirtualClock
from repro_torch.core.memory import MemoryPlane
from repro_torch.distributed.tp import TensorParallel, serve_rank, stop_ranks
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.ranks import run_ranks
from repro_torch.models import moe as tmoe
from repro_torch.models.api import build_model
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.kvpool import KVPool

PHI, SCOUT = 'phi3.5-moe-42b-a6.6b', 'llama4-scout-17b-a16e'
RANK_TIMEOUT_S = 120
AXES = ('data', 'model')
ECFG = dict(max_batch=4, max_seq=40, prefill_chunk=8)
ATOL = 1e-4
# moe_mlp cases: (arch, reduced() overrides); 5 experts over model 2 cut
# each expert's d_ff instead; llama4-scout adds the shared expert
MLP_CASES = {'phi16': (PHI, dict(n_experts=16)),
             'phi5-ffn': (PHI, dict(n_experts=5)),
             'scout16': (SCOUT, dict(n_experts=16))}
CAPACITY = (1.25, 2.0)


def _cfg(arch=PHI, **kw):
    return reduced(get_config(arch), page_size=4, **kw)


def _flat(tree, prefix=''):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f'{prefix}{k}/'))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def _unflat(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split('/')
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def _prompts(vocab):
    """Five requests, four behind the first's published 2-page prefix."""
    rng = np.random.default_rng(3)
    prefix = rng.integers(1, vocab, 8).tolist()
    return [prefix + rng.integers(1, vocab, n).tolist()
            for n in (5, 13, 9, 17, 6)]


def _mlp_input(d):
    """(4, 8, D) rows whose last two repeat one vector, as an engine's
    padding rows do: they route alike, and the capacity drops."""
    x = np.random.default_rng(5).normal(size=(4, 8, d)).astype(np.float32)
    x[2:] = x[2, 0]
    return x


def drain(model, params, mesh=None, **ecfg):
    """The first request decodes alone, then the rest arrive and share
    mixed dispatches with its decode rows (the reference's MoE dispatch
    shape); f32 pool, prefix sharing on.  -> (tokens, engine)."""
    pool = KVPool(16, 4, page_size=4, reserved_handles=1)
    MemoryPlane(pool, sharing=True)
    eng = Engine(model, params, pool, EngineConfig(**ECFG, mesh=mesh, **ecfg),
                 clock=VirtualClock(), device='cpu')
    eng.cache = {k: v.float() for k, v in eng.cache.items()}
    prompts = _prompts(model.cfg.vocab_size)
    rids = [eng.submit(prompts[0], max_new_tokens=10)]
    for _ in range(20):
        eng.step()
        if len(eng.requests[rids[0]].generated) >= 2:
            break
    rids += [eng.submit(p, max_new_tokens=10) for p in prompts[1:]]
    eng.run_to_completion()
    return [eng.output_tokens(r) for r in rids], eng


def _mlp_cases(mesh, npzs):
    """Every rank's ``moe_mlp(tp=)`` output and aux loss on layer 0 of each
    case's weights, at both capacity factors."""
    out = {}
    for name, (arch, kw) in MLP_CASES.items():
        model = build_model(_cfg(arch, **kw))
        tp = TensorParallel(model.cfg, mesh)
        params = shard_params(_unflat(dict(np.load(npzs[name]))), model,
                              mesh)
        lp = {k: w[0] for k, w in params['layers'].items()}
        x = torch.from_numpy(_mlp_input(model.cfg.d_model))
        for cf in CAPACITY:
            y, aux = tmoe.moe_mlp(model.cfg, lp, x, capacity_factor=cf,
                                  tp=tp)
            out[name, cf] = (y.numpy(), float(aux), tp.experts_partial,
                             tp.expert_split)
    return out


def _moe_rank(rank, shape, npz, npzs):
    """One rank: the ``moe_mlp`` cases; then rank 0 drains the engine
    (plain path, then every kernel path), counting its drops, and gathers
    the pool; the others serve."""
    torch.set_num_threads(1)
    mesh = make_mesh(shape, AXES, device='cpu')
    mlp = _mlp_cases(mesh, npzs)
    if rank != 0:
        return dict(serve_rank(mesh), mlp=mlp, jax='jax' in sys.modules)
    drops = [0]
    route = tmoe.route

    def counted(*a, **kw):
        r = route(*a, **kw)
        drops[0] += int((r[3] >= r[4]).sum())
        return r
    tmoe.route = counted
    try:
        model = build_model(_cfg(n_experts=16))
        tree = _unflat(dict(np.load(npz)))
        toks, eng = drain(model, params_from_jax(tree), mesh)
        ktoks, keng = drain(model, params_from_jax(tree), mesh,
                            decode_kernel=True, prefix_shared_attention=True)
        gathered = {k: v.numpy() for k, v in keng.gather_cache().items()}
        out = {'tokens': toks, 'kernel_tokens': ktoks, 'drops': drops[0],
               'gathered': gathered, 'mlp': mlp,
               'split': eng._tp.split_rows, 'experts': eng._tp.experts,
               'saved': keng.stats.shared_page_reads_saved,
               'shape': tuple(eng.cache['k'].shape),
               'jax': 'jax' in sys.modules}
        eng.close()
        keng.close()
        return out
    finally:
        tmoe.route = route
        stop_ranks(mesh)


def _jax():
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as j_get_config
    from repro.configs import reduced as j_reduced
    from repro.models.api import build_model as j_build_model
    return jax, jnp, lambda arch, **kw: j_build_model(
        j_reduced(j_get_config(arch), page_size=4, **kw))


def _jparams(jmodel, seed):
    jax, jnp, _ = _jax()
    return jax.tree.map(lambda x: x.astype(jnp.float32),
                        jmodel.init_params(jax.random.PRNGKey(seed)))


def _reference_drain(jmodel, jparams, mesh):
    from repro.core.memory import MemoryPlane as JMemoryPlane
    from repro.serving.engine import Engine as JEngine
    from repro.serving.engine import EngineConfig as JEngineConfig
    from repro.serving.kvpool import KVPool as JKVPool

    jax, jnp, _ = _jax()
    pool = JKVPool(16, 4, page_size=4, reserved_handles=1)
    JMemoryPlane(pool, sharing=True)
    eng = JEngine(jmodel, jparams, pool, JEngineConfig(**ECFG, mesh=mesh),
                  clock=VirtualClock())
    eng.cache = jax.tree.map(lambda x: x.astype(jnp.float32), eng.cache)
    prompts = _prompts(jmodel.cfg.vocab_size)
    rids = [eng.submit(prompts[0], max_new_tokens=10)]
    for _ in range(20):
        eng.step()
        if len(eng.requests[rids[0]].generated) >= 2:
            break
    rids += [eng.submit(p, max_new_tokens=10) for p in prompts[1:]]
    eng.run_to_completion()
    return [eng.output_tokens(r) for r in rids]


@pytest.mark.parametrize('shape', [(1, 2), (2, 2)], ids=['1x2', '2x2'])
def test_moe_mesh_matches_reference_and_meshless(shape, make_virtual_mesh,
                                                 tmp_path):
    """The MoE engine with 8 experts a rank (and at (2, 2) its rows over
    data, routed as one dispatch): greedy f32 tokens, plain and kernel
    paths, equal to the reference's drain on the same virtual mesh and to
    the port's meshless drain, with drops in the calls; the gathered pool
    within 1e-4 of the meshless pool.  ``moe_mlp(tp=)`` on every rank
    equal to the reference's ``moe_mlp`` (its outputs bit-equal across the
    ranks), with whole experts a rank, with each expert's d_ff cut (5
    experts over model 2) and with a shared expert."""
    jax, jnp, jmodel_of = _jax()
    from repro.models import moe as jmoe

    jmodel = jmodel_of(PHI, n_experts=16)
    jparams = _jparams(jmodel, 0)
    want = _reference_drain(jmodel, jparams, make_virtual_mesh(shape, AXES))
    tree = jax.tree.map(np.asarray, jparams)
    npz = tmp_path / 'params.npz'
    np.savez(npz, **_flat(tree))
    model = build_model(_cfg(n_experts=16))
    single, seng = drain(model, params_from_jax(tree))
    ksingle, _ = drain(model, params_from_jax(tree), decode_kernel=True,
                       prefix_shared_attention=True)

    npzs, mlp_want = {}, {}
    for name, (arch, kw) in MLP_CASES.items():
        jm = jmodel_of(arch, **kw)
        jp = _jparams(jm, 1)
        npzs[name] = str(tmp_path / f'{name}.npz')
        np.savez(npzs[name], **_flat(jax.tree.map(np.asarray, jp)))
        jlp = jax.tree.map(lambda w: w[0], jp['layers'])
        x = jnp.asarray(_mlp_input(jm.cfg.d_model))
        for cf in CAPACITY:
            y, aux = jmoe.moe_mlp(jm.cfg, jlp, x, capacity_factor=cf)
            mlp_want[name, cf] = (np.asarray(y), float(aux))

    out = run_ranks(_moe_rank, int(np.prod(shape)), store_dir=tmp_path,
                    device_type='cpu', args=(shape, str(npz), npzs),
                    timeout_s=RANK_TIMEOUT_S)
    lead = out[0]
    assert not any(o['jax'] for o in out)
    assert all(len(t) == 10 for t in want)
    assert lead['tokens'] == want == single
    assert lead['kernel_tokens'] == ksingle == single
    assert lead['drops'] > 0 and lead['saved'] > 0
    assert lead['split'] == (shape[0] > 1)
    assert lead['experts'] == (0, 8)
    cfg = model.cfg
    assert lead['shape'][3] == cfg.n_kv_heads // shape[1]
    for k, v in seng.cache.items():
        np.testing.assert_allclose(lead['gathered'][k], v.numpy(),
                                   rtol=1e-4, atol=1e-4)
    for key, (y, aux) in mlp_want.items():
        got = [o['mlp'][key] for o in out]
        assert got[0][2], key                     # a partial over model
        assert got[0][3] == (key[0] != 'phi5-ffn'), key
        np.testing.assert_allclose(got[0][0], y, rtol=0, atol=ATOL,
                                   err_msg=str(key))
        assert got[0][1] == pytest.approx(aux, rel=1e-6), key
        assert all(np.array_equal(g[0], got[0][0]) and g[1] == got[0][1]
                   for g in got), key
