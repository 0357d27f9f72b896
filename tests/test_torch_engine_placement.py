"""The mesh engine under the reference engine's placement
(``distributed.tp.engine_plan``: ``tree_spec_shaped(..., SERVE_RULES,
mesh)``).  Where ``model`` does not divide the kv-heads -- every served
architecture's 8 at ``model`` 16 -- each engine rank holds a block of RoPE
pairs of every kv-head in ``wq``/``wk``/``wv``/``wo`` and in the global
pool, its decode and chunk reads sum the f32 partial scores over
``model``, and the kernels that read whole heads (K1, K2, K3) are refused.

(a) shape only: every param leaf's and the pool's block of every served
architecture, at its published widths, against the reference's
``shaped_spec`` (``repro.distributed.sharding``), each leaf covered once.
(b)-(d) gloo ranks at ``reduced()`` widths, f32 (greedy tokens exactly
equal): dense at (4,) and (data 2, model 4), MoE at (1, 4), against the
reference engine's drain on the conftest's virtual mesh and the port's
meshless drain; a planted unsummed partial score; the refusals, fused
sampling, the pool's gather and copy; the preemption bound of
``chip_smoke.mesh_burst``'s burst.  The ranks import no jax: the
reference runs in this process only.
"""
import dataclasses
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_jax, shard_params
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tp as tplib
from repro_torch.launch.mesh import describe, make_mesh
from repro_torch.launch.ranks import run_ranks
from repro_torch.models.api import build_model

import test_torch_mesh_engine as dense_case
import test_torch_mesh_moe as moe_case

ROOT = Path(__file__).resolve().parents[1]
SERVED = ('qwen3-0.6b', 'qwen3-14b', 'internlm2-1.8b', 'command-r-35b',
          'llava-next-mistral-7b', 'valve-7b', 'phi3.5-moe-42b-a6.6b',
          'llama4-scout-17b-a16e')
DM, PDM, MODEL = ('data', 'model'), ('pod', 'data', 'model'), ('model',)
LAYOUTS = {'m2': ((2, 2), DM), 'm4': ((2, 4), DM), 'm16': ((16, 16), DM),
           'pod': ((2, 16, 16), PDM)}
POOL_PAGES = 64
BF16 = 2
TOL = 1e-4
RANK_TIMEOUT_S = 180


# ---------------------------------------------------------------------------
# (a) the blocks against the reference's shaped_spec (shape only)
# ---------------------------------------------------------------------------

def _reference_spec(shape, axes, mesh):
    from repro.distributed.sharding import shaped_spec as j_shaped_spec

    return tuple(j_shaped_spec(shape, axes, shd.SERVE_RULES, mesh))


def _volume(block) -> int:
    return int(np.prod(block.local_shape))


def _disjoint(a, b) -> bool:
    """Whether two blocks share no element: on some dimension no interval
    of one meets an interval of the other."""
    return any(not any(lo < h and l < hi for lo, hi in a.intervals(d)
                       for l, h in b.intervals(d))
               for d in range(len(a.shape)))


def _check_leaf(what, shape, axes, blocks, mesh):
    """Every rank's block holds the bytes of the reference's; the distinct
    blocks are disjoint and cover the leaf once (the batch axes' replicas
    hold the same block)."""
    spec = _reference_spec(shape, axes, mesh)
    for r, b in enumerate(blocks):
        want = shd.local_bounds(shape, spec, mesh, mesh.coords(r))
        assert _volume(b) == _volume(want), (what, r, b, want, spec)
    distinct = list(dict.fromkeys(blocks))
    assert sum(map(_volume, distinct)) == int(np.prod(shape)), what
    assert all(_disjoint(a, b) for i, a in enumerate(distinct)
               for b in distinct[i + 1:]), what


def _rank_bytes(model, plan, n_pages):
    """(weight bytes, pool bytes a page) of ``plan``'s rank in bf16."""
    weights = sum(_volume(plan.block(path, shape))
                  for path, shape in _leaves(model.param_shapes()))
    pool = model.cache_template(engine_pages=n_pages)
    page = sum(_volume(plan.pool_block(leaf.shape)) for leaf in pool.values())
    return BF16 * weights, BF16 * page // n_pages


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize('layout', list(LAYOUTS))
@pytest.mark.parametrize('arch', SERVED)
def test_engine_blocks_hold_the_reference_bytes(arch, layout):
    """Every param leaf's and the pool's block under the engine's plan
    holds the bytes of the reference engine's ``tree_spec_shaped`` block,
    each leaf covered once; where ``model`` does not divide the 8
    kv-heads, the plan holds RoPE pairs of every kv-head."""
    shape, axes = LAYOUTS[layout]
    mesh = describe(shape, axes)
    model = build_model(get_config(arch))
    plans = [tplib.engine_plan(model.cfg, mesh, mesh.coords(r), max_batch=4)
             for r in range(mesh.size)]
    n = mesh.shape['model']
    assert all(p.pair_cut == (model.cfg.n_kv_heads % n != 0) for p in plans)
    assert not any(p.embed_cut for p in plans)
    p_axes = model.param_axes()
    for path, leaf_shape in _leaves(model.param_shapes()):
        leaf_axes = p_axes
        for k in path:
            leaf_axes = leaf_axes[k]
        _check_leaf('/'.join(path), leaf_shape, leaf_axes,
                    [p.block(path, leaf_shape) for p in plans], mesh)
    for key, leaf in model.cache_template(engine_pages=POOL_PAGES).items():
        _check_leaf(key, leaf.shape, leaf.axes,
                    [p.pool_block(leaf.shape) for p in plans], mesh)


@pytest.mark.parametrize('layers,shape,want', [
    (40, (16, 16), (1_846_835_200, 163_840)),
    (2, (1, 16), (277_105_664, 8_192)),
], ids=['qwen3-14b-16x16', 'qwen3-14b-2-layers-1x16'])
def test_qwen3_14b_rank_bytes_are_pinned(layers, shape, want):
    """qwen3-14b's rank 0 in bf16: its weight bytes and a pool page's
    bytes (phase 24's cut on the second line), the reference's."""
    cfg = dataclasses.replace(get_config('qwen3-14b'), n_layers=layers)
    model = build_model(cfg)
    mesh = describe(shape, DM)
    plan = tplib.engine_plan(cfg, mesh, mesh.coords(0))
    assert plan.pair_cut and plan.pairs == (0, 4)
    assert _rank_bytes(model, plan, POOL_PAGES) == want


# ---------------------------------------------------------------------------
# The ranks (no jax)
# ---------------------------------------------------------------------------

class _Scores:
    """A model whose engine entries keep their f32 scores (rank 0's side
    of a drain)."""

    def __init__(self, model):
        self.model, self.scores = model, []

    def __getattr__(self, name):
        return getattr(self.model, name)

    def prefill_chunk_fn(self, params, cache, batch, **kw):
        cache, scores = self.model.prefill_chunk_fn(params, cache, batch,
                                                    **kw)
        self.scores.append(scores.clone())
        return cache, scores

    def decode_fn(self, params, cache, batch, **kw):
        cache, scores = self.model.decode_fn(params, cache, batch, **kw)
        self.scores.append(scores.clone())
        return cache, scores


def _unsummed(self, scores):
    """The planted fault: this rank takes part in the all-reduce of the
    partial scores (the ranks' collectives still match) and goes on with
    its own."""
    tplib.TensorParallel.score_sum(self, scores.clone())
    return scores


def _faulty_blocks(tree):
    """``serve_rank``'s ``blocks``: this rank's blocks of the reference's
    weights under the engine's plan; on ``model`` rank 1 the plan's
    partial scores go unsummed (:func:`_unsummed`)."""
    def blocks(cfg, plan):
        if plan.rank == 1:
            plan.score_sum = types.MethodType(_unsummed, plan)
        return shard_params(tree, build_model(cfg), plan.mesh, plan=plan)
    return blocks


def _gathered(eng):
    return {k: v.numpy() for k, v in eng.gather_cache().items()}


def _dense_side(mesh, tree):
    """Rank 0's dense drains on a pair-cut mesh: the reference trace
    (scores kept), its pool gathered; the refusals; the fused drain of the
    prefix trace, into which the first engine's pages are copied; the
    planted fault; the burst."""
    from chip_smoke import mesh_burst
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.serving.kvpool import KVPool

    model = build_model(dense_case._cfg())
    rec = _Scores(model)
    toks, eng = dense_case.drain(rec, params_from_jax(tree), mesh)
    out = {'tokens': toks, 'scores': [s.numpy() for s in rec.scores],
           'gathered': _gathered(eng), 'pair_cut': eng._tp.pair_cut,
           'shape': tuple(eng.cache['k'].shape),
           'use_kernel': eng._use_kernel}
    own = eng._tp.pool_block(out['gathered']['k'].shape)
    out['own_exact'] = all(
        np.array_equal(own.take(out['gathered'][k]), eng.cache[k].numpy())
        for k in ('k', 'v'))
    out['refused'] = {}
    for flag in ('decode_kernel', 'prefix_shared_attention'):
        try:
            Engine(model, params_from_jax(tree), KVPool(8, 4, page_size=4),
                   EngineConfig(mesh=mesh, **{flag: True}), device='cpu')
        except ValueError as e:
            out['refused'][flag] = str(e)
    ftoks, feng = dense_case.drain(model, params_from_jax(tree), mesh,
                                   fused_sampling=True)
    out['fused'] = ftoks
    feng.copy_kv_from(eng, [1, 2, 3], [5, 6, 7])
    moved = _gathered(feng)
    out['copied'] = all(np.array_equal(moved[k][:, 5:8],
                                       out['gathered'][k][:, 1:4])
                        for k in moved)
    eng.close()
    feng.close()
    bad = _Scores(model)
    blocks = shard_params(tree, model, mesh,
                          plan=tplib.engine_plan(model.cfg, mesh))
    out['fault_tokens'], beng = dense_case.drain(bad, blocks, mesh)
    out['fault_scores'] = [s.numpy() for s in bad.scores]
    beng.close()
    out['burst'] = mesh_burst(model.cfg, mesh, 'cpu')
    return out


def _moe_side(mesh, tree):
    model = build_model(moe_case._cfg(n_experts=16))
    toks, eng = moe_case.drain(model, params_from_jax(tree), mesh)
    out = {'tokens': toks, 'gathered': _gathered(eng),
           'pair_cut': eng._tp.pair_cut, 'experts': eng._tp.experts,
           'shape': tuple(eng.cache['k'].shape)}
    eng.close()
    return out


def _four_ranks(rank, dense_npz, moe_npz):
    """Dense on (4,) (the reference trace, the refusals, fused sampling,
    the pool's gather and copy, the planted fault, the burst), then MoE on
    (data 1, model 4)."""
    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT))
    dense = dense_case._unflat(dict(np.load(dense_npz)))
    moe = moe_case._unflat(dict(np.load(moe_npz)))
    out = {'jax': False}
    for key, shape, axes, side, tree in (
            ('dense', (4,), MODEL, _dense_side, dense),
            ('moe', (1, 4), DM, _moe_side, moe)):
        mesh = make_mesh(shape, axes, device='cpu')
        if rank != 0:
            out[key] = tplib.serve_rank(mesh, blocks=_faulty_blocks(tree))
            continue
        try:
            out[key] = side(mesh, tree)
        finally:
            tplib.stop_ranks(mesh)
    out['jax'] = 'jax' in sys.modules
    return out


def _eight_ranks(rank, dense_npz):
    """Dense on (data 2, model 4): the reference trace, the pool gathered
    (the data replicas bit-equal: ``gather_cache`` checks)."""
    torch.set_num_threads(1)
    mesh = make_mesh((2, 4), DM, device='cpu')
    if rank != 0:
        return dict(tplib.serve_rank(mesh), jax='jax' in sys.modules)
    try:
        tree = dense_case._unflat(dict(np.load(dense_npz)))
        toks, eng = dense_case.drain(build_model(dense_case._cfg()),
                                     params_from_jax(tree), mesh)
        out = {'tokens': toks, 'gathered': _gathered(eng),
               'pair_cut': eng._tp.pair_cut, 'split': eng._tp.split_rows,
               'shape': tuple(eng.cache['k'].shape),
               'jax': 'jax' in sys.modules}
        eng.close()
        return out
    finally:
        tplib.stop_ranks(mesh)


# ---------------------------------------------------------------------------
# (b)-(d): the drains
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def world(make_virtual_mesh, tmp_path_factory):
    """The reference's mesh drains (this process), the port's meshless
    drains, and the two rank runs."""
    import jax

    tmp = tmp_path_factory.mktemp('engine_placement')
    tree, want = dense_case._reference({}, (4,), MODEL, make_virtual_mesh)
    want_dm = dense_case._reference({}, (2, 4), DM, make_virtual_mesh)[1]
    jmodel = moe_case._jax()[2](moe_case.PHI, n_experts=16)
    jparams = moe_case._jparams(jmodel, 0)
    moe_want = moe_case._reference_drain(jmodel, jparams,
                                         make_virtual_mesh((1, 4), DM))
    moe_tree = jax.tree.map(np.asarray, jparams)
    npzs = {}
    for name, t in (('dense', tree), ('moe', moe_tree)):
        npzs[name] = str(tmp / f'{name}.npz')
        np.savez(npzs[name], **dense_case._flat(t))

    model = build_model(dense_case._cfg())
    rec = _Scores(model)
    single, seng = dense_case.drain(rec, params_from_jax(tree))
    fused, _ = dense_case.drain(model, params_from_jax(tree),
                                fused_sampling=True)
    mmodel = build_model(moe_case._cfg(n_experts=16))
    msingle, mseng = moe_case.drain(mmodel, params_from_jax(moe_tree))
    four = run_ranks(_four_ranks, 4, store_dir=tmp / 'four',
                     device_type='cpu', args=(npzs['dense'], npzs['moe']),
                     timeout_s=RANK_TIMEOUT_S)
    eight = run_ranks(_eight_ranks, 8, store_dir=tmp / 'eight',
                      device_type='cpu', args=(npzs['dense'],),
                      timeout_s=RANK_TIMEOUT_S)
    return {'want': want, 'want_dm': want_dm, 'moe_want': moe_want,
            'single': single, 'single_scores': [s.numpy()
                                                for s in rec.scores],
            'single_pool': {k: v.numpy() for k, v in seng.cache.items()},
            'fused_single': fused, 'moe_single': msingle,
            'moe_pool': {k: v.numpy() for k, v in mseng.cache.items()},
            'four': four, 'eight': eight, 'cfg': model.cfg}


def _gap(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def _pool_close(got, want):
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=TOL, atol=TOL)


def _pair_shapes(shapes, cfg, n):
    assert shapes and all(s[3:] == (cfg.n_kv_heads, cfg.hd // n)
                          for s in shapes), shapes


def test_dense_drain_on_pair_blocks_matches_reference_and_meshless(world):
    """(b) dense at (4,): the reduced config's 2 kv-heads over 4 ranks,
    RoPE pairs of every kv-head; greedy tokens equal to the reference's
    mesh drain and the meshless drain, every dispatch's scores within 1e-4
    of |max|, the gathered pool within 1e-4, each rank's pool block (...,
    Hkv, Dh/4), the plain path (decode_kernel=None)."""
    lead, cfg = world['four'][0]['dense'], world['cfg']
    assert not any(o['jax'] for o in world['four'] + world['eight'])
    assert lead['pair_cut'] and not lead['use_kernel']
    assert all(len(t) == 8 for t in world['want'])
    assert lead['tokens'] == world['want'] == world['single']
    assert len(lead['scores']) == len(world['single_scores'])
    assert max(_gap(a, b) for a, b in zip(lead['scores'],
                                         world['single_scores'])) <= TOL
    _pool_close(lead['gathered'], world['single_pool'])
    _pair_shapes([lead['shape']] + [
        s for o in world['four'][1:] for s in
        o['dense']['cache_shapes'].values()], cfg, 4)


def test_data_and_pair_blocks_match_reference_and_meshless(world):
    """(b) dense at (data 2, model 4): the rows over data, RoPE pairs over
    model; tokens equal to the reference's drain on that virtual mesh and
    to the meshless drain, the gathered pool within 1e-4 (the two data
    replicas of each block bit-equal: the gather checks them)."""
    lead = world['eight'][0]
    assert lead['pair_cut'] and lead['split']
    assert lead['tokens'] == world['want_dm'] == world['single']
    _pool_close(lead['gathered'], world['single_pool'])
    _pair_shapes([lead['shape']] + [s for o in world['eight'][1:]
                                    for s in o['cache_shapes'].values()],
                 world['cfg'], 4)


def test_moe_drain_on_pair_blocks_matches_reference_and_meshless(world):
    """(b) MoE at (data 1, model 4): 4 experts a rank and RoPE pairs of
    every kv-head; tokens equal to the reference's drain and the meshless
    drain, the gathered pool within 1e-4."""
    lead = world['four'][0]['moe']
    assert lead['pair_cut'] and lead['experts'] == (0, 4)
    assert all(len(t) == 10 for t in world['moe_want'])
    assert lead['tokens'] == world['moe_want'] == world['moe_single']
    _pool_close(lead['gathered'], world['moe_pool'])
    cfg = build_model(moe_case._cfg(n_experts=16)).cfg
    _pair_shapes([lead['shape']] + [s for o in world['four'][1:]
                                    for s in o['moe']['cache_shapes']
                                    .values()], cfg, 4)


def test_an_unsummed_partial_score_fails_the_gate(world):
    """(b) the planted fault: model rank 1's partial scores not summed
    over ``model`` in the engine opened on the ranks' own blocks; its
    first dispatch's scores (the same inputs as the meshless drain's) fall
    past the 1e-4 gate that the correct drain passes."""
    lead = world['four'][0]['dense']
    first = world['single_scores'][0]
    assert _gap(lead['scores'][0], first) <= TOL
    assert _gap(lead['fault_scores'][0], first) > TOL


def test_pair_cut_refuses_the_whole_head_kernels(world):
    """(c) ``decode_kernel=True`` and ``prefix_shared_attention=True``
    raise when the engine opens on a pair-cut mesh, naming the reason;
    nothing falls back."""
    refused = world['four'][0]['dense']['refused']
    assert set(refused) == {'decode_kernel', 'prefix_shared_attention'}
    assert all('K1, K2, K3' in why and 'S11' in why
               for why in refused.values())


def test_fused_sampling_and_the_pool_on_pair_blocks(world):
    """(c) fused sampling (K4's block form on every rank; its plain
    version here) draws the unfused drain's tokens and the meshless fused
    drain's; ``gather_cache`` places rank 0's pair block bit for bit, and
    ``copy_kv_from`` moves every rank's pair block bit for bit."""
    lead = world['four'][0]['dense']
    assert lead['fused'] == lead['tokens'] == world['fused_single']
    assert lead['own_exact'] and lead['copied']


def test_pair_cut_burst_keeps_one_preemption_per_request_and_device(world):
    """(d) ``chip_smoke.mesh_burst``'s burst on the pair-cut mesh of 4
    under a mesh ``ValveRuntime`` (a gate a device): at most one
    preemption per (request, device), ``check_invariants`` passing."""
    burst = world['four'][0]['dense']['burst']
    assert burst['gates'] == 4 and burst['latencies'] == [4], burst
    assert burst['events'] > 0 and burst['max_per_device'] <= 1, burst
    assert burst['finished'] == [1, 2], burst
