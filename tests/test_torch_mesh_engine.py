"""Serving over a mesh in the port (``EngineConfig.mesh``,
``distributed/tp.py``): tensor-parallel over ``model``, data-parallel over
the batch axes (``pod``, ``data``) and both, against the reference's mesh
engine (``tests/test_mesh_engine.py``) and against the port's own
single-device engine.

Ranks are processes: :func:`launch.ranks.run_ranks` spawns them (the
``spawn`` start method: this process holds JAX's threads) into a gloo
group on the CPU.  Rank 0 runs the engine, the others
``distributed.tp.serve_rank``.  The reference's weights go to the ranks as
an ``.npz`` (f32: bf16 widened, exact), and every drain runs in f32, so
greedy tokens must be exactly equal.  The ranks import no jax: this module
imports the reference only inside the tests that run in this process.
"""
import dataclasses
import sys

import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_jax, shard_params
from repro_torch.configs import get_config, reduced
from repro_torch.core.clock import VirtualClock
from repro_torch.core.memory import MemoryPlane
from repro_torch.distributed.tp import (TensorParallel, engine_plan,
                                        head_blocks, serve_rank, stop_ranks)
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.launch.ranks import run_ranks
from repro_torch.models.api import build_model
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.kvpool import KVPool

ARCH = 'qwen3-0.6b'
RANK_TIMEOUT_S = 120
KERNELS = dict(decode_kernel=True, fused_sampling=True,
               prefix_shared_attention=True)


def _cfg(**kw):
    return reduced(get_config(ARCH), page_size=4, **kw)


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
    """The reference test's three requests (its rng, its draw order)."""
    rng = np.random.default_rng(11)
    return [rng.integers(1, vocab, size=int(n)).tolist()
            for n in rng.integers(5, 20, size=3)]


def _shared_prompts(vocab):
    """Four requests behind one published 3-page prefix (page 4)."""
    rng = np.random.default_rng(3)
    prefix = rng.integers(1, vocab, 12).tolist()
    return [prefix + rng.integers(1, vocab, n).tolist() for n in (5, 2, 7)] \
        + [list(prefix)]


def drain(model, params, mesh=None, *, shared=False, **ecfg):
    """The reference test's drain (``shared``: the prefix trace, over a
    sharing memory plane, the first request published before the rest).
    Returns (tokens, engine); the pool is f32 (a mesh engine's takes the
    weights' dtype, f32 here)."""
    vocab = model.cfg.vocab_size
    if shared:
        pool = KVPool(16, 4, page_size=4, reserved_handles=1)
        MemoryPlane(pool, sharing=True)
        prompts, kw = _shared_prompts(vocab), dict(max_batch=3, max_seq=40)
    else:
        pool = KVPool(8, 4, page_size=4, reserved_handles=1)
        prompts, kw = _prompts(vocab), dict(max_batch=4, max_seq=48)
    eng = Engine(model, params, pool,
                 EngineConfig(prefill_chunk=8, mesh=mesh, **kw, **ecfg),
                 clock=VirtualClock(), device='cpu')
    eng.cache = {k: v.float() for k, v in eng.cache.items()}
    rids = [eng.submit(prompts[0], max_new_tokens=8)]
    if shared:
        for _ in range(20):                # publish the first prefix
            eng.step()
            if eng.requests[rids[0]].generated:
                break
    rids += [eng.submit(p, max_new_tokens=8) for p in prompts[1:]]
    eng.run_to_completion()
    pool.check_invariants()
    return [eng.output_tokens(r) for r in rids], eng


def _mesh_rank(rank, shape, axes, npz, cfg_kw):
    """One rank of a mesh run: rank 0 drains the reference trace (stock
    and with every kernel path on the prefix trace; where the engine's
    plan holds RoPE pairs of every kv-head, that drain is refused and a
    plain fused drain of the prefix trace runs in its place) and returns
    its tokens, its pool block's shape, the gathered pool (every replica
    bit-equal: ``gather_cache`` checks) and whether its weight blocks are
    the reference's weights cut by ``bridge.shard_params`` under the
    engine's plan (``tp.engine_plan``); the others serve and return their
    pool blocks' shapes."""
    mesh = make_mesh(shape, axes, device='cpu')
    if rank != 0:
        return dict(serve_rank(mesh), jax=('jax' in sys.modules))
    try:
        model = build_model(_cfg(**cfg_kw))
        tree = _unflat(dict(np.load(npz)))
        toks, eng = drain(model, params_from_jax(tree), mesh)
        cut = shard_params(tree, model, mesh,
                           plan=engine_plan(model.cfg, mesh))
        committed = all(torch.equal(eng.params['layers'][k], w)
                        for k, w in cut['layers'].items()) and \
            torch.equal(eng.params['embed'], cut['embed'])
        gathered = {k: v.numpy() for k, v in eng.gather_cache().items()}
        shape = tuple(eng.cache['k'].shape)
        refused = None
        if eng._tp.pair_cut:
            try:
                drain(model, params_from_jax(tree), mesh, shared=True,
                      **KERNELS)
            except ValueError as e:
                refused = str(e)
            ktoks, keng = drain(model, params_from_jax(tree), mesh,
                                shared=True, fused_sampling=True)
        else:
            ktoks, keng = drain(model, params_from_jax(tree), mesh,
                                shared=True, **KERNELS)
        # a KV handoff between two mesh engines copies every rank's block
        keng.copy_kv_from(eng, [1, 2, 3], [5, 6, 7])
        moved = keng.gather_cache()
        copied = all(torch.equal(moved[k][:, 5:8],
                                 torch.from_numpy(gathered[k][:, 1:4]))
                     for k in moved)
        eng.close()
        keng.close()
        return {'tokens': toks, 'kernel_tokens': ktoks, 'shape': shape,
                'gathered': gathered, 'committed': committed,
                'copied': copied,
                'saved': keng.stats.shared_page_reads_saved,
                'refused': refused, 'pair_cut': eng._tp.pair_cut,
                'split': (eng._tp.split_rows, keng._tp.split_rows),
                'jax': 'jax' in sys.modules}
    finally:
        stop_ranks(mesh)


def _reference(cfg_kw, shape, axes, make_virtual_mesh):
    """(f32 weights as numpy, the reference's drain over a virtual mesh of
    ``shape`` on ``axes``)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as j_get_config
    from repro.configs import reduced as j_reduced
    from repro.models.api import build_model as j_build_model
    from repro.serving.engine import Engine as JEngine
    from repro.serving.engine import EngineConfig as JEngineConfig
    from repro.serving.kvpool import KVPool as JKVPool

    f32 = lambda t: jax.tree.map(lambda x: x.astype(jnp.float32), t)  # noqa
    jmodel = j_build_model(j_reduced(j_get_config(ARCH), page_size=4,
                                     **cfg_kw))
    jparams = f32(jmodel.init_params(jax.random.PRNGKey(0)))
    pool = JKVPool(8, 4, page_size=4, reserved_handles=1)
    eng = JEngine(jmodel, jparams, pool,
                  JEngineConfig(max_batch=4, max_seq=48, prefill_chunk=8,
                                mesh=make_virtual_mesh(shape, axes)),
                  clock=VirtualClock())
    eng.cache = f32(eng.cache)
    rids = [eng.submit(p, max_new_tokens=8)
            for p in _prompts(jmodel.cfg.vocab_size)]
    eng.run_to_completion()
    return (jax.tree.map(np.asarray, jparams),
            [eng.output_tokens(r) for r in rids])


MODEL = ('model',)
DM = ('data', 'model')
PDM = ('pod', 'data', 'model')


@pytest.mark.parametrize('shape,axes,cfg_kw', [
    ((2,), MODEL, {}),                      # kv 2 / 2: GQA group 2
    ((4,), MODEL, {}),                      # kv 2 at 4: RoPE pairs (hd 16)
    ((2,), MODEL, dict(n_heads=8, n_kv_heads=2)),   # GQA group 4
    ((2, 1), DM, {}),                       # rows over data
    ((2, 2), DM, {}),                       # the production mesh's shape
    ((2, 1, 1), PDM, {}),                   # rows over pod
], ids=['model2', 'model4-kv2', 'model2-group4', 'data2', 'data2-model2',
        'pod2'])
def test_mesh_drain_matches_reference_and_single_device(
        shape, axes, cfg_kw, make_virtual_mesh, tmp_path):
    """Greedy f32 tokens equal to the reference's mesh drain and the
    meshless drain; the fused + shared path's equal to the meshless fused
    drain's (the prefix trace runs 3 rows, which 2 batch ranks do not
    divide: rows replicated; where ``model`` does not divide the kv-heads
    the kernel paths are refused and the plain fused path's tokens are
    held to it); every pool replica bit-equal, the gathered pool within
    1e-4 of the meshless pool."""
    n = int(np.prod(shape))
    tree, want = _reference(cfg_kw, shape, axes, make_virtual_mesh)
    npz = tmp_path / 'params.npz'
    np.savez(npz, **_flat(tree))
    model = build_model(_cfg(**cfg_kw))
    single, seng = drain(model, params_from_jax(tree))
    shared_single, _ = drain(model, params_from_jax(tree), shared=True,
                             **KERNELS)

    out = run_ranks(_mesh_rank, n, store_dir=tmp_path, device_type='cpu',
                    args=(shape, axes, str(npz), cfg_kw),
                    timeout_s=RANK_TIMEOUT_S)
    lead = out[0]
    assert all(len(t) == 8 for t in want)
    assert lead['tokens'] == want == single
    assert lead['kernel_tokens'] == shared_single
    cfg, m = model.cfg, dict(zip(axes, shape))['model']
    pair_cut = cfg.n_kv_heads % m != 0
    assert lead['pair_cut'] == pair_cut
    if pair_cut:
        assert 'K1, K2, K3' in lead['refused'] and lead['saved'] == 0
    else:
        assert lead['refused'] is None and lead['saved'] > 0
    assert lead['committed'] and lead['copied']
    assert not any(o['jax'] for o in out)
    # 4 rows split over 2 batch ranks; the prefix trace's 3 replicated
    assert lead['split'] == (n > dict(zip(axes, shape))['model'], False)
    # every rank's pool block: 1/m of the kv-heads where the model axis m
    # divides them, else 1/m of every kv-head's RoPE pairs; the batch axes
    # replicate it
    local = ((cfg.n_kv_heads, cfg.hd // m) if pair_cut
             else (cfg.n_kv_heads // m, cfg.hd))
    shapes = [lead['shape']] + [s for o in out[1:]
                                for s in o['cache_shapes'].values()]
    assert shapes and all(s[3:] == local for s in shapes)
    assert len(shapes) == 1 + 2 * (n - 1)   # each rank: both engines
    # each worker counts its launches by engine, from 0 at the engine's open
    assert all(set(o['launches']) == set(o['cache_shapes']) for o in out[1:])
    # the gathered pool holds the single-device drain's KV (f32, another
    # summation order: close, not equal)
    for k, v in seng.cache.items():
        np.testing.assert_allclose(lead['gathered'][k], v.numpy(),
                                   rtol=1e-4, atol=1e-4)


def test_head_blocks_keep_gqa_groups_on_one_rank():
    """The engine's plan by whole heads: q-heads 8r..8r+7 read kv-heads
    4r..4r+3 on their own rank (G = 2), and at G = 4 each rank's q-heads
    map to its own kv-heads.  Where the mesh does not divide the kv-heads
    that is the plan's fallback where it does not divide Dh/2 either
    (head_dim 6); at head_dim 16 the plan holds RoPE pairs instead."""
    for heads, kv, n in ((16, 8, 2), (32, 8, 2), (32, 8, 4), (4, 2, 4),
                         (8, 2, 4), (16, 8, 8)):
        cfg = reduced(get_config(ARCH), n_heads=heads, n_kv_heads=kv,
                      head_dim=16 if kv % n == 0 else 6)
        mesh = Mesh(np.arange(n), ('model',))
        group = heads // kv
        held = set()
        if kv % n:
            pairs = engine_plan(dataclasses.replace(cfg, head_dim=16),
                                mesh, {'model': 0})
            assert pairs.pair_cut and pairs.kv_heads == (0, kv)
        for r in range(n):
            tp = engine_plan(cfg, mesh, {'model': r})
            assert not tp.pair_cut
            assert (tp.q_heads, tp.kv_heads) == head_blocks(heads, kv, n, r)
            (qlo, qhi), (klo, khi) = tp.q_heads, tp.kv_heads
            assert (qhi - qlo) * n == heads
            needed = {h // group for h in range(qlo, qhi)}
            assert needed == set(range(klo, khi)), (heads, kv, n, r)
            held |= needed
        assert held == set(range(kv))


def test_mesh_refuses_an_axis_outside_pod_data_model():
    """An engine serves over ``pod``/``data`` (the batch) and ``model``
    only; another axis name is refused before anything is opened."""
    mesh = Mesh(np.arange(2).reshape(1, 2), ('data', 'expert'))
    for arch in (ARCH, 'phi3.5-moe-42b-a6.6b'):
        model = build_model(reduced(get_config(arch), page_size=4))
        with pytest.raises(NotImplementedError, match="'expert'"):
            Engine(model, model.init_params(0, device='cpu'),
                   KVPool(4, 4, page_size=4), EngineConfig(mesh=mesh),
                   device='cpu')


@pytest.mark.parametrize('rows,parts', [(8, 2), (8, 4), (3, 2), (4, 1)])
def test_row_blocks_cover_the_batch_once_or_replicate(rows, parts):
    """A dispatch's rows in contiguous blocks over the batch ranks, in
    rank order, or every row on every rank where the ranks do not divide
    them; ``TensorParallel.rows`` reads the block off the mesh."""
    from repro_torch.distributed.sharding import batch_coords, row_block

    blocks = [row_block(rows, parts, i) for i in range(parts)]
    if rows % parts:
        assert blocks == [(0, rows)] * parts
    else:
        assert [lo for lo, _ in blocks] == sorted(lo for lo, _ in blocks)
        covered = [r for lo, hi in blocks for r in range(lo, hi)]
        assert covered == list(range(rows))
    mesh = Mesh(np.arange(2 * parts).reshape(2, parts, 1),
                ('pod', 'data', 'model'))
    for r in range(mesh.size):
        c = mesh.coords(r)
        n, index = batch_coords(mesh, c)
        assert (n, index) == (2 * parts, c['pod'] * parts + c['data'])
        tp = TensorParallel(_cfg(), mesh, c, max_batch=rows)
        lo, hi = row_block(rows, n, index)
        assert (tp.rows.start, tp.rows.stop) == (lo, hi)
        assert tp.split_rows == (hi - lo < rows)
