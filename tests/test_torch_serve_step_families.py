"""The port's serve step on a mesh for rwkv6 (ssm), zamba2 (hybrid) and
seamless-m4t (encdec), and long_500k's sequence-parallel decode, against
the JAX package's mesh step.

- Meshless rwkv6 at long_500k against the reference's meshless step: the
  reference's ``decode_fn`` ignores ``long_context`` for every family but
  hybrid, and so does the port's.
- On gloo ranks at (data 1, model 2) and (data 2, model 2), ``reduced()``
  widths, f32, the reference's weights through ``bridge.py``: a prefill
  and 2 decode steps of B = 4 rows.  Each rank's blocks of the scores
  (its rows, its vocabulary block), gathered, are within atol 1e-4 of the
  reference's mesh step on an Auto-axis ``Mesh`` of the conftest's
  virtual devices and of the port's meshless step; greedy tokens are
  equal; a block two ranks hold is bit-equal on both.  Each rank's cache
  blocks have the shapes of its rows and heads (``StepParallel.
  cache_block``).  seamless's decoder pool has no batch dimension, so its
  rows are given disjoint pages (the reference's ``make_inputs`` gives
  every row the same ones, and rows would overwrite each other) and the
  pool's replicas over ``data`` must stay bit-equal.
- long_500k at (2, 2), S = 256, from a seeded random cache, 4 decode
  steps across the boundary of the two data ranks' blocks of zamba2's KV
  sequence: rows replicated (``LONG_SERVE_RULES``), the outputs of the
  data replicas bit-equal, within 1e-4 of both references.
- Without ranks: the partial-softmax combine against plain attention, and
  the production plan's blocks (rwkv6-3b's 40 wkv heads stay whole on a
  16-way ``model`` axis).

The ranks import no jax: this module imports the reference only inside
the tests.
"""
import dataclasses
import functools
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_jax, shard_params
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.sharding import LONG_SERVE_RULES
from repro_torch.distributed.tp import StepParallel
from repro_torch.launch.mesh import describe, make_mesh
from repro_torch.launch.ranks import run_ranks
from repro_torch.models import common as cm
from repro_torch.models.api import build_model
from repro_torch.training.train_step import make_serve_step
from repro_torch.training.tree import leaves_with_paths

ATOL = 1e-4
FAMILIES = {'ssm': 'rwkv6-3b', 'hybrid': 'zamba2-2.7b',
            'encdec': 'seamless-m4t-medium'}
LONG = ('ssm', 'hybrid')
AXES = ('data', 'model')
MESHES = {'model2': (1, 2), 'data2-model2': (2, 2)}
B, N_DECODE = 4, 2
SEQ = {'ssm': 32, 'hybrid': 32, 'encdec': 256}   # encdec: a 32-token prefix
LONG_B, LONG_S, LONG_POS0, N_LONG = 2, 256, 126, 4
RANK_TIMEOUT_S = 120


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


def _torch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.tensor(v)
            for k, v in tree.items()}


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, err_msg=what)


# ---------------------------------------------------------------------------
# The cells: shapes, batches and the long cache, as numpy (ranks and the
# reference read the same numbers)
# ---------------------------------------------------------------------------

def _shapes(family):
    s = SEQ[family]
    return (ShapeConfig('prefill', s, B, 'prefill'),
            ShapeConfig('decode', s, B, 'decode'))


def _long_shape():
    return ShapeConfig('long_500k', LONG_S, LONG_B, 'decode')


def _batches(family, cfg):
    """(prefill batch, decode batches): fixed decode tokens; every row its
    own pages (encdec's one pool) or its own region (the rest)."""
    rng = np.random.default_rng(11)
    pg, s = cfg.page_size, SEQ[family]
    if family == 'encdec':
        s_dec = s // 8
        per_row = s_dec // pg + 1            # the prefix's pages + one
        table = (1 + np.arange(B * per_row, dtype=np.int32)).reshape(
            B, per_row)
        pre = {'frames': (rng.normal(size=(B, s, cfg.d_model)) * 0.02)
               .astype(np.float32),
               'tokens': rng.integers(1, cfg.vocab_size, (B, s_dec))
               .astype(np.int32),
               'page_table': table[:, :-1].copy()}
        pos0 = s_dec
    else:
        table = np.broadcast_to(np.arange(1, s // pg + 2, dtype=np.int32),
                                (B, s // pg + 1)).copy()
        pre = {'tokens': rng.integers(1, cfg.vocab_size, (B, s))
               .astype(np.int32)}
        if family != 'ssm':
            pre['page_table'] = table[:, :-1].copy()
        pos0 = s
    steps = []
    for i in range(N_DECODE):
        step = {'tokens': rng.integers(1, cfg.vocab_size, B).astype(np.int32),
                'positions': np.full((B,), pos0 + i, np.int32)}
        if family != 'ssm':
            step['page_table'] = table
        steps.append(step)
    return pre, steps


def _long_inputs(model):
    """(a seeded random global cache of the long_500k shape, f32 numpy,
    nested; the decode steps' batches)."""
    rng = np.random.default_rng(12)
    shapes = model.cache_shapes(_long_shape())
    flat = {k: (rng.normal(size=tuple(s)) * 0.5).astype(np.float32)
            for k, s in leaves_with_paths(shapes)}
    steps = [{'tokens': rng.integers(1, model.cfg.vocab_size, LONG_B)
              .astype(np.int32),
              'positions': np.full((LONG_B,), LONG_POS0 + i, np.int32)}
             for i in range(N_LONG)]
    return _unflat(flat), steps


# ---------------------------------------------------------------------------
# One rank (no jax)
# ---------------------------------------------------------------------------

def _blocks_of(cache):
    return {k: tuple(t.shape) for k, t in leaves_with_paths(cache)}


def _plan_of(plan):
    return {'rows': (plan.rows.start, plan.rows.stop), 'vocab': plan.vocab,
            'seq': plan.seq, 'coords': plan.mesh.coords()}


def _rank(rank, shape, npzs):
    """Each family's prefill and decode steps over this rank's blocks (and
    at data 2 the long_500k decode of rwkv6 and zamba2): its blocks of the
    scores, its plan, its cache blocks' shapes, encdec's pool."""
    torch.set_num_threads(1)
    mesh = make_mesh(shape, AXES, device='cpu')
    out = {'jax': 'jax' in sys.modules}
    for family, arch in FAMILIES.items():
        model = build_model(reduced(get_config(arch)))
        params = shard_params(_unflat(dict(np.load(npzs[family]))), model,
                              mesh)
        pre_shape, dec_shape = _shapes(family)
        pre, _ = make_serve_step(model, mesh, pre_shape)
        dec, _ = make_serve_step(model, mesh, dec_shape)
        plan = pre.plan
        cache = plan.shard_cache(model.init_cache(pre_shape, device='cpu',
                                                  dtype=torch.float32))
        host_pre, host_steps = _batches(family, model.cfg)
        with torch.no_grad():
            cache, s = pre(params, cache, plan.shard_batch(_torch(host_pre)))
            blocks = [s.numpy()]
            for step in host_steps:
                cache, s = dec(params, cache, plan.shard_batch(_torch(step)))
                blocks.append(s.numpy())
        out[family] = dict(_plan_of(plan), blocks=blocks,
                           cache=_blocks_of(cache))
        if family == 'encdec':
            out[family]['pool'] = {k: cache[k].numpy() for k in ('k', 'v')}
        if family in LONG and shape[0] > 1:
            step, _ = make_serve_step(model, mesh, _long_shape())
            plan = step.plan
            host_cache, host_steps = _long_inputs(model)
            cache = plan.shard_cache(_torch_tree(host_cache))
            blocks = []
            with torch.no_grad():
                for b in host_steps:
                    cache, s = step(params, cache, plan.shard_batch(_torch(b)))
                    blocks.append(s.numpy())
            out[family + '/long'] = dict(_plan_of(plan), blocks=blocks,
                                         cache=_blocks_of(cache))
    return out


# ---------------------------------------------------------------------------
# The references (in the test process)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(reference model, port model, the reference's f32 weights as numpy)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as j_get_config
    from repro.configs import reduced as j_reduced
    from repro.models.api import build_model as j_build_model

    jcfg, tcfg = j_reduced(j_get_config(arch)), reduced(get_config(arch))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jmodel = j_build_model(jcfg)
    params = jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)),
                          jmodel.init_params(jax.random.PRNGKey(1)))
    return jmodel, build_model(tcfg), params


def _jshape(shape):
    from repro.configs.base import ShapeConfig as JShape
    return JShape(shape.name, shape.seq_len, shape.global_batch, shape.kind)


def _reference(family, mesh, *, long=False):
    """The reference's step's scores, a call: on ``mesh`` (a jax Mesh) or
    meshless (None)."""
    import jax
    import jax.numpy as jnp

    from repro.training import train_step as jts

    jm, tm, params = _pair(FAMILIES[family])
    jparams = jax.tree.map(jnp.asarray, params)
    if long:
        host_cache, steps = _long_inputs(tm)
        cache = jax.tree.map(jnp.asarray, host_cache)
        step = jts.make_serve_step(jm, mesh, _jshape(_long_shape()))[0]
        calls = [(step, b) for b in steps]
    else:
        pre_shape, dec_shape = (_jshape(s) for s in _shapes(family))
        pre = jts.make_serve_step(jm, mesh, pre_shape)[0]
        dec = jts.make_serve_step(jm, mesh, dec_shape)[0]
        cache = jax.tree.map(lambda t: jnp.zeros(t.shape, jnp.float32),
                             jm.cache_shapes(pre_shape))
        host_pre, steps = _batches(family, tm.cfg)
        calls = [(pre, host_pre)] + [(dec, b) for b in steps]
    scores = []
    for fn, batch in calls:
        cache, s = fn(jparams, cache, jax.tree.map(jnp.asarray, batch))
        scores.append(np.asarray(s))
    return scores


def _meshless(family, *, long=False):
    """The port's meshless step's scores, a call."""
    _, tm, params = _pair(FAMILIES[family])
    tparams = params_from_jax(params)
    if long:
        host_cache, steps = _long_inputs(tm)
        step = make_serve_step(tm, None, _long_shape())[0]
        cache = _torch_tree(host_cache)
        calls = [(step, b) for b in steps]
    else:
        pre_shape, dec_shape = _shapes(family)
        pre = make_serve_step(tm, None, pre_shape)[0]
        dec = make_serve_step(tm, None, dec_shape)[0]
        cache = tm.init_cache(pre_shape, device='cpu', dtype=torch.float32)
        host_pre, steps = _batches(family, tm.cfg)
        calls = [(pre, host_pre)] + [(dec, b) for b in steps]
    scores = []
    with torch.no_grad():
        for fn, batch in calls:
            cache, s = fn(tparams, cache, _torch(batch))
            scores.append(s.numpy())
    return scores


_WORLDS = {}


@pytest.fixture
def world(request, make_virtual_mesh, tmp_path_factory):
    """(the ranks' results, the reference's mesh scores, the port's
    meshless scores) of the mesh ``request.param`` names: one spawn of
    ranks a mesh, shared by the tests of this module."""
    name = request.param
    if name not in _WORLDS:
        shape = MESHES[name]
        tmp = tmp_path_factory.mktemp(name)
        npzs = {}
        for family, arch in FAMILIES.items():
            npzs[family] = str(tmp / f'{family}.npz')
            np.savez(npzs[family], **_flat(_pair(arch)[2]))
        cases = [(f, False) for f in FAMILIES]
        if shape[0] > 1:
            cases += [(f, True) for f in LONG]
        # the ranks run while this process computes the references
        with ThreadPoolExecutor(1) as pool:
            ranks = pool.submit(run_ranks, _rank, int(np.prod(shape)),
                                store_dir=tmp, device_type='cpu',
                                args=(shape, npzs), timeout_s=RANK_TIMEOUT_S)
            mesh = make_virtual_mesh(shape, AXES)
            want = {_key(f, lg): _reference(f, mesh, long=lg)
                    for f, lg in cases}
            meshless = {_key(f, lg): _meshless(f, long=lg)
                        for f, lg in cases}
            out = ranks.result()
        _WORLDS[name] = (out, want, meshless)
    return _WORLDS[name]


def _key(family, long):
    return family + '/long' if long else family


def _gathered(out, key, i, shape):
    """Call ``i``'s scores assembled from every rank's block (rows,
    vocabulary); a block two ranks hold must be bit-equal on both."""
    full = np.full(shape, np.nan, np.float32)
    for o in out:
        r, (lo, hi) = o[key]['rows'], o[key]['vocab']
        block = o[key]['blocks'][i]
        assert block.shape == (r[1] - r[0], hi - lo)
        seen = full[r[0]:r[1], lo:hi]
        assert np.isnan(seen).all() or np.array_equal(seen, block), \
            f'{key} call {i}: replicas differ'
        full[r[0]:r[1], lo:hi] = block
    assert not np.isnan(full).any()
    return full


def _check_scores(world, key):
    out, want, meshless = world
    assert not any(o['jax'] for o in out)
    for i, ref in enumerate(want[key]):
        got = _gathered(out, key, i, ref.shape)
        _close(got, ref, f'{key} call {i} against the reference mesh step')
        _close(got, meshless[key][i], f'{key} call {i} against the meshless '
                                      'step')
        np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------

def test_meshless_rwkv6_long_500k_matches_the_reference():
    """rwkv6 at long_500k meshless: the reference's decode ignores
    ``long_context`` for ssm; the port's step runs it too."""
    want = _reference('ssm', None, long=True)
    got = _meshless('ssm', long=True)
    assert len(got) == len(want) == N_LONG
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, f'call {i}')
        np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))


@pytest.mark.parametrize('family', list(FAMILIES))
@pytest.mark.parametrize('world', list(MESHES), indirect=True)
def test_family_step_on_gloo_ranks_matches_the_reference(world, family):
    _check_scores(world, family)


def _expected_blocks(family, coords, mesh_shape, long=False):
    """The cache block shapes of a rank at ``coords``: its rows and heads."""
    cfg = reduced(get_config(FAMILIES[family]))
    n_data, n_model = mesh_shape
    rows = LONG_B if long else B // n_data
    L, d = cfg.n_layers, cfg.d_model
    if family == 'ssm':
        h = d // cfg.ssm_head_dim // n_model
        hd = cfg.ssm_head_dim
        return {'wkv': (L, rows, h, hd, hd), 'shift_tm': (L, rows, d),
                'shift_cm': (L, rows, d)}
    if family == 'hybrid':
        d_in, n, hd = cfg.ssm_expand * d, cfg.ssm_state, cfg.ssm_head_dim
        apps, ah = L // cfg.hybrid_attn_every, cfg.hybrid_attn_heads
        ahd = 2 * d // ah
        if long:
            kv = (apps, rows, LONG_S // n_data, ah // n_model, ahd)
        else:
            r = -(-(SEQ[family] // cfg.page_size + 1) // 16) * 16
            kv = (apps, rows, r, cfg.page_size, ah // n_model, ahd)
        return {'mamba/conv': (L, rows, cfg.conv_kernel - 1,
                               (d_in + 2 * n) // n_model),
                'mamba/ssm': (L, rows, d_in // hd // n_model, hd, n),
                'attn/k': kv, 'attn/v': kv}
    s = SEQ[family]
    r = -(-(s // cfg.page_size + 1) // 16) * 16
    kvh = cfg.n_kv_heads // n_model
    pool = (cfg.dec_layers, r, cfg.page_size, kvh, cfg.hd)
    cross = (cfg.dec_layers, rows, s, kvh, cfg.hd)
    return {'k': pool, 'v': pool, 'cross_k': cross, 'cross_v': cross}


@pytest.mark.parametrize('family', list(FAMILIES))
@pytest.mark.parametrize('world', list(MESHES), indirect=True)
def test_cache_blocks_are_the_rank_s_rows_and_heads(world, family,
                                                   request):
    mesh_shape = MESHES[request.node.callspec.params['world']]
    out = world[0]
    for o in out:
        rec = o[family]
        assert rec['cache'] == _expected_blocks(family, rec['coords'],
                                                mesh_shape)
        rows = B // mesh_shape[0]
        lo = rec['coords']['data'] * rows
        assert rec['rows'] == (lo, lo + rows)


@pytest.mark.parametrize('world', ['data2-model2'], indirect=True)
def test_encdec_pool_replicas_stay_bit_equal(world):
    """seamless's decoder pool is replicated over ``data``: every replica
    wrote every row's K/V, and the two replicas of each kv-head block hold
    the same bits; each row's pages hold K/V."""
    out = world[0]
    by_model = {}
    for o in out:
        by_model.setdefault(o['encdec']['coords']['model'], []).append(
            o['encdec']['pool'])
    for pools in by_model.values():
        assert len(pools) == 2
        for k in ('k', 'v'):
            assert np.array_equal(pools[0][k], pools[1][k]), k
            # pages 1 .. 3 B: every row's prefix and its two decode tokens
            assert np.abs(pools[0][k][:, 1:1 + 3 * B]).sum() > 0


@pytest.mark.parametrize('family', list(LONG))
@pytest.mark.parametrize('world', ['data2-model2'], indirect=True)
def test_long_500k_on_gloo_ranks_matches_the_reference(world, family):
    """long_500k over (2, 2): the rows on every rank, zamba2's KV sequence
    in two data blocks of 128 slots, 4 steps from position 126 (the first
    two written by data rank 0, the last two by data rank 1)."""
    key = family + '/long'
    _check_scores(world, key)
    out = world[0]
    for o in out:
        rec = o[key]
        assert rec['rows'] == (0, LONG_B)
        assert rec['cache'] == _expected_blocks(family, rec['coords'],
                                                (2, 2), long=True)
        half = LONG_S // 2
        lo = rec['coords']['data'] * half
        assert rec['seq'] == ((lo, lo + half) if family == 'hybrid'
                              else (0, LONG_S))
    # the data replicas return the same bits (same model coordinate)
    for i in range(N_LONG):
        by_model = {}
        for o in out:
            by_model.setdefault(o[key]['coords']['model'], []).append(
                o[key]['blocks'][i])
        for blocks in by_model.values():
            assert np.array_equal(blocks[0], blocks[1]), i


@pytest.mark.parametrize('splits', [1, 2, 4])
def test_partial_softmax_combine_equals_attention(splits):
    """``attention_partial`` over rank-order blocks of the KV sequence,
    combined by ``combine_partials``, against ``attention`` over the whole
    sequence (GQA, a position past some blocks: a block with no valid slot
    adds nothing)."""
    g = torch.Generator().manual_seed(5)
    b, s, hq, hkv, dh = 2, 64, 4, 2, 16
    q = torch.randn(b, 1, hq, dh, generator=g)
    k = torch.randn(b, s, hkv, dh, generator=g)
    v = torch.randn(b, s, hkv, dh, generator=g)
    pos = torch.tensor([20, 50])
    kv_pos = torch.arange(s).expand(b, -1)
    valid = kv_pos <= pos[:, None]
    want = cm.attention(q, k, v, q_positions=pos[:, None],
                        kv_positions=kv_pos, kv_valid=valid, causal=False)
    w = s // splits
    parts = [cm.attention_partial(q, k[:, i:i + w], v[:, i:i + w],
                                  valid[:, i:i + w])
             for i in range(0, s, w)]
    got = cm.combine_partials(*(torch.stack(t) for t in zip(*parts)))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_production_plan_blocks():
    """The (16, 16) production layout's serve plans, described (no ranks):
    rwkv6-3b's 40 wkv heads do not divide 16, so every rank holds 4 of
    the 64 value channels of every head's state (the reference's
    ``shaped_spec`` moves ``model`` onto V); zamba2-2.7b's 80 Mamba2
    heads, N = 64 and 32
    shared heads, and seamless's 16 kv-heads, split 16 ways; long_500k
    splits zamba2's 524288-slot KV 16 ways over ``data`` and replicates
    the row."""
    mesh = describe((16, 16), AXES)
    coords = {'data': 3, 'model': 5}
    rw = build_model(get_config('rwkv6-3b'))
    dec = ShapeConfig('decode_32k', 32768, 128, 'decode')
    plan = StepParallel(rw.cfg, mesh, coords, batch=128, seq_len=32768)
    wkv = plan.cache_block(('wkv',), rw.cache_shapes(dec)['wkv'])
    assert wkv.local_shape == (32, 8, 40, 64, 4)
    assert wkv.intervals(4) == ((20, 24),)
    zm = build_model(get_config('zamba2-2.7b'))
    long = ShapeConfig('long_500k', 524288, 1, 'decode')
    plan = StepParallel(zm.cfg, mesh, coords, batch=1, seq_len=524288,
                        rules=LONG_SERVE_RULES)
    shapes = zm.cache_shapes(long)
    cfg = zm.cfg
    d_in = cfg.ssm_expand * cfg.d_model
    assert plan.rows == slice(0, 1) and plan.seq == (3 * 32768, 4 * 32768)
    assert plan.cache_block(('attn', 'k'), shapes['attn']['k']).local_shape \
        == (9, 1, 32768, 2, 160)
    assert plan.cache_block(('mamba', 'ssm'),
                            shapes['mamba']['ssm']).local_shape == \
        (54, 1, 5, 64, 64)
    assert plan.cache_block(('mamba', 'conv'),
                            shapes['mamba']['conv']).local_shape == \
        (54, 1, 3, (d_in + 2 * cfg.ssm_state) // 16)
    sm = build_model(get_config('seamless-m4t-medium'))
    plan = StepParallel(sm.cfg, mesh, coords, batch=128, seq_len=32768)
    shapes = sm.cache_shapes(dec)
    assert plan.cache_block(('k',), shapes['k']).local_shape[3] == 1
    assert plan.cache_block(('cross_k',), shapes['cross_k']).local_shape[:2] \
        == (sm.cfg.dec_layers, 8)
