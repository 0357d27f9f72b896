"""The port's serve step (``training.train_step.make_serve_step``) and its
per-request region KV layout against the JAX package's.

- Shape descriptions at full width, every config x every ``SHAPES`` cell:
  ``input_specs``, ``input_axes``, ``cache_shapes`` (with dtypes) and
  ``cache_axes`` equal the reference's (no compute); ``make_inputs`` draws
  the reference's numbers.
- The meshless step against the reference's for every family at
  ``reduced()`` widths, on the reference's weights through ``bridge.py``,
  f32: a prefill, then 4 decode steps; scores within atol 1e-4 (the rule
  of ``test_torch_models.py``: the same arithmetic in another summation
  order), greedy tokens equal, every cache leaf within 1e-4.  seamless at
  S = 256 (its decoder prefix is S / 8 tokens, at least a page) and one
  row: its cache from a shape is one global pool of R pages (as the
  reference's), which the reference's page tables give every row alike.
- Within the port, the region layout against the engine's global pool
  holding the same pages in the same order: scores, tokens and pools bit
  for bit (both gather the same KV).
- The refusals: a kernel path on a region pool; on a mesh nothing: every
  family, long_500k and every rule variant are served
  (``tests/test_torch_serve_step_families.py`` and
  ``tests/test_torch_serve_variants.py`` run them on ranks).
- The step on gloo ranks at (data 1, model 2) and (2, 2) for qwen3 and
  the MoE at 16 experts: each rank's block of the scores (its rows, its
  vocabulary block), gathered, within 1e-4 of the reference's mesh step on
  an Auto-axis ``Mesh`` of the conftest's virtual devices; and the same
  prefill under the engine's plan into the global pool (``prefill_fn(
  tp=)`` on the other layout).

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
from repro_torch.configs import SHAPES, all_configs, get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.sharding import RULE_VARIANTS
from repro_torch.launch.mesh import describe, make_mesh
from repro_torch.launch.ranks import run_ranks
from repro_torch.models.api import build_model
from repro_torch.training.train_step import make_serve_step

ATOL = 1e-4
N_DECODE = 4
FAMILIES = {'dense': 'qwen3-0.6b', 'vlm': 'llava-next-mistral-7b',
            'moe': 'phi3.5-moe-42b-a6.6b', 'ssm': 'rwkv6-3b',
            'hybrid': 'zamba2-2.7b', 'encdec': 'seamless-m4t-medium'}
# what make_serve_step refuses on a mesh: nothing
REFUSED_FAMILIES = ()
REFUSED_VARIANTS = ()
AXES = ('data', 'model')
MESH_CASES = {'qwen3': ('qwen3-0.6b', {}),
              'moe16': ('phi3.5-moe-42b-a6.6b', dict(n_experts=16))}
MESH_B, MESH_S = 4, 32
RANK_TIMEOUT_S = 120


def _dtype(d) -> str:
    return str(d).replace('torch.', '')


def _cfg(family):
    kw = dict(n_experts=16) if family == 'moe' else {}
    return FAMILIES[family], kw


def _sizes(family):
    return (1, 256) if family == 'encdec' else (2, 64)


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


@functools.lru_cache(maxsize=None)
def _pair(arch, **kw):
    """(reference model, port model, the reference's f32 weights as numpy)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as j_get_config
    from repro.configs import reduced as j_reduced
    from repro.models.api import build_model as j_build_model

    jcfg = j_reduced(j_get_config(arch), **kw)
    tcfg = reduced(get_config(arch), **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jmodel = j_build_model(jcfg)
    params = jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)),
                          jmodel.init_params(jax.random.PRNGKey(1)))
    return jmodel, build_model(tcfg), params


# ---------------------------------------------------------------------------
# Shape descriptions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('shape', list(SHAPES))
@pytest.mark.parametrize('arch', sorted(all_configs()))
def test_shape_descriptions_equal_the_reference(arch, shape):
    import jax

    from repro.configs import get_config as j_get_config
    from repro.configs.base import SHAPES as J_SHAPES
    from repro.models.api import build_model as j_build_model

    jm, tm = j_build_model(j_get_config(arch)), build_model(get_config(arch))
    js, ts = J_SHAPES[shape], SHAPES[shape]
    want = jax.tree.map(lambda s: (tuple(s.shape), _dtype(s.dtype)),
                        jm.cache_shapes(js))
    got = jax.tree.map(lambda s: (tuple(s.shape), _dtype(s.dtype)),
                       tm.cache_template(ts),
                       is_leaf=lambda x: hasattr(x, 'axes'))
    assert got == want
    assert tm.cache_axes(ts) == jm.cache_axes(js)
    assert jax.tree.map(tuple, tm.cache_shapes(ts),
                        is_leaf=lambda x: isinstance(x, torch.Size)) == \
        jax.tree.map(lambda s: tuple(s.shape), jm.cache_shapes(js))
    try:
        jspecs = jm.input_specs(js)
    except ValueError:
        with pytest.raises(ValueError):
            tm.input_specs(ts)
        return
    tspecs = tm.input_specs(ts)
    assert {k: (tuple(v.shape), _dtype(v.dtype)) for k, v in tspecs.items()} \
        == {k: (tuple(v.shape), _dtype(v.dtype)) for k, v in jspecs.items()}
    assert tm.input_axes(ts) == jm.input_axes(js)
    if ts.kind != 'train' and tm.cfg.family == 'encdec':
        assert tm.enc_len(ts) == jm.enc_len(js)


@pytest.mark.parametrize('kind', ['train', 'prefill', 'decode'])
@pytest.mark.parametrize('family', list(FAMILIES))
def test_make_inputs_draws_the_reference_s_numbers(family, kind):
    arch, kw = _cfg(family)
    jm, tm, _ = _pair(arch, **kw)
    b, s = _sizes(family)
    want = jm.make_inputs(kind, b, s, np.random.default_rng(3))
    got = tm.make_inputs(kind, b, s, np.random.default_rng(3), device='cpu')
    assert set(got) == set(want)
    for k, v in want.items():
        assert str(got[k].dtype).replace('torch.', '') == str(v.dtype), k
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(v, np.float32), err_msg=k)


# ---------------------------------------------------------------------------
# The meshless step against the reference's
# ---------------------------------------------------------------------------

def _decode_batch(cfg, tokens, pos, maxp):
    """One decode step's inputs (numpy): every row at position ``pos``,
    the page table's region-local ids 1 .. maxp (none for ssm)."""
    b = len(tokens)
    batch = {'tokens': np.asarray(tokens, np.int32),
             'positions': np.full((b,), pos, np.int32)}
    if cfg.family != 'ssm':
        batch['page_table'] = np.broadcast_to(
            np.arange(1, maxp + 1, dtype=np.int32), (b, maxp)).copy()
    return batch


def _torch(batch):
    return {k: torch.tensor(np.asarray(v, np.float32) if v.dtype.kind
                            not in 'iu' else np.asarray(v))
            for k, v in batch.items()}


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, err_msg=what)


@pytest.mark.parametrize('family', list(FAMILIES))
def test_meshless_serve_step_matches_the_reference(family):
    import jax
    import jax.numpy as jnp

    from repro.configs.base import ShapeConfig as JShape
    from repro.training import train_step as jts

    arch, kw = _cfg(family)
    jm, tm, params = _pair(arch, **kw)
    b, s = _sizes(family)
    pg = tm.cfg.page_size
    shapes = {k: (JShape(k, s, b, k), ShapeConfig(k, s, b, k))
              for k in ('prefill', 'decode')}
    jpre, jdec = (jts.make_serve_step(jm, None, shapes[k][0])[0]
                  for k in ('prefill', 'decode'))
    tpre, tdec = (make_serve_step(tm, None, shapes[k][1])[0]
                  for k in ('prefill', 'decode'))
    jparams = jax.tree.map(jnp.asarray, params)
    tparams = params_from_jax(params)
    # the cache of the prefill's shape, f32 (the Mamba state stays f32)
    jcache = jax.tree.map(lambda t: jnp.zeros(t.shape, jnp.float32),
                          jm.cache_shapes(shapes['prefill'][0]))
    tcache = tm.init_cache(shapes['prefill'][1], device='cpu',
                           dtype=torch.float32)
    batch = {k: np.asarray(v, np.float32) if v.dtype == jnp.bfloat16
             else np.asarray(v)
             for k, v in jm.make_inputs('prefill', b, s,
                                        np.random.default_rng(0)).items()}
    with torch.no_grad():
        jcache, jscores = jpre(jparams, jcache,
                               jax.tree.map(jnp.asarray, batch))
        tcache, tscores = tpre(tparams, tcache, _torch(batch))
        maxp = s // pg + 1                 # the decode tokens' page too
        for i in range(N_DECODE + 1):
            want = np.asarray(jscores)
            _close(tscores.numpy(), want, f'step {i}')
            tokens = want.argmax(-1)
            np.testing.assert_array_equal(tscores.numpy().argmax(-1), tokens)
            if i == N_DECODE:
                break
            step = _decode_batch(tm.cfg, tokens, s + i, maxp)
            jcache, jscores = jdec(jparams, jcache,
                                   jax.tree.map(jnp.asarray, step))
            tcache, tscores = tdec(tparams, tcache, _torch(step))
    want = _flat(jax.tree.map(np.asarray, jcache))
    got = _flat(jax.tree.map(lambda t: t.float().numpy(), tcache))
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], k)


# ---------------------------------------------------------------------------
# Region layout against the engine's global pool, within the port
# ---------------------------------------------------------------------------

def _global_like(model, region_cache, b):
    """A global-layout cache of B x R pages (zeros) beside a region cache of
    R slots a row: row b's slot j is page b R + j."""
    cfg = model.cfg
    if cfg.family == 'hybrid':
        r = region_cache['attn']['k'].shape[2]
        return model.init_cache(engine_pages=b * r, batch_size=b,
                                device='cpu', dtype=torch.float32), r
    r = region_cache['k'].shape[2]
    return model.init_cache(engine_pages=b * r, device='cpu',
                            dtype=torch.float32), r


def _pools(cache):
    return cache['attn'] if 'attn' in cache else cache


@pytest.mark.parametrize('family', ['dense', 'moe', 'hybrid'])
def test_region_layout_equals_the_global_pool_bit_for_bit(family):
    arch, kw = _cfg(family)
    _, tm, params = _pair(arch, **kw)
    tparams = params_from_jax(params)
    b, s = 2, 64
    pg = tm.cfg.page_size
    pre = ShapeConfig('prefill', s, b, 'prefill')
    region = tm.init_cache(pre, device='cpu', dtype=torch.float32)
    pool, r = _global_like(tm, region, b)
    base = (torch.arange(b, dtype=torch.int32) * r)[:, None]
    rng = np.random.default_rng(4)
    prompt = torch.from_numpy(rng.integers(1, tm.cfg.vocab_size, (b, s))
                              .astype(np.int32))
    local = torch.arange(1, s // pg + 2, dtype=torch.int32).expand(b, -1)
    step, _ = make_serve_step(tm, None, pre)
    with torch.no_grad():
        a = step(tparams, region, {'tokens': prompt,
                                   'page_table': local[:, :-1]})[1]
        g = tm.prefill_fn(tparams, pool, {'tokens': prompt,
                                          'page_table': (base + local)[:, :-1]})[1]
        for i in range(N_DECODE + 1):
            assert torch.equal(a, g), i
            if i == N_DECODE:
                break
            tok = a.argmax(-1).to(torch.int32)
            pos = torch.full((b,), s + i, dtype=torch.int32)
            a = tm.decode_fn(tparams, region, {'tokens': tok, 'positions': pos,
                                               'page_table': local})[1]
            g = tm.decode_fn(tparams, pool, {'tokens': tok, 'positions': pos,
                                             'page_table': base + local})[1]
    for k in ('k', 'v'):
        rp, gp = _pools(region)[k], _pools(pool)[k]
        for row in range(b):
            assert torch.equal(rp[:, row], gp[:, row * r:(row + 1) * r])
    if family == 'hybrid':
        for k in ('conv', 'ssm'):
            assert torch.equal(region['mamba'][k], pool['mamba'][k])


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------

def test_a_kernel_on_a_region_pool_raises():
    """The paged-decode kernels read the global pool only: on a region pool
    ``use_kernel`` and a shared-prefix batch raise (the reference gives
    way to its plain read there)."""
    tm = build_model(reduced(get_config('qwen3-0.6b')))
    params = tm.init_params(0, device='cpu')
    dec = ShapeConfig('decode', 64, 2, 'decode')
    cache = tm.init_cache(dec, device='cpu')
    batch = tm.make_inputs('decode', 2, 64, device='cpu')
    with torch.no_grad():
        with pytest.raises(NotImplementedError, match='region'):
            tm.decode_fn(params, cache, batch, use_kernel=True)
        with pytest.raises(NotImplementedError, match='region'):
            tm.decode_fn(params, cache, dict(batch, shared={}))
        tm.decode_fn(params, cache, batch)           # the plain read


@pytest.mark.parametrize('kw', [dict(engine_pages=9), dict(batch_size=2),
                                dict(max_seq=64), dict(enc_len=8)])
def test_a_shape_takes_no_engine_keyword(kw):
    """An execution shape sizes the cache itself: one of the engine's
    keyword forms beside it raises rather than being read or dropped."""
    tm = build_model(reduced(get_config('qwen3-0.6b')))
    dec = ShapeConfig('decode', 64, 2, 'decode')
    with pytest.raises(ValueError, match='shape'):
        tm.cache_template(dec, **kw)


def test_the_refused_set_of_item_11b():
    """On a (data 2, model 2) mesh (a description: no ranks needed),
    ``make_serve_step`` refuses nothing: every config and serve shape,
    long_500k included, under every rule variant (default, serve_dh,
    serve_kv_dp, serve_seq, train_no_sp); it serves every family.
    Meshless it refuses nothing."""
    mesh = describe((2, 2), AXES)
    refused, served = set(), set()
    for arch, cfg in sorted(all_configs().items()):
        model = build_model(cfg)
        for name, shape in SHAPES.items():
            if shape.kind == 'train' or not _supported(cfg, shape):
                continue
            assert make_serve_step(model, None, shape)[1] is None
            for variant, rules in RULE_VARIANTS.items():
                try:
                    make_serve_step(model, mesh, shape, rules=rules)
                except NotImplementedError:
                    refused.add((arch, name, variant))
                else:
                    served.add((arch, name, variant))
    want = {(arch, name, variant) for arch, name, variant in refused | served
            if all_configs()[arch].family in REFUSED_FAMILIES
            or variant in REFUSED_VARIANTS}
    assert refused == want == set()
    assert {all_configs()[a].family for a, _, _ in served} == \
        set(FAMILIES)
    assert {v for _, _, v in served} == set(RULE_VARIANTS)
    assert {a for a, name, _ in served if name == 'long_500k'} == \
        {a for a, c in all_configs().items() if c.supports_long_context}


def _supported(cfg, shape):
    from repro_torch.configs import cell_supported
    return cell_supported(cfg, shape)[0]


# ---------------------------------------------------------------------------
# On gloo ranks
# ---------------------------------------------------------------------------

def _mesh_shapes():
    return (ShapeConfig('prefill', MESH_S, MESH_B, 'prefill'),
            ShapeConfig('decode', MESH_S, MESH_B, 'decode'))


def _mesh_batches(cfg):
    """(the prefill batch, the decode steps' batches), numpy, the same on
    every rank and in the reference: fixed decode tokens."""
    rng = np.random.default_rng(9)
    pg = cfg.page_size
    pre = {'tokens': rng.integers(1, cfg.vocab_size, (MESH_B, MESH_S))
           .astype(np.int32),
           'page_table': np.broadcast_to(np.arange(1, MESH_S // pg + 1,
                                                   dtype=np.int32),
                                         (MESH_B, MESH_S // pg)).copy()}
    steps = [_decode_batch(cfg, rng.integers(1, cfg.vocab_size, MESH_B),
                           MESH_S + i, MESH_S // pg + 1)
             for i in range(2)]
    return pre, steps


def _serve_rank(rank, shape, npzs):
    """One rank: each case's prefill and decode steps over its blocks;
    returns its blocks of the scores and where they lie, and the scores of
    the same prefill under the engine's plan into the global pool (every
    row's, gathered)."""
    from repro_torch.distributed.tp import TensorParallel

    torch.set_num_threads(1)
    mesh = make_mesh(shape, AXES, device='cpu')
    out = {'jax': 'jax' in sys.modules}
    for name, (arch, kw) in MESH_CASES.items():
        model = build_model(reduced(get_config(arch), **kw))
        tree = _unflat(dict(np.load(npzs[name])))
        pre_shape, dec_shape = _mesh_shapes()
        pre, _ = make_serve_step(model, mesh, pre_shape)
        dec, specs = make_serve_step(model, mesh, dec_shape)
        plan = pre.plan
        params = shard_params(tree, model, mesh)
        cache = plan.shard_cache(model.init_cache(pre_shape, device='cpu',
                                                  dtype=torch.float32))
        host_pre, host_steps = _mesh_batches(model.cfg)
        with torch.no_grad():
            cache, s = pre(params, cache, plan.shard_batch(_torch(host_pre)))
            blocks = [s.numpy()]
            for step in host_steps:
                cache, s = dec(params, cache, plan.shard_batch(_torch(step)))
                blocks.append(s.numpy())
        # the engine's plan (every row's K/V in every replica) into the
        # global pool: row b on pages 1 + b maxp ...
        tp = TensorParallel(model.cfg, mesh, max_batch=MESH_B)
        maxp = MESH_S // model.cfg.page_size
        pool = tp.init_cache(1 + MESH_B * maxp, 'cpu', torch.float32)
        pages = 1 + torch.arange(MESH_B * maxp, dtype=torch.int32)
        with torch.no_grad():
            _, whole = model.prefill_fn(params, pool, dict(
                _torch(host_pre), page_table=pages.view(MESH_B, maxp)),
                tp=tp)
        out[name] = {'blocks': blocks, 'vocab': plan.vocab,
                     'rows': (plan.rows.start, plan.rows.stop),
                     'cache': tuple(cache['k'].shape),
                     'spec': specs['cache']['k'].spec,
                     'global': whole.numpy()}
    return out


def _mesh_reference(name, shape, make_virtual_mesh):
    """The reference's mesh step's scores, a call."""
    import jax
    import jax.numpy as jnp

    from repro.configs.base import ShapeConfig as JShape
    from repro.training import train_step as jts

    arch, kw = MESH_CASES[name]
    jm, tm, params = _pair(arch, **kw)
    mesh = make_virtual_mesh(shape, AXES)
    pre, _ = jts.make_serve_step(jm, mesh, JShape('p', MESH_S, MESH_B,
                                                  'prefill'))
    dec, _ = jts.make_serve_step(jm, mesh, JShape('d', MESH_S, MESH_B,
                                                  'decode'))
    jparams = jax.tree.map(jnp.asarray, params)
    cache = jax.tree.map(lambda t: jnp.zeros(t.shape, jnp.float32),
                         jm.cache_shapes(JShape('p', MESH_S, MESH_B,
                                                'prefill')))
    host_pre, host_steps = _mesh_batches(tm.cfg)
    cache, s = pre(jparams, cache, jax.tree.map(jnp.asarray, host_pre))
    scores = [np.asarray(s)]
    for step in host_steps:
        cache, s = dec(jparams, cache, jax.tree.map(jnp.asarray, step))
        scores.append(np.asarray(s))
    return scores


@pytest.mark.parametrize('shape', [(1, 2), (2, 2)], ids=['model2',
                                                          'data2-model2'])
def test_serve_step_on_gloo_ranks_matches_the_reference(
        shape, make_virtual_mesh, tmp_path):
    want, npzs = {}, {}
    for name, (arch, kw) in MESH_CASES.items():
        npzs[name] = str(tmp_path / f'{name}.npz')
        np.savez(npzs[name], **_flat(_pair(arch, **kw)[2]))
    n = int(np.prod(shape))
    # the ranks run while this process computes the reference's steps
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, _serve_rank, n, store_dir=tmp_path,
                            device_type='cpu', args=(shape, npzs),
                            timeout_s=RANK_TIMEOUT_S)
        for name in MESH_CASES:
            want[name] = _mesh_reference(name, shape, make_virtual_mesh)
        out = ranks.result()
    assert not any(o['jax'] for o in out)
    for name in MESH_CASES:
        for i, ref in enumerate(want[name]):
            full = np.full(ref.shape, np.nan, np.float32)
            for o in out:
                r, (lo, hi) = o[name]['rows'], o[name]['vocab']
                block = o[name]['blocks'][i]
                assert block.shape == (r[1] - r[0], hi - lo)
                seen = full[r[0]:r[1], lo:hi]
                # replicas (a block two ranks hold) are bit-equal
                assert np.isnan(seen).all() or np.array_equal(seen, block)
                full[r[0]:r[1], lo:hi] = block
            assert not np.isnan(full).any()
            _close(full, ref, f'{name} call {i}')
        # the prefill under tp= on the global pool too
        for o in out:
            _close(o[name]['global'], want[name][0], f'{name} global')
        # each rank's cache block: its rows, its kv-heads
        cfg = reduced(get_config(MESH_CASES[name][0]), **MESH_CASES[name][1])
        rows = MESH_B // shape[0]
        assert all(o[name]['cache'][1] == rows and o[name]['cache'][4] ==
                   cfg.n_kv_heads // shape[1] for o in out)
