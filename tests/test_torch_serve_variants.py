"""The port's serve step on a mesh under the reference's serving rule
variants ``serve_kv_dp``, ``serve_seq`` and ``serve_dh``, for every family,
against the JAX package's mesh step under the same rules.

- On gloo ranks at (data 1, model 2) and (data 2, model 2), ``reduced()``
  widths, f32, the reference's weights through ``bridge.py`` placed by the
  variant's plan: a prefill and 2 decode steps of B = 4 rows for qwen3
  (dense), phi3.5-moe (moe), rwkv6 (ssm), zamba2 (hybrid) and seamless
  (encdec), and at (2, 2) long_500k (S = 256, 4 steps from position 126,
  across the boundary of two blocks of the KV sequence) for rwkv6 and
  zamba2 at B = 2, whose rows ``data`` divides (the reference's B = 1,
  which no batch axis divides, is ``tests/
  test_torch_long_row_placement.py``'s).  Each rank's blocks of the scores, gathered, are within atol
  1e-4 of the reference's mesh step on an Auto-axis ``Mesh`` of the
  conftest's virtual devices and of the port's meshless step; greedy
  tokens are equal.  qwen3 then runs a ``prefill_chunk`` (the engine's
  mixed dispatch, whose attention reads the pool as decode does) under
  the same plan, against the port's meshless chunk.
- What a variant replicates over ``model`` is bit-equal on every replica
  (``serve_kv_dp``'s pool, rwkv6's ``wkv`` and zamba2's ``ssm`` state
  under ``serve_kv_dp`` and ``serve_dh``, zamba2's conv state under
  ``serve_dh``, seamless's pool over every rank under ``serve_kv_dp``),
  and each rank's cache blocks have the shapes of its blocks under the
  reference's specs (``tree_spec_shaped``).
- A planted fault of each variant fails the gate: the serve_dh partial
  scores not summed over ``model``; the last rank's (m, l, acc) dropped
  from the serve_seq combine; one serve_kv_dp replica skipping the new
  token's write (its replicas then differ too).
- Without ranks: rwkv6's serve_seq plan is the default's, block for block.

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
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tp as tplib
from repro_torch.launch.mesh import describe, make_mesh
from repro_torch.launch.ranks import run_ranks
from repro_torch.models import common as cm
from repro_torch.models.api import build_model, region_slots
from repro_torch.training.train_step import make_serve_step
from repro_torch.training.tree import leaves_with_paths

ATOL = 1e-4
FAMILIES = {'dense': 'qwen3-0.6b', 'moe': 'phi3.5-moe-42b-a6.6b',
            'ssm': 'rwkv6-3b', 'hybrid': 'zamba2-2.7b',
            'encdec': 'seamless-m4t-medium'}
VARIANTS = ('serve_kv_dp', 'serve_seq', 'serve_dh')
LONG = ('ssm', 'hybrid')
AXES = ('data', 'model')
MESHES = {'model2': (1, 2), 'data2-model2': (2, 2)}
B, N_DECODE = 4, 2
CHUNK = 8                                   # dense: a prefill chunk after
SEQ = {'encdec': 256}                       # encdec: a 32-token prefix
DEFAULT_SEQ = 32
LONG_B, LONG_S, LONG_POS0, N_LONG = 2, 256, 126, 4
MUTANTS = {'serve_dh': 'no_score_sum', 'serve_seq': 'drop_rank',
           'serve_kv_dp': 'skip_write'}
RANK_TIMEOUT_S = 150
# the reference's compiles: CPU code generation unoptimized, 4 at a time
# (XLA compiles outside the GIL)
FAST_COMPILE = {'xla_backend_optimization_level': 0,
                'xla_llvm_disable_expensive_passes': True}
COMPILE_THREADS = 4
# the cache leaves each variant replicates over ``model`` (beside those
# every placement replicates: rwkv6's token shift states)
REPLICATED = {'serve_kv_dp': {'dense': {'k', 'v'}, 'moe': {'k', 'v'},
                              'ssm': {'wkv'},
                              'hybrid': {'attn/k', 'attn/v', 'mamba/ssm'},
                              'encdec': {'k', 'v', 'cross_k', 'cross_v'}},
              'serve_dh': {'ssm': {'wkv'},
                           'hybrid': {'mamba/conv', 'mamba/ssm'}},
              'serve_seq': {}}


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


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else torch.tensor(v)
            for k, v in tree.items()}


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, err_msg=what)


def _cfg(family):
    return reduced(get_config(FAMILIES[family]))


# ---------------------------------------------------------------------------
# The cells (numpy: ranks and the reference read the same numbers)
# ---------------------------------------------------------------------------

def _shapes(family):
    s = SEQ.get(family, DEFAULT_SEQ)
    return (ShapeConfig('prefill', s, B, 'prefill'),
            ShapeConfig('decode', s, B, 'decode'))


def _long_shape():
    return ShapeConfig('long_500k', LONG_S, LONG_B, 'decode')


def _batches(family, cfg):
    """(prefill batch, decode batches): every row its own pages (encdec's
    one pool) or its own region (the rest)."""
    rng = np.random.default_rng(21)
    pg, s = cfg.page_size, SEQ.get(family, DEFAULT_SEQ)
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
        # region slots drawn from the whole region, in no order: under
        # serve_seq both ranks' blocks hold some of a row's positions
        slots = 1 + rng.permutation(region_slots(s // pg) - 1)[:s // pg + 1]
        table = np.broadcast_to(slots.astype(np.int32),
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
    """(a seeded random global cache of the long_500k shape, the decode
    steps' batches)."""
    rng = np.random.default_rng(22)
    shapes = model.cache_shapes(_long_shape())
    flat = {k: (rng.normal(size=tuple(s)) * 0.5).astype(np.float32)
            for k, s in leaves_with_paths(shapes)}
    steps = [{'tokens': rng.integers(1, model.cfg.vocab_size, LONG_B)
              .astype(np.int32),
              'positions': np.full((LONG_B,), LONG_POS0 + i, np.int32)}
             for i in range(N_LONG)]
    return _unflat(flat), steps


def _chunk(cfg):
    """A prefill chunk of CHUNK tokens a row after the decode steps
    (``prefill_chunk``, the engine's dispatch: the same attention under a
    rule variant), its writes and its table the decode steps'."""
    rng = np.random.default_rng(23)
    _, steps = _batches('dense', cfg)
    table = steps[-1]['page_table']
    pos = (steps[-1]['positions'][:, None] + 1
           + np.arange(CHUNK, dtype=np.int32)).astype(np.int32)
    rows = np.arange(B)[:, None]
    return {'tokens': rng.integers(1, cfg.vocab_size, (B, CHUNK))
            .astype(np.int32), 'positions': pos, 'page_table': table,
            'page_ids': table[rows, pos // cfg.page_size].astype(np.int32),
            'offsets': (pos % cfg.page_size).astype(np.int32),
            'kv_len': pos[:, -1] + 1,
            'last_idx': np.full((B,), CHUNK - 1, np.int32)}


def _calls(family, model, long):
    """(shapes, the global cache to start from (None: zeros), batches)."""
    if long:
        cache, steps = _long_inputs(model)
        return [_long_shape()] * N_LONG, cache, steps
    pre_shape, dec_shape = _shapes(family)
    pre, steps = _batches(family, model.cfg)
    return [pre_shape] + [dec_shape] * N_DECODE, None, [pre] + steps


# ---------------------------------------------------------------------------
# One rank (no jax), and the planted faults
# ---------------------------------------------------------------------------

def _plant(mutant, coords):
    """Plant a fault in this rank's serve step (the variants' collectives
    are methods of ``tp.StepParallel``, the writes ``models.common``'s);
    -> a function that takes it out."""
    saved = [(tplib.StepParallel, 'score_sum'),
             (tplib.StepParallel, 'model_combine'), (cm, 'kv_write_token')]
    saved = [(o, n, getattr(o, n)) for o, n in saved]
    if mutant == 'no_score_sum':
        tplib.StepParallel.score_sum = lambda self, scores: scores
    elif mutant == 'drop_rank':
        def dropped(self, states):
            m, l, acc = (tplib._gather_stack(t, self.group, self.n)
                         for t in states)
            return cm.combine_partials(m[:-1], l[:-1], acc[:-1])
        tplib.StepParallel.model_combine = dropped
    elif mutant == 'skip_write' and coords['model'] == 1:
        cm.kv_write_token = lambda *args, **kw: None

    def restore():
        for o, n, f in saved:
            setattr(o, n, f)
    return restore


def _run(model, mesh, family, variant, params_npz, long):
    rules = shd.RULE_VARIANTS[variant]
    shapes, host_cache, batches = _calls(family, model, long)
    steps = {}
    for s in shapes:
        if s.kind not in steps:
            steps[s.kind] = make_serve_step(model, mesh, s, rules=rules)[0]
    plan = steps[shapes[0].kind].plan
    params = shard_params(params_npz, model, mesh, plan=plan)
    cache = plan.shard_cache(
        _torch(host_cache) if host_cache is not None else
        model.init_cache(shapes[0], device='cpu', dtype=torch.float32))
    blocks = []
    with torch.no_grad():
        for s, b in zip(shapes, batches):
            cache, out = steps[s.kind](params, cache,
                                       plan.shard_batch(_torch(b)))
            blocks.append(out.numpy())
        if family == 'dense' and not long:
            cache, out = model.prefill_chunk_fn(
                params, cache, plan.shard_batch(_torch(_chunk(model.cfg))),
                tp=plan)
            blocks.append(out.numpy())
    return {'rows': (plan.rows.start, plan.rows.stop), 'vocab': plan.vocab,
            'coords': plan.mesh.coords(), 'blocks': blocks,
            'cache': {k: t.numpy() for k, t in leaves_with_paths(cache)}}


def _rank(rank, shape, npzs, cases):
    """The cases' steps over this rank's blocks: {case: its blocks of the
    scores, plan, cache blocks}.  A case is (family, variant, long,
    mutant)."""
    torch.set_num_threads(1)
    mesh = make_mesh(shape, AXES, device='cpu')
    out = {'jax': 'jax' in sys.modules}
    params = {f: _unflat(dict(np.load(p))) for f, p in npzs.items()}
    for case in cases:
        family, variant, long, mutant = case
        restore = _plant(mutant, mesh.coords())
        try:
            out[case] = _run(build_model(_cfg(family)), mesh, family,
                             variant, params[family], long)
        finally:
            restore()
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
                          jmodel.init_params(jax.random.PRNGKey(2)))
    return jmodel, build_model(tcfg), params


def _jshape(shape):
    from repro.configs.base import ShapeConfig as JShape
    return JShape(shape.name, shape.seq_len, shape.global_batch, shape.kind)


def _reference(family, variant, mesh, long):
    """The reference's step's scores under ``variant``, a call, on
    ``mesh`` (a jax Mesh)."""
    import jax
    import jax.numpy as jnp

    from repro.distributed.sharding import RULE_VARIANTS
    from repro.training import train_step as jts

    jm, tm, params = _pair(FAMILIES[family])
    jparams = jax.tree.map(jnp.asarray, params)
    shapes, host_cache, batches = _calls(family, tm, long)
    steps = {}
    for s in shapes:
        if s.kind not in steps:
            steps[s.kind] = jts.make_serve_step(
                jm, mesh, _jshape(s), rules=RULE_VARIANTS[variant])[0]
    cache = (jax.tree.map(jnp.asarray, host_cache) if host_cache is not None
             else jax.tree.map(lambda t: jnp.zeros(t.shape, jnp.float32),
                               jm.cache_shapes(_jshape(shapes[0]))))
    scores, compiled = [], {}
    for s, b in zip(shapes, batches):
        b = jax.tree.map(jnp.asarray, b)
        if s.kind not in compiled:
            compiled[s.kind] = steps[s.kind].lower(jparams, cache,
                                                   b).compile(FAST_COMPILE)
        cache, out = compiled[s.kind](jparams, cache, b)
        scores.append(np.asarray(out))
    return scores


@functools.lru_cache(maxsize=None)
def _meshless(family, long):
    """The port's meshless step's scores, a call."""
    _, tm, params = _pair(FAMILIES[family])
    tparams = params_from_jax(params)
    shapes, host_cache, batches = _calls(family, tm, long)
    steps = {s.kind: make_serve_step(tm, None, s)[0] for s in shapes}
    cache = (_torch(host_cache) if host_cache is not None else
             tm.init_cache(shapes[0], device='cpu', dtype=torch.float32))
    scores = []
    with torch.no_grad():
        for s, b in zip(shapes, batches):
            cache, out = steps[s.kind](tparams, cache, _torch(b))
            scores.append(out.numpy())
        if family == 'dense' and not long:
            scores.append(tm.prefill_chunk_fn(tparams, cache,
                                              _torch(_chunk(tm.cfg)))[1]
                          .numpy())
    return scores


def _cases(mesh_name):
    cases = [(f, v, False, None) for f in FAMILIES for v in VARIANTS]
    if MESHES[mesh_name][0] > 1:
        cases += [(f, v, True, None) for f in LONG for v in VARIANTS]
    else:
        cases += [('dense', v, False, m) for v, m in MUTANTS.items()]
    return cases


_WORLDS = {}


@pytest.fixture
def world(request, make_virtual_mesh, tmp_path_factory):
    """(the ranks' results, the reference's mesh scores by case): one spawn
    of ranks a mesh, shared by the tests of this module."""
    name = request.param
    if name not in _WORLDS:
        shape = MESHES[name]
        tmp = tmp_path_factory.mktemp(name)
        npzs = {}
        for family, arch in FAMILIES.items():
            npzs[family] = str(tmp / f'{family}.npz')
            np.savez(npzs[family], **_flat(_pair(arch)[2]))
        cases = _cases(name)
        # the ranks run while this process computes the references
        with ThreadPoolExecutor(1) as pool:
            ranks = pool.submit(run_ranks, _rank, int(np.prod(shape)),
                                store_dir=tmp, device_type='cpu',
                                args=(shape, npzs, cases),
                                timeout_s=RANK_TIMEOUT_S)
            mesh = make_virtual_mesh(shape, AXES)
            with ThreadPoolExecutor(COMPILE_THREADS) as refs:
                want = {c[:3]: refs.submit(_reference, *c[:2], mesh, c[2])
                        for c in cases if c[3] is None}
                want = {k: f.result() for k, f in want.items()}
            out = ranks.result()
        _WORLDS[name] = (out, want)
    return _WORLDS[name]


def _gathered(out, case, i, shape):
    """Call ``i``'s scores assembled from every rank's block (rows,
    vocabulary); a block two ranks hold must be bit-equal on both."""
    full = np.full(shape, np.nan, np.float32)
    for o in out:
        r, (lo, hi) = o[case]['rows'], o[case]['vocab']
        block = o[case]['blocks'][i]
        assert block.shape == (r[1] - r[0], hi - lo)
        seen = full[r[0]:r[1], lo:hi]
        assert np.isnan(seen).all() or np.array_equal(seen, block), \
            f'{case} call {i}: replicas differ'
        full[r[0]:r[1], lo:hi] = block
    assert not np.isnan(full).any()
    return full


def _check_scores(world, case):
    out, want = world
    assert not any(o['jax'] for o in out)
    meshless = _meshless(case[0], case[2])
    for i, ref in enumerate(want[case[:3]]):
        got = _gathered(out, case, i, ref.shape)
        _close(got, ref, f'{case} call {i} against the reference mesh step')
        _close(got, meshless[i], f'{case} call {i} against the meshless '
                                 'step')
        np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


def _replicated(family, variant, mesh_shape, long):
    """The cache leaves that the variant's plan replicates over ``model``
    (the same block on both model ranks of a data coordinate)."""
    model = build_model(_cfg(family))
    shape = _long_shape() if long else _shapes(family)[0]
    mesh = describe(mesh_shape, AXES)
    plans = [tplib.StepParallel(model.cfg, mesh, {'data': 0, 'model': r},
                                batch=shape.global_batch,
                                seq_len=shape.seq_len,
                                rules=shd.RULE_VARIANTS[variant])
             for r in range(mesh_shape[1])]
    return [k for k, s in leaves_with_paths(model.cache_shapes(shape))
            if len({p.cache_block(tuple(k.split('/')), s) for p in plans})
            == 1]


def _replicas_equal(out, case, leaves):
    """Whether every ``model`` replica of each leaf holds the same bits."""
    for leaf in leaves:
        by_data = {}
        for o in out:
            by_data.setdefault(o[case]['coords']['data'], []).append(
                o[case]['cache'][leaf])
        for blocks in by_data.values():
            if not all(np.array_equal(blocks[0], b) for b in blocks[1:]):
                return False
    return True


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('variant', VARIANTS)
@pytest.mark.parametrize('family', list(FAMILIES))
@pytest.mark.parametrize('world', list(MESHES), indirect=True)
def test_variant_step_on_gloo_ranks_matches_the_reference(world, family,
                                                          variant):
    _check_scores(world, (family, variant, False, None))


@pytest.mark.parametrize('variant', VARIANTS)
@pytest.mark.parametrize('world', list(MESHES), indirect=True)
def test_variant_prefill_chunk_matches_the_meshless_chunk(world, variant):
    """qwen3's ``prefill_chunk`` (the engine's mixed dispatch, whose
    attention reads the pool as the decode step does) after the decode
    steps, under the variant's plan: within 1e-4 of the port's meshless
    chunk (itself held to the reference in ``test_torch_models.py``)."""
    out, _ = world
    case = ('dense', variant, False, None)
    want = _meshless('dense', False)[-1]
    got = _gathered(out, case, N_DECODE + 1, want.shape)
    _close(got, want, f'{case} prefill_chunk')
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize('variant', VARIANTS)
@pytest.mark.parametrize('family', list(LONG))
@pytest.mark.parametrize('world', ['data2-model2'], indirect=True)
def test_variant_long_500k_matches_the_reference(world, family, variant):
    """long_500k over (2, 2): B = 2 rows split over ``data``; under
    serve_seq zamba2's KV sequence in two ``model`` blocks of 128 slots,
    4 steps from position 126 across their boundary."""
    _check_scores(world, (family, variant, True, None))


@pytest.mark.parametrize('variant', VARIANTS)
@pytest.mark.parametrize('family', list(FAMILIES))
@pytest.mark.parametrize('world', list(MESHES), indirect=True)
def test_variant_replicas_and_blocks(world, family, variant, request):
    """What the variant replicates over ``model`` holds the same bits on
    every replica, and each rank's cache blocks have the shapes of its
    blocks under the reference's specs."""
    mesh_shape = MESHES[request.node.callspec.params['world']]
    out = world[0]
    case = (family, variant, False, None)
    leaves = _replicated(family, variant, mesh_shape, False)
    assert set(leaves) >= REPLICATED[variant].get(family, set()), leaves
    assert _replicas_equal(out, case, leaves)
    if family == 'encdec' and variant == 'serve_kv_dp':
        # one pool, no rows: the same bits on every rank
        for leaf in ('k', 'v'):
            assert all(np.array_equal(out[0][case]['cache'][leaf],
                                      o[case]['cache'][leaf]) for o in out)
    model = build_model(_cfg(family))
    shape = _shapes(family)[0]
    mesh = describe(mesh_shape, AXES)
    specs = shd.tree_spec_shaped(model.cache_axes(shape),
                                 model.cache_shapes(shape),
                                 shd.RULE_VARIANTS[variant], mesh)
    shapes = dict(leaves_with_paths(model.cache_shapes(shape)))
    for o in out:
        for leaf, spec in leaves_with_paths(specs):
            want = shd.local_bounds(shapes[leaf], spec.spec, mesh,
                                    o[case]['coords']).local_shape
            assert o[case]['cache'][leaf].shape == want, (leaf, spec)


@pytest.mark.parametrize('variant', VARIANTS)
@pytest.mark.parametrize('world', ['model2'], indirect=True)
def test_a_planted_fault_fails_the_gate(world, variant):
    """Each variant's planted fault (module docstring) moves qwen3's
    scores past the gate's 1e-4; the serve_kv_dp replica that skipped its
    write also holds a pool that differs from the other's."""
    out, _ = world
    case = ('dense', variant, False, MUTANTS[variant])
    meshless = _meshless('dense', False)[:N_DECODE + 1]
    errs = [np.abs(_gathered(out, case, i, m.shape) - m).max()
            for i, m in enumerate(meshless)]
    assert max(errs) > 10 * ATOL, errs
    if variant == 'serve_kv_dp':
        assert not _replicas_equal(out, case, ['k', 'v'])


def test_rwkv6_serve_seq_plan_is_the_default():
    """rwkv6 has no pool: its serve_seq rules place every leaf as the
    default's (the reference's specs agree), so the plans' blocks are
    equal, leaf for leaf, at production widths on (16, 16)."""
    model = build_model(get_config('rwkv6-3b'))
    mesh = describe((16, 16), AXES)
    shape = ShapeConfig('decode_32k', 32768, 128, 'decode')
    for coords in ({'data': 0, 'model': 0}, {'data': 3, 'model': 5}):
        plans = [tplib.StepParallel(model.cfg, mesh, coords, batch=128,
                                    seq_len=32768, rules=rules)
                 for rules in (None, shd.SERVE_SEQ_RULES)]
        for path, s in leaves_with_paths(model.param_shapes()):
            assert plans[0].block(path, s) == plans[1].block(path, s), path
        for path, s in leaves_with_paths(model.cache_shapes(shape)):
            key = tuple(path.split('/'))
            assert plans[0].cache_block(key, s) == \
                plans[1].cache_block(key, s), path
    specs = [{k: s.spec for k, s in leaves_with_paths(shd.tree_spec_shaped(
        axes, shapes, rules, mesh))}
        for rules in (shd.SERVE_RULES, shd.SERVE_SEQ_RULES)
        for axes, shapes in ((model.param_axes(), model.param_shapes()),
                             (model.cache_axes(shape),
                              model.cache_shapes(shape)))]
    assert specs[:2] == specs[2:]
