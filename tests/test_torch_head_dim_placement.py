"""The reference's head_dim placement where ``model`` does not divide the
attention heads, in the serve step and the trainer
(``distributed.tp.TensorParallel``: ``pair_cut``), against
the JAX package on the CPU.

Three ``reduced()`` configs whose heads ``model`` = 2 does not divide:
qwen3-0.6b with 5 q-heads and 1 kv-head (as 40 heads on 16 ranks), with
4 q-heads and 1 kv-head (as 8 kv-heads on 16), and llama4-scout (moe)
with 5 and 1.  The reference's weights come through ``bridge.py``.

- (a) Shape only: every rank's block of each attention leaf and of the KV
  pool holds the bytes of its block under the reference's ``shaped_spec``
  (``repro.distributed.sharding``), under the default rules,
  ``serve_seq`` and ``serve_kv_dp``, for the serve step's plan and the
  trainer's; the ranks' blocks cover each leaf exactly once.
- (b) The serve step at (data 1, model 2) on gloo ranks, a prefill and 3
  decode steps of B = 4 rows, f32: the ranks' blocks of the scores,
  gathered, within 1e-4 of |max| of the port's meshless step and of the
  reference's ``make_serve_step`` on a 2-device virtual mesh under the
  same rules; argmax equal.
- (c) The trainer at (1, 2), one step: loss within 1e-5 relative of the
  port's meshless step and of the reference's meshless step; each
  gradient leaf within 1e-5 of its max; each block's update within 0.1
  of the meshless update's norm.
- (d) A checkpoint saved from the two ranks' blocks restores meshless:
  before the step it equals the meshless parameters, after it every
  rank's blocks, bit for bit.
- (e) Planted faults fail the gates: one rank's partial scores not summed
  over ``model`` (b); attention's output split into the ranks' pairs with
  a plain slice's backward, the gradient never gathered (c).

The ranks import no jax: this module imports the reference only inside
the tests.
"""
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
from repro_torch.models.api import build_model, region_slots
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as opt
from repro_torch.training import tree as tr
from repro_torch.training.data import DataConfig, batch_at
from repro_torch.training.train_step import (
    TrainPlan, loss_and_grads, make_serve_step, make_train_step,
    mesh_loss_and_grads, shard_batch)

AXES = ('data', 'model')
SHAPE = (1, 2)
CONFIGS = {'heads5': ('qwen3-0.6b', dict(n_heads=5, n_kv_heads=1)),
           'kv1': ('qwen3-0.6b', dict(n_heads=4, n_kv_heads=1)),
           'moe': ('llama4-scout-17b-a16e', dict(n_heads=5, n_kv_heads=1))}
VARIANTS = ('default', 'serve_seq', 'serve_kv_dp')
ATTN_LEAVES = ('wq', 'wk', 'wv', 'wo', 'bq', 'bk', 'bv', 'q_norm',
               'k_norm')
B, S, N_DECODE = 4, 32, 3
SCORE_TOL = 1e-4                   # (b): of |max|
LOSS_TOL = GRAD_TOL = 1e-5         # (c): loss relative; a leaf of its max
UPDATE_TOL = 0.1                   # (c): of the meshless update's norm
FAULTS = {'no_score_sum': 'serve', 'plain_split': 'train'}
RANK_TIMEOUT_S = 150
FAST_COMPILE = {'xla_backend_optimization_level': 0,
                'xla_llvm_disable_expensive_passes': True}
COMPILE_THREADS = 4


def _cfg(name):
    arch, kw = CONFIGS[name]
    return reduced(get_config(arch), **kw)


def _serve_rules(variant):
    return shd.SERVE_RULES if variant == 'default' else \
        shd.RULE_VARIANTS[variant]


def _train_rules(variant):
    return shd.RULE_VARIANTS[variant]          # None: TRAIN_RULES


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
    return {k: torch.tensor(v) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# The inputs (numpy: the ranks and the references read the same numbers)
# ---------------------------------------------------------------------------

def _shapes():
    return (ShapeConfig('prefill', S, B, 'prefill'),
            ShapeConfig('decode', S, B, 'decode'))


def _serve_batches(cfg):
    """(prefill batch, decode batches): every row its own region, its
    slots in no order (under serve_seq both ranks hold some of a row's
    pages)."""
    rng = np.random.default_rng(21)
    pg = cfg.page_size
    slots = 1 + rng.permutation(region_slots(S // pg) - 1)[:S // pg + 1]
    table = np.broadcast_to(slots.astype(np.int32), (B, S // pg + 1)).copy()
    pre = {'tokens': rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32),
           'page_table': table[:, :-1].copy()}
    if cfg.frontend is not None:
        pre['prefix_embeds'] = (rng.normal(
            size=(B, cfg.frontend_tokens, cfg.d_model)) * 0.02).astype(
                np.float32)
    steps = [{'tokens': rng.integers(1, cfg.vocab_size, B).astype(np.int32),
              'positions': np.full((B,), S + i, np.int32),
              'page_table': table} for i in range(N_DECODE)]
    return [pre] + steps


def _train_batch(cfg):
    """``batch_at`` with a loss mask and the vision stub's embeddings."""
    batch = batch_at(DataConfig(seq_len=S, global_batch=B,
                                vocab_size=cfg.vocab_size), 0)
    mask = np.ones((B, S), np.float32)
    mask[0, :12] = 0
    mask[B - 1, 5:] = 0
    batch['loss_mask'] = mask
    if cfg.frontend is not None:
        batch['prefix_embeds'] = (np.random.default_rng(0).normal(
            size=(B, cfg.frontend_tokens, cfg.d_model)) * 0.02).astype(
                np.float32)
    return batch


# ---------------------------------------------------------------------------
# The ranks (no jax)
# ---------------------------------------------------------------------------

def _plant(fault, rank):
    """Plant ``fault`` in this process's plans; -> a function that takes
    it out.  ``no_score_sum``: rank 1 takes part in the all-reduce of the
    partial scores (so the ranks' collectives still match) but goes on
    with its own; ``plain_split``: ``own_pairs`` slices with autograd's
    own backward (zeros outside the rank's pairs, never gathered)."""
    cls, step = tplib.TensorParallel, tplib.StepParallel
    saved = [(cls, 'own_pairs', cls.own_pairs),
             (step, 'score_sum', step.score_sum)]
    if fault == 'no_score_sum' and rank == 1:
        def unsummed(self, scores, _sum=step.score_sum):
            _sum(self, scores.clone())
            return scores
        step.score_sum = unsummed
    elif fault == 'plain_split':
        def sliced(self, x):
            lo, hi = self.pairs
            return x.unflatten(-1, (2, -1))[..., lo:hi].flatten(-2)
        cls.own_pairs = sliced

    def restore():
        for o, n, f in saved:
            setattr(o, n, f)
    return restore


def _serve(model, mesh, variant, tree):
    rules = _serve_rules(variant)
    steps = [make_serve_step(model, mesh, s, rules=rules)[0]
             for s in _shapes()]
    plan = steps[0].plan
    params = shard_params(tree, model, mesh, plan=plan)
    cache = plan.shard_cache(model.init_cache(_shapes()[0], device='cpu',
                                              dtype=torch.float32))
    blocks = []
    with torch.no_grad():
        for i, b in enumerate(_serve_batches(model.cfg)):
            cache, out = steps[min(i, 1)](params, cache,
                                          plan.shard_batch(_torch(b)))
            blocks.append(out.numpy())
    return {'rows': (plan.rows.start, plan.rows.stop), 'vocab': plan.vocab,
            'blocks': blocks, 'pair_cut': plan.pair_cut,
            'cache': {k: tuple(v.shape) for k, v in cache.items()}}


def _blocks(tree, plan):
    return {k: (v.detach().numpy(), plan.param_blocks[k])
            for k, v in tr.leaves_with_paths(tree)}


def _train(model, mesh, variant, tree, ckpt_dir=None):
    step = make_train_step(model, mesh, rules=_train_rules(variant))
    plan = step.plan
    params = plan.shard_params(params_from_jax(tree))
    rows = shard_batch(_train_batch(model.cfg), plan)
    state = plan.init_opt_state()
    if ckpt_dir is not None:
        ckpt.save(ckpt_dir, 0, {'params': params, 'opt': state}, mesh=mesh,
                  specs=plan.blocks())
    loss, grads = mesh_loss_and_grads(model, plan, params, rows)
    params, state, m = step(params, state, rows)
    if ckpt_dir is not None:
        ckpt.save(ckpt_dir, 1, {'params': params, 'opt': state}, mesh=mesh,
                  specs=plan.blocks())
    return {'loss': float(m['loss']), 'grad_loss': float(loss),
            'grads': _blocks(grads, plan), 'params': _blocks(params, plan),
            'pair_cut': plan.tp.pair_cut}


def _rank(rank, npzs, ckpt_dir):
    torch.set_num_threads(1)        # the ranks share this host's cores
    mesh = make_mesh(SHAPE, AXES, device='cpu')
    trees = {n: _unflat(dict(np.load(p))) for n, p in npzs.items()}
    out = {'jax': 'jax' in sys.modules}
    for name in CONFIGS:
        model = build_model(_cfg(name))
        for variant in VARIANTS:
            out['serve', name, variant] = _serve(model, mesh, variant,
                                                 trees[name])
            out['train', name, variant] = _train(
                model, mesh, variant, trees[name],
                ckpt_dir if (name, variant) == ('heads5', 'default')
                else None)
    model = build_model(_cfg('heads5'))
    for fault, kind in FAULTS.items():
        restore = _plant(fault, rank)
        try:
            run = _serve if kind == 'serve' else _train
            out[kind, 'heads5', fault] = run(model, mesh, 'default',
                                             trees['heads5'])
        finally:
            restore()
    return out


# ---------------------------------------------------------------------------
# The references (this process)
# ---------------------------------------------------------------------------

def _jmodel(name):
    from repro.configs import get_config as j_get_config
    from repro.configs import reduced as j_reduced
    from repro.models.api import build_model as j_build_model

    arch, kw = CONFIGS[name]
    return j_build_model(j_reduced(j_get_config(arch), **kw))


@functools.lru_cache(maxsize=None)
def _tree(name):
    """The reference's f32 weights as numpy."""
    import jax
    import jax.numpy as jnp

    params = _jmodel(name).init_params(jax.random.PRNGKey(2))
    return jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), params)


def _jshape(shape):
    from repro.configs.base import ShapeConfig as JShape
    return JShape(shape.name, shape.seq_len, shape.global_batch, shape.kind)


def _reference_serve(name, variant, mesh):
    """The reference's serve step's scores, a call, on ``mesh`` (a jax
    Mesh of 2 virtual devices) under the variant's rules."""
    import jax
    import jax.numpy as jnp

    from repro.distributed import sharding as jshd
    from repro.training import train_step as jts

    jm = _jmodel(name)
    rules = jshd.SERVE_RULES if variant == 'default' else \
        jshd.RULE_VARIANTS[variant]
    steps = [jts.make_serve_step(jm, mesh, _jshape(s), rules=rules)[0]
             for s in _shapes()]
    params = jax.tree.map(jnp.asarray, _tree(name))
    cache = jax.tree.map(lambda t: jnp.zeros(t.shape, jnp.float32),
                         jm.cache_shapes(_jshape(_shapes()[0])))
    scores, compiled = [], {}
    for i, b in enumerate(_serve_batches(jm.cfg)):
        b = jax.tree.map(jnp.asarray, b)
        kind = min(i, 1)
        if kind not in compiled:
            compiled[kind] = steps[kind].lower(params, cache, b).compile(
                FAST_COMPILE)
        cache, out = compiled[kind](params, cache, b)
        scores.append(np.asarray(out))
    return scores


def _reference_train_loss(name):
    """The reference's meshless step's loss."""
    import jax
    from repro.training import optimizer as jopt
    from repro.training.train_step import make_train_step as j_step

    jm = _jmodel(name)
    jstep, _ = j_step(jm, None)
    params = jax.tree.map(jax.numpy.asarray, _tree(name))
    batch = jax.tree.map(jax.numpy.asarray, _train_batch(jm.cfg))
    _, _, m = jstep(params, jopt.init_opt_state(params), batch)
    return float(m['loss'])


def _meshless_serve(name):
    model = build_model(_cfg(name))
    params = params_from_jax(_tree(name))
    steps = [make_serve_step(model, None, s)[0] for s in _shapes()]
    cache = model.init_cache(_shapes()[0], device='cpu', dtype=torch.float32)
    scores = []
    with torch.no_grad():
        for i, b in enumerate(_serve_batches(model.cfg)):
            cache, out = steps[min(i, 1)](params, cache, _torch(b))
            scores.append(out.numpy())
    return scores


def _meshless_train(name):
    """The port's meshless loss, gradients and parameters after one step."""
    model = build_model(_cfg(name))
    batch = _torch(_train_batch(model.cfg))
    params = params_from_jax(_tree(name), requires_grad=True)
    loss, grads = loss_and_grads(model, params, batch)
    grads = {k: v.numpy() for k, v in tr.leaves_with_paths(grads)}
    step = make_train_step(model)
    params, _, m = step(params, opt.init_opt_state(params), batch)
    after = {k: v.detach().numpy() for k, v in tr.leaves_with_paths(params)}
    return float(loss), float(m['loss']), grads, after


@pytest.fixture(scope='module')
def world(make_virtual_mesh, tmp_path_factory):
    """The ranks' results and the references, computed while the ranks
    run."""
    root = tmp_path_factory.mktemp('head_dim')
    npzs = {}
    for name in CONFIGS:
        npzs[name] = str(root / f'{name}.npz')
        np.savez(npzs[name], **_flat(_tree(name)))
    ckpt_dir = str(root / 'ckpt')
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, _rank, int(np.prod(SHAPE)),
                            store_dir=root / 'ranks', device_type='cpu',
                            args=(npzs, ckpt_dir), timeout_s=RANK_TIMEOUT_S)
        mesh = make_virtual_mesh(SHAPE, AXES)
        with ThreadPoolExecutor(COMPILE_THREADS) as refs:
            serve = {(n, v): refs.submit(_reference_serve, n, v, mesh)
                     for n in CONFIGS for v in VARIANTS}
            losses = {n: refs.submit(_reference_train_loss, n)
                      for n in CONFIGS}
            serve = {k: f.result() for k, f in serve.items()}
            losses = {k: f.result() for k, f in losses.items()}
        out = ranks.result()
    return dict(ranks=out, serve=serve, losses=losses, ckpt_dir=ckpt_dir,
                meshless_serve={n: _meshless_serve(n) for n in CONFIGS},
                meshless_train={n: _meshless_train(n) for n in CONFIGS})


# ---------------------------------------------------------------------------
# Gates
# ---------------------------------------------------------------------------

def _gathered(ranks, key, i, shape):
    """Call ``i``'s scores assembled from every rank's block (rows,
    vocabulary); a block two ranks hold must be bit-equal on both."""
    full = np.full(shape, np.nan, np.float32)
    for o in ranks:
        r, (lo, hi) = o[key]['rows'], o[key]['vocab']
        block = o[key]['blocks'][i]
        seen = full[r[0]:r[1], lo:hi]
        assert np.isnan(seen).all() or np.array_equal(seen, block), key
        full[r[0]:r[1], lo:hi] = block
    assert not np.isnan(full).any()
    return full


def _score_gaps(got, want):
    """Each call's max |got - want| of |max want|, and whether its argmax
    rows are equal."""
    return ([float(np.abs(g - w).max() / np.abs(w).max())
             for g, w in zip(got, want)],
            [bool((g.argmax(-1) == w.argmax(-1)).all())
             for g, w in zip(got, want)])


def _serve_scores(world, key):
    want = world['meshless_serve'][key[1]]
    return [_gathered(world['ranks'], key, i, w.shape)
            for i, w in enumerate(want)]


def _grad_errors(results, full):
    """{(rank, leaf): max error of the rank's block of ``full[leaf]``, a
    share of the leaf's max}."""
    return {(r, k): float(np.abs(a - b.take(full[k])).max()
                          / max(np.abs(full[k]).max(), 1e-30))
            for r, blocks in enumerate(results)
            for k, (a, b) in blocks.items()}


def _update_shares(results, before, want):
    """{(rank, leaf): |mesh update - meshless update| / |meshless update|}
    of every block (an unchanged block reads 1)."""
    out = {}
    for r, blocks in enumerate(results):
        for k, (a, b) in blocks.items():
            delta = b.take(want[k]) - b.take(before[k])
            miss = np.linalg.norm((a - b.take(before[k]) - delta).ravel())
            norm = np.linalg.norm(delta.ravel())
            out[r, k] = miss / norm if norm else (0.0 if miss == 0
                                                  else np.inf)
    return out


def _before(name):
    return {k: (v.T if k.rsplit('/', 1)[-1] == 'unembed' else v)
            for k, v in _flat(_tree(name)).items()}


# ---------------------------------------------------------------------------
# (a) the blocks against the reference's shaped_spec
# ---------------------------------------------------------------------------

def _reference_block(shape, axes, rules, mesh, coords):
    from repro.distributed.sharding import shaped_spec as j_shaped_spec

    spec = tuple(j_shaped_spec(shape, axes, rules, mesh))
    return shd.local_bounds(shape, spec, mesh, coords)


def _flat_indices(block) -> list:
    return block.take(np.arange(int(np.prod(block.shape))).reshape(
        block.shape)).ravel().tolist()


def _check_leaf(blocks, want):
    """Every rank's block holds the bytes of the reference's; the ranks'
    blocks cover the leaf exactly once (a leaf every rank holds whole is
    replicated, as the reference's)."""
    for b, w in zip(blocks, want):
        assert int(np.prod(b.local_shape)) == int(np.prod(w.local_shape)), \
            (b, w)
    if all(b.is_whole() for b in blocks):
        assert all(w.is_whole() for w in want)
        return
    held = sorted(i for b in blocks for i in _flat_indices(b))
    assert held == list(range(int(np.prod(blocks[0].shape))))


@pytest.mark.parametrize('plan_kind', ['serve', 'train'])
@pytest.mark.parametrize('variant', VARIANTS)
@pytest.mark.parametrize('name', list(CONFIGS))
def test_blocks_hold_the_reference_bytes(name, variant, plan_kind):
    model = build_model(_cfg(name))
    mesh = describe(SHAPE, AXES)
    coords = [mesh.coords(r) for r in range(mesh.size)]
    axes, shapes = model.param_axes(), model.param_shapes()
    if plan_kind == 'serve':
        rules = _serve_rules(variant)
        plans = [tplib.StepParallel(model.cfg, mesh, c, batch=B, seq_len=S,
                                    rules=rules) for c in coords]
        cshape = _shapes()[0]
        caxes, cshapes = model.cache_axes(cshape), model.cache_shapes(cshape)
        for leaf in ('k', 'v'):
            _check_leaf([p.cache_block((leaf,), cshapes[leaf])
                         for p in plans],
                        [_reference_block(cshapes[leaf], caxes[leaf], rules,
                                          mesh, c) for c in coords])
        assert plans[0].cache_block(('k',), cshapes['k']).local_shape[-1] \
            == (model.cfg.hd if variant != 'default' else model.cfg.hd // 2)
    else:
        rules = _train_rules(variant) or shd.TRAIN_RULES
        plans = [TrainPlan(model, mesh, coords=c, rules=_train_rules(variant))
                 .tp for c in coords]
    assert all(p.pair_cut for p in plans)
    for leaf in ATTN_LEAVES:
        if leaf not in shapes['layers']:
            continue
        _check_leaf([p.block(f'layers/{leaf}', shapes['layers'][leaf])
                     for p in plans],
                    [_reference_block(shapes['layers'][leaf],
                                      axes['layers'][leaf], rules, mesh, c)
                     for c in coords])


def test_blocks_own_their_storage():
    """A rank's cut blocks are copies: a row block of the embedding (a
    view of the global table, contiguous) would keep the whole table
    alive on every rank sharing the card.  Whole blocks stay the caller's
    tensors."""
    model = build_model(_cfg('heads5'))
    params = model.init_params(0, device='cpu')
    plan = tplib.StepParallel(model.cfg, describe(SHAPE, AXES),
                              {'data': 0, 'model': 1}, batch=B, seq_len=S)
    blocks = plan.shard_params(params)
    for path, w in tr.leaves_with_paths(blocks):
        full = dict(tr.leaves_with_paths(params))[path]
        if w.shape == full.shape:
            assert w.data_ptr() == full.data_ptr(), path
        else:
            assert w.untyped_storage().nbytes() == \
                w.numel() * w.element_size(), path


def test_the_engine_keeps_whole_heads():
    """The engine's plan (``tp.engine_plan``) holds the reference engine's
    blocks (``tree_spec_shaped(..., SERVE_RULES, mesh)``): at (1, 2) with
    one kv-head, each rank holds a block of RoPE pairs of every head in
    ``wq``/``wk``/``wv``/``wo`` and in the global pool, not whole heads
    (which K1 would read), and the ranks cover each leaf once."""
    model = build_model(_cfg('kv1'))
    mesh = describe(SHAPE, AXES)
    coords = [mesh.coords(r) for r in range(mesh.size)]
    plans = [tplib.engine_plan(model.cfg, mesh, c, max_batch=B)
             for c in coords]
    assert all(p.pair_cut and p.kv_heads == (0, 1) for p in plans)
    axes, shapes = model.param_axes(), model.param_shapes()
    for leaf in ATTN_LEAVES:
        if leaf in shapes['layers']:
            _check_leaf([p.block(f'layers/{leaf}', shapes['layers'][leaf])
                         for p in plans],
                        [_reference_block(shapes['layers'][leaf],
                                          axes['layers'][leaf],
                                          shd.SERVE_RULES, mesh, c)
                         for c in coords])
    pool = model.cache_template(engine_pages=8)['k']
    blocks = [p.pool_block(pool.shape) for p in plans]
    _check_leaf(blocks, [_reference_block(pool.shape, pool.axes,
                                          shd.SERVE_RULES, mesh, c)
                         for c in coords])
    assert blocks[0].local_shape[-1] == model.cfg.hd // 2


# ---------------------------------------------------------------------------
# (b) the serve step, (c) the trainer, (d) the checkpoint, (e) the faults
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('variant', VARIANTS)
@pytest.mark.parametrize('name', list(CONFIGS))
def test_serve_step_matches_meshless_and_the_reference(world, name, variant):
    ranks = world['ranks']
    assert not any(o['jax'] for o in ranks)
    key = ('serve', name, variant)
    assert all(o[key]['pair_cut'] for o in ranks)
    got = _serve_scores(world, key)
    for want in (world['meshless_serve'][name], world['serve'][name, variant]):
        gaps, equal = _score_gaps(got, want)
        assert max(gaps) <= SCORE_TOL and all(equal), (gaps, equal)
    # the pool: each kv-head with half its channels by default (the
    # reference's head_dim block), whole under serve_seq (a block of its
    # pages) and serve_kv_dp (replicated)
    cfg = _cfg(name)
    width = cfg.hd // 2 if variant == 'default' else cfg.hd
    assert all(o[key]['cache']['k'][-2:] == (cfg.n_kv_heads, width)
               for o in ranks)


@pytest.mark.parametrize('variant', VARIANTS)
@pytest.mark.parametrize('name', list(CONFIGS))
def test_train_step_matches_meshless_and_the_reference(world, name, variant):
    ranks = world['ranks']
    key = ('train', name, variant)
    res = [o[key] for o in ranks]
    assert all(r['pair_cut'] for r in res)
    loss, m_loss, grads, after = world['meshless_train'][name]
    assert len({r['loss'] for r in res}) == 1
    assert res[0]['loss'] == pytest.approx(m_loss, rel=LOSS_TOL)
    assert res[0]['grad_loss'] == pytest.approx(loss, rel=LOSS_TOL)
    assert res[0]['loss'] == pytest.approx(world['losses'][name],
                                           rel=LOSS_TOL)
    errs = _grad_errors([r['grads'] for r in res], grads)
    worst = max(errs.items(), key=lambda kv: kv[1])
    assert worst[1] <= GRAD_TOL, worst
    shares = _update_shares([r['params'] for r in res], _before(name), after)
    worst = max(shares.items(), key=lambda kv: kv[1])
    assert worst[1] <= UPDATE_TOL, worst


def test_checkpoint_of_the_ranks_restores_meshless(world):
    """The (1, 2) default step of ``heads5`` (its attention leaves blocks
    of 2 x 5 intervals) wrote checkpoints 0 and 1: both restore whole,
    0 equal to the meshless parameters, 1 to every rank's blocks."""
    model = build_model(_cfg('heads5'))
    target = {'params': tr.tree_map(torch.zeros, model.param_shapes())}
    before, _ = ckpt.restore(world['ckpt_dir'], 0, target)
    for k, v in tr.leaves_with_paths(before['params']):
        np.testing.assert_array_equal(v.numpy(), _before('heads5')[k],
                                      err_msg=k)
    after, _ = ckpt.restore(world['ckpt_dir'], 1, target)
    after = {k: v.numpy() for k, v in tr.leaves_with_paths(after['params'])}
    for o in world['ranks']:
        for k, (a, b) in o['train', 'heads5', 'default']['params'].items():
            np.testing.assert_array_equal(a, b.take(after[k]), err_msg=k)


def test_unsummed_partial_scores_fail_the_serve_gate(world):
    got = _serve_scores(world, ('serve', 'heads5', 'no_score_sum'))
    gaps, _ = _score_gaps(got, world['meshless_serve']['heads5'])
    assert max(gaps[1:]) > 10 * SCORE_TOL, gaps


def test_an_ungathered_split_fails_the_gradient_gate(world):
    res = [o['train', 'heads5', 'plain_split'] for o in world['ranks']]
    grads = world['meshless_train']['heads5'][2]
    errs = _grad_errors([r['grads'] for r in res], grads)
    assert max(errs[r, 'layers/wq'] for r in range(2)) > 10 * GRAD_TOL
