"""The reference's placement where ``model`` does not divide rwkv6's wkv
heads or the vocabulary, in the serve step and the trainer
(``distributed.tp.TensorParallel``: ``wkv_mode``, ``embed_cut``), against
the JAX package on the CPU.

Four ``reduced()`` configs: rwkv6 with 3 wkv heads of 16 (``d_model``
48) at ``model`` 2 and with 6 heads (``d_model`` 96) at ``model`` 4 (as
rwkv6-3b's 40 heads on 16 ranks: each rank holds a block of every head's
value channels), rwkv6 with 4 heads at ``model`` 2 (whole heads, the
decay, ``w_B`` and ``ln_x`` replicated, ``Wr_cm`` cut on columns), and
seamless with a vocabulary of 511 at ``model`` 2 (as 256206 on 16 ranks:
the embedding and the head cut on d_model).  The reference's weights come
through ``bridge.py``.

- (a) Shape only: every rank's block of every weight and cache leaf holds
  the bytes of its block under the reference's ``shaped_spec``, for the
  serve step's plan and the trainer's under the default rules,
  ``serve_seq``, ``serve_kv_dp`` and ``serve_dh``; the ranks' blocks cover
  each leaf exactly once; cut blocks own their storage.
- (b) The serve step, a prefill and 3 decode steps of B = 4 rows, f32:
  the ranks' blocks of the scores, gathered, within 1e-4 of |max| of the
  port's meshless step and of the reference's ``make_serve_step`` on a
  virtual mesh of as many devices under the same rules; argmax equal.
  Under default, ``serve_seq`` and ``serve_kv_dp``, and ``serve_dh`` for
  seamless.
- (c) The trainer, one step under the default rules and ``serve_kv_dp``:
  loss within 1e-5 relative of the port's meshless step and of the
  reference's; each gradient leaf within 1e-5 of its max or, for rwkv6,
  2x its null where larger (the meshless step with every f32 product's
  sum, or its columns, in as many parts as ``model`` has ranks: the
  recurrence amplifies f32 rounding at these widths); seamless's
  exact-zero ``xbk`` gradient held to its stack's max, its update to lr;
  each block's update within 0.1 of the meshless update's norm; every
  leaf a rank holds whole bit-equal on every rank.
- (d) A checkpoint saved from the ranks' blocks (rwkv6 3 x 16) restores
  meshless, before and after the step, bit for bit.
- (e) Planted faults fail the gates: rank 1's group-norm squares not
  summed over ``model`` (b); ``r``'s gather with a backward that keeps the
  rank's block unsummed (c); the embedding gather's backward summed, n
  times the gradient (c); rank 1's head partial not summed (b).
- ``Model.init_blocks`` gives the blocks of ``init_params``' weights, bit
  for bit; an MoE engine that rank 0 opens on its own blocks (every
  other rank drawing its own) drains the tokens of one whose weights
  rank 0 ships.

The ranks import no jax: this module imports the reference only inside
the tests.
"""
import contextlib
import functools
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_jax, shard_params
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.clock import VirtualClock
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tp as tplib
from repro_torch.distributed.tp import serve_rank, stop_ranks
from repro_torch.launch.mesh import describe, make_mesh
from repro_torch.launch.ranks import run_ranks
from repro_torch.models.api import build_model
from repro_torch.orders import halved_products
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.kvpool import KVPool
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as opt
from repro_torch.training import tree as tr
from repro_torch.training.data import DataConfig, batch_at
from repro_torch.training.train_step import (
    TrainPlan, loss_and_grads, make_serve_step, make_train_step,
    mesh_loss_and_grads, shard_batch)

AXES = ('data', 'model')
# name: (arch, reduced() overrides, model ranks, expected placement)
CONFIGS = {'h3': ('rwkv6-3b', dict(d_model=48), 2, 'values'),
           'h6': ('rwkv6-3b', dict(d_model=96), 4, 'values'),
           'h4': ('rwkv6-3b', {}, 2, 'heads'),
           'v511': ('seamless-m4t-medium', dict(vocab_size=511), 2, 'embed')}
SERVE_VARIANTS = ('default', 'serve_seq', 'serve_kv_dp')
TRAIN_VARIANTS = ('default', 'serve_kv_dp')
ALL_VARIANTS = SERVE_VARIANTS + ('serve_dh',)
B, S, N_DECODE = 4, 32, 3
ENC_S = 256                        # seamless: frames; a 32-token prefix
SCORE_TOL = 1e-4                   # (b): of |max|
LOSS_TOL = GRAD_TOL = 1e-5         # (c): loss relative; a leaf of its max
UPDATE_TOL = 0.1                   # (c): of the meshless update's norm
NULL_FACTOR = 2                    # (c): a gradient gate may widen to 2x
                                   # the leaf's null
ZERO_GRAD = 'dec_layers/xbk'       # seamless: the exact-zero gradient
# fault: (config, serve or train)
FAULTS = {'no_norm_sum': ('h3', 'serve'), 'unsummed_gather': ('h3', 'train'),
          'summed_embed': ('v511', 'train'), 'no_head_sum': ('v511', 'serve')}
CKPT = ('h3', 'default')
# an MoE engine whose experts split over model = 2
ENGINE_CFG = reduced(get_config('phi3.5-moe-42b-a6.6b'))
RANK_TIMEOUT_S = 150
FAST_COMPILE = {'xla_backend_optimization_level': 0,
                'xla_llvm_disable_expensive_passes': True}
COMPILE_THREADS = 4


def _cfg(name):
    arch, kw, _, _ = CONFIGS[name]
    return reduced(get_config(arch), **kw)


def _mesh_shape(name):
    return (1, CONFIGS[name][2])


def _serve_variants(name):
    return ALL_VARIANTS if CONFIGS[name][0].startswith('seamless') \
        else SERVE_VARIANTS


def _serve_rules(variant):
    return shd.SERVE_RULES if variant == 'default' else \
        shd.RULE_VARIANTS[variant]


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

def _shapes(cfg):
    s = ENC_S if cfg.family == 'encdec' else S
    return (ShapeConfig('prefill', s, B, 'prefill'),
            ShapeConfig('decode', s, B, 'decode'))


def _serve_batches(cfg):
    """(prefill batch, decode batches); seamless's one decoder pool takes
    each row's own pages, behind ENC_S frames a prefix of ENC_S / 8."""
    rng = np.random.default_rng(29)
    if cfg.family == 'encdec':
        dec = ENC_S // 8
        per_row = dec // cfg.page_size + 1   # the prefix's pages + one
        table = (1 + np.arange(B * per_row, dtype=np.int32)).reshape(
            B, per_row)
        pre = {'frames': (rng.normal(size=(B, ENC_S, cfg.d_model)) * 0.02)
               .astype(np.float32),
               'tokens': rng.integers(1, cfg.vocab_size, (B, dec))
               .astype(np.int32),
               'page_table': table[:, :-1].copy()}
        pos0 = dec
    else:
        pre = {'tokens': rng.integers(1, cfg.vocab_size, (B, S))
               .astype(np.int32)}
        pos0, table = S, None
    steps = []
    for i in range(N_DECODE):
        step = {'tokens': rng.integers(1, cfg.vocab_size, B).astype(np.int32),
                'positions': np.full((B,), pos0 + i, np.int32)}
        if table is not None:
            step['page_table'] = table
        steps.append(step)
    return [pre] + steps


def _train_batch(cfg):
    """``batch_at`` with a loss mask (and seamless's frames)."""
    batch = batch_at(DataConfig(seq_len=S, global_batch=B,
                                vocab_size=cfg.vocab_size), 0)
    mask = np.ones((B, S), np.float32)
    mask[0, :12] = 0
    mask[B - 1, 5:] = 0
    batch['loss_mask'] = mask
    if cfg.family == 'encdec':
        batch['frames'] = (np.random.default_rng(0).normal(
            size=(B, S, cfg.d_model)) * 0.1).astype(np.float32)
    return batch


# ---------------------------------------------------------------------------
# The ranks (no jax)
# ---------------------------------------------------------------------------

def _plant(fault, rank):
    """Plant ``fault`` in this process's plans; -> a function that takes
    it out.  A fault of rank 1 keeps its part in the collective (so the
    ranks' collectives still match) and goes on with its own part."""
    cls = tplib.TensorParallel
    saved = [(k, getattr(cls, k)) for k in
             ('value_norm', 'gather_shares', 'embed_gather', 'head_sum')]
    if fault == 'no_norm_sum' and rank == 1:
        def own_norm(self, y, width, eps):
            yf = y.float()
            part = (yf * yf).sum(-1, keepdim=True)
            self.norm_sum(part.clone())
            return (yf * torch.rsqrt(part / width + eps)).to(y.dtype)
        cls.value_norm = own_norm
    elif fault == 'unsummed_gather':
        cls.gather_shares = cls.whole
    elif fault == 'summed_embed':
        cls.embed_gather = cls.gather_shares
    elif fault == 'no_head_sum' and rank == 1:
        def own_part(self, part, dtype=torch.float32):
            self.reduce_sum(part.clone(), dtype)
            return part.to(dtype)
        cls.head_sum = own_part

    def restore():
        for k, f in saved:
            setattr(cls, k, f)
    return restore


def _serve(model, mesh, variant, tree):
    rules = _serve_rules(variant)
    shapes = _shapes(model.cfg)
    steps = [make_serve_step(model, mesh, s, rules=rules)[0] for s in shapes]
    plan = steps[0].plan
    params = shard_params(tree, model, mesh, plan=plan)
    cache = plan.shard_cache(model.init_cache(shapes[0], device='cpu',
                                              dtype=torch.float32))
    blocks = []
    with torch.no_grad():
        for i, b in enumerate(_serve_batches(model.cfg)):
            cache, out = steps[min(i, 1)](params, cache,
                                          plan.shard_batch(_torch(b)))
            blocks.append(out.numpy())
    return {'rows': (plan.rows.start, plan.rows.stop), 'vocab': plan.vocab,
            'blocks': blocks, 'mode': (plan.wkv_mode, plan.embed_cut),
            'cache': {k: tuple(v.shape) for k, v in cache.items()}}


def _blocks(tree, plan):
    return {k: (v.detach().numpy(), plan.param_blocks[k])
            for k, v in tr.leaves_with_paths(tree)}


def _train(model, mesh, variant, tree, ckpt_dir=None):
    step = make_train_step(model, mesh, rules=shd.RULE_VARIANTS[variant])
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
            'lr': float(m['lr']),
            'grads': _blocks(grads, plan), 'params': _blocks(params, plan),
            'mode': (plan.tp.wkv_mode, plan.tp.embed_cut)}


def _rank(rank, names, npzs, ckpt_dir):
    torch.set_num_threads(1)        # the ranks share this host's cores
    mesh = make_mesh(_mesh_shape(names[0]), AXES, device='cpu')
    out = {'jax': 'jax' in sys.modules}
    for name in names:
        tree = _unflat(dict(np.load(npzs[name])))
        model = build_model(_cfg(name))
        for variant in _serve_variants(name):
            out['serve', name, variant] = _serve(model, mesh, variant, tree)
        for variant in TRAIN_VARIANTS:
            out['train', name, variant] = _train(
                model, mesh, variant, tree,
                ckpt_dir if (name, variant) == CKPT else None)
        for fault, (target, kind) in FAULTS.items():
            if target != name:
                continue
            restore = _plant(fault, rank)
            try:
                run = _serve if kind == 'serve' else _train
                out[kind, name, fault] = run(model, mesh, 'default', tree)
            finally:
                restore()
    if mesh.size == 2:
        out['engine'] = _engines(rank, mesh)
    return out


def _drain(model, params, mesh, **ecfg):
    """Three requests drained by a mesh engine (8 new tokens each)."""
    pool = KVPool(8, 4, page_size=4, reserved_handles=1)
    eng = Engine(model, params, pool,
                 EngineConfig(prefill_chunk=8, max_batch=4, max_seq=48,
                              mesh=mesh, **ecfg),
                 clock=VirtualClock(), device='cpu')
    rng = np.random.default_rng(11)
    rids = [eng.submit(rng.integers(1, model.cfg.vocab_size, n).tolist(),
                       max_new_tokens=8) for n in (5, 11, 17)]
    eng.run_to_completion()
    eng.close()
    return [eng.output_tokens(r) for r in rids]


def _engines(rank, mesh):
    """An MoE engine (experts over ``model``) drained twice: its weights
    shipped from rank 0, then every rank's own blocks drawn where it runs
    (``Model.init_blocks``: rank 0's weights are its blocks, so the engine
    ships nothing).  Rank 0 returns both drains' tokens."""
    model = build_model(ENGINE_CFG)
    if rank != 0:
        serve_rank(mesh, blocks=lambda cfg, plan: build_model(
            cfg).init_blocks(0, plan, device='cpu'))
        return None
    try:
        shipped = _drain(model, model.init_params(0, device='cpu'), mesh)
        held = _drain(model, model.init_blocks(0, tplib.engine_plan(
            model.cfg, mesh), device='cpu'), mesh)
        return shipped, held
    finally:
        stop_ranks(mesh)


# ---------------------------------------------------------------------------
# The references (this process)
# ---------------------------------------------------------------------------

def _jmodel(name):
    from repro.configs import get_config as j_get_config
    from repro.configs import reduced as j_reduced
    from repro.models.api import build_model as j_build_model

    arch, kw, _, _ = CONFIGS[name]
    return j_build_model(j_reduced(j_get_config(arch), **kw))


@functools.lru_cache(maxsize=None)
def _tree(name):
    """The reference's f32 weights as numpy."""
    import jax
    import jax.numpy as jnp

    params = _jmodel(name).init_params(jax.random.PRNGKey(3))
    return jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), params)


def _jshape(shape):
    from repro.configs.base import ShapeConfig as JShape
    return JShape(shape.name, shape.seq_len, shape.global_batch, shape.kind)


def _reference_serve(name, variant, mesh):
    """The reference's serve step's scores, a call, on ``mesh`` (a jax
    Mesh of virtual devices) under the variant's rules."""
    import jax
    import jax.numpy as jnp

    from repro.distributed import sharding as jshd
    from repro.training import train_step as jts

    jm = _jmodel(name)
    rules = jshd.SERVE_RULES if variant == 'default' else \
        jshd.RULE_VARIANTS[variant]
    shapes = _shapes(_cfg(name))
    steps = [jts.make_serve_step(jm, mesh, _jshape(s), rules=rules)[0]
             for s in shapes]
    params = jax.tree.map(jnp.asarray, _tree(name))
    cache = jax.tree.map(lambda t: jnp.zeros(t.shape, jnp.float32),
                         jm.cache_shapes(_jshape(shapes[0])))
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
    shapes = _shapes(model.cfg)
    steps = [make_serve_step(model, None, s)[0] for s in shapes]
    cache = model.init_cache(shapes[0], device='cpu', dtype=torch.float32)
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


def _nulls(name, grads):
    """rwkv6: {leaf: how far the meshless gradient moves with every f32
    product's sum, or its columns, in as many parts as ``model`` has ranks
    (``orders.halved_products`` nested: the rounding the ranks' f32 sums
    add), a share of the leaf's max}; {} for seamless."""
    model = build_model(_cfg(name))
    if model.cfg.family != 'ssm':
        return {}
    batch = _torch(_train_batch(model.cfg))
    out = {}
    for split in ('sum', 'columns'):
        params = params_from_jax(_tree(name), requires_grad=True)
        with contextlib.ExitStack() as parts:
            for _ in range(int(np.log2(CONFIGS[name][2]))):
                parts.enter_context(halved_products(torch.float32, split))
            _, null = loss_and_grads(model, params, batch)
        for k, v in tr.leaves_with_paths(null):
            out[k] = max(out.get(k, 0.0), float(
                np.abs(v.numpy() - grads[k]).max() / _scale(grads, k)))
    return out


@pytest.fixture(scope='module')
def world(make_virtual_mesh, tmp_path_factory):
    """The ranks' results (a 2-rank and a 4-rank world at once) and the
    references, computed while the ranks run."""
    root = tmp_path_factory.mktemp('wkv_vocab')
    npzs = {}
    for name in CONFIGS:
        npzs[name] = str(root / f'{name}.npz')
        np.savez(npzs[name], **_flat(_tree(name)))
    ckpt_dir = str(root / 'ckpt')
    worlds = {}
    for name in CONFIGS:
        worlds.setdefault(CONFIGS[name][2], []).append(name)
    with ThreadPoolExecutor(len(worlds)) as pool:
        ranks = [pool.submit(run_ranks, _rank, n,
                             store_dir=root / f'ranks{n}', device_type='cpu',
                             args=(names, npzs, ckpt_dir),
                             timeout_s=RANK_TIMEOUT_S)
                 for n, names in worlds.items()]
        meshes = {n: make_virtual_mesh((1, n), AXES) for n in worlds}
        with ThreadPoolExecutor(COMPILE_THREADS) as refs:
            serve = {(n, v): refs.submit(_reference_serve, n, v,
                                         meshes[CONFIGS[n][2]])
                     for n in CONFIGS for v in _serve_variants(n)}
            losses = {n: refs.submit(_reference_train_loss, n)
                      for n in CONFIGS}
            serve = {k: f.result() for k, f in serve.items()}
            losses = {k: f.result() for k, f in losses.items()}
        out = {}
        for (n, names), f in zip(worlds.items(), ranks):
            out.update({name: f.result() for name in names})
    train = {n: _meshless_train(n) for n in CONFIGS}
    return dict(ranks=out, serve=serve, losses=losses, ckpt_dir=ckpt_dir,
                meshless_serve={n: _meshless_serve(n) for n in CONFIGS},
                meshless_train=train,
                nulls={n: _nulls(n, train[n][2]) for n in CONFIGS})


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
    return [_gathered(world['ranks'][key[1]], key, i, w.shape)
            for i, w in enumerate(want)]


def _scale(full, k):
    """The max a gradient leaf's error is a share of: its own, or for
    seamless's exact-zero ``xbk`` (a key bias the softmax ignores) the
    largest of its stack's leaves."""
    if k == ZERO_GRAD:
        return max(np.abs(v).max() for p, v in full.items()
                   if p.startswith('dec_layers/'))
    return max(np.abs(full[k]).max(), 1e-30)


def _grad_errors(results, full):
    """{(rank, leaf): max error of the rank's block of ``full[leaf]``, a
    share of the leaf's max (:func:`_scale`)}."""
    return {(r, k): float(np.abs(a - b.take(full[k])).max()
                          / _scale(full, k))
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


def _train_results(world, name, variant):
    return [o['train', name, variant] for o in world['ranks'][name]]


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


def _check_leaf(path, blocks, want):
    """Every rank's block holds the bytes of the reference's; the ranks'
    blocks cover the leaf exactly once (a leaf every rank holds whole is
    replicated, as the reference's)."""
    for b, w in zip(blocks, want):
        assert int(np.prod(b.local_shape)) == int(np.prod(w.local_shape)), \
            (path, b, w)
    if all(b.is_whole() for b in blocks):
        assert all(w.is_whole() for w in want), path
        return
    held = sorted(i for b in blocks for i in _flat_indices(b))
    assert held == list(range(int(np.prod(blocks[0].shape)))), path


def _leaves(axes, shapes, prefix=()):
    for k, v in shapes.items():
        if isinstance(v, dict):
            yield from _leaves(axes[k], v, prefix + (k,))
        else:
            yield prefix + (k,), axes[k], v


@pytest.mark.parametrize('plan_kind', ['serve', 'train'])
@pytest.mark.parametrize('variant', ALL_VARIANTS)
@pytest.mark.parametrize('name', list(CONFIGS))
def test_blocks_hold_the_reference_bytes(name, variant, plan_kind):
    model = build_model(_cfg(name))
    mesh = describe(_mesh_shape(name), AXES)
    coords = [mesh.coords(r) for r in range(mesh.size)]
    if plan_kind == 'serve':
        rules = _serve_rules(variant)
        shape = _shapes(model.cfg)[0]
        plans = [tplib.StepParallel(model.cfg, mesh, c, batch=B,
                                    seq_len=shape.seq_len, rules=rules)
                 for c in coords]
        for path, axes, full in _leaves(model.cache_axes(shape),
                                        model.cache_shapes(shape)):
            _check_leaf(path, [p.cache_block(path, full) for p in plans],
                        [_reference_block(full, axes, rules, mesh, c)
                         for c in coords])
    else:
        rules = shd.RULE_VARIANTS[variant] or shd.TRAIN_RULES
        plans = [TrainPlan(model, mesh, coords=c,
                           rules=shd.RULE_VARIANTS[variant]).tp
                 for c in coords]
    kind = CONFIGS[name][3]
    if kind == 'embed':
        assert all(p.embed_cut for p in plans)
    else:
        want = {'serve_kv_dp': 'every', 'serve_dh': None}.get(variant, kind)
        assert all(p.wkv_mode == want for p in plans), want
    for path, axes, full in _leaves(model.param_axes(),
                                    model.param_shapes()):
        _check_leaf(path, [p.block(path, full) for p in plans],
                    [_reference_block(full, axes, rules, mesh, c)
                     for c in coords])


@pytest.mark.parametrize('name', ['h3', 'v511'])
def test_blocks_own_their_storage(name):
    """A rank's cut blocks are copies (a column block of the embedding, a
    block of every head's value channels), never views that keep the
    whole weight alive; whole blocks stay the caller's tensors."""
    model = build_model(_cfg(name))
    params = model.init_params(0, device='cpu')
    full = dict(tr.leaves_with_paths(params))
    plan = tplib.StepParallel(model.cfg, describe(_mesh_shape(name), AXES),
                              {'data': 0, 'model': 1}, batch=B, seq_len=S)
    for path, w in tr.leaves_with_paths(plan.shard_params(params)):
        if w.shape == full[path].shape:
            assert w.data_ptr() == full[path].data_ptr(), path
        else:
            assert w.untyped_storage().nbytes() == \
                w.numel() * w.element_size(), path


@pytest.mark.parametrize('name', ['h3', 'v511'])
def test_init_blocks_are_the_whole_draw_cut(name):
    """``Model.init_blocks`` (a leaf at a time) gives every rank the
    blocks of ``init_params``' weights, bit for bit, under the serve
    step's plan and the engine's."""
    model = build_model(_cfg(name))
    mesh = describe(_mesh_shape(name), AXES)
    full = dict(tr.leaves_with_paths(model.init_params(0, device='cpu')))
    for r in range(mesh.size):
        for plan in (tplib.StepParallel(model.cfg, mesh, mesh.coords(r),
                                        batch=B, seq_len=S),
                     tplib.engine_plan(model.cfg, mesh, mesh.coords(r))):
            got = model.init_blocks(0, plan, device='cpu')
            for k, w in tr.leaves_with_paths(got):
                assert torch.equal(w, plan.shard(k, full[k])), (r, k)


def test_an_engine_on_each_rank_s_own_blocks_drains_alike(world):
    """The MoE engine whose ranks drew their own blocks (rank 0 handed
    its blocks) drains the tokens of the engine whose weights rank 0
    shipped."""
    shipped, held = world['ranks']['h3'][0]['engine']
    assert held == shipped and all(len(t) == 8 for t in held)


def test_holds_blocks_tells_a_rank_s_blocks_from_the_whole_weights():
    """What decides whether a mesh engine ships its weights: the global
    weights (shipped), rank 0's blocks (every rank holds its own), and
    neither (a leaf of each), which raises."""
    model = build_model(ENGINE_CFG)
    mesh = describe((1, 2), AXES)
    plan = tplib.engine_plan(model.cfg, mesh, mesh.coords(0))
    shapes = model.param_shapes()
    whole = model.init_params(0, device='cpu')
    blocks = model.init_blocks(0, plan, device='cpu')
    assert not plan.holds_blocks(whole, shapes)
    assert plan.holds_blocks(blocks, shapes)
    mixed = dict(whole, embed=blocks['embed'])
    assert mixed['embed'].shape != whole['embed'].shape
    with pytest.raises(ValueError, match='neither global'):
        plan.holds_blocks(mixed, shapes)


def test_a_mesh_dividing_nothing_raises():
    """rwkv6 where ``model`` divides neither the wkv heads nor their
    channels: the plan raises, never replicating silently."""
    cfg = reduced(get_config('rwkv6-3b'), d_model=48)
    with pytest.raises(NotImplementedError, match='divides neither'):
        tplib.TensorParallel(cfg, describe((1, 5), AXES), {'data': 0,
                                                           'model': 0})


# ---------------------------------------------------------------------------
# (b) the serve step, (c) the trainer, (d) the checkpoint, (e) the faults
# ---------------------------------------------------------------------------

SERVE_CASES = [(n, v) for n in CONFIGS for v in _serve_variants(n)]


@pytest.mark.parametrize('name,variant', SERVE_CASES)
def test_serve_step_matches_meshless_and_the_reference(world, name, variant):
    ranks = world['ranks'][name]
    assert not any(o['jax'] for o in ranks)
    key = ('serve', name, variant)
    got = _serve_scores(world, key)
    for want in (world['meshless_serve'][name], world['serve'][name, variant]):
        gaps, equal = _score_gaps(got, want)
        assert max(gaps) <= SCORE_TOL and all(equal), (gaps, equal)
    cfg, n = _cfg(name), CONFIGS[name][2]
    if cfg.family == 'ssm':
        # the state: every head with 1/n of its value channels where model
        # does not divide the heads, 1/n of the heads where it does, whole
        # under serve_kv_dp
        hd, h = cfg.ssm_head_dim, cfg.d_model // cfg.ssm_head_dim
        want = (h, hd, hd) if variant == 'serve_kv_dp' else \
            (h // n, hd, hd) if h % n == 0 else (h, hd, hd // n)
        assert all(o[key]['cache']['wkv'][2:] == want for o in ranks)
    else:
        assert all(o[key]['mode'] == (None, True) for o in ranks)


@pytest.mark.parametrize('variant', TRAIN_VARIANTS)
@pytest.mark.parametrize('name', list(CONFIGS))
def test_train_step_matches_meshless_and_the_reference(world, name, variant):
    res = _train_results(world, name, variant)
    loss, m_loss, grads, after = world['meshless_train'][name]
    assert len({r['loss'] for r in res}) == 1
    assert res[0]['loss'] == pytest.approx(m_loss, rel=LOSS_TOL)
    assert res[0]['grad_loss'] == pytest.approx(loss, rel=LOSS_TOL)
    assert res[0]['loss'] == pytest.approx(world['losses'][name],
                                           rel=LOSS_TOL)
    # a leaf within GRAD_TOL of its max, or within NULL_FACTOR x its null
    # (rwkv6's recurrence amplifies f32 rounding at these widths)
    nulls = world['nulls'][name]
    errs = _grad_errors([r['grads'] for r in res], grads)
    worst = max(errs.items(), key=lambda kv: kv[1] / max(
        GRAD_TOL, NULL_FACTOR * nulls.get(kv[0][1], 0.0)))
    assert worst[1] <= max(GRAD_TOL, NULL_FACTOR * nulls.get(worst[0][1],
                                                             0.0)), \
        (worst, nulls.get(worst[0][1]))
    before = _before(name)
    shares = _update_shares([r['params'] for r in res], before, after)
    if ZERO_GRAD in grads:
        # its update is AdamW's sign of f32 noise: at most lr either way
        for r in res:
            a, b = r['params'][ZERO_GRAD]
            assert np.abs(a - b.take(before[ZERO_GRAD])).max() <= \
                r['lr'] * (1 + 1e-6)
        shares = {k: v for k, v in shares.items() if k[1] != ZERO_GRAD}
    worst = max(shares.items(), key=lambda kv: kv[1])
    assert worst[1] <= UPDATE_TOL, worst
    # every leaf a rank holds whole is bit-equal on every rank
    for k, (a, b) in res[0]['grads'].items():
        if b.is_whole():
            assert all(np.array_equal(a, r['grads'][k][0]) for r in res), k


def test_checkpoint_of_the_ranks_restores_meshless(world):
    """The default step of ``h3`` (``Wv``/``Wg``/``Wo`` blocks of 3
    intervals) wrote checkpoints 0 and 1: both restore whole, 0 equal to
    the meshless parameters, 1 to every rank's blocks."""
    name, variant = CKPT
    model = build_model(_cfg(name))
    target = {'params': tr.tree_map(torch.zeros, model.param_shapes())}
    before, _ = ckpt.restore(world['ckpt_dir'], 0, target)
    for k, v in tr.leaves_with_paths(before['params']):
        np.testing.assert_array_equal(v.numpy(), _before(name)[k],
                                      err_msg=k)
    after, _ = ckpt.restore(world['ckpt_dir'], 1, target)
    after = {k: v.numpy() for k, v in tr.leaves_with_paths(after['params'])}
    for r in _train_results(world, name, variant):
        for k, (a, b) in r['params'].items():
            np.testing.assert_array_equal(a, b.take(after[k]), err_msg=k)


@pytest.mark.parametrize('fault', [f for f, (_, kind) in FAULTS.items()
                                   if kind == 'serve'])
def test_a_planted_serve_fault_fails_the_gate(world, fault):
    name = FAULTS[fault][0]
    key, want = ('serve', name, fault), world['meshless_serve'][name]
    if fault == 'no_head_sum':
        # every rank holds every column: rank 1's own are off
        got = [o[key]['blocks'] for o in world['ranks'][name]][1]
    else:
        got = _serve_scores(world, key)
    gaps, _ = _score_gaps(got, want)
    assert max(gaps) > 10 * SCORE_TOL, gaps


@pytest.mark.parametrize('fault,leaf', [('unsummed_gather', 'layers/Wr'),
                                        ('summed_embed', 'embed')])
def test_a_planted_train_fault_fails_the_gradient_gate(world, fault, leaf):
    name = FAULTS[fault][0]
    res = _train_results(world, name, fault)
    errs = _grad_errors([r['grads'] for r in res],
                        world['meshless_train'][name][2])
    assert max(errs[r, leaf] for r in range(len(res))) > 10 * GRAD_TOL
