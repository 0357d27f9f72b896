"""The trainer under the reference's rule variants
(``make_train_step(model, mesh, rules=RULE_VARIANTS[v])``,
``training/train_step.py``) against the port's meshless step and the
reference's, on the CPU.

- (a) Shape only, no ranks: for six configs on (2, 2) and (2, 2, 2)
  description meshes under ``serve_dh``, ``serve_seq`` and ``serve_kv_dp``,
  every rank's ``TrainPlan`` blocks equal what ``local_bounds`` reads off
  ``param_specs(rules=)`` and ``zero1_moment_specs``, but for the port's
  default departures (zamba2's packed leaves), which ``serve_dh`` has
  none of: there the q/k norms and rwkv6's ``u`` are the reference's
  head_dim blocks.  The blocks equal the
  reference's own specs on virtual devices too (qwen3 and rwkv6 at
  (2, 2)).
- (b) One step of every family under every variant on 2 gloo ranks at
  (data 1, model 2), f32, the reference's weights: the gates of
  ``test_torch_train_mesh.py::test_mesh_step_matches_meshless_and_the_
  reference`` -- loss and grad_norm within 1e-6 relative of the port's
  meshless step; each gradient leaf within 1e-6 of its max (1e-5 for rwkv6
  and zamba2) or within twice its null (``orders.halved_products``) where
  that is larger; dense, vlm and moe every parameter within 1e-6 of its
  max, rwkv6, zamba2 and seamless each block's update within 0.1 of the
  meshless update's norm; against the reference's meshless step loss and
  grad_norm within 1e-5 relative (or twice its spread over the
  recurrence's chunk), parameters not drawn as zeros 1e-4 of the leaf max.
- (c) At (2, 2) on 4 ranks, qwen3 under ``serve_dh`` and rwkv6 under
  ``serve_kv_dp``: the same gates, and ZeRO-1 cuts the moments of the
  leaves the variant makes whole over ``data``, as the reference's specs.
- (d) Every leaf replicated over ``model`` holds the same bits on both
  ranks after the step (gradients and parameters); ``serve_seq``'s step is
  bit-equal to the default plan's.
- (e) Planted faults fail the gradient gate: ``serve_kv_dp``'s sum over
  ``model`` of the replicated heads' leaves' gradients left out (rwkv6,
  zamba2); ``serve_dh``'s head_dim gather with a backward that sums over
  ``model`` (every rank runs the whole computation: twice the gradient).
- (f) A checkpoint written by the ``serve_dh`` (1, 2) step restores onto
  the default (1, 2) plan and meshless, every array exact.

The ranks import no jax: this module imports the reference only inside
the tests.
"""
import functools
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, reduced
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tp as tplib
from repro_torch.distributed.sharding import local_bounds
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.launch.ranks import run_ranks
from repro_torch.models.api import build_model
from repro_torch.orders import halved_products
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as opt
from repro_torch.training import tree as tr
from repro_torch.training.data import DataConfig, batch_at
from repro_torch.training.train_step import (
    TrainPlan, loss_and_grads, make_train_step, mesh_loss_and_grads,
    param_specs, shard_batch)

AXES = ('data', 'model')
VARIANTS = ('serve_dh', 'serve_seq', 'serve_kv_dp')
RANK_TIMEOUT_S = 150
B, S = 4, 32
CONFIGS = {'qwen3': dict(arch='qwen3-0.6b'),
           'vlm': dict(arch='llava-next-mistral-7b'),
           'moe': dict(arch='phi3.5-moe-42b-a6.6b', n_experts=16),
           'rwkv6': dict(arch='rwkv6-3b'), 'zamba2': dict(arch='zamba2-2.7b'),
           'seamless': dict(arch='seamless-m4t-medium')}
SPEC_CONFIGS = {'internlm2': dict(arch='internlm2-1.8b', d_model=64,
                                  d_ff=256),
                'qwen3': dict(arch='qwen3-0.6b'),
                'moe': dict(arch='phi3.5-moe-42b-a6.6b'),
                'rwkv6': dict(arch='rwkv6-3b'),
                'zamba2': dict(arch='zamba2-2.7b'),
                'seamless': dict(arch='seamless-m4t-medium')}
# the leaves whose blocks depart from the specs': the default placement's
# (tests/test_torch_train_mesh.py); serve_dh runs rwkv6's time mix and
# zamba2's Mamba2 layers whole, so it has none
DEPARTURES = {'zamba2': {'layers/in_proj', 'layers/conv_w', 'layers/conv_b'}}
# the leaves serve_dh cuts on head_dim
HEAD_DIM_LEAVES = {'qwen3': ('layers/q_norm', 'layers/k_norm'),
                   'rwkv6': ('layers/u',)}
SPLIT_FAMILIES = ('ssm', 'hybrid', 'encdec')
ZERO_GRAD = 'dec_layers/xbk'                # seamless's exact-zero gradient
NULL_FACTOR = 2
UPDATE_TOL = 0.1
REF_CHUNKS = (8, 16)
STEPS = [(name, v) for name in CONFIGS for v in ('default',) + VARIANTS]
WIDE = [('qwen3', 'serve_dh'), ('rwkv6', 'serve_kv_dp')]      # (c)
# (e): (config, variant, fault)
FAULTS = [('rwkv6', 'serve_kv_dp', 'no_head_sum'),
          ('zamba2', 'serve_kv_dp', 'no_head_sum'),
          ('qwen3', 'serve_dh', 'summed_gather'),
          ('rwkv6', 'serve_dh', 'summed_gather')]


def _cfg(name, table=CONFIGS):
    kw = dict(table[name])
    return reduced(get_config(kw.pop('arch')), **kw)


def _rules(variant):
    return shd.RULE_VARIANTS[variant]


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


def _batch(cfg):
    """``batch_at`` with a loss mask that gives every data shard its own
    token count; the vlm frontend's output, the speech frames."""
    batch = batch_at(DataConfig(seq_len=S, global_batch=B,
                                vocab_size=cfg.vocab_size), 0)
    mask = np.ones((B, S), np.float32)
    mask[0, :12] = 0
    mask[B - 1, 5:] = 0
    batch['loss_mask'] = mask
    rng = np.random.default_rng(0)
    if cfg.frontend is not None:
        batch['prefix_embeds'] = (rng.normal(
            size=(B, cfg.frontend_tokens, cfg.d_model)) * 0.02).astype(
                np.float32)
    if cfg.family == 'encdec':
        batch['frames'] = (rng.normal(size=(B, S, cfg.d_model))
                           * 0.02).astype(np.float32)
    return batch


# ---------------------------------------------------------------------------
# The ranks (no jax)
# ---------------------------------------------------------------------------

def _plant(fault):
    """Plant ``fault`` in this process's plans; -> a function that takes
    it out."""
    cls = tplib.TensorParallel
    saved = {n: getattr(cls, n) for n in ('head_share', 'whole')}
    if fault == 'no_head_sum':
        cls.head_share = lambda self, w: w
    elif fault == 'summed_gather':
        cls.whole = lambda self, part: self.gather_shares(part)

    def restore():
        for n, f in saved.items():
            setattr(cls, n, f)
    return restore


def _blocks(tree, plan):
    return {k: (v.detach().cpu().numpy(), plan.param_blocks[k])
            for k, v in tr.leaves_with_paths(tree)}


def _step(name, variant, npz, shape, fault=None, ckpt_dir=None):
    mesh = make_mesh(shape, AXES, device='cpu')
    model = build_model(_cfg(name))
    step = make_train_step(model, mesh, rules=_rules(variant))
    plan = step.plan
    params = plan.shard_params(params_from_jax(_unflat(dict(np.load(npz)))))
    rows = shard_batch(_batch(model.cfg), plan)
    restore = _plant(fault)
    try:
        loss, grads = mesh_loss_and_grads(model, plan, params, rows)
        params, state, m = step(params, plan.init_opt_state(), rows)
    finally:
        restore()
    if ckpt_dir is not None:
        ckpt.save(ckpt_dir, 1, {'params': params, 'opt': state}, mesh=mesh,
                  specs=plan.blocks())
    return {'loss': float(m['loss']), 'grad_norm': float(m['grad_norm']),
            'grad_loss': float(loss), 'grads': _blocks(grads, plan),
            'params': _blocks(params, plan),
            'moments': {k: (plan.param_blocks[k], plan.moment_block(k))
                        for k in plan.param_blocks},
            'coords': mesh.coords()}


def _restored(d, plan):
    """This rank's blocks of checkpoint 1 under ``plan``, by 'params/..',
    'mu/..', 'nu/..'."""
    zeros = tr.tree_map(torch.zeros, plan.model.param_shapes())
    target = {'params': plan.shard_params(zeros),
              'opt': plan.init_opt_state()}
    state, got = ckpt.restore(d, 1, target, shardings=plan.blocks())
    out = {'step': (got, int(state['opt']['step']))}
    for part, tree in (('params', state['params']), ('mu', state['opt']['mu']),
                       ('nu', state['opt']['nu'])):
        for k, v in tr.leaves_with_paths(tree):
            b = (plan.param_blocks[k] if part == 'params'
                 else plan.moment_block(k))
            out[f'{part}/{k}'] = (v.detach().numpy(), b)
    return out


def _rank(rank, n, npzs, ckpt_dir):
    torch.set_num_threads(1)        # ranks share this host's cores
    out = {'jax': 'jax' in sys.modules}
    if n == 4:
        out['steps'] = {c: _step(*c, npzs[c[0]], (2, 2)) for c in WIDE}
        return out
    out['steps'] = {c: _step(*c, npzs[c[0]], (1, 2),
                             ckpt_dir=ckpt_dir if c == ('qwen3', 'serve_dh')
                             else None) for c in STEPS}
    out['faults'] = {c: _step(c[0], c[1], npzs[c[0]], (1, 2), fault=c[2])
                     for c in FAULTS}
    mesh = make_mesh((1, 2), AXES, device='cpu')
    out['restored'] = _restored(ckpt_dir, TrainPlan(
        build_model(_cfg('qwen3')), mesh))
    return out


# ---------------------------------------------------------------------------
# The references (this process)
# ---------------------------------------------------------------------------

def _jmodel(name):
    from repro.configs import get_config as j_get_config
    from repro.configs import reduced as j_reduced
    from repro.models.api import build_model as j_build_model

    kw = dict(CONFIGS[name])
    return j_build_model(j_reduced(j_get_config(kw.pop('arch')), **kw))


def _np(tree):
    import jax
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _jparams(name):
    import jax
    import jax.numpy as jnp

    params = _jmodel(name).init_params(jax.random.PRNGKey(0))
    return _np(jax.tree.map(lambda x: x.astype(jnp.float32), params))


def _reference_step(name, trees):
    """The reference's meshless step: (metrics, params by path in the
    port's layout)."""
    import jax
    from repro.training import optimizer as jopt
    from repro.training.train_step import make_train_step as j_step

    jmodel = _jmodel(name)
    jstep, _ = j_step(jmodel, None)
    jp = jax.tree.map(jax.numpy.asarray, trees[name])
    batch = jax.tree.map(jax.numpy.asarray, _batch(jmodel.cfg))
    jp, _, m = jstep(jp, jopt.init_opt_state(jp), batch)
    return ({k: float(v) for k, v in m.items()},
            {k: (v.T if k.rsplit('/', 1)[-1] == 'unembed' else v)
             for k, v in tr.leaves_with_paths(_np(jp))})


def _reference_spread(name, trees, m):
    """The reference's own spread in loss and grad_norm: its step with the
    recurrence's chunked form at each of REF_CHUNKS (rwkv6, zamba2)."""
    import repro.models.rwkv6 as jrwkv6
    import repro.models.zamba2 as jzamba2

    spread = {'loss': 0.0, 'grad_norm': 0.0}
    target = {'rwkv6': (jrwkv6, 'wkv6_chunked'),
              'zamba2': (jzamba2, 'ssd_chunked')}.get(name)
    if target is None:
        return spread
    module, fn = target
    saved = getattr(module, fn)
    for chunk in REF_CHUNKS:
        setattr(module, fn, functools.partial(saved, chunk=chunk))
        try:
            other, _ = _reference_step(name, trees)
        finally:
            setattr(module, fn, saved)
        for key in spread:
            spread[key] = max(spread[key], abs(other[key] / m[key] - 1))
    return spread


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _meshless(name, trees):
    """The port's meshless loss, gradients, metrics and parameters after
    the step; for rwkv6, zamba2 and seamless each gradient leaf's null as
    a share of its max."""
    model = build_model(_cfg(name))
    batch = {k: torch.from_numpy(v) for k, v in _batch(model.cfg).items()}
    params = params_from_jax(trees[name], requires_grad=True)
    loss, grads = loss_and_grads(model, params, batch)
    grads = {k: v.numpy() for k, v in tr.leaves_with_paths(grads)}
    step = make_train_step(model)
    params, _, m = step(params, opt.init_opt_state(params), batch)
    after = {k: v.detach().numpy() for k, v in tr.leaves_with_paths(params)}
    nulls = {}
    if model.cfg.family in SPLIT_FAMILIES:
        with halved_products(torch.float32):
            _, null = loss_and_grads(
                model, params_from_jax(trees[name], requires_grad=True),
                batch)
        nulls = {k: _rel(v.numpy(), grads[k])
                 for k, v in tr.leaves_with_paths(null)}
    return float(loss), grads, {k: float(v) for k, v in m.items()}, after, \
        nulls


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    """The ranks' results (2 ranks, then 4) and the references, computed
    while the ranks run."""
    root = tmp_path_factory.mktemp('train_variants')
    trees, npzs = {}, {}
    for name in CONFIGS:
        trees[name] = _jparams(name)
        npzs[name] = str(root / f'{name}.npz')
        np.savez(npzs[name], **_flat(trees[name]))
    ckpt_dir = str(root / 'dh')
    with ThreadPoolExecutor(1) as ranks:
        spawned = ranks.submit(lambda: [run_ranks(
            _rank, n, store_dir=root / f'r{n}', device_type='cpu',
            args=(n, npzs, ckpt_dir), timeout_s=RANK_TIMEOUT_S)
            for n in (2, 4)])
        with ThreadPoolExecutor(4) as pool:
            refs = {n: pool.submit(_reference_step, n, trees)
                    for n in CONFIGS}
            refs = {n: f.result() for n, f in refs.items()}
            spreads = {n: pool.submit(_reference_spread, n, trees, refs[n][0])
                       for n in CONFIGS}
            spreads = {n: f.result() for n, f in spreads.items()}
        meshless = {n: _meshless(n, trees) for n in CONFIGS}
        two, four = spawned.result()
    return dict(two=two, four=four, trees=trees, refs=refs, spreads=spreads,
                meshless=meshless, ckpt_dir=ckpt_dir)


# ---------------------------------------------------------------------------
# Gates
# ---------------------------------------------------------------------------

def _leaf_errors(results, full, nulls=None):
    """{(rank, leaf): err / gate}: every rank's block of every leaf of
    ``full`` against it, as a share of the leaf max, over the larger of
    the tolerance and NULL_FACTOR times the leaf's null."""
    out = {}
    for r, blocks in enumerate(results):
        for k, (a, b) in blocks.items():
            if k in full:
                want = b.take(full[k])
                out[r, k] = (np.abs(a - want).max()
                             / max(np.abs(full[k]).max(), 1e-30),
                             (nulls or {}).get(k, 0.0))
    return out


def _misses(results, full, tol, nulls=None):
    return [(r, k, err) for (r, k), (err, null) in
            _leaf_errors(results, full, nulls).items()
            if err > max(tol, NULL_FACTOR * null)]


def _update_misses(results, before, want, tol):
    """[(rank, leaf, share)] of every block whose update misses ``want``'s
    by more than ``tol`` of its norm (an unchanged block reads 1)."""
    misses = []
    for r, blocks in enumerate(results):
        for k, (a, b) in blocks.items():
            if k not in want:
                continue
            delta = b.take(want[k]) - b.take(before[k])
            miss = np.linalg.norm((a - b.take(before[k]) - delta).ravel())
            norm = np.linalg.norm(delta.ravel())
            share = miss / norm if norm else (0.0 if miss == 0 else np.inf)
            if not share <= tol:
                misses.append((r, k, share))
    return misses


def _before(tree):
    return {k: (v.T if k.rsplit('/', 1)[-1] == 'unembed' else v)
            for k, v in _flat(tree).items()}


def _check_step(world, name, got):
    """The gates of (b) on ``got``, every rank's result of one step."""
    loss, grads, m, params, nulls = world['meshless'][name]
    jm, jparams = world['refs'][name]
    spread = world['spreads'][name]
    cfg = _cfg(name)
    tol = 1e-5 if cfg.family in ('ssm', 'hybrid') else 1e-6
    grads, params = dict(grads), dict(params)
    before = _before(world['trees'][name])
    if ZERO_GRAD in grads:
        stack = max(np.abs(v).max() for k, v in grads.items()
                    if k.startswith('dec_layers/'))
        for v in [grads.pop(ZERO_GRAD)] + [g['grads'][ZERO_GRAD][0]
                                           for g in got]:
            assert np.abs(v).max() <= 1e-6 * stack
        params.pop(ZERO_GRAD)
    for key in ('loss', 'grad_norm', 'grad_loss'):
        assert len({g[key] for g in got}) == 1, (key, [g[key] for g in got])
    lead = got[0]
    assert lead['grad_loss'] == lead['loss']
    assert lead['loss'] == pytest.approx(m['loss'], rel=1e-6)
    assert lead['loss'] == pytest.approx(loss, rel=1e-6)
    assert lead['grad_norm'] == pytest.approx(m['grad_norm'], rel=1e-6)
    assert not _misses([g['grads'] for g in got], grads, tol, nulls)
    if cfg.family in SPLIT_FAMILIES:
        assert not _update_misses([g['params'] for g in got], before,
                                  params, UPDATE_TOL)
    else:
        assert not _misses([g['params'] for g in got], params, tol)
    for key in ('loss', 'grad_norm'):
        assert lead[key] == pytest.approx(
            jm[key], rel=max(1e-5, NULL_FACTOR * spread[key])), (key, spread)
    drawn = {k: v for k, v in jparams.items()
             if k in params and np.abs(before[k]).any()}
    assert not _misses([g['params'] for g in got], drawn, 1e-4)
    if cfg.family in SPLIT_FAMILIES:
        assert not _update_misses([g['params'] for g in got], before,
                                  {k: jparams[k] for k in params},
                                  UPDATE_TOL)


def _replicas_equal(got, part):
    """Whether every leaf that two ranks of a data coordinate both hold
    whole (replicated over ``model``) has the same bits on both."""
    by_data = {}
    for g in got:
        by_data.setdefault(g['coords']['data'], []).append(g[part])
    for blocks in by_data.values():
        for k, (a, b) in blocks[0].items():
            if b.is_whole() and not all(np.array_equal(a, o[k][0])
                                        for o in blocks[1:]):
                return False
    return True


# ---------------------------------------------------------------------------
# (a) the blocks against the specs
# ---------------------------------------------------------------------------

def _differing(model, mesh, variant):
    """The leaves where some rank's ``TrainPlan`` block (or moment block)
    differs from ``local_bounds`` of the specs under ``variant``."""
    rules = _rules(variant)
    pspecs = param_specs(model, mesh, rules)
    specs = {'p': dict(tr.leaves_with_paths(pspecs)),
             'mu': dict(tr.leaves_with_paths(opt.zero1_moment_specs(
                 model.param_shapes(), pspecs, mesh)))}
    shapes = dict(tr.leaves_with_paths(model.param_shapes()))
    out = set()
    for r in range(mesh.size):
        coords = mesh.coords(r)
        plan = TrainPlan(model, mesh, coords=coords, rules=rules)
        for k, shp in shapes.items():
            want = {part: local_bounds(shp, specs[part][k].spec, mesh,
                                       coords).bounds for part in specs}
            if (plan.param_blocks[k].bounds != want['p']
                    or plan.moment_block(k).bounds != want['mu']):
                out.add(k)
    return out


@pytest.mark.parametrize('shape', [(2, 2), (2, 2, 2)], ids=['2x2', '2x2x2'])
@pytest.mark.parametrize('variant', VARIANTS)
@pytest.mark.parametrize('name', list(SPEC_CONFIGS))
def test_plan_blocks_follow_the_variant_specs(name, variant, shape):
    model = build_model(_cfg(name, SPEC_CONFIGS))
    axes = ('pod',) + AXES if len(shape) == 3 else AXES
    mesh = Mesh(np.arange(int(np.prod(shape))).reshape(shape), axes)
    want = set() if variant == 'serve_dh' else DEPARTURES.get(name, set())
    assert _differing(model, mesh, variant) == want
    if variant == 'serve_dh':
        for k in HEAD_DIM_LEAVES.get(name, ()):
            blocks = {TrainPlan(model, mesh, coords=mesh.coords(r),
                                rules=_rules(variant)).param_blocks[k]
                      for r in range(mesh.size)}
            assert len(blocks) == 2 and all(not b.is_whole() for b in blocks)


@pytest.mark.parametrize('variant', VARIANTS)
@pytest.mark.parametrize('name', ['qwen3', 'rwkv6'])
def test_variant_specs_equal_the_reference(name, variant, make_virtual_mesh):
    """``param_specs(rules=)`` and ZeRO-1's moment specs on a description
    mesh equal the reference's on virtual devices ((2, 2)); so the blocks
    of the test above are the reference's."""
    from repro.distributed.sharding import RULE_VARIANTS as J_VARIANTS
    from repro.training import optimizer as jopt
    from repro.training.train_step import param_specs as j_param_specs

    kw = dict(SPEC_CONFIGS[name])
    arch = kw.pop('arch')
    from repro.configs import get_config as j_get_config
    from repro.configs import reduced as j_reduced
    from repro.models.api import build_model as j_build_model
    jmodel = j_build_model(j_reduced(j_get_config(arch), **kw))
    model = build_model(reduced(get_config(arch), **kw))
    jmesh = make_virtual_mesh((2, 2), AXES)
    mesh = Mesh(np.arange(4).reshape(2, 2), AXES)
    jp = j_param_specs(jmodel, jmesh, J_VARIANTS[variant])
    jo = jopt.opt_state_specs(jp, jmesh, zero1=True,
                              param_shapes=jmodel.param_shapes())
    p = param_specs(model, mesh, _rules(variant))
    o = opt.opt_state_specs(p, mesh, zero1=True,
                            param_shapes=model.param_shapes())

    def strip(spec):
        parts = list(spec)
        while parts and parts[-1] is None:
            parts.pop()
        return tuple(parts)

    shapes = dict(tr.leaves_with_paths(model.param_shapes()))
    for want, got in ((jp, p), (jo['mu'], o['mu'])):
        want = dict(tr.leaves_with_paths(want))
        for k, s in tr.leaves_with_paths(got):
            w = tuple(want[k].spec)
            w += (None,) * (len(shapes[k]) - len(w))
            if k.rsplit('/', 1)[-1] == 'unembed':    # (D, V) read as (V, D)
                w = w[::-1]
            assert strip(w) == s.spec, (k, w, s.spec)


# ---------------------------------------------------------------------------
# (b)-(f) the steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('variant', VARIANTS)
@pytest.mark.parametrize('name', list(CONFIGS))
def test_variant_step_matches_meshless_and_the_reference(world, name,
                                                         variant):
    got = [r['steps'][name, variant] for r in world['two']]
    assert not any(r['jax'] for r in world['two'])
    _check_step(world, name, got)


@pytest.mark.parametrize('case', WIDE, ids=lambda c: '-'.join(c))
def test_variant_step_on_2x2(world, case):
    """(c): the gates at (2, 2); ZeRO-1 cuts the moments of the leaves
    the variant makes whole (attention's projections under serve_dh,
    rwkv6's ``u`` under serve_kv_dp) over ``data``."""
    got = [r['steps'][case] for r in world['four']]
    _check_step(world, case[0], got)
    newly = {'serve_dh': ('layers/wq', 'layers/wk', 'layers/wv',
                          'layers/wo'),
             'serve_kv_dp': ('layers/u',)}[case[1]]
    for g in got:
        for k in newly:
            pb, mb = g['moments'][k]
            assert pb.is_whole() and mb != pb, k
            assert np.prod(mb.local_shape) * 2 == np.prod(pb.local_shape)


@pytest.mark.parametrize('variant', ('default',) + VARIANTS)
@pytest.mark.parametrize('name', list(CONFIGS))
def test_replicated_leaves_are_bit_equal(world, name, variant):
    """(d): what both ``model`` ranks hold whole has the same bits on both
    after the step, gradients and parameters; serve_seq's step is the
    default plan's, bit for bit."""
    got = [r['steps'][name, variant] for r in world['two']]
    assert _replicas_equal(got, 'grads') and _replicas_equal(got, 'params')
    if variant == 'serve_seq':
        base = [r['steps'][name, 'default'] for r in world['two']]
        for g, d in zip(got, base):
            assert g['loss'] == d['loss'] and g['grad_norm'] == d['grad_norm']
            for part in ('grads', 'params'):
                for k, (a, b) in g[part].items():
                    assert b == d[part][k][1], k
                    np.testing.assert_array_equal(a, d[part][k][0], k)


@pytest.mark.parametrize('case', FAULTS, ids=lambda c: '-'.join(c))
def test_a_planted_fault_fails_the_gradient_gate(world, case):
    """(e): each planted fault moves some gradient leaf past its gate,
    where the step as it is passes."""
    name = case[0]
    _, grads, _, _, nulls = world['meshless'][name]
    tol = 1e-5 if _cfg(name).family in ('ssm', 'hybrid') else 1e-6
    grads = {k: v for k, v in grads.items() if k != ZERO_GRAD}
    good = [r['steps'][case[:2]]['grads'] for r in world['two']]
    assert not _misses(good, grads, tol, nulls)
    bad = [r['faults'][case]['grads'] for r in world['two']]
    misses = _misses(bad, grads, tol, nulls)
    leaves = {k for _, k, _ in misses}
    want = {'rwkv6': 'layers/u', 'zamba2': 'layers/A_log',
            'qwen3': 'layers/q_norm'}[name]
    assert want in leaves, misses


def test_serve_dh_checkpoint_restores_onto_the_default_plan_and_meshless(
        world):
    """(f): the serve_dh (1, 2) step's checkpoint (its q/k norms' head_dim
    blocks, its whole projections written once) restores onto the default
    (1, 2) plan and meshless, every array the ranks held."""
    model = build_model(_cfg('qwen3'))
    shapes = dict(tr.leaves_with_paths(model.param_shapes()))
    saved = {}
    for r in world['two']:
        for k, (a, b) in r['steps']['qwen3', 'serve_dh']['params'].items():
            full = saved.setdefault(k, np.full(shapes[k], np.nan, np.float32))
            for piece, idx in b.pieces():
                full[tuple(slice(lo, hi) for lo, hi in piece.bounds)] = \
                    a[idx]
    assert not any(np.isnan(v).any() for v in saved.values())
    for r in world['two']:
        blocks = dict(r['restored'])
        assert blocks.pop('step') == (1, 1)
        for k, v in saved.items():
            a, b = blocks[f'params/{k}']
            np.testing.assert_array_equal(a, b.take(v), k)
        assert not blocks['params/layers/wq'][1].is_whole()
    zeros = tr.tree_map(torch.zeros, model.param_shapes())
    target = {'params': zeros, 'opt': opt.init_opt_state(zeros)}
    restored, step = ckpt.restore(world['ckpt_dir'], 1, target)
    assert step == 1
    for k, v in tr.leaves_with_paths(restored['params']):
        np.testing.assert_array_equal(v.detach().numpy(), saved[k], k)
