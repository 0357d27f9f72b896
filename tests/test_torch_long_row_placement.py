"""The reference's placement of a row that the batch axes cannot divide
(long_500k's one row under ``serve_dh``, ``serve_seq`` and
``serve_kv_dp``: ``distributed.tp.StepParallel.moved``) and of the
trainer's sequence split under ``TRAIN_RULES``
(``training.train_step.TrainPlan.batch_block``), against the JAX package
on the CPU.

- (a) Shape only, no ranks: for rwkv6-3b and zamba2-2.7b at long_500k
  under each variant, on (16, 16) and (2, 16, 16), every cache leaf's
  ``StepParallel.cache_block`` is the block of the reference's
  ``shaped_spec`` (its own function, on the same mesh description), for
  ranks spread over the mesh; every train_4k batch leaf's
  ``TrainPlan.batch_block``, with the rank's rows, is the block of the
  reference's ``batch_specs``.
- (b) Gloo ranks, ``reduced()`` widths, f32, B = 1, long_500k at S = 256,
  4 decode steps from position 126 from a seeded random cache: rwkv6 with
  3 wkv heads of 16 (``d_model`` 48: ``model`` 2 does not divide them, so
  ``serve_seq`` puts ``model`` on the state's K) and zamba2, each under
  the three variants at (data 2, model 2), and zamba2 under ``serve_dh``
  and rwkv6 under ``serve_seq`` at (pod 2, data 2, model 2), where
  ``pod`` or ``model`` lands on the layers (zamba2's conv state) or on
  the long KV's slots.  The ranks' blocks of the scores, gathered, are
  within atol 1e-4 of the reference's mesh step on an Auto-axis mesh of
  the conftest's virtual devices and of the port's meshless step, with
  greedy tokens equal; every rank that holds a block of the scores
  holds the same bits; each rank's cache leaves have the shapes of its
  blocks under the reference's specs.  A planted fault of each new
  collective moves the scores past 10x the gate: the long KV's head_dim
  partial scores not summed over the batch axes (``serve_kv_dp``), the
  last slot block's softmax state dropped (``serve_seq``), the output's
  head and head_dim blocks not gathered (``serve_dh``), a state's blocks
  not gathered before the layer (rwkv6 ``serve_kv_dp``), the computed
  wkv blocks not gathered over ``model`` after it (rwkv6 ``serve_seq``),
  and the other data rank's state block written back (rwkv6
  ``serve_dh``).
- (c) The trainer under ``TRAIN_RULES`` at (1, 2) and (2, 2), one step of
  qwen3 and of seamless (its frames split too): each rank's batch holds
  its block of the reference's ``batch_specs`` (half of each row's
  sequence); the loss, grad_norm and every gradient leaf are bit-equal
  to the same step under ``TRAIN_NO_SP_RULES`` (every rank its rows'
  whole sequence: the split moves the arguments, not the function);
  the loss within 1e-6 relative and every gradient leaf within 1e-5 of
  its max (or twice its null, ``orders.halved_products``) of the port's
  meshless step, loss and grad_norm within 1e-5 relative of the
  reference's meshless step; the sequence blocks gathered in the wrong
  order fail.

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
from repro_torch.configs import SHAPES, get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tp as tplib
from repro_torch.launch.mesh import describe, make_mesh
from repro_torch.launch.ranks import run_ranks
from repro_torch.models.api import build_model
from repro_torch.orders import halved_products
from repro_torch.training import tree as tr
from repro_torch.training.data import DataConfig, batch_at
from repro_torch.training.train_step import (TrainPlan, batch_rows,
                                             loss_and_grads,
                                             make_serve_step,
                                             make_train_step,
                                             mesh_loss_and_grads,
                                             shard_batch)

ATOL = 1e-4
TRAIN_TOL = 1e-6
# a gradient leaf against the meshless step, of its max: seamless's
# dec_layers/bk reads 1.44e-06 on (2, 2) here, beside a null of 3.7e-07,
# under TRAIN_NO_SP_RULES too (the same bits), so the mesh's own rounding;
# the split's gate is the bit-equality with that step
GRAD_TOL = 1e-5
REF_TOL = 1e-5
VARIANTS = ('serve_dh', 'serve_seq', 'serve_kv_dp')
AXES = {2: ('data', 'model'), 3: ('pod', 'data', 'model')}
# name: (arch, reduced() overrides)
CONFIGS = {'rwkv6': ('rwkv6-3b', dict(d_model=48)),
           'zamba2': ('zamba2-2.7b', {}),
           'qwen3': ('qwen3-0.6b', {}),
           'seamless': ('seamless-m4t-medium', {})}
LONG_S, POS0, N_STEPS = 256, 126, 4
# (config, variant, mesh shape, fault)
SERVE_CASES = [(c, v, (2, 2), None) for c in ('rwkv6', 'zamba2')
               for v in VARIANTS] + [('zamba2', 'serve_dh', (2, 2, 2), None),
                                     ('rwkv6', 'serve_seq', (2, 2, 2), None)]
# a planted fault of each new collective: (config, variant) at (2, 2)
FAULTS = {'unsummed_scores': ('zamba2', 'serve_kv_dp'),
          'dropped_block': ('zamba2', 'serve_seq'),
          'ungathered_output': ('zamba2', 'serve_dh'),
          'ungathered_state': ('rwkv6', 'serve_kv_dp'),
          'unshared_state': ('rwkv6', 'serve_seq'),
          'wrong_block': ('rwkv6', 'serve_dh')}
FAULT_CASES = [(c, v, (2, 2), f) for f, (c, v) in FAULTS.items()]
TRAIN_B, TRAIN_S = 4, 32
# (config, mesh shape, fault)
TRAIN_CASES = [(c, s, None) for c in ('qwen3', 'seamless')
               for s in ((1, 2), (2, 2))] + [('qwen3', (1, 2), 'swapped')]
ZERO_GRAD = 'dec_layers/xbk'       # seamless's exact-zero gradient
NULL_FACTOR = 2                    # a gradient gate may widen to 2x a null
RANK_TIMEOUT_S = 150
FAST_COMPILE = {'xla_backend_optimization_level': 0,
                'xla_llvm_disable_expensive_passes': True}
COMPILE_THREADS = 4


def _cfg(name):
    arch, kw = CONFIGS[name]
    return reduced(get_config(arch), **kw)


def _long_shape():
    return ShapeConfig('long_500k', LONG_S, 1, 'decode')


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


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else torch.tensor(v)
            for k, v in tree.items()}


def _long_inputs(model):
    """(a seeded random global cache of the long_500k shape, the decode
    steps' batches)."""
    rng = np.random.default_rng(30)
    flat = {k: (rng.normal(size=tuple(s)) * 0.5).astype(np.float32)
            for k, s in tr.leaves_with_paths(
                model.cache_shapes(_long_shape()))}
    steps = [{'tokens': rng.integers(1, model.cfg.vocab_size, 1)
              .astype(np.int32),
              'positions': np.full((1,), POS0 + i, np.int32)}
             for i in range(N_STEPS)]
    return _unflat(flat), steps


def _train_batch(cfg):
    batch = batch_at(DataConfig(seq_len=TRAIN_S, global_batch=TRAIN_B,
                                vocab_size=cfg.vocab_size), 0)
    mask = np.ones((TRAIN_B, TRAIN_S), np.float32)
    mask[0, :12] = 0
    mask[TRAIN_B - 1, 5:] = 0
    batch['loss_mask'] = mask
    if cfg.family == 'encdec':
        batch['frames'] = (np.random.default_rng(1).normal(
            size=(TRAIN_B, TRAIN_S, cfg.d_model)) * 0.02).astype(np.float32)
    return batch


# ---------------------------------------------------------------------------
# One rank (no jax), and the planted faults
# ---------------------------------------------------------------------------

def _repeated(x, sizes):
    """This rank's ``x`` in place of every rank's (a gather left out)."""
    return x.expand(tuple(sizes) + tuple(x.shape))


def _plant(fault, coords):
    """Plant ``fault`` (:data:`FAULTS`, or the trainer's 'swapped') in
    this rank's step; -> a function that takes it out."""
    sp = tplib.StepParallel
    saved = [(sp, n, getattr(sp, n)) for n in (
        'head_dim_sum', 'seq_combine', 'output_gather', 'state_gather',
        'state_share', 'written_block')] + [(tplib, 'unshard',
                                            tplib.unshard)]
    orig = {n: f for _, n, f in saved}
    sizes = lambda self, axes: [self.mesh.shape[a] for a in axes]  # noqa
    if fault == 'unsummed_scores':
        sp.head_dim_sum = lambda self, s, axes: s
    elif fault == 'dropped_block':
        def dropped(self, states, axes, order):
            parts = [tplib._in_block_order(self.axes_gather(t, axes), axes,
                                           order) for t in states]
            return tplib.cm.combine_partials(*(p[:-1] for p in parts))
        sp.seq_combine = dropped
    elif fault == 'ungathered_output':
        sp.output_gather = lambda self, out, axes: _repeated(
            out, sizes(self, axes))
    elif fault == 'ungathered_state':
        sp.state_gather = lambda self, piece, axes: _repeated(
            piece, sizes(self, axes))
    elif fault == 'unshared_state':
        sp.state_share = lambda self, new: _repeated(new, [self.n])
    elif fault == 'wrong_block':
        def other(self, keys):
            n = self.mesh.shape['data']
            return self.moved_block(keys, dict(
                self.coords, data=(self.coords['data'] + 1) % n))
        sp.written_block = other
    elif fault == 'swapped':
        tplib.unshard = lambda parts, s, e: orig['unshard'](
            parts.flip(0), s, e)

    def restore():
        for o, n, f in saved:
            setattr(o, n, f)
    return restore


def _serve(mesh, name, variant, params_npz):
    model = build_model(_cfg(name))
    shape = _long_shape()
    step = make_serve_step(model, mesh, shape,
                           rules=shd.RULE_VARIANTS[variant])[0]
    plan = step.plan
    params = shard_params(params_npz, model, mesh, plan=plan)
    host, batches = _long_inputs(model)
    cache = plan.shard_cache(_torch(host))
    blocks = []
    with torch.no_grad():
        for b in batches:
            cache, out = step(params, cache, plan.shard_batch(_torch(b)))
            blocks.append(out.numpy())
    return {'vocab': plan.vocab, 'moved': plan.moved, 'blocks': blocks,
            'coords': plan.mesh.coords(),
            'cache': {k: tuple(t.shape)
                      for k, t in tr.leaves_with_paths(cache)}}


def _train(mesh, name, params_npz, rules=None):
    model = build_model(_cfg(name))
    step = make_train_step(model, mesh, rules=rules)
    plan = step.plan
    params = plan.shard_params(params_from_jax(params_npz))
    rows = shard_batch(_train_batch(model.cfg), plan)
    loss, grads = mesh_loss_and_grads(model, plan, params, rows)
    _, _, m = step(params, plan.init_opt_state(), rows)
    return {'loss': float(loss), 'grad_norm': float(m['grad_norm']),
            'coords': mesh.coords(),
            'batch': {k: tuple(v.shape) for k, v in rows.items()},
            'grads': {k: (v.detach().numpy(), plan.param_blocks[k])
                      for k, v in tr.leaves_with_paths(grads)}}


def _rank(rank, shape, npzs, serve_cases, train_cases):
    """The cases of this mesh on this rank: {case: its results}."""
    torch.set_num_threads(1)
    mesh = make_mesh(shape, AXES[len(shape)], device='cpu')
    out = {'jax': 'jax' in sys.modules}
    params = {n: _unflat(dict(np.load(p))) for n, p in npzs.items()}
    for case in serve_cases:
        name, variant, _, fault = case
        restore = _plant(fault, mesh.coords())
        try:
            out[case] = _serve(mesh, name, variant, params[name])
        finally:
            restore()
    for case in train_cases:
        name, _, fault = case
        restore = _plant(fault, mesh.coords())
        try:
            out[case] = _train(mesh, name, params[name])
        finally:
            restore()
        if fault is None:          # the same step without the split
            out[case + ('no_sp',)] = _train(mesh, name, params[name],
                                            shd.TRAIN_NO_SP_RULES)
    return out


# ---------------------------------------------------------------------------
# The references (in the test process)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _pair(name):
    """(reference model, port model, the reference's f32 weights as
    numpy)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as j_get_config
    from repro.configs import reduced as j_reduced
    from repro.models.api import build_model as j_build_model

    arch, kw = CONFIGS[name]
    jmodel = j_build_model(j_reduced(j_get_config(arch), **kw))
    params = jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)),
                          jmodel.init_params(jax.random.PRNGKey(3)))
    return jmodel, build_model(_cfg(name)), params


def _jshape(shape):
    from repro.configs.base import ShapeConfig as JShape
    return JShape(shape.name, shape.seq_len, shape.global_batch, shape.kind)


def _reference(name, variant, mesh):
    """The reference's mesh step's scores, a decode step, on ``mesh``."""
    import jax
    import jax.numpy as jnp

    from repro.distributed.sharding import RULE_VARIANTS
    from repro.training import train_step as jts

    jm, tm, params = _pair(name)
    jparams = jax.tree.map(jnp.asarray, params)
    host, batches = _long_inputs(tm)
    cache = jax.tree.map(jnp.asarray, host)
    step = jts.make_serve_step(jm, mesh, _jshape(_long_shape()),
                               rules=RULE_VARIANTS[variant])[0]
    compiled, scores = None, []
    for b in batches:
        b = jax.tree.map(jnp.asarray, b)
        if compiled is None:
            compiled = step.lower(jparams, cache, b).compile(FAST_COMPILE)
        cache, out = compiled(jparams, cache, b)
        scores.append(np.asarray(out))
    return scores


def _reference_train(name):
    """The reference's meshless train step's metrics."""
    import jax
    from repro.training import optimizer as jopt
    from repro.training.train_step import make_train_step as j_step

    jm, _, params = _pair(name)
    jstep, _ = j_step(jm, None)
    jp = jax.tree.map(jax.numpy.asarray, params)
    batch = jax.tree.map(jax.numpy.asarray, _train_batch(jm.cfg))
    _, _, m = jstep(jp, jopt.init_opt_state(jp), batch)
    return {k: float(v) for k, v in m.items()}


@functools.lru_cache(maxsize=None)
def _meshless(name):
    """The port's meshless long_500k decode scores, a step."""
    _, tm, params = _pair(name)
    tparams = params_from_jax(params)
    host, batches = _long_inputs(tm)
    step = make_serve_step(tm, None, _long_shape())[0]
    cache, scores = _torch(host), []
    with torch.no_grad():
        for b in batches:
            cache, out = step(tparams, cache, _torch(b))
            scores.append(out.numpy())
    return scores


@functools.lru_cache(maxsize=None)
def _meshless_train(name):
    """The port's meshless loss, its gradients and each gradient leaf's
    null as a share of its max (the step again with every f32 product's
    sum in two halves, ``orders.halved_products``: the rounding a
    row-parallel product's sum over two ranks adds), as
    ``tests/test_torch_train_mesh.py`` holds seamless."""
    _, tm, params = _pair(name)
    batch = {k: torch.from_numpy(v)
             for k, v in _train_batch(tm.cfg).items()}
    loss, grads = loss_and_grads(
        tm, params_from_jax(params, requires_grad=True), batch)
    grads = {k: v.numpy() for k, v in tr.leaves_with_paths(grads)}
    with halved_products(torch.float32):
        _, null = loss_and_grads(
            tm, params_from_jax(params, requires_grad=True), batch)
    nulls = {k: _rel(v.numpy(), grads[k])
             for k, v in tr.leaves_with_paths(null)}
    return float(loss), grads, nulls


_WORLD = {}


@pytest.fixture(scope='module')
def world(make_virtual_mesh, tmp_path_factory):
    """{'ranks': {mesh shape: every rank's results}, 'want': the
    reference's scores by (config, variant, mesh shape), 'train': the
    reference's train metrics by config}: one spawn of ranks a mesh, the
    references computed meanwhile."""
    if _WORLD:
        return _WORLD
    tmp = tmp_path_factory.mktemp('long_row')
    npzs = {}
    for name in CONFIGS:
        npzs[name] = str(tmp / f'{name}.npz')
        np.savez(npzs[name], **_flat(_pair(name)[2]))
    cases = SERVE_CASES + FAULT_CASES
    shapes = sorted({c[2] for c in cases} | {c[1] for c in TRAIN_CASES})
    with ThreadPoolExecutor(len(shapes)) as pool:
        ranks = {s: pool.submit(
            run_ranks, _rank, int(np.prod(s)), store_dir=tmp / 'x'.join(
                map(str, s)), device_type='cpu',
            args=(s, npzs, [c for c in cases if c[2] == s],
                  [c for c in TRAIN_CASES if c[1] == s]),
            timeout_s=RANK_TIMEOUT_S) for s in shapes}
        meshes = {s: make_virtual_mesh(s, AXES[len(s)])
                  for s in {c[2] for c in SERVE_CASES}}
        with ThreadPoolExecutor(COMPILE_THREADS) as refs:
            want = {c[:3]: refs.submit(_reference, c[0], c[1], meshes[c[2]])
                    for c in SERVE_CASES}
            train = {n: refs.submit(_reference_train, n)
                     for n in {c[0] for c in TRAIN_CASES}}
            want = {k: f.result() for k, f in want.items()}
            train = {k: f.result() for k, f in train.items()}
        _WORLD.update(ranks={s: f.result() for s, f in ranks.items()},
                      want=want, train=train)
    return _WORLD


def _gathered(out, case, i, shape):
    """Step ``i``'s scores assembled from every rank's vocabulary block;
    every rank that holds a block holds the same bits."""
    full = np.full(shape, np.nan, np.float32)
    for o in out:
        lo, hi = o[case]['vocab']
        block = o[case]['blocks'][i]
        assert block.shape == (shape[0], hi - lo)
        seen = full[:, lo:hi]
        assert np.isnan(seen).all() or np.array_equal(seen, block), \
            f'{case} step {i}: ranks differ'
        full[:, lo:hi] = block
    assert not np.isnan(full).any()
    return full


# ---------------------------------------------------------------------------
# (a) Shape only
# ---------------------------------------------------------------------------

LAYOUTS = {'16x16': ((16, 16), AXES[2]), '2x16x16': ((2, 16, 16), AXES[3])}


@pytest.mark.parametrize('layout', list(LAYOUTS))
@pytest.mark.parametrize('variant', VARIANTS)
@pytest.mark.parametrize('arch', ['rwkv6-3b', 'zamba2-2.7b'])
def test_cache_blocks_are_the_reference_s(arch, variant, layout):
    from repro.distributed.sharding import RULE_VARIANTS as J_RULES
    from repro.distributed.sharding import shaped_spec as j_shaped_spec

    model = build_model(get_config(arch))
    shape = SHAPES['long_500k']
    mesh = describe(*LAYOUTS[layout])
    axes = dict(tr.leaves_with_paths(model.cache_axes(shape)))
    shapes = dict(tr.leaves_with_paths(model.cache_shapes(shape)))
    n = int(np.prod(LAYOUTS[layout][0]))
    for r in sorted({0, 1, 17, 37, n // 2 + 5, n - 1}):
        coords = mesh.coords(r)
        plan = tplib.StepParallel(model.cfg, mesh, coords, batch=1,
                                  seq_len=shape.seq_len,
                                  rules=shd.RULE_VARIANTS[variant])
        assert plan.moved
        for leaf, s in shapes.items():
            spec = tuple(j_shaped_spec(s, axes[leaf], J_RULES[variant],
                                       mesh))
            want = shd.local_bounds(s, spec, mesh, coords)
            got = plan.cache_block(tuple(leaf.split('/')), s)
            assert got == want, (leaf, spec, got, want)


@pytest.mark.parametrize('layout', list(LAYOUTS))
@pytest.mark.parametrize('arch', ['qwen3-0.6b', 'seamless-m4t-medium',
                                  'llava-next-mistral-7b', 'rwkv6-3b'])
def test_train_batch_blocks_are_the_reference_s(arch, layout):
    """Each train_4k batch leaf: the rank's rows and its block beyond them
    are the block of the reference's ``batch_specs`` (their specs built by
    its ``shaped_spec`` from its ``input_specs`` / ``input_axes``, as
    ``batch_specs`` builds them)."""
    from repro.configs import get_config as j_get_config
    from repro.configs.base import SHAPES as J_SHAPES
    from repro.distributed.sharding import TRAIN_RULES as J_TRAIN_RULES
    from repro.distributed.sharding import shaped_spec as j_shaped_spec
    from repro.models.api import build_model as j_build_model

    model = build_model(get_config(arch))
    jmodel = j_build_model(j_get_config(arch))
    shape = SHAPES['train_4k']
    mesh = describe(*LAYOUTS[layout])
    jspecs = jmodel.input_specs(J_SHAPES['train_4k'])
    n = int(np.prod(LAYOUTS[layout][0]))
    for r in (0, 18, n - 1):
        coords = mesh.coords(r)
        plan = TrainPlan(model, mesh, coords=coords)
        rows = batch_rows(shape.global_batch, plan)
        for k, axes in jmodel.input_axes(J_SHAPES['train_4k']).items():
            s = tuple(jspecs[k].shape)
            spec = tuple(j_shaped_spec(s, axes, J_TRAIN_RULES, mesh))
            want = shd.local_bounds(s, spec, mesh, coords)
            got = plan.batch_block(k, s)
            assert (rows[0], rows[-1] + 1) == want.intervals(0)[0], k
            assert got.bounds[1:] == want.bounds[1:], (k, got, want)


# ---------------------------------------------------------------------------
# (b) The serve step on gloo ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('case', SERVE_CASES,
                         ids=lambda c: f'{c[0]}-{c[1]}-'
                         f'{"x".join(map(str, c[2]))}')
def test_long_row_step_matches_the_reference(world, case):
    out = world['ranks'][case[2]]
    assert not any(o['jax'] for o in out)
    assert all(o[case]['moved'] for o in out)
    meshless = _meshless(case[0])
    for i, ref in enumerate(world['want'][case[:3]]):
        got = _gathered(out, case, i, ref.shape)
        np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL,
                                   err_msg=f'{case} step {i}: reference')
        np.testing.assert_allclose(got, meshless[i], rtol=0, atol=ATOL,
                                   err_msg=f'{case} step {i}: meshless')
        np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
    # each rank's cache blocks: the reference's specs' shapes
    model = build_model(_cfg(case[0]))
    shape = _long_shape()
    mesh = describe(case[2], AXES[len(case[2])])
    specs = shd.tree_spec_shaped(model.cache_axes(shape),
                                 model.cache_shapes(shape),
                                 shd.RULE_VARIANTS[case[1]], mesh)
    shapes = dict(tr.leaves_with_paths(model.cache_shapes(shape)))
    for o in out:
        for leaf, spec in tr.leaves_with_paths(specs):
            want = shd.local_bounds(shapes[leaf], spec.spec, mesh,
                                    o[case]['coords']).local_shape
            assert o[case]['cache'][leaf] == want, (leaf, spec)


@pytest.mark.parametrize('fault', list(FAULTS))
def test_a_planted_fault_fails_the_gate(world, fault):
    case = FAULT_CASES[list(FAULTS).index(fault)]
    out = world['ranks'][case[2]]
    meshless = _meshless(case[0])
    errs = []
    for i, m in enumerate(meshless):
        full = np.full(m.shape, np.nan, np.float32)
        for o in out:      # the faults may leave the ranks apart
            lo, hi = o[case]['vocab']
            full[:, lo:hi] = o[case]['blocks'][i]
        errs.append(float(np.abs(full - m).max()))
    assert max(errs) > 10 * ATOL, (fault, errs)


# ---------------------------------------------------------------------------
# (c) The trainer's sequence split
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('case', [c for c in TRAIN_CASES if c[2] is None],
                         ids=lambda c: f'{c[0]}-{"x".join(map(str, c[1]))}')
def test_sequence_split_step_matches(world, case):
    name, shape, _ = case
    out = [o[case] for o in world['ranks'][shape]]
    loss, grads, nulls = _meshless_train(name)
    cfg = _cfg(name)
    mesh = describe(shape, AXES[2])
    batch = _train_batch(cfg)
    for o in out:
        plan = TrainPlan(build_model(cfg), mesh, coords=o['coords'])
        for k, v in batch.items():
            b = plan.batch_block(k, v.shape)
            assert o['batch'][k] == (TRAIN_B // shape[0],) + \
                b.local_shape[1:], k
        # the sequence is cut over model: half of it a rank
        assert o['batch']['tokens'][1] == TRAIN_S // shape[1]
    # the split moves where the batch lies, not the function: the step
    # under TRAIN_NO_SP_RULES (every rank its rows' whole sequence) gives
    # the same bits
    for o, n in zip(out, [o[case + ('no_sp',)]
                          for o in world['ranks'][shape]]):
        assert n['batch']['tokens'][1] == TRAIN_S
        assert (o['loss'], o['grad_norm']) == (n['loss'], n['grad_norm'])
        for k, (g, _) in o['grads'].items():
            assert np.array_equal(g, n['grads'][k][0]), k
    assert len({o['loss'] for o in out}) == 1
    assert out[0]['loss'] == pytest.approx(loss, rel=TRAIN_TOL)
    stack = max((np.abs(v).max() for k, v in grads.items()
                 if k.startswith('dec_layers/')), default=0.0)
    for o in out:
        for k, (g, blk) in o['grads'].items():
            want = blk.take(grads[k])
            if k == ZERO_GRAD:     # its exact gradient is 0
                assert np.abs(g).max() <= TRAIN_TOL * stack
                continue
            assert _rel(g, want) <= max(GRAD_TOL, NULL_FACTOR * nulls[k]), \
                (k, _rel(g, want), nulls[k])
    ref = world['train'][name]
    assert out[0]['loss'] == pytest.approx(ref['loss'], rel=REF_TOL)
    assert out[0]['grad_norm'] == pytest.approx(ref['grad_norm'],
                                                rel=REF_TOL)


def test_swapped_sequence_blocks_fail(world):
    """The sequence blocks gathered in the wrong order (rank 1's first)
    move the loss past the gate."""
    case = next(c for c in TRAIN_CASES if c[2] == 'swapped')
    loss = _meshless_train(case[0])[0]
    got = world['ranks'][case[1]][0][case]['loss']
    assert abs(got / loss - 1) > 100 * TRAIN_TOL, (got, loss)
