"""The trainer's mesh branch (``make_train_step(model, mesh)``,
``training/train_step.py``), ZeRO-1, the int8 compressed all-reduce and
checkpoints written from blocks, against the port's meshless step and the
reference on the CPU.

Ranks are processes (``launch.ranks.run_ranks``, gloo): one run of 4 ranks
and then one of 2 (module fixtures), each doing every case of its size,
so the file spawns twice.  The ranks import no jax; the reference runs in
this process, on the conftest's virtual CPU devices where it needs a
mesh.  Weights are the reference's ``init_params`` in f32, carried to the
ranks as an ``.npz``.

Tolerances (f32; the mesh sums in another order than one device):
- the step against the port's meshless step: loss and ``grad_norm``
  within 1e-6 relative; every gradient leaf within 1e-6 of the leaf's max
  |x| (1e-5 for rwkv6's and zamba2's, the recurrences).  The optimizer is
  ``AdamWConfig()``'s default (warmup 100: the first step's lr is 3e-6).
  At lr 3e-3 the parameters after one step differ by up to 1.6e-4 of a
  leaf's max (measured): AdamW's first update g / (|g| + 1e-8) turns an
  f32 rounding difference in a gradient element near 1e-8 into a large
  share of its update, so the gradients, where the mesh's arithmetic
  shows, are held to 1e-6 directly.  dense, vlm and moe hold every
  parameter leaf after the step within 1e-6 of its max too.
- rwkv6, zamba2 and seamless: each gradient leaf within that or within
  twice its null where that is larger (the meshless gradient with every
  f32 product's sum in two halves, ``orders.halved_products``: the
  rounding a row-parallel product's f32 sum over the ranks adds; measured
  here up to 1.4e-3 of a leaf's max for rwkv6, 3.0e-6 for seamless, where
  the mesh's own errors reach 3.0e-5 and 1.6e-6).  Their parameters are
  held by each rank's block of each leaf's update, ``||(after - before) -
  (want - before)|| / ||want - before||`` within 0.1 (UPDATE_TOL): a block
  left unchanged reads 1, one moved the wrong way 2, and the sign flips
  that rounding decides in AdamW's first update of an element whose
  gradient is near 0 read ~2 sqrt(their share) (measured here at most
  1e-2; element-wise, one such flip is 2e-5 of a seamless leaf's max, past
  1e-6).  ``test_an_unchanged_block_fails_the_update_gate`` plants every
  block unchanged in turn.  seamless's ``dec_layers/xbk`` has the exact
  gradient 0 (softmax ignores the bias it adds to every score of a
  query), so its gradient is held within 1e-6 of the decoder stack's
  largest on both sides and its parameter within lr of 0;
- against the reference's meshless step, the port's meshless parity
  test's (``tests/test_torch_training.py``): loss and ``grad_norm`` 1e-5
  relative, or, for rwkv6 and zamba2, twice the reference's own spread
  where that is larger (its step with the recurrence's chunked form at
  chunks 8 and 16 in place of one chunk of the sequence: up to 2.8e-5 in
  rwkv6's grad_norm, where the port's meshless step is 1.1e-5 from it);
  parameters not drawn as zeros 1e-4 of the leaf max; rwkv6, zamba2 and
  seamless also every block's update within UPDATE_TOL of the
  reference's;
- leaves replicated over ``model`` get bit-equal gradients on its ranks;
  ZeRO-1 on and off give bit-equal parameters;
- the compressed all-reduce: outputs and residuals within 1e-7 of the
  reference's, and the reference test's ``rel < 0.15`` and ``rel2 <
  rel``;
- checkpoints across meshes and packages: every array exact;
- failover at (2, 2) -> (1, 2): losses within 1e-4 of the unbroken run.
"""

import functools

import numpy as np
import pytest
import torch

from repro_torch.bridge import (opt_state_from_jax, params_from_jax,
                                shard_opt_state, tree_to_jax)
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.sharding import Block
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.launch.ranks import run_ranks
from repro_torch.launch.train import train
from repro_torch.models.api import build_model
from repro_torch.orders import halved_products
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as opt
from repro_torch.training import tree as tr
from repro_torch.training.compression import (init_error_state,
                                              make_compressed_allreduce)
from repro_torch.training.data import DataConfig, batch_at
from repro_torch.training.fault_tolerance import (HeartbeatConfig,
                                                  HeartbeatMonitor,
                                                  plan_recovery)
from repro_torch.training.train_step import (
    TrainPlan, batch_specs, loss_and_grads, make_train_step,
    mesh_loss_and_grads, param_specs, shard_batch)

AXES = ('data', 'model')
RANK_TIMEOUT_S = 120
B, S = 4, 32
# (mesh, microbatches, config, clip): a 'kv' config holds one kv-head a
# rank, replicated over 2 ranks, at model = 4
# rwkv6, zamba2 and seamless over model at (1, 2) and (2, 2), with and
# without microbatches; 'seamless-kv' at model = 4 replicates its 2
# kv-heads (one a rank, over 2 ranks) and cuts its vocabulary of 510 on
# d_model
FAMILY_NAMES = ('rwkv6', 'zamba2', 'seamless')
SPLIT_FAMILIES = ('ssm', 'hybrid', 'encdec')    # their families
STEP_CASES = [((2, 1), 1, 'base', 1.0), ((2, 1), 2, 'base', 1.0),
              ((1, 2), 1, 'base', 1.0), ((1, 2), 2, 'base', 1.0),
              ((2, 2), 1, 'base', 1.0), ((2, 2), 2, 'base', 100.0),
              ((1, 4), 1, 'kv', 1.0), ((2, 2), 1, 'vlm', 1.0),
              ((1, 2), 1, 'moe', 1.0), ((1, 2), 2, 'moe', 1.0),
              ((2, 2), 1, 'moe', 1.0)] + [
    (shape, micro, name, 1.0) for name in FAMILY_NAMES
    for shape in ((1, 2), (2, 2)) for micro in (1, 2)] + [
    ((1, 4), 1, 'seamless-kv', 1.0)]
CONFIGS = {'base': dict(arch='qwen3-0.6b'),
           'kv': dict(arch='qwen3-0.6b', n_heads=8, n_kv_heads=2),
           'vlm': dict(arch='llava-next-mistral-7b'),
           'moe': dict(arch='phi3.5-moe-42b-a6.6b', n_experts=16),
           'ckpt': dict(arch='internlm2-1.8b'),
           'rwkv6': dict(arch='rwkv6-3b'), 'zamba2': dict(arch='zamba2-2.7b'),
           'seamless': dict(arch='seamless-m4t-medium'),
           'seamless-kv': dict(arch='seamless-m4t-medium', vocab_size=510)}
# the leaves expert parallelism cuts
EXPERT_LEAVES = ('layers/router', 'layers/we_gate', 'layers/we_up',
                 'layers/we_down')
# data-parallel families: (arch, reduced() overrides); at 16 experts the
# capacity (1.25) drops assignments at this size
FAMILIES = {'rwkv6-3b': {}, 'zamba2-2.7b': {}, 'seamless-m4t-medium': {},
            'phi3.5-moe-42b-a6.6b': {'n_experts': 16}}
MOE = 'phi3.5-moe-42b-a6.6b'
FAIL = dict(lr=3e-3, warmup_steps=1)        # the reference failover test's
TRAIN_ARCHS, TRAIN_STEPS = ('rwkv6-3b', 'zamba2-2.7b'), 2   # train(mesh=)
ZERO_GRAD = 'dec_layers/xbk'                # seamless's exact-zero gradient
NULL_FACTOR = 2                             # a gate may widen to 2x a null
UPDATE_TOL = 0.1                            # a block's update, of its norm
REF_CHUNKS = (8, 16)                        # the reference's chunk nulls
FAIL_B, FAIL_STEPS, FAIL_AT = 8, 6, 3


def _cfg(name):
    kw = dict(CONFIGS[name])
    return reduced(get_config(kw.pop('arch')), **kw)


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


def _batch(cfg, step=0, b=B):
    """``batch_at`` with a loss mask that gives every data shard of every
    microbatch its own token count."""
    batch = batch_at(DataConfig(seq_len=S, global_batch=b,
                                vocab_size=cfg.vocab_size), step)
    mask = np.ones((b, S), np.float32)
    mask[0, :12] = 0
    mask[b - 1, 5:] = 0
    batch['loss_mask'] = mask
    if cfg.frontend is not None:           # vlm: the frontend's output
        batch['prefix_embeds'] = (np.random.default_rng(step).normal(
            size=(b, cfg.frontend_tokens, cfg.d_model)) * 0.02).astype(
                np.float32)
    if cfg.family == 'encdec':             # the speech frames
        batch['frames'] = (np.random.default_rng(step).normal(
            size=(b, S, cfg.d_model)) * 0.02).astype(np.float32)
    return batch


def _seeded(model):
    """The port's seed-0 weights in f32, as nested dicts."""
    return tr.tree_map(lambda x: x.detach().float(),
                       model.init_params(0, device='cpu'))


def _blocks(tree, plan):
    """{path: (array, Block)} of this rank's blocks."""
    return {k: (v.detach().cpu().numpy(), plan.param_blocks[k])
            for k, v in tr.leaves_with_paths(tree)}


def _step_case(case, npz):
    shape, micro, name, clip = case
    mesh = make_mesh(shape, AXES, device='cpu')
    model = build_model(_cfg(name))
    ocfg = opt.AdamWConfig(grad_clip=clip)
    step = make_train_step(model, mesh, opt_cfg=ocfg, microbatches=micro)
    plan = step.plan
    params = plan.shard_params(params_from_jax(_unflat(dict(np.load(npz)))))
    rows = shard_batch(_batch(model.cfg), plan, micro)
    loss, grads = mesh_loss_and_grads(model, plan, params, rows, micro)
    params, _, m = step(params, plan.init_opt_state(), rows)
    return {'loss': float(m['loss']), 'grad_norm': float(m['grad_norm']),
            'grad_loss': float(loss), 'grads': _blocks(grads, plan),
            'params': _blocks(params, plan)}


def _fail_steps(plan, step, params, state, lo, hi):
    model = plan.model
    losses = []
    for s in range(lo, hi):
        b = batch_at(DataConfig(seq_len=S, global_batch=FAIL_B,
                                vocab_size=model.cfg.vocab_size), s)
        params, state, m = step(params, state, shard_batch(b, plan))
        losses.append(float(m['loss']))
    return params, state, losses


def _rank_four(rank, npzs, g_global, ckpt_npz, dirs):
    """Every 4-rank case: the steps at (2, 2) and (1, 4), the compressed
    all-reduce, a checkpoint of internlm2 from (2, 2), the failover run."""
    torch.set_num_threads(1)        # ranks share this host's cores
    out = {'steps': {case: _step_case(case, npzs[case[2]])
                     for case in STEP_CASES if np.prod(case[0]) == 4}}

    mesh = make_mesh((4, 1), AXES, device='cpu')
    fn = make_compressed_allreduce(mesh, ('data',))
    g = {'w': torch.from_numpy(g_global[rank:rank + 1])}
    red, err = fn(g, init_error_state(g))
    red2, _ = fn({'w': torch.zeros_like(g['w'])}, err)
    out['compressed'] = [x['w'].numpy() for x in (red, err, red2)]

    mesh = make_mesh((2, 2), AXES, device='cpu')
    plan = TrainPlan(build_model(_cfg('ckpt')), mesh)
    state = _unflat(dict(np.load(ckpt_npz)))
    tree = {'params': plan.shard_params(params_from_jax(state['params'])),
            'opt': shard_opt_state(dict(state['opt'], step=1), plan)}
    ckpt.save(dirs['port'], 1, tree, mesh=mesh, specs=plan.blocks())

    # moe and zamba2 at (2, 2): ZeRO-1 on against off over two steps,
    # then a checkpoint of the ZeRO-1 run
    for name in ('moe', 'zamba2'):
        fmodel = build_model(_cfg(name))
        full = params_from_jax(_unflat(dict(np.load(npzs[name]))))
        ends = []
        for zero1 in (True, False):
            step = make_train_step(fmodel, mesh,
                                   opt_cfg=opt.AdamWConfig(**FAIL),
                                   zero1=zero1)
            params = step.plan.shard_params(full)
            state = step.plan.init_opt_state()
            for s in range(2):
                params, state, _ = step(params, state, shard_batch(
                    _batch(fmodel.cfg, s), step.plan))
            ends.append((params, state, step.plan))
        out[f'{name}_zero1'] = (
            all(torch.equal(a, b) for a, b in
                zip(tr.leaves(ends[0][0]), tr.leaves(ends[1][0]))),
            [[tuple(m.shape) for m in tr.leaves(e[1]['mu'])] for e in ends])
        params, state, plan = ends[0]
        ckpt.save(dirs[name], 2, {'params': params, 'opt': state},
                  mesh=mesh, specs=plan.blocks())
        out[f'{name}_saved'] = _blocks(params, plan)

    model = build_model(_cfg('base'))
    step = make_train_step(model, mesh, opt_cfg=opt.AdamWConfig(**FAIL))
    plan = step.plan
    full = params_from_jax(_unflat(dict(np.load(npzs['base']))))
    runs = []
    for hi in (FAIL_STEPS, FAIL_AT):
        params, state, losses = _fail_steps(
            plan, step, plan.shard_params(full), plan.init_opt_state(), 0, hi)
        runs.append(losses)
    ckpt.save(dirs['fail'], FAIL_AT, {'params': params, 'opt': state},
              mesh=mesh, specs=plan.blocks())
    out['fail'] = runs
    return out


def _restore_blocks(d, step, plan):
    """This rank's blocks of checkpoint ``step`` under ``plan``, by leaf
    ('params/..', 'mu/..', 'nu/..'), with their bounds."""
    zeros = tr.tree_map(torch.zeros, plan.model.param_shapes())
    target = {'params': plan.shard_params(zeros),
              'opt': plan.init_opt_state()}
    state, got = ckpt.restore(d, step, target, shardings=plan.blocks())
    blocks = {'step': int(state['opt']['step'])}
    for part, tree in (('params', state['params']), ('mu', state['opt']['mu']),
                       ('nu', state['opt']['nu'])):
        for k, v in tr.leaves_with_paths(tree):
            b = (plan.param_blocks[k] if part == 'params'
                 else plan.moment_block(k))
            blocks[f'{part}/{k}'] = (v.detach().numpy(), b)
    return got, blocks


def _rank_two(rank, npzs, dirs, new_shape, restore_step):
    """Every 2-rank case: the steps at (2, 1) and (1, 2), ZeRO-1 on against
    off, data-parallel rwkv6 and zamba2 against their meshless steps,
    restores onto (1, 2) and (2, 1), zamba2 with a norm that sums only its
    own heads, ``launch.train.train`` over model, the failover's
    restart."""
    torch.set_num_threads(1)
    out = {'steps': {case: _step_case(case, npzs[case[2]])
                     for case in STEP_CASES if np.prod(case[0]) == 2}}

    mesh = make_mesh((2, 1), AXES, device='cpu')
    model = build_model(_cfg('base'))
    full = params_from_jax(_unflat(dict(np.load(npzs['base']))))
    ends = []
    for zero1 in (True, False):
        step = make_train_step(model, mesh, opt_cfg=opt.AdamWConfig(**FAIL),
                               microbatches=2, zero1=zero1)
        params, state = step.plan.shard_params(full), step.plan.init_opt_state()
        for s in range(2):
            params, state, _ = step(params, state, shard_batch(
                _batch(model.cfg, s), step.plan, 2))
        ends.append((params, [tuple(m.shape) for m in tr.leaves(state['mu'])]))
    out['zero1'] = {
        'equal': all(torch.equal(a, b) for a, b in
                     zip(tr.leaves(ends[0][0]), tr.leaves(ends[1][0]))),
        'moments': [ends[0][1], ends[1][1]]}

    out['families'] = {}
    for arch, kw in FAMILIES.items():
        fmodel = build_model(reduced(get_config(arch), **kw))
        plan = TrainPlan(fmodel, mesh)
        loss, grads = mesh_loss_and_grads(
            fmodel, plan, plan.shard_params(_seeded(fmodel)),
            shard_batch(_batch(fmodel.cfg), plan), 1)
        out['families'][arch] = (float(loss), _blocks(grads, plan))

    plan = TrainPlan(build_model(_cfg('ckpt')), make_mesh((1, 2), AXES,
                                                          device='cpu'))
    out['port_onto_12'] = _restore_blocks(dirs['port'], 1, plan)
    plan = TrainPlan(build_model(_cfg('ckpt')), mesh)
    out['ref_onto_21'] = _restore_blocks(dirs['ref'], 1, plan)
    mesh12 = make_mesh((1, 2), AXES, device='cpu')
    for name in ('moe', 'zamba2'):
        plan = TrainPlan(build_model(_cfg(name)), mesh12)
        out[f'{name}_onto_12'] = _restore_blocks(dirs[name], 2, plan)

    # the mutant: zamba2's gated norm over this rank's heads only
    zmodel = build_model(_cfg('zamba2'))
    plan = TrainPlan(zmodel, mesh12)
    zparams = plan.shard_params(params_from_jax(_unflat(dict(np.load(
        npzs['zamba2'])))))
    tp_cls = type(plan.tp)
    norm_sum = tp_cls.norm_sum
    tp_cls.norm_sum = lambda self, part: part
    try:
        loss, grads = mesh_loss_and_grads(
            zmodel, plan, zparams, shard_batch(_batch(zmodel.cfg), plan), 1)
    finally:
        tp_cls.norm_sum = norm_sum
    out['norm_mutant'] = (float(loss), _blocks(grads, plan))

    # the driver over model
    out['train'] = {arch: train(arch, mesh=mesh12, steps=TRAIN_STEPS,
                                batch=B, seq=S, log_every=TRAIN_STEPS + 1)[2]
                    for arch in TRAIN_ARCHS}

    mesh = make_mesh(new_shape, AXES, device='cpu')
    step = make_train_step(model, mesh, opt_cfg=opt.AdamWConfig(**FAIL))
    plan = step.plan
    target = {'params': plan.shard_params(full), 'opt': plan.init_opt_state()}
    state, at = ckpt.restore(dirs['fail'], restore_step, target,
                             shardings=plan.blocks())
    out['fail'] = _fail_steps(plan, step, state['params'], state['opt'], at,
                              FAIL_STEPS)[2]
    return out


# ---------------------------------------------------------------------------
# The reference side (this process) and the two runs of ranks
# ---------------------------------------------------------------------------

def _j():
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as j_get_config
    from repro.configs import reduced as j_reduced
    from repro.models.api import build_model as j_build_model
    return jax, jnp, j_get_config, j_reduced, j_build_model


def _jmodel(name):
    _, _, j_get_config, j_reduced, j_build_model = _j()
    kw = dict(CONFIGS[name])
    return j_build_model(j_reduced(j_get_config(kw.pop('arch')), **kw))


def _jparams(name):
    jax, jnp, *_ = _j()
    params = _jmodel(name).init_params(jax.random.PRNGKey(0))
    return jax.tree.map(lambda x: x.astype(jnp.float32), params)


def _np(tree):
    import jax
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


@pytest.fixture(scope='module')
def world(tmp_path_factory, make_virtual_mesh):
    """The reference's weights and checkpoint, then the 4-rank run, then
    the 2-rank run (which restores what the first wrote)."""
    import jax
    from jax.sharding import NamedSharding

    from repro.training import checkpoint as jckpt
    from repro.training import optimizer as jopt
    from repro.training.train_step import make_train_step as j_step
    from repro.training.train_step import param_specs as j_param_specs

    root = tmp_path_factory.mktemp('train_mesh')
    dirs = {k: str(root / k) for k in ('port', 'ref', 'fail', 'moe',
                                       'zamba2')}
    trees, npzs = {}, {}
    for name in [n for n in CONFIGS if n != 'ckpt']:
        trees[name] = _np(_jparams(name))
        npzs[name] = str(root / f'{name}.npz')
        np.savez(npzs[name], **_flat(trees[name]))

    # internlm2 (an untied, vocab-split head) after one reference step,
    # saved by the reference from a (4, 2) mesh, ZeRO-1 moments
    jmodel, jp = _jmodel('ckpt'), _jparams('ckpt')
    jstep, _ = j_step(jmodel, None)
    batch = jax.tree.map(jax.numpy.asarray, _batch(jmodel.cfg))
    jp, js, _ = jstep(jp, jopt.init_opt_state(jp), batch)
    state = {'params': _np(jp), 'opt': _np({'mu': js['mu'], 'nu': js['nu']})}
    ckpt_npz = str(root / 'ckpt.npz')
    np.savez(ckpt_npz, **_flat(state))
    mesh = make_virtual_mesh((4, 2), AXES)
    pspec = j_param_specs(jmodel, mesh)
    ospec = jopt.opt_state_specs(pspec, mesh, zero1=True,
                                 param_shapes=jmodel.param_shapes())
    jckpt.save(dirs['ref'], 1, {
        'params': jax.tree.map(jax.device_put, jp, pspec),
        'opt': {'step': js['step'],
                'mu': jax.tree.map(jax.device_put, js['mu'], ospec['mu']),
                'nu': jax.tree.map(jax.device_put, js['nu'], ospec['nu'])}})
    assert any(isinstance(s, NamedSharding) and 'data' in str(s.spec)
               for s in jax.tree.leaves(ospec['mu']))

    g_global = np.random.default_rng(0).normal(size=(4, 64)).astype(
        np.float32)
    four = run_ranks(_rank_four, 4, store_dir=root, device_type='cpu',
                     args=(npzs, g_global, ckpt_npz, dirs),
                     timeout_s=RANK_TIMEOUT_S)
    mon = HeartbeatMonitor(['h0', 'h1'],
                           HeartbeatConfig(interval_s=1, miss_threshold=2))
    mon.beat('h0', 10.0)                       # h1 silent -> dead
    plan = plan_recovery(mon, devices_per_host=2, model_parallel=2,
                         last_ckpt_step=ckpt.latest_step(dirs['fail']),
                         old_shape=(2, 2), now=10.0)
    assert plan is not None and plan.new_shape == (1, 2), plan
    two = run_ranks(_rank_two, 2, store_dir=root, device_type='cpu',
                    args=(npzs, dirs, plan.new_shape, plan.restore_step),
                    timeout_s=RANK_TIMEOUT_S)
    return dict(trees=trees, state=state, dirs=dirs, g_global=g_global,
                four=four, two=two, mesh=make_virtual_mesh, cache={})


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def _strip(spec):
    parts = list(spec)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def _padded(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(tuple(spec)))


SPEC_CONFIGS = {'internlm2': dict(arch='internlm2-1.8b', d_model=64,
                                  d_ff=256),
                'qwen3': dict(arch='qwen3-0.6b'),
                'moe': dict(arch='phi3.5-moe-42b-a6.6b'),
                'rwkv6': dict(arch='rwkv6-3b'),
                'zamba2': dict(arch='zamba2-2.7b'),
                'seamless': dict(arch='seamless-m4t-medium')}
# the leaves whose blocks depart from the specs' (compared as sets of
# indices): rwkv6's decay and group norm split by heads (replicated under
# the specs) and its replicated ``Wr_cm`` (split by the specs' 'qkv'),
# zamba2's packed leaves (several intervals on their last dimension)
DEPARTURES = {'rwkv6': ('layers/w_base', 'layers/w_B', 'layers/ln_x',
                        'layers/Wr_cm'),
              'zamba2': ('layers/in_proj', 'layers/conv_w', 'layers/conv_b')}


@pytest.mark.parametrize('shape', [(4, 2), (2, 2, 2)], ids=['4x2', '2x2x2'])
@pytest.mark.parametrize('name', ['internlm2', 'qwen3', 'moe', 'rwkv6',
                                  'zamba2', 'seamless'])
def test_specs_equal_the_reference(name, shape, make_virtual_mesh):
    """``param_specs``, ``batch_specs`` and ``opt_state_specs(zero1=True)``
    on a description mesh equal the reference's on virtual devices; the
    (V, D) ``unembed``'s specs are the reference's (D, V) ones read
    transposed; some moment leaf takes the data axis."""
    from repro.training import optimizer as jopt
    from repro.training.train_step import batch_specs as j_batch_specs
    from repro.training.train_step import param_specs as j_param_specs

    cfg_kw = dict(SPEC_CONFIGS[name])
    arch = cfg_kw.pop('arch')
    _, _, j_get_config, j_reduced, j_build_model = _j()
    jmodel = j_build_model(j_reduced(j_get_config(arch), **cfg_kw))
    model = build_model(reduced(get_config(arch), **cfg_kw))
    axes = ('pod',) + AXES if len(shape) == 3 else AXES
    jmesh = make_virtual_mesh(shape, axes)
    mesh = Mesh(np.arange(int(np.prod(shape))).reshape(shape), axes)
    tshape = ShapeConfig('t', S, 8, 'train')

    jp = j_param_specs(jmodel, jmesh)
    jo = jopt.opt_state_specs(jp, jmesh, zero1=True,
                              param_shapes=jmodel.param_shapes())
    p = param_specs(model, mesh)
    o = opt.opt_state_specs(p, mesh, zero1=True,
                            param_shapes=model.param_shapes())
    shapes = dict(tr.leaves_with_paths(model.param_shapes()))
    want = {'p': dict(_leaf_specs(jp)), 'mu': dict(_leaf_specs(jo['mu']))}
    got = {'p': dict(_leaf_specs(p)), 'mu': dict(_leaf_specs(o['mu']))}
    for part in ('p', 'mu'):
        assert want[part].keys() == got[part].keys()
        for k, w in want[part].items():
            ndim = len(shapes[k])
            w = _padded(w, ndim)
            if k.rsplit('/', 1)[-1] == 'unembed':
                w = w[::-1]
            assert _strip(w) == got[part][k], (part, k, w, got[part][k])
    assert o['step'].spec == () and _strip(jo['step'].spec) == ()
    assert any('data' in str(s) for s in got['mu'].values())
    jb = j_batch_specs(jmodel, tshape, jmesh)
    b = batch_specs(model, tshape, mesh)
    assert {k: _strip(v.spec) for k, v in jb.items()} == \
        {k: v.spec for k, v in b.items()}


def _indices(block: Block) -> set:
    """The flat global indices a block holds."""
    return set(block.take(np.arange(int(np.prod(block.shape))).reshape(
        block.shape)).ravel().tolist())


@pytest.mark.parametrize('shape', [(2, 2), (2, 2, 2)], ids=['2x2', '2x2x2'])
@pytest.mark.parametrize('name', ['internlm2', 'qwen3', 'moe', 'rwkv6',
                                  'zamba2', 'seamless'])
def test_plan_blocks_follow_the_specs(name, shape):
    """Every rank's ``TrainPlan`` blocks (a description plan: no process
    group) equal the blocks ``local_bounds`` reads off ``param_specs`` and
    off ``zero1_moment_specs``: the one ZeRO-1 rule, on blocks and on
    specs, places every moment alike.  Where the port departs from the
    specs (``DEPARTURES``), as sets of indices: the ``model`` ranks'
    blocks are disjoint and cover the leaf (or each is the whole leaf),
    the data ranks' moment blocks are disjoint and cover their parameter
    block, cut along the dimension the rule picks on the block, never one
    of several intervals."""
    from repro_torch.distributed.sharding import local_bounds

    cfg_kw = dict(SPEC_CONFIGS[name])
    model = build_model(reduced(get_config(cfg_kw.pop('arch')), **cfg_kw))
    axes = ('pod',) + AXES if len(shape) == 3 else AXES
    mesh = Mesh(np.arange(int(np.prod(shape))).reshape(shape), axes)
    pspecs = param_specs(model, mesh)
    specs = {'p': dict(tr.leaves_with_paths(pspecs)),
             'mu': dict(tr.leaves_with_paths(opt.zero1_moment_specs(
                 model.param_shapes(), pspecs, mesh)))}
    shapes = dict(tr.leaves_with_paths(model.param_shapes()))
    departs = DEPARTURES.get(name, ())
    plans = [TrainPlan(model, mesh, coords=mesh.coords(r))
             for r in range(mesh.size)]
    n_data = plans[0].n_data
    cut = 0
    for k, shp in shapes.items():
        if k in departs:
            size = int(np.prod(shp))
            by_model, by_data = {}, {}
            for plan in plans:
                b = plan.param_blocks[k]
                by_model.setdefault(plan.data_index, []).append(b)
                by_data.setdefault(b.bounds, []).append(plan.moment_block(k))
                dim = plan.zdims[k]
                assert dim is None or len(b.intervals(dim)) == 1, k
            for blocks in by_model.values():
                sets = [_indices(b) for b in blocks]
                if not all(len(x) == size for x in sets):
                    assert sum(map(len, sets)) == size, k
                    assert set().union(*sets) == set(range(size)), k
            for bounds, moments in by_data.items():
                whole = _indices(Block(tuple(shp), bounds))
                sets = {frozenset(_indices(m)) for m in moments}
                if len(sets) > 1:
                    assert len(sets) == n_data, k
                    assert sum(map(len, sets)) == len(whole), k
                    assert frozenset().union(*sets) == whole, k
                    cut += 1
            continue
        for plan, r in zip(plans, range(mesh.size)):
            coords = mesh.coords(r)
            want = {part: local_bounds(shp, specs[part][k].spec, mesh,
                                       coords).bounds for part in specs}
            assert plan.param_blocks[k].bounds == want['p'], (r, k)
            assert plan.moment_block(k).bounds == want['mu'], (r, k)
            cut += want['mu'] != want['p']
    assert cut > 0


def _leaf_specs(tree):
    """[(path, spec)] of a nested dict of shardings."""
    if isinstance(tree, dict):
        return [(f'{k}/{p}' if p else k, s) for k in sorted(tree)
                for p, s in _leaf_specs(tree[k])]
    return [('', tree.spec)]


def test_a_spec_naming_an_axis_twice_is_refused():
    """An MoE expert stack whose expert count the model axis does not
    divide: ``shaped_spec`` moves the axis onto the embed dim beside the
    ffn dim that already holds it (ROADMAP Queue 3); the specs refuse it."""
    model = build_model(reduced(get_config('phi3.5-moe-42b-a6.6b'),
                                n_experts=3))
    mesh = Mesh(np.arange(2).reshape(1, 2), AXES)
    with pytest.raises(ValueError, match="names mesh axis 'model' twice"):
        param_specs(model, mesh)


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _meshless(name, micro, clip, trees):
    """The port's meshless loss, gradients, step metrics and parameters
    after the step; for rwkv6, zamba2 and seamless also each gradient
    leaf's null (every f32 product's sum in two halves,
    ``orders.halved_products``) as a share of its max."""
    model = build_model(_cfg(name))
    params = params_from_jax(trees[name], requires_grad=True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(model.cfg).items()}
    loss, grads = loss_and_grads(model, params, batch, micro)
    grads = {k: v.numpy() for k, v in tr.leaves_with_paths(grads)}
    ocfg = opt.AdamWConfig(grad_clip=clip)
    step = make_train_step(model, opt_cfg=ocfg, microbatches=micro)
    params, _, m = step(params_from_jax(trees[name], requires_grad=True),
                        opt.init_opt_state(params), batch)
    after = {k: v.detach().numpy() for k, v in tr.leaves_with_paths(params)}
    nulls = {}
    if model.cfg.family in SPLIT_FAMILIES:
        null_params = params_from_jax(trees[name], requires_grad=True)
        with halved_products(torch.float32):
            _, null = loss_and_grads(model, null_params, batch, micro)
        nulls = {k: _rel(v.numpy(), grads[k])
                 for k, v in tr.leaves_with_paths(null)}
    return float(loss), grads, m, after, nulls


def _reference_step(name, micro, clip, trees):
    import jax
    from repro.training import optimizer as jopt
    from repro.training.train_step import make_train_step as j_step

    jstep, _ = j_step(_jmodel(name), None, microbatches=micro,
                      opt_cfg=jopt.AdamWConfig(grad_clip=clip))
    jp = jax.tree.map(jax.numpy.asarray, trees[name])
    batch = jax.tree.map(jax.numpy.asarray, _batch(_jmodel(name).cfg))
    jp, _, m = jstep(jp, jopt.init_opt_state(jp), batch)
    return m, {k: (v.T if k.rsplit('/', 1)[-1] == 'unembed' else v)
               for k, v in tr.leaves_with_paths(_np(jp))}


def _reference_null(name, micro, clip, trees, m):
    """The reference's own spread in loss and grad_norm (relative to its
    metrics ``m``): its step with the recurrence's chunked form at each of
    REF_CHUNKS (rwkv6's WKV, zamba2's SSD; the default is one chunk of the
    whole sequence), the same function summed in another order; 0 for a
    family without a recurrence."""
    import repro.models.rwkv6 as jrwkv6
    import repro.models.zamba2 as jzamba2

    target = {'rwkv6': (jrwkv6, 'wkv6_chunked'),
              'zamba2': (jzamba2, 'ssd_chunked')}.get(name)
    spread = {'loss': 0.0, 'grad_norm': 0.0}
    if target is None:
        return spread
    module, fn = target
    saved = getattr(module, fn)
    for chunk in REF_CHUNKS:
        setattr(module, fn, functools.partial(saved, chunk=chunk))
        try:
            other, _ = _reference_step(name, micro, clip, trees)
        finally:
            setattr(module, fn, saved)
        for key in spread:
            spread[key] = max(spread[key],
                              abs(float(other[key]) / float(m[key]) - 1))
    return spread


def _each_block(results, full, tol, what, nulls=None):
    """Every rank's block of every leaf of ``full`` (the global leaves)
    within ``tol`` of the leaf max, or within NULL_FACTOR times the leaf's
    null (``nulls``, shares of the max) where that is larger."""
    nulls = nulls or {}
    for r, blocks in enumerate(results):
        for k, (a, b) in blocks.items():
            if k not in full:
                continue
            want = full[k]
            err = np.abs(a - b.take(want)).max() / max(np.abs(want).max(),
                                                        1e-30)
            assert err <= max(tol, NULL_FACTOR * nulls.get(k, 0.0)), (
                what, r, k, err, nulls.get(k))


def _update_misses(results, before, want, tol):
    """[(rank, leaf, share)] of every rank's block of every leaf of
    ``want`` (the parameters after another step from ``before``) whose
    update misses that step's update by more than ``tol`` of its norm,
    ``||(after - before) - (want - before)|| / ||want - before||``: a
    block the step left unchanged reads 1, while rounding that flips the
    sign of AdamW's first update lr g / |g| on a share f of a block's
    elements reads ~2 sqrt(f)."""
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


def _global_before(tree):
    """The weights before the step, by path, in the port's layout."""
    return {k: (v.T if k.rsplit('/', 1)[-1] == 'unembed' else v)
            for k, v in _flat(tree).items()}


@pytest.mark.parametrize('case', STEP_CASES, ids=lambda c: (
    f'{c[0][0]}x{c[0][1]}-mb{c[1]}-{c[2]}'
    + ('-clip' if c[3] < 2 else '-noclip')))
def test_mesh_step_matches_meshless_and_the_reference(case, world):
    shape, micro, name, clip = case
    ranks = world['four'] if np.prod(shape) == 4 else world['two']
    got = [r['steps'][case] for r in ranks]
    (loss, grads, m, params, nulls), (jm, jparams), ref_null = \
        _cached_steps(world, name, micro, clip)
    cfg = _cfg(name)
    family = cfg.family in SPLIT_FAMILIES
    tol = 1e-5 if cfg.family in ('ssm', 'hybrid') else 1e-6
    grads, params = dict(grads), dict(params)
    lr = float(m['lr'])
    before = _global_before(world['trees'][name])
    if ZERO_GRAD in grads:
        stack = max(np.abs(v).max() for k, v in grads.items()
                    if k.startswith('dec_layers/'))
        for v in [grads.pop(ZERO_GRAD)] + [g['grads'][ZERO_GRAD][0]
                                           for g in got]:
            assert np.abs(v).max() <= 1e-6 * stack
        params.pop(ZERO_GRAD)
        for g in got:
            assert np.abs(g['params'][ZERO_GRAD][0]).max() <= lr * (1 + 1e-6)
    # metrics equal on every rank
    for key in ('loss', 'grad_norm', 'grad_loss'):
        assert len({g[key] for g in got}) == 1, (key, [g[key] for g in got])
    lead = got[0]
    assert lead['grad_loss'] == lead['loss']
    assert lead['loss'] == pytest.approx(float(m['loss']), rel=1e-6)
    assert lead['loss'] == pytest.approx(loss, rel=1e-6)
    assert lead['grad_norm'] == pytest.approx(float(m['grad_norm']),
                                              rel=1e-6)
    assert (float(m['grad_norm']) > clip) == (clip < 2)
    _each_block([g['grads'] for g in got], grads, tol, 'grads', nulls)
    if family:
        # every block's update against the meshless step's, as a share of
        # its norm (an element whose gradient is near 0 moves by a share of
        # lr that rounding decides: element-wise, 2e-5 of a leaf's max)
        assert not _update_misses([g['params'] for g in got], before,
                                  params, UPDATE_TOL)
    else:
        _each_block([g['params'] for g in got], params, tol, 'params')
    # leaves replicated over model: bit-equal gradients on its ranks
    for k, (a, b) in lead['grads'].items():
        if b.is_whole():
            assert all(np.array_equal(a, g['grads'][k][0]) for g in got), k
    if name == 'moe':              # the experts and the router are cut
        assert all(k in lead['grads'] and not lead['grads'][k][1].is_whole()
                   for k in EXPERT_LEAVES)
    if name == 'seamless-kv':      # one kv-head a rank; the vocabulary of
        # 510 on d_model (4 does not divide it: the reference's spec)
        assert all(g['grads'][k][1].local_shape == (cfg.vocab_size,
                                                    cfg.d_model // 4)
                   for g in got for k in ('embed', 'unembed'))
        assert all(g['grads']['dec_layers/xwk'][1].local_shape[2] == cfg.hd
                   for g in got)
    elif name in FAMILY_NAMES:     # every family splits its layers
        assert sum(not b.is_whole() for _, b in lead['grads'].values()) > \
            len(lead['grads']) // 2
    # the reference's meshless step: loss and grad_norm within 1e-5
    # relative, or twice the reference's own spread over the recurrence's
    # chunk (rwkv6, zamba2) where that is larger
    for key in ('loss', 'grad_norm'):
        assert lead[key] == pytest.approx(
            float(jm[key]), rel=max(1e-5, NULL_FACTOR * ref_null[key])), (
                key, ref_null)
    # every leaf not drawn as zeros within 1e-4 of its max; a leaf drawn
    # as zeros is lr-sized after the step, held by its update
    drawn = {k: v for k, v in jparams.items()
             if k in params and np.abs(before[k]).any()}
    _each_block([g['params'] for g in got], drawn, 1e-4, 'reference')
    if family:
        assert not _update_misses([g['params'] for g in got], before,
                                  {k: jparams[k] for k in params},
                                  UPDATE_TOL)


def _cached_steps(world, name, micro, clip):
    """The port's meshless step, the reference's and the reference's
    spread (:func:`_reference_null`), computed once a (config,
    microbatches, clip)."""
    key = (name, micro, clip)
    if key not in world['cache']:
        jm, jparams = _reference_step(*key, world['trees'])
        world['cache'][key] = (
            _meshless(*key, world['trees']), (jm, jparams),
            _reference_null(*key, world['trees'], jm))
    return world['cache'][key]


@pytest.mark.parametrize('name', FAMILY_NAMES)
def test_an_unchanged_block_fails_the_update_gate(name, world):
    """The mutant of the update gate: a step that leaves any one leaf's
    block on either rank as it was (its update skipped) fails it, against
    the meshless step and against the reference alike; the step as it is
    passes."""
    case = ((1, 2), 1, name, 1.0)
    (_, _, _, params, _), (_, jparams), _ = _cached_steps(world, name, 1,
                                                          1.0)
    params = {k: v for k, v in params.items() if k != ZERO_GRAD}
    before = _global_before(world['trees'][name])
    results = [dict(r['steps'][case]['params']) for r in world['two']]
    for want in (params, {k: jparams[k] for k in params}):
        assert not _update_misses(results, before, want, UPDATE_TOL)
        for r, blocks in enumerate(results):
            for k in params:
                b = blocks[k][1]
                planted = [dict(x) for x in results]
                planted[r][k] = (b.take(before[k]), b)
                misses = _update_misses(planted, before, want, UPDATE_TOL)
                assert [(m[0], m[1]) for m in misses] == [(r, k)], (r, k)
                assert misses[0][2] == pytest.approx(1.0)


def test_zero1_on_and_off_give_bit_equal_params(world):
    """Two steps at (2, 1), 2 microbatches, lr 3e-3: the moments are half
    a leaf with ZeRO-1 on and whole with it off; the params bit-equal."""
    for r in world['two']:
        z = r['zero1']
        assert z['equal']
        on, off = z['moments']
        assert on != off and sum(np.prod(s) for s in on) * 2 == \
            sum(np.prod(s) for s in off)


def _family_meshless(arch):
    """The port's meshless loss and gradients (f32) of a data-parallel
    family on the seed-0 weights and the whole batch."""
    model = build_model(reduced(get_config(arch), **FAMILIES[arch]))
    params = tr.tree_map(lambda x: x.requires_grad_(), _seeded(model))
    batch = {k: torch.from_numpy(v) for k, v in _batch(model.cfg).items()}
    loss, grads = loss_and_grads(model, params, batch)
    return model, params, batch, float(loss), {
        k: v.numpy() for k, v in tr.leaves_with_paths(grads)}


@pytest.mark.parametrize('arch', [a for a in FAMILIES if a != MOE])
def test_data_parallel_trains_every_family(arch, world):
    """A data axis over ranks that each hold the whole model: the loss and
    every gradient leaf as the meshless ones (1e-6 relative, 1e-5 of the
    leaf max: the recurrences sum over longer chains).  seamless's
    ``dec_layers/xbk`` has the exact gradient 0 (softmax ignores the bias
    it adds to every score of a query), so both sides are held, as in
    ``tests/test_torch_train_grads.py``, within 1e-6 of the decoder
    stack's largest gradient."""
    *_, loss, full = _family_meshless(arch)
    got = [(g_loss, dict(b)) for g_loss, b in
           (r['families'][arch] for r in world['two'])]
    for g_loss, _ in got:
        assert g_loss == pytest.approx(loss, rel=1e-6)
    zero = 'dec_layers/xbk'
    if zero in full:
        stack = max(np.abs(v).max() for k, v in full.items()
                    if k.startswith('dec_layers/'))
        for v in [full.pop(zero)] + [b.pop(zero)[0] for _, b in got]:
            assert np.abs(v).max() <= 1e-6 * stack
    _each_block([b for _, b in got], full, 1e-5, arch)


def test_moe_trains_data_parallel(world, monkeypatch):
    """MoE at (2, 1) routes the global microbatch: each rank ranks its
    assignments after the other rank's and drops against the capacity of
    both ranks' tokens, and the aux loss takes the whole batch's expert
    fractions.  The loss and every gradient leaf as the port's meshless
    ones (1e-6 relative, 1e-5 of the leaf max) and the reference's
    (``tests/test_torch_train_grads.py``'s 1e-5 relative, 1e-4 of the leaf
    max).  The capacity binds here, and routing each rank's rows on their
    own would drop other assignments."""
    import jax

    from repro_torch.models import moe as tmoe

    drops = []
    route = tmoe.route

    def counted(*a, **kw):
        out = route(*a, **kw)
        drops.append(int((out[3] >= out[4]).sum()))
        return out
    monkeypatch.setattr(tmoe, 'route', counted)
    model, params, batch, loss, full = _family_meshless(MOE)
    whole = sum(drops)
    with torch.no_grad():
        for half in (slice(0, B // 2), slice(B // 2, B)):
            model.loss_fn(params, {k: v[half] for k, v in batch.items()})
    assert whole > 0 and sum(drops) - whole != whole, drops
    got = [r['families'][MOE] for r in world['two']]
    for g_loss, _ in got:
        assert g_loss == pytest.approx(loss, rel=1e-6)
    _each_block([b for _, b in got], full, 1e-5, MOE)

    _, _, j_get_config, j_reduced, j_build_model = _j()
    jmodel = j_build_model(j_reduced(j_get_config(MOE), **FAMILIES[MOE]))
    jp = tree_to_jax(tr.tree_map(lambda x: x.detach(), params))
    jbatch = {k: jax.numpy.asarray(v.numpy()) for k, v in batch.items()}
    jl, jg = jax.value_and_grad(lambda p: jmodel.loss_fn(p, jbatch)[0])(jp)
    want = {k: v.detach().numpy() for k, v in tr.leaves_with_paths(
        params_from_jax(jax.tree.map(np.asarray, jg)))}
    for g_loss, _ in got:
        assert g_loss == pytest.approx(float(jl), rel=1e-5)
    _each_block([b for _, b in got], want, 1e-4, 'reference')


@pytest.mark.parametrize('arch', ['rwkv6-3b', 'zamba2-2.7b',
                                  'seamless-m4t-medium'])
def test_an_expert_axis_is_refused(arch):
    """The trainer reduces over the data axes and splits over model only:
    an ``expert`` axis is refused, for every family."""
    model = build_model(reduced(get_config(arch)))
    with pytest.raises(NotImplementedError, match="mesh axes {'expert'"):
        make_train_step(model, Mesh(np.arange(2).reshape(1, 2),
                                    ('data', 'expert')))


def test_zamba2_zero1_on_and_off_give_bit_equal_params(world):
    """zamba2 at (2, 2), two steps at lr 3e-3: ZeRO-1 cuts the moments of
    the packed ``in_proj`` / ``conv_w`` along another dimension than their
    several intervals; the params bit-equal to the run without it on every
    rank."""
    for r in world['four']:
        equal, (on, off) = r['zamba2_zero1']
        assert equal and on != off
        assert sum(np.prod(x) for x in on) < sum(np.prod(x) for x in off)


def test_zamba2_norm_over_local_heads_is_rejected(world):
    """A mutant whose gated norm sums only its own heads' squares (no sum
    over model) misses the meshless loss and gradients by far more than
    the step's gates, which the true split meets."""
    loss, grads, *_ = _meshless('zamba2', 1, 1.0, world['trees'])
    for r in world['two']:
        m_loss, blocks = r['norm_mutant']
        worst = max(np.abs(a - b.take(grads[k])).max()
                    / np.abs(grads[k]).max() for k, (a, b) in blocks.items())
        assert abs(m_loss - loss) > 1e-4 * abs(loss) or worst > 1e-2, \
            (m_loss, loss, worst)
        assert worst > 1e-2, worst


@pytest.mark.parametrize('arch', TRAIN_ARCHS)
def test_train_driver_trains_over_model(arch, world):
    """``launch.train.train(mesh=)`` at (1, 2): each step's loss equal on
    both ranks; the first within 1e-6 relative of the meshless driver's,
    the next (after an AdamW step, whose first update turns the f32
    rounding in near-zero gradient elements into whole steps of lr) within
    the failover test's 1e-4."""
    want = train(arch, steps=TRAIN_STEPS, batch=B, seq=S, device='cpu',
                 log_every=TRAIN_STEPS + 1)[2]
    got = [r['train'][arch] for r in world['two']]
    assert got[0] == got[1]
    assert got[0][0] == pytest.approx(want[0], rel=1e-6)
    np.testing.assert_allclose(got[0], want, rtol=1e-4)


def test_zamba2_checkpoint_from_2x2_restores_everywhere(world):
    """The (2, 2) ZeRO-1 run's zamba2 checkpoint (each interval of the
    packed leaves a shard of its own) restores onto (1, 2), onto one
    device and through the reference's ``restore``: every parameter and
    moment equal to what the ranks held."""
    from repro.training import checkpoint as jckpt
    from repro.training import optimizer as jopt

    model = build_model(_cfg('zamba2'))
    shapes = dict(tr.leaves_with_paths(model.param_shapes()))
    saved = _assembled([r['zamba2_saved'] for r in world['four']], shapes)
    plan = TrainPlan(model, Mesh(np.arange(1).reshape(1, 1), AXES),
                     coords={'data': 0, 'model': 0})
    step, whole = _restore_blocks(world['dirs']['zamba2'], 2, plan)
    assert step == 2 and whole.pop('step') == 2
    for k, (a, _) in whole.items():
        if k.startswith('params/'):
            np.testing.assert_array_equal(a, saved[k[len('params/'):]], k)
    for r in world['two']:
        got, blocks = r['zamba2_onto_12']
        assert got == 2 and blocks.pop('step') == 2
        assert blocks.keys() == whole.keys()
        for k, (a, b) in blocks.items():
            np.testing.assert_array_equal(a, b.take(whole[k][0]), k)
        assert len(blocks['params/layers/in_proj'][1].intervals(2)) == 5
    jp = _jparams('zamba2')
    restored, step = jckpt.restore(world['dirs']['zamba2'], 2, {
        'params': jp, 'opt': jopt.init_opt_state(jp)})
    assert step == 2 and int(restored['opt']['step']) == 2
    for part, tree in (('params', restored['params']),
                       ('mu', restored['opt']['mu']),
                       ('nu', restored['opt']['nu'])):
        for k, v in tr.leaves_with_paths(_np(tree)):
            np.testing.assert_array_equal(v, whole[f'{part}/{k}'][0],
                                          f'{part}/{k}')


def test_moe_zero1_on_and_off_give_bit_equal_params(world):
    """phi3.5-moe at (2, 2), two steps at lr 3e-3: the expert stacks'
    moments cut over data beside their expert blocks, the params bit-equal
    to the run without ZeRO-1 on every rank."""
    assert all(r['moe_zero1'][0] for r in world['four'])


def _assembled(blocks_by_rank, shapes):
    full = {k: np.full(shp, np.nan, np.float32) for k, shp in shapes.items()}
    for blocks in blocks_by_rank:
        for k, (a, b) in blocks.items():
            for piece, idx in b.pieces():
                full[k][tuple(slice(lo, hi)
                              for lo, hi in piece.bounds)] = a[idx]
    assert not any(np.isnan(v).any() for v in full.values())
    return full


def test_moe_checkpoint_from_2x2_restores_onto_1x1_and_1x2(world):
    """The (2, 2) ZeRO-1 run's checkpoint (each expert block written once
    though the data ranks both hold it) restores onto (1, 2), each rank's
    8 experts, and onto (1, 1), the whole model: every parameter equal to
    what the ranks held, the moments of (1, 2) the blocks of (1, 1)'s."""
    model = build_model(_cfg('moe'))
    shapes = dict(tr.leaves_with_paths(model.param_shapes()))
    saved = _assembled([r['moe_saved'] for r in world['four']], shapes)
    plan = TrainPlan(model, Mesh(np.arange(1).reshape(1, 1), AXES),
                     coords={'data': 0, 'model': 0})
    step, whole = _restore_blocks(world['dirs']['moe'], 2, plan)
    assert step == 2 and whole.pop('step') == 2
    for k, (a, _) in whole.items():
        if k.startswith('params/'):
            np.testing.assert_array_equal(a, saved[k[len('params/'):]], k)
    for r in world['two']:
        got, blocks = r['moe_onto_12']
        assert got == 2 and blocks.pop('step') == 2
        assert blocks.keys() == whole.keys()
        for k, (a, b) in blocks.items():
            np.testing.assert_array_equal(a, b.take(whole[k][0]), k)
        assert blocks['params/layers/we_gate'][1].bounds[1] in ((0, 8),
                                                                (8, 16))


# ---------------------------------------------------------------------------
# The compressed all-reduce
# ---------------------------------------------------------------------------

def test_compressed_allreduce_matches_the_reference(world):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.training.compression import (
        init_error_state as j_init, make_compressed_allreduce as j_make)

    g_global = world['g_global']
    mesh = world['mesh']((4,), ('data',))
    sharding = NamedSharding(mesh, P('data', None))
    fn = j_make(mesh, {'w': P('data', None)}, ('data',))
    grads = {'w': jax.device_put(g_global, sharding)}
    err = jax.tree.map(lambda e: jax.device_put(e, sharding), j_init(grads))
    out, new_err = fn(grads, err)
    out2, _ = fn(jax.tree.map(jnp.zeros_like, grads), new_err)
    want = [np.asarray(x['w']) for x in (out, new_err, out2)]
    for r, got in enumerate(r['compressed'] for r in world['four']):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[0], w[r], rtol=0, atol=1e-7)
    mean = g_global.mean(axis=0)
    got, _, got2 = world['four'][0]['compressed']
    rel = np.abs(got[0] - mean).max() / (np.abs(mean).max() + 1e-9)
    rel2 = np.abs(got[0] + got2[0] - mean).max() / (np.abs(mean).max()
                                                    + 1e-9)
    assert rel < 0.15 and rel2 < rel, (rel, rel2)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _global_state(state):
    """{'params/..', 'mu/..', 'nu/..'}: the saved state in the port's
    layout."""
    out = {}
    for part, tree in (('params', state['params']), ('mu', state['opt']['mu']),
                       ('nu', state['opt']['nu'])):
        for k, v in tr.leaves_with_paths(tree):
            out[f'{part}/{k}'] = v.T if k.rsplit('/', 1)[-1] == 'unembed' \
                else v
    return out


def _exact_blocks(restored, state):
    step, blocks = restored
    assert step == 1 and blocks.pop('step') == 1
    full = _global_state(state)
    assert blocks.keys() == full.keys()
    for k, (a, b) in blocks.items():
        np.testing.assert_array_equal(a, b.take(full[k]), err_msg=k)


def test_port_checkpoint_from_2x2_restores_onto_1x2_and_meshless(world):
    state = world['state']
    for r in world['two']:
        _exact_blocks(r['port_onto_12'], state)
    params = params_from_jax(state['params'])
    target = {'params': params,
              'opt': opt_state_from_jax(dict(state['opt'], step=0))}
    restored, step = ckpt.restore(world['dirs']['port'], 1, target)
    assert step == 1 and int(restored['opt']['step']) == 1
    got = {'params': tree_to_jax(restored['params']),
           'opt': tree_to_jax({k: restored['opt'][k] for k in ('mu', 'nu')})}
    for (k, a), (_, b) in zip(tr.leaves_with_paths(got),
                              tr.leaves_with_paths(state)):
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_reference_restores_the_port_sharded_checkpoint(world):
    from repro.training import checkpoint as jckpt
    from repro.training import optimizer as jopt

    state = world['state']
    jp = _jparams('ckpt')
    target = {'params': jp, 'opt': jopt.init_opt_state(jp)}
    restored, step = jckpt.restore(world['dirs']['port'], 1, target)
    assert step == 1 and int(restored['opt']['step']) == 1
    got = {'params': _np(restored['params']),
           'opt': _np({'mu': restored['opt']['mu'],
                       'nu': restored['opt']['nu']})}
    for (k, a), (_, b) in zip(tr.leaves_with_paths(got),
                              tr.leaves_with_paths(state)):
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_reference_checkpoint_from_4x2_restores_onto_2x1(world):
    for r in world['two']:
        _exact_blocks(r['ref_onto_21'], world['state'])


def test_elastic_failover_end_to_end(world):
    """The reference's failover case on the port: (2, 2) for 3 steps, a
    checkpoint, a host lost, ``plan_recovery``'s (1, 2) restores and runs
    steps 3-5; the losses follow the unbroken (2, 2) run."""
    unbroken, first = world['four'][0]['fail']
    assert first == unbroken[:FAIL_AT]
    for r in world['four'][1:]:
        assert r['fail'] == [unbroken, first]
    for r in world['two']:
        np.testing.assert_allclose(first + r['fail'], unbroken, rtol=1e-4,
                                   atol=1e-4)
    assert unbroken[-1] < unbroken[0]
