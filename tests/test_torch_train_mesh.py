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
  within 1e-6 relative; every gradient leaf and every parameter leaf
  after the step within 1e-6 of the leaf's max |x|.  The optimizer is
  ``AdamWConfig()``'s default (warmup 100: the first step's lr is 3e-6).
  At lr 3e-3 the parameters after one step differ by up to 1.6e-4 of a
  leaf's max (measured): AdamW's first update g / (|g| + 1e-8) turns an
  f32 rounding difference in a gradient element near 1e-8 into a large
  share of its update, so the gradients, where the mesh's arithmetic
  shows, are held to 1e-6 directly;
- against the reference's meshless step, the port's meshless parity
  test's (``tests/test_torch_training.py``): loss and ``grad_norm`` 1e-5
  relative, parameters 1e-4 of the leaf max;
- leaves replicated over ``model`` get bit-equal gradients on its ranks;
  ZeRO-1 on and off give bit-equal parameters;
- the compressed all-reduce: outputs and residuals within 1e-7 of the
  reference's, and the reference test's ``rel < 0.15`` and ``rel2 <
  rel``;
- checkpoints across meshes and packages: every array exact;
- failover at (2, 2) -> (1, 2): losses within 1e-4 of the unbroken run.
"""

import numpy as np
import pytest
import torch

from repro_torch.bridge import (opt_state_from_jax, params_from_jax,
                                shard_opt_state, tree_to_jax)
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.launch.ranks import run_ranks
from repro_torch.models.api import build_model
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
STEP_CASES = [((2, 1), 1, 'base', 1.0), ((2, 1), 2, 'base', 1.0),
              ((1, 2), 1, 'base', 1.0), ((1, 2), 2, 'base', 1.0),
              ((2, 2), 1, 'base', 1.0), ((2, 2), 2, 'base', 100.0),
              ((1, 4), 1, 'kv', 1.0), ((2, 2), 1, 'vlm', 1.0),
              ((1, 2), 1, 'moe', 1.0), ((1, 2), 2, 'moe', 1.0),
              ((2, 2), 1, 'moe', 1.0)]
CONFIGS = {'base': dict(arch='qwen3-0.6b'),
           'kv': dict(arch='qwen3-0.6b', n_heads=8, n_kv_heads=2),
           'vlm': dict(arch='llava-next-mistral-7b'),
           'moe': dict(arch='phi3.5-moe-42b-a6.6b', n_experts=16),
           'ckpt': dict(arch='internlm2-1.8b')}
# the leaves expert parallelism cuts
EXPERT_LEAVES = ('layers/router', 'layers/we_gate', 'layers/we_up',
                 'layers/we_down')
# data-parallel families: (arch, reduced() overrides); at 16 experts the
# capacity (1.25) drops assignments at this size
FAMILIES = {'rwkv6-3b': {}, 'zamba2-2.7b': {}, 'seamless-m4t-medium': {},
            'phi3.5-moe-42b-a6.6b': {'n_experts': 16}}
MOE = 'phi3.5-moe-42b-a6.6b'
FAIL = dict(lr=3e-3, warmup_steps=1)        # the reference failover test's
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
    """{path: (array, bounds)} of this rank's blocks."""
    return {k: (v.detach().cpu().numpy(), plan.param_blocks[k].bounds)
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

    # moe at (2, 2): ZeRO-1 on against off over two steps, then a
    # checkpoint of the ZeRO-1 run
    moe = build_model(_cfg('moe'))
    full = params_from_jax(_unflat(dict(np.load(npzs['moe']))))
    ends = []
    for zero1 in (True, False):
        step = make_train_step(moe, mesh, opt_cfg=opt.AdamWConfig(**FAIL),
                               zero1=zero1)
        params, state = step.plan.shard_params(full), step.plan.init_opt_state()
        for s in range(2):
            params, state, _ = step(params, state, shard_batch(
                _batch(moe.cfg, s), step.plan))
        ends.append((params, state, step.plan))
    out['moe_zero1'] = all(torch.equal(a, b) for a, b in
                           zip(tr.leaves(ends[0][0]), tr.leaves(ends[1][0])))
    params, state, plan = ends[0]
    ckpt.save(dirs['moe'], 2, {'params': params, 'opt': state}, mesh=mesh,
              specs=plan.blocks())
    out['moe_saved'] = _blocks(params, plan)

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
            blocks[f'{part}/{k}'] = (v.detach().numpy(), b.bounds)
    return got, blocks


def _rank_two(rank, npzs, dirs, new_shape, restore_step):
    """Every 2-rank case: the steps at (2, 1) and (1, 2), ZeRO-1 on against
    off, data-parallel rwkv6 and zamba2 against their meshless steps,
    restores onto (1, 2) and (2, 1), the failover's restart."""
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
    plan = TrainPlan(build_model(_cfg('moe')), make_mesh((1, 2), AXES,
                                                         device='cpu'))
    out['moe_onto_12'] = _restore_blocks(dirs['moe'], 2, plan)

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
    dirs = {k: str(root / k) for k in ('port', 'ref', 'fail', 'moe')}
    trees, npzs = {}, {}
    for name in ('base', 'kv', 'vlm', 'moe'):
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
                'moe': dict(arch='phi3.5-moe-42b-a6.6b')}


@pytest.mark.parametrize('shape', [(4, 2), (2, 2, 2)], ids=['4x2', '2x2x2'])
@pytest.mark.parametrize('name', ['internlm2', 'qwen3', 'moe'])
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


@pytest.mark.parametrize('shape', [(2, 2), (2, 2, 2)], ids=['2x2', '2x2x2'])
@pytest.mark.parametrize('name', ['internlm2', 'qwen3', 'moe'])
def test_plan_blocks_follow_the_specs(name, shape):
    """Every rank's ``TrainPlan`` blocks (a description plan: no process
    group) equal the blocks ``local_bounds`` reads off ``param_specs`` and
    off ``zero1_moment_specs``: the one ZeRO-1 rule, on blocks and on
    specs, places every moment alike."""
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
    cut = 0
    for r in range(mesh.size):
        coords = mesh.coords(r)
        plan = TrainPlan(model, mesh, coords=coords)
        for k, shp in shapes.items():
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

def _meshless(name, micro, clip, trees):
    model = build_model(_cfg(name))
    params = params_from_jax(trees[name], requires_grad=True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(model.cfg).items()}
    loss, grads = loss_and_grads(model, params, batch, micro)
    step = make_train_step(model, opt_cfg=opt.AdamWConfig(grad_clip=clip),
                           microbatches=micro)
    params, _, m = step(params_from_jax(trees[name], requires_grad=True),
                        opt.init_opt_state(params), batch)
    return (float(loss), {k: v.numpy() for k, v in tr.leaves_with_paths(
        grads)}, m, {k: v.detach().numpy()
                     for k, v in tr.leaves_with_paths(params)})


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


def _each_block(results, full, tol, what):
    """Every rank's block of every leaf within ``tol`` of the leaf max of
    the global ``full``."""
    for r, blocks in enumerate(results):
        for k, (a, bounds) in blocks.items():
            want = full[k]
            part = want[tuple(slice(lo, hi) for lo, hi in bounds)]
            err = np.abs(a - part).max() / max(np.abs(want).max(), 1e-30)
            assert err <= tol, (what, r, k, err)


@pytest.mark.parametrize('case', STEP_CASES, ids=lambda c: (
    f'{c[0][0]}x{c[0][1]}-mb{c[1]}-{c[2]}'
    + ('-clip' if c[3] < 2 else '-noclip')))
def test_mesh_step_matches_meshless_and_the_reference(case, world):
    shape, micro, name, clip = case
    ranks = world['four'] if np.prod(shape) == 4 else world['two']
    got = [r['steps'][case] for r in ranks]
    key = (name, micro, clip)
    if key not in world['cache']:
        world['cache'][key] = (_meshless(*key, world['trees']),
                               _reference_step(*key, world['trees']))
    (loss, grads, m, params), (jm, jparams) = world['cache'][key]
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
    _each_block([g['grads'] for g in got], grads, 1e-6, 'grads')
    _each_block([g['params'] for g in got], params, 1e-6, 'params')
    # leaves replicated over model: bit-equal gradients on its ranks
    for k, (a, bounds) in lead['grads'].items():
        if all((lo, hi) == (0, n) for (lo, hi), n in zip(bounds,
                                                         grads[k].shape)):
            assert all(np.array_equal(a, g['grads'][k][0]) for g in got), k
    if name == 'moe':              # the experts and the router are cut
        assert all(k in lead['grads'] and lead['grads'][k][1] != tuple(
            (0, n) for n in grads[k].shape) for k in EXPERT_LEAVES)
    # the reference's meshless step
    assert lead['loss'] == pytest.approx(float(jm['loss']), rel=1e-5)
    assert lead['grad_norm'] == pytest.approx(float(jm['grad_norm']),
                                              rel=1e-5)
    _each_block([g['params'] for g in got], jparams, 1e-4, 'reference')


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
def test_model_axis_is_refused_for_other_families(arch):
    model = build_model(reduced(get_config(arch)))
    with pytest.raises(NotImplementedError, match='item 10b-iii'):
        make_train_step(model, Mesh(np.arange(4).reshape(2, 2), AXES))
    with pytest.raises(NotImplementedError, match="mesh axes {'expert'"):
        make_train_step(model, Mesh(np.arange(2).reshape(1, 2),
                                    ('data', 'expert')))


def test_moe_zero1_on_and_off_give_bit_equal_params(world):
    """phi3.5-moe at (2, 2), two steps at lr 3e-3: the expert stacks'
    moments cut over data beside their expert blocks, the params bit-equal
    to the run without ZeRO-1 on every rank."""
    assert all(r['moe_zero1'] for r in world['four'])


def _assembled(blocks_by_rank, shapes):
    full = {k: np.full(shp, np.nan, np.float32) for k, shp in shapes.items()}
    for blocks in blocks_by_rank:
        for k, (a, bounds) in blocks.items():
            full[k][tuple(slice(lo, hi) for lo, hi in bounds)] = a
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
        for k, (a, bounds) in blocks.items():
            np.testing.assert_array_equal(
                a, whole[k][0][tuple(slice(lo, hi) for lo, hi in bounds)], k)
        assert blocks['params/layers/we_gate'][1][1] in ((0, 8), (8, 16))


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
    for k, (a, bounds) in blocks.items():
        np.testing.assert_array_equal(
            a, full[k][tuple(slice(lo, hi) for lo, hi in bounds)], err_msg=k)


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
