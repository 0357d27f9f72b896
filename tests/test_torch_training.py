"""The port's trainer against the JAX package's, on the CPU: AdamW, its
schedule and global norm, the microbatched train step, checkpoints that
each package restores from the other, the data pipeline and the fault
tolerance copies, and ``launch/train.train``.

Weights are the reference's ``init_params``, carried across by the bridge
in f32.  Tolerances (same arithmetic in f32, another summation order):
- AdamW: the global norm within 1e-5 relative (an f32 sum of ~1e5
  squares in another order); in f32 the params and moments within 1e-6 of
  each leaf's max |x| after 3 steps, or the norm's 1e-5 where the clip
  binds (it scales every gradient by 1 / norm); in bf16 the params equal
  after the cast or 1 bf16 ulp apart (a last-bit difference of the f32
  update rounds either way), the f32 moments as in f32;
- ``lr_at`` within 1e-6 relative, ``global_norm`` within 1e-5;
- the train step: losses and gradient norms within 1e-5 relative over 4
  steps; params within 1e-4 of each leaf's max |x| after them;
- checkpoints across packages: continued losses within 1e-5 relative;
  the manifests' keys, shapes and dtypes equal;
- the port's own restart on the CPU retraces its losses bit for bit.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models.api import build_model as j_build_model
from repro.training import checkpoint as jckpt
from repro.training import data as jdata
from repro.training import optimizer as jopt
from repro.training.train_step import make_train_step as j_make_train_step
from repro_torch import configs as tconfigs
from repro_torch.bridge import (opt_state_from_jax, params_from_jax,
                                tree_to_jax)
from repro_torch.launch.mesh import Mesh
from repro_torch.models.api import build_model as t_build_model
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as opt
from repro_torch.training import tree as tr
from repro_torch.training.data import DataConfig, Prefetcher, batch_at
from repro_torch.training.fault_tolerance import (
    HeartbeatConfig, HeartbeatMonitor, StragglerDetector, elastic_mesh_shape,
    plan_recovery)
from repro_torch.training.train_step import make_train_step

ARCH = 'internlm2-1.8b'         # untied: the (D, V) / (V, D) head crosses


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32)
                        if x.dtype == jnp.bfloat16 else np.asarray(x), tree)


def _jparams(arch=ARCH, dtype=jnp.float32, seed=0):
    cfg = j_reduced(j_get_config(arch))
    params = j_build_model(cfg).init_params(jax.random.PRNGKey(seed))
    return cfg, jax.tree.map(lambda x: x.astype(dtype), params)


def _close_to_leaf_max(got, want, tol, what=''):
    """Every leaf of two numpy trees within ``tol`` of the leaf's max."""
    g, w = tr.leaves_with_paths(got), tr.leaves_with_paths(want)
    assert [k for k, _ in g] == [k for k, _ in w]
    for (key, a), (_, b) in zip(g, w):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape, (what, key, a.shape, b.shape)
        err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
        assert err <= tol, (what, key, err)


# ---------------------------------------------------------------------------
# The reference's own cases (tests/test_training.py) on the port's modules
# ---------------------------------------------------------------------------

def _adamw_minimizes_quadratic(_):
    cfg = opt.AdamWConfig(lr=0.1, warmup_steps=1, decay_steps=1000,
                          weight_decay=0.0, grad_clip=0)
    params = {'w': torch.tensor([5.0, -3.0])}
    state = opt.init_opt_state(params)
    for _ in range(200):
        g = {'w': 2 * params['w']}
        params, state, _ = opt.adamw_update(cfg, params, g, state)
    assert float((params['w'] ** 2).sum()) < 1e-2


def _lr_schedule_shape(_):
    cfg = opt.AdamWConfig(lr=1.0, warmup_steps=10, decay_steps=110,
                          min_lr_frac=0.1)
    lrs = [float(opt.lr_at(cfg, torch.tensor(s))) for s in range(0, 130, 5)]
    assert lrs[0] == 0.0
    assert max(lrs) == pytest.approx(1.0, abs=0.02)
    assert lrs[-1] == pytest.approx(0.1, abs=0.02)   # cosine floor


def _grad_clip_bounds_update_norm(_):
    cfg = opt.AdamWConfig(lr=1e-3, grad_clip=1.0, warmup_steps=1)
    params = {'w': torch.zeros(4)}
    state = opt.init_opt_state(params)
    g = {'w': torch.full((4,), 1e6)}
    _, _, metrics = opt.adamw_update(cfg, params, g, state)
    assert float(metrics['grad_norm']) > 1e5   # raw norm reported


def _batch_at_is_pure(_):
    cfg = DataConfig(seq_len=32, global_batch=4, vocab_size=100, seed=3)
    a, b = batch_at(cfg, 7), batch_at(cfg, 7)
    np.testing.assert_array_equal(a['tokens'], b['tokens'])
    c = batch_at(cfg, 8)
    assert not np.array_equal(a['tokens'], c['tokens'])


def _prefetcher_order_and_resume(_):
    cfg = DataConfig(seq_len=16, global_batch=2, vocab_size=50)
    pf = Prefetcher(cfg, start_step=5)
    steps = []
    for _ in range(4):
        s, batch = next(pf)
        steps.append(s)
        np.testing.assert_array_equal(batch['tokens'],
                                      batch_at(cfg, s)['tokens'])
    pf.close()
    assert steps == [5, 6, 7, 8]


def _labels_are_shifted_tokens(_):
    cfg = DataConfig(seq_len=32, global_batch=2, vocab_size=64, seed=0)
    b = batch_at(cfg, 0)
    np.testing.assert_array_equal(b['tokens'][:, 1:], b['labels'][:, :-1])


def _checkpoint_roundtrip_bitexact(tmp_path):
    tree = {'params': {'w': torch.arange(12, dtype=torch.float32)
                       .reshape(3, 4),
                       'b': torch.ones(4, dtype=torch.bfloat16)},
            'opt': {'step': torch.tensor(7, dtype=torch.int32)}}
    d = str(tmp_path)
    ckpt.save(d, 7, tree)
    assert ckpt.latest_step(d) == 7
    target = tr.tree_map(torch.zeros_like, tree)
    restored, step = ckpt.restore(d, 7, target)
    assert step == 7
    for a, b in zip(tr.leaves(tree), tr.leaves(restored)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.float().numpy(), b.float().numpy())


def _checkpoint_atomic_no_tmp_left(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 3, {'x': torch.zeros(2)})
    assert not any(p.endswith('.tmp') for p in os.listdir(d))


def _checkpoint_prune(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3, 4, 5):
        ckpt.save(d, s, {'x': torch.tensor([float(s)])})
    ckpt.prune(d, keep=2)
    assert ckpt.latest_step(d) == 5
    assert sorted(os.listdir(d)) == ['step_4', 'step_5']


def _checkpoint_overwrite_same_step(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, {'x': torch.tensor([1.0])})
    ckpt.save(d, 1, {'x': torch.tensor([2.0])})
    restored, _ = ckpt.restore(d, 1, {'x': torch.zeros(1)})
    assert float(restored['x'][0]) == 2.0


def _heartbeat_death_detection(_):
    mon = HeartbeatMonitor(['h0', 'h1', 'h2'],
                           HeartbeatConfig(interval_s=1.0, miss_threshold=3))
    for t in range(5):
        mon.beat('h0', float(t))
        mon.beat('h1', float(t))
        # h2 silent
    dead = mon.check(5.0)
    assert dead == ['h2']
    assert sorted(mon.alive) == ['h0', 'h1']


def _elastic_mesh_shrink(_):
    assert elastic_mesh_shape(256, 16) == (16, 16)
    assert elastic_mesh_shape(240, 16) == (15, 16)   # lost a 16-chip host
    assert elastic_mesh_shape(8, 16) is None         # below one model group


def _plan_recovery_end_to_end(_):
    mon = HeartbeatMonitor(['h0', 'h1'],
                           HeartbeatConfig(interval_s=1.0, miss_threshold=2))
    mon.beat('h0', 10.0)
    plan = plan_recovery(mon, devices_per_host=8, model_parallel=4,
                         last_ckpt_step=42, old_shape=(4, 4), now=10.0)
    assert plan is not None
    assert plan.lost_hosts == ['h1']
    assert plan.new_shape == (2, 4)
    assert plan.restore_step == 42


def _straggler_detection(_):
    det = StragglerDetector()
    for i in range(16):
        for h in ('a', 'b', 'c', 'd'):
            det.record(h, 1.0 if h != 'd' else 2.5)
    assert det.stragglers() == ['d']
    assert 'd' in det.quarantined


REFERENCE_CASES = [
    _adamw_minimizes_quadratic, _lr_schedule_shape,
    _grad_clip_bounds_update_norm, _batch_at_is_pure,
    _prefetcher_order_and_resume, _labels_are_shifted_tokens,
    _checkpoint_roundtrip_bitexact, _checkpoint_atomic_no_tmp_left,
    _checkpoint_prune, _checkpoint_overwrite_same_step,
    _heartbeat_death_detection, _elastic_mesh_shrink,
    _plan_recovery_end_to_end, _straggler_detection,
]


@pytest.mark.parametrize('case', REFERENCE_CASES,
                         ids=lambda f: f.__name__.lstrip('_'))
def test_reference_training_case_on_the_port(case, tmp_path):
    case(tmp_path)


# ---------------------------------------------------------------------------
# Held to the reference
# ---------------------------------------------------------------------------

def test_batch_at_bit_equal_to_the_reference():
    for seed, (b, s, v) in enumerate([(4, 32, 512), (2, 2048, 151_936)]):
        jc = jdata.DataConfig(seq_len=s, global_batch=b, vocab_size=v,
                              seed=seed)
        tc = DataConfig(seq_len=s, global_batch=b, vocab_size=v, seed=seed)
        for step in (0, 1, 17):
            want, got = jdata.batch_at(jc, step), batch_at(tc, step)
            for k in ('tokens', 'labels'):
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])


def test_lr_at_and_global_norm_match_the_reference():
    cfg = opt.AdamWConfig(lr=3e-4, warmup_steps=7, decay_steps=90)
    jcfg = jopt.AdamWConfig(lr=3e-4, warmup_steps=7, decay_steps=90)
    for s in range(0, 120, 3):
        want = float(jopt.lr_at(jcfg, jnp.asarray(s, jnp.int32)))
        got = float(opt.lr_at(cfg, torch.tensor(s, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=1e-6, abs=0.0), s
    _, jp = _jparams()
    want = float(jopt.global_norm(jp))
    got = float(opt.global_norm(params_from_jax(_np(jp))))
    assert got == pytest.approx(want, rel=1e-5)


def _random_grads(jp, step, scale, dtype):
    rng = np.random.default_rng(100 + step)
    return jax.tree.map(lambda x: jnp.asarray(
        rng.normal(size=x.shape) * scale, jnp.float32).astype(dtype), jp)


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('clip', ['active', 'inactive', 'disabled'])
def test_adamw_update_matches_the_reference(dtype, clip):
    """3 steps of ``adamw_update`` on the same params and gradients: the
    clip binding (norm ~30 > 1), not binding (norm ~0.3) and off."""
    jdt = jnp.float32 if dtype == 'f32' else jnp.bfloat16
    tdt = torch.float32 if dtype == 'f32' else torch.bfloat16
    kw = dict(lr=1e-2, warmup_steps=2, weight_decay=0.1,
              grad_clip=0.0 if clip == 'disabled' else 1.0)
    jcfg, tcfg = jopt.AdamWConfig(**kw), opt.AdamWConfig(**kw)
    _, jp = _jparams(dtype=jdt)
    n = sum(x.size for x in jax.tree.leaves(jp))
    scale = (30.0 if clip == 'active' else 0.3) / np.sqrt(n)
    tp = params_from_jax(_np(jp), dtype=tdt)
    js, ts = jopt.init_opt_state(jp), opt.init_opt_state(tp)
    for step in range(3):
        jg = _random_grads(jp, step, scale, jdt)
        tg = params_from_jax(_np(jg), dtype=tdt)
        jp, js, jm = jopt.adamw_update(jcfg, jp, jg, js)
        tp, ts, tm = opt.adamw_update(tcfg, tp, tg, ts)
        assert float(tm['lr']) == pytest.approx(float(jm['lr']), rel=1e-6)
        assert float(tm['grad_norm']) == pytest.approx(
            float(jm['grad_norm']), rel=1e-5)
        assert (float(jm['grad_norm']) > 1) == (clip == 'active')
    assert int(ts['step']) == int(js['step']) == 3
    assert ts['step'].dtype == torch.int32
    tol = 1e-5 if clip == 'active' else 1e-6
    got_state = tree_to_jax({'mu': ts['mu'], 'nu': ts['nu']})
    _close_to_leaf_max(got_state, _np({'mu': js['mu'], 'nu': js['nu']}),
                       tol, 'moments')
    got, want = tree_to_jax(tp), _np(jp)
    if dtype == 'f32':
        _close_to_leaf_max(got, want, tol, 'params')
        return
    for (key, a), (_, b) in zip(tr.leaves_with_paths(got),
                                tr.leaves_with_paths(want)):
        assert a.dtype == np.float32
        ulp = np.spacing(np.abs(b).astype(np.float32)) * 2.0 ** 16
        assert (np.abs(a - b) <= ulp).all(), (key, np.abs(a - b).max())
    assert all(p.dtype == torch.bfloat16 for p in tr.leaves(tp))


def _pair(arch=ARCH, **kw):
    jcfg = j_reduced(j_get_config(arch), **kw)
    tcfg = tconfigs.reduced(tconfigs.get_config(arch), **kw)
    return j_build_model(jcfg), t_build_model(tcfg)


def _batches(cfg, steps, b=4, s=32):
    dcfg = jdata.DataConfig(seq_len=s, global_batch=b,
                            vocab_size=cfg.vocab_size)
    return [jdata.batch_at(dcfg, i) for i in steps]


def _run_j(step, params, state, batches):
    losses, norms = [], []
    for b in batches:
        params, state, m = step(params, state, jax.tree.map(jnp.asarray, b))
        losses.append(float(m['loss']))
        norms.append(float(m['grad_norm']))
    return params, state, losses, norms


def _run_t(step, params, state, batches):
    losses, norms = [], []
    for b in batches:
        params, state, m = step(params, state, {
            k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(m['loss']))
        norms.append(float(m['grad_norm']))
    return params, state, losses, norms


@pytest.mark.parametrize('microbatches', [1, 2])
def test_train_step_matches_the_reference(microbatches):
    """4 steps of ``make_train_step`` from the same f32 weights on the
    same ``batch_at`` batches."""
    jmodel, tmodel = _pair()
    _, jp = _jparams()
    ocfg = dict(lr=3e-3, warmup_steps=2)
    jstep, _ = j_make_train_step(jmodel, None, microbatches=microbatches,
                                 opt_cfg=jopt.AdamWConfig(**ocfg))
    tstep = make_train_step(tmodel, microbatches=microbatches,
                            opt_cfg=opt.AdamWConfig(**ocfg))
    batches = _batches(jmodel.cfg, range(4))
    jp, js, jl, jn = _run_j(jstep, jp, jopt.init_opt_state(jp), batches)
    tp = params_from_jax(_np(_jparams()[1]), requires_grad=True)
    tp, ts, tl, tn = _run_t(tstep, tp, opt.init_opt_state(tp), batches)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(tn, jn, rtol=1e-5)
    assert jl[-1] < jl[0]
    _close_to_leaf_max(tree_to_jax(tp), _np(jp), 1e-4, 'params')


def test_microbatches_split_the_batch():
    """Two microbatches give the whole batch's loss and gradients (f32
    sums over equal halves, no mask)."""
    from repro_torch.training.train_step import loss_and_grads
    _, tmodel = _pair()
    tp = params_from_jax(_np(_jparams()[1]), requires_grad=True)
    batch = {k: torch.from_numpy(v)
             for k, v in _batches(tmodel.cfg, [0])[0].items()}
    l1, g1 = loss_and_grads(tmodel, tp, batch, 1)
    l2, g2 = loss_and_grads(tmodel, tp, batch, 2)
    assert float(l2) == pytest.approx(float(l1), rel=1e-6)
    assert all(g.dtype == torch.float32 for g in tr.leaves(g2))
    _close_to_leaf_max(tree_to_jax(g2), tree_to_jax(g1), 1e-5, 'grads')
    with pytest.raises(ValueError, match='split'):
        loss_and_grads(tmodel, tp, batch, 3)
    with pytest.raises(ValueError, match='require grad'):
        loss_and_grads(tmodel, params_from_jax(_np(_jparams()[1])), batch)
    # every family trains over model (rwkv6 by its wkv heads); another
    # axis is refused
    from repro_torch.training.train_step import TrainPlan, check_train_mesh
    rwkv = t_build_model(tconfigs.reduced(tconfigs.get_config('rwkv6-3b')))
    mesh = Mesh(np.arange(2).reshape(1, 2), ('data', 'model'))
    check_train_mesh(mesh)
    plan = TrainPlan(rwkv, mesh, coords={'data': 0, 'model': 1})
    assert plan.param_blocks['layers/Wr'].bounds[2] == (32, 64)
    with pytest.raises(NotImplementedError, match="mesh axes {'expert'"):
        make_train_step(rwkv, mesh=Mesh(np.arange(2).reshape(1, 2),
                                        ('data', 'expert')))


def _manifest(d, step):
    with open(os.path.join(d, f'step_{step}', 'manifest.json')) as f:
        m = json.load(f)
    return {k: (v['shape'], v['dtype']) for k, v in m['leaves'].items()}


def _with_frames(cfg, batches, seed=0):
    """encdec: each batch gains stub speech frames (normal * 0.02, as
    ``make_inputs`` draws them)."""
    if cfg.family != 'encdec':
        return batches
    rng = np.random.default_rng(seed)
    return [dict(b, frames=(rng.normal(size=b['tokens'].shape
                                       + (cfg.d_model,)) * 0.02)
                 .astype(np.float32)) for b in batches]


def _cross_restore(arch, writer, tmp_path):
    """One package trains 2 steps and saves; the other restores and runs
    2 more.  Both packages also continue their own run; the continued
    losses agree, and both packages' manifests name the same leaves with
    the same shapes and dtypes."""
    jmodel, tmodel = _pair(arch)
    ocfg = dict(lr=3e-3, warmup_steps=2)
    jstep, _ = j_make_train_step(jmodel, None,
                                 opt_cfg=jopt.AdamWConfig(**ocfg))
    tstep = make_train_step(tmodel, opt_cfg=opt.AdamWConfig(**ocfg))
    batches = _with_frames(jmodel.cfg, _batches(jmodel.cfg, range(4)))
    first, then = batches[:2], batches[2:]
    _, jp0 = _jparams(arch)
    jp, js, _, _ = _run_j(jstep, jp0, jopt.init_opt_state(jp0), first)
    tp = params_from_jax(_np(_jparams(arch)[1]), requires_grad=True)
    tp, ts, _, _ = _run_t(tstep, tp, opt.init_opt_state(tp), first)
    jdir, tdir = str(tmp_path / 'j'), str(tmp_path / 't')
    jckpt.save(jdir, 2, {'params': jp, 'opt': js})
    ckpt.save(tdir, 2, {'params': tp, 'opt': ts})
    assert _manifest(jdir, 2) == _manifest(tdir, 2)

    _, jl, _ = _run_j(jstep, jp, js, then)[1:]
    _, tl, _ = _run_t(tstep, tp, ts, then)[1:]
    if writer == 'reference':          # the port continues the reference
        target = {'params': params_from_jax(_np(jp0), requires_grad=True),
                  'opt': opt.init_opt_state(params_from_jax(_np(jp0)))}
        state, step = ckpt.restore(jdir, 2, target)
        assert step == 2 and int(state['opt']['step']) == 2
        assert all(p.requires_grad for p in tr.leaves(state['params']))
        _, cont, _ = _run_t(tstep, state['params'], state['opt'], then)[1:]
    else:                              # the reference continues the port
        target = {'params': jp0, 'opt': jopt.init_opt_state(jp0)}
        state, step = jckpt.restore(tdir, 2, target)
        assert step == 2 and int(state['opt']['step']) == 2
        state = jax.tree.map(jnp.asarray, state)
        _, cont, _ = _run_j(jstep, state['params'], state['opt'], then)[1:]
    np.testing.assert_allclose(cont, jl, rtol=1e-5)
    np.testing.assert_allclose(cont, tl, rtol=1e-5)


@pytest.mark.parametrize('writer', ['reference', 'port'])
def test_checkpoint_restores_across_packages(writer, tmp_path):
    _cross_restore(ARCH, writer, tmp_path)


@pytest.mark.parametrize('writer', ['reference', 'port'])
@pytest.mark.parametrize('arch', ['zamba2-2.7b', 'seamless-m4t-medium'])
def test_checkpoint_restores_across_packages_hybrid_encdec(arch, writer,
                                                           tmp_path):
    """:func:`_cross_restore` for the hybrid family (a tied head, the
    shared block's weights) and the encdec family (an untied ``unembed``,
    (D, V) in the checkpoint and (V, D) in the port; frames in every
    batch)."""
    _cross_restore(arch, writer, tmp_path)


def test_opt_state_bridge_round_trips():
    _, jp = _jparams()
    js = jopt.init_opt_state(jp)
    rng = np.random.default_rng(3)
    js = {'step': jnp.asarray(5, jnp.int32),
          'mu': jax.tree.map(lambda x: jnp.asarray(
              rng.normal(size=x.shape), jnp.float32), js['mu']),
          'nu': jax.tree.map(lambda x: jnp.asarray(
              rng.random(x.shape), jnp.float32), js['nu'])}
    ts = opt_state_from_jax(_np(js))
    assert ts['step'].dtype == torch.int32 and int(ts['step']) == 5
    assert tuple(ts['mu']['unembed'].shape) == tuple(
        js['mu']['unembed'].shape[::-1])
    back = tree_to_jax(ts)
    for (ka, a), (kb, b) in zip(tr.leaves_with_paths(back),
                                tr.leaves_with_paths(_np(js))):
        assert ka == kb
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# launch/train.train
# ---------------------------------------------------------------------------

def test_train_loss_decreases_and_restart_is_deterministic(tmp_path):
    """The reference's end-to-end case on the port's ``train`` on the
    CPU, where the restart retraces the first run bit for bit."""
    from repro_torch.launch.train import train
    d = str(tmp_path / 'ck')
    kw = dict(steps=12, batch=4, seq=32, use_reduced=True, log_every=100,
              opt_cfg=opt.AdamWConfig(lr=3e-3, warmup_steps=2),
              device='cpu')
    history = []
    _, _, losses = train('qwen3-0.6b', ckpt_dir=d, ckpt_every=8,
                         history=history, **kw)
    assert np.mean(losses[-4:]) < np.mean(losses[:4])   # learning signal
    assert [h['step'] for h in history] == list(range(12))
    assert [h['loss'] for h in history] == losses
    assert all(np.isfinite(h['grad_norm']) and h['seconds'] > 0
               for h in history)
    assert os.listdir(d) == ['step_8']
    _, _, losses2 = train('qwen3-0.6b', ckpt_dir=d, restore=True, **kw)
    assert len(losses2) == 4                            # steps 8..11
    np.testing.assert_allclose(losses2, losses[8:], rtol=2e-2, atol=2e-2)
    assert losses2 == losses[8:]                        # bit for bit


def test_train_runs_zamba2(tmp_path):
    """The hybrid family trains through ``train`` like any other config:
    a checkpoint and a restart that retraces its losses."""
    from repro_torch.launch.train import train
    d = str(tmp_path / 'ck')
    kw = dict(steps=3, batch=2, seq=32, use_reduced=True, log_every=100,
              opt_cfg=opt.AdamWConfig(lr=3e-3, warmup_steps=1),
              device='cpu', ckpt_dir=d)
    _, _, losses = train('zamba2-2.7b', ckpt_every=2, **kw)
    assert len(losses) == 3 and np.isfinite(losses).all()
    _, _, again = train('zamba2-2.7b', restore=True, **kw)
    assert again == losses[2:]


def test_train_refuses_encdec():
    """The encdec loss needs frames the synthetic data does not make: the
    entry point (and so the CLI) refuses the config before building
    anything, where the reference's ``train`` fails inside its first
    step."""
    from repro_torch.launch.train import train
    with pytest.raises(ValueError, match='frames'):
        train('seamless-m4t-medium', steps=1, device='cpu')


def test_train_without_cuda_raises(monkeypatch):
    from repro_torch.launch.train import train
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        train('qwen3-0.6b', steps=1)


@pytest.mark.parametrize('arch', ['qwen3-0.6b', 'phi3.5-moe-42b-a6.6b',
                                  'rwkv6-3b'])
def test_loss_fn_kernel_path_refuses_grad(arch):
    """``use_kernel=True`` takes a kernel with no backward: under autograd
    on params that require grad it raises; without grad it gives the
    plain path's loss (the CPU runs the kernels' plain versions)."""
    _, tmodel = _pair(arch)
    params = tmodel.init_params(0, device='cpu', requires_grad=True)
    b = _batches(tmodel.cfg, [0], b=2, s=64)[0]
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    with pytest.raises(RuntimeError, match='no backward kernel'):
        tmodel.loss_fn(params, batch, use_kernel=True)
    with torch.no_grad():
        got, _ = tmodel.loss_fn(params, batch, use_kernel=True)
        want, _ = tmodel.loss_fn(params, batch)
    assert float(got) == pytest.approx(float(want), rel=1e-3)
    assert tmodel.init_params(0, device='cpu')['embed'].requires_grad is False
