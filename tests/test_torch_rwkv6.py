"""The port's rwkv6 against the JAX package's, reduced rwkv6-3b in f32 with
the reference's own weights bridged: ``forward_train`` through the WKV6
kernel path and the plain chunked path (the reference's Pallas kernel in
interpret mode), ``time_mix`` from a non-zero state, ``channel_mix``,
``chunked_ce_loss`` with a mask, and the rwkv6 weight and state bridge.

Tolerances: 1e-5 on losses and the channel mix (same arithmetic in f32,
other summation order); 1e-4 on the time mix's output and WKV state, the
reference kernel tests' WKV tolerance (64 tokens of f32 sums in another
order, then a per-head norm over 16 channels).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import common as jcm
from repro.models import rwkv6 as jrwkv6
from repro.models.api import build_model as j_build_model
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax, state_from_jax
from repro_torch.models import common as tcm
from repro_torch.models import rwkv6 as trwkv6
from repro_torch.models.api import build_model as t_build_model

B, T = 2, 64
TOL = dict(rtol=1e-5, atol=1e-5)
WKV_TOL = dict(rtol=1e-4, atol=1e-4)


@functools.lru_cache(maxsize=None)
def _pair():
    jcfg = j_reduced(j_get_config('rwkv6-3b'))
    tcfg = tconfigs.reduced(tconfigs.get_config('rwkv6-3b'))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jparams = jax.tree.map(lambda x: x.astype(jnp.float32),
                           j_build_model(jcfg).init_params(
                               jax.random.PRNGKey(2)))
    # zero-initialised leaves (token-shift mixes, decay base, bonus) get
    # values, so every term of the block is exercised
    rng = np.random.default_rng(0)
    layers = dict(jparams['layers'])
    for key, scale in (('mu', 0.5), ('mu_cm', 0.5), ('w_base', 0.5),
                       ('u', 0.3)):
        layers[key] = jnp.asarray(rng.uniform(-scale, scale,
                                              layers[key].shape), jnp.float32)
    jparams = dict(jparams, layers=layers)
    return jcfg, tcfg, jparams, params_from_jax(
        jax.tree.map(np.asarray, jparams))


def _layer(jparams, tparams, i=0):
    return ({k: v[i] for k, v in jparams['layers'].items()},
            {k: v[i] for k, v in tparams['layers'].items()})


def _x(cfg, t, seed):
    x = np.random.default_rng(seed).normal(size=(B, t, cfg.d_model))
    return x.astype(np.float32)


def _state(cfg, seed):
    """A non-zero recurrent state for one layer, as numpy."""
    rng = np.random.default_rng(seed)
    h = cfg.d_model // cfg.ssm_head_dim
    hd = cfg.ssm_head_dim
    return {'wkv': (rng.normal(size=(B, h, hd, hd)) * 0.1).astype(np.float32),
            'shift_tm': rng.normal(size=(B, cfg.d_model)).astype(np.float32),
            'shift_cm': rng.normal(size=(B, cfg.d_model)).astype(np.float32)}


@pytest.mark.parametrize('use_kernel', [False, True])
def test_forward_train_matches_the_reference(use_kernel):
    jcfg, tcfg, jparams, tparams = _pair()
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    want, _ = jax.jit(functools.partial(
        jrwkv6.forward_train, jcfg, remat=False, use_kernel=use_kernel))(
        jparams, {'tokens': jnp.asarray(tokens), 'labels': jnp.asarray(labels)})
    got, aux = t_build_model(tcfg).loss_fn(
        tparams, {'tokens': torch.from_numpy(tokens),
                  'labels': torch.from_numpy(labels)}, use_kernel=use_kernel)
    assert aux['tokens'].item() == B * T
    np.testing.assert_allclose(got.item(), float(want), **TOL)


@pytest.mark.parametrize('use_kernel,t', [(False, T), (True, T), (True, 1)])
def test_time_mix_from_a_nonzero_state(use_kernel, t):
    """Sequence through the kernel path or the chunked path, and the
    single-token step (t = 1), each from the same bridged state."""
    jcfg, tcfg, jparams, tparams = _pair()
    jlp, tlp = _layer(jparams, tparams)
    x, st = _x(jcfg, t, 5), _state(jcfg, 6)
    want = jrwkv6.time_mix(jcfg, jlp, jnp.asarray(x),
                           jnp.asarray(st['shift_tm']),
                           jnp.asarray(st['wkv']), use_kernel=use_kernel)
    ts = state_from_jax(st)
    got = trwkv6.time_mix(tcfg, tlp, torch.from_numpy(x), ts['shift_tm'],
                          ts['wkv'], use_kernel=use_kernel)
    out, shift, wkv = got
    np.testing.assert_allclose(out.numpy(), np.asarray(want[0]), **WKV_TOL)
    np.testing.assert_array_equal(shift.numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(wkv.numpy(), np.asarray(want[2]), **WKV_TOL)


def test_channel_mix_from_a_nonzero_state():
    jcfg, tcfg, jparams, tparams = _pair()
    jlp, tlp = _layer(jparams, tparams, 1)
    x, st = _x(jcfg, T, 7), _state(jcfg, 8)
    want = jrwkv6.channel_mix(jcfg, jlp, jnp.asarray(x),
                              jnp.asarray(st['shift_cm']))
    got = trwkv6.channel_mix(tcfg, tlp, torch.from_numpy(x),
                             torch.from_numpy(st['shift_cm']))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_chunked_ce_loss_with_a_mask():
    """S = 1024: two 512-token chunks; a mask drops a third of the tokens."""
    rng = np.random.default_rng(9)
    b, s, d, v = 2, 1024, 32, 300
    h = rng.normal(size=(b, s, d)).astype(np.float32)
    norm_w = rng.uniform(0.5, 1.5, d).astype(np.float32)
    unembed = (rng.normal(size=(d, v)) * d ** -0.5).astype(np.float32)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    mask = (rng.uniform(size=(b, s)) > 0.33).astype(np.float32)
    want = jcm.chunked_ce_loss(jnp.asarray(h), jnp.asarray(norm_w),
                               jnp.asarray(unembed), jnp.asarray(labels),
                               mask=jnp.asarray(mask))
    got = tcm.chunked_ce_loss(torch.from_numpy(h), torch.from_numpy(norm_w),
                              torch.from_numpy(unembed.T.copy()),
                              torch.from_numpy(labels),
                              mask=torch.from_numpy(mask))
    assert got[1].item() == mask.sum()
    np.testing.assert_allclose(got[0].item(), float(want[0]), rtol=1e-5)


def test_bridge_carries_rwkv6_weights_and_state():
    """The head arrives (V, D) row-major, the port's own init draws it
    with the reference's law (std d^-0.5, not V^-0.5), and the state
    bridge keeps ``wkv`` f32 while the shift states take the model dtype."""
    jcfg, tcfg, jparams, tparams = _pair()
    head = tparams['unembed']
    assert head.shape == (jcfg.vocab_size, jcfg.d_model)
    assert head.is_contiguous()
    np.testing.assert_array_equal(head.numpy(),
                                  np.asarray(jparams['unembed']).T)
    drawn = t_build_model(tcfg).init_params(0, device='cpu')
    std = drawn['unembed'].float().std().item()
    assert abs(std - tcfg.d_model ** -0.5) < 0.1 * tcfg.d_model ** -0.5
    jshapes = jax.tree.map(lambda x: x.shape, jparams)
    for key, w in drawn['layers'].items():
        assert tuple(w.shape) == jshapes['layers'][key], key
    st = state_from_jax(_state(jcfg, 1), dtype=torch.bfloat16)
    assert st['wkv'].dtype == torch.float32
    assert st['shift_tm'].dtype == st['shift_cm'].dtype == torch.bfloat16
    zero = t_build_model(tcfg).init_cache(batch_size=B, device='cpu')
    jzero = jrwkv6.init_state(jcfg, B)
    for key, t in zero.items():
        assert tuple(t.shape) == jzero[key].shape, key
        assert str(t.dtype).split('.')[-1] == str(jzero[key].dtype), key


def _full_state(cfg, seed):
    """A non-zero recurrent state for every layer, as numpy."""
    rng = np.random.default_rng(seed)
    layers = [_state(cfg, int(s)) for s in rng.integers(0, 2 ** 31, 2)]
    layers = [layers[i % 2] for i in range(cfg.n_layers)]
    return {k: np.stack([st[k] for st in layers]) for k in layers[0]}


@pytest.mark.parametrize('use_kernel', [False, True])
def test_prefill_and_decode_match_the_reference(use_kernel):
    """A ragged prompt (T = 37) from a non-zero state, then 16 greedy
    decode steps: scores and every state within the WKV tolerance, the
    greedy tokens equal.  The reference prefills on its plain chunked
    path; the port's kernel route runs K6's plain version on the CPU."""
    jcfg, tcfg, jparams, tparams = _pair()
    t_ragged, steps = 37, 16
    tokens = np.random.default_rng(11).integers(
        0, jcfg.vocab_size, (B, t_ragged)).astype(np.int32)
    state = _full_state(jcfg, 12)
    jcache, jscores = jrwkv6.prefill(
        jcfg, jparams, {k: jnp.asarray(v) for k, v in state.items()},
        {'tokens': jnp.asarray(tokens)})
    model = t_build_model(tcfg)
    tcache = state_from_jax(state)
    tcache, tscores = model.prefill_fn(
        tparams, tcache, {'tokens': torch.from_numpy(tokens)},
        use_kernel=use_kernel)

    def held(jcache, jscores, tcache, tscores):
        np.testing.assert_allclose(tscores.numpy(), np.asarray(jscores),
                                   **WKV_TOL)
        for key, v in tcache.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(jcache[key]),
                                       **WKV_TOL)

    held(jcache, jscores, tcache, tscores)
    jstep = jax.jit(functools.partial(jrwkv6.decode_step, jcfg))
    want, got = [], []
    for _ in range(steps):
        jtok = jnp.argmax(jscores, axis=-1).astype(jnp.int32)
        ttok = tscores.argmax(dim=-1).to(torch.int32)
        want.append(np.asarray(jtok).tolist())
        got.append(ttok.tolist())
        jcache, jscores = jstep(jparams, jcache, {'tokens': jtok})
        tcache, tscores = model.decode_fn(tparams, tcache, {'tokens': ttok})
        held(jcache, jscores, tcache, tscores)
    assert got == want


def test_cache_template_matches_the_reference():
    jcfg, tcfg, _, _ = _pair()
    model = t_build_model(tcfg)
    cache = model.init_cache(batch_size=3, device='cpu')
    jtmpl = jrwkv6.cache_template(jcfg, 3)
    assert set(cache) == set(jtmpl)
    for key, t in cache.items():
        assert tuple(t.shape) == jtmpl[key].shape, key
        assert not t.any(), key
    assert cache['wkv'].dtype == torch.float32
    with pytest.raises(NotImplementedError):
        model.init_cache(engine_pages=8, device='cpu')
