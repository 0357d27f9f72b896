"""The port's zamba2 (hybrid family) against the JAX package's, reduced
zamba2-2.7b in f32 with the reference's own weights bridged and global-layout
caches on both sides (the port has no region layout): the SSD pieces
(``ssd_step``, ``ssd_ref``, ``ssd_chunked`` from a carried state, at a T
that is not a multiple of the chunk, and at decays small enough that the
naive decay matrix overflows), ``_causal_conv`` from a carried state,
``mamba_block``, prefill followed by 8 greedy decode steps through the
shared block's paged pools, the long-context ``decode_dense`` step, the
training loss, and the reference's prefill/decode consistency case.

Tolerances (same arithmetic in f32, another summation order): atol 1e-4 on
scores, states and pools (as ``test_torch_models.py``); 1e-4 (1 + |x|) on
the SSD pieces (the reference kernel tests' WKV tolerance: sums over up to
256 tokens in another order); 1e-5 on the conv (four taps); greedy tokens
exactly equal.
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
from repro.models import zamba2 as jz
from repro.models.api import build_model as j_build_model
from repro_torch import configs as tconfigs
from repro_torch.bridge import cache_from_jax, params_from_jax
from repro_torch.models import common as tcm
from repro_torch.models import zamba2 as tz
from repro_torch.models.api import build_model as t_build_model

B = 2
ATOL = 1e-4
SSD_TOL = dict(rtol=1e-4, atol=1e-4)
CONV_TOL = dict(rtol=1e-5, atol=1e-5)
PROMPT = 144          # 9 pages of 16; two SSD chunks, the second padded
DECODE = 8
MAXP = (PROMPT + DECODE + 15) // 16


@functools.lru_cache(maxsize=None)
def _pair():
    jcfg = j_reduced(j_get_config('zamba2-2.7b'))
    tcfg = tconfigs.reduced(tconfigs.get_config('zamba2-2.7b'))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jparams = jax.tree.map(lambda x: x.astype(jnp.float32),
                           j_build_model(jcfg).init_params(
                               jax.random.PRNGKey(1)))
    # zero- and one-initialised leaves get values, so every term of the
    # block is exercised (A_log and dt_bias move the decays)
    rng = np.random.default_rng(0)
    layers = dict(jparams['layers'])
    for key, lo, hi in (('A_log', -1.0, 1.0), ('dt_bias', -1.0, 1.0),
                        ('conv_b', -0.2, 0.2), ('D', 0.5, 1.5)):
        layers[key] = jnp.asarray(rng.uniform(lo, hi, layers[key].shape),
                                  jnp.float32)
    jparams = dict(jparams, layers=layers)
    return jcfg, tcfg, jparams, params_from_jax(
        jax.tree.map(np.asarray, jparams))


def _np(x):
    return np.asarray(x, np.float32)


def _ssd_inputs(t, seed, *, h=4, p=8, n=8, dt_scale=1.0):
    rng = np.random.default_rng(seed)
    dt = rng.uniform(0.05, 1.0, (B, t, h)) * dt_scale
    return (rng.normal(size=(B, t, h, p)).astype(np.float32),
            rng.normal(size=(B, t, n)).astype(np.float32),
            rng.normal(size=(B, t, n)).astype(np.float32),
            np.exp(-dt).astype(np.float32),
            (rng.normal(size=(B, h, p, n)) * 0.5).astype(np.float32))


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def test_ssd_step_matches_the_reference():
    x, b, c, a, s = _ssd_inputs(1, 0)
    want = jz.ssd_step(x[:, 0], b[:, 0], c[:, 0], a[:, 0], s)
    got = tz.ssd_step(*_t(x[:, 0], b[:, 0], c[:, 0], a[:, 0], s))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), **SSD_TOL)


@pytest.mark.parametrize('t', [128, 200, 256, 37])
def test_ssd_chunked_and_ref_match_the_reference(t):
    """From a carried state: the port's sequential and chunked forms
    against the reference's, and against each other.  T = 200 and 37 pad
    the last chunk (a = 1 there): the state after it is the sequential
    one."""
    x, b, c, a, s = _ssd_inputs(t, 1)
    jy, js = jz.ssd_ref(x, b, c, a, s)
    jyc, jsc = jz.ssd_chunked(x, b, c, a, s)
    ty, ts = tz.ssd_ref(*_t(x, b, c, a, s))
    tyc, tsc = tz.ssd_chunked(*_t(x, b, c, a, s))
    for got, want in ((ty, jy), (ts, js), (tyc, jyc), (tsc, jsc),
                      (tyc, jy), (tsc, js)):
        np.testing.assert_allclose(got.numpy(), _np(want), **SSD_TOL)


def test_ssd_chunked_gradients_stay_finite_where_the_decay_overflows():
    """dt up to 5 (a down to exp(-5)): above the diagonal the reference's
    exponent L_t - L_i passes log(f32 max) and its exp is inf, whose
    gradient through the mask is NaN.  The port masks the exponent first:
    the loss and every gradient are finite and match the sequential form."""
    x, b, c, a, s = _ssd_inputs(256, 2, dt_scale=5.0)
    L = np.cumsum(np.log(a[:, :128]), axis=1)              # first chunk
    assert (L[:, :1] - L[:, -1:]).max() > np.log(np.finfo(np.float32).max)
    w = np.random.default_rng(3).normal(size=(B, 256, 4, 8)).astype(
        np.float32)

    def loss_grads(fn):
        args = [v.requires_grad_() for v in _t(x, b, c, a, s)]
        y, st = fn(*args)
        loss = (y * torch.from_numpy(w)).sum() + st.square().sum()
        return loss, torch.autograd.grad(loss, args)
    lc, gc = loss_grads(tz.ssd_chunked)
    lr, gr = loss_grads(tz.ssd_ref)
    assert torch.isfinite(lc)
    np.testing.assert_allclose(lc.item(), lr.item(), rtol=1e-5)
    for name, g, r in zip('xbcas', gc, gr):
        assert torch.isfinite(g).all(), name
        scale = r.abs().max().item()
        assert (g - r).abs().max().item() <= 1e-4 * scale, name


def test_ssd_chunked_stays_close_to_the_exact_recurrence_at_length():
    """zamba2's SSD widths (P = N = 64) over 2048 tokens, decays down to
    exp(-2): the chunked form in f32 within 2e-5 (1 + |y|) of the
    recurrence in f64, elementwise, as the sequential form in f32 is.  The
    decay exponents are sums over (i, t]; as differences of two long
    cumulative sums (the reference's form) they put outputs ~4x past it."""
    rng = np.random.default_rng(12)
    x, b, c = (rng.normal(size=shape).astype(np.float32) for shape in
               ((1, 2048, 2, 64), (1, 2048, 64), (1, 2048, 64)))
    a = np.exp(-2 * rng.random((1, 2048, 2))).astype(np.float32)
    s = (rng.normal(size=(1, 2, 64, 64)) * 0.1).astype(np.float32)
    want_y, want_s = tz.ssd_ref(*(t.double() for t in _t(x, b, c, a, s)))
    for fn in (tz.ssd_chunked, tz.ssd_ref):
        y, st = fn(*_t(x, b, c, a, s))
        for got, want in ((y, want_y), (st, want_s)):
            err = (got.double() - want).abs()
            assert (err <= 2e-5 * (1 + want.abs())).all(), fn.__name__


def test_causal_conv_from_a_carried_state():
    jcfg, _, _, _ = _pair()
    rng = np.random.default_rng(4)
    c = 2 * jcfg.d_model + 2 * jcfg.ssm_state
    k = jcfg.conv_kernel
    xbc = rng.normal(size=(B, 9, c)).astype(np.float32)
    w = (rng.normal(size=(k, c)) * 0.5).astype(np.float32)
    bias = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    st = rng.normal(size=(B, k - 1, c)).astype(np.float32)
    want = jz._causal_conv(xbc, w, bias, st)
    got = tz._causal_conv(*_t(xbc, w, bias, st))
    np.testing.assert_allclose(got[0].numpy(), _np(want[0]), **CONV_TOL)
    np.testing.assert_array_equal(got[1].numpy(), _np(want[1]))
    np.testing.assert_array_equal(got[1].numpy(), xbc[:, -(k - 1):])


@pytest.mark.parametrize('t', [1, 130])
def test_mamba_block_from_a_carried_state(t):
    jcfg, tcfg, jparams, tparams = _pair()
    rng = np.random.default_rng(5)
    d, d_in = jcfg.d_model, 2 * jcfg.d_model
    h = d_in // jcfg.ssm_head_dim
    n = jcfg.ssm_state
    x = rng.normal(size=(B, t, d)).astype(np.float32)
    conv = rng.normal(size=(B, jcfg.conv_kernel - 1, d_in + 2 * n)).astype(
        np.float32)
    ssm = (rng.normal(size=(B, h, jcfg.ssm_head_dim, n)) * 0.3).astype(
        np.float32)
    jlp = {k: v[1] for k, v in jparams['layers'].items()}
    tlp = {k: v[1] for k, v in tparams['layers'].items()}
    jh, jc = jz.mamba_block(jcfg, jlp, jnp.asarray(x),
                            {'conv': jnp.asarray(conv), 'ssm': jnp.asarray(ssm)})
    th, tconv, tssm = tz.mamba_block(tcfg, tlp, *_t(x, conv, ssm))
    np.testing.assert_allclose(th.numpy(), _np(jh), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tconv.numpy(), _np(jc['conv']), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(tssm.numpy(), _np(jc['ssm']), rtol=0,
                               atol=ATOL)


def _page_table():
    """Each row its own pages, shuffled over the pool; page 0 is the
    quarantine page."""
    ids = np.random.default_rng(6).permutation(B * MAXP) + 1
    return ids.reshape(B, MAXP).astype(np.int32)


def _caches(jcfg):
    """Zero global-layout caches, f32, for both packages."""
    jc = {'mamba': jcm.init_from_template(jz.mamba_cache_template(jcfg, B),
                                          jax.random.PRNGKey(0)),
          'attn': jcm.init_from_template(
              jz.attn_cache_template(jcfg, 1 + B * MAXP),
              jax.random.PRNGKey(0))}
    jc = jax.tree.map(lambda x: x.astype(jnp.float32), jc)
    return jc, cache_from_jax(jax.tree.map(np.asarray, jc))


def _close_tree(got, want):
    for key in ('conv', 'ssm'):
        np.testing.assert_allclose(got['mamba'][key].numpy(),
                                   _np(want['mamba'][key]), rtol=0,
                                   atol=ATOL, err_msg=key)
    for key in ('k', 'v'):
        np.testing.assert_allclose(got['attn'][key].numpy(),
                                   _np(want['attn'][key]), rtol=0,
                                   atol=ATOL, err_msg=key)


def test_prefill_and_decode_match_the_reference():
    """Prefill of PROMPT tokens into the shared block's pools through a
    shuffled page table, then DECODE greedy steps: scores, the Mamba state
    and every pool after each call, and the tokens chosen."""
    jcfg, tcfg, jparams, tparams = _pair()
    jc, tc = _caches(jcfg)
    pt = _page_table()
    tokens = np.random.default_rng(7).integers(
        0, jcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    jc, js = jax.jit(functools.partial(jz.prefill, jcfg))(
        jparams, jc, {'tokens': jnp.asarray(tokens),
                      'page_table': jnp.asarray(pt)})
    tc, ts = t_build_model(tcfg).prefill_fn(
        tparams, tc, {'tokens': torch.from_numpy(tokens),
                      'page_table': torch.from_numpy(pt)})
    np.testing.assert_allclose(ts.numpy(), _np(js), rtol=0, atol=ATOL)
    _close_tree(tc, jc)
    jdecode = jax.jit(functools.partial(jz.decode_step, jcfg))
    for i in range(DECODE):
        nxt = np.asarray(jnp.argmax(js, -1), np.int32)
        assert np.array_equal(ts.argmax(-1).numpy(), nxt), i
        pos = np.full(B, PROMPT + i, np.int32)
        jc, js = jdecode(jparams, jc, {'tokens': jnp.asarray(nxt),
                                       'positions': jnp.asarray(pos),
                                       'page_table': jnp.asarray(pt)})
        tc, ts = t_build_model(tcfg).decode_fn(
            tparams, tc, {'tokens': torch.from_numpy(nxt),
                          'positions': torch.from_numpy(pos),
                          'page_table': torch.from_numpy(pt)})
        np.testing.assert_allclose(ts.numpy(), _np(js), rtol=0, atol=ATOL)
        _close_tree(tc, jc)


def _dense_kv(pools, pt, max_seq):
    """The paged pools of every application gathered into the contiguous
    long-context layout (n_apps, B, max_seq, AH, AHD)."""
    k = pools[:, pt].reshape(pools.shape[0], B, -1, *pools.shape[3:])
    return np.ascontiguousarray(k[:, :, :max_seq])


def test_decode_dense_matches_the_reference_and_the_paged_step():
    """From the state after a prefill, ``decode_dense`` over the pools
    gathered into contiguous rows: against the reference's step, and
    against the paged step on the same state."""
    jcfg, tcfg, jparams, tparams = _pair()
    jc, tc = _caches(jcfg)
    pt = _page_table()
    tokens = np.random.default_rng(8).integers(
        0, jcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    model = t_build_model(tcfg)
    tc, ts = model.prefill_fn(tparams, tc, {
        'tokens': torch.from_numpy(tokens), 'page_table': torch.from_numpy(pt)})
    max_seq = MAXP * 16
    mamba = {k: v.numpy().copy() for k, v in tc['mamba'].items()}
    dense = {k: _dense_kv(tc['attn'][k].numpy(), pt, max_seq) for k in 'kv'}
    jc = {'mamba': jax.tree.map(jnp.asarray, mamba),
          'attn': jax.tree.map(jnp.asarray, dense)}
    td = cache_from_jax({'mamba': mamba, 'attn': dense})
    jdecode = jax.jit(functools.partial(jz.decode_step, jcfg,
                                        long_context=True))
    for i in range(3):
        nxt = ts.argmax(-1).numpy().astype(np.int32)
        pos = np.full(B, PROMPT + i, np.int32)
        batch = {'tokens': torch.from_numpy(nxt),
                 'positions': torch.from_numpy(pos)}
        jc, js = jdecode(jparams, jc, {'tokens': jnp.asarray(nxt),
                                       'positions': jnp.asarray(pos)})
        td, got = model.decode_fn(tparams, td, batch, long_context=True)
        tc, ts = model.decode_fn(tparams, tc, dict(
            batch, page_table=torch.from_numpy(pt)))
        np.testing.assert_allclose(got.numpy(), _np(js), rtol=0, atol=ATOL)
        np.testing.assert_allclose(got.numpy(), ts.numpy(), rtol=0,
                                   atol=ATOL)
        for key in ('conv', 'ssm'):
            np.testing.assert_allclose(td['mamba'][key].numpy(),
                                       _np(jc['mamba'][key]), rtol=0,
                                       atol=ATOL)
        for key in 'kv':
            np.testing.assert_allclose(td['attn'][key].numpy(),
                                       _np(jc['attn'][key]), rtol=0,
                                       atol=ATOL)


def test_forward_train_matches_the_reference():
    jcfg, tcfg, jparams, tparams = _pair()
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, jcfg.vocab_size, (B, 160)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (B, 160)).astype(np.int32)
    want, _ = jax.jit(functools.partial(jz.forward_train, jcfg))(
        jparams, {'tokens': jnp.asarray(tokens), 'labels': jnp.asarray(labels)})
    got, aux = t_build_model(tcfg).loss_fn(
        tparams, {'tokens': torch.from_numpy(tokens),
                  'labels': torch.from_numpy(labels)})
    assert aux['tokens'].item() == B * 160
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


@pytest.mark.parametrize('s', [31, 143])
def test_decode_after_prefill_equals_the_longer_prefill(s):
    """The reference's prefill/decode consistency case (its
    ``test_prefill_decode_consistency``) at full strength: the port writes
    a partial last page, so prefill(S) then one decode step is held to a
    prefill of S + 1 tokens -- scores, the Mamba state and the pools' live
    rows -- where the reference, at page 16, checks only shapes."""
    _, tcfg, _, tparams = _pair()
    model = t_build_model(tcfg)
    pt = torch.from_numpy(_page_table())
    tokens = torch.from_numpy(np.random.default_rng(10).integers(
        0, tcfg.vocab_size, (B, s + 1)).astype(np.int32))
    short = model.init_cache(engine_pages=1 + B * MAXP, batch_size=B,
                             device='cpu', dtype=torch.float32)
    short, _ = model.prefill_fn(tparams, short, {'tokens': tokens[:, :s],
                                                 'page_table': pt})
    short, got = model.decode_fn(tparams, short, {
        'tokens': tokens[:, s], 'positions': torch.full((B,), s),
        'page_table': pt})
    long = model.init_cache(engine_pages=1 + B * MAXP, batch_size=B,
                            device='cpu', dtype=torch.float32)
    long, want = model.prefill_fn(tparams, long, {'tokens': tokens,
                                                  'page_table': pt})
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    assert torch.equal(got.argmax(-1), want.argmax(-1))
    for key in ('conv', 'ssm'):
        torch.testing.assert_close(short['mamba'][key], long['mamba'][key],
                                   rtol=0, atol=ATOL)
    live = tcm.paged_gather(long['attn']['k'][0], pt)[:, :s + 1]
    torch.testing.assert_close(
        tcm.paged_gather(short['attn']['k'][0], pt)[:, :s + 1], live,
        rtol=0, atol=ATOL)


def test_cache_templates_match_the_reference():
    jcfg, tcfg, _, _ = _pair()
    shapes = lambda t: jax.tree.map(lambda l: tuple(l.shape), t,
                                    is_leaf=lambda l: hasattr(l, 'shape'))
    assert shapes(tz.mamba_cache_template(tcfg, 3)) == shapes(
        jz.mamba_cache_template(jcfg, 3))
    assert shapes(tz.attn_cache_template(tcfg, 9)) == shapes(
        jz.attn_cache_template(jcfg, 9))
    assert shapes(tz.attn_cache_template_dense(tcfg, 3, 64)) == shapes(
        jz.attn_cache_template_dense(jcfg, 3, 64))
    model = t_build_model(tcfg)
    cache = model.init_cache(engine_pages=9, batch_size=3, device='cpu')
    assert cache['mamba']['ssm'].dtype == torch.float32
    assert cache['mamba']['conv'].dtype == torch.bfloat16
    assert cache['attn']['k'].shape == (2, 9, 16, 4, 32)
    dense = model.init_cache(batch_size=3, max_seq=64, device='cpu',
                             dtype=torch.float32)
    assert dense['attn']['v'].shape == (2, 3, 64, 4, 32)
    assert dense['mamba']['conv'].dtype == torch.float32
    with pytest.raises(ValueError, match='batch_size'):
        model.cache_template(engine_pages=9)


def test_zeros_from_template_builds_nested_trees():
    tmpl = {'mamba': {'conv': tcm.PSpec((2, 3), (None, None)),
                      'ssm': tcm.PSpec((2,), (None,), dtype=torch.float32)},
            'attn': {'k': tcm.PSpec((4,), (None,), 'zeros')}}
    z = tcm.zeros_from_template(tmpl, 'cpu')
    assert set(z) == {'mamba', 'attn'} and set(z['mamba']) == {'conv', 'ssm'}
    assert z['mamba']['conv'].dtype == torch.bfloat16
    assert z['mamba']['ssm'].dtype == torch.float32
    assert not z['attn']['k'].any()
    z = tcm.zeros_from_template(tmpl, 'cpu', torch.float16)
    assert z['mamba']['conv'].dtype == z['attn']['k'].dtype == torch.float16
    assert z['mamba']['ssm'].dtype == torch.float32


def test_cache_bridge_takes_nested_trees():
    rng = np.random.default_rng(11)
    tree = {'mamba': {'conv': rng.normal(size=(2, 3)).astype(np.float32),
                      'ssm': rng.normal(size=(2, 4)).astype(np.float32)},
            'attn': {'k': rng.normal(size=(5,)).astype(np.float32)}}
    got = cache_from_jax(tree, dtype=torch.bfloat16)
    assert got['mamba']['ssm'].dtype == torch.float32          # kept f32
    assert got['mamba']['conv'].dtype == torch.bfloat16
    np.testing.assert_array_equal(got['mamba']['ssm'].numpy(),
                                  tree['mamba']['ssm'])
    np.testing.assert_array_equal(
        got['attn']['k'].float().numpy(),
        torch.from_numpy(tree['attn']['k']).bfloat16().float().numpy())


def test_no_kernel_path_and_no_engine():
    """As in the reference: no kernel path, no fused sampling, no chunked
    prefill, and the engine does not serve the family."""
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.kvpool import KVPool

    _, tcfg, _, tparams = _pair()
    model = t_build_model(tcfg)
    cache = model.init_cache(engine_pages=9, batch_size=B, device='cpu')
    with pytest.raises(NotImplementedError, match='no kernel path'):
        model.decode_fn(tparams, cache, {}, use_kernel=True)
    with pytest.raises(NotImplementedError, match='no kernel path'):
        model.prefill_fn(tparams, cache, {}, use_kernel=True)
    with pytest.raises(NotImplementedError, match='no kernel path'):
        model.loss_fn(tparams, {}, use_kernel=True)
    with pytest.raises(NotImplementedError):
        model.decode_sample_fn(tparams, cache, {})
    with pytest.raises(NotImplementedError):
        model.prefill_chunk_fn(tparams, cache, {})
    with pytest.raises(NotImplementedError, match='decoder-only'):
        Engine(model, tparams, KVPool(n_handles=4, pages_per_handle=2),
               device='cpu')
