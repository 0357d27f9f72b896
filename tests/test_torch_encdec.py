"""The port's seamless-m4t (encdec family) against the JAX package's, reduced
seamless-m4t-medium in f32 with the reference's own weights bridged (its
zero-initialised biases given values) and global-layout caches on both
sides: ``encode`` and ``cross_kv``, the frames' bf16 rounding, prefill
followed by 8 greedy decode steps through the decoder's paged KV and the
dense cross K/V, the training loss, and the reference's prefill/decode
consistency case.

Tolerances (same arithmetic in f32, another summation order): 1e-5 on the
encoder output and the cross K/V; atol 1e-4 on scores and pools (as
``test_torch_models.py``); greedy tokens exactly equal.
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
from repro.models import encdec as jed
from repro.models.api import build_model as j_build_model
from repro_torch import configs as tconfigs
from repro_torch.bridge import cache_from_jax, params_from_jax
from repro_torch.models import common as tcm
from repro_torch.models import encdec as ted
from repro_torch.models.api import build_model as t_build_model

B = 2
ATOL = 1e-4
TOL = dict(rtol=1e-5, atol=1e-5)
S_ENC, PROMPT, DECODE, PG = 48, 32, 8, 16
MAXP = (PROMPT + DECODE + PG - 1) // PG


@functools.lru_cache(maxsize=None)
def _pair():
    jcfg = j_reduced(j_get_config('seamless-m4t-medium'))
    tcfg = tconfigs.reduced(tconfigs.get_config('seamless-m4t-medium'))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jparams = jax.tree.map(lambda x: x.astype(jnp.float32),
                           j_build_model(jcfg).init_params(
                               jax.random.PRNGKey(1)))
    rng = np.random.default_rng(0)
    for stack in ('enc_layers', 'dec_layers'):
        layers = dict(jparams[stack])
        for key in layers:
            if key.lstrip('x') in ('bq', 'bk', 'bv'):
                layers[key] = jnp.asarray(rng.uniform(
                    -0.5, 0.5, layers[key].shape), jnp.float32)
        jparams = dict(jparams, **{stack: layers})
    return jcfg, tcfg, jparams, params_from_jax(
        jax.tree.map(np.asarray, jparams))


def _np(x):
    return np.asarray(x, np.float32)


def _frames(cfg, s, seed):
    """Stub speech frames, as ``make_inputs`` draws them (normal * 0.02),
    in f32: both packages round them to bf16."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, s, cfg.d_model)) * 0.02).astype(np.float32)


def test_encode_and_cross_kv_match_the_reference():
    jcfg, tcfg, jparams, tparams = _pair()
    frames = _frames(jcfg, S_ENC, 1)
    jenc = jed.encode(jcfg, jparams, jnp.asarray(frames))
    tenc = ted.encode(tcfg, tparams, torch.from_numpy(frames))
    np.testing.assert_allclose(tenc.numpy(), _np(jenc), **TOL)
    jk, jv = jed.cross_kv(jcfg, jparams, jenc)
    tk, tv = ted.cross_kv(tcfg, tparams, tenc)
    assert tk.shape == (jcfg.dec_layers, B, S_ENC, jcfg.n_kv_heads, jcfg.hd)
    np.testing.assert_allclose(tk.numpy(), _np(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), _np(jv), **TOL)


def test_frames_are_rounded_to_bf16_first():
    """``encode`` rounds the frames to bf16 before ``frontend_proj`` whatever
    the weights' dtype: f32 frames give exactly the output of their bf16
    rounding, though their projections differ."""
    _, tcfg, _, tparams = _pair()
    frames = torch.from_numpy(_frames(tcfg, S_ENC, 2))
    rounded = frames.bfloat16().float()
    proj = tparams['frontend_proj']
    assert not torch.equal(frames @ proj, rounded @ proj)
    assert torch.equal(ted.encode(tcfg, tparams, frames),
                       ted.encode(tcfg, tparams, rounded))


def _caches(jcfg, enc_len):
    jc = jax.tree.map(lambda x: x.astype(jnp.float32), jcm.init_from_template(
        jed.cache_template(jcfg, 1 + B * MAXP, B, enc_len),
        jax.random.PRNGKey(0)))
    return jc, cache_from_jax(jax.tree.map(np.asarray, jc))


def _page_table():
    ids = np.random.default_rng(3).permutation(B * MAXP) + 1
    return ids.reshape(B, MAXP).astype(np.int32)


def _close_cache(got, want):
    for key in ('k', 'v', 'cross_k', 'cross_v'):
        np.testing.assert_allclose(got[key].numpy(), _np(want[key]), rtol=0,
                                   atol=ATOL, err_msg=key)


def test_prefill_and_decode_match_the_reference():
    """Encoder over S_ENC frames, a PROMPT-token decoder prefix into the
    paged pool through a shuffled page table, then DECODE greedy steps:
    scores, pools and cross K/V after each call, and the tokens chosen."""
    jcfg, tcfg, jparams, tparams = _pair()
    jc, tc = _caches(jcfg, S_ENC)
    pt = _page_table()
    frames = _frames(jcfg, S_ENC, 4)
    tokens = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    jc, js = jax.jit(functools.partial(jed.prefill, jcfg))(
        jparams, jc, {'frames': jnp.asarray(frames),
                      'tokens': jnp.asarray(tokens),
                      'page_table': jnp.asarray(pt)})
    model = t_build_model(tcfg)
    tc, ts = model.prefill_fn(tparams, tc, {
        'frames': torch.from_numpy(frames), 'tokens': torch.from_numpy(tokens),
        'page_table': torch.from_numpy(pt)})
    np.testing.assert_allclose(ts.numpy(), _np(js), rtol=0, atol=ATOL)
    _close_cache(tc, jc)
    jdecode = jax.jit(functools.partial(jed.decode_step, jcfg))
    for i in range(DECODE):
        nxt = np.asarray(jnp.argmax(js, -1), np.int32)
        assert np.array_equal(ts.argmax(-1).numpy(), nxt), i
        pos = np.full(B, PROMPT + i, np.int32)
        jc, js = jdecode(jparams, jc, {'tokens': jnp.asarray(nxt),
                                       'positions': jnp.asarray(pos),
                                       'page_table': jnp.asarray(pt)})
        tc, ts = model.decode_fn(tparams, tc, {
            'tokens': torch.from_numpy(nxt), 'positions': torch.from_numpy(pos),
            'page_table': torch.from_numpy(pt)})
        np.testing.assert_allclose(ts.numpy(), _np(js), rtol=0, atol=ATOL)
        _close_cache(tc, jc)


def test_forward_train_matches_the_reference():
    jcfg, tcfg, jparams, tparams = _pair()
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, jcfg.vocab_size, (B, 64)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (B, 64)).astype(np.int32)
    frames = _frames(jcfg, 64, 7)
    want, _ = jax.jit(functools.partial(jed.forward_train, jcfg))(
        jparams, {'tokens': jnp.asarray(tokens), 'labels': jnp.asarray(labels),
                  'frames': jnp.asarray(frames)})
    got, aux = t_build_model(tcfg).loss_fn(tparams, {
        'tokens': torch.from_numpy(tokens), 'labels': torch.from_numpy(labels),
        'frames': torch.from_numpy(frames)})
    assert aux['tokens'].item() == B * 64
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


@pytest.mark.parametrize('s', [15, 32])
def test_decode_after_prefill_equals_the_longer_prefill(s):
    """The reference's prefill/decode consistency case (its
    ``test_prefill_decode_consistency``) at full strength: prefill(S) then
    one decode step against a prefill of S + 1 decoder tokens over the same
    frames -- scores and the pools' live rows (the port writes a partial
    last page, where the reference, at page 16, checks only shapes)."""
    _, tcfg, _, tparams = _pair()
    model = t_build_model(tcfg)
    pt = torch.from_numpy(_page_table())
    frames = torch.from_numpy(_frames(tcfg, S_ENC, 8))
    tokens = torch.from_numpy(np.random.default_rng(9).integers(
        0, tcfg.vocab_size, (B, s + 1)).astype(np.int32))

    def cache():
        return model.init_cache(engine_pages=1 + B * MAXP, batch_size=B,
                                enc_len=S_ENC, device='cpu',
                                dtype=torch.float32)
    short, _ = model.prefill_fn(tparams, cache(), {
        'frames': frames, 'tokens': tokens[:, :s], 'page_table': pt})
    short, got = model.decode_fn(tparams, short, {
        'tokens': tokens[:, s], 'positions': torch.full((B,), s),
        'page_table': pt})
    long, want = model.prefill_fn(tparams, cache(), {
        'frames': frames, 'tokens': tokens, 'page_table': pt})
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    assert torch.equal(got.argmax(-1), want.argmax(-1))
    for key in ('k', 'v'):
        for layer in range(tcfg.dec_layers):
            torch.testing.assert_close(
                tcm.paged_gather(short[key][layer], pt)[:, :s + 1],
                tcm.paged_gather(long[key][layer], pt)[:, :s + 1],
                rtol=0, atol=ATOL)


def test_template_and_cache_match_the_reference():
    """The reference's keys (the cross-attention ones with the 'x'
    prefix) and shapes, ``unembed`` as (V, D); the cache's shapes."""
    jcfg, tcfg, _, _ = _pair()
    jt, tt = jed.template(jcfg), ted.template(tcfg)
    assert sorted(jt) == sorted(tt)
    for stack in ('enc_layers', 'dec_layers'):
        assert sorted(jt[stack]) == sorted(tt[stack])
        for k, spec in jt[stack].items():
            assert tuple(tt[stack][k].shape) == tuple(spec.shape), k
    assert 'xbk' in tt['dec_layers'] and 'xwq' in tt['dec_layers']
    assert tt['unembed'].shape == tuple(jt['unembed'].shape[::-1])
    jc = jed.cache_template(jcfg, 9, 3, 40)
    tc = t_build_model(tcfg).init_cache(engine_pages=9, batch_size=3,
                                        enc_len=40, device='cpu')
    assert {k: tuple(v.shape) for k, v in tc.items()} == {
        k: tuple(v.shape) for k, v in jc.items()}
    with pytest.raises(ValueError, match='enc_len'):
        t_build_model(tcfg).cache_template(engine_pages=9, batch_size=3)


def test_no_kernel_path_and_no_engine():
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.kvpool import KVPool

    _, tcfg, _, tparams = _pair()
    model = t_build_model(tcfg)
    cache = model.init_cache(engine_pages=9, batch_size=B, enc_len=8,
                             device='cpu')
    for call in (lambda: model.decode_fn(tparams, cache, {}, use_kernel=True),
                 lambda: model.prefill_fn(tparams, cache, {},
                                          use_kernel=True),
                 lambda: model.loss_fn(tparams, {}, use_kernel=True)):
        with pytest.raises(NotImplementedError, match='no kernel path'):
            call()
    # long_context is read for hybrid only, and ignored here, as the
    # reference's decode_fn ignores it
    batch = {'tokens': torch.zeros(B, dtype=torch.int32),
             'positions': torch.zeros(B, dtype=torch.int32),
             'page_table': torch.ones((B, 1), dtype=torch.int32)}
    with torch.no_grad():
        scores = [model.decode_fn(tparams, {k: v.clone()
                                            for k, v in cache.items()},
                                  batch, long_context=lc)[1]
                  for lc in (False, True)]
    assert torch.equal(scores[0], scores[1])
    with pytest.raises(NotImplementedError):
        model.decode_sample_fn(tparams, cache, {})
    with pytest.raises(NotImplementedError):
        model.prefill_chunk_fn(tparams, cache, {})
    with pytest.raises(NotImplementedError, match='decoder-only'):
        Engine(model, tparams, KVPool(n_handles=4, pages_per_handle=2),
               device='cpu')
