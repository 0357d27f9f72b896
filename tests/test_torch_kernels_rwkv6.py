"""The port's WKV6 (K6 on CPU tensors -- the kernel's tiled plain model
``wkv6_tiled_ref`` -- and the plain chunked form) against the JAX package's
Pallas kernel in interpret mode and its oracles, on the reference's own
cases (``tests/test_kernels_rwkv6.py``), at that file's tolerances: 1e-4
in f32 (other summation order), 3e-2 for bf16 inputs, 1e-3 for the
pathological decay, 1e-5 for the streaming composition.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6.ops import wkv6 as j_wkv6
from repro.kernels.rwkv6.ref import wkv6_chunked as j_chunked
from repro.kernels.rwkv6.ref import wkv6_ref as j_ref
from repro_torch.kernels.common import LAUNCHES
from repro_torch.kernels.rwkv6.ops import wkv6
from repro_torch.kernels.rwkv6.ref import (tf32_round, wkv6_chunked, wkv6_ref,
                                           wkv6_step, wkv6_tiled_ref)

CASES = [
    # (B, T, H, K, chunk, dtype)
    (2, 64, 2, 16, 16, 'float32'),
    (1, 128, 4, 32, 32, 'float32'),
    (2, 100, 2, 16, 32, 'float32'),      # unaligned T
    (1, 64, 2, 64, 16, 'bfloat16'),
    (3, 48, 1, 16, 64, 'float32'),       # chunk > T
]


def _setup(case, seed, decay_lo=-2.5):
    """The reference test's inputs, as (jax arrays, torch tensors) holding
    the same values."""
    b, t, h, dk, _, dtype = case
    rng = np.random.default_rng(seed)
    xs = [rng.normal(size=(b, t, h, dk)) * 0.5 for _ in range(3)]
    xs.append(np.exp(rng.uniform(decay_lo, -0.005, size=(b, t, h, dk))))
    xs.append(rng.normal(size=(h, dk)) * 0.3)
    jx = [jnp.asarray(x, getattr(jnp, dtype)) for x in xs]
    s0 = (rng.normal(size=(b, h, dk, dk)) * 0.1).astype(np.float32)
    jx.append(jnp.asarray(s0))
    tx = [torch.from_numpy(np.array(x, np.float32)).to(getattr(torch, dtype))
          for x in jx[:5]] + [torch.from_numpy(s0)]
    return jx, tx


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize('case', CASES)
def test_wkv6_matches_the_reference_kernel_and_oracle(case):
    jx, tx = _setup(case, sum(case[:5]))
    chunk = case[4]
    tol = 3e-2 if case[5] == 'bfloat16' else 1e-4
    y, s = wkv6(*tx, chunk=chunk)
    assert y.dtype == tx[0].dtype and s.dtype == torch.float32
    jy, js = j_wkv6(*jx, chunk=chunk, interpret=True)
    _close(y, jy, tol)
    _close(s, js, tol)
    f32 = [jnp.asarray(x, jnp.float32) for x in jx]
    ry, rs = j_ref(*f32)
    _close(y, ry, tol)
    _close(s, rs, tol)
    # the plain chunked form at the case's chunk, against the reference's
    cy, cs = wkv6_chunked(*[x.float() for x in tx], chunk=chunk)
    oy, os_ = j_chunked(*f32, chunk=chunk)
    _close(cy, oy, 1e-4)
    _close(cs, os_, 1e-4)


def test_wkv6_matches_the_chunked_oracle():
    jx, tx = _setup((2, 96, 2, 32, 32, 'float32'), 11)
    y, s = wkv6(*tx, chunk=32)
    oy, os_ = j_chunked(*jx, chunk=32)
    _close(y, oy, 1e-4)
    _close(s, os_, 1e-4)


def test_wkv6_pathological_decay_small_chunk():
    """log w down to -12 a step: the recurrence stays exact, and the
    chunked form at chunk 8 stays inside its f32 envelope."""
    jx, tx = _setup((1, 64, 2, 16, 8, 'float32'), 3, decay_lo=-12.0)
    y, s = wkv6(*tx, chunk=8)
    assert torch.isfinite(y).all()
    ry, rs = j_ref(*jx)
    _close(y, ry, 1e-3)
    _close(s, rs, 1e-3)
    cy, cs = wkv6_chunked(*tx, chunk=8)
    _close(cy, ry, 1e-3)
    _close(cs, rs, 1e-3)


def test_wkv6_state_streaming_composition():
    """T tokens at once == two halves with the state carried."""
    _, (r, k, v, w, u, s0) = _setup((1, 64, 2, 16, 16, 'float32'), 5)
    y_full, s_full = wkv6(r, k, v, w, u, s0, chunk=16)
    half = 32
    y1, s1 = wkv6(r[:, :half], k[:, :half], v[:, :half], w[:, :half], u, s0,
                  chunk=16)
    y2, s2 = wkv6(r[:, half:], k[:, half:], v[:, half:], w[:, half:], u, s1,
                  chunk=16)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(s2, s_full, rtol=1e-5, atol=1e-5)


def test_single_step_is_the_recurrence():
    _, (r, k, v, w, u, s0) = _setup((2, 1, 2, 16, 16, 'float32'), 9)
    y, s = wkv6_step(r[:, 0], k[:, 0], v[:, 0], w[:, 0], u, s0)
    y_seq, s_seq = wkv6_ref(r, k, v, w, u, s0)
    torch.testing.assert_close(y, y_seq[:, 0], rtol=0, atol=0)
    torch.testing.assert_close(s, s_seq, rtol=0, atol=0)


def test_cpu_tensors_take_the_plain_version_and_grad_is_refused():
    _, tx = _setup(CASES[0], 0)
    before = dict(LAUNCHES)
    wkv6(*tx)
    assert LAUNCHES == before
    with pytest.raises(RuntimeError, match='no backward'):
        wkv6(tx[0].requires_grad_(), *tx[1:])
    with pytest.raises(ValueError, match='chunk'):
        wkv6(tx[0].detach(), *tx[1:], chunk=0)


TILED_CASES = [
    # (B, T, H, K, tile)
    (2, 100, 2, 16, 32),      # ragged T
    (1, 7, 3, 32, 32),        # T below one tile
    (2, 64, 2, 64, 32),
    (1, 45, 2, 64, 64),       # a 64-token tile, ragged
]


@pytest.mark.parametrize('case', TILED_CASES)
def test_tiled_plain_model_matches_the_reference_kernel_and_oracle(case):
    """The kernel's algorithm (running products a 16-token sub-block, the
    diagonal blocks normalised per channel) against the JAX Pallas kernel
    in interpret mode and the JAX sequential recurrence, with a non-zero
    state, at 1e-4."""
    b, t, h, dk, tile = case
    jx, tx = _setup((b, t, h, dk, 16, 'float32'), sum(case))
    y, s = wkv6_tiled_ref(*tx, tile=tile)
    assert torch.count_nonzero(tx[5]) > 0
    jy, js = j_wkv6(*jx, chunk=16, interpret=True)
    ry, rs = j_ref(*jx)
    for want_y, want_s in ((jy, js), (ry, rs)):
        _close(y, want_y, 1e-4)
        _close(s, want_s, 1e-4)


def test_tiled_plain_model_streams_the_state():
    """T tokens at once == a split off the tile boundary with the state
    carried: the second call starts its own tiles there."""
    _, (r, k, v, w, u, s0) = _setup((1, 70, 2, 32, 16, 'float32'), 12)
    y_full, s_full = wkv6_tiled_ref(r, k, v, w, u, s0)
    cut = 37
    y1, s1 = wkv6_tiled_ref(r[:, :cut], k[:, :cut], v[:, :cut], w[:, :cut],
                            u, s0)
    y2, s2 = wkv6_tiled_ref(r[:, cut:], k[:, cut:], v[:, cut:], w[:, cut:],
                            u, s1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(s2, s_full, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('tile', [32, 64])
def test_tiled_plain_model_has_no_decay_envelope(tile):
    """Log-decays down to -12 a token, and rows of w = 1e-30 and w = 0:
    the tiled model stays finite and within 1e-3 of the recurrence, where
    the midpoint-normalised chunked form at chunk 64 overflows."""
    jx, (r, k, v, w, u, s0) = _setup((2, 96, 2, 64, 64, 'float32'), 4,
                                     decay_lo=-12.0)
    w = w.clone()
    w[0, 10:14] = 1e-30
    w[1, 40:43] = 0.0
    w[:, 70, 0] = 0.0
    f32 = [jnp.asarray(x.numpy()) for x in (r, k, v, w, u, s0)]
    ry, rs = j_ref(*f32)
    y, s = wkv6_tiled_ref(r, k, v, w, u, s0, tile=tile)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    _close(y, ry, 1e-3)
    _close(s, rs, 1e-3)
    # through the wrapper on CPU tensors (any chunk: the tile is its own)
    wy, ws = wkv6(r, k, v, w, u, s0, chunk=64)
    _close(wy, ry, 1e-3)
    _close(ws, rs, 1e-3)
    cy, _ = wkv6_chunked(r, k, v, w, u, s0, chunk=64)
    off = not torch.isfinite(cy).all() or not np.allclose(
        cy.numpy(), np.asarray(ry), rtol=1e-3, atol=1e-3)
    assert off, 'the chunked form at chunk 64 was expected to overflow here'


def test_tf32_round_is_cvt_rna():
    """Round to 10 mantissa bits, to nearest, ties away from zero."""
    x = torch.tensor([1 + 2 ** -12, 1 + 2 ** -11, 1 + 3 * 2 ** -12,
                      -(1 + 2 ** -11), 3.0, 0.0])
    want = torch.tensor([1.0, 1 + 2 ** -10, 1 + 2 ** -10, -(1 + 2 ** -10),
                         3.0, 0.0])
    assert torch.equal(tf32_round(x), want)


def test_single_pass_tf32_fails_the_f32_rule():
    """The f32 rule (1e-4 (1 + |want|)) rejects the tiled model with every
    product's operands rounded once to TF32 -- the single-pass tensor-core
    mutant the chip check holds the kernel against -- and passes it in
    f32."""
    _, tx = _setup((2, 256, 2, 64, 64, 'float32'), 8)
    want_y, _ = wkv6_ref(*tx)

    def worst(got):
        return ((got - want_y).abs() / (1 + want_y.abs())).max().item()

    assert worst(wkv6_tiled_ref(*tx)[0]) <= 1e-4
    assert worst(wkv6_tiled_ref(*tx, tf32=True)[0]) > 1e-4
