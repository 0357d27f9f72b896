"""The port's flash attention (K5) on CPU tensors -- its plain version --
against the JAX package's Pallas kernel in interpret mode and its oracle,
on the reference's own cases (``tests/test_kernels_flash.py``).

Tolerances are the reference test's: 2e-5 in f32 (same math, other
summation order), 2e-2 in bf16 (the reference rounds the probabilities to
bf16 before the product with V; the port's plain version keeps them f32).
The bf16 tensor-core kernel's own numerics (P meets V as two bf16 terms)
are modelled below against the on-card rule, 1e-3 + 2^-7 |ref|.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as j_ref
from repro_torch.kernels.common import LAUNCHES
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     kernel_route)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

CASES = [
    # (B, Sq, Skv, Hq, Hkv, D, causal, dtype, bq, bk) -- bq/bk: the JAX
    # kernel's blocks; the port's kernel tiles 64 x 64 on its own
    (1, 128, 128, 4, 4, 64, True, 'float32', 64, 64),
    (2, 256, 256, 8, 2, 64, True, 'float32', 128, 128),
    (1, 128, 128, 4, 1, 128, True, 'bfloat16', 64, 64),
    (2, 192, 192, 4, 2, 32, True, 'float32', 64, 64),   # ragged blocks
    (1, 64, 256, 2, 2, 64, False, 'float32', 64, 64),   # cross, non-causal
    (2, 100, 100, 4, 4, 64, True, 'float32', 64, 64),   # unaligned seq
]


def _inputs(case):
    b, sq, skv, hq, hkv, d, causal, dtype = case[:8]
    rng = np.random.default_rng(sum(case[:6]))
    shapes = [(b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d)]
    xs = [(rng.normal(size=s) * 0.5).astype(np.float32) for s in shapes]
    jx = [jnp.asarray(x, getattr(jnp, dtype)) for x in xs]
    # the same values in torch: bf16 rounding of f32 is exact in both
    tx = [torch.from_numpy(np.array(x, np.float32)).to(getattr(torch, dtype))
          for x in jx]
    return jx, tx


@pytest.mark.parametrize('case', CASES)
def test_flash_matches_the_reference_kernel(case):
    causal, dtype, bq, bk = case[6:]
    (jq, jk, jv), (tq, tk, tv) = _inputs(case)
    want = j_flash(jq, jk, jv, causal=causal, block_q=bq, block_k=bk,
                   interpret=True)
    got = flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = 2e-2 if dtype == 'bfloat16' else 2e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(
        flash_attention_ref(tq, tk, tv, causal=causal).float().numpy(),
        np.asarray(j_ref(jq, jk, jv, causal=causal), np.float32),
        rtol=tol, atol=tol)


def test_causal_mask_is_top_left_aligned():
    """Sq < Skv, causal: query row i sees keys 0..i only (positions from 0
    in both sequences, as the TPU kernel's block positions), so a change
    to keys past the last query row changes nothing."""
    (_, _, _), (q, k, v) = _inputs((1, 64, 256, 2, 2, 64, True, 'float32'))
    out = flash_attention(q, k, v, causal=True)
    k2, v2 = k.clone(), v.clone()
    k2[:, 64:] = 0
    v2[:, 64:] = 7.0
    torch.testing.assert_close(flash_attention(q, k2, v2, causal=True), out,
                               rtol=0, atol=0)
    assert not torch.equal(flash_attention(q, k2, v2, causal=False),
                           flash_attention(q, k, v, causal=False))


def test_cpu_tensors_take_the_plain_version_and_grad_is_refused():
    (_, _, _), (q, k, v) = _inputs(CASES[0])
    before = dict(LAUNCHES)
    flash_attention(q, k, v)
    assert LAUNCHES == before                 # no launch on the CPU
    with pytest.raises(RuntimeError, match='no backward'):
        flash_attention(q.requires_grad_(), k, v)
    with torch.no_grad():                     # no graph, nothing to drop
        flash_attention(q, k, v)


def test_kernel_route_by_dtype_and_head_dim():
    """One place picks the CUDA kernel: bf16 at D=64 or 128 goes to the
    tensor-core kernel, f32 (the parity dtype, held to 2e-5) and bf16 at
    D=32 to the f32-FMA kernel."""
    assert kernel_route(torch.bfloat16, 128) == 'sm90'
    assert kernel_route(torch.bfloat16, 64) == 'sm90'
    assert kernel_route(torch.bfloat16, 32) == 'fma'
    for d in (32, 64, 128):
        assert kernel_route(torch.float32, d) == 'fma'


def _tiled_bf16_p(q, k, v, residual: bool, block: int = 128):
    """Plain model of the tensor-core kernel's numerics, causal: 128-key
    tiles, the online softmax in f32, P rounded to bf16 for the product
    with V and, with ``residual``, p - bf16(p) rounded to bf16 through a
    second product; l sums the unrounded p; exact products of bf16 values
    summed in f32, as the tensor cores sum them."""
    b, sq, hq, d = q.shape
    skv, g = k.shape[1], hq // k.shape[2]
    kf, vf = (x.float().repeat_interleave(g, 2) for x in (k, v))
    s = torch.einsum('bqhd,bkhd->bhqk', q.float(), kf) * d ** -0.5
    s = torch.where(torch.arange(sq)[:, None] >= torch.arange(skv), s, -1e30)
    m = torch.full((b, hq, sq), -1e30)
    l, acc = torch.zeros(b, hq, sq), torch.zeros(b, hq, sq, d)
    for k0 in range(0, skv, block):
        st = s[..., k0:k0 + block]
        m_new = torch.maximum(m, st.amax(-1))
        alpha, p = torch.exp(m - m_new), torch.exp(st - m_new[..., None])
        hi = p.bfloat16().float()
        terms = [hi, (p - hi).bfloat16().float()] if residual else [hi]
        pv = sum(torch.einsum('bhqk,bkhd->bhqd', t, vf[:, k0:k0 + block])
                 for t in terms)
        l, acc, m = l * alpha + p.sum(-1), acc * alpha[..., None] + pv, m_new
    return (acc / l[..., None]).permute(0, 2, 1, 3).to(q.dtype)


def test_bf16_probabilities_keep_their_residual():
    """The one numeric change of the bf16 tensor-core K5: P meets V in
    bf16.  Rounded once -- as the JAX package's plain attention rounds its
    probabilities -- P breaks the on-card rule |out - ref| <= 1e-3 +
    2^-7 |ref| against the f32-P plain version at rows with few keys; with
    its bf16 residual as a second term, as the kernel takes it, it keeps
    within the rule."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.tensor(rng.normal(size=(1, 256, h, 128)) * 0.5,
                            dtype=torch.bfloat16) for h in (8, 4, 4))
    want = flash_attention_ref(q, k, v).float()
    tol = 1e-3 + 2 ** -7 * want.abs()
    once = (_tiled_bf16_p(q, k, v, residual=False).float() - want).abs()
    assert (once > tol).any()
    assert ((once > tol).nonzero()[:, 1] < 16).all()     # the first rows
    both = (_tiled_bf16_p(q, k, v, residual=True).float() - want).abs()
    assert (both <= tol).all()
