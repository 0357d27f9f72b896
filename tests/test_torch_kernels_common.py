"""Port of the kernel toolkit against the JAX package: the counter hash bit
for bit, the Gumbel noise within float rounding, the online softmax."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import common as jkc
from repro_torch.kernels import common as tkc

EDGES = [0, 1, 2, 0xFFFF, 0x10000, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE,
         0xFFFFFFFF, 0x9E3779B9]


def test_hash_u32_bits_equal_the_reference():
    rng = np.random.default_rng(0)
    x = np.concatenate([np.array(EDGES, np.uint32),
                        rng.integers(0, 2**32, 20000, dtype=np.uint32)])
    want = np.asarray(jkc.hash_u32(jnp.asarray(x)))
    got = tkc.hash_u32(torch.from_numpy(x.astype(np.int64))).numpy()
    assert got.min() >= 0 and got.max() < 2**32
    np.testing.assert_array_equal(got.astype(np.uint32), want)


# An f32 ``log`` within LOG_ULPS ulp (an ulp of x is at most 2^-23 |x|):
# g = -log(e), e = -log(u), so the inner log's relative error reaches g as
# an absolute one and the outer log's as a relative one, and
# |g - truth| <= LOG_ULPS 2^-23 (1 + |g|).  Both frameworks' logs sit
# within 1.5 ulp-units of 2^-24 here; 4 ulp a log leaves room for another
# CPU's vector paths.
LOG_ULPS = 4


@pytest.mark.parametrize('seed', [0, 7, 0x7FFFFFFF, -3])
def test_gumbel_noise_matches_the_reference(seed):
    """Same counters, same noise: each framework's f32 double log is held
    to the float64 truth from the same f32 ``u`` (the hash bits are equal,
    ``test_hash_u32_bits_equal_the_reference``), so a failure names the side
    that drifts."""
    rows = np.arange(5, dtype=np.int32)[:, None]
    cols = np.arange(3000, dtype=np.int32)[None, :]
    want = np.asarray(jkc.gumbel_hash_noise(jnp.int32(seed), jnp.asarray(rows),
                                            jnp.asarray(cols)))
    got = tkc.gumbel_hash_noise(seed, torch.from_numpy(rows),
                                torch.from_numpy(cols)).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    h = tkc.hash_u32(torch.tensor(seed & 0xFFFFFFFF)
                     ^ tkc._mul_u32(torch.from_numpy(rows.astype(np.int64)),
                                    0x9E3779B9))
    bits = tkc.hash_u32(h ^ torch.from_numpy(cols.astype(np.int64))).numpy()
    # the frameworks' u: an exact product, then one f32 rounding of the sum
    u = ((bits >> 8).astype(np.float32) * np.float32(2.0 ** -24)
         + np.float32(2.0 ** -25))
    truth = -np.log(-np.log(u.astype(np.float64)))
    unit = LOG_ULPS * 2.0 ** -23 * (1.0 + np.abs(truth))
    port = float((np.abs(got - truth) / unit).max())
    ref = float((np.abs(want - truth) / unit).max())
    msg = (f'worst |g - truth| in units of {LOG_ULPS} ulp a log: port '
           f'{port:.3f}, reference {ref:.3f}')
    assert port <= 1.0 and ref <= 1.0, msg


def test_online_softmax_over_blocks_equals_softmax():
    """Folding score blocks through the online update and finalizing gives
    the one-shot softmax average, including a fully masked leading block
    (its garbage mass is rescaled away by the first real score)."""
    rng = np.random.default_rng(1)
    s = torch.tensor(rng.normal(size=(3, 24)), dtype=torch.float32)
    v = torch.tensor(rng.normal(size=(3, 24, 8)), dtype=torch.float32)
    s[:, :8] = tkc.NEG_INF
    m = torch.full((3,), tkc.NEG_INF)
    l = torch.zeros(3)
    acc = torch.zeros(3, 8)
    for lo in range(0, 24, 8):
        m, l, acc = tkc.online_softmax_update(s[:, lo:lo + 8],
                                              v[:, lo:lo + 8], m, l, acc)
    got = tkc.online_softmax_finalize(acc, l)
    want = torch.einsum('bk,bkd->bd', torch.softmax(s, -1), v)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    zero = tkc.online_softmax_finalize(torch.ones(2, 4), torch.zeros(2))
    assert torch.equal(zero, torch.ones(2, 4))     # l == 0 -> divide by 1


def test_ceil_div_round_up():
    assert tkc.ceil_div(17, 16) == 2 and tkc.ceil_div(16, 16) == 1
    assert tkc.round_up(17, 16) == 32 and tkc.round_up(0, 8) == 0


@pytest.mark.parametrize('size,multiple,value', [(5, 4, 0.0), (8, 4, 0.0),
                                                 (7, 8, 1.0)])
def test_pad_axis_to_matches_the_reference(size, multiple, value):
    x = np.random.default_rng(size).normal(size=(2, size, 3)).astype(
        np.float32)
    want = np.asarray(jkc.pad_axis_to(jnp.asarray(x), 1, multiple,
                                      value=value))
    t = torch.from_numpy(x)
    got = tkc.pad_axis_to(t, 1, multiple, value=value)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got is t) == (size % multiple == 0)   # aligned: no copy
