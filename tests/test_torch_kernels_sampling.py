"""Fused unembed + sampling of the port against the JAX package's Pallas
kernel (interpret mode): token-exact, on all the reference's cases.

The port takes the head as (V, D) row-major; the reference's unembed is
(D, V), so the tests hand the port its transpose.  On the CPU the wrapper
takes the kernel's plain version; ``test_torch_cuda.py`` holds the CUDA
kernel to it on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sampling.kernel import unembed_sample_pallas
from repro.kernels.sampling.ref import unembed_sample_ref as j_ref
from repro_torch.kernels.sampling import ops as sops
from repro_torch.kernels.sampling.ops import fused_unembed_sample
from repro_torch.kernels.sampling.ref import (unembed_sample_ref,
                                              unembed_scores)

CASES = [
    # (B, D, V, block_v) of the reference's tests: ragged last tiles
    (1, 32, 257, 128),
    (4, 64, 1000, 256),
    (3, 48, 512, 512),
    (2, 64, 769, 128),
    (5, 32, 130, 64),
]


def _setup(case, seed=0):
    b, d, v, _ = case
    rng = np.random.default_rng(seed)
    last = rng.standard_normal((b, d)).astype(np.float32)
    unembed = (rng.standard_normal((d, v)) * 0.3).astype(np.float32)
    return last, unembed


def _pallas(last, unembed, block_v, seed=0, temperature=0.0):
    return np.asarray(unembed_sample_pallas(
        jnp.asarray(last), jnp.asarray(unembed),
        jnp.asarray([seed], jnp.int32), temperature=temperature,
        block_v=block_v, interpret=True))


def _port(last, unembed, seed=0, temperature=0.0):
    head = torch.from_numpy(np.ascontiguousarray(unembed.T))
    return fused_unembed_sample(torch.from_numpy(last), head, seed,
                                temperature=temperature).numpy()


@pytest.mark.parametrize('case', CASES)
def test_greedy_matches_pallas_and_argmax(case):
    last, unembed = _setup(case, seed=sum(case))
    got = _port(last, unembed)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, _pallas(last, unembed, case[3]))
    np.testing.assert_array_equal(got, np.asarray(j_ref(
        jnp.asarray(last), jnp.asarray(unembed))))


@pytest.mark.parametrize('case', CASES[:3])
@pytest.mark.parametrize('seed', [0, 17])
def test_temperature_matches_pallas(case, seed):
    """The same counter-hash Gumbel noise in both: exact at T > 0 too."""
    last, unembed = _setup(case, seed=3)
    got = _port(last, unembed, seed, temperature=0.8)
    np.testing.assert_array_equal(
        got, _pallas(last, unembed, case[3], seed, temperature=0.8))


def test_temperature_seed_actually_samples():
    last, unembed = _setup((8, 32, 257, 128), seed=5)
    draws = [_port(last, unembed, s, temperature=2.0) for s in range(12)]
    assert any(not np.array_equal(draws[0], d) for d in draws[1:])
    np.testing.assert_array_equal(draws[0],
                                  _port(last, unembed, 0, temperature=2.0))


def test_tie_break_is_first_occurrence_across_tiles():
    b, d, v, block_v = 2, 16, 300, 128
    last = np.ones((b, d), np.float32)
    w = np.zeros((d, v), np.float32)
    w[:, 40] = w[:, 200] = w[:, 299] = 1.0
    got = _port(last, w)
    np.testing.assert_array_equal(got, _pallas(last, w, block_v))
    assert got.tolist() == [40, 40]


def test_padding_vocab_never_wins():
    b, d, v = 2, 16, 130
    rng = np.random.default_rng(11)
    last = rng.standard_normal((b, d)).astype(np.float32)
    unembed = (-np.abs(rng.standard_normal((d, v))) - 5.0).astype(np.float32)
    got = _port(last, unembed)
    assert (got < v).all()
    np.testing.assert_array_equal(got, _pallas(last, unembed, 64))


def test_head_must_be_row_major_v_by_d():
    """A transposed view of the embedding table is refused: it would make
    the kernel read the head column-wise (or copy 311 MB per step)."""
    last, unembed = _setup(CASES[1])
    head = torch.from_numpy(unembed)             # (D, V) contiguous
    with pytest.raises(ValueError, match='row-major'):
        fused_unembed_sample(torch.from_numpy(last), head.T)
    with pytest.raises(ValueError, match=r'\(V, D\)'):
        fused_unembed_sample(torch.from_numpy(last), head)


def test_scores_are_f32_from_the_operands():
    """The port's one rounding choice: f32 scores of the model-dtype
    operands, for the fused kernel, its plain version and the unfused
    tail alike."""
    rng = np.random.default_rng(2)
    last = torch.tensor(rng.standard_normal((3, 64)), dtype=torch.bfloat16)
    head = torch.tensor(rng.standard_normal((500, 64)), dtype=torch.bfloat16)
    s = unembed_scores(last, head)
    assert s.dtype == torch.float32
    torch.testing.assert_close(s, last.float() @ head.float().T)
    np.testing.assert_array_equal(unembed_sample_ref(last, head).numpy(),
                                  s.argmax(-1).numpy())


@pytest.mark.parametrize('sms', [114, 132])      # H100 PCIe, H100 SXM
@pytest.mark.parametrize('vocab', [1, 63, 64, 65, 257, 8448, 8449, 92544,
                                   151936])
def test_plan_vocab_ranges_covers_every_row_once(vocab, sms):
    """The CUDA kernel's persistent CTAs: whole 64-row tiles each, at most
    one CTA a multiprocessor, none empty, every vocab row in exactly one
    range, in order."""
    rows = sops.plan_vocab_ranges(vocab, sms)
    n_ctas = -(-vocab // rows)
    assert rows % sops.TILE_ROWS == 0 and n_ctas <= sms
    ranges = [range(c * rows, min((c + 1) * rows, vocab))
              for c in range(n_ctas)]
    assert all(len(r) > 0 for r in ranges)
    assert [v for r in ranges for v in r] == list(range(vocab))
