"""The engine's unfused sampler: greedy exactly equal to the reference's,
temperature sampling equal in distribution (torch's generator cannot
replay ``jax.random``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving.sampler import sample as j_sample
from repro_torch.serving.sampler import sample

N_DRAWS = 20000


def test_greedy_equals_reference():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((6, 300)).astype(np.float32)
    logits[2, [7, 250]] = 9.0                   # tie: first occurrence
    got = sample(torch.from_numpy(logits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_sample(jnp.asarray(logits))))
    assert int(got[2]) == 7


@pytest.mark.parametrize('top_k', [0, 3])
def test_temperature_matches_reference_in_distribution(top_k):
    """Both samplers' empirical token frequencies over 20000 draws agree
    with softmax(logits / T) (top-k renormalized) within 0.015, about five
    standard errors of a frequency near 0.3."""
    logits = np.array([2.0, 1.5, 1.0, 0.2, -1.0, 0.9], np.float32)
    t = 0.7
    p = np.exp(logits / t)
    if top_k:
        p[np.argsort(-logits)[top_k:]] = 0.0
    p /= p.sum()
    gen = torch.Generator().manual_seed(0)
    rows = torch.from_numpy(np.tile(logits, (N_DRAWS, 1)))
    got = sample(rows, temperature=t, generator=gen, top_k=top_k).numpy()
    want = np.asarray(j_sample(jnp.asarray(np.tile(logits, (N_DRAWS, 1))),
                               temperature=t, key=jax.random.PRNGKey(0),
                               top_k=top_k))
    for draws in (got, want):
        freq = np.bincount(draws, minlength=len(logits)) / N_DRAWS
        np.testing.assert_allclose(freq, p, rtol=0, atol=0.015)
    if top_k:
        assert set(np.unique(got)) <= set(np.argsort(-logits)[:top_k])


def test_temperature_needs_a_generator():
    with pytest.raises(ValueError, match='Generator'):
        sample(torch.zeros(2, 5), temperature=1.0)
