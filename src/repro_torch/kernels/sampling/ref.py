"""Plain PyTorch version of the fused unembed + sampling kernel.

Rounding (one choice for the whole port): scores are f32 dot products of
the model-dtype operands -- what the TPU kernel computes -- not logits
rounded to the model dtype.  :func:`unembed_scores` is also the port's
unfused decode tail and prefill head (``models/dense.py``), so the fused
and unfused greedy paths argmax the same f32 scores.

The head is (V, D) row-major: for tied configs the embedding table itself,
so no transposed copy of it is ever made.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import gumbel_hash_noise


def unembed_scores(last, head):
    """last (B, D) @ head (V, D)^T -> (B, V) f32 scores."""
    return last.float() @ head.float().T


def unembed_sample_ref(last, head, seed: int = 0, *,
                       temperature: float = 0.0):
    """last (B, D); head (V, D) -> (B,) int32 sampled tokens.

    Greedy is the first-occurrence argmax of the f32 scores; T > 0 adds
    counter-hash Gumbel noise to ``scores / T`` (exact categorical sample).
    """
    return sample_scores(unembed_scores(last, head), seed,
                         temperature=temperature)


def sample_scores(scores, seed: int = 0, *, temperature: float = 0.0):
    """(B, V) f32 scores -> (B,) int32 tokens, as :func:`unembed_sample_ref`
    samples them."""
    return _perturbed_max(scores, seed, temperature, 0, 0)[1]


def unembed_argmax_block_ref(last, head, seed: int = 0, *,
                             temperature: float = 0.0, row0: int = 0,
                             col0: int = 0):
    """The sampler over a block of the head: last (B, D) holds rows row0..
    of the batch, head (Vb, D) columns col0.. of the whole head.  Returns
    each row's best (value, global column): (B,) f32 values -- the score,
    at T > 0 the score / T plus the noise drawn at the global (row,
    column) -- and (B,) int32 columns, the first occurrence.  Over blocks
    in column order, the best value with ties to the lower column is
    :func:`unembed_sample_ref` over the whole head."""
    return _perturbed_max(unembed_scores(last, head), seed, temperature,
                          row0, col0)


def combine_bests(values, indices):
    """(n, B) best values and global columns of n blocks of the head ->
    (B,) int32 columns of the best over the blocks: the larger value, ties
    to the lower column (the first occurrence, as over the whole head)."""
    best = values.amax(0)
    cand = torch.where(values == best, indices, torch.iinfo(indices.dtype).max)
    return cand.amin(0).to(torch.int32)


def _perturbed_max(scores, seed, temperature, row0, col0):
    if temperature > 0.0:
        b, v = scores.shape
        rows = torch.arange(row0, row0 + b, device=scores.device)[:, None]
        cols = torch.arange(col0, col0 + v, device=scores.device)[None, :]
        scores = scores / temperature + gumbel_hash_noise(seed, rows, cols)
    index = scores.argmax(dim=-1)
    value = scores.gather(1, index[:, None])[:, 0]
    return value, (index + col0).to(torch.int32)
