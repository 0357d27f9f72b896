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
    if temperature > 0.0:
        b, v = scores.shape
        rows = torch.arange(b, device=scores.device)[:, None]
        cols = torch.arange(v, device=scores.device)[None, :]
        scores = scores / temperature + gumbel_hash_noise(seed, rows, cols)
    return scores.argmax(dim=-1).to(torch.int32)
