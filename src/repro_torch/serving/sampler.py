"""Token sampling for the serving engine (unfused path)."""
from __future__ import annotations

import torch


def sample(logits, *, temperature: float = 0.0, generator=None,
           top_k: int = 0):
    """logits (B, V) -> tokens (B,) int32.

    temperature 0 -> greedy (first-occurrence argmax); otherwise softmax
    sampling (optionally top-k truncated) from ``generator``, a
    ``torch.Generator`` on the logits' device.  The reference draws with
    ``jax.random.categorical``; the two agree in distribution, not in bits.
    """
    if temperature <= 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    if generator is None:
        raise ValueError('temperature sampling needs a torch.Generator')
    logits = logits.float() / temperature
    if top_k > 0:
        kth = logits.topk(top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, float('-inf'), logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)
