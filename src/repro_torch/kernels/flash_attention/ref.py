"""Plain PyTorch version of the flash-attention kernel: the port's plain
attention (``models.common.attention``) with positions counted from 0 in
both sequences, so causal masking is top-left aligned as in the kernel.
Scores, softmax and the product with V are f32; the output is rounded to
q's dtype.  The wrapper in ``ops.py`` takes it for CPU tensors only.
"""
from __future__ import annotations

import torch

from repro_torch.models import common as cm


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D), scores
    scaled by D^-0.5."""
    b, sq = q.shape[:2]
    skv = k.shape[1]
    q_pos = torch.arange(sq, device=q.device).expand(b, sq)
    kv_pos = torch.arange(skv, device=q.device).expand(b, skv)
    return cm.attention(q, k, v, q_positions=q_pos, kv_positions=kv_pos,
                        causal=causal)
