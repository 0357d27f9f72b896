"""Shared model building blocks in PyTorch.

The weights of a model are an ``nn.ParameterDict`` (an ``nn.Module``) that
nests like the reference's param tree.  Each family builds a *template* --
the same nested structure with :class:`PSpec` leaves carrying shape and
init law -- from which :func:`init_from_template` draws real weights with
a ``torch.Generator`` under the reference's init law.  The two frameworks
draw different numbers from the same seed; parity tests feed the
reference's own weights through ``repro_torch.bridge``.

KV caches use the global paged layout only: per layer a pool
(P, page_size, Hkv, Dh) whose page 0 is the QUARANTINE page.  Writes update
the pool in place (``index_put_``), where the reference returns a new array.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

DEFAULT_DTYPE = torch.bfloat16
CHUNK = 512        # query rows / tokens per chunk of the chunked functions


@dataclass(frozen=True)
class PSpec:
    """Param template leaf: shape + init law."""
    shape: Tuple[int, ...]
    init: str = 'normal'       # 'normal' | 'zeros' | 'ones'
    scale: Optional[float] = None  # None -> 1/sqrt(fan_in) for 'normal'
    dtype: Any = DEFAULT_DTYPE


def _init_leaf(leaf: PSpec, gen: torch.Generator, device) -> torch.Tensor:
    if leaf.init == 'zeros':
        return torch.zeros(leaf.shape, dtype=leaf.dtype, device=device)
    if leaf.init == 'ones':
        return torch.ones(leaf.shape, dtype=leaf.dtype, device=device)
    fan_in = leaf.shape[-2] if len(leaf.shape) >= 2 else leaf.shape[-1]
    scale = leaf.scale if leaf.scale is not None else fan_in ** -0.5
    return (torch.randn(leaf.shape, generator=gen, dtype=torch.float32,
                        device=device) * scale).to(leaf.dtype)


def init_from_template(tmpl, gen: torch.Generator, device):
    """Draw a template's weights on ``device`` (the generator's device)."""
    def build(node):
        if isinstance(node, PSpec):
            return nn.Parameter(_init_leaf(node, gen, device),
                                requires_grad=False)
        return nn.ParameterDict({k: build(v) for k, v in node.items()})
    return build(tmpl)


def zeros_from_template(tmpl, device):
    """A dict of zero tensors (KV caches)."""
    return {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
            for k, v in tmpl.items()}


# ---------------------------------------------------------------------------
# Numerics
# ---------------------------------------------------------------------------

def rms_norm(x, w, eps: float = 1e-5):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def rope(x, positions, theta: float):
    """Rotate-half RoPE.  x: (..., S, H, Dh); positions: (..., S)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions.float()[..., None, None] * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def swiglu(x, wg, wu, wd):
    g = x @ wg
    u = x @ wu
    return (F.silu(g.float()).to(x.dtype) * u) @ wd


def attention(q, k, v, *, q_positions, kv_positions, kv_valid=None,
              causal: bool = True, scale: Optional[float] = None):
    """Plain GQA attention.  q: (B, Sq, Hq, Dh); k/v: (B, Skv, Hkv, Dh).

    Scores, softmax and the product with V all in f32 over K/V as stored;
    the output is rounded to the query dtype.  These are the numerics of
    the port's attention kernels, so the engine's plain and kernel decode
    paths differ only in summation order.  (The reference rounds the
    probabilities to the value dtype before the product; with f32 caches,
    as in the parity tests, the two agree.)
    """
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    scale = scale if scale is not None else dh ** -0.5
    qg = q.reshape(b, sq, hkv, hq // hkv, dh)
    scores = torch.einsum('bqhgd,bkhd->bhgqk', qg.float(), k.float()) * scale
    mask = torch.ones((b, 1, 1, sq, k.shape[1]), dtype=torch.bool,
                      device=q.device)
    if causal:
        mask = mask & (q_positions[:, None, None, :, None]
                       >= kv_positions[:, None, None, None, :])
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, None, None, :]
    probs = torch.softmax(torch.where(mask, scores, -1e30), dim=-1)
    out = torch.einsum('bhgqk,bkhd->bqhgd', probs, v.float())
    return out.reshape(b, sq, hq, dh).to(q.dtype)


def chunked_attention(q, k, v, *, q_positions, kv_positions, kv_valid=None,
                      causal: bool = True):
    """:func:`attention` over query chunks of ``CHUNK`` rows, so the scores
    are never (Sq x Skv) at once.  Sq must be a multiple of ``CHUNK`` when
    it is longer."""
    sq = q.shape[1]
    if sq <= CHUNK:
        return attention(q, k, v, q_positions=q_positions,
                         kv_positions=kv_positions, kv_valid=kv_valid,
                         causal=causal)
    assert sq % CHUNK == 0, (sq, CHUNK)
    return torch.cat([
        attention(q[:, i:i + CHUNK], k, v,
                  q_positions=q_positions[:, i:i + CHUNK],
                  kv_positions=kv_positions, kv_valid=kv_valid,
                  causal=causal)
        for i in range(0, sq, CHUNK)], dim=1)


def chunked_ce_loss(h, norm_w, head, labels, *, mask=None, eps: float = 1e-5):
    """Final norm -> unembed -> cross-entropy over about ``CHUNK``-token
    sequence chunks (S // CHUNK of them, at least one; S must split evenly),
    so the (B, S, V) logits never exist at once.  h: (B, S, D); head:
    (V, D) row-major; labels (B, S) int; mask (B, S) or None.  Logits are
    computed in the model dtype, then f32, as in the reference.  Returns
    (sum of masked NLL, sum of mask), f32 scalars."""
    b, s, _ = h.shape
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=h.device)
    n = max(s // CHUNK, 1)
    assert s % n == 0, (s, n)
    step = s // n
    nll = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, s, step):
        logits = (rms_norm(h[:, i:i + step], norm_w, eps) @ head.T).float()
        gold = logits.gather(-1, labels[:, i:i + step, None].long())[..., 0]
        m = mask[:, i:i + step].float()
        nll = nll + ((torch.logsumexp(logits, dim=-1) - gold) * m).sum()
        cnt = cnt + m.sum()
    return nll, cnt


# ---------------------------------------------------------------------------
# Paged KV-cache primitives (the substrate Valve's reclamation operates on).
# Remapping a victim handle = rewriting its page-table entries to 0, which is
# always mapped, so no access can ever fault (paper §5).
# ---------------------------------------------------------------------------

def paged_gather(pool, page_table):
    """pool (P, pg, Hkv, Dh), page_table (B, maxp) -> (B, maxp*pg, Hkv, Dh)."""
    b, maxp = page_table.shape
    return pool[page_table.long()].reshape(b, maxp * pool.shape[1],
                                           *pool.shape[2:])


def kv_write_prefill(pool, page_table, kv):
    """In-place write of a whole prefill's K or V, page by page.

    kv: (B, S, Hkv, Dh) with S % page == 0, cast to the pool's dtype;
    page_table (B, >= S // page) physical ids.  As the reference's
    ``mode='drop'`` scatter: an id in [-P, 0) counts from the end of the
    pool, and an id outside [-P, P) is dropped, not raised on.
    """
    b, s, hkv, dh = kv.shape
    n_pages, pg = pool.shape[:2]
    idx = page_table[:, :s // pg].reshape(-1).long()
    idx = torch.where(idx < 0, idx + n_pages, idx)
    keep = (idx >= 0) & (idx < n_pages)
    pool[idx[keep]] = kv.reshape(-1, pg, hkv, dh)[keep].to(pool.dtype)


def kv_write_tokens(pool, page_ids, offsets, kv):
    """In-place token-granular write.  page_ids/offsets: (B, C) physical page
    + in-page offset per token; kv: (B, C, Hkv, Dh), cast to the pool's
    dtype.  Padding tokens point at the quarantine page: overwriting it is
    harmless by design."""
    pool.index_put_((page_ids.reshape(-1).long(), offsets.reshape(-1).long()),
                    kv.reshape(-1, *kv.shape[2:]).to(pool.dtype))


def kv_write_token(pool, page_ids, offsets, kv):
    """In-place single-token write per row.  kv: (B, Hkv, Dh)."""
    pool.index_put_((page_ids.long(), offsets.long()), kv.to(pool.dtype))


def paged_attention_ref(q, pool_k, pool_v, page_table, lengths, *,
                        scale: Optional[float] = None):
    """Decode attention through the page table (gather + dense oracle).

    q: (B, Hq, Dh) -- one new token per request; lengths (B,) valid tokens.
    """
    b = q.shape[0]
    k = paged_gather(pool_k, page_table)       # (B, S_max, Hkv, Dh)
    v = paged_gather(pool_v, page_table)
    kv_pos = torch.arange(k.shape[1], device=q.device).expand(b, -1)
    valid = kv_pos < lengths.long()[:, None]
    out = attention(q[:, None], k, v, q_positions=lengths.long()[:, None],
                    kv_positions=kv_pos, kv_valid=valid, causal=False,
                    scale=scale)
    return out[:, 0]
