"""Plain PyTorch versions of the paged-attention kernels.

Each mirrors its CUDA kernel step for step -- the same page walk, the same
masking, the same f32 online-softmax update -- so the CPU tests exercise the
exact dataflow of the GPU path, and ``chip_smoke.py`` holds each kernel
against its plain version on identical inputs.  The wrappers in ``ops.py``
take them for CPU tensors only.

Layout: q (B, Hkv, G, D); pools (P, pg, Hkv, D), page 0 = quarantine.
Every row must have ``lengths[b] >= 1`` (the engine's padding rows attend
one quarantine slot).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.common import (NEG_INF, online_softmax_finalize,
                                        online_softmax_update)


def _empty_state(b, hkv, g, d, device):
    return (torch.full((b, hkv, g), NEG_INF, dtype=torch.float32,
                       device=device),
            torch.zeros((b, hkv, g), dtype=torch.float32, device=device),
            torch.zeros((b, hkv, g, d), dtype=torch.float32, device=device))


def _walk(qf, pool_k, pool_v, pt, first, lengths, cols, state, scale):
    """The f32 online-softmax walk over table columns ``cols`` of ``pt``
    (B, maxp), token positions offset by ``first`` (B,) pages, masking
    positions >= ``lengths`` (B,), from ``state`` = (m, l, acc)."""
    pg = pool_k.shape[1]
    m, l, acc = state
    tok = torch.arange(pg, device=qf.device)
    for ip in cols:
        k = pool_k[pt[:, ip]].float()                  # (B, pg, Hkv, D)
        v = pool_v[pt[:, ip]].float()
        s = torch.einsum('bhgd,bphd->bhgp', qf, k) * scale
        pos = (first + ip)[:, None] * pg + tok         # (B, pg)
        s = torch.where((pos < lengths[:, None])[:, None, None, :], s,
                        NEG_INF)
        m, l, acc = online_softmax_update(
            s, v.permute(0, 2, 1, 3)[:, :, None], m, l, acc)
    return m, l, acc


def _first_page(start, b, device):
    return (start.long() if start is not None
            else torch.zeros(b, dtype=torch.long, device=device))


def paged_decode_ref(q, pool_k, pool_v, page_table, lengths, *,
                     start=None, state=None, scale: Optional[float] = None):
    """Plain version of the page-walk kernel (K1; K3 with ``state``).

    Walks ``page_table`` (B, maxp) page by page, token positions offset by
    ``start`` (B,) pages, masking positions >= ``lengths`` (B,), starting
    from ``state`` = (m, l, acc) or the empty state.  The kernel stops at a
    row's last live page; the extra pages here are fully masked and add
    exactly nothing once a real score has been seen.
    """
    b, hkv, g, d = q.shape
    scale = d ** -0.5 if scale is None else scale
    if state is None:
        state = _empty_state(b, hkv, g, d, q.device)
    pt = page_table.long()
    m, l, acc = _walk(q.float(), pool_k, pool_v, pt,
                      _first_page(start, b, q.device), lengths.long(),
                      range(pt.shape[1]), state, scale)
    return online_softmax_finalize(acc, l).to(q.dtype)


def paged_decode_split_ref(q, pool_k, pool_v, page_table, lengths, *,
                           pages_per_split: int, start=None, state=None,
                           scale: Optional[float] = None):
    """Plain version of the split page walk (K1; K3 with ``state``), the
    algorithm of the CUDA kernels.  A page id outside ``[0, P)`` reads the
    quarantine page 0.  Split ``s`` walks table columns ``[s * pps, (s + 1)
    * pps)`` into a partial (m, l, acc): split 0 on from ``state`` (or the
    empty state), the others from the empty state.  A split that starts at
    or past the row's live pages keeps its initial state: ``state`` for
    split 0, else empty (l = 0).  The combine takes the non-empty partials
    to their common max M and sums l and acc, each term scaled by exp(m -
    M), in split order.  With one split (``pages_per_split >= maxp``) that
    is :func:`paged_decode_ref`'s walk bit for bit (every weight is exp(0));
    otherwise it equals it up to f32 summation order."""
    b, hkv, g, d = q.shape
    n_pages, pg = pool_k.shape[:2]
    maxp = page_table.shape[1]
    scale = d ** -0.5 if scale is None else scale
    qf = q.float()
    first = _first_page(start, b, q.device)
    lengths = lengths.long()
    pt = page_table.long()
    pt = torch.where((pt >= 0) & (pt < n_pages), pt, 0)
    empty = _empty_state(b, hkv, g, d, q.device)
    live = ((lengths + pg - 1) // pg - first).clamp(0, maxp)
    parts = []
    for p0 in range(0, max(maxp, 1), pages_per_split):
        init = state if p0 == 0 and state is not None else empty
        m_s, l_s, acc_s = _walk(qf, pool_k, pool_v, pt, first, lengths,
                                range(p0, min(p0 + pages_per_split, maxp)),
                                init, scale)
        keep = (p0 < live)[:, None, None]
        parts.append((torch.where(keep, m_s, init[0]),
                      torch.where(keep, l_s, init[1]),
                      torch.where(keep[..., None], acc_s, init[2])))
    _, l, acc = _combine(parts, empty)
    return online_softmax_finalize(acc, l).to(q.dtype)


def _combine(parts, empty):
    """The CUDA combine pass: the non-empty partials (l > 0) taken to their
    common max M, then l and acc summed in split order, each term scaled by
    exp(m - M).  Returns the merged state (M, l, acc)."""
    mx = torch.full_like(empty[0], NEG_INF)
    for m_s, l_s, _ in parts:
        mx = torch.where(l_s > 0, torch.maximum(mx, m_s), mx)
    l, acc = empty[1], empty[2]
    for m_s, l_s, acc_s in parts:
        w = torch.where(l_s > 0, torch.exp(m_s - mx), 0.0)
        l = l + l_s * w
        acc = acc + torch.where((w > 0)[..., None], acc_s * w[..., None], 0.0)
    return mx, l, acc


def shared_run_ref(q, pool_k, pool_v, pages, mask, *,
                   scale: Optional[float] = None):
    """Plain version of the shared-run kernel (K2, phase 1).

    pages (S,): deduplicated shared physical pages; mask (B, S) f32: row b
    attends slot s iff mask > 0.  Returns the partial f32 state
    m, l: (B, Hkv, G) and acc: (B, Hkv, G, D).  A row masked at every slot
    keeps m = NEG_INF (with garbage l/acc that the tail phase's first real
    score rescales away).
    """
    b, hkv, g, d = q.shape
    scale = d ** -0.5 if scale is None else scale
    qf = q.float()
    m, l, acc = _empty_state(b, hkv, g, d, q.device)
    ks = pool_k[pages.long()].float()                  # (S, pg, Hkv, D)
    vs = pool_v[pages.long()].float()
    for js in range(pages.shape[0]):
        s = torch.einsum('bhgd,phd->bhgp', qf, ks[js]) * scale
        s = torch.where((mask[:, js] > 0)[:, None, None, None], s, NEG_INF)
        m, l, acc = online_softmax_update(
            s, vs[js].permute(1, 0, 2)[None, :, None], m, l, acc)
    return m, l, acc


def shared_run_split_ref(q, pool_k, pool_v, pages, mask, *,
                         slots_per_split: int,
                         scale: Optional[float] = None):
    """Plain version of the split shared run (K2), the algorithm of the CUDA
    kernels.  A page id outside ``[0, P)`` reads the quarantine page 0.
    Split ``s`` walks slots ``[s * sps, (s + 1) * sps)`` from the empty
    state as :func:`shared_run_ref` walks them; the splits' partials merge
    as the split page walk's do.  Every partial has l > 0 (each slot adds
    ``pg`` probabilities, garbage ones at m = NEG_INF), so a split masked
    for a row weighs exp(NEG_INF - M) = 0 there, and a row masked at every
    slot keeps m = NEG_INF with its garbage mass.  With one split
    (``slots_per_split >= S``) this is :func:`shared_run_ref` bit for bit;
    otherwise it equals it up to f32 summation order."""
    b, hkv, g, d = q.shape
    n_pages, n_slots = pool_k.shape[0], pages.shape[0]
    pages = torch.where((pages >= 0) & (pages < n_pages), pages, 0)
    parts = [shared_run_ref(q, pool_k, pool_v, pages[s0:s0 + slots_per_split],
                            mask[:, s0:s0 + slots_per_split], scale=scale)
             for s0 in range(0, max(n_slots, 1), slots_per_split)]
    if len(parts) == 1:
        return parts[0]
    return _combine(parts, _empty_state(b, hkv, g, d, q.device))
