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
    pg = pool_k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    qf = q.float()
    m, l, acc = state if state is not None else _empty_state(
        b, hkv, g, d, q.device)
    first = (start.long() if start is not None
             else torch.zeros(b, dtype=torch.long, device=q.device))
    lengths = lengths.long()
    pt = page_table.long()
    tok = torch.arange(pg, device=q.device)
    for ip in range(pt.shape[1]):
        k = pool_k[pt[:, ip]].float()                  # (B, pg, Hkv, D)
        v = pool_v[pt[:, ip]].float()
        s = torch.einsum('bhgd,bphd->bhgp', qf, k) * scale
        pos = (first + ip)[:, None] * pg + tok         # (B, pg)
        s = torch.where((pos < lengths[:, None])[:, None, None, :], s,
                        NEG_INF)
        m, l, acc = online_softmax_update(
            s, v.permute(0, 2, 1, 3)[:, :, None], m, l, acc)
    return online_softmax_finalize(acc, l).to(q.dtype)


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
