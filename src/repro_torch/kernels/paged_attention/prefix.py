"""Shared-prefix page-run structure for prefix-aware paged attention.

The memory plane's copy-on-write prefix sharing makes several requests'
page tables point at the *same* physical pages for their common prompt
prefix.  The stock page walk still reads each physical page once per
request; with B requests sharing a K-page prefix that is B x K page reads
for K pages of data.  The prefix-aware variant splits attention into two
online-softmax phases -- a batch-wide pass over the deduplicated shared
pages (each physical page read once), then a per-request pass over the
remaining tail -- and merges them through the associativity of the running
(m, l, acc) state.

:func:`build_shared_runs` is the host-side (numpy) builder that turns a
decode batch's page tables into the kernel inputs, a verbatim copy of the
reference's.  It works *only* from the page tables the batch already holds:
a slot is emitted only for a physical page that appears at the same logical
index in >= 2 rows -- the kernel-boundary form of the plane's sharing
invariant (a page lands in two tables only via fill-gated publication).

:func:`prefix_shared_ref` is the oracle: a joint softmax over the
concatenated shared + tail score blocks.  It is independent of the
two-phase split the kernels (and their plain versions in ``ref.py``) use.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.kernels.common import NEG_INF

QUARANTINE_PAGE = 0


def build_shared_runs(page_tables, lengths, page_size: int, *,
                      quarantine: int = QUARANTINE_PAGE,
                      max_slots: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Deduplicate shared leading page runs across a decode batch.

    page_tables: (B, maxp) physical page ids (``quarantine`` = padding);
    lengths: (B,) valid KV tokens per row (``positions + 1``).  Returns a
    dict of fixed-shape numpy arrays (``max_slots`` defaults to maxp, so
    the downstream dispatch compiles once):

    - ``pages`` (S,): deduped physical ids of shared pages (padding →
      quarantine, masked out everywhere);
    - ``pos`` (S,): the logical page index each slot sits at (a physical
      page has exactly one logical index — chain-keyed CoW);
    - ``mask`` (B, S) f32 0/1: row b attends shared slot s;
    - ``tail_pt`` (B, maxp): each row's page table with its shared run
      removed (shifted left, quarantine-padded);
    - ``start`` (B,): pages removed per row (= tail position offset);
    - ``n_slots`` int: live slots (0 → nothing shared, use the stock path).

    Only *fully-filled* pages dedup (``(j+1)·pg ≤ length`` for every
    participant) and a row's run must be a leading prefix — both hold by
    construction for CoW-attached prefixes, and are re-enforced here so a
    hand-built table cannot produce an unsound slot.
    """
    pts = np.asarray(page_tables)
    lengths = np.asarray(lengths)
    b, maxp = pts.shape
    s_cap = maxp if max_slots is None else max_slots
    n_full = lengths // page_size        # fully-filled pages per row

    # candidate: page occupied, fully filled, and shared with another row
    # that ALSO holds it fully filled at the same logical index (vectorized
    # pairwise equality per column — this builder runs on the per-step
    # decode hot path)
    valid = (pts != quarantine) & (np.arange(maxp)[None, :] < n_full[:, None])
    eq = pts[None, :, :] == pts[:, None, :]
    dup = (eq & valid[None, :, :]).sum(axis=1) >= 2
    cand = dup & valid

    # a row's shared run is its leading candidate streak
    n_share = np.where(cand.all(axis=1), maxp,
                       np.argmin(cand, axis=1)).astype(np.int32)

    # collect slots in logical-index order; on slot-budget overflow clamp
    # every run at the first index that no longer fits (rare: many distinct
    # share groups) — correctness is unaffected, those pages stay in tails
    slot_of: Dict[tuple, int] = {}
    for j in range(int(n_share.max()) if b else 0):
        new = []
        for i in range(b):
            key = (j, pts[i, j])
            if j < n_share[i] and key not in slot_of:
                slot_of[key] = len(slot_of)
                new.append(key)
        if len(slot_of) > s_cap:
            for key in new:
                del slot_of[key]
            n_share = np.minimum(n_share, j)
            break

    pages = np.full(s_cap, quarantine, np.int32)
    pos = np.zeros(s_cap, np.int32)
    mask = np.zeros((b, s_cap), np.float32)
    for (j, p), si in slot_of.items():
        pages[si], pos[si] = p, j
    for i in range(b):
        for j in range(int(n_share[i])):
            mask[i, slot_of[(j, pts[i, j])]] = 1.0

    tail_pt = np.full_like(pts, quarantine)
    for i in range(b):
        ns = int(n_share[i])
        tail_pt[i, :maxp - ns] = pts[i, ns:]

    return {'pages': pages, 'pos': pos, 'mask': mask, 'tail_pt': tail_pt,
            'start': n_share.astype(np.int32), 'n_slots': len(slot_of)}


def prefix_shared_ref(q, pool_k, pool_v, shared_pages, share_pos, share_mask,
                      tail_pt, start_pages, lengths, *,
                      scale: Optional[float] = None):
    """Oracle prefix-aware paged attention (joint softmax over the
    concatenated shared-run + tail score blocks), in f32.

    q: (B, Hq, D); pools: (P, pg, Hkv, D); the remaining args are the
    :func:`build_shared_runs` outputs (as tensors) plus lengths (B,).
    ``share_pos`` is unused, as in the reference: shared pages are fully
    filled, so their positions need no mask.  Matches
    ``models.common.paged_attention_ref`` on the original tables.
    """
    b, hq, d = q.shape
    pg, hkv = pool_k.shape[1], pool_k.shape[2]
    g = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    qf = q.reshape(b, hkv, g, d).float()

    # shared phase: ONE gather of the deduped pages for the whole batch
    ks = pool_k[shared_pages.long()].float()           # (S, pg, Hkv, D)
    vs = pool_v[shared_pages.long()].float()
    s_sh = torch.einsum('bkgd,spkd->bkgsp', qf, ks) * scale
    sh_ok = share_mask[:, None, None, :, None] > 0
    s_sh = torch.where(sh_ok, s_sh, NEG_INF).reshape(b, hkv, g, -1)

    # tail phase: per-request gather over the shifted tables
    kt = pool_k[tail_pt.long()].float()                # (B, T, pg, Hkv, D)
    vt = pool_v[tail_pt.long()].float()
    t = tail_pt.shape[1]
    ar_t = torch.arange(t, device=q.device)
    ar_p = torch.arange(pg, device=q.device)
    s_tl = torch.einsum('bkgd,btpkd->bkgtp', qf, kt) * scale
    tpos = ((start_pages.long()[:, None] + ar_t)[:, :, None] * pg
            + ar_p[None, None, :])                     # (B, T, pg)
    tl_ok = tpos < lengths.long()[:, None, None]
    s_tl = torch.where(tl_ok[:, None, None], s_tl, NEG_INF).reshape(
        b, hkv, g, -1)

    p = torch.softmax(torch.cat([s_sh, s_tl], dim=-1), dim=-1)
    ns = s_sh.shape[-1]
    p_sh = p[..., :ns].reshape(b, hkv, g, -1, pg)
    p_tl = p[..., ns:].reshape(b, hkv, g, t, pg)
    out = (torch.einsum('bkgsp,spkd->bkgd', p_sh, vs)
           + torch.einsum('bkgtp,btpkd->bkgd', p_tl, vt))
    return out.reshape(b, hq, d).to(q.dtype)
