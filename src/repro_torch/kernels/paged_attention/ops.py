"""Wrappers of the paged-attention kernels: model layout (B, Hq, D) <->
kernel layout (B, Hkv, G, D), input checks, launch counters.

Kernel-level wrappers (one launch counter each, see ``kernels.common``):

- :func:`paged_decode` (K1): one new token per row attends its pages;
- :func:`shared_run` (K2): phase 1 of the prefix-shared read, each shared
  page read once per batch, emits the partial (m, l, acc);
- :func:`shared_tail` (K3): phase 2, the page walk over each row's tail,
  resumed from phase 1's state.  Same CUDA kernels as K1.

K1 and K3 split each row's page walk over CTAs (:func:`plan_splits`), K2
the shared run's slots past 128 tokens (:func:`plan_shared_splits`); each
merges its splits' partial states in a combine pass, and one call launches
both and counts one launch.

Each takes its plain version (``ref.py``) for CPU tensors only; on a CUDA
tensor it launches its kernel or raises.  The model-level entry points
:func:`paged_attention_decode` and :func:`paged_attention_prefix_shared`
are what ``models/dense.py`` calls.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import common as kc
from repro_torch.kernels.paged_attention.ref import (paged_decode_ref,
                                                     shared_run_ref)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_PAGED_DECODE_ARGS = (_P,) * 13 + (_I,) * 9 + (_F, _P)
_SHARED_RUN_ARGS = (_P,) * 11 + (_I,) * 9 + (_F, _P)
BF16, I32, F32 = torch.bfloat16, torch.int32, torch.float32

SPLIT_TOKENS = 128        # most tokens one split holds (paged_attention.cu)
CTAS_PER_SM = 4           # the splits aim at about four CTAs an SM
MAX_HEAD_DIM = 256
WALK_THREADS = 128        # threads of a page-walk CTA (paged_attention.cu)
RUN_THREADS = 512         # threads of a shared-run CTA (paged_attention.cu)


def plan_splits(batch: int, hkv: int, maxp: int, page_size: int, sms: int):
    """(pages per split, number of splits) of the K1/K3 page walk.

    From host-known shapes only -- the lengths live on the device and are
    never read back.  A table of at most :data:`SPLIT_TOKENS` tokens is one
    split, walked in the plain version's f32 order: splitting it moves the
    time by under a microsecond either way on an H100 (``chip_smoke.py``
    phase 3) but changes the decode numerics that phase 4 witnesses.  A
    longer one gets enough splits that ``batch * hkv * n_splits`` reaches
    about :data:`CTAS_PER_SM` on each of the card's ``sms`` multiprocessors
    (:func:`kernels.common.sm_count`), each no longer than
    :data:`SPLIT_TOKENS` tokens, so all of a split's pages load into shared
    memory up front.  Split ``s`` covers table columns ``[s * pps, (s + 1)
    * pps)``; together the splits cover all ``maxp`` columns exactly once."""
    if page_size > SPLIT_TOKENS:
        raise ValueError(f'page size {page_size}: a split holds at most '
                         f'{SPLIT_TOKENS} tokens')
    if maxp * page_size <= SPLIT_TOKENS:
        return max(1, maxp), 1
    cap = SPLIT_TOKENS // page_size
    want = kc.ceil_div(CTAS_PER_SM * sms, max(1, batch * hkv))
    n_splits = min(maxp, max(want, kc.ceil_div(maxp, cap)))
    pps = kc.ceil_div(maxp, n_splits)
    return pps, kc.ceil_div(maxp, pps)


def plan_shared_splits(hkv: int, n_slots: int, page_size: int, sms: int):
    """(slots per split, number of splits) of the K2 shared run.

    From host-known shapes only, as :func:`plan_splits`.  A run of at most
    :data:`SPLIT_TOKENS` tokens -- every shared run of the engine drains and
    of ``chip_smoke.py`` phase 3 at page 16 (up to 8 slots) -- is one CTA
    per kv-head, walked in the plain version's serial f32 order, which
    phase 4 witnesses.  A longer one gets enough splits that ``hkv *
    n_splits`` reaches about :data:`CTAS_PER_SM` on each of the ``sms``
    multiprocessors, each no longer than
    :data:`SPLIT_TOKENS` tokens; the combine pass merges them in split
    order.  Split ``s`` covers slots ``[s * sps, (s + 1) * sps)``; together
    the splits cover all ``n_slots`` slots exactly once."""
    if page_size > SPLIT_TOKENS:
        raise ValueError(f'page size {page_size}: a split holds at most '
                         f'{SPLIT_TOKENS} tokens')
    if n_slots * page_size <= SPLIT_TOKENS:
        return max(1, n_slots), 1
    want = kc.ceil_div(CTAS_PER_SM * sms, max(1, hkv))
    n_splits = min(n_slots, max(want, kc.ceil_div(n_slots,
                                                  SPLIT_TOKENS // page_size)))
    sps = kc.ceil_div(n_slots, n_splits)
    return sps, kc.ceil_div(n_slots, sps)


def _check_pools(q, pool_k, pool_v):
    b, hkv, g, d = q.shape
    n_pages, pg = pool_k.shape[:2]
    if d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f'head dim {d} must be a multiple of 8, at most '
                         f'{MAX_HEAD_DIM}')
    kc.require(q, 'q', BF16, (b, hkv, g, d), q.device)
    kc.require(pool_k, 'pool_k', BF16, (n_pages, pg, hkv, d), q.device)
    kc.require(pool_v, 'pool_v', BF16, (n_pages, pg, hkv, d), q.device)
    return b, hkv, g, d, n_pages, pg


def _launch_page_walk(q, pool_k, pool_v, page_table, lengths, start, state,
                      scale, name):
    b, hkv, g, d, n_pages, pg = _check_pools(q, pool_k, pool_v)
    if WALK_THREADS % (d // 8):
        raise ValueError(f'head dim {d}: the page walk takes D / 8 '
                         f'dividing {WALK_THREADS}')
    maxp = page_table.shape[1]
    kc.require(page_table, 'page_table', I32, (b, maxp), q.device)
    kc.require(lengths, 'lengths', I32, (b,), q.device)
    m0 = l0 = acc0 = None
    if start is not None:
        kc.require(start, 'start', I32, (b,), q.device)
        m0, l0, acc0 = state
        kc.require(m0, 'm0', F32, (b, hkv, g), q.device)
        kc.require(l0, 'l0', F32, (b, hkv, g), q.device)
        kc.require(acc0, 'acc0', F32, (b, hkv, g, d), q.device)
    if any(t.data_ptr() % 16 for t in (q, pool_k, pool_v)):
        raise ValueError('q and the pools must be 16-byte aligned')
    pps, n_splits = plan_splits(b, hkv, maxp, pg, kc.sm_count(q.device))
    out = torch.empty_like(q)
    m_part = l_part = acc_part = None
    if n_splits > 1:                      # the splits' partial states
        m_part = torch.empty((n_splits, b, hkv, g), dtype=F32, device=q.device)
        l_part = torch.empty_like(m_part)
        acc_part = torch.empty((n_splits, b, hkv, g, d), dtype=F32,
                               device=q.device)
    with torch.cuda.device(q.device):
        err = kc.kernel_fn('valve_paged_decode', _PAGED_DECODE_ARGS)(
            q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
            page_table.data_ptr(), kc.ptr(start), lengths.data_ptr(),
            kc.ptr(m0), kc.ptr(l0), kc.ptr(acc0), out.data_ptr(),
            kc.ptr(m_part), kc.ptr(l_part), kc.ptr(acc_part),
            b, hkv, g, d, n_pages, pg, maxp, pps, n_splits, scale,
            kc.stream_ptr(q))
    kc.check_launch(err, name)
    kc.LAUNCHES[name] += 1
    return out


def paged_decode(q, pool_k, pool_v, page_table, lengths, *,
                 scale: Optional[float] = None):
    """K1.  q (B, Hkv, G, D) bf16; pools (P, pg, Hkv, D) bf16; page_table
    (B, maxp) int32; lengths (B,) int32 (>= 1) -> (B, Hkv, G, D)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if kc.on_cpu(q):
        return paged_decode_ref(q, pool_k, pool_v, page_table, lengths,
                                scale=scale)
    return _launch_page_walk(q, pool_k, pool_v, page_table, lengths, None,
                             None, scale, 'paged_decode')


def shared_tail(q, pool_k, pool_v, tail_pt, start, lengths, state, *,
                scale: Optional[float] = None):
    """K3.  The page walk over ``tail_pt`` with positions offset by
    ``start`` (B,) int32 pages, resumed from ``state`` = (m, l, acc)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if kc.on_cpu(q):
        return paged_decode_ref(q, pool_k, pool_v, tail_pt, lengths,
                                start=start, state=state, scale=scale)
    return _launch_page_walk(q, pool_k, pool_v, tail_pt, lengths, start,
                             state, scale, 'shared_tail')


def shared_run(q, pool_k, pool_v, pages, mask, *,
               scale: Optional[float] = None):
    """K2.  pages (S,) int32, mask (B, S) f32 -> partial state
    m, l (B, Hkv, G) and acc (B, Hkv, G, D), f32.  The slots split over
    CTAs by :func:`plan_shared_splits`."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if kc.on_cpu(q):
        return shared_run_ref(q, pool_k, pool_v, pages, mask, scale=scale)
    b, hkv, g, d, n_pages, pg = _check_pools(q, pool_k, pool_v)
    if RUN_THREADS % (d // 8):
        raise ValueError(f'head dim {d}: the shared run takes D / 8 '
                         f'dividing {RUN_THREADS}')
    n_slots = pages.shape[0]
    kc.require(pages, 'pages', I32, (n_slots,), q.device)
    kc.require(mask, 'mask', F32, (b, n_slots), q.device)
    if any(t.data_ptr() % 16 for t in (q, pool_k, pool_v)):
        raise ValueError('q and the pools must be 16-byte aligned')
    sps, n_splits = plan_shared_splits(hkv, n_slots, pg,
                                       kc.sm_count(q.device))
    m = torch.empty((b, hkv, g), dtype=F32, device=q.device)
    l = torch.empty_like(m)
    acc = torch.empty((b, hkv, g, d), dtype=F32, device=q.device)
    m_part = l_part = acc_part = None
    if n_splits > 1:                      # the splits' partial states
        m_part = torch.empty((n_splits, b, hkv, g), dtype=F32,
                             device=q.device)
        l_part = torch.empty_like(m_part)
        acc_part = torch.empty((n_splits, b, hkv, g, d), dtype=F32,
                               device=q.device)
    with torch.cuda.device(q.device):
        err = kc.kernel_fn('valve_shared_run', _SHARED_RUN_ARGS)(
            q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
            pages.data_ptr(), mask.data_ptr(), m.data_ptr(), l.data_ptr(),
            acc.data_ptr(), kc.ptr(m_part), kc.ptr(l_part), kc.ptr(acc_part),
            b, hkv, g, d, n_pages, pg, n_slots, sps, n_splits, scale,
            kc.stream_ptr(q))
    kc.check_launch(err, 'shared_run')
    kc.LAUNCHES['shared_run'] += 1
    return m, l, acc


# ---------------------------------------------------------------------------
# Model-layout entry points
# ---------------------------------------------------------------------------

def _group(q, pool_k):
    b, hq, d = q.shape
    hkv = pool_k.shape[2]
    if hq % hkv:
        raise ValueError(f'{hq} query heads over {hkv} kv heads')
    return q.reshape(b, hkv, hq // hkv, d)


def paged_attention_decode(q, pool_k, pool_v, page_table, lengths, *,
                           scale: Optional[float] = None):
    """Single-token decode attention through the page table -- the serving
    hot path.  q: (B, Hq, D); pools: (P, pg, Hkv, D) global paged layout;
    page_table (B, maxp); lengths (B,) context length *including* the token
    being decoded.  Matches ``models.common.paged_attention_ref``."""
    out = paged_decode(_group(q, pool_k), pool_k, pool_v,
                       page_table.to(torch.int32), lengths.to(torch.int32),
                       scale=scale)
    return out.reshape(q.shape)


def paged_attention_prefix_shared(q, pool_k, pool_v, shared_pages, share_pos,
                                  share_mask, tail_pt, start_pages, lengths,
                                  *, scale: Optional[float] = None):
    """Prefix-shared decode attention: phase 1 (:func:`shared_run`) reads
    each deduplicated shared page once per batch, phase 2
    (:func:`shared_tail`) walks each row's tail from phase 1's state.  Args
    are ``prefix.build_shared_runs``' outputs as tensors; ``share_pos`` is
    unused, as in the reference.  Output matches
    :func:`paged_attention_decode` on the original tables."""
    qg = _group(q, pool_k)
    state = shared_run(qg, pool_k, pool_v, shared_pages.to(torch.int32),
                       share_mask.to(torch.float32), scale=scale)
    out = shared_tail(qg, pool_k, pool_v, tail_pt.to(torch.int32),
                      start_pages.to(torch.int32), lengths.to(torch.int32),
                      state, scale=scale)
    return out.reshape(q.shape)
