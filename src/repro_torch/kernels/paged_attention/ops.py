"""Wrappers of the paged-attention kernels: model layout (B, Hq, D) <->
kernel layout (B, Hkv, G, D), input checks, launch counters.

Kernel-level wrappers (one launch counter each, see ``kernels.common``):

- :func:`paged_decode` (K1): one new token per row attends its pages;
- :func:`shared_run` (K2): phase 1 of the prefix-shared read, each shared
  page read once per batch, emits the partial (m, l, acc);
- :func:`shared_tail` (K3): phase 2, the page walk over each row's tail,
  resumed from phase 1's state.  Same CUDA kernel as K1.

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
_PAGED_DECODE_ARGS = (_P,) * 10 + (_I,) * 7 + (_F, _P)
_SHARED_RUN_ARGS = (_P,) * 8 + (_I,) * 7 + (_F, _P)
BF16, I32, F32 = torch.bfloat16, torch.int32, torch.float32


def _check_pools(q, pool_k, pool_v):
    b, hkv, g, d = q.shape
    n_pages, pg = pool_k.shape[:2]
    if d % 8:
        raise ValueError(f'head dim {d} must be a multiple of 8')
    kc.require(q, 'q', BF16, (b, hkv, g, d), q.device)
    kc.require(pool_k, 'pool_k', BF16, (n_pages, pg, hkv, d), q.device)
    kc.require(pool_v, 'pool_v', BF16, (n_pages, pg, hkv, d), q.device)
    return b, hkv, g, d, n_pages, pg


def _launch_page_walk(q, pool_k, pool_v, page_table, lengths, start, state,
                      scale, name):
    b, hkv, g, d, n_pages, pg = _check_pools(q, pool_k, pool_v)
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
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = kc.kernel_fn('valve_paged_decode', _PAGED_DECODE_ARGS)(
            q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
            page_table.data_ptr(), kc.ptr(start), lengths.data_ptr(),
            kc.ptr(m0), kc.ptr(l0), kc.ptr(acc0), out.data_ptr(),
            b, hkv, g, d, n_pages, pg, maxp, scale, kc.stream_ptr(q))
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
    m, l (B, Hkv, G) and acc (B, Hkv, G, D), f32."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if kc.on_cpu(q):
        return shared_run_ref(q, pool_k, pool_v, pages, mask, scale=scale)
    b, hkv, g, d, n_pages, pg = _check_pools(q, pool_k, pool_v)
    n_slots = pages.shape[0]
    kc.require(pages, 'pages', I32, (n_slots,), q.device)
    kc.require(mask, 'mask', F32, (b, n_slots), q.device)
    m = torch.empty((b, hkv, g), dtype=F32, device=q.device)
    l = torch.empty_like(m)
    acc = torch.empty((b, hkv, g, d), dtype=F32, device=q.device)
    with torch.cuda.device(q.device):
        err = kc.kernel_fn('valve_shared_run', _SHARED_RUN_ARGS)(
            q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
            pages.data_ptr(), mask.data_ptr(), m.data_ptr(), l.data_ptr(),
            acc.data_ptr(), b, hkv, g, d, n_pages, pg, n_slots, scale,
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
