"""Wrapper of the fused unembed + sampling kernel (K4).

:func:`fused_unembed_sample` checks its tensors, takes the plain version
(``ref.py``) for CPU tensors only, and on a CUDA tensor launches the
kernel (a persistent tensor-core pass over :func:`plan_vocab_ranges`'
vocab ranges, then the argmax reduction) or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common as kc
from repro_torch.kernels.sampling.ref import unembed_sample_ref

TILE_ROWS = 64          # vocab rows of one tensor-core tile (sampling.cu)
MAX_BATCH = 16          # rows one launch takes (wgmma N <= 16)
MAX_HEAD_DIM = 4096     # `last` stays in shared memory beside the head ring
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = (_P, _P, _I, _I, _I, _I, _F, _I, _I, _P, _P, _P, _P)


def plan_vocab_ranges(vocab: int, sms: int) -> int:
    """Vocab rows each CTA of the kernel walks: a whole number of
    :data:`TILE_ROWS`-row tiles, as even as that allows over at most
    ``sms`` CTAs, one on each of the card's multiprocessors
    (:func:`kernels.common.sm_count`).  CTA ``c`` takes rows ``[c * r,
    min((c + 1) * r, V))``; ``ceil(V / r)`` CTAs cover every row exactly
    once."""
    tiles = kc.ceil_div(vocab, TILE_ROWS)
    return TILE_ROWS * kc.ceil_div(tiles, sms)


def fused_unembed_sample(last, head, seed: int = 0, *,
                         temperature: float = 0.0):
    """Sample one token per row from ``softmax(last @ head^T / T)``.

    last: (B, D) final-norm hidden; head: (V, D) row-major (the embedding
    table for tied configs -- never a transposed view); seed: int (ignored
    at T = 0).  Returns (B,) int32.  Greedy is the first-occurrence argmax
    of the f32 scores; T > 0 is an exact categorical sample via the
    Gumbel-max trick with counter-hash noise.
    """
    if head.dim() != 2 or last.dim() != 2 or head.shape[1] != last.shape[1]:
        raise ValueError(f'head {tuple(head.shape)} must be (V, D) for '
                         f'last {tuple(last.shape)}')
    if not head.is_contiguous():
        raise ValueError('head must be (V, D) row-major; pass the embedding '
                         'table itself, not a transposed view')
    seed = int(seed)
    if kc.on_cpu(last):
        return unembed_sample_ref(last, head, seed, temperature=temperature)
    (b, d), v = last.shape, head.shape[0]
    if d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f'kernel takes D % 8 == 0 and D <= {MAX_HEAD_DIM} '
                         f'(TMA rows of 16-byte multiples), got D={d}')
    kc.require(last, 'last', torch.bfloat16, (b, d), last.device)
    kc.require(head, 'head', torch.bfloat16, (v, d), last.device)
    if last.data_ptr() % 16 or head.data_ptr() % 16:
        raise ValueError('last and head must be 16-byte aligned (TMA)')
    rows_per_cta = plan_vocab_ranges(v, kc.sm_count(last.device))
    n_ctas = kc.ceil_div(v, rows_per_cta)
    rows = min(b, MAX_BATCH)
    part_val = torch.empty((n_ctas, rows), dtype=torch.float32,
                           device=last.device)
    part_idx = torch.empty((n_ctas, rows), dtype=torch.int32,
                           device=last.device)
    out = torch.empty((b,), dtype=torch.int32, device=last.device)
    fn = kc.kernel_fn('valve_unembed_sample', _ARGS)
    # one launch takes MAX_BATCH rows: one launch per block of rows, each
    # reading the whole head
    for r0 in range(0, b, MAX_BATCH):
        n = min(MAX_BATCH, b - r0)
        with torch.cuda.device(last.device):
            err = fn(last[r0].data_ptr(), head.data_ptr(), n, d, v,
                     rows_per_cta, float(temperature), seed, r0,
                     part_val.data_ptr(), part_idx.data_ptr(),
                     out[r0].data_ptr(), kc.stream_ptr(last))
        kc.check_launch(err, 'unembed_sample')
        kc.LAUNCHES['unembed_sample'] += 1
    return out
