"""Wrappers of the fused unembed + sampling kernel (K4).

:func:`fused_unembed_sample` (the whole head -> tokens) and
:func:`unembed_argmax_block` (a block of the head -> each row's best
value and global column, for a vocabulary split over ranks) check their
tensors, take the plain versions (``ref.py``) for CPU tensors only, and on
a CUDA tensor launch the kernel (a persistent tensor-core pass over
:func:`plan_vocab_ranges`' vocab ranges, then the argmax reduction) or
raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common as kc
from repro_torch.kernels.sampling.ref import (unembed_argmax_block_ref,
                                              unembed_sample_ref)

TILE_ROWS = 64          # vocab rows of one tensor-core tile (sampling.cu)
MAX_BATCH = 16          # rows one launch takes (wgmma N <= 16)
# sampling.cu's shared memory: its dynamic budget (kSmemBudget), a swizzled
# 128-byte row of 64 bf16 (kRowBytes), a head box of 64 such rows with its
# two barriers
SMEM_BUDGET, ROW_BYTES, BOX_BYTES = 227 * 1024 - 1024, 128, 64 * 128 + 16
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = (_P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _P, _P, _P, _P, _P)


def max_head_dim(rows: int) -> int:
    """The widest D one launch of ``rows`` batch rows takes: the kernel
    keeps ``last`` whole in shared memory, ceil(D / 64) slices of N
    swizzled rows (N = 8 for up to 8 rows, else 16), beside a ring of at
    least two head boxes (sampling.cu's ``launch``)."""
    n = 8 if rows <= 8 else MAX_BATCH
    room = SMEM_BUDGET - 1024 - 8 - 2 * BOX_BYTES
    return 64 * (room // (n * ROW_BYTES))


def launch_rows(d: int) -> int:
    """Batch rows a launch takes at width ``d``: :data:`MAX_BATCH`, or 8
    where 16 rows of ``last`` leave no room for the head ring."""
    return MAX_BATCH if d <= max_head_dim(MAX_BATCH) else 8


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
    _check(last, head)
    if kc.on_cpu(last):
        return unembed_sample_ref(last, head, int(seed),
                                  temperature=temperature)
    return _launch(last, head, int(seed), temperature, 0, 0)[1]


def unembed_argmax_block(last, head, seed: int = 0, *,
                         temperature: float = 0.0, row0: int = 0,
                         col0: int = 0):
    """K4 over a block of the head: ``last`` (B, D) holds rows row0.. of
    the batch, ``head`` (Vb, D) columns col0.. of the whole head.  Returns
    each row's best ((B,) f32 value, (B,) int32 global column): the value
    is the score, at T > 0 the score / T plus the noise drawn at the
    global (row, column), so the best over blocks (ties to the lower
    column) is :func:`fused_unembed_sample` over the whole head."""
    _check(last, head)
    if kc.on_cpu(last):
        return unembed_argmax_block_ref(last, head, int(seed),
                                        temperature=temperature, row0=row0,
                                        col0=col0)
    return _launch(last, head, int(seed), temperature, int(row0), int(col0))


def _check(last, head) -> None:
    if head.dim() != 2 or last.dim() != 2 or head.shape[1] != last.shape[1]:
        raise ValueError(f'head {tuple(head.shape)} must be (V, D) for '
                         f'last {tuple(last.shape)}')
    if not head.is_contiguous():
        raise ValueError('head must be (V, D) row-major; pass the embedding '
                         'table itself, not a transposed view')


def _launch(last, head, seed: int, temperature: float, row0: int,
            col0: int):
    """The kernel over ``head``: ((B,) f32 best values, (B,) int32 best
    global columns)."""
    (b, d), v = last.shape, head.shape[0]
    step = launch_rows(d)
    if d % 8 or d > max_head_dim(min(b, step)):
        raise ValueError(f'kernel takes D % 8 == 0 (TMA rows of 16-byte '
                         f'multiples) and D <= {max_head_dim(8)} (`last` in '
                         f'shared memory), got D={d}')
    kc.require(last, 'last', torch.bfloat16, (b, d), last.device)
    kc.require(head, 'head', torch.bfloat16, (v, d), last.device)
    if last.data_ptr() % 16 or head.data_ptr() % 16:
        raise ValueError('last and head must be 16-byte aligned (TMA)')
    rows_per_cta = plan_vocab_ranges(v, kc.sm_count(last.device))
    n_ctas = kc.ceil_div(v, rows_per_cta)
    rows = min(b, step)
    part_val = torch.empty((n_ctas, rows), dtype=torch.float32,
                           device=last.device)
    part_idx = torch.empty((n_ctas, rows), dtype=torch.int32,
                           device=last.device)
    value = torch.empty((b,), dtype=torch.float32, device=last.device)
    index = torch.empty((b,), dtype=torch.int32, device=last.device)
    fn = kc.kernel_fn('valve_unembed_sample', _ARGS)
    # one launch takes `step` rows: one launch per block of rows, each
    # reading the whole head
    for r0 in range(0, b, step):
        n = min(step, b - r0)
        with torch.cuda.device(last.device):
            err = fn(last[r0].data_ptr(), head.data_ptr(), n, d, v,
                     rows_per_cta, float(temperature), seed, row0 + r0,
                     col0, part_val.data_ptr(), part_idx.data_ptr(),
                     value[r0].data_ptr(), index[r0].data_ptr(),
                     kc.stream_ptr(last))
        kc.check_launch(err, 'unembed_sample')
        kc.LAUNCHES['unembed_sample'] += 1
    return value, index
