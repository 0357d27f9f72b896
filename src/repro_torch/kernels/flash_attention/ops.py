"""Wrapper of the flash-attention kernels (K5).

:func:`flash_attention` takes the model layout q (B, Sq, Hq, D), k/v
(B, Skv, Hkv, D) -- the kernels read it as is, no transposed copy -- checks
its tensors, takes the plain version (``ref.py``) for CPU tensors only, and
on a CUDA tensor launches a kernel or raises.  :func:`kernel_route` picks
the kernel, in this one place, by dtype and head dim:

- ``'sm90'``: bf16 at D in {64, 128} (the prefill path), the tensor-core
  kernel ``csrc/flash_attention_sm90.cu`` (wgmma, TMA; 128 query rows x
  128 keys a tile);
- ``'fma'``: f32 at any supported D, and bf16 at D=32, the f32-FMA kernel
  ``csrc/flash_attention.cu`` (64 x 64 tiles).  f32 is the parity dtype,
  held to 2e-5, which TF32 tensor cores cannot keep.

There is no fallback between them: a call launches its route's kernel or
raises.  Both count as one ``flash_attention`` launch.
"""
from __future__ import annotations

import ctypes
import torch

from repro_torch.kernels import common as kc
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

HEAD_DIMS = (32, 64, 128)           # the kernels' compiled head dims
SM90_HEAD_DIMS = (64, 128)          # those of the tensor-core kernel
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = (_P,) * 4 + (_I,) * 8 + (_F, _P)
_SM90_ARGS = (_P,) * 4 + (_I,) * 7 + (_F, _P)


def kernel_route(dtype, d: int) -> str:
    """``'sm90'`` (bf16 at D in :data:`SM90_HEAD_DIMS`) or ``'fma'``."""
    return 'sm90' if dtype == torch.bfloat16 and d in SM90_HEAD_DIMS \
        else 'fma'


def flash_attention(q, k, v, *, causal: bool = True):
    """Causal (top-left aligned, positions from 0 in both sequences) or
    non-causal GQA attention forward, scores scaled by D^-0.5; kv head of
    query head h is ``h // (Hq // Hkv)``.  q, k, v: one dtype, f32 or bf16;
    f32 scores and softmax (bf16 at D in {64, 128}: probabilities reach V
    as two bf16 terms, see ``csrc/flash_attention_sm90.cu``); output
    (B, Sq, Hq, D) in q's dtype."""
    kc.refuse_grad('flash_attention', q, k, v)
    if kc.on_cpu(q):
        return flash_attention_ref(q, k, v, causal=causal)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'q: dtype {q.dtype}, expected float32 or bfloat16')
    if d not in HEAD_DIMS:
        raise ValueError(f'head dim {d}: the kernel takes {HEAD_DIMS}')
    if hkv == 0 or hq % hkv:
        raise ValueError(f'{hq} query heads over {hkv} kv heads')
    if skv == 0:
        raise ValueError('no keys')
    kc.require(q, 'q', q.dtype, (b, sq, hq, d), q.device)
    kc.require(k, 'k', q.dtype, (b, skv, hkv, d), q.device)
    kc.require(v, 'v', q.dtype, (b, skv, hkv, d), q.device)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError('q, k, v must be 16-byte aligned')
    out = torch.empty_like(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    with torch.cuda.device(q.device):
        if kernel_route(q.dtype, d) == 'sm90':
            err = kc.kernel_fn('valve_flash_attention_sm90', _SM90_ARGS)(
                *ptrs, b, sq, skv, hq, hkv, d, int(causal), d ** -0.5,
                kc.stream_ptr(q))
        else:
            err = kc.kernel_fn('valve_flash_attention', _ARGS)(
                *ptrs, b, sq, skv, hq, hkv, d, int(q.dtype == torch.bfloat16),
                int(causal), d ** -0.5, kc.stream_ptr(q))
    kc.check_launch(err, 'flash_attention')
    kc.LAUNCHES['flash_attention'] += 1
    return out
