"""Wrapper of the flash-attention kernel (K5).

:func:`flash_attention` takes the model layout q (B, Sq, Hq, D), k/v
(B, Skv, Hkv, D) -- the kernel reads it as is, no transposed copy -- checks
its tensors, takes the plain version (``ref.py``) for CPU tensors only, and
on a CUDA tensor launches the kernel or raises.  The kernel's tiles are
fixed (64 query rows x 64 keys); it takes no block sizes.
"""
from __future__ import annotations

import ctypes
import torch

from repro_torch.kernels import common as kc
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

HEAD_DIMS = (32, 64, 128)           # the kernel's compiled head dims
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = (_P,) * 4 + (_I,) * 8 + (_F, _P)


def flash_attention(q, k, v, *, causal: bool = True):
    """Causal (top-left aligned, positions from 0 in both sequences) or
    non-causal GQA attention forward, scores scaled by D^-0.5; kv head of
    query head h is ``h // (Hq // Hkv)``.  q, k, v: one dtype, f32 or bf16;
    f32 scores and softmax; output (B, Sq, Hq, D) in q's dtype."""
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
    with torch.cuda.device(q.device):
        err = kc.kernel_fn('valve_flash_attention', _ARGS)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
            skv, hq, hkv, d, int(q.dtype == torch.bfloat16), int(causal),
            d ** -0.5, kc.stream_ptr(q))
    kc.check_launch(err, 'flash_attention')
    kc.LAUNCHES['flash_attention'] += 1
    return out
