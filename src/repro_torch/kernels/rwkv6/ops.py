"""Wrapper of the WKV6 kernel (K6).

:func:`wkv6` takes the model layout r/k/w (B, T, H, K), v (B, T, H, V),
checks its tensors, takes the plain sequential recurrence (``ref.py``) for
CPU tensors only, and on a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common as kc
from repro_torch.kernels.rwkv6.ref import wkv6_ref

HEAD_DIMS = (16, 32, 64)            # the kernel's compiled K
MAX_SMEM = 227 * 1024               # a CTA's shared memory on the H100
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = (_P,) * 8 + (_I,) * 7 + (_P,)


def wkv6(r, k, v, w, u, state, *, chunk: int = 64):
    """r/k/w: (B, T, H, K); v: (B, T, H, V); u: (H, K), all one dtype (f32
    or bf16); state: (B, H, K, V) f32.  Returns y (B, T, H, V) in r's
    dtype and the final state, f32.  ``chunk`` is the number of tokens the
    kernel stages in shared memory at a time; the recurrence is serial, so
    the result does not depend on it (any chunk >= 1, also one > T)."""
    kc.refuse_grad('wkv6', r, k, v, w, u, state)
    if chunk < 1:
        raise ValueError(f'chunk {chunk} < 1')
    if kc.on_cpu(r):
        f32 = [x.float() for x in (r, k, v, w, u, state)]
        y, s = wkv6_ref(*f32)
        return y.to(r.dtype), s
    b, t, h, dk = r.shape
    dv = v.shape[-1]
    if r.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'r: dtype {r.dtype}, expected float32 or bfloat16')
    if dk not in HEAD_DIMS:
        raise ValueError(f'K = {dk}: the kernel takes {HEAD_DIMS}')
    if not 1 <= dv <= 1024:
        raise ValueError(f'V = {dv}: the kernel takes 1..1024')
    if 4 * chunk * (3 * dk + dv) > MAX_SMEM:
        raise ValueError(f'chunk {chunk} does not fit in shared memory')
    for name, x, shape in (('r', r, (b, t, h, dk)), ('k', k, (b, t, h, dk)),
                           ('v', v, (b, t, h, dv)), ('w', w, (b, t, h, dk)),
                           ('u', u, (h, dk))):
        kc.require(x, name, r.dtype, shape, r.device)
    kc.require(state, 'state', torch.float32, (b, h, dk, dv), r.device)
    y = torch.empty_like(v)
    state_out = torch.empty_like(state)
    with torch.cuda.device(r.device):
        err = kc.kernel_fn('valve_wkv6', _ARGS)(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), state.data_ptr(), y.data_ptr(),
            state_out.data_ptr(), b, t, h, dk, dv, chunk,
            int(r.dtype == torch.bfloat16), kc.stream_ptr(r))
    kc.check_launch(err, 'wkv6')
    kc.LAUNCHES['wkv6'] += 1
    return y, state_out
