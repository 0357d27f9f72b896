"""Wrapper of the WKV6 kernel (K6).

:func:`wkv6` takes the model layout r/k/w (B, T, H, K), v (B, T, H, V),
checks its tensors, takes the kernel's plain version
(``ref.wkv6_tiled_ref``) for CPU tensors only, and on a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common as kc
from repro_torch.kernels.rwkv6.ref import wkv6_tiled_ref

HEAD_DIMS = (16, 32, 64)            # the kernel's compiled K
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = (_P,) * 8 + (_I,) * 6 + (_P,)


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x``, or a copy of it that starts on 16 bytes (TMA)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def wkv6(r, k, v, w, u, state, *, chunk: int = 64):
    """r/k/w: (B, T, H, K); v: (B, T, H, V); u: (H, K), all one dtype (f32
    or bf16); state: (B, H, K, V) f32.  Returns y (B, T, H, V) in r's
    dtype and the final state, f32.  ``chunk`` is the reference's chunk
    length; the kernel takes its own token tile (``ref.TILE``) and any
    chunk >= 1 gives the same result."""
    kc.refuse_grad('wkv6', r, k, v, w, u, state)
    if chunk < 1:
        raise ValueError(f'chunk {chunk} < 1')
    if kc.on_cpu(r):
        f32 = [x.float() for x in (r, k, v, w, u, state)]
        y, s = wkv6_tiled_ref(*f32)
        return y.to(r.dtype), s
    b, t, h, dk = r.shape
    dv = v.shape[-1]
    if r.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'r: dtype {r.dtype}, expected float32 or bfloat16')
    if dk not in HEAD_DIMS:
        raise ValueError(f'K = {dk}: the kernel takes {HEAD_DIMS}')
    if not 1 <= dv <= 1024:
        raise ValueError(f'V = {dv}: the kernel takes 1..1024')
    for name, x, shape in (('r', r, (b, t, h, dk)), ('k', k, (b, t, h, dk)),
                           ('v', v, (b, t, h, dv)), ('w', w, (b, t, h, dk)),
                           ('u', u, (h, dk))):
        kc.require(x, name, r.dtype, shape, r.device)
    kc.require(state, 'state', torch.float32, (b, h, dk, dv), r.device)
    r, k, w = _aligned(r), _aligned(k), _aligned(w)
    y = torch.empty_like(v)
    state_out = torch.empty_like(state)
    with torch.cuda.device(r.device):
        err = kc.kernel_fn('valve_wkv6', _ARGS)(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), state.data_ptr(), y.data_ptr(),
            state_out.data_ptr(), b, t, h, dk, dv,
            int(r.dtype == torch.bfloat16), kc.stream_ptr(r))
    kc.check_launch(err, 'wkv6')
    kc.LAUNCHES['wkv6'] += 1
    return y, state_out
