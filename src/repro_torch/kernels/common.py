"""Shared kernel toolkit: plain online-softmax helpers, the counter-hash
sampling noise, launch counters, and the build/loader of the CUDA library.

Every kernel of the port is CUDA C++ under ``kernels/*/csrc/*.cu`` (plus
``kernels/csrc/*.cu`` and the headers shared there), compiled for Hopper
(``sm_90a``) by ``nvcc`` at first use into one shared library with a plain
C interface under the checkout's git-ignored ``build/`` directory, keyed by
a hash of the sources, headers and flags,
and loaded with ``ctypes``.  Each source compiles in its own ``nvcc``
process, all started together, then one link.  Nothing is built when a
module is imported: the CPU tests import every module and never reach
:func:`kernel_library`.

Each wrapper (``paged_attention/ops.py``, ``sampling/ops.py``,
``flash_attention/ops.py``, ``rwkv6/ops.py``) checks its tensors, adds one to its entry of :data:`LAUNCHES` where it launches its
kernel, and takes the kernel's plain PyTorch version only for tensors that
lie on the CPU.  On a CUDA tensor it launches or raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Tuple

import torch

# Softmax mask fill value: large-negative but finite in f32, so a fully
# masked row underflows exp() to 0 instead of producing NaN via inf - inf.
NEG_INF = -1e30

# one launch counter per kernel wrapper (see module docstring)
LAUNCHES: Dict[str, int] = {
    'paged_decode': 0, 'shared_run': 0, 'shared_tail': 0,
    'unembed_sample': 0, 'flash_attention': 0, 'wkv6': 0,
}

PKG_DIR = Path(__file__).resolve().parents[1]
BUILD_DIR = PKG_DIR.parents[1] / 'build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC', '-Xptxas', '-v')
LIB_NAME = 'libvalve_kernels.so'


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, multiple: int) -> int:
    return ceil_div(x, multiple) * multiple


def pad_axis_to(x, axis: int, multiple: int, *, value=0.0):
    """``value``-pad one axis of ``x`` up to a multiple of ``multiple``;
    ``x`` itself (no copy) when it is already aligned."""
    size = x.shape[axis]
    extra = round_up(size, multiple) - size
    if extra == 0:
        return x
    pad_shape = list(x.shape)
    pad_shape[axis] = extra
    return torch.cat([x, x.new_full(pad_shape, value)], dim=axis)


# ---------------------------------------------------------------------------
# Online softmax (the running max/denominator state the attention kernels
# carry across pages; the plain versions below use the same steps)
# ---------------------------------------------------------------------------

def online_softmax_update(s, v, m_prev, l_prev, acc_prev):
    """One online-softmax step over a masked f32 score block.

    s: (..., cols) scores (masked entries at NEG_INF); v: (..., cols, D)
    broadcastable against ``s``.  Returns the rescaled (m, l, acc).  A row
    whose scores are all masked while m is still NEG_INF gathers garbage
    mass at weight exp(0); the first finite score rescales it away
    (alpha = exp(NEG_INF - m) = 0), exactly as in the kernels.
    """
    m_new = torch.maximum(m_prev, s.amax(dim=-1))
    alpha = torch.exp(m_prev - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l_prev * alpha + p.sum(dim=-1)
    acc_new = acc_prev * alpha[..., None] + torch.matmul(
        p[..., None, :], v)[..., 0, :]
    return m_new, l_new, acc_new


def online_softmax_finalize(acc, l):
    """acc / l with fully-masked rows (l == 0) mapped to 0, not NaN."""
    safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return acc / safe[..., None]


# ---------------------------------------------------------------------------
# Counter-based sampling noise.  torch's uint32 lacks the wrapping
# multiply, so the u32 arithmetic runs in int64 masked to 32 bits; the
# multiply is split in 16-bit halves so no int64 product overflows.
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul_u32(x, c: int):
    """(x * c) mod 2**32 for int64 ``x`` in [0, 2**32) and a u32 constant."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def hash_u32(x):
    """Stateless u32 avalanche hash (splitmix-style finalizer); returns
    int64 values in [0, 2**32), bit-identical to the reference's uint32."""
    x = torch.as_tensor(x).to(torch.int64) & _M32
    x = x ^ (x >> 16)
    x = _mul_u32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul_u32(x, 0x846CA68B)
    return x ^ (x >> 16)


def gumbel_hash_noise(seed, rows, cols):
    """Deterministic Gumbel(0, 1) noise per (row, col) counter, f32.

    ``argmax(logits / T + gumbel)`` is an exact sample from
    ``softmax(logits / T)``, so the fused sampling kernel carries
    temperature sampling as a pure argmax.  The CUDA kernel computes the
    same bits in native ``uint32_t``.
    """
    rows = torch.as_tensor(rows)
    seed = torch.as_tensor(seed, device=rows.device).to(torch.int64) & _M32
    h = hash_u32(seed ^ _mul_u32(rows.to(torch.int64) & _M32, 0x9E3779B9))
    bits = hash_u32(h ^ (torch.as_tensor(cols).to(torch.int64) & _M32))
    # top 24 bits → uniform on (0, 1], as in the reference: from 0.5 up the
    # sum rounds in f32, and all 24 bits set give u = 1.0 and noise +inf
    u = (bits >> 8).to(torch.float32) * 2.0 ** -24 + 2.0 ** -25
    return -torch.log(-torch.log(u))


# ---------------------------------------------------------------------------
# Build, load and launch
# ---------------------------------------------------------------------------

def kernel_sources():
    return sorted(PKG_DIR.glob('kernels/csrc/*.cu')) + \
        sorted(PKG_DIR.glob('kernels/*/csrc/*.cu'))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = Path(CUDA_HOME) / 'bin' / 'nvcc' if CUDA_HOME else None
    if nvcc is None or not nvcc.exists():
        raise RuntimeError('nvcc not found (set CUDA_HOME): the CUDA '
                           'kernels are built from source at first use')
    return str(nvcc)


def library_path() -> Path:
    """Where the library for the current sources, headers and flags lives."""
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in kernel_sources() + sorted(PKG_DIR.glob('kernels/**/*.cuh')):
        h.update(src.relative_to(PKG_DIR).as_posix().encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f'kernels-{h.hexdigest()[:16]}' / LIB_NAME


def _build(lib: Path) -> None:
    """One ``nvcc -c`` per source, all running at once, then one link.
    The compilers' output (``-Xptxas -v``: registers, shared memory,
    spills per kernel) is kept beside the library as ``build.log``."""
    nvcc, out = _nvcc(), lib.parent
    out.mkdir(parents=True, exist_ok=True)
    tag = f'{os.getpid()}'
    jobs = []
    for src in kernel_sources():
        obj = out / f'{src.stem}.{tag}.o'
        cmd = [nvcc, *NVCC_FLAGS, '-c', str(src), '-o', str(obj)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log = [f'$ {" ".join(cmd)}\n{proc.communicate()[0]}'
           for cmd, _, proc in jobs]       # wait for every compiler first
    for (_, _, proc), text in zip(jobs, log):
        if proc.returncode:
            raise RuntimeError('nvcc failed:\n' + text)
    tmp = lib.with_name(f'{LIB_NAME}.{tag}.tmp')
    cmd = [nvcc, '-shared', '-o', str(tmp), *(str(o) for _, o, _ in jobs)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    log.append(f'$ {" ".join(cmd)}\n{res.stdout}{res.stderr}')
    if res.returncode:
        raise RuntimeError('nvcc link failed:\n' + log[-1])
    (out / 'build.log').write_text('\n'.join(log))
    for _, obj, _ in jobs:
        obj.unlink()
    os.replace(tmp, lib)     # atomic: a concurrent builder sees all or none


@functools.lru_cache(maxsize=None)
def kernel_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    lib = library_path()
    if not lib.exists():
        _build(lib)
    return ctypes.CDLL(str(lib))


@functools.lru_cache(maxsize=None)
def kernel_fn(name: str, argtypes: Tuple, restype=ctypes.c_int):
    """A C entry point with its ``argtypes`` set: pointers and the stream
    as ``c_void_p`` (ctypes would otherwise cut them to 32 bits)."""
    fn = getattr(kernel_library(), name)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn


def check_launch(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if err:
        msg = kernel_fn('valve_cuda_error_string', (ctypes.c_int,),
                        ctypes.c_char_p)
        raise RuntimeError(f'{name}: CUDA error {err}: '
                           f'{msg(err).decode()}')


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (132 on an H100 SXM):
    the host-side plans size their grids to fill them."""
    device = torch.device(device)
    return _sm_count(torch.cuda.current_device() if device.index is None
                     else device.index)


def on_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor (the wrapper takes the plain version), False
    for a CUDA one (it launches its kernel); any other device raises."""
    if t.device.type == 'cpu':
        return True
    if t.device.type != 'cuda':
        raise ValueError(f'no kernel for device {t.device}')
    return False


def refuse_grad(name: str, *tensors) -> None:
    """The kernels have no backward: raise rather than return outputs that
    silently drop the graph."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f'{name}: no backward kernel; call it on tensors '
                           'that do not require grad')


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t) -> int:
    """Device pointer of a tensor, or 0 (NULL) for an omitted input."""
    return 0 if t is None else t.data_ptr()


def require(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    """Wrapper-side input check: raise on anything the kernel does not take."""
    if t.device != device:
        raise ValueError(f'{name}: on {t.device}, expected {device}')
    if t.dtype != dtype:
        raise ValueError(f'{name}: dtype {t.dtype}, expected {dtype}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name}: shape {tuple(t.shape)}, '
                         f'expected {tuple(shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{name}: must be contiguous')
