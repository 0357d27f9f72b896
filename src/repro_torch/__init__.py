"""PyTorch/CUDA port of the Valve reproduction.

A second package beside the JAX reference ``repro``: the same control plane
(copied, jax-free), the dense model family and serving engine rewritten in
PyTorch, and the reference's Pallas TPU kernels rewritten as CUDA C++ for
Hopper (``kernels/*/csrc``).  Nothing here imports jax or ``repro``.

Entry points run on the GPU unless the caller passes ``device='cpu'``
(:func:`resolve_device`); they never fall back to the CPU on their own.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU; the CPU only when asked for by name.  A CUDA
    device comes back with its index (``cuda`` -> ``cuda:<current>``), so
    it compares equal to the device of the tensors allocated on it."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(
                'no CUDA device: pass device="cpu" to run on the CPU')
        if device.index is None:
            device = torch.device('cuda', torch.cuda.current_device())
    return device
