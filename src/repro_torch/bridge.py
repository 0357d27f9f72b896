"""Bridge from the JAX reference's arrays to the port's tensors.

Parity tests draw weights with the reference's ``init_params`` (torch cannot
replay ``jax.random``) and hand them over as numpy.  The reference keeps
bf16 as ml_dtypes arrays, which ``torch.from_numpy`` rejects, so every leaf
goes through f32 numpy -- exact for bf16.  The reference's ``unembed``
(the untied dense head, and rwkv6's head) is (D, V); the port keeps every
head as (V, D) row-major, so it is transposed here, once.  This module
imports neither jax nor the reference: callers pass plain numpy trees.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _tensor(x, dtype, device):
    return torch.from_numpy(np.array(x, np.float32)).to(device=device,
                                                         dtype=dtype)


def params_from_jax(tree, *, dtype=torch.float32, device='cpu'):
    """Nested dict of numpy leaves (reference layout) -> nn.ParameterDict."""
    def build(node, key=None):
        if isinstance(node, dict):
            return nn.ParameterDict({k: build(v, k) for k, v in node.items()})
        t = _tensor(node, dtype, device)
        if key == 'unembed':                     # (D, V) -> (V, D)
            t = t.T.contiguous()
        return nn.Parameter(t, requires_grad=False)
    return build(tree)


def cache_from_jax(cache, *, dtype=torch.float32, device='cpu'):
    """{'k', 'v'} numpy pools (global layout) -> dict of tensors."""
    return {k: _tensor(v, dtype, device) for k, v in cache.items()}


def state_from_jax(state, *, dtype=torch.float32, device='cpu'):
    """rwkv6 recurrent state {'wkv', 'shift_tm', 'shift_cm'} -> tensors:
    ``wkv`` stays f32 whatever the model dtype, the shift states take
    ``dtype`` (the model's)."""
    return {k: _tensor(v, torch.float32 if k == 'wkv' else dtype, device)
            for k, v in state.items()}
