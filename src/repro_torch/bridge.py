"""Bridge between the JAX reference's arrays and the port's tensors.

Parity tests draw weights with the reference's ``init_params`` (torch cannot
replay ``jax.random``) and hand them over as numpy.  The reference keeps
bf16 as ml_dtypes arrays, which ``torch.from_numpy`` rejects, so every leaf
goes through f32 numpy -- exact for bf16.  The reference's ``unembed``
(the untied dense head, and rwkv6's head) is (D, V); the port keeps every
head as (V, D) row-major, so it is transposed here, once, both ways (the
trainer's checkpoints use the way back, so that each package restores the
other's).  This module imports neither jax nor the reference: callers pass
plain numpy trees.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

HEAD = 'unembed'        # the one leaf name whose layouts differ


def _tensor(x, dtype, device, key=None):
    t = torch.from_numpy(np.array(x, np.float32)).to(device=device,
                                                     dtype=dtype)
    return t.T.contiguous() if key == HEAD else t        # (D, V) -> (V, D)


def params_from_jax(tree, *, dtype=torch.float32, device='cpu',
                    requires_grad: bool = False):
    """Nested dict of numpy leaves (reference layout) -> nn.ParameterDict,
    its leaves requiring grad with ``requires_grad``."""
    def build(node, key=None):
        if isinstance(node, dict):
            return nn.ParameterDict({k: build(v, k) for k, v in node.items()})
        return nn.Parameter(_tensor(node, dtype, device, key),
                            requires_grad=requires_grad)
    return build(tree)


def opt_state_from_jax(state, *, device='cpu'):
    """The reference's AdamW state {'step', 'mu', 'nu'} (numpy leaves) ->
    the port's: an int32 step, f32 moments with ``unembed`` as (V, D)."""
    def build(node, key=None):
        if isinstance(node, dict):
            return {k: build(v, k) for k, v in node.items()}
        return _tensor(node, torch.float32, device, key)
    return {'step': torch.tensor(int(np.asarray(state['step'])),
                                 dtype=torch.int32, device=device),
            'mu': build(state['mu']), 'nu': build(state['nu'])}


def to_jax_layout(t: torch.Tensor, key=None) -> np.ndarray:
    """One port tensor as a numpy array in the reference's layout: bf16 as
    f32 (exact), ``unembed`` back to (D, V)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    a = t.cpu().numpy()
    return np.ascontiguousarray(a.T) if key == HEAD else a


def tree_to_jax(tree):
    """Port tensors (params, gradients, AdamW state: nested dicts or
    ``nn.ParameterDict``s) -> nested dicts of numpy in the reference's
    layout (:func:`to_jax_layout`)."""
    def build(node, key=None):
        if isinstance(node, (dict, nn.ParameterDict)):
            return {k: build(v, k) for k, v in node.items()}
        return to_jax_layout(node, key)
    return build(tree)


def cache_from_jax(cache, *, dtype=torch.float32, device='cpu'):
    """A numpy cache tree (the {'k', 'v'} pools in the global or the
    per-request region layout, encdec's cross K/V beside them, or zamba2's
    nested {'mamba': {'conv', 'ssm'}, 'attn': {'k', 'v'}}) -> the same
    tree of tensors in ``dtype``, but
    ``ssm``, the Mamba state, which stays f32 whatever the model dtype (as
    :func:`state_from_jax` keeps ``wkv``)."""
    def build(node, key=None):
        if isinstance(node, dict):
            return {k: build(v, k) for k, v in node.items()}
        return _tensor(node, torch.float32 if key == 'ssm' else dtype,
                       device)
    return build(cache)


def state_from_jax(state, *, dtype=torch.float32, device='cpu'):
    """rwkv6 recurrent state {'wkv', 'shift_tm', 'shift_cm'} -> tensors:
    ``wkv`` stays f32 whatever the model dtype, the shift states take
    ``dtype`` (the model's)."""
    return {k: _tensor(v, torch.float32 if k == 'wkv' else dtype, device)
            for k, v in state.items()}


def shard_params(tree, model, mesh, *, dtype=torch.float32, device='cpu',
                 requires_grad: bool = False, plan=None):
    """The reference's weights (numpy leaves, its layout) cut to the blocks
    rank ``mesh.rank`` holds under the default tensor-parallel plan
    (``distributed.tp.TensorParallel``), or under ``plan`` (a serve step's
    ``StepParallel``, or a ``TrainPlan``'s ``tp``: each places them by its
    rules), as an ``nn.ParameterDict`` whose leaves require grad with
    ``requires_grad`` (training)."""
    from repro_torch.distributed.tp import TensorParallel

    tp = TensorParallel(model.cfg, mesh) if plan is None else plan

    def build(node, path=()):
        if isinstance(node, dict):
            return nn.ParameterDict({k: build(v, path + (k,))
                                     for k, v in node.items()})
        full = _tensor(node, dtype, 'cpu', path[-1])
        return nn.Parameter(tp.shard(path, full).contiguous().to(device),
                            requires_grad=requires_grad)
    return build(tree)


def shard_opt_state(state, plan, *, device='cpu'):
    """The reference's AdamW state (numpy leaves, its layout) cut to the
    moment blocks of a ``training.train_step.TrainPlan``'s rank (its
    ZeRO-1 slices): both packages can then start a step from one state."""
    return plan.shard_opt_state(opt_state_from_jax(state, device=device))
