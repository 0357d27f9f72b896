"""AdamW, as the reference's ``training/optimizer.py`` (hand-rolled, no
master weights): gradients arrive in the parameter's dtype, the global-norm
clip and the bias-corrected moments are f32, and the decoupled weight decay
applies to an f32 copy of the parameter, which is then cast back to its
dtype (bf16 parameters stay bf16).  The schedule, the clip scale and the
bias corrections are f32 tensors on the device, as in the reference: Python
floats would be f64 and lose f32 parity, and reading them would sync the
host each step.  The update runs in place under ``torch.no_grad``.

Under a mesh (``plan``: a ``training.train_step.TrainPlan``) the tree
holds this rank's blocks: the global norm sums each block's squares once
over the ``model`` axis, and with ZeRO-1 each data rank updates its slice
of every moment and of the parameter, after which the parameter's slices
are gathered over the data axes.  AdamW is elementwise, so the parameters
are bit-equal with ZeRO-1 on and off.  ``zero1_moment_specs`` and
``opt_state_specs`` are the reference's specs of the moments.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.distributed.sharding import Sharding, check_spec
from repro_torch.training import tree as tr


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0          # global-norm clip; 0 disables
    warmup_steps: int = 100
    decay_steps: int = 10_000       # cosine decay horizon
    min_lr_frac: float = 0.1


def lr_at(cfg: AdamWConfig, step):
    """Linear warmup -> cosine decay: an f32 scalar tensor on ``step``'s
    device (an int counts as a CPU step)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init_opt_state(params) -> dict:
    """{'step': int32 0, 'mu', 'nu': f32 zeros shaped like ``params``} on
    the params' device."""
    device = tr.leaves(params)[0].device
    return {'step': torch.zeros((), dtype=torch.int32, device=device),
            'mu': tr.zeros_f32(params), 'nu': tr.zeros_f32(params)}


def global_norm(tree, plan=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares, leaf by leaf in
    the reference's order.  Under ``plan`` the leaves are this rank's
    blocks: those replicated over ``model`` count here, the sums of the
    split ones are all-reduced over ``model``, and a kv-head held by
    several ranks counts on the first of them only; the same norm on every
    rank."""
    total, split = 0, None
    for path, x in tr.leaves_with_paths(tree):
        sq = torch.sum(torch.square(x.to(torch.float32)))
        share = 'replicated' if plan is None else plan.norm_share(path)
        if share == 'replicated':
            total = total + sq
        elif share == 'split':
            split = sq if split is None else split + sq
    if plan is not None and plan.model_group is not None:
        split = (torch.zeros((), dtype=torch.float32, device=plan.device)
                 if split is None else split)
        torch.distributed.all_reduce(split, group=plan.model_group)
        total = total + split
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, opt_state, *, plan=None
                 ) -> Tuple[object, dict, dict]:
    """One AdamW step: updates ``params`` and the moments in place and
    returns (params, new opt state, {'lr', 'grad_norm'}); grad_norm is the
    norm before the clip.  ``plan``: a mesh's rank (module docstring); the
    gradients are already reduced over the data axes."""
    step = opt_state['step'] + 1
    gnorm = global_norm(grads, plan)
    scale = None
    if cfg.grad_clip > 0:
        # a tensor numerator: ``float / tensor`` is a reciprocal and a
        # product in torch, not the reference's one rounding
        scale = torch.clamp(torch.full_like(gnorm, cfg.grad_clip)
                            / (gnorm + 1e-9), max=1.0)
    lr = lr_at(cfg, step)
    t = step.to(torch.float32)
    bc1 = 1 - cfg.b1 ** t
    bc2 = 1 - cfg.b2 ** t

    def upd(p, g, mu, nu):
        g = g.to(torch.float32)
        if scale is not None:
            g = g * scale
        mu.copy_(cfg.b1 * mu + (1 - cfg.b1) * g)
        nu.copy_(cfg.b2 * nu + (1 - cfg.b2) * g * g)
        step_v = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        pf = p.to(torch.float32)
        p.copy_((pf - lr * (step_v + cfg.weight_decay * pf)).to(p.dtype))

    for (path, p), g, mu, nu in zip(tr.leaves_with_paths(params),
                                    tr.leaves(grads),
                                    tr.leaves(opt_state['mu']),
                                    tr.leaves(opt_state['nu'])):
        cut = None if plan is None else plan.moment_slice(path)
        if cut is None:
            upd(p, g, mu, nu)
        else:                       # ZeRO-1: this data rank's slice
            dim, lo, n = cut
            upd(p.narrow(dim, lo, n), g.narrow(dim, lo, n), mu, nu)
            plan.gather_slices(p, dim)
    new_state = {'step': step, 'mu': opt_state['mu'], 'nu': opt_state['nu']}
    return params, new_state, {'lr': lr, 'grad_norm': gnorm}


# ---------------------------------------------------------------------------
# Sharding of optimizer state (the reference's specs)
# ---------------------------------------------------------------------------

def _map2(fn, a, b):
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def zero1_dim(shape, sharded, n: int) -> Optional[int]:
    """ZeRO-1's rule: the dimension along which ``n`` data ranks cut a
    moment -- the first that the param's placement leaves whole (not
    ``sharded[i]``) and ``n`` divides -- or None.  ``zero1_moment_specs``
    reads it on specs, ``train_step.TrainPlan`` on a rank's blocks, where a
    dimension of several intervals (zamba2's packed leaves) is cut, so a
    moment is cut along another dimension or not at all."""
    for i, (dim, cut) in enumerate(zip(shape, sharded)):
        if not cut and dim % n == 0 and dim >= n:
            return i
    return None


def zero1_moment_specs(param_shapes, param_specs, mesh,
                       data_axes=('pod', 'data')):
    """ZeRO-1: each moment's spec is its param's, with the data axes on the
    dimension :func:`zero1_dim` picks (``Sharding`` s, specs without
    trailing ``None``).  A spec naming one mesh axis twice is refused
    (``check_spec``)."""
    axes = tuple(a for a in data_axes if a in mesh.axis_names)
    n = 1
    for a in axes:
        n *= mesh.shape[a]

    def one(shape, sharding):
        spec = check_spec(sharding.spec, 'param spec')
        parts = list(spec) + [None] * (len(shape) - len(spec))
        i = zero1_dim(shape, [p is not None for p in parts], n) if axes \
            else None
        if i is not None:
            parts[i] = axes if len(axes) > 1 else axes[0]
        while parts and parts[-1] is None:
            parts.pop()
        return Sharding(mesh, check_spec(tuple(parts), 'moment spec'))

    return _map2(one, param_shapes, param_specs)


def opt_state_specs(param_specs, mesh, *, zero1: bool = False,
                    param_shapes=None):
    """The optimizer state's specs: {'step': replicated, 'mu', 'nu'}."""
    if zero1:
        if param_shapes is None:
            raise ValueError('zero1 needs the param shapes')
        m = zero1_moment_specs(param_shapes, param_specs, mesh)
    else:
        m = param_specs
    return {'step': Sharding(mesh, ()), 'mu': m, 'nu': m}
