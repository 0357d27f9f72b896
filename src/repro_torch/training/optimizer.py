"""AdamW, as the reference's ``training/optimizer.py`` (hand-rolled, no
master weights): gradients arrive in the parameter's dtype, the global-norm
clip and the bias-corrected moments are f32, and the decoupled weight decay
applies to an f32 copy of the parameter, which is then cast back to its
dtype (bf16 parameters stay bf16).  The schedule, the clip scale and the
bias corrections are f32 tensors on the device, as in the reference: Python
floats would be f64 and lose f32 parity, and reading them would sync the
host each step.  The update runs in place under ``torch.no_grad``.

The ZeRO-1 moment shardings (``zero1_moment_specs``, ``opt_state_specs``)
are ROADMAP Queue 1 item 10b, the trainer's mesh branch.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch

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


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares, leaf by leaf in
    the reference's order."""
    total = 0
    for x in tr.leaves(tree):
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, opt_state
                 ) -> Tuple[object, dict, dict]:
    """One AdamW step: updates ``params`` and the moments in place and
    returns (params, new opt state, {'lr', 'grad_norm'}); grad_norm is the
    norm before the clip."""
    step = opt_state['step'] + 1
    gnorm = global_norm(grads)
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

    tr.tree_map(upd, params, grads, opt_state['mu'], opt_state['nu'])
    new_state = {'step': step, 'mu': opt_state['mu'], 'nu': opt_state['nu']}
    return params, new_state, {'lr': lr, 'grad_norm': gnorm}
