"""The train step, as the reference's meshless ``make_train_step``:
microbatch gradient accumulation, remat (inside the model's layer loop),
AdamW.

Microbatching splits the global batch along its leading axis; each
microbatch's gradients are summed in f32 and divided by the count, and the
loss is the mean of the microbatch losses.  The mesh branch (data-parallel
reduce, ZeRO-1 moments, the compressed all-reduce) is ROADMAP Queue 1 item
10b, over the port's mesh (``launch/mesh.py``) and sharding rules
(``distributed/sharding.py``); ``make_serve_step`` comes with its per-cell
report (item 11).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.api import Model
from repro_torch.training import optimizer as opt
from repro_torch.training import tree as tr


def loss_and_grads(model: Model, params, batch, microbatches: int = 1):
    """(loss, grads shaped like ``params``) of ``model.loss_fn`` on the
    plain paths.  One microbatch: gradients in the parameters' dtypes; more:
    f32 sums over the microbatches divided by their count."""
    leaves = tr.leaves(params)
    if not all(p.requires_grad for p in leaves):
        raise ValueError('params must require grad: draw them with '
                         'init_params(..., requires_grad=True)')

    if microbatches == 1:
        loss, _ = model.loss_fn(params, batch)
        return loss.detach(), tr.unflatten(
            params, torch.autograd.grad(loss, leaves))
    b = next(iter(batch.values())).shape[0]
    if b % microbatches:
        raise ValueError(f'batch {b} does not split into {microbatches} '
                         'microbatches')
    n = b // microbatches
    gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in leaves]
    lsum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for i in range(microbatches):
        mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
        loss, _ = model.loss_fn(params, mb)
        gsum = [a + g.to(torch.float32)
                for a, g in zip(gsum, torch.autograd.grad(loss, leaves))]
        lsum = lsum + loss.detach()
    return lsum / microbatches, tr.unflatten(
        params, [g / microbatches for g in gsum])


def make_train_step(model: Model, mesh=None, *,
                    opt_cfg: Optional[opt.AdamWConfig] = None,
                    microbatches: int = 1):
    """``step(params, opt_state, batch) -> (params, opt_state, {'lr',
    'grad_norm', 'loss'})``, updating params and moments in place.  batch:
    tensors on the params' device, split along the leading axis into
    ``microbatches``."""
    if mesh is not None:
        raise NotImplementedError(
            'make_train_step: the mesh branch (data-parallel reduce, '
            'ZeRO-1 moments) is not ported yet (ROADMAP Queue 1 item 10b)')
    ocfg = opt_cfg or opt.AdamWConfig()

    def step(params, opt_state, batch):
        loss, grads = loss_and_grads(model, params, batch, microbatches)
        params, opt_state, metrics = opt.adamw_update(ocfg, params, grads,
                                                      opt_state)
        return params, opt_state, dict(metrics, loss=loss)
    return step
