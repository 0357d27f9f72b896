"""End-to-end training driver, ported from the reference's
``launch/train.py``.

Trains any config of the port (full or ``--reduced``): the deterministic
synthetic data pipeline with prefetch, AdamW, atomic checkpoint/restart and
straggler telemetry, on one device, or from every rank of a mesh
(``train(..., mesh=...)``: each rank draws the whole weights from the
seed, keeps its blocks, takes its rows of each global batch and writes
its blocks to the checkpoints, which restore onto another mesh; every
family splits over ``model``, as ``make_train_step`` does).  It runs
on the GPU; ``--device cpu`` runs it on the CPU.  The CLI trains on one
device, as the reference's has no mesh flag.  An encoder-decoder config
(seamless-m4t-medium) is refused up front: its loss needs speech frames,
which the data pipeline does not make (the reference's ``launch/train.py``
fails on it with a ``KeyError``); ``make_train_step`` trains it with
``frames`` in the batch.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --reduced --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt \
        --device cpu

    # full-width qwen3-0.6b (bf16 weights, f32 moments) on the GPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --steps 12 --batch 4 --seq 2048
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced as reduce_cfg
from repro_torch.models.api import build_model
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as opt
from repro_torch.training.data import DataConfig, Prefetcher
from repro_torch.training.fault_tolerance import StragglerDetector
from repro_torch.training.train_step import make_train_step, shard_batch


def train(arch: str, *, steps: int = 100, batch: int = 8, seq: int = 128,
          use_reduced: bool = True, microbatches: int = 1,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
          restore: bool = False, mesh=None, seed: int = 0,
          opt_cfg: Optional[opt.AdamWConfig] = None, log_every: int = 10,
          reduced_overrides: Optional[dict] = None, device=None,
          history: Optional[list] = None):
    """Train ``arch`` from seed ``seed`` (or from the newest checkpoint in
    ``ckpt_dir`` with ``restore``) up to step ``steps``, on the GPU unless
    ``device='cpu'``.  Returns (params, opt_state, the losses of the steps
    run).  ``history``, if given, gets a dict a step: step, loss, lr,
    grad_norm, and its seconds on the host clock, the device synchronized.

    ``mesh`` (``launch.mesh.make_mesh``; its device is the ranks', and
    ``device`` is then not read): every rank of it calls ``train`` alike
    and gets its own blocks back; ``batch`` is the global batch.  Rank 0
    alone prints."""
    cfg = get_config(arch)
    if cfg.family == 'encdec':
        raise ValueError(
            f'{arch}: the encdec loss needs batch["frames"] (speech frame '
            'embeddings), which the synthetic data pipeline does not make; '
            'train it through training.train_step.make_train_step with '
            'frames in the batch')
    device = resolve_device(device) if mesh is None else mesh.device
    if use_reduced:
        cfg = reduce_cfg(cfg, **(reduced_overrides or {}))
    model = build_model(cfg)
    step_fn = make_train_step(model, mesh, microbatches=microbatches,
                              opt_cfg=opt_cfg)
    plan = getattr(step_fn, 'plan', None)
    lead = mesh is None or mesh.rank == 0

    if plan is None:
        params = model.init_params(seed, device=device, requires_grad=True)
        opt_state = opt.init_opt_state(params)
        blocks, rank = None, 0
    else:
        params = plan.shard_params(model.init_params(seed, device=device))
        opt_state = plan.init_opt_state()
        blocks, rank = plan.blocks(), mesh.rank
    start_step = 0
    if restore and ckpt_dir and (s := ckpt.latest_step(ckpt_dir)) is not None:
        state = {'params': params, 'opt': opt_state}
        state, start_step = ckpt.restore(ckpt_dir, s, state,
                                         shardings=blocks)
        params, opt_state = state['params'], state['opt']
        if lead:
            print(f'[train] restored step {start_step} from {ckpt_dir}')

    dcfg = DataConfig(seq_len=seq, global_batch=batch,
                      vocab_size=cfg.vocab_size, seed=seed)
    pf = Prefetcher(dcfg, start_step=start_step)
    straggler = StragglerDetector()
    losses = []
    try:
        for _ in range(start_step, steps):
            t0 = time.perf_counter()
            step, host_batch = next(pf)
            tbatch = ({k: torch.from_numpy(v).to(device)
                       for k, v in host_batch.items()} if plan is None
                      else shard_batch(host_batch, plan, microbatches))
            params, opt_state, metrics = step_fn(params, opt_state, tbatch)
            loss = float(metrics['loss'])   # waits for the whole step
            dt = time.perf_counter() - t0
            straggler.record(f'host{rank}', dt)
            losses.append(loss)
            if history is not None:
                history.append({'step': step, 'loss': loss,
                                'lr': float(metrics['lr']),
                                'grad_norm': float(metrics['grad_norm']),
                                'seconds': dt})
            if lead and (step + 1) % log_every == 0:
                print(f'[train] step {step + 1} loss {loss:.4f} '
                      f'lr {float(metrics["lr"]):.2e} '
                      f'gnorm {float(metrics["grad_norm"]):.3f} '
                      f'{dt:.2f}s/step', flush=True)
            if ckpt_dir and (step + 1) % ckpt_every == 0:
                ckpt.save(ckpt_dir, step + 1,
                          {'params': params, 'opt': opt_state}, mesh=mesh,
                          specs=blocks)
                if lead:
                    ckpt.prune(ckpt_dir)
    finally:
        pf.close()
    return params, opt_state, losses


def train_rank(rank: int, shape, arch: str, kwargs: dict):
    """One rank of :func:`train` over a mesh of ``shape`` on the axes
    ``('data', 'model')`` (or ``('pod', 'data', 'model')`` for three
    dimensions), for ``launch.ranks.run_ranks``; ``kwargs['device']``
    names the ranks' device type.  Returns the losses of the steps run.

        run_ranks(train_rank, 4, store_dir=d, device_type='cpu', args=(
            (2, 2), 'qwen3-0.6b', dict(steps=4, batch=8, seq=32,
                                       device='cpu')))"""
    from repro_torch.launch.mesh import make_mesh

    kwargs = dict(kwargs)
    axes = ('pod', 'data', 'model')[-len(shape):]
    mesh = make_mesh(shape, axes, device=kwargs.pop('device', None))
    return train(arch, mesh=mesh, **kwargs)[2]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--arch', required=True)
    ap.add_argument('--steps', type=int, default=100)
    ap.add_argument('--batch', type=int, default=8)
    ap.add_argument('--seq', type=int, default=128)
    ap.add_argument('--reduced', action='store_true')
    ap.add_argument('--microbatches', type=int, default=1)
    ap.add_argument('--ckpt-dir', default=None)
    ap.add_argument('--ckpt-every', type=int, default=50)
    ap.add_argument('--restore', action='store_true')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--device', default=None,
                    help='torch device (default: the GPU)')
    args = ap.parse_args()
    _, _, losses = train(
        args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
        use_reduced=args.reduced, microbatches=args.microbatches,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        restore=args.restore, seed=args.seed, device=args.device)
    print(f'[train] done; loss {losses[0]:.4f} → {losses[-1]:.4f}')


if __name__ == '__main__':
    main()
