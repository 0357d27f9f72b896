"""Checkpoints with atomic commit, in the reference's layout on disk, so a
checkpoint written by either package restores in the other.

Layout::

    <dir>/step_<N>.tmp/          # written and fsynced first
        manifest.json            # step, leaves: global shape, dtype, shards
        host0.npz                # the arrays, one shard a leaf
    <dir>/step_<N>/              # atomic rename after fsync -- a crashed
                                 # writer never leaves a half-checkpoint

Leaves are named by their keys joined with ``/`` (``params/layers/wq``,
``opt/mu/embed``, ``opt/step``).  npz cannot store bf16, so bf16 goes
through f32 (exact) and the manifest records the true dtype.  Every leaf
named ``unembed`` (the params' and the moments') is written in the
reference's (D, V) layout and read back as the port's (V, D).  The port
writes from one process; restore assembles every shard it finds, as the
reference's does.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch.bridge import HEAD, to_jax_layout
from repro_torch.training import tree as tr

def _fsync(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save(ckpt_dir: str, step: int, tree) -> str:
    """Write one checkpoint of ``tree`` (nested dicts / ParameterDicts of
    tensors or numbers); returns the committed directory."""
    tmp = os.path.join(ckpt_dir, f'step_{step}.tmp')
    final = os.path.join(ckpt_dir, f'step_{step}')
    os.makedirs(tmp, exist_ok=True)

    arrays, leaves = {}, {}
    for key, leaf in tr.leaves_with_paths(tree):
        t = torch.as_tensor(leaf)
        a = to_jax_layout(t, key.rsplit('/', 1)[-1])
        arrays[f'{key}::0'] = a
        leaves[key] = {'shape': list(a.shape),
                       'dtype': str(t.dtype).removeprefix('torch.'),
                       'shards': {'0': [[0, n] for n in a.shape]}}

    npz = os.path.join(tmp, 'host0.npz')
    np.savez(npz, **arrays)
    _fsync(npz)
    with open(os.path.join(tmp, 'manifest.json'), 'w') as f:
        json.dump({'step': step, 'leaves': leaves, 'n_processes': 1}, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    _fsync(ckpt_dir)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split('_', 1)[1]) for d in os.listdir(ckpt_dir)
             if d.startswith('step_') and not d.endswith('.tmp')]
    return max(steps) if steps else None


def _assemble(stores, key: str, entry) -> np.ndarray:
    """One leaf's global array from the shards in ``stores`` (f32 for
    bf16, as staged)."""
    dt = entry['dtype']
    buf_dt = np.float32 if dt == 'bfloat16' else np.dtype(dt)
    out = np.zeros(entry['shape'], dtype=buf_dt)
    filled = np.zeros(entry['shape'], dtype=bool) if entry['shape'] else None
    for store in stores:
        for sid, bounds in entry['shards'].items():
            akey = f'{key}::{sid}'
            if akey not in store:
                continue
            sl = tuple(slice(lo, hi) for lo, hi in bounds)
            out[sl] = store[akey]
            if filled is not None:
                filled[sl] = True
    if filled is not None and not filled.all():
        raise ValueError(f'checkpoint leaf {key} has holes')
    return out


def restore(ckpt_dir: str, step: int, target_tree):
    """Rebuild ``target_tree`` from checkpoint ``step``: new tensors of each
    target leaf's dtype and device (an ``nn.Parameter`` keeps its
    requires_grad; a ParameterDict stays one), and the step restored."""
    d = os.path.join(ckpt_dir, f'step_{step}')
    with open(os.path.join(d, 'manifest.json')) as f:
        manifest = json.load(f)
    stores = [np.load(os.path.join(d, fn)) for fn in sorted(os.listdir(d))
              if fn.endswith('.npz')]
    try:
        def build(node, key=''):
            if isinstance(node, tr.NODES):
                kids = {k: build(v, f'{key}/{k}' if key else k)
                        for k, v in node.items()}
                return (nn.ParameterDict(kids)
                        if isinstance(node, nn.ParameterDict) else kids)
            tgt = torch.as_tensor(node)
            a = _assemble(stores, key, manifest['leaves'][key])
            if key.rsplit('/', 1)[-1] == HEAD:          # (D, V) -> (V, D)
                a = a.T
            t = torch.from_numpy(np.ascontiguousarray(a)).to(
                device=tgt.device, dtype=tgt.dtype)
            if isinstance(node, nn.Parameter):
                return nn.Parameter(t, requires_grad=node.requires_grad)
            return t
        return build(target_tree), manifest['step']
    finally:
        for s in stores:
            s.close()


def prune(ckpt_dir: str, keep: int = 3) -> None:
    """Keep the newest ``keep`` checkpoints."""
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(int(d.split('_', 1)[1]) for d in os.listdir(ckpt_dir)
                   if d.startswith('step_') and not d.endswith('.tmp'))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f'step_{s}'), ignore_errors=True)
