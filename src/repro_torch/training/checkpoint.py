"""Checkpoints with atomic commit, in the reference's layout on disk, so a
checkpoint written by either package restores in the other.

Layout::

    <dir>/step_<N>.tmp/          # written and fsynced first
        manifest.json            # step, leaves: global shape, dtype, shards
        host<k>.npz              # rank k's blocks, each with its bounds
    <dir>/step_<N>/              # atomic rename after fsync -- a crashed
                                 # writer never leaves a half-checkpoint

Leaves are named by their keys joined with ``/`` (``params/layers/wq``,
``opt/mu/embed``, ``opt/step``).  npz cannot store bf16, so bf16 goes
through f32 (exact) and the manifest records the true dtype.  Every leaf
named ``unembed`` (the params' and the moments') is written in the
reference's (D, V) layout, its bounds too, and read back as the port's
(V, D).

Under a mesh every rank writes the blocks it holds (``specs``: a
:class:`~repro_torch.distributed.sharding.Block` a leaf) to
``host<rank>.npz``, a block of several intervals on a dimension (zamba2's
packed ``in_proj``) as one shard an interval; a block several ranks hold is
written once, by the lowest of them.  The manifest's shard ids are unique a
leaf across the files, and rank 0 writes the manifest and commits after
every rank has written.  Restore assembles the blocks a target asks for
(``shardings``) from every file's overlapping shards: onto another mesh
than the writer's (the elastic reshard after ``plan_recovery``), or whole.
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
from repro_torch.distributed.sharding import Block
from repro_torch.training import tree as tr


def _fsync(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _disk_bounds(key: str, block: Block) -> list:
    """A block's bounds in the on-disk layout (``unembed`` transposed)."""
    bounds = [list(b) for b in block.bounds]
    return bounds[::-1] if key.rsplit('/', 1)[-1] == HEAD else bounds


def _sync(mesh) -> None:
    """Every rank of ``mesh`` has arrived (a host-tensor all-reduce, which
    gloo carries whatever the ranks compute on)."""
    if mesh is not None and mesh.size > 1:
        torch.distributed.all_reduce(torch.zeros(1))


def save(ckpt_dir: str, step: int, tree, *, mesh=None, specs=None) -> str:
    """Write one checkpoint of ``tree`` (nested dicts / ParameterDicts of
    tensors or numbers); returns the committed directory.  Under ``mesh``
    every rank of it calls ``save`` with its own blocks and ``specs``,
    their :class:`Block` s (a tree like ``tree``; a leaf not named is
    whole)."""
    rank, n = (0, 1) if mesh is None else (mesh.rank, mesh.size)
    tmp = os.path.join(ckpt_dir, f'step_{step}.tmp')
    final = os.path.join(ckpt_dir, f'step_{step}')
    if rank == 0:
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
    _sync(mesh)

    blocks = dict(tr.leaves_with_paths(specs)) if specs is not None else {}
    mine, leaves = {}, {}
    for key, leaf in tr.leaves_with_paths(tree):
        t = torch.as_tensor(leaf)
        b = blocks.get(key) or Block.whole(t.shape)
        # a block of several intervals on a dimension: one piece each
        mine[key] = [(t[idx], _disk_bounds(key, piece))
                     for piece, idx in b.pieces()]
        leaves[key] = {'shape': [hi for _, hi in
                                 _disk_bounds(key, Block.whole(b.shape))],
                       'dtype': str(t.dtype).removeprefix('torch.')}
    # every rank's bounds: a leaf's shard ids, and which rank writes each
    held = {k: [b for _, b in pieces] for k, pieces in mine.items()}
    if n > 1:
        every = [None] * n
        torch.distributed.all_gather_object(every, held)
    else:
        every = [held]
    arrays = {}
    for key, entry in leaves.items():
        shards = {}
        for r, pieces in enumerate(b[key] for b in every):
            for i, bounds in enumerate(pieces):
                if bounds in shards.values():
                    continue
                sid = str(len(shards))
                shards[sid] = bounds
                if r == rank:
                    arrays[f'{key}::{sid}'] = to_jax_layout(
                        mine[key][i][0], key.rsplit('/', 1)[-1])
        entry['shards'] = shards

    npz = os.path.join(tmp, f'host{rank}.npz')
    np.savez(npz, **arrays)
    _fsync(npz)
    _sync(mesh)
    if rank == 0:
        with open(os.path.join(tmp, 'manifest.json'), 'w') as f:
            json.dump({'step': step, 'leaves': leaves, 'n_processes': n}, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
        _fsync(ckpt_dir)
    _sync(mesh)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split('_', 1)[1]) for d in os.listdir(ckpt_dir)
             if d.startswith('step_') and not d.endswith('.tmp')]
    return max(steps) if steps else None


def _assemble(stores, key: str, entry, bounds=None) -> np.ndarray:
    """The block ``bounds`` (the whole leaf by default; on-disk layout) of
    one leaf, from the overlapping shards in ``stores`` (f32 for bf16, as
    staged)."""
    dt = entry['dtype']
    buf_dt = np.float32 if dt == 'bfloat16' else np.dtype(dt)
    bounds = bounds or [[0, n] for n in entry['shape']]
    out = np.zeros([hi - lo for lo, hi in bounds], dtype=buf_dt)
    filled = np.zeros(out.shape, dtype=bool) if out.ndim else None
    for store in stores:
        for sid, shard in entry['shards'].items():
            akey = f'{key}::{sid}'
            if akey not in store:
                continue
            cut = [(max(lo, a), min(hi, b))
                   for (lo, hi), (a, b) in zip(bounds, shard)]
            if any(lo >= hi for lo, hi in cut):
                continue
            src = tuple(slice(lo - a, hi - a)
                        for (lo, hi), (a, _) in zip(cut, shard))
            dst = tuple(slice(lo - a, hi - a)
                        for (lo, hi), (a, _) in zip(cut, bounds))
            out[dst] = store[akey][src]
            if filled is not None:
                filled[dst] = True
    if filled is not None and not filled.all():
        raise ValueError(f'checkpoint leaf {key} has holes')
    return out


def _assemble_block(stores, key: str, entry, block: Optional[Block]):
    """:func:`_assemble` of a :class:`Block` (the whole leaf for None), in
    the on-disk layout; a block of several intervals on a dimension (never
    a transposed head's) piece by piece, each at its slices of the
    block."""
    if block is None:
        return _assemble(stores, key, entry)
    pieces = block.pieces()
    if len(pieces) == 1:
        return _assemble(stores, key, entry, _disk_bounds(key, block))
    out = None
    for piece, idx in pieces:
        part = _assemble(stores, key, entry, _disk_bounds(key, piece))
        if out is None:
            out = np.empty(block.local_shape, part.dtype)
        out[idx] = part
    return out


def restore(ckpt_dir: str, step: int, target_tree, *, shardings=None):
    """Rebuild ``target_tree`` from checkpoint ``step``: new tensors of each
    target leaf's dtype and device (an ``nn.Parameter`` keeps its
    requires_grad; a ParameterDict stays one), and the step restored.
    ``shardings``: the :class:`Block` of each leaf that this rank holds on
    the *current* mesh (a tree like the target; a leaf not named is
    whole), assembled from whatever blocks the writer's ranks wrote."""
    d = os.path.join(ckpt_dir, f'step_{step}')
    with open(os.path.join(d, 'manifest.json')) as f:
        manifest = json.load(f)
    stores = [np.load(os.path.join(d, fn)) for fn in sorted(os.listdir(d))
              if fn.endswith('.npz')]
    blocks = (dict(tr.leaves_with_paths(shardings))
              if shardings is not None else {})
    try:
        def build(node, key=''):
            if isinstance(node, tr.NODES):
                kids = {k: build(v, f'{key}/{k}' if key else k)
                        for k, v in node.items()}
                return (nn.ParameterDict(kids)
                        if isinstance(node, nn.ParameterDict) else kids)
            tgt = torch.as_tensor(node)
            a = _assemble_block(stores, key, manifest['leaves'][key],
                                blocks.get(key))
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
