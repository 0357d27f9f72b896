"""Meshes over the ranks of a process group, ported from the reference's
``launch/mesh.py``.

The reference builds a ``jax.sharding.Mesh`` over the devices of one
process.  Here every rank is a process (``launch/ranks.py`` starts them),
and a :class:`Mesh` lays the ranks of the default process group out on
named axes through ``torch.distributed.device_mesh.init_device_mesh``.  It
carries what the rest of the port reads: ``shape`` (axis -> size),
``axis_names``, ``devices`` (a numpy array of ranks in mesh order, so
``devices.size`` counts the mesh's devices, as the runtime's gate fan-out
reads it), each rank's coordinates (``coords``, ``coord``), the process
group of this rank's line along one axis or several (``group``; the
data-parallel reduce of a ``('pod', 'data', 'model')`` mesh runs over
``('pod', 'data')``), and the torch device this rank computes on.

A mesh built with ``Mesh(np.arange(n).reshape(shape), axes)`` and no
process group is a description only: the sharding rules and the runtime's
gate count read it, and ``group`` raises.

The reference's TPU v5e constants (peak FLOP/s, HBM and ICI rates) are not
carried: the port's are the card's, below, which the dry-run's roofline
(``launch/dryrun.py``) and ``chip_smoke.py``'s bounds read.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import resolve_device


# One NVIDIA H100 80GB HBM3 (SXM5) at its 700 W power limit, NVIDIA's data
# sheet: dense bf16 tensor-core peak, HBM rate, NVLink rate a direction.  A
# card set below 700 W runs slower under load.
PEAK_FLOPS_BF16 = 989e12           # FLOP/s
HBM_BW = 3.35e12                   # bytes/s
NVLINK_BW = 450e9                  # bytes/s a direction (900 GB/s both)


class Mesh:
    """Ranks laid out on named axes (row-major, as ``init_device_mesh``)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str], *,
                 rank: int = 0, device=None, device_mesh=None):
        devices = np.asarray(devices)
        if devices.ndim != len(axis_names):
            raise ValueError(f'{devices.shape} vs axes {tuple(axis_names)}')
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, devices.shape))
        self.rank = rank
        self.device = torch.device('cpu') if device is None else device
        self._device_mesh = device_mesh
        self._groups: Dict[object, object] = {}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """The coordinate on every axis of ``rank`` (this rank's)."""
        rank = self.rank if rank is None else rank
        pos = np.argwhere(self.devices == rank)
        if len(pos) != 1:
            raise ValueError(f'rank {rank} is not on this mesh once')
        return dict(zip(self.axis_names, map(int, pos[0])))

    def coord(self, axis: str) -> int:
        """This rank's coordinate on ``axis``."""
        return self.coords()[axis]

    def group(self, axes: Union[str, Sequence[str]]):
        """The process group of this rank's line along ``axes`` (one axis,
        or a tuple of them: the ranks that differ from this one on those
        axes alone).  The groups of a tuple are made on first use, one for
        every line of the mesh, and ``new_group`` is collective: every rank
        of the mesh must ask for the same axes at the same point."""
        if self._device_mesh is None:
            raise RuntimeError('a mesh without a process group has no groups')
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if len(axes) == 1:
            return self._device_mesh.get_group(axes[0])
        others = [a for a in self.axis_names if a not in axes]
        return self.group_by(
            axes, lambda c: tuple(c[a] for a in others))

    def group_by(self, name, key: Callable[[Dict[str, int]], tuple]):
        """This rank's group when the mesh's ranks are grouped by
        ``key(coords)``, cached under ``name``.  Every group is made, in
        the order of its key, on every rank: ``new_group`` is collective
        over the whole default group, and a rank that skipped one would
        hang the others."""
        if name not in self._groups:
            import torch.distributed as dist

            lines: Dict[tuple, list] = {}
            for r in self.devices.flatten().tolist():
                lines.setdefault(key(self.coords(r)), []).append(r)
            for k in sorted(lines):
                g = dist.new_group(lines[k])
                if self.rank in lines[k]:
                    self._groups[name] = g
        return self._groups[name]

    def __repr__(self) -> str:
        return f'Mesh({self.shape}, rank={self.rank}, device={self.device})'


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device=None) -> Mesh:
    """A mesh over every rank of the initialized default process group
    (``prod(shape)`` of them), computing on ``device`` (the GPU unless
    ``device='cpu'``; ranks that share one card all name it)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError('make_mesh needs an initialized process group '
                           '(launch.ranks.run_ranks starts one a rank)')
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    n = int(np.prod(shape))
    if n != dist.get_world_size():
        raise ValueError(f'mesh {shape} needs {n} ranks, the group has '
                         f'{dist.get_world_size()}')
    device = resolve_device(device)
    dm = init_device_mesh(device.type, shape, mesh_dim_names=axes)
    ranks = np.asarray(dm.mesh.tolist(), dtype=np.int64).reshape(shape)
    return Mesh(ranks, axes, rank=dist.get_rank(), device=device,
                device_mesh=dm)


def production_layout(multi_pod: bool = False):
    """(shape, axes) of the reference's production layouts: (data 16, model
    16), or (pod 2, data 16, model 16)."""
    if multi_pod:
        return (2, 16, 16), ('pod', 'data', 'model')
    return (16, 16), ('data', 'model')


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The reference's production layouts over as many live ranks."""
    return make_mesh(*production_layout(multi_pod), device=device)


def describe(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    """A mesh of ``shape`` on ``axes`` as a description only (no process
    group, no ranks): what the sharding rules, the placement plans and the
    dry-run's count of a production layout read."""
    return Mesh(np.arange(int(np.prod(shape))).reshape(tuple(shape)), axes)


def chips(mesh: Optional[Mesh]) -> int:
    n = 1
    for v in (mesh.shape.values() if mesh is not None else ()):
        n *= v
    return n
