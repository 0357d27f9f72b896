"""Logical-axis sharding, ported from the reference's
``distributed/sharding.py``.

Models annotate tensors with *logical* axis names (``PSpec.axes``); a rule
set maps those to mesh axes.  The rule tables, ``logical_to_spec`` and the
shape-aware ``shaped_spec`` are the reference's, verbatim.  A spec here is
the tuple form of jax's ``PartitionSpec``: one entry a dimension, each
``None`` (replicated), a mesh axis name or a tuple of names, trailing
``None`` entries stripped -- so ``tuple(spec) == tuple(P)`` compares the two.

There is no GSPMD behind a spec: :func:`local_shard` narrows a global
tensor to one rank's block (:func:`local_bounds` names it as a
:class:`Block`), in ``NamedSharding``'s block order, and the
tensor-parallel forward (``distributed/tp.py``) places its collectives
explicitly.  :func:`constrain` is therefore the identity, inside a rules
context and outside it.  A mesh is anything with ``axis_names`` and a
``shape`` mapping (``launch/mesh.py``'s :class:`Mesh`).
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

AxisVal = Union[None, str, Tuple[str, ...]]
Spec = Tuple[AxisVal, ...]

# ---------------------------------------------------------------------------
# Rule sets.  Values may name mesh axes that do not exist in the active mesh;
# missing axes are dropped at resolution time, so one rule set serves both the
# single-pod (data, model) and multi-pod (pod, data, model) meshes.
# ---------------------------------------------------------------------------

TRAIN_RULES: Dict[str, AxisVal] = {
    'batch': ('pod', 'data'),
    'seq': 'model',          # Megatron-style sequence parallelism on residuals
    'embed': None,
    'heads': 'model',
    'kv_heads': 'model',
    'head_dim': None,
    'qkv': 'model',          # fused q/k/v output dim
    'ffn': 'model',
    'vocab': 'model',
    'expert': 'model',       # expert parallelism
    'layers': None,
    'pages': None,
    'state': None,
}

# Decode/prefill: batch over (pod, data), tensor-parallel dims over model.
SERVE_RULES: Dict[str, AxisVal] = {
    'batch': ('pod', 'data'),
    'seq': None,
    'embed': None,
    'heads': 'model',
    'kv_heads': 'model',
    'head_dim': None,
    'qkv': 'model',
    'ffn': 'model',
    'vocab': 'model',
    'expert': 'model',
    'layers': None,
    'pages': None,
    'kv_seq': None,
    'state': None,
}

# long_500k (global_batch=1): nothing to shard on batch -- the KV sequence
# dim itself is sharded over (pod, data).
LONG_SERVE_RULES: Dict[str, AxisVal] = dict(
    SERVE_RULES, batch=None, kv_seq=('pod', 'data'))

# The reference's hill-climb variants (its EXPERIMENTS.md §Perf).
# Decode H1 -- contract-over-Dh: q and the KV pool on head_dim.
SERVE_DH_CONTRACT_RULES: Dict[str, AxisVal] = dict(
    SERVE_RULES, heads=None, kv_heads=None, head_dim='model', qkv=None)

# Decode H2 -- sequence-parallel KV: the pool's page dim over model.
SERVE_SEQ_RULES: Dict[str, AxisVal] = dict(
    SERVE_RULES, pages='model', kv_seq='model')

# Decode H3 -- data-parallel attention: the KV pool replicated over model.
SERVE_KV_DP_RULES: Dict[str, AxisVal] = dict(
    SERVE_RULES, heads=None, kv_heads=None, head_dim=None)

# Train H1 -- no sequence parallelism on the residual stream.
TRAIN_NO_SP_RULES: Dict[str, AxisVal] = dict(TRAIN_RULES, seq=None)

RULE_VARIANTS = {
    'default': None,                      # resolved per shape kind
    'serve_dh': SERVE_DH_CONTRACT_RULES,
    'serve_seq': SERVE_SEQ_RULES,
    'serve_kv_dp': SERVE_KV_DP_RULES,
    'train_no_sp': TRAIN_NO_SP_RULES,
}

_tls = threading.local()


def _current():
    return getattr(_tls, 'ctx', None)


@contextlib.contextmanager
def axis_rules(mesh, rules: Dict[str, AxisVal]):
    """Make (mesh, rules) the thread's rules context while inside;
    ``mesh=None`` clears it."""
    prev = _current()
    _tls.ctx = (mesh, rules) if mesh is not None else None
    try:
        yield
    finally:
        _tls.ctx = prev


def logical_to_spec(axes: Sequence[Optional[str]],
                    rules: Dict[str, AxisVal], mesh=None) -> Spec:
    """Map logical axis names to a spec, dropping absent mesh axes.

    A rule whose mapped axes are *all* absent from the mesh resolves to
    ``None`` (replicated) -- never a stale name tuple; ``mesh=None`` has no
    axes at all, so every mapping degrades to replicated.
    """
    mesh_axes = set(mesh.axis_names) if mesh is not None else set()
    used: set = set()
    parts = []
    for ax in axes:
        val = rules.get(ax) if ax is not None else None
        if val is None:
            parts.append(None)
            continue
        val_t = (val,) if isinstance(val, str) else tuple(val)
        val_t = tuple(v for v in val_t if v in mesh_axes)
        val_t = tuple(v for v in val_t if v not in used)
        used.update(val_t)
        if not val_t:
            parts.append(None)
        elif len(val_t) == 1:
            parts.append(val_t[0])
        else:
            parts.append(val_t)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def constrain(x, axes: Sequence[Optional[str]]):
    """The identity.  The reference pins an intermediate's sharding here and
    GSPMD inserts the collectives; the port's tensor-parallel forward holds
    local blocks and runs its collectives explicitly (``distributed/tp.py``),
    so there is nothing to pin, inside a rules context or outside it."""
    return x


def shaped_spec(shape: Sequence[int], axes: Sequence[Optional[str]],
                rules: Dict[str, AxisVal], mesh) -> Spec:
    """Shape-aware resolution for arguments (which must divide evenly).

    Mesh axes whose size does not divide the mapped dimension are dropped
    from that dimension and re-placed on the last unsharded, divisible
    dimension instead (e.g. 8 KV heads can't shard over model=16 -> the
    model axis moves to head_dim=128).  Deterministic.
    """
    sizes = dict(mesh.shape)
    used: set = set()
    groups: list = []
    freed: list = []
    for dim, ax in zip(shape, axes):
        val = rules.get(ax) if ax is not None else None
        if val is None:
            groups.append([])
            continue
        val_t = (val,) if isinstance(val, str) else tuple(val)
        val_t = [v for v in val_t if v in sizes and v not in used]
        # drop trailing axes until the product divides the dim
        while val_t:
            prod = 1
            for v in val_t:
                prod *= sizes[v]
            if dim % prod == 0:
                break
            freed.append(val_t.pop())
        used.update(val_t)
        groups.append(list(val_t))
    # re-place freed axes on the last divisible unsharded dims
    for v in freed:
        for i in range(len(groups) - 1, -1, -1):
            if not groups[i] and shape[i] % sizes[v] == 0 and shape[i] > 1:
                groups[i].append(v)
                used.add(v)
                break
    parts = [None if not g else (g[0] if len(g) == 1 else tuple(g))
             for g in groups]
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


@dataclass(frozen=True)
class Sharding:
    """A spec bound to a mesh (the reference's ``NamedSharding``)."""
    mesh: object
    spec: Spec

    def shard(self, full, coords: Optional[Dict[str, int]] = None):
        return local_shard(full, self.spec, self.mesh, coords)


def spec_for(axes: Sequence[Optional[str]], rules: Dict[str, AxisVal],
             mesh) -> Sharding:
    return Sharding(mesh, logical_to_spec(axes, rules, mesh))


def _is_axes_leaf(t) -> bool:
    return isinstance(t, tuple) and all(
        a is None or isinstance(a, str) for a in t)


def _map_axes(fn, tree, *rest):
    """``fn(axes_leaf, *matching leaves of rest)`` over a nested dict whose
    leaves are logical-axes tuples; ``rest`` are trees of the same nesting."""
    if _is_axes_leaf(tree):
        return fn(tree, *rest)
    return {k: _map_axes(fn, v, *(r[k] for r in rest))
            for k, v in tree.items()}


def tree_spec(logical_tree, rules: Dict[str, AxisVal], mesh):
    """Map a nested dict of logical-axis tuples to :class:`Sharding` s."""
    return _map_axes(lambda axes: spec_for(axes, rules, mesh), logical_tree)


def tree_spec_shaped(logical_tree, shapes_tree, rules: Dict[str, AxisVal],
                     mesh):
    """Shape-aware :func:`tree_spec`; ``shapes_tree`` holds shapes, or
    anything with a ``shape`` (tensors, ``PSpec`` leaves), nested like
    ``logical_tree``."""
    return _map_axes(
        lambda axes, s: Sharding(mesh, shaped_spec(
            tuple(getattr(s, 'shape', s)), axes, rules, mesh)),
        logical_tree, shapes_tree)


# The serving batch's mesh axes (``SERVE_RULES['batch']``; the trainer's
# data axes, ``training.train_step.DATA_AXES``, are the same pair).
BATCH_AXES: Tuple[str, ...] = ('pod', 'data')


def batch_coords(mesh, coords: Optional[Dict[str, int]] = None,
                 axes: Sequence[str] = BATCH_AXES) -> Tuple[int, int]:
    """(ranks over the mesh's ``axes``, the index of rank ``coords`` (the
    calling rank's by default) among them): row-major in the order ``axes``
    names them, the block order of ``local_bounds``."""
    coords = mesh.coords() if coords is None else coords
    n, index = 1, 0
    for a in axes:
        if a in mesh.axis_names:
            n *= mesh.shape[a]
            index = index * mesh.shape[a] + coords[a]
    return n, index


def row_block(rows: int, parts: int, index: int) -> Tuple[int, int]:
    """[lo, hi) of a dispatch's ``rows`` that batch rank ``index`` of
    ``parts`` computes: contiguous blocks in rank order, or every row where
    ``parts`` does not divide ``rows`` (replicated, as ``shaped_spec``
    drops an axis that does not divide its dimension)."""
    return block(rows, parts, index) if rows % parts == 0 else (0, rows)


def block(size: int, parts: int, index: int) -> Tuple[int, int]:
    """[lo, hi) of block ``index`` when ``size`` splits into ``parts``."""
    if size % parts:
        raise ValueError(f'{size} does not split into {parts} blocks')
    step = size // parts
    return index * step, (index + 1) * step


def check_spec(spec: Spec, what: str = '') -> Spec:
    """``spec`` itself, or ValueError where it names one mesh axis twice
    (``shaped_spec`` can: ROADMAP Queue 3; jax's ``NamedSharding`` refuses
    such a spec, and a placement must never be resolved from one)."""
    seen: set = set()
    for entry in spec:
        for a in ((entry,) if isinstance(entry, str) else tuple(entry or ())):
            if a in seen:
                raise ValueError(f'{what or "spec"} {spec} names mesh axis '
                                 f'{a!r} twice')
            seen.add(a)
    return spec


Interval = Tuple[int, int]


def _parts(out, dim: int, intervals):
    """``out``'s ``intervals`` of dimension ``dim``, concatenated in order
    (a tensor or a numpy array; a view where there is one interval)."""
    pick = [out[(slice(None),) * dim + (slice(lo, hi),)]
            for lo, hi in intervals]
    if len(pick) == 1:
        return pick[0]
    if isinstance(out, np.ndarray):
        return np.concatenate(pick, axis=dim)
    import torch
    return torch.cat(pick, dim=dim)


@dataclass(frozen=True)
class Block:
    """One rank's block of a global tensor of ``shape``: [lo, hi) on every
    dimension, or on a dimension of a packed leaf several disjoint [lo, hi)
    in global order, whose indices the block holds one after the other
    (zamba2's ``in_proj`` columns are [z | x | B | C | dt]: a rank holds
    its heads' z, x and dt and a share of B and C).  ``bounds[d]`` is
    ``(lo, hi)``, or a tuple of such pairs where there are several.  The
    trainer's placement under a mesh (heads, ZeRO-1 moment slices) is not
    always a spec's, so checkpoints read and write blocks."""
    shape: Tuple[int, ...]
    bounds: Tuple[Union[Interval, Tuple[Interval, ...]], ...]

    @classmethod
    def whole(cls, shape: Sequence[int]) -> 'Block':
        return cls(tuple(shape), tuple((0, int(n)) for n in shape))

    def intervals(self, dim: int) -> Tuple[Interval, ...]:
        """The [lo, hi) of dimension ``dim``, in global order."""
        b = self.bounds[dim]
        return b if isinstance(b[0], tuple) else (b,)

    @property
    def local_shape(self) -> Tuple[int, ...]:
        return tuple(sum(hi - lo for lo, hi in self.intervals(d))
                     for d in range(len(self.shape)))

    def is_whole(self) -> bool:
        return all(self.intervals(d) == ((0, n),)
                   for d, n in enumerate(self.shape))

    def take(self, full):
        """This block of the global ``full`` (a view where every dimension
        has one interval, else a copy)."""
        out = full
        for dim in range(len(self.shape)):
            out = _parts(out, dim, self.intervals(dim))
        return out

    def narrow(self, dim: int, lo: int, hi: int) -> 'Block':
        """This block with [lo, hi) (global bounds) on ``dim``."""
        return self.select(dim, ((lo, hi),))

    def select(self, dim: int, intervals: Sequence[Interval]) -> 'Block':
        """This block with ``intervals`` (global, disjoint, in order) on
        ``dim``."""
        iv = tuple((int(lo), int(hi)) for lo, hi in intervals)
        if any(a[1] > b[0] for a, b in zip(iv, iv[1:])) or \
                any(lo >= hi for lo, hi in iv):
            raise ValueError(f'intervals {iv} are not disjoint and ordered')
        return Block(self.shape, self.bounds[:dim]
                     + (iv[0] if len(iv) == 1 else iv,)
                     + self.bounds[dim + 1:])

    def cut(self, dim: int, parts: int, index: int) -> 'Block':
        """Block ``index`` of this block split into ``parts`` along
        ``dim``, which must hold one interval."""
        (lo, hi), *rest = self.intervals(dim)
        if rest:
            raise ValueError(f'dimension {dim} of {self} holds several '
                             'intervals: it is not cut')
        a, b = block(hi - lo, parts, index)
        return self.narrow(dim, lo + a, lo + b)

    def pieces(self):
        """[(a single-interval Block, the slices of this block's local
        tensor that hold it)]: one piece for each combination of the
        dimensions' intervals (a block of one interval a dimension is one
        piece, its whole local tensor)."""
        out = [((), ())]
        for dim in range(len(self.shape)):
            nxt, at = [], 0
            for lo, hi in self.intervals(dim):
                nxt += [(b + ((lo, hi),), s + (slice(at, at + hi - lo),))
                        for b, s in out]
                at += hi - lo
            out = nxt
        return [(Block(self.shape, b), s) for b, s in out]


def local_bounds(shape: Sequence[int], spec: Spec, mesh,
                 coords: Optional[Dict[str, int]] = None) -> Block:
    """The :class:`Block` of a global tensor of ``shape`` that rank
    ``coords`` (the calling rank's by default) holds under ``spec``.

    A dimension whose entry names mesh axes (a1, a2, ...) is split into
    prod(sizes) blocks, and the rank takes block
    ``(c1 * size2 + c2) * size3 + ...`` of its coordinates c on those axes:
    row-major in the order the entry names them, as ``NamedSharding``
    places blocks on the devices of a mesh."""
    coords = mesh.coords() if coords is None else coords
    sizes = dict(mesh.shape)
    out = Block.whole(shape)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        parts, index = 1, 0
        for a in names:
            parts *= sizes[a]
            index = index * sizes[a] + coords[a]
        out = out.cut(dim, parts, index)
    return out


def local_shard(full, spec: Spec, mesh, coords: Optional[Dict[str, int]] = None):
    """This rank's block of the global tensor ``full`` under ``spec``
    (:func:`local_bounds`); ``coords`` (axis -> coordinate) defaults to
    ``mesh.coords()``, the calling rank's.  A view (a basic slice: a tensor
    or a numpy array)."""
    return local_bounds(full.shape, spec, mesh, coords).take(full)
