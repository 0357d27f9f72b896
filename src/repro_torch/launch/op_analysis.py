"""Per-rank cost count of one eager PyTorch program, for the dry-run's
roofline (``launch/dryrun.py``): the port's counterpart of the reference's
``launch/hlo_analysis.py``.

The reference parses the optimized HLO text of the compiled SPMD program.
The port has no HLO: a rank's step is the sequence of ATen ops it
dispatches, so :class:`OpCounter` (a ``TorchDispatchMode``) counts them as
they run -- on ``meta`` tensors for a shape-only count (no data, no
device), beside a fake process group for the collectives.  What it counts,
per rank, with the reference's rules where they carry over:

- **product FLOPs:** 2 x |result| x contraction for ``mm``, ``addmm``,
  ``bmm``, ``baddbmm`` and ``convolution`` (einsum and matmul reach these);
  elementwise work is ignored (standard MFU accounting, as the reference);
- **materialized traffic of an eager program:** each op charges its
  inputs plus its outputs.  It is slice-aware, as the reference is:
  ``index``, ``gather``, ``index_select`` and ``embedding`` charge 2x the
  result, ``index_put`` / ``scatter`` / ``index_add`` / ``index_copy``
  2x the update, ``copy_`` 2x the source; views and allocations are free.
  Eager PyTorch fuses nothing, so this is the traffic of the program as it
  runs, where the reference's counts XLA's fused kernels;
- **collectives:** payload bytes by kind (the result's: the gathered
  tensor of an all-gather), wire bytes by :func:`wire_factor` over the
  group's size, and a count;
- **temp:** the peak of the bytes of live intermediates (tensors an op
  made, not views, alive until the program drops them): the estimate of
  the reference's ``temp_size_in_bytes``;
- **reads:** which tensors the program reads (:meth:`OpCounter.read`):
  jax prunes the arguments a compiled program never reads, so the
  dry-run's argument bytes leave them out too.  Being overwritten whole
  (the destination of ``copy_``) is not a read.

A size a data-dependent op makes (a boolean mask's selection; the prefill
write's dropped page ids) is counted at its upper bound, every element
kept: meta tensors hold no data, so :class:`OpCounter` hands such an op
index tensors of that size (:func:`_mask_free`).  The output shapes of an
op that makes a new tensor are remembered by its arguments' shapes,
strides and values, so a layer's ops are shaped once, not once a layer
(:meth:`OpCounter._run`).
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

# c10d's ops (what torch.distributed's calls dispatch) by the reference's
# collective kinds
_C10D_KINDS = {
    'allreduce_': 'all-reduce', 'allreduce_coalesced_': 'all-reduce',
    '_allgather_base_': 'all-gather', 'allgather_': 'all-gather',
    'allgather_into_tensor_coalesced_': 'all-gather',
    '_reduce_scatter_base_': 'reduce-scatter',
    'reduce_scatter_': 'reduce-scatter',
    'reduce_scatter_tensor_coalesced_': 'reduce-scatter',
    'alltoall_': 'all-to-all', 'alltoall_base_': 'all-to-all',
    'send': 'collective-permute', 'recv_': 'collective-permute',
    'broadcast_': 'collective-permute',
}

_PRODUCTS = {aten.mm.default, aten.addmm.default, aten.bmm.default,
             aten.baddbmm.default, aten.convolution.default}
_SLICE_READS = {aten.index.Tensor, aten.gather.default,
                aten.index_select.default, aten.embedding.default}
# in-place or functional writes of an update (index of the update operand)
_UPDATES = {aten.index_put_.default: 2, aten.index_put.default: 2,
            aten._index_put_impl_.default: 2,
            aten.scatter_.src: 3, aten.scatter.src: 3,
            aten.scatter_add_.default: 3, aten.scatter_add.default: 3,
            aten.index_add_.default: 3, aten.index_add.default: 3,
            aten.index_copy_.default: 3, aten.index_copy.default: 3}
_ALLOCS = {aten.empty.memory_format, aten.empty_strided.default,
           aten.new_empty.default, aten.new_empty_strided.default,
           aten.empty_like.default, aten.lift_fresh.default,
           aten.detach.default, aten.alias.default}


def wire_factor(kind: str, n: int) -> float:
    """Ring-algorithm wire bytes per payload byte per device (the
    reference's)."""
    if n <= 1:
        return 0.0
    if kind == 'all-reduce':
        return 2.0 * (n - 1) / n
    if kind in ('all-gather', 'reduce-scatter', 'all-to-all'):
        return (n - 1) / n
    return 1.0  # collective-permute


@dataclass
class ModuleCosts:
    """One rank's program: the reference's fields, plus ``temp_bytes``
    (the peak of live intermediates)."""
    flops: float = 0.0
    traffic_bytes: float = 0.0
    coll_payload: Dict[str, float] = field(default_factory=dict)
    coll_wire: float = 0.0
    coll_count: float = 0.0
    temp_bytes: int = 0


_MASKED = {aten.index.Tensor, aten.index_put_.default, aten.index_put.default,
           aten._index_put_impl_.default}


def _mask_free(func, args):
    """``args`` of an indexing op with each boolean mask among its indices
    replaced by long indices selecting every element (on meta tensors a
    mask's selection has no size)."""
    if func not in _MASKED or not any(
            i is not None and i.dtype == torch.bool for i in args[1]):
        return args
    indices = args[1]
    out = []
    for i in indices:
        if i is None or i.dtype != torch.bool:
            out.append(i)
            continue
        n = i.numel()
        out += [torch.empty((n,), dtype=torch.long, device=i.device)
                for _ in range(i.dim())]
    return (args[0], out) + tuple(args[2:])


_PLAIN = (int, float, bool, str, type(None), torch.dtype, torch.device,
          torch.layout, torch.memory_format)


def _tensors(x) -> list:
    """The tensors in an op's arguments or results (nested in lists,
    tuples and dicts)."""
    out = []
    _collect(x, out)
    return out


def _collect(x, out: list) -> None:
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for a in x:
            if isinstance(a, torch.Tensor):
                out.append(a)
            elif isinstance(a, (list, tuple, dict)):
                _collect(a, out)
    elif isinstance(x, dict):
        _collect(tuple(x.values()), out)


def _key(x):
    """A hashable description of an op's argument, or None where there is
    none (then the op is not remembered)."""
    if isinstance(x, torch.Tensor):
        return (x.shape, x.stride(), x.dtype, x.device)
    if isinstance(x, (list, tuple)):
        parts = []
        for a in x:
            if a is None:
                parts.append(None)
                continue
            p = _key(a)
            if p is None:
                return None
            parts.append(p)
        return tuple(parts)
    return (type(x), x) if isinstance(x, _PLAIN) else None


def _fresh(func) -> bool:
    """Whether ``func`` returns new tensors only, mutating nothing."""
    schema = func._schema
    return (func.namespace == 'aten' and not func.is_view
            and not schema.is_mutable and len(schema.returns) > 0
            and all(r.alias_info is None and str(r.type) == 'Tensor'
                    for r in schema.returns))


class OpCounter(TorchDispatchMode):
    """Counts the ops dispatched inside it into :attr:`costs`."""

    def __init__(self):
        super().__init__()
        self._memo: dict = {}
        self._fresh: dict = {}
        self.costs = ModuleCosts()
        self._live = 0
        self._refs: dict = {}          # weak references to held tensors
        self._read: set = set()

    @staticmethod
    def nbytes(t) -> int:
        return t.numel() * t.element_size() \
            if isinstance(t, torch.Tensor) else 0

    def read(self, t: torch.Tensor) -> bool:
        """Whether the program read ``t`` (or a view of it)."""
        return id(t) in self._read

    # -- the count -----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is aten.nonzero.default:
            t = args[0]
            return torch.empty((t.numel(), t.dim()), dtype=torch.long,
                               device=t.device)
        if func in _MASKED:
            args = _mask_free(func, args)
        out = self._run(func, args, kwargs)
        namespace = func.namespace
        if func.is_view or namespace not in ('aten', 'c10d'):
            return out
        ins = _tensors(args)
        if kwargs:
            ins += _tensors(kwargs)
        read = self._read
        for t in (ins[1:] if func is aten.copy_.default else ins):
            base = t._base
            read.add(id(t if base is None else base))
        if namespace == 'c10d':
            self._collective(func, args, out)
        else:
            self._op(func, args, ins, out)
        return out

    def _run(self, func, args, kwargs):
        """``func(*args, **kwargs)``; where it makes new tensors only, their
        shapes are remembered by the arguments' description and made
        again (empty, on the same device) when it comes back."""
        fresh = self._fresh.get(func)
        if fresh is None:
            fresh = self._fresh[func] = _fresh(func)
        if not fresh:
            return func(*args, **kwargs)
        key = _key(args)
        if key is not None and kwargs:
            kw = _key(tuple(sorted(kwargs.items())))
            key = None if kw is None else (key, kw)
        if key is None:
            return func(*args, **kwargs)
        key = (func, key)
        shapes = self._memo.get(key)
        if shapes is not None:
            outs = [torch.empty_strided(*s, dtype=d, device=dev)
                    for *s, d, dev in shapes]
            return outs[0] if len(outs) == 1 else tuple(outs)
        out = func(*args, **kwargs)
        outs = out if isinstance(out, tuple) else (out,)
        self._memo[key] = [(t.shape, t.stride(), t.dtype, t.device)
                           for t in outs]
        return out

    def _op(self, func, args, ins, out) -> None:
        c = self.costs
        if func in _PRODUCTS:
            c.flops += self._product_flops(func, args, out)
        if func in _ALLOCS:
            return
        outs = [out] if isinstance(out, torch.Tensor) else _tensors(out)
        nbytes = self.nbytes
        if func in _SLICE_READS:
            c.traffic_bytes += 2 * sum(map(nbytes, outs))
        elif func in _UPDATES:
            c.traffic_bytes += 2 * nbytes(args[_UPDATES[func]])
        elif func is aten.copy_.default:
            c.traffic_bytes += 2 * nbytes(args[1])
        else:
            c.traffic_bytes += sum(map(nbytes, ins)) + sum(map(nbytes, outs))
        ids = {id(a) for a in ins}
        for t in outs:
            if id(t) not in ids:
                self._hold(t)

    def _product_flops(self, func, args, out) -> float:
        if func is aten.convolution.default:
            return 2.0 * out.numel() * args[1][0].numel()
        a = args[1] if func in (aten.addmm.default,
                                aten.baddbmm.default) else args[0]
        return 2.0 * out.numel() * a.shape[-1]

    def _hold(self, t: torch.Tensor) -> None:
        """Count ``t``'s bytes live until it is freed."""
        n = t.numel() * t.element_size()
        self._live += n
        if self._live > self.costs.temp_bytes:
            self.costs.temp_bytes = self._live
        ref = weakref.ref(t, self._free)
        self._refs[ref] = n

    def _free(self, ref) -> None:
        self._live -= self._refs.pop(ref)

    def _collective(self, func, args, out) -> None:
        name = func._schema.name.split('::')[-1]
        kind = _C10D_KINDS.get(name, name)
        group = next((a for a in args if hasattr(a, 'size')
                      and not isinstance(a, torch.Tensor)), None)
        n = group.size() if group is not None else 2
        tensors = _tensors(args)
        if kind in ('all-gather', 'reduce-scatter'):
            payload = self.nbytes(tensors[0])         # the result buffer
        else:
            payload = sum(map(self.nbytes, tensors))
        c = self.costs
        c.coll_payload[kind] = c.coll_payload.get(kind, 0.0) + payload
        c.coll_wire += payload * wire_factor(kind, n)
        c.coll_count += 1
        c.traffic_bytes += 2 * payload
