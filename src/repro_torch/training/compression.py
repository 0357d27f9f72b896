"""int8-compressed gradient all-reduce with error feedback, ported from the
reference's ``training/compression.py``.

The data-parallel gradient reduce moves ``params x 4`` bytes a step a rank;
quantizing to int8 cuts the collective's bytes 4x (2x against bf16).
Scheme, as the reference's:

- per-leaf symmetric quantization at one scale for every rank: the max
  |g| all-reduced by MAX (one f32 scalar), scale = max|g| / (127 / n), so
  the *sum* over the n ranks still fits int8 and the int8 payload is what
  the all-reduce SUM carries;
- error feedback: the quantization residual is carried to the next step,
  so compression error stays O(1) instead of growing with the steps.

The reference runs this under ``manual_shard_map`` over the data axes.
Here each rank runs it over its own gradients, and the collectives run
over the data axes' process group (``Mesh.group``); a leaf split over
``model`` is reduced block by block, each block over its own data line.
Like the reference's, the train step does not call it.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.training import tree as tr


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum_leaf(g, err, group, n_shards: int):
    """One leaf: error-feedback int8 quantize -> all-reduce SUM ->
    dequantize.  Two collective rounds over ``group``: the MAX of each
    rank's max |g| (one f32 scalar), so every rank quantizes at the same
    scale, then the SUM of the int8 payload (1 / n of the int8 range a
    rank, so the sum cannot overflow).  The order is the reference's:
    round half to even, clip to +-127 / n, cast (truncating) to int8.
    Returns (mean-reduced f32 gradient, new error residual)."""
    dist = torch.distributed
    g = g.to(torch.float32) + err
    amax = torch.max(torch.abs(g))
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    qmax = 127.0 / max(n_shards, 1)
    # tensor divisors: a Python-float divisor may become a product by its
    # reciprocal, not the reference's one rounding
    scale = torch.where(amax > 0, amax / torch.full_like(amax, qmax),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(g / scale), -qmax, qmax).to(torch.int8)
    new_err = g - dequantize(q, scale)
    dist.all_reduce(q, group=group)                 # int8 on the wire
    return (dequantize(q, scale) / torch.full_like(amax, float(n_shards)),
            new_err)


def make_compressed_allreduce(mesh, data_axes: Sequence[str] = ('pod', 'data')):
    """``fn(grads, err) -> (reduced grads, new err)`` over this rank's
    gradient tree (each leaf the mean over the data axes' ranks) and its
    residuals (:func:`init_error_state`).  Every rank of the mesh calls
    ``fn`` at the same point; the data axes' group is made here."""
    axes = tuple(a for a in data_axes if a in mesh.axis_names)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    group = mesh.group(axes)

    def reduce_fn(grads, err):
        out = [compressed_psum_leaf(g, e, group, n)
               for g, e in zip(tr.leaves(grads), tr.leaves(err))]
        return (tr.unflatten(grads, [o[0] for o in out]),
                tr.unflatten(grads, [o[1] for o in out]))

    return reduce_fn


def init_error_state(grads_like):
    """f32 zeros shaped like every leaf (the first round's residual)."""
    return tr.zeros_f32(grads_like)
