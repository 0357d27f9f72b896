"""Summation-order nulls: contexts under which the port computes the same
function with its products summed in another order.

A comparison of two implementations that differ only in the order of their
sums (a tensor-parallel step against one device's, a kernel against its
plain version) can be held to how far such a null moves the result: a
correct implementation that rounds otherwise.  Each context replaces the
product functions (``torch.matmul``, ``torch.mm``, ``torch.bmm`` and the
tensor methods, ``@`` among them) for as long as it is open, in every
thread, so that a checkpointed layer recomputed in the backward takes the
same products; autograd's own backward products are not replaced.
"""
from __future__ import annotations

import contextlib

import torch

# (owner, name) of every product function replaced
PRODUCTS = ((torch, 'matmul'), (torch, 'mm'), (torch, 'bmm'),
            (torch.Tensor, 'matmul'), (torch.Tensor, '__matmul__'),
            (torch.Tensor, 'mm'), (torch.Tensor, 'bmm'))
SPLITS = ('sum', 'columns')


@contextlib.contextmanager
def halved_products(dtype: torch.dtype = torch.bfloat16, split: str = 'sum'):
    """While inside, every product of two ``dtype`` tensors whose split
    dimension is even runs as two products:

    - ``split='sum'``: the inner dimension in two halves, each over exact
      products in f32, the halves added in f32 and rounded once to the
      output dtype (``out_dtype`` where the call names one): the rounding
      a row-parallel product's f32 sum over two ranks adds;
    - ``split='columns'``: each half of the output columns by a product of
      its own, every element's sum as before but in the GEMMs a
      column-parallel rank runs, whose tiles may sum in another order.
    """
    if split not in SPLITS:
        raise ValueError(f'split must be one of {SPLITS}, not {split!r}')

    def halves(orig):
        def product(x, w, **kwargs):
            if not (torch.is_tensor(x) and torch.is_tensor(w)
                    and x.dtype == w.dtype == dtype and w.dim() >= 2):
                return orig(x, w, **kwargs)
            if split == 'sum' and x.shape[-1] % 2 == 0:
                k = x.shape[-1] // 2
                parts = [orig(x[..., i:i + k].float(),
                              w[..., i:i + k, :].float()) for i in (0, k)]
                return (parts[0] + parts[1]).to(
                    kwargs.get('out_dtype') or x.dtype)
            if split == 'columns' and w.shape[-1] % 2 == 0:
                n = w.shape[-1] // 2
                return torch.cat([orig(x, w[..., :n], **kwargs),
                                  orig(x, w[..., n:], **kwargs)], dim=-1)
            return orig(x, w, **kwargs)
        return product

    saved = [(owner, name, getattr(owner, name)) for owner, name in PRODUCTS]
    for owner, name, orig in saved:
        setattr(owner, name, halves(orig))
    try:
        yield
    finally:
        for owner, name, orig in saved:
            setattr(owner, name, orig)
