#!/usr/bin/env python3
"""Which operations of a full-width qwen3-0.6b bf16 decode step change bits
when they are split as two tensor-parallel ranks split them: q/k/v and
gate/up by column blocks, the attention output and down projections by row
blocks (each block a GEMM writing f32, the blocks added in f32, rounded
once), the q/k norms, RoPE and the paged attention a block of heads at a
time, the head's scores a vocabulary block at a time.  Layer 0's weights,
random activations, at 1 and 3 rows.  Then one whole decode step of the
single-device plain path against the same step under
``chip_smoke.MeshOrders`` (every split at once): the products it replaced
and how far the scores moved.  Prints one line an operation: bit-equal or
not, the largest difference and how many elements differ.

    PYTHONPATH=src python3 scripts/tp_order_probe.py      # needs a card
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / 'src')]

import chip_smoke as cs  # noqa: E402


def compare(name: str, a: torch.Tensor, b: torch.Tensor) -> None:
    print(f'{name:24s} bit-equal {str(torch.equal(a, b)):5s}  max |diff| '
          f'{(a.float() - b.float()).abs().max().item():.3e}  differing '
          f'{int((a != b).sum())} of {a.numel()}')


def halves(fn, *xs, dims):
    """``fn`` on each half of its operands (split along ``dims``, made
    contiguous as a rank holds them)."""
    return [fn(*(c.contiguous() for c in part)) for part in
            zip(*(x.chunk(2, d) for x, d in zip(xs, dims)))]


def main() -> None:
    from repro_torch.configs import get_config
    from repro_torch.kernels.sampling.ref import unembed_scores
    from repro_torch.models import common as cm
    from repro_torch.models.api import build_model
    from repro_torch.models.dense import head_of

    if not torch.cuda.is_available():
        sys.exit('a card is needed: the f32-output bf16 GEMM is CUDA only')
    dev, bf16 = 'cuda', torch.bfloat16
    print(cs.card_identity())
    cfg = get_config('qwen3-0.6b')
    model = build_model(cfg)
    params = model.init_params(0, device=dev)
    lp = cm.layer_views(params)[0]
    gen = torch.Generator(device=dev).manual_seed(1)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(bf16)

    for b in (1, 3):
        print(f'--- {b} row(s)')
        x = rand(b, 1, cfg.d_model)
        for k in ('wq', 'wk', 'wv', 'wg', 'wu'):
            compare(f'column {k}', x @ lp[k], cs.MeshOrders._column(
                [c.contiguous() for c in lp[k].chunk(2, 1)])(x))
        for k, width in (('wo', cfg.n_heads * cfg.hd), ('wd', cfg.d_ff)):
            y = rand(b, 1, width)
            compare(f'row {k}', y @ lp[k], cs.MeshOrders._row(
                [c.contiguous() for c in lp[k].chunk(2, 0)])(y))
        for k, heads in (('q_norm', cfg.n_heads), ('k_norm', cfg.n_kv_heads)):
            t = rand(b, 1, heads, cfg.hd)
            norm = lambda u: cm.rms_norm(u, lp[k], cfg.norm_eps)  # noqa: E731
            compare(k, norm(t), torch.cat(halves(norm, t, dims=[2]), 2))
        q = rand(b, 1, cfg.n_heads, cfg.hd)
        pos = torch.arange(b, device=dev)[:, None] + 40
        rot = lambda u: cm.rope(u, pos, cfg.rope_theta)  # noqa: E731
        compare('rope', rot(q), torch.cat(halves(rot, q, dims=[2]), 2))
        h = rand(b, cfg.d_model)
        head = head_of(cfg, params)
        score = lambda w: unembed_scores(h, w)  # noqa: E731
        compare('head scores', score(head),
                torch.cat(halves(score, head, dims=[0]), -1))
        n_pages, maxp = 1 + b * 6, 6
        pk, pv = (rand(n_pages, cfg.page_size, cfg.n_kv_heads, cfg.hd)
                  for _ in range(2))
        pt = torch.tensor((np.random.default_rng(0).permutation(n_pages - 1)
                           + 1).reshape(b, maxp).astype(np.int32), device=dev)
        lengths = torch.tensor(np.linspace(40, 90, b).astype(np.int32),
                               device=dev)
        attend = lambda qq, kk, vv: cm.paged_attention_ref(  # noqa: E731
            qq, kk, vv, pt, lengths)
        compare('paged attention', attend(q[:, 0], pk, pv), torch.cat(
            halves(attend, q[:, 0], pk, pv, dims=[1, 2, 2]), 1))

    orders = cs.MeshOrders(params, cfg, 2)
    hits = [0]
    for key, fn in list(orders.plans.items()):
        def counted(x, fn=fn):
            hits[0] += 1
            return fn(x)
        orders.plans[key] = counted
    b, n_pages, maxp = 3, 19, 6
    cache = model.init_cache(engine_pages=n_pages, device=dev)
    for pool in cache.values():
        pool.normal_(generator=gen)
    batch = {'tokens': torch.tensor([5, 7, 11], device=dev),
             'positions': torch.tensor([40, 60, 90], dtype=torch.int32,
                                       device=dev),
             'page_table': torch.tensor(
                 (np.random.default_rng(0).permutation(n_pages - 1) + 1)
                 .reshape(b, maxp).astype(np.int32), device=dev)}

    def step():
        c = {k: v.clone() for k, v in cache.items()}
        return model.decode_fn(params, c, batch)[1]

    plain = step()
    with orders.active():
        split = step()
    print(f'--- one decode step, {b} rows: {hits[0]} products split (7 a '
          f'layer: {7 * cfg.n_layers})')
    compare('scores', plain, split)


if __name__ == '__main__':
    main()
