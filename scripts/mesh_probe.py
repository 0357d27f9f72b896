#!/usr/bin/env python3
"""Which collectives each backend takes on the tensors the mesh serving
path hands it: two ranks through ``launch.ranks.run_ranks`` (sharing one
card, so gloo over CUDA tensors; on the CPU, gloo over host tensors), and
on a card one rank over NCCL.  Prints one line a collective and dtype:
``ok``, ``wrong`` or the error's first line.

    PYTHONPATH=src python3 scripts/mesh_probe.py [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / 'src'))


def _try(fn) -> str:
    try:
        return 'ok' if fn() else 'wrong'
    except Exception as e:          # noqa: BLE001 -- the probe's result
        return f'{type(e).__name__}: {str(e).splitlines()[0][:120]}'


def probe(rank: int, device_type: str) -> dict:
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    n = dist.get_world_size()
    mesh = make_mesh((n,), ('model',), device=device_type)
    group = mesh.group('model')
    dev = mesh.device
    out = {'backend': str(dist.get_backend(group)), 'device': str(dev),
           'coords': mesh.coords()}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split('.')[-1]

        def all_reduce():
            x = torch.full((4, 8), float(rank + 1), device=dev, dtype=dt)
            dist.all_reduce(x, group=group)
            return bool((x == n * (n + 1) / 2).all())

        def all_gather():
            x = torch.full((2, 3), float(rank), device=dev, dtype=dt)
            parts = [torch.empty_like(x) for _ in range(n)]
            dist.all_gather(parts, x, group=group)
            return all(bool((p == r).all()) for r, p in enumerate(parts))

        def all_gather_into_tensor():
            x = torch.full((2, 3), float(rank), device=dev, dtype=dt)
            y = torch.empty((2 * n, 3), device=dev, dtype=dt)
            dist.all_gather_into_tensor(y, x, group=group)
            return all(bool((y[2 * r:2 * r + 2] == r).all())
                       for r in range(n))

        def broadcast():
            x = torch.full((5,), float(rank + 7), device=dev, dtype=dt)
            dist.broadcast(x, src=0, group=group)
            return bool((x == 7).all())

        for fn in (all_reduce, all_gather, all_gather_into_tensor, broadcast):
            out[f'{fn.__name__}/{name}'] = _try(fn)
    obj = [{'rank': rank}] if rank == 0 else [None]
    out['broadcast_object_list'] = _try(
        lambda: dist.broadcast_object_list(obj, src=0) or obj[0] == {'rank': 0})
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('--device', default='cuda')
    a = ap.parse_args()
    from repro_torch.launch.ranks import run_ranks

    store = Path(tempfile.mkdtemp(prefix='mesh_probe_'))
    runs = {'2 ranks': run_ranks(probe, 2, store_dir=store,
                                 device_type=a.device, args=(a.device,),
                                 timeout_s=60)}
    if a.device == 'cuda':
        runs['1 rank'] = run_ranks(probe, 1, store_dir=store,
                                   device_type='cuda', args=('cuda',),
                                   timeout_s=60)
    print(json.dumps(runs, indent=1))
    return 0


if __name__ == '__main__':
    sys.exit(main())
