"""Start N ranks of one program, each a process of its own.

:func:`run_ranks` spawns ``n`` processes with the ``spawn`` start method
(never ``fork``: a parent may hold threads, and the tests' parent holds
JAX's), joins them into one process group through a ``FileStore`` under a
directory the caller gives (so concurrent runs never race for a port), runs
``fn(rank, *args)`` in each and returns the results in rank order.

Backends (:func:`pick_backend`):

- on the CPU, ``gloo``;
- on CUDA with a card for each rank, ``cpu:gloo,cuda:nccl``: collectives
  on device tensors go over NCCL, host tensors (the engine's dispatch
  messages, weight shards staged through the host) over gloo;
- on CUDA with ranks sharing a card, ``gloo``: NCCL refuses two ranks on
  one device.  gloo takes CUDA tensors for the collectives the serving
  path runs (``distributed/tp.py`` says which go through host memory).

Every wait has a limit: the process group's collectives and store waits
(``timeout_s``), and the parent's wait for the ranks' results.  A rank that
fails or hangs fails the run; the parent then terminates every rank it
started and raises, so a hung rank never hangs the caller.
"""
from __future__ import annotations

import os
import queue
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, List, Optional, Sequence

import torch

DEFAULT_TIMEOUT_S = 120.0


def pick_backend(n: int, device_type: str) -> str:
    if device_type == 'cpu':
        return 'gloo'
    if torch.cuda.device_count() >= n:
        return 'cpu:gloo,cuda:nccl'
    return 'gloo'


def rank_device(rank: int, device_type: str) -> torch.device:
    """The device rank ``rank`` computes on: its own card where there is a
    card for each rank, else the one card every rank shares."""
    if device_type == 'cpu':
        return torch.device('cpu')
    return torch.device('cuda', rank % torch.cuda.device_count())


def _rank_main(rank: int, n: int, store_path: str, backend: str,
               device_type: str, timeout_s: float, fn: Callable,
               args: Sequence[Any], results) -> None:
    import torch.distributed as dist

    try:
        if device_type == 'cuda':
            torch.cuda.set_device(rank_device(rank, device_type))
        store = dist.FileStore(store_path, n)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=n,
                                timeout=timedelta(seconds=timeout_s))
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn: Callable, n: int, *, store_dir, device_type: str = 'cpu',
              backend: Optional[str] = None, args: Sequence[Any] = (),
              timeout_s: float = DEFAULT_TIMEOUT_S) -> List[Any]:
    """``[fn(0, *args), ..., fn(n - 1, *args)]``, each in a process of its
    own inside an ``n``-rank process group.  ``fn`` and ``args`` are pickled
    (``fn`` by import path: a module-level function); so is each result.
    Raises RuntimeError with the failing rank's traceback, or on the time
    limit, after terminating every rank."""
    import multiprocessing as mp

    ctx = mp.get_context('spawn')
    backend = backend or pick_backend(n, device_type)
    os.makedirs(store_dir, exist_ok=True)
    store_path = os.path.join(tempfile.mkdtemp(dir=store_dir), 'store')
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n, store_path, backend, device_type,
                               timeout_s, fn, tuple(args), results))
             for r in range(n)]
    for p in procs:
        p.start()
    out: List[Any] = [None] * n
    reported: set = set()
    deadline = time.monotonic() + timeout_s + 30
    try:
        # drain the queue before joining: a rank blocks on a full pipe
        # until its result is read
        while len(reported) < n:
            dead = [(r, p.exitcode) for r, p in enumerate(procs)
                    if r not in reported and p.exitcode is not None]
            try:
                # a rank that exited has flushed its result, if it had one
                rank, ok, value = results.get(timeout=2 if dead else 0.5)
            except queue.Empty:
                if dead:            # died before it could report
                    raise RuntimeError(f'ranks exited with {dead}') from None
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f'ranks still running after {timeout_s + 30:.0f} '
                        f's: {sorted(set(range(n)) - reported)}') from None
                continue
            if not ok:
                raise RuntimeError(f'rank {rank} failed:\n{value}')
            out[rank] = value
            reported.add(rank)
        for p in procs:
            p.join(timeout=30)
        alive = [r for r, p in enumerate(procs) if p.is_alive()]
        if alive:
            raise RuntimeError(f'ranks {alive} did not exit')
        bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
        if bad:
            raise RuntimeError(f'ranks exited with {bad}')
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        results.close()
