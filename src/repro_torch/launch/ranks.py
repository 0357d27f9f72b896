"""Start N ranks of one program, each a process of its own.

:func:`run_ranks` spawns ``n`` processes with the ``spawn`` start method
(never ``fork``: a parent may hold threads, and the tests' parent holds
JAX's), joins them into one process group through a ``FileStore`` under a
directory the caller gives (so concurrent runs never race for a port), runs
``fn(rank, *args)`` in each and returns the results in rank order.
:class:`RankPool` keeps its ``n`` ranks and their process group across
several such functions, run one after another: a program that runs many
functions on the same ranks starts them once, and may start one
(:meth:`RankPool.submit`) and go on with other work before it collects
its results (:meth:`RankPool.collect`).

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

import gc
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
               device_type: str, timeout_s: float, tasks, results) -> None:
    """A rank's process: join the group, then run each ``(fn, args)`` that
    ``tasks`` delivers until None, reporting each result (or the failure,
    after which the rank exits)."""
    import torch.distributed as dist

    try:
        if device_type == 'cuda':
            torch.cuda.set_device(rank_device(rank, device_type))
        store = dist.FileStore(store_path, n)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=n,
                                timeout=timedelta(seconds=timeout_s))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    try:
        while (task := tasks.get()) is not None:
            fn, args = task
            try:
                out = fn(rank, *args)
            except BaseException:
                results.put((rank, False, traceback.format_exc()))
                raise
            results.put((rank, True, out))
            del out, task
            gc.collect()
            if device_type == 'cuda':
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


class RankPool:
    """``n`` ranks, each a process of its own in one ``n``-rank process
    group (the module docstring), that run one function after another:
    :meth:`run` returns ``[fn(0, *args), ..., fn(n - 1, *args)]``.
    ``timeout_s`` bounds the group's collectives and store waits, and is
    :meth:`run`'s default limit.  A failed or overdue :meth:`run` closes
    the pool (every rank terminated) and raises; :meth:`close` ends it
    (also as a context manager)."""

    def __init__(self, n: int, *, store_dir, device_type: str = 'cpu',
                 backend: Optional[str] = None,
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        import multiprocessing as mp

        ctx = mp.get_context('spawn')
        self.n, self.timeout_s = n, timeout_s
        backend = backend or pick_backend(n, device_type)
        os.makedirs(store_dir, exist_ok=True)
        store_path = os.path.join(tempfile.mkdtemp(dir=store_dir), 'store')
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(n)]
        self._procs = [ctx.Process(target=_rank_main, daemon=True,
                                   args=(r, n, store_path, backend,
                                         device_type, timeout_s,
                                         self._tasks[r], self._results))
                       for r in range(n)]
        for p in self._procs:
            p.start()
        self.closed = self.pending = False

    def run(self, fn: Callable, args: Sequence[Any] = (),
            timeout_s: Optional[float] = None) -> List[Any]:
        """``fn`` and ``args`` are pickled (``fn`` by import path: a
        module-level function); so is each result.  Raises RuntimeError
        with the failing rank's traceback, or on the time limit
        (``timeout_s``, the pool's by default), after terminating every
        rank."""
        self.submit(fn, args)
        return self.collect(timeout_s)

    def submit(self, fn: Callable, args: Sequence[Any] = ()) -> None:
        """Start ``fn(rank, *args)`` on every rank and return at once
        (:meth:`run`'s first half): the caller goes on while the ranks
        work, and :meth:`collect` waits for their results."""
        if self.closed:
            raise RuntimeError('the rank pool is closed')
        if self.pending:
            raise RuntimeError('collect the ranks\' last results first')
        for q in self._tasks:
            q.put((fn, tuple(args)))
        self.pending = True

    def collect(self, timeout_s: Optional[float] = None) -> List[Any]:
        """The results of the function :meth:`submit` started, in rank
        order, within ``timeout_s`` (the pool's by default) of this call
        (:meth:`run`'s second half, its failures)."""
        if not self.pending:
            raise RuntimeError('no function submitted to collect')
        self.pending = False
        limit = self.timeout_s if timeout_s is None else timeout_s
        out: List[Any] = [None] * self.n
        reported: set = set()
        deadline = time.monotonic() + limit + 30
        try:
            # drain the queue: a rank blocks on a full pipe until its
            # result is read
            while len(reported) < self.n:
                dead = [(r, p.exitcode) for r, p in enumerate(self._procs)
                        if r not in reported and p.exitcode is not None]
                try:
                    # a rank that exited has flushed its result, if it had
                    # one
                    rank, ok, value = self._results.get(
                        timeout=2 if dead else 0.5)
                except queue.Empty:
                    if dead:            # died before it could report
                        raise RuntimeError(
                            f'ranks exited with {dead}') from None
                    if time.monotonic() > deadline:
                        raise RuntimeError(
                            f'ranks still running after {limit + 30:.0f} '
                            f's: {sorted(set(range(self.n)) - reported)}'
                        ) from None
                    continue
                if not ok:
                    raise RuntimeError(f'rank {rank} failed:\n{value}')
                out[rank] = value
                reported.add(rank)
        except BaseException:
            self._stop()
            raise
        return out

    def close(self) -> None:
        """End every rank: each leaves the group and exits.  Raises
        RuntimeError where one did not exit, or exited with an error."""
        if self.closed:
            return
        for q in self._tasks:
            q.put(None)
        for p in self._procs:
            p.join(timeout=30)
        alive = [r for r, p in enumerate(self._procs) if p.is_alive()]
        bad = [(r, p.exitcode) for r, p in enumerate(self._procs)
               if p.exitcode]
        self._stop()
        if alive:
            raise RuntimeError(f'ranks {alive} did not exit')
        if bad:
            raise RuntimeError(f'ranks exited with {bad}')

    def _stop(self) -> None:
        """Terminate every rank still running (after a failure, or once
        they were asked to exit) and release the queues."""
        self.closed = True
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        for q in (self._results, *self._tasks):
            q.close()

    def __enter__(self) -> 'RankPool':
        return self

    def __exit__(self, *exc) -> None:
        if exc[0] is None:
            self.close()
        else:
            self._stop()


def run_ranks(fn: Callable, n: int, *, store_dir, device_type: str = 'cpu',
              backend: Optional[str] = None, args: Sequence[Any] = (),
              timeout_s: float = DEFAULT_TIMEOUT_S) -> List[Any]:
    """``[fn(0, *args), ..., fn(n - 1, *args)]``, each in a process of its
    own inside an ``n``-rank process group started for this call (a
    :class:`RankPool` of one function).  Raises RuntimeError with the
    failing rank's traceback, or on the time limit, after terminating
    every rank."""
    with RankPool(n, store_dir=store_dir, device_type=device_type,
                  backend=backend, timeout_s=timeout_s) as pool:
        return pool.run(fn, args)
