"""AsyncNodeDriver — one event loop owns the runtime.

The serving front-end's execution model: a single asyncio task pumps
``NodeOrchestrator.step()`` cooperatively with request intake (no
thread-per-request, no locks — every handler and the pump interleave at
``await`` points on one loop).  The pump yields to the loop after every
node tick, so SSE writers flush token deltas and new submissions land
between dispatches; when the node goes idle it parks on an event and is
kicked by the next submission, burning neither CPU nor virtual time.

Token delivery is a *tap*, not an engine hook: after each tick the driver
diffs every streamed request's ``generated`` list against what its
:class:`OnlineStream` has already emitted and pushes the deltas.  The
engine (and the Valve patch surface) stays untouched — streaming is a
front-end concern, and the ≤ 13-LOC framework patch cannot grow.

Cancellation (client disconnect, batch abort) routes to
:meth:`Engine.cancel`: the lease is released on the spot, which drops the
invalidation route with it (route lifetime == lease lifetime), so a
dropped stream can never pin reserved KV pages and starve MIAD.

Clock discipline: everything that waits goes through :func:`clock_sleep`
— under a :class:`~repro_torch.core.clock.VirtualClock` waits *advance* the
clock instead of sleeping, so the protocol tests and the trace-replay
load generator are deterministic and never wall-clock sleep.
"""
from __future__ import annotations

import asyncio
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence

from repro_torch.launch.node import NodeOrchestrator
from repro_torch.serving.frontend.batches import BatchManager
from repro_torch.serving.scheduler import ReqState

__all__ = ['AsyncNodeDriver', 'OnlineStream', 'TokenEvent', 'DriverStats',
           'clock_sleep']


async def clock_sleep(clock, dt: float) -> None:
    """Sleep ``dt`` on the runtime's clock: wall sleep under a RealClock,
    a pure advance (plus one loop yield) under a VirtualClock — the one
    primitive that keeps pacing/timeout tests deterministic."""
    if getattr(clock, 'virtual', False):
        if dt > 0:
            clock.advance(dt)
        await asyncio.sleep(0)
    else:
        await asyncio.sleep(max(dt, 0.0))


class TokenEvent(NamedTuple):
    """One streamed token delta (``token is None`` marks the terminal
    event carrying only the finish reason)."""
    token: Optional[int]
    index: int
    finish_reason: Optional[str]    # 'stop' | 'length' | 'cancelled'


class OnlineStream:
    """Async iterator over one online request's tokens as the engine
    produces them.  Created by :meth:`AsyncNodeDriver.submit_stream`."""

    def __init__(self, driver: 'AsyncNodeDriver', req_id: str):
        self.driver = driver
        self.req_id = req_id
        self.emitted = 0                 # tokens already pushed to the queue
        self.finish_reason: Optional[str] = None
        self._q: asyncio.Queue = asyncio.Queue()

    def __aiter__(self) -> 'OnlineStream':
        return self

    async def __anext__(self) -> TokenEvent:
        if self.finish_reason is not None and self._q.empty():
            raise StopAsyncIteration
        ev: TokenEvent = await self._q.get()
        if ev.finish_reason is not None:
            self.finish_reason = ev.finish_reason
            if ev.token is None:
                raise StopAsyncIteration
        return ev

    async def cancel(self) -> bool:
        """Abandon this stream's request (idempotent)."""
        return self.driver.cancel_stream(self.req_id)

    async def collect(self) -> List[int]:
        """Drain the stream to completion; returns all generated tokens."""
        return [ev.token async for ev in self if ev.token is not None]


@dataclass
class DriverStats:
    ticks: int = 0                   # node steps pumped
    streams_opened: int = 0
    streams_finished: int = 0
    streams_cancelled: int = 0
    idle_parks: int = 0              # pump waits for a kick


class AsyncNodeDriver:
    """Pumps one :class:`NodeOrchestrator` inside the event loop and
    exposes async submission surfaces (online streams + batch jobs)."""

    def __init__(self, node: NodeOrchestrator, *,
                 ticks_per_yield: int = 1):
        self.node = node
        self.clock = node.clock
        self.batches = BatchManager(node)
        self.stats = DriverStats()
        # ≥1 node steps per loop yield: raising this trades intake latency
        # for pump throughput under heavy traffic (benchmarked, not guessed)
        self.ticks_per_yield = max(1, int(ticks_per_yield))
        self._streams: Dict[str, OnlineStream] = {}
        self._wake = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        self._stopping = False

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------
    async def __aenter__(self) -> 'AsyncNodeDriver':
        self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    def start(self) -> None:
        """Start the pump task (must run inside the owning event loop)."""
        assert self._task is None, 'driver already started'
        self._stopping = False
        self._task = asyncio.get_running_loop().create_task(self._pump())

    async def stop(self) -> None:
        """Stop the pump (idempotent).  In-flight requests stay in the
        engines; a restarted driver resumes them."""
        self._stopping = True
        self._wake.set()
        if self._task is not None:
            await self._task
            self._task = None

    def kick(self) -> None:
        """Wake an idle pump (new work arrived)."""
        self._wake.set()

    # ------------------------------------------------------------------
    # Online streaming surface
    # ------------------------------------------------------------------
    def submit_stream(self, prompt: Sequence[int],
                      max_new_tokens: int = 32) -> OnlineStream:
        """Submit one online request; returns its token stream."""
        eng = self.node.online
        assert eng is not None, 'node has no online engine'
        rid = eng.submit(list(prompt), max_new_tokens)
        stream = OnlineStream(self, rid)
        self._streams[rid] = stream
        self.stats.streams_opened += 1
        self.kick()
        return stream

    def _engine_holding(self, req_id: str):
        """Resolve which engine holds ``req_id`` right now.  On a plain
        node that is ``node.online``; nodes/planes that move requests
        between engines (cross-pool rescue, disaggregated prefill→decode
        handoff) expose ``engine_of`` and the driver follows the request
        wherever it lives."""
        finder = getattr(self.node, 'engine_of', None)
        eng = finder(req_id) if finder is not None else None
        return eng if eng is not None else self.node.online

    def cancel_stream(self, req_id: str) -> bool:
        """Cancel an online request (client disconnect path): the holding
        engine releases its lease immediately — on whichever pool the
        request sits, including mid-handoff — and the stream gets a
        terminal ``cancelled`` event."""
        eng = self._engine_holding(req_id)
        cancelled = eng is not None and eng.cancel(req_id)
        if cancelled:
            self.stats.streams_cancelled += 1
        self._flush_streams()
        return cancelled

    def _flush_streams(self) -> None:
        """Diff streamed requests against emitted counts; push deltas and
        terminal events.  Requests may live on different engines (a
        disaggregated handoff moves them mid-stream); each holding engine
        flushes its fused-path lazy tokens once per pass."""
        if not self._streams:
            return
        flushed: set = set()
        done: List[str] = []
        for rid, stream in self._streams.items():
            eng = self._engine_holding(rid)
            if id(eng) not in flushed:
                flushed.add(id(eng))
                eng.flush_tokens()   # resolve fused-path lazy tokens
            req = eng.requests[rid]
            while stream.emitted < len(req.generated):
                stream._q.put_nowait(TokenEvent(
                    req.generated[stream.emitted], stream.emitted, None))
                stream.emitted += 1
            if req.state is ReqState.FINISHED:
                reason = ('length'
                          if len(req.generated) >= req.max_new_tokens
                          else 'stop')
                stream._q.put_nowait(TokenEvent(None, stream.emitted, reason))
                self.stats.streams_finished += 1
                done.append(rid)
            elif req.state is ReqState.CANCELLED:
                stream._q.put_nowait(
                    TokenEvent(None, stream.emitted, 'cancelled'))
                done.append(rid)
        for rid in done:
            del self._streams[rid]

    # ------------------------------------------------------------------
    # The pump
    # ------------------------------------------------------------------
    def _has_work(self) -> bool:
        return self.node.has_work()

    async def _pump(self) -> None:
        while not self._stopping:
            if not self._has_work():
                self._flush_streams()
                self._wake.clear()
                if self._has_work() or self._stopping:
                    continue        # a submit raced the clear (same task
                                    # can't, but a re-kick costs nothing)
                self.stats.idle_parks += 1
                await self._wake.wait()
                continue
            for _ in range(self.ticks_per_yield):
                if not self._has_work():
                    break
                self.node.step()
                self.stats.ticks += 1
            self._flush_streams()
            self.batches.poll()
            # hand the loop to intake / SSE writers between dispatches
            await asyncio.sleep(0)

    async def drain(self, max_ticks: int = 100_000) -> None:
        """Pump until the node is idle WITHOUT a running pump task (test
        and benchmark convenience; mirrors ``NodeOrchestrator.drain``)."""
        assert self._task is None, 'drain() conflicts with a running pump'
        for _ in range(max_ticks):
            if not self._has_work():
                self._flush_streams()
                self.batches.poll()
                return
            self.node.step()
            self.stats.ticks += 1
            self._flush_streams()
            self.batches.poll()
            await asyncio.sleep(0)
        raise RuntimeError('drain exceeded max_ticks')
