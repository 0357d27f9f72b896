"""Trace-replay async load generator — "heavy traffic" as a measured claim.

Replays a timed arrival trace against the front-end through the
in-process ASGI client: online entries open concurrent SSE streams (TTFT
= clock time from POST to first token frame), batch entries submit
offline jobs.  Runs on the node's own clock — deterministic pacing under
a :class:`~repro_torch.core.clock.VirtualClock` (tests), wall-clock arrival
jitter under a :class:`RealClock` (``chip_smoke.py``'s front-end phase:
requests/s and TTFT with offline backfill active).
"""
from __future__ import annotations

import asyncio
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serving.frontend.driver import clock_sleep
from repro_torch.serving.frontend.testing import ASGIClient

__all__ = ['TraceEntry', 'StreamRecord', 'LoadReport', 'LoadGenerator',
           'make_online_trace']


@dataclass(frozen=True)
class TraceEntry:
    """One arrival.  ``kind='online'`` opens one SSE stream;
    ``kind='batch'`` submits one offline job of ``n_requests`` items."""
    t: float                      # arrival offset from replay start
    kind: str = 'online'          # 'online' | 'batch'
    prompt_len: int = 12
    max_new_tokens: int = 8
    n_requests: int = 1           # batch items (kind='batch')
    seed: int = 0                 # per-entry prompt seed


def make_online_trace(n: int, *, horizon_s: float, prompt_len: int = 12,
                      max_new_tokens: int = 8, seed: int = 0,
                      burst_frac: float = 0.5) -> List[TraceEntry]:
    """``n`` online arrivals over ``horizon_s``: a front-loaded burst
    (``burst_frac`` of them land in the first 10% of the horizon — what
    drives peak concurrency) plus uniform background."""
    rng = np.random.default_rng(seed)
    n_burst = int(n * burst_frac)
    ts = np.concatenate([
        rng.uniform(0.0, 0.1 * horizon_s, n_burst),
        rng.uniform(0.0, horizon_s, n - n_burst),
    ])
    return [TraceEntry(t=float(t), prompt_len=prompt_len,
                       max_new_tokens=max_new_tokens, seed=seed + i)
            for i, t in enumerate(np.sort(ts))]


@dataclass
class StreamRecord:
    entry: TraceEntry
    t_submit: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0
    n_tokens: int = 0
    status: str = 'pending'       # 'completed' | 'failed'

    @property
    def ttft(self) -> Optional[float]:
        if self.status != 'completed' or self.n_tokens == 0:
            return None
        return self.t_first_token - self.t_submit


@dataclass
class LoadReport:
    n_online: int = 0
    completed: int = 0
    failed: int = 0
    duration_s: float = 0.0       # replay span on the node clock
    tokens_streamed: int = 0
    peak_concurrent_streams: int = 0
    batch_jobs: int = 0
    ttfts: List[float] = field(default_factory=list)

    @property
    def requests_per_s(self) -> float:
        return self.completed / self.duration_s if self.duration_s else 0.0

    def ttft_pct(self, q: float) -> Optional[float]:
        if not self.ttfts:
            return None
        return float(np.percentile(np.asarray(self.ttfts), q))

    def to_dict(self) -> Dict[str, object]:
        return {
            'n_online': self.n_online,
            'completed': self.completed,
            'failed': self.failed,
            'batch_jobs': self.batch_jobs,
            'duration_s': self.duration_s,
            'requests_per_s': self.requests_per_s,
            'tokens_streamed': self.tokens_streamed,
            'peak_concurrent_streams': self.peak_concurrent_streams,
            'ttft_p50_s': self.ttft_pct(50),
            'ttft_p99_s': self.ttft_pct(99),
        }


class LoadGenerator:
    """Replays a trace against one front-end app."""

    def __init__(self, client: ASGIClient, clock, *, vocab_size: int):
        self.client = client
        self.clock = clock
        self.vocab_size = vocab_size
        self._live = 0
        self._report = LoadReport()

    def _prompt(self, entry: TraceEntry) -> List[int]:
        rng = np.random.default_rng(entry.seed)
        return rng.integers(1, self.vocab_size,
                            entry.prompt_len).tolist()

    async def _run_stream(self, entry: TraceEntry,
                          rec: StreamRecord) -> None:
        r = self._report
        self._live += 1
        r.peak_concurrent_streams = max(r.peak_concurrent_streams,
                                        self._live)
        rec.t_submit = self.clock.now()
        try:
            sr = self.client.stream(
                'POST', '/v1/completions',
                json={'prompt': self._prompt(entry),
                      'max_tokens': entry.max_new_tokens, 'stream': True})
            async with sr:
                if sr.status != 200:
                    rec.status = 'failed'
                    return
                async for ev in sr.events():
                    if ev.done:
                        break
                    chunk = json.loads(ev.data)
                    if chunk['choices'][0].get('token') is not None:
                        if rec.n_tokens == 0:
                            rec.t_first_token = self.clock.now()
                        rec.n_tokens += 1
            rec.t_done = self.clock.now()
            rec.status = ('completed' if rec.n_tokens == entry.max_new_tokens
                          else 'failed')
        finally:
            self._live -= 1
            if rec.status == 'completed':
                r.completed += 1
                r.tokens_streamed += rec.n_tokens
                if rec.ttft is not None:
                    r.ttfts.append(rec.ttft)
            else:
                r.failed += 1

    async def _run_batch(self, entry: TraceEntry) -> None:
        reqs = [{'prompt': self._prompt(
                    TraceEntry(0, seed=entry.seed + 1000 + i,
                               prompt_len=entry.prompt_len)),
                 'max_tokens': entry.max_new_tokens}
                for i in range(entry.n_requests)]
        resp = await self.client.post('/v1/batches',
                                      json={'requests': reqs})
        if resp.status == 200:
            self._report.batch_jobs += 1

    async def replay(self, trace: Sequence[TraceEntry]
                     ) -> LoadReport:
        """Replay arrivals at their trace offsets; wait for every stream
        to finish; return the report."""
        self._report = LoadReport()
        t0 = self.clock.now()
        tasks: List[asyncio.Task] = []
        loop = asyncio.get_running_loop()
        for entry in sorted(trace, key=lambda e: e.t):
            dt = (t0 + entry.t) - self.clock.now()
            if dt > 0:
                await clock_sleep(self.clock, dt)
            if entry.kind == 'online':
                self._report.n_online += 1
                rec = StreamRecord(entry)
                tasks.append(loop.create_task(
                    self._run_stream(entry, rec)))
            else:
                tasks.append(loop.create_task(self._run_batch(entry)))
        if tasks:
            await asyncio.gather(*tasks)
        self._report.duration_s = self.clock.now() - t0
        return self._report
