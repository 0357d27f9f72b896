"""Batch-composition scheduler — the policy layer of the serving plane.

The engine used to decide *what to run next* inline in ``Engine.step()``:
one request's prefill chunk (batch 1) **or** one decode iteration, never
both.  This module owns that decision as an explicit layer.  Each call to
:meth:`BatchScheduler.schedule` composes one *dispatch*:

- **budgeted multi-request chunked prefill** — the per-dispatch prefill
  token budget is filled FIFO across *multiple* waiting-to-prefill requests
  (each row capped at ``chunk`` tokens, at most ``max_prefill_reqs`` rows);
- **piggybacked decode** — every request already in the RUNNING state gets a
  one-token decode slot in the *same* iteration,

so each engine step does strictly more work per compile-once dispatch while
the dispatch unit stays fixed-shape (``max_batch`` rows × ``chunk`` width —
the preemptible unit the Valve gates check between).

The scheduler is engine-agnostic: it never touches tensors, allocators or
the runtime.  Admission is delegated through a caller-supplied
``try_admit`` callable — in the Valve integration that is one
``session.admit`` call (the :class:`~repro_torch.core.api.ValveSession` bundle:
lifecycle notification, then allocation, with rollback on failure) — which
keeps the FIFO head-of-line-blocking policy here and the control-plane
plumbing behind the session API.  Request bookkeeping (:class:`Request`,
:class:`ReqState`) lives here too — requests are scheduler domain; the
engine re-exports them for compatibility.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


class ReqState(enum.Enum):
    WAITING = 'waiting'
    PREFILL = 'prefill'
    RUNNING = 'running'
    FINISHED = 'finished'
    CANCELLED = 'cancelled'         # abandoned by the client (terminal)


@dataclass
class Request:
    req_id: str
    prompt: List[int]
    max_new_tokens: int
    state: ReqState = ReqState.WAITING
    generated: List[int] = field(default_factory=list)
    pages: List[int] = field(default_factory=list)
    # the memory-plane handle behind ``pages`` (None until admitted, or
    # when admission went through a plain page-list allocator)
    lease: Optional[object] = None
    n_prefilled: int = 0
    recomputes: int = 0
    blocked_admits: int = 0       # consecutive failed admission attempts
    t_submit: float = 0.0
    t_first_token: Optional[float] = None
    t_last_token: Optional[float] = None
    decode_steps: int = 0

    @property
    def context(self) -> List[int]:
        """Prompt + already-generated tokens (what recompute re-prefills)."""
        return self.prompt + self.generated

    @property
    def target_len(self) -> int:
        return len(self.prompt) + self.max_new_tokens

    # -- latency metrics ---------------------------------------------------
    @property
    def ttft(self) -> Optional[float]:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.t_submit

    @property
    def tpot(self) -> Optional[float]:
        if self.t_last_token is None or self.t_first_token is None:
            return None
        n = len(self.generated) - 1
        if n <= 0:
            return 0.0
        return (self.t_last_token - self.t_first_token) / n


@dataclass
class SchedulerConfig:
    max_batch: int = 8              # dispatch rows (prefill + decode slots)
    chunk: int = 64                 # row width: max prefill tokens per row
    max_prefill_reqs: int = 4       # prefill rows per dispatch
    # total prefill tokens per dispatch; None → max_prefill_reqs × chunk
    prefill_budget: Optional[int] = None
    # decode slots ride along with prefill rows in one mixed dispatch;
    # False reproduces the seed engine's prefill-XOR-decode alternation
    piggyback_decode: bool = True
    # after this many consecutive failed admissions of the queue head,
    # waiting requests' surviving-prefix pages are spilled (released) one
    # at a time until the head fits — partial KV retention is a luxury
    # that must degrade to whole-request recompute, never deadlock
    # admission on pages held by requests that cannot run
    spill_after_blocked: int = 3

    @property
    def budget(self) -> int:
        if self.prefill_budget is not None:
            return self.prefill_budget
        return self.max_prefill_reqs * self.chunk


@dataclass(frozen=True)
class PrefillSlot:
    """One row of chunked prefill: context[start : start+length]."""
    req_id: str
    start: int
    length: int


@dataclass(frozen=True)
class DecodeSlot:
    """One piggybacked single-token decode row."""
    req_id: str


@dataclass
class ScheduledBatch:
    """One composed dispatch: prefill rows first, then decode rows."""
    prefill: List[PrefillSlot] = field(default_factory=list)
    decode: List[DecodeSlot] = field(default_factory=list)

    @property
    def empty(self) -> bool:
        return not (self.prefill or self.decode)

    @property
    def n_slots(self) -> int:
        return len(self.prefill) + len(self.decode)

    @property
    def prefill_tokens(self) -> int:
        return sum(s.length for s in self.prefill)


# try_admit(request) → the request's KVLease (or a plain page list), or
# None to block admission (the request stays at the queue head — FIFO
# head-of-line blocking).  For a partially-invalidated request the lease
# is *extended*: its ``resume_tokens`` is where prefill resumes.
AdmitFn = Callable[[Request], Optional[List[int]]]

# spill(request) → release a waiting request's surviving-prefix pages
# (scheduler-driven deadlock valve; see SchedulerConfig.spill_after_blocked)
SpillFn = Callable[[Request], None]


class BatchScheduler:
    """FIFO continuous-batching policy over one engine's request set.

    Owns the waiting ``queue`` and admitted ``running`` lists (the engine
    aliases them, so the < 20-LOC Valve patch keeps mutating the same
    objects).  ``schedule()`` admits, then composes the next dispatch.
    """

    def __init__(self, cfg: Optional[SchedulerConfig] = None):
        self.cfg = cfg or SchedulerConfig()
        assert self.cfg.max_prefill_reqs <= self.cfg.max_batch
        self.queue: List[str] = []       # FIFO waiting queue
        self.running: List[str] = []     # admitted (PREFILL or RUNNING)

    # ------------------------------------------------------------------
    def submit(self, req_id: str) -> None:
        self.queue.append(req_id)

    def has_work(self) -> bool:
        return bool(self.queue or self.running)

    # ------------------------------------------------------------------
    def admit(self, requests: Dict[str, Request], try_admit: AdmitFn,
              spill: Optional[SpillFn] = None) -> int:
        """FIFO admission until memory or the batch cap blocks; returns the
        number of requests admitted.

        When the head has been blocked ``spill_after_blocked`` times in a
        row and a ``spill`` callback is given, waiting requests' surviving-
        prefix pages are released one at a time (head first) until the head
        fits — sustained pressure degrades partial retention to the legacy
        whole-request recompute instead of deadlocking on pages held by
        requests that cannot run.
        """
        admitted = 0
        while self.queue and len(self.running) < self.cfg.max_batch:
            req = requests[self.queue[0]]
            res = try_admit(req)
            if res is None and spill is not None:
                req.blocked_admits += 1
                if req.blocked_admits >= self.cfg.spill_after_blocked:
                    for rid in list(self.queue):
                        if not requests[rid].pages:
                            continue
                        spill(requests[rid])
                        res = try_admit(req)
                        if res is not None:
                            break
            if res is None:
                break                    # head-of-line blocks until pages free
            self.queue.pop(0)
            req.blocked_admits = 0
            req.pages = list(res)
            req.state = ReqState.PREFILL
            # a lease resumes where its valid KV ends (0 when fresh): the
            # shared prefix at first admission, the surviving prefix on a
            # post-invalidation re-admission
            req.n_prefilled = getattr(res, 'resume_tokens', 0)
            self.running.append(req.req_id)
            admitted += 1
        return admitted

    def compose(self, requests: Dict[str, Request]) -> ScheduledBatch:
        """Compose the next dispatch from the admitted set (no admission)."""
        batch = ScheduledBatch()
        budget = self.cfg.budget
        for rid in self.running:         # FIFO by admission order
            if len(batch.prefill) >= self.cfg.max_prefill_reqs or budget <= 0:
                break
            req = requests[rid]
            if req.state is not ReqState.PREFILL:
                continue
            n = min(len(req.context) - req.n_prefilled, self.cfg.chunk, budget)
            if n <= 0:
                continue
            batch.prefill.append(PrefillSlot(rid, req.n_prefilled, n))
            budget -= n
        if batch.prefill and not self.cfg.piggyback_decode:
            return batch
        # decode slots: every RUNNING request rides along.  Row capacity is
        # never the binding constraint — len(running) ≤ max_batch and prefill
        # rows come out of the same admitted set — but guard anyway.
        rows_left = self.cfg.max_batch - len(batch.prefill)
        for rid in self.running:
            if rows_left <= 0:
                break
            if requests[rid].state is ReqState.RUNNING:
                batch.decode.append(DecodeSlot(rid))
                rows_left -= 1
        return batch

    def schedule(self, requests: Dict[str, Request], try_admit: AdmitFn,
                 spill: Optional[SpillFn] = None) -> ScheduledBatch:
        """One scheduling decision: admit, then compose the dispatch."""
        self.admit(requests, try_admit, spill)
        return self.compose(requests)
