"""Page-fault-free sub-layer memory reclamation (paper §5).

The reclamation path, in the paper's mandatory order:

1. **compute first** — offline gates are disabled so no in-flight program can
   touch pages being reclaimed (the runtime enforces the ordering and this
   module asserts it);
2. **select victims** — Algorithm 1 (or FIFO baseline) picks the handles with
   the lowest marginal token cost;
3. **remap to quarantine** — every mapped page of a victim handle is remapped
   to page 0, which is always mapped, so by construction no access can fault;
4. **surface invalidated IDs** — the per-request invalidation records are
   pushed through a single framework callback (the < 20-LOC patch surface);
   since Memory-plane API v1 each record is a
   :class:`~repro_torch.core.memory.LeaseInvalidation` carrying the **surviving
   prefix** (``keep``/``resume``), so the framework resumes
   recompute *from the surviving prefix* instead of restarting at token 0.
   Requests allocated around the plane degrade to the legacy whole-request
   semantics (``keep == 0``).

Victim selection runs Algorithm 1 over the plane's *marginal
recompute-from-surviving-prefix* cost (``MemoryPlane.recompute_cost``) —
unfilled tails and zero-ref cached prefixes are free to take.

A :class:`ReclamationRateLimiter` tracks the reclamation-event rate that the
MIAD reservation is driving toward the user target.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Sequence

from repro_torch.core import eviction
from repro_torch.core.memory import MemoryPlane
from repro_torch.serving.kvpool import KVPool

# type of the framework-side patch surface: called once per reclamation with
# {offline request id: LeaseInvalidation} — each value iterates as the
# legacy invalidated-page-id list, so un-migrated callbacks keep working
InvalidationCallback = Callable[[Dict[str, List[int]]], None]


@dataclass
class ReclamationStats:
    reclamations: int = 0
    handles_reclaimed: int = 0
    pages_invalidated: int = 0
    requests_impacted: int = 0
    tokens_lost: float = 0.0           # recompute cost surfaced to offline
    ordering_violations: int = 0       # must stay 0: compute-before-memory


class ReclamationRateLimiter:
    """Sliding-window reclamation-event rate (events/s)."""

    def __init__(self, window_s: float = 60.0):
        self.window_s = window_s
        self._events: Deque[float] = deque()
        self._t0: Optional[float] = None     # first observation time

    def note(self, now: float) -> None:
        if self._t0 is None:
            self._t0 = now
        self._events.append(now)
        self._trim(now)

    def _trim(self, now: float) -> None:
        w = self.window_s
        while self._events and self._events[0] < now - w:
            self._events.popleft()

    def rate(self, now: float) -> float:
        """Events per second over the *elapsed* horizon: before a full
        window has been observed, divide by the time actually observed —
        dividing by ``window_s`` would underestimate warm-up bursts (same
        bug class as ``MIADReservation._event_rate``)."""
        self._trim(now)
        if len(self._events) < 2:
            # one event over ~zero elapsed time is rate-indeterminate —
            # use the full window (see MIADReservation._event_rate)
            return len(self._events) / self.window_s
        start = self._t0 if self._t0 is not None else self._events[0]
        horizon = min(self.window_s, max(now - start, 1e-3))
        return len(self._events) / horizon


class ReclamationController:
    """Coordinates compute preemption with memory reclamation over one pool.

    ``gate_is_closed`` is a runtime-supplied predicate proving offline compute
    is already disabled — reclaiming while it returns False is the exact bug
    class (in-flight kernel touches an unmapped page) the paper's ordering
    rule exists to prevent, and is recorded as an ordering violation.
    """

    def __init__(self, pool: KVPool, *,
                 gate_is_closed: Callable[[], bool],
                 on_invalidate: Optional[InvalidationCallback] = None,
                 policy: str = 'valve',
                 cost_of: Optional[Callable[[str], float]] = None,
                 rate_window_s: float = 60.0,
                 bus=None):
        assert policy in ('valve', 'fifo'), policy
        self.pool = pool
        self.plane = MemoryPlane.of(pool)
        self.gate_is_closed = gate_is_closed
        self.on_invalidate = on_invalidate
        self.policy = policy
        # optional typed event stream (repro_torch.core.events.EventBus): each
        # reclamation publishes one ReclamationEvent before the framework
        # callback fires, so subscribers see the fact before the reaction
        self.bus = bus
        # COST(r): by default the plane's marginal recompute-from-surviving-
        # prefix tokens; a custom ``cost_of`` opts back into the classic
        # whole-request cost model of paper Algorithm 1
        self.cost_of = cost_of
        self.rate = ReclamationRateLimiter(rate_window_s)
        self.stats = ReclamationStats()
        self._handle_age: Dict[int, float] = {}

    # ------------------------------------------------------------- victims
    def select_victims(self, k: int) -> List[int]:
        cand = self.pool.offline_handles()
        if self.policy == 'fifo':
            by_age = sorted(cand, key=lambda h: self._handle_age.get(h, 0.0))
            return eviction.select_handles_fifo(k, by_age)
        if self.cost_of is not None:
            return eviction.select_handles(
                k, cand, self.pool.reqs_of_handle, self.cost_of)
        return eviction.select_handles_partial(
            k, cand, self.plane.impact_of, self.plane.recompute_cost)

    def note_handle_use(self, h: int, now: float) -> None:
        """FIFO baseline bookkeeping: first-touch age per handle."""
        self._handle_age.setdefault(h, now)

    # ----------------------------------------------------------- reclaim
    def reclaim(self, n_handles: int, now: float) -> Dict[str, List[int]]:
        """Reclaim ``n_handles`` offline handles for online use.

        Returns the invalidation map {offline req: LeaseInvalidation} (also
        pushed through ``on_invalidate``).  Caller must hold the compute
        gate closed.
        """
        if not self.gate_is_closed():
            self.stats.ordering_violations += 1
            raise RuntimeError(
                'reclamation attempted with offline compute enabled '
                '(paper §5: disable offline compute first)')
        victims = self.select_victims(n_handles)
        invalidated = self.plane.reclaim_handles(victims, now)
        for h in victims:
            self._handle_age.pop(h, None)

        self.stats.reclamations += 1
        self.stats.handles_reclaimed += len(victims)
        # rescued (cross-pool migrated) victims lost nothing — their KV
        # moved intact, so they are not "invalidated" for stats or the
        # event; the pool already published PageMigration for each
        truncated = {rid: v for rid, v in invalidated.items()
                     if getattr(v, 'migrated_to', None) is None}
        # PHYSICAL pages: a shared prefix page appears in every using
        # lease's record — count each page id once
        n_pages = len({p for v in truncated.values() for p in v})
        self.stats.pages_invalidated += n_pages
        self.stats.requests_impacted += len(truncated)
        # recompute tax actually inflicted: fill lost beyond the surviving
        # prefix (legacy ids report their remapped pages, as before)
        self.stats.tokens_lost += sum(v.lost_tokens
                                      for v in truncated.values())
        self.rate.note(now)

        if self.bus is not None:
            from repro_torch.core.events import ReclamationEvent
            # rescued victims are named so check_event_ordering can prove
            # each had its PageMigration (= data-plane copy) published
            # BEFORE this event frees the source pages for reallocation
            self.bus.publish(
                ReclamationEvent, n_handles=len(victims),
                requests=tuple(sorted(truncated)),
                pages=n_pages,
                gate_closed=True,
                rescued=tuple(sorted(set(invalidated) - set(truncated))))

        if self.on_invalidate is not None and invalidated:
            self.on_invalidate(invalidated)
        return invalidated
