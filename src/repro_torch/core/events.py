"""Typed runtime event stream — the control-plane API's observation surface.

Every consequential control-plane action in the Valve runtime (and in the
§7.2 ``NodeSim``) is published as exactly one immutable, sequence-numbered
event on an :class:`EventBus`.  Consumers — the node orchestrator, the
simulator, the cluster harness, telemetry — subscribe instead of poking
counters, so all of them observe the *same ordered facts*:

- :class:`PreemptionEvent`      — offline compute gates closed (paper §4);
- :class:`ReclamationEvent`     — offline KV handles reclaimed (paper §5);
- :class:`WakeupEvent`          — offline compute re-enabled after T_cool;
- :class:`ReservationChangeEvent` — MIAD moved the reserved-handle set H;
- :class:`MemoryPressureEvent`  — an online allocation overflowed H;
- :class:`PageMigration`        — KV pages changed owner/pool (cross-pool
  rescue of a reclamation victim, or an intra-pool ownership re-key);
- :class:`PrefillHandoff`       — a finished prefill's KV lease moved to
  the decode pool of a disaggregated plane (serving/disagg).

The paper's §5 ordering rule ("compute first") and the §4.2 rate bound
("≤ 1 preemption per request", wake only after T_cool) become *checkable
properties of the event log* — see :func:`check_event_ordering` and
``TelemetryRegistry.check_invariants`` — instead of hand-synchronized
counter fields.

Events are ``NamedTuple`` records, not dataclasses: they sit on the
serving/sim hot path (one construction per preemption/reclamation), and
tuple construction is ~3× cheaper than a frozen-dataclass ``__init__`` —
``benchmarks/api_overhead.py`` holds the whole bus under 10 % of NodeSim
wall time.  They are still immutable, typed, and keyword-constructible.
"""
from __future__ import annotations

import abc
from collections import deque
from typing import (
    Callable, Deque, Dict, List, NamedTuple, Optional, Tuple, Type)

__all__ = [
    'RuntimeEvent', 'PreemptionEvent', 'ReclamationEvent', 'WakeupEvent',
    'ReservationChangeEvent', 'MemoryPressureEvent', 'PageMigration',
    'PrefillHandoff', 'EventBus', 'EVENT_TYPES', 'check_event_ordering',
]


class PreemptionEvent(NamedTuple):
    """Offline compute gates closed (online activity or memory pressure).

    ``latency_s`` is the measured/modeled gate-flip latency for the whole
    group flip; ``device_latencies_s`` carries each device's own measured
    flip latency (indexed by gate, so fanout == max, serial == Σ is
    checkable from the log); ``requests`` are the online requests in
    flight (the §4.2 bound is per-request); ``trigger`` distinguishes
    lifecycle closes from memory-pressure closes.
    """
    seq: int
    t: float
    latency_s: float = 0.0
    requests: Tuple[str, ...] = ()
    trigger: str = 'lifecycle'          # 'lifecycle' | 'memory'
    device_latencies_s: Tuple[float, ...] = ()


class ReclamationEvent(NamedTuple):
    """Offline KV handles remapped to quarantine for online use.

    ``gate_closed`` records whether offline compute was disabled when the
    pages moved — the §5 ordering invariant requires True; baseline
    strategies (UVM/StaticMem in the sim) publish False, which is exactly
    the fault-risk the paper's ordering rule exists to prevent.
    """
    seq: int
    t: float
    n_handles: int = 0
    requests: Tuple[str, ...] = ()      # invalidated (or killed) request ids
    pages: int = 0
    gate_closed: bool = True
    killed: bool = False                # baselines kill instead of invalidate
    # victims rescued by cross-pool migration instead of truncated: each
    # must have an earlier cross-pool PageMigration in the same log (the
    # data-plane copy runs at that publish, before this event's freed
    # source pages can be reallocated) — checked by check_event_ordering
    rescued: Tuple[str, ...] = ()


class WakeupEvent(NamedTuple):
    """Offline compute gates re-enabled after continuous online idle.

    ``idle_for_s`` ≥ ``t_cool_s`` is the §4.2 wake rule; both are recorded
    so the property is checkable from the log alone.
    """
    seq: int
    t: float
    idle_for_s: float = 0.0
    t_cool_s: float = 0.0


class ReservationChangeEvent(NamedTuple):
    """The MIAD reserved-handle set H changed size."""
    seq: int
    t: float
    h_before: int = 0
    h_after: int = 0
    reason: str = 'miad'                # 'miad' | 'pressure'


class MemoryPressureEvent(NamedTuple):
    """An online allocation exceeded the current reservation headroom."""
    seq: int
    t: float
    req_id: str = ''
    deficit_pages: int = 0


class PageMigration(NamedTuple):
    """KV pages moved between owners and/or pools.

    Published by ``KVPool.transfer_pages`` (when the pool has a bus), so
    page movement is observable instead of silent bookkeeping.
    ``cross_pool=True`` is the Valve rescue path: a reclamation victim's
    surviving prefix re-homed to a less-loaded pool with zero recompute;
    ``cross_pool=False`` is an intra-pool ownership re-key (e.g. shared
    prefix pages outliving their lease).

    ``src_pages``/``dst_pages`` are the page ids in logical order (equal
    for intra-pool re-keys; pool-local on each side for cross-pool moves)
    — the orchestrator's data-plane copy reads them to move the actual KV
    cache rows between the engines' caches, synchronously at publish time,
    before the freed source pages can be reallocated and overwritten.
    """
    seq: int
    t: float
    owner: str = ''                     # request/lease id that owns the pages
    n_pages: int = 0
    src_pool: str = ''
    dst_pool: str = ''
    cross_pool: bool = False
    src_pages: Tuple[int, ...] = ()
    dst_pages: Tuple[int, ...] = ()


class PrefillHandoff(NamedTuple):
    """A finished prefill's whole KV lease moved to the decode pool.

    Published by the disaggregated serving plane
    (``repro_torch.serving.disagg.DisaggPlane``) on *both* pools' buses once the
    ``MemoryPlane.migrate`` / ``PageMigration`` data-plane copy has
    re-homed the request onto a decode engine.  ``recompute_tokens`` is
    the number of already-materialized prefill tokens the decode side
    will compute again — the disaggregation contract requires 0 (the
    lease carries its fill point, so decode admission resumes at
    ``lease.resume_tokens``).  ``latency_s`` measures first-token time →
    handoff completion (how long finished-prefill KV waited on the
    prefill pool); the queue depths snapshot both online engines
    (waiting + running) at publish time for interference analysis.
    """
    seq: int
    t: float
    req_id: str = ''
    src_pool: str = ''
    dst_pool: str = ''
    pages_copied: int = 0
    latency_s: float = 0.0
    recompute_tokens: int = 0
    prefill_queue_depth: int = 0
    decode_queue_depth: int = 0


EVENT_TYPES: Tuple[type, ...] = (
    PreemptionEvent, ReclamationEvent, WakeupEvent, ReservationChangeEvent,
    MemoryPressureEvent, PageMigration, PrefillHandoff)


class RuntimeEvent(abc.ABC):
    """Abstract marker for the event union: ``isinstance(ev, RuntimeEvent)``
    holds for every registered event type.  Every event carries ``seq``
    (bus sequence number) and ``t`` (runtime-clock timestamp) first."""


for _cls in EVENT_TYPES:
    RuntimeEvent.register(_cls)

Subscriber = Callable[[RuntimeEvent], None]


class EventBus:
    """Ordered, typed pub/sub with a bounded replay log.

    ``publish`` assigns a monotonically increasing sequence number and
    delivers synchronously in subscription order (the runtime is
    single-threaded on its control path; determinism matters more than
    parallel delivery).  The replay log is a bounded deque — long sim and
    harness runs must not grow memory linearly — while cumulative counters
    live in :class:`repro_torch.core.telemetry.TelemetryRegistry`, which consumes
    events as they are published and never needs the full log.

    The registry attaches through :meth:`set_fold` — a single fast-path
    consumer checked with one branch per publish — so the common case
    (telemetry only, no ad-hoc subscribers) stays off the generic
    subscriber loop.
    """

    def __init__(self, clock=None, *, log_maxlen: int = 65536):
        self.clock = clock
        self.log: Deque[RuntimeEvent] = deque(maxlen=log_maxlen)
        self._seq = 0
        self._counts: Dict[type, int] = {}
        self._fold: Optional[Subscriber] = None
        self._subs: List[Tuple[Optional[type], Subscriber]] = []

    # ------------------------------------------------------------------
    def set_fold(self, callback: Optional[Subscriber]) -> None:
        """Install the single fast-path consumer (one per bus — telemetry)."""
        assert callback is None or self._fold is None, 'fold already set'
        self._fold = callback

    def subscribe(self, callback: Subscriber,
                  event_type: Optional[type] = None
                  ) -> Callable[[], None]:
        """Register ``callback`` for ``event_type`` (None = all events).
        Returns an unsubscribe thunk."""
        entry = (event_type, callback)
        self._subs.append(entry)

        def unsubscribe() -> None:
            if entry in self._subs:
                self._subs.remove(entry)
        return unsubscribe

    def publish(self, event_cls: type, *,
                t: Optional[float] = None, **fields) -> RuntimeEvent:
        """Construct and deliver one event; ``t`` defaults to the bus clock."""
        if t is None:
            t = self.clock.now() if self.clock is not None else 0.0
        seq = self._seq
        self._seq = seq + 1
        ev = event_cls(seq, t, **fields)
        self.log.append(ev)
        self._counts[event_cls] = self._counts.get(event_cls, 0) + 1
        if self._fold is not None:
            self._fold(ev)
        if self._subs:
            for etype, cb in tuple(self._subs):
                if etype is None or type(ev) is etype \
                        or isinstance(ev, etype):
                    cb(ev)
        return ev

    # ------------------------------------------------------------------
    @property
    def published(self) -> Dict[str, int]:
        """Cumulative publish counts by event-type name."""
        return {cls.__name__: n for cls, n in self._counts.items()}

    def events(self, event_type: Optional[type] = None
               ) -> List[RuntimeEvent]:
        """Snapshot of the (bounded) replay log, optionally filtered."""
        if event_type is None:
            return list(self.log)
        return [e for e in self.log if isinstance(e, event_type)]

    def count(self, event_type: type) -> int:
        """Cumulative publish count (survives log truncation)."""
        return self._counts.get(event_type, 0)


def check_event_ordering(events: List[RuntimeEvent], *,
                         require_gate_closed: bool = True) -> None:
    """Assert the paper's ordering properties over an event log.

    - §5 compute-first: every :class:`ReclamationEvent` carries
      ``gate_closed=True`` (skipped when ``require_gate_closed=False`` —
      baseline strategies legitimately violate it, that's their flaw);
    - §4.2 wake rule: every :class:`WakeupEvent` satisfies
      ``idle_for_s ≥ t_cool_s`` (within float tolerance);
    - copy-before-reallocation: every victim a :class:`ReclamationEvent`
      reports as ``rescued`` has an *earlier* cross-pool
      :class:`PageMigration` with that owner — the data-plane KV copy
      runs synchronously at the migration publish, so migration-before-
      reclamation in the log proves the copy happened before the freed
      source pages could be reallocated and overwritten;
    - sequence numbers are strictly increasing and timestamps are
      monotonically non-decreasing (one ordered stream of facts).
    """
    last_seq, last_t = -1, float('-inf')
    migrated_owners: set = set()
    for ev in events:
        assert ev.seq > last_seq, (ev.seq, last_seq)
        assert ev.t >= last_t - 1e-9, (ev.t, last_t)
        last_seq, last_t = ev.seq, ev.t
        if isinstance(ev, PageMigration) and ev.cross_pool:
            migrated_owners.add(ev.owner)
        if isinstance(ev, ReclamationEvent):
            if require_gate_closed:
                assert ev.gate_closed, \
                    f'reclamation at t={ev.t} with offline compute ' \
                    f'enabled (§5)'
            missing = set(ev.rescued) - migrated_owners
            assert not missing, \
                f'reclamation at t={ev.t} reports rescued={sorted(missing)}' \
                f' with no prior cross-pool PageMigration (the data-plane ' \
                f'copy must precede the reclamation that frees the source)'
        if isinstance(ev, WakeupEvent):
            assert ev.idle_for_s >= ev.t_cool_s - 1e-9, \
                f'wake-up at t={ev.t} inside T_cool ({ev.idle_for_s} < ' \
                f'{ev.t_cool_s})'
