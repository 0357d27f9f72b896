"""Unified telemetry — counters *derived from the event stream*.

Before the control-plane API, every plane hand-synchronized its own
counters (``RuntimeStats`` mutated inline in the runtime hot path,
``NodeStats``/``SimResult`` scraped by callers) and ``check_invariants``
compared fields that were only correct if every mutation site remembered to
update all of them.  Here a single :class:`TelemetryRegistry` subscribes to
the :class:`~repro_torch.core.events.EventBus` and derives the counters — the
event log is the source of truth, the registry is a fold over it, and the
invariants (≤ 1 preemption per online request, wake-ups == gate enables,
§5 ordering) are checked against what was actually published.

:class:`LatencySummary` replaces the unbounded
``RuntimeStats.preemption_latencies`` list: exact count/mean/max plus a
bounded deterministic reservoir for quantiles, so week-long sim/harness
runs hold O(1) memory.  The retained samples stay list-like (iteration,
len, indexing) and ``raw`` is the escape hatch tests use.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core.events import (
    EventBus, MemoryPressureEvent, PageMigration, PreemptionEvent,
    PrefillHandoff, ReclamationEvent, ReservationChangeEvent, RuntimeEvent,
    WakeupEvent, check_event_ordering)

__all__ = ['LatencySummary', 'TelemetryRegistry']


class LatencySummary:
    """Streaming latency record: exact count/mean/max, bounded reservoir
    for quantiles (Vitter's Algorithm R with a seeded RNG — deterministic
    given the sample sequence).

    Below ``cap`` samples the reservoir IS the full raw sequence in arrival
    order, so existing ``list(...)``-style test assertions keep working;
    past ``cap`` the quantiles become estimates while count/mean/max stay
    exact.  ``raw`` is the retained-samples escape hatch.
    """

    def __init__(self, cap: int = 512, seed: int = 0):
        assert cap >= 1
        self.cap = cap
        self.count = 0
        self.total = 0.0
        self.max = 0.0
        self._samples: List[float] = []
        self._rng = random.Random(seed)

    # -- recording ---------------------------------------------------------
    def record(self, x: float) -> None:
        x = float(x)
        self.count += 1
        self.total += x
        if x > self.max:
            self.max = x
        if len(self._samples) < self.cap:
            self._samples.append(x)
        else:
            j = self._rng.randrange(self.count)
            if j < self.cap:
                self._samples[j] = x

    append = record                      # list-compat alias

    # -- list compatibility (exact while count ≤ cap) ----------------------
    def __len__(self) -> int:
        return self.count

    def __iter__(self):
        return iter(self._samples)

    def __getitem__(self, i):
        return self._samples[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, LatencySummary):
            return self._samples == other._samples and \
                self.count == other.count
        return self._samples == other     # compare against plain lists

    def __repr__(self) -> str:
        return (f'LatencySummary(count={self.count}, mean={self.mean:.6g}, '
                f'p50={self.p50:.6g}, p99={self.p99:.6g}, '
                f'max={self.max:.6g})')

    @property
    def raw(self) -> List[float]:
        """Retained samples (the full sequence while count ≤ cap)."""
        return list(self._samples)

    @property
    def exact(self) -> bool:
        return self.count <= self.cap

    # -- statistics --------------------------------------------------------
    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        if not self._samples:
            return 0.0
        s = sorted(self._samples)
        idx = min(int(q * (len(s) - 1) + 0.5), len(s) - 1)
        return s[idx]

    @property
    def p50(self) -> float:
        return self.quantile(0.50)

    @property
    def p99(self) -> float:
        return self.quantile(0.99)

    def summary(self) -> Dict[str, float]:
        return {'count': self.count, 'mean': self.mean, 'p50': self.p50,
                'p99': self.p99, 'max': self.max}


@dataclass
class _Counters:
    preemptions: int = 0
    wakeups: int = 0
    reclamations: int = 0
    handles_reclaimed: int = 0
    pages_invalidated: int = 0
    requests_invalidated: int = 0
    requests_killed: int = 0
    memory_pressure_events: int = 0
    reservation_changes: int = 0
    pages_migrated: int = 0              # cross-pool rescue pages
    requests_migrated: int = 0           # cross-pool rescued victims
    prefill_handoffs: int = 0            # disagg: prefill → decode moves
    handoff_pages: int = 0               # disagg: pages copied at handoff
    handoff_recompute_tokens: int = 0    # disagg: must stay 0
    per_request_preemptions: Dict[str, int] = field(default_factory=dict)


class TelemetryRegistry:
    """The one telemetry surface: a fold over the event bus.

    Plane-agnostic — the live :class:`~repro_torch.core.runtime.ValveRuntime`,
    the §7.2 ``NodeSim``, and any test harness attach one to their bus and
    read identical counters.  Optional ``stats``/``lifecycle`` hooks keep
    the legacy ``RuntimeStats``/``LifecycleStats`` dataclasses populated
    (now *derived* from events instead of hand-synced), preserving every
    existing read site during the deprecation window.
    """

    def __init__(self, bus: EventBus, *, stats=None, lifecycle=None,
                 latency_cap: int = 512):
        self.bus = bus
        self.counters = _Counters()
        self.preemption_latencies = LatencySummary(cap=latency_cap)
        self.handoff_latencies = LatencySummary(cap=latency_cap)
        self._stats = stats              # legacy RuntimeStats mirror
        self._lifecycle = lifecycle      # legacy LifecycleStats mirror
        if stats is not None:
            # the summary object replaces the unbounded list in-place
            stats.preemption_latencies = self.preemption_latencies
        # hot path: one dict lookup + one handler call per event
        self._handlers = {
            PreemptionEvent: self._on_preemption,
            WakeupEvent: self._on_wakeup,
            ReclamationEvent: self._on_reclamation,
            MemoryPressureEvent: self._on_pressure,
            ReservationChangeEvent: self._on_reservation,
            PageMigration: self._on_migration,
            PrefillHandoff: self._on_handoff,
        }
        bus.set_fold(self._on_event)

    # ------------------------------------------------------------------
    def _on_event(self, ev: RuntimeEvent) -> None:
        h = self._handlers.get(ev.__class__)
        if h is not None:
            h(ev)

    def _on_preemption(self, ev: PreemptionEvent) -> None:
        c = self.counters
        c.preemptions += 1
        self.preemption_latencies.record(ev.latency_s)
        per = c.per_request_preemptions
        for rid in ev.requests:
            per[rid] = per.get(rid, 0) + 1
        if self._stats is not None:
            self._stats.compute_preemptions += 1
        if self._lifecycle is not None:
            ls = self._lifecycle.stats
            ls.preemptions += 1
            for rid in ev.requests:
                ls.preempted_requests[rid] = \
                    ls.preempted_requests.get(rid, 0) + 1

    def _on_wakeup(self, ev: WakeupEvent) -> None:
        self.counters.wakeups += 1
        if self._stats is not None:
            self._stats.offline_wakeups += 1
        if self._lifecycle is not None:
            self._lifecycle.stats.wakeups += 1

    def _on_reclamation(self, ev: ReclamationEvent) -> None:
        c = self.counters
        c.reclamations += 1
        c.handles_reclaimed += ev.n_handles
        c.pages_invalidated += ev.pages
        if ev.killed:
            c.requests_killed += len(ev.requests)
        else:
            c.requests_invalidated += len(ev.requests)

    def _on_pressure(self, ev: MemoryPressureEvent) -> None:
        self.counters.memory_pressure_events += 1
        if self._stats is not None:
            self._stats.memory_pressure_events += 1

    def _on_reservation(self, ev: ReservationChangeEvent) -> None:
        self.counters.reservation_changes += 1

    def _on_migration(self, ev: PageMigration) -> None:
        # intra-pool re-keys are bookkeeping, not rescues — count only
        # actual cross-pool page movement
        if ev.cross_pool:
            self.counters.pages_migrated += ev.n_pages
            self.counters.requests_migrated += 1

    def _on_handoff(self, ev: PrefillHandoff) -> None:
        c = self.counters
        c.prefill_handoffs += 1
        c.handoff_pages += ev.pages_copied
        c.handoff_recompute_tokens += ev.recompute_tokens
        self.handoff_latencies.record(ev.latency_s)

    # ------------------------------------------------------------------
    @property
    def max_preemptions_per_request(self) -> int:
        return max(self.counters.per_request_preemptions.values(), default=0)

    def snapshot(self) -> Dict[str, object]:
        """One flat dict — what orchestrator metrics / harness reports read
        instead of reaching into per-plane stat objects."""
        c = self.counters
        return {
            'compute_preemptions': c.preemptions,
            'offline_wakeups': c.wakeups,
            'reclamations': c.reclamations,
            'handles_reclaimed': c.handles_reclaimed,
            'pages_invalidated': c.pages_invalidated,
            'requests_invalidated': c.requests_invalidated,
            'requests_killed': c.requests_killed,
            'memory_pressure_events': c.memory_pressure_events,
            'reservation_changes': c.reservation_changes,
            'pages_migrated': c.pages_migrated,
            'requests_migrated': c.requests_migrated,
            'prefill_handoffs': c.prefill_handoffs,
            'handoff_pages': c.handoff_pages,
            'handoff_recompute_tokens': c.handoff_recompute_tokens,
            'handoff_latency': self.handoff_latencies.summary(),
            'max_preemptions_per_request': self.max_preemptions_per_request,
            'preemption_latency': self.preemption_latencies.summary(),
        }

    # ------------------------------------------------------------------
    def check_invariants(self, *, gates=None,
                         require_gate_closed: bool = True,
                         max_preempt_per_request: Optional[int] = 1) -> None:
        """Check the paper's §4–5 invariants against the event log.

        - event ordering (§5 compute-first, §4.2 T_cool wake rule);
        - wake-ups == gate enables when ``gates`` (a GateGroup) is given —
          a wake-up the log never saw, or a gate enable that bypassed the
          wake-up path, both fail here;
        - ≤ ``max_preempt_per_request`` preemptions per online request
          (None disables — baseline strategies violate it by design).
        """
        check_event_ordering(list(self.bus.log),
                             require_gate_closed=require_gate_closed)
        if gates is not None:
            for g in gates.gates:
                assert g.stats.enables == self.counters.wakeups, \
                    (g.device_id, g.stats.enables, self.counters.wakeups)
        if max_preempt_per_request is not None:
            for rid, n in self.counters.per_request_preemptions.items():
                assert n <= max_preempt_per_request, \
                    f'request {rid} preempted {n}× ' \
                    f'(> {max_preempt_per_request})'
