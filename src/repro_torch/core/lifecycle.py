"""Online request lifecycle awareness (paper §4.2).

Tracks when the online workload is busy and decides when offline work may be
woken.  The paper's guarantee: **at most one preemption per online request**.
The mechanism: never wake offline inside the short idle gaps between decode
iterations — wake only after a continuous-idle *cooldown*
``T_cool = 2 × max decode gap`` (gap telemetry measured by the runtime).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, Optional, Set


@dataclass
class LifecycleStats:
    requests_seen: int = 0
    preemptions: int = 0
    wakeups: int = 0
    # per-request preemption counts (property: each value ≤ 1)
    preempted_requests: Dict[str, int] = field(default_factory=dict)


class OnlineLifecycleTracker:
    """Tracks online request lifetimes + decode-gap telemetry.

    The engine calls :meth:`request_start` / :meth:`request_end` and
    :meth:`iteration_start` / :meth:`iteration_end`; the runtime polls
    :meth:`busy` and :meth:`may_wake_offline`.
    """

    def __init__(self, *, t_cool_init: float = 0.010, gap_window: int = 4096,
                 cool_factor: float = 2.0):
        self.active: Set[str] = set()
        self.cool_factor = cool_factor
        self._t_cool = t_cool_init
        self._gaps: Deque[float] = deque(maxlen=gap_window)
        self._last_iter_end: Optional[float] = None
        self._last_busy_t: float = -1e30
        self._in_iteration = False
        self.stats = LifecycleStats()

    # -- engine-side notifications ----------------------------------------
    def request_start(self, req_id: str, now: float) -> None:
        if not self.active:
            # idle → busy boundary: the span since the last iteration is
            # idle time, not an inter-iteration gap — reset the gap chain
            # or a post-idle arrival would record the whole idle period
            # and ratchet T_cool unboundedly
            self._last_iter_end = None
        self.active.add(req_id)
        self._last_busy_t = now
        self.stats.requests_seen += 1

    def request_end(self, req_id: str, now: float) -> None:
        self.active.discard(req_id)
        self._last_busy_t = now

    def iteration_start(self, now: float) -> None:
        # a decode gap is the pause *between iterations of live requests*;
        # idle time between requests is not a gap (it would inflate T_cool
        # unboundedly and starve offline)
        if self._last_iter_end is not None and self.active:
            self._gaps.append(max(now - self._last_iter_end, 0.0))
        self._in_iteration = True
        self._last_busy_t = now

    def iteration_end(self, now: float) -> None:
        self._in_iteration = False
        self._last_iter_end = now
        self._last_busy_t = now

    def note_preemption(self, now: float) -> None:
        """A preemption fired while these requests were in flight."""
        self.stats.preemptions += 1
        for r in self.active:
            self.stats.preempted_requests[r] = \
                self.stats.preempted_requests.get(r, 0) + 1

    # -- telemetry ---------------------------------------------------------
    @property
    def max_gap(self) -> float:
        return max(self._gaps) if self._gaps else 0.0

    @property
    def t_cool(self) -> float:
        """T_cool = cool_factor × max observed decode gap (paper §4.2)."""
        g = self.max_gap
        return max(self.cool_factor * g, self._t_cool) if g > 0 else self._t_cool

    # -- runtime-side queries ----------------------------------------------
    def busy(self, now: float) -> bool:
        return bool(self.active) or self._in_iteration

    def idle_for(self, now: float) -> float:
        return now - self._last_busy_t

    def may_wake_offline(self, now: float) -> bool:
        """Continuously idle for ≥ T_cool — waking here cannot collide with a
        decode-iteration gap, so a running online request is never preempted
        more than once."""
        return not self.busy(now) and self.idle_for(now) >= self.t_cool
