"""MIAD (Multiplicative-Increase, Additive-Decrease) dynamic online memory
reservation (paper §5).

Valve keeps a dynamic online KV-cache headroom ``H`` of pre-mapped handles:

- on a *pressure event* (online usage ≥ 90 % of H) → ``H ← ceil(α·H)``;
- absent pressure, release one handle every interval ``T``.

``T`` itself is MIAD-controlled against a user target pressure-event *rate*:
if the event rate over a sliding window exceeds the target, ``T`` increases
multiplicatively (hold reservations longer → fewer reclamations); otherwise it
decreases additively (return memory to offline faster).  The controller drives
the reclamation rate toward the target while maximizing offline memory.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Optional


@dataclass
class MIADConfig:
    alpha: float = 1.5              # multiplicative increase of H
    pressure_util: float = 0.90     # pressure-event threshold on H utilization
    h_min: int = 1
    h_max: int = 1 << 30            # cap at the pool's handle count
    t_init: float = 1.0             # initial release interval (s)
    t_min: float = 0.125
    # t_max must exceed the burst spacing for low targets to be reachable —
    # safe now that only ACTUAL reclamations (not H-growth ticks) feed the
    # rate estimate, so T cannot ratchet on a single burst
    t_max: float = 64.0
    t_beta: float = 1.5             # multiplicative increase of T
    t_step: float = 0.25            # additive decrease of T (per second)
    target_rate: float = 0.1        # target RECLAMATION events / s
    # long window: the target bounds the LONG-RUN reclamation rate; a short
    # window lets a single burst pin T at t_max for the whole window
    rate_window: float = 120.0


@dataclass
class MIADStats:
    pressure_events: int = 0
    releases: int = 0
    h_trajectory: List = field(default_factory=list)


class MIADReservation:
    """Controls the online reserved-handle headroom H and interval T."""

    def __init__(self, h_init: int, cfg: Optional[MIADConfig] = None):
        self.cfg = cfg or MIADConfig()
        self.h = max(h_init, self.cfg.h_min)
        self.t = self.cfg.t_init
        self._events: Deque[float] = deque()
        self._t_observe_start: Optional[float] = None
        self._last_release = -1e30
        self._last_t_update = -1e30
        self.stats = MIADStats()

    # ------------------------------------------------------------------
    def _event_rate(self, now: float) -> float:
        """Events per second over the *elapsed* horizon.

        During warm-up (first ``rate_window`` seconds of observation) the
        denominator is the time actually observed, not the full window —
        dividing by the window would underestimate the rate exactly when a
        burst starts, and T would fail to increase multiplicatively until a
        whole window had passed.
        """
        w = self.cfg.rate_window
        while self._events and self._events[0] < now - w:
            self._events.popleft()
        if len(self._events) < 2:
            # a single event over a near-zero elapsed horizon is
            # rate-indeterminate, not a burst — fall back to the full
            # window rather than reading one reclamation as 1000/s
            return len(self._events) / w
        start = self._t_observe_start if self._t_observe_start is not None \
            else self._events[0]
        horizon = min(w, max(now - start, 1e-3))
        return len(self._events) / horizon

    def note_reclamation(self, now: float) -> None:
        """An actual reclamation fired — the interference event whose rate
        the T controller drives toward the user target."""
        if self._t_observe_start is None:
            self._t_observe_start = now
        self._events.append(now)

    def on_tick(self, now: float, online_used: int) -> int:
        """Advance the controller; returns the new reservation H.

        ``online_used``: handles currently consumed by online KV cache.
        """
        c = self.cfg
        if self._t_observe_start is None:
            self._t_observe_start = now
        pressured = online_used >= c.pressure_util * self.h
        if pressured:
            # multiplicative increase: pre-map more handles ahead of demand
            self.h = min(int(math.ceil(self.h * c.alpha)), c.h_max)
            self.stats.pressure_events += 1
            self._last_release = now          # restart the release timer
        elif now - self._last_release >= self.t:
            # additive decrease: return one handle to offline
            if self.h > max(c.h_min, online_used):
                self.h -= 1
                self.stats.releases += 1
            self._last_release = now

        # adapt T against the target reclamation rate (MIAD on T)
        if now - self._last_t_update >= 1.0:
            self._last_t_update = now
            if self._event_rate(now) > c.target_rate:
                self.t = min(self.t * c.t_beta, c.t_max)
            else:
                self.t = max(self.t - c.t_step, c.t_min)

        self.stats.h_trajectory.append((now, self.h))
        return self.h

    @property
    def reservation(self) -> int:
        return self.h
