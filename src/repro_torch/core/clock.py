"""Clock abstraction so the Valve runtime runs identically under real
wall-clock (live colocation demo) and the discrete-event simulator."""
from __future__ import annotations

import time


class RealClock:
    virtual = False

    def now(self) -> float:
        return time.monotonic()

    def sleep(self, dt: float) -> None:
        time.sleep(max(dt, 0.0))


class VirtualClock:
    """Manually-advanced clock for deterministic simulation.

    ``virtual = True`` lets clock-domain-aware components (the gate group)
    switch from measuring wall time to charging modeled latencies, so
    sim-recorded timings are deterministic instead of wall-clock noise.
    """

    virtual = True

    def __init__(self, t0: float = 0.0):
        self._t = float(t0)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> None:
        assert dt >= 0.0, dt
        self._t += dt

    def advance_to(self, t: float) -> None:
        assert t >= self._t - 1e-12, (t, self._t)
        self._t = max(self._t, t)

    def sleep(self, dt: float) -> None:
        self.advance(dt)
