"""Fault tolerance for 1000+-node runs: heartbeats, elastic re-meshing,
straggler mitigation.

All host-side control-plane logic — deliberately clock-injected so the unit
tests drive it deterministically, and the same machinery feeds the cluster
scheduler's P_multi alignment score (core/cluster/perfmodel.py).
"""
from __future__ import annotations

import math
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence, Tuple


# ---------------------------------------------------------------------------
# Heartbeats
# ---------------------------------------------------------------------------

@dataclass
class HeartbeatConfig:
    interval_s: float = 10.0
    miss_threshold: int = 3      # misses before a host is declared dead


class HeartbeatMonitor:
    """Coordinator-side liveness tracking."""

    def __init__(self, hosts: Sequence[str],
                 cfg: Optional[HeartbeatConfig] = None):
        self.cfg = cfg or HeartbeatConfig()
        self.last_seen: Dict[str, float] = {h: 0.0 for h in hosts}
        self.dead: set = set()

    def beat(self, host: str, now: float) -> None:
        if host not in self.dead:
            self.last_seen[host] = now

    def check(self, now: float) -> List[str]:
        """Returns hosts newly declared dead at ``now``."""
        limit = self.cfg.interval_s * self.cfg.miss_threshold
        newly = [h for h, t in self.last_seen.items()
                 if h not in self.dead and now - t > limit]
        self.dead.update(newly)
        return newly

    @property
    def alive(self) -> List[str]:
        return [h for h in self.last_seen if h not in self.dead]


# ---------------------------------------------------------------------------
# Elastic re-meshing
# ---------------------------------------------------------------------------

def elastic_mesh_shape(n_devices: int, model_parallel: int
                       ) -> Optional[Tuple[int, int]]:
    """Largest (data, model) mesh fitting the survivors.

    The model axis is fixed (param shards must stay complete); the data axis
    shrinks to the largest multiple that fits.  None if even one model group
    cannot be formed.
    """
    if n_devices < model_parallel:
        return None
    return (n_devices // model_parallel, model_parallel)


@dataclass
class ElasticPlan:
    old_shape: Tuple[int, ...]
    new_shape: Tuple[int, int]
    lost_hosts: List[str]
    restore_step: int


def plan_recovery(monitor: HeartbeatMonitor, devices_per_host: int,
                  model_parallel: int, last_ckpt_step: Optional[int],
                  old_shape: Tuple[int, ...], now: float
                  ) -> Optional[ElasticPlan]:
    """On heartbeat loss: shrink the data axis, restore the last checkpoint.

    Returns None when nothing died or no viable mesh remains (full restart
    needed)."""
    newly = monitor.check(now)
    if not newly:
        return None
    n = len(monitor.alive) * devices_per_host
    shape = elastic_mesh_shape(n, model_parallel)
    if shape is None or last_ckpt_step is None:
        return None
    return ElasticPlan(old_shape, shape, newly, last_ckpt_step)


# ---------------------------------------------------------------------------
# Straggler mitigation
# ---------------------------------------------------------------------------

@dataclass
class StragglerConfig:
    window: int = 32             # per-host step-time samples
    ratio: float = 1.5           # slow if EWMA > ratio × cluster median
    ewma_alpha: float = 0.25
    min_samples: int = 8


class StragglerDetector:
    """Per-host step-time telemetry → quarantine recommendations.

    The same busy-interval telemetry feeds Valve's P_multi placement score;
    a quarantined host is excluded from offline placement and flagged to the
    training launcher for data-axis exclusion at the next re-mesh.
    """

    def __init__(self, cfg: Optional[StragglerConfig] = None):
        self.cfg = cfg or StragglerConfig()
        self.ewma: Dict[str, float] = {}
        self.count: Dict[str, int] = defaultdict(int)
        self.quarantined: set = set()

    def record(self, host: str, step_time_s: float) -> None:
        a = self.cfg.ewma_alpha
        prev = self.ewma.get(host)
        self.ewma[host] = (step_time_s if prev is None
                           else a * step_time_s + (1 - a) * prev)
        self.count[host] += 1

    def _median(self) -> Optional[float]:
        vals = sorted(v for h, v in self.ewma.items()
                      if self.count[h] >= self.cfg.min_samples)
        if not vals:
            return None
        m = len(vals) // 2
        return vals[m] if len(vals) % 2 else 0.5 * (vals[m - 1] + vals[m])

    def stragglers(self) -> List[str]:
        med = self._median()
        if med is None or med <= 0:
            return []
        out = [h for h, v in self.ewma.items()
               if self.count[h] >= self.cfg.min_samples
               and v > self.cfg.ratio * med]
        self.quarantined.update(out)
        return out
