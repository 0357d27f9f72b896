"""Channel-controlled compute isolation — TPU adaptation (paper §4.1).

The paper pauses offline GPU work by disabling its *channel* via a KMD ioctl
(< 1 ms, no kernel-boundary wait).  Our TPU analogue is a per-device
**dispatch gate**: the offline engine checks its gate between (sub-layer)
program dispatches and never enqueues while gated, so preemption latency is
gate-flip time + one bounded in-flight chunk.

The paper's one-line driver change removes a node-global KMD lock so multi-GPU
preemption stops scaling O(#GPUs).  We model both regimes:

- ``serial``  — every gate flip holds one node lock (the un-patched driver);
- ``fanout``  — flips are issued concurrently per device (the patched driver).

``benchmarks/preemption_latency.py`` reproduces the paper's >5 ms → <1 ms
8-GPU measurement against these two modes.
"""
from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import List, Optional

from repro_torch.core.clock import RealClock


@dataclass
class GateStats:
    disables: int = 0
    enables: int = 0
    last_disable_t: float = -1.0
    last_enable_t: float = -1.0


class DeviceGate:
    """Per-device dispatch gate (the channel analogue).

    ``op_latency_s`` models the per-device control-command cost (the ioctl /
    dispatch-queue round trip); 0 for pure-overhead measurements.
    """

    def __init__(self, device_id: int = 0, op_latency_s: float = 0.0,
                 clock=None):
        self.device_id = device_id
        self.op_latency_s = op_latency_s
        self.clock = clock or RealClock()
        self._enabled = threading.Event()
        self._enabled.set()
        self.stats = GateStats()

    # -- control plane ----------------------------------------------------
    # ``charge_latency=False`` lets a group-level flip charge the modeled
    # op latency once for the whole fan-out instead of per device.
    # Both flips return THIS device's measured flip latency in seconds
    # (wall time under a real clock, the charged model under a virtual
    # one) — the group folds these into the event stream.
    def disable(self, now: Optional[float] = None, *,
                charge_latency: bool = True) -> float:
        t0 = self.clock.now()
        if self.op_latency_s and charge_latency:
            self.clock.sleep(self.op_latency_s)
        self._enabled.clear()
        self.stats.disables += 1
        self.stats.last_disable_t = self.clock.now() if now is None else now
        return self.clock.now() - t0

    def enable(self, now: Optional[float] = None, *,
               charge_latency: bool = True) -> float:
        t0 = self.clock.now()
        if self.op_latency_s and charge_latency:
            self.clock.sleep(self.op_latency_s)
        self._enabled.set()
        self.stats.enables += 1
        self.stats.last_enable_t = self.clock.now() if now is None else now
        return self.clock.now() - t0

    # -- data plane (called by the offline engine between chunks) ---------
    @property
    def enabled(self) -> bool:
        return self._enabled.is_set()

    def wait_enabled(self, timeout: Optional[float] = None) -> bool:
        return self._enabled.wait(timeout)


class GateGroup:
    """Node-level gate fan-out across devices.

    mode='serial': flips issued one-by-one under a single node lock —
    preemption latency grows linearly with #devices (un-patched driver).
    mode='fanout': flips issued concurrently — latency ≈ max over devices
    (the paper's 1-line driver change).
    """

    def __init__(self, gates: List[DeviceGate], mode: str = 'fanout',
                 clock=None):
        assert mode in ('serial', 'fanout'), mode
        self.gates = gates
        self.mode = mode
        self.clock = clock or RealClock()
        self._node_lock = threading.Lock()
        # per-device flip latencies of the most recent group flip, indexed
        # like ``gates`` — the runtime folds these into PreemptionEvents
        self.last_flip_latencies: tuple = ()
        # a virtual clock charges modeled latencies synchronously — real
        # threads would race on the shared clock and record sums, not maxes
        self._pool = (ThreadPoolExecutor(max_workers=max(len(gates), 1))
                      if mode == 'fanout' and not self.clock.virtual
                      else None)

    def _apply(self, fn_name: str) -> float:
        """Flip all gates; returns elapsed seconds (the preemption latency).

        Each branch also records the MEASURED per-device flip latency in
        ``last_flip_latencies``: serial flips measure under the node lock,
        real-clock fanout measures inside each worker thread, and
        virtual-clock fanout charges every device its own modeled latency
        (the group advances the shared clock once, by the max)."""
        t0 = self.clock.now()
        if self.mode == 'serial':
            # un-patched driver: node lock serializes → Σ op latencies
            # (each gate charges its latency on the shared clock, so this
            # branch is correct under both real and virtual clocks)
            with self._node_lock:
                per = [getattr(g, fn_name)() for g in self.gates]
        elif self.clock.virtual:
            # patched driver under a virtual clock: concurrent flips →
            # max op latency, charged once for the group
            self.clock.sleep(max((g.op_latency_s for g in self.gates),
                                 default=0.0))
            per = []
            for g in self.gates:
                getattr(g, fn_name)(charge_latency=False)
                per.append(g.op_latency_s)
        else:
            futs = [self._pool.submit(getattr(g, fn_name))
                    for g in self.gates]
            per = [f.result() for f in futs]
        self.last_flip_latencies = tuple(per)
        return self.clock.now() - t0

    def disable_all(self) -> float:
        return self._apply('disable')

    def enable_all(self) -> float:
        return self._apply('enable')

    @property
    def all_disabled(self) -> bool:
        return all(not g.enabled for g in self.gates)

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False)
