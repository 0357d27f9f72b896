"""ValveRuntime — the node-level GPU-colocation-runtime analogue (paper §3–5).

Composes the four mechanisms into the joint bound the paper is named for:

- **preemption latency**: :class:`GateGroup` fan-out flips all device gates in
  ~O(1); the offline engine's in-flight residual is one sub-layer chunk.
- **preemption rate**: :class:`OnlineLifecycleTracker` gates offline wake-ups
  behind ``T_cool`` (≤ 1 compute preemption per online request); MIAD keeps
  memory-reclamation frequency at the user target.
- **memory safety**: reclamation goes through :class:`ReclamationController`
  (compute-first ordering, quarantine remap, invalidated-ID callback).

**Control-plane API v1** (see ``docs/API.md``): frameworks integrate through
:meth:`open_session` (class-scoped :class:`~repro_torch.core.api.ValveSession`
handles that own alloc/notify/gate-check/invalidation routing) and observe
through :meth:`subscribe` (the typed event stream of
:mod:`repro_torch.core.events`).  Every counter in ``runtime.stats`` /
``lifecycle.stats`` is *derived from the event stream* by the
:class:`~repro_torch.core.telemetry.TelemetryRegistry` at ``runtime.telemetry`` —
the hot path publishes facts, never hand-syncs counters, and
:meth:`check_invariants` checks the event log.

**Memory-plane API v1** (``repro_torch.core.memory``): allocation goes through
``runtime.memory`` — sessions return :class:`~repro_torch.core.memory.KVLease`
handles (refcounted, prefix-sharing, partially invalidatable), and the
invalidation callback carries per-request surviving prefixes.  The
klass-string methods (``alloc_online``/``alloc_offline``/``free_*``) and
the per-request invalidation route table (``bind_invalidation``/
``unbind_invalidation``) are **deprecated shims** over hidden legacy
sessions/leases; new integrations should hold a session.

The runtime is clock-agnostic: a :class:`RealClock` drives the live demo and
a :class:`VirtualClock` drives the discrete-event simulator, so the paper's
§7.2 experiments exercise *this* code, not a model of it.
"""
from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Type

from repro_torch.core.clock import RealClock
from repro_torch.core.events import (
    EventBus, MemoryPressureEvent, PreemptionEvent, ReservationChangeEvent,
    RuntimeEvent, WakeupEvent)
from repro_torch.core.gate import DeviceGate, GateGroup
from repro_torch.core.lifecycle import OnlineLifecycleTracker
from repro_torch.core.memory import KVLease, MemoryPlane
from repro_torch.core.miad import MIADConfig, MIADReservation
from repro_torch.core.reclamation import InvalidationCallback, ReclamationController
from repro_torch.core.telemetry import TelemetryRegistry
from repro_torch.serving.kvpool import KVPool


@dataclass
class RuntimeConfig:
    n_devices: int = 1
    # Device topology: a launch.mesh.Mesh (the one the engines shard
    # over).  When set, the runtime instantiates one DeviceGate per mesh
    # device — overriding n_devices — so the gate fan-out is the real
    # flip across the serving mesh, not a modeled count.
    mesh: Optional[object] = None
    gate_mode: str = 'fanout'          # 'fanout' (patched driver) | 'serial'
    gate_op_latency_s: float = 0.0
    policy: str = 'valve'              # eviction policy: 'valve' | 'fifo'
    miad: MIADConfig = field(default_factory=MIADConfig)
    t_cool_init: float = 0.010
    # bounded replay log / latency reservoir sizes (telemetry memory bound)
    event_log_maxlen: int = 65536
    latency_reservoir: int = 512
    # memory mode (paper §7.2 baselines live in core/sim/strategies.py; the
    # real runtime always runs the paper's OurMem path)


@dataclass
class RuntimeStats:
    """Legacy counter mirror — populated by the TelemetryRegistry from the
    event stream (never mutated by the runtime hot path).  Reads are fine;
    new code should prefer ``runtime.telemetry.snapshot()``.
    ``preemption_latencies`` is a bounded
    :class:`~repro_torch.core.telemetry.LatencySummary` (list-like while small;
    ``.raw``/``.summary()`` for tests and reports)."""
    compute_preemptions: int = 0
    offline_wakeups: int = 0
    preemption_latencies: object = field(default_factory=list)
    memory_pressure_events: int = 0


class ValveRuntime:
    """One node: one online engine, ≥0 offline engines, one shared KV pool."""

    def __init__(self, pool: KVPool, cfg: Optional[RuntimeConfig] = None,
                 *, clock=None,
                 on_invalidate: Optional[InvalidationCallback] = None):
        self.cfg = cfg or RuntimeConfig()
        self.clock = clock or RealClock()
        self.pool = pool
        # -- memory plane: lease-based allocation over the physical pool --
        self.memory = MemoryPlane.of(pool)
        # route lifetime == lease lifetime: whenever a lease fully dies
        # (finish, close, zero-survivor invalidation, spill) its delivery
        # route dies with it — one mechanism for every terminal path
        self.memory.on_release = self._lease_released
        # -- control plane: event stream + derived telemetry ------------
        self.bus = EventBus(self.clock, log_maxlen=self.cfg.event_log_maxlen)
        # the pool publishes PageMigration on the runtime bus (cross-pool
        # rescue observability); aux pools registered by the orchestrator
        # share the same bus so node-wide folds see every migration
        if getattr(pool, 'bus', None) is None:
            pool.bus = self.bus
        self.lifecycle = OnlineLifecycleTracker(
            t_cool_init=self.cfg.t_cool_init)
        self.stats = RuntimeStats()
        self.telemetry = TelemetryRegistry(
            self.bus, stats=self.stats, lifecycle=self.lifecycle,
            latency_cap=self.cfg.latency_reservoir)
        # -- sessions: name → session; request id → owning session ------
        self.sessions: Dict[str, object] = {}
        self._session_seq = itertools.count()
        self._owner: Dict[str, object] = {}
        self._legacy_sessions: Dict[str, object] = {}
        # deprecated per-request invalidation route table (bind/unbind);
        # ids with neither a session owner nor a bound route fall back to
        # the legacy single ``on_invalidate`` callback (if any)
        self._invalidation_route: Dict[str, InvalidationCallback] = {}
        self._invalidation_fallback = on_invalidate
        # gates share the runtime clock so sim runs record modeled (and
        # deterministic) flip latencies, not wall-clock noise.  With a
        # mesh, one gate per mesh device: preemption is the real fan-out
        # across the serving mesh, and each PreemptionEvent folds the
        # measured per-device flip latencies into the stream.
        n_dev = self.cfg.n_devices
        if self.cfg.mesh is not None:
            n_dev = self.cfg.mesh.devices.size
        self.n_devices = n_dev
        self.gates = GateGroup(
            [DeviceGate(i, self.cfg.gate_op_latency_s, clock=self.clock)
             for i in range(n_dev)],
            mode=self.cfg.gate_mode, clock=self.clock)
        miad_cfg = dataclasses.replace(
            self.cfg.miad, h_max=min(self.cfg.miad.h_max, pool.n_handles))
        self.miad = MIADReservation(h_init=len(pool.reserved), cfg=miad_cfg)
        self.reclaimer = ReclamationController(
            pool,
            gate_is_closed=lambda: self.gates.all_disabled,
            on_invalidate=self._route_invalidation,
            policy=self.cfg.policy,
            bus=self.bus)

    # ------------------------------------------------------------------
    # Control-plane API v1: sessions + event subscription
    # ------------------------------------------------------------------
    def open_session(self, klass: str, name: Optional[str] = None, *,
                     on_invalidate: Optional[InvalidationCallback] = None):
        """Open a class-scoped session (the framework integration handle).

        ``name`` must be unique per runtime (it prefixes minted request
        ids); defaults to ``{klass}{n}`` in open order (monotonic — names
        are never reissued after a close).
        """
        from repro_torch.core.api import ValveSession
        if name is None:
            name = f'{klass}{next(self._session_seq)}'
        assert name not in self.sessions, f'duplicate session name {name!r}'
        sess = ValveSession(self, klass, name, on_invalidate=on_invalidate)
        self.sessions[name] = sess
        return sess

    def subscribe(self, callback: Callable[[RuntimeEvent], None],
                  event_type: Optional[Type[RuntimeEvent]] = None
                  ) -> Callable[[], None]:
        """Observe the typed event stream; returns an unsubscribe thunk."""
        return self.bus.subscribe(callback, event_type)

    def invalidation_routes(self) -> List[str]:
        """Live request ids with a delivery route (session ownership or a
        legacy bound callback).  Terminal paths must drain this to empty —
        pinned by the node-run regression test."""
        return sorted(set(self._owner) | set(self._invalidation_route))

    # -- session internals (called by ValveSession) ---------------------
    def _session_alloc(self, sess, req_id: str, n_pages: int,
                       prompt=None) -> Optional[KVLease]:
        if sess.klass == 'online':
            got = self._alloc_online(req_id, n_pages, prompt=prompt,
                                     scope=sess.name)
        else:
            got = self._alloc_offline(req_id, n_pages, prompt=prompt,
                                      scope=sess.name)
        if got is not None:
            self._owner[req_id] = sess
        return got

    def _session_free(self, sess, req_id: str) -> None:
        self.memory.release_id(req_id)
        self._owner.pop(req_id, None)

    def _lease_released(self, req_id: str) -> None:
        self._owner.pop(req_id, None)

    def _session_owned(self, sess) -> List[str]:
        return sorted(r for r, s in self._owner.items() if s is sess)

    def _session_closed(self, sess) -> None:
        self.sessions.pop(sess.name, None)

    def _legacy_session(self, klass: str):
        """Hidden sessions backing the deprecated klass-string methods."""
        sess = self._legacy_sessions.get(klass)
        if sess is None:
            from repro_torch.core.api import ValveSession
            sess = ValveSession(self, klass, f'legacy-{klass}')
            self._legacy_sessions[klass] = sess
        return sess

    def _legacy_alloc(self, klass: str, req_id: str, n_pages: int
                      ) -> Optional[KVLease]:
        """Shim fast path: jump straight to the session internals instead
        of re-entering through ``ValveSession.alloc`` (the shims used to
        pay the public wrapper a second time on every call)."""
        sess = self._legacy_sessions.get(klass) or self._legacy_session(klass)
        return self._session_alloc(sess, req_id, n_pages)

    # ------------------------------------------------------------------
    # Invalidation fan-out: one reclamation's {req: pages} is split by the
    # OWNING SESSION (allocation records ownership, so same-class engines
    # cannot mis-route) and delivered once per session callback.
    # ------------------------------------------------------------------
    def bind_invalidation(self, req_id: str, cb: InvalidationCallback) -> None:
        """DEPRECATED — open a session with ``on_invalidate`` instead; the
        session routes by ownership and cannot leak route entries."""
        self._invalidation_route[req_id] = cb

    def unbind_invalidation(self, req_id: str) -> None:
        """DEPRECATED — see :meth:`bind_invalidation`."""
        self._invalidation_route.pop(req_id, None)

    def _route_invalidation(self, invalidated: Dict[str, List[int]]) -> None:
        groups: Dict[object, Dict[str, List[int]]] = {}
        unrouted: Dict[str, List[int]] = {}
        for rid, pages in invalidated.items():
            if getattr(pages, 'migrated_to', None) is not None:
                # rescued cross-pool: the lease (and its KV) moved intact
                # to another pool's plane — there is nothing for the local
                # engine to truncate or recompute, and the orchestrator
                # hands the request off via the PageMigration event.  The
                # local route already died in MemoryPlane.migrate.
                continue
            sess = self._owner.get(rid)
            # a session without its own callback (e.g. the hidden legacy
            # sessions behind the klass-string shims) must not shadow a
            # per-request bound route — fall through to it
            cb = (sess.on_invalidate if sess is not None else None) \
                or self._invalidation_route.get(rid)
            if cb is None:
                unrouted[rid] = pages
            else:
                groups.setdefault(cb, {})[rid] = pages
        for cb, group in groups.items():
            cb(group)
        if unrouted and self._invalidation_fallback is not None:
            self._invalidation_fallback(unrouted)
        # route lifetime == lease lifetime.  This pop is LOAD-BEARING for
        # every released lease: the invalidation path releases with
        # notify=False (the delivery above must still find the route), so
        # the plane's on_release hook deliberately did NOT fire — routes
        # for zero-survivor leases and legacy whole-freed ids drop here,
        # after delivery.  A request with a SURVIVING prefix keeps lease
        # and route: the next invalidation must still reach its session.
        for rid, inv in invalidated.items():
            if getattr(inv, 'released', True):
                self._owner.pop(rid, None)

    # ------------------------------------------------------------------
    # Online engine hooks (sessions call these; total patch surface on the
    # online side is request/iteration notifications).
    # ------------------------------------------------------------------
    def on_online_request_start(self, req_id: str) -> None:
        now = self.clock.now()
        self.lifecycle.request_start(req_id, now)
        self._preempt_offline_if_running(trigger='lifecycle')

    def on_online_request_end(self, req_id: str) -> None:
        self.lifecycle.request_end(req_id, self.clock.now())

    def on_online_iteration_start(self) -> None:
        now = self.clock.now()
        self.lifecycle.iteration_start(now)
        self._preempt_offline_if_running(trigger='lifecycle')

    def on_online_iteration_end(self) -> None:
        self.lifecycle.iteration_end(self.clock.now())

    def _preempt_offline_if_running(self, trigger: str) -> None:
        if not self.gates.all_disabled:
            latency = self.gates.disable_all()
            self.bus.publish(
                PreemptionEvent, latency_s=latency,
                requests=tuple(sorted(self.lifecycle.active)),
                trigger=trigger,
                device_latencies_s=self.gates.last_flip_latencies)

    # ------------------------------------------------------------------
    # Memory plane (session-internal; the klass-string methods below are
    # deprecated shims over hidden legacy sessions)
    # ------------------------------------------------------------------
    def _alloc_online(self, req_id: str, n_pages: int, *, prompt=None,
                      scope=None) -> Optional[KVLease]:
        """Lease online KV pages from the MIAD reservation; on shortfall,
        reclaim offline handles (compute-first) to cover it."""
        got = self.memory.admit(req_id, n_pages, 'online',
                                prompt=prompt, scope=scope)
        if got is not None:
            return got
        now = self.clock.now()
        held = self.memory.get(req_id)
        missing = n_pages - (len(held) if held is not None else 0)
        deficit = missing - self.pool.free_pages_for('online')
        self.bus.publish(MemoryPressureEvent, req_id=req_id,
                         deficit_pages=deficit)
        n_handles = -(-deficit // self.pool.pph)  # ceil
        self._with_gates_closed_reclaim(n_handles, now)
        return self.memory.admit(req_id, n_pages, 'online',
                                 prompt=prompt, scope=scope)

    def _alloc_offline(self, req_id: str, n_pages: int, *, prompt=None,
                       scope=None) -> Optional[KVLease]:
        got = self.memory.admit(req_id, n_pages, 'offline',
                                prompt=prompt, scope=scope)
        if got is not None and len(got._pages) > 0:
            # one recency note per distinct handle (pages cluster, so the
            # set is tiny) instead of one per page
            now = self.clock.now()
            handle_of = self.pool.handle_of
            for h in {handle_of(p) for p in got._pages}:
                self.reclaimer.note_handle_use(h, now)
        return got

    def alloc_online(self, req_id: str, n_pages: int) -> Optional[KVLease]:
        """DEPRECATED — use ``open_session('online').alloc`` instead.
        Returns the hidden lease (list-like: iterates as the page ids)."""
        return self._legacy_alloc('online', req_id, n_pages)

    def free_online(self, req_id: str) -> None:
        """DEPRECATED — use the owning session's ``free``/``finish``."""
        self.memory.release_id(req_id)
        self._owner.pop(req_id, None)

    def alloc_offline(self, req_id: str, n_pages: int) -> Optional[KVLease]:
        """DEPRECATED — use ``open_session('offline').alloc`` instead.
        Returns the hidden lease (list-like: iterates as the page ids)."""
        return self._legacy_alloc('offline', req_id, n_pages)

    def free_offline(self, req_id: str) -> None:
        """DEPRECATED — use the owning session's ``free``/``finish``."""
        self.memory.release_id(req_id)
        self._owner.pop(req_id, None)

    def _with_gates_closed_reclaim(self, n_handles: int, now: float
                                   ) -> Dict[str, List[int]]:
        """Paper §5 ordering: compute gate closes before any page moves."""
        was_open = not self.gates.all_disabled
        if was_open:
            self._preempt_offline_if_running(trigger='memory')
        try:
            inv = self.reclaimer.reclaim(n_handles, now)
            self.miad.note_reclamation(now)
            return inv
        finally:
            if was_open and self.lifecycle.may_wake_offline(now):
                self._wake_offline()

    def _wake_offline(self) -> None:
        """Re-enable offline compute — the ONLY path that opens the gates,
        so the WakeupEvent count always agrees with gate enable counts
        (both the tick path and the reclaim finally-branch go through it)."""
        now = self.clock.now()
        self.gates.enable_all()
        self.bus.publish(WakeupEvent,
                         idle_for_s=self.lifecycle.idle_for(now),
                         t_cool_s=self.lifecycle.t_cool)

    # ------------------------------------------------------------------
    # Periodic tick: MIAD reservation + offline wake-up
    # ------------------------------------------------------------------
    def tick(self) -> None:
        now = self.clock.now()
        h0 = len(self.pool.reserved)
        h_target = self.miad.on_tick(now, self.pool.online_used_handles())
        self._apply_reservation(h_target, now)
        if len(self.pool.reserved) != h0:
            self.bus.publish(ReservationChangeEvent, h_before=h0,
                             h_after=len(self.pool.reserved), reason='miad')
        if self.gates.all_disabled and self.lifecycle.may_wake_offline(now):
            self._wake_offline()

    def _apply_reservation(self, h_target: int, now: float) -> None:
        """Grow/shrink the pool's reserved-handle set toward MIAD's H."""
        cur = len(self.pool.reserved)
        while cur < h_target:
            empties = self.pool.empty_offline_handles()
            if empties:
                self.pool.reserve_handle(empties[0], now)
            else:
                # growth must come from offline-held handles → reclamation
                inv = self._with_gates_closed_reclaim(1, now)
                if not inv and not self.pool.empty_offline_handles():
                    break  # nothing reclaimable (pool exhausted by online)
            cur = len(self.pool.reserved)
        while cur > h_target:
            if self.pool.release_reserved_handle() is None:
                break  # all reserved handles hold online pages
            cur = len(self.pool.reserved)
        # sync MIAD's view (pool may have refused to shrink below usage)
        self.miad.h = max(self.miad.h, len(self.pool.reserved))

    # ------------------------------------------------------------------
    # Offline engine data plane
    # ------------------------------------------------------------------
    def offline_may_dispatch(self) -> bool:
        return all(g.enabled for g in self.gates.gates)

    # ------------------------------------------------------------------
    def check_invariants(self) -> None:
        """The paper's §4–5 invariants, checked against the EVENT LOG (the
        source every counter derives from) rather than hand-synced fields:
        ≤ 1 preemption per online request, wake-ups == gate enables, §5
        compute-first ordering, T_cool wake rule."""
        self.memory.check_invariants()        # includes pool invariants
        assert self.reclaimer.stats.ordering_violations == 0
        self.telemetry.check_invariants(gates=self.gates)
        # the legacy mirrors must agree with the event-derived counters
        # (they are written only by the registry, so drift means a bug)
        tel = self.telemetry.counters
        assert self.stats.compute_preemptions == tel.preemptions
        assert self.stats.offline_wakeups == tel.wakeups
        assert self.lifecycle.stats.wakeups == tel.wakeups

    def close(self) -> None:
        for sess in list(self.sessions.values()):
            sess.close()
        self.gates.close()
