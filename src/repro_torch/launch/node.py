"""Node orchestrator — one node's engines behind one ValveRuntime
(the port of the reference's ``launch/node.py``).

Valve's deployment unit is a *node*: one latency-critical ONLINE engine plus
N throughput OFFLINE engines — possibly of **different models** — sharing
one GPU's compute (dispatch gates) and KV memory (one :class:`KVPool`)
through one :class:`ValveRuntime`.  ``launch/serve.py`` used to hand-roll a
two-engine alternation loop; this module owns that loop and drives it from
*gate state*:

- the online engine dispatches whenever it has work (its lifecycle
  notifications close the gates, preempting offline compute);
- offline engines backfill whenever the gates are open (woken by the
  runtime after ``T_cool`` of continuous online idle), round-robin across
  engines so heterogeneous offline models share the harvested capacity;
- ``runtime.tick()`` runs every step (MIAD reservation + wake-up checks).

Each engine holds a class-scoped :class:`~repro_torch.core.api.ValveSession`;
invalidations route to the owning session by allocation ownership, so N
engines each keep their own < 20-LOC patch surface — no shared callback
plumbing (and no per-request ``bind_invalidation`` table) in drivers.
The orchestrator observes the runtime through the typed event stream
(``runtime.subscribe``) and the unified telemetry registry
(``runtime.telemetry``) — it never reaches into per-plane stat objects.

**Multi-pool nodes** (cross-pool KV rescue): :meth:`add_pool` registers
auxiliary :class:`KVPool` instances — one per device group — whose memory
planes become migration targets of each other and of the runtime pool.
When online pressure reclaims offline handles, the plane first tries to
*migrate* each victim's lease to the least-loaded other pool
(``KVPool.transfer_pages`` cross-pool) instead of truncating it.  The
orchestrator subscribes to the resulting :class:`PageMigration` events and
completes the rescue at both planes:

- **data plane** — the KV cache rows behind the moved pages are copied
  from the source engine's cache into the destination engine's cache,
  synchronously at publish time (before the freed source pages can be
  reallocated and overwritten);
- **control plane** — the ``Request`` object is handed off from the source
  engine to an engine serving the destination pool and resubmitted; its
  live lease already sits in the destination plane, so admission extends
  it and prefill resumes at ``lease.resume_tokens`` — zero tokens of
  recompute are charged anywhere on this path.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.events import (
    PageMigration, PreemptionEvent, ReclamationEvent, RuntimeEvent,
    WakeupEvent)
from repro_torch.core.memory import MemoryPlane
from repro_torch.core.runtime import ValveRuntime
from repro_torch.models.api import build_model
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.kvpool import KVPool
from repro_torch.serving.scheduler import ReqState


@dataclass
class NodeStats:
    steps: int = 0
    online_dispatches: int = 0
    offline_dispatches: int = 0
    gated_skips: int = 0            # offline had work but gates were closed
    idle_steps: int = 0             # nothing dispatched this step
    # event-stream observations (subscribed, not scraped from stat fields)
    preemptions_seen: int = 0
    wakeups_seen: int = 0
    invalidation_bursts_seen: int = 0
    migrations_seen: int = 0        # cross-pool PageMigration events
    requests_rescued: int = 0       # handoffs completed (request moved)


class NodeOrchestrator:
    """Registers engines over one shared runtime and drives the node loop."""

    def __init__(self, runtime: ValveRuntime, *, idle_advance: float = 1e-3,
                 disaggregated: bool = False):
        self.runtime = runtime
        self.clock = runtime.clock
        self.pool = runtime.pool
        # True marks this node as one half of a disaggregated topology
        # (the reference's serving.disagg.DisaggPlane): cross-pool PageMigration
        # completion is delegated to the plane's subscriber — exactly one
        # completer per migration — instead of the node's own handoff
        self.disaggregated = disaggregated
        self.online: Optional[Engine] = None
        self.offline: List[Engine] = []
        self.names: Dict[str, Engine] = {}
        self.stats = NodeStats()
        # on steps where nothing dispatched, sleep this long so continuous
        # idle can accumulate to T_cool and wake offline (a busy-spinning
        # drive loop would otherwise re-check the gates microseconds apart
        # and starve offline forever — and a VirtualClock would never
        # advance at all, livelocking drain()); works for both clock kinds
        self.idle_advance = idle_advance
        self._rr = 0                # round-robin cursor over offline engines
        # auxiliary pools (one per device group) and completed rescues
        self.pools: List[KVPool] = []
        self.rescues: List[Tuple[str, str, str]] = []  # (rid, src, dst)
        runtime.subscribe(self._on_runtime_event)

    def _on_runtime_event(self, ev: RuntimeEvent) -> None:
        """The orchestrator's view of runtime activity IS the event stream
        (same ordered facts the sim and the cluster harness consume)."""
        if isinstance(ev, PreemptionEvent):
            self.stats.preemptions_seen += 1
        elif isinstance(ev, WakeupEvent):
            self.stats.wakeups_seen += 1
        elif isinstance(ev, ReclamationEvent):
            self.stats.invalidation_bursts_seen += 1
        elif isinstance(ev, PageMigration) and ev.cross_pool:
            self.stats.migrations_seen += 1
            if not self.disaggregated:
                self._handoff_migration(ev)

    # ------------------------------------------------------------------
    # Registration
    # ------------------------------------------------------------------
    def register(self, engine: Engine, name: Optional[str] = None) -> Engine:
        """Register a pre-built engine.

        Runtime-backed engines must share this node's runtime; pool-backed
        engines (no runtime — a :class:`PoolSession` over an auxiliary
        pool) must be OFFLINE and serve a pool added via :meth:`add_pool`.
        """
        if engine.runtime is not None:
            assert engine.runtime is self.runtime, \
                'engine must be built on this node\'s runtime'
        else:
            assert engine.pool in self.pools, \
                'pool-backed engine must serve a pool from add_pool'
            assert engine.cfg.klass == 'offline', \
                'auxiliary-pool engines are offline only'
        assert engine.mcfg.page_size == self.pool.page_size, \
            (engine.mcfg.page_size, self.pool.page_size)
        if engine.cfg.klass == 'online':
            assert self.online is None, 'one online engine per node'
            self.online = engine
        else:
            self.offline.append(engine)
        name = name or f'{engine.cfg.klass}:{engine.mcfg.name}' \
                       f'#{len(self.names)}'
        assert name not in self.names, f'duplicate engine name {name!r}'
        self.names[name] = engine
        return engine

    def add_engine(self, model_cfg, engine_cfg: EngineConfig, *,
                   params=None, seed: int = 0, name: Optional[str] = None,
                   pool: Optional[KVPool] = None, device=None) -> Engine:
        """Build a model + engine on this node's runtime and register it.
        Heterogeneous colocation = calling this with different model configs
        (page_size must match the shared pool).  With ``pool`` set to an
        auxiliary pool (see :meth:`add_pool`), the engine is built over
        that pool's memory plane instead of the runtime — the migration
        destination for cross-pool rescues.  The engine runs on the GPU
        unless ``device='cpu'`` is passed."""
        device = resolve_device(device)
        model = build_model(model_cfg)
        if params is None:
            params = model.init_params(seed, device=device)
        if pool is not None and pool is not self.pool:
            eng = Engine(model, params, pool, engine_cfg, clock=self.clock,
                         device=device)
        else:
            eng = Engine(model, params, None, engine_cfg,
                         runtime=self.runtime, clock=self.clock,
                         device=device)
        return self.register(eng, name)

    def add_pool(self, pool: KVPool) -> KVPool:
        """Register an auxiliary KV pool (one per device group).

        The pool joins the node's event stream (PageMigration publishes on
        the runtime bus) and every plane on the node — runtime pool plus
        all auxiliary pools — becomes a migration target of the others, so
        a reclamation victim on any pool can be rescued to the least
        loaded of the rest."""
        assert pool is not self.pool and pool not in self.pools, \
            'pool already registered'
        # names key migration_targets and PageMigration provenance
        # (src_pool/dst_pool): a duplicate would make rescue events
        # ambiguous and steer the data-plane copy to the wrong engine
        taken = {self.pool.name} | {p.name for p in self.pools}
        assert pool.name not in taken, \
            f'duplicate pool name {pool.name!r} (names key migration ' \
            f'targets and PageMigration provenance)'
        assert pool.page_size == self.pool.page_size, \
            (pool.page_size, self.pool.page_size)
        pool.bus = self.runtime.bus
        self.pools.append(pool)
        planes = [self.runtime.memory] + \
            [MemoryPlane.of(p) for p in self.pools]
        for pl in planes:
            pl.migration_targets = [q for q in planes if q is not pl]
        return pool

    @property
    def engines(self) -> List[Engine]:
        return ([self.online] if self.online is not None else []) + \
            list(self.offline)

    def engine_of(self, req_id: str) -> Optional[Engine]:
        """The engine currently holding ``req_id`` (None if unknown) —
        requests move between engines on this node (cross-pool rescue)
        and between nodes (disaggregated handoff), so front-end cancel /
        flush paths resolve the holder per call instead of assuming
        ``self.online``."""
        for eng in self.engines:
            if req_id in eng.requests:
                return eng
        return None

    # ------------------------------------------------------------------
    # Cross-pool rescue handoff (PageMigration subscriber)
    # ------------------------------------------------------------------
    def _engine_for_pool(self, pool_name: str,
                         holding: Optional[str] = None) -> Optional[Engine]:
        for eng in self.engines:
            if eng.pool.name != pool_name:
                continue
            if holding is None or holding in eng.requests:
                return eng
        return None

    def _handoff_migration(self, ev: PageMigration) -> None:
        """Complete a cross-pool rescue: copy the KV cache rows behind the
        moved pages and move the Request to an engine on the target pool.

        Runs synchronously inside the event publish — i.e. inside the
        reclamation that triggered the rescue, while the source engine is
        quiescent (reclamation only fires from online allocation pressure
        and the runtime tick, never mid-offline-dispatch) and before the
        freed source pages can be reallocated and overwritten."""
        src = self._engine_for_pool(ev.src_pool, holding=ev.owner)
        dst = self._engine_for_pool(ev.dst_pool)
        if src is None or dst is None or src is dst:
            return                  # not a serving-engine lease — no handoff
        # data plane: same-architecture engines move the physical KV rows
        # (page axis 1 of the engine pool layout); heterogeneous pairs keep
        # the bookkeeping-level rescue only
        if ev.src_pages and src.mcfg.name == dst.mcfg.name:
            dst.copy_kv_from(src, ev.src_pages, ev.dst_pages)
        # control plane: hand the request off.  Pending fused-path tokens
        # reference src.requests by id — resolve them before the pop.
        src.flush_tokens()
        req = src.requests.pop(ev.owner)
        if ev.owner in src.queue:
            src.queue.remove(ev.owner)
        if ev.owner in src.running:
            src.running.remove(ev.owner)
        req.state = ReqState.WAITING
        req.pages, req.blocked_admits = [], 0
        dst.requests[ev.owner] = req
        dst.sched.submit(ev.owner)
        # admission on dst finds the migrated live lease in its plane and
        # resumes prefill at lease.resume_tokens — nothing recomputes
        self.stats.requests_rescued += 1
        self.rescues.append((ev.owner, ev.src_pool, ev.dst_pool))

    # ------------------------------------------------------------------
    # Drive loop
    # ------------------------------------------------------------------
    def has_work(self) -> bool:
        return any(e.queue or e.running for e in self.engines)

    def step(self) -> bool:
        """One node tick: online first, offline backfill iff gates open."""
        self.stats.steps += 1
        progressed = False
        if self.online is not None and (self.online.queue
                                        or self.online.running):
            if self.online.step():
                progressed = True
                self.stats.online_dispatches += 1
        if any(e.queue or e.running for e in self.offline):
            if self.runtime.offline_may_dispatch():
                # round-robin: try each offline engine once, dispatch the
                # first that makes progress (a memory-blocked engine does
                # not starve its siblings)
                n = len(self.offline)
                for _ in range(n):
                    eng = self.offline[self._rr % n]
                    self._rr += 1
                    if not (eng.queue or eng.running):
                        continue
                    if eng.step():
                        progressed = True
                        self.stats.offline_dispatches += 1
                        break
            else:
                self.stats.gated_skips += 1
        self.runtime.tick()
        if not progressed:
            self.stats.idle_steps += 1
            if self.idle_advance > 0:
                self.clock.sleep(self.idle_advance)
        return progressed

    def run(self, steps: int) -> None:
        for _ in range(steps):
            self.step()

    def drain(self, max_steps: int = 100_000) -> None:
        """Run until every engine's queue and batch are empty."""
        for _ in range(max_steps):
            if not self.has_work():
                return
            self.step()
        raise RuntimeError('drain exceeded max_steps')

    # ------------------------------------------------------------------
    # Metrics (the paper's Fig. 10 axes + serving-plane counters)
    # ------------------------------------------------------------------
    def metrics(self) -> Dict[str, object]:
        on_fin = self.online.finished if self.online is not None else []
        ttfts = [r.ttft for r in on_fin if r.ttft is not None]
        tpots = [r.tpot for r in on_fin if r.tpot and r.tpot > 0]
        off_tokens = sum(e.stats.tokens_generated for e in self.offline)
        off_recomp = sum(e.stats.tokens_recomputed for e in self.offline)
        # runtime counters come from the unified telemetry registry (the
        # event-stream fold), not from per-plane stat objects
        tel = self.runtime.telemetry.snapshot()
        return {
            'online_finished': len(on_fin),
            'offline_finished': sum(len(e.finished) for e in self.offline),
            'online_ttft_p50': float(np.median(ttfts)) if ttfts else None,
            'online_tpot_p50': float(np.median(tpots)) if tpots else None,
            'offline_tokens': off_tokens,
            'offline_recomputed_tokens': off_recomp,
            'online_dispatches': self.stats.online_dispatches,
            'offline_dispatches': self.stats.offline_dispatches,
            'gated_skips': self.stats.gated_skips,
            'cancellations': sum(e.stats.cancellations for e in self.engines),
            'compute_preemptions': tel['compute_preemptions'],
            'offline_wakeups': tel['offline_wakeups'],
            'reclamations': tel['reclamations'],
            'max_preemptions_per_request':
                tel['max_preemptions_per_request'],
            'preemption_latency': tel['preemption_latency'],
            # live requests are LEASES now (raw pool owner ids include the
            # memory plane's internal shared-prefix blocks)
            'live_online_requests':
                len(self.runtime.memory.live_leases('online')),
            'live_offline_requests':
                len(self.runtime.memory.live_leases('offline')),
            'engines': {
                name: {
                    'arch': eng.mcfg.name,
                    'klass': eng.cfg.klass,
                    'finished': len(eng.finished),
                    'tokens': eng.stats.tokens_generated,
                    'dispatches': eng.stats.dispatches,
                    'mixed_dispatches': eng.stats.mixed_dispatches,
                    'cancelled': eng.stats.cancellations,
                    # leased pages incl. attached shared-prefix pages
                    # (pool ownership alone would miss attachments)
                    'live_pages': sum(
                        len(r.lease) for r in eng.requests.values()
                        if r.lease is not None and not r.lease.released),
                } for name, eng in self.names.items()
            },
        }
