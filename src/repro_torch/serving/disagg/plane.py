"""Disaggregated prefill/decode serving plane (migration-based KV handoff).

Production disaggregation splits the two phases of online inference onto
separate engine sets so their interference profiles separate: *prefill*
(compute-bound, bursty, long dispatches) runs on one pool, *decode*
(memory-bound, steady, short dispatches) on another.  The classic cost of
the split is the KV handoff — the prefilled cache must reach the decode
workers without recomputing it.

:class:`DisaggPlane` builds the split out of mechanisms this repo already
trusts, rather than a new transfer protocol:

- **two full Valve nodes** — each side is an ordinary
  :class:`~repro_torch.launch.node.NodeOrchestrator` (own
  :class:`~repro_torch.core.runtime.ValveRuntime`, own
  :class:`~repro_torch.serving.kvpool.KVPool` + gates + MIAD + telemetry),
  constructed with ``disaggregated=True`` so cross-pool migration
  completion is delegated here instead of to the node's rescue handler;
- **handoff == lease migration** — when a request's prefill completes on
  the prefill node's online engine, :meth:`step` calls
  ``MemoryPlane.migrate(rid, decode_plane)``: the proven cross-pool
  data-plane path (``KVPool.transfer_pages``) allocates pages on the
  decode pool, publishes a :class:`~repro_torch.core.events.PageMigration`, and
  this plane's subscriber — running synchronously inside the publish,
  before the freed source pages can be reallocated — copies the physical
  KV rows between the engine caches and re-homes the ``Request`` onto the
  decode engine;
- **zero recompute, bit-identical** — the migrated lease carries its fill
  point, so decode-side admission resumes at ``lease.resume_tokens``:
  exactly one un-materialized token (the last sampled one, whose KV a
  plain decode step would write anyway) flows through the prefill entry,
  and greedy output is bit-identical to a colocated single-pool run;
- **refusal == deferral** — a falsy
  :class:`~repro_torch.core.memory.MigrationRefusal` (decode pool full, shared
  pages) leaves the source untouched; the request simply keeps decoding on
  the prefill engine — the colocated fallback, still bit-identical — and
  the handoff is retried next step;
- **both pools backfill** — each node keeps its own offline engines behind
  its own gates.  The prefill side frees its online lifecycle at handoff
  (``session.finish``), so once its queue drains, T_cool elapses and its
  gates wake offline work while decode is still streaming — harvesting
  exactly the idleness disaggregation creates.  Each runtime keeps the
  ≤ 1-preemption-per-(request, device) bound independently; devices are
  disjoint between the nodes, so the joint bound holds per (request,
  device).

Every completed handoff publishes a typed
:class:`~repro_torch.core.events.PrefillHandoff` on BOTH runtimes' buses
(latency, pages copied, per-pool queue depths), folded into each
:class:`~repro_torch.core.telemetry.TelemetryRegistry`.

The plane duck-types the :class:`NodeOrchestrator` driver surface
(``clock``/``online``/``offline``/``has_work``/``step``/``metrics``/
``engine_of``), so the async front-end (``AsyncNodeDriver``, the SSE app,
batch jobs) runs over it unchanged — streams keep flowing across the
handoff because the driver resolves each request's holding engine per
flush.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.events import PageMigration, PrefillHandoff
from repro_torch.launch.node import NodeOrchestrator
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import ReqState

__all__ = ['DisaggPlane', 'DisaggStats', 'copy_pages']


def copy_pages(src_cache, src_pages, dst_cache, dst_pages) -> None:
    """Copy the KV rows of ``src_pages`` into ``dst_pages`` (page axis 1
    of every pool of the engine layout), in place on the current stream.

    The page ids become index tensors on each cache's device straight from
    the host lists, never through a ``non_blocking`` copy: the copy is
    queued before ``migrate`` returns, so the freed source pages cannot be
    rewritten ahead of it by a later dispatch on the same stream."""
    for key, dc in dst_cache.items():
        sc = src_cache[key]
        s = torch.tensor(src_pages, dtype=torch.long, device=sc.device)
        d = torch.tensor(dst_pages, dtype=torch.long, device=dc.device)
        dc.index_copy_(1, d, sc.index_select(1, s).to(dc.device))


@dataclass
class DisaggStats:
    steps: int = 0
    handoffs: int = 0               # prefill → decode lease moves completed
    handoffs_deferred: int = 0      # migrate refusals (retried next step)
    pages_copied: int = 0           # physical KV rows moved between caches
    rescues: int = 0                # offline cross-pool rescues completed


class DisaggPlane:
    """Two Valve nodes — prefill and decode — joined by lease migration.

    Both nodes must share one clock (one virtual timeline), be constructed
    with ``disaggregated=True`` (this plane is the single cross-pool
    migration completer), and have distinct pool names (names key
    PageMigration provenance).  Online engines on the two sides must be
    the same architecture with identical parameters — the bit-identity
    contract of the handoff; ``_try_handoff`` asserts the architecture.
    """

    def __init__(self, prefill: NodeOrchestrator, decode: NodeOrchestrator):
        assert prefill is not decode, 'prefill and decode must be two nodes'
        assert prefill.disaggregated and decode.disaggregated, \
            'both nodes must be built with disaggregated=True (the plane ' \
            'is the single cross-pool migration completer)'
        assert prefill.clock is decode.clock, \
            'disaggregated nodes must share one clock'
        assert prefill.pool.name != decode.pool.name, \
            f'pool names must differ (both {prefill.pool.name!r})'
        assert prefill.pool.page_size == decode.pool.page_size, \
            (prefill.pool.page_size, decode.pool.page_size)
        self.prefill = prefill
        self.decode = decode
        self.clock = prefill.clock
        self.stats = DisaggStats()
        self.handoffs: List[Tuple[str, str, str]] = []  # (rid, src, dst)
        # set by pair_cheapest: (src_node, dst_node, tier, cost) — the
        # interconnect the KV handoff crosses (placement.TopologyModel)
        self.link: Optional[Tuple[str, str, str, float]] = None
        # one subscription sees every migration between the two pools:
        # transfer_pages publishes on each DISTINCT bus involved (src and
        # dst), so the prefill bus carries both directions exactly once
        prefill.runtime.subscribe(self._on_migration, PageMigration)

    # ------------------------------------------------------------------
    # Topology-aware pairing (cluster placement plane)
    # ------------------------------------------------------------------
    @classmethod
    def pair_cheapest(cls, prefill_nodes: Dict[str, 'NodeOrchestrator'],
                      decode_nodes: Dict[str, 'NodeOrchestrator'],
                      topology) -> 'DisaggPlane':
        """Build the plane over the candidate pair joined by the cheapest
        interconnect link.

        ``prefill_nodes``/``decode_nodes`` map cluster node names (the
        ``TopologyModel``'s coordinates) to candidate orchestrators;
        ``topology.cheapest_pair`` picks where the prefill→decode KV copy
        is cheapest (NVLink/PCIe inside a node beat node-local, which
        beats cross-rack).  The chosen link is recorded on ``plane.link``
        and reported in :meth:`metrics` as ``handoff_link``.
        """
        src, dst, tier, cost = topology.cheapest_pair(
            list(prefill_nodes), list(decode_nodes))
        pre, dec = prefill_nodes[src], decode_nodes[dst]
        assert pre is not dec, \
            'cheapest pair resolved to one orchestrator — need two pools'
        plane = cls(pre, dec)
        plane.link = (src, dst, tier, cost)
        return plane

    # ------------------------------------------------------------------
    # Optional: cross-pool rescue of offline reclamation victims
    # ------------------------------------------------------------------
    def enable_cross_rescue(self) -> None:
        """Link the two memory planes as mutual migration targets, so a
        reclamation victim on either pool is first offered a rescue to the
        other (``MemoryPlane._rescue_victims``) instead of truncation.
        Call after registering engines: each side needs ≥ 1 offline engine
        to re-home rescued requests onto."""
        assert self.prefill.offline and self.decode.offline, \
            'cross-rescue needs an offline engine on both nodes'
        pp, dp = self.prefill.runtime.memory, self.decode.runtime.memory
        if dp not in pp.migration_targets:
            pp.migration_targets = pp.migration_targets + [dp]
        if pp not in dp.migration_targets:
            dp.migration_targets = dp.migration_targets + [pp]

    # ------------------------------------------------------------------
    # NodeOrchestrator driver surface (duck-typed for the front-end)
    # ------------------------------------------------------------------
    @property
    def online(self) -> Optional[Engine]:
        """The submission surface: new online requests enter at prefill."""
        return self.prefill.online

    @property
    def offline(self) -> List[Engine]:
        return list(self.prefill.offline) + list(self.decode.offline)

    @property
    def engines(self) -> List[Engine]:
        return self.prefill.engines + self.decode.engines

    def submit(self, prompt, max_new_tokens: int = 32) -> str:
        assert self.prefill.online is not None, 'plane has no online engine'
        return self.prefill.online.submit(prompt, max_new_tokens)

    def engine_of(self, req_id: str) -> Optional[Engine]:
        """The engine currently holding ``req_id``, on either node — the
        front-end cancel/flush paths follow the request across the
        handoff through this."""
        eng = self.prefill.engine_of(req_id)
        if eng is not None:
            return eng
        return self.decode.engine_of(req_id)

    def has_work(self) -> bool:
        return self.prefill.has_work() or self.decode.has_work()

    def step(self) -> bool:
        """One plane tick: prefill node, then the handoff pump, then the
        decode node — a prefill that completes in this tick's first phase
        reaches the decode engine before its next dispatch."""
        self.stats.steps += 1
        progressed = self.prefill.step()
        self._pump_handoffs()
        if self.decode.step():
            progressed = True
        return progressed

    def run(self, steps: int) -> None:
        for _ in range(steps):
            self.step()

    def drain(self, max_steps: int = 100_000) -> None:
        for _ in range(max_steps):
            if not self.has_work():
                return
            self.step()
        raise RuntimeError('drain exceeded max_steps')

    # ------------------------------------------------------------------
    # The handoff scheduler
    # ------------------------------------------------------------------
    def _pump_handoffs(self) -> None:
        """Move every prefill-complete online request to the decode node.

        A request is ready exactly when it sits RUNNING on the prefill
        engine: its last prefill chunk executed and produced the first
        token.  (FINISHED requests — e.g. ``max_new_tokens == 1`` — never
        hand off; CANCELLED ones released their lease already.)"""
        pe, de = self.prefill.online, self.decode.online
        if pe is None or de is None:
            return
        for rid in list(pe.running):
            req = pe.requests[rid]
            if req.state is ReqState.RUNNING:
                self._try_handoff(req)

    def _try_handoff(self, req) -> bool:
        pe, de = self.prefill.online, self.decode.online
        # bit-identity contract: the decode engine replays the request's
        # remaining tokens through identical weights
        assert pe.mcfg.name == de.mcfg.name, (pe.mcfg.name, de.mcfg.name)
        assert req.target_len <= de.cfg.max_seq, \
            (req.target_len, de.cfg.max_seq)
        rid = req.req_id
        moved = self.prefill.runtime.memory.migrate(
            rid, self.decode.runtime.memory)
        if not moved:
            # explicit refusal (decode pool full, shared pages): source
            # untouched — the request keeps decoding on the prefill engine
            # (colocated fallback, still bit-identical), retried next step
            self.stats.handoffs_deferred += 1
            return False
        # the PageMigration subscriber already ran inside migrate(): KV
        # rows copied and the Request re-homed onto the decode engine
        assert rid in de.requests and rid not in pe.requests, rid
        # balance the prefill-side online lifecycle (started at submit
        # admission): free() no-ops — the lease left this plane — and
        # request_end lets the prefill node reach T_cool idle and wake its
        # own offline backfill while decode streams
        pe.session.finish(rid)
        # prefill materialized KV for every context token but the last
        # sampled one; the lease's resume point must say exactly that —
        # anything less would be recomputed on decode (contract: 0)
        recompute = max(0, (len(req.context) - 1) - moved.resume_tokens)
        now = self.clock.now()
        t0 = req.t_first_token if req.t_first_token is not None else now
        fields = dict(
            req_id=rid,
            src_pool=self.prefill.pool.name,
            dst_pool=self.decode.pool.name,
            pages_copied=moved.n_pages,
            latency_s=now - t0,
            recompute_tokens=recompute,
            prefill_queue_depth=len(pe.queue) + len(pe.running),
            decode_queue_depth=len(de.queue) + len(de.running))
        # both telemetry registries fold the handoff (each side's report
        # stands alone); the buses are distinct so nothing double-counts
        for bus in (self.prefill.runtime.bus, self.decode.runtime.bus):
            bus.publish(PrefillHandoff, **fields)
        self.stats.handoffs += 1
        self.handoffs.append(
            (rid, self.prefill.pool.name, self.decode.pool.name))
        return True

    # ------------------------------------------------------------------
    # Cross-pool migration completion (PageMigration subscriber)
    # ------------------------------------------------------------------
    def _node_of_pool(self, pool_name: str) -> Optional[NodeOrchestrator]:
        if pool_name == self.prefill.pool.name:
            return self.prefill
        if pool_name == self.decode.pool.name:
            return self.decode
        return None

    def _pick_engine(self, node: NodeOrchestrator, pool_name: str,
                     klass: str, arch: str) -> Optional[Engine]:
        """Destination engine for a re-homed request: must serve the
        destination pool in the same class (an offline rescue must stay
        offline); same architecture preferred (physical KV rows copy)."""
        cands = [e for e in node.engines
                 if e.pool.name == pool_name and e.cfg.klass == klass]
        for e in cands:
            if e.mcfg.name == arch:
                return e
        return cands[0] if cands else None

    def _on_migration(self, ev: PageMigration) -> None:
        """Complete a cross-pool move between the two nodes: copy the KV
        cache rows behind the moved pages and re-home the ``Request``.

        Runs synchronously inside the ``transfer_pages`` publish — i.e.
        inside ``MemoryPlane.migrate`` — while the source engine is
        quiescent and before the freed source pages can be reallocated
        and overwritten.  Handles both directions (online handoff,
        optional offline rescue) through one code path."""
        if not ev.cross_pool:
            return
        src_node = self._node_of_pool(ev.src_pool)
        dst_node = self._node_of_pool(ev.dst_pool)
        if src_node is None or dst_node is None or src_node is dst_node:
            return
        src = src_node._engine_for_pool(ev.src_pool, holding=ev.owner)
        if src is None:
            return              # not a serving-engine lease — no handoff
        dst = self._pick_engine(dst_node, ev.dst_pool,
                                src.cfg.klass, src.mcfg.name)
        if dst is None or dst is src:
            return
        # data plane: same-architecture engines move the physical KV rows
        # (page axis 1 of the engine pool layout)
        if ev.src_pages and src.mcfg.name == dst.mcfg.name:
            dst.copy_kv_from(src, ev.src_pages, ev.dst_pages)
            self.stats.pages_copied += len(ev.src_pages)
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
        # resumes at lease.resume_tokens — nothing recomputes
        if src.cfg.klass == 'offline':
            self.stats.rescues += 1

    # ------------------------------------------------------------------
    # Metrics / invariants
    # ------------------------------------------------------------------
    def finished_online(self) -> List[object]:
        """All finished online requests, wherever they ended: handed-off
        requests finish on the decode engine, deferred-forever (or
        single-token) ones on the prefill engine."""
        out = []
        for node in (self.prefill, self.decode):
            if node.online is not None:
                out.extend(node.online.finished)
        return out

    def metrics(self) -> Dict[str, object]:
        fin = self.finished_online()
        ttfts = [r.ttft for r in fin if r.ttft is not None]
        tpots = [r.tpot for r in fin if r.tpot and r.tpot > 0]
        tel_p = self.prefill.runtime.telemetry.snapshot()
        tel_d = self.decode.runtime.telemetry.snapshot()
        return {
            'online_finished': len(fin),
            'online_ttft_p50': float(np.median(ttfts)) if ttfts else None,
            'online_tpot_p50': float(np.median(tpots)) if tpots else None,
            'offline_tokens': sum(e.stats.tokens_generated
                                  for e in self.offline),
            'offline_finished': sum(len(e.finished) for e in self.offline),
            'handoffs': self.stats.handoffs,
            'handoffs_deferred': self.stats.handoffs_deferred,
            'handoff_link': self.link,   # (src, dst, tier, cost) | None

            'pages_copied': self.stats.pages_copied,
            'rescues': self.stats.rescues,
            # each registry folded the same PrefillHandoff stream
            'handoff_pages': tel_p['handoff_pages'],
            'handoff_recompute_tokens': tel_p['handoff_recompute_tokens'],
            'handoff_latency': tel_p['handoff_latency'],
            # the joint preemption bound is per (request, device); devices
            # are disjoint between the nodes, so report the worst side
            'max_preemptions_per_request': max(
                tel_p['max_preemptions_per_request'],
                tel_d['max_preemptions_per_request']),
            'prefill': self.prefill.metrics(),
            'decode': self.decode.metrics(),
        }

    def check_invariants(self) -> None:
        """Both runtimes' §4–5 invariants (event ordering, ≤ 1 preemption
        per request per device, wake rule, memory-plane consistency)."""
        self.prefill.runtime.check_invariants()
        self.decode.runtime.check_invariants()
