"""Colocation strategy policies (paper §7.2 baselines).

Compute preemption — how long online waits when offline holds the GPU, and
when offline may run:

- ``KernelPreempt`` (TGS): switch at kernel boundaries; with CUDA graphs the
  boundary is a whole *iteration*, so online waits the full in-flight
  offline iteration.
- ``GPreempt``: driver timeslice — preemption is immediate (~10 µs) but
  offline wakes in every inter-iteration gap, so every online decode
  iteration pays a wake-collision switch.
- ``Channel`` (Valve §4): channel disable ≈ 0.5 ms + one bounded sub-layer
  chunk residual; wake only after ``T_cool = 2 × max decode gap`` — at most
  one preemption per online request.  Uses the real
  ``OnlineLifecycleTracker``.

Memory — where online KV comes from when it bursts:

- ``UVM``: offline fills all spare memory; online allocations page-fault it
  back at ~µs/page on the critical path, and the faulted offline requests
  die (restart from scratch).
- ``Prism``: VMM sharing without reclamation — online waits for offline
  requests to *finish* when memory is exhausted.
- ``StaticMem``: offline capped at the trailing-hour min free memory;
  online bursts above the cap kill offline requests outright.
- ``OurMem`` (Valve §5): the real ``KVPool`` + ``MIADReservation`` +
  ``ReclamationController`` (Algorithm 1 or FIFO) — sub-layer reclamation
  latency, rate driven to target by MIAD, victims chosen to minimize
  recompute tokens.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.core.lifecycle import OnlineLifecycleTracker
from repro_torch.core.memory import MemoryPlane
from repro_torch.core.miad import MIADConfig, MIADReservation
from repro_torch.core.reclamation import ReclamationController
from repro_torch.serving.kvpool import KVPool


# ---------------------------------------------------------------------------
# Compute policies
# ---------------------------------------------------------------------------

@dataclass
class ComputeStats:
    preemptions: int = 0
    preempt_delay_total: float = 0.0
    per_request: Dict[str, int] = field(default_factory=dict)


class ComputePolicy:
    name = 'base'

    def __init__(self):
        self.stats = ComputeStats()

    def preempt_delay(self, inflight_remaining: float) -> float:
        """Delay online pays to evict a running offline dispatch."""
        raise NotImplementedError

    def offline_may_start(self, now: float) -> bool:
        raise NotImplementedError

    # notifications from the simulator
    def on_online_request_start(self, rid: str, now: float): ...
    def on_online_request_end(self, rid: str, now: float): ...
    def on_online_iter(self, now_start: float, now_end: float): ...
    def note_preemption(self, rid_set, delay: float):
        self.stats.preemptions += 1
        self.stats.preempt_delay_total += delay
        for r in rid_set:
            self.stats.per_request[r] = self.stats.per_request.get(r, 0) + 1


class KernelPreempt(ComputePolicy):
    """Iteration-granularity switch (CUDA-graph boundary)."""
    name = 'KernelPreempt'

    def preempt_delay(self, inflight_remaining: float) -> float:
        return inflight_remaining          # drain the whole offline iteration

    def offline_may_start(self, now: float) -> bool:
        return True                        # backfills any idle instant


class GPreempt(ComputePolicy):
    """Driver-timeslice preemption: switching happens at timeslice
    boundaries, and offline wakes in every decode gap."""
    name = 'GPreempt'
    SWITCH = 30e-6                          # context-switch cost
    TIMESLICE = 1.0e-3                      # offline slice before yield

    def preempt_delay(self, inflight_remaining: float) -> float:
        return self.SWITCH + min(inflight_remaining, self.TIMESLICE)

    def offline_may_start(self, now: float) -> bool:
        return True


class Channel(ComputePolicy):
    """Valve §4: sub-ms channel preemption + T_cool-gated wake-ups."""
    name = 'Channel'
    DISABLE = 0.5e-3                        # channel-disable ioctl (patched)
    CHUNK_RESIDUAL = 0.5e-3                 # bounded in-flight sub-layer chunk

    def __init__(self, t_cool_init: float = 0.010):
        super().__init__()
        self.lifecycle = OnlineLifecycleTracker(t_cool_init=t_cool_init)

    def preempt_delay(self, inflight_remaining: float) -> float:
        return self.DISABLE + min(inflight_remaining, self.CHUNK_RESIDUAL)

    def offline_may_start(self, now: float) -> bool:
        return self.lifecycle.may_wake_offline(now)

    def on_online_request_start(self, rid, now):
        self.lifecycle.request_start(rid, now)

    def on_online_request_end(self, rid, now):
        self.lifecycle.request_end(rid, now)

    def on_online_iter(self, now_start, now_end):
        self.lifecycle.iteration_start(now_start)
        self.lifecycle.iteration_end(now_end)


# ---------------------------------------------------------------------------
# Memory policies
# ---------------------------------------------------------------------------

@dataclass
class MemStats:
    online_stall_total: float = 0.0
    stall_events: int = 0
    offline_tokens_lost: float = 0.0
    offline_kills: int = 0
    reclamations: int = 0


@dataclass
class AllocResult:
    ok: bool
    delay: float = 0.0
    # offline request ids whose KV was invalidated (token cost handled by
    # the offline engine's recompute queue)
    invalidated: Dict[str, List[int]] = field(default_factory=dict)
    killed: Set[str] = field(default_factory=set)
    # rid → surviving-prefix tokens (memory-plane partial invalidation:
    # the victim resumes prefill here instead of token 0; absent/0 for
    # whole-request policies)
    surviving: Dict[str, int] = field(default_factory=dict)
    # -- reclamation facts (the sim publishes these as typed events, so all
    # consumers observe the same stream the live runtime emits) --
    reclaimed: bool = False          # a reclamation/eviction pass ran
    gate_closed: bool = False        # offline compute was disabled first
    #                                  (§5 ordering — only OurMem holds it)
    reclaimed_handles: int = 0
    deficit_pages: int = 0           # shortfall that triggered the pass


class MemoryPolicy:
    """Page accounting over a shared pool of ``total_pages``."""
    name = 'base'
    # True when the policy runs the memory plane: leases with prefix
    # sharing, fill tracking and surviving-prefix (partial) invalidation
    supports_leases = False

    def __init__(self, total_pages: int, page_tokens: int = 16):
        self.total = total_pages
        self.page_tokens = page_tokens
        self.online_pages: Dict[str, int] = {}
        self.offline_pages: Dict[str, int] = {}
        self.stats = MemStats()

    # -- shared helpers -----------------------------------------------------
    @property
    def used(self) -> int:
        return sum(self.online_pages.values()) + sum(
            self.offline_pages.values())

    def free_pages(self) -> int:
        return self.total - self.used

    def offline_headroom(self, now: float) -> int:
        """Pages offline may occupy right now."""
        return self.free_pages()

    def alloc_online(self, rid: str, pages: int, now: float) -> AllocResult:
        raise NotImplementedError

    def free_online(self, rid: str) -> None:
        self.online_pages.pop(rid, None)

    def alloc_offline(self, rid: str, pages: int, now: float,
                      prefix=None) -> bool:
        """``prefix`` (token ids shared across a batch) is consumed only by
        lease-capable policies; whole-request policies ignore it."""
        if pages <= self.offline_headroom(now):
            self.offline_pages[rid] = self.offline_pages.get(rid, 0) + pages
            return True
        return False

    def free_offline(self, rid: str) -> None:
        self.offline_pages.pop(rid, None)

    # -- lease hooks (no-ops without a memory plane) ------------------------
    def note_filled(self, rid: str, tokens: int) -> None: ...

    def resume_tokens(self, rid: str) -> int:
        """Valid-KV prefix of ``rid`` (shared/surviving): prefill starts
        here.  0 for whole-request policies."""
        return 0

    def held_pages(self, rid: str) -> int:
        return self.offline_pages.get(rid, 0)

    def tick(self, now: float) -> None: ...

    def _take_offline_victims(self, deficit: int, now: float
                              ) -> Tuple[Dict[str, List[int]], int]:
        """Default FIFO-ish victim grab: evict whole offline requests until
        ``deficit`` pages free up.  Returns (invalidated map, freed)."""
        freed = 0
        inv: Dict[str, List[int]] = {}
        for rid in list(self.offline_pages.keys()):
            if freed >= deficit:
                break
            p = self.offline_pages.pop(rid)
            freed += p
            inv[rid] = list(range(p))   # page ids are symbolic in the sim
        return inv, freed


class UVM(MemoryPolicy):
    """Unified-memory: reclaim by page fault on the online critical path.

    A 16-token KV page of a 7B model is ~8 MB; UVM demand-migration moves
    it at ~15 GB/s effective → ~0.5 ms per page, paid inside the online
    allocation (the paper's "naively relying on UVM … severe interference").
    """
    name = 'UVM'
    FAULT_PER_PAGE = 500e-6

    def alloc_online(self, rid, pages, now):
        r = AllocResult(ok=True)
        deficit = pages - self.free_pages()
        if deficit > 0:
            inv, freed = self._take_offline_victims(deficit, now)
            # UVM can't coordinate with the framework: victims are killed,
            # and pages move while offline compute still runs (the §5
            # ordering violation the event stream makes visible)
            r.killed = set(inv.keys())
            r.invalidated = inv
            r.delay = pages * self.FAULT_PER_PAGE
            r.reclaimed, r.gate_closed = True, False
            r.deficit_pages = deficit
            self.stats.offline_kills += len(inv)
            self.stats.reclamations += 1
            if freed < deficit:
                r.ok = False
        if r.ok:
            self.online_pages[rid] = self.online_pages.get(rid, 0) + pages
            self.stats.online_stall_total += r.delay
            self.stats.stall_events += r.delay > 0
        return r


class Prism(MemoryPolicy):
    """VMM sharing, no reclamation: online waits for offline completions."""
    name = 'Prism'

    def alloc_online(self, rid, pages, now):
        if pages <= self.free_pages():
            self.online_pages[rid] = self.online_pages.get(rid, 0) + pages
            return AllocResult(ok=True)
        return AllocResult(ok=False)       # caller queues the request


class StaticMem(MemoryPolicy):
    """Offline statically capped at trailing-min free memory; online bursts
    above the cap kill offline instantly."""
    name = 'StaticMem'

    def __init__(self, total_pages: int, page_tokens: int = 16,
                 offline_cap_frac: float = 0.35):
        super().__init__(total_pages, page_tokens)
        self.offline_cap = int(total_pages * offline_cap_frac)

    def offline_headroom(self, now):
        used_off = sum(self.offline_pages.values())
        return min(self.offline_cap - used_off, self.free_pages())

    def alloc_online(self, rid, pages, now):
        r = AllocResult(ok=True)
        deficit = pages - self.free_pages()
        if deficit > 0:
            inv, freed = self._take_offline_victims(deficit, now)
            r.killed = set(inv.keys())
            r.invalidated = inv
            r.reclaimed, r.gate_closed = True, False
            r.deficit_pages = deficit
            self.stats.offline_kills += len(inv)
            if freed < deficit:
                r.ok = False
        if r.ok:
            self.online_pages[rid] = self.online_pages.get(rid, 0) + pages
        return r


class OurMem(MemoryPolicy):
    """Valve §5 on the real pool + memory plane: sub-layer reclamation,
    MIAD reservation, selective (Algorithm 1) or FIFO victim selection —
    with lease-based allocation, so offline victims keep their surviving
    prefix (partial invalidation) and shared-prefix batches attach
    already-materialized prompt pages.

    ``partial=False`` / ``sharing=False`` turn the plane features off
    (whole-request invalidation, no prefix index) — the benchmark baseline
    for the recompute-tax comparison.
    """
    name = 'OurMem'
    supports_leases = True
    RECLAIM_LATENCY = 1.0e-3       # disable-first + remap + callback

    def __init__(self, total_pages: int, page_tokens: int = 16,
                 pages_per_handle: int = 64, policy: str = 'valve',
                 miad: Optional[MIADConfig] = None, *,
                 partial: bool = True, sharing: bool = True):
        super().__init__(total_pages, page_tokens)
        n_handles = max(total_pages // pages_per_handle, 1)
        self.pool = KVPool(n_handles, pages_per_handle,
                           page_size=page_tokens, reserved_handles=1)
        self.plane = MemoryPlane(self.pool, sharing=sharing, partial=partial)
        self.miad = MIADReservation(h_init=1, cfg=miad or MIADConfig(
            t_init=0.5, target_rate=0.2, h_max=n_handles))
        self._gate_closed = False
        # partial=False is the pre-plane baseline end to end: whole-request
        # invalidation AND the old COST(r) = allocated tokens (the plane's
        # filled-aware marginal cost would already dodge unfilled victims,
        # which is part of what the comparison measures)
        legacy_cost = None if partial else (
            lambda r: len(self.pool.pages_of.get(r, ())) * page_tokens)
        self.reclaimer = ReclamationController(
            self.pool, gate_is_closed=lambda: self._gate_closed,
            policy=policy, cost_of=legacy_cost)

    def free_pages(self):                   # pool is the source of truth
        return (self.pool.free_pages_for('online')
                + self.pool.free_pages_for('offline'))

    def offline_headroom(self, now):
        return self.pool.free_pages_for('offline')

    def alloc_online(self, rid, pages, now):
        got = self.plane.admit(rid, pages, 'online')
        r = AllocResult(ok=got is not None)
        if got is None:
            deficit = pages - self.pool.free_pages_for('online')
            n_handles = -(-deficit // self.pool.pph)
            self._gate_closed = True        # compute-first ordering (§5)
            try:
                inv = self.reclaimer.reclaim(n_handles, now)
            finally:
                self._gate_closed = False
            self.miad.note_reclamation(now)
            r.invalidated = inv             # surfaced, NOT killed: recompute
            r.surviving = {k: v.resume for k, v in inv.items()}
            r.delay = self.RECLAIM_LATENCY
            r.reclaimed, r.gate_closed = True, True
            r.reclaimed_handles = n_handles
            r.deficit_pages = deficit
            self.stats.reclamations += 1
            self.stats.online_stall_total += r.delay
            self.stats.stall_events += 1
            got = self.plane.admit(rid, pages, 'online')
            r.ok = got is not None
        if r.ok:
            self.online_pages[rid] = self.online_pages.get(rid, 0) + pages
        return r

    def free_online(self, rid):
        super().free_online(rid)
        self.plane.release_id(rid)

    def alloc_offline(self, rid, pages, now, prefix=None):
        """Ensure ``rid`` holds ``pages`` pages: fresh admissions attach
        any published shared ``prefix``; a surviving lease (partial
        invalidation victim) is *extended*, keeping its prefix."""
        lease = self.plane.admit(rid, pages, 'offline',
                                 prompt=prefix, scope='sim')
        if lease is None:
            return False
        for p in lease:
            self.reclaimer.note_handle_use(self.pool.handle_of(p), now)
        self.offline_pages[rid] = len(lease)
        return True

    def free_offline(self, rid):
        super().free_offline(rid)
        self.plane.release_id(rid)

    def note_filled(self, rid, tokens):
        lease = self.plane.get(rid)
        if lease is not None:
            lease.note_filled(tokens)

    def resume_tokens(self, rid):
        lease = self.plane.get(rid)
        return lease.resume_tokens if lease is not None else 0

    def held_pages(self, rid):
        lease = self.plane.get(rid)
        return len(lease) if lease is not None else 0

    def tick(self, now):
        h = self.miad.on_tick(now, self.pool.online_used_handles())
        # grow/shrink the reserved set toward H using empty handles only —
        # growth beyond empties happens lazily at the next pressure event
        while len(self.pool.reserved) < h:
            empties = self.pool.empty_offline_handles()
            if not empties:
                break
            self.pool.reserve_handle(empties[0], now)
        while len(self.pool.reserved) > h:
            if self.pool.release_reserved_handle() is None:
                break


COMPUTE_POLICIES = {
    'KernelPreempt': KernelPreempt,
    'GPreempt': GPreempt,
    'Channel': Channel,
}

MEMORY_POLICIES = {
    'UVM': UVM,
    'Prism': Prism,
    'StaticMem': StaticMem,
    'OurMem': OurMem,
}

# the paper's Fig. 10 strategy grid
STRATEGIES = [
    ('KernelPreempt', 'UVM'),
    ('GPreempt', 'UVM'),
    ('Channel', 'UVM'),
    ('Channel', 'Prism'),
    ('Channel', 'StaticMem'),
    ('Channel', 'OurMem'),        # = Valve
]
