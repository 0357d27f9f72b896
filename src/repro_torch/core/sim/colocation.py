"""Single-node colocation simulator (paper §7.2).

One GPU resource, one latency-critical ONLINE engine, one throughput
OFFLINE engine, pluggable compute/memory policies (strategies.py).  The
simulation is sequential in time (single resource ⇒ no event heap needed):
the online engine always wins the GPU, paying the strategy's preemption
delay when offline holds it; offline backfills idle per the strategy's
wake rule and memory headroom.

Calibration (7B-class model, production-scale numbers the paper quotes):
prefill ≈ 50 µs/token (32 k prompt → 1.6 s — why layer-level preemption
stretches to "hundreds of ms"), decode iteration ≈ 30 ms with ≈ 2 ms
host-side gaps between iterations (paper Fig. 4).

Work conservation: Channel/GPreempt context-save the in-flight offline
dispatch (it resumes later); KernelPreempt drains it (online eats the full
residual, offline keeps the work).  Valve invalidations preserve generated
tokens and requeue a recompute prefill; UVM/StaticMem kills restart the
request and forfeit its generated tokens.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.events import (
    EventBus, MemoryPressureEvent, PreemptionEvent, ReclamationEvent,
    WakeupEvent)
from repro_torch.core.sim.strategies import (
    AllocResult, Channel, ComputePolicy, GPreempt, KernelPreempt,
    MemoryPolicy, OurMem, Prism, StaticMem, UVM)
from repro_torch.core.sim.workload import OnlineRequest, WorkloadPair
from repro_torch.core.telemetry import TelemetryRegistry


@dataclass
class SimConfig:
    total_pages: int = 4096
    page_tokens: int = 16
    t_prefill_per_token: float = 50e-6
    t_decode_iter: float = 0.030
    t_decode_gap: float = 0.002
    online_max_batch: int = 32
    miad_tick: float = 0.25          # MIAD/lifecycle maintenance cadence
    # batched decode fast path: steady pure-decode stretches (online and
    # offline) execute without the per-request Python inner loop, replaying
    # the exact scalar float/rng/event sequence — SimResult telemetry is
    # bit-identical (gated in benchmarks/fleet_placement.py); the 100+-node
    # fleet harness needs this to stay inside CI budget
    vectorized: bool = False
    # -- watchdogs (long-horizon workloads tune these instead of tripping
    # the defaults) --
    watchdog_guard_steps: int = 50_000_000   # hard non-termination assert
    watchdog_stall_steps: int = 20_000       # zero-advance loops before forcing
    watchdog_force_step_s: float = 0.001     # forced clock step on a stall


@dataclass
class OnlineState:
    req: OnlineRequest
    pages: int = 0
    prefilled: bool = False
    tokens_done: int = 0
    t_first: Optional[float] = None
    t_last: Optional[float] = None
    stall: float = 0.0               # memory stall paid at admission


@dataclass
class OfflineReq:
    rid: str
    prefill_tokens: int              # tokens to (re)compute before decoding
    out_remaining: int
    pages: int
    generated: int = 0
    filled: int = 0                  # KV materialized (mirrors the lease)
    blocked: int = 0                 # consecutive failed re-allocations

    def __post_init__(self):
        self.prompt0 = self.prefill_tokens   # original prompt length
        self.pages0 = self.pages             # full page need (for realloc)


@dataclass
class SimResult:
    name: str
    ttft: Dict[str, float] = field(default_factory=dict)
    tpot: Dict[str, float] = field(default_factory=dict)
    offline_tokens: float = 0.0
    offline_tokens_wasted: float = 0.0
    recompute_tokens: float = 0.0
    horizon: float = 0.0
    compute_stats: object = None
    mem_stats: object = None
    max_preempt_per_request: int = 0
    # -- measured node telemetry (feeds the §6 cluster perf model) --
    # online-busy GPU spans (decode gaps coalesced) and the trace of memory
    # NOT held by online — exactly the inputs Eq. 1's P_compute / P_memory /
    # P_multi consume, so the cluster scheduler can run on simulated-measured
    # data instead of hand-written telemetry
    busy_intervals: List[Tuple[float, float]] = field(default_factory=list)
    mem_trace_t: List[float] = field(default_factory=list)
    mem_trace_free: List[float] = field(default_factory=list)
    # requests whose KV need exceeds the whole pool — rejected at admission
    # (the real engine returns a max-context error; admitting head-of-line
    # would block the queue forever)
    rejected: List[str] = field(default_factory=list)
    # -- the control-plane view (same typed stream the live runtime emits):
    # a TelemetryRegistry folding the sim's event bus — the cluster harness
    # reads these counters instead of scraping compute/mem stat objects
    telemetry: Optional[TelemetryRegistry] = None
    events: List[object] = field(default_factory=list)

    @property
    def offline_throughput(self) -> float:
        return self.offline_tokens / max(self.horizon, 1e-9)

    def online_busy_fraction(self) -> float:
        busy = sum(b - a for a, b in self.busy_intervals)
        return busy / max(self.horizon, 1e-9)


class NodeSim:
    def __init__(self, pair: WorkloadPair, compute: Optional[ComputePolicy],
                 memory: MemoryPolicy, cfg: Optional[SimConfig] = None,
                 *, offline_enabled: bool = True, events: bool = True):
        self.pair = pair
        self.cp = compute
        self.mp = memory
        self.cfg = cfg or SimConfig()
        self.offline_enabled = offline_enabled
        # typed event stream (identical shape to the live runtime's):
        # preemptions, reclamations (gate_closed=False for the baselines
        # that move pages under running compute — their §5 violation made
        # visible), wake-ups.  ``events=False`` is the overhead-measurement
        # baseline for benchmarks/api_overhead.py.
        self.bus = EventBus() if events else None
        self.telemetry = (TelemetryRegistry(self.bus)
                          if self.bus is not None else None)
        self._gated_since_wake = False

        self.now = 0.0
        self.arriv = list(pair.online.requests)
        self.next_arrival = 0
        self.waiting: List[OnlineState] = []
        self.active: List[OnlineState] = []
        self.result = SimResult(pair.name)

        # offline engine
        self._off_ids = itertools.count()
        self.off_pending: List[OfflineReq] = []   # needs (re)prefill
        self.off_running: List[OfflineReq] = []   # decoding
        # shared system prompt (HyGen-style): every offline request passes
        # the same synthetic token prefix to lease-capable memory policies,
        # which attach the published pages instead of re-prefilling them
        n_shared = pair.offline.shared_prefix_tokens
        self._prefix_base = list(range(n_shared)) if n_shared > 0 else None
        self.off_busy_until = 0.0
        self.off_inflight: Optional[Tuple[str, float, List[OfflineReq]]] = None
        # ('prefill'|'decode', started_at, targets)
        self._last_tick = 0.0

    # ------------------------------------------------------------------
    # Offline bookkeeping
    # ------------------------------------------------------------------
    def _off_sizes(self) -> Tuple[int, int]:
        """(prompt, output) for the next offline request (size mix aware)."""
        w = self.pair.offline
        if w.prompt_choices:
            if not hasattr(self, '_off_rng'):
                import numpy as np
                self._off_rng = np.random.default_rng(w.seed)
            p = int(self._off_rng.choice(w.prompt_choices))
            o = int(self._off_rng.choice(w.output_choices or
                                         (w.output_tokens,)))
            return p, o
        return w.prompt_tokens, w.output_tokens

    def _off_pages_needed(self, prompt: int, out: int) -> int:
        return -(-(prompt + out) // self.cfg.page_tokens)

    def _off_prefix(self, prompt: int) -> Optional[List[int]]:
        """The shared system prompt clamped below this request's prompt
        length (≥1 token always remains to prefill)."""
        if self._prefix_base is None:
            return None
        return self._prefix_base[: max(0, prompt - 1)]

    def _off_resync(self, r: OfflineReq) -> None:
        """Align a request's prefill need with its lease's valid-KV prefix
        (shared attach on admission, surviving prefix after re-extension)."""
        resume = self.mp.resume_tokens(r.rid)
        if resume > r.filled:
            r.prefill_tokens = max(1, (r.prompt0 + r.generated) - resume)
            r.filled = resume

    def _off_admit(self) -> None:
        """Top up in-flight offline requests while memory allows."""
        w = self.pair.offline
        while (len(self.off_running) + len(self.off_pending) < w.max_batch):
            rid = f'off-{next(self._off_ids)}'
            prompt, out = self._off_sizes()
            pages = self._off_pages_needed(prompt, out)
            if not self.mp.alloc_offline(rid, pages, self.now,
                                         self._off_prefix(prompt)):
                break
            r = OfflineReq(rid, prompt, out, pages)
            self._off_resync(r)      # shared prefix: skip its prefill
            self.off_pending.append(r)

    def _off_invalidate(self, res: AllocResult) -> None:
        """Apply a memory policy's invalidations/kills to the offline engine."""
        byid = {r.rid: r for r in self.off_pending + self.off_running}
        for rid in set(res.invalidated) | res.killed:
            r = byid.get(rid)
            if r is None:
                continue
            if r in self.off_pending:
                self.off_pending.remove(r)
            if r in self.off_running:
                self.off_running.remove(r)
            if rid in res.killed:
                # restart from zero: generated work forfeited
                self.result.offline_tokens -= r.generated
                self.result.offline_tokens_wasted += r.generated
                self.mp.free_offline(rid)
            else:
                # Valve: tokens kept; recompute only what was materialized
                # BEYOND the surviving prefix, then resume.  Whole-request
                # policies report no survivors → full restart as before.
                surv = res.surviving.get(rid, 0)
                self.result.recompute_tokens += max(0, r.filled - surv)
                r.prefill_tokens = max(
                    1, (r.prompt0 + r.generated) - surv)
                r.filled = min(r.filled, surv)
                # surviving pages stay leased; the lost tail re-extends
                # lazily at the next offline dispatch (an immediate re-grab
                # would steal the pages the online burst is reclaiming FOR
                # and thrash the reclaimer)
                r.pages = self.mp.held_pages(rid)
                if r.pages == 0:
                    self.mp.free_offline(rid)
                self.off_pending.insert(0, r)
        # drop in-flight dispatch targets that vanished
        if self.off_inflight is not None:
            kind, t0, targets = self.off_inflight
            targets = [t for t in targets
                       if t in self.off_running or t in self.off_pending]
            self.off_inflight = (kind, t0, targets)

    def _publish_wakeup(self) -> None:
        """First offline dispatch after a preemption = the wake-up; record
        the §4.2 wake-rule inputs (idle span vs T_cool) when the compute
        policy tracks them (Channel — the Valve path)."""
        if self.bus is None or not self._gated_since_wake:
            return
        lc = getattr(self.cp, 'lifecycle', None)
        self.bus.publish(
            WakeupEvent, t=self.now,
            idle_for_s=lc.idle_for(self.now) if lc is not None else 0.0,
            t_cool_s=lc.t_cool if lc is not None else 0.0)
        self._gated_since_wake = False

    def _off_start_dispatch(self) -> bool:
        """Start one offline dispatch at self.now if there is work."""
        if not self.offline_enabled:
            return False
        self._off_admit()
        # re-extend recompute victims to their full page need (surviving
        # leases keep their prefix; dead ones re-admit, possibly attaching
        # a shared prefix again)
        for r in self.off_pending:
            if r.pages >= r.pages0:
                continue
            if self.mp.alloc_offline(r.rid, r.pages0, self.now,
                                     self._off_prefix(r.prompt0)):
                r.pages, r.blocked = r.pages0, 0
                self._off_resync(r)
            else:
                # sustained pressure: surviving prefixes held by blocked
                # victims must not starve re-admission — spill our own
                # survivors and fall back to whole-request recompute
                r.blocked += 1
                if r.blocked >= 3 and r.pages > 0:
                    # the forfeited surviving prefix is recompute work too
                    self.result.recompute_tokens += r.filled
                    self.mp.free_offline(r.rid)
                    r.pages, r.filled, r.blocked = 0, 0, 0
                    r.prefill_tokens = r.prompt0 + r.generated
        ready_pending = [r for r in self.off_pending if r.pages >= r.pages0]
        if ready_pending:
            r = ready_pending[0]
            dur = r.prefill_tokens * self.cfg.t_prefill_per_token
            self.off_inflight = ('prefill', self.now, [r])
            self.off_busy_until = self.now + dur
            self._publish_wakeup()
            return True
        if self.off_running:
            self.off_inflight = ('decode', self.now, list(self.off_running))
            self.off_busy_until = self.now + self.cfg.t_decode_iter
            self._publish_wakeup()
            return True
        return False

    def _off_complete_dispatch(self) -> None:
        """Apply the effects of the offline dispatch ending at off_busy_until."""
        kind, t0, targets = self.off_inflight
        self.off_inflight = None
        if kind == 'prefill':
            if not targets:        # victim invalidated while in flight
                return
            r = targets[0]
            if r in self.off_pending:
                self.off_pending.remove(r)
                self.off_running.append(r)
                # the whole context is materialized now — the lease's fill
                # fact drives prefix publication and surviving prefixes
                r.filled = r.prompt0 + r.generated
                self.mp.note_filled(r.rid, r.filled)
        else:
            for r in targets:
                if r not in self.off_running:
                    continue
                r.generated += 1
                r.out_remaining -= 1
                r.filled = r.prompt0 + r.generated
                self.mp.note_filled(r.rid, r.filled)
                self.result.offline_tokens += 1
                if r.out_remaining <= 0:
                    self.off_running.remove(r)
                    self.mp.free_offline(r.rid)

    def _off_preempt(self, online_t: float) -> float:
        """Online needs the GPU at ``online_t`` while offline is in flight.
        Returns when online may start."""
        if self.off_inflight is None or self.off_busy_until <= online_t:
            if self.off_busy_until > 0 and self.off_inflight is not None \
                    and self.off_busy_until <= online_t:
                self._off_complete_dispatch()
            return online_t
        remaining = self.off_busy_until - online_t
        delay = self.cp.preempt_delay(remaining)
        # only ADMITTED requests experience the preemption (queued requests
        # aren't executing)
        active_ids = {s.req.req_id for s in self.active}
        self.cp.note_preemption(active_ids, delay)
        if self.bus is not None:
            self.bus.publish(PreemptionEvent, t=online_t, latency_s=delay,
                             requests=tuple(sorted(active_ids)),
                             trigger='lifecycle')
        self._gated_since_wake = True
        if isinstance(self.cp, KernelPreempt):
            # drain: the offline iteration completes
            self.off_busy_until = online_t + delay
            self._off_complete_dispatch()
        else:
            # context save: the dispatch's remaining work returns to queue
            kind, t0, targets = self.off_inflight
            self.off_inflight = None
            if kind == 'prefill' and targets:
                done_frac = max(0.0, (online_t - t0)
                                / max(self.off_busy_until - t0, 1e-12))
                r = targets[0]
                # round UP and clamp to ≥1: the dispatch did NOT complete
                # (we are strictly before off_busy_until), so truncating a
                # nearly-finished prefill to 0 remaining tokens would credit
                # offline with free work on resume
                remaining = r.prefill_tokens * (1.0 - done_frac)
                r.prefill_tokens = max(1, int(math.ceil(remaining - 1e-9)))
            # decode iteration: tokens not produced; requests stay running
            self.off_busy_until = online_t + delay
        return online_t + delay

    # ------------------------------------------------------------------
    # Measured telemetry (the cluster plane's view of this node)
    # ------------------------------------------------------------------
    def _note_busy(self, a: float, b: float) -> None:
        """Record an online-busy span; spans separated by ≤ 2 decode gaps
        coalesce (the inter-iteration gap is not harvestable idle — that is
        the whole point of T_cool)."""
        if b <= a:
            return
        iv = self.result.busy_intervals
        if iv and a <= iv[-1][1] + 2.0 * self.cfg.t_decode_gap + 1e-9:
            iv[-1] = (iv[-1][0], max(iv[-1][1], b))
        else:
            iv.append((a, b))

    def _sample_mem(self, now: float) -> None:
        """Sample pages NOT held by online — the memory a colocated offline
        job could occupy at this instant (Eq. 2's free-memory trace)."""
        free_for_offline = self.mp.total - sum(self.mp.online_pages.values())
        tr_t = self.result.mem_trace_t
        if tr_t and now <= tr_t[-1] + 1e-12:
            self.result.mem_trace_free[-1] = free_for_offline
            return
        tr_t.append(now)
        self.result.mem_trace_free.append(float(free_for_offline))

    # ------------------------------------------------------------------
    # Online engine
    # ------------------------------------------------------------------
    def _pages_for(self, req: OnlineRequest) -> int:
        return -(-(req.prompt_tokens + req.output_tokens)
                 // self.cfg.page_tokens)

    def _pump_arrivals(self) -> None:
        while (self.next_arrival < len(self.arriv)
               and self.arriv[self.next_arrival].t_arrive <= self.now):
            req = self.arriv[self.next_arrival]
            self.next_arrival += 1
            self.waiting.append(OnlineState(req))
            # lifecycle start fires at ADMISSION (like the real engine): a
            # queued-but-unadmitted request produces no GPU activity, and
            # gating offline on it deadlocks Prism (online waits for memory
            # offline holds; offline waits for online idle)

    def _admit_online(self) -> None:
        while self.waiting and len(self.active) < self.cfg.online_max_batch:
            st = self.waiting[0]
            if self._pages_for(st.req) > self.mp.total:
                # oversized: no admission order can ever satisfy it — reject
                # like the real engine's max-context error instead of
                # livelocking the head of the queue
                self.waiting.pop(0)
                self.result.rejected.append(st.req.req_id)
                continue
            res = self.mp.alloc_online(st.req.req_id,
                                       self._pages_for(st.req), self.now)
            if res.reclaimed and self.bus is not None:
                self.bus.publish(MemoryPressureEvent, t=self.now,
                                 req_id=st.req.req_id,
                                 deficit_pages=res.deficit_pages)
                # physical pages: with leases a shared prefix page appears
                # in every using lease's record — count each page id once.
                # Whole-request policies use SYMBOLIC per-request ids
                # (range(n) each), where a set union would undercount.
                if self.mp.supports_leases:
                    n_pages = len({p for v in res.invalidated.values()
                                   for p in v})
                else:
                    n_pages = sum(len(v) for v in res.invalidated.values())
                self.bus.publish(
                    ReclamationEvent, t=self.now,
                    n_handles=res.reclaimed_handles,
                    requests=tuple(sorted(set(res.invalidated) | res.killed)),
                    pages=n_pages,
                    gate_closed=res.gate_closed, killed=bool(res.killed))
            self._off_invalidate(res)
            if not res.ok:
                break                       # head-of-line blocks (Prism)
            self.now += res.delay           # reclamation/fault stall
            st.stall += res.delay
            st.pages = self._pages_for(st.req)
            self.waiting.pop(0)
            self.active.append(st)
            if self.cp:
                self.cp.on_online_request_start(st.req.req_id, self.now)

    def _finish_online(self, st: OnlineState) -> None:
        self.active.remove(st)
        self.mp.free_online(st.req.req_id)
        if self.cp:
            self.cp.on_online_request_end(st.req.req_id, self.now)
        r = st.req
        self.result.ttft[r.req_id] = st.t_first - r.t_arrive
        if r.output_tokens > 1:
            self.result.tpot[r.req_id] = ((st.t_last - st.t_first)
                                          / (r.output_tokens - 1))

    def _online_dispatch(self) -> bool:
        """Run one online dispatch; returns True if one ran."""
        self._pump_arrivals()
        self._admit_online()
        needs_prefill = [s for s in self.active if not s.prefilled]
        decoding = [s for s in self.active if s.prefilled]
        if not needs_prefill and not decoding:
            return False
        start = self._off_preempt(self.now)
        self.now = start
        if needs_prefill:
            st = needs_prefill[0]
            dur = st.req.prompt_tokens * self.cfg.t_prefill_per_token
            self.now += dur
            st.prefilled = True
            st.tokens_done = 1              # prefill emits the first token
            st.t_first = st.t_last = self.now
            self._note_busy(start, self.now)
            if self.cp:
                self.cp.on_online_iter(start, self.now)
            if st.req.output_tokens <= 1:
                self._finish_online(st)
            return True
        # decode iteration over the whole batch
        self.now += self.cfg.t_decode_iter
        self._note_busy(start, self.now)
        if self.cp:
            self.cp.on_online_iter(start, self.now)
        for st in list(decoding):
            st.tokens_done += 1
            st.t_last = self.now
            if st.tokens_done >= st.req.output_tokens:
                self._finish_online(st)
        # the inter-iteration gap (paper Fig. 4): immediate-wake policies
        # inject offline work here — and pay a preemption at the next
        # iteration; Channel's T_cool (> gap) never fires in a gap
        if (self.offline_enabled and self.off_inflight is None
                and self.active and self.cp is not None
                and self.cp.offline_may_start(self.now)):
            self._off_start_dispatch()
        self.now += self.cfg.t_decode_gap
        return True

    # ------------------------------------------------------------------
    # Batched decode fast path (cfg.vectorized)
    # ------------------------------------------------------------------
    def _burst_online_decode(self) -> bool:
        """Run K back-to-back online decode iterations without the
        per-request inner loop.

        Bit-identity with the scalar loop is the contract: the clock
        replays the exact scalar float sequence (``now += t_iter``;
        ``now += t_gap``), ticks/lifecycle/busy-span calls fire at the
        same instants, and the only deferred state — per-request
        ``tokens_done``/``t_last`` — is integer-counted and flushed once,
        which is exact in float64.  Ticks run inline at their scalar
        instants; the burst stops one iteration before any finish and
        breaks at arrivals and offline wake-ups, so the scalar loop
        handles every state transition.
        """
        active = self.active
        if not active or self.waiting or self.off_inflight is not None:
            return False
        for st in active:
            if not st.prefilled:
                return False
        # batch the per-request remaining-token bound over the whole batch
        k_max = int(np.fromiter(
            (st.req.output_tokens - st.tokens_done for st in active),
            dtype=np.int64, count=len(active)).min()) - 1
        if k_max < 1:
            return False
        cfg = self.cfg
        t_iter, t_gap = cfg.t_decode_iter, cfg.t_decode_gap
        tick_every = cfg.miad_tick
        arriv, n_arr = self.arriv, len(self.arriv)
        cp = self.cp
        now = self.now
        last_end = now
        executed = 0
        while executed < k_max:
            i = self.next_arrival
            if i < n_arr and arriv[i].t_arrive <= now:
                break            # scalar entry pumps + admits the arrival
            if executed and now - self._last_tick >= tick_every:
                self._last_tick = now     # iteration 0's tick ran in run()
                self.mp.tick(now)
                self._sample_mem(now)
            start = now
            now += t_iter
            self._note_busy(start, now)
            if cp is not None:
                cp.on_online_iter(start, now)
            last_end = now
            executed += 1
            started = False
            if (self.offline_enabled and cp is not None
                    and cp.offline_may_start(now)):
                self.now = now            # dispatch stamps self.now
                started = self._off_start_dispatch()
            now += t_gap
            if started:
                break            # next scalar entry pays the preemption
        if executed:
            for st in active:
                st.tokens_done += executed
                st.t_last = last_end
            self.now = now
        return executed > 0

    def _burst_offline_decode(self) -> bool:
        """Run K offline decode dispatches back to back, deferring the
        per-target completion bookkeeping to one flush.

        Safe to defer because during a pure-decode stretch the deferred
        facts are write-only: token counts are integers (exact under one
        batched add), lease fills only move forward and publish nothing
        (every running request materialized its shared prefix at prefill
        completion), and MIAD's tick reads handle *allocation*, not fill.
        The admission probe is replayed exactly per dispatch — same rid
        counter, rng draws, and alloc calls as the scalar loop — so a
        success ends the burst and the scalar path prefills it.
        """
        if (not self.offline_enabled or self.off_inflight is not None
                or self.active or self.waiting or self.off_pending
                or not self.off_running or self._gated_since_wake):
            return False
        if (self.next_arrival < len(self.arriv)
                and self.arriv[self.next_arrival].t_arrive <= self.now):
            return False         # scalar entry admits the arrival first
        k_max = int(np.fromiter(
            (r.out_remaining for r in self.off_running),
            dtype=np.int64, count=len(self.off_running)).min()) - 1
        if k_max < 1:
            return False
        cfg = self.cfg
        t_iter, tick_every = cfg.t_decode_iter, cfg.miad_tick
        horizon = self.pair.online.horizon_s
        arrivals_done = self.next_arrival >= len(self.arriv)
        next_arr = (horizon if arrivals_done
                    else self.arriv[self.next_arrival].t_arrive)
        w = self.pair.offline
        cp = self.cp
        now = self.now
        executed = 0
        while executed < k_max:
            if executed and now - self._last_tick >= tick_every:
                self._last_tick = now     # iteration 0's tick ran in run()
                self.mp.tick(now)
                self._sample_mem(now)
            if arrivals_done and now >= horizon:
                break            # run() ends the sim at this entry
            if cp is not None and not cp.offline_may_start(now):
                break
            if now + t_iter >= next_arr:
                # arrival/horizon lands inside the dispatch — defer the
                # WHOLE iteration (probe included: its rid/rng/alloc
                # sequence belongs to the dispatch the scalar path starts)
                break
            if len(self.off_running) + len(self.off_pending) < w.max_batch:
                # _off_admit's probe, replayed exactly
                rid = f'off-{next(self._off_ids)}'
                prompt, out = self._off_sizes()
                pages = self._off_pages_needed(prompt, out)
                if self.mp.alloc_offline(rid, pages, now,
                                         self._off_prefix(prompt)):
                    r = OfflineReq(rid, prompt, out, pages)
                    self._off_resync(r)
                    self.off_pending.append(r)
                    break        # scalar path prefills the admission
            now += t_iter
            self.off_busy_until = now
            executed += 1
        if executed:
            for r in self.off_running:
                r.generated += executed
                r.out_remaining -= executed
                r.filled = r.prompt0 + r.generated
                self.mp.note_filled(r.rid, r.filled)
            self.result.offline_tokens += executed * len(self.off_running)
            self.now = now
        return executed > 0

    # ------------------------------------------------------------------
    def run(self) -> SimResult:
        horizon = self.pair.online.horizon_s
        guard = 0
        stall = 0
        last_now = -1.0
        while True:
            guard += 1
            assert guard < self.cfg.watchdog_guard_steps, \
                'sim did not terminate'
            # watchdog: if the clock stops advancing (degenerate zero-length
            # dispatch loops), force a step rather than livelock
            if self.now <= last_now + 1e-12:
                stall += 1
                if stall > self.cfg.watchdog_stall_steps:
                    self.now = last_now + self.cfg.watchdog_force_step_s
                    stall = 0
            else:
                stall = 0
                last_now = self.now
            if self.now - self._last_tick >= self.cfg.miad_tick:
                self._last_tick = self.now
                self.mp.tick(self.now)
                self._sample_mem(self.now)
            if self.cfg.vectorized and (self._burst_online_decode()
                                        or self._burst_offline_decode()):
                continue
            ran = self._online_dispatch()
            if ran:
                continue
            done = (self.next_arrival >= len(self.arriv)
                    and not self.waiting and not self.active)
            if done and self.now >= horizon:
                break
            # idle: complete offline dispatch, backfill, or jump time
            if self.off_inflight is not None:
                if self.off_busy_until <= self.now:
                    self._off_complete_dispatch()
                    continue
            next_arr = (self.arriv[self.next_arrival].t_arrive
                        if self.next_arrival < len(self.arriv) else horizon)
            if self.offline_enabled and self.off_inflight is None \
                    and (self.cp is None or self.cp.offline_may_start(self.now)):
                if self._off_start_dispatch():
                    # run until the dispatch ends or online work appears
                    t_next = min(self.off_busy_until, next_arr)
                    self.now = max(self.now, t_next)
                    continue
            if self.off_inflight is not None:
                # wait for the dispatch to end — or for the next arrival if
                # it comes first.  An arrival already in the past must not
                # clamp the jump to ``now`` (that stalls the clock below
                # off_busy_until forever when online is memory-blocked),
                # and a dispatch that ended in the past must not rewind the
                # clock (it completes on the next loop entry).
                t_next = self.off_busy_until
                if next_arr > self.now:
                    t_next = min(t_next, next_arr)
                self.now = max(self.now, t_next)
                continue
            # truly idle: jump to next arrival or wake-check boundary
            t_jump = next_arr
            if (self.cp is not None and self.offline_enabled
                    and not self.cp.offline_may_start(self.now)):
                t_jump = min(t_jump, self.now + 0.001)  # poll wake boundary
            if t_jump <= self.now:
                t_jump = self.now + 0.001
            self.now = min(t_jump, max(horizon, self.now + 0.001)) \
                if done else t_jump
            if done and self.now >= horizon:
                break

        self.result.horizon = max(self.now, horizon)
        self._sample_mem(self.result.horizon)
        if not self.result.mem_trace_t or self.result.mem_trace_t[0] > 0.0:
            # anchor the trace at t=0 (full memory before any admission)
            self.result.mem_trace_t.insert(0, 0.0)
            self.result.mem_trace_free.insert(0, float(self.mp.total))
        self.result.compute_stats = self.cp.stats if self.cp else None
        self.result.mem_stats = self.mp.stats
        if self.cp:
            self.result.max_preempt_per_request = max(
                self.cp.stats.per_request.values(), default=0)
        # the control-plane view: the same ordered facts the live runtime
        # publishes, folded by the same registry the orchestrator reads
        self.result.telemetry = self.telemetry
        if self.bus is not None:
            self.result.events = list(self.bus.log)
        return self.result


# ---------------------------------------------------------------------------
# Runners
# ---------------------------------------------------------------------------

def run_strategy(pair: WorkloadPair, compute_name: str, memory_name: str,
                 cfg: Optional[SimConfig] = None,
                 eviction_policy: str = 'valve') -> SimResult:
    from repro_torch.core.sim import strategies as S
    cfg = cfg or SimConfig()
    cp = S.COMPUTE_POLICIES[compute_name]()
    if memory_name == 'OurMem':
        mp = OurMem(cfg.total_pages, cfg.page_tokens, policy=eviction_policy)
    else:
        mp = S.MEMORY_POLICIES[memory_name](cfg.total_pages, cfg.page_tokens)
    res = NodeSim(pair, cp, mp, cfg).run()
    res.name = f'{pair.name}:{compute_name}+{memory_name}'
    return res


def run_online_standalone(pair: WorkloadPair,
                          cfg: Optional[SimConfig] = None) -> SimResult:
    """Online alone: full memory, no offline — the TTFT/TPOT baseline."""
    cfg = cfg or SimConfig()
    mp = Prism(cfg.total_pages, cfg.page_tokens)
    res = NodeSim(pair, None, mp, cfg, offline_enabled=False).run()
    res.name = f'{pair.name}:standalone'
    return res


def run_offline_standalone(pair: WorkloadPair,
                           cfg: Optional[SimConfig] = None) -> SimResult:
    """Offline monopolizing the GPU — Thrput_(w,max) for normalization."""
    cfg = cfg or SimConfig()
    empty_online = WorkloadPair(
        pair.name,
        type(pair.online)(pair.online.name, [], pair.online.horizon_s),
        pair.offline)
    mp = Prism(cfg.total_pages, cfg.page_tokens)
    res = NodeSim(empty_online, None, mp, cfg).run()
    res.name = f'{pair.name}:offline-max'
    return res
