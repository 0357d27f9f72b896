"""Continuous-batching inference engine with the Valve patch surface.

The execution layer of the serving plane, ported from the reference's
``serving/engine.py``.  Scheduling policy lives in
:mod:`repro_torch.serving.scheduler` (:class:`BatchScheduler` composes each
dispatch: budgeted multi-request chunked prefill + piggybacked decode
slots); this module turns a :class:`ScheduledBatch` into one fixed-shape
dispatch over preallocated host buffers.  The KV cache is updated in place
(``index_put_``) where the reference donates it to a jitted step.

Valve integration points (and *only* these -- Table 1's deployability
claim): the engine holds ONE class-scoped :class:`~repro_torch.core.api.
ValveSession` (``runtime.open_session``), whose calls are tagged
``# VALVE-SESSION``, alongside the <= 13-LOC invalidation patch
(:meth:`Engine.on_pages_invalidated`).  Both are counted by
``tests/test_torch_patch_surface.py``.

Memory-plane API v1: ``session.admit`` returns a
:class:`~repro_torch.core.memory.KVLease`; page-aligned shared prompt
prefixes attach copy-on-write, ``lease.note_filled`` publishes prefix
pages, and the invalidation patch resumes recompute from the surviving
prefix the :class:`~repro_torch.core.memory.LeaseInvalidation` carries.

One path a token (a deliberate departure from the reference's dispatch
internals): a decode token is always computed by the decode entry point
(``decode_fn`` / ``decode_sample_fn``), and a prompt's last chunk by the
chunked-prefill entry.  The reference runs piggybacked decode rows as
one-token rows of the chunked-prefill dispatch, and resumes a migrated
lease (the disaggregated handoff, a cross-pool rescue) with a one-token
prefill chunk.  The two entries compute the same function in another
order; on the card in bf16 the difference flips greedy near-ties, so a
token would depend on what else shared its step.  Here a mixed step runs
its prefill rows through the chunked entry and its decode rows through
the decode entry, inside one Valve iteration, and a lease resumed at its
last sampled token enters as a decode slot; every token of a request then
comes out of the same computation whatever the schedule, which the
serving plane's bit-identity claims (streamed == drained, disaggregated
== colocated) rest on.

The engine runs on the GPU unless built with ``device='cpu'``
(:func:`repro_torch.resolve_device`).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.api import PoolSession
from repro_torch.core.clock import RealClock
from repro_torch.kernels.paged_attention.prefix import build_shared_runs
from repro_torch.serving.kvpool import QUARANTINE_PAGE
from repro_torch.serving.sampler import sample
from repro_torch.serving.scheduler import (
    BatchScheduler, DecodeSlot, Request, ReqState, ScheduledBatch,
    SchedulerConfig)

__all__ = ['Engine', 'EngineConfig', 'EngineStats', 'Request', 'ReqState']


@dataclass
class EngineConfig:
    max_batch: int = 8
    max_seq: int = 512              # prompt + generation budget per request
    prefill_chunk: int = 64         # per-request prefill tokens per dispatch
    max_prefill_reqs: int = 4       # prefill rows per mixed dispatch
    # total prefill tokens per dispatch; None -> max_prefill_reqs x chunk
    prefill_budget: Optional[int] = None
    piggyback_decode: bool = True   # decode slots ride along with prefill
    temperature: float = 0.0
    seed: int = 0
    klass: str = 'offline'          # 'online' | 'offline'
    eos_token: Optional[int] = None
    # Decode attention through the paged-decode kernel (pages read through
    # the page table) instead of the full-gather oracle.  None -> the kernel
    # when the cache is on CUDA; True on the CPU runs the kernel's plain
    # version.
    decode_kernel: Optional[bool] = None
    # Fused decode+sampling: the decode dispatch returns sampled (B,) tokens
    # instead of (B, V) scores (fused unembed+argmax -- scores never reach
    # memory), tokens stay on the device between decode iterations (values
    # are fetched lazily via Engine.flush_tokens / output_tokens).  Greedy
    # drains pick the same tokens as the unfused path.  With eos_token set,
    # tokens are fetched every step (the stop check needs the value).
    fused_sampling: bool = False
    # Deduplicate copy-on-write shared prefix pages across each decode
    # batch (kernels.paged_attention.prefix): each shared physical page is
    # read once per batch instead of once per request.
    prefix_shared_attention: bool = False

    def scheduler_config(self) -> SchedulerConfig:
        return SchedulerConfig(
            max_batch=self.max_batch, chunk=self.prefill_chunk,
            max_prefill_reqs=min(self.max_prefill_reqs, self.max_batch),
            prefill_budget=self.prefill_budget,
            piggyback_decode=self.piggyback_decode)


@dataclass
class EngineStats:
    steps: int = 0
    dispatches: int = 0             # actual device dispatches issued
    mixed_dispatches: int = 0       # dispatches carrying >=1 prefill slot
    prefill_chunks: int = 0         # prefill slots executed (per-request)
    decode_iterations: int = 0      # dispatches carrying >=1 decode slot
    tokens_generated: int = 0
    tokens_recomputed: int = 0
    invalidations: int = 0
    blocked_dispatches: int = 0     # offline dispatches skipped while gated
    spills: int = 0                 # surviving prefixes dropped under pressure
    cancellations: int = 0          # requests abandoned before finishing
    token_flushes: int = 0          # lazy device->host token syncs (fused path)
    shared_page_reads_saved: int = 0  # page reads deduped by prefix sharing


class Engine:
    """One engine = one model instance on one device."""

    def __init__(self, model, params, pool,
                 cfg: Optional[EngineConfig] = None, *,
                 runtime=None, clock=None, device=None):
        self.model = model
        self.mcfg = model.cfg
        self.cfg = cfg or EngineConfig()
        self.device = resolve_device(device)
        if params['embed'].device != self.device:
            raise ValueError(f'params on {params["embed"].device}, engine on '
                             f'{self.device}')
        self.params = params
        self.runtime = runtime
        # with a runtime, the node-shared pool is authoritative; passing a
        # DIFFERENT pool alongside it would silently serve divergent state
        assert runtime is None or pool is None or pool is runtime.pool, \
            'pool conflicts with runtime.pool'
        self.pool = runtime.pool if runtime is not None else pool
        assert self.pool is not None, 'engine needs a KVPool or a runtime'
        self.clock = clock or (runtime.clock if runtime else RealClock())
        # the complete Valve control-plane integration: one class-scoped
        # session (alloc/notify/gate/invalidation-routing); a bare pool
        # gets the same interface with no runtime behind it
        if runtime is not None:
            self.session = runtime.open_session(                # VALVE-SESSION
                self.cfg.klass, on_invalidate=self.on_pages_invalidated)
        else:
            self.session = PoolSession(self.pool, self.cfg.klass)
        self.cache = model.init_cache(engine_pages=self.pool.n_pages,
                                      device=self.device)
        self.pg = self.mcfg.page_size
        self.maxp = self.cfg.max_seq // self.pg
        self.requests: Dict[str, Request] = {}
        self.sched = BatchScheduler(self.cfg.scheduler_config())
        # the scheduler owns the lists; the engine (and the Valve patch)
        # aliases them -- same objects, never rebound
        self.queue: List[str] = self.sched.queue
        self.running: List[str] = self.sched.running
        self.stats = EngineStats()
        self._gen = torch.Generator(device=self.device).manual_seed(
            self.cfg.seed)
        decode_kernel = self.cfg.decode_kernel
        if decode_kernel is None:
            decode_kernel = self.device.type == 'cuda'
        self._use_kernel = decode_kernel
        self._init_buffers()
        # lazy-token bookkeeping (fused path): device tensors whose values
        # have not been copied to req.generated yet, and the row map of
        # the newest decode output (the device-feed source)
        self._pending: List[tuple] = []
        # staged-device-tensor cache for decode dispatch inputs (see
        # _dispatch_decode): keyed by the exact host bytes they derive from
        self._stage: Dict = {}
        self._pending_rids: set = set()
        self._prev_tokens = torch.zeros((self.cfg.max_batch,),
                                        dtype=torch.int32, device=self.device)
        self._prev_rows: Dict[str, int] = {}
        self._seed_ctr = itertools.count()

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        """Stage a host buffer on the device (always a copy: the buffers
        are refilled in place every step)."""
        return torch.tensor(arr, device=self.device)

    def _init_buffers(self) -> None:
        """Preallocate the fixed-shape host staging buffers (one mixed
        dispatch shape, one decode dispatch shape) -- filled in place each
        step, never reallocated."""
        b, c = self.cfg.max_batch, self.cfg.prefill_chunk
        self._mix = {
            'toks': np.zeros((b, c), np.int32),
            'poss': np.zeros((b, c), np.int32),
            'pids': np.zeros((b, c), np.int32),
            'offs': np.zeros((b, c), np.int32),
            'pts': np.zeros((b, self.maxp), np.int32),
            'kv_len': np.zeros((b,), np.int32),
            'last_idx': np.zeros((b,), np.int32),
        }
        self._dec = {
            'toks': np.zeros((b,), np.int32),
            'poss': np.zeros((b,), np.int32),
            'pts': np.zeros((b, self.maxp), np.int32),
            # fused path: per-row device-feed selectors
            'use_prev': np.zeros((b,), np.int32),
            'src': np.zeros((b,), np.int32),
        }

    # ------------------------------------------------------------------
    # Submission
    # ------------------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32,
               req_id: Optional[str] = None) -> str:
        # no bind step: invalidation routing follows allocation ownership
        rid = req_id or self.session.new_request_id()       # VALVE-SESSION
        assert len(prompt) > 0, 'empty prompt'
        assert len(prompt) + max_new_tokens <= self.cfg.max_seq, \
            (len(prompt), max_new_tokens, self.cfg.max_seq)
        req = Request(rid, list(map(int, prompt)), max_new_tokens,
                      t_submit=self.clock.now())
        self.requests[rid] = req
        self.sched.submit(rid)
        return rid

    # ------------------------------------------------------------------
    # Valve patch surface -- the complete framework-side modification.
    # LOC counted by tests/test_torch_patch_surface.py (paper Table 1: < 20).
    # ------------------------------------------------------------------
    # >>> VALVE-PATCH-BEGIN
    def on_pages_invalidated(self, invalidated: Dict[str, List[int]]) -> None:
        for rid, inv in invalidated.items():
            # session routing delivers only ids holding a live lease, so
            # the request exists and is not FINISHED
            req = self.requests[rid]
            # recompute charge: a queued victim hit again loses only the
            # shrink from its old resume point (0 for duplicate deliveries)
            base = req.n_prefilled if rid in self.queue else len(req.context)
            self.stats.tokens_recomputed += base - inv.resume
            # keep the surviving prefix: prefill resumes at inv.resume
            req.pages, req.n_prefilled = req.pages[:inv.keep], inv.resume
            if rid in self.queue:
                continue
            req.state, req.recomputes = ReqState.WAITING, req.recomputes + 1
            self.running.remove(rid)
            self.queue.insert(0, rid)
            self.stats.invalidations += 1
    # >>> VALVE-PATCH-END

    # ------------------------------------------------------------------
    # Memory plumbing
    # ------------------------------------------------------------------
    def _fill_page_table(self, row: np.ndarray, req: Request) -> np.ndarray:
        row.fill(QUARANTINE_PAGE)
        row[: len(req.pages)] = req.pages
        return row

    # ------------------------------------------------------------------
    # Scheduling step
    # ------------------------------------------------------------------
    def _gated(self) -> bool:
        return not self.session.may_dispatch()              # VALVE-SESSION

    def _try_admit(self, req: Request) -> Optional[List[int]]:
        """Admission callback for the scheduler.  The session bundles the
        lifecycle notification with the lease -- lifecycle first, so the
        request's arrival closes the gates BEFORE any allocation can
        trigger reclamation.  Passing the prompt opts into copy-on-write
        prefix sharing; re-admitting a partially-invalidated request extends
        its live lease and keeps the surviving prefix."""
        need = -(-req.target_len // self.pg)
        lease = self.session.admit(                         # VALVE-SESSION
            req.req_id, need, req.prompt)
        if lease is not None:
            # None must NOT clobber req.lease: a failed RE-admission leaves
            # the surviving lease live in the plane, and _spill needs the
            # handle to actually release it
            req.lease = lease
        return lease

    def _spill(self, req: Request) -> None:
        """Scheduler deadlock valve: drop a waiting request's surviving-
        prefix pages under sustained admission pressure (degrades to the
        whole-request recompute)."""
        if req.lease is not None:
            req.lease.release()
        # the forfeited surviving prefix becomes recompute work
        self.stats.tokens_recomputed += req.n_prefilled
        req.pages, req.n_prefilled, req.lease = [], 0, None
        self.stats.spills += 1

    def _finish(self, req: Request) -> None:
        req.state = ReqState.FINISHED
        self.running.remove(req.req_id)
        self.session.finish(req.req_id)                     # VALVE-SESSION
        req.pages, req.lease = [], None

    # ------------------------------------------------------------------
    # Cancellation (client disconnect / batch-job abort)
    # ------------------------------------------------------------------
    def cancel(self, req_id: str) -> bool:
        """Abandon a submitted request; returns False if unknown/terminal.

        A RUNNING/PREFILL request goes through the normal terminal bundle
        (``session.finish``).  A QUEUED request was never admitted; its only
        possible KV is a surviving prefix kept across an invalidation, and
        releasing the lease drops the route with it."""
        req = self.requests.get(req_id)
        if req is None or req.state in (ReqState.FINISHED,
                                        ReqState.CANCELLED):
            return False
        if req_id in self.queue:
            self.queue.remove(req_id)
            if req.lease is not None and not req.lease.released:
                req.lease.release()
            req.pages, req.lease = [], None
        else:
            self._finish(req)
        req.state = ReqState.CANCELLED
        self.stats.cancellations += 1
        return True

    # -- mixed prefill(+decode) dispatch -------------------------------------
    def _dispatch_mixed(self, batch: ScheduledBatch) -> None:
        """Execute one composed dispatch: the prefill rows through the
        chunked-prefill entry (one fixed (max_batch x chunk) call), the
        piggybacked decode rows through the decode entry (one fixed
        (max_batch,) call), both inside one Valve iteration."""
        # prefill rows re-read context token VALUES, so lazily-held device
        # tokens must land first; the newest-output row map dies with this
        # dispatch (the decode rows below rebuild it)
        self.flush_tokens()
        self._prev_rows = {}
        m = self._mix
        m['toks'].fill(0)
        m['poss'].fill(0)
        m['pids'].fill(QUARANTINE_PAGE)
        m['offs'].fill(0)
        m['pts'].fill(QUARANTINE_PAGE)
        m['kv_len'].fill(1)        # padding rows attend 1 quarantine slot
        m['last_idx'].fill(0)
        row = 0
        for ps in batch.prefill:
            req = self.requests[ps.req_id]
            lo, hi = ps.start, ps.start + ps.length
            pos = np.arange(lo, hi)
            m['toks'][row, :ps.length] = req.context[lo:hi]
            m['poss'][row, :ps.length] = pos
            m['poss'][row, ps.length:] = hi - 1
            pt = self._fill_page_table(m['pts'][row], req)
            m['pids'][row, :ps.length] = pt[pos // self.pg]
            m['offs'][row, :ps.length] = pos % self.pg
            m['kv_len'][row] = hi
            m['last_idx'][row] = ps.length - 1
            row += 1
        mb = {
            'tokens': self._put(m['toks']),
            'positions': self._put(m['poss']),
            'page_table': self._put(m['pts']),
            'page_ids': self._put(m['pids']),
            'offsets': self._put(m['offs']),
            'kv_len': self._put(m['kv_len']),
            'last_idx': self._put(m['last_idx']),
        }
        db = self._decode_inputs(batch.decode) if batch.decode else None
        self.session.iteration_start()                      # VALVE-SESSION
        self.cache, logits = self.model.prefill_chunk_fn(
            self.params, self.cache, mb)
        out = self._decode_call(db) if db is not None else None
        self.session.iteration_end()                        # VALVE-SESSION
        self.stats.dispatches += 1
        self.stats.mixed_dispatches += 1
        self.stats.prefill_chunks += len(batch.prefill)
        if batch.decode:
            self.stats.decode_iterations += 1
        new = self._sample(logits).tolist()
        row = 0
        for ps in batch.prefill:
            req = self.requests[ps.req_id]
            req.n_prefilled = ps.start + ps.length
            if req.lease is not None:   # fill fact -> prefix publication
                req.lease.note_filled(req.n_prefilled)
            if req.n_prefilled == len(req.context):
                req.state = ReqState.RUNNING
                # the final chunk's scores predict the token after the
                # context -- the first token on a fresh prefill, the resume
                # token after an invalidation recompute
                self._append_token(req, new[row])
            row += 1
        if out is not None:
            self._decode_tokens(batch.decode, out)

    # -- pure decode dispatch -------------------------------------------------
    def _dispatch_decode(self, slots: List[DecodeSlot]) -> None:
        """Decode-only iteration through the paged-attention path.

        With ``fused_sampling`` the dispatch returns sampled tokens, not
        scores: each row's next-token input is read on the device from the
        previous dispatch's output (``use_prev``/``src`` feed), and the new
        tokens are recorded as placeholders resolved lazily by
        :meth:`flush_tokens` -- no per-step device->host sync."""
        db = self._decode_inputs(slots)
        self.session.iteration_start()                      # VALVE-SESSION
        out = self._decode_call(db)
        self.session.iteration_end()                        # VALVE-SESSION
        self.stats.dispatches += 1
        self.stats.decode_iterations += 1
        self._decode_tokens(slots, out)

    def _decode_inputs(self, slots: List[DecodeSlot]) -> Dict:
        """Stage the decode entry's batch for ``slots`` (rows in order)."""
        fused = self.cfg.fused_sampling
        if fused and any(ds.req_id in self._pending_rids
                         and ds.req_id not in self._prev_rows
                         for ds in slots):
            # a slot's pending token predates the newest device tensor (the
            # request sat out a step): resolve to host values once
            self.flush_tokens()
        d = self._dec
        d['toks'].fill(0)
        d['poss'].fill(0)
        d['pts'].fill(QUARANTINE_PAGE)
        d['use_prev'].fill(0)
        d['src'].fill(0)
        for i, ds in enumerate(slots):
            req = self.requests[ds.req_id]
            if fused and ds.req_id in self._pending_rids:
                d['use_prev'][i] = 1
                d['src'][i] = self._prev_rows[ds.req_id]
            else:
                d['toks'][i] = req.context[-1]
            d['poss'][i] = len(req.context) - 1
            self._fill_page_table(d['pts'][i], req)
        # padded slots write into quarantine (page 0) -- harmless by design.
        # Staging cache: the page tables -- and the shared-run structure
        # derived from (tables, length//pg) -- only change when a page is
        # appended, remapped, or the batch recomposes, so the staged device
        # tensors are reused between changes.
        st = self._stage
        key = (d['pts'].tobytes(), ((d['poss'] + 1) // self.pg).tobytes())
        if st.get('key') != key:
            st['key'] = key
            st['pts'] = self._put(d['pts'])
            st['shared'] = None
            if self.cfg.prefix_shared_attention:
                runs = build_shared_runs(d['pts'], d['poss'] + 1, self.pg)
                if runs['n_slots']:
                    # each shared physical page is read once per batch; the
                    # saving is (participants - 1) reads per slot
                    st['saved'] = int(runs['mask'].sum()) - runs['n_slots']
                    # bucket the slot axis to the next power of two, as the
                    # reference does (it bounds recompiles there; here it
                    # keeps the shared pass's padded slots few)
                    cap = 1
                    while cap < runs['n_slots']:
                        cap <<= 1
                    st['shared'] = {
                        'pages': self._put(runs['pages'][:cap]),
                        'pos': self._put(runs['pos'][:cap]),
                        'mask': self._put(runs['mask'][:, :cap]),
                        'tail_pt': self._put(runs['tail_pt']),
                        'start': self._put(runs['start'])}
        db = {'positions': self._put(d['poss']), 'page_table': st['pts']}
        if st.get('shared') is not None:
            self.stats.shared_page_reads_saved += st['saved']
            db['shared'] = st['shared']
        if fused:
            # steady-state decode feeds every row from the previous device
            # output, so (tokens, use_prev, src) are byte-stable -- restage
            # only when a row resolves to host values or rows move
            fkey = (d['toks'].tobytes(), d['use_prev'].tobytes(),
                    d['src'].tobytes())
            if st.get('fkey') != fkey:
                st['fkey'] = fkey
                st['toks'] = self._put(d['toks'])
                st['use_prev'] = self._put(d['use_prev'])
                st['src'] = self._put(d['src']).long()
            db['tokens'] = torch.where(st['use_prev'] > 0,
                                       self._prev_tokens[st['src']],
                                       st['toks'])
            if self.cfg.temperature > 0:
                db['seed'] = ((self.cfg.seed * 2654435761
                               + next(self._seed_ctr)) & 0x7FFFFFFF)
        else:
            db['tokens'] = self._put(d['toks'])
        return db

    def _decode_call(self, db: Dict):
        """The decode entry on a staged batch: (B,) sampled tokens on the
        device (fused) or (B, V) scores."""
        if self.cfg.fused_sampling:
            self.cache, out = self.model.decode_sample_fn(
                self.params, self.cache, db, use_kernel=self._use_kernel,
                temperature=float(self.cfg.temperature))
        else:
            self.cache, out = self.model.decode_fn(
                self.params, self.cache, db, use_kernel=self._use_kernel)
        return out

    def _decode_tokens(self, slots: List[DecodeSlot], out) -> None:
        """Record the decode entry's output as each slot's next token."""
        if not self.cfg.fused_sampling:
            new = self._sample(out).tolist()
            for i, ds in enumerate(slots):
                req = self.requests[ds.req_id]
                req.decode_steps += 1
                self._append_token(req, new[i])
            return
        records: List[tuple] = []
        self._prev_tokens, self._prev_rows = out, {}
        for i, ds in enumerate(slots):
            req = self.requests[ds.req_id]
            req.decode_steps += 1
            self._prev_rows[ds.req_id] = i
            self._append_pending(req, i, records)
        self._pending.append((out, records))
        self._pending_rids.update(r[0] for r in records)
        if self.cfg.eos_token is not None:
            # the stop check needs token values -- fetch every step (the
            # documented fused-path fallback for eos-terminated serving)
            self.flush_tokens()
            for ds in slots:
                req = self.requests[ds.req_id]
                if (req.state == ReqState.RUNNING and req.generated
                        and req.generated[-1] == self.cfg.eos_token):
                    self._finish(req)

    def _sample(self, logits):
        return sample(logits, temperature=self.cfg.temperature,
                      generator=self._gen)

    def _append_pending(self, req: Request, row: int,
                        records: List[tuple]) -> None:
        """Fused-path append: the sampled value is still on the device, so a
        placeholder lands in ``generated`` (patched by flush_tokens) while
        every count-based fact -- fill progress, timestamps, length-based
        finish -- is recorded eagerly (none of it reads the value)."""
        req.generated.append(-1)
        records.append((req.req_id, len(req.generated) - 1, row))
        if req.lease is not None:
            req.lease.note_filled(len(req.context) - 1)
        now = self.clock.now()
        if req.t_first_token is None:
            req.t_first_token = now
        req.t_last_token = now
        self.stats.tokens_generated += 1
        if len(req.generated) >= req.max_new_tokens:
            self._finish(req)

    def flush_tokens(self) -> None:
        """Resolve lazily-held sampled tokens to host ints (fused path).

        Anything that reads token VALUES -- stream emission, prefill
        re-reads after invalidation, eos checks -- calls this first.  No-op
        when nothing is pending, so callers may invoke it unconditionally."""
        if not self._pending:
            return
        for arr, records in self._pending:
            vals = arr.tolist()                 # the device->host sync
            for rid, gi, row in records:
                self.requests[rid].generated[gi] = vals[row]
        self._pending.clear()
        self._pending_rids.clear()
        self.stats.token_flushes += 1

    def _append_token(self, req: Request, tok: int) -> None:
        req.generated.append(tok)
        if req.lease is not None:
            # KV is materialized for every context token but the new one
            req.lease.note_filled(len(req.context) - 1)
        now = self.clock.now()
        if req.t_first_token is None:
            req.t_first_token = now
        req.t_last_token = now
        self.stats.tokens_generated += 1
        done = (len(req.generated) >= req.max_new_tokens
                or (self.cfg.eos_token is not None
                    and tok == self.cfg.eos_token))
        if done:
            self._finish(req)

    # ------------------------------------------------------------------
    def step(self) -> bool:
        """One scheduling step; returns True if any dispatch happened."""
        if self._gated():
            self.stats.blocked_dispatches += 1
            return False
        self.sched.admit(self.requests, self._try_admit, self._spill)
        self._resume_as_decode()
        batch = self.sched.compose(self.requests)
        self.stats.steps += 1
        if batch.empty:
            return False
        if batch.prefill:
            self._dispatch_mixed(batch)
        else:
            self._dispatch_decode(batch.decode)
        return True

    def _resume_as_decode(self) -> None:
        """A re-admitted request whose KV covers its whole context but the
        last sampled token (a lease migrated whole) takes a decode slot,
        not a one-token prefill chunk: the token it predicts next comes out
        of the decode entry, as it would have had the request not moved."""
        for rid in self.running:
            req = self.requests[rid]
            if (req.state is ReqState.PREFILL and req.generated
                    and req.n_prefilled == len(req.context) - 1):
                req.state = ReqState.RUNNING

    def run_to_completion(self, max_steps: int = 100_000) -> None:
        for _ in range(max_steps):
            if not (self.queue or self.running):
                return
            if not self.step() and self._gated():
                raise RuntimeError('offline engine gated; drive via runtime')
        raise RuntimeError('run_to_completion exceeded max_steps')

    # ------------------------------------------------------------------
    @property
    def finished(self) -> List[Request]:
        return [r for r in self.requests.values()
                if r.state == ReqState.FINISHED]

    def output_tokens(self, rid: str) -> List[int]:
        self.flush_tokens()
        return list(self.requests[rid].generated)
