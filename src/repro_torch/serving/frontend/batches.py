"""Offline batch-job API — the offline plane as a product, not just backfill.

A **batch job** is a set of generation requests submitted together
(``POST /v1/batches``), executed on the node's OFFLINE engines, and
fetched as one result set when complete (submit → poll → fetch, the cloud
batch-API shape).  Jobs are first-class *preemptible* work: each item is a
plain offline-engine request, so admission goes through the engine's
:class:`~repro_torch.core.api.ValveSession` (``session.admit`` at schedule
time), dispatch obeys the Valve gates, and reclamation can invalidate and
resume items like any other offline work — the batch API adds bookkeeping,
never a second admission path.

Allocation is *lazy by construction*: ``submit`` only enqueues items into
engine FIFO queues; no KV page is leased until the scheduler admits an
item.  Cancelling a job whose items are still queued therefore provably
never allocates (pinned by ``tests/test_frontend.py``).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from repro_torch.serving.scheduler import ReqState

__all__ = ['BatchItem', 'BatchJob', 'BatchManager']

# job lifecycle: queued → in_progress → completed, or → cancelled
_TERMINAL = ('completed', 'cancelled')


@dataclass
class BatchItem:
    """One generation request inside a job."""
    index: int
    prompt: List[int]
    max_new_tokens: int
    req_id: Optional[str] = None
    engine: Optional[object] = None      # the owning offline Engine

    @property
    def request(self):
        return self.engine.requests[self.req_id]


@dataclass
class BatchJob:
    job_id: str
    items: List[BatchItem]
    created_at: float
    status: str = 'queued'
    completed_at: Optional[float] = None

    def counts(self) -> Dict[str, int]:
        c = {'total': len(self.items), 'queued': 0, 'in_progress': 0,
             'completed': 0, 'cancelled': 0}
        for it in self.items:
            st = it.request.state
            if st is ReqState.FINISHED:
                c['completed'] += 1
            elif st is ReqState.CANCELLED:
                c['cancelled'] += 1
            elif st is ReqState.WAITING and not it.request.pages:
                c['queued'] += 1
            else:
                c['in_progress'] += 1
        return c

    def to_dict(self) -> Dict[str, object]:
        return {
            'id': self.job_id,
            'object': 'batch',
            'status': self.status,
            'created_at': self.created_at,
            'completed_at': self.completed_at,
            'request_counts': self.counts(),
        }


class BatchManager:
    """Owns batch jobs over one node's offline engines (round-robin
    placement across heterogeneous engines, mirroring how the drain demos
    spread their backlog)."""

    def __init__(self, node):
        self.node = node
        self.jobs: Dict[str, BatchJob] = {}
        self._seq = itertools.count()
        self._rr = 0

    # ------------------------------------------------------------------
    def submit(self, requests: Sequence[dict]) -> BatchJob:
        """Create a job from ``[{prompt, max_tokens}, ...]`` and enqueue
        every item on an offline engine (allocation stays deferred until
        scheduler admission)."""
        offline = self.node.offline
        assert offline, 'node has no offline engines'
        assert requests, 'empty batch'
        items: List[BatchItem] = []
        for i, spec in enumerate(requests):
            prompt = list(map(int, spec['prompt']))
            max_new = int(spec.get('max_tokens', 16))
            eng = offline[self._rr % len(offline)]
            self._rr += 1
            assert len(prompt) + max_new <= eng.cfg.max_seq, \
                (len(prompt), max_new, eng.cfg.max_seq)
            items.append(BatchItem(i, prompt, max_new,
                                   req_id=eng.submit(prompt, max_new),
                                   engine=eng))
        job = BatchJob(f'batch-{next(self._seq)}', items,
                       created_at=self.node.clock.now())
        self.jobs[job.job_id] = job
        return job

    def get(self, job_id: str) -> Optional[BatchJob]:
        job = self.jobs.get(job_id)
        if job is not None:
            self._refresh(job)
        return job

    # ------------------------------------------------------------------
    def poll(self) -> None:
        """Advance every live job's status from its items' request states
        (called by the driver pump after each tick)."""
        for job in self.jobs.values():
            self._refresh(job)

    def _refresh(self, job: BatchJob) -> None:
        if job.status in _TERMINAL:
            return
        c = job.counts()
        if c['completed'] == c['total']:
            job.status = 'completed'
            job.completed_at = self.node.clock.now()
        elif c['queued'] < c['total']:
            job.status = 'in_progress'

    # ------------------------------------------------------------------
    def cancel(self, job_id: str) -> Optional[BatchJob]:
        """Cancel every unfinished item (engine releases whatever each
        item holds; queued items never allocated, so there is nothing to
        release).  Finished items keep their results."""
        job = self.jobs.get(job_id)
        if job is None:
            return None
        if job.status not in _TERMINAL:
            for it in job.items:
                it.engine.cancel(it.req_id)
            job.status = 'cancelled'
            job.completed_at = self.node.clock.now()
        return job

    def results(self, job_id: str) -> Optional[List[Dict[str, object]]]:
        """Per-item outputs, available once the job is terminal."""
        job = self.get(job_id)
        if job is None or job.status not in _TERMINAL:
            return None
        out = []
        for it in job.items:
            req = it.request
            out.append({
                'index': it.index,
                'status': ('completed' if req.state is ReqState.FINISHED
                           else 'cancelled'),
                'tokens': list(req.generated),
                'n_prompt_tokens': len(it.prompt),
                'engine': it.engine.mcfg.name,
            })
        return out
