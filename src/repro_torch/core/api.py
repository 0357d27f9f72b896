"""Valve control-plane API v1 — class-scoped sessions.

The paper's deployability claim (Table 1) is a *narrow integration
surface*: one driver line plus a < 20-LOC framework patch.  Earlier
versions grew three ad-hoc slices of that surface — klass strings passed to
``alloc_online``/``alloc_offline``, a per-request ``bind_invalidation``
route table engines had to maintain by hand, and an engine-instance id
discriminator to keep same-class engines from colliding.  A
:class:`ValveSession` replaces all three: it is *the* handle a serving
framework holds.

    session = runtime.open_session(klass='offline', name='batch-7b',
                                   on_invalidate=engine.on_pages_invalidated)
    rid = session.new_request_id()
    lease = session.admit(rid, n_pages, prompt)  # notify + lease + route
    session.iteration_start(); ...; session.iteration_end()
    if session.may_dispatch(): ...
    session.finish(rid)                     # release lease + route + notify

Because allocation goes *through* the session, the runtime always knows
which session owns a request id: invalidation delivery routes by ownership
(route lifetime == lease lifetime, so no terminal path can leak a route
entry), same-class sessions cannot mis-route each other's callbacks, and
request ids are minted under the session's unique name (no discriminator).

**Memory-plane API v1** (``docs/API.md`` §memory): ``admit`` returns a
:class:`~repro_torch.core.memory.KVLease` — an opaque refcounted handle that
owns page lifetime (``extend``/``fork``/``release``), shares page-aligned
prompt prefixes copy-on-write (pass ``prompt=`` to opt in; the share scope
is the session name, so different models never alias KV), and survives
partial invalidation: re-admitting a live id *extends* the lease, keeping
the surviving prefix, and ``lease.resume_tokens`` is where prefill
resumes.  The lease iterates as the legacy page-id list.

:class:`PoolSession` gives a bare :class:`~repro_torch.serving.kvpool.KVPool`
the same shape (no runtime, no gating, no events — but the same
pool-global memory plane) so the engine holds one session unconditionally.

``api_surface()`` renders the public control-plane API as stable text;
the port's test holds it to the reference package's snapshot
(``tests/api_surface.txt``) with the package name mapped.
"""
from __future__ import annotations

import inspect
import itertools
from typing import Dict, List, Optional, Sequence

from repro_torch.core.memory import KVLease, MemoryPlane
from repro_torch.core.reclamation import InvalidationCallback

__all__ = ['ValveSession', 'PoolSession', 'api_surface']

# PoolSession keeps the engine-instance discriminator the runtime sessions
# no longer need: without a runtime there is no node-wide owner registry,
# so uniqueness of minted ids falls back to a process-global sequence.
_POOL_SESSION_SEQ = itertools.count()


class ValveSession:
    """A class-scoped handle on one :class:`ValveRuntime`.

    One session per engine (or per framework integration).  The session
    owns the engine's entire control-plane interaction: request-id minting,
    admission (lifecycle notification + allocation), iteration
    notifications, the dispatch-gate check, per-session invalidation
    delivery, and terminal release.  Constructed only by
    ``ValveRuntime.open_session`` — the runtime registers the session under
    a unique name and routes invalidations to it by request ownership.
    """

    def __init__(self, runtime, klass: str, name: str,
                 on_invalidate: Optional[InvalidationCallback] = None):
        assert klass in ('online', 'offline'), klass
        self.runtime = runtime
        self.klass = klass
        self.name = name
        self.on_invalidate = on_invalidate
        self.closed = False
        self._ids = itertools.count()

    # -- request ids --------------------------------------------------------
    def new_request_id(self) -> str:
        """Mint a node-unique request id (session names are unique per
        runtime, so same-class sessions cannot collide)."""
        return f'{self.name}-{next(self._ids)}'

    # -- memory plane -------------------------------------------------------
    def alloc(self, req_id: str, n_pages: int,
              prompt: Optional[Sequence[int]] = None) -> Optional[KVLease]:
        """Lease ``n_pages`` pages for ``req_id`` in this session's class;
        on success the session becomes the request's invalidation route.

        A live ``req_id`` (a partially-invalidated request re-admitting) is
        *extended* to the target, keeping its surviving prefix.  With
        ``prompt``, page-aligned prompt prefixes already materialized under
        this session are attached copy-on-write instead of re-allocated —
        ``lease.resume_tokens`` tells the engine where prefill starts."""
        assert not self.closed, f'session {self.name} is closed'
        return self.runtime._session_alloc(self, req_id, n_pages,
                                           prompt=prompt)

    def free(self, req_id: str) -> None:
        """Release the request's pages and its invalidation route."""
        self.runtime._session_free(self, req_id)

    # -- lifecycle notifications (no-ops for offline sessions) --------------
    def request_start(self, req_id: str) -> None:
        if self.klass == 'online':
            self.runtime.on_online_request_start(req_id)

    def request_end(self, req_id: str) -> None:
        if self.klass == 'online':
            self.runtime.on_online_request_end(req_id)

    def iteration_start(self) -> None:
        if self.klass == 'online':
            self.runtime.on_online_iteration_start()

    def iteration_end(self) -> None:
        if self.klass == 'online':
            self.runtime.on_online_iteration_end()

    # -- bundles (what shrinks the framework patch) -------------------------
    def admit(self, req_id: str, n_pages: int,
              prompt: Optional[Sequence[int]] = None) -> Optional[KVLease]:
        """Admission bundle: lifecycle start, then the lease; a failed
        allocation rolls the lifecycle notification back.  The start fires
        *before* the allocation so the request's arrival closes the gates
        before any reclamation it triggers (one preemption covers both)."""
        self.request_start(req_id)
        lease = self.alloc(req_id, n_pages, prompt)
        if lease is None:
            self.request_end(req_id)
        return lease

    def finish(self, req_id: str) -> None:
        """Terminal bundle: free pages + release route + lifecycle end."""
        self.free(req_id)
        self.request_end(req_id)

    # -- compute plane ------------------------------------------------------
    def may_dispatch(self) -> bool:
        """Online sessions always dispatch; offline sessions only while the
        node's gates are open (the preemption mechanism, paper §4)."""
        if self.klass == 'online':
            return True
        return self.runtime.offline_may_dispatch()

    # -- teardown -----------------------------------------------------------
    def owned_requests(self) -> List[str]:
        """Request ids currently routed to this session (hold live pages)."""
        return self.runtime._session_owned(self)

    def close(self) -> None:
        """Release every owned request and deregister the session."""
        for rid in self.owned_requests():
            self.finish(rid)
        self.closed = True
        self.runtime._session_closed(self)

    def __repr__(self) -> str:
        return f'ValveSession({self.name!r}, klass={self.klass!r})'


class PoolSession:
    """Session-shaped adapter over a bare :class:`KVPool` (no runtime).

    Standalone engines (tests, the serving-plane benchmark drain) keep the
    exact session call sites — lifecycle notifications and the gate check
    degenerate to no-ops; allocation goes through the pool's memory plane,
    so leases, prefix sharing and partial invalidation behave identically.
    """

    runtime = None

    def __init__(self, pool, klass: str, name: Optional[str] = None):
        assert klass in ('online', 'offline'), klass
        self.pool = pool
        self.plane = MemoryPlane.of(pool)
        self.klass = klass
        self.name = name or f'{klass}{next(_POOL_SESSION_SEQ)}'
        self._ids = itertools.count()

    def new_request_id(self) -> str:
        return f'{self.name}-{next(self._ids)}'

    def alloc(self, req_id: str, n_pages: int,
              prompt: Optional[Sequence[int]] = None) -> Optional[KVLease]:
        return self.plane.admit(req_id, n_pages, self.klass,
                                prompt=prompt, scope=self.name)

    def free(self, req_id: str) -> None:
        self.plane.release_id(req_id)

    def request_start(self, req_id: str) -> None: ...
    def request_end(self, req_id: str) -> None: ...
    def iteration_start(self) -> None: ...
    def iteration_end(self) -> None: ...

    admit = alloc

    def finish(self, req_id: str) -> None:
        self.free(req_id)

    def may_dispatch(self) -> bool:
        return True

    def owned_requests(self) -> List[str]:
        # ids are minted as f'{name}-{n}': match the full name segment so
        # 'offline1' never claims 'offline10-...'
        return [r for r in self.plane.leases
                if r.startswith(self.name + '-')]

    def close(self) -> None: ...


# ---------------------------------------------------------------------------
# Public-API snapshot (tests/test_api_surface.py pins this text)
# ---------------------------------------------------------------------------

def _surface_of(obj, prefix: str) -> List[str]:
    lines = []
    for name, member in sorted(vars(obj).items()):
        if name.startswith('_'):
            continue
        if callable(member) and not inspect.isclass(member):
            try:
                sig = str(inspect.signature(member))
            except (TypeError, ValueError):
                sig = '(...)'
            lines.append(f'{prefix}.{name}{sig}')
        elif isinstance(member, property):
            lines.append(f'{prefix}.{name} [property]')
    return lines


def api_surface() -> List[str]:
    """Render the public control- and memory-plane API v1 as sorted
    signature lines."""
    from repro_torch.core import events as E
    from repro_torch.core import memory as M
    from repro_torch.core import telemetry as T
    from repro_torch.core.cluster.placement import (
        GlobalPlacementPolicy, GPUProfile, PlacementPolicy, TopologyModel)
    from repro_torch.core.cluster.scheduler import ClusterScheduler
    from repro_torch.core.runtime import ValveRuntime

    lines: List[str] = []
    for cls in (ValveSession, PoolSession, ValveRuntime, M.MemoryPlane,
                M.KVLease, E.EventBus, T.TelemetryRegistry,
                T.LatencySummary, ClusterScheduler, PlacementPolicy,
                GlobalPlacementPolicy, GPUProfile, TopologyModel):
        lines.append(f'{cls.__module__}.{cls.__name__}')
        lines += _surface_of(cls, f'  {cls.__name__}')
    lines.append(f'{M.LeaseInvalidation.__module__}.LeaseInvalidation'
                 f'({", ".join(M.LeaseInvalidation.__slots__)})')
    for ev in E.EVENT_TYPES:
        lines.append(f'{ev.__module__}.{ev.__name__}'
                     f'({", ".join(ev._fields)})')
    return lines


if __name__ == '__main__':
    # re-import under the canonical module name (running via -m makes this
    # file __main__, which would leak into the snapshot's qualnames)
    from repro_torch.core import api as _canonical
    print('\n'.join(_canonical.api_surface()))
