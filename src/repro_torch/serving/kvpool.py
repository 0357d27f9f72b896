"""Global paged KV pool with equal-size reclamation handles (paper §5).

Physical layout (mirrors the JAX pool arrays the engine owns):

    page 0                      — the QUARANTINE page (always mapped)
    pages 1 … n_handles·pph     — handle h owns pages [1+h·pph, 1+(h+1)·pph)

Pages are allocated from a single free list shared by all requests, so a
request's pages scatter across handles (the fragmentation the paper's
Algorithm 1 exploits).  Handles are either *online-reserved* (the MIAD
headroom H) or offline-usable.  Reclaiming a handle remaps every mapped page
in it to quarantine and transfers the handle to the reserved set — no page is
ever unmapped, so no access can fault.

Since the Memory-plane API v1 (``repro_torch.core.memory``), this class is the
**physical backend**: it tracks page ownership per *owner id* (a lease id or
an internal shared-prefix block id) and knows nothing about refcounts,
prefix sharing or surviving prefixes — those live in
:class:`~repro_torch.core.memory.MemoryPlane`.  Owner-granular partial frees
(:meth:`free_pages`) and in-place growth (:meth:`alloc_more`) exist for the
plane; ``reclaim_handles(free_survivors=False)`` leaves a victim's
untouched pages mapped so the plane can keep the surviving prefix.

Occupancy queries (``free_pages_for`` / ``used_pages_for`` /
``online_used_handles``) are O(1) incremental counters — they run every
scheduler tick; ``check_invariants`` cross-checks them against full scans.
"""
from __future__ import annotations

import itertools
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set

QUARANTINE_PAGE = 0

# default pool names ('pool0', 'pool1', …) — stable within a process so
# PageMigration events can name src/dst pools without explicit naming
_POOL_SEQ = itertools.count()


@dataclass
class PoolStats:
    allocs: int = 0
    frees: int = 0
    reclaims: int = 0
    reclaimed_pages: int = 0
    alloc_failures: int = 0


class KVPool:
    def __init__(self, n_handles: int, pages_per_handle: int,
                 page_size: int = 16, reserved_handles: int = 1,
                 name: Optional[str] = None):
        assert n_handles >= 1 and pages_per_handle >= 1
        self.n_handles = n_handles
        self.pph = pages_per_handle
        self.page_size = page_size
        self.n_pages = 1 + n_handles * pages_per_handle
        self.name = name or f'pool{next(_POOL_SEQ)}'
        # optional typed event stream (repro_torch.core.events.EventBus): when a
        # runtime/orchestrator attaches one, transfer_pages publishes a
        # PageMigration per ownership move so transfers are observable
        self.bus = None

        # page → owning id (None = free); page 0 is never owned
        self.owner: List[Optional[str]] = [None] * self.n_pages
        # owner id → its mapped pages, in allocation order
        self.pages_of: Dict[str, List[int]] = {}
        # owner id → 'online' | 'offline'
        self.klass_of: Dict[str, str] = {}
        # free pages per handle (deque for O(1) pop)
        self.free_in_handle: List[deque] = [
            deque(self._handle_pages(h)) for h in range(n_handles)]
        # MIAD-reserved handles (online headroom), insertion-ordered for FIFO
        self.reserved: "OrderedDict[int, float]" = OrderedDict()
        for h in range(min(reserved_handles, n_handles)):
            self.reserved[h] = 0.0
        self.stats = PoolStats()
        # -- incremental occupancy counters (the per-tick hot path) --------
        # free pages split by reservation status; mapped pages per handle;
        # used pages per klass; #reserved handles with ≥1 mapped page
        self._free_reserved = sum(
            len(self.free_in_handle[h]) for h in self.reserved)
        self._free_offline = (n_handles * pages_per_handle
                              - self._free_reserved)
        self._mapped_in_handle: List[int] = [0] * n_handles
        self._used_by_klass: Dict[str, int] = {'online': 0, 'offline': 0}
        self._used_reserved_handles = 0

    # ------------------------------------------------------------- layout
    def _handle_pages(self, h: int) -> range:
        return range(1 + h * self.pph, 1 + (h + 1) * self.pph)

    def handle_of(self, page: int) -> int:
        assert page >= 1, 'quarantine page belongs to no handle'
        return (page - 1) // self.pph

    def reqs_of_handle(self, h: int) -> Set[str]:
        return {self.owner[p] for p in self._handle_pages(h)
                if self.owner[p] is not None}

    # ------------------------------------------------- counter transitions
    def _note_free(self, h: int, delta: int) -> None:
        if h in self.reserved:
            self._free_reserved += delta
        else:
            self._free_offline += delta

    def _note_mapped(self, h: int, delta: int) -> None:
        before = self._mapped_in_handle[h]
        self._mapped_in_handle[h] = before + delta
        if h in self.reserved:
            if before == 0 and delta > 0:
                self._used_reserved_handles += 1
            elif before + delta == 0 and before > 0:
                self._used_reserved_handles -= 1

    # ------------------------------------------------------------ queries
    def pages_of_request(self, req_id: str) -> List[int]:
        """Copy of an owner's mapped pages, in allocation order."""
        return list(self.pages_of.get(req_id, ()))

    def handles_of_request(self, req_id: str) -> List[int]:
        """Sorted handles holding ≥1 page of ``req_id`` (the handles whose
        reclamation would invalidate it — orchestrator/test introspection)."""
        return sorted({self.handle_of(p)
                       for p in self.pages_of.get(req_id, ())})

    def request_ids(self, klass: Optional[str] = None) -> List[str]:
        """Live owner ids holding pages, optionally filtered by class —
        includes the memory plane's internal shared-prefix block ids."""
        return [r for r in self.pages_of
                if klass is None or self.klass_of.get(r) == klass]

    def free_pages_for(self, klass: str) -> int:
        return (self._free_reserved if klass == 'online'
                else self._free_offline)

    def used_pages_for(self, klass: str) -> int:
        return self._used_by_klass.get(klass, 0)

    def online_used_handles(self) -> int:
        """Reserved handles with ≥1 mapped page (MIAD pressure signal)."""
        return self._used_reserved_handles

    # ---------------------------------------------------------- alloc/free
    def _take_pages(self, req_id: str, n: int,
                    handles: Sequence[int]) -> Optional[List[int]]:
        if sum(len(self.free_in_handle[h]) for h in handles) < n:
            self.stats.alloc_failures += 1
            return None
        got: List[int] = []
        for h in handles:
            fl = self.free_in_handle[h]
            take = min(len(fl), n - len(got))
            for _ in range(take):
                p = fl.popleft()
                self.owner[p] = req_id
                got.append(p)
            if take:
                self._note_free(h, -take)
                self._note_mapped(h, take)
            if len(got) == n:
                break
        return got

    def _klass_handles(self, klass: str) -> List[int]:
        assert klass in ('online', 'offline')
        if klass == 'online':
            return list(self.reserved.keys())
        return [h for h in range(self.n_handles) if h not in self.reserved]

    def alloc(self, req_id: str, n: int, klass: str = 'offline'
              ) -> Optional[List[int]]:
        """Allocate ``n`` pages for a NEW owner ``req_id``; None if
        insufficient."""
        # ids are node-global: a second alloc under a live id means two
        # engines minted colliding request ids (their pages would merge)
        assert req_id not in self.pages_of, \
            f'request id {req_id!r} already holds pages'
        got = self._take_pages(req_id, n, self._klass_handles(klass))
        if got is None:
            return None
        self.pages_of[req_id] = got
        self.klass_of[req_id] = klass
        self._used_by_klass[klass] += n
        self.stats.allocs += 1
        return got

    def alloc_more(self, req_id: str, n: int) -> Optional[List[int]]:
        """Grow an EXISTING owner by ``n`` pages (lease extension); the
        klass is the one recorded at first allocation."""
        assert req_id in self.pages_of, f'{req_id!r} holds no pages'
        klass = self.klass_of[req_id]
        got = self._take_pages(req_id, n, self._klass_handles(klass))
        if got is None:
            return None
        self.pages_of[req_id].extend(got)
        self._used_by_klass[klass] += n
        self.stats.allocs += 1
        return got

    def free(self, req_id: str) -> int:
        """Release every page of ``req_id``; returns #pages freed.  A free
        for an id that holds no pages is a NO-OP and does not count as a
        lifecycle event (``stats.frees`` unchanged)."""
        pages = self.pages_of.pop(req_id, None)
        if pages is None:
            self.klass_of.pop(req_id, None)
            return 0
        klass = self.klass_of.pop(req_id, None)
        released = 0
        for p in pages:
            if self.owner[p] == req_id:
                self._release_page(p)
                released += 1
        if klass is not None:
            self._used_by_klass[klass] -= released
        self.stats.frees += 1
        return len(pages)

    def free_pages(self, req_id: str, pages: Sequence[int]) -> int:
        """Release a SUBSET of an owner's pages (memory-plane partial free:
        surviving-prefix tails, per-page refcount drops).  Single pass over
        the owner's list — callers batch drops per owner so a request
        completion stays O(pages).  Does not count as a whole-owner
        ``stats.frees`` lifecycle event."""
        held = self.pages_of.get(req_id)
        if not held:
            return 0
        drop = set(pages)
        kept: List[int] = []
        freed = 0
        for p in held:
            if p in drop:
                assert self.owner[p] == req_id, (p, self.owner[p], req_id)
                self._release_page(p)
                freed += 1
            else:
                kept.append(p)
        if freed:
            self._used_by_klass[self.klass_of[req_id]] -= freed
        if kept:
            self.pages_of[req_id] = kept
        else:
            del self.pages_of[req_id]
            self.klass_of.pop(req_id, None)
        return freed

    def transfer_pages(self, old_owner: str, pages: Sequence[int],
                       new_owner: str,
                       dst_pool: Optional['KVPool'] = None
                       ) -> Optional[List[int]]:
        """Move pages from one owner id to another.

        Intra-pool (``dst_pool`` None or self): pure ownership re-key
        (memory-plane use: shared pages outliving their creating lease
        move to an internal block id so the request id can be
        re-admitted).  Klass-preserving; no page moves physically; returns
        the (unchanged) page ids.

        Cross-pool (``dst_pool`` another KVPool): the Valve rescue path —
        allocate the same count in ``dst_pool`` under ``new_owner``
        (klass-preserving), free the source pages here, and return the
        NEW page ids in the destination pool (page ids are pool-local).
        Returns None — with the source untouched — if the destination
        cannot fit the transfer.  Either pool with a bus attached
        publishes a typed PageMigration event.
        """
        if dst_pool is not None and dst_pool is not self:
            return self._transfer_cross_pool(old_owner, list(pages),
                                             new_owner, dst_pool)
        held = self.pages_of[old_owner]
        klass = self.klass_of[old_owner]
        moved = 0
        for p in pages:
            assert self.owner[p] == old_owner, (p, self.owner[p], old_owner)
            self.owner[p] = new_owner
            held.remove(p)
            self.pages_of.setdefault(new_owner, []).append(p)
            moved += 1
        if moved:
            self.klass_of.setdefault(new_owner, klass)
            assert self.klass_of[new_owner] == klass
        if not held:
            del self.pages_of[old_owner]
            self.klass_of.pop(old_owner, None)
        if moved and self.bus is not None:
            self._publish_migration(new_owner, pages)
        return list(pages)

    def _transfer_cross_pool(self, old_owner: str, pages: List[int],
                             new_owner: str, dst: 'KVPool'
                             ) -> Optional[List[int]]:
        klass = self.klass_of[old_owner]
        for p in pages:
            assert self.owner[p] == old_owner, (p, self.owner[p], old_owner)
        if new_owner in dst.pages_of:
            got = dst.alloc_more(new_owner, len(pages))
        else:
            got = dst.alloc(new_owner, len(pages), klass)
        if got is None:
            return None             # destination full — source untouched
        self.free_pages(old_owner, pages)
        for bus in {id(self.bus): self.bus, id(dst.bus): dst.bus}.values():
            if bus is not None:
                from repro_torch.core.events import PageMigration
                bus.publish(PageMigration, owner=new_owner,
                            n_pages=len(pages), src_pool=self.name,
                            dst_pool=dst.name, cross_pool=True,
                            src_pages=tuple(pages), dst_pages=tuple(got))
        return got

    def _publish_migration(self, owner: str, pages: Sequence[int]) -> None:
        from repro_torch.core.events import PageMigration
        self.bus.publish(PageMigration, owner=owner, n_pages=len(pages),
                         src_pool=self.name, dst_pool=self.name,
                         cross_pool=False, src_pages=tuple(pages),
                         dst_pages=tuple(pages))

    def _release_page(self, p: int) -> None:
        self.owner[p] = None
        h = self.handle_of(p)
        self.free_in_handle[h].append(p)
        self._note_free(h, 1)
        self._note_mapped(h, -1)

    # ---------------------------------------------------------- MIAD hooks
    def offline_handles(self) -> List[int]:
        return [h for h in range(self.n_handles) if h not in self.reserved]

    def empty_offline_handles(self) -> List[int]:
        return [h for h in self.offline_handles()
                if len(self.free_in_handle[h]) == self.pph]

    def reserve_handle(self, h: int, now: float = 0.0) -> None:
        """Move a (fully-free) handle into the online reservation."""
        assert h not in self.reserved
        assert len(self.free_in_handle[h]) == self.pph, \
            'reserve requires a reclaimed/empty handle'
        self._free_offline -= self.pph
        self.reserved[h] = now
        self._free_reserved += self.pph

    def release_reserved_handle(self) -> Optional[int]:
        """MIAD additive decrease: return the emptiest reserved handle to
        offline use (never one holding online pages)."""
        for h in list(self.reserved.keys()):
            if len(self.free_in_handle[h]) == self.pph:
                del self.reserved[h]
                self._free_reserved -= self.pph
                self._free_offline += self.pph
                return h
        return None

    # ---------------------------------------------------------- reclamation
    def reclaim_handles(self, handles: Sequence[int], now: float = 0.0,
                        free_survivors: bool = True) -> Dict[str, List[int]]:
        """Remap every mapped page of ``handles`` to quarantine and move the
        handles to the online reservation.

        Returns {owner id: [its invalidated page ids]} — the paper's
        "invalidated page IDs exposed to the framework".  The caller
        (ValveRuntime) must have disabled offline compute first; this class
        only records, the runtime asserts the ordering invariant.

        ``free_survivors=True`` (the legacy whole-request semantics) also
        releases every *untouched* page of each invalidated owner — the
        request restarts from token 0.  The memory plane passes ``False``
        and keeps each lease's surviving prefix mapped, freeing only the
        recompute tail itself (partial invalidation).
        """
        invalidated: Dict[str, List[int]] = {}
        for h in handles:
            assert h not in self.reserved, 'cannot reclaim a reserved handle'
            for p in self._handle_pages(h):
                r = self.owner[p]
                if r is not None:
                    invalidated.setdefault(r, []).append(p)
                    self.owner[p] = None
                    self._note_mapped(h, -1)
                    self.stats.reclaimed_pages += 1
            self._note_free(h, self.pph - len(self.free_in_handle[h]))
            self.free_in_handle[h] = deque(self._handle_pages(h))
            self.reserve_handle(h, now)
        # drop remapped pages from owner lists in ONE pass per owner (a
        # per-page list.remove would be quadratic under reclamation bursts)
        for r, pages in invalidated.items():
            drop = set(pages)
            kept = [p for p in self.pages_of[r] if p not in drop]
            self._used_by_klass[self.klass_of[r]] -= len(pages)
            if kept:
                self.pages_of[r] = kept
                if free_survivors:
                    # legacy semantics: an invalidated request loses *all*
                    # its KV (restarts from its prompt+generated tokens)
                    self.free(r)
            else:
                del self.pages_of[r]
                self.klass_of.pop(r, None)
        self.stats.reclaims += 1
        return invalidated

    # ---------------------------------------------------------- invariants
    def check_invariants(self) -> None:
        seen: Set[int] = set()
        for r, pages in self.pages_of.items():
            assert pages, f'owner {r!r} with empty page list'
            for p in pages:
                assert p != QUARANTINE_PAGE, 'live request maps quarantine'
                assert self.owner[p] == r, (r, p, self.owner[p])
                assert p not in seen, f'page {p} double-owned'
                seen.add(p)
        for h in range(self.n_handles):
            for p in self.free_in_handle[h]:
                assert self.owner[p] is None
                assert p not in seen, f'page {p} both free and owned'
        # incremental counters must agree with a full scan
        free_res = sum(len(self.free_in_handle[h]) for h in self.reserved)
        free_off = sum(len(self.free_in_handle[h])
                       for h in range(self.n_handles)
                       if h not in self.reserved)
        assert self._free_reserved == free_res, \
            (self._free_reserved, free_res)
        assert self._free_offline == free_off, \
            (self._free_offline, free_off)
        for h in range(self.n_handles):
            mapped = sum(1 for p in self._handle_pages(h)
                         if self.owner[p] is not None)
            assert self._mapped_in_handle[h] == mapped, \
                (h, self._mapped_in_handle[h], mapped)
        for klass in ('online', 'offline'):
            used = sum(len(v) for r, v in self.pages_of.items()
                       if self.klass_of[r] == klass)
            assert self._used_by_klass[klass] == used, \
                (klass, self._used_by_klass[klass], used)
        used_res = sum(1 for h in self.reserved
                       if any(self.owner[p] is not None
                              for p in self._handle_pages(h)))
        assert self._used_reserved_handles == used_res, \
            (self._used_reserved_handles, used_res)
