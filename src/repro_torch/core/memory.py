"""Memory-plane API v1 — lease-based KV allocation (paper §5, ConServe/HyGen).

The physical pool (:class:`~repro_torch.serving.kvpool.KVPool`) deals in handles
and raw page ids; this module is the **logical** layer every consumer now
talks to.  A :class:`KVLease` is the opaque, refcounted handle a framework
holds for one request's KV:

    lease = plane.admit(rid, n_pages, klass='offline', prompt=tokens)
    lease.note_filled(n)        # KV materialized for tokens [0, n)
    lease.extend(k)             # grow (tail re-allocation after reclaim)
    child = lease.fork(rid2)    # CoW-share the filled prefix
    lease.release()             # drop refs; pages free at refcount zero

Three properties the raw pool could not express:

- **Refcounted prefix sharing** — page-aligned prompt prefixes are chained
  through a content-hash index (scoped per session, so different models
  never alias).  A later request with the same prompt prefix *attaches* the
  published pages instead of re-allocating and re-prefilling them; physical
  pages free only when their refcount reaches zero.  Writes are
  copy-on-write by construction: a lease's resume point is always at or
  beyond its shared prefix, so divergent tokens land in private pages and
  a fork never mutates its parent's pages.  Zero-ref published pages stay
  in a retention cache (evicted LRU under allocation pressure), so
  sequential same-prefix batches share too.
- **(layer, position)-addressed partial invalidation** — pages are tracked
  by logical position; the pool remaps reclaimed pages of *all* layers for
  a position range, so reclaiming a handle invalidates a lease only from
  the first remapped position on.  The invalidation callback now carries a
  :class:`LeaseInvalidation` per request — ``keep``/``resume``
  is the **surviving prefix** the scheduler resumes prefill from, instead
  of restarting at token 0.
- **Marginal recompute cost** — Algorithm 1's COST(r) becomes the tokens
  actually recomputed (``filled − surviving``), so victim selection
  prefers handles holding unfilled tails and zero-ref cached prefixes.

Ids allocated *around* the plane (direct ``pool.alloc``) keep the legacy
whole-request invalidation semantics — the plane passes them through with
``keep == 0`` and frees their survivors, exactly like the pre-lease
pool did.
"""
from __future__ import annotations

from collections import OrderedDict
from collections.abc import Sequence as _Sequence
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set

from repro_torch.serving.kvpool import KVPool

__all__ = ['KVLease', 'LeaseInvalidation', 'MemoryPlane', 'MemoryPlaneStats',
           'MigrationRefusal']


class MigrationRefusal:
    """Falsy, explicit result of a :meth:`MemoryPlane.migrate` that did
    NOT move the lease (the source is untouched).  Callers that only care
    about success keep truthiness (``if not moved: ...``); callers that
    need the cause — the disagg handoff scheduler deferring vs erroring,
    tests pinning the shared-page rule — read ``reason``:

    ``'unknown-lease'`` — no live lease under that id on this plane;
    ``'self-target'``   — destination is the source plane;
    ``'shared-pages'``  — ≥ 1 page is referenced by another lease or held
    under a foreign pool id (``pinned_pages`` lists them): moving it would
    tear KV out from under the co-referencing lease, so the caller must
    fall through to partial truncation;
    ``'no-capacity'``   — the destination pool could not fit the lease.
    """

    __slots__ = ('reason', 'pinned_pages')

    def __init__(self, reason: str, pinned_pages: Iterable[int] = ()):
        self.reason = reason
        self.pinned_pages = tuple(pinned_pages)

    def __bool__(self) -> bool:
        return False

    def __repr__(self) -> str:
        pins = f', pinned_pages={list(self.pinned_pages)}' \
            if self.pinned_pages else ''
        return f'MigrationRefusal({self.reason!r}{pins})'


class LeaseInvalidation(_Sequence):
    """One request's share of a reclamation: the physically remapped page
    ids plus the surviving prefix.  Sequence-compatible with the legacy
    ``List[int]`` payload (iterating/len yields the invalidated pages), so
    un-migrated callbacks keep working.

    ``keep``        — logical pages still valid from position 0 (the
    surviving prefix: the framework truncates its page list to this);
    ``resume``      — the resume token position: tokens of valid KV
    (≤ ``keep × page_size``, clamped to what was actually materialized) —
    (re)prefill starts here instead of token 0.
    ``lost_tokens`` — materialized tokens that must be recomputed
    (fill before the hit − ``resume``).
    ``released``    — True when nothing survived and the lease was dropped
    (the request re-admits from scratch, legacy semantics).
    ``migrated_to`` — destination pool name when the victim was *rescued*:
    its whole lease moved to a less-loaded pool before the handles were
    physically taken, so nothing was lost (``lost_tokens == 0``) and the
    request re-admits against the destination pool's plane with its full
    prefix intact.  None for ordinary (truncating) invalidations."""

    __slots__ = ('pages', 'keep', 'resume', 'lost_tokens', 'released',
                 'migrated_to')

    def __init__(self, pages: Iterable[int], keep: int = 0,
                 resume: int = 0, released: bool = True,
                 lost_tokens: float = 0.0,
                 migrated_to: Optional[str] = None):
        self.pages = tuple(pages)
        self.keep = int(keep)
        self.resume = int(resume)
        self.lost_tokens = float(lost_tokens)
        self.released = bool(released)
        self.migrated_to = migrated_to

    def __len__(self) -> int:
        return len(self.pages)

    def __getitem__(self, i):
        return self.pages[i]

    def __eq__(self, other):
        if isinstance(other, LeaseInvalidation):
            return (self.pages, self.keep, self.resume) == \
                (other.pages, other.keep, other.resume)
        if isinstance(other, (list, tuple)):
            return list(self.pages) == list(other)
        return NotImplemented

    __hash__ = None

    def __repr__(self) -> str:
        mig = f', migrated_to={self.migrated_to!r}' if self.migrated_to \
            else ''
        return (f'LeaseInvalidation(pages={list(self.pages)}, '
                f'keep={self.keep}, resume={self.resume}{mig})')


class KVLease(_Sequence):
    """Opaque refcounted handle owning one request's KV page lifetime.

    Sequence-compatible with the legacy ``List[int]`` page list (iterating
    yields physical page ids in logical order), so call sites that treated
    the allocation result as a page list keep working unchanged.
    """

    __slots__ = ('plane', 'lease_id', 'klass', 'scope', 'filled',
                 'released', '_pages', '_pending_publish', '_clean')

    def __init__(self, plane: 'MemoryPlane', lease_id: str, klass: str,
                 scope: str):
        self.plane = plane
        self.lease_id = lease_id
        self.klass = klass
        self.scope = scope
        self.filled = 0          # tokens of valid KV from position 0
        self.released = False
        self._pages: List[int] = []
        # logical page idx → prefix-index key, published once filled
        self._pending_publish: Dict[int, object] = {}
        # True while every page is provably private: sole reference, held
        # under this lease's own pool id, unpublished.  Any path that can
        # share a page (prefix attach, publication, fork) clears it; the
        # release fast path keys off it.
        self._clean = True

    # -- sequence protocol (legacy page-list compatibility) -----------------
    def __len__(self) -> int:
        return len(self._pages)

    def __getitem__(self, i):
        return self._pages[i]

    def __eq__(self, other):
        if isinstance(other, KVLease):
            return self is other
        if isinstance(other, (list, tuple)):
            return self._pages == list(other)
        return NotImplemented

    __hash__ = object.__hash__

    # -- views --------------------------------------------------------------
    @property
    def pages(self) -> List[int]:
        """Physical page ids in logical (position) order."""
        return list(self._pages)

    @property
    def n_pages(self) -> int:
        return len(self._pages)

    @property
    def resume_tokens(self) -> int:
        """Where (re)compute starts: everything before is valid KV — the
        shared prefix at admission, the surviving prefix after a partial
        invalidation."""
        return self.filled

    # -- lifecycle ----------------------------------------------------------
    def extend(self, n_pages: int) -> bool:
        """Grow the lease by ``n_pages`` (tail re-allocation after a
        partial invalidation, or output growth)."""
        return self.plane.extend(self, n_pages) is not None

    def fork(self, new_id: str, n_pages: Optional[int] = None
             ) -> Optional['KVLease']:
        """CoW fork: the child shares this lease's *filled* full pages
        (refcounted) and allocates private pages for the rest — divergent
        writes never touch the parent's pages."""
        return self.plane.fork(self, new_id, n_pages)

    def note_filled(self, tokens: int) -> None:
        """Record that KV is materialized for tokens [0, ``tokens``) —
        monotone; publishes any now-covered prompt-prefix pages."""
        self.plane.note_filled(self, tokens)

    def release(self) -> None:
        """Drop this lease's reference on every page; physical pages free
        when their refcount reaches exactly zero."""
        self.plane.release(self)

    def __repr__(self) -> str:
        return (f'KVLease({self.lease_id!r}, klass={self.klass!r}, '
                f'pages={len(self._pages)}, filled={self.filled})')


@dataclass
class MemoryPlaneStats:
    leases_opened: int = 0
    forks: int = 0
    extends: int = 0
    releases: int = 0
    admit_failures: int = 0
    # prefix sharing
    shared_pages_attached: int = 0     # page attachments that skipped alloc
    shared_tokens_saved: float = 0.0   # prefill tokens skipped via sharing
    pages_published: int = 0
    cache_evictions: int = 0
    # partial invalidation
    invalidations: int = 0             # leases hit by reclamations
    partial_invalidations: int = 0     # … of which kept a surviving prefix
    tokens_preserved: float = 0.0      # Σ resume tokens (recompute saved)
    pages_preserved: int = 0           # Σ surviving pages
    # cross-pool rescue
    leases_migrated: int = 0           # victims re-homed to another pool
    pages_migrated: int = 0            # Σ pages moved cross-pool
    migration_refusals: int = 0        # explicit migrate() refusals


class MemoryPlane:
    """The logical memory plane over one physical :class:`KVPool`.

    One plane per pool (``MemoryPlane.of`` attaches it); every consumer —
    runtime sessions, the reclamation controller, NodeSim's OurMem policy —
    shares it, so refcounts and the prefix index are pool-global.

    ``partial=False`` disables surviving prefixes (every invalidation
    reports ``keep == 0`` — the pre-lease whole-request semantics,
    the benchmark baseline); ``sharing=False`` disables the prefix index.
    """

    def __init__(self, pool: KVPool, *, sharing: bool = True,
                 partial: bool = True):
        assert getattr(pool, '_memory_plane', None) is None, \
            'pool already has a memory plane (use MemoryPlane.of)'
        pool._memory_plane = self
        self.pool = pool
        self.sharing = sharing
        self.partial = partial
        self.leases: Dict[str, KVLease] = {}
        self.stats = MemoryPlaneStats()
        # fired with the lease id whenever a lease fully dies (release or
        # zero-survivor invalidation) — the runtime drops its delivery
        # route here, so route lifetime == lease lifetime by construction.
        # Migration also fires it: the lease leaves THIS plane, so the
        # local route must die exactly like a release.
        self.on_release: Optional[Callable[[str], None]] = None
        # planes a reclamation victim may be rescued to (cross-pool
        # migration); empty list = rescue disabled (truncate as before)
        self.migration_targets: List['MemoryPlane'] = []
        # -- per-page tracking (plane-managed pages only) -------------------
        self._page_users: Dict[int, Set[str]] = {}   # lease ids holding a ref
        self._page_owner: Dict[int, str] = {}        # pool owner id
        self._page_index: Dict[int, int] = {}        # logical position
        self._page_key: Dict[int, object] = {}       # published prefix key
        self._page_chunk: Dict[int, tuple] = {}      # published page tokens
        self._prefix_index: Dict[object, int] = {}   # key → physical page
        self._cache: 'OrderedDict[int, None]' = OrderedDict()  # zero-ref LRU
        self._block_seq = 0
        # husks of cleanly-released leases, reused by the next admit (the
        # session-alloc fast path: admit/release cycles on the serving hot
        # path stop paying object construction).  Only leases released
        # through the notifying path are pooled — an invalidation-released
        # lease may still be referenced by its framework request record
        # (e.g. a queued victim awaiting re-admission), and recycling it
        # would alias two requests onto one handle.
        self._lease_pool: List[KVLease] = []

    @classmethod
    def of(cls, pool: KVPool) -> 'MemoryPlane':
        """The pool's plane, created on first use (pool-global singleton)."""
        plane = getattr(pool, '_memory_plane', None)
        return plane if plane is not None else cls(pool)

    # ------------------------------------------------------------------
    # Prefix index
    # ------------------------------------------------------------------
    @staticmethod
    def _chain_keys(scope: str, prompt: Sequence[int], n: int,
                    page_size: int) -> List[object]:
        """Content-hash chain over page-aligned prompt prefixes: key i
        commits to *all* tokens [0, (i+1)·page_size), so an index hit at
        page i implies the full preceding prefix matches.  Returns
        ``(key, chunk)`` pairs — attachment re-verifies the actual chunk
        tokens against the published page (``hash()`` is not collision
        resistant; aliasing KV between different prompts would corrupt
        decode output silently).  Chunk-equality at every level of a
        contiguous attach implies full-prefix equality."""
        keys: List[object] = []
        acc = hash(scope)
        for i in range(n):
            chunk = tuple(prompt[i * page_size:(i + 1) * page_size])
            acc = hash((acc, chunk))
            keys.append(((scope, i, acc), chunk))
        return keys

    def _shareable_pages(self, prompt: Optional[Sequence[int]],
                         n_pages: int) -> int:
        """Full prompt pages eligible for sharing.  Strictly less than the
        prompt (≥1 token always remains to prefill, so the resumer computes
        the logits the first generated token needs)."""
        if not self.sharing or prompt is None or len(prompt) == 0:
            return 0
        return min((len(prompt) - 1) // self.pool.page_size, n_pages)

    def _publish(self, lease: KVLease) -> None:
        """Enter filled, still-pending prompt pages into the prefix index."""
        pg = self.pool.page_size
        for idx in sorted(lease._pending_publish):
            if (idx + 1) * pg > lease.filled:
                break
            key, chunk = lease._pending_publish.pop(idx)
            # filled ≤ len(pages)·page_size always (note_filled clamps and
            # invalidation truncates both together), so idx is in range
            assert idx < len(lease._pages), (idx, len(lease._pages))
            page = lease._pages[idx]
            if key in self._prefix_index or page in self._page_key:
                continue                      # someone else published first
            self._prefix_index[key] = page
            self._page_key[page] = key
            self._page_chunk[page] = chunk
            self.stats.pages_published += 1

    # ------------------------------------------------------------------
    # Page bookkeeping
    # ------------------------------------------------------------------
    def _track(self, page: int, owner: str, idx: int, lease_id: str) -> None:
        self._page_owner[page] = owner
        self._page_index[page] = idx
        self._page_users[page] = {lease_id}

    def _attach(self, page: int, lease_id: str) -> None:
        self._page_users[page].add(lease_id)
        self._cache.pop(page, None)           # cached → live again

    def _deref(self, page: int, lease_id: str,
               drops: Optional[Dict[str, List[int]]] = None) -> None:
        """Drop one reference.  With ``drops``, zero-ref pages are
        collected per pool owner instead of freed immediately — bulk
        releases flush them in one ``free_pages`` call per owner, keeping
        request completion O(pages) instead of O(pages²)."""
        users = self._page_users[page]
        users.discard(lease_id)
        if users:
            return
        owner = self._page_owner[page]
        if page in self._page_key \
                and self.pool.klass_of.get(owner) == 'offline':
            # published OFFLINE prefix page: retain (LRU) for later
            # same-prefix admissions; reclaimed under allocation pressure.
            # Online pages never retain — zero-ref pages pinning reserved
            # handles would block the MIAD additive decrease and starve
            # offline of handles forever
            self._cache[page] = None
            self._cache.move_to_end(page)
        elif drops is not None:
            drops.setdefault(owner, []).append(page)
        else:
            self._drop_page(page)

    def _flush_drops(self, drops: Dict[str, List[int]]) -> None:
        for owner, pages in drops.items():
            self.pool.free_pages(owner, pages)
            for p in pages:
                self._forget(p)

    def _drop_page(self, page: int) -> None:
        """Physically free a plane page and forget everything about it."""
        self.pool.free_pages(self._page_owner[page], [page])
        self._forget(page)

    def _forget(self, page: int) -> None:
        """Forget a page whose pool mapping is already gone (reclaimed)."""
        self._page_owner.pop(page, None)
        self._page_index.pop(page, None)
        self._page_users.pop(page, None)
        self._cache.pop(page, None)
        self._page_chunk.pop(page, None)
        key = self._page_key.pop(page, None)
        if key is not None:
            self._prefix_index.pop(key, None)

    def drop_cache(self) -> int:
        """Free every zero-ref retained prefix page (benchmark resets,
        memory-accounting tests); returns the number of pages freed."""
        n = len(self._cache)
        for page in list(self._cache):
            self._drop_page(page)
            self.stats.cache_evictions += 1
        return n

    def _evict_cached(self, klass: str, need: int) -> None:
        """Free zero-ref cached prefix pages (LRU) from the region ``klass``
        allocates from until ``need`` pages are free there."""
        for page in list(self._cache):
            if self.pool.free_pages_for(klass) >= need:
                return
            in_reserved = self.pool.handle_of(page) in self.pool.reserved
            if in_reserved == (klass == 'online'):
                self._drop_page(page)
                self.stats.cache_evictions += 1

    def _pool_alloc(self, owner: str, n: int, klass: str, *,
                    grow: bool) -> Optional[List[int]]:
        alloc = self.pool.alloc_more if grow else self.pool.alloc
        got = alloc(owner, n) if grow else alloc(owner, n, klass)
        if got is None and self._cache:
            self._evict_cached(klass, n)
            got = alloc(owner, n) if grow else alloc(owner, n, klass)
        return got

    # ------------------------------------------------------------------
    # Lease lifecycle
    # ------------------------------------------------------------------
    def _new_lease(self, lease_id: str, klass: str, scope: str) -> KVLease:
        if self._lease_pool:
            lease = self._lease_pool.pop()
            lease.lease_id = lease_id
            lease.klass = klass
            lease.scope = scope
            lease.filled = 0
            lease.released = False
            lease._clean = True
            # _pages / _pending_publish were emptied at release
            return lease
        return KVLease(self, lease_id, klass, scope)

    def get(self, lease_id: str) -> Optional[KVLease]:
        return self.leases.get(lease_id)

    def live_leases(self, klass: Optional[str] = None) -> List[str]:
        return sorted(l.lease_id for l in self.leases.values()
                      if klass is None or l.klass == klass)

    def admit(self, lease_id: str, n_pages: int, klass: str = 'offline', *,
              prompt: Optional[Sequence[int]] = None,
              scope: Optional[str] = None) -> Optional[KVLease]:
        """Ensure ``lease_id`` holds ``n_pages`` pages and return its lease.

        Fresh ids open a new lease (attaching any published shared prefix
        of ``prompt``); a live id — a partially-invalidated request being
        re-admitted — is *extended* to the target instead, keeping its
        surviving prefix.  Returns None (state unchanged) on exhaustion.
        """
        assert klass in ('online', 'offline'), klass
        lease = self.leases.get(lease_id)
        if lease is not None:
            assert lease.klass == klass, (lease.klass, klass)
            need = n_pages - len(lease._pages)
            if need > 0 and self.extend(lease, need) is None:
                return None
            return lease

        if prompt is None or not self.sharing:
            # session-alloc fast path: no prefix index to consult, so the
            # whole admit is one pool alloc plus inline page tracking
            got = self.pool.alloc(lease_id, n_pages, klass) \
                if n_pages > 0 else []
            if got is None and self._cache:
                self._evict_cached(klass, n_pages)
                got = self.pool.alloc(lease_id, n_pages, klass)
            if got is None:
                self.stats.admit_failures += 1
                return None
            lease = self._new_lease(lease_id, klass, scope or klass)
            owners, index = self._page_owner, self._page_index
            users = self._page_users
            for i, page in enumerate(got):
                owners[page] = lease_id
                index[page] = i
                users[page] = {lease_id}
            lease._pages.extend(got)
            self.leases[lease_id] = lease
            self.stats.leases_opened += 1
            return lease

        scope = scope or klass
        lease = self._new_lease(lease_id, klass, scope)
        pg = self.pool.page_size
        # 1. attach the published shared prefix (contiguous from page 0);
        #    a hash hit alone is not trusted — the page's published tokens
        #    must equal this prompt's chunk (collision insurance)
        n_share = self._shareable_pages(prompt, n_pages)
        keys = self._chain_keys(scope, prompt, n_share, pg) if n_share else []
        for idx, (key, chunk) in enumerate(keys):
            page = self._prefix_index.get(key)
            if page is None or self._page_index.get(page) != idx \
                    or self._page_chunk.get(page) != chunk:
                break
            self._attach(page, lease_id)
            lease._pages.append(page)
        shared = len(lease._pages)
        if keys:
            # attached pages and/or pending publications → pages of this
            # lease may gain outside references; no release fast path
            lease._clean = False
        # 2. allocate the private tail under the lease's own id
        n_priv = n_pages - shared
        got = self._pool_alloc(lease_id, n_priv, klass, grow=False) \
            if n_priv > 0 else []
        if got is None:
            for idx in range(shared - 1, -1, -1):   # roll the attach back
                self._deref(lease._pages[idx], lease_id)
            self.stats.admit_failures += 1
            del lease._pages[:]                     # recycle the husk
            lease.released = True
            if len(self._lease_pool) < 64:
                self._lease_pool.append(lease)
            return None
        for i, page in enumerate(got):
            self._track(page, lease_id, shared + i, lease_id)
        lease._pages.extend(got)
        # 3. shared KV is valid: the resume point skips it entirely
        lease.filled = shared * pg
        # 4. remember the prompt-page keys this lease may publish once it
        #    fills them (the pages behind a miss, or re-filled after loss)
        for idx in range(shared, len(keys)):
            lease._pending_publish[idx] = keys[idx]
        self.leases[lease_id] = lease
        self.stats.leases_opened += 1
        if shared:
            self.stats.shared_pages_attached += shared
            self.stats.shared_tokens_saved += shared * pg
        return lease

    def extend(self, lease: KVLease, n_pages: int) -> Optional[List[int]]:
        assert not lease.released, f'lease {lease.lease_id} released'
        if n_pages <= 0:
            return []
        grow = lease.lease_id in self.pool.pages_of
        got = self._pool_alloc(lease.lease_id, n_pages, lease.klass,
                               grow=grow)
        if got is None:
            self.stats.admit_failures += 1
            return None
        base = len(lease._pages)
        for i, page in enumerate(got):
            self._track(page, lease.lease_id, base + i, lease.lease_id)
        lease._pages.extend(got)
        self.stats.extends += 1
        return got

    def fork(self, parent: KVLease, new_id: str,
             n_pages: Optional[int] = None) -> Optional[KVLease]:
        assert not parent.released
        assert new_id not in self.leases, f'lease id {new_id!r} live'
        pg = self.pool.page_size
        n_pages = n_pages if n_pages is not None else len(parent._pages)
        child = self._new_lease(new_id, parent.klass, parent.scope)
        n_share = min(parent.filled // pg, len(parent._pages), n_pages)
        if n_share:
            parent._clean = child._clean = False
        for idx in range(n_share):
            self._attach(parent._pages[idx], new_id)
            child._pages.append(parent._pages[idx])
        n_priv = n_pages - n_share
        got = self._pool_alloc(new_id, n_priv, child.klass, grow=False) \
            if n_priv > 0 else []
        if got is None:
            for idx in range(n_share - 1, -1, -1):
                self._deref(child._pages[idx], new_id)
            self.stats.admit_failures += 1
            return None
        for i, page in enumerate(got):
            self._track(page, new_id, n_share + i, new_id)
        child._pages.extend(got)
        child.filled = n_share * pg
        self.leases[new_id] = child
        self.stats.leases_opened += 1
        self.stats.forks += 1
        if n_share:
            self.stats.shared_pages_attached += n_share
            self.stats.shared_tokens_saved += n_share * pg
        return child

    def note_filled(self, lease: KVLease, tokens: int) -> None:
        if lease.released:
            return
        cap = len(lease._pages) * self.pool.page_size
        tokens = min(int(tokens), cap)
        if tokens <= lease.filled:
            return
        lease.filled = tokens
        if lease._pending_publish:
            self._publish(lease)

    def release(self, lease: KVLease, notify: bool = True) -> None:
        """``notify=False`` is the invalidation path: the reclamation
        callback must still find the dying lease's delivery route, so the
        caller (the runtime) drops routes *after* delivery instead."""
        if lease.released:
            return
        lease.released = True
        lid = lease.lease_id
        # Fast path — the hot serving shape: ``_clean`` proves every page
        # is private (sole reference, held under this lease's own pool id,
        # unpublished — sharing requires publication or a fork, both of
        # which clear the flag), so release is one bulk pool free plus
        # three dict deletes per page: no per-page retention checks, no
        # drop batching, no survivor transfer.
        if lease._clean:
            pages = lease._pages
            if pages:
                self.pool.free(lid)
                owners, index = self._page_owner, self._page_index
                users = self._page_users
                for p in pages:
                    del owners[p]
                    del index[p]
                    del users[p]
                del pages[:]
            self.leases.pop(lid, None)
            self.stats.releases += 1
            if notify:
                if len(self._lease_pool) < 64:
                    self._lease_pool.append(lease)
                if self.on_release is not None:
                    self.on_release(lid)
            return
        drops: Dict[str, List[int]] = {}
        for page in reversed(lease._pages):
            self._deref(page, lease.lease_id, drops)
        self._flush_drops(drops)
        lease._pages = []
        lease._pending_publish.clear()
        self.leases.pop(lease.lease_id, None)
        # pages that outlived us (shared with live leases, or retained in
        # the prefix cache) move to an internal block id so this request
        # id can be re-admitted without colliding in the pool
        left = self.pool.pages_of.get(lease.lease_id)
        if left:
            block = f'~blk{self._block_seq}'
            self._block_seq += 1
            self.pool.transfer_pages(lease.lease_id, list(left), block)
            for p in self.pool.pages_of[block]:
                self._page_owner[p] = block
        self.stats.releases += 1
        if notify:
            if len(self._lease_pool) < 64:
                self._lease_pool.append(lease)
            if self.on_release is not None:
                self.on_release(lease.lease_id)

    def release_id(self, lease_id: str) -> None:
        lease = self.leases.get(lease_id)
        if lease is not None:
            self.release(lease)
        elif lease_id in self.pool.pages_of:
            self.pool.free(lease_id)          # legacy id around the plane

    # ------------------------------------------------------------------
    # Cross-pool migration (reclamation-victim rescue)
    # ------------------------------------------------------------------
    def migrate(self, lease_id: str, dst: 'MemoryPlane'
                ) -> 'KVLease | MigrationRefusal':
        """Re-home a live lease to ``dst``'s pool with all KV bookkeeping
        intact (same filled/resume point — zero recompute for the owner).

        Only *privately held* leases move: every page must be solely
        referenced by this lease and held under its own pool id (shared
        prefix pages are pinned by other leases' references).  Published
        pages a lease still solely holds DO move — their prefix-index
        entries are withdrawn, so no later admission can attach a page
        that left the pool.  Returns the (same) lease object, now owned
        by ``dst``, or a falsy :class:`MigrationRefusal` naming why the
        lease did not move (source untouched on refusal)."""
        lease = self.leases.get(lease_id)
        if lease is None or lease.released:
            return self._refuse('unknown-lease')
        if dst is self:
            return self._refuse('self-target')
        lid = lease.lease_id
        assert lid not in dst.leases, f'lease id {lid!r} live in target'
        pages = list(lease._pages)
        pinned = [p for p in pages
                  if self._page_users.get(p) != {lid}
                  or self._page_owner.get(p) != lid]
        if pinned:
            return self._refuse('shared-pages', pinned)
        got = self.pool.transfer_pages(lid, pages, lid, dst_pool=dst.pool)
        if got is None:
            return self._refuse('no-capacity')
        for p in pages:
            self._forget(p)
        del self.leases[lid]
        # page ids are pool-local: the lease's logical order is preserved,
        # the physical ids are the destination allocation
        lease._pages = list(got)
        lease._pending_publish.clear()
        lease._clean = True
        lease.plane = dst
        dst.leases[lid] = lease
        for i, p in enumerate(got):
            dst._track(p, lid, i, lid)
        self.stats.leases_migrated += 1
        self.stats.pages_migrated += len(got)
        if self.on_release is not None:
            self.on_release(lid)          # the local route dies with us
        return lease

    def _refuse(self, reason: str,
                pinned: Iterable[int] = ()) -> MigrationRefusal:
        self.stats.migration_refusals += 1
        return MigrationRefusal(reason, pinned)

    def _pick_migration_target(self, lease: KVLease
                               ) -> Optional['MemoryPlane']:
        """Least-loaded target with room for the whole lease, or None."""
        best, best_free = None, -1
        need = len(lease._pages)
        for dst in self.migration_targets:
            if dst is self:
                continue
            free = dst.pool.free_pages_for(lease.klass)
            if free >= need and free > best_free:
                best, best_free = dst, free
        return best

    def _rescue_victims(self, handles: Sequence[int]
                        ) -> Dict[str, LeaseInvalidation]:
        """Migrate would-be reclamation victims out of ``handles`` before
        the pages are physically taken.  A rescued lease frees its source
        pages (the reclaimer still gets its handles) but keeps every token
        of KV in the destination pool — the invalidation entry records the
        hit pages with ``lost_tokens == 0`` and ``migrated_to`` set."""
        hit: Dict[str, List[int]] = {}
        for h in handles:
            for p in self.pool._handle_pages(h):
                if self.pool.owner[p] is None:
                    continue
                users = self._page_users.get(p)
                if users:
                    for lid in users:
                        hit.setdefault(lid, []).append(p)
        out: Dict[str, LeaseInvalidation] = {}
        for lid, hit_pages in hit.items():
            lease = self.leases[lid]
            dst = self._pick_migration_target(lease)
            # a refusal (shared pages, destination filled up mid-batch) is
            # explicit but non-fatal here: the victim falls through to the
            # ordinary partial-truncation path below
            if dst is None or not self.migrate(lid, dst):
                continue
            out[lid] = LeaseInvalidation(
                hit_pages, keep=len(lease._pages), resume=lease.filled,
                released=False, lost_tokens=0.0,
                migrated_to=dst.pool.name)
        return out

    # ------------------------------------------------------------------
    # Reclamation (partial invalidation)
    # ------------------------------------------------------------------
    def reclaim_handles(self, handles: Sequence[int], now: float = 0.0
                        ) -> Dict[str, LeaseInvalidation]:
        """Physically reclaim ``handles`` and translate the raw page map
        into per-lease invalidations with surviving prefixes.  The caller
        (ReclamationController) must hold the compute gate closed.

        With ``migration_targets`` set, victims are first offered a
        cross-pool rescue (:meth:`_rescue_victims`); the remaining hits
        take the ordinary truncation path."""
        migrated: Dict[str, LeaseInvalidation] = {}
        if self.migration_targets:
            migrated = self._rescue_victims(handles)
        raw = self.pool.reclaim_handles(handles, now, free_survivors=False)
        out = self.apply_pool_invalidation(raw)
        # a rescued lease left this pool whole, so the truncation pass
        # cannot also have hit it — if it ever did, merging would let one
        # victim's lost_tokens be charged under both labels
        assert not set(out) & set(migrated), \
            (sorted(set(out) & set(migrated)), 'victim both rescued and '
             'truncated in one reclamation')
        out.update(migrated)
        return out

    def apply_pool_invalidation(self, raw: Dict[str, List[int]]
                                ) -> Dict[str, LeaseInvalidation]:
        pg = self.pool.page_size
        hit: Dict[str, List[int]] = {}        # lease id → remapped pages
        legacy: Dict[str, List[int]] = {}     # ids allocated around us
        for owner, pages in raw.items():
            for p in pages:
                users = self._page_users.get(p)
                if users is None:
                    legacy.setdefault(owner, []).append(p)
                else:
                    for lid in users:
                        hit.setdefault(lid, []).append(p)
                # the pool already dropped the mapping — forget the page
                # (removes cached/published entries for reclaimed pages)
                self._forget(p)

        out: Dict[str, LeaseInvalidation] = {}
        for lid, pages in hit.items():
            lease = self.leases[lid]
            cut = min(self._lease_pos(lease, p) for p in pages)
            keep = cut if self.partial else 0
            keep_tokens = min(keep * pg, lease.filled)
            lost_tokens = lease.filled - keep_tokens
            # drop everything from the first remapped position on: the
            # remapped pages themselves plus the now-unreachable tail
            # (deref — shared tails may survive under other leases)
            gone = set(pages)
            drops: Dict[str, List[int]] = {}
            for page in reversed(lease._pages[keep:]):
                if page not in gone:
                    self._deref(page, lid, drops)
            self._flush_drops(drops)
            del lease._pages[keep:]
            lease.filled = keep_tokens
            self.stats.invalidations += 1
            if keep > 0:
                self.stats.partial_invalidations += 1
                self.stats.tokens_preserved += keep_tokens
                self.stats.pages_preserved += keep
                released = False
            else:
                self.release(lease, notify=False)
                released = True
            out[lid] = LeaseInvalidation(pages, keep, resume=keep_tokens,
                                         released=released,
                                         lost_tokens=lost_tokens)
        for owner, pages in legacy.items():
            # legacy whole-request semantics: survivors die too, and the
            # loss is counted as the remapped pages' tokens (pre-plane rule)
            self.pool.free(owner)
            self.stats.invalidations += 1
            out[owner] = LeaseInvalidation(
                pages, 0, 0, released=True,
                lost_tokens=len(pages) * pg)
        return out

    def _lease_pos(self, lease: KVLease, page: int) -> int:
        # shared pages sit at the same logical position for every user, so
        # the page's recorded index is the lease's position — but a page
        # reclaimed and forgotten loses its index; fall back to a scan
        idx = self._page_index.get(page)
        if idx is not None:
            return idx
        return lease._pages.index(page)

    # ------------------------------------------------------------------
    # Eviction support (Algorithm 1's marginal recompute cost)
    # ------------------------------------------------------------------
    def impact_of(self, handle: int) -> Dict[str, int]:
        """{request id: min logical page index lost} if ``handle`` were
        reclaimed.  Zero-ref cached prefix pages impact nobody (free to
        take); legacy ids lose everything (index 0)."""
        out: Dict[str, int] = {}
        for p in self.pool._handle_pages(handle):
            owner = self.pool.owner[p]
            if owner is None:
                continue
            users = self._page_users.get(p)
            if users:
                idx = self._page_index[p]
                for lid in users:
                    if idx < out.get(lid, 1 << 30):
                        out[lid] = idx
            elif p not in self._page_owner:
                out[owner] = 0                # legacy: full restart
        return out

    def recompute_cost(self, rid: str, min_idx: int) -> float:
        """Marginal recompute tokens if ``rid`` loses pages from logical
        index ``min_idx`` on (COST(r) for Algorithm 1)."""
        lease = self.leases.get(rid)
        if lease is None:                     # legacy id: full restart cost
            return len(self.pool.pages_of.get(rid, ())) * self.pool.page_size
        keep = min_idx if self.partial else 0
        return max(0.0, lease.filled - keep * self.pool.page_size)

    # ------------------------------------------------------------------
    def check_invariants(self) -> None:
        self.pool.check_invariants()
        seen_refs: Dict[int, int] = {}
        for lid, lease in self.leases.items():
            assert not lease.released
            assert lease.filled <= len(lease._pages) * self.pool.page_size
            for idx, p in enumerate(lease._pages):
                assert self._page_index[p] == idx, (lid, p, idx)
                assert lid in self._page_users[p], (lid, p)
                seen_refs[p] = seen_refs.get(p, 0) + 1
        for p, users in self._page_users.items():
            assert len(users) == seen_refs.get(p, 0), \
                (p, users, seen_refs.get(p))
            assert self.pool.owner[p] == self._page_owner[p], \
                (p, self.pool.owner[p], self._page_owner[p])
            if not users:
                assert p in self._cache, f'zero-ref page {p} not cached'
        for p in self._cache:
            assert not self._page_users[p], f'cached page {p} has users'
            assert p in self._page_key, f'cached page {p} never published'
        for key, p in self._prefix_index.items():
            assert self._page_key.get(p) == key, (key, p)
            assert p in self._page_chunk, f'published page {p} lacks tokens'
