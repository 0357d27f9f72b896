"""Selective handle reclamation — paper Algorithm 1 (+ FIFO baseline).

The KV cache is not allocated contiguously over memory handles (fragmentation),
so one handle may hold pages of several offline requests.  Valve greedily
selects the ``k`` handles with the lowest *marginal token cost*: the total
extra tokens of requests newly impacted by reclaiming that handle (requests
already impacted by an earlier pick are free).

Two cost models:

- :func:`select_handles` — the classic COST(r) model: a request's whole
  recompute cost is paid the first time any of its pages is hit.
- :func:`select_handles_partial` — the memory-plane model (partial
  invalidation): hitting a page only costs the tokens between the request's
  *surviving prefix* and its current fill, so the marginal cost of a handle
  depends on the lowest logical position it would knock out given the picks
  so far (``repro_torch.core.memory.MemoryPlane.recompute_cost``).

Both are **memoized**: per-handle costs are cached and only handles sharing
a request with the previous pick are re-scored (the naive loop re-scored
every handle every round — O(k·H·R)).  ``_select_handles_naive`` keeps the
textbook implementation as the property-test oracle; the memoized versions
are tie-break-identical to it.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Sequence, Set

_INF = 1 << 30


def _select_handles_naive(
    k: int,
    handles: Sequence[int],
    reqs_of: Callable[[int], Set[str]],
    cost: Callable[[str], float],
) -> List[int]:
    """Reference implementation (paper Algorithm 1, verbatim greedy) —
    the oracle the memoized version is property-tested against."""
    S: List[int] = []
    chosen: Set[int] = set()
    E: Set[str] = set()
    k = min(k, len(handles))
    for _ in range(k):
        best, best_cost = None, None
        for h in handles:
            if h in chosen:
                continue
            c = sum(cost(r) for r in reqs_of(h) if r not in E)
            if best_cost is None or c < best_cost:
                best, best_cost = h, c
        if best is None:
            break
        S.append(best)
        chosen.add(best)
        E |= reqs_of(best)
    return S


def select_handles(
    k: int,
    handles: Sequence[int],
    reqs_of: Callable[[int], Set[str]],
    cost: Callable[[str], float],
) -> List[int]:
    """Paper Algorithm 1 (memoized).

    k           — number of handles to reclaim;
    handles     — candidate handle ids (equal size);
    reqs_of(h)  — REQS(h): offline requests with ≥1 page in handle h;
    cost(r)     — COST(r): recompute cost of request r in tokens.

    Per-handle costs are computed once, then only handles intersecting the
    last pick's request set are re-scored — identical picks (including tie
    breaks: first-lowest in ``handles`` order) to the naive O(k·H·R) loop.
    """
    k = min(k, len(handles))
    if k <= 0:
        return []
    req_sets: Dict[int, Set[str]] = {h: set(reqs_of(h)) for h in handles}
    by_req: Dict[str, Set[int]] = {}
    for h in handles:
        for r in req_sets[h]:
            by_req.setdefault(r, set()).add(h)
    E: Set[str] = set()
    cached: Dict[int, float] = {
        h: sum(cost(r) for r in req_sets[h]) for h in handles}
    S: List[int] = []
    chosen: Set[int] = set()
    for _ in range(k):
        best, best_cost = None, None
        for h in handles:
            if h in chosen:
                continue
            c = cached[h]
            if best_cost is None or c < best_cost:
                best, best_cost = h, c
        if best is None:
            break
        S.append(best)
        chosen.add(best)
        newly = req_sets[best] - E
        E |= newly
        dirty: Set[int] = set()
        for r in newly:
            dirty |= by_req[r]
        for h in dirty:
            if h not in chosen:
                cached[h] = sum(cost(r) for r in req_sets[h] if r not in E)
    return S


def select_handles_partial(
    k: int,
    handles: Sequence[int],
    impact_of: Callable[[int], Dict[str, int]],
    loss_of: Callable[[str, int], float],
) -> List[int]:
    """Algorithm 1 under partial (surviving-prefix) invalidation.

    impact_of(h)     — {request id: lowest logical page index lost} if ``h``
                       were reclaimed;
    loss_of(r, idx)  — tokens request ``r`` must recompute if its surviving
                       prefix is cut at logical page ``idx`` (monotone
                       non-increasing in ``idx``; ``loss_of(r, ∞) == 0``).

    The marginal cost of a handle is the *additional* recompute its cut
    positions cause beyond the cuts already inflicted by earlier picks —
    memoized with the same dirty-set re-scoring as :func:`select_handles`.
    """
    k = min(k, len(handles))
    if k <= 0:
        return []
    impact: Dict[int, Dict[str, int]] = {h: dict(impact_of(h))
                                         for h in handles}
    by_req: Dict[str, Set[int]] = {}
    for h in handles:
        for r in impact[h]:
            by_req.setdefault(r, set()).add(h)
    cut: Dict[str, int] = {}           # rid → lowest idx cut by picks so far
    cut_loss: Dict[str, float] = {}    # rid → loss already paid at that cut

    def marginal(h: int) -> float:
        tot = 0.0
        for r, idx in impact[h].items():
            if idx < cut.get(r, _INF):
                tot += loss_of(r, idx) - cut_loss.get(r, 0.0)
        return tot

    cached: Dict[int, float] = {h: marginal(h) for h in handles}
    S: List[int] = []
    chosen: Set[int] = set()
    for _ in range(k):
        best, best_cost = None, None
        for h in handles:
            if h in chosen:
                continue
            c = cached[h]
            if best_cost is None or c < best_cost:
                best, best_cost = h, c
        if best is None:
            break
        S.append(best)
        chosen.add(best)
        dirty: Set[int] = set()
        for r, idx in impact[best].items():
            if idx < cut.get(r, _INF):
                cut[r] = idx
                cut_loss[r] = loss_of(r, idx)
            dirty |= by_req[r]
        for h in dirty:
            if h not in chosen:
                cached[h] = marginal(h)
    return S


def select_handles_fifo(
    k: int,
    handles_by_age: Sequence[int],
    reqs_of: Callable[[int], Set[str]] = None,
    cost: Callable[[str], float] = None,
) -> List[int]:
    """FIFO baseline (paper §7.2, Fig. 11): evict oldest handles first."""
    return list(handles_by_age[: k])


def impacted_requests(selected: Iterable[int],
                      reqs_of: Callable[[int], Set[str]]) -> Set[str]:
    out: Set[str] = set()
    for h in selected:
        out |= reqs_of(h)
    return out
