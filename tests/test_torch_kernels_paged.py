"""Paged decode attention of the port (K1 page walk, K2/K3 prefix-shared
two-phase read) against the JAX package's Pallas kernels (interpret mode)
and its jnp oracles, and ``build_shared_runs`` against the reference's.
The CUDA kernels' split algorithms (``paged_decode_split_ref``,
``shared_run_split_ref``) and their planners are held here too.

On the CPU the wrappers take the kernels' plain versions, which these
tests hold to the reference; ``test_torch_cuda.py`` holds the CUDA kernels
to the plain versions on the card.  Tolerance: f32 inputs, atol/rtol 1e-5
(summation order only).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import ops as jops
from repro.kernels.paged_attention import prefix as jprefix
from repro.kernels.paged_attention.ref import \
    paged_attention_ref as j_paged_ref
from repro_torch.kernels.paged_attention import ops as tops
from repro_torch.kernels.paged_attention import prefix as tprefix
from repro_torch.kernels.paged_attention.ref import (paged_decode_ref,
                                                     paged_decode_split_ref,
                                                     shared_run_ref,
                                                     shared_run_split_ref)
from repro_torch.models import common as tcm

TOL = dict(rtol=1e-5, atol=1e-5)
H100_SMS = 132            # multiprocessors the plans fill on an H100 SXM

# (B, Hq, Hkv, D, pg, maxp) of the reference's kernel tests, all run in f32
CASES = [
    (2, 4, 4, 64, 16, 4),
    (2, 8, 2, 64, 16, 8),
    (1, 16, 8, 128, 16, 4),
    (3, 4, 1, 32, 8, 5),
    (2, 4, 2, 64, 4, 16),
]


def _setup(case, seed=0):
    b, hq, hkv, d, pg, maxp = case
    rng = np.random.default_rng(seed)
    n_pages = b * maxp + 1
    q = (rng.normal(size=(b, hq, d)) * 0.5).astype(np.float32)
    pk = (rng.normal(size=(n_pages, pg, hkv, d)) * 0.5).astype(np.float32)
    pv = (rng.normal(size=(n_pages, pg, hkv, d)) * 0.5).astype(np.float32)
    perm = rng.permutation(n_pages - 1) + 1
    pt = perm[: b * maxp].reshape(b, maxp).astype(np.int32)
    lengths = rng.integers(1, maxp * pg + 1, size=b).astype(np.int32)
    return q, pk, pv, pt, lengths


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize('case', CASES)
def test_paged_decode_matches_pallas_and_oracle(case):
    args = _setup(case, seed=sum(case))
    want_kernel = np.asarray(jops.paged_attention(*_j(*args), interpret=True))
    want_ref = np.asarray(j_paged_ref(*_j(*args)))
    got = tops.paged_attention_decode(*_t(*args)).numpy()
    np.testing.assert_allclose(got, want_kernel, **TOL)
    np.testing.assert_allclose(got, want_ref, **TOL)
    # the port's own gather oracle (the engine's plain decode path)
    oracle = tcm.paged_attention_ref(*_t(*args)).numpy()
    np.testing.assert_allclose(oracle, want_ref, **TOL)


def test_quarantined_pages_are_harmless_when_masked():
    """Remapping pages past a row's length to quarantine (page 0) leaves
    its output unchanged -- the Valve no-fault contract."""
    case = (2, 4, 2, 64, 8, 6)
    q, pk, pv, pt, _ = _setup(case, seed=7)
    lengths = np.array([3 * 8, 2 * 8], np.int32)
    base = tops.paged_attention_decode(*_t(q, pk, pv, pt, lengths)).numpy()
    pt_q = pt.copy()
    pt_q[0, 3:] = 0
    pt_q[1, 2:] = 0
    out = tops.paged_attention_decode(*_t(q, pk, pv, pt_q, lengths)).numpy()
    np.testing.assert_allclose(out, base, rtol=1e-6, atol=1e-6)
    want = np.asarray(jops.paged_attention(*_j(q, pk, pv, pt_q, lengths),
                                           interpret=True))
    np.testing.assert_allclose(out, want, **TOL)


def test_padding_rows_attend_one_quarantine_slot():
    """The engine's padding decode rows: length 1 over an all-quarantine
    table.  Finite, equal to the quarantine page's first V row."""
    q, pk, pv, pt, _ = _setup((3, 4, 2, 32, 4, 5), seed=3)
    pt[1:] = 0
    lengths = np.array([7, 1, 1], np.int32)
    got = tops.paged_attention_decode(*_t(q, pk, pv, pt, lengths)).numpy()
    want = np.asarray(j_paged_ref(*_j(q, pk, pv, pt, lengths)))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got[1], np.repeat(pv[0, 0], 2, axis=0),
                               **TOL)


def test_paged_vs_dense_attention():
    """The paged read equals dense attention over the same tokens."""
    from repro.models import common as jcm
    b, hq, hkv, d, pg, maxp = 2, 8, 4, 64, 4, 8
    rng = np.random.default_rng(3)
    s = maxp * pg
    k = (rng.normal(size=(b, s, hkv, d)) * 0.5).astype(np.float32)
    v = (rng.normal(size=(b, s, hkv, d)) * 0.5).astype(np.float32)
    q = (rng.normal(size=(b, hq, d)) * 0.5).astype(np.float32)
    lengths = np.array([s, s - 5], np.int32)
    pool_k = np.zeros((1 + b * maxp, pg, hkv, d), np.float32)
    pool_v = np.zeros_like(pool_k)
    pool_k[1:] = k.reshape(b * maxp, pg, hkv, d)
    pool_v[1:] = v.reshape(b * maxp, pg, hkv, d)
    pt = np.arange(1, 1 + b * maxp, dtype=np.int32).reshape(b, maxp)
    got = tops.paged_attention_decode(*_t(q, pool_k, pool_v, pt,
                                          lengths)).numpy()
    kv_pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    want = np.asarray(jcm.attention(
        jnp.asarray(q)[:, None], jnp.asarray(k), jnp.asarray(v),
        q_positions=jnp.asarray(lengths)[:, None],
        kv_positions=jnp.asarray(kv_pos),
        kv_valid=jnp.asarray(kv_pos < lengths[:, None]), causal=False))[:, 0]
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# prefix-shared two-phase read and the shared-run builder
# ---------------------------------------------------------------------------

def _shared_setup(b=4, hq=4, hkv=2, d=32, pg=4, maxp=10, n_shared=3, seed=0):
    """Every row starts with the same ``n_shared`` published prefix pages,
    then owns a private tail (the reference test's CoW-shaped batch)."""
    rng = np.random.default_rng(seed)
    n_pages = b * maxp + n_shared + 1
    q = (rng.normal(size=(b, hq, d)) * 0.5).astype(np.float32)
    pk = (rng.normal(size=(n_pages, pg, hkv, d)) * 0.5).astype(np.float32)
    pv = (rng.normal(size=(n_pages, pg, hkv, d)) * 0.5).astype(np.float32)
    pt = np.zeros((b, maxp), np.int32)
    pt[:, :n_shared] = np.arange(1, n_shared + 1)
    tail = maxp - n_shared
    for i in range(b):
        pt[i, n_shared:] = np.arange(n_shared + 1 + i * tail,
                                     n_shared + 1 + (i + 1) * tail)
    lengths = rng.integers(n_shared * pg + 1, maxp * pg + 1,
                           size=b).astype(np.int32)
    return q, pk, pv, pt, lengths


def _run_args(runs, lengths):
    return [runs['pages'], runs['pos'], runs['mask'], runs['tail_pt'],
            runs['start'], lengths]


def _assert_runs_equal(got, want):
    assert set(got) == set(want)
    assert got['n_slots'] == want['n_slots']
    for key in ('pages', 'pos', 'mask', 'tail_pt', 'start'):
        assert got[key].dtype == np.asarray(want[key]).dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_prefix_shared_matches_pallas_and_oracles(seed):
    q, pk, pv, pt, lengths = _shared_setup(seed=seed)
    runs = tprefix.build_shared_runs(pt, lengths, 4)
    assert runs['n_slots'] > 0
    args = [q, pk, pv] + _run_args(runs, lengths)
    got = tops.paged_attention_prefix_shared(*_t(*args)).numpy()
    stock = np.asarray(j_paged_ref(*_j(q, pk, pv, pt, lengths)))
    want_ref = np.asarray(jprefix.prefix_shared_ref(*_j(*args)))
    want_kernel = np.asarray(jops.paged_attention_prefix_shared(
        *_j(*args), backend='pallas', interpret=True))
    np.testing.assert_allclose(got, want_kernel, **TOL)
    np.testing.assert_allclose(got, want_ref, **TOL)
    np.testing.assert_allclose(got, stock, **TOL)
    # the port's joint-softmax oracle agrees as well
    oracle = tprefix.prefix_shared_ref(*_t(*args)).numpy()
    np.testing.assert_allclose(oracle, want_ref, **TOL)


def test_prefix_shared_with_padded_slots_and_unshared_rows():
    """The engine pads the slot axis to a power of two (quarantine slots,
    masked everywhere) and may batch rows that share nothing: such a row's
    phase-1 state is all garbage at m = NEG_INF, rescaled away by its tail."""
    q, pk, pv, pt, lengths = _shared_setup(b=5, seed=11)
    pt[4] = np.arange(40, 50)                # row 4 shares nothing
    runs = tprefix.build_shared_runs(pt, lengths, 4)
    assert runs['n_slots'] == 3 and runs['start'][4] == 0
    cap = 4
    args = [q, pk, pv, runs['pages'][:cap], runs['pos'][:cap],
            runs['mask'][:, :cap], runs['tail_pt'], runs['start'], lengths]
    m, l, acc = shared_run_ref(*_t(q.reshape(5, 2, 2, 32), pk, pv,
                                   runs['pages'][:cap],
                                   runs['mask'][:, :cap]))
    assert (m[4] == tprefix.NEG_INF).all()
    got = tops.paged_attention_prefix_shared(*_t(*args)).numpy()
    want = np.asarray(j_paged_ref(*_j(q, pk, pv, pt, lengths)))
    np.testing.assert_allclose(got, want, **TOL)
    want_kernel = np.asarray(jops.paged_attention_prefix_shared(
        *_j(*args), backend='pallas', interpret=True))
    np.testing.assert_allclose(got, want_kernel, **TOL)


def test_tail_walk_resumes_from_state():
    """K3's plain version: the page walk over the tails, started from the
    phase-1 state, equals the one-pass walk over the full tables."""
    q, pk, pv, pt, lengths = _shared_setup(seed=4)
    qg = q.reshape(4, 2, 2, 32)
    runs = tprefix.build_shared_runs(pt, lengths, 4)
    state = shared_run_ref(*_t(qg, pk, pv, runs['pages'], runs['mask']))
    got = tops.shared_tail(*_t(qg, pk, pv, runs['tail_pt'], runs['start'],
                               lengths), state)
    want = paged_decode_ref(*_t(qg, pk, pv, pt, lengths))
    torch.testing.assert_close(got, want, **TOL)


# the check of the CUDA kernels' bf16 outputs against their plain versions
# (chip_smoke.py, test_torch_cuda.py): |got - want| <= 1e-3 + 2^-7 |want|
BF16_TOL = dict(rtol=2 ** -7, atol=1e-3)


@pytest.mark.parametrize('mutant', ['dropped page', 'shifted start',
                                    'no initial state'])
def test_bf16_tolerance_rejects_a_wrong_page_walk(mutant):
    """At the qwen3-0.6b decode shapes the on-card check uses (B=8, Hkv=8,
    G=2, D=128, 32 pages of 16, a shared 4-page prefix), the bf16
    tolerance passes the gather oracle, which sums in another order, and
    fails a page walk that drops the longest row's last page, starts its
    tail one page late, or skips the phase-1 state."""
    b, hkv, g, d, pg, maxp = 8, 8, 2, 128, 16, 32
    rng = np.random.default_rng(0)
    n_pages = 1 + b * maxp

    def bf16(*shape):
        return torch.tensor(rng.normal(size=shape) * 0.5,
                            dtype=torch.bfloat16)

    q = bf16(b, hkv, g, d)
    pk, pv = bf16(n_pages, pg, hkv, d), bf16(n_pages, pg, hkv, d)
    pt = (rng.permutation(n_pages - 1) + 1).reshape(b, maxp).astype(np.int32)
    pt[:, :4] = pt[0, :4]
    lengths = np.linspace(4 * pg + 1, maxp * pg, b).astype(np.int32)
    runs = tprefix.build_shared_runs(pt, lengths, pg)
    pt_t, n, tail, start = _t(pt, lengths, runs['tail_pt'], runs['start'])
    state = shared_run_ref(q, pk, pv, *_t(runs['pages'], runs['mask']))
    want = paged_decode_ref(q, pk, pv, tail, n, start=start, state=state)
    oracle = tcm.paged_attention_ref(q.reshape(b, hkv * g, d), pk, pv, pt_t,
                                     n)
    torch.testing.assert_close(oracle.reshape(want.shape).float(),
                               want.float(), **BF16_TOL)
    longest = int(lengths.argmax())
    if mutant == 'dropped page':
        short = n.clone()
        short[longest] -= pg
        bad = paged_decode_ref(q, pk, pv, pt_t, short)
    elif mutant == 'shifted start':
        late = start.clone()
        late[longest] += 1
        bad = paged_decode_ref(q, pk, pv, tail, n, start=late, state=state)
    else:
        bad = paged_decode_ref(q, pk, pv, tail, n, start=start)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(bad.float(), want.float(), **BF16_TOL)


def test_shared_runs_zero_sharing():
    q, pk, pv, pt, lengths = _shared_setup(n_shared=0, seed=2)
    runs = tprefix.build_shared_runs(pt, lengths, 4)
    _assert_runs_equal(runs, jprefix.build_shared_runs(pt, lengths, 4))
    assert runs['n_slots'] == 0 and (runs['start'] == 0).all()
    np.testing.assert_array_equal(runs['tail_pt'], pt)


def test_shared_runs_partial_page_never_dedups():
    q, pk, pv, pt, _ = _shared_setup(n_shared=3, seed=3)
    lengths = np.full(pt.shape[0], 2 * 4 + 1, np.int32)   # inside page 3
    runs = tprefix.build_shared_runs(pt, lengths, 4)
    _assert_runs_equal(runs, jprefix.build_shared_runs(pt, lengths, 4))
    assert runs['n_slots'] == 2 and (runs['start'] == 2).all()
    args = [q, pk, pv] + _run_args(runs, lengths)
    got = tops.paged_attention_prefix_shared(*_t(*args)).numpy()
    want = np.asarray(j_paged_ref(*_j(q, pk, pv, pt, lengths)))
    np.testing.assert_allclose(got, want, **TOL)


def test_shared_runs_quarantine_never_becomes_a_slot():
    pt = np.zeros((3, 6), np.int32)
    lengths = np.full(3, 24, np.int32)
    runs = tprefix.build_shared_runs(pt, lengths, 4)
    _assert_runs_equal(runs, jprefix.build_shared_runs(pt, lengths, 4))
    assert runs['n_slots'] == 0
    assert (runs['pages'] == tprefix.QUARANTINE_PAGE).all()


def test_shared_runs_slot_overflow_clamps_soundly():
    q, pk, pv, pt, lengths = _shared_setup(b=4, maxp=10, n_shared=6, seed=4)
    runs = tprefix.build_shared_runs(pt, lengths, 4, max_slots=3)
    _assert_runs_equal(runs, jprefix.build_shared_runs(pt, lengths, 4,
                                                       max_slots=3))
    assert 0 < runs['n_slots'] <= 3 and (runs['start'] <= 3).all()
    args = [q, pk, pv] + _run_args(runs, lengths)
    got = tops.paged_attention_prefix_shared(*_t(*args)).numpy()
    want = np.asarray(j_paged_ref(*_j(q, pk, pv, pt, lengths)))
    np.testing.assert_allclose(got, want, **TOL)


def test_shared_runs_equal_the_reference_on_random_tables():
    """Random tables with repeated, quarantined and foreign pages: the
    builder's whole output equals the reference's, and every slot holds a
    page present at its logical index in >= 2 of the batch's own tables."""
    rng = np.random.default_rng(9)
    for trial in range(60):
        b, maxp, pg = 4, 8, 4
        pt = rng.integers(1, 12, size=(b, maxp)).astype(np.int32)
        if trial % 2:                        # CoW-like leading runs
            pt[:, :3] = pt[0, :3]
        pt[rng.random((b, maxp)) < 0.2] = tprefix.QUARANTINE_PAGE
        lengths = rng.integers(1, maxp * pg + 1, size=b).astype(np.int32)
        max_slots = None if trial % 3 else 2
        runs = tprefix.build_shared_runs(pt, lengths, pg,
                                         max_slots=max_slots)
        _assert_runs_equal(runs, jprefix.build_shared_runs(
            pt, lengths, pg, max_slots=max_slots))
        n_full = lengths // pg
        for si in range(runs['n_slots']):
            p, j = int(runs['pages'][si]), int(runs['pos'][si])
            holders = [i for i in range(b) if pt[i, j] == p and j < n_full[i]]
            assert len(holders) >= 2
            assert set(np.nonzero(runs['mask'][:, si])[0]) <= set(holders)


# ---------------------------------------------------------------------------
# the split page walk of the CUDA kernels (K1/K3) and its planner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('pps', [1, 2, 3, 'maxp'])
@pytest.mark.parametrize('case', CASES)
def test_split_walk_matches_the_serial_walk_and_pallas(case, pps):
    """The CUDA walk's algorithm -- per-split partials from the empty state,
    an empty partial for a split past the row's live pages, all merged in
    split order -- equals the serial walk and the JAX kernel (interpret
    mode), with a row of length 1 in every batch.  With one split it is the
    serial walk bit for bit."""
    b, hq, hkv, d, pg, maxp = case
    q, pk, pv, pt, lengths = _setup(case, seed=sum(case) + 1)
    lengths[0] = 1
    qg = q.reshape(b, hkv, hq // hkv, d)
    got = paged_decode_split_ref(
        *_t(qg, pk, pv, pt, lengths),
        pages_per_split=maxp if pps == 'maxp' else pps)
    serial = paged_decode_ref(*_t(qg, pk, pv, pt, lengths))
    torch.testing.assert_close(got, serial, **TOL)
    if pps == 'maxp':
        assert torch.equal(got, serial)
    want = np.asarray(jops.paged_attention(*_j(q, pk, pv, pt, lengths),
                                           interpret=True))
    np.testing.assert_allclose(got.reshape(b, hq, d).numpy(), want, **TOL)


@pytest.mark.parametrize('pps', [1, 2, 3, 10])
def test_split_walk_resumes_from_state(pps):
    """K3's algorithm: split 0 of the tails' walk goes on from the phase-1
    state, the other splits start empty; a row whose tail is empty (its
    whole context in the shared prefix) leaves split 0's partial at the
    state and every other split empty.  Equals the serial walk from the
    state (bit for bit with one split), the serial walk over the full
    tables and the JAX prefix-shared kernel."""
    q, pk, pv, pt, lengths = _shared_setup(seed=5)
    lengths[1] = 3 * 4                         # row 1: no tail page
    qg = q.reshape(4, 2, 2, 32)
    runs = tprefix.build_shared_runs(pt, lengths, 4)
    assert runs['start'][1] == 3
    state = shared_run_ref(*_t(qg, pk, pv, runs['pages'], runs['mask']))
    got = paged_decode_split_ref(
        *_t(qg, pk, pv, runs['tail_pt'], lengths), start=_t(runs['start'])[0],
        state=state, pages_per_split=pps)
    resumed = paged_decode_ref(*_t(qg, pk, pv, runs['tail_pt'], lengths),
                               start=_t(runs['start'])[0], state=state)
    torch.testing.assert_close(got, resumed, **TOL)
    if pps >= runs['tail_pt'].shape[1]:
        assert torch.equal(got, resumed)
    torch.testing.assert_close(got, paged_decode_ref(
        *_t(qg, pk, pv, pt, lengths)), **TOL)
    want = np.asarray(jops.paged_attention_prefix_shared(
        *_j(q, pk, pv, *_run_args(runs, lengths)), backend='pallas',
        interpret=True))
    np.testing.assert_allclose(got.reshape(4, 4, 32).numpy(), want, **TOL)


def test_split_walk_reads_out_of_range_pages_as_quarantine():
    """A page id outside [0, P) reads the quarantine page 0, as the CUDA
    kernels do, so no index leaves the pool."""
    case = (2, 4, 2, 32, 4, 6)
    q, pk, pv, pt, lengths = _setup(case, seed=8)
    lengths[:] = 24
    bad = pt.copy()
    bad[0, 2], bad[1, 0] = pk.shape[0] + 3, -1
    fixed = pt.copy()
    fixed[0, 2] = fixed[1, 0] = 0
    qg = q.reshape(2, 2, 2, 32)
    got = paged_decode_split_ref(*_t(qg, pk, pv, bad, lengths),
                                 pages_per_split=2)
    torch.testing.assert_close(got, paged_decode_ref(
        *_t(qg, pk, pv, fixed, lengths)), **TOL)


@pytest.mark.parametrize('shape', [
    # (B, Hkv, maxp, page size)
    (8, 8, 32, 16),      # qwen3-0.6b decode, the on-card shape
    (8, 8, 256, 16),     # a 4096-token context
    (1, 1, 1, 16),
    (2, 4, 5, 4),
    (64, 8, 6, 16),      # a batch that fills the card alone
    (3, 2, 17, 1),
    (1, 1, 3, 128),
])
def test_plan_splits_covers_every_live_page_once(shape):
    """For any length up to maxp * page size and any start, the splits'
    page ranges, clipped to the row's live pages as each CTA clips them,
    cover every live page exactly once, in order; a split never holds more
    than SPLIT_TOKENS tokens, and no split starts past the table."""
    b, hkv, maxp, pg = shape
    pps, n_splits = tops.plan_splits(b, hkv, maxp, pg, H100_SMS)
    assert pps * pg <= tops.SPLIT_TOKENS
    assert (n_splits - 1) * pps < maxp <= n_splits * pps
    for first in (0, maxp // 3):
        for length in range(1, maxp * pg + 1):
            live = min(max(-(-length // pg) - first, 0), maxp)
            covered = []
            for s in range(n_splits):
                p0 = s * pps
                covered += range(p0, p0 + max(0, min(pps, live - p0)))
            assert covered == list(range(live)), (first, length)


def test_plan_splits_fills_the_card_at_the_decode_shape():
    """qwen3-0.6b decode at B=8 (Hkv=8, 32 pages of 16): at least two CTAs
    for each of the H100's 132 SMs, where one CTA per (kv-head, row) gave
    64."""
    pps, n_splits = tops.plan_splits(8, 8, 32, 16, H100_SMS)
    assert 8 * 8 * n_splits >= 2 * 132
    assert tops.plan_splits(8, 8, 0, 16, H100_SMS) == (1, 1)      # an empty table


# ---------------------------------------------------------------------------
# the split shared run of the CUDA kernel (K2) and its planner
# ---------------------------------------------------------------------------

# the f32 partial softmax state: relative 1e-4 (chip_smoke.STATE_RTOL)
STATE_TOL = dict(rtol=1e-4, atol=1e-5)


def _pallas_shared_run(q, pk, pv, pages, pos, mask):
    """Phase 1 of the JAX prefix-shared kernel on its own: the reference's
    ``_shared_run_kernel`` under the grid spec of
    ``paged_attention_prefix_shared_bhgd``, in interpret mode, as the JAX
    package's tests run it.  Returns its state (m, l, acc) as numpy."""
    import functools

    import jax
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from repro.kernels import common as jkc
    from repro.kernels.paged_attention.kernel import _shared_run_kernel

    b, hkv, g, d = q.shape
    pg = pk.shape[1]
    spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=2,
        grid=(hkv, pages.shape[0]),
        in_specs=[
            pl.BlockSpec((b, 1, g, d), lambda ih, js, sp, spos: (0, ih, 0, 0)),
            pl.BlockSpec((1, pg, 1, d),
                         lambda ih, js, sp, spos: (sp[js], 0, ih, 0)),
            pl.BlockSpec((1, pg, 1, d),
                         lambda ih, js, sp, spos: (sp[js], 0, ih, 0)),
            pl.BlockSpec((b, 1), lambda ih, js, sp, spos: (0, js)),
        ],
        out_specs=[
            pl.BlockSpec((b, 1, g), lambda ih, js, sp, spos: (0, ih, 0)),
            pl.BlockSpec((b, 1, g), lambda ih, js, sp, spos: (0, ih, 0)),
            pl.BlockSpec((b, 1, g, d), lambda ih, js, sp, spos: (0, ih, 0, 0)),
        ],
        scratch_shapes=[pltpu.VMEM((b * g,), jnp.float32),
                        pltpu.VMEM((b * g,), jnp.float32),
                        pltpu.VMEM((b * g, d), jnp.float32)],
    )
    out = pl.pallas_call(
        functools.partial(_shared_run_kernel, page_size=pg, scale=d ** -0.5),
        grid_spec=spec,
        out_shape=[jax.ShapeDtypeStruct((b, hkv, g), jnp.float32),
                   jax.ShapeDtypeStruct((b, hkv, g), jnp.float32),
                   jax.ShapeDtypeStruct((b, hkv, g, d), jnp.float32)],
        compiler_params=jkc.compiler_params(
            dimension_semantics=('parallel', 'arbitrary')),
        interpret=True,
    )(*_j(pages, pos, q, pk, pv, mask))
    return [np.asarray(x) for x in out]


def _shared_run_case(which):
    """(q (B, Hkv, G, D), pools, pages, pos, mask) of a shared run.
    'engine': build_shared_runs' 3-slot run padded to 4 slots by a
    quarantine slot, row 4 sharing nothing (masked at every slot).
    'random': 9 slots, the last a quarantine padding slot, random
    participation; row 2 masked at every slot, row 3 joining at slot 3."""
    if which == 'engine':
        q, pk, pv, pt, lengths = _shared_setup(b=5, seed=12)
        pt[4] = np.arange(40, 50)
        runs = tprefix.build_shared_runs(pt, lengths, 4)
        assert runs['n_slots'] == 3 and not runs['mask'][4].any()
        return (q.reshape(5, 2, 2, 32), pk, pv, runs['pages'][:4],
                runs['pos'][:4], runs['mask'][:, :4])
    rng = np.random.default_rng(21)
    b, hkv, g, d, pg, n_pages, s = 5, 2, 3, 32, 4, 40, 9
    q = (rng.normal(size=(b, hkv, g, d)) * 0.5).astype(np.float32)
    pk = (rng.normal(size=(n_pages, pg, hkv, d)) * 0.5).astype(np.float32)
    pv = (rng.normal(size=(n_pages, pg, hkv, d)) * 0.5).astype(np.float32)
    pages = np.append(rng.permutation(n_pages - 1)[:s - 1] + 1,
                      tprefix.QUARANTINE_PAGE).astype(np.int32)
    mask = (rng.random((b, s)) < 0.6).astype(np.float32)
    mask[:, -1] = 0.0
    mask[2] = 0.0
    mask[3, :3], mask[3, 3:-1] = 0.0, 1.0
    return q, pk, pv, pages, np.arange(s, dtype=np.int32), mask


@pytest.mark.parametrize('sps', [1, 2, 3, 'all'])
@pytest.mark.parametrize('which', ['engine', 'random'])
def test_split_shared_run_matches_the_serial_run_and_pallas(which, sps):
    """K2's algorithm -- each split's slots walked from the empty state,
    the partial states merged in split order -- equals the serial run and
    the JAX package's phase-1 kernel (interpret mode) to the state
    tolerance, over padded quarantine slots, rows masked at every slot
    (they keep m = NEG_INF and their garbage mass) and a row joining late.
    With one split it is the serial run bit for bit."""
    q, pk, pv, pages, pos, mask = _shared_run_case(which)
    n_slots = pages.shape[0]
    got = shared_run_split_ref(
        *_t(q, pk, pv, pages, mask),
        slots_per_split=n_slots if sps == 'all' else sps)
    serial = shared_run_ref(*_t(q, pk, pv, pages, mask))
    masked = ~mask.any(axis=1)
    assert masked.any() and (got[0][masked] == tprefix.NEG_INF).all()
    for a, b in zip(got, serial):
        torch.testing.assert_close(a, b, **STATE_TOL)
        if sps == 'all':
            assert torch.equal(a, b)
    want = _pallas_shared_run(q, pk, pv, pages, pos, mask)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, **STATE_TOL)
    # K3 from the split state gives the stock walk's output
    if which == 'engine':
        qs, pks, pvs, pt, lengths = _shared_setup(b=5, seed=12)
        pt[4] = np.arange(40, 50)
        runs = tprefix.build_shared_runs(pt, lengths, 4)
        out = tops.shared_tail(*_t(q, pk, pv, runs['tail_pt'],
                                   runs['start'], lengths), got)
        torch.testing.assert_close(out, paged_decode_ref(
            *_t(q, pk, pv, pt, lengths)), **TOL)


def test_split_shared_run_reads_out_of_range_pages_as_quarantine():
    """A slot's page id outside [0, P) reads the quarantine page 0, as the
    CUDA kernel does."""
    q, pk, pv, pages, _, mask = _shared_run_case('random')
    bad = pages.copy()
    bad[1], bad[4] = pk.shape[0] + 2, -3
    fixed = pages.copy()
    fixed[1] = fixed[4] = 0
    for sps in (2, pages.shape[0]):
        got = shared_run_split_ref(*_t(q, pk, pv, bad, mask),
                                   slots_per_split=sps)
        for a, b in zip(got, shared_run_ref(*_t(q, pk, pv, fixed, mask))):
            torch.testing.assert_close(a, b, **STATE_TOL)


@pytest.mark.parametrize('shape', [
    # (Hkv, slots, page size)
    (8, 4, 16),          # phase 3's and the short drain's run
    (8, 8, 16),          # 128 tokens: still one split
    (8, 9, 16),
    (8, 16, 16),         # the long drain's bucket
    (8, 32, 16),
    (1, 1, 16),
    (2, 5, 4),
    (8, 0, 16),          # no slot at all
    (4, 200, 1),
    (1, 3, 128),
])
def test_plan_shared_splits_covers_every_slot_once(shape):
    """The splits' slot ranges cover every slot exactly once, in order; a
    split never holds more than SPLIT_TOKENS tokens and none is empty; a
    run of at most SPLIT_TOKENS tokens is one split."""
    hkv, n_slots, pg = shape
    sps, n_splits = tops.plan_shared_splits(hkv, n_slots, pg, H100_SMS)
    assert sps * pg <= tops.SPLIT_TOKENS
    assert (n_splits - 1) * sps < max(n_slots, 1) <= n_splits * sps
    covered = [js for s in range(n_splits)
               for js in range(s * sps, min((s + 1) * sps, n_slots))]
    assert covered == list(range(n_slots))
    assert (n_splits == 1) == (n_slots * pg <= tops.SPLIT_TOKENS)
