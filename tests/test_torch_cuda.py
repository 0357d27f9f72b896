"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one.  The file imports
neither jax nor the JAX package, so it runs on a machine that has only the
port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: bf16 attention outputs, elementwise |got - want| <= 1e-3 +
2^-7 |want| (one bf16 ulp: a correct kernel may round the other way;
``test_torch_kernels_paged.py`` shows it fails a dropped page, a shifted
start and a skipped initial state); the f32 partial softmax state, 1e-4; sampled
tokens equal unless the two best f32 scores lie within 1e-5 of |max| (the
kernel sums the dot products on the tensor cores, in another order than its
plain version), and exactly equal where a winner is planted or tied;
flash attention, the bf16 rule above and 2e-5 in f32; WKV6, 1e-4 in f32
(1e-3 at log-decays down to -12 and w = 0), 3e-2 for bf16 inputs, as in
the reference's kernel tests.
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch.kernels.common import LAUNCHES, gumbel_hash_noise, sm_count
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.paged_attention import ops as pa
from repro_torch.kernels.paged_attention.prefix import build_shared_runs
from repro_torch.kernels.paged_attention.ref import (paged_decode_ref,
                                                     shared_run_ref,
                                                     shared_run_split_ref)
from repro_torch.kernels.rwkv6.ops import wkv6
from repro_torch.kernels.rwkv6.ref import (wkv6_chunked, wkv6_ref,
                                           wkv6_tiled_ref)
from repro_torch.kernels.sampling import ops as sops
from repro_torch.kernels.sampling.ops import (fused_unembed_sample,
                                              unembed_argmax_block)
from repro_torch.kernels.sampling.ref import (unembed_sample_ref,
                                              unembed_scores)

pytestmark = pytest.mark.cuda

BF16_TOL = dict(rtol=2 ** -7, atol=1e-3)
STATE_TOL = dict(rtol=1e-4, atol=1e-4)

PAGED_CASES = [
    # (B, Hq, Hkv, D, pg, maxp)
    (2, 4, 4, 64, 16, 4),
    (2, 8, 2, 64, 16, 8),
    (8, 16, 8, 128, 16, 32),          # qwen3-0.6b decode
    (3, 4, 1, 32, 8, 5),
    (2, 4, 2, 64, 4, 16),
    (8, 16, 8, 128, 16, 256),         # a long context: 4096 tokens a row
]
FLASH_CASES = [
    # (B, Sq, Skv, Hq, Hkv, D, causal, dtype)
    (1, 128, 128, 4, 4, 64, True, torch.float32),
    (2, 256, 256, 8, 2, 64, True, torch.float32),
    (1, 128, 128, 4, 1, 128, True, torch.bfloat16),
    (2, 192, 192, 4, 2, 32, True, torch.float32),
    (1, 64, 256, 2, 2, 64, False, torch.float32),
    (2, 100, 100, 4, 4, 64, True, torch.float32),
    (1, 300, 200, 4, 2, 128, True, torch.bfloat16),    # Sq > Skv
    (2, 1024, 1024, 16, 8, 128, True, torch.bfloat16),  # qwen3-0.6b
    # the tensor-core kernel: D=64 and 128 at G = 1, 2, 8
    (2, 256, 256, 8, 8, 64, True, torch.bfloat16),
    (1, 256, 256, 8, 4, 64, True, torch.bfloat16),
    (1, 384, 384, 8, 1, 64, True, torch.bfloat16),
    (1, 256, 256, 8, 8, 128, True, torch.bfloat16),
    (1, 256, 256, 8, 1, 128, True, torch.bfloat16),
    (2, 1000, 1000, 16, 8, 128, True, torch.bfloat16),  # Sq off the tile
    (1, 200, 300, 4, 2, 64, True, torch.bfloat16),      # Sq < Skv
    (1, 256, 1024, 16, 8, 128, False, torch.bfloat16),  # cross, non-causal
    (1, 2048, 2048, 16, 8, 128, True, torch.bfloat16),
    (1, 4096, 4096, 16, 8, 128, True, torch.bfloat16),
    (1, 128, 128, 4, 2, 32, True, torch.bfloat16),      # D=32: the FMA kernel
    (1, 50, 50, 4, 2, 128, True, torch.bfloat16),       # shorter than a tile
    (2, 1, 1, 8, 8, 64, True, torch.bfloat16),          # one token
]
WKV_CASES = [
    # (B, T, H, K, chunk, dtype[, V, lowest log-decay]); V = K and log-decays
    # down to -2.5 unless given
    (2, 64, 2, 16, 16, torch.float32),
    (1, 128, 4, 32, 32, torch.float32),
    (2, 100, 2, 16, 32, torch.float32),
    (1, 64, 2, 64, 16, torch.bfloat16),
    (3, 48, 1, 16, 64, torch.float32),
    (2, 1000, 40, 64, 64, torch.float32),             # rwkv6-3b heads
    (2, 1, 3, 64, 64, torch.float32),                 # one token
    (2, 77, 3, 64, 64, torch.float32, 40),            # V off the value block
    (1, 45, 2, 32, 16, torch.bfloat16, 100),          # two value blocks, bf16
    (2, 200, 4, 64, 64, torch.float32, 64, -12.0),    # see _wkv_inputs
    # a rank's value block of every head (rwkv6-3b's 40 heads on 16 ranks:
    # V = 4; 3 heads of V = 8): mostly padding in each CTA, unaligned loads
    (2, 200, 40, 64, 64, torch.float32, 4),
    (1, 77, 3, 64, 64, torch.float32, 8),
]
SAMPLE_CASES = [
    # (B, D, V): ragged vocab tiles, two launches' worth of rows, and the
    # qwen3-0.6b head
    (1, 32, 257), (4, 64, 1000), (5, 32, 130), (20, 64, 1000),
    (8, 1024, 151936),
]
SAMPLE_BATCHES = [1, 7, 8, 9, 16, 20]    # wgmma N = 8 and 16, two launches


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the CUDA kernels run only there')
    return torch.device('cuda')


def _bf16(dev, rng, *shape, scale=0.5):
    return torch.tensor(rng.normal(size=shape) * scale, dtype=torch.bfloat16,
                        device=dev)


def _paged_inputs(dev, case, seed):
    b, hq, hkv, d, pg, maxp = case
    rng = np.random.default_rng(seed)
    n_pages = b * maxp + 1
    q = _bf16(dev, rng, b, hkv, hq // hkv, d)
    pk = _bf16(dev, rng, n_pages, pg, hkv, d)
    pv = _bf16(dev, rng, n_pages, pg, hkv, d)
    pt = (rng.permutation(n_pages - 1)[:b * maxp] + 1).reshape(b, maxp)
    lengths = rng.integers(1, maxp * pg + 1, size=b)
    return (q, pk, pv, torch.tensor(pt, dtype=torch.int32, device=dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


@pytest.mark.parametrize('case', PAGED_CASES)
def test_paged_decode_matches_plain(cuda, case):
    q, pk, pv, pt, lengths = _paged_inputs(cuda, case, sum(case))
    before = LAUNCHES['paged_decode']
    got = pa.paged_decode(q, pk, pv, pt, lengths)
    torch.cuda.synchronize()
    assert LAUNCHES['paged_decode'] == before + 1
    want = paged_decode_ref(q, pk, pv, pt, lengths)
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)


def test_paged_decode_padding_rows_stay_in_the_pool(cuda):
    """The engine's padding rows (length 1, all-quarantine tables) read the
    quarantine page's first token and nothing else."""
    q, pk, pv, pt, lengths = _paged_inputs(cuda, PAGED_CASES[1], 1)
    pt[1] = 0
    lengths[1] = 1
    got = pa.paged_decode(q, pk, pv, pt, lengths)
    want = paged_decode_ref(q, pk, pv, pt, lengths)
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
    torch.testing.assert_close(got[1].float(),
                               pv[0, 0][:, None].expand_as(got[1]).float(),
                               **BF16_TOL)


def _split_len(case):
    """Tokens in one split of the walk for a case's shape."""
    b, hq, hkv, d, pg, maxp = case
    return pa.plan_splits(b, hkv, maxp, pg, sm_count('cuda'))[0] * pg


@pytest.mark.parametrize('what', ['split_boundary', 'all_length_1',
                                  'page_out_of_range'])
def test_paged_decode_split_edges(cuda, what):
    """Rows ending exactly on a split boundary (and one token either side),
    every row of length 1, and a live page id outside the pool (read as the
    quarantine page 0): the split walk equals the plain version."""
    case = PAGED_CASES[2]
    q, pk, pv, pt, lengths = _paged_inputs(cuda, case, 11)
    n_pages = pk.shape[0]
    split = _split_len(case)
    if what == 'split_boundary':
        lengths = torch.tensor([split, split - 1, split + 1, 2 * split, 1,
                                2 * split + 1, 3 * split, case[4] * case[5]],
                               dtype=torch.int32, device=cuda)
    elif what == 'all_length_1':
        lengths = torch.ones_like(lengths)
    else:
        lengths[:] = case[4] * case[5]
        pt[0, 3] = n_pages + 5
        pt[1, 0] = -2
    got = pa.paged_decode(q, pk, pv, pt, lengths)
    clamped = torch.where((pt >= 0) & (pt < n_pages), pt, 0)
    want = paged_decode_ref(q, pk, pv, clamped, lengths)
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
    if what == 'page_out_of_range':
        assert not torch.equal(want, paged_decode_ref(q, pk, pv, pt.clamp(
            0, n_pages - 1), lengths))      # the quarantine page did count


def test_shared_tail_from_a_state_with_empty_splits(cuda):
    """K3 resumed from a non-empty state over tails that leave most splits
    empty (and one row with no tail at all): the state and the live splits
    merge in order, as the plain version walks them."""
    case = PAGED_CASES[2]
    b, hq, hkv, d, pg, maxp = case
    q, pk, pv, pt, _ = _paged_inputs(cuda, case, 12)
    rng = np.random.default_rng(12)
    g = hq // hkv
    state = (torch.tensor(rng.normal(size=(b, hkv, g)), dtype=torch.float32,
                          device=cuda),
             torch.tensor(rng.uniform(1, 20, size=(b, hkv, g)),
                          dtype=torch.float32, device=cuda),
             torch.tensor(rng.normal(size=(b, hkv, g, d)) * 3,
                          dtype=torch.float32, device=cuda))
    start = torch.tensor([4, 4, 0, 8, 4, 2, 4, 4], dtype=torch.int32,
                         device=cuda)
    lengths = torch.tensor([4 * pg, 4 * pg + 1, 3, 20 * pg, 6 * pg + 7,
                            2 * pg + 1, 5 * pg, 4 * pg + pg],
                           dtype=torch.int32, device=cuda)
    got = pa.shared_tail(q, pk, pv, pt, start, lengths, state)
    want = paged_decode_ref(q, pk, pv, pt, lengths, start=start, state=state)
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)


def test_new_kernels_are_deterministic(cuda):
    """Two calls on the same inputs give the same bits: the split walk's
    and the split shared run's combines merge in a fixed order, K4's
    partials reduce in a fixed order, and no kernel uses float atomics."""
    q, pk, pv, pt, lengths = _paged_inputs(cuda, PAGED_CASES[-1], 13)
    assert torch.equal(pa.paged_decode(q, pk, pv, pt, lengths),
                       pa.paged_decode(q, pk, pv, pt, lengths))
    rng = np.random.default_rng(13)
    q, k, v = (torch.tensor(rng.normal(size=(2, 1000, h, 128)) * 0.5,
                            dtype=torch.bfloat16, device=cuda)
               for h in (16, 8, 8))
    assert torch.equal(flash_attention(q, k, v), flash_attention(q, k, v))
    q, pk, pv, pages, mask = _shared_run_inputs(cuda, 16, 13)[:5]
    assert all(torch.equal(a, b) for a, b in zip(
        pa.shared_run(q, pk, pv, pages, mask),
        pa.shared_run(q, pk, pv, pages, mask)))
    gen = torch.Generator(device=cuda).manual_seed(13)
    last = torch.randn((9, 1024), generator=gen, device=cuda).to(torch.bfloat16)
    head = (torch.randn((151936, 1024), generator=gen, device=cuda)
            * 1024 ** -0.5).to(torch.bfloat16)
    assert torch.equal(fused_unembed_sample(last, head, 3, temperature=0.8),
                       fused_unembed_sample(last, head, 3, temperature=0.8))


@pytest.mark.parametrize('n_slots_cap', [4, 8])
def test_prefix_shared_matches_plain(cuda, n_slots_cap):
    """A shared 3-page prefix, one row that shares nothing, quarantine
    padding slots up to a power of two: K2's partial state and K3's output
    equal their plain versions."""
    rng = np.random.default_rng(6)
    b, hkv, g, d, pg, maxp = 5, 2, 4, 64, 4, 10
    n_pages = b * maxp + 4
    q = _bf16(cuda, rng, b, hkv, g, d)
    pk = _bf16(cuda, rng, n_pages, pg, hkv, d)
    pv = _bf16(cuda, rng, n_pages, pg, hkv, d)
    pt = np.arange(4, 4 + b * maxp, dtype=np.int32).reshape(b, maxp)
    pt[:4, :3] = [1, 2, 3]
    lengths = rng.integers(3 * pg + 1, maxp * pg + 1, size=b).astype(np.int32)
    runs = build_shared_runs(pt, lengths, pg)
    assert runs['n_slots'] == 3 and runs['start'][4] == 0

    def t(x, dtype=torch.int32):
        return torch.tensor(x, dtype=dtype, device=cuda)

    pages = t(runs['pages'][:n_slots_cap])
    mask = t(runs['mask'][:, :n_slots_cap], torch.float32)
    state = pa.shared_run(q, pk, pv, pages, mask)
    want_state = shared_run_ref(q, pk, pv, pages, mask)
    for got, want in zip(state, want_state):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    args = (t(runs['tail_pt']), t(runs['start']), t(lengths))
    got = pa.shared_tail(q, pk, pv, *args, state)
    want = paged_decode_ref(q, pk, pv, args[0], args[2], start=args[1],
                            state=want_state)
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
    full = paged_decode_ref(q, pk, pv, t(pt), t(lengths))
    torch.testing.assert_close(got.float(), full.float(), **BF16_TOL)


def _shared_run_inputs(dev, n_slots, seed):
    """qwen3-0.6b decode widths (B=8, Hkv=8, G=2, D=128, page 16): rows
    0..6 share an (n_slots - 1)-page prefix, the run is padded to n_slots
    by a quarantine slot, row 7 shares nothing (masked at every slot)."""
    b, hkv, g, d, pg = 8, 8, 2, 128, 16
    maxp = n_slots + 4
    rng = np.random.default_rng(seed)
    n_pages = 1 + b * maxp
    q = _bf16(dev, rng, b, hkv, g, d)
    pk, pv = _bf16(dev, rng, n_pages, pg, hkv, d), _bf16(dev, rng, n_pages,
                                                         pg, hkv, d)
    pt = (rng.permutation(n_pages - 1) + 1).reshape(b, maxp).astype(np.int32)
    pt[:b - 1, :n_slots - 1] = pt[0, :n_slots - 1]
    lengths = rng.integers((n_slots - 1) * pg + 1, maxp * pg + 1,
                           size=b).astype(np.int32)
    runs = build_shared_runs(pt, lengths, pg)
    assert runs['n_slots'] == n_slots - 1 and not runs['mask'][b - 1].any()

    def t(x, dtype=torch.int32):
        return torch.tensor(x, dtype=dtype, device=dev)
    return (q, pk, pv, t(runs['pages'][:n_slots]),
            t(runs['mask'][:, :n_slots], torch.float32), t(runs['tail_pt']),
            t(runs['start']), t(lengths), t(pt))


@pytest.mark.parametrize('n_slots', [4, 8, 16, 32])
def test_shared_run_splits_match_both_plain_versions(cuda, n_slots):
    """K2 over runs of 4 and 8 slots (one CTA a kv-head) and of 16 and 32
    (the slots split over CTAs, then the combine): its state equals the
    serial plain version and the split one, a row masked at every slot
    keeps m = -1e30, and K2 -> K3 equals the stock walk over the full
    tables."""
    q, pk, pv, pages, mask, tail_pt, start, lengths, pt = \
        _shared_run_inputs(cuda, n_slots, n_slots)
    sps, n_splits = pa.plan_shared_splits(8, n_slots, 16, sm_count('cuda'))
    assert (n_splits > 1) == (n_slots * 16 > pa.SPLIT_TOKENS)
    before = LAUNCHES['shared_run']
    state = pa.shared_run(q, pk, pv, pages, mask)
    torch.cuda.synchronize()
    assert LAUNCHES['shared_run'] == before + 1
    assert (state[0][7] == -1e30).all()
    for want in (shared_run_ref(q, pk, pv, pages, mask),
                 shared_run_split_ref(q, pk, pv, pages, mask,
                                      slots_per_split=sps)):
        for got, w in zip(state, want):
            torch.testing.assert_close(got, w, **STATE_TOL)
    out = pa.shared_tail(q, pk, pv, tail_pt, start, lengths, state)
    torch.testing.assert_close(out.float(), paged_decode_ref(
        q, pk, pv, pt, lengths).float(), **BF16_TOL)


@pytest.mark.parametrize('b, g, n_slots', [(64, 2, 4), (100, 2, 16),
                                            (64, 8, 8)])
def test_shared_run_blocks_many_rows_over_ctas(cuda, b, g, n_slots):
    """K2 past one CTA's 32 query rows (B x G up to 512, in row blocks),
    at D = 128 and page 16: its state equals both plain versions, the last
    row (sharing nothing) keeps m = -1e30, and two calls are bit-equal."""
    rng = np.random.default_rng(b + n_slots)
    hkv, d, pg = 2, 128, 16
    q = _bf16(cuda, rng, b, hkv, g, d)
    pk = _bf16(cuda, rng, 1 + n_slots, pg, hkv, d)
    pv = _bf16(cuda, rng, 1 + n_slots, pg, hkv, d)
    pages = torch.arange(1, 1 + n_slots, dtype=torch.int32, device=cuda)
    mask = torch.tensor(rng.random((b, n_slots)) < 0.8, dtype=torch.float32,
                        device=cuda)
    mask[b - 1] = 0.0
    sps = pa.plan_shared_splits(hkv, n_slots, pg, sm_count('cuda'))[0]
    state = pa.shared_run(q, pk, pv, pages, mask)
    assert (state[0][b - 1] == -1e30).all()
    for want in (shared_run_ref(q, pk, pv, pages, mask),
                 shared_run_split_ref(q, pk, pv, pages, mask,
                                      slots_per_split=sps)):
        for got, w in zip(state, want):
            torch.testing.assert_close(got, w, **STATE_TOL)
    for got, again in zip(state, pa.shared_run(q, pk, pv, pages, mask)):
        assert torch.equal(got, again)


@pytest.mark.parametrize('case', FLASH_CASES)
def test_flash_attention_matches_plain(cuda, case):
    b, sq, skv, hq, hkv, d, causal, dtype = case
    rng = np.random.default_rng(sq + skv + d)
    q, k, v = (torch.tensor(rng.normal(size=(b, s, h, d)) * 0.5, dtype=dtype,
                            device=cuda)
               for s, h in ((sq, hq), (skv, hkv), (skv, hkv)))
    before = LAUNCHES['flash_attention']
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert LAUNCHES['flash_attention'] == before + 1
    assert got.dtype == dtype
    want = flash_attention_ref(q, k, v, causal=causal)
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
    else:
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def _wkv_inputs(dev, case, seed, decay_lo=-2.5):
    """Inputs of a WKV_CASES entry.  A case whose log-decays reach -12 also
    gets rows of w = 1e-30 and w = 0 (sub-blocks past any f32 envelope of a
    cumulative-decay factorisation)."""
    b, t, h, dk, _, dtype = case[:6]
    dv = case[6] if len(case) > 6 else dk
    decay_lo = case[7] if len(case) > 7 else decay_lo
    rng = np.random.default_rng(seed)
    xs = [rng.normal(size=(b, t, h, dk)) * 0.5 for _ in range(2)]
    xs.append(rng.normal(size=(b, t, h, dv)) * 0.5)
    w = np.exp(rng.uniform(decay_lo, -0.005, size=(b, t, h, dk)))
    if len(case) > 7:
        w[0, 3:7] = 1e-30
        w[-1, t // 2:t // 2 + 3] = 0.0
    xs.append(w)
    xs.append(rng.normal(size=(h, dk)) * 0.3)
    s0 = rng.normal(size=(b, h, dk, dv)) * 0.1
    return ([torch.tensor(x, dtype=dtype, device=dev) for x in xs]
            + [torch.tensor(s0, dtype=torch.float32, device=dev)])


@pytest.mark.parametrize('case', WKV_CASES)
def test_wkv6_matches_plain(cuda, case):
    """Against the recurrence and the kernel's tiled plain model; against
    the chunked form too, where its decays stay inside its envelope."""
    xs = _wkv_inputs(cuda, case, sum(case[:5]))
    before = LAUNCHES['wkv6']
    y, s = wkv6(*xs, chunk=case[4])
    torch.cuda.synchronize()
    assert LAUNCHES['wkv6'] == before + 1
    assert y.dtype == case[5] and s.dtype == torch.float32
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    f32 = [x.float() for x in xs]
    decaying = len(case) > 7
    tol = 3e-2 if case[5] == torch.bfloat16 else 1e-3 if decaying else 1e-4
    wants = [wkv6_ref(*f32), wkv6_tiled_ref(*f32)]
    if not decaying:
        wants.append(wkv6_chunked(*f32, chunk=case[4]))
    for want in wants:
        torch.testing.assert_close(y.float(), want[0], rtol=tol, atol=tol)
        torch.testing.assert_close(s, want[1], rtol=tol, atol=tol)


def test_wkv6_pathological_decay(cuda):
    xs = _wkv_inputs(cuda, (1, 64, 2, 16, 8, torch.float32), 3,
                     decay_lo=-12.0)
    y, s = wkv6(*xs, chunk=8)
    want = wkv6_ref(*xs)
    assert torch.isfinite(y).all()
    torch.testing.assert_close(y, want[0], rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(s, want[1], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize('case', SAMPLE_CASES)
@pytest.mark.parametrize('temperature', [0.0, 0.8])
def test_unembed_sample_matches_plain(cuda, case, temperature):
    b, d, v = case
    rng = np.random.default_rng(sum(case))
    last = _bf16(cuda, rng, b, d, scale=1.0)
    head = _bf16(cuda, rng, v, d, scale=d ** -0.5)
    before = LAUNCHES['unembed_sample']
    got = fused_unembed_sample(last, head, 5, temperature=temperature)
    torch.cuda.synchronize()
    assert LAUNCHES['unembed_sample'] == before + -(-b // 16)
    want = unembed_sample_ref(last, head, 5, temperature=temperature)
    s = unembed_scores(last, head)
    if temperature > 0:
        s = s / temperature + gumbel_hash_noise(
            5, torch.arange(b, device=cuda)[:, None],
            torch.arange(v, device=cuda)[None, :])
    rows = torch.arange(b, device=cuda)
    gap = (s[rows, want.long()] - s[rows, got.long()]).abs()
    assert ((got == want) | (gap <= 1e-5 * s.abs().amax(-1))).all()


def test_unembed_sample_first_occurrence_across_tiles(cuda):
    last = torch.ones(2, 16, dtype=torch.bfloat16, device=cuda)
    head = torch.zeros(300, 16, dtype=torch.bfloat16, device=cuda)
    head[[40, 200, 299]] = 1.0
    assert fused_unembed_sample(last, head).tolist() == [40, 40]


def _range_edges(vocab):
    """Every persistent CTA's first and last vocab row, and V - 1."""
    rows = sops.plan_vocab_ranges(vocab, sm_count('cuda'))
    n_ctas = -(-vocab // rows)
    return rows, sorted({c * rows for c in range(n_ctas)}
                        | {min((c + 1) * rows, vocab) - 1
                           for c in range(n_ctas)} | {vocab - 1})


def _plant(head, last, idx, rows_of):
    """Head rows ``idx`` set to ``last[rows_of]`` scaled to score ~64 for
    their own batch row, against a field of N(0, 1) scores."""
    lf = last[rows_of].float()
    head[idx] = (lf * (64.0 / lf.pow(2).sum(-1, keepdim=True))).to(head.dtype)


@pytest.mark.parametrize('b', SAMPLE_BATCHES)
@pytest.mark.parametrize('temperature', [0.0, 0.8])
def test_unembed_sample_planted_winners_at_range_edges(cuda, b, temperature):
    """Each batch row's winner planted at a different CTA range edge (first
    or last row of a CTA's range, or V - 1): the kernel and its plain
    version both find it, at both temperatures, in one launch per 16
    rows."""
    d, v = 256, 20000
    rng = np.random.default_rng(b)
    last = _bf16(cuda, rng, b, d, scale=1.0)
    head = _bf16(cuda, rng, v, d, scale=d ** -0.5)
    _, edges = _range_edges(v)
    idx = [edges[(j * len(edges)) // b] for j in range(b - 1)] + [v - 1]
    _plant(head, last, torch.tensor(idx, device=cuda),
           torch.arange(b, device=cuda))
    before = LAUNCHES['unembed_sample']
    got = fused_unembed_sample(last, head, 4, temperature=temperature)
    torch.cuda.synchronize()
    assert LAUNCHES['unembed_sample'] == before + -(-b // 16)
    assert got.tolist() == idx
    assert unembed_sample_ref(last, head, 4,
                              temperature=temperature).tolist() == idx


@pytest.mark.parametrize('b', SAMPLE_BATCHES)
def test_unembed_sample_exact_ties_across_ctas_go_to_the_first(cuda, b):
    """Row j's winner planted twice, the same bits at two indices in two
    CTAs' ranges: the kernel returns the lower index."""
    d, v = 256, 20000
    rng = np.random.default_rng(100 + b)
    last = _bf16(cuda, rng, b, d, scale=1.0)
    head = _bf16(cuda, rng, v, d, scale=d ** -0.5)
    rows, _ = _range_edges(v)
    lo = [rows * (2 + 5 * (j % 20)) + (j * 13) % rows for j in range(b)]
    hi = [rows * (4 + 5 * (j % 20)) + (j * 29) % rows for j in range(b)]
    src = torch.arange(b, device=cuda)
    _plant(head, last, torch.tensor(hi, device=cuda), src)
    _plant(head, last, torch.tensor(lo, device=cuda), src)
    assert fused_unembed_sample(last, head).tolist() == lo


def _block_pick(last, head, n, seed, temperature, row0=0):
    """K4 over n equal column blocks of ``head`` (copies, as a rank holds
    its block), combined: the larger value, ties to the lower column."""
    from repro_torch.kernels.sampling.ref import combine_bests

    v = head.shape[0]
    parts = [unembed_argmax_block(last, head[c0:c0 + v // n].contiguous(),
                                  seed, temperature=temperature, row0=row0,
                                  col0=c0)
             for c0 in range(0, v, v // n)]
    return combine_bests(torch.stack([p[0] for p in parts]),
                         torch.stack([p[1] for p in parts]))


@pytest.mark.parametrize('v,d,n', [(151936, 1024, 2), (151936, 1024, 4),
                                   (32064, 4096, 2)],
                         ids=['qwen3-2', 'qwen3-4', 'phi3.5-2'])
@pytest.mark.parametrize('temperature', [0.0, 0.8])
def test_unembed_block_combine_is_bit_equal_to_the_whole_head(
        cuda, v, d, n, temperature):
    """K4 over n blocks of qwen3-0.6b's and phi3.5-moe's heads (V / n:
    blocks that start inside a whole-head tile at 151936 / 4) plus the
    combine picks the whole head's K4 tokens bit for bit, with an exact
    tie planted across a block boundary; equal to the plain block version;
    rows from row0 = 3 draw the whole batch's noise."""
    from repro_torch.kernels.sampling.ref import unembed_argmax_block_ref

    b = 8
    rng = np.random.default_rng(n)
    last = _bf16(cuda, rng, b, d, scale=1.0)
    head = _bf16(cuda, rng, v, d, scale=d ** -0.5)
    edge = v // n
    # rows 0 and 1: winners just before the first block edge, the same
    # bits again just past it
    _plant(head, last, torch.tensor([edge - 1, edge - 2], device=cuda),
           torch.tensor([0, 1], device=cuda))
    head[edge] = head[edge - 1]
    head[edge + 5] = head[edge - 2]
    whole = fused_unembed_sample(last, head, 7, temperature=temperature)
    got = _block_pick(last, head, n, 7, temperature)
    assert torch.equal(got, whole)
    if temperature == 0.0:
        assert got[:2].tolist() == [edge - 1, edge - 2]
    plain = [unembed_argmax_block_ref(last, head[c0:c0 + edge], 7,
                                      temperature=temperature, col0=c0)
             for c0 in range(0, v, edge)]
    kern = [unembed_argmax_block(last, head[c0:c0 + edge].contiguous(), 7,
                                 temperature=temperature, col0=c0)
            for c0 in range(0, v, edge)]
    for (pv, pi), (kv, ki) in zip(plain, kern):
        same = pi == ki
        gap = (pv - kv).abs() <= 1e-5 * pv.abs().clamp_min(1.0)
        assert (same | gap).all()
    sub = _block_pick(last[3:], head, n, 7, temperature, row0=3)
    assert torch.equal(sub, whole[3:])


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q, pk, pv, pt, lengths = _paged_inputs(cuda, PAGED_CASES[1], 0)
    with pytest.raises(ValueError, match='dtype'):
        pa.paged_decode(q.float(), pk, pv, pt, lengths)
    with pytest.raises(ValueError, match='dtype'):
        pa.paged_decode(q, pk, pv, pt.long(), lengths)
    with pytest.raises(ValueError, match='contiguous'):
        pa.paged_decode(q, pk, pv, pt.T.contiguous().T, lengths)
    with pytest.raises(ValueError, match='on'):
        pa.paged_decode(q, pk.cpu(), pv, pt, lengths)
    last = torch.zeros(2, 64, dtype=torch.bfloat16, device=cuda)
    head = torch.zeros(100, 64, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match='row-major'):
        fused_unembed_sample(last, head.T.contiguous().T)
    with pytest.raises(ValueError, match='dtype'):
        fused_unembed_sample(last.float(), head)
    for d in (12, 4104):          # TMA rows of 16-byte multiples; `last` fits
        odd = torch.zeros(2, d, dtype=torch.bfloat16, device=cuda)
        with pytest.raises(ValueError, match='kernel takes'):
            fused_unembed_sample(odd, torch.zeros(100, d, dtype=torch.bfloat16,
                                                  device=cuda))
    # K2: D / 8 must divide its 512 threads
    pool = torch.zeros(2, 16, 1, 24, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match='head dim'):
        pa.shared_run(torch.zeros(1, 1, 1, 24, dtype=torch.bfloat16,
                                  device=cuda), pool, pool,
                      torch.ones(1, dtype=torch.int32, device=cuda),
                      torch.ones(1, 1, device=cuda))
    q = torch.zeros(1, 64, 4, 64, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match='dtype'):
        flash_attention(q, q.float(), q)
    with pytest.raises(ValueError, match='head dim'):
        flash_attention(q[..., :48].contiguous(), q[..., :48].contiguous(),
                        q[..., :48].contiguous())
    with pytest.raises(RuntimeError, match='no backward'):
        flash_attention(q.float().requires_grad_(), q.float(), q.float())
    xs = _wkv_inputs(cuda, WKV_CASES[0], 0)
    with pytest.raises(ValueError, match='dtype'):
        wkv6(*xs[:5], xs[5].double())
    with pytest.raises(ValueError, match='K = '):
        wkv6(*[x[..., :8].contiguous() for x in xs[:5]],
             xs[5][:, :, :8, :8].contiguous())


def test_engine_decodes_through_the_kernels(cuda):
    """An engine on the card with the defaults (decode_kernel=None) and the
    fused, prefix-shared options launches all four decode kernels, and
    neither prefill nor rwkv6 kernel."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.memory import MemoryPlane
    from repro_torch.models.api import build_model
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.serving.kvpool import KVPool

    cfg = reduced(get_config('qwen3-0.6b'), page_size=16, head_dim=64)
    model = build_model(cfg)
    params = model.init_params(0, device=cuda)
    pool = KVPool(16, 4, page_size=16, reserved_handles=1)
    MemoryPlane(pool, sharing=True)
    eng = Engine(model, params, pool,
                 EngineConfig(max_batch=4, max_seq=96, prefill_chunk=32,
                              fused_sampling=True,
                              prefix_shared_attention=True))
    prompt = np.random.default_rng(0).integers(1, cfg.vocab_size, 48).tolist()
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    rids = [eng.submit(prompt, max_new_tokens=8)]
    for _ in range(20):
        eng.step()
        if len(eng.requests[rids[0]].generated) >= 2:
            break
    rids += [eng.submit(prompt, max_new_tokens=8) for _ in range(2)]
    eng.run_to_completion()
    outs = [eng.output_tokens(r) for r in rids]
    assert all(len(o) == 8 and 0 <= min(o) and max(o) < cfg.vocab_size
               for o in outs)
    assert eng.stats.shared_page_reads_saved > 0
    decode = ('paged_decode', 'shared_run', 'shared_tail', 'unembed_sample')
    assert all(LAUNCHES[k] > 0 for k in decode), LAUNCHES
    assert LAUNCHES['flash_attention'] == LAUNCHES['wkv6'] == 0, LAUNCHES


def test_prefill_and_rwkv6_forward_run_through_the_kernels(cuda):
    """Reduced configs on the card: prefill launches K5 once per layer and
    agrees with the plain path; the rwkv6 loss launches K6 once per layer
    and agrees with the plain chunked path."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.api import build_model

    cfg = reduced(get_config('qwen3-0.6b'), page_size=16, head_dim=64)
    model = build_model(cfg)
    params = model.init_params(0, device=cuda).to(torch.float32)
    b, s = 2, 256
    tokens = torch.randint(0, cfg.vocab_size, (b, s), device=cuda)
    batch = {'tokens': tokens, 'page_table': torch.arange(
        1, 1 + b * s // 16, dtype=torch.int32, device=cuda).reshape(b, -1)}
    out = {}
    for use_kernel in (False, True):
        cache = {k: v.float() for k, v in model.init_cache(
            engine_pages=1 + b * s // 16, device=cuda).items()}
        LAUNCHES['flash_attention'] = 0
        out[use_kernel] = model.prefill_fn(params, cache, batch,
                                           use_kernel=use_kernel)
    assert LAUNCHES['flash_attention'] == cfg.n_layers
    torch.testing.assert_close(out[True][1], out[False][1], rtol=1e-4,
                               atol=1e-4)
    for key in ('k', 'v'):
        torch.testing.assert_close(out[True][0][key], out[False][0][key],
                                   rtol=1e-4, atol=1e-4)

    cfg = reduced(get_config('rwkv6-3b'), ssm_head_dim=64, d_model=256)
    model = build_model(cfg)
    params = model.init_params(0, device=cuda).to(torch.float32)
    batch = {'tokens': torch.randint(0, cfg.vocab_size, (2, 200),
                                     device=cuda),
             'labels': torch.randint(0, cfg.vocab_size, (2, 200),
                                     device=cuda)}
    LAUNCHES['wkv6'] = 0
    loss_k, _ = model.loss_fn(params, batch, use_kernel=True)
    assert LAUNCHES['wkv6'] == cfg.n_layers
    loss_p, _ = model.loss_fn(params, batch)
    torch.testing.assert_close(loss_k, loss_p, rtol=1e-5, atol=1e-5)


def test_rwkv6_prefill_carries_a_state_through_the_kernel(cuda):
    """A reduced rwkv6 prefill from a non-zero state (ragged T = 200), K6
    in every layer, against the plain chunked path: scores and every
    state within 1e-4; then a decode step from each agrees as well."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.api import build_model

    cfg = reduced(get_config('rwkv6-3b'), ssm_head_dim=64, d_model=256)
    model = build_model(cfg)
    params = model.init_params(0, device=cuda).to(torch.float32)
    gen = torch.Generator(device=cuda).manual_seed(3)
    start = {k: torch.randn(v.shape, generator=gen, device=cuda) * 0.1
             for k, v in model.init_cache(batch_size=2, device=cuda).items()}
    tokens = torch.randint(0, cfg.vocab_size, (2, 200), device=cuda,
                           generator=gen)
    out = {}
    for use_kernel in (False, True):
        cache = {k: v.clone() for k, v in start.items()}
        LAUNCHES['wkv6'] = 0
        cache, scores = model.prefill_fn(params, cache, {'tokens': tokens},
                                         use_kernel=use_kernel)
        assert LAUNCHES['wkv6'] == (cfg.n_layers if use_kernel else 0)
        cache, step = model.decode_fn(params, cache,
                                      {'tokens': scores.argmax(-1)})
        out[use_kernel] = (scores, step, cache)
    for got, want in zip(out[True][:2], out[False][:2]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    for key, v in out[True][2].items():
        torch.testing.assert_close(v, out[False][2][key], rtol=1e-4,
                                   atol=1e-4)


def test_disagg_kv_copy_is_bit_equal_on_the_card(cuda):
    """The disaggregated plane's KV copy on CUDA pools: the destination's
    pages hold the source's rows bit for bit, other pages untouched."""
    from repro_torch.serving.disagg.plane import copy_pages

    gen = torch.Generator(device=cuda).manual_seed(0)
    shape = (4, 40, 16, 8, 128)                  # (L, P, pg, Hkv, Dh)
    src = {k: torch.randn(shape, generator=gen, device=cuda)
           .to(torch.bfloat16) for k in 'kv'}
    dst = {k: torch.zeros(shape, dtype=torch.bfloat16, device=cuda)
           for k in 'kv'}
    src_pages, dst_pages = [7, 3, 39, 12], [1, 20, 5, 38]
    copy_pages(src, src_pages, dst, dst_pages)
    d = torch.tensor(dst_pages, device=cuda)
    s = torch.tensor(src_pages, device=cuda)
    rest = torch.tensor(sorted(set(range(40)) - set(dst_pages)), device=cuda)
    for k in 'kv':
        assert torch.equal(dst[k].index_select(1, d),
                           src[k].index_select(1, s))
        assert not dst[k].index_select(1, rest).any()


@pytest.mark.parametrize('arch', ['zamba2-2.7b', 'seamless-m4t-medium'])
def test_hybrid_and_encdec_on_the_card_match_the_cpu(cuda, arch):
    """Both families at reduced widths, f32 weights drawn on the CPU and
    copied: a prefill and 4 greedy decode steps on the card against the
    CPU (scores and caches within 1e-4, the same tokens), then the training
    loss; no hand-written kernel is launched (the reference runs none for
    these families)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.api import build_model

    cfg = reduced(get_config(arch))
    model = build_model(cfg)
    drawn = model.init_params(0, device='cpu').to(torch.float32)
    rng = np.random.default_rng(0)
    b, s, n_new = 2, 200, 4
    maxp = -(-(s + n_new) // cfg.page_size)
    tokens = rng.integers(0, cfg.vocab_size, (b, s))
    labels = rng.integers(0, cfg.vocab_size, (b, s))
    pt = (rng.permutation(b * maxp) + 1).reshape(b, maxp).astype(np.int32)
    frames = rng.normal(size=(b, 64, cfg.d_model)) * 0.02
    runs = {}
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for side, dev in (('card', cuda), ('cpu', torch.device('cpu'))):
        params = copy.deepcopy(drawn).to(dev)
        batch = {'tokens': torch.tensor(tokens, device=dev),
                 'page_table': torch.tensor(pt, device=dev)}
        kw = {}
        if cfg.family == 'encdec':
            kw['enc_len'] = 64
            batch['frames'] = torch.tensor(frames, dtype=torch.float32,
                                           device=dev)
        cache = model.init_cache(engine_pages=1 + b * maxp, batch_size=b,
                                 device=dev, dtype=torch.float32, **kw)
        cache, scores = model.prefill_fn(params, cache, batch)
        out, fed = [scores], []
        for i in range(n_new):
            nxt = scores.argmax(-1).to(torch.int32)
            fed.append(nxt.cpu())
            cache, scores = model.decode_fn(params, cache, {
                'tokens': nxt, 'positions': torch.full_like(nxt, s + i),
                'page_table': batch['page_table']})
            out.append(scores)
        loss, _ = model.loss_fn(params, dict(batch, labels=torch.tensor(
            labels, device=dev)))
        runs[side] = (out, fed, cache, loss)
    assert not any(LAUNCHES.values()), LAUNCHES
    (gs, gt, gc, gl), (ws, wt, wc, wl) = runs['card'], runs['cpu']
    for a, w in zip(gs, ws):
        torch.testing.assert_close(a.cpu(), w, rtol=0, atol=1e-4)
    assert all(torch.equal(a, w) for a, w in zip(gt, wt))

    def leaves(tree):
        return ([x for v in tree.values() for x in leaves(v)]
                if isinstance(tree, dict) else [tree])
    for a, w in zip(leaves(gc), leaves(wc)):
        torch.testing.assert_close(a.cpu(), w, rtol=0, atol=1e-4)
    torch.testing.assert_close(gl.cpu(), wl, rtol=1e-5, atol=0)


def test_f32_product_trains_as_the_bf16_product(cuda):
    """A row-parallel product under autograd on the card
    (``tp.f32_product`` of bf16 operands, as a bf16 tensor-parallel
    training step runs it): the one GEMM that writes f32, bit-equal to the
    product without autograd, and gradients as the plain bf16 ``x @ w``'s
    for the same bf16 output gradient (torch's bf16 tolerance: the two
    may order the backward GEMMs' operands differently)."""
    from repro_torch.distributed.tp import f32_product

    rng = np.random.default_rng(0)
    x0 = _bf16(cuda, rng, 2, 64, 384)
    w0 = _bf16(cuda, rng, 384, 256, scale=0.05)
    g = _bf16(cuda, rng, 2, 64, 256)
    with torch.no_grad():
        want = f32_product(x0, w0)
    x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
    out = f32_product(x, w)
    assert out.dtype == torch.float32 and torch.equal(out, want)
    out.to(torch.bfloat16).backward(g)
    xr, wr = x0.clone().requires_grad_(), w0.clone().requires_grad_()
    (xr @ wr).backward(g)
    assert x.grad.dtype == w.grad.dtype == torch.bfloat16
    torch.testing.assert_close(x.grad, xr.grad)
    torch.testing.assert_close(w.grad, wr.grad)


def test_paged_decode_on_a_local_head_slice(cuda):
    """A tensor-parallel rank's K1 call: the query and the pool hold only
    the rank's kv-heads (a contiguous copy of their block, as the rank's
    own pool is), and the kernel equals the plain version on that slice and
    the full call's output for those heads."""
    b, hq, hkv, d, pg, maxp = 8, 16, 8, 128, 16, 32       # qwen3-0.6b
    q, pk, pv, pt, lengths = _paged_inputs(cuda, (b, hq, hkv, d, pg, maxp),
                                           7)
    full = pa.paged_decode(q, pk, pv, pt, lengths)
    for n in (2, 4):
        for r in range(n):
            lo, hi = r * hkv // n, (r + 1) * hkv // n
            args = (q[:, lo:hi].contiguous(), pk[:, :, lo:hi].contiguous(),
                    pv[:, :, lo:hi].contiguous(), pt, lengths)
            got = pa.paged_decode(*args)
            torch.cuda.synchronize()
            want = paged_decode_ref(*args)
            torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
            torch.testing.assert_close(got.float(), full[:, lo:hi].float(),
                                       **BF16_TOL)


def _mesh_drain_rank(rank, n):
    """One rank of a reduced-width mesh drain on the card (kernels on)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.distributed.tp import serve_rank, stop_ranks
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import build_model
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.serving.kvpool import KVPool

    mesh = make_mesh((n,), ('model',))
    if rank != 0:
        return serve_rank(mesh)
    try:
        cfg = reduced(get_config('qwen3-0.6b'), page_size=16, head_dim=64)
        model = build_model(cfg)
        params = model.init_params(0, device=mesh.device)
        prompt = np.random.default_rng(0).integers(1, cfg.vocab_size,
                                                   40).tolist()
        outs = {}
        for name, m in (('meshless', None), ('mesh', mesh)):
            for k in LAUNCHES:
                LAUNCHES[k] = 0
            eng = Engine(model, params, KVPool(8, 4, page_size=16),
                         EngineConfig(max_batch=2, max_seq=64,
                                      prefill_chunk=16, decode_kernel=True,
                                      mesh=m), device=mesh.device)
            rids = [eng.submit(prompt, max_new_tokens=8) for _ in range(2)]
            eng.run_to_completion()
            eng.close()
            outs[name] = ([eng.output_tokens(r) for r in rids],
                          LAUNCHES['paged_decode'],
                          str(torch.distributed.get_backend()))
        return outs
    finally:
        stop_ranks(mesh)


@pytest.mark.parametrize('n', [1, 2])
def test_mesh_over_nccl_decodes_through_the_kernels(cuda, tmp_path, n):
    """A mesh of a card a rank over NCCL decodes through K1; one rank gives
    the single-device engine's tokens bit for bit (two need two cards)."""
    from repro_torch.launch.ranks import run_ranks

    if torch.cuda.device_count() < n:
        pytest.skip(f'a mesh of {n} over NCCL needs {n} cards')
    out = run_ranks(_mesh_drain_rank, n, store_dir=tmp_path,
                    device_type='cuda', args=(n,), timeout_s=120)[0]
    (single, _, _), (mesh, launches, backend) = out['meshless'], out['mesh']
    assert 'nccl' in backend
    assert all(len(o) == 8 for o in mesh)
    assert launches > 0
    if n == 1:
        assert mesh == single


def _train_rank(rank, shape, micro, arch='qwen3-0.6b'):
    """One rank of a reduced-width f32 training step of ``arch`` on the
    card over ``shape``, and the meshless step from the same weights on
    the same card: (backend, mesh metrics, meshless metrics, the worst
    gradient and parameter leaf of this rank's blocks against the meshless
    ones, of the leaf's max (a parameter drawn as zeros is lr-sized after
    the step, and is left out), the worst block's update off the meshless
    one as a share of that update's norm, and whether every block is
    bit-equal)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import build_model
    from repro_torch.training import optimizer as opt
    from repro_torch.training import tree as tr
    from repro_torch.training.data import DataConfig, batch_at
    from repro_torch.training.train_step import (
        loss_and_grads, make_train_step, mesh_loss_and_grads, shard_batch)

    mesh = make_mesh(shape, ('data', 'model'))
    dev = mesh.device
    model = build_model(reduced(get_config(arch)))
    drawn = tr.tree_map(lambda x: x.detach().float(),
                        model.init_params(0, device='cpu'))
    host = batch_at(DataConfig(seq_len=64, global_batch=4,
                               vocab_size=model.cfg.vocab_size), 0)
    host['loss_mask'] = np.ones((4, 64), np.float32)
    host['loss_mask'][0, :20] = 0
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    params = tr.tree_map(lambda x: x.to(dev, copy=True).requires_grad_(),
                         drawn)
    _, grads = loss_and_grads(model, params, batch, micro)
    _, _, m0 = make_train_step(model, microbatches=micro)(
        params, opt.init_opt_state(params), batch)
    step = make_train_step(model, mesh, microbatches=micro)
    plan = step.plan
    p = plan.shard_params(drawn)
    rows = shard_batch(host, plan, micro)
    _, g = mesh_loss_and_grads(model, plan, p, rows, micro)
    p, _, m = step(p, plan.init_opt_state(), rows)
    want = {'grads': dict(tr.leaves_with_paths(grads)),
            'params': dict(tr.leaves_with_paths(params))}
    worst, equal = {}, True
    zero = {k for k, v in tr.leaves_with_paths(drawn) if not v.any()}
    for what, tree in (('grads', g), ('params', p)):
        worst[what] = 0.0
        for k, v in tr.leaves_with_paths(tree):
            if what == 'params' and k in zero:
                continue
            w = plan.param_blocks[k].take(want[what][k].detach())
            equal &= torch.equal(v.detach(), w)
            worst[what] = max(worst[what], float(
                (v.detach() - w).abs().max()
                / want[what][k].detach().abs().max()))
    # each block's update off the meshless one, of that update's norm (an
    # unchanged block reads 1)
    worst['update'] = 0.0
    start = dict(tr.leaves_with_paths(drawn))
    for k, v in tr.leaves_with_paths(p):
        b = plan.param_blocks[k]
        before = b.take(start[k]).to(dev)
        delta = b.take(want['params'][k].detach()) - before
        miss = torch.linalg.vector_norm(v.detach() - before - delta)
        norm = torch.linalg.vector_norm(delta)
        worst['update'] = max(worst['update'], float(miss / norm) if norm
                              else (0.0 if miss == 0 else float('inf')))
    metrics = lambda x: {k: float(v) for k, v in x.items()}  # noqa: E731
    return (str(torch.distributed.get_backend()), metrics(m), metrics(m0),
            worst, equal)


@pytest.mark.parametrize('n', [1, 2])
def test_training_over_nccl_matches_the_meshless_step(cuda, tmp_path, n):
    """A data-parallel mesh of a card a rank over NCCL: one rank trains bit
    for bit as the meshless step (same card, f32, 2 microbatches); two
    need two cards."""
    from repro_torch.launch.ranks import run_ranks

    if torch.cuda.device_count() < n:
        pytest.skip(f'a mesh of {n} over NCCL needs {n} cards')
    out = run_ranks(_train_rank, n, store_dir=tmp_path, device_type='cuda',
                    args=((n, 1), 2), timeout_s=120)
    for backend, m, m0, worst, equal in out:
        assert 'nccl' in backend
        if n == 1:
            assert equal and m == m0, (m, m0, worst)
        else:
            assert worst['grads'] <= 1e-5 and worst['params'] <= 1e-5, worst


@pytest.mark.parametrize('shape', [(2, 1), (1, 2)])
def test_two_gloo_ranks_train_on_one_card(cuda, tmp_path, shape):
    """Two ranks sharing the card over gloo, data- or tensor-parallel, f32,
    2 microbatches and a loss mask: loss and grad_norm within 1e-5
    relative of the meshless step's on the card, every gradient and
    parameter block within 1e-5 of its leaf's max (chip_smoke phase 17
    (a)'s rule)."""
    from repro_torch.launch.ranks import run_ranks

    out = run_ranks(_train_rank, 2, store_dir=tmp_path, device_type='cuda',
                    backend='gloo', args=(shape, 2), timeout_s=120)
    for backend, m, m0, worst, _ in out:
        assert backend == 'gloo'
        assert m['loss'] == pytest.approx(m0['loss'], rel=1e-5)
        assert m['grad_norm'] == pytest.approx(m0['grad_norm'], rel=1e-5)
        assert worst['grads'] <= 1e-5 and worst['params'] <= 1e-5, worst
        assert worst['update'] <= 0.1, worst
    assert out[0][1] == out[1][1]


def test_two_gloo_ranks_train_zamba2_over_model_on_one_card(cuda, tmp_path):
    """A reduced zamba2 over (1, 2), two ranks sharing the card over gloo,
    f32, 2 microbatches and a loss mask: loss and grad_norm within 1e-5
    relative of the meshless step on the card, every gradient and
    parameter block within 1e-5 of its leaf's max (a parameter drawn as
    zeros is held by its update alone) and every block's update within
    0.1 of the meshless update's norm (an unchanged block reads 1).  The
    packed ``in_proj`` and conv blocks, the B/C gather and the gated
    norm's sum over ``model`` on CUDA tensors, at a size that runs in seconds;
    ``chip_smoke.py`` phase 19 covers zamba2 (with rwkv6 and seamless) at
    published widths."""
    from repro_torch.launch.ranks import run_ranks

    out = run_ranks(_train_rank, 2, store_dir=tmp_path, device_type='cuda',
                    backend='gloo', args=((1, 2), 2, 'zamba2-2.7b'),
                    timeout_s=120)
    for backend, m, m0, worst, _ in out:
        assert backend == 'gloo'
        assert m['loss'] == pytest.approx(m0['loss'], rel=1e-5)
        assert m['grad_norm'] == pytest.approx(m0['grad_norm'], rel=1e-5)
        assert worst['grads'] <= 1e-5 and worst['params'] <= 1e-5, worst
        assert worst['update'] <= 0.1, worst
    assert out[0][1] == out[1][1]
