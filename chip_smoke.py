#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each fatal on failure:

1. card identity (``nvidia-smi`` name and power limit);
2. build the CUDA kernel library from the checkout's sources (nvcc, sm_90a),
   print ptxas' registers and spills and, per kernel, its count of wgmma
   (HGMMA), TMA-load (UTMALDG), cp.async (LDGSTS) and mma.sync (HMMA)
   instructions, and require the first two in K5's bf16 kernel and K4's,
   the third in K1/K3's walk and K2's run, and HMMA, UTMALDG and LDGSTS in
   K6's;
3. every kernel against its plain PyTorch version at the main paths'
   shapes (qwen3-0.6b decode: B=8, Hq=16, Hkv=8, D=128, page 16, lengths
   1..512; the fused head at V=151936, D=1024; qwen3-0.6b prefill
   attention at B=2, S=4096; the rwkv6-3b WKV6 at B=4, T=2048, H=40,
   K=V=64, also at log-decays down to -12 with w = 1e-30 and w = 0 rows),
   with times, bounds and a library yardstick, and mutants of each kernel
   that the checks must reject (for K6 also one that rounds every product
   to TF32 once); edge cases of the split page
   walk and of K5's tiles, two calls of each redesigned kernel bit-equal,
   K1 at a 4096-token context and K5 at S=2048 timed on lines of their
   own, K1's short tables timed as one split and as a split a page, and
   K5 with P rounded once (built from a copy of its source) timed and
   checked beside the shipped kernel; K2 also over a 16-slot shared run
   that splits over CTAs (against the serial and the split plain
   versions), K4 with winners planted at every CTA's first and last vocab
   row, at V - 1 and as an exact tie across two CTAs, and K4 at
   internlm2-1.8b's head (V=92544, D=2048) on a line of its own;
4. full-width qwen3-0.6b, held teacher-forced: every kernel-path decode
   step (one step at the kernel shapes of phase 3, then every step of an
   engine drain over a prefix-sharing KV pool with short tables) is also
   scored on the same cache state by the plain path and by the plain
   models of the kernels' own split algorithms; the kernels stay within
   the spread of those two correct implementations, every sampled token
   is checked, shared page reads are saved and every kernel is launched;
5. the full-width Valve node (online qwen3-0.6b, offline qwen3-0.6b and
   internlm2-1.8b on one pool, ``serve.build_node``'s geometry) through
   ``serve_demo``: invariants, <= 1 preemption per request, all 12 offline
   requests finished;
6. full-width qwen3-0.6b whole-prompt prefill (``Model.prefill_fn``,
   B=2, S=2048, page 16) through the flash-attention kernel against the
   plain path, gated in f32 (the FMA kernel) and, by last-token argmax, in
   bf16 (the tensor-core kernel; its launches are the main path's), each
   run's attention kernel named by the profiler;
7. the full-width rwkv6-3b forward (``Model.loss_fn``, B=4, T=2048)
   through the WKV6 kernel against the plain path, gated in f32 and, in
   bf16, against the plain path's own chunk-32 / chunk-64 spread;
8. full-width rwkv6-3b inference (``Model.prefill_fn`` over B=4, T=2048
   through the WKV6 kernel, the state carried out of it, then 16 greedy
   ``decode_fn`` steps) against the plain path: f32 scores and every
   layer's wkv state within 1e-4, greedy tokens equal; bf16 prefill argmax
   equal or a near tie, the decode steps' spread recorded; K6 named by the
   profiler;
9. the serving front-end ``serve_http`` builds, over phase 5's node:
   ``AsyncNodeDriver`` + ``FrontendApp`` on a RealClock, a ``loadgen``
   trace (16 online streams and a 12-prompt batch job) through the
   in-process ASGI client, and two streams over a real loopback socket, one
   hung up mid-stream: every completed stream ends with [DONE] and carries
   its request's engine tokens, which equal a plain drain of a second node;
   the hung-up stream's lease is released and the pool's pages come back;
   TTFT, requests/s and token flushes a step printed;
10. ``python -m repro_torch.launch.serve --http --port 0`` as a child
    process on the card: one streamed completion over the socket, then
    SIGINT and exit code 0;
11. the disaggregated prefill/decode plane: two full-width nodes on the
    card, 8 online requests and offline work on both sides, against one
    colocated node: tokens bit for bit, zero handoff recompute, the copied
    KV rows bit-equal to their source, both runtimes' invariants;
12. phase 4's drain again with tables and shared runs long enough that K1,
    K3 and K2 split over CTAs, gated the same way (last, so that a failure
    there leaves every other phase's numbers printed);
13. one JSON line of per-kernel results, then the result line.

It exits non-zero, printing no result, without a CUDA device or outside a
checkout.  ``--trace`` profiles the node run, one bf16 prefill and one bf16
rwkv6 forward once more each (device time by kernel, busy share).
"""
from __future__ import annotations

import argparse
import asyncio
import contextlib
import functools
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / 'src'))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, data sheet
BF16_FLOPS_PER_S = 989e12          # dense bf16 tensor-core peak, data sheet
F32_FLOPS_PER_S = 67e12            # f32 outside the tensor cores, data sheet
ATTN_ATOL = 1e-3                   # bf16 attention outputs, elementwise:
ATTN_RTOL = 2 ** -7                # |out - ref| <= atol + rtol |ref|
F32_ATTN_TOL = 2e-5                # f32 flash attention (reference test's)
STATE_RTOL = 1e-4                  # f32 partial softmax state, rel err
TIE_RTOL = 1e-3                    # token ties: top-2 gap <= 1e-3 * |max|
WKV_TOL = 1e-4                     # WKV6, |got - want| <= tol (1 + |want|):
WKV_TOL_DECAY = 1e-3               # f32; log-decays down to -12;
WKV_TOL_BF16 = 3e-2                # bf16 inputs (reference kernel tests')
PREFILL_TOL = 1e-3                 # f32 prefill: scores of |max|, KV pools
LOSS_RTOL_F32 = 1e-4               # f32 rwkv6 loss, kernel vs plain
LOSS_RTOL_BF16 = 1e-3              # bf16: or 2x the plain path's null gap
REPS = 25

B, HQ, HKV, D, PG, MAXP = 8, 16, 8, 128, 16, 32
V_QWEN, D_QWEN = 151_936, 1024
V_INTERN, D_INTERN = 92_544, 2048  # internlm2-1.8b's head (offline engine)
FLASH_B, FLASH_S = 2, 4096         # qwen3-0.6b prefill attention
WKV_B, WKV_T, WKV_H, WKV_K = 4, 2048, 40, 64     # rwkv6-3b WKV6
WKV_CHUNK = 64
WKV_T_CHECK = 1000                 # the untimed WKV6 checks' length
LONG_MAXP = 256                    # K1 at a 4096-token context
PREFILL_B, PREFILL_S = 2, 2048
RWKV_B, RWKV_T = 4, 2048
RWKV_DECODE = 16                   # greedy decode steps after the prefill
FRONT_STREAMS, FRONT_BATCH = 16, 12  # loadgen streams, batch-job prompts
DISAGG_REQS, DISAGG_PROMPT, DISAGG_NEW = 8, 64, 24
SERVE_TIMEOUT_S = 300              # bounds a serving phase that stalls
DECODE_KERNELS = ('paged_decode', 'shared_run', 'shared_tail',
                  'unembed_sample')
SASS_OPS = ('HGMMA', 'UTMALDG', 'LDGSTS', 'HMMA')
# what the redesigned kernels claim to use: wgmma and TMA in K5's bf16
# kernel and K4's, cp.async in K1/K3's split walk and K2's run, mma.sync,
# TMA and cp.async in K6's tiles
SASS_NEEDS = {'flash_sm90_kernel': ('HGMMA', 'UTMALDG'),
              'unembed_wgmma_kernel': ('HGMMA', 'UTMALDG'),
              'paged_split_kernel': ('LDGSTS',),
              'shared_run_kernel': ('LDGSTS',),
              'wkv6_tile_kernel': ('HMMA', 'UTMALDG', 'LDGSTS')}
# the port's device kernels, by function name (device_profile lists each)
PORT_KERNELS = ('paged_split_kernel', 'paged_combine_kernel',
                'shared_run_kernel', 'unembed_wgmma_kernel',
                'argmax_reduce_kernel', 'flash_sm90_kernel',
                'flash_attention_kernel', 'wkv6_tile_kernel')
DEV = 'cuda'
PROFILE_MARGIN_S = 0.05           # host sleep at each end of a profiled window


def card_identity() -> str:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def sass_counts(lib: Path) -> dict:
    """For each kernel entry of the built library, how many of its SASS
    instructions are wgmma (HGMMA), TMA loads (UTMALDG), cp.async (LDGSTS)
    and mma.sync (HMMA), from ``cuobjdump -sass``."""
    from torch.utils.cpp_extension import CUDA_HOME
    text = subprocess.run([str(Path(CUDA_HOME) / 'bin' / 'cuobjdump'),
                           '-sass', str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in text.splitlines():
        found = re.search(r'Function : (\S+)', line)
        if found:
            name = found.group(1)
            counts[name] = dict.fromkeys(SASS_OPS, 0)
        elif name is not None:
            for op in re.findall(r'\b(' + '|'.join(SASS_OPS) + r')\b', line):
                counts[name][op] += 1
    return counts


class Timer:
    """Median device time of one call: L2 flushed first (the decode path
    finds its pages and head cold), the stream held busy by a spin kernel
    while the call is enqueued, so host launch overhead is not counted."""

    def __init__(self):
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)

    def __call__(self, fn, reps: int = REPS) -> float:
        for _ in range(3):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(50_000_000)   # ~25 ms: covers the enqueue
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def sms() -> int:
    """The card's multiprocessors, which the kernels' plans fill."""
    from repro_torch.kernels.common import sm_count
    return sm_count(DEV)


def bound(n_bytes: float, n_flops: float,
          flops_per_s: float = BF16_FLOPS_PER_S):
    """Least time (ms) for the work, and what bounds it: the bytes over the
    memory rate, or the operations over the peak rate of their type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / flops_per_s * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def near_tie(scores: torch.Tensor, a: int, b: int,
             rtol: float = TIE_RTOL) -> bool:
    """Both tokens score within ``rtol * |max|`` of the row's max."""
    top = scores.max().item()
    tol = rtol * abs(top)
    return scores[a].item() >= top - tol and scores[b].item() >= top - tol


def attn_close(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Elementwise within one bf16 ulp of ``want`` plus 1e-3: a correct
    kernel may round the other way, a dropped page or a shifted position
    moves outputs of ~0.03 by more (shown by the checks' mutants)."""
    got, want = got.float(), want.float()
    return bool(((got - want).abs()
                 <= ATTN_ATOL + ATTN_RTOL * want.abs()).all())


def max_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def state_rel(got, want) -> float:
    """Largest relative error of a partial softmax state (m, l, acc): l and
    acc over their whole tensors, m over the rows that saw a real score.
    A row masked at every slot must keep m = -1e30 in both (else inf)."""
    live = want[0] > -1e29
    if not torch.equal(got[0] > -1e29, live):
        return float('inf')
    rels = [max_rel(a, b) for a, b in zip(got[1:], want[1:])]
    if live.any():
        rels.append(max_rel(got[0][live], want[0][live]))
    return max(rels)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def wkv_close(got, want, tol: float) -> bool:
    """The reference kernel tests' rule: |got - want| <= tol + tol |want|."""
    got, want = got.float(), want.float()
    return bool(((got - want).abs() <= tol + tol * want.abs()).all())


def reject(mutants, close) -> None:
    """Every mutant's plain output must fail the check the kernel passed."""
    for name, (got, bad) in mutants.items():
        assert not close(got, bad), f'the check passes a {name}'
        print(f'  the check rejects a {name}: max abs err '
              f'{max_err(got, bad):.3e}')


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_checks(card: str, timer: Timer):
    import torch.nn.functional as F

    from repro_torch.kernels import common as kc
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.paged_attention.prefix import (build_shared_runs,
                                                            prefix_shared_ref)
    from repro_torch.kernels.paged_attention.ref import (paged_decode_ref,
                                                         shared_run_ref,
                                                         shared_run_split_ref)
    from repro_torch.kernels.sampling.ops import fused_unembed_sample
    from repro_torch.kernels.sampling.ref import (unembed_sample_ref,
                                                  unembed_scores)
    from repro_torch.models.common import paged_gather

    rng = np.random.default_rng(0)
    dev = DEV
    g = HQ // HKV
    n_pages = 1 + B * MAXP
    pool_k = torch.tensor(rng.normal(size=(n_pages, PG, HKV, D)) * 0.5,
                          dtype=torch.bfloat16, device=dev)
    pool_v = torch.tensor(rng.normal(size=(n_pages, PG, HKV, D)) * 0.5,
                          dtype=torch.bfloat16, device=dev)
    q = torch.tensor(rng.normal(size=(B, HKV, g, D)) * 0.5,
                     dtype=torch.bfloat16, device=dev)
    lengths_np = np.linspace(1, MAXP * PG, B).astype(np.int32)
    rng.shuffle(lengths_np)
    pt_np = (rng.permutation(n_pages - 1)[:B * MAXP] + 1).reshape(
        B, MAXP).astype(np.int32)
    pt = torch.tensor(pt_np, device=dev)
    lengths = torch.tensor(lengths_np, device=dev)
    results = {}

    # --- K1 paged_decode -----------------------------------------------------
    out = pa.paged_decode(q, pool_k, pool_v, pt, lengths)
    ref = paged_decode_ref(q, pool_k, pool_v, pt, lengths)
    err = (out.float() - ref.float()).abs().max().item()
    assert attn_close(out, ref), f'paged_decode max abs err {err}'
    # the check's power: the longest row with its last page dropped fails it
    dropped = lengths.clone()
    dropped[int(lengths_np.argmax())] -= PG
    mutants = {'K1 dropped page': (out, paged_decode_ref(
        q, pool_k, pool_v, pt, dropped))}
    live = np.ceil(lengths_np / PG).astype(np.int64)
    kv_bytes = int(live.sum()) * PG * HKV * D * 2 * 2
    n_bytes = kv_bytes + 2 * q.numel() * 2 + int(live.sum()) * 4 + B * 4
    n_flops = 4 * HQ * D * int(lengths_np.sum())
    kg = paged_gather(pool_k, pt).permute(0, 2, 1, 3)
    vg = paged_gather(pool_v, pt).permute(0, 2, 1, 3)
    sdpa_mask = (torch.arange(MAXP * PG, device=dev)[None, :]
                 < lengths[:, None])[:, None, None, :]
    q_sdpa = q.reshape(B, HQ, 1, D)
    results['paged_decode'] = dict(
        err=err, bound=bound(n_bytes, n_flops),
        ms=timer(lambda: pa.paged_decode(q, pool_k, pool_v, pt, lengths)),
        plain_ms=timer(lambda: paged_decode_ref(q, pool_k, pool_v, pt,
                                                lengths)),
        library_ms=timer(lambda: F.scaled_dot_product_attention(
            q_sdpa, kg, vg, attn_mask=sdpa_mask, enable_gqa=True)))

    paged_edge_checks(q, pool_k, pool_v, pt, lengths)
    long_context_check(card, timer)
    split_threshold_check(card, timer)

    # --- K2 shared_run / K3 shared_tail on a shared-prefix batch -------------
    n_shared = 4                                       # 64-token prefix
    spt_np = pt_np.copy()
    spt_np[:, :n_shared] = pt_np[0, :n_shared]
    slen_np = np.linspace(n_shared * PG + 1, MAXP * PG, B).astype(np.int32)
    rng.shuffle(slen_np)
    runs = build_shared_runs(spt_np, slen_np, PG)
    assert runs['n_slots'] == n_shared, runs['n_slots']
    cap = 1 << (runs['n_slots'] - 1).bit_length()      # the engine's bucket
    pages = torch.tensor(runs['pages'][:cap], device=dev)
    smask = torch.tensor(runs['mask'][:, :cap], device=dev)
    tail_pt = torch.tensor(runs['tail_pt'], device=dev)
    start = torch.tensor(runs['start'], device=dev)
    slen = torch.tensor(slen_np, device=dev)
    state = pa.shared_run(q, pool_k, pool_v, pages, smask)
    state_ref = shared_run_ref(q, pool_k, pool_v, pages, smask)
    sps = pa.plan_shared_splits(HKV, cap, PG, sms())[0]
    for want in (state_ref, shared_run_split_ref(
            q, pool_k, pool_v, pages, smask, slots_per_split=sps)):
        rel = state_rel(state, want)
        assert rel <= STATE_RTOL, f'shared_run state rel err {rel}'
    assert all(torch.equal(a, b) for a, b in zip(
        state, pa.shared_run(q, pool_k, pool_v, pages, smask))), \
        'K2: two calls differ'
    reject_state_mutant('K2', state, q, pool_k, pool_v, pages, smask)
    err = max((a - b).abs().max().item() for a, b in zip(state, state_ref))
    n_rows_slots = int(runs['mask'].sum())
    results['shared_run'] = dict(
        err=err, bound=bound(
            n_shared * PG * HKV * D * 2 * 2 + q.numel() * 2 + smask.numel() * 4
            + cap * 4 + B * HQ * 4 * (2 + D),
            4 * g * D * PG * HKV * n_rows_slots),
        ms=timer(lambda: pa.shared_run(q, pool_k, pool_v, pages, smask)),
        plain_ms=timer(lambda: shared_run_ref(q, pool_k, pool_v, pages,
                                              smask)),
        library_ms=None)

    out = pa.shared_tail(q, pool_k, pool_v, tail_pt, start, slen, state)
    ref = paged_decode_ref(q, pool_k, pool_v, tail_pt, slen, start=start,
                           state=state)
    err = (out.float() - ref.float()).abs().max().item()
    assert attn_close(out, ref), f'shared_tail max abs err {err}'
    oracle = prefix_shared_ref(q.reshape(B, HQ, D), pool_k, pool_v, pages,
                               None, smask, tail_pt, start, slen)
    both = (out.reshape(B, HQ, D).float() - oracle.float()).abs().max().item()
    assert attn_close(out.reshape(B, HQ, D), oracle), \
        f'shared_run+shared_tail vs oracle {both}'
    shifted = start.clone()
    shifted[int(slen_np.argmax())] += 1        # the longest tail, one page on
    mutants['K3 shifted start'] = (out, paged_decode_ref(
        q, pool_k, pool_v, tail_pt, slen, start=shifted, state=state))
    mutants['K3 no initial state'] = (out, paged_decode_ref(
        q, pool_k, pool_v, tail_pt, slen, start=start))
    reject(mutants, attn_close)
    # K2 + K3 compute what K1 computes: the pair's yardstick is SDPA over
    # the gathered KV of the shared-prefix tables
    skg = paged_gather(pool_k, torch.tensor(spt_np, device=dev)).permute(
        0, 2, 1, 3)
    svg = paged_gather(pool_v, torch.tensor(spt_np, device=dev)).permute(
        0, 2, 1, 3)
    tail_mask = (torch.arange(MAXP * PG, device=dev)[None, :]
                 < slen[:, None])[:, None, None, :]
    pair_ms = timer(lambda: F.scaled_dot_product_attention(
        q_sdpa, skg, svg, attn_mask=tail_mask, enable_gqa=True))
    results['shared_run']['library_ms'] = pair_ms
    tail_live = np.ceil(slen_np / PG).astype(np.int64) - runs['start']
    tail_tokens = int(slen_np.sum()) - int(runs['start'].sum()) * PG
    results['shared_tail'] = dict(
        err=err, bound=bound(
            int(tail_live.sum()) * PG * HKV * D * 2 * 2 + 2 * q.numel() * 2
            + B * HQ * 4 * (2 + D) + int(tail_live.sum()) * 4 + B * 8,
            4 * HQ * D * tail_tokens),
        ms=timer(lambda: pa.shared_tail(q, pool_k, pool_v, tail_pt, start,
                                        slen, state)),
        plain_ms=timer(lambda: paged_decode_ref(
            q, pool_k, pool_v, tail_pt, slen, start=start, state=state)),
        library_ms=pair_ms)

    assert torch.equal(out, pa.shared_tail(q, pool_k, pool_v, tail_pt, start,
                                           slen, state)), 'K3: two calls differ'
    shared_split_check(card, timer, q, pool_k, pool_v, pt_np)
    shared_rows_check(card, timer)
    floor_check(card, timer, q, pool_k, pool_v, pt, pages)
    # K3 from a non-empty state over tails that leave most splits empty
    # (row 0 none at all): the state and the live splits merge in order
    gen = torch.Generator(device=dev).manual_seed(4)
    rich = (torch.randn((B, HKV, g), generator=gen, device=dev),
            torch.rand((B, HKV, g), generator=gen, device=dev) * 20 + 1,
            torch.randn((B, HKV, g, D), generator=gen, device=dev) * 3)
    few = torch.tensor([4, 4, 0, 8, 4, 2, 4, 4], dtype=torch.int32, device=dev)
    flen = torch.tensor([4 * PG, 4 * PG + 1, 3, 20 * PG, 6 * PG + 7,
                         2 * PG + 1, 5 * PG, 5 * PG], dtype=torch.int32,
                        device=dev)
    got = pa.shared_tail(q, pool_k, pool_v, pt, few, flen, rich)
    want = paged_decode_ref(q, pool_k, pool_v, pt, flen, start=few, state=rich)
    assert attn_close(got, want), f'K3 from a state: {max_err(got, want)}'
    print(f'  shared_tail from a non-empty state, most splits empty: max abs '
          f'err {max_err(got, want):.3e}; two calls bit-equal')

    # --- K4 unembed_sample ---------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    head = (torch.randn((V_QWEN, D_QWEN), generator=gen, device=dev)
            * D_QWEN ** -0.5).to(torch.bfloat16)
    last = torch.randn((B, D_QWEN), generator=gen, device=dev).to(
        torch.bfloat16)
    scores = unembed_scores(last, head)
    worst = 0.0
    for temp in (0.0, 0.8):
        got = fused_unembed_sample(last, head, 7, temperature=temp)
        want = unembed_sample_ref(last, head, 7, temperature=temp)
        s = scores
        if temp > 0:
            s = scores / temp + kc.gumbel_hash_noise(
                7, torch.arange(B, device=dev)[:, None],
                torch.arange(V_QWEN, device=dev)[None, :])
        for r in range(B):
            a, b = int(got[r]), int(want[r])
            if a != b:
                assert near_tie(s[r], a, b), \
                    f'unembed_sample T={temp} row {r}: {a} vs {b}'
                print(f'  near tie, T={temp} row {r}: kernel {a} plain {b}')
            worst = max(worst, (s[r, b] - s[r, a]).item())
    assert torch.equal(got, fused_unembed_sample(last, head, 7,
                                                 temperature=0.8)), \
        'K4: two calls differ'
    unembed_planted_check(head)
    n_bytes = V_QWEN * D_QWEN * 2 + last.numel() * 2 + B * 4
    results['unembed_sample'] = dict(
        err=worst, bound=bound(n_bytes, 2 * B * V_QWEN * D_QWEN),
        ms=timer(lambda: fused_unembed_sample(last, head, 0)),
        plain_ms=timer(lambda: unembed_sample_ref(last, head, 0)),
        library_ms=timer(lambda: torch.argmax(last @ head.T, dim=-1)))
    del head, scores
    unembed_wide_check(card, timer)

    results['flash_attention'] = flash_check(card, timer)
    results['wkv6'] = wkv6_check(timer)

    for name, r in results.items():
        lib = 'none' if r['library_ms'] is None else f'{r["library_ms"]:.4f}'
        print(f'  {name}: err {r["err"]:.3e}  kernel_ms {r["ms"]:.4f}  '
              f'plain_ms {r["plain_ms"]:.4f}  library_ms {lib}  '
              f'bound_ms {r["bound"][0]:.4f} ({r["bound"][1]})  [{card}]')
    print(f'  (shared_run and shared_tail: library_ms is their pair\'s, SDPA '
          f'over the gathered shared-prefix KV)')
    return results


def reject_state_mutant(what, state, q, pool_k, pool_v, pages, mask) -> None:
    """The state check must fail the plain state computed with one slot
    masked out for one row (the first row's first slot it attends)."""
    from repro_torch.kernels.paged_attention.ref import shared_run_ref

    r, js = (int(x) for x in (mask > 0).nonzero()[0])
    holed = mask.clone()
    holed[r, js] = 0.0
    bad = shared_run_ref(q, pool_k, pool_v, pages, holed)
    rel = state_rel(state, bad)
    assert rel > STATE_RTOL, f'the check passes a {what} state missing a slot'
    print(f'  the check rejects a {what} state with slot {js} masked out for '
          f'row {r}: rel err {rel:.3e}')


def floor_check(card: str, timer: Timer, q, pool_k, pool_v, pt,
                pages) -> None:
    """The fixed cost of the decode kernels' chain of phases in this timer:
    K2 over one slot for one batch row, and K1 over one page of one row,
    each the kernel's least work, beside a one-element fill (the timer's
    own floor for a launch), on a line of their own."""
    from repro_torch.kernels.paged_attention import ops as pa

    one = torch.ones((1, 1), dtype=torch.float32, device=DEV)
    q1, page1, table1 = q[:1], pages[:1], pt[:1, :1].contiguous()
    length1 = torch.full((1,), PG, dtype=torch.int32, device=DEV)
    run = timer(lambda: pa.shared_run(q1, pool_k, pool_v, page1, one))
    walk = timer(lambda: pa.paged_decode(q1, pool_k, pool_v, table1, length1))
    fill = timer(lambda: one.zero_())
    print(f'  least work: shared_run over 1 slot for 1 row {run:.4f} ms; '
          f'paged_decode over 1 page of 1 row {walk:.4f} ms; a one-element '
          f'fill (PyTorch) {fill:.4f} ms  [{card}]')


def shared_split_check(card: str, timer: Timer, q, pool_k, pool_v,
                       pt_np) -> None:
    """K2 over a shared run long enough to split over CTAs: 13 shared pages
    (208 tokens) for rows 0..6, padded to the engine's 16-slot bucket with
    quarantine slots, row 7 sharing nothing.  The state against the serial
    and the split plain versions, two calls bit-equal, a mutant, K2 + K3
    against the stock walk; K2 and the K2 + K3 pair timed beside SDPA over
    the gathered KV, on a line of its own."""
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.paged_attention.prefix import build_shared_runs
    from repro_torch.kernels.paged_attention.ref import (paged_decode_ref,
                                                         shared_run_ref,
                                                         shared_run_split_ref)
    from repro_torch.models.common import paged_gather

    rng = np.random.default_rng(8)
    n_shared, g = 13, HQ // HKV
    spt_np = pt_np.copy()
    spt_np[:B - 1, :n_shared] = pt_np[0, :n_shared]
    slen_np = np.linspace(n_shared * PG + 1, MAXP * PG, B).astype(np.int32)
    rng.shuffle(slen_np)
    runs = build_shared_runs(spt_np, slen_np, PG)
    assert runs['n_slots'] == n_shared and not runs['mask'][B - 1].any()
    cap = 1 << (runs['n_slots'] - 1).bit_length()
    pages = torch.tensor(runs['pages'][:cap], device=DEV)
    smask = torch.tensor(runs['mask'][:, :cap], device=DEV)
    sps, n_splits = pa.plan_shared_splits(HKV, cap, PG, sms())
    assert n_splits > 1, (sps, n_splits)
    state = pa.shared_run(q, pool_k, pool_v, pages, smask)
    rels = [state_rel(state, want) for want in (
        shared_run_ref(q, pool_k, pool_v, pages, smask),
        shared_run_split_ref(q, pool_k, pool_v, pages, smask,
                             slots_per_split=sps))]
    assert max(rels) <= STATE_RTOL, f'K2 split state rel err {rels}'
    assert all(torch.equal(a, b) for a, b in zip(
        state, pa.shared_run(q, pool_k, pool_v, pages, smask))), \
        'K2 split: two calls differ'
    reject_state_mutant('K2 split', state, q, pool_k, pool_v, pages, smask)
    tail_pt = torch.tensor(runs['tail_pt'], device=DEV)
    start = torch.tensor(runs['start'], device=DEV)
    slen = torch.tensor(slen_np, device=DEV)
    spt = torch.tensor(spt_np, device=DEV)
    out = pa.shared_tail(q, pool_k, pool_v, tail_pt, start, slen, state)
    stock = paged_decode_ref(q, pool_k, pool_v, spt, slen)
    assert attn_close(out, stock), f'K2 split + K3: {max_err(out, stock)}'
    n_read = len(set(runs['pages'][:cap].tolist()))
    t_bound, by = bound(
        n_read * PG * HKV * D * 2 * 2 + q.numel() * 2 + smask.numel() * 4
        + cap * 4 + B * HQ * 4 * (2 + D),
        4 * g * D * PG * HKV * int(runs['mask'].sum()))
    kg, vg = (paged_gather(pool, spt).permute(0, 2, 1, 3)
              for pool in (pool_k, pool_v))
    mask = (torch.arange(MAXP * PG, device=DEV)[None, :]
            < slen[:, None])[:, None, None, :]
    ms = timer(lambda: pa.shared_run(q, pool_k, pool_v, pages, smask))
    pair = timer(lambda: pa.shared_tail(q, pool_k, pool_v, tail_pt, start,
                                        slen, pa.shared_run(
                                            q, pool_k, pool_v, pages, smask)))
    lib = timer(lambda: F.scaled_dot_product_attention(
        q.reshape(B, HQ, 1, D), kg, vg, attn_mask=mask, enable_gqa=True))
    print(f'  shared_run over {cap} slots ({n_shared} shared pages, row {B - 1} '
          f'sharing nothing; {n_splits} splits of {sps} slots + combine): '
          f'rel err {max(rels):.3e}; kernel_ms {ms:.4f}, K2 + K3 '
          f'{pair:.4f}, library_ms {lib:.4f} (SDPA, gathered KV), bound_ms '
          f'{t_bound:.4f} ({by}); K2 + K3 vs the stock walk max abs err '
          f'{max_err(out, stock):.3e}  [{card}]')


def shared_rows_check(card: str, timer: Timer) -> None:
    """K2 at a batch whose query rows (B x G) span several CTAs' row blocks:
    B=100 at qwen3-0.6b's widths, 200 rows, rows 0..98 sharing a run, row
    99 sharing nothing, over 4 slots (one split) and 16 (split): the state
    against the serial and the split plain versions and two calls
    bit-equal; timed, on a line of its own."""
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.paged_attention.ref import (shared_run_ref,
                                                         shared_run_split_ref)

    rng = np.random.default_rng(10)
    b, g = 100, HQ // HKV
    q = torch.tensor(rng.normal(size=(b, HKV, g, D)) * 0.5,
                     dtype=torch.bfloat16, device=DEV)
    for n_slots in (4, 16):
        pool_k, pool_v = (torch.tensor(
            rng.normal(size=(1 + n_slots, PG, HKV, D)) * 0.5,
            dtype=torch.bfloat16, device=DEV) for _ in range(2))
        pages = torch.arange(1, 1 + n_slots, dtype=torch.int32, device=DEV)
        mask = torch.ones((b, n_slots), device=DEV)
        mask[b - 1] = 0.0
        sps, n_splits = pa.plan_shared_splits(HKV, n_slots, PG, sms())
        state = pa.shared_run(q, pool_k, pool_v, pages, mask)
        rels = [state_rel(state, want) for want in (
            shared_run_ref(q, pool_k, pool_v, pages, mask),
            shared_run_split_ref(q, pool_k, pool_v, pages, mask,
                                 slots_per_split=sps))]
        assert max(rels) <= STATE_RTOL, f'K2 at B={b}: rel err {rels}'
        assert all(torch.equal(x, y) for x, y in zip(
            state, pa.shared_run(q, pool_k, pool_v, pages, mask))), \
            f'K2 at B={b}: two calls differ'
        ms = timer(lambda: pa.shared_run(q, pool_k, pool_v, pages, mask))
        print(f'  shared_run at B={b} ({b * g} query rows in '
              f'{-(-b * g // 32)} row blocks), {n_slots} slots in {n_splits} '
              f'splits: rel err {max(rels):.3e}; two calls bit-equal; '
              f'kernel_ms {ms:.4f}  [{card}]')


def unembed_planted_check(head) -> None:
    """K4's range edges at the qwen3-0.6b head: winners planted at every
    persistent CTA's first and last vocab row and at V - 1, 16 batch rows
    a call, each row's winner a copy of its own ``last`` row scaled to
    score ~64 against a field of N(0, 1) scores; then exact ties across two
    CTAs' ranges (the same head row at two indices): the first occurrence
    must win.  ``head`` is restored."""
    from repro_torch.kernels.sampling.ops import (fused_unembed_sample,
                                                  plan_vocab_ranges)
    from repro_torch.kernels.sampling.ref import (unembed_sample_ref,
                                                  unembed_scores)

    v = head.shape[0]
    rows = plan_vocab_ranges(v, sms())
    n_ctas = -(-v // rows)
    gen = torch.Generator(device=DEV).manual_seed(9)
    last = torch.randn((16, head.shape[1]), generator=gen, device=DEV).to(
        torch.bfloat16)
    lf = last.float()
    planted = (lf * (64.0 / lf.pow(2).sum(-1, keepdim=True))).to(
        torch.bfloat16)

    spots = sorted({c * rows for c in range(n_ctas)}
                   | {min((c + 1) * rows, v) - 1 for c in range(n_ctas)}
                   | {v - 1})
    for k in range(0, len(spots), 16):
        idx = torch.tensor(spots[k:k + 16], device=DEV)
        n = len(idx)
        saved = head[idx].clone()
        head[idx] = planted[:n]
        try:
            got = fused_unembed_sample(last[:n], head)
            want = unembed_sample_ref(last[:n], head)
        finally:
            head[idx] = saved
        assert got.tolist() == idx.tolist() == want.tolist(), \
            (k, got.tolist(), want.tolist(), idx.tolist())
    # exact ties: row j's winner at two indices in two CTAs' ranges
    pairs = [(2 * rows - 1, 9 * rows), (5 * rows, 7 * rows - 1),
             ((n_ctas - 2) * rows + 5, v - 1), (0, (n_ctas - 1) * rows)]
    idx = torch.tensor([i for pair in pairs for i in pair], device=DEV)
    src = torch.tensor([j for j in range(len(pairs)) for _ in range(2)],
                       device=DEV)
    saved = head[idx].clone()
    head[idx] = planted[src]
    try:
        got = fused_unembed_sample(last[:len(pairs)], head).tolist()
        want = unembed_sample_ref(last[:len(pairs)], head).tolist()
        scores = unembed_scores(last[:len(pairs)], head)
    finally:
        head[idx] = saved
    for j, (a, b) in enumerate(pairs):
        assert got[j] == a, f'K4 tie across CTAs, row {j}: {got[j]}, not {a}'
        assert want[j] == a or near_tie(scores[j], want[j], a), (j, want[j])
    print(f'  unembed_sample range edges: winners at all {len(spots)} first '
          f'and last rows of {n_ctas} CTAs ({rows} vocab rows each) and at '
          f'V - 1 found; exact ties across two CTAs go to the first '
          f'occurrence ({len(pairs)} rows)')


def unembed_wide_check(card: str, timer: Timer) -> None:
    """K4 at internlm2-1.8b's head (V=92544, D=2048; the node's second
    offline engine unembeds with it), B=8, T=0: checked against the plain
    version and timed beside ``argmax(last @ head.T)``, on its own line."""
    from repro_torch.kernels.sampling.ops import fused_unembed_sample
    from repro_torch.kernels.sampling.ref import (unembed_sample_ref,
                                                  unembed_scores)

    gen = torch.Generator(device=DEV).manual_seed(10)
    head = (torch.randn((V_INTERN, D_INTERN), generator=gen, device=DEV)
            * D_INTERN ** -0.5).to(torch.bfloat16)
    last = torch.randn((B, D_INTERN), generator=gen, device=DEV).to(
        torch.bfloat16)
    got = fused_unembed_sample(last, head)
    want = unembed_sample_ref(last, head)
    scores = unembed_scores(last, head)
    for r, (a, b) in enumerate(zip(got.tolist(), want.tolist())):
        assert a == b or near_tie(scores[r], a, b), \
            f'unembed_sample internlm2 head row {r}: {a} vs {b}'
    t_bound, by = bound(V_INTERN * D_INTERN * 2 + last.numel() * 2 + B * 4,
                        2 * B * V_INTERN * D_INTERN)
    ms = timer(lambda: fused_unembed_sample(last, head))
    lib = timer(lambda: torch.argmax(last @ head.T, dim=-1))
    same = int((got == want).sum())
    print(f'  unembed_sample at internlm2-1.8b\'s head ({V_INTERN} x '
          f'{D_INTERN}, B={B}): {same}/{B} tokens equal, the rest near '
          f'ties; kernel_ms {ms:.4f}  library_ms {lib:.4f} (argmax(last @ '
          f'W.T))  bound_ms {t_bound:.4f} ({by})  [{card}]')


def paged_edge_checks(q, pool_k, pool_v, pt, lengths) -> None:
    """K1 at the phase-3 shape: rows ending on a split boundary and one
    token either side, every row of length 1, live page ids outside the
    pool (read as the quarantine page 0), and two calls bit-equal."""
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.paged_attention.ref import paged_decode_ref

    dev, n_pages = q.device, pool_k.shape[0]
    split = pa.plan_splits(B, HKV, MAXP, PG, sms())[0] * PG
    oob = pt.clone()
    oob[0, 3], oob[1, 0] = n_pages + 5, -2
    cases = {
        'on split boundaries': (pt, [split, split - 1, split + 1, 2 * split,
                                     1, 2 * split + 1, 3 * split, MAXP * PG]),
        'every row of length 1': (pt, [1] * B),
        'page ids out of range': (oob, [MAXP * PG] * B),
    }
    for what, (table, lens) in cases.items():
        lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        got = pa.paged_decode(q, pool_k, pool_v, table, lens)
        quarantined = torch.where((table >= 0) & (table < n_pages), table, 0)
        want = paged_decode_ref(q, pool_k, pool_v, quarantined, lens)
        assert attn_close(got, want), f'paged_decode {what}: ' \
            f'{max_err(got, want)}'
        print(f'  paged_decode {what}: max abs err {max_err(got, want):.3e}')
    assert torch.equal(pa.paged_decode(q, pool_k, pool_v, pt, lengths),
                       pa.paged_decode(q, pool_k, pool_v, pt, lengths)), \
        'K1: two calls differ'


def split_threshold_check(card: str, timer: Timer) -> None:
    """Why a table of at most ``SPLIT_TOKENS`` tokens is one split: K1 at
    the node's and the engine drain's table widths (6 and 8 pages of 16),
    timed as planned (one split, no combine) and forced to one split a page
    (the planner's rule without that threshold: maxp splits, then the
    combine), both checked; printed on lines of their own."""
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.paged_attention.ref import paged_decode_ref

    rng = np.random.default_rng(2)
    planned, g = pa.plan_splits, HQ // HKV
    for b, maxp in ((4, 6), (8, 6), (8, 8)):
        assert planned(b, HKV, maxp, PG, sms())[1] == 1
        n_pages = 1 + b * maxp
        pool_k, pool_v = (torch.tensor(rng.normal(size=(n_pages, PG, HKV, D))
                                       * 0.5, dtype=torch.bfloat16,
                                       device=DEV) for _ in range(2))
        q = torch.tensor(rng.normal(size=(b, HKV, g, D)) * 0.5,
                         dtype=torch.bfloat16, device=DEV)
        pt = torch.tensor((rng.permutation(n_pages - 1) + 1).reshape(
            b, maxp).astype(np.int32), device=DEV)
        lengths = torch.tensor(np.linspace(1, maxp * PG, b).astype(np.int32),
                               device=DEV)
        ref = paged_decode_ref(q, pool_k, pool_v, pt, lengths)
        ms = []
        for plan in (planned, lambda *shape: (1, shape[2])):
            pa.plan_splits = plan
            try:
                got = pa.paged_decode(q, pool_k, pool_v, pt, lengths)
                assert attn_close(got, ref), f'K1 split threshold, {maxp}'
                ms.append(timer(lambda: pa.paged_decode(q, pool_k, pool_v,
                                                        pt, lengths)))
            finally:
                pa.plan_splits = planned
        print(f'  paged_decode at a {maxp * PG}-token table, B={b}: one '
              f'split {ms[0]:.4f} ms; {maxp} splits of a page + combine '
              f'{ms[1]:.4f} ms  [{card}]')


def long_context_check(card: str, timer: Timer) -> None:
    """K1 at a long context, B=8, 256 pages of 16 a row (4096 tokens),
    lengths spread: checked, timed beside its bound and SDPA over the
    gathered KV, printed on its own line (not in the kernels line)."""
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.paged_attention.ref import paged_decode_ref
    from repro_torch.models.common import paged_gather

    rng = np.random.default_rng(1)
    maxp, g = LONG_MAXP, HQ // HKV
    n_pages = 1 + B * maxp
    pool_k, pool_v = (torch.tensor(rng.normal(size=(n_pages, PG, HKV, D))
                                   * 0.5, dtype=torch.bfloat16, device=DEV)
                      for _ in range(2))
    q = torch.tensor(rng.normal(size=(B, HKV, g, D)) * 0.5,
                     dtype=torch.bfloat16, device=DEV)
    lengths_np = np.linspace(PG, maxp * PG, B).astype(np.int32)
    rng.shuffle(lengths_np)
    pt = torch.tensor((rng.permutation(n_pages - 1)[:B * maxp] + 1).reshape(
        B, maxp).astype(np.int32), device=DEV)
    lengths = torch.tensor(lengths_np, device=DEV)
    out = pa.paged_decode(q, pool_k, pool_v, pt, lengths)
    ref = paged_decode_ref(q, pool_k, pool_v, pt, lengths)
    assert attn_close(out, ref), f'paged_decode long: {max_err(out, ref)}'
    live = int(np.ceil(lengths_np / PG).sum())
    t_bound, by = bound(live * PG * HKV * D * 2 * 2 + 2 * q.numel() * 2
                        + live * 4 + B * 4, 4 * HQ * D * int(lengths_np.sum()))
    kg, vg = (paged_gather(pool, pt).permute(0, 2, 1, 3)
              for pool in (pool_k, pool_v))
    mask = (torch.arange(maxp * PG, device=DEV)[None, :]
            < lengths[:, None])[:, None, None, :]
    ms = timer(lambda: pa.paged_decode(q, pool_k, pool_v, pt, lengths))
    lib = timer(lambda: F.scaled_dot_product_attention(
        q.reshape(B, HQ, 1, D), kg, vg, attn_mask=mask, enable_gqa=True))
    pps, n_splits = pa.plan_splits(B, HKV, maxp, PG, sms())
    print(f'  paged_decode long context (B={B}, {maxp} pages of {PG}, '
          f'lengths {lengths_np.min()}..{lengths_np.max()}, {n_splits} splits '
          f'of {pps} pages): err {max_err(out, ref):.3e}  kernel_ms {ms:.4f}'
          f'  library_ms {lib:.4f} (SDPA, gathered KV)  bound_ms '
          f'{t_bound:.4f} ({by})  [{card}]')


def profiled(fn):
    """``fn()`` under ``torch.profiler``, after the device is idle, with
    PROFILE_MARGIN_S of host sleep inside the window before ``fn`` and
    after its sync, host activity traced too.  Without them the profiler
    drops the first kernels of a window now and then, at times a layer's
    attention kernel among them, which an exact launch count then misses
    (``scripts/profiler_probe.py`` counts each setting)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def launched(fn) -> dict:
    """The device kernels one call of ``fn`` launches: name -> count."""
    return {e.key: e.count for e in profiled(fn)}


def p_once_kernel():
    """K5's bf16 kernel with P rounded to bf16 once, as the JAX package's
    plain attention rounds it: a copy of ``flash_attention_sm90.cu``
    without the second P.V product (P's bf16 residual), built beside the
    library.  Returns ``fn(q, k, v)`` (causal), whose error and time stand
    beside the shipped kernel's; the bf16 check must reject it."""
    import ctypes

    from repro_torch.kernels import common as kc
    from repro_torch.kernels.flash_attention import ops as fa

    text = (ROOT / SOURCES['flash_attention'][0]).read_text()
    residual = re.compile(
        r'#pragma unroll\n[^\n]*\n[^\n]*wgmma_pv<D>\(o, p_lo[^\n]*\n')
    assert len(residual.findall(text)) == 1, 'no residual product to remove'
    out_dir = kc.library_path().parent / 'p_once'
    out_dir.mkdir(exist_ok=True)
    src, lib = out_dir / 'flash_p_once.cu', out_dir / 'libflash_p_once.so'
    src.write_text(residual.sub('', text))
    subprocess.run([kc._nvcc(), *kc.NVCC_FLAGS, '-I',    # its relative include
                    str((ROOT / SOURCES['flash_attention'][0]).parent),
                    '-shared', '-o', str(lib), str(src)], check=True,
                   capture_output=True)
    fn = ctypes.CDLL(str(lib)).valve_flash_attention_sm90
    fn.argtypes, fn.restype = list(fa._SM90_ARGS), ctypes.c_int

    def run(q, k, v):
        b, sq, hq, d = q.shape
        out = torch.empty_like(q)
        kc.check_launch(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           out.data_ptr(), b, sq, k.shape[1], hq, k.shape[2],
                           d, 1, d ** -0.5, kc.stream_ptr(q)),
                        'flash_attention, P rounded once')
        return out
    return run


def rule_share(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| as a share of :func:`attn_close`'s bound."""
    got, want = got.float(), want.float()
    return ((got - want).abs()
            / (ATTN_ATOL + ATTN_RTOL * want.abs())).max().item()


def flash_check(card: str, timer: Timer):
    """K5 at qwen3-0.6b's prefill widths: timed at B=2, S=4096, bf16,
    causal (and at S=2048, prefill's own length, on a line of its own);
    checked in bf16 at D=64 and 128 with G = 1, 2, 8, at Sq off the tile
    (1000; 300 x 200, Sq > Skv), non-causal across Sq=256, Skv=1024, at
    S=2048 and 4096, and in f32 (S=1024, the FMA kernel, 2e-5); bf16 at
    D=32 takes the FMA kernel too.  A bf16 call must launch the tensor-core
    kernel, two calls must be bit-equal, three mutants must fail (the
    third: the kernel itself with P rounded once, also timed)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models.common import attention

    gen = torch.Generator(device=DEV).manual_seed(5)

    def qkv(sq, skv, dtype, hq=HQ, hkv=HKV, d=D):
        return [(torch.randn((FLASH_B, s, h, d), generator=gen, device=DEV)
                 * 0.5).to(dtype) for s, h in ((sq, hq), (skv, hkv),
                                               (skv, hkv))]

    def f32_close(got, want):
        return bool(((got - want).abs()
                     <= F32_ATTN_TOL * (1 + want.abs())).all())

    bf16 = torch.bfloat16
    for sq, skv, causal, dtype, hq, hkv, d in (
            (1024, 1024, True, torch.float32, HQ, HKV, D),
            (256, 256, True, bf16, 8, 8, 64), (256, 256, True, bf16, 8, 4, 64),
            (384, 384, True, bf16, 8, 1, 64), (256, 256, True, bf16, 8, 8, D),
            (256, 256, True, bf16, 8, 1, D), (1000, 1000, True, bf16, HQ, HKV, D),
            (300, 200, True, bf16, HQ, HKV, D), (256, 1024, False, bf16, HQ, HKV, D),
            (2048, 2048, True, bf16, HQ, HKV, D), (128, 128, True, bf16, 4, 2, 32)):
        q, k, v = qkv(sq, skv, dtype, hq, hkv, d)
        got = flash_attention(q, k, v, causal=causal)
        want = flash_attention_ref(q, k, v, causal=causal)
        close = f32_close if dtype == torch.float32 else attn_close
        assert close(got, want), \
            f'flash_attention {sq}x{skv} {dtype} D={d}: {max_err(got, want)}'
        print(f'  flash_attention Sq={sq} Skv={skv} Hq={hq} Hkv={hkv} D={d} '
              f'causal={causal} {str(dtype)[6:]}: max abs err '
              f'{max_err(got, want):.3e}')

    q, k, v = qkv(FLASH_S, FLASH_S, bf16)
    out = flash_attention(q, k, v)
    ref = flash_attention_ref(q, k, v)
    assert attn_close(out, ref), f'flash_attention {max_err(out, ref)}'
    assert torch.equal(out, flash_attention(q, k, v)), 'K5: two calls differ'
    names = launched(lambda: flash_attention(q, k, v))
    assert any('flash_sm90_kernel' in n for n in names), names
    f32_names = launched(lambda: flash_attention(q[:, :128].float(),
                                                 k[:, :128].float(),
                                                 v[:, :128].float()))
    assert any('flash_attention_kernel' in n for n in f32_names), f32_names
    print('  a bf16 call launches flash_sm90_kernel, an f32 call '
          'flash_attention_kernel; two bf16 calls are bit-equal')
    pos = torch.arange(FLASH_S, device=DEV).expand(FLASH_B, FLASH_S)
    reject({
        'K5 with its last kv block dropped': (out, flash_attention_ref(
            q, k[:, :-64], v[:, :-64])),
        'K5 with the causal mask shifted by one': (out, attention(
            q, k, v, q_positions=pos + 1, kv_positions=pos)),
    }, attn_close)

    def work(s):            # bytes and causal-pair flops at length s
        return (2 * (2 * FLASH_B * s * HQ * D + 2 * FLASH_B * s * HKV * D),
                4 * FLASH_B * HQ * D * (s * (s + 1) // 2))

    qs, ks, vs = (x[:, :PREFILL_S].contiguous() for x in (q, k, v))
    once = p_once_kernel()
    for x in ((q, k, v), (qs, ks, vs)):
        want = flash_attention_ref(*x)
        got, got_once = flash_attention(*x), once(*x)
        print(f'  K5 with P rounded once (no residual product), S='
              f'{x[0].shape[1]}: max abs err {max_err(got_once, want):.3e}, '
              f'{rule_share(got_once, want):.3f}x the rule (shipped: '
              f'{max_err(got, want):.3e}, {rule_share(got, want):.3f}x); '
              f'kernel_ms {timer(lambda: once(*x)):.4f}, shipped '
              f'{timer(lambda: flash_attention(*x)):.4f}  [{card}]')
    # what the residual product buys: without it the rule fails
    reject({'K5 with P rounded once (no residual product)': (
        once(q, k, v), ref)}, attn_close)
    t_bound, by = bound(*work(PREFILL_S))
    ms = timer(lambda: flash_attention(qs, ks, vs))
    lib = timer(lambda: F.scaled_dot_product_attention(
        *(x.transpose(1, 2) for x in (qs, ks, vs)), is_causal=True,
        enable_gqa=True))
    print(f'  flash_attention at prefill length S={PREFILL_S} (B={FLASH_B}, '
          f'bf16, causal): kernel_ms {ms:.4f}  library_ms {lib:.4f} (SDPA)  '
          f'bound_ms {t_bound:.4f} ({by})  [{card}]')
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return dict(
        err=max_err(out, ref), bound=bound(*work(FLASH_S)),
        ms=timer(lambda: flash_attention(q, k, v)),
        plain_ms=timer(lambda: flash_attention_ref(q, k, v)),
        library_ms=timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)))


def wkv6_check(timer: Timer):
    """K6 at rwkv6-3b's widths: timed at B=4, T=2048, H=40, K=V=64, f32,
    against the sequential recurrence and the kernel's tiled plain model;
    checked also at T=1000 in f32 and with bf16 inputs, and at log-decays
    down to -12 with chunk 8 and with chunk 64 and rows of w = 1e-30 and
    w = 0 (any chunk gives the kernel's own tile); three mutants must
    fail.  Prints ptxas' registers and spills of the f32, K=64 kernel."""
    from repro_torch.kernels import common as kc
    from repro_torch.kernels.rwkv6.ops import wkv6
    from repro_torch.kernels.rwkv6.ref import wkv6_ref, wkv6_tiled_ref

    log = (kc.library_path().parent / 'build.log').read_text().splitlines()
    for i, ln in enumerate(log):
        if 'Compiling entry function' in ln and 'wkv6_tile_kernelIfLi64' in ln:
            print('  ptxas wkv6_tile_kernel<float, 64>: ' + '; '.join(
                x.strip() for x in log[i + 1:i + 5]
                if 'registers' in x or 'spill' in x))
            break

    gen = torch.Generator(device=DEV).manual_seed(6)

    def inputs(t, decay_lo=-2.5, dead_rows=False):
        def randn(*shape, scale):
            return torch.randn(shape, generator=gen, device=DEV) * scale
        shape = (WKV_B, t, WKV_H, WKV_K)
        logw = decay_lo + (-0.005 - decay_lo) * torch.rand(
            shape, generator=gen, device=DEV)
        w = torch.exp(logw)
        if dead_rows:       # sub-blocks past any cumulative-decay envelope
            w[0, t // 10:t // 10 + 4] = 1e-30
            w[1, t // 2:t // 2 + 3] = 0.0
            w[2:, 3 * t // 4, :5] = 0.0
        return [randn(*shape, scale=0.5), randn(*shape, scale=0.5),
                randn(*shape, scale=0.5), w,
                randn(WKV_H, WKV_K, scale=0.3),
                randn(WKV_B, WKV_H, WKV_K, WKV_K, scale=0.1)]

    def check(xs, chunk, tol, what):
        y, s = wkv6(*xs, chunk=chunk)
        assert torch.isfinite(y).all() and torch.isfinite(s).all(), what
        f32 = [x.float() for x in xs]
        errs = []
        for want in (wkv6_ref(*f32), wkv6_tiled_ref(*f32)):
            assert wkv_close(y, want[0], tol) and wkv_close(s, want[1], tol), \
                f'wkv6 {what}: {max_err(y, want[0])}, {max_err(s, want[1])}'
            errs += [max_err(y, want[0]), max_err(s, want[1])]
        print(f'  wkv6 {what}: max abs err {max(errs):.3e} (tol {tol})')
        return y, max(errs)

    xs = inputs(WKV_T_CHECK)
    check(xs, WKV_CHUNK, WKV_TOL, f'T={WKV_T_CHECK} f32')
    check([x.to(torch.bfloat16) for x in xs[:5]] + xs[5:], WKV_CHUNK,
          WKV_TOL_BF16, f'T={WKV_T_CHECK} bf16')
    check(inputs(WKV_T_CHECK, decay_lo=-12.0), 8, WKV_TOL_DECAY,
          f'T={WKV_T_CHECK} log-decays to -12, chunk 8')
    check(inputs(WKV_T_CHECK, decay_lo=-12.0, dead_rows=True), WKV_CHUNK,
          WKV_TOL_DECAY, f'T={WKV_T_CHECK} log-decays to -12, w = 1e-30 and '
          f'0 rows, chunk {WKV_CHUNK}')

    xs = inputs(WKV_T)
    y, err = check(xs, WKV_CHUNK, WKV_TOL, f'T={WKV_T} f32')
    r, k, v, w, u, s0 = xs
    no_carry = torch.cat([
        wkv6_ref(r[:, i:i + WKV_CHUNK], k[:, i:i + WKV_CHUNK],
                 v[:, i:i + WKV_CHUNK], w[:, i:i + WKV_CHUNK], u, s0)[0]
        for i in range(0, WKV_T, WKV_CHUNK)], dim=1)
    reject({
        'K6 without the u bonus': (y, wkv6_ref(r, k, v, w,
                                               torch.zeros_like(u), s0)[0]),
        'K6 without the carried state': (y, no_carry),
        'K6 with single-pass TF32 products': (
            y, wkv6_tiled_ref(*xs, tf32=True)[0]),
    }, lambda got, bad: wkv_close(got, bad, WKV_TOL))
    n_bytes = 4 * (4 * r.numel() + u.numel() + 2 * s0.numel() + y.numel())
    return dict(
        err=err,
        bound=bound(n_bytes, 4 * WKV_K * WKV_K * WKV_B * WKV_T * WKV_H,
                    F32_FLOPS_PER_S),
        ms=timer(lambda: wkv6(*xs, chunk=WKV_CHUNK)),
        plain_ms=timer(lambda: wkv6_tiled_ref(*xs)),
        library_ms=None)


# ---------------------------------------------------------------------------
# Phase 4: full-width qwen3-0.6b, every kernel-path decode step witnessed
# ---------------------------------------------------------------------------

# the split orders of the Witness's nulls: the kernels' own plans first
NULL_ORDERS = ('plan', 'serial', 'page', 'pair')


@contextlib.contextmanager
def plain_kernels(order: str = 'plan'):
    """Each attention kernel swapped for the plain model of its own split
    algorithm (``ref.py``): K1 and K3 for ``paged_decode_split_ref``, K2 for
    ``shared_run_split_ref``, split by ``order``: 'plan' under the plan the
    kernel takes for that call (``ops.plan_splits``' pages per split,
    ``ops.plan_shared_splits``' slots per split), 'serial' in one split,
    'page' a page (a slot) a split, 'pair' two.  Each is a correct
    implementation that sums in another f32 order than the plain path's
    gather oracle -- a null of the score comparisons; 'plan' keeps the
    kernel path's dataflow and split order too.  With one split each model
    is the plain version's serial walk bit for bit."""
    from repro_torch.kernels.common import sm_count
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.paged_attention.ref import (paged_decode_split_ref,
                                                         shared_run_split_ref)

    def per_split(planned: int, full: int) -> int:
        return {'plan': planned, 'serial': max(full, 1), 'page': 1,
                'pair': 2}[order]

    def walk(q, k, v, pt, n, start=None, state=None, scale=None):
        b, hkv = q.shape[:2]
        pps = per_split(pa.plan_splits(b, hkv, pt.shape[1], k.shape[1],
                                       sm_count(q.device))[0], pt.shape[1])
        return paged_decode_split_ref(q, k, v, pt, n, pages_per_split=pps,
                                      start=start, state=state, scale=scale)

    def run(q, k, v, pages, mask, scale=None):
        sps = per_split(pa.plan_shared_splits(q.shape[1], pages.shape[0],
                                              k.shape[1],
                                              sm_count(q.device))[0],
                        pages.shape[0])
        return shared_run_split_ref(q, k, v, pages, mask,
                                    slots_per_split=sps, scale=scale)

    saved = pa.paged_decode, pa.shared_run, pa.shared_tail
    pa.paged_decode = lambda q, k, v, pt, n, scale=None: walk(
        q, k, v, pt, n, scale=scale)
    pa.shared_run = run
    pa.shared_tail = lambda q, k, v, pt, st, n, state, scale=None: walk(
        q, k, v, pt, n, start=st, state=state, scale=scale)
    try:
        yield
    finally:
        pa.paged_decode, pa.shared_run, pa.shared_tail = saved


class Witness:
    """A model whose fused decode steps are held, teacher-forced, to the
    plain path.  Before each step runs, it is scored on copies of the same
    cache state with the same batch: P the plain path (gather oracle,
    unfused head), K the kernel path (K1, or K2 + K3 when the batch shares
    a prefix), and the nulls N (:func:`plain_kernels`, one for each of
    :data:`NULL_ORDERS`: the plain models of the kernels' split algorithms
    under the kernels' own split plans, in one split, a page a split and
    two pages a split), each a correct implementation that sums in another
    f32 order than P.

    Over 28 bf16 layers a single flipped bf16 rounding grows into a few
    percent of the scores, so K is held to the spread between two correct
    implementations: the median and the max of |K - P| / |max P| over every
    live row of every step stay within twice those of N under the kernels'
    plans.  Every token the step samples (K4) must be K's argmax up to an
    f32-order tie (TIE_RTOL: K4 sums the head in another order), and P's
    argmax unless the two plain scores lie within the nulls' reach on that
    row, 2 max |N - P| over every null.  One null alone reproduces P bit for
    bit on about a row in five (no bf16 rounding of the row flips), and its
    reach there is 0; several orders make that rare.  A token past the
    reach fails the verdict; the drain runs on to its end first, so the
    verdict lists every such row (the plain-score gap, the reach and the
    row's max |K - P|, each of |max P|) beside how many live rows K, the
    plan's null and every null reproduce P bit for bit.  The launches made
    to score K are taken back off the counters."""

    def __init__(self, model):
        self.model = model
        self.k_diffs, self.n_diffs, self.flips, self.past = [], [], [], []
        self.tokens = self.k_same = self.n_same = self.all_same = 0

    def __getattr__(self, name):            # the engine's other model calls
        return getattr(self.model, name)

    def decode_sample_fn(self, params, cache, batch, *, use_kernel,
                         temperature):
        from repro_torch.kernels.common import LAUNCHES
        assert use_kernel and temperature == 0.0

        def scores(b, kernel):
            c = {k: v.clone() for k, v in cache.items()}
            return self.model.decode_fn(params, c, b, use_kernel=kernel)[1]

        counts = dict(LAUNCHES)
        plain = scores({k: v for k, v in batch.items() if k != 'shared'},
                       False)
        kern = scores(batch, True)
        nulls = []
        for order in NULL_ORDERS:
            with plain_kernels(order):
                nulls.append(scores(batch, True))
        LAUNCHES.update(counts)
        cache, toks = self.model.decode_sample_fn(
            params, cache, batch, use_kernel=True, temperature=0.0)
        live = (batch['page_table'][:, 0] != 0).nonzero()[:, 0]
        self._check(toks[live], plain[live], kern[live],
                    torch.stack(nulls)[:, live])
        return cache, toks

    def _check(self, toks, plain, kern, nulls):
        top = plain.abs().amax(-1, keepdim=True)
        self.k_diffs.append(((kern - plain).abs() / top).flatten())
        self.n_diffs.append(((nulls[0] - plain).abs() / top).flatten())
        reach = 2 * (nulls - plain).abs().amax(-1).amax(0)
        self.k_same += int((kern == plain).all(-1).sum())
        self.n_same += int((nulls[0] == plain).all(-1).sum())
        self.all_same += int((nulls == plain).all(-1).all(0).sum())
        for r, a in enumerate(toks.tolist()):
            kb, pb = int(kern[r].argmax()), int(plain[r].argmax())
            assert a == kb or near_tie(kern[r], a, kb), \
                f'fused token {a} vs kernel-path argmax {kb}'
            if a != pb:
                span = top[r].item()
                gap = (plain[r, pb] - plain[r, a]).item() / span
                if gap <= reach[r].item() / span:
                    self.flips.append((gap, reach[r].item() / span))
                else:
                    self.past.append((a, pb, gap, reach[r].item() / span, (
                        kern[r] - plain[r]).abs().max().item() / span))
        self.tokens += len(toks)

    def verdict(self, what: str, card: str) -> list:
        """Print the record and return what failed (empty: passed)."""
        k, n = torch.cat(self.k_diffs), torch.cat(self.n_diffs)
        k_med, k_max = k.median().item(), k.max().item()
        n_med, n_max = n.median().item(), n.max().item()
        flips = ', '.join(f'{g:.3e} in {r:.3e}'
                          for g, r in self.flips) or 'none'
        print(f'  {what}: {self.tokens} tokens; |kernel - plain| median '
              f'{k_med:.3e}, max {k_max:.3e} of |max|; null {n_med:.3e}, '
              f'{n_max:.3e} (the kernels\' plans); tokens off the plain '
              f'argmax within the nulls\' reach: {len(self.flips)} '
              f'(plain-score gap in reach: {flips}, of |max|); rows equal to '
              f'the plain path bit for bit: kernel path {self.k_same}, null under the '
              f'plans {self.n_same}, all {len(NULL_ORDERS)} nulls '
              f'{self.all_same} of {self.tokens}  [{card}]')
        for a, pb, gap, reach, kdiff in self.past:
            print(f'  {what}: token {a} off the plain argmax {pb} past the '
                  f'nulls\' reach: plain-score gap {gap:.3e}, reach '
                  f'{reach:.3e}, the row\'s max |kernel - plain| {kdiff:.3e} '
                  f'(of |max|)  [{card}]')
        failed = []
        if self.past:
            failed.append(f'{what}: {len(self.past)} tokens past the reach')
        if not (k_med <= 2 * n_med and k_max <= 2 * n_max):
            failed.append(f'{what}: spread past twice the null\'s')
        return failed


def step_check(card: str) -> list:
    """One full-width qwen3-0.6b decode step at phase 3's kernel shapes
    (B=8, contexts 65..512 over a shared 4-page prefix), through K1 and
    through K2 + K3, each held by a :class:`Witness`.  Returns what the
    witnesses failed."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention.prefix import build_shared_runs
    from repro_torch.models.api import build_model

    model = build_model(get_config('qwen3-0.6b'))
    params = model.init_params(0, device=DEV)
    rng = np.random.default_rng(3)
    n_pages = 1 + B * MAXP
    base = model.init_cache(engine_pages=n_pages, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(3)
    for pool in base.values():
        pool.normal_(generator=gen)
    pt_np = (rng.permutation(n_pages - 1)[:B * MAXP] + 1).reshape(
        B, MAXP).astype(np.int32)
    pt_np[:, :4] = pt_np[0, :4]                        # shared 4-page prefix
    lengths_np = np.linspace(4 * PG + 1, MAXP * PG, B).astype(np.int32)
    runs = build_shared_runs(pt_np, lengths_np, PG)
    batch = {
        'tokens': torch.tensor(rng.integers(1, model.cfg.vocab_size, B),
                               device=DEV),
        'positions': torch.tensor(lengths_np - 1, device=DEV),
        'page_table': torch.tensor(pt_np, device=DEV),
    }
    shared = {k: torch.tensor(runs[k], device=DEV)
              for k in ('pages', 'pos', 'mask', 'tail_pt', 'start')}
    failed = []
    for name, b in (('paged_decode', batch),
                    ('shared_run+shared_tail', dict(batch, shared=shared))):
        witness = Witness(model)
        witness.decode_sample_fn(params, {k: v.clone()
                                          for k, v in base.items()}, b,
                                 use_kernel=True, temperature=0.0)
        failed += witness.verdict(f'one decode step, {model.cfg.n_layers} '
                                  f'layers, {name} + unembed_sample', card)
    return failed


@contextlib.contextmanager
def split_plans():
    """The (pages per split, splits) of every K1/K3 call while inside, under
    'walk', and the (slots per split, splits) of every K2 call, under
    'run'."""
    from repro_torch.kernels.paged_attention import ops as pa

    seen = {'walk': set(), 'run': set()}
    saved = pa.plan_splits, pa.plan_shared_splits

    def recorded(key, planned):
        def plan(*shape):
            result = planned(*shape)
            seen[key].add(result)
            return result
        return plan
    pa.plan_splits = recorded('walk', saved[0])
    pa.plan_shared_splits = recorded('run', saved[1])
    try:
        yield seen
    finally:
        pa.plan_splits, pa.plan_shared_splits = saved


def engine_check(card: str, long: bool = False):
    """Drain a prefix-shared trace through the plain path and through the
    kernel path, the latter's every decode step held by a
    :class:`Witness`; the two drains' tokens are compared for the record
    (greedy decoding carries a tie's flip forward).  Returns the kernel
    drain's launches and what its Witness failed.  Short (phase 4): 3-page prompts in 96-token tables,
    where K1 and K3 walk one split and K2 runs 4 slots in one CTA a kv-head
    (these launches are the kernels' main-path counts).  ``long`` (the
    last phase): 10-page prompts in 256-token tables, where K1 and K3 split
    the walk, K2 splits its 16-slot run, and both merge their splits in the
    combine kernel.  There the kernels cannot keep the plain version's
    serial f32 order, and the first null (the split plain models under the
    same plans) sums in the kernels' split order.  Both gated."""
    from repro_torch.configs import get_config
    from repro_torch.core.memory import MemoryPlane
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.models.api import build_model
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.serving.kvpool import KVPool

    model = build_model(get_config('qwen3-0.6b'))
    params = model.init_params(0, device=DEV)
    pg = model.cfg.page_size

    def drain(kernels: bool, n_prompt_pages: int, max_seq: int):
        prompt = np.random.default_rng(7).integers(
            1, model.cfg.vocab_size, n_prompt_pages * pg).tolist()
        pool = KVPool(16, max(4, max_seq // pg // 2), page_size=pg,
                      reserved_handles=1)
        MemoryPlane(pool, sharing=True)
        witness = Witness(model) if kernels else None
        eng = Engine(witness or model, params, pool, EngineConfig(
            max_batch=4, max_seq=max_seq, prefill_chunk=32,
            decode_kernel=None if kernels else False,
            fused_sampling=kernels, prefix_shared_attention=kernels),
            device=DEV)
        rids = [eng.submit(prompt, max_new_tokens=16)]
        for _ in range(20):         # publish r0's prefix; decode it alone
            eng.step()
            if len(eng.requests[rids[0]].generated) >= 3:
                break
        rids += [eng.submit(prompt, max_new_tokens=16) for _ in range(2)]
        eng.run_to_completion()
        torch.cuda.synchronize()
        return [eng.output_tokens(r) for r in rids], eng.stats, witness

    what, n_prompt_pages, max_seq = (('long engine drain', 10, 256) if long
                                     else ('engine drain', 3, 96))
    plain, _, _ = drain(False, n_prompt_pages, max_seq)
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    with split_plans() as plans:
        fast, stats, witness = drain(True, n_prompt_pages, max_seq)
    counts = dict(LAUNCHES)
    n_splits = sorted({n for _, n in plans['walk']})
    run_splits = sorted({n for _, n in plans['run']})
    first = [next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
             for a, b in zip(fast, plain)]
    print(f'  {what}: {n_prompt_pages}-page prompts, {max_seq}-token '
          f'tables, K1/K3 walks in {n_splits} splits, K2 runs in '
          f'{run_splits} splits; {sum(map(len, fast))} tokens, kernel drain '
          f'vs plain drain first differing token per request {first}, '
          f'shared_page_reads_saved {stats.shared_page_reads_saved}, '
          f'token_flushes {stats.token_flushes}, launches {counts}  [{card}]')
    failed = witness.verdict(f'{what}, every decode step', card)
    assert stats.shared_page_reads_saved > 0, 'no shared page reads saved'
    assert all(counts[k] > 0 for k in DECODE_KERNELS), counts
    assert (max(n_splits) > 1) == long, (what, plans)
    assert (max(run_splits) > 1) == long, (what, plans)
    return counts, failed


# ---------------------------------------------------------------------------
# Phase 5: the full-width node
# ---------------------------------------------------------------------------

def full_width_node(pool=None, clock=None, disaggregated: bool = False):
    """``serve.build_node``'s node (pool geometry, engine settings, seeds)
    at the published widths, page 16, fused sampling on every engine.  The
    disaggregated plane's halves pass their own ``pool``, one shared
    ``clock`` and ``disaggregated=True``."""
    from repro_torch.configs import get_config
    from repro_torch.core.clock import RealClock
    from repro_torch.core.runtime import RuntimeConfig, ValveRuntime
    from repro_torch.launch.node import NodeOrchestrator
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.kvpool import KVPool

    if pool is None:
        pool = KVPool(n_handles=24, pages_per_handle=8, page_size=PG,
                      reserved_handles=2)
    rt = ValveRuntime(pool, RuntimeConfig(n_devices=1, t_cool_init=0.002),
                      clock=clock or RealClock())
    node = NodeOrchestrator(rt, idle_advance=1e-3,
                            disaggregated=disaggregated)
    for arch, klass, seed, name in (
            ('qwen3-0.6b', 'online', 0, 'online:qwen3-0.6b'),
            ('qwen3-0.6b', 'offline', 0, 'offline0:qwen3-0.6b'),
            ('internlm2-1.8b', 'offline', 1, 'offline1:internlm2-1.8b')):
        node.add_engine(get_config(arch), EngineConfig(
            max_batch=8, max_seq=96, prefill_chunk=16, klass=klass,
            fused_sampling=True), seed=seed, name=name, device=DEV)
    return node


def node_check(card: str):
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.launch.serve import serve_demo

    node = full_width_node()
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    t0 = time.perf_counter()
    m = serve_demo(node=node, steps=400, quiet=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    assert m['max_preemptions_per_request'] <= 1, m
    assert m['offline_finished'] == 12, m['offline_finished']
    assert launches['paged_decode'] > 0 and launches['unembed_sample'] > 0, \
        launches
    print(f'  node: online_finished {m["online_finished"]}, '
          f'offline_finished {m["offline_finished"]}, '
          f'online_ttft_p50 {m["online_ttft_p50"]} s, '
          f'online_tpot_p50 {m["online_tpot_p50"]} s, '
          f'offline {m["offline_tokens"] / wall:.2f} tokens/s '
          f'({m["offline_tokens"]} in {wall:.2f} s), '
          f'preemptions {m["compute_preemptions"]}, '
          f'reclamations {m["reclamations"]}, launches {launches}  [{card}]')
    return launches, wall


def device_profile(what: str, run, card: str, wall=None) -> None:
    """``--trace``: ``run()`` once more under ``torch.profiler``
    (``profiled``): device time by kernel (the top 12, then the port's own
    kernels below them), and the device's busy share of
    the untraced wall time (the profiler slows the host, not the
    kernels).  Without ``wall``, an untraced run first gives it."""
    if wall is None:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = profiled(run)
    kernels.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    print(f'  {what}: device busy {busy:.3f} s of {wall:.3f} s untraced '
          f'wall: {busy / wall:.3%} busy, {1 - busy / wall:.3%} idle; '
          f'{sum(e.count for e in kernels)} device activities  [{card}]')
    ours = [e for e in kernels[12:]
            if any(name in e.key for name in PORT_KERNELS)]
    for e in kernels[:12] + ours:       # the top 12, then the port's others
        print(f'  {e.self_device_time_total / 1e3:10.3f} ms  {e.count:7d}x  '
              f'{e.key[:90]}')


# ---------------------------------------------------------------------------
# Phase 6: whole-prompt prefill; phase 7: the rwkv6 forward
# ---------------------------------------------------------------------------

def prefill_check(card: str, trace: bool = False):
    """Full-width qwen3-0.6b prefill on a global pool, kernel path (K5 in
    every layer) against the plain path (``chunked_attention``) on copies
    of the same empty pool.  f32 weights and pools (the FMA kernel):
    last-token scores within 1e-3 of |max|, the same argmax, KV pools
    within 1e-3.  bf16 (the tensor-core kernel): the same last-token
    argmax in every row, or two tokens within TIE_RTOL of |max|; the
    spread is reported, as phase 4 reports its null.  The launches are
    counted on the bf16 kernel-path run, the main path (bf16 is the
    serving dtype); one more kernel-path run of each dtype under the
    profiler shows which kernel each layer launched.  ``trace`` profiles
    one bf16 kernel-path prefill."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.models.api import build_model

    model = build_model(get_config('qwen3-0.6b'))
    cfg = model.cfg
    n_pages = 1 + PREFILL_B * PREFILL_S // cfg.page_size
    rng = np.random.default_rng(11)
    batch = {
        'tokens': torch.tensor(rng.integers(1, cfg.vocab_size,
                                            (PREFILL_B, PREFILL_S)),
                               device=DEV),
        'page_table': torch.tensor((rng.permutation(n_pages - 1) + 1).reshape(
            PREFILL_B, -1).astype(np.int32), device=DEV),
    }

    def empty_cache(dtype):
        return {k: v.to(dtype) for k, v in model.init_cache(
            engine_pages=n_pages, device=DEV).items()}

    launches = None
    for dtype, kernel in ((torch.float32, 'flash_attention_kernel'),
                          (torch.bfloat16, 'flash_sm90_kernel')):
        params = model.init_params(0, device=DEV).to(dtype)
        out, secs = {}, {}
        for use_kernel in (True, False):
            cache = empty_cache(dtype)
            main = use_kernel and dtype == torch.bfloat16
            if main:
                for k in LAUNCHES:
                    LAUNCHES[k] = 0
            t0 = time.perf_counter()
            out[use_kernel] = model.prefill_fn(params, cache, batch,
                                               use_kernel=use_kernel)
            torch.cuda.synchronize()
            secs[use_kernel] = time.perf_counter() - t0
            if main:
                launches = dict(LAUNCHES)
        names = launched(lambda: model.prefill_fn(
            params, empty_cache(dtype), batch, use_kernel=True))
        flash = {n: c for n, c in names.items() if 'flash' in n}
        assert sum(c for n, c in flash.items() if kernel in n) == \
            sum(flash.values()) == cfg.n_layers, \
            f'{dtype} prefill launched {flash}'
        print(f'  {str(dtype)[6:]} prefill: {cfg.n_layers} launches of '
              f'{kernel} (profiler), no other attention kernel')
        (kcache, kern), (pcache, plain) = out[True], out[False]
        assert torch.isfinite(kern).all(), 'non-finite prefill scores'
        spread = ((kern - plain).abs().max() / plain.abs().max()).item()
        same = int((kern.argmax(-1) == plain.argmax(-1)).sum())
        pools = max(max_err(kcache[k], pcache[k]) for k in ('k', 'v'))
        print(f'  prefill {cfg.n_layers} layers {str(dtype)[6:]}: '
              f'|kernel - plain| max {spread:.3e} of |max|; argmax equal '
              f'{same}/{PREFILL_B}; KV pools max abs diff {pools:.3e}; '
              f'kernel path {secs[True]:.3f} s, plain path '
              f'{secs[False]:.3f} s (host clock)  [{card}]')
        if dtype == torch.float32:
            assert spread <= PREFILL_TOL and same == PREFILL_B and \
                pools <= PREFILL_TOL, 'f32 prefill: kernel vs plain'
        else:
            for r, (a, b) in enumerate(zip(kern.argmax(-1).tolist(),
                                           plain.argmax(-1).tolist())):
                assert a == b or near_tie(plain[r], a, b), \
                    f'bf16 prefill row {r}: kernel argmax {a}, plain {b}'
            print(f'  bf16 gate: last-token argmax equal, or a near tie '
                  f'({TIE_RTOL} of |max|), in {PREFILL_B}/{PREFILL_B} rows; '
                  f'spread {spread:.3e} of |max| (the f32-FMA kernel gave '
                  f'1.696e-02 here)')
            if trace:
                device_profile('prefill, bf16, kernel path', lambda: (
                    model.prefill_fn(params, kcache, batch, use_kernel=True)),
                    card)
        del params, out, kcache, pcache
    assert launches['flash_attention'] == cfg.n_layers, launches
    return launches


@contextlib.contextmanager
def plain_wkv_chunk(chunk: int):
    """The model's plain WKV6 path at another chunk: the same function
    summed in another order, the null of the bf16 loss comparison."""
    from repro_torch.kernels.rwkv6.ref import wkv6_chunked
    from repro_torch.models import rwkv6

    saved = rwkv6.wkv6_chunked
    rwkv6.wkv6_chunked = functools.partial(wkv6_chunked, chunk=chunk)
    try:
        yield
    finally:
        rwkv6.wkv6_chunked = saved


def rwkv6_check(card: str, trace: bool = False):
    """Full-width rwkv6-3b training forward, kernel path (K6 in every
    layer) against the plain path (chunked WKV6, chunk 32), random
    weights from seed 0.  bf16 weights: |loss_kernel - loss_plain| within
    the larger of 1e-3 relative and twice the plain path's own chunk-32 /
    chunk-64 gap.  The same weights in f32: within 1e-4 relative.
    ``trace`` profiles one bf16 kernel-path forward."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.models.api import build_model

    model = build_model(get_config('rwkv6-3b'))
    cfg = model.cfg
    rng = np.random.default_rng(13)
    batch = {k: torch.tensor(rng.integers(0, cfg.vocab_size,
                                          (RWKV_B, RWKV_T)), device=DEV)
             for k in ('tokens', 'labels')}

    def loss(params, use_kernel):
        t0 = time.perf_counter()
        value = model.loss_fn(params, batch, use_kernel=use_kernel)[0].item()
        return value, time.perf_counter() - t0

    with torch.no_grad():
        params = model.init_params(0, device=DEV)            # bf16
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        kern, k_secs = loss(params, True)
        launches = dict(LAUNCHES)
        plain, p_secs = loss(params, False)
        with plain_wkv_chunk(64):
            null, _ = loss(params, False)
        gap, null_gap = abs(kern - plain), abs(null - plain)
        print(f'  rwkv6 {cfg.n_layers} layers bf16: loss kernel {kern:.7f}, '
              f'plain {plain:.7f}, plain at chunk 64 {null:.7f}; |kernel - '
              f'plain| {gap:.3e}, null {null_gap:.3e}; kernel path '
              f'{k_secs:.3f} s, plain path {p_secs:.3f} s (host clock)  '
              f'[{card}]')
        assert gap <= max(LOSS_RTOL_BF16 * abs(plain), 2 * null_gap), \
            'bf16 rwkv6 loss: kernel vs plain'
        if trace:
            device_profile('rwkv6 forward, bf16, kernel path',
                           lambda: loss(params, True), card)
        params = params.to(torch.float32)
        kern, k_secs = loss(params, True)
        plain, p_secs = loss(params, False)
        rel = abs(kern - plain) / abs(plain)
        print(f'  rwkv6 {cfg.n_layers} layers f32: loss kernel {kern:.7f}, '
              f'plain {plain:.7f}, relative gap {rel:.3e}; kernel path '
              f'{k_secs:.3f} s, plain path {p_secs:.3f} s (host clock)  '
              f'[{card}]')
        assert rel <= LOSS_RTOL_F32, 'f32 rwkv6 loss: kernel vs plain'
    assert launches['wkv6'] == cfg.n_layers, launches
    return launches


# ---------------------------------------------------------------------------
# Phase 8: rwkv6 inference (prefill through K6, then decode)
# ---------------------------------------------------------------------------

def rwkv6_inference_check(card: str):
    """Full-width rwkv6-3b inference: ``Model.prefill_fn`` over a
    RWKV_T-token prompt with the WKV6 kernel (the state carried out of
    it), then RWKV_DECODE greedy ``decode_fn`` steps from that state,
    against the same through the plain path on the same weights and
    prompt.  f32: layer 0's wkv state within 1e-4 of |max| (K6's own
    error: both paths read the same input there), the last-token scores and
    every deeper layer's state within the larger of 1e-4 and twice the
    plain path's own chunk-32 / chunk-64 gap (the model carries a layer's
    difference on, ~300x by the last layer), all greedy tokens equal.  bf16
    (the main path; its launches are counted): phase 7's bf16 rule on the
    last-token scores -- each row's |kernel - plain| within the larger of
    1e-3 of |max| and twice the plain path's own chunk-32 / chunk-64 gap
    (the null) -- with the argmax
    agreement of both printed, and the spread of the decode steps
    recorded, both paths fed the kernel path's tokens.  (Phase 6's rule,
    argmax equal or a near tie, fails the plain path against its own
    chunk-64 run here: full-width rwkv6 in bf16 from random weights moves
    the last-token scores by ~0.3 of |max| under any change of summation
    order.)  The profiler names K6 in a kernel-path prefill."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.models.api import build_model

    model = build_model(get_config('rwkv6-3b'))
    cfg = model.cfg
    rng = np.random.default_rng(17)
    batch = {'tokens': torch.tensor(rng.integers(
        0, cfg.vocab_size, (RWKV_B, RWKV_T)), device=DEV)}

    def empty_cache(dtype):
        cache = model.init_cache(batch_size=RWKV_B, device=DEV)
        return {k: v if k == 'wkv' else v.to(dtype) for k, v in cache.items()}

    def run(params, dtype, use_kernel, feed=None):
        """Prefill, then RWKV_DECODE steps fed their own argmax (or
        ``feed``'s tokens).  -> scores, wkv state after the prefill,
        tokens fed, each step's scores, prefill s, decode s a step."""
        cache = empty_cache(dtype)
        t0 = time.perf_counter()
        cache, scores = model.prefill_fn(params, cache, batch,
                                         use_kernel=use_kernel)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        prefill, wkv = scores, cache['wkv'].clone()
        toks, steps = [], []
        for i in range(RWKV_DECODE):
            tok = scores.argmax(-1) if feed is None else feed[i]
            toks.append(tok)
            cache, scores = model.decode_fn(params, cache, {'tokens': tok})
            steps.append(scores)
        torch.cuda.synchronize()
        return (prefill, wkv, torch.stack(toks), steps, t1 - t0,
                (time.perf_counter() - t1) / RWKV_DECODE)

    def null_prefill(params, dtype):
        """The plain path at chunk 64: (scores, wkv state after)."""
        with plain_wkv_chunk(64):
            cache, scores = model.prefill_fn(params, empty_cache(dtype),
                                             batch)
        return scores, cache['wkv']

    def rel(a, b) -> float:
        return ((a - b).abs().max() / b.abs().max()).item()

    with torch.no_grad():
        params = model.init_params(0, device=DEV)            # bf16
        model.prefill_fn(params, empty_cache(torch.bfloat16), batch,
                         use_kernel=True)                    # warm-up
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        kern = run(params, torch.bfloat16, True)
        launches = dict(LAUNCHES)
        plain = run(params, torch.bfloat16, False, feed=kern[2])
        names = launched(lambda: model.prefill_fn(
            params, empty_cache(torch.bfloat16), batch, use_kernel=True))
        wkv = {n: c for n, c in names.items() if 'wkv' in n}
        assert sum(c for n, c in wkv.items() if 'wkv6_tile_kernel' in n) \
            == sum(wkv.values()) == cfg.n_layers, f'rwkv6 prefill: {wkv}'
        print(f'  bf16 prefill: {cfg.n_layers} launches of wkv6_tile_kernel '
              f'(profiler); decode takes the single-token step, no kernel')
        null = null_prefill(params, torch.bfloat16)[0]
        rows = list(zip(kern[0].argmax(-1).tolist(),
                        plain[0].argmax(-1).tolist(),
                        null.argmax(-1).tolist()))
        gaps = []
        for r, (a, b, n) in enumerate(rows):
            top = plain[0][r].abs().max()
            gaps.append((((kern[0][r] - plain[0][r]).abs().max() / top)
                         .item(),
                         ((null[r] - plain[0][r]).abs().max() / top).item()))
            print(f'  bf16 prefill row {r}: |kernel - plain| max '
                  f'{gaps[-1][0]:.3e} of |max|, null (|chunk 64 - plain|) '
                  f'{gaps[-1][1]:.3e}; argmax kernel {a}, plain {b}, null '
                  f'{n}: kernel {"equal or a near tie" if a == b or near_tie(plain[0][r], a, b) else "off"}, '
                  f'null {"equal or a near tie" if n == b or near_tie(plain[0][r], n, b) else "off"}')
        for r, (gap, null_gap) in enumerate(gaps):
            assert gap <= max(PREFILL_TOL, 2 * null_gap), \
                f'bf16 rwkv6 prefill row {r}: |kernel - plain| {gap:.3e} ' \
                f'past twice the null\'s {null_gap:.3e}'
        spread = [((k - p).abs().max() / p.abs().max()).item()
                  for k, p in zip([kern[0]] + kern[3],
                                  [plain[0]] + plain[3])]
        agree = sum(int((k.argmax(-1) == p.argmax(-1)).all())
                    for k, p in zip(kern[3], plain[3]))
        print(f'  rwkv6 {cfg.n_layers} layers bf16, B={RWKV_B}, '
              f'T={RWKV_T}: every row within twice the null; |kernel - '
              f'plain| of |max|: prefill {spread[0]:.3e}, '
              f'decode steps median {statistics.median(spread[1:]):.3e} '
              f'max {max(spread[1:]):.3e}; argmax equal in every row at '
              f'{agree}/{RWKV_DECODE} steps (both fed the kernel path\'s '
              f'tokens); kernel path prefill {kern[4] * 1e3:.1f} ms, decode '
              f'{kern[5] * 1e3:.2f} ms a step; plain path prefill '
              f'{plain[4] * 1e3:.1f} ms, decode {plain[5] * 1e3:.2f} ms a '
              f'step (host clock, synchronized)  [{card}]')
        params = params.to(torch.float32)
        del kern, plain
        kern = run(params, torch.float32, True)
        plain = run(params, torch.float32, False)
        null = null_prefill(params, torch.float32)
        scores = (rel(kern[0], plain[0]), rel(null[0], plain[0]))
        states = [(rel(kw, pw), rel(nw, pw))
                  for kw, pw, nw in zip(kern[1], plain[1], null[1])]
        same = torch.equal(kern[2], plain[2])
        worst = max(range(cfg.n_layers), key=lambda i: states[i][0])
        print(f'  rwkv6 {cfg.n_layers} layers f32, |kernel - plain| of '
              f'|max| (null: |chunk 64 - plain|): layer 0 wkv state '
              f'{states[0][0]:.3e} ({states[0][1]:.3e}), worst layer '
              f'{worst} {states[worst][0]:.3e} ({states[worst][1]:.3e}), '
              f'last-token scores {scores[0]:.3e} ({scores[1]:.3e}); '
              f'{RWKV_DECODE} greedy tokens a row equal: {same}  [{card}]')
        # layer 0 reads the same input on both paths: K6's own error;
        # deeper layers carry it through the model, as the null does
        assert states[0][0] <= WKV_TOL, 'f32 rwkv6: layer 0 wkv state'
        for what, (gap, null_gap) in [('scores', scores)] + [
                (f'layer {i} wkv state', g) for i, g in enumerate(states)]:
            assert gap <= max(WKV_TOL, 2 * null_gap), \
                f'f32 rwkv6 {what}: {gap:.3e} past 1e-4 and twice the ' \
                f'null\'s {null_gap:.3e}'
        assert same, 'f32 rwkv6: greedy tokens differ'
    assert launches['wkv6'] == cfg.n_layers, launches
    return launches


# ---------------------------------------------------------------------------
# Phases 9-11: the serving surface (front-end, CLI, disaggregated plane)
# ---------------------------------------------------------------------------

def recording(app, log: list):
    """ASGI middleware: each ``/v1/completions`` call appends [request
    body, response bytes] to ``log`` as it starts."""
    async def wrapped(scope, receive, send):
        if scope.get('path') != '/v1/completions':
            return await app(scope, receive, send)
        entry = [b'', b'']
        log.append(entry)

        async def rx():
            msg = await receive()
            if msg['type'] == 'http.request':
                entry[0] += msg.get('body', b'')
            return msg

        async def tx(msg):
            if msg['type'] == 'http.response.body':
                entry[1] += msg.get('body', b'')
            await send(msg)
        await app(scope, rx, tx)
    return wrapped


def sse_tokens(events) -> tuple:
    """(request id, tokens, ended with [DONE]) of one stream's events."""
    frames = [json.loads(e.data) for e in events if not e.done]
    toks = [f['choices'][0]['token'] for f in frames
            if f['choices'][0].get('token') is not None]
    rid = frames[0]['id'] if frames else None
    return rid, toks, bool(events) and events[-1].done


async def sse_over_socket(port: int, prompt, max_tokens: int,
                          hang_up_after=None):
    """One streamed completion as a raw HTTP/1.1 client: POST, then read
    the chunked body into an ``SSEParser``.  With ``hang_up_after`` it
    closes the connection after that many token frames.  -> events."""
    from repro_torch.serving.frontend.sse import SSEParser

    reader, writer = await asyncio.open_connection('127.0.0.1', port)
    try:
        body = json.dumps({'prompt': prompt, 'max_tokens': max_tokens,
                           'stream': True}).encode()
        writer.write(b'POST /v1/completions HTTP/1.1\r\nhost: 127.0.0.1\r\n'
                     b'content-type: application/json\r\ncontent-length: '
                     + str(len(body)).encode() + b'\r\n\r\n' + body)
        await writer.drain()
        head = await reader.readuntil(b'\r\n\r\n')
        assert head.startswith(b'HTTP/1.1 200') and \
            b'transfer-encoding: chunked' in head.lower(), head
        parser, events = SSEParser(), []
        while True:
            n = int((await reader.readuntil(b'\r\n')).strip(), 16)
            if n == 0:
                await reader.readuntil(b'\r\n')
                break
            events += parser.feed(await reader.readexactly(n))
            await reader.readexactly(2)
            if hang_up_after is not None and \
                    len(sse_tokens(events)[1]) >= hang_up_after:
                return events
        parser.finish()
        return events
    finally:
        writer.close()
        with contextlib.suppress(ConnectionError, OSError):
            await writer.wait_closed()


def free_pages(node) -> int:
    return sum(len(d) for d in node.pool.free_in_handle)


def timed_flushes(node):
    """Wrap every engine's ``flush_tokens`` with a host-clock timer.
    -> [seconds] shared by all of them (each call adds its time, a call
    with nothing pending adds 0 and counts nothing, as the engine's
    ``token_flushes``)."""
    spent = [0.0]
    for eng in node.engines:
        def timed(flush=eng.flush_tokens, eng=eng):
            if not eng._pending:
                return flush()
            t0 = time.perf_counter()
            flush()
            spent[0] += time.perf_counter() - t0
        eng.flush_tokens = timed
    return spent


def frontend_check(card: str):
    """``serve_http``'s stack around ``full_width_node()`` on a RealClock:
    ``AsyncNodeDriver`` + ``FrontendApp``.  (a) A ``loadgen`` trace through
    the in-process ASGI client: FRONT_STREAMS online streams and one batch
    job of FRONT_BATCH offline prompts.  (b) Two streams over a real socket
    (``serve_asgi`` on 127.0.0.1, port 0), one hung up mid-stream.  Every
    completed stream ends with [DONE] and carries its request's tokens on
    the engine, and the tokens a plain ``drain()`` of a second node gives
    the same prompts; the hung-up stream's lease is released and the
    pool's free pages come back; the batch job finishes; <= 1 preemption
    per request; the runtime's invariants hold."""
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.serving.frontend.app import FrontendApp
    from repro_torch.serving.frontend.driver import AsyncNodeDriver
    from repro_torch.serving.frontend.http import serve_asgi
    from repro_torch.serving.frontend.loadgen import (
        LoadGenerator, TraceEntry, make_online_trace)
    from repro_torch.serving.frontend.sse import SSEParser
    from repro_torch.serving.frontend.testing import ASGIClient
    from repro_torch.serving.scheduler import ReqState

    node = full_width_node()
    # prompts valid for every engine a trace entry may land on
    vocab = min(e.mcfg.vocab_size for e in node.engines)
    free0 = free_pages(node)
    trace = make_online_trace(FRONT_STREAMS, horizon_s=1.0, prompt_len=12,
                              max_new_tokens=16, seed=5)
    trace.append(TraceEntry(t=0.05, kind='batch', n_requests=FRONT_BATCH,
                            prompt_len=24, max_new_tokens=24, seed=50))
    rng = np.random.default_rng(6)
    sock_prompts = [rng.integers(1, vocab, 12).tolist() for _ in range(2)]
    log: list = []
    flush_s = timed_flushes(node)
    flushes0 = sum(e.stats.token_flushes for e in node.engines)

    async def scenario():
        async with AsyncNodeDriver(node) as driver:
            app = recording(FrontendApp(driver), log)
            client = ASGIClient(app)
            gen = LoadGenerator(client, node.clock, vocab_size=vocab)
            ticks0, t0 = driver.stats.ticks, time.perf_counter()
            report = await gen.replay(trace)
            wall = time.perf_counter() - t0
            server = await serve_asgi(app, '127.0.0.1', 0)
            try:
                sock = await asyncio.gather(
                    sse_over_socket(server.port, sock_prompts[0], 16),
                    sse_over_socket(server.port, sock_prompts[1], 24,
                                    hang_up_after=3))
            finally:
                await server.stop()
            results = {}
            for bid in list(driver.batches.jobs):
                while (await client.get(f'/v1/batches/{bid}')
                       ).json()['status'] != 'completed':
                    await asyncio.sleep(1e-3)
                results[bid] = (await client.get(
                    f'/v1/batches/{bid}/results')).json()['results']
            while node.has_work():
                await asyncio.sleep(1e-3)
            return report, wall, sock, results, driver

    for k in LAUNCHES:
        LAUNCHES[k] = 0
    report, wall, sock, results, driver = asyncio.run(
        asyncio.wait_for(scenario(), SERVE_TIMEOUT_S))
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    eng = node.online
    hung_rid, hung_toks, hung_done = sse_tokens(sock[1])
    assert not hung_done and len(hung_toks) >= 3, 'socket hang-up'
    rid, toks, done = sse_tokens(sock[0])
    assert done and toks == eng.output_tokens(rid), 'socket stream'
    completed = []                     # (prompt, max_tokens, tokens)
    for body, raw in log:              # the loadgen's and the socket's
        rid, toks, done = sse_tokens(SSEParser().feed(raw))
        if rid == hung_rid:
            continue
        assert done, f'stream {rid}: no [DONE] frame'
        assert toks == eng.output_tokens(rid), f'stream {rid}: SSE tokens ' \
            f'{toks} != engine {eng.output_tokens(rid)}'
        req = json.loads(body)
        assert len(toks) == req['max_tokens'], (rid, toks)
        completed.append((req['prompt'], req['max_tokens'], toks))
    assert len(log) == FRONT_STREAMS + 2, len(log)
    assert len(completed) == FRONT_STREAMS + 1, len(completed)
    hung = eng.requests[hung_rid]
    assert hung.state is ReqState.CANCELLED and hung.lease is None, \
        'the hung-up stream kept its lease'
    assert driver.stats.streams_cancelled == 1, driver.stats
    assert all(r['status'] == 'completed' and len(r['tokens']) == 24
               for res in results.values() for r in res) and \
        sum(map(len, results.values())) == FRONT_BATCH, results
    node.runtime.check_invariants()
    m = node.metrics()
    assert m['max_preemptions_per_request'] <= 1, m
    assert node.runtime.memory.live_leases('online') == [] and \
        node.runtime.memory.live_leases('offline') == []
    assert node.runtime.invalidation_routes() == []
    retained = node.runtime.memory.drop_cache()  # offline prefix pages
    assert free_pages(node) == free0, (free_pages(node), free0)
    assert launches['paged_decode'] > 0 and \
        launches['unembed_sample'] > 0, launches
    flushes = sum(e.stats.token_flushes for e in node.engines) - flushes0
    ticks = driver.stats.ticks
    print(f'  front-end: {report.completed}/{report.n_online} loadgen '
          f'streams + 1 socket stream completed with [DONE], SSE tokens = '
          f'engine tokens; 1 socket stream hung up after '
          f'{len(hung_toks)} tokens: lease released, free pages '
          f'{free_pages(node)} = {free0} before (after dropping {retained} '
          f'retained offline prefix pages); batch job '
          f'{FRONT_BATCH}/{FRONT_BATCH} completed; preemptions '
          f'{m["compute_preemptions"]}, max per request '
          f'{m["max_preemptions_per_request"]}; launches {launches}')
    print(f'  front-end load: TTFT p50 {report.ttft_pct(50) * 1e3:.1f} ms, '
          f'p99 {report.ttft_pct(99) * 1e3:.1f} ms, '
          f'{report.requests_per_s:.2f} requests/s, peak '
          f'{report.peak_concurrent_streams} streams, over '
          f'{report.duration_s:.3f} s (replay wall {wall:.3f} s); '
          f'{ticks} node steps, {flushes} token flushes '
          f'({flushes / ticks:.3f} a step), {flush_s[0] * 1e3:.1f} ms in '
          f'flush_tokens ({flush_s[0] / max(flushes, 1) * 1e3:.3f} ms a '
          f'flush, the device->host sync included)  [{card}]')
    del node
    # the same prompts through a plain drain of a second node
    ref = full_width_node()
    rids = [ref.online.submit(p, max_new_tokens=n)
            for p, n, _ in completed]
    ref.drain()
    diff = [i for i, (r, s) in enumerate(zip(rids, completed))
            if ref.online.output_tokens(r) != s[2]]
    print(f'  streamed tokens vs a plain drain of a second node: '
          f'{len(completed) - len(diff)}/{len(completed)} streams '
          f'bit-identical' + (f'; differ: {[(completed[i][2], ref.online.output_tokens(rids[i])) for i in diff]}' if diff else ''))
    assert not diff, 'streamed tokens != a plain drain'
    return launches


def cli_check(card: str) -> None:
    """``python -m repro_torch.launch.serve --http --port 0`` as a child
    process on the card (``build_node``'s reduced widths): read its
    "serving on" line, stream one completion over the socket, SIGINT, and
    require [DONE] and exit code 0."""
    import os
    import queue
    import signal
    import threading

    env = dict(os.environ, PYTHONPATH=str(ROOT / 'src'))
    proc = subprocess.Popen(
        [sys.executable, '-u', '-m', 'repro_torch.launch.serve', '--http',
         '--port', '0'], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines: queue.Queue = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout],
                     daemon=True).start()
    try:
        t0 = time.perf_counter()
        seen = []
        while True:
            ln = lines.get(timeout=max(1.0, 120 - (time.perf_counter() - t0)))
            seen.append(ln.rstrip())
            found = re.search(r'serving on http://[\d.]+:(\d+)', ln)
            if found:
                break
        port = int(found.group(1))
        up = time.perf_counter() - t0
        events = asyncio.run(sse_over_socket(port, [5, 7, 11], 8))
        rid, toks, done = sse_tokens(events)
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=60)
        print(f'  serve --http: "{seen[-1]}" after {up:.1f} s; one stream '
              f'{rid}: {len(toks)} tokens, [DONE] {done}; SIGINT -> exit '
              f'code {rc}  [{card}]')
        assert done and len(toks) == 8 and rc == 0, (seen, events, rc)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def disagg_check(card: str):
    """Two full-width nodes on one card joined by the disaggregated plane
    (pools 'prefill' and 'decode', sized as the reference's plane tests
    at page 16), DISAGG_REQS online requests and offline work on both
    sides (run until the online requests finish), against one colocated
    ``full_width_node()``: greedy tokens bit for bit, zero handoff
    recompute, every request handed off or finished on the prefill side
    (>= 1 handoff), pages copied, the first handoff's copied KV rows
    bit-equal to their source, both runtimes' invariants, <= 1 preemption
    per (request, device), offline tokens on both sides."""
    from repro_torch.core.clock import RealClock
    from repro_torch.core.events import PageMigration, PrefillHandoff
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.serving.disagg import DisaggPlane
    from repro_torch.serving.kvpool import KVPool
    from repro_torch.serving.scheduler import ReqState

    clock = RealClock()
    plane = DisaggPlane(
        full_width_node(KVPool(8, 4, page_size=PG, reserved_handles=4,
                               name='prefill'), clock, True),
        full_width_node(KVPool(8, 4, page_size=PG, reserved_handles=6,
                               name='decode'), clock, True))
    migs, copied = {}, []

    def on_migration(ev):
        if ev.cross_pool:
            migs[ev.owner] = ev

    def on_handoff(ev):
        if copied:
            return
        mig = migs[ev.req_id]
        src = plane.prefill.online.cache
        dst = plane.decode.online.cache
        s = torch.tensor(mig.src_pages, device=DEV)
        d = torch.tensor(mig.dst_pages, device=DEV)
        copied.append((len(mig.src_pages), all(
            torch.equal(dst[k].index_select(1, d), src[k].index_select(1, s))
            for k in src)))

    plane.prefill.runtime.subscribe(on_migration, PageMigration)
    plane.decode.runtime.subscribe(on_handoff, PrefillHandoff)
    rng = np.random.default_rng(8)
    vocab = plane.online.mcfg.vocab_size
    prompts = [rng.integers(1, vocab, DISAGG_PROMPT).tolist()
               for _ in range(DISAGG_REQS)]
    for node in (plane.prefill, plane.decode):
        for eng in node.offline:
            for _ in range(2):
                eng.submit(rng.integers(1, eng.mcfg.vocab_size, 24).tolist(),
                           max_new_tokens=24)
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    t0 = time.perf_counter()
    for _ in range(4):                   # offline under way on both sides
        plane.step()
    rids = [plane.submit(p, DISAGG_NEW) for p in prompts]
    # until every online request finishes: the offline backlog's tail
    # waits on MIAD handing handles back (one per release interval, which
    # the burst's reclamations stretch), and no gate reads it
    for _ in range(20_000):
        if all(plane.engine_of(r).requests[r].state is ReqState.FINISHED
               for r in rids):
            break
        plane.step()
    else:
        raise AssertionError('disagg: online requests did not finish')
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    got = [plane.engine_of(r).output_tokens(r) for r in rids]
    plane.check_invariants()
    m = plane.metrics()
    on_prefill = sum(r in plane.prefill.online.requests for r in rids)
    off_tokens = [sum(e.stats.tokens_generated for e in node.offline)
                  for node in (plane.prefill, plane.decode)]
    lat = m['handoff_latency']
    print(f'  disagg: {m["handoffs"]} handoffs, {on_prefill} finished on '
          f'the prefill side, {m["handoffs_deferred"]} deferrals, '
          f'{m["pages_copied"]} pages copied, recompute '
          f'{m["handoff_recompute_tokens"]} tokens, handoff latency p50 '
          f'{lat["p50"] * 1e3:.2f} ms (n {lat["count"]}); first handoff '
          f'{copied[0][0] if copied else 0} pages, rows equal '
          f'{copied[0][1] if copied else None}; offline tokens '
          f'{off_tokens} (prefill, decode side); max preemptions per '
          f'request {m["max_preemptions_per_request"]}; {wall:.2f} s, '
          f'{plane.stats.steps} plane steps; launches {launches}  [{card}]')
    assert m['handoff_recompute_tokens'] == 0, m
    assert m['handoffs'] >= 1 and m['handoffs'] + on_prefill == \
        DISAGG_REQS, m
    assert m['pages_copied'] > 0 and copied and copied[0][1], copied
    assert m['max_preemptions_per_request'] <= 1, m
    assert min(off_tokens) > 0, 'disagg: no offline backfill on a side'
    assert launches['paged_decode'] > 0 and \
        launches['unembed_sample'] > 0, launches
    del plane
    colo = full_width_node()
    crids = [colo.online.submit(p, DISAGG_NEW) for p in prompts]
    colo.drain()
    want = [colo.online.output_tokens(r) for r in crids]
    same = sum(g == w for g, w in zip(got, want))
    print(f'  disagg vs colocated: {same}/{DISAGG_REQS} requests '
          f'bit-identical' + (f'; {[(g, w) for g, w in zip(got, want) if g != w]}' if same < DISAGG_REQS else ''))
    assert all(len(g) == DISAGG_NEW for g in got) and got == want, \
        'disagg tokens != colocated'
    return launches


SOURCES = {
    'paged_decode': ('src/repro_torch/kernels/paged_attention/csrc/'
                     'paged_attention.cu',
                     'src/repro/kernels/paged_attention/kernel.py:34'),
    'shared_run': ('src/repro_torch/kernels/paged_attention/csrc/'
                   'paged_attention.cu',
                   'src/repro/kernels/paged_attention/kernel.py:117'),
    'shared_tail': ('src/repro_torch/kernels/paged_attention/csrc/'
                    'paged_attention.cu',
                    'src/repro/kernels/paged_attention/kernel.py:154'),
    'unembed_sample': ('src/repro_torch/kernels/sampling/csrc/sampling.cu',
                       'src/repro/kernels/sampling/kernel.py:39'),
    'flash_attention': ('src/repro_torch/kernels/flash_attention/csrc/'
                        'flash_attention_sm90.cu',
                        'src/repro/kernels/flash_attention/kernel.py:33'),
    'wkv6': ('src/repro_torch/kernels/rwkv6/csrc/wkv6.cu',
             'src/repro/kernels/rwkv6/kernel.py:30'),
}
# the phase whose run is each kernel's main path (its `launches`)
MAIN_PHASE = {'flash_attention': 'prefill', 'wkv6': 'rwkv6_forward'}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--trace', action='store_true',
                    help='also profile the node, prefill and rwkv6 runs '
                         '(device time by kernel)')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    from repro_torch.kernels import common as kc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_identity()
    print(f'[1] card: {card}; torch {torch.__version__}, '
          f'CUDA {torch.version.cuda}')

    t0 = time.perf_counter()
    kc.kernel_library()
    log = kc.library_path().parent / 'build.log'
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if re.search(r'entry function|registers|spill', ln)]
    print(f'[2] build: {time.perf_counter() - t0:.1f} s '
          f'({kc.library_path()})')
    for ln in ptxas:
        print(f'  {ln}')
    sass = sass_counts(kc.library_path())
    for name, counts in sass.items():
        print(f'  SASS {" ".join(f"{op} {n}" for op, n in counts.items())}'
              f'  {name}')
    for kernel, ops in SASS_NEEDS.items():
        entries = [c for name, c in sass.items() if kernel in name]
        assert entries and all(c[op] > 0 for c in entries for op in ops), \
            f'{kernel}: expected {ops} in its SASS'
        print(f'  {kernel}: {", ".join(ops)} present in every instance')

    phase = time.perf_counter()

    def done() -> None:
        nonlocal phase
        print(f'  phase: {time.perf_counter() - phase:.1f} s')
        phase = time.perf_counter()

    print('[3] kernels vs plain versions')
    timer = Timer()
    results = kernel_checks(card, timer)
    del timer
    done()

    # the Witness's verdicts fail the run after the kernels line is printed
    print('[4] engine: qwen3-0.6b full width, plain path vs kernel path')
    witnessed = step_check(card)
    counts, failed = engine_check(card)
    by_phase, witnessed = {'engine_drain': counts}, witnessed + failed
    done()
    print('[5] node: online qwen3-0.6b + offline qwen3-0.6b, internlm2-1.8b')
    by_phase['node'], node_wall = node_check(card)
    if args.trace:
        from repro_torch.launch.serve import serve_demo
        node = full_width_node()
        device_profile('node', lambda: serve_demo(node=node, steps=400,
                                                  quiet=True),
                       card, node_wall)
    done()
    print('[6] prefill: qwen3-0.6b full width, B=2, S=2048, plain path vs '
          'kernel path')
    by_phase['prefill'] = prefill_check(card, args.trace)
    done()
    print('[7] rwkv6-3b forward: full width, B=4, T=2048, plain path vs '
          'kernel path')
    by_phase['rwkv6_forward'] = rwkv6_check(card, args.trace)
    done()
    print(f'[8] rwkv6-3b inference: full width, B={RWKV_B}, prefill '
          f'T={RWKV_T} through K6, {RWKV_DECODE} decode steps, plain path '
          f'vs kernel path')
    by_phase['rwkv6_inference'] = rwkv6_inference_check(card)
    done()
    print(f'[9] front-end: AsyncNodeDriver + FrontendApp over the full-width '
          f'node, {FRONT_STREAMS} loadgen streams + a {FRONT_BATCH}-prompt '
          f'batch job, 2 streams over a socket')
    by_phase['frontend'] = frontend_check(card)
    done()
    print('[10] CLI: python -m repro_torch.launch.serve --http --port 0')
    cli_check(card)
    done()
    print(f'[11] disaggregated plane: two full-width nodes, '
          f'{DISAGG_REQS} online requests, vs one colocated node')
    by_phase['disagg'] = disagg_check(card)
    done()
    print('[12] long engine drain: qwen3-0.6b full width, K1/K3 and K2 '
          'split')
    witnessed += engine_check(card, long=True)[1]
    done()

    print(f'[13] total {time.perf_counter() - t_start:.1f} s')
    kernels = []
    for name, r in results.items():
        src, replaces = SOURCES[name]
        kernels.append({
            'name': name, 'route': 'cuda', 'source': src,
            'replaces': replaces,
            'launches': by_phase[MAIN_PHASE.get(name, 'engine_drain')][name],
            'launches_by_phase': {p: n[name] for p, n in by_phase.items()},
            'max_abs_err': r['err'], 'ms': r['ms'], 'plain_ms': r['plain_ms'],
            'bound_ms': r['bound'][0], 'bound_by': r['bound'][1],
            'library_ms': r['library_ms']})
    print(card)
    print(json.dumps({'kernels': kernels}))
    assert not witnessed, witnessed
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
