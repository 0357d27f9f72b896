#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each fatal on failure:

1. card identity (``nvidia-smi`` name and power limit);
2. build the CUDA kernel library from the checkout's sources (nvcc, sm_90a);
3. every kernel against its plain PyTorch version at the main paths'
   shapes (qwen3-0.6b decode: B=8, Hq=16, Hkv=8, D=128, page 16, lengths
   1..512; the fused head at V=151936, D=1024; qwen3-0.6b prefill
   attention at B=2, S=4096; the rwkv6-3b WKV6 at B=4, T=2048, H=40,
   K=V=64), with times, bounds and a library yardstick, and mutants of
   each kernel that the checks must reject;
4. full-width qwen3-0.6b, held teacher-forced: every kernel-path decode
   step (one step at the kernel shapes of phase 3, then every step of an
   engine drain over a prefix-sharing KV pool) is also scored on the same
   cache state by the plain path and by the kernels' plain versions; the
   kernels stay within the spread of those two correct implementations,
   every sampled token is checked, shared page reads are saved and every
   kernel is launched;
5. the full-width Valve node (online qwen3-0.6b, offline qwen3-0.6b and
   internlm2-1.8b on one pool, ``serve.build_node``'s geometry) through
   ``serve_demo``: invariants, <= 1 preemption per request, all 12 offline
   requests finished;
6. full-width qwen3-0.6b whole-prompt prefill (``Model.prefill_fn``,
   B=2, S=2048, page 16) through the flash-attention kernel against the
   plain path, gated in f32, reported in bf16;
7. the full-width rwkv6-3b forward (``Model.loss_fn``, B=4, T=2048)
   through the WKV6 kernel against the plain path, gated in f32 and, in
   bf16, against the plain path's own chunk-32 / chunk-64 spread;
8. one JSON line of per-kernel results, then the result line.

It exits non-zero, printing no result, without a CUDA device or outside a
checkout.  ``--trace`` profiles the node run, one bf16 prefill and one bf16
rwkv6 forward once more each (device time by kernel, busy share).
"""
from __future__ import annotations

import argparse
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
FLASH_B, FLASH_S = 2, 4096         # qwen3-0.6b prefill attention
WKV_B, WKV_T, WKV_H, WKV_K = 4, 2048, 40, 64     # rwkv6-3b WKV6
WKV_CHUNK = 64
WKV_T_CHECK = 1000                 # the untimed WKV6 checks' length
PREFILL_B, PREFILL_S = 2, 2048
RWKV_B, RWKV_T = 4, 2048
DECODE_KERNELS = ('paged_decode', 'shared_run', 'shared_tail',
                  'unembed_sample')
DEV = 'cuda'


def card_identity() -> str:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


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
                                                         shared_run_ref)
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
    rel = max(max_rel(a, b) for a, b in zip(state, state_ref))
    assert rel <= STATE_RTOL, f'shared_run state rel err {rel}'
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
    n_bytes = V_QWEN * D_QWEN * 2 + last.numel() * 2 + B * 4
    results['unembed_sample'] = dict(
        err=worst, bound=bound(n_bytes, 2 * B * V_QWEN * D_QWEN),
        ms=timer(lambda: fused_unembed_sample(last, head, 0)),
        plain_ms=timer(lambda: unembed_sample_ref(last, head, 0)),
        library_ms=timer(lambda: torch.argmax(last @ head.T, dim=-1)))

    results['flash_attention'] = flash_check(timer)
    results['wkv6'] = wkv6_check(timer)

    for name, r in results.items():
        lib = 'none' if r['library_ms'] is None else f'{r["library_ms"]:.4f}'
        print(f'  {name}: err {r["err"]:.3e}  kernel_ms {r["ms"]:.4f}  '
              f'plain_ms {r["plain_ms"]:.4f}  library_ms {lib}  '
              f'bound_ms {r["bound"][0]:.4f} ({r["bound"][1]})  [{card}]')
    print(f'  (shared_run and shared_tail: library_ms is their pair\'s, SDPA '
          f'over the gathered shared-prefix KV)')
    return results


def flash_check(timer: Timer):
    """K5 at qwen3-0.6b's prefill widths: timed at B=2, S=4096, bf16,
    causal; checked also in f32 (S=1024), at an unaligned S=1000, and
    non-causal across Sq=256, Skv=1024; two mutants must fail."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models.common import attention

    gen = torch.Generator(device=DEV).manual_seed(5)

    def qkv(sq, skv, dtype):
        return [(torch.randn((FLASH_B, s, h, D), generator=gen, device=DEV)
                 * 0.5).to(dtype) for s, h in ((sq, HQ), (skv, HKV),
                                               (skv, HKV))]

    def f32_close(got, want):
        return bool(((got - want).abs()
                     <= F32_ATTN_TOL * (1 + want.abs())).all())

    for sq, skv, causal, dtype in ((1024, 1024, True, torch.float32),
                                   (1000, 1000, True, torch.bfloat16),
                                   (256, 1024, False, torch.bfloat16)):
        q, k, v = qkv(sq, skv, dtype)
        got = flash_attention(q, k, v, causal=causal)
        want = flash_attention_ref(q, k, v, causal=causal)
        close = f32_close if dtype == torch.float32 else attn_close
        assert close(got, want), \
            f'flash_attention {sq}x{skv} {dtype}: {max_err(got, want)}'
        print(f'  flash_attention Sq={sq} Skv={skv} causal={causal} '
              f'{str(dtype)[6:]}: max abs err {max_err(got, want):.3e}')

    q, k, v = qkv(FLASH_S, FLASH_S, torch.bfloat16)
    out = flash_attention(q, k, v)
    ref = flash_attention_ref(q, k, v)
    assert attn_close(out, ref), f'flash_attention {max_err(out, ref)}'
    pos = torch.arange(FLASH_S, device=DEV).expand(FLASH_B, FLASH_S)
    reject({
        'K5 with its last kv block dropped': (out, flash_attention_ref(
            q, k[:, :-64], v[:, :-64])),
        'K5 with the causal mask shifted by one': (out, attention(
            q, k, v, q_positions=pos + 1, kv_positions=pos)),
    }, attn_close)
    pairs = FLASH_S * (FLASH_S + 1) // 2            # causal (q, k) pairs
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return dict(
        err=max_err(out, ref),
        bound=bound(2 * (2 * q.numel() + k.numel() + v.numel()),
                    4 * FLASH_B * HQ * D * pairs),
        ms=timer(lambda: flash_attention(q, k, v)),
        plain_ms=timer(lambda: flash_attention_ref(q, k, v)),
        library_ms=timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)))


def wkv6_check(timer: Timer):
    """K6 at rwkv6-3b's widths: timed at B=4, T=2048, H=40, K=V=64, f32,
    chunk 64, against the sequential and the chunked plain versions;
    checked also at T=1000 in f32 and with bf16 inputs, and at log-decays
    down to -12 with chunk 8; two mutants must fail."""
    from repro_torch.kernels.rwkv6.ops import wkv6
    from repro_torch.kernels.rwkv6.ref import wkv6_chunked, wkv6_ref

    gen = torch.Generator(device=DEV).manual_seed(6)

    def inputs(t, decay_lo=-2.5):
        def randn(*shape, scale):
            return torch.randn(shape, generator=gen, device=DEV) * scale
        shape = (WKV_B, t, WKV_H, WKV_K)
        logw = decay_lo + (-0.005 - decay_lo) * torch.rand(
            shape, generator=gen, device=DEV)
        return [randn(*shape, scale=0.5), randn(*shape, scale=0.5),
                randn(*shape, scale=0.5), torch.exp(logw),
                randn(WKV_H, WKV_K, scale=0.3),
                randn(WKV_B, WKV_H, WKV_K, WKV_K, scale=0.1)]

    def check(xs, chunk, tol, what):
        y, s = wkv6(*xs, chunk=chunk)
        f32 = [x.float() for x in xs]
        errs = []
        for want in (wkv6_ref(*f32), wkv6_chunked(*f32, chunk=chunk)):
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
    }, lambda got, bad: wkv_close(got, bad, WKV_TOL))
    n_bytes = 4 * (4 * r.numel() + u.numel() + 2 * s0.numel() + y.numel())
    return dict(
        err=err,
        bound=bound(n_bytes, 4 * WKV_K * WKV_K * WKV_B * WKV_T * WKV_H,
                    F32_FLOPS_PER_S),
        ms=timer(lambda: wkv6(*xs, chunk=WKV_CHUNK)),
        plain_ms=timer(lambda: wkv6_chunked(*xs, chunk=WKV_CHUNK)),
        library_ms=None)


# ---------------------------------------------------------------------------
# Phase 4: full-width qwen3-0.6b, every kernel-path decode step witnessed
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_kernels():
    """Each attention kernel swapped for its plain version (``ref.py``): the
    kernel path's dataflow with another order of f32 sums, a second correct
    implementation -- the null of the score comparisons."""
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.paged_attention.ref import (paged_decode_ref,
                                                         shared_run_ref)
    saved = pa.paged_decode, pa.shared_run, pa.shared_tail
    pa.paged_decode = lambda q, k, v, pt, n, scale=None: paged_decode_ref(
        q, k, v, pt, n, scale=scale)
    pa.shared_run = shared_run_ref
    pa.shared_tail = lambda q, k, v, pt, st, n, state, scale=None: \
        paged_decode_ref(q, k, v, pt, n, start=st, state=state, scale=scale)
    try:
        yield
    finally:
        pa.paged_decode, pa.shared_run, pa.shared_tail = saved


class Witness:
    """A model whose fused decode steps are held, teacher-forced, to the
    plain path.  Before each step runs, it is scored on copies of the same
    cache state with the same batch three ways: P the plain path (gather
    oracle, unfused head), K the kernel path (K1, or K2 + K3 when the batch
    shares a prefix), N the null (:func:`plain_kernels`).

    Over 28 bf16 layers a single flipped bf16 rounding grows into a few
    percent of the scores, so K is held to the spread between two correct
    implementations: the median and the max of |K - P| / |max P| over every
    live row of every step stay within twice N's.  Every token the step
    samples (K4) must be K's argmax up to an f32-order tie (TIE_RTOL: K4
    sums the head in another order), and P's argmax unless the two plain
    scores lie within the null's reach on that row, 2 max |N - P|.  The
    launches made to score K are taken back off the counters."""

    def __init__(self, model):
        self.model = model
        self.k_diffs, self.n_diffs, self.flips = [], [], []
        self.tokens = 0

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
        with plain_kernels():
            null = scores(batch, True)
        LAUNCHES.update(counts)
        cache, toks = self.model.decode_sample_fn(
            params, cache, batch, use_kernel=True, temperature=0.0)
        live = (batch['page_table'][:, 0] != 0).nonzero()[:, 0]
        self._check(toks[live], plain[live], kern[live], null[live])
        return cache, toks

    def _check(self, toks, plain, kern, null):
        top = plain.abs().amax(-1, keepdim=True)
        self.k_diffs.append(((kern - plain).abs() / top).flatten())
        self.n_diffs.append(((null - plain).abs() / top).flatten())
        reach = 2 * (null - plain).abs().amax(-1)
        for r, a in enumerate(toks.tolist()):
            kb, pb = int(kern[r].argmax()), int(plain[r].argmax())
            assert a == kb or near_tie(kern[r], a, kb), \
                f'fused token {a} vs kernel-path argmax {kb}'
            if a != pb:
                gap = (plain[r, pb] - plain[r, a]).item()
                assert gap <= reach[r].item(), (
                    f'token {a} vs plain argmax {pb}: plain-score gap '
                    f'{gap:.6f} beyond the null reach {reach[r].item():.6f}')
                self.flips.append(gap / top[r].item())
        self.tokens += len(toks)

    def verdict(self, what: str, card: str) -> None:
        k, n = torch.cat(self.k_diffs), torch.cat(self.n_diffs)
        k_med, k_max = k.median().item(), k.max().item()
        n_med, n_max = n.median().item(), n.max().item()
        flips = ', '.join(f'{g:.3e}' for g in self.flips) or 'none'
        print(f'  {what}: {self.tokens} tokens; |kernel - plain| median '
              f'{k_med:.3e}, max {k_max:.3e} of |max|; null {n_med:.3e}, '
              f'{n_max:.3e}; tokens off the plain argmax: '
              f'{len(self.flips)} (plain-score gaps {flips} of |max|)  '
              f'[{card}]')
        assert k_med <= 2 * n_med and k_max <= 2 * n_max, what


def step_check(card: str) -> None:
    """One full-width qwen3-0.6b decode step at phase 3's kernel shapes
    (B=8, contexts 65..512 over a shared 4-page prefix), through K1 and
    through K2 + K3, each held by a :class:`Witness`."""
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
    for name, b in (('paged_decode', batch),
                    ('shared_run+shared_tail', dict(batch, shared=shared))):
        witness = Witness(model)
        witness.decode_sample_fn(params, {k: v.clone()
                                          for k, v in base.items()}, b,
                                 use_kernel=True, temperature=0.0)
        witness.verdict(f'one decode step, {model.cfg.n_layers} layers, '
                        f'{name} + unembed_sample', card)


def engine_check(card: str):
    """Drain a prefix-shared trace through the plain path and through the
    kernel path, the latter's every decode step held by a
    :class:`Witness`; the two drains' tokens are compared for the record
    (greedy decoding carries a tie's flip forward)."""
    from repro_torch.configs import get_config
    from repro_torch.core.memory import MemoryPlane
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.models.api import build_model
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.serving.kvpool import KVPool

    model = build_model(get_config('qwen3-0.6b'))
    params = model.init_params(0, device=DEV)
    prompt = np.random.default_rng(7).integers(
        1, model.cfg.vocab_size, 3 * model.cfg.page_size).tolist()  # 3 pages

    def drain(kernels: bool):
        pool = KVPool(16, 4, page_size=model.cfg.page_size,
                      reserved_handles=1)
        MemoryPlane(pool, sharing=True)
        witness = Witness(model) if kernels else None
        eng = Engine(witness or model, params, pool, EngineConfig(
            max_batch=4, max_seq=96, prefill_chunk=32,
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

    plain, _, _ = drain(False)
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    fast, stats, witness = drain(True)
    launches = dict(LAUNCHES)
    witness.verdict('engine drain, every decode step', card)
    assert stats.shared_page_reads_saved > 0, 'no shared page reads saved'
    assert all(launches[k] > 0 for k in DECODE_KERNELS), launches
    first = [next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
             for a, b in zip(fast, plain)]
    print(f'  engine drain: {sum(map(len, fast))} tokens, kernel drain vs '
          f'plain drain first differing token per request {first}, '
          f'shared_page_reads_saved {stats.shared_page_reads_saved}, '
          f'token_flushes {stats.token_flushes}, launches {launches}  '
          f'[{card}]')
    return launches


# ---------------------------------------------------------------------------
# Phase 5: the full-width node
# ---------------------------------------------------------------------------

def full_width_node():
    """``serve.build_node``'s node (pool geometry, engine settings, seeds)
    at the published widths, page 16, fused sampling on every engine."""
    from repro_torch.configs import get_config
    from repro_torch.core.clock import RealClock
    from repro_torch.core.runtime import RuntimeConfig, ValveRuntime
    from repro_torch.launch.node import NodeOrchestrator
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.kvpool import KVPool

    pool = KVPool(n_handles=24, pages_per_handle=8, page_size=PG,
                  reserved_handles=2)
    rt = ValveRuntime(pool, RuntimeConfig(n_devices=1, t_cool_init=0.002),
                      clock=RealClock())
    node = NodeOrchestrator(rt, idle_advance=1e-3)
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
    """``--trace``: ``run()`` once more under ``torch.profiler``, device
    activity only: device time by kernel, and the device's busy share of
    the untraced wall time (the profiler slows the host, not the
    kernels).  Without ``wall``, an untraced run first gives it."""
    from torch.profiler import ProfilerActivity, profile

    if wall is None:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    print(f'  {what}: device busy {busy:.3f} s of {wall:.3f} s untraced '
          f'wall: {busy / wall:.3%} busy, {1 - busy / wall:.3%} idle; '
          f'{sum(e.count for e in kernels)} device activities  [{card}]')
    for e in kernels[:12]:
        print(f'  {e.self_device_time_total / 1e3:10.3f} ms  {e.count:7d}x  '
              f'{e.key[:90]}')


# ---------------------------------------------------------------------------
# Phase 6: whole-prompt prefill; phase 7: the rwkv6 forward
# ---------------------------------------------------------------------------

def prefill_check(card: str, trace: bool = False):
    """Full-width qwen3-0.6b prefill on a global pool, kernel path (K5 in
    every layer) against the plain path (``chunked_attention``) on copies
    of the same empty pool.  f32 weights and pools: last-token scores
    within 1e-3 of |max|, the same argmax, KV pools within 1e-3.  bf16:
    the spread is reported, as phase 4 reports its null.  ``trace``
    profiles one bf16 kernel-path prefill."""
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
    launches = None
    for dtype in (torch.float32, torch.bfloat16):
        params = model.init_params(0, device=DEV).to(dtype)
        out, secs = {}, {}
        for use_kernel in (True, False):
            cache = {k: v.to(dtype) for k, v in model.init_cache(
                engine_pages=n_pages, device=DEV).items()}
            if launches is None:
                for k in LAUNCHES:
                    LAUNCHES[k] = 0
            t0 = time.perf_counter()
            out[use_kernel] = model.prefill_fn(params, cache, batch,
                                               use_kernel=use_kernel)
            torch.cuda.synchronize()
            secs[use_kernel] = time.perf_counter() - t0
            if launches is None:
                launches = dict(LAUNCHES)
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
        elif trace:
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
                        'flash_attention.cu',
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

    print('[4] engine: qwen3-0.6b full width, plain path vs kernel path')
    step_check(card)
    by_phase = {'engine_drain': engine_check(card)}
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

    print(f'[8] total {time.perf_counter() - t_start:.1f} s')
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
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
