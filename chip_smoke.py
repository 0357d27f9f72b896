#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each fatal on failure:

1. card identity (``nvidia-smi`` name and power limit);
2. build the CUDA kernel library from the checkout's sources (nvcc, sm_90a);
3. every kernel against its plain PyTorch version at the main path's
   shapes (qwen3-0.6b decode: B=8, Hq=16, Hkv=8, D=128, page 16, lengths
   1..512; the fused head at V=151936, D=1024), with times, bounds and a
   library yardstick;
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
6. one JSON line of per-kernel results, then the result line.

It exits non-zero, printing no result, without a CUDA device or outside a
checkout.  ``--trace`` profiles the node run once more (device time by
kernel, busy share).
"""
from __future__ import annotations

import argparse
import contextlib
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
ATTN_ATOL = 1e-3                   # bf16 attention outputs, elementwise:
ATTN_RTOL = 2 ** -7                # |out - ref| <= atol + rtol |ref|
STATE_RTOL = 1e-4                  # f32 partial softmax state, rel err
TIE_RTOL = 1e-3                    # token ties: top-2 gap <= 1e-3 * |max|
REPS = 25

B, HQ, HKV, D, PG, MAXP = 8, 16, 8, 128, 16, 32
V_QWEN, D_QWEN = 151_936, 1024
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


def bound(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / BF16_FLOPS_PER_S * 1e3
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
    for name, (got, bad) in mutants.items():
        bad_err = (got.float() - bad.float()).abs().max().item()
        assert not attn_close(got, bad), f'the check passes a {name}'
        print(f'  the check rejects a {name}: max abs err {bad_err:.3e}')
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
        library_ms=None)

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

    for name, r in results.items():
        lib = 'n/a' if r['library_ms'] is None else f'{r["library_ms"]:.4f}'
        print(f'  {name}: err {r["err"]:.3e}  kernel_ms {r["ms"]:.4f}  '
              f'plain_ms {r["plain_ms"]:.4f}  library_ms {lib}  '
              f'bound_ms {r["bound"][0]:.4f} ({r["bound"][1]})  [{card}]')
    return results


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
    assert all(n > 0 for n in launches.values()), launches
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


def node_trace(card: str, wall: float) -> None:
    """``--trace``: the phase-5 node run once more under ``torch.profiler``,
    device activity only: device time by kernel, and the device's busy
    share of the untraced run's wall time (the profiler slows the host,
    not the kernels)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import serve_demo

    node = full_width_node()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        serve_demo(node=node, steps=400, quiet=True)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    print(f'  node device busy {busy:.3f} s of {wall:.3f} s untraced wall: '
          f'{busy / wall:.3%} busy, {1 - busy / wall:.3%} idle; '
          f'{sum(e.count for e in kernels)} device activities  [{card}]')
    for e in kernels[:12]:
        print(f'  {e.self_device_time_total / 1e3:10.3f} ms  {e.count:7d}x  '
              f'{e.key[:90]}')


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
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--trace', action='store_true',
                    help='also profile the node run (device time by kernel)')
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

    print('[3] kernels vs plain versions')
    timer = Timer()
    results = kernel_checks(card, timer)

    print('[4] engine: qwen3-0.6b full width, plain path vs kernel path')
    step_check(card)
    engine_launches = engine_check(card)
    print('[5] node: online qwen3-0.6b + offline qwen3-0.6b, internlm2-1.8b')
    node_launches, node_wall = node_check(card)
    if args.trace:
        node_trace(card, node_wall)

    print(f'[6] total {time.perf_counter() - t_start:.1f} s')
    kernels = []
    for name, r in results.items():
        src, replaces = SOURCES[name]
        kernels.append({
            'name': name, 'route': 'cuda', 'source': src,
            'replaces': replaces, 'launches': engine_launches[name],
            'launches_node': node_launches[name],
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
