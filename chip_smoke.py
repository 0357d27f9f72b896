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
   internlm2-1.8b's head (V=92544, D=2048) on a line of its own; K1, K2
   and K3 at phi3.5-moe's decode shape (Hq=32 over Hkv=8, GQA group 4),
   checked with mutants and timed on lines of their own;
4. full-width qwen3-0.6b, held teacher-forced: every kernel-path decode
   step (one step at the kernel shapes of phase 3, then every step of an
   engine drain over a prefix-sharing KV pool with short tables, its new
   tokens **cut to 8 a request**) is also
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
    K3 and K2 split over CTAs, gated the same way, its new tokens **cut to
    8 a request** (as in phases 4, 16 and 18);
13. MoE serving: phi3.5-moe at its published widths (d_model 4096, 32/8
    heads, 16 experts of d_ff 6400, top-2, vocab 32064, bf16), depth cut
    to 16 of 32 layers so that the weights leave room on the card: phase
    4's drain with prefix sharing, every kernel-path decode step (K1, or K2
    + K3) held to the plain path by the Witness and gated the same way,
    the routing's differences and drops printed; one decode step timed
    (host clock, synchronized) against the least time to read its
    weights; then ``serve_demo`` on
    ``build_node``'s geometry at page 16 with online qwen3-0.6b (fused
    sampling) and offline phi3.5-moe (unfused): invariants, <= 1
    preemption per request, all 6 offline requests finished, K1 launched
    by the MoE engine (the Witnesses' verdicts come last, so that a
    failure leaves every other phase's numbers printed);
14. training: ``launch.train.train`` on full-width qwen3-0.6b (28
    layers, bf16 weights, f32 AdamW moments), B=4, S=2048, 12 steps with a
    checkpoint at step 8: finite losses and gradient norms, the loss
    falling (mean of the last 4 below the first 4), then a restart from
    the checkpoint retracing steps 8-11 within 2e-2; qwen3-0.6b cut to 2
    of 28 layers in f32, weights drawn on the CPU: the loss within 1e-5
    relative and every gradient leaf within 1e-4 of its max |g| against
    the CPU, and 2 microbatches against 1 within 1e-5; ``python -m
    repro_torch.launch.train`` at full width as a child process (exit 0,
    step_4 committed, no .tmp); the step's time, tokens/s, model FLOPs
    and their share of the bf16 peak, peak memory; no hand-written kernel
    launched (the reference trains through none);
15. the hybrid and encoder-decoder families, which run no hand-written
    kernel (as the reference runs no Pallas kernel for them; the phase's
    launch counts must be 0): (a) zamba2-2.7b at published widths, all 54
    layers, f32: a prefill of 511 tokens into a global pool at page 16 and
    one decode step against a prefill of 512 (scores within 1e-3 of |max|,
    argmax equal, the Mamba states within 1e-3), then the long-context
    step over the same KV gathered into contiguous rows against the paged
    step; (b) the chunked SSD against the sequential recurrence at
    zamba2's shapes (B=2, T=2048, H=80, P=64, N=64, f32) within 1e-4 (1 +
    |y|); (c) f32 card against CPU: zamba2 cut to 12 of 54 layers (a
    256-token prefill, 4 decode steps) and seamless-m4t-medium (256
    frames, 32 decoder tokens, 4 decode steps), scores and caches within
    1e-4, greedy tokens equal, and zamba2 cut to 6 layers through
    ``loss_and_grads`` at S=256 under phase 14's rule; (d) bf16 at full
    width, B=2: zamba2 prefill of 2048 and 16 greedy steps, seamless over
    2048 frames with a 256-token decoder prefix and 16 greedy steps, the
    last step's argmax equal to a longer prefill's or a near tie, with
    prefill and decode times, tokens/s and peak memory; (e) two training
    steps of each at full width (bf16 weights, f32 moments, B=1, S=2048),
    finite, with step times and peak memory;
16. tensor-parallel serving (``EngineConfig.mesh``), qwen3-0.6b at
    published widths, ranks spawned by ``launch.ranks.run_ranks``: (a) a
    mesh of one rank over NCCL, phase 4's drain (its new tokens **cut to
    8 a request**, as in phase 18) at **14 of 28 layers** unfused through
    K1/K2/K3:
    every token and every live row's scores bit-equal to the meshless
    drain; (b) two ranks sharing the card over gloo (``model`` = 2, 4
    kv-heads each): an f32 drain with the **depth cut to 4 of 28 layers**
    (greedy tokens equal to the meshless drain's, scores within 1e-4 of
    |max|), then the bf16 drain at 14 of 28 layers (as (a) and (c))
    with ``decode_kernel=True``,
    every decode step held by the Witness rule to the meshless plain path
    on the pool gathered from both ranks, K1/K2/K3 launched on each rank;
    (c) online and offline engines on that mesh under a runtime with a gate
    a device: an online burst gives at most 1 preemption per (request,
    device), 2 device latencies an event; ms a decode step at meshless,
    mesh 1 and mesh 2 printed (two ranks time-slicing one card: recorded,
    not a claim);
17. training over a mesh (``make_train_step(model, mesh)``,
    ``launch.train.train(mesh=...)``), ranks spawned by
    ``launch.ranks.run_ranks``, two sharing the card over gloo: (a)
    qwen3-0.6b at published widths with the **depth cut to 2 of 28
    layers**, f32, one step of 2 microbatches with a loss mask that gives
    the data shards different token counts, at (data 2, model 1) and (data
    1, model 2) against the meshless step on the card: loss and grad_norm
    within 1e-5 relative, every gradient and parameter leaf within 1e-5 of
    its max; ZeRO-1 on against off bit-equal; (b) the **depth cut to 7 of
    28 layers**, bf16 weights, f32 moments, (2, 1), global B=4, S=2048, 4
    steps with a checkpoint at step 2 from both ranks, 2 steps at (1, 2),
    then ``plan_recovery``'s shrink to one rank,
    which restores it and runs steps 2-3 within 2e-2 of the unbroken run;
    step times, the gradient reduce's bytes and seconds a step, peak memory
    a rank; (c) the int8 compressed all-reduce of a (7, 1024, 3072) f32
    leaf ((b)'s ``wg`` stack), on the card bit-equal to the same ranks'
    round on host tensors, the error falling after the feedback round; 0
    hand-written kernel launches;
18. data- and expert-parallel serving, ranks sharing the card over gloo:
    (a) qwen3-0.6b at published widths on (data 2, model 1) and (data 2,
    model 2) (2 and 4 ranks, each dispatch's rows over ``data``): phase
    16's f32 drain (8 new tokens a request) with the **depth cut to 4 of
    28 layers** (tokens equal
    to the meshless drain, scores and the gathered pool within 1e-4),
    then the bf16 drain at **14 of 28 layers** with K1/K2/K3 and K4 on
    (fused
    sampling: K4 on each rank's vocabulary block, the bests combined over
    ``model``), every step under phase 16's two Witness gates, K1-K4
    launched on every rank, every replica's pool bit-equal; the burst on
    (2, 2) with 4 gates; (b) phi3.5-moe at published widths on (data 1,
    model 2), 8 experts a rank, K1/K2/K3 at G=4 on each rank's 4
    kv-heads: f32 at **2 of 32 layers** (tokens equal to the meshless
    drain, drops in the calls), bf16 at phase 13's **16 of 32 layers**,
    each rank's blocks of its weights drawn on the card a leaf at a time
    (no card holds the whole set; rank 0's peak below it), every decode
    step under the MoE Witness
    over the mesh's own plain path and nulls (probe dispatches on every
    rank), the routing flips printed; (c) K4 over 2 and 4 blocks of the
    151936 x 1024 head, T = 0 and 0.8, ties planted across a block edge:
    the combine bit-equal to K4 over the whole head, a mutant drawing
    noise at local columns rejected, each block's and the combine's time
    against bounds and library calls; (d) phi3.5-moe training at **1 of
    32 layers**, f32, (1, 2), under phase 17 (a)'s gates; 0 launches;
19. tensor-parallel training of the other families, two ranks sharing
    the card over gloo at (data 1, model 2): rwkv6-3b (**2 of 32
    layers**), zamba2-2.7b (**12 of 54**: two applications of the shared
    block) and seamless-m4t-medium (**2 + 2 of 12 + 12**) at published
    widths; (a) f32, one step of 2 microbatches with a loss mask against
    the meshless step on the card: loss within 1e-5 relative, grad_norm,
    every gradient leaf (of its max) and every leaf's update (in lr)
    within 1e-5 / 1e-5 / 0.25, or within twice the meshless step's own
    spread over its nulls where that is larger (every f32 product summed
    in two halves of its inner dimension, or of its columns, and the
    recurrence at chunk 64), seamless's exact-zero ``xbk`` gradient held
    apart; (b) two bf16 steps (B=4, **S=512**, cut from 1024) at (1, 2)
    beside two meshless
    ones, their times and each rank's peak memory; 0 launches;
20. the serve step (``training.train_step.make_serve_step``) over the
    per-request region KV layout and the dry-run's cost report
    (``launch/dryrun.py``): (a) qwen3-0.6b at published widths, meshless,
    in f32 and in bf16: a prefill of B=4 prompts of 1024 tokens into a
    region cache sized for 2048, then 16 greedy decode steps, beside the
    same calls on the engine's global pool holding the same pages in the
    same order: every step's scores and tokens bit-equal; (b) ``run_cell``
    of that prefill and decode with ``measure=True``: the record, the
    measured ms of a step against the roofline's max(compute, memory) and
    the measured peak memory against argument + output + temp; (c) two
    production records of the shape-only count, qwen3-0.6b x decode_32k
    and x train_4k on the (16, 16) mesh, ``status: ok``; 0 launches;
21. the serve step on a mesh for the other families, two ranks sharing
    the card over gloo: (a) rwkv6-3b (**2 of 32 layers**), zamba2-2.7b
    (**12 of 54**) and seamless-m4t-medium (**2 + 2 of 12 + 12**) at
    published widths, ``make_serve_step`` on (data 1, model 2): a prefill
    of B=4 prompts of 512 tokens (seamless: 512 frames and a 64-token
    decoder prefix, every row on pages of its own) and 4 decode steps
    against the meshless step on the card, f32 scores within 1e-4 of
    |max| with argmax equal, bf16 scores within twice the meshless step's
    own nulls (every bf16 product in two halves of its sum, or of its
    columns; the argmax flips of the mesh and of the nulls printed), the
    steps' times recorded; zamba2 at long_500k on (data 2, model 1), f32, from a
    seeded random cache of 16384 slots split over ``data``, 4 steps across
    the blocks' boundary: the same f32 gate, both replicas' scores
    bit-equal; (b) K6 over each rank's 20 of 40 wkv heads
    (``prefill_fn(use_kernel=True, tp=)``, B=4, T=2048) against the rank's
    plain prefill under phase 8's gates; (c) the dry-run's zamba2-2.7b x
    long_500k and rwkv6-3b x decode_32k on the (16, 16) layout at full
    depth, rank 0's step measured on the card; K6 the only kernel
    launched;
22. the serve step under the rule variants ``serve_kv_dp``, ``serve_seq``
    and ``serve_dh``, two ranks sharing the card over gloo at (data 1,
    model 2): (a) qwen3-0.6b (**4 of 28 layers**) and phase 21's three
    families at their depths, published widths, each under each variant
    (rwkv6's serve_seq plan is the default's: phase 21 runs it), phase
    21's prefill and 4 decode steps against the meshless step on the card:
    f32 within 1e-4 of |max| with argmax equal, what the variant
    replicates over ``model`` (the pool under serve_kv_dp; rwkv6's and
    zamba2's states under serve_kv_dp and serve_dh) bit-equal on both
    ranks, bf16 under phase 21's rule (the median row's error against the
    meshless f32 step within 1.4 x the meshless bf16 step's); each
    variant's planted fault on qwen3 (the partial scores not summed, one
    rank's softmax state dropped, one replica skipping the new token's
    write) failing the f32 gate (b); (c) rank 0 of qwen3-0.6b x decode_32k
    on the (16, 16) layout under each variant, counted and measured on the
    card (serve_kv_dp holds the 30.3 GB replicated pool); 0 launches;
23. training under the rule variants (``make_train_step(rules=)``), two
    ranks sharing the card at (data 1, model 2): qwen3-0.6b (**2 of 28
    layers**) under ``serve_dh``, ``serve_kv_dp`` and ``serve_seq``, phase
    19's families at its depths under the first two; phase 19's f32 gates
    against the meshless step, every leaf a rank holds whole bit-equal on
    both ranks, one planted fault a variant past the gradient gate; two
    bf16 steps timed; 0 launches;
24. the reference's head_dim placement where ``model`` does not divide the
    attention heads: qwen3-14b (**2 of 40 layers**) at published widths on
    (data 1, model 16), 16 gloo ranks sharing the card, each holding 4 of
    the 64 RoPE pairs of every head in the projections, ``wo`` and the
    pool: the serve step's prefill of B=4 x 64 and 4 decode steps against
    the meshless step, f32 within 1e-4 of |max| with argmax equal, a
    planted fault (one rank's partial scores not summed) past that gate,
    bf16 under phase 21's rule; each rank's cache bytes the dry-run's
    count of the reference's block; one f32 training step (B=2, S=64)
    under phase 19's gates; 0 launches; then, on the same ranks, the mesh
    engine under the reference engine's placement (``tp.engine_plan``, the
    same blocks of RoPE pairs in the global pool), rank 0 opened on its
    own blocks: three requests of a 64-token prompt, 4 new tokens each,
    through mixed and decode dispatches, the plain path; f32 greedy
    tokens equal to the meshless engine's, every dispatch's scores within
    1e-4 of |max|, the planted fault past that gate; bf16 fused sampling
    (K4 on every rank's vocabulary block, the main path of this check)
    against the argmax of the bf16 unfused drain's scores or a near tie;
    each rank's weight and pool bytes the reference's; K1-K3 not launched;
    K4 alone on a rank's block of qwen3-14b's head (9496 x 5120, a width
    whose ``last`` takes most of the kernel's shared memory) against its
    plain version, and timed;
25. the reference's placement where ``model`` does not divide rwkv6's wkv
    heads or the vocabulary, on phase 24's 16 ranks at published widths:
    rwkv6-3b (**2 of 32 layers**; each rank 4 of the 64 value channels of
    every head, the ``wkv`` state (L, B, 40, 64, 4)) and
    seamless-m4t-medium (**2 + 2 of 12 + 12 layers**; the embedding and
    the head cut on d_model), each under phase 24's gates with its own
    planted fault (rank 1's group-norm squares, rank 1's head partial, not
    summed over ``model``); rwkv6's prefill through K6 on every rank's
    value block against the plain chunked path on that block; K6 timed
    alone at (4, 64, 40, 64, 4); K6 the only kernel launched;
26. the reference's placement of long_500k's one row, which no batch
    axis divides, under ``serve_kv_dp``, ``serve_seq`` and ``serve_dh``
    (``tp.StepParallel.moved``), on 4 ranks sharing the card at (data 2,
    model 2), f32, published widths: zamba2-2.7b (**12 of 54 layers**, a
    seeded random cache of 16384 slots) and rwkv6-3b (**2 of 32
    layers**), B = 1, 4 decode steps from position 8190: scores within
    1e-4 of |max| of the meshless step on the card, argmax equal, every
    rank's scores bit-equal, every rank's cache bytes the dry-run's count
    of its block under the reference's specs; a planted fault of each new
    collective past the gate; one f32 training step of qwen3-0.6b (**2 of
    28 layers**) at (2, 2) under ``TRAIN_RULES``, its batch's sequence
    split over ``model`` (each rank's batch bytes the reference's), its
    gradients within 1e-5 of the meshless step's, bit-equal to the step
    under ``TRAIN_NO_SP_RULES``, its sequence blocks swapped past the
    gate; no kernel launched;
27. one JSON line of per-kernel results, then the result line.

It exits non-zero, printing no result, without a CUDA device or outside a
checkout.  ``--trace`` profiles the node run, one bf16 prefill, one bf16
rwkv6 forward, one MoE decode step, one full-width training step and one
zamba2 bf16 prefill and decode step once more each (device time by kernel,
busy share, idle gaps).
"""
from __future__ import annotations

import argparse
import asyncio
import contextlib
import functools
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path
from typing import Optional

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / 'src'))

from repro_torch.launch.mesh import HBM_BW as HBM_BYTES_PER_S  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    PEAK_FLOPS_BF16 as BF16_FLOPS_PER_S)

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
SPIN_CYCLES_PER_S = 2e9            # torch.cuda._sleep's cycles a second,
                                   # near the H100's 1.98 GHz boost clock

B, HQ, HKV, D, PG, MAXP = 8, 16, 8, 128, 16, 32
MOE_HQ = 32                        # phi3.5-moe: 32 query heads over HKV
V_QWEN, D_QWEN = 151_936, 1024
V_INTERN, D_INTERN = 92_544, 2048  # internlm2-1.8b's head (offline engine)
FLASH_B, FLASH_S = 2, 4096         # qwen3-0.6b prefill attention
WKV_B, WKV_T, WKV_H, WKV_K = 4, 2048, 40, 64     # rwkv6-3b WKV6
WKV_CHUNK = 64
WKV_T_CHECK = 1000                 # the untimed WKV6 checks' length
LONG_MAXP = 256                    # K1 at a 4096-token context
DRAIN_NEW_TOKENS = 8               # phases 4 and 12: new tokens a request,
                                   # cut from 16 (the time limit)
PREFILL_B, PREFILL_S = 2, 2048
RWKV_B, RWKV_T = 4, 2048
RWKV_DECODE = 16                   # greedy decode steps after the prefill
FRONT_STREAMS, FRONT_BATCH = 16, 12  # loadgen streams, batch-job prompts
DISAGG_REQS, DISAGG_PROMPT, DISAGG_NEW = 8, 64, 24
SERVE_TIMEOUT_S = 300              # bounds a serving phase that stalls
MOE_ARCH, MOE_LAYERS = 'phi3.5-moe-42b-a6.6b', 16   # depth cut, of 32
TRAIN_ARCH = 'qwen3-0.6b'           # the training phase, full width
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_CKPT = 4, 2048, 12, 8
TRAIN_LR, TRAIN_WARMUP = 3e-4, 2
RESTART_TOL = 2e-2                 # restart vs first run (reference test's)
PARITY_LAYERS, PARITY_S = 2, 512   # f32 card vs CPU: depth cut, of 28
TRAIN_LOSS_RTOL = 1e-5             # f32 loss, card vs CPU
TRAIN_GRAD_TOL = 1e-4              # f32 gradients: of each leaf's max |g|
MICRO_TOL = 1e-5                   # 2 microbatches vs 1: loss, gradients
CLI_TRAIN = ('--steps', '4', '--batch', '2', '--seq', '256',
             '--ckpt-every', '4')      # one checkpoint, step_4 (the time)
HYBRID_ARCH, ENCDEC_ARCH = 'zamba2-2.7b', 'seamless-m4t-medium'
ID_B, ID_T = 2, 511                # zamba2 f32: prefill T + 1 step vs T + 1
SSD_B, SSD_T, SSD_H, SSD_P, SSD_N = 2, 2048, 80, 64, 64   # zamba2's SSD
SSD_TOL = 1e-4                     # f32 SSD: |got - want| <= tol (1 + |want|)
CPU_TOL = 1e-4                     # f32 card vs CPU: scores of |max|, caches
CPU_LAYERS, CPU_T, CPU_DECODE = 12, 256, 4   # zamba2 depth cut, of 54
ENC_S, ENC_DEC = 256, 32           # seamless card vs CPU: frames, tokens
GRAD_LAYERS, GRAD_S = 6, 256       # zamba2 loss_and_grads: depth cut, of 54
BF16_B, BF16_T, BF16_DECODE = 2, 2048, 16
FAM_S, TRAIN_FAMILY_STEPS = 2048, 2
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

    def __call__(self, fn, reps: int = REPS,
                 spin_s: Optional[float] = None) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()                        # the host's enqueue of one call alone
        enqueue = time.perf_counter() - t0
        torch.cuda.synchronize()
        # the spin outlasts the enqueue 4x over (at least 2 ms; a slower
        # clock only lengthens it), or lasts ``spin_s``
        cycles = int((spin_s or max(4 * enqueue, 2e-3)) * SPIN_CYCLES_PER_S)
        times = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(cycles)
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
    # the timer against a fixed 25 ms spin (its earlier form), paired in
    # the order fixed, sized, sized, fixed
    k1 = functools.partial(pa.paged_decode, q, pool_k, pool_v, pt, lengths)
    fixed = [timer(k1, spin_s=25e-3)]
    sized = [timer(k1), timer(k1)]
    fixed.append(timer(k1, spin_s=25e-3))
    print(f'  timer, K1: {" / ".join(f"{t:.4f}" for t in sized)} ms with '
          f'the spin sized to the enqueue, '
          f'{" / ".join(f"{t:.4f}" for t in fixed)} ms with a fixed 25 ms '
          f'spin')

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
    group4_check(card, timer)
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


def group4_check(card: str, timer: Timer) -> None:
    """K1, K2 and K3 at phi3.5-moe's decode shape, GQA group 4: B=8,
    Hq=32, Hkv=8, D=128, page 16, 32 pages a row, lengths 1..512, and K2 +
    K3 over a shared 4-page prefix, against their plain versions with the
    phase's tolerances, each with a mutant the check must reject, two calls
    bit-equal; timed beside SDPA over the gathered KV, on lines of their
    own."""
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.paged_attention.prefix import build_shared_runs
    from repro_torch.kernels.paged_attention.ref import (paged_decode_ref,
                                                         shared_run_ref,
                                                         shared_run_split_ref)
    from repro_torch.models.common import paged_gather

    rng = np.random.default_rng(12)
    hq, g = MOE_HQ, MOE_HQ // HKV
    n_pages = 1 + B * MAXP
    pool_k, pool_v = (torch.tensor(rng.normal(size=(n_pages, PG, HKV, D))
                                   * 0.5, dtype=torch.bfloat16, device=DEV)
                      for _ in range(2))
    q = torch.tensor(rng.normal(size=(B, HKV, g, D)) * 0.5,
                     dtype=torch.bfloat16, device=DEV)
    lengths_np = np.linspace(1, MAXP * PG, B).astype(np.int32)
    rng.shuffle(lengths_np)
    pt_np = (rng.permutation(n_pages - 1)[:B * MAXP] + 1).reshape(
        B, MAXP).astype(np.int32)
    pt, lengths = (torch.tensor(a, device=DEV) for a in (pt_np, lengths_np))
    q_sdpa = q.reshape(B, hq, 1, D)

    def sdpa(table, lens):
        kg, vg = (paged_gather(pool, table).permute(0, 2, 1, 3)
                  for pool in (pool_k, pool_v))
        mask = (torch.arange(MAXP * PG, device=DEV)[None, :]
                < lens[:, None])[:, None, None, :]
        return timer(lambda: F.scaled_dot_product_attention(
            q_sdpa, kg, vg, attn_mask=mask, enable_gqa=True))

    out = pa.paged_decode(q, pool_k, pool_v, pt, lengths)
    ref = paged_decode_ref(q, pool_k, pool_v, pt, lengths)
    assert attn_close(out, ref), f'K1 at G={g}: {max_err(out, ref)}'
    assert torch.equal(out, pa.paged_decode(q, pool_k, pool_v, pt, lengths)),\
        f'K1 at G={g}: two calls differ'
    dropped = lengths.clone()
    dropped[int(lengths_np.argmax())] -= PG
    mutants = {f'K1 at G={g}, dropped page': (out, paged_decode_ref(
        q, pool_k, pool_v, pt, dropped))}
    live = int(np.ceil(lengths_np / PG).sum())
    t_bound, by = bound(live * PG * HKV * D * 2 * 2 + 2 * q.numel() * 2
                        + live * 4 + B * 4, 4 * hq * D * int(lengths_np.sum()))
    ms = timer(lambda: pa.paged_decode(q, pool_k, pool_v, pt, lengths))
    plain = timer(lambda: paged_decode_ref(q, pool_k, pool_v, pt, lengths))
    print(f'  paged_decode at phi3.5-moe\'s decode shape (B={B}, Hq={hq}, '
          f'Hkv={HKV}, G={g}, D={D}, lengths 1..{MAXP * PG}): err '
          f'{max_err(out, ref):.3e}; two calls bit-equal; kernel_ms '
          f'{ms:.4f}  plain_ms {plain:.4f}  library_ms {sdpa(pt, lengths):.4f} '
          f'(SDPA, gathered KV)  bound_ms {t_bound:.4f} ({by})  [{card}]')

    n_shared = 4
    spt_np = pt_np.copy()
    spt_np[:, :n_shared] = pt_np[0, :n_shared]
    slen_np = np.linspace(n_shared * PG + 1, MAXP * PG, B).astype(np.int32)
    rng.shuffle(slen_np)
    runs = build_shared_runs(spt_np, slen_np, PG)
    assert runs['n_slots'] == n_shared, runs['n_slots']
    cap = 1 << (runs['n_slots'] - 1).bit_length()
    pages, smask, tail_pt, start, slen = (torch.tensor(a, device=DEV) for a in (
        runs['pages'][:cap], runs['mask'][:, :cap], runs['tail_pt'],
        runs['start'], slen_np))
    state = pa.shared_run(q, pool_k, pool_v, pages, smask)
    sps = pa.plan_shared_splits(HKV, cap, PG, sms())[0]
    rels = [state_rel(state, want) for want in (
        shared_run_ref(q, pool_k, pool_v, pages, smask),
        shared_run_split_ref(q, pool_k, pool_v, pages, smask,
                             slots_per_split=sps))]
    assert max(rels) <= STATE_RTOL, f'K2 at G={g}: state rel err {rels}'
    assert all(torch.equal(a, b) for a, b in zip(
        state, pa.shared_run(q, pool_k, pool_v, pages, smask))), \
        f'K2 at G={g}: two calls differ'
    reject_state_mutant(f'K2 at G={g}', state, q, pool_k, pool_v, pages,
                        smask)
    out = pa.shared_tail(q, pool_k, pool_v, tail_pt, start, slen, state)
    ref = paged_decode_ref(q, pool_k, pool_v, tail_pt, slen, start=start,
                           state=state)
    assert attn_close(out, ref), f'K3 at G={g}: {max_err(out, ref)}'
    assert torch.equal(out, pa.shared_tail(q, pool_k, pool_v, tail_pt, start,
                                           slen, state)), \
        f'K3 at G={g}: two calls differ'
    stock = paged_decode_ref(q, pool_k, pool_v,
                             torch.tensor(spt_np, device=DEV), slen)
    assert attn_close(out, stock), f'K2 + K3 at G={g} vs the stock walk: ' \
        f'{max_err(out, stock)}'
    shifted = start.clone()
    shifted[int(slen_np.argmax())] += 1
    mutants[f'K3 at G={g}, shifted start'] = (out, paged_decode_ref(
        q, pool_k, pool_v, tail_pt, slen, start=shifted, state=state))
    reject(mutants, attn_close)
    run_ms = timer(lambda: pa.shared_run(q, pool_k, pool_v, pages, smask))
    run_plain = timer(lambda: shared_run_ref(q, pool_k, pool_v, pages, smask))
    tail_ms = timer(lambda: pa.shared_tail(q, pool_k, pool_v, tail_pt, start,
                                           slen, state))
    tail_plain = timer(lambda: paged_decode_ref(
        q, pool_k, pool_v, tail_pt, slen, start=start, state=state))
    run_bound = bound(
        n_shared * PG * HKV * D * 2 * 2 + q.numel() * 2 + smask.numel() * 4
        + cap * 4 + B * hq * 4 * (2 + D),
        4 * g * D * PG * HKV * int(runs['mask'].sum()))
    tail_live = np.ceil(slen_np / PG).astype(np.int64) - runs['start']
    tail_bound = bound(
        int(tail_live.sum()) * PG * HKV * D * 2 * 2 + 2 * q.numel() * 2
        + B * hq * 4 * (2 + D) + int(tail_live.sum()) * 4 + B * 8,
        4 * hq * D * (int(slen_np.sum()) - int(runs['start'].sum()) * PG))
    print(f'  shared_run / shared_tail at G={g} over a shared {n_shared}-page '
          f'prefix: state rel err {max(rels):.3e}, tail err '
          f'{max_err(out, ref):.3e}; two calls bit-equal; kernel_ms '
          f'{run_ms:.4f} / {tail_ms:.4f}  plain_ms {run_plain:.4f} / '
          f'{tail_plain:.4f}  library_ms (the pair, SDPA) '
          f'{sdpa(torch.tensor(spt_np, device=DEV), slen):.4f}  bound_ms '
          f'{run_bound[0]:.4f} ({run_bound[1]}) / {tail_bound[0]:.4f} '
          f'({tail_bound[1]})  [{card}]')


def profiled(fn):
    """``fn()`` under ``torch.profiler``, after the device is idle, with
    PROFILE_MARGIN_S of host sleep inside the window before ``fn`` and
    after its sync, host activity traced too.  Without them the profiler
    drops the first kernels of a window now and then, at times a layer's
    attention kernel among them, which an exact launch count then misses
    (``scripts/profiler_probe.py`` counts each setting)."""
    return [e for e in profile_run(fn).key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def profile_run(fn):
    """The profiler of :func:`profiled`'s window, after it closed."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
    return prof


def launched(fn) -> dict:
    """The device kernels one call of ``fn`` launches: name -> count."""
    return {e.key: e.count for e in profiled(fn)}


# the mutants built from copies of the kernels' sources (nvcc in the
# background, started beside the library's build: start_mutant_builds),
# and the libraries of the builds that have finished
MUTANT_BUILDS: dict = {}
MUTANT_LIBS: dict = {}


def p_once_source() -> str:
    """``flash_attention_sm90.cu`` without the second P.V product (P's
    bf16 residual)."""
    text = (ROOT / SOURCES['flash_attention'][0]).read_text()
    residual = re.compile(
        r'#pragma unroll\n[^\n]*\n[^\n]*wgmma_pv<D>\(o, p_lo[^\n]*\n')
    assert len(residual.findall(text)) == 1, 'no residual product to remove'
    return residual.sub('', text)


def local_noise_source() -> str:
    """``sampling.cu`` drawing each block's noise at its local columns."""
    text = (ROOT / SOURCES['unembed_sample'][0]).read_text()
    drawn = 'gumbel(seed, row0 + col, col0 + row)'
    assert text.count(drawn) == 1, 'no global-column draw to mutate'
    return text.replace(drawn, 'gumbel(seed, row0 + col, row)')


MUTANTS = {'p_once': ('flash_attention', p_once_source),
           'k4_local': ('unembed_sample', local_noise_source)}


def start_build(name: str):
    """nvcc of mutant ``name`` (``MUTANTS``: the kernel whose source it
    copies, the copy's text) into a directory beside the library, in the
    background.  -> (the process, the library it writes)."""
    from repro_torch.kernels import common as kc

    key, source = MUTANTS[name]
    out_dir = kc.library_path().parent / name
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / f'{name}.cu', out_dir / f'lib{name}.so'
    src.write_text(source())
    proc = subprocess.Popen(
        [kc._nvcc(), *kc.NVCC_FLAGS, '-I',          # its relative include
         str((ROOT / SOURCES[key][0]).parent), '-shared', '-o', str(lib),
         str(src)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    return proc, lib


def start_mutant_builds() -> None:
    """Start every mutant's nvcc at once (their libraries are loaded by
    :func:`p_once_kernel` and :func:`local_noise_kernel`)."""
    for name in MUTANTS:
        MUTANT_BUILDS[name] = start_build(name)


def mutant_library(name: str) -> Path:
    """Mutant ``name``'s library, once its nvcc (started here if it was
    not) has finished."""
    if name not in MUTANT_LIBS:
        proc, lib = MUTANT_BUILDS.pop(name, None) or start_build(name)
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f'nvcc of mutant {name}: exit '
                               f'{proc.returncode}: {err[-2000:]}')
        MUTANT_LIBS[name] = lib
    return MUTANT_LIBS[name]


def p_once_kernel():
    """K5's bf16 kernel with P rounded to bf16 once, as the JAX package's
    plain attention rounds it: a copy of ``flash_attention_sm90.cu``
    without the second P.V product (P's bf16 residual), built beside the
    library.  Returns ``fn(q, k, v)`` (causal), whose error and time stand
    beside the shipped kernel's; the bf16 check must reject it."""
    import ctypes

    from repro_torch.kernels import common as kc
    from repro_torch.kernels.flash_attention import ops as fa

    fn = ctypes.CDLL(str(mutant_library('p_once'))).valve_flash_attention_sm90
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

    gated = "the kernels' plans"          # what the gated null is

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
        self.n_nulls = len(nulls)
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
              f'{n_max:.3e} ({self.gated}); tokens off the plain '
              f'argmax within the nulls\' reach: {len(self.flips)} '
              f'(plain-score gap in reach: {flips}, of |max|); rows equal to '
              f'the plain path bit for bit: kernel path {self.k_same}, null under the '
              f'plans {self.n_same}, all {self.n_nulls} nulls '
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


def drain_trace(model, params, kernels: bool, n_prompt_pages: int,
                max_seq: int, witness_cls, new_tokens: int = 16):
    """One engine drain of the prefix-sharing trace: a prompt of
    ``n_prompt_pages`` pages decodes alone until its prefix is published,
    then two more requests with the same prompt join it; ``new_tokens``
    new tokens each.  The kernel path (``kernels``) runs the decode kernels, prefix
    sharing and the fused head where the model has one, under a
    ``witness_cls`` witness; the plain path none of them.  Returns (tokens,
    stats, witness)."""
    witness = witness_cls(model) if kernels else None
    fused = kernels and model.cfg.family != 'moe'
    eng = trace_engine(witness or model, params, max_seq,
                       decode_kernel=None if kernels else False,
                       fused_sampling=fused, prefix_shared_attention=kernels)
    return run_trace(eng, n_prompt_pages, new_tokens), eng.stats, witness


def trace_engine(model, params, max_seq: int, *, device=None, **ecfg):
    """An engine for :func:`run_trace`: a 16-handle pool whose memory plane
    shares published prefixes, 4 rows, 32-token chunks."""
    from repro_torch.core.memory import MemoryPlane
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.serving.kvpool import KVPool

    pg = model.cfg.page_size
    pool = KVPool(16, max(4, max_seq // pg // 2), page_size=pg,
                  reserved_handles=1)
    MemoryPlane(pool, sharing=True)
    return Engine(model, params, pool, EngineConfig(
        max_batch=4, max_seq=max_seq, prefill_chunk=32, **ecfg),
        device=device or DEV)


def run_trace(eng, n_prompt_pages: int, new_tokens: int = 16) -> list:
    """The prefix-sharing trace: a prompt of ``n_prompt_pages`` pages
    decodes alone until its prefix is published, then two more requests
    with the same prompt join it; ``new_tokens`` new tokens each."""
    cfg = eng.mcfg
    prompt = np.random.default_rng(7).integers(
        1, cfg.vocab_size, n_prompt_pages * cfg.page_size).tolist()
    rids = [eng.submit(prompt, max_new_tokens=new_tokens)]
    for _ in range(20):         # publish r0's prefix; decode it alone
        eng.step()
        if len(eng.requests[rids[0]].generated) >= 3:
            break
    rids += [eng.submit(prompt, max_new_tokens=new_tokens)
             for _ in range(2)]
    eng.run_to_completion()
    torch.cuda.synchronize()
    return [eng.output_tokens(r) for r in rids]


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
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.models.api import build_model

    model = build_model(get_config('qwen3-0.6b'))
    params = model.init_params(0, device=DEV)

    def drain(kernels: bool, n_prompt_pages: int, max_seq: int):
        return drain_trace(model, params, kernels, n_prompt_pages, max_seq,
                           Witness, DRAIN_NEW_TOKENS)

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
    kernels), and the idle gaps between its device activities
    (:func:`idle_gaps`).  Without ``wall``, an untraced run first gives
    it."""
    if wall is None:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof = profile_run(run)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
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
    idle_gaps(prof, card)


def idle_gaps(prof, card: str) -> None:
    """The idle gaps of a traced window: the device's activities merged
    into busy spans, and the gaps between the first and the last of them,
    by size, with the activity that ends each of the five largest."""
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    gaps, end, last = [], spans[0][1], spans[0][2]
    for lo, hi, name in spans[1:]:
        if lo > end:
            gaps.append((lo - end, last))
        if hi > end:
            end, last = hi, name
    total = spans[-1][1] - spans[0][0]
    gaps.sort(reverse=True)
    size = sum(g for g, _ in gaps)
    print(f'  idle gaps: {len(gaps)} over {total / 1e3:.3f} ms from the first '
          f'device activity to the last, {size / 1e3:.3f} ms idle '
          f'({size / total:.3%}); {sum(g > 100 for g, _ in gaps)} gaps over '
          f'0.1 ms holding {sum(g for g, _ in gaps if g > 100) / 1e3:.3f} '
          f'ms  [{card}]')
    for g, name in gaps[:5]:
        print(f'  {g / 1e3:10.3f} ms idle after {name[:80]}')


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


# ---------------------------------------------------------------------------
# Phase 13: MoE serving (phi3.5-moe at its published widths, depth cut)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def routing_log(log: list):
    """Every MoE layer's routing while inside, appended to ``log``: (the
    (N, k) expert ids, the assignments past capacity)."""
    from repro_torch.models import moe

    routed = moe.route

    def logged(*args, **kw):
        out = routed(*args, **kw)
        log.append((out[1], int((out[3] >= out[4]).sum())))
        return out
    moe.route = logged
    try:
        yield log
    finally:
        moe.route = routed


class MoEWitness(Witness):
    """The :class:`Witness` for an engine without fused sampling (MoE):
    each kernel-path ``decode_fn`` step is held to the plain path and the
    nulls the same way, the engine's greedy pick being the argmax of the
    scores it returns.  Each step's routing is recorded too: the live
    token-layers whose top-k expert set differs between the plain path and
    the kernel path, and the assignments each path dropped."""

    def __init__(self, model):
        super().__init__(model)
        self.route_diff = self.route_total = 0
        self.dropped = {'plain': 0, 'kernel': 0}

    def decode_fn(self, params, cache, batch, *, use_kernel):
        from repro_torch.kernels.common import LAUNCHES
        assert use_kernel

        def scores(b, kernel, log):
            c = {k: v.clone() for k, v in cache.items()}
            with routing_log(log):
                return self.model.decode_fn(params, c, b,
                                            use_kernel=kernel)[1]

        counts = dict(LAUNCHES)
        logs = {'plain': [], 'kernel': []}
        plain = scores({k: v for k, v in batch.items() if k != 'shared'},
                       False, logs['plain'])
        kern = scores(batch, True, logs['kernel'])
        nulls = []
        for order in NULL_ORDERS:
            with plain_kernels(order):
                nulls.append(scores(batch, True, []))
        LAUNCHES.update(counts)
        cache, out = self.model.decode_fn(params, cache, batch,
                                          use_kernel=True)
        live = (batch['page_table'][:, 0] != 0).nonzero()[:, 0]
        self._check(out[live].argmax(-1), plain[live], kern[live],
                    torch.stack(nulls)[:, live])
        self._routing(logs, live)
        return cache, out

    def _routing(self, logs, live) -> None:
        """Count the live token-layers whose top-k expert set differs
        between the plain and the kernel path, and each path's drops."""
        for (p_ids, p_drop), (k_ids, k_drop) in zip(logs['plain'],
                                                    logs['kernel']):
            same = (p_ids.sort(-1).values == k_ids.sort(-1).values).all(-1)
            self.route_diff += int((~same[live]).sum())
            self.route_total += len(live)
            self.dropped['plain'] += p_drop
            self.dropped['kernel'] += k_drop


class LaunchTap:
    """Stands in for one engine's model and counts the kernel launches its
    calls make (the node's other engines launch too)."""

    def __init__(self, model):
        from repro_torch.kernels.common import LAUNCHES
        self.model, self.launches = model, dict.fromkeys(LAUNCHES, 0)

    def __getattr__(self, name):
        from repro_torch.kernels.common import LAUNCHES
        attr = getattr(self.model, name)
        if not name.endswith('_fn'):
            return attr

        def tapped(*args, **kw):
            before = dict(LAUNCHES)
            try:
                return attr(*args, **kw)
            finally:
                for k, n in LAUNCHES.items():
                    self.launches[k] += n - before[k]
        return tapped


def moe_step_time(card: str, model, params, trace: bool = False) -> None:
    """One kernel-path and one plain-path MoE decode step at the node's
    engine shape (B=8, 96-token tables, contexts 24..95): the median wall
    of 10 synchronized steps on the host clock (the eager step's host work
    can outlast its device work, so CUDA events alone would not show what
    a step takes), beside the least time to read the weights the step
    reads: every layer's (the dense-capacity formulation runs all experts)
    and the head.  ``trace``: the kernel-path step's device time by kernel
    and busy share too."""
    b, maxp = 8, 96 // PG
    n_pages = 1 + b * maxp
    cache = model.init_cache(engine_pages=n_pages, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(5)
    for pool in cache.values():
        pool.normal_(generator=gen)
    rng = np.random.default_rng(5)
    batch = {
        'tokens': torch.tensor(rng.integers(1, model.cfg.vocab_size, b),
                               device=DEV),
        'positions': torch.tensor(np.linspace(24, 95, b).astype(np.int32),
                                  device=DEV),
        'page_table': torch.tensor((rng.permutation(n_pages - 1) + 1)
                                   .reshape(b, maxp).astype(np.int32),
                                   device=DEV)}

    def step_ms(kernel: bool) -> float:
        times = []
        for i in range(13):                 # 3 warm-up steps, then 10
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.decode_fn(params, cache, batch, use_kernel=kernel)
            torch.cuda.synchronize()
            if i >= 3:
                times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    ms = [step_ms(k) for k in (True, False, True, False)]
    layers = sum(w.numel() * w.element_size()
                 for w in params['layers'].values())
    experts = sum(params['layers'][k].numel() * 2
                  for k in ('we_gate', 'we_up', 'we_down'))
    head = params['embed' if model.cfg.tie_embeddings else 'unembed']
    n_bytes = layers + head.numel() * head.element_size()
    t_all, t_experts = (n / HBM_BYTES_PER_S * 1e3 for n in (n_bytes, experts))
    print(f'  MoE decode step (B={b}, {model.cfg.n_layers} layers), median '
          f'wall of 10 (host clock, synchronized), in turns: kernel path '
          f'{ms[0]:.4f} / {ms[2]:.4f} ms, plain path {ms[1]:.4f} / '
          f'{ms[3]:.4f} ms; bound {t_all:.4f} ms (bytes: {n_bytes:.4e} of '
          f'weights read, {experts:.4e} of them experts, {t_experts:.4f} '
          f'ms)  [{card}]')
    if trace:
        device_profile('MoE decode step, kernel path', lambda: model.decode_fn(
            params, cache, batch, use_kernel=True), card)


def moe_check(card: str, trace: bool = False):
    """Phase 13.  (a) An engine drain of phi3.5-moe (16 of 32 layers) over
    the prefix-sharing trace, plain path and kernel path, every kernel-path
    decode step held by a :class:`MoEWitness` (gated as phase 4; K1, K2
    and K3 launched); one decode step timed against its bound.  (b)
    ``serve_demo(steps=400)`` on ``build_node``'s geometry at page 16:
    online qwen3-0.6b with fused sampling, offline phi3.5-moe without (the
    reference has no fused MoE head): invariants, <= 1 preemption per
    request, every offline request finished, K1 launched by the MoE
    engine.  Returns (the MoE engines' launches, what the witness
    failed)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.clock import RealClock
    from repro_torch.core.runtime import RuntimeConfig, ValveRuntime
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.launch.node import NodeOrchestrator
    from repro_torch.launch.serve import serve_demo
    from repro_torch.models.api import build_model
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.kvpool import KVPool

    # earlier phases' engines sit in reference cycles (sessions call back
    # into them) until a collection; the expert stacks need the room
    held = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    print(f'  device memory allocated before the phase: {held / 1e9:.2f} GB, '
          f'{torch.cuda.memory_allocated() / 1e9:.2f} GB after a collection')
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    model = build_model(cfg)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = model.init_params(0, device=DEV)
    torch.cuda.synchronize()
    n_params = sum(w.numel() for w in params.parameters())
    print(f'  {MOE_ARCH}: depth cut to {cfg.n_layers} of 32 layers (bf16 '
          f'weights of all 32 would leave under 2 GB of the card for the '
          f'rest); d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} '
          f'heads, {cfg.n_experts} experts of d_ff {cfg.d_ff}, top-'
          f'{cfg.moe_top_k}, vocab {cfg.vocab_size}; {n_params:.4e} '
          f'parameters drawn in {time.perf_counter() - t0:.1f} s, peak '
          f'{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated')

    plain, _, _ = drain_trace(model, params, False, 3, 96, MoEWitness)
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    fast, stats, witness = drain_trace(model, params, True, 3, 96,
                                       MoEWitness)
    drained = dict(LAUNCHES)
    first = [next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
             for a, b in zip(fast, plain)]
    print(f'  MoE engine drain: {sum(map(len, fast))} tokens, kernel drain vs '
          f'plain drain first differing token per request {first}, '
          f'shared_page_reads_saved {stats.shared_page_reads_saved}, '
          f'launches {drained}  [{card}]')
    print(f'  MoE routing over the witnessed steps: {witness.route_diff} of '
          f'{witness.route_total} live token-layers choose another top-'
          f'{cfg.moe_top_k} expert set on the kernel path than on the plain '
          f'path; assignments dropped past capacity: plain path '
          f'{witness.dropped["plain"]}, kernel path '
          f'{witness.dropped["kernel"]}')
    failed = witness.verdict('MoE engine drain, every decode step', card)
    assert stats.shared_page_reads_saved > 0, 'no shared page reads saved'
    assert all(drained[k] > 0 for k in DECODE_KERNELS[:3]), drained
    moe_step_time(card, model, params, trace)

    pool = KVPool(n_handles=24, pages_per_handle=8, page_size=PG,
                  reserved_handles=2)
    node = NodeOrchestrator(ValveRuntime(
        pool, RuntimeConfig(n_devices=1, t_cool_init=0.002),
        clock=RealClock()), idle_advance=1e-3)
    ecfg = dict(max_batch=8, max_seq=96, prefill_chunk=16)
    node.add_engine(get_config('qwen3-0.6b'), EngineConfig(
        **ecfg, klass='online', fused_sampling=True), seed=0,
        name='online:qwen3-0.6b', device=DEV)
    eng = node.add_engine(cfg, EngineConfig(**ecfg, klass='offline'),
                          params=params, name=f'offline0:{MOE_ARCH}',
                          device=DEV)
    tap = eng.model = LaunchTap(eng.model)
    t0 = time.perf_counter()
    m = serve_demo(node=node, steps=400, quiet=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    em = m['engines'][f'offline0:{MOE_ARCH}']
    print(f'  MoE node: online_finished {m["online_finished"]}, '
          f'offline_finished {m["offline_finished"]}, online_ttft_p50 '
          f'{m["online_ttft_p50"]} s, online_tpot_p50 {m["online_tpot_p50"]} '
          f's, offline {m["offline_tokens"] / wall:.2f} tokens/s '
          f'({m["offline_tokens"]} in {wall:.2f} s; MoE dispatches '
          f'{em["dispatches"]}, mixed {em["mixed_dispatches"]}), preemptions '
          f'{m["compute_preemptions"]}, max a request '
          f'{m["max_preemptions_per_request"]}, reclamations '
          f'{m["reclamations"]}, MoE engine launches {tap.launches}  [{card}]')
    assert m['max_preemptions_per_request'] <= 1, m
    assert m['offline_finished'] == 6, m['offline_finished']
    assert tap.launches['paged_decode'] > 0, tap.launches
    return {k: drained[k] + tap.launches[k] for k in drained}, failed


# ---------------------------------------------------------------------------
# Phase 14: training
# ---------------------------------------------------------------------------

def f32_params(params, device):
    """An f32 copy of ``params`` (an ``nn.ParameterDict`` or a nested dict)
    on ``device`` whose leaves require grad."""
    from torch import nn
    if isinstance(params, (dict, nn.ParameterDict)):
        return nn.ParameterDict({k: f32_params(v, device)
                                 for k, v in params.items()})
    return nn.Parameter(params.detach().to(device=device,
                                           dtype=torch.float32, copy=True))


def grads_close(got, want, tol: float) -> float:
    """The largest of every leaf's max |got - want| over its max |want|;
    fails past ``tol``."""
    from repro_torch.training import tree as tr
    worst = 0.0
    for (key, a), (_, b) in zip(tr.leaves_with_paths(got),
                                tr.leaves_with_paths(want)):
        err = float((a.cpu() - b.cpu()).abs().max() / b.abs().max())
        assert err <= tol, (key, err, tol)
        worst = max(worst, err)
    return worst


def train_parity(card: str) -> None:
    """(b): full-width qwen3-0.6b cut to PARITY_LAYERS layers, f32 weights
    drawn on the CPU and copied to the card, one batch_at batch (B=1,
    S=PARITY_S): loss and every gradient leaf on the card against the CPU;
    then 2 microbatches against 1 on the card (B=2)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.training.data import DataConfig, batch_at
    from repro_torch.training.train_step import loss_and_grads

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=PARITY_LAYERS)
    model = build_model(cfg)
    drawn = model.init_params(0, device='cpu')
    cpu, dev = f32_params(drawn, 'cpu'), f32_params(drawn, DEV)

    def batch(b: int, device):
        data = batch_at(DataConfig(seq_len=PARITY_S, global_batch=b,
                                   vocab_size=cfg.vocab_size), 0)
        return {k: torch.from_numpy(v).to(device) for k, v in data.items()}
    t0 = time.perf_counter()
    want_l, want_g = loss_and_grads(model, cpu, batch(1, 'cpu'))
    cpu_s = time.perf_counter() - t0
    got_l, got_g = loss_and_grads(model, dev, batch(1, DEV))
    rel = abs(float(got_l) - float(want_l)) / abs(float(want_l))
    worst = grads_close(got_g, want_g, TRAIN_GRAD_TOL)
    print(f'  f32 parity, {TRAIN_ARCH} cut to {PARITY_LAYERS} of '
          f'{get_config(TRAIN_ARCH).n_layers} layers, B=1, S={PARITY_S}: '
          f'loss card {float(got_l):.7f} CPU {float(want_l):.7f} (rel '
          f'{rel:.3e}, gate {TRAIN_LOSS_RTOL:g}); gradients: worst leaf '
          f'{worst:.3e} of its max |g| (gate {TRAIN_GRAD_TOL:g}); the CPU '
          f'took {cpu_s:.1f} s  [{card}]')
    assert rel <= TRAIN_LOSS_RTOL, (float(got_l), float(want_l))

    one_l, one_g = loss_and_grads(model, dev, batch(2, DEV), 1)
    two_l, two_g = loss_and_grads(model, dev, batch(2, DEV), 2)
    rel = abs(float(two_l) - float(one_l)) / abs(float(one_l))
    worst = grads_close(two_g, one_g, MICRO_TOL)
    print(f'  2 microbatches vs 1 on the card (B=2, f32): loss rel {rel:.3e}, '
          f'gradients worst leaf {worst:.3e} of its max |g| (gate '
          f'{MICRO_TOL:g})  [{card}]')
    assert rel <= MICRO_TOL, (float(two_l), float(one_l))


@contextlib.contextmanager
def train_cli(card: str, scratch: Path):
    """(c): ``python -m repro_torch.launch.train`` at full width as a child
    process on the card, run while the body of the ``with`` runs: exit 0, a
    done line with finite losses, step_4 committed and no .tmp left."""
    import math
    import os

    ckpt_dir = scratch / 'cli'
    env = dict(os.environ, PYTHONPATH=str(ROOT / 'src'))
    cmd = [sys.executable, '-m', 'repro_torch.launch.train', '--arch',
           TRAIN_ARCH, *CLI_TRAIN, '--ckpt-dir', str(ckpt_dir)]
    t0 = time.perf_counter()
    with open(scratch / 'cli.out', 'w+') as out, \
            open(scratch / 'cli.err', 'w+') as err:
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=out,
                                stderr=err, text=True)
        try:
            yield
            rc = proc.wait(timeout=SERVE_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        out.seek(0)
        err.seek(0)
        stdout, stderr = out.read(), err.read()
    done = re.search(r'\[train\] done; loss (\S+) → (\S+)', stdout)
    left = sorted(os.listdir(ckpt_dir)) if ckpt_dir.is_dir() else []
    print(f'  {" ".join(cmd[2:])}: exit {rc} after '
          f'{time.perf_counter() - t0:.1f} s, "{stdout.strip()[-60:]}", '
          f'checkpoints {left}  [{card}]')
    assert rc == 0, stderr[-3000:]
    assert done and all(math.isfinite(float(x)) for x in done.groups()), \
        stdout
    assert 'step_4' in left and not any(d.endswith('.tmp') for d in left), left


def train_check(card: str, trace: bool = False) -> dict:
    """Phase 14.  (a) ``launch.train.train`` at full width (bf16 weights,
    f32 moments), TRAIN_B x TRAIN_S, TRAIN_STEPS steps, a checkpoint at
    step TRAIN_CKPT: every loss and gradient norm finite, the mean of the
    last 4 losses below that of the first 4; then ``restore=True``, whose
    steps retrace the first run's within RESTART_TOL.  (b)
    :func:`train_parity`.  (c) :func:`train_cli`.  (d) the step's time,
    tokens/s, model FLOPs and their share of the bf16 peak, peak memory.
    No hand-written kernel launches in the phase (the reference trains
    through none; the CLI's child process counts its own, and runs none
    either: its path is (a)'s).  ``trace``: one full-width step profiled,
    with its idle gaps.  Returns the phase's launches."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.launch.train import train
    from repro_torch.models.api import build_model
    from repro_torch.training.data import DataConfig, batch_at
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import make_train_step

    gc.collect()
    torch.cuda.empty_cache()
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    cfg = get_config(TRAIN_ARCH)
    ocfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP)
    (ROOT / 'build').mkdir(exist_ok=True)
    scratch = Path(tempfile.mkdtemp(prefix='train_', dir=ROOT / 'build'))
    try:
        kw = dict(batch=TRAIN_B, seq=TRAIN_S, use_reduced=False,
                  ckpt_dir=str(scratch / 'run'), opt_cfg=ocfg, device=DEV)
        torch.cuda.reset_peak_memory_stats()
        hist = []
        t0 = time.perf_counter()
        params, opt_state, losses = train(
            TRAIN_ARCH, steps=TRAIN_STEPS, ckpt_every=TRAIN_CKPT,
            log_every=1, history=hist, **kw)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        norms = [h['grad_norm'] for h in hist]
        print(f'  losses {[round(x, 4) for x in losses]}; grad norms '
              f'{[round(x, 3) for x in norms]}; {wall:.1f} s with the '
              f'checkpoint  [{card}]')
        assert all(np.isfinite(losses)) and all(np.isfinite(norms))
        first, last = np.mean(losses[:4]), np.mean(losses[-4:])
        print(f'  mean loss of the first 4 steps {first:.4f}, of the last 4 '
              f'{last:.4f} (lr {TRAIN_LR:g}, warmup {TRAIN_WARMUP})')
        assert last < first, (first, last)

        times = sorted(h['seconds'] for h in hist[2:])
        step_s = statistics.median(times)
        n_params = sum(p.numel() for p in params.parameters())
        tokens = TRAIN_B * TRAIN_S
        attn = 12 * cfg.n_layers * cfg.n_heads * cfg.hd * TRAIN_S * tokens
        flops = 6 * n_params * tokens + attn
        print(f'  step {step_s * 1e3:.1f} ms (host clock, synchronized, '
              f'median of steps 2-{TRAIN_STEPS - 1}; range '
              f'{times[0] * 1e3:.1f}-{times[-1] * 1e3:.1f}), '
              f'{tokens / step_s:.0f} tokens/s; model FLOPs a step '
              f'{flops:.4e} (6 N T, N = {n_params:.4e} parameters, T = '
              f'{tokens} tokens, + attention {attn:.4e}), '
              f'{flops / step_s / BF16_FLOPS_PER_S:.2%} of the bf16 peak; '
              f'peak {peak / 1e9:.2f} GB allocated  [{card}]')

        if trace:
            model = build_model(cfg)
            step = make_train_step(model, opt_cfg=ocfg)
            data = batch_at(DataConfig(seq_len=TRAIN_S, global_batch=TRAIN_B,
                                       vocab_size=cfg.vocab_size), 0)
            batch = {k: torch.from_numpy(v).to(DEV) for k, v in data.items()}
            device_profile('training step', lambda: step(
                params, opt_state, batch), card, step_s)
        del params, opt_state
        gc.collect()
        torch.cuda.empty_cache()

        # the CLI's child process runs beside the restart and (b): its
        # start and its checkpoints are host work
        with train_cli(card, scratch):
            t0 = time.perf_counter()
            _, _, again = train(TRAIN_ARCH, steps=TRAIN_STEPS, restore=True,
                                log_every=TRAIN_STEPS, **kw)
            diff = np.abs(np.subtract(again, losses[TRAIN_CKPT:]))
            print(f'  restart from step {TRAIN_CKPT}: losses '
                  f'{[round(x, 4) for x in again]}, largest difference from '
                  f'the first run {diff.max():.3e} (gate {RESTART_TOL:g} + '
                  f'{RESTART_TOL:g} |loss|); {time.perf_counter() - t0:.1f} '
                  f's with the restore  [{card}]')
            assert len(again) == TRAIN_STEPS - TRAIN_CKPT
            np.testing.assert_allclose(again, losses[TRAIN_CKPT:],
                                       rtol=RESTART_TOL, atol=RESTART_TOL)
            train_parity(card)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    launches = dict(LAUNCHES)
    print(f'  hand-written kernel launches in the phase: {launches}')
    assert not any(launches.values()), launches
    return launches



# ---------------------------------------------------------------------------
# Phase 15: the hybrid (zamba2) and encoder-decoder (seamless) families
# ---------------------------------------------------------------------------

def cache_rel(got, want) -> float:
    """The largest max|got - want| / max|want| over the leaves of two
    cache trees (nested dicts of tensors, on any devices)."""
    if isinstance(want, dict):
        return max(cache_rel(got[k], want[k]) for k in want)
    return max_rel(got.cpu().float(), want.cpu().float())


def random_pages(rng, b: int, maxp: int, device):
    """A page table of ``maxp`` pages a row, each row its own, shuffled
    over a pool of 1 + b * maxp pages (page 0 the quarantine page)."""
    ids = rng.permutation(b * maxp) + 1
    return torch.tensor(ids.reshape(b, maxp).astype(np.int32), device=device)


def hybrid_identity(card: str) -> None:
    """(a) full-width zamba2-2.7b, all 54 layers, f32: prefill of ID_T
    tokens into a global pool at page 16, then one decode step, against
    a prefill of ID_T + 1 tokens (the SSD crosses chunks, the last one
    padded; each of the 9 shared pools is read through the page table);
    then the long-context step over those pools gathered into contiguous
    rows against the paged step."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model

    model = build_model(get_config(HYBRID_ARCH))
    cfg = model.cfg
    params = model.init_params(0, device=DEV).to(torch.float32)
    pg = cfg.page_size
    maxp = -(-(ID_T + 1) // pg)
    n_pages = 1 + ID_B * maxp
    rng = np.random.default_rng(21)
    tokens = torch.tensor(rng.integers(0, cfg.vocab_size, (ID_B, ID_T + 1)),
                          device=DEV)
    pt = random_pages(rng, ID_B, maxp, DEV)

    def empty():
        return model.init_cache(engine_pages=n_pages, batch_size=ID_B,
                                device=DEV, dtype=torch.float32)
    t0 = time.perf_counter()
    short, _ = model.prefill_fn(params, empty(), {'tokens': tokens[:, :ID_T],
                                                  'page_table': pt})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    attn = short['attn']
    n_apps = attn['k'].shape[0]
    dense = {'mamba': {k: v.clone() for k, v in short['mamba'].items()},
             'attn': {k: v[:, pt.long()].reshape(n_apps, ID_B, maxp * pg,
                                                 *v.shape[3:])
                      for k, v in attn.items()}}
    step = {'tokens': tokens[:, ID_T],
            'positions': torch.full((ID_B,), ID_T, device=DEV)}
    short, got = model.decode_fn(params, short, dict(step, page_table=pt))
    long, want = model.prefill_fn(params, empty(), {'tokens': tokens,
                                                    'page_table': pt})
    dense, dgot = model.decode_fn(params, dense, step, long_context=True)
    torch.cuda.synchronize()
    rel, states = max_rel(got, want), cache_rel(short['mamba'], long['mamba'])
    same = int((got.argmax(-1) == want.argmax(-1)).sum())
    drel = max_rel(dgot, got)
    dsame = int((dgot.argmax(-1) == got.argmax(-1)).sum())
    dstates = cache_rel(dense['mamba'], short['mamba'])
    print(f'  (a) {HYBRID_ARCH} full width ({cfg.n_layers} layers, '
          f'{n_apps} shared pools), f32, B={ID_B}: prefill T={ID_T} '
          f'({prefill_s:.2f} s) + 1 decode step vs prefill T={ID_T + 1}: '
          f'scores {rel:.3e} of |max|, argmax equal {same}/{ID_B}, conv/ssm '
          f'states {states:.3e}; long-context step vs paged step: scores '
          f'{drel:.3e}, argmax equal {dsame}/{ID_B}, states {dstates:.3e} '
          f'(gate {PREFILL_TOL:g})  [{card}]')
    assert torch.isfinite(got).all() and torch.isfinite(dgot).all()
    assert rel <= PREFILL_TOL and same == ID_B and states <= PREFILL_TOL
    assert drel <= PREFILL_TOL and dsame == ID_B and dstates <= PREFILL_TOL


def ssd_check(card: str) -> None:
    """(b) the chunked SSD against the sequential recurrence on the card at
    zamba2-2.7b's shapes, f32, from a carried state, with decays down to
    exp(-2) (where the reference's unmasked decay square overflows)."""
    from repro_torch.models.zamba2 import ssd_chunked, ssd_ref

    gen = torch.Generator(device=DEV).manual_seed(5)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEV)
    x = randn(SSD_B, SSD_T, SSD_H, SSD_P)
    b, c = randn(SSD_B, SSD_T, SSD_N), randn(SSD_B, SSD_T, SSD_N)
    a = torch.exp(-2 * torch.rand(SSD_B, SSD_T, SSD_H, generator=gen,
                                  device=DEV))
    s0 = randn(SSD_B, SSD_H, SSD_P, SSD_N) * 0.1
    out, secs = {}, {}
    for name, fn in (('chunked', ssd_chunked), ('sequential', ssd_ref)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = fn(x, b, c, a, s0)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
    (y, s), (yr, sr) = out['chunked'], out['sequential']
    print(f'  (b) SSD B={SSD_B}, T={SSD_T}, H={SSD_H}, P={SSD_P}, N={SSD_N} '
          f'f32: chunked vs sequential y max abs err {max_err(y, yr):.3e} '
          f'(|y| max {yr.abs().max().item():.2f}), state {max_err(s, sr):.3e}'
          f' (gate {SSD_TOL:g} (1 + |want|)); chunked {secs["chunked"]:.3f} '
          f's, sequential {secs["sequential"]:.3f} s (host clock, first '
          f'call)  [{card}]')
    assert wkv_close(y, yr, SSD_TOL) and wkv_close(s, sr, SSD_TOL)


def _serve_tokens(model, params, cache, batch, n_decode: int):
    """Prefill, then ``n_decode`` greedy decode steps: every call's scores
    and the tokens fed."""
    cache, scores = model.prefill_fn(params, cache, batch)
    s = batch['tokens'].shape[1]
    outs, fed = [scores], []
    for i in range(n_decode):
        nxt = scores.argmax(-1).to(torch.int32)
        fed.append(nxt)
        cache, scores = model.decode_fn(params, cache, {
            'tokens': nxt, 'positions': torch.full_like(nxt, s + i),
            'page_table': batch['page_table']})
        outs.append(scores)
    return cache, outs, fed


def cpu_parity(card: str) -> None:
    """(c) f32 on the card against the CPU, weights drawn on the card and
    copied to both: zamba2-2.7b cut to CPU_LAYERS of 54 layers (B=1,
    prefill CPU_T, CPU_DECODE greedy steps) and seamless-m4t-medium at full
    depth (B=1, ENC_S frames, ENC_DEC decoder tokens, CPU_DECODE steps):
    every call's scores and the caches after within CPU_TOL, the greedy
    tokens equal; then zamba2 cut to GRAD_LAYERS layers, ``loss_and_grads``
    at S=GRAD_S (two SSD chunks; the backward of the masked decay square):
    the loss within 1e-5 relative, every gradient leaf within 1e-4 of its
    max (phase 14's rule)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.training.data import DataConfig, batch_at
    from repro_torch.training.train_step import loss_and_grads

    rng = np.random.default_rng(22)
    for arch, layers in ((HYBRID_ARCH, CPU_LAYERS), (ENCDEC_ARCH, None)):
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        model = build_model(cfg)
        drawn = model.init_params(0, device=DEV)
        encdec = cfg.family == 'encdec'
        s = ENC_DEC if encdec else CPU_T
        maxp = -(-(s + CPU_DECODE + 1) // cfg.page_size)
        tokens = rng.integers(0, cfg.vocab_size, (1, s))
        pages = rng.permutation(maxp) + 1
        frames = rng.normal(size=(1, ENC_S, cfg.d_model)) * 0.02
        runs, secs = {}, {}
        for device in (DEV, 'cpu'):
            params = f32_params(drawn, device).requires_grad_(False)
            batch = {'tokens': torch.tensor(tokens, device=device),
                     'page_table': torch.tensor(pages[None].astype(np.int32),
                                                device=device)}
            kw = dict(enc_len=ENC_S) if encdec else {}
            if encdec:
                batch['frames'] = torch.tensor(frames, dtype=torch.float32,
                                               device=device)
            cache = model.init_cache(engine_pages=1 + maxp, batch_size=1,
                                     device=device, dtype=torch.float32, **kw)
            t0 = time.perf_counter()
            runs[device] = _serve_tokens(model, params, cache, batch,
                                         CPU_DECODE)
            secs[device] = time.perf_counter() - t0
            del params
        (gc_, gs, gt), (wc, ws, wt) = runs[DEV], runs['cpu']
        rel = max(max_rel(a.cpu(), b) for a, b in zip(gs, ws))
        states = cache_rel(gc_, wc)
        same = all(torch.equal(a.cpu(), b) for a, b in zip(gt, wt))
        cut = (f'{layers} of {get_config(arch).n_layers} layers'
               if layers else 'full depth')
        print(f'  (c) {arch} ({cut}) f32 card vs CPU, B=1, '
              f'{"frames " + str(ENC_S) + ", " if encdec else ""}prefill '
              f'{s} + {CPU_DECODE} decode steps: scores {rel:.3e} of |max|, '
              f'caches {states:.3e} (gate {CPU_TOL:g}), greedy tokens '
              f'{"equal" if same else "DIFFER"} {[int(t) for t in wt]}; '
              f'card {secs[DEV]:.2f} s, CPU {secs["cpu"]:.2f} s  [{card}]')
        assert rel <= CPU_TOL and states <= CPU_TOL and same, arch
        del drawn, runs

    cfg = dataclasses.replace(get_config(HYBRID_ARCH), n_layers=GRAD_LAYERS)
    model = build_model(cfg)
    drawn = model.init_params(0, device=DEV)
    data = batch_at(DataConfig(seq_len=GRAD_S, global_batch=1,
                               vocab_size=cfg.vocab_size), 0)
    got_l, got_g = loss_and_grads(model, f32_params(drawn, DEV), {
        k: torch.from_numpy(v).to(DEV) for k, v in data.items()})
    t0 = time.perf_counter()
    want_l, want_g = loss_and_grads(model, f32_params(drawn, 'cpu'), {
        k: torch.from_numpy(v) for k, v in data.items()})
    cpu_s = time.perf_counter() - t0
    rel = abs(float(got_l) - float(want_l)) / abs(float(want_l))
    worst = grads_close(got_g, want_g, TRAIN_GRAD_TOL)
    print(f'  (c) {HYBRID_ARCH} cut to {GRAD_LAYERS} of '
          f'{get_config(HYBRID_ARCH).n_layers} layers, loss_and_grads f32, '
          f'B=1, S={GRAD_S}: loss card {float(got_l):.7f} CPU '
          f'{float(want_l):.7f} (rel {rel:.3e}, gate {TRAIN_LOSS_RTOL:g}); '
          f'gradients: worst leaf {worst:.3e} of its max |g| (gate '
          f'{TRAIN_GRAD_TOL:g}); the CPU took {cpu_s:.1f} s  [{card}]')
    assert rel <= TRAIN_LOSS_RTOL, (float(got_l), float(want_l))


def bf16_serving(card: str, trace: bool = False) -> None:
    """(d) bf16 at full width: zamba2-2.7b, B=BF16_B, a prefill of BF16_T
    tokens, then BF16_DECODE greedy steps; seamless-m4t-medium, B=BF16_B,
    BF16_T frames (normal * 0.02 from a seeded numpy), a decoder prefix of
    BF16_T / DEC_PREFIX_FRACTION tokens, then BF16_DECODE greedy steps.
    Scores finite; the last step's argmax equal to that of a prefill over
    the prompt and the tokens fed, or a near tie.  Prefill time, decode
    time a step (host clock, synchronized), tokens/s, peak memory.
    ``trace`` profiles one zamba2 prefill and one decode step."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.models.encdec import DEC_PREFIX_FRACTION

    rng = np.random.default_rng(23)
    for arch in (HYBRID_ARCH, ENCDEC_ARCH):
        model = build_model(get_config(arch))
        cfg = model.cfg
        params = model.init_params(0, device=DEV)
        encdec = cfg.family == 'encdec'
        s = BF16_T // DEC_PREFIX_FRACTION if encdec else BF16_T
        maxp = -(-(s + BF16_DECODE + 1) // cfg.page_size)
        batch = {'tokens': torch.tensor(rng.integers(
            0, cfg.vocab_size, (BF16_B, s)), device=DEV),
            'page_table': random_pages(rng, BF16_B, maxp, DEV)}
        kw = {}
        if encdec:
            kw['enc_len'] = BF16_T
            batch['frames'] = torch.tensor(
                rng.normal(size=(BF16_B, BF16_T, cfg.d_model)) * 0.02,
                dtype=torch.float32, device=DEV)

        def empty():
            return model.init_cache(engine_pages=1 + BF16_B * maxp,
                                    batch_size=BF16_B, device=DEV, **kw)
        cache = empty()
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cache, scores = model.prefill_fn(params, cache, batch)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        outs, fed = [scores], []
        t0 = time.perf_counter()
        for i in range(BF16_DECODE):
            nxt = scores.argmax(-1).to(torch.int32)
            fed.append(nxt)
            cache, scores = model.decode_fn(params, cache, {
                'tokens': nxt, 'positions': torch.full_like(nxt, s + i),
                'page_table': batch['page_table']})
            outs.append(scores)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / BF16_DECODE
        peak = torch.cuda.max_memory_allocated()
        assert all(torch.isfinite(o).all() for o in outs), arch
        longer = dict(batch, tokens=torch.cat(
            [batch['tokens'], torch.stack(fed, 1)], dim=1))
        _, want = model.prefill_fn(params, empty(), longer)
        ties = 0
        for r, (a, b) in enumerate(zip(scores.argmax(-1).tolist(),
                                       want.argmax(-1).tolist())):
            assert a == b or near_tie(want[r], a, b), \
                f'{arch} bf16 row {r}: decode argmax {a}, longer prefill {b}'
            ties += a != b
        spread = max_rel(scores, want)
        what = (f'{BF16_T} frames, decoder prefix {s}' if encdec
                else f'prefill {s}')
        print(f'  (d) {arch} full width bf16, B={BF16_B}, {what}: prefill '
              f'{prefill_s * 1e3:.1f} ms, {BF16_DECODE} decode steps '
              f'{step_s * 1e3:.2f} ms a step, {BF16_B / step_s:.1f} tokens/s '
              f'(host clock, synchronized), peak {peak / 1e9:.2f} GB '
              f'allocated; last step vs a prefill of {s + BF16_DECODE}: '
              f'argmax equal {BF16_B - ties}/{BF16_B}, near ties {ties}, '
              f'spread {spread:.3e} of |max|  [{card}]')
        if trace and not encdec:
            step = {'tokens': fed[-1], 'positions': torch.full_like(
                fed[-1], s + BF16_DECODE), 'page_table': batch['page_table']}
            device_profile(f'{arch} prefill, bf16', lambda: model.prefill_fn(
                params, empty(), batch), card, prefill_s)
            device_profile(f'{arch} decode step, bf16', lambda: (
                model.decode_fn(params, cache, step)), card, step_s)
        del params, cache, outs, want
        gc.collect()
        torch.cuda.empty_cache()


def family_train(card: str) -> None:
    """(e) TRAIN_FAMILY_STEPS steps of each family at full width through
    ``make_train_step``: bf16 weights, f32 AdamW moments, B=1, S=FAM_S
    (seamless: FAM_S frames as well).  The loss and gradient norm finite;
    each step's time (the first includes the first call's set-up) and the
    peak memory printed."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.training import optimizer as opt
    from repro_torch.training.data import DataConfig, batch_at
    from repro_torch.training.train_step import make_train_step

    rng = np.random.default_rng(24)
    for arch in (HYBRID_ARCH, ENCDEC_ARCH):
        model = build_model(get_config(arch))
        cfg = model.cfg
        params = model.init_params(0, device=DEV, requires_grad=True)
        n_params = sum(p.numel() for p in params.parameters())
        opt_state = opt.init_opt_state(params)
        step = make_train_step(model, opt_cfg=opt.AdamWConfig(
            lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP))
        data = batch_at(DataConfig(seq_len=FAM_S, global_batch=1,
                                   vocab_size=cfg.vocab_size), 0)
        batch = {k: torch.from_numpy(v).to(DEV) for k, v in data.items()}
        if cfg.family == 'encdec':
            batch['frames'] = torch.tensor(
                rng.normal(size=(1, FAM_S, cfg.d_model)) * 0.02,
                dtype=torch.float32, device=DEV)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, norms, times = [], [], []
        for _ in range(TRAIN_FAMILY_STEPS):
            t0 = time.perf_counter()
            params, opt_state, m = step(params, opt_state, batch)
            losses.append(float(m['loss']))
            norms.append(float(m['grad_norm']))
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        print(f'  (e) {arch} full width ({n_params:.4e} parameters), bf16 '
              f'weights + f32 moments, B=1, S={FAM_S}: losses '
              f'{[round(x, 4) for x in losses]}, grad norms '
              f'{[round(x, 3) for x in norms]}; steps '
              f'{[round(t * 1e3, 1) for t in times]} ms (host clock, '
              f'synchronized by the loss), peak {peak / 1e9:.2f} GB '
              f'allocated  [{card}]')
        assert np.isfinite(losses).all() and np.isfinite(norms).all(), arch
        del params, opt_state, m
        gc.collect()
        torch.cuda.empty_cache()


def hybrid_encdec_check(card: str, trace: bool = False) -> dict:
    """Phase 15: (a)-(e) above.  No hand-written kernel launches in the
    phase: the reference runs no Pallas kernel for these families.
    Returns the phase's launches."""
    from repro_torch.kernels.common import LAUNCHES

    gc.collect()
    torch.cuda.empty_cache()
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for part in (hybrid_identity, ssd_check, cpu_parity):
        part(card)
        gc.collect()
        torch.cuda.empty_cache()
    bf16_serving(card, trace)
    family_train(card)
    launches = dict(LAUNCHES)
    print(f'  hand-written kernel launches in the phase: {launches}')
    assert not any(launches.values()), launches
    return launches

# ---------------------------------------------------------------------------
# Phase 16: tensor-parallel serving over a mesh
# ---------------------------------------------------------------------------

MESH_ARCH = 'qwen3-0.6b'
MESH_F32_LAYERS = 4                # the two-rank f32 drain's depth, of 28
MESH_BF16_LAYERS = 14              # phases 16 and 18 (a): the bf16 drains'
                                   # depth, of 28, cut for the time limit
MESH_TOL = 1e-4                    # f32 mesh vs meshless scores, of |max|
MESH_TIMEOUT_S = 300               # bounds each spawned run of the phase
MESH_PROMPT_PAGES, MESH_MAX_SEQ = 3, 96    # phase 4's trace
MESH_NEW_TOKENS = 8                # its 16 new tokens a request cut to 8
                                   # in phases 16 and 18 (the time limit)


class Recorder:
    """A model whose engine entries keep a copy of the f32 scores of their
    live rows (a padding row's table is all quarantine page), and the host
    time of every decode step (synchronized at both ends)."""

    def __init__(self, model):
        self.model, self.scores, self.decode_s = model, [], []

    def __getattr__(self, name):
        return getattr(self.model, name)

    def _keep(self, batch, scores):
        live = (batch['page_table'][:, 0] != 0).nonzero()[:, 0]
        self.scores.append(scores[live].detach().clone())

    def prefill_chunk_fn(self, params, cache, batch, **kw):
        cache, scores = self.model.prefill_chunk_fn(params, cache, batch,
                                                    **kw)
        self._keep(batch, scores)
        return cache, scores

    def decode_fn(self, params, cache, batch, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache, scores = self.model.decode_fn(params, cache, batch, **kw)
        torch.cuda.synchronize()
        self.decode_s.append(time.perf_counter() - t0)
        self._keep(batch, scores)
        return cache, scores


def host_batch(batch) -> dict:
    """A staged batch back as host arrays (``distributed.tp.stage``'s
    input)."""
    return {k: host_batch(v) if isinstance(v, dict)
            else v.cpu().numpy() if torch.is_tensor(v) else v
            for k, v in batch.items()}


class MeshOrders:
    """The single-device plain path computed in the tensor-parallel
    forward's summation orders over ``n`` ranks, independently of
    ``distributed/tp.py``: while active, every layer product of the
    weights ``params`` is split as a rank holds it -- q/k/v and gate/up by
    column blocks (whole heads, d_ff / n), the attention output and down
    projections by row blocks, each block a GEMM writing f32 and the blocks
    added in f32, rounded once -- attention runs a block of heads at a
    time, and the head scores a vocabulary block at a time.  Equal blocks:
    ``n`` must divide the heads, kv-heads, d_ff and the vocabulary.  The
    function is the model's; only the order of its sums moves, so the
    tensor-parallel plain path, run on the mesh, should land where this
    does (bit for bit where the kernels' shapes pick the same GEMMs)."""

    def __init__(self, params, cfg, n: int):
        from repro_torch.models import common as cm
        from repro_torch.models.dense import head_of

        assert all(w % n == 0 for w in (cfg.n_heads, cfg.n_kv_heads,
                                        cfg.d_ff, cfg.vocab_size))
        self.n, self.plans = n, {}

        def cut(w, dim):
            return [c.contiguous() for c in w.detach().chunk(n, dim)]

        for lp in cm.layer_views(params):
            for k in ('wq', 'wk', 'wv', 'wg', 'wu'):
                self._plan(lp[k], self._column(cut(lp[k], 1)))
            for k in ('wo', 'wd'):
                self._plan(lp[k], self._row(cut(lp[k], 0)))
        self.head = cut(head_of(cfg, params), 0)

    def _plan(self, w, fn):
        self.plans[w.data_ptr(), tuple(w.shape)] = fn

    @staticmethod
    def _column(blocks):
        return lambda x: torch.cat([x @ b for b in blocks], dim=-1)

    @staticmethod
    def _row(blocks):
        def product(x):
            parts = x.chunk(len(blocks), dim=-1)
            total = None
            for xr, b in zip(parts, blocks):
                xr = xr.contiguous().reshape(-1, xr.shape[-1])
                p = (torch.mm(xr, b, out_dtype=torch.float32)
                     if xr.is_cuda and xr.dtype != torch.float32
                     else xr.float() @ b.float())
                total = p if total is None else total + p
            return total.to(x.dtype).reshape(x.shape[:-1] + (-1,))
        return product

    @contextlib.contextmanager
    def active(self):
        from torch.overrides import TorchFunctionMode

        from repro_torch.models import common as cm
        from repro_torch.models import dense

        plans, n, head = self.plans, self.n, self.head
        scores, attend = dense.unembed_scores, cm.paged_attention_ref

        class Products(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                if getattr(func, '__name__', None) in ('matmul',
                                                       '__matmul__') and \
                        len(args) == 2 and torch.is_tensor(args[1]):
                    plan = plans.get((args[1].data_ptr(),
                                      tuple(args[1].shape)))
                    if plan is not None:
                        return plan(args[0])
                return func(*args, **(kwargs or {}))

        def by_heads(q, pool_k, pool_v, page_table, lengths, **kw):
            return torch.cat([attend(qb.contiguous(), kb.contiguous(),
                                     vb.contiguous(), page_table, lengths,
                                     **kw)
                              for qb, kb, vb in zip(q.chunk(n, 1),
                                                    pool_k.chunk(n, 2),
                                                    pool_v.chunk(n, 2))],
                             dim=1)

        dense.unembed_scores = lambda last, _: torch.cat(
            [scores(last, b) for b in head], dim=-1)
        cm.paged_attention_ref = by_heads
        try:
            with Products():
                yield
        finally:
            dense.unembed_scores, cm.paged_attention_ref = scores, attend


def live_rows(batch) -> torch.Tensor:
    """The rows of a decode batch that hold a request (a padding row's
    table is all quarantine page 0)."""
    return (batch['page_table'][:, 0] != 0).nonzero()[:, 0]


class MeshWitness(Witness):
    """The Witness of a tensor-parallel engine's (unfused) decode steps,
    two gates a step.  P is the single-device plain path with the whole
    weights over the whole pool, gathered from every rank after the step:
    the step wrote only its new tokens' slots, which P writes again before
    it reads them, so P sees the cache state the step saw.  M is the mesh's
    own plain path, run by ``shadow``, a second engine on the mesh whose
    pool takes the engine's pages on every rank before each step.  E is
    :class:`MeshOrders`: the single-device plain path in the mesh's
    summation orders, written apart from the tensor-parallel code.

    - The mesh's forward (``self.orders``): M held to P by the Witness rule
      with E as the gated null (then the four single-device split-order
      nulls of :class:`Witness` for the reach), so a fault of the
      tensor-parallel forward, in bf16 too, fails the phase.
    - The kernels on the mesh (this Witness): K, the mesh's own step -- K1,
      or K2 + K3, on every rank's kv-heads -- held to P with M as the gated
      null (it sums in the kernel path's dataflow, as phase 4's plan null
      does), the reach over M, E and the four.  With one ``model`` rank
      (a data axis alone) M is P bit for bit, no null at all, and K is
      held to the single-device kernel path on the same state (phase 4's
      K, which phase 4 holds to P): a data axis may move the kernels'
      scores only as far as the kernels themselves move them.

    Printed beside them, not gated: E's and M's spread against the
    single-device plan null's, and the live rows E reproduces M bit for
    bit.  The sampled token is K's argmax (greedy) in an unfused drain,
    K4's (each rank's vocabulary block, combined) in a fused one."""

    def __init__(self, model, params, n: int):
        super().__init__(model)
        self.full, self.engine, self.shadow, self.decode_s = \
            params, None, None, []
        self.mesh_orders = MeshOrders(params, model.cfg, n)
        self.orders = Witness(model)
        self.n = n
        if n > 1:
            self.gated, self.orders.gated = 'M', 'E'
        else:
            self.gated = 'the single-device kernel path'
        self.single, self.e_same, self.ks_same, self.rows = [], 0, 0, 0

    def decode_fn(self, params, cache, batch, *, use_kernel, tp):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache, kern = self.model.decode_fn(params, cache, batch,
                                           use_kernel=use_kernel, tp=tp)
        torch.cuda.synchronize()
        self.decode_s.append(time.perf_counter() - t0)
        self._witness(batch, kern, None)
        return cache, kern

    def decode_sample_fn(self, params, cache, batch, *, use_kernel,
                         temperature, tp):
        """The fused step (K4 on every rank's vocabulary block, combined),
        then K's scores from the shadow's kernel step on a copy of the
        engine's pages (the step rewrites the slots the fused step wrote,
        with the same bits); every token must be K's argmax up to an
        f32-order tie."""
        from repro_torch.kernels.common import LAUNCHES

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache, toks = self.model.decode_sample_fn(
            params, cache, batch, use_kernel=use_kernel,
            temperature=temperature, tp=tp)
        torch.cuda.synchronize()
        self.decode_s.append(time.perf_counter() - t0)
        counts = dict(LAUNCHES)
        shadow, pages = self.shadow, list(range(self.engine.pool.n_pages))
        shadow.copy_kv_from(self.engine, pages, pages)
        shadow._leader.announce('decode', host_batch(batch), use_kernel=True)
        kern = self.model.decode_fn(shadow.params, shadow.cache, batch,
                                    use_kernel=True, tp=shadow._tp)[1]
        LAUNCHES.update(counts)
        self._witness(batch, kern, toks)
        return cache, toks

    def _witness(self, batch, kern, toks):
        """The two gates on one step whose kernel-path scores are ``kern``
        (``toks``: the tokens it sampled; None: ``kern``'s argmax)."""
        from repro_torch.kernels.common import LAUNCHES

        counts = dict(LAUNCHES)
        unshared = {k: v for k, v in batch.items() if k != 'shared'}
        shadow, pages = self.shadow, list(range(self.engine.pool.n_pages))
        shadow.copy_kv_from(self.engine, pages, pages)
        shadow._leader.announce('decode', host_batch(unshared),
                                use_kernel=False)
        mesh_plain = self.model.decode_fn(shadow.params, shadow.cache,
                                          unshared, use_kernel=False,
                                          tp=shadow._tp)[1]
        pool = self.engine.gather_cache()

        def scores(b, kernel):
            c = {k: v.clone() for k, v in pool.items()}
            return self.model.decode_fn(self.full, c, b,
                                        use_kernel=kernel)[1]

        plain = scores(unshared, False)
        with self.mesh_orders.active():
            split = scores(unshared, False)
        singles = []
        for order in NULL_ORDERS:
            with plain_kernels(order):
                singles.append(scores(batch, True))
        if self.n == 1:
            kern_single = scores(batch, True)[live_rows(batch)]
            self.ks_same += int((kern[live_rows(batch)] == kern_single)
                                .all(-1).sum())
        LAUNCHES.update(counts)
        live = live_rows(batch)
        m, e, p = mesh_plain[live], split[live], plain[live]
        top = p.abs().amax(-1, keepdim=True)
        self.single.append(((singles[0][live] - p).abs() / top).flatten())
        self.e_same += int((e == m).all(-1).sum())
        self.rows += len(live)
        singles = torch.stack(singles)[:, live]
        # with one model rank E reorders nothing (it is P on the card);
        # M then differs from P only by the GEMMs' row counts, held to the
        # kernels' plan null as any correct reordering is
        self.orders._check(m.argmax(-1), p, m, torch.cat(
            [e[None], singles] if self.n > 1 else [singles, e[None]]))
        # the gated null: M where the model axis reorders the mesh's sums;
        # with one model rank M is P itself, and K is held to the
        # single-device kernel path (phase 4's K) on the same state
        nulls = ([m, e] + list(singles) if self.n > 1
                 else [kern_single, m, e] + list(singles))
        self._check(kern[live].argmax(-1) if toks is None else toks[live],
                    p, kern[live], torch.stack(nulls))

    def verdict(self, what: str, card: str) -> list:
        single = torch.cat(self.single)
        e, m = torch.cat(self.orders.n_diffs), torch.cat(self.orders.k_diffs)
        print(f'  {what}: the single-device plan null (not gated): median '
              f'{single.median().item():.3e}, max {single.max().item():.3e} '
              f'of |max|; the mesh\'s orders on one device (E) '
              f'{e.median().item():.3e}, {e.max().item():.3e}; the mesh\'s '
              f'plain path (M) {m.median().item():.3e}, '
              f'{m.max().item():.3e}; E reproduces M bit for bit on '
              f'{self.e_same} of {self.rows} live rows'
              + (f'; the kernel path reproduces the single-device kernel '
                 f'path bit for bit on {self.ks_same} of {self.rows}'
                 if self.n == 1 else '') + f'  [{card}]')
        return (self.orders.verdict(f'{what}, the mesh\'s plain path (M) '
                                    'against E', card)
                + super().verdict(f'{what}, the kernel path against '
                                  + ('M' if self.n > 1 else 'P'), card))


def f32_copy(params):
    """An f32 copy of ``params`` (no grad)."""
    from torch import nn
    if isinstance(params, nn.ParameterDict):
        return nn.ParameterDict({k: f32_copy(v) for k, v in params.items()})
    return nn.Parameter(params.detach().float(), requires_grad=False)


def traced(model, params, mesh, dev, **ecfg):
    """(tokens, engine) of :func:`run_trace` at phase 4's geometry over
    ``mesh`` (None: one device), unfused, the pool in the weights' dtype
    (a mesh engine's already is)."""
    eng = trace_engine(model, params, MESH_MAX_SEQ, device=dev, mesh=mesh,
                       **ecfg)
    dtype = params['embed'].dtype
    eng.cache = {k: v.to(dtype) for k, v in eng.cache.items()}
    toks = run_trace(eng, MESH_PROMPT_PAGES, MESH_NEW_TOKENS)
    eng.close()
    return toks, eng


def mesh_rank_one(rank: int, cfg, dev: str) -> dict:
    """Phase 16 (a), on a mesh of one rank over NCCL: phase 4's drain,
    unfused, through K1/K2/K3, with and without the mesh; every score and
    token must be equal bit for bit."""
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import build_model

    mesh = make_mesh((1,), ('model',), device=dev)
    model = build_model(cfg)
    params = model.init_params(0, device=dev)
    runs = {}
    for name, m in (('meshless', None), ('mesh', mesh)):
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        rec = Recorder(model)
        toks, eng = traced(rec, params, m, dev, decode_kernel=True,
                           prefix_shared_attention=True)
        runs[name] = (toks, rec, dict(LAUNCHES),
                      eng.stats.shared_page_reads_saved)
    (a_toks, a_rec, _, _), (b_toks, b_rec, launches, saved) = \
        runs['meshless'], runs['mesh']
    return {'backend': str(torch.distributed.get_backend()),
            'tokens_equal': a_toks == b_toks, 'n_tokens': sum(map(len, b_toks)),
            'scores_equal': len(a_rec.scores) == len(b_rec.scores) and all(
                torch.equal(x, y) for x, y in zip(a_rec.scores, b_rec.scores)),
            'n_scores': len(b_rec.scores), 'launches': launches,
            'saved': saved,
            'ms': {k: 1e3 * statistics.median(r.decode_s)
                   for k, (_, r, _, _) in runs.items()}}


def mesh_burst(cfg, mesh, dev: str) -> dict:
    """Phase 16 (c): online and offline engines of ``cfg``, tensor-parallel
    on ``mesh``, under a runtime on that mesh (a gate a device): offline
    work, then an online request mid-flight (the reference's
    ``tests/test_gate_fanout.py`` burst); the preemption events."""
    from repro_torch.core.clock import VirtualClock
    from repro_torch.core.events import PreemptionEvent
    from repro_torch.core.runtime import RuntimeConfig, ValveRuntime
    from repro_torch.launch.node import NodeOrchestrator
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.kvpool import KVPool

    pool = KVPool(5, 4, page_size=cfg.page_size, reserved_handles=1)
    rt = ValveRuntime(pool, RuntimeConfig(mesh=mesh, t_cool_init=0.002,
                                          gate_op_latency_s=0.0005),
                      clock=VirtualClock())
    node = NodeOrchestrator(rt, idle_advance=1e-3)
    for klass, seed in (('online', 0), ('offline', 1)):
        node.add_engine(cfg, EngineConfig(max_batch=4, max_seq=48,
                                          prefill_chunk=8, klass=klass,
                                          mesh=mesh),
                        seed=seed, name=klass, device=dev)
    rng = np.random.default_rng(7)
    off = node.offline[0]
    for _ in range(2):
        off.submit(rng.integers(1, cfg.vocab_size, 12).tolist(),
                   max_new_tokens=8)
    for _ in range(4):
        node.step()
    node.online.submit(rng.integers(1, cfg.vocab_size, 28).tolist(),
                       max_new_tokens=12)
    node.drain(max_steps=5000)
    rt.check_invariants()
    evs = rt.bus.events(PreemptionEvent)
    per = {}
    for ev in evs:
        for rid in ev.requests:
            for d in range(len(ev.device_latencies_s)):
                per[rid, d] = per.get((rid, d), 0) + 1
    for eng in node.engines:
        eng.close()
    return {'gates': len(rt.gates.gates), 'events': len(evs),
            'latencies': sorted({len(ev.device_latencies_s) for ev in evs}),
            'max_per_device': max(per.values(), default=0),
            'finished': [len(e.finished) for e in node.engines]}


def mesh_rank_two(rank: int, cfg, cut, dev: str, card: str) -> dict:
    """Phase 16 (b) and (c), two ranks sharing the card (gloo): the f32
    drain at published widths cut to ``cut``'s depth, mesh vs meshless; the
    bf16 full-depth drain through K1/K2/K3 under :class:`MeshWitness`; the
    preemption burst.  Rank 1 serves."""
    from repro_torch.distributed.tp import serve_rank, stop_ranks
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import build_model

    mesh = make_mesh((2,), ('model',), device=dev)
    if rank != 0:
        return serve_rank(mesh)
    try:
        out = {'backend': str(torch.distributed.get_backend())}
        model = build_model(cut)
        params = f32_copy(model.init_params(0, device=dev))
        runs = {}
        for name, m in (('mesh', mesh), ('meshless', None)):
            rec = Recorder(model)
            # f32: the plain path (the decode kernels take bf16)
            runs[name] = (traced(rec, params, m, dev,
                                 decode_kernel=False)[0], rec)
        (m_toks, m_rec), (s_toks, s_rec) = runs['mesh'], runs['meshless']
        out['f32'] = {
            'tokens_equal': m_toks == s_toks, 'n_scores': len(m_rec.scores),
            'worst': max(((x - y).abs().max() / y.abs().max()).item()
                         for x, y in zip(m_rec.scores, s_rec.scores)),
            'same_count': len(m_rec.scores) == len(s_rec.scores)}
        del model, params, runs, m_rec, s_rec

        model = build_model(cfg)
        params = model.init_params(0, device=dev)
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        witness = MeshWitness(model, params, mesh.shape['model'])
        eng = trace_engine(witness, params, MESH_MAX_SEQ, device=dev,
                           mesh=mesh, decode_kernel=True,
                           prefix_shared_attention=True)
        witness.engine = eng
        witness.shadow = trace_engine(model, params, MESH_MAX_SEQ,
                                      device=dev, mesh=mesh,
                                      decode_kernel=False)
        toks = run_trace(eng, MESH_PROMPT_PAGES, MESH_NEW_TOKENS)
        eng.close()
        witness.shadow.close()
        out['bf16'] = {
            'launches': dict(LAUNCHES), 'engine': eng._leader.id,
            'n_tokens': sum(map(len, toks)),
            'saved': eng.stats.shared_page_reads_saved,
            'ms': 1e3 * statistics.median(witness.decode_s),
            'failed': witness.verdict(
                'mesh of 2, bf16 engine drain, every decode step', card)}
        del eng, witness, params
        out['burst'] = mesh_burst(cfg, mesh, dev)
        return out
    finally:
        stop_ranks(mesh)


def need_launches(counts: dict, what: str) -> None:
    """K1, K2 and K3 each launched in ``counts``."""
    assert all(counts[k] > 0 for k in DECODE_KERNELS[:3]), (what, counts)


# Phases 16-23 run their one- and two-rank functions on ranks started once
# (launch.ranks.RankPool): ranks started for a phase of their own cost it
# 10-30 s on the H100 machine (each process imports torch, opens a CUDA
# context and makes its first calls), 27 s of phase 21's 38.8 s.  Phase
# 18's four ranks start while phase 17 runs, phase 24's sixteen while
# phase 23 runs, phase 26's four while phase 25 runs; each pool's ranks
# are warmed as they start (warm_rank: the first checkpointed step's
# import of torch._dynamo cost phase 24 ~21 s on 16 ranks).
POOLED = (1, 2)
_POOLS: dict = {}


def warm_rank(rank: int, dev: str) -> float:
    """A pooled rank's first call on ``dev`` and its import of
    ``torch._dynamo``, which the first checkpointed training step makes
    (~21 s on 16 ranks at once, PERF.md section 7), while the ranks wait
    for their first phase; -> its seconds."""
    t0 = time.perf_counter()
    torch.zeros(1, device=dev)
    import torch._dynamo as _dynamo  # noqa: F401
    return time.perf_counter() - t0


def start_ranks(n: int, timeout_s: float) -> None:
    """Start ``n`` pooled ranks sharing the card (gloo; one rank: NCCL) now,
    unless they run, and warm them (:func:`warm_rank`): their start
    overlaps whatever runs before their first use.  ``timeout_s`` bounds
    their group's collectives."""
    from repro_torch.launch.ranks import RankPool

    if n not in _POOLS:
        _POOLS[n] = RankPool(n, store_dir=ROOT / 'build' / 'mesh_store',
                             device_type=torch.device(DEV).type,
                             timeout_s=timeout_s)
        _POOLS[n].submit(warm_rank, (DEV,))


def on_ranks(fn, n: int, args, timeout_s: float) -> list:
    """``[fn(0, *args), ..., fn(n - 1, *args)]`` on ``n`` ranks sharing the
    card, within ``timeout_s``: pooled ranks (:data:`POOLED` sizes start at
    their first use), else ranks started for this call."""
    from repro_torch.launch.ranks import run_ranks

    if n in POOLED:
        # the group's collectives wait as long as the longest phase may
        start_ranks(n, MESH_TIMEOUT_S + MESH_TRAIN_TIMEOUT_S)
    if n not in _POOLS:
        return run_ranks(fn, n, store_dir=ROOT / 'build' / 'mesh_store',
                         device_type=torch.device(DEV).type, args=args,
                         timeout_s=timeout_s)
    pool = _POOLS[n]
    if pool.pending:
        t0 = time.perf_counter()
        warm = pool.collect(timeout_s)
        print(f'  {n} pooled ranks warmed in {min(warm):.1f}-{max(warm):.1f}'
              f' s each, {time.perf_counter() - t0:.1f} s of it waited for '
              f'here')
    return pool.run(fn, args, timeout_s=timeout_s)


def close_pools(sizes=None) -> None:
    """End the pooled ranks of ``sizes`` (all where None): each exits."""
    for n in list(_POOLS) if sizes is None else sizes:
        if n in _POOLS:
            _POOLS.pop(n).close()


def mesh_check(card: str):
    """Phase 16: (a) one rank over NCCL, bit-equal to the meshless drain;
    (b) two ranks sharing the card, f32 within :data:`MESH_TOL` with equal
    tokens, bf16 under the Witness with K1/K2/K3 launched on both ranks;
    (c) the per-device preemption bound.  Returns the two-rank bf16
    drain's launches over both ranks and what its Witness failed."""
    import dataclasses

    from repro_torch.configs import get_config

    gc.collect()
    torch.cuda.empty_cache()
    full = get_config(MESH_ARCH)
    cfg = dataclasses.replace(full, n_layers=MESH_BF16_LAYERS)
    cut = dataclasses.replace(full, n_layers=MESH_F32_LAYERS)
    kind = torch.device(DEV).type
    one = on_ranks(mesh_rank_one, 1, (cfg, DEV), MESH_TIMEOUT_S)[0]
    print(f'  (a) mesh of 1 ({one["backend"]}): {one["n_tokens"]} tokens, '
          f'{one["n_scores"]} score blocks, tokens equal to the meshless '
          f'drain: {one["tokens_equal"]}, scores bit-equal: '
          f'{one["scores_equal"]}; shared_page_reads_saved {one["saved"]}, '
          f'launches {one["launches"]}  [{card}]')
    lead, worker = on_ranks(mesh_rank_two, 2, (cfg, cut, DEV, card),
                            MESH_TIMEOUT_S)
    f32, bf16, burst = lead['f32'], lead['bf16'], lead['burst']
    # rank 1's launches for the bf16 drain's engine alone (from 0 at its open)
    rank1 = worker['launches'][bf16['engine']]
    print(f'  (b) mesh of 2 ({lead["backend"]}, one card): f32 at '
          f'{MESH_F32_LAYERS} of {full.n_layers} layers, {f32["n_scores"]} '
          f'score blocks: tokens equal to the meshless drain: '
          f'{f32["tokens_equal"]}, max |mesh - meshless| {f32["worst"]:.3e} '
          f'of |max|; bf16 at {cfg.n_layers} of {full.n_layers} layers: '
          f'{bf16["n_tokens"]} tokens, '
          f'shared_page_reads_saved {bf16["saved"]}, launches rank 0 '
          f'{bf16["launches"]}, rank 1 {rank1}  [{card}]')
    print(f'  decode step ({MESH_ARCH} at {cfg.n_layers} layers, bf16, '
          f'K1/K2/K3, unfused, <= 3 rows): meshless {one["ms"]["meshless"]:.2f} ms, mesh of 1 '
          f'{one["ms"]["mesh"]:.2f} ms, mesh of 2 sharing the card '
          f'{bf16["ms"]:.2f} ms (medians)  [{card}]')
    print(f'  (c) burst on the mesh of 2: {burst["gates"]} gates, '
          f'{burst["events"]} preemption events, device latencies an event '
          f'{burst["latencies"]}, max preemptions per (request, device) '
          f'{burst["max_per_device"]}, finished {burst["finished"]}  '
          f'[{card}]')
    assert 'nccl' in one['backend'] or kind == 'cpu', one['backend']
    assert one['tokens_equal'] and one['scores_equal'], one
    assert one['saved'] > 0
    need_launches(one['launches'], 'mesh of 1')
    assert f32['tokens_equal'] and f32['same_count'], f32
    assert f32['worst'] <= MESH_TOL, f32
    assert bf16['saved'] > 0
    need_launches(bf16['launches'], 'mesh of 2, rank 0')
    need_launches(rank1, 'mesh of 2, rank 1')
    assert burst['gates'] == 2 and burst['latencies'] == [2], burst
    assert burst['events'] > 0 and burst['max_per_device'] <= 1, burst
    assert burst['finished'] == [1, 2], burst
    launches = {k: bf16['launches'][k] + rank1[k] for k in bf16['launches']}
    return launches, bf16['failed']


# ---------------------------------------------------------------------------
# Phase 17: training over a mesh
# ---------------------------------------------------------------------------

MESH_AXES = ('data', 'model')
MT_LAYERS = 2                      # (a)'s depth, of 28
MT_B, MT_S, MT_MICRO = 4, 512, 2   # (a): global batch, 2 microbatches
MT_TOL = 1e-5                      # (a) f32: loss, grad_norm relative;
                                   # every leaf of its max |x|
MT_UPDATE_TOL = 0.25               # (a): each leaf's update (after -
                                   # before) off the meshless one, in lr
TP_STEPS = 2                       # (b) the bf16 steps at (1, 2)
DP_B, DP_S, DP_STEPS, DP_CKPT = 4, 2048, 4, 2     # (b) bf16
DP_LAYERS = 7                      # (b)'s depth, of 28, cut for the time
                                   # limit (its checkpoints and steps)
WG_SHAPE = (DP_LAYERS, 1024, 3072)  # (c): (b)'s wg stack, f32
EXPERT_LEAVES = ('layers/router', 'layers/we_gate', 'layers/we_up',
                 'layers/we_down')
MESH_TRAIN_TIMEOUT_S = 300         # bounds each spawned run of the phase


def masked_batch(cfg, b: int, s: int, step: int = 0) -> dict:
    """``batch_at`` with a loss mask that gives each data shard of each
    microbatch its own token count."""
    from repro_torch.training.data import DataConfig, batch_at

    batch = batch_at(DataConfig(seq_len=s, global_batch=b,
                                vocab_size=cfg.vocab_size), step)
    mask = np.ones((b, s), np.float32)
    mask[0, :s // 3] = 0
    mask[b - 1, s // 5:] = 0
    if cfg.family == 'encdec':             # the speech frames, f32
        batch['frames'] = (np.random.default_rng(step).standard_normal(
            (b, s, cfg.d_model), dtype=np.float32) * 0.02)
    return dict(batch, loss_mask=mask)


def leaf_errors(blocks, full) -> dict:
    """{path: max |got - want| over the leaf's global max |want|} of each
    block (``full``: the meshless tree; ``blocks``: path -> (tensor,
    Block)); NaN reads inf."""
    out = {}
    for k, (got, b) in blocks.items():
        want = full[k]
        err = float((got - b.take(want).to(got.device)).abs().max()
                    / want.abs().max())
        out[k] = math.inf if math.isnan(err) else err
    return out


def worst_block(blocks, full) -> float:
    """The largest of :func:`leaf_errors`."""
    return max(leaf_errors(blocks, full).values(), default=0.0)


def worst_update(blocks, before, delta, lr: float) -> float:
    """The largest of each block's max |(after - before) - delta| over
    ``lr`` (``blocks``: path -> (after, Block); ``before``: the global
    weights before the step on the CPU; ``delta``: the meshless step's
    update, on the CPU)."""
    worst = 0.0
    for k, (got, b) in blocks.items():
        moved = got - b.take(before[k]).to(got.device)
        worst = max(worst, float(
            (moved - b.take(delta[k]).to(got.device)).abs().max() / lr))
    return worst


def update_shares(blocks, before, delta) -> dict:
    """{path: ||(after - before) - delta|| / ||delta||} over each block
    (arguments as :func:`worst_update`'s): a block the step left unchanged
    reads 1 and one moved the other way 2, while AdamW's first update, lr
    times the sign of each gradient element, adds ~2 sqrt(f) where
    rounding flips the sign of a share f of a block's elements (an
    element-wise gate in lr reads up to 2 for one such element)."""
    out = {}
    for k, (got, b) in blocks.items():
        want = b.take(delta[k]).to(got.device)
        miss = torch.linalg.vector_norm(
            got - b.take(before[k]).to(got.device) - want)
        norm = torch.linalg.vector_norm(want)
        out[k] = float(miss / norm) if norm > 0 else (
            0.0 if miss == 0 else math.inf)
    return out


def null_spread(model, drawn, batch, micro: int, dev: str, grads, after,
                m0, nulls) -> dict:
    """The meshless step's spread over ``nulls`` ({name: context}: the same
    function summed in another order), on this rank: under each, the
    gradients (``loss_and_grads``) against ``grads`` per leaf as a share of
    its max, the step from them (``make_train_step``'s AdamW) against
    ``after`` per leaf as :func:`update_shares`, and grad_norm relative;
    the largest over the nulls, and each null's gradient errors
    (``by_null``).  ``grads`` and ``after`` lie on the card, ``drawn`` on
    the host or the card."""
    from repro_torch.distributed.sharding import Block
    from repro_torch.training import optimizer as opt
    from repro_torch.training import tree as tr
    from repro_torch.training.train_step import loss_and_grads

    before = dict(tr.leaves_with_paths(drawn))
    delta = {k: v - before[k].to(v.device) for k, v in after.items()} \
        if nulls else {}
    out = {'grads': {}, 'update': {}, 'grad_norm': 0.0, 'by_null': {}}
    whole = lambda tree: {  # noqa: E731
        k: (v.detach(), Block.whole(tuple(v.shape)))
        for k, v in tr.leaves_with_paths(tree)}
    for name, context in nulls.items():
        params = f32_params(drawn, dev)
        with context():
            _, g = loss_and_grads(model, params, batch, micro)
        errs = leaf_errors(whole(g), grads)
        _, _, mn = opt.adamw_update(opt.AdamWConfig(), params, g,
                                    opt.init_opt_state(params))
        shares = update_shares(whole(params), before, delta)
        for k, e in errs.items():
            out['grads'][k] = max(out['grads'].get(k, 0.0), e)
            out['update'][k] = max(out['update'].get(k, 0.0), shares[k])
        out['grad_norm'] = max(out['grad_norm'], abs(
            float(mn['grad_norm']) / float(m0['grad_norm']) - 1))
        out['by_null'][name] = errs
        del params, g
    return out


# phase 19's null spreads of the meshless f32 steps of rwkv6, zamba2 and
# seamless (per-leaf numbers, :func:`null_spread`), kept on each of the two
# pooled ranks for phase 23, which holds its variants to the same steps:
# {(config, batch, sequence, microbatches): spread}
NULL_SPREADS: dict = {}


def mesh_parity(cfg, dev: str, shapes=((2, 1), (1, 2)), b: int = MT_B,
                s: int = MT_S, micro: int = MT_MICRO,
                in_turn: bool = False, nulls=None, keep: str = 'cpu') -> dict:
    """Phase 17 (a), on one of two ranks sharing the card: f32 weights
    drawn on the card (the same on every rank) and kept on the host, one
    step with 2 microbatches and a loss mask, meshless on the card (its
    results kept on the host) and at each of ``shapes``; ZeRO-1 on against
    off at (2, 1).  Besides each parameter leaf against the meshless one,
    each leaf's update is held to the meshless update as a share of lr: at
    the first lr (3e-6) a parameter near 1 moves by ~3e-6 of its max,
    below the leaf gate, so only the update gate sees a step that left a
    slice unchanged (it would read ``unchanged``, the smallest leaf's max
    |update| / lr).  Each shape's result also holds every leaf's gradient
    error (``leaf_grads``), update share (``leaf_update``,
    :func:`update_shares`) and largest |gradient| (``grad_max``; the
    meshless ones in ``meshless['grad_max']``).  ``nulls`` ({name:
    context}): the meshless step's spread over them (:func:`null_spread`)
    in ``out['nulls']``.  ``keep``: where the drawn weights and the
    meshless results stay (the host, or the card where they fit: no
    copies back and forth); the spread over ``nulls`` also stays in
    :data:`NULL_SPREADS` for phase 23."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import build_model
    from repro_torch.training import optimizer as opt
    from repro_torch.training import tree as tr
    from repro_torch.training.train_step import (
        loss_and_grads, make_train_step, mesh_loss_and_grads, shard_batch)

    model = build_model(cfg)
    drawn = tr.tree_map(lambda x: x.detach().float().to(keep),
                        model.init_params(0, device=dev))
    host = masked_batch(cfg, b, s)
    # the meshless step, kept on ``keep``; ``in_turn``: on each rank in
    # turn (two ranks' at once do not fit the card at phi3.5-moe's widths)
    for r in range(torch.distributed.get_world_size() if in_turn else 1):
        if not in_turn or r == torch.distributed.get_rank():
            batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
            params = f32_params(drawn, dev)
            loss, grads = loss_and_grads(model, params, batch, micro)
            step = make_train_step(model, microbatches=micro)
            _, _, m0 = step(params, opt.init_opt_state(params), batch)
            grads = dict(tr.leaves_with_paths(grads))
            after = {k: v.detach() for k, v in tr.leaves_with_paths(params)}
            del params, step
            spread = null_spread(model, drawn, batch, micro, dev, grads,
                                 after, m0, nulls or {})
            grads = {k: v.to(keep) for k, v in grads.items()}
            after = {k: v.to(keep) for k, v in after.items()}
            del batch
            gc.collect()
            torch.cuda.empty_cache()
        if in_turn:
            torch.distributed.barrier()
    if nulls:
        NULL_SPREADS[cfg, b, s, micro] = spread
    before = dict(tr.leaves_with_paths(drawn))
    lr = float(m0['lr'])
    delta = {k: v - before[k] for k, v in after.items()}
    out = {'backend': str(torch.distributed.get_backend()),
           'tf32': torch.backends.cuda.matmul.allow_tf32, 'nulls': spread,
           'meshless': {'loss': float(m0['loss']),
                        'grad_norm': float(m0['grad_norm']), 'lr': lr,
                        'unchanged': min(float(d.abs().max()) / lr
                                         for d in delta.values()),
                        'grad_max': {k: float(v.abs().max())
                                     for k, v in grads.items()}}}
    for shape in shapes:
        mesh = make_mesh(shape, MESH_AXES, device=dev)
        step = make_train_step(model, mesh, microbatches=micro)
        plan = step.plan
        p = plan.shard_params(drawn)
        rows = shard_batch(host, plan, micro)
        _, g = mesh_loss_and_grads(model, plan, p, rows, micro)
        p, _, m = step(p, plan.init_opt_state(), rows)
        blocks = lambda tree: {k: (v.detach(), plan.param_blocks[k])  # noqa
                               for k, v in tr.leaves_with_paths(tree)}
        leaf_grads = leaf_errors(blocks(g), grads)
        res = {'loss': float(m['loss']), 'grad_norm': float(m['grad_norm']),
               'grads': max(leaf_grads.values()), 'leaf_grads': leaf_grads,
               'grad_max': {k: float(v.abs().max())
                            for k, v in tr.leaves_with_paths(g)},
               'experts': worst_block({k: v for k, v in blocks(g).items()
                                       if k in EXPERT_LEAVES}, grads),
               'params': worst_block(blocks(p), after),
               'update': worst_update(blocks(p), before, delta, lr),
               'leaf_update': update_shares(blocks(p), before, delta),
               'split': [k for k, bl in plan.param_blocks.items()
                         if not bl.is_whole()]}
        if shape == (2, 1):
            off = make_train_step(model, mesh, microbatches=micro,
                                  zero1=False)
            q, _, _ = off(off.plan.shard_params(drawn),
                          off.plan.init_opt_state(), rows)
            res['zero1_equal'] = all(torch.equal(a, b) for a, b in
                                     zip(tr.leaves(p), tr.leaves(q)))
            res['moment_elems'] = [
                sum(x.numel() for x in tr.leaves(s.plan.init_opt_state()['mu']))
                for s in (step, off)]
        out[shape] = res
    del grads, after, delta
    return out


class ReduceMeter:
    """Times every all-reduce of a device tensor and counts its bytes,
    while active: the trainer's data-parallel reduce.  Each waits at a
    barrier of its group first (the device synchronized), timed apart
    (``wait``): two ranks time-slice one card, so a rank that reaches the
    reduce first would otherwise count the other's backward as transport.
    The barriers add their own latency to the step."""

    def __init__(self):
        self.calls, self.nbytes, self.seconds, self.wait = 0, 0, 0.0, 0.0
        self._orig = torch.distributed.all_reduce

    def __enter__(self):
        def metered(tensor, *args, **kw):
            if not tensor.is_cuda and DEV != 'cpu':
                return self._orig(tensor, *args, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.distributed.barrier(group=kw.get('group'))
            t1 = time.perf_counter()
            self.wait += t1 - t0
            out = self._orig(tensor, *args, **kw)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t1
            self.nbytes += tensor.numel() * tensor.element_size()
            self.calls += 1
            return out
        torch.distributed.all_reduce = metered
        return self

    def __exit__(self, *exc):
        torch.distributed.all_reduce = self._orig


@contextlib.contextmanager
def depth_cut(layers: int):
    """``launch.train.train`` on its arch at published widths cut to
    ``layers`` layers while inside."""
    import dataclasses

    from repro_torch.launch import train as train_mod

    full = train_mod.get_config
    train_mod.get_config = lambda arch: dataclasses.replace(
        full(arch), n_layers=layers)
    try:
        yield
    finally:
        train_mod.get_config = full


def dp_train(shape, ckpt_dir: str, dev: str, restore: bool) -> dict:
    """Phase 17 (b), on one rank: ``launch.train.train`` on qwen3-0.6b at
    published widths cut to DP_LAYERS layers (bf16 weights, f32 moments)
    over ``shape``, the global batch DP_B x DP_S, a checkpoint every
    DP_CKPT steps; with ``restore`` the newest checkpoint restored onto
    this mesh, the steps after it, and no checkpoint written."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import train
    from repro_torch.training.optimizer import AdamWConfig

    mesh = make_mesh(shape, MESH_AXES, device=dev)
    torch.cuda.reset_peak_memory_stats()
    hist = []
    with ReduceMeter() as meter, depth_cut(DP_LAYERS):
        _, _, losses = train(
            TRAIN_ARCH, steps=DP_STEPS, batch=DP_B, seq=DP_S,
            use_reduced=False, ckpt_dir=ckpt_dir,
            ckpt_every=DP_STEPS + 1 if restore else DP_CKPT, restore=restore, mesh=mesh, log_every=DP_STEPS, history=hist,
            opt_cfg=AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP))
    return {'losses': losses, 'seconds': [h['seconds'] for h in hist],
            'grad_norms': [h['grad_norm'] for h in hist],
            'reduce': (meter.calls, meter.nbytes, meter.seconds, meter.wait),
            'peak': torch.cuda.max_memory_allocated(),
            'backend': str(torch.distributed.get_backend())}


def tp_train(dev: str) -> dict:
    """Phase 17 (b), the tensor-parallel half, on one rank: TP_STEPS steps
    of ``launch.train.train`` at (1, 2), bf16 at DP_LAYERS layers on (b)'s
    first global batches (the row-parallel products one bf16 GEMM that
    writes f32, ``tp._F32Product``, under autograd); no meter, no
    checkpoint."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import train
    from repro_torch.training.optimizer import AdamWConfig

    mesh = make_mesh((1, 2), MESH_AXES, device=dev)
    torch.cuda.reset_peak_memory_stats()
    hist = []
    with depth_cut(DP_LAYERS):
        _, _, losses = train(
            TRAIN_ARCH, steps=TP_STEPS, batch=DP_B, seq=DP_S,
            use_reduced=False, mesh=mesh, log_every=TP_STEPS, history=hist,
            opt_cfg=AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP))
    return {'losses': losses, 'seconds': [h['seconds'] for h in hist],
            'grad_norms': [h['grad_norm'] for h in hist],
            'peak': torch.cuda.max_memory_allocated()}


def compress_rank(rank: int, dev: str) -> dict:
    """Phase 17 (c), one of two ranks: the int8 compressed all-reduce of a
    ``WG_SHAPE`` f32 gradient (rank r's drawn from seed r) and of zeros with
    the carried residual; digests of what came out, the error against the
    exact mean of both ranks' gradients, before and after the feedback.
    :func:`mesh_train_rank` runs it on the card and on host tensors."""
    import hashlib

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training.compression import (init_error_state,
                                                  make_compressed_allreduce)

    mesh = make_mesh((2, 1), MESH_AXES, device=dev)
    fn = make_compressed_allreduce(mesh, ('data',))
    g = [torch.from_numpy(np.random.default_rng(r).standard_normal(
        WG_SHAPE, dtype=np.float32)) for r in range(2)]
    mean = ((g[0] + g[1]) / 2).to(dev)
    grads = {'w': g[rank].to(dev)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    red, err = fn(grads, init_error_state(grads))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    red2, _ = fn({'w': torch.zeros_like(grads['w'])}, err)
    top = mean.abs().max()
    rel = float((red['w'] - mean).abs().max() / top)
    rel2 = float((red['w'] + red2['w'] - mean).abs().max() / top)
    digest = {name: hashlib.sha256(x['w'].cpu().numpy().tobytes()).hexdigest()
              for name, x in (('out', red), ('residual', err),
                              ('out2', red2))}
    return {'digest': digest, 'rel': rel, 'rel2': rel2, 'seconds': seconds,
            'backend': str(torch.distributed.get_backend())}


def mesh_train_rank(rank: int, cut, ckpt_dir: str, dev: str) -> dict:
    """Phase 17 on one of two ranks sharing the card: (a), (b)'s unbroken
    run and its steps at (1, 2), (c) -- in one process a rank, which
    starts once -- and the hand-written kernel launches of all of them."""
    from repro_torch.kernels.common import LAUNCHES

    LAUNCHES.update(dict.fromkeys(LAUNCHES, 0))
    out = {'parity': mesh_parity(cut, dev)}
    gc.collect()
    torch.cuda.empty_cache()
    out['train'] = dp_train((2, 1), ckpt_dir, dev, False)
    gc.collect()
    torch.cuda.empty_cache()
    out['tp'] = tp_train(dev)
    gc.collect()
    torch.cuda.empty_cache()
    out['compress'] = compress_rank(rank, dev)
    # the same round on host tensors over the same gloo group (what CPU
    # ranks compute), in these processes: no second spawn
    out['compress_cpu'] = compress_rank(rank, 'cpu')
    return dict(out, launches=dict(LAUNCHES))


def restart_rank(rank: int, shape, ckpt_dir: str, dev: str) -> dict:
    """Phase 17 (b)'s restart on the mesh ``plan_recovery`` gives, and its
    hand-written kernel launches."""
    from repro_torch.kernels.common import LAUNCHES

    LAUNCHES.update(dict.fromkeys(LAUNCHES, 0))
    return dict(dp_train(shape, ckpt_dir, dev, True),
                launches=dict(LAUNCHES))


def mesh_train_check(card: str) -> dict:
    """Phase 17: (a) f32 parity of the mesh step with the meshless step
    on the card, ZeRO-1 on against off; (b) bf16 data-parallel training at
    DP_LAYERS layers, a checkpoint from both ranks, ``plan_recovery``'s
    shrink to
    one rank, the restart; (c) the compressed all-reduce, card against CPU
    ranks.  Returns the phase's hand-written kernel launches (every rank's:
    the trainer runs none)."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.training.fault_tolerance import (
        HeartbeatConfig, HeartbeatMonitor, plan_recovery)

    gc.collect()
    torch.cuda.empty_cache()
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    full = get_config(TRAIN_ARCH)
    cut = dataclasses.replace(full, n_layers=MT_LAYERS)

    (ROOT / 'build').mkdir(exist_ok=True)
    scratch = Path(tempfile.mkdtemp(prefix='mesh_train_', dir=ROOT / 'build'))
    try:
        t0 = time.perf_counter()
        ranks = on_ranks(mesh_train_rank, 2, (cut, str(scratch), DEV),
                         MESH_TRAIN_TIMEOUT_S)
        wall = time.perf_counter() - t0
        mon = HeartbeatMonitor(['h0', 'h1'], HeartbeatConfig(
            interval_s=1.0, miss_threshold=2))
        mon.beat('h0', 10.0)                   # the second rank's host lost
        # the run is lost after step DP_STEPS - 1: its last checkpoint
        # never committed
        shutil.rmtree(scratch / f'step_{DP_STEPS}')
        plan = plan_recovery(mon, devices_per_host=1, model_parallel=1,
                             last_ckpt_step=DP_CKPT, old_shape=(2, 1),
                             now=10.0)
        assert plan is not None and plan.new_shape == (1, 1), plan
        t1 = time.perf_counter()
        c = on_ranks(restart_rank, 1, (plan.new_shape, str(scratch), DEV),
                     MESH_TRAIN_TIMEOUT_S)[0]
        restart_s = time.perf_counter() - t1
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    a = [r['parity'] for r in ranks]
    b = [r['train'] for r in ranks]
    on_card = [r['compress'] for r in ranks]
    print(f'  two ranks on the card (a, b, c): {wall:.1f} s; the restart '
          f'on one: {restart_s:.1f} s  [{card}]')
    ref = a[0]['meshless']
    for shape in ((2, 1), (1, 2)):
        res = [r[shape] for r in a]
        lead = res[0]
        loss_rel = abs(lead['loss'] - ref['loss']) / abs(ref['loss'])
        norm_rel = abs(lead['grad_norm'] - ref['grad_norm']) / ref['grad_norm']
        grads = max(r['grads'] for r in res)
        params = max(r['params'] for r in res)
        update = max(r['update'] for r in res)
        print(f'  (a) {TRAIN_ARCH} at {MT_LAYERS} of {full.n_layers} layers, '
              f'f32, mesh {shape} ({a[0]["backend"]}, 2 ranks on one card), '
              f'B={MT_B}, S={MT_S}, {MT_MICRO} microbatches, a loss mask: '
              f'loss {lead["loss"]:.7f} vs meshless {ref["loss"]:.7f} (rel '
              f'{loss_rel:.3e}), grad_norm {lead["grad_norm"]:.6f} vs '
              f'{ref["grad_norm"]:.6f} (rel {norm_rel:.3e}); worst gradient '
              f'leaf {grads:.3e}, worst parameter leaf after the step '
              f'{params:.3e} of its max (gate {MT_TOL:g}); worst leaf '
              f'update off the meshless one {update:.3e} of lr '
              f'{ref["lr"]:.3e} (gate {MT_UPDATE_TOL:g}; a leaf left '
              f'unchanged would read at least {ref["unchanged"]:.3f})  '
              f'[{card}]')
        assert all(r['loss'] == lead['loss'] and
                   r['grad_norm'] == lead['grad_norm'] for r in res), res
        assert loss_rel <= MT_TOL and norm_rel <= MT_TOL, (shape, lead)
        assert grads <= MT_TOL and params <= MT_TOL, (shape, grads, params)
        assert update <= MT_UPDATE_TOL, (shape, update)
    assert ref['unchanged'] >= 3 * MT_UPDATE_TOL, ref
    z = [r[(2, 1)] for r in a]
    print(f'  (a) ZeRO-1 on vs off at (2, 1): parameters bit-equal '
          f'{all(r["zero1_equal"] for r in z)}; moment elements a rank '
          f'{z[0]["moment_elems"][0]} (on) vs {z[0]["moment_elems"][1]} '
          f'(off)  [{card}]')
    assert all(r['zero1_equal'] for r in z), z
    assert z[0]['moment_elems'][0] < z[0]['moment_elems'][1]

    losses = b[0]['losses']
    calls, nbytes, secs, wait = b[0]['reduce']
    steps = len(losses)
    step_s = [round(x * 1e3, 1) for x in b[0]['seconds']]
    print(f'  (b) {TRAIN_ARCH} at published widths, {DP_LAYERS} of '
          f'{full.n_layers} layers, bf16 weights, f32 moments, mesh (2, 1) ({b[0]["backend"]}: two ranks '
          f'share the card, the transport goes through host memory), global '
          f'B={DP_B}, S={DP_S}: losses {[round(x, 4) for x in losses]}, '
          f'grad norms {[round(x, 3) for x in b[0]["grad_norms"]]}; step '
          f'times {step_s} ms (host clock, synchronized, the checkpoint '
          f"writes outside them, the meter's barriers inside; the first "
          f'warms up)  [{card}]')
    print(f'  (b) gradient reduce a step (rank 0): {calls / steps:.1f} '
          f'all-reduces, {nbytes / steps / 1e9:.3f} GB of f32, '
          f'{secs / steps * 1e3:.1f} ms after a barrier of the group, '
          f'{wait / steps * 1e3:.1f} ms waiting at the barriers for the '
          f'other rank; peak memory rank 0 {b[0]["peak"] / 1e9:.2f} GB, '
          f'rank 1 {b[1]["peak"] / 1e9:.2f} GB  [{card}]')
    t = [r['tp'] for r in ranks]
    tp_diff = np.abs(np.subtract(t[0]['losses'], losses[:TP_STEPS]))
    print(f'  (b) the same model at (1, 2) (tensor-parallel, bf16, the '
          f'row-parallel products one bf16 GEMM writing f32 under '
          f'autograd), steps 0-{TP_STEPS - 1}: losses '
          f'{[round(x, 4) for x in t[0]["losses"]]}, grad norms '
          f'{[round(x, 3) for x in t[0]["grad_norms"]]}, largest loss '
          f'difference from (2, 1) {tp_diff.max():.3e} (gate '
          f'{RESTART_TOL:g} + {RESTART_TOL:g} |loss|); step times '
          f'{[round(x * 1e3, 1) for x in t[0]["seconds"]]} ms (host '
          f'clock, synchronized; the first warms up); peak memory rank 0 '
          f'{t[0]["peak"] / 1e9:.2f} GB, rank 1 {t[1]["peak"] / 1e9:.2f} '
          f'GB  [{card}]')
    assert t[1]['losses'] == t[0]['losses'], t
    np.testing.assert_allclose(t[0]['losses'], losses[:TP_STEPS],
                               rtol=RESTART_TOL, atol=RESTART_TOL)
    diff = np.abs(np.subtract(c['losses'], losses[DP_CKPT:]))
    print(f'  (b) plan_recovery: {plan.lost_hosts} lost, new mesh '
          f'{plan.new_shape} ({c["backend"]}), restored step '
          f'{plan.restore_step}: losses {[round(x, 4) for x in c["losses"]]}'
          f', largest difference from the unbroken run {diff.max():.3e} '
          f'(gate {RESTART_TOL:g} + {RESTART_TOL:g} |loss|); peak '
          f'{c["peak"] / 1e9:.2f} GB  [{card}]')
    assert all(np.isfinite(losses)) and b[1]['losses'] == losses, b
    assert len(c['losses']) == DP_STEPS - DP_CKPT
    np.testing.assert_allclose(c['losses'], losses[DP_CKPT:],
                               rtol=RESTART_TOL, atol=RESTART_TOL)

    on_cpu = [r['compress_cpu'] for r in ranks]
    n = int(np.prod(WG_SHAPE))
    same = [x['digest'] == y['digest'] for x, y in zip(on_card, on_cpu)]
    print(f'  (c) compressed all-reduce of a {WG_SHAPE} f32 leaf over 2 '
          f'ranks ({on_card[0]["backend"]} on the card, int8 SUM on the '
          f'wire: {n / 1e6:.1f} MB a rank against {4 * n / 1e6:.1f} MB in '
          f'f32): outputs and residuals bit-equal to the same round on '
          f'host tensors {same}; error of |mean| {on_card[0]["rel"]:.4f}, '
          f'after the feedback round {on_card[0]["rel2"]:.4f}; '
          f'{on_card[0]["seconds"] * 1e3:.1f} ms a round on the card, '
          f'{on_cpu[0]["seconds"] * 1e3:.1f} ms on the host  [{card}]')
    assert all(same), (on_card, on_cpu)
    assert all(r['rel'] < 0.15 and r['rel2'] < r['rel'] for r in on_card)

    launches = dict(LAUNCHES)
    for r in ranks + [c]:
        for k, v in r['launches'].items():
            launches[k] += v
    print(f'  hand-written kernel launches in the phase (every rank): '
          f'{launches}')
    assert not any(launches.values()), launches
    return launches


# ---------------------------------------------------------------------------
# Phase 18: data- and expert-parallel serving, K4 on blocks, MoE training
# ---------------------------------------------------------------------------

DP_SHAPES = ((2, 1), (2, 2))       # (a): (data, model), 2 and 4 gloo ranks
EP_SHAPE = (1, 2)                  # (b), (d): 8 experts a rank
EP_F32_LAYERS = 2                  # (b) the f32 drain's depth, of 32
EP_LAYERS = MOE_LAYERS             # (b) the bf16 drain's: phase 13's 16
EP_TRAIN_LAYERS = 1                # (d) f32 depth, of 32 (5.03 GB of
                                   # experts, then gradients, 2 moments)
EP_B, EP_S, EP_MICRO = 4, 256, 2   # (d): global batch, 2 microbatches
K4_BLOCKS = (2, 4)                 # (c): the vocabulary over model
K4_T = 0.8                         # (c): the sampling temperature


HALVES = 'halves'                  # MeshMoEWitness's order null


def null_context(order):
    """The context of a null ``order``: ``orders.halved_products`` (every
    bf16 product's inner dimension summed as two halves in f32), one of
    :data:`NULL_ORDERS` (:func:`plain_kernels`), or None (nothing)."""
    from repro_torch.orders import halved_products

    if order == HALVES:
        return halved_products()
    return plain_kernels(order) if order else contextlib.nullcontext()


def probe_follower() -> None:
    """Let this worker rank's followers run probe dispatches: a dispatch
    whose keywords name ``probe`` runs on a copy of the follower's pool
    (``probe`` an order of :data:`NULL_ORDERS`: under
    :func:`plain_kernels` in that order; None: as it is) and leaves the
    pool as it was.  Rank 0's :class:`MeshMoEWitness` sends them."""
    from repro_torch.distributed import tp as tpm
    from repro_torch.kernels.common import LAUNCHES

    run = tpm._Follower.run

    def probed(self, op, host, kw):
        if 'probe' not in kw:
            return run(self, op, host, kw)
        kw = dict(kw)
        order = kw.pop('probe')
        pool, counts = self.cache, dict(LAUNCHES)
        self.cache = {k: v.clone() for k, v in pool.items()}
        try:
            with null_context(order):
                run(self, op, host, kw)
        finally:
            self.cache = pool
            LAUNCHES.update(counts)        # a probe is no main-path launch
    tpm._Follower.run = probed


class MeshMoEWitness(MoEWitness):
    """Phase 13's :class:`MoEWitness` over a mesh, every score the mesh's
    own: after each kernel-path step (K1, or K2 + K3, on every rank's
    kv-heads) the mesh's plain path P, its kernel path K and the nulls
    (the plain models of the kernels' split algorithms, every rank under
    the same order) are computed on copies of every rank's pool by probe
    dispatches (:func:`probe_follower`): the step wrote only its new
    tokens' slots, which each probe writes again before it reads them.
    Beside the four attention nulls, the reach takes a fifth: the plain
    path with every bf16 product summed in halves
    (``orders.halved_products``).  The attention nulls alone reproduce P bit
    for bit on some rows, and a token off P's argmax there has reach 0
    however near the tie (the first card run failed two such rows, gaps
    1.7e-4 and 9.4e-4 of |max|); the spread gate still reads the kernels'
    plan null.  No weights beyond the ranks' blocks are held (the bf16
    expert stacks fill the card), so the single-device plain path is not
    a witness here; the routing rank 0 sees is the whole dispatch's."""

    def __init__(self, model):
        super().__init__(model)
        self.engine = None

    def decode_fn(self, params, cache, batch, *, use_kernel, tp):
        from repro_torch.kernels.common import LAUNCHES
        assert use_kernel

        cache, out = self.model.decode_fn(params, cache, batch,
                                          use_kernel=True, tp=tp)
        counts = dict(LAUNCHES)

        def scores(b, kernel, log, order=None):
            self.engine._leader.announce('decode', host_batch(b),
                                         use_kernel=kernel, probe=order)
            c = {k: v.clone() for k, v in cache.items()}
            with routing_log(log), null_context(order):
                return self.model.decode_fn(params, c, b, use_kernel=kernel,
                                            tp=tp)[1]

        logs = {'plain': [], 'kernel': []}
        unshared = {k: v for k, v in batch.items() if k != 'shared'}
        plain = scores(unshared, False, logs['plain'])
        kern = scores(batch, True, logs['kernel'])
        nulls = [scores(batch, True, [], order) for order in NULL_ORDERS]
        nulls.append(scores(unshared, False, [], HALVES))
        LAUNCHES.update(counts)
        live = (batch['page_table'][:, 0] != 0).nonzero()[:, 0]
        self._check(out[live].argmax(-1), plain[live], kern[live],
                    torch.stack(nulls)[:, live])
        self._routing(logs, live)
        return cache, out


def dp_rank(rank: int, shape, cfg, cut, dev: str, card: str) -> dict:
    """Phase 18 (a) on one rank of a (data, model) mesh sharing the card:
    the f32 drain cut to ``cut``'s depth (plain path, unfused), mesh vs
    meshless, the gathered pool against the meshless one; then the bf16
    drain at ``cfg``'s depth, K1/K2/K3 and K4 on, every fused step under
    :class:`MeshWitness`; every replica's pool bit-equal
    (``gather_cache`` refuses replicas that differ); at (2, 2) the burst.
    Rank 0 leads; the others serve."""
    from repro_torch.distributed.tp import serve_rank, stop_ranks
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import build_model

    mesh = make_mesh(shape, MESH_AXES, device=dev)
    if rank != 0:
        return serve_rank(mesh)
    try:
        out = {'backend': str(torch.distributed.get_backend())}
        model = build_model(cut)
        params = f32_copy(model.init_params(0, device=dev))
        runs = {}
        for name, m in (('mesh', mesh), ('meshless', None)):
            rec = Recorder(model)
            eng = trace_engine(rec, params, MESH_MAX_SEQ, device=dev,
                               mesh=m, decode_kernel=False)
            eng.cache = {k: v.float() for k, v in eng.cache.items()}
            toks = run_trace(eng, MESH_PROMPT_PAGES, MESH_NEW_TOKENS)
            runs[name] = (toks, rec, eng.gather_cache(),
                          m is not None and eng._tp.split_rows)
            eng.close()
        (m_toks, m_rec, m_pool, split), (s_toks, s_rec, s_pool, _) = \
            runs['mesh'], runs['meshless']
        out['f32'] = {
            'tokens_equal': m_toks == s_toks, 'n_scores': len(m_rec.scores),
            'same_count': len(m_rec.scores) == len(s_rec.scores),
            'worst': max(((x - y).abs().max() / y.abs().max()).item()
                         for x, y in zip(m_rec.scores, s_rec.scores)),
            'pool': max(cache_rel(m_pool[k], s_pool[k]) for k in m_pool),
            'split': split}
        del model, params, runs, m_rec, s_rec, m_pool, s_pool

        model = build_model(cfg)
        params = model.init_params(0, device=dev)
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        witness = MeshWitness(model, params, mesh.shape['model'])
        eng = trace_engine(witness, params, MESH_MAX_SEQ, device=dev,
                           mesh=mesh, decode_kernel=True, fused_sampling=True,
                           prefix_shared_attention=True)
        witness.engine = eng
        witness.shadow = trace_engine(model, params, MESH_MAX_SEQ,
                                      device=dev, mesh=mesh,
                                      decode_kernel=False)
        toks = run_trace(eng, MESH_PROMPT_PAGES, MESH_NEW_TOKENS)
        launches = dict(LAUNCHES)
        eng.gather_cache()                 # every replica bit-equal
        eng.close()
        witness.shadow.close()
        out['bf16'] = {
            'launches': launches, 'engine': eng._leader.id,
            'n_tokens': sum(map(len, toks)),
            'saved': eng.stats.shared_page_reads_saved,
            'ms': 1e3 * statistics.median(witness.decode_s),
            'failed': witness.verdict(
                f'mesh {shape}, bf16 fused drain, every decode step', card)}
        del eng, witness, params
        if shape == (2, 2):
            out['burst'] = mesh_burst(cfg, mesh, dev)
        return out
    finally:
        stop_ranks(mesh)


def ep_rank(rank: int, cut, cfg, dev: str, card: str) -> dict:
    """Phase 18 (b) on one of two ranks sharing the card, experts over
    ``model``: the f32 MoE drain cut to ``cut``'s depth, mesh vs meshless;
    then the bf16 drain at ``cfg``'s depth, each rank's blocks of its
    weights drawn on the card a leaf at a time (``Model.init_blocks``;
    the engine, handed rank 0's blocks, ships nothing: no card ever holds
    the whole set), K1/K2/K3 at G=4 on each rank's 4 kv-heads, every
    decode step under
    :class:`MeshMoEWitness`.  Rank 0 leads; rank 1 serves, running the
    witness's probes."""
    from repro_torch.distributed.tp import (engine_plan, serve_rank,
                                            stop_ranks)
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import build_model
    from repro_torch.training import tree as tr

    def own_blocks(c, plan):
        # a leaf drawn whole at a time (up to 25 GB of f32); the draw's
        # segments go back to the card before the other rank needs them
        blocks = build_model(c).init_blocks(0, plan, device=dev)
        gc.collect()
        torch.cuda.empty_cache()
        return blocks

    mesh = make_mesh(EP_SHAPE, MESH_AXES, device=dev)
    if rank != 0:
        probe_follower()
        out = serve_rank(mesh, blocks=own_blocks)
        return dict(out, peak=torch.cuda.max_memory_allocated())
    try:
        out = {'backend': str(torch.distributed.get_backend())}
        model = build_model(cut)
        params = f32_copy(model.init_params(0, device=dev))
        runs = {}
        for name, m in (('meshless', None), ('mesh', mesh)):
            log = []
            with routing_log(log):
                toks, eng = traced(model, params, m, dev, decode_kernel=False)
            runs[name] = (toks, sum(d for _, d in log))
            gc.collect()
            torch.cuda.empty_cache()
        out['f32'] = {'tokens_equal': runs['mesh'][0] == runs['meshless'][0],
                      'n_tokens': sum(map(len, runs['mesh'][0])),
                      'drops': (runs['meshless'][1], runs['mesh'][1])}
        del model, params, runs, eng
        gc.collect()
        torch.cuda.empty_cache()

        model = build_model(cfg)
        t0 = time.perf_counter()
        params = own_blocks(cfg, engine_plan(cfg, mesh))
        whole = sum(int(np.prod(leaf.shape)) * leaf.dtype.itemsize
                    for _, leaf in tr.leaves_with_paths(model.template()))
        drawn_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        witness = MeshMoEWitness(model)
        t0 = time.perf_counter()
        eng = trace_engine(witness, params, MESH_MAX_SEQ, device=dev,
                           mesh=mesh, decode_kernel=True,
                           prefix_shared_attention=True)
        open_s = time.perf_counter() - t0
        del params
        witness.engine = eng
        toks = run_trace(eng, MESH_PROMPT_PAGES, MESH_NEW_TOKENS)
        eng.close()
        out['bf16'] = {
            'launches': dict(LAUNCHES), 'engine': eng._leader.id,
            'n_tokens': sum(map(len, toks)), 'whole': whole,
            'block': sum(w.numel() * w.element_size()
                         for w in eng.params.parameters()),
            'peak': torch.cuda.max_memory_allocated(),
            'drawn_s': drawn_s, 'open_s': open_s,
            'saved': eng.stats.shared_page_reads_saved,
            'route': (witness.route_diff, witness.route_total),
            'dropped': dict(witness.dropped),
            'failed': witness.verdict(
                f'MoE mesh {EP_SHAPE}, bf16 drain, every decode step', card)}
        return out
    finally:
        stop_ranks(mesh)


def ep_train_rank(rank: int, cut, dev: str) -> dict:
    """Phase 18 (d) on one of two ranks sharing the card: phase 17 (a)'s
    parity, phi3.5-moe cut to ``cut``'s depth, at (1, 2), and the
    hand-written kernel launches (none: the trainer runs the plain
    paths)."""
    from repro_torch.kernels.common import LAUNCHES

    LAUNCHES.update(dict.fromkeys(LAUNCHES, 0))
    torch.cuda.reset_peak_memory_stats()
    out = mesh_parity(cut, dev, shapes=(EP_SHAPE,), b=EP_B, s=EP_S,
                      micro=EP_MICRO, in_turn=True)
    return {'parity': out, 'peak': torch.cuda.max_memory_allocated(),
            'launches': dict(LAUNCHES)}


def ep_serve_train_rank(rank: int, cut, cfg, t_cut, dev: str,
                        card: str) -> dict:
    """Phase 18 (b), then (d), on one of two ranks sharing the card: one
    spawn for both (:func:`ep_rank`, :func:`ep_train_rank`), and each
    part's seconds."""
    t0 = time.perf_counter()
    serve = ep_rank(rank, cut, cfg, dev, card)
    serve_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train = ep_train_rank(rank, t_cut, dev)
    return {'serve': serve, 'serve_s': serve_s, 'train': train,
            'train_s': time.perf_counter() - t0}


def local_noise_kernel():
    """K4 built from a copy of ``sampling.cu`` that draws each block's
    noise at its local columns (the global index still reported): the
    mutant the block check must reject.  Returns ``fn(last, head, seed,
    temperature, col0)`` -> (values, columns)."""
    import ctypes

    from repro_torch.kernels import common as kc
    from repro_torch.kernels.sampling import ops as so

    fn = ctypes.CDLL(str(mutant_library('k4_local'))).valve_unembed_sample
    fn.argtypes, fn.restype = list(so._ARGS), ctypes.c_int

    def run(last, head, seed, temperature, col0):
        b, d = last.shape
        v = head.shape[0]
        rows = so.plan_vocab_ranges(v, sms())
        n_ctas = -(-v // rows)
        part_v = torch.empty((n_ctas, b), dtype=torch.float32, device=DEV)
        part_i = torch.empty((n_ctas, b), dtype=torch.int32, device=DEV)
        val = torch.empty((b,), dtype=torch.float32, device=DEV)
        idx = torch.empty((b,), dtype=torch.int32, device=DEV)
        kc.check_launch(fn(last.data_ptr(), head.data_ptr(), b, d, v, rows,
                           float(temperature), seed, 0, col0,
                           part_v.data_ptr(), part_i.data_ptr(),
                           val.data_ptr(), idx.data_ptr(),
                           kc.stream_ptr(last)), 'K4, noise at local columns')
        return val, idx
    return run


def k4_block_check(card: str) -> list:
    """Phase 18 (c): K4 over n = 2 and 4 blocks of qwen3-0.6b's head (V =
    151936, D = 1024, B = 8: a rank's block as its own tensor), at T = 0
    and T > 0, with winners tied exactly across the first block boundary,
    combined (larger value, ties to the lower column): bit-equal to K4 over
    the whole head and to the combine of the plain block version up to
    f32-order ties; rows from row0 = 3 draw the whole batch's noise; the
    local-column mutant rejected.  Each block's time, the combine's, their
    bounds and library times.  Returns the timing lines' numbers."""
    from repro_torch.kernels.common import gumbel_hash_noise
    from repro_torch.kernels.sampling.ops import (fused_unembed_sample,
                                                  unembed_argmax_block)
    from repro_torch.kernels.sampling.ref import (combine_bests,
                                                  unembed_argmax_block_ref,
                                                  unembed_scores)

    gen = torch.Generator(device=DEV).manual_seed(18)
    v, d = V_QWEN, D_QWEN
    head = (torch.randn((v, d), generator=gen, device=DEV)
            * d ** -0.5).to(torch.bfloat16)
    last = torch.randn((B, d), generator=gen, device=DEV).to(torch.bfloat16)
    mutant = local_noise_kernel()
    timer, rows = Timer(), []
    for n in K4_BLOCKS:
        w = v // n
        assert v % n == 0
        h = head.clone()
        # rows 0, 1: winners just before the first block edge, the same
        # bits again just past it
        lf = last[:2].float()
        h[[w - 1, w - 2]] = (lf * (64.0 / lf.pow(2).sum(-1, keepdim=True))
                             ).to(h.dtype)
        h[w], h[w + 5] = h[w - 1], h[w - 2]
        blocks = [h[c:c + w].contiguous() for c in range(0, v, w)]
        for t in (0.0, K4_T):
            def pick(fn, x=last, row0=0):
                parts = [fn(x, blk, 11, t, row0, c * w)
                         for c, blk in enumerate(blocks)]
                return combine_bests(torch.stack([p[0] for p in parts]),
                                     torch.stack([p[1] for p in parts]))
            kern = lambda x, blk, seed, t, row0, col0: unembed_argmax_block(  # noqa
                x, blk, seed, temperature=t, row0=row0, col0=col0)
            plain = lambda x, blk, seed, t, row0, col0: \
                unembed_argmax_block_ref(x, blk, seed, temperature=t,  # noqa
                                         row0=row0, col0=col0)
            whole = fused_unembed_sample(last, h, 11, temperature=t)
            got, ref = pick(kern), pick(plain)
            assert torch.equal(got, whole), (n, t, got, whole)
            if t == 0.0:
                assert got[:2].tolist() == [w - 1, w - 2], got
            scores = unembed_scores(last, h)
            if t > 0:
                scores = scores / t + gumbel_hash_noise(
                    11, torch.arange(B, device=DEV)[:, None],
                    torch.arange(v, device=DEV)[None, :])
            for r, (a, b) in enumerate(zip(got.tolist(), ref.tolist())):
                assert a == b or near_tie(scores[r], a, b), (n, t, r, a, b)
            sub = pick(kern, last[3:], 3)
            assert torch.equal(sub, whole[3:]), (n, t, sub, whole)
            if t > 0:
                bad = pick(lambda x, blk, seed, t, row0, col0: mutant(
                    x, blk, seed, t, col0))
                assert not torch.equal(bad, whole), \
                    f'K4 noise at local columns not rejected (n={n})'
        vals = torch.randn((n, B), generator=gen, device=DEV)
        idxs = torch.randint(0, v, (n, B), generator=gen, device=DEV,
                             dtype=torch.int32)
        blk = blocks[0]
        t_blk = timer(lambda: unembed_argmax_block(last, blk, 11,
                                                   temperature=K4_T))
        lib_blk = timer(lambda: torch.argmax(last @ blk.T, dim=-1))
        t_cmb = timer(lambda: combine_bests(vals, idxs))
        lib_cmb = timer(lambda: idxs.gather(0, vals.argmax(0)[None]))
        b_blk = bound(w * d * 2 + B * d * 2 + B * 8, 2 * B * w * d)
        b_cmb = bound(n * B * 8 + B * 4, 2 * n * B)
        print(f'  K4 over a block of {w} x {d} (n={n}, B={B}, T={K4_T}): '
              f'ms {t_blk:.4f}  library_ms {lib_blk:.4f} (argmax(last @ '
              f'W_block.T))  bound_ms {b_blk[0]:.4f} ({b_blk[1]}); the '
              f'combine of {n} (value, column) bests: ms {t_cmb:.4f}  '
              f'library_ms {lib_cmb:.4f} (argmax over the blocks, then the '
              f'gather of its column)  bound_ms {b_cmb[0]:.6f} '
              f'({b_cmb[1]})  [{card}]')
        rows.append((n, t_blk, lib_blk, b_blk[0], t_cmb, lib_cmb, b_cmb[0]))
    print(f'  K4 on blocks: n = {K4_BLOCKS}, T = 0 and {K4_T}: the combine '
          f'bit-equal to K4 over the whole head, ties across the block '
          f'edge to the first, row0 = 3 equal, the plain block version '
          f'equal up to f32-order ties, the local-column mutant rejected  '
          f'[{card}]')
    return rows


def dp_ep_check(card: str):
    """Phase 18: (a) data-parallel serving of qwen3-0.6b at (2, 1) and
    (2, 2); (c) K4 on blocks; (b) the MoE engine over (1, 2), then (d) MoE
    training over (1, 2) in the same two ranks.  Returns the phase's
    main-path launches (the bf16 drains of (a) and (b), every rank) and
    what the witnesses failed."""
    import dataclasses

    from repro_torch.configs import get_config

    gc.collect()
    torch.cuda.empty_cache()
    full = get_config(MESH_ARCH)
    cfg = dataclasses.replace(full, n_layers=MESH_BF16_LAYERS)
    cut = dataclasses.replace(full, n_layers=MESH_F32_LAYERS)
    launches, failed = None, []

    def add(counts):
        nonlocal launches
        launches = dict(counts) if launches is None else {
            k: launches[k] + counts[k] for k in launches}

    for shape in DP_SHAPES:
        t0 = time.perf_counter()
        ranks = on_ranks(dp_rank, int(np.prod(shape)),
                         (shape, cfg, cut, DEV, card), MESH_TIMEOUT_S)
        lead, f32, bf16 = ranks[0], ranks[0]['f32'], ranks[0]['bf16']
        others = [r['launches'][bf16['engine']] for r in ranks[1:]]
        print(f'  (a) {MESH_ARCH} on (data, model) = {shape} '
              f'({lead["backend"]}, {len(ranks)} ranks on one card, '
              f'{time.perf_counter() - t0:.1f} s): f32 at {MESH_F32_LAYERS} '
              f'of {full.n_layers} layers, rows split over data '
              f'{f32["split"]}: tokens equal to the meshless drain '
              f'{f32["tokens_equal"]}, max |mesh - meshless| '
              f'{f32["worst"]:.3e} of |max| over {f32["n_scores"]} score '
              f'blocks, gathered pool off the meshless one by '
              f'{f32["pool"]:.3e}; bf16 at {cfg.n_layers} layers, fused: '
              f'{bf16["n_tokens"]} tokens, shared_page_reads_saved '
              f'{bf16["saved"]}, replicas bit-equal, decode step '
              f'{bf16["ms"]:.2f} ms (median, ranks time-slicing one card: '
              f'recorded, not a claim), launches rank 0 {bf16["launches"]}, '
              f'the others {others}  [{card}]')
        assert f32['tokens_equal'] and f32['same_count'] and f32['split'], \
            f32
        assert f32['worst'] <= MESH_TOL and f32['pool'] <= MESH_TOL, f32
        assert bf16['saved'] > 0
        for r, counts in enumerate([bf16['launches']] + others):
            assert all(counts[k] > 0 for k in DECODE_KERNELS), \
                (shape, r, counts)
            add(counts)
        failed += bf16['failed']
        if 'burst' in lead:
            burst = lead['burst']
            print(f'  (a) burst on {shape}: {burst["gates"]} gates, '
                  f'{burst["events"]} preemption events, device latencies '
                  f'an event {burst["latencies"]}, max preemptions per '
                  f'(request, device) {burst["max_per_device"]}, finished '
                  f'{burst["finished"]}  [{card}]')
            assert burst['gates'] == 4 and burst['latencies'] == [4], burst
            assert burst['events'] > 0 and burst['max_per_device'] <= 1
            assert burst['finished'] == [1, 2], burst

    k4_block_check(card)

    # (b) and (d): two ranks, spawned once
    gc.collect()
    torch.cuda.empty_cache()
    moe = get_config(MOE_ARCH)
    moe_cut = dataclasses.replace(moe, n_layers=EP_F32_LAYERS)
    moe_cfg = dataclasses.replace(moe, n_layers=EP_LAYERS)
    t_cut = dataclasses.replace(moe, n_layers=EP_TRAIN_LAYERS)
    both = on_ranks(ep_serve_train_rank, 2,
                    (moe_cut, moe_cfg, t_cut, DEV, card),
                    MESH_TIMEOUT_S + MESH_TRAIN_TIMEOUT_S)
    lead, worker = (r['serve'] for r in both)
    f32, bf16 = lead['f32'], lead['bf16']
    rank1 = worker['launches'][bf16['engine']]
    print(f'  (b) {MOE_ARCH} on (data, model) = {EP_SHAPE} '
          f'({lead["backend"]}, {both[0]["serve_s"]:.1f} s), 8 '
          f'experts a rank: f32 at {EP_F32_LAYERS} of 32 layers: '
          f'{f32["n_tokens"]} tokens equal to the meshless drain '
          f'{f32["tokens_equal"]}, assignments dropped (meshless, mesh) '
          f'{f32["drops"]}; bf16 at {EP_LAYERS} of 32 layers: weights '
          f'{bf16["whole"] / 1e9:.2f} GB, each rank\'s blocks drawn on the '
          f'card a leaf at a time (rank 0 {bf16["drawn_s"]:.1f} s, rank 1 '
          f'at the engine\'s open), engine opened in {bf16["open_s"]:.1f} '
          f's, rank 0 holds {bf16["block"] / 1e9:.2f} GB of them, peak '
          f'{bf16["peak"] / 1e9:.2f} GB (rank 1 {worker["peak"] / 1e9:.2f} '
          f'GB); {bf16["n_tokens"]} tokens, shared_page_reads_saved '
          f'{bf16["saved"]}; routing: {bf16["route"][0]} of '
          f'{bf16["route"][1]} live token-layers choose another expert set '
          f'on the kernel path than on the mesh\'s plain path, dropped '
          f'{bf16["dropped"]}; launches rank 0 {bf16["launches"]}, rank 1 '
          f'{rank1}  [{card}]')
    assert f32['tokens_equal'] and sum(f32['drops']) > 0, f32
    assert bf16['peak'] < bf16['whole'], bf16
    assert bf16['saved'] > 0
    for counts in (bf16['launches'], rank1):
        need_launches(counts, 'MoE mesh')
        add(counts)
    failed += bf16['failed']

    ranks = [r['train'] for r in both]
    ref = ranks[0]['parity']['meshless']
    res = [r['parity'][EP_SHAPE] for r in ranks]
    lead = res[0]
    loss_rel = abs(lead['loss'] - ref['loss']) / abs(ref['loss'])
    norm_rel = abs(lead['grad_norm'] - ref['grad_norm']) / ref['grad_norm']
    grads, params = max(r['grads'] for r in res), max(r['params'] for r in res)
    experts = max(r['experts'] for r in res)
    update = max(r['update'] for r in res)
    print(f'  (d) {MOE_ARCH} training at {EP_TRAIN_LAYERS} of 32 layers, '
          f'f32, {EP_SHAPE} ({both[0]["train_s"]:.1f} s, 2 ranks on '
          f'one card), B={EP_B}, S={EP_S}, {EP_MICRO} microbatches, a loss '
          f'mask: loss {lead["loss"]:.7f} vs meshless {ref["loss"]:.7f} '
          f'(rel {loss_rel:.3e}), grad_norm {lead["grad_norm"]:.6f} vs '
          f'{ref["grad_norm"]:.6f} (rel {norm_rel:.3e}); worst gradient '
          f'leaf {grads:.3e} (router and we_*: {experts:.3e}), worst '
          f'parameter leaf {params:.3e} of its max (gate {MT_TOL:g}); '
          f'worst leaf update off the meshless one {update:.3e} of lr '
          f'(gate {MT_UPDATE_TOL:g}); peak memory rank 0 '
          f'{ranks[0]["peak"] / 1e9:.2f} GB, rank 1 '
          f'{ranks[1]["peak"] / 1e9:.2f} GB  [{card}]')
    assert all(r['loss'] == lead['loss'] and
               r['grad_norm'] == lead['grad_norm'] for r in res), res
    assert loss_rel <= MT_TOL and norm_rel <= MT_TOL, (lead, ref)
    assert grads <= MT_TOL and params <= MT_TOL, (grads, params)
    assert update <= MT_UPDATE_TOL and ref['unchanged'] >= 3 * MT_UPDATE_TOL
    assert not any(v for r in ranks for v in r['launches'].values())
    return launches, failed


# ---------------------------------------------------------------------------
# Phase 19: tensor-parallel training of rwkv6, zamba2 and seamless
# ---------------------------------------------------------------------------

# (arch, depth): rwkv6-3b 2 of 32 layers, zamba2-2.7b 12 of 54 (two
# applications of the shared block), seamless-m4t-medium 2 + 2 of 12 + 12
FM_FAMILIES = (('rwkv6-3b', 2), ('zamba2-2.7b', 12),
               ('seamless-m4t-medium', 2))
FM_SHAPE = (1, 2)                  # (data, model): 2 gloo ranks
FM_B, FM_S, FM_MICRO = 4, 512, 2   # (a) f32: global batch, 2 microbatches
FM_BF16_S, FM_STEPS = 512, 2       # (b) bf16: B = FM_B (S cut from 1024
                                   # for the time limit); the first warms up
ZERO_GRAD = 'dec_layers/xbk'       # seamless: the exact-zero gradient
FM_NULL = 2                        # (a): a gradient gate may widen to 2x
                                   # the leaf's null
FM_UPDATE_TOL = 0.1                # (a): each block's update off the
                                   # meshless one, a share of its norm
                                   # (unchanged reads 1; update_shares)


def family_cut(arch: str, layers: int):
    """``arch`` at its published widths, depth cut to ``layers`` (encoder
    and decoder each, for an encoder-decoder)."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if cfg.family == 'encdec':
        return dataclasses.replace(cfg, enc_layers=layers, dec_layers=layers)
    return dataclasses.replace(cfg, n_layers=layers)


@contextlib.contextmanager
def plain_ssd_chunk(chunk: int):
    """zamba2's chunked SSD at another chunk: the same function summed in
    another order."""
    from repro_torch.models import zamba2

    saved = zamba2.ssd_chunked
    zamba2.ssd_chunked = functools.partial(saved, chunk=chunk)
    try:
        yield
    finally:
        zamba2.ssd_chunked = saved


def family_nulls(cfg) -> dict:
    """The meshless step's nulls for ``cfg``'s family, {name: context}:
    the step again as it is (the card's run-to-run spread), every f32
    product in two halves of its sum or of its columns
    (``orders.halved_products``), and the recurrence's chunked form at
    chunk 64."""
    from repro_torch.orders import halved_products

    nulls = {'again': contextlib.nullcontext,
             'sum halves': functools.partial(halved_products, torch.float32,
                                             'sum'),
             'column halves': functools.partial(halved_products,
                                                torch.float32, 'columns')}
    if cfg.family == 'ssm':
        nulls['wkv chunk 64'] = functools.partial(plain_wkv_chunk, 64)
    elif cfg.family == 'hybrid':
        nulls['ssd chunk 64'] = functools.partial(plain_ssd_chunk, 64)
    return nulls


def family_bf16(cfg, dev: str) -> dict:
    """Phase 19 (b), on one of two ranks sharing the card: bf16 weights
    drawn on the card, FM_STEPS meshless steps on rank 0 (the other rank
    waits), then FM_STEPS steps at :data:`FM_SHAPE` on both, global batch
    FM_B x FM_BF16_S; each step's seconds (host clock, synchronized) and
    each run's peak memory on this rank."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import build_model
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_step import make_train_step, shard_batch

    model = build_model(cfg)
    ocfg = opt.AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP)
    hosts = [masked_batch(cfg, FM_B, FM_BF16_S, s) for s in range(FM_STEPS)]

    def run(step, params, state, batches):
        losses, seconds = [], []
        for batch in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step(params, state, batch)
            losses.append(float(m['loss']))
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        return losses, seconds

    out = {}
    if torch.distributed.get_rank() == 0:
        torch.cuda.reset_peak_memory_stats()
        params = model.init_params(0, device=dev, requires_grad=True)
        losses, seconds = run(
            make_train_step(model, opt_cfg=ocfg), params,
            opt.init_opt_state(params),
            [{k: torch.from_numpy(v).to(dev) for k, v in h.items()}
             for h in hosts])
        out['meshless'] = {'losses': losses, 'seconds': seconds,
                           'peak': torch.cuda.max_memory_allocated()}
        del params
        gc.collect()
        torch.cuda.empty_cache()
    torch.distributed.barrier()
    torch.cuda.reset_peak_memory_stats()
    mesh = make_mesh(FM_SHAPE, MESH_AXES, device=dev)
    step = make_train_step(model, mesh, opt_cfg=ocfg)
    plan = step.plan
    params = plan.shard_params(model.init_params(0, device=dev))
    losses, seconds = run(step, params, plan.init_opt_state(),
                          [shard_batch(h, plan) for h in hosts])
    out['mesh'] = {'losses': losses, 'seconds': seconds,
                   'peak': torch.cuda.max_memory_allocated()}
    return out


def family_rank(rank: int, cuts, dev: str) -> dict:
    """Phase 19 on one of two ranks sharing the card: (a) and (b) of each
    family in turn, their seconds, and the hand-written kernel launches
    (none: the trainer runs the plain paths)."""
    from repro_torch.kernels.common import LAUNCHES

    LAUNCHES.update(dict.fromkeys(LAUNCHES, 0))
    out = {'backend': str(torch.distributed.get_backend())}
    for arch, cfg in cuts:
        t0 = time.perf_counter()
        out[arch] = {'parity': mesh_parity(
            cfg, dev, shapes=(FM_SHAPE,), b=FM_B, s=FM_S, micro=FM_MICRO,
            in_turn=True, nulls=family_nulls(cfg), keep=dev)}
        gc.collect()
        torch.cuda.empty_cache()
        out[arch]['bf16'] = family_bf16(cfg, dev)
        gc.collect()
        torch.cuda.empty_cache()
        out[arch]['seconds'] = time.perf_counter() - t0
    return dict(out, launches=dict(LAUNCHES))


def family_mesh_check(card: str) -> dict:
    """Phase 19: rwkv6, zamba2 and seamless at published widths trained
    tensor-parallel over (1, 2) by two ranks sharing the card: (a) f32
    parity of one step with the meshless step on the card
    (:func:`mesh_parity`): loss within MT_TOL relative, grad_norm and each
    gradient leaf within MT_TOL (relative, of the leaf's max) or, where it
    is larger, within FM_NULL times the meshless step's own spread over its
    nulls (``family_nulls``: the same function run again and summed in
    other orders); each block's update within FM_UPDATE_TOL of the
    meshless update's norm (a fixed gate: an unchanged block reads 1);
    seamless's exact-zero gradient held apart; (b) bf16 steps
    timed beside the meshless step, peak memory a rank.  Every family is
    printed before any gate is asserted.  Returns the phase's hand-written
    kernel launches (every rank's)."""
    from repro_torch.kernels.common import LAUNCHES

    gc.collect()
    torch.cuda.empty_cache()
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    cuts = [(arch, family_cut(arch, layers)) for arch, layers in FM_FAMILIES]
    t0 = time.perf_counter()
    ranks = on_ranks(family_rank, 2, (cuts, DEV), MESH_TRAIN_TIMEOUT_S)
    print(f'  two ranks on the card ({ranks[0]["backend"]}): '
          f'{time.perf_counter() - t0:.1f} s  [{card}]')
    failed = []

    def gate(ok, what):
        if not ok:
            failed.append(what)

    for (arch, layers), (_, cfg) in zip(FM_FAMILIES, cuts):
        a = [r[arch]['parity'] for r in ranks]
        ref, res = a[0]['meshless'], [x[FM_SHAPE] for x in a]
        loss_rel = abs(res[0]['loss'] - ref['loss']) / abs(ref['loss'])
        norm_rel = abs(res[0]['grad_norm'] - ref['grad_norm']) \
            / ref['grad_norm']
        held = [k for k in res[0]['leaf_grads'] if k != ZERO_GRAD]
        # each rank holds its blocks to its own meshless step and nulls
        g_ratio, g_leaf, grads = max(
            (x['leaf_grads'][k] / max(MT_TOL, FM_NULL
                                      * p['nulls']['grads'][k]), k,
             x['leaf_grads'][k]) for p, x in zip(a, res) for k in held)
        update, u_leaf = max((x['leaf_update'][k], k) for x in res
                             for k in held)
        u_null = max(p['nulls']['update'][k] for p in a for k in held)
        n_gate = max(MT_TOL, FM_NULL * max(p['nulls']['grad_norm']
                                           for p in a))
        nulls = ', '.join(
            f'{n} {max(e for p in a for k, e in p["nulls"]["by_null"][n].items() if k != ZERO_GRAD):.3e}'  # noqa: E501
            for n in a[0]['nulls']['by_null'])
        depth = (f'{layers} + {layers} of {get_config_layers(arch)}'
                 if cfg.family == 'encdec'
                 else f'{layers} of {get_config_layers(arch)}')
        print(f'  (a) {arch} at {depth} layers, f32 (TF32 '
              f'{a[0]["tf32"]}), mesh {FM_SHAPE}, B={FM_B}, S={FM_S}, '
              f'{FM_MICRO} microbatches, a loss mask: loss '
              f'{res[0]["loss"]:.7f} vs meshless {ref["loss"]:.7f} (rel '
              f'{loss_rel:.3e}, gate {MT_TOL:g}), grad_norm '
              f'{res[0]["grad_norm"]:.6f} vs {ref["grad_norm"]:.6f} (rel '
              f'{norm_rel:.3e}, gate {n_gate:.3e}); worst gradient leaf '
              f'{grads:.3e} of its max ({g_leaf}: {g_ratio:.3f} of its '
              f'gate max({MT_TOL:g}, {FM_NULL:g} x the leaf\'s null)); the '
              f'meshless step\'s nulls, worst leaf: {nulls}; worst update '
              f'{update:.3e} of the meshless update\'s norm ({u_leaf}; gate '
              f'{FM_UPDATE_TOL:g}, an unchanged block reads 1; the nulls\' '
              f'worst {u_null:.3e}); {len(res[0]["split"])} of '
              f'{len(res[0]["leaf_grads"])} leaves split  [{card}]')
        gate(all(x['loss'] == res[0]['loss'] and
                 x['grad_norm'] == res[0]['grad_norm'] for x in res),
             (arch, 'ranks differ'))
        gate(loss_rel <= MT_TOL and norm_rel <= n_gate,
             (arch, 'loss', loss_rel, norm_rel))
        gate(g_ratio <= 1.0, (arch, 'grads', g_leaf, g_ratio))
        gate(update <= FM_UPDATE_TOL, (arch, 'update', u_leaf, update))
        if ZERO_GRAD in ref['grad_max']:
            stack = max(v for k, v in ref['grad_max'].items()
                        if k.startswith('dec_layers/'))
            zeros = [ref['grad_max'][ZERO_GRAD] / stack] + [
                x['grad_max'][ZERO_GRAD] / stack for x in res]
            print(f'  (a) {arch}: {ZERO_GRAD} (softmax ignores it) '
                  f'meshless and mesh max |g| {zeros[0]:.3e} / '
                  f'{max(zeros[1:]):.3e} of the decoder stack\'s max |g| '
                  f'(gate {MT_TOL:g})  [{card}]')
            gate(max(zeros) <= MT_TOL, (arch, ZERO_GRAD, zeros))
        b = [r[arch]['bf16'] for r in ranks]
        m0, m1 = b[0]['meshless'], [r['mesh'] for r in b]
        ms = lambda xs: [round(x * 1e3, 1) for x in xs]  # noqa: E731
        print(f'  (b) {arch} bf16, B={FM_B}, S={FM_BF16_S}: meshless '
              f'losses {[round(x, 4) for x in m0["losses"]]}, step times '
              f'{ms(m0["seconds"])} ms, peak {m0["peak"] / 1e9:.2f} GB; '
              f'mesh {FM_SHAPE} losses '
              f'{[round(x, 4) for x in m1[0]["losses"]]}, step times '
              f'{ms(m1[0]["seconds"])} ms (host clock, synchronized; two '
              f'ranks time-slice one card, gloo through host memory: '
              f'recorded, not a claim), peak rank 0 '
              f'{m1[0]["peak"] / 1e9:.2f} GB, rank 1 '
              f'{m1[1]["peak"] / 1e9:.2f} GB; the family '
              f'{ranks[0][arch]["seconds"]:.1f} s  [{card}]')
        gate(m1[1]['losses'] == m1[0]['losses'], (arch, 'bf16 ranks differ'))
        losses = np.array(m1[0]['losses'] + m0['losses'])
        gate(np.isfinite(losses).all() and np.allclose(
            m1[0]['losses'], m0['losses'], rtol=RESTART_TOL,
            atol=RESTART_TOL), (arch, 'bf16 losses', losses))
    launches = dict(LAUNCHES)
    for r in ranks:
        for k, v in r['launches'].items():
            launches[k] += v
    print(f'  hand-written kernel launches in the phase (every rank): '
          f'{launches}')
    assert not failed, failed
    assert not any(launches.values()), launches
    return launches


# ---------------------------------------------------------------------------
# Phase 20: the serve step over the region KV layout; the dry-run's records
# ---------------------------------------------------------------------------

SERVE_ARCH = 'qwen3-0.6b'
SERVE_B, SERVE_PROMPT, SERVE_MAX = 4, 1024, 2048   # rows, prompt, cache
SERVE_DECODE = 16                  # greedy decode steps after the prefill
# (c), on (16, 16); the decode cell also measured: one rank's blocks on
# the card (the meshless cell's 485 GB region cache would not fit)
SERVE_CELLS = ('decode_32k', 'train_4k')
SERVE_MEASURED = 'decode_32k'
SERVE_TIMEOUT_S = 300              # bounds each dry-run child process


def serve_shapes():
    """(the prefill's, the decode's) execution shapes of (a) and (b)."""
    from repro_torch.configs.base import ShapeConfig

    return (ShapeConfig('prefill_1k_b4', SERVE_PROMPT, SERVE_B, 'prefill'),
            ShapeConfig('decode_2k_b4', SERVE_MAX, SERVE_B, 'decode'))


def layouts_identity(model, params, dtype) -> dict:
    """Phase 20 (a) in one dtype: ``make_serve_step``'s prefill and
    SERVE_DECODE greedy decode steps over a region cache, and the same
    calls on a global pool whose pages [b R, (b+1) R) are row b's region
    slots, in order.  -> the steps' largest score difference, whether the
    tokens were equal, and whether the pools hold the same bits."""
    from repro_torch.training.train_step import make_serve_step

    pre, dec = serve_shapes()
    pg = model.cfg.page_size
    region = model.init_cache(dec, device=DEV, dtype=dtype)
    r = region['k'].shape[2]
    pool = model.init_cache(engine_pages=SERVE_B * r, device=DEV,
                            dtype=dtype)
    base = torch.arange(SERVE_B, device=DEV, dtype=torch.int32)[:, None] * r
    local = torch.arange(1, SERVE_MAX // pg + 1, device=DEV,
                         dtype=torch.int32).expand(SERVE_B, -1)
    prompt_pages = SERVE_PROMPT // pg
    prefill, _ = make_serve_step(model, None, pre)
    decode, _ = make_serve_step(model, None, dec)
    tokens = torch.tensor(np.random.default_rng(20).integers(
        1, model.cfg.vocab_size, (SERVE_B, SERVE_PROMPT)),
        dtype=torch.int32, device=DEV)
    worst, same_tokens, steps = 0.0, True, 0
    with torch.no_grad():
        a = prefill(params, region, {'tokens': tokens,
                                     'page_table': local[:, :prompt_pages]})[1]
        b = model.prefill_fn(params, pool, {
            'tokens': tokens,
            'page_table': (base + local)[:, :prompt_pages]})[1]
        for i in range(SERVE_DECODE + 1):
            worst = max(worst, float((a - b).abs().max()))
            tok = a.argmax(-1).to(torch.int32)
            same_tokens &= bool(torch.equal(tok, b.argmax(-1).to(torch.int32)))
            steps += 1
            if i == SERVE_DECODE:
                break
            pos = torch.full((SERVE_B,), SERVE_PROMPT + i, dtype=torch.int32,
                             device=DEV)
            a = decode(params, region, {'tokens': tok, 'positions': pos,
                                        'page_table': local})[1]
            b = model.decode_fn(params, pool, {'tokens': tok, 'positions': pos,
                                               'page_table': base + local})[1]
    torch.cuda.synchronize()
    pools_equal = all(
        torch.equal(region[k][:, row], pool[k][:, row * r:(row + 1) * r])
        for k in ('k', 'v') for row in range(SERVE_B))
    return {'worst': worst, 'tokens_equal': same_tokens, 'steps': steps,
            'pools_equal': pools_equal, 'slots': r}


def dryrun_child(shape: str, measure: bool = False) -> subprocess.Popen:
    """``python -m repro_torch.launch.dryrun`` for SERVE_ARCH x ``shape`` on
    the (16, 16) mesh, a child process (its fake process group stays
    there); with ``measure``, the counted rank's step also run on the
    card."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / 'src'))
    return subprocess.Popen(
        [sys.executable, '-m', 'repro_torch.launch.dryrun', '--arch',
         SERVE_ARCH, '--shape', shape, '--mesh', 'single',
         *(['--measure'] if measure else [])],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=str(ROOT))


def serve_step_check(card: str) -> dict:
    """Phase 20: (a) the region layout against the engine's global layout,
    bit for bit, in f32 and bf16; (b) ``run_cell`` of (a)'s prefill and
    decode measured on the card; (c) two production records of the
    shape-only count, the decode cell's counted rank also measured on the
    card (after (b), so that neither times the other's work).  Returns the phase's hand-written kernel launches
    (none: the serve step runs the plain paths, as the reference's)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.models.api import build_model

    gc.collect()
    torch.cuda.empty_cache()
    children = {s: dryrun_child(s) for s in SERVE_CELLS
                if s != SERVE_MEASURED}
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    model = build_model(get_config(SERVE_ARCH))
    params = model.init_params(0, device=DEV)
    results = {}
    for name, dtype, p in (('f32', torch.float32, f32_params(params, DEV)),
                           ('bf16', torch.bfloat16, params)):
        t0 = time.perf_counter()
        res = results[name] = layouts_identity(model, p, dtype)
        del p
        print(f'  (a) {SERVE_ARCH} {name}, make_serve_step meshless: prefill '
              f'B={SERVE_B} x {SERVE_PROMPT} tokens into a region cache of '
              f'{res["slots"]} slots a row (sized for {SERVE_MAX}), '
              f'{SERVE_DECODE} greedy decode steps, against the global pool '
              f'holding the same pages in order: {res["steps"]} score '
              f'blocks, largest |region - global| {res["worst"]:.3e}, tokens '
              f'equal {res["tokens_equal"]}, pools bit-equal '
              f'{res["pools_equal"]} ({time.perf_counter() - t0:.1f} s)  '
              f'[{card}]')
    del params
    gc.collect()
    torch.cuda.empty_cache()
    records = {}
    for shape in serve_shapes():
        rec = records[shape.kind] = run_cell(SERVE_ARCH, shape, 'none',
                                             measure=True, device=DEV)
        print(f'  (b) record: {json.dumps(rec)}')
        roof = rec['roofline']
        bound_ms = max(roof['compute_s'], roof['memory_s']) * 1e3
        ms = rec['measured']['step_ms']
        hbm = rec['hbm']
        counted = hbm['argument'] + hbm['output'] + hbm['temp']
        print(f'  (b) {SERVE_ARCH} {shape.kind} B={SERVE_B}, S='
              f'{shape.seq_len}, bf16, meshless: {ms:.3f} ms a step (median '
              f'of {rec["measured"]["reps"]}, CUDA events) against the '
              f'count\'s max(compute, memory) {bound_ms:.3f} ms ('
              f'{roof["dominant"]}-bound; {bound_ms / ms:.3f} of it); peak '
              f'memory {rec["measured"]["peak_bytes"] / 1e9:.3f} GB against '
              f'argument + output + temp {counted / 1e9:.3f} GB (argument '
              f'{hbm["argument"] / 1e9:.3f}, output {hbm["output"] / 1e9:.3f}'
              f', of it aliased {hbm["alias"] / 1e9:.3f}, temp '
              f'{hbm["temp"] / 1e9:.3f})  [{card}]')
    launches = dict(LAUNCHES)
    children[SERVE_MEASURED] = dryrun_child(SERVE_MEASURED, measure=True)
    prod = {}
    for shape, child in children.items():
        out, err = child.communicate(timeout=SERVE_TIMEOUT_S)
        if child.returncode:
            raise RuntimeError(f'dryrun {shape}: exit {child.returncode}: '
                               f'{err[-2000:]}')
        rec = prod[shape] = json.loads(out.strip().splitlines()[-1])
        print_production(rec, card)
    print(f'  hand-written kernel launches in the phase: {launches}')
    for name, res in results.items():
        assert res['worst'] == 0.0 and res['tokens_equal'], (name, res)
        assert res['pools_equal'], (name, res)
    for rec in records.values():
        assert rec['status'] == 'ok' and rec['measured']['step_ms'] > 0, rec
    assert prod[SERVE_MEASURED]['measured']['step_ms'] > 0, prod
    for shape, rec in prod.items():
        assert rec['status'] == 'ok', (shape, rec)
        assert rec['flops_per_device'] * rec['chips'] >= \
            0.95 * rec['model_flops'] or rec['kind'] == 'decode', rec
    assert not any(launches.values()), launches
    return launches


# ---------------------------------------------------------------------------
# Phase 21: the serve step on a mesh for rwkv6, zamba2 and seamless;
# long_500k's sequence-parallel decode; K6 over a rank's heads
# ---------------------------------------------------------------------------

FS_SHAPE = (1, 2)                  # (a), (b): (data, model), 2 gloo ranks
FS_B, FS_S, FS_DECODE = 4, 512, 4  # (a): rows, prompt (seamless: frames,
                                   # its decoder prefix FS_S / 8), steps
FS_LONG_SHAPE = (2, 1)             # (a) long_500k: the KV sequence over data
FS_LONG_S = 16384                  # its slots; 2 blocks of 8192
FS_LONG_POS0 = 8190                # 4 steps across the blocks' boundary
FS_TOL = 1e-4                      # f32: scores of |max|
FS_BF16_RATIO = 1.4                # bf16: the median row's error against
                                   # the f32 step, of the meshless bf16's
                                   # (correct steps 0.94-1.04, zamba2's
                                   # planted fault 1.72 on the H100)
FS_K6_T = 2048                     # (b): the prompt K6 carries
FS_CELLS = (('zamba2-2.7b', 'long_500k'), ('rwkv6-3b', 'decode_32k'))
FS_TIMEOUT_S = 300                 # bounds the spawned ranks


def serve_batches(cfg, b: int, s: int, steps: int, seed: int):
    """(prefill batch, decode batches), numpy: every row its own region
    (the region layout) or, for encdec's one pool, its own pages; fixed
    decode tokens."""
    rng = np.random.default_rng(seed)
    pg = cfg.page_size
    if cfg.family == 'encdec':
        s_dec = s // 8
        # the prefix's pages, then the decode steps' (a prefix shorter
        # than a page shares its page with them)
        per_row, prefix = -(-(s_dec + steps) // pg), -(-s_dec // pg)
        table = (1 + np.arange(b * per_row, dtype=np.int32)).reshape(
            b, per_row)
        pre = {'frames': (rng.normal(size=(b, s, cfg.d_model)) * 0.02)
               .astype(np.float32),
               'tokens': rng.integers(1, cfg.vocab_size, (b, s_dec))
               .astype(np.int32),
               'page_table': table[:, :prefix].copy()}
        pos0 = s_dec
    else:
        table = np.broadcast_to(np.arange(1, s // pg + 2, dtype=np.int32),
                                (b, s // pg + 1)).copy()
        pre = {'tokens': rng.integers(1, cfg.vocab_size, (b, s))
               .astype(np.int32)}
        if cfg.family != 'ssm':
            pre['page_table'] = table[:, :-1].copy()
        pos0 = s
    out = []
    for i in range(steps):
        step = {'tokens': rng.integers(1, cfg.vocab_size, b).astype(np.int32),
                'positions': np.full((b,), pos0 + i, np.int32)}
        if cfg.family != 'ssm':
            step['page_table'] = table
        out.append(step)
    return pre, out


def on_device(batch, dtype=None):
    """A numpy batch as tensors on DEV (float leaves in ``dtype``)."""
    return {k: torch.tensor(v, device=DEV, dtype=dtype if v.dtype.kind == 'f'
                            else None) for k, v in batch.items()}


def timed_calls(calls):
    """Run ``calls`` ([(step, params, cache, batch)]), each synchronized:
    -> (each call's scores, each call's seconds)."""
    scores, secs = [], []
    with torch.no_grad():
        for step, params, cache, batch in calls:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scores.append(step(params, cache, batch)[1])
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
    return scores, secs


def full_scores(plan, block):
    """A rank's block of the scores -> every row and column, gathered over
    ``model`` (vocabulary) and the batch axes (rows), on every rank."""
    from repro_torch.distributed.tp import TensorParallel

    return TensorParallel.gather_rows(plan, TensorParallel.gather_vocab(
        plan, block))


def score_gaps(mesh_scores, meshless) -> dict:
    """Each call's max |mesh - meshless| of the meshless |max|, whether its
    argmax rows are equal, and whether each differing row is a near tie of
    the meshless scores."""
    gaps, equal, ties = [], [], []
    for m, r in zip(mesh_scores, meshless):
        gaps.append(((m - r).abs().max() / r.abs().max()).item())
        a, b = m.argmax(-1).tolist(), r.argmax(-1).tolist()
        equal.append(a == b)
        ties.append(all(x == y or near_tie(r[i], x, y)
                        for i, (x, y) in enumerate(zip(a, b))))
    return {'gaps': gaps, 'equal': equal, 'ties': ties}


def row_errors(scores, exact) -> list:
    """Each row's max |scores - exact| of the row's |max| in ``exact``,
    over every call's rows in order."""
    return [e for x, t in zip(scores, exact)
            for e in ((x.float() - t).abs().amax(-1)
                      / t.abs().amax(-1)).tolist()]


def flips(scores, exact, rtol: float) -> list:
    """(call, row) of every row whose argmax differs from ``exact``'s and
    is not a near tie there at ``rtol`` of |max|."""
    out = []
    for c, (x, t) in enumerate(zip(scores, exact)):
        for r, (a, b) in enumerate(zip(x.argmax(-1).tolist(),
                                       t.argmax(-1).tolist())):
            if a != b and not near_tie(t[r], a, b, rtol):
                out.append((c, r))
    return out


class ReduceTap:
    """Counts the ``reduce_sum`` calls of a serve step's plan a call, and
    with ``skip`` leaves that one unreduced on this rank -- each rank keeps
    its own partial, as a row-parallel product whose reduce was left out
    would: the planted fault that phase 21's bf16 gate must reject."""

    def __init__(self, plan):
        self.plan, self.orig = plan, plan.reduce_sum
        self.n, self.skip = 0, None
        plan.reduce_sum = self

    def __call__(self, part, dtype):
        i, self.n = self.n, self.n + 1
        if i == self.skip:
            return part.to(dtype)
        return self.orig(part, dtype)

    def close(self):
        del self.plan.reduce_sum


def family_serve(cfg, mesh, dev: str) -> dict:
    """(a) for one family on a mesh of two ranks sharing the card: a
    prefill and FS_DECODE decode steps of ``make_serve_step`` over this
    rank's blocks, in f32 and bf16; rank 0 also runs the meshless step and
    holds the scores gathered from both ranks to it.  In bf16 each row's
    error is also taken against the meshless f32 step's scores (the
    function), for the mesh step, the meshless bf16 step and the mesh step
    with a planted fault: the last row-parallel product of every call left
    unreduced on both ranks (:class:`ReduceTap`)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.api import build_model
    from repro_torch.training.train_step import make_serve_step
    from repro_torch.training.tree import leaves_with_paths

    model = build_model(cfg)
    shapes = (ShapeConfig('prefill', FS_S, FS_B, 'prefill'),
              ShapeConfig('decode', FS_S, FS_B, 'decode'))
    steps = [make_serve_step(model, mesh, s)[0] for s in shapes]
    whole = [make_serve_step(model, None, s)[0] for s in shapes]
    plan = steps[0].plan
    taps = [ReduceTap(s.plan) for s in steps]
    host_pre, host_steps = serve_batches(cfg, FS_B, FS_S, FS_DECODE, 21)
    drawn = model.init_params(0, device=dev)
    out, exact = {'cache': None}, None

    def mesh_calls(blocks, batches, dtype, skips):
        cache = plan.shard_cache(model.init_cache(shapes[0], device=dev,
                                                  dtype=dtype))
        counts = []

        def tapped(i):
            step, tap = steps[min(i, 1)], taps[min(i, 1)]

            def run(*args):
                tap.n, tap.skip = 0, skips[i]
                try:
                    return step(*args)
                finally:
                    counts.append(tap.n)
                    tap.skip = None
            return run
        got, secs = timed_calls(
            [(tapped(i), blocks, cache, plan.shard_batch(b))
             for i, b in enumerate(batches)])
        return [full_scores(plan, g) for g in got], secs, counts, cache

    for name, dtype in (('f32', torch.float32), ('bf16', torch.bfloat16)):
        params = f32_params(drawn, dev) if dtype == torch.float32 else drawn
        blocks = plan.shard_params(params)
        batches = [on_device(host_pre, dtype)] + [on_device(b)
                                                  for b in host_steps]
        none = [None] * len(batches)
        got, secs, counts, cache = mesh_calls(blocks, batches, dtype, none)
        out['cache'] = {k: tuple(v.shape)
                        for k, v in leaves_with_paths(cache)}
        res = {'mesh_s': secs}
        if mesh.rank == 0:
            cache = model.init_cache(shapes[0], device=dev, dtype=dtype)
            want, res['meshless_s'] = timed_calls(
                [(whole[min(i, 1)], params, cache, b)
                 for i, b in enumerate(batches)])
            res.update(score_gaps(got, want))
            if dtype == torch.float32:
                exact = want
            else:
                res['rows'] = {'mesh': row_errors(got, exact),
                               'meshless': row_errors(want, exact)}
                noise = 2 * max(res['rows']['meshless'])
                res['flips'] = {'mesh': flips(got, exact, noise),
                                'meshless': flips(want, exact, noise),
                                'rtol': noise}
        if dtype == torch.bfloat16:
            faulty = mesh_calls(blocks, batches, dtype,
                                [n - 1 for n in counts])[0]
            res['reduces'] = counts
            if mesh.rank == 0:
                res['rows']['fault'] = row_errors(faulty, exact)
            del faulty
        out[name] = res
        del params, blocks, cache, got
        gc.collect()
        torch.cuda.empty_cache()
    for tap in taps:
        tap.close()
    return out


def long_serve(cfg, mesh, dev: str) -> dict:
    """(a) long_500k: zamba2 on (data 2, model 1), f32, from a seeded
    random cache of FS_LONG_S slots (the KV sequence in two blocks, one a
    rank), 4 decode steps across the blocks' boundary; every rank's
    scores, and rank 0's against the meshless step."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.api import build_model
    from repro_torch.training.train_step import make_serve_step
    from repro_torch.training.tree import leaves_with_paths

    model = build_model(cfg)
    shape = ShapeConfig('long_500k', FS_LONG_S, 1, 'decode')
    step, _ = make_serve_step(model, mesh, shape)
    plan = step.plan
    params = f32_params(model.init_params(0, device=dev), dev)
    gen = torch.Generator(device=dev).manual_seed(22)
    cache = model.init_cache(shape, device=dev, dtype=torch.float32)
    for _, leaf in leaves_with_paths(cache):
        leaf.normal_(generator=gen).mul_(0.5)
    mine = plan.shard_cache(cache)
    rng = np.random.default_rng(23)
    batches = [on_device({'tokens': rng.integers(1, cfg.vocab_size, 1)
                          .astype(np.int32),
                          'positions': np.full((1,), FS_LONG_POS0 + i,
                                               np.int32)})
               for i in range(4)]
    got, secs = timed_calls([(step, plan.shard_params(params), mine, b)
                             for b in batches])
    out = {'seq': plan.seq, 'rows': (plan.rows.start, plan.rows.stop),
           'mesh_s': secs,
           'kv_block': tuple(mine['attn']['k'].shape),
           'scores': [g.cpu().numpy() for g in got]}
    if mesh.rank == 0:
        whole, _ = make_serve_step(model, None, shape)
        want, out['meshless_s'] = timed_calls([(whole, params, cache, b)
                                               for b in batches])
        out.update(score_gaps(got, want))
    return out


def k6_rank_check(cfg, mesh, dev: str) -> dict:
    """(b): rwkv6's ``prefill_fn(use_kernel=True, tp=)`` -- K6 over this
    rank's wkv heads -- against this rank's plain prefill and the plain
    prefill at chunk 64 (the null), B=FS_B, T=FS_K6_T, in bf16 and f32;
    the kernel's launches."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.tp import StepParallel
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.models.api import build_model

    model = build_model(cfg)
    shape = ShapeConfig('prefill', FS_K6_T, FS_B, 'prefill')
    plan = StepParallel(cfg, mesh, batch=FS_B, seq_len=FS_K6_T)
    batch = {'tokens': torch.tensor(np.random.default_rng(24).integers(
        0, cfg.vocab_size, (FS_B, FS_K6_T)), device=dev)}
    drawn = model.init_params(0, device=dev)
    out = {'heads': (plan.wkv[1] - plan.wkv[0]) // cfg.ssm_head_dim,
           'of': cfg.d_model // cfg.ssm_head_dim}

    def rel(a, b) -> float:
        return ((a - b).abs().max() / b.abs().max()).item()

    for name, dtype in (('bf16', torch.bfloat16), ('f32', torch.float32)):
        params = plan.shard_params(
            f32_params(drawn, dev) if dtype == torch.float32 else drawn)

        def run(use_kernel):
            cache = plan.shard_cache(model.init_cache(shape, device=dev,
                                                      dtype=dtype))
            with torch.no_grad():
                cache, scores = model.prefill_fn(params, cache, batch,
                                                 use_kernel=use_kernel,
                                                 tp=plan)
            return scores, cache['wkv']

        before = LAUNCHES['wkv6']
        kern = run(True)
        out.setdefault('launches', 0)
        out['launches'] += LAUNCHES['wkv6'] - before
        plain = run(False)
        with plain_wkv_chunk(64):
            null = run(False)
        rows = [(((kern[0][r] - plain[0][r]).abs().max()
                  / plain[0][r].abs().max()).item(),
                 ((null[0][r] - plain[0][r]).abs().max()
                  / plain[0][r].abs().max()).item())
                for r in range(FS_B)]
        out[name] = {'rows': rows, 'scores': (rel(kern[0], plain[0]),
                                              rel(null[0], plain[0])),
                     'states': [(rel(k, p), rel(n, p)) for k, p, n in
                                zip(kern[1], plain[1], null[1])]}
        del params, kern, plain, null
    return out


def family_serve_rank(rank: int, cuts, dev: str) -> dict:
    """Phase 21 on one of two ranks sharing the card: (a) each family's
    serve step over (1, 2), (b) K6 over this rank's heads, (a) zamba2's
    long_500k over (2, 1); the hand-written kernel launches of (a)'s
    steps and (b)'s."""
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.launch.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    LAUNCHES.update(dict.fromkeys(LAUNCHES, 0))
    mesh = make_mesh(FS_SHAPE, MESH_AXES, device=dev)
    out = {'backend': str(torch.distributed.get_backend())}
    for arch, cfg in cuts:
        t0 = time.perf_counter()
        out[arch] = family_serve(cfg, mesh, dev)
        out[arch]['seconds'] = time.perf_counter() - t0
    rwkv = dict(cuts)['rwkv6-3b']
    out['k6'] = k6_rank_check(rwkv, mesh, dev)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    long_mesh = make_mesh(FS_LONG_SHAPE, MESH_AXES, device=dev)
    out['long'] = long_serve(dict(cuts)['zamba2-2.7b'], long_mesh, dev)
    out['long']['seconds'] = time.perf_counter() - t0
    out['launches'] = dict(LAUNCHES)
    return out


def family_serve_check(card: str) -> dict:
    """Phase 21: (a) rwkv6, zamba2 and seamless at published widths, depth
    cut as phase 19, served by ``make_serve_step`` on (1, 2) by two ranks
    sharing the card: a prefill and FS_DECODE decode steps against the
    meshless step on the card -- f32 scores within FS_TOL of |max| and
    argmax equal; bf16 held to the meshless f32 step (the function): the
    median row's error within FS_BF16_RATIO x the meshless bf16 step's, a
    planted fault (``family_serve``) beyond that bound, and no argmax off
    the f32 step's but a near tie at twice the meshless bf16 step's largest
    row error -- with the steps' times;
    zamba2 at long_500k on (2, 1), the KV sequence split over data, f32,
    the same gate and the two replicas bit-equal; (b) K6 over each rank's
    wkv heads against the rank's plain prefill (phase 8's gates); (c)
    ``run_cell`` of FS_CELLS on the (16, 16) layout at full depth,
    measured on the card (rank 0's step, collectives not run).  Returns
    the phase's launches: K6's from (b), none of K1-K5."""
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.launch.dryrun import run_cell

    gc.collect()
    torch.cuda.empty_cache()
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    cuts = [(arch, family_cut(arch, layers)) for arch, layers in FM_FAMILIES]
    t0 = time.perf_counter()
    ranks = on_ranks(family_serve_rank, 2, (cuts, DEV), FS_TIMEOUT_S)
    print(f'  two ranks on the card ({ranks[0]["backend"]}): '
          f'{time.perf_counter() - t0:.1f} s  [{card}]')
    failed = []

    def gate(ok, what):
        if not ok:
            failed.append(what)

    ms = lambda xs: [round(x * 1e3, 2) for x in xs]  # noqa: E731
    for (arch, layers), (_, cfg) in zip(FM_FAMILIES, cuts):
        r0 = ranks[0][arch]
        depth = (f'{layers} + {layers} of {get_config_layers(arch)}'
                 if cfg.family == 'encdec'
                 else f'{layers} of {get_config_layers(arch)}')
        for name in ('f32', 'bf16'):
            res = r0[name]
            print(f'  (a) {arch} at {depth} layers, {name}, mesh {FS_SHAPE}, '
                  f'B={FS_B}, S={FS_S}: prefill + {FS_DECODE} decode steps, '
                  f'|mesh - meshless| of |max| '
                  f'{[f"{g:.3e}" for g in res["gaps"]]}, argmax equal '
                  f'{res["equal"]}, else a near tie {res["ties"]}; mesh '
                  f'step ms {ms(res["mesh_s"])} (rank 1 '
                  f'{ms(ranks[1][arch][name]["mesh_s"])}), meshless '
                  f'{ms(res["meshless_s"])} (host clock, synchronized; two '
                  f'ranks time-slice one card, gloo through host memory: '
                  f'recorded, not a claim)  [{card}]')
            if name == 'f32':
                gate(max(res['gaps']) <= FS_TOL and all(res['equal']),
                     (arch, name, res['gaps'], res['equal']))
                continue
            rows = res['rows']
            med = {k: statistics.median(v) for k, v in rows.items()}
            print(f'  (a) {arch} bf16 against the meshless f32 step (the '
                  f'function), each row\'s |x - f32| of its |max| over the '
                  f'{len(rows["mesh"])} rows of the 5 calls, median / max: '
                  + ', '.join(f'{k} {med[k]:.3e} / {max(v):.3e}'
                              for k, v in rows.items())
                  + f' (fault: the last of each call\'s {res["reduces"]} '
                  f'row-parallel reduces left out on both ranks); gate: '
                  f'mesh median <= {FS_BF16_RATIO:g} x the meshless bf16 '
                  f'median, the fault above it; argmax off f32 and not a '
                  f'near tie at {res["flips"]["rtol"]:.3e} (2 x the meshless '
                  f'bf16 step\'s largest row error): mesh '
                  f'{res["flips"]["mesh"]}, meshless bf16 '
                  f'{res["flips"]["meshless"]}  [{card}]')
            bound = FS_BF16_RATIO * med['meshless']
            gate(med['mesh'] <= bound, (arch, name, 'rows', med))
            gate(med['fault'] > bound, (arch, name, 'fault passes', med))
            gate(not res['flips']['mesh'], (arch, name, res['flips']))
        print(f'  (a) {arch} cache blocks, rank 0: {r0["cache"]}; rank 1: '
              f'{ranks[1][arch]["cache"]}; the family '
              f'{r0["seconds"]:.1f} s')
    lg = [r['long'] for r in ranks]
    same = all(np.array_equal(a, b) for a, b in zip(lg[0]['scores'],
                                                    lg[1]['scores']))
    layers = dict(FM_FAMILIES)['zamba2-2.7b']
    print(f'  (a) zamba2-2.7b at {layers} of '
          f'{get_config_layers("zamba2-2.7b")} layers, long_500k, f32, mesh '
          f'{FS_LONG_SHAPE}: {FS_LONG_S} slots in blocks {lg[0]["seq"]} and '
          f'{lg[1]["seq"]} (rank KV block {lg[0]["kv_block"]}), rows '
          f'{lg[0]["rows"]} on both, 4 steps from position {FS_LONG_POS0}: '
          f'|mesh - meshless| of |max| '
          f'{[f"{g:.3e}" for g in lg[0]["gaps"]]}, argmax equal '
          f'{lg[0]["equal"]}, the replicas bit-equal {same}; mesh step ms '
          f'{ms(lg[0]["mesh_s"])}, meshless {ms(lg[0]["meshless_s"])} '
          f'({lg[0]["seconds"]:.1f} s)  [{card}]')
    gate(max(lg[0]['gaps']) <= FS_TOL and all(lg[0]['equal']) and same,
         ('long_500k', lg[0]['gaps'], lg[0]['equal'], same))
    k6_launches = 0
    for rank, r in enumerate(ranks):
        k6 = r['k6']
        k6_launches += k6['launches']
        f32 = k6['f32']
        null = max(n for _, n in f32['states'][1:] + [f32['scores']])
        worst = max(g for g, _ in f32['states'][1:] + [f32['scores']])
        bf = k6['bf16']['rows']
        print(f'  (b) rank {rank}: K6 over its {k6["heads"]} of {k6["of"]} wkv heads, '
              f'B={FS_B}, T={FS_K6_T}, {k6["launches"]} launches; f32 '
              f'|kernel - plain| of |max|: layer 0 state '
              f'{f32["states"][0][0]:.3e} (gate {FS_TOL:g}), deeper states '
              f'and scores {worst:.3e} (gate max({FS_TOL:g}, 2 x the null '
              f'{null:.3e})); bf16 rows {[f"{g:.3e}" for g, _ in bf]} '
              f'(nulls {[f"{n:.3e}" for _, n in bf]}, gate max('
              f'{PREFILL_TOL:g}, 2 x the null))  [{card}]')
        gate(f32['states'][0][0] <= FS_TOL, (rank, 'k6 layer 0', f32))
        gate(worst <= max(FS_TOL, 2 * null), (rank, 'k6 f32', f32))
        gate(all(g <= max(PREFILL_TOL, 2 * n) for g, n in bf),
             (rank, 'k6 bf16', bf))
        gate(k6['launches'] == 2 * dict(cuts)['rwkv6-3b'].n_layers,
             (rank, 'k6 launches', k6['launches']))
    launches = dict(LAUNCHES)
    for r in ranks:
        for k, v in r['launches'].items():
            launches[k] += v
    print(f'  hand-written kernel launches in the phase (every rank): '
          f'{launches}')
    del ranks
    gc.collect()
    torch.cuda.empty_cache()
    prod = {}
    for arch, shape in FS_CELLS:
        rec = prod[arch, shape] = run_cell(arch, shape, 'single',
                                           measure=True, device=DEV)
        print_production(rec, card)
        gate(rec['status'] == 'ok' and rec['measured']['step_ms'] > 0,
             (arch, shape, rec.get('status')))
    assert not failed, failed
    assert launches['wkv6'] == k6_launches, launches
    assert not any(v for k, v in launches.items() if k != 'wkv6'), launches
    return launches


def print_production(rec: dict, card: str) -> None:
    """Print a production record of the dry-run's count and, where it has
    one, its measured step against the count."""
    print(f'  (c) {rec["arch"]} x {rec["shape"]} x {rec["mesh"]}, shape-only '
          f'on the host: status {rec["status"]}, rank {rec.get("rank")}, '
          f'counted in {rec.get("trace_s", 0):.1f} s: flops a device '
          f'{rec.get("flops_per_device", 0):.4g}, bytes a device '
          f'{rec.get("bytes_per_device", 0):.4g}, hbm {rec.get("hbm")}, '
          f'collectives {rec.get("collectives")}, roofline '
          f'{rec.get("roofline")}, useful flops ratio '
          f'{rec.get("useful_flops_ratio", 0):.4f}')
    if 'measured' in rec:
        m, hbm, roof = rec['measured'], rec['hbm'], rec['roofline']
        counted = hbm['argument'] + hbm['output'] + hbm['temp']
        bound_ms = max(roof['compute_s'], roof['memory_s']) * 1e3
        print(f'  (c) {rec["shape"]} rank {rec["rank"]} measured on the card '
              f'(collectives not run): {m["step_ms"]:.3f} ms a step '
              f'(median of {m["reps"]}) against the count\'s max('
              f'compute, memory) {bound_ms:.3f} ms; peak memory '
              f'{m["peak_bytes"] / 1e9:.3f} GB against argument + output '
              f'+ temp {counted / 1e9:.3f} GB (argument, the rank\'s own '
              f'blocks, {hbm["argument"] / 1e9:.3f} GB; under the '
              f'reference\'s specs '
              f'{sum(rec["reference_arguments"].values()) / 1e9:.3f} GB)  '
              f'[{card}]')


def get_config_layers(arch: str) -> int:
    """The published depth of ``arch`` (an encoder-decoder's, each
    stack's)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return cfg.dec_layers if cfg.family == 'encdec' else cfg.n_layers


# ---------------------------------------------------------------------------
# Phase 22: the serve step under the rule variants serve_kv_dp, serve_seq
# and serve_dh
# ---------------------------------------------------------------------------

VS_VARIANTS = ('serve_kv_dp', 'serve_seq', 'serve_dh')
VS_FAMILIES = ((MESH_ARCH, MESH_F32_LAYERS),) + FM_FAMILIES
# rwkv6 holds no pool: its serve_seq plan is the default's, leaf for leaf
# (tests/test_torch_serve_variants.py), so phase 21 runs it
VS_SKIP = {('rwkv6-3b', 'serve_seq')}
# (b) each variant's planted fault, on qwen3 (as the CPU tests plant them)
VS_FAULTS = {'serve_dh': 'the partial scores not summed over model',
             'serve_seq': 'the last rank\'s (m, l, acc) dropped from the '
                          'combine',
             'serve_kv_dp': 'model rank 1 skipping the new token\'s write'}
VS_CELL = ('qwen3-0.6b', 'decode_32k')   # (c): rank 0 on (16, 16)


def plant_fault(variant: Optional[str], coords) -> callable:
    """Plant ``variant``'s fault (:data:`VS_FAULTS`) in this rank's serve
    step; -> a function that takes it out."""
    from repro_torch.distributed import tp as tplib
    from repro_torch.models import common as cm

    saved = [(o, n, getattr(o, n)) for o, n in (
        (tplib.StepParallel, 'score_sum'),
        (tplib.StepParallel, 'model_combine'), (cm, 'kv_write_token'))]
    if variant == 'serve_dh':
        tplib.StepParallel.score_sum = lambda self, scores: scores
    elif variant == 'serve_seq':
        def dropped(self, states):
            m, l, acc = (tplib._gather_stack(t, self.group, self.n)
                         for t in states)
            return cm.combine_partials(m[:-1], l[:-1], acc[:-1])
        tplib.StepParallel.model_combine = dropped
    elif variant == 'serve_kv_dp' and coords['model'] == 1:
        cm.kv_write_token = lambda *args, **kw: None

    def restore():
        for o, n, f in saved:
            setattr(o, n, f)
    return restore


def replicated_leaves(plan, model, shape) -> list:
    """The cache leaves whose block is the same on every ``model`` rank of
    ``plan``'s mesh (what its variant replicates over ``model``)."""
    from repro_torch.distributed.tp import StepParallel
    from repro_torch.training.tree import leaves_with_paths

    plans = [StepParallel(plan.cfg, plan.mesh, dict(plan.mesh.coords(),
                                                    model=r),
                          batch=shape.global_batch, seq_len=shape.seq_len,
                          rules=plan.rules)
             for r in range(plan.n)]
    return [k for k, s in leaves_with_paths(model.cache_shapes(shape))
            if len({p.cache_block(tuple(k.split('/')), s) for p in plans})
            == 1]


def replicas_equal(plan, cache, leaves) -> bool:
    """Whether every ``model`` replica of each of ``leaves`` holds the same
    bits: the elementwise max and min of its bits over ``model`` agree."""
    from repro_torch.training.tree import leaves_with_paths

    dist, ok = torch.distributed, True
    mine = dict(leaves_with_paths(cache))
    for leaf in leaves:
        t = mine[leaf]
        bits = (t.view(torch.int32) if t.element_size() == 4
                else t.view(torch.int16).to(torch.int32))
        hi, lo = bits.clone(), bits.clone()
        dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=plan.group)
        dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=plan.group)
        ok = ok and torch.equal(hi, lo)
    return ok


def variant_meshless(cfg, dev: str) -> dict:
    """The meshless step's scores and seconds in f32 and bf16 (rank 0's
    reference for every variant of ``cfg``)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.api import build_model
    from repro_torch.training.train_step import make_serve_step

    model = build_model(cfg)
    shapes = (ShapeConfig('prefill', FS_S, FS_B, 'prefill'),
              ShapeConfig('decode', FS_S, FS_B, 'decode'))
    whole = [make_serve_step(model, None, s)[0] for s in shapes]
    host_pre, host_steps = serve_batches(cfg, FS_B, FS_S, FS_DECODE, 21)
    drawn = model.init_params(0, device=dev)
    out = {}
    for name, dtype in (('f32', torch.float32), ('bf16', torch.bfloat16)):
        params = f32_params(drawn, dev) if dtype == torch.float32 else drawn
        batches = [on_device(host_pre, dtype)] + [on_device(b)
                                                  for b in host_steps]
        cache = model.init_cache(shapes[0], device=dev, dtype=dtype)
        out[name], out[name + '_s'] = timed_calls(
            [(whole[min(i, 1)], params, cache, b)
             for i, b in enumerate(batches)])
        del params, cache
    return out


def variant_serve(cfg, mesh, dev: str, variant: str, meshless,
                  fault: bool = False) -> dict:
    """(a) for one family under ``variant`` on a mesh of two ranks sharing
    the card: a prefill and FS_DECODE decode steps of ``make_serve_step``
    over this rank's blocks, in f32 and bf16 (``fault``: with the
    variant's planted fault); whether what the variant replicates over
    ``model`` is bit-equal on both ranks; on rank 0 the gathered scores
    against the meshless step (``meshless``, :func:`variant_meshless`)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import RULE_VARIANTS
    from repro_torch.models.api import build_model
    from repro_torch.training.train_step import make_serve_step
    from repro_torch.training.tree import leaves_with_paths

    model = build_model(cfg)
    rules = RULE_VARIANTS[variant]
    shapes = (ShapeConfig('prefill', FS_S, FS_B, 'prefill'),
              ShapeConfig('decode', FS_S, FS_B, 'decode'))
    steps = [make_serve_step(model, mesh, s, rules=rules)[0] for s in shapes]
    plan = steps[0].plan
    leaves = replicated_leaves(plan, model, shapes[0])
    host_pre, host_steps = serve_batches(cfg, FS_B, FS_S, FS_DECODE, 21)
    drawn = model.init_params(0, device=dev)
    out = {'replicated': leaves}
    for name, dtype in (('f32', torch.float32), ('bf16', torch.bfloat16)):
        params = f32_params(drawn, dev) if dtype == torch.float32 else drawn
        blocks = plan.shard_params(params)
        batches = [on_device(host_pre, dtype)] + [on_device(b)
                                                  for b in host_steps]
        cache = plan.shard_cache(model.init_cache(shapes[0], device=dev,
                                                  dtype=dtype))
        restore = plant_fault(variant if fault else None, mesh.coords())
        try:
            got, secs = timed_calls(
                [(steps[min(i, 1)], blocks, cache, plan.shard_batch(b))
                 for i, b in enumerate(batches)])
        finally:
            restore()
        got = [full_scores(plan, g) for g in got]
        res = {'mesh_s': secs, 'replicas': replicas_equal(plan, cache,
                                                          leaves),
               'cache': {k: tuple(v.shape)
                         for k, v in leaves_with_paths(cache)}}
        if mesh.rank == 0:
            res.update(score_gaps(got, meshless[name]))
            if dtype == torch.bfloat16:
                exact = meshless['f32']
                res['rows'] = {'mesh': row_errors(got, exact),
                               'meshless': row_errors(meshless['bf16'],
                                                      exact)}
                noise = 2 * max(res['rows']['meshless'])
                res['flips'] = {'mesh': flips(got, exact, noise),
                                'rtol': noise}
        out[name] = res
        del params, blocks, cache, got
        gc.collect()
        torch.cuda.empty_cache()
    return out


def variant_serve_rank(rank: int, cuts, dev: str) -> dict:
    """Phase 22 on one of two ranks sharing the card: each family under
    each variant (but :data:`VS_SKIP`), then qwen3 under each variant's
    planted fault; the hand-written kernel launches of the steps."""
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.launch.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    LAUNCHES.update(dict.fromkeys(LAUNCHES, 0))
    mesh = make_mesh(FS_SHAPE, MESH_AXES, device=dev)
    out = {}
    for arch, cfg in cuts:
        t0 = time.perf_counter()
        meshless = variant_meshless(cfg, dev) if rank == 0 else None
        for variant in VS_VARIANTS:
            if (arch, variant) not in VS_SKIP:
                out[arch, variant] = variant_serve(cfg, mesh, dev, variant,
                                                   meshless)
        if arch == MESH_ARCH:
            for variant in VS_VARIANTS:
                out[arch, variant, 'fault'] = variant_serve(
                    cfg, mesh, dev, variant, meshless, fault=True)
        out[arch] = {'seconds': time.perf_counter() - t0,
                     'meshless_s': meshless and (meshless['f32_s'],
                                                 meshless['bf16_s'])}
        del meshless
        gc.collect()
        torch.cuda.empty_cache()
    out['launches'] = dict(LAUNCHES)
    return out


def variant_serve_check(card: str) -> dict:
    """Phase 22: (a) qwen3-0.6b at MESH_F32_LAYERS of 28 layers and rwkv6,
    zamba2 and seamless at phase 19's depths, all at published widths,
    served by ``make_serve_step`` under ``serve_kv_dp``, ``serve_seq`` and
    ``serve_dh`` on (1, 2) by two ranks sharing the card: a prefill of
    FS_S tokens and FS_DECODE decode steps of FS_B rows against the
    meshless step on the card -- f32 within FS_TOL of |max|, argmax equal,
    and what the variant replicates over ``model`` bit-equal on both
    ranks; bf16 held to the meshless f32 step as phase 21 holds it (the
    median row's error within FS_BF16_RATIO x the meshless bf16 step's, no
    argmax off but a near tie) -- and each variant's planted fault on
    qwen3 (:data:`VS_FAULTS`), which must fail the f32 gate (and is shown
    against the bf16 one: (b)); (c) rank 0 of qwen3-0.6b decode_32k on the
    (16, 16) layout under each variant, counted and measured on the card
    (``run_cell(..., measure=True)``: collectives not run).  Returns the
    phase's launches (none: no kernel lies on this path)."""
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.launch.dryrun import run_cell

    gc.collect()
    torch.cuda.empty_cache()
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    cuts = [(arch, family_cut(arch, layers)) for arch, layers in VS_FAMILIES]
    t0 = time.perf_counter()
    ranks = on_ranks(variant_serve_rank, 2, (cuts, DEV), FS_TIMEOUT_S)
    print(f'  (a) two ranks on the card: {time.perf_counter() - t0:.1f} s  '
          f'[{card}]')
    failed = []

    def gate(ok, what):
        if not ok:
            failed.append(what)

    ms = lambda xs: [round(x * 1e3, 2) for x in xs]  # noqa: E731
    for arch, layers in VS_FAMILIES:
        r0 = ranks[0][arch]
        print(f'  (a) {arch} at {layers} of {get_config_layers(arch)} '
              f'layers: meshless step ms f32 {ms(r0["meshless_s"][0])}, bf16 '
              f'{ms(r0["meshless_s"][1])}; the family with its variants '
              f'{r0["seconds"]:.1f} s')
        for key in [k for k in ranks[0] if isinstance(k, tuple)
                    and k[0] == arch]:
            variant, fault = key[1], len(key) > 2
            res, res1 = ranks[0][key], ranks[1][key]
            f32, bf = res['f32'], res['bf16']
            med = {k: statistics.median(v) for k, v in bf['rows'].items()}
            bound = FS_BF16_RATIO * med['meshless']
            f32_ok = max(f32['gaps']) <= FS_TOL and all(f32['equal'])
            bf_ok = med['mesh'] <= bound and not bf['flips']['mesh']
            replicas = all(r[key][n]['replicas'] for r in ranks
                           for n in ('f32', 'bf16'))
            what = (f'planted fault ({VS_FAULTS[variant]})' if fault
                    else 'step')
            print(f'  ({"b" if fault else "a"}) {arch} {variant} {what}: f32 |mesh - meshless| of '
                  f'|max| {[f"{g:.3e}" for g in f32["gaps"]]}, argmax equal '
                  f'{f32["equal"]} (gate {FS_TOL:g}: '
                  f'{"pass" if f32_ok else "FAIL"}); bf16 rows against the '
                  f'meshless f32 step, median {med["mesh"]:.3e} against '
                  f'{FS_BF16_RATIO:g} x the meshless bf16 step\'s '
                  f'{med["meshless"]:.3e} = {bound:.3e}, argmax off and not '
                  f'a near tie {bf["flips"]["mesh"]} (gate: '
                  f'{"pass" if bf_ok else "FAIL"}); replicated over model '
                  f'{res["replicated"]} bit-equal {replicas}; mesh step ms '
                  f'f32 {ms(f32["mesh_s"])}, bf16 {ms(bf["mesh_s"])} (rank 1 '
                  f'{ms(res1["bf16"]["mesh_s"])}; host clock, two ranks '
                  f'time-slice the card)  [{card}]')
            if fault:
                gate(not f32_ok, (arch, variant, 'fault passes f32',
                                  f32['gaps']))
                continue
            print(f'  (a) {arch} {variant} cache blocks: rank 0 '
                  f'{res["f32"]["cache"]}, rank 1 {res1["f32"]["cache"]}')
            gate(f32_ok, (arch, variant, 'f32', f32['gaps'], f32['equal']))
            gate(bf_ok, (arch, variant, 'bf16', med, bf['flips']))
            gate(replicas, (arch, variant, 'replicas'))
    launches = dict(LAUNCHES)
    for r in ranks:
        for k, v in r['launches'].items():
            launches[k] += v
    print(f'  hand-written kernel launches in the phase (every rank): '
          f'{launches}')
    del ranks
    gc.collect()
    torch.cuda.empty_cache()
    for variant in VS_VARIANTS:
        t0 = time.perf_counter()
        rec = run_cell(*VS_CELL, 'single', rules_variant=variant,
                       measure=True, device=DEV)
        print(f'  (c) {VS_CELL[0]} x {VS_CELL[1]} under {variant} '
              f'({time.perf_counter() - t0:.1f} s): arguments '
              f'{rec.get("arguments")}, the reference\'s '
              f'{rec.get("reference_arguments")}, collectives counted '
              f'{rec.get("collectives", {}).get("bytes_by_kind")}')
        print_production(rec, card)
        gate(rec['status'] == 'ok' and rec['measured']['step_ms'] > 0
             and rec['arguments']['cache'] ==
             rec['reference_arguments']['cache'],
             (VS_CELL, variant, rec.get('status')))
    assert not failed, failed
    assert not any(launches.values()), launches
    return launches


# ---------------------------------------------------------------------------
# Phase 23: the trainer under the rule variants serve_dh, serve_kv_dp and
# serve_seq
# ---------------------------------------------------------------------------

# (arch, depth, variants): qwen3-0.6b at MT_LAYERS of 28 under each of the
# three, phase 19's families at its depths under serve_dh and serve_kv_dp
VT_RUNS = ((MESH_ARCH, MT_LAYERS, ('serve_dh', 'serve_kv_dp', 'serve_seq')),
           ) + tuple((arch, layers, ('serve_dh', 'serve_kv_dp'))
                     for arch, layers in FM_FAMILIES)
VT_TIMEOUT_S = 420                 # bounds the phase's spawned ranks
# one planted fault a variant, on one arch; each must fail its f32 gate
VT_FAULTS = {
    'serve_dh': (MESH_ARCH, 'the q/k norms\' head_dim gather with a '
                            'backward that sums over model (twice the '
                            'gradient: every rank runs attention whole)'),
    'serve_kv_dp': ('rwkv6-3b', 'u\'s gradient not summed over model (each '
                                'rank\'s heads only)'),
    'serve_seq': (MESH_ARCH, 'the _CopyToModel sums of the split products\' '
                             'inputs left out'),
}


def plant_train_fault(variant: str) -> callable:
    """Plant ``variant``'s fault (:data:`VT_FAULTS`) in this rank's
    trainer; -> a function that takes it out."""
    from repro_torch.distributed import tp as tplib

    cls = tplib.TensorParallel
    name = {'serve_dh': 'whole', 'serve_kv_dp': 'head_share',
            'serve_seq': 'copy'}[variant]
    saved = getattr(cls, name)
    if variant == 'serve_dh':
        cls.whole = lambda self, part: self.gather_shares(part)
    elif variant == 'serve_kv_dp':
        cls.head_share = lambda self, w: w
    else:
        cls.copy = lambda self, x, split=True: x

    def restore():
        setattr(cls, name, saved)
    return restore


def whole_digests(tree, plan) -> dict:
    """{path: sha256 of the bytes} of every leaf that this rank holds whole
    (replicated over ``model``)."""
    import hashlib

    from repro_torch.training import tree as tr

    return {k: hashlib.sha256(v.detach().cpu().numpy().tobytes()).hexdigest()
            for k, v in tr.leaves_with_paths(tree)
            if plan.param_blocks[k].is_whole()}


def variant_train(cfg, dev: str, variants, faults) -> dict:
    """Phase 23 for one config, on one of two ranks sharing the card: f32
    weights drawn on the card, the meshless step on each rank in turn and
    its nulls (``family_nulls``; phase 19's spread where it ran the config,
    :data:`NULL_SPREADS`), then one step at
    :data:`FM_SHAPE` under each of ``variants`` (``make_train_step(rules=
    )``) and under each of ``faults``' planted fault, each held leaf by
    leaf to the meshless step (:func:`leaf_errors`, :func:`update_shares`);
    the digests of what the rank holds whole; then FM_STEPS bf16 steps
    under each variant, timed, and the peak memory of each run."""
    from repro_torch.distributed.sharding import RULE_VARIANTS
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import build_model
    from repro_torch.training import optimizer as opt
    from repro_torch.training import tree as tr
    from repro_torch.training.train_step import (
        loss_and_grads, make_train_step, mesh_loss_and_grads, shard_batch)

    model = build_model(cfg)
    drawn = tr.tree_map(lambda x: x.detach().float(),
                        model.init_params(0, device=dev))
    host = masked_batch(cfg, FM_B, FM_S)
    # phase 19's spread of this config's meshless step, where it ran one
    kept = NULL_SPREADS.pop((cfg, FM_B, FM_S, FM_MICRO), None)
    for r in range(torch.distributed.get_world_size()):
        if r == torch.distributed.get_rank():
            batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
            params = f32_params(drawn, dev)
            _, grads = loss_and_grads(model, params, batch, FM_MICRO)
            step = make_train_step(model, microbatches=FM_MICRO)
            _, _, m0 = step(params, opt.init_opt_state(params), batch)
            grads = dict(tr.leaves_with_paths(grads))
            after = {k: v.detach() for k, v in tr.leaves_with_paths(params)}
            del params, step
            spread = kept or null_spread(model, drawn, batch, FM_MICRO,
                                         dev, grads, after, m0,
                                         family_nulls(cfg))
            del batch
            gc.collect()
            torch.cuda.empty_cache()
        torch.distributed.barrier()
    before = dict(tr.leaves_with_paths(drawn))
    delta = {k: v - before[k] for k, v in after.items()}
    del after
    out = {'tf32': torch.backends.cuda.matmul.allow_tf32, 'nulls': spread,
           'meshless': {'loss': float(m0['loss']),
                        'grad_norm': float(m0['grad_norm']),
                        'grad_max': {k: float(v.abs().max())
                                     for k, v in grads.items()}}}
    mesh = make_mesh(FM_SHAPE, MESH_AXES, device=dev)
    for variant, fault in ([(v, False) for v in variants]
                           + [(v, True) for v in faults]):
        restore = plant_train_fault(variant) if fault else (lambda: None)
        try:
            step = make_train_step(model, mesh, microbatches=FM_MICRO,
                                   rules=RULE_VARIANTS[variant])
            plan = step.plan
            p = plan.shard_params(drawn)
            rows = shard_batch(host, plan, FM_MICRO)
            _, g = mesh_loss_and_grads(model, plan, p, rows, FM_MICRO)
            p, _, m = step(p, plan.init_opt_state(), rows)
        finally:
            restore()
        blocks = lambda tree: {k: (v.detach(), plan.param_blocks[k])  # noqa
                               for k, v in tr.leaves_with_paths(tree)}
        res = {'loss': float(m['loss']), 'grad_norm': float(m['grad_norm']),
               'leaf_grads': leaf_errors(blocks(g), grads),
               'leaf_update': update_shares(blocks(p), before, delta),
               'grad_max': {k: float(v.abs().max())
                            for k, v in tr.leaves_with_paths(g)},
               'whole': [k for k, b in plan.param_blocks.items()
                         if b.is_whole()]}
        if not fault:
            res['digests'] = (whole_digests(g, plan), whole_digests(p, plan))
        out[variant, fault] = res
        del p, g, step, plan, rows
        gc.collect()
        torch.cuda.empty_cache()
    del grads, delta, drawn
    ocfg = opt.AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP)
    for variant in variants:
        torch.cuda.reset_peak_memory_stats()
        step = make_train_step(model, mesh, opt_cfg=ocfg,
                               rules=RULE_VARIANTS[variant])
        plan = step.plan
        params = plan.shard_params(model.init_params(0, device=dev))
        state = plan.init_opt_state()
        losses, seconds = [], []
        for s in range(FM_STEPS):
            rows = shard_batch(masked_batch(cfg, FM_B, FM_BF16_S, s), plan)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step(params, state, rows)
            losses.append(float(m['loss']))
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        out[variant, 'bf16'] = {'losses': losses, 'seconds': seconds,
                                'peak': torch.cuda.max_memory_allocated()}
        del params, state, step, plan
        gc.collect()
        torch.cuda.empty_cache()
    return out


def variant_train_rank(rank: int, runs, dev: str) -> dict:
    """Phase 23 on one of two ranks sharing the card: each config of
    ``runs`` ((arch, config, variants, faults)) in turn, its seconds, and
    the hand-written kernel launches (none: the trainer runs the plain
    paths)."""
    from repro_torch.kernels.common import LAUNCHES

    torch.backends.cuda.matmul.allow_tf32 = False
    LAUNCHES.update(dict.fromkeys(LAUNCHES, 0))
    out = {'backend': str(torch.distributed.get_backend())}
    for arch, cfg, variants, faults in runs:
        t0 = time.perf_counter()
        out[arch] = variant_train(cfg, dev, variants, faults)
        out[arch]['seconds'] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    NULL_SPREADS.clear()
    return dict(out, launches=dict(LAUNCHES))


def variant_train_check(card: str) -> dict:
    """Phase 23: qwen3-0.6b at MT_LAYERS of 28 layers and rwkv6, zamba2 and
    seamless at phase 19's depths, all at published widths, trained by
    ``make_train_step(rules=)`` on (1, 2) by two ranks sharing the card:
    qwen3 under ``serve_dh``, ``serve_kv_dp`` and ``serve_seq``, the rest
    under the first two.  Phase 19's f32 gates against the meshless step
    on the card (loss within MT_TOL relative, grad_norm and each gradient
    leaf within MT_TOL or FM_NULL x the meshless step's own spread over
    ``family_nulls``, each block's update within FM_UPDATE_TOL of the
    meshless update's norm); every leaf a rank holds whole bit-equal on
    both ranks, gradient and parameter; each variant's planted fault
    (:data:`VT_FAULTS`) past the gradient gate.  bf16 steps timed, peak
    memory a rank: recorded, not gated.  Every config is printed before
    any gate is asserted.  Returns the phase's launches (every rank's)."""
    from repro_torch.kernels.common import LAUNCHES

    gc.collect()
    torch.cuda.empty_cache()
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    runs = [(arch, family_cut(arch, layers), variants,
             tuple(v for v, (a, _) in VT_FAULTS.items() if a == arch))
            for arch, layers, variants in VT_RUNS]
    t0 = time.perf_counter()
    ranks = on_ranks(variant_train_rank, 2, (runs, DEV), VT_TIMEOUT_S)
    print(f'  two ranks on the card ({ranks[0]["backend"]}): '
          f'{time.perf_counter() - t0:.1f} s  [{card}]')
    failed = []

    def gate(ok, what):
        if not ok:
            failed.append(what)

    for (arch, layers, _), (_, cfg, variants, faults) in zip(VT_RUNS, runs):
        a = [r[arch] for r in ranks]
        ref = a[0]['meshless']
        held = [k for k in ref['grad_max'] if k != ZERO_GRAD]
        n_gate = max(MT_TOL, FM_NULL * max(p['nulls']['grad_norm']
                                           for p in a))
        depth = (f'{layers} + {layers} of {get_config_layers(arch)}'
                 if cfg.family == 'encdec'
                 else f'{layers} of {get_config_layers(arch)}')

        def ratios(res):
            """(worst leaf's error over its gate, leaf, error)."""
            return max((x['leaf_grads'][k] / max(
                MT_TOL, FM_NULL * p['nulls']['grads'][k]), k,
                x['leaf_grads'][k]) for p, x in zip(a, res) for k in held)

        for variant in variants:
            res = [x[variant, False] for x in a]
            loss_rel = abs(res[0]['loss'] - ref['loss']) / abs(ref['loss'])
            norm_rel = abs(res[0]['grad_norm'] - ref['grad_norm']) \
                / ref['grad_norm']
            g_ratio, g_leaf, grads = ratios(res)
            update, u_leaf = max((x['leaf_update'][k], k) for x in res
                                 for k in held)
            digests = [x['digests'] for x in res]
            replicas = all(d == digests[0] for d in digests[1:])
            b = [x[variant, 'bf16'] for x in a]
            ms = lambda xs: [round(x * 1e3, 1) for x in xs]  # noqa: E731
            print(f'  {arch} at {depth} layers under {variant}, f32, mesh '
                  f'{FM_SHAPE}, B={FM_B}, S={FM_S}, {FM_MICRO} microbatches: '
                  f'loss {res[0]["loss"]:.7f} vs meshless {ref["loss"]:.7f} '
                  f'(rel {loss_rel:.3e}, gate {MT_TOL:g}), grad_norm rel '
                  f'{norm_rel:.3e} (gate {n_gate:.3e}); worst gradient leaf '
                  f'{grads:.3e} of its max ({g_leaf}: {g_ratio:.3f} of its '
                  f'gate); worst update {update:.3e} ({u_leaf}; gate '
                  f'{FM_UPDATE_TOL:g}); {len(res[0]["whole"])} of '
                  f'{len(res[0]["leaf_grads"])} leaves whole, bit-equal on '
                  f'both ranks: {replicas}; bf16 B={FM_B}, S={FM_BF16_S} '
                  f'losses {[round(x, 4) for x in b[0]["losses"]]}, step '
                  f'times {ms(b[0]["seconds"])} ms (host clock, '
                  f'synchronized; two ranks time-slice one card: recorded, '
                  f'not a claim), peak rank 0 {b[0]["peak"] / 1e9:.2f} GB, '
                  f'rank 1 {b[1]["peak"] / 1e9:.2f} GB  [{card}]')
            gate(all(x['loss'] == res[0]['loss'] and
                     x['grad_norm'] == res[0]['grad_norm'] for x in res),
                 (arch, variant, 'ranks differ'))
            gate(loss_rel <= MT_TOL and norm_rel <= n_gate,
                 (arch, variant, 'loss', loss_rel, norm_rel))
            gate(g_ratio <= 1.0, (arch, variant, 'grads', g_leaf, g_ratio))
            gate(update <= FM_UPDATE_TOL,
                 (arch, variant, 'update', u_leaf, update))
            gate(replicas, (arch, variant, 'replicas'))
            if ZERO_GRAD in ref['grad_max']:
                stack = max(v for k, v in ref['grad_max'].items()
                            if k.startswith('dec_layers/'))
                zero = max(x['grad_max'][ZERO_GRAD] for x in res) / stack
                gate(zero <= MT_TOL, (arch, variant, ZERO_GRAD, zero))
        for variant in faults:
            g_ratio, g_leaf, grads = ratios([x[variant, True] for x in a])
            print(f'  planted fault on {arch} under {variant} '
                  f'({VT_FAULTS[variant][1]}): worst gradient leaf '
                  f'{grads:.3e} of its max ({g_leaf}: {g_ratio:.3g} of its '
                  f'gate; must be past it)  [{card}]')
            gate(g_ratio > 1.0, (arch, variant, 'fault passed', g_ratio))
        print(f'  {arch}: {a[0]["seconds"]:.1f} s')
    launches = dict(LAUNCHES)
    for r in ranks:
        for k, v in r['launches'].items():
            launches[k] += v
    print(f'  hand-written kernel launches in the phase (every rank): '
          f'{launches}')
    assert not failed, failed
    assert not any(launches.values()), launches
    return launches


# ---------------------------------------------------------------------------
# Phase 24: the reference's head_dim placement where model does not divide
# the attention heads
# ---------------------------------------------------------------------------

HD_ARCH, HD_LAYERS = 'qwen3-14b', 2    # published widths, 2 of 40 layers
HD_SHAPE = (1, 16)                 # (data, model): 16 gloo ranks sharing the
                                   # card; 16 divides neither the 40 q-heads
                                   # nor the 8 kv-heads
HD_B, HD_S, HD_DECODE = 4, 64, 4   # serve: rows, prompt, decode steps
HD_TRAIN_B, HD_TRAIN_S = 2, 64     # train: one f32 step
HD_DRAW = 8                        # ranks drawing their blocks at once
HD_TIMEOUT_S = 420                 # bounds the phase's spawned ranks
HD_FAULT = 'model rank 1\'s partial scores not summed over model'


def unsummed_scores(self, scores):
    """:data:`HD_FAULT` as a plan's ``score_sum``: this rank takes part in
    the all-reduce of the partial scores (the ranks' collectives still
    match) and goes on with its own."""
    torch.distributed.all_reduce(scores.clone(), group=self.group)
    return scores


def plant_head_dim_fault(rank: int) -> callable:
    """:data:`HD_FAULT` in this rank's serve step (on rank 1); -> a
    function that takes it out."""
    from repro_torch.distributed.tp import TensorParallel

    saved = TensorParallel.score_sum
    if rank == 1:
        TensorParallel.score_sum = unsummed_scores

    def restore():
        TensorParallel.score_sum = saved
    return restore


def plant_norm_fault(rank: int) -> callable:
    """Phase 25's rwkv6 fault: rank 1's group-norm squares not summed over
    model (it takes part in the all-reduce and goes on with its own);
    -> a function that takes it out."""
    from repro_torch.distributed.tp import TensorParallel

    saved = TensorParallel.value_norm
    if rank == 1:
        def own_norm(self, y, width, eps):
            yf = y.float()
            part = (yf * yf).sum(-1, keepdim=True)
            self.norm_sum(part.clone())
            return (yf * torch.rsqrt(part / width + eps)).to(y.dtype)
        TensorParallel.value_norm = own_norm

    def restore():
        TensorParallel.value_norm = saved
    return restore


def plant_head_fault(rank: int) -> callable:
    """Phase 25's seamless fault: rank 1's partial scores of the head cut
    on d_model not summed over model (it takes part in the all-reduce and
    goes on with its own); -> a function that takes it out."""
    from repro_torch.distributed.tp import TensorParallel

    saved = TensorParallel.head_sum
    if rank == 1:
        def own_part(self, part, dtype=torch.float32):
            saved(self, part.clone(), dtype)
            return part.to(dtype)
        TensorParallel.head_sum = own_part

    def restore():
        TensorParallel.head_sum = saved
    return restore


def plant_gather_fault() -> callable:
    """Phase 25's rwkv6 training fault: the gathers of ``r`` and ``k``
    keep each rank's block of their gradient, unsummed over model (the
    backward of ``TensorParallel.whole``); -> a function that takes it
    out."""
    from repro_torch.distributed.tp import TensorParallel

    saved = TensorParallel.gather_shares
    TensorParallel.gather_shares = TensorParallel.whole

    def restore():
        TensorParallel.gather_shares = saved
    return restore


TRAIN_FAULT = ('r\'s and k\'s gathers with a backward that keeps the rank\'s '
               'block unsummed')


# a fault's name -> (what it plants, its planter)
PLACEMENT_FAULTS = {
    'score_sum': (HD_FAULT, plant_head_dim_fault),
    'norm_sum': ('model rank 1\'s group-norm squares not summed over model',
                 plant_norm_fault),
    'head_sum': ('model rank 1\'s head partial not summed over model',
                 plant_head_fault)}


def every_rank(plan, x: torch.Tensor) -> torch.Tensor:
    """Every ``model`` rank's ``x``, stacked in rank order, on every
    rank."""
    x = x.contiguous()
    out = x.new_empty((plan.n * x.shape[0],) + tuple(x.shape[1:]))
    torch.distributed.all_gather_into_tensor(out, x, group=plan.group)
    return out.view((plan.n,) + tuple(x.shape))


def scatter_from_lead(parts, like: torch.Tensor) -> torch.Tensor:
    """Rank 0's ``parts`` (host tensors, one a rank in rank order; None on
    the other ranks) -> this rank's, shaped and placed like ``like``."""
    buf = torch.empty(like.shape, dtype=like.dtype)
    torch.distributed.scatter(
        buf, None if parts is None else [p.contiguous() for p in parts],
        src=0)
    return buf.to(like.device)


def placement_rank(rank: int, cfg, dev: str, fault: str, seed: int,
                   engine: bool = False) -> dict:
    """Phases 24 and 25 on one of the HD_SHAPE ranks sharing the card:
    each rank's serve and training blocks drawn on the card a leaf at a
    time (``Model.init_blocks``; rank 0 draws the whole weights for the
    meshless references); the serve step (``make_serve_step``, the
    default rules) in f32, under the planted ``fault``
    (:data:`PLACEMENT_FAULTS`; the prefill and one decode step) and in
    bf16, every rank's scores
    gathered, the batches drawn from ``seed``; rwkv6's prefill through K6
    on the rank's block (:func:`k6_block_check`); one training step in
    f32 (rwkv6's also under :data:`TRAIN_FAULT`), rank 0's meshless
    blocks of each gradient and update leaf scattered to the ranks, each
    comparing its own on the card.  ``engine``: between the two, the
    mesh engine on the serve step's blocks (:func:`engine_pair_rank`).
    Rank 0
    returns the score gates' numbers; every rank its placement, errors,
    times, peak memory, cache bytes (against the dry-run's count of the
    reference's block) and kernel launches."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import SERVE_RULES
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import describe, make_mesh
    from repro_torch.models.api import build_model
    from repro_torch.training import optimizer as opt
    from repro_torch.training import tree as tr
    from repro_torch.training.train_step import (
        TrainPlan, loss_and_grads, make_serve_step, make_train_step,
        mesh_loss_and_grads, shard_batch)

    entered = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    LAUNCHES.update(dict.fromkeys(LAUNCHES, 0))
    dist, lead = torch.distributed, rank == 0
    # each part's seconds on this rank (host clock, synchronized)
    spent, mark = {}, [time.perf_counter()]

    def lap(what):
        torch.cuda.synchronize()
        now = time.perf_counter()
        spent[what] = spent.get(what, 0.0) + now - mark[0]
        mark[0] = now

    mesh = make_mesh(HD_SHAPE, MESH_AXES, device=dev)
    model = build_model(cfg)
    shapes = (ShapeConfig('prefill', HD_S, HD_B, 'prefill'),
              ShapeConfig('decode', HD_S, HD_B, 'decode'))
    steps = [make_serve_step(model, mesh, s)[0] for s in shapes]
    plan = steps[0].plan
    tplan = make_train_step(model, mesh).plan
    out = {'placement': [(p.pair_cut, p.wkv_mode, p.embed_cut)
                         for p in (plan, tplan.tp)]}
    lap('plans')
    t0 = time.perf_counter()
    for turn in range(-(-mesh.size // HD_DRAW)):
        if rank // HD_DRAW == turn:
            # in turns: a leaf's f32 draw is up to 3.1 GB (qwen3-14b's
            # embed), too much for 16 ranks on one card at once
            served = model.init_blocks(0, plan, device=dev)
            blocks = model.init_blocks(0, tplan, device=dev)
            trained = f32_params(blocks, dev)
            del blocks
            torch.cuda.empty_cache()
        dist.barrier()
    out['draw_s'] = time.perf_counter() - t0
    # rank 0's whole weights for the meshless references
    drawn = model.init_params(0, device=dev) if lead else None
    lap('draw')

    # -- the serve step ----------------------------------------------------
    host_pre, host_steps = serve_batches(cfg, HD_B, HD_S, HD_DECODE, seed)
    dtypes = {'f32': torch.float32, 'bf16': torch.bfloat16}

    def batches(dtype):
        return [on_device(host_pre, dtype)] + [on_device(b)
                                               for b in host_steps]

    meshless = {}
    if lead:
        whole = [make_serve_step(model, None, s)[0] for s in shapes]
        for name, dtype in dtypes.items():
            params = f32_params(drawn, dev) if name == 'f32' else drawn
            cache = model.init_cache(shapes[0], device=dev, dtype=dtype)
            meshless[name], meshless[name + '_s'] = timed_calls(
                [(whole[min(i, 1)], params, cache, b)
                 for i, b in enumerate(batches(dtype))])
            del params, cache
        gc.collect()
        torch.cuda.empty_cache()
    lap('meshless serve')
    dist.barrier()
    lap('wait')
    reference = dryrun.argument_bytes(
        model, shapes[0], describe(HD_SHAPE, MESH_AXES), SERVE_RULES,
        coords=mesh.coords())
    reference_cache = reference['cache']
    lap('count')
    for name in ('f32', 'fault', 'bf16'):
        dtype = dtypes['bf16' if name == 'bf16' else 'f32']
        blocks = served if dtype == torch.bfloat16 else f32_params(served,
                                                                   dev)
        cache = plan.shard_cache(model.init_cache(shapes[0], device=dev,
                                                  dtype=dtype))
        restore = PLACEMENT_FAULTS[fault][1](rank) if name == 'fault' \
            else (lambda: None)
        torch.cuda.reset_peak_memory_stats()
        # the fault shows from the first decode step: prefill + 1 step
        calls = batches(dtype)[:2 if name == 'fault' else None]
        try:
            got, secs = timed_calls(
                [(steps[min(i, 1)], blocks, cache, plan.shard_batch(b))
                 for i, b in enumerate(calls)])
        finally:
            restore()
        res = {'mesh_s': secs, 'peak': torch.cuda.max_memory_allocated(),
               'cache_bytes': sum(t.numel() * t.element_size()
                                  for t in cache.values()),
               'cache_shape': tuple(cache['wkv' if 'wkv' in cache
                                          else 'k'].shape)}
        got = [full_scores(plan, g) for g in got]
        if plan.embed_cut:
            # every rank returns every column: the gates read the rank
            # furthest from the meshless step, and the ranks must agree
            every = [every_rank(plan, g) for g in got]
            res['replicas'] = all(torch.equal(e[0], x) for e in every
                                  for x in e[1:])
            if lead:
                got = [max(e, key=lambda x, w=w: (x - w).abs().max().item())
                       for e, w in zip(every, meshless['f32'])]
        if lead:
            res.update(score_gaps(got, meshless['f32']))
            if name == 'bf16':
                exact = meshless['f32']
                res['rows'] = {'mesh': row_errors(got, exact),
                               'meshless': row_errors(meshless['bf16'],
                                                      exact)}
                noise = 2 * max(res['rows']['meshless'])
                res['flips'] = {'mesh': flips(got, exact, noise),
                                'rtol': noise}
        out[name] = res
        del blocks, cache, got
        lap(f'{name} serve')
    out['reference_cache'] = reference_cache
    out['meshless_s'] = (meshless.get('f32_s'), meshless.get('bf16_s'))
    del meshless
    if engine:
        gc.collect()
        torch.cuda.empty_cache()
        out['engine'] = engine_pair_rank(rank, model, mesh, plan, served,
                                         drawn, reference['params'], dev)
        lap('engine')
    if cfg.family == 'ssm':
        out['k6'] = k6_block_check(model, plan, served, dev)
        lap('k6')
    del served
    gc.collect()
    torch.cuda.empty_cache()

    # -- one training step -------------------------------------------------
    host = masked_batch(cfg, HD_TRAIN_B, HD_TRAIN_S)
    ocfg = opt.AdamWConfig()
    want = {}
    if lead:
        batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        params = f32_params(drawn, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = loss_and_grads(model, params, batch)
        params, state, m = opt.adamw_update(ocfg, params, grads,
                                            opt.init_opt_state(params))
        torch.cuda.synchronize()
        want['s'] = time.perf_counter() - t0
        want['loss'], want['grad_norm'] = float(loss), float(m['grad_norm'])
        if cfg.family in ('ssm', 'hybrid', 'encdec'):
            # phase 19's nulls of these families' meshless step: a
            # gradient leaf's gate widens to FM_NULL x its spread
            want['nulls'] = null_spread(
                model, drawn, batch, 1, dev, dict(tr.leaves_with_paths(
                    grads)), {k: p.detach() for k, p in
                              tr.leaves_with_paths(params)}, m,
                family_nulls(cfg))['grads']
        want['grads'] = {k: g.cpu() for k, g in tr.leaves_with_paths(grads)}
        want['delta'] = {k: (p.detach() - drawn_leaf.float()).cpu()
                         for (k, p), (_, drawn_leaf) in zip(
                             tr.leaves_with_paths(params),
                             tr.leaves_with_paths(drawn))}
        del batch, params, state, grads, m, drawn
        gc.collect()
        torch.cuda.empty_cache()
    lap('meshless train')
    dist.barrier()
    lap('wait')
    rows = shard_batch(host, tplan)
    faulty = {}
    if cfg.family == 'ssm':
        # the planted training fault (:data:`TRAIN_FAULT`), which the
        # gradient gate must catch at these ranks
        restore = plant_gather_fault()
        try:
            _, bad = mesh_loss_and_grads(model, tplan, trained, rows)
        finally:
            restore()
        faulty = {k: g.detach() for k, g in tr.leaves_with_paths(bad)}
        del bad
        lap('train fault')
    before = {k: v.detach().clone() for k, v in tr.leaves_with_paths(trained)}
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads = mesh_loss_and_grads(model, tplan, trained, rows)
    lap('train forward, backward')
    grad_blocks = dict(tr.leaves_with_paths(grads))
    trained, _, m = opt.adamw_update(ocfg, trained, grads,
                                     tplan.init_opt_state(), plan=tplan)
    torch.cuda.synchronize()
    lap('train update')
    out['train'] = {'s': time.perf_counter() - t0, 'loss': float(loss),
                    'grad_norm': float(m['grad_norm']),
                    'peak': torch.cuda.max_memory_allocated()}
    t0 = time.perf_counter()
    plans = ([TrainPlan(model, mesh, coords=mesh.coords(r))
              for r in range(mesh.size)] if lead else None)
    errors, maxima = {'grads': {}, 'update': {}, 'fault': {}}, {}
    for k, p in tr.leaves_with_paths(trained):
        for what, local in (('grads', grad_blocks[k].detach()),
                            ('update', p.detach() - before[k])):
            full = want['grads' if what == 'grads' else 'delta'][k] \
                if lead else None
            mine = scatter_from_lead(
                [b.param_blocks[k].take(full) for b in plans]
                if lead else None, local)
            if what == 'grads':
                top = mine.abs().max()
                # the leaf's max: the largest of its blocks' maxima
                dist.all_reduce(top, op=dist.ReduceOp.MAX)
                err = float((local - mine).abs().max() / top)
                errors[what][k] = math.inf if math.isnan(err) else err
                if k in faulty:
                    errors['fault'][k] = float((faulty[k] - mine).abs().max()
                                               / top)
                # (the meshless leaf's max |g|, this rank's block's)
                maxima[k] = (float(top), float(local.abs().max()))
            else:
                miss = torch.linalg.vector_norm(local - mine)
                norm = torch.linalg.vector_norm(mine)
                errors[what][k] = float(miss / norm) if norm > 0 else (
                    0.0 if miss == 0 else math.inf)
    out['compare_s'] = time.perf_counter() - t0
    lap('compare')
    out['train'].update(errors=errors, maxima=maxima)
    if lead:
        out['train'].update(meshless_s=want['s'],
                            meshless_loss=want['loss'],
                            meshless_grad_norm=want['grad_norm'],
                            nulls=want.get('nulls', {}))
    out['launches'] = dict(LAUNCHES)
    out['spent'], out['entered'], out['left'] = spent, entered, time.time()
    return out


def placement_gates(card: str, arch: str, layers: int, ranks: list,
                    fault: str, started: float, t0: float) -> list:
    """Print and gate one architecture's results of :func:`placement_rank`
    (phases 24 and 25): (a) f32 scores within FS_TOL of |max| of the
    meshless step, argmax equal, the planted fault past that gate; (b) bf16
    under phase 21's rule; (c) each rank's cache bytes equal to the
    dry-run's count of its block under the reference's specs; (d) one f32
    training step: loss within MT_TOL relative, every gradient leaf within
    MT_TOL of its max, every block's update within FM_UPDATE_TOL of the
    meshless update's norm, and where a training fault was planted (rwkv6,
    :data:`TRAIN_FAULT`) its gradients past that gate.  Returns the gates
    that failed."""
    r0, ended = ranks[0], time.time()
    print(f'  {arch}: {len(ranks)} ranks on the card '
          f'{time.perf_counter() - t0:.1f} s (weights drawn and cut '
          f'{r0["draw_s"]:.1f} s, the meshless training blocks scattered and '
          f'compared {r0["compare_s"]:.1f} s)  [{card}]')
    print(f'  where the time went (host clock): the ranks entered '
          f'{min(r["entered"] for r in ranks) - started:.1f}-'
          f'{max(r["entered"] for r in ranks) - started:.1f} s after the '
          f'call, their results were back '
          f'{ended - max(r["left"] for r in ranks):.1f} s after the last '
          f'left it; rank 0 '
          + ', '.join(f'{k} {v:.1f}' for k, v in r0['spent'].items())
          + ' s; the slowest rank '
          + ', '.join(f'{k} {max(r["spent"][k] for r in ranks):.1f}'
                      for k in r0['spent']) + ' s')
    failed = []

    def gate(ok, what):
        if not ok:
            failed.append((arch,) + tuple(what))

    ms = lambda xs: [round(x * 1e3, 2) for x in xs]  # noqa: E731
    f32, bad, bf = r0['f32'], r0['fault'], r0['bf16']
    f32_ok = max(f32['gaps']) <= FS_TOL and all(f32['equal'])
    fault_ok = max(bad['gaps']) <= FS_TOL and all(bad['equal'])
    med = {k: statistics.median(v) for k, v in bf['rows'].items()}
    bound = FS_BF16_RATIO * med['meshless']
    bf_ok = med['mesh'] <= bound and not bf['flips']['mesh']
    print(f'  (a) {arch} at {layers} of {get_config_layers(arch)} layers, '
          f'prefill B={HD_B} S={HD_S} + {HD_DECODE} decode steps, f32: '
          f'|mesh - meshless| of |max| {[f"{g:.3e}" for g in f32["gaps"]]}, '
          f'argmax equal {f32["equal"]} (gate {FS_TOL:g}: '
          f'{"pass" if f32_ok else "FAIL"}); planted fault '
          f'({PLACEMENT_FAULTS[fault][0]}): '
          f'{[f"{g:.3e}" for g in bad["gaps"]]} (must fail: '
          f'{"fails" if not fault_ok else "PASSES"})  [{card}]')
    print(f'  (b) bf16 rows against the meshless f32 step, median '
          f'{med["mesh"]:.3e} against {FS_BF16_RATIO:g} x the meshless bf16 '
          f'step\'s {med["meshless"]:.3e} = {bound:.3e}, argmax off and not '
          f'a near tie {bf["flips"]["mesh"]} (gate: '
          f'{"pass" if bf_ok else "FAIL"}); meshless step ms f32 '
          f'{ms(r0["meshless_s"][0])}, bf16 {ms(r0["meshless_s"][1])}  '
          f'[{card}]')
    calls = [r['bf16']['mesh_s'] for r in ranks]
    peaks = [r['bf16']['peak'] / 1e9 for r in ranks]
    print(f'  (b) bf16 mesh step ms (prefill, then decode; host clock, '
          f'{len(ranks)} ranks time-slice one card): rank 0 '
          f'{ms(calls[0])}, slowest prefill {max(c[0] for c in calls) * 1e3:.2f}'
          f', slowest decode {max(max(c[1:]) for c in calls) * 1e3:.2f}; '
          f'peak memory a rank {min(peaks):.3f}-{max(peaks):.3f} GB (f32 '
          f'{max(r["f32"]["peak"] for r in ranks) / 1e9:.3f} GB)  [{card}]')
    caches = {(r['bf16']['cache_bytes'], r['reference_cache'],
               r['bf16']['cache_shape']) for r in ranks}
    cache_ok = all(c[0] == c[1] for c in caches)
    print(f'  (c) cache bytes a rank (bf16; the block shape of its wkv '
          f'state or its K pool) against the dry-run\'s reference count: '
          f'{sorted(caches)} ({"equal" if cache_ok else "DIFFER"})')
    t = r0['train']
    loss_rel = abs(t['loss'] - t['meshless_loss']) / abs(t['meshless_loss'])
    norm_rel = abs(t['grad_norm'] - t['meshless_grad_norm']) \
        / t['meshless_grad_norm']
    # a gradient leaf's gate: MT_TOL of its max, or FM_NULL x its null
    # where the meshless step has one (phase 19's rule); seamless's
    # exact-zero gradient is held to the decoder stack's max instead
    nulls = t['nulls']
    g_gate = lambda k: max(MT_TOL, FM_NULL * nulls.get(k, 0.0))  # noqa
    (g_ratio, g_err, g_leaf, g_rank), (u_err, _, u_leaf, u_rank) = (
        max((e / (g_gate(k) if what == 'grads' else 1.0), e, k, r)
            for r, x in enumerate(ranks)
            for k, e in x['train']['errors'][what].items()
            if k != ZERO_GRAD)
        for what in ('grads', 'update'))
    same = all(r['train']['loss'] == t['loss'] for r in ranks)
    print(f'  (d) one f32 training step B={HD_TRAIN_B} S={HD_TRAIN_S}: loss '
          f'{t["loss"]:.7f} vs meshless {t["meshless_loss"]:.7f} (rel '
          f'{loss_rel:.3e}, gate {MT_TOL:g}), grad_norm rel {norm_rel:.3e}; '
          f'worst gradient leaf {g_err:.3e} of its max ({g_leaf}, rank '
          f'{g_rank}; gate {g_gate(g_leaf):.3e}: max({MT_TOL:g}, {FM_NULL:g} '
          f'x the leaf\'s null {nulls.get(g_leaf, 0.0):.3e})), worst block '
          f'update {u_err:.3e} '
          f'({u_leaf}, rank {u_rank}; gate {FM_UPDATE_TOL:g}) over '
          f'{len(t["errors"]["grads"])} leaves x {len(ranks)} ranks; loss '
          f'equal on every '
          f'rank {same}; step {t["s"] * 1e3:.1f} ms (meshless '
          f'{t["meshless_s"] * 1e3:.1f} ms), peak rank 0 {t["peak"] / 1e9:.3f}'
          f' GB  [{card}]')
    faults = [(e / g_gate(k), e, k, r) for r, x in enumerate(ranks)
              for k, e in x['train']['errors']['fault'].items()
              if k != ZERO_GRAD]
    if faults:
        f_ratio, f_err, f_leaf, f_rank = max(faults)
        print(f'  (d) planted training fault ({TRAIN_FAULT}): worst gradient '
              f'leaf {f_err:.3e} of its max ({f_leaf}, rank {f_rank}; its '
              f'gate {g_gate(f_leaf):.3e}; must fail: '
              f'{"fails" if f_ratio > 1.0 else "PASSES"})  [{card}]')
        gate(f_ratio > 1.0, ('train fault passes', f_leaf, f_err))
    if 'replicas' in f32:
        print(f'  (a) every rank\'s scores (the head cut on d_model, every '
              f'column on every rank) bit-equal: f32 {f32["replicas"]}, bf16 '
              f'{bf["replicas"]}; the fault\'s gaps are the worst rank\'s  '
              f'[{card}]')
        gate(f32['replicas'] and bf['replicas'], ('replicas',))
    gate(f32_ok, ('f32', f32['gaps'], f32['equal']))
    gate(not fault_ok, ('fault passes f32', bad['gaps']))
    gate(bf_ok, ('bf16', med, bf['flips']))
    gate(cache_ok, ('cache bytes', sorted(caches)))
    gate(same and loss_rel <= MT_TOL and norm_rel <= MT_TOL,
         ('train loss', loss_rel, norm_rel))
    gate(g_ratio <= 1.0, ('train grads', g_leaf, g_err))
    gate(u_err <= FM_UPDATE_TOL, ('train update', u_leaf, u_err))
    if ZERO_GRAD in t['maxima']:
        stack = max(v[0] for k, v in t['maxima'].items()
                    if k.startswith('dec_layers/'))
        zeros = [t['maxima'][ZERO_GRAD][0] / stack] + [
            r['train']['maxima'][ZERO_GRAD][1] / stack for r in ranks]
        print(f'  (d) {ZERO_GRAD} (softmax ignores it): meshless and mesh '
              f'max |g| {zeros[0]:.3e} / {max(zeros[1:]):.3e} of the decoder '
              f'stack\'s max |g| (gate {MT_TOL:g})  [{card}]')
        gate(max(zeros) <= MT_TOL, (ZERO_GRAD, zeros))
    return failed


def rank_launches(ranks) -> dict:
    """Every rank's hand-written kernel launches of a phase, summed, with
    the main process's own (:data:`LAUNCHES`)."""
    from repro_torch.kernels.common import LAUNCHES

    launches = dict(LAUNCHES)
    for r in ranks:
        for k, v in r['launches'].items():
            launches[k] += v
    return launches


# (e): the mesh engine under the reference engine's placement, on phase
# 24's ranks and blocks
HD_ENGINE_REQS, HD_ENGINE_NEW = 3, 4   # requests (a 64-token prompt each),
                                       # new tokens a request
HD_ENGINE_FAULT_STEPS = 2          # the fault's dispatches (the first shows it)
HD_NEAR_TIE = 1e-3                 # bf16 fused: a near tie, of |max|
HD_ENGINE_POOL = (8, 4)            # the engine's pool: handles, pages each


class EngineLog(Recorder):
    """:class:`Recorder` that also keeps the kind of every dispatch in
    order and, for a fused decode dispatch, the sampled tokens of its
    live rows."""

    def __init__(self, model):
        super().__init__(model)
        self.kinds, self.tokens = [], []

    def prefill_chunk_fn(self, params, cache, batch, **kw):
        self.kinds.append('mixed')
        return super().prefill_chunk_fn(params, cache, batch, **kw)

    def decode_fn(self, params, cache, batch, **kw):
        self.kinds.append('decode')
        return super().decode_fn(params, cache, batch, **kw)

    def decode_sample_fn(self, params, cache, batch, **kw):
        cache, toks = self.model.decode_sample_fn(params, cache, batch, **kw)
        self.kinds.append('sample')
        self.tokens.append(toks[live_rows(batch)].clone())
        return cache, toks


def pair_engine(model, params, mesh, dev: str, **ecfg):
    """(e)'s engine: a pool of :data:`HD_ENGINE_POOL`, 4 rows, one chunk a
    prompt; its pool in the weights' dtype."""
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.serving.kvpool import KVPool

    pool = KVPool(*HD_ENGINE_POOL, page_size=model.cfg.page_size,
                  reserved_handles=1)
    eng = Engine(model, params, pool, EngineConfig(
        max_batch=4, max_seq=HD_S + 2 * model.cfg.page_size,
        prefill_chunk=HD_S, mesh=mesh, **ecfg), device=dev)
    dtype = params['embed'].dtype
    eng.cache = {k: v.to(dtype) for k, v in eng.cache.items()}
    return eng


def pair_drain(eng, steps: Optional[int] = None) -> list:
    """(e)'s trace: :data:`HD_ENGINE_REQS` prompts of HD_S tokens; the
    first is prefilled and decodes a token alone, then the others join its
    decode row in a mixed dispatch; HD_ENGINE_NEW new tokens each.
    ``steps``: only that many dispatches (the fault's)."""
    rng = np.random.default_rng(24)
    prompts = [rng.integers(1, eng.mcfg.vocab_size, HD_S).tolist()
               for _ in range(HD_ENGINE_REQS)]
    rids = [eng.submit(prompts[0], max_new_tokens=HD_ENGINE_NEW)]
    for _ in range(steps or 4):
        eng.step()
        if steps is None and len(eng.requests[rids[0]].generated) >= 2:
            break
    if steps is not None:
        return []
    rids += [eng.submit(p, max_new_tokens=HD_ENGINE_NEW)
             for p in prompts[1:]]
    eng.run_to_completion()
    torch.cuda.synchronize()
    return [eng.output_tokens(r) for r in rids]


def whole_head_bytes(model, plan, dtype) -> tuple:
    """(weight bytes, pool bytes a page) that ``plan``'s rank would hold
    with whole heads (``tp.head_blocks``: here every head, replicated),
    the rest of its blocks as they are: for the record."""
    from repro_torch.distributed.tp import _leaves, head_blocks

    cfg, size = model.cfg, torch.tensor([], dtype=dtype).element_size()
    (q0, q1), (k0, k1) = head_blocks(cfg.n_heads, cfg.n_kv_heads, plan.n,
                                     plan.rank)
    heads = {'wq': (2, q1 - q0), 'bq': (1, q1 - q0), 'wo': (1, q1 - q0),
             **dict.fromkeys(('wk', 'wv'), (2, k1 - k0)),
             **dict.fromkeys(('bk', 'bv'), (1, k1 - k0))}
    weights, shapes = 0, model.param_shapes()
    for path, _ in _leaves(model.template()):
        shape = shapes
        for k in path:
            shape = shape[k]
        if path[-1] in heads:
            dim, h = heads[path[-1]]
            weights += int(np.prod(shape)) // shape[dim] * h * cfg.hd
        else:
            weights += int(np.prod(plan.block(path, shape).local_shape))
    page = 2 * cfg.n_layers * cfg.page_size * (k1 - k0) * cfg.hd
    return weights * size, page * size


def engine_pair_rank(rank: int, model, mesh, plan, served, drawn,
                     reference_params: int, dev: str) -> dict:
    """Phase 24 (e) on one of the HD_SHAPE ranks: the mesh engine under
    the engine's plan (``tp.engine_plan``, whose blocks are the serve
    step's ``served`` ones), rank 0 opening each engine on its own blocks
    and every other rank following with its own (``serve_rank(mesh,
    blocks=)``): f32, f32 with :data:`HD_FAULT` planted on model rank 1's
    plan, bf16 unfused, bf16 fused (K4 on every rank's vocabulary block:
    the counts are set to 0 just before this drain and read just after).
    Rank 0 also drains the meshless engine in f32 on its whole weights
    ``drawn``.  Every rank returns its weight and pool bytes beside the
    reference's count and its launches; rank 0 the drains."""
    from repro_torch.distributed.sharding import (SERVE_RULES, local_bounds,
                                                  shaped_spec)
    from repro_torch.distributed.tp import (_leaves, engine_plan, serve_rank,
                                            stop_ranks)
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.launch.mesh import describe

    eplan = engine_plan(model.cfg, mesh, max_batch=4)
    shapes = model.param_shapes()

    def shape_of(path):
        node = shapes
        for k in path:
            node = node[k]
        return node

    out = {'pair_cut': eplan.pair_cut, 'same_blocks': all(
        eplan.block(p, shape_of(p)) == plan.block(p, shape_of(p))
        for p, _ in _leaves(served))}
    bf16 = served['embed'].dtype
    size = torch.tensor([], dtype=bf16).element_size()
    n_pages = 1 + HD_ENGINE_POOL[0] * HD_ENGINE_POOL[1]
    pool = model.cache_template(engine_pages=n_pages)
    ref_mesh = describe(HD_SHAPE, MESH_AXES)
    out['reference'] = (reference_params, size * sum(
        int(np.prod(local_bounds(leaf.shape, shaped_spec(
            leaf.shape, leaf.axes, SERVE_RULES, ref_mesh), ref_mesh,
            mesh.coords()).local_shape)) for leaf in pool.values())
        // n_pages)
    out['whole'] = whole_head_bytes(model, eplan, bf16)
    out['weights'] = sum(w.numel() * w.element_size()
                         for _, w in _leaves(served))
    # the serve step's and the trainer's counts stay theirs
    saved = dict(LAUNCHES)
    if rank != 0:
        opened = []

        def blocks(cfg, p):
            # the engines open in rank 0's order: f32, the fault, bf16
            # unfused, bf16 fused
            i = len(opened)
            opened.append(i)
            if i == 1 and p.rank == 1:
                p.score_sum = types.MethodType(unsummed_scores, p)
            return f32_copy(served) if i < 2 else served
        res = serve_rank(mesh, blocks=blocks)
        ids = sorted(res['launches'])
        out['launches'] = res['launches'][ids[-1]]
        out['unfused'] = {k: sum(res['launches'][i][k] for i in ids[:-1])
                          for k in LAUNCHES}
        shape = res['cache_shapes'][ids[-1]]
        out['page'] = 2 * size * int(np.prod(shape)) // shape[1]
        LAUNCHES.update(saved)
        return out
    try:
        LAUNCHES.update(dict.fromkeys(LAUNCHES, 0))
        t0 = time.perf_counter()
        whole = f32_copy(drawn)
        ref = EngineLog(model)
        toks = pair_drain(pair_engine(ref, whole, None, dev,
                                      decode_kernel=False))
        del whole
        gc.collect()
        torch.cuda.empty_cache()
        out['meshless'] = {'tokens': toks, 's': time.perf_counter() - t0,
                           'scores': [x.float().cpu().numpy()
                                      for x in ref.scores]}
        runs = {}
        for name, params, steps in (
                ('f32', lambda: f32_copy(served), None),
                ('fault', lambda: f32_copy(served), HD_ENGINE_FAULT_STEPS),
                ('bf16', lambda: served, None),
                ('fused', lambda: served, None)):
            if name == 'fused':
                out['unfused'] = dict(LAUNCHES)
                LAUNCHES.update(dict.fromkeys(LAUNCHES, 0))
            t0 = time.perf_counter()
            log = EngineLog(model)
            eng = pair_engine(log, params(), mesh, dev,
                              fused_sampling=name == 'fused')
            toks = pair_drain(eng, steps)
            eng.close()
            # numpy: a rank's tensors would not outlive it in the queue
            runs[name] = {'tokens': toks, 'kinds': log.kinds,
                          'scores': [x.float().cpu().numpy()
                                     for x in log.scores],
                          'sampled': [x.cpu().numpy() for x in log.tokens],
                          's': time.perf_counter() - t0,
                          'use_kernel': eng._use_kernel}
            if name == 'fused':
                out['launches'] = dict(LAUNCHES)
                out['page'] = size * sum(t.numel() for t in eng.cache.values()
                                         ) // eng.pool.n_pages
            del eng
            gc.collect()
            torch.cuda.empty_cache()
        out['runs'] = runs
        return out
    finally:
        LAUNCHES.update(saved)
        stop_ranks(mesh)


def fused_against_unfused(fused, unfused) -> dict:
    """(e) bf16: each fused decode dispatch's tokens against the argmax of
    the unfused drain's scores at the same dispatch (the two drains run
    one schedule), up to and including the first dispatch where a token
    differs (the drains' inputs part there): each differing token a near
    tie (within :data:`HD_NEAR_TIE` of the row's |max|)."""
    rows = differ = 0
    ties = True
    scores = iter(unfused['scores'])
    tokens = iter(fused['sampled'])
    for kind, other in zip(fused['kinds'], unfused['kinds']):
        s = next(scores)
        if kind != 'sample':
            assert kind == other == 'mixed', (kind, other)
            continue
        assert other == 'decode', other
        got, want = next(tokens), s.argmax(-1)
        rows += len(got)
        bad = np.nonzero(got != want)[0].tolist()
        for i in bad:
            ties &= bool(s[i].max() - s[i][got[i]]
                         <= HD_NEAR_TIE * np.abs(s[i]).max())
        if bad:
            differ = len(bad)
            break
    return {'rows': rows, 'differ': differ, 'ties': ties}


def engine_pair_gates(card: str, ranks: list) -> tuple:
    """Print and gate phase 24 (e): (a) f32 tokens equal to the meshless
    engine's and every dispatch's scores within FS_TOL of |max|, the
    fault's past it; (b) bf16 fused tokens against the unfused drain's
    argmax (:func:`fused_against_unfused`), K4 launched on every rank in
    the fused drain, K1-K3 in none of the drains; (c) every rank's weight
    and pool-page bytes the reference's.  -> (the gates that failed, the
    fused drain's launches over every rank)."""
    e = ranks[0]['engine']
    m, runs = e['meshless'], e['runs']
    f32, fault, bf, fused = (runs[k] for k in ('f32', 'fault', 'bf16',
                                               'fused'))
    gap = lambda x, y: float(np.abs(x - y).max() / np.abs(y).max())  # noqa
    gaps = [gap(x, y) for x, y in zip(f32['scores'], m['scores'])]
    fault_gap = gap(fault['scores'][0], m['scores'][0])
    f32_ok = (f32['tokens'] == m['tokens'] and
              len(f32['scores']) == len(m['scores']) and
              max(gaps) <= FS_TOL)
    cmp = fused_against_unfused(fused, bf)
    fused_ok = cmp['ties'] and cmp['rows'] > 0
    launches = {k: sum(r['engine']['launches'][k] for r in ranks)
                for k in ranks[0]['engine']['launches']}
    unfused = {k: sum(r['engine']['unfused'][k] for r in ranks)
               for k in launches}
    k4_ok = all(r['engine']['launches']['unembed_sample'] > 0 for r in ranks)
    k13 = {k: launches[k] + unfused[k] for k in DECODE_KERNELS[:3]}
    sizes = {(r['engine']['weights'], r['engine']['page'])
             for r in ranks}
    refs = {r['engine']['reference'] for r in ranks}
    bytes_ok = all((r['engine']['weights'], r['engine']['page'])
                   == r['engine']['reference'] for r in ranks)
    plan_ok = all(r['engine']['pair_cut'] and r['engine']['same_blocks']
                  for r in ranks)
    secs = {k: round(v['s'], 1) for k, v in runs.items()}
    print(f'  (e) the mesh engine on the pair blocks ({len(ranks)} ranks, '
          f'{HD_ENGINE_REQS} requests of {HD_S} tokens, {HD_ENGINE_NEW} new '
          f'tokens each, {len(m["scores"])} dispatches; decode_kernel=None '
          f'resolved to the plain path: {not f32["use_kernel"]}): f32 tokens '
          f'{f32["tokens"]} equal to the meshless engine\'s '
          f'{f32["tokens"] == m["tokens"]}, |mesh - meshless| of |max| '
          f'{[f"{g:.3e}" for g in gaps]} (gate {FS_TOL:g}: '
          f'{"pass" if f32_ok else "FAIL"}); planted fault ({HD_FAULT}) '
          f'{fault_gap:.3e} on the first dispatch (must fail: '
          f'{"fails" if fault_gap > FS_TOL else "PASSES"})  [{card}]')
    print(f'  (e) bf16 fused against the bf16 unfused drain\'s argmax: '
          f'{cmp["rows"]} decode rows compared, {cmp["differ"]} differing, '
          f'near ties {cmp["ties"]} (gate {HD_NEAR_TIE:g} of |max|: '
          f'{"pass" if fused_ok else "FAIL"}); fused tokens '
          f'{fused["tokens"]}; launches in the fused drain (every rank) '
          f'{launches}, K4 on every rank {k4_ok}; K1-K3 in every drain '
          f'{k13}  [{card}]')
    print(f'  (e) bytes a rank (bf16): weights and a pool page {sorted(sizes)}'
          f' against the reference\'s tree_spec_shaped count '
          f'{sorted(refs)} ({"equal" if bytes_ok else "DIFFER"}); with '
          f'whole heads rank 0 would hold {e["whole"][0]:,} B of weights '
          f'and {e["whole"][1]:,} B a page; the engine\'s plan is the serve '
          f'step\'s blocks {plan_ok}; seconds (host clock) meshless '
          f'{m["s"]:.1f}, mesh {secs}  [{card}]')
    failed = []
    for ok, what in ((f32_ok, ('engine f32', gaps)),
                     (fault_gap > FS_TOL, ('engine fault passes', fault_gap)),
                     (fused_ok, ('engine fused', cmp)),
                     (k4_ok, ('engine K4', launches)),
                     (not any(k13.values()), ('engine K1-K3', k13)),
                     (bytes_ok, ('engine bytes', sorted(sizes),
                                 sorted(refs))),
                     (plan_ok, ('engine plan',))):
        if not ok:
            failed.append(what)
    return failed, launches


def k4_pair_check(card: str) -> dict:
    """Phase 24 (e)'s K4 at the engine's shape: a rank's block of
    qwen3-14b's head (151936 / 16 = 9496 rows of D = 5120, col0 the 16th
    rank's) for HD_B rows (8-row launches: N = 8) and for 16 (N = 16, a
    shorter ring beside ``last``), T = 0 and 0.8, against the plain block
    version: every index equal or a near tie of the f32 scores.  Timed
    at HD_B rows beside the plain version, its bound and ``argmax(last @
    block.T)``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.common import gumbel_hash_noise
    from repro_torch.kernels.sampling.ops import unembed_argmax_block
    from repro_torch.kernels.sampling.ref import (unembed_argmax_block_ref,
                                                  unembed_scores)

    cfg = get_config(HD_ARCH)
    n = HD_SHAPE[1]
    v, d = cfg.vocab_size // n, cfg.d_model
    col0 = (n - 1) * v
    gen = torch.Generator(device=DEV).manual_seed(24)
    head = (torch.randn((v, d), generator=gen, device=DEV)
            * d ** -0.5).to(torch.bfloat16)
    out = {}
    for rows in (HD_B, 16):
        last = torch.randn((rows, d), generator=gen,
                           device=DEV).to(torch.bfloat16)
        for t in (0.0, K4_T):
            got = unembed_argmax_block(last, head, 5, temperature=t, row0=0,
                                       col0=col0)[1]
            want = unembed_argmax_block_ref(last, head, 5, temperature=t,
                                            row0=0, col0=col0)[1]
            scores = unembed_scores(last, head)
            if t > 0:
                scores = scores / t + gumbel_hash_noise(
                    5, torch.arange(rows, device=DEV)[:, None],
                    torch.arange(col0, col0 + v, device=DEV)[None, :])
            for r, (a, b) in enumerate(zip(got.tolist(), want.tolist())):
                assert a == b or near_tie(scores[r], a - col0, b - col0), \
                    ('K4 at the engine\'s shape', rows, t, r, a, b)
            out[rows, t] = int((got == want).sum())
    last = torch.randn((HD_B, d), generator=gen, device=DEV).to(torch.bfloat16)
    timer = Timer()
    ms = timer(lambda: unembed_argmax_block(last, head, 5, col0=col0))
    plain = timer(lambda: unembed_argmax_block_ref(last, head, 5, col0=col0))
    lib = timer(lambda: torch.argmax(last @ head.T, dim=-1))
    t_bound, by = bound(v * d * 2 + HD_B * d * 2 + HD_B * 8, 2 * HD_B * v * d)
    print(f'  (e) K4 on a rank\'s block of {HD_ARCH}\'s head ({v} x {d}, '
          f'col0 {col0}) at {HD_B} and 16 rows, T = 0 and {K4_T}: indices '
          f'equal to the plain block version on {out} rows (the rest near '
          f'ties); at {HD_B} rows kernel_ms {ms:.4f}  plain_ms {plain:.4f}  '
          f'library_ms {lib:.4f} (argmax(last @ block.T))  bound_ms '
          f'{t_bound:.4f} ({by})  [{card}]')
    return {'ms': ms, 'plain_ms': plain, 'library_ms': lib,
            'bound': (t_bound, by)}


def head_dim_check(card: str) -> tuple:
    """Phase 24: qwen3-14b at published widths (d 5120, 40 q-heads, 8
    kv-heads, head_dim 128), HD_LAYERS of 40 layers, on (data 1, model 16)
    by 16 gloo ranks sharing the card: the reference's head_dim placement
    (``tp.TensorParallel``, ``pair_cut``: every rank 4 of the 64 RoPE
    pairs of every head in ``wq``/``wk``/``wv``/``wo`` and the pool),
    :func:`placement_gates`' (a)-(d) with :data:`HD_FAULT` planted, 0
    kernel launches; (e) the mesh engine on the same blocks
    (:func:`engine_pair_gates`).  Returns (the serve step's and the
    trainer's launches, the engine's fused drain's: every rank's)."""
    from repro_torch.kernels.common import LAUNCHES

    gc.collect()
    torch.cuda.empty_cache()
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    cfg = family_cut(HD_ARCH, HD_LAYERS)
    t0, started = time.perf_counter(), time.time()
    ranks = on_ranks(placement_rank, int(np.prod(HD_SHAPE)),
                     (cfg, DEV, 'score_sum', 24, True), HD_TIMEOUT_S)
    failed = placement_gates(card, HD_ARCH, HD_LAYERS, ranks, 'score_sum',
                             started, t0)
    if not all(r['placement'] == [(True, None, False)] * 2 for r in ranks):
        failed.append(('placement', ranks[0]['placement']))
    engine_failed, engine = engine_pair_gates(card, ranks)
    launches = rank_launches(ranks)
    k4_pair_check(card)               # its launches count for no path
    print(f'  hand-written kernel launches in the serve step and training '
          f'(every rank): {launches}')
    assert not failed + engine_failed, failed + engine_failed
    assert not any(launches.values()), launches
    return launches, engine


# ---------------------------------------------------------------------------
# Phase 25: the reference's placement where model does not divide rwkv6's
# wkv heads or seamless's vocabulary
# ---------------------------------------------------------------------------

# (arch, depth, the planted fault, the batches' seed, what the plans hold:
# (pair_cut, wkv_mode, embed_cut) of the serve step's and the trainer's)
WV_RUNS = (('rwkv6-3b', 2, 'norm_sum', 25, (False, 'values', False)),
           ('seamless-m4t-medium', 2, 'head_sum', 26, (False, None, True)))
WV_K6 = (4, 64, 40, 64, 4)         # K6 at a rank's value block, timed:
                                   # (B, T, H, K, V), f32


def k6_block_check(model, plan, served, dev: str) -> dict:
    """Phase 25 (e), on one rank: rwkv6's ``prefill_fn(use_kernel=True,
    tp=)`` -- K6 over every head's value block of this rank -- against the
    plain chunked path on the same block and the plain path at chunk 64
    (the null), f32, HD_B rows of HD_S tokens: each layer's state block
    and the scores; the kernel's launches."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels.common import LAUNCHES

    shape = ShapeConfig('prefill', HD_S, HD_B, 'prefill')
    batch = {'tokens': torch.tensor(np.random.default_rng(25).integers(
        0, model.cfg.vocab_size, (HD_B, HD_S)), device=dev)}
    params = f32_params(served, dev)

    def run(use_kernel):
        cache = plan.shard_cache(model.init_cache(shape, device=dev,
                                                  dtype=torch.float32))
        with torch.no_grad():
            cache, scores = model.prefill_fn(params, cache, batch,
                                             use_kernel=use_kernel, tp=plan)
        return scores, cache['wkv']

    before = LAUNCHES['wkv6']
    kern = run(True)
    launches = LAUNCHES['wkv6'] - before
    plain = run(False)
    with plain_wkv_chunk(64):
        null = run(False)

    def rel(a, b) -> float:
        return ((a - b).abs().max() / b.abs().max()).item()

    return {'launches': launches, 'block': tuple(kern[1].shape),
            'state0': (max_err(kern[1][0], plain[1][0]),
                       wkv_close(kern[1][0], plain[1][0], WKV_TOL)),
            'states': [(rel(k, p), rel(n, p)) for k, p, n in
                       zip(kern[1], plain[1], null[1])],
            'scores': (rel(kern[0], plain[0]), rel(null[0], plain[0]))}


def k6_block_time(timer) -> dict:
    """K6 at :data:`WV_K6` (a rank's value block of rwkv6-3b's 40 heads on
    16 ranks, the prompt of phase 25), f32: its time, its tiled plain
    model's, and the bound of the bytes it must move."""
    from repro_torch.kernels.rwkv6.ops import wkv6
    from repro_torch.kernels.rwkv6.ref import wkv6_tiled_ref

    b, t, h, k, v = WV_K6
    gen = torch.Generator(device=DEV).manual_seed(25)

    def randn(*shape, scale=0.5):
        return torch.randn(shape, generator=gen, device=DEV) * scale
    w = torch.exp(-2.5 + 2.495 * torch.rand((b, t, h, k), generator=gen,
                                            device=DEV))
    xs = [randn(b, t, h, k), randn(b, t, h, k), randn(b, t, h, v), w,
          randn(h, k, scale=0.3), randn(b, h, k, v, scale=0.1)]
    y, s = wkv6(*xs)
    want = wkv6_tiled_ref(*xs)
    n_bytes = 4 * (3 * b * t * h * k + 2 * b * t * h * v + h * k
                   + 2 * b * h * k * v)
    return {'ok': wkv_close(y, want[0], WKV_TOL)
            and wkv_close(s, want[1], WKV_TOL),
            'err': max(max_err(y, want[0]), max_err(s, want[1])),
            'ms': timer(lambda: wkv6(*xs)),
            'plain_ms': timer(lambda: wkv6_tiled_ref(*xs)),
            'bound': bound(n_bytes, 4 * k * v * b * t * h, F32_FLOPS_PER_S)}


def wkv_vocab_check(card: str) -> dict:
    """Phase 25: on phase 24's 16 ranks, (data 1, model 16), at published
    widths: rwkv6-3b (40 wkv heads of 64) at 2 of 32 layers, each rank
    holding channels [4r, 4r + 4) of every head's values (``wkv_mode``
    'values'), and seamless-m4t-medium at 2 + 2 of 12 + 12 layers, its
    embedding and head cut on d_model (``embed_cut``): each under
    :func:`placement_gates`' (a)-(d), rwkv6 with rank 1's group-norm
    squares unsummed planted, seamless with rank 1's head partial; (e)
    rwkv6's prefill through K6 on every rank's value block against the
    plain chunked path on that block: layer 0's state within WKV_TOL (1 +
    |x|), deeper states and the scores within max(1e-4, 2x the chunk-64
    null); K6 timed at :data:`WV_K6` in this process.  Returns the
    phase's launches (every rank's: K6's of (e) only)."""
    from repro_torch.kernels.common import LAUNCHES

    gc.collect()
    torch.cuda.empty_cache()
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    failed, ranks_all = [], []
    for arch, layers, fault, seed, placed in WV_RUNS:
        cfg = family_cut(arch, layers)
        t0, started = time.perf_counter(), time.time()
        ranks = on_ranks(placement_rank, int(np.prod(HD_SHAPE)),
                         (cfg, DEV, fault, seed), HD_TIMEOUT_S)
        failed += placement_gates(card, arch, layers, ranks, fault, started,
                                  t0)
        if not all(r['placement'] == [placed] * 2 for r in ranks):
            failed.append((arch, 'placement', ranks[0]['placement']))
        if 'k6' in ranks[0]:
            k6 = [r['k6'] for r in ranks]
            worst = lambda i, j: max(x['states'][i][j]  # noqa: E731
                                     for x in k6)
            deep = max(max(s[0] for s in x['states'][1:]) for x in k6)
            deep_null = max(max(s[1] for s in x['states'][1:]) for x in k6)
            scores = max(x['scores'][0] for x in k6)
            scores_null = max(x['scores'][1] for x in k6)
            ok = (all(x['state0'][1] for x in k6)
                  and all(x['launches'] == layers for x in k6)
                  and deep <= max(1e-4, 2 * deep_null)
                  and scores <= max(1e-4, 2 * scores_null))
            print(f'  (e) {arch} prefill B={HD_B} T={HD_S} through K6 on '
                  f'every rank\'s value block {k6[0]["block"]} (L, B, H, '
                  f'K, V/{HD_SHAPE[1]}), f32, against the plain chunked '
                  f'path on the '
                  f'same block: layer 0 state max abs err '
                  f'{max(x["state0"][0] for x in k6):.3e} (tol {WKV_TOL:g}'
                  f' (1 + |x|)), layer 0 of |max| {worst(0, 0):.3e}; deeper '
                  f'states {deep:.3e} (chunk-64 null {deep_null:.3e}), '
                  f'scores {scores:.3e} (null {scores_null:.3e}); launches '
                  f'a rank {sorted({x["launches"] for x in k6})} '
                  f'({"pass" if ok else "FAIL"})  [{card}]')
            if not ok:
                failed.append((arch, 'k6 block', k6[0]))
        ranks_all += ranks
    launches = rank_launches(ranks_all)
    # the comparison's and the timer's launches are no main-path launches
    timer = Timer()
    k6 = k6_block_time(timer)
    del timer
    LAUNCHES.update(dict.fromkeys(LAUNCHES, 0))
    print(f'  (e) K6 alone at (B, T, H, K, V) = {WV_K6}, f32: '
          f'{k6["ms"]:.4f} ms, its tiled plain model {k6["plain_ms"]:.4f} '
          f'ms, bound {k6["bound"][0]:.4f} ms ({k6["bound"][1]}), max abs '
          f'err {k6["err"]:.3e} ({"pass" if k6["ok"] else "FAIL"})  '
          f'[{card}]')
    if not k6['ok']:
        failed.append(('k6 alone', k6['err']))
    print(f'  hand-written kernel launches in the phase (every rank): '
          f'{launches}')
    assert not failed, failed
    assert launches['wkv6'] > 0 and not any(
        v for k, v in launches.items() if k != 'wkv6'), launches
    return launches


# ---------------------------------------------------------------------------
# Phase 26: the reference's placement of long_500k's one row under the
# serving variants, and the trainer's sequence split under TRAIN_RULES
# ---------------------------------------------------------------------------

LR_SHAPE = (2, 2)                  # (data, model): 4 gloo ranks sharing the
                                   # card; the one row divides over neither
                                   # batch axis
LR_RUNS = (('zamba2-2.7b', 12), ('rwkv6-3b', 2))   # published widths
LR_VARIANTS = ('serve_kv_dp', 'serve_seq', 'serve_dh')
LR_S, LR_POS0, LR_STEPS = FS_LONG_S, FS_LONG_POS0, 4   # phase 21's long KV:
                                   # under serve_seq 2 blocks of 8192 slots,
                                   # the steps across their boundary
LR_FAULT_STEPS = 2                 # a fault's steps: a wrong state written
                                   # at the first is read at the second
# a planted fault of each new collective (``tp.StepParallel``'s methods),
# where the run calls it (rwkv6-3b's 40 heads split over model 2 as its
# held wkv block does, so only zamba2's conv state gathers its computed
# blocks over model): name -> (arch, variant, what)
LR_FAULTS = {
    'unsummed_scores': ('zamba2-2.7b', 'serve_kv_dp',
                        'the long KV\'s head_dim partial scores not summed '
                        'over data'),
    'dropped_block': ('zamba2-2.7b', 'serve_seq',
                      'the first slot block\'s softmax state dropped'),
    'ungathered_output': ('zamba2-2.7b', 'serve_dh',
                          'the output\'s head and head_dim blocks not '
                          'gathered'),
    'ungathered_state': ('rwkv6-3b', 'serve_kv_dp',
                         'the wkv and shift states\' blocks not gathered '
                         'over data before the layer'),
    'unshared_state': ('zamba2-2.7b', 'serve_kv_dp',
                       'the computed conv blocks (a rank\'s heads\' channels '
                       'and its share of B and C) not gathered over model '
                       'after the layer'),
    'wrong_block': ('rwkv6-3b', 'serve_dh',
                    'the other data rank\'s state block written back')}
LR_TRAIN = ('qwen3-0.6b', 2)       # one f32 step, published widths
LR_TRAIN_B, LR_TRAIN_S = 4, 256    # 2 rows a data rank, 128 positions a
                                   # model rank
LR_TRAIN_TOL = 1e-5                # a gradient leaf, of its max (phase 19's)
LR_TIMEOUT_S = 420                 # bounds the phase's pooled ranks


def plant_long_row_fault(fault: str) -> callable:
    """One of :data:`LR_FAULTS`, or ``'swapped'`` (the trainer's sequence
    blocks gathered in the wrong order), in this rank's step; -> a
    function that takes it out."""
    from repro_torch.distributed import tp as tplib

    sp = tplib.StepParallel
    saved = [(sp, n, getattr(sp, n)) for n in (
        'head_dim_sum', 'seq_combine', 'output_gather', 'state_gather',
        'state_share', 'written_block')] + [(tplib, 'unshard',
                                            tplib.unshard)]
    unshard = tplib.unshard

    def repeated(self, x, axes):
        return x.expand(tuple(self.mesh.shape[a] for a in axes)
                        + tuple(x.shape))

    if fault == 'unsummed_scores':
        sp.head_dim_sum = lambda self, scores, axes: scores
    elif fault == 'dropped_block':
        def dropped(self, states, axes, order):
            parts = [tplib._in_block_order(self.axes_gather(t, axes), axes,
                                           order) for t in states]
            return tplib.cm.combine_partials(*(x[1:] for x in parts))
        sp.seq_combine = dropped
    elif fault == 'ungathered_output':
        sp.output_gather = repeated
    elif fault == 'ungathered_state':
        sp.state_gather = repeated
    elif fault == 'unshared_state':
        sp.state_share = lambda self, new: repeated(self, new, ('model',))
    elif fault == 'wrong_block':
        sp.written_block = lambda self, keys: self.moved_block(keys, dict(
            self.coords, data=1 - self.coords['data']))
    elif fault == 'swapped':
        tplib.unshard = lambda parts, sizes, entries: unshard(
            parts.flip(0), sizes, entries)

    def restore():
        for o, n, f in saved:
            setattr(o, n, f)
    return restore


def long_row_serve(arch: str, model, mesh, dev: str, lead: bool) -> dict:
    """Phase 26's serve runs of ``arch`` on this rank: the meshless step on
    rank 0, then each variant's step and its planted faults from a fresh
    block of one seeded random cache; the rank's cache bytes beside the
    dry-run's count of its blocks under the reference's specs (f32, as
    the cache here)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import RULE_VARIANTS
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import describe
    from repro_torch.training.train_step import make_serve_step
    from repro_torch.training.tree import leaves_with_paths, tree_map

    cfg = model.cfg
    shape = ShapeConfig('long_500k', LR_S, 1, 'decode')
    params = f32_params(model.init_params(0, device=dev), dev)
    gen = torch.Generator(device=dev).manual_seed(26)
    cache = model.init_cache(shape, device=dev, dtype=torch.float32)
    for _, leaf in leaves_with_paths(cache):
        leaf.normal_(generator=gen).mul_(0.5)
    rng = np.random.default_rng(26)
    batches = [on_device({'tokens': rng.integers(1, cfg.vocab_size, 1)
                          .astype(np.int32),
                          'positions': np.full((1,), LR_POS0 + i, np.int32)})
               for i in range(LR_STEPS)]
    out = {'variants': {}, 'faults': {}}
    if lead:
        whole = make_serve_step(model, None, shape)[0]
        copy = tree_map(torch.clone, cache)
        want, secs = timed_calls([(whole, params, copy, b) for b in batches])
        out['meshless'] = [w.cpu().numpy() for w in want]
        out['meshless_s'] = secs
        del copy
    for variant in LR_VARIANTS:
        rules = RULE_VARIANTS[variant]
        step = make_serve_step(model, mesh, shape, rules=rules)[0]
        plan = step.plan
        blocks = plan.shard_params(params)
        runs = [(None, LR_STEPS)] + [
            (f, LR_FAULT_STEPS) for f, (a, v, _) in LR_FAULTS.items()
            if (a, v) == (arch, variant)]
        for fault, n in runs:
            mine = plan.shard_cache(cache)
            restore = (plant_long_row_fault(fault) if fault
                       else (lambda: None))
            try:
                got, secs = timed_calls([(step, blocks, mine,
                                          plan.shard_batch(b))
                                         for b in batches[:n]])
            finally:
                restore()
            full = [full_scores(plan, g).cpu().numpy() for g in got]
            if fault:
                out['faults'][fault] = full
                continue
            counted = {}
            dryrun.argument_bytes(model, shape, describe(LR_SHAPE, MESH_AXES),
                                  rules, coords=mesh.coords(),
                                  leaves=counted)
            out['variants'][variant] = {
                'scores': full, 's': secs, 'moved': plan.moved,
                'cache_bytes': sum(t.numel() * t.element_size()
                                   for _, t in leaves_with_paths(mine)),
                'reference_cache': sum(
                    counted[('cache', p)] // leaf.dtype.itemsize * 4
                    for p, leaf in dryrun._template_leaves(
                        model.cache_template(shape))),
                'blocks': {k: tuple(t.shape)
                           for k, t in leaves_with_paths(mine)}}
            del mine
        del blocks
    return out


def long_row_train(mesh, dev: str, lead: bool) -> dict:
    """Phase 26's training step on this rank: qwen3-0.6b at
    :data:`LR_TRAIN`'s depth under ``TRAIN_RULES`` (the sequence split),
    under ``TRAIN_NO_SP_RULES`` and under the ``'swapped'`` fault; each
    gradient block against rank 0's meshless one, scattered to the rank
    and compared on the card; the rank's batch bytes beside the
    reference's ``batch_specs`` blocks."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import TRAIN_NO_SP_RULES
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import describe
    from repro_torch.models.api import build_model
    from repro_torch.training import tree as tr
    from repro_torch.training.train_step import (
        TrainPlan, batch_specs, loss_and_grads, make_train_step,
        mesh_loss_and_grads, shard_batch)

    dist = torch.distributed
    cfg = family_cut(*LR_TRAIN)
    model = build_model(cfg)
    host = masked_batch(cfg, LR_TRAIN_B, LR_TRAIN_S)
    drawn = model.init_params(0, device=dev)
    out, runs = {}, {}
    t0 = time.perf_counter()
    for name, rules, fault in (('split', None, None),
                               ('no_sp', TRAIN_NO_SP_RULES, None),
                               ('swapped', None, 'swapped')):
        plan = make_train_step(model, mesh, rules=rules).plan
        params = plan.shard_params(f32_params(drawn, dev))
        rows = shard_batch(host, plan)
        restore = plant_long_row_fault(fault) if fault else (lambda: None)
        try:
            loss, grads = mesh_loss_and_grads(model, plan, params, rows)
        finally:
            restore()
        runs[name] = (float(loss), {k: g.detach() for k, g in
                                    tr.leaves_with_paths(grads)})
        if name == 'split':
            out['batch'] = {k: v.numel() * v.element_size()
                            for k, v in rows.items()}
            out['batch_shapes'] = {k: tuple(v.shape)
                                   for k, v in rows.items()}
        del params, rows, grads
    torch.cuda.synchronize()
    out['mesh_s'] = time.perf_counter() - t0
    tshape = ShapeConfig('train', LR_TRAIN_S, LR_TRAIN_B, 'train')
    desc = describe(LR_SHAPE, MESH_AXES)
    specs = batch_specs(model, tshape, desc)
    out['reference_batch'] = {
        k: dryrun._block_bytes(s.shape, s.dtype, specs[k].spec, desc,
                               mesh.coords())
        for k, s in model.input_specs(tshape).items()}
    split, no_sp = runs['split'], runs['no_sp']
    out['bit_equal'] = split[0] == no_sp[0] and all(
        torch.equal(g, no_sp[1][k]) for k, g in split[1].items())
    out['loss'], out['swapped_loss'] = split[0], runs['swapped'][0]
    want = {}
    if lead:
        batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        loss, grads = loss_and_grads(model, f32_params(drawn, dev), batch)
        want = {'loss': float(loss),
                'grads': {k: g.cpu() for k, g in
                          tr.leaves_with_paths(grads)}}
        out['meshless_loss'] = want['loss']
        del batch, grads
    plans = ([TrainPlan(model, mesh, coords=mesh.coords(r))
              for r in range(mesh.size)] if lead else None)
    errors = {}
    for k, local in split[1].items():
        mine = scatter_from_lead(
            [p.param_blocks[k].take(want['grads'][k]) for p in plans]
            if lead else None, local)
        top = mine.abs().max()
        dist.all_reduce(top, op=dist.ReduceOp.MAX)
        errors[k] = float((local - mine).abs().max() / top)
    out['errors'] = errors
    return out


def long_row_rank(rank: int, dev: str) -> dict:
    """Phase 26 on one of the LR_SHAPE ranks sharing the card: each of
    :data:`LR_RUNS` under each variant (:func:`long_row_serve`), then the
    training step (:func:`long_row_train`).  Returns every score, time,
    cache and batch count, error and kernel launch of the rank."""
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    LAUNCHES.update(dict.fromkeys(LAUNCHES, 0))
    mesh = make_mesh(LR_SHAPE, MESH_AXES, device=dev)
    out = {'serve': {}}
    for arch, layers in LR_RUNS:
        t0 = time.perf_counter()
        out['serve'][arch] = long_row_serve(arch, build_model(family_cut(
            arch, layers)), mesh, dev, rank == 0)
        out['serve'][arch]['s'] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    out['train'] = long_row_train(mesh, dev, rank == 0)
    out['launches'] = dict(LAUNCHES)
    return out


def long_row_check(card: str) -> dict:
    """Phase 26: :func:`long_row_rank` on 4 pooled ranks sharing the card,
    and its gates: each variant's f32 scores within FS_TOL of |max| of the
    meshless step with argmax equal, every rank's scores bit-equal, every
    rank's cache the dry-run's count of its block under the reference's
    specs; each planted fault past FS_TOL; the training step's batch bytes
    the reference's, its loss within 1e-6 relative and every gradient leaf
    within :data:`LR_TRAIN_TOL` of its max of the meshless step's,
    bit-equal to the step under ``TRAIN_NO_SP_RULES``, the swapped
    sequence past 100x the loss gate; no kernel launched.  Returns the
    phase's launches (every rank's)."""
    from repro_torch.kernels.common import LAUNCHES

    gc.collect()
    torch.cuda.empty_cache()
    LAUNCHES.update(dict.fromkeys(LAUNCHES, 0))
    t0 = time.perf_counter()
    ranks = on_ranks(long_row_rank, int(np.prod(LR_SHAPE)), (DEV,),
                     LR_TIMEOUT_S)
    failed = []
    for arch, layers in LR_RUNS:
        runs = [r['serve'][arch] for r in ranks]
        want = runs[0]['meshless']
        print(f'  {arch} ({layers} layers) long_500k, {LR_S} slots, B=1, '
              f'{LR_STEPS} decode steps from {LR_POS0}: the meshless step '
              f'{sum(runs[0]["meshless_s"]):.2f} s; every rank '
              f'{max(r["s"] for r in runs):.1f} s  [{card}]')
        for variant in LR_VARIANTS:
            res = [r['variants'][variant] for r in runs]
            gaps = [float(np.abs(g - w).max() / np.abs(w).max())
                    for g, w in zip(res[0]['scores'], want)]
            equal = all(np.array_equal(g.argmax(-1), w.argmax(-1))
                        for g, w in zip(res[0]['scores'], want))
            same = all(np.array_equal(a, b) for r in res[1:]
                       for a, b in zip(res[0]['scores'], r['scores']))
            counted = [(r['cache_bytes'], r['reference_cache'])
                       for r in res]
            ok = (max(gaps) <= FS_TOL and equal and same
                  and all(a == b for a, b in counted)
                  and all(r['moved'] for r in res))
            print(f'  {arch} {variant}: f32 scores of |max| '
                  f'{max(gaps):.3e} (tol {FS_TOL:g}), argmax equal '
                  f'{equal}, every rank bit-equal {same}; cache bytes a '
                  f'rank {sorted({c[0] for c in counted})} (the reference\'s'
                  f' {sorted({c[1] for c in counted})}), blocks '
                  f'{res[0]["blocks"]}; steps {np.round(res[0]["s"], 3)} s '
                  f'({"pass" if ok else "FAIL"})  [{card}]')
            if not ok:
                failed.append((arch, variant, gaps, equal, same, counted))
        for fault, (a, variant, what) in LR_FAULTS.items():
            if a != arch:
                continue
            err = max(float(np.abs(g - w).max() / np.abs(w).max())
                      for r in runs for g, w in zip(r['faults'][fault], want))
            caught = err > FS_TOL
            print(f'  planted fault, {arch} {variant}: {what}: scores of '
                  f'|max| {err:.3e} (gate {FS_TOL:g}: '
                  f'{"fails the gate, as it must" if caught else "PASSES"})'
                  f'  [{card}]')
            if not caught:
                failed.append((arch, fault, err))
    train = [r['train'] for r in ranks]
    lead = train[0]
    loss_rel = abs(lead['loss'] / lead['meshless_loss'] - 1)
    swapped = abs(lead['swapped_loss'] / lead['meshless_loss'] - 1)
    worst = max(max(t['errors'].values()) for t in train)
    bytes_ok = all(t['batch'][k] == t['reference_batch'][k]
                   for t in train for k in t['reference_batch'])
    ok = (loss_rel <= 1e-6 and worst <= LR_TRAIN_TOL and bytes_ok
          and all(t['bit_equal'] for t in train)
          and len({t['loss'] for t in train}) == 1)
    print(f'  training: {LR_TRAIN[0]} ({LR_TRAIN[1]} layers) at {LR_SHAPE}, '
          f'B={LR_TRAIN_B}, S={LR_TRAIN_S}, f32, TRAIN_RULES: batch a rank '
          f'{lead["batch_shapes"]}, {sorted(lead["batch"].items())} bytes '
          f'(the reference\'s {sorted(lead["reference_batch"].items())}); '
          f'loss rel {loss_rel:.3e}, worst gradient leaf {worst:.3e} (tol '
          f'{LR_TRAIN_TOL:g}), bit-equal to TRAIN_NO_SP_RULES\' step '
          f'{all(t["bit_equal"] for t in train)}; the three steps '
          f'{max(t["mesh_s"] for t in train):.1f} s '
          f'({"pass" if ok else "FAIL"})  [{card}]')
    print(f'  planted fault, training: the sequence blocks gathered in the '
          f'wrong order: loss rel {swapped:.3e} (gate 1e-06: '
          f'{"fails the gate, as it must" if swapped > 1e-4 else "PASSES"})'
          f'  [{card}]')
    if not ok:
        failed.append(('train', loss_rel, worst, bytes_ok))
    if swapped <= 1e-4:
        failed.append(('train fault', swapped))
    launches = rank_launches(ranks)
    print(f'  hand-written kernel launches in the phase (every rank): '
          f'{launches}; the phase {time.perf_counter() - t0:.1f} s')
    assert not failed, failed
    assert not any(launches.values()), launches
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
                    help='also profile the node, prefill, rwkv6, MoE '
                         'decode, training-step and zamba2 runs (device '
                         'time by kernel)')
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
    start_mutant_builds()
    kc.kernel_library()
    for name in MUTANTS:       # no compiler runs beside phase 3's timing
        mutant_library(name)
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
        del node
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
    print(f'[13] MoE: {MOE_ARCH} at published widths, {MOE_LAYERS} of 32 '
          f'layers: engine drain (plain path vs kernel path) and the node '
          f'beside online qwen3-0.6b')
    by_phase['moe'], failed = moe_check(card, args.trace)
    witnessed += failed
    done()

    print(f'[14] training: {TRAIN_ARCH} full width, B={TRAIN_B}, '
          f'S={TRAIN_S}, {TRAIN_STEPS} steps, restart, f32 parity with the '
          f'CPU, the CLI')
    by_phase['train'] = train_check(card, args.trace)
    done()

    print(f'[15] {HYBRID_ARCH} and {ENCDEC_ARCH}: full width f32 '
          f'prefill/decode identity, the SSD, f32 card vs CPU, bf16 '
          f'serving, a training step each')
    by_phase['hybrid_encdec'] = hybrid_encdec_check(card, args.trace)
    done()

    print(f'[16] mesh: {MESH_ARCH} at published widths, {MESH_BF16_LAYERS} '
          f'of 28 layers, tensor-parallel over 1 rank (NCCL) and 2 ranks '
          f'sharing the card (gloo)')
    by_phase['mesh'], failed = mesh_check(card)
    witnessed += failed
    done()

    start_ranks(int(np.prod(DP_SHAPES[1])), MESH_TIMEOUT_S)   # phase 18's
    print(f'[17] training over a mesh: {TRAIN_ARCH}, f32 parity at '
          f'{MT_LAYERS} layers over (2, 1) and (1, 2), bf16 data-parallel at '
          f'{DP_LAYERS} layers with a shrink to one rank, the compressed '
          f'all-reduce')
    by_phase['train_mesh'] = mesh_train_check(card)
    done()

    print(f'[18] data- and expert-parallel serving: {MESH_ARCH} on (data, '
          f'model) = {DP_SHAPES[0]} and {DP_SHAPES[1]} (K1-K4 on each '
          f'rank\'s rows and blocks), {MOE_ARCH} over {EP_SHAPE}, K4 on '
          f'{K4_BLOCKS} vocabulary blocks, MoE training over {EP_SHAPE}')
    by_phase['mesh_dp_ep'], failed = dp_ep_check(card)
    close_pools((int(np.prod(DP_SHAPES[1])),))
    witnessed += failed
    done()

    print(f'[19] training over a mesh, the other families: '
          f'{", ".join(f"{a} ({n} layers)" for a, n in FM_FAMILIES)} at '
          f'published widths, tensor-parallel over {FM_SHAPE}: f32 parity, '
          f'bf16 steps')
    by_phase['family_mesh'] = family_mesh_check(card)
    done()


    print(f'[20] serve step: {SERVE_ARCH} at published widths, '
          f'make_serve_step over the region KV layout against the global '
          f'pool (f32, bf16), run_cell measured, two production records of '
          f'the dry-run')
    by_phase['serve_step'] = serve_step_check(card)
    done()

    print(f'[21] serve step on a mesh, the other families: '
          f'{", ".join(f"{a} ({n} layers)" for a, n in FM_FAMILIES)} at '
          f'published widths over {FS_SHAPE} (f32, bf16), zamba2 long_500k '
          f'over {FS_LONG_SHAPE}, K6 over a rank\'s heads, '
          f'{len(FS_CELLS)} production cells measured')
    by_phase['family_serve'] = family_serve_check(card)
    done()

    print(f'[22] serve step under the rule variants '
          f'{", ".join(VS_VARIANTS)}: '
          f'{", ".join(f"{a} ({n} layers)" for a, n in VS_FAMILIES)} at '
          f'published widths over {FS_SHAPE} (f32, bf16, planted faults), '
          f'{VS_CELL[0]} x {VS_CELL[1]} rank 0 measured under each')
    by_phase['variant_serve'] = variant_serve_check(card)
    done()

    start_ranks(int(np.prod(HD_SHAPE)), HD_TIMEOUT_S)     # phase 24's
    runs = '; '.join(f'{a} ({n} layers: ' + ', '.join(v) + ')'
                     for a, n, v in VT_RUNS)
    print(f'[23] training under the rule variants: {runs} at published '
          f'widths over {FM_SHAPE} (f32 parity, planted faults, bf16 '
          f'steps)')
    by_phase['variant_train'] = variant_train_check(card)
    close_pools(POOLED)
    done()

    print(f'[24] the reference\'s head_dim placement where model does not '
          f'divide the heads: {HD_ARCH} ({HD_LAYERS} layers) at published '
          f'widths over {HD_SHAPE} ({int(np.prod(HD_SHAPE))} ranks sharing '
          f'the card): serve step f32 and bf16, a planted fault, cache '
          f'bytes, one f32 training step')
    by_phase['head_dim'], by_phase['engine_pair_cut'] = head_dim_check(card)
    done()

    start_ranks(int(np.prod(LR_SHAPE)), LR_TIMEOUT_S)     # phase 26's
    print(f'[25] the reference\'s placement where model does not divide '
          f'rwkv6\'s wkv heads or the vocabulary: '
          f'{", ".join(f"{a} ({n} layers)" for a, n, *_ in WV_RUNS)} at '
          f'published widths over {HD_SHAPE} on phase 24\'s ranks: serve '
          f'step f32 and bf16, a planted fault each, cache bytes, one f32 '
          f'training step (rwkv6\'s also under a planted fault), K6 on '
          f'every rank\'s value block')
    by_phase['wkv_vocab'] = wkv_vocab_check(card)
    close_pools((int(np.prod(HD_SHAPE)),))
    done()

    print(f'[26] the reference\'s placement of long_500k\'s one row, which '
          f'no batch axis divides: '
          f'{", ".join(f"{a} ({n} layers)" for a, n in LR_RUNS)} at '
          f'published widths over {LR_SHAPE} ({int(np.prod(LR_SHAPE))} '
          f'ranks sharing the card) under {", ".join(LR_VARIANTS)}, f32, '
          f'planted faults, cache bytes; one f32 training step of '
          f'{LR_TRAIN[0]} ({LR_TRAIN[1]} layers) with its sequence split '
          f'over model')
    by_phase['long_row'] = long_row_check(card)
    close_pools()
    done()

    print(f'[27] total {time.perf_counter() - t_start:.1f} s')
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
    try:
        sys.exit(main())
    finally:
        close_pools()
