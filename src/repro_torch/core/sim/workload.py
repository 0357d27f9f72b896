"""Workload models for the colocation simulator (paper §7.2 methodology:
"sample 10 online/offline workload pairs from production and replay").

Online traces are bursty in compute and/or KV memory (paper Fig. 2–3): a
Poisson background with periodic burst windows; prompt/output lengths
lognormal.  The 10 pairs sweep burstiness (compute-CV and memory-CV) so the
strategy comparison reproduces the paper's spread — including the 4
memory-bursty workloads where Prism/StaticMem degrade.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np


@dataclass(frozen=True)
class OnlineRequest:
    req_id: str
    t_arrive: float
    prompt_tokens: int
    output_tokens: int


@dataclass
class OnlineWorkload:
    name: str
    requests: List[OnlineRequest]
    horizon_s: float


@dataclass(frozen=True)
class OfflineWorkload:
    """A continuous batch-inference job (throughput SLA, no latency SLA).

    ``prompt_choices``/``output_choices``: per-request size mixes — varied
    sizes fragment the handle space (the condition Algorithm 1 exploits).

    ``shared_prefix_tokens``: every request's prompt starts with the same
    ``shared_prefix_tokens``-token system prompt (the HyGen-style dominant
    harvest workload).  Lease-capable memory policies attach the published
    prefix pages copy-on-write instead of re-prefilling them; whole-request
    policies just see the prompt length.
    """
    name: str
    prompt_tokens: int = 512        # per request (mean when mixed)
    output_tokens: int = 256
    max_batch: int = 48             # requests in flight if memory allows
    prompt_choices: tuple = ()
    output_choices: tuple = ()
    shared_prefix_tokens: int = 0
    seed: int = 0


@dataclass(frozen=True)
class WorkloadPair:
    name: str
    online: OnlineWorkload
    offline: OfflineWorkload
    # burstiness knobs recorded for the report
    compute_cv: float = 0.0
    memory_bursty: bool = False


def make_online_trace(*, name: str, horizon_s: float = 600.0,
                      base_rate: float = 0.5, burst_rate: float = 6.0,
                      burst_every_s: float = 120.0, burst_len_s: float = 10.0,
                      prompt_mean: int = 512, prompt_sigma: float = 0.8,
                      out_mean: int = 96, seed: int = 0,
                      ramp_at_s: float = None,
                      ramp_mult: float = 1.0) -> OnlineWorkload:
    """Bursty Poisson trace.  ``ramp_at_s``/``ramp_mult`` make the trace
    non-stationary: all rates multiply by ``ramp_mult`` from ``ramp_at_s``
    on — the "deceptive node" the cluster monitoring loop exists for (looks
    harvestable when scouted, then its online service heats up)."""
    rng = np.random.default_rng(seed)
    reqs: List[OnlineRequest] = []
    t = 0.0
    i = 0
    while t < horizon_s:
        in_burst = (t % burst_every_s) < burst_len_s
        rate = burst_rate if in_burst else base_rate
        ramped = ramp_at_s is not None and t >= ramp_at_s
        if ramped:
            rate *= ramp_mult
        gap = float(rng.exponential(1.0 / max(rate, 1e-9)))
        if ramp_at_s is not None and not ramped and t + gap > ramp_at_s:
            # a quiet-period gap that crosses the ramp boundary must not
            # skip the ramp: by memorylessness, restart the draw at the
            # boundary with the ramped rate
            t = ramp_at_s
            continue
        t += gap
        if t >= horizon_s:
            break
        prompt = int(np.clip(rng.lognormal(math.log(prompt_mean),
                                           prompt_sigma), 16, 32768))
        out = max(1, int(rng.geometric(1.0 / out_mean)))
        reqs.append(OnlineRequest(f'{name}-r{i}', t, prompt, out))
        i += 1
    return OnlineWorkload(name, reqs, horizon_s)


def slice_trace(w: OnlineWorkload, t0: float, t1: float) -> OnlineWorkload:
    """Epoch window [t0, t1) of a trace, rebased to epoch-local time —
    the cluster harness replays one epoch slice per scheduling round."""
    reqs = [OnlineRequest(r.req_id, r.t_arrive - t0,
                          r.prompt_tokens, r.output_tokens)
            for r in w.requests if t0 <= r.t_arrive < t1]
    return OnlineWorkload(f'{w.name}@{t0:g}', reqs, t1 - t0)


# ---------------------------------------------------------------------------
# Fleet generator (cluster plane, paper §6): heterogeneous online services
# across nodes, with per-node GPU alignment structure
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class NodeWorkload:
    """One node's online side: a trace per GPU.

    ``aligned`` nodes run one service replicated across GPUs (arrivals
    jittered by ≲0.2 s → busy intervals overlap, P_multi high); unaligned
    nodes run independent services per GPU (P_multi low — the 0.95
    admission gate must reject multi-GPU offline jobs there).
    """
    name: str
    gpu_traces: Tuple[OnlineWorkload, ...]
    aligned: bool


def make_fleet_workloads(n_nodes: int = 8, gpus_per_node: int = 2, *,
                         horizon_s: float = 240.0, seed: int = 0,
                         n_ramp_nodes: int = 1, ramp_at_s: float = None,
                         ramp_mult: float = 60.0,
                         aligned_frac: float = 0.68) -> List[NodeWorkload]:
    """Heterogeneous trace mix for a simulated fleet.

    The first ``n_ramp_nodes`` nodes are quiet until ``ramp_at_s`` (default:
    a quarter of the horizon) and then heat up by ``ramp_mult`` — jobs the
    scheduler places there from scout-epoch telemetry will start violating
    their SLA, driving the eviction/reschedule path.

    Seeding is isolated per node (``SeedSequence.spawn``): node *i*'s trace
    depends only on ``(seed, i)``, so a 100-node fleet is byte-reproducible
    and growing ``n_nodes`` never re-rolls the existing nodes.
    """
    children = np.random.SeedSequence(seed).spawn(n_nodes)
    if ramp_at_s is None:
        ramp_at_s = horizon_s / 4.0
    nodes: List[NodeWorkload] = []
    for i in range(n_nodes):
        rng = np.random.default_rng(children[i])
        ramping = i < n_ramp_nodes
        aligned = ramping or bool(rng.random() < aligned_frac)
        base = 0.03 + 0.02 * float(rng.random())
        kw = dict(
            horizon_s=horizon_s,
            base_rate=(0.015 if ramping else base),
            burst_rate=(0.2 if ramping else 2.0 + 2.0 * float(rng.random())),
            burst_every_s=45.0 + 10.0 * (i % 4),
            burst_len_s=5.0 + 1.0 * (i % 3),
            prompt_mean=int(rng.choice([256, 512, 2048])),
            prompt_sigma=0.6,
            out_mean=int(rng.choice([32, 48, 64])),
            ramp_at_s=(ramp_at_s if ramping else None),
            ramp_mult=(ramp_mult if ramping else 1.0))
        traces = []
        if aligned:
            # one service, replicated: same request stream, small per-GPU
            # arrival jitter (scatter-gather fan-out skew)
            base_trace = make_online_trace(
                name=f'n{i}', seed=int(rng.integers(0, 2**31)), **kw)
            for g in range(gpus_per_node):
                # jitter ≪ request service time, so measured busy-interval
                # alignment stays above the 0.95 admission gate
                jit = rng.normal(0.0, 0.015, size=len(base_trace.requests))
                reqs = [OnlineRequest(f'{r.req_id}-g{g}',
                                      min(max(r.t_arrive + float(j), 0.0),
                                          horizon_s - 1e-6),
                                      r.prompt_tokens, r.output_tokens)
                        for r, j in zip(base_trace.requests, jit)]
                reqs.sort(key=lambda r: r.t_arrive)
                traces.append(OnlineWorkload(f'n{i}g{g}', reqs, horizon_s))
        else:
            for g in range(gpus_per_node):
                traces.append(make_online_trace(
                    name=f'n{i}g{g}', seed=int(rng.integers(0, 2**31)), **kw))
        nodes.append(NodeWorkload(f'node{i}', tuple(traces), aligned))
    return nodes


def make_workload_pairs(n: int = 10, *, horizon_s: float = 600.0,
                        seed: int = 0) -> List[WorkloadPair]:
    """10 production-shaped pairs sweeping compute/memory burstiness."""
    pairs: List[WorkloadPair] = []
    rng = np.random.default_rng(seed)
    for i in range(n):
        mem_bursty = i % 2 == 0            # half the pairs memory-bursty
        burst_rate = 3.0 + 0.8 * i          # increasing compute burstiness
        prompt_mean = 2048 if mem_bursty else 256
        prompt_sigma = 1.1 if mem_bursty else 0.5
        # background duty ≈ rate × lifetime ≈ 0.05..0.14 × ~2 s → 10–30%:
        # utilization switches between idle and fully-busy (paper Fig. 3),
        # which is the idle capacity colocation exists to harvest
        online = make_online_trace(
            name=f'online{i}', horizon_s=horizon_s,
            base_rate=0.05 + 0.01 * i,
            burst_rate=burst_rate,
            burst_every_s=60.0 + 10.0 * i,
            burst_len_s=6.0 + 1.5 * i,
            prompt_mean=prompt_mean, prompt_sigma=prompt_sigma,
            out_mean=40 + 12 * (i % 3),
            seed=int(rng.integers(0, 2**31)))
        offline = OfflineWorkload(
            name=f'offline{i}',
            prompt_tokens=int(rng.choice([256, 512, 1024])),
            output_tokens=int(rng.choice([128, 256, 512])),
            max_batch=48)
        cv = burst_rate / (0.3 + 0.05 * i)
        pairs.append(WorkloadPair(f'pair{i}', online, offline,
                                  compute_cv=cv, memory_bursty=mem_bursty))
    return pairs
