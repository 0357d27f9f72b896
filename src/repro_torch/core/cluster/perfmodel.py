"""Offline-on-harvested-GPU performance model (paper §6, Eq. 1–2).

    Thrput(w,N) / Thrput(w,max) = P_compute · P_memory · P_multi

- ``P_compute``: idle compute fraction of the node (timeslices available to
  offline), measured by the colocation runtime.
- ``P_memory`` (Eq. 2): expected throughput over the node's free-memory
  trace through the workload's profiled memory→throughput curve, minus
  ``MAC_w · E[ΔM]`` for dips below the required memory.
- ``P_multi``: pairwise busy-time alignment across the node's GPUs —
  ``T_∩ / T_∪`` of busy intervals; model-parallel offline jobs run in
  lockstep, so misaligned online activity creates stragglers.  Admission
  requires every pair ≥ 0.95.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

import numpy as np

if TYPE_CHECKING:                                     # pragma: no cover
    from repro_torch.core.cluster.placement.profiles import GPUProfile

MULTI_ADMIT_THRESHOLD = 0.95


# ---------------------------------------------------------------------------
# Workload profile (measured once at submission)
# ---------------------------------------------------------------------------

@dataclass
class WorkloadProfile:
    """Memory→throughput curve + recompute sensitivity for one offline job."""
    name: str
    mem_points: np.ndarray          # available memory samples (pages)
    thrput_points: np.ndarray       # tokens/s at each sample
    m_req: float                    # memory for full throughput
    mac: float                      # Eq. 2 MAC_w: tokens/s lost per page of
                                    # expected deficit
    n_gpus: int = 1                 # model-parallel degree

    @property
    def thrput_max(self) -> float:
        return float(self.thrput_points[-1])

    def thrput_at(self, mem: np.ndarray) -> np.ndarray:
        return np.interp(mem, self.mem_points, self.thrput_points)


def profile_workload(name: str, *, thrput_max: float, m_req: float,
                     n_gpus: int = 1, mac: Optional[float] = None,
                     n_points: int = 8) -> WorkloadProfile:
    """Synthesize a concave saturating memory→throughput curve (the shape a
    profiling run of a batch-inference job produces: throughput ∝ batch
    size ∝ KV memory until compute-bound)."""
    mems = np.linspace(0, m_req * 1.5, n_points)
    sat = np.minimum(mems / m_req, 1.0) ** 0.7    # concave ramp, saturates
    thr = thrput_max * sat
    return WorkloadProfile(name, mems, thr, m_req,
                           mac if mac is not None else thrput_max / m_req,
                           n_gpus)


def profile_workload_from_curve(name: str, mem_points, thrput_points, *,
                                n_gpus: int = 1, sat_frac: float = 0.95,
                                mac: Optional[float] = None
                                ) -> WorkloadProfile:
    """Build a profile from a MEASURED memory→throughput sweep (e.g. a
    ``NodeSim`` run per pool size — see ``cluster.harness.
    profile_workload_from_sim``).

    ``m_req`` is the knee: the smallest measured memory reaching
    ``sat_frac`` of peak throughput.  ``mac`` (Eq. 2's tokens/s lost per
    page of deficit) defaults to the mean curve slope below the knee.
    """
    order = np.argsort(np.asarray(mem_points, dtype=float))
    mems = np.asarray(mem_points, dtype=float)[order]
    thrs = np.asarray(thrput_points, dtype=float)[order]
    assert len(mems) >= 2, 'need ≥2 sweep points'
    # enforce monotone non-decreasing throughput (more memory never hurts a
    # batch job; sim noise can produce tiny inversions)
    thrs = np.maximum.accumulate(thrs)
    peak = float(thrs[-1])
    sat_idx = int(np.argmax(thrs >= sat_frac * peak))
    m_req = float(mems[sat_idx])
    if mac is None:
        below = max(sat_idx, 1)
        rise = float(thrs[below] - thrs[0])
        run = max(float(mems[below] - mems[0]), 1e-9)
        mac = rise / run
    return WorkloadProfile(name, mems, thrs, m_req, float(mac), n_gpus)


# ---------------------------------------------------------------------------
# Node telemetry
# ---------------------------------------------------------------------------

@dataclass
class GPUTelemetry:
    """Busy intervals + free-memory trace for one GPU over a window.

    ``source`` records provenance: 'synthetic' for hand-written curves,
    'nodesim' when extracted from a real ``NodeSim`` run — the closed-loop
    harness tags (and its benchmark asserts) the latter, so no Eq. 1 input
    is hand-written.
    """
    busy_intervals: List[Tuple[float, float]]
    mem_trace_t: np.ndarray         # sample times
    mem_trace_free: np.ndarray      # free pages at each sample
    window: Tuple[float, float] = (0.0, 600.0)
    source: str = 'synthetic'
    # heterogeneous fleets: the catalog entry this GPU was measured under
    # (placement.profiles.GPUProfile); None = the reference GPU, scalar 1.0
    profile: Optional['GPUProfile'] = None

    def idle_fraction(self) -> float:
        t0, t1 = self.window
        busy = sum(min(b, t1) - max(a, t0)
                   for a, b in self.busy_intervals if b > t0 and a < t1)
        return max(0.0, 1.0 - busy / max(t1 - t0, 1e-9))


@dataclass
class NodeTelemetry:
    name: str
    gpus: List[GPUTelemetry]
    rack: int = 0                   # topology coordinate (placement plane)

    def free_gpu_indices(self) -> List[int]:
        return list(range(len(self.gpus)))


# ---------------------------------------------------------------------------
# The three factors
# ---------------------------------------------------------------------------

def p_compute(gpu: GPUTelemetry) -> float:
    return gpu.idle_fraction()


def p_memory(w: WorkloadProfile, gpu: GPUTelemetry) -> float:
    """Eq. 2 over the node's free-memory trace."""
    free = gpu.mem_trace_free
    e_thr = float(np.mean(w.thrput_at(free)))
    deficit = np.maximum(0.0, w.m_req - free)
    e_def = float(np.mean(deficit))
    val = (e_thr - w.mac * e_def) / max(w.thrput_max, 1e-9)
    return float(np.clip(val, 0.0, 1.0))


def _union_intersection(a: List[Tuple[float, float]],
                        b: List[Tuple[float, float]],
                        window: Tuple[float, float]) -> Tuple[float, float]:
    """(T_∩, T_∪) of two busy-interval sets over the window."""
    t0, t1 = window
    grid = sorted({t0, t1}
                  | {max(t0, min(x, t1)) for iv in a for x in iv}
                  | {max(t0, min(x, t1)) for iv in b for x in iv})

    def busy_at(ivs, lo, hi):
        mid = 0.5 * (lo + hi)
        return any(s <= mid < e for s, e in ivs)

    inter = union = 0.0
    for lo, hi in zip(grid, grid[1:]):
        if hi <= lo:
            continue
        ba, bb = busy_at(a, lo, hi), busy_at(b, lo, hi)
        if ba and bb:
            inter += hi - lo
        if ba or bb:
            union += hi - lo
    return inter, union


def p_multi(gpus: Sequence[GPUTelemetry]) -> float:
    """Minimum pairwise T_∩/T_∪ alignment score across the GPU set."""
    if len(gpus) <= 1:
        return 1.0
    score = 1.0
    for i in range(len(gpus)):
        for j in range(i + 1, len(gpus)):
            inter, union = _union_intersection(
                gpus[i].busy_intervals, gpus[j].busy_intervals,
                gpus[i].window)
            s = 1.0 if union == 0 else inter / union
            score = min(score, s)
    return score


def predict_normalized_throughput(w: WorkloadProfile,
                                  gpus: Sequence[GPUTelemetry]) -> float:
    """Eq. 1 for a candidate GPU set (len == w.n_gpus).

    Heterogeneous fleets: each GPU's catalog ``norm_throughput`` scalar
    rescales the prediction to the reference GPU the workload profile was
    measured on (lockstep jobs run at the slowest card's rate), keeping
    predictions in the same normalized units as achieved throughput.
    """
    pc = min(p_compute(g) for g in gpus)
    pm = min(p_memory(w, g) for g in gpus)
    px = p_multi(gpus)
    scale = min((g.profile.norm_throughput if g.profile is not None else 1.0)
                for g in gpus)
    return pc * pm * px * scale


def admissible(w: WorkloadProfile, gpus: Sequence[GPUTelemetry]) -> bool:
    if len(gpus) != w.n_gpus:
        return False
    return w.n_gpus == 1 or p_multi(gpus) >= MULTI_ADMIT_THRESHOLD
