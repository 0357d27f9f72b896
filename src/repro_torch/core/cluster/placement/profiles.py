"""GPU profile catalog + interconnect topology for a heterogeneous fleet.

``GPUProfile`` is catalog *data* (the Helix ``machine_profiles`` idiom): a
memory fraction and a normalized-throughput scalar relative to the
reference GPU the workload profiles were measured on, plus the intra-node
link the card sits behind.  ``scale_sim`` derives the per-GPU ``SimConfig``
so the harness *measures* a slow card being slow — the catalog scalar then
re-enters Eq. 1 as a multiplier so predictions stay in the same normalized
units as achieved throughput.

``TopologyModel`` prices the links a placement crosses: NVLink/PCIe inside
a node, node-local vs cross-rack between nodes (the Baichuan
topology-aware-scheduling motivation).  Multi-GPU lockstep jobs pay the
intra-node efficiency of the node they land on; the disagg plane asks
``cheapest_pair`` where to put the prefill→decode handoff copy.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.sim.colocation import SimConfig

# relative cost of moving KV bytes across each link tier (lower = cheaper);
# the absolute scale is arbitrary — only the ordering and ratios matter to
# placement decisions
LINK_COSTS: Dict[str, float] = {
    'nvlink': 1.0,       # intra-node NVLink
    'pcie': 4.0,         # intra-node PCIe
    'node-local': 12.0,  # different nodes, same rack (ToR switch)
    'cross-rack': 40.0,  # rack-to-rack (spine)
}

# lockstep efficiency of a multi-GPU job behind each intra-node link: the
# all-reduce per decode step is latency-bound, so PCIe shaves a few percent
# off the pair's effective throughput
INTRA_EFFICIENCY: Dict[str, float] = {'nvlink': 1.0, 'pcie': 0.94}


@dataclass(frozen=True)
class GPUProfile:
    """One catalog entry.  ``norm_throughput`` and ``mem_frac`` are relative
    to the reference GPU (the one workload profiles are measured on)."""
    model: str
    mem_frac: float          # KV pool size as a fraction of the reference
    norm_throughput: float   # step rate relative to the reference
    intra_link: str          # 'nvlink' | 'pcie'

    def scale_sim(self, base: SimConfig) -> SimConfig:
        """The per-GPU sim config this card actually runs: smaller KV pool,
        proportionally slower compute (host-side decode gap unchanged)."""
        return replace(
            base,
            total_pages=max(int(base.total_pages * self.mem_frac), 64),
            t_prefill_per_token=base.t_prefill_per_token / self.norm_throughput,
            t_decode_iter=base.t_decode_iter / self.norm_throughput)


GPU_CATALOG: Dict[str, GPUProfile] = {
    'A100': GPUProfile('A100', mem_frac=1.0, norm_throughput=1.0,
                       intra_link='nvlink'),
    'L4': GPUProfile('L4', mem_frac=0.5, norm_throughput=0.5,
                     intra_link='pcie'),
    'T4': GPUProfile('T4', mem_frac=0.375, norm_throughput=0.3,
                     intra_link='pcie'),
}


@dataclass
class TopologyModel:
    """Link-cost model over the fleet: node → rack and node → intra-link."""
    rack_of: Dict[str, int] = field(default_factory=dict)
    intra_link_of: Dict[str, str] = field(default_factory=dict)
    link_costs: Dict[str, float] = field(
        default_factory=lambda: dict(LINK_COSTS))

    def link_tier(self, a: str, b: str) -> str:
        if a == b:
            return self.intra_link_of.get(a, 'nvlink')
        if self.rack_of.get(a, 0) == self.rack_of.get(b, 1):
            return 'node-local'
        return 'cross-rack'

    def link_cost(self, a: str, b: str) -> float:
        return self.link_costs[self.link_tier(a, b)]

    def intra_efficiency(self, node: str) -> float:
        """Lockstep efficiency for a multi-GPU placement on ``node``."""
        return INTRA_EFFICIENCY[self.intra_link_of.get(node, 'nvlink')]

    def cheapest_pair(self, srcs: Sequence[str], dsts: Sequence[str]
                      ) -> Tuple[str, str, str, float]:
        """The (src, dst) node pair whose link is cheapest — where the
        disagg plane should put the prefill→decode handoff copy.  Distinct
        nodes preferred; src == dst (two pools on one node) is allowed only
        when it is the single option.  Deterministic: ties break on name.
        """
        assert srcs and dsts, 'need candidates on both sides'
        best = None
        for s in sorted(srcs):
            for d in sorted(dsts):
                if s == d and (len(srcs) > 1 or len(dsts) > 1):
                    continue
                c = self.link_cost(s, d)
                if best is None or c < best[3]:
                    best = (s, d, self.link_tier(s, d), c)
        return best


def make_fleet_profiles(node_names: Sequence[str], gpus_per_node: int, *,
                        mix: Sequence[Tuple[str, float]] = (
                            ('A100', 0.3), ('L4', 0.4), ('T4', 0.3)),
                        nodes_per_rack: int = 16,
                        seed: int = 0) -> Tuple[
                            Dict[str, Tuple[GPUProfile, ...]], TopologyModel]:
    """Assign catalog profiles to a fleet (homogeneous within a node, as in
    real procurement) and lay nodes out in racks.

    Seeding is isolated per node via ``SeedSequence.spawn`` — growing the
    fleet never re-rolls the profile of an existing node.
    """
    names = [m for m, _ in mix]
    weights = np.asarray([w for _, w in mix], dtype=float)
    weights = weights / weights.sum()
    children = np.random.SeedSequence(seed).spawn(len(node_names))
    profiles: Dict[str, Tuple[GPUProfile, ...]] = {}
    topo = TopologyModel()
    for i, name in enumerate(node_names):
        rng = np.random.default_rng(children[i])
        model = names[int(rng.choice(len(names), p=weights))]
        prof = GPU_CATALOG[model]
        profiles[name] = (prof,) * gpus_per_node
        topo.rack_of[name] = i // nodes_per_rack
        topo.intra_link_of[name] = prof.intra_link
    return profiles, topo
