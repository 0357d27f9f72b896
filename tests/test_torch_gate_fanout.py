"""Gate fan-out across N devices on the port's control plane: the
reference's ``tests/test_gate_fanout.py`` cases on the port's copies
(``core/gate.py``, ``core/runtime.py``, ``launch/node.py``), the gate count
following the port's :class:`~repro_torch.launch.mesh.Mesh`, and the
per-device preemption bound over an online burst on engines that run
tensor-parallel over a two-rank gloo mesh.

Under a VirtualClock the modeled flip latencies are deterministic:
fan-out group latency == max over devices, serial == sum, and the
per-device latencies folded into each PreemptionEvent let the bound
(<= 1 compute preemption per online request) be checked per device from the
event log alone.  This module imports no jax (the ranks import it).
"""
import numpy as np
import pytest

from repro_torch.configs import get_config, reduced
from repro_torch.core.clock import VirtualClock
from repro_torch.core.events import PreemptionEvent
from repro_torch.core.gate import DeviceGate, GateGroup
from repro_torch.core.runtime import RuntimeConfig, ValveRuntime
from repro_torch.distributed.tp import serve_rank, stop_ranks
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.launch.node import NodeOrchestrator
from repro_torch.launch.ranks import run_ranks
from repro_torch.serving.engine import EngineConfig
from repro_torch.serving.kvpool import KVPool

ARCH = 'qwen3-0.6b'
N_DEV = 4


def _gates(latencies, clock):
    return [DeviceGate(i, lat, clock=clock)
            for i, lat in enumerate(latencies)]


# ---------------------------------------------------------------------------
# GateGroup latency model (virtual clock: exact, deterministic)
# ---------------------------------------------------------------------------
def test_fanout_latency_is_max_over_devices():
    clock = VirtualClock()
    lats = [0.001 * (i + 1) for i in range(N_DEV)]       # 1..4 ms
    grp = GateGroup(_gates(lats, clock), mode='fanout', clock=clock)
    elapsed = grp.disable_all()
    assert elapsed == pytest.approx(max(lats))
    # each device records ITS OWN modeled flip latency, not the group max
    assert grp.last_flip_latencies == pytest.approx(tuple(lats))
    assert grp.all_disabled
    elapsed = grp.enable_all()
    assert elapsed == pytest.approx(max(lats))
    assert grp.last_flip_latencies == pytest.approx(tuple(lats))


def test_serial_latency_is_sum_over_devices():
    clock = VirtualClock()
    lats = [0.001 * (i + 1) for i in range(N_DEV)]
    grp = GateGroup(_gates(lats, clock), mode='serial', clock=clock)
    elapsed = grp.disable_all()
    assert elapsed == pytest.approx(sum(lats))
    assert grp.last_flip_latencies == pytest.approx(tuple(lats))
    assert grp.all_disabled


def test_fanout_vs_serial_scaling():
    """Serial grows linearly with device count, fan-out stays flat."""
    per_dev = 0.0008
    for n in (1, 2, 4, 8):
        cs, cf = VirtualClock(), VirtualClock()
        serial = GateGroup(_gates([per_dev] * n, cs), mode='serial',
                           clock=cs).disable_all()
        fanout = GateGroup(_gates([per_dev] * n, cf), mode='fanout',
                           clock=cf).disable_all()
        assert serial == pytest.approx(n * per_dev)
        assert fanout == pytest.approx(per_dev)


def test_real_clock_fanout_measures_per_device():
    """Real-clock fan-out issues concurrent flips; each worker returns a
    measured wall time >= 0 (exact values are noise, the shape is not)."""
    grp = GateGroup([DeviceGate(i) for i in range(N_DEV)], mode='fanout')
    try:
        grp.disable_all()
        assert len(grp.last_flip_latencies) == N_DEV
        assert all(t >= 0.0 for t in grp.last_flip_latencies)
        assert grp.all_disabled
    finally:
        grp.close()


# ---------------------------------------------------------------------------
# Runtime fold: PreemptionEvent carries per-device measured latencies
# ---------------------------------------------------------------------------
def _burst_node(rcfg, mesh=None):
    pool = KVPool(5, 4, page_size=4, reserved_handles=1)
    rt = ValveRuntime(pool, rcfg, clock=VirtualClock())
    node = NodeOrchestrator(rt, idle_advance=1e-3)
    cfg = reduced(get_config(ARCH), page_size=4)
    for klass, seed, name in (('online', 0, 'online'), ('offline', 1, 'off0')):
        node.add_engine(cfg, EngineConfig(max_batch=4, max_seq=48,
                                          prefill_chunk=8, klass=klass,
                                          mesh=mesh),
                        seed=seed, name=name, device='cpu')
    return node


def _burst(node) -> list:
    """Offline work, then an online request mid-flight; the preemption
    events of the drain."""
    rng = np.random.default_rng(7)
    eng = node.offline[0]
    for _ in range(2):
        eng.submit(rng.integers(1, eng.mcfg.vocab_size, 12).tolist(),
                   max_new_tokens=8)
    for _ in range(4):
        node.step()
    node.online.submit(
        rng.integers(1, node.online.mcfg.vocab_size, 28).tolist(),
        max_new_tokens=12)
    node.drain(max_steps=5000)
    return node.runtime.bus.events(PreemptionEvent)


def _per_device_requests(evs) -> dict:
    """Gates flip as a group, so device d preempts request r once per
    PreemptionEvent listing r."""
    per = {}
    for ev in evs:
        for rid in ev.requests:
            for d in range(len(ev.device_latencies_s)):
                per[rid, d] = per.get((rid, d), 0) + 1
    return per


def test_preemption_event_folds_device_latencies():
    node = _burst_node(RuntimeConfig(n_devices=N_DEV, t_cool_init=0.002,
                                     gate_op_latency_s=0.0005))
    evs = _burst(node)
    assert evs, 'burst produced no preemption'
    for ev in evs:
        # one measured flip latency per mesh device, fan-out == max
        assert len(ev.device_latencies_s) == N_DEV
        assert ev.latency_s == pytest.approx(max(ev.device_latencies_s))
        assert all(t == pytest.approx(0.0005) for t in ev.device_latencies_s)
    per = _per_device_requests(evs)
    assert per and max(per.values()) <= 1
    node.runtime.check_invariants()       # node-wide <= 1 + wakeup parity


def test_runtime_gate_count_follows_mesh():
    """RuntimeConfig.mesh overrides n_devices: one DeviceGate per mesh
    device, so the fan-out is the real flip across the serving mesh."""
    mesh = Mesh(np.arange(N_DEV), ('model',))
    pool = KVPool(4, 4, page_size=4)
    rt = ValveRuntime(pool, RuntimeConfig(n_devices=1, mesh=mesh),
                      clock=VirtualClock())
    assert rt.n_devices == N_DEV
    assert len(rt.gates.gates) == N_DEV


def _mesh_burst_rank(rank, n, shape=None, axes=('model',)):
    mesh = make_mesh(shape or (n,), axes, device='cpu')
    if rank != 0:
        return serve_rank(mesh)
    try:
        node = _burst_node(RuntimeConfig(mesh=mesh, t_cool_init=0.002,
                                         gate_op_latency_s=0.0005), mesh)
        evs = _burst(node)
        node.runtime.check_invariants()
        return {'gates': len(node.runtime.gates.gates),
                'latencies': [len(ev.device_latencies_s) for ev in evs],
                'per_device': _per_device_requests(evs),
                'finished': [len(e.finished) for e in node.engines]}
    finally:
        stop_ranks(mesh)


def test_tensor_parallel_burst_bounds_preemptions_per_device(tmp_path):
    """Online and offline engines tensor-parallel over a 2-rank mesh, under
    a runtime on that mesh: 2 gates, 2 device latencies an event, at most
    one preemption per (request, device)."""
    out = run_ranks(_mesh_burst_rank, 2, store_dir=tmp_path, args=(2,),
                    timeout_s=120)[0]
    assert out['gates'] == 2
    assert out['latencies'] and set(out['latencies']) == {2}
    assert out['per_device'] and max(out['per_device'].values()) <= 1
    assert out['finished'] == [1, 2]


def test_data_and_model_burst_bounds_preemptions_per_device(tmp_path):
    """The same burst on the production mesh's shape, (data 2, model 2):
    each dispatch's rows over data, the heads over model; 4 gates (one a
    mesh device, batch ranks included), 4 device latencies an event, at
    most one preemption per (request, device)."""
    out = run_ranks(_mesh_burst_rank, 4, store_dir=tmp_path,
                    args=(4, (2, 2), ('data', 'model')), timeout_s=120)[0]
    assert out['gates'] == 4
    assert out['latencies'] and set(out['latencies']) == {4}
    assert out['per_device'] and max(out['per_device'].values()) <= 1
    assert len({d for _, d in out['per_device']}) == 4
    assert out['finished'] == [1, 2]
