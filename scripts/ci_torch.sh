#!/usr/bin/env bash
# CI gate of the PyTorch port (src/repro_torch) on the CPU: the Valve patch
# surface of the port's engine, the node smoke, a tensor-parallel drain
# over two gloo ranks (tests/test_torch_gate_fanout.py), the in-process
# HTTP smoke, a short reduced training run, two over four gloo ranks
# (qwen3-0.6b and zamba2-2.7b) and the trainer's mesh refusals (tests/test_torch_train_mesh.py, the cases
# that need no reference).  Nothing here imports jax;
# the CPU parity tests against the reference are tests/test_torch_*.py.
#
# Usage:  scripts/ci_torch.sh
set -euo pipefail
cd "$(dirname "$0")/.."
export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"

echo "== torch $(python -c 'import torch; print(torch.__version__)')"

echo "== valve patch surface (the port's engine) =="
python - <<'PY'
import sys
sys.path.insert(0, 'tests')
from test_torch_patch_surface import ENGINES, patch_loc, session_patch_loc
loc, sloc = patch_loc(ENGINES['port']), session_patch_loc(ENGINES['port'])
print(f'framework-side patch: {loc} LOC (paper Table 1 contract: < 20; '
      f'memory-plane v1 budget: <= 13)')
print(f'session-API integration: {sloc} tagged lines')
assert 0 < loc <= 13, loc
assert 0 < sloc < 10, sloc
PY

echo "== node demo smoke (heterogeneous colocation, CPU) =="
python -m repro_torch.launch.serve --steps 50 --device cpu

echo "== tensor-parallel drain (online + offline engines over 2 gloo ranks, CPU) =="
python -m pytest -q -p no:cacheprovider tests/test_torch_gate_fanout.py

echo "== serving front-end: in-process HTTP smoke (1 stream + 1 batch, no sockets) =="
python - <<'PY'
import asyncio, json
from repro_torch.configs import get_config, reduced
from repro_torch.core.clock import VirtualClock
from repro_torch.core.runtime import RuntimeConfig, ValveRuntime
from repro_torch.launch.node import NodeOrchestrator
from repro_torch.serving.engine import EngineConfig
from repro_torch.serving.frontend.app import FrontendApp
from repro_torch.serving.frontend.driver import AsyncNodeDriver, clock_sleep
from repro_torch.serving.frontend.testing import ASGIClient
from repro_torch.serving.kvpool import KVPool

pool = KVPool(6, 4, page_size=4, reserved_handles=1)
rt = ValveRuntime(pool, RuntimeConfig(n_devices=1, t_cool_init=0.002),
                  clock=VirtualClock())
node = NodeOrchestrator(rt, idle_advance=1e-3)
for klass, seed in (('online', 0), ('offline', 1)):
    node.add_engine(reduced(get_config('qwen3-0.6b'), page_size=4),
                    EngineConfig(max_batch=4, max_seq=48, prefill_chunk=8,
                                 klass=klass), seed=seed, device='cpu')

async def main():
    async with AsyncNodeDriver(node) as driver:
        client = ASGIClient(FrontendApp(driver))
        sr = client.stream('POST', '/v1/completions',
                           json={'prompt': [5, 7, 11], 'max_tokens': 4,
                                 'stream': True})
        toks = 0
        async with sr:
            assert sr.status == 200, sr.status
            async for ev in sr.events():
                if ev.done:
                    break
                if json.loads(ev.data)['choices'][0].get('token') is not None:
                    toks += 1
        assert toks == 4, toks
        job = (await client.post('/v1/batches', json={
            'requests': [{'prompt': [3, 1, 4], 'max_tokens': 3}]})).json()
        for _ in range(20000):
            st = (await client.get(f"/v1/batches/{job['id']}")).json()['status']
            if st == 'completed':
                break
            await clock_sleep(node.clock, 1e-4)
        assert st == 'completed', st
        res = (await client.get(f"/v1/batches/{job['id']}/results")).json()
        assert len(res['results'][0]['tokens']) == 3, res

asyncio.run(main())
node.runtime.check_invariants()
assert node.runtime.invalidation_routes() == []
print('front-end smoke OK: 1 SSE stream (4 tokens) + 1 batch job, in-process')
PY

echo "== training smoke (reduced qwen3-0.6b, 4 steps, CPU) =="
python -m repro_torch.launch.train --arch qwen3-0.6b --reduced --steps 4 \
    --device cpu

echo "== mesh training smoke (reduced qwen3-0.6b and zamba2-2.7b, 4 gloo ranks at (2, 2), CPU) =="
# -c, not a heredoc: spawned ranks re-run a main module that has a path
python -c "
import tempfile
from repro_torch.launch.ranks import run_ranks
from repro_torch.launch.train import train_rank
for arch in ('qwen3-0.6b', 'zamba2-2.7b'):
    with tempfile.TemporaryDirectory() as d:
        out = run_ranks(train_rank, 4, store_dir=d, device_type='cpu',
                        args=((2, 2), arch, dict(steps=4, batch=8, seq=32,
                                                 device='cpu',
                                                 log_every=100)))
    assert all(o == out[0] for o in out), out
    print(arch, 'mesh training smoke OK: losses',
          [round(x, 4) for x in out[0]])
"
python -m pytest -q -p no:cacheprovider tests/test_torch_train_mesh.py \
    -k refused

echo "CI (port) green."
