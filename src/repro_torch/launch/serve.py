"""Live online-offline colocation driver (one node), ported from the
reference's ``launch/serve.py``.

One ONLINE engine (latency-critical, bursty arrivals) and N OFFLINE engines
(throughput batch work, **heterogeneous model configs**) share one KV pool
and one set of dispatch gates through the :class:`NodeOrchestrator`:
online activity closes the offline compute gates (<= 1 preemption per
online request, wake after T_cool); online memory pressure reclaims offline
handles (compute-first, quarantine remap) and the invalidations fan out to
the owning engine's session; MIAD keeps the online reservation tracking
demand.  Reports TTFT / TPOT for online and tokens for offline.

The node runs on the GPU; ``--device cpu`` runs it on the CPU.  ``--http``
serves the async front-end over it instead of the scripted demo.

    # online qwen3-0.6b + offline qwen3-0.6b AND offline internlm2-1.8b
    # (reduced widths) on one pool
    PYTHONPATH=src python -m repro_torch.launch.serve --steps 400

    # an offline MoE engine (phi3.5-moe, reduced widths) beside the online
    # qwen3-0.6b
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --offline-arch phi3.5-moe-42b-a6.6b

    # the same node behind the HTTP front-end (SSE streaming + batch jobs)
    PYTHONPATH=src python -m repro_torch.launch.serve --http --port 8080
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced as reduce_cfg
from repro_torch.core.clock import RealClock
from repro_torch.core.runtime import RuntimeConfig, ValveRuntime
from repro_torch.launch.node import NodeOrchestrator
from repro_torch.serving.engine import EngineConfig
from repro_torch.serving.kvpool import KVPool

DEFAULT_OFFLINE_ARCHS = ('qwen3-0.6b', 'internlm2-1.8b')


def build_node(*, arch: str = 'qwen3-0.6b',
               offline_archs: Sequence[str] = DEFAULT_OFFLINE_ARCHS,
               seed: int = 0, clock=None, page_size: int = 4,
               max_prefill_reqs: int = 4,
               piggyback_decode: bool = True,
               idle_advance: float = 1e-3,
               device=None) -> NodeOrchestrator:
    """One node: online ``arch`` + one offline engine per ``offline_archs``
    entry (heterogeneous model configs over one pool/runtime), on the GPU
    unless ``device='cpu'``."""
    device = resolve_device(device)
    pool = KVPool(n_handles=24, pages_per_handle=8, page_size=page_size,
                  reserved_handles=2)
    clock = clock or RealClock()
    rt = ValveRuntime(pool, RuntimeConfig(n_devices=1, t_cool_init=0.002),
                      clock=clock)
    node = NodeOrchestrator(rt, idle_advance=idle_advance)

    def ecfg(klass: str) -> EngineConfig:
        return EngineConfig(max_batch=8, max_seq=96, prefill_chunk=16,
                            max_prefill_reqs=max_prefill_reqs,
                            piggyback_decode=piggyback_decode, klass=klass)

    node.add_engine(reduce_cfg(get_config(arch), page_size=page_size),
                    ecfg('online'), seed=seed, name=f'online:{arch}',
                    device=device)
    for i, oarch in enumerate(offline_archs):
        node.add_engine(reduce_cfg(get_config(oarch), page_size=page_size),
                        ecfg('offline'), seed=seed + i,
                        name=f'offline{i}:{oarch}', device=device)
    return node


def serve_demo(*, arch: str = 'qwen3-0.6b',
               offline_archs: Sequence[str] = DEFAULT_OFFLINE_ARCHS,
               steps: int = 400, online_rate: float = 0.08,
               burst_every: int = 120, seed: int = 0, clock=None,
               quiet: bool = False, max_prefill_reqs: int = 4,
               piggyback_decode: bool = True,
               node: Optional[NodeOrchestrator] = None, device=None):
    """Drive the node for ``steps`` scheduler ticks; returns metrics.

    A prebuilt ``node`` takes precedence: the build kwargs (``arch``,
    ``offline_archs``, ``max_prefill_reqs``, ``piggyback_decode``,
    ``clock``, ``device``) only apply when this function builds the node
    itself.
    """
    rng = np.random.default_rng(seed)
    node = node or build_node(arch=arch, offline_archs=offline_archs,
                              seed=seed, clock=clock,
                              max_prefill_reqs=max_prefill_reqs,
                              piggyback_decode=piggyback_decode,
                              device=device)
    online_eng = node.online

    # offline backlog: long prompts, long generations, spread round-robin
    # across the (heterogeneous) offline engines
    for i in range(6 * len(node.offline)):
        eng = node.offline[i % len(node.offline)]
        eng.submit(rng.integers(1, eng.mcfg.vocab_size, 24).tolist(),
                   max_new_tokens=24)

    for t in range(steps):
        # bursty online arrivals: poisson background + periodic spike
        # (an offline-only prebuilt node simply gets no arrivals)
        n_new = rng.poisson(online_rate) + (3 if t % burst_every == 0 else 0)
        for _ in range(n_new if online_eng is not None else 0):
            online_eng.submit(
                rng.integers(1, online_eng.mcfg.vocab_size, 12).tolist(),
                max_new_tokens=8)
        node.step()
    # arrivals over: drain the remaining (mostly offline) backlog so the
    # throughput metrics reflect completed work, not a truncated run
    node.drain()

    # event-log invariants (≤1 preemption/request, wakeups==gate-enables,
    # §5 ordering) + the published-event census from the typed stream
    node.runtime.check_invariants()
    metrics = node.metrics()
    metrics['events'] = dict(node.runtime.bus.published)
    metrics['live_invalidation_routes'] = \
        len(node.runtime.invalidation_routes())
    if not quiet:
        for k, v in metrics.items():
            if k == 'engines':
                for name, em in v.items():
                    print(f'  engine {name}: {em}')
            else:
                print(f'  {k}: {v}')
    return metrics


def serve_http(*, arch: str = 'qwen3-0.6b',
               offline_archs: Sequence[str] = DEFAULT_OFFLINE_ARCHS,
               host: str = '127.0.0.1', port: int = 8080,
               seed: int = 0, device=None) -> None:
    """Run the async serving front-end over a live node: OpenAI-style
    ``POST /v1/completions`` (SSE streaming) + the ``/v1/batches`` offline
    batch-job API, one event loop owning the runtime.

        PYTHONPATH=src python -m repro_torch.launch.serve --http --port 8080
        curl -N localhost:8080/v1/completions -d \\
            '{"prompt": [5, 7, 11], "max_tokens": 8, "stream": true}'
    """
    import asyncio

    from repro_torch.serving.frontend.app import FrontendApp
    from repro_torch.serving.frontend.driver import AsyncNodeDriver
    from repro_torch.serving.frontend.http import serve_asgi

    node = build_node(arch=arch, offline_archs=offline_archs, seed=seed,
                      device=device)

    async def _main() -> None:
        async with AsyncNodeDriver(node) as driver:
            server = await serve_asgi(FrontendApp(driver), host, port)
            print(f'serving on http://{host}:{server.port}  '
                  f'(online {arch}, offline {", ".join(offline_archs)})')
            try:
                await server.serve_forever()
            except asyncio.CancelledError:
                pass
            finally:
                await server.stop()

    try:
        asyncio.run(_main())
    except KeyboardInterrupt:
        print('shutting down')


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--arch', default='qwen3-0.6b',
                    help='online engine architecture')
    ap.add_argument('--offline-arch', action='append', default=None,
                    help='offline engine architecture (repeatable; default: '
                         f'{" + ".join(DEFAULT_OFFLINE_ARCHS)})')
    ap.add_argument('--steps', type=int, default=400)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--device', default=None,
                    help='torch device (default: the GPU)')
    ap.add_argument('--http', action='store_true',
                    help='serve the HTTP front-end (SSE streaming + batch '
                         'jobs) instead of running the scripted demo')
    ap.add_argument('--host', default='127.0.0.1')
    ap.add_argument('--port', type=int, default=8080)
    args = ap.parse_args()
    offline_archs = tuple(args.offline_arch or DEFAULT_OFFLINE_ARCHS)
    if args.http:
        serve_http(arch=args.arch, offline_archs=offline_archs,
                   host=args.host, port=args.port, seed=args.seed,
                   device=args.device)
    else:
        serve_demo(arch=args.arch, offline_archs=offline_archs,
                   steps=args.steps, seed=args.seed, device=args.device)


if __name__ == '__main__':
    main()
