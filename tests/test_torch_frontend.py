"""The port's async serving front-end, on a VirtualClock node on the CPU:
every gate of ``tests/test_frontend.py`` run on the port's stack
(``repro_torch.serving.frontend`` over the port's node and engines), and
one parity test that replays the same ``loadgen`` trace through the
reference's stack and the port's, with the reference's weights bridged in
f32 and f32 KV pools on both sides: equal SSE payloads byte for byte,
equal batch results and equal node metrics.

- concurrent online streams colocated with an offline batch job, with the
  paper's <= 1-compute-preemption-per-online-request bound asserted from
  the runtime's typed event log;
- a mid-stream client disconnect frees the request's KV lease (and its
  invalidation route dies with it);
- cancelling a still-queued batch job never allocates a page;
- engine-level cancellation keeps ``drain()`` / ``has_work()`` live;
- batch-job lifecycle with outputs identical to a direct offline drain;
- request validation, non-streamed == streamed text, the trace-replay
  load generator's determinism, and cancel during a disaggregated
  handoff.

No pytest-asyncio in the container: each test wraps its coroutine in
``asyncio.run``.
"""
import asyncio

import numpy as np
import pytest

from repro_torch.configs import get_config, reduced
from repro_torch.core.clock import VirtualClock
from repro_torch.core.events import PreemptionEvent
from repro_torch.core.runtime import RuntimeConfig, ValveRuntime
from repro_torch.launch.node import NodeOrchestrator
from repro_torch.serving.engine import EngineConfig
from repro_torch.serving.frontend.app import FrontendApp, token_text
from repro_torch.serving.frontend.driver import AsyncNodeDriver, clock_sleep
from repro_torch.serving.frontend.loadgen import (
    LoadGenerator, TraceEntry, make_online_trace)
from repro_torch.serving.frontend.testing import ASGIClient
from repro_torch.serving.kvpool import KVPool
from repro_torch.serving.scheduler import ReqState

ONLINE_ARCH = 'qwen3-0.6b'
OFFLINE_ARCHS = ('internlm2-1.8b', 'qwen3-0.6b')
# every reduced config in play shares this vocab (prompts must be valid
# ids for whichever engine they land on)
VOCAB = reduced(get_config(ONLINE_ARCH), page_size=4).vocab_size

# every async scenario is wall-clock-free; this bounds a livelocked pump
TIMEOUT_S = 120


def _ecfg(klass):
    return EngineConfig(max_batch=4, max_seq=48, prefill_chunk=8,
                        klass=klass)


def _node(*, pool_handles=5, pph=4, offline=True):
    pool = KVPool(pool_handles, pph, page_size=4, reserved_handles=1)
    rt = ValveRuntime(pool, RuntimeConfig(n_devices=1, t_cool_init=0.002),
                      clock=VirtualClock())
    node = NodeOrchestrator(rt, idle_advance=1e-3)
    node.add_engine(reduced(get_config(ONLINE_ARCH), page_size=4),
                    _ecfg('online'), seed=0, name='online',
                    device='cpu')
    if offline:
        for i, arch in enumerate(OFFLINE_ARCHS):
            node.add_engine(reduced(get_config(arch), page_size=4),
                            _ecfg('offline'), seed=10 + i, name=f'off{i}',
                            device='cpu')
    return node


def _prompt(vocab, n, seed):
    return np.random.default_rng(seed).integers(1, vocab, n).tolist()


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, TIMEOUT_S))


async def _poll_batch(client, bid, *, until, clock, max_polls=20000):
    """Poll a batch's status until ``until``; the pump runs between polls.
    Returns every status string observed (for lifecycle assertions)."""
    seen = []
    for _ in range(max_polls):
        resp = await client.get(f'/v1/batches/{bid}')
        assert resp.status == 200
        seen.append(resp.json()['status'])
        if seen[-1] == until:
            return seen
        await clock_sleep(clock, 1e-4)
    raise AssertionError(f'batch never reached {until!r}: {seen[-5:]}')


# ---------------------------------------------------------------------------
# Colocation under the preemption bound
# ---------------------------------------------------------------------------

def test_concurrent_streams_with_batch_under_preemption_bound():
    """≥4 concurrent online SSE streams land on a node whose offline
    engines are mid-batch; everything completes, and the event log shows
    no online request preempted offline compute more than once."""
    node = _node(pool_handles=6)
    vocab = node.online.mcfg.vocab_size

    async def scenario():
        async with AsyncNodeDriver(node) as driver:
            client = ASGIClient(FrontendApp(driver))
            # offline batch first: its items hold live pages when the
            # online burst arrives, so admission forces reclamation
            batch = await client.post('/v1/batches', json={'requests': [
                {'prompt': _prompt(vocab, 12, 100 + i), 'max_tokens': 8}
                for i in range(4)]})
            assert batch.status == 200
            bid = batch.json()['id']
            await _poll_batch(client, bid, until='in_progress',
                              clock=node.clock)

            async def one_stream(i):
                sr = client.stream('POST', '/v1/completions',
                                   json={'prompt': _prompt(vocab, 10, i),
                                         'max_tokens': 6, 'stream': True})
                toks = []
                async with sr:
                    assert sr.status == 200
                    async for ev in sr.events():
                        if ev.done:
                            break
                        import json as _json
                        c = _json.loads(ev.data)['choices'][0]
                        if c.get('token') is not None:
                            toks.append(c['token'])
                return toks

            results = await asyncio.gather(*(one_stream(i)
                                             for i in range(4)))
            statuses = await _poll_batch(client, bid, until='completed',
                                         clock=node.clock)
            return results, statuses

    results, statuses = _run(scenario())
    assert all(len(t) == 6 for t in results), [len(t) for t in results]
    assert statuses[-1] == 'completed'

    # the paper's bound, read from the typed event log — not from a
    # summary counter: fold PreemptionEvent.requests per online request
    preempts = node.runtime.bus.events(PreemptionEvent)
    assert len(preempts) >= 1          # colocation actually contended
    per_req = {}
    for ev in preempts:
        for rid in ev.requests:
            per_req[rid] = per_req.get(rid, 0) + 1
    assert per_req and max(per_req.values()) <= 1, per_req
    tel = node.runtime.telemetry.snapshot()
    assert tel['max_preemptions_per_request'] <= 1
    node.runtime.check_invariants()
    node.pool.check_invariants()
    assert node.runtime.invalidation_routes() == []


# ---------------------------------------------------------------------------
# Cancellation / leak regressions
# ---------------------------------------------------------------------------

def test_disconnect_mid_stream_releases_lease_and_routes():
    """Client drops the SSE connection after the first tokens: the
    request's lease frees on the spot, its invalidation route dies with
    it, and the node keeps serving."""
    node = _node(offline=False)
    vocab = node.online.mcfg.vocab_size
    # reservation-independent leak check: total free pages across ALL
    # handles (MIAD legitimately moves handles between reserved/offline)
    free0 = sum(len(d) for d in node.pool.free_in_handle)

    async def scenario():
        async with AsyncNodeDriver(node) as driver:
            client = ASGIClient(FrontendApp(driver))
            sr = client.stream('POST', '/v1/completions',
                               json={'prompt': _prompt(vocab, 8, 1),
                                     'max_tokens': 24, 'stream': True})
            async with sr:
                got = 0
                async for ev in sr.events():
                    if not ev.done:
                        got += 1
                    if got >= 2:
                        break
                await sr.disconnect()      # mid-stream hang-up
            # the app handler observed the disconnect and unwound; give
            # the pump one tick to settle bookkeeping
            await clock_sleep(node.clock, 1e-3)
            assert driver.stats.streams_cancelled == 1

            # the node still serves: a fresh request completes normally
            resp = await client.post('/v1/completions',
                                     json={'prompt': _prompt(vocab, 8, 2),
                                           'max_tokens': 4})
            assert resp.status == 200
            return resp.json()

    completion = _run(scenario())
    assert completion['choices'][0]['finish_reason'] == 'length'
    assert len(completion['choices'][0]['tokens']) == 4

    (cancelled,) = [r for r in node.online.requests.values()
                    if r.state is ReqState.CANCELLED]
    assert cancelled.lease is None and cancelled.pages == []
    assert node.runtime.memory.live_leases('online') == []
    assert node.runtime.invalidation_routes() == []
    assert sum(len(d) for d in node.pool.free_in_handle) == free0
    assert node.metrics()['cancellations'] == 1
    node.runtime.check_invariants()
    node.pool.check_invariants()


def test_cancel_queued_batch_never_allocates():
    """Admission is deferred to scheduler admission, and the gates stay
    closed while an online request is in flight — so a batch cancelled
    while still queued provably never leased a page."""
    node = _node()
    vocab = node.online.mcfg.vocab_size

    async def scenario():
        async with AsyncNodeDriver(node) as driver:
            client = ASGIClient(FrontendApp(driver))
            # a long online stream holds the gates closed
            sr = client.stream('POST', '/v1/completions',
                               json={'prompt': _prompt(vocab, 8, 5),
                                     'max_tokens': 24, 'stream': True})
            async with sr:
                it = sr.events()
                await it.__anext__()       # online is live → gates closed

                batch = await client.post('/v1/batches', json={'requests': [
                    {'prompt': _prompt(vocab, 12, 50 + i), 'max_tokens': 8}
                    for i in range(3)]})
                bid = batch.json()['id']
                assert batch.json()['status'] == 'queued'
                # gated: no offline lease exists anywhere
                assert node.runtime.memory.live_leases('offline') == []
                assert all(e.stats.dispatches == 0 for e in node.offline)

                resp = await client.post(f'/v1/batches/{bid}/cancel')
                assert resp.json()['status'] == 'cancelled'
                assert resp.json()['request_counts']['cancelled'] == 3

                # the stream finishes undisturbed
                async for ev in it:
                    pass
            res = await client.get(f'/v1/batches/{bid}/results')
            return res

    res = _run(scenario())
    assert res.status == 200
    assert all(r['status'] == 'cancelled' and r['tokens'] == []
               for r in res.json()['results'])
    # never allocated: no offline engine ever dispatched or leased
    assert all(e.stats.dispatches == 0 for e in node.offline)
    assert all(r.lease is None and r.pages == []
               for e in node.offline for r in e.requests.values())
    assert node.runtime.memory.live_leases('offline') == []
    assert sum(e.stats.cancellations for e in node.offline) == 3
    assert node.runtime.invalidation_routes() == []
    node.runtime.check_invariants()
    node.pool.check_invariants()


def test_engine_cancel_keeps_drain_live_and_counts():
    """Cancelling queued AND running requests leaves the node loop live:
    ``drain()`` terminates without a watchdog stall, ``has_work()`` goes
    False, and cancellations are counted (the liveness regression for the
    cancellation path)."""
    node = _node(offline=False)
    eng = node.online
    vocab = eng.mcfg.vocab_size
    rids = [eng.submit(_prompt(vocab, 8, i), max_new_tokens=4)
            for i in range(6)]              # max_batch=4 → 2 stay queued
    for _ in range(3):
        node.step()
    running = [r for r in rids if r in eng.running]
    queued = [r for r in rids if r in eng.queue]
    assert running and queued
    assert eng.cancel(running[0]) and eng.cancel(queued[-1])
    assert eng.cancel(running[0]) is False          # idempotent
    assert eng.cancel('no-such-request') is False

    node.drain(max_steps=2000)                      # must not stall
    assert not node.has_work()
    assert eng.stats.cancellations == 2
    assert len(eng.finished) == 4
    for rid in (running[0], queued[-1]):
        assert eng.requests[rid].state is ReqState.CANCELLED
        assert eng.requests[rid].lease is None
    assert node.metrics()['cancellations'] == 2
    assert node.runtime.invalidation_routes() == []
    node.runtime.check_invariants()
    node.pool.check_invariants()


# ---------------------------------------------------------------------------
# Batch-job lifecycle
# ---------------------------------------------------------------------------

def test_batch_lifecycle_and_result_fidelity():
    """queued → in_progress → completed; results are refused (409) before
    the job is terminal and match a direct offline drain afterwards."""
    specs = [{'prompt': _prompt(VOCAB, 10, 200 + i), 'max_tokens': 5}
             for i in range(3)]

    # reference: same prompts fed straight to a fresh node's offline
    # engines in BatchManager's round-robin order, drained synchronously
    ref = _node()
    ref_out = []
    ref_rids = [(ref.offline[i % len(ref.offline)],
                 ref.offline[i % len(ref.offline)].submit(
                     s['prompt'], s['max_tokens']))
                for i, s in enumerate(specs)]
    ref.drain(max_steps=5000)
    ref_out = [e.output_tokens(r) for e, r in ref_rids]

    node = _node()

    async def scenario():
        async with AsyncNodeDriver(node) as driver:
            client = ASGIClient(FrontendApp(driver))
            sub = await client.post('/v1/batches', json={'requests': specs})
            assert sub.status == 200
            job = sub.json()
            assert job['status'] == 'queued'
            assert job['request_counts'] == {
                'total': 3, 'queued': 3, 'in_progress': 0,
                'completed': 0, 'cancelled': 0}
            early = await client.get(f'/v1/batches/{job["id"]}/results')
            assert early.status == 409                 # not terminal yet
            statuses = await _poll_batch(client, job['id'],
                                         until='completed',
                                         clock=node.clock)
            res = await client.get(f'/v1/batches/{job["id"]}/results')
            return statuses, res.json()

    statuses, results = _run(scenario())
    assert 'in_progress' in statuses
    assert results['object'] == 'batch.results'
    by_index = sorted(results['results'], key=lambda r: r['index'])
    assert [r['tokens'] for r in by_index] == ref_out
    assert all(r['status'] == 'completed'
               and r['text'] == token_text(r['tokens'])
               for r in by_index)
    # heterogeneous placement: round-robin used both offline models
    assert len({r['engine'] for r in by_index}) == 2


# ---------------------------------------------------------------------------
# Validation + non-streaming parity
# ---------------------------------------------------------------------------

def test_request_validation_and_routing():
    node = _node()
    vocab = node.online.mcfg.vocab_size

    async def scenario():
        async with AsyncNodeDriver(node) as driver:
            client = ASGIClient(FrontendApp(driver))
            bad = [
                ({'max_tokens': 4}, 400),                    # no prompt
                ({'prompt': [], 'max_tokens': 4}, 400),      # empty
                ({'prompt': ['a'], 'max_tokens': 4}, 400),   # not ids
                ({'prompt': [1, 2], 'max_tokens': 0}, 400),  # bad budget
                ({'prompt': [1] * 47, 'max_tokens': 9}, 400),  # > max_seq
                ({'prompt': [vocab + 7], 'max_tokens': 4}, 400),  # vocab
            ]
            for body, want in bad:
                resp = await client.post('/v1/completions', json=body)
                assert resp.status == want, (body, resp.status)
                assert 'error' in resp.json()
            for body in ({}, {'requests': []},
                         {'requests': [{'max_tokens': 4}]},
                         {'requests': [{'prompt': [1], 'max_tokens': 99}]}):
                resp = await client.post('/v1/batches', json=body)
                assert resp.status == 400, body
            assert (await client.get('/v1/batches/nope')).status == 404
            assert (await client.post('/v1/batches/nope/cancel')
                    ).status == 404
            assert (await client.get('/v1/nowhere')).status == 404
            health = await client.get('/healthz')
            assert health.status == 200
            assert health.json()['online'] is True
            metrics = await client.get('/v1/metrics')
            assert metrics.status == 200
            assert 'cancellations' in metrics.json()
            # nothing above ever reached an engine
            assert node.online.stats.dispatches == 0

    _run(scenario())


def test_nonstream_completion_matches_streamed_text():
    """``stream: false`` returns exactly the text a streaming client
    would reassemble from its deltas (same seed, fresh nodes)."""
    import json as _json
    prompt = _prompt(VOCAB, 9, 77)

    async def non_stream():
        node = _node(offline=False)
        async with AsyncNodeDriver(node) as driver:
            client = ASGIClient(FrontendApp(driver))
            resp = await client.post('/v1/completions',
                                     json={'prompt': prompt,
                                           'max_tokens': 5})
            assert resp.status == 200
            body = resp.json()
            assert body['usage'] == {'prompt_tokens': 9,
                                     'completion_tokens': 5}
            return body['choices'][0]['text']

    async def streamed():
        node = _node(offline=False)
        async with AsyncNodeDriver(node) as driver:
            client = ASGIClient(FrontendApp(driver))
            sr = client.stream('POST', '/v1/completions',
                               json={'prompt': prompt, 'max_tokens': 5,
                                     'stream': True})
            parts = []
            async with sr:
                async for ev in sr.events():
                    if ev.done:
                        break
                    c = _json.loads(ev.data)['choices'][0]
                    if c.get('token') is not None:
                        parts.append(c['text'])
            return ''.join(parts)

    assert _run(non_stream()) == _run(streamed())


# ---------------------------------------------------------------------------
# Trace-replay load generator
# ---------------------------------------------------------------------------

def _replay_once():
    node = _node(pool_handles=8)

    async def scenario():
        async with AsyncNodeDriver(node) as driver:
            client = ASGIClient(FrontendApp(driver))
            gen = LoadGenerator(client, node.clock,
                                vocab_size=node.online.mcfg.vocab_size)
            trace = make_online_trace(6, horizon_s=0.5, prompt_len=8,
                                      max_new_tokens=4, seed=9)
            trace.append(TraceEntry(t=0.05, kind='batch', n_requests=2,
                                    prompt_len=8, max_new_tokens=4,
                                    seed=99))
            return await gen.replay(trace)

    report = _run(scenario())
    node.runtime.check_invariants()
    return report


def test_loadgen_replay_is_deterministic():
    """The load generator paces on the virtual clock: two replays of the
    same trace on fresh nodes produce the SAME report, TTFTs included —
    the property that makes benchmark regressions attributable."""
    a, b = _replay_once(), _replay_once()
    assert a.n_online == 6 and a.completed == 6 and a.failed == 0
    assert a.batch_jobs == 1
    assert a.peak_concurrent_streams >= 2     # the front-loaded burst
    assert a.tokens_streamed == 24
    assert a.requests_per_s > 0
    assert a.ttft_pct(99) is not None and a.ttft_pct(99) > 0
    assert a.to_dict() == b.to_dict()


# ---------------------------------------------------------------------------
# Disaggregated plane: cancel during the prefill→decode handoff
# ---------------------------------------------------------------------------

def _disagg_plane():
    """Minimal two-node disagg plane (online engines only) — the driver
    runs over it through the same duck-typed node surface."""
    from repro_torch.serving.disagg import DisaggPlane
    clock = VirtualClock()

    def side(name, reserved):
        pool = KVPool(6, 4, page_size=4, reserved_handles=reserved,
                      name=name)
        rt = ValveRuntime(pool,
                          RuntimeConfig(n_devices=1, t_cool_init=0.002),
                          clock=clock)
        node = NodeOrchestrator(rt, idle_advance=1e-3, disaggregated=True)
        node.add_engine(reduced(get_config(ONLINE_ARCH), page_size=4),
                        _ecfg('online'), seed=0, name=f'{name}-online',
                        device='cpu')
        return node

    return DisaggPlane(side('prefill', 2), side('decode', 5))


def test_cancel_during_handoff_leaks_nothing_on_either_pool():
    """A client disconnect in EITHER handoff window — (a) prefill done
    but the lease still on the prefill pool, (b) already migrated and
    queued on the decode engine but not yet admitted — must release the
    lease on whichever pool holds it: no page, lease, or invalidation
    route survives on either side."""
    plane = _disagg_plane()
    vocab = plane.online.mcfg.vocab_size
    pe, de = plane.prefill.online, plane.decode.online
    free0 = [sum(len(d) for d in p.free_in_handle)
             for p in (plane.prefill.pool, plane.decode.pool)]

    async def scenario():
        driver = AsyncNodeDriver(plane)    # no pump: windows stepped by hand

        # --- window (a): RUNNING on prefill, handoff pump not yet run ---
        s1 = driver.submit_stream(_prompt(vocab, 8, 31), max_new_tokens=8)
        for _ in range(200):
            if (s1.req_id in pe.requests
                    and pe.requests[s1.req_id].state is ReqState.RUNNING):
                break
            plane.prefill.step()
        assert pe.requests[s1.req_id].state is ReqState.RUNNING
        assert plane.stats.handoffs == 0
        assert plane.prefill.runtime.memory.live_leases('online') \
            == [s1.req_id]
        assert driver.cancel_stream(s1.req_id)
        await s1.collect()
        assert s1.finish_reason == 'cancelled'
        assert pe.requests[s1.req_id].state is ReqState.CANCELLED
        assert de.requests == {}           # never reached the decode side

        # --- window (b): migrated to decode, queued, not yet admitted ---
        s2 = driver.submit_stream(_prompt(vocab, 8, 32), max_new_tokens=8)
        for _ in range(200):
            plane.prefill.step()
            plane._pump_handoffs()
            if s2.req_id in de.queue:
                break
        assert s2.req_id in de.queue and s2.req_id not in pe.requests
        assert plane.stats.handoffs == 1
        # the migrated lease lives on the DECODE plane now
        assert plane.prefill.runtime.memory.live_leases('online') == []
        assert plane.decode.runtime.memory.live_leases('online') \
            == [s2.req_id]
        assert driver.cancel_stream(s2.req_id)
        await s2.collect()
        assert s2.finish_reason == 'cancelled'
        assert de.requests[s2.req_id].state is ReqState.CANCELLED
        assert driver.stats.streams_cancelled == 2

    _run(scenario())
    # nothing leaked on EITHER pool: every page back, no live lease, no
    # invalidation route pinning reserved KV
    for node, f0 in zip((plane.prefill, plane.decode), free0):
        assert sum(len(d) for d in node.pool.free_in_handle) == f0
        assert node.runtime.memory.live_leases('online') == []
        assert node.runtime.invalidation_routes() == []
    plane.check_invariants()


# ---------------------------------------------------------------------------
# Parity: the same loadgen trace through the reference's stack and the port's
# ---------------------------------------------------------------------------

def _recording(app, log):
    """ASGI middleware: every ``/v1/completions`` call's response bytes,
    one entry per call in the order the calls start."""
    async def wrapped(scope, receive, send):
        if scope.get('path') != '/v1/completions':
            return await app(scope, receive, send)
        chunks = []
        log.append(chunks)

        async def tap(msg):
            if msg['type'] == 'http.response.body':
                chunks.append(msg.get('body', b''))
            await send(msg)
        await app(scope, receive, tap)
    return wrapped


def _parity_trace(make_trace, entry_cls):
    trace = make_trace(8, horizon_s=0.5, prompt_len=8, max_new_tokens=5,
                       seed=21)
    trace.append(entry_cls(t=0.05, kind='batch', n_requests=3,
                           prompt_len=8, max_new_tokens=4, seed=77))
    return trace


def _replay_on(stack, node):
    """Replay the parity trace on ``node`` through ``stack``'s front-end
    (a namespace of its modules); run until every batch job is terminal.
    -> (load report, SSE bytes per call, batch results, node metrics)."""
    log = []

    async def scenario():
        async with stack.AsyncNodeDriver(node) as driver:
            client = stack.ASGIClient(_recording(stack.FrontendApp(driver),
                                                 log))
            gen = stack.LoadGenerator(client, node.clock,
                                      vocab_size=node.online.mcfg.vocab_size)
            report = await gen.replay(_parity_trace(stack.make_online_trace,
                                                    stack.TraceEntry))
            results = {}
            for bid in list(driver.batches.jobs):
                while (await client.get(f'/v1/batches/{bid}')
                       ).json()['status'] != 'completed':
                    await stack.clock_sleep(node.clock, 1e-4)
                results[bid] = (await client.get(
                    f'/v1/batches/{bid}/results')).json()
            return report, results

    report, results = _run(scenario())
    node.runtime.check_invariants()
    return report.to_dict(), [b''.join(c) for c in log], results, \
        node.metrics()


def test_loadgen_trace_matches_the_reference_stack():
    """One trace (8 online streams, one 3-item batch job) replayed through
    the reference's front-end over the reference's node and through the
    port's over the port's, the same weights in f32 on both: the SSE bytes
    of every stream, the batch results, the load report and the node's
    preemption metrics are equal."""
    import types

    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as j_get_config
    from repro.configs import reduced as j_reduced
    from repro.core.clock import VirtualClock as JVirtualClock
    from repro.core.runtime import RuntimeConfig as JRuntimeConfig
    from repro.core.runtime import ValveRuntime as JValveRuntime
    from repro.launch.node import NodeOrchestrator as JNodeOrchestrator
    from repro.models.api import build_model as j_build_model
    from repro.serving.engine import EngineConfig as JEngineConfig
    from repro.serving.frontend import app as japp
    from repro.serving.frontend import driver as jdriver
    from repro.serving.frontend import loadgen as jloadgen
    from repro.serving.frontend import testing as jtesting
    from repro.serving.kvpool import KVPool as JKVPool
    from repro_torch.bridge import params_from_jax
    from repro_torch.serving.frontend import loadgen, testing

    archs = (ONLINE_ARCH,) + OFFLINE_ARCHS
    klasses = ('online', 'offline', 'offline')
    seeds = (0, 10, 11)
    f32 = lambda tree: jax.tree.map(lambda x: x.astype(jnp.float32), tree)
    params = [f32(j_build_model(j_reduced(j_get_config(a), page_size=4))
                  .init_params(jax.random.PRNGKey(s)))
              for a, s in zip(archs, seeds)]

    jnode = JNodeOrchestrator(JValveRuntime(
        JKVPool(8, 4, page_size=4, reserved_handles=1),
        JRuntimeConfig(n_devices=1, t_cool_init=0.002),
        clock=JVirtualClock()), idle_advance=1e-3)
    node = NodeOrchestrator(ValveRuntime(
        KVPool(8, 4, page_size=4, reserved_handles=1),
        RuntimeConfig(n_devices=1, t_cool_init=0.002),
        clock=VirtualClock()), idle_advance=1e-3)
    for arch, klass, p in zip(archs, klasses, params):
        eng = jnode.add_engine(
            j_reduced(j_get_config(arch), page_size=4),
            JEngineConfig(max_batch=4, max_seq=48, prefill_chunk=8,
                          klass=klass), params=p)
        eng.cache = f32(eng.cache)
        eng = node.add_engine(
            reduced(get_config(arch), page_size=4), _ecfg(klass),
            params=params_from_jax(jax.tree.map(np.asarray, p)),
            device='cpu')
        eng.cache = {k: v.float() for k, v in eng.cache.items()}

    def stack(app, driver, loadgen, testing):
        return types.SimpleNamespace(
            FrontendApp=app.FrontendApp, AsyncNodeDriver=driver.AsyncNodeDriver,
            clock_sleep=driver.clock_sleep, ASGIClient=testing.ASGIClient,
            LoadGenerator=loadgen.LoadGenerator, TraceEntry=loadgen.TraceEntry,
            make_online_trace=loadgen.make_online_trace)

    want = _replay_on(stack(japp, jdriver, jloadgen, jtesting), jnode)
    from repro_torch.serving.frontend import app, driver
    got = _replay_on(stack(app, driver, loadgen, testing), node)

    report, frames, results, metrics = got
    assert report['completed'] == 8 and report['failed'] == 0
    assert len(frames) == 8 and all(f.endswith(b'data: [DONE]\n\n')
                                    for f in frames)
    assert report == want[0]
    assert frames == want[1]
    assert results == want[2]
    for key in ('compute_preemptions', 'reclamations', 'offline_wakeups',
                'max_preemptions_per_request', 'online_finished',
                'offline_finished', 'offline_tokens'):
        assert metrics[key] == want[3][key], key
    assert metrics['compute_preemptions'] >= 1      # the trace contends
    assert metrics['max_preemptions_per_request'] <= 1
