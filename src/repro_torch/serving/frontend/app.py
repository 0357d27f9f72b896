"""The HTTP surface — a framework-free ASGI application.

OpenAI-style endpoints over one :class:`AsyncNodeDriver` (see
``docs/API.md`` § Serving endpoints for the wire contract):

- ``POST /v1/completions`` — online request.  ``stream: true`` responds
  ``text/event-stream``: one SSE frame per token delta, a final frame
  carrying ``finish_reason``, then ``data: [DONE]``.  ``stream: false``
  returns the whole completion as JSON.  A client disconnect mid-stream
  cancels the request — the engine releases its lease immediately, so an
  abandoned stream cannot pin KV pages.
- ``POST /v1/batches`` / ``GET /v1/batches/{id}`` /
  ``GET /v1/batches/{id}/results`` / ``POST /v1/batches/{id}/cancel`` —
  the offline batch-job lifecycle (submit → poll → fetch).
- ``GET /v1/metrics`` — the node's metrics dict; ``GET /healthz``.

The app is plain ASGI (``async def app(scope, receive, send)``) with no
web framework behind it: the container ships no starlette/uvicorn, and
the protocol tests want byte-level control of the wire anyway.  It runs
in-process under the deterministic test client
(:mod:`repro_torch.serving.frontend.testing`) and over real sockets under the
:mod:`repro_torch.serving.frontend.http` adapter — same code path either way.

The repro has no tokenizer, so prompts are token-id arrays and "text" is
the canonical space-joined id rendering (:func:`token_text`) — what the
SSE-vs-drain bit-identity tests compare.
"""
from __future__ import annotations

import asyncio
import json
import re
from typing import Callable, Dict, List, Sequence, Tuple

from repro_torch.serving.frontend.driver import AsyncNodeDriver, OnlineStream
from repro_torch.serving.frontend.sse import DONE_FRAME, encode_sse

__all__ = ['FrontendApp', 'token_text', 'token_delta']

_JSON = {'content-type': 'application/json'}
_SSE = {'content-type': 'text/event-stream', 'cache-control': 'no-cache'}


def token_text(tokens: Sequence[int]) -> str:
    """Canonical text rendering of a token-id sequence ("5 17 99")."""
    return ' '.join(str(int(t)) for t in tokens)


def token_delta(token: int, index: int) -> str:
    """The streamed delta for one token such that concatenating every
    delta reproduces ``token_text`` bit-identically."""
    return ('' if index == 0 else ' ') + str(int(token))


class _HTTPError(Exception):
    def __init__(self, status: int, message: str, kind: str = 'invalid_request'):
        self.status, self.message, self.kind = status, message, kind


class FrontendApp:
    """ASGI application over one driver.  Routes are (method, regex) pairs
    resolved in order; handlers are ``async (match, body) -> (status,
    headers, obj)`` or take over the raw ``send`` for streaming."""

    def __init__(self, driver: AsyncNodeDriver):
        self.driver = driver
        self.node = driver.node
        self.batches = driver.batches
        self._routes: List[Tuple[str, re.Pattern, Callable]] = [
            ('POST', re.compile(r'^/v1/completions$'), self._completions),
            ('POST', re.compile(r'^/v1/batches$'), self._batch_submit),
            ('GET', re.compile(r'^/v1/batches/(?P<bid>[\w.-]+)/results$'),
             self._batch_results),
            ('POST', re.compile(r'^/v1/batches/(?P<bid>[\w.-]+)/cancel$'),
             self._batch_cancel),
            ('GET', re.compile(r'^/v1/batches/(?P<bid>[\w.-]+)$'),
             self._batch_status),
            ('GET', re.compile(r'^/v1/metrics$'), self._metrics),
            ('GET', re.compile(r'^/healthz$'), self._health),
        ]

    # ------------------------------------------------------------------
    # ASGI entry
    # ------------------------------------------------------------------
    async def __call__(self, scope: dict, receive, send) -> None:
        if scope['type'] == 'lifespan':
            await self._lifespan(receive, send)
            return
        assert scope['type'] == 'http', scope['type']
        method, path = scope['method'].upper(), scope['path']
        try:
            for m, pat, handler in self._routes:
                match = pat.match(path)
                if match and m == method:
                    await handler(match, scope, receive, send)
                    return
            raise _HTTPError(404, f'no route for {method} {path}',
                             'not_found')
        except _HTTPError as e:
            await self._respond(send, e.status,
                                {'error': {'message': e.message,
                                           'type': e.kind}})

    async def _lifespan(self, receive, send) -> None:
        while True:
            msg = await receive()
            if msg['type'] == 'lifespan.startup':
                await send({'type': 'lifespan.startup.complete'})
            elif msg['type'] == 'lifespan.shutdown':
                await send({'type': 'lifespan.shutdown.complete'})
                return

    # ------------------------------------------------------------------
    # Plumbing
    # ------------------------------------------------------------------
    async def _read_json(self, receive) -> dict:
        body = b''
        while True:
            msg = await receive()
            if msg['type'] == 'http.disconnect':
                raise _HTTPError(400, 'client disconnected during body')
            body += msg.get('body', b'')
            if not msg.get('more_body'):
                break
        if not body:
            return {}
        try:
            obj = json.loads(body)
        except ValueError:
            raise _HTTPError(400, 'request body is not valid JSON')
        if not isinstance(obj, dict):
            raise _HTTPError(400, 'request body must be a JSON object')
        return obj

    async def _respond(self, send, status: int, obj,
                       headers: Dict[str, str] = _JSON) -> None:
        body = json.dumps(obj, default=str).encode('utf-8')
        await send({'type': 'http.response.start', 'status': status,
                    'headers': [(k.encode(), v.encode())
                                for k, v in headers.items()]
                    + [(b'content-length', str(len(body)).encode())]})
        await send({'type': 'http.response.body', 'body': body})

    def _parse_completion(self, body: dict) -> Tuple[List[int], int, bool]:
        eng = self.node.online
        if eng is None:
            raise _HTTPError(503, 'node has no online engine',
                             'service_unavailable')
        prompt = body.get('prompt')
        if (not isinstance(prompt, list) or not prompt
                or not all(isinstance(t, int) and t >= 0 for t in prompt)):
            raise _HTTPError(400, 'prompt must be a non-empty list of '
                                  'token ids (this repro has no tokenizer)')
        max_tokens = body.get('max_tokens', 16)
        if not isinstance(max_tokens, int) or max_tokens < 1:
            raise _HTTPError(400, 'max_tokens must be a positive integer')
        if len(prompt) + max_tokens > eng.cfg.max_seq:
            raise _HTTPError(400, f'prompt ({len(prompt)}) + max_tokens '
                                  f'({max_tokens}) exceeds the engine '
                                  f'budget of {eng.cfg.max_seq}')
        if any(t >= eng.mcfg.vocab_size for t in prompt):
            raise _HTTPError(400, f'token id out of range (vocab size '
                                  f'{eng.mcfg.vocab_size})')
        return prompt, max_tokens, bool(body.get('stream', False))

    # ------------------------------------------------------------------
    # POST /v1/completions
    # ------------------------------------------------------------------
    async def _completions(self, match, scope, receive, send) -> None:
        body = await self._read_json(receive)
        prompt, max_tokens, stream = self._parse_completion(body)
        s = self.driver.submit_stream(prompt, max_tokens)
        if stream:
            await self._stream_completion(s, receive, send)
        else:
            tokens = await s.collect()
            await self._respond(send, 200, {
                'id': s.req_id,
                'object': 'text_completion',
                'model': self.node.online.mcfg.name,
                'choices': [{'index': 0,
                             'text': token_text(tokens),
                             'tokens': tokens,
                             'finish_reason': s.finish_reason}],
                'usage': {'prompt_tokens': len(prompt),
                          'completion_tokens': len(tokens)},
            })

    async def _stream_completion(self, s: OnlineStream,
                                 receive, send) -> None:
        """SSE-stream one request; a client disconnect cancels it (the
        robustness half: the lease frees the moment the stream drops)."""
        await send({'type': 'http.response.start', 'status': 200,
                    'headers': [(k.encode(), v.encode())
                                for k, v in _SSE.items()]})
        disconnect = asyncio.get_running_loop().create_task(
            self._wait_disconnect(receive))
        try:
            it = s.__aiter__()
            while True:
                nxt = asyncio.get_running_loop().create_task(it.__anext__())
                done, _ = await asyncio.wait(
                    {nxt, disconnect}, return_when=asyncio.FIRST_COMPLETED)
                if disconnect in done:
                    nxt.cancel()
                    s.driver.cancel_stream(s.req_id)
                    return              # client gone: nothing to send
                try:
                    ev = nxt.result()
                except StopAsyncIteration:
                    break
                frame = {'id': s.req_id, 'object': 'text_completion.chunk',
                         'choices': [{'index': 0,
                                      'finish_reason': ev.finish_reason}]}
                if ev.token is not None:
                    frame['choices'][0].update(
                        token=ev.token, text=token_delta(ev.token, ev.index))
                await send({'type': 'http.response.body',
                            'body': encode_sse(json.dumps(frame),
                                               id=f'{s.req_id}:{ev.index}'),
                            'more_body': True})
            # terminal frame (finish_reason) then the [DONE] sentinel
            final = {'id': s.req_id, 'object': 'text_completion.chunk',
                     'choices': [{'index': 0,
                                  'finish_reason': s.finish_reason}]}
            await send({'type': 'http.response.body',
                        'body': encode_sse(json.dumps(final)),
                        'more_body': True})
            await send({'type': 'http.response.body', 'body': DONE_FRAME,
                        'more_body': False})
        finally:
            disconnect.cancel()

    async def _wait_disconnect(self, receive) -> None:
        while True:
            msg = await receive()
            if msg['type'] == 'http.disconnect':
                return

    # ------------------------------------------------------------------
    # Batch jobs
    # ------------------------------------------------------------------
    async def _batch_submit(self, match, scope, receive, send) -> None:
        body = await self._read_json(receive)
        reqs = body.get('requests')
        if not isinstance(reqs, list) or not reqs:
            raise _HTTPError(400, 'requests must be a non-empty list')
        if not self.node.offline:
            raise _HTTPError(503, 'node has no offline engines',
                             'service_unavailable')
        for i, spec in enumerate(reqs):
            if not isinstance(spec, dict) or 'prompt' not in spec:
                raise _HTTPError(400, f'requests[{i}] needs a prompt')
            p, mt = spec['prompt'], spec.get('max_tokens', 16)
            if (not isinstance(p, list) or not p
                    or not all(isinstance(t, int) and t >= 0 for t in p)):
                raise _HTTPError(400, f'requests[{i}].prompt must be a '
                                      'non-empty list of token ids')
            if not isinstance(mt, int) or mt < 1:
                raise _HTTPError(400, f'requests[{i}].max_tokens must be '
                                      'a positive integer')
            budget = max(e.cfg.max_seq for e in self.node.offline)
            if len(p) + mt > budget:
                raise _HTTPError(400, f'requests[{i}] exceeds the offline '
                                      f'budget of {budget}')
        job = self.batches.submit(reqs)
        self.driver.kick()
        await self._respond(send, 200, job.to_dict())

    def _job_or_404(self, match) -> 'object':
        job = self.batches.get(match.group('bid'))
        if job is None:
            raise _HTTPError(404, f'no batch {match.group("bid")!r}',
                             'not_found')
        return job

    async def _batch_status(self, match, scope, receive, send) -> None:
        await self._respond(send, 200, self._job_or_404(match).to_dict())

    async def _batch_cancel(self, match, scope, receive, send) -> None:
        self._job_or_404(match)
        job = self.batches.cancel(match.group('bid'))
        await self._respond(send, 200, job.to_dict())

    async def _batch_results(self, match, scope, receive, send) -> None:
        job = self._job_or_404(match)
        results = self.batches.results(job.job_id)
        if results is None:
            raise _HTTPError(409, f'batch {job.job_id!r} is {job.status}, '
                                  'not terminal', 'conflict')
        for r in results:
            r['text'] = token_text(r['tokens'])
        await self._respond(send, 200,
                            {'id': job.job_id, 'object': 'batch.results',
                             'results': results})

    # ------------------------------------------------------------------
    # Introspection
    # ------------------------------------------------------------------
    async def _metrics(self, match, scope, receive, send) -> None:
        await self._respond(send, 200, self.node.metrics())

    async def _health(self, match, scope, receive, send) -> None:
        await self._respond(send, 200, {
            'status': 'ok',
            'online': self.node.online is not None,
            'offline_engines': len(self.node.offline),
            'has_work': self.node.has_work(),
        })
