"""Deterministic in-process ASGI test client — no sockets, no threads.

The protocol test harness (``tests/test_frontend.py``,
``tests/test_sse.py``) and the trace-replay load generator drive the
front-end through this client: it calls the ASGI app coroutine directly
on the current event loop, so requests, the driver pump, and SSE delivery
interleave at deterministic ``await`` points.  Combined with a
:class:`~repro_torch.core.clock.VirtualClock` on the node, an entire
timeout/pacing scenario runs without a single wall-clock sleep.

Mid-stream client disconnects are first-class:
:meth:`StreamingResponse.disconnect` makes the app's next ``receive()``
return ``{'type': 'http.disconnect'}`` — exactly what a real server does
when the TCP peer drops — which is how the cancellation/leak regression
tests sever a stream at a precise token boundary.
"""
from __future__ import annotations

import asyncio
import json as _json
from typing import AsyncIterator, Dict, List, Optional, Tuple

from repro_torch.serving.frontend.sse import SSEEvent, SSEParser

__all__ = ['ASGIClient', 'Response', 'StreamingResponse']


class Response:
    """A fully-buffered HTTP response."""

    def __init__(self, status: int, headers: List[Tuple[bytes, bytes]],
                 body: bytes):
        self.status = status
        self.headers: Dict[str, str] = {
            k.decode().lower(): v.decode() for k, v in headers}
        self.body = body

    def json(self):
        return _json.loads(self.body)

    def __repr__(self) -> str:
        return f'Response({self.status}, {len(self.body)}B)'


def _scope(method: str, path: str, headers: List[Tuple[bytes, bytes]]):
    return {
        'type': 'http', 'asgi': {'version': '3.0'},
        'http_version': '1.1', 'method': method.upper(),
        'scheme': 'http', 'path': path, 'raw_path': path.encode(),
        'query_string': b'', 'headers': headers,
        'client': ('testclient', 0), 'server': ('testserver', 80),
    }


class StreamingResponse:
    """Handle on an in-flight streaming request (async context manager).

    The app runs as a task on the same loop; body chunks surface through
    :meth:`chunks` and parsed SSE events through :meth:`events`.
    """

    def __init__(self, app, scope: dict, body: bytes):
        self._app = app
        self._scope = scope
        self._body = body
        self._sent_body = False
        self._disconnected = asyncio.Event()
        self._chunks: asyncio.Queue = asyncio.Queue()
        self._started = asyncio.Event()
        self.status: Optional[int] = None
        self.headers: Dict[str, str] = {}
        self._task: Optional[asyncio.Task] = None

    # -- ASGI plumbing ------------------------------------------------------
    async def _receive(self) -> dict:
        if not self._sent_body:
            self._sent_body = True
            return {'type': 'http.request', 'body': self._body,
                    'more_body': False}
        await self._disconnected.wait()
        return {'type': 'http.disconnect'}

    async def _send(self, msg: dict) -> None:
        if msg['type'] == 'http.response.start':
            self.status = msg['status']
            self.headers = {k.decode().lower(): v.decode()
                            for k, v in msg.get('headers', [])}
            self._started.set()
        elif msg['type'] == 'http.response.body':
            body = msg.get('body', b'')
            if body:
                self._chunks.put_nowait(body)
            if not msg.get('more_body', False):
                self._chunks.put_nowait(None)          # EOF marker

    async def _run(self) -> None:
        try:
            await self._app(self._scope, self._receive, self._send)
        finally:
            self._started.set()
            self._chunks.put_nowait(None)

    # -- public surface -----------------------------------------------------
    async def __aenter__(self) -> 'StreamingResponse':
        self._task = asyncio.get_running_loop().create_task(self._run())
        await self._started.wait()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.aclose()

    async def aclose(self) -> None:
        """Sever the stream (client hang-up) and join the app task."""
        self._disconnected.set()
        if self._task is not None:
            await self._task
            self._task = None

    async def disconnect(self) -> None:
        """Simulate the TCP peer dropping mid-stream, then wait for the
        app to observe it and unwind (cancellation path)."""
        await self.aclose()

    async def chunks(self) -> AsyncIterator[bytes]:
        """Raw body chunks exactly as the app sent them."""
        while True:
            chunk = await self._chunks.get()
            if chunk is None:
                return
            yield chunk

    async def events(self, *, strict: bool = True
                     ) -> AsyncIterator[SSEEvent]:
        """Parsed SSE events (including the ``[DONE]`` terminator)."""
        parser = SSEParser(strict=strict)
        async for chunk in self.chunks():
            for ev in parser.feed(chunk):
                yield ev


class ASGIClient:
    """In-process client for one ASGI app."""

    def __init__(self, app):
        self.app = app

    def _prep(self, method: str, path: str, json=None, body: bytes = b''
              ) -> Tuple[dict, bytes]:
        headers = [(b'host', b'testserver')]
        if json is not None:
            body = _json.dumps(json).encode()
            headers.append((b'content-type', b'application/json'))
        headers.append((b'content-length', str(len(body)).encode()))
        return _scope(method, path, headers), body

    async def request(self, method: str, path: str, *, json=None,
                      body: bytes = b'') -> Response:
        """Run one non-streaming request to completion."""
        scope, body = self._prep(method, path, json, body)
        sr = StreamingResponse(self.app, scope, body)
        async with sr:
            buf = b''
            async for chunk in sr.chunks():
                buf += chunk
        assert sr.status is not None, 'app sent no response'
        return Response(sr.status,
                        [(k.encode(), v.encode())
                         for k, v in sr.headers.items()], buf)

    async def get(self, path: str) -> Response:
        return await self.request('GET', path)

    async def post(self, path: str, *, json=None) -> Response:
        return await self.request('POST', path, json=json)

    def stream(self, method: str, path: str, *,
               json=None) -> StreamingResponse:
        """Open a streaming request: ``async with client.stream(...) as s``.
        Iterate ``s.events()``; call ``s.disconnect()`` to drop mid-way."""
        scope, body = self._prep(method, path, json)
        return StreamingResponse(self.app, scope, body)
