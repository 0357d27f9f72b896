"""Minimal HTTP/1.1 ⇄ ASGI adapter over asyncio streams.

The container ships no ASGI server (no uvicorn/hypercorn), so this module
bridges real sockets to the front-end app: request parsing, chunked
streaming responses (what SSE rides on), and client-disconnect
propagation (a dropped TCP peer surfaces to the app as
``{'type': 'http.disconnect'}`` — the same contract the in-process test
client implements, so the cancellation path is identical on a live
socket).

Deliberately small: HTTP/1.1 only, ``Connection: close`` semantics, one
request per connection, no TLS — a demo/benchmark entry point
(``python -m repro_torch.launch.serve --http``), not a production edge.  The
protocol tests run in-process via :mod:`repro_torch.serving.frontend.testing`;
this adapter's loopback coverage is ``chip_smoke.py``'s socket leg and its
``serve --http`` subprocess.
"""
from __future__ import annotations

import asyncio
from typing import Optional, Tuple

__all__ = ['serve_asgi', 'AsgiHttpServer']

_MAX_HEADER = 65536


async def _read_request(reader: asyncio.StreamReader
                        ) -> Optional[Tuple[str, str, list, bytes]]:
    """Parse one request; returns (method, path, headers, body)."""
    try:
        head = await reader.readuntil(b'\r\n\r\n')
    except (asyncio.IncompleteReadError, ConnectionError):
        return None
    except asyncio.LimitOverrunError:
        return None
    if len(head) > _MAX_HEADER:
        return None
    lines = head.decode('latin-1').split('\r\n')
    try:
        method, target, _version = lines[0].split(' ', 2)
    except ValueError:
        return None
    headers = []
    for line in lines[1:]:
        if not line:
            continue
        name, _, value = line.partition(':')
        headers.append((name.strip().lower().encode('latin-1'),
                        value.strip().encode('latin-1')))
    length = 0
    for k, v in headers:
        if k == b'content-length':
            try:
                length = int(v)
            except ValueError:
                return None
    body = await reader.readexactly(length) if length else b''
    path = target.split('?', 1)[0]
    return method, path, headers, body


class AsgiHttpServer:
    """Serve one ASGI app on a listening socket."""

    def __init__(self, app, host: str = '127.0.0.1', port: int = 8080):
        self.app = app
        self.host = host
        self.port = port
        self._server: Optional[asyncio.base_events.Server] = None

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        sock = self._server.sockets[0]
        self.port = sock.getsockname()[1]     # resolve port 0

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def serve_forever(self) -> None:
        assert self._server is not None, 'call start() first'
        await self._server.serve_forever()

    # ------------------------------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            req = await _read_request(reader)
            if req is None:
                return
            method, path, headers, body = req
            await self._dispatch(method, path, headers, body,
                                 reader, writer)
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _dispatch(self, method, path, headers, body,
                        reader, writer) -> None:
        scope = {
            'type': 'http', 'asgi': {'version': '3.0'},
            'http_version': '1.1', 'method': method.upper(),
            'scheme': 'http', 'path': path, 'raw_path': path.encode(),
            'query_string': b'', 'headers': headers,
            'client': writer.get_extra_info('peername'),
            'server': (self.host, self.port),
        }
        sent_body = False
        disconnected = asyncio.Event()

        async def watch_peer() -> None:
            # after the body, any read returning b'' means the peer closed
            # (we never pipeline, so nothing legitimate arrives here)
            try:
                data = await reader.read(1)
                if not data:
                    disconnected.set()
            except (ConnectionError, OSError):
                disconnected.set()

        watcher = asyncio.get_running_loop().create_task(watch_peer())

        async def receive() -> dict:
            nonlocal sent_body
            if not sent_body:
                sent_body = True
                return {'type': 'http.request', 'body': body,
                        'more_body': False}
            await disconnected.wait()
            return {'type': 'http.disconnect'}

        state = {'started': False, 'chunked': False}

        async def send(msg: dict) -> None:
            if disconnected.is_set():
                return                      # peer gone: drop silently
            try:
                if msg['type'] == 'http.response.start':
                    state['started'] = True
                    hdrs = list(msg.get('headers', []))
                    has_len = any(k.lower() == b'content-length'
                                  for k, _ in hdrs)
                    lines = [f'HTTP/1.1 {msg["status"]} '
                             f'{_reason(msg["status"])}'.encode('latin-1')]
                    for k, v in hdrs:
                        lines.append(k + b': ' + v)
                    if not has_len:
                        state['chunked'] = True
                        lines.append(b'transfer-encoding: chunked')
                    lines.append(b'connection: close')
                    writer.write(b'\r\n'.join(lines) + b'\r\n\r\n')
                elif msg['type'] == 'http.response.body':
                    data = msg.get('body', b'')
                    if state['chunked']:
                        if data:
                            writer.write(
                                f'{len(data):x}\r\n'.encode() + data
                                + b'\r\n')
                        if not msg.get('more_body', False):
                            writer.write(b'0\r\n\r\n')
                    else:
                        writer.write(data)
                    await writer.drain()
            except (ConnectionError, OSError):
                disconnected.set()

        try:
            await self.app(scope, receive, send)
        finally:
            watcher.cancel()


def _reason(status: int) -> str:
    return {200: 'OK', 400: 'Bad Request', 404: 'Not Found',
            409: 'Conflict', 500: 'Internal Server Error',
            503: 'Service Unavailable'}.get(status, 'Unknown')


async def serve_asgi(app, host: str = '127.0.0.1', port: int = 8080
                     ) -> AsgiHttpServer:
    """Start serving ``app``; returns the (started) server handle."""
    server = AsgiHttpServer(app, host, port)
    await server.start()
    return server
