"""Async serving front-end over :class:`~repro_torch.launch.node.NodeOrchestrator`.

One event loop owns the runtime (:class:`AsyncNodeDriver` pumps
``node.step()`` cooperatively with request intake); the HTTP surface is a
framework-free ASGI app (:class:`FrontendApp`) with an OpenAI-style
streaming online API (``POST /v1/completions`` + SSE) and an offline
batch-job API (``POST /v1/batches`` submit → poll → fetch).  See
``docs/API.md`` § Serving endpoints.

Submodules (import the ones you need — keeps :mod:`.sse` free of the
engine/torch dependency chain):

- :mod:`.sse`      — SSE wire format (encoder + incremental parser)
- :mod:`.driver`   — the asyncio pump, online token streams, cancellation
- :mod:`.batches`  — batch jobs over the offline plane (lazy allocation)
- :mod:`.app`      — the ASGI application
- :mod:`.testing`  — deterministic in-process ASGI client (no sockets)
- :mod:`.http`     — minimal HTTP/1.1 ⇄ ASGI socket adapter
- :mod:`.loadgen`  — trace-replay async load generator
"""
from __future__ import annotations

__all__ = ['AsyncNodeDriver', 'FrontendApp', 'BatchManager', 'SSEParser',
           'encode_sse']


def __getattr__(name):
    # lazy: `import repro_torch.serving.frontend` must not drag in torch via
    # the driver's NodeOrchestrator import unless those symbols are touched
    if name in ('AsyncNodeDriver', 'OnlineStream', 'TokenEvent'):
        from repro_torch.serving.frontend import driver
        return getattr(driver, name)
    if name == 'FrontendApp':
        from repro_torch.serving.frontend.app import FrontendApp
        return FrontendApp
    if name == 'BatchManager':
        from repro_torch.serving.frontend.batches import BatchManager
        return BatchManager
    if name in ('SSEParser', 'SSEEvent', 'encode_sse'):
        from repro_torch.serving.frontend import sse
        return getattr(sse, name)
    raise AttributeError(name)
