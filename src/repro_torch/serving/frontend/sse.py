"""Server-Sent Events wire format — encoder + incremental parser.

The online streaming API (``POST /v1/completions`` with ``stream: true``)
speaks SSE (`text/event-stream`): UTF-8 frames of ``field: value`` lines
separated by a blank line, terminated by the OpenAI-style ``data: [DONE]``
sentinel.  This module is the single source of truth for that framing on
both sides of the wire — the app encodes with :func:`encode_sse`, and the
test harness / load generator decode with :class:`SSEParser`, an
incremental parser that is correct under arbitrary chunk boundaries (a
frame split anywhere, including mid-codepoint, reassembles exactly).

``tests/test_sse.py`` is the conformance suite: split-across-chunks
frames, CR/CRLF/LF line endings, multi-line data joining, comment lines,
``[DONE]`` termination, and malformed-frame rejection in strict mode.
"""
from __future__ import annotations

from typing import Iterator, List, NamedTuple, Optional, Union

__all__ = ['SSEEvent', 'SSEParser', 'SSEProtocolError', 'encode_sse',
           'DONE_DATA', 'DONE_FRAME']

# the OpenAI streaming termination sentinel (a data-only frame)
DONE_DATA = '[DONE]'
DONE_FRAME = b'data: [DONE]\n\n'

# fields the SSE spec defines; anything else is malformed in strict mode
# (the spec says "ignore", but our own encoder never emits them, so a
# strict consumer treats one as a corrupted stream)
_KNOWN_FIELDS = ('data', 'event', 'id', 'retry')


class SSEProtocolError(ValueError):
    """A frame violated the event-stream grammar (strict mode)."""


class SSEEvent(NamedTuple):
    """One dispatched server-sent event."""
    data: str
    event: str = 'message'
    id: Optional[str] = None
    retry: Optional[int] = None

    @property
    def done(self) -> bool:
        """True for the ``data: [DONE]`` stream terminator."""
        return self.data == DONE_DATA


def encode_sse(data: str, *, event: Optional[str] = None,
               id: Optional[str] = None,
               retry: Optional[int] = None) -> bytes:
    """Encode one event frame.  Multi-line ``data`` becomes one ``data:``
    line per line (the parser re-joins them with ``\\n``)."""
    parts: List[str] = []
    if event is not None:
        assert '\n' not in event and '\r' not in event, event
        parts.append(f'event: {event}')
    if id is not None:
        assert '\n' not in id and '\r' not in id and '\0' not in id, id
        parts.append(f'id: {id}')
    if retry is not None:
        assert retry >= 0, retry
        parts.append(f'retry: {int(retry)}')
    for line in data.split('\n'):
        parts.append(f'data: {line}')
    return ('\n'.join(parts) + '\n\n').encode('utf-8')


def encode_done() -> bytes:
    return DONE_FRAME


class SSEParser:
    """Incremental ``text/event-stream`` parser.

    Feed raw byte chunks exactly as they arrive off the wire; each call
    returns the events *completed* by that chunk.  Partial lines, partial
    UTF-8 sequences and partial frames are buffered across calls, so any
    split of the byte stream parses identically to the unsplit stream.

    ``strict=True`` (the default — what the protocol tests run) raises
    :class:`SSEProtocolError` on frames our encoder could never have
    produced: unknown field names, a non-integer ``retry``, a frame that
    dispatches without any ``data`` line, or invalid UTF-8.
    """

    def __init__(self, *, strict: bool = True):
        self.strict = strict
        self._buf = b''          # undecoded bytes (may end mid-codepoint)
        self._tail = ''          # decoded text of the current partial line
        self._data: List[str] = []
        self._event: Optional[str] = None
        self._id: Optional[str] = None
        self._retry: Optional[int] = None
        self._saw_field = False  # current frame carried any field line
        self.closed = False      # saw the [DONE] terminator

    # ------------------------------------------------------------------
    def feed(self, chunk: Union[bytes, str]) -> List[SSEEvent]:
        """Consume one wire chunk; return the events it completed."""
        if isinstance(chunk, str):
            chunk = chunk.encode('utf-8')
        self._buf += chunk
        text, self._buf = self._decode_progress(self._buf)
        events: List[SSEEvent] = []
        # normalize CRLF/CR to LF, honoring a CR that ends the chunk (the
        # matching LF may arrive in the next chunk)
        text = self._tail + text
        self._tail = ''
        if text.endswith('\r'):
            text, self._tail = text[:-1], '\r'
        text = text.replace('\r\n', '\n').replace('\r', '\n')
        lines = text.split('\n')
        # the last element is an incomplete line — buffer it
        self._tail = lines.pop() + self._tail
        for line in lines:
            ev = self._line(line)
            if ev is not None:
                events.append(ev)
        return events

    def finish(self) -> List[SSEEvent]:
        """Signal end-of-stream.  A CR held back in case an LF followed is
        now known to be a bare-CR terminator — flush it.  After that, a
        dangling partial frame is a protocol error in strict mode (frames
        end with a blank line)."""
        events: List[SSEEvent] = []
        if self._tail.endswith('\r'):
            line, self._tail = self._tail[:-1], ''
            ev = self._line(line)
            if ev is not None:
                events.append(ev)
        if self.strict and (self._tail or self._buf or self._saw_field):
            raise SSEProtocolError('stream ended mid-frame')
        return events

    # ------------------------------------------------------------------
    def _decode_progress(self, buf: bytes) -> tuple:
        """Decode the longest valid UTF-8 prefix; keep the rest buffered.
        A partial multi-byte sequence at the end is not an error — it
        completes with the next chunk."""
        try:
            return buf.decode('utf-8'), b''
        except UnicodeDecodeError as e:
            # only a *suffix* shorter than a max-length codepoint may be
            # incomplete; anything else is real corruption
            if len(buf) - e.start <= 3 and e.reason.startswith(
                    ('unexpected end of data', 'invalid continuation')):
                try:
                    return buf[:e.start].decode('utf-8'), buf[e.start:]
                except UnicodeDecodeError:
                    pass
            if self.strict:
                raise SSEProtocolError(f'invalid UTF-8 in stream: {e}')
            return buf.decode('utf-8', errors='replace'), b''

    def _line(self, line: str) -> Optional[SSEEvent]:
        if line == '':
            return self._dispatch()
        if line.startswith(':'):         # comment (keep-alive pings)
            return None
        if ':' in line:
            field, _, value = line.partition(':')
            if value.startswith(' '):
                value = value[1:]
        else:
            field, value = line, ''
        self._saw_field = True
        if field == 'data':
            self._data.append(value)
        elif field == 'event':
            self._event = value
        elif field == 'id':
            if '\0' not in value:
                self._id = value
        elif field == 'retry':
            if value.isdigit():
                self._retry = int(value)
            elif self.strict:
                raise SSEProtocolError(f'non-integer retry: {value!r}')
        elif self.strict:
            raise SSEProtocolError(f'unknown SSE field: {field!r}')
        return None

    def _dispatch(self) -> Optional[SSEEvent]:
        saw_field, self._saw_field = self._saw_field, False
        data, self._data = self._data, []
        event, self._event = self._event, None
        retry, self._retry = self._retry, None
        if not data:
            # per spec a dataless frame dispatches nothing; our encoder
            # never produces one, so strict mode rejects it (unless the
            # "frame" was pure comments/blank lines — those are fine)
            if saw_field and self.strict:
                raise SSEProtocolError('frame dispatched without data')
            return None
        ev = SSEEvent(data='\n'.join(data), event=event or 'message',
                      id=self._id, retry=retry)
        if ev.done:
            self.closed = True
        return ev


def parse_sse_stream(chunks: Iterator[bytes], *,
                     strict: bool = True) -> Iterator[SSEEvent]:
    """Convenience: parse an iterable of wire chunks into events."""
    p = SSEParser(strict=strict)
    for chunk in chunks:
        yield from p.feed(chunk)
    p.finish()
