"""The SSE wire format of the port's front-end against the reference's:
every protocol case of ``tests/test_sse.py`` (encoder, incremental parser
under any chunk split, line endings, ``[DONE]``, strict-mode rejection),
run on both packages' ``sse`` modules, and the end-to-end gates on the
port's stack: streamed token text bit-identical to a plain drain, and the
wire order of a stream's last frames.

The port keeps its own copy of ``sse`` (it may not import the reference),
so each case counts once per package.
"""
import asyncio
import json

import numpy as np
import pytest

from repro.serving.frontend import sse as ref_sse
from repro_torch.serving.frontend import sse as port_sse


@pytest.fixture(params=[ref_sse, port_sse], ids=['reference', 'port'])
def sse(request):
    return request.param

# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def test_encode_basic_frame(sse):
    assert sse.encode_sse('hello') == b'data: hello\n\n'


def test_encode_with_event_and_id(sse):
    assert sse.encode_sse('x', event='tok', id='r1:0') == \
        b'event: tok\nid: r1:0\ndata: x\n\n'


def test_encode_multiline_data_one_line_per_data_field(sse):
    assert sse.encode_sse('a\nb') == b'data: a\ndata: b\n\n'


def test_encode_retry(sse):
    assert sse.encode_sse('x', retry=250) == b'retry: 250\ndata: x\n\n'


def test_done_frame_constant(sse):
    assert sse.DONE_FRAME == b'data: [DONE]\n\n'


# ---------------------------------------------------------------------------
# Parser: happy path
# ---------------------------------------------------------------------------

def test_parse_single_frame(sse):
    (ev,) = sse.SSEParser().feed(b'data: hello\n\n')
    assert ev.data == 'hello' and ev.event == 'message' and not ev.done


def test_parse_roundtrip_with_fields(sse):
    (ev,) = sse.SSEParser().feed(sse.encode_sse('payload', event='tok', id='a:1'))
    assert (ev.data, ev.event, ev.id) == ('payload', 'tok', 'a:1')


def test_parse_multiple_frames_in_one_chunk(sse):
    evs = sse.SSEParser().feed(sse.encode_sse('one') + sse.encode_sse('two'))
    assert [e.data for e in evs] == ['one', 'two']


def test_multiline_data_joined_with_newline(sse):
    (ev,) = sse.SSEParser().feed(b'data: a\ndata: b\n\n')
    assert ev.data == 'a\nb'


def test_no_space_after_colon(sse):
    (ev,) = sse.SSEParser().feed(b'data:tight\n\n')
    assert ev.data == 'tight'


def test_comment_lines_ignored(sse):
    p = sse.SSEParser()
    assert p.feed(b': keep-alive ping\n\n') == []
    (ev,) = p.feed(b': note\ndata: x\n\n')
    assert ev.data == 'x'


def test_crlf_and_cr_line_endings(sse):
    (ev,) = sse.SSEParser().feed(b'data: a\r\ndata: b\r\n\r\n')
    assert ev.data == 'a\nb'
    p = sse.SSEParser()
    assert p.feed(b'data: a\rdata: b\r\r') == []   # last CR: LF may follow
    (ev,) = p.finish()                             # EOF resolves the CR
    assert ev.data == 'a\nb'


def test_done_sets_closed(sse):
    p = sse.SSEParser()
    (ev,) = p.feed(sse.DONE_FRAME)
    assert ev.done and ev.data == sse.DONE_DATA and p.closed


def test_id_is_sticky_across_frames(sse):
    p = sse.SSEParser()
    (a,) = p.feed(b'id: 7\ndata: x\n\n')
    (b,) = p.feed(b'data: y\n\n')
    assert a.id == '7' and b.id == '7'


# ---------------------------------------------------------------------------
# Parser: split-across-chunks (the incremental contract)
# ---------------------------------------------------------------------------

def _feed_split(sse, frame: bytes, step: int):
    p = sse.SSEParser()
    out = []
    for i in range(0, len(frame), step):
        out += p.feed(frame[i:i + step])
    p.finish()
    return out


def test_byte_by_byte_equals_whole_frame(sse):
    frame = sse.encode_sse(json.dumps({'t': 42}), event='tok', id='r:0') \
        + sse.encode_sse('x') + sse.DONE_FRAME
    whole = sse.SSEParser().feed(frame)
    for step in (1, 2, 3, 5, 7, len(frame)):
        assert _feed_split(sse, frame, step) == whole


def test_split_mid_utf8_codepoint(sse):
    frame = sse.encode_sse('héllo wörld ✓')
    whole = sse.SSEParser().feed(frame)
    assert _feed_split(sse, frame, 1) == whole       # splits every multibyte char


def test_split_between_cr_and_lf(sse):
    # the CR/LF pair split across chunks must not double-break
    p = sse.SSEParser()
    assert p.feed(b'data: a\r') == []
    (ev,) = p.feed(b'\ndata: b\n\n')
    assert ev.data == 'a\nb'


def test_frame_split_at_blank_line(sse):
    p = sse.SSEParser()
    assert p.feed(b'data: x\n') == []
    (ev,) = p.feed(b'\n')
    assert ev.data == 'x'


# ---------------------------------------------------------------------------
# Parser: malformed-frame rejection (strict) vs lenient mode
# ---------------------------------------------------------------------------

def test_unknown_field_rejected_strict(sse):
    with pytest.raises(sse.SSEProtocolError):
        sse.SSEParser().feed(b'bogus: x\ndata: y\n\n')


def test_unknown_field_ignored_lenient(sse):
    (ev,) = sse.SSEParser(strict=False).feed(b'bogus: x\ndata: y\n\n')
    assert ev.data == 'y'


def test_dataless_frame_rejected_strict(sse):
    with pytest.raises(sse.SSEProtocolError):
        sse.SSEParser().feed(b'event: tok\n\n')


def test_dataless_frame_dropped_lenient(sse):
    assert sse.SSEParser(strict=False).feed(b'event: tok\n\n') == []


def test_non_integer_retry_rejected_strict(sse):
    with pytest.raises(sse.SSEProtocolError):
        sse.SSEParser().feed(b'retry: soon\ndata: x\n\n')


def test_invalid_utf8_rejected_strict(sse):
    with pytest.raises(sse.SSEProtocolError):
        sse.SSEParser().feed(b'data: \xff\xfe broken\n\n')


def test_truncated_stream_rejected_at_finish(sse):
    p = sse.SSEParser()
    p.feed(b'data: never terminated')
    with pytest.raises(sse.SSEProtocolError):
        p.finish()


def test_clean_stream_finishes_quietly(sse):
    p = sse.SSEParser()
    p.feed(sse.encode_sse('x') + sse.DONE_FRAME)
    assert p.finish() == []


# ---------------------------------------------------------------------------
# End-to-end on the port: streamed token text == a plain drain
# ---------------------------------------------------------------------------

def _tiny_node():
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.clock import VirtualClock
    from repro_torch.core.runtime import RuntimeConfig, ValveRuntime
    from repro_torch.launch.node import NodeOrchestrator
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.kvpool import KVPool

    pool = KVPool(8, 4, page_size=4, reserved_handles=1)
    rt = ValveRuntime(pool, RuntimeConfig(n_devices=1, t_cool_init=0.002),
                      clock=VirtualClock())
    node = NodeOrchestrator(rt, idle_advance=1e-3)
    node.add_engine(reduced(get_config('qwen3-0.6b'), page_size=4),
                    EngineConfig(max_batch=4, max_seq=48, prefill_chunk=8,
                                 klass='online'), seed=0, name='online',
                    device='cpu')
    return node


def _prompts(node, n, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, node.online.mcfg.vocab_size, 10).tolist()
            for _ in range(n)]


def test_streamed_text_bit_identical_to_drain():
    """Greedy decoding is deterministic, so the SSE deltas reassembled
    over the wire must equal the drain path's rendered text exactly."""
    from repro_torch.serving.frontend.app import FrontendApp, token_text
    from repro_torch.serving.frontend.driver import AsyncNodeDriver
    from repro_torch.serving.frontend.testing import ASGIClient

    ref_node = _tiny_node()
    prompts = _prompts(ref_node, 3)
    ref_rids = [ref_node.online.submit(p, max_new_tokens=6)
                for p in prompts]
    ref_node.drain(max_steps=5000)
    ref_texts = [token_text(ref_node.online.output_tokens(r))
                 for r in ref_rids]

    async def streamed():
        node = _tiny_node()
        async with AsyncNodeDriver(node) as driver:
            client = ASGIClient(FrontendApp(driver))
            texts = []
            for p in prompts:
                sr = client.stream('POST', '/v1/completions',
                                   json={'prompt': p, 'max_tokens': 6,
                                         'stream': True})
                parts = []
                async with sr:
                    assert sr.status == 200
                    assert sr.headers['content-type'] == 'text/event-stream'
                    async for ev in sr.events():   # strict parser
                        if ev.done:
                            break
                        chunk = json.loads(ev.data)['choices'][0]
                        if chunk.get('token') is not None:
                            parts.append(chunk['text'])
                texts.append(''.join(parts))
            return texts

    assert asyncio.run(streamed()) == ref_texts


def test_stream_terminates_with_done_after_finish_reason():
    """Wire order: token frames, then exactly one finish_reason frame,
    then [DONE], then EOF."""
    from repro_torch.serving.frontend.app import FrontendApp
    from repro_torch.serving.frontend.driver import AsyncNodeDriver
    from repro_torch.serving.frontend.testing import ASGIClient

    async def run():
        node = _tiny_node()
        async with AsyncNodeDriver(node) as driver:
            client = ASGIClient(FrontendApp(driver))
            (prompt,) = _prompts(node, 1)
            sr = client.stream('POST', '/v1/completions',
                               json={'prompt': prompt, 'max_tokens': 4,
                                     'stream': True})
            events = []
            async with sr:
                async for ev in sr.events():
                    events.append(ev)
            return events

    events = asyncio.run(run())
    assert events[-1].done
    payloads = [json.loads(e.data)['choices'][0] for e in events[:-1]]
    tokens = [p for p in payloads if p.get('token') is not None]
    finals = [p for p in payloads if p.get('token') is None]
    assert len(tokens) == 4
    assert all(p['finish_reason'] is None for p in tokens)
    assert [p['finish_reason'] for p in finals] == ['length']


def test_sse_module_imports_without_torch():
    """The package's lazy ``__init__`` keeps the wire format free of the
    engine: importing ``sse`` in a fresh interpreter loads no torch."""
    import subprocess
    import sys
    from pathlib import Path
    src = Path(__file__).resolve().parents[1] / 'src'
    code = ('import sys; sys.path.insert(0, %r); '
            'import repro_torch.serving.frontend.sse; '
            'print("torch" in sys.modules)') % str(src)
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    assert out.strip() == 'False'
