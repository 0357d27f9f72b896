"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one.  The file imports
neither jax nor the JAX package, so it runs on a machine that has only the
port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: bf16 attention outputs, elementwise |got - want| <= 1e-3 +
2^-7 |want| (one bf16 ulp: a correct kernel may round the other way;
``test_torch_kernels_paged.py`` shows it fails a dropped page, a shifted
start and a skipped initial state); the f32 partial softmax state, 1e-4; sampled
tokens equal unless the two best f32 scores lie within 1e-5 of |max| (the
kernel and its plain version sum the dot products in other orders);
flash attention, the bf16 rule above and 2e-5 in f32; WKV6, 1e-4 in f32
(1e-3 at log-decays down to -12), 3e-2 for bf16 inputs, as in the
reference's kernel tests.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.common import LAUNCHES, gumbel_hash_noise
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.paged_attention import ops as pa
from repro_torch.kernels.paged_attention.prefix import build_shared_runs
from repro_torch.kernels.paged_attention.ref import (paged_decode_ref,
                                                     shared_run_ref)
from repro_torch.kernels.rwkv6.ops import wkv6
from repro_torch.kernels.rwkv6.ref import wkv6_chunked, wkv6_ref
from repro_torch.kernels.sampling.ops import fused_unembed_sample
from repro_torch.kernels.sampling.ref import (unembed_sample_ref,
                                              unembed_scores)

pytestmark = pytest.mark.cuda

BF16_TOL = dict(rtol=2 ** -7, atol=1e-3)

PAGED_CASES = [
    # (B, Hq, Hkv, D, pg, maxp)
    (2, 4, 4, 64, 16, 4),
    (2, 8, 2, 64, 16, 8),
    (8, 16, 8, 128, 16, 32),          # qwen3-0.6b decode
    (3, 4, 1, 32, 8, 5),
    (2, 4, 2, 64, 4, 16),
]
FLASH_CASES = [
    # (B, Sq, Skv, Hq, Hkv, D, causal, dtype)
    (1, 128, 128, 4, 4, 64, True, torch.float32),
    (2, 256, 256, 8, 2, 64, True, torch.float32),
    (1, 128, 128, 4, 1, 128, True, torch.bfloat16),
    (2, 192, 192, 4, 2, 32, True, torch.float32),
    (1, 64, 256, 2, 2, 64, False, torch.float32),
    (2, 100, 100, 4, 4, 64, True, torch.float32),
    (1, 300, 200, 4, 2, 128, True, torch.bfloat16),    # Sq > Skv
    (2, 1024, 1024, 16, 8, 128, True, torch.bfloat16),  # qwen3-0.6b
]
WKV_CASES = [
    # (B, T, H, K, chunk, dtype)
    (2, 64, 2, 16, 16, torch.float32),
    (1, 128, 4, 32, 32, torch.float32),
    (2, 100, 2, 16, 32, torch.float32),
    (1, 64, 2, 64, 16, torch.bfloat16),
    (3, 48, 1, 16, 64, torch.float32),
    (2, 1000, 40, 64, 64, torch.float32),             # rwkv6-3b heads
]
SAMPLE_CASES = [
    # (B, D, V): ragged vocab tiles, two launches' worth of rows, and the
    # qwen3-0.6b head
    (1, 32, 257), (4, 64, 1000), (5, 32, 130), (20, 64, 1000),
    (8, 1024, 151936),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the CUDA kernels run only there')
    return torch.device('cuda')


def _bf16(dev, rng, *shape, scale=0.5):
    return torch.tensor(rng.normal(size=shape) * scale, dtype=torch.bfloat16,
                        device=dev)


def _paged_inputs(dev, case, seed):
    b, hq, hkv, d, pg, maxp = case
    rng = np.random.default_rng(seed)
    n_pages = b * maxp + 1
    q = _bf16(dev, rng, b, hkv, hq // hkv, d)
    pk = _bf16(dev, rng, n_pages, pg, hkv, d)
    pv = _bf16(dev, rng, n_pages, pg, hkv, d)
    pt = (rng.permutation(n_pages - 1)[:b * maxp] + 1).reshape(b, maxp)
    lengths = rng.integers(1, maxp * pg + 1, size=b)
    return (q, pk, pv, torch.tensor(pt, dtype=torch.int32, device=dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


@pytest.mark.parametrize('case', PAGED_CASES)
def test_paged_decode_matches_plain(cuda, case):
    q, pk, pv, pt, lengths = _paged_inputs(cuda, case, sum(case))
    before = LAUNCHES['paged_decode']
    got = pa.paged_decode(q, pk, pv, pt, lengths)
    torch.cuda.synchronize()
    assert LAUNCHES['paged_decode'] == before + 1
    want = paged_decode_ref(q, pk, pv, pt, lengths)
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)


def test_paged_decode_padding_rows_stay_in_the_pool(cuda):
    """The engine's padding rows (length 1, all-quarantine tables) read the
    quarantine page's first token and nothing else."""
    q, pk, pv, pt, lengths = _paged_inputs(cuda, PAGED_CASES[1], 1)
    pt[1] = 0
    lengths[1] = 1
    got = pa.paged_decode(q, pk, pv, pt, lengths)
    want = paged_decode_ref(q, pk, pv, pt, lengths)
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
    torch.testing.assert_close(got[1].float(),
                               pv[0, 0][:, None].expand_as(got[1]).float(),
                               **BF16_TOL)


@pytest.mark.parametrize('n_slots_cap', [4, 8])
def test_prefix_shared_matches_plain(cuda, n_slots_cap):
    """A shared 3-page prefix, one row that shares nothing, quarantine
    padding slots up to a power of two: K2's partial state and K3's output
    equal their plain versions."""
    rng = np.random.default_rng(6)
    b, hkv, g, d, pg, maxp = 5, 2, 4, 64, 4, 10
    n_pages = b * maxp + 4
    q = _bf16(cuda, rng, b, hkv, g, d)
    pk = _bf16(cuda, rng, n_pages, pg, hkv, d)
    pv = _bf16(cuda, rng, n_pages, pg, hkv, d)
    pt = np.arange(4, 4 + b * maxp, dtype=np.int32).reshape(b, maxp)
    pt[:4, :3] = [1, 2, 3]
    lengths = rng.integers(3 * pg + 1, maxp * pg + 1, size=b).astype(np.int32)
    runs = build_shared_runs(pt, lengths, pg)
    assert runs['n_slots'] == 3 and runs['start'][4] == 0

    def t(x, dtype=torch.int32):
        return torch.tensor(x, dtype=dtype, device=cuda)

    pages = t(runs['pages'][:n_slots_cap])
    mask = t(runs['mask'][:, :n_slots_cap], torch.float32)
    state = pa.shared_run(q, pk, pv, pages, mask)
    want_state = shared_run_ref(q, pk, pv, pages, mask)
    for got, want in zip(state, want_state):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    args = (t(runs['tail_pt']), t(runs['start']), t(lengths))
    got = pa.shared_tail(q, pk, pv, *args, state)
    want = paged_decode_ref(q, pk, pv, args[0], args[2], start=args[1],
                            state=want_state)
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
    full = paged_decode_ref(q, pk, pv, t(pt), t(lengths))
    torch.testing.assert_close(got.float(), full.float(), **BF16_TOL)


@pytest.mark.parametrize('case', FLASH_CASES)
def test_flash_attention_matches_plain(cuda, case):
    b, sq, skv, hq, hkv, d, causal, dtype = case
    rng = np.random.default_rng(sq + skv + d)
    q, k, v = (torch.tensor(rng.normal(size=(b, s, h, d)) * 0.5, dtype=dtype,
                            device=cuda)
               for s, h in ((sq, hq), (skv, hkv), (skv, hkv)))
    before = LAUNCHES['flash_attention']
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert LAUNCHES['flash_attention'] == before + 1
    assert got.dtype == dtype
    want = flash_attention_ref(q, k, v, causal=causal)
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
    else:
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def _wkv_inputs(dev, case, seed, decay_lo=-2.5):
    b, t, h, dk, _, dtype = case
    rng = np.random.default_rng(seed)
    xs = [rng.normal(size=(b, t, h, dk)) * 0.5 for _ in range(3)]
    xs.append(np.exp(rng.uniform(decay_lo, -0.005, size=(b, t, h, dk))))
    xs.append(rng.normal(size=(h, dk)) * 0.3)
    s0 = rng.normal(size=(b, h, dk, dk)) * 0.1
    return ([torch.tensor(x, dtype=dtype, device=dev) for x in xs]
            + [torch.tensor(s0, dtype=torch.float32, device=dev)])


@pytest.mark.parametrize('case', WKV_CASES)
def test_wkv6_matches_plain(cuda, case):
    xs = _wkv_inputs(cuda, case, sum(case[:5]))
    before = LAUNCHES['wkv6']
    y, s = wkv6(*xs, chunk=case[4])
    torch.cuda.synchronize()
    assert LAUNCHES['wkv6'] == before + 1
    assert y.dtype == case[5] and s.dtype == torch.float32
    f32 = [x.float() for x in xs]
    tol = 3e-2 if case[5] == torch.bfloat16 else 1e-4
    for want in (wkv6_ref(*f32), wkv6_chunked(*f32, chunk=case[4])):
        torch.testing.assert_close(y.float(), want[0], rtol=tol, atol=tol)
        torch.testing.assert_close(s, want[1], rtol=tol, atol=tol)


def test_wkv6_pathological_decay(cuda):
    xs = _wkv_inputs(cuda, (1, 64, 2, 16, 8, torch.float32), 3,
                     decay_lo=-12.0)
    y, s = wkv6(*xs, chunk=8)
    want = wkv6_ref(*xs)
    assert torch.isfinite(y).all()
    torch.testing.assert_close(y, want[0], rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(s, want[1], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize('case', SAMPLE_CASES)
@pytest.mark.parametrize('temperature', [0.0, 0.8])
def test_unembed_sample_matches_plain(cuda, case, temperature):
    b, d, v = case
    rng = np.random.default_rng(sum(case))
    last = _bf16(cuda, rng, b, d, scale=1.0)
    head = _bf16(cuda, rng, v, d, scale=d ** -0.5)
    before = LAUNCHES['unembed_sample']
    got = fused_unembed_sample(last, head, 5, temperature=temperature)
    torch.cuda.synchronize()
    assert LAUNCHES['unembed_sample'] == before + -(-b // 16)
    want = unembed_sample_ref(last, head, 5, temperature=temperature)
    s = unembed_scores(last, head)
    if temperature > 0:
        s = s / temperature + gumbel_hash_noise(
            5, torch.arange(b, device=cuda)[:, None],
            torch.arange(v, device=cuda)[None, :])
    rows = torch.arange(b, device=cuda)
    gap = (s[rows, want.long()] - s[rows, got.long()]).abs()
    assert ((got == want) | (gap <= 1e-5 * s.abs().amax(-1))).all()


def test_unembed_sample_first_occurrence_across_tiles(cuda):
    last = torch.ones(2, 16, dtype=torch.bfloat16, device=cuda)
    head = torch.zeros(300, 16, dtype=torch.bfloat16, device=cuda)
    head[[40, 200, 299]] = 1.0
    assert fused_unembed_sample(last, head).tolist() == [40, 40]


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q, pk, pv, pt, lengths = _paged_inputs(cuda, PAGED_CASES[1], 0)
    with pytest.raises(ValueError, match='dtype'):
        pa.paged_decode(q.float(), pk, pv, pt, lengths)
    with pytest.raises(ValueError, match='dtype'):
        pa.paged_decode(q, pk, pv, pt.long(), lengths)
    with pytest.raises(ValueError, match='contiguous'):
        pa.paged_decode(q, pk, pv, pt.T.contiguous().T, lengths)
    with pytest.raises(ValueError, match='on'):
        pa.paged_decode(q, pk.cpu(), pv, pt, lengths)
    last = torch.zeros(2, 64, dtype=torch.bfloat16, device=cuda)
    head = torch.zeros(100, 64, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match='row-major'):
        fused_unembed_sample(last, head.T.contiguous().T)
    with pytest.raises(ValueError, match='dtype'):
        fused_unembed_sample(last.float(), head)
    q = torch.zeros(1, 64, 4, 64, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match='dtype'):
        flash_attention(q, q.float(), q)
    with pytest.raises(ValueError, match='head dim'):
        flash_attention(q[..., :48].contiguous(), q[..., :48].contiguous(),
                        q[..., :48].contiguous())
    with pytest.raises(RuntimeError, match='no backward'):
        flash_attention(q.float().requires_grad_(), q.float(), q.float())
    xs = _wkv_inputs(cuda, WKV_CASES[0], 0)
    with pytest.raises(ValueError, match='dtype'):
        wkv6(*xs[:5], xs[5].double())
    with pytest.raises(ValueError, match='K = '):
        wkv6(*[x[..., :8].contiguous() for x in xs[:5]],
             xs[5][:, :, :8, :8].contiguous())


def test_engine_decodes_through_the_kernels(cuda):
    """An engine on the card with the defaults (decode_kernel=None) and the
    fused, prefix-shared options launches all four decode kernels, and
    neither prefill nor rwkv6 kernel."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.memory import MemoryPlane
    from repro_torch.models.api import build_model
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.serving.kvpool import KVPool

    cfg = reduced(get_config('qwen3-0.6b'), page_size=16, head_dim=64)
    model = build_model(cfg)
    params = model.init_params(0, device=cuda)
    pool = KVPool(16, 4, page_size=16, reserved_handles=1)
    MemoryPlane(pool, sharing=True)
    eng = Engine(model, params, pool,
                 EngineConfig(max_batch=4, max_seq=96, prefill_chunk=32,
                              fused_sampling=True,
                              prefix_shared_attention=True))
    prompt = np.random.default_rng(0).integers(1, cfg.vocab_size, 48).tolist()
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    rids = [eng.submit(prompt, max_new_tokens=8)]
    for _ in range(20):
        eng.step()
        if len(eng.requests[rids[0]].generated) >= 2:
            break
    rids += [eng.submit(prompt, max_new_tokens=8) for _ in range(2)]
    eng.run_to_completion()
    outs = [eng.output_tokens(r) for r in rids]
    assert all(len(o) == 8 and 0 <= min(o) and max(o) < cfg.vocab_size
               for o in outs)
    assert eng.stats.shared_page_reads_saved > 0
    decode = ('paged_decode', 'shared_run', 'shared_tail', 'unembed_sample')
    assert all(LAUNCHES[k] > 0 for k in decode), LAUNCHES
    assert LAUNCHES['flash_attention'] == LAUNCHES['wkv6'] == 0, LAUNCHES


def test_prefill_and_rwkv6_forward_run_through_the_kernels(cuda):
    """Reduced configs on the card: prefill launches K5 once per layer and
    agrees with the plain path; the rwkv6 loss launches K6 once per layer
    and agrees with the plain chunked path."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.api import build_model

    cfg = reduced(get_config('qwen3-0.6b'), page_size=16, head_dim=64)
    model = build_model(cfg)
    params = model.init_params(0, device=cuda).to(torch.float32)
    b, s = 2, 256
    tokens = torch.randint(0, cfg.vocab_size, (b, s), device=cuda)
    batch = {'tokens': tokens, 'page_table': torch.arange(
        1, 1 + b * s // 16, dtype=torch.int32, device=cuda).reshape(b, -1)}
    out = {}
    for use_kernel in (False, True):
        cache = {k: v.float() for k, v in model.init_cache(
            engine_pages=1 + b * s // 16, device=cuda).items()}
        LAUNCHES['flash_attention'] = 0
        out[use_kernel] = model.prefill_fn(params, cache, batch,
                                           use_kernel=use_kernel)
    assert LAUNCHES['flash_attention'] == cfg.n_layers
    torch.testing.assert_close(out[True][1], out[False][1], rtol=1e-4,
                               atol=1e-4)
    for key in ('k', 'v'):
        torch.testing.assert_close(out[True][0][key], out[False][0][key],
                                   rtol=1e-4, atol=1e-4)

    cfg = reduced(get_config('rwkv6-3b'), ssm_head_dim=64, d_model=256)
    model = build_model(cfg)
    params = model.init_params(0, device=cuda).to(torch.float32)
    batch = {'tokens': torch.randint(0, cfg.vocab_size, (2, 200),
                                     device=cuda),
             'labels': torch.randint(0, cfg.vocab_size, (2, 200),
                                     device=cuda)}
    LAUNCHES['wkv6'] = 0
    loss_k, _ = model.loss_fn(params, batch, use_kernel=True)
    assert LAUNCHES['wkv6'] == cfg.n_layers
    loss_p, _ = model.loss_fn(params, batch)
    torch.testing.assert_close(loss_k, loss_p, rtol=1e-5, atol=1e-5)
