"""The port's serving engine against the JAX package's: drains of the same
trace give the same tokens, and the reference's engine tests of the Valve
round trip (invalidation -> exact recompute, partial resume from the
surviving prefix) and of the hot-path variants hold for the port.

Parity runs bridge the reference's weights in f32 and give both engines f32
KV pools, so the two differ only in summation order; greedy tokens must be
exactly equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core.memory import MemoryPlane as JMemoryPlane
from repro.models.api import build_model as j_build_model
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.kvpool import KVPool as JKVPool
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, reduced
from repro_torch.core.memory import MemoryPlane
from repro_torch.models.api import build_model
from repro_torch.serving.engine import Engine, EngineConfig, ReqState
from repro_torch.serving.kvpool import KVPool


def _f32(tree):
    return jax.tree.map(lambda x: x.astype(jnp.float32), tree)


def _pair(arch):
    jmodel = j_build_model(j_reduced(j_get_config(arch), page_size=4))
    jparams = _f32(jmodel.init_params(jax.random.PRNGKey(0)))
    tmodel = build_model(reduced(get_config(arch), page_size=4))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, tmodel, tparams


def _trace(vocab):
    """Six requests, four of them behind one published 3-page prefix."""
    rng = np.random.default_rng(3)
    prefix = rng.integers(1, vocab, 12).tolist()
    prompts = [prefix + rng.integers(1, vocab, n).tolist() for n in (5, 2, 7)]
    prompts += [rng.integers(1, vocab, n).tolist() for n in (13, 6)]
    prompts.insert(1, list(prefix))
    return prompts


def _drain(eng, prompts):
    rids = [eng.submit(prompts[0], max_new_tokens=8)]
    for _ in range(20):                    # publish the first prefix
        eng.step()
        if eng.requests[rids[0]].generated:
            break
    rids += [eng.submit(p, max_new_tokens=8) for p in prompts[1:]]
    eng.run_to_completion()
    return [eng.output_tokens(r) for r in rids]


@pytest.mark.parametrize('arch', ['qwen3-0.6b', 'internlm2-1.8b'])
def test_drain_matches_reference_engine(arch):
    jmodel, jparams, tmodel, tparams = _pair(arch)
    prompts = _trace(jmodel.cfg.vocab_size)

    jpool = JKVPool(16, 4, page_size=4, reserved_handles=1)
    JMemoryPlane(jpool, sharing=True)
    jeng = JEngine(jmodel, jparams, jpool,
                   JEngineConfig(max_batch=3, max_seq=40, prefill_chunk=8))
    jeng.cache = _f32(jeng.cache)
    want = _drain(jeng, prompts)

    runs = {}
    for name, kw in (('stock', {}),
                     ('kernels', dict(decode_kernel=True, fused_sampling=True,
                                      prefix_shared_attention=True))):
        pool = KVPool(16, 4, page_size=4, reserved_handles=1)
        MemoryPlane(pool, sharing=True)
        eng = Engine(tmodel, tparams, pool,
                     EngineConfig(max_batch=3, max_seq=40, prefill_chunk=8,
                                  **kw), device='cpu')
        eng.cache = {k: v.float() for k, v in eng.cache.items()}
        runs[name] = (_drain(eng, prompts), eng.stats)
        MemoryPlane.of(pool).check_invariants()
    assert runs['stock'][0] == want
    assert runs['kernels'][0] == want
    assert runs['kernels'][1].shared_page_reads_saved > 0
    assert runs['kernels'][1].token_flushes > 0
    assert runs['stock'][1].mixed_dispatches == jeng.stats.mixed_dispatches
    assert runs['stock'][1].dispatches == jeng.stats.dispatches


def _setup(*, pool_handles=10, pph=4, seed=0, **ecfg):
    cfg = reduced(get_config('internlm2-1.8b'), page_size=4)
    model = build_model(cfg)
    params = model.init_params(seed, device='cpu')
    pool = KVPool(pool_handles, pph, page_size=4, reserved_handles=1)
    eng = Engine(model, params, pool,
                 EngineConfig(max_batch=4, max_seq=64, prefill_chunk=8,
                              **ecfg), device='cpu')
    return eng, pool


def _run_until(eng, rid, n):
    for _ in range(20):
        eng.step()
        if len(eng.requests[rid].generated) >= n:
            return eng.requests[rid]
    raise AssertionError('request never reached its token count')


@pytest.mark.parametrize('ecfg', [{}, dict(decode_kernel=True,
                                           fused_sampling=True)])
def test_invalidation_recompute_round_trip(ecfg):
    """Reclaim every handle of a request mid-generation; the engine
    recomputes and the output equals the undisturbed run's."""
    eng, _ = _setup(**ecfg)
    prompt = np.random.default_rng(2).integers(1, 512, 9).tolist()
    ref_rid = eng.submit(prompt, max_new_tokens=8)
    eng.run_to_completion()
    ref = eng.output_tokens(ref_rid)
    assert len(ref) == 8

    eng2, pool2 = _setup(**ecfg)
    rid = eng2.submit(prompt, max_new_tokens=8)
    req = _run_until(eng2, rid, 3)
    handles = sorted({pool2.handle_of(p) for p in req.pages})
    inv = MemoryPlane.of(pool2).reclaim_handles(handles)
    assert inv[rid].keep == 0 and inv[rid].resume == 0
    eng2.on_pages_invalidated(inv)
    assert req.state == ReqState.WAITING and req.recomputes == 1
    kept = eng2.output_tokens(rid)
    eng2.run_to_completion()
    out = eng2.output_tokens(rid)
    assert out[:len(kept)] == kept
    assert out == ref
    pool2.check_invariants()


def test_partial_invalidation_resumes_from_surviving_prefix():
    """Reclaiming only the handle of logical page 2 resumes prefill at
    token 8: same output, strictly fewer recomputed tokens."""
    eng, _ = _setup(pool_handles=12, pph=2)
    prompt = np.random.default_rng(9).integers(1, 512, 9).tolist()
    ref_rid = eng.submit(prompt, max_new_tokens=8)
    eng.run_to_completion()
    ref = eng.output_tokens(ref_rid)

    eng2, pool2 = _setup(pool_handles=12, pph=2)
    rid = eng2.submit(prompt, max_new_tokens=8)
    req = _run_until(eng2, rid, 3)
    inv = MemoryPlane.of(pool2).reclaim_handles(
        [pool2.handle_of(req.pages[2])])
    assert inv[rid].keep == 2 and inv[rid].resume == 8
    eng2.on_pages_invalidated(inv)
    assert req.state == ReqState.WAITING
    assert req.n_prefilled == 8 and len(req.pages) == 2
    assert eng2.stats.tokens_recomputed == len(req.context) - 8
    kept = list(req.generated)
    eng2.run_to_completion()
    out = eng2.output_tokens(rid)
    assert out[:len(kept)] == kept
    assert out == ref
    MemoryPlane.of(pool2).check_invariants()


def test_fused_sampling_and_shared_attention_drain_identity():
    """The hot-path variants -- the kernel page walk, fused unembed+sample
    with lazy on-device tokens, prefix-shared reads over CoW pages --
    drain a staggered shared-prefix batch to the stock path's tokens."""
    cfg = reduced(get_config('internlm2-1.8b'), page_size=4)
    model = build_model(cfg)
    params = model.init_params(0, device='cpu')
    prompt = np.random.default_rng(7).integers(1, cfg.vocab_size, 12).tolist()

    def run(**kw):
        pool = KVPool(16, 4, page_size=4, reserved_handles=1)
        MemoryPlane(pool, sharing=True)
        eng = Engine(model, params, pool,
                     EngineConfig(max_batch=3, max_seq=40, prefill_chunk=8,
                                  **kw), device='cpu')
        out = _drain(eng, [prompt] * 3)
        return out, eng.stats.token_flushes, eng.stats.shared_page_reads_saved

    base, flushes0, saved0 = run()
    fused, flushes1, _ = run(fused_sampling=True)
    both, _, saved2 = run(decode_kernel=True, fused_sampling=True,
                          prefix_shared_attention=True)
    assert flushes0 == 0 and flushes1 > 0
    assert saved0 == 0 and saved2 > 0
    assert fused == base and both == base


def test_temperature_sampling_uses_the_engine_generator():
    """T > 0: the unfused path draws from the engine's seeded generator
    (same seed, same tokens), and the fused path's counter-hash noise is
    reproducible from EngineConfig.seed."""
    prompt = np.random.default_rng(1).integers(1, 512, 7).tolist()
    outs = {}
    for fused in (False, True):
        for rep in range(2):
            eng, _ = _setup(temperature=1.0, seed=0, fused_sampling=fused)
            rid = eng.submit(prompt, max_new_tokens=6)
            eng.run_to_completion()
            outs[fused, rep] = eng.output_tokens(rid)
    assert outs[False, 0] == outs[False, 1]
    assert outs[True, 0] == outs[True, 1]
    assert all(0 <= t < 512 for t in outs[True, 0] + outs[False, 0])


def test_engine_refuses_params_on_another_device():
    cfg = reduced(get_config('qwen3-0.6b'), page_size=4)
    model = build_model(cfg)
    params = model.init_params(0, device='cpu')
    with pytest.raises(ValueError, match='params on'):
        Engine(model, params, KVPool(4, 2, page_size=4), device='meta')
    eng = Engine(model, params, KVPool(4, 2, page_size=4), device='cpu')
    assert eng.cache['k'].device.type == 'cpu'
    assert eng.cache['k'].shape == (cfg.n_layers, eng.pool.n_pages, 4,
                                    cfg.n_kv_heads, cfg.hd)
    assert torch.equal(eng.cache['k'], torch.zeros_like(eng.cache['k']))


class _EntryLog:
    """Stands in for the engine's model: delegates every call and counts
    the real rows each entry point computes (padding rows write to the
    quarantine page)."""

    def __init__(self, model):
        self.model, self.chunk_rows, self.decode_rows = model, 0, 0

    def __getattr__(self, name):
        return getattr(self.model, name)

    def prefill_chunk_fn(self, params, cache, batch):
        self.chunk_rows += int((batch['page_ids'][:, 0] != 0).sum())
        return self.model.prefill_chunk_fn(params, cache, batch)

    def _decode_rows(self, batch):
        rows = batch['page_table'].gather(
            1, (batch['positions'] // 4)[:, None].long())[:, 0]
        self.decode_rows += int((rows != 0).sum())

    def decode_fn(self, params, cache, batch, **kw):
        self._decode_rows(batch)
        return self.model.decode_fn(params, cache, batch, **kw)

    def decode_sample_fn(self, params, cache, batch, **kw):
        self._decode_rows(batch)
        return self.model.decode_sample_fn(params, cache, batch, **kw)


@pytest.mark.parametrize('fused', [False, True])
def test_piggybacked_decode_rows_take_the_decode_entry(fused):
    """While one request prefills, another decodes in the same steps: the
    chunked-prefill call carries only prompt chunks and every generated
    token after a request's first comes out of the decode entry, so a
    token is computed the same way whatever shares its step.  Outputs
    equal each request run alone."""
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, 512, n).tolist() for n in (6, 30)]
    alone = []
    for p in prompts:
        eng, _ = _setup(fused_sampling=fused, decode_kernel=fused)
        rid = eng.submit(p, max_new_tokens=8)
        eng.run_to_completion()
        alone.append(eng.output_tokens(rid))
    eng, _ = _setup(fused_sampling=fused, decode_kernel=fused)
    log = eng.model = _EntryLog(eng.model)
    first = eng.submit(prompts[0], max_new_tokens=8)
    _run_until(eng, first, 2)
    second = eng.submit(prompts[1], max_new_tokens=8)
    eng.run_to_completion()
    assert [eng.output_tokens(first), eng.output_tokens(second)] == alone
    assert eng.stats.mixed_dispatches > 1 and \
        eng.stats.decode_iterations == eng.stats.dispatches - 1
    assert log.chunk_rows == eng.stats.prefill_chunks
    assert log.decode_rows == eng.stats.tokens_generated - len(prompts)
