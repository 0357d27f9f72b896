"""The port's dense model against the JAX package's, module by module:
``prefill_chunk``, ``decode_step`` and ``decode_step_sample`` for reduced
qwen3-0.6b (qk_norm, tied head) and internlm2-1.8b (untied head), with the
reference's own weights bridged in f32 and f32 KV pools on both sides.

Tolerance: atol 1e-4 on f32 scores (same arithmetic, other summation
order); greedy tokens exactly equal over a two-chunk prefill and 16 decodes.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import dense as jdense
from repro.models.api import build_model as j_build_model
from repro_torch import configs as tconfigs
from repro_torch.bridge import cache_from_jax, params_from_jax
from repro_torch.models import dense as tdense
from repro_torch.models.api import build_model as t_build_model

ARCHS = ['qwen3-0.6b', 'internlm2-1.8b']
PG, MAXP, CHUNK, B = 4, 8, 8, 2
ATOL = 1e-4


def _pair(arch):
    jcfg = j_reduced(j_get_config(arch), page_size=PG)
    tcfg = tconfigs.reduced(tconfigs.get_config(arch), page_size=PG)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jmodel = j_build_model(jcfg)
    jparams = jax.tree.map(lambda x: x.astype(jnp.float32),
                           jmodel.init_params(jax.random.PRNGKey(1)))
    jcache = jax.tree.map(lambda x: x.astype(jnp.float32),
                          jmodel.init_cache(None, engine_pages=1 + B * MAXP))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    tcache = cache_from_jax(jax.tree.map(np.asarray, jcache))
    return jcfg, tcfg, jparams, jcache, tparams, tcache


def _chunk_batch(prompts, lo, page_table):
    """The engine's mixed-dispatch layout for one chunk per row."""
    toks = np.zeros((B, CHUNK), np.int32)
    poss = np.zeros((B, CHUNK), np.int32)
    pids = np.zeros((B, CHUNK), np.int32)
    offs = np.zeros((B, CHUNK), np.int32)
    kv_len = np.zeros(B, np.int32)
    last = np.zeros(B, np.int32)
    for r, prompt in enumerate(prompts):
        hi = min(lo + CHUNK, len(prompt))
        n = hi - lo
        pos = np.arange(lo, hi)
        toks[r, :n] = prompt[lo:hi]
        poss[r, :n] = pos
        poss[r, n:] = hi - 1
        pids[r, :n] = page_table[r, pos // PG]
        offs[r, :n] = pos % PG
        kv_len[r] = hi
        last[r] = n - 1
    return {'tokens': toks, 'positions': poss, 'page_table': page_table,
            'page_ids': pids, 'offsets': offs, 'kv_len': kv_len,
            'last_idx': last}


def _to_j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _to_t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


@pytest.mark.parametrize('arch', ARCHS)
def test_prefill_then_decode_matches_reference(arch):
    jcfg, tcfg, jparams, jcache, tparams, tcache = _pair(arch)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, jcfg.vocab_size, 13).tolist(),
               rng.integers(1, jcfg.vocab_size, 11).tolist()]
    pt = np.arange(1, 1 + B * MAXP, dtype=np.int32).reshape(B, MAXP)
    j_prefill = jax.jit(functools.partial(jdense.prefill_chunk, jcfg))
    j_decode = jax.jit(functools.partial(jdense.decode_step, jcfg))
    j_sample = jax.jit(functools.partial(jdense.decode_step_sample, jcfg))

    # two prefill chunks (the second one ragged, padding at quarantine)
    for lo in (0, CHUNK):
        batch = _chunk_batch(prompts, lo, pt)
        jcache, jlogits = j_prefill(jparams, jcache, _to_j(batch))
        tcache, tscores = tdense.prefill_chunk(tcfg, tparams, tcache,
                                               _to_t(batch))
        assert tscores.dtype == torch.float32
        np.testing.assert_allclose(tscores.numpy(), np.asarray(jlogits),
                                   rtol=0, atol=ATOL)
    for key in ('k', 'v'):
        np.testing.assert_allclose(tcache[key][:, 1:].numpy(),
                                   np.asarray(jcache[key])[:, 1:],
                                   rtol=0, atol=ATOL)
    j_tok = t_tok = np.asarray(jlogits).argmax(-1).astype(np.int32)
    positions = np.array([len(p) for p in prompts], np.int32)

    j_out, t_out = [], []
    for _ in range(16):
        jb = {'tokens': jnp.asarray(j_tok), 'positions': jnp.asarray(positions),
              'page_table': jnp.asarray(pt)}
        tb = {'tokens': torch.from_numpy(t_tok.copy()),
              'positions': torch.from_numpy(positions.copy()),
              'page_table': torch.from_numpy(pt)}
        _, j_fused = j_sample(jparams, jcache, jb)
        jcache, jlogits = j_decode(jparams, jcache, jb)
        _, t_fused = tdense.decode_step_sample(tcfg, tparams, tcache, tb)
        _, t_kernel = tdense.decode_step(tcfg, tparams, tcache, tb,
                                         use_kernel=True)
        tcache, tscores = tdense.decode_step(tcfg, tparams, tcache, tb)
        np.testing.assert_allclose(tscores.numpy(), np.asarray(jlogits),
                                   rtol=0, atol=ATOL)
        np.testing.assert_allclose(t_kernel.numpy(), tscores.numpy(),
                                   rtol=0, atol=ATOL)
        j_tok = np.asarray(jlogits).argmax(-1).astype(np.int32)
        t_tok = tscores.numpy().argmax(-1).astype(np.int32)
        np.testing.assert_array_equal(np.asarray(j_fused), j_tok)
        np.testing.assert_array_equal(t_fused.numpy(), t_tok)
        j_out.append(j_tok.tolist())
        t_out.append(t_tok.tolist())
        positions = positions + 1
    assert t_out == j_out


@pytest.mark.parametrize('arch', ARCHS)
def test_decode_with_shared_prefix_matches_reference(arch):
    """A decode step whose rows share their first pages, read through the
    prefix-shared path, equals the reference's stock decode step."""
    from repro_torch.kernels.paged_attention.prefix import build_shared_runs
    jcfg, tcfg, jparams, jcache, tparams, tcache = _pair(arch)
    rng = np.random.default_rng(5)
    n_pages = 1 + B * MAXP
    kv = {k: (rng.normal(size=jcache[k].shape) * 0.5).astype(np.float32)
          for k in ('k', 'v')}
    jcache = {k: jnp.asarray(v) for k, v in kv.items()}
    tcache = cache_from_jax(kv)
    pt = np.arange(1, n_pages, dtype=np.int32).reshape(B, MAXP)
    pt[1, :2] = pt[0, :2]                       # two shared full pages
    positions = np.array([13, 20], np.int32)
    toks = rng.integers(1, jcfg.vocab_size, B).astype(np.int32)
    runs = build_shared_runs(pt, positions + 1, PG)
    assert runs['n_slots'] == 2
    jb = {'tokens': jnp.asarray(toks), 'positions': jnp.asarray(positions),
          'page_table': jnp.asarray(pt)}
    _, jlogits = jax.jit(functools.partial(jdense.decode_step, jcfg))(
        jparams, jcache, jb)
    tb = {'tokens': torch.from_numpy(toks), 'positions':
          torch.from_numpy(positions), 'page_table': torch.from_numpy(pt),
          'shared': {k: torch.from_numpy(runs[k])
                     for k in ('pages', 'pos', 'mask', 'tail_pt', 'start')}}
    _, tscores = tdense.decode_step(tcfg, tparams, tcache, tb)
    np.testing.assert_allclose(tscores.numpy(), np.asarray(jlogits),
                               rtol=0, atol=ATOL)


def test_bridge_head_layout():
    """Tied configs use the embedding table as the (V, D) head itself (no
    copy); the bridge transposes an untied (D, V) unembed once."""
    for arch in ARCHS:
        jcfg, tcfg, jparams, _, tparams, _ = _pair(arch)
        head = tdense.head_of(tcfg, tparams)
        assert head.is_contiguous() and head.shape == (jcfg.vocab_size,
                                                       jcfg.d_model)
        np.testing.assert_array_equal(
            head.numpy(), np.asarray(jdense.unembed_of(jcfg, jparams)).T)
        if tcfg.tie_embeddings:
            assert head.data_ptr() == tparams['embed'].data_ptr()


def test_init_params_follows_the_template_law():
    """Weights drawn on the device from a seeded generator, with the
    reference's shapes and init law: same seed, same weights."""
    tcfg = tconfigs.reduced(tconfigs.get_config('internlm2-1.8b'),
                            page_size=PG)
    model = t_build_model(tcfg)
    a = model.init_params(3, device='cpu')
    b = model.init_params(3, device='cpu')
    jshapes = jax.tree.map(lambda x: x.shape, j_build_model(
        j_reduced(j_get_config('internlm2-1.8b'), page_size=PG)).param_shapes())
    assert jshapes['unembed'] == tuple(reversed(a['unembed'].shape))
    for key in ('embed', 'final_norm'):
        assert tuple(a[key].shape) == jshapes[key]
    for key, w in a['layers'].items():
        assert tuple(w.shape) == jshapes['layers'][key], key
        assert torch.equal(w, b['layers'][key])
        assert w.dtype == torch.bfloat16 and not w.requires_grad
    assert (a['layers']['ln1'] == 1).all()
    std = a['layers']['wq'].float().std().item()
    assert abs(std - tcfg.d_model ** -0.5) < 0.1 * tcfg.d_model ** -0.5
