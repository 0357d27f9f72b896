"""The port's whole-prompt prefill against the JAX package's, with the
reference's own weights bridged in f32 and f32 KV pools on both sides:
``dense.prefill`` (plain ``chunked_attention`` and the flash-attention
path) against the reference's ``dense.prefill(use_pallas=True)``, whose
Pallas kernel runs in interpret mode; ``chunked_attention`` past one query
chunk; ``kv_write_prefill``'s dropped page ids.

Tolerances: 2e-4 on the last-token scores (the reference integration
test's, ``test_prefill_pallas_matches_oracle_path``), 1e-5 on the KV
pools (the same projections of the same weights; other summation order).
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
from repro.models import common as jcm
from repro.models import dense as jdense
from repro.models.api import build_model as j_build_model
from repro_torch import configs as tconfigs
from repro_torch.bridge import cache_from_jax, params_from_jax
from repro_torch.kernels.common import LAUNCHES
from repro_torch.models import common as tcm
from repro_torch.models.api import build_model as t_build_model

ARCHS = {
    'internlm2-1.8b': dict(page_size=8, head_dim=32),
    'qwen3-0.6b': dict(page_size=8),
}
B, S = 2, 64


def _pair(arch):
    jcfg = j_reduced(j_get_config(arch), **ARCHS[arch])
    tcfg = tconfigs.reduced(tconfigs.get_config(arch), **ARCHS[arch])
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jmodel = j_build_model(jcfg)
    jparams = jax.tree.map(lambda x: x.astype(jnp.float32),
                           jmodel.init_params(jax.random.PRNGKey(0)))
    n_pages = 1 + B * S // jcfg.page_size + 3
    jcache = jax.tree.map(lambda x: x.astype(jnp.float32),
                          jmodel.init_cache(None, engine_pages=n_pages))
    return (jcfg, tcfg, jparams, jcache,
            params_from_jax(jax.tree.map(np.asarray, jparams)))


@pytest.mark.parametrize('use_kernel', [False, True])
@pytest.mark.parametrize('arch', sorted(ARCHS))
def test_prefill_matches_the_reference_flash_path(arch, use_kernel):
    jcfg, tcfg, jparams, jcache, tparams = _pair(arch)
    rng = np.random.default_rng(1)
    n_pages = jcache['k'].shape[1]
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    # scattered physical pages, none of them the quarantine page
    pt = (rng.permutation(n_pages - 1)[:B * S // jcfg.page_size] + 1
          ).reshape(B, -1).astype(np.int32)
    jc, jlogits = jax.jit(functools.partial(jdense.prefill, jcfg,
                                            use_pallas=True))(
        jparams, jcache, {'tokens': jnp.asarray(tokens),
                          'page_table': jnp.asarray(pt)})
    tcache = cache_from_jax(jax.tree.map(np.asarray, jcache))
    before = LAUNCHES['flash_attention']
    tc, scores = t_build_model(tcfg).prefill_fn(
        tparams, tcache, {'tokens': torch.from_numpy(tokens),
                          'page_table': torch.from_numpy(pt)},
        use_kernel=use_kernel)
    assert LAUNCHES['flash_attention'] == before     # CPU: plain version
    assert scores.dtype == torch.float32 and scores.shape == (
        B, jcfg.vocab_size)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jlogits),
                               rtol=2e-4, atol=2e-4)
    for key in ('k', 'v'):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('causal', [True, False])
def test_chunked_attention_past_one_query_chunk(causal):
    """S = 1024 runs as two 512-row query chunks; GQA 4 over 2."""
    rng = np.random.default_rng(2)
    b, s, hq, hkv, d = 1, 1024, 4, 2, 16
    q, k, v = ((rng.normal(size=(b, s, h, d)) * 0.5).astype(np.float32)
               for h in (hq, hkv, hkv))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    want = jcm.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), q_positions=jnp.asarray(pos),
                                 kv_positions=jnp.asarray(pos), causal=causal,
                                 remat_chunks=False)
    tpos = torch.from_numpy(pos.copy())
    got = tcm.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), q_positions=tpos,
                                kv_positions=tpos, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_kv_write_prefill_drops_ids_outside_the_pool():
    """As the reference's ``mode='drop'`` scatter: ids >= P and < -P are
    dropped, -1 counts from the end, every other page is untouched."""
    rng = np.random.default_rng(3)
    n_pages, pg, hkv, d = 6, 4, 2, 8
    pool = rng.normal(size=(n_pages, pg, hkv, d)).astype(np.float32)
    kv = rng.normal(size=(2, 3 * pg, hkv, d)).astype(np.float32)
    pt = np.array([[1, 6, -1, 2], [9, 3, -7, 0]], np.int32)   # 4th unused
    want = jcm.kv_write_prefill(jnp.asarray(pool), jnp.asarray(pt),
                                jnp.asarray(kv))
    got = torch.from_numpy(pool.copy())
    tcm.kv_write_prefill(got, torch.from_numpy(pt), torch.from_numpy(kv))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[0].numpy(), pool[0])    # 0: unused
    assert not np.array_equal(got[5].numpy(), pool[5])        # -1 -> 5
