"""The port's training loss and every gradient leaf against the JAX
package's, for each family and config the port trains, at ``reduced()``
widths in f32 with the reference's own weights bridged.

The reference differentiates its ``Model.loss_fn`` with
``jax.value_and_grad`` (its layers under ``jax.checkpoint``); the port
runs autograd through ``loss_and_grads`` (its layers and chunks under
``torch.utils.checkpoint``).  Tolerances: the loss within 1e-5 relative,
every gradient leaf within 1e-4 of that leaf's max |g| (same arithmetic
in f32, another summation order).

Two leaves of the new families need a word:
- zamba2 at S=256: the reference's chunked SSD takes exp of the whole
  (chunk, chunk) decay square before masking it; at these weights (mean
  |log a| ~0.8) the masked half overflows and its gradients are NaN,
  which the case asserts.  The port masks the exponent first (its
  ``ssd_chunked``); the reference side then runs its own sequential oracle
  ``ssd_ref`` in place of ``ssd_chunked``, the same function, which its
  docstring says the chunked form matches.
- seamless: the cross-attention key bias ``dec_layers/xbk`` adds the same
  q . b to every score of a query (cross K has no RoPE), which softmax
  ignores, so its exact gradient is 0 and both packages return rounding
  noise.  It is held to that: both within 1e-6 of the largest gradient of
  the decoder stack.
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
from repro.models import zamba2 as jzamba2
from repro.models.api import build_model as j_build_model
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax, tree_to_jax
from repro_torch.models import moe as tmoe
from repro_torch.models.api import build_model as t_build_model
from repro_torch.training import tree as tr
from repro_torch.training.train_step import loss_and_grads

B = 2
EXACT_ZERO = ('dec_layers/xbk',)     # gradient 0 in exact arithmetic
# (id, arch, reduced() overrides, sequence length, extra batch inputs;
# 'ssd_ref': the reference runs its sequential SSD, see above)
CASES = [
    ('qwen3-0.6b', 'qwen3-0.6b', {}, 64, ()),
    # 1024 tokens: two query chunks of attention, two CE chunks, each
    # checkpointed
    ('qwen3-0.6b-S1024', 'qwen3-0.6b', {}, 1024, ()),
    ('qwen3-0.6b-prefix-mask', 'qwen3-0.6b', {}, 64,
     ('prefix_embeds', 'loss_mask')),
    ('internlm2-1.8b', 'internlm2-1.8b', {}, 64, ()),
    # 16 experts: the capacity (1.25) drops assignments at this size
    ('phi3.5-moe-E16', 'phi3.5-moe-42b-a6.6b', {'n_experts': 16}, 64, ()),
    ('llama4-scout', 'llama4-scout-17b-a16e', {}, 64, ()),
    ('rwkv6-3b', 'rwkv6-3b', {}, 64, ()),
    ('qwen3-14b', 'qwen3-14b', {}, 64, ()),
    ('command-r-35b', 'command-r-35b', {}, 64, ()),
    ('valve-7b', 'valve-7b', {}, 64, ()),
    ('llava-next-mistral-7b', 'llava-next-mistral-7b', {}, 64,
     ('prefix_embeds',)),
    ('zamba2-2.7b', 'zamba2-2.7b', {}, 64, ()),
    # 256 tokens: two SSD chunks, the inter-chunk state carried
    ('zamba2-2.7b-S256', 'zamba2-2.7b', {}, 256, ('ssd_ref',)),
    ('seamless-m4t-medium', 'seamless-m4t-medium', {}, 64, ('frames',)),
]


@functools.lru_cache(maxsize=None)
def _pair(arch, overrides):
    kw = dict(overrides)
    jcfg = j_reduced(j_get_config(arch), **kw)
    tcfg = tconfigs.reduced(tconfigs.get_config(arch), **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jparams = jax.tree.map(lambda x: x.astype(jnp.float32),
                           j_build_model(jcfg).init_params(
                               jax.random.PRNGKey(0)))
    return j_build_model(jcfg), t_build_model(tcfg), jparams


def _batch(cfg, s, extra):
    rng = np.random.default_rng(7)
    batch = {'tokens': rng.integers(0, cfg.vocab_size, (B, s)),
             'labels': rng.integers(0, cfg.vocab_size, (B, s))}
    batch = {k: v.astype(np.int32) for k, v in batch.items()}
    if 'prefix_embeds' in extra:
        p = 8
        batch['prefix_embeds'] = (rng.normal(size=(B, p, cfg.d_model))
                                  * 0.02).astype(np.float32)
    if 'frames' in extra:                      # as make_inputs draws them
        batch['frames'] = (rng.normal(size=(B, s, cfg.d_model))
                           * 0.02).astype(np.float32)
    if 'loss_mask' in extra:
        mask = (rng.random((B, s)) < 0.7).astype(np.float32)
        mask[:, :8] = 0.0                      # no loss on the prefix
        batch['loss_mask'] = mask
    return batch


@pytest.mark.parametrize('case', CASES, ids=[c[0] for c in CASES])
def test_loss_and_gradients_match_the_reference(case, monkeypatch):
    _, arch, overrides, s, extra = case
    jmodel, tmodel, jparams = _pair(arch, tuple(sorted(overrides.items())))
    batch = _batch(jmodel.cfg, s, extra)

    def jloss(p):
        return jmodel.loss_fn(p, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
    if 'ssd_ref' in extra:
        jg = jax.grad(lambda p: jloss(p)[0])(jparams)
        assert any(np.isnan(np.asarray(g)).any()
                   for g in jax.tree.leaves(jg))
        monkeypatch.setattr(jzamba2, 'ssd_chunked',
                            lambda x, b, c, a, state: jzamba2.ssd_ref(
                                x, b, c, a, state))
    (jl, jaux), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)

    drops = []
    route = tmoe.route

    def counting_route(cfg, lp, xf, capacity_factor):
        out = route(cfg, lp, xf, capacity_factor)
        drops.append(int((out[3] >= out[4]).sum()))
        return out
    monkeypatch.setattr(tmoe, 'route', counting_route)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              requires_grad=True)
    tl, tg = loss_and_grads(tmodel, tparams, {
        k: torch.from_numpy(v) for k, v in batch.items()})

    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    got = tree_to_jax(tg)
    want = jax.tree.map(np.asarray, jg)
    assert [k for k, _ in tr.leaves_with_paths(got)] == \
        [k for k, _ in tr.leaves_with_paths(want)]
    stack = max((np.abs(b).max() for k, b in tr.leaves_with_paths(want)
                 if k.startswith('dec_layers/')), default=0.0)
    for (key, a), (_, b) in zip(tr.leaves_with_paths(got),
                                tr.leaves_with_paths(want)):
        assert a.shape == b.shape, key
        if key in EXACT_ZERO:
            assert max(np.abs(a).max(), np.abs(b).max()) <= 1e-6 * stack, key
            continue
        scale = np.abs(b).max()
        assert scale > 0, key                  # every leaf is trained
        assert np.abs(a - b).max() <= 1e-4 * scale, (
            key, np.abs(a - b).max() / scale)
    if jmodel.cfg.family == 'moe':
        with torch.no_grad():
            _, aux = tmodel.loss_fn(tparams, {
                k: torch.from_numpy(v) for k, v in batch.items()})
        assert float(aux['aux_loss']) == pytest.approx(
            float(jaux['aux_loss']), rel=1e-5)
    if arch == 'phi3.5-moe-42b-a6.6b':
        assert sum(drops) > 0, 'no assignment dropped: capacity never binds'
