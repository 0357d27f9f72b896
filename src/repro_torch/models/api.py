"""Model API of the port: ``build_model(cfg)`` returns a :class:`Model` bound
to a config, with the entry points the engine and the tests need.  The port
serves the ``dense`` and ``vlm`` families (``vlm`` shares the dense
decoder and takes its frontend's output as ``batch['prefix_embeds']``; the
frontend itself is not ported) and the ``moe`` family (the dense decoder
with routed experts; no fused sampling and no prefill kernel, as in the
reference), and runs the ``ssm`` family (rwkv6): its training forward, and
prefill + decode over a recurrent-state cache.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm
from repro_torch.models import dense, moe, rwkv6

_FAMILY = {'dense': dense, 'vlm': dense, 'moe': moe, 'ssm': rwkv6}


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def __post_init__(self):
        if self.cfg.family not in _FAMILY:
            raise NotImplementedError(
                f'family {self.cfg.family!r} is not ported yet')

    def _only(self, *families):
        if self.cfg.family not in families:
            raise NotImplementedError(
                f'not ported for family {self.cfg.family!r}')

    def template(self):
        return _FAMILY[self.cfg.family].template(self.cfg)

    def init_params(self, seed: int = 0, *, device):
        """Weights drawn on ``device`` from a seeded ``torch.Generator`` (an
        ``nn.ParameterDict``; requires_grad is off)."""
        device = torch.device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        return cm.init_from_template(self.template(), gen, device)

    def cache_template(self, *, engine_pages: Optional[int] = None,
                       batch_size: Optional[int] = None):
        """The cache's PSpec tree: the engine's global paged pool {'k',
        'v'} of (L, engine_pages, pg, Hkv, Dh) for the paged families, the
        recurrent state of ``batch_size`` rows for ``ssm``."""
        if self.cfg.family == 'ssm':
            if engine_pages is not None:
                raise NotImplementedError(
                    'engine pool layout only for paged-KV families')
            if batch_size is None:
                raise ValueError('the ssm cache needs batch_size')
            return rwkv6.cache_template(self.cfg, batch_size)
        if engine_pages is None:
            raise ValueError('the paged KV pool needs engine_pages')
        return dense.cache_template(self.cfg, engine_pages)

    def init_cache(self, *, engine_pages: Optional[int] = None,
                   batch_size: Optional[int] = None, device):
        """:meth:`cache_template`'s cache, zeros, on ``device``."""
        return cm.zeros_from_template(
            self.cache_template(engine_pages=engine_pages,
                                batch_size=batch_size), device)

    def loss_fn(self, params, batch, *, use_kernel=False):
        """(mean NLL, {'tokens': count}); the WKV6 kernel with
        ``use_kernel``.  Forward only (no backward kernel exists)."""
        self._only('ssm')
        return rwkv6.forward_train(self.cfg, params, batch,
                                   use_kernel=use_kernel)

    def prefill_fn(self, params, cache, batch, *, use_kernel=False):
        """Whole-prompt prefill: (cache, (B, V) f32 scores of the last
        token).  Dense: into the global pool, the flash-attention kernel
        with ``use_kernel``.  ssm: from the recurrent state in ``cache``,
        the WKV6 kernel with ``use_kernel``.  moe: the plain path only (the
        reference's MoE prefill has no kernel path)."""
        if self.cfg.family == 'moe':
            if use_kernel:
                raise NotImplementedError('moe prefill has no kernel path')
            return moe.prefill(self.cfg, params, cache, batch)
        self._only('dense', 'vlm', 'ssm')
        return _FAMILY[self.cfg.family].prefill(
            self.cfg, params, cache, batch, use_kernel=use_kernel)

    def decode_fn(self, params, cache, batch, *, use_kernel=False):
        """One token a row: (cache, (B, V) f32 scores).  Dense and moe:
        the paged decode kernel with ``use_kernel``.  ssm: the single-token
        recurrence step (no kernel, as in the reference)."""
        if self.cfg.family == 'ssm':
            return rwkv6.decode_step(self.cfg, params, cache, batch)
        return _FAMILY[self.cfg.family].decode_step(
            self.cfg, params, cache, batch, use_kernel=use_kernel)

    def decode_sample_fn(self, params, cache, batch, *, use_kernel=False,
                         temperature=0.0):
        """Fused decode+sampling step: (cache, (B,) int32 tokens).  Dense
        and vlm only, as in the reference."""
        self._only('dense', 'vlm')
        return dense.decode_step_sample(self.cfg, params, cache, batch,
                                        use_kernel=use_kernel,
                                        temperature=temperature)

    def prefill_chunk_fn(self, params, cache, batch):
        self._only('dense', 'vlm', 'moe')
        return _FAMILY[self.cfg.family].prefill_chunk(self.cfg, params,
                                                      cache, batch)


@functools.lru_cache(maxsize=None)
def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
