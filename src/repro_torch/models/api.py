"""Model API of the port: ``build_model(cfg)`` returns a :class:`Model` bound
to a config, with the entry points the engine and the tests need.  The port
serves the ``dense`` and ``vlm`` families (``vlm`` shares the dense
decoder and takes its frontend's output as ``batch['prefix_embeds']``; the
frontend itself is not ported) and the ``moe`` family (the dense decoder
with routed experts; no fused sampling and no prefill kernel, as in the
reference), and runs the ``ssm`` family (rwkv6): prefill + decode over a
recurrent-state cache.  Every family trains: :meth:`Model.loss_fn` is
differentiable by autograd through the plain paths.
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

    def init_params(self, seed: int = 0, *, device,
                    requires_grad: bool = False):
        """Weights drawn on ``device`` from a seeded ``torch.Generator`` (an
        ``nn.ParameterDict``); its leaves require grad for training only,
        with ``requires_grad``."""
        device = torch.device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        return cm.init_from_template(self.template(), gen, device,
                                     requires_grad=requires_grad)

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
        """The training loss: (mean NLL, {'tokens': count}), moe adding its
        aux loss (``{'aux_loss'}`` too).  batch: tokens, labels (B, S) [,
        loss_mask (B, S), prefix_embeds (B, p, D)].  Differentiable
        through the plain paths; ``use_kernel`` takes the flash-attention
        kernel (dense, vlm, moe) or the WKV6 kernel (ssm), which have no
        backward: under autograd on tensors that require grad they raise.
        """
        return _FAMILY[self.cfg.family].forward_train(
            self.cfg, params, batch, use_kernel=use_kernel)

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
