"""Model API of the port: ``build_model(cfg)`` returns a :class:`Model` bound
to a config, with the entry points the engine and the tests need.  The port
serves the ``dense`` and ``vlm`` families (``vlm`` shares the dense
decoder; its frontend is not ported) and runs the ``ssm`` family's (rwkv6)
training forward.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm
from repro_torch.models import dense, rwkv6

_FAMILY = {'dense': dense, 'vlm': dense, 'ssm': rwkv6}


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

    def init_cache(self, *, engine_pages: int, device):
        """The engine's global paged pool: {'k', 'v'} of
        (L, engine_pages, pg, Hkv, Dh), zeros."""
        self._only('dense', 'vlm')
        return cm.zeros_from_template(
            dense.cache_template(self.cfg, engine_pages), device)

    def init_state(self, batch_size: int, *, device):
        """The rwkv6 recurrent state, zeros (``rwkv6.init_state``)."""
        self._only('ssm')
        return rwkv6.init_state(self.cfg, batch_size, device=device)

    def loss_fn(self, params, batch, *, use_kernel=False):
        """(mean NLL, {'tokens': count}); the WKV6 kernel with
        ``use_kernel``.  Forward only (no backward kernel exists)."""
        self._only('ssm')
        return rwkv6.forward_train(self.cfg, params, batch,
                                   use_kernel=use_kernel)

    def prefill_fn(self, params, cache, batch, *, use_kernel=False):
        """Whole-prompt prefill into the global pool: (cache, (B, V) f32
        scores of the last token); the flash-attention kernel with
        ``use_kernel``."""
        self._only('dense', 'vlm')
        return dense.prefill(self.cfg, params, cache, batch,
                             use_kernel=use_kernel)

    def decode_fn(self, params, cache, batch, *, use_kernel=False):
        self._only('dense', 'vlm')
        return dense.decode_step(self.cfg, params, cache, batch,
                                 use_kernel=use_kernel)

    def decode_sample_fn(self, params, cache, batch, *, use_kernel=False,
                         temperature=0.0):
        """Fused decode+sampling step: (cache, (B,) int32 tokens)."""
        self._only('dense', 'vlm')
        return dense.decode_step_sample(self.cfg, params, cache, batch,
                                        use_kernel=use_kernel,
                                        temperature=temperature)

    def prefill_chunk_fn(self, params, cache, batch):
        self._only('dense', 'vlm')
        return dense.prefill_chunk(self.cfg, params, cache, batch)


@functools.lru_cache(maxsize=None)
def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
