"""Model API of the port: ``build_model(cfg)`` returns a :class:`Model` bound
to a config, with the entry points the engine and the tests need.  The port
serves the ``dense`` and ``vlm`` families (``vlm`` shares the dense
decoder and takes its frontend's output as ``batch['prefix_embeds']``; the
frontend itself is not ported) and the ``moe`` family (the dense decoder
with routed experts; no fused sampling and no prefill kernel, as in the
reference), and runs the ``ssm`` family (rwkv6): prefill + decode over a
recurrent-state cache.  Every family trains: :meth:`Model.loss_fn` is
differentiable by autograd through the plain paths, on one device or as a
tensor-parallel rank's share (``tp``).

It also runs the ``hybrid`` family (zamba2: Mamba2 layers and a shared
attention block, a paged KV pool per application of it) and the
``encdec`` family (seamless-m4t: a speech-frame encoder and a decoder with
a paged self-attention KV beside a dense cross-attention K/V): their
``loss_fn``, ``prefill_fn`` and ``decode_fn`` (hybrid's with
``long_context``, which reads a contiguous KV of ``max_seq`` tokens).
They have no kernel path, as in the reference (its ``decode_fn`` passes
``use_pallas`` to dense, vlm and moe only): ``use_kernel=True`` raises
for them, and so do ``decode_sample_fn`` and ``prefill_chunk_fn``; the
engine does not serve them either (``serving/engine.py``).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, cell_supported
from repro_torch.models import common as cm
from repro_torch.models import dense, encdec, moe, rwkv6, zamba2

_FAMILY = {'dense': dense, 'vlm': dense, 'moe': moe, 'ssm': rwkv6,
           'hybrid': zamba2, 'encdec': encdec}
NO_KERNEL = ('hybrid', 'encdec')     # families with no kernel path


@dataclass(frozen=True)
class InputSpec:
    """A step input's shape and torch dtype (the reference's
    ``ShapeDtypeStruct`` stand-in)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


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

    def param_shapes(self):
        return cm.shapes_from_template(self.template())

    def param_axes(self):
        """The weights' logical axes (the reference's, with each (V, D)
        head's axes in the port's row-major order)."""
        return cm.axes_from_template(self.template())

    def init_params(self, seed: int = 0, *, device,
                    requires_grad: bool = False):
        """Weights drawn on ``device`` from a seeded ``torch.Generator`` (an
        ``nn.ParameterDict``); its leaves require grad for training only,
        with ``requires_grad``."""
        device = torch.device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        return cm.init_from_template(self.template(), gen, device,
                                     requires_grad=requires_grad)

    def _no_kernel(self, use_kernel: bool, families=NO_KERNEL):
        if use_kernel and self.cfg.family in families:
            raise NotImplementedError(
                f'family {self.cfg.family!r} has no kernel path here (the '
                'reference runs none for it)')

    def cache_template(self, *, engine_pages: Optional[int] = None,
                       batch_size: Optional[int] = None,
                       max_seq: Optional[int] = None,
                       enc_len: Optional[int] = None):
        """The cache's PSpec tree: the engine's global paged pool {'k',
        'v'} of (L, engine_pages, pg, Hkv, Dh) for the paged families, the
        recurrent state of ``batch_size`` rows for ``ssm``; for ``hybrid``
        {'mamba': the state of ``batch_size`` rows, 'attn': the shared
        block's paged pools of ``engine_pages``, or with ``max_seq`` its
        contiguous long-context KV}; for ``encdec`` the decoder's pool of
        ``engine_pages`` and the cross K/V of ``batch_size`` rows of
        ``enc_len`` frames."""
        cfg, fam = self.cfg, self.cfg.family
        if fam == 'ssm' and engine_pages is not None:
            raise NotImplementedError(
                'engine pool layout only for paged-KV families')
        if fam in ('ssm', 'hybrid', 'encdec') and batch_size is None:
            raise ValueError(f'the {fam} cache needs batch_size')
        if fam == 'ssm':
            return rwkv6.cache_template(cfg, batch_size)
        if fam == 'hybrid' and max_seq is not None:
            return {'mamba': zamba2.mamba_cache_template(cfg, batch_size),
                    'attn': zamba2.attn_cache_template_dense(
                        cfg, batch_size, max_seq)}
        if engine_pages is None:
            raise ValueError('the paged KV pool needs engine_pages')
        if fam == 'hybrid':
            return {'mamba': zamba2.mamba_cache_template(cfg, batch_size),
                    'attn': zamba2.attn_cache_template(cfg, engine_pages)}
        if fam == 'encdec':
            if enc_len is None:
                raise ValueError('the encdec cache needs enc_len')
            return encdec.cache_template(cfg, engine_pages, batch_size,
                                         enc_len)
        return dense.cache_template(cfg, engine_pages)

    def cache_axes(self, **kw):
        """The logical axes of :meth:`cache_template` (same arguments)."""
        return cm.axes_from_template(self.cache_template(**kw))

    def init_cache(self, *, engine_pages: Optional[int] = None,
                   batch_size: Optional[int] = None,
                   max_seq: Optional[int] = None,
                   enc_len: Optional[int] = None, device, dtype=None):
        """:meth:`cache_template`'s cache, zeros, on ``device``; ``dtype``
        (the model's, where it is not bf16) for every leaf but the f32
        recurrent states."""
        return cm.zeros_from_template(
            self.cache_template(engine_pages=engine_pages,
                                batch_size=batch_size, max_seq=max_seq,
                                enc_len=enc_len), device, dtype)

    def loss_fn(self, params, batch, *, use_kernel=False, tp=None,
                data=None):
        """The training loss: (mean NLL, {'tokens': count}), moe adding its
        aux loss (``{'aux_loss'}`` too).  batch: tokens, labels (B, S) [,
        loss_mask (B, S), prefix_embeds (B, p, D)]; encdec also frames (B,
        S_enc, D).  Differentiable through the plain paths; ``use_kernel``
        takes the flash-attention kernel (dense, vlm, moe) or the WKV6
        kernel (ssm), which have no backward: under autograd on tensors
        that require grad they raise.  hybrid and encdec have no kernel
        path.  ``tp``: a tensor-parallel rank's loss over its weight blocks
        (every family: heads, ``d_ff`` and vocabulary blocks, moe's
        experts, rwkv6's wkv heads, zamba2's Mamba2 heads and shared-block
        heads; ``distributed/tp.py``).
        ``data``: ``batch`` is this rank's block of the rows of a
        data-parallel call (``distributed.tp.DataShare``), and the loss is
        this rank's share of the call's loss: its NLL over every rank's
        token count (moe: with its share of the aux loss, routed over the
        whole call), so that the ranks' losses and gradients sum to the
        call's."""
        self._no_kernel(use_kernel)
        kw = {} if tp is None else {'tp': tp}
        fam = self.cfg.family
        if fam not in NO_KERNEL:
            kw['use_kernel'] = use_kernel
        if fam == 'moe':
            return moe.forward_train(self.cfg, params, batch, data=data,
                                     **kw)
        loss, m = _FAMILY[fam].forward_train(self.cfg, params, batch, **kw)
        if data is not None:
            cnt = m['tokens'].detach()
            loss = loss * (torch.clamp_min(cnt, 1.0) / torch.clamp_min(
                data.sum(cnt.clone()), 1.0))
        return loss, m

    def input_specs(self, shape: ShapeConfig) -> Dict[str, InputSpec]:
        """Shape and dtype of each tensor of the step's ``batch`` for an
        execution shape (the reference's ``input_specs``, as plain
        descriptions).  The ``train`` kind; prefill and decode come with
        ``make_serve_step`` (ROADMAP Queue 1 item 11)."""
        ok, why = cell_supported(self.cfg, shape)
        if not ok:
            raise ValueError(f'{self.cfg.name} × {shape.name}: {why}')
        if shape.kind != 'train':
            raise NotImplementedError(
                f'input specs of the {shape.kind!r} kind come with '
                'make_serve_step (ROADMAP Queue 1 item 11)')
        cfg = self.cfg
        b, s, d = shape.global_batch, shape.seq_len, cfg.d_model
        specs = {'tokens': InputSpec((b, s), torch.int32),
                 'labels': InputSpec((b, s), torch.int32)}
        if cfg.family == 'encdec':
            specs['frames'] = InputSpec((b, s, d), torch.bfloat16)
        elif cfg.frontend is not None:
            specs['prefix_embeds'] = InputSpec((b, cfg.frontend_tokens, d),
                                               torch.bfloat16)
        return specs

    def input_axes(self, shape: ShapeConfig) -> Dict[str, tuple]:
        """The logical axes of each of :meth:`input_specs`' inputs."""
        known = {'tokens': ('batch', 'seq'), 'labels': ('batch', 'seq'),
                 'frames': ('batch', 'seq', 'embed'),
                 'prefix_embeds': ('batch', None, 'embed')}
        return {name: known[name] for name in self.input_specs(shape)}

    def prefill_fn(self, params, cache, batch, *, use_kernel=False):
        """Whole-prompt prefill: (cache, (B, V) f32 scores of the last
        token).  Dense: into the global pool, the flash-attention kernel
        with ``use_kernel``.  ssm: from the recurrent state in ``cache``,
        the WKV6 kernel with ``use_kernel``.  moe, hybrid, encdec: the
        plain path only (the reference has no kernel path for them)."""
        fam = self.cfg.family
        self._no_kernel(use_kernel, ('moe',) + NO_KERNEL)
        if fam in ('moe',) + NO_KERNEL:
            return _FAMILY[fam].prefill(self.cfg, params, cache, batch)
        return _FAMILY[fam].prefill(self.cfg, params, cache, batch,
                                    use_kernel=use_kernel)

    def decode_fn(self, params, cache, batch, *, use_kernel=False,
                  long_context=False, tp=None):
        """One token a row: (cache, (B, V) f32 scores).  Dense and moe:
        the paged decode kernel with ``use_kernel``.  ssm: the single-token
        recurrence step (no kernel, as in the reference).  hybrid: the
        shared block through the page table, or with ``long_context`` over
        the contiguous KV; encdec: through the page table (neither has a
        kernel path).  ``tp``: a tensor-parallel rank's step (dense, vlm and
        moe; ``distributed/tp.py``)."""
        fam = self.cfg.family
        self._no_kernel(use_kernel)
        tp_kw = self._tp(tp)
        if long_context and fam != 'hybrid':
            raise NotImplementedError(
                f'long-context decode is hybrid only, not {fam!r}')
        if fam == 'hybrid':
            return zamba2.decode_step(self.cfg, params, cache, batch,
                                      long_context=long_context)
        if fam in ('ssm', 'encdec'):
            return _FAMILY[fam].decode_step(self.cfg, params, cache, batch)
        return _FAMILY[fam].decode_step(self.cfg, params, cache, batch,
                                        use_kernel=use_kernel, **tp_kw)

    def decode_sample_fn(self, params, cache, batch, *, use_kernel=False,
                         temperature=0.0, tp=None):
        """Fused decode+sampling step: (cache, (B,) int32 tokens).  Dense
        and vlm only, as in the reference."""
        self._only('dense', 'vlm')
        return dense.decode_step_sample(self.cfg, params, cache, batch,
                                        use_kernel=use_kernel,
                                        temperature=temperature, tp=tp)

    def prefill_chunk_fn(self, params, cache, batch, *, tp=None):
        self._only('dense', 'vlm', 'moe')
        return _FAMILY[self.cfg.family].prefill_chunk(
            self.cfg, params, cache, batch, **self._tp(tp))

    def _tp(self, tp):
        """The ``tp`` keyword for a serving entry point: none without a
        mesh; dense, vlm and moe only with one (every family trains with
        one: :meth:`loss_fn`)."""
        if tp is None:
            return {}
        self._only('dense', 'vlm', 'moe')
        return {'tp': tp}


@functools.lru_cache(maxsize=None)
def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
