"""Model API of the port: ``build_model(cfg)`` returns a :class:`Model` bound
to a config, with the entry points the engine and the tests need.  The port
serves the ``dense`` and ``vlm`` families (``vlm`` shares the dense
decoder and takes its frontend's output as ``batch['prefix_embeds']``; the
frontend itself is not ported) and the ``moe`` family (the dense decoder
with routed experts; no fused sampling and no prefill kernel, as in the
reference), and runs the ``ssm`` family (rwkv6): prefill + decode over a
recurrent-state cache.  Every family trains: :meth:`Model.loss_fn` is
differentiable by autograd through the plain paths, on one device or as a
tensor-parallel rank's share (``tp``); and every family's
:meth:`Model.prefill_fn` / :meth:`Model.decode_fn` run a tensor-parallel
rank's share too (``tp``: the serve step on a mesh).

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

For the serve step and the dry-run (``training/train_step.py::
make_serve_step``, ``launch/dryrun.py``) a :class:`Model` describes each
execution shape of ``configs.SHAPES`` as the reference does: the cache of
a shape (:meth:`Model.cache_template`, ``cache_shapes``, ``cache_axes``,
``init_cache``; the paged families' per-request region pools), the step's
inputs (:meth:`Model.input_specs` / ``input_axes`` for the train, prefill
and decode kinds) and small concrete inputs drawn as the reference draws
them (:meth:`Model.make_inputs`).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, ShapeConfig, cell_supported
from repro_torch.models import common as cm
from repro_torch.models import dense, encdec, moe, rwkv6, zamba2

_FAMILY = {'dense': dense, 'vlm': dense, 'moe': moe, 'ssm': rwkv6,
           'hybrid': zamba2, 'encdec': encdec}
NO_KERNEL = ('hybrid', 'encdec')     # families with no kernel path


def region_slots(max_pages: int) -> int:
    """A row's region slots for ``max_pages`` pages: one more for the
    quarantine slot 0, rounded up to a multiple of 16 (the reference's)."""
    return -(-(max_pages + 1) // 16) * 16


@dataclass(frozen=True)
class InputSpec:
    """A step input's shape and torch dtype (the reference's
    ``ShapeDtypeStruct`` stand-in)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


# the logical axes of a step's batch tensors by name (``loss_mask`` as the
# labels it masks); ``tokens`` are (B, S), or (B,) for a decode step
INPUT_AXES = {'labels': ('batch', 'seq'), 'loss_mask': ('batch', 'seq'),
              'frames': ('batch', 'seq', 'embed'),
              'prefix_embeds': ('batch', None, 'embed'),
              'page_table': ('batch', None), 'positions': ('batch',)}


def input_axes_of(name: str, ndim: int) -> tuple:
    """The logical axes of a batch tensor ``name`` of ``ndim`` dimensions
    (:data:`INPUT_AXES`)."""
    if name == 'tokens':
        return ('batch', 'seq')[:ndim]
    return INPUT_AXES[name]


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

    def init_blocks(self, seed: int, plan, *, device):
        """``plan``'s blocks (a ``distributed.tp.TensorParallel`` or a
        ``training.train_step.TrainPlan``: ``plan.shard``) of
        ``init_params(seed, device=device)``, the same
        numbers, drawn a leaf at a time: the device holds one whole leaf at
        once, never the whole set (an ``nn.ParameterDict`` as
        :meth:`init_params`', each cut block a copy)."""
        device = torch.device(device)
        gen = torch.Generator(device=device).manual_seed(seed)

        def release():
            # the card's free segments back to it (the leaf's f32 draw,
            # then the whole leaf), before a block lands in one and pins it
            # cached: the next leaf, or another process sharing the card,
            # needs the room
            if device.type == 'cuda':
                torch.cuda.empty_cache()

        def build(node, path):
            if not isinstance(node, cm.PSpec):
                return nn.ParameterDict({k: build(v, path + (k,))
                                         for k, v in node.items()})
            whole = cm.init_leaf(node, gen, device)
            release()
            part = plan.shard(path, whole)
            if part.shape != whole.shape:
                part = part.clone(memory_format=torch.contiguous_format)
            del whole
            release()
            return nn.Parameter(part, requires_grad=False)
        return build(self.template(), ())

    def _no_kernel(self, use_kernel: bool, families=NO_KERNEL):
        if use_kernel and self.cfg.family in families:
            raise NotImplementedError(
                f'family {self.cfg.family!r} has no kernel path here (the '
                'reference runs none for it)')

    def cache_template(self, shape: Optional[ShapeConfig] = None, *,
                       engine_pages: Optional[int] = None,
                       batch_size: Optional[int] = None,
                       max_seq: Optional[int] = None,
                       enc_len: Optional[int] = None):
        """The cache's PSpec tree.

        With an execution ``shape`` (the serve step's, the reference's
        ``cache_template(shape)``): the paged families' per-request region
        pools {'k', 'v'} of (L, B, R, pg, Hkv, Dh), B the shape's global
        batch and R = ceil((seq_len // pg + 1) / 16) * 16 slots a row
        (slot 0 the quarantine slot; rounded up so that the slots split
        over a 16-way ``model`` axis); ``ssm`` the recurrent state of B
        rows; ``hybrid`` the Mamba state and the shared block's region
        pools, or for ``long_500k`` its contiguous KV of ``seq_len``
        tokens; ``encdec`` a global pool of R pages beside the cross K/V of
        B rows of :meth:`enc_len` frames (as the reference).  A shape takes
        none of the keyword forms below.

        Without a shape (the engine's keyword forms): the global paged pool
        {'k', 'v'} of (L, engine_pages, pg, Hkv, Dh) for the paged
        families, the recurrent state of ``batch_size`` rows for ``ssm``;
        for ``hybrid`` {'mamba': the state of ``batch_size`` rows, 'attn':
        the shared block's paged pools of ``engine_pages``, or with
        ``max_seq`` its contiguous long-context KV}; for ``encdec`` the
        decoder's pool of ``engine_pages`` and the cross K/V of
        ``batch_size`` rows of ``enc_len`` frames."""
        if shape is not None:
            if (engine_pages, batch_size, max_seq, enc_len) != (None,) * 4:
                raise ValueError('an execution shape sizes the cache itself; '
                                 'the engine\'s keyword forms take no shape')
            return self._shape_cache_template(shape)
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

    def _shape_cache_template(self, shape: ShapeConfig):
        cfg, fam = self.cfg, self.cfg.family
        b = shape.global_batch
        region = region_slots(shape.seq_len // cfg.page_size)
        if fam in ('dense', 'vlm', 'moe'):
            return dense.cache_template(cfg, region, batch=b)
        if fam == 'ssm':
            return rwkv6.cache_template(cfg, b)
        if fam == 'hybrid':
            if shape.name == 'long_500k':
                attn = zamba2.attn_cache_template_dense(cfg, b, shape.seq_len)
            else:
                attn = zamba2.attn_cache_template(cfg, region, batch=b)
            return {'mamba': zamba2.mamba_cache_template(cfg, b),
                    'attn': attn}
        return encdec.cache_template(cfg, region, b, self.enc_len(shape))

    def cache_shapes(self, shape: Optional[ShapeConfig] = None, **kw):
        """The shapes of :meth:`cache_template` (same arguments)."""
        return cm.shapes_from_template(self.cache_template(shape, **kw))

    def cache_axes(self, shape: Optional[ShapeConfig] = None, **kw):
        """The logical axes of :meth:`cache_template` (same arguments)."""
        return cm.axes_from_template(self.cache_template(shape, **kw))

    def init_cache(self, shape: Optional[ShapeConfig] = None, *,
                   engine_pages: Optional[int] = None,
                   batch_size: Optional[int] = None,
                   max_seq: Optional[int] = None,
                   enc_len: Optional[int] = None, device, dtype=None):
        """:meth:`cache_template`'s cache, zeros, on ``device``; ``dtype``
        (the model's, where it is not bf16) for every leaf but the f32
        recurrent states."""
        return cm.zeros_from_template(
            self.cache_template(shape, engine_pages=engine_pages,
                                batch_size=batch_size, max_seq=max_seq,
                                enc_len=enc_len), device, dtype)

    def enc_len(self, shape: ShapeConfig) -> int:
        """The encoder context of an encdec execution shape: the whole
        sequence for prefill, at most 4096 frames otherwise (the
        reference's)."""
        if shape.kind == 'prefill':
            return shape.seq_len
        return min(shape.seq_len, 4096)

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
        descriptions): ``train`` tokens and labels (B, S); ``prefill``
        tokens (B, S) and the page table (B, S // pg) (encdec: frames (B,
        S, D) and a decoder prefix of S // 8 tokens; ssm: no page table);
        ``decode`` one token a row, its position and the page table (B, S
        // pg) (ssm and ``long_500k``: no page table).  vlm adds
        ``prefix_embeds`` (B, frontend_tokens, D)."""
        ok, why = cell_supported(self.cfg, shape)
        if not ok:
            raise ValueError(f'{self.cfg.name} × {shape.name}: {why}')
        cfg = self.cfg
        b, s, d = shape.global_batch, shape.seq_len, cfg.d_model
        pg = cfg.page_size
        i32, bf16 = torch.int32, torch.bfloat16
        if shape.kind == 'train':
            specs = {'tokens': InputSpec((b, s), i32),
                     'labels': InputSpec((b, s), i32)}
            if cfg.family == 'encdec':
                specs['frames'] = InputSpec((b, s, d), bf16)
            elif cfg.frontend is not None:
                specs['prefix_embeds'] = InputSpec(
                    (b, cfg.frontend_tokens, d), bf16)
            return specs
        if shape.kind == 'prefill':
            if cfg.family == 'encdec':
                s_dec = s // encdec.DEC_PREFIX_FRACTION
                return {'frames': InputSpec((b, s, d), bf16),
                        'tokens': InputSpec((b, s_dec), i32),
                        'page_table': InputSpec((b, s_dec // pg), i32)}
            specs = {'tokens': InputSpec((b, s), i32)}
            if cfg.family != 'ssm':
                specs['page_table'] = InputSpec((b, s // pg), i32)
            if cfg.frontend is not None:
                specs['prefix_embeds'] = InputSpec(
                    (b, cfg.frontend_tokens, d), bf16)
            return specs
        specs = {'tokens': InputSpec((b,), i32),
                 'positions': InputSpec((b,), i32)}
        if cfg.family != 'ssm' and shape.name != 'long_500k':
            specs['page_table'] = InputSpec((b, s // pg), i32)
        return specs

    def input_axes(self, shape: ShapeConfig) -> Dict[str, tuple]:
        """The logical axes of each of :meth:`input_specs`' inputs."""
        return {name: input_axes_of(name, len(spec.shape))
                for name, spec in self.input_specs(shape).items()}

    def make_inputs(self, kind: str, b: int, s: int,
                    rng: Optional[np.random.Generator] = None, *, device):
        """Small concrete inputs of a ``kind`` ('train', 'prefill',
        'decode') on ``device``, drawn from ``rng`` in the reference's
        order (the same numbers as its ``make_inputs``): page tables hold
        region-local ids 1 .. S // pg (slot 0 is the quarantine slot), a
        decode row's position is S - 1."""
        cfg = self.cfg
        rng = rng or np.random.default_rng(0)
        d = cfg.d_model
        maxp = s // cfg.page_size

        def tok(shp):
            return torch.tensor(rng.integers(0, cfg.vocab_size, size=shp),
                                dtype=torch.int32, device=device)

        def bf16(shp):
            return torch.tensor(rng.normal(size=shp) * 0.02,
                                dtype=torch.float32,
                                device=device).to(torch.bfloat16)

        pt = torch.arange(1, maxp + 1, dtype=torch.int32,
                          device=device).expand(b, maxp).contiguous()
        if kind == 'train':
            batch = {'tokens': tok((b, s)), 'labels': tok((b, s))}
            if cfg.family == 'encdec':
                batch['frames'] = bf16((b, s, d))
            elif cfg.frontend is not None:
                batch['prefix_embeds'] = bf16(
                    (b, min(cfg.frontend_tokens, s), d))
            return batch
        if kind == 'prefill':
            if cfg.family == 'encdec':
                return {'frames': bf16((b, s, d)), 'tokens': tok((b, s)),
                        'page_table': pt}
            batch = {'tokens': tok((b, s))}
            if cfg.family != 'ssm':
                batch['page_table'] = pt
            if cfg.frontend is not None:
                batch['prefix_embeds'] = bf16(
                    (b, min(cfg.frontend_tokens, s), d))
            return batch
        if kind == 'decode':
            return {'tokens': tok((b,)),
                    'positions': torch.full((b,), s - 1, dtype=torch.int32,
                                            device=device),
                    'page_table': pt}
        raise ValueError(kind)

    def prefill_fn(self, params, cache, batch, *, use_kernel=False,
                   tp=None):
        """Whole-prompt prefill: (cache, (B, V) f32 scores of the last
        token).  Dense: into the global or the region pool, the
        flash-attention kernel with ``use_kernel``.  ssm: from the
        recurrent state in ``cache``, the WKV6 kernel with ``use_kernel``.
        moe, hybrid, encdec: the plain path only (the reference has no
        kernel path for them).  ``tp``: a tensor-parallel rank's step over
        its weight and cache blocks, every family (``distributed/tp.py``;
        a serve step's plan returns the rank's rows over its vocabulary
        block)."""
        fam = self.cfg.family
        self._no_kernel(use_kernel, ('moe',) + NO_KERNEL)
        if fam in ('moe',) + NO_KERNEL:
            return _FAMILY[fam].prefill(self.cfg, params, cache, batch, tp=tp)
        return _FAMILY[fam].prefill(self.cfg, params, cache, batch,
                                    use_kernel=use_kernel, tp=tp)

    def decode_fn(self, params, cache, batch, *, use_kernel=False,
                  long_context=False, tp=None):
        """One token a row: (cache, (B, V) f32 scores).  Dense and moe:
        the paged decode kernel with ``use_kernel``.  ssm: the single-token
        recurrence step (no kernel, as in the reference).  hybrid: the
        shared block through the page table, or with ``long_context`` over
        the contiguous KV; encdec: through the page table (neither has a
        kernel path).  ``long_context`` is read for hybrid only and ignored
        for the other families, as the reference's.  ``tp``: a
        tensor-parallel rank's step, every family (``distributed/tp.py``)."""
        fam = self.cfg.family
        self._no_kernel(use_kernel)
        if fam == 'hybrid':
            return zamba2.decode_step(self.cfg, params, cache, batch,
                                      long_context=long_context, tp=tp)
        if fam in ('ssm', 'encdec'):
            return _FAMILY[fam].decode_step(self.cfg, params, cache, batch,
                                            tp=tp)
        return _FAMILY[fam].decode_step(self.cfg, params, cache, batch,
                                        use_kernel=use_kernel, tp=tp)

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
            self.cfg, params, cache, batch, tp=tp)


@functools.lru_cache(maxsize=None)
def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
