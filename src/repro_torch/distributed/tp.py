"""Tensor parallelism over a mesh's ``model`` axis: serving, and the
trainer's forward and backward.

The reference shards the params and the KV pool by ``SERVE_RULES`` and
lets GSPMD insert the collectives where the forward's ``constrain`` calls
pin a layout.  Here each rank holds its blocks as ordinary tensors and the
forward (``models/dense.py``, given a :class:`TensorParallel`) runs the
collectives itself, over the ``model`` axis's process group:

- q/k/v are column blocks of whole heads, ``wo`` a row block: attention's
  output projection is a partial sum, then a reduction;
- ``wg``/``wu`` column blocks and ``wd`` a row block: the MLP the same;
- the embedding is vocab-parallel (a masked lookup of the rank's rows,
  then a reduction), and so is the head (qwen3 ties it to the
  embedding): each rank's block of scores is gathered before sampling.
  Where ``model`` does not divide the vocabulary (seamless's 256206 on 16
  ranks), the reference's ``shaped_spec`` moves it onto d_model, and so
  does every plan (:attr:`TensorParallel.embed_cut`; no architecture the
  engine serves meets it at ``model`` <= 16, and its fused sampling
  refuses it): a rank looks up its columns of every row, gathered whole
  (:meth:`TensorParallel.embed_gather`), and its columns of the head give
  f32 partial scores summed over ``model`` (:meth:`TensorParallel.
  head_sum`), the loss's logits too;
- the norms are replicated.

**Heads, or RoPE pairs of every head.**  Where the mesh divides the
kv-heads, rank r holds kv-heads [r Hkv/n, (r+1) Hkv/n) and their q-heads
(:func:`head_blocks`) -- so the GQA groups stay on one rank and the pool
shard holds 1/n of the kv-heads.  Where it does not, the reference's
``shaped_spec`` cuts the flattened (H*Dh) width and moves the pool's axis
onto head_dim; RoPE pairs channels d and d + Dh/2 and qwen3's q/k norms
reduce over Dh, so a plan holds a block of RoPE pairs of every head
instead, as many bytes as the reference's block (:attr:`TensorParallel.pair_cut`: the
norms sum their squares over ``model``, decode sums the f32 partial
scores, prefill and training gather q/k/v into whole heads).  Every plan
does, the engine's too (:func:`engine_plan`, the reference engine's
``tree_spec_shaped(..., SERVE_RULES, mesh)``): its paged reads of the
global pool sum the partial scores as the serve step's do
(:meth:`TensorParallel.paged_read`), so its decode runs the plain path
(K1 reads whole heads).  Where the mesh divides neither the kv-heads
nor Dh/2, a plan keeps whole heads: where the mesh divides the
q-heads and each rank's q-heads read one kv-head (G % (H/n) == 0), each
rank holds that one kv-head, its projection columns and its pool
replicated over the G n / H ranks that read it; otherwise attention is
replicated.  Where the mesh does not divide ``d_ff``, that part is
replicated.  Every reduction is an all-reduce of f32 partial sums
(:func:`reduce_sum`), rounded once to the activations' dtype: every rank
receives the one reduced buffer, so the replicated activations hold the
same bits on every rank.

**One control plane.**  Rank 0 runs the engine, its scheduler, the
``KVPool`` and the ``ValveRuntime``; each dispatch sends its op and its
staged host batch to the other ranks (:class:`Leader`), which run the same
model entry on their blocks (:func:`serve_rank`).  Were every rank to
schedule for itself, a real clock would let the ranks' schedules diverge
into collectives that never match.

**Training** (``training/train_step.py``) runs the same forward under
autograd (every family: the placement table is the family's,
:meth:`TensorParallel.ranges`; rwkv6 splits its wkv heads -- or, where
``model`` does not divide them, every head's value channels
(:meth:`TensorParallel._wkv_placement`) -- and ``d_ff``,
zamba2 its Mamba2 heads with a share of B and C and its shared block's
heads, encdec its encoder's and decoder's heads and ``d_ff`` as dense), and
the collectives carry their gradients as Megatron's pair:
:class:`_ReduceFromModel` (forward: the f32 sum over the ranks, rounded
once; backward: the identity, since its output is replicated and every rank
holds the same gradient of it) after a row-parallel product, the
vocab-parallel lookup and the head's partial sums, and
:class:`_CopyToModel` (forward: the identity; backward: the sum of the
ranks' gradients) where a replicated activation enters a rank's block of a
column-parallel product.  ``torch.distributed.nn.functional.all_reduce`` is
not that pair: its backward sums gradients that are already whole, n times
the gradient.  Two more pairs: :class:`_SumOverModel` (forward and backward
both the sum over the ranks) for a norm's statistic that each rank applies
to its own block (zamba2's gated norm over all of ``d_in``), and
:meth:`TensorParallel.gather_shares` (forward a gather, backward the sum
over the ranks, then the rank's block) for a tensor that every rank reads
for its own block (zamba2's B and C).  Where each rank holds one kv-head
replicated over several ranks, that kv-head's ``wk``/``wv``/``bk``/``bv``
gradient on a rank covers its own q-heads only, so those weights pass
through :class:`_CopyToModel` over the ranks that hold the same kv-head; so
do qwen3's q/k norms, one vector for every head, over all the ranks
(:meth:`TensorParallel.attn_weights`).  Serving runs no autograd, and its
path stays op for op what it was: each of these applies only to a tensor
that requires grad.

**Data-parallel serving.**  The batch axes (``pod``, ``data``:
``SERVE_RULES['batch']``) split each dispatch's ``max_batch`` rows into
contiguous blocks in rank order (:func:`~repro_torch.distributed.sharding.
row_block`; every row where they do not divide it): a rank computes its
block's rows over its ``model`` blocks, and the weights are replicated over
the batch axes.  The pool is replicated too (the reference keeps ``pages``
unsharded, and a row's pages may be read by another batch rank at the next
dispatch), so every replica writes every row's K/V: each layer's new K/V
rows are gathered over the batch axes before they are written.  The scores
and the sampled tokens are gathered over the batch axes, so every rank
holds the whole batch's.

**Expert parallelism.**  Where ``model`` divides the experts, rank r holds
experts [r E/n, (r+1) E/n) of ``we_gate``/``we_up``/``we_down`` and their
``router`` columns (``expert`` over ``model`` in ``SERVE_RULES`` and
``TRAIN_RULES``); where it does not, every rank holds every expert and
cuts each one's ``d_ff`` (the reference's ``shaped_spec`` moves the axis
onto another dimension; the function computed is the same).  The router's
logits are gathered over ``model`` before the softmax, so every rank routes
alike; a rank runs its experts on its slots and its f32 partial joins one
:func:`reduce_sum` (``models/moe.py``).

**The rule variants.**  ``TensorParallel(rules=)`` places the weights
as the reference's specs under ``rules`` place them
(:func:`attention_placement`; ``TRAIN_RULES`` by default), for the
trainer and the serve step alike: ``serve_dh`` replicates attention's
projections (rwkv6's time mix, zamba2's Mamba2 layers and shared
attention), which every rank then runs whole, and cuts the q/k norms on
head_dim (:attr:`norms_cut`); ``serve_kv_dp`` replicates rwkv6's ``u``
and zamba2's ``A_log`` / ``dt_bias`` / ``D`` (``HEAD_LEAVES``), which
every rank reads for every head; rwkv6's ``u`` is cut on K wherever
every rank holds every wkv head but under ``serve_kv_dp``
(:attr:`u_dim`).  A leaf cut on head_dim is gathered whole before use
(:meth:`whole`; under autograd the backward keeps the rank's block of the
gradient, which every rank computes whole); a replicated leaf a rank
reads for its own heads only passes through :class:`_CopyToModel`
(:meth:`head_share`), so its gradient is summed over ``model``.

**The serve step** (:class:`StepParallel`, ``make_serve_step``) runs
every family on a mesh over the training placement, each rank on its own
rows with its cache blocks following its weight blocks
(:meth:`StepParallel.cache_block`); under ``LONG_SERVE_RULES`` the rows
are replicated and zamba2's long-context KV sequence is split over the
batch axes, each rank's partial softmax state combined in rank order
(:meth:`StepParallel.seq_attention`).  Under the reference's serving
variants the plan's rules move the pool and attention's heads
(:attr:`StepParallel.placement`): ``serve_kv_dp`` replicates the pool
over ``model`` (the new K/V heads gathered, every replica writing them),
``serve_seq`` splits its pages over ``model`` (the ranks' partial softmax
states combined in rank order), ``serve_dh`` splits its head_dim (the
f32 partial scores summed over ``model``, the projections replicated).
Where no batch axis divides the rows (long_500k's one row under a
variant), the recurrent states and the long KV are the blocks of the
reference's specs, the freed batch axes on a state or KV dimension
(:attr:`StepParallel.moved`).

Transport: the dispatch messages over the default group's host side
(``broadcast_object_list``), weight shards rank 0 -> worker and the cache
gather worker -> rank 0 as host tensors (``send`` / ``gather`` on CPU
copies: staged through host memory, so gloo takes them whether the ranks
compute on the CPU or on CUDA); the forward's collectives on the tensors
as they are (gloo takes CUDA tensors for ``all_reduce`` and
``all_gather_into_tensor``; NCCL where each rank has a card of its own).
"""
from __future__ import annotations

import itertools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.distributed.sharding import (BATCH_AXES, SERVE_RULES,
                                              TRAIN_RULES, Block,
                                              batch_coords, block,
                                              local_bounds, row_block,
                                              shaped_spec)
from repro_torch.kernels.sampling.ref import combine_bests, unembed_scores
from repro_torch.models import common as cm

MODEL = 'model'
# the leaves on the recurrences' 'heads' axis (rwkv6's u, zamba2's A_log,
# dt_bias, D), which serve_kv_dp replicates
HEAD_LEAVES = ('u', 'A_log', 'dt_bias', 'D')
# the weights of one kv-head block (encdec's cross-attention ones too,
# with an 'x' in front)
KV_LEAVES = ('wk', 'wv', 'bk', 'bv')
# where a serve step's rules put attention's heads and pool
# (:func:`attention_placement`, :class:`StepParallel`)
HEADS, KV_DP, SEQ, DH = 'heads', 'kv_dp', 'seq', 'dh'
# where rwkv6's time mix lies over model (:meth:`TensorParallel.
# _wkv_placement`)
WKV_HEADS, WKV_VALUES, WKV_EVERY = 'heads', 'values', 'every'


class _ReduceFromModel(torch.autograd.Function):
    """Forward: the sum of every rank's f32 ``part`` over ``group``;
    backward: the identity (the sum is replicated, so is its gradient)."""

    @staticmethod
    def forward(ctx, part, group):
        out = part.clone()
        torch.distributed.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyToModel(torch.autograd.Function):
    """Forward: the identity; backward: the sum of every rank's gradient
    over ``group``, in f32, rounded once to the gradient's dtype."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        total = grad.to(torch.float32, copy=True)
        torch.distributed.all_reduce(total, group=ctx.group)
        return total.to(grad.dtype), None


class _SumOverModel(torch.autograd.Function):
    """Forward: the sum of every rank's f32 ``part`` over ``group``;
    backward: the sum of every rank's gradient too.  For a statistic that
    every rank then applies to its own block (zamba2's gated norm over
    all of ``d_in``, each rank holding some heads): each rank's gradient of
    the sum covers its own block's use only."""

    @staticmethod
    def forward(ctx, part, group):
        ctx.group = group
        out = part.clone()
        torch.distributed.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        total = grad.clone()
        torch.distributed.all_reduce(total, group=ctx.group)
        return total, None


class _GatherFromModel(torch.autograd.Function):
    """Forward: every rank's block of the last dimension, gathered in rank
    order over ``group``; backward: this rank's block of the gradient (the
    computation after the gather is replicated, so every rank holds the
    whole gradient already: no sum)."""

    @staticmethod
    def forward(ctx, part, group, rank):
        ctx.width, ctx.rank = part.shape[-1], rank
        return _gather_last(part, group)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.rank * ctx.width
        return grad[..., lo:lo + ctx.width], None, None


class _SplitToModel(torch.autograd.Function):
    """Forward: this rank's block of the last dimension of a tensor every
    rank holds whole (``n`` blocks in rank order); backward: every rank's
    block of the gradient gathered (each rank's computation after the
    split reads its own block only, so its gradient covers that block)."""

    @staticmethod
    def forward(ctx, whole, group, rank, n):
        ctx.group = group
        width = whole.shape[-1] // n
        return whole[..., rank * width:(rank + 1) * width]

    @staticmethod
    def backward(ctx, grad):
        return _gather_last(grad, ctx.group), None, None, None


def _gather_last(part: torch.Tensor, group) -> torch.Tensor:
    n = torch.distributed.get_world_size(group)
    rows = part.movedim(-1, 0).contiguous()
    out = rows.new_empty((n * rows.shape[0],) + tuple(rows.shape[1:]))
    torch.distributed.all_gather_into_tensor(out, rows, group=group)
    return out.movedim(0, -1)


def _traced(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def head_blocks(n_heads: int, n_kv: int, n: int,
                r: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """(q-heads [lo, hi), kv-heads [lo, hi)) rank ``r`` of ``n`` holds."""
    if n_kv % n == 0:
        return block(n_heads, n, r), block(n_kv, n, r)
    group = n_heads // n_kv
    if n_heads % n == 0 and group % (n_heads // n) == 0:
        q = block(n_heads, n, r)
        kv = q[0] // group
        return q, (kv, kv + 1)
    return (0, n_heads), (0, n_kv)


class TensorParallel:
    """One rank's plan over a mesh's ``model`` axis, and the collectives of
    the tensor-parallel forward.  ``coords`` (axis -> coordinate) defaults
    to the mesh's own rank's; another rank's plan needs no process group.
    ``max_batch``: a serving plan's dispatch rows, cut over the batch axes
    (:attr:`rows`); a plan without it (the trainer's) computes every row
    of what it is given.  ``rules`` (``TRAIN_RULES`` by default): where
    the weights lie (:attr:`placement`; the module docstring's rule
    variants; the engine's plan is :func:`engine_plan`'s, under
    ``SERVE_RULES``).  Where ``model`` does not divide the kv-heads,
    attention is placed as the reference's ``shaped_spec`` places it (a
    block of RoPE pairs of every head, :attr:`pair_cut`), in every plan:
    the serve step's, the trainer's and the engine's."""

    # the pool's pages (a serve step's plan under ``serve_seq`` holds a
    # block of them: :class:`StepParallel`)
    held = None
    # whether the rows are placed by the reference's spec of each state
    # (a serve step's plan: :attr:`StepParallel.moved`)
    moved = False

    def __init__(self, cfg, mesh, coords: Optional[Dict[str, int]] = None,
                 *, max_batch: Optional[int] = None, rules=None):
        self.cfg, self.mesh = cfg, mesh
        self.rules = TRAIN_RULES if rules is None else rules
        self.placement = attention_placement(self.rules)
        coords = mesh.coords() if coords is None else coords
        self.coords = dict(coords)
        self.n = mesh.shape.get(MODEL, 1)
        self.rank = coords.get(MODEL, 0)
        # the paged-attention heads (none in rwkv6 and zamba2's backbone;
        # zamba2's shared block has heads of its own below)
        attn = cfg.family not in ('ssm', 'hybrid')
        self.q_heads, self.kv_heads = head_blocks(
            cfg.n_heads, cfg.n_kv_heads, self.n if attn else 1,
            self.rank if attn else 0)
        self.attn_split = self.q_heads != (0, cfg.n_heads)
        # ranks holding this rank's kv-heads: > 1 where a kv-head is
        # replicated over the ranks whose q-heads read it
        self.kv_holders = (self.n * (self.kv_heads[1] - self.kv_heads[0])
                           // cfg.n_kv_heads if self.attn_split else 1)
        self.ffn = self._split(cfg.d_ff)
        self.vocab = self._split(cfg.vocab_size)
        self.vocab_split = self.vocab != (0, cfg.vocab_size)
        # where model does not divide the vocabulary, the reference's
        # shaped_spec moves it onto d_model: the embedding's and the head's
        # columns [lo, hi) of d_model
        self.embed_cut = (self.n > 1 and not self.vocab_split
                          and cfg.d_model % self.n == 0)
        self.embed_cols = (block(cfg.d_model, self.n, self.rank)
                           if self.embed_cut else (0, cfg.d_model))
        # experts: whole ones where model divides them, else every expert
        # with its d_ff cut (module docstring)
        e = cfg.n_experts
        self.experts = self._split(e) if e else (0, 0)
        self.expert_split = self.experts != (0, e)
        self.expert_ffn = (0, cfg.d_ff) if self.expert_split else self.ffn
        self.experts_partial = self.expert_split or self.ffn != (0, cfg.d_ff)
        self.shared_ffn = self._split(cfg.d_ff * max(cfg.n_shared_experts, 1))
        # rwkv6's time mix (:meth:`_wkv_placement`)
        self.wkv_mode, self.wkv, self.values = self._wkv_placement()
        # zamba2: whole Mamba2 heads (channels [lo, hi) of d_in) and a
        # share of the state dimension N of B and C, both or neither; the
        # shared block's own heads (channels of its q/k/v width) and d_ff
        self.mamba, self.mamba_state = (0, 0), (0, 0)
        self.shared_heads, self.hybrid_ffn = (0, 0), (0, 0)
        self.mamba_split = self.shared_split = False
        if cfg.family == 'hybrid':
            d_in = cfg.ssm_expand * cfg.d_model
            n_heads = d_in // cfg.ssm_head_dim
            self.mamba_split = (n_heads % self.n == 0
                                and cfg.ssm_state % self.n == 0)
            self.mamba = (self._heads(n_heads, cfg.ssm_head_dim)
                          if self.mamba_split else (0, d_in))
            self.mamba_state = self._split(cfg.ssm_state) \
                if self.mamba_split else (0, cfg.ssm_state)
            ah = cfg.hybrid_attn_heads
            self.shared_heads = self._heads(ah, 2 * cfg.d_model // ah)
            self.hybrid_ffn = self._split(cfg.hybrid_attn_d_ff)
            self.shared_split = self.shared_heads != (0, 2 * cfg.d_model)
        if self.placement == DH:
            # replicated projections: every head (and every wkv head, every
            # Mamba2 head) on every rank, the computation replicated
            self.q_heads, self.kv_heads = (0, cfg.n_heads), (0, cfg.n_kv_heads)
            self.attn_split, self.kv_holders = False, 1
            if cfg.family == 'hybrid':
                d_in = cfg.ssm_expand * cfg.d_model
                self.mamba, self.mamba_state = (0, d_in), (0, cfg.ssm_state)
                self.mamba_split = False
                self.shared_heads = (0, 2 * cfg.d_model)
                self.shared_split = False
        # the head_dim block of attention (zamba2's shared block's) under
        # serve_dh; the q/k norms take it too
        dh = 2 * cfg.d_model // cfg.hybrid_attn_heads \
            if cfg.family == 'hybrid' else cfg.hd
        self.dh_split = (self.placement == DH and self.n > 1
                         and dh % self.n == 0)
        self.head_dim = block(dh, self.n, self.rank) if self.dh_split \
            else (0, dh)
        self.norms_cut = self.dh_split and cfg.qk_norm
        # where model does not divide the kv-heads, the reference's
        # shaped_spec cuts the flattened q/k/v width (``wo``'s rows) and
        # moves the pool's model axis onto head_dim: rank r holds RoPE
        # pairs [lo, hi) of every head -- channels [lo, hi) and [Dh/2 + lo,
        # Dh/2 + hi) -- in the projections, ``wo`` and the pool, so RoPE
        # stays on the rank; the q/k norms sum their squares over model
        half = cfg.hd // 2
        self.pair_cut = (cfg.family in ('dense', 'vlm', 'moe')
                         and self.placement != DH and self.n > 1
                         and cfg.n_kv_heads % self.n != 0
                         and half % self.n == 0)
        self.pairs = block(half, self.n, self.rank) if self.pair_cut \
            else (0, half)
        if self.pair_cut:
            self.q_heads, self.kv_heads = (0, cfg.n_heads), (0, cfg.n_kv_heads)
            self.attn_split, self.kv_holders = True, 1
        # rwkv6's ``u`` (L, H, K): on K where the rules place 'head_dim' on
        # model (serve_dh) or 'heads' where model does not divide them (the
        # reference moves it onto K), whole under serve_kv_dp
        k = cfg.ssm_head_dim
        self.u_dim = (block(k, self.n, self.rank)
                      if self.wkv_mode == WKV_VALUES or cfg.family == 'ssm'
                      and self.placement == DH and self.n > 1
                      and k % self.n == 0 else None)
        # the serving batch's rows over the batch axes
        self.n_batch, self.batch_index = (
            batch_coords(mesh, coords) if max_batch else (1, 0))
        self.rows = slice(*row_block(max_batch or 1, self.n_batch,
                                     self.batch_index))
        self.split_rows = self.rows.stop - self.rows.start < (max_batch or 1)
        self._group = self._batch_group = None

    def _split(self, size: int) -> Tuple[int, int]:
        return block(size, self.n, self.rank) if size % self.n == 0 \
            else (0, size)

    def _heads(self, n_heads: int, width: int) -> Tuple[int, int]:
        """[lo, hi) of this rank's channels of ``n_heads`` heads of
        ``width``: whole heads, all of them where ``model`` does not divide
        them."""
        lo, hi = self._split(n_heads)
        return lo * width, hi * width

    def _wkv_placement(self):
        """(mode, channels [lo, hi) of d_model, value channels [lo, hi) of
        a head) of rwkv6's time mix on this rank: ``WKV_HEADS``, whole wkv
        heads where ``model`` divides them; ``WKV_VALUES``, where it does
        not, the value channels [lo, hi) of every head (the reference's
        specs move ``model`` onto the state's V), with a contiguous d/n
        block of ``Wr``/``Wk``; ``WKV_EVERY`` (``serve_kv_dp``), a
        contiguous d/n block of every projection, every head run on every
        rank; None where the time mix is replicated (``serve_dh``, one
        rank, another family).  Raises where ``model`` divides neither
        the heads nor a head's channels."""
        cfg, n = self.cfg, self.n
        hd = cfg.ssm_head_dim
        if cfg.family != 'ssm' or n == 1 or self.placement == DH:
            return None, (0, cfg.d_model), (0, hd)
        heads = cfg.d_model // hd
        if self.placement == KV_DP or heads % n:
            if cfg.d_model % n or hd % n:
                raise NotImplementedError(
                    f'rwkv6 over model = {n}: it divides neither its '
                    f'{heads} wkv heads nor their {hd} channels')
        if self.placement == KV_DP:
            return WKV_EVERY, block(cfg.d_model, n, self.rank), (0, hd)
        if heads % n == 0:
            return WKV_HEADS, self._heads(heads, hd), (0, hd)
        return WKV_VALUES, block(cfg.d_model, n, self.rank), \
            block(hd, n, self.rank)

    def value_columns(self) -> Tuple[Tuple[int, int], ...]:
        """This rank's columns of rwkv6's (H x V) width under
        ``WKV_VALUES``: its value channels of every head, in global
        order."""
        hd, (lo, hi) = self.cfg.ssm_head_dim, self.values
        return tuple((h * hd + lo, h * hd + hi)
                     for h in range(self.cfg.d_model // hd))

    @property
    def group(self):
        if self._group is None:
            self._group = self.mesh.group(MODEL)
        return self._group

    @property
    def batch_group(self):
        """The group of the ranks that hold this rank's ``model`` blocks
        and the other rows of its dispatches (made on first use, at one
        point of every rank's forward)."""
        if self._batch_group is None:
            self._batch_group = self.mesh.group(
                tuple(a for a in BATCH_AXES if a in self.mesh.axis_names))
        return self._batch_group

    @property
    def data(self) -> Optional['DataShare']:
        """This rank's place among the batch ranks of a dispatch whose rows
        are split (MoE routes the whole dispatch: ``models/moe.py``), or
        None."""
        if not self.split_rows:
            return None
        return DataShare(self.batch_group, self.n_batch, self.batch_index)

    @property
    def kv_group(self):
        """The group of the ranks that hold this rank's kv-heads (the
        replicated case): the same coordinates off the ``model`` axis and
        the same kv-heads.  Made on every rank at once (``Mesh.group_by``)."""
        cfg, n = self.cfg, self.n
        return self.mesh.group_by(('kv', MODEL), lambda c: tuple(
            v for a, v in c.items() if a != MODEL) + head_blocks(
                cfg.n_heads, cfg.n_kv_heads, n, c[MODEL])[1])

    @property
    def kv_first(self) -> bool:
        """Whether this rank is the first of its kv-heads' holders."""
        return self.kv_holders == 1 or \
            self.q_heads[0] % (self.cfg.n_heads // self.cfg.n_kv_heads) == 0

    # -- placement ---------------------------------------------------------
    def ranges(self, path) -> Dict[int, Tuple[Tuple[int, int], ...]]:
        """{dim: this rank's [lo, hi) intervals, in global order} of the
        weight at ``path`` (its keys joined by ``/``, or a tuple of them:
        ``'layers/wq'``, ``'shared/wq'``, ``'embed'``); {} is replicated.
        The table is the family's (rwkv6's and zamba2's from their model
        modules): one interval a dimension but for zamba2's packed
        ``in_proj`` / ``conv_w`` / ``conv_b`` (the module docstring of
        ``models/zamba2.py``)."""
        keys = tuple(path.split('/')) if isinstance(path, str) else \
            tuple(path)
        fam = self.cfg.family
        if self.placement == KV_DP and keys[-1] in HEAD_LEAVES and \
                fam in ('ssm', 'hybrid'):
            # kv_dp replicates the leaves on the 'heads' axis: the
            # recurrences run every head on every rank
            return {}
        table = (self._ssm_ranges() if fam == 'ssm' else
                 self._hybrid_ranges(keys[0]) if fam == 'hybrid' else
                 self._attn_ranges())
        return {dim: iv if isinstance(iv[0], tuple) else (iv,)
                for dim, iv in table.get(keys[-1], {}).items()}

    def _attn_ranges(self):
        """dense, vlm, moe and encdec (whose cross-attention leaves are
        the self-attention's with an ``x`` in front)."""
        hd = self.cfg.hd
        if self.pair_cut:
            q = self._pair_columns(self.cfg.n_heads)
            kv = self._pair_columns(self.cfg.n_kv_heads)
        else:
            q = (self.q_heads[0] * hd, self.q_heads[1] * hd)
            kv = (self.kv_heads[0] * hd, self.kv_heads[1] * hd)
        ex, ef, sf = self.experts, self.expert_ffn, self.shared_ffn
        up = {1: ex} if self.expert_split else {3: ef}
        attn = {'wq': {2: q}, 'bq': {1: q}, 'wo': {1: q},
                'wk': {2: kv}, 'wv': {2: kv}, 'bk': {1: kv}, 'bv': {1: kv}}
        if self.norms_cut:
            attn.update(dict.fromkeys(('q_norm', 'k_norm'),
                                      {1: self.head_dim}))
        return {
            **self._head_ranges(), **attn,
            **({'x' + k: v for k, v in attn.items()}
               if self.cfg.family == 'encdec' else {}),
            'wg': {2: self.ffn}, 'wu': {2: self.ffn}, 'wd': {1: self.ffn},
            'router': {2: ex}, 'we_gate': up, 'we_up': up,
            'we_down': {1: ex} if self.expert_split else {2: ef},
            'ws_gate': {2: sf}, 'ws_up': {2: sf}, 'ws_down': {1: sf},
        }

    def pair_channels(self) -> Tuple[Tuple[int, int], Tuple[int, int]]:
        """This rank's channels of a head's head_dim under :attr:`pair_cut`:
        its RoPE pairs [lo, hi) and [Dh/2 + lo, Dh/2 + hi)."""
        (lo, hi), half = self.pairs, self.cfg.hd // 2
        return (lo, hi), (half + lo, half + hi)

    def _pair_columns(self, heads: int):
        """This rank's columns of a flattened (heads x Dh) width under
        :attr:`pair_cut`: its channels of every head, in global order."""
        hd = self.cfg.hd
        return tuple((h * hd + lo, h * hd + hi) for h in range(heads)
                     for lo, hi in self.pair_channels())

    def _head_ranges(self):
        """The embedding and the head (V, D): by vocabulary, or by d_model
        (:attr:`embed_cut`)."""
        cut = {1: self.embed_cols} if self.embed_cut else {0: self.vocab}
        return {'embed': cut, 'unembed': cut}

    def _ssm_ranges(self):
        """rwkv6: its table (``models.rwkv6.placement``), the embedding and
        the head."""
        from repro_torch.models import rwkv6

        return {**self._head_ranges(), **rwkv6.placement(self)}

    def _hybrid_ranges(self, group: str):
        """zamba2: its table for ``group`` (``models.zamba2.placement``),
        the embedding (the tied head)."""
        from repro_torch.models import zamba2

        table = zamba2.placement(
            self.cfg, group, self.mamba if self.mamba_split else None,
            self.mamba_state, self.shared_heads, self.hybrid_ffn)
        if group == 'shared':
            return table
        return {**self._head_ranges(), **table}

    def block(self, path, shape) -> Block:
        """This rank's :class:`Block` of the global weight ``path`` of
        ``shape``."""
        b = Block.whole(shape)
        for dim, intervals in self.ranges(path).items():
            b = b.select(dim, intervals)
        return b

    def duplicate(self, path) -> bool:
        """Whether this rank's block of ``path`` is a kv-head block that a
        lower rank of :attr:`kv_group` holds too (it counts it once)."""
        name = path.split('/')[-1] if isinstance(path, str) else path[-1]
        return (self.kv_holders > 1 and not self.kv_first
                and name.removeprefix('x') in KV_LEAVES)

    def shard(self, path, full):
        """This rank's block of the global weight ``full`` at ``path`` (a
        tensor or a numpy array; a view but for a packed leaf)."""
        return self.block(path, full.shape).take(full)

    def shard_params(self, params) -> nn.ParameterDict:
        """The global weights cut to this rank's blocks, on the mesh's
        device (copies where cut or moved, so no block keeps the global
        weight's storage alive; the weights may lie on the host)."""
        def build(node, path):
            if isinstance(node, (dict, nn.ParameterDict)):
                return nn.ParameterDict({k: build(v, path + (k,))
                                         for k, v in node.items()})
            part = self.shard(path, node.detach())
            return nn.Parameter(part.to(
                self.mesh.device, memory_format=torch.contiguous_format,
                copy=part.shape != node.shape), requires_grad=False)
        return build(params, ())

    def holds_blocks(self, params, shapes) -> bool:
        """Whether ``params`` are this rank's blocks already (every leaf at
        its block's shape, some leaf cut) rather than the global weights
        (every leaf at its shape in ``shapes``, ``Model.param_shapes()``);
        raises where they are neither."""
        local = whole = True
        for path, w in _leaves(params):
            shape = shapes
            for k in path:
                shape = shape[k]
            local &= tuple(w.shape) == tuple(self.block(path,
                                                        shape).local_shape)
            whole &= tuple(w.shape) == tuple(shape)
        if not (local or whole):
            raise ValueError('weights neither global nor this rank\'s '
                             'blocks')
        return not whole

    def pool_block(self, shape) -> Block:
        """This rank's :class:`Block` of a leaf of the engine's global
        paged pool (L, P, pg, Hkv, Dh) (the reference engine's
        ``tree_spec_shaped`` block): its kv-heads, or under
        :attr:`pair_cut` its RoPE pairs of every kv-head."""
        b = Block.whole(shape)
        if self.pair_cut:
            return b.select(4, self.pair_channels())
        return b.narrow(3, *self.kv_heads)

    def init_cache(self, n_pages: int, device, dtype):
        """This rank's block of the global paged pool
        (:meth:`pool_block`)."""
        c = self.cfg
        shape = self.pool_block((c.n_layers, n_pages, c.page_size,
                                 c.n_kv_heads, c.hd)).local_shape
        return {k: torch.zeros(shape, dtype=dtype, device=device)
                for k in ('k', 'v')}

    # -- the forward's collectives -----------------------------------------
    def reduce_sum(self, part: torch.Tensor, dtype) -> torch.Tensor:
        """The sum of every rank's f32 ``part`` (reduced in place; under
        autograd a copy, with an identity backward), rounded once to
        ``dtype``: the same bits on every rank."""
        if _traced(part):
            return _ReduceFromModel.apply(part, self.group).to(dtype)
        torch.distributed.all_reduce(part, group=self.group)
        return part.to(dtype)

    def reduce_max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max over the ranks of ``x`` (no gradient: it
        only steadies a softmax), reduced in place."""
        torch.distributed.all_reduce(x, op=torch.distributed.ReduceOp.MAX,
                                     group=self.group)
        return x

    def copy(self, x: torch.Tensor, split: bool = True) -> torch.Tensor:
        """``x``, replicated over the ranks, as the input of a product by
        this rank's block (``split``): under autograd its gradient is
        summed over the ranks; otherwise ``x`` itself."""
        if not split or self.n == 1 or not _traced(x):
            return x
        return _CopyToModel.apply(x, self.group)

    def norm_sum(self, part: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of each rank's f32 ``part`` of a norm's
        statistic, which every rank then applies to its own block (reduced
        in place; under autograd :class:`_SumOverModel`, whose backward
        sums the ranks' gradients too)."""
        if _traced(part):
            return _SumOverModel.apply(part, self.group)
        torch.distributed.all_reduce(part, group=self.group)
        return part

    def gather_shares(self, part: torch.Tensor) -> torch.Tensor:
        """Every rank's block of the last dimension, gathered in rank
        order, for a computation that each rank then runs over its own
        block (zamba2's B and C, read by each rank's heads): under autograd
        the gradient is summed over the ranks and this rank's block kept,
        a reduce-scatter (:class:`_CopyToModel` after
        :class:`_GatherFromModel`)."""
        if _traced(part):
            return _CopyToModel.apply(
                _GatherFromModel.apply(part, self.group, self.rank),
                self.group)
        return _gather_last(part, self.group)

    def whole(self, part: torch.Tensor) -> torch.Tensor:
        """A leaf cut on its last dimension over ``model`` (``serve_dh``'s
        q/k norms, rwkv6's ``u`` on K: :attr:`norms_cut`, :attr:`u_dim`),
        every rank's block gathered in rank order, for a computation every
        rank runs whole: under autograd the backward keeps this rank's
        block of the gradient, which every rank holds whole
        (:class:`_GatherFromModel`; no sum)."""
        if _traced(part):
            return _GatherFromModel.apply(part, self.group, self.rank)
        return _gather_last(part, self.group)

    def whole_pairs(self, part: torch.Tensor) -> torch.Tensor:
        """(..., 2w) this rank's RoPE pairs of every head (:attr:`pair_cut`)
        -> (..., Dh), every rank's gathered in channel order, for a
        computation every rank runs on whole heads: under autograd the
        backward keeps this rank's block of the gradient (:meth:`whole`;
        the computation's output enters ``wo`` through :meth:`own_pairs`,
        whose backward gathers its gradient whole)."""
        return self.whole(part.unflatten(-1, (2, -1))).flatten(-2)

    def own_pairs(self, x: torch.Tensor) -> torch.Tensor:
        """(..., Dh) whole heads, the same on every rank -> (..., 2w) this
        rank's RoPE pairs of each (:attr:`pair_cut`): under autograd the
        backward gathers every rank's block of the gradient
        (:class:`_SplitToModel`), so the computation before it, run whole
        on every rank, gets the whole gradient."""
        pairs = x.unflatten(-1, (2, -1))
        if _traced(x):
            pairs = _SplitToModel.apply(pairs, self.group, self.rank, self.n)
        else:
            pairs = pairs[..., self.pairs[0]:self.pairs[1]]
        return pairs.flatten(-2)

    def pair_norm(self, x: torch.Tensor, w: torch.Tensor, eps: float):
        """``models.common.rms_norm`` of each head over all of Dh, x (...,
        2w) this rank's RoPE pairs of it (:attr:`pair_cut`) and ``w`` (Dh,)
        whole: the f32 sum of squares summed over ``model``
        (:meth:`norm_sum`), then this rank's channels scaled."""
        xf = x.float()
        total = self.norm_sum((xf * xf).sum(-1, keepdim=True))
        lo, hi = self.pairs
        g = w.unflatten(-1, (2, -1))[..., lo:hi].flatten(-2)
        return (xf * torch.rsqrt(total / self.cfg.hd + eps)
                * g.float()).to(x.dtype)

    def head_share(self, w: torch.Tensor) -> torch.Tensor:
        """A leaf replicated over ``model`` that this rank's computation
        reads for its own heads only (``serve_kv_dp``'s rwkv6 ``u`` and
        zamba2 ``A_log`` / ``dt_bias`` / ``D``, every head run, the
        rank's kept): under autograd its gradient is summed over ``model``
        (:class:`_CopyToModel`); otherwise ``w``."""
        return self.copy(w)

    def attn_weights(self, lp):
        """A layer's attention weights for a forward over this rank's
        heads: under ``serve_dh`` the q/k norms' head_dim blocks gathered
        whole (:meth:`whole`); under autograd each weight passed through
        :class:`_CopyToModel` where its gradient here covers only part of
        what uses it: the q/k norms (one vector for every head) over the
        ``model`` ranks, and where this rank's kv-heads are replicated,
        ``wk``/``wv``/``bk``/``bv`` over :attr:`kv_group` (their holders'
        q-heads together read them)."""
        if self.norms_cut and 'q_norm' in lp:
            lp = dict(lp, q_norm=self.whole(lp['q_norm']),
                      k_norm=self.whole(lp['k_norm']))
        if not self.attn_split or not _traced(lp['wq']):
            return lp
        groups = {'q_norm': self.group, 'k_norm': self.group}
        if self.kv_holders > 1:
            groups.update(dict.fromkeys(('wk', 'wv', 'bk', 'bv'),
                                        self.kv_group))
        return {k: _CopyToModel.apply(w, groups[k]) if k in groups else w
                for k, w in lp.items()}

    def row_parallel(self, x, w, split: bool):
        """``x @ w`` where ``w`` is this rank's row block of the full weight
        (``split``) or the full weight: the partial product in f32, summed
        over the ranks."""
        if not split or self.n == 1:
            return x @ w
        return self.reduce_sum(f32_product(x, w), x.dtype)

    def embed(self, table, tokens):
        """Vocab-parallel lookup: each rank looks up the tokens in its rows
        (zeros elsewhere), and the sum has one nonzero term a row: exact.
        Under :attr:`embed_cut` each rank looks up its columns of every
        row, gathered whole (:meth:`embed_gather`)."""
        tokens = tokens.long()
        if self.embed_cut:
            return self.embed_gather(table[tokens])
        lo, hi = self.vocab
        if self.n == 1 or (lo, hi) == (0, self.cfg.vocab_size):
            return table[tokens]
        local = tokens - lo
        inside = (local >= 0) & (local < hi - lo)
        h = table[local.clamp(0, hi - lo - 1)]
        return self.reduce_sum(torch.where(inside[..., None], h.float(), 0.0),
                               table.dtype)

    def embed_gather(self, part: torch.Tensor) -> torch.Tensor:
        """(..., d/n) this rank's columns of the embedded rows -> (..., d),
        every rank's gathered in rank order: the residual after it is the
        same on every rank, so under autograd the backward keeps this
        rank's block of a gradient every rank holds whole (:meth:`whole`;
        a sum would count it n times)."""
        return self.whole(part)

    def own_cols(self, x: torch.Tensor) -> torch.Tensor:
        """(..., d) the same on every rank -> (..., d/n) this rank's columns
        of d_model (:attr:`embed_cut`): under autograd the backward gathers
        every rank's block of the gradient (:class:`_SplitToModel`)."""
        if _traced(x):
            return _SplitToModel.apply(x, self.group, self.rank, self.n)
        return x[..., self.embed_cols[0]:self.embed_cols[1]]

    def head_sum(self, part: torch.Tensor, dtype=torch.float32):
        """Every rank's f32 partial product over its columns of d_model
        (the head under :attr:`embed_cut`), summed over ``model`` and
        rounded once to ``dtype`` (:meth:`reduce_sum`)."""
        return self.reduce_sum(part, dtype)

    def column_logits(self, x: torch.Tensor, head: torch.Tensor):
        """x (..., d) the same on every rank, ``head`` (V, d/n) this rank's
        columns of d_model (:attr:`embed_cut`) -> the logits (..., V) in
        x's dtype: the f32 partial product over the rank's columns summed
        over ``model`` (:meth:`head_sum`), rounded once, as the meshless
        ``x @ head.T`` rounds its f32 accumulation once."""
        return self.head_sum(f32_product(self.own_cols(x), head.T), x.dtype)

    def scores(self, last: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
        """The head's f32 scores of ``last`` (B, D): ``head`` (V, D) this
        rank's vocabulary block, or whole, or under :attr:`embed_cut` its
        columns of d_model, whose partial scores are summed over ``model``
        (every rank then holds every column)."""
        if not self.embed_cut:
            return unembed_scores(last, head)
        return self.head_sum(unembed_scores(self.own_cols(last), head))

    def value_norm(self, y: torch.Tensor, width: int, eps: float):
        """``models.common.rms_norm`` of each head over its ``width``
        channels, y (..., w) this rank's block of them (rwkv6's group norm
        under ``WKV_VALUES``) and no weight: the f32 sum of squares summed
        over ``model`` (:meth:`norm_sum`), then this rank's channels
        scaled."""
        yf = y.float()
        total = self.norm_sum((yf * yf).sum(-1, keepdim=True))
        return (yf * torch.rsqrt(total / width + eps)).to(y.dtype)

    def gather_vocab(self, scores):
        """(B, V/n) blocks of scores -> (B, V), blocks in rank order."""
        if self.n == 1 or self.vocab == (0, self.cfg.vocab_size):
            return scores
        return _gather_last(scores, self.group)

    def gather_experts(self, logits):
        """(N, E/n) router logits of this rank's experts -> (N, E), blocks
        in rank order; under autograd the gradient keeps this rank's
        block (:class:`_GatherFromModel`)."""
        if not self.expert_split:
            return logits
        if _traced(logits):
            return _GatherFromModel.apply(logits, self.group, self.rank)
        return _gather_last(logits, self.group)

    def combine_argmax(self, value, index):
        """Each rank's best (B,) (value, global column) of its vocabulary
        block -> the (B,) int32 columns of the best over every rank: the
        larger value, ties to the lower column (blocks lie in rank order,
        so that is the first occurrence over the whole head).  Every rank
        gets the same columns."""
        if not self.vocab_split:
            return index
        b = value.shape[0]
        vals = value.new_empty((self.n * b,))
        idxs = index.new_empty((self.n * b,))
        torch.distributed.all_gather_into_tensor(vals, value.contiguous(),
                                                 group=self.group)
        torch.distributed.all_gather_into_tensor(idxs, index.contiguous(),
                                                 group=self.group)
        return combine_bests(vals.view(self.n, b), idxs.view(self.n, b))

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows (:attr:`rows`) of a dispatch -> every row,
        gathered over the batch axes in rank order; ``x`` itself where the
        rows are not split."""
        if not self.split_rows:
            return x
        x = x.contiguous()
        out = x.new_empty((self.n_batch * x.shape[0],) + tuple(x.shape[1:]))
        torch.distributed.all_gather_into_tensor(out, x,
                                                 group=self.batch_group)
        return out

    def local(self, x):
        """This rank's rows of a dispatch's per-row tensor (or None)."""
        return x if x is None or not self.split_rows else x[self.rows]

    def pool_kv(self, k: torch.Tensor, kind: str = 'kv') -> torch.Tensor:
        """The part of new K/V that this rank's pool block takes: here all
        of ``k``, its own kv-heads (:meth:`StepParallel.pool_kv`)."""
        return k

    # -- attention over a block of head_dim ---------------------------------
    def paged_read(self, q, pool_k, pool_v, page_table, q_positions, kv_len,
                   kinds: Tuple[str, str] = ('q', 'kv')) -> torch.Tensor:
        """Attention of q (B, Sq, h, Dh), this rank's q heads (under
        :attr:`pair_cut` its RoPE pairs of every head; ``dh``: every
        head), over the K/V its pool block holds through the page table
        (the engine's global pool and physical ids, or a serve step's
        region pool and region-local ids), causal to ``q_positions`` (B,
        Sq) and below ``kv_len`` (B,) -> (B, Sq, h, Dh) in q's dtype, the
        same heads (under the pair cut the rank's pairs, P V over them:
        :meth:`dh_attention`).  ``kinds``: the q and kv heads' kinds, which
        :class:`StepParallel`'s variants read."""
        k = cm.kv_gather(pool_k, page_table)
        v = cm.kv_gather(pool_v, page_table)
        if self.placement == DH or self.pair_cut:
            return self.dh_attention(q, k, v, cm.kv_mask(k.shape[1],
                                                         q_positions, kv_len))
        kv_pos = torch.arange(k.shape[1], device=q.device).expand(
            k.shape[0], -1)
        return cm.attention(q, k, v, q_positions=q_positions,
                            kv_positions=kv_pos,
                            kv_valid=kv_pos < kv_len.long()[:, None])

    def score_sum(self, scores: torch.Tensor) -> torch.Tensor:
        """The f32 partial scores of every rank's head_dim block, summed
        over ``model`` (in place): the same bits on every rank."""
        torch.distributed.all_reduce(scores, group=self.group)
        return scores

    def dh_attention(self, q, k, v, mask) -> torch.Tensor:
        """q (B, Sq, H, Dh), every head; k/v (B, S, Hkv, Dh/n) this rank's
        head_dim block; ``mask`` (B, Sq, S) -> (B, Sq, H, Dh) in q's dtype,
        the same on every rank: the f32 partial scores summed over
        ``model`` (:meth:`score_sum`), the softmax, P V over the block
        gathered in rank order (``models.common.attention_dh_block``).
        Under :attr:`pair_cut` q and k/v are this rank's RoPE pairs of
        every head, and so is the output (B, Sq, H, Dh/n), P V over them,
        which enters ``wo`` as the rank's rows: nothing is gathered."""
        if self.pair_cut:
            return cm.attention_dh_block(q, k, v, mask, self.cfg.hd,
                                         self.score_sum).to(q.dtype)
        lo, hi = self.head_dim
        if not self.dh_split:
            return cm.attention_dh_block(q, k, v, mask, q.shape[-1],
                                         lambda s: s).to(q.dtype)
        out = cm.attention_dh_block(q[..., lo:hi], k, v, mask, q.shape[-1],
                                    self.score_sum)
        return _gather_last(out, self.group).to(q.dtype)


class StepParallel(TensorParallel):
    """A serve step's plan (``training/train_step.py::make_serve_step``):
    the step is given this rank's blocks only -- its rows of the call's
    ``batch`` rows over the batch axes (:attr:`rows`; every row where they
    do not divide it, or where ``rules`` replicate the batch), its blocks
    of the cache (:meth:`cache_block`), its weight blocks -- and returns its
    rows' block of the scores over its vocabulary block.  So nothing is
    gathered over the vocabulary, and the K/V a rank writes into a
    per-row cache are its own rows', into its own rows' regions.  MoE
    still routes the whole call (:attr:`data`), as GSPMD does.

    encdec's decoder pool has no batch dimension (the reference's): it is
    one pool replicated over the batch axes (:attr:`shared_pool`), so
    every replica writes every row's K/V: the decoder's new K/V rows, page
    table and positions are gathered over the batch axes before the write
    (:meth:`gather_rows`), as the engine's data-parallel plan does.

    ``rules`` (``SERVE_RULES`` by default) say where the rows, the
    attention's heads and pool, and a long context's KV sequence lie
    (:attr:`placement`, :func:`attention_placement`):

    - ``heads`` (``SERVE_RULES``, ``LONG_SERVE_RULES``): the training
      placement; ``LONG_SERVE_RULES`` (long_500k) replicate the rows and
      split the ``kv_seq`` dimension of zamba2's contiguous KV over the
      batch axes (:attr:`seq`, of ``seq_len`` slots) in rank-order blocks;
      each rank attends over its own slots and the partial softmax states
      are combined in rank order (:meth:`seq_attention`);
    - ``kv_dp`` (``SERVE_KV_DP_RULES``): the weights as ``heads``, the
      pool (and rwkv6's ``wkv``, zamba2's ``ssm`` state, ``u``,
      ``A_log``, ``dt_bias``, ``D``) replicated over ``model``: the new
      K/V heads are gathered over ``model`` and every replica writes them
      all (:meth:`pool_kv`); a rank attends its q heads over its kv-heads
      of the pool, with no collective (:meth:`paged_read`);
    - ``seq`` (``SERVE_SEQ_RULES``): the weights as ``heads``, the pool's
      pages (a long context's ``kv_seq``) over ``model`` in rank-order
      blocks (:attr:`held`, :attr:`seq`) with every head: q and the new
      K/V are gathered into whole heads, the rank holding a page writes
      it, each rank attends every head over its pages and the f32 states
      are combined in rank order over ``model`` (:meth:`model_combine`);
      the rank takes its heads into the row-parallel ``wo``;
    - ``dh`` (``SERVE_DH_CONTRACT_RULES``): attention's projections (and
      rwkv6's time mix, zamba2's Mamba layers) replicated, the pool (and
      encdec's cross K/V) on ``head_dim`` (:attr:`head_dim`): a rank
      writes its head_dim block of K/V, its f32 partial scores are summed
      over ``model`` before the softmax, and P V over its block is
      gathered into whole heads (:meth:`dh_attention`); ``wo`` is
      replicated.  The q/k norms and rwkv6's ``u`` are the reference's
      head_dim blocks, gathered whole before use (RoPE pairs channel i
      with i + Dh/2, and the norms reduce over all of Dh).

    A row that no batch axis divides (long_500k's one row under a
    variant, whose rules put the rows on the batch axes: :attr:`moved`)
    is computed on every rank, and each cache leaf of rwkv6 and zamba2
    (the recurrent states, the long context's contiguous KV) is the block
    of the reference's spec (``shaped_spec`` moves the freed batch axes --
    and ``model`` where it divides nothing else -- onto the last dimension
    each divides, the layers too; :meth:`moved_block`).  A layer gathers
    its state's blocks over the axes that cut them, runs as it would on
    the replicated row (:meth:`compute_block`), gathers the computed
    blocks over ``model`` where they are not the held ones, and writes
    back its own block (:meth:`layer_state`, :meth:`put_layer_state`);
    the long KV never moves: a rank's partial scores over its head_dim
    channels are summed over the axes that cut head_dim, its softmax
    state over its slots is combined with the others' in block order, and
    the output's head and channel blocks are gathered
    (:meth:`long_attention`).  Each of those collectives is a method of
    its own (:meth:`state_gather`, :meth:`state_share`,
    :meth:`head_dim_sum`, :meth:`seq_combine`, :meth:`output_gather`).
    The weights stay as the variant places them.

    The weights' placement is :class:`TensorParallel`'s under the same
    rules (the trainer's plan reads it too); this class adds the rows,
    the pool and the long context."""

    def __init__(self, cfg, mesh, coords: Optional[Dict[str, int]] = None,
                 *, batch: int, seq_len: int = 0, rules=None):
        rules = SERVE_RULES if rules is None else rules
        super().__init__(cfg, mesh, coords, max_batch=batch, rules=rules)
        if rules.get('batch') != SERVE_RULES['batch']:
            self.rows, self.split_rows = slice(0, batch), False
        self.shared_pool = cfg.family == 'encdec'
        hybrid = cfg.family == 'hybrid'
        # seq: a rank's block of the region slots (encdec's pool pages)
        pages = region_pages(cfg, seq_len)
        self.page_split = (self.placement == SEQ and self.n > 1
                           and pages % self.n == 0)
        self.held = (block(pages, self.n, self.rank)[0], pages) \
            if self.page_split else None
        # a long context's contiguous KV (zamba2's): split over the batch
        # axes (LONG_SERVE_RULES) or over model (serve_seq)
        over = rules.get('kv_seq')
        self.seq_over = (MODEL if over == MODEL else
                         'batch' if over == SERVE_RULES['batch'] else None)
        parts = self.n if self.seq_over == MODEL else self.n_batch
        index = self.rank if self.seq_over == MODEL else self.batch_index
        self.seq_split = (self.seq_over is not None and hybrid and parts > 1
                          and seq_len > 0 and seq_len % parts == 0)
        self.seq = (block(seq_len, parts, index) if self.seq_split
                    else (0, seq_len))
        # rows that no batch axis divides (long_500k's one row under a
        # serving variant): the reference's shaped_spec moves the freed
        # axes onto the recurrent states and the long KV, and so does this
        # plan (the class docstring)
        self.batch, self.seq_len = batch, seq_len
        self.moved = (cfg.family in ('ssm', 'hybrid')
                      and rules.get('batch') == SERVE_RULES['batch']
                      and self.n_batch > 1
                      and not shaped_spec((batch,), ('batch',), rules, mesh))
        self._specs = self._moved_specs() if self.moved else {}
        self._peers: Dict[int, 'StepParallel'] = {}
        self._state_plans: Dict[Tuple[str, ...], tuple] = {}

    def local(self, x):
        return super().local(x) if self.shared_pool else x

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        return super().gather_rows(x) if self.shared_pool else x

    def gather_vocab(self, scores):
        return scores

    # -- placement ---------------------------------------------------------
    def cache_block(self, path, shape) -> Block:
        """This rank's :class:`Block` of the cache leaf ``path`` (a tuple
        of keys: ``('k',)``, ``('mamba', 'conv')``) of global ``shape``:
        where the rows are :attr:`moved`, a recurrent state's and the long
        KV's block of the reference's spec (:meth:`moved_block`), else
        :meth:`compute_block`."""
        keys = _keys(path)
        if keys in self._specs and tuple(shape) == self._specs[keys][0]:
            return self.moved_block(keys)
        return self.compute_block(keys, shape)

    def compute_block(self, path, shape) -> Block:
        """The :class:`Block` of the cache leaf ``path`` that the rank's
        layers read and write (the one it holds, unless the rows are
        :attr:`moved`), following its weight blocks (:meth:`ranges`) and
        the placement:

        - dense, vlm, moe: the region pool (L, B, R, pg, Hkv, Dh), its
          rows and its kv-heads (``kv_dp``: every head; ``seq``: its block
          of R, every head; ``dh``: its block of Dh, every head);
        - ssm: ``wkv`` (L, B, H, K, V) its rows and wkv heads, or where
          ``model`` does not divide them its value channels of every head
          (``kv_dp``, ``dh``: the whole state), ``shift_tm`` / ``shift_cm``
          (L, B, D) its rows;
        - hybrid: ``mamba/conv`` (L, B, K-1, C) its rows and its conv
          channels (its heads' x and its share of B's and C's), ``mamba/
          ssm`` (L, B, H, P, N) its rows and its heads, N whole; ``attn``
          its rows and the shared block's heads of the region pool (apps,
          B, R, pg, AH, AHD), or of the contiguous KV (apps, B, S, AH,
          AHD) with its block :attr:`seq` of S, as the pool above;
        - encdec: the pool (Ld, R, pg, Hkv, Dh) as the pool above with no
          rows, ``cross_k`` / ``cross_v`` (Ld, B, S_enc, Hkv, Dh) its rows
          and kv-heads (``kv_dp``: every head; ``dh``: its block of
          Dh)."""
        keys = _keys(path)
        name, fam = keys[-1], self.cfg.family
        b = Block.whole(shape)
        if self.shared_pool and name in ('k', 'v'):
            return self._pool_block(b, 1, self.kv_heads)
        b = b.narrow(1, self.rows.start, self.rows.stop)
        if fam == 'ssm':
            hd = self.cfg.ssm_head_dim
            if name != 'wkv' or self.wkv_mode not in (WKV_HEADS, WKV_VALUES):
                return b
            return (b.narrow(2, self.wkv[0] // hd, self.wkv[1] // hd)
                    if self.wkv_mode == WKV_HEADS
                    else b.narrow(4, *self.values))
        if fam == 'encdec':
            return self._pool_block(b, None, self.kv_heads)
        if fam != 'hybrid':
            return self._pool_block(b, 2, self.kv_heads)
        if name == 'conv':
            return _select(b, 3, self.ranges('layers/conv_w').get(2))
        if name == 'ssm':
            return _select(b, 2, self.ranges('layers/A_log').get(1))
        heads = self.own('shared')
        if len(shape) == 5:                  # the contiguous long KV
            b = b.narrow(2, *self.seq)
            return b if self.placement == SEQ else \
                self._pool_block(b, None, heads)
        return self._pool_block(b, 2, heads)

    def _pool_block(self, b: Block, pages: Optional[int], heads) -> Block:
        """A K/V leaf's block whose last two dimensions are (heads, head
        dim) and whose dimension ``pages`` holds the pages (None: a leaf
        with no pages, encdec's cross K/V)."""
        nd = len(b.shape)
        if self.placement == DH:
            return b.narrow(nd - 1, *self.head_dim)
        if self.placement == KV_DP:
            return b
        if self.placement == SEQ and pages is not None:
            if self.held is None:
                return b
            lo = self.held[0]
            return b.narrow(pages, lo, lo + self.held[1] // self.n)
        if self.pair_cut:
            return b.select(nd - 1, self.pair_channels())
        return b.narrow(nd - 2, *heads)

    def shard_cache(self, cache):
        """This rank's blocks of a global cache (copies on the mesh's
        device), nested as it is."""
        def build(node, path):
            if isinstance(node, dict):
                return {k: build(v, path + (k,)) for k, v in node.items()}
            return self.cache_block(path, node.shape).take(node).to(
                self.mesh.device, copy=True).contiguous()
        return build(cache, ())

    def shard_batch(self, batch):
        """This rank's rows of a serve step's batch (tensors, on the mesh's
        device)."""
        return {k: v[self.rows].to(self.mesh.device) for k, v in batch.items()}

    # -- a row that no batch axis divides ----------------------------------
    def _moved_specs(self) -> Dict[Tuple[str, ...], Tuple[Tuple[int, ...],
                                                          tuple]]:
        """{leaf keys: (global shape, the reference's spec)} of the cache
        leaves that a :attr:`moved` plan holds by the spec: ssm's every
        leaf, hybrid's Mamba states and its long context's contiguous KV
        (``seq_len`` slots; a paged pool keeps :meth:`compute_block`)."""
        from repro_torch.models import rwkv6, zamba2

        cfg, b = self.cfg, self.batch
        if cfg.family == 'ssm':
            tmpl = rwkv6.cache_template(cfg, b)
        else:
            tmpl = {'mamba': zamba2.mamba_cache_template(cfg, b)}
            if self.seq_len:
                tmpl['attn'] = zamba2.attn_cache_template_dense(
                    cfg, b, self.seq_len)
        out = {}
        for keys, leaf in _template_items(tmpl):
            spec = shaped_spec(leaf.shape, leaf.axes, self.rules, self.mesh)
            if keys[0] == 'attn' and (_entry(spec, 0) or _entry(spec, 1)):
                raise NotImplementedError(
                    f'the long KV\'s spec {spec} cuts its layers or rows')
            out[keys] = (tuple(leaf.shape), spec)
        return out

    def moved_block(self, keys, coords: Optional[Dict[str, int]] = None
                    ) -> Block:
        """The block of the leaf ``keys`` under the reference's spec that
        rank ``coords`` (this one's by default) holds."""
        shape, spec = self._specs[keys]
        return local_bounds(shape, spec, self.mesh,
                            self.coords if coords is None else coords)

    def written_block(self, keys) -> Block:
        """The block of a state leaf that :meth:`put_layer_state` writes
        into this rank's cache: its own."""
        return self.moved_block(keys)

    def peer(self, r: int) -> 'StepParallel':
        """The plan of ``model`` rank ``r`` beside this one (no groups)."""
        if r not in self._peers:
            self._peers[r] = StepParallel(
                self.cfg, self.mesh, dict(self.coords, **{MODEL: r}),
                batch=self.batch, seq_len=self.seq_len, rules=self.rules)
        return self._peers[r]

    def _over(self, spec, dims) -> Tuple[str, ...]:
        """The mesh axes of more than one rank that ``spec`` names on
        ``dims``, in the mesh's order."""
        named = {a for d in dims for a in _entry(spec, d)}
        return tuple(a for a in self.mesh.axis_names
                     if a in named and self.mesh.shape[a] > 1)

    def _state_plan(self, keys):
        """(the axes a layer's state is gathered over before the layer,
        whether the layer's new block is gathered over ``model`` after it)
        of the moved state leaf ``keys``.  Where ``model`` cuts the held
        block as it cuts the computed one (zamba2's ``ssm`` heads under
        ``serve_seq``), neither gathers over it."""
        if keys not in self._state_plans:
            shape, spec = self._specs[keys]
            held = self.moved_block(keys)
            comp = self.compute_block(keys, shape)
            axes = self._over(spec, range(len(shape)))
            cut = [d for d in range(1, len(shape))
                   if comp.intervals(d) != ((0, shape[d]),)]
            aligned = (MODEL in axes and len(cut) == 1
                       and _entry(spec, cut[0]) == (MODEL,)
                       and comp.intervals(cut[0]) == held.intervals(cut[0]))
            if aligned:
                axes = tuple(a for a in axes if a != MODEL)
            self._state_plans[keys] = (axes, bool(cut) and not aligned)
        return self._state_plans[keys]

    def layer_state(self, path, leaf: torch.Tensor, i: int) -> torch.Tensor:
        """Layer ``i``'s state of the :attr:`moved` cache leaf ``path`` as
        the layer reads it (:meth:`compute_block`): the rank holds its
        block of the reference's spec, so the layer's blocks are gathered
        over the axes that cut them (the ranks that do not hold layer
        ``i`` send zeros, which nothing reads) and its computed block
        taken."""
        keys = _keys(path)
        shape, spec = self._specs[keys]
        axes, _ = self._state_plan(keys)
        (lo, hi), = self.moved_block(keys).intervals(0)
        piece = leaf[i - lo] if lo <= i < hi else \
            leaf.new_zeros(leaf.shape[1:])
        if axes:
            parts = self.state_gather(piece, axes)
            size = self.mesh.shape
            lay = [a for a in _entry(spec, 0) if a in axes]
            if lay:
                # the layer's holder among the ranks that cut the layers
                idx = i // (shape[0] // int(np.prod([size[a] for a in lay])))
                at = {}
                for a in reversed(lay):
                    idx, at[a] = divmod(idx, size[a])
                parts = parts[tuple(at.get(a, slice(None)) for a in axes)]
            rest = [a for a in axes if a not in lay]
            piece = unshard(parts, [size[a] for a in rest], [
                tuple(rest.index(a) for a in _entry(spec, d) if a in rest)
                for d in range(1, len(shape))])
        spec_left = tuple(tuple(a for a in _entry(spec, d) if a not in axes)
                          or None for d in range(len(spec)))
        outer = local_bounds(shape, spec_left, self.mesh, self.coords)
        return _within(self.compute_block(keys, shape), outer).take(piece)

    def put_layer_state(self, path, leaf: torch.Tensor, i: int,
                        new: torch.Tensor) -> None:
        """Write layer ``i``'s new state ``new`` (the layer's computed
        block) into the :attr:`moved` cache leaf ``leaf``: only this
        rank's block of the reference's spec, and only if it holds layer
        ``i``, the computed blocks gathered over ``model`` first where they
        are not the held ones."""
        keys = _keys(path)
        shape, _ = self._specs[keys]
        _, gather = self._state_plan(keys)
        outer = self.compute_block(keys, shape)
        if gather:
            parts = self.state_share(new)
            whole = new.new_empty(shape[1:])
            for r in range(self.n):
                for b, at in self.peer(r).compute_block(keys, shape).pieces():
                    whole[tuple(slice(*b.intervals(d)[0])
                                for d in range(1, len(shape)))] = \
                        parts[r][at[1:]]
            new, outer = whole, Block.whole(shape)
        held = self.written_block(keys)
        (lo, hi), = held.intervals(0)
        if lo <= i < hi:
            leaf[i - lo].copy_(_within(held, outer).take(new))

    def state_gather(self, piece: torch.Tensor, axes) -> torch.Tensor:
        """A layer's state blocks of every rank of this rank's line along
        ``axes`` (:meth:`axes_gather`), before the layer."""
        return self.axes_gather(piece, axes)

    def state_share(self, new: torch.Tensor) -> torch.Tensor:
        """Every ``model`` rank's computed block of a layer's new state
        (:meth:`axes_gather`), after the layer."""
        return self.axes_gather(new, (MODEL,))

    def head_dim_sum(self, scores: torch.Tensor, axes) -> torch.Tensor:
        """The long KV's f32 partial scores of every rank's head_dim
        channels, summed over the axes that cut head_dim (in place): the
        same bits on every rank of them."""
        torch.distributed.all_reduce(scores, group=self._line(axes))
        return scores

    def seq_combine(self, states, axes, order) -> torch.Tensor:
        """Every rank's partial softmax state (m, l, acc) over its block
        of the long KV's slots, cut over ``axes`` (in the spec's
        ``order``), gathered and combined in block order -> the attention
        output (B, Sq, H, d) f32."""
        return cm.combine_partials(*(
            _in_block_order(self.axes_gather(t, axes), axes, order)
            for t in states))

    def output_gather(self, out: torch.Tensor, axes) -> torch.Tensor:
        """The attention output's blocks of heads and head_dim channels of
        every rank along ``axes`` (:meth:`axes_gather`)."""
        return self.axes_gather(out, axes)

    def axes_gather(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Every rank's ``x`` of this rank's line along ``axes`` (mesh
        axes in the mesh's order) -> (*their sizes, *x.shape): the ranks'
        tensors stacked, indexed by their coordinates."""
        sizes = tuple(self.mesh.shape[a] for a in axes)
        parts = _gather_stack(x, self._line(axes), int(np.prod(sizes)))
        return parts.view(sizes + tuple(x.shape))

    def _line(self, axes):
        axes = tuple(axes)
        return self.mesh.group(axes[0] if len(axes) == 1 else axes)

    def long_attention(self, q, k, v, pos, pool_k, pool_v) -> torch.Tensor:
        """One token a row over zamba2's contiguous long KV where the rows
        are :attr:`moved`: the pools (B, s, h, d) hold this rank's block of
        the reference's spec, slots [s0, s1) of heads [h0, h1) and
        channels [d0, d1) of head_dim, each cut over the axes that the spec
        names there.  q, k, v (B, 1, heads, AHD): the rank's heads of the
        shared block (every head where ``model`` does not split them),
        gathered into every head.  The rank writes its block of the new
        K/V where it holds slot ``pos`` (B,); its f32 partial scores over
        its channels are summed over the axes that cut head_dim, its
        partial softmax state over its slots combined with the others' in
        block order, and the output's blocks of heads and channels gathered
        -- the KV itself never moves.  -> (B, 1, heads, AHD) in q's dtype,
        the rank's heads, the same bits on every rank that holds them."""
        shape, spec = self._specs[('attn', 'k')]
        held = self.moved_block(('attn', 'k'))
        (s0, s1), (h0, h1), (d0, d1) = (held.intervals(d)[0]
                                        for d in (2, 3, 4))
        seq, heads, dims = (self._over(spec, (d,)) for d in (2, 3, 4))
        q, k, v = (self.gather_heads(t, 'shared') for t in (q, k, v))
        rows = torch.arange(q.shape[0], device=q.device)
        slot = pos - s0
        inside = ((slot >= 0) & (slot < s1 - s0))[:, None, None]
        slot = slot.clamp(0, s1 - s0 - 1)
        for pool, new in ((pool_k, k), (pool_v, v)):
            pool[rows, slot] = torch.where(
                inside, new[:, 0, h0:h1, d0:d1].to(pool.dtype),
                pool[rows, slot])
        kv_pos = s0 + torch.arange(s1 - s0, device=q.device)
        states = cm.attention_partial(
            q[:, :, h0:h1, d0:d1], pool_k, pool_v,
            kv_pos[None, :] <= pos[:, None],
            score_sum=(lambda s: self.head_dim_sum(s, dims)) if dims
            else None, head_dim=q.shape[-1])
        out = (self.seq_combine(states, seq,
                                [a for a in _entry(spec, 2) if a in seq])
               if seq else cm.combine_partials(*(t[None] for t in states)))
        axes = tuple(a for a in self.mesh.axis_names if a in heads + dims)
        if axes:
            out = unshard(self.output_gather(out, axes),
                          [self.mesh.shape[a] for a in axes],
                          [(), ()] + [tuple(axes.index(a)
                                            for a in _entry(spec, d)
                                            if a in axes) for d in (3, 4)])
        out = out.to(q.dtype)
        if self.shared_split:
            lo, hi = self.own('shared')
            out = out[:, :, lo:hi]
        return out

    # -- the heads of attention --------------------------------------------
    def head_blocks_of(self, kind: str):
        """Every ``model`` rank's [lo, hi) of the heads of ``kind``, in
        rank order: ``'q'`` and ``'kv'`` the paged attention's (dense, vlm,
        moe, encdec's self and cross), ``'shared'`` zamba2's shared
        block's (whose q and kv heads are one)."""
        cfg, n = self.cfg, self.n
        if kind == 'shared':
            ah = cfg.hybrid_attn_heads
            return [block(ah, n, r) if self.shared_split else (0, ah)
                    for r in range(n)]
        if not self.attn_split or self.pair_cut:
            return [(0, cfg.n_heads if kind == 'q' else cfg.n_kv_heads)] * n
        return [head_blocks(cfg.n_heads, cfg.n_kv_heads, n, r)[kind == 'kv']
                for r in range(n)]

    def own(self, kind: str) -> Tuple[int, int]:
        """This rank's [lo, hi) of the heads of ``kind``."""
        return self.head_blocks_of(kind)[self.rank]

    def gather_heads(self, x: torch.Tensor, kind: str) -> torch.Tensor:
        """x (..., h, D), this rank's heads of ``kind`` -> (..., H, D),
        every head, each from the first rank that holds it (a kv-head
        replicated over several ranks is read once); ``x`` itself where
        every rank holds every head.  Under :attr:`pair_cut` x holds this
        rank's RoPE pairs of every head, gathered whole
        (:meth:`whole_pairs`)."""
        if self.pair_cut and kind != 'shared':
            return self.whole_pairs(x)
        blocks = self.head_blocks_of(kind)
        if all(b == blocks[0] for b in blocks):
            return x
        parts = _gather_stack(x, self.group, self.n)
        pick, seen = [], 0
        for r, (lo, hi) in enumerate(blocks):
            if lo >= seen:
                pick.append(parts[r])
                seen = hi
        return torch.cat(pick, dim=-2)

    def own_part(self, out: torch.Tensor, kind: str) -> torch.Tensor:
        """This rank's part of ``out`` (..., H, Dh), every head of
        ``kind``: its heads, or under :attr:`pair_cut` its RoPE pairs of
        every head (:meth:`own_pairs`)."""
        if self.pair_cut and kind != 'shared':
            return self.own_pairs(out)
        lo, hi = self.own(kind)
        return out[..., lo:hi, :]

    def pool_kv(self, k: torch.Tensor, kind: str = 'kv', *,
                paged: bool = True) -> torch.Tensor:
        """The part of the new K/V (..., h, D) of this rank's heads of
        ``kind`` that its cache block takes: every head (``kv_dp``;
        ``seq`` where the leaf is paged), its head_dim block (``dh``), or
        ``k`` (``heads``; ``seq``'s cross K/V, by kv-heads; under
        :attr:`pair_cut` its RoPE pairs of every head)."""
        if self.placement == KV_DP or self.placement == SEQ and paged:
            return self.gather_heads(k, kind)
        if self.placement == DH:
            return k[..., self.head_dim[0]:self.head_dim[1]]
        return k

    # -- the variants' attention -------------------------------------------
    def paged_read(self, q, pool_k, pool_v, page_table, q_positions, kv_len,
                   kinds: Tuple[str, str] = ('q', 'kv')) -> torch.Tensor:
        """:meth:`TensorParallel.paged_read` over the variants' pool
        blocks: ``seq`` attends every head over the rank's pages and
        combines the ranks' f32 states; ``kv_dp`` reads the rank's q heads'
        kv-heads (under :attr:`pair_cut` its RoPE pairs of every head) of
        a pool that holds every head whole."""
        if self.placement == SEQ:
            states = cm.paged_partial(self.gather_heads(q, kinds[0]), pool_k,
                                      pool_v, page_table, q_positions, kv_len,
                                      self.held)
            out = (self.model_combine(states) if self.page_split else
                   cm.combine_partials(*(t[None] for t in states)))
            return self.own_part(out, kinds[0]).to(q.dtype)
        if self.placement == KV_DP and self.pair_cut:
            # every rank holds every head whole; it reads its RoPE pairs
            # of each (1/n of the pool) and sums the partial scores: the
            # whole heads attended on every rank read n times the bytes
            pool_k, pool_v = self.own_pairs(pool_k), self.own_pairs(pool_v)
        elif self.placement == KV_DP:
            lo, hi = self.own(kinds[1])
            pool_k, pool_v = pool_k[..., lo:hi, :], pool_v[..., lo:hi, :]
        return super().paged_read(q, pool_k, pool_v, page_table, q_positions,
                                  kv_len, kinds)

    def model_combine(self, states) -> torch.Tensor:
        """Every ``model`` rank's partial softmax state (m, l, acc) (over
        its pages, ``models.common.paged_partial``, or its block of a long
        KV sequence), gathered and combined in rank order -> the attention
        output (B, Sq, H, Dh) f32, the same bits on every rank."""
        return _combine_over(states, self.group, self.n)

    def seq_attention(self, q, k, v, kv_valid):
        """Attention of one query token a row over a KV sequence split into
        rank-order blocks (:attr:`seq`) over the batch axes or, under
        ``seq``, over ``model``: q (B, 1, Hq, Dh); k/v (B, S_local, Hkv,
        Dh), this rank's slots; ``kv_valid`` (B, S_local).  Each rank's
        partial softmax state (m, l, acc), f32, is all-gathered and the
        blocks combined in rank order (``models.common.combine_partials``),
        so every rank returns the same bits.  -> (B, 1, Hq, Dh) in q's
        dtype."""
        states = cm.attention_partial(q, k, v, kv_valid)
        if self.seq_over == MODEL:
            return self.model_combine(states).to(q.dtype)
        return _combine_over(states, self.batch_group,
                             self.n_batch).to(q.dtype)


def attention_placement(rules) -> str:
    """Where ``rules`` put attention's heads and its pool: ``'dh'`` (the
    pool and q on ``head_dim``), ``'seq'`` (the pool's pages over
    ``model``), ``'kv_dp'`` (the pool's heads replicated, the projections
    split), else ``'heads'``."""
    if rules.get('head_dim') == MODEL:
        return DH
    if rules.get('pages') == MODEL:
        return SEQ
    if rules.get('kv_heads') is None and rules.get('qkv') == MODEL:
        return KV_DP
    return HEADS


def region_pages(cfg, seq_len: int) -> int:
    """The page dimension of a serve step's pool at ``seq_len`` (a row's
    region slots; encdec's one pool has as many pages)."""
    from repro_torch.models.api import region_slots

    return region_slots(seq_len // cfg.page_size) if seq_len else 0


def _gather_stack(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """Every rank's ``t`` of ``group``, stacked on a new first dimension in
    rank order."""
    t = t.contiguous()
    out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
    torch.distributed.all_gather_into_tensor(out, t, group=group)
    return out.view((n,) + tuple(t.shape))


def _combine_over(states, group, n: int) -> torch.Tensor:
    """Every rank's partial softmax state (m, l, acc) of ``group``,
    gathered and combined in rank order (``models.common.
    combine_partials``)."""
    return cm.combine_partials(*(_gather_stack(t, group, n) for t in states))


def _keys(path) -> Tuple[str, ...]:
    return tuple(path.split('/')) if isinstance(path, str) else tuple(path)


def _entry(spec, dim: int) -> Tuple[str, ...]:
    """The mesh axes that ``spec`` names on ``dim``, in its order."""
    e = spec[dim] if dim < len(spec) else None
    return () if e is None else (e,) if isinstance(e, str) else tuple(e)


def _template_items(tmpl, prefix=()):
    """[(keys, PSpec)] of a (nested) cache template."""
    if isinstance(tmpl, cm.PSpec):
        return [(prefix, tmpl)]
    return [x for k, v in tmpl.items()
            for x in _template_items(v, prefix + (k,))]


def unshard(parts: torch.Tensor, sizes, entries) -> torch.Tensor:
    """The whole of a tensor cut over mesh axes, from every rank's block:
    ``parts`` (*sizes, *block) stacked by the ranks' coordinates on the
    axes of ``sizes``; ``entries[d]``: the indices (into ``sizes``) of the
    axes that cut block dimension ``d``, in the spec's order (the block
    order of ``sharding.local_bounds``).  Every axis cuts one dimension."""
    k = len(sizes)
    perm, shape = [], []
    for d, e in enumerate(entries):
        perm += list(e) + [k + d]
        shape.append(int(np.prod([sizes[j] for j in e], dtype=np.int64))
                     * parts.shape[k + d])
    return parts.permute(perm).reshape(shape)


def _in_block_order(parts: torch.Tensor, axes, order) -> torch.Tensor:
    """``parts`` (*sizes of ``axes``, ...) -> (n, ...), the blocks of a
    dimension cut over ``order`` (the same axes, in the spec's order) in
    block order."""
    k = len(axes)
    perm = [axes.index(a) for a in order] + list(range(k, parts.dim()))
    return parts.permute(perm).reshape((-1,) + tuple(parts.shape[k:]))


def _within(inner: Block, outer: Block, start: int = 1) -> Block:
    """``inner``'s bounds on dimensions ``start``.. taken relative to
    ``outer``'s (one interval a dimension, holding ``inner``'s): a Block of
    ``outer``'s local tensor there."""
    bounds = []
    for d in range(start, len(outer.shape)):
        (lo, hi), = outer.intervals(d)
        iv = tuple((a - lo, b - lo) for a, b in inner.intervals(d))
        if iv[0][0] < 0 or iv[-1][1] > hi - lo:
            raise ValueError(f'{inner} is not inside {outer}')
        bounds.append(iv[0] if len(iv) == 1 else iv)
    return Block(tuple(outer.local_shape[start:]), tuple(bounds))


def _select(b: Block, dim: int, intervals) -> Block:
    """``b`` with ``intervals`` on ``dim``, or ``b`` where there are none
    (a replicated weight: the cache dimension stays whole)."""
    return b if intervals is None else b.select(dim, intervals)


class DataShare:
    """A rank's place among the ``n`` data (batch) ranks of a call whose
    rows are split over them (``Model.loss_fn(data=)``, a serving plan's
    :attr:`TensorParallel.data`): rank ``index`` holds the rows after those
    of ranks 0 .. index-1."""

    def __init__(self, group, n: int, index: int):
        self.group, self.n, self.index = group, n, index

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the data ranks, in place."""
        torch.distributed.all_reduce(x, group=self.group)
        return x

    def before(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the lower data ranks (zeros on the first)."""
        rows = x.new_zeros((self.n,) + tuple(x.shape))
        rows[self.index] = x
        return self.sum(rows)[:self.index].sum(0)


def f32_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with an f32 result, rounded nowhere before it: on the card
    one GEMM over the operands as they are that accumulates and writes f32
    (no f32 copy of the weight), under autograd too (:class:`_F32Product`);
    on the CPU, and for f32 operands, the f32 product."""
    if not x.is_cuda or x.dtype == torch.float32:
        return x.float() @ w.float()
    if _traced(x) or _traced(w):
        return _F32Product.apply(x, w)
    return _mm_f32(x, w)


def _mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    out = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
    return out.reshape(x.shape[:-1] + w.shape[-1:])


class _F32Product(torch.autograd.Function):
    """:func:`f32_product` of bf16 operands on the card, with the bf16
    product's backward: the incoming f32 gradient holds bf16 values (the
    reduction after it rounds once to bf16), so it is cast back and both
    gradients are the bf16 GEMMs the meshless ``x @ w`` runs."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _mm_f32(x, w)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        g = grad.to(x.dtype)
        gx = g @ w.t() if ctx.needs_input_grad[0] else None
        gw = (x.reshape(-1, x.shape[-1]).t() @ g.reshape(-1, g.shape[-1])
              if ctx.needs_input_grad[1] else None)
        return gx, gw


def engine_plan(cfg, mesh, coords: Optional[Dict[str, int]] = None, *,
                max_batch: Optional[int] = None) -> TensorParallel:
    """The mesh engine's plan on rank ``coords`` (the calling rank's by
    default): the reference engine's placement of its params and pool,
    ``tree_spec_shaped(..., SERVE_RULES, mesh)`` -- where ``model`` does
    not divide the kv-heads, a block of RoPE pairs of every kv-head
    (:attr:`TensorParallel.pair_cut`).  Every side of one engine (rank 0's
    engine, :class:`Leader`'s shipped blocks, :class:`_Follower`,
    :func:`_gather_cache`) places its blocks through this one plan."""
    return TensorParallel(cfg, mesh, coords, max_batch=max_batch,
                          rules=SERVE_RULES)


def check_mesh(cfg, mesh) -> None:
    """What an engine serves under a mesh, and what it refuses (the
    trainer's check is ``training.train_step.check_train_mesh``): the
    paged-KV families the engine serves, on the ``pod``/``data`` batch
    axes and the ``model`` axis."""
    if cfg.family not in ('dense', 'vlm', 'moe'):
        raise NotImplementedError(
            f'a {cfg.family!r} engine under a mesh: the engine serves the '
            'paged-KV families only')
    other = [a for a in mesh.axis_names if a not in BATCH_AXES + (MODEL,)]
    if other:
        raise NotImplementedError(
            f'mesh axes {other}: an engine serves over {BATCH_AXES} (the '
            'batch) and model only')


# ---------------------------------------------------------------------------
# The dispatch plane: rank 0 leads, every other rank follows.
# ---------------------------------------------------------------------------

def _send_op(msg) -> None:
    torch.distributed.broadcast_object_list([msg], src=0)


def _recv_op():
    box = [None]
    torch.distributed.broadcast_object_list(box, src=0)
    return box[0]


def stage(host, device, prev=None) -> Dict:
    """A dispatch's host batch (numpy; ``shared`` nested) as device tensors,
    as the engine stages it; a fused decode batch's ``tokens`` read from
    ``prev``, the previous fused output, where ``use_prev`` says."""
    out = {}
    for k, v in host.items():
        if isinstance(v, dict):
            out[k] = stage(v, device)
        elif isinstance(v, np.ndarray):
            out[k] = torch.tensor(v, device=device)
        else:
            out[k] = v
    if 'use_prev' in out:
        out['tokens'] = torch.where(out.pop('use_prev') > 0,
                                    prev[out.pop('src').long()],
                                    out.pop('toks'))
    return out


def _leaves(params, prefix=()):
    for k, v in params.items():
        if isinstance(v, (dict, nn.ParameterDict)):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


class Leader:
    """Rank 0's side of one engine's plane: opens the engine on every rank
    (its config, cache geometry and weight blocks), then announces each
    dispatch before rank 0 runs it.  With one rank, nothing is sent.
    ``params`` None: every rank makes its own blocks (:func:`serve_rank`'s
    ``blocks``), none are shipped, and the engine opens once every rank
    holds them (a barrier: a rank drawing its blocks may need the room on
    a shared card that a first dispatch would take)."""

    _ids = itertools.count()

    def __init__(self, model, params, mesh, *, n_pages: int, max_batch: int,
                 cache_dtype):
        self.mesh, self.cfg, self.id = mesh, model.cfg, next(Leader._ids)
        self.workers = [int(r) for r in mesh.devices.flatten() if r != 0]
        if not self.workers:
            return
        leaves = [] if params is None else list(_leaves(params))
        _send_op(('open', self.id, model.cfg, n_pages, max_batch,
                  cache_dtype, None if params is None
                  else [(path, t.dtype) for path, t in leaves]))
        if params is None:
            torch.distributed.barrier()
        plans = {r: engine_plan(model.cfg, mesh, mesh.coords(r))
                 for r in self.workers}
        for path, full in leaves:
            for r in self.workers:
                part = plans[r].shard(path, full.detach())
                # staged through host memory (gloo sends host tensors only),
                # a block at a time: weights on the host are never copied
                # whole to the card
                torch.distributed.send(part.cpu().contiguous(), dst=r)

    def announce(self, op: str, host, **kw) -> None:
        if self.workers:
            _send_op((op, self.id, host, kw))

    def gather_cache(self, cache) -> Dict[str, torch.Tensor]:
        """The global pool (every kv-head, every channel), assembled on
        rank 0 from every rank's block: a copy, on the cache's device (a
        check's view)."""
        if not self.workers:
            return {k: v.clone() for k, v in cache.items()}
        _send_op(('gather_cache', self.id))
        return _gather_cache(cache, self.cfg, self.mesh)

    def close(self) -> None:
        if self.workers:
            _send_op(('close', self.id))


def _gather_cache(cache, cfg, mesh):
    """Every rank's pool block to rank 0 (host copies: gloo gathers host
    tensors), placed at its block of the global pool
    (:meth:`TensorParallel.pool_block`: its kv-heads, or its RoPE pairs
    of every kv-head, channels [lo, hi) and [Dh/2 + lo, Dh/2 + hi) of
    head_dim); None on the other ranks.  A block held by several ranks
    (the batch axes' replicas, a kv-head replicated over ``model``) is
    read from the first and must be bit-equal on the others."""
    dist = torch.distributed
    ranks = [int(r) for r in mesh.devices.flatten()]
    out = {}
    for key in ('k', 'v'):
        local = cache[key].cpu().contiguous()
        parts = ([torch.empty_like(local) for _ in ranks]
                 if dist.get_rank() == 0 else None)
        dist.gather(local, parts, dst=0)
        if parts is None:
            continue
        shape = tuple(local.shape[:3]) + (cfg.n_kv_heads, cfg.hd)
        full = torch.empty(shape, dtype=local.dtype)
        first: Dict[Block, int] = {}
        for r, part in zip(ranks, parts):
            b = engine_plan(cfg, mesh, mesh.coords(r)).pool_block(shape)
            if b in first:
                if not torch.equal(b.take(full), part):
                    raise AssertionError(
                        f'pool replicas differ: rank {r} against rank '
                        f'{first[b]}, block {b.bounds}')
                continue
            first[b] = r
            for piece, at in b.pieces():
                full[tuple(slice(lo, hi) for lo, hi in piece.bounds)] = \
                    part[at]
        out[key] = full.to(cache[key].device)
    return out if out else None


def stop_ranks(mesh) -> None:
    """End every worker's :func:`serve_rank` (rank 0, once all its mesh
    engines are done)."""
    if mesh.size > 1:
        _send_op(('stop',))


class _Follower:
    """A worker rank's copy of one engine: its weight blocks (received from
    rank 0 in the order of ``leaves``, or where ``leaves`` is None made
    here by ``blocks(cfg, plan)``, an ``nn.ParameterDict``), its cache
    block and its last fused output (the device feed of the next fused
    batch)."""

    def __init__(self, cfg, mesh, n_pages: int, max_batch: int, cache_dtype,
                 leaves, blocks=None):
        from repro_torch.models.api import build_model

        self.model = build_model(cfg)
        self.tp = engine_plan(cfg, mesh, max_batch=max_batch)
        shapes = self.model.param_shapes()
        params: Dict = {}
        if leaves is None:
            if blocks is None:
                raise ValueError('an engine opened with every rank\'s own '
                                 'blocks: serve_rank needs blocks=')
            params = blocks(cfg, self.tp)
            torch.distributed.barrier()          # the leader waits on it
        for path, dtype in leaves or ():
            shape = shapes
            for k in path:
                shape = shape[k]
            buf = torch.empty(self.tp.block(path, shape).local_shape,
                              dtype=dtype)
            torch.distributed.recv(buf, src=0)
            node = params
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = buf.to(mesh.device)
        self.params = params if leaves is None else _parameter_dict(params)
        self.cache = self.tp.init_cache(n_pages, mesh.device, cache_dtype)
        self.prev = torch.zeros((max_batch,), dtype=torch.int32,
                                device=mesh.device)

    def run(self, op: str, host, kw) -> None:
        batch = stage(host, self.tp.mesh.device, self.prev)
        m, p, tp = self.model, self.params, self.tp
        if op == 'mixed':
            self.cache, _ = m.prefill_chunk_fn(p, self.cache, batch, tp=tp)
        elif op == 'decode':
            self.cache, _ = m.decode_fn(p, self.cache, batch, tp=tp, **kw)
        elif op == 'decode_sample':
            self.cache, self.prev = m.decode_sample_fn(p, self.cache, batch,
                                                       tp=tp, **kw)
        else:
            raise ValueError(f'unknown op {op!r}')


def _parameter_dict(tree) -> nn.ParameterDict:
    return nn.ParameterDict({
        k: _parameter_dict(v) if isinstance(v, dict)
        else nn.Parameter(v, requires_grad=False) for k, v in tree.items()})


def serve_rank(mesh, blocks=None) -> Dict:
    """A worker rank's loop: follow rank 0's engines on ``mesh`` until
    :func:`stop_ranks`.  ``blocks(cfg, plan)``: this rank's weight blocks
    (an ``nn.ParameterDict`` on the mesh's device, e.g. ``Model.
    init_blocks``) for an engine that rank 0 opened on its own blocks
    (:meth:`TensorParallel.holds_blocks`); the others' are shipped by rank
    0.
    Returns, by engine id (``Leader.id``), each engine's cache block shape
    and the kernel launches its own dispatches made on this rank (the
    counters of ``kernels.common``, counted from 0 at its ``open``)."""
    from repro_torch.kernels.common import LAUNCHES

    engines: Dict[int, _Follower] = {}
    shapes: Dict[int, Tuple[int, ...]] = {}
    launches: Dict[int, Dict[str, int]] = {}
    while True:
        op, *rest = _recv_op()
        if op == 'stop':
            return {'launches': launches, 'cache_shapes': shapes}
        eid = rest[0]
        if op == 'open':
            engines[eid] = _Follower(rest[1], mesh, *rest[2:], blocks=blocks)
            shapes[eid] = tuple(engines[eid].cache['k'].shape)
            launches[eid] = dict.fromkeys(LAUNCHES, 0)
        elif op == 'close':
            del engines[eid]
        elif op == 'gather_cache':
            f = engines[eid]
            _gather_cache(f.cache, f.model.cfg, mesh)
        elif op == 'copy_kv':
            from repro_torch.serving.disagg.plane import copy_pages
            src, src_pages, dst_pages = rest[1]
            copy_pages(engines[src].cache, src_pages, engines[eid].cache,
                       dst_pages)
        else:
            before = dict(LAUNCHES)
            engines[eid].run(op, *rest[1:])
            for k, n in LAUNCHES.items():
                launches[eid][k] += n - before[k]
