"""Decoder-only dense transformer (qwen3-0.6b, internlm2-1.8b) in PyTorch:
the serving entry points of the reference's ``models/dense.py``.

- ``embed_inputs``: token embeddings, the first p positions overwritten
  by ``batch['prefix_embeds']`` where a batch carries them (the vlm
  frontend's output), in ``prefill`` and ``prefill_chunk``.
- ``prefill``: a whole prompt per row written into the pool, attention
  through the flash-attention kernel (``use_kernel=True``) or
  :func:`~repro_torch.models.common.chunked_attention`.
- ``prefill_chunk``: one chunk per row with past-KV readback (the engine's
  mixed prefill+decode dispatch).  Gather + dense attention, no kernel, as
  in the reference.
- ``decode_step`` / ``decode_step_sample``: one token per row, attention
  read through the page table -- by the paged-decode kernel, the
  prefix-shared kernels, or the gather oracle -- and the head as f32
  scores (``decode_step``) or the fused unembed+sample kernel.

Every entry point takes the engine's global pool or the serve step's
per-request region pool (``cache_template(batch=)``, ``models/common.py``);
the paged-decode kernels read the global pool only.

A Python loop over layers replaces ``lax.scan``; the KV pools are updated
in place.  The output head is (V, D) row-major (:func:`head_of`).  Each
entry point takes the layer's MLP block as ``mlp(cfg, lp, h) -> h``
(residual included; :func:`_mlp`, the SwiGLU, by default), so the MoE
family (``models/moe.py``) runs these loops with its routed experts.

The engine's entry points (``prefill_chunk``, ``decode_step``,
``decode_step_sample``) and the whole-prompt ``prefill`` (the serve step's,
``training/train_step.py::make_serve_step``) also run tensor-parallel:
given ``tp``, a
:class:`~repro_torch.distributed.tp.TensorParallel`, the weights and the
pool are this rank's blocks and the collectives sit where the reference
calls ``constrain`` (the embedding, the ``wo`` and ``wd`` products, the
head's scores).  Where the plan splits the dispatch's rows over the batch
axes (``tp.split_rows``), a rank computes its rows (``tp.local``), gathers
each layer's new K/V rows over the batch axes and writes every row's into
its replica of the pool, and gathers the scores and the sampled tokens, so
every rank returns the whole batch's.  Without ``tp`` they are the
single-device code, with no collective and no extra copy.  A serve step's
plan under a rule variant (``serve_kv_dp``, ``serve_seq``, ``serve_dh``:
``tp.placement``, ``distributed/tp.py``) holds another block of the pool:
the new K/V go through ``tp.pool_kv`` (every head, or a head_dim block)
into the pages ``tp.held`` names, and the paged read through
``tp.paged_read``; ``prefill`` attends the call's own K/V as ever.

Where ``model`` does not divide the kv-heads, every plan -- the serve
step's, the trainer's and the engine's (``tp.pair_cut``) -- holds a block
of RoPE pairs of every head: ``qkv_proj`` norms and rotates the rank's
channels, decode and the engine's chunk read them from the pool through
``tp.paged_read`` (the partial scores summed; the engine's global pool
too), and prefill and training gather q/k/v into whole heads
(``tp.whole_pairs``) and take the rank's pairs of the output into ``wo``
(``tp.own_pairs``).

The training forward (``forward_train``) takes ``tp`` too: the rank's
q/kv heads, its ``d_ff`` block and a vocab-parallel embedding and head,
under autograd (the collectives' backward: ``distributed/tp.py``).  The
residual stream stays replicated over ``model``: no sequence
parallelism, the reference's ``TRAIN_NO_SP_RULES`` variant.  It computes
the same function as ``TRAIN_RULES``, whose ``'seq': 'model'`` GSPMD
uses only as a layout of the residuals.  Under a rule variant's plan
(``make_train_step(rules=)``) the weights lie as its rules say:
``serve_dh`` runs attention whole on every rank (its projections
replicated), the q/k norms' head_dim blocks gathered whole
(``tp.attn_weights``, for serving too).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.paged_attention.ops import (
    paged_attention_decode, paged_attention_prefix_shared)
from repro_torch.kernels.sampling.ops import (fused_unembed_sample,
                                              unembed_argmax_block)
from repro_torch.kernels.sampling.ref import unembed_scores
from repro_torch.models import common as cm
from repro_torch.models.common import PSpec


# ---------------------------------------------------------------------------
# Template
# ---------------------------------------------------------------------------

def attn_template(cfg: ModelConfig, L: int) -> Dict[str, PSpec]:
    """A stack of L attention blocks: the projections, then the biases and
    the q/k norms where the config has them."""
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    t = {
        'wq': PSpec((L, d, h * hd), ('layers', 'embed', 'qkv')),
        'wk': PSpec((L, d, hkv * hd), ('layers', 'embed', 'qkv')),
        'wv': PSpec((L, d, hkv * hd), ('layers', 'embed', 'qkv')),
        'wo': PSpec((L, h * hd, d), ('layers', 'qkv', 'embed')),
    }
    if cfg.attn_bias:
        for n, w in (('bq', h), ('bk', hkv), ('bv', hkv)):
            t[n] = PSpec((L, w * hd), ('layers', 'qkv'), 'zeros')
    if cfg.qk_norm:
        t['q_norm'] = PSpec((L, hd), ('layers', 'head_dim'), 'ones')
        t['k_norm'] = PSpec((L, hd), ('layers', 'head_dim'), 'ones')
    return t


def mlp_template(cfg: ModelConfig, L: int) -> Dict[str, PSpec]:
    """A stack of L SwiGLU MLPs."""
    d, f = cfg.d_model, cfg.d_ff
    return {'wg': PSpec((L, d, f), ('layers', 'embed', 'ffn')),
            'wu': PSpec((L, d, f), ('layers', 'embed', 'ffn')),
            'wd': PSpec((L, f, d), ('layers', 'ffn', 'embed'))}


def template(cfg: ModelConfig) -> Dict[str, Any]:
    L, d, v = cfg.n_layers, cfg.d_model, cfg.vocab_size
    t: Dict[str, Any] = {
        'embed': PSpec((v, d), ('vocab', 'embed'),
                       scale=d ** -0.5),           # tied-unembed-safe
        'final_norm': PSpec((d,), ('embed',), 'ones'),
        'layers': {
            'ln1': PSpec((L, d), ('layers', 'embed'), 'ones'),
            'ln2': PSpec((L, d), ('layers', 'embed'), 'ones'),
            **attn_template(cfg, L),
            **mlp_template(cfg, L),
        },
    }
    if not cfg.tie_embeddings:
        # (V, D) row-major for the sampling kernel: the reference's (D, V)
        # unembed transposed, same law (fan_in = d) and axes
        t['unembed'] = PSpec((v, d), ('vocab', 'embed'), scale=d ** -0.5)
    return t


def head_of(cfg: ModelConfig, params):
    """The output head as (V, D) row-major: the embedding table itself for
    tied configs (no transposed copy), else the (V, D) unembed."""
    return params['embed'] if cfg.tie_embeddings else params['unembed']


def cache_template(cfg: ModelConfig, n_pages: int,
                   batch: Optional[int] = None) -> Dict[str, PSpec]:
    """Paged KV pool for k and v.  ``batch=None``: the global pool (L, P,
    pg, Hkv, Dh), the engine's layout, whose page 0 is the quarantine page
    Valve's handles remap to.  ``batch=B``: the per-request region layout
    (L, B, R, pg, Hkv, Dh) of ``make_serve_step``, ``n_pages`` = R slots a
    row, slot 0 each row's quarantine slot."""
    if batch is None:
        shape = (cfg.n_layers, n_pages, cfg.page_size, cfg.n_kv_heads, cfg.hd)
        axes = ('layers', 'pages', None, 'kv_heads', 'head_dim')
    else:
        shape = (cfg.n_layers, batch, n_pages, cfg.page_size,
                 cfg.n_kv_heads, cfg.hd)
        axes = ('layers', 'batch', 'pages', None, 'kv_heads', 'head_dim')
    return {'k': PSpec(shape, axes, 'zeros'), 'v': PSpec(shape, axes, 'zeros')}


# ---------------------------------------------------------------------------
# Layer pieces
# ---------------------------------------------------------------------------

def qkv_proj(cfg: ModelConfig, lp, x, positions, tp=None):
    """q, k, v (B, S, h, Dh) after the norms and RoPE; under ``tp``'s
    pair cut (``tp.pair_cut``) every head's RoPE pairs of the rank (B, S,
    H, Dh/n), normed over all of Dh (``tp.pair_norm``)."""
    b, s, _ = x.shape
    q, k, v = x @ lp['wq'], x @ lp['wk'], x @ lp['wv']
    if cfg.attn_bias and 'bq' in lp:
        q, k, v = q + lp['bq'], k + lp['bk'], v + lp['bv']
    cut = _cut(tp)
    # -1 heads: a tensor-parallel rank's weights hold its heads only
    width = 2 * (tp.pairs[1] - tp.pairs[0]) if cut else cfg.hd
    q = q.reshape(b, s, -1, width)
    k = k.reshape(b, s, -1, width)
    v = v.reshape(b, s, -1, width)
    if cfg.qk_norm and 'q_norm' in lp:
        norm = tp.pair_norm if cut else cm.rms_norm
        q = norm(q, lp['q_norm'], cfg.norm_eps)
        k = norm(k, lp['k_norm'], cfg.norm_eps)
    pairs = (tp.pairs[0], cfg.hd // 2) if cut else None
    return (cm.rope(q, positions, cfg.rope_theta, pairs),
            cm.rope(k, positions, cfg.rope_theta, pairs), v)


def _cut(tp) -> bool:
    """Whether ``tp`` holds a block of RoPE pairs of every head
    (``tp.pair_cut``: the reference's placement where ``model`` does not
    divide the kv-heads)."""
    return tp is not None and tp.pair_cut


def _whole(tp, *ts):
    """Under the pair cut, each of ``ts`` (B, S, h, Dh/n) gathered over
    ``model`` into whole heads (``tp.whole_pairs``); else ``ts``."""
    return tuple(tp.whole_pairs(t) for t in ts) if _cut(tp) else ts


def _own(tp, out):
    """Under the pair cut, this rank's RoPE pairs (``tp.own_pairs``) of
    attention's output over whole heads, its rows of ``wo``; else
    ``out``."""
    return tp.own_pairs(out) if _cut(tp) else out


def _row_ops(tp):
    """(this rank's rows of a per-row tensor, every row gathered from the
    ranks' blocks) under ``tp``; the identity twice without it."""
    if tp is None:
        return (lambda t: t), (lambda t: t)
    return tp.local, tp.gather_rows


def _store(tp):
    """(new K/V (B, ..., h, Dh) of this rank's heads -> what its pool block
    takes, every row's (``tp.pool_kv``, then ``tp.gather_rows``); the
    pool's page block ``tp.held``) under ``tp``; the identity and None
    without it."""
    if tp is None:
        return (lambda t: t), None
    return (lambda t: tp.gather_rows(tp.pool_kv(t))), tp.held


def _weights(lp, tp):
    """A serving layer's attention weights under ``tp``
    (``tp.attn_weights``: ``serve_dh``'s q/k norms gathered whole)."""
    return lp if tp is None else tp.attn_weights(lp)


def placed(tp) -> bool:
    """Whether ``tp`` is a serve step's plan under a rule variant
    (``serve_kv_dp``, ``serve_seq``, ``serve_dh``: ``distributed.tp.
    StepParallel``) or any plan under the pair cut (the engine's too),
    whose paged reads go through ``tp.paged_read``."""
    return tp is not None and (tp.placement != 'heads' or tp.pair_cut)


def _out_proj(x, wo, tp):
    """Attention's output projection; under ``tp`` the rank's heads'
    partial product, summed over the ranks."""
    return x @ wo if tp is None else tp.row_parallel(x, wo, tp.attn_split)


def self_attn_decode(cfg: ModelConfig, lp, x, positions, pool_k, pool_v,
                     page_table, *, use_kernel: bool = False, shared=None,
                     tp=None):
    """x: (B, 1, D); positions: (B,) index of the new token.

    ``shared`` (optional) is the deduplicated shared-prefix run structure
    (``kernels.paged_attention.prefix.build_shared_runs``, as tensors): the
    read then goes through the prefix-shared kernels, each shared physical
    page read once per batch.  The KV *write* always indexes the row's own
    ``page_table``.  Under ``tp`` with split rows, ``x`` holds this rank's
    rows and ``positions``/``page_table`` every row's (module docstring).
    The pools may be global or region-paged (``models/common.py``); the
    kernels read the global layout only, and on a region pool
    ``use_kernel`` and ``shared`` raise (the reference's kernel path falls
    back to its plain read there instead).
    """
    if pool_k.dim() == 5 and (use_kernel or shared is not None):
        raise NotImplementedError(
            'the paged-decode kernels read the global pool layout, not the '
            'region layout: decode a region cache with use_kernel=False')
    pg = pool_k.shape[-3]
    local = _row_ops(tp)[0]
    store, held = _store(tp)
    lp = _weights(lp, tp)
    q, k, v = qkv_proj(cfg, lp, x, local(positions)[:, None], tp)
    page_idx = page_table.gather(1, (positions // pg)[:, None].long())[:, 0]
    offs = positions % pg
    cm.kv_write_token(pool_k, page_idx, offs, store(k[:, 0]), held)
    cm.kv_write_token(pool_v, page_idx, offs, store(v[:, 0]), held)
    lengths = local(positions) + 1
    if placed(tp):
        out = tp.paged_read(q, pool_k, pool_v, local(page_table),
                            local(positions)[:, None], lengths)[:, 0]
    elif shared is not None:
        out = paged_attention_prefix_shared(
            q[:, 0], pool_k, pool_v, shared['pages'], shared['pos'],
            local(shared['mask']), local(shared['tail_pt']),
            local(shared['start']), lengths)
    elif use_kernel:
        out = paged_attention_decode(q[:, 0], pool_k, pool_v,
                                     local(page_table), lengths)
    else:
        out = cm.paged_attention_ref(q[:, 0], pool_k, pool_v,
                                     local(page_table), lengths)
    return _out_proj(out.reshape(x.shape[0], 1, -1), lp['wo'], tp)


def self_attn_train(cfg: ModelConfig, lp, x, positions, *,
                    use_kernel: bool = False, tp=None, causal: bool = True):
    """Self-attention over the whole sequence, no cache (causal, or not:
    encdec's encoder).  x: (B, S, D); positions: (B, S) = 0..S-1.
    ``chunked_attention`` (checkpointed a query chunk under autograd), or
    the flash-attention kernel with ``use_kernel``, which has no backward
    and raises under autograd.  Under ``tp`` the rank's heads, ``wo`` a
    row-parallel product."""
    b, s, _ = x.shape
    if tp is not None:
        x, lp = tp.copy(x, tp.attn_split), tp.attn_weights(lp)
    q, k, v = _whole(tp, *qkv_proj(cfg, lp, x, positions, tp))
    if use_kernel:
        out = flash_attention(q, k, v, causal=causal)
    else:
        out = cm.chunked_attention(q, k, v, q_positions=positions,
                                   kv_positions=positions, causal=causal)
    return _out_proj(_own(tp, out).reshape(b, s, -1), lp['wo'], tp)


def self_attn_prefill(cfg: ModelConfig, lp, x, positions, pool_k, pool_v,
                      page_table, *, use_kernel: bool = False, tp=None):
    """Whole-prompt prefill attention.  x: (B, S, D); positions: (B, S)
    = 0..S-1; page_table (B, >= S // page).  K/V go into the pools (either
    layout), and attention reads this call's own K/V, not the pool.  Under
    ``tp`` with split rows, ``x`` and ``positions`` hold this rank's rows
    and ``page_table`` every row's (module docstring)."""
    b, s, _ = x.shape
    store, held = _store(tp)
    q, k, v = qkv_proj(cfg, _weights(lp, tp), x, positions, tp)
    cm.kv_write_prefill(pool_k, page_table, store(k), held)
    cm.kv_write_prefill(pool_v, page_table, store(v), held)
    qw, kw, vw = _whole(tp, q, k, v)
    if use_kernel:
        out = flash_attention(qw, kw, vw, causal=True)
    else:
        out = cm.chunked_attention(qw, kw, vw, q_positions=positions,
                                   kv_positions=positions, causal=True)
    return _out_proj(_own(tp, out).reshape(b, s, -1), lp['wo'], tp)


def self_attn_prefill_chunk(cfg: ModelConfig, lp, x, positions, pool_k,
                            pool_v, page_table, page_ids, offsets, kv_len,
                            tp=None):
    """One prefill chunk with past-KV readback.

    x: (B, C, D); positions: (B, C) absolute positions (padding repeats the
    last real one); page_ids/offsets: (B, C) write targets (padding ->
    quarantine page 0); kv_len: (B,) valid tokens after this chunk.  Under
    ``tp`` with split rows, ``x`` holds this rank's rows and the rest every
    row's (module docstring).
    """
    local = _row_ops(tp)[0]
    store, held = _store(tp)
    positions = local(positions)
    q, k, v = qkv_proj(cfg, _weights(lp, tp), x, positions, tp)
    cm.kv_write_tokens(pool_k, page_ids, offsets, store(k), held)
    cm.kv_write_tokens(pool_v, page_ids, offsets, store(v), held)
    if placed(tp):
        out = tp.paged_read(q, pool_k, pool_v, local(page_table), positions,
                            local(kv_len))
        return _out_proj(out.reshape(x.shape[0], x.shape[1], -1), lp['wo'],
                         tp)
    kg = cm.kv_gather(pool_k, local(page_table))  # (B, maxp*pg, Hkv, Dh)
    vg = cm.kv_gather(pool_v, local(page_table))
    b, skv = kg.shape[:2]
    kv_pos = torch.arange(skv, device=x.device).expand(b, -1)
    out = cm.attention(q, kg, vg, q_positions=positions.long(),
                       kv_positions=kv_pos,
                       kv_valid=kv_pos < local(kv_len).long()[:, None],
                       causal=True)
    return _out_proj(out.reshape(b, x.shape[1], -1), lp['wo'], tp)


def _mlp(cfg, lp, h, tp=None):
    """The dense MLP block: pre-norm SwiGLU plus the residual; under
    ``tp`` the rank's d_ff block, its ``wd`` product summed over the
    ranks."""
    x = cm.rms_norm(h, lp['ln2'], cfg.norm_eps)
    if tp is None:
        return h + cm.swiglu(x, lp['wg'], lp['wu'], lp['wd'])
    split = tp.ffn != (0, cfg.d_ff)
    return h + cm.swiglu(tp.copy(x, split), lp['wg'], lp['wu'], lp['wd'],
                         functools.partial(tp.row_parallel, split=split))


def head_scores(last, head, tp=None):
    """The head's f32 scores (B, V) of ``last`` (B, D); under ``tp`` the
    rank's vocabulary block, or every column where ``model`` cuts the head
    on d_model (``tp.scores``)."""
    return unembed_scores(last, head) if tp is None else tp.scores(last,
                                                                   head)


def _scores(cfg, params, last, tp):
    """The head's f32 scores (B, V); under ``tp`` the rank's vocab block
    of its rows, gathered over ``model`` and the batch axes."""
    scores = head_scores(last, head_of(cfg, params), tp)
    return scores if tp is None else tp.gather_rows(tp.gather_vocab(scores))


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def embed_inputs(cfg: ModelConfig, params, tokens, prefix_embeds=None,
                 tp=None):
    """Token embeddings (B, S, D); with ``prefix_embeds`` (B, p, D) the
    first p positions are those embeddings, cast to the embedding dtype.
    Under ``tp`` a vocab-parallel lookup (``tp.embed``; where ``model``
    does not divide the vocabulary, the rank's columns gathered)."""
    h = (params['embed'][tokens.long()] if tp is None
         else tp.embed(params['embed'], tokens))
    if prefix_embeds is not None:
        p = prefix_embeds.shape[1]
        h = torch.cat([prefix_embeds.to(h.dtype), h[:, p:]], dim=1)
    return h


def train_layer(cfg: ModelConfig, lp, h, positions, *,
                use_kernel: bool = False, tp=None):
    """One decoder layer of the training forward (``tp``: a rank's)."""
    x = cm.rms_norm(h, lp['ln1'], cfg.norm_eps)
    h = h + self_attn_train(cfg, lp, x, positions, use_kernel=use_kernel,
                            tp=tp)
    return _mlp(cfg, lp, h, tp)


def forward_train(cfg: ModelConfig, params, batch, *,
                  use_kernel: bool = False, tp=None):
    """Mean next-token NLL of batch['labels'] (B, S) given batch['tokens']
    (B, S) [, prefix_embeds (B, p, D)], masked by batch['loss_mask'] if
    present.  Each layer is checkpointed under autograd, as the reference's
    ``scan_layers`` does; the loss is ``chunked_ce_loss``.  Under ``tp``
    the weights are a rank's blocks (module docstring) and the loss is
    replicated over the ranks.  -> (loss, {'tokens': count})."""
    tokens = batch['tokens']
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    h = embed_inputs(cfg, params, tokens, batch.get('prefix_embeds'), tp)
    for lp in cm.layer_views(params):
        h = cm.remat(lambda h, lp: train_layer(cfg, lp, h, positions,
                                               use_kernel=use_kernel, tp=tp),
                     h, lp)
    nll, cnt = cm.chunked_ce_loss(
        h, params['final_norm'], head_of(cfg, params), batch['labels'],
        mask=batch.get('loss_mask'), eps=cfg.norm_eps,
        tp=tp)
    return nll / torch.clamp_min(cnt, 1.0), {'tokens': cnt}


def prefill(cfg: ModelConfig, params, cache, batch, *,
            use_kernel: bool = False, mlp=_mlp, tp=None):
    """Whole-prompt prefill.  batch: tokens (B, S) with S a multiple of
    the page size, page_table (B, >= S // page) [, prefix_embeds (B, p,
    D)]; the cache's pools global or region-paged.  Returns (cache with
    the prompt's K/V written, f32 scores of the last token).  ``tp``: a
    rank's step, as ``prefill_chunk``'s."""
    local = _row_ops(tp)[0]
    tokens = local(batch['tokens'])
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    h = embed_inputs(cfg, params, tokens, local(batch.get('prefix_embeds')),
                     tp)
    if tp is not None:
        mlp = functools.partial(mlp, tp=tp)
    for i, lp in enumerate(cm.layer_views(params)):
        x = cm.rms_norm(h, lp['ln1'], cfg.norm_eps)
        h = h + self_attn_prefill(cfg, lp, x, positions, cache['k'][i],
                                  cache['v'][i], batch['page_table'],
                                  use_kernel=use_kernel, tp=tp)
        h = mlp(cfg, lp, h)
    last = cm.rms_norm(h[:, -1], params['final_norm'], cfg.norm_eps)
    return cache, _scores(cfg, params, last, tp)


def prefill_chunk(cfg: ModelConfig, params, cache, batch, *, mlp=_mlp,
                  tp=None):
    """Chunked prefill step (the offline engine's preemptible dispatch unit).

    batch: tokens (B, C), positions (B, C), page_table (B, maxp),
    page_ids/offsets (B, C), kv_len (B,), last_idx (B,) index of the last
    real token inside the chunk [, prefix_embeds (B, p, D)].  Returns
    (cache, f32 scores at last_idx).
    """
    positions = batch['positions']
    local = _row_ops(tp)[0]
    h = embed_inputs(cfg, params, local(batch['tokens']),
                     local(batch.get('prefix_embeds')), tp)
    if tp is not None:
        mlp = functools.partial(mlp, tp=tp)
    for i, lp in enumerate(cm.layer_views(params)):
        x = cm.rms_norm(h, lp['ln1'], cfg.norm_eps)
        h = h + self_attn_prefill_chunk(
            cfg, lp, x, positions, cache['k'][i], cache['v'][i],
            batch['page_table'], batch['page_ids'], batch['offsets'],
            batch['kv_len'], tp)
        h = mlp(cfg, lp, h)
    last = h[torch.arange(h.shape[0], device=h.device),
             local(batch['last_idx']).long()]
    last = cm.rms_norm(last, params['final_norm'], cfg.norm_eps)
    return cache, _scores(cfg, params, last, tp)


def _decode_hidden(cfg, params, cache, batch, use_kernel, mlp=_mlp,
                   tp=None):
    positions = batch['positions']
    tokens = _row_ops(tp)[0](batch['tokens'])
    h = embed_inputs(cfg, params, tokens, tp=tp)[:, None, :]
    if tp is not None:
        mlp = functools.partial(mlp, tp=tp)
    for i, lp in enumerate(cm.layer_views(params)):
        x = cm.rms_norm(h, lp['ln1'], cfg.norm_eps)
        h = h + self_attn_decode(cfg, lp, x, positions, cache['k'][i],
                                 cache['v'][i], batch['page_table'],
                                 use_kernel=use_kernel,
                                 shared=batch.get('shared'), tp=tp)
        h = mlp(cfg, lp, h)
    return cm.rms_norm(h[:, 0], params['final_norm'], cfg.norm_eps)


def decode_step(cfg: ModelConfig, params, cache, batch, *,
                use_kernel: bool = False, mlp=_mlp, tp=None):
    """tokens (B,), positions (B,), page_table (B, maxp) [, shared] ->
    (cache, (B, V) f32 scores)."""
    last = _decode_hidden(cfg, params, cache, batch, use_kernel, mlp, tp)
    return cache, _scores(cfg, params, last, tp)


def decode_step_sample(cfg: ModelConfig, params, cache, batch, *,
                       use_kernel: bool = False, temperature: float = 0.0,
                       tp=None):
    """``decode_step`` with the sampling tail fused into the unembed: the
    final-norm hidden goes straight into the fused unembed+argmax kernel and
    (cache, (B,) int32 tokens) comes back -- logits never reach memory.
    Greedy picks the argmax of the same f32 scores ``decode_step`` returns;
    temperature sampling uses counter-hash Gumbel noise seeded by
    ``batch['seed']`` (an int).

    Under ``tp`` each rank samples its rows over its vocabulary block (the
    kernel's block form: the noise drawn at the global row and column) and
    the ranks' bests are combined over ``model`` (``tp.combine_argmax``):
    the single-device kernel's tokens bit for bit where the block's scores
    are the whole head's; then the tokens are gathered over the batch
    axes."""
    last = _decode_hidden(cfg, params, cache, batch, use_kernel, tp=tp)
    seed = batch.get('seed', 0)
    if tp is not None:
        value, index = unembed_argmax_block(
            last, head_of(cfg, params), seed, temperature=temperature,
            row0=tp.rows.start, col0=tp.vocab[0])
        return cache, tp.gather_rows(tp.combine_argmax(value, index))
    return cache, fused_unembed_sample(last, head_of(cfg, params), seed,
                                       temperature=temperature)
