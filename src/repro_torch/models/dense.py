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

A Python loop over layers replaces ``lax.scan``; the KV pools are updated
in place.  The output head is (V, D) row-major (:func:`head_of`).  Each
entry point takes the layer's MLP block as ``mlp(cfg, lp, h) -> h``
(residual included; :func:`_mlp`, the SwiGLU, by default), so the MoE
family (``models/moe.py``) runs these loops with its routed experts.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.paged_attention.ops import (
    paged_attention_decode, paged_attention_prefix_shared)
from repro_torch.kernels.sampling.ops import fused_unembed_sample
from repro_torch.kernels.sampling.ref import unembed_scores
from repro_torch.models import common as cm
from repro_torch.models.common import PSpec


# ---------------------------------------------------------------------------
# Template
# ---------------------------------------------------------------------------

def template(cfg: ModelConfig) -> Dict[str, Any]:
    L, d, v, f = cfg.n_layers, cfg.d_model, cfg.vocab_size, cfg.d_ff
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    layers = {
        'ln1': PSpec((L, d), 'ones'),
        'ln2': PSpec((L, d), 'ones'),
        'wq': PSpec((L, d, h * hd)),
        'wk': PSpec((L, d, hkv * hd)),
        'wv': PSpec((L, d, hkv * hd)),
        'wo': PSpec((L, h * hd, d)),
        'wg': PSpec((L, d, f)),
        'wu': PSpec((L, d, f)),
        'wd': PSpec((L, f, d)),
    }
    if cfg.attn_bias:
        for n, w in (('bq', h), ('bk', hkv), ('bv', hkv)):
            layers[n] = PSpec((L, w * hd), 'zeros')
    if cfg.qk_norm:
        layers['q_norm'] = PSpec((L, hd), 'ones')
        layers['k_norm'] = PSpec((L, hd), 'ones')
    t: Dict[str, Any] = {
        'embed': PSpec((v, d), scale=d ** -0.5),   # tied-unembed-safe
        'final_norm': PSpec((d,), 'ones'),
        'layers': layers,
    }
    if not cfg.tie_embeddings:
        # (V, D) row-major for the sampling kernel: the reference's (D, V)
        # unembed transposed, same law (fan_in = d)
        t['unembed'] = PSpec((v, d), scale=d ** -0.5)
    return t


def head_of(cfg: ModelConfig, params):
    """The output head as (V, D) row-major: the embedding table itself for
    tied configs (no transposed copy), else the (V, D) unembed."""
    return params['embed'] if cfg.tie_embeddings else params['unembed']


def cache_template(cfg: ModelConfig, n_pages: int) -> Dict[str, PSpec]:
    """Global paged KV pool: (L, P, pg, Hkv, Dh) for k and v; page 0 is the
    quarantine page Valve's handles remap to."""
    shape = (cfg.n_layers, n_pages, cfg.page_size, cfg.n_kv_heads, cfg.hd)
    return {'k': PSpec(shape, 'zeros'), 'v': PSpec(shape, 'zeros')}


def _layer(params, i: int):
    return {k: w[i] for k, w in params['layers'].items()}


# ---------------------------------------------------------------------------
# Layer pieces
# ---------------------------------------------------------------------------

def qkv_proj(cfg: ModelConfig, lp, x, positions):
    b, s, _ = x.shape
    q, k, v = x @ lp['wq'], x @ lp['wk'], x @ lp['wv']
    if cfg.attn_bias and 'bq' in lp:
        q, k, v = q + lp['bq'], k + lp['bk'], v + lp['bv']
    q = q.reshape(b, s, cfg.n_heads, cfg.hd)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.hd)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.hd)
    if cfg.qk_norm and 'q_norm' in lp:
        q = cm.rms_norm(q, lp['q_norm'], cfg.norm_eps)
        k = cm.rms_norm(k, lp['k_norm'], cfg.norm_eps)
    return (cm.rope(q, positions, cfg.rope_theta),
            cm.rope(k, positions, cfg.rope_theta), v)


def self_attn_decode(cfg: ModelConfig, lp, x, positions, pool_k, pool_v,
                     page_table, *, use_kernel: bool = False, shared=None):
    """x: (B, 1, D); positions: (B,) index of the new token.

    ``shared`` (optional) is the deduplicated shared-prefix run structure
    (``kernels.paged_attention.prefix.build_shared_runs``, as tensors): the
    read then goes through the prefix-shared kernels, each shared physical
    page read once per batch.  The KV *write* always indexes the row's own
    ``page_table``.
    """
    b = x.shape[0]
    pg = pool_k.shape[1]
    q, k, v = qkv_proj(cfg, lp, x, positions[:, None])
    page_idx = page_table.gather(1, (positions // pg)[:, None].long())[:, 0]
    offs = positions % pg
    cm.kv_write_token(pool_k, page_idx, offs, k[:, 0])
    cm.kv_write_token(pool_v, page_idx, offs, v[:, 0])
    lengths = positions + 1
    if shared is not None:
        out = paged_attention_prefix_shared(
            q[:, 0], pool_k, pool_v, shared['pages'], shared['pos'],
            shared['mask'], shared['tail_pt'], shared['start'], lengths)
    elif use_kernel:
        out = paged_attention_decode(q[:, 0], pool_k, pool_v, page_table,
                                     lengths)
    else:
        out = cm.paged_attention_ref(q[:, 0], pool_k, pool_v, page_table,
                                     lengths)
    return out.reshape(b, 1, -1) @ lp['wo']


def self_attn_prefill(cfg: ModelConfig, lp, x, positions, pool_k, pool_v,
                      page_table, *, use_kernel: bool = False):
    """Whole-prompt prefill attention.  x: (B, S, D); positions: (B, S)
    = 0..S-1; page_table (B, >= S // page).  K/V go into the pools, and
    attention reads this call's own K/V, not the pool."""
    b, s, _ = x.shape
    q, k, v = qkv_proj(cfg, lp, x, positions)
    cm.kv_write_prefill(pool_k, page_table, k)
    cm.kv_write_prefill(pool_v, page_table, v)
    if use_kernel:
        out = flash_attention(q, k, v, causal=True)
    else:
        out = cm.chunked_attention(q, k, v, q_positions=positions,
                                   kv_positions=positions, causal=True)
    return out.reshape(b, s, -1) @ lp['wo']


def self_attn_prefill_chunk(cfg: ModelConfig, lp, x, positions, pool_k,
                            pool_v, page_table, page_ids, offsets, kv_len):
    """One prefill chunk with past-KV readback.

    x: (B, C, D); positions: (B, C) absolute positions (padding repeats the
    last real one); page_ids/offsets: (B, C) write targets (padding ->
    quarantine page 0); kv_len: (B,) valid tokens after this chunk.
    """
    q, k, v = qkv_proj(cfg, lp, x, positions)
    cm.kv_write_tokens(pool_k, page_ids, offsets, k)
    cm.kv_write_tokens(pool_v, page_ids, offsets, v)
    kg = cm.paged_gather(pool_k, page_table)   # (B, maxp*pg, Hkv, Dh)
    vg = cm.paged_gather(pool_v, page_table)
    b, skv = kg.shape[:2]
    kv_pos = torch.arange(skv, device=x.device).expand(b, -1)
    out = cm.attention(q, kg, vg, q_positions=positions.long(),
                       kv_positions=kv_pos,
                       kv_valid=kv_pos < kv_len.long()[:, None], causal=True)
    return out.reshape(b, x.shape[1], -1) @ lp['wo']


def _mlp(cfg, lp, h):
    """The dense MLP block: pre-norm SwiGLU plus the residual."""
    x = cm.rms_norm(h, lp['ln2'], cfg.norm_eps)
    return h + cm.swiglu(x, lp['wg'], lp['wu'], lp['wd'])


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def embed_inputs(cfg: ModelConfig, params, tokens, prefix_embeds=None):
    """Token embeddings (B, S, D); with ``prefix_embeds`` (B, p, D) the
    first p positions are those embeddings, cast to the embedding dtype."""
    h = params['embed'][tokens.long()]
    if prefix_embeds is not None:
        p = prefix_embeds.shape[1]
        h = torch.cat([prefix_embeds.to(h.dtype), h[:, p:]], dim=1)
    return h


def prefill(cfg: ModelConfig, params, cache, batch, *,
            use_kernel: bool = False, mlp=_mlp):
    """Whole-prompt prefill.  batch: tokens (B, S) with S a multiple of
    the page size, page_table (B, >= S // page) [, prefix_embeds (B, p,
    D)].  Returns (cache with the
    prompt's K/V written, f32 scores of the last token)."""
    tokens = batch['tokens']
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    h = embed_inputs(cfg, params, tokens, batch.get('prefix_embeds'))
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        x = cm.rms_norm(h, lp['ln1'], cfg.norm_eps)
        h = h + self_attn_prefill(cfg, lp, x, positions, cache['k'][i],
                                  cache['v'][i], batch['page_table'],
                                  use_kernel=use_kernel)
        h = mlp(cfg, lp, h)
    last = cm.rms_norm(h[:, -1], params['final_norm'], cfg.norm_eps)
    return cache, unembed_scores(last, head_of(cfg, params))


def prefill_chunk(cfg: ModelConfig, params, cache, batch, *, mlp=_mlp):
    """Chunked prefill step (the offline engine's preemptible dispatch unit).

    batch: tokens (B, C), positions (B, C), page_table (B, maxp),
    page_ids/offsets (B, C), kv_len (B,), last_idx (B,) index of the last
    real token inside the chunk [, prefix_embeds (B, p, D)].  Returns
    (cache, f32 scores at last_idx).
    """
    positions = batch['positions']
    h = embed_inputs(cfg, params, batch['tokens'], batch.get('prefix_embeds'))
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        x = cm.rms_norm(h, lp['ln1'], cfg.norm_eps)
        h = h + self_attn_prefill_chunk(
            cfg, lp, x, positions, cache['k'][i], cache['v'][i],
            batch['page_table'], batch['page_ids'], batch['offsets'],
            batch['kv_len'])
        h = mlp(cfg, lp, h)
    last = h[torch.arange(h.shape[0], device=h.device),
             batch['last_idx'].long()]
    last = cm.rms_norm(last, params['final_norm'], cfg.norm_eps)
    return cache, unembed_scores(last, head_of(cfg, params))


def _decode_hidden(cfg, params, cache, batch, use_kernel, mlp=_mlp):
    positions = batch['positions']
    h = params['embed'][batch['tokens'].long()][:, None, :]
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        x = cm.rms_norm(h, lp['ln1'], cfg.norm_eps)
        h = h + self_attn_decode(cfg, lp, x, positions, cache['k'][i],
                                 cache['v'][i], batch['page_table'],
                                 use_kernel=use_kernel,
                                 shared=batch.get('shared'))
        h = mlp(cfg, lp, h)
    return cm.rms_norm(h[:, 0], params['final_norm'], cfg.norm_eps)


def decode_step(cfg: ModelConfig, params, cache, batch, *,
                use_kernel: bool = False, mlp=_mlp):
    """tokens (B,), positions (B,), page_table (B, maxp) [, shared] ->
    (cache, (B, V) f32 scores)."""
    last = _decode_hidden(cfg, params, cache, batch, use_kernel, mlp)
    return cache, unembed_scores(last, head_of(cfg, params))


def decode_step_sample(cfg: ModelConfig, params, cache, batch, *,
                       use_kernel: bool = False, temperature: float = 0.0):
    """``decode_step`` with the sampling tail fused into the unembed: the
    final-norm hidden goes straight into the fused unembed+argmax kernel and
    (cache, (B,) int32 tokens) comes back -- logits never reach memory.
    Greedy picks the argmax of the same f32 scores ``decode_step`` returns;
    temperature sampling uses counter-hash Gumbel noise seeded by
    ``batch['seed']`` (an int)."""
    last = _decode_hidden(cfg, params, cache, batch, use_kernel)
    return cache, fused_unembed_sample(last, head_of(cfg, params),
                                       batch.get('seed', 0),
                                       temperature=temperature)
