"""seamless-m4t-medium in PyTorch: a speech encoder -> text decoder
transformer, the reference's ``models/encdec.py`` [arXiv:2308.11596].

The audio frontend is a stub, as in the reference: the inputs are
precomputed speech frame embeddings (B, S_enc, d_model), rounded to bf16
before ``frontend_proj`` whatever the weights' dtype.  The encoder is
non-causal self-attention with RoPE.  The decoder is a causal transformer
with cross-attention; its self-attention KV is paged (Valve-reclaimable),
and the cross-attention K/V, computed once from the encoder output at
prefill, is a dense per-request cache.  Cross K/V take the biases but no
RoPE and no q/k norm, and neither does the cross query.

A Python loop over layers replaces ``lax.scan``; the caches are updated in
place.  The output head ``unembed`` is stored (V, D) row-major, as the
dense family's.  No kernel runs here, as in the reference: the decoder's
paged read is the gather oracle.

**Training over ``model``** (``forward_train(tp=)``, a
``distributed.tp.TensorParallel``): the encoder's and the decoder's
self-attention and MLPs are split as the dense family's (whole heads,
their biases, ``d_ff``; ``models/dense.py``), the cross-attention's
``x*`` leaves by the same heads, and ``embed`` / ``unembed`` by
vocabulary where ``model`` divides it, else by d_model, as the
reference's specs place them (seamless-m4t-medium's 256206 tokens on 16
ranks: the lookup's columns gathered, the head's partial scores and the
loss's logits summed over ``model``; ``distributed.tp.TensorParallel.
embed_cut``); ``frontend_proj`` and the norms stay replicated.  The
encoder's output enters every layer's cross K/V
through one ``tp.copy``; where a rank's kv-head is replicated over several
ranks, its cross ``wk``/``wv``/``bk``/``bv`` pass through ``_CopyToModel``
over those ranks, as the self-attention's do.

**Serving over ``model``** (``prefill`` / ``decode_step(tp=)``, a serve
step's ``distributed.tp.StepParallel``): the same blocks, the cross K/V
of the rank's rows and kv-heads; the decoder's pool has no batch
dimension, so it is replicated over the batch axes and every replica
writes every row's K/V (:func:`prefill`).  Under the rule variants the
pool and the cross K/V take the plan's blocks (every head under
``serve_kv_dp``, a head_dim block under ``serve_dh``; ``serve_seq`` splits
the pool's pages and keeps the cross K/V by kv-heads), and a decode step's
cross-attention reads them so (``serve_dh``: ``tp.dh_attention``).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm
from repro_torch.models import dense
from repro_torch.models.common import PSpec

# decoder prefix of an enc-dec prefill shape: seq_len / 8 tokens beside
# seq_len encoder frames
DEC_PREFIX_FRACTION = 8


def template(cfg: ModelConfig) -> Dict[str, Any]:
    d, v = cfg.d_model, cfg.vocab_size
    Le, Ld = cfg.enc_layers, cfg.dec_layers
    return {
        'embed': PSpec((v, d), ('vocab', 'embed'),
                       scale=d ** -0.5),           # tied-unembed-safe
        # (V, D): the reference's (D, V) transposed, same law (fan_in = d)
        'unembed': PSpec((v, d), ('vocab', 'embed'), scale=d ** -0.5),
        'frontend_proj': PSpec((d, d), ('embed', 'embed')),  # audio stub
        'enc_final_norm': PSpec((d,), ('embed',), 'ones'),
        'final_norm': PSpec((d,), ('embed',), 'ones'),
        'enc_layers': {
            'ln1': PSpec((Le, d), ('layers', 'embed'), 'ones'),
            'ln2': PSpec((Le, d), ('layers', 'embed'), 'ones'),
            **dense.attn_template(cfg, Le),
            **dense.mlp_template(cfg, Le),
        },
        'dec_layers': {
            'ln1': PSpec((Ld, d), ('layers', 'embed'), 'ones'),
            'ln2': PSpec((Ld, d), ('layers', 'embed'), 'ones'),
            'ln_cross': PSpec((Ld, d), ('layers', 'embed'), 'ones'),
            **dense.attn_template(cfg, Ld),
            **{f'x{k}': s for k, s in dense.attn_template(cfg, Ld).items()},
            **dense.mlp_template(cfg, Ld),
        },
    }


def _xlp(lp):
    """The cross-attention weights of a decoder layer (keys prefixed with
    'x', the prefix stripped)."""
    return {k[1:]: v for k, v in lp.items() if k.startswith('x')}


def _positions(b: int, s: int, device):
    return torch.arange(s, device=device).expand(b, s)


def encode(cfg: ModelConfig, params, frames, tp=None):
    """frames: (B, S_enc, D) stub embeddings -> encoder output (B, S_enc,
    D).  The frames are rounded to bf16 first, as in the reference.
    ``tp``: a tensor-parallel rank's blocks (module docstring)."""
    b, s, _ = frames.shape
    proj = params['frontend_proj']
    h = frames.to(cm.DEFAULT_DTYPE).to(proj.dtype) @ proj
    positions = _positions(b, s, frames.device)
    for lp in cm.layer_views(params, 'enc_layers'):
        x = cm.rms_norm(h, lp['ln1'], cfg.norm_eps)
        h = h + dense.self_attn_train(cfg, lp, x, positions, tp=tp,
                                      causal=False)
        h = dense._mlp(cfg, lp, h, tp)
    return cm.rms_norm(h, params['enc_final_norm'], cfg.norm_eps)


def cross_kv(cfg: ModelConfig, params, enc_out, tp=None):
    """The cross-attention K/V of every decoder layer: (Ld, B, S_enc, Hkv,
    Dh) each (a tensor-parallel rank's kv-heads under ``tp``)."""
    b, s, _ = enc_out.shape
    if tp is not None:
        enc_out = tp.copy(enc_out, tp.attn_split)
    ks, vs = [], []
    for lp in cm.layer_views(params, 'dec_layers'):
        xlp = _xlp(lp)
        if tp is not None:
            xlp = tp.attn_weights(xlp)
        k, v = enc_out @ xlp['wk'], enc_out @ xlp['wv']
        if cfg.attn_bias and 'bk' in xlp:
            k, v = k + xlp['bk'], v + xlp['bv']
        ks.append(k.reshape(b, s, -1, cfg.hd))
        vs.append(v.reshape(b, s, -1, cfg.hd))
    return torch.stack(ks), torch.stack(vs)


def _cross_attn(cfg: ModelConfig, lp, x, positions, xk, xv, tp=None,
                cached: bool = False):
    """Cross-attention of x (B, T, D) over xk/xv, this call's cross K/V
    (the rank's kv-heads, or every head) or, ``cached``, the cache's block
    (under a rule variant: every head, or a head_dim block)."""
    b, t, _ = x.shape
    xlp = _xlp(lp)
    if tp is not None:
        x = tp.copy(x, tp.attn_split)
    q = x @ xlp['wq']
    if cfg.attn_bias and 'bq' in xlp:
        q = q + xlp['bq']
    q = q.reshape(b, t, -1, cfg.hd)
    if cached and tp is not None and tp.placement == 'dh':
        every = torch.ones((b, t, xk.shape[1]), dtype=torch.bool,
                           device=x.device)
        out = tp.dh_attention(q, xk, xv, every)
        return dense._out_proj(out.reshape(b, t, -1), xlp['wo'], tp)
    if cached and tp is not None and tp.placement == 'kv_dp':
        lo, hi = tp.own('kv')
        xk, xv = xk[..., lo:hi, :], xv[..., lo:hi, :]
    out = cm.chunked_attention(q, xk, xv, q_positions=positions,
                               kv_positions=_positions(b, xk.shape[1],
                                                       x.device),
                               causal=False)
    return dense._out_proj(out.reshape(b, t, -1), xlp['wo'], tp)


def dec_layer(cfg: ModelConfig, lp, h, positions, mode, pool_k, pool_v,
              page_table, xk, xv, tp=None):
    """One decoder layer.  ``mode``: ``train`` (no cache), ``prefill``
    (positions (B, S); K/V into the pools), ``decode`` (positions (B,);
    the pools read through the page table).  xk/xv: this layer's cross
    K/V (B, S_enc, Hkv, Dh).  ``tp``: a rank's blocks; serving, ``h`` and
    xk/xv hold the rank's rows and ``positions`` / ``page_table`` every
    row's, for the write into the replicated pool (:func:`prefill`)."""
    x = cm.rms_norm(h, lp['ln1'], cfg.norm_eps)
    if mode == 'train':
        h = h + dense.self_attn_train(cfg, lp, x, positions, tp=tp)
    elif mode == 'prefill':
        h = h + dense.self_attn_prefill(cfg, lp, x, positions, pool_k,
                                        pool_v, page_table, tp=tp)
    else:
        h = h + dense.self_attn_decode(cfg, lp, x, positions, pool_k, pool_v,
                                       page_table, tp=tp)
    x = cm.rms_norm(h, lp['ln_cross'], cfg.norm_eps)
    if positions.dim() == 1 and tp is not None:
        positions = tp.local(positions)
    pos2d = positions if positions.dim() == 2 else positions[:, None]
    h = h + _cross_attn(cfg, lp, x, pos2d, xk, xv, tp, mode == 'decode')
    return dense._mlp(cfg, lp, h, tp)


def forward_train(cfg: ModelConfig, params, batch, *, tp=None):
    """Mean next-token NLL of batch['labels'] (B, S) given
    batch['tokens'] (B, S) and batch['frames'] (B, S_enc, D), masked by
    batch['loss_mask'] if present.  Each decoder layer is checkpointed
    under autograd, as the reference's ``scan_dec``; the encoder is not.
    ``tp``: a tensor-parallel rank's weight blocks (module docstring).
    -> (loss, {'tokens': count})."""
    tokens = batch['tokens']
    b, s = tokens.shape
    xks, xvs = cross_kv(cfg, params, encode(cfg, params, batch['frames'], tp),
                        tp)
    positions = _positions(b, s, tokens.device)
    h = dense.embed_inputs(cfg, params, tokens, tp=tp)
    for lp, xk, xv in zip(cm.layer_views(params, 'dec_layers'),
                          xks.unbind(0), xvs.unbind(0)):
        h = cm.remat(lambda h, lp, xk, xv: dec_layer(
            cfg, lp, h, positions, 'train', None, None, None, xk, xv, tp),
            h, lp, xk, xv)
    nll, cnt = cm.chunked_ce_loss(
        h, params['final_norm'], params['unembed'], batch['labels'],
        mask=batch.get('loss_mask'), eps=cfg.norm_eps,
        tp=tp)
    return nll / torch.clamp_min(cnt, 1.0), {'tokens': cnt}


def prefill(cfg: ModelConfig, params, cache, batch, *, tp=None):
    """Encode the frames, compute the cross K/V, prefill the decoder
    prefix.  batch: frames (B, S_enc, D), tokens (B, S), page_table (B, >=
    ceil(S / page)).  The cache's ``cross_k`` / ``cross_v`` (Ld, B, S_enc,
    Hkv, Dh) take the cross K/V.  ``tp``: a serve step's plan
    (``distributed.tp.StepParallel``): the rank's rows and weight blocks,
    its kv-heads of the cross K/V and of the decoder's one pool, which has
    no batch dimension and is replicated over the batch axes, so the new
    K/V of every row are gathered and written by every replica.  -> (cache,
    (B, V) f32 scores of the last token; under ``tp`` the rank's rows over
    its vocabulary block)."""
    tokens = batch['tokens']
    b, s = tokens.shape
    xks, xvs = cross_kv(cfg, params, encode(cfg, params, batch['frames'], tp),
                        tp)
    # the cache's block: the rank's kv-heads, or under a rule variant every
    # head or a head_dim block
    held_k, held_v = ((xks, xvs) if tp is None else
                      (tp.pool_kv(xks, paged=False),
                       tp.pool_kv(xvs, paged=False)))
    if cache['cross_k'].shape != held_k.shape:
        raise ValueError(f'cross K/V {tuple(held_k.shape)} does not fit the '
                         f'cache\'s {tuple(cache["cross_k"].shape)}')
    cache['cross_k'].copy_(held_k)
    cache['cross_v'].copy_(held_v)
    positions = _positions(b, s, tokens.device)
    page_table = dense._row_ops(tp)[1](batch['page_table'])
    h = dense.embed_inputs(cfg, params, tokens, tp=tp)
    for i, lp in enumerate(cm.layer_views(params, 'dec_layers')):
        h = dec_layer(cfg, lp, h, positions, 'prefill', cache['k'][i],
                      cache['v'][i], page_table, xks[i], xvs[i], tp)
    last = cm.rms_norm(h[:, -1], params['final_norm'], cfg.norm_eps)
    return cache, dense.head_scores(last, params['unembed'], tp)


def decode_step(cfg: ModelConfig, params, cache, batch, *, tp=None):
    """tokens (B,), positions (B,), page_table (B, maxp) -> (cache one
    token on, (B, V) f32 scores).  ``tp``: as :func:`prefill`."""
    every_row = dense._row_ops(tp)[1]
    positions = every_row(batch['positions'])
    page_table = every_row(batch['page_table'])
    h = dense.embed_inputs(cfg, params, batch['tokens'], tp=tp)[:, None, :]
    for i, lp in enumerate(cm.layer_views(params, 'dec_layers')):
        h = dec_layer(cfg, lp, h, positions, 'decode', cache['k'][i],
                      cache['v'][i], page_table, cache['cross_k'][i],
                      cache['cross_v'][i], tp)
    last = cm.rms_norm(h[:, 0], params['final_norm'], cfg.norm_eps)
    return cache, dense.head_scores(last, params['unembed'], tp)


def cache_template(cfg: ModelConfig, n_pages: int, batch: int, enc_len: int):
    """The decoder's paged self-attention KV (Ld, P, pg, Hkv, Dh), global
    layout, and the dense cross K/V (Ld, B, enc_len, Hkv, Dh)."""
    Ld = cfg.dec_layers
    kv_shape = (Ld, n_pages, cfg.page_size, cfg.n_kv_heads, cfg.hd)
    x_shape = (Ld, batch, enc_len, cfg.n_kv_heads, cfg.hd)
    kv_axes = ('layers', 'pages', None, 'kv_heads', 'head_dim')
    x_axes = ('layers', 'batch', None, 'kv_heads', 'head_dim')
    return {'k': PSpec(kv_shape, kv_axes, 'zeros'),
            'v': PSpec(kv_shape, kv_axes, 'zeros'),
            'cross_k': PSpec(x_shape, x_axes, 'zeros'),
            'cross_v': PSpec(x_shape, x_axes, 'zeros')}
