"""RWKV6 "Finch" (rwkv6-3b) in PyTorch: the training forward of the
reference's ``models/rwkv6.py`` [arXiv:2404.05892].

Time mix per head (K = V = head dim):
    y_t = r_t . (S_{t-1} + (u k_t)^T v_t),   S_t = diag(w_t) S_{t-1} + k_t^T v_t
with the data-dependent decay w_t = exp(-exp(w_base + tanh(x_w A) B)).
The sequence runs through the WKV6 kernel (``use_kernel=True``) or the
chunk-parallel plain form at chunk 32; a single token takes the exact step.
All three get f32 r/k/v/w/u and the f32 state.

Inference: ``prefill`` runs a prompt from a given recurrent state (the
cache of :func:`cache_template`) and ``decode_step`` one token a row; both
write the state after into the cache in place and return f32 scores of
the last token.  ``prefill(use_kernel=True)`` carries the state through
the WKV6 kernel, as the reference's ``time_mix`` does; the default is the
plain chunked path, as in the reference.

A Python loop over layers replaces ``lax.scan``.  The output head
``unembed`` is stored (V, D) row-major, like the dense family's, and
scores are ``h @ unembed.T``.

**Over ``model``** (``forward_train(tp=)``, a ``distributed.tp.
TensorParallel``; ``prefill`` / ``decode_step(tp=)``, a serve step's
``distributed.tp.StepParallel``), each rank holds the reference's blocks
(``shaped_spec``): ``Wr``, ``Wk`` and ``Wr_cm`` a contiguous block of
d_model's columns (``'qkv'``), a ``d_ff`` block of ``Wk_cm`` / ``Wv_cm``,
the embedding and the head by vocabulary, and ``mu``, ``mu_cm``, the
decay's ``w_base`` / ``w_A`` / ``w_B``, ``ln_x`` and the norms
replicated (``'embed'``).  Where the time mix lies is ``tp.wkv_mode``:

- ``'heads'`` (``model`` divides the wkv heads): whole heads, the columns
  of ``Wr``/``Wk``/``Wv``/``Wg``, the rows of ``Wo``, ``u`` and the
  ``wkv`` state's heads; the recurrence and the group norm are
  head-local, and each rank reads its heads' channels of the replicated
  decay and ``ln_x``;
- ``'values'`` (rwkv6-3b's 40 heads on 16 ranks): value channels [v0, v1)
  of every head -- ``Wv``/``Wg`` columns and ``Wo`` rows strided over the
  heads, the ``wkv`` state (L, B, H, K, V/n), ``u`` cut on K.  The state
  ``S[k, v]`` decays by ``w[k]`` and ``y[v]`` sums over k, so each value
  channel is its own recurrence: ``r`` and ``k`` are gathered whole (a
  reduce-scatter backward: each rank's use is a share), ``w`` is computed
  whole from the replicated decay, and the per-head group norm sums its
  f32 squares over ``model`` (``tp.value_norm``).  ``prefill(use_kernel=
  True, tp=)`` runs the WKV6 kernel over every head's block (V = 4 at 16
  ranks);
- ``'every'`` (``serve_kv_dp``): contiguous d/n blocks of every
  projection, ``r``/``k``/``v`` gathered, every head run on every rank
  (``u`` and the state replicated), the rank's channels taken into the
  gate and ``Wo``;
- None (``serve_dh``, one rank): the time mix replicated, ``u`` cut on K
  and gathered whole where ``model`` > 1.

``Wo`` and ``Wv_cm`` are row-parallel products (an f32 sum over the
ranks, rounded once); the channel mix's sigmoid gate is computed on the
rank's ``Wr_cm`` columns and gathered whole, so it multiplies the reduced
product.  Where no batch axis divides a serve step's rows (long_500k's
one row under a variant: ``tp.moved``), the cache holds each state's
block of the reference's spec, and a layer reads and writes its state
through ``tp.layer_state`` / ``tp.put_layer_state``.  Under autograd the
mixes enter the rank's columns through
``tp.copy``, and a replicated leaf a rank reads only in part (the decay,
``ln_x``, ``u`` under ``'every'``) through ``tp.head_share``: every
replicated leaf gets the whole gradient, bit-equal on every rank.  The
cache's token shift states hold the rank's rows (every channel); the
scores are its vocabulary block.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.tp import WKV_EVERY, WKV_HEADS, WKV_VALUES
from repro_torch.kernels.rwkv6.ops import wkv6
from repro_torch.kernels.rwkv6.ref import wkv6_chunked, wkv6_step
from repro_torch.models import common as cm
from repro_torch.models.dense import embed_inputs, head_scores
from repro_torch.models.common import PSpec

LORA_DIM = 32


def template(cfg: ModelConfig) -> Dict[str, Any]:
    L, d, f, v = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    hd = cfg.ssm_head_dim
    h = d // hd
    return {
        'embed': PSpec((v, d), ('vocab', 'embed'), scale=d ** -0.5),
        'final_norm': PSpec((d,), ('embed',), 'ones'),
        # (V, D): the reference's (D, V) transposed; the law is the
        # reference's fan_in = d, stated because shape[-2] here is V
        'unembed': PSpec((v, d), ('vocab', 'embed'), scale=d ** -0.5),
        'layers': {
            'ln1': PSpec((L, d), ('layers', 'embed'), 'ones'),
            'ln2': PSpec((L, d), ('layers', 'embed'), 'ones'),
            # time mix
            'mu': PSpec((L, 5, d), ('layers', None, 'embed'),
                        'zeros'),                    # r, k, v, w, g
            'w_base': PSpec((L, d), ('layers', 'embed'), 'zeros'),
            'w_A': PSpec((L, d, LORA_DIM), ('layers', 'embed', None)),
            'w_B': PSpec((L, LORA_DIM, d), ('layers', None, 'embed'),
                         scale=0.1),
            'Wr': PSpec((L, d, d), ('layers', 'embed', 'qkv')),
            'Wk': PSpec((L, d, d), ('layers', 'embed', 'qkv')),
            'Wv': PSpec((L, d, d), ('layers', 'embed', 'qkv')),
            'Wg': PSpec((L, d, d), ('layers', 'embed', 'qkv')),
            'Wo': PSpec((L, d, d), ('layers', 'qkv', 'embed')),
            'u': PSpec((L, h, hd), ('layers', 'heads', 'head_dim'), 'zeros'),
            'ln_x': PSpec((L, d), ('layers', 'embed'), 'ones'),
            # channel mix
            'mu_cm': PSpec((L, 2, d), ('layers', None, 'embed'), 'zeros'),
            'Wk_cm': PSpec((L, d, f), ('layers', 'embed', 'ffn')),
            'Wv_cm': PSpec((L, f, d), ('layers', 'ffn', 'embed')),
            'Wr_cm': PSpec((L, d, d), ('layers', 'embed', 'qkv')),
        },
    }


def placement(tp) -> Dict[str, Dict[int, Any]]:
    """A tensor-parallel rank's blocks of the layer stack's leaves, {name:
    {dim: [lo, hi) or several of them}}, under ``tp``'s ``wkv_mode`` (the
    module docstring): ``Wr`` / ``Wk`` / ``Wr_cm`` the rank's contiguous
    columns ``tp.wkv``; ``Wv`` / ``Wg`` columns and ``Wo`` rows its heads'
    channels, its value channels of every head (``tp.value_columns()``),
    or the contiguous block; ``u`` by heads or on K (``tp.u_dim``); the
    ``d_ff`` block ``tp.ffn`` of ``Wk_cm`` / ``Wv_cm``.  A leaf it does
    not name (``mu``, ``mu_cm``, ``w_base``, ``w_A``, ``w_B``, ``ln_x``,
    the norms) is replicated, as the reference's ``'embed'`` axis is."""
    table = {'Wk_cm': {2: tp.ffn}, 'Wv_cm': {1: tp.ffn}}
    if tp.u_dim is not None:
        table['u'] = {2: tp.u_dim}
    if tp.wkv_mode is None:
        return table
    cols, hd = tp.wkv, tp.cfg.ssm_head_dim
    own = tp.value_columns() if tp.wkv_mode == WKV_VALUES else cols
    if tp.wkv_mode == WKV_HEADS:
        table['u'] = {1: (cols[0] // hd, cols[1] // hd)}
    table.update(Wr={2: cols}, Wk={2: cols}, Wv={2: own}, Wg={2: own},
                 Wo={1: own}, Wr_cm={2: cols})
    return table


def cache_template(cfg: ModelConfig, batch_size: int) -> Dict[str, PSpec]:
    """The recurrent state as an inference cache: ``wkv`` (L, B, H, K, V)
    f32 and the token shift states ``shift_tm`` / ``shift_cm`` (L, B, D)
    in the model dtype, zeros."""
    d, hd, L = cfg.d_model, cfg.ssm_head_dim, cfg.n_layers
    shift = (L, batch_size, d)
    shift_axes = ('layers', 'batch', 'embed')
    return {'wkv': PSpec((L, batch_size, d // hd, hd, hd),
                         ('layers', 'batch', 'heads', None, None), 'zeros',
                         dtype=torch.float32),
            'shift_tm': PSpec(shift, shift_axes, 'zeros'),
            'shift_cm': PSpec(shift, shift_axes, 'zeros')}


def init_state(cfg: ModelConfig, batch_size: int, *, device):
    """Recurrent state, zeros (:func:`cache_template`)."""
    return cm.zeros_from_template(cache_template(cfg, batch_size), device)


def _shift(x, last):
    """Token shift: x_{t-1}, with ``last`` filling t = 0.  x: (B, T, D)."""
    return torch.cat([last[:, None, :].to(x.dtype), x[:, :-1]], dim=1)


def _identity(x):
    return x


def time_mix(cfg: ModelConfig, lp, x, shift_state, wkv_state, *,
             use_kernel: bool = False, tp=None):
    """-> (output (B, T, D), new shift state x[:, -1], new wkv state).
    ``tp``: a tensor-parallel rank's blocks (module docstring)."""
    b, t, d = x.shape
    hd = cfg.ssm_head_dim
    mode = None if tp is None else tp.wkv_mode
    copy = tp.copy if mode else _identity
    share = tp.head_share if mode else _identity
    # every head's r and k (and under WKV_EVERY v) from the ranks' blocks
    whole = tp.gather_shares if mode in (WKV_VALUES, WKV_EVERY) \
        else _identity
    xs = _shift(x, shift_state)
    mu = lp['mu']
    xr, xk, xv, xw, xg = (x + (xs - x) * mu[i] for i in range(5))
    # -1 heads: a rank's weights may hold its heads only
    r = whole(copy(xr) @ lp['Wr']).reshape(b, t, -1, hd).float()
    k = whole(copy(xk) @ lp['Wk']).reshape(b, t, -1, hd).float()
    v = copy(xv) @ lp['Wv']
    if mode == WKV_EVERY:
        v = whole(v)
    # (B, T, heads, V): a rank's value channels under WKV_VALUES
    v = v.reshape(b, t, r.shape[2], -1).float()
    g = copy(xg) @ lp['Wg']
    # the decay from the replicated w_base / w_A / w_B, for the rank's
    # heads or every head; a rank's use of it is a share of the gradient
    w_base, w_B = share(lp['w_base']), share(lp['w_B'])
    ln_x = share(lp['ln_x'])
    if mode == WKV_HEADS:
        lo, hi = tp.wkv
        w_base, w_B = w_base[..., lo:hi], w_B[..., lo:hi]
    w_raw = (w_base.float()
             + copy(torch.tanh(xw.float() @ lp['w_A'].float()))
             @ w_B.float())
    w = torch.exp(-torch.exp(w_raw)).reshape(b, t, -1, hd)   # (0, 1)
    u = lp['u']
    if mode == WKV_EVERY:           # replicated, read for the rank's heads
        u = tp.head_share(u)
    elif mode == WKV_VALUES:        # cut on K, read for the rank's values
        u = tp.gather_shares(u)
    elif tp is not None and tp.u_dim is not None:    # serve_dh: replicated
        u = tp.whole(u)
    u = u.float()
    if t == 1:
        y, wkv_state = wkv6_step(r[:, 0], k[:, 0], v[:, 0], w[:, 0], u,
                                 wkv_state)
        y = y[:, None]
    elif use_kernel:
        # the kernel reads dense rows (the ranks' gathers are strided)
        y, wkv_state = wkv6(*(x.contiguous() for x in (r, k, v, w, u)),
                            wkv_state)
    else:
        y, wkv_state = wkv6_chunked(r, k, v, w, u, wkv_state)
    # per-head group norm (over every rank's values of a head), the gate
    if mode == WKV_VALUES:
        y = tp.value_norm(y, hd, 64e-5)
    else:
        y = cm.rms_norm(y, torch.ones(hd, dtype=y.dtype, device=y.device),
                        64e-5)
    y = y.reshape(b, t, -1)
    if mode == WKV_EVERY:
        y = y[..., tp.wkv[0]:tp.wkv[1]]
    if mode in (WKV_HEADS, WKV_EVERY):
        ln_x = ln_x[tp.wkv[0]:tp.wkv[1]]
    elif mode == WKV_VALUES:
        ln_x = ln_x.reshape(-1, hd)[:, tp.values[0]:tp.values[1]].flatten()
    y = y.to(x.dtype) * ln_x
    y = y * F.silu(g.float()).to(x.dtype)
    out = tp.row_parallel(y, lp['Wo'], True) if mode else y @ lp['Wo']
    return out, x[:, -1], wkv_state


def channel_mix(cfg: ModelConfig, lp, x, shift_state, tp=None):
    """-> (output (B, T, D), new shift state x[:, -1]).  ``tp``: a
    tensor-parallel rank's ``d_ff`` block and ``Wr_cm`` columns: the gate
    of its columns, gathered, multiplies the reduced product."""
    split = tp is not None and tp.ffn != (0, cfg.d_ff)
    gate_cut = tp is not None and tp.wkv_mode is not None
    xs = _shift(x, shift_state)
    mu = lp['mu_cm']
    xk = x + (xs - x) * mu[0]
    xr = x + (xs - x) * mu[1]
    k = torch.square(torch.relu((tp.copy(xk) if split else xk)
                                @ lp['Wk_cm']))
    kv = tp.row_parallel(k, lp['Wv_cm'], True) if split \
        else k @ lp['Wv_cm']
    gate = torch.sigmoid(((tp.copy(xr) if gate_cut else xr)
                          @ lp['Wr_cm']).float()).to(x.dtype)
    if gate_cut:
        # every rank's columns; kv is whole on every rank, so the gate's
        # gradient is too and the backward keeps the rank's block
        gate = tp.whole(gate)
    return gate * kv, x[:, -1]


def layer_apply(cfg: ModelConfig, lp, h, state_l, *, use_kernel: bool = False,
                tp=None):
    """One layer; ``state_l`` = {'wkv', 'shift_tm', 'shift_cm'} of this
    layer.  -> (h, new state of this layer)."""
    x = cm.rms_norm(h, lp['ln1'], cfg.norm_eps)
    tm_out, shift_tm, wkv = time_mix(cfg, lp, x, state_l['shift_tm'],
                                     state_l['wkv'], use_kernel=use_kernel,
                                     tp=tp)
    h = h + tm_out
    x = cm.rms_norm(h, lp['ln2'], cfg.norm_eps)
    cm_out, shift_cm = channel_mix(cfg, lp, x, state_l['shift_cm'], tp)
    return h + cm_out, {'wkv': wkv, 'shift_tm': shift_tm,
                        'shift_cm': shift_cm}


def forward_train(cfg: ModelConfig, params, batch, *,
                  use_kernel: bool = False, tp=None):
    """Mean next-token NLL of batch['labels'] (B, T) given batch['tokens']
    (B, T), masked by batch['loss_mask'] if present, from a zero state;
    each layer checkpointed under autograd, as in the reference.  The
    WKV6 kernel with ``use_kernel`` has no backward and raises under
    autograd.  ``tp``: a tensor-parallel rank's weight blocks (module
    docstring).  -> (loss, {'tokens': count})."""
    tokens = batch['tokens']
    h = embed_inputs(cfg, params, tokens, tp=tp)
    zero = {k: s[0] for k, s in init_state(cfg, tokens.shape[0],
                                           device=h.device).items()}
    mode = None if tp is None else tp.wkv_mode
    if mode == WKV_HEADS:
        hd = cfg.ssm_head_dim
        zero['wkv'] = zero['wkv'][:, tp.wkv[0] // hd:tp.wkv[1] // hd]
    elif mode == WKV_VALUES:
        zero['wkv'] = zero['wkv'][..., tp.values[0]:tp.values[1]]
    for lp in cm.layer_views(params):
        h = cm.remat(lambda h, lp: layer_apply(cfg, lp, h, zero,
                                               use_kernel=use_kernel,
                                               tp=tp)[0],
                     h, lp)
    nll, cnt = cm.chunked_ce_loss(
        h, params['final_norm'], params['unembed'], batch['labels'],
        mask=batch.get('loss_mask'), eps=cfg.norm_eps, tp=tp)
    return nll / torch.clamp_min(cnt, 1.0), {'tokens': cnt}


def _run_layers(cfg: ModelConfig, params, h, cache, use_kernel: bool,
                tp=None):
    """Every layer from the state in ``cache``, which takes the state
    after, in place (under ``tp`` the rank's blocks of both).  -> the last
    layer's output (B, T, D)."""
    for i, lp in enumerate(cm.layer_views(params)):
        state = {k: cm.layer_state(tp, (k,), s, i) for k, s in cache.items()}
        h, new = layer_apply(cfg, lp, h, state, use_kernel=use_kernel, tp=tp)
        for k, s in new.items():
            cm.put_layer_state(tp, (k,), cache[k], i, s)
    return h


def prefill(cfg: ModelConfig, params, cache, batch, *,
            use_kernel: bool = False, tp=None):
    """tokens (B, T) from the state in ``cache`` -> (cache holding the
    state after the prompt, (B, V) f32 scores of the last token).  The
    WKV6 kernel carries the state with ``use_kernel``.  ``tp``: a
    tensor-parallel rank's step over its weight blocks (module docstring)
    and its wkv heads of the state; the scores are its vocabulary block."""
    h = embed_inputs(cfg, params, batch['tokens'], tp=tp)
    h = _run_layers(cfg, params, h, cache, use_kernel, tp)
    last = cm.rms_norm(h[:, -1], params['final_norm'], cfg.norm_eps)
    return cache, head_scores(last, params['unembed'], tp)


def decode_step(cfg: ModelConfig, params, cache, batch, *, tp=None):
    """tokens (B,) -> (cache one token on, (B, V) f32 scores); each layer
    takes the single-token recurrence step.  ``tp``: as :func:`prefill`."""
    h = embed_inputs(cfg, params, batch['tokens'], tp=tp)[:, None, :]
    h = _run_layers(cfg, params, h, cache, False, tp)
    last = cm.rms_norm(h[:, 0], params['final_norm'], cfg.norm_eps)
    return cache, head_scores(last, params['unembed'], tp)
