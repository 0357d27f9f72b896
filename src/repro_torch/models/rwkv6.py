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
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rwkv6.ops import wkv6
from repro_torch.kernels.rwkv6.ref import wkv6_chunked, wkv6_step
from repro_torch.kernels.sampling.ref import unembed_scores
from repro_torch.models import common as cm
from repro_torch.models.common import PSpec

LORA_DIM = 32


def template(cfg: ModelConfig) -> Dict[str, Any]:
    L, d, f, v = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    hd = cfg.ssm_head_dim
    h = d // hd
    return {
        'embed': PSpec((v, d), scale=d ** -0.5),
        'final_norm': PSpec((d,), 'ones'),
        # (V, D): the reference's (D, V) transposed; the law is the
        # reference's fan_in = d, stated because shape[-2] here is V
        'unembed': PSpec((v, d), scale=d ** -0.5),
        'layers': {
            'ln1': PSpec((L, d), 'ones'),
            'ln2': PSpec((L, d), 'ones'),
            # time mix
            'mu': PSpec((L, 5, d), 'zeros'),            # r, k, v, w, g
            'w_base': PSpec((L, d), 'zeros'),
            'w_A': PSpec((L, d, LORA_DIM)),
            'w_B': PSpec((L, LORA_DIM, d), scale=0.1),
            'Wr': PSpec((L, d, d)),
            'Wk': PSpec((L, d, d)),
            'Wv': PSpec((L, d, d)),
            'Wg': PSpec((L, d, d)),
            'Wo': PSpec((L, d, d)),
            'u': PSpec((L, h, hd), 'zeros'),
            'ln_x': PSpec((L, d), 'ones'),
            # channel mix
            'mu_cm': PSpec((L, 2, d), 'zeros'),
            'Wk_cm': PSpec((L, d, f)),
            'Wv_cm': PSpec((L, f, d)),
            'Wr_cm': PSpec((L, d, d)),
        },
    }


def cache_template(cfg: ModelConfig, batch_size: int) -> Dict[str, PSpec]:
    """The recurrent state as an inference cache: ``wkv`` (L, B, H, K, V)
    f32 and the token shift states ``shift_tm`` / ``shift_cm`` (L, B, D)
    in the model dtype, zeros."""
    d, hd, L = cfg.d_model, cfg.ssm_head_dim, cfg.n_layers
    shift = (L, batch_size, d)
    return {'wkv': PSpec((L, batch_size, d // hd, hd, hd), 'zeros',
                         dtype=torch.float32),
            'shift_tm': PSpec(shift, 'zeros'),
            'shift_cm': PSpec(shift, 'zeros')}


def init_state(cfg: ModelConfig, batch_size: int, *, device):
    """Recurrent state, zeros (:func:`cache_template`)."""
    return cm.zeros_from_template(cache_template(cfg, batch_size), device)


def _shift(x, last):
    """Token shift: x_{t-1}, with ``last`` filling t = 0.  x: (B, T, D)."""
    return torch.cat([last[:, None, :].to(x.dtype), x[:, :-1]], dim=1)


def time_mix(cfg: ModelConfig, lp, x, shift_state, wkv_state, *,
             use_kernel: bool = False):
    """-> (output (B, T, D), new shift state x[:, -1], new wkv state)."""
    b, t, d = x.shape
    hd = cfg.ssm_head_dim
    h = d // hd
    xs = _shift(x, shift_state)
    mu = lp['mu']
    xr, xk, xv, xw, xg = (x + (xs - x) * mu[i] for i in range(5))
    r = (xr @ lp['Wr']).reshape(b, t, h, hd).float()
    k = (xk @ lp['Wk']).reshape(b, t, h, hd).float()
    v = (xv @ lp['Wv']).reshape(b, t, h, hd).float()
    g = xg @ lp['Wg']
    w_raw = (lp['w_base'].float()
             + torch.tanh(xw.float() @ lp['w_A'].float()) @ lp['w_B'].float())
    w = torch.exp(-torch.exp(w_raw)).reshape(b, t, h, hd)  # (0, 1)
    u = lp['u'].float()
    if t == 1:
        y, wkv_state = wkv6_step(r[:, 0], k[:, 0], v[:, 0], w[:, 0], u,
                                 wkv_state)
        y = y[:, None]
    elif use_kernel:
        y, wkv_state = wkv6(r, k, v, w, u, wkv_state)
    else:
        y, wkv_state = wkv6_chunked(r, k, v, w, u, wkv_state)
    # per-head group norm, then the gate
    y = cm.rms_norm(y, torch.ones(hd, dtype=y.dtype, device=y.device), 64e-5)
    y = y.reshape(b, t, d).to(x.dtype) * lp['ln_x']
    y = y * F.silu(g.float()).to(x.dtype)
    return y @ lp['Wo'], x[:, -1], wkv_state


def channel_mix(cfg: ModelConfig, lp, x, shift_state):
    """-> (output (B, T, D), new shift state x[:, -1])."""
    xs = _shift(x, shift_state)
    mu = lp['mu_cm']
    xk = x + (xs - x) * mu[0]
    xr = x + (xs - x) * mu[1]
    k = torch.square(torch.relu(xk @ lp['Wk_cm']))
    out = torch.sigmoid((xr @ lp['Wr_cm']).float()).to(x.dtype) \
        * (k @ lp['Wv_cm'])
    return out, x[:, -1]


def layer_apply(cfg: ModelConfig, lp, h, state_l, *, use_kernel: bool = False):
    """One layer; ``state_l`` = {'wkv', 'shift_tm', 'shift_cm'} of this
    layer.  -> (h, new state of this layer)."""
    x = cm.rms_norm(h, lp['ln1'], cfg.norm_eps)
    tm_out, shift_tm, wkv = time_mix(cfg, lp, x, state_l['shift_tm'],
                                     state_l['wkv'], use_kernel=use_kernel)
    h = h + tm_out
    x = cm.rms_norm(h, lp['ln2'], cfg.norm_eps)
    cm_out, shift_cm = channel_mix(cfg, lp, x, state_l['shift_cm'])
    return h + cm_out, {'wkv': wkv, 'shift_tm': shift_tm,
                        'shift_cm': shift_cm}


def forward_train(cfg: ModelConfig, params, batch, *,
                  use_kernel: bool = False):
    """Mean next-token NLL of batch['labels'] (B, T) given batch['tokens']
    (B, T), masked by batch['loss_mask'] if present, from a zero state.
    -> (loss, {'tokens': count})."""
    tokens = batch['tokens']
    h = params['embed'][tokens.long()]
    state = init_state(cfg, tokens.shape[0], device=h.device)
    for i in range(cfg.n_layers):
        lp = {k: w[i] for k, w in params['layers'].items()}
        h, _ = layer_apply(cfg, lp, h, {k: s[i] for k, s in state.items()},
                           use_kernel=use_kernel)
    nll, cnt = cm.chunked_ce_loss(
        h, params['final_norm'], params['unembed'], batch['labels'],
        mask=batch.get('loss_mask'), eps=cfg.norm_eps)
    return nll / torch.clamp_min(cnt, 1.0), {'tokens': cnt}


def _run_layers(cfg: ModelConfig, params, h, cache, use_kernel: bool):
    """Every layer from the state in ``cache``, which takes the state
    after, in place.  -> the last layer's output (B, T, D)."""
    for i in range(cfg.n_layers):
        lp = {k: w[i] for k, w in params['layers'].items()}
        h, new = layer_apply(cfg, lp, h, {k: s[i] for k, s in cache.items()},
                             use_kernel=use_kernel)
        for k, s in new.items():
            cache[k][i].copy_(s)
    return h


def prefill(cfg: ModelConfig, params, cache, batch, *,
            use_kernel: bool = False):
    """tokens (B, T) from the state in ``cache`` -> (cache holding the
    state after the prompt, (B, V) f32 scores of the last token).  The
    WKV6 kernel carries the state with ``use_kernel``."""
    h = params['embed'][batch['tokens'].long()]
    h = _run_layers(cfg, params, h, cache, use_kernel)
    last = cm.rms_norm(h[:, -1], params['final_norm'], cfg.norm_eps)
    return cache, unembed_scores(last, params['unembed'])


def decode_step(cfg: ModelConfig, params, cache, batch):
    """tokens (B,) -> (cache one token on, (B, V) f32 scores); each layer
    takes the single-token recurrence step."""
    h = params['embed'][batch['tokens'].long()][:, None, :]
    h = _run_layers(cfg, params, h, cache, False)
    last = cm.rms_norm(h[:, 0], params['final_norm'], cfg.norm_eps)
    return cache, unembed_scores(last, params['unembed'])
