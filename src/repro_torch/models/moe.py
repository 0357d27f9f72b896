"""Mixture-of-Experts decoder (phi3.5-moe 16e top-2, llama4-scout 16e top-1
+ shared expert) in PyTorch: the serving entry points of the reference's
``models/moe.py``.

Routing is capacity-based (Switch-style), with the reference's semantics
exactly: f32 router scores, softmax, top-k (ties to the lower expert id),
the top-k weights renormalised; each assignment ranked within its expert in
token-major order; assignments ranked at or past ``cap = ceil(k N / E *
capacity_factor)`` dropped.  The kept rows go into a dense (E, C, D)
buffer, the experts run as three batched products over E, and each token
sums its k weighted outputs in k order.  The capacity counts every token of
the call, padding included, so what a dispatch holds decides which tokens
drop.

Attention, KV writes and the decode kernels are the dense decoder's: the
entry points run ``models/dense.py``'s layer loops with :func:`moe_block`
as the MLP.  Each entry takes the reference's capacity factor: 1.25 for
whole-prompt ``prefill``, 2.0 for ``prefill_chunk`` and ``decode_step``.
``prefill`` has no kernel path (the reference's has none); ``decode_step``
reads through the paged-decode kernel with ``use_kernel`` and through the
prefix-shared kernels when the batch carries ``shared``.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm
from repro_torch.models import dense
from repro_torch.models.common import PSpec

PREFILL_CAPACITY = 1.25
SERVE_CAPACITY = 2.0       # prefill_chunk and decode_step


def template(cfg: ModelConfig) -> Dict[str, Any]:
    L, d, f, e = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.n_experts
    t = dense.template(cfg)
    layers = t['layers']
    for k in ('wg', 'wu', 'wd'):
        del layers[k]
    layers['router'] = PSpec((L, d, e), scale=d ** -0.5)
    layers['we_gate'] = PSpec((L, e, d, f))
    layers['we_up'] = PSpec((L, e, d, f))
    layers['we_down'] = PSpec((L, e, f, d))
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        layers['ws_gate'] = PSpec((L, d, fs))
        layers['ws_up'] = PSpec((L, d, fs))
        layers['ws_down'] = PSpec((L, fs, d))
    return t


def route(cfg: ModelConfig, lp, xf, capacity_factor: float):
    """Top-k routing with capacity.  xf: (N, D) -> (probs (N, E) f32, top_i
    (N, k) expert ids, top_w (N, k) f32 renormalised weights, pos (N*k,) the
    rank of each token-major assignment in its expert, cap)."""
    n = xf.shape[0]
    e, k = cfg.n_experts, cfg.moe_top_k
    probs = torch.softmax(xf.float() @ lp['router'].float(), dim=-1)
    # a stable descending sort: equal probabilities keep the lower expert
    # id first, as jax.lax.top_k does (torch.topk promises no order)
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[:, :k], top_i[:, :k]
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    onehot = F.one_hot(top_i.reshape(-1), e)
    pos = (onehot.cumsum(0) * onehot).sum(-1) - 1
    cap = int(math.ceil(k * n / e * capacity_factor))
    return probs, top_i, top_w, pos, cap


def moe_mlp(cfg: ModelConfig, lp, x, *,
            capacity_factor: float = PREFILL_CAPACITY):
    """x: (B, S, D) -> (B, S, D), the Switch load-balance aux loss (f32
    scalar; serving ignores it)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    n = b * s
    xf = x.reshape(n, d)
    probs, top_i, top_w, pos, cap = route(cfg, lp, xf, capacity_factor)
    flat_e = top_i.reshape(-1)
    keep = pos < cap
    tok = torch.arange(n * k, device=x.device) // k

    # each kept row to its (expert, rank) slot, every dropped row to one
    # spare slot past the end that is cut off: selecting the kept rows by
    # mask would sync the host with the device in every layer
    slot = torch.where(keep, flat_e * cap + pos, e * cap)
    buf = x.new_zeros((e * cap + 1, d))
    buf[slot] = xf[tok]
    buf = buf[:-1].view(e, cap, d)
    g = torch.bmm(buf, lp['we_gate'])
    u = torch.bmm(buf, lp['we_up'])
    h = F.silu(g.float()).to(x.dtype) * u
    out = torch.bmm(h, lp['we_down'])                 # (E, C, D)

    gathered = out[flat_e, pos.clamp(max=cap - 1)]    # (N*k, D)
    contrib = torch.where(keep[:, None],
                          gathered * top_w.reshape(-1, 1).to(x.dtype),
                          torch.zeros_like(gathered)).reshape(n, k, d)
    y = torch.zeros_like(xf)
    for j in range(k):          # the reference's scatter-add, in k order
        y = y + contrib[:, j]
    if cfg.n_shared_experts:
        y = y + cm.swiglu(xf, lp['ws_gate'], lp['ws_up'], lp['ws_down'])

    frac = F.one_hot(top_i, e).float().mean(dim=(0, 1))
    aux = e * (frac * probs.mean(0)).sum()
    return y.reshape(b, s, d), aux


def moe_block(cfg: ModelConfig, lp, h, *, capacity_factor: float):
    """The MoE layer's MLP block for the dense loops: pre-norm routed
    experts plus the residual."""
    x = cm.rms_norm(h, lp['ln2'], cfg.norm_eps)
    return h + moe_mlp(cfg, lp, x, capacity_factor=capacity_factor)[0]


def prefill(cfg: ModelConfig, params, cache, batch):
    """Whole-prompt prefill (see ``dense.prefill``), capacity factor 1.25,
    attention by the plain path."""
    return dense.prefill(cfg, params, cache, batch, mlp=functools.partial(
        moe_block, capacity_factor=PREFILL_CAPACITY))


def prefill_chunk(cfg: ModelConfig, params, cache, batch):
    """Chunked prefill with past-KV readback (see ``dense.prefill_chunk``),
    capacity factor 2.0."""
    return dense.prefill_chunk(cfg, params, cache, batch, mlp=functools.partial(
        moe_block, capacity_factor=SERVE_CAPACITY))


def decode_step(cfg: ModelConfig, params, cache, batch, *,
                use_kernel: bool = False):
    """One token a row (see ``dense.decode_step``), capacity factor 2.0."""
    return dense.decode_step(cfg, params, cache, batch, use_kernel=use_kernel,
                             mlp=functools.partial(
                                 moe_block, capacity_factor=SERVE_CAPACITY))


cache_template = dense.cache_template
