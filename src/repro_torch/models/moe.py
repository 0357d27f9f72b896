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
whole-prompt ``prefill`` and ``forward_train``, 2.0 for ``prefill_chunk``
and ``decode_step``.  ``forward_train`` adds the load-balance aux loss,
averaged over layers, at weight 0.01.
``prefill`` has no kernel path (the reference's has none); ``decode_step``
reads through the paged-decode kernel with ``use_kernel`` and through the
prefix-shared kernels when the batch carries ``shared``.

**Data-parallel training** (``forward_train(..., data=)``, a
``distributed.tp.DataShare``): each rank holds a block of the call's
rows, after the lower data ranks' blocks, and routes as the whole call
routes on one device.  An assignment's rank in its expert counts the lower
ranks' assignments to that expert (their per-expert counts, summed over
the data group), the capacity counts every rank's tokens, and the aux
loss's expert fractions are the whole call's; the rank returns its share
of the call's loss (its NLL over every rank's token count, and the aux
terms of its own router probabilities), so the ranks' shares and their
gradients sum to the loss and the gradients of the call.  Serving takes
the same path where a dispatch's rows are split over the batch axes
(``tp.data``, ``distributed/tp.py``): the capacity counts every token of
the dispatch, padding included, on every rank.

**Expert parallelism** (``tp``, a ``distributed.tp.TensorParallel``): a
rank holds its experts (or, where ``model`` does not divide them, every
expert's ``d_ff`` block) and their router columns.  Its router logits are
gathered over ``model`` before the softmax, so every rank routes alike; it
fills only its experts' slots, runs its experts and sums its weighted
contributions in k order as an f32 partial, which the shared expert's
row-parallel partial joins in one ``reduce_sum``, rounded once.  Under
autograd the token rows and the renormalised top-k weights enter the
rank's experts through ``tp.copy`` (their gradients summed over the
ranks), the gathered logits' gradient keeps the rank's columns, and the
aux loss, computed alike on every rank from the replicated probabilities,
enters the objective once.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.tp import f32_product
from repro_torch.models import common as cm
from repro_torch.models import dense
from repro_torch.models.common import PSpec

PREFILL_CAPACITY = 1.25    # prefill and forward_train
SERVE_CAPACITY = 2.0       # prefill_chunk and decode_step
AUX_WEIGHT = 0.01          # the load-balance loss's weight in training


def template(cfg: ModelConfig) -> Dict[str, Any]:
    L, d, f, e = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.n_experts
    t = dense.template(cfg)
    layers = t['layers']
    for k in ('wg', 'wu', 'wd'):
        del layers[k]
    layers['router'] = PSpec((L, d, e), ('layers', 'embed', 'expert'),
                             scale=d ** -0.5)
    layers['we_gate'] = PSpec((L, e, d, f),
                              ('layers', 'expert', 'embed', 'ffn'))
    layers['we_up'] = PSpec((L, e, d, f), ('layers', 'expert', 'embed', 'ffn'))
    layers['we_down'] = PSpec((L, e, f, d),
                              ('layers', 'expert', 'ffn', 'embed'))
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        layers['ws_gate'] = PSpec((L, d, fs), ('layers', 'embed', 'ffn'))
        layers['ws_up'] = PSpec((L, d, fs), ('layers', 'embed', 'ffn'))
        layers['ws_down'] = PSpec((L, fs, d), ('layers', 'ffn', 'embed'))
    return t


def route(cfg: ModelConfig, lp, xf, capacity_factor: float, tp=None):
    """Top-k routing with capacity.  xf: (N, D) -> (probs (N, E) f32, top_i
    (N, k) expert ids, top_w (N, k) f32 renormalised weights, pos (N*k,) the
    rank of each token-major assignment in its expert, cap).  Under ``tp``
    the router is this rank's expert columns, gathered."""
    n = xf.shape[0]
    e, k = cfg.n_experts, cfg.moe_top_k
    logits = xf.float() @ lp['router'].float()
    if tp is not None:
        logits = tp.gather_experts(logits)
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort: equal probabilities keep the lower expert
    # id first, as jax.lax.top_k does (torch.topk promises no order)
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[:, :k], top_i[:, :k]
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    onehot = F.one_hot(top_i.reshape(-1), e)
    pos = (onehot.cumsum(0) * onehot).sum(-1) - 1
    return probs, top_i, top_w, pos, capacity(k, n, e, capacity_factor)


def capacity(k: int, n: int, e: int, capacity_factor: float) -> int:
    """Slots an expert has in a call of ``n`` tokens."""
    return int(math.ceil(k * n / e * capacity_factor))


def moe_mlp(cfg: ModelConfig, lp, x, *,
            capacity_factor: float = PREFILL_CAPACITY, data=None, tp=None):
    """x: (B, S, D) -> (B, S, D), the Switch load-balance aux loss (f32
    scalar; serving ignores it).  ``data``: this rank's rows of a
    data-parallel call (module docstring); the aux loss is then this
    rank's share.  ``tp``: this rank's experts (module docstring)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    n = b * s
    xf = x.reshape(n, d)
    partial = tp is not None and tp.experts_partial
    # under autograd a replicated input of this rank's block has its
    # gradient summed over the ranks: the router's columns, the experts
    xr = tp.copy(xf, tp.expert_split) if tp is not None else xf
    # the meshless call keeps route's four arguments
    probs, top_i, top_w, pos, cap = (
        route(cfg, lp, xr, capacity_factor) if tp is None
        else route(cfg, lp, xr, capacity_factor, tp=tp))
    flat_e = top_i.reshape(-1)
    rows, keep = cap, pos < cap
    if data is not None:
        # ranked after the lower ranks' assignments, against the capacity
        # of every rank's tokens; an expert holds at most n of this rank's.
        # The counts' size is E whatever the routing (a bincount's depends
        # on the data, which the dry-run's shape-only count cannot see)
        counts = F.one_hot(flat_e, e).sum(0)
        cap = capacity(k, n * data.n, e, capacity_factor)
        keep = pos + data.before(counts)[flat_e] < cap
        rows = min(cap, n)
    tok = torch.arange(n * k, device=x.device) // k
    # this rank's experts [lo, hi): every expert but under expert
    # parallelism
    lo, hi = (0, e) if tp is None or not tp.expert_split else tp.experts
    mine = keep & (flat_e >= lo) & (flat_e < hi) if hi - lo < e else keep
    local_e = flat_e - lo

    # each kept row to its (expert, rank) slot, every other row to one
    # spare slot past the end that is cut off: selecting the kept rows by
    # mask would sync the host with the device in every layer
    slot = torch.where(mine, local_e * rows + pos, (hi - lo) * rows)
    xe = tp.copy(xf) if partial else xf
    buf = xf.new_zeros(((hi - lo) * rows + 1, d))
    buf[slot] = xe[tok]
    buf = buf[:-1].view(hi - lo, rows, d)
    g = torch.bmm(buf, lp['we_gate'])
    u = torch.bmm(buf, lp['we_up'])
    h = F.silu(g.float()).to(x.dtype) * u
    out = torch.bmm(h, lp['we_down'])                 # (E, C, D)

    gathered = out[local_e.clamp(0, hi - lo - 1), pos.clamp(max=rows - 1)]
    if not partial:
        contrib = torch.where(keep[:, None],
                              gathered * top_w.reshape(-1, 1).to(x.dtype),
                              torch.zeros_like(gathered)).reshape(n, k, d)
        y = torch.zeros_like(xf)
        for j in range(k):      # the reference's scatter-add, in k order
            y = y + contrib[:, j]
        if cfg.n_shared_experts:
            y = y + _shared(cfg, lp, xf, tp)
    else:
        # this rank's experts' f32 partial, and the shared expert's row-
        # parallel one, summed over the ranks once
        w = tp.copy(top_w).reshape(-1, 1)
        contrib = torch.where(mine[:, None], gathered.float() * w,
                              torch.zeros_like(gathered, dtype=torch.float32)
                              ).reshape(n, k, d)
        part = torch.zeros_like(xf, dtype=torch.float32)
        for j in range(k):
            part = part + contrib[:, j]
        shared_split = cfg.n_shared_experts and _shared_split(cfg, tp)
        if shared_split:
            part = part + cm.swiglu(tp.copy(xf), lp['ws_gate'], lp['ws_up'],
                                    lp['ws_down'], f32_product)
        y = tp.reduce_sum(part, x.dtype)
        if cfg.n_shared_experts and not shared_split:
            y = y + _shared(cfg, lp, xf, None)

    if data is None:
        frac = F.one_hot(top_i, e).float().mean(dim=(0, 1))
        aux = e * (frac * probs.mean(0)).sum()
    else:
        total = n * data.n
        frac = data.sum(counts.float()) / (total * k)
        aux = e * (frac * (probs.sum(0) / total)).sum()
    return y.reshape(b, s, d), aux


def _shared_split(cfg: ModelConfig, tp) -> bool:
    return tp.shared_ffn != (0, cfg.d_ff * cfg.n_shared_experts)


def _shared(cfg: ModelConfig, lp, xf, tp):
    """The shared expert (a SwiGLU); under ``tp`` with its ``d_ff`` split,
    this rank's block, its down product summed over the ranks."""
    if tp is None or not _shared_split(cfg, tp):
        return cm.swiglu(xf, lp['ws_gate'], lp['ws_up'], lp['ws_down'])
    return cm.swiglu(tp.copy(xf), lp['ws_gate'], lp['ws_up'], lp['ws_down'],
                     functools.partial(tp.row_parallel, split=True))


def moe_block(cfg: ModelConfig, lp, h, *, capacity_factor: float, tp=None):
    """The MoE layer's MLP block for the dense loops: pre-norm routed
    experts plus the residual; under ``tp`` a rank's experts (and its
    rows: their routing is the whole dispatch's, ``tp.data``)."""
    x = cm.rms_norm(h, lp['ln2'], cfg.norm_eps)
    return h + moe_mlp(cfg, lp, x, capacity_factor=capacity_factor, tp=tp,
                       data=None if tp is None else tp.data)[0]


def train_layer(cfg: ModelConfig, lp, h, positions, *,
                use_kernel: bool = False, data=None, tp=None):
    """One MoE layer of the training forward (capacity factor 1.25): ->
    (h, the layer's load-balance aux loss)."""
    x = cm.rms_norm(h, lp['ln1'], cfg.norm_eps)
    h = h + dense.self_attn_train(cfg, lp, x, positions,
                                  use_kernel=use_kernel, tp=tp)
    x = cm.rms_norm(h, lp['ln2'], cfg.norm_eps)
    y, aux = moe_mlp(cfg, lp, x, capacity_factor=PREFILL_CAPACITY,
                     data=data, tp=tp)
    return h + y, aux


def forward_train(cfg: ModelConfig, params, batch, *,
                  use_kernel: bool = False, data=None, tp=None):
    """The dense training forward with routed experts: mean NLL plus
    ``AUX_WEIGHT`` times the aux loss averaged over layers; each layer
    checkpointed under autograd.  The capacity counts every token of the
    call (B x S), as in serving.  -> (loss, {'tokens', 'aux_loss'}).
    ``data``: this rank's share of a data-parallel call (module
    docstring); ``aux_loss`` is then this rank's share too.  ``tp``: a
    rank's heads, experts and vocabulary block (``dense.forward_train``'s
    plan, with expert parallelism); the loss is replicated over
    ``model``."""
    tokens = batch['tokens']
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    h = dense.embed_inputs(cfg, params, tokens, batch.get('prefix_embeds'),
                           tp)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for lp in cm.layer_views(params):
        h, a = cm.remat(lambda h, lp: train_layer(
            cfg, lp, h, positions, use_kernel=use_kernel, data=data, tp=tp),
            h, lp)
        aux = aux + a
    aux = aux / cfg.n_layers
    nll, cnt = cm.chunked_ce_loss(
        h, params['final_norm'], dense.head_of(cfg, params),
        batch['labels'], mask=batch.get('loss_mask'), eps=cfg.norm_eps,
        tp=tp)
    total = cnt if data is None else data.sum(cnt.detach().clone())
    loss = nll / torch.clamp_min(total, 1.0) + AUX_WEIGHT * aux
    return loss, {'tokens': cnt, 'aux_loss': aux}


def prefill(cfg: ModelConfig, params, cache, batch, *, tp=None):
    """Whole-prompt prefill (see ``dense.prefill``), capacity factor 1.25,
    attention by the plain path; ``tp``: a rank's step (module
    docstring)."""
    return dense.prefill(cfg, params, cache, batch, mlp=functools.partial(
        moe_block, capacity_factor=PREFILL_CAPACITY), tp=tp)


def prefill_chunk(cfg: ModelConfig, params, cache, batch, *, tp=None):
    """Chunked prefill with past-KV readback (see ``dense.prefill_chunk``),
    capacity factor 2.0; ``tp``: a rank's step (module docstring)."""
    return dense.prefill_chunk(cfg, params, cache, batch, mlp=functools.partial(
        moe_block, capacity_factor=SERVE_CAPACITY), tp=tp)


def decode_step(cfg: ModelConfig, params, cache, batch, *,
                use_kernel: bool = False, tp=None):
    """One token a row (see ``dense.decode_step``), capacity factor 2.0."""
    return dense.decode_step(cfg, params, cache, batch, use_kernel=use_kernel,
                             mlp=functools.partial(
                                 moe_block, capacity_factor=SERVE_CAPACITY),
                             tp=tp)


cache_template = dense.cache_template
