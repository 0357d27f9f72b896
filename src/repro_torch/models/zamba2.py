"""Zamba2 (zamba2-2.7b) in PyTorch: a Mamba2 backbone with one SHARED
attention+MLP block applied every ``hybrid_attn_every`` layers, the
reference's ``models/zamba2.py`` [arXiv:2411.15242].

Mamba2 sequence paths use the chunked SSD form (intra-chunk matmuls with a
decay matrix, then a scan of the chunks' states); decode takes the exact
single-step recurrence.  The shared block attends over concat(hidden,
token embedding), width 2 d_model, with one parameter set at every
application; each application has its own paged KV pool -- the tensors
Valve reclaims for this architecture.

- ``forward_train``: every layer checkpointed under autograd, the shared
  block in ``train`` mode, ``chunked_ce_loss``; with ``tp`` a
  tensor-parallel rank's share (below).
- ``prefill``: a whole prompt from the Mamba state in the cache, the
  shared block's K/V written into its pools through the page table.
- ``decode_step``: one token a row; the shared block reads its pools
  through the page table (``decode``) or, with ``long_context``, a
  contiguous KV of ``max_seq`` tokens a row (``decode_dense``).

A Python loop over layers takes the place of ``lax.scan`` + ``lax.cond``;
the caches are updated in place.  The shared block's pools take the
engine's global layout or the per-request region layout of
``make_serve_step`` (``attn_cache_template(batch=)``).
No kernel runs here, as in the reference: the paged read is the gather
oracle ``paged_attention_ref`` and the attentions are ``chunked_attention``.

**Training over ``model``** (``forward_train(tp=)``, a
``distributed.tp.TensorParallel``).  A rank holds whole Mamba2 heads and
a 1/n share of the state dimension N.  ``in_proj``'s columns are packed
[z | x | B | C | dt] = [d_in | d_in | N | N | H] and the conv's channels
[x | B | C], so a rank's block of each is several intervals in global
order (``sharding.Block``): its heads' z, x and dt columns, its heads' x
channels, and its share of B's and C's columns and channels.  The
depthwise conv is channel-wise, so each rank convolves its own channels;
then B and C are all-gathered over ``model`` (B x T x 2N values a layer),
since every head's SSD reads all of them; the gather's backward sums the
ranks' gradients and keeps the rank's share (a reduce-scatter).  The
gated RMSNorm normalises over all of ``d_in``: each rank's f32 sum of
squares is summed over ``model`` before the rsqrt, and in the backward
that statistic's gradient is summed too (``tp.norm_sum``).  ``out_proj``
is row-parallel.  The shared block is split by its own heads (q/k/v
columns, ``wo`` rows) and ``hybrid_attn_d_ff``; its one parameter set
gathers the gradients of every application.  The embedding (the tied
head) is vocab-parallel.  ``ln``'s output before ``in_proj`` and the
shared block's normed ``concat(h, e0)`` enter the split products through
``tp.copy``, so every replicated leaf gets the whole gradient on every
rank.  Where ``model`` does not divide the Mamba2 heads and N, the Mamba2
layers stay whole on every rank.

**Serving over ``model``** (``prefill`` / ``decode_step(tp=)``, a serve
step's ``distributed.tp.StepParallel``): the same blocks; the cache's
conv state holds the rank's conv channels, its SSM state the rank's heads
(N whole), its pools the shared block's heads.  The long context's
contiguous KV may be split over the batch axes by sequence
(``LONG_SERVE_RULES``): :func:`_decode_dense`.  Under the rule variants
(``tp.placement``): ``serve_dh`` runs the Mamba2 layers whole on every
rank (their weights and states replicated) and the shared block's
attention by head_dim; ``serve_kv_dp`` gathers the conv's x, B, C and dt
over ``model`` and runs every head's SSD on every rank (the ``ssm`` state
replicated), then the rank's d_in block into the gated norm and
``out_proj``, and replicates the shared block's pools; ``serve_seq``
splits the pools' pages (the long context's sequence) over ``model``.
Where no batch axis divides the rows (long_500k's one row under a
variant: ``tp.moved``), the Mamba states and the long KV hold the blocks
of the reference's specs: a layer reads its states through
``tp.layer_state`` and writes them through ``tp.put_layer_state``, and
the long KV is read in place by ``tp.long_attention``.
The trainer places its weights by the same rules
(``distributed.tp.TensorParallel(rules=)``): under ``serve_dh`` every
rank runs the Mamba2 layers and the shared attention whole; under
``serve_kv_dp`` every rank runs every head's SSD from a zero state of
every head, and ``A_log`` / ``dt_bias`` / ``D``, read for the rank's
heads, have their gradients summed over ``model`` (``tp.head_share``).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm
from repro_torch.models.common import PSpec
from repro_torch.models.dense import embed_inputs, head_of, head_scores, placed

SSD_CHUNK = 128


def n_attn_apps(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.hybrid_attn_every


def _dims(cfg: ModelConfig):
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    hd = cfg.ssm_head_dim
    return d, d_in, hd, d_in // hd, cfg.ssm_state


def placement(cfg: ModelConfig, group: str, heads, state, shared_heads,
              ffn) -> Dict[str, Dict[int, Any]]:
    """A tensor-parallel rank's blocks of the leaves of ``group``
    (``'layers'`` or ``'shared'``), {name: {dim: [lo, hi) or a tuple of
    them in global order}}, for a rank holding the Mamba2 heads whose
    channels of ``d_in`` are ``heads`` = [lo, hi) (None: the Mamba2
    layers whole) with the share ``state`` = [lo, hi) of the state
    dimension N, and the shared block's head channels ``shared_heads`` and
    ``hybrid_attn_d_ff`` block ``ffn`` (the module docstring); a leaf it
    does not name is replicated."""
    if group == 'shared':
        return {'wq': {1: shared_heads}, 'wk': {1: shared_heads},
                'wv': {1: shared_heads}, 'wo': {0: shared_heads},
                'wg': {1: ffn}, 'wu': {1: ffn}, 'wd': {0: ffn}}
    if heads is None:
        return {}
    _, d_in, hd, _, n = _dims(cfg)
    (lo, hi), (slo, shi) = heads, state
    h = (lo // hd, hi // hd)
    # conv channels [x | B | C]; in_proj columns [z | x B C | dt]
    xbc = ((lo, hi), (d_in + slo, d_in + shi),
           (d_in + n + slo, d_in + n + shi))
    dt = 2 * d_in + 2 * n
    cols = (((lo, hi),) + tuple((d_in + a, d_in + b) for a, b in xbc)
            + ((dt + h[0], dt + h[1]),))
    return {'in_proj': {2: cols}, 'conv_w': {2: xbc}, 'conv_b': {1: xbc},
            'A_log': {1: h}, 'dt_bias': {1: h}, 'D': {1: h},
            'norm': {1: heads}, 'out_proj': {1: heads}}


def template(cfg: ModelConfig) -> Dict[str, Any]:
    d, d_in, hd, h, n = _dims(cfg)
    L, v = cfg.n_layers, cfg.vocab_size
    conv_ch = d_in + 2 * n
    d2 = 2 * d
    ah = cfg.hybrid_attn_heads
    ahd = d2 // ah
    f = cfg.hybrid_attn_d_ff
    t: Dict[str, Any] = {
        'embed': PSpec((v, d), ('vocab', 'embed'),
                       scale=d ** -0.5),           # tied-unembed-safe
        'final_norm': PSpec((d,), ('embed',), 'ones'),
        'layers': {
            'ln': PSpec((L, d), ('layers', 'embed'), 'ones'),
            'in_proj': PSpec((L, d, 2 * d_in + 2 * n + h),
                             ('layers', 'embed', 'qkv')),
            'conv_w': PSpec((L, cfg.conv_kernel, conv_ch),
                            ('layers', None, 'qkv'), scale=0.5),
            'conv_b': PSpec((L, conv_ch), ('layers', 'qkv'), 'zeros'),
            'A_log': PSpec((L, h), ('layers', 'heads'), 'zeros'),
            'dt_bias': PSpec((L, h), ('layers', 'heads'), 'zeros'),
            'D': PSpec((L, h), ('layers', 'heads'), 'ones'),
            'norm': PSpec((L, d_in), ('layers', 'qkv'), 'ones'),
            'out_proj': PSpec((L, d_in, d), ('layers', 'qkv', 'embed')),
        },
        # ONE shared attention+MLP block, a fresh KV pool per application
        'shared': {
            'ln1': PSpec((d2,), ('embed',), 'ones'),
            'wq': PSpec((d2, ah * ahd), ('embed', 'qkv')),
            'wk': PSpec((d2, ah * ahd), ('embed', 'qkv')),
            'wv': PSpec((d2, ah * ahd), ('embed', 'qkv')),
            'wo': PSpec((ah * ahd, d), ('qkv', 'embed')),
            'ln2': PSpec((d2,), ('embed',), 'ones'),
            'wg': PSpec((d2, f), ('embed', 'ffn')),
            'wu': PSpec((d2, f), ('embed', 'ffn')),
            'wd': PSpec((f, d), ('ffn', 'embed')),
        },
    }
    if not cfg.tie_embeddings:
        # (V, D) row-major, as the dense family's: the reference's (D, V)
        t['unembed'] = PSpec((v, d), ('vocab', 'embed'), scale=d ** -0.5)
    return t


# ---------------------------------------------------------------------------
# Mamba2 SSD
# ---------------------------------------------------------------------------

def ssd_step(x, b_t, c_t, a_t, state):
    """Exact decode recurrence.  x: (B, H, P); b_t/c_t: (B, N); a_t: (B,
    H); state: (B, H, P, N).  -> (y (B, H, P), new state)."""
    state = a_t[..., None, None] * state \
        + x[..., :, None] * b_t[:, None, None, :]
    return torch.einsum('bhpn,bn->bhp', state, c_t), state


def ssd_ref(x, b, c, a, state):
    """Sequential oracle.  x: (B, T, H, P); b/c: (B, T, N); a: (B, T, H)."""
    ys = []
    for t in range(x.shape[1]):
        y, state = ssd_step(x[:, t], b[:, t], c[:, t], a[:, t], state)
        ys.append(y)
    return torch.stack(ys, dim=1), state


def ssd_chunked(x, b, c, a, state, *, chunk: int = SSD_CHUNK):
    """Chunked SSD (Dao & Gu 2024 block decomposition); matches
    :func:`ssd_ref`.  x: (B, T, H, P) f32; b, c: (B, T, N); a: (B, T, H) in
    (0, 1); state: (B, H, P, N).  A ragged T is padded with a = 1 (log 0),
    so the state leaves the padding as it entered.

    Within a chunk h_t = sum_{i<=t} exp(S_ti) x_i b_i, with S_ti the sum of
    log a over (i, t].  The reference takes S_ti as L_t - L_i of the
    cumulative sum L and exp of the whole square before masking it: above
    the diagonal that exponent is a positive sum which overflows f32 once
    the decays are small, and the masked inf's gradient is NaN; below it,
    the difference of two large sums loses ~|L| ulps, which at T = 2048, N
    = 64 puts some outputs past 1e-4 (1 + |y|) of the exact recurrence.
    Here S is a cumulative sum of the log-decays masked to
    (i, t] (Mamba2's ``segsum``), so every exponent is <= 0 and exact to a
    few ulps, and it is -inf above the diagonal before ``exp``: the same
    values, finite gradients.  The decay of each token to the chunk's end
    is the last row of the square.
    """
    bsz, t, h, p = x.shape
    n = b.shape[-1]
    pad = -t % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad), value=1.0)
    nc = x.shape[1] // chunk
    xc = x.reshape(bsz, nc, chunk, h, p).permute(1, 0, 3, 2, 4)  # nc,B,H,c,P
    bc = b.reshape(bsz, nc, chunk, n).transpose(0, 1)            # nc,B,c,N
    cc = c.reshape(bsz, nc, chunk, n).transpose(0, 1)
    ac = a.reshape(bsz, nc, chunk, h).permute(1, 0, 3, 2)        # nc,B,H,c

    loga = torch.log(torch.clamp_min(ac, 1e-30))
    lower = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    seg = torch.cumsum(loga[..., :, None].expand(*loga.shape, chunk)
                       .masked_fill(~lower.tril(-1), 0.0), dim=-2)
    M = torch.exp(seg.masked_fill(~lower, float('-inf')))       # nc,B,H,c,c
    cb = cc @ bc.transpose(-1, -2)                               # nc,B,c,c
    y_intra = (cb[:, :, None] * M) @ xc                          # nc,B,H,c,P

    chunk_state = (xc * M[..., -1, :, None]).transpose(-1, -2) \
        @ bc[:, :, None]                                         # nc,B,H,P,N
    L = torch.cumsum(loga, dim=-1)
    a_tot = torch.exp(L[..., -1])                                # nc,B,H
    decay_in = torch.exp(L)

    y_inter = []
    for g in range(nc):
        y_inter.append(torch.einsum('btn,bhpn->bhtp', cc[g], state)
                       * decay_in[g][..., None])
        state = a_tot[g][..., None, None] * state + chunk_state[g]
    y = (y_intra + torch.stack(y_inter)).permute(1, 0, 3, 2, 4)
    return y.reshape(bsz, nc * chunk, h, p)[:, :t], state


def _causal_conv(xbc, conv_w, conv_b, conv_state):
    """Depthwise causal conv.  xbc: (B, T, C); conv_w: (K, C); conv_state:
    (B, K-1, C), the last K-1 inputs of the previous segment.  The taps sum
    in the reference's order (each partial sum rounds in bf16).  -> (silu
    output in xbc's dtype, new state: the last K-1 inputs, xbc's dtype)."""
    k, t = conv_w.shape[0], xbc.shape[1]
    full = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)
    out = full[:, :t] * conv_w[0]
    for i in range(1, k):
        out = out + full[:, i:i + t] * conv_w[i]
    new_state = full[:, -(k - 1):] if k > 1 else conv_state
    return F.silu((out + conv_b).float()).to(xbc.dtype), new_state


def _gated_norm(cfg: ModelConfig, y, w, tp):
    """RMSNorm of the gated ``y`` over all of ``d_in``; under ``tp`` (a
    rank holding some heads' channels) the f32 sum of squares is summed
    over ``model`` before the rsqrt, and its gradient too
    (``tp.norm_sum``)."""
    if tp is None:
        return cm.rms_norm(y, w, cfg.norm_eps)
    yf = y.float()
    total = tp.norm_sum((yf * yf).sum(-1, keepdim=True))
    var = total / (cfg.ssm_expand * cfg.d_model)
    return (yf * torch.rsqrt(var + cfg.norm_eps) * w.float()).to(y.dtype)


def mamba_block(cfg: ModelConfig, lp, h, conv_state, ssm_state, tp=None):
    """One Mamba2 layer.  h: (B, T, D); conv_state (B, K-1, C) (C: the
    conv channels of ``lp``); ssm_state (B, H, P, N) f32 (H: the heads of
    ``lp``, or every head where the state is replicated).  ``tp``: a
    tensor-parallel rank's heads and its share of B and C (module
    docstring).  -> (h, new conv state, new ssm state)."""
    d, d_in, hd, nh, n = _dims(cfg)
    bsz, t, _ = h.shape
    if tp is not None and not tp.mamba_split:
        tp = None
    parts = tp.n if tp is not None else 1
    # serve_kv_dp: the SSM state replicated, every head run on every rank
    every = tp is not None and tp.placement == 'kv_dp'
    d_own, nh_own, n_own = d_in // parts, nh // parts, n // parts
    x = cm.rms_norm(h, lp['ln'], cfg.norm_eps)
    if tp is not None:
        x = tp.copy(x)
    z, xbc, dt = torch.split(x @ lp['in_proj'],
                             [d_own, d_own + 2 * n_own, nh_own], dim=-1)
    xbc, new_conv = _causal_conv(xbc, lp['conv_w'], lp['conv_b'], conv_state)
    xs, bc = torch.split(xbc, [d_own, 2 * n_own], dim=-1)
    if tp is not None:
        # every rank's share of B and C, in rank order
        bc = tp.gather_shares(bc).reshape(bsz, t, parts, 2, n_own)
        bc = bc.transpose(2, 3).reshape(bsz, t, 2 * n)
    if every:
        xs, dt = tp.gather_shares(xs), tp.gather_shares(dt)
    else:
        d_in, nh = d_own, nh_own
    b, c = torch.split(bc, [n, n], dim=-1)
    xs = xs.reshape(bsz, t, nh, hd).float()
    # serve_kv_dp: the heads' leaves replicated, read for the rank's heads
    heads_leaf = tp.head_share if every else (lambda w: w)
    dt = F.softplus(dt.float() + heads_leaf(lp['dt_bias']))     # (B, T, H)
    a = torch.exp(-torch.exp(heads_leaf(lp['A_log']).float()) * dt)  # (0, 1)
    xdt = xs * dt[..., None]
    if t == 1:
        y, new_ssm = ssd_step(xdt[:, 0], b[:, 0].float(), c[:, 0].float(),
                              a[:, 0], ssm_state)
        y = y[:, None]
    else:
        y, new_ssm = ssd_chunked(xdt, b.float(), c.float(), a, ssm_state)
    y = (y + heads_leaf(lp['D'])[:, None] * xs).reshape(bsz, t, d_in)  # skip
    if every:
        y = y[..., tp.mamba[0]:tp.mamba[1]]
    y = _gated_norm(cfg, y * F.silu(z.float()), lp['norm'], tp).to(h.dtype)
    out = y @ lp['out_proj'] if tp is None \
        else tp.row_parallel(y, lp['out_proj'], True)
    return h + out, new_conv, new_ssm


# ---------------------------------------------------------------------------
# Shared attention block (a paged KV pool per application)
# ---------------------------------------------------------------------------

def shared_attn(cfg: ModelConfig, sp, h, e0, positions, mode,
                pool_k=None, pool_v=None, page_table=None, tp=None):
    """h, e0: (B, T, D); positions (B, T).  ``mode``: ``train`` (no cache),
    ``prefill`` (K/V into the pools (P, pg, AH, AHD), or (B, R, pg, AH,
    AHD) region-paged, through the page table), ``decode`` (one token, the
    pools read through the page table),
    ``decode_dense`` (one token, contiguous pools (B, S_max, AH, AHD)).
    The pools are written in place.  ``tp``: a tensor-parallel rank's
    heads and ``d_ff`` block of the block, in every mode, and the pools'
    blocks as its placement holds them (of the long context's sequence
    too: :func:`_decode_dense`).  -> h'."""
    b, t, d = h.shape
    ahd = 2 * d // cfg.hybrid_attn_heads
    heads = tp is not None and tp.shared_split
    ffn = tp is not None and tp.hybrid_ffn != (0, cfg.hybrid_attn_d_ff)
    x = cm.rms_norm(torch.cat([h, e0], dim=-1), sp['ln1'], cfg.norm_eps)
    if heads:
        x = tp.copy(x)
    # -1 heads: a tensor-parallel rank's weights hold its heads only
    q = cm.rope((x @ sp['wq']).reshape(b, t, -1, ahd), positions,
                cfg.rope_theta)
    k = cm.rope((x @ sp['wk']).reshape(b, t, -1, ahd), positions,
                cfg.rope_theta)
    v = (x @ sp['wv']).reshape(b, t, -1, ahd)
    store, held = ((lambda t: t), None) if tp is None else \
        ((lambda t: tp.pool_kv(t, 'shared')), tp.held)
    if mode in ('train', 'prefill'):
        if mode == 'prefill':
            cm.kv_write_prefill(pool_k, page_table, store(k), held)
            cm.kv_write_prefill(pool_v, page_table, store(v), held)
        out = cm.chunked_attention(q, k, v, q_positions=positions,
                                   kv_positions=positions, causal=True)
    elif mode == 'decode_dense':
        out = _decode_dense(q, k, v, positions[:, 0].long(), pool_k, pool_v,
                            tp)
    else:                                   # decode
        pos = positions[:, 0]
        pg = pool_k.shape[-3]
        page_idx = page_table.gather(1, (pos // pg)[:, None].long())[:, 0]
        cm.kv_write_token(pool_k, page_idx, pos % pg, store(k[:, 0]), held)
        cm.kv_write_token(pool_v, page_idx, pos % pg, store(v[:, 0]), held)
        if placed(tp):
            out = tp.paged_read(q, pool_k, pool_v, page_table, positions,
                                pos + 1, ('shared', 'shared'))
        else:
            out = cm.paged_attention_ref(q[:, 0], pool_k, pool_v, page_table,
                                         pos + 1)[:, None]
    out = out.reshape(b, t, -1)
    h = h + (tp.row_parallel(out, sp['wo'], True) if heads
             else out @ sp['wo'])
    x = cm.rms_norm(torch.cat([h, e0], dim=-1), sp['ln2'], cfg.norm_eps)
    if not ffn:
        return h + cm.swiglu(x, sp['wg'], sp['wu'], sp['wd'])
    return h + cm.swiglu(tp.copy(x), sp['wg'], sp['wu'], sp['wd'],
                         functools.partial(tp.row_parallel, split=True))


def _decode_dense(q, k, v, pos, pool_k, pool_v, tp=None):
    """One token a row over the contiguous KV: its K/V written at ``pos``
    (B,), then attention over the slots <= ``pos``.  Under a plan whose
    ``seq_split`` cuts the sequence (over the batch axes, or under
    ``serve_seq`` over ``model``), the pools hold the rank's slots
    ``tp.seq`` = [lo, hi): only the rank whose block holds ``pos`` writes
    there (the others write the slot's old value back), and the ranks'
    partial softmax states are combined in rank order
    (``tp.seq_attention``); under ``serve_seq`` q and the new K/V are
    gathered into every head first and the rank keeps its heads of the
    output.  ``serve_kv_dp``: every head written, the rank's heads read;
    ``serve_dh``: the rank's head_dim block written and read
    (``tp.dh_attention``).  -> (B, 1, AH or the rank's heads, AHD)."""
    if tp is not None and tp.moved:
        return tp.long_attention(q, k, v, pos, pool_k, pool_v)
    b, slots = pool_k.shape[:2]
    rows = torch.arange(b, device=q.device)
    placement = 'heads' if tp is None else tp.placement
    if placement == 'seq':
        q = tp.gather_heads(q, 'shared')
    if tp is not None:
        k, v = tp.pool_kv(k, 'shared'), tp.pool_kv(v, 'shared')
    split = tp is not None and tp.seq_split
    lo = tp.seq[0] if split else 0
    slot = pos - lo
    if split:
        inside = ((slot >= 0) & (slot < slots))[:, None, None]
        slot = slot.clamp(0, slots - 1)
        for pool, new in ((pool_k, k), (pool_v, v)):
            pool[rows, slot] = torch.where(inside, new[:, 0].to(pool.dtype),
                                           pool[rows, slot])
    else:
        pool_k[rows, slot] = k[:, 0].to(pool_k.dtype)
        pool_v[rows, slot] = v[:, 0].to(pool_v.dtype)
    kv_pos = lo + torch.arange(slots, device=q.device).expand(b, -1)
    valid = kv_pos <= pos[:, None]
    if placement == 'dh':
        return tp.dh_attention(q, pool_k, pool_v, valid[:, None, :])
    if placement == 'kv_dp':
        own = tp.own('shared')
        pool_k = pool_k[..., own[0]:own[1], :]
        pool_v = pool_v[..., own[0]:own[1], :]
    if split:
        out = tp.seq_attention(q, pool_k, pool_v, valid)
    else:
        out = cm.attention(q, pool_k, pool_v, q_positions=pos[:, None],
                           kv_positions=kv_pos, kv_valid=valid, causal=False)
    if placement == 'seq':
        own = tp.own('shared')
        out = out[:, :, own[0]:own[1]]
    return out


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def mamba_cache_template(cfg: ModelConfig, batch_size: int):
    """The Mamba state: ``conv`` (L, B, K-1, C) in the model dtype (the
    default, which ``zeros_from_template``'s ``dtype`` replaces: the
    reference carries it in the dtype of the conv's input) and ``ssm`` (L,
    B, H, P, N) f32."""
    d, d_in, hd, h, n = _dims(cfg)
    L = cfg.n_layers
    return {
        'conv': PSpec((L, batch_size, cfg.conv_kernel - 1, d_in + 2 * n),
                      ('layers', 'batch', None, 'qkv'), 'zeros'),
        'ssm': PSpec((L, batch_size, h, hd, n),
                     ('layers', 'batch', 'heads', None, 'state'), 'zeros',
                     dtype=torch.float32),
    }


def attn_cache_template(cfg: ModelConfig, n_pages: int,
                        batch: Optional[int] = None):
    """The shared block's paged KV for k and v: ``batch=None`` the global
    layout (n_apps, P, pg, AH, AHD), page 0 the quarantine page (the
    engine's); ``batch=B`` the per-request region layout (n_apps, B, R,
    pg, AH, AHD), ``n_pages`` = R slots a row."""
    ah = cfg.hybrid_attn_heads
    ahd = 2 * cfg.d_model // ah
    if batch is None:
        shape = (n_attn_apps(cfg), n_pages, cfg.page_size, ah, ahd)
        axes = ('layers', 'pages', None, 'heads', 'head_dim')
    else:
        shape = (n_attn_apps(cfg), batch, n_pages, cfg.page_size, ah, ahd)
        axes = ('layers', 'batch', 'pages', None, 'heads', 'head_dim')
    return {'k': PSpec(shape, axes, 'zeros'), 'v': PSpec(shape, axes, 'zeros')}


def attn_cache_template_dense(cfg: ModelConfig, batch: int, max_seq: int):
    """Contiguous long-context KV: (n_apps, B, max_seq, AH, AHD)."""
    ah = cfg.hybrid_attn_heads
    shape = (n_attn_apps(cfg), batch, max_seq, ah, 2 * cfg.d_model // ah)
    axes = ('layers', 'batch', 'kv_seq', 'heads', 'head_dim')
    return {'k': PSpec(shape, axes, 'zeros'), 'v': PSpec(shape, axes, 'zeros')}


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _positions(b: int, s: int, device):
    return torch.arange(s, device=device).expand(b, s)


def train_layer(cfg: ModelConfig, idx: int, lp, sp, h, e0, positions,
                tp=None):
    """Layer ``idx`` of the training forward from a zero Mamba state, the
    shared block after it where ``(idx + 1) % every == 0``.  ``tp``: a
    rank's blocks (module docstring)."""
    d, d_in, hd, nh, n = _dims(cfg)
    b = h.shape[0]
    conv0 = torch.zeros(b, cfg.conv_kernel - 1, lp['conv_w'].shape[-1],
                        dtype=h.dtype, device=h.device)
    ssm0 = torch.zeros(b, lp['A_log'].shape[-1], hd, n, dtype=torch.float32,
                       device=h.device)
    h = mamba_block(cfg, lp, h, conv0, ssm0, tp)[0]
    if (idx + 1) % cfg.hybrid_attn_every == 0:
        h = shared_attn(cfg, sp, h, e0, positions, 'train', tp=tp)
    return h


def forward_train(cfg: ModelConfig, params, batch, *, tp=None):
    """Mean next-token NLL of batch['labels'] (B, S) given batch['tokens']
    (B, S), masked by batch['loss_mask'] if present; each layer
    checkpointed under autograd, as the reference's ``scan_layers``.
    ``tp``: a tensor-parallel rank's weight blocks (module docstring).
    -> (loss, {'tokens': count})."""
    tokens = batch['tokens']
    b, s = tokens.shape
    h = e0 = embed_inputs(cfg, params, tokens, tp=tp)
    positions = _positions(b, s, tokens.device)
    sp = params['shared']
    for idx, lp in enumerate(cm.layer_views(params)):
        h = cm.remat(lambda h, lp, idx=idx: train_layer(
            cfg, idx, lp, sp, h, e0, positions, tp), h, lp)
    nll, cnt = cm.chunked_ce_loss(
        h, params['final_norm'], head_of(cfg, params), batch['labels'],
        mask=batch.get('loss_mask'), eps=cfg.norm_eps,
        tp=tp)
    return nll / torch.clamp_min(cnt, 1.0), {'tokens': cnt}


def _run_layers(cfg: ModelConfig, params, h, positions, mode, cache,
                page_table, tp=None):
    """Every layer from the Mamba state in ``cache['mamba']``, which takes
    the state after, in place; application ``app = idx // every`` of the
    shared block reads and writes ``cache['attn']``'s pool ``app``.  The
    token embedding ``h`` is the shared block's ``e0``.  ``tp``: a
    tensor-parallel rank's weight and cache blocks (module docstring)."""
    e0 = h
    mamba, attn = cache['mamba'], cache['attn']
    sp = params['shared']
    every = cfg.hybrid_attn_every
    for idx, lp in enumerate(cm.layer_views(params)):
        conv, ssm = (cm.layer_state(tp, ('mamba', k), mamba[k], idx)
                     for k in ('conv', 'ssm'))
        h, conv, ssm = mamba_block(cfg, lp, h, conv, ssm, tp)
        cm.put_layer_state(tp, ('mamba', 'conv'), mamba['conv'], idx, conv)
        cm.put_layer_state(tp, ('mamba', 'ssm'), mamba['ssm'], idx, ssm)
        if (idx + 1) % every == 0:
            app = idx // every
            h = shared_attn(cfg, sp, h, e0, positions, mode, attn['k'][app],
                            attn['v'][app], page_table, tp)
    return h


def prefill(cfg: ModelConfig, params, cache, batch, *, tp=None):
    """tokens (B, S), page_table (B, >= ceil(S / page)) -> (cache holding
    the Mamba state after the prompt and its shared-block K/V, (B, V) f32
    scores of the last token).  ``tp``: a tensor-parallel rank's step over
    its blocks (module docstring); the scores are its vocabulary block."""
    tokens = batch['tokens']
    h = embed_inputs(cfg, params, tokens, tp=tp)
    h = _run_layers(cfg, params, h, _positions(*tokens.shape, tokens.device),
                    'prefill', cache, batch['page_table'], tp)
    last = cm.rms_norm(h[:, -1], params['final_norm'], cfg.norm_eps)
    return cache, head_scores(last, head_of(cfg, params), tp)


def decode_step(cfg: ModelConfig, params, cache, batch, *,
                long_context: bool = False, tp=None):
    """tokens (B,), positions (B,) [, page_table (B, maxp)] -> (cache one
    token on, (B, V) f32 scores).  ``long_context`` reads the contiguous KV
    of :func:`attn_cache_template_dense` (no page table).  ``tp``: as
    :func:`prefill`, the long context's sequence split as the plan says
    (:func:`_decode_dense`)."""
    positions = batch['positions']
    h = embed_inputs(cfg, params, batch['tokens'], tp=tp)[:, None, :]
    h = _run_layers(cfg, params, h, positions[:, None],
                    'decode_dense' if long_context else 'decode', cache,
                    batch.get('page_table'), tp)
    last = cm.rms_norm(h[:, 0], params['final_norm'], cfg.norm_eps)
    return cache, head_scores(last, head_of(cfg, params), tp)
