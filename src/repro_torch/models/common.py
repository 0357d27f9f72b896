"""Shared model building blocks in PyTorch.

The weights of a model are an ``nn.ParameterDict`` (an ``nn.Module``) that
nests like the reference's param tree.  Each family builds a *template* --
the same nested structure with :class:`PSpec` leaves carrying shape, logical
sharding axes and init law -- from which :func:`init_from_template` draws
real weights with
a ``torch.Generator`` under the reference's init law.  The two frameworks
draw different numbers from the same seed; parity tests feed the
reference's own weights through ``repro_torch.bridge``.

KV caches come in two layouts, as in the reference.  The engine's global
paged pool is per layer (P, page_size, Hkv, Dh), page 0 the QUARANTINE
page; the per-request region layout of ``make_serve_step`` is per layer
(B, R, page_size, Hkv, Dh), each row's page ids local to its own R slots,
slot 0 its quarantine slot.  The KV functions below take either: a 4-D
pool is the global layout, a 5-D one the region layout.  Writes update
the pool in place (``index_put_``), where the reference returns a new array.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.common import (NEG_INF, combine_softmax_states,
                                        online_softmax_finalize,
                                        online_softmax_update)

DEFAULT_DTYPE = torch.bfloat16
CHUNK = 512        # query rows / tokens per chunk of the chunked functions


@dataclass(frozen=True)
class PSpec:
    """Param template leaf: shape + logical axes (one name or None a
    dimension, resolved to mesh axes by ``distributed.sharding``) + init
    law."""
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = 'normal'       # 'normal' | 'zeros' | 'ones'
    scale: Optional[float] = None  # None -> 1/sqrt(fan_in) for 'normal'
    dtype: Any = DEFAULT_DTYPE

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f'shape {self.shape} vs axes {self.axes}')


def _map_template(fn, tmpl):
    if isinstance(tmpl, PSpec):
        return fn(tmpl)
    return {k: _map_template(fn, v) for k, v in tmpl.items()}


def shapes_from_template(tmpl):
    """The template's shapes (``torch.Size``), nested like it."""
    return _map_template(lambda leaf: torch.Size(leaf.shape), tmpl)


def axes_from_template(tmpl):
    """The template's logical-axes tuples, nested like it."""
    return _map_template(lambda leaf: leaf.axes, tmpl)


def init_leaf(leaf: PSpec, gen: torch.Generator, device) -> torch.Tensor:
    """One template leaf drawn from ``gen`` on ``device`` under its init
    law (the generator advances as :func:`init_from_template` advances it
    for this leaf)."""
    if leaf.init == 'zeros':
        return torch.zeros(leaf.shape, dtype=leaf.dtype, device=device)
    if leaf.init == 'ones':
        return torch.ones(leaf.shape, dtype=leaf.dtype, device=device)
    fan_in = leaf.shape[-2] if len(leaf.shape) >= 2 else leaf.shape[-1]
    scale = leaf.scale if leaf.scale is not None else fan_in ** -0.5
    # scaled in place: one f32 draw of the leaf is alive at a time (an MoE
    # expert stack is tens of GB in f32)
    return torch.randn(leaf.shape, generator=gen, dtype=torch.float32,
                       device=device).mul_(scale).to(leaf.dtype)


def init_from_template(tmpl, gen: torch.Generator, device, *,
                       requires_grad: bool = False):
    """Draw a template's weights on ``device`` (the generator's device)."""
    def build(node):
        if isinstance(node, PSpec):
            return nn.Parameter(init_leaf(node, gen, device),
                                requires_grad=requires_grad)
        return nn.ParameterDict({k: build(v) for k, v in node.items()})
    return build(tmpl)


def zeros_from_template(tmpl, device, dtype=None):
    """Zero tensors nested like ``tmpl`` (caches: flat, or zamba2's
    ``{'mamba': {...}, 'attn': {...}}``).  ``dtype``, if given, replaces the
    default dtype (the model's compute dtype for its caches); a leaf that
    names another dtype (an f32 recurrent state) keeps it."""
    def build(node):
        if isinstance(node, PSpec):
            dt = node.dtype
            if dtype is not None and dt == DEFAULT_DTYPE:
                dt = dtype
            return torch.zeros(node.shape, dtype=dt, device=device)
        return {k: build(v) for k, v in node.items()}
    return build(tmpl)


def layer_state(tp, path, leaf, i: int):
    """Layer ``i``'s recurrent state of the cache leaf ``path`` (L, ...)
    as the layer reads it: ``leaf[i]``, or where ``tp`` places the rows
    by the reference's specs the plan's (``distributed.tp.StepParallel.
    moved``, ``layer_state``)."""
    if tp is None or not tp.moved:
        return leaf[i]
    return tp.layer_state(path, leaf, i)


def put_layer_state(tp, path, leaf, i: int, new) -> None:
    """Write layer ``i``'s new state into ``leaf`` in place (where ``tp``
    places the rows by the reference's specs, the plan's block of it:
    ``StepParallel.put_layer_state``)."""
    if tp is None or not tp.moved:
        leaf[i].copy_(new)
    else:
        tp.put_layer_state(path, leaf, i, new)


def layer_views(params, key: str = 'layers'):
    """Each layer's weights as a dict of views into the (L, ...) stacks of
    ``params[key]``, taken with one ``unbind`` a stack: under autograd a
    ``w[i]`` per layer would write a zero tensor the size of the whole
    stack in each select's backward, where ``unbind``'s backward stacks the
    L gradients once."""
    stacks = params[key]
    views = {k: w.unbind(0) for k, w in stacks.items()}
    return [{k: v[i] for k, v in views.items()}
            for i in range(len(next(iter(views.values()))))]


def remat(fn, *args):
    """``fn(*args)``, checkpointed when autograd records it: its
    activations are recomputed in the backward pass instead of kept (the
    reference's ``jax.checkpoint``).  Without grad, a plain call."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# Numerics
# ---------------------------------------------------------------------------

def rms_norm(x, w, eps: float = 1e-5):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def rope(x, positions, theta: float, pairs=None):
    """Rotate-half RoPE.  x: (..., S, H, Dh); positions: (..., S).
    ``pairs`` = (lo, half): x holds RoPE pairs [lo, lo + its last
    dimension / 2) of a head_dim of 2 half -- channels lo.. and half +
    lo.. -- each pair rotated at its own frequency (a tensor-parallel
    rank's block of every head)."""
    half = x.shape[-1] // 2
    lo, full = (0, half) if pairs is None else pairs
    freqs = theta ** (-torch.arange(lo, lo + half, dtype=torch.float32,
                                    device=x.device) / full)
    angles = positions.float()[..., None, None] * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def swiglu(x, wg, wu, wd, down=torch.matmul):
    """SwiGLU; ``down(hidden, wd)`` is the down-projection (a
    tensor-parallel rank passes its row-parallel product)."""
    g = x @ wg
    u = x @ wu
    return down(F.silu(g.float()).to(x.dtype) * u, wd)


def attention(q, k, v, *, q_positions, kv_positions, kv_valid=None,
              causal: bool = True, scale: Optional[float] = None):
    """Plain GQA attention.  q: (B, Sq, Hq, Dh); k/v: (B, Skv, Hkv, Dh).

    Scores, softmax and the product with V all in f32 over K/V as stored;
    the output is rounded to the query dtype.  These are the numerics of
    the port's attention kernels, so the engine's plain and kernel decode
    paths differ only in summation order.  (The reference rounds the
    probabilities to the value dtype before the product; with f32 caches,
    as in the parity tests, the two agree.)
    """
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    scale = scale if scale is not None else dh ** -0.5
    qg = q.reshape(b, sq, hkv, hq // hkv, dh)
    scores = torch.einsum('bqhgd,bkhd->bhgqk', qg.float(), k.float()) * scale
    mask = torch.ones((b, 1, 1, sq, k.shape[1]), dtype=torch.bool,
                      device=q.device)
    if causal:
        mask = mask & (q_positions[:, None, None, :, None]
                       >= kv_positions[:, None, None, None, :])
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, None, None, :]
    probs = torch.softmax(torch.where(mask, scores, -1e30), dim=-1)
    out = torch.einsum('bhgqk,bkhd->bqhgd', probs, v.float())
    return out.reshape(b, sq, hq, dh).to(q.dtype)


def attention_partial(q, k, v, kv_valid, *, score_sum=None,
                      head_dim: Optional[int] = None):
    """:func:`attention` of one block of a split KV sequence, before the
    softmax is normalised: q (B, Sq, Hq, Dh); k/v (B, Skv, Hkv, Dh), the
    block's slots; ``kv_valid`` (B, Skv), or (B, Sq, Skv) a query's own.
    -> the online-softmax state (m, l, acc), f32, of the block's valid
    slots taken from the empty state (``kernels.common.
    online_softmax_update``): m and l (B, Hkv, G, Sq), acc (B, Hkv, G, Sq,
    Dh).  :func:`combine_partials` joins the blocks.  Where q and k/v
    hold a block of ``head_dim`` channels, the f32 partial scores go
    through ``score_sum`` (their sum over the other blocks) before the
    scale of the whole ``head_dim`` (as :func:`attention_dh_block`)."""
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, dh)
    scores = torch.einsum('bqhgd,bkhd->bhgqk', qg.float(), k.float())
    if score_sum is not None:
        scores = score_sum(scores)
    scores = scores * (head_dim or dh) ** -0.5
    valid = (kv_valid[:, None, None, None, :] if kv_valid.dim() == 2
             else kv_valid[:, None, None])
    scores = torch.where(valid, scores, NEG_INF)
    m = torch.full(scores.shape[:-1], NEG_INF, device=q.device)
    zero = torch.zeros_like(m)
    vh = v.float().permute(0, 2, 1, 3)[:, :, None, None]
    return online_softmax_update(scores, vh, m, zero, zero[..., None])


def combine_partials(m, l, acc):
    """The blocks' :func:`attention_partial` states stacked on a first
    dimension (in block order) -> the attention output (B, Sq, Hq, Dh) f32,
    combined in that order (``kernels.common.combine_softmax_states``)."""
    _, l, acc = combine_softmax_states(list(zip(m, l, acc)))
    out = online_softmax_finalize(acc, l)
    b, hkv, g, sq, dh = out.shape
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hkv * g, dh)


def kv_mask(slots: int, q_positions, kv_len):
    """(B, Sq, slots): KV position s is read by query row (b, i) where s <
    ``kv_len[b]`` and s <= ``q_positions[b, i]`` (a paged read's mask:
    :func:`paged_attention_ref` for one query a row)."""
    kv_pos = torch.arange(slots, device=q_positions.device)
    return ((kv_pos < kv_len.long()[:, None])[:, None, :]
            & (q_positions.long()[:, :, None] >= kv_pos))


def attention_dh_block(q, k, v, mask, head_dim: int, score_sum):
    """Attention over one block of head_dim: q (B, Sq, Hq, d) and k/v (B,
    S, Hkv, d) the block's channels of every head; ``mask`` (B, Sq, S).
    The block's f32 partial scores go through ``score_sum`` (the sum over
    the ranks holding the other blocks) before the scale of the whole
    ``head_dim`` and the softmax (as :func:`attention`); -> P V over the
    block, (B, Sq, Hq, d) f32."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, d)
    scores = score_sum(torch.einsum('bqhgd,bkhd->bhgqk', qg.float(),
                                    k.float())) * head_dim ** -0.5
    probs = torch.softmax(torch.where(mask[:, None, None], scores, -1e30),
                          dim=-1)
    out = torch.einsum('bhgqk,bkhd->bqhgd', probs, v.float())
    return out.reshape(b, sq, hq, d)


def held_positions(page_table, held, slots: int, page_size: int, kv_len):
    """(B, slots): the index in each row's page table of each of the pages
    [lo, lo + slots) of a pool's page dimension of ``held`` = (lo, n)
    pages, -1 where the row's table names it at no entry below its
    ``kv_len``.  Ids in [-n, 0) count from the end, as in the writes; a
    table naming one page twice below its length reads it at the later
    entry."""
    lo, n = held
    b, maxp = page_table.shape
    ids = page_table.long()
    ids = torch.where(ids < 0, ids + n, ids)
    j = torch.arange(maxp, device=ids.device).expand(b, -1)
    used = ((j * page_size < kv_len.long()[:, None])
            & (ids >= lo) & (ids < lo + slots))
    at = torch.where(used, ids - lo, slots)       # column ``slots``: unused
    inv = torch.full((b, slots + 1), -1, dtype=torch.long, device=ids.device)
    return inv.scatter_reduce(1, at, j, 'amax')[:, :slots]


def paged_partial(q, pool_k, pool_v, page_table, q_positions, kv_len, held):
    """:func:`attention_partial` of q (B, Sq, Hq, Dh) over the K/V of a
    rank's block of a pool's pages -- region (B, R_local, pg, Hkv, Dh), or
    global (P_local, pg, Hkv, Dh) -- read in place, each slot at the
    position its page has in the row's table (:func:`held_positions`;
    ``held`` = (lo, n): the block's first page of n), causal to
    ``q_positions`` (B, Sq) and below ``kv_len`` (B,).  -> (m, l, acc),
    f32."""
    b = q.shape[0]
    slots, pg = pool_k.shape[-4], pool_k.shape[-3]
    inv = held_positions(page_table, held, slots, pg, kv_len)
    kv_pos = (inv[:, :, None] * pg
              + torch.arange(pg, device=q.device)).reshape(b, slots * pg)
    read = (inv >= 0)[:, :, None].expand(b, slots, pg).reshape(b, -1)
    mask = ((read & (kv_pos < kv_len.long()[:, None]))[:, None, :]
            & (q_positions.long()[:, :, None] >= kv_pos[:, None, :]))
    shape = (-1, slots * pg) + tuple(pool_k.shape[-2:])
    k, v = pool_k.reshape(shape), pool_v.reshape(shape)
    if pool_k.dim() == 4:                     # one pool for every row
        k, v = k.expand(b, -1, -1, -1), v.expand(b, -1, -1, -1)
    return attention_partial(q, k, v, mask)


def chunked_attention(q, k, v, *, q_positions, kv_positions, kv_valid=None,
                      causal: bool = True):
    """:func:`attention` over query chunks of ``CHUNK`` rows, so the scores
    are never (Sq x Skv) at once.  The reference asks for a multiple of
    ``CHUNK`` past one chunk; here the last chunk may be shorter (each row's
    output is the same whatever chunk holds it).  Under autograd each chunk
    is checkpointed (recomputed in the backward pass), as the reference's
    ``remat_chunks``: otherwise every chunk's f32 scores and probabilities
    stay alive for the backward."""
    sq = q.shape[1]
    if sq <= CHUNK:
        return attention(q, k, v, q_positions=q_positions,
                         kv_positions=kv_positions, kv_valid=kv_valid,
                         causal=causal)

    def chunk(qc, qpc):
        return attention(qc, k, v, q_positions=qpc,
                         kv_positions=kv_positions, kv_valid=kv_valid,
                         causal=causal)
    return torch.cat([remat(chunk, q[:, i:i + CHUNK],
                            q_positions[:, i:i + CHUNK])
                      for i in range(0, sq, CHUNK)], dim=1)


def chunked_ce_loss(h, norm_w, head, labels, *, mask=None, eps: float = 1e-5,
                    tp=None):
    """Final norm -> unembed -> cross-entropy over about ``CHUNK``-token
    sequence chunks (S // CHUNK of them, at least one; S must split evenly),
    so the (B, S, V) logits never exist at once.  h: (B, S, D); head:
    (V, D) row-major; labels (B, S) int; mask (B, S) or None.  Logits are
    computed in the model dtype, then f32, as in the reference.  Under
    autograd each chunk is checkpointed, as in the reference: otherwise
    every chunk's (B, chunk, V) logits stay alive for the backward.
    Returns (sum of masked NLL, sum of mask), f32 scalars.

    ``tp`` (a ``distributed.tp.TensorParallel``): where its vocabulary is
    split, ``head`` is the rank's vocabulary block, and the log-sum-exp is
    assembled over the ranks -- the row max by an all-reduce MAX (detached:
    it only steadies the exponentials), the sum of exponentials by an f32
    all-reduce SUM, the gold logit by a masked pick on the rank that owns
    the label and an all-reduce SUM (both with an identity backward).
    Where ``model`` cuts the head on d_model instead (``tp.embed_cut``),
    each chunk's logits are the rank's f32 partial product over its
    columns summed over ``model`` (``tp.head_sum``), rounded once to the
    model dtype, then the plain cross-entropy.  A checkpointed chunk
    re-issues these collectives when the backward recomputes it, in the
    same order on every rank."""
    b, s, _ = h.shape
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=h.device)
    n = max(s // CHUNK, 1)
    assert s % n == 0, (s, n)
    step = s // n

    def chunk(hc, lc, mc):
        logits = (rms_norm(hc, norm_w, eps) @ head.T).float()
        gold = logits.gather(-1, lc[..., None].long())[..., 0]
        return ((torch.logsumexp(logits, dim=-1) - gold) * mc).sum()

    def column_chunk(hc, lc, mc):
        logits = tp.column_logits(rms_norm(hc, norm_w, eps), head).float()
        gold = logits.gather(-1, lc[..., None].long())[..., 0]
        return ((torch.logsumexp(logits, dim=-1) - gold) * mc).sum()

    def vocab_parallel_chunk(hc, lc, mc):
        x = tp.copy(rms_norm(hc, norm_w, eps))
        logits = (x @ head.T).float()
        top = tp.reduce_max(logits.detach().amax(-1))
        total = tp.reduce_sum(torch.exp(logits - top[..., None]).sum(-1),
                              torch.float32)
        lo, hi = tp.vocab
        local = lc.long() - lo
        pick = logits.gather(-1, local.clamp(0, hi - lo - 1)[..., None])[..., 0]
        gold = tp.reduce_sum(
            torch.where((local >= 0) & (local < hi - lo), pick, 0.0),
            torch.float32)
        return ((torch.log(total) + top - gold) * mc).sum()

    fn = (chunk if tp is None or not (tp.vocab_split or tp.embed_cut) else
          column_chunk if tp.embed_cut else vocab_parallel_chunk)
    nll = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, s, step):
        m = mask[:, i:i + step].float()
        nll = nll + remat(fn, h[:, i:i + step], labels[:, i:i + step], m)
        cnt = cnt + m.sum()
    return nll, cnt


# ---------------------------------------------------------------------------
# Paged KV-cache primitives (the substrate Valve's reclamation operates on).
# Remapping a victim handle = rewriting its page-table entries to 0, which is
# always mapped, so no access can ever fault (paper §5).
# ---------------------------------------------------------------------------

def paged_gather(pool, page_table):
    """pool (P, pg, Hkv, Dh), page_table (B, maxp) -> (B, maxp*pg, Hkv, Dh)."""
    b, maxp = page_table.shape
    return pool[page_table.long()].reshape(b, maxp * pool.shape[1],
                                           *pool.shape[2:])


def region_gather(pool, page_table):
    """pool (B, R, pg, Hkv, Dh), page_table (B, maxp) of region-local ids
    -> (B, maxp*pg, Hkv, Dh): row b reads its own slots only."""
    b, maxp = page_table.shape
    rows = torch.arange(b, device=pool.device)[:, None]
    return pool[rows, page_table.long()].reshape(b, maxp * pool.shape[2],
                                                 *pool.shape[3:])


def kv_gather(pool, page_table):
    """Dispatch on layout: 4-D = global pool, 5-D = per-request regions."""
    return (paged_gather if pool.dim() == 4 else region_gather)(pool,
                                                                page_table)


def kv_write_prefill(pool, page_table, kv, held=None):
    """In-place write of a whole prefill's K or V, page by page, into
    either layout.

    kv: (B, S, Hkv, Dh), cast to the pool's dtype; page_table (B, >=
    ceil(S / page)) page ids (physical, or region-local for a 5-D pool).
    As the reference's ``mode='drop'`` scatter: an id in [-P, 0) counts from
    the end of the pool (of the row's region), and an id outside [-P, P) is
    dropped, not raised on.  The reference needs S % page == 0; here a last
    partial page is written whole, its slots past S as zeros (a row's
    length masks them, and decode writes them in turn).  ``held`` = (lo,
    P): the pool is a rank's block [lo, lo + its pages) of P pages, and only
    the ids in it are written (the other ranks hold the rest).
    """
    b, s, hkv, dh = kv.shape
    pg = pool.shape[-3]
    lo, n_pages = (0, pool.shape[-4]) if held is None else held
    if s % pg:
        kv = F.pad(kv, (0, 0, 0, 0, 0, pg - s % pg))
        s = kv.shape[1]
    idx = page_table[:, :s // pg].long()
    idx = torch.where(idx < 0, idx + n_pages, idx)
    if held is None:
        keep = (idx >= 0) & (idx < n_pages)
    else:
        keep = (idx >= lo) & (idx < lo + pool.shape[-4])
        idx = idx - lo
    chunks = kv.reshape(b, s // pg, pg, hkv, dh).to(pool.dtype)
    if pool.dim() == 4:
        pool[idx[keep]] = chunks[keep]
    else:
        rows = torch.arange(b, device=pool.device)[:, None].expand_as(idx)
        pool[rows[keep], idx[keep]] = chunks[keep]


def kv_write_tokens(pool, page_ids, offsets, kv, held=None):
    """In-place token-granular write.  page_ids/offsets: (B, C) page (a
    region-local slot for a 5-D pool) + in-page offset per token; kv: (B,
    C, Hkv, Dh), cast to the pool's dtype.  Padding tokens point at the
    quarantine page: overwriting it is harmless by design.  ``held``: as
    :func:`kv_write_prefill`'s, the tokens of other ranks' pages are not
    written."""
    if held is not None:
        lo, n = held
        ids = page_ids.long()
        ids = torch.where(ids < 0, ids + n, ids) - lo
        keep = (ids >= 0) & (ids < pool.shape[-4])
        rows = torch.arange(kv.shape[0], device=pool.device)[:, None] \
            .expand_as(ids)
        index = ((ids[keep], offsets.long()[keep]) if pool.dim() == 4 else
                 (rows[keep], ids[keep], offsets.long()[keep]))
        pool.index_put_(index, kv[keep].to(pool.dtype))
        return
    if pool.dim() == 4:
        pool.index_put_((page_ids.reshape(-1).long(),
                         offsets.reshape(-1).long()),
                        kv.reshape(-1, *kv.shape[2:]).to(pool.dtype))
        return
    rows = torch.arange(pool.shape[0], device=pool.device)[:, None]
    pool.index_put_((rows.expand_as(page_ids), page_ids.long(),
                     offsets.long()), kv.to(pool.dtype))


def kv_write_token(pool, page_ids, offsets, kv, held=None):
    """In-place single-token write per row.  kv: (B, Hkv, Dh).  ``held``:
    as :func:`kv_write_tokens`'s."""
    if held is not None:
        kv_write_tokens(pool, page_ids[:, None], offsets[:, None],
                        kv[:, None], held)
        return
    if pool.dim() == 4:
        pool.index_put_((page_ids.long(), offsets.long()), kv.to(pool.dtype))
        return
    rows = torch.arange(pool.shape[0], device=pool.device)
    pool.index_put_((rows, page_ids.long(), offsets.long()),
                    kv.to(pool.dtype))


def paged_attention_ref(q, pool_k, pool_v, page_table, lengths, *,
                        scale: Optional[float] = None):
    """Decode attention through the page table (gather + dense oracle).

    q: (B, Hq, Dh) -- one new token per request; lengths (B,) valid tokens.
    The pools may be global (P, pg, H, D) or region (B, R, pg, H, D).
    """
    b = q.shape[0]
    k = kv_gather(pool_k, page_table)          # (B, S_max, Hkv, Dh)
    v = kv_gather(pool_v, page_table)
    kv_pos = torch.arange(k.shape[1], device=q.device).expand(b, -1)
    valid = kv_pos < lengths.long()[:, None]
    out = attention(q[:, None], k, v, q_positions=lengths.long()[:, None],
                    kv_positions=kv_pos, kv_valid=valid, causal=False,
                    scale=scale)
    return out[:, 0]
