"""Plain PyTorch versions of WKV6: the single step, the sequential
recurrence and the chunk-parallel form (the reference's
``models/rwkv6.py``, whose ``kernels/rwkv6/ref.py`` re-exports them), and
the CUDA kernel's own tiled form.

:func:`wkv6_tiled_ref` is the kernel's plain version (the wrapper in
``ops.py`` takes it for CPU tensors only); :func:`wkv6_chunked` is what the
model's non-kernel path runs; :func:`wkv6_ref` is the oracle both are held
to.  All compute in f32: r/k/v/w (B, T, H, K), u (H, K), state (B, H, K, V).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import pad_axis_to


def wkv6_step(r, k, v, w, u, state):
    """One recurrence step.  r/k/w: (B, H, K); v: (B, H, V); state:
    (B, H, K, V) -> (y (B, H, V), new state)."""
    outer = k[..., :, None] * v[..., None, :]              # (B, H, K, V)
    y = torch.einsum('bhk,bhkv->bhv', r, state + u[..., :, None] * outer)
    return y, w[..., :, None] * state + outer


def wkv6_ref(r, k, v, w, u, state):
    """The sequential recurrence over T -> (y (B, T, H, V), final state)."""
    ys = []
    for t in range(r.shape[1]):
        y, state = wkv6_step(r[:, t], k[:, t], v[:, t], w[:, t], u, state)
        ys.append(y)
    return torch.stack(ys, dim=1), state


def wkv6_chunked(r, k, v, w, u, state, *, chunk: int = 32):
    """Chunk-parallel WKV6, equal to :func:`wkv6_ref`.

    Within a chunk (A_t = prod_{tau<=t} w_tau, A_0 = 1):
      y_t = (r_t A_{t-1}) . S_in + sum_{i<t} [(r_t A_{t-1} / A_i) . k_i] v_i
            + (r_t . (u k_t)) v_t
      S_out = A_T S_in + sum_i (A_T / A_i) k_i^T v_i
    Padded tokens carry w = 1, r = k = v = 0.  ``log(max(w, 1e-30))`` keeps
    an underflowed decay finite, and the intra-chunk factors are normalised
    at the chunk's midpoint so neither overflows f32 while the in-chunk
    decay range stays under ~170 nats.
    """
    b, t, h, dk = r.shape
    dv = v.shape[-1]
    r, k, v = (pad_axis_to(x, 1, chunk) for x in (r, k, v))
    w = pad_axis_to(w, 1, chunk, value=1.0)
    n = r.shape[1] // chunk

    def resh(x):                                          # (n, B, H, c, .)
        return x.reshape(b, n, chunk, h, x.shape[-1]).permute(1, 0, 3, 2, 4)

    rc, kc, vc, wc = resh(r), resh(k), resh(v), resh(w)
    logw = torch.log(torch.clamp_min(wc, 1e-30))
    log_a = torch.cumsum(logw, dim=-2)                    # inclusive
    a_end = torch.exp(log_a[..., -1:, :])                 # (n, B, H, 1, K)
    r_dec = rc * torch.exp(log_a - logw)                  # r_t A_{t-1}
    k_end = kc * torch.exp(log_a[..., -1:, :] - log_a)    # (A_T / A_i) k_i
    mid = log_a[..., chunk // 2:chunk // 2 + 1, :]
    r_dec_m = rc * torch.exp(log_a - logw - mid)
    k_inc_m = kc * torch.exp(mid - log_a)

    scores = torch.einsum('nbhtk,nbhsk->nbhts', r_dec_m, k_inc_m)
    causal = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                   device=r.device), diagonal=-1)
    scores = torch.where(causal, scores, 0.0)
    y_intra = torch.einsum('nbhts,nbhsv->nbhtv', scores, vc)
    y_diag = torch.einsum('nbhtk,nbhtv->nbhtv',
                          rc * (u[None, None, :, None, :] * kc), vc)
    chunk_states = torch.einsum('nbhsk,nbhsv->nbhkv', k_end, vc)
    y_inter = []
    for i in range(n):
        y_inter.append(torch.einsum('bhtk,bhkv->bhtv', r_dec[i], state))
        state = a_end[i, ..., 0, :, None] * state + chunk_states[i]
    y = y_intra + y_diag + torch.stack(y_inter)           # (n, B, H, c, V)
    y = y.permute(1, 0, 3, 2, 4).reshape(b, n * chunk, h, dv)
    return y[:, :t], state


SUB = 16            # tokens a sub-block: the rows that share a decay reference
TILE = 32           # the kernel's token tile: two sub-blocks
SAFE_TOTAL = 1e-24  # a sub-block's decay product (per channel) below which
                    # its diagonal block is summed pair by pair (~55 nats)


def tf32_round(x):
    """``x`` rounded to TF32 (10 mantissa bits, to nearest, ties away from
    zero), as ``cvt.rna.tf32.f32`` rounds: one tensor-core operand pass."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def wkv6_tiled_ref(r, k, v, w, u, state, *, tile: int = TILE,
                   tf32: bool = False):
    """The CUDA kernel's algorithm in plain f32 torch, equal to
    :func:`wkv6_ref` at any decay in [0, 1].

    Tokens go ``tile`` at a time (padded ones carry w = 1, r = k = v = 0),
    each tile in sub-blocks of ``SUB``.  Within sub-block I, running
    products (no logs, no division) give, per channel,
      F_t = prod_{start(I) <= tau < t} w_tau,  B_s = prod_{s < tau <= end(I)} w_tau,
    and the sub-block's total T_I; every factor is <= 1.  Then
      r~_t = r_t F_t,  k^_s = k_s B_s,
    and the decay between s < t is r~_t k^_s times
      - G_IJ = prod of the totals strictly between J and I, for s in an
        earlier sub-block J (<= 1);
      - 1 / T_I on the diagonal block, for a channel whose T_I >= SAFE_TOTAL
        (so no factor exceeds 1e24 and none overflows);
      - the pair's own prod_{s < tau < t} w_tau, for the other channels.
    Across tiles: r~ times the totals before I reads the carried state, and
    k^ times the totals after J writes it.  ``tf32`` rounds every product's
    operands to TF32 once (the single-pass tensor-core mutant).
    """
    if tile % SUB:
        raise ValueError(f'tile {tile} is not a multiple of {SUB}')
    b, t, h, dk = r.shape
    dv = v.shape[-1]
    nsub = tile // SUB
    r, k, v = (pad_axis_to(x, 1, tile) for x in (r, k, v))
    w = pad_axis_to(w, 1, tile, value=1.0)
    n = r.shape[1] // tile
    op = tf32_round if tf32 else (lambda x: x)

    def resh(x):                                  # (n, B, H, nsub, SUB, .)
        return x.reshape(b, n, nsub, SUB, h, x.shape[-1]).permute(
            1, 0, 4, 2, 3, 5)

    rc, kc, vc, wc = resh(r), resh(k), resh(v), resh(w)
    one = torch.ones_like(wc[..., :1, :])
    fwd = torch.cumprod(torch.cat([one, wc[..., :-1, :]], -2), -2)
    bwd = torch.cumprod(torch.cat([one, wc.flip(-2)[..., :-1, :]], -2),
                        -2).flip(-2)
    tot = fwd[..., -1, :] * wc[..., -1, :]        # (n, B, H, nsub, K)
    rt, kh = rc * fwd, kc * bwd
    safe = tot >= SAFE_TOTAL
    gdiag = torch.where(safe, 1.0 / tot, torch.zeros_like(tot))

    # the diagonal blocks' unsafe channels, pair by pair: d = t - s
    unsafe = (~safe).to(r.dtype)[..., None, :]
    ew = r.new_zeros(*rc.shape[:-1], SUB)         # (n, B, H, nsub, SUB, SUB)
    dec = torch.ones_like(wc[..., 1:, :])         # prod_{s < tau < s + d} w
    for d in range(1, SUB):
        val = (rc[..., d:, :] * kc[..., :SUB - d, :] * dec * unsafe).sum(-1)
        ew.diagonal(offset=-d, dim1=-2, dim2=-1).copy_(val)
        dec = dec[..., :-1, :] * wc[..., d:SUB - 1, :]
    bonus = torch.einsum('nbhitk,hk,nbhitk->nbhit', rc, u, kc)
    lower = torch.tril(torch.ones(SUB, SUB, dtype=torch.bool,
                                  device=r.device), diagonal=-1)

    scores = r.new_zeros(n, b, h, tile, tile)
    for i in range(nsub):
        for j in range(i + 1):
            g = gdiag[..., i, :] if j == i else \
                torch.prod(tot[..., j + 1:i, :], dim=-2)
            blk = torch.einsum('nbhtk,nbhsk->nbhts',
                               op(rt[..., i, :, :] * g[..., None, :]),
                               op(kh[..., j, :, :]))
            if j == i:
                blk = (torch.where(lower, blk, 0.0) + ew[..., i, :, :]
                       + torch.diag_embed(bonus[..., i, :]))
            scores[..., i * SUB:(i + 1) * SUB, j * SUB:(j + 1) * SUB] = blk

    apre = torch.cumprod(torch.cat([torch.ones_like(tot[..., :1, :]),
                                    tot[..., :-1, :]], -2), -2)
    apost = torch.cumprod(torch.cat([torch.ones_like(tot[..., :1, :]),
                                     tot.flip(-2)[..., :-1, :]], -2),
                          -2).flip(-2)
    a_end = apre[..., -1, :] * tot[..., -1, :]    # (n, B, H, K)

    def flat(x):                                  # (n, B, H, tile, .)
        return x.reshape(n, b, h, tile, x.shape[-1])

    r_dec = flat(rt * apre[..., None, :])
    k_end = flat(kh * apost[..., None, :])
    vt = flat(vc)
    y_intra = op(scores) @ op(vt)
    y_inter = []
    for i in range(n):
        y_inter.append(op(r_dec[i]) @ op(state))
        state = (a_end[i][..., None] * state
                 + op(k_end[i]).transpose(-1, -2) @ op(vt[i]))
    y = y_intra + torch.stack(y_inter)            # (n, B, H, tile, V)
    y = y.permute(1, 0, 3, 2, 4).reshape(b, n * tile, h, dv)
    return y[:, :t], state
