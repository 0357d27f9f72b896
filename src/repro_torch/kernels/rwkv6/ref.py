"""Plain PyTorch versions of WKV6: the single step, the sequential
recurrence and the chunk-parallel form (the reference's
``models/rwkv6.py``, whose ``kernels/rwkv6/ref.py`` re-exports them).

The CUDA kernel runs the sequential recurrence, so :func:`wkv6_ref` is its
plain version (the wrapper in ``ops.py`` takes it for CPU tensors only);
:func:`wkv6_chunked` is what the model's non-kernel path runs.  All three
compute in f32: r/k/v/w (B, T, H, K), u (H, K), state (B, H, K, V).
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
