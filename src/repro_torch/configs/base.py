"""Config system: architectures and input shapes.

A copy of the reference package's config system, trimmed to the configs
the port runs.  Each ``ModelConfig`` in ``configs/<id>.py`` holds
the exact published dimensions; ``reduced()`` variants (same family, tiny
dims) power the CPU tests, and the full configs run on the GPU.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # 'dense' | 'moe' | 'ssm' | 'hybrid' | 'encdec' | 'vlm'
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default: d_model // n_heads
    qk_norm: bool = False
    attn_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- MoE ---
    n_experts: int = 0
    moe_top_k: int = 0
    n_shared_experts: int = 0  # llama4-style always-on shared expert

    # --- SSM (rwkv6 / mamba2) ---
    ssm_state: int = 0          # mamba2 state size N
    ssm_head_dim: int = 64      # rwkv6 wkv head dim / mamba2 head dim P
    ssm_expand: int = 2         # mamba2 inner expansion
    conv_kernel: int = 4        # mamba2 depthwise conv width

    # --- hybrid (zamba2): shared attn+mlp block applied every k SSM layers ---
    hybrid_attn_every: int = 0
    hybrid_attn_heads: int = 0
    hybrid_attn_d_ff: int = 0

    # --- enc-dec (seamless-m4t) ---
    enc_layers: int = 0
    dec_layers: int = 0

    # --- modality frontend stub: None | 'audio' | 'vision' ---
    frontend: Optional[str] = None
    frontend_tokens: int = 0  # prefix embedding count injected at prefill

    # --- serving ---
    page_size: int = 16           # tokens per KV page
    pages_per_handle: int = 64    # equal-size reclamation handles (paper §5)

    # ---------------------------------------------------------------- helpers
    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.hd

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.hd

    @property
    def is_attention_free(self) -> bool:
        return self.family == 'ssm'

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic-memory decode path exists (SSM state or hybrid)."""
        return self.family in ('ssm', 'hybrid')

    # ------------------------------------------------------------ param math
    def _attn_params(self, d_in: Optional[int] = None) -> int:
        d = d_in if d_in is not None else self.d_model
        p = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * self.d_model
        if self.qk_norm:
            p += 2 * self.hd
        return p

    def _mlp_params(self, d_ff: Optional[int] = None) -> int:
        f = d_ff if d_ff is not None else self.d_ff
        return 3 * self.d_model * f  # SwiGLU: gate, up, down

    def param_count(self) -> int:
        """Total parameters N (for MODEL_FLOPS = 6·N·D roofline accounting)."""
        D = self.d_model
        emb = self.vocab_size * D * (1 if self.tie_embeddings else 2)
        if self.family in ('dense', 'vlm'):
            per = self._attn_params() + self._mlp_params() + 2 * D
            return emb + self.n_layers * per + D
        if self.family == 'moe':
            expert = self._mlp_params()
            per = (self._attn_params() + 2 * D + D * self.n_experts
                   + (self.n_experts + self.n_shared_experts) * expert)
            return emb + self.n_layers * per + D
        if self.family == 'ssm':  # rwkv6
            H = D // self.ssm_head_dim
            tm = (6 * D          # mu params (token-shift mixes: r,k,v,w,g,x)
                  + 2 * D * 32 + 5 * 32 * D   # low-rank data-dep decay/mix (lora dim 32)
                  + 4 * D * D    # r,k,v,g projections
                  + D * D        # output
                  + H * self.ssm_head_dim  # u (bonus)
                  + 2 * D)       # ln_x scale + decay base
            cm = 2 * D * self.d_ff + self.d_ff * 0 + self.d_ff * D  # channel mix (k,v) + recv
            per = tm + cm + 2 * D
            return emb + self.n_layers * per + D
        if self.family == 'hybrid':  # zamba2
            d_in = self.ssm_expand * D
            H = d_in // self.ssm_head_dim
            mamba = (D * (2 * d_in + 2 * self.ssm_state + H)  # in_proj (x,z,B,C,dt)
                     + self.conv_kernel * (d_in + 2 * self.ssm_state)
                     + 2 * H + d_in * D + d_in)
            per = mamba + 2 * D
            n_apps = self.n_layers // max(self.hybrid_attn_every, 1)
            d2 = 2 * D
            shared_hd = d2 // self.hybrid_attn_heads
            shared = (3 * d2 * self.hybrid_attn_heads * shared_hd
                      + self.hybrid_attn_heads * shared_hd * D
                      + 3 * D * self.hybrid_attn_d_ff + 2 * d2)
            return emb + self.n_layers * per + shared + n_apps * 0 + D
        if self.family == 'encdec':
            per_enc = self._attn_params() + self._mlp_params() + 2 * D
            per_dec = 2 * self._attn_params() + self._mlp_params() + 3 * D
            return emb + self.enc_layers * per_enc + self.dec_layers * per_dec + 2 * D
        raise ValueError(self.family)

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only top-k + shared experts)."""
        if self.family != 'moe':
            return self.param_count()
        expert = self._mlp_params()
        total = self.param_count()
        inactive = self.n_layers * (self.n_experts - self.moe_top_k) * expert
        return total - inactive


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES = {
    'train_4k':    ShapeConfig('train_4k', 4_096, 256, 'train'),
    'prefill_32k': ShapeConfig('prefill_32k', 32_768, 32, 'prefill'),
    'decode_32k':  ShapeConfig('decode_32k', 32_768, 128, 'decode'),
    'long_500k':   ShapeConfig('long_500k', 524_288, 1, 'decode'),
}


def cell_supported(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch × shape) cell runs, per DESIGN.md shape-skip rules."""
    if shape.name == 'long_500k' and not cfg.supports_long_context:
        return False, 'skipped/long-context-full-attention'
    return True, 'ok'


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    small = dict(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=512, head_dim=16,
    )
    if cfg.family == 'moe':
        small.update(n_experts=4, moe_top_k=min(cfg.moe_top_k, 2) or 1)
    if cfg.family == 'ssm':
        small.update(d_model=64, ssm_head_dim=16, d_ff=128, n_heads=4, n_kv_heads=4)
    if cfg.family == 'hybrid':
        small.update(n_layers=4, hybrid_attn_every=2, hybrid_attn_heads=4,
                     hybrid_attn_d_ff=128, ssm_state=8, ssm_head_dim=16)
    if cfg.family == 'encdec':
        small.update(enc_layers=2, dec_layers=2)
    if cfg.frontend is not None:
        small.update(frontend_tokens=8)
    small.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + '-reduced', **small)
