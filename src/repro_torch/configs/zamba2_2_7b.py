"""zamba2-2.7b — hybrid Mamba2 backbone + shared attention blocks [arXiv:2411.15242; hf].

54L Mamba2 (d_model=2560, ssm_state=64), one SHARED attention+MLP block
(32H over concat(hidden, embed) width 2*d_model, d_ff=10240) applied every 6
Mamba2 layers (9 applications), vocab=32000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name='zamba2-2.7b',
    family='hybrid',
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10_240,
    vocab_size=32_000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    conv_kernel=4,
    hybrid_attn_every=6,
    hybrid_attn_heads=32,
    hybrid_attn_d_ff=10_240,
    tie_embeddings=True,
)
