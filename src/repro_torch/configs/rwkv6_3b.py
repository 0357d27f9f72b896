"""rwkv6-3b "Finch" — attention-free, data-dependent decay [arXiv:2404.05892; hf].

32L, d_model=2560 (40 wkv heads x 64), d_ff=8960 (channel-mix), vocab=65536.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name='rwkv6-3b',
    family='ssm',
    n_layers=32,
    d_model=2560,
    n_heads=40,        # wkv heads = d_model / ssm_head_dim
    n_kv_heads=40,
    d_ff=8960,
    vocab_size=65_536,
    ssm_head_dim=64,
)
