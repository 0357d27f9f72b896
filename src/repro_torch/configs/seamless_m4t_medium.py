"""seamless-m4t-medium — enc-dec, multimodal [arXiv:2308.11596; hf].

12L (12 enc + 12 dec), d_model=1024, 16H (GQA kv=16 = MHA), d_ff=4096,
vocab=256206.  [audio] frontend is a STUB: input_specs() provides precomputed
speech frame embeddings (B, S_enc, d_model).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name='seamless-m4t-medium',
    family='encdec',
    n_layers=12,
    enc_layers=12,
    dec_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256_206,
    attn_bias=True,
    frontend='audio',
)
