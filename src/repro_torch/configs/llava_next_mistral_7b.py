"""llava-next-mistral-7b — VLM, anyres tiling [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].

Backbone: mistral-7b — 32L, d_model=4096, 32H (GQA kv=8), d_ff=14336, vocab=32000.
[vlm] frontend is a STUB: input_specs() provides precomputed anyres patch
embeddings (B, frontend_tokens, d_model); 2880 = 576 base + 4x576 tiles.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name='llava-next-mistral-7b',
    family='vlm',
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    vocab_size=32_000,
    rope_theta=1e6,
    frontend='vision',
    frontend_tokens=2880,
)
