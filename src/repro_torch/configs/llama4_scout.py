"""llama4-scout-17b-a16e — MoE 16 experts top-1 + shared expert, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

48L, d_model=5120, 40H (GQA kv=8), d_ff=8192 (per expert), vocab=202048.
Early fusion reduced to the instructed vision stub (prefix patch embeddings).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name='llama4-scout-17b-a16e',
    family='moe',
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202_048,
    n_experts=16,
    moe_top_k=1,
    n_shared_experts=1,
    qk_norm=True,
    rope_theta=5e5,
    frontend='vision',
    frontend_tokens=2048,
)
