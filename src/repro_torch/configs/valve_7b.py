"""valve-7b — the paper's own evaluation model class (§7.2 colocates a 7B online
model with a 7B offline model).  Mistral-7B-class dense config used by the
paper-replication benchmarks; not part of the assigned-architecture pool.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name='valve-7b',
    family='dense',
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    vocab_size=32_000,
)
