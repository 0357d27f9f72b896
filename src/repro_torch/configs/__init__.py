"""Architecture registry of the port.

``get_config(arch_id)`` resolves the exact published config.  The port
serves the dense configs of the node demo (``launch/serve.py``):
qwen3-0.6b and internlm2-1.8b; the MoE configs phi3.5-moe-42b-a6.6b and
llama4-scout-17b-a16e; and it runs rwkv6-3b.
"""
from repro_torch.configs.base import (
    ModelConfig, ShapeConfig, SHAPES, cell_supported, reduced,
)

from repro_torch.configs import (internlm2_1_8b, llama4_scout, phi3_5_moe,
                                 qwen3_0_6b, rwkv6_3b)

_ALL = {m.CONFIG.name: m.CONFIG
        for m in (internlm2_1_8b, llama4_scout, phi3_5_moe, qwen3_0_6b,
                  rwkv6_3b)}


def get_config(arch: str) -> ModelConfig:
    try:
        return _ALL[arch]
    except KeyError:
        raise KeyError(f'unknown arch {arch!r}; known: {sorted(_ALL)}') from None


def all_configs():
    return dict(_ALL)


__all__ = [
    'ModelConfig', 'ShapeConfig', 'SHAPES', 'cell_supported', 'reduced',
    'get_config', 'all_configs',
]
