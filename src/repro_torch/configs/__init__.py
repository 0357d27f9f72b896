"""Architecture registry of the port.

``get_config(arch_id)`` resolves the exact published config.  The port
serves the dense configs of the node demo (``launch/serve.py``):
qwen3-0.6b and internlm2-1.8b.
"""
from repro_torch.configs.base import (
    ModelConfig, ShapeConfig, SHAPES, cell_supported, reduced,
)

from repro_torch.configs import internlm2_1_8b, qwen3_0_6b

_ALL = {m.CONFIG.name: m.CONFIG for m in (internlm2_1_8b, qwen3_0_6b)}


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
