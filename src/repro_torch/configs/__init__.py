"""Architecture registry of the port.

``get_config(arch_id)`` resolves the exact published config.  The port
holds every config of the reference.  It serves the dense configs of the
node demo (``launch/serve.py``): qwen3-0.6b and internlm2-1.8b; the MoE
configs phi3.5-moe-42b-a6.6b and llama4-scout-17b-a16e; and it runs
rwkv6-3b, the hybrid zamba2-2.7b and the encoder-decoder
seamless-m4t-medium through ``Model``'s prefill and decode.  The trainer
(``launch/train.py``) takes every one of them but seamless-m4t-medium
(its loss needs speech frames the synthetic data does not make), and the
dense / vlm configs qwen3-14b, command-r-35b, valve-7b and
llava-next-mistral-7b.
"""
from repro_torch.configs.base import (
    ModelConfig, ShapeConfig, SHAPES, cell_supported, reduced,
)

from repro_torch.configs import (command_r_35b, internlm2_1_8b,
                                 llama4_scout, llava_next_mistral_7b,
                                 phi3_5_moe, qwen3_0_6b, qwen3_14b, rwkv6_3b,
                                 seamless_m4t_medium, valve_7b, zamba2_2_7b)

_ALL = {m.CONFIG.name: m.CONFIG
        for m in (command_r_35b, internlm2_1_8b, llama4_scout,
                  llava_next_mistral_7b, phi3_5_moe, qwen3_0_6b, qwen3_14b,
                  rwkv6_3b, seamless_m4t_medium, valve_7b, zamba2_2_7b)}


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
