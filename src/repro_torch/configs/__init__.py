"""Architecture registry: ``--arch <id>`` resolution for the port.

The ten architectures of the JAX package's ``repro.configs``, each a
field-for-field copy, and its dry-run shapes (``SHAPES``).
"""
from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      shape_applicable)
from repro_torch.configs.chatglm3_6b import CONFIG as _chatglm3
from repro_torch.configs.deepseek_moe_16b import CONFIG as _deepseek_moe
from repro_torch.configs.deepseek_v2_lite_16b import CONFIG as _deepseek_v2
from repro_torch.configs.internvl2_2b import CONFIG as _internvl
from repro_torch.configs.minitron_4b import CONFIG as _minitron
from repro_torch.configs.phi3_mini_3_8b import CONFIG as _phi3
from repro_torch.configs.qwen1_5_32b import CONFIG as _qwen1_5
from repro_torch.configs.recurrentgemma_9b import CONFIG as _recurrentgemma
from repro_torch.configs.whisper_large_v3 import CONFIG as _whisper
from repro_torch.configs.xlstm_125m import CONFIG as _xlstm

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in (_phi3, _deepseek_moe, _chatglm3, _minitron, _qwen1_5,
                        _deepseek_v2, _recurrentgemma, _xlstm,
                        _whisper, _internvl)}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; options: {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs() -> list[str]:
    return sorted(ARCHS)


__all__ = ["ARCHS", "ModelConfig", "get_config", "list_archs", "SHAPES",
           "ShapeConfig", "shape_applicable"]
