"""Architecture registry: ``--arch <id>`` resolution for the port.

Only the architectures the port can serve are registered; the JAX
package's ``repro.configs`` lists the rest of the zoo.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.deepseek_moe_16b import CONFIG as _deepseek_moe
from repro_torch.configs.phi3_mini_3_8b import CONFIG as _phi3

ARCHS: dict[str, ModelConfig] = {c.name: c for c in (_phi3, _deepseek_moe)}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; options: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "ModelConfig", "get_config"]
