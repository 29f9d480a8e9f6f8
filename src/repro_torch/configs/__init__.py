"""Architecture registry of the port: ``get_config("<arch-id>")`` for every
config of the JAX package (counterpart of
``repro/configs/__init__.py:41-45``): the dense full-attention configs (the
testbed backends, minicpm-2b, qwen3-32b, and the stub-frontend
internvl2-1b and musicgen-medium), the 5:1 local:global window configs
gemma3-27b and gemma3-12b, the window + MoE mixtral-8x22b, the
attention-free Mamba-2 model, the MLA + MoE deepseek-v2-lite-16b and the
mamba/attention/MoE hybrid jamba-v0.1-52b."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (SHAPES, BlockSpec, ModelConfig,
                                      ShapeSpec, Stage, reduce_config,
                                      uniform_stage)

_REGISTRY = {
    "minicpm-2b": "minicpm_2b",
    "qwen3-32b": "qwen3_32b",
    "mamba2-1.3b": "mamba2_1p3b",
    "internvl2-1b": "internvl2_1b",
    "musicgen-medium": "musicgen_medium",
    "llama3.1-8b": "llama31_8b",
    "qwen2.5-14b": "qwen25_14b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite",
    "jamba-v0.1-52b": "jamba_52b",
    "gemma3-27b": "gemma3_27b",
    "gemma3-12b": "gemma3_12b",
    "mixtral-8x22b": "mixtral_8x22b",
}

ALL_ARCHS = tuple(_REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"arch {name!r} is not ported; supported: "
                       f"{sorted(_REGISTRY)}")
    return importlib.import_module(
        f"repro_torch.configs.{_REGISTRY[name]}").CONFIG


__all__ = ["ALL_ARCHS", "SHAPES", "BlockSpec", "ModelConfig", "ShapeSpec",
           "Stage", "get_config", "reduce_config", "uniform_stage"]
