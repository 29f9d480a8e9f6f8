"""Architecture registry of the port: ``get_config("<arch-id>")`` for the
dense full-attention testbed backends and the attention-free Mamba-2
model (counterpart of ``repro/configs/__init__.py:41-45``).  Other
architectures wait for the slices that port their mixers."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (BlockSpec, ModelConfig, Stage,
                                      reduce_config, uniform_stage)

_REGISTRY = {
    "llama3.1-8b": "llama31_8b",
    "qwen2.5-14b": "qwen25_14b",
    "mamba2-1.3b": "mamba2_1p3b",
}

ALL_ARCHS = tuple(_REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"arch {name!r} is not ported; supported: "
                       f"{sorted(_REGISTRY)}")
    return importlib.import_module(
        f"repro_torch.configs.{_REGISTRY[name]}").CONFIG


__all__ = ["ALL_ARCHS", "BlockSpec", "ModelConfig", "Stage", "get_config",
           "reduce_config", "uniform_stage"]
