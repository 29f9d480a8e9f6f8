"""Architecture registry of the port: ``get_config("<arch-id>")`` for every
config of the JAX package (counterpart of
``repro/configs/__init__.py:41-45``): the dense full-attention configs (the
testbed backends, minicpm-2b, qwen3-32b, and the stub-frontend
internvl2-1b and musicgen-medium), the 5:1 local:global window configs
gemma3-27b and gemma3-12b, the window + MoE mixtral-8x22b, the
attention-free Mamba-2 model, the MLA + MoE deepseek-v2-lite-16b and the
mamba/attention/MoE hybrid jamba-v0.1-52b; and the dry run's cell grid
(``ASSIGNED_ARCHS``, ``LONG_CONTEXT_ARCHS``, ``shape_applicable``,
``assigned_cells``: :28-61).

``get_config`` also resolves the port's own configurations
(``PORT_ONLY_ARCHS``: granite-4.0-h-small, NoPE attention and the muP
scalars, which the JAX package lacks); ``ALL_ARCHS`` stays the JAX
package's list, which the tests that compare with it iterate."""
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

# configurations of the port alone, with no counterpart in the JAX package
PORT_ONLY_ARCHS = {
    "granite-4.0-h-small": "granite4_h_small",
}

# the dry run's grid (``repro/configs/__init__.py:28-61``), in the
# reference's order, which ``_REGISTRY`` above does not keep
ASSIGNED_ARCHS = ("gemma3-27b", "minicpm-2b", "gemma3-12b", "qwen3-32b",
                  "jamba-v0.1-52b", "mamba2-1.3b", "deepseek-v2-lite-16b",
                  "mixtral-8x22b", "internvl2-1b", "musicgen-medium")

# long_500k runs only for archs with a sub-quadratic or bounded-KV path
LONG_CONTEXT_ARCHS = frozenset({
    "gemma3-27b", "gemma3-12b",            # 5:1 sliding:global
    "jamba-v0.1-52b", "mamba2-1.3b",       # SSM / hybrid
    "mixtral-8x22b",                       # sliding-window attention
    "deepseek-v2-lite-16b",                # MLA compressed latent KV
})


def get_config(name: str) -> ModelConfig:
    module = _REGISTRY.get(name) or PORT_ONLY_ARCHS.get(name)
    if module is None:
        raise KeyError(f"arch {name!r} is not ported; supported: "
                       f"{sorted(_REGISTRY) + sorted(PORT_ONLY_ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{module}").CONFIG


def shape_applicable(arch: str, shape: str) -> bool:
    """Whether an (arch x shape) cell is run (vs documented-skip)."""
    if shape == "long_500k":
        return arch in LONG_CONTEXT_ARCHS
    return True


def assigned_cells(include_skipped: bool = False):
    """Yield (arch, shape_name) for the 10 x 4 grid: 36 cells run."""
    for arch in ASSIGNED_ARCHS:
        for shape in SHAPES:
            if include_skipped or shape_applicable(arch, shape):
                yield arch, shape


__all__ = ["ALL_ARCHS", "ASSIGNED_ARCHS", "LONG_CONTEXT_ARCHS",
           "PORT_ONLY_ARCHS", "SHAPES",
           "BlockSpec", "ModelConfig", "ShapeSpec", "Stage", "assigned_cells",
           "get_config", "reduce_config", "shape_applicable",
           "uniform_stage"]
