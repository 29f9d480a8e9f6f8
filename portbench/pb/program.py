"""The system under test, built from the benchmark's files: the port's
``ModelConfig`` from a configuration's ``port`` section, its ``Model``
around the weights the benchmark drew, and its engines."""
from __future__ import annotations

import dataclasses
import typing

import torch
from torch import nn

from repro_torch.configs.base import BlockSpec, ModelConfig, Stage
from repro_torch.engine.engine import InferenceEngine
from repro_torch.models.model import init_params

from pb import spec


def model_config(conf: dict) -> ModelConfig:
    """The port's ``ModelConfig`` of a configuration: ``name`` and
    ``source`` from the file, every key of its ``port`` section given to
    the field of that name (``layers``, ``spec.stages``' format, to
    ``stages``).  A field whose type is a dataclass (``moe``, ``mla``,
    ``ssm``) is built from its object, and a tuple from its list.  A key
    that names no field raises: no setting is dropped."""
    hints = typing.get_type_hints(ModelConfig)
    kw = {"name": conf["name"], "source": conf["source"]}
    for key, value in conf["port"].items():
        if key == "layers":
            kw["stages"] = tuple(
                Stage(tuple(BlockSpec(**blk) for blk in pattern), repeat)
                for pattern, repeat in spec.stages(conf["port"]))
        elif key in hints and key != "stages":
            kw[key] = _value(key, hints[key], value)
        else:
            raise ValueError(f"port key {key!r} names no field of the "
                             f"port's ModelConfig")
    return ModelConfig(**kw)


def _value(key: str, hint, value):
    """``value`` as the field ``key`` of type ``hint`` holds it."""
    for cls in (hint, *typing.get_args(hint)):
        if dataclasses.is_dataclass(cls) and isinstance(value, dict):
            names = {f.name for f in dataclasses.fields(cls)}
            if set(value) - names:
                raise ValueError(f"port key {key!r}: {cls.__name__} has no "
                                 f"field {sorted(set(value) - names)}")
            return cls(**value)
    if isinstance(value, list) and typing.get_origin(hint) is tuple:
        return tuple(value)
    return value


def layout(cfg: ModelConfig, dtype) -> dict:
    """{parameter name: (shape, dtype)} of the port's model, from its
    parameters on the meta device (no memory)."""
    meta = init_params(cfg, dtype=dtype, device="meta")
    return {n: (tuple(p.shape), p.dtype) for n, p in meta.named_parameters()}


def build_model(cfg: ModelConfig, weights: dict, dtype):
    """The port's ``Model`` holding ``weights`` (the benchmark's tensors,
    not copied): every parameter must be there at its shape and dtype."""
    model = init_params(cfg, dtype=dtype, device="meta")
    names = {n for n, _ in model.named_parameters()}
    if names != set(weights):
        raise ValueError(f"weights do not match the port's parameters: "
                         f"missing {sorted(names - set(weights))[:4]}, "
                         f"extra {sorted(set(weights) - names)[:4]}")
    for name, meta in list(model.named_parameters()):
        w = weights[name]
        if tuple(w.shape) != tuple(meta.shape) or w.dtype != meta.dtype:
            raise ValueError(f"{name}: drawn {tuple(w.shape)} {w.dtype}, "
                             f"the port holds {tuple(meta.shape)} "
                             f"{meta.dtype}")
        owner, _, key = name.rpartition(".")
        model.get_submodule(owner)[key] = nn.Parameter(w, requires_grad=False)
    return model


def build_engines(cfg: ModelConfig, model, serving: dict, device):
    """``serving["engines"]`` engines over the one weight set, as the
    port's ``launch.serve.build_engines`` makes them: odd-numbered ones
    stage prompts through chunked prefill where the config allows it."""
    return [InferenceEngine(cfg, model, max_batch=serving["max_batch"],
                            max_len=serving["max_len"],
                            page_size=serving["page_size"],
                            prefill_chunk=(serving["prefill_chunk"]
                                           if i % 2 else None),
                            device=device)
            for i in range(serving["engines"])]


DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
