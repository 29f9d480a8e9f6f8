"""The system under test, built from the benchmark's files: the port's
``ModelConfig`` from a configuration's ``port`` section, its ``Model``
around the weights the benchmark drew, and its engines."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import (BlockSpec, MLAConfig, ModelConfig,
                                      MoEConfig, Stage)
from repro_torch.engine.engine import InferenceEngine
from repro_torch.models.model import init_params


def model_config(conf: dict) -> ModelConfig:
    p = conf["port"]
    stages = tuple(Stage(pattern=(BlockSpec(l["mixer"], l["ffn"]),),
                         repeat=l["repeat"]) for l in p["layers"])
    return ModelConfig(
        name=conf["name"], family=p["family"], num_layers=p["num_layers"],
        d_model=p["d_model"], num_heads=p["num_heads"],
        num_kv_heads=p["num_kv_heads"], head_dim=p["head_dim"],
        d_ff=p["d_ff"], vocab_size=p["vocab_size"], stages=stages,
        moe=MoEConfig(**p["moe"]) if "moe" in p else None,
        mla=MLAConfig(**p["mla"]) if "mla" in p else None,
        rope_theta=p["rope_theta"], tie_embeddings=p["tie_embeddings"],
        act=p["act"], norm_eps=p["norm_eps"], source=conf["source"])


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
