"""Weight bridge between the JAX parameter pytree and the port's ``Model``.

``repro.models.init_params`` draws from ``jax.random`` (``model.py:53-80``),
which torch cannot reproduce, so this bridge is how both packages compute
with the same weights.  The JAX tree holds ``embed``, ``final_norm``,
``lm_head`` and a ``stages`` list; each stage maps ``blk{i}`` to that
pattern slot's ``attn``, ``mixer`` (mamba) and ``ffn`` dicts, whichever the
layer has, with a leading repeat axis.  Leaves keep their dtype: a bf16
tree's ``A_log``, ``D`` and ``dt_bias`` stay float32.  The
caller hands the tree over as numpy arrays
(``jax.tree.map(np.asarray, params)``), so this module needs no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import frozen
from repro_torch.models.model import Block, Model, check_supported


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes' bf16, as JAX hands it
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """bf16 widens to float32 (exactly): numpy has no bf16 without JAX's
    ml_dtypes."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def from_jax_params(tree, cfg: ModelConfig, *, device="cuda") -> Model:
    """The port's ``Model`` holding the weights of a JAX param tree."""
    dev = resolve_device(device)
    check_supported(cfg)
    top = {k: _to_tensor(tree[k], dev)
           for k in ("embed", "final_norm", "lm_head") if k in tree}
    blocks = []
    for si, stage in enumerate(cfg.stages):
        sp = tree["stages"][si]
        for r in range(stage.repeat):
            for pi, spec in enumerate(stage.pattern):
                leaf = sp[f"blk{pi}"]
                blocks.append(Block(spec, **{
                    part: frozen({k: _to_tensor(np.asarray(a)[r], dev)
                                  for k, a in leaf[part].items()})
                    for part in ("attn", "mixer", "ffn") if part in leaf}))
    return Model(cfg, frozen(top), blocks)


def to_numpy_tree(model: Model) -> dict:
    """Inverse of :func:`from_jax_params`: the JAX-layout tree as numpy."""
    out = {k: _to_numpy(v) for k, v in model.top.items()}
    stages, i = [], 0
    for stage in model.cfg.stages:
        n = len(stage.pattern)
        blocks = model.layers[i:i + stage.num_layers]
        i += stage.num_layers
        sp = {}
        for pi in range(n):
            reps = [blocks[r * n + pi] for r in range(stage.repeat)]
            sp[f"blk{pi}"] = {
                part: {k: np.stack([_to_numpy(getattr(b, part)[k])
                                    for b in reps])
                       for k in getattr(reps[0], part)}
                for part in reps[0].parts}
        stages.append(sp)
    out["stages"] = stages
    return out
