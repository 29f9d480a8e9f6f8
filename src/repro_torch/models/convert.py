"""Weight bridge between the JAX parameter pytree and the port's ``Model``.

``repro.models.init_params`` draws from ``jax.random`` (``model.py:53-80``),
which torch cannot reproduce, so this bridge is how both packages compute
with the same weights.  The JAX tree holds ``embed``, ``final_norm``,
``lm_head``, ``prefix_proj`` (configs with prefix embeddings) and a
``stages`` list; each stage maps ``blk{i}`` to that pattern slot's
``attn`` (full or window attention, or MLA), ``mixer`` (mamba) and ``ffn``
(dense or MoE) dicts, whichever the layer has, with a leading repeat
axis.  A MoE ``ffn`` nests its shared experts' leaves under
``shared``; the port keeps them flat as ``shared_w_gate`` and so on
(``layers.SHARED``), since ``nn.ParameterDict`` keys cannot nest.  Leaves
keep their dtype: a bf16 tree's ``A_log``, ``D``, ``dt_bias`` and MoE
``router`` stay float32.  The
caller hands the tree over as numpy arrays
(``jax.tree.map(np.asarray, params)``), so this module needs no JAX.

The optimizer state crosses the same way: ``m`` and ``v`` (float32, keyed
like ``named_parameters``) map to and from trees of the parameters'
layout by the code that maps the parameters (:func:`jax_location`), and
``step`` (a Python int in the port) becomes a 0-d int32, as
``repro/training/optimizer.py:51-57`` holds it.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import SHARED, frozen
from repro_torch.models.model import Block, Model, check_supported

# the tree's top-level leaves, each present or not as the config says
TOP_KEYS = ("embed", "final_norm", "lm_head", "prefix_proj")


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


def _flat(part: dict) -> dict:
    """One part's leaves with the nested ``shared`` dict flattened."""
    out = {k: a for k, a in part.items() if k != "shared"}
    out.update({SHARED + k: a for k, a in part.get("shared", {}).items()})
    return out


def from_jax_params(tree, cfg: ModelConfig, *, device="cuda") -> Model:
    """The port's ``Model`` holding the weights of a JAX param tree."""
    dev = resolve_device(device)
    check_supported(cfg)
    top = {k: _to_tensor(tree[k], dev)
           for k in TOP_KEYS if k in tree}
    blocks = []
    for si, stage in enumerate(cfg.stages):
        sp = tree["stages"][si]
        for r in range(stage.repeat):
            for pi, spec in enumerate(stage.pattern):
                leaf = sp[f"blk{pi}"]
                blocks.append(Block(spec, **{
                    part: frozen({k: _to_tensor(np.asarray(a)[r], dev)
                                  for k, a in _flat(leaf[part]).items()})
                    for part in ("attn", "mixer", "ffn") if part in leaf}))
    return Model(cfg, frozen(top), blocks)


def jax_location(cfg: ModelConfig, name: str) -> Tuple[tuple, Optional[int]]:
    """Where parameter ``name`` (as ``Model.named_parameters`` names it)
    sits in the JAX tree: the path of its leaf, and the index along the
    leaf's leading repeat axis (None for a top-level leaf)."""
    parts = name.split(".")
    if parts[0] == "top":
        return (parts[1],), None
    i, part, key = int(parts[1]), parts[2], parts[3]
    for si, stage in enumerate(cfg.stages):
        if i < stage.num_layers:
            r, pi = divmod(i, len(stage.pattern))
            leaf = ("shared", key[len(SHARED):]) if key.startswith(SHARED) \
                else (key,)
            return ("stages", si, f"blk{pi}", part) + leaf, r
        i -= stage.num_layers
    raise KeyError(f"{name}: no layer {parts[1]} in {cfg.name}")


def to_numpy_tree(model: Model,
                  tensors: Optional[Dict[str, torch.Tensor]] = None) -> dict:
    """Inverse of :func:`from_jax_params`: the JAX-layout tree as numpy, of
    the model's parameters or, given ``tensors`` keyed like
    ``named_parameters`` (AdamW's ``m`` or ``v``), of those."""
    if tensors is None:
        tensors = dict(model.named_parameters())
    out: dict = {"stages": [{} for _ in model.cfg.stages]}
    rows: Dict[tuple, list] = {}
    for name, _ in model.named_parameters():
        path, r = jax_location(model.cfg, name)
        if r is None:
            out[path[0]] = _to_numpy(tensors[name])
        else:
            rows.setdefault(path, []).append(_to_numpy(tensors[name]))
    for path, leaves in rows.items():
        node = out
        for k in path[:-1]:
            node = node[k] if isinstance(k, int) else node.setdefault(k, {})
        node[path[-1]] = np.stack(leaves)
    return out


def _leaf(tree, path: tuple, r: Optional[int]):
    for k in path:
        tree = tree[k]
    return np.asarray(tree) if r is None else np.asarray(tree)[r]


def opt_state_to_jax(model: Model, opt_state: dict) -> dict:
    """The port's AdamW state as the JAX package holds it."""
    return {"m": to_numpy_tree(model, opt_state["m"]),
            "v": to_numpy_tree(model, opt_state["v"]),
            "step": np.asarray(opt_state["step"], np.int32)}


def opt_state_from_jax(tree, model: Model, *, device="cuda") -> dict:
    """Inverse of :func:`opt_state_to_jax`: ``m`` and ``v`` as float32
    tensors keyed like ``model.named_parameters()`` on ``device``."""
    dev = resolve_device(device)
    names = [n for n, _ in model.named_parameters()]
    out = {k: {n: _to_tensor(_leaf(tree[k], *jax_location(model.cfg, n)),
                             dev).float() for n in names}
           for k in ("m", "v")}
    out["step"] = int(np.asarray(tree["step"]))
    return out
