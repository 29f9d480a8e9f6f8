"""Fault-tolerant checkpointing.

Counterpart of ``repro/training/checkpoint.py``, with the same files:
trees (nested dicts and lists) are flattened to npz archives keyed by the
``|``-joined paths of their leaves (dict keys, list indices), written to
``.tmp-step-N.npz`` and published with ``os.replace`` (a crash mid-write
never corrupts the latest checkpoint), with ``LATEST`` naming the newest
step and the newest ``keep`` files kept; an optional writer thread keeps
the train loop off the disk.  A file written by either package restores
in the other: the port's trainer saves ``{"params": to_numpy_tree(model),
"opt": opt_state_to_jax(model, opt)}``, the JAX tree layout.  Leaves may
be numpy arrays, Python numbers or torch tensors (saved as numpy; bf16
widens to float32).  ``restore_checkpoint`` takes a torch ``device``
where the reference takes shardings.
"""
from __future__ import annotations

import os
import re
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch

_SEP = "|"


def _host(leaf, copy: bool = False) -> np.ndarray:
    """A leaf as a numpy array: a copy where ``copy``, since ``.numpy()`` of
    a CPU tensor (and ``np.asarray`` of an array) aliases its memory."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        t = t.to("cpu")
        return t.numpy().copy() if copy else t.numpy()
    return np.array(leaf, copy=True) if copy else np.asarray(leaf)


def _items(node):
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _flatten(tree, copy: bool = False) -> dict:
    """{``|``-joined path: numpy leaf}, dict keys in sorted order, as
    ``jax.tree_util`` orders them."""
    out = {}

    def walk(node, path):
        items = _items(node)
        if items is None:
            out[_SEP.join(path)] = _host(node, copy)
            return
        for k, v in items:
            walk(v, path + [str(k)])

    walk(tree, [])
    return out


def _map(fn, tree):
    items = _items(tree)
    if items is None:
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in items}
    return [_map(fn, v) for _, v in items]


def save_checkpoint(ckpt_dir, step: int, tree, *, keep: int = 3):
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f".tmp-step-{step}.npz"
    final = ckpt_dir / f"step-{step}.npz"
    np.savez(tmp, **_flatten(tree))
    os.replace(tmp, final)                      # atomic publish
    (ckpt_dir / "LATEST").write_text(str(step))
    # retention
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep]:
        try:
            (ckpt_dir / f"step-{s}.npz").unlink()
        except FileNotFoundError:
            pass
    return final


class AsyncCheckpointer:
    """Fire-and-forget saver: snapshot to host then write on a thread.  The
    snapshot copies every leaf, on every device, so the caller may update
    its tensors in place as soon as ``save`` returns."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None

    def save(self, ckpt_dir, step: int, tree, keep: int = 3):
        host_tree = _map(lambda a: _host(a, copy=True), tree)  # snapshot now
        self.wait()
        self._thread = threading.Thread(
            target=save_checkpoint, args=(ckpt_dir, step, host_tree),
            kwargs={"keep": keep}, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def all_steps(ckpt_dir):
    ckpt_dir = Path(ckpt_dir)
    out = []
    for f in ckpt_dir.glob("step-*.npz"):
        m = re.match(r"step-(\d+)\.npz", f.name)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir, step: Optional[int] = None,
                       target_tree=None, device=None):
    """Load a checkpoint (the latest unless ``step`` is given) as a tree of
    numpy arrays; if ``target_tree`` is given, in its structure (dicts and
    lists), else rebuilt from the flat keys (dicts whose keys are 0..n-1
    become lists); with ``device`` the leaves become torch tensors there."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    with np.load(ckpt_dir / f"step-{step}.npz") as data:
        flat = {k: data[k] for k in data.files}
    if target_tree is None:
        root: dict = {}
        for key, leaf in flat.items():
            parts = key.split(_SEP)
            node = root
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = leaf
        tree = _lists_from_intkeys(root)
    else:
        paths = iter(_flatten(_map(lambda a: 0, target_tree)))
        tree = _map(lambda _: flat[next(paths)], target_tree)
    if device is not None:
        tree = _map(lambda a: torch.from_numpy(np.array(a)).to(device), tree)
    return tree


def _lists_from_intkeys(node):
    """Dict nodes whose keys are 0..n-1 become lists (scan stacks)."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists_from_intkeys(v) for k, v in node.items()}
    keys = list(node)
    if keys and all(re.fullmatch(r"\d+", k) for k in keys):
        idx = sorted(int(k) for k in keys)
        if idx == list(range(len(idx))):
            return [node[str(i)] for i in idx]
    return node
