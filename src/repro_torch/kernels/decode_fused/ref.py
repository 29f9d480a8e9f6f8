"""Plain PyTorch versions of the fused glue: the CPU path of
``ops.add_rms_norm``, ``ops.rope_kv_write``, ``ops.rope_kv_prefill`` and
``ops.act_mul``, and the chains the kernels are held to.

Each is the chain as the model layers wrote it before the kernels,
unchanged: ``models/layers.py`` ``rms_norm``, ``rope`` and ``_act``
(imported when called: the layers import the wrappers), with the paged and
ring index math of the engine's decode (a paged row writes position
``context_lens - 1``; a ring row of ``ring`` rows writes row ``pos %
ring``, pos clamped at 0) and the staging cache's rows of a prefill chunk
(``pos0`` onward)."""
from __future__ import annotations

from typing import Optional

import torch


def add_rms_norm_ref(x, y, w, eps: float, alpha: float = 1.0):
    """(s, rms_norm(s, w, eps)) with s = x + alpha * y (``layers.
    residual_add``: x + y where alpha is 1, else formed in fp32 and rounded
    once); y None: (x, rms_norm(x, w, eps))."""
    from repro_torch.models.layers import residual_add, rms_norm
    s = x if y is None else residual_add(x, y, alpha)
    return s, rms_norm(s, w, eps)


def rope_kv_write_ref(q, k, v, context_lens, tables, k_pages, v_pages,
                      theta: Optional[float], q_norm=None, k_norm=None,
                      eps: float = 1e-6, ring: Optional[int] = None):
    """q [B, H, hd], k/v [B, KV, hd]: the one-token projections.  Norms q
    and k where ``q_norm``/``k_norm`` are given, rotates both at each row's
    position (not at all where ``theta`` is None), stores k and v into the
    row's slot of k/v_pages [P, page, KV, hd] in place (page ``tables[b,
    row // page]``, offset ``row % page``) and returns q."""
    from repro_torch.models.layers import rms_norm, rope
    page = k_pages.shape[1]
    pos = context_lens.long() - 1
    row = pos
    if ring is not None:
        pos = pos.clamp_min(0)
        row = pos % ring
    if q_norm is not None:
        q = rms_norm(q, q_norm, eps)
        k = rms_norm(k, k_norm, eps)
    if theta is not None:
        q = rope(q[:, None], pos[:, None], theta)[:, 0]
        k = rope(k[:, None], pos[:, None], theta)[:, 0]
    idx = tables.long().gather(1, (row // page)[:, None])[:, 0] * page \
        + row % page
    k_pages.view(-1, *k_pages.shape[2:])[idx] = k
    v_pages.view(-1, *v_pages.shape[2:])[idx] = v
    return q


def rope_kv_prefill_ref(q, k, v, pos0: int, theta: Optional[float],
                        q_norm=None, k_norm=None, eps: float = 1e-6,
                        k_out=None, v_out=None):
    """q [B, L, H, hd], k/v [B, L, KV, hd]: a prompt's or chunk's
    projections, row i at position ``pos0 + i``.  ``_qkv``'s qk_norm and
    ``rope`` (none where ``theta`` is None), then, where ``k_out`` and
    ``v_out`` [B, L, KV, hd] are given, ``attn_chunk``'s two stores into
    them.  Returns (q, k), k being ``k_out`` where given."""
    from repro_torch.models.layers import rms_norm, rope
    if q_norm is not None:
        q = rms_norm(q, q_norm, eps)
        k = rms_norm(k, k_norm, eps)
    if theta is not None:
        positions = (pos0 + torch.arange(q.shape[1], device=q.device))[None]
        q = rope(q, positions, theta)
        k = rope(k, positions, theta)
    if k_out is None:
        return q, k
    k_out.copy_(k)
    v_out.copy_(v)
    return q, k_out


def act_mul_ref(g, u, act: str):
    """``_act(act)(g) * u``: silu, or tanh-gelu for ``act == "gelu"``."""
    from repro_torch.models.layers import _act
    return _act(act)(g) * u
