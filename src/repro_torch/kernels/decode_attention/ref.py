"""Plain PyTorch version of GQA flash-decode attention.

One query token per sequence against a KV cache, in float32: the
reference's ``repro.kernels.decode_attention.ref.decode_attention``, per-
sequence ``lengths`` included (columns at or past ``lengths[b]`` score
−1e30), plus the decode mask of ``repro.models.layers.attention_apply``
over each slot's stored position: with ``key_pos`` (the cache's positions
stored +1, 0 for an empty slot) and ``q_pos``, slot l of sequence b is
valid when ``key_pos[b, l] > 0`` and ``key_pos[b, l] - 1 <= q_pos[b]``,
and, with a sliding ``window``, ``q_pos[b] - (key_pos[b, l] - 1) < window``
(the reference's ``dpos < window``). A key must pass every mask given. It is the oracle the CUDA kernel is held
against and the route a CPU tensor takes.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    key_pos: Optional[torch.Tensor] = None,
    q_pos: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """q (B, H, dh), caches (B, Hkv, S, dh), lengths (B,) int or None (all
    S valid), key_pos (B, S) and q_pos (B,) int or both None, window an int
    or None (taken with key_pos only) → (B, H, dh) float32. Head h attends
    with kv head h // G, G = H / Hkv."""
    b, h, dh = q.shape
    _, hkv, s, _ = k_cache.shape
    g = h // hkv
    qf = q.float().reshape(b, hkv, g, dh)
    scores = torch.einsum("bkgd,bksd->bkgs", qf, k_cache.float()) / math.sqrt(dh)
    masks = []
    if lengths is not None:
        masks.append(torch.arange(s, device=q.device)[None, :] < lengths.to(q.device)[:, None])
    if key_pos is not None:
        kp, qp = key_pos.to(q.device), q_pos.to(q.device)[:, None]
        valid = (kp > 0) & (kp - 1 <= qp)
        if window is not None:
            valid &= qp - (kp - 1) < window
        masks.append(valid)
    if masks:
        valid = masks[0] if len(masks) == 1 else masks[0] & masks[1]
        scores = torch.where(valid[:, None, None, :], scores, -1e30)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgs,bksd->bkgd", p, v_cache.float()).reshape(b, h, dh)
