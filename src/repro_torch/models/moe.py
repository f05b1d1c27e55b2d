"""Mixture-of-Experts FFN with capacity-bounded scatter dispatch.

Counterpart of ``repro.models.moe``. Each (token, slot) of the top-k
routing gets a flat destination ``e·C + pos_in_expert`` in an (E·C + 1, d)
expert input buffer: its position within its expert comes from the
token-major cumsum of the one-hot assignments, and a slot past the
capacity C goes to the overflow row E·C. The experts' SwiGLU runs batched
over E, and the combine gathers each slot's row back, weighted by the
renormalised top-k gates.

Which tokens are dropped depends only on that order, so it is the
reference's. The scatter is ``index_add_``: every kept slot receives
exactly one row and the overflow row only zero rows, so the card's atomic
adds give the buffer the CPU's values. The reference computes all of this
outside any Pallas kernel, and so does the port: plain torch.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L


class MoE(nn.Module):
    """``router`` (d, E), ``w_gate_e`` / ``w_up_e`` (E, d, f), ``w_down_e``
    (E, f, d), and the ``shared`` FFN (width ``d_ff_shared``) when the
    config has shared experts."""

    def __init__(self, cfg: ArchConfig, device=None) -> None:
        super().__init__()
        m = cfg.moe
        d, f, e = cfg.d_model, m.d_ff_expert, m.num_experts
        self.router = L.make_param(d, e, cfg=cfg, device=device)
        self.w_gate_e = L.make_param(e, d, f, cfg=cfg, device=device)
        self.w_up_e = L.make_param(e, d, f, cfg=cfg, device=device)
        self.w_down_e = L.make_param(e, f, d, cfg=cfg, device=device)
        if m.num_shared_experts:
            self.shared = L.FFN(cfg, device, d_ff=m.d_ff_shared)


def capacity(cfg: ArchConfig, tokens: int, seq_len: int) -> int:
    """Slots an expert takes: every token at decode (``seq_len == 1``, no
    drops), else ``max(int(T·k/E·capacity_factor), 1)``."""
    m = cfg.moe
    if seq_len == 1:
        return tokens
    return max(int(tokens * m.top_k / m.num_experts * m.capacity_factor), 1)


def route(params: MoE, xf: torch.Tensor, cfg: ArchConfig, cap: int):
    """The router's f32 softmax, its top-k and the dispatch of (T, d) rows.

    Returns (probs (T, E), gates (T, k) f32, one-hot (T, k, E) int64,
    dest (T, k) int64 with E·C for a dropped slot, keep (T, k) bool)."""
    m = cfg.moe
    t, e, k = xf.shape[0], m.num_experts, m.top_k
    probs = torch.softmax(xf.float() @ params.router.float(), dim=-1)
    gates, expert = torch.topk(probs, k, dim=-1)  # descending, as lax.top_k
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    onehot = F.one_hot(expert, e)  # (T, k, E)
    flat = onehot.reshape(t * k, e)
    pos = ((flat.cumsum(0) - flat) * flat).sum(-1).reshape(t, k)  # token-major order
    keep = pos < cap
    dest = torch.where(keep, expert * cap + pos, torch.full_like(pos, e * cap))
    return probs, gates, onehot, dest, keep


def moe_apply(params: MoE, x: torch.Tensor, cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) → (y (B, S, d) in x's dtype, the switch aux loss, f32)."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = m.num_experts, m.top_k
    xf = x.reshape(t, d)
    cap = capacity(cfg, t, s)
    probs, gates, onehot, dest, keep = route(params, xf, cfg, cap)

    # dispatch: each kept slot's row into the (E·C + 1, d) buffer, in x's dtype
    rows = xf.repeat_interleave(k, dim=0) * keep.reshape(t * k, 1).to(xf.dtype)
    buf = torch.zeros(e * cap + 1, d, dtype=xf.dtype, device=x.device)
    buf.index_add_(0, dest.reshape(-1), rows)
    expert_in = buf[: e * cap].reshape(e, cap, d)

    # the experts' SwiGLU, batched over E (bf16 rows @ f32 weights: f32, as jnp promotes)
    xin = L._promote(expert_in, params.w_gate_e)
    h = F.silu(torch.bmm(xin, params.w_gate_e)) * torch.bmm(xin, params.w_up_e)
    expert_out = torch.bmm(L._promote(h, params.w_down_e), params.w_down_e)

    # combine: gather each slot's row (the overflow row is zero), weighted by its gate
    flat_out = torch.cat([expert_out.reshape(e * cap, d), expert_out.new_zeros(1, d)])
    gathered = flat_out[dest.reshape(-1)].reshape(t, k, d)
    y = (gathered * gates[..., None].to(gathered.dtype)).sum(1)
    if m.num_shared_experts:
        y = y + L.ffn_apply(params.shared, xf, cfg).to(y.dtype)

    me = probs.mean(0)  # mean gate
    ce = onehot.sum(1).float().mean(0)  # dispatch fraction
    aux = e * (me * ce).sum() / k
    return y.reshape(b, s, d).to(x.dtype), aux
