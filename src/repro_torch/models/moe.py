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

On DTensors (:func:`_moe_sharded`) the routing, the dispatch and the
combine are local regions (``local_map``) over each device's tokens, with
the reference's global capacity and positions (the devices' per-expert
slot counts gathered between them); the (E, C, d) buffer is split on C
over the batch axes, and the experts over ``model`` when E divides
(expert parallelism), else C over ``model`` too.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import spmd


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


def _gate(router: torch.Tensor, xf: torch.Tensor, cfg: ArchConfig):
    """The router's f32 softmax and top-k over (T, d) rows → (probs (T, E),
    gates (T, k) f32 renormalised, expert (T, k) int64, one-hot (T, k, E)
    int64, pos (T, k): each slot's token-major position within its
    expert)."""
    m = cfg.moe
    t, e, k = xf.shape[0], m.num_experts, m.top_k
    probs = torch.softmax(xf.float() @ router.float(), dim=-1)
    gates, expert = torch.topk(probs, k, dim=-1)  # descending, as lax.top_k
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    onehot = F.one_hot(expert, e)  # (T, k, E)
    flat = onehot.reshape(t * k, e)
    pos = ((flat.cumsum(0) - flat) * flat).sum(-1).reshape(t, k)  # token-major order
    return probs, gates, expert, onehot, pos


def route(params: MoE, xf: torch.Tensor, cfg: ArchConfig, cap: int):
    """The router's f32 softmax, its top-k and the dispatch of (T, d) rows.

    Returns (probs (T, E), gates (T, k) f32, one-hot (T, k, E) int64,
    dest (T, k) int64 with E·C for a dropped slot, keep (T, k) bool)."""
    e = cfg.moe.num_experts
    probs, gates, expert, onehot, pos = _gate(params.router, xf, cfg)
    keep = pos < cap
    dest = torch.where(keep, expert * cap + pos, torch.full_like(pos, e * cap))
    return probs, gates, onehot, dest, keep


def moe_apply(params: MoE, x: torch.Tensor, cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) → (y (B, S, d) in x's dtype, the switch aux loss, f32)."""
    if spmd.is_dtensor(x) or spmd.is_dtensor(params.router):
        return _moe_sharded(params, x, cfg)
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = m.num_experts, m.top_k
    xf = x.reshape(t, d)
    cap = capacity(cfg, t, s)
    probs, gates, onehot, dest, keep = route(params, xf, cfg, cap)

    experts = (params.w_gate_e, params.w_up_e, params.w_down_e)
    y = _dispatch_combine(xf, gates, dest, keep, *experts, cap)
    if m.num_shared_experts:
        y = y + L.ffn_apply(params.shared, xf, cfg).to(y.dtype)

    return y.reshape(b, s, d).to(x.dtype), _aux(probs, onehot, e, k)


def _aux(probs: torch.Tensor, onehot: torch.Tensor, e: int, k: int) -> torch.Tensor:
    """The switch aux loss: E · Σ_e mean gate · dispatch fraction / k."""
    return _switch(*_fractions(probs, onehot), e, k)


def _fractions(probs: torch.Tensor, onehot: torch.Tensor):
    """(each expert's mean gate, its dispatch fraction), both (E,) f32."""
    return probs.mean(0), onehot.sum(1).float().mean(0)


def _switch(me: torch.Tensor, ce: torch.Tensor, e: int, k: int) -> torch.Tensor:
    return e * (me * ce).sum() / k


def _dispatch_combine(xf, gates, dest, keep, w_gate_e, w_up_e, w_down_e, cap: int) -> torch.Tensor:
    """Each kept slot's row of xf (T, d) into the (E·C + 1, d) buffer at its
    ``dest`` (E the experts of these weights), the experts' SwiGLU, and the
    gate-weighted gather back → (T, d) f32."""
    e = w_gate_e.shape[0]
    expert_in = _dispatch(xf, dest, keep, e * cap).reshape(e, cap, xf.shape[1])
    return _combine(_experts(expert_in, w_gate_e, w_up_e, w_down_e), dest, gates)


def _dispatch(xf, dest, keep, slots: int) -> torch.Tensor:
    """Each kept slot's row of xf (T, d), in x's dtype, at its ``dest`` row
    of a (slots, d) buffer (a dropped slot's dest is the overflow row
    ``slots``, which is cut off)."""
    t, k = dest.shape
    rows = xf.repeat_interleave(k, dim=0) * keep.reshape(t * k, 1).to(xf.dtype)
    buf = torch.zeros(slots + 1, xf.shape[1], dtype=xf.dtype, device=xf.device)
    buf.index_add_(0, dest.reshape(-1), rows)
    return buf[:slots]


def _experts(expert_in, w_gate_e, w_up_e, w_down_e) -> torch.Tensor:
    """The experts' SwiGLU, batched over E (bf16 rows @ f32 weights: f32, as
    jnp promotes)."""
    xin = L._promote(expert_in, w_gate_e)
    h = F.silu(torch.bmm(xin, w_gate_e)) * torch.bmm(xin, w_up_e)
    return torch.bmm(L._promote(h, w_down_e), w_down_e)


def _combine(expert_out, dest, gates) -> torch.Tensor:
    """Each slot's row of the (E, C, d) expert output (a dropped slot's is
    zero), weighted by its gate and summed over the slots → (T, d)."""
    e, cap, d = expert_out.shape
    t, k = dest.shape
    flat_out = torch.cat([expert_out.reshape(e * cap, d), expert_out.new_zeros(1, d)])
    gathered = flat_out[dest.reshape(-1)].reshape(t, k, d)
    return (gathered * gates[..., None].to(gathered.dtype)).sum(1)


def _moe_sharded(params: MoE, x: torch.Tensor, cfg: ArchConfig):
    """:func:`moe_apply` on DTensors, with the reference's routing over all
    T = B·S tokens and its (E, C, d) expert buffer split over the mesh:

    * the routing region, over each device's tokens (the batch over the
      batch axes, repeated on every ``model`` device, the router gathered
      whole): gates, experts, each slot's token-major position within its
      expert among the device's tokens, the device's (E,) slot counts, and
      its shares of the aux loss's two means over T (pending sums over the
      batch axes; the loss is taken after);
    * the counts gathered over the batch axes (one all-gather of n × E): a
      slot's position over all T is its own plus the slots its expert
      takes on the devices before it in batch order, so with the
      reference's capacity C for T the same slots are dropped;
    * the dispatch region: each device writes its tokens' kept slots at
      their rows of its experts' (E_m, C, d) buffer, a pending sum over
      the batch axes (every row is written by one device), which is
      reduce-scattered over them on C;
    * the experts' SwiGLU as DTensor products on those rows: when E
      divides over ``model`` the experts split over it (expert
      parallelism, each device E / n experts whole, gathered over the data
      axes), else C splits over ``model`` too and every expert is whole on
      each device;
    * the combine region: the output rows gathered back over C, each
      device reading its tokens' slots, a pending sum over ``model`` under
      expert parallelism.

    The shared expert runs as DTensor ops after the regions."""
    mesh = next(t for t in (x, params.router) if spmd.is_dtensor(t)).device_mesh
    m = cfg.moe
    e, k = m.num_experts, m.top_k
    b, s, d = x.shape
    bat = spmd.batch_entry(mesh, b)
    rows, slots = (bat, None, None), (bat, None)
    batch_axes = spmd.batch_axes(mesh, b)
    n_batch = spmd.axes_size(mesh, batch_axes)
    n = spmd.model_size(mesh)
    split = n > 1 and e % n == 0
    cap = capacity(cfg, b * s, s)

    def gate(x_, router):
        probs, gates, expert, onehot, pos = _gate(router, x_.reshape(-1, d), cfg)
        counts = onehot.reshape(-1, e).sum(0, keepdim=True)  # (1, E)
        me, ce = _fractions(probs, onehot)
        return gates, expert, pos, counts, me / n_batch, ce / n_batch

    fraction = spmd.Pending((None,), batch_axes)  # each device's share of the mean over T
    gates, expert, pos, counts, me, ce = spmd.local_region(
        gate, [slots, slots, slots, slots, fraction, fraction],
        [rows, (None, None)], mesh, x, params.router,
        grad_specs=[None, spmd.Pending((None, None), batch_axes)],
    )
    aux = _switch(me, ce, e, k)
    counts = spmd.pin(counts, (None, None))  # (n_batch, E) on every device
    e_local = e // n if split else e
    first = mesh.get_local_rank("model") * e_local if split else 0
    me_at = spmd.coordinate(mesh, batch_axes)

    def local_dest(expert_, pos_, counts_):
        """This device's kept slots of its experts, at their rows of the
        (E_m·C + 1) buffer (E_m·C for every other slot)."""
        pos_ = pos_ + counts_[:me_at].sum(0)[expert_]  # the slots on earlier devices
        mine = (pos_ < cap) & (expert_ >= first) & (expert_ < first + e_local)
        dest = torch.where(mine, (expert_ - first) * cap + pos_, torch.full_like(pos_, e_local * cap))
        return dest, mine

    def dispatch(x_, expert_, pos_, counts_):
        dest, mine = local_dest(expert_, pos_, counts_)
        return _dispatch(x_.reshape(-1, d), dest, mine, e_local * cap).reshape(e_local, cap, d)

    ex_m = "model" if split else None
    summed = ("model",) if split else ()
    buf = spmd.local_region(
        dispatch, spmd.Pending((ex_m, None, None), batch_axes),
        [rows, slots, slots, (None, None)], mesh, x, expert, pos, counts,
        grad_specs=[spmd.Pending(rows, summed), None, None, None],
    )
    c_axes = batch_axes + (("model",) if n > 1 and not split else ())
    c_entry = c_axes[0] if len(c_axes) == 1 else (c_axes or None)
    expert_in = spmd.pin(buf, (ex_m, c_entry, None))  # each device's rows of C
    ws = [spmd.pin(w, (ex_m, None, None)) for w in (params.w_gate_e, params.w_up_e, params.w_down_e)]
    expert_out = _experts(expert_in, *ws)

    def combine(out_, gates_, expert_, pos_, counts_):
        dest, _ = local_dest(expert_, pos_, counts_)
        return _combine(out_, dest, gates_).reshape(-1, s, d)

    y = spmd.local_region(
        combine, spmd.Pending(rows, summed),
        [(ex_m, None, None), slots, slots, slots, (None, None)], mesh,
        expert_out, gates, expert, pos, counts,
        grad_specs=[spmd.Pending((ex_m, None, None), batch_axes), spmd.Pending(slots, summed),
                    None, None, None],
    )
    if m.num_shared_experts:
        y = y + L.ffn_apply(params.shared, x, cfg).to(y.dtype)
    return y.to(x.dtype), aux
