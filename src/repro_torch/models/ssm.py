"""Mamba2 blocks: the chunked SSD scan and the decode recurrence.

Counterpart of ``repro.models.ssm``, one SSM group (G = 1) as there.
Prefill and ``hidden_fn`` run the chunked SSD algorithm [arXiv:2405.21060
§6]: within a chunk, dense (L, L) products; across chunks, a scan over the
chunk states. Decode is the constant-memory recurrence
``h ← exp(Δ·A)·h + Δ·B·x``, ``y = C·h``, with a rolling (W − 1)-deep buffer
for the causal conv; the cache's two tensors are updated in place, as the
dense decode updates its KV cache.

Dtypes follow the reference's promotions (see ``layers``): ``x @ in_proj``
is f32 whatever the residual stream's dtype, so the conv, the scan and the
gated norm all run in f32, the norm at width d_inner through the RMSNorm
kernel on the card. Everything else here is plain torch: the reference has
no Pallas kernel on this path either.

On DTensors the block runs as :func:`_mamba_sharded`: two local regions
(``local_map``), the conv and the SSD scan, each device on its rows (and,
over a full sequence, its heads when ``in_proj``'s output is split over
``model`` or ``cfg.shard_ssm_heads`` pins them); the projections and the
gated norm stay DTensor ops.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.specs import TensorSpec, spec
from repro_torch.models import layers as L
from repro_torch.models import spmd


def _dims(cfg: ArchConfig) -> Tuple[int, int, int, int]:
    """(d_inner, SSD heads, d_state, conv width)."""
    ssm = cfg.ssm
    d_inner = ssm.expand * cfg.d_model
    return d_inner, d_inner // ssm.head_dim, ssm.d_state, ssm.conv_width


class Mamba(nn.Module):
    """``in_proj`` (d, 2·d_inner + 2N + H), ``conv_w`` (W, C) and
    ``conv_bias`` (C) over the C = d_inner + 2N conv channels, ``A_log``,
    ``D`` and ``dt_bias`` (H), ``gate_norm_scale`` (d_inner), ``out_proj``
    (d_inner, d)."""

    def __init__(self, cfg: ArchConfig, device=None) -> None:
        super().__init__()
        d_inner, n_heads, n, width = _dims(cfg)
        conv_ch = d_inner + 2 * n

        def param(*shape):
            return L.make_param(*shape, cfg=cfg, device=device)

        self.in_proj = param(cfg.d_model, 2 * d_inner + 2 * n + n_heads)
        self.conv_w = param(width, conv_ch)
        self.conv_bias = param(conv_ch)
        self.A_log = param(n_heads)
        self.D = param(n_heads)
        self.dt_bias = param(n_heads)
        self.gate_norm_scale = param(d_inner)
        self.out_proj = param(d_inner, cfg.d_model)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., L) → (..., L, L) segment sums ``Σ_{j<k≤i} x_k`` on and below the
    diagonal, ``-inf`` above it (``exp`` makes those 0)."""
    length = x.shape[-1]
    cum = x.cumsum(-1)
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.ones(length, length, dtype=torch.bool, device=x.device).tril()
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b_mat: torch.Tensor,
    c_mat: torch.Tensor,
    chunk: int,
    initial_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan. x (B, S, H, P), dt (B, S, H), a (H,) negative, b / c
    (B, S, N) → (y (B, S, H, P), final state (B, H, P, N) f32)."""
    bb, s, h, p = x.shape
    n = b_mat.shape[-1]
    nc = s // chunk
    assert nc * chunk == s, (s, chunk)
    xc = x.reshape(bb, nc, chunk, h, p)
    dtc = dt.reshape(bb, nc, chunk, h)
    bc = b_mat.reshape(bb, nc, chunk, n)
    cc = c_mat.reshape(bb, nc, chunk, n)

    a_bar = dtc * a  # (b, c, l, h)
    a_cum = a_bar.cumsum(2)
    # within a chunk: the quadratic, attention-like branch
    decay = torch.exp(_segsum(a_bar.movedim(-1, 2)))  # (b, c, h, l, l)
    cb = torch.einsum("bcln,bcjn->bclj", cc, bc)
    m = cb[:, :, None] * decay  # (b, c, h, l, j)
    y_diag = torch.einsum("bchlj,bcjh,bcjhp->bclhp", m, dtc, xc)

    # each chunk's end state
    state_decay = torch.exp(a_cum[:, :, -1:, :] - a_cum)  # (b, c, l, h)
    states = torch.einsum("bcln,bclh,bclhp->bchpn", bc, state_decay * dtc, xc)

    # across chunks: chunk c reads the state before it (the reference's scan
    # emits the previous carry)
    chunk_decay = torch.exp(a_cum[:, :, -1, :]).float()  # (b, c, h)
    carry = (
        initial_state.float()
        if initial_state is not None
        else torch.zeros(bb, h, p, n, dtype=torch.float32, device=x.device)
    )
    prev = []
    for i in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, i, :, None, None] + states[:, i].float()
    prev_states = torch.stack(prev, dim=1)  # (b, c, h, p, n)

    in_decay = torch.exp(a_cum)  # (b, c, l, h)
    y_off = torch.einsum("bcln,bchpn,bclh->bclhp", cc, prev_states.to(xc.dtype), in_decay)
    return (y_diag + y_off).reshape(bb, s, h, p), carry


def _causal_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d: x (B, S, C), w (W, C), the taps summed in the
    reference's order."""
    width, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = 0
    for i in range(width):
        out = out + pad[:, i : i + s, :] * w[i]
    return out + bias


def mamba_apply(
    params: Mamba, x: torch.Tensor, cfg: ArchConfig, cache: Optional[Dict[str, torch.Tensor]] = None
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Full sequence (``cache`` None): x (B, S, d). Decode: x (B, 1, d) and
    the block's cache {conv (B, W − 1, C), ssm (B, H, P, N)}, updated in
    place and returned. The output is f32 (the reference's ``y @ out_proj``);
    the block casts it to the residual stream's dtype. On DTensors,
    :func:`_mamba_sharded`."""
    if spmd.is_dtensor(x) or spmd.is_dtensor(params.in_proj):
        return _mamba_sharded(params, x, cfg, cache)
    zxbcdt = spmd.mm(L._promote(x, params.in_proj), params.in_proj)
    z, xh, dt, a, b_mat, c_mat = _mamba_inputs(
        zxbcdt, params.conv_w, params.conv_bias, params.A_log, params.dt_bias, cfg, cache
    )
    y = _mamba_scan(xh, dt, a, b_mat, c_mat, params.D, cfg, cache)
    return _mamba_out(params, x, y, z, cfg), cache


def _mamba_inputs(zxbcdt, conv_w, conv_bias, a_log, dt_bias, cfg: ArchConfig, cache):
    """The projection's split and the causal conv (at decode against the
    cache's conv buffer, updated in place) → (z, xh (B, S, H, P), dt
    (B, S, H) f32 after softplus, a (H,) = −exp(A_log), b, c (B, S, N))."""
    d_inner, n_heads, n, _ = _dims(cfg)
    bsz, s, _ = zxbcdt.shape
    z, xin, b_mat, c_mat, dt = zxbcdt.split([d_inner, d_inner, n, n, n_heads], dim=-1)
    conv_in = torch.cat([xin, b_mat, c_mat], dim=-1)  # (B, S, C)

    if cache is None:
        conv_out = F.silu(_causal_conv(conv_in, conv_w, conv_bias))
    else:
        if s != 1:
            raise ValueError(f"decode takes one token per sequence, got {s}")
        buf = torch.cat([cache["conv"], conv_in], dim=1)  # (B, W, C)
        conv_out = F.silu((buf * conv_w).sum(1, keepdim=True) + conv_bias)
        cache["conv"].copy_(buf[:, 1:])

    xin, b_mat, c_mat = conv_out.split([d_inner, n, n], dim=-1)
    xh = xin.reshape(bsz, s, n_heads, -1)  # (B, S, H, P)
    dt = F.softplus(dt.float() + dt_bias)
    a = -torch.exp(a_log.float())
    return z, xh, dt, a, b_mat, c_mat


def _mamba_scan(xh, dt, a, b_mat, c_mat, d_skip, cfg: ArchConfig, cache) -> torch.Tensor:
    """The SSD scan (full sequence) or one recurrence step against the
    cache's state (updated in place), plus the D skip → y (B, S, H, P) f32."""
    s = xh.shape[1]
    if cache is None:
        y, _ = ssd_chunked(
            xh.float(), dt, a, b_mat.float(), c_mat.float(), chunk=min(cfg.ssm.chunk, s)
        )
    else:
        hstate = cache["ssm"]  # (B, H, P, N) f32
        dt1 = dt[:, 0]  # (B, H)
        da = torch.exp(dt1 * a)
        bx = torch.einsum("bn,bhp,bh->bhpn", b_mat[:, 0].float(), xh[:, 0].float(), dt1)
        hstate.copy_(hstate * da[..., None, None] + bx)
        y = torch.einsum("bn,bhpn->bhp", c_mat[:, 0].float(), hstate)[:, None]  # (B, 1, H, P)
    return y + xh.float() * d_skip[:, None]


def _mamba_out(params: Mamba, x: torch.Tensor, y: torch.Tensor, z: torch.Tensor, cfg: ArchConfig):
    """y (B, S, H, P) through the gated RMSNorm (at d_inner, in f32) and the
    output projection."""
    bsz, s, _ = x.shape
    y = y.reshape(bsz, s, -1)
    gated = y.to(x.dtype) * F.silu(z)  # f32: the gated norm runs at d_inner in f32
    y = L.rms_norm(gated, params.gate_norm_scale, cfg.norm_eps)
    return spmd.mm(L._promote(y, params.out_proj), params.out_proj)


def _mamba_sharded(params: Mamba, x: torch.Tensor, cfg: ArchConfig, cache):
    """:func:`mamba_apply` on DTensors, in two local regions; the
    projections and the gated norm stay DTensor ops.

    * the conv region: :func:`_mamba_inputs` on each device's rows (the
      batch over the batch axes; the conv weights, and at decode the conv
      buffer, whole on each device), its outputs placed by the batch;
    * over a full sequence, with ``cfg.shard_ssm_heads`` or with
      ``in_proj``'s output split over ``model``, xh and dt are pinned to
      the reference's ``P("data", None, "model", None)`` and
      ``P("data", None, "model")`` (the heads over ``model``; a slice, no
      collective), when the heads divide;
    * the scan region: :func:`_mamba_scan` on each device's rows and heads
      (a, D and the state's heads split like xh; b and c whole).

    The conv region repeats on every ``model`` device (W taps a channel, no
    dot). At decode the cache's conv buffer and SSD state are gathered
    whole over ``model`` into the regions (the cache splits P or N there,
    not the heads) and written back into their own shards; the one-token
    recurrence then runs with every head on each ``model`` device."""
    mesh = next(t for t in (x, params.in_proj) if spmd.is_dtensor(t)).device_mesh
    _, n_heads, _, _ = _dims(cfg)
    bat = spmd.batch_entry(mesh, x.shape[0])
    rows = (bat, None, None)
    zxbcdt = spmd.mm(L._promote(x, params.in_proj), params.in_proj)
    decode = cache is not None

    def inputs(zx, conv_w, conv_b, a_log, dt_b, *conv):
        local = {"conv": conv[0]} if decode else None
        out = _mamba_inputs(zx, conv_w, conv_b, a_log, dt_b, cfg, local)
        return (*out, conv[0]) if decode else out

    small = [params.conv_w, params.conv_bias, params.A_log, params.dt_bias]
    whole = [(None,) * p.dim() for p in small]
    batch_axes = spmd.batch_axes(mesh, x.shape[0])
    outs = [rows, (bat, None, None, None), rows, (None,), rows, rows] + ([rows] if decode else [])
    res = spmd.local_region(
        inputs, outs, [rows] + whole + ([rows] if decode else []),
        mesh, zxbcdt, *small, *([cache["conv"]] if decode else []),
        # each device's rows make a pending sum of the weights' gradients; A_log's comes
        # through a, whose gradient arrives summed
        grad_specs=[None] + [spmd.Pending(w, batch_axes) for w in whole[:2]] + [None]
        + [spmd.Pending(whole[3], batch_axes)] + ([None] if decode else []),
    )
    z, xh, dt, a, b_mat, c_mat = res[:6]
    if decode:
        cache["conv"].copy_(spmd.pin(res[6], spmd.spec_of(cache["conv"])))

    heads = None
    split = cfg.shard_ssm_heads or spmd.model_dim(params.in_proj) == 1
    if split and not decode and n_heads % spmd.model_size(mesh) == 0:
        heads = "model"
        xh = spmd.pin(xh, (bat, None, "model", None))
        dt = spmd.pin(dt, (bat, None, "model"))

    def scan(xh_, dt_, a_, b_, c_, d_, *state):
        local = {"ssm": state[0]} if decode else None
        y = _mamba_scan(xh_, dt_, a_, b_, c_, d_, cfg, local)
        return (y, state[0]) if decode else y

    state = (bat, None, None, None)
    y_spec = (bat, None, heads, None)
    # with the heads split, b and c feed every device's heads: their gradients are pending sums
    bc_grad = spmd.Pending(rows, ("model",)) if heads else None
    per_head = spmd.Pending((heads,), batch_axes)
    res = spmd.local_region(
        scan, [y_spec, state] if decode else y_spec,
        [y_spec, (bat, None, heads), (heads,), rows, rows, (heads,)] + ([state] if decode else []),
        mesh, xh, dt, a, b_mat, c_mat, params.D, *([cache["ssm"]] if decode else []),
        grad_specs=[None, None, per_head, bc_grad, bc_grad, per_head] + ([None] if decode else []),
    )
    y = res[0] if decode else res
    if decode:
        cache["ssm"].copy_(spmd.pin(res[1], spmd.spec_of(cache["ssm"])))
    return _mamba_out(params, x, y, z, cfg), cache


def mamba_cache_shapes(cfg: ArchConfig, batch: int) -> Dict[str, TensorSpec]:
    """One block's decode cache, both float32: the conv's last W − 1 inputs
    (B, W − 1, C) and the SSD state (B, H, P, N)."""
    d_inner, n_heads, n, width = _dims(cfg)
    return {
        "conv": spec(batch, width - 1, d_inner + 2 * n, dtype=torch.float32),
        "ssm": spec(batch, n_heads, cfg.ssm.head_dim, n, dtype=torch.float32),
    }
