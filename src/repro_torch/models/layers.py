"""Transformer building blocks of the model zoo.

Counterpart of ``repro.models.layers``. The reference declares each module's
parameters as a shape tree and applies them with pure functions; here each
module is an ``nn.Module`` whose parameters carry the reference's key names
(``w_q``, ``ln1_scale``, ``tok``, ...), and the same pure ``*_apply``
functions take the module as their ``params``. Weights are stored
``(in, out)`` as in the reference, so ``x @ w`` reads the same on both sides.

Numeric policy, as in the reference: parameters float32, the residual stream
in the config's activation dtype (bfloat16 by default). jnp promotes
``bf16 @ f32`` to an f32 product; ``torch.matmul`` refuses mixed dtypes, so
:func:`_promote` makes each promotion explicit at the same points, and each
block casts back where the reference writes ``h.astype(x.dtype)``.

Two kernels carry the layers on the card:

* every :func:`rms_norm` goes through ``kernels.rmsnorm`` (the config's eps);
* the decode branch of :func:`attention_apply` goes through
  ``kernels.decode_attention``, reading the (B, S, Hkv, dh) cache in place,
  with the sliding window's mask term when a window is set (the cache is
  then a ring: the write slot wraps).

Prefill, ``hidden_fn``, the audio encoder and cross-attention attend with
:func:`_attend_block_scan`, the reference's blocked online-softmax scan in
plain torch (the reference has no Pallas kernel there either).

Multi-head latent attention (:class:`MLA`, deepseek-v2) decodes in the
reference's absorbed form in plain torch einsums, as the reference computes
it in jnp outside any kernel. The decode kernel cannot take that shape: all
H = 128 heads share one latent "kv head" (G = 128, past the kernel's 16), and
the 576-wide key (latent 512 + rope 64) differs from the 512-wide value. A
kernel for it is later work.

On DTensor parameters (``launch.dryrun``, ``models/spmd.py``) every weight
product is ``spmd.mm``: the weight gathered over the data axes and kept on
its own ``model`` split, column parallel (the input by its batch) or row
parallel (the input split over ``model`` on its last dim, the output a
pending sum); a projection splits into heads in ``spmd.heads`` layout. The
regions run on local shards through ``local_map``, each with its
placements stated in its docstring:

* :func:`_attend_sharded`: the blocked scan, batch over the batch axes,
  heads by :func:`head_split` (the ``shard_attn_heads`` pin);
* :func:`_decode_attend_sharded` and :func:`_write_sharded`: the cache
  write into the cache's own shards, then the decode attention (the
  kernel's route with dh whole; with dh split, pending score sums and P·V
  on the local dh slice);
* :func:`_mla_decode_sharded`: MLA's absorbed decode with the latent cache
  gathered over ``model`` and the heads split over it;
* :func:`_embed_sharded`: the token lookup, vocabulary split over
  ``model`` (a pending sum).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops
from repro_torch.launch.specs import TensorSpec, spec
from repro_torch.models import spmd

NEG_INF = -1e30  # the reference's masked score

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_param(*shape: int, cfg: ArchConfig, device=None) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=_DTYPES[cfg.param_dtype], device=device))


def _promote(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x in the dtype jnp would give ``x @ w`` (bf16 with f32 → f32)."""
    return x.to(torch.promote_types(x.dtype, w.dtype))


# ------------------------------------------------------------------- init --
@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator, base_std: float = 0.02):
    """The reference's name rules, in place: ``*scale`` → 1, ``*bias`` (and
    ``*_b``, ``conv_b*``) → 0, ``A_log`` → ``log(linspace(1, 16, H))`` on a
    1-D leaf and 0 otherwise, every other parameter N(0, base_std²) drawn
    from ``generator`` on the parameter's device. Returns ``module``.

    The reference stacks repeated blocks on leading axes; here they are
    ``nn.ModuleList`` entries, whose indices stand in the parameter's name.
    Its ``A_log`` leaf has one axis more for each such index, so a lone
    Mamba block gets the linspace and every block of a built model 0, as
    the reference's own init gives them."""
    for name, p in module.named_parameters():
        parts = name.split(".")
        leaf = parts[-1]
        if "scale" in leaf:
            p.fill_(1.0)
        elif "bias" in leaf or leaf.endswith("_b") or "conv_b" in leaf:
            p.zero_()
        elif "A_log" in leaf:
            stacked = sum(part.isdigit() for part in parts)
            if p.dim() + stacked == 1:
                p.copy_(torch.linspace(1.0, 16.0, p.shape[-1]).log())
            else:
                p.zero_()
        else:
            p.normal_(0.0, base_std, generator=generator)
    return module


# ------------------------------------------------------------------- norm --
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x · rsqrt(mean(x²) + eps) · scale`` in f32, written in x's dtype:
    the RMSNorm kernel on the card, its plain version on the CPU."""
    return rmsnorm_ops.rms_norm(x, scale, eps)


# ------------------------------------------------------------------- rope --
def _rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exponents)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """cos and sin (..., S, 1, dh/2) of positions (..., S): computed once per
    forward and shared by every layer's q and k."""
    freqs = _rope_freqs(head_dim, theta, positions.device)
    angles = positions[..., :, None, None].float() * freqs
    return angles.cos(), angles.sin()


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., S, H, dh); positions broadcastable to (..., S). Split-half
    rotation in f32, written in x's dtype."""
    return _rotate(x, *rope_angles(positions, x.shape[-1], theta))


MROPE_SECTIONS = (1, 1, 2)  # temporal, height, width shares of the dh/2 frequencies


def mrope_angles(positions3: torch.Tensor, head_dim: int, theta: float):
    """Qwen2-VL M-RoPE's cos and sin (..., S, 1, dh/2) of positions3
    (3, ..., S): the dh/2 frequencies split into temporal, height and width
    sections (MROPE_SECTIONS of dh/2, the last taking the rest), each
    rotated by its own position stream."""
    half = head_dim // 2
    sec = [half * s // sum(MROPE_SECTIONS) for s in MROPE_SECTIONS]
    sec[-1] = half - sec[0] - sec[1]
    lead = positions3.shape[1:]
    pos = torch.cat(  # (..., S, half): each stream repeated over its section
        [positions3[i, ..., None].expand(*lead, n) for i, n in enumerate(sec)], dim=-1
    )
    angles = pos[..., :, None, :].float() * _rope_freqs(head_dim, theta, positions3.device)
    return angles.cos(), angles.sin()


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., S, H, dh); positions3 (3, ..., S). M-RoPE in f32, written in
    x's dtype."""
    return _rotate(x, *mrope_angles(positions3, x.shape[-1], theta))


# -------------------------------------------------------------------- ffn --
class FFN(nn.Module):
    """``w_gate``, ``w_up`` (d, f) and ``w_down`` (f, d); no gate for gelu.
    ``d_ff`` overrides the config's f (a MoE's shared expert)."""

    def __init__(self, cfg: ArchConfig, device=None, d_ff: Optional[int] = None) -> None:
        super().__init__()
        d, f = cfg.d_model, d_ff if d_ff is not None else cfg.d_ff
        if cfg.activation in ("swiglu", "geglu"):
            self.w_gate = make_param(d, f, cfg=cfg, device=device)
        self.w_up = make_param(d, f, cfg=cfg, device=device)
        self.w_down = make_param(f, d, cfg=cfg, device=device)


def ffn_apply(params: FFN, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    # jax.nn.gelu is the tanh approximation by default; F.gelu is not
    xf = _promote(x, params.w_up)
    if cfg.activation == "swiglu":
        h = F.silu(spmd.mm(xf, params.w_gate)) * spmd.mm(xf, params.w_up)
    elif cfg.activation == "geglu":
        h = F.gelu(spmd.mm(xf, params.w_gate), approximate="tanh") * spmd.mm(xf, params.w_up)
    else:  # gelu
        h = F.gelu(spmd.mm(xf, params.w_up), approximate="tanh")
    return spmd.mm(_promote(h, params.w_down), params.w_down)


# -------------------------------------------------------- blocked attention --
def _attend_block_scan(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_pos: torch.Tensor,
    k_pos: torch.Tensor,
    causal: bool,
    kv_chunk: int,
    window: Optional[int] = None,
    shard_heads: bool = False,
) -> torch.Tensor:
    """:func:`_attend_local` (the reference's blocked scan); on DTensors,
    :func:`_attend_sharded`. ``shard_heads`` (``cfg.shard_attn_heads``) pins
    the head split as the reference's ``with_sharding_constraint`` does."""
    if spmd.is_dtensor(q) or spmd.is_dtensor(k):
        return _attend_sharded(q, k, v, q_pos, k_pos, causal, kv_chunk, window, shard_heads)
    return _attend_local(q, k, v, q_pos, k_pos, causal, kv_chunk, window)


def head_split(g: int, hkv: int, model_n: int, shard_heads: bool) -> Optional[str]:
    """Which grouped head dim of the attention core (B, Sq, Hkv, G, dh)
    shards over ``model``: with ``shard_heads``, the reference's pin, G when
    G >= Hkv and else Hkv (each only if it divides); without it, Hkv when it
    divides (query heads and their kv heads then stay together), else
    neither."""
    if model_n <= 1:
        return None
    if shard_heads and g >= hkv:
        return "g" if g % model_n == 0 else None
    return "hkv" if hkv % model_n == 0 else None


def _attend_sharded(q, k, v, q_pos, k_pos, causal, kv_chunk, window, shard_heads) -> torch.Tensor:
    """The blocked scan on each device's shards (a local region): the batch
    over the mesh's batch axes, the sequences whole, and the grouped query
    (B, Sq, Hkv, G, dh) split on the head dim of :func:`head_split`. Split
    on Hkv, k and v split their heads too (query head h attends with kv
    head h // G, so a block of kv heads keeps its query heads). Split on G,
    k and v are whole over ``model`` and the output is gathered back over
    it before the heads merge. With ``shard_heads`` the grouped query is
    pinned to the reference's spec, ``P("data", None, None, "model", None)``
    (G) or ``P("data", None, "model", None, None)`` (Hkv)."""
    mesh = next(t for t in (q, k, v) if spmd.is_dtensor(t)).device_mesh
    b, sq, h, dh = q.shape
    hkv, dv = k.shape[2], v.shape[-1]
    g = h // hkv
    bat = spmd.batch_entry(mesh, b)
    split = head_split(g, hkv, spmd.model_size(mesh), shard_heads)
    kv_heads = "model" if split == "hkv" else None
    kv = (bat, None, kv_heads, None)
    pos = (bat, None)
    grouped = (bat, None, kv_heads, "model" if split == "g" else None, None)
    q5 = spmd.pin(q, kv).reshape(b, sq, hkv, g, dh)  # a view: h splits as (Hkv, G)
    q5 = spmd.pin(q5, grouped)

    def core(q5_, k_, v_, qp, kp):
        bl, _, hl, gl, _ = q5_.shape
        q4 = q5_.reshape(bl, sq, hl * gl, dh)
        out = _attend_local(q4, k_, v_, qp, kp, causal, kv_chunk, window)
        return out.reshape(bl, sq, hl, gl, dv)

    # split on G, each device's k and v gradients are its query slice's share
    kv_grad = spmd.Pending(kv, ("model",)) if split == "g" else None
    out = spmd.local_region(
        core, grouped, [grouped, kv, kv, pos, pos], mesh, q5, k, v, q_pos, k_pos,
        grad_specs=[None, kv_grad, kv_grad, None, None],
    )
    return spmd.pin(out, (bat, None, kv_heads, None, None)).reshape(b, sq, h, dv)


def _attend_local(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_pos: torch.Tensor,
    k_pos: torch.Tensor,
    causal: bool,
    kv_chunk: int,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Online-softmax attention over KV chunks (the reference's scan), on
    plain tensors.

    q (B, Sq, H, dh); k (B, Sk, Hkv, dh); v (B, Sk, Hkv, dv), dv may differ
    from dh (MLA); *_pos (B, S*) int. Key l is masked for query i where
    ``causal`` and ``q_pos[i] - k_pos[l] < 0``, or where ``window`` is set
    and ``q_pos[i] - k_pos[l] >= window``. Returns (B, Sq, H, dv) in q's
    dtype. Grouped heads by reshape: query head h attends with kv head h // G."""
    b, sq, h, dh = q.shape
    _, sk, hkv, _ = k.shape
    dv = v.shape[-1]
    g = h // hkv
    n_chunks = sk // kv_chunk
    if n_chunks * kv_chunk != sk:
        raise ValueError(f"key length {sk} is not a multiple of kv_chunk {kv_chunk}")
    qf = (q.float() * (1.0 / math.sqrt(dh))).reshape(b, sq, hkv, g, dh)
    kc = k.float().reshape(b, n_chunks, kv_chunk, hkv, dh)
    vc = v.float().reshape(b, n_chunks, kv_chunk, hkv, dv)
    kpos = k_pos.reshape(b, n_chunks, kv_chunk)

    m = torch.full((b, sq, hkv, g), NEG_INF, device=q.device)
    l = torch.zeros((b, sq, hkv, g), device=q.device)
    acc = torch.zeros((b, sq, hkv, g, dv), device=q.device)
    for i in range(n_chunks):
        s = torch.einsum("bqkgd,blkd->bqkgl", qf, kc[:, i])
        if causal or window is not None:
            dpos = q_pos[:, :, None, None, None] - kpos[:, i][:, None, None, None, :]
            keep = dpos >= 0 if causal else torch.ones_like(dpos, dtype=torch.bool)
            if window is not None:
                keep &= dpos < window
            s = torch.where(keep, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bqkgl,blkd->bqkgd", p, vc[:, i])
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(b, sq, h, dv).to(q.dtype)


class Attention(nn.Module):
    """``w_q`` (d, H·dh), ``w_k`` / ``w_v`` (d, Hkv·dh), ``w_o`` (H·dh, d),
    and ``b_q`` / ``b_k`` / ``b_v`` with ``qkv_bias``."""

    def __init__(self, cfg: ArchConfig, device=None) -> None:
        super().__init__()
        d, h, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        self.w_q = make_param(d, h * dh, cfg=cfg, device=device)
        self.w_k = make_param(d, hkv * dh, cfg=cfg, device=device)
        self.w_v = make_param(d, hkv * dh, cfg=cfg, device=device)
        self.w_o = make_param(h * dh, d, cfg=cfg, device=device)
        if cfg.qkv_bias:
            self.b_q = make_param(h * dh, cfg=cfg, device=device)
            self.b_k = make_param(hkv * dh, cfg=cfg, device=device)
            self.b_v = make_param(hkv * dh, cfg=cfg, device=device)


def _write_slot(index: torch.Tensor, slots: int, window: Optional[int]) -> torch.Tensor:
    """The (1,) slot this step writes: ``index % slots`` in a sliding
    window's ring, else ``index`` clamped to the last slot, as the
    reference's ``dynamic_update_slice`` clamps it. Stays on the device."""
    slot = index % slots if window is not None else index.clamp(max=slots - 1)
    return slot.reshape(1).long()


def _decode_attend(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    positions: torch.Tensor,
    cache: Dict,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Write this token's k/v at the step's slot of the cache (in place),
    then attend over the cache with the decode-attention kernel.

    The kernel applies the reference's mask ``kpos > 0 & pos_q - (kpos - 1)
    >= 0`` (and ``< window`` with a window) to each slot's own stored
    position, wherever along the slots it lies: a ring's wrapped slots need
    nothing more."""
    if spmd.is_dtensor(cache["k"]):
        return _decode_attend_sharded(q, k, v, positions, cache, window)
    b, _, h, dh = q.shape
    kpos = cache["pos"]  # (B, S): each slot's position, stored +1
    _write_local(window, [cache["k"], cache["v"], kpos], cache["index"], positions, k, v)
    out = decode_ops.decode_attention(
        q.reshape(b, h, dh),
        cache["k"].transpose(1, 2),
        cache["v"].transpose(1, 2),
        key_pos=kpos,
        q_pos=positions.reshape(b),
        window=window,
    )
    return out.reshape(b, 1, h, dh)


def _write_local(window, buffers, index, positions, *rows, slots=None, start=None):
    """A local region's in-place write of one decode step: ``rows`` into
    ``buffers`` at the step's slot along dim 1, the positions (+1) into the
    last buffer, and the index advanced. ``slots`` and ``start``: the
    buffers are this device's part of ``slots`` slots, from slot ``start``
    on; a slot outside it writes back what the buffer holds."""
    slot = _write_slot(index, slots or buffers[0].shape[1], window)
    news = [row.to(buf.dtype) for buf, row in zip(buffers[:-1], rows)]
    news.append((positions + 1).to(buffers[-1].dtype))
    if slots is not None:
        slot = slot - start
        inside = (slot >= 0) & (slot < buffers[0].shape[1])
        slot = slot.clamp(0, buffers[0].shape[1] - 1)
        news = [torch.where(inside, new, buf.index_select(1, slot)) for buf, new in zip(buffers, news)]
    for buf, new in zip(buffers, news):
        buf.index_copy_(1, slot, new)
    index.add_(1)


def _write_sharded(window, buffers, index, positions, rows) -> None:
    """:func:`_write_local` on each device's shards: every buffer keeps its
    own placements (the write lands in the cache, not in a copy), each new
    row is placed like its buffer but whole along the slots, the positions
    by the batch, the 0-d index replicated. Where the slots are split (the
    reference's ``cache_spec`` takes a hybrid's stacked attention cache's
    slot dim for its batch dim), each device writes the slot only if it
    holds it."""
    mesh = buffers[0].device_mesh
    specs = [spmd.spec_of(t) for t in buffers]
    row_specs = [(sp[0], None) + tuple(sp[2:]) for sp in specs[: len(rows)]]
    pos_spec = (specs[-1][0], None)
    n_buf = len(buffers)
    slots = buffers[0].shape[1]
    split = spmd.axes_of(specs[0][1])

    def write(*args):
        bufs = list(args[:n_buf])
        start = spmd.coordinate(mesh, split) * bufs[0].shape[1] if split else None
        _write_local(window, bufs, args[n_buf], args[n_buf + 1], *args[n_buf + 2 :],
                     slots=slots if split else None, start=start)
        return args[n_buf]  # the index: local_map wants an output

    spmd.local_region(
        write, (), specs + [(), pos_spec] + row_specs, mesh,
        *buffers, index, positions, *rows,
    )


def _decode_attend_sharded(q, k, v, positions, cache, window) -> torch.Tensor:
    """The decode step on a sharded cache, in local regions. The cache (B, S,
    Hkv, dh) keeps its placements (``launch.sharding.cache_spec``: the batch
    over the batch axes, the larger of Hkv and dh over ``model`` when it
    divides). With dh whole on each device, one region writes the token and
    runs ``decode_ops.decode_attention`` on the local shards. With dh split
    over ``model``, the scores are summed over the split (a pending sum,
    then one all-reduce of (B, Hkv, G, S) over ``model``), the softmax and
    P·V run on the local dh slice of V, and the (B, H, dh) output is
    gathered over ``model``: the cache itself never moves."""
    ck, cv, kpos, idx = cache["k"], cache["v"], cache["pos"], cache["index"]
    mesh = ck.device_mesh
    b, _, h, dh = q.shape
    hkv = ck.shape[2]
    g = h // hkv
    bat, _, heads, feat = spmd.spec_of(ck)
    _write_sharded(window, [ck, cv, kpos], idx, positions, [k, v])
    pos_spec = (bat, None)
    if feat is None:
        out = spmd.local_region(
            lambda q_, k_, v_, kp, qp: decode_ops.decode_attention(
                q_.reshape(q_.shape[0], -1, dh), k_.transpose(1, 2), v_.transpose(1, 2),
                key_pos=kp, q_pos=qp.reshape(-1), window=window,
            ),
            (bat, heads, None), [(bat, None, heads, None), (bat, None, heads, None),
                                 (bat, None, heads, None), pos_spec, pos_spec],
            mesh, q, ck, cv, kpos, positions,
        )
        return out.reshape(b, 1, h, dh)

    def scores_local(q_, k_):
        bl, hl = q_.shape[0], q_.shape[2]
        qf = q_.float().reshape(bl, k_.shape[2], hl // k_.shape[2], -1)
        return torch.einsum("bkgd,bskd->bkgs", qf, k_.float()) / math.sqrt(dh)

    q_spec = (bat, None, heads, feat)
    scores = spmd.local_region(
        scores_local, spmd.Pending((bat, heads, None, None), (feat,)),
        [q_spec, (bat, None, heads, feat)], mesh, q, ck,
    )
    scores = spmd.pin(scores, (bat, heads, None, None))

    def pv_local(sc, v_, kp, qp):
        valid = (kp > 0) & (kp - 1 <= qp)
        if window is not None:
            valid &= qp - (kp - 1) < window
        p = torch.softmax(torch.where(valid[:, None, None, :], sc, NEG_INF), dim=-1)
        return torch.einsum("bkgs,bskd->bkgd", p, v_.float())

    out = spmd.local_region(
        pv_local, (bat, heads, None, feat),
        [(bat, heads, None, None), (bat, None, heads, feat), pos_spec, pos_spec], mesh,
        scores, cv, kpos, positions,
    )
    # the dh slices gathered (B·H·dh per device) before the heads merge into w_o's rows
    return spmd.pin(out, (bat, heads, None, None)).reshape(b, 1, h, dh)


def attention_apply(
    params: Attention,
    x: torch.Tensor,
    cfg: ArchConfig,
    positions: torch.Tensor,
    positions3: Optional[torch.Tensor] = None,
    kv_chunk: int = 1024,
    window: Optional[int] = None,
    cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Self- or cross-attention.

    Self-attention, causal: without ``cache``, x (B, S, d) through the
    blocked scan; with ``cache`` (decode), x (B, 1, d), the cache dict {k,
    v, pos, index} updated in place and returned. q and k rotate by RoPE
    over ``positions`` or, with ``rope_style == "mrope"``, by M-RoPE over
    ``positions3`` (3, B, S); ``rope`` carries their angles
    (:func:`rope_angles` / :func:`mrope_angles`) if the caller has them.
    ``window``: keys ``window`` or more positions back are masked.

    Cross-attention (``cross_kv`` = (k, v), each (B, Sk, Hkv, dh)): the
    queries attend over every key, unrotated and unmasked."""
    b, s, _ = x.shape
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    xf = _promote(x, params.w_q)
    q = spmd.mm(xf, params.w_q)
    if cfg.qkv_bias:
        q = q + params.b_q
    q = spmd.heads(q, h).reshape(b, s, h, dh)

    if cross_kv is not None:
        k, v = cross_kv
        sk = k.shape[1]
        k_pos = torch.arange(sk, device=x.device).expand(b, sk)
        out = _attend_block_scan(
            q, k, v, positions, k_pos, causal=False, kv_chunk=min(1024, sk)
        )
        cache = None
    else:
        k, v = spmd.mm(xf, params.w_k), spmd.mm(xf, params.w_v)
        if cfg.qkv_bias:
            k, v = k + params.b_k, v + params.b_v
        k = spmd.heads(k, hkv).reshape(b, s, hkv, dh)
        v = spmd.heads(v, hkv).reshape(b, s, hkv, dh)
        if cfg.rope_style in ("rope", "mrope"):
            if rope is None:
                rope = (
                    mrope_angles(positions3, dh, cfg.rope_theta)
                    if cfg.rope_style == "mrope"
                    else rope_angles(positions, dh, cfg.rope_theta)
                )
            q, k = _rotate(q, *rope), _rotate(k, *rope)
        if cache is None:
            out = _attend_block_scan(
                q, k, v, positions, positions, causal=True, kv_chunk=min(kv_chunk, s),
                window=window, shard_heads=cfg.shard_attn_heads,
            )
        else:
            if s != 1:
                raise ValueError(f"decode takes one token per sequence, got {s}")
            # the reference casts the decode output to x's dtype before w_o
            out = _decode_attend(q, k, v, positions, cache, window).to(x.dtype)
    y = spmd.mm(_promote(out.reshape(b, s, h * dh), params.w_o), params.w_o)
    return y, cache


def attention_cache_shapes(
    cfg: ArchConfig, batch: int, cache_len: int, dtype: torch.dtype = torch.bfloat16
) -> Dict[str, TensorSpec]:
    """One layer's decode cache: k, v (B, S, Hkv, dh); slot positions
    (B, S) int32 stored +1 (0 = empty); the write index, a 0-d int32."""
    hkv, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    return {
        "k": spec(batch, cache_len, hkv, dh, dtype=dtype),
        "v": spec(batch, cache_len, hkv, dh, dtype=dtype),
        "pos": spec(batch, cache_len, dtype=torch.int32),
        "index": spec(dtype=torch.int32),
    }


# ---------------------------------------------------------------- MLA ------
class MLA(nn.Module):
    """DeepSeek-V2 multi-head latent attention: ``w_dkv`` (d, r) into the kv
    latent and its ``kv_norm_scale``, ``w_kr`` (d, dr) for the shared rope
    key, ``w_uk`` (r, H·dn) and ``w_uv`` (r, H·dv) out of the latent, ``w_o``
    (H·dv, d); queries through ``w_dq`` (d, rq), ``q_norm_scale`` and
    ``w_uq`` (rq, H·(dn + dr)) with a q latent (``q_lora_rank``), else
    ``w_q`` (d, H·(dn + dr))."""

    def __init__(self, cfg: ArchConfig, device=None) -> None:
        super().__init__()
        m, d, h = cfg.mla, cfg.d_model, cfg.num_heads
        r, dq = m.kv_lora_rank, h * (m.nope_head_dim + m.rope_head_dim)
        self.w_dkv = make_param(d, r, cfg=cfg, device=device)
        self.w_kr = make_param(d, m.rope_head_dim, cfg=cfg, device=device)
        self.w_uk = make_param(r, h * m.nope_head_dim, cfg=cfg, device=device)
        self.w_uv = make_param(r, h * m.v_head_dim, cfg=cfg, device=device)
        self.w_o = make_param(h * m.v_head_dim, d, cfg=cfg, device=device)
        self.kv_norm_scale = make_param(r, cfg=cfg, device=device)
        if m.q_lora_rank:
            self.w_dq = make_param(d, m.q_lora_rank, cfg=cfg, device=device)
            self.q_norm_scale = make_param(m.q_lora_rank, cfg=cfg, device=device)
            self.w_uq = make_param(m.q_lora_rank, dq, cfg=cfg, device=device)
        else:
            self.w_q = make_param(d, dq, cfg=cfg, device=device)


def mla_apply(
    params: MLA,
    x: torch.Tensor,
    cfg: ArchConfig,
    positions: torch.Tensor,
    window: Optional[int] = None,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """MLA over x (B, S, d). ``rope``: :func:`rope_angles` of the positions
    at the rope head width, if the caller has them.

    Without ``cache`` (prefill): the latent expands to per-head K (nope part
    from ``w_uk``, the one rope key broadcast over the heads) and V, through
    the blocked scan with dh = dn + dr and dv, scaled by 1/sqrt(dn + dr);
    ``window`` masks there as in :func:`attention_apply`.

    With ``cache`` {c_kv, k_rope, pos, index} (decode, x (B, 1, d)): the
    absorbed form. This token's latent, rope key and position (stored +1)
    are written in place at slot ``index``, clamped to the last slot; the
    queries map into the latent space through ``w_uk``, score against the
    cached latents and rope keys, mask by the stored positions, and ``w_uv``
    applies after P·V. As in the reference, this decode takes no window: no
    ring and no window mask."""
    m = cfg.mla
    b, s, _ = x.shape
    h, r = cfg.num_heads, m.kv_lora_rank
    dn, dr, dv = m.nope_head_dim, m.rope_head_dim, m.v_head_dim
    xf = _promote(x, params.w_dkv)
    if m.q_lora_rank:
        q_lat = rms_norm(spmd.mm(xf, params.w_dq), params.q_norm_scale, cfg.norm_eps)
        q = spmd.mm(q_lat, params.w_uq)
    else:
        q = spmd.mm(xf, params.w_q)
    q = spmd.heads(q, h).reshape(b, s, h, dn + dr)
    cos, sin = rope if rope is not None else rope_angles(positions, dr, cfg.rope_theta)
    q_nope, q_rope = q[..., :dn], _rotate(q[..., dn:], cos, sin)
    c_kv = rms_norm(spmd.mm(xf, params.w_dkv), params.kv_norm_scale, cfg.norm_eps)  # (B, S, r)
    kr = spmd.rows(spmd.mm(xf, params.w_kr))
    k_rope = _rotate(kr.reshape(b, s, 1, dr), cos, sin)  # shared by the heads
    scale = 1.0 / math.sqrt(dn + dr)

    if cache is None:
        k_nope = spmd.heads(spmd.mm(c_kv, params.w_uk), h).reshape(b, s, h, dn)
        v = spmd.heads(spmd.mm(c_kv, params.w_uv), h).reshape(b, s, h, dv)
        k = torch.cat([k_nope, k_rope.expand(b, s, h, dr)], dim=-1)
        out = _attend_block_scan(
            torch.cat([q_nope, q_rope], dim=-1), k, v, positions, positions,
            causal=True, kv_chunk=min(1024, s), window=window, shard_heads=cfg.shard_attn_heads,
        )
        return spmd.mm(_promote(out.reshape(b, s, h * dv), params.w_o), params.w_o), None

    if s != 1:
        raise ValueError(f"decode takes one token per sequence, got {s}")
    cc, ckr, kpos = cache["c_kv"], cache["k_rope"], cache["pos"]
    if spmd.is_dtensor(cc):
        out = _mla_decode_sharded(
            params, cfg, q_nope, q_rope, c_kv, k_rope, positions, cache, scale
        )
    else:  # positions stored +1 (0 = empty)
        _write_local(None, [cc, ckr, kpos], cache["index"], positions, c_kv, k_rope[:, :, 0, :])
        out = _mla_absorbed(
            q_nope, q_rope, cc, ckr, kpos, positions, params.w_uk, params.w_uv, cfg, scale
        )
    return spmd.mm(_promote(out.to(x.dtype), params.w_o), params.w_o), cache


def _mla_absorbed(q_nope, q_rope, cc, ckr, kpos, positions, w_uk, w_uv, cfg, scale):
    """The absorbed attention of queries (B, S, H, ·) over a latent cache →
    (B, S, H·dv) f32: queries into the latent space through ``w_uk``, scores
    against the latents and rope keys, the stored-position mask, P·V, then
    ``w_uv``. A bf16 operand meets an f32 one promoted, as jnp's einsum
    promotes it."""
    m = cfg.mla
    r, dn, dv = m.kv_lora_rank, m.nope_head_dim, m.v_head_dim
    b, s, h = q_nope.shape[:3]  # h: the heads these queries and weights hold
    ccf = cc.float()
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope, w_uk.reshape(r, h, dn))
    scores = torch.einsum("bshr,blr->bshl", _promote(q_lat, ccf), ccf)
    ckf = ckr.float()
    scores = (scores + torch.einsum("bshd,bld->bshl", _promote(q_rope, ckf), ckf)) * scale
    dpos = positions[:, :, None, None] - (kpos[:, None, None, :] - 1)
    mask = (dpos >= 0) & (kpos[:, None, None, :] > 0)
    p = torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1)  # (B, S, H, L)
    o_lat = torch.einsum("bshl,blr->bshr", p, ccf)
    out = torch.einsum("bshr,rhd->bshd", o_lat, _promote(w_uv, o_lat).reshape(r, h, dv))
    return out.reshape(b, s, h * dv)


def _mla_decode_sharded(params, cfg, q_nope, q_rope, c_kv, k_rope, positions, cache, scale):
    """MLA's absorbed decode on a sharded latent cache, in local regions: the
    token written into the cache's own shards, then the plain absorbed form
    per device with the batch over the batch axes, the latent cache
    gathered whole, and the heads split over ``model`` when they divide
    (the queries, and ``w_uk`` / ``w_uv`` on their (H·d) dim; every score
    sums over the whole latent width). Returns (B, 1, H·dv) f32."""
    cc, ckr, kpos = cache["c_kv"], cache["k_rope"], cache["pos"]
    mesh = cc.device_mesh
    _write_sharded(None, [cc, ckr, kpos], cache["index"], positions, [c_kv, k_rope[:, :, 0, :]])
    bat = spmd.spec_of(kpos)[0]
    heads = "model" if cfg.num_heads % spmd.model_size(mesh) == 0 else None
    rows, q = (bat, None, None), (bat, None, heads, None)
    return spmd.local_region(
        lambda *a: _mla_absorbed(*a, cfg, scale), (bat, None, heads),
        [q, q, rows, rows, (bat, None), (bat, None), (None, heads), (None, heads)],
        mesh, q_nope, q_rope, cc, ckr, kpos, positions, params.w_uk, params.w_uv,
    )


def mla_cache_shapes(cfg: ArchConfig, batch: int, cache_len: int) -> Dict[str, TensorSpec]:
    """One MLA layer's decode cache: the latent c_kv (B, S, r) and the rope
    key k_rope (B, S, dr) in bf16, slot positions (B, S) int32 stored +1,
    and the write index."""
    m = cfg.mla
    return {
        "c_kv": spec(batch, cache_len, m.kv_lora_rank, dtype=torch.bfloat16),
        "k_rope": spec(batch, cache_len, m.rope_head_dim, dtype=torch.bfloat16),
        "pos": spec(batch, cache_len, dtype=torch.int32),
        "index": spec(dtype=torch.int32),
    }


# -------------------------------------------------------------- embedding --
class Embedding(nn.Module):
    """``tok`` (V, d); ``unembed`` (d, V) unless the embeddings are tied."""

    def __init__(self, cfg: ArchConfig, device=None) -> None:
        super().__init__()
        self.tok = make_param(cfg.vocab_size, cfg.d_model, cfg=cfg, device=device)
        if not cfg.tie_embeddings:
            self.unembed = make_param(cfg.d_model, cfg.vocab_size, cfg=cfg, device=device)


def act_dtype(cfg: ArchConfig) -> torch.dtype:
    """The residual stream's dtype: bfloat16 by default, else float32."""
    return torch.bfloat16 if cfg.activation_dtype == "bfloat16" else torch.float32


def _embed_sharded(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The lookup on each device's shards (a local region): the tokens by
    the batch, the table's rows split over ``model`` when the vocabulary
    divides (each device looks up the tokens its rows hold, zeros for the
    rest: a pending sum over ``model``, one all-reduce) and its columns
    whole; the table's gradient a pending sum over the batch axes."""
    mesh = table.device_mesh
    bat = spmd.batch_entry(mesh, tokens.shape[0])
    split = "model" if table.shape[0] % spmd.model_size(mesh) == 0 else None
    r = mesh.get_local_rank("model") if split else 0

    def lookup(tok, tab):
        local = tok - r * tab.shape[0]
        inside = (local >= 0) & (local < tab.shape[0])
        return F.embedding(local.clamp(0, tab.shape[0] - 1), tab) * inside[..., None].to(tab.dtype)

    rows = (bat,) + (None,) * tokens.dim()
    out = spmd.Pending(rows, ("model",)) if split else rows
    batch_axes = spmd.batch_axes(mesh, tokens.shape[0])
    return spmd.local_region(
        lookup, out, [rows[:-1], (split, None)], mesh, tokens, table,
        grad_specs=[None, spmd.Pending((split, None), batch_axes)],
    )


def embed(params: Embedding, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if spmd.is_dtensor(params.tok):
        e = _embed_sharded(tokens, params.tok)
    else:
        e = F.embedding(tokens, params.tok)
    if cfg.name.startswith("gemma"):
        e = e * math.sqrt(cfg.d_model)
    return e.to(act_dtype(cfg))


def unembed(params: Embedding, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Logits in x's dtype: the tied table is cast to it, as the reference
    does (``x @ tok.T.astype(x.dtype)``: a bf16 product by default)."""
    if cfg.tie_embeddings:
        return spmd.mm(x, params.tok.to(x.dtype).T)
    return spmd.mm(x, params.unembed.to(x.dtype))
