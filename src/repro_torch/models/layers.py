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
        h = F.silu(xf @ params.w_gate) * (xf @ params.w_up)
    elif cfg.activation == "geglu":
        h = F.gelu(xf @ params.w_gate, approximate="tanh") * (xf @ params.w_up)
    else:  # gelu
        h = F.gelu(xf @ params.w_up, approximate="tanh")
    return _promote(h, params.w_down) @ params.w_down


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
) -> torch.Tensor:
    """Online-softmax attention over KV chunks (the reference's scan).

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
    b, _, h, dh = q.shape
    idx = cache["index"]
    kpos = cache["pos"]
    slot = _write_slot(idx, cache["k"].shape[1], window)
    cache["k"].index_copy_(1, slot, k.to(cache["k"].dtype))
    cache["v"].index_copy_(1, slot, v.to(cache["v"].dtype))
    kpos.index_copy_(1, slot, (positions + 1).to(kpos.dtype))  # (B, 1), stored +1
    idx.add_(1)
    out = decode_ops.decode_attention(
        q.reshape(b, h, dh),
        cache["k"].transpose(1, 2),
        cache["v"].transpose(1, 2),
        key_pos=kpos,
        q_pos=positions.reshape(b),
        window=window,
    )
    return out.reshape(b, 1, h, dh)


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
    q = xf @ params.w_q
    if cfg.qkv_bias:
        q = q + params.b_q
    q = q.reshape(b, s, h, dh)

    if cross_kv is not None:
        k, v = cross_kv
        sk = k.shape[1]
        k_pos = torch.arange(sk, device=x.device).expand(b, sk)
        out = _attend_block_scan(
            q, k, v, positions, k_pos, causal=False, kv_chunk=min(1024, sk)
        )
        cache = None
    else:
        k, v = xf @ params.w_k, xf @ params.w_v
        if cfg.qkv_bias:
            k, v = k + params.b_k, v + params.b_v
        k = k.reshape(b, s, hkv, dh)
        v = v.reshape(b, s, hkv, dh)
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
                window=window,
            )
        else:
            if s != 1:
                raise ValueError(f"decode takes one token per sequence, got {s}")
            # the reference casts the decode output to x's dtype before w_o
            out = _decode_attend(q, k, v, positions, cache, window).to(x.dtype)
    y = _promote(out.reshape(b, s, h * dh), params.w_o) @ params.w_o
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
        q_lat = rms_norm(xf @ params.w_dq, params.q_norm_scale, cfg.norm_eps)
        q = q_lat @ params.w_uq
    else:
        q = xf @ params.w_q
    q = q.reshape(b, s, h, dn + dr)
    cos, sin = rope if rope is not None else rope_angles(positions, dr, cfg.rope_theta)
    q_nope, q_rope = q[..., :dn], _rotate(q[..., dn:], cos, sin)
    c_kv = rms_norm(xf @ params.w_dkv, params.kv_norm_scale, cfg.norm_eps)  # (B, S, r)
    k_rope = _rotate((xf @ params.w_kr).reshape(b, s, 1, dr), cos, sin)  # shared by the heads
    scale = 1.0 / math.sqrt(dn + dr)

    if cache is None:
        k_nope = (c_kv @ params.w_uk).reshape(b, s, h, dn)
        v = (c_kv @ params.w_uv).reshape(b, s, h, dv)
        k = torch.cat([k_nope, k_rope.expand(b, s, h, dr)], dim=-1)
        out = _attend_block_scan(
            torch.cat([q_nope, q_rope], dim=-1), k, v, positions, positions,
            causal=True, kv_chunk=min(1024, s), window=window,
        )
        return _promote(out.reshape(b, s, h * dv), params.w_o) @ params.w_o, None

    if s != 1:
        raise ValueError(f"decode takes one token per sequence, got {s}")
    cc, ckr, kpos = cache["c_kv"], cache["k_rope"], cache["pos"]
    slot = _write_slot(cache["index"], cc.shape[1], None)
    cc.index_copy_(1, slot, c_kv.to(cc.dtype))
    ckr.index_copy_(1, slot, k_rope[:, :, 0, :].to(ckr.dtype))
    kpos.index_copy_(1, slot, (positions + 1).to(kpos.dtype))  # stored +1 (0 = empty)
    cache["index"].add_(1)
    ccf = cc.float()
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope, params.w_uk.reshape(r, h, dn))
    scores = torch.einsum("bshr,blr->bshl", q_lat, ccf)
    scores = (scores + torch.einsum("bshd,bld->bshl", q_rope, ckr.float())) * scale
    dpos = positions[:, :, None, None] - (kpos[:, None, None, :] - 1)
    mask = (dpos >= 0) & (kpos[:, None, None, :] > 0)
    p = torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1)  # (B, 1, H, L)
    o_lat = torch.einsum("bshl,blr->bshr", p, ccf)
    out = torch.einsum("bshr,rhd->bshd", o_lat, params.w_uv.reshape(r, h, dv))
    out = out.reshape(b, s, h * dv).to(x.dtype)
    return _promote(out, params.w_o) @ params.w_o, cache


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


def embed(params: Embedding, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    e = F.embedding(tokens, params.tok)
    if cfg.name.startswith("gemma"):
        e = e * math.sqrt(cfg.d_model)
    return e.to(act_dtype(cfg))


def unembed(params: Embedding, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Logits in x's dtype: the tied table is cast to it, as the reference
    does (``x @ tok.T.astype(x.dtype)``: a bf16 product by default)."""
    if cfg.tie_embeddings:
        return x @ params.tok.to(x.dtype).T
    return x @ params.unembed.to(x.dtype)
