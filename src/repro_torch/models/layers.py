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
  ``kernels.decode_attention``, reading the (B, S, Hkv, dh) cache in place.

Prefill and ``hidden_fn`` attend with :func:`_attend_block_scan`, the
reference's blocked online-softmax scan in plain torch (the reference has no
Pallas kernel there either).
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
) -> torch.Tensor:
    """Online-softmax attention over KV chunks (the reference's scan).

    q (B, Sq, H, dh); k, v (B, Sk, Hkv, dh); *_pos (B, S*) int. Returns
    (B, Sq, H, dv) in q's dtype. Grouped heads by reshape: query head h
    attends with kv head h // G."""
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
        if causal:
            dpos = q_pos[:, :, None, None, None] - kpos[:, i][:, None, None, None, :]
            s = torch.where(dpos >= 0, s, NEG_INF)
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


def _decode_attend(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor, cache: Dict
) -> torch.Tensor:
    """Write this token's k/v at slot ``index`` of the cache (in place), then
    attend over the cache with the decode-attention kernel.

    The reference writes with ``dynamic_update_slice``, which clamps a slot
    past the end to the last one; the clamp here keeps that behaviour. The
    kernel applies the reference's mask ``kpos > 0 & pos_q - (kpos - 1) >= 0``
    to each slot's own stored position, wherever along the slots it lies."""
    b, _, h, dh = q.shape
    idx = cache["index"]
    kpos = cache["pos"]
    slot = idx.clamp(max=cache["k"].shape[1] - 1).reshape(1).long()
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
    )
    return out.reshape(b, 1, h, dh)


def attention_apply(
    params: Attention,
    x: torch.Tensor,
    cfg: ArchConfig,
    positions: torch.Tensor,
    kv_chunk: int = 1024,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Causal self-attention. Without ``cache``: x (B, S, d), the blocked
    scan. With ``cache`` (decode): x (B, 1, d); the cache dict {k, v, pos,
    index} is updated in place and returned. ``rope``: the positions'
    :func:`rope_angles`, if the caller has them already."""
    if cfg.rope_style == "mrope":
        raise NotImplementedError("M-RoPE (vlm) is not ported yet: ROADMAP Queue 1 #14")
    b, s, _ = x.shape
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    xf = _promote(x, params.w_q)
    q, k, v = xf @ params.w_q, xf @ params.w_k, xf @ params.w_v
    if cfg.qkv_bias:
        q, k, v = q + params.b_q, k + params.b_k, v + params.b_v
    q = q.reshape(b, s, h, dh)
    k = k.reshape(b, s, hkv, dh)
    v = v.reshape(b, s, hkv, dh)
    if cfg.rope_style == "rope":
        cos, sin = rope if rope is not None else rope_angles(positions, dh, cfg.rope_theta)
        q, k = _rotate(q, cos, sin), _rotate(k, cos, sin)

    if cache is None:
        out = _attend_block_scan(
            q, k, v, positions, positions, causal=True, kv_chunk=min(kv_chunk, s)
        )
    else:
        if s != 1:
            raise ValueError(f"decode takes one token per sequence, got {s}")
        # the reference casts the decode output to x's dtype before w_o
        out = _decode_attend(q, k, v, positions, cache).to(x.dtype)
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


# -------------------------------------------------------------- embedding --
class Embedding(nn.Module):
    """``tok`` (V, d); ``unembed`` (d, V) unless the embeddings are tied."""

    def __init__(self, cfg: ArchConfig, device=None) -> None:
        super().__init__()
        self.tok = make_param(cfg.vocab_size, cfg.d_model, cfg=cfg, device=device)
        if not cfg.tie_embeddings:
            self.unembed = make_param(cfg.d_model, cfg.vocab_size, cfg=cfg, device=device)


def embed(params: Embedding, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    e = F.embedding(tokens, params.tok)
    if cfg.name.startswith("gemma"):
        e = e * math.sqrt(cfg.d_model)
    return e.to(torch.bfloat16 if cfg.activation_dtype == "bfloat16" else torch.float32)


def unembed(params: Embedding, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Logits in x's dtype: the tied table is cast to it, as the reference
    does (``x @ tok.T.astype(x.dtype)``: a bf16 product by default)."""
    if cfg.tie_embeddings:
        return x @ params.tok.to(x.dtype).T
    return x @ params.unembed.to(x.dtype)
