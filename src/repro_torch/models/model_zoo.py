"""Assemble model-zoo models from an ArchConfig.

Counterpart of ``repro.models.model_zoo``. A :class:`ModelDef` exposes what
the launchers need:

* ``init(generator)``   — the family's parameter module, seeded, on the
  generator's device;
* ``loss_fn``           — next-token cross-entropy over a (tokens, labels)
  batch, plus 0.01 × the MoE blocks' summed switch aux loss;
* ``prefill_fn``        — full-sequence forward → last-position logits;
* ``decode_fn``         — one token against the decode cache;
* ``hidden_fn``         — final-layer hidden states (the VFL extractor's);
* ``cache_shapes``      — the decode cache's spec tree for (batch, cache_len).

Four stacks are built:

* :class:`DecoderLM` (``dense``, ``moe`` and ``vlm``): pre-norm attention
  blocks, the FFN a :class:`~repro_torch.models.moe.MoE` in the ``moe``
  family. With MLA (deepseek-v2) the attention is
  :class:`~repro_torch.models.layers.MLA` and a dense first block,
  ``dense0``, comes before the MoE blocks. The ``vlm`` family (qwen2-vl)
  rotates by M-RoPE and puts the batch's patch ``embeds`` before the text;
* :class:`SSMLM` (``ssm``): Mamba2 blocks only;
* :class:`HybridLM` (``hybrid``, zamba2): n_super groups of
  ``hybrid_attn_every`` Mamba2 blocks, each group followed by the one
  shared attention block (the same weights every time, its own KV cache
  each time), then the trailing blocks;
* :class:`EncDecLM` (``audio``, seamless-m4t): a bidirectional encoder
  over the batch's frame ``embeds`` and a decoder whose blocks self-attend
  (causally, with a KV cache) and cross-attend to the encoder's output.
  Decode reads that output from the cache (``enc_out``).

A sliding window (``window_override``, or the config's ``attn_window``)
masks keys ``window`` or more positions back and makes every self-attention
KV cache a ring of ``min(cache_len, window)`` slots; MLA's decode, as the
reference's, takes no window.

The reference stacks repeated blocks on leading axes and scans them; here
they are ``nn.ModuleList``s and the axes are list indices. Decode caches
keep the reference's stacked trees (``cache_shapes``) and ``decode_fn``
updates them in place (the reference returns a new tree and donates the
old one). ``prefill_fn`` and ``decode_fn`` run without autograd.

With ``cfg.remat``, a full-sequence forward under grad runs each repeated
block under ``torch.utils.checkpoint`` (non-reentrant), where the reference
puts ``jax.checkpoint`` on each scan body: the decoder's MoE or dense
blocks (not deepseek's ``dense0``), every Mamba2 block (not zamba2's
shared attention block), the audio encoder's and decoder's blocks. The
backward then re-runs each block's forward, its RMSNorm launches included.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.specs import TensorSpec
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM

Tree = Dict[str, Any]
ModelParams = nn.Module  # a DecoderLM, SSMLM, HybridLM or EncDecLM


class DenseBlock(nn.Module):
    """One pre-norm decoder layer: ``ln1_scale``, ``attn`` (an MLA with
    ``cfg.mla``), ``ln2_scale``, and ``ffn``, or ``moe`` in its place."""

    def __init__(self, cfg: ArchConfig, device=None, use_moe: bool = False) -> None:
        super().__init__()
        self.ln1_scale = L.make_param(cfg.d_model, cfg=cfg, device=device)
        self.ln2_scale = L.make_param(cfg.d_model, cfg=cfg, device=device)
        self.attn = L.MLA(cfg, device) if cfg.mla is not None else L.Attention(cfg, device)
        if use_moe:
            self.moe = MOE.MoE(cfg, device)
        else:
            self.ffn = L.FFN(cfg, device)


def _has_dense0(cfg: ArchConfig) -> bool:
    """deepseek: an MLA MoE model's first block is dense."""
    return cfg.family == "moe" and cfg.mla is not None


class DecoderLM(nn.Module):
    """A decoder-only stack's parameters: ``embed``, ``blocks`` and
    ``final_ln_scale``; with MLA in the ``moe`` family also ``dense0``, a
    dense block at ``d_ff``, and L - 1 MoE ``blocks`` after it. The apply
    functions of :func:`build_model` take it as their ``params``."""

    def __init__(self, cfg: ArchConfig, device=None) -> None:
        super().__init__()
        use_moe = cfg.family == "moe"
        self.embed = L.Embedding(cfg, device)
        self.final_ln_scale = L.make_param(cfg.d_model, cfg=cfg, device=device)
        n = cfg.num_layers
        if _has_dense0(cfg):
            self.dense0 = DenseBlock(cfg, device)
            n -= 1
        self.blocks = nn.ModuleList(DenseBlock(cfg, device, use_moe) for _ in range(n))


class MambaBlock(nn.Module):
    """``ln_scale`` and ``mamba``: a pre-norm residual Mamba2 block."""

    def __init__(self, cfg: ArchConfig, device=None) -> None:
        super().__init__()
        self.ln_scale = L.make_param(cfg.d_model, cfg=cfg, device=device)
        self.mamba = SSM.Mamba(cfg, device)


def _mamba_stack(cfg: ArchConfig, n: int, device) -> nn.ModuleList:
    return nn.ModuleList(MambaBlock(cfg, device) for _ in range(n))


class SSMLM(nn.Module):
    """``embed``, ``blocks`` (L Mamba2 blocks) and ``final_ln_scale``."""

    def __init__(self, cfg: ArchConfig, device=None) -> None:
        super().__init__()
        self.embed = L.Embedding(cfg, device)
        self.final_ln_scale = L.make_param(cfg.d_model, cfg=cfg, device=device)
        self.blocks = _mamba_stack(cfg, cfg.num_layers, device)


def _hybrid_counts(cfg: ArchConfig) -> Tuple[int, int]:
    """(n_super, n_rest): groups of ``hybrid_attn_every`` blocks, and the
    blocks after the last group."""
    n_super = cfg.num_layers // cfg.hybrid_attn_every
    return n_super, cfg.num_layers - n_super * cfg.hybrid_attn_every


class HybridLM(nn.Module):
    """``embed``, ``final_ln_scale``, ``shared_attn`` (one
    :class:`DenseBlock`), ``super`` (n_super lists of ``hybrid_attn_every``
    Mamba2 blocks) and, when the groups leave some over, ``rest``."""

    def __init__(self, cfg: ArchConfig, device=None) -> None:
        super().__init__()
        n_super, n_rest = _hybrid_counts(cfg)
        self.embed = L.Embedding(cfg, device)
        self.final_ln_scale = L.make_param(cfg.d_model, cfg=cfg, device=device)
        self.shared_attn = DenseBlock(cfg, device)
        self.super = nn.ModuleList(
            _mamba_stack(cfg, cfg.hybrid_attn_every, device) for _ in range(n_super)
        )
        if n_rest:
            self.rest = _mamba_stack(cfg, n_rest, device)


class EncoderBlock(nn.Module):
    """One bidirectional encoder layer: ``ln1_scale``, ``attn``,
    ``ln2_scale``, ``ffn``."""

    def __init__(self, cfg: ArchConfig, device=None) -> None:
        super().__init__()
        self.ln1_scale = L.make_param(cfg.d_model, cfg=cfg, device=device)
        self.ln2_scale = L.make_param(cfg.d_model, cfg=cfg, device=device)
        self.attn = L.Attention(cfg, device)
        self.ffn = L.FFN(cfg, device)


class DecoderBlock(nn.Module):
    """One encoder-decoder decoder layer: ``ln1_scale`` and ``self_attn``,
    ``ln2_scale`` and ``cross_attn``, ``ln3_scale`` and ``ffn``."""

    def __init__(self, cfg: ArchConfig, device=None) -> None:
        super().__init__()
        for name in ("ln1_scale", "ln2_scale", "ln3_scale"):
            setattr(self, name, L.make_param(cfg.d_model, cfg=cfg, device=device))
        self.self_attn = L.Attention(cfg, device)
        self.cross_attn = L.Attention(cfg, device)
        self.ffn = L.FFN(cfg, device)


class EncDecLM(nn.Module):
    """``embed``, ``final_ln_scale``, ``enc_final_ln_scale``, ``enc_blocks``
    (``encoder_layers`` of them) and ``dec_blocks`` (``num_layers``)."""

    def __init__(self, cfg: ArchConfig, device=None) -> None:
        super().__init__()
        self.embed = L.Embedding(cfg, device)
        self.final_ln_scale = L.make_param(cfg.d_model, cfg=cfg, device=device)
        self.enc_final_ln_scale = L.make_param(cfg.d_model, cfg=cfg, device=device)
        self.enc_blocks = nn.ModuleList(
            EncoderBlock(cfg, device) for _ in range(cfg.encoder_layers)
        )
        self.dec_blocks = nn.ModuleList(DecoderBlock(cfg, device) for _ in range(cfg.num_layers))


_BACKBONES = {
    "dense": DecoderLM,
    "moe": DecoderLM,
    "vlm": DecoderLM,
    "ssm": SSMLM,
    "hybrid": HybridLM,
    "audio": EncDecLM,
}


def make_backbone(cfg: ArchConfig, device=None) -> ModelParams:
    """The family's parameter module, allocated (not drawn) on ``device``."""
    if cfg.family not in _BACKBONES:
        raise ValueError(f"{cfg.name}: no model family {cfg.family!r}")
    return _BACKBONES[cfg.family](cfg, device)


def _dense_block_apply(
    params: DenseBlock, x: torch.Tensor, cfg: ArchConfig, positions, cache, rope=None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """One pre-norm block's output (:func:`_dense_block` without the aux)."""
    return _dense_block(params, x, cfg, positions, cache, rope, window)[0]


def _dense_block(
    params: DenseBlock, x: torch.Tensor, cfg: ArchConfig, positions, cache, rope=None,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One pre-norm block → (x, the MoE's switch aux loss, or None for a
    dense FFN)."""
    attn_in = L.rms_norm(x, params.ln1_scale, cfg.norm_eps)
    attend = L.mla_apply if cfg.mla is not None else L.attention_apply
    h, _ = attend(params.attn, attn_in, cfg, positions, window=window, cache=cache, rope=rope)
    x = x + h.to(x.dtype)
    ff_in = L.rms_norm(x, params.ln2_scale, cfg.norm_eps)
    aux = None
    if hasattr(params, "moe"):
        y, aux = MOE.moe_apply(params.moe, ff_in, cfg)
    else:
        y = L.ffn_apply(params.ffn, ff_in, cfg)
    return x + y.to(x.dtype), aux


def _remat(cfg: ArchConfig, caches) -> bool:
    """Checkpoint each block: the config asks for it, autograd records, and
    the call is a full-sequence forward (never a decode)."""
    return cfg.remat and caches is None and torch.is_grad_enabled()


def _block(fn: Callable, remat: bool, *args):
    """``fn(*args)``, under non-reentrant activation checkpointing when
    ``remat``."""
    return checkpoint(fn, *args, use_reentrant=False) if remat else fn(*args)


def _add_aux(total, aux):
    return aux if total is None else (total if aux is None else total + aux)


def _mamba_block_apply(params: MambaBlock, x: torch.Tensor, cfg: ArchConfig, cache=None) -> torch.Tensor:
    h, _ = SSM.mamba_apply(params.mamba, L.rms_norm(x, params.ln_scale, cfg.norm_eps), cfg, cache)
    return x + h.to(x.dtype)


def _layer(caches: Optional[Tree], i: int) -> Optional[Tree]:
    """Entry i of a stacked cache tree: views, so updates land in the tree."""
    if caches is None:
        return None
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in caches.items()}


def _rope(cfg: ArchConfig, positions, positions3=None):
    """Every attention layer rotates by the same angles: computed once (at
    the rope head width under MLA, from the three streams under M-RoPE)."""
    if cfg.mla is not None:
        return L.rope_angles(positions, cfg.mla.rope_head_dim, cfg.rope_theta)
    if cfg.rope_style == "rope":
        return L.rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta)
    if cfg.rope_style == "mrope":
        return L.mrope_angles(positions3, cfg.resolved_head_dim, cfg.rope_theta)
    return None


def _positions3_for(batch: int, prefix: int, total: int, device=None) -> torch.Tensor:
    """M-RoPE position streams (3, B, total) int32: the patch prefix gets a
    (t = 0, h, w) grid of side floor(sqrt(prefix)); text gets t = h = w =
    its position."""
    side = max(int(math.sqrt(max(prefix, 1))), 1)
    idx = torch.arange(total, dtype=torch.int32, device=device)
    is_text = idx >= prefix
    t = torch.where(is_text, idx, 0)
    hh = torch.where(is_text, idx, idx // side)
    ww = torch.where(is_text, idx, idx % side)
    pos3 = torch.stack([t, hh, ww])[:, None, :].expand(3, batch, total)
    return pos3


def _decoder_forward(
    params: DecoderLM,
    cfg: ArchConfig,
    x: torch.Tensor,
    positions,
    positions3,
    window: Optional[int],
    caches: Optional[Tree],
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x (B, S, d) embedded input; caches None (prefill) or the stacked
    tree, updated in place. Returns the final-normed hidden states and the
    MoE blocks' summed aux loss (None without MoE blocks; ``dense0`` adds
    none)."""
    rope = _rope(cfg, positions, positions3)
    if hasattr(params, "dense0"):
        c0 = None if caches is None else caches["dense0"]
        x = _dense_block_apply(params.dense0, x, cfg, positions, c0, rope, window)
    blocks = None if caches is None else caches["blocks"]
    remat, aux = _remat(cfg, caches), None
    for i, block in enumerate(params.blocks):
        x, a = _block(
            lambda x_, b=block, c=_layer(blocks, i): _dense_block(
                b, x_, cfg, positions, c, rope, window
            ),
            remat,
            x,
        )
        aux = _add_aux(aux, a)
    return L.rms_norm(x, params.final_ln_scale, cfg.norm_eps), aux


def _mamba_scan(blocks: nn.ModuleList, x: torch.Tensor, cfg: ArchConfig, caches) -> torch.Tensor:
    remat = _remat(cfg, caches)
    for i, block in enumerate(blocks):
        x = _block(_mamba_block_apply, remat, block, x, cfg, _layer(caches, i))
    return x


def _ssm_forward(params: SSMLM, cfg: ArchConfig, x: torch.Tensor, caches) -> torch.Tensor:
    x = _mamba_scan(params.blocks, x, cfg, None if caches is None else caches["blocks"])
    return L.rms_norm(x, params.final_ln_scale, cfg.norm_eps)


def _hybrid_forward(
    params: HybridLM, cfg: ArchConfig, x: torch.Tensor, positions, window, caches
) -> torch.Tensor:
    """Each super group's Mamba2 blocks, then the shared attention block
    against that application's own KV cache; then the trailing blocks."""
    rope = _rope(cfg, positions)
    groups = None if caches is None else caches["super"]
    for i, group in enumerate(params.super):
        cache = _layer(groups, i)
        x = _mamba_scan(group, x, cfg, None if cache is None else cache["mamba"])
        attn = None if cache is None else cache["attn"]
        x = _dense_block_apply(params.shared_attn, x, cfg, positions, attn, rope, window)
    if hasattr(params, "rest"):
        x = _mamba_scan(params.rest, x, cfg, None if caches is None else caches["rest"])
    return L.rms_norm(x, params.final_ln_scale, cfg.norm_eps)


def _sinusoidal_pos(positions: torch.Tensor, d: int) -> torch.Tensor:
    """SeamlessM4T / NLLB sinusoidal position embeddings (..., d) f32 of
    int positions (...): sin then cos over d // 2 frequencies, and a zero
    column at the end when d is odd."""
    half = d // 2
    step = torch.tensor(10000.0).log() / max(half - 1, 1)  # f32, as jnp computes it
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32) * step).to(positions.device)
    ang = positions[..., None].float() * freqs
    emb = torch.cat([ang.sin(), ang.cos()], dim=-1)
    return torch.nn.functional.pad(emb, (0, d % 2))


def _encode(params: EncDecLM, cfg: ArchConfig, embeds: torch.Tensor) -> torch.Tensor:
    """The encoder over frame embeddings (B, S, d): sinusoidal positions
    added, then bidirectional pre-norm blocks. The reference passes all-zero
    positions to the causal scan, so its mask passes every key. Returns the
    final-normed (B, S, d) in the activation dtype."""
    b, s, _ = embeds.shape
    adt = L.act_dtype(cfg)
    pos = torch.arange(s, device=embeds.device)
    x = embeds.to(adt) + _sinusoidal_pos(pos, cfg.d_model)[None].to(adt)
    positions = torch.zeros((b, s), dtype=torch.int32, device=embeds.device)

    def enc_block(block: EncoderBlock, x: torch.Tensor) -> torch.Tensor:
        attn_in = L.rms_norm(x, block.ln1_scale, cfg.norm_eps)
        h, _ = L.attention_apply(block.attn, attn_in, cfg, positions, kv_chunk=min(1024, s))
        x = x + h.to(x.dtype)
        y = L.ffn_apply(block.ffn, L.rms_norm(x, block.ln2_scale, cfg.norm_eps), cfg)
        return x + y.to(x.dtype)

    remat = _remat(cfg, None)
    for block in params.enc_blocks:
        x = _block(enc_block, remat, block, x)
    return L.rms_norm(x, params.enc_final_ln_scale, cfg.norm_eps)


def _decode_stack(
    params: EncDecLM, cfg: ArchConfig, x: torch.Tensor, positions, enc_out, window, caches
) -> torch.Tensor:
    """The decoder blocks over x (B, S, d): causal self-attention (the KV
    cache at decode), then cross-attention whose K/V each block computes
    from ``enc_out`` with its own ``cross_attn.w_k`` / ``w_v`` (at every
    step, as the reference does), then the FFN. Returns the final-normed
    hidden states."""
    b, sk = x.shape[0], enc_out.shape[1]
    hkv, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    blocks = None if caches is None else caches["blocks"]

    def dec_block(block: DecoderBlock, x: torch.Tensor, cache) -> torch.Tensor:
        attn_in = L.rms_norm(x, block.ln1_scale, cfg.norm_eps)
        h, _ = L.attention_apply(
            block.self_attn, attn_in, cfg, positions, window=window, cache=cache
        )
        x = x + h.to(x.dtype)
        ck = L.rms_norm(x, block.ln2_scale, cfg.norm_eps)
        kv_in = L._promote(enc_out, block.cross_attn.w_k)
        k = (kv_in @ block.cross_attn.w_k).reshape(b, sk, hkv, dh)
        v = (kv_in @ block.cross_attn.w_v).reshape(b, sk, hkv, dh)
        h2, _ = L.attention_apply(block.cross_attn, ck, cfg, positions, cross_kv=(k, v))
        x = x + h2.to(x.dtype)
        y = L.ffn_apply(block.ffn, L.rms_norm(x, block.ln3_scale, cfg.norm_eps), cfg)
        return x + y.to(x.dtype)

    remat = _remat(cfg, caches)
    for i, block in enumerate(params.dec_blocks):
        x = _block(dec_block, remat, block, x, _layer(blocks, i))
    return L.rms_norm(x, params.final_ln_scale, cfg.norm_eps)


def _stack(tree: Tree, n: int) -> Tree:
    """A spec tree with a leading axis of n (the reference's _stack_shapes)."""
    return {
        k: _stack(v, n) if isinstance(v, dict) else TensorSpec((n, *v.shape), v.dtype)
        for k, v in tree.items()
    }


def _ce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy over every label, the log-softmax in
    f32 (a bf16 unembed's logits are cast first)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[..., None].long())[..., 0].mean()


@dataclass(frozen=True)
class ModelDef:
    cfg: ArchConfig
    init: Callable[[torch.Generator], ModelParams]
    loss_fn: Callable[[ModelParams, Dict[str, torch.Tensor]], torch.Tensor]
    prefill_fn: Callable[[ModelParams, Dict[str, torch.Tensor]], torch.Tensor]
    decode_fn: Callable[[ModelParams, Tree, Dict[str, torch.Tensor]], Tuple[torch.Tensor, Tree]]
    cache_shapes: Callable[[int, int], Tree]
    hidden_fn: Callable[[ModelParams, Dict[str, torch.Tensor]], torch.Tensor]


def build_model(cfg: ArchConfig, window_override: Optional[int] = None) -> ModelDef:
    """The ModelDef of any zoo config. ``window_override`` forces
    sliding-window attention (the reference's long-context variant); without
    it the config's ``attn_window`` applies."""
    window = window_override if window_override is not None else cfg.attn_window

    def forward(params: ModelParams, x: torch.Tensor, positions, positions3, caches):
        """A decoder-only, SSM or hybrid stack over embedded x → (hidden
        states, the MoE aux loss or None)."""
        if cfg.family == "ssm":
            return _ssm_forward(params, cfg, x, caches), None
        if cfg.family == "hybrid":
            return _hybrid_forward(params, cfg, x, positions, window, caches), None
        return _decoder_forward(params, cfg, x, positions, positions3, window, caches)

    def init(generator: torch.Generator) -> ModelParams:
        return L.init_params(make_backbone(cfg, generator.device), generator)

    def embed_batch(params: ModelParams, batch: Dict[str, torch.Tensor]):
        """tokens, and a vlm's patch ``embeds`` before them → (x,
        positions, positions3)."""
        tokens = batch["tokens"]
        b = tokens.shape[0]
        x = L.embed(params.embed, tokens, cfg)
        prefix = 0
        if "embeds" in batch and cfg.family == "vlm":
            pre = batch["embeds"].to(x.dtype)
            x = torch.cat([pre, x], dim=1)
            prefix = pre.shape[1]
        s = x.shape[1]
        positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
        positions3 = None
        if cfg.rope_style == "mrope":
            positions3 = _positions3_for(b, prefix, s, device=x.device)
        return x, positions, positions3

    def forward_hidden(params: ModelParams, batch: Dict[str, torch.Tensor]):
        """The full-sequence forward → (final hidden states, the MoE aux
        loss or None)."""
        if cfg.family == "audio":
            enc_out = _encode(params, cfg, batch["embeds"])
            tokens = batch["tokens"]
            b, s = tokens.shape
            x = L.embed(params.embed, tokens, cfg)
            pos = torch.arange(s, dtype=torch.int32, device=x.device)
            x = x + _sinusoidal_pos(pos, cfg.d_model)[None].to(x.dtype)
            return _decode_stack(params, cfg, x, pos.expand(b, s), enc_out, window, None), None
        return forward(params, *embed_batch(params, batch), None)

    def loss_fn(params: ModelParams, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Next-token CE over ``labels`` (B, S) plus 0.01 × the summed MoE
        aux loss. The vlm's loss covers the text positions only (after its
        ``embeds`` prefix); the audio family encodes ``embeds``."""
        h, aux = forward_hidden(params, batch)
        if cfg.family == "vlm" and "embeds" in batch:
            h = h[:, batch["embeds"].shape[1] :, :]
        loss = _ce_loss(L.unembed(params.embed, h, cfg), batch["labels"])
        return loss if aux is None else loss + 0.01 * aux

    @torch.no_grad()
    def prefill_fn(params: ModelParams, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """tokens (B, S), and ``embeds`` (B, prefix, d) for the vlm (patches
        before the text) and audio (the encoder's frames) families →
        last-position logits."""
        h, _ = forward_hidden(params, batch)
        return L.unembed(params.embed, h[:, -1:, :], cfg)[:, 0, :]

    @torch.no_grad()
    def decode_fn(params: ModelParams, caches: Tree, batch: Dict[str, torch.Tensor]):
        """token (B, 1); pos (B, 1) int32, which the attention-free ``ssm``
        family does not read (its cache has no positions). The audio family
        cross-attends to the cache's ``enc_out``, cast to the activation
        dtype and left as it is."""
        token, pos = batch["token"], batch["pos"]
        x = L.embed(params.embed, token, cfg)
        if cfg.family == "audio":
            x = x + _sinusoidal_pos(pos[:, 0], cfg.d_model)[:, None].to(x.dtype)
            enc_out = caches["enc_out"].to(L.act_dtype(cfg))
            h = _decode_stack(params, cfg, x, pos, enc_out, window, caches)
        else:
            positions3 = pos[None].expand(3, *pos.shape) if cfg.rope_style == "mrope" else None
            h, _ = forward(params, x, pos, positions3, caches)
        return L.unembed(params.embed, h, cfg)[:, 0, :], caches

    def cache_shapes(batch: int, cache_len: int) -> Tree:
        """The reference's tree: self-attention caches of ``min(cache_len,
        window)`` slots with a window (ring buffers); MLA's latent caches
        (L - 1 stacked and ``dense0``); the audio family's bf16 ``enc_out``
        (B, prefix, d)."""
        eff_len = min(cache_len, window) if window is not None else cache_len
        if cfg.family == "ssm":
            return {"blocks": _stack(SSM.mamba_cache_shapes(cfg, batch), cfg.num_layers)}
        if cfg.family == "hybrid":
            n_super, n_rest = _hybrid_counts(cfg)
            attn_len = min(eff_len, cfg.attn_window or eff_len)
            attn = L.attention_cache_shapes(cfg, batch, attn_len)
            mamba = SSM.mamba_cache_shapes(cfg, batch)
            group = {"mamba": _stack(mamba, cfg.hybrid_attn_every), "attn": attn}
            out = {"super": _stack(group, n_super)}
            if n_rest:
                out["rest"] = _stack(mamba, n_rest)
            return out
        if cfg.mla is not None:
            blk = L.mla_cache_shapes(cfg, batch, eff_len)
            return {"blocks": _stack(blk, cfg.num_layers - 1), "dense0": blk}
        out = {"blocks": _stack(L.attention_cache_shapes(cfg, batch, eff_len), cfg.num_layers)}
        if cfg.family == "audio":
            out["enc_out"] = TensorSpec((batch, cfg.prefix_tokens, cfg.d_model), torch.bfloat16)
        return out

    def hidden_fn(params: ModelParams, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Final-layer hidden states (B, S, d): the backbone as a VFL
        representation extractor (with ``embeds`` for vlm and audio, as in
        :func:`prefill_fn`)."""
        return forward_hidden(params, batch)[0]

    return ModelDef(
        cfg=cfg,
        init=init,
        loss_fn=loss_fn,
        prefill_fn=prefill_fn,
        decode_fn=decode_fn,
        cache_shapes=cache_shapes,
        hidden_fn=hidden_fn,
    )
