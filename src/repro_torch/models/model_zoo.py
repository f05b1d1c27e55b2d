"""Assemble model-zoo models from an ArchConfig.

Counterpart of ``repro.models.model_zoo``. A :class:`ModelDef` exposes what
the launchers need:

* ``init(generator)``   — the family's parameter module, seeded, on the
  generator's device;
* ``prefill_fn``        — full-sequence forward → last-position logits;
* ``decode_fn``         — one token against the decode cache;
* ``hidden_fn``         — final-layer hidden states (the VFL extractor's);
* ``cache_shapes``      — the decode cache's spec tree for (batch, cache_len).

Three stacks are built:

* :class:`DecoderLM` (``dense`` and ``moe``): pre-norm attention blocks, the
  FFN a :class:`~repro_torch.models.moe.MoE` in the ``moe`` family;
* :class:`SSMLM` (``ssm``): Mamba2 blocks only;
* :class:`HybridLM` (``hybrid``, zamba2): n_super groups of
  ``hybrid_attn_every`` Mamba2 blocks, each group followed by the one
  shared attention block (the same weights every time, its own KV cache
  each time), then the trailing blocks.

The reference stacks repeated blocks on leading axes and scans them; here
they are ``nn.ModuleList``s and the axes are list indices. Decode caches
keep the reference's stacked trees (``cache_shapes``) and ``decode_fn``
updates them in place (the reference returns a new tree and donates the
old one). ``prefill_fn`` and ``decode_fn`` run without autograd; the MoE's
aux loss, ``loss_fn`` and the train step wait for the training slice (the
kernels have no backward yet).

MLA (deepseek), M-RoPE (vlm), the audio encoder-decoder and sliding-window
decode raise ``NotImplementedError`` naming ROADMAP Queue 1 #14.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.specs import TensorSpec
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM

Tree = Dict[str, Any]
ModelParams = nn.Module  # a DecoderLM, SSMLM or HybridLM


class DenseBlock(nn.Module):
    """One pre-norm decoder layer: ``ln1_scale``, ``attn``, ``ln2_scale``,
    and ``ffn``, or ``moe`` in its place."""

    def __init__(self, cfg: ArchConfig, device=None, use_moe: bool = False) -> None:
        super().__init__()
        self.ln1_scale = L.make_param(cfg.d_model, cfg=cfg, device=device)
        self.ln2_scale = L.make_param(cfg.d_model, cfg=cfg, device=device)
        self.attn = L.Attention(cfg, device)
        if use_moe:
            self.moe = MOE.MoE(cfg, device)
        else:
            self.ffn = L.FFN(cfg, device)


class DecoderLM(nn.Module):
    """A decoder-only stack's parameters: ``embed``, ``blocks`` (L of them)
    and ``final_ln_scale``. The apply functions of :func:`build_model` take
    it as their ``params``."""

    def __init__(self, cfg: ArchConfig, device=None) -> None:
        super().__init__()
        use_moe = cfg.family == "moe"
        self.embed = L.Embedding(cfg, device)
        self.final_ln_scale = L.make_param(cfg.d_model, cfg=cfg, device=device)
        self.blocks = nn.ModuleList(
            DenseBlock(cfg, device, use_moe) for _ in range(cfg.num_layers)
        )


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


_BACKBONES = {"dense": DecoderLM, "moe": DecoderLM, "ssm": SSMLM, "hybrid": HybridLM}


def check_ported(cfg: ArchConfig, window: Optional[int] = None) -> None:
    """Raise ``NotImplementedError`` for what the port does not build yet."""
    if cfg.family not in _BACKBONES or cfg.mla is not None or cfg.rope_style == "mrope":
        raise NotImplementedError(
            f"{cfg.name}: the port builds the dense, moe, ssm and hybrid families; "
            f"{cfg.family}{' with MLA' if cfg.mla is not None else ''} (MLA, vlm, audio) is "
            "ROADMAP Queue 1 #14"
        )
    if window is not None:
        raise NotImplementedError(
            f"{cfg.name}: sliding-window attention (ring-buffer decode) is ROADMAP Queue 1 #14"
        )


def make_backbone(cfg: ArchConfig, device=None) -> ModelParams:
    """The family's parameter module, allocated (not drawn) on ``device``."""
    check_ported(cfg)
    return _BACKBONES[cfg.family](cfg, device)


def _dense_block_apply(
    params: DenseBlock, x: torch.Tensor, cfg: ArchConfig, positions, cache, rope=None
) -> torch.Tensor:
    attn_in = L.rms_norm(x, params.ln1_scale, cfg.norm_eps)
    h, _ = L.attention_apply(params.attn, attn_in, cfg, positions, cache=cache, rope=rope)
    x = x + h.to(x.dtype)
    ff_in = L.rms_norm(x, params.ln2_scale, cfg.norm_eps)
    if hasattr(params, "moe"):
        y, _ = MOE.moe_apply(params.moe, ff_in, cfg)  # the aux loss: the training slice's
    else:
        y = L.ffn_apply(params.ffn, ff_in, cfg)
    return x + y.to(x.dtype)


def _mamba_block_apply(params: MambaBlock, x: torch.Tensor, cfg: ArchConfig, cache) -> torch.Tensor:
    h, _ = SSM.mamba_apply(params.mamba, L.rms_norm(x, params.ln_scale, cfg.norm_eps), cfg, cache)
    return x + h.to(x.dtype)


def _layer(caches: Optional[Tree], i: int) -> Optional[Tree]:
    """Entry i of a stacked cache tree: views, so updates land in the tree."""
    if caches is None:
        return None
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in caches.items()}


def _rope(cfg: ArchConfig, positions):
    """Every attention layer rotates by the same angles: computed once."""
    if cfg.rope_style == "rope":
        return L.rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta)
    return None


def _decoder_forward(
    params: DecoderLM, cfg: ArchConfig, x: torch.Tensor, positions, caches: Optional[Tree]
) -> torch.Tensor:
    """x (B, S, d) embedded input; caches None (prefill) or the stacked
    tree, updated in place. Returns the final-normed hidden states."""
    rope = _rope(cfg, positions)
    blocks = None if caches is None else caches["blocks"]
    for i, block in enumerate(params.blocks):
        x = _dense_block_apply(block, x, cfg, positions, _layer(blocks, i), rope)
    return L.rms_norm(x, params.final_ln_scale, cfg.norm_eps)


def _mamba_scan(blocks: nn.ModuleList, x: torch.Tensor, cfg: ArchConfig, caches) -> torch.Tensor:
    for i, block in enumerate(blocks):
        x = _mamba_block_apply(block, x, cfg, _layer(caches, i))
    return x


def _ssm_forward(params: SSMLM, cfg: ArchConfig, x: torch.Tensor, caches) -> torch.Tensor:
    x = _mamba_scan(params.blocks, x, cfg, None if caches is None else caches["blocks"])
    return L.rms_norm(x, params.final_ln_scale, cfg.norm_eps)


def _hybrid_forward(
    params: HybridLM, cfg: ArchConfig, x: torch.Tensor, positions, caches
) -> torch.Tensor:
    """Each super group's Mamba2 blocks, then the shared attention block
    against that application's own KV cache; then the trailing blocks."""
    rope = _rope(cfg, positions)
    groups = None if caches is None else caches["super"]
    for i, group in enumerate(params.super):
        cache = _layer(groups, i)
        x = _mamba_scan(group, x, cfg, None if cache is None else cache["mamba"])
        attn = None if cache is None else cache["attn"]
        x = _dense_block_apply(params.shared_attn, x, cfg, positions, attn, rope)
    if hasattr(params, "rest"):
        x = _mamba_scan(params.rest, x, cfg, None if caches is None else caches["rest"])
    return L.rms_norm(x, params.final_ln_scale, cfg.norm_eps)


def _stack(tree: Tree, n: int) -> Tree:
    """A spec tree with a leading axis of n (the reference's _stack_shapes)."""
    return {
        k: _stack(v, n) if isinstance(v, dict) else TensorSpec((n, *v.shape), v.dtype)
        for k, v in tree.items()
    }


@dataclass(frozen=True)
class ModelDef:
    cfg: ArchConfig
    init: Callable[[torch.Generator], ModelParams]
    prefill_fn: Callable[[ModelParams, Dict[str, torch.Tensor]], torch.Tensor]
    decode_fn: Callable[[ModelParams, Tree, Dict[str, torch.Tensor]], Tuple[torch.Tensor, Tree]]
    cache_shapes: Callable[[int, int], Tree]
    hidden_fn: Callable[[ModelParams, Dict[str, torch.Tensor]], torch.Tensor]


def build_model(cfg: ArchConfig, window_override: Optional[int] = None) -> ModelDef:
    """The ModelDef of a dense, moe, ssm or hybrid config.
    ``window_override`` (the reference's sliding-window long-context
    variant) is not ported yet."""
    window = window_override if window_override is not None else cfg.attn_window
    check_ported(cfg, window)

    def forward(params: ModelParams, x: torch.Tensor, positions, caches) -> torch.Tensor:
        if cfg.family == "ssm":
            return _ssm_forward(params, cfg, x, caches)
        if cfg.family == "hybrid":
            return _hybrid_forward(params, cfg, x, positions, caches)
        return _decoder_forward(params, cfg, x, positions, caches)

    def init(generator: torch.Generator) -> ModelParams:
        return L.init_params(make_backbone(cfg, generator.device), generator)

    def forward_hidden(params: ModelParams, tokens: torch.Tensor) -> torch.Tensor:
        b, s = tokens.shape
        x = L.embed(params.embed, tokens, cfg)
        positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
        return forward(params, x, positions, None)

    @torch.no_grad()
    def prefill_fn(params: ModelParams, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        h = forward_hidden(params, batch["tokens"])
        return L.unembed(params.embed, h[:, -1:, :], cfg)[:, 0, :]

    @torch.no_grad()
    def decode_fn(params: ModelParams, caches: Tree, batch: Dict[str, torch.Tensor]):
        """token (B, 1); pos (B, 1) int32, which the attention-free ``ssm``
        family does not read (its cache has no positions)."""
        x = L.embed(params.embed, batch["token"], cfg)
        h = forward(params, x, batch["pos"], caches)
        return L.unembed(params.embed, h, cfg)[:, 0, :], caches

    def cache_shapes(batch: int, cache_len: int) -> Tree:
        if cfg.family == "ssm":
            return {"blocks": _stack(SSM.mamba_cache_shapes(cfg, batch), cfg.num_layers)}
        attn = L.attention_cache_shapes(cfg, batch, cache_len)
        if cfg.family == "hybrid":
            n_super, n_rest = _hybrid_counts(cfg)
            mamba = SSM.mamba_cache_shapes(cfg, batch)
            group = {"mamba": _stack(mamba, cfg.hybrid_attn_every), "attn": attn}
            out = {"super": _stack(group, n_super)}
            if n_rest:
                out["rest"] = _stack(mamba, n_rest)
            return out
        return {"blocks": _stack(attn, cfg.num_layers)}

    def hidden_fn(params: ModelParams, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Final-layer hidden states (B, S, d): the backbone as a VFL
        representation extractor."""
        return forward_hidden(params, batch["tokens"])

    return ModelDef(
        cfg=cfg,
        init=init,
        prefill_fn=prefill_fn,
        decode_fn=decode_fn,
        cache_shapes=cache_shapes,
        hidden_fn=hidden_fn,
    )
