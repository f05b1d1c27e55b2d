"""Assemble model-zoo decoders from an ArchConfig (the dense family).

Counterpart of ``repro.models.model_zoo``. A :class:`ModelDef` exposes what
the launchers need:

* ``init(generator)``   — a :class:`DecoderLM` with seeded parameters, on
  the generator's device;
* ``prefill_fn``        — full-sequence forward → last-position logits;
* ``decode_fn``         — one token against the KV cache;
* ``hidden_fn``         — final-layer hidden states (the VFL extractor's);
* ``cache_shapes``      — the decode cache's spec tree for (batch, cache_len).

The reference stacks the L blocks on a leading axis and scans them; here the
blocks are an ``nn.ModuleList`` and the L axis is the list index. Decode
caches keep the reference's stacked tree, ``{"blocks": {k, v, pos, index}}``
with a leading L axis, and ``decode_fn`` updates it in place (the reference
returns a new tree and donates the old one). ``prefill_fn`` and
``decode_fn`` run without autograd; ``loss_fn`` and the train step wait for
the training slice (the kernels have no backward yet).

Only the ``dense`` family is built so far; MoE, SSM, hybrid, MLA, M-RoPE
(vlm), the audio encoder-decoder and sliding-window decode raise
``NotImplementedError`` naming ROADMAP Queue 1 #14.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.specs import TensorSpec
from repro_torch.models import layers as L

Tree = Dict[str, Any]


class DenseBlock(nn.Module):
    """One pre-norm decoder layer: ``ln1_scale``, ``attn``, ``ln2_scale``,
    ``ffn``."""

    def __init__(self, cfg: ArchConfig, device=None) -> None:
        super().__init__()
        self.ln1_scale = L.make_param(cfg.d_model, cfg=cfg, device=device)
        self.ln2_scale = L.make_param(cfg.d_model, cfg=cfg, device=device)
        self.attn = L.Attention(cfg, device)
        self.ffn = L.FFN(cfg, device)


class DecoderLM(nn.Module):
    """A decoder-only stack's parameters: ``embed``, ``blocks`` (L of them)
    and ``final_ln_scale``. The apply functions of :func:`build_model` take
    it as their ``params``."""

    def __init__(self, cfg: ArchConfig, device=None) -> None:
        super().__init__()
        self.embed = L.Embedding(cfg, device)
        self.final_ln_scale = L.make_param(cfg.d_model, cfg=cfg, device=device)
        self.blocks = nn.ModuleList(DenseBlock(cfg, device) for _ in range(cfg.num_layers))


def _dense_block_apply(
    params: DenseBlock, x: torch.Tensor, cfg: ArchConfig, positions, cache, rope=None
) -> torch.Tensor:
    attn_in = L.rms_norm(x, params.ln1_scale, cfg.norm_eps)
    h, _ = L.attention_apply(params.attn, attn_in, cfg, positions, cache=cache, rope=rope)
    x = x + h.to(x.dtype)
    ff_in = L.rms_norm(x, params.ln2_scale, cfg.norm_eps)
    return x + L.ffn_apply(params.ffn, ff_in, cfg).to(x.dtype)


def _decoder_forward(
    params: DecoderLM, cfg: ArchConfig, x: torch.Tensor, positions, caches: Optional[Tree]
) -> Tuple[torch.Tensor, Optional[Tree]]:
    """x (B, S, d) embedded input; caches None (prefill) or the stacked
    tree, updated in place. Returns (hidden, caches)."""
    rope = None
    if cfg.rope_style == "rope":  # every layer rotates by the same angles
        rope = L.rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta)
    for i, block in enumerate(params.blocks):
        cache = None if caches is None else {k: t[i] for k, t in caches["blocks"].items()}
        x = _dense_block_apply(block, x, cfg, positions, cache, rope)
    return L.rms_norm(x, params.final_ln_scale, cfg.norm_eps), caches


@dataclass(frozen=True)
class ModelDef:
    cfg: ArchConfig
    init: Callable[[torch.Generator], DecoderLM]
    prefill_fn: Callable[[DecoderLM, Dict[str, torch.Tensor]], torch.Tensor]
    decode_fn: Callable[[DecoderLM, Tree, Dict[str, torch.Tensor]], Tuple[torch.Tensor, Tree]]
    cache_shapes: Callable[[int, int], Tree]
    hidden_fn: Callable[[DecoderLM, Dict[str, torch.Tensor]], torch.Tensor]


def build_model(cfg: ArchConfig, window_override: Optional[int] = None) -> ModelDef:
    """The dense family's ModelDef. ``window_override`` (the reference's
    sliding-window long-context variant) is not ported yet."""
    window = window_override if window_override is not None else cfg.attn_window
    if cfg.family != "dense" or cfg.mla is not None or cfg.rope_style == "mrope":
        raise NotImplementedError(
            f"{cfg.name}: the port builds the dense family only; {cfg.family} (MoE, SSM, "
            "hybrid, MLA, vlm, audio) is ROADMAP Queue 1 #14"
        )
    if window is not None:
        raise NotImplementedError(
            f"{cfg.name}: sliding-window attention (ring-buffer decode) is ROADMAP Queue 1 #14"
        )

    def init(generator: torch.Generator) -> DecoderLM:
        return L.init_params(DecoderLM(cfg, generator.device), generator)

    def forward_hidden(params: DecoderLM, tokens: torch.Tensor) -> torch.Tensor:
        b, s = tokens.shape
        x = L.embed(params.embed, tokens, cfg)
        positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
        return _decoder_forward(params, cfg, x, positions, None)[0]

    @torch.no_grad()
    def prefill_fn(params: DecoderLM, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        h = forward_hidden(params, batch["tokens"])
        return L.unembed(params.embed, h[:, -1:, :], cfg)[:, 0, :]

    @torch.no_grad()
    def decode_fn(params: DecoderLM, caches: Tree, batch: Dict[str, torch.Tensor]):
        x = L.embed(params.embed, batch["token"], cfg)  # token (B, 1)
        h, caches = _decoder_forward(params, cfg, x, batch["pos"], caches)  # pos (B, 1) int32
        return L.unembed(params.embed, h, cfg)[:, 0, :], caches

    def cache_shapes(batch: int, cache_len: int) -> Tree:
        blk = L.attention_cache_shapes(cfg, batch, cache_len)
        stacked = {k: TensorSpec((cfg.num_layers, *s.shape), s.dtype) for k, s in blk.items()}
        return {"blocks": stacked}

    def hidden_fn(params: DecoderLM, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
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
