"""Roofline terms of a model-zoo step on one NVIDIA H100 SXM.

Counterpart of ``repro.roofline.analysis``. :func:`active_params` and
:func:`model_flops` are the reference's arithmetic on the config, unchanged
(MODEL_FLOPS = 6·N·D for a train step, 2·N·D for inference). :class:`Hardware`
holds the H100's published rates, which ``chip_smoke.py``'s bounds read
(NVIDIA's data sheet, SXM part, dense, at the full 700 W power limit), not
the reference's TPU figures; :func:`roofline_terms` turns per-device flops
and bytes into seconds on it. The reference's ``hlo_analysis`` reads XLA's
HLO and has no counterpart in the port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.configs.base import ArchConfig, InputShape


@dataclass(frozen=True)
class Hardware:
    name: str = "h100-sxm"
    peak_flops: float = 989e12  # dense bf16 on the tensor cores, FLOP/s
    tf32_flops: float = 495e12  # dense TF32 on the tensor cores, FLOP/s
    f32_flops: float = 67e12  # f32 outside the tensor cores (FMA = 2 FLOP), FLOP/s
    hbm_bw: float = 3.35e12  # B/s
    ici_bw: float = 450e9  # NVLink, B/s each way to the other cards of a host
    hbm_per_chip: float = 80e9


HW = Hardware()


def active_params(cfg: ArchConfig) -> float:
    """Parameters touched per token (dense count, or active-expert count for
    MoE) — the N in MODEL_FLOPS = 6·N·D."""
    d = cfg.d_model
    v = cfg.vocab_size
    total = v * d * (1 if cfg.tie_embeddings else 2)
    L = cfg.num_layers

    def attn_params():
        dh = cfg.resolved_head_dim
        if cfg.mla is not None:
            m = cfg.mla
            p = d * m.kv_lora_rank + d * m.rope_head_dim
            p += m.kv_lora_rank * cfg.num_heads * (m.nope_head_dim + m.v_head_dim)
            if m.q_lora_rank:
                p += d * m.q_lora_rank + m.q_lora_rank * cfg.num_heads * (m.nope_head_dim + m.rope_head_dim)
            else:
                p += d * cfg.num_heads * (m.nope_head_dim + m.rope_head_dim)
            p += cfg.num_heads * m.v_head_dim * d
            return p
        return d * cfg.num_heads * dh + 2 * d * cfg.num_kv_heads * dh \
            + cfg.num_heads * dh * d

    def ffn_params(width, glu=True):
        return (3 if glu else 2) * d * width

    glu = cfg.activation in ("swiglu", "geglu")
    if cfg.family in ("dense", "vlm"):
        total += L * (attn_params() + ffn_params(cfg.d_ff, glu))
    elif cfg.family == "moe":
        m = cfg.moe
        act_ffn = m.top_k * ffn_params(m.d_ff_expert, True) \
            + (ffn_params(m.d_ff_shared, True) if m.num_shared_experts else 0)
        n_moe = L - (1 if cfg.mla is not None else 0)
        total += n_moe * (attn_params() + act_ffn + d * m.num_experts)
        if cfg.mla is not None:
            total += attn_params() + ffn_params(cfg.d_ff, True)
    elif cfg.family == "ssm":
        di = cfg.ssm.expand * d
        nh = di // cfg.ssm.head_dim
        per = d * (2 * di + 2 * cfg.ssm.d_state + nh) + di * d
        total += L * per
    elif cfg.family == "hybrid":
        di = cfg.ssm.expand * d
        nh = di // cfg.ssm.head_dim
        per = d * (2 * di + 2 * cfg.ssm.d_state + nh) + di * d
        total += L * per
        n_super = L // cfg.hybrid_attn_every
        total += n_super * (attn_params() + ffn_params(cfg.d_ff, glu)) / n_super  # shared weights counted once
        # but FLOPs-wise the shared block runs n_super times; handled in model_flops
    elif cfg.family == "audio":
        total += cfg.encoder_layers * (attn_params() + ffn_params(cfg.d_ff, glu))
        total += L * (2 * attn_params() + ffn_params(cfg.d_ff, glu))
    return float(total)


def model_flops(cfg: ArchConfig, shape: InputShape) -> float:
    """6·N_active·D (training) or 2·N_active·D (inference) useful flops,
    D = tokens processed by this step."""
    n = active_params(cfg)
    if cfg.family == "hybrid":
        # shared attention block executes n_super times per forward
        d = cfg.d_model
        dh = cfg.resolved_head_dim
        glu = 3 if cfg.activation in ("swiglu", "geglu") else 2
        shared = d * cfg.num_heads * dh * 2 + 2 * d * cfg.num_kv_heads * dh \
            + glu * d * cfg.d_ff
        n += shared * (cfg.num_layers // cfg.hybrid_attn_every - 1)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch          # decode: one token per seq


def roofline_terms(per_device: Dict[str, float], hw: Hardware = HW) -> Dict[str, float]:
    """per_device: {dot_flops, traffic_bytes, collective_bytes} → seconds
    of each term, and the ``bottleneck`` term's name."""
    compute = per_device.get("dot_flops", 0.0) / hw.peak_flops
    memory = per_device.get("traffic_bytes", 0.0) / hw.hbm_bw
    collective = per_device.get("collective_bytes", 0.0) / hw.ici_bw
    terms = {"compute_s": compute, "memory_s": memory, "collective_s": collective}
    dom = max(terms, key=terms.get)
    terms["bottleneck"] = dom.replace("_s", "")
    return terms
