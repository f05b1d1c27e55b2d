"""Granite-MoE 3B-a800m [hf:ibm-granite/granite-3.0-*-base family]:
40 experts, top-8 routing, GQA kv=8."""

from repro_torch.configs.base import ArchConfig, MoEConfig, register

CONFIG = register(
    ArchConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        num_layers=32,
        d_model=1536,
        num_heads=24,
        num_kv_heads=8,
        d_ff=512,  # per-expert width
        vocab_size=49155,
        activation="swiglu",
        moe=MoEConfig(num_experts=40, top_k=8, d_ff_expert=512),
        source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    )
)
