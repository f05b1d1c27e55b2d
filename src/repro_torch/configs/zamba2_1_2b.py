"""Zamba2 1.2B [arXiv:2411.15242]: hybrid, a Mamba2 backbone plus one SHARED
attention block (same weights) applied periodically."""

from repro_torch.configs.base import ArchConfig, SSMConfig, register

CONFIG = register(
    ArchConfig(
        name="zamba2-1.2b",
        family="hybrid",
        num_layers=38,  # mamba2 blocks
        d_model=2048,
        num_heads=32,  # the shared attention block
        num_kv_heads=32,
        d_ff=8192,  # shared block's MLP
        vocab_size=32000,
        activation="swiglu",
        ssm=SSMConfig(d_state=64, head_dim=64, expand=2, conv_width=4),
        hybrid_attn_every=6,  # shared attn after every 6 mamba blocks
        source="arXiv:2411.15242",
    )
)
