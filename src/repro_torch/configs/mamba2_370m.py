"""Mamba2 370M [arXiv:2405.21060]: attention-free SSD (state-space duality)."""

from repro_torch.configs.base import ArchConfig, SSMConfig, register

CONFIG = register(
    ArchConfig(
        name="mamba2-370m",
        family="ssm",
        num_layers=48,
        d_model=1024,
        num_heads=0,  # attention-free
        num_kv_heads=0,
        d_ff=0,  # mamba blocks subsume the FFN
        vocab_size=50280,
        rope_style="none",
        ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4),
        source="arXiv:2405.21060",
    )
)
