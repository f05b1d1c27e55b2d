"""Llama-3 405B [arXiv:2407.21783]: dense GQA kv=8, 128k-class vocab."""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="llama3-405b",
        family="dense",
        num_layers=126,
        d_model=16384,
        num_heads=128,
        num_kv_heads=8,
        d_ff=53248,
        vocab_size=128256,
        activation="swiglu",
        rope_theta=500000.0,
        source="arXiv:2407.21783",
    )
)
