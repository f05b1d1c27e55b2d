"""Qwen1.5 32B [hf:Qwen/Qwen1.5-0.5B family]: dense MHA with QKV bias."""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="qwen1.5-32b",
        family="dense",
        num_layers=64,
        d_model=5120,
        num_heads=40,
        num_kv_heads=40,
        d_ff=27392,
        vocab_size=152064,
        activation="swiglu",
        qkv_bias=True,
        rope_theta=1000000.0,
        source="hf:Qwen/Qwen1.5-0.5B",
    )
)
