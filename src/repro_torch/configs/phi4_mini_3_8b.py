"""Phi-4-mini 3.8B [arXiv:2412.08905]: dense, RoPE, SwiGLU, GQA kv=8."""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="phi4-mini-3.8b",
        family="dense",
        num_layers=32,
        d_model=3072,
        num_heads=24,
        num_kv_heads=8,
        d_ff=8192,
        vocab_size=200064,
        activation="swiglu",
        rope_theta=10000.0,
        tie_embeddings=True,
        source="arXiv:2412.08905",
    )
)
