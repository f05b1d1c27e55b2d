"""Gemma 7B [arXiv:2403.08295]: dense, GeGLU, head_dim=256, MHA (kv=16)."""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="gemma-7b",
        family="dense",
        num_layers=28,
        d_model=3072,
        num_heads=16,
        num_kv_heads=16,
        d_ff=24576,
        vocab_size=256000,
        head_dim=256,
        activation="geglu",
        rope_theta=10000.0,
        tie_embeddings=True,
        source="arXiv:2403.08295",
    )
)
