"""Qwen2-VL 72B [arXiv:2409.12191]: VLM backbone, M-RoPE, GQA kv=8.

The ViT frontend is a stub: batches carry precomputed patch embeddings
(prefix_tokens, d_model) that the backbone consumes with 3D M-RoPE ids.
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="qwen2-vl-72b",
        family="vlm",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=29568,
        vocab_size=152064,
        activation="swiglu",
        qkv_bias=True,
        rope_style="mrope",
        rope_theta=1000000.0,
        prefix_tokens=1024,  # patch-embedding prefix in train/prefill
        source="arXiv:2409.12191",
    )
)
