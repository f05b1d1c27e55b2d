"""SeamlessM4T-large v2 [arXiv:2308.11596]: encoder-decoder, multimodal.

The audio feature extractor is a stub: batches carry precomputed frame
embeddings for the transformer encoder; the text decoder cross-attends to
the encoder output.
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="seamless-m4t-large-v2",
        family="audio",
        num_layers=24,  # decoder layers
        encoder_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_ff=8192,
        vocab_size=256206,
        activation="gelu",
        rope_style="none",  # sinusoidal positions
        prefix_tokens=1024,  # audio-frame embeddings fed to the encoder
        source="arXiv:2308.11596",
    )
)
