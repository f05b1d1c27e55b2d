from repro_torch.models.extractors import (
    CNNExtractor,
    Dense,
    make_classifier,
    make_cnn_extractor,
    make_mlp_extractor,
)

__all__ = [
    "CNNExtractor",
    "Dense",
    "make_classifier",
    "make_cnn_extractor",
    "make_mlp_extractor",
]
