"""Data for the port: the numpy-seeded schedules, the vertical split and
the synthetic generators (counterpart of ``repro.data``)."""

from repro_torch.data.loader import batch_iterator, epoch_batches
from repro_torch.data.synthetic import (
    make_cluster_tabular,
    make_image_classification,
    make_sequence_classification,
    make_tabular_credit,
    make_token_stream,
    sequence_classification_from_draws,
    tabular_credit_from_draws,
    token_stream_from_draws,
)
from repro_torch.data.vertical import (
    VerticalSplit,
    make_vfl_partition,
    split_features,
    split_from_numpy,
    split_image_halves,
    split_image_patches,
)

__all__ = [
    "VerticalSplit",
    "batch_iterator",
    "epoch_batches",
    "make_cluster_tabular",
    "make_image_classification",
    "make_sequence_classification",
    "make_tabular_credit",
    "make_token_stream",
    "make_vfl_partition",
    "split_features",
    "split_from_numpy",
    "split_image_halves",
    "split_image_patches",
    "sequence_classification_from_draws",
    "tabular_credit_from_draws",
    "token_stream_from_draws",
]
