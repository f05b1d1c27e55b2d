from repro_torch.checkpoint.artifact import (
    ARTIFACT_VERSION,
    ExtractorSpec,
    TrainedVFLModel,
    from_state,
    init_artifact,
    load_artifact,
    save_artifact,
)
from repro_torch.checkpoint.ckpt import latest_step, load_checkpoint, save_checkpoint

__all__ = [
    "ARTIFACT_VERSION",
    "ExtractorSpec",
    "TrainedVFLModel",
    "from_state",
    "init_artifact",
    "latest_step",
    "load_artifact",
    "load_checkpoint",
    "save_artifact",
    "save_checkpoint",
]
