"""The trained-VFL deployment artifact: saved, loaded and rebuilt in the
port's modules.

Counterpart of ``repro.checkpoint.artifact``. An artifact directory holds
one ``ckpt_00000000.npz``: the parameter pytree

    {"clients": [{"extractor": θ_k, "head": θ_k^aux}, ...],
     "overlap_reps": [H_o^k, ...],      # optional: Eq. 10 keys/values
     "server": θ_c}

in the reference's keys and layouts, every leaf float32, plus JSON metadata
(artifact version, scenario, classes, per-party feature shapes and
:class:`ExtractorSpec` records, protocol provenance). :func:`save_artifact`
writes it through :func:`repro_torch.bridge.to_jax_params`, so the
reference's ``load_artifact`` reads what the port saved; :func:`load_artifact`
reads what either package saved: it rebuilds every module from the specs
alone, reads the pytree in the reference's leaf order and carries it across
with :func:`repro_torch.bridge.load_jax_params`. :func:`from_state` builds
the artifact of a model the port trained (``VFLResult.to_artifact``), and
:func:`init_artifact` a seeded untrained one.

    art = result.to_artifact("hard/overlap-32", split=split)
    save_artifact("artifacts/hard32", art)
    art2 = load_artifact("artifacts/hard32")          # on cuda
    logits = art2.predict_logits([x_party0, x_party1])
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch.bridge import load_jax_params, to_jax_params
from repro_torch.checkpoint.ckpt import load_checkpoint, load_metadata, save_checkpoint
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.extractors import make_classifier, make_cnn_extractor, make_mlp_extractor

ARTIFACT_VERSION = 1
_ARTIFACT_STEP = 0  # ckpt step slot: one artifact per directory


@dataclass(frozen=True)
class ExtractorSpec:
    """Declarative identity of one party's extractor (the reference's
    record, with the same metadata form)."""

    kind: str  # "mlp" | "cnn"
    rep_dim: int
    hidden: Tuple[int, ...] = ()  # mlp widths
    widths: Tuple[int, ...] = ()  # cnn stage widths
    blocks_per_stage: int = 1  # cnn depth

    def build(self, feature_shape: Sequence[int]) -> nn.Module:
        """The extractor for inputs of trailing shape ``feature_shape``."""
        if self.kind == "mlp":
            return make_mlp_extractor(feature_shape[-1], self.rep_dim, self.hidden)
        if self.kind == "cnn":
            return make_cnn_extractor(
                feature_shape[-1], self.rep_dim, self.widths, self.blocks_per_stage
            )
        raise ValueError(
            f"unknown extractor kind {self.kind!r} (artifact from a newer repo version?)"
        )

    def to_meta(self) -> dict:
        return {
            "kind": self.kind,
            "rep_dim": self.rep_dim,
            "hidden": list(self.hidden),
            "widths": list(self.widths),
            "blocks_per_stage": self.blocks_per_stage,
        }

    @staticmethod
    def from_meta(meta: dict) -> "ExtractorSpec":
        return ExtractorSpec(
            kind=meta["kind"],
            rep_dim=meta["rep_dim"],
            hidden=tuple(meta["hidden"]),
            widths=tuple(meta["widths"]),
            blocks_per_stage=meta["blocks_per_stage"],
        )


@dataclass
class TrainedVFLModel:
    """A deployable K-party VFL model: per-party extractors f_k (and their
    local heads, which serving does not use), the joint head f_c, and the
    optional overlap representations H_o^k that Eq. 10 attends over."""

    scenario: str
    num_classes: int
    feature_shapes: Tuple[Tuple[int, ...], ...]  # per-party trailing shape
    extractor_specs: Tuple[ExtractorSpec, ...]
    extractors: List[nn.Module]
    heads: List[nn.Module]
    classifier: nn.Module
    protocol: Dict[str, Any] = field(default_factory=dict)
    overlap_reps: Optional[List[torch.Tensor]] = None
    metric_name: str = ""
    metric: float = 0.0
    version: int = ARTIFACT_VERSION

    def __post_init__(self):
        k = len(self.extractor_specs)
        if not (len(self.extractors) == len(self.heads) == len(self.feature_shapes) == k):
            raise ValueError(
                f"inconsistent party count: {k} extractor specs, "
                f"{len(self.extractors)} extractors, {len(self.heads)} heads, "
                f"{len(self.feature_shapes)} feature shapes"
            )
        if self.overlap_reps is not None and len(self.overlap_reps) != k:
            raise ValueError("overlap_reps must carry one H_o^k per party")

    @property
    def num_parties(self) -> int:
        return len(self.extractor_specs)

    @property
    def parties_are_homogeneous(self) -> bool:
        """Equal extractor specs and equal per-party feature shapes."""
        return len(set(self.extractor_specs)) == 1 and len(set(self.feature_shapes)) == 1

    @property
    def device(self) -> torch.device:
        return self.classifier.layers[0].weight.device

    @torch.inference_mode()
    def predict_logits(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """The unbatched reference forward: per-party extract → party-major
        concat → joint head. Batched serving is held against it."""
        reps = [ext(x) for ext, x in zip(self.extractors, xs)]
        return self.classifier(torch.cat(reps, dim=-1))


def _modules(specs, shapes, num_classes: int):
    extractors = [s.build(shape) for s, shape in zip(specs, shapes)]
    heads = [make_classifier(s.rep_dim, num_classes) for s in specs]
    classifier = make_classifier(sum(s.rep_dim for s in specs), num_classes)
    return extractors, heads, classifier


def init_artifact(
    specs: Sequence[ExtractorSpec],
    feature_shapes: Sequence[Sequence[int]],
    num_classes: int,
    *,
    seed: int,
    device: DeviceLike = None,
    aligned: Optional[Sequence[torch.Tensor]] = None,
    scenario: str = "seeded",
) -> TrainedVFLModel:
    """A seeded, untrained artifact: He-normal weights drawn from one
    ``torch.Generator``. With ``aligned`` (per-party rows of the overlap
    set), the overlap reps are the extractors' outputs on them, as the
    reference's ``from_state`` computes them."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    shapes = tuple(tuple(s) for s in feature_shapes)
    extractors, heads, classifier = _modules(specs, shapes, num_classes)
    for m in (*extractors, *heads, classifier):
        m.init_(gen).to(dev).eval()
    overlap = None
    if aligned is not None:
        with torch.inference_mode():
            overlap = [ext(x.to(dev)) for ext, x in zip(extractors, aligned)]
    return TrainedVFLModel(
        scenario=scenario,
        num_classes=num_classes,
        feature_shapes=shapes,
        extractor_specs=tuple(specs),
        extractors=extractors,
        heads=heads,
        classifier=classifier,
        overlap_reps=overlap,
    )


def from_state(
    extractors: Sequence[nn.Module],
    heads: Sequence[nn.Module],
    classifier: nn.Module,
    specs: Sequence[ExtractorSpec],
    *,
    scenario: str,
    num_classes: int,
    protocol: Optional[Dict[str, Any]] = None,
    metric_name: str = "",
    metric: float = 0.0,
    aligned: Optional[Sequence[torch.Tensor]] = None,
) -> TrainedVFLModel:
    """The artifact of trained protocol state (the reference's
    ``from_state``). The modules are used as they are, in eval mode. With
    ``aligned`` (each party's overlap rows) the overlap reps are the
    extractors' outputs on them and the feature shapes theirs; without it
    only MLP parties can be exported, their input width read off the
    first layer."""
    if len(specs) != len(extractors):
        raise ValueError(f"{len(specs)} extractor specs for {len(extractors)} parties")
    if classifier is None:
        raise ValueError("no fitted joint classifier: nothing deployable to export")
    overlap = None
    if aligned is not None:
        with torch.inference_mode():
            overlap = [ext(x) for ext, x in zip(extractors, aligned)]
        shapes = tuple(tuple(x.shape[1:]) for x in aligned)
    elif all(s.kind == "mlp" for s in specs):
        shapes = tuple((e.layers[0].in_features,) for e in extractors)
    else:
        raise ValueError("exporting CNN parties needs `aligned=` (their input shape)")
    for m in (*extractors, *heads, classifier):
        m.eval()
    return TrainedVFLModel(
        scenario=scenario,
        num_classes=num_classes,
        feature_shapes=shapes,
        extractor_specs=tuple(specs),
        extractors=list(extractors),
        heads=list(heads),
        classifier=classifier,
        protocol=dict(protocol or {}),
        overlap_reps=overlap,
        metric_name=metric_name,
        metric=float(metric),
    )


def _param_tree(art: TrainedVFLModel) -> dict:
    """The artifact's checkpoint pytree in the reference's keys and layouts,
    float32 numpy leaves."""
    tree: Dict[str, Any] = {
        "clients": [
            {"extractor": to_jax_params(e), "head": to_jax_params(h)}
            for e, h in zip(art.extractors, art.heads)
        ],
        "server": to_jax_params(art.classifier),
    }
    if art.overlap_reps is not None:
        tree["overlap_reps"] = [h.detach().to("cpu", torch.float32).numpy() for h in art.overlap_reps]
    return tree


def save_artifact(directory: str, art: TrainedVFLModel) -> str:
    """Persist one artifact per directory (atomic, via ``save_checkpoint``):
    the parameters as the pytree, the declarative fields as metadata with
    the reference's keys. Returns the checkpoint's path. Only ``mlp`` and
    ``cnn`` extractors have an artifact form (the reference's
    ``ExtractorSpec`` knows no other kind): a model-zoo extractor's
    (``ZooExtractorSpec``, kind ``zoo``) is refused."""
    for s in art.extractor_specs:
        if s.kind not in ("mlp", "cnn"):
            raise ValueError(
                f"an extractor of kind {s.kind!r} has no artifact form: the reference's "
                "ExtractorSpec (repro/checkpoint/artifact.py) knows only 'mlp' and 'cnn'"
            )
    meta = {
        "artifact_version": art.version,
        "scenario": art.scenario,
        "num_classes": art.num_classes,
        "feature_shapes": [list(s) for s in art.feature_shapes],
        "extractor_specs": [s.to_meta() for s in art.extractor_specs],
        "protocol": dict(art.protocol),
        "metric_name": art.metric_name,
        "metric": float(art.metric),
        "n_overlap": (int(art.overlap_reps[0].shape[0]) if art.overlap_reps is not None else None),
    }
    return save_checkpoint(directory, _ARTIFACT_STEP, _param_tree(art), meta)


def load_artifact(directory: str, device: DeviceLike = None) -> TrainedVFLModel:
    """Load an artifact written by either package's ``save_artifact``:
    metadata → rebuild the modules from the specs → read the parameter
    pytree in the reference's leaf order → copy it in. Runs on ``cuda``
    unless ``device="cpu"``."""
    dev = resolve_device(device)
    meta = load_metadata(directory, step=_ARTIFACT_STEP)
    version = meta.get("artifact_version")
    if version is None or version > ARTIFACT_VERSION:
        raise ValueError(
            f"{directory}: not a VFL serving artifact, or version "
            f"{version!r} is newer than supported ({ARTIFACT_VERSION})"
        )
    specs = tuple(ExtractorSpec.from_meta(m) for m in meta["extractor_specs"])
    shapes = tuple(tuple(s) for s in meta["feature_shapes"])
    extractors, heads, classifier = _modules(specs, shapes, meta["num_classes"])
    n_overlap = meta.get("n_overlap")
    art = TrainedVFLModel(
        scenario=meta["scenario"],
        num_classes=meta["num_classes"],
        feature_shapes=shapes,
        extractor_specs=specs,
        extractors=extractors,
        heads=heads,
        classifier=classifier,
        protocol=dict(meta.get("protocol", {})),
        overlap_reps=None if n_overlap is None else [torch.empty(n_overlap, s.rep_dim) for s in specs],
        metric_name=meta.get("metric_name", ""),
        metric=float(meta.get("metric", 0.0)),
        version=version,
    )
    tree, _ = load_checkpoint(directory, _param_tree(art), step=_ARTIFACT_STEP)
    for module, params in zip(extractors, (c["extractor"] for c in tree["clients"])):
        load_jax_params(module, params)
    for module, params in zip(heads, (c["head"] for c in tree["clients"])):
        load_jax_params(module, params)
    load_jax_params(classifier, tree["server"])
    for m in (*extractors, *heads, classifier):
        m.to(dev).eval()
    if "overlap_reps" in tree:
        art.overlap_reps = [h.to(dev, torch.float32) for h in tree["overlap_reps"]]
    return art
