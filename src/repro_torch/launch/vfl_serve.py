"""Online VFL serving: a loaded artifact behind one batched forward.

Counterpart of ``repro.launch.vfl_serve``. A :class:`ServingEngine` runs the
K party extractors and the joint head over fixed-capacity masked batches
from :mod:`repro_torch.launch.batching`; padding rows' logits are zeroed.
The head sees the party-major concatenation of the representations, the
layout it was trained on. Partial-party queries estimate the missing
parties' representations with Eq. 10 (:meth:`predict_logits_partial`).

What has no counterpart here: the reference's fused ``jax.jit`` program,
its compile-session cache and input donation (PyTorch runs eagerly), and
its ``KernelRouter``, whose thresholds were derived for the TPU. On the card
every partial-party query goes through the hand-written SDPA kernel; on the
CPU through the plain version. Where the plain PyTorch route would beat the
kernel on the card is left to a measured crossover.

CLI::

    PYTHONPATH=src python -m repro_torch.launch.vfl_serve \\
        --artifact artifacts/hard32 --capacity 64 --requests 32 [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import List, Sequence

import torch

from repro_torch.checkpoint.artifact import TrainedVFLModel, load_artifact
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.engine.dispatch import estimate_missing_fused
from repro_torch.launch import batching


class ServingEngine:
    """Continuous batched inference over one deployed VFL model.

    ``device`` defaults to ``cuda`` and must be where the artifact lives
    (``load_artifact(..., device=)`` puts it there)."""

    def __init__(self, art: TrainedVFLModel, capacity: int = 64, device: DeviceLike = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.device = resolve_device(device)
        if art.device.type != self.device.type:
            raise ValueError(
                f"the artifact lives on {art.device}, the engine on {self.device}; "
                "load it with load_artifact(..., device=) on the engine's device"
            )
        self.art = art
        self.capacity = int(capacity)

    # ------------------------------------------------------------ forward
    @torch.inference_mode()
    def step(self, batch: batching.MaskedBatch) -> torch.Tensor:
        """One fixed-shape forward over a padded batch → (capacity, C)
        logits, padding rows zeroed. The unit ``batching.drive`` times."""
        reps = [ext(x) for ext, x in zip(self.art.extractors, batch.xs)]
        logits = self.art.classifier(torch.cat(reps, dim=-1))
        return torch.where(batch.mask[:, None], logits, 0.0)

    def predict_logits(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """Logits for a request of any size: chunk to capacity, pad, run
        :meth:`step`, keep the valid rows."""
        parts = []
        for chunk in batching.chunk_requests(xs, self.capacity):
            batch = batching.pad_to_capacity(chunk, self.capacity)
            parts.append(self.step(batch)[: batch.n])
        return torch.cat(parts, dim=0) if len(parts) > 1 else parts[0]

    def predict(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """Class predictions (argmax over the logits)."""
        return torch.argmax(self.predict_logits(xs), dim=-1)

    # ------------------------------------------- partial-party queries
    @torch.inference_mode()
    def predict_logits_partial(self, x_k: torch.Tensor, k: int) -> torch.Tensor:
        """Serve a query where ONLY party ``k``'s features are present:
        estimate every other party's representation from the artifact's
        overlap reps with Eq. 10 (all K−1 as one kernel launch when their
        widths agree), then run the joint head."""
        art = self.art
        if art.overlap_reps is None:
            raise ValueError(
                "artifact carries no overlap_reps — re-export it with "
                "to_artifact(..., split=split) to serve partial-party queries"
            )
        if not 0 <= k < art.num_parties:
            raise ValueError(f"party index {k} out of range [0, {art.num_parties})")
        h_u_k = art.extractors[k](x_k)
        est = iter(estimate_missing_fused(h_u_k, art.overlap_reps, k))
        reps = [h_u_k if j == k else next(est) for j in range(art.num_parties)]
        return art.classifier(torch.cat(reps, dim=-1))


# ------------------------------------------------------------------- CLI
def synthetic_requests(
    art: TrainedVFLModel,
    num_requests: int,
    batch_size: int,
    seed: int = 0,
    device: DeviceLike = None,
) -> List[tuple]:
    """Per-party Gaussian feature blocks of the artifact's feature shapes,
    drawn from one seeded ``torch.Generator`` on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [
        tuple(
            torch.randn((batch_size, *shape), generator=gen, device=dev)
            for shape in art.feature_shapes
        )
        for _ in range(num_requests)
    ]


def serve_traffic(
    engine: ServingEngine, requests: Sequence[Sequence[torch.Tensor]], warmup: int = 1
):
    """Drive a request stream through the engine's step via the shared
    batcher; returns (outputs, LatencyRecorder)."""
    return batching.drive(engine.step, requests, engine.capacity, warmup=warmup)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--artifact", required=True, help="directory written by save_artifact")
    ap.add_argument("--capacity", type=int, default=64, help="fixed batch capacity")
    ap.add_argument("--requests", type=int, default=32, help="number of synthetic requests")
    ap.add_argument(
        "--batch-size", type=int, default=None, help="rows per request (default: capacity)"
    )
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    t0 = time.time()
    art = load_artifact(args.artifact, device=args.device)
    engine = ServingEngine(art, capacity=args.capacity, device=args.device)
    print(
        f"loaded {args.artifact}: scenario={art.scenario} K={art.num_parties} "
        f"classes={art.num_classes} homogeneous={art.parties_are_homogeneous} "
        f"device={engine.device} ({time.time() - t0:.2f}s)"
    )
    bs = args.batch_size or args.capacity
    reqs = synthetic_requests(art, args.requests, bs, seed=args.seed, device=engine.device)
    outs, rec = serve_traffic(engine, reqs)
    s = rec.summary()
    print(
        f"served {s['rows']} rows in {s['batches']} batches (capacity {engine.capacity}): "
        f"p50={s['p50_ms']:.2f}ms p99={s['p99_ms']:.2f}ms "
        f"throughput={s['rows_per_s']:.0f} rows/s"
    )
    print(f"sample predictions: {torch.argmax(outs[0], dim=-1)[:8].tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
