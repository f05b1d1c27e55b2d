"""Online VFL serving: a loaded artifact behind one session-cached fused
forward.

Counterpart of ``repro.launch.vfl_serve``. A :class:`ServingEngine` runs the
K party extractors and the joint head as one fused forward over
fixed-capacity masked batches from :mod:`repro_torch.launch.batching`;
padding rows' logits are zeroed. The head sees the party-major
concatenation of the representations, the layout it was trained on.

The forward is built by :func:`_build_fused_forward` on one of two paths:

* ``"stacked"``: the K extractors' parameters stacked on a leading K axis
  when the engine is made, and again after a weight changes
  (``torch.func.stack_module_state``; the reference's
  ``ServingEngine._ext_params``), and one
  ``torch.func.vmap(functional_call)`` over them and the stacked inputs;
* ``"composed"``: each party's extractor in turn.

Which path serves is a rule measured on the card (:func:`stack_pays`, of
the artifact and the engine's capacity: four or more homogeneous CNN
parties at up to 64 rows a step), not the reference's "homogeneous ⇒
stack": ``vmap`` turns a convolution into a grouped one. Both paths give
the same logits (tests hold them within 1e-5, and 2e-5 of the logits' scale
for the CNN).

The built forwards come from the engine-wide session cache
(``engine/sessions.py``, domain ``"serving"``) under :func:`_serving_key`:
whether the parties can stack, each party's spec and the head's, never a
capacity, a batch width or a feature width. One session holds both paths'
forwards, because the path follows the capacity. The parameters travel as
arguments, so one built session serves every capacity and every engine over
artifacts of the same specs: after the first, no serving engine adds a
fresh miss (the reference's RECOMPILE contract). PyTorch runs eagerly, so
what is cached is the built forward, not a compiled program, and there is
no input donation.

Partial-party queries estimate the missing parties' representations with
Eq. 10 (:meth:`ServingEngine.predict_logits_partial`), through the
``sdpa_estimator`` kernel on the card and its plain version on the CPU.
:class:`KernelRouter` records the reference's routing API with the card's
rule (the kernel at every measured shape) rather than the TPU's VMEM
thresholds; the engine does not consult it.

CLI::

    PYTHONPATH=src python -m repro_torch.launch.vfl_serve \\
        --artifact artifacts/hard32 --capacity 64 --requests 32 [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
from torch.func import functional_call, stack_module_state, vmap

from repro_torch.checkpoint.artifact import TrainedVFLModel, load_artifact
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.engine.dispatch import estimate_missing_fused
from repro_torch.engine.sessions import cached_session, module_spec
from repro_torch.launch import batching

SERVING_DOMAIN = "serving"
PATHS = ("stacked", "composed")


@dataclasses.dataclass(frozen=True)
class KernelRouter:
    """The reference's kernel-vs-plain routing of Eq. 10, as a record of the
    card's rule; the engine does not consult it, because the route already
    follows the tensor's device (a CUDA tensor launches the kernel, a CPU
    tensor takes the plain version).

    On the CPU the rule routes to the plain version: the CUDA kernels run
    only on a card. On the card it routes to the ``sdpa_estimator`` kernel
    at every shape, because the card's numbers say so
    (``benchmarks/torch_serving.py --router-sweep``)."""

    device: str  # "cuda" | "cpu"

    @staticmethod
    def default(device: DeviceLike = None) -> "KernelRouter":
        """The router of ``device`` (``cuda`` unless the caller says ``cpu``)."""
        return KernelRouter(resolve_device(device).type)

    @property
    def kernels_viable(self) -> bool:
        return self.device == "cuda"

    def use_sdpa(self, n_u: int, n_o: int, d: int, batch: int = 1) -> bool:
        """Eq. 10 through the ``sdpa_estimator`` kernel, for ``batch``
        estimates of (n_u, n_o, d) in one launch (a partial-party query's
        K−1). On the card it beats the plain route and
        ``F.scaled_dot_product_attention`` at every swept shape, by CUDA
        events (host enqueue included) and by device time."""
        return self.kernels_viable


# The path rule, from stacked against composed ms a step on the card
# (benchmarks/torch_serving.py --path-sweep, PERF.md §5): the stack wins for
# 4 CNN parties up to 64 rows a step (their composed forward is host-bound
# there), never for 2 CNN parties, and loses 2.5-3.6x for the CNN from 256
# rows on, where vmap's grouped convolutions dominate. MLP parties are
# served composed: the stack's gain there (8 parties) was within the
# sweep's run-to-run spread.
#: the fewest homogeneous CNN parties whose stacked forward pays ...
STACK_MIN_CNN_PARTIES = 4
#: ... at up to this many rows a step
STACK_MAX_CNN_ROWS = 64


def _can_stack(art: TrainedVFLModel) -> bool:
    """Whether the stacked forward serves ``art`` at some capacity:
    homogeneous parties (equal specs and feature shapes), at least
    :data:`STACK_MIN_CNN_PARTIES` of them, CNNs."""
    return (
        art.parties_are_homogeneous
        and art.extractor_specs[0].kind == "cnn"
        and art.num_parties >= STACK_MIN_CNN_PARTIES
    )


def stack_pays(art: TrainedVFLModel, capacity: int) -> bool:
    """Whether the stacked forward serves ``art`` at ``capacity`` rows a
    step: where :func:`_can_stack`, at up to :data:`STACK_MAX_CNN_ROWS`
    rows."""
    return _can_stack(art) and capacity <= STACK_MAX_CNN_ROWS


def serving_path(art: TrainedVFLModel, capacity: int) -> str:
    """``"stacked"`` where :func:`stack_pays`, else ``"composed"``."""
    return "stacked" if stack_pays(art, capacity) else "composed"


def _serving_key(art: TrainedVFLModel) -> tuple:
    """The fused session's cache key: whether the parties can stack
    (:func:`_can_stack`), each party's spec and the head's (whose width is
    the classes). No capacity, batch width or feature width, and no path:
    the path follows the capacity, so the session holds both paths'
    forwards and one built session serves every capacity of a deployed
    model geometry."""
    specs = tuple(module_spec(e) for e in art.extractors)
    return (_can_stack(art), specs, module_spec(art.classifier))


def _build_session(art: TrainedVFLModel) -> Dict[str, Callable]:
    """Path → fused forward: both paths where the parties can stack
    (:func:`_can_stack`), else the composed one."""
    paths = PATHS if _can_stack(art) else ("composed",)
    return {path: _build_fused_forward(art, path) for path in paths}


def _party_params(art: TrainedVFLModel, path: str) -> Any:
    """What the path's forward takes for the parties: the extractors
    themselves (composed), or their parameters stacked once on a leading K
    axis (stacked). The stack is made under ``no_grad`` and detached, never
    as inference tensors, so the artifact's modules can still train."""
    if path == "composed":
        return list(art.extractors)
    with torch.no_grad():
        params, _ = stack_module_state(list(art.extractors))
    return {name: p.detach() for name, p in params.items()}


def _build_fused_forward(art: TrainedVFLModel, path: str) -> Callable:
    """The forward ``(party_params, classifier, xs, mask) → (capacity, C)``
    logits of ``path``, padding rows zeroed; ``party_params`` is
    :func:`_party_params` of the same path. The stacked path applies one
    template of the parties' spec, built on the meta device at input width
    1: ``functional_call`` supplies every weight, and no forward reads a
    layer's input width."""
    if path not in PATHS:
        raise ValueError(f"unknown serving path {path!r}; use one of {PATHS}")
    if path == "composed":

        def composed(extractors, classifier, xs, mask):
            reps = [ext(x) for ext, x in zip(extractors, xs)]
            return torch.where(mask[:, None], classifier(torch.cat(reps, dim=-1)), 0.0)

        return composed
    if not art.parties_are_homogeneous:
        raise ValueError("the stacked serving path needs homogeneous parties")
    with torch.device("meta"):
        template = module_spec(art.extractors[0]).build((1,))
    extract = vmap(lambda params, x: functional_call(template, params, (x,)))

    def stacked(params, classifier, xs, mask):
        reps = extract(params, torch.stack(xs))  # (K, capacity, rep)
        flat = reps.transpose(0, 1).reshape(reps.shape[1], -1)  # party-major
        return torch.where(mask[:, None], classifier(flat), 0.0)

    return stacked


class ServingEngine:
    """Continuous batched inference over one deployed VFL model.

    ``device`` defaults to ``cuda`` and must be where the artifact lives
    (``load_artifact(..., device=)`` puts it there). The path
    (:func:`serving_path` of the artifact and the capacity) is fixed when
    the engine is made. The engine serves the artifact's current weights on
    both paths: the composed path reads the modules, and the stacked path
    stacks them again at its next step once a parameter has changed, in
    place (an optimizer step, ``load_state_dict``) or by replacement."""

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
        self.path = serving_path(art, self.capacity)
        self._key = _serving_key(art)
        self._stamp = self._weights_stamp()
        self._party_params = _party_params(art, self.path)

    # ------------------------------------------------------------ forward
    def _weights_stamp(self) -> Optional[tuple]:
        """Each party parameter's identity and version counter on the
        stacked path (``None`` on the composed one, which reads the live
        modules)."""
        if self.path != "stacked":
            return None
        return tuple((id(p), p._version) for e in self.art.extractors for p in e.parameters())

    def _current_party_params(self) -> Any:
        """The path's party parameters, stacked again if a weight changed
        since the last stack."""
        stamp = self._weights_stamp()
        if stamp != self._stamp:
            self._party_params = _party_params(self.art, self.path)
            self._stamp = stamp
        return self._party_params

    def _fused(self) -> Callable:
        """The session-cached fused forward of the engine's path (hits and
        misses visible under ``session_cache_stats("serving")``)."""
        return cached_session(SERVING_DOMAIN, self._key, lambda: _build_session(self.art))[self.path]

    def step(self, batch: batching.MaskedBatch) -> torch.Tensor:
        """One fixed-shape forward over a padded batch → (capacity, C)
        logits, padding rows zeroed. The unit ``batching.drive`` times."""
        params = self._current_party_params()
        with torch.inference_mode():
            return self._fused()(params, self.art.classifier, batch.xs, batch.mask)

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
        overlap reps with Eq. 10 (all K−1 as one ``sdpa_estimator`` launch
        on the card when their widths agree), then run the joint head."""
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
        f"path={engine.path} device={engine.device} ({time.time() - t0:.2f}s)"
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
