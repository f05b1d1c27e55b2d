"""One-shot (Alg. 1) and few-shot (Alg. 2) VFL end to end, with the
communication ledger.

Counterpart of ``repro.core.protocol::run_one_shot``, ``run_few_shot`` and
``run_few_shot_finetune`` at one seed. Every
client↔server transfer is logged in a :class:`CommLedger` with the
reference's events, tags and rounds, so the paper's communication columns
come from the training path itself:

1. ① clients upload their overlap representations H_o^k (round 1);
2. ② the server sends back ∇_{H_o^k} L (round 2);
3. ③ each client clusters its gradient rows into C pseudo-labels;
4. ④ each client trains its extractor and head by local SSL;
5. ⑤ clients upload refreshed representations (round 3);
6. ⑥ the server fits its classifier on them;

then the held-out split is scored (AUC for two classes, else accuracy).
Few-shot continues from there with one more round trip:

1. ①' clients upload their unaligned reps H_u^k with the ⑤ upload (round 3);
2. ②' the server fits an aux classifier f_c^k on each H_o^k;
3. ③' it estimates every party's missing reps of H_u^k (Eq. 10, the
   ``sdpa_estimator`` kernel on the card) and gates the rows (Eq. 8-9);
4. ④' p̂ goes down (round 4);
5. ⑤' each client re-runs SSL with its gated rows added to the labeled set;
6. ⑥' clients upload final overlap reps (round 5); the server re-fits f_c.

Few-shot + finetune (Tab. 1's last row) then trains the whole stack for a
while as vanilla SplitNN (``baselines.run_vanilla``), on the same ledger.

Each algorithm is implemented once, over a list of entries (the folds):
``_one_shot_pass`` / ``_few_shot_pass`` drive S seeds × C scenarios through
the exchanges together, with step ③ one k-means search over all S·C·K
gradient matrices, steps ④ and ⑤' one stacked S·C·K SSL session (where
``local_ssl.stack_pays``), ③' one
``sdpa_estimator`` launch a party over the stacked axis, and the server fits
stacked (``engine.batched``). The single-seed runners are the S = 1 case;
``run_seeds`` folds one scenario's seeds and ``run_scenarios_seeds`` a group
of equal-shape scenarios as well. Communication is a function of shapes,
so an unfaulted fold logs one prototype ledger (checked byte for byte
across entries at every exchange) and each result gets a copy.

A ``fault`` (``scenarios.FaultSpec``) is applied where the reference
applies it (``core.faults``): a dropped party's transfers are missing from
the ledger and the server rebuilds its uploads by Eq. 10 (⑤, ⑥' and the
evaluation), a party that skips an SSL session or straggles commits only
the steps its mask allows, and a dp_upload party's payloads carry noise.

Everything runs on ``device`` (``cuda`` unless the caller says ``"cpu"``).
Randomness comes from two generators seeded with ``seed``: one on the CPU
(weight init, integer schedule seeds) and one on the device (augmentation,
k-means++ and gate draws, gradient noise); a fault's noise comes from
generators of its own (``faults.fault_noise``). Few-shot's one-shot pass
draws exactly what ``run_one_shot`` draws at the same seed, and an entry of
a fold exactly what its single-seed run draws: every entry keeps its own
generators, and the stacked steps take draws made beforehand, entry after
entry, in the single-seed order.

``ProtocolConfig.mesh`` (None, a slot count or a ``launch.mesh.BatchMesh``)
shards every stacked stage of a pass over the mesh's slots
(``engine.parallel``): step ③'s search, the SSL sessions of ④ and ⑤', the
server fits and ③''s estimates, and few-shot + finetune's finetune
session (``IterativeConfig.mesh``). Every entry still draws what its
unsharded run draws, so the results and ledgers equal the unsharded fold's;
``device_fold`` records the slot count where the SSL sessions ran stacked
and 1 where they ran by the per-party loop.
"""

from __future__ import annotations

import time
from dataclasses import asdict, dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.checkpoint.artifact import ExtractorSpec, TrainedVFLModel, from_state
from repro_torch.core import faults
from repro_torch.core.client import VFLClient, make_client, ssl_task_for
from repro_torch.core.clustering import cluster_purity
from repro_torch.core.comm import CommLedger, nbytes
from repro_torch.core.metrics import accuracy, binary_auc
from repro_torch.core.server import VFLServer, fit_aux_classifiers_seeds, train_classifier_seeds
from repro_torch.core.ssl import SSLConfig
from repro_torch.data.vertical import VerticalSplit
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.engine import batched, parallel
from repro_torch.engine.local_ssl import PartyTask, SSLHParams, schedule_steps, seed_from
from repro_torch.launch.mesh import BatchMesh
from repro_torch.scenarios.faults import (
    POINT_ROUND2,
    POINT_SSL,
    POINT_UPLOAD1,
    POINT_UPLOAD2,
    FaultSpec,
)
from repro_torch.scenarios.grouping import split_signature

KMEANS_RESTARTS = 4  # the reference's step-③ default
_DEVICE_STREAM = 7919  # offset of the device generator's seed from the host's


@dataclass(frozen=True)
class ProtocolConfig:
    client_epochs: int = 20  # E_c
    server_epochs: int = 50  # E_s
    batch_size: int = 32  # B (paper: 32)
    client_lr: float = 0.01  # η_c (paper: 0.01)
    server_lr: float = 0.01  # η_s (paper: 0.01)
    fewshot_threshold: float = 0.9  # t in Eq. 9
    fewshot_stochastic_gate: bool = False  # Bernoulli(p̂) draws instead of keeping every p̂ > 0
    fewshot_relabel_overlap: bool = False  # ⑤': re-predict the overlap rows, not reuse Ŷ_o^k
    grad_dp_sigma: float = 0.0  # Gaussian noise on partial grads, × each grad's std
    kmeans_iters: int = 25
    unlabeled_ratio: int = 2
    engine_mode: str = "auto"  # "auto" | "vmap" | "python": the SSL sessions' path
    rep_dtype: torch.dtype = torch.float32
    mesh: object = None  # None | slot count | BatchMesh: the stacked stages' slots

    def ssl_hparams(self) -> SSLHParams:
        return SSLHParams(
            epochs=self.client_epochs,
            batch_size=self.batch_size,
            learning_rate=self.client_lr,
            unlabeled_ratio=self.unlabeled_ratio,
        )


@dataclass
class VFLResult:
    metric_name: str
    metric: float
    ledger: CommLedger
    clients: List[VFLClient]
    server: VFLServer
    extractor_specs: Sequence[ExtractorSpec] = ()
    cfg: Optional[ProtocolConfig] = None
    diagnostics: dict = field(default_factory=dict)

    def summary_row(self) -> dict:
        """The paper's three columns (metric, comm bytes, comm times) and the
        execution diagnostics, through the one typed row builder
        (``core.rows.training_row``)."""
        from repro_torch.core import rows

        return rows.training_row(self)

    def to_artifact(
        self, scenario: str = "", split: Optional[VerticalSplit] = None
    ) -> TrainedVFLModel:
        """The trained model as a serving artifact; with ``split``, its
        overlap representations H_o (Eq. 10's keys and values) are the
        trained extractors' outputs on the aligned rows."""
        protocol = {}
        if self.cfg is not None:
            protocol = asdict(self.cfg)
            protocol["rep_dtype"] = str(self.cfg.rep_dtype).removeprefix("torch.")
            # where the stacked stages ran, like the device: the trained
            # state does not depend on it
            protocol["mesh"] = None
        return from_state(
            [c.extractor for c in self.clients],
            [c.head for c in self.clients],
            self.server.classifier,
            self.extractor_specs,
            scenario=scenario,
            num_classes=self.server.num_classes,
            protocol=protocol,
            metric_name=self.metric_name,
            metric=self.metric,
            aligned=None if split is None else split.aligned,
        )


def _build_clients(
    split: VerticalSplit,
    specs: Sequence[ExtractorSpec],
    ssl_cfgs: Sequence[SSLConfig],
    generator: torch.Generator,
    device: torch.device,
) -> List[VFLClient]:
    clients = []
    for k, (spec, cfg) in enumerate(zip(specs, ssl_cfgs)):
        # x̄ for FixMatch-tab comes from the party's local rows: its private
        # pool, or its aligned block when the pool is empty (full overlap)
        pool = split.unaligned[k]
        if pool.dim() == 2 and pool.shape[0] == 0:
            pool = split.aligned[k]
        clients.append(
            make_client(
                k,
                spec,
                tuple(split.aligned[k].shape[1:]),
                split.num_classes,
                cfg,
                generator,
                device,
                local_data_for_mean=pool if pool.dim() == 2 else None,
            )
        )
    return clients


def _evaluate(
    server: VFLServer,
    clients: Sequence[VFLClient],
    split: VerticalSplit,
    fault: Optional[FaultSpec] = None,
    h_o_final: Optional[Sequence[torch.Tensor]] = None,
    seed: Optional[int] = None,
    record: Optional[list] = None,
) -> tuple:
    """The metric on the held-out split; under a fault, on the degraded view
    of the test reps (``faults.faulted_test_reps``: a dp_upload party's
    noise drawn for ``seed``, none without one)."""
    test_reps = [c.extract(x) for c, x in zip(clients, split.test_aligned)]
    if fault is not None:
        noise, party = None, fault.party
        if seed is not None and faults.dp_applies(fault, party) and party < len(test_reps):
            noise = faults.fault_noise(seed, faults.PHASE_TEST, test_reps[party])
        test_reps = faults.faulted_test_reps(test_reps, fault, h_o_final, noise, record)
    logits = server.predict_logits(test_reps)
    if split.num_classes == 2:
        return "auc", binary_auc(torch.softmax(logits, -1)[:, 1], split.test_labels)
    return "accuracy", accuracy(logits, split.test_labels)


class _StepClock:
    """Host-clock time of each protocol step, ended by a device sync."""

    def __init__(self, device: torch.device) -> None:
        self.device, self.ms, self._t = device, {}, time.perf_counter()

    def lap(self, name: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.ms[name] = (now - self._t) * 1e3
        self._t = now


def _log_round(
    ledger: CommLedger,
    direction: str,
    tag: str,
    payloads: Sequence,
    skip: Optional[Sequence[bool]] = None,
) -> None:
    """One round: party k's payload, unless ``skip[k]`` (its transfer is
    missing); the round advances either way."""
    r = ledger.next_round()
    for k, p in enumerate(payloads):
        if skip is None or not skip[k]:
            ledger.log_bytes(k, direction, tag, nbytes(p), round=r)


def _skips(fault: Optional[FaultSpec], num_parties: int, point: int) -> Optional[List[bool]]:
    """Per-party skip flags of a transfer at protocol ``point`` (None: no fault)."""
    if fault is None:
        return None
    return [faults.drop_skip(fault, k, point) for k in range(num_parties)]


def _dp_all(
    reps: Sequence[torch.Tensor], fault: Optional[FaultSpec], seed: int, phase: int
) -> List[torch.Tensor]:
    """Every party's payload of one phase, the dp_upload party's noised."""
    return [faults.dp_upload(r, fault, k, seed, phase) for k, r in enumerate(reps)]


def _generators(seed: int, dev: torch.device) -> Tuple[torch.Generator, torch.Generator]:
    """The run's CPU generator and its device generator."""
    host = torch.Generator().manual_seed(seed)
    return host, torch.Generator(device=dev).manual_seed(seed + _DEVICE_STREAM)


@dataclass
class _Entry:
    """One (scenario, seed) entry of a fold: its split on the device, its
    parties' specs and SSL configs, its fault, its two generators, and the
    ledger it logs to (its own in a faulted fold, else the fold's shared
    prototype). The passes fill in the rest."""

    seed: int
    split: VerticalSplit
    specs: Sequence[ExtractorSpec]
    ssl_cfgs: Sequence[SSLConfig]
    fault: Optional[FaultSpec]
    host: torch.Generator
    draws: torch.Generator
    ledger: CommLedger
    clients: List[VFLClient] = field(default_factory=list)
    server: Optional[VFLServer] = None
    reps: List[torch.Tensor] = field(default_factory=list)
    rebuilt: list = field(default_factory=list)  # each Eq. 10 reconstruction's record
    diags: Dict = field(default_factory=dict)


@dataclass
class _Fold:
    """The entries of one pass, the shared ledger of an unfaulted fold (None
    when every entry logs to its own), the config, the step clock and the
    resolved mesh of the stacked stages (None: unsharded)."""

    entries: List[_Entry]
    shared: Optional[CommLedger]
    cfg: ProtocolConfig
    clock: _StepClock
    mesh: Optional[BatchMesh] = None

    def device_fold(self, path: str) -> int:
        """The slot count an SSL session on ``path`` folded over: the
        mesh's on the stacked path, 1 on the per-party loop."""
        return parallel.device_fold(self.mesh) if path == "vmap" else 1

    @property
    def faulted(self) -> bool:
        """A fold given faults (even all None): every entry has its own
        ledger and every SSL session a commit mask, as the reference's."""
        return self.shared is None

    @property
    def num_parties(self) -> int:
        return len(self.entries[0].split.aligned)

    def log(self, direction: str, tag: str, payloads, point: Optional[int], new_round: bool = True):
        """One transfer of every party in every entry (``payloads[e][k]``).
        An unfaulted fold logs it once in its shared ledger, after checking
        that every entry moves the same bytes; a faulted fold logs each
        entry's, leaving out the parties its fault drops at ``point``. With
        ``new_round`` False the payloads ride the ledger's last round."""
        if self.shared is not None:
            led = self.shared
            r = led.next_round() if new_round else max(ev.round for ev in led.events)
            for k in range(self.num_parties):
                sizes = {nbytes(p[k]) for p in payloads}
                if len(sizes) != 1:
                    raise ValueError(
                        f"a fold broke ledger byte-identity for {tag!r}: per-entry bytes "
                        f"{sorted(sizes)}"
                    )
                led.log_bytes(k, direction, tag, sizes.pop(), round=r)
            return
        for ent, p in zip(self.entries, payloads):
            led = ent.ledger
            r = led.next_round() if new_round else max(ev.round for ev in led.events)
            skip = _skips(ent.fault, self.num_parties, point)
            for k in range(self.num_parties):
                if skip is None or not skip[k]:
                    led.log_bytes(k, direction, tag, nbytes(p[k]), round=r)


def _fold(
    seeds: Sequence[int],
    splits: Sequence[VerticalSplit],
    extractors: Sequence[Sequence[ExtractorSpec]],
    ssl_cfgs: Sequence[Sequence[SSLConfig]],
    cfg: ProtocolConfig,
    device: DeviceLike,
    faults: Optional[Sequence[Optional[FaultSpec]]],
    ledger: Optional[CommLedger] = None,
) -> _Fold:
    """The entries of a pass: each split moved to ``device``, each entry's
    generators seeded from its seed (``_generators``). ``faults`` (one
    FaultSpec or None per entry) gives every entry a ledger of its own;
    without it the entries share one prototype ledger. ``ledger`` is the
    one ledger of a single-entry pass. ``cfg.mesh`` resolves here, on
    ``device``'s type; a mesh of the other type is refused."""
    if not (len(splits) == len(extractors) == len(ssl_cfgs) == len(seeds)):
        raise ValueError("a fold needs one split, extractor list and SSL-config list per seed")
    if faults is not None and len(faults) != len(seeds):
        raise ValueError("faults needs one entry (FaultSpec or None) per stacked entry")
    if ledger is not None and len(seeds) != 1:
        raise ValueError("a ledger can be given to a single-entry pass only")
    dev = resolve_device(device)
    mesh = parallel.fold_mesh(cfg.mesh, dev)
    shared = None if faults is not None else (ledger if ledger is not None else CommLedger())
    entries = []
    for i, seed in enumerate(seeds):
        host, draws = _generators(seed, dev)
        own = shared if shared is not None else (ledger if ledger is not None else CommLedger())
        entries.append(
            _Entry(
                seed, _to_device(splits[i], dev), extractors[i], ssl_cfgs[i],
                None if faults is None else faults[i], host, draws, own,
            )
        )
    return _Fold(entries, shared, cfg, _StepClock(dev), mesh)


def _one_shot_pass(fold: _Fold) -> List[VFLResult]:
    """Alg. 1 over every entry of ``fold`` at once. Each entry draws from
    its own generators exactly what a single-seed run draws; step ③ is one
    k-means search over all S·C·K gradient matrices, step ④ one stacked
    SSL session (``engine.batched``), step ⑥ stacked fits. Leaves each
    entry's ⑤ uploads (the server's view, few-shot's H_o) in ``reps``."""
    cfg, clock, entries, mesh = fold.cfg, fold.clock, fold.entries, fold.mesh
    dev = entries[0].split.labels.device
    num_classes = entries[0].split.num_classes
    num_parties = fold.num_parties
    for ent in entries:
        ent.clients = _build_clients(ent.split, ent.specs, ent.ssl_cfgs, ent.host, dev)
        ent.server = VFLServer(num_classes=ent.split.num_classes)

    # ① clients upload overlap representations; a party dropped before it
    # never shows up and the server holds zeros in its slot
    for ent in entries:
        reps = [c.extract(x).to(cfg.rep_dtype) for c, x in zip(ent.clients, ent.split.aligned)]
        if ent.fault is not None:
            reps = [
                torch.zeros_like(r) if ent.fault.drops(k, POINT_UPLOAD1) else r
                for k, r in enumerate(_dp_all(reps, ent.fault, ent.seed, faults.PHASE_UPLOAD1))
            ]
        ent.reps = reps
    fold.log("up", "reps_overlap", [e.reps for e in entries], POINT_UPLOAD1)
    stale = [e.reps for e in entries]  # the server's last view, for ⑤'s reconstruction
    clock.lap("1_extract")

    # ② server computes and sends partial gradients (+ C), optionally noised
    grads_all = []
    for ent in entries:
        grads = ent.server.partial_gradients([r.float() for r in ent.reps], ent.split.labels, ent.host)
        if cfg.grad_dp_sigma > 0:
            noise = [torch.randn(g.shape, generator=ent.draws, device=dev) for g in grads]
            grads = [g + cfg.grad_dp_sigma * g.std(correction=0) * n for g, n in zip(grads, noise)]
        grads_all.append([g.to(cfg.rep_dtype) for g in grads])
    fold.log("down", "partial_grads", grads_all, POINT_SSL)
    clock.lap("2_partial_grads")

    # ③ gradient k-means → pseudo-labels: one search over every entry's
    # parties when all their gradient matrices share a shape
    km_info: dict = {}
    pseudo_all = batched.pseudo_labels_seeds(
        grads_all,
        num_classes,
        cfg.kmeans_iters,
        KMEANS_RESTARTS,
        generators=[e.draws for e in entries],
        info=km_info,
        mesh=mesh,
    )
    clock.lap("3_kmeans")

    # ④ local SSL; a padded split's mask keeps its duplicate rows out of the
    # labeled loss. Under a fault every party's session gets a commit mask
    # (all zeros where the party skips SSL).
    hp = cfg.ssl_hparams()
    tasks_all = []
    for ent, pseudo in zip(entries, pseudo_all):
        tasks = []
        for c, y_k, x_o, x_u in zip(ent.clients, pseudo, ent.split.aligned, ent.split.unaligned):
            sv = None
            if fold.faulted:  # every entry of a faulted fold gets a mask: one stacked shape
                skip = ent.fault is not None and ent.fault.skips_ssl(c.index)
                sv = faults.fault_step_valid(ent.fault, c.index, x_o.shape[0], hp, skip_all=skip)
            tasks.append(
                ssl_task_for(c, x_o, y_k, x_u, labeled_mask=ent.split.aligned_mask, step_valid=sv)
            )
        tasks_all.append(tasks)
    seeds0 = [[seed_from(e.host) for _ in tasks] for e, tasks in zip(entries, tasks_all)]
    metrics_all, paths = batched.train_clients_ssl_seeds(
        tasks_all, hp, seeds0, [e.draws for e in entries], cfg.engine_mode, mesh
    )
    clock.lap("4_local_ssl")

    # ⑤ refreshed representations (a party dropped by now is rebuilt by
    # Eq. 10 from the ① view);  ⑥ the server fits its classifier
    reps_all = []
    for ent in entries:
        reps = [c.extract(x).to(cfg.rep_dtype) for c, x in zip(ent.clients, ent.split.aligned)]
        if ent.fault is not None:
            reps = _dp_all(reps, ent.fault, ent.seed, faults.PHASE_UPLOAD2)
        reps_all.append(reps)
    reps_all = faults.reconstruct_dropped_seeds(
        reps_all, stale, [e.fault for e in entries], POINT_UPLOAD2, [e.rebuilt for e in entries]
    )
    for ent, reps in zip(entries, reps_all):
        ent.reps = reps
    fold.log("up", "reps_overlap_refreshed", reps_all, POINT_UPLOAD2)
    clock.lap("5_refresh")
    train_classifier_seeds(
        [e.server for e in entries],
        [[r.float() for r in reps] for reps in reps_all],
        [e.split.labels for e in entries],
        epochs=cfg.server_epochs,
        batch_size=cfg.batch_size,
        learning_rate=cfg.server_lr,
        generators=[e.host for e in entries],
        mesh=mesh,
    )
    clock.lap("6_server_fit")

    results = []
    for ent, pseudo, metrics, path in zip(entries, pseudo_all, metrics_all, paths):
        name, metric = _evaluate(
            ent.server, ent.clients, ent.split, ent.fault, ent.reps, ent.seed, ent.rebuilt
        )
        labels = ent.split.labels
        ent.diags = {
            "kmeans_purity": [cluster_purity(p, labels, num_classes) for p in pseudo],
            "pseudo_labels": pseudo,
            "ssl_metrics": metrics,
            "ssl_steps": [schedule_steps(x.shape[0], hp) for x in ent.split.aligned],
            "step_ms": clock.ms,
            "seed_fold": len(entries),
            "kernel_fold": km_info.get("fold", 1),
            "engine_path": path,
            "device_fold": fold.device_fold(path),
        }
        if "fallback" in km_info:
            ent.diags["kernel_fallback"] = km_info["fallback"]
        if fold.faulted:
            ent.diags.update(
                faults.fault_diags(ent.fault, num_parties, metric), fault_reconstruct=ent.rebuilt
            )
        results.append(
            VFLResult(name, metric, ent.ledger, ent.clients, ent.server, tuple(ent.specs), cfg, ent.diags)
        )
    clock.lap("eval")
    return results


def _one_shot_seeds(
    seeds: Sequence[int],
    splits: Sequence[VerticalSplit],
    extractors: Sequence[Sequence[ExtractorSpec]],
    ssl_cfgs: Sequence[Sequence[SSLConfig]],
    cfg: Optional[ProtocolConfig] = None,
    device: DeviceLike = None,
    faults: Optional[Sequence[Optional[FaultSpec]]] = None,
    ledger: Optional[CommLedger] = None,
) -> List[VFLResult]:
    """Alg. 1 over S entries at once (seeds, or scenarios × seeds flattened
    scenario-major). Unfaulted, every result holds the one prototype ledger
    (callers copy it per result); with ``faults`` each entry has its own."""
    cfg = cfg if cfg is not None else ProtocolConfig()
    fold = _fold(seeds, splits, extractors, ssl_cfgs, cfg, device, faults, ledger)
    return _one_shot_pass(fold)


def run_one_shot(
    seed: int,
    split: VerticalSplit,
    extractors: Sequence[ExtractorSpec],
    ssl_cfgs: Sequence[SSLConfig],
    cfg: Optional[ProtocolConfig] = None,
    ledger: Optional[CommLedger] = None,
    device: DeviceLike = None,
    fault: Optional[FaultSpec] = None,
) -> VFLResult:
    """Alg. 1 one-shot VFL on ``split``: K parties with the extractors of
    ``extractors`` and the SSL recipes of ``ssl_cfgs``, under ``fault`` if
    given; the S = 1 case of :func:`run_seeds`. The split is moved to
    ``device`` first. ``diagnostics`` carries the k-means purity, the SSL
    sessions' last metrics and steps, each step's time (``step_ms``), and
    the fold record (``seed_fold``, ``kernel_fold``, ``engine_path``, and
    ``device_fold``: the mesh's slot count where ④ ran stacked over
    ``cfg.mesh``, else 1); under a fault also ``faults.fault_diags``'s keys and
    ``fault_reconstruct``, each Eq. 10 reconstruction's inputs and output
    (⑤, then the evaluation)."""
    return _one_shot_seeds(
        [seed], [split], [extractors], [ssl_cfgs], cfg, device,
        None if fault is None else [fault], ledger,
    )[0]


def fewshot_phase5_labels(
    client: VFLClient,
    x_o: torch.Tensor,
    x_u: torch.Tensor,
    pseudo_overlap: torch.Tensor,
    relabel_overlap: bool = False,
) -> torch.Tensor:
    """Labels of the phase-⑤' labeled set ``x_o ∘ x_u`` (Alg. 2 l.11-19):
    the overlap rows keep the step-③ pseudo-labels Ŷ_o^k (or, with
    ``relabel_overlap``, the local head's predictions), the pool rows take
    the local head's predictions (the Eq. 9 gate masks them)."""
    y_o = client.predict(x_o) if relabel_overlap else pseudo_overlap.long()
    return torch.cat([y_o, client.predict(x_u)])


def fewshot_task(
    client: VFLClient,
    x_o: torch.Tensor,
    x_u: torch.Tensor,
    probs: torch.Tensor,
    pseudo_overlap: torch.Tensor,
    cfg: ProtocolConfig,
    generator: Optional[torch.Generator] = None,
    aligned_mask: Optional[torch.Tensor] = None,
    absent: bool = False,
    step_valid: Optional[torch.Tensor] = None,
) -> Tuple[PartyTask, torch.Tensor]:
    """One party's phase-⑤' SSL task and its take mask (N_u,) float32.

    The labeled set is the whole ``x_o ∘ x_u`` at capacity N_o + N_u with
    the mask ``[aligned_mask ∘ take]`` (ones for the overlap rows when the
    split has no mask); the unlabeled set is the whole pool with the mask
    ``1 − take``, so no row is in both. ``take`` keeps every gated row
    (p̂ > 0, the paper's rule), or under ``cfg.fewshot_stochastic_gate`` is a
    Bernoulli(p̂) draw from the device ``generator``. A party ``absent``
    from round 2 never received p̂: its take is all zeros (after the draw).
    ``step_valid`` is the session's commit mask (None: every step)."""
    if cfg.fewshot_stochastic_gate:
        take = torch.bernoulli(probs.clamp(0.0, 1.0), generator=generator)
    else:
        take = (probs > 0).float()
    if absent:
        take = torch.zeros_like(take)
    x_lab = torch.cat([x_o, x_u])
    y_lab = fewshot_phase5_labels(client, x_o, x_u, pseudo_overlap, cfg.fewshot_relabel_overlap)
    o_mask = (
        torch.ones(x_o.shape[0], device=take.device)
        if aligned_mask is None
        else aligned_mask.float()
    )
    lab_mask = torch.cat([o_mask, take])
    task = ssl_task_for(
        client,
        x_lab,
        y_lab,
        x_u,
        labeled_mask=lab_mask,
        unlabeled_mask=1.0 - take,
        step_valid=step_valid,
    )
    return task, take


def _rate(mask: torch.Tensor) -> float:
    """Mean of a 0/1 mask; 0 for an empty pool."""
    return float(mask.float().mean()) if mask.numel() else 0.0


def _few_shot_pass(fold: _Fold) -> List[VFLResult]:
    """Alg. 2 over every entry of ``fold``: the one-shot pass, then one more
    round trip, each step over all entries at once (the aux fits stacked,
    ③' one ``sdpa_estimator`` launch a party over the stacked axis, ⑤' one
    stacked session, ⑥' stacked fits). See :func:`run_few_shot`."""
    cfg, clock, entries, mesh = fold.cfg, fold.clock, fold.entries, fold.mesh
    ones = _one_shot_pass(fold)
    num_parties = fold.num_parties
    h_o_all = [e.reps for e in entries]  # the ⑤ uploads: the server's H_o
    for ent, one in zip(entries, ones):
        ent.diags = dict(one.diagnostics, one_shot_metric=one.metric)
    gone = [_skips(e.fault, num_parties, POINT_ROUND2) for e in entries]

    # ①' unaligned reps go up in the ⑤ upload's round
    h_u_all = []
    for ent in entries:
        h_u = [c.extract(x).to(cfg.rep_dtype) for c, x in zip(ent.clients, ent.split.unaligned)]
        if ent.fault is not None:
            h_u = _dp_all(h_u, ent.fault, ent.seed, faults.PHASE_UNALIGNED)
        h_u_all.append(h_u)
    fold.log("up", "reps_unaligned", h_u_all, POINT_ROUND2, new_round=False)
    clock.lap("1p_unaligned")

    # ②' the server fits f_c^k on each H_o^k (f_c is ⑥'s)
    fit_aux_classifiers_seeds(
        [e.server for e in entries],
        [[h.float() for h in h_o] for h_o in h_o_all],
        [e.split.labels for e in entries],
        epochs=cfg.server_epochs,
        batch_size=cfg.batch_size,
        learning_rate=cfg.server_lr,
        generators=[e.host for e in entries],
        mesh=mesh,
    )
    clock.lap("2p_aux_fit")

    # ③' Eq. 10 estimates + Eq. 8-9 gate, one party at a time over the
    # stacked entries;  ④' p̂ goes down
    servers = [e.server for e in entries]
    h_o_stacks = [torch.stack([h_o[j] for h_o in h_o_all]) for j in range(num_parties)]
    probs_all: List[List[torch.Tensor]] = [[] for _ in entries]
    ests_all: List[List[List[torch.Tensor]]] = [[] for _ in entries]
    for k in range(num_parties):
        ests: List[torch.Tensor] = []
        h_u_stack = torch.stack([h_u[k] for h_u in h_u_all])
        probs = batched.fewshot_probs_seeds(
            servers, k, h_u_stack, h_o_stacks, cfg.fewshot_threshold, ests, mesh
        )
        for e in range(len(entries)):
            probs_all[e].append(probs[e])
            ests_all[e].append([est[e] for est in ests])
    fold.log("down", "pseudo_label_probs", probs_all, POINT_ROUND2)
    joints = [srv.classifier for srv in servers]  # the f_c that gated (⑥' replaces it)
    clock.lap("3p_estimate_gate")

    # ⑤' each party adds its gated rows to the labeled set and re-runs SSL;
    # a party absent from round 2 gates nothing in and commits no step
    hp = cfg.ssl_hparams()
    tasks_all, takes_all = [], []
    for ent, probs, absent_k in zip(entries, probs_all, gone):
        tasks, takes = [], []
        for c, x_o, x_u, p, y_o in zip(
            ent.clients, ent.split.aligned, ent.split.unaligned, probs, ent.diags["pseudo_labels"]
        ):
            absent, sv = False, None
            if ent.fault is not None:
                absent = ent.fault.skips_ssl(c.index) or absent_k[c.index]
            if fold.faulted:
                n_lab = x_o.shape[0] + x_u.shape[0]
                sv = faults.fault_step_valid(ent.fault, c.index, n_lab, hp, skip_all=absent)
            task, take = fewshot_task(
                c, x_o, x_u, p, y_o, cfg, ent.draws, ent.split.aligned_mask, absent, sv
            )
            tasks.append(task)
            takes.append(take)
        tasks_all.append(tasks)
        takes_all.append(takes)
    seeds0 = [[seed_from(e.host) for _ in tasks] for e, tasks in zip(entries, tasks_all)]
    metrics_all, paths = batched.train_clients_ssl_seeds(
        tasks_all, hp, seeds0, [e.draws for e in entries], cfg.engine_mode, mesh
    )
    clock.lap("5p_local_ssl")

    # ⑥' final overlap reps go up (a party dropped by round 2 is rebuilt by
    # Eq. 10 over the ⑤ view); the server re-fits a fresh f_c on them
    reps_all = []
    for ent in entries:
        reps = [c.extract(x).to(cfg.rep_dtype) for c, x in zip(ent.clients, ent.split.aligned)]
        if ent.fault is not None:
            reps = _dp_all(reps, ent.fault, ent.seed, faults.PHASE_FINAL)
        reps_all.append(reps)
    reps_all = faults.reconstruct_dropped_seeds(
        reps_all, h_o_all, [e.fault for e in entries], POINT_ROUND2, [e.rebuilt for e in entries]
    )
    fold.log("up", "reps_overlap_final", reps_all, POINT_ROUND2)
    train_classifier_seeds(
        servers,
        [[r.float() for r in reps] for reps in reps_all],
        [e.split.labels for e in entries],
        epochs=cfg.server_epochs,
        batch_size=cfg.batch_size,
        learning_rate=cfg.server_lr,
        generators=[e.host for e in entries],
        mesh=mesh,
    )
    clock.lap("6p_server_refit")

    results = []
    for i, ent in enumerate(entries):
        name, metric = _evaluate(
            ent.server, ent.clients, ent.split, ent.fault, reps_all[i], ent.seed, ent.rebuilt
        )
        diags = ent.diags
        if fold.faulted:
            diags.update(
                faults.fault_diags(ent.fault, num_parties, metric), fault_reconstruct=ent.rebuilt
            )
        diags.update(
            fewshot_step3p=dict(
                h_u=h_u_all[i], h_o=h_o_all[i], estimates=ests_all[i], probs=probs_all[i],
                joint=joints[i],
            ),
            fewshot_gate_rate=[_rate(p > 0) for p in probs_all[i]],
            fewshot_take_rate=[_rate(take) for take in takes_all[i]],
            ssl_metrics=diags["ssl_metrics"] + metrics_all[i],
            fewshot_ssl_steps=[schedule_steps(t.x_labeled.shape[0], hp) for t in tasks_all[i]],
            sdpa_fold=len(entries),
            engine_path=paths[i],
            device_fold=fold.device_fold(paths[i]),
        )
        results.append(
            VFLResult(name, metric, ent.ledger, ent.clients, ent.server, tuple(ent.specs), cfg, diags)
        )
    clock.lap("eval_few_shot")
    return results


def _few_shot_seeds(
    seeds: Sequence[int],
    splits: Sequence[VerticalSplit],
    extractors: Sequence[Sequence[ExtractorSpec]],
    ssl_cfgs: Sequence[Sequence[SSLConfig]],
    cfg: Optional[ProtocolConfig] = None,
    device: DeviceLike = None,
    faults: Optional[Sequence[Optional[FaultSpec]]] = None,
    ledger: Optional[CommLedger] = None,
) -> List[VFLResult]:
    """Alg. 2 over S entries at once; ledgers as :func:`_one_shot_seeds`'s."""
    cfg = cfg if cfg is not None else ProtocolConfig()
    fold = _fold(seeds, splits, extractors, ssl_cfgs, cfg, device, faults, ledger)
    return _few_shot_pass(fold)


def run_few_shot(
    seed: int,
    split: VerticalSplit,
    extractors: Sequence[ExtractorSpec],
    ssl_cfgs: Sequence[SSLConfig],
    cfg: Optional[ProtocolConfig] = None,
    ledger: Optional[CommLedger] = None,
    device: DeviceLike = None,
    fault: Optional[FaultSpec] = None,
) -> VFLResult:
    """Alg. 2 few-shot VFL on ``split``: the one-shot pass of
    :func:`run_one_shot` at the same seed and ``fault``, then one more round
    trip (①'-⑥'); the S = 1 case of :func:`run_seeds`. A party dropped by
    round 2 logs none of its events, gates nothing in and commits no ⑤'
    step; the server rebuilds its ⑥' upload by Eq. 10 over the ⑤ view.
    ``diagnostics`` adds to the one-shot pass's: its metric
    (``one_shot_metric``), step ③''s inputs and outputs (``fewshot_step3p``:
    H_u^k, the ⑤ uploads H_o^k, the Eq. 10 estimates of each party, p̂, and
    the joint f_c that gated them), the per-party gate and take rates, the
    ⑤' sessions' last metrics (appended to ``ssl_metrics``) and steps
    (``fewshot_ssl_steps``), ``sdpa_fold``, and each round-2 step's time in
    ``step_ms``; under a fault, the fault diagnostics of the few-shot metric
    and every reconstruction of both rounds in ``fault_reconstruct``."""
    return _few_shot_seeds(
        [seed], [split], [extractors], [ssl_cfgs], cfg, device,
        None if fault is None else [fault], ledger,
    )[0]


def _few_shot_finetune_seeds(
    seeds: Sequence[int],
    splits: Sequence[VerticalSplit],
    extractors: Sequence[Sequence[ExtractorSpec]],
    ssl_cfgs: Sequence[Sequence[SSLConfig]],
    cfg: Optional[ProtocolConfig] = None,
    finetune_iterations: int = 200,
    device: DeviceLike = None,
    faults: Optional[Sequence[Optional[FaultSpec]]] = None,
) -> List[VFLResult]:
    """Tab. 1's last row over S entries: the few-shot fold hands every
    entry's trained clients and fitted server straight to ONE
    ``baselines.run_vanilla_seeds`` fold, which continues the few-shot
    fold's ledger (see :func:`run_few_shot_finetune`); no per-entry loop in
    between. The finetune session runs on the few-shot fold's mesh; the
    diagnostics are the few-shot fold's, with the finetune's path and slot
    count as ``finetune_engine_path`` / ``finetune_device_fold`` and its
    stage times as ``finetune_*`` in ``step_ms``."""
    from repro_torch.core import baselines  # deferred: baselines imports this module

    if faults is not None and any(f is not None for f in faults):
        raise ValueError(
            "few_shot_finetune does not support fault injection: the chained finetune "
            "stage is the iterative round loop; model its dropout cost with "
            "baselines.run_vanilla(fault=...) instead"
        )
    cfg = cfg if cfg is not None else ProtocolConfig()
    fold = _fold(seeds, splits, extractors, ssl_cfgs, cfg, device, None)
    fews = _few_shot_pass(fold)
    it_cfg = baselines.IterativeConfig(
        iterations=finetune_iterations,
        batch_size=cfg.batch_size,
        client_lr=cfg.client_lr / 10,
        server_lr=cfg.server_lr / 10,
        mesh=fold.mesh,
    )
    results = baselines.run_vanilla_seeds(
        [seed_from(ent.host) for ent in fold.entries],
        [ent.split for ent in fold.entries],
        [ent.specs for ent in fold.entries],
        [ent.ssl_cfgs for ent in fold.entries],
        it_cfg,
        clients_per_seed=[few.clients for few in fews],
        servers=[few.server for few in fews],
        ledger=fold.shared,  # one ledger spans both stages
        device=fold.clock.device,
    )
    for res, few in zip(results, fews):
        d = res.diagnostics
        step_ms = dict(few.diagnostics["step_ms"])
        step_ms.update({f"finetune_{k}": v for k, v in d["step_ms"].items()})
        finetune = {f"finetune_{k}": d[k] for k in ("engine_path", "device_fold")}
        d.update(few.diagnostics, fewshot_metric=few.metric, step_ms=step_ms, **finetune)
    return results


def run_few_shot_finetune(
    seed: int,
    split: VerticalSplit,
    extractors: Sequence[ExtractorSpec],
    ssl_cfgs: Sequence[SSLConfig],
    cfg: Optional[ProtocolConfig] = None,
    finetune_iterations: int = 200,
    device: DeviceLike = None,
    fault: Optional[FaultSpec] = None,
) -> VFLResult:
    """Tab. 1's last row: :func:`run_few_shot` at ``seed``, draw for draw, as
    pre-training, then ``baselines.run_vanilla`` finetuning of the trained
    extractors and classifier for ``finetune_iterations`` at a tenth of the
    learning rates, its schedule seeded by the next draw of the few-shot
    pass's CPU generator. One ledger spans both stages. ``diagnostics``
    holds the finetune's (``iterations``, ``losses``, ``final_loss``), the
    few-shot pass's on top of them, its metric (``fewshot_metric``), and in
    ``step_ms`` the few-shot steps then the finetune's as ``finetune_*``.
    A ``fault`` is refused: the finetune is the iterative round loop, whose
    dropout cost ``baselines.run_vanilla(fault=...)`` models."""
    return _few_shot_finetune_seeds(
        [seed], [split], [extractors], [ssl_cfgs], cfg, finetune_iterations, device,
        None if fault is None else [fault],
    )[0]


# ---------------------------------------------------- multi-seed orchestrator
def _splits_are_homogeneous(splits: Sequence[VerticalSplit]) -> bool:
    """True when every split shares all shapes and the class count: the
    precondition of a fold (communication is then entry-invariant)."""
    s0 = split_signature(splits[0])
    return all(split_signature(sp) == s0 for sp in splits[1:])


def _copy_ledger(ledger: CommLedger) -> CommLedger:
    return CommLedger(events=list(ledger.events), _round_counter=ledger._round_counter)


def _assert_ledgers_identical(ledgers: Sequence[CommLedger]) -> None:
    l0 = ledgers[0]
    for i, led in enumerate(ledgers[1:], start=1):
        if (
            led.total_bytes() != l0.total_bytes()
            or led.comm_times() != l0.comm_times()
            or led.by_tag() != l0.by_tag()
        ):
            raise ValueError(
                f"seed {i} produced a different communication ledger than seed 0: multi-seed "
                f"runs of one scenario point must be byte-identical ({led.total_bytes()} vs "
                f"{l0.total_bytes()} bytes)"
            )


def _run_one_scenario_seeds(
    runner, entry, seeds, splits, extractors, ssl_cfgs, cfg, device, faults=None, **kw
) -> List[VFLResult]:
    """One scenario's S seeds when the cross-scenario fold does not apply:
    the registered ``*_seeds`` impl when the seeds share one shape, else a
    per-seed loop of the runner (ledger byte-identity asserted after)."""
    impl = entry.seeds_impl if entry is not None else None
    if impl is not None and _splits_are_homogeneous(splits):
        if faults is not None:
            kw["faults"] = list(faults)
        results = impl(list(seeds), list(splits), list(extractors), list(ssl_cfgs), cfg, device=device, **kw)
        if len(results) > 1:  # the shared prototype ledger → per-seed copies
            for res in results:
                res.ledger = _copy_ledger(res.ledger)
    else:
        results = [
            runner(s, sp, ex, sc, cfg, device=device,
                   **(kw if faults is None else {**kw, "fault": faults[i]}))
            for i, (s, sp, ex, sc) in enumerate(zip(seeds, splits, extractors, ssl_cfgs))
        ]
        if faults is None or all(f is None for f in faults):
            _assert_ledgers_identical([r.ledger for r in results])
        for res in results:
            res.diagnostics["seed_fold"] = 1
    for res in results:
        res.diagnostics.setdefault("scenario_fold", 1)
        res.diagnostics.setdefault("device_fold", 1)
    return results


def run_scenarios_seeds(
    runner,
    seeds: Sequence[Sequence[int]],
    splits: Sequence[Sequence[VerticalSplit]],
    extractors: Sequence[Sequence[Sequence[ExtractorSpec]]],
    ssl_cfgs: Sequence[Sequence[Sequence[SSLConfig]]],
    cfg=None,
    device: DeviceLike = None,
    **runner_kwargs,
) -> List[List[VFLResult]]:
    """C grouped scenarios × S seeds as ONE folded sweep. Arguments are
    rectangular C×S grids (``seeds[c][s]`` …); returns the results on the
    same grid.

    The stacked axis is anonymous, so a group of scenarios whose splits
    share one shape signature flattens scenario-major into the registered
    ``*_seeds`` impl like extra seeds: one stacked S·C·K SSL session, one
    k-means search, stacked server fits. Session-cache keys carry no batch
    width, so a C ≥ 2 fold against a warm C = 1 cache builds nothing fresh.
    Each result's ``diagnostics["seed_fold"]`` / ``["scenario_fold"]`` record
    the fold that ran; the iterative baselines fold the same way, into one
    stacked S·C session (``baselines.run_*_seeds``). Grids whose splits
    differ in shape and unregistered runners go scenario by scenario
    (``scenario_fold`` 1); :func:`run_seeds`
    is the C = 1 case. ``faults`` is an optional C×S grid of FaultSpecs,
    carried as per-entry data. Per-seed state kwargs are refused. A
    config's ``mesh`` (a ``ProtocolConfig``'s or an ``IterativeConfig``'s) is
    resolved once, here, and shards every pass of the sweep
    (``device_fold``)."""
    from repro_torch.core import runners as registry  # deferred: the registry imports this module

    num_scenarios = len(seeds)
    if not (len(splits) == len(extractors) == len(ssl_cfgs) == num_scenarios):
        raise ValueError(
            "run_scenarios_seeds needs one per-seed list of seeds / splits / extractor "
            "lists / ssl-config lists per scenario"
        )
    if num_scenarios == 0:
        return []
    num_seeds = len(seeds[0])
    for c in range(num_scenarios):
        if not (len(seeds[c]) == len(splits[c]) == len(extractors[c]) == len(ssl_cfgs[c]) == num_seeds):
            raise ValueError(
                "run_scenarios_seeds needs a rectangular C×S grid: every scenario must carry "
                "the same per-seed list lengths"
            )
    entry = registry.resolve(runner)
    registry.reject_stateful_kwargs("run_scenarios_seeds", runner_kwargs, entry)
    if getattr(cfg, "mesh", None) is not None:  # a ProtocolConfig's or an IterativeConfig's
        cfg = replace(cfg, mesh=parallel.resolve_mesh(cfg.mesh, resolve_device(device)))
    faults = runner_kwargs.pop("faults", None)
    if faults is not None:
        if len(faults) != num_scenarios or any(len(row) != num_seeds for row in faults):
            raise ValueError(
                "faults must mirror the C×S grid: one entry (FaultSpec or None) per scenario per seed"
            )
        if not any(f is not None for row in faults for f in row):
            faults = None
    flat_splits = [sp for row in splits for sp in row]
    if (
        entry is not None
        and num_scenarios > 1
        and _splits_are_homogeneous(flat_splits)
    ):
        kw = dict(runner_kwargs)
        if faults is not None:
            kw["faults"] = [f for row in faults for f in row]
        results = entry.seeds_impl(
            [s for row in seeds for s in row],
            flat_splits,
            [e for row in extractors for e in row],
            [s for row in ssl_cfgs for s in row],
            cfg,
            device=device,
            **kw,
        )
        for res in results:  # the shared prototype ledger → per-entry copies
            res.ledger = _copy_ledger(res.ledger)
            res.diagnostics["seed_fold"] = num_seeds
            res.diagnostics["scenario_fold"] = num_scenarios
            res.diagnostics.setdefault("device_fold", 1)
        return [results[c * num_seeds : (c + 1) * num_seeds] for c in range(num_scenarios)]
    return [
        _run_one_scenario_seeds(
            runner, entry, list(seeds[c]), list(splits[c]), list(extractors[c]),
            list(ssl_cfgs[c]), cfg, device, None if faults is None else list(faults[c]),
            **runner_kwargs,
        )
        for c in range(num_scenarios)
    ]


def run_seeds(
    runner,
    seeds: Sequence[int],
    splits: Sequence[VerticalSplit],
    extractors: Sequence[Sequence[ExtractorSpec]],
    ssl_cfgs: Sequence[Sequence[SSLConfig]],
    cfg=None,
    device: DeviceLike = None,
    **runner_kwargs,
) -> List[VFLResult]:
    """One scenario point over S seeds: the C = 1 case of
    :func:`run_scenarios_seeds`. The protocol runners (``run_one_shot``,
    ``run_few_shot``, ``run_few_shot_finetune``) fold their S·K SSL
    sessions, k-means runs and server fits; each seed draws exactly what
    its single-seed run draws, so ``run_seeds`` equals a loop of single-seed
    runs up to the rounding of batched products, with byte-identical
    ledgers (each result holds its own copy). The iterative baselines
    (``run_vanilla``, ``run_fedcvt``, ``run_fedbcd``) fold their S sessions
    into one stacked session. ``faults`` is an optional per-seed list; per-seed
    state kwargs (``clients``, ``server``, ``ledger``) are refused. A
    ``ProtocolConfig.mesh`` shards the protocol folds' stacked stages, an
    ``IterativeConfig.mesh`` the baselines' stacked session."""
    if not (len(splits) == len(extractors) == len(ssl_cfgs) == len(seeds)):
        raise ValueError("run_seeds needs one split / extractor list / ssl-config list per seed")
    from repro_torch.core import runners as registry

    registry.reject_stateful_kwargs("run_seeds", runner_kwargs, registry.resolve(runner))
    faults = runner_kwargs.pop("faults", None)
    if faults is not None:
        runner_kwargs["faults"] = [list(faults)]
    return run_scenarios_seeds(
        runner, [list(seeds)], [list(splits)], [list(extractors)], [list(ssl_cfgs)], cfg,
        device=device, **runner_kwargs,
    )[0]


def _to_device(split: VerticalSplit, dev: torch.device) -> VerticalSplit:
    def move(ts):
        return None if ts is None else [t.to(dev) for t in ts]

    return VerticalSplit(
        aligned=move(split.aligned),
        labels=split.labels.to(dev),
        unaligned=move(split.unaligned),
        test_aligned=move(split.test_aligned),
        test_labels=split.test_labels.to(dev),
        num_classes=split.num_classes,
        unaligned_labels=move(split.unaligned_labels),
        aligned_mask=None if split.aligned_mask is None else split.aligned_mask.to(dev),
    )
