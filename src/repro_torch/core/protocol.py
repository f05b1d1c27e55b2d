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
draws exactly what ``run_one_shot`` draws at the same seed.
"""

from __future__ import annotations

import time
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.checkpoint.artifact import ExtractorSpec, TrainedVFLModel, from_state
from repro_torch.core import faults
from repro_torch.core.client import VFLClient, make_client, ssl_task_for
from repro_torch.core.clustering import cluster_purity
from repro_torch.core.comm import CommLedger, nbytes
from repro_torch.core.metrics import accuracy, binary_auc
from repro_torch.core.server import VFLServer
from repro_torch.core.ssl import SSLConfig
from repro_torch.data.vertical import VerticalSplit
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.engine import dispatch
from repro_torch.engine.local_ssl import (
    PartyTask,
    SSLHParams,
    schedule_steps,
    seed_from,
    train_party_ssl,
)
from repro_torch.scenarios.faults import (
    POINT_ROUND2,
    POINT_SSL,
    POINT_UPLOAD1,
    POINT_UPLOAD2,
    FaultSpec,
)

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
    rep_dtype: torch.dtype = torch.float32

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


def _one_shot_pass(
    split: VerticalSplit,
    extractors: Sequence[ExtractorSpec],
    ssl_cfgs: Sequence[SSLConfig],
    cfg: ProtocolConfig,
    ledger: CommLedger,
    host: torch.Generator,
    draws: torch.Generator,
    clock: _StepClock,
    fault: Optional[FaultSpec] = None,
    seed: int = 0,
) -> Tuple[VFLResult, List[torch.Tensor]]:
    """Alg. 1 on a split already on its device, drawing from the caller's
    generators (``fault``'s noise from those of ``seed``); returns the
    result and the server's view of the step-⑤ uploads (few-shot's H_o)."""
    dev = split.labels.device
    clients = _build_clients(split, extractors, ssl_cfgs, host, dev)
    server = VFLServer(num_classes=split.num_classes)
    num_classes = split.num_classes
    num_parties = len(clients)
    rebuilt: list = []  # each Eq. 10 reconstruction's inputs and output

    # ① clients upload overlap representations; a party dropped before it
    # never shows up and the server holds zeros in its slot
    reps = [c.extract(x).to(cfg.rep_dtype) for c, x in zip(clients, split.aligned)]
    if fault is not None:
        reps = [
            torch.zeros_like(r) if fault.drops(k, POINT_UPLOAD1) else r
            for k, r in enumerate(_dp_all(reps, fault, seed, faults.PHASE_UPLOAD1))
        ]
    _log_round(ledger, "up", "reps_overlap", reps, _skips(fault, num_parties, POINT_UPLOAD1))
    stale = reps  # the server's last view of every party, for ⑤'s reconstruction
    clock.lap("1_extract")

    # ② server computes and sends partial gradients (+ C), optionally noised
    grads = server.partial_gradients([r.float() for r in reps], split.labels, host)
    if cfg.grad_dp_sigma > 0:
        noise = [torch.randn(g.shape, generator=draws, device=dev) for g in grads]
        grads = [g + cfg.grad_dp_sigma * g.std(correction=0) * n for g, n in zip(grads, noise)]
    grads = [g.to(cfg.rep_dtype) for g in grads]
    _log_round(ledger, "down", "partial_grads", grads, _skips(fault, num_parties, POINT_SSL))
    clock.lap("2_partial_grads")

    # ③ gradient k-means → pseudo-labels; one batched search when the
    # parties' gradient matrices share a shape
    km = (num_classes, cfg.kmeans_iters, KMEANS_RESTARTS)
    if len({tuple(g.shape) for g in grads}) == 1:
        stacked = torch.stack(grads).float()
        pseudo = list(dispatch.pseudo_labels_batched(stacked, *km, generator=draws))
    else:
        pseudo = [dispatch.pseudo_labels(g.float(), *km, generator=draws) for g in grads]
    purity = [cluster_purity(p, split.labels, num_classes) for p in pseudo]
    clock.lap("3_kmeans")

    # ④ local SSL, one party after another; a padded split's mask keeps its
    # duplicate rows out of the labeled loss. Under a fault every party's
    # session gets a commit mask (all zeros where the party skips SSL).
    hp = cfg.ssl_hparams()
    ssl_metrics = []
    for c, y_k, x_o, x_u in zip(clients, pseudo, split.aligned, split.unaligned):
        sv = None
        if fault is not None:
            sv = faults.fault_step_valid(
                fault, c.index, x_o.shape[0], hp, skip_all=fault.skips_ssl(c.index)
            )
        task = ssl_task_for(c, x_o, y_k, x_u, labeled_mask=split.aligned_mask, step_valid=sv)
        ssl_metrics.append(train_party_ssl(task, hp, seed_from(host), generator=draws))
    clock.lap("4_local_ssl")

    # ⑤ refreshed representations (a party dropped by now is rebuilt by
    # Eq. 10 from the ① view);  ⑥ the server fits its classifier
    reps = [c.extract(x).to(cfg.rep_dtype) for c, x in zip(clients, split.aligned)]
    if fault is not None:
        reps = _dp_all(reps, fault, seed, faults.PHASE_UPLOAD2)
        reps = faults.reconstruct_dropped(reps, stale, fault, POINT_UPLOAD2, rebuilt)
    _log_round(
        ledger, "up", "reps_overlap_refreshed", reps, _skips(fault, num_parties, POINT_UPLOAD2)
    )
    clock.lap("5_refresh")
    server.train_classifier(
        [r.float() for r in reps],
        split.labels,
        epochs=cfg.server_epochs,
        batch_size=cfg.batch_size,
        learning_rate=cfg.server_lr,
        generator=host,
    )
    clock.lap("6_server_fit")

    name, metric = _evaluate(server, clients, split, fault, reps, seed, rebuilt)
    clock.lap("eval")
    diags: Dict = {
        "kmeans_purity": purity,
        "pseudo_labels": pseudo,
        "ssl_metrics": ssl_metrics,
        "ssl_steps": [schedule_steps(x.shape[0], hp) for x in split.aligned],
        "step_ms": clock.ms,
    }
    if fault is not None:
        diags.update(faults.fault_diags(fault, num_parties, metric), fault_reconstruct=rebuilt)
    result = VFLResult(name, metric, ledger, clients, server, tuple(extractors), cfg, diags)
    return result, reps


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
    given. The split is moved to ``device`` first. ``diagnostics`` carries
    the k-means purity, the SSL sessions' last metrics and steps, and each
    step's time (``step_ms``); under a fault also ``faults.fault_diags``'s
    keys and ``fault_reconstruct``, each Eq. 10 reconstruction's inputs and
    output (⑤, then the evaluation)."""
    cfg = cfg if cfg is not None else ProtocolConfig()
    ledger = ledger if ledger is not None else CommLedger()
    dev = resolve_device(device)
    split = _to_device(split, dev)
    host, draws = _generators(seed, dev)
    clock = _StepClock(dev)
    return _one_shot_pass(
        split, extractors, ssl_cfgs, cfg, ledger, host, draws, clock, fault, seed
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
    trip (①'-⑥'). A party dropped by round 2 logs none of its events, gates
    nothing in and commits no ⑤' step; the server rebuilds its ⑥' upload by
    Eq. 10 over the ⑤ view.
    ``diagnostics`` adds to the one-shot pass's: its metric
    (``one_shot_metric``), step ③''s inputs and outputs (``fewshot_step3p``:
    H_u^k, the ⑤ uploads H_o^k, the Eq. 10 estimates of each party, p̂, and
    the joint f_c that gated them), the per-party gate and take rates, the
    ⑤' sessions' last metrics (appended to ``ssl_metrics``) and steps
    (``fewshot_ssl_steps``), and each round-2 step's time in ``step_ms``;
    under a fault, the fault diagnostics of the few-shot metric and every
    reconstruction of both rounds in ``fault_reconstruct``."""
    cfg = cfg if cfg is not None else ProtocolConfig()
    ledger = ledger if ledger is not None else CommLedger()
    dev = resolve_device(device)
    split = _to_device(split, dev)
    host, draws = _generators(seed, dev)
    clock = _StepClock(dev)
    return _few_shot_pass(split, extractors, ssl_cfgs, cfg, ledger, host, draws, clock, fault, seed)


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
    from repro_torch.core import baselines  # deferred: baselines imports this module

    if fault is not None:
        raise ValueError(
            "few_shot_finetune does not support fault injection: the chained finetune "
            "stage is the iterative round loop; model its dropout cost with "
            "baselines.run_vanilla(fault=...) instead"
        )
    cfg = cfg if cfg is not None else ProtocolConfig()
    dev = resolve_device(device)
    split = _to_device(split, dev)
    host, draws = _generators(seed, dev)
    few = _few_shot_pass(
        split, extractors, ssl_cfgs, cfg, CommLedger(), host, draws, _StepClock(dev)
    )
    it_cfg = baselines.IterativeConfig(
        iterations=finetune_iterations,
        batch_size=cfg.batch_size,
        client_lr=cfg.client_lr / 10,
        server_lr=cfg.server_lr / 10,
    )
    res = baselines.run_vanilla(
        seed_from(host),
        split,
        extractors,
        ssl_cfgs,
        it_cfg,
        clients=few.clients,
        server=few.server,
        ledger=few.ledger,
        device=dev,
    )
    step_ms = dict(few.diagnostics["step_ms"])
    step_ms.update({f"finetune_{k}": v for k, v in res.diagnostics["step_ms"].items()})
    res.diagnostics.update(few.diagnostics, fewshot_metric=few.metric, step_ms=step_ms)
    return res


def _few_shot_pass(
    split: VerticalSplit,
    extractors: Sequence[ExtractorSpec],
    ssl_cfgs: Sequence[SSLConfig],
    cfg: ProtocolConfig,
    ledger: CommLedger,
    host: torch.Generator,
    draws: torch.Generator,
    clock: _StepClock,
    fault: Optional[FaultSpec] = None,
    seed: int = 0,
) -> VFLResult:
    """Alg. 2 on a split already on its device, drawing from the caller's
    generators (see :func:`run_few_shot`)."""
    one, h_o = _one_shot_pass(
        split, extractors, ssl_cfgs, cfg, ledger, host, draws, clock, fault, seed
    )
    clients, server = one.clients, one.server
    diags = dict(one.diagnostics, one_shot_metric=one.metric)
    num_parties = len(clients)
    gone = _skips(fault, num_parties, POINT_ROUND2)  # absent from every round-2 event
    rebuilt = list(diags.get("fault_reconstruct", ()))

    # ①' unaligned reps go up in the ⑤ upload's round
    h_u = [c.extract(x).to(cfg.rep_dtype) for c, x in zip(clients, split.unaligned)]
    if fault is not None:
        h_u = _dp_all(h_u, fault, seed, faults.PHASE_UNALIGNED)
    r5 = max(e.round for e in ledger.events)
    for k, h in enumerate(h_u):
        if gone is None or not gone[k]:
            ledger.log_bytes(k, "up", "reps_unaligned", nbytes(h), round=r5)
    clock.lap("1p_unaligned")

    # ②' the server fits f_c^k on each H_o^k (f_c is ⑥'s)
    server.fit_aux_classifiers(
        [h.float() for h in h_o],
        split.labels,
        epochs=cfg.server_epochs,
        batch_size=cfg.batch_size,
        learning_rate=cfg.server_lr,
        generator=host,
    )
    clock.lap("2p_aux_fit")

    # ③' Eq. 10 estimates + Eq. 8-9 gate per party;  ④' p̂ goes down
    ests: List[List[torch.Tensor]] = [[] for _ in h_u]
    probs = [
        dispatch.fewshot_probs(server, k, h, h_o, cfg.fewshot_threshold, ests[k])
        for k, h in enumerate(h_u)
    ]
    _log_round(ledger, "down", "pseudo_label_probs", probs, gone)
    clock.lap("3p_estimate_gate")
    step3p = dict(h_u=h_u, h_o=h_o, estimates=ests, probs=probs, joint=server.classifier)

    # ⑤' each party adds its gated rows to the labeled set and re-runs SSL;
    # a party absent from round 2 gates nothing in and commits no step
    hp = cfg.ssl_hparams()
    tasks = []
    for c, x_o, x_u, p, y_o in zip(
        clients, split.aligned, split.unaligned, probs, diags["pseudo_labels"]
    ):
        absent, sv = False, None
        if fault is not None:
            absent = fault.skips_ssl(c.index) or gone[c.index]
            n_lab = x_o.shape[0] + x_u.shape[0]
            sv = faults.fault_step_valid(fault, c.index, n_lab, hp, skip_all=absent)
        tasks.append(
            fewshot_task(c, x_o, x_u, p, y_o, cfg, draws, split.aligned_mask, absent, sv)
        )
    ssl_metrics = [train_party_ssl(t, hp, seed_from(host), generator=draws) for t, _ in tasks]
    clock.lap("5p_local_ssl")

    # ⑥' final overlap reps go up (a party dropped by round 2 is rebuilt by
    # Eq. 10 over the ⑤ view); the server re-fits a fresh f_c on them
    reps = [c.extract(x).to(cfg.rep_dtype) for c, x in zip(clients, split.aligned)]
    if fault is not None:
        reps = _dp_all(reps, fault, seed, faults.PHASE_FINAL)
        reps = faults.reconstruct_dropped(reps, h_o, fault, POINT_ROUND2, rebuilt)
    _log_round(ledger, "up", "reps_overlap_final", reps, gone)
    server.train_classifier(
        [r.float() for r in reps],
        split.labels,
        epochs=cfg.server_epochs,
        batch_size=cfg.batch_size,
        learning_rate=cfg.server_lr,
        generator=host,
    )
    clock.lap("6p_server_refit")

    name, metric = _evaluate(server, clients, split, fault, reps, seed, rebuilt)
    clock.lap("eval_few_shot")
    if fault is not None:
        diags.update(faults.fault_diags(fault, num_parties, metric), fault_reconstruct=rebuilt)
    diags.update(
        fewshot_step3p=step3p,
        fewshot_gate_rate=[_rate(p > 0) for p in probs],
        fewshot_take_rate=[_rate(take) for _, take in tasks],
        ssl_metrics=diags["ssl_metrics"] + ssl_metrics,
        fewshot_ssl_steps=[schedule_steps(t.x_labeled.shape[0], hp) for t, _ in tasks],
    )
    return VFLResult(name, metric, ledger, clients, server, tuple(extractors), cfg, diags)


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
