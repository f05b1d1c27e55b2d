"""Baseline VFL methods of the paper's evaluation (§5.1) and their seed fold.

Counterpart of ``repro.core.baselines``:

* ``run_vanilla``: per-round SplitNN iterative VFL. Every iteration uploads
  minibatch representations and downloads their gradients (2 comm times a
  client an iteration). It is also the finetuning stage of "few-shot +
  finetune" (Tab. 1's last row, ``protocol.run_few_shot_finetune``).
* ``run_fedbcd``: FedBCD [20], Q local updates per communication round on
  the stale rep-gradients.
* ``run_fedcvt``: FedCVT-style [15] cross-view training: each party's
  unaligned batch joins with Eq. 10 estimates of the other parties' reps
  and confidence-gated pseudo-labels.

Each runs on ``device`` (``cuda`` unless the caller says ``"cpu"``). The
single-seed runners are the E = 1 case of ``run_vanilla_seeds`` /
``run_fedcvt_seeds`` / ``run_fedbcd_seeds``, the runner registry's
multi-seed entries: every entry (seeds and scenarios alike) draws from a
CPU generator seeded with its seed, in this order: its clients' init
(``protocol._build_clients``), its server classifier's, then its schedule
seed ``seed0``; then all entries' sessions run as one
``engine.batched.*_sessions_seeds`` call, one stacked session where
``iterative.stack_pays`` (four entries or more) or ``cfg.engine_mode`` asks
for it, else the per-entry loop. Every transfer
goes through the :class:`CommLedger` with the reference's tags and rounds:
a fault-free fold logs one prototype ledger (the orchestration copies it
per result), a faulted one each entry's own. ``cfg.mesh`` (None, a slot
count or a ``launch.mesh.BatchMesh``) shards the stacked session over its
slots (``engine.parallel``); the per-entry loop ignores it. Results record
``engine_path``, ``seed_fold`` and ``device_fold``: the mesh's slot count
where the stacked session ran, else 1.

A ``fault`` follows the reference's model of the synchronous round loop
(:func:`log_fault_plan`): a dropout stalls the loop at its stage's share
of the steps (the later steps compute their loss and commit nothing), the
server then spends ``retry_rounds`` rounds re-collecting the survivors'
batches and probing the dropped party, and the evaluation zero-imputes
the dropped party's test reps. The other fault kinds have no model here:
they run fault-free and say so (``fault_modeled: False``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint.artifact import ExtractorSpec
from repro_torch.core import protocol
from repro_torch.core.client import VFLClient
from repro_torch.core.comm import CommLedger
from repro_torch.core.protocol import VFLResult
from repro_torch.core.server import VFLServer
from repro_torch.core.ssl import SSLConfig
from repro_torch.data.loader import epoch_batches
from repro_torch.data.vertical import VerticalSplit
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.engine import batched, iterative, parallel
from repro_torch.engine.local_ssl import seed_from
from repro_torch.launch.mesh import BatchMesh
from repro_torch.scenarios.faults import FaultSpec


@dataclass(frozen=True)
class IterativeConfig:
    iterations: int = 2000
    batch_size: int = 32
    client_lr: float = 0.01
    server_lr: float = 0.01
    momentum: float = 0.9
    fedbcd_q: int = 5  # Q (paper: 5)
    fedcvt_threshold: float = 0.95
    engine_mode: str = "auto"  # "auto" | "vmap" | "python": the sessions' path
    mesh: object = None  # None | slot count | BatchMesh: the stacked session's slots

    def iter_hparams(self) -> iterative.IterHParams:
        return iterative.IterHParams(
            client_lr=self.client_lr,
            server_lr=self.server_lr,
            momentum=self.momentum,
            fedcvt_threshold=self.fedcvt_threshold,
        )


def log_iterative_rounds(
    ledger: CommLedger,
    rep_dims: Sequence[int],
    iterations: int,
    bs: int,
    payload_factor: int = 1,
) -> None:
    """Per-iteration accounting: party k's (bs, rep_dims[k]) float32 reps up
    and their gradients down, in two rounds (× ``payload_factor`` when a
    method ships extra batches, e.g. FedCVT's unaligned reps)."""
    for _ in range(iterations):
        r_up, r_dn = ledger.next_round(), ledger.next_round()
        for k, rep_dim in enumerate(rep_dims):
            num = payload_factor * bs * rep_dim * 4
            ledger.log_bytes(k, "up", "reps_batch", num, round=r_up)
            ledger.log_bytes(k, "down", "grads_batch", num, round=r_dn)


def log_fault_plan(
    ledger: CommLedger,
    fault: Optional[FaultSpec],
    rep_dims: Sequence[int],
    n_steps: int,
    bs: int,
    payload_factor: int = 1,
) -> tuple:
    """The ledger and commit horizon of an ``n_steps`` session under
    ``fault``: without a dropout, :func:`log_iterative_rounds` over every
    step; with one, over the steps before the stall, then per retry round
    every survivor's batch up again (``retry_reps``) and a 4-byte
    ``retry_timeout`` down to the dropped party. Returns (the number of
    steps that commit, None for all; the fault diagnostics)."""
    num_parties = len(rep_dims)
    if fault is None or fault.kind != "dropout":
        log_iterative_rounds(ledger, rep_dims, n_steps, bs, payload_factor)
        if fault is None:
            return None, {}
        return None, {"fault_kind": fault.kind, "parties_survived": num_parties,
                      "fault_modeled": False}
    t_drop = fault.iterative_active_steps(n_steps)
    log_iterative_rounds(ledger, rep_dims, t_drop, bs, payload_factor)
    retry_bytes = 0
    for _ in range(fault.retry_rounds):
        r_up, r_dn = ledger.next_round(), ledger.next_round()
        for k, rep_dim in enumerate(rep_dims):
            if k == fault.party:
                continue
            num = payload_factor * bs * rep_dim * 4
            ledger.log_bytes(k, "up", "retry_reps", num, round=r_up)
            retry_bytes += num
        ledger.log_bytes(fault.party, "down", "retry_timeout", 4, round=r_dn)
        retry_bytes += 4
    return t_drop, {
        "fault_kind": fault.kind,
        "fault_stage": fault.stage,
        "parties_survived": fault.parties_survived(num_parties),
        "fault_modeled": True,
        "fault_retry_rounds": fault.retry_rounds,
        "fault_retry_bytes": retry_bytes,
    }


def fedbcd_schedule(seed0: int, n: int, batch_size: int, rounds: int) -> np.ndarray:
    """(rounds, bs) int64 minibatch indices of FedBCD, the reference's: each
    shuffled epoch is seeded ``seed0 + rows_done`` at its entry (not
    ``seed0 + epoch``), drop-remainder, cut to ``rounds`` rows."""
    bs = min(batch_size, n)
    if rounds <= 0:
        return np.zeros((0, bs), np.int64)
    rows: List[np.ndarray] = []
    while len(rows) < rounds:
        for b in epoch_batches(n, bs, seed0 + len(rows)):
            rows.append(b)
            if len(rows) == rounds:
                break
    return np.stack(rows).astype(np.int64)


@dataclass
class _Session:
    split: VerticalSplit
    clients: List[VFLClient]
    server: VFLServer
    seed0: int
    bs: int

    @property
    def extractors(self) -> list:
        return [c.extractor for c in self.clients]


def _setup(
    seed: int,
    split: VerticalSplit,
    extractors: Sequence[ExtractorSpec],
    ssl_cfgs: Sequence[SSLConfig],
    cfg: IterativeConfig,
    clients: Optional[List[VFLClient]],
    server: Optional[VFLServer],
    dev: torch.device,
) -> _Session:
    """One entry: the split on ``dev``, the clients (built unless given),
    the server with a classifier over Σ rep_dim (fresh unless given fitted)
    and ``seed0``, drawn in that order from the CPU generator of ``seed``."""
    split = protocol._to_device(split, dev)
    host = torch.Generator().manual_seed(seed)
    if clients is None:
        clients = protocol._build_clients(split, extractors, ssl_cfgs, host, dev)
    if server is None or server.classifier is None:
        server = VFLServer(num_classes=split.num_classes)
        server.classifier = server._fresh_classifier(sum(e.rep_dim for e in extractors), host, dev)
    seed0 = seed_from(host)
    bs = min(cfg.batch_size, split.labels.shape[0])
    return _Session(split, clients, server, seed0, bs)


@dataclass
class _SeedFold:
    """The entries of one fold, their specs and faults, the step clock, the
    resolved mesh (None: unsharded), and what the fault plan gives: each
    entry's ledger (one shared prototype when no entry is faulted), commit
    horizon and fault diagnostics."""

    entries: List[_Session]
    specs: Sequence[Sequence[ExtractorSpec]]
    faults: Optional[Sequence[Optional[FaultSpec]]]
    clock: "protocol._StepClock"
    mesh: Optional[BatchMesh] = None
    ledgers: List[CommLedger] = field(default_factory=list)
    active: Optional[List[Optional[int]]] = None
    diags: List[dict] = field(default_factory=list)


def _seed_fold(
    seeds, splits, extractors, ssl_cfgs, cfg, device, faults=None, clients_per_seed=None, servers=None
) -> _SeedFold:
    """Every entry's :func:`_setup`, each from its own seed's generator.
    ``cfg.mesh`` resolves here, on ``device``'s type; a mesh of the other
    type is refused."""
    num = len(seeds)
    if not (len(splits) == len(extractors) == len(ssl_cfgs) == num):
        raise ValueError("a fold needs one split, extractor list and SSL-config list per seed")
    for given, what in ((faults, "faults"), (clients_per_seed, "clients_per_seed"), (servers, "servers")):
        if given is not None and len(given) != num:
            raise ValueError(f"{what} needs one entry per stacked entry")
    if faults is not None and not any(f is not None for f in faults):
        faults = None
    dev = resolve_device(device)
    mesh = parallel.fold_mesh(cfg.mesh, dev)
    clock = protocol._StepClock(dev)
    entries = [
        _setup(
            seed, splits[e], extractors[e], ssl_cfgs[e], cfg,
            None if clients_per_seed is None else clients_per_seed[e],
            None if servers is None else servers[e], dev,
        )
        for e, seed in enumerate(seeds)
    ]
    clock.lap("setup")
    return _SeedFold(entries, [list(e) for e in extractors], faults, clock, mesh)


def _plan(fold: _SeedFold, ledger: Optional[CommLedger], n_steps: int, payload_factor: int = 1) -> None:
    """The fold's ledgers and commit horizons (:func:`log_fault_plan`, the
    reference's ``_iterative_fault_plan``). Without a fault the fold logs one
    prototype ledger (``ledger`` if given), after checking every entry moves
    the same bytes; with one, each entry logs its own plan on its own
    ledger (``ledger`` only for a single entry)."""
    num = len(fold.entries)
    plans = {(tuple(e.rep_dim for e in specs), s.bs) for specs, s in zip(fold.specs, fold.entries)}
    if fold.faults is None:
        if len(plans) != 1:
            raise ValueError(f"a fold broke ledger byte-identity: per-entry (rep dims, bs) {sorted(plans)}")
        ledger = ledger if ledger is not None else CommLedger()
        rep_dims, bs = plans.pop()
        log_iterative_rounds(ledger, rep_dims, n_steps, bs, payload_factor)
        fold.ledgers, fold.diags = [ledger] * num, [{} for _ in range(num)]
        return
    if ledger is not None and num != 1:
        raise ValueError("a ledger can be given to a faulted single-entry run only")
    active = []
    for specs, s, fault in zip(fold.specs, fold.entries, fold.faults):
        own = ledger if ledger is not None else CommLedger()
        horizon, diags = log_fault_plan(own, fault, [e.rep_dim for e in specs], n_steps, s.bs, payload_factor)
        fold.ledgers.append(own)
        fold.diags.append(diags)
        active.append(horizon)
    fold.active = active if any(a is not None for a in active) else None


def _finish(fold: _SeedFold, losses: torch.Tensor, path: str, extra: dict) -> List[VFLResult]:
    """Score every entry's trained state on its held-out split and pack the
    results. ``diagnostics`` gets the entry's losses, the last one, the
    fold's stage times (``step_ms``: setup, session, eval), the path
    (``engine_path``), ``seed_fold`` (the entries), ``device_fold`` (the
    mesh's slot count on the stacked path, 1 on the loop) and ``extra``.
    Under a dropout the dropped party's test reps are zeros; under any
    fault the metric is also ``degraded_metric``."""
    fold.clock.lap("session")
    faults = fold.faults if fold.faults is not None else [None] * len(fold.entries)
    scores = []
    for s, fault in zip(fold.entries, faults):
        dropout = fault if fault is not None and fault.kind == "dropout" else None
        scores.append(protocol._evaluate(s.server, s.clients, s.split, dropout))
    fold.clock.lap("eval")
    host = losses.cpu()
    results = []
    for e, (s, fault, (name, metric)) in enumerate(zip(fold.entries, faults, scores)):
        diags = dict(fold.diags[e], **extra)
        if fault is not None:
            diags["degraded_metric"] = float(metric)
        diags.update(
            losses=host[e],
            final_loss=float(host[e, -1]) if host.shape[1] else None,
            step_ms=dict(fold.clock.ms),
            engine_path=path,
            seed_fold=len(fold.entries),
            device_fold=parallel.device_fold(fold.mesh) if path == "vmap" else 1,
        )
        results.append(
            VFLResult(name, metric, fold.ledgers[e], s.clients, s.server, tuple(fold.specs[e]), None, diags)
        )
    return results


def _data(fold: _SeedFold) -> tuple:
    """Every entry's modules, aligned rows and labels, the fold's arguments."""
    es = fold.entries
    return (
        [s.extractors for s in es],
        [s.server.classifier for s in es],
        [s.split.aligned for s in es],
        [s.split.labels for s in es],
    )


def run_vanilla_seeds(
    seeds: Sequence[int],
    splits: Sequence[VerticalSplit],
    extractors: Sequence[Sequence[ExtractorSpec]],
    ssl_cfgs: Sequence[Sequence[SSLConfig]],
    cfg: Optional[IterativeConfig] = None,
    clients_per_seed: Optional[Sequence[Optional[List[VFLClient]]]] = None,
    servers: Optional[Sequence[Optional[VFLServer]]] = None,
    ledger: Optional[CommLedger] = None,
    device: DeviceLike = None,
    faults: Optional[Sequence[Optional[FaultSpec]]] = None,
) -> List[VFLResult]:
    """Vanilla SplitNN VFL over E entries as one fold: each entry's
    ``cfg.iterations`` joint steps over shuffled epochs of its aligned rows,
    under its fault if given (:func:`log_fault_plan`), all entries' sessions
    one ``batched.splitnn_sessions_seeds`` call. ``clients_per_seed`` /
    ``servers`` / ``ledger`` take pre-trained state and a ledger to continue
    (the chained finetune of ``protocol.run_few_shot_finetune``)."""
    cfg = cfg if cfg is not None else IterativeConfig()
    fold = _seed_fold(seeds, splits, extractors, ssl_cfgs, cfg, device, faults, clients_per_seed, servers)
    schedules = [
        iterative.build_iteration_schedule(s.seed0, s.split.labels.shape[0], cfg.batch_size, cfg.iterations)
        for s in fold.entries
    ]
    _plan(fold, ledger, cfg.iterations)
    exts, clfs, xs, ys = _data(fold)
    losses, path = batched.splitnn_sessions_seeds(
        exts, clfs, cfg.iter_hparams(), xs, ys, schedules, cfg.engine_mode, fold.active, fold.mesh
    )
    return _finish(fold, losses, path, {"iterations": cfg.iterations})


def run_vanilla(
    seed: int,
    split: VerticalSplit,
    extractors: Sequence[ExtractorSpec],
    ssl_cfgs: Sequence[SSLConfig],
    cfg: Optional[IterativeConfig] = None,
    clients: Optional[List[VFLClient]] = None,
    server: Optional[VFLServer] = None,
    ledger: Optional[CommLedger] = None,
    device: DeviceLike = None,
    fault: Optional[FaultSpec] = None,
) -> VFLResult:
    """Vanilla SplitNN VFL: ``cfg.iterations`` joint steps over shuffled
    epochs of the aligned rows, under ``fault`` if given. The E = 1 case of
    :func:`run_vanilla_seeds`."""
    return run_vanilla_seeds(
        [seed], [split], [extractors], [ssl_cfgs], cfg, [clients], [server], ledger, device,
        None if fault is None else [fault],
    )[0]


def run_fedbcd_seeds(
    seeds: Sequence[int],
    splits: Sequence[VerticalSplit],
    extractors: Sequence[Sequence[ExtractorSpec]],
    ssl_cfgs: Sequence[Sequence[SSLConfig]],
    cfg: Optional[IterativeConfig] = None,
    device: DeviceLike = None,
    faults: Optional[Sequence[Optional[FaultSpec]]] = None,
) -> List[VFLResult]:
    """FedBCD-p over E entries as one fold: ``cfg.iterations // cfg.fedbcd_q``
    rounds, each one rep exchange then Q local updates on both sides. A
    dropout's stall counts rounds, not local updates."""
    cfg = cfg if cfg is not None else IterativeConfig()
    rounds = cfg.iterations // cfg.fedbcd_q
    fold = _seed_fold(seeds, splits, extractors, ssl_cfgs, cfg, device, faults)
    schedules = [
        fedbcd_schedule(s.seed0, s.split.labels.shape[0], cfg.batch_size, rounds) for s in fold.entries
    ]
    _plan(fold, None, rounds)
    exts, clfs, xs, ys = _data(fold)
    losses, path = batched.fedbcd_sessions_seeds(
        exts, clfs, cfg.iter_hparams(), cfg.fedbcd_q, xs, ys, schedules, cfg.engine_mode, fold.active,
        fold.mesh,
    )
    return _finish(fold, losses, path, {"rounds": rounds, "Q": cfg.fedbcd_q})


def run_fedbcd(
    seed: int,
    split: VerticalSplit,
    extractors: Sequence[ExtractorSpec],
    ssl_cfgs: Sequence[SSLConfig],
    cfg: Optional[IterativeConfig] = None,
    device: DeviceLike = None,
    fault: Optional[FaultSpec] = None,
) -> VFLResult:
    """FedBCD-p at one seed: the E = 1 case of :func:`run_fedbcd_seeds`."""
    return run_fedbcd_seeds(
        [seed], [split], [extractors], [ssl_cfgs], cfg, device, None if fault is None else [fault]
    )[0]


def run_fedcvt_seeds(
    seeds: Sequence[int],
    splits: Sequence[VerticalSplit],
    extractors: Sequence[Sequence[ExtractorSpec]],
    ssl_cfgs: Sequence[Sequence[SSLConfig]],
    cfg: Optional[IterativeConfig] = None,
    device: DeviceLike = None,
    faults: Optional[Sequence[Optional[FaultSpec]]] = None,
) -> List[VFLResult]:
    """FedCVT-style semi-supervised baseline over E entries as one fold:
    vanilla iterations plus, per iteration, each party's unaligned batch
    with Eq. 10-estimated missing reps and pseudo-labels above
    ``cfg.fedcvt_threshold``. Overlap and unaligned reps go up and both
    gradients come down: 2× vanilla's bytes, retry rounds included."""
    cfg = cfg if cfg is not None else IterativeConfig()
    fold = _seed_fold(seeds, splits, extractors, ssl_cfgs, cfg, device, faults)
    schedules = [
        iterative.build_iteration_schedule(s.seed0, s.split.labels.shape[0], cfg.batch_size, cfg.iterations)
        for s in fold.entries
    ]
    # seeded literally 0, as the reference seeds them: only pool sizes and bs enter
    u_schedules = [
        iterative.build_unaligned_schedule(0, [x.shape[0] for x in s.split.unaligned], s.bs, cfg.iterations)
        for s in fold.entries
    ]
    _plan(fold, None, cfg.iterations, payload_factor=2)
    exts, clfs, xs, ys = _data(fold)
    losses, path = batched.fedcvt_sessions_seeds(
        exts, clfs, cfg.iter_hparams(), xs, ys, schedules,
        [s.split.unaligned for s in fold.entries], u_schedules, cfg.engine_mode, fold.active,
        fold.mesh,
    )
    return _finish(fold, losses, path, {"iterations": cfg.iterations})


def run_fedcvt(
    seed: int,
    split: VerticalSplit,
    extractors: Sequence[ExtractorSpec],
    ssl_cfgs: Sequence[SSLConfig],
    cfg: Optional[IterativeConfig] = None,
    device: DeviceLike = None,
    fault: Optional[FaultSpec] = None,
) -> VFLResult:
    """FedCVT-style baseline at one seed: the E = 1 case of
    :func:`run_fedcvt_seeds`."""
    return run_fedcvt_seeds(
        [seed], [split], [extractors], [ssl_cfgs], cfg, device, None if fault is None else [fault]
    )[0]
