"""Baseline VFL methods of the paper's evaluation (§5.1), at one seed.

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

Each runs on ``device`` (``cuda`` unless the caller says ``"cpu"``) through
``engine.iterative``'s Python loop. Randomness comes from one CPU generator
seeded with ``seed``, in this order: the clients' init
(``protocol._build_clients``), the server classifier's, then the schedule
seed ``seed0``. Every transfer goes through the :class:`CommLedger` with the
reference's tags and rounds. The reference's seed folds have no
counterpart.

A ``fault`` follows the reference's model of the synchronous round loop
(:func:`log_fault_plan`): a dropout stalls the loop at its stage's share
of the steps (the later steps compute their loss and commit nothing), the
server then spends ``retry_rounds`` rounds re-collecting the survivors'
batches and probing the dropped party, and the evaluation zero-imputes
the dropped party's test reps. The other fault kinds have no model here:
they run fault-free and say so (``fault_modeled: False``).
"""

from __future__ import annotations

from dataclasses import dataclass
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
from repro_torch.engine import iterative
from repro_torch.engine.local_ssl import seed_from
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
    clock: "protocol._StepClock"
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
    device: DeviceLike,
) -> _Session:
    """The split on its device, the clients (built unless given), the
    server with a classifier over Σ rep_dim (fresh unless given fitted) and
    ``seed0``, drawn in that order from the CPU generator of ``seed``."""
    dev = resolve_device(device)
    clock = protocol._StepClock(dev)
    split = protocol._to_device(split, dev)
    host = torch.Generator().manual_seed(seed)
    if clients is None:
        clients = protocol._build_clients(split, extractors, ssl_cfgs, host, dev)
    if server is None or server.classifier is None:
        server = VFLServer(num_classes=split.num_classes)
        server.classifier = server._fresh_classifier(sum(e.rep_dim for e in extractors), host, dev)
    seed0 = seed_from(host)
    clock.lap("setup")
    bs = min(cfg.batch_size, split.labels.shape[0])
    return _Session(split, clients, server, seed0, clock, bs)


def _finish(
    s: _Session,
    extractors: Sequence[ExtractorSpec],
    ledger: CommLedger,
    losses: torch.Tensor,
    diags: dict,
    fault: Optional[FaultSpec] = None,
) -> VFLResult:
    """Score the trained state on the held-out split and pack the result;
    ``diagnostics`` gets the session's losses, the last one and each
    stage's time (``step_ms``: setup, session, eval). Under a dropout the
    dropped party's test reps are zeros; under any fault the metric is
    also ``degraded_metric``."""
    s.clock.lap("session")
    dropout = fault if fault is not None and fault.kind == "dropout" else None
    name, metric = protocol._evaluate(s.server, s.clients, s.split, dropout)
    s.clock.lap("eval")
    if fault is not None:
        diags["degraded_metric"] = float(metric)
    losses = losses.cpu()
    diags.update(
        losses=losses,
        final_loss=float(losses[-1]) if losses.numel() else None,
        step_ms=s.clock.ms,
    )
    return VFLResult(name, metric, ledger, s.clients, s.server, tuple(extractors), None, diags)


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
    epochs of the aligned rows, under ``fault`` if given
    (:func:`log_fault_plan`). ``clients`` / ``server`` / ``ledger`` take
    pre-trained state and a ledger to continue (the finetune of
    ``protocol.run_few_shot_finetune``)."""
    cfg = cfg if cfg is not None else IterativeConfig()
    ledger = ledger if ledger is not None else CommLedger()
    s = _setup(seed, split, extractors, ssl_cfgs, cfg, clients, server, device)
    sched = iterative.build_iteration_schedule(
        s.seed0, s.split.labels.shape[0], cfg.batch_size, cfg.iterations
    )
    active, diags = log_fault_plan(
        ledger, fault, [e.rep_dim for e in extractors], cfg.iterations, s.bs
    )
    step = iterative.make_splitnn_step_fn(s.extractors, s.server.classifier, cfg.iter_hparams())
    losses = iterative.run_iterative_session(
        step, s.split.aligned, s.split.labels, sched, active_steps=active
    )
    diags["iterations"] = cfg.iterations
    return _finish(s, extractors, ledger, losses, diags, fault)


def run_fedbcd(
    seed: int,
    split: VerticalSplit,
    extractors: Sequence[ExtractorSpec],
    ssl_cfgs: Sequence[SSLConfig],
    cfg: Optional[IterativeConfig] = None,
    device: DeviceLike = None,
    fault: Optional[FaultSpec] = None,
) -> VFLResult:
    """FedBCD-p: ``cfg.iterations // cfg.fedbcd_q`` rounds, each one rep
    exchange then Q local updates on both sides. A dropout's stall counts
    rounds, not local updates."""
    cfg = cfg if cfg is not None else IterativeConfig()
    ledger = CommLedger()
    rounds = cfg.iterations // cfg.fedbcd_q
    s = _setup(seed, split, extractors, ssl_cfgs, cfg, None, None, device)
    sched = fedbcd_schedule(s.seed0, s.split.labels.shape[0], cfg.batch_size, rounds)
    active, diags = log_fault_plan(ledger, fault, [e.rep_dim for e in extractors], rounds, s.bs)
    step = iterative.make_fedbcd_step_fn(
        s.extractors, s.server.classifier, cfg.iter_hparams(), cfg.fedbcd_q
    )
    losses = iterative.run_iterative_session(
        step, s.split.aligned, s.split.labels, sched, active_steps=active
    )
    diags.update(rounds=rounds, Q=cfg.fedbcd_q)
    return _finish(s, extractors, ledger, losses, diags, fault)


def run_fedcvt(
    seed: int,
    split: VerticalSplit,
    extractors: Sequence[ExtractorSpec],
    ssl_cfgs: Sequence[SSLConfig],
    cfg: Optional[IterativeConfig] = None,
    device: DeviceLike = None,
    fault: Optional[FaultSpec] = None,
) -> VFLResult:
    """FedCVT-style semi-supervised baseline: vanilla iterations plus, per
    iteration, each party's unaligned batch with Eq. 10-estimated missing
    reps and pseudo-labels above ``cfg.fedcvt_threshold``. Overlap and
    unaligned reps go up and both gradients come down: 2× vanilla's bytes,
    retry rounds included."""
    cfg = cfg if cfg is not None else IterativeConfig()
    ledger = CommLedger()
    s = _setup(seed, split, extractors, ssl_cfgs, cfg, None, None, device)
    sched = iterative.build_iteration_schedule(
        s.seed0, s.split.labels.shape[0], cfg.batch_size, cfg.iterations
    )
    # seeded literally 0, as the reference seeds them: only pool sizes and bs enter
    u_scheds = iterative.build_unaligned_schedule(
        0, [x.shape[0] for x in s.split.unaligned], s.bs, cfg.iterations
    )
    active, diags = log_fault_plan(
        ledger, fault, [e.rep_dim for e in extractors], cfg.iterations, s.bs, payload_factor=2
    )
    step = iterative.make_fedcvt_step_fn(s.extractors, s.server.classifier, cfg.iter_hparams())
    losses = iterative.run_iterative_session(
        step, s.split.aligned, s.split.labels, sched, s.split.unaligned, u_scheds, active
    )
    diags["iterations"] = cfg.iterations
    return _finish(s, extractors, ledger, losses, diags, fault)
