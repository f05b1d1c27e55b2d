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
reference's tags and rounds. The reference's seed folds and fault plans
have no counterpart yet.
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
) -> VFLResult:
    """Score the trained state on the held-out split and pack the result;
    ``diagnostics`` gets the session's losses, the last one and each
    stage's time (``step_ms``: setup, session, eval)."""
    s.clock.lap("session")
    name, metric = protocol._evaluate(s.server, s.clients, s.split)
    s.clock.lap("eval")
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
) -> VFLResult:
    """Vanilla SplitNN VFL: ``cfg.iterations`` joint steps over shuffled
    epochs of the aligned rows. ``clients`` / ``server`` / ``ledger`` take
    pre-trained state and a ledger to continue (the finetune of
    ``protocol.run_few_shot_finetune``)."""
    cfg = cfg if cfg is not None else IterativeConfig()
    ledger = ledger if ledger is not None else CommLedger()
    s = _setup(seed, split, extractors, ssl_cfgs, cfg, clients, server, device)
    sched = iterative.build_iteration_schedule(
        s.seed0, s.split.labels.shape[0], cfg.batch_size, cfg.iterations
    )
    step = iterative.make_splitnn_step_fn(s.extractors, s.server.classifier, cfg.iter_hparams())
    losses = iterative.run_iterative_session(step, s.split.aligned, s.split.labels, sched)
    log_iterative_rounds(ledger, [e.rep_dim for e in extractors], cfg.iterations, s.bs)
    return _finish(s, extractors, ledger, losses, {"iterations": cfg.iterations})


def run_fedbcd(
    seed: int,
    split: VerticalSplit,
    extractors: Sequence[ExtractorSpec],
    ssl_cfgs: Sequence[SSLConfig],
    cfg: Optional[IterativeConfig] = None,
    device: DeviceLike = None,
) -> VFLResult:
    """FedBCD-p: ``cfg.iterations // cfg.fedbcd_q`` rounds, each one rep
    exchange then Q local updates on both sides."""
    cfg = cfg if cfg is not None else IterativeConfig()
    ledger = CommLedger()
    rounds = cfg.iterations // cfg.fedbcd_q
    s = _setup(seed, split, extractors, ssl_cfgs, cfg, None, None, device)
    sched = fedbcd_schedule(s.seed0, s.split.labels.shape[0], cfg.batch_size, rounds)
    step = iterative.make_fedbcd_step_fn(
        s.extractors, s.server.classifier, cfg.iter_hparams(), cfg.fedbcd_q
    )
    losses = iterative.run_iterative_session(step, s.split.aligned, s.split.labels, sched)
    log_iterative_rounds(ledger, [e.rep_dim for e in extractors], rounds, s.bs)
    return _finish(s, extractors, ledger, losses, {"rounds": rounds, "Q": cfg.fedbcd_q})


def run_fedcvt(
    seed: int,
    split: VerticalSplit,
    extractors: Sequence[ExtractorSpec],
    ssl_cfgs: Sequence[SSLConfig],
    cfg: Optional[IterativeConfig] = None,
    device: DeviceLike = None,
) -> VFLResult:
    """FedCVT-style semi-supervised baseline: vanilla iterations plus, per
    iteration, each party's unaligned batch with Eq. 10-estimated missing
    reps and pseudo-labels above ``cfg.fedcvt_threshold``. Overlap and
    unaligned reps go up and both gradients come down: 2× vanilla's bytes."""
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
    step = iterative.make_fedcvt_step_fn(s.extractors, s.server.classifier, cfg.iter_hparams())
    losses = iterative.run_iterative_session(
        step, s.split.aligned, s.split.labels, sched, s.split.unaligned, u_scheds
    )
    log_iterative_rounds(
        ledger, [e.rep_dim for e in extractors], cfg.iterations, s.bs, payload_factor=2
    )
    return _finish(s, extractors, ledger, losses, {"iterations": cfg.iterations})
