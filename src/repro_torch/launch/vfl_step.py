"""The paper's protocol as collectives between party processes.

    PYTHONPATH=src python -m repro_torch.launch.vfl_step --device cpu
    PYTHONPATH=src python -m repro_torch.launch.vfl_step --parties 4 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.vfl_step   # every party on the GPU

Counterpart of ``repro.launch.vfl_step``. Each party is one process of a
``torch.distributed`` group (gloo, on the CPU and on the card alike); its
features and extractor never leave it, and the labels and the server head
are replicated, as the reference replicates them over its pod axis. The
only tensors that cross processes are the ones the protocol exchanges:

  vanilla VFL   one iteration all-gathers the minibatch representations
                and returns their gradients by the gather's transpose, a
                reduce-scatter: two collectives a step;
  one-shot VFL  the whole session makes exactly three: representations
                up (all-gather), partial gradients down (all-reduce), and
                the refreshed representations up (all-gather). Step ③'s
                k-means (``core.clustering``, the ``kmeans`` kernel on the
                card) and every local SSL step (the engine's
                ``make_ssl_step_fn``) run inside the party.

:class:`count_party_collectives` counts the collectives that ran, as
``count_pod_collectives`` counts them in the reference's compiled text.
:func:`run_parties` runs a function in K spawned processes joined by a
gloo group; :func:`run_party_jobs` is the function the tests, the smoke
script and :func:`main` run there.

Two behaviours mirror the reference on purpose (ROADMAP.md): at ② every
party receives the mean of all parties' gradient slices, and the vanilla
update is K times the joint loss's gradient, since every party computes
the same loss and the gather's transpose sums the K cotangents.
"""

from __future__ import annotations

import argparse
import datetime
import multiprocessing.connection
import os
import tempfile
import time
import traceback
import warnings
from dataclasses import dataclass, fields, is_dataclass
from pathlib import Path
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import bridge
from repro_torch.core import clustering
from repro_torch.core.ssl import SSLConfig, SSLDraws, cross_entropy, draw_ssl
from repro_torch.device import resolve_device
from repro_torch.engine import PartyParams, make_ssl_optimizer, make_ssl_step_fn
from repro_torch.engine.local_ssl import SSLHParams
from repro_torch.kernels.kmeans import ops as kmeans_ops
from repro_torch.models.extractors import Dense, make_classifier, make_mlp_extractor

# Seconds a party group may take from spawn to its last rank's exit, and
# each collective's own limit: a hung rank fails the call in about this.
PARTY_TIMEOUT_S = 60.0


def _make_extractor(feat_dim: int, hidden: int, rep_dim: int) -> Dense:
    return make_mlp_extractor(feat_dim, rep_dim, (hidden,))


def extractor_shapes(feat_dim: int, hidden: int, rep_dim: int, parties: int) -> Dict[str, torch.Tensor]:
    """The per-party extractor parameters under the reference's keys, with
    the leading party dimension, as float32 ``meta`` tensors (shapes and
    types, no data)."""
    shapes = {
        "w0": (parties, feat_dim, hidden),
        "b0": (parties, hidden),
        "w1": (parties, hidden, rep_dim),
        "b1": (parties, rep_dim),
    }
    return {k: torch.empty(s, dtype=torch.float32, device="meta") for k, s in shapes.items()}


def _check(extractor: nn.Module, w_head: torch.Tensor, group, dims: tuple) -> None:
    """``extractor`` is the MLP of ``dims`` = (feat_dim, hidden, rep_dim,
    num_classes) and ``w_head`` the (K·rep_dim, num_classes) server head."""
    feat_dim, hidden, rep_dim, num_classes = dims
    want = [(feat_dim, hidden), (hidden, rep_dim)]
    got = [(lin.in_features, lin.out_features) for lin in getattr(extractor, "layers", [])]
    if not isinstance(extractor, Dense) or got != want:
        raise ValueError(f"the extractor is not an MLP of layers {want}")
    if tuple(w_head.shape) != (_parties(group) * rep_dim, num_classes):
        raise ValueError(f"w_head {tuple(w_head.shape)} does not fit K·rep_dim × num_classes")


# ------------------------------------------------------------- collectives
def _parties(group) -> int:
    return dist.get_world_size(group)


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Every party's ``t`` (b, …), concatenated party-major: (K·b, …)."""
    out = t.new_empty((_parties(group) * t.shape[0], *t.shape[1:]))
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out


class _GatherReps(torch.autograd.Function):
    """:func:`all_gather_rows` whose backward is its transpose: a SUM
    reduce-scatter of the (K·b, …) cotangent back to each party's rows."""

    @staticmethod
    def forward(ctx, rep: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return all_gather_rows(rep, group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        out = grad.new_empty((grad.shape[0] // _parties(ctx.group), *grad.shape[1:]))
        dist.reduce_scatter_tensor(out, grad.contiguous(), op=dist.ReduceOp.SUM, group=ctx.group)
        return out, None


def _joint(reps: torch.Tensor, rows: int) -> torch.Tensor:
    """(K·b, r) gathered representations → the party-major joint (b, K·r)."""
    return reps.view(-1, rows, reps.shape[-1]).transpose(0, 1).reshape(rows, -1)


def _server_loss(joint: torch.Tensor, y: torch.Tensor, w_head: torch.Tensor) -> torch.Tensor:
    return cross_entropy(joint @ w_head, y).mean()


class Collective(NamedTuple):
    """One collective that ran: its kind, its result's shape, type and
    bytes, the bytes this process put in (``payload``), and its group's
    size."""

    kind: str
    shape: tuple
    dtype: str
    bytes: int
    payload: int
    parties: int


# the c10d ops this module runs, under the reference's names (any other op
# keeps its own name)
_KINDS = {
    "_allgather_base_": "all_gather",
    "allreduce_": "all_reduce",
    "_reduce_scatter_base_": "reduce_scatter",
}


def _tensors(x: Any) -> List[torch.Tensor]:
    if torch.is_tensor(x):
        return [x]
    return [t for item in x for t in _tensors(item)]


class count_party_collectives(TorchDispatchMode):
    """Records every ``c10d`` op that runs inside it, on any thread its
    autograd engine runs (the backward's reduce-scatter included).

    Counterpart of the reference's ``count_pod_collectives``, which reads
    a compiled program: this sees the ops as they are dispatched, so it
    counts what ran, not what the code says it sends. :meth:`counts` gives
    the reference's keys; a collective over more than one party crosses
    parties."""

    def __init__(self) -> None:
        super().__init__()
        self.ops: List[Collective] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "c10d":
            self.ops.append(_collective(func, args, kwargs or {}))
        return out

    def kinds(self) -> List[str]:
        return [op.kind for op in self.ops]

    def counts(self) -> Dict[str, int]:
        crossing = [op for op in self.ops if op.parties > 1]
        return {
            "pod_crossing": len(crossing),
            "pod_internal": len(self.ops) - len(crossing),
            "pod_crossing_bytes": sum(op.bytes for op in crossing),
        }


def _collective(func, args: tuple, kwargs: dict) -> Collective:
    names = [a.name for a in func._schema.arguments]
    bound = dict(zip(names, args), **kwargs)
    result = _tensors(bound.get("output_tensor", bound.get("output_tensors", bound.get("tensors"))))
    given = _tensors(bound.get("input_tensor", bound.get("input_tensors", bound.get("tensors"))))
    group = dist.ProcessGroup.unbox(bound["process_group"])
    name = func.overloadpacket.__name__
    return Collective(
        kind=_KINDS.get(name, name),
        shape=tuple(result[0].shape) if len(result) == 1 else tuple(tuple(t.shape) for t in result),
        dtype=str(result[0].dtype).removeprefix("torch."),
        bytes=sum(t.numel() * t.element_size() for t in result),
        payload=sum(t.numel() * t.element_size() for t in given),
        parties=group.size(),
    )


# --------------------------------------------------------------- the steps
def make_vanilla_vfl_step(
    group, feat_dim: int, hidden: int, rep_dim: int, num_classes: int, lr: float = 0.01
) -> Callable:
    """One SplitNN iteration in this party's process: its representations
    all-gathered across the parties, the joint loss over the replicated
    labels and head, and plain SGD (``p − lr·g``) of its own extractor
    through the gather's transpose.

    Returns ``step(extractor, x, y, w_head) -> loss``: ``extractor`` is this
    party's (trained in place), ``x`` (b, feat_dim) its rows, ``y`` (b,)
    and ``w_head`` (K·rep_dim, num_classes) the server's."""

    def step(extractor: nn.Module, x: torch.Tensor, y: torch.Tensor, w_head: torch.Tensor):
        _check(extractor, w_head, group, (feat_dim, hidden, rep_dim, num_classes))
        params = list(extractor.parameters())
        reps = _GatherReps.apply(extractor(x), group)  # ① up; ② is its backward
        loss = _server_loss(_joint(reps, x.shape[0]), y, w_head)
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            for p, g in zip(params, grads):
                p.copy_(p - lr * g)
        return loss.detach()

    return step


class OneShotResult(NamedTuple):
    """A party's end of the one-shot session: the final joint loss, its
    step-③ pseudo-labels and the partial gradients it received at ②."""

    loss: torch.Tensor
    pseudo_labels: torch.Tensor
    partial_grads: torch.Tensor


def make_oneshot_vfl_session(
    group,
    feat_dim: int,
    hidden: int,
    rep_dim: int,
    num_classes: int,
    local_steps: int,
    lr: float = 0.01,
    rep_dtype: torch.dtype = torch.float32,
    kmeans_iters: int = 8,
    ssl_cfg: SSLConfig = SSLConfig(modality="tabular"),
) -> Callable:
    """The whole one-shot session in this party's process, with exactly
    three exchanges: ① the overlap representations, cast to ``rep_dtype``,
    all-gathered; ② this party's columns of the server loss's gradient,
    in ``rep_dtype``, all-reduced and divided by K; ③ the gradient k-means
    (one restart, ``kmeans_iters`` Lloyd iterations); ④ ``local_steps``
    full-batch steps of the engine's SSL step over (overlap, pseudo-labels)
    and the private pool, with no collective inside; ⑤ the refreshed
    representations all-gathered, and the final loss.

    Returns ``session(extractor, x_o, x_u, y, w_head, *, head=None,
    seeding=None, step_draws=None, generator=None) -> OneShotResult``:
    ``extractor`` and ``head`` (the local classifier's initial state) are
    trained in place; ``seeding`` is ③'s k-means++ draws (batch 1, one
    restart) and ``step_draws`` ④'s per-step augmentation draws. What is
    not given is drawn from ``generator``, on the data's device, in that
    order (seeding, head, steps)."""
    if local_steps < 0:
        raise ValueError(f"local_steps must be ≥ 0, got {local_steps}")
    hp = SSLHParams(epochs=0, learning_rate=lr)

    def exchange_reps(extractor: nn.Module, x_o: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            reps = all_gather_rows(extractor(x_o).to(rep_dtype), group)
        return _joint(reps, x_o.shape[0]).float()

    def session(
        extractor: nn.Module,
        x_o: torch.Tensor,
        x_u: torch.Tensor,
        y: torch.Tensor,
        w_head: torch.Tensor,
        *,
        head: Optional[nn.Module] = None,
        seeding: Optional[clustering.SeedingDraws] = None,
        step_draws: Optional[Sequence[SSLDraws]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> OneShotResult:
        _check(extractor, w_head, group, (feat_dim, hidden, rep_dim, num_classes))
        k, me, dev = _parties(group), dist.get_rank(group), x_o.device
        if step_draws is not None and len(step_draws) != local_steps:
            raise ValueError(f"{len(step_draws)} step draws for {local_steps} local steps")
        if generator is None and (seeding is None or head is None or step_draws is None):
            raise ValueError("give every draw, or a generator to draw the rest from")

        joint = exchange_reps(extractor, x_o).requires_grad_()  # ①
        (g_joint,) = torch.autograd.grad(_server_loss(joint, y, w_head), joint)
        g = g_joint[:, me * rep_dim : (me + 1) * rep_dim].to(rep_dtype).contiguous()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)  # ②
        g = (g / k).float()

        if seeding is None:
            seeding = clustering.draw_seeding(generator, 1, 1, g.shape[0], num_classes, dev)
        pseudo = clustering.gradient_pseudo_labels(  # ③
            g, num_classes, kmeans_iters, restarts=1, draws=seeding
        )

        if head is None:
            head = make_classifier(rep_dim, num_classes).to(dev).init_(generator)
        if step_draws is None:
            step_draws = [
                draw_ssl(generator, ssl_cfg, x_o.shape, x_u.shape, dev) for _ in range(local_steps)
            ]
        params = PartyParams(extractor, head)
        opt = make_ssl_optimizer(hp, params)
        step = make_ssl_step_fn(extractor, head, ssl_cfg)
        fm = x_u.mean(0)  # the party's x̄ for FixMatch-tab
        for draws in step_draws:  # ④: no collective
            step(params, opt, fm, draws, x_o, pseudo, x_u)

        with torch.no_grad():
            loss = _server_loss(exchange_reps(extractor, x_o), y, w_head)  # ⑤
        return OneShotResult(loss, pseudo, g)

    return session


# ------------------------------------------------------------- party group
def run_parties(
    fn: Callable, rank_args: Sequence[tuple], timeout: float = PARTY_TIMEOUT_S
) -> List[Any]:
    """``fn(rank, group, *rank_args[rank])`` in K = ``len(rank_args)``
    spawned processes joined by one gloo group; returns each rank's result.

    Rendezvous is a file in a fresh temporary directory, so any number of
    groups may run at once. Each child pins itself to one intra-op thread.
    ``fn`` must be importable by name (the children import it). A rank
    that raises makes the call raise with its traceback; a group not done
    within ``timeout`` seconds raises ``TimeoutError``. Either way every
    child still alive is killed first."""
    ctx = torch.multiprocessing.get_context("spawn")
    k = len(rank_args)
    with tempfile.TemporaryDirectory(prefix="vfl_parties_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(k)]
        procs = [
            ctx.Process(
                target=_party_main, args=(r, k, init, outs[r], timeout, fn, a), daemon=True
            )
            for r, a in enumerate(rank_args)
        ]
        try:
            for p in procs:
                p.start()
            _join(procs, outs, time.monotonic() + timeout)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(o, weights_only=False) for o in outs]


def _join(procs: list, outs: List[str], deadline: float) -> None:
    pending = dict(enumerate(procs))
    while pending:
        left = deadline - time.monotonic()
        if left <= 0:
            raise TimeoutError(f"party ranks {sorted(pending)} did not finish in time")
        ready = multiprocessing.connection.wait([p.sentinel for p in pending.values()], left)
        for r, p in list(pending.items()):
            if p.sentinel not in ready:
                continue
            p.join()
            del pending[r]
            if p.exitcode != 0:
                err = Path(outs[r] + ".err")
                detail = err.read_text() if err.exists() else f"exit code {p.exitcode}"
                raise RuntimeError(f"party rank {r} failed:\n{detail}")


def _party_main(rank: int, k: int, init: str, out: str, timeout: float, fn: Callable, args: tuple):
    torch.set_num_threads(1)
    # torch 2.13 marks the *_tensor collectives deprecated; torch 2.11 has no successor
    warnings.filterwarnings("ignore", r"`torch\.distributed\.\w+_tensor` is deprecated", FutureWarning)
    try:
        dist.init_process_group(
            "gloo", init_method=init, rank=rank, world_size=k,
            timeout=datetime.timedelta(seconds=timeout),
        )
        try:
            result = fn(rank, dist.group.WORLD, *args)
        finally:
            dist.destroy_process_group()
        torch.save(result, out)
    except BaseException:
        Path(out + ".err").write_text(traceback.format_exc())
        raise


# ------------------------------------------------------------ party jobs
@dataclass
class PartyJob:
    """One run in a party's process: ``kind`` "oneshot" (a session of
    ``steps`` local steps) or "vanilla" (``steps`` iterations), over this
    party's rows ``x`` (and pool ``x_u``) and the replicated ``y`` and
    ``w_head``. The extractor's and head's initial parameters (reference
    keys), ③'s seeding and ④'s step draws are used where given; the rest
    is drawn on the CPU from ``seed`` + 1000·rank and then moved, so every
    device runs on the same draws."""

    kind: str
    x: torch.Tensor
    y: torch.Tensor
    w_head: torch.Tensor
    steps: int
    hidden: int
    rep_dim: int
    x_u: Optional[torch.Tensor] = None
    rep_dtype: torch.dtype = torch.float32
    kmeans_iters: int = 8
    lr: float = 0.01
    seed: int = 0
    extractor: Optional[Dict[str, np.ndarray]] = None
    head: Optional[Dict[str, np.ndarray]] = None
    seeding: Optional[clustering.SeedingDraws] = None
    step_draws: Optional[List[SSLDraws]] = None

    def __post_init__(self) -> None:
        # a view pickles with its base's whole storage: a slice of every
        # party's features would carry the others' into this party's process
        self.x = self.x.clone()
        self.x_u = None if self.x_u is None else self.x_u.clone()


def _to(obj: Any, dev: torch.device) -> Any:
    """``obj``'s tensors (in dataclasses, tuples and lists) on ``dev``."""
    if torch.is_tensor(obj):
        return obj.to(dev)
    if is_dataclass(obj):
        return type(obj)(**{f.name: _to(getattr(obj, f.name), dev) for f in fields(obj)})
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to(o, dev) for o in obj)
    return obj


def _module(module: Dense, params: Optional[dict], gen: torch.Generator, dev) -> Dense:
    if params is None:
        module.init_(gen)
    else:
        bridge.load_jax_params(module, params)
    return module.to(dev)


def _run_job(job: PartyJob, rank: int, group, dev: torch.device) -> Dict[str, Any]:
    gen = torch.Generator().manual_seed(job.seed + 1000 * rank)
    feat_dim, num_classes = job.x.shape[1], job.w_head.shape[1]
    x, y, w_head = job.x.to(dev), job.y.to(dev), job.w_head.to(dev)
    extractor = _module(_make_extractor(feat_dim, job.hidden, job.rep_dim), job.extractor, gen, dev)
    out: Dict[str, Any] = {}
    if job.kind == "vanilla":
        step = make_vanilla_vfl_step(group, feat_dim, job.hidden, job.rep_dim, num_classes, job.lr)
        out["losses"] = [float(step(extractor, x, y, w_head)) for _ in range(job.steps)]
        out["loss"] = out["losses"][-1] if out["losses"] else float("nan")
    elif job.kind == "oneshot":
        session = make_oneshot_vfl_session(
            group, feat_dim, job.hidden, job.rep_dim, num_classes, job.steps, job.lr,
            job.rep_dtype, job.kmeans_iters,
        )
        x_u = job.x_u.to(dev)
        seeding = job.seeding or clustering.draw_seeding(gen, 1, 1, x.shape[0], num_classes, "cpu")
        head = _module(make_classifier(job.rep_dim, num_classes), job.head, gen, dev)
        step_draws = job.step_draws or [
            draw_ssl(gen, SSLConfig(modality="tabular"), x.shape, x_u.shape, "cpu")
            for _ in range(job.steps)
        ]
        res = session(
            extractor, x, x_u, y, w_head,
            head=head, seeding=_to(seeding, dev), step_draws=_to(step_draws, dev),
        )
        out.update(
            loss=float(res.loss),
            pseudo=res.pseudo_labels.cpu().numpy(),
            partial_grads=res.partial_grads.cpu().numpy(),
        )
    else:
        raise ValueError(f"unknown party job kind {job.kind!r}")
    out["extractor"] = bridge.to_jax_params(extractor)
    return out


def run_party_jobs(rank: int, group, device: str, jobs: Sequence[PartyJob]) -> List[Dict[str, Any]]:
    """Run ``jobs`` in order in party ``rank``'s process on ``device``
    ("cpu", or "cuda": rank r on card r mod the card count). Each result
    holds the job's final extractor (reference keys), loss, the
    collectives it ran (:class:`Collective` records and their
    :meth:`count_party_collectives.counts`), its ``kmeans`` kernel
    launches and its seconds; a one-shot job also its pseudo-labels and
    received partial gradients, a vanilla job its per-step losses."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    results = []
    for job in jobs:
        launches = kmeans_ops.LAUNCHES
        t0 = time.perf_counter()
        with count_party_collectives() as seen:
            out = _run_job(job, rank, group, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out.update(
            ops=list(seen.ops),
            counts=seen.counts(),
            kmeans_launches=kmeans_ops.LAUNCHES - launches,
            seconds=time.perf_counter() - t0,
        )
        results.append(out)
    return results


# -------------------------------------------------------------------- CLI
# The sizes of the reference's examples/vfl_multipod.py.
FEAT, HIDDEN, REP, CLASSES, BATCH, POOL, LOCAL_STEPS = 64, 128, 32, 10, 256, 1024, 100


def example_jobs(parties: int, seed: int = 0) -> List[List[PartyJob]]:
    """Each party's jobs at the example's sizes: one vanilla iteration and
    a one-shot session of 100 local steps, on rows drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((parties, BATCH, FEAT), dtype=np.float32))
    x_u = torch.from_numpy(rng.standard_normal((parties, POOL, FEAT), dtype=np.float32))
    y = torch.from_numpy(rng.integers(0, CLASSES, BATCH))
    w_head = torch.from_numpy(0.1 * rng.standard_normal((parties * REP, CLASSES), dtype=np.float32))
    common = dict(y=y, w_head=w_head, hidden=HIDDEN, rep_dim=REP, seed=seed)
    return [
        [
            PartyJob("vanilla", x[k], steps=1, **common),
            PartyJob("oneshot", x[k], steps=LOCAL_STEPS, x_u=x_u[k], **common),
        ]
        for k in range(parties)
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    ap.add_argument("--parties", type=int, default=2)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    results = run_parties(
        run_party_jobs, [(dev.type, jobs) for jobs in example_jobs(args.parties)]
    )
    vanilla, oneshot = results[0]
    cv, co = vanilla["counts"]["pod_crossing"], oneshot["counts"]["pod_crossing"]
    iters = 1000
    print(f"{args.parties} party processes on {dev.type} (gloo)")
    print(
        f"vanilla VFL step    : {cv} cross-party collectives per iteration "
        f"{[op.kind for op in vanilla['ops']]}, {vanilla['counts']['pod_crossing_bytes']} bytes"
    )
    print(
        f"one-shot VFL session: {co} cross-party collectives TOTAL ({LOCAL_STEPS} local steps "
        f"inside) {[op.kind for op in oneshot['ops']]}, "
        f"{oneshot['counts']['pod_crossing_bytes']} bytes"
    )
    print(
        f"→ a {iters}-iteration session crosses parties {cv * iters}× (vanilla) vs {co}× "
        f"(one-shot): {cv * iters // co}× fewer"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
