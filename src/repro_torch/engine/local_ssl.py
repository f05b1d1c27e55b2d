"""The local-SSL session of one party (Alg. 1 l.29-34).

Counterpart of ``repro.engine.local_ssl``: ``build_schedule`` is the same
numpy-seeded epoch×minibatch schedule (so equal ``seed0`` gives equal
indices), and ``train_party_ssl`` runs it as a Python loop of the one
step of :func:`make_ssl_step_fn`, one minibatch of Eq. (4) followed by
clip-5 SGD with momentum (:func:`make_ssl_optimizer`). ``launch.vfl_step``
takes its full-batch steps from the same function.

``train_parties_ssl_stacked`` is the counterpart of the reference's
``train_parties_ssl_vmapped``: E homogeneous tasks (parties, seeds and
scenarios alike; the axis is anonymous) train as one stacked session. Their
parameters stack on a leading axis, one step is
``vmap(grad_and_value(loss))`` over a parameter template of their spec
(``functional_call``), then each entry's clip
by its own global norm and the momentum update, stacked. The built step is
cached in ``engine.sessions`` (domain ``"ssl"``). The augmentation draws of
every step are made before the session, entry after entry and step after
step, in the order the one-party loop draws them (:func:`draw_session`), so
the stack trains on exactly the loop's draws. ``train_clients_ssl`` picks
the path: the reference's dispatcher stacks any homogeneous tasks, this one
only where the card's measurements show the stack paying (:func:`stack_pays`).
A batch mesh (``engine.parallel``) shards the stacked session slot by slot;
it never changes which path runs.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, is_dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call, grad_and_value, vmap

from repro_torch.core.ssl import SSLConfig, SSLDraws, draw_ssl, ssl_loss
from repro_torch.data.loader import epoch_batches
from repro_torch.engine import parallel, sessions
from repro_torch.optim import ClippedSGD, clipped_sgd_stacked_

# Offset of the unlabeled draw stream from the labeled shuffle stream: the
# labeled epochs seed RandomState(seed0 + e), the unlabeled ones
# RandomState(seed0 + 7919·e + _UNLABELED_STREAM), so the two never share a
# seed (the reference's constant).
_UNLABELED_STREAM = 104729


@dataclass(frozen=True)
class SSLHParams:
    """Hyper-parameters of the local-SSL loop (paper defaults)."""

    epochs: int = 20
    batch_size: int = 32
    learning_rate: float = 0.01
    momentum: float = 0.9
    unlabeled_ratio: int = 2  # μ: unlabeled batch = μ × labeled batch
    grad_clip: float = 5.0


@dataclass
class PartyTask:
    """One party's local-SSL problem: its modules (trained in place) and its
    pseudo-labeled and private data.

    ``labeled_mask`` / ``unlabeled_mask`` are per-row validity masks (None:
    every row counts). ``step_valid`` is the fault path's (S,) per-step
    commit mask (None: every step commits): a step whose entry is 0 draws
    and computes as usual but leaves the parameters and the momentum as
    they were."""

    extractor: nn.Module
    head: nn.Module
    ssl_cfg: SSLConfig
    x_labeled: torch.Tensor  # (N_l, …) overlap rows
    y_pseudo: torch.Tensor  # (N_l,) cluster pseudo-labels
    x_unlabeled: torch.Tensor  # (N_u, …) party-private pool
    feature_mean: Optional[torch.Tensor] = None  # x̄ for FixMatch-tab
    labeled_mask: Optional[torch.Tensor] = None
    unlabeled_mask: Optional[torch.Tensor] = None
    step_valid: Optional[torch.Tensor] = None


class Schedule(NamedTuple):
    idx_labeled: np.ndarray  # (S, bs_l) int64
    idx_unlabeled: np.ndarray  # (S, bs_u) int64


def schedule_steps(n_labeled: int, hp: SSLHParams) -> int:
    """The number of steps :func:`build_schedule` flattens the epochs into."""
    bs_l = min(hp.batch_size, n_labeled)
    return hp.epochs * (n_labeled // bs_l) if bs_l else 0


def build_schedule(seed0: int, n_labeled: int, n_unlabeled: int, hp: SSLHParams) -> Schedule:
    """Flatten the epoch×minibatch loop into one (S, …) schedule.

    Labeled batches are shuffled epochs (drop-remainder); unlabeled batches
    are independent uniform draws, μ× larger, from a decorrelated stream.
    An empty private pool gives zero-width unlabeled batches."""
    bs_l = min(hp.batch_size, n_labeled)
    bs_u = min(hp.batch_size * hp.unlabeled_ratio, n_unlabeled)
    idx_l: List[np.ndarray] = []
    idx_u: List[np.ndarray] = []
    for e in range(hp.epochs):
        u_rng = np.random.RandomState(seed0 + 7919 * e + _UNLABELED_STREAM)
        for batch in epoch_batches(n_labeled, bs_l, seed0 + e):
            idx_l.append(batch)
            if n_unlabeled > 0:
                idx_u.append(u_rng.randint(0, n_unlabeled, size=bs_u))
            else:
                idx_u.append(np.zeros(0, np.int64))
    if not idx_l:
        return Schedule(np.zeros((0, bs_l), np.int64), np.zeros((0, bs_u), np.int64))
    return Schedule(np.stack(idx_l).astype(np.int64), np.stack(idx_u).astype(np.int64))


def seed_from(gen: torch.Generator) -> int:
    """An integer schedule seed in [0, 2³¹−1) drawn from ``gen``."""
    return int(torch.randint(0, 2**31 - 1, (), generator=gen, device=gen.device))


class PartyParams(NamedTuple):
    """(extractor, head) modules of one party's local model."""

    extractor: nn.Module
    head: nn.Module


def make_ssl_optimizer(hp: SSLHParams, params: PartyParams) -> ClippedSGD:
    """Clip by global norm, then SGD with momentum, over the extractor's and
    then the head's parameters (the reference's ``make_ssl_optimizer``)."""
    return ClippedSGD(
        [*params.extractor.parameters(), *params.head.parameters()],
        hp.learning_rate,
        hp.momentum,
        hp.grad_clip,
    )


def make_ssl_step_fn(extractor: nn.Module, head: nn.Module, ssl_cfg: SSLConfig):
    """THE local-SSL step: every caller in the port takes its step from here.

    Returns ``step(params, opt, feature_mean, draws, xb_l, yb_l, xb_u,
    mb_l=None, mb_u=None, commit=True) -> metrics``: one minibatch of
    Eq. (4) through ``head(extractor(x))``, then ``opt``'s update of
    ``params`` in place. ``params`` are the modules it was built from (the
    reference passes the pytrees its models apply; here the modules hold
    them). ``draws`` are the step's augmentation draws; ``mb_l`` / ``mb_u``
    the minibatch rows of the validity masks (None: every row counts). A
    step with ``commit`` False computes its loss and metrics and updates
    nothing. The metrics are detached tensors."""

    def logits_fn(x: torch.Tensor) -> torch.Tensor:
        return head(extractor(x))

    def step(params, opt, feature_mean, draws, xb_l, yb_l, xb_u, mb_l=None, mb_u=None, commit=True):
        if params.extractor is not extractor or params.head is not head:
            raise ValueError("the step trains the modules it was built from")
        with torch.set_grad_enabled(commit):
            loss, metrics = ssl_loss(
                logits_fn, xb_l, yb_l, xb_u, ssl_cfg, draws, feature_mean, mb_l, mb_u
            )
        if commit:
            # zeros for a parameter the loss does not reach (an untied zoo
            # backbone's unembed), as jax.grad gives them
            opt.step(torch.autograd.grad(loss, opt.params, allow_unused=True, materialize_grads=True))
        return metrics

    return step


def train_party_ssl(
    task: PartyTask,
    hp: SSLHParams,
    seed0: int,
    *,
    generator: Optional[torch.Generator] = None,
    step_draws: Optional[Sequence[SSLDraws]] = None,
) -> Dict[str, float]:
    """One party's SSL session; trains ``task.extractor`` and ``task.head``
    in place and returns the last step's metrics.

    ``seed0`` seeds the schedule (as the reference's ``build_schedule``
    draws it from its key). Each step's augmentation draws come from
    ``step_draws[i]`` when given, else from ``generator``, which must live
    on the data's device. A step that ``task.step_valid`` marks 0 still
    draws its augmentation and computes its loss and metrics, but commits
    nothing (no optimizer step), as the reference's masked session."""
    sched = build_schedule(seed0, task.x_labeled.shape[0], task.x_unlabeled.shape[0], hp)
    steps = sched.idx_labeled.shape[0]
    if step_draws is None and generator is None and steps:
        raise ValueError("give the per-step draws or a generator to draw them from")
    if step_draws is not None and len(step_draws) != steps:
        raise ValueError(f"{len(step_draws)} step draws for a {steps}-step schedule")
    valid = None if task.step_valid is None else [v > 0 for v in task.step_valid.tolist()]
    if valid is not None and len(valid) != steps:
        raise ValueError(f"{len(valid)} step_valid entries for a {steps}-step schedule")
    dev = task.x_labeled.device
    idx_l = torch.from_numpy(sched.idx_labeled).to(dev)
    idx_u = torch.from_numpy(sched.idx_unlabeled).to(dev)
    params = PartyParams(task.extractor, task.head)
    opt = make_ssl_optimizer(hp, params)
    step = make_ssl_step_fn(task.extractor, task.head, task.ssl_cfg)

    metrics: Dict[str, torch.Tensor] = {}
    for i in range(steps):
        il, iu = idx_l[i], idx_u[i]
        xb_l, xb_u = task.x_labeled[il], task.x_unlabeled[iu]
        draws = (
            step_draws[i]
            if step_draws is not None
            else draw_ssl(generator, task.ssl_cfg, xb_l.shape, xb_u.shape, dev)
        )
        metrics = step(
            params,
            opt,
            task.feature_mean,
            draws,
            xb_l,
            task.y_pseudo[il],
            xb_u,
            None if task.labeled_mask is None else task.labeled_mask[il],
            None if task.unlabeled_mask is None else task.unlabeled_mask[iu],
            commit=valid is None or valid[i],
        )
    return {k: float(v) for k, v in metrics.items()}


# ------------------------------------------------------------ the stacked fold
def draw_session(task: PartyTask, hp: SSLHParams, generator: torch.Generator) -> List[SSLDraws]:
    """Every step's augmentation draws of ``task``'s session, drawn from
    ``generator`` as :func:`train_party_ssl` would draw them step by step."""
    n_l, n_u = task.x_labeled.shape[0], task.x_unlabeled.shape[0]
    bs_l = min(hp.batch_size, n_l)
    bs_u = min(hp.batch_size * hp.unlabeled_ratio, n_u)
    l_shape = (bs_l, *task.x_labeled.shape[1:])
    u_shape = (bs_u, *task.x_unlabeled.shape[1:])
    dev = task.x_labeled.device
    return [
        draw_ssl(generator, task.ssl_cfg, l_shape, u_shape, dev)
        for _ in range(schedule_steps(n_l, hp))
    ]


def tasks_are_homogeneous(tasks: Sequence[PartyTask]) -> bool:
    """True when every task shares one stacked shape and one forward: equal
    extractor and head specs (:func:`sessions.module_spec`; a module no spec
    describes never stacks), parameter shapes and dtypes, data shapes and
    device, SSL config, and the same optional masks, of the same shapes.
    Ragged per-party gate counts are not heterogeneous: masked tasks share
    one static capacity."""
    t0 = tasks[0]
    spec0 = (sessions.module_spec(t0.extractor), sessions.module_spec(t0.head))
    if None in spec0:
        return False

    def shapes(t: PartyTask) -> list:
        params = [*t.extractor.parameters(), *t.head.parameters()]
        return [(p.shape, p.dtype) for p in params]

    ref = shapes(t0)
    for t in tasks[1:]:
        if (sessions.module_spec(t.extractor), sessions.module_spec(t.head)) != spec0:
            return False
        if shapes(t) != ref or t.ssl_cfg != t0.ssl_cfg:
            return False
        for attr in ("x_labeled", "y_pseudo", "x_unlabeled"):
            a, a0 = getattr(t, attr), getattr(t0, attr)
            if a.shape != a0.shape or a.dtype != a0.dtype or a.device != a0.device:
                return False
        for attr in ("feature_mean", "labeled_mask", "unlabeled_mask", "step_valid"):
            a, a0 = getattr(t, attr), getattr(t0, attr)
            if (a is None) != (a0 is None):
                return False
            if a is not None and a.shape != a0.shape:
                return False
    return True


def parties_are_homogeneous(
    specs: Sequence, ssl_cfgs: Sequence[SSLConfig], feature_shapes: Sequence[tuple]
) -> bool:
    """:func:`tasks_are_homogeneous` decided before any task exists, from a
    scenario's extractor specs, SSL configs and per-party aligned shapes:
    one spec, one config, one trailing feature shape."""
    return (
        len(set(specs)) == 1
        and len(set(ssl_cfgs)) == 1
        and len({tuple(s)[1:] for s in feature_shapes}) == 1
    )


def _leaves(obj) -> List[torch.Tensor]:
    """The tensors of a draws record (dataclasses, tuples), in field order."""
    if torch.is_tensor(obj):
        return [obj]
    if is_dataclass(obj):
        return [x for f in fields(obj) for x in _leaves(getattr(obj, f.name))]
    if isinstance(obj, (tuple, list)):
        return [x for o in obj for x in _leaves(o)]
    raise TypeError(f"cannot stack a draw of type {type(obj).__name__}")


def _rebuild(template, leaves):
    """``template``'s structure around the tensors of the iterator ``leaves``."""
    if torch.is_tensor(template):
        return next(leaves)
    if is_dataclass(template):
        return type(template)(
            **{f.name: _rebuild(getattr(template, f.name), leaves) for f in fields(template)}
        )
    return type(template)(_rebuild(o, leaves) for o in template)


def _functional(module: nn.Module):
    """``module``'s forward as a function of a parameter dict."""
    return lambda params, x: functional_call(module, params, (x,))


class StackedSSLStep:
    """One built stacked SSL step: the loss of Eq. (4) as a function of an
    entry's (extractor, head) parameters over templates of their specs,
    ``vmap(grad_and_value(loss))`` over the entry axis; the stacked update
    is ``optim.clipped_sgd_stacked_``. Masks and draws are arguments."""

    METRICS = ("loss", "l_s", "l_u", "pseudo_mask_rate")

    def __init__(self, ext_spec, head_spec, feature_shape, rep_dim, ssl_cfg, in_dims):
        with torch.device("meta"):
            self.ext = ext_spec.build(feature_shape)
            self.head = head_spec.build((rep_dim,))
        self.ext_names = [n for n, _ in self.ext.named_parameters()]
        self.head_names = [n for n, _ in self.head.named_parameters()]
        ext_fn, head_fn = _functional(self.ext), _functional(self.head)
        n_ext = len(self.ext_names)

        def loss(params, x_l, y_l, x_u, draw_leaves, template, fm, m_l, m_u):
            ext_p = dict(zip(self.ext_names, params[:n_ext]))
            head_p = dict(zip(self.head_names, params[n_ext:]))

            def logits_fn(x: torch.Tensor) -> torch.Tensor:
                return head_fn(head_p, ext_fn(ext_p, x))

            draws = _rebuild(template, iter(draw_leaves))
            value, metrics = ssl_loss(logits_fn, x_l, y_l, x_u, ssl_cfg, draws, fm, m_l, m_u)
            return value, torch.stack([metrics[k] for k in self.METRICS])

        self.grad = vmap(grad_and_value(loss, has_aux=True), in_dims=in_dims)

    def param_lists(self, tasks: Sequence[PartyTask]) -> List[List[nn.Parameter]]:
        """Each task's parameters in the step's order (extractor, then head)."""
        return [
            [*(dict(t.extractor.named_parameters())[n] for n in self.ext_names),
             *(dict(t.head.named_parameters())[n] for n in self.head_names)]
            for t in tasks
        ]


def _stack(xs: Sequence[Optional[torch.Tensor]]) -> Optional[torch.Tensor]:
    return None if xs[0] is None else torch.stack(list(xs))


def train_parties_ssl_stacked(
    tasks: Sequence[PartyTask],
    hp: SSLHParams,
    seeds0: Sequence[int],
    step_draws: Sequence[Sequence[SSLDraws]],
    mesh=None,
) -> List[Dict[str, float]]:
    """E homogeneous tasks' SSL sessions as one stacked session; trains
    every task's modules in place and returns each task's last-step metrics.

    ``seeds0[e]`` seeds task e's schedule and ``step_draws[e]`` holds its
    per-step draws, exactly as :func:`train_party_ssl` takes them, so
    entry e trains as that loop would, up to the rounding of batched
    products. An entry's ``step_valid`` 0 still computes the step and
    commits neither its parameters nor its momentum.

    With a ``mesh`` the E entries are padded to a multiple of its slots with
    copies of entry 0 (its task, schedule and drawn tensors, never a new
    draw), each slot holds its slice's parameters, momentum, data and draws
    on its device for the whole session, every step launches each slot's
    step in turn, and only the real entries are written back."""
    t0 = tasks[0]
    n = len(tasks)
    dev = t0.x_labeled.device
    mesh = parallel.resolve_mesh(mesh, dev)
    scheds = [
        build_schedule(s0, t.x_labeled.shape[0], t.x_unlabeled.shape[0], hp)
        for s0, t in zip(seeds0, tasks)
    ]
    steps = scheds[0].idx_labeled.shape[0]
    for t, d in zip(tasks, step_draws):
        if len(d) != steps:
            raise ValueError(f"{len(d)} step draws for a {steps}-step schedule")
        if t.step_valid is not None and t.step_valid.shape[0] != steps:
            raise ValueError(
                f"{t.step_valid.shape[0]} step_valid entries for a {steps}-step schedule"
            )
    if steps == 0:
        return [{} for _ in tasks]
    tasks, scheds, step_draws = (
        parallel.pad_entries(x, mesh) for x in (tasks, scheds, step_draws)
    )
    fm, m_l, m_u = (
        _stack([getattr(t, a) for t in tasks])
        for a in ("feature_mean", "labeled_mask", "unlabeled_mask")
    )
    valid = _stack([t.step_valid for t in tasks])
    if valid is not None:
        valid = valid.to(dev) > 0
    in_dims = (0, 0, 0, 0, 0, None) + tuple(None if a is None else 0 for a in (fm, m_l, m_u))
    ext_spec = sessions.module_spec(t0.extractor)
    head_spec = sessions.module_spec(t0.head)
    key = (
        "vmap", ext_spec, head_spec, t0.ssl_cfg,
        (hp.learning_rate, hp.momentum, hp.grad_clip), in_dims, parallel.mesh_key(mesh),
    )
    step = sessions.cached_session(
        "ssl",
        key,
        lambda: StackedSSLStep(
            ext_spec, head_spec, tuple(t0.x_labeled.shape[1:]), ext_spec.rep_dim, t0.ssl_cfg, in_dims
        ),
    )

    own = step.param_lists(tasks)  # a padded slot's are entry 0's: read, never written
    with torch.no_grad():
        flat = [torch.stack(ps) for ps in zip(*own)]
    x_l, y_l, x_u = (
        torch.stack([getattr(t, a) for t in tasks]) for a in ("x_labeled", "y_pseudo", "x_unlabeled")
    )
    idx_l = torch.from_numpy(np.stack([s.idx_labeled for s in scheds])).to(dev)
    idx_u = torch.from_numpy(np.stack([s.idx_unlabeled for s in scheds])).to(dev)
    template = step_draws[0][0]
    stacked = (flat, x_l, y_l, x_u, idx_l, idx_u, _stack_draws(step_draws), fm, m_l, m_u, valid)
    slots = [_SSLSlot(*part) for part in parallel.split_stacked(stacked, mesh)]

    for i in range(steps):
        for slot in slots:
            slot.step(step, i, template, hp)

    with torch.no_grad():
        flat = parallel.gather_stacked([slot.flat for slot in slots], dev)
        for e, ps in enumerate(own[:n]):  # the real entries only
            for p, col in zip(ps, flat):
                p.copy_(col[e])
    metrics = parallel.gather_stacked([slot.metrics for slot in slots], dev)[:n]
    return [dict(zip(StackedSSLStep.METRICS, row)) for row in metrics.cpu().tolist()]


class _SSLSlot:
    """One mesh slot's share of a stacked SSL session, on its device: its
    entries' stacked parameters and momentum, data, schedules, draws and
    masks, and its last step's metrics."""

    def __init__(self, flat, x_l, y_l, x_u, idx_l, idx_u, draws, fm, m_l, m_u, valid):
        self.flat, self.x_l, self.y_l, self.x_u = flat, x_l, y_l, x_u
        self.idx_l, self.idx_u, self.draws = idx_l, idx_u, draws
        self.fm, self.m_l, self.m_u, self.valid = fm, m_l, m_u, valid
        self.trace = [torch.zeros_like(p, dtype=torch.float32) for p in flat]
        self.rows = torch.arange(x_l.shape[0], device=x_l.device)[:, None]
        self.metrics: Optional[torch.Tensor] = None

    def step(self, step: StackedSSLStep, i: int, template, hp: SSLHParams) -> None:
        """Step ``i`` of the schedule, launched and never read back."""
        rows, il, iu = self.rows, self.idx_l[:, i], self.idx_u[:, i]
        grads, (_, self.metrics) = step.grad(
            tuple(self.flat),
            self.x_l[rows, il],
            self.y_l[rows, il],
            self.x_u[rows, iu],
            [d[:, i] for d in self.draws],
            template,
            self.fm,
            None if self.m_l is None else self.m_l[rows, il],
            None if self.m_u is None else self.m_u[rows, iu],
        )
        commit = None if self.valid is None else self.valid[:, i]
        clipped_sgd_stacked_(
            self.flat, self.trace, grads, hp.learning_rate, hp.momentum, hp.grad_clip, commit
        )


def _stack_draws(step_draws: Sequence[Sequence[SSLDraws]]) -> List[torch.Tensor]:
    """Per draw leaf, one (E, steps, …) tensor over the tasks' sessions."""
    per_task = []
    for task_draws in step_draws:
        cols = zip(*(_leaves(d) for d in task_draws))
        per_task.append([torch.stack(col) for col in cols])
    return [torch.stack(col) for col in zip(*per_task)]


# Where "auto" stacks (PERF.md §5, NVIDIA H100 80GB HBM3): a K = 2 MLP
# entry's stacked step costs more than its two one-party steps (few-shot A's
# ⑤' 3.363 ms a party-step against 2.626), a K = 4 entry's less (the fault
# family's few-shot runs 3.14 s against 4.6-6.2), and several entries'
# stack beats their loop at any K; ``vmap`` turns the CNN's convolutions
# into grouped ones that cost more than the loop (one-shot B's ④ 39.313 ms
# a step against 17.4-19.0).
STACK_MIN_PARTIES = 4


def stack_pays(spec, num_parties: int, num_entries: int = 1) -> bool:
    """Whether ``"auto"`` stacks the homogeneous sessions of ``num_entries``
    entries of ``num_parties`` parties with extractor ``spec``: MLP
    extractors only, and several entries or at least
    :data:`STACK_MIN_PARTIES` parties in the one entry."""
    if spec is None or spec.kind != "mlp" or num_parties * num_entries < 2:
        return False
    return num_entries > 1 or num_parties >= STACK_MIN_PARTIES


def refuse_unstackable(tasks: Sequence[PartyTask], mode: str) -> None:
    """``mode`` "vmap" over an extractor that no spec describes (a model-zoo
    backbone) raises before anything runs: its norms launch the RMSNorm
    kernel through a ctypes entry that takes one (rows, d) tensor, never a
    batched one."""
    if mode == "vmap" and any(sessions.module_spec(t.extractor) is None for t in tasks):
        raise ValueError(
            "engine mode 'vmap' cannot stack a model-zoo extractor: its RMSNorm kernel takes "
            "one (rows, d) tensor, not a batched one; use mode='auto' or 'python'"
        )


def train_clients_ssl(
    tasks: Sequence[PartyTask],
    hp: SSLHParams,
    seeds0: Sequence[int],
    step_draws: Sequence[Sequence[SSLDraws]],
    mode: str = "auto",
    mesh=None,
) -> Tuple[List[Dict[str, float]], str]:
    """Every task's SSL session; returns the per-task last-step metrics and
    the path that ran, ``"vmap"`` (one stacked session) or ``"python"`` (one
    :func:`train_party_ssl` after another, on the same draws).

    ``mode``: ``"auto"`` stacks homogeneous tasks where :func:`stack_pays`
    for one entry of ``len(tasks)`` parties; ``"vmap"`` requires the stack
    (and raises on heterogeneous tasks); ``"python"`` forces the loop. A
    ``mesh`` shards the stacked session; the loop has no stacked axis and
    ignores it."""
    if mode not in ("auto", "vmap", "python"):
        raise ValueError(f"unknown engine mode {mode!r}")
    refuse_unstackable(tasks, mode)
    homogeneous = tasks_are_homogeneous(tasks)
    if mode == "vmap" and not homogeneous:
        raise ValueError(
            "engine mode 'vmap' requires homogeneous party tasks (same specs, "
            "parameter and data shapes, and SSLConfig); use mode='auto' or 'python'"
        )
    pays = homogeneous and stack_pays(sessions.module_spec(tasks[0].extractor), len(tasks))
    if mode == "vmap" or (mode == "auto" and pays):
        return train_parties_ssl_stacked(tasks, hp, seeds0, step_draws, mesh), "vmap"
    metrics = [
        train_party_ssl(t, hp, s0, step_draws=d) for t, s0, d in zip(tasks, seeds0, step_draws)
    ]
    return metrics, "python"
