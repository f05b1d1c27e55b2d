"""Iterative split-NN VFL sessions: the steps of the three baselines and
their seed fold.

Counterpart of ``repro.engine.iterative``:

* ``make_splitnn_step_fn``: one SplitNN iteration, reps up and
  rep-gradients down, as one joint backward over every party's extractor
  and the server classifier;
* ``make_fedcvt_step_fn``: the same iteration plus FedCVT-style cross-view
  training: each party's unaligned batch, completed with Eq. 10 estimates
  of the other parties' reps, joins the loss where its pseudo-label
  confidence clears a threshold;
* ``make_fedbcd_step_fn``: one FedBCD-p round [20], one rep exchange then
  ``q`` local updates on the stale rep-gradients (clients) and the stale
  reps (server);
* ``build_iteration_schedule`` / ``build_unaligned_schedule``: the
  numpy-seeded minibatch schedules, equal to the reference's index for
  index;
* ``run_iterative_session``: a Python loop of a step over a schedule, up
  to a commit horizon (``active_steps``, the fault path's dropout stall);
* ``run_iterative_session_seeds``: the seed fold. E entries (seeds and
  scenarios alike) of one step kind train as one stacked session: each
  party's extractor and the classifier become functional losses over meta
  templates of their specs (:class:`StackedIterStep`), one
  ``vmap(grad_and_value)`` a step over the entry axis, and the stacked
  momentum update, each entry committing up to its own horizon. The
  ``"python"`` path is :func:`run_iterative_session` once an entry.

A step function updates the parties' extractors, the server classifier and
their momentum traces (unclipped SGD with momentum, ``optim.ClippedSGD``
with ``max_norm=None``) in place, and returns the step's loss; called with
``commit=False`` it only computes that loss at the current state. Only the
extractors and the classifier train: a client's local head rides in the
reference's carry with a zero gradient and stays unchanged, so here it is
left out.

The built stacked step is cached in ``engine.sessions`` (domain
``"iterative"``) under :func:`session_cache_key`: the kind, each party's
and the classifier's spec, the hyper-parameters and FedBCD's Q. The key has
no batch width and no data shape, so the width-1 session and every fold
share it, whichever path runs. A batch mesh (``engine.parallel``) shards
the stacked session over its slots; on that path the key gains the mesh's
``parallel.mesh_key``, and the per-entry loop ignores the mesh.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import grad, grad_and_value, vmap

from repro_torch.core import estimator
from repro_torch.core.server import concat_reps
from repro_torch.core.ssl import cross_entropy
from repro_torch.data.loader import epoch_batches
from repro_torch.engine import parallel, sessions
from repro_torch.engine.local_ssl import _functional
from repro_torch.optim import ClippedSGD, clipped_sgd_stacked_

# step(xs, y, xs_u, commit=True) -> loss: minibatches of each party's aligned
# rows, their labels, and (FedCVT only) each party's unaligned minibatch;
# with commit=False the step updates nothing
Step = Callable[..., torch.Tensor]


@dataclass(frozen=True)
class IterHParams:
    """Optimizer hyper-parameters of one iterative session."""

    client_lr: float = 0.01
    server_lr: float = 0.01
    momentum: float = 0.9
    fedcvt_threshold: float = 0.95


def _optimizers(
    extractors: Sequence[nn.Module], classifier: nn.Module, hp: IterHParams
) -> Tuple[List[ClippedSGD], ClippedSGD]:
    """One unclipped SGD with momentum per extractor, one for the classifier."""
    clients = [
        ClippedSGD(list(e.parameters()), hp.client_lr, hp.momentum, max_norm=None)
        for e in extractors
    ]
    server = ClippedSGD(list(classifier.parameters()), hp.server_lr, hp.momentum, max_norm=None)
    return clients, server


def _joint_update(loss: torch.Tensor, opts: Sequence[ClippedSGD]) -> None:
    """One backward of ``loss`` over every optimizer's parameters, then each
    optimizer's step on its share of the gradients."""
    grads = torch.autograd.grad(loss, [p for opt in opts for p in opt.params])
    start = 0
    for opt in opts:
        opt.step(grads[start : start + len(opt.params)])
        start += len(opt.params)


def _joint_loss(reps: Sequence[torch.Tensor], classify: Callable, y: torch.Tensor) -> torch.Tensor:
    """Mean CE of the classifier on the party-major concatenated reps."""
    return cross_entropy(classify(concat_reps(reps)), y).mean()


def make_splitnn_step_fn(
    extractors: Sequence[nn.Module], classifier: nn.Module, hp: IterHParams
) -> Step:
    """One SplitNN iteration: mean CE of the classifier on the concatenated
    reps, differentiated jointly through every extractor and the classifier.
    The iteration's communication (reps up, rep-gradients down) is logged by
    the caller."""
    extractors = list(extractors)
    clients, server = _optimizers(extractors, classifier, hp)

    def step(xs, y, xs_u=None, commit=True):
        del xs_u
        with torch.set_grad_enabled(commit):
            loss = _joint_loss([e(x) for e, x in zip(extractors, xs)], classifier, y)
        if commit:
            _joint_update(loss, [*clients, server])
        return loss.detach()

    return step


def _fedcvt_loss(extract: Callable, classify: Callable, xs, y, xs_u, threshold: float) -> torch.Tensor:
    """FedCVT's loss: the joint CE on the overlap batch, plus for each party
    k its unaligned batch's masked pseudo-label CE. H_u^k is completed with
    Eq. 10 estimates of every other party j from this step's overlap reps
    (H_o^k as keys, H_o^j as values), differentiated through all three;
    pseudo-labels and the mask ``max p > threshold`` come from the detached
    logits, and the term is ``Σ ce·mask / max(Σ mask, 1)`` (0 for an empty
    pool). ``extract(k, x)`` is party k's extractor, ``classify`` f_c."""
    reps_o = [extract(k, x) for k, x in enumerate(xs)]
    loss = _joint_loss(reps_o, classify, y)
    for k, x_u in enumerate(xs_u):
        h_u = extract(k, x_u)
        parts = [
            h_u if j == k else estimator.sdpa_transform_differentiable(h_u, reps_o[k], o)
            for j, o in enumerate(reps_o)
        ]
        logits_u = classify(concat_reps(parts))
        p_u = torch.softmax(logits_u.detach(), dim=-1)
        conf, pseudo = p_u.max(dim=-1)
        mask = (conf > threshold).float()
        ce = cross_entropy(logits_u, pseudo)
        loss = loss + (ce * mask).sum() / mask.sum().clamp(min=1.0)
    return loss


def make_fedcvt_step_fn(
    extractors: Sequence[nn.Module], classifier: nn.Module, hp: IterHParams
) -> Step:
    """SplitNN iteration + FedCVT-style cross-view expansion
    (:func:`_fedcvt_loss` at ``hp.fedcvt_threshold``). ``xs_u`` is
    required."""
    extractors = list(extractors)
    clients, server = _optimizers(extractors, classifier, hp)

    def step(xs, y, xs_u, commit=True):
        with torch.set_grad_enabled(commit):
            loss = _fedcvt_loss(
                lambda k, x: extractors[k](x), classifier, xs, y, xs_u, hp.fedcvt_threshold
            )
        if commit:
            _joint_update(loss, [*clients, server])
        return loss.detach()

    return step


def make_fedbcd_step_fn(
    extractors: Sequence[nn.Module], classifier: nn.Module, hp: IterHParams, q: int
) -> Step:
    """One FedBCD-p communication round: fresh reps up and rep-gradients
    ∂L/∂H down once, then ``q`` local updates, each client on the surrogate
    ``Σ g ⊙ f_k(x; θ)`` with g fixed at round entry, the server on the
    round-entry reps. Returns the round-entry loss."""
    extractors = list(extractors)
    clients, server = _optimizers(extractors, classifier, hp)

    def step(xs, y, xs_u=None, commit=True):
        del xs_u
        with torch.no_grad():
            reps = [e(x) for e, x in zip(extractors, xs)]
            if not commit:
                return _joint_loss(reps, classifier, y)
        leaves = [r.requires_grad_(True) for r in reps]
        loss = _joint_loss(leaves, classifier, y)
        g_reps = torch.autograd.grad(loss, leaves)
        for e, opt, x, g in zip(extractors, clients, xs, g_reps):
            for _ in range(q):
                surrogate = (g * e(x)).sum()
                opt.step(torch.autograd.grad(surrogate, opt.params))
        stale = concat_reps([r.detach() for r in reps])
        for _ in range(q):
            loss_s = cross_entropy(classifier(stale), y).mean()
            server.step(torch.autograd.grad(loss_s, server.params))
        return loss.detach()

    return step


def build_iteration_schedule(seed: int, n: int, batch_size: int, iterations: int) -> np.ndarray:
    """(S, bs) int64 minibatch indices: shuffled epochs seeded ``seed + e``,
    drop-remainder, cut to exactly ``iterations`` rows (the reference's)."""
    bs = min(batch_size, n)
    if iterations <= 0:
        return np.zeros((0, bs), np.int64)
    rows: List[np.ndarray] = []
    e = 0
    while len(rows) < iterations:
        for b in epoch_batches(n, bs, seed + e):
            rows.append(b)
            if len(rows) == iterations:
                break
        e += 1
    return np.stack(rows).astype(np.int64)


def build_unaligned_schedule(
    seed: int, pool_sizes: Sequence[int], batch_size: int, iterations: int
) -> Tuple[np.ndarray, ...]:
    """Per-party (S, bs) int64 uniform draws from each private pool, from one
    ``RandomState(seed)`` in party order (FedCVT's unaligned batches). An
    empty pool draws nothing and gives (S, 0) rows."""
    rng = np.random.RandomState(seed)
    return tuple(
        np.zeros((iterations, 0), np.int64)
        if n_u == 0
        else rng.randint(0, n_u, size=(iterations, batch_size)).astype(np.int64)
        for n_u in pool_sizes
    )


def run_iterative_session(
    step: Step,
    xs: Sequence[torch.Tensor],
    y: torch.Tensor,
    schedule: np.ndarray,
    xs_u: Optional[Sequence[torch.Tensor]] = None,
    u_schedules: Optional[Sequence[np.ndarray]] = None,
    active_steps: Optional[int] = None,
) -> torch.Tensor:
    """Run ``step`` over every row of ``schedule`` (and, with ``xs_u``, the
    matching rows of ``u_schedules``); returns the (S,) losses on y's
    device. With ``active_steps`` only the first ``active_steps`` steps
    commit: each later step computes its loss at the frozen state (the
    reference's stalled round loop) and updates nothing."""
    dev = y.device
    idx = torch.from_numpy(schedule).to(dev)
    u_idx = None if xs_u is None else [torch.from_numpy(u).to(dev) for u in u_schedules]
    losses = []
    for i in range(idx.shape[0]):
        il = idx[i]
        xub = None if xs_u is None else [xu[ui[i]] for xu, ui in zip(xs_u, u_idx)]
        commit = active_steps is None or i < active_steps
        losses.append(step([x[il] for x in xs], y[il], xub, commit=commit))
    return torch.stack(losses) if losses else torch.zeros(0, device=dev)


# ------------------------------------------------------------ the seed fold
KINDS = ("splitnn", "fedcvt", "fedbcd")

# Where "auto" stacks (PERF.md §5, benchmarks/torch_iterative_fold.py on an
# NVIDIA H100 80GB HBM3): a stacked step costs 1-4 one-entry loop steps of
# host time, nearly flat in the width. Loop ms over stacked ms at two entries: SplitNN 0.69-0.96,
# FedCVT 0.83-0.87 (FedBCD 1.00-1.62); at three 1.01-2.08; from four the
# stack wins on every cell measured, the CNN scenarios too (MLP 1.41-2.51,
# CNN 1.13-1.63 at E = 4; MLP 5.47-17.28 at E = 36, CNN 1.90-2.64 at E = 8).
STACK_MIN_ENTRIES = 4


def stack_pays(num_entries: int) -> bool:
    """Whether ``"auto"`` stacks ``num_entries`` entries' sessions: at
    least :data:`STACK_MIN_ENTRIES` of them, whatever their extractors."""
    return num_entries >= STACK_MIN_ENTRIES


def resolve_mode(mode: str, stack: bool = True) -> str:
    """The path a requested engine mode takes: ``"vmap"`` (the stacked
    session; the reference's ``"scan"`` reads as it) or ``"python"`` (the
    per-entry loop). ``"auto"`` takes the stack where ``stack`` says it
    pays (:func:`stack_pays`)."""
    if mode == "python":
        return "python"
    if mode in ("vmap", "scan"):
        return "vmap"
    if mode == "auto":
        return "vmap" if stack else "python"
    raise ValueError(f"unknown iterative engine mode {mode!r}")


def session_cache_key(
    kind: str, party_specs: Sequence, classifier_spec, hp: IterHParams, q: Optional[int] = None
) -> tuple:
    """THE cache key of one step kind ("splitnn" | "fedcvt" | "fedbcd"):
    each party's and the classifier's spec (``sessions.module_spec``), the
    hyper-parameters, and Q for FedBCD. No batch width, no data shape: the
    width-1 session and every fold share it."""
    key = (kind, tuple(party_specs), classifier_spec, hp)
    return key if q is None else key + (int(q),)


def session_cache_stats() -> Dict[str, int]:
    """Hits and misses of the ``"iterative"`` domain."""
    return sessions.session_cache_stats("iterative")


def clear_session_cache() -> None:
    """Clears the whole engine-wide cache (every domain), as the
    reference's does; the per-domain counters reset with it."""
    sessions.clear_session_cache()


class StackedIterStep:
    """One built stacked step of ``kind``: each party's extractor and the
    classifier as functional losses over meta templates of their specs,
    ``vmap``ped over the entry axis. Parties keep their own templates, so
    parties of different input widths fold: an entry axis only needs the
    same shapes at the same party across entries.

    :meth:`step` takes the stacked leaves (:meth:`param_lists` order:
    party 0's extractor … party K−1's, then the classifier), their momentum
    traces and one minibatch of every entry; it updates leaves and traces
    in place (``optim.clipped_sgd_stacked_``, unclipped, client and server
    learning rates each on its own leaves, an entry whose ``commit`` is
    False keeping both) and returns the (E,) losses. :meth:`loop_step` is
    the same kind's one-entry step over live modules (the ``"python"``
    path)."""

    def __init__(self, kind: str, party_specs, feature_shapes, classifier_spec, hp: IterHParams, q=None):
        if kind not in KINDS:
            raise ValueError(f"unknown iterative step kind {kind!r}")
        with torch.device("meta"):
            exts = [s.build(shape) for s, shape in zip(party_specs, feature_shapes)]
            clf = classifier_spec.build((sum(s.rep_dim for s in party_specs),))
        self.kind, self.hp, self.q = kind, hp, q
        self.ext_names = [[n for n, _ in e.named_parameters()] for e in exts]
        self.clf_names = [n for n, _ in clf.named_parameters()]
        self.num_client_leaves = sum(len(n) for n in self.ext_names)
        ext_fns = [_functional(e) for e in exts]
        clf_fn = _functional(clf)

        def reps_of(ext_p, xs):
            return [f(p, x) for f, p, x in zip(ext_fns, ext_p, xs)]

        def rep_loss(reps, clf_p, y):
            return _joint_loss(reps, lambda h: clf_fn(clf_p, h), y)

        def joint(ext_p, clf_p, xs, y):
            return rep_loss(reps_of(ext_p, xs), clf_p, y)

        def cross_view(ext_p, clf_p, xs, y, xs_u):
            return _fedcvt_loss(
                lambda k, x: ext_fns[k](ext_p[k], x),
                lambda h: clf_fn(clf_p, h),
                xs, y, xs_u, hp.fedcvt_threshold,
            )

        def local(ext_p, clf_p, g_reps, reps, xs, y):
            # the clients' surrogates Σ_k ⟨g_k, f_k(x_k; θ_k)⟩ and the server's
            # loss on the stale reps: independent terms, so each leaf's
            # gradient is its own term's, as in separate backwards
            surrogate = sum((g * r).sum() for g, r in zip(g_reps, reps_of(ext_p, xs)))
            return surrogate + rep_loss(reps, clf_p, y)

        if kind == "splitnn":
            self._grad = vmap(grad_and_value(joint, argnums=(0, 1)))
        elif kind == "fedcvt":
            self._grad = vmap(grad_and_value(cross_view, argnums=(0, 1)))
        else:
            self._reps = vmap(reps_of)
            self._rep_grad = vmap(grad_and_value(rep_loss))
            self._local_grad = vmap(grad(local, argnums=(0, 1)))

    def loop_step(self, extractors: Sequence[nn.Module], classifier: nn.Module) -> Step:
        """This kind's one-entry step over live modules."""
        if self.kind == "splitnn":
            return make_splitnn_step_fn(extractors, classifier, self.hp)
        if self.kind == "fedcvt":
            return make_fedcvt_step_fn(extractors, classifier, self.hp)
        return make_fedbcd_step_fn(extractors, classifier, self.hp, self.q)

    def param_lists(self, models) -> List[List[torch.Tensor]]:
        """Each entry's (extractors, classifier) leaves in the step's order."""
        out = []
        for exts, clf in models:
            leaves = []
            for e, names in zip(exts, self.ext_names):
                own = dict(e.named_parameters())
                leaves += [own[n] for n in names]
            own = dict(clf.named_parameters())
            out.append(leaves + [own[n] for n in self.clf_names])
        return out

    def views(self, flat: Sequence[torch.Tensor]) -> tuple:
        """The stacked leaves as the functional losses take them: one name →
        leaf dict a party, and the classifier's."""
        ext_p, start = [], 0
        for names in self.ext_names:
            ext_p.append(dict(zip(names, flat[start : start + len(names)])))
            start += len(names)
        return ext_p, dict(zip(self.clf_names, flat[start:]))

    def step(self, flat, trace, views, xs, y, xs_u=None, commit=None) -> torch.Tensor:
        """One step (FedBCD: one round of Q local updates a side) of every
        entry; ``views`` is :meth:`views` of ``flat``, ``commit`` (E,) bool
        or None (every entry commits)."""
        ext_p, clf_p = views
        if self.kind == "fedbcd":
            reps = self._reps(ext_p, xs)
            g_reps, loss = self._rep_grad(reps, clf_p, y)
            for _ in range(self.q):  # local update j of every client and of the server
                self._update(flat, trace, self._local_grad(ext_p, clf_p, g_reps, reps, xs, y), commit)
            return loss
        args = (ext_p, clf_p, xs, y) + ((xs_u,) if self.kind == "fedcvt" else ())
        grads, loss = self._grad(*args)
        self._update(flat, trace, grads, commit)
        return loss

    def _update(self, flat, trace, grads, commit) -> None:
        """The momentum step of the clients' leaves at the client rate and of
        the classifier's at the server rate; ``grads`` = (per-party dicts,
        the classifier's dict)."""
        hp, nc = self.hp, self.num_client_leaves
        g_ext, g_clf = grads
        g = [g_[n] for g_, names in zip(g_ext, self.ext_names) for n in names]
        clipped_sgd_stacked_(flat[:nc], trace[:nc], g, hp.client_lr, hp.momentum, None, commit)
        g = [g_clf[n] for n in self.clf_names]
        clipped_sgd_stacked_(flat[nc:], trace[nc:], g, hp.server_lr, hp.momentum, None, commit)


def _stack_refusal(params, xs, y, schedules, xs_u, u_schedules) -> Optional[str]:
    """Why the entries cannot share one stack (None when they can): each
    leaf, each party's data and each schedule of one shape, dtype and
    device across the entries."""

    def signature(ts) -> tuple:
        return tuple((tuple(t.shape), t.dtype, str(getattr(t, "device", "cpu"))) for t in ts)

    def ragged(what: str, per_entry) -> Optional[str]:
        if len({signature(ts) for ts in per_entry}) == 1:
            return None
        return f"the entries' {what} differ in shape, dtype or device"

    checks = [("parameters", params), ("aligned rows", xs), ("labels", [[t] for t in y]),
              ("schedules", [[s] for s in schedules])]
    if xs_u is not None:
        checks += [("private pools", xs_u), ("unaligned schedules", u_schedules)]
    for what, per_entry in checks:
        reason = ragged(what, per_entry)
        if reason is not None:
            return reason
    return None


def _stack_party_data(per_entry: Sequence[Sequence[torch.Tensor]]) -> List[torch.Tensor]:
    """[[entry 0's party 0..K−1], …] → one (E, n, …) stack a party. Parties
    may differ in width: each stacks only across entries."""
    return [torch.stack(list(col)) for col in zip(*per_entry)]


def _entry_leaves(models) -> List[List[torch.Tensor]]:
    """Each entry's extractor and classifier leaves, in module order (what
    :func:`_stack_refusal` compares before any step is built)."""
    return [[p for m in (*exts, clf) for p in m.parameters()] for exts, clf in models]


def run_iterative_session_seeds(
    key: tuple,
    build: Callable[[], StackedIterStep],
    models: Sequence[Tuple[Sequence[nn.Module], nn.Module]],
    xs: Sequence[Sequence[torch.Tensor]],
    y: Sequence[torch.Tensor],
    schedules: Sequence[np.ndarray],
    mode: str = "auto",
    xs_u: Optional[Sequence[Sequence[torch.Tensor]]] = None,
    u_schedules: Optional[Sequence[Sequence[np.ndarray]]] = None,
    active_steps: Optional[Sequence[Optional[int]]] = None,
    mesh=None,
) -> Tuple[torch.Tensor, str]:
    """E entries' sessions of one step kind; trains each entry's modules
    (``models[e]``: its party extractors and classifier) in place and
    returns the (E, iters) losses on the device and the path that ran.

    Entry e runs ``schedules[e]`` over its parties' aligned rows ``xs[e]``
    and labels ``y[e]`` (FedCVT: and ``u_schedules[e]`` over ``xs_u[e]``),
    committing only its first ``active_steps[e]`` steps (None: all): a
    stalled entry computes every later step, its loss at the frozen state,
    and commits neither parameters nor momentum.

    The built step is served from ``engine.sessions`` under ``key``
    (``build`` on a miss), whichever path runs. ``mode``: ``"vmap"`` runs
    one stacked session: the data go on the device once as (E, n, d)
    stacks a party, the schedules as (E, iters, bs) index tensors and the
    horizons as an (E, iters) commit mask, a step gathers its minibatches
    with ``x[rows, idx[:, i]]``, and no step reads a value back to the
    host; entries that cannot share one stack raise. ``"python"`` runs
    :func:`run_iterative_session` once an entry. ``"auto"`` stacks where
    :func:`stack_pays`.

    A ``mesh`` (``engine.parallel``) shards the stacked session: the
    entries are padded to a multiple of its slots with copies of entry 0
    (its modules, data, schedules and horizon), each slot keeps its slice's
    leaves, momentum, data, index tensors and commit mask on its device for
    the whole session, every step launches each slot's step in turn, and
    only the real entries are written back; the key gains
    ``parallel.mesh_key``. The loop has no stacked axis and ignores it."""
    num = len(models)
    has_u = xs_u is not None
    refusal = _stack_refusal(_entry_leaves(models), xs, y, schedules, xs_u, u_schedules)
    path = resolve_mode(mode, refusal is None and stack_pays(num))
    if path == "vmap" and refusal is not None:
        raise ValueError(
            f"engine mode 'vmap' cannot stack these iterative sessions: {refusal}; use "
            f"mode='auto' or 'python'"
        )
    active = [None] * num if active_steps is None else list(active_steps)
    if path == "python":
        step = sessions.cached_session("iterative", key, build)
        losses = [
            run_iterative_session(
                step.loop_step(exts, clf), xs[e], y[e], schedules[e],
                xs_u[e] if has_u else None, u_schedules[e] if has_u else None, active[e],
            )
            for e, (exts, clf) in enumerate(models)
        ]
        return torch.stack(losses), path

    dev = y[0].device
    mesh = parallel.resolve_mesh(mesh, dev)
    if mesh is not None:
        key = key + (parallel.mesh_key(mesh),)
    step = sessions.cached_session("iterative", key, build)
    iters = schedules[0].shape[0]
    models, xs, y, schedules, active = (
        parallel.pad_entries(a, mesh) for a in (models, xs, y, schedules, active)
    )
    if has_u:
        xs_u, u_schedules = (parallel.pad_entries(a, mesh) for a in (xs_u, u_schedules))
    own = step.param_lists(models)  # a padded entry's are entry 0's: read, never written
    with torch.no_grad():
        flat = [torch.stack(ps) for ps in zip(*own)]
    horizon = [iters if a is None else int(a) for a in active]
    valid = (torch.arange(iters)[None, :] < torch.tensor(horizon)[:, None]).to(dev)
    stacked = (
        flat,
        _stack_party_data(xs),
        torch.stack(list(y)),
        torch.from_numpy(np.stack(schedules)).to(dev),
        _stack_party_data(xs_u) if has_u else None,
        [torch.from_numpy(np.stack(col)).to(dev) for col in zip(*u_schedules)] if has_u else None,
        valid,
    )
    width = len(horizon) // parallel.device_fold(mesh)
    slots = [
        _IterSlot(step, *part, horizon[j * width : (j + 1) * width])
        for j, part in enumerate(parallel.split_stacked(stacked, mesh))
    ]
    for i in range(iters):
        for slot in slots:
            slot.step(step, i)
    with torch.no_grad():
        flat = parallel.gather_stacked([slot.flat for slot in slots], dev)
        for e, ps in enumerate(own[:num]):  # the real entries only
            for p, col in zip(ps, flat):
                p.copy_(col[e])
    losses = parallel.gather_stacked([slot.losses for slot in slots], dev)
    return losses[:num], path


class _IterSlot:
    """One mesh slot's share of a stacked iterative session, on its device:
    its entries' stacked leaves, momentum and their views, aligned rows,
    labels, schedules (FedCVT: private pools and unaligned schedules),
    commit mask and losses. ``first_stall`` is its own entries' earliest
    horizon: before it every entry commits and no mask applies."""

    def __init__(self, step: StackedIterStep, flat, xs, y, idx, xs_u, u_idx, valid, horizon):
        self.flat, self.xs, self.y, self.idx = flat, xs, y, idx
        self.xs_u, self.u_idx, self.valid = xs_u, u_idx, valid
        self.trace = [torch.zeros_like(p, dtype=torch.float32) for p in flat]
        self.views = step.views(flat)
        self.first_stall = min(horizon)
        self.rows = torch.arange(y.shape[0], device=y.device)[:, None]
        self.losses = torch.empty(y.shape[0], idx.shape[1], device=y.device)

    def step(self, step: StackedIterStep, i: int) -> None:
        """Step ``i`` of every entry of the slot, launched and never read back."""
        rows, il = self.rows, self.idx[:, i]
        xb = [x[rows, il] for x in self.xs]
        xub = None if self.xs_u is None else [x[rows, u[:, i]] for x, u in zip(self.xs_u, self.u_idx)]
        commit = None if i < self.first_stall else self.valid[:, i]
        self.losses[:, i] = step.step(self.flat, self.trace, self.views, xb, self.y[rows, il], xub, commit)
