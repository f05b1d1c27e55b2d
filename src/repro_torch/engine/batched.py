"""Seed- and scenario-batched engine execution: the folds.

Counterpart of ``repro.engine.batched``. The stacked axis is anonymous:
nothing in a stacked step knows that entry ``i`` is "party i mod K of seed
i // K", so S seeds × C scenarios × K parties ride one axis:

* :func:`train_clients_ssl_seeds`: every entry's every party's SSL session
  as one stacked session (``local_ssl.train_parties_ssl_stacked``) when the
  S·C·K tasks are homogeneous and the stack pays (``local_ssl.stack_pays``),
  else per entry;
* :func:`pseudo_labels_seeds`: step ③ over all S·C·K gradient matrices as
  one k-means search, so each Lloyd iteration is one ``kmeans`` launch over
  S·C·K·R entries. Ragged shapes fall back per entry, recorded in ``info``
  and logged once;
* :func:`fewshot_probs_seeds`: few-shot ③' for one party over the stacked
  axis (``dispatch.estimate_missing_batched``: one ``sdpa_estimator``
  launch), then the Eq. 8-9 gate per entry with that entry's classifiers;
* :func:`fit_sessions_batched`: server classifier fits stacked, each entry
  on its own schedule;
* :func:`splitnn_sessions_seeds` / :func:`fedcvt_sessions_seeds` /
  :func:`fedbcd_sessions_seeds`: the iterative baselines' sessions of every
  entry as one stacked session (``iterative.run_iterative_session_seeds``)
  where ``iterative.stack_pays``, else one after another.

Randomness is reproduced, not re-derived: each entry keeps its own
generators, and every draw is made in the order the single-seed loop makes
it, so a fold equals a loop of single-seed runs up to the rounding of
batched products. Built steps are cached in ``engine.sessions`` under keys
without batch width, so later seeds and scenarios add no fresh builds.

Every stacked stage takes a ``mesh`` (``engine.parallel``): the SSL
session, the k-means search, the Eq. 10 estimates, the server fits and
the iterative baselines' sessions then run slot by slot over the entry
axis, padded with copies of entry 0 and stripped before anything is
written back, so a sharded fold equals the unsharded one entry by entry.
The per-entry loops have no stacked axis and ignore it.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import grad, stack_module_state, vmap

from repro_torch.core import clustering
from repro_torch.engine import dispatch, parallel, sessions
from repro_torch.engine.local_ssl import (
    PartyTask,
    SSLHParams,
    _functional,
    draw_session,
    refuse_unstackable,
    stack_pays,
    tasks_are_homogeneous,
    train_clients_ssl,
    train_parties_ssl_stacked,
)
from repro_torch.optim import clipped_sgd_stacked_


def flatten_seed_tasks(tasks_per_seed: Sequence[Sequence[Any]]) -> List[Any]:
    """[[entry 0's party 0..K−1], [entry 1's …], …] → entry-major flat list."""
    return [t for seed_tasks in tasks_per_seed for t in seed_tasks]


def unflatten_seed_results(flat: Sequence[Any], num_seeds: int, num_parties: int) -> List[List[Any]]:
    """Inverse of :func:`flatten_seed_tasks` for per-task results."""
    return [list(flat[s * num_parties : (s + 1) * num_parties]) for s in range(num_seeds)]


# ------------------------------------------------------------ SSL: the fold
def train_clients_ssl_seeds(
    tasks_per_seed: Sequence[Sequence[PartyTask]],
    hp: SSLHParams,
    seeds0_per_seed: Sequence[Sequence[int]],
    generators: Sequence[torch.Generator],
    mode: str = "auto",
    mesh=None,
) -> Tuple[List[List[Dict[str, float]]], List[str]]:
    """Every entry's every party's SSL session; returns per-entry metric
    lists and the path each entry trained on.

    Entry e's parties draw their sessions from ``generators[e]`` one after
    another, as the single-seed loop does, before anything trains. One
    entry is :func:`local_ssl.train_clients_ssl` itself. Several entries
    fold into one stacked session when all their tasks are homogeneous,
    under ``mode`` "vmap" or where ``local_ssl.stack_pays`` (of the real
    entries) under "auto"; else each entry runs on its own. A ``mesh``
    shards whichever stacked session runs."""
    if mode not in ("auto", "vmap", "python"):
        raise ValueError(f"unknown engine mode {mode!r}")
    num_seeds = len(tasks_per_seed)
    draws = [
        [draw_session(t, hp, gen) for t in tasks]
        for tasks, gen in zip(tasks_per_seed, generators)
    ]
    if num_seeds == 1:
        metrics, path = train_clients_ssl(
            tasks_per_seed[0], hp, seeds0_per_seed[0], draws[0], mode, mesh
        )
        return [metrics], [path]
    k = len(tasks_per_seed[0])
    flat = flatten_seed_tasks(tasks_per_seed)
    refuse_unstackable(flat, mode)
    homogeneous = len({len(t) for t in tasks_per_seed}) == 1 and tasks_are_homogeneous(flat)
    if mode == "vmap" and not homogeneous:
        raise ValueError(
            "engine mode 'vmap' requires homogeneous party tasks across every entry of "
            "the fold; use mode='auto' or 'python'"
        )
    pays = stack_pays(sessions.module_spec(flat[0].extractor), k, num_seeds)
    if homogeneous and (mode == "vmap" or (mode == "auto" and pays)):
        metrics = train_parties_ssl_stacked(
            flat, hp, flatten_seed_tasks(seeds0_per_seed), flatten_seed_tasks(draws), mesh
        )
        return unflatten_seed_results(metrics, num_seeds, k), ["vmap"] * num_seeds
    out, paths = [], []
    for tasks, seeds0, d in zip(tasks_per_seed, seeds0_per_seed, draws):
        metrics, path = train_clients_ssl(tasks, hp, seeds0, d, mode, mesh)
        out.append(metrics)
        paths.append(path)
    return out, paths


# --------------------------------------------------- k-means: one search
_log = logging.getLogger(__name__)
_ragged_fallback_logged = False


def _note_ragged_fallback(what: str) -> None:
    """Log the per-entry fallback once a process; rows record each one."""
    global _ragged_fallback_logged
    if not _ragged_fallback_logged:
        _ragged_fallback_logged = True
        _log.warning(
            "%s: ragged entry shapes, per-entry fallback (fold width 1); "
            "diagnostics record kernel_fold=1",
            what,
        )


def _search_fn(num_classes: int, iters: int, restarts: int) -> Callable:
    """Step ③'s k-means search over a stack: labels of (B, N, d) gradients."""

    def search(stacked: torch.Tensor, draws: clustering.SeedingDraws, mesh) -> torch.Tensor:
        return dispatch.pseudo_labels_batched(
            stacked, num_classes, iters, restarts, draws=draws, mesh=mesh
        )

    return search


def _entry_pseudo_labels(
    grads: Sequence[torch.Tensor], num_classes: int, iters: int, restarts: int, gen
) -> List[torch.Tensor]:
    """One entry's step ③ as the single-seed run does it: one batched search
    when its parties' gradients share a shape, else one search a party."""
    if len({tuple(g.shape) for g in grads}) == 1:
        stacked = torch.stack(list(grads)).float()
        return list(dispatch.pseudo_labels_batched(stacked, num_classes, iters, restarts, generator=gen))
    return [dispatch.pseudo_labels(g.float(), num_classes, iters, restarts, generator=gen) for g in grads]


def pseudo_labels_seeds(
    grads_per_seed: Sequence[Sequence[torch.Tensor]],
    num_classes: int,
    kmeans_iters: int = 25,
    restarts: int = 4,
    *,
    generators: Sequence[torch.Generator],
    info: Optional[dict] = None,
    mesh=None,
) -> List[List[torch.Tensor]]:
    """Step ③ for every entry's K gradient matrices → per-entry lists of
    pseudo-labels (N,) int64.

    When all S·C·K matrices share one shape they are ONE search: each
    entry's k-means++ draws come from its own generator, (K, R) at a time as
    its single-seed run draws them, and every assignment of the search is
    one ``kmeans`` launch over all S·C·K·R restarts. Otherwise each entry
    runs on its own (:func:`_entry_pseudo_labels`), recorded in ``info``
    (``{"fold": 1, "fallback": reason}``) and logged once; on the folded
    path ``info["fold"]`` is S·C·K. A ``mesh`` shards the one search: the
    S·C·K matrices and their draws are padded with copies of the first's,
    each slot searches its slice, and the labels are stripped back."""
    flat = flatten_seed_tasks(grads_per_seed)
    num_parties = len(grads_per_seed[0])
    uniform = len({len(g) for g in grads_per_seed}) == 1
    if not uniform or len({tuple(g.shape) for g in flat}) != 1:
        if info is not None:
            info["fold"] = 1
            info["fallback"] = "ragged gradient shapes"
        _note_ragged_fallback("pseudo_labels_seeds")
        return [
            _entry_pseudo_labels(g, num_classes, kmeans_iters, restarts, gen)
            for g, gen in zip(grads_per_seed, generators)
        ]
    n, dev = flat[0].shape[0], flat[0].device
    per_entry = [
        clustering.draw_seeding(gen, num_parties, restarts, n, num_classes, dev) for gen in generators
    ]
    mesh = parallel.resolve_mesh(mesh, dev)
    pad = parallel.pad_width(len(flat), mesh)
    draws = clustering.SeedingDraws(
        torch.cat([d.first for d in per_entry]), torch.cat([d.u for d in per_entry])
    )
    search = sessions.cached_session(
        "kmeans",
        ("search", num_classes, kmeans_iters, restarts, parallel.mesh_key(mesh)),
        lambda: _search_fn(num_classes, kmeans_iters, restarts),
    )
    stacked = parallel.pad_stacked(torch.stack(flat).float(), pad)
    labels = parallel.strip_stacked(search(stacked, parallel.pad_stacked(draws, pad), mesh), len(flat))
    if info is not None:
        info["fold"] = len(flat)
    return unflatten_seed_results(list(labels), len(grads_per_seed), num_parties)


# ------------------------------------------------ few-shot ③': the fold
def _gate_fn(threshold: float) -> Callable:
    """One entry's Eq. 8-9 gate of party k at ``threshold``."""

    def gate(server: Any, k: int, h_u_k: torch.Tensor, ests: List[torch.Tensor]) -> torch.Tensor:
        return dispatch.gate(server, k, h_u_k, ests, threshold)

    return gate


def fewshot_probs_seeds(
    servers: Sequence[Any],
    k: int,
    h_u_stack: torch.Tensor,
    h_o_stacks: Sequence[torch.Tensor],
    threshold: float,
    estimates_out: Optional[list] = None,
    mesh=None,
) -> torch.Tensor:
    """Few-shot ③' for party k over the stacked entry axis: the Eq. 10
    estimates of every missing party (one ``sdpa_estimator`` launch, see
    :func:`dispatch.estimate_missing_batched`), concatenated in party order
    with h_u in slot k, then each entry's Eq. 8-9 gate with ``servers[e]``'s
    f_c^k and f_c. ``h_u_stack`` (E, N_u, d_k), ``h_o_stacks[j]`` (E, N_o,
    d_j). Returns p̂ (E, N_u) float32; ``estimates_out`` (if given) receives
    the (E, N_u, d_j) estimates in party order.

    A ``mesh`` shards the estimates: E is padded with copies of entry 0,
    each slot estimates its slice, and the estimates are stripped back to E
    on this device before the gates, which run entry by entry here."""
    num_entries = h_u_stack.shape[0]
    mesh = parallel.resolve_mesh(mesh, h_u_stack.device)
    pad = parallel.pad_width(num_entries, mesh)
    ests = dispatch.estimate_missing_batched(
        parallel.pad_stacked(h_u_stack, pad), parallel.pad_stacked(list(h_o_stacks), pad), k, mesh
    )
    ests = parallel.strip_stacked(ests, num_entries)
    if estimates_out is not None:
        estimates_out.extend(ests)
    gate = sessions.cached_session(
        "fewshot_gate",
        ("gate", float(threshold), parallel.mesh_key(mesh)),
        lambda: _gate_fn(threshold),
    )
    probs = [gate(srv, k, h_u_stack[e], [est[e] for est in ests]) for e, srv in enumerate(servers)]
    return torch.stack(probs)


# ---------------------------------------------- server fits: stacked
class StackedFitStep:
    """One built stacked fit step: mean cross-entropy of a classifier over
    a template of its spec, ``vmap(grad)`` over the entry axis."""

    def __init__(self, spec, in_dim: int) -> None:
        with torch.device("meta"):
            self.model = spec.build((in_dim,))
        apply = _functional(self.model)

        def loss(params, x, y):
            return F.cross_entropy(apply(params, x), y.long(), reduction="none").mean()

        self.grad = vmap(grad(loss))


def fit_sessions_batched(
    models: Sequence[nn.Module],
    xs: Sequence[torch.Tensor],
    ys: Sequence[torch.Tensor],
    schedules: Sequence[Optional[np.ndarray]],
    lr: float,
    mesh=None,
) -> None:
    """A batch of server classifier fits, trained in place: entry e fits
    ``models[e]`` on ``xs[e]``, ``ys[e]`` over ``schedules[e]`` (``server.fit``'s
    loop: clip 5.0, SGD with momentum 0.9). Entries that share a spec, data
    shapes and schedule shape train as one stacked session (domain
    ``"server_fit"``); a None schedule is a no-op fit.

    A ``mesh`` shards each session: its entries are padded with copies of
    the first (module, data and schedule), each slot keeps its slice's
    parameters and momentum on its device for the whole session, and only
    the real entries are written back."""
    groups: Dict[tuple, List[int]] = {}
    for e, (m, x, y, sched) in enumerate(zip(models, xs, ys, schedules)):
        if sched is None:
            continue
        spec = sessions.module_spec(m)
        groups.setdefault((spec, tuple(x.shape), tuple(y.shape), sched.shape, x.device), []).append(e)
    for (spec, xshape, _, _, dev), members in groups.items():
        mesh = parallel.resolve_mesh(mesh, dev)
        step = sessions.cached_session(
            "server_fit",
            ("vmap", spec, float(lr), parallel.mesh_key(mesh)),
            lambda: StackedFitStep(spec, xshape[-1]),
        )
        padded = parallel.pad_entries(members, mesh)
        params, _ = stack_module_state([models[e] for e in padded])
        params = {k: v.detach() for k, v in params.items()}
        x = torch.stack([xs[e] for e in padded]).detach()
        y = torch.stack([ys[e] for e in padded])
        idx = torch.from_numpy(np.stack([schedules[e] for e in padded])).to(dev)
        slots = parallel.split_stacked((params, x, y, idx), mesh)
        traces = [[torch.zeros_like(p, dtype=torch.float32) for p in sp.values()] for sp, *_ in slots]
        rows = [torch.arange(sx.shape[0], device=sx.device)[:, None] for _, sx, _, _ in slots]
        for i in range(idx.shape[1]):
            for (sp, sx, sy, sidx), trace, r in zip(slots, traces, rows):
                g = step.grad(sp, sx[r, sidx[:, i]], sy[r, sidx[:, i]])
                clipped_sgd_stacked_(list(sp.values()), trace, list(g.values()), lr, 0.9, 5.0)
        params = parallel.gather_stacked([sp for sp, *_ in slots], dev)
        with torch.no_grad():
            for e, member in enumerate(members):  # the real entries only
                for name, p in models[member].named_parameters():
                    p.copy_(params[name][e])


# ------------------------------------------ iterative baselines: the fold
def _assert_entry_models_equal(extractors_per_entry, classifiers) -> tuple:
    """Every entry's party specs and classifier spec equal, party by party
    (one built step serves the fold); returns them."""
    specs0 = tuple(sessions.module_spec(e) for e in extractors_per_entry[0])
    clf0 = sessions.module_spec(classifiers[0])
    for exts, clf in zip(extractors_per_entry[1:], classifiers[1:]):
        if tuple(sessions.module_spec(e) for e in exts) != specs0 or sessions.module_spec(clf) != clf0:
            raise ValueError(
                "seed-batched iterative sessions require semantically equal party extractors "
                "and server classifier across every entry of the fold"
            )
    if None in specs0 or clf0 is None:
        raise ValueError("iterative sessions need modules an ExtractorSpec describes")
    return specs0, clf0


def _iterative_sessions(
    kind, extractors_per_entry, classifiers, hp, xs_per_entry, ys, schedules, mode,
    q=None, xs_u_per_entry=None, u_schedules=None, active_steps=None, mesh=None,
) -> Tuple[torch.Tensor, str]:
    from repro_torch.engine import iterative  # deferred: iterative imports core, core this module

    specs, clf_spec = _assert_entry_models_equal(extractors_per_entry, classifiers)
    shapes = [tuple(x.shape[1:]) for x in xs_per_entry[0]]
    return iterative.run_iterative_session_seeds(
        iterative.session_cache_key(kind, specs, clf_spec, hp, q),
        lambda: iterative.StackedIterStep(kind, specs, shapes, clf_spec, hp, q),
        list(zip(extractors_per_entry, classifiers)),
        xs_per_entry, ys, schedules, mode, xs_u_per_entry, u_schedules, active_steps, mesh,
    )


def splitnn_sessions_seeds(
    extractors_per_entry, classifiers, hp, xs_per_entry, ys, schedules, mode="auto", active_steps=None,
    mesh=None,
) -> Tuple[torch.Tensor, str]:
    """E entries of one SplitNN session as one fold, trained in place.
    ``extractors_per_entry[e]`` / ``classifiers[e]`` are entry e's modules
    (equal specs across entries, :func:`_assert_entry_models_equal`),
    ``xs_per_entry[e]`` / ``ys[e]`` / ``schedules[e]`` its data and
    minibatch schedule, ``active_steps[e]`` its commit horizon (None: every
    step), ``mesh`` the slots of the stacked session (the loop ignores it).
    Returns the (E, iters) losses and the path that ran."""
    return _iterative_sessions(
        "splitnn", extractors_per_entry, classifiers, hp, xs_per_entry, ys, schedules, mode,
        active_steps=active_steps, mesh=mesh,
    )


def fedcvt_sessions_seeds(
    extractors_per_entry, classifiers, hp, xs_per_entry, ys, schedules, xs_u_per_entry,
    u_schedules, mode="auto", active_steps=None, mesh=None,
) -> Tuple[torch.Tensor, str]:
    """E entries of one FedCVT-style session as one fold; each entry's
    private pools and unaligned schedules ride the same entry axis. As
    :func:`splitnn_sessions_seeds` otherwise."""
    return _iterative_sessions(
        "fedcvt", extractors_per_entry, classifiers, hp, xs_per_entry, ys, schedules, mode,
        xs_u_per_entry=xs_u_per_entry, u_schedules=u_schedules, active_steps=active_steps,
        mesh=mesh,
    )


def fedbcd_sessions_seeds(
    extractors_per_entry, classifiers, hp, q, xs_per_entry, ys, schedules, mode="auto",
    active_steps=None, mesh=None,
) -> Tuple[torch.Tensor, str]:
    """E entries of one FedBCD-p session (Q local updates a round) as one
    fold; ``active_steps`` counts rounds. As :func:`splitnn_sessions_seeds`
    otherwise: returns the (E, rounds) losses and the path."""
    return _iterative_sessions(
        "fedbcd", extractors_per_entry, classifiers, hp, xs_per_entry, ys, schedules, mode,
        q=q, active_steps=active_steps, mesh=mesh,
    )
