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
  on its own schedule.

Randomness is reproduced, not re-derived: each entry keeps its own
generators, and every draw is made in the order the single-seed loop makes
it, so a fold equals a loop of single-seed runs up to the rounding of
batched products. Built steps are cached in ``engine.sessions`` under keys
without batch width, so later seeds and scenarios add no fresh builds.
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
from repro_torch.engine import dispatch, sessions
from repro_torch.engine.local_ssl import (
    PartyTask,
    SSLHParams,
    _functional,
    draw_session,
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
) -> Tuple[List[List[Dict[str, float]]], List[str]]:
    """Every entry's every party's SSL session; returns per-entry metric
    lists and the path each entry trained on.

    Entry e's parties draw their sessions from ``generators[e]`` one after
    another, as the single-seed loop does, before anything trains. One
    entry is :func:`local_ssl.train_clients_ssl` itself. Several entries
    fold into one stacked session when all their tasks are homogeneous,
    under ``mode`` "vmap" or where ``local_ssl.stack_pays`` under "auto";
    else each entry runs on its own."""
    if mode not in ("auto", "vmap", "python"):
        raise ValueError(f"unknown engine mode {mode!r}")
    num_seeds = len(tasks_per_seed)
    draws = [
        [draw_session(t, hp, gen) for t in tasks]
        for tasks, gen in zip(tasks_per_seed, generators)
    ]
    if num_seeds == 1:
        metrics, path = train_clients_ssl(tasks_per_seed[0], hp, seeds0_per_seed[0], draws[0], mode)
        return [metrics], [path]
    k = len(tasks_per_seed[0])
    flat = flatten_seed_tasks(tasks_per_seed)
    homogeneous = len({len(t) for t in tasks_per_seed}) == 1 and tasks_are_homogeneous(flat)
    if mode == "vmap" and not homogeneous:
        raise ValueError(
            "engine mode 'vmap' requires homogeneous party tasks across every entry of "
            "the fold; use mode='auto' or 'python'"
        )
    pays = stack_pays(sessions.module_spec(flat[0].extractor), k, num_seeds)
    if homogeneous and (mode == "vmap" or (mode == "auto" and pays)):
        metrics = train_parties_ssl_stacked(
            flat, hp, flatten_seed_tasks(seeds0_per_seed), flatten_seed_tasks(draws)
        )
        return unflatten_seed_results(metrics, num_seeds, k), ["vmap"] * num_seeds
    out, paths = [], []
    for tasks, seeds0, d in zip(tasks_per_seed, seeds0_per_seed, draws):
        metrics, path = train_clients_ssl(tasks, hp, seeds0, d, mode)
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

    def search(stacked: torch.Tensor, draws: clustering.SeedingDraws) -> torch.Tensor:
        return dispatch.pseudo_labels_batched(stacked, num_classes, iters, restarts, draws=draws)

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
) -> List[List[torch.Tensor]]:
    """Step ③ for every entry's K gradient matrices → per-entry lists of
    pseudo-labels (N,) int64.

    When all S·C·K matrices share one shape they are ONE search: each
    entry's k-means++ draws come from its own generator, (K, R) at a time as
    its single-seed run draws them, and every assignment of the search is
    one ``kmeans`` launch over all S·C·K·R restarts. Otherwise each entry
    runs on its own (:func:`_entry_pseudo_labels`), recorded in ``info``
    (``{"fold": 1, "fallback": reason}``) and logged once; on the folded
    path ``info["fold"]`` is S·C·K."""
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
    draws = clustering.SeedingDraws(
        torch.cat([d.first for d in per_entry]), torch.cat([d.u for d in per_entry])
    )
    search = sessions.cached_session(
        "kmeans",
        ("search", num_classes, kmeans_iters, restarts),
        lambda: _search_fn(num_classes, kmeans_iters, restarts),
    )
    labels = search(torch.stack(flat).float(), draws)
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
) -> torch.Tensor:
    """Few-shot ③' for party k over the stacked entry axis: the Eq. 10
    estimates of every missing party (one ``sdpa_estimator`` launch, see
    :func:`dispatch.estimate_missing_batched`), concatenated in party order
    with h_u in slot k, then each entry's Eq. 8-9 gate with ``servers[e]``'s
    f_c^k and f_c. ``h_u_stack`` (E, N_u, d_k), ``h_o_stacks[j]`` (E, N_o,
    d_j). Returns p̂ (E, N_u) float32; ``estimates_out`` (if given) receives
    the (E, N_u, d_j) estimates in party order."""
    ests = dispatch.estimate_missing_batched(h_u_stack, h_o_stacks, k)
    if estimates_out is not None:
        estimates_out.extend(ests)
    gate = sessions.cached_session("fewshot_gate", ("gate", float(threshold)), lambda: _gate_fn(threshold))
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
) -> None:
    """A batch of server classifier fits, trained in place: entry e fits
    ``models[e]`` on ``xs[e]``, ``ys[e]`` over ``schedules[e]`` (``server.fit``'s
    loop: clip 5.0, SGD with momentum 0.9). Entries that share a spec, data
    shapes and schedule shape train as one stacked session (domain
    ``"server_fit"``); a None schedule is a no-op fit."""
    groups: Dict[tuple, List[int]] = {}
    for e, (m, x, y, sched) in enumerate(zip(models, xs, ys, schedules)):
        if sched is None:
            continue
        spec = sessions.module_spec(m)
        groups.setdefault((spec, tuple(x.shape), tuple(y.shape), sched.shape, x.device), []).append(e)
    for (spec, xshape, _, _, dev), members in groups.items():
        step = sessions.cached_session(
            "server_fit", ("vmap", spec, float(lr)), lambda: StackedFitStep(spec, xshape[-1])
        )
        mods = [models[e] for e in members]
        params, _ = stack_module_state(mods)
        params = {k: v.detach() for k, v in params.items()}
        flat = list(params.values())
        trace = [torch.zeros_like(p, dtype=torch.float32) for p in flat]
        x = torch.stack([xs[e] for e in members]).detach()
        y = torch.stack([ys[e] for e in members])
        idx = torch.from_numpy(np.stack([schedules[e] for e in members])).to(dev)
        rows = torch.arange(len(members), device=dev)[:, None]
        for i in range(idx.shape[1]):
            g = step.grad(params, x[rows, idx[:, i]], y[rows, idx[:, i]])
            clipped_sgd_stacked_(flat, trace, list(g.values()), lr, 0.9, 5.0)
        with torch.no_grad():
            for e, m in enumerate(mods):
                for name, p in m.named_parameters():
                    p.copy_(params[name][e])
