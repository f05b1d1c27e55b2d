"""The iterative baselines' seed fold in the port.

Counterpart of the iterative half of ``tests/test_seed_batched.py`` and of
``repro.engine.batched``'s ``*_sessions_seeds``. What is held here:

* the stacked session (``batched.{splitnn,fedcvt,fedbcd}_sessions_seeds``,
  ``engine_mode="vmap"``) against the reference's (``mode="scan"``) at
  S = 2, from the reference's own initial parameters carried across with
  ``repro_torch.bridge``: commit horizons 10 and 6, FedCVT with one pool
  empty, FedBCD at Q = 5; every loss and every parameter at 1e-5;
* ``run_seeds`` of ``run_vanilla`` / ``run_fedcvt`` / ``run_fedbcd`` equals
  the single-seed runners at 1e-5 on the metric and every parameter, with
  byte-identical ledgers, equal to the reference's ``run_seeds`` ledgers;
* more seeds build no fresh ``"iterative"`` session;
* the chained few-shot + finetune fold equals ``run_few_shot_finetune``
  per seed, with 5 + 2·20 comm times;
* FedCVT on full-overlap parties (empty pools: zero-row batches) folds;
* which path ``"auto"`` / ``"vmap"`` / ``"python"`` takes (``"auto"``
  stacks four entries or more, ``iterative.stack_pays``), and ``"vmap"`` on
  entries that cannot stack raising.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import scenarios as jscen
from repro.core import IterativeConfig as RefIterConfig
from repro.core import baselines as jbase
from repro.core import run_fedbcd as ref_fedbcd
from repro.core import run_fedcvt as ref_fedcvt
from repro.core import run_vanilla as ref_vanilla
from repro.core.protocol import _build_clients
from repro.core.protocol import run_seeds as ref_run_seeds
from repro.core.server import VFLServer as JServer
from repro.engine import batched as jbatched
from repro.engine import iterative as jiter
from repro_torch import bridge, scenarios
from repro_torch.core import baselines
from repro_torch.core.protocol import run_few_shot_finetune, run_seeds
from repro_torch.data import split_from_numpy
from repro_torch.engine import batched, iterative, sessions
from repro_torch.models import extractors as tx

from test_torch_catalog import events, one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_seed_fold import FAST, SEEDS, TOL, port_splits, specs_of

NAME = "hard/overlap-32"
STEPS = 10
ACTIVE = [10, 6]  # entry 1 stalls after 6 steps (FedBCD: rounds)
SEED0 = 4321  # the schedules' seed in the session tests (any integer)
Q = 5
RUNNERS = {
    "vanilla": (baselines.run_vanilla, ref_vanilla, 20),
    "fedcvt": (baselines.run_fedcvt, ref_fedcvt, 10),
    "fedbcd": (baselines.run_fedbcd, ref_fedbcd, 20),
}


def all_params(res):
    """Every leaf of a result: extractors, heads and the classifier."""
    mods = [m for c in res.clients for m in (c.extractor, c.head)] + [res.server.classifier]
    return [p for m in mods for p in m.parameters()]


def assert_same_run(got, want, tol=TOL):
    assert abs(got.metric - want.metric) <= tol
    for p, q in zip(all_params(got), all_params(want), strict=True):
        torch.testing.assert_close(p, q, atol=tol, rtol=0)
    torch.testing.assert_close(got.diagnostics["losses"], want.diagnostics["losses"], atol=tol, rtol=0)
    assert events(got.ledger) == events(want.ledger)


# ------------------------------------------- the stacked session vs the reference's
@pytest.fixture(scope="module")
def reference_entries():
    """hard/overlap-32 at seeds 0-1 and each seed's reference initial state,
    on the key split of ``baselines._seed_sessions_setup``."""
    out = []
    for s in SEEDS:
        bundle = jscen.build(NAME, seed=s)
        _, kc, ks = jax.random.split(jax.random.PRNGKey(s), 3)
        clients = _build_clients(kc, bundle.split, bundle.extractors, bundle.ssl_cfgs)
        reps0 = [c.extract(x[:2]) for c, x in zip(clients, bundle.split.aligned)]
        server = jbase._init_server(ks, JServer(num_classes=2), reps0)
        out.append((bundle, clients, server))
    return out


def _port_models(clients, server, widths):
    spec = scenarios.extractor_specs_for(scenarios.HARD_OVERLAP_32)[0]
    exts = [bridge.load_jax_params(spec.build((w,)), c.params.extractor) for c, w in zip(clients, widths)]
    clf = bridge.load_jax_params(tx.make_classifier(32, 2), server.params)
    return exts, clf


@pytest.mark.parametrize("kind", ["splitnn", "fedcvt", "fedbcd"])
def test_the_stacked_session_equals_the_references(reference_entries, kind):
    cfg = RefIterConfig(fedbcd_q=Q, fedcvt_threshold=0.75)
    hp = cfg.iter_hparams()
    splits = []
    for bundle, _, _ in reference_entries:
        split = bundle.split
        if kind == "fedcvt":  # party 1's pool empty: its term adds exactly 0
            split = dataclasses.replace(split, unaligned=[split.unaligned[0], split.unaligned[1][:0]])
        splits.append(split)
    scheds = [
        np.asarray(jiter.build_iteration_schedule(SEED0 + s, sp.labels.shape[0], 32, STEPS))
        for s, sp in zip(SEEDS, splits)
    ]
    u_scheds = [
        [np.asarray(u) for u in jiter.build_unaligned_schedule(
            0, [u.shape[0] for u in sp.unaligned], 32, STEPS)]
        for sp in splits
    ]
    j_exts = [[c.extractor for c in cl] for _, cl, _ in reference_entries]
    j_clfs = [srv.classifier for _, _, srv in reference_entries]
    carries = [jbase._session_carry(cl, srv, cfg) for _, cl, srv in reference_entries]
    common = dict(mode="scan", active_steps=jnp.asarray(ACTIVE, jnp.int32))
    j_xs = [sp.aligned for sp in splits]
    j_ys = [sp.labels for sp in splits]
    if kind == "splitnn":
        out, j_losses = jbatched.splitnn_sessions_seeds(
            j_exts, j_clfs, hp, carries, j_xs, j_ys, scheds, **common
        )
    elif kind == "fedcvt":
        out, j_losses = jbatched.fedcvt_sessions_seeds(
            j_exts, j_clfs, hp, carries, j_xs, j_ys, scheds, [sp.unaligned for sp in splits], u_scheds,
            **common,
        )
    else:
        out, j_losses = jbatched.fedbcd_sessions_seeds(
            j_exts, j_clfs, hp, Q, carries, j_xs, j_ys, scheds, **common
        )

    t_splits = [split_from_numpy(sp, "cpu") for sp in splits]
    models = [
        _port_models(cl, srv, [x.shape[1] for x in sp.aligned])
        for (_, cl, srv), sp in zip(reference_entries, splits)
    ]
    t_exts, t_clfs = [m[0] for m in models], [m[1] for m in models]
    t_xs = [sp.aligned for sp in t_splits]
    t_ys = [sp.labels for sp in t_splits]
    if kind == "splitnn":
        losses, path = batched.splitnn_sessions_seeds(t_exts, t_clfs, hp, t_xs, t_ys, scheds, "vmap", ACTIVE)
    elif kind == "fedcvt":
        losses, path = batched.fedcvt_sessions_seeds(
            t_exts, t_clfs, hp, t_xs, t_ys, scheds, [sp.unaligned for sp in t_splits], u_scheds,
            "vmap", ACTIVE,
        )
    else:
        losses, path = batched.fedbcd_sessions_seeds(
            t_exts, t_clfs, hp, Q, t_xs, t_ys, scheds, "vmap", ACTIVE
        )
    assert path == "vmap" and losses.shape == (2, STEPS)
    np.testing.assert_allclose(losses.numpy(), np.asarray(j_losses), atol=TOL, rtol=TOL)
    for e in range(2):
        for k, ext in enumerate(t_exts[e]):
            got, want = bridge.to_jax_params(ext), out[e][0][k].extractor
            for key in want:
                np.testing.assert_allclose(got[key], np.asarray(want[key]), atol=TOL, rtol=TOL,
                                           err_msg=f"{kind} entry {e} party {k} {key}")
        got = bridge.to_jax_params(t_clfs[e])
        for key in out[e][1]:
            np.testing.assert_allclose(got[key], np.asarray(out[e][1][key]), atol=TOL, rtol=TOL,
                                       err_msg=f"{kind} entry {e} classifier {key}")


# ------------------------------------------------- the fold vs the single-seed loop
@pytest.fixture(scope="module")
def splits():
    return port_splits(NAME)


@pytest.fixture(scope="module")
def splits4():
    return port_splits(NAME, seeds=range(4))


def fold_of(runner, splits, cfg, seeds=SEEDS, name=NAME):
    exts, ssls = specs_of(name)
    return run_seeds(runner, list(seeds), splits, [exts] * len(seeds), [ssls] * len(seeds), cfg, device="cpu")


@pytest.mark.parametrize("method", list(RUNNERS))
def test_run_seeds_equals_the_single_seed_loop(method, splits):
    runner, _, iterations = RUNNERS[method]
    cfg = baselines.IterativeConfig(iterations=iterations)
    # two entries take the loop under "auto": stack them to hold the stack
    fold = fold_of(runner, splits, dataclasses.replace(cfg, engine_mode="vmap"))
    assert fold[0].ledger is not fold[1].ledger
    assert events(fold[0].ledger) == events(fold[1].ledger)
    exts, ssls = specs_of(NAME)
    for seed, split, got in zip(SEEDS, splits, fold):
        want = runner(seed, split, exts, ssls, cfg, device="cpu")
        assert_same_run(got, want)
        d = got.diagnostics
        assert (d["engine_path"], d["seed_fold"], d["scenario_fold"], d["device_fold"]) == ("vmap", 2, 1, 1)
        assert want.diagnostics["engine_path"] == "python"


@pytest.mark.parametrize("method", list(RUNNERS))
def test_folded_ledgers_equal_the_references_run_seeds(method, splits):
    runner, ref_runner, _ = RUNNERS[method]
    bundles = [jscen.build(NAME, seed=s) for s in SEEDS]
    ref = ref_run_seeds(
        ref_runner, [jax.random.PRNGKey(s) for s in SEEDS], [b.split for b in bundles],
        [b.extractors for b in bundles], [b.ssl_cfgs for b in bundles], RefIterConfig(iterations=8),
    )
    fold = fold_of(runner, splits, baselines.IterativeConfig(iterations=8))
    for got, want in zip(fold, ref):
        assert events(got.ledger) == events(want.ledger)
        assert got.ledger.summary() == want.ledger.summary()


def _misses():
    return {d: st["misses"] for d, st in sessions.session_cache_stats_by_domain().items()}


def test_more_seeds_add_zero_fresh_iterative_misses(splits4):
    """The width-1 run and the fold share one key: after a single-seed run
    (the loop, under "auto") a 4-seed fold (the stack) builds nothing."""
    cfg = baselines.IterativeConfig(iterations=10)
    iterative.clear_session_cache()
    fold_of(baselines.run_vanilla, splits4[:1], cfg, seeds=[0])
    warm = _misses()
    assert warm["iterative"] == 1 and iterative.session_cache_stats() == {"hits": 0, "misses": 1}
    fold = fold_of(baselines.run_vanilla, splits4, cfg, seeds=range(4))
    assert fold[0].diagnostics["engine_path"] == "vmap"
    assert _misses() == warm and iterative.session_cache_stats()["hits"] == 1


def test_the_finetune_fold_chains_the_folds(splits):
    """Few-shot's fold hands its trained state to ONE run_vanilla_seeds fold:
    per seed the single-seed ``run_few_shot_finetune`` at 1e-5, its few-shot
    metric too, with 5 + 2·20 comm times on one ledger."""
    exts, ssls = specs_of(NAME)
    fold = run_seeds(
        run_few_shot_finetune, list(SEEDS), splits, [exts] * 2, [ssls] * 2, FAST, device="cpu",
        finetune_iterations=20,
    )
    assert fold[0].ledger is not fold[1].ledger
    for seed, split, got in zip(SEEDS, splits, fold):
        want = run_few_shot_finetune(seed, split, exts, ssls, FAST, 20, device="cpu")
        assert_same_run(got, want)
        assert abs(got.diagnostics["fewshot_metric"] - want.diagnostics["fewshot_metric"]) <= TOL
        assert got.ledger.comm_times() == 5 + 2 * 20
        assert got.diagnostics["iterations"] == 20


def test_fedcvt_folds_over_empty_private_pools():
    """edge/full-overlap: every pool empty, so every unaligned batch has zero
    rows under ``vmap``; the term adds exactly 0 and the fold equals the
    loop."""
    name = "edge/full-overlap"
    splits = port_splits(name, smoke=True)
    assert all(u.shape[0] == 0 for u in splits[0].unaligned)
    cfg = baselines.IterativeConfig(iterations=5)
    fold = fold_of(baselines.run_fedcvt, splits, dataclasses.replace(cfg, engine_mode="vmap"), name=name)
    exts, ssls = specs_of(name)
    for seed, split, got in zip(SEEDS, splits, fold):
        assert got.diagnostics["engine_path"] == "vmap" and np.isfinite(got.metric)
        assert_same_run(got, baselines.run_fedcvt(seed, split, exts, ssls, cfg, device="cpu"))


# ------------------------------------------------------------ where "auto" stacks
@pytest.mark.parametrize("entries, pays", [(1, False), (2, False), (3, False), (4, True), (36, True)])
def test_stack_pays(entries, pays):
    assert iterative.stack_pays(entries) is pays


def test_resolve_mode():
    assert [iterative.resolve_mode(m) for m in ("vmap", "scan", "python", "auto")] == [
        "vmap", "vmap", "python", "vmap"
    ]
    assert iterative.resolve_mode("auto", stack=False) == "python"
    assert iterative.resolve_mode("vmap", stack=False) == "vmap"
    with pytest.raises(ValueError, match="unknown iterative engine mode"):
        iterative.resolve_mode("jit")


@pytest.mark.parametrize("mode, entries, path", [
    ("auto", 1, "python"), ("auto", 2, "python"), ("auto", 4, "vmap"), ("vmap", 1, "vmap"),
    ("python", 4, "python"),
])
def test_engine_mode_picks_the_path(mode, entries, path, splits4):
    cfg = baselines.IterativeConfig(iterations=4, engine_mode=mode)
    fold = fold_of(baselines.run_fedbcd, splits4[:entries], cfg, seeds=range(entries))
    assert {r.diagnostics["engine_path"] for r in fold} == {path}


def test_vmap_on_entries_that_cannot_stack_raises(splits):
    exts, ssls = specs_of(NAME)
    cfg = baselines.IterativeConfig(iterations=4, engine_mode="vmap")
    wider = [dataclasses.replace(s, hidden=(48,)) for s in exts]
    with pytest.raises(ValueError, match="semantically equal party extractors"):
        run_seeds(baselines.run_vanilla, list(SEEDS), splits, [exts, wider], [ssls] * 2, cfg, device="cpu")
    doubled = dataclasses.replace(
        splits[1], aligned=[torch.cat([x, x]) for x in splits[1].aligned],
        labels=torch.cat([splits[1].labels] * 2),
    )
    with pytest.raises(ValueError, match="cannot stack these iterative sessions: the entries' aligned rows"):
        baselines.run_vanilla_seeds(list(SEEDS), [splits[0], doubled], [exts] * 2, [ssls] * 2,
                                    cfg, device="cpu")
    # under "auto" the same entries take the loop
    auto = dataclasses.replace(cfg, engine_mode="auto")
    res = baselines.run_vanilla_seeds(list(SEEDS), [splits[0], doubled], [exts] * 2, [ssls] * 2, auto,
                                      device="cpu")
    assert {r.diagnostics["engine_path"] for r in res} == {"python"}
