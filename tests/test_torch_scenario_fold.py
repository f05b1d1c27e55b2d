"""The scenario fold of the port: ``run_scenarios_seeds``.

Counterpart of ``tests/test_scenario_batched.py`` (and of
``test_faults.py::test_changing_faults_adds_zero_fresh_session_misses``).
On the padded equal-shape pair ``hard/overlap-{32,64}-eq`` (one shape, so
one group), a C = 2 × S = 2 grid folds into one stacked program that
equals the per-scenario loop at 1e-5 with byte-identical ledgers, the
reference's ``run_scenarios_seeds`` ledgers; ``run_seeds`` is the C = 1
case; ragged grids are refused, unequal shapes go scenario by scenario; and
neither more seeds, more scenarios nor other faults build a fresh session.
"""

import dataclasses

import jax
import pytest

from repro import scenarios as jscen
from repro.core import ProtocolConfig as RefConfig
from repro.core import run_few_shot as ref_few_shot
from repro.core import run_one_shot as ref_one_shot
from repro.core.protocol import run_scenarios_seeds as ref_run_scenarios_seeds
from repro_torch.core.protocol import (
    ProtocolConfig,
    run_few_shot,
    run_one_shot,
    run_scenarios_seeds,
    run_seeds,
)
from repro_torch.engine import sessions

from test_torch_catalog import events, one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_seed_fold import FAST, ONE_EPOCH, SEEDS, assert_same_run, port_splits, specs_of

PAIR = ["hard/overlap-32-eq", "hard/overlap-64-eq"]
FAULT_PAIR = ["fault/dropout-pre-ssl", "fault/straggler-half"]


@pytest.fixture(scope="module")
def grid():
    return [port_splits(n) for n in PAIR]


def run_grid(runner, names, splits, cfg=FAST, **kw):
    return run_scenarios_seeds(
        runner,
        [list(SEEDS) for _ in names],
        splits,
        [[specs_of(n)[0] for _ in SEEDS] for n in names],
        [[specs_of(n)[1] for _ in SEEDS] for n in names],
        cfg,
        device="cpu",
        **kw,
    )


def run_loop(runner, names, splits, cfg=FAST, faults=None):
    return [
        run_seeds(
            runner, list(SEEDS), sp, [specs_of(n)[0]] * 2, [specs_of(n)[1]] * 2, cfg,
            device="cpu", **({} if faults is None else {"faults": faults[c]}),
        )
        for c, (n, sp) in enumerate(zip(names, splits))
    ]


@pytest.mark.parametrize("runner", [run_one_shot, run_few_shot], ids=lambda r: r.__name__)
def test_scenario_fold_equals_the_per_scenario_loop(runner, grid):
    folded = run_grid(runner, PAIR, grid)
    loop = run_loop(runner, PAIR, grid)
    for row_f, row_l in zip(folded, loop):
        for got, want in zip(row_f, row_l):
            assert_same_run(got, want)
            d = got.diagnostics
            assert (d["seed_fold"], d["scenario_fold"], d["kernel_fold"]) == (2, 2, 8)
            assert d["engine_path"] == "vmap" and d["device_fold"] == 1
            if runner is run_few_shot:
                assert d["sdpa_fold"] == 4
    flat = [r.ledger for row in folded for r in row]
    assert len({id(led) for led in flat}) == 4  # a copy per entry


@pytest.mark.parametrize("protocol", ["one-shot", "few-shot"])
def test_folded_ledgers_equal_the_references_run_scenarios_seeds(protocol, grid):
    ref_runner, runner = {
        "one-shot": (ref_one_shot, run_one_shot),
        "few-shot": (ref_few_shot, run_few_shot),
    }[protocol]
    bundles = [[jscen.build(n, seed=s) for s in SEEDS] for n in PAIR]
    ref = ref_run_scenarios_seeds(
        ref_runner,
        [[jax.random.PRNGKey(s) for s in SEEDS] for _ in PAIR],
        [[b.split for b in row] for row in bundles],
        [[b.extractors for b in row] for row in bundles],
        [[b.ssl_cfgs for b in row] for row in bundles],
        RefConfig(**ONE_EPOCH),
    )
    got = run_grid(runner, PAIR, grid, ProtocolConfig(**ONE_EPOCH))
    for row_r, row_g in zip(ref, got):
        for r, g in zip(row_r, row_g):
            assert events(g.ledger) == events(r.ledger)
            assert g.ledger.summary() == r.ledger.summary()
            for key in ("seed_fold", "scenario_fold", "kernel_fold"):
                assert g.diagnostics[key] == r.diagnostics[key]


def test_run_seeds_is_the_width_one_case(grid):
    one = run_grid(run_one_shot, PAIR[:1], grid[:1])[0]
    seeds = run_seeds(
        run_one_shot, list(SEEDS), grid[0], [specs_of(PAIR[0])[0]] * 2,
        [specs_of(PAIR[0])[1]] * 2, FAST, device="cpu",
    )
    for a, b in zip(one, seeds):
        assert_same_run(a, b, tol=0.0)
        assert a.diagnostics["scenario_fold"] == 1 and a.diagnostics["seed_fold"] == 2


def test_ragged_grids_are_refused(grid):
    exts, ssls = specs_of(PAIR[0])
    with pytest.raises(ValueError, match="rectangular"):
        run_scenarios_seeds(
            run_one_shot, [[0, 1], [0]], [grid[0], grid[1][:1]], [[exts] * 2, [exts]],
            [[ssls] * 2, [ssls]], FAST, device="cpu",
        )
    with pytest.raises(ValueError, match="one per-seed list"):
        run_scenarios_seeds(run_one_shot, [[0, 1]], grid, [[exts] * 2], [[ssls] * 2], FAST)
    with pytest.raises(ValueError, match="mirror the C×S grid"):
        run_grid(run_one_shot, PAIR, grid, faults=[[None, None]])
    with pytest.raises(ValueError, match="per-seed state kwargs"):
        run_grid(run_one_shot, PAIR, grid, server=None)


def test_unequal_shapes_go_scenario_by_scenario():
    names = ["hard/overlap-32", "hard/overlap-64"]
    splits = [port_splits(n) for n in names]
    folded = run_grid(run_one_shot, names, splits)
    loop = run_loop(run_one_shot, names, splits)
    for row_f, row_l in zip(folded, loop):
        for got, want in zip(row_f, row_l):
            assert_same_run(got, want, tol=0.0)
            assert got.diagnostics["scenario_fold"] == 1 and got.diagnostics["seed_fold"] == 2


def _misses():
    return {d: st["misses"] for d, st in sessions.session_cache_stats_by_domain().items()}


def test_more_seeds_add_zero_fresh_session_misses(grid):
    sessions.clear_session_cache()
    exts, ssls = specs_of(PAIR[0])
    # one seed's two MLP parties loop under "auto": stack them to build the session
    cfg = dataclasses.replace(FAST, engine_mode="vmap")
    run_few_shot(0, grid[0][0], exts, ssls, cfg, device="cpu")
    warm = _misses()
    assert set(warm) == {"ssl", "server_fit", "kmeans", "sdpa", "fewshot_gate"}
    run_seeds(run_few_shot, list(SEEDS), grid[0], [exts] * 2, [ssls] * 2, cfg, device="cpu")
    assert _misses() == warm


def test_more_scenarios_add_zero_fresh_session_misses(grid):
    sessions.clear_session_cache()
    run_grid(run_few_shot, PAIR[:1], grid[:1])
    warm = _misses()
    run_grid(run_few_shot, PAIR, grid)
    assert _misses() == warm
    assert sessions.session_cache_stats()["hits"] > 0


def test_changing_faults_adds_zero_fresh_session_misses():
    from repro_torch.scenarios import FaultSpec

    splits = [port_splits(n) for n in FAULT_PAIR]
    cfg = ProtocolConfig(**ONE_EPOCH)
    sessions.clear_session_cache()
    drop, strag = FaultSpec("dropout", party=1, stage="pre_ssl"), FaultSpec("straggler", 0, epoch_fraction=0.5)
    run_grid(run_one_shot, FAULT_PAIR, splits, cfg, faults=[[drop, None], [strag, None]])
    warm = _misses()
    flipped = [
        [FaultSpec("dp_upload", party=0, dp_sigma=0.5), FaultSpec("representation_only", party=2)],
        [FaultSpec("dropout", party=0, stage="post_ssl"), None],
    ]
    run_grid(run_one_shot, FAULT_PAIR, splits, cfg, faults=flipped)
    assert _misses() == warm
