"""Faulted folds of the port (counterparts of ``tests/test_faults.py``'s
fold-parity tests): a C = 3 slice of the fault family × seeds 0-1 through
``run_scenarios_seeds`` equals the single-seed runs under each entry's
fault at 1e-5, one-shot and few-shot; every entry keeps its own ledger,
equal event for event to the reference's ``run_scenarios_seeds`` ledger of
the same entry; a healthy entry beside a faulted one is unaffected; the
fold's Eq. 10 reconstructions are one launch a (dropped party, anchor) pair
and equal the per-entry ones; the finetune fold refuses faults."""

import jax
import pytest
import torch

from repro import scenarios as jscen
from repro.core import ProtocolConfig as RefConfig
from repro.core import run_few_shot as ref_few_shot
from repro.core import run_one_shot as ref_one_shot
from repro.core.protocol import run_scenarios_seeds as ref_run_scenarios_seeds
from repro_torch import scenarios
from repro_torch.core import faults
from repro_torch.core.protocol import (
    ProtocolConfig,
    run_few_shot,
    run_few_shot_finetune,
    run_one_shot,
    run_seeds,
)
from repro_torch.scenarios.faults import POINT_UPLOAD2

from test_torch_catalog import events, one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_scenario_fold import run_grid
from test_torch_seed_fold import ONE_EPOCH, SEEDS, TOL, assert_same_run, port_splits, specs_of

NAMES = ["fault/dropout-post-ssl", "fault/dp-sigma-0.5", "fault/rep-only"]
CFG = ProtocolConfig(**ONE_EPOCH)
DIAG_KEYS = ("fault_kind", "parties_survived", "fault_stage")


@pytest.fixture(scope="module")
def grid():
    return [port_splits(n) for n in NAMES]


def fault_grid():
    return [[scenarios.get(n).fault for _ in SEEDS] for n in NAMES]


def runner_of(protocol):
    return {"one-shot": run_one_shot, "few-shot": run_few_shot}[protocol]


@pytest.mark.parametrize("protocol", ["one-shot", "few-shot"])
def test_faulted_scenario_fold_equals_the_single_runs(protocol, grid):
    runner = runner_of(protocol)
    folded = run_grid(runner, NAMES, grid, CFG, faults=fault_grid())
    for name, splits, row in zip(NAMES, grid, folded):
        exts, ssls = specs_of(name)
        fault = scenarios.get(name).fault
        for seed, split, got in zip(SEEDS, splits, row):
            want = runner(seed, split, exts, ssls, CFG, device="cpu", fault=fault)
            assert_same_run(got, want)
            d = got.diagnostics
            assert (d["seed_fold"], d["scenario_fold"], d["kernel_fold"]) == (2, 3, 24)
            assert d["engine_path"] == "vmap"
            assert d["degraded_metric"] == pytest.approx(got.metric)
            assert {k: d.get(k) for k in DIAG_KEYS} == {
                k: want.diagnostics.get(k) for k in DIAG_KEYS
            }
            recs_g, recs_w = d["fault_reconstruct"], want.diagnostics["fault_reconstruct"]
            assert [(r["point"], r["party"], r["anchor"]) for r in recs_g] == [
                (r["point"], r["party"], r["anchor"]) for r in recs_w
            ]
            for a, b in zip(recs_g, recs_w):
                torch.testing.assert_close(a["estimate"], b["estimate"], atol=TOL, rtol=0)
    ledgers = [r.ledger for row in folded for r in row]
    assert len({id(led) for led in ledgers}) == len(ledgers)


@pytest.mark.parametrize("protocol", ["one-shot", "few-shot"])
def test_faulted_fold_ledgers_equal_the_references(protocol, grid):
    ref_runner = {"one-shot": ref_one_shot, "few-shot": ref_few_shot}[protocol]
    bundles = [[jscen.build(n, seed=s) for s in SEEDS] for n in NAMES]
    ref = ref_run_scenarios_seeds(
        ref_runner,
        [[jax.random.PRNGKey(s) for s in SEEDS] for _ in NAMES],
        [[b.split for b in row] for row in bundles],
        [[b.extractors for b in row] for row in bundles],
        [[b.ssl_cfgs for b in row] for row in bundles],
        RefConfig(**ONE_EPOCH),
        faults=[[b.spec.fault for b in row] for row in bundles],
    )
    got = run_grid(runner_of(protocol), NAMES, grid, CFG, faults=fault_grid())
    for row_r, row_g in zip(ref, got):
        for r, g in zip(row_r, row_g):
            assert events(g.ledger) == events(r.ledger)
            assert g.ledger.summary() == r.ledger.summary()
            assert {k: g.diagnostics.get(k) for k in DIAG_KEYS} == {
                k: r.diagnostics.get(k) for k in DIAG_KEYS
            }


def test_a_healthy_entry_beside_a_faulted_one_is_unaffected():
    name = "fault/none"
    splits = port_splits(name)
    exts, ssls = specs_of(name)
    drop = scenarios.get("fault/dropout-pre-ssl").fault
    folded = run_seeds(
        run_few_shot, list(SEEDS), splits, [exts] * 2, [ssls] * 2, CFG, device="cpu",
        faults=[drop, None],
    )
    healthy = run_few_shot(SEEDS[1], splits[1], exts, ssls, CFG, device="cpu")
    assert_same_run(folded[1], healthy)
    assert folded[1].diagnostics["fault_kind"] == "none"
    assert folded[1].diagnostics["parties_survived"] == 4
    dropped = run_few_shot(SEEDS[0], splits[0], exts, ssls, CFG, device="cpu", fault=drop)
    assert_same_run(folded[0], dropped)
    assert folded[0].ledger.total_bytes() < folded[1].ledger.total_bytes()


def test_fold_reconstructions_are_one_launch_a_pair_and_equal_the_single_ones():
    gen = torch.Generator().manual_seed(0)
    reps = [[torch.randn(32, 16, generator=gen) for _ in range(4)] for _ in range(3)]
    stale = [[torch.randn(32, 16, generator=gen) for _ in range(4)] for _ in range(3)]
    drop1 = scenarios.get("fault/dropout-pre-ssl").fault
    drop0 = scenarios.FaultSpec("dropout", party=0, stage="pre_ssl")
    fault_list = [drop1, None, drop0]
    calls = []
    batched = faults.estimator.sdpa_transform_batched

    def spy(q, a, b):
        calls.append(tuple(q.shape))
        return batched(q, a, b)

    records = [[] for _ in reps]
    faults.estimator.sdpa_transform_batched = spy
    try:
        got = faults.reconstruct_dropped_seeds(reps, stale, fault_list, POINT_UPLOAD2, records)
    finally:
        faults.estimator.sdpa_transform_batched = batched
    assert calls == [(1, 32, 16), (1, 32, 16)]  # (party 0, anchor 1), (party 1, anchor 0)
    for e, fault in enumerate(fault_list):
        rec = []
        want = faults.reconstruct_dropped(reps[e], stale[e], fault, POINT_UPLOAD2, rec)
        for a, b in zip(got[e], want):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
        assert [(r["party"], r["anchor"]) for r in records[e]] == [
            (r["party"], r["anchor"]) for r in rec
        ]
    two = faults.reconstruct_dropped_seeds(reps[:1] * 2, stale[:1] * 2, [drop1, drop1], POINT_UPLOAD2)
    assert torch.equal(two[0][1], two[1][1])


def test_the_finetune_fold_refuses_faults():
    name = "fault/none"
    splits = port_splits(name)
    exts, ssls = specs_of(name)
    with pytest.raises(ValueError, match="does not support fault injection"):
        run_seeds(
            run_few_shot_finetune, list(SEEDS), splits, [exts] * 2, [ssls] * 2, CFG,
            device="cpu", faults=[scenarios.get("fault/rep-only").fault, None],
        )
