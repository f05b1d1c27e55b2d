"""The iterative baselines' scenario fold in the port: C scenarios × S
seeds through ``run_scenarios_seeds`` as one stacked session.

Counterpart of ``tests/test_scenario_batched.py``'s iterative fold test and
``tests/test_faults.py``'s faulted one. On the padded equal-shape pair
``hard/overlap-{32,64}-eq`` and on two fault/* members, a C = 2 × S = 2
grid of each baseline equals the single-seed runs at 1e-5 (metric, every
parameter, losses) with byte-identical ledgers, equal to the reference's
``run_scenarios_seeds`` ledgers, the dropouts' retry rounds included; and
neither more scenarios nor other faults build a fresh ``"iterative"``
session.
"""

import jax
import pytest

from repro import scenarios as jscen
from repro.core import IterativeConfig as RefIterConfig
from repro.core.protocol import run_scenarios_seeds as ref_run_scenarios_seeds
from repro.scenarios import FaultSpec as RefFaultSpec
from repro_torch.core import baselines
from repro_torch.engine import sessions
from repro_torch.scenarios import FaultSpec

from test_torch_catalog import events, one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_iterative_fold import RUNNERS, assert_same_run
from test_torch_scenario_fold import FAULT_PAIR, PAIR, run_grid
from test_torch_seed_fold import SEEDS, port_splits, specs_of

ITERATIONS = 8  # FedBCD: one round of Q = 5
# entries stall at different steps (pre_upload: none commits) beside a
# healthy entry and an unmodeled straggler
FAULTS = [
    [("dropout", 1, "pre_upload"), None],
    [("dropout", 0, "post_ssl"), ("straggler", 0, None)],
]


def port_faults(grid=FAULTS):
    return [[None if f is None else FaultSpec(f[0], party=f[1], stage=f[2] or "pre_ssl",
                                               epoch_fraction=0.5)
             for f in row] for row in grid]


def ref_faults(grid=FAULTS):
    return [[None if f is None else RefFaultSpec(f[0], party=f[1], stage=f[2] or "pre_ssl",
                                                  epoch_fraction=0.5)
             for f in row] for row in grid]


@pytest.fixture(scope="module")
def pair():
    return [port_splits(n) for n in PAIR]


@pytest.fixture(scope="module")
def fault_pair():
    return [port_splits(n) for n in FAULT_PAIR]


def single_runs(runner, names, grid, cfg, faults=None):
    return [
        [
            runner(seed, split, *specs_of(name), cfg, device="cpu",
                   fault=None if faults is None else faults[c][s])
            for s, (seed, split) in enumerate(zip(SEEDS, splits))
        ]
        for c, (name, splits) in enumerate(zip(names, grid))
    ]


def ref_grid(method, names, cfg, faults=None):
    bundles = [[jscen.build(n, seed=s) for s in SEEDS] for n in names]
    return ref_run_scenarios_seeds(
        RUNNERS[method][1],
        [[jax.random.PRNGKey(s) for s in SEEDS] for _ in names],
        [[b.split for b in row] for row in bundles],
        [[b.extractors for b in row] for row in bundles],
        [[b.ssl_cfgs for b in row] for row in bundles],
        cfg,
        **({} if faults is None else {"faults": faults}),
    )


@pytest.mark.parametrize("method", list(RUNNERS))
def test_scenario_fold_equals_the_single_runs(method, pair):
    runner, _, iterations = RUNNERS[method]
    cfg = baselines.IterativeConfig(iterations=iterations)
    folded = run_grid(runner, PAIR, pair, cfg)
    flat = [r for row in folded for r in row]
    assert len({id(r.ledger) for r in flat}) == len(flat)  # per-entry copies
    for row, want_row in zip(folded, single_runs(runner, PAIR, pair, cfg)):
        for got, want in zip(row, want_row):
            assert_same_run(got, want)
            d = got.diagnostics
            assert (d["engine_path"], d["seed_fold"], d["scenario_fold"]) == ("vmap", 2, 2)
    for r in flat[1:]:  # communication is a shape function: one prototype
        assert events(r.ledger) == events(flat[0].ledger)


@pytest.mark.parametrize("method", list(RUNNERS))
def test_faulted_scenario_fold_equals_the_single_runs_and_the_references_ledgers(method, fault_pair):
    runner = RUNNERS[method][0]
    cfg = baselines.IterativeConfig(iterations=ITERATIONS)
    folded = run_grid(runner, FAULT_PAIR, fault_pair, cfg, faults=port_faults())
    loop = single_runs(runner, FAULT_PAIR, fault_pair, cfg, port_faults())
    ref = ref_grid(method, FAULT_PAIR, RefIterConfig(iterations=ITERATIONS), ref_faults())
    for row, want_row, ref_row, faults in zip(folded, loop, ref, port_faults()):
        for got, want, r, fault in zip(row, want_row, ref_row, faults):
            assert_same_run(got, want)
            assert events(got.ledger) == events(r.ledger)
            d = got.diagnostics
            assert (d["engine_path"], d["seed_fold"], d["scenario_fold"]) == ("vmap", 2, 2)
            for key in ("fault_kind", "parties_survived", "fault_modeled", "fault_retry_bytes"):
                assert d.get(key) == want.diagnostics.get(key), key
            if fault is not None and fault.kind == "dropout":
                assert d["fault_retry_bytes"] > 0 and d["parties_survived"] == 3


def test_the_fault_free_grid_ledgers_equal_the_references(pair):
    cfg = baselines.IterativeConfig(iterations=ITERATIONS)
    folded = run_grid(baselines.run_fedcvt, PAIR, pair, cfg)
    ref = ref_grid("fedcvt", PAIR, RefIterConfig(iterations=ITERATIONS))
    for row, ref_row in zip(folded, ref):
        for got, want in zip(row, ref_row):
            assert events(got.ledger) == events(want.ledger)
            assert got.ledger.summary() == want.ledger.summary()


def _misses():
    return {d: st["misses"] for d, st in sessions.session_cache_stats_by_domain().items()}


def test_more_scenarios_add_zero_fresh_iterative_misses(pair):
    cfg = baselines.IterativeConfig(iterations=10)
    sessions.clear_session_cache()
    run_grid(baselines.run_fedbcd, PAIR[:1], pair[:1], cfg)
    warm = _misses()
    assert warm == {"iterative": 1}
    run_grid(baselines.run_fedbcd, PAIR, pair, cfg)
    assert _misses() == warm


def test_changing_faults_adds_zero_fresh_iterative_misses(fault_pair):
    cfg = baselines.IterativeConfig(iterations=ITERATIONS)
    sessions.clear_session_cache()
    run_grid(baselines.run_vanilla, FAULT_PAIR, fault_pair, cfg, faults=port_faults())
    warm = _misses()
    flipped = [[("dropout", 0, "pre_ssl"), ("dp_upload", 1, None)], [None, ("dropout", 1, "pre_round2")]]
    run_grid(baselines.run_vanilla, FAULT_PAIR, fault_pair, cfg, faults=port_faults(flipped))
    assert _misses() == warm == {"iterative": 1}
