"""The port's runner registry and typed rows against the reference's.

The registry's names, aliases, config families and refused kwargs equal
``repro.core.runners``; unknown names raise; the protocol runners fold and
the iterative baselines (their fold still to come) loop, saying so in their
diagnostics. ``rows`` has the reference's key sets, ``training_row`` builds
the reference's row from the same result, a one-shot run's
``summary_row`` has the reference's keys, and core-key clashes raise.
"""

import types

import jax
import pytest

from repro import scenarios as jscen
from repro.core import ProtocolConfig as RefConfig
from repro.core import rows as jrows
from repro.core import run_one_shot as ref_one_shot
from repro.core import runners as jrunners
from repro_torch.core import baselines, protocol, rows, runners
from repro_torch.core.comm import CommLedger

from test_torch_catalog import one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_seed_fold import ONE_EPOCH, SEEDS, port_splits, specs_of


def test_the_names_and_aliases_are_the_references():
    assert runners.names() == jrunners.names()
    assert runners.names(include_aliases=True) == jrunners.names(include_aliases=True)
    assert [e.name for e in runners.RUNNERS] == [e.name for e in jrunners.RUNNERS]
    assert runners.STATE_KWARGS == jrunners.STATE_KWARGS
    assert runners.LEDGER_PROTOTYPE == jrunners.LEDGER_PROTOTYPE


@pytest.mark.parametrize("name", jrunners.names(include_aliases=True))
def test_each_entry_matches_the_reference(name):
    got, want = runners.get(name), jrunners.get(name)
    assert (got.name, got.kind, got.aliases, got.ledger_policy, got.servable) == (
        want.name, want.kind, want.aliases, want.ledger_policy, want.servable
    )
    assert got.stateful_kwargs == want.stateful_kwargs
    assert runners.resolve(got.runner) is got and runners.resolve(name) is got
    assert got.folds == (got.kind == "protocol")
    assert got.seeds_impl.__name__ == want.seeds_impl.__name__


def test_unknown_and_unregistered_runners():
    with pytest.raises(KeyError, match="unknown runner 'one-shot'"):
        runners.get("one-shot")
    assert runners.resolve("nope") is None
    assert runners.resolve(lambda *a: None) is None
    with pytest.raises(ValueError, match="already registered"):
        runners.register(runners.get("vanilla"))


@pytest.mark.parametrize("kwarg", sorted(runners.STATE_KWARGS))
def test_state_kwargs_are_refused(kwarg):
    with pytest.raises(ValueError, match="per-seed state kwargs"):
        runners.reject_stateful_kwargs("run_seeds", {kwarg: None}, runners.get("one_shot"))
    with pytest.raises(ValueError, match="per-seed state kwargs"):
        runners.reject_stateful_kwargs("run_seeds", {kwarg: None})
    runners.reject_stateful_kwargs("run_seeds", {"faults": None})


def test_row_keys_are_the_references():
    assert rows.DIAGNOSTIC_KEYS == jrows.DIAGNOSTIC_KEYS
    assert rows.CORE_KEYS == jrows.CORE_KEYS
    assert rows.KINDS == jrows.KINDS


def _result(diagnostics):
    ledger = CommLedger()
    ledger.log_bytes(0, "up", "reps_overlap", 4096, round=1)
    ledger.log_bytes(1, "down", "partial_grads", 4096, round=2)
    return types.SimpleNamespace(
        metric_name="auc", metric=0.75, ledger=ledger, diagnostics=diagnostics
    )


def test_training_row_is_the_references_for_the_same_result():
    diags = {k: i for i, k in enumerate(rows.DIAGNOSTIC_KEYS)}
    diags.update(kmeans_purity=[1.0], step_ms={"eval": 1.0})  # not forwarded
    res = _result(diags)
    got = rows.training_row(res, scenario="hard/overlap-32", seed=0, method="one_shot")
    want = jrows.training_row(res, scenario="hard/overlap-32", seed=0, method="one_shot")
    assert got == want
    assert list(got) == list(want)
    assert rows.serving_row("p50_ms", 1.5, batch=4) == jrows.serving_row("p50_ms", 1.5, batch=4)


def test_core_key_clashes_raise():
    res = _result({"engine_path": "vmap"})
    with pytest.raises(ValueError, match="shadow typed row fields"):
        rows.training_row(res, metric=1.0)
    with pytest.raises(ValueError, match="collide with forwarded diagnostics"):
        rows.training_row(res, engine_path="python")
    with pytest.raises(ValueError, match="not in"):
        rows.ResultRow(kind="eval", metric_name="auc", metric=0.5)
    with pytest.raises(ValueError, match="shadow"):
        rows.serving_row("p50_ms", 1.0, kind="train")


def test_a_one_shot_summary_row_has_the_references_keys():
    name = "hard/overlap-32"
    bundle = jscen.build(name, seed=0)
    ref = ref_one_shot(
        jax.random.PRNGKey(0), bundle.split, bundle.extractors, bundle.ssl_cfgs,
        RefConfig(**ONE_EPOCH),
    )
    exts, ssls = specs_of(name)
    split = port_splits(name, (0,))[0]
    # the reference stacks any homogeneous parties; the port's "auto" loops two MLP parties
    cfg = protocol.ProtocolConfig(**ONE_EPOCH, engine_mode="vmap")
    port = protocol.run_one_shot(0, split, exts, ssls, cfg, device="cpu")
    got, want = port.summary_row(), ref.summary_row()
    assert sorted(got) == sorted(want)
    for key in ("kind", "metric_name", "comm_bytes", "comm_times", "seed_fold", "kernel_fold",
                "engine_path", "device_fold"):
        assert got[key] == want[key], key


def test_the_iterative_seed_entries_loop_and_say_so():
    name = "hard/overlap-32"
    splits = port_splits(name)
    exts, ssls = specs_of(name)
    cfg = baselines.IterativeConfig(iterations=8)
    results = protocol.run_seeds(
        baselines.run_fedcvt, list(SEEDS), splits, [exts] * 2, [ssls] * 2, cfg, device="cpu"
    )
    for seed, split, res in zip(SEEDS, splits, results):
        solo = baselines.run_fedcvt(seed, split, exts, ssls, cfg, device="cpu")
        assert res.metric == solo.metric
        d = res.diagnostics
        assert (d["seed_fold"], d["scenario_fold"], d["engine_path"]) == (1, 1, "python")
        assert res.ledger.summary() == solo.ledger.summary()
    assert results[0].ledger is not results[1].ledger
