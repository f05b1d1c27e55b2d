"""``benchmarks/torch_frontier.py``: the port's frontier and its gate.

``check_gate`` on hand-made rows against the unchanged
``benchmarks/frontier_baseline.json``: a clean sweep passes, and each floor
(the 100× bytes advantage, the one-shot and few-shot mean and worst-seed
margins, the recorded one-shot bytes, seed-invariant bytes), each fold rule
(the protocol methods' and the iterative baselines') and each fault rule
fails on its own. Then one
small end-to-end run of the CLI on the CPU.
"""

import copy
import json
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from benchmarks import torch_frontier as tf  # noqa: E402
from repro_torch import scenarios  # noqa: E402

from test_torch_catalog import one_torch_thread  # noqa: E402,F401 (autouse fixture)

NAME = "hard/overlap-32"
FAULT_MEMBERS = [
    "fault/none", "fault/dropout-pre-upload", "fault/dropout-pre-ssl", "fault/dropout-post-ssl",
    "fault/dropout-pre-round2", "fault/straggler-half", "fault/dp-sigma-0.1",
    "fault/dp-sigma-0.5", "fault/rep-only",
]


def _row(scenario, method, seed, metric, comm_bytes, **kw):
    protocol = method in ("one_shot", "few_shot")
    row = dict(
        kind="train", metric_name="auc", metric=metric, comm_bytes=comm_bytes, comm_times=3,
        scenario=scenario, seed=seed, method=method, wall_s=0.1, cache_misses=0, group_size=1,
        vmap_eligible=True, overlap=32, num_parties=2, modality="tabular",
        seed_fold=2, scenario_fold=1, engine_path="vmap",
    )
    if protocol:
        row["kernel_fold"] = 4
    if method == "few_shot":
        row["sdpa_fold"] = 2
    row.update(kw)
    return row


def clean_rows():
    rows = []
    for seed in (0, 1):
        rows.append(_row(NAME, "one_shot", seed, 0.80, 12288))
        rows.append(_row(NAME, "few_shot", seed, 0.82, 177408))
        rows.append(_row(NAME, "iterative", seed, 0.70, 3276800))
        rows.append(_row(NAME, "fedcvt", seed, 0.71, 6553600))
    return rows


def _set(rows, method, seed=None, **kw):
    for r in rows:
        if r["method"] == method and (seed is None or r["seed"] == seed):
            r.update(kw)
    return rows


def test_a_clean_sweep_passes():
    assert tf.check_gate(clean_rows()) == []


FAILURES = {
    "bytes advantage": (lambda rows: _set(rows, "iterative", comm_bytes=12288 * 50), "100x"),
    "one-shot mean": (lambda rows: _set(rows, "one_shot", metric=0.705), "one-shot mean margin"),
    "one-shot worst seed": (
        lambda rows: _set(_set(rows, "one_shot", 0, metric=0.80), "one_shot", 1, metric=0.69),
        "one-shot worst-seed margin",
    ),
    "few-shot mean": (lambda rows: _set(rows, "few_shot", metric=0.705), "few-shot mean margin"),
    "few-shot worst seed": (
        lambda rows: _set(rows, "few_shot", 1, metric=0.69), "few-shot worst-seed margin"
    ),
    "one-shot bytes": (lambda rows: _set(rows, "one_shot", comm_bytes=12289), "regressed"),
    "seed-variant bytes": (
        lambda rows: _set(rows, "one_shot", 1, comm_bytes=12000), "differ across seeds"
    ),
    "no few-shot": (
        lambda rows: [r for r in rows if r["method"] != "few_shot"], "no few_shot rows"
    ),
    "seed fold": (  # a row that looped records its folds honestly
        lambda rows: _set(rows, "few_shot", seed_fold=1, kernel_fold=2, sdpa_fold=1),
        "per-seed loop",
    ),
    "scenario fold": (lambda rows: _set(rows, "one_shot", group_size=2), "per-scenario loop"),
    "engine path": (lambda rows: _set(rows, "one_shot", engine_path="python"), "not the stack"),
    "iterative seed fold": (lambda rows: _set(rows, "iterative", seed_fold=1), "per-seed loop"),
    "iterative engine path": (
        lambda rows: _set(rows, "fedcvt", engine_path="python"), "not the stack"
    ),
    "kernel fold": (lambda rows: _set(rows, "one_shot", kernel_fold=1), "kernel_fold=1"),
    "sdpa fold": (lambda rows: _set(rows, "few_shot", sdpa_fold=1), "sdpa_fold=1"),
}


@pytest.mark.parametrize("case", sorted(FAILURES))
def test_each_floor_and_fold_rule_fails_on_its_own(case):
    mutate, needle = FAILURES[case]
    problems = tf.check_gate(mutate(clean_rows()))
    assert problems and all(needle in p for p in problems), problems


def test_the_iterative_baselines_and_heterogeneous_parties_are_exempt_from_the_fold_rules():
    """Only from the engine-path rule, and only where the stack policy keeps
    the entries on the loop (``vmap_eligible`` False: one entry, or CNN
    parties); the seed and scenario folds hold on every row."""
    rows = _set(clean_rows(), "iterative", vmap_eligible=False, engine_path="python")
    assert tf.check_gate(rows) == []
    rows = _set(clean_rows(), "one_shot", vmap_eligible=False, engine_path="python", kernel_fold=2)
    assert tf.check_gate(rows) == []


def fault_rows():
    rows = []
    for name in FAULT_MEMBERS:
        dropout = "/dropout-" in name
        for seed in (0, 1):
            for method in ("one_shot", "iterative"):
                fault = scenarios.get(name).fault
                extra = dict(
                    fault_kind="none" if fault is None else fault.kind,
                    parties_survived=3 if dropout else 4, num_parties=4, group_size=9,
                    scenario_fold=9,
                )
                if method == "one_shot":
                    extra.update(degraded_metric=0.7, kernel_fold=72)
                elif dropout:
                    extra.update(fault_retry_rounds=3, fault_retry_bytes=1024)
                rows.append(_row(name, method, seed, 0.7, 20480, **extra))
    return rows


def test_the_fault_family_passes_its_rules():
    assert tf.check_gate(fault_rows(), expect_faults=True) == []


def _drop_member(rows):
    return [r for r in rows if r["scenario"] != "fault/rep-only"]


FAULT_FAILURES = {
    "missing member": (_drop_member, "missing from the sweep"),
    "survivors": (
        lambda rows: [
            dict(r, parties_survived=4) if "/dropout-" in r["scenario"] else r for r in rows
        ],
        "parties_survived=4",
    ),
    "retry cost": (
        lambda rows: [
            dict(r, fault_retry_bytes=0) if r["method"] == "iterative" else r for r in rows
        ],
        "retry/timeout",
    ),
    "degradation": (
        lambda rows: [dict(r, metric=0.55) if r["scenario"] == "fault/dp-sigma-0.5"
                      and r["method"] == "one_shot" else r for r in rows],
        "graceful degradation broke",
    ),
    "degraded metric": (
        lambda rows: [{k: v for k, v in r.items() if k != "degraded_metric"} for r in rows],
        "degraded_metric",
    ),
}


@pytest.mark.parametrize("case", sorted(FAULT_FAILURES))
def test_each_fault_rule_fails_on_its_own(case):
    mutate, needle = FAULT_FAILURES[case]
    problems = tf.check_gate(mutate(fault_rows()))
    assert problems and all(needle in p for p in problems), problems


def test_a_full_sweep_without_fault_rows_fails():
    problems = tf.check_gate(clean_rows(), expect_faults=True)
    assert len(problems) == 1 and "no fault-injected rows" in problems[0]


def test_the_aggregate_row_summarises_its_seeds():
    rows = [_row(NAME, "one_shot", s, m, 12288) for s, m in ((0, 0.7), (1, 0.9))]
    agg = tf._aggregate_row(copy.deepcopy(rows))
    assert agg["aggregate"] and agg["seed"] == "aggregate" and agg["num_seeds"] == 2
    assert agg["metric"] == pytest.approx(0.8) and agg["metric_std"] == pytest.approx(0.1)
    assert (agg["metric_min"], agg["metric_max"]) == (0.7, 0.9)
    rows[1]["engine_path"] = "python"
    assert "engine_path" not in tf._aggregate_row(rows)
    assert tf.check_gate(clean_rows() + [agg]) == []  # aggregate rows are not gated


def test_the_cli_runs_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "frontier.json"
    argv = [
        "--scenarios", NAME, "--smoke", "--seeds", "2", "--methods", "one_shot", "iterative",
        "--device", "cpu", "--check-gate", "--out", str(out),
    ]
    rc = tf.main(argv)
    blob = json.loads(out.read_text())
    err = capsys.readouterr().err
    # a partial sweep without few-shot rows cannot pass the few-shot gate
    violations = [ln for ln in err.splitlines() if ln.startswith("GATE VIOLATION")]
    assert rc == 1 and len(violations) == 1 and "no few_shot rows" in violations[0]
    assert blob["device"] == "cpu" and blob["seeds"] == [0, 1]
    assert blob["groups"] == [{"scenarios": [NAME], "size": 1}]
    per_seed = [r for r in blob["rows"] if not r.get("aggregate")]
    assert {(r["method"], r["seed"]) for r in per_seed} == {
        (m, s) for m in ("one_shot", "iterative") for s in (0, 1)
    }
    for r in per_seed:
        if r["method"] == "one_shot":
            assert (r["seed_fold"], r["scenario_fold"], r["kernel_fold"]) == (2, 1, 4)
            assert r["engine_path"] == "vmap" and r["comm_bytes"] == 12288
        else:
            # two entries take the loop under "auto" (iterative.stack_pays), and say so
            assert (r["seed_fold"], r["scenario_fold"], r["engine_path"]) == (2, 1, "python")
            assert r["vmap_eligible"] is False
            assert r["comm_bytes"] == 3276800
    assert set(blob["session_cache"]) >= {"ssl", "server_fit", "kmeans"}
    with pytest.raises(KeyError, match="unknown runner"):
        tf.main(["--methods", "one-shot", "--device", "cpu"])


@pytest.mark.parametrize("data_device", [None, "cuda"])
def test_the_cli_draws_the_data_on_data_device_and_trains_on_device(
    data_device, tmp_path, monkeypatch
):
    """``--data-device`` moves where the rows are drawn and nothing else:
    training stays on ``--device`` (the flag reproduces PERF.md's diagnosis
    of the card's gate miss: the card's rows through the CPU and back)."""
    seen = {}
    build = tf.build_bundles

    def spy_build(spec, seeds, smoke, device=None):
        seen.setdefault("data", []).append(torch.device(device))
        return build(spec, seeds, smoke, "cpu")

    def spy_run(bundles, seeds, methods=tf.METHODS, device=None, verbose=True):
        seen.setdefault("train", []).append(torch.device(device))
        return []

    monkeypatch.setattr(tf, "resolve_device", lambda d=None: torch.device("cuda" if d is None else d))
    monkeypatch.setattr(tf, "build_bundles", spy_build)
    monkeypatch.setattr(tf, "run_scenario_group", spy_run)
    out = tmp_path / "frontier.json"
    argv = ["--scenarios", NAME, "--smoke", "--methods", "one_shot", "--device", "cpu",
            "--out", str(out)]
    assert tf.main(argv + (["--data-device", data_device] if data_device else [])) == 0
    want = torch.device(data_device or "cpu")
    assert seen == {"data": [want], "train": [torch.device("cpu")]}
    blob = json.loads(out.read_text())
    assert (blob["device"], blob["data_device"]) == ("cpu", str(want))


def _gate_rows(scenario, fewshot_seed1):
    rows = [dict(r, scenario=scenario) for r in clean_rows()]
    return _set(rows, "few_shot", seed=1, metric=fewshot_seed1)


@pytest.mark.parametrize(
    "scenario, fewshot_seed1, reported",
    [
        ("hard/overlap-32", 0.70, True),  # margin 0: no miss at all
        ("hard/overlap-32", 0.66, True),  # -0.04, within the reported margin
        ("hard/overlap-32", 0.64, False),  # -0.06, below it
        ("hard/overlap-64", 0.66, False),  # the same miss on another scenario
    ],
)
def test_chip_smoke_reports_only_the_diagnosed_gate_miss(scenario, fewshot_seed1, reported):
    rows = _gate_rows(scenario, fewshot_seed1)
    if scenario != NAME:
        for r in rows:
            r["comm_bytes"] = {"one_shot": 24576, "few_shot": 191616}.get(r["method"], 3276800)
    problems = tf.check_gate(rows)
    assert all(chip_smoke.gate_miss_reported(p) for p in problems) is reported
    if fewshot_seed1 < 0.70:
        assert len(problems) == 1 and "few-shot worst-seed margin" in problems[0]
