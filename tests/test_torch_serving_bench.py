"""``benchmarks/torch_serving.py`` against the reference's
``benchmarks/serving.py``: the same gate verdicts in the same words, the
same row keys, and the CLI on the CPU."""

import copy
import json
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmarks import serving as jx_serving  # noqa: E402
from benchmarks import torch_serving  # noqa: E402
from repro_torch.checkpoint import load_artifact, save_artifact  # noqa: E402
from test_torch_serving import _port_from, _reference_artifact  # noqa: E402

BASELINE = torch_serving.BASELINE_PATH


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _row(batch, p50, rows_per_s, parity=0.0, misses=0, first=False, kind="serving"):
    return {
        "kind": kind,
        "metric_name": "p50_ms",
        "metric": p50,
        "batch": batch,
        "rows_per_s": rows_per_s,
        "parity_max_abs": parity,
        "cache_misses": misses,
        "first_shape": first,
    }


GOOD = [_row(1, 0.1, 9e3, misses=1, first=True), _row(64, 0.2, 3e5), _row(1024, 0.9, 1e6)]
ROW_SETS = {
    "good": GOOD,
    "parity": [_row(1, 0.1, 9e3, parity=3e-5, first=True), *GOOD[1:]],
    "recompile": [GOOD[0], _row(64, 0.2, 3e5, misses=2), _row(1024, 0.9, 1e6, misses=1)],
    "first shape may miss": [_row(1, 0.1, 9e3, misses=4, first=True)],
    "latency": [_row(1, 75.0, 13.0, first=True), _row(64, 51.0, 1254.9), _row(1024, 260.0, 3938.5)],
    "everything": [_row(1024, 300.0, 10.0, parity=1.0, misses=3)],
    "no serving rows": [_row(1, 0.1, 9e3, kind="train")],
    "empty": [],
}


@pytest.mark.parametrize("rows", list(ROW_SETS), ids=list(ROW_SETS))
def test_gate_returns_the_reference_violation_strings(rows, tmp_path):
    got = torch_serving.check_serving_gate(copy.deepcopy(ROW_SETS[rows]), BASELINE)
    assert got == jx_serving.check_serving_gate(copy.deepcopy(ROW_SETS[rows]), BASELINE)
    assert (got == []) == (rows in ("good", "first shape may miss"))
    # a baseline with the latency bounds off (null) and another atol
    loose = json.loads(Path(BASELINE).read_text())
    loose.update(parity_atol=1e-3, max_p50_ms={"1": None, "64": None}, min_rows_per_s={})
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps(loose))
    got = torch_serving.check_serving_gate(copy.deepcopy(ROW_SETS[rows]), str(path))
    assert got == jx_serving.check_serving_gate(copy.deepcopy(ROW_SETS[rows]), str(path))


def test_rows_carry_the_reference_keys():
    ref = _reference_artifact("mlp_k2", seed=1)
    want = jx_serving.bench_artifact(ref, batch_sizes=(1, 4), requests=2)
    got = torch_serving.bench_artifact(_port_from(ref), batch_sizes=(1, 4), requests=2)
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    same = ("kind", "metric_name", "scenario", "batch", "capacity", "requests", "first_shape")
    same += ("homogeneous", "num_parties")
    for g, w in zip(got, want, strict=True):
        assert {k: g[k] for k in same} == {k: w[k] for k in same}
        assert g["parity_max_abs"] <= 1e-5 and g["rows_per_s"] > 0
        assert g["p99_ms"] >= g["metric"] > 0
    assert got[1]["cache_misses"] == 0
    assert torch_serving.check_serving_gate(got) == []


def test_cli_serves_a_port_saved_artifact_and_holds_the_gate(tmp_path, capsys):
    art = _port_from(_reference_artifact("mlp_k2", seed=2))  # the gate's MLP bounds
    save_artifact(str(tmp_path / "art"), art)
    out = tmp_path / "bench.json"
    argv = ["--artifact", str(tmp_path / "art"), "--device", "cpu", "--requests", "2"]
    assert torch_serving.main(argv + ["--check-gate", "--out", str(out)]) == 0
    blob = json.loads(out.read_text())
    assert blob["device"] == "cpu" and [r["batch"] for r in blob["rows"]] == [1, 64, 1024]
    assert "serving gate: parity at 1e-5" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            torch_serving.main(["--artifact", str(tmp_path / "art"), "--out", str(out)])


def test_cli_trains_saves_and_serves_the_reloaded_artifact(tmp_path, capsys):
    out = tmp_path / "bench.json"
    argv = ["--train", "--smoke", "--device", "cpu", "--requests", "2", "--batch-sizes", "1", "8"]
    argv += ["--save-artifact", str(tmp_path / "art"), "--check-gate", "--out", str(out)]
    assert torch_serving.main(argv) == 0
    text = capsys.readouterr().out
    assert "trained hard/overlap-32: auc=" in text and "saved artifact ->" in text
    art = load_artifact(str(tmp_path / "art"), device="cpu")
    assert art.scenario == "hard/overlap-32" and art.overlap_reps[0].shape == (32, 16)
    rows = json.loads(out.read_text())["rows"]
    assert [r["batch"] for r in rows] == [1, 8] and rows[1]["cache_misses"] == 0


@pytest.mark.parametrize("sweep", ["--path-sweep", "--router-sweep"])
def test_sweeps_refuse_the_cpu(sweep):
    with pytest.raises(SystemExit, match="CUDA device"):
        torch_serving.main([sweep, "--device", "cpu"])


def test_train_artifact_is_the_reference_recipe():
    """``--train``'s artifact: the scenario's budgets and metric, its overlap
    reps, and a finite forward."""
    art = torch_serving.train_artifact(seed=1, smoke=True, device="cpu")
    assert (art.protocol["client_epochs"], art.protocol["server_epochs"]) == (80, 40)
    assert art.metric_name == "auc" and art.metric > 0.6
    x = [torch.zeros(3, 20), torch.ones(3, 20)]
    assert torch.isfinite(art.predict_logits(x)).all()
    assert art.overlap_reps[1].shape == (32, 16)
