"""The port's few-shot VFL (Alg. 2) end to end on ``hard/overlap-64``, by
the rules and helpers of ``test_torch_few_shot.py``: the ledger equals the
reference's event for event, and the AUC margins over the reference's and
the port's ``run_vanilla`` clear ``benchmarks/frontier_baseline.json``'s few-shot
limits; and the few-shot CLI runs on the CPU."""

import pytest

from test_torch_few_shot import (  # noqa: F401 (one_torch_thread: an autouse fixture)
    check_diagnostics,
    check_ledger,
    check_margins,
    one_torch_thread,
    port_vanilla_runs,
    scenario_runs,
)

NAME = "hard/overlap-64"


@pytest.fixture(scope="module")
def runs():
    return scenario_runs(NAME)


def test_ledger_equals_reference(runs):
    check_ledger(runs, 191616)


def test_few_shot_beats_vanilla_on_the_same_splits(runs):
    check_margins(runs, NAME)


def test_few_shot_beats_the_ports_vanilla_on_the_same_splits(runs):
    check_margins(runs, NAME, port_vanilla_runs(runs, NAME))


def test_diagnostics(runs):
    check_diagnostics(runs)


def test_few_shot_cli_on_cpu(capsys):
    from repro_torch.launch import few_shot

    assert few_shot.main(["--scenario", NAME, "--device", "cpu", "--seed", "1"]) == 0
    out = capsys.readouterr().out
    assert f"{NAME} seed 1 on cpu" in out and "its one-shot pass" in out
    assert "comm times/client  : 5" in out and "pseudo_label_probs" in out
    assert "gate rate / party" in out and "5p_local_ssl" in out
