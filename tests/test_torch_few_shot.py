"""The port's few-shot VFL (Alg. 2) end to end against the reference, on
``hard/overlap-32`` (``test_torch_few_shot_64.py`` runs ``hard/overlap-64``
through the helpers here, and the CLI).

Splits come from the reference (``repro.scenarios``), carried across through
numpy, so both packages train on the same rows. PyTorch cannot replay JAX's
random streams, so whole runs compare by the rules of the port: the ledger
must equal the reference's ``run_few_shot`` ledger event for event, and the
port's AUC over seeds 0-1 must beat the reference's iterative baseline
(``run_vanilla``) on the same splits by the margins the reference itself is
gated on (``benchmarks/frontier_baseline.json``: ``fewshot_min_mean_margin``
on the mean, ``fewshot_min_worst_margin`` on the worst seed), and so must it
beat the port's own ``run_vanilla`` (torch against torch).
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import scenarios as jscen
from repro.core import IterativeConfig, run_vanilla
from repro.core import ProtocolConfig as RefConfig
from repro.core import run_few_shot as ref_few_shot
from repro_torch import scenarios
from repro_torch.core import baselines
from repro_torch.core.protocol import ProtocolConfig, run_few_shot, run_one_shot
from repro_torch.data import split_from_numpy
from repro_torch.launch.vfl_serve import ServingEngine

ROOT = Path(__file__).resolve().parents[1]
GATES = json.loads((ROOT / "benchmarks" / "frontier_baseline.json").read_text())
SEEDS = (0, 1)
# Served logits vs the trained server's forward: the same f32 layers on
# other batch compositions.
LOGIT_TOL = 1e-5
NAME = "hard/overlap-32"


def budget_cfg(spec) -> ProtocolConfig:
    return ProtocolConfig(
        client_epochs=spec.budget("client_epochs", 20),
        server_epochs=spec.budget("server_epochs", 50),
    )


def scenario_runs(name):
    """(reference bundle, port split, reference run_vanilla, port
    run_few_shot) for each seed of SEEDS, at the scenario's budgets."""
    spec = scenarios.CATALOG[name]
    out = []
    for seed in SEEDS:
        bundle = jscen.build(name, seed=seed)
        vanilla = run_vanilla(
            jax.random.PRNGKey(seed),
            bundle.split,
            bundle.extractors,
            bundle.ssl_cfgs,
            IterativeConfig(iterations=bundle.spec.budget("iterations", 300)),
        )
        split = split_from_numpy(bundle.split, device="cpu")
        port = run_few_shot(
            seed,
            split,
            scenarios.extractor_specs_for(spec),
            scenarios.ssl_configs_for(spec),
            budget_cfg(spec),
            device="cpu",
        )
        out.append((bundle, split, vanilla, port))
    return out


def check_ledger(runs, want_bytes):
    """Every run's ledger equals a one-epoch reference run's event for event
    (communication is a function of shapes)."""
    bundle = runs[0][0]
    ref = ref_few_shot(
        jax.random.PRNGKey(0),
        bundle.split,
        bundle.extractors,
        bundle.ssl_cfgs,
        RefConfig(client_epochs=1, server_epochs=1),
    )
    want = [e.__dict__ for e in ref.ledger.events]
    assert ref.ledger.total_bytes() == want_bytes
    n_u = [u.shape[0] for u in bundle.split.unaligned]
    for _, _, _, port in runs:
        assert [e.__dict__ for e in port.ledger.events] == want
        assert port.ledger.total_bytes() == want_bytes
        assert port.ledger.comm_times() == 5
        assert port.ledger.summary() == ref.ledger.summary()
        by_tag = port.ledger.by_tag()
        assert by_tag["reps_unaligned"] == (2, sum(n * 16 * 4 for n in n_u))
        assert by_tag["pseudo_label_probs"] == (2, sum(n * 4 for n in n_u))


def port_vanilla_runs(runs, name):
    """The port's run_vanilla on each seed's split at the scenario's budget."""
    spec = scenarios.CATALOG[name]
    cfg = baselines.IterativeConfig(iterations=spec.budget("iterations", 300))
    specs, ssl_cfgs = scenarios.extractor_specs_for(spec), scenarios.ssl_configs_for(spec)
    return [
        baselines.run_vanilla(seed, split, specs, ssl_cfgs, cfg, device="cpu")
        for seed, (_, split, _, _) in zip(SEEDS, runs)
    ]


def check_margins(runs, name, vanilla_runs=None):
    """Mean and worst-seed AUC margins of few-shot over run_vanilla: the
    reference's in ``runs``, or the port's results ``vanilla_runs``."""
    gate = GATES[name]
    port = np.array([p.metric for *_, p in runs])
    if vanilla_runs is None:
        vanilla_runs = [v for _, _, v, _ in runs]
    assert all(v.metric_name == "auc" for v in vanilla_runs)
    vanilla = np.array([v.metric for v in vanilla_runs])
    assert all(p.metric_name == "auc" for *_, p in runs)
    margins = port - vanilla
    assert margins.mean() >= gate["fewshot_min_mean_margin"], (port, vanilla)
    assert margins.min() >= gate["fewshot_min_worst_margin"], (port, vanilla)


def check_diagnostics(runs):
    for _, split, _, port in runs:
        d = port.diagnostics
        n_o = split.aligned[0].shape[0]
        n_u = [u.shape[0] for u in split.unaligned]
        assert d["ssl_steps"] == [80 * (n_o // 32)] * 2
        assert d["fewshot_ssl_steps"] == [80 * ((n_o + n) // 32) for n in n_u]
        assert len(d["ssl_metrics"]) == 4  # ④ then ⑤', party by party
        assert list(d["step_ms"])[-6:] == [
            "1p_unaligned",
            "2p_aux_fit",
            "3p_estimate_gate",
            "5p_local_ssl",
            "6p_server_refit",
            "eval_few_shot",
        ]
        for gate, take, p in zip(
            d["fewshot_gate_rate"], d["fewshot_take_rate"], d["fewshot_step3p"]["probs"]
        ):
            assert 0.0 < gate < 1.0 and take == gate  # the paper's keep-all-gated rule
            assert p.dtype == torch.float32 and bool(((p == 0) | (p > 0.9)).all())


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """A run is thousands of tiny ops: one intra-op thread runs them faster
    than a spinning pool, and leaves the cores to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def runs():
    return scenario_runs(NAME)


def test_ledger_equals_reference(runs):
    check_ledger(runs, 177408)


def test_few_shot_beats_vanilla_on_the_same_splits(runs):
    check_margins(runs, NAME)


def test_few_shot_beats_the_ports_vanilla_on_the_same_splits(runs):
    check_margins(runs, NAME, port_vanilla_runs(runs, NAME))


def test_diagnostics(runs):
    check_diagnostics(runs)


def test_one_shot_pass_equals_run_one_shot(runs):
    """Few-shot's one-shot pass draws exactly what run_one_shot draws at the
    same seed: equal pseudo-labels, ⑤ uploads and AUC."""
    _, split, _, few = runs[0]
    spec = scenarios.CATALOG[NAME]
    one = run_one_shot(
        0,
        split,
        scenarios.extractor_specs_for(spec),
        scenarios.ssl_configs_for(spec),
        budget_cfg(spec),
        device="cpu",
    )
    d = few.diagnostics
    assert d["one_shot_metric"] == one.metric
    for a, b in zip(d["pseudo_labels"], one.diagnostics["pseudo_labels"]):
        assert torch.equal(a, b)
    for h, c, x in zip(d["fewshot_step3p"]["h_o"], one.clients, split.aligned):
        assert torch.equal(h, c.extract(x))
    assert d["kmeans_purity"] == one.diagnostics["kmeans_purity"]


def test_few_shot_model_serves_through_the_engine(runs):
    _, split, _, port = runs[0]
    art = port.to_artifact(NAME, split)
    assert art.num_classes == 2 and art.protocol["fewshot_threshold"] == 0.9
    # the overlap reps are the final (step ⑥') uploads
    for h, c, x in zip(art.overlap_reps, port.clients, split.aligned):
        assert torch.equal(h, c.extract(x))
    engine = ServingEngine(art, capacity=128, device="cpu")
    got = engine.predict_logits(split.test_aligned)
    reps = [c.extract(x) for c, x in zip(port.clients, split.test_aligned)]
    want = port.server.predict_logits(reps)
    torch.testing.assert_close(got, want, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    assert engine.predict_logits_partial(split.test_aligned[1][:9], 1).shape == (9, 2)


def test_run_few_shot_and_its_cli_default_to_cuda(runs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card error cannot show")
    from repro_torch.launch import few_shot

    _, split, _, _ = runs[0]
    spec = scenarios.CATALOG[NAME]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_few_shot(0, split, scenarios.extractor_specs_for(spec), scenarios.ssl_configs_for(spec))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        few_shot.main(["--scenario", NAME])

