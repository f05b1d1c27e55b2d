"""The port's one-shot VFL (Alg. 1) end to end against the reference.

``hard/overlap-32`` splits come from the reference (``repro.scenarios``),
carried across through numpy, so both packages train on the same rows. PyTorch
cannot replay JAX's random streams, so whole runs compare by the rules of
the port: the communication ledger must be equal event for event, and the
port's mean AUC over seeds 0-1 must beat the reference's iterative baseline
(``run_vanilla``) on the same splits by the margin the reference itself is
gated on (``benchmarks/frontier_baseline.json``: ``min_mean_margin``), and
so must it beat the port's own ``run_vanilla`` (torch against torch).
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
from repro.core import run_one_shot as ref_one_shot
from repro_torch import scenarios
from repro_torch.core import baselines
from repro_torch.core.protocol import ProtocolConfig, run_one_shot
from repro_torch.data import split_from_numpy
from repro_torch.launch.vfl_serve import ServingEngine

ROOT = Path(__file__).resolve().parents[1]
GATE = json.loads((ROOT / "benchmarks" / "frontier_baseline.json").read_text())["hard/overlap-32"]
SEEDS = (0, 1)
# Served logits vs the trained server's forward: the same f32 layers on
# other batch compositions.
LOGIT_TOL = 1e-5


@pytest.fixture(scope="module")
def runs():
    spec = scenarios.HARD_OVERLAP_32
    cfg = ProtocolConfig(
        client_epochs=spec.budget("client_epochs", 20),
        server_epochs=spec.budget("server_epochs", 50),
    )
    out = []
    for seed in SEEDS:
        bundle = jscen.build("hard/overlap-32", seed=seed)
        vanilla = run_vanilla(
            jax.random.PRNGKey(seed),
            bundle.split,
            bundle.extractors,
            bundle.ssl_cfgs,
            IterativeConfig(iterations=bundle.spec.budget("iterations", 300)),
        )
        split = split_from_numpy(bundle.split, device="cpu")
        port = run_one_shot(
            seed,
            split,
            scenarios.extractor_specs_for(spec),
            scenarios.ssl_configs_for(spec),
            cfg,
            device="cpu",
        )
        out.append((bundle, split, vanilla, port))
    return out


@pytest.fixture(scope="module")
def port_vanilla(runs):
    """The port's run_vanilla on each seed's split at the scenario's budget."""
    spec = scenarios.HARD_OVERLAP_32
    cfg = baselines.IterativeConfig(iterations=spec.budget("iterations", 300))
    specs, ssl_cfgs = scenarios.extractor_specs_for(spec), scenarios.ssl_configs_for(spec)
    return [
        baselines.run_vanilla(seed, split, specs, ssl_cfgs, cfg, device="cpu")
        for seed, (_, split, _, _) in zip(SEEDS, runs)
    ]


def test_ledger_equals_reference(runs):
    bundle = runs[0][0]
    # the ledger is a function of shapes: a one-epoch reference run logs it
    ref = ref_one_shot(
        jax.random.PRNGKey(0),
        bundle.split,
        bundle.extractors,
        bundle.ssl_cfgs,
        RefConfig(client_epochs=1, server_epochs=1),
    )
    want = [e.__dict__ for e in ref.ledger.events]
    for _, _, _, port in runs:
        assert [e.__dict__ for e in port.ledger.events] == want
        assert port.ledger.total_bytes() == GATE["one_shot_bytes"] == 12288
        assert port.ledger.comm_times() == 3
        assert port.ledger.summary() == ref.ledger.summary()


def test_one_shot_beats_vanilla_on_the_same_splits(runs):
    port = [p.metric for *_, p in runs]
    vanilla = [v.metric for _, _, v, _ in runs]
    assert all(p.metric_name == "auc" for *_, p in runs)
    margin = float(np.mean(port) - np.mean(vanilla))
    assert margin >= GATE["min_mean_margin"], (port, vanilla)


def test_one_shot_beats_the_ports_vanilla_on_the_same_splits(runs, port_vanilla):
    port = [p.metric for *_, p in runs]
    vanilla = [v.metric for v in port_vanilla]
    assert all(v.metric_name == "auc" for v in port_vanilla)
    margin = float(np.mean(port) - np.mean(vanilla))
    assert margin >= GATE["min_mean_margin"], (port, vanilla)


def test_one_shot_beats_vanilla_with_limited_overlap(runs, port_vanilla):
    """The reference's headline test (``tests/test_core_protocol.py``), torch
    against torch at seed 0: one-shot beats iterative VFL on the 32-row
    overlap by a strict margin, at a fraction of the communication."""
    one, van = runs[0][3], port_vanilla[0]
    assert one.metric >= van.metric + 0.02
    assert one.ledger.total_bytes() * 100 <= van.ledger.total_bytes()
    assert one.ledger.comm_times() < van.ledger.comm_times() / 10


def test_step3_purity_and_diagnostics(runs):
    for *_, port in runs:
        assert len(port.diagnostics["kmeans_purity"]) == 2
        assert all(p > 0.5 for p in port.diagnostics["kmeans_purity"])
        assert port.diagnostics["ssl_steps"] == [80, 80]
        assert list(port.diagnostics["step_ms"]) == [
            "1_extract",
            "2_partial_grads",
            "3_kmeans",
            "4_local_ssl",
            "5_refresh",
            "6_server_fit",
            "eval",
        ]
        for m in port.diagnostics["ssl_metrics"]:
            assert np.isfinite(m["loss"]) and 0.0 <= m["pseudo_mask_rate"] <= 1.0


def test_trained_model_serves_through_the_engine(runs):
    _, split, _, port = runs[0]
    art = port.to_artifact("hard/overlap-32", split)
    assert art.feature_shapes == ((20,), (20,)) and art.num_classes == 2
    assert art.protocol["client_epochs"] == 80 and art.protocol["rep_dtype"] == "float32"
    # the overlap reps are the refreshed (step ⑤) uploads
    for h, c, x in zip(art.overlap_reps, port.clients, split.aligned):
        assert torch.equal(h, c.extract(x))
    engine = ServingEngine(art, capacity=128, device="cpu")
    got = engine.predict_logits(split.test_aligned)
    reps = [c.extract(x) for c, x in zip(port.clients, split.test_aligned)]
    want = port.server.predict_logits(reps)
    torch.testing.assert_close(got, want, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    # and a partial-party query runs the Eq. 10 estimate over those reps
    assert engine.predict_logits_partial(split.test_aligned[0][:7], 0).shape == (7, 2)


def test_gradient_noise_keeps_the_ledger(runs):
    _, split, _, base = runs[0]
    spec = scenarios.HARD_OVERLAP_32
    cfg = ProtocolConfig(client_epochs=2, server_epochs=2, grad_dp_sigma=0.5)
    specs, ssl_cfgs = scenarios.extractor_specs_for(spec), scenarios.ssl_configs_for(spec)
    noisy = run_one_shot(0, split, specs, ssl_cfgs, cfg, device="cpu")
    assert [e.__dict__ for e in noisy.ledger.events] == [e.__dict__ for e in base.ledger.events]
    assert np.isfinite(noisy.metric)


def test_image_path_runs_end_to_end_on_cpu():
    """The CNN / image-SSL path (the chip run's full-width configuration),
    at a tiny size: 10 classes, accuracy, the shape-only ledger."""
    spec = scenarios.ScenarioSpec(
        name="image/halves-tiny",
        modality="image",
        generator="image_classification",
        overlap=64,
        num_samples=400,
        gen_params=(("image_size", 8),),
        rep_dim=8,
        widths=(4, 8),
    )
    bundle = scenarios.build(spec, seed=0, device="cpu")
    assert [tuple(a.shape[1:]) for a in bundle.split.aligned] == [(8, 4, 3), (8, 4, 3)]
    res = run_one_shot(
        0, bundle.split, bundle.extractors, bundle.ssl_cfgs,
        ProtocolConfig(client_epochs=1, server_epochs=2, kmeans_iters=3), device="cpu",
    )
    assert res.metric_name == "accuracy" and 0.0 <= res.metric <= 1.0
    assert res.ledger.total_bytes() == 3 * 2 * 64 * 8 * 4 and res.ledger.comm_times() == 3
    art = res.to_artifact(spec.name, bundle.split)
    assert art.extractor_specs[0].kind == "cnn" and art.overlap_reps[0].shape == (64, 8)


def test_run_one_shot_defaults_to_cuda(runs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card error cannot show")
    _, split, _, _ = runs[0]
    spec = scenarios.HARD_OVERLAP_32
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_one_shot(0, split, scenarios.extractor_specs_for(spec), scenarios.ssl_configs_for(spec))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        scenarios.build(spec)


def test_one_shot_cli_on_cpu(capsys):
    from repro_torch.launch import one_shot

    assert one_shot.main(["--device", "cpu", "--seed", "2"]) == 0
    out = capsys.readouterr().out
    assert "hard/overlap-32 seed 2 on cpu" in out
    assert "comm times/client  : 3" in out and "reps_overlap_refreshed" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            one_shot.main([])
