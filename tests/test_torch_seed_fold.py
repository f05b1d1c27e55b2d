"""The seed fold of the port: ``run_seeds`` and its engine pieces.

Counterpart of ``tests/test_seed_batched.py``. Splits come from the
reference through numpy (rule (a)). What is held here:

* ``run_seeds`` equals a loop of the port's single-seed runners at 1e-5
  (metric, final parameters, p̂) with byte-identical ledgers, for one-shot,
  few-shot and few-shot + finetune on ``hard/overlap-32`` at seeds 0-1;
* the folded ledgers equal the reference's ``run_seeds`` ledgers, event for
  event;
* the stacked session equals ``train_party_ssl`` party by party for 10
  steps, under a partial ``step_valid`` mask and a padded ``-eq`` mask;
* ``pseudo_labels_seeds`` equals per-entry searches bit for bit, and its
  ragged fallback is recorded;
* heterogeneous splits, heterogeneous parties and unregistered runners fall
  back to the loop; per-seed state kwargs are refused;
* an image scenario folds through the stacked CNN session.
"""

import dataclasses
import logging

import jax
import numpy as np
import pytest
import torch

from repro import scenarios as jscen
from repro.core import ProtocolConfig as RefConfig
from repro.core import run_few_shot as ref_few_shot
from repro.core import run_one_shot as ref_one_shot
from repro.core.protocol import run_seeds as ref_run_seeds
from repro_torch import scenarios
from repro_torch.core import clustering
from repro_torch.core.client import make_client, ssl_task_for
from repro_torch.core.comm import CommLedger
from repro_torch.core.protocol import (
    ProtocolConfig,
    run_few_shot,
    run_few_shot_finetune,
    run_one_shot,
    run_seeds,
)
from repro_torch.data import split_from_numpy
from repro_torch.engine import batched, dispatch, local_ssl, sessions

from test_torch_catalog import events, one_torch_thread  # noqa: F401 (autouse fixture)

NAME = "hard/overlap-32"
SEEDS = (0, 1)
FAST = ProtocolConfig(client_epochs=2, server_epochs=3)
ONE_EPOCH = dict(client_epochs=1, server_epochs=1)
TOL = 1e-5
FINETUNE_ITERATIONS = 40


def specs_of(name):
    spec = scenarios.get(name)
    return list(scenarios.extractor_specs_for(spec)), scenarios.ssl_configs_for(spec)


def ref_splits(name, seeds=SEEDS, smoke=False):
    return [jscen.build(name, seed=s, smoke=smoke).split for s in seeds]


def port_splits(name, seeds=SEEDS, smoke=False):
    return [split_from_numpy(sp, "cpu") for sp in ref_splits(name, seeds, smoke)]


@pytest.fixture(scope="module")
def splits():
    return port_splits(NAME)


def params_of(res):
    return [p for c in res.clients for p in (*c.extractor.parameters(), *c.head.parameters())]


def assert_same_run(got, want, tol=TOL):
    """One run of a fold against its single-seed run: metric and every final
    parameter within ``tol``, byte-identical ledgers, p̂ within ``tol``."""
    assert abs(got.metric - want.metric) <= tol
    for p, q in zip(params_of(got), params_of(want), strict=True):
        torch.testing.assert_close(p, q, atol=tol, rtol=0)
    assert events(got.ledger) == events(want.ledger)
    assert got.ledger.summary() == want.ledger.summary()
    step3p = "fewshot_step3p"
    if step3p in want.diagnostics:
        for a, b in zip(got.diagnostics[step3p]["probs"], want.diagnostics[step3p]["probs"]):
            torch.testing.assert_close(a, b, atol=tol, rtol=0)


def fold_and_loop(runner, splits, names=None, cfg=FAST, seeds=SEEDS, **kw):
    names = names or [NAME] * len(seeds)
    exts = [specs_of(n)[0] for n in names]
    ssls = [specs_of(n)[1] for n in names]
    fold = run_seeds(runner, list(seeds), splits, exts, ssls, cfg, device="cpu", **kw)
    loop = [
        runner(s, sp, e, c, cfg, device="cpu", **kw)
        for s, sp, e, c in zip(seeds, splits, exts, ssls)
    ]
    return fold, loop


def _finetune(seed, split, exts, ssls, cfg, device=None):
    return run_few_shot_finetune(seed, split, exts, ssls, cfg, FINETUNE_ITERATIONS, device=device)


@pytest.mark.parametrize(
    "runner", [run_one_shot, run_few_shot, run_few_shot_finetune], ids=lambda r: r.__name__
)
def test_run_seeds_equals_the_single_seed_loop(runner, splits):
    exts, ssls = specs_of(NAME)
    fold = run_seeds(
        runner, list(SEEDS), splits, [exts] * 2, [ssls] * 2, FAST, device="cpu",
        **({"finetune_iterations": FINETUNE_ITERATIONS} if runner is run_few_shot_finetune else {}),
    )
    for seed, split, got in zip(SEEDS, splits, fold):
        want = (_finetune if runner is run_few_shot_finetune else runner)(
            seed, split, exts, ssls, FAST, device="cpu"
        )
        assert_same_run(got, want)
        d = got.diagnostics
        assert (d["seed_fold"], d["scenario_fold"], d["kernel_fold"]) == (2, 1, 4)
        # the fold stacks; one K = 2 MLP entry trains by the one-party loop
        assert (d["engine_path"], want.diagnostics["engine_path"]) == ("vmap", "python")
    assert fold[0].ledger is not fold[1].ledger  # each result holds its own copy


@pytest.mark.parametrize("protocol", ["one-shot", "few-shot"])
def test_folded_ledgers_equal_the_references_run_seeds(protocol, splits):
    ref_runner, runner = {
        "one-shot": (ref_one_shot, run_one_shot),
        "few-shot": (ref_few_shot, run_few_shot),
    }[protocol]
    bundles = [jscen.build(NAME, seed=s) for s in SEEDS]
    ref = ref_run_seeds(
        ref_runner, [jax.random.PRNGKey(s) for s in SEEDS], [b.split for b in bundles],
        [b.extractors for b in bundles], [b.ssl_cfgs for b in bundles], RefConfig(**ONE_EPOCH),
    )
    exts, ssls = specs_of(NAME)
    got = run_seeds(
        runner, list(SEEDS), splits, [exts] * 2, [ssls] * 2, ProtocolConfig(**ONE_EPOCH),
        device="cpu",
    )
    for r, g in zip(ref, got):
        assert events(g.ledger) == events(r.ledger)
        assert g.ledger.summary() == r.ledger.summary()
        assert g.diagnostics["seed_fold"] == r.diagnostics["seed_fold"] == 2
        assert g.diagnostics["kernel_fold"] == r.diagnostics["kernel_fold"] == 4


def _tasks(split, seeds0, masked_steps):
    """K = 2 parties of ``split`` for two entries (their own inits), with
    the split's mask and a partial commit mask on every session."""
    gen = torch.Generator().manual_seed(5)
    exts, ssls = specs_of("hard/overlap-32-eq")
    tasks = []
    for _ in seeds0:
        for k in range(2):
            c = make_client(
                k, exts[k], tuple(split.aligned[k].shape[1:]), 2, ssls[k], gen,
                torch.device("cpu"), local_data_for_mean=split.unaligned[k],
            )
            tasks.append(
                ssl_task_for(
                    c, split.aligned[k], split.labels, split.unaligned[k],
                    labeled_mask=split.aligned_mask, step_valid=masked_steps,
                )
            )
    return tasks


def test_stacked_session_equals_train_party_ssl_under_both_masks():
    split = port_splits("hard/overlap-32-eq", seeds=(0,))[0]
    assert split.aligned_mask is not None and float(split.aligned_mask.sum()) == 32
    hp = local_ssl.SSLHParams(epochs=5, batch_size=32)  # 64 rows: 10 steps
    valid = torch.tensor([1, 1, 0, 1, 0, 0, 1, 1, 0, 0], dtype=torch.float32)
    stacked = _tasks(split, (0, 1), valid)
    loop = _tasks(split, (0, 1), valid)
    seeds0 = [11, 12, 13, 14]
    gens = [torch.Generator().manual_seed(3), torch.Generator().manual_seed(4)]
    draws = [local_ssl.draw_session(t, hp, g) for t, g in zip(stacked, [gens[0]] * 2 + [gens[1]] * 2)]
    assert [len(d) for d in draws] == [10] * 4
    got, path = local_ssl.train_clients_ssl(stacked, hp, seeds0, draws, mode="auto")
    assert path == "vmap"
    want = [
        local_ssl.train_party_ssl(t, hp, s, step_draws=d) for t, s, d in zip(loop, seeds0, draws)
    ]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert abs(g[k] - w[k]) <= TOL
    for a, b in zip(stacked, loop):
        pa = [*a.extractor.parameters(), *a.head.parameters()]
        pb = [*b.extractor.parameters(), *b.head.parameters()]
        for p, q in zip(pa, pb):
            torch.testing.assert_close(p, q, atol=TOL, rtol=0)
    # the masked steps froze the parameters: a session of only those steps is a no-op
    frozen = _tasks(split, (0,), torch.zeros(10))
    before = [p.clone() for t in frozen for p in (*t.extractor.parameters(), *t.head.parameters())]
    local_ssl.train_clients_ssl(frozen, hp, seeds0[:2], draws[:2], mode="vmap")
    after = [p for t in frozen for p in (*t.extractor.parameters(), *t.head.parameters())]
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_train_clients_ssl_picks_its_path_where_the_stack_pays():
    split = port_splits("hard/overlap-32-eq", seeds=(0,))[0]
    hp = local_ssl.SSLHParams(epochs=1, batch_size=32)
    tasks = _tasks(split, (0, 1), None)
    gen = torch.Generator().manual_seed(0)
    draws = [local_ssl.draw_session(t, hp, gen) for t in tasks]
    assert local_ssl.tasks_are_homogeneous(tasks)
    assert local_ssl.train_clients_ssl(tasks[:1], hp, [1], draws[:1])[1] == "python"
    # two MLP parties loop, four stack
    assert local_ssl.train_clients_ssl(tasks[:2], hp, [1, 2], draws[:2])[1] == "python"
    assert local_ssl.train_clients_ssl(tasks, hp, [1, 2, 3, 4], draws)[1] == "vmap"
    assert local_ssl.train_clients_ssl(tasks, hp, [1, 2, 3, 4], draws, mode="python")[1] == "python"
    assert local_ssl.train_clients_ssl(tasks[:2], hp, [1, 2], draws[:2], mode="vmap")[1] == "vmap"
    tasks = tasks[:2]
    mlp = sessions.module_spec(tasks[0].extractor)
    cnn = specs_of("image/halves")[0][0]
    assert cnn.kind == "cnn"
    assert [local_ssl.stack_pays(mlp, k) for k in (1, 2, 3, 4, 8)] == [False] * 3 + [True] * 2
    assert local_ssl.stack_pays(mlp, 2, num_entries=2) and local_ssl.stack_pays(mlp, 1, 4)
    assert not any(local_ssl.stack_pays(cnn, k, e) for k in (2, 4) for e in (1, 8))
    assert not local_ssl.stack_pays(None, 4, 4)
    assert local_ssl.train_clients_ssl(tasks[:1], hp, [1], draws[:1], mode="vmap")[1] == "vmap"
    wide = dataclasses.replace(tasks[1], x_labeled=torch.zeros(64, 7))
    assert not local_ssl.tasks_are_homogeneous([tasks[0], wide])
    with pytest.raises(ValueError, match="homogeneous"):
        local_ssl.train_clients_ssl([tasks[0], wide], hp, [1, 2], draws, mode="vmap")
    with pytest.raises(ValueError, match="unknown engine mode"):
        local_ssl.train_clients_ssl(tasks, hp, [1, 2], draws, mode="scan")
    exts, ssls = specs_of(NAME)
    assert local_ssl.parties_are_homogeneous(exts, ssls, [(32, 20), (32, 20)])
    assert not local_ssl.parties_are_homogeneous(exts, ssls, [(32, 18), (32, 5)])


def _grads(entries, n=32, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return [
        [torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)) for _ in range(2)]
        for _ in range(entries)
    ]


def test_pseudo_labels_seeds_equal_per_entry_searches_bit_for_bit():
    grads = _grads(3)
    info = {}
    got = batched.pseudo_labels_seeds(
        grads, 2, 25, 4, generators=[torch.Generator().manual_seed(s) for s in range(3)], info=info
    )
    assert info == {"fold": 6}
    for s, (g, labels) in enumerate(zip(grads, got)):
        want = dispatch.pseudo_labels_batched(
            torch.stack(g), 2, 25, 4, generator=torch.Generator().manual_seed(s)
        )
        for a, b in zip(labels, want):
            assert torch.equal(a, b)


def test_pseudo_labels_seeds_ragged_fallback_is_recorded(caplog):
    grads = _grads(1) + _grads(1, n=40, seed=1)
    info = {}
    batched._ragged_fallback_logged = False
    with caplog.at_level(logging.WARNING, logger="repro_torch.engine.batched"):
        got = batched.pseudo_labels_seeds(
            grads, 2, 25, 4, generators=[torch.Generator().manual_seed(s) for s in range(2)],
            info=info,
        )
    assert info == {"fold": 1, "fallback": "ragged gradient shapes"}
    assert "per-entry fallback" in caplog.text
    for s, (g, labels) in enumerate(zip(grads, got)):
        gen = torch.Generator().manual_seed(s)
        want = dispatch.pseudo_labels_batched(torch.stack(g), 2, 25, 4, generator=gen)
        assert all(torch.equal(a, b) for a, b in zip(labels, want))
    assert clustering.SeedingDraws  # the draws type the fold concatenates


def test_heterogeneous_splits_fall_back_to_the_loop():
    """Seeds whose splits differ in shape loop, even for a registered
    runner; the ledger identity holds where the byte-determining shapes
    agree (the baselines: batch size and rep width) and refuses the run
    where they do not (one-shot's N_o)."""
    from repro_torch.core.baselines import IterativeConfig, run_vanilla

    names = [NAME, "hard/overlap-64"]
    splits = [port_splits(NAME, (0,))[0], port_splits("hard/overlap-64", (1,))[0]]
    fold, loop = fold_and_loop(run_vanilla, splits, names, IterativeConfig(iterations=10))
    for got, want in zip(fold, loop):
        assert_same_run(got, want)
        assert got.diagnostics["seed_fold"] == 1
    with pytest.raises(ValueError, match="byte-identical"):
        fold_and_loop(run_one_shot, splits, names)


def test_heterogeneous_parties_train_per_entry_inside_the_fold():
    name = "credit/feature-skew"
    splits = port_splits(name, smoke=True)
    fold, loop = fold_and_loop(run_one_shot, splits, [name] * 2, ProtocolConfig(**ONE_EPOCH))
    for got, want in zip(fold, loop):
        assert_same_run(got, want)
        d = got.diagnostics
        assert d["engine_path"] == "python" and d["seed_fold"] == 2 and d["kernel_fold"] == 4


def test_unregistered_runner_falls_back_to_the_loop(splits):
    def my_runner(seed, split, exts, ssls, cfg=None, device=None):
        return run_one_shot(seed, split, exts, ssls, cfg, device=device)

    exts, ssls = specs_of(NAME)
    fold = run_seeds(my_runner, list(SEEDS), splits, [exts] * 2, [ssls] * 2, FAST, device="cpu")
    for seed, split, got in zip(SEEDS, splits, fold):
        assert_same_run(got, run_one_shot(seed, split, exts, ssls, FAST, device="cpu"))
        assert got.diagnostics["seed_fold"] == 1


@pytest.mark.parametrize("kwarg", ["clients", "server", "ledger"])
def test_per_seed_state_kwargs_are_refused(kwarg, splits):
    exts, ssls = specs_of(NAME)
    with pytest.raises(ValueError, match="per-seed state kwargs"):
        run_seeds(
            run_one_shot, list(SEEDS), splits, [exts] * 2, [ssls] * 2, FAST, device="cpu",
            **{kwarg: CommLedger()},
        )


def test_image_scenario_folds_through_the_stacked_cnn_session():
    name = "image/halves"
    splits = port_splits(name, smoke=True)
    cfg = ProtocolConfig(**ONE_EPOCH, engine_mode="vmap")  # "auto" loops the CNN
    fold, loop = fold_and_loop(run_one_shot, splits, [name] * 2, cfg)
    exts, ssls = specs_of(name)
    auto = dataclasses.replace(cfg, engine_mode="auto")
    for seed, split, got, want in zip(SEEDS, splits, fold, loop):
        assert_same_run(got, want)
        assert got.diagnostics["engine_path"] == "vmap"
        apart = run_one_shot(seed, split, exts, ssls, auto, device="cpu")
        assert apart.diagnostics["engine_path"] == "python"
        assert_same_run(got, apart)


def test_all_none_faults_are_the_fault_free_path(splits):
    exts, ssls = specs_of(NAME)
    plain = run_seeds(run_one_shot, list(SEEDS), splits, [exts] * 2, [ssls] * 2, FAST, device="cpu")
    nones = run_seeds(
        run_one_shot, list(SEEDS), splits, [exts] * 2, [ssls] * 2, FAST, device="cpu",
        faults=[None, None],
    )
    for a, b in zip(nones, plain):
        assert a.metric == b.metric
        assert events(a.ledger) == events(b.ledger)
        assert "fault_kind" not in a.diagnostics


def test_the_step3p_record_gates_to_its_probs(splits):
    """Each folded entry's ③' record holds the f_c that gated (⑥' refits a
    fresh one after it): re-gating the recorded reps with it and the aux
    heads gives the recorded p̂ exactly."""
    from repro_torch.core.server import VFLServer

    exts, ssls = specs_of(NAME)
    fold = run_seeds(run_few_shot, list(SEEDS), splits, [exts] * 2, [ssls] * 2, FAST, device="cpu")
    for res in fold:
        rec = res.diagnostics["fewshot_step3p"]
        assert rec["joint"] is not res.server.classifier
        server = VFLServer(2, rec["joint"], res.server.aux_classifiers)
        for k, (h, probs) in enumerate(zip(rec["h_u"], rec["probs"])):
            ests = []
            again = dispatch.fewshot_probs(server, k, h, rec["h_o"], FAST.fewshot_threshold, ests)
            assert torch.equal(again, probs)
            assert all(torch.equal(a, b) for a, b in zip(ests, rec["estimates"][k]))
