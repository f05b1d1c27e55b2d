"""The port's runners on the scenario catalog, against the reference.

Splits come from the reference (``repro.scenarios``) through numpy, so both
packages train on the same rows (rule (a)); sessions start from the same
parameters and draws (rule (b)). What is held here:

* ledgers do not depend on the epoch budgets (``credit/overlap-32``, both
  packages), so ``test_torch_catalog_ledgers_*.py`` compare every non-fault
  scenario's ledgers at one epoch (helpers below);
* the padded equal-shape pair: a 10-step masked ④ session and a 10-step ⑤'
  session on ``hard/overlap-32-eq`` end at the reference's parameters
  within 1e-5, and the protocol hands the split's mask to those two
  sessions and to nothing else;
* ``edge/full-overlap``: both protocols run with empty pools, no NaN, as
  the reference's do;
* bf16 reps (the counterpart of ``tests/test_protocol_quantized.py``): half
  the f32 one-shot bytes at nearly the same AUC, 3 comm times; and on
  ``hard/overlap-32`` the bf16 ledgers equal the reference's, 6144 and
  93440 bytes, p̂ staying f32.
"""

import dataclasses
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import scenarios as jscen
from repro.core import ProtocolConfig as RefConfig
from repro.core import SSLConfig as RefSSLConfig
from repro.core import client as jclient
from repro.core import protocol as jproto
from repro.core import run_few_shot as ref_few_shot
from repro.core import run_one_shot as ref_one_shot
from repro.data import make_tabular_credit, make_vfl_partition
from repro.engine import local_ssl as jlocal
from repro.models import extractors as jx
from repro_torch import bridge, scenarios
from repro_torch.checkpoint.artifact import ExtractorSpec
from repro_torch.core import client as tclient
from repro_torch.core import protocol as tproto
from repro_torch.core import ssl as tssl
from repro_torch.data import split_from_numpy
from repro_torch.engine import local_ssl as tlocal

from test_torch_ssl import _assert_tree_close, _ref_params, _t, ref_ssl_draws

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

# A 10-step masked session, relative to the parameters' scale (as
# test_torch_fewshot_units.py holds the unpadded one).
SESSION_RTOL = 1e-5
# bf16 against f32 reps: the reference's own bar (test_protocol_quantized.py)
BF16_AUC_GAP = 0.05
ONE_EPOCH = dict(client_epochs=1, server_epochs=1)
NON_FAULT = [n for n in jscen.names() if not n.startswith("fault/")]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Runs are thousands of tiny ops: one intra-op thread runs them faster
    than a spinning pool, and leaves the cores to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def events(ledger):
    return [e.__dict__ for e in ledger.events]


def port_run(runner, name, split, seed=0, **cfg):
    spec = scenarios.get(name)
    return runner(
        seed,
        split,
        scenarios.extractor_specs_for(spec),
        scenarios.ssl_configs_for(spec),
        tproto.ProtocolConfig(**cfg),
        device="cpu",
    )


def check_catalog_ledgers(name, protocol):
    """The port's one-shot or few-shot ledger at one epoch on the
    reference's seed-0 split equals the reference's event for event, and
    chip_smoke.py's table holds the reference's total."""
    bundle = jscen.build(name, seed=0)
    ref_runner, port_runner, col = {
        "one-shot": (ref_one_shot, tproto.run_one_shot, 0),
        "few-shot": (ref_few_shot, tproto.run_few_shot, 1),
    }[protocol]
    ref = ref_runner(
        jax.random.PRNGKey(0), bundle.split, bundle.extractors, bundle.ssl_cfgs,
        RefConfig(**ONE_EPOCH),
    )
    port = port_run(port_runner, name, split_from_numpy(bundle.split, "cpu"), **ONE_EPOCH)
    assert events(port.ledger) == events(ref.ledger)
    assert port.ledger.summary() == ref.ledger.summary()
    assert port.ledger.comm_times() == ref.ledger.comm_times() == (3 if col == 0 else 5)
    assert chip_smoke.CATALOG_LEDGERS[name][col] == ref.ledger.total_bytes()
    assert math.isfinite(port.metric)
    return port


LEDGER_FILES = ("sweep", "sweep_wide", "credit", "hard", "halves")


def test_every_non_fault_scenario_has_a_ledger_test():
    import importlib

    groups = [
        n for f in LEDGER_FILES for n in importlib.import_module(f"test_torch_catalog_ledgers_{f}").NAMES
    ]
    assert sorted(groups) == sorted(NON_FAULT) == sorted(chip_smoke.CATALOG_LEDGERS)
    assert len(NON_FAULT) == 18


def test_ledgers_do_not_depend_on_the_epoch_budgets():
    """credit/overlap-32 at its registered budgets (8 client, 30 server
    epochs): the reference's few-shot ledger is the port's at those budgets
    and at one epoch (which ``test_torch_catalog_ledgers_sweep.py`` holds
    against the reference's one-epoch ledger)."""
    name = "credit/overlap-32"
    bundle = jscen.build(name, seed=0)
    spec = bundle.spec
    full = dict(
        client_epochs=spec.budget("client_epochs", 20),
        server_epochs=spec.budget("server_epochs", 50),
    )
    assert full == {"client_epochs": 8, "server_epochs": 30}
    split = split_from_numpy(bundle.split, "cpu")
    ref_full = ref_few_shot(
        jax.random.PRNGKey(0), bundle.split, bundle.extractors, bundle.ssl_cfgs, RefConfig(**full)
    )
    port_full = port_run(tproto.run_few_shot, name, split, **full)
    port_one = port_run(tproto.run_few_shot, name, split, **ONE_EPOCH)
    assert events(port_full.ledger) == events(port_one.ledger) == events(ref_full.ledger)
    assert port_full.diagnostics["ssl_steps"] == [8, 8]  # 8 epochs of one 32-row batch


# ------------------------------------------------ the padded equal-shape pair
EQ = "hard/overlap-32-eq"


@pytest.fixture(scope="module")
def eq_split():
    bundle = jscen.build(EQ, seed=0)
    return bundle.split, split_from_numpy(bundle.split, "cpu")


def _eq_clients(pool, seed=3):
    """A reference client of hard/overlap-32-eq's party 0 and its port copy
    with the same seeded parameters (x̄ from the party's pool)."""
    spec = scenarios.get(EQ)
    n_feat, rep = pool.shape[1], spec.rep_dim
    ssl = dict(spec.ssl_params)
    ext = jx.make_mlp_extractor(rep, spec.hidden)
    ref = jclient.make_client(
        jax.random.PRNGKey(seed), 0, ext, 2, sample_input=jnp.asarray(pool[:4]),
        ssl_cfg=RefSSLConfig(modality="tabular", **ssl), local_data_for_mean=jnp.asarray(pool),
    )
    params = jclient.ClientParams(
        _ref_params(ext, np.zeros((1, n_feat), np.float32), seed + 1),
        _ref_params(jx.make_classifier(2), np.zeros((1, rep), np.float32), seed + 2),
    )
    ref = dataclasses.replace(ref, params=params)
    port = tclient.make_client(
        0, ExtractorSpec("mlp", rep, hidden=spec.hidden), (n_feat,), 2,
        tssl.SSLConfig(modality="tabular", **ssl), torch.Generator().manual_seed(seed),
        torch.device("cpu"), local_data_for_mean=_t(pool),
    )
    bridge.load_jax_params(port.extractor, params.extractor)
    bridge.load_jax_params(port.head, params.head)
    torch.testing.assert_close(port.feature_mean, _t(ref.feature_mean))
    return ref, port


def _session_matches(ref, port, task_r, task, epochs, seed=11):
    """Train both sessions from the same seed0 and per-step draws; the port
    ends at the reference's parameters, 10 steps in."""
    n_l, n_u = task.x_labeled.shape[0], task.x_unlabeled.shape[0]
    hp_r = jlocal.SSLHParams(epochs=epochs, batch_size=32)
    hp = tlocal.SSLHParams(epochs=epochs, batch_size=32)
    key = jax.random.PRNGKey(seed)
    params_r, _ = jlocal.train_party_ssl(key, task_r, hp_r)
    sched = jlocal.build_schedule(key, n_l, n_u, hp_r)
    steps = sched.step_keys.shape[0]
    assert steps == 10 == tlocal.schedule_steps(n_l, hp)
    bs_l, bs_u = sched.idx_labeled.shape[1], sched.idx_unlabeled.shape[1]
    n_feat = task.x_labeled.shape[1]
    draws = [
        ref_ssl_draws(sched.step_keys[i], ref.ssl_cfg, (bs_l, n_feat), (bs_u, n_feat))
        for i in range(steps)
    ]
    seed0 = int(jax.random.randint(key, (), 0, 2**31 - 1))
    tlocal.train_party_ssl(task, hp, seed0, step_draws=draws)
    _assert_tree_close(bridge.to_jax_params(port.extractor), params_r.extractor, SESSION_RTOL)
    _assert_tree_close(bridge.to_jax_params(port.head), params_r.head, SESSION_RTOL)
    start, end = jax.tree_util.tree_leaves(ref.params), jax.tree_util.tree_leaves(params_r)
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max()) for a, b in zip(start, end))
    assert moved > 100 * SESSION_RTOL


def _eq_pseudo(mask):
    """Pseudo-labels of the padded rows: a duplicate row has its original's
    gradient, so k-means gives it its original's label."""
    n_o = int(mask.sum())
    real = np.random.default_rng(8).integers(0, 2, n_o)
    return real[np.arange(mask.shape[0]) % n_o]


def test_padded_step4_session_matches_reference(eq_split):
    """④ on the padded block (64 rows, 32 real): the split's mask keeps the
    duplicates out of the labeled loss; 5 epochs of 2 batches."""
    split_r, split = eq_split
    x_o, x_u = np.asarray(split_r.aligned[0]), np.asarray(split_r.unaligned[0])
    ref, port = _eq_clients(x_u)
    pseudo = _eq_pseudo(np.asarray(split_r.aligned_mask))
    task_r = jclient.ssl_task_for(
        ref, jnp.asarray(x_o), jnp.asarray(pseudo), jnp.asarray(x_u),
        labeled_mask=split_r.aligned_mask,
    )
    task = tclient.ssl_task_for(
        port, split.aligned[0], _t(pseudo), split.unaligned[0], labeled_mask=split.aligned_mask
    )
    _session_matches(ref, port, task_r, task, epochs=5)


def test_padded_step5p_session_matches_reference(eq_split):
    """⑤' on the padded block and 256 pool rows: the labeled mask is the
    split's mask over the overlap part, the take mask over the pool (the
    reference's ``_few_shot_seeds`` construction); 1 epoch of 10 batches."""
    split_r, split = eq_split
    x_o = np.asarray(split_r.aligned[0])
    x_u = np.asarray(split_r.unaligned[0])[:256]
    ref, port = _eq_clients(np.asarray(split_r.unaligned[0]))
    pseudo = _eq_pseudo(np.asarray(split_r.aligned_mask))
    p = np.random.default_rng(9).uniform(size=256)
    probs = np.where(p > 0.5, p, 0.0).astype(np.float32)

    take_r = (jnp.asarray(probs) > 0).astype(jnp.float32)
    x_lab = jnp.concatenate([jnp.asarray(x_o), jnp.asarray(x_u)], axis=0)
    y_lab = jproto.fewshot_phase5_labels(
        ref, jnp.asarray(x_o), jnp.asarray(x_u), jnp.asarray(pseudo)
    )
    lab_mask = jnp.concatenate([split_r.aligned_mask.astype(jnp.float32), take_r])
    task_r = jclient.ssl_task_for(
        ref, x_lab, y_lab, jnp.asarray(x_u), labeled_mask=lab_mask, unlabeled_mask=1.0 - take_r
    )
    task, take = tproto.fewshot_task(
        port, split.aligned[0], _t(x_u), _t(probs), _t(pseudo), tproto.ProtocolConfig(),
        aligned_mask=split.aligned_mask,
    )
    np.testing.assert_array_equal(task.labeled_mask.numpy(), np.asarray(lab_mask))
    np.testing.assert_array_equal(task.unlabeled_mask.numpy(), np.asarray(task_r.unlabeled_mask))
    np.testing.assert_array_equal(task.y_pseudo.numpy(), np.asarray(y_lab))
    assert float(task.labeled_mask[:64].sum()) == 32
    _session_matches(ref, port, task_r, task, epochs=1)


@pytest.mark.parametrize("name", [EQ, "hard/overlap-64-eq"])
def test_protocol_masks_the_two_ssl_sessions_and_nothing_else(name, monkeypatch):
    """A one-epoch few-shot run on the padded split: ④'s labeled mask is
    the split's, ⑤''s is the split's over the overlap rows then the take
    mask; the mask reaches no other step (k-means, the fits and Eq. 10 see
    the duplicates, as the reference's do), so the ledger counts the padded
    rows: 3·2·64·16·4 = 24576 bytes one-shot."""
    tasks = []
    train = tproto.batched.train_clients_ssl_seeds

    def spy(tasks_per_seed, *args, **kw):
        tasks.extend(t for seed_tasks in tasks_per_seed for t in seed_tasks)
        return train(tasks_per_seed, *args, **kw)

    monkeypatch.setattr(tproto.batched, "train_clients_ssl_seeds", spy)
    bundle = jscen.build(name, seed=0)
    split = split_from_numpy(bundle.split, "cpu")
    res = port_run(tproto.run_few_shot, name, split, **ONE_EPOCH)
    mask = split.aligned_mask
    assert len(tasks) == 4
    for t in tasks[:2]:  # ④
        assert torch.equal(t.labeled_mask, mask) and t.unlabeled_mask is None
    for t, take in zip(tasks[2:], res.diagnostics["fewshot_step3p"]["probs"]):  # ⑤'
        assert torch.equal(t.labeled_mask, torch.cat([mask, (take > 0).float()]))
        assert torch.equal(t.unlabeled_mask, 1.0 - (take > 0).float())
    d = res.diagnostics
    assert [h.shape[0] for h in d["fewshot_step3p"]["h_o"]] == [64, 64]  # Eq. 10's keys
    assert [p.shape[0] for p in d["pseudo_labels"]] == [64, 64]  # k-means over the padding
    assert res.ledger.by_tag()["reps_overlap"] == (2, 2 * 64 * 16 * 4)
    assert res.ledger.total_bytes() == chip_smoke.CATALOG_LEDGERS[name][1] == 191616


# ------------------------------------------------------------- full overlap
def test_full_overlap_runs_both_protocols_like_the_reference():
    """Empty pools: zero-width unlabeled batches in ④, an empty ③' query
    (no Eq. 10 work), rates 0, finite metrics, the reference's ledgers."""
    name = "edge/full-overlap"
    bundle = jscen.build(name, seed=0)
    spec = bundle.spec
    budgets = dict(
        client_epochs=spec.budget("client_epochs", 20),
        server_epochs=spec.budget("server_epochs", 50),
    )
    args = (bundle.split, bundle.extractors, bundle.ssl_cfgs, RefConfig(**budgets))
    ref_one, ref_few = (r(jax.random.PRNGKey(0), *args) for r in (ref_one_shot, ref_few_shot))
    split = split_from_numpy(bundle.split, "cpu")
    assert [u.shape[0] for u in split.unaligned] == [0, 0]
    one = port_run(tproto.run_one_shot, name, split, **budgets)
    few = port_run(tproto.run_few_shot, name, split, **budgets)
    for port, ref in ((one, ref_one), (few, ref_few)):
        assert math.isfinite(ref.metric) and math.isfinite(port.metric)
        assert events(port.ledger) == events(ref.ledger)
        assert port.metric > 0.6  # the credit task over its 800 aligned rows
    d = few.diagnostics
    assert d["fewshot_gate_rate"] == d["fewshot_take_rate"] == [0.0, 0.0]
    assert [p.shape for p in d["fewshot_step3p"]["probs"]] == [(0,), (0,)]
    assert [e[0].shape for e in d["fewshot_step3p"]["estimates"]] == [(0, 16), (0, 16)]
    for params in (c.extractor.parameters() for c in few.clients):
        assert all(bool(torch.isfinite(p).all()) for p in params)
    assert few.ledger.total_bytes() == chip_smoke.CATALOG_LEDGERS[name][1]


# --------------------------------------------------------------- bf16 reps
def test_bf16_reps_half_bytes_same_auc():
    """tests/test_protocol_quantized.py's run on the port: the reference's
    data and split, MLP 16 (32) extractors, 2 client and 5 server epochs."""
    x, y = make_tabular_credit(jax.random.PRNGKey(0), 1200)
    split = split_from_numpy(
        make_vfl_partition(x, y, overlap_size=128, feature_sizes=[10, 13], seed=1), "cpu"
    )
    specs = [ExtractorSpec("mlp", 16, hidden=(32,))] * 2
    ssl = [tssl.SSLConfig(modality="tabular")] * 2
    results = {}
    for dt in (torch.float32, torch.bfloat16):
        cfg = tproto.ProtocolConfig(client_epochs=2, server_epochs=5, rep_dtype=dt)
        results[dt] = tproto.run_one_shot(1, split, specs, ssl, cfg, device="cpu")
    f32, bf16 = results[torch.float32], results[torch.bfloat16]
    assert bf16.ledger.total_bytes() * 2 == f32.ledger.total_bytes()
    assert abs(bf16.metric - f32.metric) < BF16_AUC_GAP, (bf16.metric, f32.metric)
    assert bf16.ledger.comm_times() == 3


def test_bf16_ledgers_on_hard_overlap_32_equal_the_references():
    name = "hard/overlap-32"
    bundle = jscen.build(name, seed=0)
    split = split_from_numpy(bundle.split, "cpu")
    cfg = RefConfig(rep_dtype=jnp.bfloat16, **ONE_EPOCH)
    args = (bundle.split, bundle.extractors, bundle.ssl_cfgs, cfg)
    want = chip_smoke.CATALOG_BF16_LEDGERS[name]
    for col, ref_runner, runner in ((0, ref_one_shot, tproto.run_one_shot),
                                    (1, ref_few_shot, tproto.run_few_shot)):
        ref = ref_runner(jax.random.PRNGKey(0), *args)
        port = port_run(runner, name, split, rep_dtype=torch.bfloat16, **ONE_EPOCH)
        assert events(port.ledger) == events(ref.ledger)
        assert port.ledger.total_bytes() == ref.ledger.total_bytes() == want[col]
    assert want == (6144, 93440)
    n_u = [u.shape[0] for u in split.unaligned]
    assert port.ledger.by_tag()["pseudo_label_probs"] == (2, 4 * sum(n_u))  # p̂ in f32
    assert port.ledger.by_tag()["reps_unaligned"] == (2, 2 * 16 * sum(n_u))
    step3p = port.diagnostics["fewshot_step3p"]
    assert all(h.dtype == torch.bfloat16 for h in step3p["h_u"] + step3p["h_o"])
    assert all(p.dtype == torch.float32 for p in step3p["probs"])
