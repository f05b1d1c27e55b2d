"""The port's iterative baselines and few-shot + finetune end to end against
the reference (``repro.core.baselines``, ``repro.core.protocol``).

Splits come from the reference, carried across through numpy. The ledger is
a function of shapes, so each of ``run_vanilla``, ``run_fedbcd``,
``run_fedcvt`` and ``run_few_shot_finetune`` must log the reference's
events one for one (party, direction, tag, bytes, round) on
``hard/overlap-32``; the finetune row is also held to the reference's own
test of it (``tests/test_extensions.py::test_few_shot_finetune_row``).
"""

import jax
import numpy as np
import pytest
import torch

from repro import scenarios as jscen
from repro.core import IterativeConfig as RefIterativeConfig
from repro.core import ProtocolConfig as RefConfig
from repro.core import run_fedbcd as ref_fedbcd
from repro.core import run_fedcvt as ref_fedcvt
from repro.core import run_few_shot_finetune as ref_finetune
from repro.core import run_vanilla as ref_vanilla
from repro.data import make_tabular_credit, make_vfl_partition
from repro_torch import scenarios
from repro_torch.checkpoint.artifact import ExtractorSpec
from repro_torch.core import baselines
from repro_torch.core.protocol import ProtocolConfig, run_few_shot, run_few_shot_finetune
from repro_torch.core.ssl import SSLConfig
from repro_torch.data import split_from_numpy

NAME = "hard/overlap-32"
ITERATIONS = 400  # the scenario's budget
# (method, bytes, comm times) on hard/overlap-32 at 400 iterations: 2 parties,
# bs 32, rep 16, f32; FedBCD in 80 rounds of Q = 5; FedCVT ships 2x.
WANT = {"vanilla": (3276800, 800), "fedbcd": (655360, 160), "fedcvt": (6553600, 800)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Thousands of tiny ops: one intra-op thread runs them faster than a
    spinning pool, and leaves the cores to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def hard():
    bundle = jscen.build(NAME, seed=0)
    spec = scenarios.CATALOG[NAME]
    split = split_from_numpy(bundle.split, device="cpu")
    return bundle, split, scenarios.extractor_specs_for(spec), scenarios.ssl_configs_for(spec)


def _events(ledger):
    return [e.__dict__ for e in ledger.events]


@pytest.mark.parametrize(
    "method,port_fn,ref_fn",
    [
        ("vanilla", baselines.run_vanilla, ref_vanilla),
        ("fedbcd", baselines.run_fedbcd, ref_fedbcd),
        ("fedcvt", baselines.run_fedcvt, ref_fedcvt),
    ],
)
def test_baseline_ledger_equals_reference(hard, method, port_fn, ref_fn):
    bundle, split, specs, ssl_cfgs = hard
    ref = ref_fn(
        jax.random.PRNGKey(0),
        bundle.split,
        bundle.extractors,
        bundle.ssl_cfgs,
        RefIterativeConfig(iterations=ITERATIONS),
    )
    port = port_fn(
        0, split, specs, ssl_cfgs, baselines.IterativeConfig(iterations=ITERATIONS), device="cpu"
    )
    assert _events(port.ledger) == _events(ref.ledger)
    assert (port.ledger.total_bytes(), port.ledger.comm_times()) == WANT[method]
    assert port.ledger.summary() == ref.ledger.summary()
    assert port.metric_name == "auc" and port.metric > 0.5  # the reference's own bar
    d = port.diagnostics
    assert d["losses"].shape == (ITERATIONS // 5 if method == "fedbcd" else ITERATIONS,)
    assert np.isfinite(d["final_loss"]) and d["final_loss"] == float(d["losses"][-1])
    assert list(d["step_ms"]) == ["setup", "session", "eval"]
    if method == "fedbcd":
        assert (d["rounds"], d["Q"]) == (80, 5)
    else:
        assert d["iterations"] == ITERATIONS


def test_few_shot_finetune_ledger_equals_reference(hard):
    bundle, split, specs, ssl_cfgs = hard
    ref = ref_finetune(
        jax.random.PRNGKey(0),
        bundle.split,
        bundle.extractors,
        bundle.ssl_cfgs,
        RefConfig(client_epochs=1, server_epochs=1),
    )
    port = run_few_shot_finetune(
        0, split, specs, ssl_cfgs, ProtocolConfig(client_epochs=1, server_epochs=1), device="cpu"
    )
    assert _events(port.ledger) == _events(ref.ledger)
    assert port.ledger.total_bytes() == 177408 + 1638400 == 1815808
    assert port.ledger.comm_times() == 5 + 2 * 200
    assert port.ledger.summary() == ref.ledger.summary()


def test_schedule_free_runs_are_exact_and_deterministic(hard):
    """iterations 0 leaves the fresh state and logs nothing; two runs at one
    seed are equal bit for bit."""
    _, split, specs, ssl_cfgs = hard
    empty = baselines.run_vanilla(
        3, split, specs, ssl_cfgs, baselines.IterativeConfig(iterations=0), device="cpu"
    )
    assert empty.ledger.events == [] and empty.diagnostics["final_loss"] is None
    cfg = baselines.IterativeConfig(iterations=30)
    a, b = (baselines.run_fedcvt(3, split, specs, ssl_cfgs, cfg, device="cpu") for _ in range(2))
    assert a.metric == b.metric and torch.equal(a.diagnostics["losses"], b.diagnostics["losses"])


@pytest.fixture(scope="module")
def credit():
    """The reference's finetune test's split and models
    (``tests/test_extensions.py``)."""
    x, y = make_tabular_credit(jax.random.PRNGKey(0), 1200)
    ref = make_vfl_partition(x, y, overlap_size=96, feature_sizes=[10, 13], seed=1)
    specs = [ExtractorSpec("mlp", 16, hidden=(32,))] * 2
    return split_from_numpy(ref, device="cpu"), specs, [SSLConfig(modality="tabular")] * 2


def test_few_shot_finetune_row(credit):
    """Tab. 1's last row, as the reference tests it: finetuning adds
    iterative comm on top of few-shot's 5 rounds, and its few-shot pass is
    ``run_few_shot`` at the same seed, draw for draw."""
    split, specs, ssl_cfgs = credit
    cfg = ProtocolConfig(client_epochs=2, server_epochs=5)
    res = run_few_shot_finetune(1, split, specs, ssl_cfgs, cfg, finetune_iterations=30, device="cpu")
    few = run_few_shot(1, split, specs, ssl_cfgs, cfg, device="cpu")
    assert res.metric > 0.6
    assert res.diagnostics["fewshot_metric"] == few.metric
    assert res.ledger.comm_times() == 5 + 2 * 30
    assert res.diagnostics["iterations"] == 30
    assert list(res.diagnostics["step_ms"])[-3:] == [
        "finetune_setup",
        "finetune_session",
        "finetune_eval",
    ]


def test_runners_default_to_cuda(hard):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card error cannot show")
    _, split, specs, ssl_cfgs = hard
    cfg = baselines.IterativeConfig(iterations=1)
    for fn in (baselines.run_vanilla, baselines.run_fedbcd, baselines.run_fedcvt):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(0, split, specs, ssl_cfgs, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_few_shot_finetune(0, split, specs, ssl_cfgs, ProtocolConfig(client_epochs=1))
