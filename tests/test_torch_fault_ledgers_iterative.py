"""The port's iterative baselines under every ``fault/*`` member: ledgers
(the dropouts' retry rounds included) and fault diagnostics equal the
reference's at 8 iterations (``tests/test_faults.py``'s size), and
``chip_smoke.FAULT_LEDGERS`` holds the reference's fault plan at the
members' 200 iterations (FedBCD: 40 rounds)."""

from types import SimpleNamespace

import jax
import pytest

from repro import scenarios as jscen
from repro.core import baselines as jbase
from repro.core.comm import CommLedger as RefLedger
from repro_torch import scenarios
from repro_torch.core import baselines as tbase
from repro_torch.core.comm import CommLedger
from repro_torch.data import split_from_numpy

from test_torch_catalog import (  # noqa: F401 (one_torch_thread: an autouse fixture)
    chip_smoke,
    events,
    one_torch_thread,
)

FAULT_NAMES = [n for n in jscen.names() if n.startswith("fault/")]
METHODS = {"vanilla": ("run_vanilla", 1), "fedbcd": ("run_fedbcd", 1), "fedcvt": ("run_fedcvt", 2)}
DIAG_KEYS = (
    "fault_kind",
    "fault_stage",
    "parties_survived",
    "fault_modeled",
    "fault_retry_rounds",
    "fault_retry_bytes",
)


@pytest.mark.parametrize("method", list(METHODS))
@pytest.mark.parametrize("name", FAULT_NAMES)
def test_retry_ledger_and_diagnostics_equal_the_references(name, method):
    bundle = jscen.build(name, seed=0)
    spec = scenarios.get(name)
    runner = METHODS[method][0]
    ref = getattr(jbase, runner)(
        jax.random.PRNGKey(0), bundle.split, bundle.extractors, bundle.ssl_cfgs,
        jbase.IterativeConfig(iterations=8), fault=bundle.spec.fault,
    )
    port = getattr(tbase, runner)(
        0,
        split_from_numpy(bundle.split, "cpu"),
        scenarios.extractor_specs_for(spec),
        scenarios.ssl_configs_for(spec),
        tbase.IterativeConfig(iterations=8),
        device="cpu",
        fault=spec.fault,
    )
    assert events(port.ledger) == events(ref.ledger)
    assert {k: port.diagnostics.get(k) for k in DIAG_KEYS} == {
        k: ref.diagnostics.get(k) for k in DIAG_KEYS
    }
    if spec.fault is not None:
        assert port.diagnostics["degraded_metric"] == port.metric
    if "/dropout-" in name:
        tags = port.ledger.by_tag()
        retry = tags["retry_reps"][1] + tags["retry_timeout"][1]
        assert retry == port.diagnostics["fault_retry_bytes"] > 0


@pytest.mark.parametrize("method", list(METHODS))
@pytest.mark.parametrize("name", FAULT_NAMES)
def test_fault_plan_at_the_members_budget_equals_the_references(name, method):
    """The ledger of a 200-iteration run (40 FedBCD rounds) is its fault
    plan: the reference's ``_iterative_fault_plan`` for four rep-16 parties
    at batch 32, the port's ``log_fault_plan`` and FAULT_LEDGERS agree."""
    spec = scenarios.get(name)
    iterations = spec.budget("iterations", 300)
    steps = iterations // 5 if method == "fedbcd" else iterations
    factor = METHODS[method][1]
    clients = [SimpleNamespace(index=k, extractor=SimpleNamespace(rep_dim=16)) for k in range(4)]
    ledgers, _, _ = jbase._iterative_fault_plan([jscen.get(name).fault], clients, steps, 32, factor)
    ref = ledgers[0]
    assert isinstance(ref, RefLedger)
    port = CommLedger()
    tbase.log_fault_plan(port, spec.fault, [16] * 4, steps, 32, factor)
    assert events(port) == events(ref)
    assert chip_smoke.FAULT_LEDGERS[name][method] == (ref.total_bytes(), ref.comm_times())
