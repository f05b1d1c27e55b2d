"""The port's one-shot and few-shot ledgers under every ``fault/*`` member
equal the reference's, event for event, and ``chip_smoke.FAULT_LEDGERS``
holds the reference's totals (the reference's seed-0 split, one epoch: the
ledgers do not depend on the budgets). The fault diagnostics are the
reference's too."""

import math

import jax
import pytest

from repro import scenarios as jscen
from repro.core import ProtocolConfig as RefConfig
from repro.core import run_few_shot as ref_few_shot
from repro.core import run_one_shot as ref_one_shot
from repro_torch import scenarios
from repro_torch.core import protocol as tproto
from repro_torch.data import split_from_numpy

from test_torch_catalog import (  # noqa: F401 (one_torch_thread: an autouse fixture)
    ONE_EPOCH,
    chip_smoke,
    events,
    one_torch_thread,
)

FAULT_NAMES = [n for n in jscen.names() if n.startswith("fault/")]
DIAG_KEYS = ("fault_kind", "parties_survived", "fault_stage")


def test_every_fault_member_has_a_ledger_entry():
    assert sorted(chip_smoke.FAULT_LEDGERS) == sorted(FAULT_NAMES) == sorted(chip_smoke.FAULT_NAMES)
    assert len(FAULT_NAMES) == 9


@pytest.mark.parametrize("protocol", ["one-shot", "few-shot"])
@pytest.mark.parametrize("name", FAULT_NAMES)
def test_ledger_equals_the_references(name, protocol):
    bundle = jscen.build(name, seed=0)
    ref_runner, port_runner, times = {
        "one-shot": (ref_one_shot, tproto.run_one_shot, 3),
        "few-shot": (ref_few_shot, tproto.run_few_shot, 5),
    }[protocol]
    ref = ref_runner(
        jax.random.PRNGKey(0), bundle.split, bundle.extractors, bundle.ssl_cfgs,
        RefConfig(**ONE_EPOCH), fault=bundle.spec.fault,
    )
    spec = scenarios.get(name)
    port = port_runner(
        0,
        split_from_numpy(bundle.split, "cpu"),
        scenarios.extractor_specs_for(spec),
        scenarios.ssl_configs_for(spec),
        tproto.ProtocolConfig(**ONE_EPOCH),
        device="cpu",
        fault=spec.fault,
    )
    assert events(port.ledger) == events(ref.ledger)
    assert port.ledger.summary() == ref.ledger.summary()
    assert port.ledger.comm_times() == ref.ledger.comm_times() == times
    total = (ref.ledger.total_bytes(), ref.ledger.comm_times())
    assert chip_smoke.FAULT_LEDGERS[name][protocol] == total
    assert {k: port.diagnostics.get(k) for k in DIAG_KEYS} == {
        k: ref.diagnostics.get(k) for k in DIAG_KEYS
    }
    assert math.isfinite(port.metric)
    if spec.fault is not None:
        assert port.diagnostics["degraded_metric"] == port.metric
