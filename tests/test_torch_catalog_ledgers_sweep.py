"""The port's one-shot and few-shot ledgers equal the reference's, event
for event, on the ``credit/overlap-N`` sweep up to N = 256, by the rules and helpers of
``test_torch_catalog.py`` (the reference's seed-0 splits, one epoch: the
ledgers do not depend on the budgets)."""

import pytest

from test_torch_catalog import (  # noqa: F401 (one_torch_thread: an autouse fixture)
    check_catalog_ledgers,
    one_torch_thread,
)

NAMES = [f"credit/overlap-{n}" for n in (32, 64, 128, 256)]


@pytest.mark.parametrize("protocol", ["one-shot", "few-shot"])
@pytest.mark.parametrize("name", NAMES)
def test_ledger_equals_the_references(name, protocol):
    check_catalog_ledgers(name, protocol)
