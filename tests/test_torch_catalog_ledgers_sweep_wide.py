"""The port's one-shot and few-shot ledgers equal the reference's, event
for event, on the ``credit/overlap-N`` sweep from N = 512, and ``credit/label-noise``, by the rules and helpers of
``test_torch_catalog.py`` (the reference's seed-0 splits, one epoch: the
ledgers do not depend on the budgets)."""

import pytest

from test_torch_catalog import (  # noqa: F401 (one_torch_thread: an autouse fixture)
    check_catalog_ledgers,
    one_torch_thread,
)

NAMES = [
    "credit/overlap-512",
    "credit/overlap-1024",
    "credit/overlap-2048",
    "credit/label-noise",
]


@pytest.mark.parametrize("protocol", ["one-shot", "few-shot"])
@pytest.mark.parametrize("name", NAMES)
def test_ledger_equals_the_references(name, protocol):
    check_catalog_ledgers(name, protocol)
