"""The port's one-shot and few-shot ledgers equal the reference's, event
for event, on the hard family (the padded pair included) and ``image/patch-4``, by the rules and helpers of
``test_torch_catalog.py`` (the reference's seed-0 splits, one epoch: the
ledgers do not depend on the budgets)."""

import pytest

from test_torch_catalog import (  # noqa: F401 (one_torch_thread: an autouse fixture)
    check_catalog_ledgers,
    one_torch_thread,
)

NAMES = [
    "hard/overlap-32",
    "hard/overlap-64",
    "hard/overlap-32-eq",
    "hard/overlap-64-eq",
    "image/patch-4",
]


@pytest.mark.parametrize("protocol", ["one-shot", "few-shot"])
@pytest.mark.parametrize("name", NAMES)
def test_ledger_equals_the_references(name, protocol):
    check_catalog_ledgers(name, protocol)
