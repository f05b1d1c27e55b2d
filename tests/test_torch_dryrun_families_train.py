"""``launch.dryrun.record`` of each family's train step on
``make_debug_mesh((2, 2))``: the checks of ``test_torch_dryrun_families.py``
(the reference's parameter count, per-device dot FLOPs the one-device
step's split four ways) on the forward, the backward and the update."""

import pytest
from torch_spmd_cases import FAMILIES, check_record


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_record_on_a_debug_mesh(family):
    check_record(family, "train")
