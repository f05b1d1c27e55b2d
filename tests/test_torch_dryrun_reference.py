"""The port's dry-run counts held against the reference's compiled HLO:
``launch.dryrun.record`` of each family's reduced config on a (2, 2) fake
mesh, and the reference's lowering of the same config on 4 forced host
devices read by ``repro.roofline.hlo_analysis.analyze_hlo_text``. Per
device, the dot FLOPs agree within ``REFERENCE_BOUNDS``, and both steps
move data with all-gathers and all-reduces. Prefill and decode here; train
in ``test_torch_dryrun_reference_train.py``."""

import pytest
from torch_spmd_cases import FAMILIES, both_counts, check_against_reference

KINDS = ["prefill", "decode"]


@pytest.fixture(scope="module")
def counts(tmp_path_factory):
    return both_counts(KINDS, tmp_path_factory.mktemp("reference"))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_dot_flops_match_the_reference(counts, family, kind):
    check_against_reference(counts, family, kind)
