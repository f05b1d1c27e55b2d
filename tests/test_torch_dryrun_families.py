"""``launch.dryrun.record`` (the core of ``dryrun_pair``) on
``make_debug_mesh((2, 2))`` for a reduced config of each of the six
families, in prefill and decode (train in
``test_torch_dryrun_families_train.py``): the step runs on DTensor
parameters, batches and caches under ``FakeTensorMode``, the record holds
the reference's parameter count, and its per-device dot FLOPs are the
plain one-device step's split four ways: a region repeated on every
``model`` device, or on every ``data`` device, would add its share again.
The values of the same steps on a real 4-rank group are held against the
plain route in ``test_torch_spmd_parity_*.py``, and the counts against
the reference's compiled HLO in ``test_torch_dryrun_reference.py``."""

import pytest
from torch_spmd_cases import FAMILIES, check_record

from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world, make_debug_mesh


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_record_on_a_debug_mesh(family, kind):
    check_record(family, kind)


def test_microbatches_and_policies():
    cfg = get_config("phi4-mini-3.8b").reduced()
    shape = InputShape("train_t", 32, 8, "train")
    with fake_world(4):
        mesh = make_debug_mesh((2, 2))
        one = dryrun.record(cfg, shape, mesh, arch="phi4-mini-3.8b", full_depth=True)
        two = dryrun.record(cfg, shape, mesh, arch="phi4-mini-3.8b", microbatches=2,
                            fsdp_only=("blocks",), embed_single_axis=True, batch_both_axes=True,
                            full_depth=True)
    assert two["policy"] == {"microbatches": 2, "fsdp_only": ["blocks"], "batch_both_axes": True,
                             "embed_single_axis": True}
    assert one["hlo_analysis"]["dot_flops"] > 0 and two["hlo_analysis"]["dot_flops"] > 0
