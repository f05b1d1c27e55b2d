"""The zoo's train step on DTensors on a real 4-rank gloo group, held
against the plain one-device step on the same parameters and batch: the
loss to 1e-5 and every parameter's gradient to 2e-5 of its largest entry,
for each family and for the placements' and pins' variants
(``torch_spmd_cases.CASES``: grouped heads pinned on G, input-dim FSDP
with vocabulary-only embeddings, a (pod, data, model) mesh, experts whole
when E does not divide over ``model``, the SSM head pin). Activations are
f32 so the two routes differ by f32 rounding only. The dense cases run
here, the MoE ones in ``test_torch_spmd_parity_train_moe.py`` and the
others in ``test_torch_spmd_parity_train_families.py`` (one group each,
so each file stays short)."""

import pytest
from torch_spmd_cases import CASES, check_parity, parity_job

from repro_torch.launch import vfl_step

HERE = [c for c in CASES if c.startswith("dense")]
MICRO = ["dense"]
PAIRS = [(c, "train") for c in HERE] + [(c, "train-micro") for c in MICRO]



@pytest.fixture(scope="module")
def runs():
    ranks = vfl_step.run_parties(parity_job, [(PAIRS,)] * 4, timeout=300.0)
    return ranks[0]  # the plain route runs on rank 0, which compares


@pytest.mark.parametrize("case", HERE)
def test_train_step_matches_the_plain_route(runs, case):
    check_parity(runs[(case, "train")], "train")


@pytest.mark.parametrize("case", MICRO)
def test_microbatched_train_step_matches_the_plain_route(runs, case):
    """``make_train_step`` at 2 microbatches: the same loss (a MoE's drops
    depend on which rows share a microbatch)."""
    check_parity(runs[(case, "train-micro")], "train-micro")
