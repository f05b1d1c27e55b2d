"""The zoo's prefill and decode steps on DTensors on a real 4-rank gloo
group, held against the plain one-device steps on the same parameters,
batch and cache (``torch_spmd_cases.CASES``): logits to 1e-5 of the
largest, and after a decode every cache leaf (float leaves made f32,
integer leaves exactly), the token written at slot 21 of 32 (the second
half of a cache whose slots split over ``data``, as the hybrid's do) and
every write index advanced. Prefill runs each family's forward, which the
train files hold for every variant too; decode runs every variant but the
dense one on the (pod, data, model) mesh, whose batch entry the MoE one
holds."""

import pytest
from torch_spmd_cases import CASES, FAMILIES, check_parity, parity_job

from repro_torch.launch import vfl_step

PREFILL = list(FAMILIES)
DECODE = [c for c in CASES if c != "dense-pods"]


@pytest.fixture(scope="module")
def runs():
    pairs = [(c, "prefill") for c in PREFILL] + [(c, "decode") for c in DECODE]
    ranks = vfl_step.run_parties(parity_job, [(pairs,)] * 4, timeout=300.0)
    return ranks[0]  # the plain route runs on rank 0, which compares


@pytest.mark.parametrize("case", PREFILL)
def test_prefill_step_matches_the_plain_route(runs, case):
    check_parity(runs[(case, "prefill")], "prefill")


@pytest.mark.parametrize("case", DECODE)
def test_decode_step_matches_the_plain_route(runs, case):
    check_parity(runs[(case, "decode")], "decode")
