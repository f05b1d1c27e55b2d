"""The port's CUDA kernels against their plain versions, on the card.

Every test here carries the ``gpu`` marker and skips without a CUDA device:
a CUDA kernel has no CPU mode. The file imports neither ``jax`` nor the
reference package, so it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import ExtractorSpec, init_artifact
from repro_torch.kernels.sdpa_estimator import ops, ref
from repro_torch.launch.vfl_serve import ServingEngine

# The kernel and the plain version both sum in f32, in different orders: a
# few ulps on O(1) outputs. Held against a float64 plain version, 2e-5 is the
# reference package's own f32 kernel tolerance.
TOL = 2e-5

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, nu, no, d, db, device, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(
        torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(device)
        for s in ((b, nu, d), (b, no, d), (b, no, db))
    )


@pytest.mark.parametrize(
    "shape",
    [
        (1, 1024, 2048, 128, 128),  # the serving shape
        (3, 1024, 2048, 128, 128),  # K = 4: three estimates in one launch
        (1, 1024, 2000, 128, 128),  # ragged N_o
        (2, 333, 517, 64, 128),  # odd sizes, d != d_b
        (1, 17, 1, 256, 256),  # one overlap row, widest d and d_b
        (2, 5, 130, 3, 200),  # narrow d, two column slices of d_b
        (1, 17, 100, 64, 64),  # one K/V tile: the second group has none
    ],
)
def test_kernel_matches_plain_version(shape, cuda):
    q, a, b = _inputs(*shape, cuda)
    before = ops.LAUNCHES
    got = ops.sdpa_estimate_batched(q, a, b)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    want = ref.sdpa_estimate_batched(q.double(), a.double(), b.double()).float()
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


def test_kernel_takes_stride0_batch_views(cuda):
    q, a, b = _inputs(1, 40, 300, 32, 64, cuda, seed=1)
    bb = torch.cat([b, 2 * b, -b])
    got = ops.sdpa_estimate_batched(q.expand(3, -1, -1), a.expand(3, -1, -1), bb)
    want = ref.sdpa_estimate_batched(q.expand(3, -1, -1), a.expand(3, -1, -1), bb)
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


def test_partial_party_query_is_one_launch(cuda):
    spec = ExtractorSpec(kind="cnn", rep_dim=32, widths=(8, 16), blocks_per_stage=1)
    gen = torch.Generator(device=cuda).manual_seed(0)
    aligned = [torch.randn(64, 8, 8, 3, generator=gen, device=cuda) for _ in range(4)]
    art = init_artifact([spec] * 4, [(8, 8, 3)] * 4, 10, seed=0, device=cuda, aligned=aligned)
    engine = ServingEngine(art, capacity=16, device=cuda)
    x = torch.randn(20, 8, 8, 3, generator=gen, device=cuda)
    before = ops.LAUNCHES
    got = engine.predict_logits_partial(x, 2)
    assert ops.LAUNCHES == before + 1
    with torch.inference_mode():
        h = art.extractors[2](x)
        reps = [
            h if j == 2 else ref.sdpa_estimate(h, art.overlap_reps[2], art.overlap_reps[j])
            for j in range(4)
        ]
        want = art.classifier(torch.cat(reps, dim=-1))
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
