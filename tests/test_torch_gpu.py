"""The port's CUDA kernels against their plain versions, on the card.

Every test here carries the ``gpu`` marker and skips without a CUDA device:
a CUDA kernel has no CPU mode. The file imports neither ``jax`` nor the
reference package, so it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py
"""

import copy
import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from repro_torch import scenarios  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    ExtractorSpec,
    init_artifact,
    load_artifact,
    save_artifact,
)
from repro_torch.core import baselines, clustering, estimator  # noqa: E402
from repro_torch.core.protocol import (  # noqa: E402
    ProtocolConfig,
    run_few_shot,
    run_few_shot_finetune,
    run_one_shot,
    run_seeds,
)
from repro_torch.kernels.decode_attention import ops as dops  # noqa: E402
from repro_torch.kernels.decode_attention import ref as dref  # noqa: E402
from repro_torch.kernels.kmeans import ops as kops  # noqa: E402
from repro_torch.kernels.kmeans import ref as kref  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rops  # noqa: E402
from repro_torch.kernels.rmsnorm import ref as rref  # noqa: E402
from repro_torch.kernels.sdpa_estimator import ops, ref  # noqa: E402
from repro_torch.launch import batching, vfl_serve, vfl_step  # noqa: E402
from repro_torch.launch.mesh import BatchMesh  # noqa: E402
from repro_torch.launch.specs import zeros_like_spec  # noqa: E402
from repro_torch.launch.vfl_serve import KernelRouter, ServingEngine  # noqa: E402
from repro_torch.models import moe as zoo_moe  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402

# The kernel and the plain version both sum in f32, in different orders: a
# few ulps on O(1) outputs. Held against a float64 plain version, 2e-5 is the
# reference package's own f32 kernel tolerance.
TOL = 2e-5
# k-means assignments compare exactly except on rows whose best two squared
# distances (unit rows: in [0, 4]) are within NEAR_TIE: the kernel and the
# plain version sum the d-long dots in different orders. Such rows may
# disagree, at most 0.1 % of a launch's rows.
NEAR_TIE = 1e-5

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _oracle64(q, a, b):
    """Eq. 10 in float64 (the plain version casts its inputs to float32)."""
    q, a, b = q.double(), a.double(), b.double()
    return torch.softmax((q @ a.transpose(1, 2)) / math.sqrt(q.shape[-1]), dim=-1) @ b


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
        (2, 5, 130, 3, 200),  # narrow d, two column chunks of d_b
        (1, 17, 100, 64, 64),  # four tiles of keys: one range
        (1, 15, 7, 3, 1),  # N_o = 7 < one 8-key step, N_u = 15, d = 3, d_b = 1
        (2, 15, 9, 200, 200),  # N_o = 9: a ragged 8-key step; d and d_b not multiples of 8
        (3, 100, 9, 200, 256),  # d_b = 256: two column chunks
        (1, 1024, 2049, 128, 128),  # 13 key ranges, the last tile one key long
        (1, 22976, 2048, 128, 128),  # few-shot step ③': one range, 359 row blocks
        (1, 1184, 32, 16, 16),  # hard/overlap-32's ③': d below a TMA box, one key tile
        (1, 1168, 64, 16, 16),  # hard/overlap-64's ③': two key tiles
    ],
)
def test_kernel_matches_plain_version(shape, cuda):
    q, a, b = _inputs(*shape, cuda)
    before = ops.LAUNCHES
    got = ops.sdpa_estimate_batched(q, a, b)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    want = _oracle64(q, a, b).float()
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


def test_kernel_takes_stride0_batch_views(cuda):
    q, a, b = _inputs(1, 40, 300, 32, 64, cuda, seed=1)
    bb = torch.cat([b, 2 * b, -b])
    got = ops.sdpa_estimate_batched(q.expand(3, -1, -1), a.expand(3, -1, -1), bb)
    want = ref.sdpa_estimate_batched(q.expand(3, -1, -1), a.expand(3, -1, -1), bb)
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


def test_kernel_takes_stride0_batch_views_on_the_split_route(cuda):
    q, a, b = _inputs(1, 64, 2049, 32, 64, cuda, seed=2)
    qe, ae, bb = q.expand(3, -1, -1), a.expand(3, -1, -1), torch.cat([b, 2 * b, -b])
    assert ops.device_plan(qe, bb).splits > 1
    got = ops.sdpa_estimate_batched(qe, ae, bb)
    want = _oracle64(qe, ae, bb).float()
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("want_ranges", [1, 2, 5, 10])
def test_kernel_under_any_key_range_plan(want_ranges, cuda):
    """Plans the wrapper would not pick here: 10 tiles of keys in up to 10
    ranges, the last shorter than the rest (300 = 9·32 + 12 keys)."""
    shape = (2, 70, 300, 24, 40)
    q, a, b = _inputs(*shape, cuda, seed=3)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = ops.split_plan(2, 70, 300, 40, sms, want_ranges)
    assert plan.splits >= min(want_ranges, 10) and plan.ranges(300)[-1][1] == 300
    before = ops.LAUNCHES
    got = ops.launch(q, a, b, plan)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1  # one call, whether or not it merges
    want = _oracle64(q, a, b).float()
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("no", [2048, 8192])
def test_kernel_holds_f32_accuracy_over_one_long_key_range(no, cuda):
    """One block walks every key: 64 and 256 tiles, the plan the wrapper
    picks when the query rows alone fill the card (few-shot step ③'). The
    error must not grow with the range's length past TOL."""
    shape = (1, 256, no, 128, 128)
    q, a, b = _inputs(*shape, cuda, seed=4)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = ops.split_plan(1, 256, no, 128, sms, want=1)
    assert plan.splits == 1 and plan.per_tiles * ops.BN >= no
    got = ops.launch(q, a, b, plan)
    want = _oracle64(q, a, b).float()
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


def test_kernel_replays_from_a_cuda_graph(cuda):
    """The serving shape (16 key ranges and the merge) captured once and
    replayed on new values of the same inputs: the eager call's outputs,
    bit for bit."""
    q, a, b = _inputs(1, 1024, 2048, 128, 128, cuda)
    assert ops.device_plan(q, b).splits > 1
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.sdpa_estimate_batched(q, a, b)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = ops.sdpa_estimate_batched(q, a, b)
    for seed in (1, 2):
        for t, new in zip((q, a, b), _inputs(1, 1024, 2048, 128, 128, cuda, seed=seed)):
            t.copy_(new)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, ops.sdpa_estimate_batched(q, a, b))


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


def test_few_shot_step3p_launches_the_kernel_once_a_party(cuda):
    """Alg. 2 on hard/overlap-32 on the card at a few epochs: the ledger's
    5 comm times and 177408 bytes, and step ③' as one ``sdpa_estimator``
    launch a party (K = 2), beside step ③'s 27 k-means launches."""
    spec = scenarios.HARD_OVERLAP_32
    bundle = scenarios.build(spec, seed=0, device=cuda)
    cfg = ProtocolConfig(client_epochs=2, server_epochs=2)
    before, before_km = ops.LAUNCHES, kops.LAUNCHES
    res = run_few_shot(0, bundle.split, bundle.extractors, bundle.ssl_cfgs, cfg, device=cuda)
    assert ops.LAUNCHES - before == len(bundle.split.aligned) == 2
    assert kops.LAUNCHES - before_km == cfg.kmeans_iters + 2
    assert res.ledger.comm_times() == 5 and res.ledger.total_bytes() == 177408
    probs = res.diagnostics["fewshot_step3p"]["probs"]
    assert all(p.is_cuda and p.dtype == torch.float32 and p.shape == (1184,) for p in probs)
    assert 0.0 <= res.metric <= 1.0


@pytest.mark.parametrize(
    "name", ["credit/parties-8", "image/patch-4", "hard/overlap-32-eq", "edge/full-overlap"]
)
def test_catalog_few_shot_on_the_card(name, cuda):
    """A catalog scenario at its smoke sizes and 2 epochs on the card: the
    CPU's ledger event for event; step ③ one batched k-means search (27
    launches) over the K parties; step ③' one fused Eq. 10 launch of width
    K − 1 a party with a non-empty pool (none at full overlap), its
    estimates and p̂ within 1e-4 of the CPU's plain route on the run's own
    inputs, gate decisions equal outside near-ties."""
    cfg = ProtocolConfig(client_epochs=2, server_epochs=2)
    cpu = scenarios.build(name, seed=0, smoke=True, device="cpu")
    want = run_few_shot(0, cpu.split, cpu.extractors, cpu.ssl_cfgs, cfg, device="cpu")
    bundle = scenarios.build(name, seed=0, smoke=True, device=cuda)
    before, before_km = ops.LAUNCHES, kops.LAUNCHES
    res = run_few_shot(0, bundle.split, bundle.extractors, bundle.ssl_cfgs, cfg, device=cuda)
    pools = [u.shape[0] for u in bundle.split.unaligned]
    assert ops.LAUNCHES - before == sum(n > 0 for n in pools)
    assert kops.LAUNCHES - before_km == cfg.kmeans_iters + 2
    assert [e.__dict__ for e in res.ledger.events] == [e.__dict__ for e in want.ledger.events]
    k = bundle.spec.num_parties
    assert [len(e) for e in res.diagnostics["fewshot_step3p"]["estimates"]] == [k - 1] * k
    chip_smoke.check_step3p(res, name)
    assert 0.0 <= res.metric <= 1.0


def test_bf16_few_shot_on_the_card(cuda):
    """hard/overlap-32 with bf16 reps at 2 epochs: 93440 bytes (p̂ in f32),
    2 Eq. 10 and 27 k-means launches, ③' within the bf16 tolerance of the
    CPU's plain route on the same bf16 reps."""
    bundle = scenarios.build("hard/overlap-32", seed=0, device=cuda)
    cfg = ProtocolConfig(client_epochs=2, server_epochs=2, rep_dtype=torch.bfloat16)
    before, before_km = ops.LAUNCHES, kops.LAUNCHES
    res = run_few_shot(0, bundle.split, bundle.extractors, bundle.ssl_cfgs, cfg, device=cuda)
    assert (ops.LAUNCHES - before, kops.LAUNCHES - before_km) == (2, cfg.kmeans_iters + 2)
    assert res.ledger.total_bytes() == chip_smoke.CATALOG_BF16_LEDGERS["hard/overlap-32"][1]
    rec = res.diagnostics["fewshot_step3p"]
    assert all(h.dtype == torch.bfloat16 for h in rec["h_u"] + rec["h_o"])
    chip_smoke.check_step3p(res, "bf16", chip_smoke.BF16_STEP3P_TOL)


@pytest.mark.parametrize("name", ["fault/dropout-pre-round2", "fault/straggler-half"])
def test_fault_few_shot_on_the_card(name, cuda):
    """A fault/* member's few-shot at one epoch on the card: the CPU's
    ledger event for event (a round-2 dropout's missing events included);
    ``sdpa_estimator`` launched for ③' once a party plus once a
    reconstruction (⑥' and two evaluations for the dropout), 27 ``kmeans``
    launches; every reconstruction within 1e-4 of the CPU's plain route on
    the run's own inputs."""
    cfg = ProtocolConfig(client_epochs=1, server_epochs=1)
    cpu = scenarios.build(name, seed=0, device="cpu")
    fault = cpu.spec.fault
    want = run_few_shot(0, cpu.split, cpu.extractors, cpu.ssl_cfgs, cfg, device="cpu", fault=fault)
    bundle = scenarios.build(name, seed=0, device=cuda)
    before, before_km = ops.LAUNCHES, kops.LAUNCHES
    res = run_few_shot(
        0, bundle.split, bundle.extractors, bundle.ssl_cfgs, cfg, device=cuda, fault=fault
    )
    pools = [u.shape[0] for u in bundle.split.unaligned]
    expected = chip_smoke.fault_launches(fault, bundle.spec.num_parties, pools, True)
    assert expected == (7 if "dropout" in name else 4)
    assert ops.LAUNCHES - before == expected
    assert kops.LAUNCHES - before_km == cfg.kmeans_iters + 2
    assert [e.__dict__ for e in res.ledger.events] == [e.__dict__ for e in want.ledger.events]
    assert res.ledger.total_bytes() == chip_smoke.FAULT_LEDGERS[name]["few-shot"][0]
    err, points = chip_smoke.check_reconstructions(res, name)
    assert points == ([4, 3, 4] if "dropout" in name else [])
    assert err <= chip_smoke.KERNEL_TOL
    assert res.diagnostics["parties_survived"] == (3 if "dropout" in name else 4)
    assert 0.0 <= res.metric <= 1.0


def test_kernel_takes_an_empty_query(cuda):
    """An empty private pool (full overlap): no rows to estimate, nothing
    launched, an empty f32 result."""
    q = torch.zeros(3, 0, 16, device=cuda)
    a, b = torch.randn(3, 800, 16, device=cuda), torch.randn(3, 800, 8, device=cuda)
    before = ops.LAUNCHES
    out = ops.sdpa_estimate_batched(q, a, b)
    assert out.shape == (3, 0, 8) and out.dtype == torch.float32 and out.is_cuda
    assert ops.LAUNCHES == before


def test_sdpa_kernel_refuses_inputs_under_grad(cuda):
    """The kernel has no backward: a CUDA input that requires grad is refused
    under grad (the error names the differentiable route), and the same
    inputs run under no_grad."""
    q, a, b = (torch.randn(s, device=cuda) for s in ((64, 16), (32, 16), (32, 16)))
    for i in range(3):
        args = [q, a, b]
        args[i] = args[i].clone().requires_grad_(True)
        with pytest.raises(NotImplementedError, match="sdpa_transform_differentiable"):
            ops.sdpa_estimate(*args)
        with torch.no_grad():
            got = ops.sdpa_estimate(*args)
        torch.testing.assert_close(got, ref.sdpa_estimate(q, a, b), atol=TOL, rtol=0)
    assert not ops.sdpa_estimate(q, a, b).requires_grad  # no input needs grad: it launches


def test_differentiable_eq10_on_the_card_matches_the_cpu(cuda):
    """FedCVT's Eq. 10 (plain ops, TF32 off) and its three gradients on the
    card against the CPU, at 1e-5."""
    rng = np.random.default_rng(5)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in ((32, 16), (32, 16), (32, 16))]
    w = torch.from_numpy(rng.standard_normal((32, 16)).astype(np.float32))
    outs = []
    for dev in (cuda, torch.device("cpu")):
        ts = [torch.from_numpy(a).to(dev).requires_grad_(True) for a in arrays]
        before = ops.LAUNCHES
        out = estimator.sdpa_transform_differentiable(*ts)
        grads = torch.autograd.grad((out * w.to(dev)).sum(), ts)
        assert ops.LAUNCHES == before
        outs.append([out.detach().cpu(), *(g.cpu() for g in grads)])
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("method", ["run_vanilla", "run_fedcvt"])
def test_baselines_on_the_card_launch_no_kernel(method, cuda):
    """SplitNN and FedCVT at 20 iterations on hard/overlap-32: the CPU's
    ledger, finite losses, and no kernel launch (FedCVT's Eq. 10 is
    plain ops, for its backward)."""
    spec = scenarios.HARD_OVERLAP_32
    cfg = baselines.IterativeConfig(iterations=20)
    fn = getattr(baselines, method)
    bundle = scenarios.build(spec, seed=0, device="cpu")
    cpu = fn(0, bundle.split, bundle.extractors, bundle.ssl_cfgs, cfg, device="cpu")
    before, before_km = ops.LAUNCHES, kops.LAUNCHES
    res = fn(0, bundle.split, bundle.extractors, bundle.ssl_cfgs, cfg, device=cuda)
    assert (ops.LAUNCHES, kops.LAUNCHES) == (before, before_km)
    assert [e.__dict__ for e in res.ledger.events] == [e.__dict__ for e in cpu.ledger.events]
    assert res.clients[0].extractor.layers[0].weight.is_cuda
    assert bool(torch.isfinite(res.diagnostics["losses"]).all()) and 0.0 <= res.metric <= 1.0


def test_few_shot_finetune_launches_the_few_shot_kernels(cuda):
    """Few-shot + finetune at 2 epochs: few-shot's 2 ``sdpa_estimator`` and
    27 ``kmeans`` launches and none in the finetune; 1815808 bytes in 405
    comm times."""
    spec = scenarios.HARD_OVERLAP_32
    bundle = scenarios.build(spec, seed=0, device=cuda)
    cfg = ProtocolConfig(client_epochs=2, server_epochs=2)
    before, before_km = ops.LAUNCHES, kops.LAUNCHES
    res = run_few_shot_finetune(
        0, bundle.split, bundle.extractors, bundle.ssl_cfgs, cfg, device=cuda
    )
    assert ops.LAUNCHES - before == 2
    assert kops.LAUNCHES - before_km == cfg.kmeans_iters + 2
    assert res.ledger.comm_times() == 405 and res.ledger.total_bytes() == 1815808
    assert 0.0 <= res.diagnostics["fewshot_metric"] <= 1.0 and 0.0 <= res.metric <= 1.0


def _unit(shape, device, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)
    return (x / x.norm(dim=-1, keepdim=True)).to(dtype)


def _assert_kmeans_matches_f64(x, m, got, mind):
    """Assignments equal to a float64 oracle of the same expansion outside
    NEAR_TIE near-ties (at most 0.1 % of the rows differ); minimum distances
    within 1e-5."""
    c = m.shape[1]
    xd, md = x.double(), m.double()  # a float64 oracle of the same expansion
    dots = xd @ md.transpose(1, 2)
    dist = (xd * xd).sum(-1, keepdim=True) - 2 * dots + (md * md).sum(-1)[:, None]
    top = dist.topk(min(2, c), dim=-1, largest=False).values
    gap = top[..., 1] - top[..., 0] if c > 1 else torch.full_like(top[..., 0], 9.0)
    want = dist.argmin(-1).int()
    exempt = gap <= NEAR_TIE
    assert torch.equal(got[~exempt], want[~exempt])
    assert float((got != want).float().mean()) <= 1e-3
    torch.testing.assert_close(mind.double(), top[..., 0], atol=1e-5, rtol=0)


@pytest.mark.parametrize(
    "shape",
    [
        (8, 2048, 128, 10),  # step ③'s Lloyd and inertia launches (K·R = 2·4)
        (2, 2048, 128, 10),  # its final assignment (K = 2)
        (8, 32, 16, 2),  # the tabular path's launches
        (2, 32, 16, 2),
        (3, 1000, 77, 37),  # odd sizes: ragged row, centre and column tiles
        (1, 4096, 1024, 1000),  # centres far beyond shared memory
        (1, 1, 1, 1),
        (2, 300, 513, 130),  # rows off the 16-byte grid, three centre ranges
        (8, 2048, 128, 64),  # the path's shape at 64 centres: the tile route
        (2, 100, 32, 17),  # C = 17: one past a 16-centre step
        (2, 50, 3, 5),  # d = 3: one ragged vector a row
        (1, 22976, 128, 10),  # a few-shot pool: more rows-route blocks than the card holds at once
    ],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kmeans_kernel_matches_plain_version(shape, dtype, cuda):
    b, n, d, c = shape
    x, m = _unit((b, n, d), cuda, 0, dtype), _unit((b, c, d), cuda, 1, dtype)
    before = kops.LAUNCHES
    got, mind = kops.kmeans_assign_min_batched(x, m)
    torch.cuda.synchronize()
    assert kops.LAUNCHES == before + 1
    _assert_kmeans_matches_f64(x, m, got, mind)


def _both_routes(b, n, d, c, elem, device):
    """The rows-route plan and tile-route plans of 1 and 4 centre ranges."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tiles = [kops.tile_plan(b, n, c, sms, w) for w in (1, 4)]
    return [kops.rows_plan(b, n, d, elem, sms)] + tiles


@pytest.mark.parametrize("shape", [(3, 1000, 77, 100), (2, 500, 128, 130), (4, 300, 16, 200)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kmeans_kernel_on_either_route_by_an_explicit_plan(shape, dtype, cuda):
    """Shapes where both routes run (more centres than ops.ROWS_MAX_C: the
    wrapper would take the tile route): each route, forced by its plan,
    holds the f64 oracle, and the tile route under one and several centre
    ranges."""
    b, n, d, c = shape
    x, m = _unit((b, n, d), cuda, 4, dtype), _unit((b, c, d), cuda, 5, dtype)
    plans = _both_routes(b, n, d, c, x.element_size(), cuda)
    assert [p.route for p in plans] == ["rows", "tiles", "tiles"]
    assert plans[2].splits > 1
    for plan in plans:
        got, mind = kops.launch(x, m, plan)
        torch.cuda.synchronize()
        _assert_kmeans_matches_f64(x, m, got, mind)


@pytest.mark.parametrize("route", ["rows", "tiles"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kmeans_kernel_reads_rows_off_the_16_byte_grid(route, dtype, cuda):
    """A view whose base is 4 (or 2) bytes off the 16-byte grid, with
    aligned strides: the kernel reads it element by element, in place."""
    b, n, d, c = 4, 300, 128, 20
    flat = _unit((1, 1, b * n * d + 1), cuda, 6, dtype).flatten()
    x = flat[1:].view(b, n, d)
    m = _unit((b, c, d), cuda, 7, dtype)
    assert x.data_ptr() % 16 != 0
    rows, tiles, _ = _both_routes(b, n, d, c, x.element_size(), cuda)
    got, mind = kops.launch(x, m, rows if route == "rows" else tiles)
    torch.cuda.synchronize()
    _assert_kmeans_matches_f64(x, m, got, mind)


def test_kmeans_tile_route_breaks_a_tie_across_centre_ranges_to_the_lower_index(cuda):
    """Centre 5 and an exact copy at 133, two ranges later (ranges of one
    64-centre tile, the copy at the same place in its tile): the ranges are
    merged in no fixed block order, and the lower index wins every tie."""
    b, n, d, c = 1, 4096, 256, 200
    x = _unit((b, n, d), cuda, 8)
    m = _unit((b, c, d), cuda, 9)
    m[:, 133] = m[:, 5]
    x[:, ::7] = m[:, 5:6]  # these rows sit on both centres
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = kops.tile_plan(b, n, c, sms, 4)
    assert plan.splits == 4 and plan.ranges(c)[2] == (128, 192)
    got, mind = kops.launch(x, m, plan)
    torch.cuda.synchronize()
    assert not bool((got == 133).any())
    assert bool((got[:, ::7] == 5).all())
    _assert_kmeans_matches_f64(x, m, got, mind)


@pytest.mark.parametrize(
    "shape,route", [((8, 2048, 128, 10), "rows"), ((1, 2048, 256, 300), "tiles")]
)
def test_kmeans_kernel_replays_from_a_cuda_graph(shape, route, cuda):
    """Captured once, replayed on new values of the same inputs: the same
    outputs as an eager call (the same kernels, so bit for bit), on each
    route (the tile route's with its merge)."""
    b, n, d, c = shape
    x, m = _unit((b, n, d), cuda, 10), _unit((b, c, d), cuda, 11)
    plan = kops.device_plan(x, m)
    assert plan.route == route and (route == "rows" or plan.splits > 1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kops.kmeans_assign_min_batched(x, m)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got, mind = kops.kmeans_assign_min_batched(x, m)
    for seed in (12, 13):
        x.copy_(_unit((b, n, d), cuda, seed))
        m.copy_(_unit((b, c, d), cuda, seed + 10))
        graph.replay()
        torch.cuda.synchronize()
        want, want_min = kops.kmeans_assign_min_batched(x, m)
        assert torch.equal(got, want) and torch.equal(mind, want_min)
        _assert_kmeans_matches_f64(x, m, got, mind)


def test_kmeans_kernel_takes_stride0_batch_views_and_ties(cuda):
    x = _unit((1, 300, 48), cuda, 2).expand(4, -1, -1)
    m = _unit((4, 12, 48), cuda, 3)
    m[:, 7] = m[:, 2]  # an exact tie: the lower index wins
    got = kops.kmeans_assign_batched(x, m)
    want = kref.kmeans_assign_batched(x, m)
    assert not bool((got == 7).any())
    assert float((got == want).float().mean()) >= 0.999


def test_step3_launches_the_kernel_for_every_assignment(cuda):
    g = torch.randn(2, 256, 16, device=cuda)
    before = kops.LAUNCHES
    labels, _ = clustering.gradient_pseudo_labels_batched(
        g, 3, num_iters=5, restarts=4, generator=torch.Generator(device=cuda).manual_seed(0)
    )
    assert kops.LAUNCHES - before == 5 + 2  # Lloyd iterations, inertia, final
    assert labels.shape == (2, 256)


@pytest.mark.parametrize(
    "shape",
    [
        (4, 3072),  # the zoo's decode step
        (128, 3072),  # its 32-token prompt forward at batch 4
        (2048, 4096),  # the reference op's own example
        (231, 130),  # odd d: rows start off the 16-byte grid
        (3, 7, 96),
        (5, 1),
        (4, 1536),  # granite-moe's decode step
        (4, 1024),  # mamba2's
        (4, 2048),  # zamba2's, and mamba2's gated norm (f32)
        (4, 4096),  # zamba2's gated norm (f32)
    ],
)
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_matches_plain_version(shape, x_dtype, scale_dtype, cuda):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda, x_dtype)
    scale = 1.0 + 0.1 * rng.standard_normal(shape[-1:]).astype(np.float32)
    scale = torch.from_numpy(scale).to(cuda, scale_dtype)
    before = rops.LAUNCHES
    got = rops.rms_norm(x, scale)
    torch.cuda.synchronize()
    assert rops.LAUNCHES == before + 1
    assert got.dtype == x_dtype and got.shape == x.shape
    want = rref.rms_norm(x, scale)
    # f32: a few ulps of O(1) values; bf16: one rounding step of the output
    tol = 1e-5 if x_dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("rows, d", [(4, 2048), (4, 4096), (128, 2048), (128, 4096)])
def test_rmsnorm_kernel_at_the_gated_norm_widths_matches_f64(rows, d, cuda):
    """The Mamba2 gated norm: f32 rows at d_inner (mamba2 2048, zamba2
    4096), a decode step's 4 and a 32-token prompt's 128 at batch 4."""
    rng = np.random.default_rng(rows + d)
    x = torch.from_numpy(rng.standard_normal((rows, d)).astype(np.float32) * 3).to(cuda)
    scale = torch.from_numpy(1.0 + 0.1 * rng.standard_normal(d).astype(np.float32)).to(cuda)
    got = rops.rms_norm(x, scale)
    xd = x.double()
    want = xd * torch.rsqrt(xd.square().mean(-1, keepdim=True) + 1e-6) * scale.double()
    torch.testing.assert_close(got.double(), want, atol=1e-5, rtol=0)


def test_rmsnorm_kernel_takes_offset_rows_and_eps(cuda):
    x = torch.randn(40 * 100 + 3, device=cuda)[3:].reshape(40, 100)  # 12-byte offset base
    scale = torch.rand(100, device=cuda)
    for eps in (1e-6, 0.5):
        torch.testing.assert_close(
            rops.rms_norm(x, scale, eps), rref.rms_norm(x, scale, eps), atol=1e-5, rtol=1e-5
        )


def _rms_inputs(rows, d, x_dtype, scale_dtype, device, offset=0, seed=0):
    rng = np.random.default_rng(seed)
    flat = rng.standard_normal(rows * d + offset).astype(np.float32)
    x = torch.from_numpy(flat).to(device, x_dtype)[offset:].view(rows, d)
    scale = 1.0 + 0.1 * rng.standard_normal(d).astype(np.float32)
    return x, torch.from_numpy(scale).to(device, scale_dtype)


@pytest.mark.parametrize("d", [3072, 3071, 130, 16384, 40000])  # 40000: past registers, the loop
@pytest.mark.parametrize("side", [0, 1])  # 2·SMs rows (a block per row), then one more (packed)
@pytest.mark.parametrize("offset", [0, 3])  # rows off the 16-byte grid
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_at_the_launch_policy_boundaries(
    d, side, offset, x_dtype, scale_dtype, cuda
):
    rows = 2 * torch.cuda.get_device_properties(cuda).multi_processor_count + side
    x, scale = _rms_inputs(rows, d, x_dtype, scale_dtype, cuda, offset)
    before = rops.LAUNCHES
    got = rops.rms_norm(x, scale)
    torch.cuda.synchronize()
    assert rops.LAUNCHES == before + 1 and got.dtype == x_dtype
    tol = 1e-5 if x_dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), rref.rms_norm(x, scale).float(), atol=tol, rtol=tol)


def test_rmsnorm_kernel_replays_from_a_cuda_graph(cuda):
    """Captured once, replayed on new values of the same input: the same
    outputs as an eager call (the same kernel, so bit for bit)."""
    x, scale = _rms_inputs(4, 3072, torch.bfloat16, torch.float32, cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        rops.rms_norm(x, scale)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = rops.rms_norm(x, scale)
    for seed in (1, 2):
        x.copy_(_rms_inputs(4, 3072, torch.bfloat16, torch.float32, cuda, seed=seed)[0])
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, rops.rms_norm(x, scale))


def _rms_bwd_check(x, scale, dy):
    """The backward kernel (one counted launch) against float64: dx within
    1e-5 of its largest entry in f32, within one bf16 step of the f64 value
    (plus that) in bf16; dscale within 1e-5 of its largest entry; and the
    plain version within the same bounds."""
    before = rops.BACKWARD_LAUNCHES
    dx, ds = rops.rms_norm_backward(x, scale, dy)
    torch.cuda.synchronize()
    assert rops.BACKWARD_LAUNCHES == before + 1
    assert dx.dtype == x.dtype and dx.shape == x.shape and ds.dtype == scale.dtype
    want_dx, want_ds = chip_smoke._bwd_oracle64(x, scale.float(), dy)
    bound = chip_smoke.bwd_dx_bound(want_dx, x.dtype)
    for got_dx, got_ds in ((dx, ds), rref.rms_norm_backward(x, scale, dy)):
        assert bool(((got_dx.double() - want_dx).abs() <= bound).all())
        tol_ds = 1e-5 if scale.dtype == torch.float32 else 2**-7
        assert (got_ds.double() - want_ds).abs().max() <= tol_ds * want_ds.abs().max()
    return dx, ds


@pytest.mark.parametrize("rows, d", [(1024, 1024), (1024, 2048), (1024, 3072), (512, 256), (231, 130), (3, 7), (300, 16384)])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_backward_kernel_matches_f64(rows, d, x_dtype, scale_dtype, cuda):
    """Every dtype pair at a [zoo-train] step's shapes, the zoo extractor's,
    ragged rows and d past 12288 (its dscale accumulator past 48 KB of
    shared memory)."""
    x, scale = _rms_inputs(rows, d, x_dtype, scale_dtype, cuda, seed=rows + d)
    dy = _rms_inputs(rows, d, x_dtype, scale_dtype, cuda, seed=rows + d + 1)[0]
    dx, ds = _rms_bwd_check(x, scale, dy)
    again = rops.rms_norm_backward(x, scale, dy)
    assert torch.equal(dx, again[0]) and torch.equal(ds, again[1])  # no atomics: the same bits


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_backward_kernel_at_its_widest_row(x_dtype, cuda):
    """The widest row the first version's shared-memory accumulator took
    (57984) and one past it: both on the loop route, whose dscale terms go
    to the block's partial row in the scratch, so no width is refused."""
    for d in (57984, 57985):
        x, scale = _rms_inputs(5, d, x_dtype, torch.float32, cuda, seed=11)
        dy = _rms_inputs(5, d, x_dtype, torch.float32, cuda, seed=12)[0]
        assert rops.device_backward_plan(x).vpt == 0
        _rms_bwd_check(x, scale, dy)


def _rms_bwd_split_check(rows, d, x_dtype, scale_dtype, device, **override):
    """The kernel under backward_plan(rows, d, ..., **override) against
    float64 (one counted launch), and again bit for bit."""
    x, scale = _rms_inputs(rows, d, x_dtype, scale_dtype, device, seed=rows + d)
    dy = _rms_inputs(rows, d, x_dtype, scale_dtype, device, seed=rows + d + 1)[0]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    split = rops.backward_plan(rows, d, x.element_size(), sms, **override)
    assert split.threads <= rops.backward_max_threads(split.vpt)
    before = rops.BACKWARD_LAUNCHES
    dx, ds = rops.backward_launch(x, scale, dy, split)
    torch.cuda.synchronize()
    assert rops.BACKWARD_LAUNCHES == before + 1
    want_dx, want_ds = chip_smoke._bwd_oracle64(x, scale.float(), dy)
    assert bool(((dx.double() - want_dx).abs() <= chip_smoke.bwd_dx_bound(want_dx, x_dtype)).all())
    tol_ds = 1e-5 if scale_dtype == torch.float32 else 2**-7
    assert (ds.double() - want_ds).abs().max() <= tol_ds * want_ds.abs().max()
    again = rops.backward_launch(x, scale, dy, split)
    assert torch.equal(dx, again[0]) and torch.equal(ds, again[1])
    return split, dx, ds


@pytest.mark.parametrize(
    "rows, d, x_dtype, override",
    [
        # each register route at the training shapes
        (1024, 1024, torch.bfloat16, {"vpt": 1}),
        (1024, 1024, torch.bfloat16, {"vpt": 2}),
        (1024, 1024, torch.bfloat16, {"vpt": 4}),
        (1024, 2048, torch.float32, {"vpt": 1}),
        (1024, 2048, torch.float32, {"vpt": 2}),
        (1024, 2048, torch.float32, {"vpt": 4}),
        # the widest register rows (1024 slots) and the loop route just past them
        (64, 4096, torch.float32, {}),
        (64, 8192, torch.bfloat16, {}),
        (64, 4100, torch.float32, {}),
        (64, 8200, torch.bfloat16, {}),
        # fewer rows than groups, one row, rows not whole rounds of the groups
        (3, 256, torch.bfloat16, {"groups": 8}),
        (1, 1024, torch.float32, {}),
        (1, 256, torch.bfloat16, {"groups": 4}),
        (1000, 256, torch.bfloat16, {"groups": 3}),
        (1000, 512, torch.float32, {"groups": 5, "blocks_per_sm": 2}),
        # rows 8-, 4- or 2-byte aligned: the narrower accesses, and the ragged slot
        (40, 130, torch.float32, {}),
        (40, 1001, torch.bfloat16, {}),
        (40, 4097, torch.bfloat16, {"vpt": 0}),
        # the column sum at fewer than 32 warps (a warp a partial row)
        (20, 1024, torch.bfloat16, {}),
    ],
    ids=str,
)
@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_backward_kernel_at_the_split_boundaries(rows, d, x_dtype, override, scale_dtype, cuda):
    split, _, _ = _rms_bwd_split_check(rows, d, x_dtype, scale_dtype, cuda, **override)
    for key, value in override.items():
        if key in split._fields:
            assert getattr(split, key) == value


def test_rmsnorm_backward_kernel_takes_offset_and_empty_rows(cuda):
    x, scale = _rms_inputs(40, 100, torch.float32, torch.float32, cuda, offset=3)
    dy = torch.randn(40 * 100 + 1, device=cuda)[1:].view(40, 100)  # offset views: copied
    _rms_bwd_check(x, scale, dy)
    before = rops.BACKWARD_LAUNCHES
    dx, ds = rops.rms_norm_backward(x[:0], scale, dy[:0])
    assert rops.BACKWARD_LAUNCHES == before and dx.shape == (0, 100)
    assert torch.equal(ds, torch.zeros_like(ds))


def test_rmsnorm_backward_kernel_replays_from_a_cuda_graph(cuda):
    x, scale = _rms_inputs(1024, 1024, torch.bfloat16, torch.float32, cuda)
    dy = _rms_inputs(1024, 1024, torch.bfloat16, torch.float32, cuda, seed=5)[0]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        rops.rms_norm_backward(x, scale, dy)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = rops.rms_norm_backward(x, scale, dy)
    for seed in (1, 2):
        x.copy_(_rms_inputs(1024, 1024, torch.bfloat16, torch.float32, cuda, seed=seed)[0])
        graph.replay()
        torch.cuda.synchronize()
        want = rops.rms_norm_backward(x, scale, dy)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_rmsnorm_under_grad_launches_both_kernels(cuda):
    """Under autograd on the card the op launches the forward kernel and,
    in the backward, the backward kernel: no plain route."""
    x, scale = _rms_inputs(64, 256, torch.bfloat16, torch.float32, cuda)
    dy = _rms_inputs(64, 256, torch.bfloat16, torch.float32, cuda, seed=3)[0]
    xg, sg = x.clone().requires_grad_(True), scale.clone().requires_grad_(True)
    f0, b0 = rops.LAUNCHES, rops.BACKWARD_LAUNCHES
    y = rops.rms_norm(xg, sg)
    y.backward(dy)
    torch.cuda.synchronize()
    assert (rops.LAUNCHES - f0, rops.BACKWARD_LAUNCHES - b0) == (1, 1)
    dx, ds = rops.rms_norm_backward(x, scale, dy)
    assert torch.equal(xg.grad, dx) and torch.equal(sg.grad, ds)
    assert torch.equal(y.detach(), rops.rms_norm(x, scale))


# (forward, backward) RMSNorm launches of a reduced train step: every norm
# once each way, and the checkpointed blocks' norms again in the backward's
# re-run (not the final norm, nor zamba2's shared block: not checkpointed)
REDUCED_TRAIN_LAUNCHES = {
    "mamba2-370m": (9, 5),
    "phi4-mini-3.8b": (9, 5),
    "granite-moe-3b-a800m": (9, 5),
    "zamba2-1.2b": (11, 7),
}


@pytest.mark.parametrize("name", sorted(REDUCED_TRAIN_LAUNCHES))
def test_reduced_train_steps_card_equal_cpu(name, cuda):
    """Three clip + Adam steps of a reduced config (f32 activations) on the
    card and the CPU from the same weights and batch: first-step gradients
    and every loss within 1e-4, and the exact launches of each step."""
    from repro_torch.data import make_token_stream
    from repro_torch.launch.steps import make_optimizer, make_train_step

    cfg = chip_smoke._zoo_cfg(name, reduced=True)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    host = copy.deepcopy(params).cpu()
    tokens, labels = make_token_stream(torch.Generator().manual_seed(1), 2, 16, cfg.vocab_size)
    losses, grads = {}, {}
    for dev, p in ((cuda, params), ("cpu", host)):
        batch = {"tokens": tokens.to(dev), "labels": labels.to(dev)}
        grads[dev] = torch.autograd.grad(model.loss_fn(p, batch), list(p.parameters()))
        tx = make_optimizer(cfg, 3e-4)
        opt, step = tx.init(list(p.parameters())), make_train_step(model, tx)
        losses[dev] = []
        for _ in range(3):
            f0, b0 = rops.LAUNCHES, rops.BACKWARD_LAUNCHES
            losses[dev].append(float(step(p, opt, batch)))
            if dev == cuda:
                got = (rops.LAUNCHES - f0, rops.BACKWARD_LAUNCHES - b0)
                assert got == REDUCED_TRAIN_LAUNCHES[name]
    for a, b in zip(grads[cuda], grads["cpu"]):
        assert chip_smoke._leaf_rel(a.cpu(), b) <= 1e-4
    for a, b in zip(losses[cuda], losses["cpu"]):
        assert abs(a - b) <= 1e-4 * abs(b)


def test_zoo_extractor_trains_in_the_protocol_on_the_card(cuda):
    """chip_smoke's [zoo-vfl] run: metric over the bar, the pinned bytes,
    step ③'s k-means launches, and the norms launched forward and backward."""
    _zero = chip_smoke._zero_counters
    _zero()
    counts = chip_smoke.phase_zoo_vfl("test")
    assert counts["kmeans"] == chip_smoke.ProtocolConfig().kmeans_iters + 2
    assert counts["rmsnorm"] > 0 and counts["rmsnorm_backward"] > 0


_decode64 = chip_smoke.decode_oracle64  # the plain version's masks, in float64


def _zoo_cache(b, s, hkv, dh, dtype, device, seed):
    """A (B, S, Hkv, dh) cache viewed as (B, Hkv, S, dh), as the zoo passes it."""
    rng = np.random.default_rng(seed)
    c = torch.from_numpy(rng.standard_normal((b, s, hkv, dh)).astype(np.float32))
    return c.to(device, dtype).transpose(1, 2)


@pytest.mark.parametrize(
    "shape",
    [
        (4, 24, 8, 48, 128),  # phi4-mini's decode step, 48-slot cache
        (2, 8, 2, 128, 64),
        (1, 16, 16, 300, 128),  # MHA, ragged last tile
        (3, 12, 4, 1024, 32),
        (2, 4, 1, 77, 80),  # G = 4 against one kv head, odd S and dh
        (1, 16, 16, 4096, 256),  # gemma-like widest head, split across blocks
        (2, 32, 2, 9000, 128),  # G = 16, split across blocks
        (4, 24, 8, 48, 64),  # granite-moe's (G = 3, dh 64)
        (4, 32, 32, 48, 64),  # zamba2's shared block (G = 1, dh 64)
    ],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ragged", [False, True])
def test_decode_attention_kernel_matches_plain_version(shape, dtype, ragged, cuda):
    b, h, hkv, s, dh = shape
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((b, h, dh)).astype(np.float32)).to(cuda)
    k, v = (_zoo_cache(b, s, hkv, dh, dtype, cuda, seed) for seed in (2, 3))
    lengths = None
    if ragged:
        lengths = torch.from_numpy(rng.integers(1, s + 1, b).astype(np.int32)).to(cuda)
        lengths[0] = 1
    before = dops.LAUNCHES
    got = dops.decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    assert dops.LAUNCHES == before + 1
    want = _decode64(q, k, v, lengths).float()
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize(
    "shape",
    [
        (4, 24, 8, 48, 128),  # phi4-mini's decode step
        (1, 16, 16, 300, 128),
        (2, 32, 2, 9000, 128),  # split across blocks
        (8, 24, 8, 32768, 128),  # long context: the first ranges wholly masked
        (4, 24, 8, 48, 64),  # granite-moe's
        (4, 32, 32, 48, 64),  # zamba2's shared block
    ],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_lengths", [False, True])
def test_decode_attention_kernel_masks_each_slot_by_its_position(shape, dtype, with_lengths, cuda):
    """Stored positions in no order along the slots; on long caches the
    first half of the slots fails the mask, so whole tiles and whole split
    ranges hold no valid key and the merge must weigh them 0."""
    b, h, hkv, s, dh = shape
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((b, h, dh)).astype(np.float32)).to(cuda)
    k, v = (_zoo_cache(b, s, hkv, dh, dtype, cuda, seed) for seed in (6, 7))
    q_pos = rng.integers(s // 2, s, b)
    key_pos = rng.integers(0, s + 1, (b, s))
    if s >= 4096:  # empty, or later than the query: never valid
        key_pos[:, : s // 2] = np.where(rng.random((b, s // 2)) < 0.5, 0, s + 1)
    lengths = rng.integers(s // 2 + 1, s + 1, b) if with_lengths else np.full(b, s)
    cur = rng.integers(s // 2, lengths)  # the current token's slot: valid
    key_pos[np.arange(b), cur] = q_pos + 1
    key_pos, q_pos = (torch.from_numpy(a.astype(np.int32)).to(cuda) for a in (key_pos, q_pos))
    lengths = torch.from_numpy(lengths.astype(np.int32)).to(cuda) if with_lengths else None
    before = dops.LAUNCHES
    got = dops.decode_attention(q, k, v, lengths, key_pos=key_pos, q_pos=q_pos)
    torch.cuda.synchronize()
    assert dops.LAUNCHES == before + 1
    want = _decode64(q, k, v, lengths, key_pos, q_pos)
    torch.testing.assert_close(got, want.float(), atol=TOL, rtol=TOL)


def test_decode_attention_kernel_takes_contiguous_caches(cuda):
    q = torch.randn(2, 6, 64, device=cuda)
    k, v = torch.randn(2, 2, 200, 64, device=cuda), torch.randn(2, 2, 200, 64, device=cuda)
    torch.testing.assert_close(
        dops.decode_attention(q, k, v), dref.decode_attention(q, k, v), atol=TOL, rtol=TOL
    )


def _positions(b, s, rng, device, masked_half=False):
    """Stored positions (+1, 0 empty) in no order along the slots, the
    current token's slot valid; with ``masked_half`` the first half of the
    slots is empty or later than the query."""
    q_pos = rng.integers(s // 2, s, b)
    key_pos = rng.integers(0, s + 1, (b, s))
    if masked_half:
        key_pos[:, : s // 2] = np.where(rng.random((b, s // 2)) < 0.5, 0, s + 1)
    key_pos[np.arange(b), rng.integers(s // 2, s, b)] = q_pos + 1
    return (torch.from_numpy(a.astype(np.int32)).to(device) for a in (key_pos, q_pos))


@pytest.mark.parametrize("s", [1, 63, 65])
@pytest.mark.parametrize("dh", [80, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_at_tile_edges(s, dh, dtype, cuda):
    """One key, one key short of and one past four 16-key tiles; an 80-wide
    head (10 bf16 or 20 f32 chunks of 16 bytes, not a power of two)."""
    b, h, hkv = 3, 12, 4
    rng = np.random.default_rng(8)
    q = torch.from_numpy(rng.standard_normal((b, h, dh)).astype(np.float32)).to(cuda)
    k, v = (_zoo_cache(b, s, hkv, dh, dtype, cuda, seed) for seed in (9, 10))
    key_pos, q_pos = _positions(b, s, rng, cuda)
    for args in ((None, None, None), (None, key_pos, q_pos)):
        got = dops.decode_attention(q, k, v, args[0], key_pos=args[1], q_pos=args[2])
        want = _decode64(q, k, v, *args).float()
        torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_g16_long_context_with_positions(dtype, cuda):
    """llama3-405b's G = 16 over a 32768-slot cache, half of it masked."""
    b, h, hkv, s, dh = 2, 32, 2, 32768, 128
    rng = np.random.default_rng(11)
    q = torch.from_numpy(rng.standard_normal((b, h, dh)).astype(np.float32)).to(cuda)
    k, v = (_zoo_cache(b, s, hkv, dh, dtype, cuda, seed) for seed in (12, 13))
    key_pos, q_pos = _positions(b, s, rng, cuda, masked_half=True)
    assert dops.device_plan(q, k).splits > 1
    got = dops.decode_attention(q, k, v, key_pos=key_pos, q_pos=q_pos)
    want = _decode64(q, k, v, None, key_pos, q_pos).float()
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("with_positions", [False, True])
def test_decode_attention_many_ranges_with_empty_ones(with_positions, cuda):
    """64 key ranges of 128 keys; ragged lengths leave most ranges of the
    short sequences past their length (never run, skipped by the merge)."""
    b, h, hkv, s, dh = 4, 12, 4, 8192, 128
    rng = np.random.default_rng(14)
    q = torch.from_numpy(rng.standard_normal((b, h, dh)).astype(np.float32)).to(cuda)
    k, v = (_zoo_cache(b, s, hkv, dh, torch.bfloat16, cuda, seed) for seed in (15, 16))
    lengths = torch.tensor([1, 129, 5000, s], dtype=torch.int32, device=cuda)
    key_pos = q_pos = None
    if with_positions:
        key_pos, q_pos = _positions(b, s, rng, cuda)
        key_pos[torch.arange(b, device=cuda), 0] = (q_pos + 1).int()  # slot 0 valid everywhere
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = dops.split_plan(b, hkv, h // hkv, s, dh, 2, sms, want=64)
    assert plan.splits == 64 and plan.range_keys == 128
    before = dops.LAUNCHES
    got = dops.launch(q, k, v, lengths, key_pos, q_pos, plan)
    torch.cuda.synchronize()
    assert dops.LAUNCHES == before + 1  # one call, the merge included
    want = _decode64(q, k, v, lengths, key_pos, q_pos).float()
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


def test_decode_attention_plan_counts_with_the_built_registers(cuda):
    """Loading the library reads every instantiation's registers, within
    what the kernel's __launch_bounds__(128, 1) allows; the plan uses them."""
    q = torch.zeros(1, 16, 128, device=cuda)
    k = torch.zeros(1, 1, 4096, 128, device=cuda, dtype=torch.bfloat16)
    plan = dops.device_plan(q, k)
    assert sorted(dops._regs) == [(e, g) for e in (2, 4) for g in (1, 2, 3, 4, 8)]
    assert all(0 < n <= 255 for n in dops._regs.values())
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert plan == dops.launch_plan(1, 1, 16, 4096, 128, 2, sms, dops._regs[2, 8], False)


@pytest.mark.parametrize("s", [48, 32768])
def test_decode_attention_kernel_replays_from_a_cuda_graph(s, cuda):
    """The zoo's decode step (one range) and a long cache (ranges and the
    merge), with the path's position mask: captured once, replayed on new
    values of the same inputs, the same outputs as an eager call."""
    b, h, hkv, dh = 4, 24, 8, 128
    rng = np.random.default_rng(17)

    def inputs(seed):
        r = np.random.default_rng(seed)
        q = torch.from_numpy(r.standard_normal((b, h, dh)).astype(np.float32)).to(cuda)
        k, v = (_zoo_cache(b, s, hkv, dh, torch.bfloat16, cuda, seed + i) for i in (1, 2))
        return q, k, v

    q, k, v = inputs(0)
    key_pos, q_pos = _positions(b, s, rng, cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        dops.decode_attention(q, k, v, key_pos=key_pos, q_pos=q_pos)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = dops.decode_attention(q, k, v, key_pos=key_pos, q_pos=q_pos)
    for seed in (10, 20):
        for t, new in zip((q, k, v), inputs(seed)):
            t.copy_(new)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, dops.decode_attention(q, k, v, key_pos=key_pos, q_pos=q_pos))
        want = _decode64(q, k, v, None, key_pos, q_pos).float()
        torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


def _fold_bundles(name, seeds, device):
    return [scenarios.build(name, seed=s, device=device) for s in seeds]


def _run_seeds_on(runner, bundles, seeds, cfg, device):
    from repro_torch.core.protocol import run_seeds

    return run_seeds(
        runner, list(seeds), [b.split for b in bundles], [b.extractors for b in bundles],
        [b.ssl_cfgs for b in bundles], cfg, device=device,
    )


def test_folded_one_shot_on_the_card(cuda):
    """``run_seeds`` one-shot on hard/overlap-32 at seeds 0-3, 2 epochs, on
    the card: every seed's ledger the CPU's, step ③ ONE k-means search over
    the 4·2 gradient matrices (exactly 27 ``kmeans`` launches for the fold,
    against 4 · 27 by loop), the stacked ④ session, no Eq. 10 launch."""
    from repro_torch.core.protocol import run_one_shot

    cfg = ProtocolConfig(client_epochs=2, server_epochs=2)
    seeds = range(4)
    want = _run_seeds_on(run_one_shot, _fold_bundles("hard/overlap-32", seeds, "cpu"), seeds, cfg, "cpu")
    bundles = _fold_bundles("hard/overlap-32", seeds, cuda)
    before, before_km = ops.LAUNCHES, kops.LAUNCHES
    got = _run_seeds_on(run_one_shot, bundles, seeds, cfg, cuda)
    assert (ops.LAUNCHES - before, kops.LAUNCHES - before_km) == (0, cfg.kmeans_iters + 2)
    for g, w in zip(got, want):
        assert [e.__dict__ for e in g.ledger.events] == [e.__dict__ for e in w.ledger.events]
        d = g.diagnostics
        assert (d["engine_path"], d["seed_fold"], d["kernel_fold"]) == ("vmap", 4, 8)
        assert g.clients[0].extractor.layers[0].weight.is_cuda and 0.0 <= g.metric <= 1.0


def test_folded_few_shot_on_the_card(cuda):
    """``run_seeds`` few-shot on hard/overlap-32 at seeds 0-1, 2 epochs, on
    the card: the CPU's ledgers; step ③' one Eq. 10 launch a party over the
    stacked seeds (K = 2: exactly 2 ``sdpa_estimator`` launches, width 2
    each), its estimates and p̂ within 1e-4 of the CPU's plain route on the
    run's own inputs; 27 ``kmeans`` launches."""
    cfg = ProtocolConfig(client_epochs=2, server_epochs=2)
    seeds = range(2)
    want = _run_seeds_on(run_few_shot, _fold_bundles("hard/overlap-32", seeds, "cpu"), seeds, cfg, "cpu")
    bundles = _fold_bundles("hard/overlap-32", seeds, cuda)
    before, before_km = ops.LAUNCHES, kops.LAUNCHES
    got = _run_seeds_on(run_few_shot, bundles, seeds, cfg, cuda)
    assert (ops.LAUNCHES - before, kops.LAUNCHES - before_km) == (2, cfg.kmeans_iters + 2)
    for g, w in zip(got, want):
        assert [e.__dict__ for e in g.ledger.events] == [e.__dict__ for e in w.ledger.events]
        assert g.diagnostics["sdpa_fold"] == 2
        chip_smoke.check_step3p(g, "folded few-shot")


@pytest.mark.parametrize("num_parties", [2, 4])
@pytest.mark.parametrize("entries", [1, 3])
def test_estimate_missing_batched_against_the_plain_route(entries, num_parties, cuda):
    """``dispatch.estimate_missing_batched`` on the card against the CPU's
    plain route on the same inputs, within TOL of float64: one launch for all
    K − 1 missing parties (fused: stride-0 at one entry, repeated over
    several), each estimate (E, N_u, d_j)."""
    from repro_torch.engine import dispatch

    rng = np.random.default_rng(entries * 10 + num_parties)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    h_u = t(entries, 600, 16)
    h_o = [t(entries, 32, 16) for _ in range(num_parties)]
    for k in range(num_parties):
        before = ops.LAUNCHES
        got = dispatch.estimate_missing_batched(h_u.to(cuda), [h.to(cuda) for h in h_o], k)
        assert ops.LAUNCHES - before == 1
        want = dispatch.estimate_missing_batched(h_u, h_o, k)
        others = [j for j in range(num_parties) if j != k]
        assert len(got) == len(want) == len(others)
        for g, w, j in zip(got, want, others):
            assert g.shape == (entries, 600, 16) and g.is_cuda
            torch.testing.assert_close(g.cpu(), w, atol=1e-4, rtol=0)
            oracle = _oracle64(h_u, h_o[k], h_o[j])
            assert (g.cpu().double() - oracle).abs().max().item() <= TOL


def _rel_param_gap(got, want) -> float:
    """max |Δ| over every parameter of two results, over the largest |param|."""
    ps = [p for c in got.clients for p in c.extractor.parameters()]
    ps += list(got.server.classifier.parameters())
    qs = [p for c in want.clients for p in c.extractor.parameters()]
    qs += list(want.server.classifier.parameters())
    err = max((p - q).abs().max().item() for p, q in zip(ps, qs, strict=True))
    return err / max(q.abs().max().item() for q in qs)


@pytest.mark.parametrize("method", ["run_vanilla", "run_fedbcd", "run_fedcvt"])
def test_folded_baselines_on_the_card(method, cuda):
    """``run_seeds`` of each baseline on hard/overlap-32 at seeds 0-1 and 20
    iterations, on the card: the CPU's ledgers, the stacked session
    (``engine_mode`` "vmap": two entries take the loop under "auto"), no
    kernel launch, and every seed within 1e-4 of the largest parameter of
    its single-seed run on the card (the loop)."""
    import dataclasses

    from repro_torch.core.protocol import run_seeds

    cfg = baselines.IterativeConfig(iterations=20)
    seeds = range(2)
    fn = getattr(baselines, method)
    cpu = _run_seeds_on(fn, _fold_bundles("hard/overlap-32", seeds, "cpu"), seeds, cfg, "cpu")
    bundles = _fold_bundles("hard/overlap-32", seeds, cuda)
    before, before_km = ops.LAUNCHES, kops.LAUNCHES
    got = run_seeds(
        fn, list(seeds), [b.split for b in bundles], [b.extractors for b in bundles],
        [b.ssl_cfgs for b in bundles], dataclasses.replace(cfg, engine_mode="vmap"), device=cuda,
    )
    assert (ops.LAUNCHES, kops.LAUNCHES) == (before, before_km)
    for seed, b, g, w in zip(seeds, bundles, got, cpu):
        assert [e.__dict__ for e in g.ledger.events] == [e.__dict__ for e in w.ledger.events]
        assert (g.diagnostics["engine_path"], g.diagnostics["seed_fold"]) == ("vmap", 2)
        loop = fn(seed, b.split, b.extractors, b.ssl_cfgs, cfg, device=cuda)
        assert loop.diagnostics["engine_path"] == "python"
        assert _rel_param_gap(g, loop) <= 1e-4
        assert bool(torch.isfinite(g.diagnostics["losses"]).all()) and 0.0 <= g.metric <= 1.0


def test_folded_few_shot_finetune_on_the_card(cuda):
    """``run_seeds(run_few_shot_finetune)`` on hard/overlap-32 at seeds 0-1,
    2 epochs: the few-shot fold's exact launches (K = 2: 2
    ``sdpa_estimator``, one k-means search of 27) and none from the folded
    finetune; the CPU's ledgers, 5 + 2·200 comm times."""
    cfg = ProtocolConfig(client_epochs=2, server_epochs=2)
    seeds = range(2)
    want = _run_seeds_on(run_few_shot_finetune, _fold_bundles("hard/overlap-32", seeds, "cpu"), seeds,
                         cfg, "cpu")
    bundles = _fold_bundles("hard/overlap-32", seeds, cuda)
    before, before_km = ops.LAUNCHES, kops.LAUNCHES
    got = _run_seeds_on(run_few_shot_finetune, bundles, seeds, cfg, cuda)
    assert (ops.LAUNCHES - before, kops.LAUNCHES - before_km) == (2, cfg.kmeans_iters + 2)
    for g, w in zip(got, want):
        assert [e.__dict__ for e in g.ledger.events] == [e.__dict__ for e in w.ledger.events]
        assert g.ledger.comm_times() == 5 + 2 * 200
        assert 0.0 <= g.diagnostics["fewshot_metric"] <= 1.0 and 0.0 <= g.metric <= 1.0


# ------------------------------------------------------------- deployment
def _deploy_artifacts(device):
    """A K = 8 MLP artifact (composed at every capacity) and a K = 4 CNN one
    (stacked up to 64 rows a step, composed above), seeded, overlap reps
    included."""
    gen = torch.Generator().manual_seed(3)
    mlp = ExtractorSpec("mlp", 8, hidden=(32,))
    cnn = ExtractorSpec("cnn", 16, widths=(8, 16), blocks_per_stage=2)
    out = []
    for spec, shapes in ((mlp, [(5,)] * 8), (cnn, [(8, 4, 3)] * 4)):
        aligned = [torch.randn(48, *s, generator=gen) for s in shapes]
        out.append(init_artifact([spec] * len(shapes), shapes, 3, seed=1, device="cpu", aligned=aligned))
    return out


def test_save_and_load_on_the_card(cuda, tmp_path):
    """An artifact on the card saved and loaded back on the card: the same
    logits bit for bit; loaded on the CPU, the same weights."""
    for i, art_cpu in enumerate(_deploy_artifacts(cuda)):
        save_artifact(str(tmp_path / f"c{i}"), art_cpu)
        art = load_artifact(str(tmp_path / f"c{i}"), device=cuda)
        save_artifact(str(tmp_path / f"g{i}"), art)
        again = load_artifact(str(tmp_path / f"g{i}"), device=cuda)
        xs = [torch.randn(37, *s, device=cuda) for s in art.feature_shapes]
        assert torch.equal(again.predict_logits(xs), art.predict_logits(xs))
        for a, b, c in zip(again.overlap_reps, art.overlap_reps, art_cpu.overlap_reps):
            assert a.is_cuda and torch.equal(a, b) and torch.equal(a.cpu(), c)
        back = load_artifact(str(tmp_path / f"g{i}"), device="cpu")
        for m, n in zip(back.classifier.parameters(), art_cpu.classifier.parameters()):
            assert torch.equal(m, n)


def test_fused_engine_on_the_card_matches_the_cpu(cuda, tmp_path):
    """Both fused paths on the card against the CPU's engine on the same
    weights and rows (TF32 off): within 1e-4 of the logits' scale, and the
    two paths within 2e-5 of it."""
    for i, art_cpu in enumerate(_deploy_artifacts(cuda)):
        save_artifact(str(tmp_path / str(i)), art_cpu)
        art = load_artifact(str(tmp_path / str(i)), device=cuda)
        xs = [torch.randn(150, *s) for s in art.feature_shapes]
        want = ServingEngine(art_cpu, capacity=8, device="cpu").predict_logits(xs)
        scale = max(1.0, want.abs().max().item())
        for capacity in (8, 128):
            engine = ServingEngine(art, capacity=capacity, device=cuda)
            assert engine.path == ("stacked" if i == 1 and capacity == 8 else "composed")
            got = engine.predict_logits([x.to(cuda) for x in xs]).cpu()
            torch.testing.assert_close(got, want, atol=1e-4 * scale, rtol=0)
        batch = batching.pad_to_capacity([x[:8].to(cuda) for x in xs], 8)
        with torch.inference_mode():
            outs = [
                vfl_serve._build_fused_forward(art, p)(
                    vfl_serve._party_params(art, p), art.classifier, batch.xs, batch.mask
                ).cpu()
                for p in vfl_serve.PATHS
            ]
        torch.testing.assert_close(outs[0], outs[1], atol=2e-5 * scale, rtol=0)


def test_router_card_rule(cuda):
    """On the card the router's rule is the kernel, and a partial-party
    query launches the ``sdpa_estimator`` kernel once (its K−1 = 7 Eq. 10
    estimates fused)."""
    assert KernelRouter.default() == KernelRouter("cuda") and KernelRouter("cuda").kernels_viable
    art = _deploy_artifacts(cuda)[0]
    art = init_artifact(art.extractor_specs, art.feature_shapes, 3, seed=1, device=cuda,
                        aligned=[torch.randn(48, 5, device=cuda) for _ in range(8)])
    assert KernelRouter.default().use_sdpa(20, 48, 8, batch=art.num_parties - 1)
    engine = ServingEngine(art, capacity=16, device=cuda)
    x = torch.randn(20, 5, device=cuda)
    before = ops.LAUNCHES
    got = engine.predict_logits_partial(x, 1)
    assert ops.LAUNCHES == before + 1
    assert got.shape == (20, 3) and bool(torch.isfinite(got).all())


# ------------------------------------------------ the zoo's MoE, SSM, hybrid --
def _family_model(name, cuda):
    cfg = chip_smoke._zoo_cfg(name, reduced=True)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    return cfg, model, params


@pytest.mark.parametrize(  # the last families: test_reduced_last_zoo_family_...
    "name", sorted(set(chip_smoke.ZOO_SMALL_LAUNCHES) - set(chip_smoke.ZOO_LAST))
)
def test_reduced_zoo_family_on_the_card_matches_the_cpu(name, cuda):
    """Eight decode steps and a prefill of the reduced config (f32
    activations, f32 cache) on the card and on the CPU from the same
    weights: logits within 1e-4 of their scale, and exactly the config's
    RMSNorm and decode-attention launches a step."""
    want_rms, want_dec = chip_smoke.ZOO_SMALL_LAUNCHES[name]
    cfg, model, params = _family_model(name, cuda)
    host = copy.deepcopy(params).cpu()
    toks = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(1))
    toks = toks.to(torch.int32)
    caches = {
        dev: chip_smoke._f32_cache(zeros_like_spec(model.cache_shapes(2, 8), dev))
        for dev in (cuda, "cpu")
    }
    for t in range(8):
        outs = {}
        for dev, p in ((cuda, params), ("cpu", host)):
            batch = {"token": toks[:, t : t + 1].to(dev), "pos": torch.full((2, 1), t).int().to(dev)}
            rops.LAUNCHES = dops.LAUNCHES = 0
            outs[dev], caches[dev] = model.decode_fn(p, caches[dev], batch)
            torch.cuda.synchronize()
            if dev == cuda:
                assert (rops.LAUNCHES, dops.LAUNCHES) == (want_rms, want_dec)
        assert chip_smoke._rel(outs[cuda].cpu(), outs["cpu"]) <= 1e-4, t
    rops.LAUNCHES = dops.LAUNCHES = 0
    got = model.prefill_fn(params, {"tokens": toks.to(cuda)})
    torch.cuda.synchronize()
    assert (rops.LAUNCHES, dops.LAUNCHES) == (want_rms, 0)
    want = model.prefill_fn(host, {"tokens": toks})
    assert chip_smoke._rel(got.cpu(), want) <= 1e-4


@pytest.mark.parametrize("case", ["decode", "prefill-drops"])
def test_moe_apply_on_the_card_keeps_the_cpus_slots(case, cuda):
    """The router's top-k and the dispatch on the card keep the same slots
    as on the CPU, and the output agrees within 1e-5 of its scale. At
    prefill the capacity factor is 0.5: 16 slots an expert for 128, so half
    the slots or more drop whatever the routing."""
    cfg, _, params = _family_model("granite-moe-3b-a800m", cuda)
    if case == "prefill-drops":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    moe_params = params.blocks[0].moe
    host = copy.deepcopy(moe_params).cpu()
    b, s = (4, 1) if case == "decode" else (2, 32)
    rng = np.random.default_rng(2)
    x = torch.from_numpy((rng.standard_normal((b, s, cfg.d_model)) + 0.5).astype(np.float32))
    cap = zoo_moe.capacity(cfg, b * s, s)
    with torch.no_grad():
        *_, dest_c, keep_c = zoo_moe.route(moe_params, x.reshape(b * s, -1).to(cuda), cfg, cap)
        *_, dest_h, keep_h = zoo_moe.route(host, x.reshape(b * s, -1), cfg, cap)
        got, _ = zoo_moe.moe_apply(moe_params, x.to(cuda), cfg)
        want, _ = zoo_moe.moe_apply(host, x, cfg)
    assert torch.equal(keep_c.cpu(), keep_h) and torch.equal(dest_c.cpu(), dest_h)
    assert bool(keep_h.all()) == (case == "decode")
    assert chip_smoke._rel(got.cpu(), want) <= 1e-5


# ------------------------------- the zoo's MLA, vlm, audio and the window --
def _ring_positions(b, s, window, rng, device, stale_share=1 / 3):
    """An S-slot ring at ragged query positions (past 2S: wrapped twice),
    each slot holding the last position it took or (``stale_share`` of
    them, never the query's own) the one a turn before; the window's term
    masks the stale ones where ``window`` <= S."""
    q_pos = rng.integers(2 * s, 3 * s, b)
    slot = np.arange(s)
    last = q_pos[:, None] - (q_pos[:, None] - slot) % s
    stale = rng.random((b, s)) < stale_share
    stale[np.arange(b), q_pos % s] = False
    key_pos = last - s * stale + 1
    return (torch.from_numpy(a.astype(np.int32)).to(device) for a in (key_pos, q_pos))


@pytest.mark.parametrize(
    "shape, window",
    [
        ((4, 24, 8, 16, 128), 16),  # phi4-mini's 16-slot ring under a window of 16
        ((4, 24, 8, 16, 128), 5),  # a window inside the ring
        ((2, 16, 16, 48, 64), 20),  # seamless's self-attention (G = 1)
        ((2, 64, 8, 4096, 128), 1000),  # qwen2-vl's G = 8, several key ranges
    ],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_window_on_a_wrapped_ring(shape, window, dtype, cuda):
    b, h, hkv, s, dh = shape
    rng = np.random.default_rng(21)
    q = torch.from_numpy(rng.standard_normal((b, h, dh)).astype(np.float32)).to(cuda)
    k, v = (_zoo_cache(b, s, hkv, dh, dtype, cuda, seed) for seed in (22, 23))
    key_pos, q_pos = _ring_positions(b, s, window, rng, cuda)
    before = dops.LAUNCHES
    got = dops.decode_attention(q, k, v, key_pos=key_pos, q_pos=q_pos, window=window)
    torch.cuda.synchronize()
    assert dops.LAUNCHES == before + 1
    want = _decode64(q, k, v, None, key_pos, q_pos, window).float()
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
    unwindowed = _decode64(q, k, v, None, key_pos, q_pos).float()
    if window <= s:  # the window's term masked some slot: the output moved
        assert (unwindowed - want).abs().max() > 1e-3


def test_decode_attention_refuses_a_window_without_positions_or_below_one(cuda):
    q, k = torch.zeros(2, 4, 16, device=cuda), torch.zeros(2, 2, 8, 16, device=cuda)
    pos = torch.ones(2, 8, dtype=torch.int32, device=cuda)
    qpos = torch.zeros(2, dtype=torch.int32, device=cuda)
    before = dops.LAUNCHES
    with pytest.raises(ValueError, match="key_pos"):
        dops.decode_attention(q, k, k, window=4)
    for bad in (0, -1):
        with pytest.raises(ValueError, match="window must be"):
            dops.decode_attention(q, k, k, key_pos=pos, q_pos=qpos, window=bad)
    assert dops.LAUNCHES == before


def _last_family_cases():
    cases = [(name, None) for name in chip_smoke.ZOO_LAST]
    return cases + [(chip_smoke.ZOO_ARCH, chip_smoke.ZOO_SMALL_WINDOW)]


@pytest.mark.parametrize("name, window", _last_family_cases())
def test_reduced_last_zoo_family_on_the_card_matches_the_cpu(name, window, cuda):
    """Eight decode steps and a prefill of the reduced deepseek-v2 (MLA),
    qwen2-vl (M-RoPE, with patch embeds at prefill), seamless (enc_out
    encoded from the same frames on each device) and windowed phi4-mini (a
    4-slot ring wrapped once) on the card and on the CPU from the same
    weights: logits within 1e-4 of their scale, and exactly the config's
    RMSNorm and decode-attention launches a step."""
    want_rms, want_dec = chip_smoke.ZOO_SMALL_LAUNCHES[name]
    cfg = chip_smoke._zoo_cfg(name, reduced=True)
    model = build_model(cfg, window_override=window)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    host = copy.deepcopy(params).cpu()
    toks = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(1))
    toks = toks.to(torch.int32)
    extra = {}
    if cfg.family in ("vlm", "audio"):
        extra["embeds"] = chip_smoke._frames(cfg, 2, 5).cpu()
    caches = {}
    for dev, p in ((cuda, params), ("cpu", host)):
        caches[dev] = chip_smoke._f32_cache(zeros_like_spec(model.cache_shapes(2, 8), dev))
        if cfg.family == "audio":
            with torch.no_grad():
                frames = extra["embeds"].to(dev)
                caches[dev]["enc_out"] = chip_smoke.model_zoo._encode(p, cfg, frames)
    for t in range(8):
        outs = {}
        for dev, p in ((cuda, params), ("cpu", host)):
            batch = {"token": toks[:, t : t + 1].to(dev), "pos": torch.full((2, 1), t).int().to(dev)}
            rops.LAUNCHES = dops.LAUNCHES = 0
            outs[dev], caches[dev] = model.decode_fn(p, caches[dev], batch)
            torch.cuda.synchronize()
            if dev == cuda:
                assert (rops.LAUNCHES, dops.LAUNCHES) == (want_rms, want_dec)
        assert chip_smoke._rel(outs[cuda].cpu(), outs["cpu"]) <= 1e-4, t
    for k in ("pos", "index"):
        assert torch.equal(caches[cuda]["blocks"][k].cpu(), caches["cpu"]["blocks"][k])
    rops.LAUNCHES = dops.LAUNCHES = 0
    on_card = {k: v.to(cuda) for k, v in extra.items()}
    got = model.prefill_fn(params, {"tokens": toks.to(cuda), **on_card})
    torch.cuda.synchronize()
    assert (rops.LAUNCHES, dops.LAUNCHES) == (want_rms + chip_smoke.encoder_norms(cfg), 0)
    want = model.prefill_fn(host, {"tokens": toks, **extra})
    assert chip_smoke._rel(got.cpu(), want) <= 1e-4


@pytest.mark.parametrize("runner", [run_one_shot, run_few_shot], ids=["one_shot", "few_shot"])
def test_two_slots_of_one_card_equal_the_unsharded_fold(runner, cuda):
    """``ProtocolConfig.mesh`` on the card: 3 seeds of ``hard/overlap-32``
    on two slots of one card (the fits and ③' pad 3 entries to 4) equal the
    unsharded fold at 1e-5 on the metric and every leaf, with equal ledgers,
    and each slot launches its own k-means search and ③' estimates."""
    seeds = [0, 1, 2]
    bundles = [scenarios.build("hard/overlap-32", seed=s, device="cuda") for s in seeds]
    cfg = ProtocolConfig(client_epochs=2, server_epochs=3, engine_mode="vmap")
    card = torch.device("cuda", 0)
    runs = {}
    for slots, run_cfg in ((1, cfg), (2, dataclasses.replace(cfg, mesh=BatchMesh((card, card))))):
        torch.cuda.synchronize()
        km0, sd0 = kops.LAUNCHES, ops.LAUNCHES
        runs[slots] = run_seeds(
            runner, seeds, [b.split for b in bundles], [b.extractors for b in bundles],
            [b.ssl_cfgs for b in bundles], run_cfg, device="cuda",
        )
        eq10 = 2 * slots if runner is run_few_shot else 0  # ③': one a party a slot
        assert (kops.LAUNCHES - km0, ops.LAUNCHES - sd0) == (slots * (cfg.kmeans_iters + 2), eq10)
        assert {r.diagnostics["device_fold"] for r in runs[slots]} == {slots}
    for a, b in zip(runs[2], runs[1], strict=True):
        assert abs(a.metric - b.metric) <= 1e-5
        assert (a.ledger.total_bytes(), a.ledger.comm_times(), a.ledger.by_tag()) == (
            b.ledger.total_bytes(), b.ledger.comm_times(), b.ledger.by_tag()
        )
        la, lb = (chip_smoke._mesh_leaves(r) for r in (a, b))
        assert len(la) == len(lb)
        for p, q in zip(la, lb):
            torch.testing.assert_close(p, q, atol=1e-5, rtol=0)


def test_two_slots_of_one_card_equal_the_unsharded_vanilla_fold(cuda):
    """``IterativeConfig.mesh`` on the card: vanilla SplitNN over 3 seeds of
    ``hard/overlap-32`` (3 entries padded to 4) on two slots of one card
    equals the unsharded stacked fold at 1e-5 on the metric, every loss and
    every leaf, with equal ledgers, and launches no kernel."""
    seeds = [0, 1, 2]
    bundles = [scenarios.build("hard/overlap-32", seed=s, device="cuda") for s in seeds]
    cfg = baselines.IterativeConfig(iterations=40, engine_mode="vmap")
    card = torch.device("cuda", 0)
    runs = {}
    for slots, run_cfg in ((1, cfg), (2, dataclasses.replace(cfg, mesh=BatchMesh((card, card))))):
        km0, sd0 = kops.LAUNCHES, ops.LAUNCHES
        runs[slots] = run_seeds(
            baselines.run_vanilla, seeds, [b.split for b in bundles], [b.extractors for b in bundles],
            [b.ssl_cfgs for b in bundles], run_cfg, device="cuda",
        )
        assert (kops.LAUNCHES - km0, ops.LAUNCHES - sd0) == (0, 0)
        assert {(r.diagnostics["engine_path"], r.diagnostics["device_fold"]) for r in runs[slots]} == {
            ("vmap", slots)
        }
    for a, b in zip(runs[2], runs[1], strict=True):
        assert abs(a.metric - b.metric) <= 1e-5
        assert (a.ledger.total_bytes(), a.ledger.comm_times(), a.ledger.by_tag()) == (
            b.ledger.total_bytes(), b.ledger.comm_times(), b.ledger.by_tag()
        )
        torch.testing.assert_close(a.diagnostics["losses"], b.diagnostics["losses"], atol=1e-5, rtol=0)
        la, lb = (chip_smoke._params(r) for r in (a, b))
        assert len(la) == len(lb)
        for p, q in zip(la, lb):
            torch.testing.assert_close(p, q, atol=1e-5, rtol=0)


def test_party_processes_on_one_card_equal_the_cpu_ranks(cuda):
    """``launch/vfl_step.py`` on the card: two gloo ranks on cuda:0 run the
    one-shot session at 10 local steps and 3 vanilla steps on
    ``hard/overlap-32``'s split. The collectives counted on the card, the
    vanilla backward's reduce-scatter included, are the CPU ranks' kinds: 3
    for the session, 2 a vanilla step. Each card rank launches ``kmeans``
    10 times in the session, and its extractor and loss are within 1e-4 of
    the largest parameter of two CPU ranks' on the same draws."""
    _, jobs = chip_smoke.vfl_step_jobs()
    jobs = [[dataclasses.replace(j[3], steps=10), dataclasses.replace(j[0], steps=3)] for j in jobs]
    card = vfl_step.run_parties(vfl_step.run_party_jobs, [("cuda", j) for j in jobs], 180.0)
    cpu = vfl_step.run_parties(vfl_step.run_party_jobs, [("cpu", j) for j in jobs], 180.0)
    wants = (["all_gather", "all_reduce", "all_gather"], ["all_gather", "reduce_scatter"] * 3)
    for a_rank, b_rank in zip(card, cpu, strict=True):
        for i, (a, b) in enumerate(zip(a_rank, b_rank, strict=True)):
            assert [op.kind for op in a["ops"]] == [op.kind for op in b["ops"]] == wants[i]
            assert a["counts"] == b["counts"] and a["counts"]["pod_crossing"] == len(wants[i])
            assert (a["kmeans_launches"], b["kmeans_launches"]) == ((10, 0) if i == 0 else (0, 0))
            scale = max(1.0, max(float(np.abs(v).max()) for v in b["extractor"].values()))
            for k, v in b["extractor"].items():
                assert np.abs(a["extractor"][k] - v).max() <= 1e-4 * scale
            assert abs(a["loss"] - b["loss"]) <= 1e-4 * scale
