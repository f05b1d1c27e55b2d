"""The port's fused serving forward, its session cache, its path rule and
its KernelRouter, against the reference where the reference has the
function.

The artifacts are test_torch_serving.py's CONFIGS, saved by the reference
and loaded by the port, plus seeded port artifacts of K = 4 and K = 8 MLP
parties. Both paths of ``vfl_serve._build_fused_forward`` are reached
directly: stacked (one ``vmap(functional_call)`` over parameters stacked on
a leading K axis) and composed (party by party). They agree with each other
and with the artifact's unbatched ``predict_logits`` within 1e-5 (MLP) and
2e-5 of the logits' scale (CNN: ``vmap`` runs its convolutions grouped).
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmarks.torch_serving import ROUTER_SHAPES  # noqa: E402
from repro.engine.dispatch import estimate_missing as jx_estimate_missing  # noqa: E402
from repro.launch.vfl_serve import KernelRouter as JxRouter  # noqa: E402
from repro.launch.vfl_serve import ServingEngine as JxEngine  # noqa: E402
from repro_torch.checkpoint import ExtractorSpec, init_artifact  # noqa: E402
from repro_torch.engine import dispatch  # noqa: E402
from repro_torch.engine.sessions import clear_session_cache, session_cache_stats  # noqa: E402
from repro_torch.launch import batching, vfl_serve  # noqa: E402
from repro_torch.launch.vfl_serve import KernelRouter, ServingEngine  # noqa: E402
from test_torch_serving import (  # noqa: E402
    CONFIGS,
    TOL,
    _close,
    _features,
    _port_from,
    _reference_artifact,
)

HOMOGENEOUS = [n for n in CONFIGS if n != "mlp_k3_hetero"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _mlp_artifact(k, width=5, seed=0):
    gen = torch.Generator().manual_seed(seed)
    spec = ExtractorSpec("mlp", 8, hidden=(16,))
    aligned = [torch.randn(12, width, generator=gen) for _ in range(k)]
    return init_artifact([spec] * k, [(width,)] * k, 3, seed=seed, device="cpu", aligned=aligned)


def _both_paths(art, xs, capacity):
    batch = batching.pad_to_capacity(xs, capacity)
    out = {}
    with torch.inference_mode():
        for path in vfl_serve.PATHS:
            fwd = vfl_serve._build_fused_forward(art, path)
            out[path] = fwd(vfl_serve._party_params(art, path), art.classifier, batch.xs, batch.mask)
    return out, batch


@pytest.mark.parametrize("name", HOMOGENEOUS)
def test_stacked_and_composed_match_each_other_and_the_unbatched_forward(name):
    ref = _reference_artifact(name, seed=7)
    art = _port_from(ref)
    tol = TOL[CONFIGS[name][0]]
    xs = [torch.from_numpy(x) for x in _features(ref, 10, seed=8)]
    out, batch = _both_paths(art, xs, capacity=13)
    want = art.predict_logits(xs)
    for path in vfl_serve.PATHS:
        _close(out[path][:10], want.numpy(), tol)
        assert torch.count_nonzero(out[path][10:]) == 0  # padding rows zeroed
    _close(out["stacked"], out["composed"].numpy(), tol)
    # and the reference's own fused forward on the same artifact
    jx = JxEngine(ref, capacity=13, router=JxRouter(backend="cpu", interpret=True))
    _close(out["stacked"][:10], jx.predict_logits([jnp.asarray(x.numpy()) for x in xs]), tol)


@pytest.mark.parametrize("k", [4, 8])
def test_stacked_path_on_many_mlp_parties(k):
    art = _mlp_artifact(k)
    xs = [torch.randn(6, 5, generator=torch.Generator().manual_seed(j)) for j in range(k)]
    out, _ = _both_paths(art, xs, capacity=6)
    want = art.predict_logits(xs)
    for path in vfl_serve.PATHS:
        _close(out[path], want.numpy(), TOL["mlp"])


@pytest.mark.parametrize("name", HOMOGENEOUS)
def test_stacked_parameters_carry_a_leading_k_and_stay_trainable(name):
    art = _port_from(_reference_artifact(name))
    params = vfl_serve._party_params(art, "stacked")
    own = dict(art.extractors[0].named_parameters())
    assert sorted(params) == sorted(own)
    for leaf_name, leaf in params.items():
        assert leaf.shape == (art.num_parties, *own[leaf_name].shape)
        assert not leaf.requires_grad and not leaf.is_inference()
        for j, ext in enumerate(art.extractors):
            assert torch.equal(leaf[j], dict(ext.named_parameters())[leaf_name])
    # an artifact served, then fine-tuned: its modules still train
    engine = ServingEngine(art, capacity=4, device="cpu")
    xs = [torch.from_numpy(x) for x in _features(art, 3, seed=1)]
    engine.predict_logits(xs)
    art.extractors[0](xs[0]).sum().backward()
    assert all(p.grad is not None for p in art.extractors[0].parameters())


def test_heterogeneous_parties_compose():
    ref = _reference_artifact("mlp_k3_hetero", seed=2)
    art = _port_from(ref)
    assert not art.parties_are_homogeneous
    assert vfl_serve.serving_path(art, 1) == "composed"
    with pytest.raises(ValueError, match="homogeneous"):
        vfl_serve._build_fused_forward(art, "stacked")
    with pytest.raises(ValueError, match="unknown serving path"):
        vfl_serve._build_fused_forward(art, "scan")
    xs = _features(ref, 9, seed=3)
    engine = ServingEngine(art, capacity=4, device="cpu")
    assert engine.path == "composed" and isinstance(engine._party_params, list)
    got = engine.predict_logits([torch.from_numpy(x) for x in xs])
    _close(got, ref.predict_logits([jnp.asarray(x) for x in xs]), TOL["mlp"])


def _cnn_artifact(k, seed=0):
    cnn = ExtractorSpec("cnn", 8, widths=(8, 8), blocks_per_stage=1)
    return init_artifact([cnn] * k, [(4, 4, 3)] * k, 3, seed=seed, device="cpu")


def test_the_path_rule():
    for capacity in (1, 16, 64, 256, 1024):
        for k in (2, 4, 8):  # MLP parties are served composed
            assert vfl_serve.serving_path(_mlp_artifact(k), capacity) == "composed"
        assert vfl_serve.serving_path(_cnn_artifact(2), capacity) == "composed"
    k_cnn, rows = vfl_serve.STACK_MIN_CNN_PARTIES, vfl_serve.STACK_MAX_CNN_ROWS
    assert vfl_serve.serving_path(_cnn_artifact(k_cnn), rows) == "stacked"
    assert vfl_serve.serving_path(_cnn_artifact(k_cnn), 1) == "stacked"
    assert vfl_serve.serving_path(_cnn_artifact(k_cnn), rows + 1) == "composed"
    assert vfl_serve.serving_path(_cnn_artifact(k_cnn - 1), 1) == "composed"
    for name in ("cnn_k2", "cnn_k3"):
        assert vfl_serve.serving_path(_port_from(_reference_artifact(name)), 1) == "composed"
    hetero = _port_from(_reference_artifact("mlp_k3_hetero"))
    assert vfl_serve.serving_path(hetero, 1) == "composed"
    engine = ServingEngine(_cnn_artifact(k_cnn), capacity=rows, device="cpu")
    assert engine.path == "stacked" and isinstance(engine._party_params, dict)
    assert ServingEngine(_cnn_artifact(k_cnn), capacity=rows + 1, device="cpu").path == "composed"


@pytest.mark.parametrize("capacity", [4, 128])
def test_an_engine_serves_the_artifacts_current_weights_on_both_paths(capacity):
    """An engine made, then the artifact fine-tuned (an optimizer step) and
    one parameter replaced: both paths serve the new weights."""
    art = _cnn_artifact(vfl_serve.STACK_MIN_CNN_PARTIES, seed=4)
    engine = ServingEngine(art, capacity=capacity, device="cpu")
    assert engine.path == ("stacked" if capacity <= vfl_serve.STACK_MAX_CNN_ROWS else "composed")
    gen = torch.Generator().manual_seed(5)
    xs = [torch.randn(6, *s, generator=gen) for s in art.feature_shapes]
    before = engine.predict_logits(xs)
    params = [p for e in art.extractors for p in e.parameters()]
    opt = torch.optim.SGD(params, lr=0.5)
    sum(e(x).square().sum() for e, x in zip(art.extractors, xs)).backward()
    opt.step()
    tuned = engine.predict_logits(xs)
    want = art.predict_logits(xs)
    assert (tuned - before).abs().max() > 1e-3
    _close(tuned, want.numpy(), 2e-5 * max(1.0, want.abs().max().item()))
    stem = art.extractors[1].stem
    stem.weight = torch.nn.Parameter(stem.weight.detach() * 0.5)
    replaced = engine.predict_logits(xs)
    assert (replaced - tuned).abs().max() > 1e-3
    _close(replaced, art.predict_logits(xs).numpy(), 2e-5 * max(1.0, want.abs().max().item()))


@pytest.mark.parametrize("kind,k", [("mlp", 2), ("mlp", 8), ("cnn", 4)])
def test_zero_fresh_serving_misses_after_first_shape(kind, k):
    """The reference's RECOMPILE contract on the port: one built session per
    model geometry; new capacities (the 4-party CNN changes path on the way,
    from stacked to composed), a second engine, and an artifact of the same
    specs at another feature width (MLP) or seed re-serve it."""
    clear_session_cache()
    make = _mlp_artifact if kind == "mlp" else _cnn_artifact
    art = make(k)
    xs = [torch.randn(300, *s, generator=torch.Generator().manual_seed(j)) for j, s in
          enumerate(art.feature_shapes)]
    ServingEngine(art, capacity=4, device="cpu").predict_logits([x[:3] for x in xs])
    assert session_cache_stats("serving") == {"hits": 0, "misses": 1}
    paths = set()
    for capacity in (1, 16, 64, 256):
        engine = ServingEngine(art, capacity=capacity, device="cpu")
        engine.predict_logits([x[:capacity] for x in xs])
        paths.add(engine.path)
    second = _mlp_artifact(k, width=9, seed=1) if kind == "mlp" else _cnn_artifact(k, seed=1)
    ServingEngine(second, capacity=16, device="cpu").predict_logits(
        [torch.zeros(20, *s) for s in second.feature_shapes]
    )
    assert session_cache_stats("serving") == {"hits": 4 + 2, "misses": 1}  # one step a chunk
    assert paths == ({"stacked", "composed"} if kind == "cnn" else {vfl_serve.serving_path(art, 1)})


def test_serving_key_names_stackability_specs_and_classes_only():
    a, b = _mlp_artifact(2, width=5), _mlp_artifact(2, width=11, seed=3)
    assert vfl_serve._serving_key(a) == vfl_serve._serving_key(b)
    c = init_artifact([ExtractorSpec("mlp", 8, hidden=(16,))] * 2, [(5,)] * 2, 4, seed=0, device="cpu")
    assert vfl_serve._serving_key(a) != vfl_serve._serving_key(c)  # other classes
    hetero = _port_from(_reference_artifact("mlp_k3_hetero"))
    assert vfl_serve._serving_key(hetero)[0] is False
    assert sorted(vfl_serve._build_session(hetero)) == ["composed"]
    assert sorted(vfl_serve._build_session(a)) == ["composed"]  # MLP parties never stack
    cnn = _cnn_artifact(vfl_serve.STACK_MIN_CNN_PARTIES)
    assert vfl_serve._serving_key(cnn)[0] is True
    assert sorted(vfl_serve._build_session(cnn)) == ["composed", "stacked"]


def test_kernel_router_rules():
    cpu, card = KernelRouter("cpu"), KernelRouter("cuda")
    assert not cpu.kernels_viable and card.kernels_viable
    for b, nu, no, d, _ in [(1, 1 << 20, 1 << 10, 64, 0), *ROUTER_SHAPES]:
        assert not cpu.use_sdpa(nu, no, d, batch=b)
        assert card.use_sdpa(nu, no, d, batch=b)  # the kernel at every swept shape
    assert KernelRouter.default("cpu") == cpu
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            KernelRouter.default()


@pytest.mark.parametrize("k_parties,k", [(2, 0), (2, 1), (3, 1), (4, 3)])
def test_estimate_missing_matches_the_reference(k_parties, k):
    """The reference's per-party ``estimate_missing`` against the Eq. 10
    estimates the port's partial-party queries take
    (``dispatch.estimate_missing_fused``), widths equal or not."""
    rng = np.random.default_rng(k_parties * 10 + k)
    h_u = rng.standard_normal((9, 6)).astype(np.float32)
    for widths in ([6] * k_parties, [6 if j == k else 4 + j for j in range(k_parties)]):
        h_o = [rng.standard_normal((13, w)).astype(np.float32) for w in widths]
        got = dispatch.estimate_missing_fused(
            torch.from_numpy(h_u), [torch.from_numpy(h) for h in h_o], k
        )
        assert len(got) == k_parties - 1
        for use_kernels in (False, True):
            want = jx_estimate_missing(jnp.asarray(h_u), [jnp.asarray(h) for h in h_o], k, use_kernels)
            for g, w in zip(got, want, strict=True):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)
