"""The port's serving path against the reference, on an artifact the
reference saved.

A reference ``TrainedVFLModel`` goes through
``repro.checkpoint.save_artifact``. Its params have the tree and shapes of the
reference's own init (``jax.eval_shape`` of it, which compiles nothing) and
seeded numpy values, so no bias is zero and no GroupNorm scale is one; its
overlap reps are seeded too.
``repro_torch.checkpoint.load_artifact`` reads it back on the CPU. The
port's unbatched, batched and partial-party logits are then held against the
reference's ``predict_logits`` and its ``ServingEngine`` (jnp route), for
MLP and CNN parties at K = 2 and K = 3.
"""

import tempfile

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import ExtractorSpec as JxSpec
from repro.checkpoint import TrainedVFLModel as JxModel
from repro.checkpoint import save_artifact, save_checkpoint
from repro.engine.local_ssl import PartyParams
from repro.launch.vfl_serve import KernelRouter
from repro.launch.vfl_serve import ServingEngine as JxEngine
from repro.models.extractors import make_classifier
from repro_torch import bridge
from repro_torch.checkpoint import load_artifact, load_checkpoint
from repro_torch.launch import batching, vfl_serve
from repro_torch.launch.vfl_serve import ServingEngine

N_O = 24  # overlap rows
CLASSES = 5
# MLP logits agree to a few f32 ulps. CNN logits chain 5 convolutions and
# GroupNorms whose f32 sums run in framework-specific orders (see
# test_torch_extractors.py); both are held relative to the logits' scale.
TOL = {"mlp": 1e-5, "cnn": 2e-5}

CONFIGS = {
    # name: (kind, per-party specs, per-party feature shapes)
    "mlp_k2": ("mlp", [JxSpec("mlp", 8, hidden=(16,))] * 2, [(7,), (7,)]),
    "mlp_k3_hetero": (
        "mlp",
        [JxSpec("mlp", 8, hidden=(16,)), JxSpec("mlp", 8, hidden=(12, 12)), JxSpec("mlp", 8)],
        [(5,), (6,), (7,)],
    ),
    "cnn_k2": ("cnn", [JxSpec("cnn", 8, widths=(8, 16), blocks_per_stage=1)] * 2, [(8, 4, 3)] * 2),
    "cnn_k3": ("cnn", [JxSpec("cnn", 8, widths=(8, 8), blocks_per_stage=1)] * 3, [(8, 3, 3)] * 3),
}


def _init(model, sample, rng):
    """Params in the reference init's tree and shapes, seeded N(0, 0.5²)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), sample)
    return jax.tree_util.tree_map(
        lambda s: (0.5 * rng.standard_normal(s.shape)).astype(np.float32), shapes
    )


def _reference_artifact(name, seed=0):
    _, specs, shapes = CONFIGS[name]
    rng = np.random.default_rng(seed)
    head_model = make_classifier(CLASSES)
    client_params = []
    for spec, shape in zip(specs, shapes):
        ext = _init(spec.build(), jnp.zeros((2, *shape)), rng)
        head = _init(head_model, jnp.zeros((1, spec.rep_dim)), rng)
        client_params.append(PartyParams(ext, head))
    joint = jnp.zeros((1, sum(s.rep_dim for s in specs)))
    server = _init(head_model, joint, rng)
    overlap = [rng.standard_normal((N_O, s.rep_dim)).astype(np.float32) for s in specs]
    return JxModel(
        scenario=f"test/{name}",
        num_classes=CLASSES,
        feature_shapes=tuple(tuple(s) for s in shapes),
        extractor_specs=tuple(specs),
        client_params=client_params,
        server_params=server,
        protocol={"client_epochs": 2},
        overlap_reps=overlap,
        metric_name="auc",
        metric=0.75,
    )


def _features(art, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, *s)).astype(np.float32) for s in art.feature_shapes]


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (err, np.abs(want).max())


@pytest.fixture(scope="module", params=list(CONFIGS))
def served(request, tmp_path_factory):
    """(config name, reference artifact, port artifact loaded from disk)."""
    ref = _reference_artifact(request.param)
    directory = str(tmp_path_factory.mktemp(request.param))
    save_artifact(directory, ref)
    return request.param, ref, load_artifact(directory, device="cpu")


def test_load_artifact_carries_every_field_and_weight(served):
    name, ref, port = served
    assert port.scenario == ref.scenario
    assert port.num_classes == CLASSES
    assert port.feature_shapes == ref.feature_shapes
    assert port.version == ref.version
    assert port.protocol == ref.protocol
    assert (port.metric_name, port.metric) == ("auc", 0.75)
    assert port.parties_are_homogeneous == ref.parties_are_homogeneous
    assert [s.kind for s in port.extractor_specs] == [s.kind for s in ref.extractor_specs]
    pairs = [(port.classifier, ref.server_params)]
    for ext, head, params in zip(port.extractors, port.heads, ref.client_params):
        pairs += [(ext, params.extractor), (head, params.head)]
    for module, params in pairs:
        back = jax.tree_util.tree_leaves(bridge.to_jax_params(module))
        for a, b in zip(jax.tree_util.tree_leaves(params), back, strict=True):
            np.testing.assert_array_equal(np.asarray(a), b)
    for a, b in zip(ref.overlap_reps, port.overlap_reps):
        np.testing.assert_array_equal(a, b.numpy())


def test_unbatched_and_batched_logits_match_reference(served):
    name, ref, port = served
    xs = _features(ref, 13, seed=1)
    want = ref.predict_logits([jnp.asarray(x) for x in xs])
    txs = [torch.from_numpy(x) for x in xs]
    _close(port.predict_logits(txs), want, TOL[CONFIGS[name][0]])
    engine = ServingEngine(port, capacity=5, device="cpu")  # 13 rows: 5 + 5 + 3
    _close(engine.predict_logits(txs), want, TOL[CONFIGS[name][0]])
    np.testing.assert_array_equal(engine.predict(txs).numpy(), np.argmax(np.asarray(want), -1))


def test_partial_party_logits_match_reference(served):
    name, ref, port = served
    jx_engine = JxEngine(ref, capacity=8, router=KernelRouter(backend="cpu", interpret=True))
    engine = ServingEngine(port, capacity=8, device="cpu")
    xs = _features(ref, 6, seed=2)
    for k in range(ref.num_parties):
        want = jx_engine.predict_logits_partial(jnp.asarray(xs[k]), k)
        got = engine.predict_logits_partial(torch.from_numpy(xs[k]), k)
        _close(got, want, TOL[CONFIGS[name][0]])


def _port_from(ref):
    with tempfile.TemporaryDirectory() as d:
        save_artifact(d, ref)
        return load_artifact(d, device="cpu")


def test_serve_traffic_pads_masks_and_matches_unbatched():
    ref = _reference_artifact("mlp_k2", seed=3)
    art = _port_from(ref)
    engine = ServingEngine(art, capacity=4, device="cpu")
    sizes = [1, 4, 9, 3]
    reqs = [tuple(torch.from_numpy(x) for x in _features(ref, n, seed=n)) for n in sizes]
    outs, rec = vfl_serve.serve_traffic(engine, reqs)
    for req, out in zip(reqs, outs):
        torch.testing.assert_close(out, art.predict_logits(req), atol=1e-6, rtol=1e-6)
    s = rec.summary()
    assert (s["batches"], s["rows"]) == (6, sum(sizes))
    assert s["p99_ms"] >= s["p50_ms"] > 0
    batch = batching.pad_to_capacity(reqs[0], 4)
    assert batch.n == 1 and batch.mask.tolist() == [True, False, False, False]
    logits = engine.step(batch)
    assert logits.shape == (4, CLASSES)
    assert torch.count_nonzero(logits[1:]) == 0  # padding rows zeroed


def test_partial_party_errors():
    ref = _reference_artifact("mlp_k2")
    ref.overlap_reps = None
    engine = ServingEngine(_port_from(ref), capacity=4, device="cpu")
    with pytest.raises(ValueError, match="overlap_reps"):
        engine.predict_logits_partial(torch.zeros(2, 7), 0)
    engine = ServingEngine(_port_from(_reference_artifact("mlp_k2")), capacity=4, device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        engine.predict_logits_partial(torch.zeros(2, 7), 2)


def test_artifact_version_gate(tmp_path):
    ref = _reference_artifact("mlp_k2")
    ref.version = 2
    save_artifact(str(tmp_path), ref)
    with pytest.raises(ValueError, match="newer"):
        load_artifact(str(tmp_path), device="cpu")


def test_checkpoint_leaf_order_and_bf16(tmp_path):
    """Leaves come back in tree_flatten's order (sorted dict keys at every
    level) and bf16 leaves, stored as raw bytes, as torch.bfloat16."""
    rng = np.random.default_rng(0)
    tree = {
        "zeta": [rng.standard_normal((2, 3)).astype(np.float32), np.arange(4, dtype=np.int32)],
        "alpha": {"w1": rng.standard_normal(5).astype(ml_dtypes.bfloat16), "b": np.ones(1)},
    }
    save_checkpoint(str(tmp_path), 7, tree, {"note": "x"})
    template = jax.tree_util.tree_map(lambda a: np.zeros(a.shape), tree)
    got, meta = load_checkpoint(str(tmp_path), template)
    assert meta == {"note": "x", "step": 7}
    assert got["alpha"]["w1"].dtype == torch.bfloat16
    bits = got["alpha"]["w1"].view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(bits, tree["alpha"]["w1"].view(np.uint16))
    np.testing.assert_array_equal(got["zeta"][1].numpy(), tree["zeta"][1])
    np.testing.assert_array_equal(got["zeta"][0].numpy(), tree["zeta"][0])
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(str(tmp_path), {**template, "zeta": [np.zeros((3, 2)), np.zeros(4)]})


def test_cli_serves_a_reference_artifact(tmp_path, capsys):
    save_artifact(str(tmp_path), _reference_artifact("mlp_k2"))
    argv = ["--artifact", str(tmp_path), "--device", "cpu", "--capacity", "4", "--requests", "3"]
    assert vfl_serve.main(argv + ["--batch-size", "6"]) == 0
    out = capsys.readouterr().out
    assert "K=2" in out and "p50=" in out and "18 rows in 6 batches" in out
