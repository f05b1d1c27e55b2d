"""The port's writers against the reference's readers.

``repro_torch.checkpoint.save_checkpoint`` must write what the reference's
``load_checkpoint`` reads (leaf order, dtypes, bf16 as raw 2-byte records,
metadata), atomically; ``save_artifact`` must write what the reference's
``load_artifact`` reads, with the metadata and leaves the reference's own
``save_artifact`` writes for the same parameters. The artifacts are
test_torch_serving.py's four CONFIGS (MLP K = 2, heterogeneous MLP K = 3,
CNN K = 2, CNN K = 3): a reference artifact goes through the reference's
save and the port's load, then the port's save, and the reference's load
and forward are held against the port's within that file's TOL. A model the
port trains is saved and read back by the reference too.
"""

import json
import os
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmarks import torch_serving  # noqa: E402
from repro.checkpoint import latest_step as jx_latest_step  # noqa: E402
from repro.checkpoint import load_artifact as jx_load_artifact  # noqa: E402
from repro.checkpoint import load_checkpoint as jx_load_checkpoint  # noqa: E402
from repro.checkpoint import save_artifact as jx_save_artifact  # noqa: E402
from repro.launch.vfl_serve import KernelRouter as JxRouter  # noqa: E402
from repro.launch.vfl_serve import ServingEngine as JxEngine  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    latest_step,
    load_artifact,
    save_artifact,
    save_checkpoint,
)
from repro_torch.launch.vfl_serve import ServingEngine  # noqa: E402
from test_torch_serving import CONFIGS, TOL, _close, _features, _reference_artifact  # noqa: E402


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _tree(rng):
    """Nested dicts with unsorted keys, lists, f32, int32 and bf16 leaves:
    the port's tree (torch) and the reference template it loads into."""
    w = rng.standard_normal((3, 4)).astype(np.float32)
    ids = np.arange(6, dtype=np.int32).reshape(2, 3)
    half = rng.standard_normal(5).astype(np.float32)
    stack = [rng.standard_normal((2, 2)).astype(np.float32), np.array([7], np.int32)]
    port = {
        "zeta": {"w": torch.from_numpy(w), "ids": torch.from_numpy(ids)},
        "alpha": [torch.from_numpy(stack[0]), torch.from_numpy(stack[1])],
        "mid": {"b2": torch.from_numpy(half).to(torch.bfloat16), "a1": torch.tensor(2.5)},
    }
    want = {
        "zeta": {"w": w, "ids": ids},
        "alpha": stack,
        "mid": {"b2": half.astype(ml_dtypes.bfloat16), "a1": np.float32(2.5)},
    }
    template = jax.tree_util.tree_map(lambda a: jnp.zeros(np.shape(a), jnp.asarray(a).dtype), want)
    return port, want, template


@pytest.mark.parametrize("where", ["tmp_path", "tempdir"])
def test_save_checkpoint_loads_in_the_reference(where, tmp_path):
    port, want, template = _tree(np.random.default_rng(0))
    with tempfile.TemporaryDirectory() as tmp:
        d = str(tmp_path / "ck") if where == "tmp_path" else os.path.join(tmp, "ck")
        path = save_checkpoint(d, 5, port, {"note": "x", "k": [1, 2]})
        assert path.endswith("ckpt_00000005.npz")
        got, meta = jx_load_checkpoint(d, template)
        assert meta == {"note": "x", "k": [1, 2], "step": 5}
        assert jx_latest_step(d) == 5
    assert got["mid"]["b2"].dtype == jnp.bfloat16
    assert got["zeta"]["ids"].dtype == jnp.int32
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want), strict=True):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_writer_is_atomic_overwrites_in_place_and_latest_step(tmp_path):
    d = str(tmp_path)
    assert latest_step(d) is None
    save_checkpoint(d, 3, {"w": torch.zeros(2)})
    save_checkpoint(d, 3, {"w": torch.ones(2)}, {"again": True})
    save_checkpoint(d, 10, {"w": torch.full((2,), 4.0)})
    assert sorted(os.listdir(d)) == ["ckpt_00000003.npz", "ckpt_00000010.npz"]
    assert latest_step(d) == 10
    got, meta = jx_load_checkpoint(d, {"w": jnp.zeros(2)}, step=3)
    assert meta == {"again": True, "step": 3}
    np.testing.assert_array_equal(np.asarray(got["w"]), [1.0, 1.0])
    # a leaf np.savez cannot write (a function: it pickles by name, and a
    # local lambda has none) fails the write and leaves no temporary file,
    # and the checkpoint already in place untouched
    with pytest.raises(Exception):
        save_checkpoint(d, 3, {"w": torch.zeros(2), "z": lambda: None})
    assert sorted(os.listdir(d)) == ["ckpt_00000003.npz", "ckpt_00000010.npz"]
    got, _ = jx_load_checkpoint(d, {"w": jnp.zeros(2)}, step=3)
    np.testing.assert_array_equal(np.asarray(got["w"]), [1.0, 1.0])


def _npz(directory):
    with np.load(os.path.join(directory, "ckpt_00000000.npz")) as blob:
        meta = json.loads(bytes(blob["__meta__"]).decode())
        return meta, {k: blob[k] for k in blob.files if k != "__meta__"}


@pytest.fixture(scope="module", params=list(CONFIGS))
def saved(request, tmp_path_factory):
    """(name, reference artifact, its reference-saved dir, the port's load of
    it, the port's save of that load, the reference's load of the port's save)."""
    ref = _reference_artifact(request.param)
    ref_dir = str(tmp_path_factory.mktemp(f"{request.param}_ref"))
    jx_save_artifact(ref_dir, ref)
    port = load_artifact(ref_dir, device="cpu")
    port_dir = str(tmp_path_factory.mktemp(f"{request.param}_port"))
    save_artifact(port_dir, port)
    return request.param, ref, ref_dir, port, port_dir, jx_load_artifact(port_dir)


def test_port_save_writes_the_reference_saves_metadata_and_leaves(saved):
    _, _, ref_dir, _, port_dir, _ = saved
    meta_ref, leaves_ref = _npz(ref_dir)
    meta_port, leaves_port = _npz(port_dir)
    assert meta_port == meta_ref
    assert sorted(leaves_port) == sorted(leaves_ref)
    for name, arr in leaves_ref.items():
        assert leaves_port[name].dtype == np.float32, name
        np.testing.assert_array_equal(leaves_port[name], arr, err_msg=name)


def test_reference_loads_a_port_saved_artifact(saved):
    name, ref, _, port, _, back = saved
    assert (back.scenario, back.num_classes, back.feature_shapes) == (
        ref.scenario,
        ref.num_classes,
        ref.feature_shapes,
    )
    assert back.extractor_specs == ref.extractor_specs
    assert (back.protocol, back.metric_name, back.metric) == (ref.protocol, "auc", 0.75)
    pairs = [(back.server_params, ref.server_params)]
    for a, b in zip(back.client_params, ref.client_params):
        pairs += [(a.extractor, b.extractor), (a.head, b.head)]
    pairs += [(back.overlap_reps, ref.overlap_reps)]
    for got, want in pairs:
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want), strict=True):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_reference_forward_on_a_port_saved_artifact_matches_the_port(saved):
    name, ref, _, port, _, back = saved
    tol = TOL[CONFIGS[name][0]]
    xs = _features(ref, 11, seed=4)
    want = back.predict_logits([jnp.asarray(x) for x in xs])
    _close(port.predict_logits([torch.from_numpy(x) for x in xs]), want, tol)
    jx_engine = JxEngine(back, capacity=4, router=JxRouter(backend="cpu", interpret=True))
    engine = ServingEngine(port, capacity=4, device="cpu")
    for k in range(back.num_parties):
        want = jx_engine.predict_logits_partial(jnp.asarray(xs[k][:6]), k)
        _close(engine.predict_logits_partial(torch.from_numpy(xs[k][:6]), k), want, tol)


def test_port_save_then_port_load_is_bit_exact(saved, tmp_path):
    name, ref, _, port, port_dir, _ = saved
    again = load_artifact(port_dir, device="cpu")
    xs = [torch.from_numpy(x) for x in _features(ref, 9, seed=5)]
    assert torch.equal(again.predict_logits(xs), port.predict_logits(xs))
    for a, b in zip(again.overlap_reps, port.overlap_reps):
        assert torch.equal(a, b)
    save_artifact(str(tmp_path), again)  # and a second round trip writes the same file
    assert _npz(str(tmp_path))[0] == _npz(port_dir)[0]


def test_a_model_the_port_trains_is_read_back_by_the_reference(tmp_path):
    art = torch_serving.train_artifact(seed=0, smoke=True, device="cpu")
    assert art.protocol["rep_dtype"] == "float32"
    save_artifact(str(tmp_path), art)
    back = jx_load_artifact(str(tmp_path))
    cfg = back.protocol_config()  # the port's provenance rebuilds the reference's config
    assert (cfg.client_epochs, cfg.server_epochs) == (80, 40)
    assert (back.metric_name, back.metric) == (art.metric_name, art.metric)
    assert back.overlap_reps[0].shape == (32, 16)
    xs = _features(back, 17, seed=6)
    want = back.predict_logits([jnp.asarray(x) for x in xs])
    _close(art.predict_logits([torch.from_numpy(x) for x in xs]), want, TOL["mlp"])
