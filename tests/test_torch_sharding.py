"""The port's sharding specs (``repro_torch.launch.sharding``) against the
reference's ``repro.launch.sharding``, leaf for leaf, on every config at
full size; and their DTensor placements on a fake 2×2 mesh."""

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import INPUT_SHAPES as REF_SHAPES
from repro.launch import sharding as RSH
from repro.launch import specs as RSP
from repro.launch.dryrun import config_for as ref_config_for
from repro.models.model_zoo import build_model as ref_build
from repro_torch.configs import INPUT_SHAPES, all_configs, get_config
from repro_torch.launch import sharding as SH
from repro_torch.launch import specs as SP
from repro_torch.launch.dryrun import config_for
from repro_torch.launch.mesh import fake_world, make_debug_mesh
from repro_torch.models.model_zoo import build_model, make_backbone


def _fake_mesh(shape):
    class FakeMesh:
        axis_names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")

        class devices:
            pass

    FakeMesh.devices.shape = tuple(shape)
    return FakeMesh()


MESHES = [(16, 16), (2, 16, 16), (2, 2)]
FSDP = [(), ("blocks", "super", "rest")]


def _ref_leaves(tree):
    """(names, leaf) of a reference tree, names as ``_path_names`` gives them."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(RSH._path_names(path), leaf) for path, leaf in flat]


def _port_leaf(tree, names):
    for n in names:
        tree = tree[n]
    return tree


# ------------------------------------------------- the reference's own tests --
def test_param_specs_respect_divisibility():
    mesh = _fake_mesh((16, 16))
    assert SH.param_spec(["embed", "tok"], (256000, 3072), mesh) == ("model", "data")
    spec = SH.param_spec(["blocks", "ffn", "w_up"], (28, 3072, 24576), mesh)
    assert spec[0] is None and "model" in spec
    assert SH.param_spec(["x"], (7, 13), mesh) == (None, None)
    assert SH.param_spec(["attn", "b_q"], (4096,), mesh) == ("model",)


def test_cache_specs():
    spec = SH.cache_spec(["blocks", "k"], (126, 128, 32768, 8, 128), _fake_mesh((16, 16)))
    assert spec[1] == "data"
    assert spec[2] is None
    assert spec[4] == "model"


def test_batch_specs():
    m = _fake_mesh((16, 16))
    assert SH.batch_spec((256, 4096), m) == ("data", None)
    assert SH.batch_spec((1, 524288), m) == (None, None)


# ------------------------------------------------------- parity, every leaf --
@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", sorted(all_configs()))
def test_param_specs_equal_the_reference(arch, mesh_shape):
    mesh = _fake_mesh(mesh_shape)
    ref_tree = ref_build(jax_cfg(arch)).param_shapes()
    port_tree = build_model(get_config(arch)).param_shapes()
    leaves = _ref_leaves(ref_tree)
    assert len(leaves) > 5
    for fsdp in FSDP:
        for embed1 in (False, True):
            port = SH.param_specs(port_tree, mesh, fsdp, embed1)
            for names, leaf in leaves:
                want = P() if len(leaf.shape) == 0 else RSH.param_spec(
                    names, leaf.shape, mesh, fsdp_only=any(n in fsdp for n in names),
                    embed_single_axis=embed1,
                )
                assert _port_leaf(port, names) == tuple(want), (names, fsdp, embed1)


def jax_cfg(arch):
    from repro.configs import get_config as ref_get

    return ref_get(arch)


@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", sorted(all_configs()))
def test_cache_and_batch_specs_equal_the_reference(arch, mesh_shape):
    mesh = _fake_mesh(mesh_shape)
    checked = 0
    for name, shape in INPUT_SHAPES.items():
        ref_shape, cfg = REF_SHAPES[name], config_for(arch, shape)
        ref_cfg = ref_config_for(arch, ref_shape)
        assert cfg.attn_window == ref_cfg.attn_window
        batches = {
            "train": (RSP.train_specs, SP.train_specs),
            "prefill": (RSP.prefill_specs, SP.prefill_specs),
            "decode": (RSP.decode_specs, SP.decode_specs),
        }
        for kind, (ref_fn, port_fn) in batches.items():
            port = SH.batch_specs(port_fn(cfg, shape), mesh)
            for names, leaf in _ref_leaves(ref_fn(ref_cfg, ref_shape)):
                assert _port_leaf(port, names) == tuple(RSH.batch_spec(tuple(leaf.shape), mesh))
                checked += 1
        if shape.kind != "decode":
            continue
        ref_tree = ref_build(ref_cfg).cache_shapes(shape.global_batch, shape.seq_len)
        port_tree = build_model(cfg).cache_shapes(shape.global_batch, shape.seq_len)
        port = SH.cache_specs(port_tree, mesh)
        for names, leaf in _ref_leaves(ref_tree):
            want = P() if len(leaf.shape) == 0 else RSH.cache_spec(names, leaf.shape, mesh)
            assert _port_leaf(port, names) == tuple(want), names
            assert _port_leaf(port_tree, names).shape == tuple(leaf.shape)
            checked += 1
    assert checked > 20


# --------------------------------------------------------------- placements --
SPECS_2x2 = [
    ((8, 6), ("data", "model")),
    ((8, 6), (None, "model")),
    ((4, 10, 6), (("data", "model"), None, None)),
    ((6, 4), ("model", None)),
    ((5, 3), (None, None)),
    ((), ()),
]


def test_placements_shard_by_the_spec():
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    with fake_world(4):
        mesh = make_debug_mesh((2, 2))
        assert SH.placements(("data", "model"), mesh) == (Shard(0), Shard(1))
        assert SH.placements((("data", "model"), None), mesh) == (Shard(0), Shard(0))
        assert SH.placements((None, None), mesh) == (Replicate(), Replicate())
        assert SH.replicated(mesh) == (Replicate(), Replicate())
        for shape, spec in SPECS_2x2:
            t = distribute_tensor(torch.zeros(shape), mesh, SH.placements(spec, mesh))
            assert tuple(t.to_local().shape) == SH.local_shape(shape, spec, mesh), (shape, spec)
        with pytest.raises(ValueError, match="pod"):
            SH.placements(("pod", None), mesh)
    assert not torch.distributed.is_initialized()


def test_shard_trees_are_the_specs_placements():
    """``shard_params`` / ``shard_batch`` / ``shard_cache`` give each leaf
    the placements of its spec, under the reference's leaf names."""
    cfg = get_config("zamba2-1.2b")
    model = build_model(cfg)
    shape = INPUT_SHAPES["decode_32k"]
    with fake_world(256):
        from repro_torch.launch.mesh import make_production_mesh

        mesh = make_production_mesh()
        trees = [
            (SH.shard_params(model.param_shapes(), mesh, ("super",)),
             SH.param_specs(model.param_shapes(), mesh, ("super",))),
            (SH.shard_batch(SP.decode_specs(cfg, shape), mesh),
             SH.batch_specs(SP.decode_specs(cfg, shape), mesh)),
            (SH.shard_cache(model.cache_shapes(128, 4096), mesh),
             SH.cache_specs(model.cache_shapes(128, 4096), mesh)),
        ]
        for placed, specs in trees:
            flat = []
            SH.map_tree(specs, lambda names, spec: flat.append((names, spec)))
            for names, spec in flat:
                assert _port_leaf(placed, names) == SH.placements(spec, mesh)
        assert SH.axis_sizes(mesh) == {"data": 16, "model": 16}
    assert not torch.distributed.is_initialized()


def test_fake_world_refuses_a_second_group():
    with fake_world(4):
        with pytest.raises(RuntimeError, match="already initialised"):
            with fake_world(4):
                pass
    with pytest.raises(RuntimeError, match="fake_world"):
        make_debug_mesh((2, 2))


FAMILIES = [
    "phi4-mini-3.8b", "granite-moe-3b-a800m", "mamba2-370m", "zamba2-1.2b",
    "deepseek-v2-236b", "qwen2-vl-72b", "seamless-m4t-large-v2",
]


@pytest.mark.parametrize("arch", FAMILIES)
def test_module_specs_are_the_stacked_leaves_without_stack_dims(arch):
    """Each module parameter's spec is its stacked leaf's (the reference's
    rule on the reference's tree) without the leading stack dims."""
    cfg = get_config(arch)
    module = make_backbone(cfg, "meta")
    ref_tree = ref_build(jax_cfg(arch)).param_shapes()
    mesh = _fake_mesh((16, 16))
    for fsdp in FSDP:
        specs = SH.module_specs(module, build_model(cfg).param_shapes(), mesh, fsdp)
        params = dict(module.named_parameters())
        assert set(specs) == set(params)
        for name, p in params.items():
            names, index = SH.stacked_leaf(name)
            leaf = _port_leaf(ref_tree, names)
            assert tuple(leaf.shape[len(index):]) == tuple(p.shape), name
            want = RSH.param_spec(list(names), leaf.shape, mesh,
                                  fsdp_only=any(n in fsdp for n in names))
            assert specs[name] == tuple(want)[len(index):], name


def test_stacked_leaf_names():
    assert SH.stacked_leaf("blocks.3.ffn.w_up") == (("blocks", "ffn", "w_up"), (3,))
    assert SH.stacked_leaf("super.2.1.mamba.in_proj") == (("super", "mamba", "in_proj"), (2, 1))
    assert SH.stacked_leaf("embed.tok") == (("embed", "tok"), ())


def test_module_placements_on_a_real_mesh():
    cfg = get_config("zamba2-1.2b").reduced()
    module = make_backbone(cfg, "meta")
    with fake_world(4):
        mesh = make_debug_mesh((2, 2))
        specs = SH.module_specs(module, build_model(cfg).param_shapes(), mesh)
        placed = SH.module_placements(module, build_model(cfg).param_shapes(), mesh)
        assert placed.keys() == specs.keys()
        for name, spec in specs.items():
            assert placed[name] == SH.placements(spec, mesh)
