"""``ModelDef.param_shapes()`` and ``launch.steps.opt_state_shapes`` against
the reference's trees, on every config at full size (shapes only: nothing
is allocated on either side)."""

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get
from repro.launch.steps import make_optimizer as ref_make_optimizer
from repro.launch.steps import opt_state_shapes as ref_opt_state_shapes
from repro.models.model_zoo import build_model as ref_build
from repro_torch.configs import all_configs, get_config
from repro_torch.launch.specs import TensorSpec, leaves
from repro_torch.launch.steps import make_optimizer, opt_state_shapes
from repro_torch.models.model_zoo import build_model, make_backbone

ARCHS = sorted(all_configs())


def _key(entry) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(entry, attr):
            return str(getattr(entry, attr))
    raise TypeError(entry)


def _ref_flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(_key(e) for e in path): (tuple(l.shape), np.dtype(l.dtype).name) for path, l in flat}


def _port_flat(tree, path=()):
    out = {}
    if isinstance(tree, TensorSpec):
        out[path] = (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_port_flat(v, path + (str(k),)))
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            out.update(_port_flat(v, path + (str(i),)))
    else:
        raise TypeError(type(tree))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_equal_the_reference(arch):
    want = _ref_flat(ref_build(ref_get(arch)).param_shapes())
    got = _port_flat(build_model(get_config(arch)).param_shapes())
    assert got == want
    n = sum(math.prod(s) for s, _ in got.values())
    module = make_backbone(get_config(arch), "meta")
    assert n == sum(p.numel() for p in module.parameters())


def test_param_counts_at_full_size():
    counts = {a: sum(math.prod(s.shape) for s in leaves(build_model(get_config(a)).param_shapes()))
              for a in ("phi4-mini-3.8b", "mamba2-370m", "seamless-m4t-large-v2")}
    assert counts == {
        "phi4-mini-3.8b": 3836021760,
        "mamba2-370m": 419825152,
        "seamless-m4t-large-v2": 1632131072,
    }


@pytest.mark.parametrize("optimizer", ["adam", "sgdm"])
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_shapes_equal_eval_shape_of_init(arch, optimizer):
    ref_cfg = dataclasses.replace(ref_get(arch), optimizer=optimizer)
    cfg = dataclasses.replace(get_config(arch), optimizer=optimizer)
    ref_params = ref_build(ref_cfg).param_shapes()
    want = _ref_flat(ref_opt_state_shapes(ref_make_optimizer(ref_cfg), ref_params))
    tx = make_optimizer(cfg)
    assert tx.kind == optimizer
    got = _port_flat(opt_state_shapes(tx, build_model(cfg).param_shapes()))
    assert got == want
    assert ("1", "step") in got and got[("1", "step")] == ((), "int32")


def test_opt_state_matches_the_optimizers_tensors():
    """The port's optimizer objects hold exactly the spec's moments, as f32
    lists in parameter order."""
    cfg = get_config("mamba2-370m").reduced()
    module = make_backbone(cfg, "cpu")
    state = make_optimizer(cfg).init(list(module.parameters()))
    spec = opt_state_shapes(make_optimizer(cfg), build_model(cfg).param_shapes())[1]
    assert len(state.mu) == len(list(module.parameters()))
    assert all(m.dtype == torch.float32 for m in state.mu + state.nu)
    assert sum(m.numel() for m in state.mu) == sum(math.prod(s.shape) for s in leaves(spec["mu"]))
