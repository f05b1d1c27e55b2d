"""The port's MoE family (granite-moe-3b-a800m) against the reference.

``moe_apply`` on its own (decode, prefill with and without drops, a shared
expert), the reference's ``tests/test_moe.py`` properties on the port, and
the reduced granite model through the ``family_*`` checks of
``test_torch_zoo``. Weights and inputs are numpy draws carried to both
sides; f32 activations, 1e-5 of the outputs' scale.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.models import layers as jx_layers
from repro.models import moe as jx_moe
from repro_torch.configs import get_config
from repro_torch.models import layers, moe
from test_torch_zoo import (
    RTOL,
    _numpy_tree,
    _rel,
    family_bridge_round_trip,
    family_cache_shapes,
    family_decode_steps,
    family_init_rule,
    family_prefill_and_hidden,
    family_prefill_equals_sequential_decode,
    family_serve_cli,
    family_setup,
    load_module,
)

NAME = "granite-moe-3b-a800m"


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _moe_cfgs(base=NAME, **changes):
    out = []
    for get in (jx_get_config, get_config):
        cfg = dataclasses.replace(get(base).reduced(), activation_dtype="float32")
        out.append(dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **changes)))
    return out


def _moe_pair(jcfg, tcfg, seed=1):
    tree = _numpy_tree(jx_layers.init_params(jax.random.PRNGKey(0), jx_moe.moe_shapes(jcfg)), seed)
    return jax.tree_util.tree_map(jnp.asarray, tree), load_module(moe.MoE(tcfg), tree)


def _x(shape, seed=2, offset=0.0):
    """N(offset, 1) rows: an offset shared by every row skews the router
    toward some experts, as a real token stream does."""
    return (np.random.default_rng(seed).standard_normal(shape) + offset).astype(np.float32)


CASES = {
    "decode": ((4, 1), {}, 0.0),  # s = 1: capacity T, no drops
    # capacity_factor 1.25: 40 slots an expert of 128; the skew drops 7
    "prefill-drops": ((2, 32), {}, 0.5),
    "prefill-drop-free": ((2, 32), {"capacity_factor": 8.0}, 0.5),
    "shared-expert": ((2, 16), {"num_shared_experts": 1, "d_ff_shared": 128}, 0.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_apply_matches_the_reference(case):
    (b, s), changes, offset = CASES[case]
    jcfg, tcfg = _moe_cfgs(**changes)
    jparams, tparams = _moe_pair(jcfg, tcfg)
    x = _x((b, s, tcfg.d_model), offset=offset)
    want_y, want_aux = jx_moe.moe_apply(jparams, jnp.asarray(x), jcfg)
    with torch.no_grad():
        got_y, got_aux = moe.moe_apply(tparams, torch.from_numpy(x), tcfg)
    assert got_y.shape == (b, s, tcfg.d_model) and got_y.dtype == torch.float32
    assert _rel(got_y, want_y) < RTOL
    assert abs(float(got_aux) - float(want_aux)) < RTOL * abs(float(want_aux))
    with torch.no_grad():
        _, _, _, _, keep = moe.route(
            tparams, torch.from_numpy(x).reshape(b * s, -1), tcfg,
            moe.capacity(tcfg, b * s, s),
        )
    assert bool(keep.all()) == (case != "prefill-drops")  # drops only where meant


def test_moe_apply_bf16_rows_match_the_reference():
    """The default policy: bf16 rows scatter into a bf16 buffer exactly (one
    row a kept slot), the experts' products promote to f32."""
    jcfg, tcfg = (dataclasses.replace(c, activation_dtype="bfloat16") for c in _moe_cfgs())
    jparams, tparams = _moe_pair(jcfg, tcfg)
    x = _x((2, 32, tcfg.d_model), offset=0.5)
    want, _ = jx_moe.moe_apply(jparams, jnp.asarray(x, jnp.bfloat16), jcfg)
    with torch.no_grad():
        got, _ = moe.moe_apply(tparams, torch.from_numpy(x).bfloat16(), tcfg)
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    assert _rel(got, want) < 1e-2  # one bf16 rounding of the output (2^-8)


def test_capacity_rule():
    _, tcfg = _moe_cfgs()
    assert moe.capacity(tcfg, 4, 1) == 4  # decode: every token
    assert moe.capacity(tcfg, 64, 32) == int(64 * 2 / 4 * 1.25)
    _, tiny = _moe_cfgs(capacity_factor=0.001)
    assert moe.capacity(tiny, 64, 32) == 1
    full = get_config(NAME)  # granite at full width: 128 prompt tokens, 8 of 40 experts
    assert moe.capacity(full, 128, 32) == 32
    assert moe.capacity(dataclasses.replace(
        full, moe=dataclasses.replace(full.moe, capacity_factor=8.0)), 128, 32) == 204


def test_capacity_drops_tokens():
    """The reference's property: a tiny capacity factor drops most slots, so
    the output's energy falls."""
    _, small = _moe_cfgs(capacity_factor=0.05)
    _, big = _moe_cfgs(capacity_factor=8.0)
    _, params = _moe_pair(*_moe_cfgs())
    x = torch.from_numpy(_x((1, 64, small.d_model), seed=4))
    with torch.no_grad():
        y_small, _ = moe.moe_apply(params, x, small)
        y_big, _ = moe.moe_apply(params, x, big)
    assert y_small.abs().mean() < y_big.abs().mean()


def test_decode_is_drop_free():
    _, cfg = _moe_cfgs(capacity_factor=0.01)
    _, params = _moe_pair(*_moe_cfgs())
    with torch.no_grad():
        y, _ = moe.moe_apply(params, torch.from_numpy(_x((8, 1, cfg.d_model), seed=5)), cfg)
    assert float(y[:, 0].norm(dim=-1).min()) > 0


def test_shared_expert_is_always_on():
    """deepseek's reduced MoE (two shared experts): with capacity 1 nearly
    every slot drops, and a token with all its slots dropped gets exactly
    the shared FFN's output."""
    jcfg, tcfg = (
        dataclasses.replace(c, activation_dtype="float32", moe=dataclasses.replace(
            c.moe, capacity_factor=0.001))
        for c in (jx_get_config("deepseek-v2-236b").reduced(),
                  get_config("deepseek-v2-236b").reduced())
    )
    jparams, tparams = _moe_pair(jcfg, tcfg)
    assert hasattr(tparams, "shared")
    x = torch.from_numpy(_x((1, 8, tcfg.d_model), seed=6))
    with torch.no_grad():
        y, _ = moe.moe_apply(tparams, x, tcfg)
        _, _, _, _, keep = moe.route(tparams, x[0], tcfg, 1)
        shared = layers.ffn_apply(tparams.shared, x[0], tcfg)
    dropped = ~keep.any(-1)
    assert dropped.sum() >= 4
    torch.testing.assert_close(y[0][dropped], shared[dropped], rtol=0, atol=1e-6)
    want, _ = jx_moe.moe_apply(jparams, jnp.asarray(x.numpy()), jcfg)
    assert _rel(y, want) < RTOL


@pytest.mark.parametrize("seed", range(5))
def test_permutation_equivariance(seed):
    """Drop-free, the token order does not change each token's output."""
    _, cfg = _moe_cfgs(capacity_factor=16.0)
    _, params = _moe_pair(*_moe_cfgs())
    x = torch.from_numpy(_x((1, 16, cfg.d_model), seed=10 + seed))
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(16))
    with torch.no_grad():
        y, _ = moe.moe_apply(params, x, cfg)
        y_perm, _ = moe.moe_apply(params, x[:, perm], cfg)
    torch.testing.assert_close(y[:, perm], y_perm, rtol=0, atol=1e-5)


# ------------------------------------------------- the reduced granite model --
SETUPS = {"cf-1.25": {}, "cf-8": {"capacity_factor": 8.0}}


@pytest.fixture(scope="module", params=sorted(SETUPS))
def setup(request):
    return family_setup(NAME, **SETUPS[request.param])


def test_prefill_and_hidden_match(setup):
    family_prefill_and_hidden(setup)


def test_decode_steps_match_logits_and_cache(setup):
    family_decode_steps(setup)


def test_prefill_equals_sequential_decode_drop_free():
    """capacity_factor 8.0, as the reference's own equivalence test: the
    default 1.25 drops slots at prefill that decode (drop-free) keeps."""
    family_prefill_equals_sequential_decode(family_setup(NAME, capacity_factor=8.0))


def test_cache_shapes_match_the_reference():
    family_cache_shapes(NAME)


def test_bridge_round_trip_and_key_check(setup):
    family_bridge_round_trip(setup, ("blocks", "moe", "w_up_e"))


def test_init_follows_the_reference_rules():
    family_init_rule(NAME)


def test_serve_cli_on_the_cpu(capsys):
    family_serve_cli(NAME, capsys)
