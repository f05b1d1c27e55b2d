"""The port's MLA family (deepseek-v2-236b) against the reference.

Multi-head latent attention on its own (prefill through the blocked scan
with dv != dh, and the absorbed decode over the latent cache), then the
reduced deepseek model (a dense first block ``dense0`` and one MoE block
with two shared experts) through the ``family_*`` checks of
``test_torch_zoo``, with a q latent (``q_lora_rank`` 1536, the config's)
and without one (``w_q``). Weights and inputs are numpy draws carried to
both sides; f32 activations, 1e-5 of the outputs' scale.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import specs as jx_specs
from repro.models import layers as jx_layers
from repro_torch.configs import get_config
from repro_torch.launch import specs
from repro_torch.models import layers, model_zoo
from test_torch_zoo import (
    RTOL,
    _f32_caches,
    _numpy_tree,
    _rel,
    family_bridge_round_trip,
    family_cache_shapes,
    family_cfgs,
    family_decode_steps,
    family_init_rule,
    family_prefill_and_hidden,
    family_prefill_equals_sequential_decode,
    family_serve_cli,
    family_setup,
    load_module,
)

NAME = "deepseek-v2-236b"
Q_BRANCHES = {"q-lora": {}, "full-rank-q": {"q_lora_rank": 0}}


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", params=sorted(Q_BRANCHES))
def setup(request):
    return family_setup(NAME, **Q_BRANCHES[request.param])


def _mla_pair(branch, seed=1):
    jcfg, tcfg = family_cfgs(NAME, **Q_BRANCHES[branch])
    tree = _numpy_tree(
        jx_layers.init_params(jax.random.PRNGKey(0), jx_layers.mla_shapes(jcfg)), seed
    )
    return jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree), load_module(layers.MLA(tcfg), tree)


def test_layout_at_full_width():
    """Three layers (dense0 and two MoE blocks) hold the 9,330,795,520
    parameters that the reference's param_shapes() counts; a q latent gives
    w_dq / q_norm_scale / w_uq, none gives w_q."""
    cut = model_zoo.make_backbone(dataclasses.replace(get_config(NAME), num_layers=3), "meta")
    assert sum(p.numel() for p in cut.parameters()) == 9_330_795_520
    assert len(cut.blocks) == 2 and hasattr(cut, "dense0") and hasattr(cut.dense0, "ffn")
    assert cut.dense0.ffn.w_up.shape == (5120, 12288) and hasattr(cut.blocks[0], "moe")
    names = {n for n, _ in cut.dense0.attn.named_parameters()}
    assert names == {"w_dkv", "w_kr", "w_uk", "w_uv", "w_o", "kv_norm_scale", "w_dq",
                     "q_norm_scale", "w_uq"}
    _, tcfg = family_cfgs(NAME, q_lora_rank=0)
    assert {n for n, _ in layers.MLA(tcfg, "meta").named_parameters()} == {
        "w_dkv", "w_kr", "w_uk", "w_uv", "w_o", "kv_norm_scale", "w_q"
    }


@pytest.mark.parametrize("window", [None, 1, 3])
@pytest.mark.parametrize("branch", sorted(Q_BRANCHES))
def test_mla_prefill_matches_the_reference(branch, window):
    """The expanded prefill, with and without a window (MLA's prefill takes
    one; its decode does not)."""
    jcfg, tcfg, jparams, tparams = _mla_pair(branch)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(8, dtype=np.int32) + 3, (2, 8)).copy()
    want, _ = jx_layers.mla_apply(jparams, jnp.asarray(x), jcfg, jnp.asarray(pos), window=window)
    with torch.no_grad():
        got, cache = layers.mla_apply(
            tparams, torch.from_numpy(x), tcfg, torch.from_numpy(pos), window=window
        )
    assert cache is None and _rel(got, want) < RTOL


@pytest.mark.parametrize("branch", sorted(Q_BRANCHES))
def test_absorbed_decode_matches_the_reference(branch):
    """Eight absorbed steps over a 6-slot latent cache: the last two writes
    clamp to slot 5, as ``dynamic_update_slice`` clamps them; output and
    every cache leaf against the reference's."""
    jcfg, tcfg, jparams, tparams = _mla_pair(branch)
    rng = np.random.default_rng(3)
    shapes = layers.mla_cache_shapes(tcfg, 2, 6)
    jcache = _f32_caches(jx_specs.zeros_like_spec(jx_layers.mla_cache_shapes(jcfg, 2, 6)))
    tcache = _f32_caches(specs.zeros_like_spec(shapes, "cpu"))
    for t in range(8):
        x = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
        pos = np.full((2, 1), t, np.int32)
        want, jcache = jx_layers.mla_apply(
            jparams, jnp.asarray(x), jcfg, jnp.asarray(pos), cache=jcache
        )
        with torch.no_grad():
            got, tcache = layers.mla_apply(
                tparams, torch.from_numpy(x), tcfg, torch.from_numpy(pos), cache=tcache
            )
        assert _rel(got, want) < RTOL, t
    for k in ("c_kv", "k_rope"):
        assert _rel(tcache[k], jcache[k]) < RTOL, k
    np.testing.assert_array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))
    assert tcache["pos"][0].tolist() == [1, 2, 3, 4, 5, 8] and int(tcache["index"]) == 8


def test_decode_refuses_more_than_one_token():
    _, tcfg, _, tparams = _mla_pair("q-lora")
    cache = specs.zeros_like_spec(layers.mla_cache_shapes(tcfg, 2, 4), "cpu")
    with pytest.raises(ValueError, match="one token"):
        layers.mla_apply(tparams, torch.zeros(2, 2, tcfg.d_model), tcfg,
                         torch.zeros(2, 2, dtype=torch.int32), cache=cache)


def test_prefill_and_hidden_match(setup):
    family_prefill_and_hidden(setup)


def test_decode_steps_match_logits_and_cache(setup):
    """The absorbed decode through dense0 and the MoE block: logits of 8
    steps and every leaf (``dense0``'s latent cache and the stacked one)."""
    cache = family_decode_steps(setup)
    assert sorted(cache) == ["blocks", "dense0"]
    assert cache["blocks"]["c_kv"].shape == (1, 2, 8, 64)


@pytest.mark.parametrize("branch", sorted(Q_BRANCHES))
def test_prefill_equals_sequential_decode(branch):
    """At capacity factor 8 the MoE drops nothing at prefill, so the
    expanded prefill and the absorbed decode must agree."""
    family_prefill_equals_sequential_decode(
        family_setup(NAME, capacity_factor=8.0, **Q_BRANCHES[branch])
    )


@pytest.mark.parametrize("layers_", [2, 3])
def test_cache_shapes_match_the_reference(layers_):
    family_cache_shapes(NAME, num_layers=layers_)
    family_cache_shapes(NAME, window=5, num_layers=layers_)


def test_bridge_round_trip_and_key_check(setup):
    family_bridge_round_trip(setup, ("dense0", "attn", "kv_norm_scale"))
    family_bridge_round_trip(setup, ("blocks", "attn", "w_uk"))


@pytest.mark.parametrize("branch", sorted(Q_BRANCHES))
def test_init_follows_the_reference_rules(branch):
    family_init_rule(NAME, **Q_BRANCHES[branch])


def test_serve_cli_on_the_cpu(capsys):
    family_serve_cli(NAME, capsys)


def test_decode_launches_no_decode_attention_and_four_norms_a_block(monkeypatch):
    """The absorbed decode is plain torch: a step calls RMSNorm 4 times a
    block (ln1, q_norm, kv_norm, ln2) plus the final norm, and the
    decode-attention op never."""
    _, tcfg, _, tmodel, _, tparams = family_setup(NAME, num_layers=3)
    calls = {"rms": 0, "dec": 0}
    rms, dec = layers.rmsnorm_ops.rms_norm, layers.decode_ops.decode_attention

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(layers.rmsnorm_ops, "rms_norm", count("rms", rms))
    monkeypatch.setattr(layers.decode_ops, "decode_attention", count("dec", dec))
    cache = specs.zeros_like_spec(tmodel.cache_shapes(2, 4), "cpu")
    batch = {"token": torch.zeros(2, 1, dtype=torch.int32), "pos": torch.zeros(2, 1).int()}
    tmodel.decode_fn(tparams, cache, batch)
    assert calls == {"rms": 13, "dec": 0}
