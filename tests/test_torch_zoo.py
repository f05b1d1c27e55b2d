"""The port's dense model zoo and its serving path against the reference.

Reduced phi4-mini with two kv heads (G = 2: ``reduced()`` alone gives
kv heads = heads) and reduced gemma-7b (MHA, GeGLU, the √d embedding
scale, head_dim 64). Weights are drawn with numpy into the reference's
pytree and carried into the port by ``bridge.zoo_params_from_reference``;
tokens are numpy draws. With ``activation_dtype="float32"`` both sides run
the same f32 arithmetic in different orders: 1e-5 of the outputs' scale.

The ``family_*`` helpers at the end hold any family's reduced model to the
reference the same way; ``test_torch_zoo_{moe,ssm,hybrid,mla,vlm,audio,window}.py``
call them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_configs as jx_all_configs
from repro.configs import get_config as jx_get_config
from repro.launch import serve as jx_serve
from repro.launch import specs as jx_specs
from repro.models import layers as jx_layers
from repro.models import model_zoo as jx_zoo
from repro.models.zoo_extractor import make_zoo_extractor as jx_make_zoo_extractor
from repro_torch import bridge
from repro_torch.configs import INPUT_SHAPES, all_configs, get_config
from repro_torch.launch import serve, specs
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import layers, model_zoo
from repro_torch.models.zoo_extractor import make_zoo_extractor

RTOL = 1e-5  # f32 policy, relative to the outputs' largest magnitude
# The default policy (bf16 residual stream, bf16 tied unembed): the two sides
# round to bf16 at the same points, but a value near a rounding boundary may
# land one bf16 step (2^-8 relative) apart and carry through the layers.
# Measured ~1e-2 of the logits' scale; 3e-2 is about eight bf16 steps.
BF16_RTOL = 3e-2
ARCHS = {"phi4": ("phi4-mini-3.8b", 2), "gemma": ("gemma-7b", None)}
B, S = 2, 8


def _cfgs(arch, act="float32"):
    name, kv = ARCHS[arch]
    out = []
    for get in (jx_get_config, get_config):
        cfg = dataclasses.replace(get(name).reduced(), activation_dtype=act)
        out.append(dataclasses.replace(cfg, num_kv_heads=kv) if kv else cfg)
    return out


def _numpy_tree(tree, seed, std=0.05):
    """Every leaf redrawn with numpy: scales 1 + 0.1·N, the rest std·N."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        a = rng.standard_normal(leaf.shape).astype(np.float32)
        return 1.0 + 0.1 * a if "scale" in str(path[-1]) else std * a

    return jax.tree_util.tree_map_with_path(draw, tree)


def _setup(arch, act="float32"):
    jcfg, tcfg = _cfgs(arch, act)
    jmodel, tmodel = jx_zoo.build_model(jcfg), model_zoo.build_model(tcfg)
    tree = _numpy_tree(jmodel.init(jax.random.PRNGKey(0)), seed=1)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tparams = bridge.zoo_params_from_reference(tree, tcfg, device="cpu")
    return jcfg, tcfg, jmodel, tmodel, jparams, tparams


def _tokens(cfg, seed=2, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _rel(got, want):
    want = np.asarray(want).astype(np.float32)
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _f32_caches(tree):
    if isinstance(tree, dict):
        return {k: _f32_caches(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.float() if tree.dtype == torch.bfloat16 else tree
    return tree.astype(jnp.float32) if tree.dtype == jnp.bfloat16 else tree


def test_configs_equal_the_reference():
    mine, ref = all_configs(), jx_all_configs()
    assert sorted(mine) == sorted(ref) and len(mine) == 10
    for name in ref:
        assert dataclasses.asdict(mine[name]) == dataclasses.asdict(ref[name])
        assert dataclasses.asdict(mine[name].reduced()) == dataclasses.asdict(ref[name].reduced())


@pytest.mark.parametrize("shape", sorted(INPUT_SHAPES))
def test_input_specs_match_the_reference(shape):
    for name in ("phi4-mini-3.8b", "qwen2-vl-72b"):
        cfg, jcfg, s = get_config(name), jx_get_config(name), INPUT_SHAPES[shape]
        for mine, ref in (
            (specs.prefill_specs(cfg, s), jx_specs.prefill_specs(jcfg, s)),
            (specs.decode_specs(cfg, s), jx_specs.decode_specs(jcfg, s)),
        ):
            assert sorted(mine) == sorted(ref)
            for k in ref:
                assert mine[k].shape == ref[k].shape
                assert str(mine[k].dtype).split(".")[-1] == str(ref[k].dtype)


@pytest.mark.parametrize("name", ["gemma-7b", "phi4-mini-3.8b", "qwen1.5-32b", "llama3-405b"])
def test_cache_shapes_match_the_reference(name):
    family_cache_shapes(name)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_bridge_round_trip_and_key_check(arch):
    family_bridge_round_trip(_setup(arch), ("final_ln_scale",))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_rope_and_ffn_match(arch):
    jcfg, tcfg, *_, jparams, tparams = _setup(arch)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, S, 4, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32) + 5, (B, S))
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()), tcfg.rope_theta)
    want = jx_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), jcfg.rope_theta)
    assert _rel(got, want) < RTOL
    h = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    ffn = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"]["ffn"])
    got = layers.ffn_apply(tparams.blocks[0].ffn, torch.from_numpy(h), tcfg)
    want = jx_layers.ffn_apply(ffn, jnp.asarray(h), jcfg)
    assert _rel(got.detach(), want) < RTOL


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_one_block_matches(arch):
    jcfg, tcfg, *_, jparams, tparams = _setup(arch)
    x = np.random.default_rng(4).standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    block = jax.tree_util.tree_map(lambda a: a[1], jparams["blocks"])
    want, _, _ = jx_zoo._dense_block_apply(
        block, jnp.asarray(x), jcfg, jnp.asarray(pos), None, None, None, use_moe=False
    )
    with torch.no_grad():
        got = model_zoo._dense_block_apply(
            tparams.blocks[1], torch.from_numpy(x), tcfg, torch.from_numpy(pos.copy()), None
        )
    assert _rel(got, want) < RTOL


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_and_hidden_match(arch):
    family_prefill_and_hidden(_setup(arch))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_eight_decode_steps_match_logits_and_cache(arch):
    family_decode_steps(_setup(arch), seed=2)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_decode_positions_behind_slots_match_reference(arch):
    """Positions t // 2 at slot t: the reference's mask over the stored
    positions keeps every written slot, where a prefix of min(index, pos) + 1
    slots would drop half of them."""
    _, tcfg, jmodel, tmodel, jparams, tparams = _setup(arch)
    toks = _tokens(tcfg, seed=4)
    jcache = _f32_caches(jx_specs.zeros_like_spec(jmodel.cache_shapes(B, S)))
    tcache = _f32_caches(specs.zeros_like_spec(tmodel.cache_shapes(B, S), "cpu"))
    jdecode = jax.jit(jmodel.decode_fn)
    for t in range(S):
        batch = {"token": toks[:, t : t + 1], "pos": np.full((B, 1), t // 2, np.int32)}
        want, jcache = jdecode(jparams, jcache, jax.tree_util.tree_map(jnp.asarray, batch))
        got, tcache = tmodel.decode_fn(
            tparams, tcache, {k: torch.from_numpy(v) for k, v in batch.items()}
        )
        assert _rel(got, want) < RTOL, t
    np.testing.assert_array_equal(
        tcache["blocks"]["pos"].numpy(), np.asarray(jcache["blocks"]["pos"])
    )


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_decode_positions_decreasing_along_slots_match_reference(arch):
    """Position S - 1 - t at slot t: the valid slots are a suffix of the
    written ones, never a prefix, so only a mask over each slot's own stored
    position agrees with the reference."""
    _, tcfg, jmodel, tmodel, jparams, tparams = _setup(arch)
    toks = _tokens(tcfg, seed=8)
    jcache = _f32_caches(jx_specs.zeros_like_spec(jmodel.cache_shapes(B, S)))
    tcache = _f32_caches(specs.zeros_like_spec(tmodel.cache_shapes(B, S), "cpu"))
    jdecode = jax.jit(jmodel.decode_fn)
    for t in range(S):
        batch = {"token": toks[:, t : t + 1], "pos": np.full((B, 1), S - 1 - t, np.int32)}
        want, jcache = jdecode(jparams, jcache, jax.tree_util.tree_map(jnp.asarray, batch))
        got, tcache = tmodel.decode_fn(
            tparams, tcache, {k: torch.from_numpy(v) for k, v in batch.items()}
        )
        assert _rel(got, want) < RTOL, t
    np.testing.assert_array_equal(
        tcache["blocks"]["pos"].numpy(), np.asarray(jcache["blocks"]["pos"])
    )


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_equals_sequential_decode(arch):
    """The port against itself: the blocked-scan prefill and the decode
    path (the decode-attention op over the cache) give the same logits."""
    family_prefill_equals_sequential_decode(_setup(arch))


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_greedy_tokens_equal_the_reference_serve(act):
    """serve.prefill + greedy_decode, 8 prompt and 8 generated tokens. The
    weights are drawn wide (std 0.3) so the greedy tokens vary."""
    jcfg, tcfg = _cfgs("phi4", act)
    jmodel, tmodel = jx_zoo.build_model(jcfg), model_zoo.build_model(tcfg)
    tree = _numpy_tree(jmodel.init(jax.random.PRNGKey(0)), seed=6, std=0.3)
    tparams = bridge.zoo_params_from_reference(tree, tcfg, device="cpu")
    prompt = _tokens(tcfg, seed=7)
    jcache = jx_specs.zeros_like_spec(jmodel.cache_shapes(B, 2 * S))
    jdecode = jx_serve.make_serving_decode(jmodel)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    logits, jcache = jx_serve.prefill(jdecode, jparams, jcache, jnp.asarray(prompt))
    want, _ = jx_serve.greedy_decode(jdecode, jparams, jcache, logits, S, S)

    rec = serve.LatencyRecorder()
    tcache = specs.zeros_like_spec(tmodel.cache_shapes(B, 2 * S), "cpu")
    tdecode = tmodel.decode_fn
    logits, tcache = serve.prefill(tdecode, tparams, tcache, torch.from_numpy(prompt), rec)
    got, tcache = serve.greedy_decode(tdecode, tparams, tcache, logits, S, S, rec)
    assert got.dtype == torch.int32 and got.shape == (B, S)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(set(got.flatten().tolist())) > 2
    assert rec.summary()["batches"] == 2 * S and rec.rows == 2 * S * B
    assert int(tcache["blocks"]["index"][0]) == 2 * S


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_default_bf16_policy_within_tolerance(arch):
    _, tcfg, jmodel, tmodel, jparams, tparams = _setup(arch, act="bfloat16")
    toks = _tokens(tcfg)
    want = jmodel.prefill_fn(jparams, {"tokens": jnp.asarray(toks)})
    got = tmodel.prefill_fn(tparams, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    assert _rel(got, want) < BF16_RTOL
    jcache = jx_specs.zeros_like_spec(jmodel.cache_shapes(B, S))
    tcache = specs.zeros_like_spec(tmodel.cache_shapes(B, S), "cpu")
    assert tcache["blocks"]["k"].dtype == torch.bfloat16
    jdecode = jax.jit(jmodel.decode_fn)
    for t in range(S):
        batch = {"token": toks[:, t : t + 1], "pos": np.full((B, 1), t, np.int32)}
        want, jcache = jdecode(jparams, jcache, jax.tree_util.tree_map(jnp.asarray, batch))
        got, tcache = tmodel.decode_fn(
            tparams, tcache, {k: torch.from_numpy(v) for k, v in batch.items()}
        )
        assert _rel(got, want) < BF16_RTOL, t


def test_zoo_extractor_matches_the_reference():
    jcfg, tcfg = _cfgs("phi4")
    x = _tokens(tcfg, seed=8, shape=(5, 6))
    jext = jx_make_zoo_extractor(jcfg, rep_dim=16)
    jparams = jext.init(jax.random.PRNGKey(3), jnp.asarray(x))
    tree = _numpy_tree(jparams, seed=9)
    ext = bridge.zoo_params_from_reference(tree, tcfg, device="cpu")
    assert ext.rep_dim == 16
    want = jext.apply(jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x))
    got = ext(torch.from_numpy(x))
    assert got.shape == (5, 16) and _rel(got.detach(), want) < RTOL
    fresh = make_zoo_extractor(tcfg, rep_dim=16, device="cpu").init_(
        torch.Generator().manual_seed(0)
    )
    assert float(fresh.backbone.blocks[0].ln1_scale.detach().min()) == 1.0
    assert fresh(torch.from_numpy(x)).shape == (5, 16)


def test_serve_cli_on_the_cpu(capsys):
    argv = ["--arch", "phi4-mini-3.8b", "--reduce", "--batch", "2", "--prompt-len", "4"]
    assert serve.main(argv + ["--gen", "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "arch=phi4-mini-3.8b on cpu generated (2, 3)" in out and "sample:" in out


def test_serve_cli_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card error cannot show")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "phi4-mini-3.8b", "--reduce"])


# ------------------------------------------------- any family's reduced model --
def family_cfgs(name, act="float32", **changes):
    """The reference's and the port's reduced config of ``name``, with
    ``changes`` (e.g. ``capacity_factor``, ``chunk``, ``q_lora_rank``,
    ``num_layers``) applied to both; the MoE, SSM and MLA sub-configs take
    theirs by field name."""
    out = []
    for get in (jx_get_config, get_config):
        cfg = dataclasses.replace(get(name).reduced(), activation_dtype=act)
        top = {k: v for k, v in changes.items() if hasattr(cfg, k)}
        for sub in ("moe", "ssm", "mla"):
            part = getattr(cfg, sub)
            mine = {k: v for k, v in changes.items() if part is not None and hasattr(part, k)}
            if mine:
                top[sub] = dataclasses.replace(part, **mine)
        out.append(dataclasses.replace(cfg, **top))
    return out


def load_module(module, tree):
    """A reference sub-tree (one block's ``moe`` or ``mamba``) into a port
    module, leaf by leaf; the names must match."""
    leaves = bridge._flat(tree)
    names = dict(module.named_parameters())
    assert sorted(names) == sorted(".".join(k) for k in leaves)
    with torch.no_grad():
        for path, value in leaves.items():
            names[".".join(path)].copy_(torch.from_numpy(np.asarray(value)))
    return module


def family_setup(name, act="float32", seed=1, window=None, **changes):
    """(jcfg, tcfg, jmodel, tmodel, jparams, tparams): the reference's
    pytree redrawn with numpy and carried into the port; ``window`` is both
    models' ``window_override``."""
    jcfg, tcfg = family_cfgs(name, act, **changes)
    jmodel = jx_zoo.build_model(jcfg, window_override=window)
    tmodel = model_zoo.build_model(tcfg, window_override=window)
    tree = _numpy_tree(jmodel.init(jax.random.PRNGKey(0)), seed=seed)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tparams = bridge.zoo_params_from_reference(tree, tcfg, device="cpu")
    return jcfg, tcfg, jmodel, tmodel, jparams, tparams


def _leaves(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def family_prefill_and_hidden(setup, extra=None):
    """``prefill_fn`` and ``hidden_fn`` against the reference's; ``extra``:
    numpy arrays added to the batch (a vlm's or an audio model's
    ``embeds``)."""
    _, tcfg, jmodel, tmodel, jparams, tparams = setup
    toks = _tokens(tcfg, shape=(B, S))
    arrays = {"tokens": toks, **(extra or {})}
    jbatch = {k: jnp.asarray(v) for k, v in arrays.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in arrays.items()}
    want = jmodel.prefill_fn(jparams, jbatch)
    got = make_prefill_step(tmodel)(tparams, tbatch)
    assert got.shape == (B, tcfg.vocab_size) and _rel(got, want) < RTOL
    want_h = jmodel.hidden_fn(jparams, jbatch)
    with torch.no_grad():
        got_h = tmodel.hidden_fn(tparams, tbatch)
    assert _rel(got_h, want_h) < RTOL


def _set_leaves(jcache, tcache, leaves):
    """Put ``leaves`` {name: (numpy array, dtype name)} into both caches."""
    for name, (a, dtype) in (leaves or {}).items():
        jcache[name] = jnp.asarray(a).astype(dtype)
        tcache[name] = torch.from_numpy(np.array(a)).to(getattr(torch, dtype))


def family_decode_steps(setup, seed=3, steps=S, cache_len=None, leaves=None):
    """``steps`` decode steps' logits, then every leaf of the cache, against
    the reference's decode with the f32-cast cache (of ``cache_len`` slots,
    ``steps`` by default; ``leaves`` put in after the cast, e.g. an audio
    model's ``enc_out``): floats within RTOL of their scale, positions and
    write indices equal."""
    _, tcfg, jmodel, tmodel, jparams, tparams = setup
    b, s = B, steps
    toks = _tokens(tcfg, seed=seed, shape=(b, s))
    jcache = _f32_caches(jx_specs.zeros_like_spec(jmodel.cache_shapes(b, cache_len or s)))
    tcache = _f32_caches(specs.zeros_like_spec(tmodel.cache_shapes(b, cache_len or s), "cpu"))
    _set_leaves(jcache, tcache, leaves)
    jdecode = jax.jit(jmodel.decode_fn)
    for t in range(s):
        batch = {"token": toks[:, t : t + 1], "pos": np.full((b, 1), t, np.int32)}
        want, jcache = jdecode(jparams, jcache, jax.tree_util.tree_map(jnp.asarray, batch))
        got, tcache = tmodel.decode_fn(
            tparams, tcache, {k: torch.from_numpy(v) for k, v in batch.items()}
        )
        assert _rel(got, want) < RTOL, t
    mine, ref = _leaves(tcache), _leaves(jcache)
    assert sorted(mine) == sorted(ref)
    for path, want in ref.items():
        if np.issubdtype(np.asarray(want).dtype, np.integer):
            np.testing.assert_array_equal(mine[path].numpy(), np.asarray(want))
        else:
            assert mine[path].dtype == getattr(torch, str(want.dtype)), path
            assert _rel(mine[path], want) < RTOL, path
    return tcache


def family_prefill_equals_sequential_decode(setup, seed=5, steps=S, cache_len=None, fill=None):
    """The port against itself in f32 with the f32-cast cache (of
    ``cache_len`` slots, ``steps`` by default): the full-sequence forward
    over ``steps`` tokens and the decode path give the same last logits.
    ``fill(tmodel, tparams, cache)`` returns the prefill's extra batch
    entries after filling what the decode reads from the cache (an audio
    model's ``enc_out``)."""
    _, tcfg, _, tmodel, _, tparams = setup
    toks = torch.from_numpy(_tokens(tcfg, seed=seed, shape=(B, steps)))
    cache = _f32_caches(specs.zeros_like_spec(tmodel.cache_shapes(B, cache_len or steps), "cpu"))
    extra = fill(tmodel, tparams, cache) if fill else {}
    full = tmodel.prefill_fn(tparams, {"tokens": toks, **extra})
    logits, _ = serve.prefill(tmodel.decode_fn, tparams, cache, toks)
    assert _rel(logits, full.numpy()) < 2e-5


def family_cache_shapes(name, window=None, **changes):
    """The decode cache's spec tree equals the reference's, leaf for leaf."""
    jcfg, tcfg = family_cfgs(name, "bfloat16", **changes)
    for batch, cache_len in ((3, 11), (4, 48)):
        mine = _leaves(model_zoo.build_model(tcfg, window).cache_shapes(batch, cache_len))
        ref = _leaves(jx_zoo.build_model(jcfg, window).cache_shapes(batch, cache_len))
        assert sorted(mine) == sorted(ref)
        for path, want in ref.items():
            assert mine[path].shape == want.shape, path
            assert str(mine[path].dtype).split(".")[-1] == str(want.dtype), path


def family_bridge_round_trip(setup, drop):
    """Port → reference tree gives back the reference's leaves bit for bit;
    a tree that lacks ``drop`` or has an extra key is refused."""
    *_, jparams, tparams = setup
    tcfg = setup[1]
    back = bridge.zoo_params_to_reference(tparams)
    flat_ref = jax.tree_util.tree_leaves_with_path(jparams)
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_ref] == [p for p, _ in flat_back]
    for (_, a), (_, b) in zip(flat_ref, flat_back):
        np.testing.assert_array_equal(np.asarray(a), b)
    missing = jax.tree_util.tree_map(lambda a: a, back)
    node = missing
    for k in drop[:-1]:
        node = node[k]
    node.pop(drop[-1])
    with pytest.raises(ValueError, match="missing"):
        bridge.zoo_params_from_reference(missing, tcfg, device="cpu")
    extra = dict(back, stray=np.zeros(1, np.float32))
    with pytest.raises(ValueError, match="unexpected"):
        bridge.zoo_params_from_reference(extra, tcfg, device="cpu")
    again = bridge.zoo_params_to_reference(
        bridge.zoo_params_from_reference(back, tcfg, device="cpu")
    )
    for (_, a), (_, b) in zip(flat_back, jax.tree_util.tree_leaves_with_path(again)):
        np.testing.assert_array_equal(a, b)


def family_init_rule(name, **changes):
    """A built model's init by the reference's name rules: ``A_log`` 0 on
    every stacked block (as the reference's init gives it), ``dt_bias`` and
    ``conv_bias`` 0, scales 1, ``D``, the weights and ``b_q`` / ``b_k`` /
    ``b_v`` (no ``bias`` in their names) N(0, 0.02²)."""
    jcfg, tcfg = family_cfgs(name, "bfloat16", **changes)
    ref = _leaves(jx_zoo.build_model(jcfg).init(jax.random.PRNGKey(0)))
    mine = _leaves(bridge.zoo_params_to_reference(
        model_zoo.build_model(tcfg).init(torch.Generator().manual_seed(0))
    ))
    assert sorted(mine) == sorted(ref)
    for path, want in ref.items():
        got, want = mine[path], np.asarray(want)
        assert got.shape == want.shape, path
        leaf = path[-1]
        if "scale" in leaf or "bias" in leaf or "A_log" in leaf:
            np.testing.assert_array_equal(got, want)  # constants: 1 or 0
            assert (got == (1.0 if "scale" in leaf else 0.0)).all(), path
        else:  # drawn: both N(0, 0.02²); a leaf of a few values only within 10 σ
            for a in (got, want):
                if a.size >= 1000:
                    assert abs(a.std() - 0.02) < 0.2 * 0.02 and abs(a.mean()) < 0.01, path
                else:
                    assert 0 < np.abs(a).max() < 0.2, path


def family_serve_cli(name, capsys):
    argv = ["--arch", name, "--reduce", "--batch", "2", "--prompt-len", "4", "--gen", "3"]
    assert serve.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"arch={name} on cpu generated (2, 3)" in out and "sample:" in out
