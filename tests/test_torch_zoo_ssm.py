"""The port's SSM family (mamba2-370m) against the reference.

``ssd_chunked`` (against the reference, across chunk sizes, from an initial
state), ``mamba_apply`` over a full sequence and step by step, the init
rule of a lone block, and the reduced mamba2 model through the
``family_*`` checks of ``test_torch_zoo`` (once with chunks of 4, so that
the 8-token prefill crosses a chunk boundary). Inputs are numpy draws
carried to both sides; f32, 1e-5 of the outputs' scale.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.models import layers as jx_layers
from repro.models import ssm as jx_ssm
from repro_torch.configs import get_config
from repro_torch.launch import specs
from repro_torch.models import layers, ssm
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

NAME = "mamba2-370m"


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _ssd_inputs(b=2, s=32, h=4, p=8, n=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)  # softplus
    a = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return x, dt, a, bm, cm, h0


@pytest.mark.parametrize("chunk", [4, 8, 32])
@pytest.mark.parametrize("initial", [False, True])
def test_ssd_chunked_matches_the_reference(chunk, initial):
    *args, h0 = _ssd_inputs()
    init_j = jnp.asarray(h0) if initial else None
    init_t = torch.from_numpy(h0) if initial else None
    want_y, want_h = jx_ssm.ssd_chunked(*map(jnp.asarray, args), chunk, init_j)
    got_y, got_h = ssm.ssd_chunked(*map(torch.from_numpy, args), chunk, init_t)
    assert got_h.dtype == torch.float32
    assert _rel(got_y, want_y) < RTOL and _rel(got_h, want_h) < RTOL


def test_ssd_chunk_size_invariance():
    """The chunked state-passing identity: the output does not depend on
    the chunk size."""
    args = [torch.from_numpy(a) for a in _ssd_inputs(seed=1)[:-1]]
    y_ref, h_ref = ssm.ssd_chunked(*args, 32)
    for chunk in (1, 2, 4, 8, 16):
        y, h = ssm.ssd_chunked(*args, chunk)
        assert _rel(y, y_ref.numpy()) < RTOL and _rel(h, h_ref.numpy()) < RTOL, chunk


def test_ssd_matches_the_naive_recurrence():
    x, dt, a, bm, cm, _ = (torch.from_numpy(v).double() for v in _ssd_inputs(b=1, s=16, seed=2))
    y, _ = ssm.ssd_chunked(*(v.float() for v in (x, dt, a, bm, cm)), 4)
    h = torch.zeros(1, x.shape[2], x.shape[3], bm.shape[-1], dtype=torch.float64)
    want = []
    for t in range(x.shape[1]):
        da = torch.exp(dt[:, t] * a)
        h = h * da[..., None, None] + torch.einsum("bn,bhp,bh->bhpn", bm[:, t], x[:, t], dt[:, t])
        want.append(torch.einsum("bn,bhpn->bhp", cm[:, t], h))
    assert _rel(y, torch.stack(want, 1).numpy()) < RTOL


def test_ssd_refuses_a_ragged_last_chunk():
    args = [torch.from_numpy(a) for a in _ssd_inputs(s=12)[:-1]]
    with pytest.raises(AssertionError):
        ssm.ssd_chunked(*args, 8)


def test_segsum_masks_above_the_diagonal():
    x = torch.tensor([1.0, 2.0, 3.0])
    seg = ssm._segsum(x)
    assert torch.isinf(seg.triu(1)[seg.triu(1) != 0]).all() and (seg.triu(1) < 0).any()
    torch.testing.assert_close(seg.tril(), torch.tensor([[0, 0, 0], [2, 0, 0], [5, 3, 0.0]]))


def _mamba_pair(act="float32", seed=1):
    jcfg, tcfg = (
        dataclasses.replace(g(NAME).reduced(), activation_dtype=act)
        for g in (jx_get_config, get_config)
    )
    tree = _numpy_tree(jx_layers.init_params(jax.random.PRNGKey(0), jx_ssm.mamba_shapes(jcfg)), seed)
    module = load_module(ssm.Mamba(tcfg), tree)
    return jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree), module


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_mamba_apply_full_sequence_matches_the_reference(act):
    jcfg, tcfg, jparams, tparams = _mamba_pair(act)
    x = np.random.default_rng(3).standard_normal((2, 16, tcfg.d_model)).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    if act == "bfloat16":
        xj, xt = xj.astype(jnp.bfloat16), xt.bfloat16()
    want, _ = jx_ssm.mamba_apply(jparams, xj, jcfg)
    with torch.no_grad():
        got, cache = ssm.mamba_apply(tparams, xt, tcfg)
    assert cache is None and got.dtype == torch.float32 and str(want.dtype) == "float32"
    # bf16 rows: the gate's ``y.astype(x.dtype)`` may round a value one bf16
    # step (2^-8) apart on the two sides, an error the out_proj spreads
    assert _rel(got, want) < (RTOL if act == "float32" else 2.0**-8)


def test_mamba_decode_steps_match_the_reference_and_the_full_sequence():
    """Eight recurrence steps: each output and the final conv buffer and
    state against the reference's, and the outputs against the
    full-sequence (chunked SSD) branch."""
    jcfg, tcfg, jparams, tparams = _mamba_pair()
    b, s = 2, 8
    x = np.random.default_rng(4).standard_normal((b, s, tcfg.d_model)).astype(np.float32)
    jcache = jax.tree_util.tree_map(
        lambda sp: jnp.zeros(sp.shape, sp.dtype), jx_ssm.mamba_cache_shapes(jcfg, b)
    )
    tcache = specs.zeros_like_spec(ssm.mamba_cache_shapes(tcfg, b), "cpu")
    steps = []
    for t in range(s):
        want, jcache = jx_ssm.mamba_apply(jparams, jnp.asarray(x[:, t : t + 1]), jcfg, jcache)
        with torch.no_grad():
            got, back = ssm.mamba_apply(tparams, torch.from_numpy(x[:, t : t + 1]), tcfg, tcache)
        assert back is tcache and _rel(got, want) < RTOL, t
        steps.append(got)
    for k in ("conv", "ssm"):
        assert tcache[k].dtype == torch.float32 and _rel(tcache[k], jcache[k]) < RTOL
    with torch.no_grad():
        full, _ = ssm.mamba_apply(tparams, torch.from_numpy(x), tcfg)
    assert _rel(torch.cat(steps, 1), full.numpy()) < 2e-5


def test_mamba_cache_shapes_match_the_reference():
    jcfg, tcfg = jx_get_config(NAME), get_config(NAME)
    for b in (1, 4):
        mine, ref = ssm.mamba_cache_shapes(tcfg, b), jx_ssm.mamba_cache_shapes(jcfg, b)
        assert sorted(mine) == sorted(ref)
        for k in ref:
            assert mine[k].shape == ref[k].shape and str(mine[k].dtype).endswith(str(ref[k].dtype))
    assert ssm.mamba_cache_shapes(tcfg, 4)["ssm"].shape == (4, 32, 64, 128)  # H, P, N


def test_lone_block_init_is_the_reference_linspace():
    """A lone block's ``A_log`` is 1-D in the reference too: log(linspace(1,
    16, H)) (within an f32 ulp of log 16); ``dt_bias`` and ``conv_bias`` 0,
    the gate norm's scale 1, ``D`` drawn."""
    jcfg, tcfg = jx_get_config(NAME).reduced(), get_config(NAME).reduced()
    ref = jx_layers.init_params(jax.random.PRNGKey(0), jx_ssm.mamba_shapes(jcfg))
    mine = layers.init_params(ssm.Mamba(tcfg), torch.Generator().manual_seed(0)).requires_grad_(False)
    np.testing.assert_allclose(mine.A_log.detach().numpy(), np.asarray(ref["A_log"]), atol=1e-6)
    assert float(mine.A_log[0]) == 0.0 and abs(float(mine.A_log[-1]) - np.log(16.0)) < 1e-6
    for name in ("dt_bias", "conv_bias"):
        assert not getattr(mine, name).any() and not np.asarray(ref[name]).any()
    assert (mine.gate_norm_scale == 1).all()
    assert mine.D.abs().max() > 0 and mine.D.abs().max() < 0.2


# ------------------------------------------------- the reduced mamba2 model --
SETUPS = {"chunk-32": {}, "chunk-4": {"chunk": 4}}


@pytest.fixture(scope="module", params=sorted(SETUPS))
def setup(request):
    return family_setup(NAME, **SETUPS[request.param])


def test_prefill_and_hidden_match(setup):
    family_prefill_and_hidden(setup)


def test_decode_steps_match_logits_and_cache(setup):
    family_decode_steps(setup)


def test_prefill_equals_sequential_decode(setup):
    family_prefill_equals_sequential_decode(setup)


def test_cache_shapes_match_the_reference():
    family_cache_shapes(NAME)


def test_bridge_round_trip_and_key_check(setup):
    family_bridge_round_trip(setup, ("blocks", "mamba", "A_log"))


def test_init_follows_the_reference_rules():
    """A built model stacks its blocks: ``A_log`` 0, as the reference's init gives it."""
    family_init_rule(NAME)


def test_decode_ignores_the_position():
    """The attention-free stack reads no position: any ``pos`` gives the same logits."""
    _, tcfg, _, tmodel, _, tparams = family_setup(NAME)
    tok = torch.ones(2, 1, dtype=torch.int32)
    outs = []
    for p in (0, 5):
        cache = specs.zeros_like_spec(tmodel.cache_shapes(2, 4), "cpu")
        pos = torch.full((2, 1), p, dtype=torch.int32)
        outs.append(tmodel.decode_fn(tparams, cache, {"token": tok, "pos": pos})[0])
    assert torch.equal(outs[0], outs[1])


def test_serve_cli_on_the_cpu(capsys):
    family_serve_cli(NAME, capsys)
