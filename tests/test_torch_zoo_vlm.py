"""The port's vlm family (qwen2-vl-72b) against the reference.

Qwen2-VL rotates q and k by M-RoPE: the head's frequencies split into
temporal, height and width sections, each turned by its own position
stream. A batch's patch ``embeds`` go before its text, on a (t = 0, h, w)
grid; text positions are t = h = w. ``apply_mrope`` and ``_positions3_for``
on their own, then the reduced model (qkv biases, an 8-row patch prefix)
with one kv head a query head and with G = 2 through the ``family_*``
checks of ``test_torch_zoo``. Numpy draws carried to both sides; f32
activations, 1e-5 of the outputs' scale.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jx_layers
from repro.models import model_zoo as jx_zoo
from repro_torch.configs import get_config
from repro_torch.models import layers, model_zoo
from test_torch_zoo import (
    B,
    RTOL,
    S,
    _rel,
    _tokens,
    family_bridge_round_trip,
    family_cache_shapes,
    family_cfgs,
    family_decode_steps,
    family_init_rule,
    family_prefill_and_hidden,
    family_prefill_equals_sequential_decode,
    family_serve_cli,
    family_setup,
)

NAME = "qwen2-vl-72b"
SETUPS = {"reduced": {}, "G-2": {"num_kv_heads": 2}}
PREFIX = 8  # the reduced config's patch rows


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", params=sorted(SETUPS))
def setup(request):
    return family_setup(NAME, **SETUPS[request.param])


def _embeds(cfg, seed=11, rows=PREFIX):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, rows, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("prefix", [0, 1, 8, 9])
def test_positions3_match_the_reference(prefix):
    """The patch grid (side floor(sqrt(prefix))) then text, and the
    reference's per-sequence offset applied to the port's streams."""
    jcfg, _ = family_cfgs(NAME)
    offset = np.array([0, 5], np.int32)
    for off in (None, offset):
        want = jx_zoo._positions3_for(jcfg, 2, prefix, 14, None if off is None else jnp.asarray(off))
        got = model_zoo._positions3_for(2, prefix, 14)
        if off is not None:
            got = got + torch.from_numpy(off)[None, :, None]
        assert got.dtype == torch.int32 and got.shape == (3, 2, 14)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dh", [64, 128, 10])
def test_apply_mrope_matches_the_reference(dh):
    """Sections (1, 1, 2) of dh/2, the last taking the rest (dh 10: 1, 1, 3)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 16, 4, dh)).astype(np.float32)
    pos3 = np.asarray(jx_zoo._positions3_for(None, B, PREFIX, 16, None)) + 7
    want = jx_layers.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e6)
    got = layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3.copy()), 1e6)
    assert _rel(got, want) < RTOL
    # text positions on all three streams rotate as plain RoPE does
    text = np.broadcast_to(np.arange(16, dtype=np.int32), (3, B, 16)).copy()
    plain = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(text[0]), 1e6)
    assert torch.allclose(layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(text), 1e6), plain)


def test_prefill_and_hidden_with_patch_embeds_match(setup):
    family_prefill_and_hidden(setup, extra={"embeds": _embeds(setup[1])})


def test_prefill_and_hidden_of_text_only_match(setup):
    family_prefill_and_hidden(setup)


def test_patch_embeds_move_the_text_logits(setup):
    """The prefix reaches the text: the same tokens with other patch rows
    give other logits, and the hidden states hold prefix + text rows."""
    _, tcfg, _, tmodel, _, tparams = setup
    toks = torch.from_numpy(_tokens(tcfg))
    a, b = (torch.from_numpy(_embeds(tcfg, seed)) for seed in (1, 2))
    with torch.no_grad():
        h = tmodel.hidden_fn(tparams, {"tokens": toks, "embeds": a})
    assert h.shape == (B, PREFIX + S, tcfg.d_model)
    la = tmodel.prefill_fn(tparams, {"tokens": toks, "embeds": a})
    lb = tmodel.prefill_fn(tparams, {"tokens": toks, "embeds": b})
    assert _rel(la, lb.numpy()) > 1e-3


def test_decode_steps_match_logits_and_cache(setup):
    """Decode broadcasts ``pos`` to the three streams, as the reference does."""
    family_decode_steps(setup)


def test_prefill_equals_sequential_decode(setup):
    family_prefill_equals_sequential_decode(setup)


@pytest.mark.parametrize("layers_", [2, 80])
def test_cache_shapes_match_the_reference(layers_):
    family_cache_shapes(NAME, num_layers=layers_)


def test_layout_at_full_width():
    """Four of the 80 layers: 6,002,163,712 parameters, as the reference's
    param_shapes() counts them, with the q / k / v biases."""
    cut = model_zoo.make_backbone(dataclasses.replace(get_config(NAME), num_layers=4), "meta")
    assert sum(p.numel() for p in cut.parameters()) == 6_002_163_712
    attn = cut.blocks[0].attn
    assert attn.b_q.shape == (8192,) and attn.b_k.shape == (1024,) and attn.b_v.shape == (1024,)


def test_bridge_round_trip_and_key_check(setup):
    family_bridge_round_trip(setup, ("blocks", "attn", "b_k"))


def test_init_follows_the_reference_rules():
    """``b_q`` / ``b_k`` / ``b_v`` are drawn N(0, 0.02²), as the
    reference's name rule gives them (no ``bias`` in their names)."""
    family_init_rule(NAME)


def test_serve_cli_on_the_cpu(capsys):
    family_serve_cli(NAME, capsys)
