"""The port's audio encoder-decoder (seamless-m4t-large-v2) against the reference.

The encoder runs bidirectional blocks over the batch's frame ``embeds``
(sinusoidal positions added); the decoder's blocks attend causally over
the text (a KV cache at decode) and cross-attend to the encoder's output,
which decode reads from the cache (``enc_out``, bf16 in the reference's
tree). ``_sinusoidal_pos`` and ``_encode`` on their own, then the reduced
model through the ``family_*`` checks of ``test_torch_zoo``, decode with a
bf16 and with an f32 ``enc_out``. Numpy draws carried to both sides; f32
activations, 1e-5 of the outputs' scale.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model_zoo as jx_zoo
from repro_torch.configs import get_config
from repro_torch.models import model_zoo
from repro_torch.models.zoo_extractor import make_zoo_extractor
from test_torch_zoo import (
    B,
    RTOL,
    _rel,
    family_bridge_round_trip,
    family_cache_shapes,
    family_decode_steps,
    family_init_rule,
    family_prefill_and_hidden,
    family_prefill_equals_sequential_decode,
    family_serve_cli,
    family_setup,
)

NAME = "seamless-m4t-large-v2"
FRAMES = 8  # the reduced config's prefix_tokens


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def setup():
    return family_setup(NAME)


def _frames(cfg, seed=12):
    rng = np.random.default_rng(seed)
    return (0.5 * rng.standard_normal((B, FRAMES, cfg.d_model))).astype(np.float32)


@pytest.mark.parametrize("d", [1, 2, 3, 64, 255, 1024])
def test_sinusoidal_pos_matches_the_reference(d):
    """sin then cos over d // 2 frequencies; an odd d gets a zero column."""
    pos = np.arange(0, 1022, 7, dtype=np.int32).reshape(2, -1)
    want = np.asarray(jx_zoo._sinusoidal_pos(jnp.asarray(pos), d))
    got = model_zoo._sinusoidal_pos(torch.from_numpy(pos), d)
    assert got.shape == want.shape == pos.shape + (d,)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    if d % 2:
        assert (got[..., -1] == 0).all()


def test_encode_matches_the_reference(setup):
    jcfg, tcfg, _, _, jparams, tparams = setup
    x = _frames(tcfg)
    want = jx_zoo._encode(jparams, jcfg, jnp.asarray(x))
    with torch.no_grad():
        got = model_zoo._encode(tparams, tcfg, torch.from_numpy(x))
    assert got.shape == (B, FRAMES, tcfg.d_model) and _rel(got, want) < RTOL


def test_encoder_is_bidirectional(setup):
    """A change to the last frame moves the first frame's output."""
    _, tcfg, _, _, _, tparams = setup
    x = torch.from_numpy(_frames(tcfg))
    y = x.clone()
    y[:, -1] += 1.0
    with torch.no_grad():
        a, b = (model_zoo._encode(tparams, tcfg, t) for t in (x, y))
    assert (a[:, 0] - b[:, 0]).abs().max() > 1e-4


def test_prefill_and_hidden_match(setup):
    family_prefill_and_hidden(setup, extra={"embeds": _frames(setup[1])})


@pytest.mark.parametrize("enc_dtype", ["bfloat16", "float32"])
def test_decode_steps_match_logits_and_cache(setup, enc_dtype):
    """Eight steps against ``enc_out`` held in the cache as bf16 (the
    reference's tree) or f32; decode leaves it as it is."""
    enc = np.array(jx_zoo._encode(setup[4], setup[0], jnp.asarray(_frames(setup[1]))))
    cache = family_decode_steps(setup, leaves={"enc_out": (enc, enc_dtype)})
    assert cache["enc_out"].dtype == getattr(torch, enc_dtype)
    want = torch.from_numpy(enc).to(getattr(torch, enc_dtype))
    assert torch.equal(cache["enc_out"], want)


def test_prefill_equals_sequential_decode(setup):
    """Prefill encodes the frames; decode reads the same encoding (f32)
    from the cache."""

    def fill(tmodel, tparams, cache):
        frames = torch.from_numpy(_frames(setup[1]))
        with torch.no_grad():
            cache["enc_out"] = model_zoo._encode(tparams, setup[1], frames)
        return {"embeds": frames}

    family_prefill_equals_sequential_decode(setup, fill=fill)


@pytest.mark.parametrize("layers_", [2, 24])
def test_cache_shapes_match_the_reference(layers_):
    family_cache_shapes(NAME, num_layers=layers_)


def test_layout_at_full_width():
    """24 encoder and 24 decoder layers: 1,632,131,072 parameters, as the
    reference's param_shapes() counts them."""
    full = model_zoo.make_backbone(get_config(NAME), "meta")
    assert len(full.enc_blocks) == len(full.dec_blocks) == 24
    assert sum(p.numel() for p in full.parameters()) == 1_632_131_072
    assert {n for n, _ in full.dec_blocks[0].named_children()} == {
        "self_attn", "cross_attn", "ffn"
    }


def test_bridge_round_trip_and_key_check(setup):
    family_bridge_round_trip(setup, ("dec_blocks", "cross_attn", "w_k"))
    family_bridge_round_trip(setup, ("enc_final_ln_scale",))


def test_init_follows_the_reference_rules():
    family_init_rule(NAME)


def test_serve_cli_on_the_cpu(capsys):
    """The CLI encodes 0.02·N(0, 1) frames into ``enc_out`` first."""
    family_serve_cli(NAME, capsys)


def test_zoo_extractor_refuses_the_audio_family():
    """It passes tokens only; the reference's fails with a KeyError at its
    first forward, the port's says why when it is made."""
    cfg = dataclasses.replace(get_config(NAME).reduced(), activation_dtype="float32")
    with pytest.raises(ValueError, match="frame embeddings"):
        make_zoo_extractor(cfg, rep_dim=8, device="cpu")
