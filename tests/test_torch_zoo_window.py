"""Sliding-window attention in the port against the reference.

With a window (``window_override``, or the config's ``attn_window``) the
prefill scan masks keys ``window`` or more positions back, and every
self-attention KV cache is a ring of ``min(cache_len, window)`` slots: step
t writes slot ``t % slots`` and the decode-attention op masks each slot by
its own stored position with the window's term. Held against the
reference's decode step by step (logits and every cache leaf, the ring's
too) on reduced gemma-7b, the hybrid's shared block (its ``attn_len``
rule), the MoE and vlm decoders and the audio decoder's self-attention;
MLA's decode takes no window, as the reference's does not. Numpy draws
carried to both sides; f32 activations, 1e-5 of the outputs' scale.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model_zoo as jx_zoo
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.decode_attention import ref as dec_ref
from repro_torch.launch import specs
from repro_torch.models import layers
from test_torch_zoo import (
    B,
    family_cache_shapes,
    family_decode_steps,
    family_prefill_and_hidden,
    family_prefill_equals_sequential_decode,
    family_setup,
)

STEPS = 12  # three turns of a 4-slot ring


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# (config, window_override, config changes): the window from the override
# or from the config's own attn_window
CASES = {
    "gemma-attn-window-4": ("gemma-7b", None, {"attn_window": 4}),
    "gemma-override-4": ("gemma-7b", 4, {}),
    "phi4-G2-override-5": ("phi4-mini-3.8b", 5, {"num_kv_heads": 2}),
    "granite-moe-override-4": ("granite-moe-3b-a800m", 4, {"capacity_factor": 8.0}),
    "qwen2-vl-override-4": ("qwen2-vl-72b", 4, {"num_kv_heads": 2}),
    "zamba2-override-4": ("zamba2-1.2b", 4, {"num_layers": 5}),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    name, window, changes = CASES[request.param]
    return family_setup(name, window=window, **changes)


def test_windowed_prefill_and_hidden_match(case):
    """8 tokens against a window of 4 or 5: the scan's window term masks."""
    family_prefill_and_hidden(case)


def test_ring_decode_matches_logits_and_cache(case):
    """12 steps over a 4- or 5-slot ring (cache_len 12): logits of every
    step, then the ring's k, v and stored positions against the
    reference's."""
    family_decode_steps(case, steps=STEPS, cache_len=STEPS)


def test_windowed_prefill_equals_ring_decode(case):
    """The port against itself (the reference's
    ``test_sliding_window_decode_matches_windowed_prefill``): a windowed
    prefill over 12 tokens and 12 steps through the ring agree."""
    family_prefill_equals_sequential_decode(case, steps=STEPS, cache_len=STEPS)


def test_ring_holds_the_last_window_positions():
    """Ten steps through a 4-slot ring: slot t % 4 holds position t, the
    first six overwritten."""
    _, tcfg, _, tmodel, _, tparams = family_setup("gemma-7b", window=4)
    cache = specs.zeros_like_spec(tmodel.cache_shapes(B, STEPS), "cpu")
    toks = torch.zeros(B, 1, dtype=torch.int32)
    for t in range(10):
        tmodel.decode_fn(tparams, cache, {"token": toks, "pos": torch.full((B, 1), t).int()})
    pos = cache["blocks"]["pos"]
    assert pos.shape == (2, B, 4) and pos[0, 0].tolist() == [9, 10, 7, 8]
    assert cache["blocks"]["index"].tolist() == [10, 10]


@pytest.mark.parametrize("window", [3, 5, 64])
def test_hybrid_attn_len_rule(window):
    """zamba2's shared block: ``min(eff_len, attn_window or eff_len)``,
    with the window from the override and from the config."""
    family_cache_shapes("zamba2-1.2b", window=window, num_layers=5, hybrid_attn_every=2)
    family_cache_shapes(
        "zamba2-1.2b", num_layers=5, hybrid_attn_every=2, attn_window=window
    )


@pytest.mark.parametrize("name", ["gemma-7b", "seamless-m4t-large-v2", "deepseek-v2-236b"])
def test_windowed_cache_shapes_match_the_reference(name):
    family_cache_shapes(name, window=4)


@pytest.fixture(scope="module")
def audio():
    return family_setup("seamless-m4t-large-v2", window=4)


def _frames(cfg, seed=12):
    rng = np.random.default_rng(seed)
    return (0.5 * rng.standard_normal((B, cfg.prefix_tokens, cfg.d_model))).astype(np.float32)


def test_audio_decoder_with_a_window_matches(audio):
    """The decoder's self-attention takes the window; cross-attention
    does not."""
    jcfg, tcfg, _, _, jparams, _ = audio
    family_prefill_and_hidden(audio, extra={"embeds": _frames(tcfg)})
    enc = np.asarray(jx_zoo._encode(jparams, jcfg, jnp.asarray(_frames(tcfg))))
    family_decode_steps(audio, steps=STEPS, cache_len=STEPS, leaves={"enc_out": (enc, "float32")})


@pytest.mark.parametrize("branch", [{}, {"q_lora_rank": 0}])
def test_mla_decode_ignores_the_window_as_the_reference_does(branch):
    """deepseek with window 4: the latent cache has 4 slots (cache_shapes
    takes the window), the windowed prefill masks, and the decode clamps its
    writes to the last slot with no ring and no window mask, step for step
    the reference's."""
    setup = family_setup("deepseek-v2-236b", window=4, **branch)
    family_prefill_and_hidden(setup)
    cache = family_decode_steps(setup, steps=8, cache_len=8)
    assert cache["dense0"]["pos"][0].tolist() == [1, 2, 3, 8]


# ---------------------------------------------------- the op's window term --
def _np_window_attention(q, k, v, key_pos, q_pos, window):
    """The reference decode branch's mask written out in float64 numpy:
    kpos > 0, dpos = q_pos - (kpos - 1) >= 0 and dpos < window."""
    b, h, dh = q.shape
    hkv = k.shape[1]
    qf = (q.astype(np.float64) / math.sqrt(dh)).reshape(b, hkv, h // hkv, dh)
    scores = np.einsum("bkgd,bksd->bkgs", qf, k.astype(np.float64))
    dpos = q_pos[:, None] - (key_pos - 1)
    mask = (key_pos > 0) & (dpos >= 0) & (dpos < window)
    scores = np.where(mask[:, None, None, :], scores, -1e30)
    p = np.exp(scores - scores.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bkgs,bksd->bkgd", p, v.astype(np.float64)).reshape(b, h, dh), mask


@pytest.mark.parametrize("window", [1, 3, 16, 100])
@pytest.mark.parametrize("shape", [(3, 8, 2, 16, 32), (4, 24, 8, 24, 128)])
def test_plain_window_mask_matches_a_direct_mask(shape, window):
    """A wrapped ring: slot l holds position p with p % S == l for the last
    S positions before the query (stored +1), with some slots empty."""
    b, h, hkv, s, dh = shape
    rng = np.random.default_rng(window)
    q = rng.standard_normal((b, h, dh)).astype(np.float32)
    k, v = (rng.standard_normal((b, hkv, s, dh)).astype(np.float32) for _ in range(2))
    q_pos = rng.integers(s, 3 * s, b).astype(np.int32)
    key_pos = np.zeros((b, s), np.int32)
    for i in range(b):
        for p in range(q_pos[i] - s + 1, q_pos[i] + 1):
            key_pos[i, p % s] = p + 1
    key_pos[rng.random((b, s)) < 0.2] = 0
    key_pos[np.arange(b), q_pos % s] = q_pos + 1  # the current token's slot
    want, mask = _np_window_attention(q, k, v, key_pos, q_pos, window)
    assert mask.any(-1).all()
    args = [torch.from_numpy(a) for a in (q, k, v)]
    got = dec_ref.decode_attention(
        *args, key_pos=torch.from_numpy(key_pos), q_pos=torch.from_numpy(q_pos), window=window
    )
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    via_op = dec_ops.decode_attention(
        *args, key_pos=torch.from_numpy(key_pos), q_pos=torch.from_numpy(q_pos), window=window
    )
    assert torch.equal(via_op, got)


def test_op_refuses_a_window_without_positions_or_below_one():
    q, k = torch.zeros(2, 4, 16), torch.zeros(2, 2, 8, 16)
    pos, qpos = torch.ones(2, 8, dtype=torch.int32), torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="key_pos"):
        dec_ops.decode_attention(q, k, k, window=4)
    for bad in (0, -3, 2.5, True):
        with pytest.raises(ValueError, match="window must be"):
            dec_ops.decode_attention(q, k, k, key_pos=pos, q_pos=qpos, window=bad)


def test_ring_decode_step_writes_index_mod_slots_and_passes_the_window(monkeypatch):
    """Step 7 of a 4-slot ring writes slot 3, in place, the index a device
    tensor read by no host code; the op gets the window."""
    b, h, hkv, s, dh = 2, 4, 2, 4, 8
    seen = {}

    def record(q, k_cache, v_cache, lengths=None, key_pos=None, q_pos=None, window=None):
        seen.update(key_pos=key_pos.clone(), q_pos=q_pos.clone(), window=window)
        return torch.zeros(q.shape)

    monkeypatch.setattr(layers.decode_ops, "decode_attention", record)
    cache = {
        "k": torch.zeros(b, s, hkv, dh),
        "v": torch.zeros(b, s, hkv, dh),
        "pos": torch.tensor([[5, 6, 7, 4], [5, 6, 7, 4]], dtype=torch.int32),
        "index": torch.tensor(7, dtype=torch.int32),
    }
    layers._decode_attend(
        torch.zeros(b, 1, h, dh), torch.ones(b, 1, hkv, dh), torch.ones(b, 1, hkv, dh),
        torch.full((b, 1), 7, dtype=torch.int32), cache, window=4,
    )
    assert seen["window"] == 4 and seen["key_pos"].tolist() == [[5, 6, 7, 8]] * 2
    assert int(cache["index"]) == 8 and (cache["k"][:, 3] == 1).all()
    assert (cache["k"][:, :3] == 0).all()
