"""The port's hybrid family (zamba2-1.2b) against the reference.

Zamba2 is a Mamba2 stack with one shared attention block (the same
weights) applied after every ``hybrid_attn_every`` blocks, each time with
its own KV cache. The reduced config (2 blocks, a group of 2) has one group
and no trailing blocks, so a 5-block variant (two groups of 2, one trailing
block) also runs: two applications of the shared block and ``rest``. Both
go through the ``family_*`` checks of ``test_torch_zoo``; f32 activations,
1e-5 of the outputs' scale.
"""

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import specs
from repro_torch.models import model_zoo
from test_torch_zoo import (
    _f32_caches,
    _tokens,
    family_bridge_round_trip,
    family_cache_shapes,
    family_decode_steps,
    family_init_rule,
    family_prefill_and_hidden,
    family_prefill_equals_sequential_decode,
    family_serve_cli,
    family_setup,
)

NAME = "zamba2-1.2b"
SETUPS = {"reduced": {}, "groups-2-rest-1": {"num_layers": 5}}


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", params=sorted(SETUPS))
def setup(request):
    return family_setup(NAME, **SETUPS[request.param])


def test_layout_of_groups_and_rest():
    full = model_zoo.make_backbone(get_config(NAME), "meta")
    assert len(full.super) == 6 and all(len(g) == 6 for g in full.super) and len(full.rest) == 2
    assert sum(p.numel() for p in full.parameters()) == 1_170_473_856
    _, tcfg, _, tmodel, _, tparams = family_setup(NAME, num_layers=5)
    assert len(tparams.super) == 2 and len(tparams.rest) == 1
    assert not hasattr(family_setup(NAME)[5], "rest")


def test_prefill_and_hidden_match(setup):
    family_prefill_and_hidden(setup)


def test_decode_steps_match_logits_and_cache(setup):
    family_decode_steps(setup)


def test_prefill_equals_sequential_decode(setup):
    family_prefill_equals_sequential_decode(setup)


@pytest.mark.parametrize("layers", [2, 5, 38])
def test_cache_shapes_match_the_reference(layers):
    family_cache_shapes(NAME, num_layers=layers, hybrid_attn_every=2 if layers < 38 else 6)


def test_each_application_of_the_shared_block_has_its_own_cache():
    """Two groups: the shared block's two KV caches hold different keys,
    and each took one write a step."""
    _, tcfg, _, tmodel, _, tparams = family_setup(NAME, num_layers=5)
    toks = torch.from_numpy(_tokens(tcfg, shape=(2, 4)))
    cache = _f32_caches(specs.zeros_like_spec(tmodel.cache_shapes(2, 4), "cpu"))
    for t in range(4):
        pos = torch.full((2, 1), t, dtype=torch.int32)
        _, cache = tmodel.decode_fn(tparams, cache, {"token": toks[:, t : t + 1], "pos": pos})
    attn = cache["super"]["attn"]
    assert attn["index"].tolist() == [4, 4]
    assert attn["k"].shape[0] == 2 and not torch.allclose(attn["k"][0], attn["k"][1])
    assert (attn["pos"] == torch.arange(1, 5, dtype=torch.int32)).all()


def test_bridge_round_trip_and_key_check(setup):
    family_bridge_round_trip(setup, ("super", "mamba", "conv_w"))
    family_bridge_round_trip(setup, ("shared_attn", "attn", "w_o"))


def test_init_follows_the_reference_rules():
    """Two stacked axes on the groups' blocks: ``A_log`` 0, as the reference's init gives it."""
    family_init_rule(NAME)


def test_serve_cli_on_the_cpu(capsys):
    family_serve_cli(NAME, capsys)
