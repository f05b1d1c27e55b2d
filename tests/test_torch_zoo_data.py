"""The zoo's training data and token SSL against the reference.

``token_stream_from_draws`` and ``sequence_classification_from_draws`` are
fed the reference's own draws (its ``jax.random`` calls under the same
keys) and must give the reference's outputs exactly; the token
augmentations, fed the reference's keep masks, likewise. Also the token
modality of ``SSLConfig`` / ``draw_ssl`` / ``augment_views``, the train
specs, ``materialize``, and the roofline arithmetic.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import INPUT_SHAPES as JX_SHAPES
from repro.configs import all_configs as jx_all_configs
from repro.core import augment as jx_augment
from repro.data import synthetic as jx_synthetic
from repro.launch import specs as jx_specs
from repro.roofline import analysis as jx_roofline
from repro_torch.configs import INPUT_SHAPES, all_configs, get_config
from repro_torch.core import augment
from repro_torch.core.ssl import SSLConfig, augment_views, draw_ssl, ssl_loss
from repro_torch.data import (
    make_sequence_classification,
    make_token_stream,
    sequence_classification_from_draws,
    token_stream_from_draws,
)
from repro_torch.launch import specs
from repro_torch.roofline import HW, active_params, model_flops, roofline_terms


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("vocab", [32, 512, 50280])
def test_token_stream_from_the_references_draws(seed, vocab):
    key = jax.random.PRNGKey(seed)
    b, s = 4, 33
    (k1,) = jax.random.split(key, 1)  # the reference's own split
    u = jax.random.uniform(k1, (b, s + 1), minval=1e-6, maxval=1.0)
    want_t, want_l = jx_synthetic.make_token_stream(key, b, s, vocab)
    got_t, got_l = token_stream_from_draws(torch.from_numpy(np.array(u)), vocab)
    assert got_t.dtype == torch.int32 and got_t.shape == (b, s)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("n, seq, vocab, classes", [(400, 16, 32, 3), (50, 32, 64, 4)])
def test_sequence_classification_from_the_references_draws(seed, n, seq, vocab, classes):
    key = jax.random.PRNGKey(seed)
    k_topic, k_lbl, k_tok, k_mix = jax.random.split(key, 4)
    topics = jax.random.randint(k_topic, (classes, vocab // 4), 1, vocab)
    labels = jax.random.randint(k_lbl, (n,), 0, classes)
    base = jax.random.randint(k_tok, (n, seq), 1, vocab)
    pick = jax.random.randint(k_mix, (n, seq), 0, vocab // 4)
    use = jax.random.bernoulli(k_mix, 0.5, (n, seq))
    want_x, want_y = jx_synthetic.make_sequence_classification(
        key, n, seq_len=seq, vocab_size=vocab, num_classes=classes
    )
    got_x, got_y = sequence_classification_from_draws(
        *(torch.from_numpy(np.array(a)) for a in (topics, labels, base, pick, use))
    )
    assert got_x.dtype == torch.int32 and got_y.dtype == torch.int64
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))


def test_generators_on_their_own_draws():
    g = torch.Generator().manual_seed(0)
    tokens, labels = make_token_stream(g, 8, 128, 50280)
    assert tokens.shape == labels.shape == (8, 128) and tokens.dtype == torch.int32
    assert torch.equal(tokens[:, 1:], labels[:, :-1])
    assert int(tokens.min()) >= 0 and int(tokens.max()) < 50280
    assert float((tokens == 0).float().mean()) > 0.2  # Zipf-like: the head is heavy
    x, y = make_sequence_classification(400, seed=0, device="cpu", seq_len=16, vocab_size=32, num_classes=3)
    assert x.shape == (400, 16) and y.shape == (400,)
    assert int(x.min()) >= 1 and int(x.max()) < 32 and sorted(set(y.tolist())) == [0, 1, 2]
    x2, _ = make_sequence_classification(400, seed=0, device="cpu", seq_len=16, vocab_size=32, num_classes=3)
    assert torch.equal(x, x2)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("mask_ratio", [0.15, 0.5])
def test_token_augmentations_from_the_references_masks(mask_ratio, dtype):
    """Fed the reference's keep masks (its Bernoulli draws under its keys),
    the views equal the reference's, in the input's dtype (a split carries
    tokens as float32)."""
    x = np.random.default_rng(1).integers(1, 32, (6, 8)).astype(dtype)
    key = jax.random.PRNGKey(4)
    kw, ks = jax.random.split(key)
    keep_w = jax.random.bernoulli(kw, 1.0 - mask_ratio, x.shape)
    keep_s = keep_w & jax.random.bernoulli(ks, 1.0 - 0.4, x.shape)
    want_w, want_s = jx_augment.token_augment_pair(key, jnp.asarray(x), mask_ratio=mask_ratio)
    draws = augment.TokenPairDraws(
        torch.from_numpy(np.asarray(keep_w)), torch.from_numpy(np.asarray(keep_s))
    )
    got_w, got_s = augment.token_augment_pair(torch.from_numpy(x), draws)
    assert got_w.dtype == got_s.dtype == torch.from_numpy(x).dtype
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    keep = jax.random.bernoulli(key, 1.0 - mask_ratio, x.shape)
    want = jx_augment.weak_augment_tokens(key, jnp.asarray(x), mask_ratio=mask_ratio)
    got = augment.weak_augment_tokens(torch.from_numpy(x), torch.from_numpy(np.asarray(keep)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_token_draws_and_views():
    """draw_ssl's token draws: the weak keep rate ≈ 1 − r_m, the strong
    view masks wherever the weak one does, and ≈ (1 − r_m)·0.6 kept."""
    cfg = SSLConfig(modality="token")
    g = torch.Generator().manual_seed(0)
    d = draw_ssl(g, cfg, (4000, 16), (4000, 16), torch.device("cpu"))
    assert d.labeled.dtype == torch.bool and d.labeled.shape == (4000, 16)
    kw, ks = d.unlabeled.keep_weak, d.unlabeled.keep_strong
    assert not bool((ks & ~kw).any())
    assert abs(float(kw.float().mean()) - 0.8) < 0.01
    assert abs(float(ks.float().mean()) - 0.48) < 0.01
    x = torch.randint(1, 32, (4000, 16)).float()
    xl, wu, su = augment_views(x, x, cfg, d)
    assert xl.dtype == torch.float32
    assert torch.equal(xl == 0, ~d.labeled) and torch.equal(su == 0, ~ks) and torch.equal(wu == 0, ~kw)


def test_token_ssl_reads_no_feature_mean():
    """The client computes a feature mean of any 2-D pool (tokens
    included); the token loss is the same with it and without it."""
    cfg = SSLConfig(modality="token", confidence_threshold=0.0)
    g = torch.Generator().manual_seed(1)
    x = torch.randint(1, 32, (8, 6)).float()
    y = torch.randint(0, 3, (8,))
    d = draw_ssl(g, cfg, x.shape, x.shape, torch.device("cpu"))
    head = torch.nn.Linear(6, 3)
    losses = [
        ssl_loss(head, x, y, x, cfg, d, feature_mean=fm)[0].item()
        for fm in (None, x.mean(0))
    ]
    assert losses[0] == losses[1]
    with pytest.raises(ValueError, match="unsupported SSL modality"):
        draw_ssl(g, dataclasses.replace(cfg, modality="audio"), x.shape, x.shape, torch.device("cpu"))


@pytest.mark.parametrize("shape", sorted(INPUT_SHAPES))
def test_train_specs_match_the_reference(shape):
    for name in ("phi4-mini-3.8b", "qwen2-vl-72b", "seamless-m4t-large-v2", "mamba2-370m"):
        cfg, jcfg, s = get_config(name), jx_all_configs()[name], INPUT_SHAPES[shape]
        mine, ref = specs.train_specs(cfg, s), jx_specs.train_specs(jcfg, JX_SHAPES[shape])
        assert sorted(mine) == sorted(ref)
        for k in ref:
            assert mine[k].shape == ref[k].shape
            assert str(mine[k].dtype).split(".")[-1] == str(ref[k].dtype)


def test_materialize_draws_the_references_ranges():
    cfg = get_config("qwen2-vl-72b").reduced()
    tree = specs.train_specs(cfg, INPUT_SHAPES["train_4k"])
    tree = {k: specs.TensorSpec((2,) + v.shape[1:3], v.dtype) for k, v in tree.items()}
    g = torch.Generator().manual_seed(0)
    batch = specs.materialize(g, tree, "cpu")
    assert sorted(batch) == ["embeds", "labels", "tokens"]
    for k, v in batch.items():
        assert v.shape == tree[k].shape and v.dtype == tree[k].dtype
    assert int(batch["tokens"].min()) >= 0 and int(batch["tokens"].max()) < 100
    assert 0.005 < float(batch["embeds"].float().std()) < 0.05
    again = specs.materialize(torch.Generator().manual_seed(0), tree, "cpu")
    assert all(torch.equal(batch[k], again[k]) for k in batch)
    with pytest.raises(TypeError, match="not a spec tree"):
        specs.materialize(g, [1], "cpu")


@pytest.mark.parametrize("name", sorted(jx_all_configs()))
def test_model_flops_and_active_params_equal_the_references(name):
    cfg, jcfg = get_config(name), jx_all_configs()[name]
    assert active_params(cfg) == jx_roofline.active_params(jcfg)
    assert active_params(cfg.reduced()) == jx_roofline.active_params(jcfg.reduced())
    for shape in INPUT_SHAPES:
        assert model_flops(cfg, INPUT_SHAPES[shape]) == jx_roofline.model_flops(jcfg, JX_SHAPES[shape])


def test_roofline_terms_on_the_h100():
    assert HW.name == "h100-sxm" and HW.peak_flops == 989e12 and HW.hbm_bw == 3.35e12
    assert HW.tf32_flops == 495e12 and HW.f32_flops == 67e12
    t = roofline_terms({"dot_flops": 989e12, "traffic_bytes": 6.7e12, "collective_bytes": 0.0})
    assert t["compute_s"] == pytest.approx(1.0) and t["memory_s"] == pytest.approx(2.0)
    assert t["bottleneck"] == "memory"
    assert sorted(all_configs()) == sorted(jx_all_configs())


def test_chip_smoke_bounds_read_the_roofline_rates():
    """chip_smoke.py's kernel bounds take the H100's rates from HW: one
    source for the card's figures."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    assert chip_smoke.H100_BYTES_PER_S == HW.hbm_bw
    assert chip_smoke.H100_F32_FLOPS == HW.f32_flops
    assert chip_smoke.H100_TF32_FLOPS == HW.tf32_flops
