"""The port's local-SSL session and extractor grads against
``repro.engine.local_ssl`` and ``repro.models.extractors``.

The session is given the reference's schedule seed and, for every step,
the augmentation draws the reference derives from that step's key (with
the helpers of ``test_torch_ssl.py``). Parameters are seeded numpy draws carried across with
``repro_torch.bridge``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ssl as jssl
from repro.engine import local_ssl as jlocal
from repro.models import extractors as jx
from repro_torch import bridge
from repro_torch.core import ssl as tssl
from repro_torch.engine import local_ssl as tlocal
from repro_torch.models import extractors as tx

from test_torch_ssl import _assert_tree_close, _grad_tree, _rand, _ref_params, _t, ref_ssl_draws

# The CNN's GroupNorms rescale the two frameworks' different summation
# orders; relative to the grads' scale (as in test_torch_ssl.py).
CNN_RTOL = 1e-4
# A 10-step session compounds per-step rounding differences through the
# momentum trace; relative to the parameters' scale.
SESSION_RTOL = 1e-4


def test_cnn_extractor_grads_match_reference():
    """The backward pass through XLA SAME (0, 1) pads of the stride-2 convs
    and the strided shortcut, on an even and an odd input size."""
    for size, seed in ((16, 0), (15, 1)):
        x = _rand(seed, (3, size, size, 3))
        ref_e = jx.make_cnn_extractor(rep_dim=8, widths=(8, 16), blocks_per_stage=2)
        port_e = tx.make_cnn_extractor(3, 8, (8, 16), 2)
        params = _ref_params(ref_e, x, seed + 5)
        bridge.load_jax_params(port_e, params)
        w = _rand(seed + 9, (3, 8))
        grads_r = jax.jit(jax.grad(lambda p: jnp.sum(ref_e.apply(p, jnp.asarray(x)) * w)))(params)
        (port_e(_t(x)) * _t(w)).sum().backward()
        _assert_tree_close(_grad_tree(port_e), grads_r, CNN_RTOL)



# ------------------------------------------------------- the local session
def _unlabeled_draw_seeds(seed0, epochs):
    return [seed0 + 7919 * e + jlocal._UNLABELED_STREAM for e in range(epochs)]


@pytest.mark.parametrize("n_l,n_u", [(70, 300), (32, 0), (5, 3)])
def test_schedule_indices_equal_reference(n_l, n_u):
    key = jax.random.PRNGKey(n_l)
    hp_r = jlocal.SSLHParams(epochs=3, batch_size=32, unlabeled_ratio=2)
    hp = tlocal.SSLHParams(epochs=3, batch_size=32, unlabeled_ratio=2)
    ref = jlocal.build_schedule(key, n_l, n_u, hp_r)
    seed0 = int(jax.random.randint(key, (), 0, 2**31 - 1))
    got = tlocal.build_schedule(seed0, n_l, n_u, hp)
    np.testing.assert_array_equal(got.idx_labeled, np.asarray(ref.idx_labeled))
    np.testing.assert_array_equal(got.idx_unlabeled, np.asarray(ref.idx_unlabeled))
    assert got.idx_labeled.shape[0] == tlocal.schedule_steps(n_l, hp)
    assert len(set(_unlabeled_draw_seeds(seed0, 3)) & {seed0 + e for e in range(3)}) == 0


@pytest.mark.parametrize("modality", ["tabular", "image"])
def test_ssl_session_matches_reference(modality):
    """A 10-step session, given the reference's seed0 and per-step draws,
    ends at the reference's parameters."""
    if modality == "tabular":
        fshape, n_l, n_u, epochs = (20,), 32, 200, 10
        ref_e, port_e = jx.make_mlp_extractor(16, (64,)), tx.make_mlp_extractor(20, 16, (64,))
    else:
        fshape, n_l, n_u, epochs = (8, 8, 3), 8, 40, 10
        ref_e = jx.make_cnn_extractor(rep_dim=8, widths=(8, 16), blocks_per_stage=1)
        port_e = tx.make_cnn_extractor(3, 8, (8, 16), 1)
    ref_h, port_h = jx.make_classifier(2), tx.make_classifier(ref_e.rep_dim, 2)
    cfg = jssl.SSLConfig(modality=modality, confidence_threshold=0.6)
    tcfg = tssl.SSLConfig(modality=modality, confidence_threshold=0.6)
    x_l, x_u = _rand(30, (n_l, *fshape)), _rand(31, (n_u, *fshape))
    y = np.random.default_rng(32).integers(0, 2, n_l)
    fm = x_u.mean(0) if modality == "tabular" else None
    pe = _ref_params(ref_e, x_l, 33, scale=0.3)
    ph = _ref_params(ref_h, np.zeros((1, ref_e.rep_dim), np.float32), 34, scale=0.3)
    bridge.load_jax_params(port_e, pe)
    bridge.load_jax_params(port_h, ph)
    hp_r = jlocal.SSLHParams(epochs=epochs, batch_size=8 if modality == "image" else 32)
    hp = tlocal.SSLHParams(epochs=epochs, batch_size=hp_r.batch_size)
    key = jax.random.PRNGKey(9)
    task_r = jlocal.PartyTask(
        extractor=ref_e,
        head=ref_h,
        params=jlocal.PartyParams(pe, ph),
        ssl_cfg=cfg,
        x_labeled=jnp.asarray(x_l),
        y_pseudo=jnp.asarray(y),
        x_unlabeled=jnp.asarray(x_u),
        feature_mean=None if fm is None else jnp.asarray(fm),
    )
    params_r, _ = jlocal.train_party_ssl(key, task_r, hp_r)

    sched = jlocal.build_schedule(key, n_l, n_u, hp_r)
    steps = sched.step_keys.shape[0]
    assert steps == 10
    bs_l, bs_u = sched.idx_labeled.shape[1], sched.idx_unlabeled.shape[1]
    draws = [
        ref_ssl_draws(sched.step_keys[i], cfg, (bs_l, *fshape), (bs_u, *fshape))
        for i in range(steps)
    ]
    seed0 = int(jax.random.randint(key, (), 0, 2**31 - 1))
    task = tlocal.PartyTask(
        port_e, port_h, tcfg, _t(x_l), _t(y), _t(x_u), None if fm is None else _t(fm)
    )
    metrics = tlocal.train_party_ssl(task, hp, seed0, step_draws=draws)
    assert set(metrics) == {"loss", "l_s", "l_u", "pseudo_mask_rate"}
    _assert_tree_close(bridge.to_jax_params(port_e), params_r.extractor, SESSION_RTOL)
    _assert_tree_close(bridge.to_jax_params(port_h), params_r.head, SESSION_RTOL)
    # and the session moved the parameters well beyond that tolerance
    moved = max(
        float(np.abs(np.asarray(a) - np.asarray(b)).max())
        for a, b in zip(
            jax.tree_util.tree_leaves(params_r.extractor), jax.tree_util.tree_leaves(pe)
        )
    )
    assert moved > 100 * SESSION_RTOL


def test_session_draws_from_a_generator_are_seeded():
    """Without given draws the session draws from its generator: the same
    seed gives the same parameters, another seed others."""

    def run(seed):
        g = torch.Generator().manual_seed(0)
        e = tx.make_mlp_extractor(6, 4, (8,)).init_(g)
        h = tx.make_classifier(4, 2).init_(g)
        x_l, x_u = _t(_rand(1, (16, 6))), _t(_rand(2, (40, 6)))
        cfg = tssl.SSLConfig("tabular")
        task = tlocal.PartyTask(e, h, cfg, x_l, torch.arange(16) % 2, x_u, torch.zeros(6))
        hp = tlocal.SSLHParams(epochs=3, batch_size=8)
        tlocal.train_party_ssl(task, hp, 11, generator=torch.Generator().manual_seed(seed))
        return torch.cat([p.detach().flatten() for p in e.parameters()])

    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))
