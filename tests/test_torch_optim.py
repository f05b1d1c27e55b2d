"""The port's Adam, AdamW, SGD and schedules against ``repro.optim``.

Random numpy trees (three leaves of mixed shapes) and numpy gradients go
through the reference's ``chain(clip_by_global_norm, …)`` transforms and
the port's optimizers for five steps; every parameter within 1e-6 of its
leaf's scale (f32 in different association orders). Below them, the port's
counterparts of ``tests/test_optim.py``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jx
from repro_torch import optim

TOL = 1e-6
SHAPES = [(7, 5), (13,), (3, 4, 2)]
STEPS = 5


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(scale * rng.standard_normal(s)).astype(np.float32) for s in SHAPES]


def _reference(tx, params, grads_by_step):
    ptree = {str(i): jnp.asarray(p) for i, p in enumerate(params)}
    state = tx.init(ptree)
    for grads in grads_by_step:
        gtree = {str(i): jnp.asarray(g) for i, g in enumerate(grads)}
        updates, state = tx.update(gtree, state, ptree)
        ptree = jx.apply_updates(ptree, updates)
    return [np.asarray(ptree[str(i)]) for i in range(len(params))]


def _port(make, params, grads_by_step):
    ps = [torch.from_numpy(p.copy()) for p in params]
    opt = make(ps)
    for grads in grads_by_step:
        opt.step([torch.from_numpy(g.copy()) for g in grads])
    return [p.numpy() for p in ps]


def _match(got, want, tol=TOL):
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= tol * max(np.abs(w).max(), 1e-30)


def _grads(seed, clip_scale):
    return [_tree(seed + 100 + i, clip_scale) for i in range(STEPS)]


SCHEDULES = {
    "const": (lambda: 3e-2, lambda: 3e-2),
    "cosine": (lambda: jx.cosine_decay(5e-2, 4, 0.1), lambda: optim.cosine_decay(5e-2, 4, 0.1)),
    "warmup": (
        lambda: jx.linear_warmup_cosine(5e-2, 2, 6, 1e-3),
        lambda: optim.linear_warmup_cosine(5e-2, 2, 6, 1e-3),
    ),
}


@pytest.mark.parametrize("clip", [None, 1.0])
@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adam_and_adamw_match_the_reference(weight_decay, schedule, clip):
    params = _tree(1)
    grads = _grads(1, 3.0)  # global norm ~8: clip 1.0 scales every step
    jlr, tlr = (f() for f in SCHEDULES[schedule])
    adam = jx.adam(jlr, weight_decay=weight_decay)
    tx = adam if clip is None else jx.chain(jx.clip_by_global_norm(clip), adam)
    want = _reference(tx, params, grads)
    got = _port(lambda ps: optim.Adam(ps, tlr, weight_decay=weight_decay, max_norm=clip), params, grads)
    _match(got, want)


def test_adam_covers_the_references_adamw():
    """The reference's ``adamw`` (decay 0.01 by default) is Adam with
    ``weight_decay`` 0.01."""
    params, grads = _tree(2), _grads(2, 1.0)
    want = _reference(jx.adamw(1e-2), params, grads)
    _match(_port(lambda ps: optim.Adam(ps, 1e-2, weight_decay=0.01), params, grads), want)


@pytest.mark.parametrize("clip", [None, 1.0])
@pytest.mark.parametrize(
    "momentum, nesterov, weight_decay",
    [(0.0, False, 0.0), (0.9, False, 0.0), (0.9, True, 0.0), (0.9, True, 0.05), (0.0, False, 0.05)],
)
def test_sgd_matches_the_reference(momentum, nesterov, weight_decay, clip):
    params, grads = _tree(3), _grads(3, 3.0)
    sgd = jx.sgd(jx.cosine_decay(0.1, 4), momentum=momentum, nesterov=nesterov, weight_decay=weight_decay)
    tx = sgd if clip is None else jx.chain(jx.clip_by_global_norm(clip), sgd)
    want = _reference(tx, params, grads)

    def make(ps):
        return optim.SGD(
            ps, optim.cosine_decay(0.1, 4), momentum=momentum, nesterov=nesterov,
            weight_decay=weight_decay, max_norm=clip,
        )

    _match(_port(make, params, grads), want)


@pytest.mark.parametrize("max_norm", [None, 5.0])
def test_clipped_sgd_matches_the_references_chain(max_norm):
    """ClippedSGD (every SSL session's and server fit's optimizer, unclipped
    for the baselines) is the reference's clip + sgd(momentum 0.9)."""
    params, grads = _tree(4), _grads(4, 3.0)
    sgd = jx.sgd(0.05, momentum=0.9)
    tx = sgd if max_norm is None else jx.chain(jx.clip_by_global_norm(max_norm), sgd)
    got = _port(lambda ps: optim.ClippedSGD(ps, 0.05, 0.9, max_norm), params, grads)
    _match(got, _reference(tx, params, grads))


@pytest.mark.parametrize("step", [0, 1, 2, 3, 5, 7, 10, 100])
def test_schedules_match_the_reference(step):
    for jf, tf in (
        (jx.constant(0.3), optim.constant(0.3)),
        (jx.cosine_decay(1.0, 7, 0.2), optim.cosine_decay(1.0, 7, 0.2)),
        (jx.linear_warmup_cosine(1.0, 3, 9, 0.05), optim.linear_warmup_cosine(1.0, 3, 9, 0.05)),
        (jx.linear_warmup_cosine(2.0, 0, 5), optim.linear_warmup_cosine(2.0, 0, 5)),
    ):
        want = float(jf(jnp.asarray(step)))
        assert abs(tf(step) - want) <= TOL * max(abs(want), 1.0)


def test_adam_reads_lr_before_the_step_and_counts_steps():
    seen = []

    def schedule(step):
        seen.append(step)
        return 1e-2

    opt = optim.Adam([torch.zeros(3)], schedule)
    for _ in range(3):
        opt.step([torch.ones(3)])
    assert seen == [0, 1, 2] and opt.count == 3
    assert all(m.dtype == torch.float32 for m in opt.mu + opt.nu)


def test_updates_run_in_bounded_groups(monkeypatch):
    """Leaves are updated in multi-tensor groups of at most FOREACH_CHUNK
    elements (a larger leaf alone), with the same result as one group."""
    params, grads = _tree(5), _grads(5, 1.0)
    want = _port(lambda ps: optim.Adam(ps, 1e-2, weight_decay=0.1), params, grads)
    monkeypatch.setattr(optim, "FOREACH_CHUNK", 20)
    groups = [[t.numel() for t in g[0]] for g in optim._groups([torch.from_numpy(p) for p in params])]
    assert groups == [[35], [13, 24]]
    _match(_port(lambda ps: optim.Adam(ps, 1e-2, weight_decay=0.1), params, grads), want, 0.0)


def test_bf16_parameters_keep_their_dtype():
    p = torch.ones(4, dtype=torch.bfloat16)
    opt = optim.Adam([p], 0.5, weight_decay=0.1)
    opt.step([torch.full((4,), 2.0, dtype=torch.bfloat16)])
    assert p.dtype == torch.bfloat16 and float(p[0]) == pytest.approx(1.0 - 0.5 - 0.05, abs=1e-2)
    with pytest.raises(ValueError, match="2 gradients for 1 parameters"):
        opt.step([torch.zeros(4), torch.zeros(4)])


# ------------------------------------------ counterparts of tests/test_optim.py
def _quadratic_min(make, steps=200):
    w = torch.tensor([3.0, -2.0])
    b = torch.tensor(1.5)
    opt = make([w, b])
    for _ in range(steps):
        opt.step([2 * w, 2 * b])
    return float((w**2).sum() + b**2)


def test_sgd_converges_quadratic():
    assert _quadratic_min(lambda ps: optim.SGD(ps, 0.1)) < 1e-6


def test_sgd_momentum_converges():
    assert _quadratic_min(lambda ps: optim.SGD(ps, 0.05, momentum=0.9)) < 1e-6


def test_adam_converges():
    assert _quadratic_min(lambda ps: optim.Adam(ps, 0.1)) < 1e-4


def test_adamw_decays_weights():
    w = torch.ones(3)
    optim.Adam([w], 0.01, weight_decay=0.5).step([torch.zeros(3)])
    assert float(w[0]) < 1.0  # decay pulls toward zero


def test_clip_by_global_norm():
    g = [torch.full((4,), 10.0)]
    optim.clip_by_global_norm_(g, 1.0)
    assert float(optim.global_norm(g)) == pytest.approx(1.0, rel=1e-5)


def test_clip_then_step_order():
    """Clip to norm 1, then an SGD step of lr 0.5: (3, 4) → (−0.3, −0.4)."""
    w = torch.zeros(2)
    optim.SGD([w], 0.5, max_norm=1.0).step([torch.tensor([3.0, 4.0])])
    assert torch.allclose(w, torch.tensor([-0.3, -0.4]), atol=1e-6)


def test_schedules():
    s = optim.cosine_decay(1.0, 100)
    assert s(0) == pytest.approx(1.0)
    assert s(100) == pytest.approx(0.0, abs=1e-6)
    w = optim.linear_warmup_cosine(1.0, 10, 100)
    assert w(5) == pytest.approx(0.5, rel=1e-5)
    assert w(100) == pytest.approx(0.0, abs=1e-6)
    assert math.isclose(optim.constant(0.25)(7), 0.25)
