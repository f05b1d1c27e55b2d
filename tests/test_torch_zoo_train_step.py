"""The layers under autograd and ``make_train_step`` against the reference:
the prefill's blocked attention scan, the chunked SSD scan and the causal
conv against ``jax.grad``; three clip + Adam steps with 1 and 2
microbatches against the reference's ``make_train_step``. Set-up and
tolerances as in ``test_torch_zoo_train.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jx_optim
from repro.launch import steps as jx_steps
from repro.models import layers as jx_layers
from repro.models import ssm as jx_ssm
from repro_torch import bridge, optim
from repro_torch.launch import steps
from repro_torch.models import layers, ssm
from test_torch_zoo import family_setup
from test_torch_zoo_train import one_torch_thread  # noqa: F401 (an autouse fixture)
from test_torch_zoo_train import (
    FAMILIES,
    TOL,
    _batch,
    _jnp,
    _leaf,
    _torch,
)


def test_attention_scan_ssd_and_conv_gradients_match():
    """The prefill's blocked attention scan (causal, windowed, G = 2, two
    chunks), the chunked SSD scan and the causal conv under autograd, against
    ``jax.grad`` of the reference's functions."""
    rng = np.random.default_rng(8)

    def check(tfn, jfn, arrays):
        tin = [torch.from_numpy(a).requires_grad_(a.dtype == np.float32) for a in arrays]
        out = tfn(*tin)
        w = rng.standard_normal(out.shape).astype(np.float32)
        (out * torch.from_numpy(w)).sum().backward()
        jf = [i for i, a in enumerate(arrays) if a.dtype == np.float32]

        def jloss(*fl):
            full = [jnp.asarray(a) for a in arrays]
            for i, v in zip(jf, fl):
                full[i] = v
            return jnp.sum(jfn(*full) * w)

        want = jax.grad(jloss, argnums=tuple(range(len(jf))))(*[jnp.asarray(arrays[i]) for i in jf])
        for i, g in zip(jf, want):
            g = np.asarray(g)
            assert np.abs(tin[i].grad.numpy() - g).max() <= TOL * np.abs(g).max(), i

    q = rng.standard_normal((2, 8, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 8, 2, 16)).astype(np.float32) for _ in range(2))
    pos = np.broadcast_to(np.arange(8, dtype=np.int32), (2, 8)).copy()
    for window in (None, 3):
        check(
            lambda q_, k_, v_, p_: layers._attend_block_scan(q_, k_, v_, p_, p_, True, 4, window),
            lambda q_, k_, v_, p_: jx_layers._attend_block_scan(q_, k_, v_, p_, p_, window, True, 4),
            [q, k, v, pos],
        )
    x = rng.standard_normal((2, 8, 3, 4)).astype(np.float32)
    dt = np.abs(rng.standard_normal((2, 8, 3))).astype(np.float32)
    a = -np.exp(rng.standard_normal(3)).astype(np.float32)
    bm, cm = (rng.standard_normal((2, 8, 5)).astype(np.float32) for _ in range(2))
    check(
        lambda *t: ssm.ssd_chunked(*t, chunk=4)[0],
        lambda *t: jx_ssm.ssd_chunked(*t, chunk=4)[0],
        [x, dt, a, bm, cm],
    )
    xc = rng.standard_normal((2, 8, 6)).astype(np.float32)
    wc, bc = rng.standard_normal((4, 6)).astype(np.float32), rng.standard_normal(6).astype(np.float32)
    check(ssm._causal_conv, jx_ssm._causal_conv, [xc, wc, bc])


# Adam's eps for the parameter comparison. With the default 1e-8 an element
# whose gradient lies below the two sides' rounding difference (~1e-7 of the
# leaf's scale) can take the opposite sign on each side, and Adam's first
# update is about ±lr whatever the gradient's size: a 2·lr jump with no
# bearing on the port's arithmetic. At 1e-3 such an element moves by about
# lr·|g| / 1e-3 on both sides.
CMP_EPS = 1e-3


def _jx_train(jcfg, jmodel, jparams, arrays, micro, eps):
    tx = jx_optim.chain(jx_optim.clip_by_global_norm(1.0), jx_optim.adam(3e-3, eps=eps))
    state = tx.init(jparams)
    step = jax.jit(jx_steps.make_train_step(jmodel, tx, micro))
    losses = []
    for _ in range(3):
        jparams, state, loss = step(jparams, state, _jnp(arrays))
        losses.append(float(loss))
    return jparams, losses


@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("family", ["dense", "moe"])
def test_train_step_matches_the_reference(family, micro):
    """Three steps of clip(1.0) + Adam(3e-3) on one batch of four rows with
    1 and 2 microbatches: the three losses within 1e-5 relative (Adam's
    default eps), and every parameter leaf within 1e-5 of its scale after
    the third step (eps CMP_EPS)."""
    name, changes = FAMILIES[family]
    jcfg, tcfg, jmodel, tmodel, jparams, tparams = family_setup(name, **changes)
    arrays = _batch(tcfg, seed=9, b=4)
    start = [p.detach().clone() for p in tparams.parameters()]
    for eps in (1e-8, CMP_EPS):
        want_params, want_losses = _jx_train(jcfg, jmodel, jparams, arrays, micro, eps)
        with torch.no_grad():
            for p, p0 in zip(tparams.parameters(), start):
                p.copy_(p0)
        tx = steps.Transform(lambda ps: optim.Adam(ps, 3e-3, eps=eps, max_norm=1.0))
        opt = tx.init(list(tparams.parameters()))
        step = steps.make_train_step(tmodel, tx, micro)
        batch = _torch(arrays)
        losses = [float(step(tparams, opt, batch)) for _ in range(3)]
        assert want_losses[-1] < want_losses[0]
        for got, want in zip(losses, want_losses):
            assert abs(got - want) <= TOL * abs(want), (eps, losses, want_losses)
    for path, index, p in bridge._zoo_leaves(tparams):
        want = _leaf(want_params, path, index)
        scale = max(np.abs(want).max(), 1e-30)
        assert np.abs(p.detach().numpy() - want).max() <= TOL * scale, ("/".join(path), index)


def test_microbatches_must_split_the_batch_evenly():
    _, tcfg, _, tmodel, _, tparams = family_setup("phi4-mini-3.8b")
    tx = steps.make_optimizer(tcfg)
    step = steps.make_train_step(tmodel, tx, 3)
    with pytest.raises(ValueError, match="3 equal microbatches"):
        step(tparams, tx.init(list(tparams.parameters())), _torch(_batch(tcfg, b=4)))


def test_sgdm_configs_get_clipped_momentum_sgd():
    _, tcfg, *_ = family_setup("phi4-mini-3.8b")
    opt = steps.make_optimizer(dataclasses.replace(tcfg, optimizer="sgdm"), 0.1, 2.0).init(
        [torch.zeros(3)]
    )
    assert isinstance(opt, optim.SGD) and opt.momentum == 0.9 and opt.max_norm == 2.0
    opt = steps.make_optimizer(tcfg, 0.1, 2.0).init([torch.zeros(3)])
    assert isinstance(opt, optim.Adam) and opt.max_norm == 2.0
