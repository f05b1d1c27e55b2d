"""The zoo's ``loss_fn`` and its gradients against the reference for the vlm,
SSM, hybrid and audio families; remat against the plain gradients; the
norms under autograd. Set-up and tolerances as in
``test_torch_zoo_train.py``.
"""

import dataclasses

import pytest
import torch

from repro_torch.kernels.rmsnorm import ops as rops
from repro_torch.models import model_zoo
from test_torch_zoo import B, S, _tokens, family_setup
from test_torch_zoo_train import one_torch_thread  # noqa: F401 (an autouse fixture)
from test_torch_zoo_train import (
    FAMILIES,
    TOL,
    _batch,
    _loss_and_grads,
    _torch,
    assert_grads_match,
)


@pytest.mark.parametrize("family", ["audio", "hybrid", "ssm", "vlm"])
def test_loss_and_gradients_match_the_reference(family):
    name, changes = FAMILIES[family]
    setup = family_setup(name, **changes)
    tcfg, tparams = setup[1], setup[5]
    assert tcfg.remat  # the reduced configs checkpoint their blocks
    jloss, jgrads, loss = _loss_and_grads(setup, _batch(tcfg))
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert abs(loss.item() - jloss) <= TOL * abs(jloss)
    assert assert_grads_match(tparams, jgrads) == len(list(tparams.parameters()))


@pytest.mark.parametrize("family", ["dense", "moe", "ssm", "hybrid", "audio"])
def test_remat_gradients_equal_the_plain_ones(family):
    """Checkpointed blocks re-run their forward in the backward: the same
    gradients as without remat (to 1e-7 of each leaf's scale)."""
    name, changes = FAMILIES[family]
    setup = family_setup(name, **changes)
    tcfg, tparams = setup[1], setup[5]
    batch = _torch(_batch(tcfg, seed=7))
    grads = {}
    for remat in (True, False):
        model = model_zoo.build_model(dataclasses.replace(tcfg, remat=remat))
        tparams.zero_grad()
        model.loss_fn(tparams, batch).backward()
        grads[remat] = [p.grad.clone() for p in tparams.parameters()]
    for a, b in zip(grads[True], grads[False]):
        assert torch.allclose(a, b, rtol=0, atol=1e-7 * max(b.abs().max().item(), 1e-30))


def test_prefill_and_decode_stay_out_of_autograd():
    _, tcfg, _, tmodel, _, tparams = family_setup("phi4-mini-3.8b")
    toks = torch.from_numpy(_tokens(tcfg, shape=(B, S)))
    assert not tmodel.prefill_fn(tparams, {"tokens": toks}).requires_grad
    assert tmodel.hidden_fn(tparams, {"tokens": toks}).requires_grad


def test_gated_norm_goes_through_the_norm_function():
    """Under grad every zoo norm (the Mamba2 gated norm included) takes the
    RMSNorm op's autograd Function, whose CPU backward is the plain formula."""
    _, tcfg, _, tmodel, _, tparams = family_setup("mamba2-370m")
    calls = []
    plain = rops.RmsNormFunction.apply

    def counted(*args):
        calls.append(args[0].shape[-1])
        return plain(*args)

    rops.RmsNormFunction.apply = counted
    try:
        model = model_zoo.build_model(dataclasses.replace(tcfg, remat=False))
        model.loss_fn(tparams, _torch(_batch(tcfg))).backward()
    finally:
        rops.RmsNormFunction.apply = plain
    d_inner = tcfg.ssm.expand * tcfg.d_model
    assert sorted(calls) == sorted([tcfg.d_model] * 3 + [d_inner] * 2)
