"""The zoo's ``loss_fn`` and its gradients against the reference: the dense,
MoE and MLA families here, and the MoE aux term; the other families and
remat in ``test_torch_zoo_train_families.py``, the layers under autograd and
``make_train_step`` in ``test_torch_zoo_train_step.py`` (both use the
helpers below).

Reduced configs in f32 activations (``capacity_factor`` 8.0 in the MoE
configs, as ``tests/test_models_equivalence.py::_float_cfg`` sets it, except
where a test says the config's own), the reference's pytree redrawn with
numpy and carried into the port by ``bridge``; tokens, labels and
``embeds`` are numpy draws. Both sides compute the same f32 arithmetic in
different orders: the loss within 1e-5 relative, every gradient leaf within
1e-5 of that leaf's largest magnitude (``jax.grad`` on the reference).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jx_moe
from repro_torch import bridge
from repro_torch.models import moe
from test_torch_zoo import B, S, _tokens, family_setup

TOL = 1e-5
FAMILIES = {
    "dense": ("phi4-mini-3.8b", {}),
    "moe": ("granite-moe-3b-a800m", {"capacity_factor": 8.0}),
    "mla": ("deepseek-v2-236b", {"capacity_factor": 8.0}),
    "vlm": ("qwen2-vl-72b", {}),
    "ssm": ("mamba2-370m", {}),
    "hybrid": ("zamba2-1.2b", {}),
    "audio": ("seamless-m4t-large-v2", {}),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _batch(tcfg, seed=2, b=B, s=S):
    """tokens and labels (B, S), and 0.02·N(0, 1) ``embeds`` (B, prefix, d)
    for the vlm and audio families, as numpy arrays."""
    rng = np.random.default_rng(seed)
    arrays = {
        "tokens": _tokens(tcfg, seed=seed, shape=(b, s)),
        "labels": rng.integers(0, tcfg.vocab_size, (b, s)).astype(np.int32),
    }
    if tcfg.family in ("vlm", "audio"):
        shape = (b, tcfg.prefix_tokens, tcfg.d_model)
        arrays["embeds"] = (0.02 * rng.standard_normal(shape)).astype(np.float32)
    return arrays


def _torch(arrays):
    return {k: torch.from_numpy(v) for k, v in arrays.items()}


def _jnp(arrays):
    return {k: jnp.asarray(v) for k, v in arrays.items()}


def _leaf(tree, path, index):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)[index] if index else np.asarray(tree)


def assert_grads_match(module, jgrads, tol=TOL):
    """Every parameter's ``.grad`` against the reference's gradient leaf,
    within ``tol`` of that leaf's largest magnitude."""
    n = 0
    for path, index, p in bridge._zoo_leaves(module):
        want = _leaf(jgrads, path, index)
        got = p.grad.numpy() if p.grad is not None else np.zeros_like(want)
        scale = max(np.abs(want).max(), 1e-30)
        assert np.abs(got - want).max() <= tol * scale, ("/".join(path), index)
        n += 1
    return n


def _loss_and_grads(setup, arrays):
    _, _, jmodel, tmodel, jparams, tparams = setup
    jloss, jgrads = jax.value_and_grad(jmodel.loss_fn)(jparams, _jnp(arrays))
    tparams.zero_grad()
    loss = tmodel.loss_fn(tparams, _torch(arrays))
    loss.backward()
    return float(jloss), jgrads, loss


@pytest.mark.parametrize("family", ["dense", "mla", "moe"])
def test_loss_and_gradients_match_the_reference(family):
    name, changes = FAMILIES[family]
    setup = family_setup(name, **changes)
    tcfg, tparams = setup[1], setup[5]
    assert tcfg.remat  # the reduced configs checkpoint their blocks
    jloss, jgrads, loss = _loss_and_grads(setup, _batch(tcfg))
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert abs(loss.item() - jloss) <= TOL * abs(jloss)
    assert assert_grads_match(tparams, jgrads) == len(list(tparams.parameters()))


@pytest.mark.parametrize("family", ["moe", "mla"])
def test_moe_aux_term_at_the_configs_own_capacity(family):
    """At the config's own capacity factor tokens drop past capacity, in
    the reference's token-major order: the loss with its 0.01·aux term and
    every gradient still match; the aux term alone is the reference's
    ``moe_apply`` aux, and its router gradient ``jax.grad``'s."""
    name, _ = FAMILIES[family]
    setup = family_setup(name)
    jcfg, tcfg, _, tmodel, jparams, tparams = setup
    assert tcfg.moe.capacity_factor < 8.0
    jloss, jgrads, loss = _loss_and_grads(setup, _batch(tcfg, seed=5))
    assert abs(loss.item() - jloss) <= TOL * abs(jloss)
    assert_grads_match(tparams, jgrads)

    x = np.random.default_rng(6).standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    block = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"]["moe"])

    def jaux(p):
        return jx_moe.moe_apply(p, jnp.asarray(x), jcfg)[1]

    want, want_g = jax.value_and_grad(jaux)(block)
    mod = tparams.blocks[0].moe
    mod.zero_grad()
    _, aux = moe.moe_apply(mod, torch.from_numpy(x), tcfg)
    aux.backward()
    assert abs(aux.item() - float(want)) <= TOL * abs(float(want))
    g = np.asarray(want_g["router"])
    assert np.abs(mod.router.grad.numpy() - g).max() <= TOL * np.abs(g).max()
