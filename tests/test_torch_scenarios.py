"""The port's scenario registry, catalog and data layouts against the
reference's (``repro.scenarios``, ``repro.data``), on the CPU.

* the registry holds the reference's 27 names, and every spec equals the
  reference's field for field (``FaultSpec``s included), shrunk by
  ``smoke()`` alike; its errors are the reference's;
* ``make_tabular_credit``'s deterministic part, fed the reference's own
  draws, gives the reference's features (within 1e-6, relative above 1)
  and labels (equal), at 2 and 4 classes;
* ``split_image_patches`` and ``make_vfl_partition`` (patch grid, padded
  capacity) split one numpy array exactly as the reference does;
* every scenario builds on the CPU with the layout its spec implies, and
  the training CLIs take every name and run a fault scenario under its
  fault.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import scenarios as jscen
from repro.data import synthetic as jsyn
from repro.data import vertical as jvert
from repro_torch import scenarios
from repro_torch.data import synthetic, vertical
from repro_torch.launch import few_shot, one_shot

NAMES = jscen.names()
# features: latent @ mix sums D products in f32 in another order than XLA's
X_TOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def test_names_are_the_references():
    assert scenarios.names() == NAMES
    assert len(NAMES) == 27
    assert sorted(scenarios.CATALOG) == NAMES
    assert scenarios.HARD_OVERLAP_32 is scenarios.get("hard/overlap-32")
    assert scenarios.HARD_OVERLAP_64 is scenarios.get("hard/overlap-64")


def test_spec_fields_are_the_references():
    port = [(f.name, f.default) for f in dataclasses.fields(scenarios.ScenarioSpec)]
    ref = [(f.name, f.default) for f in dataclasses.fields(jscen.ScenarioSpec)]
    assert port == ref
    port = [(f.name, f.default) for f in dataclasses.fields(scenarios.FaultSpec)]
    assert port == [(f.name, f.default) for f in dataclasses.fields(jscen.FaultSpec)]


@pytest.mark.parametrize("name", NAMES)
def test_spec_equals_the_references(name):
    port, ref = scenarios.get(name), jscen.get(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.smoke()) == dataclasses.asdict(ref.smoke())
    assert hash(dataclasses.replace(port)) == hash(port)
    assert [s.name for s in scenarios.by_tag(ref.tags[0])] == [
        s.name for s in jscen.by_tag(ref.tags[0])
    ]
    if ref.fault is not None:
        for party in range(ref.num_parties):
            assert port.fault.skips_ssl(party) == ref.fault.skips_ssl(party)
            for point in range(5):
                assert port.fault.drops(party, point) == ref.fault.drops(party, point)
        assert port.fault.parties_survived(4) == ref.fault.parties_survived(4)
        assert port.fault.iterative_active_steps(200) == ref.fault.iterative_active_steps(200)


def test_registry_errors_are_the_references():
    spec = scenarios.get("hard/overlap-32")
    assert spec.budget("client_epochs", 1) == 80 and spec.budget("not-a-budget", 7) == 7
    with pytest.raises(ValueError, match="already registered"):
        scenarios.register(spec)
    with pytest.raises(KeyError, match="unknown scenario 'no/such-scenario'; registered: "):
        scenarios.get("no/such-scenario")
    with pytest.raises(KeyError):
        jscen.get("no/such-scenario")
    bad = dataclasses.replace(spec, name="no/such-generator", generator="nope")
    with pytest.raises(ValueError, match="unknown generator 'nope'"):
        scenarios.register(bad)
    bad_ref = dataclasses.replace(
        jscen.get("hard/overlap-32"), name="no/such-generator", generator="nope"
    )
    with pytest.raises(ValueError, match="unknown generator 'nope'"):
        jscen.register(bad_ref)
    assert "no/such-generator" not in scenarios.names()
    assert sorted(scenarios.GENERATORS) == sorted(jscen.GENERATORS)
    with pytest.raises(ValueError, match="bad"):
        scenarios.FaultSpec(kind="bad")


@pytest.mark.parametrize(
    "seed,n,d,classes,noise", [(1000, 1500, 23, 2, 0.05), (1003, 1800, 40, 2, 0.05),
                               (7, 1001, 23, 4, 0.25), (1001, 1500, 23, 2, 0.25)]
)
def test_tabular_credit_from_the_references_draws(seed, n, d, classes, noise):
    key = jax.random.PRNGKey(seed)
    x_r, y_r = jsyn.make_tabular_credit(
        key, n, num_features=d, num_classes=classes, label_noise=noise
    )
    k_mix, k_x, k_w, k_flip = jax.random.split(key, 4)
    draws = (
        jax.random.normal(k_x, (n, d)),
        jax.random.normal(k_mix, (d, d)),
        jax.random.normal(k_w, (d,)),
        jax.random.uniform(k_flip, (n,)),  # bernoulli(k, p) is uniform(k) < p
    )
    x, y = synthetic.tabular_credit_from_draws(*map(_t, draws), classes, noise)
    torch.testing.assert_close(x, _t(x_r), atol=X_TOL, rtol=X_TOL)
    np.testing.assert_array_equal(y.numpy(), np.asarray(y_r))
    assert y.dtype == torch.int64 and sorted(set(y.tolist())) == list(range(classes))


def test_tabular_credit_draws_on_its_device():
    x, y = synthetic.make_tabular_credit(600, seed=3, device="cpu", num_features=32)
    assert x.shape == (600, 32) and x.dtype == torch.float32 and y.dtype == torch.int64
    # the 2-class cut is the logits' median: the classes balance up to the flips
    assert abs(float(y.float().mean()) - 0.5) < 0.05
    x2, y2 = synthetic.make_tabular_credit(600, seed=3, device="cpu", num_features=32)
    assert torch.equal(x, x2) and torch.equal(y, y2)


def _images(n=40, h=16, w=15, c=3):
    return np.random.default_rng(0).standard_normal((n, h, w, c)).astype(np.float32)


@pytest.mark.parametrize("grid", [(2, 2), (1, 3), (3, 2)])
def test_image_patches_are_the_references(grid):
    x = _images()
    want = jvert.split_image_patches(jnp.asarray(x), grid)
    got = vertical.split_image_patches(_t(x), grid)
    assert len(got) == len(want) == grid[0] * grid[1]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _assert_splits_equal(port, ref):
    for name in ("aligned", "unaligned", "test_aligned", "unaligned_labels"):
        got, want = getattr(port, name), getattr(ref, name)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.is_contiguous()
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(port.labels.numpy(), np.asarray(ref.labels))
    np.testing.assert_array_equal(port.test_labels.numpy(), np.asarray(ref.test_labels))
    assert port.num_classes == ref.num_classes
    if ref.aligned_mask is None:
        assert port.aligned_mask is None
    else:
        assert port.aligned_mask.dtype == torch.float32
        np.testing.assert_array_equal(port.aligned_mask.numpy(), np.asarray(ref.aligned_mask))


def test_patch_partition_is_the_references():
    x, y = _images(200, 16, 16), np.arange(200) % 4
    kw = dict(overlap_size=48, num_parties=4, seed=3, image_grid=(2, 2))
    ref = jvert.make_vfl_partition(jnp.asarray(x), jnp.asarray(y), **kw)
    port = vertical.make_vfl_partition(_t(x), _t(y), **kw)
    _assert_splits_equal(port, ref)
    assert [tuple(a.shape[1:]) for a in port.aligned] == [(8, 8, 3)] * 4
    with pytest.raises(ValueError, match="grid"):
        vertical.make_vfl_partition(_t(x), _t(y), 48, num_parties=3, image_grid=(2, 2))


def test_padded_partition_is_the_references_and_shares_its_pools():
    x = np.random.default_rng(1).standard_normal((3000, 40)).astype(np.float32)
    y = np.random.default_rng(2).integers(0, 2, 3000)
    splits = {}
    for n_o in (32, 64):
        kw = dict(overlap_size=n_o, feature_sizes=(20, 20), seed=0, overlap_capacity=64)
        ref = jvert.make_vfl_partition(jnp.asarray(x), jnp.asarray(y), **kw)
        port = vertical.make_vfl_partition(_t(x), _t(y), **kw)
        _assert_splits_equal(port, ref)
        assert port.aligned[0].shape[0] == 64
        assert float(port.aligned_mask.sum()) == n_o
        splits[n_o] = port
    # the padding repeats the real rows cyclically, and both members share the pools
    a32 = splits[32].aligned[0]
    assert torch.equal(a32[32:], a32[:32])
    assert torch.equal(a32[:32], splits[64].aligned[0][:32])
    for u32, u64 in zip(splits[32].unaligned, splits[64].unaligned):
        assert torch.equal(u32, u64)
    with pytest.raises(ValueError, match="capacity"):
        vertical.make_vfl_partition(_t(x), _t(y), 65, overlap_capacity=64)


def test_split_from_numpy_carries_the_mask():
    bundle = jscen.build("hard/overlap-32-eq", seed=0)
    port = vertical.split_from_numpy(bundle.split, device="cpu")
    _assert_splits_equal(port, bundle.split)
    assert float(port.aligned_mask.sum()) == 32 and port.aligned_mask.shape == (64,)
    plain = vertical.split_from_numpy(jscen.build("hard/overlap-32", seed=0).split, "cpu")
    assert plain.aligned_mask is None


@pytest.mark.parametrize("name", NAMES)
def test_every_scenario_builds_on_the_cpu(name):
    """The port's own data at smoke sizes: the layout the spec implies, with
    the reference's shapes (the row counts come from the same partition)."""
    bundle = scenarios.build(name, seed=0, smoke=True, device="cpu")
    spec, split = bundle.spec, bundle.split
    want = jscen.build(name, seed=0, smoke=True).split
    assert len(split.aligned) == spec.num_parties == len(bundle.extractors)
    assert len(bundle.ssl_cfgs) == spec.num_parties
    for part in ("aligned", "unaligned", "test_aligned"):
        got = [tuple(a.shape) for a in getattr(split, part)]
        assert got == [tuple(a.shape) for a in getattr(want, part)]
    assert split.num_classes == want.num_classes
    assert (split.aligned_mask is None) == (spec.overlap_capacity is None)
    if spec.name == "edge/full-overlap":
        assert all(u.shape[0] == 0 for u in split.unaligned)
    for e in bundle.extractors:
        assert e.rep_dim == spec.rep_dim
        assert e.kind == ("cnn" if spec.modality == "image" else "mlp")


@pytest.mark.parametrize("cli", [one_shot, few_shot])
def test_clis_take_every_name_and_refuse_faults(cli, monkeypatch, capsys):
    """Both CLIs take every name; a fault/* scenario, which they once
    refused, runs under its fault (here ``fault/dropout-pre-ssl`` at
    ``--smoke --device cpu``, its budgets cut to 2 epochs) and prints the
    fault diagnostics."""
    faulted = [n for n in NAMES if scenarios.get(n).fault is not None]
    assert len(faulted) == 8 and "fault/none" not in faulted
    for name in NAMES:
        args = one_shot.parse_scenario_args("", ["--scenario", name, "--smoke"])
        assert args.scenario == name and args.smoke
    get = scenarios.get
    budgets = (("client_epochs", 2), ("server_epochs", 2), ("iterations", 8))
    monkeypatch.setattr(scenarios, "get", lambda n: dataclasses.replace(get(n), budgets=budgets))
    assert cli.main(["--scenario", "fault/dropout-pre-ssl", "--smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "fault/dropout-pre-ssl seed 0 on cpu" in out
    fault_line = next(ln for ln in out.splitlines() if ln.startswith("fault "))
    for field in ("fault_kind=dropout", "fault_stage=pre_ssl", "parties_survived=3",
                  "degraded_metric="):
        assert field in fault_line, fault_line
    # party 1's missing uploads: 20480 or 147392 bytes, as the ledger table prints them
    total = 20480 if cli is one_shot else 147392
    assert f"total: {total / 2**20:.2f} MB" in out
