"""The batch mesh over the protocol folds' entry axis.

Counterpart of ``tests/test_sharded_frontier.py`` for one-shot and
few-shot, at its sizes: the reference's ``make_tabular_credit(PRNGKey(5000),
700)`` split through numpy (rule (a)), N_o 48, features 11 / 11, MLP
extractors (rep 8, hidden 16), 2 client and 3 server epochs, engine mode
"vmap". The reference shards over 8 forced host devices; the port's mesh
repeats the CPU in its slots, which runs the same pad, split, per-slot and
gather path. What is held here:

* ``engine.parallel``'s padding helpers equal the reference's on the same
  numpy-made arrays, and ``resolve_mesh`` normalises as the reference's;
* one-shot and few-shot on 2 slots equal the unsharded fold over seeds 0-1
  at 1e-5 on the metric and every parameter leaf, with equal ledgers and
  ``device_fold`` 2 against 1;
* 3 seeds on 2 slots (3 → 4 entries) and on 4 slots (S·K 6 → 8), entry by
  entry;
* session keys carry the mesh and never the batch width;
* the per-party loop ignores the mesh (``device_fold`` 1);
* a faulted fold shards too;
* the sharded ledgers equal the reference's unsharded run's;
* a CUDA mesh without a card and a mixed mesh are refused.

The card's case, two slots of one card against the unsharded fold, is
``tests/test_torch_gpu.py::test_two_slots_of_one_card_equal_the_unsharded_fold``,
beside the other card tests, which run where JAX is not installed; this
file imports JAX.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ProtocolConfig as RefConfig
from repro.core import SSLConfig as RefSSL
from repro.core import run_few_shot as ref_few_shot
from repro.core import run_one_shot as ref_one_shot
from repro.core.protocol import run_seeds as ref_run_seeds
from repro.data import make_tabular_credit, make_vfl_partition
from repro.engine import parallel as ref_parallel
from repro.models import make_mlp_extractor
from repro_torch.checkpoint.artifact import ExtractorSpec
from repro_torch.core.protocol import ProtocolConfig, run_few_shot, run_one_shot, run_seeds
from repro_torch.core.ssl import SSLConfig
from repro_torch.data import split_from_numpy
from repro_torch.engine import parallel, sessions
from repro_torch.launch.mesh import BatchMesh, make_batch_mesh
from repro_torch.scenarios.faults import FaultSpec

from test_torch_catalog import events, one_torch_thread  # noqa: F401 (autouse fixture)

TOL = 1e-5
FAST = ProtocolConfig(client_epochs=2, server_epochs=3, engine_mode="vmap")
SPECS = [ExtractorSpec("mlp", 8, hidden=(16,))] * 2
SSL = [SSLConfig(modality="tabular")] * 2
CPU = torch.device("cpu")
RUNNERS = {"one_shot": run_one_shot, "few_shot": run_few_shot}


def _ref_splits(seeds):
    x, y = make_tabular_credit(jax.random.PRNGKey(5000), 700)
    return [
        make_vfl_partition(x[:, :22], y, overlap_size=48, feature_sizes=[11, 11], seed=s)
        for s in seeds
    ]


_SPLITS = {}


def _splits(seeds):
    key = tuple(seeds)
    if key not in _SPLITS:
        _SPLITS[key] = [split_from_numpy(sp, "cpu") for sp in _ref_splits(seeds)]
    return _SPLITS[key]


def _run(runner, seeds, cfg=FAST, **kw):
    n = len(seeds)
    return run_seeds(runner, list(seeds), _splits(seeds), [SPECS] * n, [SSL] * n, cfg, device="cpu", **kw)


def _leaves(res):
    mods = [m for c in res.clients for m in (c.extractor, c.head)] + [res.server.classifier]
    mods += list(res.server.aux_classifiers)
    return [p.detach() for m in mods for p in m.parameters()]


def _assert_parity(sharded, single):
    assert len(sharded) == len(single)
    for a, b in zip(sharded, single):
        assert abs(a.metric - b.metric) <= TOL, (a.metric, b.metric)
        assert events(a.ledger) == events(b.ledger)
        assert a.ledger.total_bytes() == b.ledger.total_bytes()
        assert a.ledger.comm_times() == b.ledger.comm_times()
        assert a.ledger.by_tag() == b.ledger.by_tag()
        for p, q in zip(_leaves(a), _leaves(b), strict=True):
            torch.testing.assert_close(p, q, atol=TOL, rtol=0)
        for key in ("kernel_fold", "seed_fold", "engine_path"):
            assert a.diagnostics[key] == b.diagnostics[key], key


def _mesh(n):
    return BatchMesh((CPU,) * n)


# ------------------------------------------------------------------ (a)
def _tree(rng, width):
    return {
        "w": rng.standard_normal((width, 3, 2)).astype(np.float32),
        "layers": [rng.standard_normal((width, 4)).astype(np.float32)],
        "pair": (rng.integers(0, 9, (width,)), rng.standard_normal((width, 1)).astype(np.float32)),
    }


def _flat(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


class _Slots:
    """What the reference's helpers read of a mesh: its size."""

    def __init__(self, size):
        self.size = size


@pytest.mark.parametrize("width,slots", [(1, 2), (3, 2), (4, 2), (6, 4), (5, 3), (3, 1)])
def test_padding_helpers_equal_the_references(width, slots):
    rng = np.random.default_rng(width * 10 + slots)
    tree = _tree(rng, width)
    ours = BatchMesh((CPU,) * slots)
    pad = parallel.pad_width(width, ours)
    assert pad == ref_parallel.pad_width(width, _Slots(slots))
    assert parallel.pad_entries(list("abcdef")[:width], ours) == ref_parallel.pad_entries(
        list("abcdef")[:width], _Slots(slots)
    )
    got = parallel.pad_stacked(jax.tree_util.tree_map(torch.from_numpy, tree), pad)
    want = ref_parallel.pad_stacked(jax.tree_util.tree_map(jnp.asarray, tree), pad)
    for a, b in zip(_flat(jax.tree_util.tree_map(lambda t: t.numpy(), got)), _flat(want), strict=True):
        np.testing.assert_array_equal(a, b)
    back = parallel.strip_stacked(got, width)
    ref_back = ref_parallel.strip_stacked(want, width)
    for a, b in zip(_flat(jax.tree_util.tree_map(lambda t: t.numpy(), back)), _flat(ref_back), strict=True):
        np.testing.assert_array_equal(a, b)


def test_resolve_mesh_normalises_as_the_references():
    assert parallel.resolve_mesh(None) is None
    for width in (0, 1):
        assert parallel.resolve_mesh(width, "cpu") is None
    assert parallel.resolve_mesh(_mesh(1)) is None
    two = parallel.resolve_mesh(2, "cpu")
    assert two == make_batch_mesh(2, "cpu") == _mesh(2)
    assert parallel.resolve_mesh(two) is two  # idempotent
    assert (parallel.device_fold(None), parallel.device_fold(two)) == (1, 2)
    with pytest.raises(TypeError):
        parallel.resolve_mesh(True)
    # the key is the reference's: axis names and shape, never the devices
    ref_key = ref_parallel.mesh_key(jax.make_mesh((1,), ("batch",)))
    assert parallel.mesh_key(_mesh(1)) == ref_key == (("batch",), (1,))
    assert parallel.mesh_key(two) == (("batch",), (2,))
    assert parallel.mesh_key(None) is ref_parallel.mesh_key(None) is None


def test_shard_step_splits_in_slot_order_and_gathers_home():
    x = torch.arange(24.0).reshape(6, 4)
    seen = []

    def fn(a, scale, parts):
        seen.append(a.shape[0])
        return {"y": a * scale, "z": [p.sum(-1) for p in parts]}

    got = parallel.shard_step(fn, _mesh(3))(x, 2.0, [x, x + 1])
    assert seen == [2, 2, 2]
    torch.testing.assert_close(got["y"], x * 2.0)
    torch.testing.assert_close(got["z"][1], (x + 1).sum(-1))
    with pytest.raises(ValueError, match="pad it first"):
        parallel.shard_step(fn, _mesh(4))(x, 1.0, [x])


# ------------------------------------------------------------------ (b)
@pytest.mark.parametrize("runner", list(RUNNERS))
def test_two_slots_equal_the_unsharded_fold(runner):
    single = _run(RUNNERS[runner], (0, 1))
    sharded = _run(RUNNERS[runner], (0, 1), dataclasses.replace(FAST, mesh=2))
    _assert_parity(sharded, single)
    assert [r.diagnostics["device_fold"] for r in single] == [1, 1]
    assert [r.diagnostics["device_fold"] for r in sharded] == [2, 2]
    assert sharded[0].diagnostics["kernel_fold"] == 4  # S·K real entries, never the padded


# ------------------------------------------------------------------ (c)
@pytest.mark.parametrize("slots", [2, 4], ids=["pad-3-to-4", "pad-3x2-to-8"])
def test_padded_folds_equal_the_unsharded_entry_by_entry(slots):
    seeds = (0, 1, 2)
    single = _run(run_one_shot, seeds)
    sharded = _run(run_one_shot, seeds, dataclasses.replace(FAST, mesh=_mesh(slots)))
    _assert_parity(sharded, single)
    assert {r.diagnostics["device_fold"] for r in sharded} == {slots}


# ------------------------------------------------------------------ (d)
def test_session_keys_carry_the_mesh_never_the_width():
    sessions.clear_session_cache()
    _run(run_few_shot, (0, 1))
    warm = copy.deepcopy(sessions.session_cache_stats_by_domain())
    sharded = dataclasses.replace(FAST, mesh=2)
    _run(run_few_shot, (0, 1), sharded)
    first = copy.deepcopy(sessions.session_cache_stats_by_domain())
    fresh = {d: first[d]["misses"] - warm[d]["misses"] for d in first}
    # the cold unsharded run's builds, once more under the mesh's keys
    assert fresh == {d: s["misses"] for d, s in warm.items()}, (fresh, warm)
    assert sorted(fresh) == ["fewshot_gate", "kmeans", "sdpa", "server_fit", "ssl"]

    _run(run_few_shot, (0, 1, 2), sharded)  # a new width on the same mesh shape
    _run(run_few_shot, (0, 1, 2), dataclasses.replace(FAST, mesh=_mesh(2)))  # other slots, same key
    second = sessions.session_cache_stats_by_domain()
    assert {d: s["misses"] for d, s in second.items()} == {d: s["misses"] for d, s in first.items()}

    _run(run_few_shot, (0, 1))  # unsharded again
    third = sessions.session_cache_stats_by_domain()
    assert {d: s["misses"] for d, s in third.items()} == {d: s["misses"] for d, s in first.items()}


# ------------------------------------------------------------------ (e)
@pytest.mark.parametrize("runner", list(RUNNERS))
def test_the_per_party_loop_ignores_the_mesh(runner):
    looped = dataclasses.replace(FAST, mesh=2, engine_mode="python")
    got = _run(RUNNERS[runner], (0, 1), looped)
    want = _run(RUNNERS[runner], (0, 1), dataclasses.replace(FAST, engine_mode="python"))
    _assert_parity(got, want)
    for r in got:
        assert (r.diagnostics["engine_path"], r.diagnostics["device_fold"]) == ("python", 1)


# ------------------------------------------------------------------ (f)
@pytest.mark.parametrize(
    "fault",
    [FaultSpec("straggler", party=1, epoch_fraction=0.5), FaultSpec("dropout", party=1, stage="post_ssl")],
    ids=["straggler", "dropout"],
)
def test_a_faulted_fold_shards_too(fault):
    seeds = (0, 1, 2)
    faults = [fault, None, fault]
    single = _run(run_one_shot, seeds, faults=faults)
    sharded = _run(run_one_shot, seeds, dataclasses.replace(FAST, mesh=2), faults=faults)
    _assert_parity(sharded, single)
    for a, b in zip(sharded, single):
        assert a.diagnostics["parties_survived"] == b.diagnostics["parties_survived"]
        assert a.diagnostics["device_fold"] == 2


# ------------------------------------------------------------------ (g)
@pytest.mark.parametrize("runner", list(RUNNERS))
def test_sharded_ledgers_equal_the_references_unsharded_run(runner):
    ref_runner = {"one_shot": ref_one_shot, "few_shot": ref_few_shot}[runner]
    seeds = (0, 1)
    ref = ref_run_seeds(
        ref_runner,
        [jax.random.PRNGKey(s) for s in seeds],
        _ref_splits(seeds),
        [[make_mlp_extractor(rep_dim=8, hidden=(16,)) for _ in range(2)] for _ in seeds],
        [[RefSSL(modality="tabular")] * 2 for _ in seeds],
        RefConfig(client_epochs=1, server_epochs=1, engine_mode="vmap"),
    )
    cfg = ProtocolConfig(client_epochs=1, server_epochs=1, engine_mode="vmap", mesh=2)
    got = _run(RUNNERS[runner], seeds, cfg)
    for g, r in zip(got, ref, strict=True):
        assert events(g.ledger) == events(r.ledger)
        assert g.ledger.summary() == r.ledger.summary()
        assert g.diagnostics["device_fold"] == 2


# ------------------------------------------------------------------ (h)
@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card error cannot show")


@pytest.mark.parametrize(
    "make",
    [lambda: make_batch_mesh(2, "cuda"), lambda: BatchMesh(("cuda:0", "cuda:0")), lambda: BatchMesh(("cuda",))],
    ids=["make_batch_mesh", "explicit", "unindexed"],
)
def test_a_cuda_mesh_without_a_card_is_refused(no_card, make):
    with pytest.raises(ValueError, match="visible"):
        make()


@pytest.mark.parametrize(
    "devices", [("cpu", "cuda:0"), ("cuda:0", "cpu"), ("cpu", "meta")], ids=["cpu-cuda", "cuda-cpu", "cpu-meta"]
)
def test_a_mixed_mesh_is_refused(devices):
    with pytest.raises(ValueError, match="mixes device types"):
        BatchMesh(devices)


def test_a_mesh_never_shrinks_and_never_leaves_the_folds_device_type():
    with pytest.raises(ValueError, match="at least one slot"):
        make_batch_mesh(0, "cpu")
    with pytest.raises(ValueError, match="at least one"):
        BatchMesh(())
    if torch.cuda.is_available():  # a CUDA mesh over a fold on the CPU
        cfg = dataclasses.replace(FAST, mesh=BatchMesh(("cuda:0", "cuda:0")))
        with pytest.raises(ValueError, match="cannot shard a fold on cpu"):
            _run(run_one_shot, (0, 1), cfg)
