"""A zoo backbone as a VFL extractor in Alg. 1, and the training CLI.

The port's counterpart of ``tests/test_extensions.py::
test_zoo_backbone_extractor_in_protocol``: the reference's
``make_sequence_classification`` data and split (carried across as numpy),
a reduced phi4 (vocab 32, 2 layers) as both parties' extractor through
``ZooExtractorSpec``, token SSL, one-shot at 3 client and 10 server epochs.
The metric must clear the reference test's bar (0.4; chance 1/3) in 3 comm
times, and the ledger must be the reference's run of that split event for
event (``REFERENCE_LEDGER``: the reference's ``run_one_shot`` on this split,
whose events depend on shapes only; it takes ~25 s to compile, so it is
pinned here, and ``chip_smoke.py::ZOO_VFL_BYTES`` holds the card to it).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jx_load_checkpoint
from repro.configs import get_config as jx_get_config
from repro.data.synthetic import make_sequence_classification
from repro.data.vertical import VerticalSplit as JxSplit
from repro.models import model_zoo as jx_zoo
from repro_torch import bridge, optim
from repro_torch.checkpoint import ExtractorSpec, save_artifact
from repro_torch.configs import get_config
from repro_torch.core.protocol import ProtocolConfig, run_one_shot, run_seeds
from repro_torch.core.ssl import SSLConfig
from repro_torch.data import split_from_numpy
from repro_torch.engine import local_ssl, sessions
from repro_torch.launch import train
from repro_torch.models.zoo_extractor import ZooExtractor, ZooExtractorSpec

BAR = 0.4
# (party, direction, tag, bytes, round) of the reference's run of the split
REFERENCE_LEDGER = [
    (0, "up", "reps_overlap", 4096, 1),
    (1, "up", "reps_overlap", 4096, 1),
    (0, "down", "partial_grads", 4096, 2),
    (1, "down", "partial_grads", 4096, 2),
    (0, "up", "reps_overlap_refreshed", 4096, 3),
    (1, "up", "reps_overlap_refreshed", 4096, 3),
]
CFG = ProtocolConfig(client_epochs=3, server_epochs=10, client_lr=0.02)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def split():
    """The reference test's data and split, carried across (tokens become
    float32 features, as ``split_from_numpy`` casts every split)."""
    x, y = make_sequence_classification(
        jax.random.PRNGKey(0), 400, seq_len=16, vocab_size=32, num_classes=3
    )
    x, y = np.asarray(x), np.asarray(y)
    perm = np.random.RandomState(0).permutation(400)
    test, over, rest = perm[:80], perm[80:144], perm[144:]
    pool = np.array_split(rest, 2)
    ref = JxSplit(
        aligned=[x[over, :8], x[over, 8:]], labels=y[over],
        unaligned=[x[pool[0], :8], x[pool[1], 8:]],
        test_aligned=[x[test, :8], x[test, 8:]], test_labels=y[test],
        num_classes=3,
    )
    return split_from_numpy(ref, "cpu")


def _spec():
    cfg = dataclasses.replace(get_config("phi4-mini-3.8b").reduced(), vocab_size=32, num_layers=2)
    return ZooExtractorSpec(cfg, rep_dim=16)


@pytest.fixture(scope="module")
def result(split):
    spec = _spec()
    return run_one_shot(1, split, [spec] * 2, [SSLConfig(modality="token")] * 2, CFG, device="cpu")


def test_zoo_extractor_in_the_one_shot_protocol(result):
    assert result.metric > BAR
    assert result.ledger.comm_times() == 3
    got = [(e.party, e.direction, e.tag, e.bytes, e.round) for e in result.ledger.events]
    assert got == REFERENCE_LEDGER
    assert result.ledger.total_bytes() == 24576
    assert result.diagnostics["engine_path"] == "python"
    for c in result.clients:
        assert isinstance(c.extractor, ZooExtractor)
        assert c.feature_mean is not None and c.feature_mean.shape == (8,)  # computed, not read


def test_trained_extractors_moved_from_their_init(result):
    fresh = _spec().build((8,)).init_(torch.Generator().manual_seed(0))
    trained = result.clients[0].extractor
    moved = [
        (a - b).abs().max().item()
        for a, b in zip(trained.parameters(), fresh.parameters())
    ]
    assert max(moved) > 0.0 and trained.rep_head.grad is None


def test_an_untied_backbone_trains_as_an_extractor(split, monkeypatch):
    """mamba2's backbone, whose untied unembed no loss reaches, trains in
    the protocol: the SSL step gives that leaf a zero gradient, as
    ``jax.grad`` does, so its momentum SGD step leaves it as it was."""
    cfg = dataclasses.replace(get_config("mamba2-370m").reduced(), vocab_size=32)
    assert not cfg.tie_embeddings
    spec = ZooExtractorSpec(cfg, rep_dim=16)
    seen = []
    step = optim.ClippedSGD.step

    def recorded(self, grads):
        seen.extend(float(g.abs().max()) for p, g in zip(self.params, grads) if p.shape == (cfg.d_model, 32))
        return step(self, grads)

    monkeypatch.setattr(optim.ClippedSGD, "step", recorded)
    res = run_one_shot(
        0, split, [spec] * 2, [SSLConfig(modality="token")] * 2,
        dataclasses.replace(CFG, client_epochs=1, server_epochs=2), device="cpu",
    )
    assert res.ledger.total_bytes() == 24576
    assert seen and max(seen) == 0.0


def test_float_tokens_go_back_to_exact_ids():
    ext = _spec().build((8,)).init_(torch.Generator().manual_seed(0))
    ids = torch.randint(0, 32, (3, 8), dtype=torch.int32)
    with torch.no_grad():
        assert torch.equal(ext(ids.float()), ext(ids))


@pytest.mark.parametrize("seeds", [[0], [0, 1]])
def test_forced_vmap_over_zoo_extractors_raises(split, seeds):
    spec, ssl = _spec(), [SSLConfig(modality="token")] * 2
    cfg = dataclasses.replace(CFG, client_epochs=1, engine_mode="vmap")
    with pytest.raises(ValueError, match="cannot stack a model-zoo extractor"):
        run_seeds(run_one_shot, seeds, [split] * len(seeds), [[spec] * 2] * len(seeds),
                  [ssl] * len(seeds), cfg, device="cpu")
    assert not local_ssl.stack_pays(spec, 2, 4)
    assert sessions.module_spec(spec.build((8,))) is None


def test_save_artifact_refuses_a_zoo_extractor(result, split, tmp_path):
    art = result.to_artifact("zoo", split=split)
    with pytest.raises(ValueError, match="knows only 'mlp' and 'cnn'"):
        save_artifact(str(tmp_path / "art"), art)
    assert not (tmp_path / "art").exists()
    assert ExtractorSpec("mlp", 4).kind == "mlp"  # the kinds that do save


def test_train_cli_saves_what_the_reference_loads(tmp_path, capsys):
    argv = ["--arch", "mamba2-370m", "--reduce", "--steps", "3", "--batch", "2", "--seq", "32"]
    assert train.main(argv + ["--log-every", "1", "--ckpt-dir", str(tmp_path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    losses = [float(line.split("loss ")[1].split()[0]) for line in out.splitlines() if line.startswith("step")]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert "arch=mamba2-370m params=" in out and "saved " in out
    jcfg = jx_get_config("mamba2-370m").reduced()
    template = jx_zoo.build_model(jcfg).init(jax.random.PRNGKey(0))
    tree, meta = jx_load_checkpoint(str(tmp_path), template)
    assert meta["arch"] == "mamba2-370m" and meta["step"] == 3
    assert meta["loss"] == pytest.approx(losses[-1], abs=1e-4)
    # the same run in memory (deterministic on the CPU): its parameters are
    # the saved leaves, bit for bit
    params, loss = train.train(get_config("mamba2-370m").reduced(), 3, 2, 32, device="cpu")
    assert loss == meta["loss"]
    want = bridge.zoo_params_to_reference(params)
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_train_cli_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card error cannot show")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "mamba2-370m", "--reduce", "--steps", "1"])
