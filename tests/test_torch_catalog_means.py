"""The port's metrics on ``credit/parties-4`` over seeds 0-3 against the
reference's, on the reference's splits (rule (a)) at the scenario's
budgets: the mean one-shot and few-shot AUCs within METRIC_GAP of the
reference's. PyTorch cannot replay JAX's random streams, so single runs
differ; the means over four seeds hold the four-party protocol (step ③'s
stacked k-means over K = 4, ③''s width-3 Eq. 10 launches) to the
reference's quality. The reference runs seed-batched (``run_seeds``), so
its side compiles once."""

import jax
import numpy as np
import pytest

from repro import scenarios as jscen
from repro.core import ProtocolConfig as RefConfig
from repro.core import run_few_shot as ref_few_shot
from repro.core import run_one_shot as ref_one_shot
from repro.core.protocol import run_seeds
from repro_torch.core import protocol as tproto
from repro_torch.data import split_from_numpy

from test_torch_catalog import (  # noqa: F401 (one_torch_thread: an autouse fixture)
    one_torch_thread,
    port_run,
)

NAME = "credit/parties-4"
SEEDS = (0, 1, 2, 3)
# Four seeds of 360 test rows: the standard error of a mean AUC is about
# 0.01, so two means of the same quality sit within 0.03.
METRIC_GAP = 0.03


@pytest.fixture(scope="module")
def metrics():
    bundles = [jscen.build(NAME, seed=s) for s in SEEDS]
    spec = bundles[0].spec
    budgets = dict(
        client_epochs=spec.budget("client_epochs", 20),
        server_epochs=spec.budget("server_epochs", 50),
    )
    args = (
        [jax.random.PRNGKey(s) for s in SEEDS],
        [b.split for b in bundles],
        [b.extractors for b in bundles],
        [b.ssl_cfgs for b in bundles],
        RefConfig(**budgets),
    )
    ref = {
        "one-shot": [r.metric for r in run_seeds(ref_one_shot, *args)],
        "few-shot": [r.metric for r in run_seeds(ref_few_shot, *args)],
    }
    port = [
        port_run(tproto.run_few_shot, NAME, split_from_numpy(b.split, "cpu"), seed=s, **budgets)
        for s, b in zip(SEEDS, bundles)
    ]
    got = {
        "one-shot": [r.diagnostics["one_shot_metric"] for r in port],
        "few-shot": [r.metric for r in port],
    }
    assert all(r.metric_name == "auc" for r in port)
    return got, ref


@pytest.mark.parametrize("protocol", ["one-shot", "few-shot"])
def test_mean_metric_within_the_gap_of_the_references(metrics, protocol):
    got, ref = (np.array(m[protocol]) for m in metrics)
    assert abs(got.mean() - ref.mean()) < METRIC_GAP, (got, ref)
    assert (got > 0.6).all()  # the reference's bar for a tabular run
