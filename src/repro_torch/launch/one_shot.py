"""Train one-shot VFL (Alg. 1) on a named scenario and print its result.

    PYTHONPATH=src python -m repro_torch.launch.one_shot --device cpu
    PYTHONPATH=src python -m repro_torch.launch.one_shot --scenario credit/parties-4 --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.one_shot --scenario fault/dropout-pre-ssl --device cpu
    PYTHONPATH=src python -m repro_torch.launch.one_shot --seed 1   # on the GPU

The port's counterpart of ``examples/quickstart.py``: any registered
scenario (``--smoke``: its shrunk variant), its data drawn with the port's
own generators, the run at the scenario's training budgets; the output is
the metric, the step-③ k-means purity, the per-step times and the
communication ledger. A ``fault/*`` scenario runs under its fault and also
prints the fault diagnostics (kind, stage, parties left, the degraded
metric). Without ``--device cpu`` it runs on ``cuda`` and raises where
there is no card.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence, Tuple

from repro_torch import scenarios
from repro_torch.core.protocol import ProtocolConfig, run_one_shot


def parse_scenario_args(doc: str, argv: Optional[Sequence[str]]) -> argparse.Namespace:
    """The training CLIs' arguments: scenario, seed, smoke, device."""
    ap = argparse.ArgumentParser(
        description=doc, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    ap.add_argument(
        "--scenario", default=scenarios.HARD_OVERLAP_32.name, choices=scenarios.names()
    )
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true", help="the scenario's shrunk variant")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def scenario_run(
    args: argparse.Namespace,
) -> Tuple[scenarios.ScenarioSpec, scenarios.ScenarioBundle, ProtocolConfig]:
    """The scenario's bundle on ``args.device`` and its budgets as a
    protocol config."""
    spec = scenarios.get(args.scenario)
    bundle = scenarios.build(spec, seed=args.seed, smoke=args.smoke, device=args.device)
    cfg = ProtocolConfig(
        client_epochs=spec.budget("client_epochs", 20),
        server_epochs=spec.budget("server_epochs", 50),
    )
    return bundle.spec, bundle, cfg


def print_fault(diags: dict) -> None:
    """The fault diagnostics of a faulted run (nothing for a fault-free one)."""
    if "fault_kind" not in diags:
        return
    keys = ("fault_kind", "fault_stage", "parties_survived", "degraded_metric")
    print("fault              : " + " ".join(f"{k}={diags[k]}" for k in keys if k in diags))


def main(argv=None) -> int:
    args = parse_scenario_args(__doc__, argv)
    spec, bundle, cfg = scenario_run(args)
    res = run_one_shot(
        args.seed,
        bundle.split,
        bundle.extractors,
        bundle.ssl_cfgs,
        cfg,
        device=args.device,
        fault=spec.fault,
    )
    steps = " ".join(f"{k} {v:.1f}" for k, v in res.diagnostics["step_ms"].items())
    print(f"{spec.name} seed {args.seed} on {bundle.split.labels.device}")
    print(f"test {res.metric_name:14s}: {res.metric:.4f}")
    print(f"k-means purity     : {res.diagnostics['kmeans_purity']}")
    print(f"comm times/client  : {res.ledger.comm_times()}   (paper: 3)")
    print(f"step ms            : {steps}")
    print_fault(res.diagnostics)
    print(res.ledger.summary())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
