"""Train few-shot VFL (Alg. 2) on a named scenario and print its result.

    PYTHONPATH=src python -m repro_torch.launch.few_shot --device cpu
    PYTHONPATH=src python -m repro_torch.launch.few_shot --scenario hard/overlap-64  # on the GPU

The port's counterpart of ``examples/fewshot_tabular.py``: the scenario's
data is drawn with the port's own generators, the run uses the scenario's
training budgets, and the output is the few-shot metric beside its one-shot
pass's, the Eq. 9 gate and take rates of each party, the per-step times, the
comm times (5) and the communication ledger. Without ``--device cpu`` it
runs on ``cuda`` and raises where there is no card.
"""

from __future__ import annotations

import argparse

from repro_torch import scenarios
from repro_torch.core.protocol import ProtocolConfig, run_few_shot


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    ap.add_argument(
        "--scenario", default=scenarios.HARD_OVERLAP_32.name, choices=sorted(scenarios.CATALOG)
    )
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    spec = scenarios.CATALOG[args.scenario]
    bundle = scenarios.build(spec, seed=args.seed, device=args.device)
    cfg = ProtocolConfig(
        client_epochs=spec.budget("client_epochs", 20),
        server_epochs=spec.budget("server_epochs", 50),
    )
    res = run_few_shot(
        args.seed, bundle.split, bundle.extractors, bundle.ssl_cfgs, cfg, device=args.device
    )
    d = res.diagnostics
    steps = " ".join(f"{k} {v:.1f}" for k, v in d["step_ms"].items())
    print(f"{spec.name} seed {args.seed} on {bundle.split.labels.device}")
    one = d["one_shot_metric"]
    print(f"test {res.metric_name:14s}: {res.metric:.4f}   (its one-shot pass: {one:.4f})")
    print(f"gate rate / party  : {[round(r, 4) for r in d['fewshot_gate_rate']]}")
    print(f"take rate / party  : {[round(r, 4) for r in d['fewshot_take_rate']]}")
    print(f"comm times/client  : {res.ledger.comm_times()}   (paper: 5)")
    print(f"step ms            : {steps}")
    print(res.ledger.summary())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
