"""Train few-shot VFL (Alg. 2) on a named scenario and print its result.

    PYTHONPATH=src python -m repro_torch.launch.few_shot --device cpu
    PYTHONPATH=src python -m repro_torch.launch.few_shot --scenario image/patch-4 --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.few_shot --scenario hard/overlap-64  # on the GPU

The port's counterpart of ``examples/fewshot_tabular.py``: any registered
scenario (``--smoke``: its shrunk variant), its data drawn with the port's
own generators, the run at the scenario's training budgets; the output is
the few-shot metric beside its one-shot pass's, the Eq. 9 gate and take
rates of each party, the per-step times, the comm times (5) and the
communication ledger; for a ``fault/*`` scenario, run under its fault, the
fault diagnostics too. Without ``--device cpu`` it runs on ``cuda`` and raises where there is no
card.
"""

from __future__ import annotations

from repro_torch.core.protocol import run_few_shot
from repro_torch.launch.one_shot import parse_scenario_args, print_fault, scenario_run


def main(argv=None) -> int:
    args = parse_scenario_args(__doc__, argv)
    spec, bundle, cfg = scenario_run(args)
    res = run_few_shot(
        args.seed,
        bundle.split,
        bundle.extractors,
        bundle.ssl_cfgs,
        cfg,
        device=args.device,
        fault=spec.fault,
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
    print_fault(d)
    print(res.ledger.summary())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
