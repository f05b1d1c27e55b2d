"""Where a batch-mesh run leaves the unsharded fold, stage by stage (the
PyTorch port).

    python3 benchmarks/torch_mesh_parity.py [--device cuda] [--client-epochs 5 20] \
        [--seeds 4] [--slots 2]

On ``hard/overlap-32`` over seeds 0..S−1 at its budget with the given client
epochs, it runs one-shot, few-shot and few-shot + finetune (200 finetune
iterations) as one ``run_seeds`` fold unsharded and on a mesh of ``--slots``
slots of the fold's device (``BatchMesh((cuda:0,) * slots)`` on the card),
then vanilla SplitNN at the finetune's rates (200 iterations, a tenth of the
learning rates) from fresh parameters, then the unsharded few-shot fold
twice (the run-to-run floor). A line a stage and seed gives the largest
difference of the metric and of each module's leaves (``ext{k}``,
``head{k}``, ``clf``, ``aux{k}``); few-shot lines add step ③''s H_u, Eq.
10 estimates and p̂ per party and the gate decisions that differ; lines of
an iterative session add its losses. The stages run in protocol order, so
the first stage whose leaves differ is where the slot width changed the
rounding. The last lines are the card's ``nvidia-smi`` name and power limit
and one JSON object with every row. Imports the port only, never JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch import scenarios  # noqa: E402
from repro_torch.core import baselines  # noqa: E402
from repro_torch.core.protocol import (  # noqa: E402
    ProtocolConfig,
    run_few_shot,
    run_few_shot_finetune,
    run_one_shot,
    run_seeds,
)
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.mesh import BatchMesh  # noqa: E402

SCENARIO = "hard/overlap-32"
FINETUNE_ITERATIONS = 200


def gpu_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def _gap(a, b) -> float:
    return max([(x - y).abs().max().item() for x, y in zip(a, b)] or [0.0])


def _modules(res) -> dict:
    out = {}
    for k, c in enumerate(res.clients):
        out[f"ext{k}"] = list(c.extractor.parameters())
        out[f"head{k}"] = list(c.head.parameters())
    out["clf"] = list(res.server.classifier.parameters())
    for k, m in enumerate(res.server.aux_classifiers):
        out[f"aux{k}"] = list(m.parameters())
    return out


def compare(stage: str, seeds, got, want) -> list:
    """One row a seed: the largest difference of ``got`` against ``want``."""
    rows = []
    for seed, a, b in zip(seeds, got, want, strict=True):
        ma, mb = _modules(a), _modules(b)
        row = {"stage": stage, "seed": seed, "metric": abs(a.metric - b.metric),
               "modules": {k: _gap(ma[k], mb[k]) for k in ma}}
        if "fewshot_step3p" in b.diagnostics:
            pa, pb = a.diagnostics["fewshot_step3p"], b.diagnostics["fewshot_step3p"]
            row["h_u"] = [_gap([x], [y]) for x, y in zip(pa["h_u"], pb["h_u"])]
            row["estimates"] = [_gap(x, y) for x, y in zip(pa["estimates"], pb["estimates"])]
            row["probs"] = [_gap([x], [y]) for x, y in zip(pa["probs"], pb["probs"])]
            row["gate_flips"] = [int(((x > 0) != (y > 0)).sum()) for x, y in zip(pa["probs"], pb["probs"])]
        if "losses" in b.diagnostics:
            row["losses"] = _gap([a.diagnostics["losses"]], [b.diagnostics["losses"]])
        rows.append(row)
        extra = "".join(
            f" | {k} {row[k]}" for k in ("h_u", "estimates", "probs", "gate_flips", "losses") if k in row
        )
        print(
            f"[parity] {stage} seed {seed}: metric {row['metric']:.3e} | "
            + " ".join(f"{k} {v:.2e}" for k, v in row["modules"].items()) + extra,
            flush=True,
        )
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--client-epochs", type=int, nargs="+", default=[5, 20])
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--slots", type=int, default=2)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device("cuda", 0)
    seeds = list(range(args.seeds))
    spec = scenarios.get(SCENARIO)
    bundles = [scenarios.build(spec, seed=s, device=dev) for s in seeds]
    mesh = BatchMesh((dev,) * args.slots)

    def fold(runner, cfg, **kw):
        return run_seeds(
            runner, seeds, [b.split for b in bundles], [b.extractors for b in bundles],
            [b.ssl_cfgs for b in bundles], cfg, device=dev, **kw,
        )

    def pair(stage, runner, cfg, **kw):
        return compare(stage, seeds, fold(runner, dataclasses.replace(cfg, mesh=mesh), **kw),
                       fold(runner, cfg, **kw))

    rows = []
    for epochs in args.client_epochs:
        cfg = ProtocolConfig(client_epochs=epochs, server_epochs=spec.budget("server_epochs", 50))
        rows += pair(f"one-shot e{epochs}", run_one_shot, cfg)
        rows += pair(f"few-shot e{epochs}", run_few_shot, cfg)
        rows += pair(f"few-shot + finetune e{epochs}", run_few_shot_finetune, cfg,
                     finetune_iterations=FINETUNE_ITERATIONS)
    base = ProtocolConfig()
    it = baselines.IterativeConfig(
        iterations=FINETUNE_ITERATIONS, client_lr=base.client_lr / 10, server_lr=base.server_lr / 10,
        engine_mode="vmap",
    )
    rows += pair("vanilla at the finetune's rates", baselines.run_vanilla, it)
    cfg = ProtocolConfig(client_epochs=args.client_epochs[0],
                         server_epochs=spec.budget("server_epochs", 50))
    rows += compare(f"few-shot e{args.client_epochs[0]} unsharded twice", seeds,
                    fold(run_few_shot, cfg), fold(run_few_shot, cfg))
    line = gpu_line() if dev.type == "cuda" else "cpu"
    print(line)
    print(json.dumps({"mesh_parity": rows, "slots": args.slots, "device": str(dev), "card": line}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
