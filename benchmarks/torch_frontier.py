"""The comm-accuracy frontier of the PyTorch port: every method × every
scenario, one artifact, held to the reference's gate.

    PYTHONPATH=src python benchmarks/torch_frontier.py \
        --scenarios hard/overlap-32 hard/overlap-64 --seeds 4 --check-gate

The port's counterpart of ``benchmarks/frontier.py``. For each scenario it
runs ``METHODS``: one-shot (Alg. 1), few-shot (Alg. 2), SplitNN-style
iterative VFL and FedCVT, over ``--seeds`` seeds, and emits one row per
(scenario, method, seed) plus, for several seeds, one aggregate row per
(scenario, method). Execution is grouped: the selection is partitioned by
``scenarios.group_scenarios`` and each group's C scenarios × S seeds go
through ``core.protocol.run_scenarios_seeds`` as one folded sweep a method.
The protocol methods fold into one stacked S·C·K program; the iterative
baselines loop per seed for now (their stacked fold is still to come) and
say so in their rows (``seed_fold`` 1, ``engine_path`` "python").

Each row records the metric, ledger bytes and comm times, ``wall_s`` (the
method's whole-group sweep wall, amortized over its C×S entries),
``group_size``, ``seed_fold`` and ``scenario_fold`` (the partitioner's
ground truth against the fold that ran), ``engine_path``, ``kernel_fold``
(step ③'s k-means fold) and ``sdpa_fold`` (③''s), and ``cache_misses``
(fresh session builds the method's group sweep made, ``engine.sessions``).

``--check-gate`` holds the fresh rows to the reference's rules and floors,
read from the unchanged ``benchmarks/frontier_baseline.json``: one-shot
moves at least 100× fewer bytes than iterative; one-shot's and few-shot's
mean margins over iterative clear ``min_mean_margin`` /
``fewshot_min_mean_margin`` and no seed's margin falls below
``min_worst_margin`` / ``fewshot_min_worst_margin``; one-shot's bytes do not
exceed the recorded ``one_shot_bytes``; the fault family degrades within
``max_oneshot_drop`` (:func:`_check_fault_rows`). It also requires the
protocol methods to have folded: every stackable one-shot and few-shot row
on the stacked engine path, ``seed_fold`` equal to the sweep's seeds,
``scenario_fold`` to its group's size, ``kernel_fold`` to
S·C·K and few-shot's ``sdpa_fold`` to S·C. The run is on the card unless
``--device cpu`` is given; ``--data-device`` draws the data elsewhere (the
port's generators draw other rows on the card than on the CPU for one
seed), so the card can train on the CPU's rows and the CPU on the card's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import scenarios  # noqa: E402
from repro_torch.core import rows as result_rows  # noqa: E402
from repro_torch.core import runners as runner_registry  # noqa: E402
from repro_torch.core.baselines import IterativeConfig  # noqa: E402
from repro_torch.core.protocol import ProtocolConfig, run_scenarios_seeds  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.engine.local_ssl import parties_are_homogeneous, stack_pays  # noqa: E402
from repro_torch.engine.sessions import (  # noqa: E402
    session_cache_stats,
    session_cache_stats_by_domain,
)

BASELINE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "frontier_baseline.json")

METHODS = ("one_shot", "few_shot", "iterative", "fedcvt")
PROTOCOL_METHODS = ("one_shot", "few_shot")


def _aggregate_row(seed_rows) -> dict:
    """One (scenario, method) summary row over its per-seed rows; the mean
    metric doubles as ``metric``."""
    metrics = [r["metric"] for r in seed_rows]
    mean = sum(metrics) / len(metrics)
    var = sum((m - mean) ** 2 for m in metrics) / len(metrics)
    row = dict(seed_rows[0])
    row.update(
        seed="aggregate",
        aggregate=True,
        num_seeds=len(seed_rows),
        metric=mean,
        metric_mean=mean,
        metric_std=var**0.5,
        metric_min=min(metrics),
        metric_max=max(metrics),
        wall_s=sum(r["wall_s"] for r in seed_rows),
    )
    if len({r.get("engine_path") for r in seed_rows}) != 1:
        row.pop("engine_path", None)  # mixed per-seed paths: claim none
    return row


def _runner_cfgs(spec, methods=METHODS) -> dict:
    """Each method's runner and config, through the runner registry: its
    ``kind`` picks the config family the scenario's budgets fill."""
    pcfg = ProtocolConfig(
        client_epochs=spec.budget("client_epochs", 8),
        server_epochs=spec.budget("server_epochs", 30),
    )
    if spec.fewshot_threshold is not None:
        pcfg = dataclasses.replace(pcfg, fewshot_threshold=spec.fewshot_threshold)
    icfg = IterativeConfig(iterations=spec.budget("iterations", 300))
    by_kind = {"protocol": pcfg, "iterative": icfg}
    return {m: (runner_registry.get(m).runner, by_kind[runner_registry.get(m).kind]) for m in methods}


def build_bundles(spec, seeds, smoke: bool, device=None):
    """One built bundle per seed of one scenario, on ``device``."""
    return [scenarios.build(spec, seed=s, smoke=smoke, device=device) for s in seeds]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_scenario_group(bundles_per_scenario, seeds, methods=METHODS, device=None, verbose=True):
    """Every method on one partitioner group over all ``seeds``: each
    method's C scenarios × S seeds are one ``run_scenarios_seeds`` call.
    ``bundles_per_scenario`` is the C×S grid of built bundles. Returns the
    rows."""
    dev = resolve_device(device)
    specs = [bs[0].spec for bs in bundles_per_scenario]
    group_size = len(specs)
    runner_cfgs = _runner_cfgs(specs[0], methods)
    b0 = bundles_per_scenario[0][0]
    # the fold stacks its SSL sessions where "auto" would (local_ssl.stack_pays)
    vmap_eligible = parties_are_homogeneous(
        b0.extractors, b0.ssl_cfgs, [tuple(x.shape) for x in b0.split.aligned]
    ) and stack_pays(b0.extractors[0], len(b0.extractors), group_size * len(seeds))
    # faults are per-entry data, outside the fold signature: a group with
    # any FaultSpec threads the C×S grid through the same folded sweep
    fault_kw = {}
    if any(spec.fault is not None for spec in specs):
        fault_kw["faults"] = [[spec.fault for _ in seeds] for spec in specs]
    rows = []
    for method in methods:
        runner, cfg = runner_cfgs[method]
        _sync(dev)
        t0 = time.perf_counter()
        misses0 = session_cache_stats()["misses"]
        results = run_scenarios_seeds(
            runner,
            [list(seeds) for _ in specs],
            [[b.split for b in bs] for bs in bundles_per_scenario],
            [[b.extractors for b in bs] for bs in bundles_per_scenario],
            [[b.ssl_cfgs for b in bs] for bs in bundles_per_scenario],
            cfg,
            device=dev,
            **fault_kw,
        )
        _sync(dev)
        wall = time.perf_counter() - t0
        misses = session_cache_stats()["misses"] - misses0
        for spec, scen_results in zip(specs, results):
            seed_rows = []
            for seed, res in zip(seeds, scen_results):
                row = result_rows.training_row(
                    res,
                    scenario=spec.name,
                    seed=seed,
                    method=method,
                    wall_s=wall / (len(seeds) * group_size),
                    cache_misses=misses,
                    group_size=group_size,
                    vmap_eligible=vmap_eligible,
                    overlap=spec.overlap,
                    num_parties=spec.num_parties,
                    modality=spec.modality,
                )
                seed_rows.append(row)
                if verbose:
                    print(
                        "{scenario:>18s} {method:>9s} s{seed:<2d} {metric_name}={metric:.4f} "
                        "bytes={comm_bytes:>10d} times={comm_times:>6d} path={engine_path} "
                        "folds S{seed_fold}·C{scenario_fold} km{kf} sdpa{sf} "
                        "({wall_s:.2f}s)".format(
                            kf=row.get("kernel_fold", "-"), sf=row.get("sdpa_fold", "-"), **row
                        ),
                        flush=True,
                    )
            rows.extend(seed_rows)
            if len(seed_rows) > 1:
                agg = _aggregate_row(seed_rows)
                rows.append(agg)
                if verbose:
                    print(
                        "{scenario:>18s} {method:>9s} agg {metric_name}={metric_mean:.4f}"
                        "±{metric_std:.4f} [{metric_min:.4f}, {metric_max:.4f}] "
                        "({wall_s:.2f}s total)".format(**agg),
                        flush=True,
                    )
    return rows


def _check_margins(
    name: str, method_rows: dict, its: dict, label: str, min_mean: float, min_worst: float, problems
) -> None:
    """Mean-margin and worst-seed dominance of one method over iterative."""
    shared_seeds = sorted(set(method_rows) & set(its))
    if not shared_seeds:
        return
    margins = {s: method_rows[s]["metric"] - its[s]["metric"] for s in shared_seeds}
    mean_margin = sum(margins.values()) / len(margins)
    if mean_margin <= min_mean:
        problems.append(
            f"{name}: {label} mean margin over iterative {mean_margin:+.4f} <= floor "
            f"{min_mean:+.4f} (seeds {shared_seeds})"
        )
    worst_seed = min(margins, key=margins.get)
    if margins[worst_seed] < min_worst:
        problems.append(
            f"{name}: {label} worst-seed margin {margins[worst_seed]:+.4f} (seed {worst_seed}) "
            f"< floor {min_worst:+.4f}"
        )


def _check_fault_rows(per_seed, baseline, expect_faults: bool, problems: list) -> None:
    """The graceful-degradation gate over the fault/* rows, per
    ``fault_families`` entry of the baseline file: the whole family present
    (``required``); a dropout row one party down (and, on the iterative
    methods, retry cost in its ledger), any other fault row every party
    left; a protocol fault row carrying ``degraded_metric``; each member's
    one-shot mean at most ``max_oneshot_drop`` below its fault-free twin's.
    A gated full sweep with no fault row at all fails (``expect_faults``)."""
    fams = baseline.get("fault_families", {})
    fault_rows = [r for r in per_seed if "fault_kind" in r]
    if not fault_rows:
        if expect_faults:
            problems.append(
                "no fault-injected rows in a gated sweep: the graceful-degradation gate cannot "
                "be evaluated (sweep the full catalog, or pass --scenarios for partial sweeps)"
            )
        return
    for fam, fspec in fams.items():
        rows_f = [r for r in fault_rows if r["scenario"].startswith(fam + "/")]
        if not rows_f:
            continue
        present = {r["scenario"] for r in rows_f}
        missing = sorted(set(fspec.get("required", ())) - present)
        if missing:
            problems.append(
                f"fault family {fam!r}: scenarios {missing} missing from the sweep; the "
                f"degradation claim needs the whole family"
            )
        for r in rows_f:
            num_parties = r.get("num_parties")
            survived = r.get("parties_survived")
            if r.get("fault_kind") == "dropout":
                if survived != num_parties - 1:
                    problems.append(
                        f"{r['scenario']} seed {r['seed']}: {r['method']} dropout row records "
                        f"parties_survived={survived} (expected {num_parties - 1} of {num_parties})"
                    )
                if r["method"] in ("iterative", "fedcvt") and (
                    r.get("fault_retry_rounds", 0) < 1 or r.get("fault_retry_bytes", 0) < 1
                ):
                    problems.append(
                        f"{r['scenario']} seed {r['seed']}: {r['method']} dropout row shows no "
                        f"retry/timeout cost in the ledger (fault_retry_rounds="
                        f"{r.get('fault_retry_rounds')}, fault_retry_bytes="
                        f"{r.get('fault_retry_bytes')})"
                    )
            elif survived != num_parties:
                problems.append(
                    f"{r['scenario']} seed {r['seed']}: {r['method']} {r.get('fault_kind')} row "
                    f"records parties_survived={survived} (expected {num_parties})"
                )
            if r["method"] in PROTOCOL_METHODS and r.get("degraded_metric") is None:
                problems.append(
                    f"{r['scenario']} seed {r['seed']}: {r['method']} fault row carries no "
                    f"degraded_metric"
                )
        base_name = fspec.get("baseline_scenario")
        max_drop = fspec.get("max_oneshot_drop")
        if base_name is None or max_drop is None:
            continue
        base_ones = [
            r["metric"] for r in per_seed if r["scenario"] == base_name and r["method"] == "one_shot"
        ]
        if not base_ones:
            problems.append(
                f"fault family {fam!r}: fault-free twin {base_name!r} has no one_shot rows to "
                f"measure degradation against"
            )
            continue
        base_mean = sum(base_ones) / len(base_ones)
        for name in sorted(present - {base_name}):
            vals = [
                r["metric"] for r in fault_rows if r["scenario"] == name and r["method"] == "one_shot"
            ]
            if not vals:
                continue
            mean = sum(vals) / len(vals)
            if mean < base_mean - max_drop:
                problems.append(
                    f"{name}: one-shot degraded mean metric {mean:.4f} fell more than "
                    f"{max_drop:.3f} below the fault-free twin {base_name} ({base_mean:.4f}): "
                    f"graceful degradation broke"
                )


def _check_folds(per_seed, problems: list) -> None:
    """The protocol methods must have folded: on the stacked engine path
    where the parties stack, over every seed of the sweep and the row's
    whole group, with step ③ one k-means search over S·C·K and ③' over S·C.
    The iterative baselines are exempt (their fold is still to come)."""
    num_sweep_seeds = len({r["seed"] for r in per_seed})
    for r in per_seed:
        if r["method"] not in PROTOCOL_METHODS:
            continue
        what = f"{r['scenario']} seed {r['seed']}: {r['method']}"
        if r.get("seed_fold") != num_sweep_seeds:
            problems.append(
                f"{what} ran seed_fold={r.get('seed_fold')}: the {num_sweep_seeds}-seed sweep "
                f"fell back to the per-seed loop"
            )
        if r.get("scenario_fold") != r.get("group_size"):
            problems.append(
                f"{what} ran scenario_fold={r.get('scenario_fold')} against a size-"
                f"{r.get('group_size')} group: the grouped sweep fell back to the "
                f"per-scenario loop"
            )
        if not r.get("vmap_eligible", False):
            continue  # heterogeneous parties train per entry inside the fold
        if r.get("engine_path") != "vmap":
            problems.append(f"{what} trained on engine_path={r.get('engine_path')!r}, not the stack")
        flat = r.get("seed_fold", 1) * r.get("scenario_fold", 1)
        want_km = flat * r.get("num_parties", 1)
        if r.get("kernel_fold") != want_km:
            problems.append(
                f"{what} ran kernel_fold={r.get('kernel_fold')} (expected {want_km} = seed_fold "
                f"x scenario_fold x num_parties"
                + (f"; fallback: {r['kernel_fallback']!r}" if r.get("kernel_fallback") else "")
                + ")"
            )
        if r["method"] == "few_shot" and r.get("sdpa_fold") != flat:
            problems.append(f"{what} ran sdpa_fold={r.get('sdpa_fold')} (expected {flat})")


def check_gate(rows, baseline_path: str = BASELINE_PATH, expect_faults: bool = False) -> list:
    """The regression gate over fresh rows; returns the violations. See the
    module doc for the rules."""
    problems: list = []
    per_seed = [r for r in rows if not r.get("aggregate")]
    with open(baseline_path) as fh:
        baseline = json.load(fh)
    _check_fault_rows(per_seed, baseline, expect_faults, problems)
    _check_folds(per_seed, problems)
    for name in sorted({r["scenario"] for r in per_seed}):
        ones = {r["seed"]: r for r in per_seed if r["scenario"] == name and r["method"] == "one_shot"}
        fews = {r["seed"]: r for r in per_seed if r["scenario"] == name and r["method"] == "few_shot"}
        its = {r["seed"]: r for r in per_seed if r["scenario"] == name and r["method"] == "iterative"}
        if not ones:
            continue
        one0 = next(iter(ones.values()))
        one_bytes = {r["comm_bytes"] for r in ones.values()}
        if len(one_bytes) != 1:
            problems.append(
                f"{name}: one-shot bytes differ across seeds {sorted(one_bytes)}: communication "
                f"must be seed-invariant"
            )
        base = baseline.get(name)
        if base is None:
            continue
        if base.get("one_shot_bytes") is not None and one0["comm_bytes"] > base["one_shot_bytes"]:
            problems.append(
                f"{name}: one-shot bytes regressed {one0['comm_bytes']} > baseline "
                f"{base['one_shot_bytes']}"
            )
        if not its or one0["overlap"] > 64:
            continue
        it0 = next(iter(its.values()))
        ratio = it0["comm_bytes"] / max(one0["comm_bytes"], 1)
        if ratio < 100.0:
            problems.append(f"{name}: one-shot bytes advantage {ratio:.0f}x < 100x")
        _check_margins(
            name, ones, its, "one-shot", base.get("min_mean_margin", 0.0),
            base.get("min_worst_margin", 0.0), problems,
        )
        if not fews:
            problems.append(
                f"{name}: no few_shot rows: the few-shot margin gate cannot be evaluated (run "
                f"all METHODS, or drop --check-gate for partial sweeps)"
            )
        _check_margins(
            name, fews, its, "few-shot", base.get("fewshot_min_mean_margin", 0.0),
            base.get("fewshot_min_worst_margin", 0.0), problems,
        )
    return problems


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true", help="the catalog at smoke sizes")
    ap.add_argument("--seed", type=int, default=0, help="first seed")
    ap.add_argument("--seeds", type=int, default=1, help="seeds per scenario (seed .. seed+N-1)")
    ap.add_argument("--out", default="BENCH_torch_frontier.json")
    ap.add_argument("--scenarios", nargs="+", default=None, help="scenario names (default: by tag)")
    ap.add_argument("--methods", nargs="+", default=list(METHODS), help="runner registry names")
    ap.add_argument("--check-gate", action="store_true", help="enforce the frontier gate")
    ap.add_argument("--baseline", default=BASELINE_PATH)
    ap.add_argument("--device", default=None, help="where to train: cuda (default) or cpu")
    ap.add_argument(
        "--data-device",
        default=None,
        help="where to draw the data (default: --device). The generators draw other rows "
        "on the card than on the CPU for the same seed",
    )
    args = ap.parse_args(argv)
    for m in args.methods:
        runner_registry.get(m)  # a typo'd method fails before any training
    dev = resolve_device(args.device)
    data_dev = resolve_device(args.data_device) if args.data_device else dev

    if args.scenarios:
        specs = [scenarios.get(n) for n in args.scenarios]
    elif args.smoke:
        specs = [scenarios.get(n) for n in scenarios.names()]
    else:
        specs = scenarios.by_tag("frontier")
    seeds = list(range(args.seed, args.seed + args.seeds))

    t0 = time.perf_counter()
    bundles = [build_bundles(spec, seeds, args.smoke, data_dev) for spec in specs]
    groups = scenarios.group_scenarios([(bs[0].spec, bs[0]) for bs in bundles])
    for g in groups:
        print(f"group[{g.size}]: {', '.join(g.names)}", flush=True)
    rows = []
    for g in groups:
        rows.extend(
            run_scenario_group([bundles[i] for i in g.indices], seeds, args.methods, dev)
        )
    blob = {
        "mode": "smoke" if args.smoke else "full",
        "device": str(dev),
        "data_device": str(data_dev),
        "seed": args.seed,
        "seeds": seeds,
        "methods": list(args.methods),
        "groups": [{"scenarios": g.names, "size": g.size} for g in groups],
        "wall_s": time.perf_counter() - t0,
        "session_cache": session_cache_stats_by_domain(),
        "rows": rows,
    }
    with open(args.out, "w") as fh:
        json.dump(blob, fh, indent=2)
    print(f"wrote {args.out}: {len(rows)} rows in {blob['wall_s']:.1f}s")

    if args.check_gate:
        problems = check_gate(rows, args.baseline, expect_faults=args.scenarios is None)
        if problems:
            for p in problems:
                print(f"GATE VIOLATION: {p}", file=sys.stderr)
            return 1
        print(
            "gate: one-shot AND few-shot dominate iterative (bytes >=100x, mean margin + worst "
            "seed), the protocol methods folded, fault/* degradation within bounds, and bytes "
            "match the recorded baseline"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
