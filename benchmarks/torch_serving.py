"""The port's serving benchmark: latency, throughput and the reference's
serving gate on a deployed artifact, and the card's sweeps behind the
serving rules.

    PYTHONPATH=src python -m benchmarks.torch_serving --train --smoke \
        --save-artifact DIR --check-gate [--device cpu]
    PYTHONPATH=src python -m benchmarks.torch_serving --artifact DIR --check-gate
    PYTHONPATH=src python -m benchmarks.torch_serving --path-sweep     # a card only
    PYTHONPATH=src python -m benchmarks.torch_serving --router-sweep   # a card only

Counterpart of ``benchmarks/serving.py``. It loads (or trains with the
port's ``run_one_shot`` and exports) a ``TrainedVFLModel`` and drives it
through ``repro_torch.launch.vfl_serve`` at batch 1 / 64 / 1024,
:data:`REQUESTS` timed requests a size by default (the reference times 8,
whose p99 is only their largest), one typed serving row a batch size (``core/rows.py::serving_row``, the reference's
keys): p50 / p99 / mean latency, rows/s, parity against the artifact's
unbatched ``predict_logits``, and the fresh ``"serving"`` session misses
the size made. ``--check-gate`` holds the rows to the reference's three
contracts, read from the unchanged ``benchmarks/serving_baseline.json``:

* PARITY: the fused batched logits match the unbatched forward within
  ``parity_atol`` at every batch size;
* RECOMPILE: no fresh ``"serving"`` miss after the first batch size;
* LATENCY: p50 under each size's ceiling, rows/s above its floor.

With ``--save-artifact`` the trained artifact is saved and the RELOADED
one is served, as a deployment would. Runs on ``cuda`` unless ``--device
cpu``.

The two sweeps time, on the card, what ``vfl_serve``'s rules rest on. Each
ends with the card's ``nvidia-smi`` name and power limit and one JSON line
of its rows.

* ``--path-sweep``: the stacked fused forward against the composed one
  (``vfl_serve._build_fused_forward``) at capacities 1 to 1024 on five
  artifacts: ``hard/overlap-32`` (K = 2 MLP), ``credit/parties-4`` and
  ``credit/parties-8`` (K = 4 and 8 MLP), one-shot B's geometry (K = 2
  (32, 16, 3) halves, the CNN at its defaults) and the K = 4 (16, 16, 3)
  patches with the same CNN; seeded weights. Host clock around each forward, ended by a device sync; median
  of :data:`PATH_STEPS` steps, in the order composed, stacked, stacked,
  composed.
* ``--router-sweep``: Eq. 10 through the ``sdpa_estimator`` kernel, the
  plain version and ``F.scaled_dot_product_attention``, each by CUDA events
  over back-to-back calls and by CUDA-graph replay (device time), at
  B·N_u·N_o from 1·32·32 to 3·1024·2048 and d, d_b in {16, 128}; B = 3 is
  a K = 4 query's fused launch (h_u and H_oᴬ as stride-0 views). Each row
  names the fastest route by both timers.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import scenarios  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    ExtractorSpec,
    init_artifact,
    load_artifact,
    save_artifact,
)
from repro_torch.core import rows as result_rows  # noqa: E402
from repro_torch.core.protocol import ProtocolConfig, run_one_shot  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.engine.sessions import session_cache_stats  # noqa: E402
from repro_torch.kernels.sdpa_estimator import ops, ref  # noqa: E402
from repro_torch.launch import batching, vfl_serve  # noqa: E402
from repro_torch.launch.vfl_serve import ServingEngine  # noqa: E402

BASELINE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "serving_baseline.json")

BATCH_SIZES = (1, 64, 1024)
REQUESTS = 300
PARITY_ATOL = 1e-5
TRAIN_SCENARIO = "hard/overlap-32"

CNN = ExtractorSpec("cnn", 128, widths=(32, 64, 128), blocks_per_stage=2)
#: the path sweep's artifacts: name → a registered scenario, or (spec,
#: per-party feature shapes, classes)
PATH_CELLS = {
    "hard/overlap-32": "hard/overlap-32",
    "credit/parties-4": "credit/parties-4",
    "credit/parties-8": "credit/parties-8",
    "one-shot B (K=2 CNN)": (CNN, [(32, 16, 3)] * 2, 10),
    "patches (K=4 CNN)": (CNN, [(16, 16, 3)] * 4, 10),
}
PATH_CAPACITIES = (1, 16, 64, 256, 1024)
PATH_STEPS = 30
ROUTER_SHAPES = [
    (b, nu, no, d, db)
    for b in (1, 3)
    for nu, no in ((32, 32), (256, 256), (1024, 2048))
    for d, db in ((16, 16), (16, 128), (128, 16), (128, 128))
]
ROUTER_TOL = 1e-4  # kernel vs plain version, f32 (chip_smoke.py's KERNEL_TOL)


def train_artifact(scenario: str = TRAIN_SCENARIO, seed: int = 0, smoke: bool = True, device=None):
    """One-shot-train one scenario seed with the port and export it, overlap
    reps included (what ``--train`` runs)."""
    spec = scenarios.get(scenario)
    bundle = scenarios.build(spec, seed=seed, smoke=smoke, device=device)
    cfg = ProtocolConfig(
        client_epochs=spec.budget("client_epochs", 8),
        server_epochs=spec.budget("server_epochs", 30),
    )
    res = run_one_shot(seed, bundle.split, bundle.extractors, bundle.ssl_cfgs, cfg, device=device)
    return res.to_artifact(spec.name, split=bundle.split)


def bench_artifact(art, batch_sizes=BATCH_SIZES, requests: int = REQUESTS, seed: int = 0) -> list:
    """Serve ``requests`` synthetic batches at every batch size on the
    artifact's device; one typed serving row a size with the latency
    summary, the parity error against the unbatched forward on the first
    request, and the fresh ``"serving"`` misses the size made."""
    rows = []
    for i, bs in enumerate(batch_sizes):
        engine = ServingEngine(art, capacity=bs, device=art.device)
        reqs = vfl_serve.synthetic_requests(art, requests, bs, seed=seed + i, device=art.device)
        misses0 = session_cache_stats("serving")["misses"]
        outs, rec = vfl_serve.serve_traffic(engine, reqs)
        fresh = session_cache_stats("serving")["misses"] - misses0
        want = art.predict_logits(list(reqs[0]))
        parity = float((outs[0] - want).abs().max())
        s = rec.summary()
        rows.append(
            result_rows.serving_row(
                "p50_ms",
                s["p50_ms"],
                scenario=art.scenario,
                batch=bs,
                capacity=engine.capacity,
                requests=len(reqs),
                p99_ms=s["p99_ms"],
                mean_ms=s["mean_ms"],
                rows_per_s=s["rows_per_s"],
                parity_max_abs=parity,
                cache_misses=fresh,
                first_shape=(i == 0),
                homogeneous=art.parties_are_homogeneous,
                num_parties=art.num_parties,
            )
        )
        print(
            f"{art.scenario:>18s} serve b={bs:<5d} path={engine.path} requests={len(reqs)} "
            f"p50={s['p50_ms']:8.3f}ms p99={s['p99_ms']:8.3f}ms "
            f"{s['rows_per_s']:10.0f} rows/s parity={parity:.2e} fresh_builds={fresh}",
            flush=True,
        )
    return rows


def check_serving_gate(rows, baseline_path: str = BASELINE_PATH) -> list:
    """The reference's serving gate over typed serving rows; returns the
    violations, in the reference's words."""
    problems = []
    with open(baseline_path) as fh:
        baseline = json.load(fh)
    atol = baseline.get("parity_atol", PARITY_ATOL)
    ceilings = baseline.get("max_p50_ms", {})
    floors = baseline.get("min_rows_per_s", {})
    serving = [r for r in rows if r.get("kind") == "serving"]
    if not serving:
        return ["no serving rows to gate"]
    for r in serving:
        bs = str(r["batch"])
        if r["parity_max_abs"] > atol:
            problems.append(
                f"batch {bs}: batched-vs-unbatched parity {r['parity_max_abs']:.2e} > {atol:.0e}"
            )
        if not r.get("first_shape") and r["cache_misses"] != 0:
            problems.append(
                f"batch {bs}: {r['cache_misses']} fresh serving-session "
                f"builds after the first batch shape — the fused forward "
                f"must re-serve ONE cached program at every capacity"
            )
        ceiling = ceilings.get(bs)
        if ceiling is not None and r["metric"] > ceiling:
            problems.append(f"batch {bs}: p50 {r['metric']:.2f}ms > baseline ceiling {ceiling:.2f}ms")
        floor = floors.get(bs)
        if floor is not None and r["rows_per_s"] < floor:
            problems.append(
                f"batch {bs}: throughput {r['rows_per_s']:.0f} rows/s < baseline floor {floor:.0f}"
            )
    return problems


# ----------------------------------------------------------- card sweeps
def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _median(xs) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2]


def _path_artifact(name, cell, dev):
    if isinstance(cell, str):
        bundle = scenarios.build(cell, seed=0, device=dev)
        specs = bundle.extractors
        shapes = [tuple(x.shape[1:]) for x in bundle.split.aligned]
        classes = bundle.split.num_classes
    else:
        spec, shapes, classes = cell
        specs = [spec] * len(shapes)
    return init_artifact(specs, shapes, classes, seed=0, device=dev, scenario=name)


def path_sweep(dev) -> list:
    """Stacked against composed fused forward, ms a step (median)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for name, cell in PATH_CELLS.items():
        art = _path_artifact(name, cell, dev)
        fwds = {p: vfl_serve._build_fused_forward(art, p) for p in vfl_serve.PATHS}
        params = {p: vfl_serve._party_params(art, p) for p in vfl_serve.PATHS}
        for cap in PATH_CAPACITIES:
            xs = [torch.randn(cap, *s, generator=gen, device=dev) for s in art.feature_shapes]
            batch = batching.pad_to_capacity(xs, cap)
            times = {p: [] for p in vfl_serve.PATHS}
            outs = {}
            with torch.inference_mode():
                for p in ("composed", "stacked", "stacked", "composed"):
                    for i in range(PATH_STEPS + 3):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        outs[p] = fwds[p](params[p], art.classifier, batch.xs, batch.mask)
                        torch.cuda.synchronize()
                        if i >= 3:
                            times[p].append((time.perf_counter() - t0) * 1e3)
            scale = max(1.0, outs["composed"].abs().max().item())
            rel = (outs["stacked"] - outs["composed"]).abs().max().item() / scale
            row = {
                "cell": name,
                "K": art.num_parties,
                "kind": art.extractor_specs[0].kind,
                "capacity": cap,
                "stacked_ms": _median(times["stacked"]),
                "composed_ms": _median(times["composed"]),
                "stacked_vs_composed_rel": rel,
                "rule": vfl_serve.serving_path(art, cap),
            }
            row["faster"] = "stacked" if row["stacked_ms"] < row["composed_ms"] else "composed"
            rows.append(row)
            print(
                f"[path] {name} K={row['K']} capacity {cap}: stacked {row['stacked_ms']:.4f} ms, "
                f"composed {row['composed_ms']:.4f} ms -> faster {row['faster']}, rule "
                f"{row['rule']} | stacked vs composed {rel:.2e} (relative)",
                flush=True,
            )
    return rows


def event_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean time of ``fn()`` over ``iters`` back-to-back calls by CUDA
    events: the host's enqueue included where it is the slower side."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    """Mean device time of ``fn()``: ``iters`` calls captured into one CUDA
    graph, replayed between two events (no host in the way)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()  # the first replay uploads the graph
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def router_sweep(dev) -> list:
    """Eq. 10 by route and timer at :data:`ROUTER_SHAPES`."""
    gen = torch.Generator(device=dev).manual_seed(0)
    router = vfl_serve.KernelRouter(dev.type)
    rows = []
    for b, nu, no, d, db in ROUTER_SHAPES:
        q = torch.randn(nu, d, generator=gen, device=dev).expand(b, nu, d)
        a = torch.randn(no, d, generator=gen, device=dev).expand(b, no, d)
        v = torch.randn(b, no, db, generator=gen, device=dev)
        err = (ops.sdpa_estimate_batched(q, a, v) - ref.sdpa_estimate_batched(q, a, v)).abs().max()
        if err.item() > ROUTER_TOL:
            raise SystemExit(f"kernel vs plain max|err| {err.item()} > {ROUTER_TOL} at {(b, nu, no, d, db)}")
        routes = {
            "kernel": lambda: ops.sdpa_estimate_batched(q, a, v),
            "plain": lambda: ref.sdpa_estimate_batched(q, a, v),
            "library": lambda: F.scaled_dot_product_attention(q, a, v),
        }
        row = {"shape": [b, nu, no, d, db], "router": "kernel" if router.use_sdpa(nu, no, d, b) else "plain"}
        for route, fn in routes.items():
            row[f"{route}_ms"] = event_ms(fn)
            row[f"{route}_device_ms"] = graph_ms(fn)
        row["fastest"] = min(routes, key=lambda r: row[f"{r}_ms"])
        row["fastest_device"] = min(routes, key=lambda r: row[f"{r}_device_ms"])
        rows.append(row)
        times = " | ".join(
            f"{r} {row[f'{r}_ms']:.4f} ({row[f'{r}_device_ms']:.4f})" for r in routes
        )
        print(
            f"[router] B={b} N_u={nu} N_o={no} d={d} d_b={db}: ms (device ms) {times} -> fastest "
            f"{row['fastest']} ({row['fastest_device']}), router {row['router']}",
            flush=True,
        )
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--artifact", help="serve an existing artifact directory")
    src.add_argument("--train", action="store_true", help=f"train {TRAIN_SCENARIO} and serve it")
    src.add_argument("--path-sweep", action="store_true", help="stacked vs composed (a card)")
    src.add_argument("--router-sweep", action="store_true", help="Eq. 10 by route (a card)")
    ap.add_argument("--smoke", action="store_true", help="train at smoke sizes")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch-sizes", type=int, nargs="+", default=list(BATCH_SIZES))
    ap.add_argument("--requests", type=int, default=REQUESTS, help="timed requests per batch size")
    ap.add_argument("--save-artifact", default=None, help="save the trained artifact here")
    ap.add_argument("--out", default="BENCH_torch_serving.json")
    ap.add_argument("--check-gate", action="store_true")
    ap.add_argument("--baseline", default=BASELINE_PATH)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.path_sweep or args.router_sweep:
        if dev.type != "cuda":
            raise SystemExit("the sweeps time the card; they need a CUDA device")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        rows = path_sweep(dev) if args.path_sweep else router_sweep(dev)
        print(gpu_line())
        print(json.dumps({"sweep": "path" if args.path_sweep else "router", "rows": rows}))
        return 0

    t0 = time.time()
    if args.train:
        art = train_artifact(seed=args.seed, smoke=args.smoke, device=dev)
        print(
            f"trained {art.scenario}: {art.metric_name}={art.metric:.4f} on {dev} "
            f"({time.time() - t0:.1f}s)",
            flush=True,
        )
        if args.save_artifact:
            path = save_artifact(args.save_artifact, art)
            print(f"saved artifact -> {path}")
            # serve what a deployment would: the RELOADED artifact
            art = load_artifact(args.save_artifact, device=dev)
    else:
        art = load_artifact(args.artifact, device=dev)

    rows = bench_artifact(art, batch_sizes=tuple(args.batch_sizes), requests=args.requests, seed=args.seed)
    blob = {
        "scenario": art.scenario,
        "device": str(dev),
        "seed": args.seed,
        "batch_sizes": list(args.batch_sizes),
        "wall_s": round(time.time() - t0, 2),
        "rows": rows,
    }
    with open(args.out, "w") as fh:
        json.dump(blob, fh, indent=2)
    print(f"wrote {args.out}: {len(rows)} rows in {blob['wall_s']:.1f}s")

    if args.check_gate:
        problems = check_serving_gate(rows, args.baseline)
        if problems:
            for p in problems:
                print(f"SERVING GATE VIOLATION: {p}", file=sys.stderr)
            return 1
        print(
            "serving gate: parity at 1e-5, one cached fused forward across batch shapes, "
            "latency within baseline"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
