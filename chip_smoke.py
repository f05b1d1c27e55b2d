"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``repro_torch`` (never JAX, never the reference package) through its
serving path at the image extractor's full width: K = 2 parties holding the
(32, 16, 3) halves of a CIFAR-10 image and K = 4 holding (16, 16, 3)
patches, the WideResNet-style CNN at its defaults (widths 32/64/128, two
blocks per stage, 128-wide representations), a linear 10-class joint head,
seeded random weights and N_o = 2048 overlap rows. Phases, each of which
fails the run (nonzero exit, no result line) if it goes wrong:

1. device: name, count, power limit; TF32 off for matmuls and cuDNN;
2. kernels: build every CUDA kernel from ``src/repro_torch/kernels/*/csrc``
   (one nvcc per kernel, in parallel), then hold each kernel against its
   plain PyTorch version on the card at the serving path's shapes, timing
   the kernel, the plain version, and one PyTorch library call computing
   the same function;
3. serving (K = 2): ragged requests through ``serve_traffic`` at capacity
   1024, held against the unbatched ``predict_logits``;
4. partial-party queries (K = 2: one B = 1 launch each; K = 4: one B = 3
   launch each), held against the plain route on the same inputs.

Kernel launch counters are set to 0 just before phases 3-4 (the main path)
and read just after. Output ends with a ``{"kernels": [...]}`` line, the
card's ``nvidia-smi`` name and power limit, and, last, the result line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.checkpoint import ExtractorSpec, init_artifact  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.sdpa_estimator import ops, ref  # noqa: E402
from repro_torch.launch.vfl_serve import ServingEngine, serve_traffic  # noqa: E402

SEED = 0
N_O = 2048  # overlap rows: the Eq. 10 keys/values
CAPACITY = 1024
H100_F32_FLOPS = 67e12  # FMA = 2 FLOP, outside the tensor cores (NVIDIA data sheet, SXM)
H100_BYTES_PER_S = 3.35e12
# Kernel vs plain version: both sum in f32 in different orders (d-long dots,
# N_o-long softmax sums); outputs are convex combinations of O(1) value rows,
# so their rounding differences stay a few 1e-6. 1e-4 leaves margin and still
# catches any indexing or masking error, which moves outputs by O(0.1).
KERNEL_TOL = 1e-4
# Logits: the same f32 layers on different batch compositions (cuDNN may
# pick another convolution algorithm for a padded batch), relative to the
# logits' scale.
LOGIT_RTOL = 1e-4
# (B, N_u, N_o, d, d_b): the partial-party launches of the serving path
# (K = 2: B = 1; K = 4: B = 3), a ragged N_o, and odd sizes with d != d_b.
SHAPES = [
    (1, 1024, 2048, 128, 128),
    (3, 1024, 2048, 128, 128),
    (1, 1024, 2000, 128, 128),
    (2, 333, 517, 64, 128),
]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls (CUDA
    events, after ``warmup`` calls). Inputs stay in L2 between calls, as the
    serving path's overlap reps do between queries."""
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


def sdpa_bound_ms(b: int, nu: int, no: int, d: int, db: int) -> tuple:
    """Least time for the work on an H100: the larger of compulsory bytes
    (each input read once, the output written once) over the memory rate and
    the two products' FLOPs over the f32 peak."""
    nbytes = 4 * b * (nu * d + no * d + no * db + nu * db)
    flops = 2 * b * nu * no * (d + db)
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def phase_device() -> str:
    check(torch.cuda.is_available(), "no CUDA device")
    name = torch.cuda.get_device_name(0)
    line = gpu_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {name} x{torch.cuda.device_count()} | nvidia-smi: {line}")
    print("[device] torch.backends.cuda.matmul.allow_tf32 = False, cudnn.allow_tf32 = False")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}")
    return line


def phase_kernels(gen) -> dict:
    """Kernel vs plain version (and library call) at the path's shapes."""
    rows = []
    for b, nu, no, d, db in SHAPES:
        q = torch.randn(b, nu, d, generator=gen, device="cuda")
        a = torch.randn(b, no, d, generator=gen, device="cuda")
        v = torch.randn(b, no, db, generator=gen, device="cuda")
        got = ops.sdpa_estimate_batched(q, a, v)
        want = ref.sdpa_estimate_batched(q, a, v)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(bool(torch.isfinite(got).all()), f"non-finite kernel output at {(b, nu, no, d, db)}")
        check(err <= KERNEL_TOL, f"kernel vs plain max|err| {err} > {KERNEL_TOL}")
        row = {
            "shape": [b, nu, no, d, db],
            "max_abs_err": err,
            "ms": time_ms(lambda: ops.sdpa_estimate_batched(q, a, v)),
            "plain_ms": time_ms(lambda: ref.sdpa_estimate_batched(q, a, v)),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(q, a, v)),
        }
        row["bound_ms"], row["bound_by"] = sdpa_bound_ms(b, nu, no, d, db)
        rows.append(row)
        times = " | ".join(f"{k} {row[k]:.4f} ms" for k in ("ms", "plain_ms", "library_ms"))
        print(
            f"[kernel] sdpa_estimator B={b} N_u={nu} N_o={no} d={d} d_b={db}: "
            f"max|err| {err:.3e} | {times} | bound {row['bound_ms']:.4f} ms ({row['bound_by']})"
        )
    return rows[0]  # the K = 2 partial-query launch shape


def make_art(spec, shapes, gen):
    """A seeded artifact whose overlap reps are its extractors' outputs on
    N_O seeded aligned rows."""
    aligned = [torch.randn(N_O, *s, generator=gen, device="cuda") for s in shapes]
    specs = [spec] * len(shapes)
    return init_artifact(specs, shapes, 10, seed=SEED, device="cuda", aligned=aligned)


def phase_serving(art, gen, line: str) -> None:
    engine = ServingEngine(art, capacity=CAPACITY, device="cuda")
    sizes = torch.randint(1, 2 * CAPACITY + 1, (36,), generator=gen, device="cuda").tolist()
    reqs = [
        tuple(torch.randn(n, *s, generator=gen, device="cuda") for s in art.feature_shapes)
        for n in sizes
    ]
    outs, rec = serve_traffic(engine, reqs, warmup=2)
    worst = 0.0
    for req, out in zip(reqs, outs):
        want = art.predict_logits(req)
        check(out.shape == want.shape == (req[0].shape[0], 10), f"logit shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), "non-finite served logits")
        scale = max(1.0, want.abs().max().item())
        worst = max(worst, (out - want).abs().max().item() / scale)
    check(worst <= LOGIT_RTOL, f"batched vs unbatched logits differ by {worst} (relative)")
    s = rec.summary()
    print(
        "[serve] K=2 halves (32,16,3) CNN 32/64/128 x2 rep 128 -> 10 classes, "
        f"capacity {CAPACITY}: {len(reqs)} requests, {s['rows']} rows in {s['batches']} "
        f"batches: p50 {s['p50_ms']:.3f} ms p99 {s['p99_ms']:.3f} ms "
        f"{s['rows_per_s']:.0f} rows/s | batched vs unbatched max rel diff {worst:.2e} | {line}"
    )


def phase_partial(art, gen, queries: int, line: str) -> int:
    """Partial-party queries, each held against the plain route; returns
    the number of kernel launches they should have made."""
    engine = ServingEngine(art, capacity=CAPACITY, device="cuda")
    k_parties = art.num_parties
    worst, times = 0.0, []
    for i in range(queries):
        k = i % k_parties
        x = torch.randn(CAPACITY, *art.feature_shapes[k], generator=gen, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = engine.predict_logits_partial(x, k)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        with torch.inference_mode():
            h = art.extractors[k](x)
            o = art.overlap_reps
            reps = [h if j == k else ref.sdpa_estimate(h, o[k], o[j]) for j in range(k_parties)]
            want = art.classifier(torch.cat(reps, dim=-1))
        check(got.shape == (CAPACITY, 10), f"partial logits shape {tuple(got.shape)}")
        check(bool(torch.isfinite(got).all()), "non-finite partial-party logits")
        worst = max(worst, (got - want).abs().max().item() / max(1.0, want.abs().max().item()))
    check(worst <= LOGIT_RTOL, f"partial-party logits vs plain route differ by {worst}")
    times.sort()
    print(
        f"[partial] K={k_parties} {art.feature_shapes[0]}: {queries} queries of {CAPACITY} rows "
        f"(one B={k_parties - 1} launch each): median {times[len(times) // 2]:.3f} ms "
        f"| vs plain route max rel diff {worst:.2e} | {line}"
    )
    return queries


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this smoke run needs a GPU", file=sys.stderr)
        return 1
    line = phase_device()
    t0 = time.time()
    _build.build()
    print(f"[build] {', '.join(_build.KERNELS)} built in {time.time() - t0:.1f}s")
    for name in _build.KERNELS:
        for log_line in _build.build_log(name).splitlines():
            if "registers" in log_line or "spill" in log_line:
                print(f"[build] {name}: {log_line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    kernel_row = phase_kernels(gen)

    cnn = ExtractorSpec(kind="cnn", rep_dim=128, widths=(32, 64, 128), blocks_per_stage=2)
    halves = make_art(cnn, [(32, 16, 3)] * 2, gen)
    patches = make_art(cnn, [(16, 16, 3)] * 4, gen)
    torch.cuda.synchronize()

    # ---- the main path: counters from 0, read right after
    ops.LAUNCHES = 0
    phase_serving(halves, gen, line)
    expected = phase_partial(halves, gen, 4, line)
    expected += phase_partial(patches, gen, 3, line)
    torch.cuda.synchronize()
    launches = ops.LAUNCHES
    check(launches == expected, f"sdpa_estimator launched {launches} times, expected {expected}")
    print(f"[path] sdpa_estimator launches on the main path: {launches} (expected {expected})")

    kernels = [
        {
            "name": "sdpa_estimator",
            "route": "cuda",
            "source": "src/repro_torch/kernels/sdpa_estimator/csrc/sdpa_estimator.cu",
            "replaces": "src/repro/kernels/sdpa_estimator/kernel.py:38",
            "launches": launches,
            "max_abs_err": kernel_row["max_abs_err"],
            "ms": kernel_row["ms"],
            "plain_ms": kernel_row["plain_ms"],
            "bound_ms": kernel_row["bound_ms"],
            "bound_by": kernel_row["bound_by"],
            "library_ms": kernel_row["library_ms"],
        }
    ]
    print(json.dumps({"kernels": kernels}))
    print(line)
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
