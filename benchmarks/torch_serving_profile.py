"""Where a served query's time goes on the GPU (the PyTorch port).

    python3 benchmarks/torch_serving_profile.py [--seed 0]

Builds the K = 2 CIFAR-halves artifact that ``chip_smoke.py`` serves (the
CNN extractor at its defaults, seeded weights, N_o = 2048 overlap rows),
then traces two units of work with ``torch.profiler`` after a warm-up:

* ``step``: one ``ServingEngine.step`` on a full 1024-row batch;
* ``partial``: one ``predict_logits_partial`` on 1024 rows of party 0,
  which runs the Eq. 10 SDPA kernel.

For each it prints the host wall time without tracing (median of 10
synchronized calls) and under the profiler (its overhead is the
difference), the device's busy time in the traced call (the sum of kernel
times; one stream, so kernels do not overlap), the idle share
``1 - busy / untraced wall``, and the busy time split by kind of kernel.
The last line is one JSON object with the same numbers and the card's
``nvidia-smi`` name and power limit. Needs a CUDA card; imports the port
only, never JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from repro_torch.checkpoint import ExtractorSpec, init_artifact  # noqa: E402
from repro_torch.launch import batching  # noqa: E402
from repro_torch.launch.vfl_serve import ServingEngine  # noqa: E402

ROWS = 1024
N_O = 2048
# Kernel-name fragments → kind, first match wins. cuDNN's convolutions run
# as implicit GEMMs, FFTs or complex GEMMs ("cf32"), so they precede "gemm".
KINDS = (
    ("sdpa_estimator", "sdpa_estimator (CUDA kernel)"),
    ("kmeans_assign", "kmeans (CUDA kernel)"),
    ("rmsnorm_kernel", "rmsnorm (CUDA kernel)"),
    ("decode_attention", "decode_attention (CUDA kernel)"),
    ("conv", "convolution (cuDNN)"),
    ("fprop", "convolution (cuDNN)"),
    ("fft", "convolution (cuDNN)"),
    ("cf32", "convolution (cuDNN)"),
    ("Moments", "group norm"),
    ("GroupNorm", "group norm"),
    ("FusedParams", "group norm"),
    ("gemm", "matmul"),
    ("gemv", "matmul"),
    ("elementwise", "elementwise / copy / pad"),
    ("copy", "elementwise / copy / pad"),
    ("Memcpy", "elementwise / copy / pad"),
    ("Memset", "elementwise / copy / pad"),
    ("reduce", "reduction"),
)


def _kind(name: str) -> str:
    for fragment, kind in KINDS:
        if fragment in name:
            return kind
    return "other"


def wall_ms(fn) -> float:
    """Host time of one call of ``fn``, to the end of its device work."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def trace(fn) -> dict:
    """Untraced and traced wall time and per-kind device time of ``fn``."""
    untraced = statistics.median(wall_ms(fn) for _ in range(10))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced = wall_ms(fn)
    by_kind: dict = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kind = _kind(ev.name)
            by_kind[kind] = by_kind.get(kind, 0.0) + ev.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_kind.values())
    return {
        "wall_ms": untraced,
        "traced_wall_ms": traced,
        "busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / untraced,
        "busy_ms_by_kind": dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_serving_profile: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    spec = ExtractorSpec(kind="cnn", rep_dim=128, widths=(32, 64, 128), blocks_per_stage=2)
    shapes = [(32, 16, 3)] * 2
    aligned = [torch.randn(N_O, *s, generator=gen, device="cuda") for s in shapes]
    art = init_artifact([spec] * 2, shapes, 10, seed=args.seed, device="cuda", aligned=aligned)
    engine = ServingEngine(art, capacity=ROWS, device="cuda")
    xs = [torch.randn(ROWS, *s, generator=gen, device="cuda") for s in shapes]
    batch = batching.pad_to_capacity(xs, ROWS)
    units = {
        "step": lambda: engine.step(batch),
        "partial": lambda: engine.predict_logits_partial(xs[0], 0),
    }
    for fn in units.values():  # warm-up: cuDNN algorithm choice, kernel build
        for _ in range(3):
            fn()
    result = {name: trace(fn) for name, fn in units.items()}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
    ).stdout.strip()
    for name, r in result.items():
        print(
            f"[{name}] {card}: wall {r['wall_ms']:.3f} ms (traced {r['traced_wall_ms']:.3f}), "
            f"device busy {r['busy_ms']:.3f} ms, idle share {r['idle_share']:.3f}"
        )
        for kind, ms in r["busy_ms_by_kind"].items():
            print(f"    {kind:<28} {ms:8.3f} ms  {ms / r['busy_ms']:6.1%} of busy")
    print(json.dumps({"device": card, "rows": ROWS, "n_overlap": N_O, **result}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
