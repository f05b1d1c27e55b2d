"""The RMSNorm backward of one source tree on one NVIDIA GPU, so that two
trees can be compared on one card in one call.

    python3 benchmarks/torch_rmsnorm_backward.py [--src DIR]

``--src DIR`` imports ``repro_torch`` from another tree's ``src`` (by
default this checkout's); its kernels build into that tree's ``build/``.
Run it for the parent and the change in turns (parent, change, change,
parent). At ``chip_smoke.py``'s ``RMS_BWD_SHAPES`` (x in the row's dtype,
an f32 scale, as the zoo passes them) it prints, for the wrapper
``ops.rms_norm_backward``: dx's and dscale's error against float64 within
``chip_smoke.py``'s bounds, whether two runs give the same bits, the
device time by CUDA graph with the inputs in L2 and (at the three training
shapes) out of it, the host µs a call, and each CUDA kernel's mean device
µs from ``torch.profiler``; and the library's backward
(``torch.autograd.grad`` of ``F.rms_norm``) by the same graphs. The timing
helpers, the bounds and the float64 oracle are ``chip_smoke.py``'s. Needs
a card: without one, or with a result off its bound, it exits 1.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]


def profile_us(fn, calls: int = 50) -> dict:
    """Mean device µs a launch of each RMSNorm CUDA kernel ``fn()`` runs,
    from ``torch.profiler`` over ``calls`` eager calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    found = {}
    for e in prof.key_averages():
        if e.device_time_total > 0 and "rmsnorm" in e.key:
            found[re.search(r"rmsnorm\w*", e.key).group(0)] = e.device_time_total / e.count
    return found


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_rmsnorm_backward: no CUDA device", file=sys.stderr)
        return 1
    # the tree's repro_torch first: chip_smoke's own imports then find it
    sys.path.insert(0, args.src)
    from repro_torch.kernels.rmsnorm import ops

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    for rows, d, dtype in cs.RMS_BWD_SHAPES:
        x = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
        scale = 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
        dy = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
        name = f"{rows}x{d} {str(dtype).split('.')[-1]}"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dx, ds = ops.rms_norm_backward(x, scale, dy)
        first_us = (time.perf_counter() - t0) * 1e6
        again = ops.rms_norm_backward(x, scale, dy)
        torch.cuda.synchronize()
        same = torch.equal(dx, again[0]) and torch.equal(ds, again[1])
        want_dx, want_ds = cs._bwd_oracle64(x, scale, dy)
        used = ((dx.double() - want_dx).abs() / cs.bwd_dx_bound(want_dx, dtype)).max().item()
        err_ds = (ds.double() - want_ds).abs().max().item() / want_ds.abs().max().item()
        ok = ok and same and used <= 1.0 and err_ds <= cs.RMS_BWD_TOL
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        lx, ls = x.clone().requires_grad_(True), scale.clone().requires_grad_(True)
        with torch.cuda.stream(side):  # autograd runs the backward on this stream
            ly = F.rms_norm(lx, (d,), ls, 1e-6)
        torch.cuda.current_stream().wait_stream(side)
        nbytes, bound_ms, _ = cs.bwd_bound(x)

        def wrapper():
            return ops.rms_norm_backward(x, scale, dy)

        ms = cs.device_ms(wrapper)
        lib_ms = cs.device_ms(
            lambda: torch.autograd.grad(ly, (lx, ls), dy, retain_graph=True), stream=side
        )
        kernels = ", ".join(f"{k} {v:.2f} us" for k, v in profile_us(wrapper).items())
        print(
            f"[wrapper] {name}: device_ms {ms:.4f} ({bound_ms / ms:.0%} of its bytes bound) | "
            f"library_device_ms {lib_ms:.4f} | host {cs.host_us(wrapper):.1f} us a call (first "
            f"{first_us:.0f} us) | dx at {used:.2f} of its bound, dscale {err_ds:.2e}, bit-equal "
            f"{same} | {kernels} | {args.src}"
        )
        if (rows, d, dtype) in cs.RMS_BWD_SHAPES[:3]:
            cs._bwd_cold_row(cs.bwd_copies(x, scale, dy, nbytes), bound_ms)  # prints its line
        del lx, ls, ly
    print(card)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
