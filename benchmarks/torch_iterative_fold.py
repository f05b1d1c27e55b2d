"""Where the iterative baselines' fold pays: the stacked session against the
per-entry loop, step by step (the PyTorch port).

    python3 benchmarks/torch_iterative_fold.py [--device cuda] [--entries 1 2 4 8 36] \
        [--image-entries 1 2 4] [--cells hard/overlap-32 fault image/halves]

For each cell and each of SplitNN (``run_vanilla_seeds``), FedBCD
(``run_fedbcd_seeds``) and FedCVT (``run_fedcvt_seeds``), it trains E
entries as one fold twice, with ``engine_mode="vmap"`` (one stacked
session) and ``"python"`` (one session an entry, one after another), and
reads the fold's ``step_ms["session"]``: the whole session's host wall,
ended by a device sync. ``ms a step`` is that over the session's steps
(FedBCD: rounds of Q = 5), so the loop's number is the time of one step of
every entry. The cells:

* ``hard/overlap-32``: K = 2 MLP parties, entries are seeds 0..E−1;
* ``fault``: the fault family's 4-party MLP condition, entries are its
  nine members × seeds 0-3 taken seed-major (the first E), each under its
  own fault, so dropouts stall entries at different steps;
* ``image/halves`` and ``image/patch-4``: K = 2 and K = 4 CNN parties,
  entries are seeds 0..E−1, at ``--image-entries``.

Each (cell, method, mode) is warmed up once at E = 1. Every row prints with
its ratio loop / stacked; the last lines are the card's ``nvidia-smi`` name
and power limit and one JSON object with every row. Imports the port only,
never JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch import scenarios  # noqa: E402
from repro_torch.core import baselines  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402

METHODS = (
    ("vanilla", baselines.run_vanilla_seeds),
    ("fedbcd", baselines.run_fedbcd_seeds),
    ("fedcvt", baselines.run_fedcvt_seeds),
)
FAULT_SEEDS = range(4)


def cell_entries(cell: str, num: int, device) -> list:
    """The first ``num`` (bundle, seed) entries of ``cell``."""
    if cell == "fault":
        names = [n for n in scenarios.names() if n.startswith("fault/")]
        order = [(n, s) for s in FAULT_SEEDS for n in names]
    else:
        order = [(cell, s) for s in range(num)]
    return [(scenarios.build(n, seed=s, device=device), s) for n, s in order[:num]]


def session_ms(impl, entries, iterations: int, mode: str, device) -> tuple:
    """(the fold's session ms, its steps, the path that ran)."""
    cfg = baselines.IterativeConfig(iterations=iterations, engine_mode=mode)
    faults = [b.spec.fault for b, _ in entries]
    res = impl(
        [s for _, s in entries], [b.split for b, _ in entries], [b.extractors for b, _ in entries],
        [b.ssl_cfgs for b, _ in entries], cfg, device=device,
        faults=faults if any(f is not None for f in faults) else None,
    )
    d = res[0].diagnostics
    return d["step_ms"]["session"], d["losses"].shape[0], d["engine_path"]


def gpu_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--entries", type=int, nargs="+", default=[1, 2, 4, 8, 36])
    ap.add_argument("--image-entries", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--iterations", type=int, default=50, help="FedBCD: /5 rounds")
    ap.add_argument("--cells", nargs="+", default=["hard/overlap-32", "fault", "image/halves"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    rows = []
    for cell in args.cells:
        sizes = args.image_entries if cell.startswith("image/") else args.entries
        pool = cell_entries(cell, max(sizes), dev)
        for method, impl in METHODS:
            for mode in ("vmap", "python"):  # warm-up: builds, caches, first launches
                session_ms(impl, pool[:1], 5 * 2, mode, dev)
            for num in sizes:
                ms = {}
                for mode in ("vmap", "python"):
                    total, steps, path = session_ms(impl, pool[:num], args.iterations, mode, dev)
                    assert path == mode, (path, mode)
                    ms[mode] = total / steps
                row = {"cell": cell, "method": method, "entries": num, "steps": steps,
                       "stacked_ms": ms["vmap"], "loop_ms": ms["python"],
                       "loop_over_stacked": ms["python"] / ms["vmap"]}
                rows.append(row)
                print(
                    f"[fold] {cell} {method} E={num}: stacked {ms['vmap']:.3f} ms a step, loop "
                    f"{ms['python']:.3f} ms a step of every entry ({ms['python'] / num:.3f} an "
                    f"entry), loop / stacked {ms['python'] / ms['vmap']:.2f} ({steps} steps)",
                    flush=True,
                )
    line = gpu_line() if dev.type == "cuda" else "cpu"
    print(line)
    print(json.dumps({"iterative_fold": rows, "device": str(dev), "card": line}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
