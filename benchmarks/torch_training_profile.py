"""Where one-shot training's time goes on the GPU (the PyTorch port).

    python3 benchmarks/torch_training_profile.py [--seed 0]

Sets up the full-width image configuration that ``chip_smoke.py`` trains
(one-shot B: K = 2 (32, 16, 3) halves, the CNN at its defaults, N_o = 2048,
batch 32 with μ = 2) on seeded data, and traces three units of its
training path with ``torch.profiler`` after a warm-up:

* ``ssl_steps``: 8 local-SSL steps of one party (``train_party_ssl`` over
  256 labeled rows, one epoch): augmentations, three CNN passes, backward,
  clip and momentum update;
* ``kmeans``: step ③ on two parties' (2048, 128) gradient matrices
  (k-means++ seeding, 25 Lloyd iterations, inertia, final assignment);
* ``server_fit``: one epoch (64 steps) of the joint classifier's fit.

For each it prints the untraced host wall time (median of 3 synchronized
calls), the traced wall time, the device's busy time (the sum of kernel
times; one stream), the idle share ``1 - busy / untraced wall``, the number
of kernels launched, and the busy time by kind of kernel. The last line is
one JSON object with the same numbers and the card's ``nvidia-smi`` name
and power limit. Needs a CUDA card; imports the port only, never JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "benchmarks"))

from torch_serving_profile import _kind, wall_ms  # noqa: E402

from repro_torch.checkpoint import ExtractorSpec  # noqa: E402
from repro_torch.core import server  # noqa: E402
from repro_torch.core.client import make_client, ssl_task_for  # noqa: E402
from repro_torch.core.ssl import SSLConfig  # noqa: E402
from repro_torch.engine import dispatch  # noqa: E402
from repro_torch.engine.local_ssl import SSLHParams, train_party_ssl  # noqa: E402
from repro_torch.models.extractors import make_classifier  # noqa: E402

SSL_STEPS = 8
N_O = 2048


def trace(fn, per: int = 1) -> dict:
    """Untraced and traced wall time, busy time, launches and per-kind
    device time of ``fn``, each divided by ``per`` (units in one call)."""
    untraced = statistics.median(wall_ms(fn) for _ in range(3))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced = wall_ms(fn)
    by_kind: dict = {}
    launches = 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            launches += 1
            kind = _kind(ev.name)
            by_kind[kind] = by_kind.get(kind, 0.0) + ev.time_range.elapsed_us() / 1e3
    busy = sum(by_kind.values())
    return {
        "per_call_units": per,
        "wall_ms": untraced / per,
        "traced_wall_ms": traced / per,
        "busy_ms": busy / per,
        "idle_share": 1.0 - busy / untraced,
        "kernels": launches / per,
        "busy_ms_by_kind": {k: v / per for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1])},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_training_profile: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    host = torch.Generator().manual_seed(args.seed)
    spec = ExtractorSpec(kind="cnn", rep_dim=128, widths=(32, 64, 128), blocks_per_stage=2)
    client = make_client(0, spec, (32, 16, 3), 10, SSLConfig(modality="image"), host, dev)
    x_l = torch.randn(32 * SSL_STEPS, 32, 16, 3, generator=gen, device=dev)
    x_u = torch.randn(22976, 32, 16, 3, generator=gen, device=dev)
    y = torch.randint(0, 10, (x_l.shape[0],), generator=gen, device=dev)
    task = ssl_task_for(client, x_l, y, x_u)
    hp = SSLHParams(epochs=1)
    grads = torch.randn(2, N_O, 128, generator=gen, device=dev)
    h = torch.randn(N_O, 256, generator=gen, device=dev)
    labels = torch.randint(0, 10, (N_O,), generator=gen, device=dev)
    head = make_classifier(256, 10).init_(host).to(dev)
    schedule = server.fit_schedule(args.seed, N_O, 1, 32)

    units = {
        "ssl_steps": (lambda: train_party_ssl(task, hp, args.seed, generator=gen), SSL_STEPS),
        "kmeans": (lambda: dispatch.pseudo_labels_batched(grads, 10, 25, 4, generator=gen), 1),
        "server_fit": (lambda: server.fit(head, h, labels, schedule, 0.01), schedule.shape[0]),
    }
    for fn, _ in units.values():  # warm-up: cuDNN algorithm choice, kernel build
        fn()
    result = {name: trace(fn, per) for name, (fn, per) in units.items()}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
    ).stdout.strip()
    for name, r in result.items():
        print(
            f"[{name}] {card}: per unit (1/{r['per_call_units']} of a call) "
            f"wall {r['wall_ms']:.3f} ms "
            f"(traced {r['traced_wall_ms']:.3f}), device busy {r['busy_ms']:.3f} ms, idle share "
            f"{r['idle_share']:.3f}, {r['kernels']:.0f} kernels"
        )
        for kind, ms in r["busy_ms_by_kind"].items():
            print(f"    {kind:<28} {ms:8.3f} ms  {ms / r['busy_ms']:6.1%} of busy")
    print(json.dumps({"device": card, **result}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
