"""Witnesses for a zoo train run's loss curve on the GPU (the PyTorch port).

    python3 benchmarks/torch_zoo_train_lr.py

Trains phi4-mini at full width over 4 of its 32 layers, 12 steps at lr
3e-4, on the fixed batch of ``chip_smoke.py``'s ``[zoo-train]`` (seed 0,
batch 8 x seq 128, clip 1.0 + Adam) four ways, each from the same seeded
weights:

* ``port``: ``launch/steps.py``'s train step with the port's ``optim.Adam``,
  the config's activations (bf16), the RMSNorm kernels forward and backward;
* ``torch_adam``: the same loss and gradients, then
  ``torch.nn.utils.clip_grad_norm_`` and ``torch.optim.Adam`` (the library's
  optimizer in place of the port's);
* ``f32``: the port's step with f32 activations;
* ``f32_torch_adam_plain_norm``: f32 activations, ``torch.optim.Adam``, and
  every norm through its plain PyTorch version under autograd (neither the
  port's optimizer nor its kernels nor bf16).

It prints each run's losses and how far each witness's losses are from the
port's (relative to the port's), so a swing of the loss that all four share
is the training dynamics at that learning rate and not a fault of the
port's optimizer, kernels or bf16 path. The last line is one JSON object
with the same numbers and the card's ``nvidia-smi`` name and power limit.
Needs a CUDA card; imports the port only, never JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import make_token_stream  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rops  # noqa: E402
from repro_torch.kernels.rmsnorm import ref as rref  # noqa: E402
from repro_torch.launch.steps import make_optimizer, make_train_step  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402

VARIANTS = ("port", "torch_adam", "f32", "f32_torch_adam_plain_norm")
SEED, BATCH, SEQ, CLIP = 0, 8, 128, 1.0
ARCH, LAYERS, LR, STEPS = "phi4-mini-3.8b", 4, 3e-4, 12


@contextlib.contextmanager
def plain_norm():
    """Every zoo norm through ``ref.rms_norm`` (plain PyTorch, autograd's own
    backward) while inside."""
    kernel = rops.rms_norm
    rops.rms_norm = rref.rms_norm
    try:
        yield
    finally:
        rops.rms_norm = kernel


def run(variant: str) -> list:
    """The losses of STEPS train steps of one variant."""
    cfg = dataclasses.replace(get_config(ARCH), num_layers=LAYERS)
    if variant.startswith("f32"):
        cfg = dataclasses.replace(cfg, activation_dtype="float32")
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = model.init(gen)
    tokens, labels = make_token_stream(gen, BATCH, SEQ, cfg.vocab_size)
    batch = {"tokens": tokens, "labels": labels}
    ps = list(params.parameters())
    losses = []
    with plain_norm() if variant.endswith("plain_norm") else contextlib.nullcontext():
        if "torch_adam" in variant:
            opt = torch.optim.Adam(ps, lr=LR, betas=(0.9, 0.999), eps=1e-8, foreach=True)
            for _ in range(STEPS):
                loss = model.loss_fn(params, batch)
                grads = torch.autograd.grad(loss, ps, allow_unused=True, materialize_grads=True)
                for p, g in zip(ps, grads):
                    p.grad = g
                torch.nn.utils.clip_grad_norm_(ps, CLIP, foreach=True)
                opt.step()
                opt.zero_grad(set_to_none=True)
                losses.append(float(loss.detach()))
        else:
            tx = make_optimizer(cfg, LR, CLIP)
            opt, step = tx.init(ps), make_train_step(model, tx)
            losses = [float(step(params, opt, batch)) for _ in range(STEPS)]
    del params, opt, model
    torch.cuda.empty_cache()
    return losses


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_zoo_train_lr: no CUDA device is visible", file=sys.stderr)
        return 1
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    runs = {}
    for variant in VARIANTS:
        runs[variant] = run(variant)
        print(f"[lr] {ARCH} ({LAYERS} layers) lr {LR} {variant}: losses {runs[variant]}")
    port = runs["port"]
    off = {
        v: max(abs(a - b) / abs(b) for a, b in zip(runs[v], port)) for v in VARIANTS if v != "port"
    }
    for v, rel in off.items():
        print(f"[lr] {v} vs port: max relative difference of the losses {rel:.3e}")
    print(gpu)
    print(json.dumps({
        "arch": ARCH, "layers": LAYERS, "lr": LR, "steps": STEPS,
        "losses": runs, "vs_port": off, "gpu": gpu,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
