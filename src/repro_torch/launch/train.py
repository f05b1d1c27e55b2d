"""Single-card training of a model-zoo architecture on synthetic token streams.

Counterpart of ``repro.launch.train``: the zoo's end-to-end training path.
Each step draws a token stream (Zipf-like ids, labels the next token) from
one seeded generator, plus 0.02·N(0, 1) bf16 ``embeds`` for the vlm and
audio families, and runs ``steps.make_train_step`` (clip 1.0, then Adam at
``--lr``, or SGD with momentum for an ``sgdm`` config). On the card every
norm runs the RMSNorm kernel forward and backward. ``--ckpt-dir`` saves the
parameters in the reference's layout through ``checkpoint.save_checkpoint``,
which the reference's ``load_checkpoint`` reads.

CLI::

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \\
        [--reduce] --steps 50 --batch 8 --seq 128 [--device cpu]

Without ``--device cpu`` it runs on ``cuda`` and raises where there is no
card. Weights are random, drawn from ``--seed``.
"""

from __future__ import annotations

import argparse
import time
from typing import Tuple

import torch
from torch import nn

from repro_torch import bridge
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.data.synthetic import make_token_stream
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.steps import make_optimizer, make_train_step
from repro_torch.models.model_zoo import build_model


def train(
    cfg: ArchConfig,
    steps: int,
    batch: int = 8,
    seq: int = 128,
    lr: float = 3e-4,
    seed: int = 0,
    device: DeviceLike = None,
    log_every: int = 10,
) -> Tuple[nn.Module, float]:
    """``steps`` train steps of ``cfg`` from weights and data drawn from one
    generator seeded with ``seed`` on ``device``; prints the loss every
    ``log_every`` steps and returns (the trained parameter module, the last
    loss)."""
    dev = resolve_device(device)
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = model.init(gen)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"arch={cfg.name} params={n_params / 1e6:.2f}M on {dev}")

    tx = make_optimizer(cfg, lr)
    opt_state = tx.init(list(params.parameters()))
    step_fn = make_train_step(model, tx)

    t0 = time.perf_counter()
    loss = torch.zeros(())
    for step in range(steps):
        tokens, labels = make_token_stream(gen, batch, seq, cfg.vocab_size)
        data = {"tokens": tokens, "labels": labels}
        if cfg.family in ("vlm", "audio"):
            embeds = torch.randn((batch, cfg.prefix_tokens, cfg.d_model), generator=gen, device=dev)
            data["embeds"] = (0.02 * embeds).to(torch.bfloat16)
        loss = step_fn(params, opt_state, data)
        if step % log_every == 0 or step == steps - 1:
            print(
                f"step {step:5d} loss {float(loss):.4f} "
                f"({(time.perf_counter() - t0) / (step + 1):.2f}s/step)"
            )
    return params, float(loss)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    ap.add_argument("--arch", default="mamba2-370m")
    ap.add_argument("--reduce", action="store_true", help="the config's 2-layer smoke variant")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduce:
        cfg = cfg.reduced()
    params, loss = train(
        cfg, args.steps, args.batch, args.seq, args.lr, args.seed, args.device, args.log_every
    )
    if args.ckpt_dir:
        tree = bridge.zoo_params_to_reference(params)
        path = save_checkpoint(args.ckpt_dir, args.steps, tree, {"arch": cfg.name, "loss": loss})
        print(f"saved {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
