"""Where a model-zoo decode step's time goes on the GPU (the PyTorch port).

    python3 benchmarks/torch_zoo_profile.py [--arch phi4-mini-3.8b] [--seed 0]

Builds the config (``phi4-mini-3.8b``, or one of the MoE, SSM and hybrid
families ``chip_smoke.py`` serves) at its full width with seeded weights,
fills a batch-4 decode cache with a 40-token prompt, and traces with
``torch.profiler`` after a warm-up:

* ``decode_step``: one ``decode_fn`` step at position 40 of a 48-slot cache
  (every attention cache's index is reset before each call, so every call
  does the same work; a Mamba2 state step does the same work at any state);
* ``prefill_fn``: one 32-token prompt forward.

For each it prints the untraced host wall time (median of 3 synchronized
calls), the traced wall time, the device's busy time (the sum of kernel
times; one stream), the idle share ``1 - busy / untraced wall``, the number
of kernels launched, and the busy time by kind of kernel, with each CUDA
kernel's device time per launch. It then times the host side of single
calls at the decode step's shapes: the enqueue time per call (host clock
over 200 calls, no synchronize inside) of the two kernels' wrappers and
their plain versions (decode attention masked by the cache's stored
positions, as the step calls it), the PyTorch library calls, and one bare elementwise op as a
floor (the decode attention calls only where the config has attention).
The last line is one JSON object with the same numbers and the
card's ``nvidia-smi`` name and power limit. Needs a CUDA card; imports the
port only, never JAX.
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
sys.path.insert(0, os.path.join(ROOT, "benchmarks"))

from torch_training_profile import trace  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dops  # noqa: E402
from repro_torch.kernels.decode_attention import ref as dref  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rops  # noqa: E402
from repro_torch.kernels.rmsnorm import ref as rref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.specs import zeros_like_spec  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402

ARCHS = ("phi4-mini-3.8b", "granite-moe-3b-a800m", "mamba2-370m", "zamba2-1.2b")
BATCH, PROMPT, SLOTS, PREFILL = 4, 40, 48, 32
ENQUEUE_CALLS = 200


def enqueue_us(fn) -> float:
    """Host time per call of ``fn`` over back-to-back calls: what the host
    spends to enqueue the work (the device may still be running)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ENQUEUE_CALLS):
        fn()
    per = (time.perf_counter() - t0) / ENQUEUE_CALLS * 1e6
    torch.cuda.synchronize()
    return per


def _attention_caches(tree: dict) -> list:
    """Every attention cache (a dict holding ``index``) in a decode cache
    tree: the decoder's stacked blocks, or the hybrid's per-group caches."""
    if "index" in tree:
        return [tree]
    return [a for t in tree.values() if isinstance(t, dict) for a in _attention_caches(t)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCHS, default=ARCHS[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_zoo_profile: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = model.init(gen)
    prompt = torch.randint(
        0, cfg.vocab_size, (BATCH, PROMPT), generator=gen, device="cuda", dtype=torch.int32
    )
    cache = zeros_like_spec(model.cache_shapes(BATCH, SLOTS), "cuda")
    decode = model.decode_fn
    logits, cache = serve.prefill(decode, params, cache, prompt)
    batch = {
        "token": logits.argmax(-1).to(torch.int32)[:, None],
        "pos": torch.full((BATCH, 1), PROMPT, dtype=torch.int32, device="cuda"),
    }
    attn = _attention_caches(cache)

    def decode_step():
        for a in attn:
            a["index"].fill_(PROMPT)
        decode(params, cache, batch)

    tokens = {"tokens": prompt[:, :PREFILL]}
    units = {
        "decode_step": lambda: decode_step(),
        "prefill_fn": lambda: model.prefill_fn(params, tokens),
    }
    for fn in units.values():  # warm-up: cuBLAS handles and heuristics
        for _ in range(3):
            fn()
    result = {name: trace(fn) for name, fn in units.items()}
    n_attn = {"ssm": 0, "hybrid": cfg.num_layers // max(cfg.hybrid_attn_every, 1)}.get(
        cfg.family, cfg.num_layers
    )
    # a block's two norms (a Mamba2 block's pre-norm and gated norm), the
    # hybrid's shared block's two at each application, and the final norm
    n_norm = 2 * cfg.num_layers + 1 + (2 * n_attn if cfg.family == "hybrid" else 0)
    per_launch = {"rmsnorm (CUDA kernel)": n_norm, "decode_attention (CUDA kernel)": n_attn}

    x = torch.randn(BATCH, cfg.d_model, generator=gen, device="cuda").bfloat16()
    scale = torch.ones(cfg.d_model, device="cuda")
    scale_bf16 = scale.bfloat16()
    calls = {
        "rmsnorm kernel wrapper": lambda: rops.rms_norm(x, scale),
        "rmsnorm plain version": lambda: rref.rms_norm(x, scale),
        "F.rms_norm": lambda: F.rms_norm(x, (cfg.d_model,), scale_bf16, 1e-6),
    }
    if attn:
        dh = cfg.resolved_head_dim
        q = torch.randn(BATCH, cfg.num_heads, dh, generator=gen, device="cuda")
        k = attn[0]["k"][0].transpose(1, 2)
        v = attn[0]["v"][0].transpose(1, 2)
        key_pos = attn[0]["pos"][0]  # the path's mask: each slot's stored position
        q_pos = torch.full((BATCH,), PROMPT, dtype=torch.int32, device="cuda")
        q4 = q.bfloat16()[:, :, None, :]
        calls["decode_attention kernel wrapper"] = lambda: dops.decode_attention(
            q, k, v, key_pos=key_pos, q_pos=q_pos
        )
        calls["decode_attention plain version"] = lambda: dref.decode_attention(
            q, k, v, key_pos=key_pos, q_pos=q_pos
        )
        calls["F.scaled_dot_product_attention"] = lambda: F.scaled_dot_product_attention(
            q4, k, v, enable_gqa=True
        )
    calls["x.add_(0) (one bare op)"] = lambda: x.add_(0)
    host = {name: enqueue_us(fn) for name, fn in calls.items()}

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
    ).stdout.strip()
    for name, r in result.items():
        print(
            f"[{name}] {card}: wall {r['wall_ms']:.3f} ms (traced {r['traced_wall_ms']:.3f}), "
            f"device busy {r['busy_ms']:.3f} ms, idle share {r['idle_share']:.3f}, "
            f"{r['kernels']:.0f} kernels"
        )
        for kind, ms in r["busy_ms_by_kind"].items():
            each = ""
            if per_launch.get(kind):
                each = f"  ({ms / per_launch[kind] * 1e3:.2f} us a launch)"
            print(f"    {kind:<32} {ms:8.3f} ms  {ms / r['busy_ms']:6.1%} of busy{each}")
    for name, us in host.items():
        print(f"[host] {name}: {us:.1f} us to enqueue a call ({card})")
    print(json.dumps({"device": card, "arch": args.arch, "batch": BATCH, **result, "enqueue_us": host}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
