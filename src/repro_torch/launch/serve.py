"""Batched model-zoo serving: prefill a prompt batch, then decode greedily.

Counterpart of ``repro.launch.serve``. :func:`prefill` steps the decoder over
the prompt one token at a time (cache-exact), :func:`greedy_decode`
continues from the last logits, and every step is timed through the port's
``launch/batching.LatencyRecorder``, the stopwatch the VFL serving path
reports p50/p99 with, to the step's end on the card. The reference jits the
step and donates the cache; here the step runs eagerly and updates the
cache in place.

The cache is the model's own tree: a dense, MoE or vlm model's KV cache
(MLA's latent cache for deepseek; a ring of ``window`` slots under a
sliding window), the SSM family's conv buffers and states (no positions: its
decode ignores ``pos``), the hybrid's both, or the audio family's decoder
KV cache with the encoder's output ``enc_out``, which is filled by
encoding 0.02·N(0, 1) frame embeddings (:func:`make_cache`), as the
reference's ``launch/serve.py`` does.

CLI::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b \\
        [--reduce] --batch 4 --prompt-len 32 --gen 16 [--device cpu]

``--arch`` takes every zoo config: the dense ones, ``granite-moe-3b-a800m``
(MoE), ``deepseek-v2-236b`` (MLA + MoE), ``qwen2-vl-72b`` (vlm, M-RoPE),
``mamba2-370m`` (SSM), ``zamba2-1.2b`` (hybrid) and
``seamless-m4t-large-v2`` (audio encoder-decoder). Without ``--device cpu``
it runs on ``cuda`` and raises where there is no card. Weights are random,
drawn from ``--seed``.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Optional, Tuple

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch import specs as SP
from repro_torch.launch.batching import LatencyRecorder
from repro_torch.launch.steps import make_decode_step
from repro_torch.models.model_zoo import _encode, build_model


def prefill(
    decode: Callable, params, cache, prompt: torch.Tensor, rec: Optional[LatencyRecorder] = None
):
    """Step the decoder over the (B, S) prompt tokens. Returns the
    last-position logits and the filled cache."""
    b, prompt_len = prompt.shape
    logits = None
    for t in range(prompt_len):
        pos = torch.full((b, 1), t, dtype=torch.int32, device=prompt.device)
        batch = {"token": prompt[:, t : t + 1], "pos": pos}
        logits, cache = _timed_decode(decode, params, cache, batch, rec, b)
    return logits, cache


def greedy_decode(
    decode: Callable,
    params,
    cache,
    logits: torch.Tensor,
    start: int,
    steps: int,
    rec: Optional[LatencyRecorder] = None,
) -> Tuple[torch.Tensor, dict]:
    """Greedy continuation for ``steps`` tokens from position ``start``.
    Returns the (B, steps) generated tokens (int32) and the cache."""
    b = logits.shape[0]
    generated = []
    for t in range(start, start + steps):
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        generated.append(tok)
        pos = torch.full((b, 1), t, dtype=torch.int32, device=logits.device)
        logits, cache = _timed_decode(decode, params, cache, {"token": tok, "pos": pos}, rec, b)
    return torch.cat(generated, dim=1), cache


def make_cache(model, params, batch: int, cache_len: int, device, generator: torch.Generator):
    """The model's zero decode cache for ``batch`` sequences of
    ``cache_len`` steps on ``device``. An audio model's ``enc_out`` holds the
    encoder's output over 0.02·N(0, 1) frame embeddings drawn from
    ``generator`` (the stub frontend, as the reference's ``launch/serve.py`` fills it)."""
    cfg = model.cfg
    cache = SP.zeros_like_spec(model.cache_shapes(batch, cache_len), device)
    if cfg.family == "audio":
        shape = (batch, cfg.prefix_tokens, cfg.d_model)
        emb = 0.02 * torch.randn(shape, generator=generator, device=device)
        with torch.no_grad():
            cache["enc_out"] = _encode(params, cfg, emb).to(cache["enc_out"].dtype)
    return cache


def _timed_decode(decode, params, cache, batch, rec: Optional[LatencyRecorder], rows: int):
    if rec is None:
        return decode(params, cache, batch)
    t0 = time.perf_counter()
    logits, cache = decode(params, cache, batch)
    if logits.is_cuda:
        torch.cuda.synchronize(logits.device)
    rec.record(time.perf_counter() - t0, rows)
    return logits, cache


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    ap.add_argument("--arch", default="phi4-mini-3.8b")
    ap.add_argument("--reduce", action="store_true", help="the config's 2-layer smoke variant")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduce:
        cfg = cfg.reduced()
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = model.init(gen)
    b = args.batch
    cache = make_cache(model, params, b, args.prompt_len + args.gen, dev, gen)
    decode = make_decode_step(model)
    prompt = torch.randint(
        0, cfg.vocab_size, (b, args.prompt_len), generator=gen, device=dev, dtype=torch.int32
    )

    rec = LatencyRecorder()
    logits, cache = prefill(decode, params, cache, prompt, rec=rec)
    out, cache = greedy_decode(decode, params, cache, logits, args.prompt_len, args.gen, rec=rec)
    s = rec.summary()
    print(
        f"arch={cfg.name} on {dev} generated {tuple(out.shape)}: "
        f"p50={s['p50_ms']:.2f}ms/step p99={s['p99_ms']:.2f}ms/step "
        f"{s['rows_per_s']:.1f} tok/s"
    )
    print("sample:", out[0][:16].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
