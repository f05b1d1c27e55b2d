"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``repro_torch`` (never JAX, never the reference package) through its
paths: training (one-shot, few-shot, the iterative baselines, few-shot +
finetune, fault injection, the seed and scenario folds, and the scenario
catalog), serving,
model-zoo serving, model-zoo training, and the protocol as collectives
between party processes. Phases, each of
which fails the run (nonzero exit, no result line) if it goes wrong:

1. device: name, count, power limit; TF32 off for matmuls and cuDNN;
2. kernels: build every CUDA kernel from ``src/repro_torch/kernels/*/csrc``
   (one nvcc per kernel, in parallel), then hold each kernel against its
   plain PyTorch version on the card at its path's shapes, timing the
   kernel, the plain version, and one PyTorch library call computing the
   same function (CUDA events over back-to-back calls), and the kernel's
   device time from a CUDA graph of the same calls (``device_ms``, also
   the library call's); and the Eq. 10 and decode-attention kernels under
   key-range plans other than the wrapper's, and the k-means kernel on
   both of its routes and under several centre-range plans, each timed and
   held against a float64 plain version; and the Eq. 10 kernel at the
   catalog's new step ③' shapes (width 7 over stride-0 views, bf16 reps),
   at the fault path's (⑤ / ⑥' reconstruction, degraded evaluation) and at
   the folds' (③' over stacked entries; the Lloyd launch over S·C·K·R);
3. one-shot A (the training path): Alg. 1 on the port's own
   ``hard/overlap-32`` data (two parties, MLP 20→64→16, N_o = 32, 80 client
   and 40 server epochs): 3 comm times, 12288 bytes, k-means purity > 0.5
   on both parties, AUC > 0.6;
4. one-shot B (the training path at full width): Alg. 1 on 60000 synthetic
   CIFAR-like images split into K = 2 (32, 16, 3) halves, the
   WideResNet-style CNN at its defaults (widths 32/64/128, two blocks per
   stage, 128-wide representations), a linear 256 → 10 head, N_o = 2048:
   3 comm times, 6291456 bytes, purity > 0.5, accuracy > 0.2; each step
   timed; its epochs cut to B_CLIENT_EPOCHS and B_SERVER_EPOCHS;
5. few-shot A (Alg. 2, the training path's second round): ``hard/overlap-32``
   at its budgets, the client epochs cut A_FEW_EPOCH_CUT-fold (20 client
   and 40 server epochs): 5 comm times, 177408
   bytes, AUC > 0.6; step ③' (one ``sdpa_estimator`` launch a party, at
   (1, 1184, 32, 16, 16)) recomputed on the CPU's plain route from the same
   reps and heads: estimates within KERNEL_TOL, gate decisions equal
   outside near-ties (counted);
6. few-shot B: Alg. 2 on one-shot B's configuration, ③' at (1, 22976, 2048,
   128, 128), ``client_epochs`` cut to FEW_B_CLIENT_EPOCHS and
   ``server_epochs`` to B_SERVER_EPOCHS: 5 comm times,
   32099840 bytes, accuracy > 0.2, the same ③' check; each step timed;
7. baselines A: SplitNN (``run_vanilla``), FedBCD and FedCVT on
   ``hard/overlap-32`` at its 400 iterations: AUC > 0.5 each, the exact
   ledgers (3276800, 655360 and 6553600 bytes in 800, 160 and 800 comm
   times), ms an iteration; one-shot A's AUC margin and byte ratio over
   vanilla on the same split;
8. baselines B: the three at one-shot B's configuration, cut to
   B_BASELINE_ITERATIONS (SplitNN and FedCVT 200, FedBCD 150 rounds of
   Q = 5): accuracy > 0.2, 13107200, 9830400 and 26214400 bytes; and B's
   first 5 SplitNN iterations on the card against the CPU from the same parameters
   (losses and parameters within LOGIT_RTOL), beside the CPU against
   itself at one thread. No kernel launches in 7-8;
9. few-shot + finetune A: ``run_few_shot_finetune`` on ``hard/overlap-32``
   at few-shot A's budget and 200 finetune iterations: 1815808 bytes in 405 comm
   times, its few-shot pass's AUC equal to few-shot A's, AUC > 0.6; 2
   ``sdpa_estimator`` and 27 ``kmeans`` launches;
9a. faults: the nine ``fault/*`` members (one 4-party condition; dropouts
   of party 1 at four stages, a straggler, dp noise at σ 0.1 and 0.5, a
   frozen party, the fault-free twin) through ``scenarios.build`` on the
   card and the runners' ``fault`` argument at their sizes and budgets:
   one-shot at seeds 0-3, held to the reference gate's rule
   (``fault_families`` in ``benchmarks/frontier_baseline.json``: the twin's
   mean AUC > 0.6, every member's mean at most ``max_oneshot_drop`` below
   it, 3 survivors on a dropout, 4 elsewhere); few-shot at seed 0 and a
   quarter of the client epochs (finite,
   its Δ against the twin printed); SplitNN, FedBCD and FedCVT on the twin
   and the four dropouts at 200 iterations (retry bytes in the ledger);
   every ledger equal to FAULT_LEDGERS; every Eq. 10 reconstruction (⑤,
   ⑥', the evaluation) within KERNEL_TOL of the CPU's plain route on the
   run's own inputs;
9b. the folds: the fault family as ONE ``run_scenarios_seeds`` group a
   protocol on [faults]' own splits (held bit-equal): one-shot at seeds 0-3
   (144 stacked entries), few-shot at seed 0 (36), each ledger equal to
   FAULT_LEDGERS, the reference gate's outcomes equal to the loop's, every
   metric within FOLD_METRIC_TOL of the loop's; the first FOLD_PARAM_STEPS
   stacked ④ steps against the one-party loop on the card (parameters within
   LOGIT_RTOL of the largest); SplitNN, FedBCD and FedCVT each as ONE
   ``run_scenarios_seeds`` group over the nine members × seeds 0-3 (36
   entries of one stacked session, each stalling at its own step) at 200
   iterations, each ledger equal to FAULT_LEDGERS, the dropouts with 3
   survivors and the straggler and dp members unmodeled, the seed-0 entries
   of FAULT_ITERATIVE within FOLD_METRIC_TOL of [faults]' loop; the first
   ITER_CONTRAST_ITERATIONS iterations of each stacked and by the per-entry
   loop on the card (parameters within LOGIT_RTOL of the largest);
   ``benchmarks/torch_frontier.py`` on
   ``hard/overlap-{32,64}`` at seeds 0-3 (one-shot, few-shot, iterative,
   FedCVT at the registered sizes and budgets) and its gate against
   ``benchmarks/frontier_baseline.json`` (every violation fails the run
   but the FOLD_GATE_REPORTED miss within its margin, printed); fold and
   loop wall times side by side; exact ``kmeans`` (27 a folded group) and Eq. 10 launches;
9b'. the mesh (``ProtocolConfig.mesh``, ``IterativeConfig.mesh``), every
   row on ``hard/overlap-32`` unsharded and on ``BatchMesh((cuda:0,
   cuda:0))``, whose two slots share the card and run the padded (3
   entries → 4), split, per-slot and gathered path: one-shot at its budget
   and few-shot at few-shot A's over MESH_SEEDS (one fold); SplitNN, FedBCD
   (Q = 5) and FedCVT at 400 iterations over MESH_SEEDS, stacked; few-shot
   + finetune at finetune A's budget (20 client epochs, 200 finetune
   iterations) over MESH_FINETUNE_SEEDS, its finetune session stacked on
   the mesh: the metric, every leaf and every loss within
   MESH_TOL, equal ledgers, ``device_fold`` 2 and 1, and each run's
   ``kmeans`` (27 a slot a pass) and ``sdpa_estimator`` (③': one a party a
   slot) launches exact, none from a baseline or the finetune session; the
   visible cards, each run's wall time and the iterative rows' time;
9c. the scenario catalog: one-shot and few-shot through ``scenarios.build``
   on the card, ``run_one_shot`` and ``run_few_shot`` at seed 0 and the
   registered sizes and budgets (a tabular scenario's client epochs cut
   CATALOG_EPOCH_CUT-fold) on every non-fault scenario but
   ``hard/overlap-32`` (17: the credit overlap sweep, feature skew, label
   noise, 4 and 8 parties, the hard and padded equal-shape pairs, full
   overlap, image halves and patches), each held to its ledger
   (CATALOG_LEDGERS), 3 or 5 comm times and its bar (AUC > 0.6; an image
   scenario's mean accuracy over seeds 0-7, seeds 1-7 as one fold, above
   chance by two standard errors; few-shot skipped on ``hard/overlap-64-eq``, which is
   ``hard/overlap-64`` row for row, and on ``hard/overlap-64``, whose few-shot
   [folds]' frontier runs at seeds 0-3 and holds to the same ledger and, at
   seed 0, the same bar); SplitNN beside the sweep at 400
   iterations (Fig. 6/7: metric and byte ratio at each N_o); ③' against
   the CPU's plain route at widths 7 and 3; ``hard/overlap-32`` with bf16
   reps: 6144 and 93440 bytes, ③' within BF16_STEP3P_TOL;
10. serving (K = 2): the model B trained, ragged requests through
   ``serve_traffic`` at capacity 1024, held against the unbatched
   ``predict_logits``;
11. partial-party queries (K = 2 over B's 2048 refreshed overlap reps: one
   B = 1 launch each; K = 4 (16, 16, 3) patches with seeded random weights:
   one B = 3 launch each), held against the plain route on the same inputs;
11a. deploy: B's, A's and the patches' artifacts saved with the port's
   ``save_artifact`` and loaded back on the card: logits on 1024 rows
   bit-identical to the in-memory artifact's, and B's partial-party logits
   too; each reloaded artifact served through the fused, session-cached
   ``ServingEngine`` at capacities 1, 64 and 1024 by
   ``benchmarks/torch_serving.py::bench_artifact`` over DEPLOY_REQUESTS
   requests a capacity (the path the rule chose at each, p50 / p99 /
   rows/s, no fresh ``"serving"`` miss after the first
   capacity; the patches take the stacked path up to 64 rows and the
   composed one at 1024); A (``hard/overlap-32``) held to the reference's
   serving gate (``check_serving_gate`` against the unchanged
   ``benchmarks/serving_baseline.json``): any violation fails; the CNNs'
   batched vs unbatched logits within LOGIT_RTOL;
12. zoo, small: reduced phi4-mini (2 layers, G = 2, f32 activations) served
   on the card and on the CPU's plain route with the same weights: equal
   greedy tokens, logits within 1e-4, 5 RMSNorm and 2 decode-attention
   launches a step;
13. zoo, full width (the third path): ``phi4-mini-3.8b`` at its own config
   (3,836,021,760 f32 parameters, seeded on the card). ``launch/serve``'s
   prefill + greedy decode at batch 4, prompt 32, 16 new tokens, once to
   warm up and once timed (p50/p99 per token step, tokens/s, peak memory);
   prefill ≡ sequential decode in f32 activations (max relative logit
   difference <= 1e-4); one ``make_zoo_extractor`` forward. Each part's
   RMSNorm and decode-attention launches are checked exactly: 2L + 1 = 65
   and L = 32 per decode step, 65 and 0 per ``prefill_fn`` or extractor
   forward;
14. zoo families, small: the reduced ``granite-moe-3b-a800m`` (MoE),
   ``mamba2-370m`` (SSM), ``zamba2-1.2b`` (hybrid), ``deepseek-v2-236b``
   (MLA + MoE), ``qwen2-vl-72b`` (vlm, M-RoPE), ``seamless-m4t-large-v2``
   (audio encoder-decoder, ``enc_out`` encoded from the same frames on each
   device) and phi4-mini under a window of 4 (a ring wrapped four times) in
   f32 activations served on the card and on the CPU's plain route with the
   same weights: every decode step's logits within 1e-4, equal greedy
   tokens, exact launches a step (the MoE runs' smallest top-k gate margin
   printed);
15. zoo families, full width (the fourth path), one config at a time, the
   card freed between them: the exact parameter count, ``launch/serve``'s
   prefill + greedy decode at batch 4, prompt 32, 16 new tokens, warm-up
   and timed (p50/p99 per token step, tokens/s, peak memory), and prefill
   ≡ sequential decode in f32 activations with the f32-cast cache (the
   MoEs at capacity factor 8, drop-free at prefill; seamless with an f32
   ``enc_out``) within 1e-4. deepseek-v2 runs 3 of its 60 layers and
   qwen2-vl 4 of its 80 (ZOO_DEPTH: the full depth does not fit the card);
   qwen2-vl also prefills its 1024-row patch prefix with 1024 text tokens;
   phi4-mini last, under a window of 16: its 16-slot ring wraps twice over
   a serve run's 48 positions, and prefill ≡ ring decode over all 48.
   Launches a decode step, checked exactly: granite 65 RMSNorm and 32
   decode attention, mamba2 97 and 0, zamba2 89 and 6, deepseek-v2 13 and
   0 (MLA decodes absorbed, in plain torch), qwen2-vl 9 and 4, seamless 73
   and 24, windowed phi4 65 and 32; a ``prefill_fn`` the same RMSNorm count
   and no decode attention, but seamless's 122 (its encoder's 49 more, as
   each serve run's ``enc_out``);
16. zoo training (the fifth path): ``mamba2-370m`` at full width and depth
   and ``phi4-mini-3.8b`` at full width over 4 of its 32 layers train on
   one fixed batch of 8 × 128 tokens through ``launch/steps``'
   ``make_train_step`` (clip 1.0 + Adam, remat): one warm-up step and 6
   timed ones (the loss of each, p50 / p99 ms a step, tokens/s, peak
   memory, model FLOPs from ``roofline.model_flops`` and TFLOP/s), the
   losses finite and the last below the first, and the RMSNorm forward
   and backward launches of every step exact (193 / 97 and 17 / 9); then a
   2-layer reduced variant of each trains 3 steps on the card and the CPU
   from the same weights and batch: first-step gradients per leaf and
   every loss within 1e-4;
17. a zoo backbone in Alg. 1 (the sixth path): the reference's
   ``test_zoo_backbone_extractor_in_protocol`` on the port's own sequence
   data on the card (``ZooExtractorSpec``, token SSL): accuracy > 0.4,
   24576 bytes (the reference's ledger of that split) in 3 comm times,
   27 k-means launches and the RMSNorm kernel launched both ways;
18. the protocol as collectives between party processes (``[vfl-step]``,
   the seventh path): ``launch/vfl_step.py`` as two gloo ranks on cuda:0
   and, spawned at the same time, two on the CPU, each pair running 20
   vanilla steps and the one-shot session (100 local steps) at the
   reference example's sizes (F 64, H 128, R 32, C 10, B 256, pool 1024)
   and the session on ``hard/overlap-32``'s split, every session in f32
   and bf16 reps, all on the same CPU-drawn draws: the collectives counted
   in each rank (2 a vanilla step, 3 a session, their kinds), one-shot's
   payload over the parties equal to ``run_one_shot``'s ledger on
   ``hard/overlap-32`` (12288, 6144 bytes), exactly ``kmeans_iters + 2`` =
   10 ``kmeans`` launches a card rank a session and none on the CPU, and
   each card rank's final extractor and loss within VFL_STEP_TOL of the
   largest parameter of the CPU rank's;
19. the multi-pod dry-run (``[dryrun]``, after 13): ``python -m
   repro_torch.launch.dryrun`` in two subprocesses started together on
   the CPU's fake mesh, ``mamba2-370m`` × ``long_500k`` at 16x16 and
   2x16x16 and ``phi4-mini-3.8b`` × ``decode_32k`` at 16x16: each record's
   parameter count equal to ``param_shapes()``'s, positive per-device dot
   FLOPs and traffic, the children never initialising CUDA, this
   process's card memory unchanged;
20. the trace counter on the card (``[roofline]``, the eighth path):
   ``roofline.trace_analysis.TraceCounter`` over one full-width phi4-mini
   decode step with 13's weights (the ``rmsnorm`` and ``decode_attention``
   kernels declaring their costs): its kernel calls equal the launches,
   the 2-layer variant's dot FLOPs equal the CPU plain route's to the
   FLOP, and the step floor's weight bytes <= the memory term <= the
   measured p50; 19 and 20 within ROOFLINE_BUDGET_S.

The RMSNorm backward has ``[kernel] rmsnorm_backward`` rows at the
training path's shapes (1024 rows at d 1024 and 3072 in bf16 and 2048 in
f32; the zoo extractor's 512 × 256 bf16; a ragged 231 × 130), held to a
float64 plain version and run twice for equal bits, with its plain and
library (``autograd.grad`` of ``F.rms_norm``) times and the wrapper's host
µs a call (its first call, which checks the inputs and builds the plan,
apart); at the three training shapes, the kernel's and the library's
device times with their inputs out of L2 (copies taken in turn, together
three times the L2), the kernel's against its bytes bound; and
``[plan] rmsnorm_backward`` rows at the three training shapes
under other splits than the wrapper's (slots a thread, row groups a
block, partial rows), each held against float64 and timed.

The RMSNorm and decode-attention ``[kernel]`` rows include the families'
shapes (d 1536, 1024, 2048, 5120 and 8192 in bf16, the gated norm's 2048
and 4096 and MLA's latent norms' 1536 and 512 in f32; dh 64 at G = 3 and
G = 1, dh 128 at G = 8, and a 16-slot ring under a window of 16), and
every row is also held against a float64 plain version.

Kernel launch counters are set to 0 just before each path (phases 3-4, then
5-6, then 7-8, then 9, then 9a, then 9b, then 9b', then 9c, then 10-11a, then 13,
then 19-20, then 15, then 16, then 17, then 18, whose launches each rank
process counts for itself) and read just after. Output ends
with a ``{"kernels": [...]}`` line,
the card's ``nvidia-smi`` name and power limit, and, last, the result line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import scenarios  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    ExtractorSpec,
    init_artifact,
    load_artifact,
    save_artifact,
)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import INPUT_SHAPES, InputShape  # noqa: E402
from repro_torch.core import baselines, estimator  # noqa: E402
from repro_torch.core.protocol import (  # noqa: E402
    KMEANS_RESTARTS,
    ProtocolConfig,
    run_few_shot,
    run_few_shot_finetune,
    run_one_shot,
    run_scenarios_seeds,
    run_seeds,
)
from repro_torch.core.server import VFLServer  # noqa: E402
from repro_torch.core.ssl import SSLConfig  # noqa: E402
from repro_torch.data import VerticalSplit, make_sequence_classification, make_token_stream  # noqa: E402
from repro_torch.engine import dispatch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dops  # noqa: E402
from repro_torch.kernels.decode_attention import ref as dref  # noqa: E402
from repro_torch.kernels.kmeans import ops as kops  # noqa: E402
from repro_torch.kernels.kmeans import ref as kref  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rops  # noqa: E402
from repro_torch.kernels.rmsnorm import ref as rref  # noqa: E402
from repro_torch.kernels.sdpa_estimator import ops, ref  # noqa: E402
from repro_torch.launch import serve, vfl_step  # noqa: E402
from repro_torch.launch.specs import leaves, zeros_like_spec  # noqa: E402
from repro_torch.launch.steps import make_optimizer, make_train_step  # noqa: E402
from repro_torch.launch.mesh import BatchMesh  # noqa: E402
from repro_torch.launch.vfl_serve import ServingEngine, serve_traffic, serving_path  # noqa: E402
from repro_torch.models import model_zoo  # noqa: E402
from repro_torch.models import moe as zoo_moe  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.models.zoo_extractor import ZooExtractorSpec, make_zoo_extractor  # noqa: E402
from repro_torch.roofline import HW, TraceCounter, model_flops, roofline_terms  # noqa: E402

SEED = 0
N_O = 2048  # overlap rows: the Eq. 10 keys/values
CAPACITY = 1024
# the H100's rates behind every bound (repro_torch.roofline.HW)
H100_F32_FLOPS, H100_TF32_FLOPS, H100_BYTES_PER_S = HW.f32_flops, HW.tf32_flops, HW.hbm_bw
# Kernel vs plain version: both sum in f32 in different orders (d-long dots,
# N_o-long softmax sums); outputs are convex combinations of O(1) value rows,
# so their rounding differences stay a few 1e-6. 1e-4 leaves margin and still
# catches any indexing or masking error, which moves outputs by O(0.1).
KERNEL_TOL = 1e-4
# The Eq. 10 kernel against a float64 Eq. 10, as tests/test_torch_gpu.py holds it.
F64_TOL = 2e-5
# key ranges wanted in the plan phase (ops.split_plan)
PLAN_RANGES = (1, 2, 4, 8, 16, 32, 64)
# Logits: the same f32 layers on different batch compositions (cuDNN may
# pick another convolution algorithm for a padded batch), relative to the
# logits' scale.
LOGIT_RTOL = 1e-4
# [deploy]: the reference serving gate's batch sizes (benchmarks/serving.py)
DEPLOY_CAPACITIES = (1, 64, 1024)
# [deploy]: timed requests a capacity, enough for a p99 that is not the
# largest of a handful
DEPLOY_REQUESTS = 300
# (B, N_u, N_o, d, d_b): the partial-party launches of the serving path
# (K = 2: B = 1; K = 4: B = 3), a ragged N_o, odd sizes with d != d_b,
# few-shot step ③'s query pool (one-shot B's private rows of a party: one
# key range), a last key range one key long, and few-shot A's step ③'
# (hard/overlap-32: d = 16, below one 32-float TMA box; one key tile).
SHAPES = [
    (1, 1024, 2048, 128, 128),
    (3, 1024, 2048, 128, 128),
    (1, 1024, 2000, 128, 128),
    (2, 333, 517, 64, 128),
    (1, 22976, 2048, 128, 128),
    (1, 1024, 2049, 128, 128),
    (1, 1184, 32, 16, 16),
]
# k-means assignment vs plain version: equal on every row whose best two
# squared distances differ by more than NEAR_TIE (rows are unit vectors, so
# distances lie in [0, 4]; the two sum d-long dots in different orders);
# near-tie rows may differ, at most MAX_EXEMPT of a launch's rows. The
# minimum distance itself agrees to a few f32 ulps of 4.
NEAR_TIE = 1e-5
MAX_EXEMPT = 1e-3
KMEANS_MIN_TOL = 1e-5
# (B, N, d, C): one-shot B's Lloyd and inertia launches (K·R = 2·4 entries)
# and final launch (K = 2), the same for one-shot A, an odd shape, centres
# far beyond shared memory (the tile route), the CPU tests' shape (rows
# that are not 16-byte aligned, the tile route with three centre ranges),
# and the path's shape at 64 centres: with C = 37 below it, the two routes'
# crossover seen from both sides.
KMEANS_SHAPES = [
    (8, 2048, 128, 10),
    (2, 2048, 128, 10),
    (8, 32, 16, 2),
    (2, 32, 16, 2),
    (3, 1000, 77, 37),
    (1, 4096, 1024, 1000),
    (2, 300, 513, 130),
    (8, 2048, 128, 64),
    # the folds' Lloyd launches: the fault family's one-shot group (S·C·K·R =
    # 4·9·4·4) and hard/overlap-32 at S = 4 (4·2·4)
    (576, 32, 16, 2),
    (32, 32, 16, 2),
]
# centre ranges wanted on the tile route in the k-means plan phase (ops.tile_plan)
KMEANS_PLAN_RANGES = (1, 4, 16)
# The routes' crossover, timed at one (B, N, d), the path's Lloyd launch,
# in both element types: C from 16 to 64 centres (one tile of the tile route).
KMEANS_CROSSOVER = ((8, 2048, 128), (16, 24, 32, 40, 48, 56, 64))
# One-shot B: the paper's §5.1 CIFAR-10 layout at the extractor's full
# width, on the repository's synthetic CIFAR-like generator.
IMAGE_B = scenarios.ScenarioSpec(
    name="image/halves-cifar-full",
    modality="image",
    generator="image_classification",
    overlap=2048,
    num_samples=60000,
    rep_dim=128,
    widths=(32, 64, 128),
    blocks_per_stage=2,
)
# One-shot B's and few-shot B's depth, cut so that the script keeps inside
# its limit on a slow host: client epochs 20 → 2 (one-shot B's step ④ then
# runs 256 SSL steps, not 2560: 73.1 s of 83.2 on the H100 at 20) and
# server epochs 50 → 10 (the fits of ⑥, ②' and ⑥' took 9.3-11.1 s each at
# 50); one-shot B reached accuracy 1.0 at 20 / 50 and few-shot B's one-shot
# pass 0.9983 at 1 / 50 (PERF.md §6).
B_CLIENT_EPOCHS = 2
B_SERVER_EPOCHS = 10
# Few-shot B: client_epochs cut from 20 to 1: step ⑤' then runs 782 SSL
# steps a party (N_o + N_u = 25024 labeled rows), step ④ 64.
FEW_B_CLIENT_EPOCHS = 1
# The baselines on B: the paper runs 32000 iterations at N_o = 2048
# (benchmarks/comm_cost.py). Cut, so that the script keeps inside its limit
# on a slow host, to 200 for SplitNN and FedCVT (at 750 the sessions took
# 15.7 and 25.8 s on the H100, 20.9 and 34.3 ms an iteration; at 200 both
# reach accuracy 1.0) and to 750 for FedBCD (150 rounds of Q = 5; 115.1 ms
# a round, accuracy 0.9914): FedBCD's stale local updates spike its loss
# early, and at 40 rounds its accuracy sat near chance (0.2590 on the card,
# 0.5798 on the CPU), so there it would hang on the rounding (PERF.md §6).
B_BASELINE_ITERATIONS = {"vanilla": 200, "fedbcd": 750, "fedcvt": 200}
# Card ≡ CPU on B's image training path: the first 5 SplitNN iterations from
# the same parameters on the card and on the CPU (TF32 off): losses within
# LOGIT_RTOL of the largest loss, final parameters within LOGIT_RTOL of the
# largest parameter. Five, not ten: unclipped momentum SGD on the CNN about
# doubles a rounding difference each step, so past a few steps the CPU
# against itself (1 thread against all) nears the bar; the script prints that
# floor beside the card's error.
B_CONTRAST_ITERATIONS = 5
B_CONTRAST_TEST_ROWS = 256
# (bytes, comm times) of the baselines on hard/overlap-32 at its 400
# iterations and on B: 2 parties, bs 32, f32 reps of 16 and 128; FedBCD in
# iterations // Q rounds; FedCVT ships 2x.
BASELINE_LEDGERS = {
    "A": {"vanilla": (3276800, 800), "fedbcd": (655360, 160), "fedcvt": (6553600, 800)},
    "B": {"vanilla": (13107200, 400), "fedbcd": (9830400, 300), "fedcvt": (26214400, 400)},
}
# (one-shot, few-shot) ledger bytes of every non-fault catalog scenario at
# its registered sizes, f32 reps: one-shot 3·K·N·rep·4 over the N aligned
# rows (a padded split's capacity), few-shot 4·K·N·rep·4 + Σ_k N_u^k·(rep·4 + 4).
# tests/test_torch_catalog_ledgers_*.py hold every entry against the
# reference's ledgers; the [catalog] phase holds the card's runs to them.
CATALOG_LEDGERS = {
    "credit/feature-skew": (49152, 138432),
    "credit/label-noise": (49152, 138432),
    "credit/overlap-32": (12288, 95808),
    "credit/overlap-64": (24576, 110016),
    "credit/overlap-128": (49152, 138432),
    "credit/overlap-256": (98304, 195264),
    "credit/overlap-512": (196608, 310832),
    "credit/overlap-1024": (393216, 621800),
    "credit/overlap-2048": (786432, 1243600),
    "credit/parties-4": (49152, 112768),
    "credit/parties-8": (98304, 178304),
    "edge/full-overlap": (307200, 409600),
    "hard/overlap-32": (12288, 177408),
    "hard/overlap-64": (24576, 191616),
    "hard/overlap-32-eq": (24576, 191616),
    "hard/overlap-64-eq": (24576, 191616),
    "image/halves": (73728, 138432),
    "image/patch-4": (147456, 236736),
}
# hard/overlap-32 with bf16 reps: half of every rep transfer, p̂ stays f32
CATALOG_BF16_LEDGERS = {"hard/overlap-32": (6144, 93440)}
# The [catalog] phase: one-shot and few-shot on every non-fault scenario at
# seed 0 and its registered sizes and budgets (CATALOG_EPOCH_CUT below), but
# hard/overlap-32 (which [one-shot A] and [few-shot A] run in f32; here it
# runs with bf16 reps).
CATALOG_RUN = [n for n in CATALOG_LEDGERS if n != "hard/overlap-32"]
# Bars: a tabular run's AUC (the reference's bar for hard/*) at seed 0. An
# image scenario's accuracy (4 classes, 100 test rows) cannot be told from
# chance at one seed (the reference's own image/halves over seeds 0-7:
# one-shot 0.27-0.44, few-shot 0.11-0.49), so each protocol's mean over
# IMAGE_SEEDS is held above chance by two standard errors of a mean at
# chance over those seeds' test rows: 0.25 + 2·√(0.25·0.75 / 800) = 0.2806.
CATALOG_BARS = {"auc": 0.6}
IMAGE_SEEDS = range(8)
IMAGE_CHANCE = 0.25
# Few-shot is not run on hard/overlap-64-eq: at capacity 64 = N_o it is
# hard/overlap-64 row for row (an all-ones mask); it saves 6080 ⑤' steps
# (about 20 s) of the phase. Nor on hard/overlap-64: [folds]' frontier runs
# its few-shot at seeds 0-3 at the same sizes and budgets, and holds those
# rows to CATALOG_LEDGERS and, at seed 0, to CATALOG_BARS (36.5 s of the
# phase on a slow host).
CATALOG_ONE_SHOT_ONLY = ("hard/overlap-64-eq", "hard/overlap-64")
# The catalog's tabular runs (credit/*, edge/*, hard/*) at their budgets
# with the client epochs cut 4-fold (at least 1: hard 80 → 20, credit 8 → 2,
# edge 4 → 1), the image scenarios uncut: the tabular runs took ~150 s of
# the phase's 201 on the H100, most of it in ④ and ⑤' (PERF.md §6). The
# sizes, ledgers and bars are the registered ones.
CATALOG_EPOCH_CUT = 4
# Scenarios whose step ③' is recomputed on the CPU's plain route: the
# widest fused Eq. 10 launches (K − 1 = 7 and 3).
CATALOG_STEP3P = ("credit/parties-8", "image/patch-4")
# bf16 reps in ③': estimates and p̂ against the plain route on the same bf16
# inputs within one bf16 rounding step of O(1) values (both upcast to f32).
BF16_STEP3P_TOL = 3e-2
# The new ③' shapes of the catalog, timed as [kernel] rows: credit/parties-8
# (K − 1 = 7 estimates of 164 pool rows over N_o = 128 keys, rep 8, h_u and
# H_oᴬ stride-0 views as the path passes them) and hard/overlap-32's with
# bf16 reps.
CATALOG_SDPA_SHAPES = [((7, 164, 128, 8, 8), torch.float32), ((1, 1184, 32, 16, 16), torch.bfloat16)]
# The fault/* family: one 4-party hard condition (N_o = 32, 592 pool rows a
# party, 600 test rows, rep 16, 20 client / 30 server epochs, 200
# iterations) under nine fault treatments, fault/none its fault-free twin.
FAULT_NAMES = [n for n in scenarios.names() if n.startswith("fault/")]
FAULT_BASELINE = "fault/none"
# The reference gate's rule for the family (fault_families in
# benchmarks/frontier_baseline.json): one-shot means over seeds 0-3, the
# fault-free twin's above FAULT_NONE_BAR (the reference's AUC bar), every
# member's at most max_oneshot_drop below it.
FAULT_SEEDS = range(4)
FAULT_NONE_BAR = 0.6
FAULT_GATE_FILE = os.path.join(ROOT, "benchmarks", "frontier_baseline.json")
# The iterative baselines run on the fault-free twin and the four dropouts.
FAULT_ITERATIVE = [FAULT_BASELINE] + [n for n in FAULT_NAMES if "/dropout-" in n]
# The family's few-shot runs ([faults]' loop and [folds]' group, held to each
# other) at the members' budgets with the client epochs cut 4-fold (20 → 5:
# ⑤' 380 SSL steps, not 1520; ~3.5-5 s a run on the H100 at 20), so that
# the script keeps inside its limit on a slow host. One-shot, which the
# gate reads, and the baselines keep the full budgets.
FAULT_FEW_EPOCH_CUT = 4
# (bytes, comm times) of each member: one-shot and few-shot (independent of
# the budgets), the baselines at 200 iterations (FedBCD: 40 rounds of Q = 5).
# A dropped party's missing uploads are not on the wire; a stalled iterative
# loop stops at its stage's share of the steps, then spends 3 retry rounds
# (each survivor's batch up, 4 bytes down to the dropped party).
# tests/test_torch_fault_ledgers_*.py hold every entry against the reference.
FAULT_LEDGERS = {
    "fault/dp-sigma-0.1": {"one-shot": (24576, 3), "few-shot": (193792, 5),
                           "vanilla": (3276800, 400), "fedbcd": (655360, 80), "fedcvt": (6553600, 400)},
    "fault/dp-sigma-0.5": {"one-shot": (24576, 3), "few-shot": (193792, 5),
                           "vanilla": (3276800, 400), "fedbcd": (655360, 80), "fedcvt": (6553600, 400)},
    "fault/dropout-post-ssl": {"one-shot": (22528, 3), "few-shot": (149440, 5),
                               "vanilla": (1656844, 203), "fedbcd": (346124, 43), "fedcvt": (3313676, 203)},
    "fault/dropout-pre-round2": {"one-shot": (24576, 3), "few-shot": (151488, 5),
                                 "vanilla": (2476044, 303), "fedbcd": (509964, 63), "fedcvt": (4952076, 303)},
    "fault/dropout-pre-ssl": {"one-shot": (20480, 3), "few-shot": (147392, 5),
                              "vanilla": (837644, 103), "fedbcd": (182284, 23), "fedcvt": (1675276, 103)},
    "fault/dropout-pre-upload": {"one-shot": (18432, 3), "few-shot": (145344, 5),
                                 "vanilla": (18444, 3), "fedbcd": (18444, 3), "fedcvt": (36876, 3)},
    "fault/none": {"one-shot": (24576, 3), "few-shot": (193792, 5),
                   "vanilla": (3276800, 400), "fedbcd": (655360, 80), "fedcvt": (6553600, 400)},
    "fault/rep-only": {"one-shot": (24576, 3), "few-shot": (193792, 5),
                       "vanilla": (3276800, 400), "fedbcd": (655360, 80), "fedcvt": (6553600, 400)},
    "fault/straggler-half": {"one-shot": (24576, 3), "few-shot": (193792, 5),
                             "vanilla": (3276800, 400), "fedbcd": (655360, 80), "fedcvt": (6553600, 400)},
}
# The Eq. 10 shapes the fault path adds: ⑤ / ⑥' reconstruction of a dropped
# party's 32 overlap rows, and the degraded evaluation's 600 test rows.
FAULT_SDPA_SHAPES = [((1, 32, 32, 16, 16), torch.float32), ((1, 600, 32, 16, 16), torch.float32)]
# The folds: the fault family as ONE run_scenarios_seeds group (one-shot at
# FAULT_SEEDS: C 9 × S 4 × K 4 = 144 entries; few-shot at seed 0), held to
# the [faults] loop on the same splits: every metric within FOLD_METRIC_TOL
# of the loop's (the same draws; the stacked products round differently and
# 20 epochs carry that on), and, after FOLD_PARAM_STEPS stacked ④ steps,
# every entry's parameters within LOGIT_RTOL of the largest against the
# one-party loop on the card (the B contrast's rule). Then the port's
# frontier on FOLD_FRONTIER at seeds 0-3 with the reference's methods and
# gate (benchmarks/torch_frontier.py, benchmarks/frontier_baseline.json).
FOLD_METRIC_TOL = 0.02
FOLD_PARAM_STEPS = 5
# The iterative baselines' folds: the stacked session against the per-entry
# loop (engine_mode "vmap" / "python") over their first iterations.
ITER_CONTRAST_ITERATIONS = 10
FOLD_FRONTIER = ("hard/overlap-32", "hard/overlap-64")
FOLD_FRONTIER_SEEDS = range(4)
# The one gate miss the phase prints and does not fail on: few-shot's
# worst-seed floor (fewshot_min_worst_margin 0) misses on hard/overlap-32 at
# seeds 0-3 on the card by 0.037 at seed 1, and it misses on the card's rows
# trained on the CPU too (0.036), and on the CPU's rows trained on the card
# (0.015 at seed 2): four seeds of 600 test rows, few-shot's spread 0.03-0.04
# (PERF.md §6; benchmarks/torch_frontier.py --data-device). Only that rule on
# that scenario, and only down to the margin below; a larger miss, that rule
# on another scenario, or any other rule of the gate fails the run.
FOLD_GATE_REPORTED = ("hard/overlap-32", "few-shot worst-seed margin", -0.05)


def gate_miss_reported(problem: str) -> bool:
    """Whether ``problem`` (a ``check_gate`` line) is the diagnosed miss of
    FOLD_GATE_REPORTED, within its margin."""
    name, rule, floor = FOLD_GATE_REPORTED
    head = f"{name}: {rule} "
    if not problem.startswith(head):
        return False
    return float(problem[len(head):].split()[0]) >= floor
# The Eq. 10 launches of the folds, timed as [kernel] rows: hard/overlap-32's
# ③' at S = 4 (one launch of width 4 a party, h_u stacked over the seeds),
# and the fault family's few-shot ③' folded over C = 9 (width 27: the K − 1 = 3
# estimates of 9 entries, h_u and H_oᴬ repeated).
FOLD_SDPA_SHAPES = [((4, 1184, 32, 16, 16), torch.float32), ((27, 592, 32, 16, 16), torch.float32)]
# [mesh]: one-shot (at hard/overlap-32's budget), few-shot (at few-shot A's)
# and the three baselines (at 400 iterations) over these seeds, unsharded and
# on a 2-slot mesh of one card (3 entries padded to 4), held to MESH_TOL on
# the metric, every leaf and every loss
MESH_SEEDS = range(3)
MESH_TOL = 1e-5
# [mesh]'s few-shot + finetune row: four entries, so that "auto" stacks the
# finetune session (iterative.stack_pays), at finetune A's budget. The
# baseline and finetune rows together should take at most
# MESH_ITERATIVE_BUDGET_S (printed, not held: hosts differ ~2x); they took
# 74.3 s on the H100, and the row is not cut further: at 5 client epochs
# seed 1's sharded ⑤' left the unsharded one by 7.5e-5 (PERF.md §6,
# benchmarks/torch_mesh_parity.py)
MESH_FINETUNE_SEEDS = range(4)
MESH_ITERATIVE_BUDGET_S = 60
BASELINE_RUNNERS = (
    ("vanilla", baselines.run_vanilla),
    ("fedbcd", baselines.run_fedbcd),
    ("fedcvt", baselines.run_fedcvt),
)
FINETUNE_ITERATIONS = 200
# Few-shot A and few-shot + finetune A at hard/overlap-32's budget with its
# client epochs cut 4-fold (80 → 20: ⑤' 1520 SSL steps, not 6080; 22.4 s of
# few-shot A's 23.4 on the H100 at 80), so that the script keeps inside its
# limit on a slow host; [mesh]'s few-shot row too (34.5 s unsharded and 71.7
# on two slots at 80). On the CPU the cut moved few-shot's AUC 0.7976 →
# 0.7931 (PERF.md §6). One-shot A keeps the full budget.
A_FEW_EPOCH_CUT = 4
# Few-shot step ③' gate decisions, card vs the CPU's plain route: equal
# except on rows where a head's top confidence lies within NEAR_GATE of t,
# or its top two class probabilities within NEAR_GATE of each other (the
# estimates differ by up to KERNEL_TOL, and so do the heads' inputs).
NEAR_GATE = 1e-4
# RMSNorm kernel vs plain version: f32 outputs within 1e-5 (both sum d
# squares in f32, in different orders); bf16 outputs within one rounding
# step, |err| <= 2e-2 + 2e-2·|want| (2^-8 relative: 0.03 at |y| in [4, 8)).
RMS_TOL = {torch.float32: (1e-5, 0.0), torch.bfloat16: (2e-2, 2e-2)}  # (abs, rel)
# (rows, d, x dtype), scale f32 as the zoo passes it: the zoo's decode step
# (B = 4), its prompt forward (4 x 32 tokens), the reference op's own
# example in both dtypes, an odd d.
RMS_SHAPES = [
    (4, 3072, torch.bfloat16),
    (128, 3072, torch.bfloat16),
    (2048, 4096, torch.bfloat16),
    (2048, 4096, torch.float32),
    (231, 130, torch.float32),
    # the zoo families' decode steps: granite's d, mamba2's d, zamba2's d
    # (bf16 residual stream), and the Mamba2 gated norm at d_inner in f32
    (4, 1536, torch.bfloat16),
    (4, 1024, torch.bfloat16),
    (4, 2048, torch.bfloat16),
    (4, 2048, torch.float32),
    (4, 4096, torch.float32),
    # the last families' decode steps: deepseek-v2's d and qwen2-vl's d
    # (bf16), MLA's q and kv latent norms (f32)
    (4, 5120, torch.bfloat16),
    (4, 8192, torch.bfloat16),
    (4, 1536, torch.float32),
    (4, 512, torch.float32),
]
# Decode attention vs plain version: f32 outputs, softmax-weighted means of
# bf16 cache rows computed in f32 on both sides; a few ulps. 2e-5 is the
# reference package's own f32 kernel tolerance, far inside the 2e-2 a bf16
# output would need, and a masking error moves outputs by O(0.01) or more.
DECODE_TOL = 2e-5
# (B, H, Hkv, S, dh, mask), all bf16 caches in the zoo's (B, S, Hkv, dh)
# layout: phi4-mini's decode step (48-slot cache) with no mask, with
# per-sequence lengths, and with stored positions in no order along the
# slots (the path passes positions: its mask, here with valid slots that are
# no prefix), long context (1 GiB of K+V), gemma-like 256-wide heads, an odd
# shape, long context with per-sequence lengths, and llama3-405b's head
# layout (G = 16: 128 query heads over 8 kv heads; 67 MB of K+V).
DECODE_SHAPES = [
    (4, 24, 8, 48, 128, None),
    (4, 24, 8, 48, 128, "lengths"),
    (4, 24, 8, 48, 128, "positions"),
    (8, 24, 8, 32768, 128, None),
    (1, 16, 16, 4096, 256, None),
    (2, 4, 1, 77, 80, None),
    (8, 24, 8, 32768, 128, "lengths"),
    (4, 128, 8, 4096, 128, None),
    # the zoo families' decode steps at 48 slots, with the path's mask:
    # granite (G = 3, dh 64) and zamba2's shared block (G = 1, dh 64)
    (4, 24, 8, 48, 64, "positions"),
    (4, 32, 32, 48, 64, "positions"),
    # the last families: qwen2-vl (G = 8, dh 128) and seamless's decoder
    # self-attention (G = 1, dh 64), and phi4-mini's 16-slot ring under a
    # window of 16 (ragged positions, some older than the window)
    (4, 64, 8, 48, 128, "positions"),
    (4, 16, 16, 48, 64, "positions"),
    (4, 24, 8, 16, 128, "window"),
]
# key ranges wanted in the decode plan phase (ops.split_plan), at the long
# context shape (unmasked and with ragged lengths) and at the G = 16 shape
DECODE_PLAN_RANGES = (1, 4, 8, 16, 32, 64, 128)
# the columns printed for the zoo kernels
ZOO_TIMES = ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms")
ZOO_ARCH = "phi4-mini-3.8b"
ZOO_FAMILIES = ("granite-moe-3b-a800m", "mamba2-370m", "zamba2-1.2b")
# the zoo's last families (MLA + MoE, vlm, audio encoder-decoder)
ZOO_LAST = ("deepseek-v2-236b", "qwen2-vl-72b", "seamless-m4t-large-v2")
# Full width with fewer layers where the full depth does not fit one card's
# 80 GB in f32 (deepseek-v2: 943 GB; qwen2-vl: 291 GB): dense0 and two MoE
# blocks, and 4 of 80 layers.
ZOO_DEPTH = {"deepseek-v2-236b": 3, "qwen2-vl-72b": 4}
# phi4-mini served with a sliding window: 16 ring slots over the 48
# positions of a serve run, so the ring wraps twice; the reduced run's 4
# slots wrap four times over its 16
ZOO_WINDOW, ZOO_SMALL_WINDOW = 16, 4
ZOO_BATCH, ZOO_PROMPT, ZOO_GEN = 4, 32, 16
# qwen2-vl's prefill_fn with the config's patch prefix: batch 1, 1024 patch
# rows and 1024 text tokens (a multiple of the scan's 1024-key chunk)
VLM_TEXT = 1024
# Exact parameter counts at full width (the reference's param_shapes(); phi4:
# 32 x 100,669,440 per layer + 614,596,608 embedding + 3,072), and the
# launches a decode step, (RMSNorm, decode attention): 2L + 1 norms (a dense
# block's two, or a Mamba2 block's pre-norm and gated norm), plus the shared
# block's two norms at each of zamba2's 6 applications. A prefill_fn launches
# the same RMSNorm count and no decode attention.
ZOO_PARAMS = {
    ZOO_ARCH: 3_836_021_760,
    "granite-moe-3b-a800m": 3_374_295_552,
    "mamba2-370m": 419_825_152,
    "zamba2-1.2b": 1_170_473_856,
    "deepseek-v2-236b": 9_330_795_520,
    "qwen2-vl-72b": 6_002_163_712,
    "seamless-m4t-large-v2": 1_632_131_072,
}
# The last families: an MLA block norms 4 times (ln1, q_norm, kv_norm,
# ln2) and decodes in plain torch (absorbed: no decode-attention launch);
# seamless's decoder blocks norm 3 times and self-attend through the kernel
# (cross-attention is the blocked scan), and its prefill_fn also runs the
# encoder (2 · 24 + 1 norms), as does filling a serve run's enc_out.
ZOO_LAUNCHES = {
    ZOO_ARCH: (2 * 32 + 1, 32),
    "granite-moe-3b-a800m": (2 * 32 + 1, 32),
    "mamba2-370m": (2 * 48 + 1, 0),
    "zamba2-1.2b": (2 * 38 + 2 * 6 + 1, 6),
    "deepseek-v2-236b": (4 * 3 + 1, 0),
    "qwen2-vl-72b": (2 * 4 + 1, 4),
    "seamless-m4t-large-v2": (3 * 24 + 1, 24),
}
# The reduced configs' launches a step: 2 layers (deepseek: dense0 and one
# MoE block), or zamba2's one group of 2 blocks and one shared-block
# application; windowed phi4-mini (ZOO_SMALL_WINDOW) launches as the plain.
ZOO_SMALL_LAUNCHES = {
    ZOO_ARCH: (5, 2),
    "granite-moe-3b-a800m": (5, 2),
    "mamba2-370m": (5, 0),
    "zamba2-1.2b": (7, 1),
    "deepseek-v2-236b": (9, 0),
    "qwen2-vl-72b": (5, 2),
    "seamless-m4t-large-v2": (7, 2),
}
# The RMSNorm backward's shapes (rows, d, x dtype; scale f32 as the zoo
# passes it): a [zoo-train] step's 1024 rows (batch 8 x seq 128) at
# mamba2-370m's block and final norms (d 1024, bf16), its gated norms
# (d_inner 2048, f32) and phi4-mini's norms (d 3072, bf16); the [zoo-vfl]
# extractor's strong view of an unlabeled SSL batch (64 rows x 8 tokens at
# d 256, bf16); a ragged odd shape. dx within 1e-5 of its largest entry in
# f32, one bf16 step (plus that) in bf16; dscale within 1e-5 of its largest
# entry; both against float64.
RMS_BWD_SHAPES = [
    (1024, 1024, torch.bfloat16),
    (1024, 2048, torch.float32),
    (1024, 3072, torch.bfloat16),
    (512, 256, torch.bfloat16),
    (231, 130, torch.float32),
]
RMS_BWD_TOL = 1e-5
# [zoo-train]: mamba2-370m at full width and depth (launch/train.py's own
# default) and phi4-mini at full width over 4 of its 32 layers (its Adam
# state alone would take ~61 GB of the 80 at full depth); batch 8, seq 128,
# clip 1.0 + Adam at 3e-4 (launch/train.py's default), remat on; one
# warm-up step, then TRAIN_STEPS timed steps on one fixed batch. phi4-mini's
# fixed-batch loss swings over its first steps at 3e-4 (Adam moves every
# weight of its 200064-row tied table by about lr at once): its seventh
# loss is above its first, and from the ninth on every loss is below;
# torch.optim.Adam, f32 activations and the plain norms trace the same
# curve (benchmarks/torch_zoo_train_lr.py, PERF.md section 4). Launches a
# step (RMSNorm forward, backward): each norm once forward and once
# backward, plus each block's norms again in the backward's re-run of its
# checkpointed forward.
TRAIN_ARCHS = ("mamba2-370m", ZOO_ARCH)
TRAIN_DEPTH = {ZOO_ARCH: 4}
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 128, 11
TRAIN_LR = 3e-4
TRAIN_SMALL_STEPS = 3
TRAIN_PARAMS = {"mamba2-370m": 419_825_152, ZOO_ARCH: 614_596_608 + 4 * 100_669_440 + 3_072}
TRAIN_LAUNCHES = {"mamba2-370m": (97 + 96, 97), ZOO_ARCH: (9 + 8, 9)}
# [zoo-vfl]: the reference's test_zoo_backbone_extractor_in_protocol on the
# port's own data: 400 rows of 16 tokens over a vocabulary of 32, 3
# classes, split as that test splits it; reduced phi4 (vocab 32, 2 layers)
# as both parties' extractor, rep_dim 16, token SSL, one-shot at 3 client
# and 10 server epochs, client lr 0.02. The bar is the test's (chance 1/3);
# the bytes are the reference's run of that split (24576: 4096 a party in
# each of the three rounds), which tests/test_torch_zoo_vfl.py pins.
ZOO_VFL_BAR = 0.4
ZOO_VFL_BYTES = 24576
# prefill ≡ sequential decode at full width in f32 activations, TF32 off: the
# blocked-scan prefill and the decode kernel sum in different orders; logits
# relative to their scale (the reference's own test holds 2e-5 at 2 layers).
ZOO_RTOL = 1e-4
# [vfl-step]: launch/vfl_step.py's party processes, two gloo ranks on cuda:0
# and two on the CPU with the same draws: 20 vanilla steps and the one-shot
# session (100 local steps, the reference example's) at the example's sizes,
# and the session on hard/overlap-32's split, each session in f32 and bf16.
VFL_STEP_VANILLA_STEPS = 20
VFL_STEP_LOCAL_STEPS = vfl_step.LOCAL_STEPS
# card against CPU ranks: each rank's final extractor and loss, relative to
# its largest parameter (a session's SSL steps, as SESSION_RTOL in the tests)
VFL_STEP_TOL = 1e-4
VFL_STEP_TIMEOUT_S = 180.0


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


def _entry_names(mangled: list) -> dict:
    """Each ptxas entry's name demangled, without its parameters, by the
    CUDA toolkit's ``cu++filt -p`` (next to nvcc); the mangled names where
    it is missing or fails."""
    tool = Path(_build._nvcc()).with_name("cu++filt")
    if not tool.exists():
        return {m: m for m in mangled}
    out = subprocess.run(
        [str(tool), "-p"], input="\n".join(mangled), capture_output=True, text=True, timeout=60
    )
    names = out.stdout.splitlines()
    if out.returncode != 0 or len(names) != len(mangled):
        return {m: m for m in mangled}
    return dict(zip(mangled, names))


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


def device_ms(fn, iters: int = 50, warmup: int = 3, stream=None) -> float:
    """Mean device time of ``fn()``: ``iters`` back-to-back calls captured
    into one CUDA graph after ``warmup`` calls on a side stream, the graph
    replayed between two events. At small shapes the event timer of
    :func:`time_ms` reads the host's enqueue rate; a replay has no host in
    the way. ``stream`` is the side stream, and the capture's, when ``fn``
    must run on one given stream: autograd runs a backward on the stream
    of its forward. A call that cannot be captured fails the run."""
    side = torch.cuda.Stream() if stream is None else stream
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(iters):
                fn()
    except RuntimeError as e:
        fail(f"CUDA graph capture failed: {e}")
    graph.replay()  # the first replay uploads the graph
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sdpa_bound_ms(
    b: int, nu: int, no: int, d: int, db: int, elem: int = 4, shared_qk: bool = False
) -> tuple:
    """Least time for the kernel's work on an H100: the larger of compulsory
    bytes (each input read once at ``elem`` bytes an element, queries and
    keys once for the whole batch when ``shared_qk`` (stride-0 views), the
    f32 output written once) over the memory rate and the arithmetic it
    does, the two products' FLOPs three times over (3xTF32) at the dense
    TF32 rate. Also returns the same bound with the products once at the
    f32 (non-tensor) rate, the bound of the earlier f32-FMA design, so that
    older rows stay comparable."""
    qk = (nu * d + no * d) * (1 if shared_qk else b)
    nbytes = elem * (qk + b * no * db) + 4 * b * nu * db
    flops = 2 * b * nu * no * (d + db)
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, 3 * flops / H100_TF32_FLOPS
    fma_ms = max(t_bytes, flops / H100_F32_FLOPS) * 1e3
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations"), fma_ms


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


def phase_sdpa(gen) -> dict:
    """Kernel vs plain version (and library call) at the path's shapes, and
    vs float64, with the launch plan the wrapper picked: one range at both
    step ③' shapes, and at least one block an SM at the serving shape."""
    rows = []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b, nu, no, d, db in SHAPES:
        q = torch.randn(b, nu, d, generator=gen, device="cuda")
        a = torch.randn(b, no, d, generator=gen, device="cuda")
        v = torch.randn(b, no, db, generator=gen, device="cuda")
        got = ops.sdpa_estimate_batched(q, a, v)
        want = ref.sdpa_estimate_batched(q, a, v)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        err64 = (got.double() - _oracle64(q, a, v)).abs().max().item()
        check(bool(torch.isfinite(got).all()), f"non-finite kernel output at {(b, nu, no, d, db)}")
        check(err <= KERNEL_TOL, f"kernel vs plain max|err| {err} > {KERNEL_TOL}")
        check(err64 <= F64_TOL, f"kernel vs f64 max|err| {err64} > {F64_TOL}")
        plan = ops.device_plan(q, v)
        if (b, nu, no) == (1, 1024, N_O):
            check(plan.blocks >= sms, f"serving shape: {plan.blocks} blocks for {sms} SMs")
        if nu in (22976, 1184):
            check(plan.splits == 1, f"step ③' shape: {plan.splits} key ranges, not 1")

        def library():
            return F.scaled_dot_product_attention(q, a, v)

        row = {
            "shape": [b, nu, no, d, db],
            "max_abs_err": err,
            "splits": plan.splits,
            "blocks": plan.blocks,
            "ms": time_ms(lambda: ops.sdpa_estimate_batched(q, a, v)),
            "plain_ms": time_ms(lambda: ref.sdpa_estimate_batched(q, a, v)),
            "library_ms": time_ms(library),
            "device_ms": device_ms(lambda: ops.sdpa_estimate_batched(q, a, v)),
            "library_device_ms": device_ms(library),
        }
        row["bound_ms"], row["bound_by"], row["fma_bound_ms"] = sdpa_bound_ms(b, nu, no, d, db)
        rows.append(row)
        times = " | ".join(f"{k} {row[k]:.4f} ms" for k in ZOO_TIMES)
        print(
            f"[kernel] sdpa_estimator B={b} N_u={nu} N_o={no} d={d} d_b={db}: "
            f"{plan.splits} key range(s), {plan.blocks} blocks | max|err| {err:.3e} (vs f64 "
            f"{err64:.3e}) | {times} | "
            f"bound {row['bound_ms']:.4g} ms ({row['bound_by']}, 3xTF32) | "
            f"fma_bound {row['fma_bound_ms']:.4g} ms"
        )
    return rows[0]  # the K = 2 partial-query launch shape


def phase_sdpa_extra(gen, shapes: list, label: str, shared_qk: bool = True) -> list:
    """The Eq. 10 kernel at a path's further ``shapes`` ((B, N_u, N_o, d,
    d_b), dtype), with the path's layout: with ``shared_qk`` a launch of
    width B > 1 reads one h_u and one H_oᴬ through stride-0 batch views (the
    catalog's ③'), else B of each (the folds' stacked entries); bf16 reps
    reach the wrapper as bf16 (it upcasts them). Kernel vs plain version and
    float64, timed beside ``F.scaled_dot_product_attention`` on the same
    inputs."""
    rows = []
    for (b, nu, no, d, db), dtype in shapes:
        if shared_qk:
            q = torch.randn(nu, d, generator=gen, device="cuda").to(dtype).expand(b, nu, d)
            a = torch.randn(no, d, generator=gen, device="cuda").to(dtype).expand(b, no, d)
        else:
            q = torch.randn(b, nu, d, generator=gen, device="cuda").to(dtype)
            a = torch.randn(b, no, d, generator=gen, device="cuda").to(dtype)
        v = torch.randn(b, no, db, generator=gen, device="cuda").to(dtype)
        got = ops.sdpa_estimate_batched(q, a, v)
        want = ref.sdpa_estimate_batched(q, a, v)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        err64 = (got.double() - _oracle64(q, a, v)).abs().max().item()
        check(err <= KERNEL_TOL, f"kernel vs plain max|err| {err} at {(b, nu, no, d, db)}")
        check(err64 <= F64_TOL, f"kernel vs f64 max|err| {err64} at {(b, nu, no, d, db)}")
        plan = ops.device_plan(q, v)

        def library():
            return F.scaled_dot_product_attention(q, a, v)

        row = {
            "shape": [b, nu, no, d, db],
            "dtype": str(dtype).removeprefix("torch."),
            "max_abs_err": err,
            "splits": plan.splits,
            "blocks": plan.blocks,
            "ms": time_ms(lambda: ops.sdpa_estimate_batched(q, a, v)),
            "plain_ms": time_ms(lambda: ref.sdpa_estimate_batched(q, a, v)),
            "library_ms": time_ms(library),
            "device_ms": device_ms(lambda: ops.sdpa_estimate_batched(q, a, v)),
            "library_device_ms": device_ms(library),
        }
        bound = sdpa_bound_ms(b, nu, no, d, db, q.element_size(), shared_qk=shared_qk and b > 1)
        row["bound_ms"], row["bound_by"], row["fma_bound_ms"] = bound
        rows.append(row)
        times = " | ".join(f"{k} {row[k]:.4f} ms" for k in ZOO_TIMES)
        print(
            f"[kernel] sdpa_estimator {label} B={b} N_u={nu} N_o={no} d={d} d_b={db} "
            f"{row['dtype']}{' (stride-0 h_u, H_oᴬ)' if shared_qk and b > 1 else ''}: {plan.splits} key "
            f"range(s), {plan.blocks} blocks | max|err| {err:.3e} (vs f64 {err64:.3e}) | {times} "
            f"| bound {row['bound_ms']:.4g} ms ({row['bound_by']}, 3xTF32) | fma_bound "
            f"{row['fma_bound_ms']:.4g} ms"
        )
    return rows


def _oracle64(q, a, v):
    """Eq. 10 in float64 (the plain version casts its inputs to float32)."""
    q, a, v = q.double(), a.double(), v.double()
    return torch.softmax((q @ a.transpose(1, 2)) / q.shape[-1] ** 0.5, dim=-1) @ v


def phase_sdpa_plans(gen) -> None:
    """The kernel under other key-range plans than the wrapper's, at the
    serving and step ③' shapes: device time and error against float64
    (within the card tests' 2e-5) of 1 to 64 ranges, the wrapper's marked."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b, nu, no, d, db in (SHAPES[0], SHAPES[4]):
        q = torch.randn(b, nu, d, generator=gen, device="cuda")
        a = torch.randn(b, no, d, generator=gen, device="cuda")
        v = torch.randn(b, no, db, generator=gen, device="cuda")
        want = _oracle64(q, a, v)
        default = ops.device_plan(q, v)
        plans = {ops.split_plan(b, nu, no, db, sms, w) for w in PLAN_RANGES} | {default}
        for plan in sorted(plans):
            err = (ops.launch(q, a, v, plan).double() - want).abs().max().item()
            check(err <= F64_TOL, f"plan {plan} at {(b, nu, no, d, db)}: error {err} vs f64")
            ms = device_ms(lambda: ops.launch(q, a, v, plan))
            mark = " (the wrapper's plan)" if plan == default else ""
            print(
                f"[plan] sdpa_estimator B={b} N_u={nu} N_o={no} d={d} d_b={db}: "
                f"{plan.splits} range(s) of {plan.per_tiles} tiles, {plan.blocks} blocks | "
                f"device_ms {ms:.4f} | max|err| vs f64 {err:.3e}{mark}"
            )


def kmeans_bound_ms(b: int, n: int, d: int, c: int, route: str) -> tuple:
    """Least time on an H100 for the arithmetic the route runs: x, the
    centres and the labels each moved once, against the distance products'
    FLOPs at the f32 FMA peak (the rows route) or three times over at the
    dense TF32 rate (the tile route's 3xTF32). Also returns the f32 FMA
    bound of either, as the sdpa_estimator rows print it."""
    t_bytes = 4 * b * (n * d + c * d + n) / H100_BYTES_PER_S
    flops = 2 * b * n * c * d
    fma = flops / H100_F32_FLOPS
    t_ops = fma if route == "rows" else 3 * flops / H100_TF32_FLOPS
    bound_by = "bytes" if t_bytes > t_ops else "operations"
    return max(t_bytes, t_ops) * 1e3, bound_by, max(t_bytes, fma) * 1e3


def _kmeans_plan_text(plan) -> str:
    if plan.route == "rows":
        return (
            f"rows route: {plan.lanes} lane(s) a row, {plan.group_rows} row(s) a lane group, "
            f"{plan.rows_per_block} rows a block, {plan.blocks} blocks"
        )
    return (
        f"tile route: {plan.splits} centre range(s) of {plan.per_tiles} tile(s) of "
        f"{kops.BN}, {plan.rows_per_block} rows a block, {plan.blocks} blocks"
    )


def kmeans_oracle_check(x, m, got, mind, what: str) -> float:
    """Hold assignments and minimum distances against a float64 oracle of
    the same expansion: equal outside NEAR_TIE near-ties (at most MAX_EXEMPT
    of the rows differ), minima within KMEANS_MIN_TOL. Returns the error."""
    xd, md = x.double(), m.double()
    dist = (xd * xd).sum(-1, keepdim=True) - 2 * xd @ md.transpose(1, 2)
    dist = dist + (md * md).sum(-1)[:, None]
    c = m.shape[1]
    top = dist.topk(min(2, c), dim=-1, largest=False).values
    gap = top[..., 1] - top[..., 0] if c > 1 else torch.full_like(top[..., 0], 4.0)
    want = dist.argmin(-1).int()
    exempt = gap <= NEAR_TIE
    wrong = int(((got != want) & ~exempt).sum())
    check(wrong == 0, f"{what}: {wrong} rows differ from the f64 oracle outside near-ties")
    check(float((got != want).float().mean()) <= MAX_EXEMPT, f"{what}: too many near-tie rows")
    err = (mind.double() - top[..., 0]).abs().max().item()
    check(err <= KMEANS_MIN_TOL, f"{what}: min distance error {err} vs f64 > {KMEANS_MIN_TOL}")
    return err


def _unit_rows(gen, *shape):
    x = torch.randn(*shape, generator=gen, device="cuda")
    return x / x.norm(dim=-1, keepdim=True)


def phase_kmeans(gen) -> dict:
    """The k-means kernel vs its plain version (and ``torch.cdist`` +
    argmin) at the training path's shapes (the rows route, one launch each),
    an odd shape, centres far beyond shared memory (the tile route, at least
    a block an SM), the CPU tests' shape and the path's shape at 64 centres,
    each with the wrapper's plan."""
    rows = []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b, n, d, c in KMEANS_SHAPES:
        x, m = _unit_rows(gen, b, n, d), _unit_rows(gen, b, c, d)
        got, mind = kops.kmeans_assign_min_batched(x, m)
        want, want_min = kref.kmeans_assign_min_batched(x, m)
        torch.cuda.synchronize()
        top = kref.sq_dists(x, m).topk(min(2, c), dim=-1, largest=False).values
        gap = top[..., 1] - top[..., 0] if c > 1 else torch.full_like(top[..., 0], 4.0)
        exempt = gap <= NEAR_TIE
        wrong = int(((got != want) & ~exempt).sum())
        err = (mind - want_min).abs().max().item()
        agree = float((got == want).float().mean())
        check(wrong == 0, f"kmeans kernel disagrees on {wrong} rows at {(b, n, d, c)}")
        check(1.0 - agree <= MAX_EXEMPT, f"{1 - agree:.2%} near-tie rows differ at {(b, n, d, c)}")
        check(err <= KMEANS_MIN_TOL, f"kmeans min distance max|err| {err} > {KMEANS_MIN_TOL}")
        plan = kops.device_plan(x, m)
        if (n, d, c) == (2048, 128, 10) or n == 32:
            check(plan.route == "rows", f"path shape {(b, n, d, c)}: {plan.route} route, not rows")
        if (b, n, d, c) == (1, 4096, 1024, 1000):
            check(plan.route == "tiles" and plan.blocks >= sms, f"large C·d: {plan}")
        row = {
            "shape": [b, n, d, c],
            "max_abs_err": err,
            "agreement": agree,
            "ms": time_ms(lambda: kops.kmeans_assign_batched(x, m)),
            "plain_ms": time_ms(lambda: kref.kmeans_assign_batched(x, m)),
            "library_ms": time_ms(lambda: torch.cdist(x, m).argmin(-1)),
            "device_ms": device_ms(lambda: kops.kmeans_assign_batched(x, m)),
            "library_device_ms": device_ms(lambda: torch.cdist(x, m).argmin(-1)),
        }
        bound = kmeans_bound_ms(b, n, d, c, plan.route)
        row["bound_ms"], row["bound_by"], row["fma_bound_ms"] = bound
        rows.append(row)
        times = " | ".join(f"{k} {row[k]:.4f} ms" for k in ZOO_TIMES)
        what = "3xTF32" if plan.route == "tiles" else "f32 FMA"
        print(
            f"[kernel] kmeans B={b} N={n} d={d} C={c}: {_kmeans_plan_text(plan)} | agreement "
            f"{agree:.6f} ({int(exempt.sum())} near-tie rows exempt) | min-dist max|err| "
            f"{err:.3e} | {times} | bound {row['bound_ms']:.4f} ms ({row['bound_by']}, {what}) "
            f"| fma_bound {row['fma_bound_ms']:.4f} ms"
        )
    return rows[0]  # the Lloyd launch: 25 of every run's 27


def _kmeans_plan_rows(x, m, plans) -> None:
    """Each plan launched on (x, m): held against the float64 oracle,
    timed, printed as a ``[plan] kmeans`` row, the wrapper's plan marked."""
    b, n, d = x.shape
    c = m.shape[1]
    default = kops.device_plan(x, m)
    for plan in sorted(set(plans) | {default}):
        got, mind = kops.launch(x, m, plan)
        torch.cuda.synchronize()
        err = kmeans_oracle_check(x, m, got, mind, f"kmeans plan {plan} at {(b, n, d, c)}")
        ms = device_ms(lambda: kops.launch(x, m, plan, False))
        mark = " (the wrapper's plan)" if plan == default else ""
        print(
            f"[plan] kmeans {str(x.dtype).removeprefix('torch.')} B={b} N={n} d={d} C={c}: "
            f"{_kmeans_plan_text(plan)} | device_ms {ms:.4f} | max|err| vs f64 {err:.3e}{mark}"
        )


def phase_kmeans_plans(gen) -> None:
    """The k-means kernel under other plans than the wrapper's, at every
    KMEANS_SHAPES row: the rows route where it can run, with one and two
    rows a lane group, and the tile route with 1, 4 and 16 centre ranges
    wanted (fewer where C has fewer tiles). Then the crossover rows
    (KMEANS_CROSSOVER): the wrapper's rows-route plan and the one-range tile
    plan at each C, in float32 and bfloat16. Each row: device time and
    error against a float64 oracle (KMEANS_MIN_TOL and the near-tie rule),
    the wrapper's plan marked. The crossover rows set the plan's
    ``ops.ROWS_MAX_C``."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b, n, d, c in KMEANS_SHAPES:
        x, m = _unit_rows(gen, b, n, d), _unit_rows(gen, b, c, d)
        plans = {kops.tile_plan(b, n, c, sms, w) for w in KMEANS_PLAN_RANGES}
        if kops.rows_ok(c, d, 4):
            plans |= {kops.rows_plan(b, n, d, 4, sms, rows) for rows in (1, 2)}
        _kmeans_plan_rows(x, m, plans)
    (b, n, d), centres = KMEANS_CROSSOVER
    for dtype in (torch.float32, torch.bfloat16):
        for c in centres:
            x = _unit_rows(gen, b, n, d).to(dtype)
            m = _unit_rows(gen, b, c, d).to(dtype)
            rows = kops.rows_plan(b, n, d, x.element_size(), sms)
            _kmeans_plan_rows(x, m, [rows, kops.tile_plan(b, n, c, sms, 1)])


def phase_rmsnorm(gen) -> dict:
    """The RMSNorm kernel vs its plain version and ``F.rms_norm``."""
    rows_out = []
    for rows, d, dtype in RMS_SHAPES:
        x = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
        scale = 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
        got, want = rops.rms_norm(x, scale), rref.rms_norm(x, scale)
        torch.cuda.synchronize()
        check(got.dtype == dtype and bool(torch.isfinite(got).all()), f"rmsnorm at {rows, d}")
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        atol, rtol = RMS_TOL[dtype]
        ok = bool((diff <= atol + rtol * want.float().abs()).all())
        check(ok, f"rmsnorm {rows, d, dtype}: max|err| {err} past {atol} + {rtol}·|want|")
        xd = x.double()
        want64 = xd * torch.rsqrt(xd.square().mean(-1, keepdim=True) + 1e-6) * scale.double()
        diff64 = (got.double() - want64).abs()
        err64 = diff64.max().item()
        ok64 = bool((diff64 <= atol + rtol * want64.abs()).all())
        check(ok64, f"rmsnorm {rows, d, dtype}: max|err| vs f64 {err64} past {atol} + {rtol}·|want|")
        lib_scale = scale.to(dtype)
        row = {
            "shape": [rows, d, str(dtype).split(".")[-1]],
            "max_abs_err": err,
            "ms": time_ms(lambda: rops.rms_norm(x, scale)),
            "plain_ms": time_ms(lambda: rref.rms_norm(x, scale)),
            "library_ms": time_ms(lambda: F.rms_norm(x, (d,), lib_scale, 1e-6)),
            "device_ms": device_ms(lambda: rops.rms_norm(x, scale)),
            "library_device_ms": device_ms(lambda: F.rms_norm(x, (d,), lib_scale, 1e-6)),
        }
        nbytes = 2 * rows * d * x.element_size() + 4 * d
        t_bytes, t_ops = nbytes / H100_BYTES_PER_S, 4 * rows * d / H100_F32_FLOPS
        row["bound_ms"] = max(t_bytes, t_ops) * 1e3
        row["bound_by"] = "bytes" if t_bytes > t_ops else "operations"
        rows_out.append(row)
        times = " | ".join(f"{k} {row[k]:.4f} ms" for k in ZOO_TIMES)
        print(
            f"[kernel] rmsnorm rows={rows} d={d} {row['shape'][2]} (scale f32): max|err| "
            f"{err:.3e} (vs f64 {err64:.3e}) | {times} | bound {row['bound_ms']:.3e} ms "
            f"({row['bound_by']})"
        )
    return rows_out[0]  # the decode step's norm: 65 launches a step


def _decode_mask(mode, b: int, s: int, gen) -> tuple:
    """(lengths, key_pos, q_pos, window, valid (B, S)) for one of
    DECODE_SHAPES' masks. Positions: stored +1 in no order along the slots
    (0 = empty), one slot per sequence holding the query's own position, and
    at least one sequence whose valid slots are no prefix. Window: an S-slot
    ring under a window of S at a ragged query position per sequence (past
    2S: wrapped twice), each slot holding the last position it took, or
    (about a third of them) the one a turn before, older than the window."""
    lengths = key_pos = q_pos = window = None
    valid = torch.ones(b, s, dtype=torch.bool, device="cuda")
    if mode == "lengths":
        lengths = torch.randint(1, s + 1, (b,), generator=gen, device="cuda", dtype=torch.int32)
        valid = torch.arange(s, device="cuda")[None, :] < lengths[:, None]
    elif mode == "positions":
        key_pos = torch.randint(0, s + 1, (b, s), generator=gen, device="cuda", dtype=torch.int32)
        q_pos = torch.randint(0, s, (b,), generator=gen, device="cuda", dtype=torch.int32)
        cur = torch.randint(0, s, (b,), generator=gen, device="cuda")
        key_pos[torch.arange(b, device="cuda"), cur] = q_pos + 1
        valid = (key_pos > 0) & (key_pos - 1 <= q_pos[:, None])
        prefix = torch.arange(s, device="cuda")[None, :] < valid.sum(-1, keepdim=True)
        check(bool((valid != prefix).any(-1).any()), "the position mask drew only prefixes")
    elif mode == "window":
        window = s
        q_pos = torch.randint(2 * s, 3 * s, (b,), generator=gen, device="cuda", dtype=torch.int32)
        slot = torch.arange(s, device="cuda", dtype=torch.int32)
        last = q_pos[:, None] - (q_pos[:, None] - slot) % s  # the slot's latest position
        stale = torch.rand(b, s, generator=gen, device="cuda") < 1 / 3
        stale[torch.arange(b, device="cuda"), (q_pos % s).long()] = False  # the query's own
        key_pos = (last - s * stale.int() + 1).int()
        valid = (key_pos > 0) & (key_pos - 1 <= q_pos[:, None])
        valid &= q_pos[:, None] - (key_pos - 1) < window
        check(bool((~valid).any()) and bool(valid.any(-1).all()), "the window mask drew no mix")
    return lengths, key_pos, q_pos, window, valid


def phase_decode_attention(gen) -> dict:
    """The decode-attention kernel vs its plain version and
    ``F.scaled_dot_product_attention(enable_gqa=True)``, on caches in the
    zoo's (B, S, Hkv, dh) layout viewed as (B, Hkv, S, dh)."""
    rows_out = []
    for b, h, hkv, s, dh, mode in DECODE_SHAPES:
        q = torch.randn(b, h, dh, generator=gen, device="cuda")
        kc, vc = (
            torch.randn(b, s, hkv, dh, generator=gen, device="cuda").bfloat16().transpose(1, 2)
            for _ in range(2)
        )
        lengths, key_pos, q_pos, window, valid = _decode_mask(mode, b, s, gen)

        def kernel():
            return dops.decode_attention(
                q, kc, vc, lengths, key_pos=key_pos, q_pos=q_pos, window=window
            )

        def plain():
            return dref.decode_attention(q, kc, vc, lengths, key_pos, q_pos, window)

        got = kernel()
        want = plain()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(bool(torch.isfinite(got).all()), f"non-finite decode attention at {(b, h, s)}")
        check(err <= DECODE_TOL, f"decode attention max|err| {err} > {DECODE_TOL} at {(b, h, s)}")
        want64 = decode_oracle64(q, kc, vc, lengths, key_pos, q_pos, window)
        err64 = (got.double() - want64).abs().max()
        err64 = err64.item()
        check(err64 <= DECODE_TOL, f"decode attention error vs f64 {err64} at {(b, h, s, dh)}")
        q4 = q.bfloat16()[:, :, None, :]
        mask = None if mode is None else valid[:, None, None, :]

        def library():
            return F.scaled_dot_product_attention(q4, kc, vc, attn_mask=mask, enable_gqa=True)

        keys = int(valid.sum())  # the cache rows this run's output depends on
        plan = dops.device_plan(q, kc, lengths)
        if s <= 64:
            check(plan.splits == 1, f"decode step shape: {plan.splits} key ranges, not 1")
        row = {
            "shape": [b, h, hkv, s, dh] + ([mode] if mode else []),
            "max_abs_err": err,
            "ms": time_ms(kernel),
            "plain_ms": time_ms(plain),
            "library_ms": time_ms(library),
            "device_ms": device_ms(kernel),
            "library_device_ms": device_ms(library),
        }
        mask_bytes = 4 * b if mode == "lengths" else (4 * b * s + 4 * b if mode else 0)
        nbytes = 2 * keys * hkv * dh * 2 + 2 * b * h * dh * 4 + mask_bytes
        t_bytes, t_ops = nbytes / H100_BYTES_PER_S, 4 * h * dh * keys / H100_F32_FLOPS
        row["bound_ms"] = max(t_bytes, t_ops) * 1e3
        row["bound_by"] = "bytes" if t_bytes > t_ops else "operations"
        rows_out.append(row)
        times = " | ".join(f"{k} {row[k]:.4f} ms" for k in ZOO_TIMES)
        what = {
            None: "",
            "lengths": " ragged lengths",
            "positions": " non-prefix positions",
            "window": f" ring under window {window}",
        }
        print(
            f"[kernel] decode_attention B={b} H={h} Hkv={hkv} S={s} dh={dh} bf16 cache"
            f"{what[mode]}: {_plan_text(plan)} | max|err| {err:.3e} (vs f64 {err64:.3e}) | "
            f"{times} | "
            f"bound {row['bound_ms']:.3e} ms ({row['bound_by']})"
        )
    return rows_out[2]  # the decode step's launch (32 a step) with the path's mask


def _plan_text(plan) -> str:
    return (
        f"{plan.splits} key range(s) of {plan.range_keys} keys, {plan.blocks} blocks of "
        f"{plan.warps} warps, {dops.STAGES} stages"
    )


def decode_oracle64(q, kc, vc, lengths=None, key_pos=None, q_pos=None, window=None):
    """Decode attention in float64, with the plain version's masks (the
    plain version computes in float32 whatever its inputs)."""
    b, h, dh = q.shape
    _, hkv, s, _ = kc.shape
    qd = q.double().reshape(b, hkv, h // hkv, dh)
    scores = torch.einsum("bkgd,bksd->bkgs", qd, kc.double()) / dh**0.5
    valid = torch.ones(b, s, dtype=torch.bool, device=q.device)
    if lengths is not None:
        valid &= torch.arange(s, device=q.device)[None, :] < lengths[:, None]
    if key_pos is not None:
        valid &= (key_pos > 0) & (key_pos - 1 <= q_pos[:, None])
    if window is not None:
        valid &= q_pos[:, None] - (key_pos - 1) < window
    p = torch.softmax(torch.where(valid[:, None, None, :], scores, -1e30), dim=-1)
    return torch.einsum("bkgs,bksd->bkgd", p, vc.double()).reshape(b, h, dh)


def phase_decode_plans(gen) -> None:
    """The decode kernel under other plans than the wrapper's: device time
    and error against a float64 plain version (within DECODE_TOL) of 1 to
    128 key ranges and of the wrapper's plans with and without per-sequence
    lengths, at the long context shape (unmasked and with ragged lengths)
    and at llama3-405b's G = 16 shape (unmasked); the wrapper's plan for the
    row's mask marked."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for shape, modes in ((DECODE_SHAPES[3], (None, "lengths")), (DECODE_SHAPES[7], (None,))):
        b, h, hkv, s, dh, _ = shape
        q = torch.randn(b, h, dh, generator=gen, device="cuda")
        kc, vc = (
            torch.randn(b, s, hkv, dh, generator=gen, device="cuda").bfloat16().transpose(1, 2)
            for _ in range(2)
        )
        full = torch.full((b,), s, dtype=torch.int32, device="cuda")  # any lengths: their plan
        defaults = {None: dops.device_plan(q, kc), "lengths": dops.device_plan(q, kc, full)}
        plans = {dops.split_plan(b, hkv, h // hkv, s, dh, 2, sms, w) for w in DECODE_PLAN_RANGES}
        plans |= set(defaults.values())
        for mode in modes:
            lengths = _decode_mask(mode, b, s, gen)[0]
            want64 = decode_oracle64(q, kc, vc, lengths)
            for plan in sorted(plans):
                got = dops.launch(q, kc, vc, lengths, None, None, plan)
                err = (got.double() - want64).abs().max().item()
                check(err <= DECODE_TOL, f"decode plan {plan}: error {err} vs f64")
                ms = device_ms(lambda: dops.launch(q, kc, vc, lengths, None, None, plan))
                mark = " (the wrapper's plan)" if plan == defaults[mode] else ""
                print(
                    f"[plan] decode_attention B={b} H={h} Hkv={hkv} S={s} dh={dh} bf16"
                    f"{' ragged lengths' if mode else ''}: {_plan_text(plan)} | device_ms "
                    f"{ms:.4f} | max|err| vs f64 {err:.3e}{mark}"
                )


def phase_one_shot_a(line: str) -> tuple:
    """Alg. 1 on hard/overlap-32 (the port's own data); returns the k-means
    launches it should have made, the result and its artifact."""
    spec = scenarios.HARD_OVERLAP_32
    bundle = scenarios.build(spec, seed=SEED, device="cuda")
    cfg = ProtocolConfig(
        client_epochs=spec.budget("client_epochs", 20),
        server_epochs=spec.budget("server_epochs", 50),
    )
    res = run_one_shot(SEED, bundle.split, bundle.extractors, bundle.ssl_cfgs, cfg, device="cuda")
    purity = res.diagnostics["kmeans_purity"]
    check(res.ledger.comm_times() == 3, f"A: {res.ledger.comm_times()} comm times, not 3")
    check(res.ledger.total_bytes() == 12288, f"A: {res.ledger.total_bytes()} bytes, not 12288")
    check(all(p > 0.5 for p in purity), f"A: k-means purity {purity}")
    check(res.metric_name == "auc" and res.metric > 0.6, f"A: {res.metric_name} {res.metric}")
    steps = " ".join(f"{k} {v:.1f}" for k, v in res.diagnostics["step_ms"].items())
    print(
        f"[one-shot A] {spec.name}: AUC {res.metric:.4f} | {res.ledger.total_bytes()} bytes in "
        f"{res.ledger.comm_times()} comm times | purity {purity} | step ms: {steps} | {line}"
    )
    return cfg.kmeans_iters + 2, res, res.to_artifact(spec.name, bundle.split)


def phase_one_shot_b(line: str):
    """Alg. 1 at full CNN width, its epochs cut to B_CLIENT_EPOCHS and
    B_SERVER_EPOCHS; returns (the trained artifact, the k-means launches it
    should have made)."""
    t0 = time.perf_counter()
    bundle = scenarios.build(IMAGE_B, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    setup_ms = (time.perf_counter() - t0) * 1e3
    split = bundle.split
    cfg = ProtocolConfig(client_epochs=B_CLIENT_EPOCHS, server_epochs=B_SERVER_EPOCHS)
    res = run_one_shot(SEED, split, bundle.extractors, bundle.ssl_cfgs, cfg, device="cuda")
    purity = res.diagnostics["kmeans_purity"]
    want_bytes = 3 * 2 * IMAGE_B.overlap * IMAGE_B.rep_dim * 4
    check(res.ledger.comm_times() == 3, f"B: {res.ledger.comm_times()} comm times, not 3")
    check(res.ledger.total_bytes() == want_bytes, f"B: {res.ledger.total_bytes()} bytes")
    check(all(p > 0.5 for p in purity), f"B: k-means purity {purity}")
    check(res.metric_name == "accuracy" and res.metric > 0.2, f"B: {res.metric_name} {res.metric}")
    ms = res.diagnostics["step_ms"]
    ssl_steps = sum(res.diagnostics["ssl_steps"])
    steps = " ".join(f"{k} {v:.1f}" for k, v in ms.items())
    print(
        f"[one-shot B] {IMAGE_B.name}: {IMAGE_B.num_samples} rows, halves "
        f"{tuple(split.aligned[0].shape[1:])}, pools {[u.shape[0] for u in split.unaligned]}, "
        f"test {split.test_labels.shape[0]}, CNN 32/64/128 x2 rep 128, client_epochs "
        f"{cfg.client_epochs}, server_epochs {cfg.server_epochs}: accuracy {res.metric:.4f} | "
        f"{res.ledger.total_bytes()} bytes in {res.ledger.comm_times()} comm times | "
        f"purity {purity} | "
        f"data {setup_ms:.1f} ms | step ms: {steps} | SSL {ssl_steps} steps, "
        f"{ms['4_local_ssl'] / ssl_steps:.3f} ms/step | total {sum(ms.values()):.1f} ms | {line}"
    )
    print(json.dumps({"one_shot_b_step_ms": ms, "ssl_steps": ssl_steps}))
    return res.to_artifact(IMAGE_B.name, split), cfg.kmeans_iters + 2


def check_step3p(res, what: str, tol: float = KERNEL_TOL) -> str:
    """Step ③' of a few-shot run recomputed on the CPU's plain route from
    the run's own reps and heads: each Eq. 10 estimate and p̂ within ``tol``
    of the card's, and the gate decisions equal except on near-ties (a
    head's top confidence within NEAR_GATE of t, or its top two class
    probabilities within NEAR_GATE). Returns the printed summary."""
    rec = res.diagnostics["fewshot_step3p"]
    t = res.cfg.fewshot_threshold
    h_u = [h.cpu() for h in rec["h_u"]]
    h_o = [h.cpu() for h in rec["h_o"]]
    cpu = VFLServer(
        num_classes=res.server.num_classes,
        classifier=copy.deepcopy(rec["joint"]).cpu(),
        aux_classifiers=[copy.deepcopy(m).cpu() for m in res.server.aux_classifiers],
    )
    err = prob_err = 0.0
    near = differ = 0
    for k, (h, p_card) in enumerate(zip(h_u, rec["probs"])):
        ests: list = []
        p_plain = dispatch.fewshot_probs(cpu, k, h, h_o, t, ests)
        for e_plain, e_card in zip(ests, rec["estimates"][k]):
            check(e_card.is_cuda, f"{what}: step ③' ran off the card")
            check(e_card.shape == e_plain.shape, f"{what}: estimate shapes differ")
            if e_plain.numel():  # an empty pool has nothing to estimate
                err = max(err, (e_card.cpu() - e_plain).abs().max().item())
        parts = list(ests)
        parts.insert(k, h)
        near_k = torch.zeros(h.shape[0], dtype=torch.bool)
        with torch.no_grad():
            full = torch.cat([p.float() for p in parts], -1)
            for logits in (cpu.aux_classifiers[k](h.float()), cpu.classifier(full)):
                top = torch.softmax(logits, -1).topk(2, dim=-1).values
                near_k |= (top[:, 0] - t).abs() <= NEAR_GATE
                near_k |= top[:, 0] - top[:, 1] <= NEAR_GATE
        gate_card, gate_plain = p_card.cpu() > 0, p_plain > 0
        wrong = gate_card != gate_plain
        check(not bool((wrong & ~near_k).any()), f"{what}: party {k} gate differs off near-ties")
        both = gate_card & gate_plain
        if bool(both.any()):
            prob_err = max(prob_err, (p_card.cpu() - p_plain)[both].abs().max().item())
        near += int(near_k.sum())
        differ += int(wrong.sum())
    check(err <= tol, f"{what}: step ③' estimates vs plain max|err| {err} > {tol}")
    check(prob_err <= tol, f"{what}: p̂ vs plain max|err| {prob_err} > {tol}")
    return (
        f"③' vs plain route: estimates max|err| {err:.3e}, p̂ max|err| {prob_err:.3e}, gate "
        f"decisions differ on {differ} rows ({near} near-tie rows exempt)"
    )


def _rates(rates) -> list:
    return [round(r, 4) for r in rates]


def _few_shot_line(res, what: str, spec_name: str, line: str) -> dict:
    d = res.diagnostics
    ms = d["step_ms"]
    steps5p = sum(d["fewshot_ssl_steps"])
    shapes = [
        (1, h.shape[0], o.shape[0], o.shape[1], o.shape[1])
        for h, o in zip(d["fewshot_step3p"]["h_u"], d["fewshot_step3p"]["h_o"])
    ]
    step3p = check_step3p(res, what)
    print(
        f"[few-shot {what}] {spec_name}: {res.metric_name} {res.metric:.4f} (its one-shot pass "
        f"{d['one_shot_metric']:.4f}) | {res.ledger.total_bytes()} bytes in "
        f"{res.ledger.comm_times()} comm times | gate rate {_rates(d['fewshot_gate_rate'])} take "
        f"rate {_rates(d['fewshot_take_rate'])} | ③' shapes {shapes} | {step3p} | step ms: "
        f"{' '.join(f'{k} {v:.1f}' for k, v in ms.items())} | ⑤' {steps5p} steps, "
        f"{ms['5p_local_ssl'] / steps5p:.3f} ms/step | total {sum(ms.values()):.1f} ms | {line}"
    )
    return {"step_ms": ms, "fewshot_ssl_steps": d["fewshot_ssl_steps"]}


def phase_few_shot_a(line: str) -> tuple:
    """Alg. 2 on hard/overlap-32 at its budgets, the client epochs cut
    A_FEW_EPOCH_CUT-fold; returns the (sdpa_estimator,
    kmeans) launches it should have made and its AUC."""
    spec = scenarios.HARD_OVERLAP_32
    bundle = scenarios.build(spec, seed=SEED, device="cuda")
    cfg = _cut_cfg(spec, A_FEW_EPOCH_CUT)
    res = run_few_shot(SEED, bundle.split, bundle.extractors, bundle.ssl_cfgs, cfg, device="cuda")
    check(res.ledger.comm_times() == 5, f"few-shot A: {res.ledger.comm_times()} comm times, not 5")
    check(res.ledger.total_bytes() == 177408, f"few-shot A: {res.ledger.total_bytes()} bytes")
    check(res.metric_name == "auc" and res.metric > 0.6, f"few-shot A: {res.metric}")
    _few_shot_line(res, "A", spec.name, line)
    # ③': one Eq. 10 launch a party (its K − 1 estimates fused); ③: 27
    return len(bundle.split.aligned), cfg.kmeans_iters + 2, res.metric


def phase_few_shot_b(line: str) -> tuple:
    """Alg. 2 at full CNN width, ``client_epochs`` cut to
    FEW_B_CLIENT_EPOCHS and ``server_epochs`` to B_SERVER_EPOCHS; returns the (sdpa_estimator, kmeans) launches it
    should have made."""
    bundle = scenarios.build(IMAGE_B, seed=SEED, device="cuda")
    split = bundle.split
    cfg = ProtocolConfig(client_epochs=FEW_B_CLIENT_EPOCHS, server_epochs=B_SERVER_EPOCHS)
    res = run_few_shot(SEED, split, bundle.extractors, bundle.ssl_cfgs, cfg, device="cuda")
    n_u = [u.shape[0] for u in split.unaligned]
    rep = 4 * IMAGE_B.rep_dim
    want = 4 * 2 * IMAGE_B.overlap * rep + sum(n * (rep + 4) for n in n_u)
    check(want == 32099840, f"few-shot B: pools {n_u} give {want} bytes, not 32099840")
    check(res.ledger.comm_times() == 5, f"few-shot B: {res.ledger.comm_times()} comm times, not 5")
    check(res.ledger.total_bytes() == want, f"few-shot B: {res.ledger.total_bytes()} bytes")
    check(res.metric_name == "accuracy" and res.metric > 0.2, f"few-shot B: {res.metric}")
    print(
        f"[few-shot B] {IMAGE_B.name}: pools {n_u}, client_epochs {cfg.client_epochs} (cut from "
        f"{ProtocolConfig().client_epochs}), server_epochs {cfg.server_epochs} (cut from "
        f"{ProtocolConfig().server_epochs}), ⑤' labeled rows "
        f"{[IMAGE_B.overlap + n for n in n_u]}"
    )
    out = _few_shot_line(res, "B", IMAGE_B.name, line)
    print(json.dumps({"few_shot_b": out}))
    return len(split.aligned), cfg.kmeans_iters + 2


def _baseline_row(name: str, res, cell: str, spec_name: str, line: str) -> dict:
    """Check a baseline run's ledger against BASELINE_LEDGERS[cell], print
    it, and return its numbers."""
    d = res.diagnostics
    want = BASELINE_LEDGERS[cell][name]
    got = (res.ledger.total_bytes(), res.ledger.comm_times())
    check(got == want, f"{spec_name} {name}: (bytes, comm times) {got}, not {want}")
    check(bool(torch.isfinite(d["losses"]).all()), f"{spec_name} {name}: a loss is not finite")
    steps = d.get("iterations", d.get("rounds"))
    ms = d["step_ms"]
    row = {
        "method": name,
        "metric": res.metric,
        "bytes": got[0],
        "comm_times": got[1],
        "steps": steps,
        "ms_per_step": ms["session"] / steps,
        "wall_ms": sum(ms.values()),
        "final_loss": d["final_loss"],
    }
    unit = "round" if "Q" in d else "iteration"
    each = f" of Q = {d['Q']} local updates" if "Q" in d else ""
    print(
        f"[baselines {cell}] {spec_name} {name}: "
        f"{res.metric_name} {res.metric:.4f} | {got[0]} bytes in {got[1]} comm times | {steps} "
        f"{unit}s{each}, {row['ms_per_step']:.3f} ms a {unit} | final loss {d['final_loss']:.4f} | "
        f"setup {ms['setup']:.1f} session {ms['session']:.1f} eval {ms['eval']:.1f} ms | {line}"
    )
    return row


def phase_baselines_a(line: str, one_shot) -> list:
    """SplitNN, FedBCD and FedCVT on hard/overlap-32 at its budget of 400
    iterations, beside one-shot A on the same split: AUC > 0.5 each (the
    reference's bar), the exact ledgers, and one-shot's AUC margin and byte
    ratio over vanilla (the paper's limited-overlap claim)."""
    spec = scenarios.HARD_OVERLAP_32
    bundle = scenarios.build(spec, seed=SEED, device="cuda")
    cfg = baselines.IterativeConfig(iterations=spec.budget("iterations", 300))
    rows = []
    for name, fn in BASELINE_RUNNERS:
        res = fn(SEED, bundle.split, bundle.extractors, bundle.ssl_cfgs, cfg, device="cuda")
        check(res.metric_name == "auc" and res.metric > 0.5, f"A {name}: AUC {res.metric}")
        rows.append(_baseline_row(name, res, "A", spec.name, line))
    van = rows[0]
    ratio = van["bytes"] / one_shot.ledger.total_bytes()
    print(
        f"[baselines A] one-shot A vs vanilla on {spec.name}: AUC {one_shot.metric:.4f} - "
        f"{van['metric']:.4f} = {one_shot.metric - van['metric']:+.4f} | bytes "
        f"{one_shot.ledger.total_bytes()} vs {van['bytes']} ({ratio:.1f}x fewer) | comm times "
        f"{one_shot.ledger.comm_times()} vs {van['comm_times']}"
    )
    return rows


def _params(res) -> list:
    mods = [c.extractor for c in res.clients] + [res.server.classifier]
    return [p.detach().cpu() for m in mods for p in m.parameters()]


def _trajectory_err(a, b) -> tuple:
    """(losses, parameters) of run a against run b: the largest difference
    relative to b's largest loss, and to b's largest parameter."""
    pa, pb = _params(a), _params(b)
    scale = max(q.abs().max() for q in pb)
    params = max((p - q).abs().max() for p, q in zip(pa, pb)) / scale
    return _rel(a.diagnostics["losses"], b.diagnostics["losses"]), float(params)


def check_b_card_equals_cpu(split: VerticalSplit, specs, ssl_cfgs) -> str:
    """The first B_CONTRAST_ITERATIONS SplitNN iterations of B on the card
    and on the CPU, from the same seed (the same initial parameters and
    schedule): losses and final parameters within LOGIT_RTOL. Beside it the
    CPU against itself at one thread, the floor that summation order alone
    gives, and both again at twice the iterations (printed, not checked)."""
    test_aligned = [x[:B_CONTRAST_TEST_ROWS] for x in split.test_aligned]
    small = VerticalSplit(
        aligned=split.aligned,
        labels=split.labels,
        unaligned=[u[:0] for u in split.unaligned],
        test_aligned=test_aligned,
        test_labels=split.test_labels[:B_CONTRAST_TEST_ROWS],
        num_classes=split.num_classes,
    )
    threads = torch.get_num_threads()
    out = []
    for iterations in (B_CONTRAST_ITERATIONS, 2 * B_CONTRAST_ITERATIONS):
        cfg = baselines.IterativeConfig(iterations=iterations)
        card = baselines.run_vanilla(SEED, small, specs, ssl_cfgs, cfg, device="cuda")
        cpu = baselines.run_vanilla(SEED, small, specs, ssl_cfgs, cfg, device="cpu")
        torch.set_num_threads(1)
        try:
            cpu1 = baselines.run_vanilla(SEED, small, specs, ssl_cfgs, cfg, device="cpu")
        finally:
            torch.set_num_threads(threads)
        err, floor = _trajectory_err(card, cpu), _trajectory_err(cpu1, cpu)
        if iterations == B_CONTRAST_ITERATIONS:
            check(err[0] <= LOGIT_RTOL, f"B card vs CPU: losses differ by {err[0]} relative")
            check(err[1] <= LOGIT_RTOL, f"B card vs CPU: parameters differ by {err[1]} relative")
        out.append(
            f"{iterations} iterations: losses {err[0]:.3e}, parameters {err[1]:.3e} (CPU at 1 "
            f"thread vs {threads}: {floor[0]:.3e}, {floor[1]:.3e})"
        )
    return (
        f"card vs CPU ({threads} threads), SplitNN from the same parameters, relative to the "
        f"largest loss and parameter; checked at {B_CONTRAST_ITERATIONS} iterations against "
        f"{LOGIT_RTOL}: " + "; ".join(out)
    )


def phase_baselines_b(line: str) -> list:
    """The three baselines at B's full CNN width (IMAGE_B, N_o = 2048), cut
    to B_BASELINE_ITERATIONS: accuracy > 0.2 each and the exact ledgers; and
    the card ≡ CPU check of B's first SplitNN iterations."""
    bundle = scenarios.build(IMAGE_B, seed=SEED, device="cuda")
    rows = []
    for name, fn in BASELINE_RUNNERS:
        cfg = baselines.IterativeConfig(iterations=B_BASELINE_ITERATIONS[name])
        res = fn(SEED, bundle.split, bundle.extractors, bundle.ssl_cfgs, cfg, device="cuda")
        check(res.metric_name == "accuracy" and res.metric > 0.2, f"B {name}: {res.metric}")
        rows.append(_baseline_row(name, res, "B", IMAGE_B.name, line))
        del res
        torch.cuda.empty_cache()
    contrast = check_b_card_equals_cpu(bundle.split, bundle.extractors, bundle.ssl_cfgs)
    print(f"[baselines B] {contrast}")
    print(json.dumps({"baselines_b": rows}))
    return rows


def phase_finetune_a(line: str, few_shot_auc: float) -> tuple:
    """Few-shot + finetune on hard/overlap-32 at few-shot A's budget and 200
    finetune iterations: its few-shot pass equals [few-shot A] (same seed,
    same draws), the shared ledger, AUC > 0.6. Returns the (sdpa_estimator,
    kmeans) launches it should have made."""
    spec = scenarios.HARD_OVERLAP_32
    bundle = scenarios.build(spec, seed=SEED, device="cuda")
    cfg = _cut_cfg(spec, A_FEW_EPOCH_CUT)
    res = run_few_shot_finetune(
        SEED, bundle.split, bundle.extractors, bundle.ssl_cfgs, cfg, FINETUNE_ITERATIONS, "cuda"
    )
    d = res.diagnostics
    want = (
        177408 + FINETUNE_ITERATIONS * 2 * 2 * 32 * spec.rep_dim * 4,
        5 + 2 * FINETUNE_ITERATIONS,
    )
    got = (res.ledger.total_bytes(), res.ledger.comm_times())
    check(got == want == (1815808, 405), f"finetune A: (bytes, comm times) {got}, not {want}")
    check(
        d["fewshot_metric"] == few_shot_auc,
        f"finetune A: its few-shot pass's AUC {d['fewshot_metric']} != few-shot A's {few_shot_auc}",
    )
    check(res.metric_name == "auc" and res.metric > 0.6, f"finetune A: AUC {res.metric}")
    ms = d["step_ms"]
    print(
        f"[few-shot + finetune A] {spec.name}: AUC {res.metric:.4f} after {FINETUNE_ITERATIONS} "
        f"finetune iterations (its few-shot pass {d['fewshot_metric']:.4f}, equal to [few-shot A]) "
        f"| {got[0]} bytes in {got[1]} comm times | finetune "
        f"{ms['finetune_session'] / FINETUNE_ITERATIONS:.3f} ms an iteration, final loss "
        f"{d['final_loss']:.4f} | total {sum(ms.values()):.1f} ms | {line}"
    )
    return len(bundle.split.aligned), cfg.kmeans_iters + 2


def _budget_cfg(spec, **kw) -> ProtocolConfig:
    return ProtocolConfig(
        client_epochs=spec.budget("client_epochs", 20),
        server_epochs=spec.budget("server_epochs", 50),
        **kw,
    )


def _cut_cfg(spec, cut: int, **kw) -> ProtocolConfig:
    """``spec``'s budget with its client epochs cut ``cut``-fold (at least
    one): a cut of depth, never of width or rows."""
    cfg = _budget_cfg(spec, **kw)
    return dataclasses.replace(cfg, client_epochs=max(1, cfg.client_epochs // cut))


def _catalog_cfg(spec, **kw) -> ProtocolConfig:
    """A catalog run's budget: an image scenario's as registered, a tabular
    one's with its client epochs cut CATALOG_EPOCH_CUT-fold."""
    if spec.modality == "image":
        return _budget_cfg(spec, **kw)
    return _cut_cfg(spec, CATALOG_EPOCH_CUT, **kw)


def image_bar(n_test: int) -> float:
    """Chance plus two standard errors of a mean accuracy at chance over
    IMAGE_SEEDS runs of ``n_test`` test rows each."""
    n = len(IMAGE_SEEDS) * n_test
    return IMAGE_CHANCE + 2 * (IMAGE_CHANCE * (1 - IMAGE_CHANCE) / n) ** 0.5


def _catalog_run(runner, bundle, cfg, protocol: str, want_bytes: int, seed: int = SEED) -> tuple:
    """One catalog run on the card, checked: the expected bytes, 3 or 5
    comm times, a finite metric, a tabular AUC above its bar (an image
    scenario's bar holds its mean over seeds: :func:`phase_catalog`).
    Returns (result, its JSON row) and prints its line at seed 0."""
    spec, split = bundle.spec, bundle.split
    t0 = time.perf_counter()
    res = runner(seed, split, bundle.extractors, bundle.ssl_cfgs, cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    what = f"catalog {spec.name} {protocol}{' bf16' if cfg.rep_dtype == torch.bfloat16 else ''}"
    times = 3 if protocol == "one-shot" else 5
    got = (res.ledger.total_bytes(), res.ledger.comm_times())
    check(got == (want_bytes, times), f"{what}: (bytes, comm times) {got}, not {(want_bytes, times)}")
    check(math.isfinite(res.metric), f"{what}: {res.metric_name} {res.metric}")
    if res.metric_name in CATALOG_BARS:
        bar = CATALOG_BARS[res.metric_name]
        check(res.metric > bar, f"{what}: {res.metric_name} {res.metric} not above {bar}")
        held = f"bar > {bar}"
    else:
        held = f"seed {seed}; the bar holds the mean over seeds {IMAGE_SEEDS[0]}-{IMAGE_SEEDS[-1]}"
    if seed != SEED:
        return res, None
    d, ms = res.diagnostics, res.diagnostics["step_ms"]
    n = split.aligned[0].shape[0]
    rows = f"N_o {n}" if spec.overlap_capacity is None else f"capacity {n}, N_o {spec.overlap}"
    steps4 = sum(d["ssl_steps"])
    fields = [
        f"K {spec.num_parties}, {rows}, N_u {[u.shape[0] for u in split.unaligned]}",
        f"{res.metric_name} {res.metric:.4f} ({held})",
        f"{got[0]} bytes (expected {want_bytes}) in {got[1]} comm times (expected {times})",
        f"④ {ms['4_local_ssl'] / steps4:.3f} ms a step ({steps4} steps)",
    ]
    if protocol == "few-shot":
        steps5 = sum(d["fewshot_ssl_steps"])
        fields.append(f"⑤' {ms['5p_local_ssl'] / steps5:.3f} ms a step ({steps5} steps)")
        fields.append(
            f"gate {_rates(d['fewshot_gate_rate'])} take {_rates(d['fewshot_take_rate'])}"
        )
    fields.append(f"wall {wall:.2f} s")
    print(f"[catalog] {spec.name} {protocol}{' bf16' if 'bf16' in what else ''}: "
          + " | ".join(fields))
    row = {
        "scenario": spec.name,
        "protocol": protocol,
        "rep_dtype": str(cfg.rep_dtype).removeprefix("torch."),
        "metric_name": res.metric_name,
        "metric": res.metric,
        "bytes": got[0],
        "comm_times": got[1],
        "wall_s": wall,
        "step_ms": ms,
    }
    return res, row


def phase_catalog(line: str) -> dict:
    """One-shot and few-shot (one-shot only on CATALOG_ONE_SHOT_ONLY) on
    every scenario of CATALOG_RUN through ``scenarios.build(...,
    device="cuda")``, ``run_one_shot`` and ``run_few_shot`` at seed 0 and the
    registered sizes and budgets (:func:`_catalog_cfg`), each held to
    CATALOG_LEDGERS and CATALOG_BARS; the image scenarios' few-shot also at the other
    IMAGE_SEEDS as one ``run_seeds`` fold, each protocol's mean accuracy
    held to :func:`image_bar`;
    ③' against the CPU's plain route on CATALOG_STEP3P; SplitNN on the
    credit sweep at its 400
    iterations beside both (Fig. 6/7's comparison at each N_o); and
    hard/overlap-32 with bf16 reps against CATALOG_BF16_LEDGERS, its ③'
    within BF16_STEP3P_TOL. Returns the kernel launches it should have made,
    each run's row and the sweep's rows."""
    want = {"sdpa": 0, "kmeans": 0, "runs": [], "sweep": [], "image": []}

    def count(split, cfg, few_shot: bool):
        # ③: one batched search of kmeans_iters + 2 launches a run; few-shot's
        # ③': one fused launch (width K − 1) a party whose pool is not empty
        want["kmeans"] += cfg.kmeans_iters + 2
        if few_shot:
            want["sdpa"] += sum(1 for u in split.unaligned if u.shape[0] > 0)

    for name in CATALOG_RUN:
        bundle = scenarios.build(name, seed=SEED, device="cuda")
        spec, cfg = bundle.spec, _catalog_cfg(bundle.spec)
        one, row1 = _catalog_run(run_one_shot, bundle, cfg, "one-shot", CATALOG_LEDGERS[name][0])
        want["runs"].append(row1)
        count(bundle.split, cfg, False)
        if name in CATALOG_ONE_SHOT_ONLY:
            continue
        few, row2 = _catalog_run(run_few_shot, bundle, cfg, "few-shot", CATALOG_LEDGERS[name][1])
        want["runs"].append(row2)
        count(bundle.split, cfg, True)
        if spec.modality == "image":
            # few-shot at the other seeds as ONE fold (run_seeds): its one-shot
            # pass is run_one_shot's; one k-means search and one ③' launch a
            # party for the seven
            means = {"one-shot": [one.metric], "few-shot": [few.metric]}
            seeds = list(IMAGE_SEEDS[1:])
            bs = [scenarios.build(name, seed=seed, device="cuda") for seed in seeds]
            t0 = time.perf_counter()
            fold = run_seeds(
                run_few_shot, seeds, [b.split for b in bs], [b.extractors for b in bs],
                [b.ssl_cfgs for b in bs], cfg, device="cuda",
            )
            torch.cuda.synchronize()
            for seed, res in zip(seeds, fold):
                got = (res.ledger.total_bytes(), res.ledger.comm_times())
                what = f"catalog {name} few-shot seed {seed}"
                check(got == (CATALOG_LEDGERS[name][1], 5), f"{what}: (bytes, comm times) {got}")
                check(math.isfinite(res.metric), f"{what}: {res.metric_name} {res.metric}")
                check(res.diagnostics["seed_fold"] == len(seeds), f"{what}: not folded")
                means["one-shot"].append(res.diagnostics["one_shot_metric"])
                means["few-shot"].append(res.metric)
            count(bs[0].split, cfg, True)
            print(
                f"[catalog] {name} few-shot seeds {seeds[0]}-{seeds[-1]}: one run_seeds fold "
                f"(engine_path {fold[0].diagnostics['engine_path']}, seed_fold "
                f"{fold[0].diagnostics['seed_fold']}) in {time.perf_counter() - t0:.2f} s"
            )
            bar = image_bar(bundle.split.test_labels.shape[0])
            for proto, accs in means.items():
                mean = sum(accs) / len(accs)
                check(mean > bar, f"catalog {name} {proto}: mean accuracy {mean} not above {bar}")
                want["image"].append({"scenario": name, "protocol": proto, "accuracy": accs})
                print(
                    f"[catalog] {name} {proto} over seeds {IMAGE_SEEDS[0]}-{IMAGE_SEEDS[-1]}: "
                    f"accuracy {_rates(accs)}, mean {mean:.4f} (bar > {bar:.4f}: chance "
                    f"{IMAGE_CHANCE} + 2 standard errors)"
                )
        if name in CATALOG_STEP3P:
            widths = sorted({len(e) for e in few.diagnostics["fewshot_step3p"]["estimates"]})
            print(f"[catalog] {name} ③' (width {widths}) {check_step3p(few, name)}")
        if name.startswith("credit/overlap-"):
            it = baselines.IterativeConfig(iterations=spec.budget("iterations", 300))
            van = baselines.run_vanilla(
                SEED, bundle.split, bundle.extractors, bundle.ssl_cfgs, it, device="cuda"
            )
            got = (van.ledger.total_bytes(), van.ledger.comm_times())
            check(got == BASELINE_LEDGERS["A"]["vanilla"], f"{name} vanilla: {got}")
            check(van.metric > 0.5, f"{name} vanilla: AUC {van.metric}")
            sweep = {"scenario": name, "overlap": spec.overlap, "vanilla": van.metric}
            for proto, res in (("one_shot", one), ("few_shot", few)):
                sweep[proto] = res.metric
                sweep[f"{proto}_byte_ratio"] = got[0] / res.ledger.total_bytes()
            want["sweep"].append(sweep)
            print(
                f"[catalog] Fig. 6/7 N_o {spec.overlap}: vanilla AUC {van.metric:.4f} ({it.iterations} "
                f"iterations, {got[0]} bytes in {got[1]} comm times) | one-shot {one.metric:.4f} "
                f"({one.metric - van.metric:+.4f}, {sweep['one_shot_byte_ratio']:.1f}x fewer bytes) "
                f"| few-shot {few.metric:.4f} ({few.metric - van.metric:+.4f}, "
                f"{sweep['few_shot_byte_ratio']:.1f}x fewer bytes)"
            )
        del one, few, bundle
    for name, (one_b, few_b) in CATALOG_BF16_LEDGERS.items():
        bundle = scenarios.build(name, seed=SEED, device="cuda")
        cfg = _catalog_cfg(bundle.spec, rep_dtype=torch.bfloat16)
        _, row1 = _catalog_run(run_one_shot, bundle, cfg, "one-shot", one_b)
        few, row2 = _catalog_run(run_few_shot, bundle, cfg, "few-shot", few_b)
        want["runs"] += [row1, row2]
        count(bundle.split, cfg, False)
        count(bundle.split, cfg, True)
        rec = few.diagnostics["fewshot_step3p"]
        check(all(h.dtype == torch.bfloat16 for h in rec["h_u"] + rec["h_o"]), "bf16: reps")
        check(all(p.dtype == torch.float32 for p in rec["probs"]), "bf16: p̂ is not f32")
        step3p = check_step3p(few, f"{name} bf16", BF16_STEP3P_TOL)
        print(f"[catalog] {name} bf16 ③' (bf16 h_u, H_o; tolerance {BF16_STEP3P_TOL}) {step3p}")
    print(json.dumps({key: want[key] for key in ("runs", "sweep", "image")}))
    return want


def fault_launches(fault, num_parties: int, pools: list, few_shot: bool) -> int:
    """The Eq. 10 launches a fault/* run should make: one a party the fault
    drops at ⑤ and at the evaluation (and, few-shot, at ⑥' and its own
    evaluation), plus few-shot's ③', one a party with a non-empty pool (a
    dropped party's ③' still runs; only its p̂ goes nowhere)."""
    if fault is None:
        dropped = {point: 0 for point in (2, 3, 4)}
    else:
        dropped = {point: sum(fault.drops(k, point) for k in range(num_parties)) for point in (2, 3, 4)}
    one_shot = dropped[2] + dropped[4]  # POINT_UPLOAD2, POINT_EVAL
    if not few_shot:
        return one_shot
    return one_shot + sum(1 for n in pools if n > 0) + dropped[3] + dropped[4]


def check_reconstructions(res, what: str) -> tuple:
    """Every Eq. 10 reconstruction of a faulted run recomputed on the CPU's
    plain route from the run's own inputs: each within KERNEL_TOL of the
    card's. Returns (max |err|, the protocol points it covered)."""
    err, points = 0.0, []
    for rec in res.diagnostics.get("fault_reconstruct", []):
        est = rec["estimate"]
        check(est.is_cuda, f"{what}: a reconstruction ran off the card")
        cpu = [rec[k].cpu() for k in ("query", "keys", "values")]
        want = estimator.sdpa_transform_batched(*(t[None] for t in cpu))[0]
        check(bool(torch.isfinite(est).all()), f"{what}: a reconstruction is not finite")
        err = max(err, (est.cpu() - want).abs().max().item())
        points.append(rec["point"])
    check(err <= KERNEL_TOL, f"{what}: reconstruction vs plain max|err| {err} > {KERNEL_TOL}")
    return err, points


def _fault_run(runner, name: str, seed: int, protocol: str) -> tuple:
    """One fault/* run of ``protocol`` on the card at the member's sizes and
    budgets (few-shot's client epochs cut FAULT_FEW_EPOCH_CUT-fold), held to
    FAULT_LEDGERS, a finite metric, its survivors (K − 1 under a dropout,
    else K) and its reconstructions. Returns (the result,
    the Eq. 10 launches it should have made, its wall seconds)."""
    bundle = scenarios.build(name, seed=seed, device="cuda")
    spec, split = bundle.spec, bundle.split
    cfg = _cut_cfg(spec, FAULT_FEW_EPOCH_CUT) if protocol == "few-shot" else _budget_cfg(spec)
    t0 = time.perf_counter()
    res = runner(seed, split, bundle.extractors, bundle.ssl_cfgs, cfg, device="cuda", fault=spec.fault)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    what = f"faults {name} {protocol} seed {seed}"
    got = (res.ledger.total_bytes(), res.ledger.comm_times())
    want = FAULT_LEDGERS[name][protocol]
    check(got == want, f"{what}: (bytes, comm times) {got}, not {want}")
    check(math.isfinite(res.metric), f"{what}: {res.metric_name} {res.metric}")
    d = res.diagnostics
    k = spec.num_parties
    survived = d.get("parties_survived", k)
    check(survived == (k - 1 if "/dropout-" in name else k), f"{what}: {survived} parties survived")
    check((spec.fault is None) == ("fault_kind" not in d), f"{what}: fault diagnostics")
    pools = [u.shape[0] for u in split.unaligned]
    launches = fault_launches(spec.fault, k, pools, protocol == "few-shot")
    eq10 = launches - (sum(1 for n in pools if n > 0) if protocol == "few-shot" else 0)
    got_eq10 = len(d.get("fault_reconstruct", []))
    check(got_eq10 == eq10, f"{what}: {got_eq10} reconstructions, expected {eq10}")
    return res, launches, wall, split


def phase_faults(line: str) -> dict:
    """The fault/* family on the card through ``scenarios.build(...,
    device="cuda")`` and the runners' ``fault`` argument: one-shot on every
    member at FAULT_SEEDS (the reference gate's rule on the means), few-shot
    on every member at seed 0 (its Δ against the fault-free twin), and
    SplitNN, FedBCD and FedCVT on FAULT_ITERATIVE at the members' 200
    iterations (retry bytes in the ledger). Every ledger equals
    FAULT_LEDGERS and every Eq. 10 reconstruction its CPU plain-route
    recomputation. Returns the kernel launches the phase should have made
    and its rows."""
    with open(FAULT_GATE_FILE) as f:
        gate = json.load(f)["fault_families"]["fault"]
    check(gate["baseline_scenario"] == FAULT_BASELINE, f"fault gate baseline {gate}")
    check(sorted(gate["required"]) == sorted(FAULT_NAMES), f"fault gate members {gate['required']}")
    max_drop = gate["max_oneshot_drop"]
    out = {"sdpa": 0, "kmeans": 0, "one_shot": {}, "few_shot": {}, "iterative": [], "points": set()}
    out.update(splits={}, one_shot_wall=0.0, few_shot_wall=0.0, gate={})
    recon_err = 0.0
    for name in FAULT_NAMES:
        metrics, walls = [], []
        for seed in FAULT_SEEDS:
            res, launches, wall, split = _fault_run(run_one_shot, name, seed, "one-shot")
            out["splits"][name, seed] = split
            out["one_shot_wall"] += wall
            err, points = check_reconstructions(res, f"{name} one-shot seed {seed}")
            recon_err = max(recon_err, err)
            out["points"].update(points)
            out["sdpa"] += launches
            out["kmeans"] += res.cfg.kmeans_iters + 2
            metrics.append(res.metric)
            walls.append(wall)
        out["one_shot"][name] = metrics
        d = res.diagnostics
        print(
            f"[faults] {name} one-shot: {res.metric_name} over seeds {FAULT_SEEDS[0]}-"
            f"{FAULT_SEEDS[-1]} {_rates(metrics)}, mean {sum(metrics) / len(metrics):.4f} | "
            f"{res.ledger.total_bytes()} bytes in {res.ledger.comm_times()} comm times (expected "
            f"{FAULT_LEDGERS[name]['one-shot']}) | survived {d.get('parties_survived', 4)} | "
            f"{d.get('fault_kind', 'none')} {d.get('fault_stage', '')} | ④ "
            f"{d['step_ms']['4_local_ssl'] / sum(d['ssl_steps']):.3f} ms a step | wall "
            f"{sum(walls) / len(walls):.2f} s a run"
        )
    none_mean = sum(out["one_shot"][FAULT_BASELINE]) / len(FAULT_SEEDS)
    check(none_mean > FAULT_NONE_BAR, f"{FAULT_BASELINE} one-shot mean {none_mean} not above 0.6")
    for name, metrics in out["one_shot"].items():
        mean = sum(metrics) / len(metrics)
        check(
            mean >= none_mean - max_drop,
            f"{name} one-shot mean {mean} below {FAULT_BASELINE}'s {none_mean} - {max_drop}",
        )
        out["gate"][name] = mean >= none_mean - max_drop
        print(
            f"[faults] gate {name}: one-shot mean {mean:.4f}, Δ {mean - none_mean:+.4f} against "
            f"{FAULT_BASELINE}'s {none_mean:.4f} (floor -{max_drop}, {os.path.relpath(FAULT_GATE_FILE, ROOT)})"
        )

    few_none = None
    for name in [FAULT_BASELINE] + [n for n in FAULT_NAMES if n != FAULT_BASELINE]:
        res, launches, wall, _ = _fault_run(run_few_shot, name, SEED, "few-shot")
        out["few_shot_wall"] += wall
        err, points = check_reconstructions(res, f"{name} few-shot")
        recon_err = max(recon_err, err)
        out["points"].update(points)
        out["sdpa"] += launches
        out["kmeans"] += res.cfg.kmeans_iters + 2
        out["few_shot"][name] = res.metric
        few_none = res.metric if name == FAULT_BASELINE else few_none
        d = res.diagnostics
        steps5 = sum(d["fewshot_ssl_steps"])
        print(
            f"[faults] {name} few-shot seed {SEED}: {res.metric_name} {res.metric:.4f} (Δ "
            f"{res.metric - few_none:+.4f} against {FAULT_BASELINE}'s; its one-shot pass "
            f"{d['one_shot_metric']:.4f}) | {res.ledger.total_bytes()} bytes in "
            f"{res.ledger.comm_times()} comm times (expected {FAULT_LEDGERS[name]['few-shot']}) | "
            f"take {_rates(d['fewshot_take_rate'])} | Eq. 10 launches {launches} | ⑤' "
            f"{d['step_ms']['5p_local_ssl'] / steps5:.3f} ms a step ({steps5} steps) | wall "
            f"{wall:.2f} s"
        )
    # ⑤ (POINT_UPLOAD2 = 2), ⑥' (POINT_ROUND2 = 3) and the evaluation (4)
    check(out["points"] >= {2, 3, 4}, f"reconstructions at points {sorted(out['points'])}")
    print(
        f"[faults] Eq. 10 reconstructions at ⑤, ⑥' and the evaluation vs the CPU's plain route: "
        f"max|err| {recon_err:.3e} (tolerance {KERNEL_TOL})"
    )

    for name in FAULT_ITERATIVE:
        bundle = scenarios.build(name, seed=SEED, device="cuda")
        spec = bundle.spec
        it = baselines.IterativeConfig(iterations=spec.budget("iterations", 300))
        for method, runner in BASELINE_RUNNERS:
            t0 = time.perf_counter()
            res = runner(
                SEED, bundle.split, bundle.extractors, bundle.ssl_cfgs, it, device="cuda",
                fault=spec.fault,
            )
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            what = f"faults {name} {method}"
            d = res.diagnostics
            got = (res.ledger.total_bytes(), res.ledger.comm_times())
            check(got == FAULT_LEDGERS[name][method], f"{what}: (bytes, comm times) {got}")
            check(bool(torch.isfinite(d["losses"]).all()), f"{what}: a loss is not finite")
            check(math.isfinite(res.metric), f"{what}: {res.metric_name} {res.metric}")
            tags = res.ledger.by_tag()
            retry = sum(tags.get(t, (0, 0))[1] for t in ("retry_reps", "retry_timeout"))
            if spec.fault is not None:
                check(d["parties_survived"] == 3, f"{what}: {d['parties_survived']} survived")
                check(d["fault_modeled"] is True, f"{what}: the dropout was not modeled")
                check(retry == d["fault_retry_bytes"] > 0, f"{what}: retry bytes {retry}")
            else:
                check(retry == 0 and "fault_kind" not in d, f"{what}: fault-free run")
            out["iterative"].append({"scenario": name, "method": method, "metric": res.metric,
                                     "bytes": got[0], "comm_times": got[1],
                                     "retry_bytes": retry, "wall_s": wall})
            print(
                f"[faults] {name} {method}: {res.metric_name} {res.metric:.4f} | {got[0]} bytes in "
                f"{got[1]} comm times (expected {FAULT_LEDGERS[name][method]}), retry bytes "
                f"{retry} | survived {d.get('parties_survived', spec.num_parties)} | wall {wall:.2f} s"
            )
    print(json.dumps({
        "faults": {
            "one_shot": out["one_shot"],
            "few_shot": out["few_shot"],
            "iterative": out["iterative"],
            "reconstruct_max_abs_err": recon_err,
            "card": line,
        }
    }))
    return out


def fold_eq10_launches(faults: list, pools: list, num_parties: int, few_shot: bool) -> int:
    """The Eq. 10 launches of one folded group (``faults``: one FaultSpec or
    None an entry), as ``core.protocol`` makes them: at ⑤ (and few-shot's
    ⑥') one launch a distinct (dropped party, anchor) pair over all the
    entries that drop it (``faults.reconstruct_dropped_seeds``), at each
    evaluation one a dropping entry; few-shot's ③' one launch a party with a
    non-empty pool over the stacked entries (``estimate_missing_batched``)."""

    def pairs(point: int) -> int:
        seen = set()
        for fa in faults:
            if fa is None or fa.kind != "dropout":
                continue
            alive = [k for k in range(num_parties) if not fa.drops(k, point)]
            seen.update((k, alive[0]) for k in range(num_parties) if fa.drops(k, point))
        return len(seen)

    evals = sum(1 for fa in faults if fa is not None and fa.drops(fa.party, 4))  # POINT_EVAL
    one_shot = pairs(2) + evals  # POINT_UPLOAD2, then the evaluation
    if not few_shot:
        return one_shot
    return one_shot + sum(1 for n in pools if n > 0) + pairs(3) + evals  # ③', POINT_ROUND2


def _fold_group(runner, seeds: list, flt: dict, cfg) -> tuple:
    """The fault family through ONE ``run_scenarios_seeds`` call at ``seeds``,
    on the [faults] phase's own splits (rebuilt, and held bit-equal to
    them). Returns (the C×S results, wall seconds, the faults)."""
    grid = []
    for name in FAULT_NAMES:
        row = []
        for seed in seeds:
            bundle = scenarios.build(name, seed=seed, device="cuda")
            loop_split = flt["splits"].get((name, seed))
            if loop_split is not None:
                for a, b in zip(_split_tensors(bundle.split), _split_tensors(loop_split)):
                    check(torch.equal(a, b), f"folds: {name} seed {seed} split is not [faults]'")
            row.append(bundle)
        grid.append(row)
    faults = [[b.spec.fault for b in row] for row in grid]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_scenarios_seeds(
        runner,
        [list(seeds) for _ in grid],
        [[b.split for b in row] for row in grid],
        [[b.extractors for b in row] for row in grid],
        [[b.ssl_cfgs for b in row] for row in grid],
        cfg,
        device="cuda",
        faults=faults,
    )
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, [f for row in faults for f in row]


def _split_tensors(split) -> list:
    return [*split.aligned, *split.unaligned, *split.test_aligned, split.labels, split.test_labels]


def _fold_row_checks(res, name: str, protocol: str, seed_fold: int, what: str) -> None:
    """A folded fault-family run: FAULT_LEDGERS, finite, its survivors, and
    the fold record of the whole group."""
    got = (res.ledger.total_bytes(), res.ledger.comm_times())
    check(got == FAULT_LEDGERS[name][protocol], f"{what}: (bytes, comm times) {got}")
    check(math.isfinite(res.metric), f"{what}: {res.metric_name} {res.metric}")
    d = res.diagnostics
    k = 4
    check(d["parties_survived"] == (k - 1 if "/dropout-" in name else k), f"{what}: survivors")
    folds = (d["engine_path"], d["seed_fold"], d["scenario_fold"], d["kernel_fold"])
    want = ("vmap", seed_fold, len(FAULT_NAMES), seed_fold * len(FAULT_NAMES) * k)
    check(folds == want, f"{what}: (engine_path, seed_fold, scenario_fold, kernel_fold) {folds}")


def _param_contrast(cfg) -> tuple:
    """The one-shot group's first FOLD_PARAM_STEPS ④ steps, stacked and by
    the one-party loop (``engine_mode="python"``), on the card from the same
    draws: every entry's parameters after them, max |Δ| over the largest
    |parameter|. Returns (that ratio, the Eq. 10 launches the two runs
    made)."""
    short = dataclasses.replace(cfg, client_epochs=FOLD_PARAM_STEPS)  # one 32-row step an epoch
    runs = {}
    for mode in ("vmap", "python"):
        res, _, faults = _fold_group(
            run_one_shot, list(FAULT_SEEDS), {"splits": {}}, dataclasses.replace(short, engine_mode=mode)
        )
        check(res[0][0].diagnostics["ssl_steps"] == [FOLD_PARAM_STEPS] * 4, "folds: contrast steps")
        runs[mode] = [
            p.detach() for row in res for r in row for c in r.clients
            for p in (*c.extractor.parameters(), *c.head.parameters())
        ]
    err = max((a - b).abs().max().item() for a, b in zip(runs["vmap"], runs["python"]))
    scale = max(p.abs().max().item() for p in runs["python"])
    return err / scale, 2 * fold_eq10_launches(faults, [], 4, False)


def phase_folds(line: str, flt: dict) -> dict:
    """The folds on the card: the fault family as one folded group a
    protocol (one-shot at FAULT_SEEDS, few-shot at seed 0) on [faults]' own
    splits, held to its ledgers, gate outcomes and metrics; the stacked ④
    steps against the one-party loop; the baselines' folds
    (:func:`phase_iterative_folds`); and ``benchmarks/torch_frontier.py``'s
    group runner and gate on FOLD_FRONTIER at FOLD_FRONTIER_SEEDS. Returns
    the launches the phase should have made."""
    from benchmarks import torch_frontier

    spec = scenarios.get(FAULT_BASELINE)
    cfg = _budget_cfg(spec)
    out = {"sdpa": 0, "kmeans": 0}
    km_run = cfg.kmeans_iters + 2  # one search a fold: Lloyd iterations, inertia, final

    # one-shot: C 9 × S 4 × K 4 in one fold
    res, wall, faults = _fold_group(run_one_shot, list(FAULT_SEEDS), flt, cfg)
    pools = [u.shape[0] for u in flt["splits"][FAULT_BASELINE, 0].unaligned]
    eq10 = fold_eq10_launches(faults, pools, 4, False)
    out["sdpa"] += eq10
    out["kmeans"] += km_run
    deltas, gate = [], {}
    recon_err = 0.0
    for name, row in zip(FAULT_NAMES, res):
        for seed, r in zip(FAULT_SEEDS, row):
            what = f"folds {name} one-shot seed {seed}"
            _fold_row_checks(r, name, "one-shot", len(FAULT_SEEDS), what)
            deltas.append(abs(r.metric - flt["one_shot"][name][seed]))
            recon_err = max(recon_err, check_reconstructions(r, what)[0])
        gate[name] = sum(r.metric for r in row) / len(row)
    none_mean = gate[FAULT_BASELINE]
    with open(FAULT_GATE_FILE) as f:
        max_drop = json.load(f)["fault_families"]["fault"]["max_oneshot_drop"]
    outcomes = {name: mean >= none_mean - max_drop for name, mean in gate.items()}
    check(outcomes == flt["gate"], f"folds: gate outcomes {outcomes}, the loop's {flt['gate']}")
    check(max(deltas) <= FOLD_METRIC_TOL, f"folds: one-shot metric vs the loop max|Δ| {max(deltas)}")
    d = res[0][0].diagnostics
    steps = sum(d["ssl_steps"])
    print(
        f"[folds] fault family one-shot: ONE run_scenarios_seeds group of {len(FAULT_NAMES)} "
        f"scenarios × {len(FAULT_SEEDS)} seeds × 4 parties ({len(faults) * 4} stacked entries) | "
        f"engine_path {d['engine_path']}, seed_fold {d['seed_fold']}, scenario_fold "
        f"{d['scenario_fold']}, kernel_fold {d['kernel_fold']} | ledgers = FAULT_LEDGERS | gate "
        f"outcomes = the loop's ({sum(outcomes.values())}/{len(outcomes)} pass; "
        f"{FAULT_BASELINE} mean {none_mean:.4f}) | AUC vs the loop max|Δ| {max(deltas):.4f} "
        f"(tolerance {FOLD_METRIC_TOL}) | reconstructions vs plain max|err| {recon_err:.3e} | "
        f"fold wall {wall:.2f} s against the loop's {flt['one_shot_wall']:.2f} s | ④ "
        f"{d['step_ms']['4_local_ssl'] / (steps // 4):.3f} ms a stacked step | kmeans launches "
        f"{km_run}, Eq. 10 launches {eq10}"
    )

    # few-shot: C 9 × S 1 (its ⑤' draws are made before the stacked session:
    # the peak device memory over the fold measures them)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res, wall_few, faults = _fold_group(run_few_shot, [SEED], flt, _cut_cfg(spec, FAULT_FEW_EPOCH_CUT))
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    eq10_few = fold_eq10_launches(faults, pools, 4, True)
    out["sdpa"] += eq10_few
    out["kmeans"] += km_run
    deltas_few = []
    for name, row in zip(FAULT_NAMES, res):
        r = row[0]
        what = f"folds {name} few-shot seed {SEED}"
        _fold_row_checks(r, name, "few-shot", 1, what)
        check(r.diagnostics["sdpa_fold"] == len(FAULT_NAMES), f"{what}: sdpa_fold")
        deltas_few.append(abs(r.metric - flt["few_shot"][name]))
        recon_err = max(recon_err, check_reconstructions(r, what)[0])
    check(max(deltas_few) <= FOLD_METRIC_TOL, f"folds: few-shot vs the loop max|Δ| {max(deltas_few)}")
    d = res[0][0].diagnostics
    steps5 = d["fewshot_ssl_steps"][0]
    print(
        f"[folds] fault family few-shot: ONE group of {len(FAULT_NAMES)} scenarios × 1 seed × 4 "
        f"parties | sdpa_fold {d['sdpa_fold']}, kernel_fold {d['kernel_fold']} | ledgers = "
        f"FAULT_LEDGERS | AUC vs the loop max|Δ| {max(deltas_few):.4f} | fold wall {wall_few:.2f} "
        f"s against the loop's {flt['few_shot_wall']:.2f} s | ⑤' {d['step_ms']['5p_local_ssl'] / steps5:.3f} "
        f"ms a stacked step ({steps5} steps of {len(FAULT_NAMES) * 4} entries) | peak device "
        f"memory over the fold {peak_gb:.3f} GB above its start | kmeans launches "
        f"{km_run}, Eq. 10 launches {eq10_few} (③' {sum(1 for n in pools if n > 0)} of width "
        f"{len(FAULT_NAMES) * 3})"
    )

    ratio, eq10_contrast = _param_contrast(cfg)
    out["sdpa"] += eq10_contrast
    out["kmeans"] += 2 * km_run
    check(ratio <= LOGIT_RTOL, f"folds: stacked vs one-party ④ parameters {ratio} > {LOGIT_RTOL}")
    print(
        f"[folds] stacked ④ vs the one-party loop on the card after {FOLD_PARAM_STEPS} steps, "
        f"all {len(FAULT_NAMES) * len(FAULT_SEEDS) * 4} entries: max|Δ| / max|param| {ratio:.3e} "
        f"(tolerance {LOGIT_RTOL})"
    )

    t_it = time.perf_counter()
    iter_rows = phase_iterative_folds(flt)
    iterative_s = time.perf_counter() - t_it

    # the frontier: the reference's methods, sizes, budgets and gate
    seeds = list(FOLD_FRONTIER_SEEDS)
    rows = []
    t0 = time.perf_counter()
    for name in FOLD_FRONTIER:
        bundles = torch_frontier.build_bundles(scenarios.get(name), seeds, False, "cuda")
        rows += torch_frontier.run_scenario_group([bundles], seeds, torch_frontier.METHODS, "cuda")
        out["kmeans"] += 2 * km_run  # one-shot and few-shot: one search each
        out["sdpa"] += sum(1 for u in bundles[0].split.unaligned if u.shape[0] > 0)  # ③'
    frontier_s = time.perf_counter() - t0
    for r in rows:  # the few-shot runs the catalog leaves to the frontier
        if r.get("aggregate") or r["method"] != "few_shot" or r["scenario"] not in CATALOG_ONE_SHOT_ONLY:
            continue
        what = f"folds: frontier {r['scenario']} few-shot seed {r['seed']}"
        got = (r["comm_bytes"], r["comm_times"])
        check(got == (CATALOG_LEDGERS[r["scenario"]][1], 5), f"{what}: (bytes, comm times) {got}")
        if r["seed"] == SEED:
            bar = CATALOG_BARS[r["metric_name"]]
            check(r["metric"] > bar, f"{what}: {r['metric_name']} {r['metric']} not above {bar}")
    problems = torch_frontier.check_gate(rows)
    reported = [p for p in problems if gate_miss_reported(p)]
    for p in problems:
        print(f"[folds] GATE VIOLATION{' (reported, PERF.md §6)' if p in reported else ''}: {p}")
    check(len(reported) == len(problems), f"folds: the frontier gate failed: {problems}")
    aggs = [r for r in rows if r.get("aggregate")]
    for r in aggs:
        print(
            f"[folds] frontier {r['scenario']} {r['method']}: {r['metric_name']} mean "
            f"{r['metric_mean']:.4f} ± {r['metric_std']:.4f} [{r['metric_min']:.4f}, "
            f"{r['metric_max']:.4f}] over seeds {seeds[0]}-{seeds[-1]} | {r['comm_bytes']} bytes "
            f"in {r['comm_times']} comm times | path {r.get('engine_path', 'mixed')}, seed_fold "
            f"{r['seed_fold']} | wall {r['wall_s']:.2f} s"
        )
    print(
        f"[folds] gate: {', '.join(FOLD_FRONTIER)} at seeds {seeds[0]}-{seeds[-1]} against "
        f"benchmarks/frontier_baseline.json: {len(problems)} violation(s), "
        f"{len(reported)} of them the reported one ({FOLD_GATE_REPORTED[0]} "
        f"{FOLD_GATE_REPORTED[1]} >= {FOLD_GATE_REPORTED[2]:+.2f}); every other rule holds "
        f"| {frontier_s:.1f} s"
    )
    print(json.dumps({"folds": {"frontier": aggs, "gate": problems, "iterative": iter_rows,
                                "card": line}}))
    out.update(one_shot_wall=wall, few_shot_wall=wall_few, frontier_s=frontier_s,
               iterative_s=iterative_s)
    return out


def _mesh_leaves(res) -> list:
    """Every trained leaf of a protocol result: the parties' extractors and
    heads, the joint classifier and few-shot's aux classifiers."""
    mods = [m for c in res.clients for m in (c.extractor, c.head)] + [res.server.classifier]
    return [p.detach() for m in mods + list(res.server.aux_classifiers) for p in m.parameters()]


def phase_mesh(line: str) -> dict:
    """The batch mesh on the card, every row on ``hard/overlap-32``
    unsharded and on ``BatchMesh((cuda:0, cuda:0))``, whose slots share the
    card and still run the padded, split, per-slot and gathered path:
    one-shot at its budget and few-shot at few-shot A's over MESH_SEEDS
    (``ProtocolConfig.mesh``); SplitNN, FedBCD and FedCVT at [baselines A]'s
    400 iterations over MESH_SEEDS, stacked (``IterativeConfig.mesh``); and
    few-shot + finetune at finetune A's budget over MESH_FINETUNE_SEEDS, its
    finetune session stacked on the protocol's mesh. Each sharded run's
    metric, losses and every leaf within MESH_TOL of the unsharded one's,
    equal ledgers, ``device_fold`` 2 and 1 on the stacked path, and each
    run's ``kmeans`` and ``sdpa_estimator`` launches exact: one a slot per
    assignment and per estimate, none from a baseline or the finetune
    session. Returns the launches the phase made and the rows' walls."""
    spec = scenarios.HARD_OVERLAP_32
    seeds = list(MESH_SEEDS)
    ft_seeds = list(MESH_FINETUNE_SEEDS)
    bundles = {s: scenarios.build(spec, seed=s, device="cuda") for s in sorted({*seeds, *ft_seeds})}
    cfg = _budget_cfg(spec)
    it_cfg = baselines.IterativeConfig(iterations=spec.budget("iterations", 300), engine_mode="vmap")
    few_cfg = _cut_cfg(spec, A_FEW_EPOCH_CUT)
    card = torch.device("cuda", 0)
    mesh = BatchMesh((card, card))
    km_run = cfg.kmeans_iters + 2  # one search a pass: Lloyd iterations, inertia, final
    eq10 = sum(1 for u in bundles[0].split.unaligned if u.shape[0] > 0)  # ③': one a party
    rows = [  # (row, runner, seeds, config, (kmeans, sdpa_estimator) launches a slot, kwargs)
        ("one-shot", run_one_shot, seeds, cfg, (km_run, 0), {}),
        ("few-shot", run_few_shot, seeds, few_cfg, (km_run, eq10), {}),
        *((name, fn, seeds, it_cfg, (0, 0), {}) for name, fn in BASELINE_RUNNERS),
        ("few-shot + finetune", run_few_shot_finetune, ft_seeds, few_cfg, (km_run, eq10),
         {"finetune_iterations": FINETUNE_ITERATIONS}),
    ]
    out = {"sdpa": 0, "kmeans": 0, "walls": {}, "launches": {}}
    worst = 0.0
    for row, runner, row_seeds, row_cfg, per_slot, kw in rows:
        runs = {}
        for slots, run_cfg in ((1, row_cfg), (2, dataclasses.replace(row_cfg, mesh=mesh))):
            what = f"mesh {row} on {slots} slot(s)"
            torch.cuda.synchronize()
            km0, sd0 = kops.LAUNCHES, ops.LAUNCHES
            t0 = time.perf_counter()
            res = run_seeds(
                runner, row_seeds, [bundles[s].split for s in row_seeds],
                [bundles[s].extractors for s in row_seeds], [bundles[s].ssl_cfgs for s in row_seeds],
                run_cfg, device="cuda", **kw,
            )
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = (kops.LAUNCHES - km0, ops.LAUNCHES - sd0)
            want = (slots * per_slot[0], slots * per_slot[1])
            check(got == want, f"{what}: (kmeans, sdpa_estimator) launches {got}, not {want}")
            folds = {(r.diagnostics["device_fold"], r.diagnostics["engine_path"]) for r in res}
            check(folds == {(slots, "vmap")}, f"{what}: (device_fold, engine_path) {folds}")
            if kw:  # the finetune session: stacked, on the protocol's mesh
                ft = {(r.diagnostics["finetune_device_fold"], r.diagnostics["finetune_engine_path"])
                      for r in res}
                check(ft == {(slots, "vmap")}, f"{what}: the finetune's (device_fold, engine_path) {ft}")
            check(all(math.isfinite(r.metric) for r in res), f"{what}: metrics {[r.metric for r in res]}")
            out["sdpa"] += got[1]
            out["kmeans"] += got[0]
            out["walls"][f"{row} {slots}"] = wall
            out["launches"][f"{row} {slots}"] = got
            runs[slots] = res
        err = 0.0
        for seed, a, b in zip(row_seeds, runs[2], runs[1]):
            what = f"mesh {row} seed {seed}"
            for key in ("total_bytes", "comm_times", "by_tag"):
                ka, kb = getattr(a.ledger, key)(), getattr(b.ledger, key)()
                check(ka == kb, f"{what}: ledger {key} {ka} sharded, {kb} unsharded")
            la, lb = _mesh_leaves(a), _mesh_leaves(b)
            if "losses" in b.diagnostics:
                la, lb = la + [a.diagnostics["losses"]], lb + [b.diagnostics["losses"]]
            check(len(la) == len(lb), f"{what}: {len(la)} leaves against {len(lb)}")
            e = max([abs(a.metric - b.metric)] + [(p - q).abs().max().item() for p, q in zip(la, lb)])
            check(e <= MESH_TOL, f"{what}: sharded vs unsharded max|Δ| {e} > {MESH_TOL}")
            err = max(err, e)
        worst = max(worst, err)
        a, b = runs[2][0], runs[1][0]
        sharded, single = out["launches"][f"{row} 2"], out["launches"][f"{row} 1"]
        print(
            f"[mesh] {spec.name} {row}, seeds {row_seeds[0]}-{row_seeds[-1]}: {a.metric_name} "
            f"{[round(r.metric, 4) for r in runs[2]]} | 2 slots of {card} ≡ unsharded: max|Δ| "
            f"{err:.3e} on the metric, every leaf{' and loss' if 'losses' in b.diagnostics else ''} "
            f"(bound {MESH_TOL}), ledgers equal ({a.ledger.total_bytes()} bytes in "
            f"{a.ledger.comm_times()} comm times) | device_fold {a.diagnostics['device_fold']} / "
            f"{b.diagnostics['device_fold']} | (kmeans, sdpa_estimator) launches {sharded} / "
            f"{single} | wall {out['walls'][row + ' 2']:.2f} s sharded, "
            f"{out['walls'][row + ' 1']:.2f} s unsharded"
        )
    iterative = [row for row, *_ in rows[2:]]
    out["iterative_s"] = sum(out["walls"][f"{row} {n}"] for row in iterative for n in (1, 2))
    print(
        f"[mesh] {torch.cuda.device_count()} visible card(s); the mesh's 2 slots share {card} "
        f"(the cost of the slots, not a speed-up) | largest sharded vs unsharded difference "
        f"{worst:.3e} | the iterative rows ({', '.join(iterative)}) {out['iterative_s']:.1f} s "
        f"(budget {MESH_ITERATIVE_BUDGET_S} s) | {line}"
    )
    out["max_err"] = worst
    return out


def _params_of(results) -> list:
    """Every trained leaf of a C×S grid of baseline results."""
    return [
        p.detach() for row in results for r in row
        for m in (*(c.extractor for c in r.clients), r.server.classifier) for p in m.parameters()
    ]


def phase_iterative_folds(flt: dict) -> list:
    """SplitNN, FedBCD and FedCVT on the fault family as one folded group
    each (FAULT_NAMES × FAULT_SEEDS, [faults]' own splits) at the members'
    200 iterations, held to FAULT_LEDGERS, the fault model's survivors and
    [faults]' loop metrics; then each method's first ITER_CONTRAST_ITERATIONS
    iterations stacked and by the per-entry loop. No kernel launches.
    Returns the rows."""
    spec = scenarios.get(FAULT_BASELINE)
    it = baselines.IterativeConfig(iterations=spec.budget("iterations", 300))
    loop = {(r["scenario"], r["method"]): r for r in flt["iterative"]}
    rows = []
    before = (ops.LAUNCHES, kops.LAUNCHES)
    for method, runner in BASELINE_RUNNERS:
        res, wall, _ = _fold_group(runner, list(FAULT_SEEDS), flt, it)
        deltas = []
        for name, row in zip(FAULT_NAMES, res):
            fault = scenarios.get(name).fault
            for seed, r in zip(FAULT_SEEDS, row):
                what = f"folds {name} {method} seed {seed}"
                d = r.diagnostics
                got = (r.ledger.total_bytes(), r.ledger.comm_times())
                check(got == FAULT_LEDGERS[name][method], f"{what}: (bytes, comm times) {got}")
                check(bool(torch.isfinite(d["losses"]).all()), f"{what}: a loss is not finite")
                check(math.isfinite(r.metric), f"{what}: {r.metric_name} {r.metric}")
                folds = (d["engine_path"], d["seed_fold"], d["scenario_fold"])
                check(folds == ("vmap", len(FAULT_SEEDS), len(FAULT_NAMES)), f"{what}: folds {folds}")
                if fault is None:
                    check("fault_kind" not in d, f"{what}: fault diagnostics on the fault-free twin")
                elif fault.kind == "dropout":
                    check(d["parties_survived"] == 3 and d["fault_modeled"] is True,
                          f"{what}: survivors {d['parties_survived']}, modeled {d['fault_modeled']}")
                else:  # the synchronous round loop has no model of it
                    check(d["fault_modeled"] is False and d["parties_survived"] == 4,
                          f"{what}: fault_modeled {d['fault_modeled']}")
                if seed == SEED and (name, method) in loop:
                    deltas.append(abs(r.metric - loop[name, method]["metric"]))
        check(len(deltas) == len(FAULT_ITERATIVE), f"folds {method}: {len(deltas)} loop entries")
        check(max(deltas) <= FOLD_METRIC_TOL, f"folds {method}: vs the loop max|Δ| {max(deltas)}")
        d = res[0][0].diagnostics
        steps = d["losses"].shape[0]
        loop_wall = sum(loop[n, method]["wall_s"] for n in FAULT_ITERATIVE)
        entries = len(FAULT_NAMES) * len(FAULT_SEEDS)
        row = {"method": method, "entries": entries, "steps": steps, "fold_wall_s": wall,
               "stacked_step_ms": d["step_ms"]["session"] / steps, "loop_entries": len(deltas),
               "loop_wall_s": loop_wall, "max_abs_delta": max(deltas)}
        rows.append(row)
        print(
            f"[folds] fault family {method}: ONE run_scenarios_seeds group of {len(FAULT_NAMES)} "
            f"scenarios × {len(FAULT_SEEDS)} seeds ({entries} entries of one stacked session, "
            f"{steps} {'rounds of Q = 5' if method == 'fedbcd' else 'iterations'}) | engine_path "
            f"{d['engine_path']}, seed_fold {d['seed_fold']}, scenario_fold {d['scenario_fold']} | "
            f"ledgers = FAULT_LEDGERS (retry rounds included) | {FAULT_ITERATIVE[0]} and the "
            f"dropouts at seed {SEED} vs [faults]' loop max|Δ| {max(deltas):.4f} (tolerance "
            f"{FOLD_METRIC_TOL}) | fold wall {wall:.2f} s for {entries} entries ({wall / entries:.3f} "
            f"s an entry) against the loop's {loop_wall:.2f} s for {len(deltas)} "
            f"({loop_wall / len(deltas):.3f} s an entry) | {row['stacked_step_ms']:.3f} ms a "
            f"stacked {'round' if method == 'fedbcd' else 'step'}"
        )
    for method, runner in BASELINE_RUNNERS:
        short = dataclasses.replace(it, iterations=ITER_CONTRAST_ITERATIONS)
        runs = {}
        for mode in ("vmap", "python"):
            res, _, _ = _fold_group(runner, list(FAULT_SEEDS), {"splits": {}},
                                    dataclasses.replace(short, engine_mode=mode))
            check(res[0][0].diagnostics["engine_path"] == mode, f"folds {method}: {mode} path")
            runs[mode] = _params_of(res)
        err = max((a - b).abs().max().item() for a, b in zip(runs["vmap"], runs["python"]))
        scale = max(p.abs().max().item() for p in runs["python"])
        check(err / scale <= LOGIT_RTOL, f"folds {method}: stacked vs loop {err / scale} > {LOGIT_RTOL}")
        rows.append({"method": method, "contrast_iterations": ITER_CONTRAST_ITERATIONS,
                     "max_abs_over_max_param": err / scale})
        print(
            f"[folds] {method} stacked vs the per-entry loop on the card after "
            f"{ITER_CONTRAST_ITERATIONS} iterations, all {len(FAULT_NAMES) * len(FAULT_SEEDS)} "
            f"entries: max|Δ| / max|param| {err / scale:.3e} (tolerance {LOGIT_RTOL})"
        )
    launched = (ops.LAUNCHES - before[0], kops.LAUNCHES - before[1])
    check(launched == (0, 0), f"folds: the iterative baselines launched kernels {launched}")
    return rows


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
        f"[serve] K=2 halves (32,16,3) CNN 32/64/128 x2 rep 128 -> 10 classes ({art.scenario}), "
        f"capacity {CAPACITY}: {len(reqs)} requests, {s['rows']} rows in {s['batches']} "
        f"batches: p50 {s['p50_ms']:.3f} ms p99 {s['p99_ms']:.3f} ms "
        f"{s['rows_per_s']:.0f} rows/s | batched vs unbatched max rel diff {worst:.2e} | {line}"
    )


def phase_partial(art, gen, queries: int, line: str) -> int:
    """Partial-party queries, each held against the plain route; returns
    the number of kernel launches they should have made: one a query (its
    K−1 Eq. 10 estimates fused)."""
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


def phase_deploy(arts: dict, gen, line: str) -> int:
    """Each artifact of ``arts`` (name → artifact: B, A, the patches) saved
    by the port and loaded back on the card, the reloaded one served
    through the fused engine (module docstring, 11a); returns the
    ``sdpa_estimator`` launches B's partial-party queries should have made:
    one a query."""
    from benchmarks import torch_serving

    loaded = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, art in arts.items():
            t0 = time.perf_counter()
            path = save_artifact(os.path.join(tmp, name), art)
            save_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            loaded[name] = load_artifact(os.path.join(tmp, name), device="cuda")
            torch.cuda.synchronize()
            load_ms = (time.perf_counter() - t0) * 1e3
            xs = [torch.randn(CAPACITY, *s, generator=gen, device="cuda") for s in art.feature_shapes]
            same = torch.equal(loaded[name].predict_logits(xs), art.predict_logits(xs))
            check(same, f"{name} reloaded: logits differ from the in-memory artifact's")
            print(
                f"[deploy] {name} ({art.scenario}, K={art.num_parties}) saved "
                f"({os.path.getsize(path) / 2**20:.2f} MiB, {save_ms:.1f} ms) and loaded on the "
                f"card ({load_ms:.1f} ms): logits on {CAPACITY} rows bit-identical to the "
                f"in-memory artifact's"
            )
    b = loaded["B"]
    engines = [ServingEngine(a, capacity=CAPACITY, device="cuda") for a in (b, arts["B"])]
    for k in range(b.num_parties):
        x = torch.randn(CAPACITY, *b.feature_shapes[k], generator=gen, device="cuda")
        got, mem = (e.predict_logits_partial(x, k) for e in engines)
        check(torch.equal(got, mem), f"B reloaded: party {k}'s partial-party logits differ")
    print(f"[deploy] B reloaded: party 0's and 1's partial-party logits bit-identical | {line}")
    for name, art in loaded.items():
        rows = torch_serving.bench_artifact(
            art, batch_sizes=DEPLOY_CAPACITIES, requests=DEPLOY_REQUESTS
        )
        misses = [r["cache_misses"] for r in rows]
        paths = [serving_path(art, c) for c in DEPLOY_CAPACITIES]
        check(misses[1:] == [0] * (len(rows) - 1), f"{name}: fresh serving misses {misses}")
        print(
            f"[deploy] {name} reloaded, served through the fused engine at capacities "
            f"{list(DEPLOY_CAPACITIES)} on paths {paths}: fresh serving misses {misses} | {line}"
        )
        if name == "A":
            problems = torch_serving.check_serving_gate(rows)
            for p in problems:
                print(f"[deploy] SERVING GATE VIOLATION: {p}")
            check(not problems, f"A: {len(problems)} serving gate violation(s)")
            print(
                f"[deploy] serving gate on {art.scenario} (benchmarks/serving_baseline.json): "
                "no violation"
            )
        else:  # the CNN: held relative to the logits' scale, as [serve] holds B
            xs = [torch.randn(CAPACITY, *s, generator=gen, device="cuda") for s in art.feature_shapes]
            scale = max(1.0, art.predict_logits(xs).abs().max().item())
            worst = max(r["parity_max_abs"] for r in rows) / scale
            check(worst <= LOGIT_RTOL, f"{name}: batched vs unbatched logits differ by {worst}")
    return 2 * b.num_parties  # one a query, on each engine


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


def _f32_cache(cache: dict) -> dict:
    """A decode cache with float32 k/v (and every other float leaf), for the
    f32 activation policy."""
    return {
        k: _f32_cache(t) if isinstance(t, dict) else (t.float() if t.is_floating_point() else t)
        for k, t in cache.items()
    }


def _zoo_cfg(name: str, reduced: bool, **moe_changes):
    """The config in f32 activations; reduced phi4 with two kv heads (G = 2:
    ``reduced()`` alone gives kv heads = heads); at full width cut to
    ZOO_DEPTH layers where the full depth does not fit the card."""
    base = get_config(name).reduced() if reduced else _full_cfg(name)
    cfg = dataclasses.replace(base, activation_dtype="float32")
    if reduced and name == ZOO_ARCH:
        cfg = dataclasses.replace(cfg, num_kv_heads=2)
    if moe_changes and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_changes))
    return cfg


def _full_cfg(name: str):
    """The config at full width, cut to ZOO_DEPTH layers where it has one."""
    cfg = get_config(name)
    if name in ZOO_DEPTH:
        cfg = dataclasses.replace(cfg, num_layers=ZOO_DEPTH[name])
    return cfg


def _frames(cfg, batch: int, seed: int, rows: int = 0) -> torch.Tensor:
    """0.02·N(0, 1) ``embeds`` (B, rows or the config's prefix, d) on the
    card, the stub frontend's patch or frame rows (as ``serve.make_cache``
    draws them from the same seed)."""
    shape = (batch, rows or cfg.prefix_tokens, cfg.d_model)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return 0.02 * torch.randn(shape, generator=gen, device="cuda")


def _min_topk_margin(fn):
    """Run ``fn()`` with ``moe.route`` wrapped: returns fn's result and the
    smallest gap between a token's k-th and (k+1)-th router probability
    over every routing of the run (how near a top-k tie came)."""
    plain, margins = zoo_moe.route, []

    def recorded(params, xf, cfg, cap):
        out = plain(params, xf, cfg, cap)
        top = torch.topk(out[0], cfg.moe.top_k + 1, dim=-1).values
        margins.append((top[:, -2] - top[:, -1]).min().item())
        return out

    zoo_moe.route = recorded
    try:
        return fn(), min(margins)
    finally:
        zoo_moe.route = plain


def phase_zoo_small(name: str, tag: str, window=None) -> None:
    """A reduced config (f32 activations, ``window`` its window_override)
    served on the card and on the CPU's plain route with the same weights
    and prompt (an audio model's ``enc_out`` encoded on each from the same
    frames). The logits of every decode step are compared (greedy tokens of
    random weights repeat, so their equality alone says little), and the
    card's launches a step checked exactly. A MoE run prints its smallest
    top-k gate margin."""
    cfg = _zoo_cfg(name, reduced=True)
    want_rms, want_dec = ZOO_SMALL_LAUNCHES[name]
    model = build_model(cfg, window_override=window)
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    prompt = torch.randint(
        0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(SEED), dtype=torch.int32
    )
    frames = _frames(cfg, 2, SEED + 3) if cfg.family == "audio" else None
    outs, margins = {}, {}
    for dev, p in (("cuda", params), ("cpu", copy.deepcopy(params).cpu())):
        steps = []

        def decode(params_, cache_, batch):
            logits_, cache_ = model.decode_fn(params_, cache_, batch)
            steps.append(logits_.cpu())
            return logits_, cache_

        cache = _f32_cache(zeros_like_spec(model.cache_shapes(2, 16), dev))
        if cfg.family == "audio":  # the same frames encoded on each device
            with torch.no_grad():
                cache["enc_out"] = model_zoo._encode(p, cfg, frames.to(dev))

        def run():
            logits, cache_ = serve.prefill(decode, p, cache, prompt.to(dev))
            return serve.greedy_decode(decode, p, cache_, logits, 8, 8)[0]

        torch.cuda.synchronize()
        rops.LAUNCHES = dops.LAUNCHES = 0
        if cfg.moe is not None:
            toks, margins[dev] = _min_topk_margin(run)
        else:
            toks = run()
        torch.cuda.synchronize()
        if dev == "cuda":
            got = (rops.LAUNCHES, dops.LAUNCHES)
            check(got == (16 * want_rms, 16 * want_dec), f"reduced {name}: launches {got}")
        outs[dev] = (torch.stack(steps), toks.cpu())
    rops.LAUNCHES = dops.LAUNCHES = 0
    check(outs["cuda"][0].shape[0] == 16, f"reduced {name}: 16 decode steps")
    rel = max(_rel(c, g) for c, g in zip(outs["cuda"][0], outs["cpu"][0]))
    margin = ""
    if margins:
        margin = f"; smallest top-k gate margin card {margins['cuda']:.3e}, CPU {margins['cpu']:.3e}"
    what = f"reduced {name}{f' window {window}' if window else ''}"
    check(rel <= ZOO_RTOL, f"{what} card vs CPU logits differ by {rel}{margin}")
    check(torch.equal(outs["cuda"][1], outs["cpu"][1]), f"{what} greedy tokens differ{margin}")
    print(
        f"[{tag}] {what} ({cfg.family}, {cfg.num_layers} layers, d {cfg.d_model}"
        f"{f', G {cfg.num_heads // cfg.num_kv_heads}' if cfg.num_heads else ''}, f32): card vs CPU "
        f"plain route logits of all "
        f"16 decode steps max rel diff {rel:.2e}, greedy tokens equal {outs['cuda'][1][0].tolist()}, "
        f"launches a step {want_rms} rmsnorm / {want_dec} decode_attention{margin}"
    )
    del params, model
    torch.cuda.empty_cache()


def _counted(totals: dict, want_rms: int, want_dec: int, what: str) -> None:
    """Check one part's launches exactly, add them to the path's, and count
    the next part from 0."""
    torch.cuda.synchronize()
    got = (rops.LAUNCHES, dops.LAUNCHES)
    check(got == (want_rms, want_dec), f"{what}: launches {got}, not {want_rms, want_dec}")
    totals["rmsnorm"] += got[0]
    totals["decode_attention"] += got[1]
    rops.LAUNCHES = dops.LAUNCHES = 0


def encoder_norms(cfg) -> int:
    """RMSNorm launches of an audio model's encoder (two a block and the
    final norm), run once a prefill_fn or a serve run's enc_out; 0 for the
    other families."""
    return 2 * cfg.encoder_layers + 1 if cfg.family == "audio" else 0


def step_floor_ms(cfg, params) -> tuple:
    """The least time a decode step at batch ZOO_BATCH could take on the
    card, and what bounds it, the larger of: the f32 weights the step needs
    over the memory rate (all but the token table when the unembedding has
    its own, and but an audio model's encoder; of a MoE's routed experts
    only the min(E, B·k) that B tokens at top-k reach), and its f32
    operations (2·B a dense weight, 2·B·k/E a routed expert weight, and an
    audio model's cross-attention K and V of ``enc_out``, recomputed at
    every step) over the f32 rate. Third, for a MoE: the ms to read every
    expert, which the port's batched SwiGLU over all E does (its cost, not
    the floor); else None."""
    dense = routed = 0
    for n, p in params.named_parameters():
        if n.startswith("enc_") or (n == "embed.tok" and not cfg.tie_embeddings):
            continue
        if n.rsplit(".", 1)[-1] in ("w_gate_e", "w_up_e", "w_down_e"):
            routed += p.numel() * p.element_size()
        else:
            dense += p.numel() * p.element_size()
    e, k = (cfg.moe.num_experts, cfg.moe.top_k) if cfg.moe is not None else (1, 1)
    weights = dense + routed * min(e, ZOO_BATCH * k) / e
    ops = 2 * ZOO_BATCH * (dense + routed * k / e) / 4
    if cfg.family == "audio":
        kv = cfg.num_kv_heads * cfg.resolved_head_dim
        ops += 2 * 2 * ZOO_BATCH * cfg.prefix_tokens * cfg.d_model * kv * cfg.num_layers
    t_bytes, t_ops = weights / H100_BYTES_PER_S, ops / H100_F32_FLOPS
    every = (dense + routed) / H100_BYTES_PER_S * 1e3 if cfg.moe is not None else None
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations", every


def phase_zoo_serve(name: str, line: str, tag: str, totals: dict, window=None, keep=False):
    """A config at full width (cut to ZOO_DEPTH layers where it has one;
    ``window`` its window_override) through ``launch/serve``: the exact
    parameter count; prefill + greedy decode at batch 4, prompt 32, 16 new
    tokens, warm-up and timed (p50/p99 per token step, tokens/s, peak
    memory); prefill ≡ sequential decode in f32 activations with the
    f32-cast cache (a MoE at capacity factor 8, drop-free at prefill; an
    audio model's f32 ``enc_out``) within ZOO_RTOL, over the prompt, or
    over all 48 positions under a window (its ring wraps twice). qwen2-vl
    also runs a prefill_fn over its 1024-row patch prefix and 1024 text
    tokens. Every part's launches are checked exactly and added to
    ``totals``. Returns the config, the card's generator and, with
    ``keep``, the parameters (not freed; else None)."""
    cfg = _full_cfg(name)
    per_step = ZOO_LAUNCHES[name]
    enc_rms = encoder_norms(cfg)
    label = f"{name} window {window}" if window else name
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, window_override=window)
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    check(n_params == ZOO_PARAMS[name], f"{name}: {n_params} parameters, not {ZOO_PARAMS[name]}")
    gb = sum(p.numel() * p.element_size() for p in params.parameters()) / 1e9
    attn = "attention-free" if not cfg.num_heads else (
        f"heads {cfg.num_heads}/{cfg.num_kv_heads} x {cfg.resolved_head_dim}"
    )
    if cfg.mla is not None:
        m = cfg.mla
        attn = (
            f"MLA heads {cfg.num_heads}, kv latent {m.kv_lora_rank}, q latent {m.q_lora_rank}, "
            f"rope {m.rope_head_dim} / nope {m.nope_head_dim} / v {m.v_head_dim}"
        )
    depth = f"{cfg.num_layers} of {get_config(name).num_layers} layers" if name in ZOO_DEPTH else (
        f"{cfg.num_layers} layers"
    )
    print(
        f"[{tag}] {label} ({cfg.family}): {n_params} parameters ({gb:.2f} GB f32), {depth}"
        f"{f' + {cfg.encoder_layers} encoder layers' if cfg.encoder_layers else ''}, d "
        f"{cfg.d_model}, {attn}, vocab {cfg.vocab_size}"
        f"{', tied' if cfg.tie_embeddings else ''}; seeded on the card in {init_s:.2f} s"
    )
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    prompt = torch.randint(
        0, cfg.vocab_size, (ZOO_BATCH, ZOO_PROMPT), generator=gen, device="cuda", dtype=torch.int32
    )
    steps = ZOO_PROMPT + ZOO_GEN
    decode = model.decode_fn
    results = []
    for timed in (False, True):
        rec = serve.LatencyRecorder() if timed else None
        frames = torch.Generator(device="cuda").manual_seed(SEED + 3)  # an audio model's
        cache = serve.make_cache(model, params, ZOO_BATCH, steps, "cuda", frames)
        logits, cache = serve.prefill(decode, params, cache, prompt, rec)
        first = logits
        out, cache = serve.greedy_decode(decode, params, cache, logits, ZOO_PROMPT, ZOO_GEN, rec)
        _counted(
            totals, enc_rms + steps * per_step[0], steps * per_step[1],
            f"{label} serve ({per_step} a step, {enc_rms} for enc_out)",
        )
        results.append((first, out, rec))
    first, out, rec = results[1]
    check(out.shape == (ZOO_BATCH, ZOO_GEN), f"{name}: generated {tuple(out.shape)}")
    check(bool(((out >= 0) & (out < cfg.vocab_size)).all()), f"{name}: tokens out of range")
    check(bool(torch.isfinite(first).all()), f"{name}: non-finite logits")
    check(torch.equal(out, results[0][1]), f"{name}: the timed run's tokens differ from the warm-up's")
    s = rec.summary()
    peak = torch.cuda.max_memory_allocated() / 1e9
    floor, floor_by, every = step_floor_ms(cfg, params)
    every = f", reading every expert {every:.3f} ms" if every is not None else ""
    print(
        f"[{tag}] {label} serve batch {ZOO_BATCH}, prompt {ZOO_PROMPT}, {ZOO_GEN} new tokens "
        f"({s['batches']} decode steps, bf16 activations, f32 weights): per-token step p50 "
        f"{s['p50_ms']:.3f} ms p99 {s['p99_ms']:.3f} ms mean {s['mean_ms']:.3f} ms, "
        f"{s['rows_per_s']:.1f} tokens/s | step floor {floor:.3f} ms ({floor_by}{every}) | peak "
        f"memory "
        f"{peak:.2f} GB | launches a step "
        f"{per_step[0]} rmsnorm / {per_step[1]} decode_attention | sequence 0: {out[0].tolist()} "
        f"| {line}"
    )
    print(json.dumps({"zoo_serve": label, "summary": s, "peak_memory_gb": peak, "floor_ms": floor}))

    # prefill ≡ sequential decode, bf16 (reported) and f32 with the f32 cache
    # (held to ZOO_RTOL); under a window over all 48 positions
    check_len = steps if window else ZOO_PROMPT
    tokens = prompt
    if window:
        more = torch.randint(0, cfg.vocab_size, (ZOO_BATCH, ZOO_GEN), generator=gen, device="cuda")
        tokens = torch.cat([prompt, more.int()], dim=1)
    batch = {"tokens": tokens}
    if cfg.family == "audio":  # the serve runs' frames
        batch["embeds"] = _frames(cfg, ZOO_BATCH, SEED + 3)
    pre_bf16 = model.prefill_fn(params, batch)
    _counted(totals, enc_rms + per_step[0], 0, f"{label} prefill_fn")
    model32 = build_model(_zoo_cfg(name, reduced=False, capacity_factor=8.0), window_override=window)
    pre32 = model32.prefill_fn(params, batch)
    _counted(totals, enc_rms + per_step[0], 0, f"{label} f32 prefill_fn")
    cache = _f32_cache(zeros_like_spec(model32.cache_shapes(ZOO_BATCH, check_len), "cuda"))
    if cfg.family == "audio":
        with torch.no_grad():
            cache["enc_out"] = model_zoo._encode(params, model32.cfg, batch["embeds"])
    dec32, cache = serve.prefill(model32.decode_fn, params, cache, tokens)
    _counted(
        totals, enc_rms + check_len * per_step[0], check_len * per_step[1], f"{label} f32 decode"
    )
    check(pre32.dtype == dec32.dtype == torch.float32, f"{name}: f32 logits")
    check(bool(torch.isfinite(pre32).all() and torch.isfinite(dec32).all()), f"{name}: non-finite")
    rel32 = _rel(dec32, pre32)
    check(rel32 <= ZOO_RTOL, f"{label}: f32 prefill vs sequential decode differ by {rel32}")
    rel_bf16 = _rel(pre_bf16, first) if check_len == ZOO_PROMPT else float("nan")
    extra = ""
    if window:
        slots = cache["blocks"]["pos"].shape[-1]
        extra = f", a ring of {slots} slots wrapped {check_len // slots - 1} times"
        check(slots == window, f"{label}: {slots} ring slots, not {window}")
    print(
        f"[{tag}] {label} prefill_fn ≡ sequential decode over {check_len} tokens: f32 "
        f"activations, f32 cache{', capacity factor 8' if cfg.moe else ''}"
        f"{', f32 enc_out' if cfg.family == 'audio' else ''}{extra}: max rel logit diff "
        f"{rel32:.3e} (limit {ZOO_RTOL:g}, TF32 off); bf16 activations vs the serve run's "
        f"first logits {rel_bf16:.3e}"
    )
    if cfg.family == "vlm":
        toks = torch.randint(0, cfg.vocab_size, (1, VLM_TEXT), generator=gen, device="cuda")
        vbatch = {"tokens": toks.int(), "embeds": _frames(cfg, 1, SEED + 4)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = model.prefill_fn(params, vbatch)
        torch.cuda.synchronize()
        vms = (time.perf_counter() - t0) * 1e3
        _counted(totals, per_step[0], 0, f"{label} prefill_fn with the patch prefix")
        check(logits.shape == (1, cfg.vocab_size), f"{name}: patch prefill logits {logits.shape}")
        check(bool(torch.isfinite(logits).all()), f"{name}: non-finite patch prefill logits")
        print(
            f"[{tag}] {label} prefill_fn at batch 1 over {cfg.prefix_tokens} patch rows + "
            f"{VLM_TEXT} text tokens (M-RoPE grid side {int(math.sqrt(cfg.prefix_tokens))}): "
            f"logits finite, {vms:.1f} ms, peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB"
        )
    kept = params if keep else None
    del params, model, model32, cache
    torch.cuda.empty_cache()
    return cfg, gen, kept


def phase_zoo(line: str) -> tuple:
    """phi4-mini-3.8b at full width through ``launch/serve``, then one
    ``make_zoo_extractor`` forward; returns the path's launch counts, the
    config and its parameters (for ``[roofline]``)."""
    totals = {"rmsnorm": 0, "decode_attention": 0}
    cfg, gen, params = phase_zoo_serve(ZOO_ARCH, line, "zoo", totals, keep=True)
    ext = make_zoo_extractor(cfg, rep_dim=128, device="cuda")
    ext.init_(torch.Generator(device="cuda").manual_seed(SEED + 2))
    rows = torch.randint(0, cfg.vocab_size, (8, 64), generator=gen, device="cuda")
    with torch.no_grad():
        reps = ext(rows)
    _counted(totals, ZOO_LAUNCHES[ZOO_ARCH][0], 0, "zoo extractor forward (65 and 0)")
    check(reps.shape == (8, 128) and bool(torch.isfinite(reps).all()), "zoo extractor reps")
    print(
        f"[zoo] make_zoo_extractor({ZOO_ARCH}, rep_dim 128) forward on 8 rows of 64 tokens: "
        f"reps {tuple(reps.shape)} finite, |rep| mean {reps.abs().mean().item():.4e}"
    )
    del ext
    torch.cuda.empty_cache()
    return totals, cfg, params


# [dryrun]: the port's dry-run CLI on the reference's integration pair (at
# 16x16 and 2x16x16) and on phi4-mini's decode step (16x16), each a
# subprocess; [roofline] and [dryrun] together within ROOFLINE_BUDGET_S
DRYRUN_PAIRS = (("mamba2-370m", "long_500k", True), (ZOO_ARCH, "decode_32k", False))
ROOFLINE_BUDGET_S = 60.0
ROOFLINE_STEPS = 20  # timed decode steps of [roofline] (after 3 warm-up ones)


def phase_dryrun(line: str) -> dict:
    """``python -m repro_torch.launch.dryrun`` in subprocesses, started
    together, on the CPU's fake mesh: each record's parameter count equal to
    its config's ``param_shapes()``, positive per-device dot FLOPs and
    traffic, the child's last line saying it never initialised CUDA, and
    this process's allocated card memory unchanged. Returns the records by
    tag and the wall seconds."""
    from repro_torch.launch import dryrun

    allocated = torch.cuda.memory_allocated()
    t0 = time.time()
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    with tempfile.TemporaryDirectory() as out:
        procs = []
        for arch, shape, both in DRYRUN_PAIRS:
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                   "--shape", shape, "--out", out] + (["--both-meshes"] if both else [])
            procs.append(subprocess.Popen(
                cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
            ))
        try:
            results = [p.communicate(timeout=ROOFLINE_BUDGET_S) for p in procs]
        finally:  # a child past the budget is stopped, not left behind
            for p in procs:
                p.kill()
        recs = {}
        for (arch, shape, both), p, (stdout, stderr) in zip(DRYRUN_PAIRS, procs, results):
            if p.returncode != 0:
                errs = [open(os.path.join(out, f)).read()[-3000:] for f in sorted(os.listdir(out))
                        if f.endswith(".err")]
                fail(f"[dryrun] {arch} {shape}: exit {p.returncode}: {stdout[-1000:]} {stderr[-1000:]} "
                     f"{' '.join(errs)}")
            last = stdout.strip().splitlines()[-1]
            check(last.endswith("torch.cuda.is_initialized()=False"), f"[dryrun] child: {last!r}")
            for mesh in ("16x16", "2x16x16") if both else ("16x16",):
                tag = f"{arch}__{shape}__{mesh}"
                with open(os.path.join(out, tag + ".json")) as f:
                    recs[tag] = json.load(f)
    wall = time.time() - t0
    check(torch.cuda.memory_allocated() == allocated, "[dryrun] the card's allocated memory moved")
    for tag, rec in recs.items():
        arch, shape, _ = tag.split("__")
        cfg = dryrun.config_for(arch, INPUT_SHAPES[shape])
        want = sum(math.prod(t.shape) for t in leaves(build_model(cfg).param_shapes()))
        ha, rf = rec["hlo_analysis"], rec["roofline"]
        check(rec["num_params"] == want, f"[dryrun] {tag}: {rec['num_params']} parameters, not {want}")
        check(ha["dot_flops"] > 0 and ha["traffic_bytes"] > 0, f"[dryrun] {tag}: empty counts")
        counts = {k: v for k, v in ha["collective_counts"].items() if v}
        print(
            f"[dryrun] {tag} (route {rec['route']}): {rec['num_params']} parameters | per device: "
            f"dot FLOPs {ha['dot_flops']:.4e}, traffic {ha['traffic_bytes']:.4e} B, collectives "
            f"{ha['total_collective_bytes']:.4e} B {counts} | compute {rf['compute_s']:.4e} s, "
            f"memory {rf['memory_s']:.4e} s, collective {rf['collective_s']:.4e} s -> "
            f"{rf['bottleneck']}; useful FLOPs ratio {rf['useful_flops_ratio']:.4f} | stacks "
            f"{ha['while_trip_counts']} | trace {rec['lower_s']} s | {line}"
        )
    print(f"[dryrun] {len(recs)} records in {wall:.1f} s (the subprocesses together), the card "
          f"untouched ({allocated} bytes allocated before and after)")
    return {"records": recs, "wall": wall}


def _decode_inputs(model, batch: int, slots: int, device, pos: int) -> tuple:
    cache = zeros_like_spec(model.cache_shapes(batch, slots), device)
    step = {
        "token": torch.ones(batch, 1, dtype=torch.int32, device=device),
        "pos": torch.full((batch, 1), pos, dtype=torch.int32, device=device),
    }
    return cache, step


def _counted_step(model, params, cache, step) -> tuple:
    """One decode step under the trace counter → (its cost, the RMSNorm and
    decode-attention launches it made)."""
    torch.cuda.synchronize()
    before = (rops.LAUNCHES, dops.LAUNCHES)
    with TraceCounter() as counter:
        model.decode_fn(params, cache, step)
    torch.cuda.synchronize()
    return counter.cost, (rops.LAUNCHES - before[0], dops.LAUNCHES - before[1])


def phase_roofline(cfg, params, line: str) -> dict:
    """The trace counter on the card: one decode step of ``cfg`` at batch
    ZOO_BATCH against a cache of ZOO_PROMPT + ZOO_GEN slots, with [zoo]'s
    parameters, in which the ``rmsnorm`` and ``decode_attention`` kernels
    run and declare their costs. Held: the counter's kernel calls equal the
    LAUNCHES deltas; on the 2-layer variant (the same parameters' first two
    blocks) the card's dot FLOPs equal, to the FLOP, the counter's over the
    CPU's plain route on the same shapes (fake tensors: the kernels'
    declared attention FLOPs stand in for the plain einsums); at full width
    the step floor's weight-bytes term <= the memory term <= the measured
    p50 a step. Returns the launches and the wall seconds."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    t0 = time.time()
    slots = ZOO_PROMPT + ZOO_GEN
    device = params.embed.tok.device
    model = build_model(cfg)
    cache, step = _decode_inputs(model, ZOO_BATCH, slots, device, 0)
    cost, launched = _counted_step(model, params, cache, step)
    calls = {"rmsnorm": launched[0], "decode_attention": launched[1]}
    check(cost.kernel_calls == calls, f"[roofline] kernel calls {cost.kernel_calls}, launches {calls}")
    want = {"rmsnorm": 2 * cfg.num_layers + 1, "decode_attention": cfg.num_layers}
    check(calls == want, f"[roofline] launches {calls}, not {want}")
    terms = roofline_terms({"dot_flops": cost.dot_flops, "traffic_bytes": cost.traffic_bytes,
                            "collective_bytes": cost.total_collective_bytes})

    times = []
    for i in range(3 + ROOFLINE_STEPS):  # the counted step wrote position 0
        step["pos"].fill_(i + 1)
        torch.cuda.synchronize()
        t = time.perf_counter()
        model.decode_fn(params, cache, step)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    p50 = float(np.percentile(times[3:], 50))
    floor, floor_by, _ = step_floor_ms(cfg, params)
    check(floor_by == "bytes", f"[roofline] the step floor is bound by {floor_by}")
    mem_ms = terms["memory_s"] * 1e3
    check(floor <= mem_ms <= p50, f"[roofline] floor {floor} ms, memory {mem_ms} ms, p50 {p50} ms")

    # the 2-layer variant: the card's kernels against the CPU's plain route
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    model2 = build_model(cfg2)
    params2 = copy.copy(params)
    params2._modules = dict(params._modules)
    params2._modules["blocks"] = torch.nn.ModuleList(list(params.blocks)[:2])
    cache2, step2 = _decode_inputs(model2, ZOO_BATCH, slots, device, 0)
    card2, launched2 = _counted_step(model2, params2, cache2, step2)
    with FakeTensorMode():
        plain_params = model_zoo.make_backbone(cfg2, "cpu")
        cache_c, step_c = _decode_inputs(model2, ZOO_BATCH, slots, "cpu", 0)
        with TraceCounter() as plain:
            model2.decode_fn(plain_params, cache_c, step_c)
    plain = plain.cost
    check(plain.kernel_calls == {}, f"[roofline] the CPU's plain route reported {plain.kernel_calls}")
    check(card2.dot_flops == plain.dot_flops,
          f"[roofline] 2 layers: card dot FLOPs {card2.dot_flops}, CPU plain {plain.dot_flops}")
    check(card2.kernel_calls == {"rmsnorm": launched2[0], "decode_attention": launched2[1]},
          f"[roofline] 2 layers: kernel calls {card2.kernel_calls}, launches {launched2}")
    wall = time.time() - t0
    print(
        f"[roofline] {cfg.name} decode step at batch {ZOO_BATCH}, {slots} cache slots, on the card "
        f"under the trace counter: dot FLOPs {cost.dot_flops:.6e}, traffic "
        f"{cost.traffic_bytes:.6e} B, kernel calls {cost.kernel_calls} (= the launches) | on "
        f"{HW.name}: compute {terms['compute_s'] * 1e3:.4f} ms, memory {mem_ms:.4f} ms, collective "
        f"{terms['collective_s'] * 1e3:.4f} ms -> {terms['bottleneck']} | measured p50 "
        f"{p50:.3f} ms a step over {ROOFLINE_STEPS}, step floor {floor:.3f} ms ({floor_by}) | "
        f"{line}"
    )
    print(
        f"[roofline] 2-layer variant: card dot FLOPs {card2.dot_flops:.0f} (kernel calls "
        f"{card2.kernel_calls}) = CPU plain route {plain.dot_flops:.0f}; traffic card "
        f"{card2.traffic_bytes:.6e} B (the kernels' declared bytes), plain "
        f"{plain.traffic_bytes:.6e} B; {wall:.1f} s"
    )
    del cache, cache2, params2
    return {"wall": wall, "p50_ms": p50}


def _bwd_oracle64(x, scale, dy, eps: float = 1e-6):
    """dx and dscale of the RMSNorm in float64."""
    xd, sd, gd = x.double(), scale.double(), dy.double()
    r = torch.rsqrt(xd.square().mean(-1, keepdim=True) + eps)
    g = sd * gd
    dx = r * g - xd * r**3 * (xd * g).mean(-1, keepdim=True)
    return dx, (gd * xd * r).sum(0)


def bwd_dx_bound(want_dx: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The per-element bound on a backward's dx against float64: 1e-5 of
    the largest entry, plus one bf16 step at the value in bf16."""
    bound = RMS_BWD_TOL * want_dx.abs().max()
    if dtype == torch.bfloat16:
        bound = bound + torch.exp2(torch.floor(torch.log2(want_dx.abs().clamp_min(2.0**-126))) - 7)
    return bound


def bwd_bound(x: torch.Tensor) -> tuple:
    """(bytes, bound ms, "bytes" or "operations") of the backward over x
    (rows, d) with an f32 scale: x and dy read, dx written, scale read,
    dscale written; about 12 f32 operations an element (the two row sums,
    dx, dscale's term)."""
    rows, d = x.shape
    nbytes = 3 * rows * d * x.element_size() + 2 * 4 * d
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, 12 * rows * d / H100_F32_FLOPS
    return nbytes, max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations"


def phase_rmsnorm_backward(gen) -> dict:
    """The RMSNorm backward kernel vs its plain version and float64, timed
    with events and from a CUDA graph, beside the plain backward and the
    library's backward alone (``torch.autograd.grad`` of ``F.rms_norm`` on
    the same f32 scale)."""
    rows_out = []
    for rows, d, dtype in RMS_BWD_SHAPES:
        x = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
        scale = 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
        dy = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dx, ds = rops.rms_norm_backward(x, scale, dy)  # checks the inputs, builds the plan
        first_us = (time.perf_counter() - t0) * 1e6
        pdx, pds = rref.rms_norm_backward(x, scale, dy)
        dx2, ds2 = rops.rms_norm_backward(x, scale, dy)
        torch.cuda.synchronize()
        check(dx.dtype == dtype and ds.dtype == scale.dtype, f"rmsnorm backward dtypes at {rows, d}")
        same = torch.equal(dx, dx2) and torch.equal(ds, ds2)
        check(same, f"rmsnorm backward not deterministic at {rows, d}")
        want_dx, want_ds = _bwd_oracle64(x, scale, dy)
        err = (dx.double() - want_dx).abs()
        used = (err / bwd_dx_bound(want_dx, dtype)).max().item()
        dx_text = f"{err.max().item() / want_dx.abs().max().item():.2e} of max|dx|"
        err_ds = (ds.double() - want_ds).abs().max().item() / want_ds.abs().max().item()
        check(used <= 1.0, f"rmsnorm backward {rows, d, dtype}: dx at {used:.2f} of its bound vs f64")
        check(err_ds <= RMS_BWD_TOL, f"rmsnorm backward {rows, d, dtype}: dscale off by {err_ds:.2e}")
        plain_err = max(
            (dx.float() - pdx.float()).abs().max().item(), (ds - pds).abs().max().item()
        )
        # the library's forward on a stream of its own, where the graph is
        # captured: its backward runs there (on the default stream, the
        # capture refuses it)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        lx, ls = x.clone().requires_grad_(True), scale.clone().requires_grad_(True)
        with torch.cuda.stream(side):
            ly = F.rms_norm(lx, (d,), ls, 1e-6)
        torch.cuda.current_stream().wait_stream(side)

        def library():
            return torch.autograd.grad(ly, (lx, ls), dy, retain_graph=True)

        row = {
            "shape": [rows, d, str(dtype).split(".")[-1]],
            "max_abs_err": plain_err,
            "ms": time_ms(lambda: rops.rms_norm_backward(x, scale, dy)),
            "plain_ms": time_ms(lambda: rref.rms_norm_backward(x, scale, dy)),
            "library_ms": time_ms(library),
            "device_ms": device_ms(lambda: rops.rms_norm_backward(x, scale, dy)),
            "library_device_ms": device_ms(library, stream=side),
            "host_us": host_us(lambda: rops.rms_norm_backward(x, scale, dy)),
        }
        nbytes, row["bound_ms"], row["bound_by"] = bwd_bound(x)
        rows_out.append(row)
        times = " | ".join(f"{k} {row[k]:.4f} ms" for k in ZOO_TIMES)
        print(
            f"[kernel] rmsnorm_backward rows={rows} d={d} {row['shape'][2]} (scale f32): dx vs "
            f"f64 {dx_text} ({used:.2f} of its bound), dscale vs f64 {err_ds:.2e} of max, vs "
            f"plain {plain_err:.3e}, two runs bit-equal | {times} | bound "
            f"{row['bound_ms']:.3e} ms ({row['bound_by']}) | host {row['host_us']:.1f} us a "
            f"call (first call {first_us:.0f} us) | {_bwd_split_text(rops.device_backward_plan(x))}"
        )
        del lx, ls, ly
        if (rows, d, dtype) in RMS_BWD_SHAPES[:3]:
            copies = bwd_copies(x, scale, dy, nbytes)
            row.update(_bwd_cold_row(copies, row["bound_ms"]))
            _bwd_plan_rows(x, scale, dy, want_dx, want_ds, copies)
            del copies
    return rows_out[0]  # mamba2-370m's block norm: 49 of a [zoo-train] step's 97


def host_us(fn, calls: int = 200) -> float:
    """Host µs a call of ``fn()`` over ``calls`` calls that do not wait for
    the card (synchronized before and after)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def cold_device_ms(calls, iters: int = 50, stream=None) -> float:
    """Mean device time of a call with its inputs out of L2: ``calls`` run
    one function on as many copies of its inputs, whose bytes together are
    several times the card's L2, and the graph's calls take them in turn;
    every call's outputs are kept until the timing ends, so no output
    buffer is written twice either."""
    turn, kept = itertools.cycle(calls), []
    ms = device_ms(lambda: kept.append(next(turn)()), max(iters, 2 * len(calls)), stream=stream)
    kept.clear()
    return ms


def bwd_copies(x, scale, dy, nbytes: int) -> list:
    """Copies of a backward's inputs for :func:`cold_device_ms` to take in
    turn: enough that their ``nbytes`` each (inputs read, outputs written)
    come to three times the card's L2."""
    n = max(2, -(-3 * torch.cuda.get_device_properties(x.device).L2_cache_size // nbytes))
    return [(x.clone(), scale.clone(), dy.clone()) for _ in range(n)]


def _bwd_cold_row(copies, bound_ms: float) -> dict:
    """The wrapper's backward and the library's with their inputs out of
    L2 (:func:`cold_device_ms` over :func:`bwd_copies`' copies), the
    kernel's time against its bytes bound; beside them ``x + dy`` into a
    new tensor, which moves the same bytes (x and dy read, one x-sized
    output written) in one library kernel, as a floor that the card
    reaches in practice."""
    x = copies[0][0]
    d = x.shape[-1]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    lib = []
    with torch.cuda.stream(side):  # the library's forwards, as in phase_rmsnorm_backward
        for cx, cs, cy in copies:
            lx, ls = cx.detach().requires_grad_(True), cs.detach().requires_grad_(True)
            lib.append((F.rms_norm(lx, (d,), ls, 1e-6), lx, ls, cy))
    torch.cuda.current_stream().wait_stream(side)
    out = {
        "cold_device_ms": cold_device_ms([lambda c=c: rops.rms_norm_backward(*c) for c in copies]),
        "library_cold_device_ms": cold_device_ms(
            [lambda c=c: torch.autograd.grad(c[0], c[1:3], c[3], retain_graph=True) for c in lib],
            stream=side,
        ),
        "same_bytes_cold_ms": cold_device_ms([lambda c=c: torch.add(c[0], c[2]) for c in copies]),
    }
    print(
        f"[kernel] rmsnorm_backward rows={x.shape[0]} d={d} {str(x.dtype).split('.')[-1]}, inputs "
        f"out of L2 ({len(copies)} copies in turn): device_ms {out['cold_device_ms']:.4f} "
        f"({bound_ms / out['cold_device_ms']:.0%} of its bytes bound) | library_device_ms "
        f"{out['library_cold_device_ms']:.4f} | x + dy, the same bytes: device_ms "
        f"{out['same_bytes_cold_ms']:.4f} ({bound_ms / out['same_bytes_cold_ms']:.0%})"
    )
    return out


def _bwd_split_text(split) -> str:
    route = f"{split.vpt} slot(s) a thread" if split.vpt else "the loop route"
    return (
        f"{route}, {split.groups} row group(s) of {split.group_threads} threads a block, "
        f"{split.blocks} blocks = partial rows of {split.rows_per_block} rows, column sum "
        f"{split.sum_warps} warps"
    )


def _bwd_plan_rows(x, scale, dy, want_dx, want_ds, copies) -> None:
    """The backward under other splits than the wrapper's at one shape:
    every slots-a-thread route with the wrapper's rows a group, the
    wrapper's route with one row a group and with two blocks an SM; each
    held against float64 and timed from a CUDA graph with its inputs in L2
    and out of it (``copies`` in turn), the wrapper's marked."""
    rows, d = x.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    wrapper = rops.device_backward_plan(x)
    splits = {wrapper}
    for vpt in (1, 2, 4):
        splits.add(rops.backward_plan(rows, d, x.element_size(), sms, vpt=vpt))
    per_block = -(-rows // sms)
    splits.add(rops.backward_plan(rows, d, x.element_size(), sms, wrapper.vpt, per_block))
    splits.add(rops.backward_plan(rows, d, x.element_size(), sms, wrapper.vpt, blocks_per_sm=2))
    for split in sorted(splits):
        if split.threads > rops.backward_max_threads(split.vpt):  # past the route's registers
            continue
        dx, ds = rops.backward_launch(x, scale, dy, split)
        used = ((dx.double() - want_dx).abs() / bwd_dx_bound(want_dx, x.dtype)).max().item()
        err_ds = (ds.double() - want_ds).abs().max().item() / want_ds.abs().max().item()
        check(used <= 1.0 and err_ds <= RMS_BWD_TOL, f"rmsnorm backward split {split}: off vs f64")
        ms = device_ms(lambda: rops.backward_launch(x, scale, dy, split))
        cold = cold_device_ms([lambda c=c: rops.backward_launch(*c, split) for c in copies])
        mark = " (the wrapper's plan)" if split == wrapper else ""
        print(
            f"[plan] rmsnorm_backward rows={rows} d={d} {str(x.dtype).split('.')[-1]}: "
            f"{_bwd_split_text(split)} | device_ms {ms:.4f}, out of L2 {cold:.4f} | dx at "
            f"{used:.2f} of its bound vs f64, dscale {err_ds:.2e} of max{mark}"
        )


def _pct(values, q: float) -> float:
    return torch.quantile(torch.tensor(values, dtype=torch.float64), q).item()


def _train_cfg(name: str, reduced: bool):
    """The [zoo-train] config: full width (TRAIN_DEPTH layers where set), or
    the 2-layer reduced variant in f32 activations (_zoo_cfg)."""
    if reduced:
        return _zoo_cfg(name, reduced=True)
    cfg = get_config(name)
    if name in TRAIN_DEPTH:
        cfg = dataclasses.replace(cfg, num_layers=TRAIN_DEPTH[name])
    return cfg


def _leaf_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """|a − b| at its largest over b's largest magnitude."""
    return ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30)).item()


def phase_zoo_train_small(name: str) -> str:
    """The 2-layer reduced variant (f32 activations) trained TRAIN_SMALL_STEPS
    steps on the card and on the CPU from the same parameters and batch: the
    first step's gradients per leaf and every step's loss within
    ZOO_RTOL."""
    cfg = _train_cfg(name, reduced=True)
    model = build_model(cfg)
    params = {"cuda": model.init(torch.Generator(device="cuda").manual_seed(SEED))}
    params["cpu"] = copy.deepcopy(params["cuda"]).cpu()
    tokens, labels = make_token_stream(
        torch.Generator(device="cuda").manual_seed(SEED + 5), 4, 32, cfg.vocab_size
    )
    grads, losses = {}, {}
    for dev, p in params.items():
        batch = {"tokens": tokens.to(dev), "labels": labels.to(dev)}
        grads[dev] = torch.autograd.grad(model.loss_fn(p, batch), list(p.parameters()))
        tx = make_optimizer(cfg, TRAIN_LR)
        opt, step = tx.init(list(p.parameters())), make_train_step(model, tx)
        losses[dev] = [float(step(p, opt, batch)) for _ in range(TRAIN_SMALL_STEPS)]
    grad_rel = max(_leaf_rel(c.cpu(), g) for c, g in zip(grads["cuda"], grads["cpu"]))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
    what = f"[zoo-train] reduced {name} ({cfg.num_layers} layers, d {cfg.d_model}, f32)"
    check(grad_rel <= ZOO_RTOL, f"{what}: card vs CPU first-step gradients differ by {grad_rel}")
    check(loss_rel <= ZOO_RTOL, f"{what}: card vs CPU losses {losses}")
    del params, grads
    torch.cuda.empty_cache()
    return (
        f"{what}: card vs CPU first-step gradients max rel diff per leaf {grad_rel:.2e}, "
        f"{TRAIN_SMALL_STEPS}-step losses {[round(v, 5) for v in losses['cuda']]} max rel diff "
        f"{loss_rel:.2e}"
    )


def phase_zoo_train_full(name: str, line: str) -> dict:
    """One full-width train run (TRAIN_STEPS + 1 steps on one fixed batch):
    the loss of every step, p50 / p99 ms a step on the host clock
    (synchronized), tokens/s, peak memory, model FLOPs a step and TFLOP/s,
    and the RMSNorm forward and backward launches of every step, exact.
    Returns the run's launch counts."""
    cfg = _train_cfg(name, reduced=False)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = model.init(gen)
    n_params = sum(p.numel() for p in params.parameters())
    check(n_params == TRAIN_PARAMS[name], f"[zoo-train] {name}: {n_params} parameters")
    tokens, labels = make_token_stream(gen, TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size)
    batch = {"tokens": tokens, "labels": labels}
    tx = make_optimizer(cfg, TRAIN_LR)
    opt = tx.init(list(params.parameters()))
    step = make_train_step(model, tx)
    want_fwd, want_bwd = TRAIN_LAUNCHES[name]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    fwd = bwd = 0
    for i in range(TRAIN_STEPS + 1):
        f0, b0 = rops.LAUNCHES, rops.BACKWARD_LAUNCHES
        t0 = time.perf_counter()
        loss = step(params, opt, batch)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        got = (rops.LAUNCHES - f0, rops.BACKWARD_LAUNCHES - b0)
        check(got == (want_fwd, want_bwd), f"[zoo-train] {name} step {i}: rmsnorm launches {got}")
        fwd, bwd = fwd + got[0], bwd + got[1]
        losses.append(float(loss))
        if i:
            ms.append(dt)
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(all(math.isfinite(v) for v in losses), f"[zoo-train] {name}: losses {losses}")
    check(losses[-1] < losses[0], f"[zoo-train] {name}: loss did not fall: {losses}")
    flops = model_flops(cfg, InputShape("train", TRAIN_SEQ, TRAIN_BATCH, "train"))
    p50, p99 = _pct(ms, 0.5), _pct(ms, 0.99)
    tokens_s = TRAIN_BATCH * TRAIN_SEQ / (p50 / 1e3)
    depth = f", {cfg.num_layers} of {get_config(name).num_layers} layers" if name in TRAIN_DEPTH else ""
    print(
        f"[zoo-train] {name} full width ({n_params} params{depth}, {cfg.activation_dtype} "
        f"activations, remat {cfg.remat}), batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, clip 1.0 + Adam "
        f"lr {TRAIN_LR}: losses {[round(v, 4) for v in losses]} | p50 {p50:.2f} ms p99 {p99:.2f} "
        f"ms a step over {TRAIN_STEPS} steps | {tokens_s:.0f} tokens/s | peak "
        f"{peak:.2f} GiB | model FLOPs {flops:.4e} a step, {flops / (p50 / 1e3) / 1e12:.2f} "
        f"TFLOP/s | rmsnorm launches a step {want_fwd} forward / {want_bwd} backward | {line}"
    )
    del params, opt, model
    torch.cuda.empty_cache()
    return {"rmsnorm": fwd, "rmsnorm_backward": bwd}


def phase_zoo_vfl(line: str) -> dict:
    """A reduced phi4 backbone as both parties' extractor in Alg. 1 one-shot
    with token SSL, on the port's own sequence data on the card (see
    ZOO_VFL_BAR); returns its launch counts."""
    cfg = dataclasses.replace(get_config(ZOO_ARCH).reduced(), vocab_size=32, num_layers=2)
    x, y = make_sequence_classification(
        400, seed=SEED, device="cuda", seq_len=16, vocab_size=32, num_classes=3
    )
    xf = x.float()  # a split's features are float32, as split_from_numpy makes them
    perm = np.random.RandomState(0).permutation(400)
    test, over, rest = (torch.as_tensor(a, device="cuda") for a in (perm[:80], perm[80:144], perm[144:]))
    pool = [torch.as_tensor(a, device="cuda") for a in np.array_split(rest.cpu().numpy(), 2)]
    split = VerticalSplit(
        aligned=[xf[over, :8], xf[over, 8:]],
        labels=y[over],
        unaligned=[xf[pool[0], :8], xf[pool[1], 8:]],
        test_aligned=[xf[test, :8], xf[test, 8:]],
        test_labels=y[test],
        num_classes=3,
    )
    spec = ZooExtractorSpec(cfg, rep_dim=16)
    t0 = time.time()
    res = run_one_shot(
        SEED, split, [spec] * 2, [SSLConfig(modality="token")] * 2,
        ProtocolConfig(client_epochs=3, server_epochs=10, client_lr=0.02), device="cuda",
    )
    torch.cuda.synchronize()
    wall = time.time() - t0
    nbytes, times = res.ledger.total_bytes(), res.ledger.comm_times()
    check(res.metric > ZOO_VFL_BAR, f"[zoo-vfl] metric {res.metric} not above {ZOO_VFL_BAR}")
    check(times == 3, f"[zoo-vfl] {times} comm times")
    check(nbytes == ZOO_VFL_BYTES, f"[zoo-vfl] {nbytes} bytes, not {ZOO_VFL_BYTES}")
    counts = {
        "rmsnorm": rops.LAUNCHES,
        "rmsnorm_backward": rops.BACKWARD_LAUNCHES,
        "kmeans": kops.LAUNCHES,
    }
    print(
        f"[zoo-vfl] reduced {ZOO_ARCH} (vocab 32, 2 layers, d {cfg.d_model}) as both parties' "
        f"extractor, token SSL, one-shot 3 / 10 epochs: {res.metric_name} {res.metric:.4f} "
        f"(bar {ZOO_VFL_BAR}, chance 0.33) | {nbytes} bytes in {times} comm times | engine path "
        f"{res.diagnostics.get('engine_path')} | {wall:.1f} s | rmsnorm launches "
        f"{counts['rmsnorm']} forward / {counts['rmsnorm_backward']} backward, kmeans "
        f"{counts['kmeans']} | {line}"
    )
    del res
    torch.cuda.empty_cache()
    return counts


def phase_zoo_train(line: str) -> dict:
    """[zoo-train]: each TRAIN_ARCHS config at full width, then its reduced
    variant on the card and the CPU. Returns the full-width runs' RMSNorm
    launches."""
    totals = {"rmsnorm": 0, "rmsnorm_backward": 0}
    for name in TRAIN_ARCHS:
        got = phase_zoo_train_full(name, line)
        totals = {k: totals[k] + got[k] for k in totals}
        print(phase_zoo_train_small(name))
    return totals


def vfl_step_jobs() -> tuple:
    """([vfl-step]'s run names, each party's jobs): 20 vanilla steps and the
    one-shot session in f32 and bf16 at the reference example's sizes
    (``vfl_step.example_jobs``), and the session in f32 and bf16 on
    ``hard/overlap-32``'s split from the port's catalog build, a seeded
    server head. Every draw comes from each job's seed on the CPU."""
    bundle = scenarios.build("hard/overlap-32", seed=SEED, device="cpu")
    split, spec = bundle.split, bundle.extractors[0]
    gen = torch.Generator().manual_seed(SEED)
    w_head = 0.3 * torch.randn(2 * spec.rep_dim, split.num_classes, generator=gen)
    names = [
        f"example vanilla x{VFL_STEP_VANILLA_STEPS}", "example one-shot f32",
        "example one-shot bf16", "hard/overlap-32 one-shot f32", "hard/overlap-32 one-shot bf16",
    ]
    jobs = []
    for k, (vanilla, oneshot) in enumerate(vfl_step.example_jobs(2, SEED)):
        hard = vfl_step.PartyJob(
            "oneshot", split.aligned[k], split.labels, w_head, VFL_STEP_LOCAL_STEPS,
            spec.hidden[0], spec.rep_dim, x_u=split.unaligned[k], seed=SEED,
        )
        jobs.append([
            dataclasses.replace(vanilla, steps=VFL_STEP_VANILLA_STEPS),
            oneshot,
            dataclasses.replace(oneshot, rep_dtype=torch.bfloat16),
            hard,
            dataclasses.replace(hard, rep_dtype=torch.bfloat16),
        ])
    return names, jobs


def _vfl_step_run(name: str, job, card: list, cpu: list, line: str) -> int:
    """Checks one [vfl-step] run's ranks (card and CPU) and prints its line;
    returns the card ranks' ``kmeans`` launches."""
    if job.kind == "vanilla":
        want, want_km = ["all_gather", "reduce_scatter"] * job.steps, 0
    else:
        want, want_km = ["all_gather", "all_reduce", "all_gather"], job.kmeans_iters + 2
    for where, runs in (("card", card), ("cpu", cpu)):
        for r, run in enumerate(runs):
            kinds = [op.kind for op in run["ops"]]
            check(kinds == want, f"[vfl-step] {name}: {where} rank {r} ran {kinds}")
            check(run["counts"]["pod_crossing"] == len(want), f"[vfl-step] {name}: {run['counts']}")
    km = [run["kmeans_launches"] for run in card]
    check(km == [want_km] * len(card), f"[vfl-step] {name}: card kmeans launches {km}, not {want_km}")
    check(all(run["kmeans_launches"] == 0 for run in cpu), f"[vfl-step] {name}: a CPU rank launched")
    sent = sum(op.payload for run in card for op in run["ops"])
    if name.startswith("hard/overlap-32"):
        bf16 = job.rep_dtype == torch.bfloat16
        ledger = (CATALOG_BF16_LEDGERS if bf16 else CATALOG_LEDGERS)["hard/overlap-32"][0]
        check(sent == ledger, f"[vfl-step] {name}: {sent} payload bytes, not run_one_shot's {ledger}")
    errs = []
    for r, (a, b) in enumerate(zip(card, cpu)):
        scale = max(1.0, max(float(np.abs(v).max()) for v in b["extractor"].values()))
        worst = max(float(np.abs(a["extractor"][k] - v).max()) for k, v in b["extractor"].items())
        loss_err = abs(a["loss"] - b["loss"])
        check(
            worst <= VFL_STEP_TOL * scale and loss_err <= VFL_STEP_TOL * scale,
            f"[vfl-step] {name}: rank {r} card vs CPU extractor {worst:.3e}, loss {loss_err:.3e} "
            f"(scale {scale:.3f})",
        )
        check(math.isfinite(a["loss"]), f"[vfl-step] {name}: rank {r} loss {a['loss']}")
        errs.append(f"{worst:.3e} / {loss_err:.3e}")
    flips = (
        [int((a["pseudo"] != b["pseudo"]).sum()) for a, b in zip(card, cpu)]
        if job.kind == "oneshot" else None
    )
    print(
        f"[vfl-step] {name}: {want[:3] if job.kind == 'oneshot' else want[:2]} x "
        f"{1 if job.kind == 'oneshot' else job.steps} = {len(want)} cross-party collectives "
        f"(counted in each rank), {card[0]['counts']['pod_crossing_bytes']} result bytes a rank, "
        f"{sent} payload bytes over the parties | kmeans launches a rank {km} (expected "
        f"{want_km}) | loss card {card[0]['loss']:.6f} cpu {cpu[0]['loss']:.6f} | card vs cpu "
        f"extractor / loss max |Δ| a rank {errs} (tol {VFL_STEP_TOL} x largest parameter)"
        + ("" if flips is None else f", pseudo-labels differing a rank {flips}")
        + f" | job s card {[round(run['seconds'], 3) for run in card]} cpu "
        f"{[round(run['seconds'], 3) for run in cpu]} | {line}"
    )
    return sum(km)


def phase_vfl_step(line: str) -> dict:
    """[vfl-step]: ``launch/vfl_step.py`` as two gloo party processes on
    cuda:0 and, at the same time, two on the CPU, over :func:`vfl_step_jobs`;
    every run checked by :func:`_vfl_step_run`. Returns the card ranks'
    ``kmeans`` launches and the phase's seconds."""
    names, jobs = vfl_step_jobs()
    t0 = time.time()
    with ThreadPoolExecutor(1) as pool:
        cpu_future = pool.submit(
            vfl_step.run_parties, vfl_step.run_party_jobs, [("cpu", j) for j in jobs],
            VFL_STEP_TIMEOUT_S,
        )
        card = vfl_step.run_parties(
            vfl_step.run_party_jobs, [("cuda", j) for j in jobs], VFL_STEP_TIMEOUT_S
        )
        card_s = time.time() - t0
        cpu = cpu_future.result()
    wall = time.time() - t0
    launches = sum(
        _vfl_step_run(name, jobs[0][i], [rank[i] for rank in card], [rank[i] for rank in cpu], line)
        for i, name in enumerate(names)
    )
    print(
        f"[vfl-step] 2 gloo ranks on cuda:0 and 2 on the CPU, spawned together: the card's "
        f"group {card_s:.1f} s from spawn to exit, both {wall:.1f} s | {line}"
    )
    sessions = [j for j in jobs[0] if j.kind == "oneshot"]
    expected = len(jobs) * sum(j.kmeans_iters + 2 for j in sessions)
    return {"kmeans": launches, "expected": expected, "wall": wall, "sessions": len(sessions)}


def _zero_counters() -> None:
    torch.cuda.synchronize()
    ops.LAUNCHES = kops.LAUNCHES = rops.LAUNCHES = rops.BACKWARD_LAUNCHES = dops.LAUNCHES = 0


def run_training_paths(line: str) -> tuple:
    """The zoo's training path and the zoo extractor in Alg. 1, each with the
    counters from 0, read right after. Returns (train counts, vfl counts,
    seconds of each)."""
    _zero_counters()
    t0 = time.time()
    train = phase_zoo_train(line)
    torch.cuda.synchronize()
    train_s = time.time() - t0
    small = (rops.LAUNCHES - train["rmsnorm"], rops.BACKWARD_LAUNCHES - train["rmsnorm_backward"])
    check(ops.LAUNCHES == kops.LAUNCHES == dops.LAUNCHES == 0, "a VFL or decode kernel launched in [zoo-train]")
    check(min(small) > 0, f"[zoo-train] the reduced card runs launched {small}")
    train = {"rmsnorm": rops.LAUNCHES, "rmsnorm_backward": rops.BACKWARD_LAUNCHES}
    print(
        f"[path] zoo-train: rmsnorm launches {train['rmsnorm']} forward / "
        f"{train['rmsnorm_backward']} backward (each full-width step exactly "
        + ", ".join(f"{n} {f} / {b}" for n, (f, b) in TRAIN_LAUNCHES.items())
        + f"; the reduced card runs {small[0]} / {small[1]}) in {train_s:.1f} s"
    )
    _zero_counters()
    t0 = time.time()
    vfl = phase_zoo_vfl(line)
    torch.cuda.synchronize()
    vfl_s = time.time() - t0
    want_km = ProtocolConfig().kmeans_iters + 2
    check(vfl["kmeans"] == want_km, f"[zoo-vfl] kmeans launched {vfl['kmeans']} times, not {want_km}")
    check(vfl["rmsnorm"] > 0 and vfl["rmsnorm_backward"] > 0, f"[zoo-vfl] rmsnorm launches {vfl}")
    check(ops.LAUNCHES == dops.LAUNCHES == 0, "sdpa_estimator or decode_attention launched in [zoo-vfl]")
    print(
        f"[path] zoo-vfl: rmsnorm launches {vfl['rmsnorm']} forward / {vfl['rmsnorm_backward']} "
        f"backward, kmeans launches {vfl['kmeans']} (expected {want_km}: step ③) in {vfl_s:.1f} s"
    )
    return train, vfl, train_s, vfl_s


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this smoke run needs a GPU", file=sys.stderr)
        return 1
    line = phase_device()
    t_start = t0 = time.time()
    _build.build()
    print(f"[build] {', '.join(_build.KERNELS)} built in {time.time() - t0:.1f}s")
    logs = {name: _build.build_log(name).splitlines() for name in _build.KERNELS}
    entries = _entry_names(
        [ln.split("'")[1] for lines in logs.values() for ln in lines if "entry function" in ln]
    )
    for name, lines in logs.items():
        entry = ""
        for log_line in lines:
            if "Compiling entry function" in log_line:
                entry = entries[log_line.split("'")[1]]
            elif "registers" in log_line or "spill" in log_line:
                print(f"[build] {name}: {entry}: {log_line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    sdpa_row = phase_sdpa(gen)
    phase_sdpa_extra(gen, CATALOG_SDPA_SHAPES, "③' catalog")
    phase_sdpa_extra(gen, FAULT_SDPA_SHAPES, "faults")
    phase_sdpa_extra(gen, FOLD_SDPA_SHAPES, "folds", shared_qk=False)
    phase_sdpa_plans(gen)
    kmeans_row = phase_kmeans(gen)
    phase_kmeans_plans(gen)
    t0 = time.time()
    rms_row = phase_rmsnorm(gen)
    rms_bwd_row = phase_rmsnorm_backward(gen)
    decode_row = phase_decode_attention(gen)
    phase_decode_plans(gen)
    zoo_kernels_s = time.time() - t0

    # ---- the training path: counters from 0, read right after
    torch.cuda.synchronize()
    ops.LAUNCHES = kops.LAUNCHES = rops.LAUNCHES = rops.BACKWARD_LAUNCHES = dops.LAUNCHES = 0
    expected_km, one_shot_a, art_a = phase_one_shot_a(line)
    art_b, runs_b = phase_one_shot_b(line)
    expected_km += runs_b
    torch.cuda.synchronize()
    km_launches, sdpa_in_training = kops.LAUNCHES, ops.LAUNCHES
    check(rops.BACKWARD_LAUNCHES == 0, "the RMSNorm backward launched in VFL training")
    check(
        km_launches == expected_km,
        f"kmeans launched {km_launches} times, expected {expected_km}",
    )
    check(sdpa_in_training == 0, f"sdpa_estimator launched {sdpa_in_training} times in training")
    check(rops.LAUNCHES == dops.LAUNCHES == 0, "a zoo kernel launched in training")
    print(
        f"[path] training: kmeans launches {km_launches} (expected {expected_km}: per run "
        f"{runs_b - 2} Lloyd iterations over K·R = 2·{KMEANS_RESTARTS} + 1 inertia + 1 final)"
    )

    # ---- the few-shot training path: counters from 0, read right after
    ops.LAUNCHES = kops.LAUNCHES = rops.LAUNCHES = rops.BACKWARD_LAUNCHES = dops.LAUNCHES = 0
    t0 = time.time()
    sdpa_a, km_a, few_shot_a_auc = phase_few_shot_a(line)
    torch.cuda.empty_cache()
    sdpa_b, km_b = phase_few_shot_b(line)
    torch.cuda.synchronize()
    few_shot_s = time.time() - t0
    few_sdpa, few_km = ops.LAUNCHES, kops.LAUNCHES
    check(few_sdpa == sdpa_a + sdpa_b, f"few-shot: sdpa_estimator launched {few_sdpa} times")
    check(few_km == km_a + km_b, f"few-shot: kmeans launched {few_km} times")
    check(rops.LAUNCHES == dops.LAUNCHES == 0, "a zoo kernel launched in few-shot training")
    print(
        f"[path] few-shot: sdpa_estimator launches {few_sdpa} (expected {sdpa_a + sdpa_b}), "
        f"kmeans launches {few_km} (expected {km_a + km_b}) in {few_shot_s:.1f} s"
    )
    torch.cuda.empty_cache()

    # ---- the iterative baselines: counters from 0, read right after
    ops.LAUNCHES = kops.LAUNCHES = rops.LAUNCHES = rops.BACKWARD_LAUNCHES = dops.LAUNCHES = 0
    t0 = time.time()
    phase_baselines_a(line, one_shot_a)
    baselines_a_s = time.time() - t0
    t0 = time.time()
    phase_baselines_b(line)
    torch.cuda.synchronize()
    baselines_b_s = time.time() - t0
    launched = (ops.LAUNCHES, kops.LAUNCHES, rops.LAUNCHES, dops.LAUNCHES)
    check(launched == (0, 0, 0, 0), f"a kernel launched in the iterative baselines: {launched}")
    print(
        f"[path] iterative: sdpa_estimator launches {ops.LAUNCHES}, kmeans launches "
        f"{kops.LAUNCHES} (expected 0 and 0: FedCVT's Eq. 10 is plain ops, for its backward)"
    )
    del one_shot_a
    torch.cuda.empty_cache()

    # ---- few-shot + finetune: counters from 0, read right after
    ops.LAUNCHES = kops.LAUNCHES = rops.LAUNCHES = rops.BACKWARD_LAUNCHES = dops.LAUNCHES = 0
    t0 = time.time()
    sdpa_ft, km_ft = phase_finetune_a(line, few_shot_a_auc)
    torch.cuda.synchronize()
    finetune_s = time.time() - t0
    ft_sdpa, ft_km = ops.LAUNCHES, kops.LAUNCHES
    check(ft_sdpa == sdpa_ft, f"finetune: sdpa_estimator launched {ft_sdpa} times")
    check(ft_km == km_ft, f"finetune: kmeans launched {ft_km} times")
    check(rops.LAUNCHES == dops.LAUNCHES == 0, "a zoo kernel launched in few-shot + finetune")
    print(
        f"[path] finetune: sdpa_estimator launches {ft_sdpa} (expected {sdpa_ft}), kmeans "
        f"launches {ft_km} (expected {km_ft}) in {finetune_s:.1f} s"
    )

    # ---- the fault/* family: counters from 0, read right after
    torch.cuda.empty_cache()
    ops.LAUNCHES = kops.LAUNCHES = rops.LAUNCHES = rops.BACKWARD_LAUNCHES = dops.LAUNCHES = 0
    t0 = time.time()
    flt = phase_faults(line)
    torch.cuda.synchronize()
    faults_s = time.time() - t0
    flt_sdpa, flt_km = ops.LAUNCHES, kops.LAUNCHES
    check(flt_sdpa == flt["sdpa"], f"faults: sdpa_estimator launched {flt_sdpa} times")
    check(flt_km == flt["kmeans"], f"faults: kmeans launched {flt_km} times")
    check(rops.LAUNCHES == dops.LAUNCHES == 0, "a zoo kernel launched on the fault path")
    print(
        f"[path] faults: sdpa_estimator launches {flt_sdpa} (expected {flt['sdpa']}: one a "
        f"dropped party at ⑤, ⑥' and each evaluation, and few-shot's ③', one a party), kmeans "
        f"launches {flt_km} (expected {flt['kmeans']}: {ProtocolConfig().kmeans_iters + 2} a "
        f"one-shot or few-shot run; the iterative baselines launch none) in {faults_s:.1f} s"
    )

    # ---- the folds: counters from 0, read right after
    torch.cuda.empty_cache()
    ops.LAUNCHES = kops.LAUNCHES = rops.LAUNCHES = rops.BACKWARD_LAUNCHES = dops.LAUNCHES = 0
    t0 = time.time()
    fld = phase_folds(line, flt)
    torch.cuda.synchronize()
    folds_s = time.time() - t0
    fld_sdpa, fld_km = ops.LAUNCHES, kops.LAUNCHES
    check(fld_sdpa == fld["sdpa"], f"folds: sdpa_estimator launched {fld_sdpa} times, expected {fld['sdpa']}")
    check(fld_km == fld["kmeans"], f"folds: kmeans launched {fld_km} times, expected {fld['kmeans']}")
    check(rops.LAUNCHES == dops.LAUNCHES == 0, "a zoo kernel launched in the folds")
    print(
        f"[path] folds: sdpa_estimator launches {fld_sdpa} (expected {fld['sdpa']}: one a "
        f"(dropped party, anchor) pair at ⑤ and ⑥' over the whole group, one a dropping entry "
        f"at each evaluation, ③' one a party over the stacked entries), kmeans launches {fld_km} "
        f"(expected {fld['kmeans']}: {ProtocolConfig().kmeans_iters + 2} a folded group, against "
        f"{len(FAULT_NAMES) * len(FAULT_SEEDS) * (ProtocolConfig().kmeans_iters + 2)} for the "
        f"one-shot group by loop) in {folds_s:.1f} s"
    )
    del flt

    # ---- the mesh over the folds: counters from 0, read right after
    torch.cuda.empty_cache()
    _zero_counters()
    t0 = time.time()
    msh = phase_mesh(line)
    torch.cuda.synchronize()
    mesh_s = time.time() - t0
    msh_sdpa, msh_km = ops.LAUNCHES, kops.LAUNCHES
    check(msh_sdpa == msh["sdpa"], f"mesh: sdpa_estimator launched {msh_sdpa} times, expected {msh['sdpa']}")
    check(msh_km == msh["kmeans"], f"mesh: kmeans launched {msh_km} times, expected {msh['kmeans']}")
    check(rops.LAUNCHES == dops.LAUNCHES == 0, "a zoo kernel launched on the mesh")
    print(
        f"[path] mesh: sdpa_estimator launches {msh_sdpa} (expected {msh['sdpa']}: few-shot's ③', "
        f"one a party a slot), kmeans launches {msh_km} (expected {msh['kmeans']}: "
        f"{ProtocolConfig().kmeans_iters + 2} a slot a pass; the baselines and the finetune "
        f"session launch none) in {mesh_s:.1f} s, the iterative rows {msh['iterative_s']:.1f} s"
    )

    # ---- the scenario catalog: counters from 0, read right after
    torch.cuda.empty_cache()
    ops.LAUNCHES = kops.LAUNCHES = rops.LAUNCHES = rops.BACKWARD_LAUNCHES = dops.LAUNCHES = 0
    t0 = time.time()
    cat = phase_catalog(line)
    torch.cuda.synchronize()
    catalog_s = time.time() - t0
    cat_sdpa, cat_km = ops.LAUNCHES, kops.LAUNCHES
    check(cat_sdpa == cat["sdpa"], f"catalog: sdpa_estimator launched {cat_sdpa} times")
    check(cat_km == cat["kmeans"], f"catalog: kmeans launched {cat_km} times")
    check(rops.LAUNCHES == dops.LAUNCHES == 0, "a zoo kernel launched in the catalog")
    print(
        f"[path] catalog: sdpa_estimator launches {cat_sdpa} (expected {cat['sdpa']}: few-shot's "
        f"③', one fused launch of width K − 1 a party with a non-empty pool), kmeans launches "
        f"{cat_km} (expected {cat['kmeans']}: step ③, one batched search of "
        f"{ProtocolConfig().kmeans_iters + 2} launches a run) over {len(cat['runs'])} runs in "
        f"{catalog_s:.1f} s"
    )
    torch.cuda.empty_cache()

    cnn = ExtractorSpec(kind="cnn", rep_dim=128, widths=(32, 64, 128), blocks_per_stage=2)
    patches = make_art(cnn, [(16, 16, 3)] * 4, gen)
    torch.cuda.synchronize()

    # ---- the serving path: counters from 0, read right after
    ops.LAUNCHES = kops.LAUNCHES = rops.LAUNCHES = rops.BACKWARD_LAUNCHES = dops.LAUNCHES = 0
    phase_serving(art_b, gen, line)
    expected = phase_partial(art_b, gen, 4, line)
    expected += phase_partial(patches, gen, 3, line)
    expected += phase_deploy({"B": art_b, "A": art_a, "patches": patches}, gen, line)
    torch.cuda.synchronize()
    launches = ops.LAUNCHES
    check(launches == expected, f"sdpa_estimator launched {launches} times, expected {expected}")
    check(kops.LAUNCHES == 0, f"kmeans launched {kops.LAUNCHES} times in serving")
    check(rops.LAUNCHES == dops.LAUNCHES == 0, "a zoo kernel launched in VFL serving")
    print(f"[path] serving: sdpa_estimator launches {launches} (expected {expected})")

    t0 = time.time()
    phase_zoo_small(ZOO_ARCH, "zoo")
    zoo_small_s = time.time() - t0
    del art_b, art_a, patches
    torch.cuda.empty_cache()

    # ---- the model-zoo serving path: counters from 0, read right after
    torch.cuda.synchronize()
    ops.LAUNCHES = kops.LAUNCHES = rops.LAUNCHES = rops.BACKWARD_LAUNCHES = dops.LAUNCHES = 0
    t0 = time.time()
    zoo, zoo_cfg, zoo_params = phase_zoo(line)
    torch.cuda.synchronize()
    zoo_s = time.time() - t0
    check(ops.LAUNCHES == kops.LAUNCHES == 0, "a VFL kernel launched on the zoo path")
    print(
        f"[path] zoo: rmsnorm launches {zoo['rmsnorm']}, decode_attention launches "
        f"{zoo['decode_attention']} (each part exactly 65 / 32 per decode step, 65 / 0 per "
        f"prefill_fn and extractor forward) in {zoo_s:.1f} s"
    )

    # ---- the dry-run and the trace counter on the card: counters from 0, read right after
    _zero_counters()
    t0 = time.time()
    dry = phase_dryrun(line)
    roof = phase_roofline(zoo_cfg, zoo_params, line)
    torch.cuda.synchronize()
    roofline_s = time.time() - t0
    del zoo_params
    torch.cuda.empty_cache()
    roof_launches = {"rmsnorm": rops.LAUNCHES, "decode_attention": dops.LAUNCHES}
    check(ops.LAUNCHES == kops.LAUNCHES == rops.BACKWARD_LAUNCHES == 0, "a VFL kernel in [roofline]")
    per_step = ZOO_LAUNCHES[ZOO_ARCH]  # and the 2-layer step's 2·2 + 1 and 2
    want_roof = {"rmsnorm": (ROOFLINE_STEPS + 4) * per_step[0] + 5,
                 "decode_attention": (ROOFLINE_STEPS + 4) * per_step[1] + 2}
    check(roof_launches == want_roof, f"[roofline] launches {roof_launches}, not {want_roof}")
    check(roofline_s <= ROOFLINE_BUDGET_S, f"[dryrun] + [roofline] took {roofline_s:.1f} s")
    print(
        f"[path] roofline: rmsnorm launches {roof_launches['rmsnorm']}, decode_attention "
        f"launches {roof_launches['decode_attention']} ({ROOFLINE_STEPS + 4} full-width decode "
        f"steps, one under the counter, and one 2-layer step); [dryrun] {dry['wall']:.1f} s + "
        f"[roofline] {roof['wall']:.1f} s = {roofline_s:.1f} s (budget {ROOFLINE_BUDGET_S:.0f} s)"
    )

    t0 = time.time()
    for name in ZOO_FAMILIES + ZOO_LAST:
        phase_zoo_small(name, "zoo-families")
    phase_zoo_small(ZOO_ARCH, "zoo-families", window=ZOO_SMALL_WINDOW)
    families_small_s = time.time() - t0

    # ---- the zoo families at full width: counters from 0, read right after
    torch.cuda.synchronize()
    ops.LAUNCHES = kops.LAUNCHES = rops.LAUNCHES = rops.BACKWARD_LAUNCHES = dops.LAUNCHES = 0
    t0 = time.time()
    fam = {"rmsnorm": 0, "decode_attention": 0}
    for name in ZOO_FAMILIES + ZOO_LAST:  # one at a time: each frees the card before the next
        phase_zoo_serve(name, line, "zoo-families", fam)
    phase_zoo_serve(ZOO_ARCH, line, "zoo-families", fam, window=ZOO_WINDOW)
    torch.cuda.synchronize()
    families_s = time.time() - t0
    check(ops.LAUNCHES == kops.LAUNCHES == 0, "a VFL kernel launched on the zoo families' path")
    check(rops.BACKWARD_LAUNCHES == 0, "the RMSNorm backward launched in zoo serving")
    print(
        f"[path] zoo-families: rmsnorm launches {fam['rmsnorm']}, decode_attention launches "
        f"{fam['decode_attention']} (each part exactly granite 65 / 32, mamba2 97 / 0, zamba2 "
        f"89 / 6, deepseek-v2 13 / 0, qwen2-vl 9 / 4, seamless 73 / 24, windowed phi4 65 / 32 a "
        f"decode step, the same rmsnorm count and 0 a prefill_fn, seamless 122 / 0 a prefill_fn "
        f"and 49 / 0 an enc_out) in {families_s:.1f} s"
    )
    train, vfl, train_s, vfl_s = run_training_paths(line)

    # ---- the party processes: counters from 0, read right after (the
    # kernel launches in the card's two rank processes, each counting its own)
    _zero_counters()
    vst = phase_vfl_step(line)
    torch.cuda.synchronize()
    vst_km, want_vst = vst["kmeans"], vst["expected"]
    check(vst_km == want_vst, f"[vfl-step] kmeans launched {vst_km} times, expected {want_vst}")
    here = (ops.LAUNCHES, kops.LAUNCHES, rops.LAUNCHES, rops.BACKWARD_LAUNCHES, dops.LAUNCHES)
    check(here == (0,) * 5, f"[vfl-step] a kernel launched in the driving process: {here}")
    print(
        f"[path] vfl-step: kmeans launches {vst_km} (expected {want_vst}: kmeans_iters + 2 = "
        f"{vfl_step.PartyJob.kmeans_iters + 2} a rank a one-shot session, {vst['sessions']} "
        f"sessions on 2 card ranks; the vanilla steps launch none) in {vst['wall']:.1f} s"
    )
    print(
        f"[time] {time.time() - t_start:.1f} s from the build on; few-shot phases "
        f"{few_shot_s:.1f} s; baselines A {baselines_a_s:.1f} s, baselines B {baselines_b_s:.1f} "
        f"s, few-shot + finetune A {finetune_s:.1f} s, faults {faults_s:.1f} s, folds "
        f"{folds_s:.1f} s (the iterative folds {fld['iterative_s']:.1f} s, the frontier "
        f"{fld['frontier_s']:.1f} s), mesh {mesh_s:.1f} s (its iterative rows "
        f"{msh['iterative_s']:.1f} s), catalog "
        f"{catalog_s:.1f} s; the zoo's "
        f"share: kernel phases "
        f"{zoo_kernels_s:.1f} s, reduced zoo {zoo_small_s:.1f} s, full-width path {zoo_s:.1f} s, "
        f"reduced families {families_small_s:.1f} s, full-width families {families_s:.1f} s, "
        f"zoo-train {train_s:.1f} s, zoo-vfl {vfl_s:.1f} s; vfl-step {vst['wall']:.1f} s; "
        f"dryrun + roofline {roofline_s:.1f} s"
    )

    def entry(name, source, replaces, count, row):
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        out = {"name": name, "route": "cuda", "source": source, "replaces": replaces}
        out["launches"] = count
        out.update({k: row[k] for k in keys})
        extra = (
            "device_ms", "library_device_ms", "agreement", "host_us", "cold_device_ms",
            "library_cold_device_ms",
        )
        out.update({k: row[k] for k in extra if k in row})
        return out

    kernels = [
        entry(
            "sdpa_estimator",
            "src/repro_torch/kernels/sdpa_estimator/csrc/sdpa_estimator.cu",
            "src/repro/kernels/sdpa_estimator/kernel.py:38",
            launches + few_sdpa + ft_sdpa + cat_sdpa + flt_sdpa + fld_sdpa + msh_sdpa,
            sdpa_row,
        ),
        entry(
            "kmeans",
            "src/repro_torch/kernels/kmeans/csrc/kmeans_assign.cu",
            "src/repro/kernels/kmeans/kernel.py:32",
            km_launches + few_km + ft_km + cat_km + flt_km + fld_km + msh_km + vst_km,
            kmeans_row,
        ),
        entry(
            "rmsnorm",
            "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
            "src/repro/kernels/rmsnorm/kernel.py:21",
            zoo["rmsnorm"] + roof_launches["rmsnorm"] + fam["rmsnorm"] + train["rmsnorm"]
            + vfl["rmsnorm"],
            rms_row,
        ),
        entry(
            "rmsnorm_backward",
            "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
            # no TPU kernel: the reference's gradient of its jnp norm
            "src/repro/models/layers.py:54",
            train["rmsnorm_backward"] + vfl["rmsnorm_backward"],
            rms_bwd_row,
        ),
        entry(
            "decode_attention",
            "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention/kernel.py:25",
            zoo["decode_attention"] + roof_launches["decode_attention"] + fam["decode_attention"],
            decode_row,
        ),
    ]
    print(json.dumps({"kernels": kernels}))
    print(line)
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
