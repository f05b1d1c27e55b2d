"""Communication of the PyTorch port at the paper's scale (Tab. 1's columns).

    PYTHONPATH=src python benchmarks/torch_comm_cost.py

Ledger arithmetic, no training, on any host: two parties, 128-wide
representations, batch 32, and the paper's iterations per overlap size
(N_o 256, 512, 1024, 2048 at 4000, 8000, 16000, 32000). The vanilla ledger
comes from the port's own ``baselines.log_iterative_rounds``; the one-shot
and few-shot ledgers log the port's protocol events (tags, rounds, f32
payloads sized as ``protocol`` sizes them) through ``protocol._log_round``
on meta tensors, which carry shapes and no data. Prints one CSV row per
ledger and the vanilla / one-shot byte ratio, and asserts 3 and 5 comm
times and a ratio above 300 (333.3× at N_o = 2048: 2,097,152,000 against
6,291,456 bytes).
"""

from __future__ import annotations

import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.core import protocol  # noqa: E402
from repro_torch.core.baselines import log_iterative_rounds  # noqa: E402
from repro_torch.core.comm import CommLedger, nbytes  # noqa: E402

REP_DIM = 128  # WideResNet20 feature width at the paper's setting
BATCH = 32
PARTIES = 2
CIFAR_ROWS = 50000
PAPER_ITERATIONS = {256: 4000, 512: 8000, 1024: 16000, 2048: 32000}


def _reps(rows: int, width: int = REP_DIM) -> list:
    return [torch.empty((rows, width), device="meta")] * PARTIES


def vanilla_ledger(iterations: int) -> CommLedger:
    led = CommLedger()
    log_iterative_rounds(led, [REP_DIM] * PARTIES, iterations, BATCH)
    return led


def one_shot_ledger(n_o: int, rep_dim: int = REP_DIM) -> CommLedger:
    """①, ② and ⑤ of ``protocol.run_one_shot``: reps up, their gradients
    down, refreshed reps up."""
    led = CommLedger()
    protocol._log_round(led, "up", "reps_overlap", _reps(n_o, rep_dim))
    protocol._log_round(led, "down", "partial_grads", _reps(n_o, rep_dim))
    protocol._log_round(led, "up", "reps_overlap_refreshed", _reps(n_o, rep_dim))
    return led


def few_shot_ledger(n_o: int, n_u: int, rep_dim: int = REP_DIM) -> CommLedger:
    """``protocol.run_few_shot``: the one-shot rounds, H_u in the ⑤ round,
    p̂ down (④') and the final reps up (⑥')."""
    led = one_shot_ledger(n_o, rep_dim)
    r5 = max(e.round for e in led.events)
    for k, h in enumerate(_reps(n_u, rep_dim)):
        led.log_bytes(k, "up", "reps_unaligned", nbytes(h), round=r5)
    probs = [torch.empty(n_u, device="meta")] * PARTIES
    protocol._log_round(led, "down", "pseudo_label_probs", probs)
    protocol._log_round(led, "up", "reps_overlap_final", _reps(n_o, rep_dim))
    return led


def ledgers() -> dict:
    """{N_o: (vanilla, one-shot, few-shot)} at the paper's scale; the
    few-shot pools split the rest of CIFAR-10's 50000 rows in two."""
    return {
        n_o: (
            vanilla_ledger(iters),
            one_shot_ledger(n_o),
            few_shot_ledger(n_o, (CIFAR_ROWS - n_o) // 2),
        )
        for n_o, iters in PAPER_ITERATIONS.items()
    }


def main() -> int:
    print("name,bytes,comm_times,derived")
    for n_o, (van, one, few) in ledgers().items():
        ratio = van.total_bytes() / one.total_bytes()
        for name, led in (("vanilla", van), ("one_shot", one), ("few_shot", few)):
            print(
                f"comm/{name}/overlap{n_o},{led.total_bytes()},{led.comm_times()},"
                f"mb={led.total_megabytes():.2f}"
            )
        print(f"comm/reduction/overlap{n_o},,,ratio={ratio:.1f}x")
        assert one.comm_times() == 3 and few.comm_times() == 5
        assert ratio > 300, ratio
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
