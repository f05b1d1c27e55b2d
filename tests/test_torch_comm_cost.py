"""``benchmarks/torch_comm_cost.py`` (the port's ledgers at the paper's
scale) against the reference's ``benchmarks/comm_cost.py`` and against the
port's own protocol runs."""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmarks import comm_cost as ref  # noqa: E402
from benchmarks import torch_comm_cost as port  # noqa: E402
from repro_torch import scenarios  # noqa: E402
from repro_torch.core.protocol import ProtocolConfig, run_few_shot  # noqa: E402

# The reference script charges ② a 4-byte cluster count C a client that
# neither package's protocol logs: its one-shot and few-shot ledgers are 8
# bytes above the protocols' (and the port's).
REF_C_BYTES = 2 * 4


@pytest.mark.parametrize("n_o", sorted(port.PAPER_ITERATIONS))
def test_ledgers_equal_the_reference_scripts(n_o):
    van, one, few = port.ledgers()[n_o]
    n_u = (port.CIFAR_ROWS - n_o) // 2
    want_van = ref.vanilla_ledger(port.PAPER_ITERATIONS[n_o])
    want_one, want_few = ref.one_shot_ledger(n_o), ref.few_shot_ledger(n_o, n_u)
    assert (van.total_bytes(), van.comm_times()) == (want_van.total_bytes(), want_van.comm_times())
    assert one.total_bytes() == want_one.total_bytes() - REF_C_BYTES
    assert few.total_bytes() == want_few.total_bytes() - REF_C_BYTES
    assert one.comm_times() == want_one.comm_times() == 3
    assert few.comm_times() == want_few.comm_times() == 5
    assert van.total_bytes() / one.total_bytes() > 330


def test_paper_scale_ratio_and_main(capsys):
    van, one, _ = port.ledgers()[2048]
    assert (van.total_bytes(), one.total_bytes()) == (2_097_152_000, 6_291_456)
    assert port.main() == 0
    assert "comm/reduction/overlap2048,,,ratio=333.3x" in capsys.readouterr().out


def test_few_shot_ledger_is_the_protocols():
    """The benchmark's few-shot events, at hard/overlap-32's shapes, are a
    real ``run_few_shot``'s, event for event."""
    spec = scenarios.HARD_OVERLAP_32
    bundle = scenarios.build(spec, seed=0, device="cpu")
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = run_few_shot(
            0,
            bundle.split,
            bundle.extractors,
            bundle.ssl_cfgs,
            ProtocolConfig(client_epochs=1, server_epochs=1),
            device="cpu",
        )
    finally:
        torch.set_num_threads(before)
    n_u = {u.shape[0] for u in bundle.split.unaligned}
    assert len(n_u) == 1
    want = port.few_shot_ledger(spec.overlap, n_u.pop(), rep_dim=spec.rep_dim)
    assert [e.__dict__ for e in res.ledger.events] == [e.__dict__ for e in want.events]
