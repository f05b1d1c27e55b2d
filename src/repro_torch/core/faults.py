"""Fault injection: the server's and the parties' side of a ``FaultSpec``.

Counterpart of the fault helpers of ``repro.core.protocol`` at one seed. A
:class:`~repro_torch.scenarios.faults.FaultSpec` names one party fault; the
runners (``protocol.run_one_shot`` / ``run_few_shot`` and the iterative
baselines) apply it through these functions:

* ``drop_skip``: is a party's transfer at a protocol point missing (a
  dropout past its stage)? A missing transfer is not logged;
* ``dp_noised``: a ``dp_upload`` party's payload plus σ · std(payload) ·
  noise. The noise is an argument; the runners draw it with
  :func:`fault_noise` from a generator of the fault path's own, seeded from
  the run's seed, ``FAULT_STREAM`` and the protocol phase, so a fault never
  moves the run's other draws;
* ``reconstruct_dropped``: the server's Eq. 10 estimate of a dropped
  party's missing upload, softmax(H_a H̄_aᵀ/√d) H̄_k from the lowest
  surviving party a over the last payloads H̄ it holds, through the
  ``sdpa_estimator`` kernel on the card. A party that never uploaded (stale
  zeros) reconstructs to zeros;
* ``fault_step_valid``: one party's per-step commit mask of an SSL session
  (all zeros for a party that skips it, a straggler's leading whole epochs);
* ``faulted_test_reps``: the degraded evaluation view of the test reps;
* ``fault_diags``: the diagnostics every faulted run reports.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import estimator
from repro_torch.engine.local_ssl import SSLHParams, schedule_steps
from repro_torch.scenarios.faults import POINT_EVAL, FaultSpec

# The fault path's generators are seeded off this prime, apart from every
# seed the protocol draws itself (the reference's constant).
FAULT_STREAM = 15485863
# Protocol phases whose payloads a dp_upload fault noises (the reference's
# fold-in indices).
PHASE_UPLOAD1, PHASE_UPLOAD2, PHASE_UNALIGNED, PHASE_FINAL, PHASE_TEST = 1, 2, 3, 4, 5


def drop_skip(fault: Optional[FaultSpec], party: int, point: int) -> bool:
    """Is ``party``'s transfer at protocol ``point`` missing?"""
    return fault is not None and fault.drops(party, point)


def dp_applies(fault: Optional[FaultSpec], party: int) -> bool:
    """Does ``fault`` noise ``party``'s uploads?"""
    return (
        fault is not None
        and fault.kind == "dp_upload"
        and fault.party == party
        and fault.dp_sigma > 0
    )


def dp_noised(
    arr: torch.Tensor, fault: Optional[FaultSpec], party: int, noise: torch.Tensor
) -> torch.Tensor:
    """``arr`` + σ · std(arr) · ``noise`` (population std over the whole
    tensor, the noise cast to arr's dtype) when ``fault`` noises ``party``'s
    uploads, else ``arr`` itself. Bytes on the wire are unchanged."""
    if not dp_applies(fault, party):
        return arr
    scale = fault.dp_sigma * arr.std(correction=0)
    return arr + scale * noise.to(arr.dtype)


def fault_noise(seed: int, phase: int, like: torch.Tensor) -> torch.Tensor:
    """Standard normal f32 noise of ``like``'s shape and device from the
    fault path's generator for protocol ``phase`` of the run seeded
    ``seed`` (seeded from both and FAULT_STREAM, apart from the run's own
    generators)."""
    state = np.random.SeedSequence([seed, FAULT_STREAM, phase]).generate_state(1, np.uint64)[0]
    gen = torch.Generator(device=like.device).manual_seed(int(state) >> 1)
    return torch.randn(like.shape, generator=gen, device=like.device)


def dp_upload(
    arr: torch.Tensor, fault: Optional[FaultSpec], party: int, seed: int, phase: int
) -> torch.Tensor:
    """:func:`dp_noised` with the noise of ``phase`` drawn only where the
    fault noises ``party``."""
    if not dp_applies(fault, party):
        return arr
    return dp_noised(arr, fault, party, fault_noise(seed, phase, arr))


def reconstruct_dropped(
    reps: Sequence[torch.Tensor],
    stale: Sequence[torch.Tensor],
    fault: Optional[FaultSpec],
    point: int,
    record: Optional[list] = None,
) -> List[torch.Tensor]:
    """The server's view of the uploads at ``point``: ``reps`` with every
    party the fault drops there replaced by its Eq. 10 estimate from the
    lowest surviving party a, softmax(reps[a] stale[a]ᵀ/√d) stale[k], cast
    to reps[k]'s dtype. ``record`` (if given) receives each estimate's
    inputs and f32 output."""
    out = list(reps)
    if fault is None or fault.kind != "dropout":
        return out
    alive = [k for k in range(len(reps)) if not fault.drops(k, point)]
    for k in range(len(reps)):
        if not fault.drops(k, point):
            continue
        a = alive[0]
        est = estimator.sdpa_transform_batched(reps[a][None], stale[a][None], stale[k][None])[0]
        out[k] = est.to(reps[k].dtype)
        if record is not None:
            record.append(
                dict(point=point, party=k, anchor=a, query=reps[a], keys=stale[a],
                     values=stale[k], estimate=est)
            )
    return out


def fault_step_valid(
    fault: Optional[FaultSpec], party: int, n_labeled: int, hp: SSLHParams, skip_all: bool
) -> torch.Tensor:
    """(n_steps,) float32 commit mask of ``party``'s SSL session over
    ``n_labeled`` rows: all zeros with ``skip_all``; for a straggler, ones on
    its first ⌊epochs · fraction⌋ whole epochs; all ones otherwise."""
    n_steps = schedule_steps(n_labeled, hp)
    if skip_all:
        return torch.zeros(n_steps)
    if fault is not None and fault.kind == "straggler" and fault.party == party:
        steps_per_epoch = n_steps // max(hp.epochs, 1)
        active = int(hp.epochs * fault.epoch_fraction) * steps_per_epoch
        return (torch.arange(n_steps) < active).float()
    return torch.ones(n_steps)


def faulted_test_reps(
    test_reps: Sequence[torch.Tensor],
    fault: FaultSpec,
    h_o_final: Optional[Sequence[torch.Tensor]],
    noise: Optional[torch.Tensor] = None,
    record: Optional[list] = None,
) -> List[torch.Tensor]:
    """The degraded view of the test reps: a dropped party's are its Eq. 10
    estimate from the lowest survivor's test reps over the final overlap
    reps ``h_o_final`` (zeros when there are none: the iterative baselines);
    a dp_upload party's carry σ · std noise (``noise``; none when None).
    ``record`` as :func:`reconstruct_dropped`'s."""
    reps = list(test_reps)
    if fault.kind == "dp_upload":
        if noise is not None and fault.party < len(reps):
            reps[fault.party] = dp_noised(reps[fault.party], fault, fault.party, noise)
        return reps
    if fault.kind != "dropout":
        return reps
    if h_o_final is None:
        return [
            torch.zeros_like(r) if fault.drops(k, POINT_EVAL) else r for k, r in enumerate(reps)
        ]
    return reconstruct_dropped(reps, h_o_final, fault, POINT_EVAL, record)


def fault_diags(fault: Optional[FaultSpec], num_parties: int, metric: float) -> dict:
    """The fault diagnostics of a run: its kind, the parties left at
    evaluation, the metric it reached, and a dropout's stage."""
    d = {
        "fault_kind": fault.kind if fault is not None else "none",
        "parties_survived": (
            fault.parties_survived(num_parties) if fault is not None else num_parties
        ),
        "degraded_metric": float(metric),
    }
    if fault is not None and fault.kind == "dropout":
        d["fault_stage"] = fault.stage
    return d
