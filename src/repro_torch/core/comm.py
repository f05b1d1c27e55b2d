"""Communication ledger — the paper's two efficiency metrics.

Counterpart of ``repro.core.comm``: ``comm times`` is the number of distinct
rounds a client takes part in (payloads that share a round id travel in one
message), ``comm cost`` the bytes moved between clients and server. Every
exchange of the port's protocol logs here, so both columns come from the
training code path. Byte counts are ``numel · element_size`` of the
tensors, which equals the reference's count for the same shapes and types.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch


def nbytes(x: Any) -> int:
    """Size in bytes of a tensor, or of a list / tuple / dict of them."""
    if torch.is_tensor(x):
        return x.numel() * x.element_size()
    if isinstance(x, dict):
        return sum(nbytes(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return sum(nbytes(v) for v in x)
    raise TypeError(f"cannot size a payload of type {type(x).__name__}")


@dataclass
class CommEvent:
    party: int  # client index (the server end of the link is implicit)
    direction: str  # "up" (client -> server) or "down" (server -> client)
    tag: str  # e.g. "reps_overlap", "partial_grads"
    bytes: int
    round: int = -1  # payloads sharing a round id travel in one message


@dataclass
class CommLedger:
    events: List[CommEvent] = field(default_factory=list)
    _round_counter: int = 0

    def next_round(self) -> int:
        self._round_counter += 1
        return self._round_counter

    def log_bytes(
        self, party: int, direction: str, tag: str, num_bytes: int, round: Optional[int] = None
    ) -> None:
        if direction not in ("up", "down"):
            raise ValueError(f"direction must be 'up' or 'down', got {direction!r}")
        if round is None:
            round = self.next_round()
        self.events.append(CommEvent(party, direction, tag, int(num_bytes), round))

    # -- the paper's metrics ------------------------------------------------
    def total_bytes(self) -> int:
        return sum(e.bytes for e in self.events)

    def total_megabytes(self) -> float:
        return self.total_bytes() / 2**20

    def comm_times(self, party: Optional[int] = None) -> int:
        """Distinct rounds ``party`` takes part in; without a party, the
        maximum over parties (the busiest client gates the session)."""
        if party is not None:
            return len({e.round for e in self.events if e.party == party})
        parties = {e.party for e in self.events}
        return max((self.comm_times(p) for p in parties), default=0)

    def by_tag(self) -> Dict[str, Tuple[int, int]]:
        out: Dict[str, Tuple[int, int]] = {}
        for e in self.events:
            cnt, byt = out.get(e.tag, (0, 0))
            out[e.tag] = (cnt + 1, byt + e.bytes)
        return out

    def summary(self) -> str:
        lines = [
            f"total: {self.total_megabytes():.2f} MB over "
            f"{self.comm_times()} comm times (busiest client)"
        ]
        for tag, (cnt, byt) in sorted(self.by_tag().items()):
            lines.append(f"  {tag:24s} x{cnt:<6d} {byt / 2**20:9.3f} MB")
        return "\n".join(lines)
