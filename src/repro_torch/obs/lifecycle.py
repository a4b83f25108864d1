"""Per-request lifecycle records: queued → admitted → prefill → first
token → decode steps → terminal state (the port's copy of
``repro.obs.lifecycle``).

``LifecycleLog`` is fed by the serving engine at each transition and
derives the two latencies operators actually page on: **TTFT**
(time-to-first-token, submit → first emitted token) and **per-token
latency** (decode-phase seconds per generated token).  Timestamps come
from whatever clock the owning :class:`~repro_torch.obs.Telemetry` was
built with, so tests drive it deterministically.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

__all__ = ["RequestLifecycle", "LifecycleLog"]


@dataclasses.dataclass
class RequestLifecycle:
    """Timeline of one request through the serving engine."""

    request_id: str
    submitted_ts: float
    admitted_ts: Optional[float] = None
    first_token_ts: Optional[float] = None
    last_token_ts: Optional[float] = None
    finished_ts: Optional[float] = None
    tokens: int = 0
    decode_steps: int = 0
    state: Optional[str] = None
    reason: Optional[str] = None

    @property
    def ttft_s(self) -> Optional[float]:
        """Submit → first token, seconds (None before first token)."""
        if self.first_token_ts is None:
            return None
        return self.first_token_ts - self.submitted_ts

    @property
    def queue_s(self) -> Optional[float]:
        """Submit → admission, seconds (None before admission)."""
        if self.admitted_ts is None:
            return None
        return self.admitted_ts - self.submitted_ts

    @property
    def per_token_s(self) -> Optional[float]:
        """Decode-phase seconds per token after the first.

        None until at least two tokens exist (the first token is
        produced by prefill, so decode latency needs a second one).
        """
        if (self.first_token_ts is None or self.last_token_ts is None
                or self.tokens < 2):
            return None
        return ((self.last_token_ts - self.first_token_ts)
                / (self.tokens - 1))

    def as_dict(self) -> Dict[str, Any]:
        """JSON-serialisable view including the derived latencies."""
        out = dataclasses.asdict(self)
        out["ttft_s"] = self.ttft_s
        out["queue_s"] = self.queue_s
        out["per_token_s"] = self.per_token_s
        return out


class LifecycleLog:
    """Collects :class:`RequestLifecycle` records keyed by request id."""

    def __init__(self) -> None:
        """Create an empty log."""
        self.records: Dict[str, RequestLifecycle] = {}

    def submitted(self, request_id: str, ts: float) -> RequestLifecycle:
        """Open a record at submit time (idempotent per id)."""
        rec = self.records.get(request_id)
        if rec is None:
            rec = RequestLifecycle(request_id=request_id, submitted_ts=ts)
            self.records[request_id] = rec
        return rec

    def admitted(self, request_id: str, ts: float) -> None:
        """Mark admission into the engine."""
        rec = self.records.get(request_id)
        if rec is not None:
            rec.admitted_ts = ts

    def token(self, request_id: str, ts: float, n: int = 1) -> None:
        """Record ``n`` emitted tokens; the first sets ``first_token_ts``."""
        rec = self.records.get(request_id)
        if rec is None:
            return
        if rec.tokens == 0:
            rec.first_token_ts = ts
        rec.tokens += n
        rec.last_token_ts = ts

    def decode_step(self, request_id: str) -> None:
        """Count one decode step the request participated in."""
        rec = self.records.get(request_id)
        if rec is not None:
            rec.decode_steps += 1

    def terminal(self, request_id: str, ts: float, state: str,
                 reason: Optional[str] = None) -> None:
        """Close the record with its terminal state."""
        rec = self.records.get(request_id)
        if rec is not None:
            rec.finished_ts = ts
            rec.state = state
            rec.reason = reason

    def ttft_values(self) -> List[float]:
        """All recorded TTFTs (requests that produced a first token)."""
        return [rec.ttft_s for rec in self.records.values()
                if rec.ttft_s is not None]

    def as_dicts(self) -> List[Dict[str, Any]]:
        """Every record as a dict, ordered by submit time then id."""
        recs = sorted(self.records.values(),
                      key=lambda r: (r.submitted_ts, r.request_id))
        return [r.as_dict() for r in recs]
