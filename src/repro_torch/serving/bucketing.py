"""Shape buckets of the serving engine (port of ``repro.serving.bucketing``).

With a dispatch service the engine scores buckets by its decode step
times (measured, else predicted: ``ServeSession._bucket_step_time``);
without one :func:`pick_bucket` takes the smallest batch that serves
every pending request, as the JAX session does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

from repro_torch.models.model_zoo import bucket_length


@dataclasses.dataclass(frozen=True, order=True)
class Bucket:
    """One serving shape class: ``batch`` rows of prompts padded to
    ``prompt_len`` decoding into a KV capacity of ``total_len``."""

    batch: int
    prompt_len: int
    total_len: int


def candidate_buckets(budgets: Sequence[int], prompt_len: int,
                      batch_sizes: Sequence[int],
                      ) -> List[Tuple[Bucket, int]]:
    """All (bucket, n_real) choices for a group of same-prompt-bucket
    requests with new-token ``budgets`` (FIFO order): one per allowed
    batch size, each serving ``min(batch, len(budgets))`` requests and
    sized for the budgets of the requests it would take."""
    if not budgets:
        raise ValueError("candidate_buckets needs a non-empty group")
    out = []
    for b in sorted(set(int(b) for b in batch_sizes)):
        if b < 1:
            continue
        n_real = min(b, len(budgets))
        nb = bucket_length(max(budgets[:n_real]))
        out.append((Bucket(b, prompt_len, prompt_len + nb), n_real))
    if not out:
        raise ValueError(f"no usable batch sizes in {batch_sizes!r}")
    return out


def pick_bucket(candidates: Sequence[Tuple[Bucket, int]],
                step_time: Optional[
                    Callable[[Bucket], Optional[float]]] = None,
                ) -> Tuple[Bucket, int]:
    """The bucket whose expected throughput is best (the JAX rule).

    ``step_time(bucket)`` returns the expected decode-step seconds of a
    bucket's shape, or None without a timing.  Scored candidates win by
    ``n_real / step_time``, ties toward the smaller batch; with no
    timing at all (or no ``step_time``), the smallest batch that serves
    every pending request, else the largest batch."""
    if not candidates:
        raise ValueError("pick_bucket needs at least one candidate")
    scored = []
    for bucket, n_real in candidates:
        t = step_time(bucket) if step_time is not None else None
        if t is not None and t > 0.0:
            scored.append((n_real / t, -bucket.batch, bucket, n_real))
    if scored:
        scored.sort(key=lambda x: (x[0], x[1]), reverse=True)
        _, _, bucket, n_real = scored[0]
        return bucket, n_real
    n_pending = max(n for _, n in candidates)
    fitting = [c for c in candidates if c[0].batch >= n_pending]
    if fitting:
        return min(fitting, key=lambda c: c[0].batch)
    return max(candidates, key=lambda c: c[0].batch)


__all__ = ["Bucket", "candidate_buckets", "pick_bucket"]
