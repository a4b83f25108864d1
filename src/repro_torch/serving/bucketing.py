"""Shape buckets of the serving engine (port of ``repro.serving.bucketing``).

The JAX session scores buckets by the dispatch service's measured step
times; the port has no dispatch service yet, so :func:`pick_bucket`
keeps only the JAX rule for when no timing exists.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

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


def pick_bucket(candidates: Sequence[Tuple[Bucket, int]]
                ) -> Tuple[Bucket, int]:
    """The smallest batch that serves every pending request, else the
    largest batch (the JAX rule when no step timing exists)."""
    if not candidates:
        raise ValueError("pick_bucket needs at least one candidate")
    n_pending = max(n for _, n in candidates)
    fitting = [c for c in candidates if c[0].batch >= n_pending]
    if fitting:
        return min(fitting, key=lambda c: c[0].batch)
    return max(candidates, key=lambda c: c[0].batch)


__all__ = ["Bucket", "candidate_buckets", "pick_bucket"]
