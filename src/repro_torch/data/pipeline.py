"""Deterministic, shardable, checkpointable synthetic LM data pipeline
(the port's own copy of ``repro.data.pipeline``, numpy only: its batches
equal the JAX package's element for element).

* **Stateless sharding**: batch ``i`` for host-shard ``(k of n)`` is a
  pure function of ``(seed, i, k, n)``, so any host can recompute any
  shard, and a restore is exact after elastic resharding (the *global*
  batch of step ``i`` is the same for any ``n``).
* **Checkpointable**: the pipeline's state is its step counter.
* **Prefetch**: a background thread keeps ``prefetch`` batches ready.

The synthetic stream is a Zipf-ish token distribution with a
deterministic per-step generator; labels are the next token, the final
position masked (-1).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """The stream: vocabulary, sequence length, global batch, seed, and
    ``extra`` modality stubs (``name -> (shape suffix, dtype)``, drawn
    standard normal after the tokens)."""
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


def _rng_for(seed: int, step: int) -> np.random.Generator:
    """The generator of one step: a pure function of (seed, step)."""
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


def global_batch(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """The full (unsharded) batch for a step — pure function."""
    rng = _rng_for(cfg.seed, step)
    b, s = cfg.global_batch, cfg.seq_len
    # Zipf-ish: mix of a few frequent and many rare tokens.
    u = rng.random((b, s + 1))
    toks = np.floor((cfg.vocab_size - 1) * u ** 3).astype(np.int32)
    batch = {"tokens": toks[:, :s],
             "labels": np.concatenate(
                 [toks[:, 1:s], np.full((b, 1), -1, np.int32)], axis=1)}
    for name, (suffix, dtype) in cfg.extra.items():
        batch[name] = rng.standard_normal((b, *suffix)).astype(dtype)
    return batch


def shard_batch(batch: Dict[str, np.ndarray], shard: int,
                num_shards: int) -> Dict[str, np.ndarray]:
    """Rows ``[shard * n, (shard + 1) * n)`` of every field, ``n`` the
    batch over ``num_shards``."""
    out = {}
    for k, v in batch.items():
        if v.shape[0] % num_shards:
            raise ValueError(f"{k}: batch {v.shape[0]} does not split "
                             f"into {num_shards} shards")
        n = v.shape[0] // num_shards
        out[k] = v[shard * n:(shard + 1) * n]
    return out


@dataclasses.dataclass
class PipelineState:
    """The pipeline's checkpointable state: the next step it yields."""
    step: int = 0

    def to_dict(self) -> Dict[str, int]:
        """JSON-ready form."""
        return {"step": self.step}

    @staticmethod
    def from_dict(d: Dict[str, int]) -> "PipelineState":
        """Inverse of :meth:`to_dict`."""
        return PipelineState(step=int(d["step"]))


class DataPipeline:
    """Iterator with background prefetch and restorable state."""

    def __init__(self, cfg: DataConfig, shard: int = 0,
                 num_shards: int = 1, prefetch: int = 2,
                 state: Optional[PipelineState] = None):
        """Start the producer thread at ``state.step`` (0 by default)."""
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards
        self.state = state or PipelineState()
        self._q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        self._next_to_produce = self.state.step
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self) -> None:
        """Make the batches in step order until :meth:`close`."""
        while not self._stop.is_set():
            step = self._next_to_produce
            batch = shard_batch(global_batch(self.cfg, step), self.shard,
                                self.num_shards)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            self._next_to_produce = step + 1

    def next(self) -> Dict[str, np.ndarray]:
        """The next step's batch (this shard's rows)."""
        step, batch = self._q.get()
        # steps arrive in order: the producer makes them one by one
        if step != self.state.step:
            raise RuntimeError(f"pipeline produced step {step}, expected "
                               f"{self.state.step}")
        self.state.step += 1
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        """Endless :meth:`next`."""
        while True:
            yield self.next()

    def close(self) -> None:
        """Stop the producer and join it."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)


__all__ = ["DataConfig", "DataPipeline", "PipelineState", "global_batch",
           "shard_batch"]
