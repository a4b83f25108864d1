"""ServeSession: the in-flight serving engine for greedy traffic of the
dense and ssm families (port of ``repro.serving.session``).

Requests are submitted to a queue and served by :meth:`ServeSession.drain`
through a step loop over a fixed set of engine rows.  For the dense
family the rows are backed by a block-paged KV pool
(:mod:`repro_torch.serving.paged_kv`); at every step boundary the engine

1. retires finished rows and frees their KV blocks,
2. compacts the pool when its fragmentation passes 1/2,
3. admits queued requests in FIFO order while a row is free and the
   allocator fits the request's whole ``prompt + budget - 1`` footprint:
   a batch-1 left-padded masked prefill (flash attention), whose prompt
   K/V is scattered into the row's pool blocks, and
4. runs one paged ``decode_step`` over all rows (paged decode attention).

For the ssm family a row's state is O(1): there is no allocator, block
table or compaction.  The pool is ``init_cache(rows, cap)``; admission
runs the same batch-1 masked prefill (the selective-scan kernel) and
writes the row's final SSM and conv states into row ``r`` of every
layer, in place; each boundary runs one recurrent ``decode_step`` over
all rows.

The prefill and decode steps come from the session's
:class:`~repro_torch.serving.cache.ExecutableCache`, keyed as the JAX
session keys them: one batch-1 prefill step per prompt bucket, shared
by every activation and by ``generate(session=)``, and one decode step
per engine geometry, whose entry owns the pool (a CUDA graph holds its
addresses; it is zeroed at each activation's start, so a run equals
one on a fresh pool).  An ssm decode key carries no detail, so it can
equal ``generate``'s: both build it with the same
:func:`~repro_torch.serving.captured.recurrent_decode_step`.  On a card each step is a captured CUDA graph
(:class:`~repro_torch.serving.captured.CapturedStep`); ``capture=False``
runs the same steps eagerly, and on the CPU they always run directly.
A step's tokens, positions and block tables go in through pinned
buffers, and its argmax and finiteness flags come out in one copy to
the host a step.

Every request ends in a terminal :class:`RequestState`.  A request whose
footprint can never fit the pool is REJECTED; a row whose logits are
not finite (checked at every step) is retired FAILED without touching
the others.  Kernel and capture failures are not caught: a CUDA error
raises out of :meth:`drain` (the JAX session's degrade-to-reference
path, dispatch, telemetry, watchdog, recorder, deadlines and
cancellation are not ported yet).
"""
from __future__ import annotations

import dataclasses
import itertools
import logging
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.attention import BACKENDS
from repro_torch.models.model_zoo import (Model, bucket_length,
                                          left_pad_prompts)
from repro_torch.models.transformer import SERVED_FAMILIES
from repro_torch.serving.bucketing import (Bucket, candidate_buckets,
                                           pick_bucket)
from repro_torch.serving.cache import ExecKey, ExecutableCache
from repro_torch.serving.captured import (CapturedStep, pick, prefill_step,
                                          recurrent_decode_step)
from repro_torch.serving.paged_kv import BlockAllocator, blocks_needed

log = logging.getLogger("repro_torch.serving")

_REQUEST_IDS = itertools.count()
_NULL_BUCKET = Bucket(0, 0, 0)


class RequestState:
    """Terminal request states.

    * ``COMPLETED`` — full decode budget delivered.
    * ``REJECTED`` — the request's KV footprint exceeds the whole pool
      (attention families).
    * ``FAILED`` — non-finite logits retired the row (partial tokens).
    """

    COMPLETED = "COMPLETED"
    REJECTED = "REJECTED"
    FAILED = "FAILED"


@dataclasses.dataclass
class Request:
    """One submitted generation request (a single sequence)."""

    tokens: np.ndarray              # [S] int32 prompt
    max_new_tokens: int
    request_id: str
    submitted_at: float             # session clock at submission


@dataclasses.dataclass
class RequestResult:
    """Per-request outcome returned by :meth:`ServeSession.drain`."""

    request_id: str
    tokens: np.ndarray              # [<= max_new_tokens] int32
    bucket: Bucket
    queue_s: float                  # submission -> admission
    stats: Any                      # the activation's ServeStats (shared)
    state: str = RequestState.COMPLETED
    reason: Optional[str] = None


@dataclasses.dataclass
class SessionStats:
    """What the engine did, over the session's life."""

    requests: int = 0
    batches: int = 0                # engine activations
    tokens_generated: int = 0       # every delivered token
    decode_tokens: int = 0          # tokens made by decode steps only
    prefill_s: float = 0.0
    decode_s: float = 0.0
    steps: int = 0                  # engine decode steps
    inflight_admissions: int = 0    # requests admitted at step boundaries
    compactions: int = 0            # pool defragmentation passes
    rejected: int = 0
    failed: int = 0
    poisoned_rows: int = 0          # rows retired on non-finite logits
    queue_s: List[float] = dataclasses.field(default_factory=list)
    ttft_s: List[float] = dataclasses.field(default_factory=list)
    per_bucket: Dict[Bucket, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    cache: Dict[str, int] = dataclasses.field(default_factory=dict)
    capture_s: float = 0.0          # building steps (warm-up + capture)
    graph_pool_bytes: int = 0       # the built graphs' private pools

    @staticmethod
    def _pcts(xs: List[float]) -> Tuple[float, float]:
        """(p50, p95) of ``xs`` (0.0 with no samples)."""
        if not xs:
            return 0.0, 0.0
        a = np.asarray(xs, dtype=np.float64)
        return float(np.percentile(a, 50)), float(np.percentile(a, 95))

    def queue_percentiles(self) -> Tuple[float, float]:
        """(p50, p95) queue latency in seconds."""
        return self._pcts(self.queue_s)

    def ttft_percentiles(self) -> Tuple[float, float]:
        """(p50, p95) time to first token in seconds."""
        return self._pcts(self.ttft_s)

    def to_dict(self) -> Dict[str, Any]:
        """JSON-ready summary (what ``launch/serve`` prints)."""
        q50, q95 = self.queue_percentiles()
        t50, t95 = self.ttft_percentiles()
        hits = self.cache.get("hits", 0)
        lookups = hits + self.cache.get("misses", 0)
        return {
            "requests": self.requests,
            "batches": self.batches,
            "tokens_generated": self.tokens_generated,
            "decode_tokens": self.decode_tokens,
            "prefill_s": self.prefill_s,
            "decode_s": self.decode_s,
            # a request's first token comes from its prefill, so only
            # decode-step tokens are divided by decode-step time
            "decode_tok_s": (self.decode_tokens
                             / max(self.decode_s, 1e-9)),
            "steps": self.steps,
            "inflight_admissions": self.inflight_admissions,
            "compactions": self.compactions,
            "rejected": self.rejected,
            "failed": self.failed,
            "poisoned_rows": self.poisoned_rows,
            "queue_p50_s": q50,
            "queue_p95_s": q95,
            "ttft_p50_s": t50,
            "ttft_p95_s": t95,
            "cache": dict(self.cache),
            "cache_hit_rate": hits / lookups if lookups else 0.0,
            "capture_s": self.capture_s,
            "graph_pool_bytes": self.graph_pool_bytes,
            "buckets": {
                f"b{b.batch}xp{b.prompt_len}xt{b.total_len}": {
                    **{k: float(v) for k, v in e.items()},
                    "tok_s": (e["decode_tokens"]
                              / max(e["decode_s"], 1e-9)),
                }
                for b, e in sorted(self.per_bucket.items())
            },
        }


class ServeSession:
    """Persistent serving engine: queue, paged KV pool, step loop.

    ``backend`` is ``"cuda"`` (the hand-written kernels; their wrappers
    run the plain versions when the parameters live on the CPU) or
    ``"plain"``.  ``batch_sizes`` are the allowed engine row counts,
    ``kv_block_size`` the token slots per pool block and ``kv_blocks``
    the pool size (None sizes it so every row reaches its full
    capacity); both apply to attention families only.  Prompts are
    left-padded with token 0 to power-of-two buckets.  The session runs
    where ``params`` live.

    ``cache_capacity`` bounds the executable cache (LRU by entry).
    ``capture`` False runs the cached steps eagerly on a card (one
    launch per op, to time the eager path; the counterpart of the JAX
    session's un-lowered jit step), never chosen by a failure.
    """

    def __init__(self, model: Model, params, *, backend: str = "cuda",
                 batch_sizes: Sequence[int] = (1, 2, 4, 8),
                 kv_block_size: int = 16, kv_blocks: Optional[int] = None,
                 cache_capacity: int = 16, capture: bool = True):
        """Validate the knobs and start with an empty queue."""
        if model.cfg.family not in SERVED_FAMILIES:
            raise NotImplementedError(
                f"the port's engine serves the "
                f"{' and '.join(SERVED_FAMILIES)} families, got "
                f"{model.cfg.family!r}")
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}")
        self.model = model
        self.params = params
        self.device = params["embed"].device
        self.backend = backend
        self.batch_sizes = tuple(sorted(set(int(b) for b in batch_sizes)))
        if not self.batch_sizes or self.batch_sizes[0] < 1:
            raise ValueError(
                f"batch_sizes must be positive ints, got {batch_sizes!r}")
        if kv_block_size < 1:
            raise ValueError("kv_block_size must be >= 1")
        if kv_blocks is not None and kv_blocks < 2:
            raise ValueError(
                "kv_blocks must be >= 2 (block 0 is the reserved sink)")
        self.kv_block_size = int(kv_block_size)
        self.kv_blocks = None if kv_blocks is None else int(kv_blocks)
        self.capture = bool(capture)
        self.exec_cache = ExecutableCache(cache_capacity)
        self.stats = SessionStats()
        self._queue: List[Request] = []
        self._clock = time.perf_counter

    # ------------------------------------------------------ admission
    def submit(self, tokens, max_new_tokens: int,
               request_id: Optional[str] = None) -> str:
        """Queue one request (a 1-D prompt); returns its id."""
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        prompt = np.asarray(tokens, dtype=np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must contain at least one token")
        rid = (request_id if request_id is not None
               else f"req-{next(_REQUEST_IDS)}")
        self._queue.append(Request(tokens=prompt,
                                   max_new_tokens=int(max_new_tokens),
                                   request_id=rid,
                                   submitted_at=self._clock()))
        return rid

    def pending(self) -> int:
        """Requests queued but not yet admitted."""
        return len(self._queue)

    def _prompt_bucket(self, request: Request) -> int:
        """Padded prompt length (the request's shape class)."""
        return bucket_length(len(request.tokens))

    def _reject(self, req: Request, reason: str,
                sink: List[RequestResult]) -> None:
        """Terminal REJECTED result for a request that never fits."""
        log.warning("request %s rejected: %s", req.request_id, reason)
        sink.append(RequestResult(
            request_id=req.request_id, tokens=np.zeros((0,), np.int32),
            bucket=_NULL_BUCKET, queue_s=self._clock() - req.submitted_at,
            stats=None, state=RequestState.REJECTED, reason=reason))
        self.stats.requests += 1
        self.stats.rejected += 1

    def drain(self, on_step=None) -> List[RequestResult]:
        """Serve every queued request; results in completion order.

        ``on_step(info)`` is called after every decode step with
        ``{"step", "active", "pending", "free_blocks"}``; it may submit
        more requests, which are admitted at the next step boundary."""
        results: List[RequestResult] = []
        while self._queue:
            results.extend(self._drain_inflight(on_step))
        return results

    # ------------------------------------------------------ execution
    def _compile(self, key: ExecKey, builder) -> Tuple[Any, bool]:
        """Step for ``key`` via the shared cache: ``(step, was_hit)``.
        A build's warm-up and capture time and its graph's pool are
        added to the stats."""
        step, hit = self.exec_cache.get(key, builder)
        if not hit:
            self.stats.capture_s += step.build_s
            self.stats.graph_pool_bytes += step.pool_bytes
        self.stats.cache = self.exec_cache.stats()
        return step, hit

    def _decode_builder(self, pool: Dict[str, Any], rows: int,
                        max_blocks: Optional[int]):
        """Builder of the engine's decode step over ``pool``: the paged
        step (tokens, per-row positions, block tables) for dense, the
        recurrent step (:func:`recurrent_decode_step`, which
        ``generate`` shares) for ssm; outputs :func:`pick` of the
        logits.  The step owns ``pool``."""
        model, params, dev = self.model, self.params, self.device
        backend = self.backend
        if max_blocks is None:
            return lambda: recurrent_decode_step(
                model, params, backend, rows, self.capture,
                layers=pool["layers"])

        def build() -> CapturedStep:
            """Static inputs, the step function and its capture."""
            inputs = {"tokens": torch.zeros((rows, 1), dtype=torch.int64,
                                            device=dev),
                      "pos": torch.zeros((rows,), dtype=torch.int64,
                                         device=dev),
                      "tables": torch.zeros((rows, max_blocks),
                                            dtype=torch.int32, device=dev)}

            def fn():
                """One paged decode step over all rows."""
                lg, _ = model.decode_step(
                    params, pool, inputs["tokens"], inputs["pos"],
                    backend=backend, block_tables=inputs["tables"])
                return pick(lg[:, -1])

            return CapturedStep(fn, dev, inputs=inputs,
                                state=pool["layers"], capture=self.capture)
        return build

    # ------------------------------------------- in-flight engine
    def _drain_inflight(self, on_step=None) -> List[RequestResult]:
        """One engine activation: a fixed (rows, block-table) geometry
        that serves requests at step granularity until the queue and all
        rows are empty, or the head request needs a wider table (it then
        waits for the next activation).  A recurrent (ssm) activation
        has rows only: no allocator, block table or compaction."""
        # here, not at the top: the serve loop imports this package
        from repro_torch.runtime.serve_loop import ServeStats
        model, params, dev = self.model, self.params, self.device
        cfg = model.cfg
        backend = self.backend
        attn_family = cfg.family == "dense"

        head = self._queue[0]
        s_pad = self._prompt_bucket(head)
        budgets = [r.max_new_tokens for r in self._queue
                   if self._prompt_bucket(r) == s_pad]
        cands = candidate_buckets(budgets, s_pad, self.batch_sizes)
        picked, _ = pick_bucket(cands)
        rows_n = picked.batch
        cap = max(self._prompt_bucket(r) + bucket_length(r.max_new_tokens)
                  for r in self._queue)
        cap = max(cap, picked.total_len)
        bs = self.kv_block_size
        if attn_family:
            max_blocks = blocks_needed(cap, bs)
            cap = max_blocks * bs       # gather extent == table reach
            n_blocks = (1 + rows_n * max_blocks if self.kv_blocks is None
                        else self.kv_blocks)
            alloc = BlockAllocator(n_blocks, bs)
            tables_np = np.zeros((rows_n, max_blocks), np.int32)
            detail = ("paged", bs, max_blocks)
        else:
            alloc = tables_np = max_blocks = detail = None
        decode_key = ExecKey(cfg.name, "decode", rows_n, cap, None,
                             backend, detail)
        # The pool belongs to the geometry's decode step, whose graph
        # holds its addresses: a cached step's pool is reused, zeroed.
        # The step itself is looked up at the first decode step, as the
        # JAX engine compiles it there.
        cached = self.exec_cache.peek(decode_key)
        if cached is not None:
            pool = {"layers": cached.state}
            for t in pool["layers"].values():
                t.zero_()
        elif attn_family:
            pool = model.init_paged_cache(n_blocks, bs, dev)
        else:
            pool = model.init_cache(rows_n, cap, dev)
        build_decode = self._decode_builder(pool, rows_n, max_blocks)
        engine_bucket = Bucket(rows_n, s_pad, cap)
        act_stats = ServeStats(prefill_s=0.0, decode_s=0.0,
                               tokens_generated=0, backend=backend)

        row_req: List[Optional[Request]] = [None] * rows_n
        row_blocks: List[List[int]] = [[] for _ in range(rows_n)]
        row_remaining = [0] * rows_n
        row_out: List[List[int]] = [[] for _ in range(rows_n)]
        row_wait = [0.0] * rows_n
        row_fate: Dict[int, Tuple[str, Optional[str]]] = {}
        pos_np = np.zeros((rows_n,), np.int32)
        tok_np = np.zeros((rows_n,), np.int32)
        results: List[RequestResult] = []
        entry = self.stats.per_bucket.setdefault(
            engine_bucket, {"batches": 0, "tokens": 0, "decode_tokens": 0,
                            "decode_s": 0.0})

        def retire(r: int) -> None:
            """Finish row r (COMPLETED unless row_fate says otherwise),
            free its blocks and emit its result."""
            req = row_req[r]
            state, reason = row_fate.pop(r, (RequestState.COMPLETED, None))
            results.append(RequestResult(
                request_id=req.request_id,
                tokens=np.asarray(row_out[r], np.int32),
                bucket=engine_bucket, queue_s=row_wait[r],
                stats=act_stats, state=state, reason=reason))
            delivered = len(row_out[r])
            act_stats.tokens_generated += delivered
            self.stats.tokens_generated += delivered
            entry["tokens"] += delivered
            self.stats.requests += 1
            if state == RequestState.FAILED:
                self.stats.failed += 1
            self.stats.queue_s.append(row_wait[r])
            if attn_family and row_blocks[r]:
                alloc.free(row_blocks[r])
                tables_np[r, :] = 0
            row_req[r] = None
            row_blocks[r] = []
            row_out[r] = []
            pos_np[r] = 0
            tok_np[r] = 0

        def place(pool_t: torch.Tensor, pre: torch.Tensor, r: int,
                  length: int, p_len: int) -> None:
            """Scatter one prompt's real K or V ([L,1,HKV,p_len,hd]) into
            row r's first blocks; the tail of the last block is zeroed
            and later overwritten by decode writes.  In place
            (``index_copy_``) where the JAX engine rebuilds the pool."""
            nbp = blocks_needed(length, bs)
            real = pre[:, 0, :, p_len - length:, :].to(pool_t.dtype)
            ln, hkv, _, hd = real.shape
            padded = torch.zeros((ln, hkv, nbp * bs, hd),
                                 dtype=pool_t.dtype, device=dev)
            padded[:, :, :length, :] = real
            blocked = padded.reshape(ln, hkv, nbp, bs, hd).permute(
                0, 2, 1, 3, 4)
            idx = torch.as_tensor(row_blocks[r][:nbp], dtype=torch.int64,
                                  device=dev)
            pool_t.index_copy_(1, idx, blocked)

        def admit(req: Request, r: int) -> bool:
            """Prefill req into row r and scatter its K/V (or write its
            recurrent state); False (request FAILED, row still free) on
            non-finite prefill logits."""
            length = len(req.tokens)
            p_len = self._prompt_bucket(req)
            row_wait[r] = self._clock() - req.submitted_at
            if attn_family:
                nb = blocks_needed(length + req.max_new_tokens - 1, bs)
                row_blocks[r] = alloc.alloc(nb)
                tables_np[r, :] = 0
                tables_np[r, :nb] = row_blocks[r]
            pf, _ = self._compile(
                ExecKey(cfg.name, "prefill", 1, p_len, None, backend),
                lambda: prefill_step(model, params, backend, 1, p_len,
                                     self.capture))
            t0 = time.perf_counter()
            pf.feed(tokens=left_pad_prompts([req.tokens], p_len),
                    starts=np.asarray([p_len - length]))
            picked, pcache = pf.replay()
            # one copy to the host: it waits for the card
            first, finite = picked[:, 0].cpu().tolist()
            dt = time.perf_counter() - t0
            act_stats.prefill_s += dt
            self.stats.prefill_s += dt
            if not finite:
                self.stats.poisoned_rows += 1
                log.warning("admission of %s failed: non-finite prefill "
                            "logits", req.request_id)
                if attn_family:
                    alloc.free(row_blocks[r])
                    row_blocks[r] = []
                    tables_np[r, :] = 0
                results.append(RequestResult(
                    request_id=req.request_id,
                    tokens=np.zeros((0,), np.int32), bucket=engine_bucket,
                    queue_s=row_wait[r], stats=act_stats,
                    state=RequestState.FAILED,
                    reason="non-finite prefill logits"))
                self.stats.requests += 1
                self.stats.failed += 1
                return False
            if attn_family:
                for name in ("k", "v"):
                    place(pool["layers"][name], pcache["layers"][name], r,
                          length, p_len)
            else:
                # a recurrent state is O(1) per row: write row r of
                # every layer, in place
                for name, t in pool["layers"].items():
                    t[:, r].copy_(pcache["layers"][name][:, 0])
            row_req[r] = req
            row_out[r] = [first]
            row_remaining[r] = req.max_new_tokens - 1
            pos_np[r] = length
            tok_np[r] = first
            self.stats.inflight_admissions += 1
            self.stats.ttft_s.append(self._clock() - req.submitted_at)
            return True

        step = None
        step_idx = 0
        while True:
            for r in range(rows_n):
                if row_req[r] is not None and row_remaining[r] <= 0:
                    retire(r)
            if (attn_family and alloc.num_live
                    and alloc.fragmentation() > 0.5):
                live = [row_blocks[r] for r in range(rows_n)
                        if row_blocks[r]]
                perm, moved = alloc.compact_tables(tables_np, live)
                if moved:
                    gather = torch.as_tensor(perm, dtype=torch.int64,
                                             device=dev)
                    for p in pool["layers"].values():
                        p.copy_(p.index_select(1, gather))
                    self.stats.compactions += 1
            while self._queue:
                free_rows = [r for r in range(rows_n) if row_req[r] is None]
                if not free_rows:
                    break
                nxt = self._queue[0]
                if attn_family:
                    needed = len(nxt.tokens) + nxt.max_new_tokens - 1
                    nb = blocks_needed(needed, bs)
                    if nb > alloc.n_blocks - 1:
                        self._queue.pop(0)
                        self._reject(nxt, f"needs {nb} KV blocks but the "
                                     f"pool holds {alloc.n_blocks - 1}; "
                                     f"raise kv_blocks", results)
                        continue
                    if needed > max_blocks * bs:
                        break   # wider table: next activation
                    if not alloc.can_fit(needed):
                        break   # backpressure: wait for retirements
                admit(self._queue.pop(0), free_rows[0])
            active = [r for r in range(rows_n) if row_req[r] is not None]
            if not active:
                break
            if not any(row_remaining[r] > 0 for r in active):
                continue        # budget-1 admissions retire at loop top
            if step is None:
                step, _ = self._compile(decode_key, build_decode)
            t_step = time.perf_counter()
            if attn_family:
                step.feed(tokens=tok_np, pos=pos_np, tables=tables_np)
            else:
                step.feed(tokens=tok_np)
            # one copy to the host a step: it waits for the card
            new_tok, finite = step.replay().cpu().numpy()
            dt = time.perf_counter() - t_step
            act_stats.decode_s += dt
            self.stats.decode_s += dt
            entry["decode_s"] += dt
            for r in active:
                if not finite[r]:
                    self.stats.poisoned_rows += 1
                    row_fate[r] = (RequestState.FAILED,
                                   f"non-finite logits at step {step_idx}")
                    row_remaining[r] = 0
                    continue
                if row_remaining[r] > 0:
                    t = int(new_tok[r])
                    row_out[r].append(t)
                    tok_np[r] = t
                    pos_np[r] += 1
                    row_remaining[r] -= 1
                    act_stats.decode_tokens += 1
                    self.stats.decode_tokens += 1
                    entry["decode_tokens"] += 1
            self.stats.steps += 1
            step_idx += 1
            if on_step is not None:
                on_step({"step": step_idx,
                         "active": [row_req[r].request_id
                                    for r in range(rows_n)
                                    if row_req[r] is not None],
                         "pending": len(self._queue),
                         "free_blocks": (alloc.num_free if attn_family
                                         else None)})
        self.stats.batches += 1
        entry["batches"] += 1
        return results


__all__ = ["Request", "RequestResult", "RequestState", "SessionStats",
           "ServeSession"]
