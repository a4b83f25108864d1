"""Offline schedule search for the port's kernels on the H100.

The tuner enumerates the schedule space of each kernel (grid order x
block shapes, plus the resident RHS for matmul), scores the whole
enumeration with one batch call of the H100 cost model and ranks it.
The block candidates are the port's own, sized for a Hopper block
rather than the TPU's MXU and for the body the dtype runs: float32
(CUDA cores) channels around 16-128, pixels around 4-16 or the full
extent, matmul tiles around 32-128 and k chunks around 16-64 or the
whole k; bf16 (tensor cores) also channels up to 256, pixel tiles up to
28 a side (64-256 pixels fill the MMA's 16-row steps with little
padding), matmul rows of 64 or 128 (one or two warpgroups) and columns
of 16-256 (the wgmma widths).  Blocks always divide their dimensions,
and only schedules the CUDA kernels accept (``kernels/_geometry.py``,
the layout of the dtype's body) are ever returned, so a ranked
schedule never raises on the card.

The serving kernels offer only what their bodies take (``_geometry``'s
``error`` is None), by the problem's element size: flash bf16 64 or 128
query rows at the 64-key tile, float32 its single 64 x 32 tile; the
split decode ``block_kv`` (keys a block) in DECODE_SPLITS up
to the cache length, plus the split ``decode_plan`` picks by itself; the
scan ``block_d`` in SCAN_BLOCK_DS.

``cached_tune_*`` put the ranking behind the port's tuning registry: a
warm hit performs zero cost-model evaluations.  Each lookup counts on
the process metrics registry (``tune.warm_hits_total``,
``tune.sweeps_total``, ``tune.sweep_wall_s_total``,
``tune.cost_model_evals_total``, the JAX package's names).
"""
from __future__ import annotations

import itertools
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import cost_model as cm
from repro_torch.core import registry as reg
from repro_torch.core.loopnest import ConvLayer
from repro_torch.core.schedule import (ConvSchedule, DecodeAttentionSchedule,
                                       FlashAttentionSchedule,
                                       MatmulSchedule, SSMScanSchedule,
                                       SparseConvSchedule)
from repro_torch.kernels import _geometry as geo
from repro_torch.obs.metrics import get_metrics_registry

CONV_CHANNEL_TARGETS = (16, 32, 64, 128)
CONV_PIXEL_TARGETS = (4, 8, 16)
MATMUL_TILE_TARGETS = (32, 64, 128)
MATMUL_K_TARGETS = (16, 32, 64)
# bf16, the tensor-core bodies
CONV_MMA_CHANNEL_TARGETS = (16, 32, 64, 128, 256)
CONV_MMA_PIXEL_TARGETS = (4, 8, 16, 28)
MATMUL_MMA_ROW_TARGETS = (64, 128)
MATMUL_MMA_COL_TARGETS = (16, 32, 64, 128, 192, 256)
# the serving kernels
DECODE_SPLITS = (32, 64, 128, 256, 512)
SCAN_BLOCK_DS = (32, 64, 128, 256)


def _divisors(n: int, cap: int = 1 << 30) -> List[int]:
    """All divisors of ``n`` up to ``cap``."""
    return [d for d in range(1, min(n, cap) + 1) if n % d == 0]


def _block_candidates(dim: int, targets: Sequence[int]) -> List[int]:
    """Divisors of ``dim`` closest below each target."""
    divs = _divisors(dim)
    return sorted({max(d for d in divs if d <= t) for t in targets if t >= 1})


def conv_blocks(layer: ConvLayer, elem_bytes: int) -> List[Dict[str, int]]:
    """The conv block candidates the dtype's kernel accepts for
    ``layer``."""
    mma = geo.tensor_cores(elem_bytes)
    ch = CONV_MMA_CHANNEL_TARGETS if mma else CONV_CHANNEL_TARGETS
    px = CONV_MMA_PIXEL_TARGETS if mma else CONV_PIXEL_TARGETS
    oc_c = _block_candidates(layer.oc, ch)
    ic_c = _block_candidates(layer.ic, ch)
    y_c = _block_candidates(layer.h, px + (layer.h,))
    x_c = _block_candidates(layer.w, px + (layer.w,))
    blocks = [{"oc": o, "ic": i, "y": y, "x": x}
              for o, i, y, x in itertools.product(oc_c, ic_c, y_c, x_c)]
    return [b for b in blocks
            if geo.conv_layout(b["oc"], b["ic"], b["y"], b["x"], layer.kh,
                               layer.kw, elem_bytes).error is None]


def _top(times: np.ndarray, feasible: np.ndarray, top_k: int) -> List[int]:
    """Flat indices of the ``top_k`` cheapest feasible candidates (a
    stable sort, so ties keep enumeration order)."""
    flat = np.where(feasible.reshape(-1), times.reshape(-1), np.inf)
    order = np.argsort(flat, kind="stable")
    return [int(i) for i in order[:top_k] if np.isfinite(flat[i])]


def tune_conv(layer: ConvLayer, spec: cm.H100Spec = cm.H100Spec(),
              elem_bytes: int = 2, top_k: int = 5, batch: int = 1,
              ) -> List[Tuple[ConvSchedule, cm.KernelCost]]:
    """Rank (grid order x block shape) conv schedules by the H100 model
    for ``batch`` images with one ``conv_schedule_cost_batch`` call (the
    tensor-core body's best tile differs between one image and a
    batch: few images want many small tiles, many want large ones)."""
    orders = list(itertools.permutations(("oc", "ic", "y", "x")))
    blocks = conv_blocks(layer, elem_bytes)
    scored = cm.conv_schedule_cost_batch(layer, orders, blocks, spec,
                                         elem_bytes, batch)
    n_b = len(blocks)
    return [(ConvSchedule.make(orders[i // n_b], blocks[i % n_b]),
             scored.cost((i // n_b, i % n_b)))
            for i in _top(scored.time_s, scored.feasible, top_k)]


def matmul_blocks(m: int, n: int, k: int, elem_bytes: int = 2
                  ) -> List[Tuple[int, int, int]]:
    """The matmul (bm, bn, bk) candidates for the dtype's kernel
    (feasibility also depends on the resident switch, so it is applied
    on the scores)."""
    mma = geo.tensor_cores(elem_bytes)
    m_c = _block_candidates(m, MATMUL_MMA_ROW_TARGETS if mma
                            else MATMUL_TILE_TARGETS)
    n_c = _block_candidates(n, MATMUL_MMA_COL_TARGETS if mma
                            else MATMUL_TILE_TARGETS)
    k_c = _block_candidates(k, MATMUL_K_TARGETS + (k,))
    return list(itertools.product(m_c, n_c, k_c))


def tune_matmul(m: int, n: int, k: int, spec: cm.H100Spec = cm.H100Spec(),
                elem_bytes: int = 2, top_k: int = 5,
                ) -> List[Tuple[MatmulSchedule, cm.KernelCost]]:
    """Rank matmul schedules: 6 grid orders x blocks x resident RHS, with
    one ``matmul_schedule_cost_batch`` call."""
    orders = list(itertools.permutations(("m", "n", "k")))
    blocks = matmul_blocks(m, n, k, elem_bytes)
    batch = cm.matmul_schedule_cost_batch(m, n, k, blocks, orders, spec,
                                          elem_bytes)
    n_b = len(blocks)
    out: List[Tuple[MatmulSchedule, cm.KernelCost]] = []
    for i in _top(batch.time_s, batch.feasible, top_k):
        o, rem = divmod(i, n_b * 2)
        b, resident = divmod(rem, 2)
        bm, bn, bk = blocks[b]
        sched = MatmulSchedule.make(orders[o], {"m": bm, "n": bn, "k": bk},
                                    bool(resident))
        out.append((sched, batch.cost((o, b, resident))))
    return out


def sparse_blocks(layer: ConvLayer, elem_bytes: int) -> List[Dict[str, int]]:
    """The (oc, ic) skip-block candidates the sparse kernel of the dtype
    accepts: bf16 those with a pixel tile that fits the tensor-core
    layout (``sparsity.sparse_pixel_tile``: whether one fits does not
    depend on the batch), float32 those whose CUDA-core tile fits."""
    from repro_torch.core.sparsity import sparse_pixel_tile
    oc_c = _block_candidates(layer.oc, CONV_CHANNEL_TARGETS)
    ic_c = _block_candidates(layer.ic, CONV_CHANNEL_TARGETS)
    if geo.tensor_cores(elem_bytes):
        return [{"oc": o, "ic": i} for o, i in itertools.product(oc_c, ic_c)
                if sparse_pixel_tile(layer, o, i) is not None]
    by, bx = geo.sparse_tile(layer.h, layer.w)
    return [{"oc": o, "ic": i} for o, i in itertools.product(oc_c, ic_c)
            if geo.conv_tile(o, i, by, bx, layer.kh, layer.kw,
                             elem_bytes).error is None]


def tune_sparse_conv(layer: ConvLayer, density: float = 1.0,
                     spec: cm.H100Spec = cm.H100Spec(),
                     elem_bytes: int = 2, top_k: int = 5, batch: int = 1,
                     ) -> List[Tuple[SparseConvSchedule, cm.KernelCost]]:
    """Rank (oc, ic) skip blocks for the block-sparse conv kernel at a
    given block density for ``batch`` images (the bf16 body's pixel tile,
    and so its best skip block, depends on the batch)."""
    blocks = sparse_blocks(layer, elem_bytes)
    scored = cm.sparse_conv_schedule_cost_batch(layer, blocks, density,
                                                batch, spec, elem_bytes)
    return [(SparseConvSchedule.make(blocks[i]), scored.cost(i))
            for i in _top(scored.time_s, scored.feasible, top_k)]


def flash_attention_tiles(d: int, elem_bytes: int = 2
                          ) -> List[Tuple[int, int]]:
    """The (block_q, block_kv) tiles the flash body of the dtype takes at
    head dim ``d``: bf16 every row choice at the key tile, float32 its
    one tile."""
    if geo.tensor_cores(elem_bytes):
        tiles = [(r, geo.FLASH_KEYS) for r in geo.FLASH_ROW_CHOICES]
    else:
        tiles = [geo.FLASH_F32_TILE]
    return [t for t in tiles
            if geo.flash_tile_error(d, elem_bytes, *t) is None]


def tune_flash_attention(b: int, hq: int, hkv: int, s: int, d: int,
                         causal: bool = True,
                         spec: cm.H100Spec = cm.H100Spec(),
                         elem_bytes: int = 2, top_k: int = 5,
                         ) -> List[Tuple[FlashAttentionSchedule,
                                         cm.KernelCost]]:
    """Rank the flash tiles with one
    ``flash_attention_schedule_cost_batch`` call."""
    tiles = flash_attention_tiles(d, elem_bytes)
    scored = cm.flash_attention_schedule_cost_batch(
        b, hq, hkv, s, d, tiles, causal, spec, elem_bytes)
    return [(FlashAttentionSchedule(*tiles[i]), scored.cost(i))
            for i in _top(scored.time_s, scored.feasible, top_k)]


def decode_splits(b: int, hq: int, hkv: int, s: int, d: int,
                  elem_bytes: int = 2) -> List[int]:
    """The splits (``block_kv``) the contiguous split decode takes over a
    cache of ``s`` keys: the plan's own first, then DECODE_SPLITS up to
    ``s``, each once and only where ``decode_plan`` raises no error."""
    own = geo.decode_plan(b, hq, hkv, d, s, 0, elem_bytes).split_keys
    out: List[int] = []
    for k in (own,) + tuple(x for x in DECODE_SPLITS if x <= s):
        if k not in out and geo.decode_plan(b, hq, hkv, d, s, 0, elem_bytes,
                                            k).error is None:
            out.append(k)
    return out


def tune_decode_attention(b: int, hq: int, hkv: int, s: int, d: int,
                          spec: cm.H100Spec = cm.H100Spec(),
                          elem_bytes: int = 2, top_k: int = 5,
                          ) -> List[Tuple[DecodeAttentionSchedule,
                                          cm.KernelCost]]:
    """Rank decode splits with one ``decode_attention_schedule_cost_batch``
    call (ties keep the plan's own split first)."""
    splits = decode_splits(b, hq, hkv, s, d, elem_bytes)
    scored = cm.decode_attention_schedule_cost_batch(b, hq, hkv, s, d,
                                                     splits, spec,
                                                     elem_bytes)
    return [(DecodeAttentionSchedule(splits[i]), scored.cost(i))
            for i in _top(scored.time_s, scored.feasible, top_k)]


def scan_blocks(n: int, elem_bytes: int = 2) -> List[int]:
    """The ``block_d`` values of SCAN_BLOCK_DS the scan takes for state
    size ``n``."""
    return [bd for bd in SCAN_BLOCK_DS
            if geo.scan_layout(bd, n, elem_bytes).error is None]


def tune_ssm_scan(bt: int, seq: int, di: int, n: int,
                  spec: cm.H100Spec = cm.H100Spec(),
                  elem_bytes: int = 2, top_k: int = 5,
                  ) -> List[Tuple[SSMScanSchedule, cm.KernelCost]]:
    """Rank channel blocks with one ``ssm_scan_schedule_cost_batch``
    call."""
    blocks = scan_blocks(n, elem_bytes)
    scored = cm.ssm_scan_schedule_cost_batch(bt, seq, di, n, blocks, spec,
                                             elem_bytes)
    return [(SSMScanSchedule(blocks[i]), scored.cost(i))
            for i in _top(scored.time_s, scored.feasible, top_k)]


def _tune_counter(name: str):
    """A counter of the offline tuner on the process metrics registry."""
    return get_metrics_registry().counter(
        name, help="offline-tuner sweep accounting")


def _ranked_to_value(ranked) -> Dict:
    """Registry value for a ranked (schedule, cost) list."""
    return {"schedules": [reg.schedule_to_dict(s) for s, _ in ranked],
            "costs": [reg.cost_to_dict(c) for _, c in ranked],
            "tier": "roofline"}


def _has_ranked(value: Dict, top_k: int) -> bool:
    """A record answers a top_k request when it holds that many ranked
    pairs, or the whole (smaller) enumeration; a record made only by an
    online write-back holds no costs and must re-tune."""
    n = min(len(value.get("schedules", ())), len(value.get("costs", ())))
    if value.get("complete") and n > 0:
        return True
    return n >= top_k


def _value_to_ranked(value: Dict, top_k: Optional[int] = None):
    """Rebuild the ranked (schedule, cost) list from a registry value."""
    pairs = zip(value["schedules"][:top_k], value["costs"][:top_k])
    return [(reg.schedule_from_dict(s), reg.cost_from_dict(c))
            for s, c in pairs]


def _cached_ranked(key: reg.RegistryKey, tune: Callable[[int], List],
                   top_k: int, registry: Optional[reg.TuningRegistry],
                   refresh: bool) -> List:
    """Return the stored ranking on a warm hit (zero cost-model
    evaluations); otherwise run ``tune`` once and persist it, keeping
    any measurement already attached to the key."""
    registry = registry if registry is not None else \
        reg.TuningRegistry.default()
    prev = registry.get(key)
    rec = None if refresh else prev
    if rec is not None and _has_ranked(rec.value, top_k):
        _tune_counter("tune.warm_hits_total").inc()
        return _value_to_ranked(rec.value, top_k)
    want = max(top_k, 5)
    evals0 = cm.total_evals()
    t0 = time.perf_counter()
    ranked = tune(want)
    _tune_counter("tune.sweeps_total").inc()
    _tune_counter("tune.sweep_wall_s_total").inc(time.perf_counter() - t0)
    _tune_counter("tune.cost_model_evals_total").inc(
        cm.total_evals() - evals0)
    if not ranked:
        raise ValueError(f"no schedule of {key.kind} {key.problem_dict()} "
                         f"fits the kernel")
    value = _ranked_to_value(ranked)
    if len(ranked) < want:
        value["complete"] = True      # the whole feasible enumeration
    registry.put(reg.TuningRecord(key=key, value=value,
                                  measured=prev.measured if prev else None,
                                  source="offline"))
    return ranked[:top_k]


def cached_tune_conv(layer: ConvLayer, spec: cm.H100Spec = cm.H100Spec(),
                     elem_bytes: int = 2, top_k: int = 5,
                     registry: Optional[reg.TuningRegistry] = None,
                     refresh: bool = False, machine: Optional[str] = None,
                     batch: int = 1,
                     ) -> List[Tuple[ConvSchedule, cm.KernelCost]]:
    """:func:`tune_conv` behind the registry (the key holds the batch);
    ``machine`` overrides the key's machine part (the dispatch service
    passes spec + runtime)."""
    return _cached_ranked(
        reg.conv_schedule_key(layer, machine or spec, elem_bytes, batch),
        lambda k: tune_conv(layer, spec, elem_bytes, top_k=k, batch=batch),
        top_k, registry, refresh)


def cached_tune_matmul(m: int, n: int, k: int,
                       spec: cm.H100Spec = cm.H100Spec(),
                       elem_bytes: int = 2, top_k: int = 5,
                       registry: Optional[reg.TuningRegistry] = None,
                       refresh: bool = False, machine: Optional[str] = None,
                       ) -> List[Tuple[MatmulSchedule, cm.KernelCost]]:
    """:func:`tune_matmul` behind the registry."""
    return _cached_ranked(
        reg.matmul_schedule_key(m, n, k, machine or spec, elem_bytes),
        lambda kk: tune_matmul(m, n, k, spec, elem_bytes, top_k=kk),
        top_k, registry, refresh)


def cached_tune_sparse_conv(
        layer: ConvLayer, density: float = 1.0,
        spec: cm.H100Spec = cm.H100Spec(), elem_bytes: int = 2,
        top_k: int = 5, registry: Optional[reg.TuningRegistry] = None,
        refresh: bool = False, machine: Optional[str] = None,
        batch: int = 1,
        ) -> List[Tuple[SparseConvSchedule, cm.KernelCost]]:
    """:func:`tune_sparse_conv` behind the registry (density quantised to
    the registry's 1/16 grid, so the key space stays finite; the key
    holds the batch)."""
    density_q = reg.quantize_density(density) / 16.0
    return _cached_ranked(
        reg.sparse_conv_schedule_key(layer, density, machine or spec,
                                     elem_bytes, batch),
        lambda k: tune_sparse_conv(layer, density_q, spec, elem_bytes,
                                   top_k=k, batch=batch),
        top_k, registry, refresh)


def cached_tune_flash_attention(
        b: int, hq: int, hkv: int, s: int, d: int, causal: bool = True,
        spec: cm.H100Spec = cm.H100Spec(), elem_bytes: int = 2,
        top_k: int = 5, registry: Optional[reg.TuningRegistry] = None,
        refresh: bool = False, machine: Optional[str] = None,
        ) -> List[Tuple[FlashAttentionSchedule, cm.KernelCost]]:
    """:func:`tune_flash_attention` behind the registry."""
    return _cached_ranked(
        reg.flash_attention_schedule_key(b, hq, hkv, s, d, machine or spec,
                                         causal, elem_bytes),
        lambda k: tune_flash_attention(b, hq, hkv, s, d, causal, spec,
                                       elem_bytes, top_k=k),
        top_k, registry, refresh)


def cached_tune_decode_attention(
        b: int, hq: int, hkv: int, s: int, d: int,
        spec: cm.H100Spec = cm.H100Spec(), elem_bytes: int = 2,
        top_k: int = 5, registry: Optional[reg.TuningRegistry] = None,
        refresh: bool = False, machine: Optional[str] = None,
        ) -> List[Tuple[DecodeAttentionSchedule, cm.KernelCost]]:
    """:func:`tune_decode_attention` behind the registry."""
    return _cached_ranked(
        reg.decode_attention_schedule_key(b, hq, hkv, s, d, machine or spec,
                                          elem_bytes),
        lambda k: tune_decode_attention(b, hq, hkv, s, d, spec, elem_bytes,
                                        top_k=k),
        top_k, registry, refresh)


def cached_tune_ssm_scan(
        bt: int, seq: int, di: int, n: int,
        spec: cm.H100Spec = cm.H100Spec(), elem_bytes: int = 2,
        top_k: int = 5, registry: Optional[reg.TuningRegistry] = None,
        refresh: bool = False, machine: Optional[str] = None,
        ) -> List[Tuple[SSMScanSchedule, cm.KernelCost]]:
    """:func:`tune_ssm_scan` behind the registry."""
    return _cached_ranked(
        reg.ssm_scan_schedule_key(bt, seq, di, n, machine or spec,
                                  elem_bytes),
        lambda k: tune_ssm_scan(bt, seq, di, n, spec, elem_bytes, top_k=k),
        top_k, registry, refresh)


__all__ = ["tune_conv", "tune_matmul", "tune_sparse_conv",
           "tune_flash_attention", "tune_decode_attention", "tune_ssm_scan",
           "cached_tune_conv", "cached_tune_matmul",
           "cached_tune_sparse_conv", "cached_tune_flash_attention",
           "cached_tune_decode_attention", "cached_tune_ssm_scan",
           "conv_blocks", "matmul_blocks", "sparse_blocks",
           "flash_attention_tiles", "decode_splits", "scan_blocks"]
