"""Time a spread of conv2d, matmul and block-sparse conv schedules, and
every flash-attention, split-decode and selective-scan schedule the
tuner offers at the serving shapes, on the card beside the cost model's
predictions: the data the model's fitted constants come from
(``core/cost_model.py``).

    PYTHONPATH=src python -m repro_torch.launch.calibrate_thesis \\
        [--out build/calibrate_thesis.jsonl] [--kinds conv2d matmul ...]
    PYTHONPATH=src python -m repro_torch.launch.calibrate_thesis \\
        --score FILE.jsonl [FILE.jsonl ...]

For each Table 4.1 layer (at batch 1 and 32, scratch order) and each
GEMM shape of the thesis path (the 1x1 layers' GEMM forms and phi3-mini's
QKV projection, k innermost), it takes the cost model's best candidates
and an even spread of the rest of the tuner's bf16 blocks; for the
block-sparse conv, an even spread of the tuner's skip blocks on the
thesis' Fig 6.2 layer and the 3x3 Table 4.1 layers at block densities
0-1, batch 1 and 32.  For the serving kernels (bf16): flash at phi3's
prefill buckets, ``generate``'s [4, 512] and head_dim 256; the
contiguous decode at 1 and 4 rows over caches of 544-2080 keys; the
scan at the prefill, ``generate`` and decode shapes of falcon-mamba.
It times each with CUDA events (median of 15 launches, the 50 MB L2
flushed before each) and writes one JSON line per (schedule, batch):
the measured and the predicted milliseconds, with the card's name and
power limit.  Needs a CUDA card; random inputs from numpy seed 0.

``--score`` needs no card: it reads such lines and prints, per kind of
line, the current constants' mean squared log error, mean log bias,
mean rank correlation within each shape and the geometric-mean ratio
of the model's pick to the fastest timed schedule of each shape; for
the sparse lines also the least-squares ``SPARSE_CALL_S`` (bf16: the
tensor-core body's model has no other sparse constant) or, for lines of
the float32 body (``"dtype": "float32"``), ``SPARSE_CALL_S`` and
``SPARSE_CHANNEL_S``; for the serving kernels the least-squares fit of
each family's three constants (``FLASH_*``, ``DEC_*``, ``SCAN_*``) to
its lines' times less the launch.
"""
import argparse
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs.squeezenet_layers import TABLE_4_1
from repro_torch.core import cost_model as cm
from repro_torch.core import tuner
from repro_torch.core.loopnest import ConvLayer
from repro_torch.kernels import conv2d, matmul, sparse_conv2d
from repro_torch.kernels.sparse_conv import analyze_weights

CONV_ORDER = ("oc", "y", "x", "ic")
QKV = (512, 9216, 3072)
KINDS = ("conv2d", "matmul", "sparse_conv", "flash_attention",
         "decode_attention", "ssm_scan")
# the serving kernels' shapes (bf16): flash (b, hq, hkv, s, d), the
# contiguous decode (b, hq, hkv, s, d), the scan (bt, seq, di, n)
FLASH_SHAPES = [(1, 32, 32, s, 96) for s in (64, 128, 256, 512)] + [
    (4, 32, 32, 512, 96), (1, 16, 1, 512, 256)]
DECODE_SHAPES = [(b, 32, 32, s, 96) for b in (1, 4)
                 for s in (544, 1056, 2080)]
SCAN_SHAPES = [(1, 64, 8192, 16), (1, 512, 8192, 16), (4, 512, 8192, 16),
               (1, 1, 8192, 16), (4, 1, 8192, 16), (8, 1, 8192, 16)]
# each serving family's fitted constants and the features they multiply
SERVING = {
    "flash_attention": (("FLASH_BLOCK_S", "FLASH_TILE_S", "FLASH_WORK_EFF"),
                        lambda r: cm.flash_attention_features(
                            *_dims(r), [tuple(r["block"])],
                            elem_bytes=_elem_bytes(r))[0][0]),
    "decode_attention": (("DEC_BLOCK_S", "DEC_TILE_S", "DEC_MERGE_S"),
                         lambda r: cm.decode_attention_features(
                             *_dims(r), [r["block"]],
                             elem_bytes=_elem_bytes(r))[0][0]),
    "ssm_scan": (("SCAN_BLOCK_S", "SCAN_STEP_S", "SCAN_EXP_S"),
                 lambda r: cm.ssm_scan_features(
                     *_dims(r), [r["block"]],
                     elem_bytes=_elem_bytes(r))[0][0]),
}
DIMS = {"flash_attention": ("b", "hq", "hkv", "s", "d"),
        "decode_attention": ("b", "hq", "hkv", "s", "d"),
        "ssm_scan": ("bt", "seq", "di", "n")}
PER_SHAPE = 12          # schedules timed a shape: the 4 best predicted and
#                         an even spread of the rest


SPARSE_LAYERS = {"fig6.2-128x128-25x25": ConvLayer(128, 128, 25, 25, 3, 3),
                 **{name: l for name, l in TABLE_4_1.items() if l.kh == 3
                    and l.ic >= 16}}
SPARSE_DENSITIES = (0.0, 0.25, 0.5, 1.0)
SPARSE_PER_LAYER = 4    # skip blocks timed a layer, an even spread


def _dims(rec):
    """A serving line's problem dims, in the cost model's order."""
    return [rec["problem"][k] for k in DIMS[rec["kind"]]]


def _predict_ms(rec) -> float:
    """The model's ms for one calibration line."""
    eb = _elem_bytes(rec)
    if rec["kind"] == "flash_attention":
        return float(cm.flash_attention_schedule_cost_batch(
            *_dims(rec), [tuple(rec["block"])],
            elem_bytes=eb).time_s[0]) * 1e3
    if rec["kind"] == "decode_attention":
        return float(cm.decode_attention_schedule_cost_batch(
            *_dims(rec), [rec["block"]], elem_bytes=eb).time_s[0]) * 1e3
    if rec["kind"] == "ssm_scan":
        return float(cm.ssm_scan_schedule_cost_batch(
            *_dims(rec), [rec["block"]], elem_bytes=eb).time_s[0]) * 1e3
    if rec["kind"] == "conv2d":
        order = tuple({"o": "oc", "i": "ic", "y": "y", "x": "x"}[c]
                      for c in rec["order"])
        return float(cm.conv_schedule_cost_batch(
            TABLE_4_1[rec["layer"]], [order], [rec["block"]],
            batch=rec["batch"]).time_s[0, 0]) * 1e3
    if rec["kind"] == "sparse_conv":
        return float(cm.sparse_conv_schedule_cost_batch(
            SPARSE_LAYERS[rec["layer"]], [rec["block"]],
            rec["block_density"], rec["batch"],
            elem_bytes=_elem_bytes(rec)).time_s[0]) * 1e3
    m, n, k = rec["mnk"]
    b = rec["block"]
    return float(cm.matmul_schedule_cost_batch(
        m, n, k, [(b["m"], b["n"], b["k"])],
        [tuple(rec["order"])]).time_s[0, 0, 0]) * 1e3


def _elem_bytes(rec) -> int:
    """Element size of a calibration line (lines without a dtype are
    bf16)."""
    return 4 if rec.get("dtype") == "float32" else 2


def sparse_fit(recs):
    """The sparse body's constants by least squares on its lines.  bf16
    (the tensor-core body): ``{"SPARSE_CALL_S"}``, time = the model with
    no call time + call.  float32 (the CUDA-core body):
    ``{"SPARSE_CALL_S", "SPARSE_CHANNEL_S"}``, time = launch + call +
    channel x ``cm.sparse_channel_waves``."""
    meas = np.array([r["ms"] for r in recs]) * 1e-3
    if all(_elem_bytes(r) == 2 for r in recs):
        base = np.array([_predict_ms(r) for r in recs]) * 1e-3 \
            - cm.SPARSE_CALL_S
        return {"SPARSE_CALL_S": float(np.mean(meas - base))}
    x = np.array([cm.sparse_channel_waves(
        SPARSE_LAYERS[r["layer"]], [r["block"]], r["block_density"],
        r["batch"], elem_bytes=4)[0] for r in recs])
    (fixed, channel), *_ = np.linalg.lstsq(
        np.stack([np.ones(len(recs)), x], axis=1), meas, rcond=None)
    return {"SPARSE_CALL_S": float(fixed - cm.H100Spec().launch_s),
            "SPARSE_CHANNEL_S": float(channel)}


def serving_fit(kind, recs):
    """A serving family's three constants by least squares: each line's
    time less the launch against its features (the model's compute term,
    which bounds these kernels at the calibrated shapes)."""
    names, features = SERVING[kind]
    x = np.stack([features(r) for r in recs])
    meas = np.array([r["ms"] for r in recs]) * 1e-3 - cm.H100Spec().launch_s
    consts, *_ = np.linalg.lstsq(x, meas, rcond=None)
    return dict(zip(names, (float(c) for c in consts)))


def fit_stats(recs):
    """(mean squared log error, mean log bias, mean rank correlation and
    geometric-mean pick regret over the shapes) of the model on
    ``recs``."""
    pred = np.array([_predict_ms(r) for r in recs])
    meas = np.array([r["ms"] for r in recs])
    err = np.log(pred / meas)
    groups = {}
    for i, r in enumerate(recs):
        key = (r.get("layer", r.get("shape")), r.get("batch"),
               r.get("order"), r.get("density"))
        groups.setdefault(key, []).append(i)
    rho, regret = [], []
    for idx in groups.values():
        if len(idx) < 3:
            continue
        p, m = pred[idx], meas[idx]
        rho.append(np.corrcoef(np.argsort(np.argsort(p)),
                               np.argsort(np.argsort(m)))[0, 1])
        regret.append(m[np.argmin(p)] / m.min())
    if not rho:           # no shape with three timed schedules
        return float(np.mean(err ** 2)), float(np.mean(err)), np.nan, np.nan
    return (float(np.mean(err ** 2)), float(np.mean(err)),
            float(np.mean(rho)), float(np.exp(np.mean(np.log(regret)))))


def score(paths) -> None:
    """Print the model's fit to calibration lines, per kind of line."""
    recs = [json.loads(line) for p in paths for line in open(p)]
    fmt = "mse {:.4f} bias {:+.4f} rho {:.3f} regret {:.4f}"
    for kind in KINDS:
        rs = [r for r in recs if r["kind"] == kind]
        if not rs:
            continue
        print(f"[score] kind={kind} lines={len(rs)} "
              + fmt.format(*fit_stats(rs)))
        if kind == "sparse_conv":
            for eb in (2, 4):
                sub = [r for r in rs if _elem_bytes(r) == eb]
                if sub:
                    print("[score] kind=sparse_conv least_squares " + " ".join(
                        f"{k}={v:.4g}" for k, v in sparse_fit(sub).items()))
        if kind in SERVING:
            print(f"[score] kind={kind} least_squares " + " ".join(
                f"{k}={v:.4g}" for k, v in serving_fit(kind, rs).items()))


def _median_ms(fn, flush, iters=15):
    """Median device ms of ``fn()``, the L2 flushed before each call."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    ms = sorted(s.elapsed_time(e) for s, e in pairs)
    return ms[len(ms) // 2]


def _spread(times: np.ndarray, best: int, per_shape: int):
    """Indices of the ``best`` cheapest predictions and an even spread of
    the rest, ``per_shape`` in all."""
    order = np.argsort(times, kind="stable")
    rest = order[best:]
    k = max(0, min(per_shape - best, len(rest)))
    picks = list(order[:best]) + [rest[i] for i in
                                  np.linspace(0, len(rest) - 1, k).astype(int)]
    return sorted(set(int(i) for i in picks), key=lambda i: times[i])


def main(argv=None) -> None:
    """Time the spread and write the JSON lines, or score them."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/calibrate_thesis.jsonl")
    ap.add_argument("--kinds", nargs="+", default=list(KINDS),
                    choices=KINDS)
    ap.add_argument("--score", nargs="+", metavar="FILE")
    args = ap.parse_args(argv)
    if args.score:
        score(args.score)
        return
    if not torch.cuda.is_available():
        raise SystemExit("calibrate_thesis needs a CUDA card")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    rng = np.random.default_rng(0)

    def rn(shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                * np.float32(scale)).to(dev, torch.bfloat16)

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    n = 0
    with out.open("w") as f:
        def emit(rec):
            nonlocal n
            f.write(json.dumps({**rec, "card": smi}) + "\n")
            n += 1

        if "conv2d" in args.kinds:
            for name, l in TABLE_4_1.items():
                img = rn((32, l.ic, l.h + l.kh - 1, l.w + l.kw - 1))
                wgt = rn((l.oc, l.ic, l.kh, l.kw),
                         (l.ic * l.kh * l.kw) ** -0.5)
                blocks = tuner.conv_blocks(l, 2)
                t1 = cm.conv_schedule_cost_batch(l, [CONV_ORDER],
                                                 blocks).time_s[0]
                for i in _spread(t1, 4, PER_SHAPE):
                    blk = blocks[i]
                    for nb in (1, 32):
                        pred = cm.conv_schedule_cost_batch(
                            l, [CONV_ORDER], [blk], batch=nb).time_s[0, 0]
                        x = img[:nb]
                        ms = _median_ms(lambda: conv2d(x, wgt, block=blk,
                                                       grid_order=CONV_ORDER),
                                        flush)
                        emit({"kind": "conv2d", "layer": name, "batch": nb,
                              "block": blk, "order": "".join(a[0] for a in
                                                             CONV_ORDER),
                              "ms": ms, "predicted_ms": pred * 1e3})
                del img, wgt
        if "matmul" in args.kinds:
            gemms = [(name, (l.oc, l.h * l.w, l.ic))
                     for name, l in TABLE_4_1.items() if l.kh == 1]
            gemms.append(("phi3-qkv", QKV))
            for label, (m, n_, k) in gemms:
                a, b = rn((m, k)), rn((k, n_), k ** -0.5)
                blocks = tuner.matmul_blocks(m, n_, k, 2)
                orders = [("m", "n", "k")] + ([("n", "m", "k")]
                                              if label == "phi3-qkv" else [])
                batch = cm.matmul_schedule_cost_batch(m, n_, k, blocks, orders)
                for o, order in enumerate(orders):
                    t = np.where(batch.feasible[o, :, 0],
                                 batch.time_s[o, :, 0], np.inf)
                    for i in _spread(t, 4, PER_SHAPE):
                        if not np.isfinite(t[i]):
                            continue
                        bm, bn, bk = blocks[i]
                        blk = {"m": bm, "n": bn, "k": bk}
                        ms = _median_ms(lambda: matmul(a, b, block=blk,
                                                       grid_order=order),
                                        flush)
                        emit({"kind": "matmul", "shape": label,
                              "mnk": [m, n_, k], "block": blk,
                              "order": "".join(order), "ms": ms,
                              "predicted_ms": float(t[i]) * 1e3})
        if "sparse_conv" in args.kinds:
            for name, l in SPARSE_LAYERS.items():
                img = rn((32, l.ic, l.h + l.kh - 1, l.w + l.kw - 1))
                blocks = tuner.sparse_blocks(l, 2)
                picks = np.linspace(0, len(blocks) - 1,
                                    min(SPARSE_PER_LAYER, len(blocks)))
                for i in sorted(set(picks.astype(int))):
                    blk = blocks[i]
                    boc, bic = blk["oc"], blk["ic"]
                    for d in SPARSE_DENSITIES:
                        # a block is dropped where a uniform draw is >= d
                        drop = rng.random((l.oc // boc, l.ic // bic)) >= d
                        w = rn((l.oc, l.ic, l.kh, l.kw),
                               (l.ic * l.kh * l.kw) ** -0.5)
                        for o, c in zip(*np.nonzero(drop)):
                            w[o * boc:(o + 1) * boc,
                              c * bic:(c + 1) * bic] = 0
                        sp = analyze_weights(w, blk)
                        for nb in (1, 32):
                            x = img[:nb]
                            ms = _median_ms(
                                lambda: sparse_conv2d(x, w, block=blk,
                                                      sparsity=sp), flush)
                            rec = {"kind": "sparse_conv", "layer": name,
                                   "batch": nb, "block": blk, "density": d,
                                   "block_density": sp.density,
                                   "dtype": "bfloat16", "ms": ms}
                            emit({**rec, "predicted_ms": _predict_ms(rec)})
                del img
        serving(args.kinds, rn, flush, emit)
    print(f"[calibrate] lines={n} out={out} card={smi!r}")


def serving(kinds, rn, flush, emit) -> None:
    """Time every schedule the tuner offers at the serving shapes."""
    from repro_torch.kernels import (decode_attention, flash_attention,
                                     ssm_scan)
    dev = flush.device
    if "flash_attention" in kinds:
        for b, hq, hkv, s, d in FLASH_SHAPES:
            q = rn((b, hq, s, d))
            k, v = rn((b, hkv, s, d)), rn((b, hkv, s, d))
            for bq, bkv in tuner.flash_attention_tiles(d, 2):
                rec = {"kind": "flash_attention",
                       "shape": f"[{b},{hq},{s},{d}]/{hkv}kv",
                       "problem": {"b": b, "hq": hq, "hkv": hkv, "s": s,
                                   "d": d},
                       "block": [bq, bkv], "dtype": "bfloat16",
                       "ms": _median_ms(lambda: flash_attention(
                           q, k, v, block_q=bq, block_kv=bkv), flush)}
                emit({**rec, "predicted_ms": _predict_ms(rec)})
    if "decode_attention" in kinds:
        for b, hq, hkv, s, d in DECODE_SHAPES:
            q = rn((b, hq, 1, d))
            k, v = rn((b, hkv, s, d)), rn((b, hkv, s, d))
            for bkv in tuner.decode_splits(b, hq, hkv, s, d, 2):
                rec = {"kind": "decode_attention",
                       "shape": f"[{b},{hq},1,{d}] cache {s}/{hkv}kv",
                       "problem": {"b": b, "hq": hq, "hkv": hkv, "s": s,
                                   "d": d},
                       "block": bkv, "dtype": "bfloat16",
                       "ms": _median_ms(lambda: decode_attention(
                           q, k, v, s - 1, block_kv=bkv), flush)}
                emit({**rec, "predicted_ms": _predict_ms(rec)})
    if "ssm_scan" in kinds:
        for bt, seq, di, n in SCAN_SHAPES:
            x, d = rn((bt, seq, di)), rn((di,))
            dt = torch.nn.functional.softplus(rn((bt, seq, di)).float())
            b, c = rn((bt, seq, n)).float(), rn((bt, seq, n)).float()
            a = -torch.arange(1, n + 1, dtype=torch.float32,
                              device=dev).repeat(di, 1)
            h0 = rn((bt, di, n)).float() if seq == 1 else None
            for bd in tuner.scan_blocks(n, 2):
                rec = {"kind": "ssm_scan", "shape": f"[{bt},{seq},{di}] N{n}",
                       "problem": {"bt": bt, "seq": seq, "di": di, "n": n},
                       "block": bd, "dtype": "bfloat16",
                       "ms": _median_ms(lambda: ssm_scan(
                           x, dt, b, c, a, d, h0, block_d=bd), flush)}
                emit({**rec, "predicted_ms": _predict_ms(rec)})


if __name__ == "__main__":
    main()
