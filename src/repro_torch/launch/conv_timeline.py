"""Where a bf16 conv call spends its time, and what each Table 4.1 layer
costs beside cuDNN: a scratch build of the conv sources whose implicit
GEMM (``conv_mma.cuh``) stamps each block's phases, and CUDA-event times
of the real library.

    PYTHONPATH=src python -m repro_torch.launch.conv_timeline [--out F]
        [--parent DIR] [--precision] [--without pass|loads|mma|epilogue]

Needs a CUDA card and ``nvcc``.  Prints JSON lines:

- ``layer``: each Table 4.1 layer at batch 1 and 32 at the tuner's
  rank-0 bf16 schedule: kernel ms, ``F.conv2d`` (cuDNN) ms and the bound
  (image, weights and output once at 3.35 TB/s, or the MACs at the 989
  TFLOP/s bf16 peak), then their sums at batch 32.  With ``--parent
  DIR`` (another checkout, imported beside this tree by
  ``parent_tree.load_parent``) the parent's own wrapper also runs at
  its own tuner's rank-0 schedule, built from its sources, in the order
  parent, this tree, this tree, parent, in this one process: ``ms`` and
  ``parent_ms`` are each body's faster run, ``runs`` holds both;
- ``sparse``: the block-sparse conv on the thesis' Fig 6.2 layer (128 x
  128, 25 x 25, 3 x 3) at batch 32 and block density 0.25: the rank-0
  skip block (ranked at the weights' own structure) and every other
  candidate the tuner offers, each timed,
  beside ``F.conv2d`` on the zeroed weights and the bound (with
  ``--parent``, the parent's body at the blocks its tuner offers, and a
  line of its own rank-0 block);
- ``precision``: Table 4.2's long sums, 90 and 210 channels at 11 x 11
  (10,890 and 25,410 terms a launch, batch 2, 10 x 10, scratch order,
  block oc 15 ic 15 y 2 x 2): the worst error of this tree's body (and
  the parent's) as a share of the bf16 tolerance against the plain
  version and against a float64 reference, the plain version's against
  float64, and whether two calls are bit-identical (``--precision``
  prints only these);
- ``phases``: one call of ``initial-conf`` (3 x 3), ``conv-final``
  (1 x 1) and the Fig 6.2 sparse layer at density 0.25, batch 32, after
  an L2 flush, from the instrumented build: the blocks, the span from
  the first block's entry to the last block's end (``%globaltimer``),
  and per phase the median over blocks of the block's own time in it
  (``clock64`` cycles, turned into us by each block's cycles per ns),
  with its share of the block's time.  The phases are the body's marks
  (``CM_T_MARK`` in ``conv_mma.cuh``: the prologue up to the first
  multiply, the waits on loads and barriers, the issue of the next
  loads, the channels-last pass, the wgmmas' issue and the waits for
  them, the epilogue).

``--without PHASE`` builds the instrumented copy with one phase of the
body removed (its results are wrong; only the ``phases`` lines are
printed, each naming the phase): the time a call loses without it says
whether the phases overlap or run in turn.  Then the card's name and
power limit.  Times are medians of 25 calls,
each after a 256 MB write that flushes the L2 (cold inputs, as
``chip_smoke.py`` times them).  The instrumented copy goes to
``build/conv_timeline/``; the kernel library is not changed.
"""
import argparse
import ctypes
import json
import subprocess

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.launch.parent_tree import build_all, load_parent

OUT = _build.BUILD_DIR.parent / "conv_timeline"
STAMP_WORDS = 12                 # entry ns, end ns, cycles, 8 phases, spare
MAX_STAMPS = (1 << 18) * STAMP_WORDS      # 262,144 blocks

# the marks' definitions, force-included into the instrumented build
STAMPS_H = r"""
#pragma once
static __device__ long long g_cm_stamps[%d];
__device__ __forceinline__ long long cm_ns() {
  long long t;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
  return t;
}
#define CM_T_BEGIN() \
  const long long _cm_g0 = cm_ns(); long long _cm_c = clock64(); \
  const long long _cm_c0 = _cm_c; \
  long long _cm_ph[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#define CM_T_MARK(k) \
  { const long long _n = clock64(); _cm_ph[k] += _n - _cm_c; _cm_c = _n; }
#define CM_T_END() \
  if (threadIdx.x == 0) { \
    long long* _s = g_cm_stamps + (size_t)blockIdx.x * %d; \
    _s[0] = _cm_g0; _s[1] = cm_ns(); _s[2] = clock64() - _cm_c0; \
    for (int _k = 0; _k < 8; ++_k) _s[3 + _k] = _cm_ph[_k]; \
  }
""" % (MAX_STAMPS, STAMP_WORDS)

# The phases the body marks (CM_T_MARK(k) ends phase k).
PHASES = ("prologue", "wait", "issue", "transpose", "mma", "epilogue")
# --without: (anchor, replacement) that removes one phase of the body
ABLATIONS = {
    "pass": ("  auto transpose = [&](int s) {\n",
             "  auto transpose = [&](int s) {\n    return;\n"),
    "loads": ("  auto issue = [&](int s) {\n",
              "  auto issue = [&](int s) {\n    return;\n"),
    "mma": ("              hw::WgmmaKMajor<NT>::run(acc[m], da, db, scale);\n",
            ""),
    "epilogue": ("store_rows(a, tb + (8 * j + ch) * plane, rows, v.x,\n"
                 "                               v.y);", "(void)v;"),
}


def instrumented_source(without=None):
    """(conv_mma.cuh to build, phase names): the body with its own marks,
    phase ``without`` removed."""
    src = (_build.CSRC / "conv_mma.cuh").read_text()
    if without is not None:
        old, new = ABLATIONS[without]
        if src.count(old) != 1:
            raise SystemExit(f"conv_timeline: {old!r} not found once in "
                             f"conv_mma.cuh")
        src = src.replace(old, new)
    return src, PHASES


def build(without=None):
    """The instrumented conv library (phase ``without`` removed), with a
    reader and a reset of the stamps; returns (library, phase names)."""
    OUT.mkdir(parents=True, exist_ok=True)
    src, phases = instrumented_source(without)
    (OUT / "conv_mma.cuh").write_text(src)
    (OUT / "cm_stamps.cuh").write_text(STAMPS_H)
    for p in _build.CSRC.glob("*.cuh"):
        if p.name != "conv_mma.cuh":
            (OUT / p.name).write_text(p.read_text())
    reader = ("\nextern \"C\" int read_cm_stamps(void* dst, long long n) {\n"
              "  return (int)cudaMemcpyFromSymbol(dst, g_cm_stamps,\n"
              "      sizeof(long long) * n);\n}\n"
              "extern \"C\" int reset_cm_stamps() {\n"
              "  void* p; cudaGetSymbolAddress(&p, g_cm_stamps);\n"
              "  return (int)cudaMemset(p, 0, sizeof(g_cm_stamps));\n}\n")
    # the dense conv's object holds the stamps; the sparse conv's object
    # gets its own copy, read and reset by its own functions
    (OUT / "conv2d.cu").write_text((_build.CSRC / "conv2d.cu").read_text()
                                   + reader)
    (OUT / "sparse_conv.cu").write_text(
        (_build.CSRC / "sparse_conv.cu").read_text()
        + reader.replace("read_cm_stamps", "read_cm_stamps_sparse")
        .replace("reset_cm_stamps", "reset_cm_stamps_sparse"))
    (OUT / "errors.cu").write_text((_build.CSRC / "errors.cu").read_text())
    flags = [*_build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
             "-DCONV_MMA_TIMELINE", "-include", str(OUT / "cm_stamps.cuh"),
             "-I", str(OUT)]
    procs, objs = [], []
    for name in ("conv2d.cu", "sparse_conv.cu", "errors.cu"):
        obj = OUT / (name + ".o")
        objs.append(str(obj))
        procs.append(subprocess.Popen(
            [_build.nvcc_path(), *flags, "-c", str(OUT / name), "-o",
             str(obj)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    for p in procs:
        text, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit("conv_timeline: nvcc failed\n" + text)
    so = OUT / "libconv_timeline.so"
    subprocess.run([_build.nvcc_path(), *_build.ARCH_FLAGS, "-shared", "-o",
                    str(so), *objs], check=True)
    lib = ctypes.CDLL(str(so))
    for fn in ("conv2d_fwd", "conv2d_mma_fwd", "sparse_conv2d_fwd"):
        getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    lib.kernels_error_string.argtypes = [ctypes.c_int]
    lib.kernels_error_string.restype = ctypes.c_char_p
    for fn in ("read_cm_stamps", "read_cm_stamps_sparse"):
        getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    return lib, phases


def summarize(buf, phases):
    """The stamps of one call: blocks, span and each phase's median."""
    t = buf.reshape(-1, STAMP_WORDS)
    t = t[t[:, 0] > 0].astype(np.float64)
    t0 = t[:, 0].min()
    ns = t[:, 1] - t[:, 0]
    per_ns = np.where(ns > 0, t[:, 2] / np.maximum(ns, 1.0), np.nan)
    out = {"blocks": int(len(t)),
           "span_us": round(float((t[:, 1].max() - t0) / 1e3), 3),
           "block_us_median": round(float(np.median(ns) / 1e3), 3),
           "block_us_max": round(float(ns.max() / 1e3), 3),
           "cycles_per_ns": round(float(np.nanmedian(per_ns)), 4)}
    total = t[:, 2]
    for k, name in enumerate(phases):
        us = t[:, 3 + k] / per_ns / 1e3
        out[name] = {"median_us": round(float(np.nanmedian(us)), 3),
                     "share": round(float(np.nansum(t[:, 3 + k])
                                          / total.sum()), 4)}
    return out


def bound_ms(layer, n, density=1.0):
    """(ms, by) of the least time: every byte once, or the MACs at the
    bf16 tensor-core peak."""
    l = layer
    n_bytes = (n * l.ic * (l.h + l.kh - 1) * (l.w + l.kw - 1)
               + l.oc * l.ic * l.kh * l.kw * density
               + n * l.oc * l.h * l.w) * 2
    t_b = n_bytes / 3.35e12 * 1e3
    t_o = 2 * n * l.macs * density / 989e12 * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


class Timer:
    """Median ms of one call over CUDA events, the L2 flushed before
    each call and the stream kept busy while the host enqueues."""

    def __init__(self, dev):
        self.flush = torch.empty(64 * 2 ** 20, dtype=torch.int32,
                                 device=dev)

    def __call__(self, fn, iters=25):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
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


class Parent:
    """Another checkout's bf16 conv and block-sparse conv
    (:func:`parent_tree.load_parent`), each at its own tuner's rank-0
    schedule, its sparse pixel tile from its own model."""

    def __init__(self, root):
        self.tree = load_parent(root)

    def rank0(self, layer, n):
        s = self.tree.tuner.tune_conv(layer, elem_bytes=2, top_k=1,
                                      batch=n)[0][0]
        return s.block_dict(), tuple(s.grid_order)

    def conv(self, img, wgt, blk, order):
        return self.tree.kernels.conv2d(img, wgt, block=blk,
                                        grid_order=order)

    def sparse_blocks(self, layer, density, n):
        return [s.block_dict() for s, _ in self.tree.tuner.tune_sparse_conv(
            layer, density, elem_bytes=2, top_k=1000, batch=n)]

    def sparse_fn(self, img, wgt, blk):
        sp = self.tree.sparse.analyze_weights(wgt, blk)
        return lambda: self.tree.kernels.sparse_conv2d(img, wgt, block=blk,
                                                       sparsity=sp)


def _timed(timer, runs):
    """Each (key, fn) of ``runs`` timed in the order given and then in
    reverse (parent, tree, tree, parent): {key: [ms, ms]}."""
    got = {}
    for key, fn in runs + runs[::-1]:
        got.setdefault(key, []).append(timer(fn))
    return got


def make_data(dev):
    """Table 4.1 images (batch 32) and weights, the Fig 6.2 layer's image
    and its weights zeroed at 16 x 16 blocks to density 0.25 (numpy seed
    0, weights scaled by 1/sqrt(ic kh kw))."""
    from repro_torch.configs.squeezenet_layers import TABLE_4_1
    from repro_torch.core.loopnest import ConvLayer
    rng = np.random.default_rng(0)

    def rn(shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                * np.float32(scale)).to(dev).to(
                                    torch.bfloat16)

    conv = {}
    for name, l in TABLE_4_1.items():
        conv[name] = (l, rn((32, l.ic, l.h + l.kh - 1, l.w + l.kw - 1)),
                      rn((l.oc, l.ic, l.kh, l.kw),
                         (l.ic * l.kh * l.kw) ** -0.5))
    sl = ConvLayer(128, 128, 25, 25, 3, 3)
    w = rng.standard_normal((128, 128, 3, 3), dtype=np.float32) / np.float32(
        (128 * 9) ** 0.5)
    drop = rng.random((8, 8)) >= 0.25
    for o, i in zip(*np.nonzero(drop)):
        w[o * 16:(o + 1) * 16, i * 16:(i + 1) * 16] = 0.0
    sparse = (sl, rn((32, 128, 27, 27)),
              torch.from_numpy(w).to(dev).to(torch.bfloat16))
    return conv, sparse


def emit(line, sink):
    """Print one JSON line (and append it to ``sink``)."""
    text = json.dumps(line)
    print(text, flush=True)
    if sink is not None:
        with open(sink, "a") as f:
            f.write(text + "\n")


def layer_times(timer, conv, sparse, sink, parent=None):
    """The ``layer`` and ``sparse`` lines."""
    import torch.nn.functional as F
    from repro_torch.core import tuner
    from repro_torch.kernels import conv2d, sparse_conv2d
    from repro_torch.kernels.sparse_conv import analyze_weights
    keys = ("ms", "cudnn_ms", "bound_ms") + (("parent_ms",) if parent
                                             else ())
    tot = {k: 0.0 for k in keys}
    for n in (1, 32):
        for name, (l, img32, wgt) in conv.items():
            img = img32[:n].contiguous()
            s = tuner.tune_conv(l, elem_bytes=2, top_k=1, batch=n)[0][0]
            blk, order = s.block_dict(), s.grid_order
            b_ms, by = bound_ms(l, n)
            runs = [("ms", lambda: conv2d(img, wgt, block=blk,
                                          grid_order=order))]
            line = {"layer": name, "batch": n,
                    "schedule": f"{''.join(a[0] for a in order)} {blk}"}
            if parent is not None:
                pb, po = parent.rank0(l, n)
                runs.insert(0, ("parent_ms", lambda: parent.conv(
                    img, wgt, pb, po)))
                line["parent_schedule"] = f"{''.join(a[0] for a in po)} {pb}"
            got = _timed(timer, runs)
            t = {k: min(v) for k, v in got.items()}
            t["cudnn_ms"] = timer(lambda: F.conv2d(img, wgt))
            t["bound_ms"] = b_ms
            if n == 32:
                for k in tot:
                    tot[k] += t[k]
            line.update({k: round(t[k], 4) for k in keys})
            line.update({"bound_by": by,
                         "ratio_to_cudnn": round(t["ms"] / t["cudnn_ms"], 3),
                         "runs": {k: [round(x, 4) for x in v]
                                  for k, v in got.items()}})
            emit(line, sink)
    line = {"layer": "sum of the 8 at batch 32",
            **{k: round(v, 4) for k, v in tot.items()},
            "ratio_to_cudnn": round(tot["ms"] / tot["cudnn_ms"], 3)}
    if parent is not None:
        line["ratio_to_parent"] = round(tot["ms"] / tot["parent_ms"], 3)
    emit(line, sink)
    l, img, wgt = sparse
    cands = [s.block_dict() for s, _ in tuner.tune_sparse_conv(
        l, 0.25, elem_bytes=2, top_k=1000, batch=32, weights=wgt)]
    theirs = parent.sparse_blocks(l, 0.25, 32) if parent else []
    lib_ms = timer(lambda: F.conv2d(img, wgt))
    b_ms, by = bound_ms(l, 32, analyze_weights(wgt, {"oc": 16, "ic": 16})
                        .density)
    for rank, blk in enumerate(cands):
        sp = analyze_weights(wgt, blk)
        runs = [("ms", lambda: sparse_conv2d(img, wgt, block=blk,
                                             sparsity=sp))]
        if blk in theirs:
            runs.insert(0, ("parent_ms", parent.sparse_fn(img, wgt, blk)))
        got = _timed(timer, runs)
        ms = min(got["ms"])
        line = {"sparse": "fig6.2 128x128 25x25 3x3 batch 32",
                "rank": rank, "block": blk,
                "block_density": round(sp.density, 4),
                "ms": round(ms, 4), "cudnn_ms": round(lib_ms, 4),
                "bound_ms": round(b_ms, 4), "bound_by": by,
                "ratio_to_cudnn": round(ms / lib_ms, 3)}
        if "parent_ms" in got:
            line["parent_ms"] = round(min(got["parent_ms"]), 4)
            line["parent_rank"] = theirs.index(blk)
        line["runs"] = {k: [round(x, 4) for x in v] for k, v in got.items()}
        emit(line, sink)
    if theirs and theirs[0] not in cands:
        got = _timed(timer, [("parent_ms",
                              parent.sparse_fn(img, wgt, theirs[0]))])
        emit({"sparse": "fig6.2 128x128 25x25 3x3 batch 32",
              "parent_rank": 0, "block": theirs[0],
              "parent_ms": round(min(got["parent_ms"]), 4),
              "cudnn_ms": round(lib_ms, 4), "bound_ms": round(b_ms, 4)},
             sink)


# Table 4.2's longest sums: (n, ic, h, w, oc, k) at block (oc 15, ic 15, y
# 2, x 2), scratch order: 90 x 121 and 210 x 121 terms a launch
LONG_SUMS = ((2, 90, 10, 10, 90, 11), (2, 210, 10, 10, 210, 11))
LONG_BLOCK = {"oc": 15, "ic": 15, "y": 2, "x": 2}


def _share_of_tol(got, want, peak=None):
    """Worst |got - want| as a share of the bf16 tolerance at the
    magnitude (``peak``, else ``want``), in float64."""
    from repro_torch.kernels._checks import bf16_tolerance
    diff = (got.double() - want.double()).abs()
    mag = want.double() if peak is None else peak.double()
    return round(float((diff / bf16_tolerance(mag)).max()), 4)


def _exact(img, wgt):
    """The conv in float64 (the reference the long sums are held to)."""
    n, _, h2, w2 = img.shape
    oc, _, kh, kw = wgt.shape
    h, w = h2 - kh + 1, w2 - kw + 1
    out = torch.zeros((n, oc, h, w), dtype=torch.float64, device=img.device)
    for ky in range(kh):
        for kx in range(kw):
            out += torch.einsum("nihw,oi->nohw",
                                img[:, :, ky:ky + h, kx:kx + w].double(),
                                wgt[:, :, ky, kx].double())
    return out


def precision_lines(dev, sink, parent=None):
    """The ``precision`` lines (numpy seed 0, weights scaled by 1/sqrt(ic
    kh kw))."""
    from repro_torch.kernels.conv2d import conv2d, conv2d_plain
    order = ("oc", "y", "x", "ic")
    rng = np.random.default_rng(0)
    for n, ic, h, w, oc, k in LONG_SUMS:
        img = torch.from_numpy(rng.standard_normal(
            (n, ic, h + k - 1, w + k - 1), dtype=np.float32)).to(dev)
        wgt = torch.from_numpy(rng.standard_normal(
            (oc, ic, k, k), dtype=np.float32)
            / np.float32((ic * k * k) ** 0.5)).to(dev)
        img, wgt = img.to(torch.bfloat16), wgt.to(torch.bfloat16)
        want, peak = conv2d_plain(img, wgt, block=LONG_BLOCK,
                                  grid_order=order, with_peak=True)
        exact = _exact(img, wgt)
        bodies = [("tree", lambda: conv2d(img, wgt, block=LONG_BLOCK,
                                          grid_order=order))]
        if parent is not None:
            bodies.append(("parent", lambda: parent.conv(img, wgt,
                                                         LONG_BLOCK, order)))
        line = {"precision": f"n{n} ic{ic} {h}x{w} oc{oc} k{k}",
                "terms": ic * k * k, "block": LONG_BLOCK,
                "plain_vs_float64": _share_of_tol(want, exact)}
        for who, fn in bodies:
            got = fn()
            again = fn()
            line[who] = _share_of_tol(got, want, peak)
            line[f"{who}_vs_float64"] = _share_of_tol(got, exact)
            line[f"{who}_bit_identical"] = bool(torch.equal(got, again))
        emit(line, sink)


def phase_lines(lib, phases, conv, sparse, dev, sink, without=None):
    """The ``phases`` lines, from the instrumented library."""
    from repro_torch.core import tuner
    from repro_torch.kernels import conv2d, sparse_conv2d
    from repro_torch.kernels.sparse_conv import analyze_weights
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    buf = np.zeros(MAX_STAMPS, np.int64)

    def run(fn, read, reset, what):
        fn()
        torch.cuda.synchronize()
        if reset() != 0:
            raise SystemExit("conv_timeline: resetting the stamps failed")
        flush.zero_()
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
        if read(buf.ctypes.data, MAX_STAMPS) != 0:
            raise SystemExit("conv_timeline: reading the stamps failed")
        emit({"phases": what, "without": without,
              **summarize(buf, phases)}, sink)

    for name in ("initial-conf", "conv-final"):
        l, img, wgt = conv[name]
        s = tuner.tune_conv(l, elem_bytes=2, top_k=1, batch=32)[0][0]
        blk, order = s.block_dict(), s.grid_order
        run(lambda: conv2d(img, wgt, block=blk, grid_order=order),
            lib.read_cm_stamps, lib.reset_cm_stamps,
            f"{name} batch 32 {''.join(a[0] for a in order)} {blk}")
    l, img, wgt = sparse
    blk = tuner.tune_sparse_conv(l, 0.25, elem_bytes=2, top_k=1, batch=32,
                                 weights=wgt)[0][0].block_dict()
    sp = analyze_weights(wgt, blk)
    run(lambda: sparse_conv2d(img, wgt, block=blk, sparsity=sp),
        lib.read_cm_stamps_sparse, lib.reset_cm_stamps_sparse,
        f"sparse fig6.2 batch 32 density 0.25 {blk}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the lines to this file")
    ap.add_argument("--parent", help="a checkout of another commit whose "
                    "bf16 bodies to time beside this tree's")
    ap.add_argument("--precision", action="store_true",
                    help="only print the precision lines")
    ap.add_argument("--without", choices=sorted(ABLATIONS),
                    help="remove this phase of the body (phases only)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("conv_timeline: needs a CUDA card")
    dev = torch.device("cuda")
    if args.out:
        open(args.out, "w").close()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    parent = Parent(args.parent) if args.parent else None
    if args.without is None:
        build_all([_build.load] + ([parent.tree.build.load] if parent
                                   else []))
        precision_lines(dev, args.out, parent)
        if args.precision:
            emit({"device": smi}, args.out)
            return
    conv, sparse = make_data(dev)
    if args.without is None:
        layer_times(Timer(dev), conv, sparse, args.out, parent)
    lib, phases = build(args.without)
    _build._lib = lib                 # the wrappers launch the copy
    phase_lines(lib, phases, conv, sparse, dev, args.out, args.without)
    emit({"device": smi}, args.out)


if __name__ == "__main__":
    main()
