"""Where a bf16 conv call spends its time, and what each Table 4.1 layer
costs beside cuDNN: a scratch build of the conv sources whose implicit
GEMM (``conv_mma.cuh``) stamps each block's phases, and CUDA-event times
of the real library.

    PYTHONPATH=src python -m repro_torch.launch.conv_timeline [--out F]
        [--without pass|loads|mma|epilogue]

Needs a CUDA card and ``nvcc``.  Prints JSON lines:

- ``layer``: each Table 4.1 layer at batch 1 and 32 at the tuner's
  rank-0 bf16 schedule: kernel ms, ``F.conv2d`` (cuDNN) ms and the bound
  (image, weights and output once at 3.35 TB/s, or the MACs at the 989
  TFLOP/s bf16 peak), then their sums at batch 32;
- ``sparse``: the block-sparse conv on the thesis' Fig 6.2 layer (128 x
  128, 25 x 25, 3 x 3) at batch 32 and block density 0.25: the rank-0
  skip block and every other candidate the tuner offers, each timed,
  beside ``F.conv2d`` on the zeroed weights and the bound;
- ``phases``: one call of ``initial-conf`` (3 x 3), ``conv-final``
  (1 x 1) and the Fig 6.2 sparse layer at density 0.25, batch 32, after
  an L2 flush, from the instrumented build: the blocks, the span from
  the first block's entry to the last block's end (``%globaltimer``),
  and per phase the median over blocks of the block's own time in it
  (``clock64`` cycles, turned into us by each block's cycles per ns),
  with its share of the block's time.  The phases are the body's marks
  (``CM_T_MARK`` in ``conv_mma.cuh``: the prologue up to the first
  multiply, the waits on loads and barriers, the issue of the next
  loads, the channels-last pass, the MMAs, the epilogue).

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
    "mma": ("      load(fa0, fb0);\n      for (int j = 0; j < steps_k;",
            "      for (int j = 0; j < 0;"),
    "epilogue": ("                if (oc < a.boc) store_pair(",
                 "                if (oc < 0) store_pair("),
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


def layer_times(timer, conv, sparse, sink):
    """The ``layer`` and ``sparse`` lines."""
    import torch.nn.functional as F
    from repro_torch.core import tuner
    from repro_torch.kernels import conv2d, sparse_conv2d
    from repro_torch.kernels.sparse_conv import analyze_weights
    tot = {"ms": 0.0, "cudnn_ms": 0.0, "bound_ms": 0.0}
    for n in (1, 32):
        for name, (l, img32, wgt) in conv.items():
            img = img32[:n].contiguous()
            s = tuner.tune_conv(l, elem_bytes=2, top_k=1, batch=n)[0][0]
            blk, order = s.block_dict(), s.grid_order
            b_ms, by = bound_ms(l, n)
            t = {"ms": timer(lambda: conv2d(img, wgt, block=blk,
                                            grid_order=order)),
                 "cudnn_ms": timer(lambda: F.conv2d(img, wgt)),
                 "bound_ms": b_ms}
            if n == 32:
                for k in tot:
                    tot[k] += t[k]
            emit({"layer": name, "batch": n,
                          "schedule": f"{''.join(a[0] for a in order)} {blk}",
                          **{k: round(v, 4) for k, v in t.items()},
                          "bound_by": by,
                  "ratio_to_cudnn": round(t["ms"] / t["cudnn_ms"], 3)},
                 sink)
    emit({"layer": "sum of the 8 at batch 32",
                  **{k: round(v, 4) for k, v in tot.items()},
          "ratio_to_cudnn": round(tot["ms"] / tot["cudnn_ms"], 3)}, sink)
    l, img, wgt = sparse
    cands = [s.block_dict() for s, _ in tuner.tune_sparse_conv(
        l, 0.25, elem_bytes=2, top_k=1000, batch=32)]
    lib_ms = timer(lambda: F.conv2d(img, wgt))
    b_ms, by = bound_ms(l, 32, analyze_weights(wgt, {"oc": 16, "ic": 16})
                        .density)
    for rank, blk in enumerate(cands):
        sp = analyze_weights(wgt, blk)
        ms = timer(lambda: sparse_conv2d(img, wgt, block=blk, sparsity=sp))
        emit({"sparse": "fig6.2 128x128 25x25 3x3 batch 32",
                      "rank": rank, "block": blk,
                      "block_density": round(sp.density, 4),
                      "ms": round(ms, 4), "cudnn_ms": round(lib_ms, 4),
                      "bound_ms": round(b_ms, 4), "bound_by": by,
                      "ratio_to_cudnn": round(ms / lib_ms, 3)}, sink)


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
    blk = tuner.tune_sparse_conv(l, 0.25, elem_bytes=2, top_k=1,
                                 batch=32)[0][0].block_dict()
    sp = analyze_weights(wgt, blk)
    run(lambda: sparse_conv2d(img, wgt, block=blk, sparsity=sp),
        lib.read_cm_stamps_sparse, lib.reset_cm_stamps_sparse,
        f"sparse fig6.2 batch 32 density 0.25 {blk}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the lines to this file")
    ap.add_argument("--without", choices=sorted(ABLATIONS),
                    help="remove this phase of the body (phases only)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("conv_timeline: needs a CUDA card")
    dev = torch.device("cuda")
    conv, sparse = make_data(dev)
    if args.out:
        open(args.out, "w").close()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    if args.without is None:
        _build.load()
        layer_times(Timer(dev), conv, sparse, args.out)
    lib, phases = build(args.without)
    _build._lib = lib                 # the wrappers launch the copy
    phase_lines(lib, phases, conv, sparse, dev, args.out, args.without)
    emit({"device": smi}, args.out)


if __name__ == "__main__":
    main()
