"""Where a bf16 matmul call spends its time, and what each GEMM shape of
the thesis path costs beside cuBLAS and beside a parent checkout's body:
a scratch build of ``csrc/matmul.cu`` whose consumers stamp their
phases, CUDA-event times of the real library, and optionally a scratch
build of another checkout's matmul source.

    PYTHONPATH=src python -m repro_torch.launch.matmul_timeline \\
        [--out F] [--parent DIR] [--parent-only] [--precision]

Needs a CUDA card and ``nvcc``.  Prints JSON lines:

- ``gemm``: each shape of ``SHAPES`` (phi3-mini's QKV, O and down
  projections at the 512-token bucket, the GEMM forms of the 1 x 1
  Table 4.1 layers at batch 1) at this tree's rank-0 bf16 schedule: the
  kernel's ms (two runs), ``torch.matmul`` (cuBLAS) ms and the bound
  (A, B and C once at 3.35 TB/s, or the FLOPs at the 989 TFLOP/s bf16
  peak), with the launch plan (grid, tail split).  With ``--parent
  DIR`` (a checkout of another commit, unpacked inside this
  repository's ``build/``, imported beside this tree by
  ``parent_tree.load_parent``) the same shapes also run that checkout's
  ``matmul`` wrapper at its own tuner's rank-0 schedule, its library
  built from its sources, in the order parent, this tree, this tree,
  parent, in this one process;
- ``blocks``: QKV at a spread of blocks in the order (m, n, k), each
  with the bytes its tiles pull from L2 into shared memory (every tile
  reads its [bm, k] rows of A and its [k, bn] panel of B) over the
  call's time, one SM's rate within a wave (a tile's bytes over the
  call's time a wave of as many tiles as SMs), and the achieved TFLOP/s:
  an SM rate that stays flat across blocks whose FLOPs a byte differ
  says the call is bound by that traffic;
- ``phases``: one call at QKV and at down at the rank-0 schedule and at
  the schedules of ``PHASE_RUNS``, after an L2 flush, from the
  instrumented build: the blocks, the span from the first block's entry
  to the last block's end (``%globaltimer``), and per phase the median
  over blocks of thread 0's time in it (``clock64`` cycles at each
  block's cycles per ns) with its share: the prologue (barriers), the
  waits on ``full``, the MMAs (issue and the wait for the chunk
  before), the epilogue and the tail's fix-up (partials out, ticket,
  partials in).  The marks are ``MM_T_MARK`` in ``matmul_mma.cuh``.

``--precision`` prints, at QKV and down, the worst error as a share of
the bf16 tolerance against the plain version for cuBLAS, the parent
(with ``--parent``), this tree's body and this tree's body with every
tile summed in one part (``precision`` lines).  ``--parent-only`` times
only the parent (``gemm`` and ``blocks``), for reading a body before
changing it.  Then the card's name and power limit.  Times are medians
of 25 calls, each after a 256 MB write that flushes the L2 (cold
inputs, as ``chip_smoke.py`` times them).  Builds go to
``build/matmul_timeline/``; the kernel library is not changed.
"""
import argparse
import ctypes
import subprocess
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.launch.conv_timeline import (STAMP_WORDS, MAX_STAMPS, Timer,
                                              emit, summarize)
from repro_torch.launch.parent_tree import build_all, load_parent

OUT = _build.BUILD_DIR.parent / "matmul_timeline"
QKV = (512, 9216, 3072)
# (label, (m, n, k)): phi3-mini's projections at the 512-token bucket
# and the 1 x 1 Table 4.1 layers' GEMM forms at batch 1 ([oc, ic] x [ic,
# h w])
SHAPES = (("phi3-qkv", QKV), ("phi3-o", (512, 3072, 3072)),
          ("phi3-down", (512, 3072, 8192)),
          ("fire4-conv1x1-1", (32, 3025, 128)),
          ("fire4-conv1x1-2", (128, 3025, 32)),
          ("fire7-conv1x1-1", (48, 729, 384)),
          ("fire9-conv1x1-1", (64, 169, 512)),
          ("conv-final", (1000, 169, 512)))
PHASE_SHAPES = ("phi3-qkv", "phi3-down")
# and these schedules: (shape, block, order)
PHASE_RUNS = (("phi3-down", (128, 192, 64), "nmk"),
              ("conv-final", (50, 13, 64), "nmk"),
              ("fire4-conv1x1-1", (32, 11, 64), "nmk"))
BLOCK_SWEEP = ((128, 128, 64), (128, 192, 64), (128, 256, 64),
               (64, 192, 64), (64, 256, 64), (64, 128, 64))

# the marks' definitions, force-included into the instrumented build
STAMPS_H = r"""
#pragma once
static __device__ long long g_mm_stamps[%d];
__device__ __forceinline__ long long mm_ns() {
  long long t;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
  return t;
}
#define MM_T_BEGIN() \
  const long long _mm_g0 = mm_ns(); long long _mm_c = clock64(); \
  const long long _mm_c0 = _mm_c; \
  long long _mm_ph[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#define MM_T_MARK(k) \
  { const long long _n = clock64(); _mm_ph[k] += _n - _mm_c; _mm_c = _n; }
#define MM_T_END() \
  if (threadIdx.x == 0) { \
    long long* _s = g_mm_stamps + (size_t)blockIdx.x * %d; \
    _s[0] = _mm_g0; _s[1] = mm_ns(); _s[2] = clock64() - _mm_c0; \
    for (int _k = 0; _k < 8; ++_k) _s[3 + _k] = _mm_ph[_k]; \
  }
""" % (MAX_STAMPS, STAMP_WORDS)

# The phases the consumers mark (MM_T_MARK(k) ends phase k).
PHASES = ("prologue", "wait", "mma", "epilogue", "fixup")


def _nvcc(srcs, out_dir, flags, so_name):
    """Compile ``srcs`` in parallel and link them into ``so_name``."""
    procs, objs = [], []
    for src in srcs:
        obj = out_dir / (Path(src).name + ".o")
        objs.append(str(obj))
        procs.append(subprocess.Popen(
            [_build.nvcc_path(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", *flags, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for p in procs:
        text, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit("matmul_timeline: nvcc failed\n" + text)
    so = out_dir / so_name
    subprocess.run([_build.nvcc_path(), *_build.ARCH_FLAGS, "-shared", "-o",
                    str(so), *objs], check=True)
    lib = ctypes.CDLL(str(so))
    lib.kernels_error_string.argtypes = [ctypes.c_int]
    lib.kernels_error_string.restype = ctypes.c_char_p
    return lib


# the matmul's translation units: the float32 body, the entry points and
# the full bf16 instances; the lean instances
MATMUL_UNITS = ("matmul.cu", "matmul_lean.cu", "errors.cu")


def _reader(suffix=""):
    """C functions that read and reset a unit's stamps."""
    return ("\nextern \"C\" int read_mm_stamps%s(void* dst, long long n) {\n"
            "  return (int)cudaMemcpyFromSymbol(dst, g_mm_stamps,\n"
            "      sizeof(long long) * n);\n}\n"
            "extern \"C\" int reset_mm_stamps%s() {\n"
            "  void* p; cudaGetSymbolAddress(&p, g_mm_stamps);\n"
            "  return (int)cudaMemset(p, 0, sizeof(g_mm_stamps));\n}\n"
            % (suffix, suffix))


def _bind(lib):
    """The matmul entry points' argument types on a scratch library."""
    for fn in ("matmul_fwd", "matmul_mma_fwd", "matmul_mma_resident"):
        getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def instrumented_source():
    """(matmul_mma.cuh to build, phase names): the body with its marks."""
    return (_build.CSRC / "matmul_mma.cuh").read_text(), PHASES


def build_instrumented():
    """The instrumented kernel library (the matmul's units, its marks
    defined), with a reader and a reset of each unit's stamps (the full
    and the lean instances each stamp their own copy)."""
    out = OUT / "instrumented"
    out.mkdir(parents=True, exist_ok=True)
    (out / "mm_stamps.cuh").write_text(STAMPS_H)
    for p in _build.CSRC.glob("*.cu*"):
        (out / p.name).write_text(p.read_text())
    src, phases = instrumented_source()
    (out / "matmul_mma.cuh").write_text(src)
    (out / "matmul.cu").write_text((out / "matmul.cu").read_text()
                                   + _reader())
    (out / "matmul_lean.cu").write_text((out / "matmul_lean.cu").read_text()
                                        + _reader("_lean"))
    lib = _bind(_nvcc([out / u for u in MATMUL_UNITS], out,
                      ["-DMATMUL_TIMELINE", "-include",
                       str(out / "mm_stamps.cuh"), "-I", str(out)],
                      "libmatmul_timeline.so"))
    for fn in ("read_mm_stamps", "read_mm_stamps_lean"):
        getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    return lib, phases


class Parent:
    """Another checkout's bf16 matmul (:func:`parent_tree.load_parent`):
    its own wrapper at its own tuner's rank-0 schedule of each shape."""

    def __init__(self, root):
        self.tree = load_parent(root)
        self.rank0 = {}
        for label, (m, n, k) in SHAPES:
            s = self.tree.tuner.tune_matmul(m, n, k, elem_bytes=2,
                                            top_k=1)[0][0]
            self.rank0[label] = (s.block_dict(), tuple(s.grid_order),
                                 s.resident_rhs)

    def call(self, a, b, block, order, resident):
        return self.tree.kernels.matmul(a, b, block=block, grid_order=order,
                                        resident_rhs=resident)


def make_data(dev):
    """A [m, k] and B [k, n] of every shape, bf16 (numpy seed 0, B
    scaled by 1/sqrt(k))."""
    rng = np.random.default_rng(0)
    data = {}
    for label, (m, n, k) in SHAPES:
        a = rng.standard_normal((m, k), dtype=np.float32)
        b = rng.standard_normal((k, n), dtype=np.float32) / np.float32(
            k ** 0.5)
        data[label] = (torch.from_numpy(a).to(dev).to(torch.bfloat16),
                       torch.from_numpy(b).to(dev).to(torch.bfloat16))
    return data


def bound_ms(m, n, k):
    """(ms, by) of the least time: A, B and C once, or the FLOPs at the
    bf16 tensor-core peak."""
    t_b = (m * k + k * n + m * n) * 2 / 3.35e12 * 1e3
    t_o = 2 * m * n * k / 989e12 * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def _plan_fields(a, m, n, k, blk, order, resident):
    """The launch plan of this tree's body for one schedule."""
    from repro_torch.kernels.matmul import launch_plan
    count = k if resident or order[-1] == "k" else blk["k"]
    p = launch_plan(a, m, n, k, blk["m"], blk["n"], blk["k"], count,
                    resident)
    return {"grid": p.grid, "tail_tiles": p.tail_tiles,
            "splits": p.splits}


def gemm_times(timer, data, parent, sink, parent_only=False):
    """The ``gemm`` lines."""
    from repro_torch.core import tuner
    from repro_torch.kernels.matmul import matmul
    for label, (m, n, k) in SHAPES:
        a, b = data[label]
        b_ms, by = bound_ms(m, n, k)
        line = {"gemm": label, "mnk": [m, n, k],
                "cublas_ms": round(timer(lambda: torch.matmul(a, b)), 4),
                "bound_ms": round(b_ms, 4), "bound_by": by}
        runs = []
        if parent is not None:
            pb, po, pr = parent.rank0[label]
            p_fn = lambda: parent.call(a, b, pb, po, pr)  # noqa: E731
            line["parent_schedule"] = f"{''.join(po)} {pb} resident={pr}"
            runs.append(("parent_ms", p_fn))
        if not parent_only:
            s = tuner.tune_matmul(m, n, k, elem_bytes=2, top_k=1)[0][0]
            blk, order = s.block_dict(), s.grid_order
            fn = lambda: matmul(a, b, block=blk, grid_order=order,  # noqa
                                resident_rhs=s.resident_rhs)
            line["schedule"] = (f"{''.join(order)} {blk} "
                                f"resident={s.resident_rhs}")
            line["plan"] = _plan_fields(a, m, n, k, blk, order,
                                        s.resident_rhs)
            runs.insert(1 if runs else 0, ("ms", fn))
        # parent, new, new, parent
        seq = runs + runs[::-1]
        got = {}
        for key, fn in seq:
            got.setdefault(key, []).append(round(timer(fn), 4))
        line.update(got)
        best = min(min(v) for v in got.values())
        line["best_to_cublas"] = round(best / line["cublas_ms"], 3)
        emit(line, sink)


def block_times(timer, data, parent, sink, parent_only=False):
    """The ``blocks`` lines: QKV at a spread of blocks, order (m, n, k)."""
    from repro_torch.kernels.matmul import matmul
    m, n, k = QKV
    a, b = data["phi3-qkv"]
    order = ("m", "n", "k")
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    for bm, bn, bk in BLOCK_SWEEP:
        blk = {"m": bm, "n": bn, "k": bk}
        tiles = (m // bm) * (n // bn)
        l2_bytes = tiles * (bm * k + k * bn) * 2
        bodies = []
        if parent is not None:
            bodies.append(("parent", lambda: parent.call(a, b, blk, order,
                                                         False)))
        if not parent_only:
            bodies.append(("tree", lambda: matmul(a, b, block=blk,
                                                  grid_order=order)))
        # one block an SM: the tiles run in waves of the SMs
        waves = -(-tiles // sms)
        for who, fn in bodies:
            ms = timer(fn)
            emit({"blocks": "phi3-qkv mnk", "body": who, "block": blk,
                  "tiles": tiles, "waves": waves, "ms": round(ms, 4),
                  "l2_to_smem_tb_s": round(l2_bytes / ms / 1e9, 3),
                  "sm_gb_s_in_a_wave": round(
                      (bm * k + k * bn) * 2 / (ms / waves) / 1e6, 2),
                  "tflop_s": round(2 * m * n * k / ms / 1e9, 1)}, sink)


def phase_lines(lib, phases, data, dev, sink):
    """The ``phases`` lines, from the instrumented library."""
    from repro_torch.core import tuner
    from repro_torch.kernels.matmul import matmul
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    buf = np.zeros(MAX_STAMPS, np.int64)
    runs = []
    for label in PHASE_SHAPES:
        m, n, k = dict(SHAPES)[label]
        s = tuner.tune_matmul(m, n, k, elem_bytes=2, top_k=1)[0][0]
        runs.append((label, s.block_dict(), s.grid_order, s.resident_rhs))
    for label, (bm, bn, bk), order in PHASE_RUNS:
        runs.append((label, {"m": bm, "n": bn, "k": bk}, tuple(order),
                     False))
    for label, blk, order, res in runs:
        m, n, k = dict(SHAPES)[label]
        a, b = data[label]
        fn = lambda: matmul(a, b, block=blk, grid_order=order,  # noqa
                            resident_rhs=res)
        fn()
        torch.cuda.synchronize()
        if lib.reset_mm_stamps() != 0 or lib.reset_mm_stamps_lean() != 0:
            raise SystemExit("matmul_timeline: resetting the stamps failed")
        flush.zero_()
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
        lean = np.zeros_like(buf)
        if (lib.read_mm_stamps(buf.ctypes.data, MAX_STAMPS) != 0
                or lib.read_mm_stamps_lean(lean.ctypes.data,
                                           MAX_STAMPS) != 0):
            raise SystemExit("matmul_timeline: reading the stamps failed")
        buf += lean       # one flavour ran: the other's stamps are zeros
        emit({"phases": f"{label} {''.join(order)} {blk}",
              "plan": _plan_fields(a, m, n, k, blk, order, res),
              **summarize(buf, phases)}, sink)


def _share_of_tol(got, want):
    """Worst |got - want| as a share of two bf16 ulps of ``want`` plus
    1e-5 (chip_smoke.py's contract)."""
    diff = (got.float() - want.float()).abs()
    mag = want.float().abs().clamp_min(2.0 ** -126)
    return float((diff / (2 * torch.exp2(torch.floor(torch.log2(mag)) - 7)
                          + 1e-5)).max())


def precision_lines(parent, data, sink):
    """The ``precision`` lines: at QKV and down, the worst error as a
    share of the bf16 tolerance against the plain version for cuBLAS,
    the parent's body (with ``--parent``), this tree's at its plan and
    this tree's with every unit summed in one part (no split)."""
    from repro_torch.core import tuner
    from repro_torch.kernels import _geometry as geo
    from repro_torch.kernels.matmul import matmul, matmul_plain
    for label in ("phi3-qkv", "phi3-down"):
        m, n, k = dict(SHAPES)[label]
        a, b = data[label]
        s = tuner.tune_matmul(m, n, k, elem_bytes=2, top_k=1)[0][0]
        blk, order = s.block_dict(), s.grid_order
        want = matmul_plain(a, b, block=blk, grid_order=order)
        line = {"precision": label, "schedule": f"{''.join(order)} {blk}",
                "cublas": _share_of_tol(torch.matmul(a, b), want),
                "tree": _share_of_tol(matmul(a, b, block=blk,
                                             grid_order=order), want)}
        keep = geo.MMA_PART_K, geo.MMA_MAX_SPLITS
        geo.MMA_PART_K, geo.MMA_MAX_SPLITS = 1 << 30, 1
        try:
            line["tree_one_part"] = _share_of_tol(
                matmul(a, b, block=blk, grid_order=order), want)
        finally:
            geo.MMA_PART_K, geo.MMA_MAX_SPLITS = keep
        if parent is not None:
            pb, po, pr = parent.rank0[label]
            line["parent"] = _share_of_tol(
                parent.call(a, b, pb, po, pr),
                matmul_plain(a, b, block=pb, grid_order=po,
                             resident_rhs=pr))
        emit({k2: round(v, 4) if isinstance(v, float) else v
              for k2, v in line.items()}, sink)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the lines to this file")
    ap.add_argument("--parent", help="a checkout of another commit whose "
                    "bf16 body to time beside this tree's")
    ap.add_argument("--parent-only", action="store_true",
                    help="time only the parent's body (needs --parent)")
    ap.add_argument("--precision", action="store_true",
                    help="only print the precision lines")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("matmul_timeline: needs a CUDA card")
    if args.parent_only and not args.parent:
        raise SystemExit("matmul_timeline: --parent-only needs --parent")
    dev = torch.device("cuda")
    data = make_data(dev)
    if args.out:
        open(args.out, "w").close()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    parent = Parent(args.parent) if args.parent else None
    build_all(([] if args.parent_only else [_build.load])
              + ([parent.tree.build.load] if parent else []))
    if args.precision:
        precision_lines(parent, data, args.out)
        emit({"device": smi}, args.out)
        return
    timer = Timer(dev)
    gemm_times(timer, data, parent, args.out, args.parent_only)
    block_times(timer, data, parent, args.out, args.parent_only)
    if not args.parent_only:
        lib, phases = build_instrumented()
        _build._lib = lib             # the wrappers launch the copy
        phase_lines(lib, phases, data, dev, args.out)
    emit({"device": smi}, args.out)


if __name__ == "__main__":
    main()
