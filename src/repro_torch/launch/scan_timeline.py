"""Where a selective-scan call spends its time: a scratch build of
``csrc/ssm_scan.cu`` that stamps ``%globaltimer`` (ns) at each phase of
every block, run once at ``chip_smoke.py``'s scan shapes.

    PYTHONPATH=src python -m repro_torch.launch.scan_timeline

Needs a CUDA card and ``nvcc``.  The instrumented copy and its library
go to ``build/scan_timeline/`` (the kernel library itself is not
changed).  Stamps of thread 0 of a block: ``entry``; ``states_in`` (its
a and h0 arrived); ``tile0_in`` (the first tile staged, past the
block's barrier); ``steps_done`` (the last tile's steps scanned);
``end`` (the final state stored).  Prints, per shape, one JSON line: the
blocks, the span from the first block's entry to the last stamp, each
stamp's median and maximum over the blocks in us after the first entry
(the L2 is flushed before the call, as ``chip_smoke.py``'s timer does),
the median time a tile's steps took (``steps_done`` less ``tile0_in``
over the tiles) and the call's CUDA-event time as ``chip_smoke.py``
takes it; then that time for a 4-byte fill (the floor of one launch so
timed), and the card's name and power limit.
"""
import ctypes
import json
import subprocess

import numpy as np
import torch

from repro_torch.kernels import _build, ssm_scan
from repro_torch.kernels._geometry import SCAN_TILE_STEPS
from repro_torch.kernels.ssm_scan import DEFAULT_BLOCK_D
from repro_torch.launch.scan_variants import (DI, GENERATE_PROMPTS,
                                              event_ms, scan_inputs)

STAMPS = ("entry", "states_in", "tile0_in", "steps_done", "end")
OUT = _build.BUILD_DIR.parent / "scan_timeline"


def _stamp(k: int, cond: str = "true", dep: str = "0") -> str:
    return (f"  if (threadIdx.x == 0 && ({cond})) g_stamps[((size_t)"
            f"blockIdx.y * gridDim.x + blockIdx.x) * 5 + {k}] = "
            f"stamp_ns() + (long long)({dep});\n")


# (anchor in ssm_scan.cu, stamp inserted before it)
ANCHORS = (
    ("  float av[kP], h[kP];\n", _stamp(0)),
    # the loads must have arrived: the stamp reads them (times zero)
    ("  const int n_tiles = (S + kTile - 1) / kTile;\n",
     _stamp(1, dep="h[0] * 0.f + av[0] * 0.f")),
    ("    if (k + 1 < n_tiles)\n      stage_tile(", _stamp(2, "k == 0")),
    ("    __syncthreads();             // the tile's y is in shared memory",
     _stamp(3, "k == n_tiles - 1", "h[0] * 0.f")),
)
END = "  if (live) store_states(hout + hoff, h, vec);\n"


def instrumented_source() -> str:
    """ssm_scan.cu with a stamp before each anchor and one at the end."""
    src = (_build.CSRC / "ssm_scan.cu").read_text()
    head = ("__device__ long long g_stamps[1 << 20];\n"
            "__device__ __forceinline__ long long stamp_ns() {\n"
            "  long long t;\n"
            "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
            "  return t;\n}\n")
    src = src.replace("namespace rt {\n", "namespace rt {\n" + head, 1)
    for anchor, stamp in ANCHORS + ((END, None),):
        if src.count(anchor) != 1:
            raise SystemExit(f"scan_timeline: {anchor!r} not found once "
                             f"in ssm_scan.cu")
    for anchor, stamp in ANCHORS:
        src = src.replace(anchor, stamp + anchor)
    src = src.replace(END, END + _stamp(4, dep="h[0] * 0.f"))
    return src + ("\nextern \"C\" int read_stamps(void* dst, int n) {\n"
                  "  return (int)cudaMemcpyFromSymbol(dst, rt::g_stamps,\n"
                  "      sizeof(long long) * n);\n}\n")


def build():
    """The instrumented scan library with a reader of the stamps."""
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "ssm_scan.cu").write_text(instrumented_source())
    for name in ("common.cuh", "hopper.cuh", "errors.cu"):
        (OUT / name).write_text((_build.CSRC / name).read_text())
    so = OUT / "libscan_timeline.so"
    res = subprocess.run(
        [_build.nvcc_path(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-shared", "-I", str(OUT),
         str(OUT / "ssm_scan.cu"), str(OUT / "errors.cu"), "-o", str(so)],
        capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit("scan_timeline: nvcc failed\n" + res.stdout
                         + res.stderr)
    lib = ctypes.CDLL(str(so))
    lib.ssm_scan_fwd.argtypes = _build.SIGNATURES["ssm_scan_fwd"]
    lib.ssm_scan_fwd.restype = ctypes.c_int
    lib.kernels_error_string.argtypes = [ctypes.c_int]
    lib.kernels_error_string.restype = ctypes.c_char_p
    lib.read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def timeline(lib, blocks, n_tiles, fn, flush):
    """Run ``fn`` once after an L2 flush; the summary of its stamps."""
    n = blocks * 5
    fn()
    flush.zero_()
    torch.cuda.synchronize()
    fn()
    torch.cuda.synchronize()
    buf = np.zeros(n, np.int64)
    if lib.read_stamps(buf.ctypes.data, n) != 0:
        raise SystemExit("scan_timeline: reading the stamps failed")
    t = buf.reshape(blocks, 5).astype(np.float64)
    rel = (t - t[:, 0].min()) / 1e3
    out = {"blocks": blocks, "span_us": round(float(rel.max()), 2)}
    for k, name in enumerate(STAMPS):
        out[name] = {"median_us": round(float(np.median(rel[:, k])), 2),
                     "max_us": round(float(rel[:, k].max()), 2)}
    out["tile_us"] = round(float(np.median(rel[:, 3] - rel[:, 2]))
                           / n_tiles, 3)
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("scan_timeline: needs a CUDA card")
    dev = torch.device("cuda")
    lib = build()
    _build._lib = lib                 # the wrapper launches the copy
    gen = torch.Generator(device=dev).manual_seed(1)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    shapes = {"decode [4,1,8192] h0": (4, 1, (), True),
              "prefill [1,512,8192] real 300": (1, 512, (300,), False),
              f"prefill [4,512,8192] real {GENERATE_PROMPTS}":
                  (4, 512, tuple(GENERATE_PROMPTS), False)}
    for shape, (bt, s, real, h0) in shapes.items():
        args = scan_inputs(gen, torch.bfloat16, bt, s, real, h0)
        blocks = bt * -(-DI // DEFAULT_BLOCK_D)
        res = timeline(lib, blocks, -(-s // SCAN_TILE_STEPS),
                       lambda: ssm_scan(*args), flush)
        print(json.dumps({"shape": shape, "block_d": DEFAULT_BLOCK_D,
                          "event_ms": round(event_ms(
                              lambda: ssm_scan(*args), flush), 4),
                          **res}), flush=True)
    one = torch.empty(1, device=dev)
    print(json.dumps({"one_launch_floor_ms": round(event_ms(
        one.zero_, flush), 4), "what": "a 4-byte fill, timed the same way"}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())


if __name__ == "__main__":
    main()
