"""Where a split-decode call spends its time: a scratch build of the
decode sources that stamps ``%globaltimer`` (ns) at each phase of every
block, run once at ``chip_smoke.py``'s two decode shapes.

    PYTHONPATH=src python -m repro_torch.launch.decode_timeline

Needs a CUDA card and ``nvcc``.  The instrumented copy and its library
go to ``build/decode_timeline/`` (the kernel library itself is not
changed).  Phases of a block with keys: entry; ``loaded`` (pos, starts,
q and the split's table entries read); ``k_staged`` (K in shared
memory); ``scored``; ``v_staged`` (softmax done and V in); ``pv_done``;
``ticket`` (partial published, ticket drawn); ``end`` (output written by
the merging block or by a row's only live split).  The packed body
(``decode_packed_kernel``, recurrentgemma's rolling decode) has its own
phases: entry; ``loaded`` (pos, starts, the group's q, the table; a
contiguous cache's first tile is already in flight);
``tiles`` (every tile's scores and P V done); ``reduced`` (l summed over
the warps); ``level2`` (the row's last cluster, past its ticket);
``end`` (the cluster's combine done, or the last cluster's).
Prints, per shape,
one JSON line: the blocks, the live ones, the span from the first block
entry to the last stamp, and each stamp's median and maximum over the
live blocks in us after the first entry (the L2 is flushed before the
call, as ``chip_smoke.py``'s timer does), then the card's name and power
limit.
"""
import ctypes
import json
import subprocess

import numpy as np
import torch

from repro_torch.kernels import _build, decode_attention
from repro_torch.kernels import paged_decode_attention
from repro_torch.kernels._geometry import decode_plan

STAMPS = ("entry", "loaded", "k_staged", "scored", "v_staged", "pv_done",
          "ticket", "end")
OUT = _build.BUILD_DIR.parent / "decode_timeline"


def _stamp(k: int) -> str:
    return (f"  if (threadIdx.x == 0) g_stamps[((size_t)blockIdx.y * "
            f"gridDim.x + blockIdx.x) * 8 + {k}] = stamp_ns();\n")


# (anchor in decode_common.cuh, stamp inserted before it)
ANCHORS = (
    ("  // pos, starts and q are loaded together", 0),
    ("  const int ud = (D + VE - 1) / VE;", 1),
    ("    } else {\n      // columns D .. ud * VE - 1 are zeros", 2),
    ("    // ---- online softmax", 3),
    ("    // ---- acc = acc * alpha + P V", 4),
    ("  if (n_live == 1) {", 5),
    ("  if (!*last_s) return;", 6),
)
# the row's only live split writes its output directly; the merge's end
DIRECT = ("        og[q_row * D + idx] = from_f<T>(l > 0.f ? acc[o] / l"
          " : 0.f);\n      }\n    }\n")
MERGED = "    og[q_row * D + idx] = from_f<T>(x / l);\n  }\n}"
# the packed body's phases, anchors (stamp before) and ends
PACKED_STAMPS = ("entry", "loaded", "tiles", "reduced", "level2", "end")
PACKED_ANCHORS = (
    ("  // keys t0 .. t0 + nk - 1 into stage st;", 0),
    ("  float o[MT][NC][4];", 1),
    ("  // l of each row: the quad's, then the four warps'", 2),
    ("  // ---- combine, level 1: the cluster's C splits (blocks) leave", 3),
)
# stamps after: the last cluster past its ticket, every block past the
# cluster's combine, the last cluster's end
PACKED_MERGING = "  if (!is_last) return;\n"
PACKED_DIRECT = ("  hw::cluster_sync();                // the partials' reads "
                 "are done\n")
PACKED_MERGED = ("    dst[1] = __floats2bfloat162_rn(x.z * inv, x.w * inv);"
                 "\n  }\n}")


def instrumented_source() -> str:
    """decode_common.cuh with a stamp before each anchor, and one after
    the merge and after a row's only live split's write."""
    src = (_build.CSRC / "decode_common.cuh").read_text()
    head = ("__device__ long long g_stamps[1 << 20];\n"
            "__device__ __forceinline__ long long stamp_ns() {\n"
            "  long long t;\n"
            "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
            "  return t;\n}\n")
    src = src.replace("namespace rt {\n", "namespace rt {\n" + head, 1)
    for anchor, k in ANCHORS:
        if src.count(anchor) != 1:
            raise SystemExit(f"decode_timeline: {anchor!r} not found once "
                             f"in decode_common.cuh")
        stamp = _stamp(k)
        if k == 2:      # after the K wait, inside the vec branch
            stamp = "  " + stamp
        src = src.replace(anchor, stamp + anchor)
    if src.count(DIRECT) != 1:
        raise SystemExit("decode_timeline: the direct write not found once")
    src = src.replace(DIRECT, DIRECT + _stamp(7))
    if src.count(MERGED) != 1:
        raise SystemExit("decode_timeline: the merge's end not found once")
    src = src.replace(MERGED, MERGED[:-1] + _stamp(7) + "}")
    for anchor, k in PACKED_ANCHORS:
        if src.count(anchor) != 1:
            raise SystemExit(f"decode_timeline: {anchor!r} not found once "
                             f"in decode_common.cuh")
        src = src.replace(anchor, _stamp(k) + anchor)
    for text, k, where in ((PACKED_MERGING, 4, "the last cluster"),
                           (PACKED_DIRECT, 5, "the cluster combine's end"),
                           (PACKED_MERGED, 5, "the packed merge's end")):
        if src.count(text) != 1:
            raise SystemExit(f"decode_timeline: {where} not found once")
        src = src.replace(text, text + _stamp(k) if text.endswith("\n")
                          else text[:-1] + _stamp(k) + "}")
    return src


def build():
    """The instrumented decode library with a reader of the stamps."""
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "decode_common.cuh").write_text(instrumented_source())
    for name in ("common.cuh", "hopper.cuh", "errors.cu"):
        (OUT / name).write_text((_build.CSRC / name).read_text())
    # each entry's file holds its own copy of the stamps, and a reader
    for name, reader in (("decode_attention.cu", "read_stamps"),
                         ("paged_decode_attention.cu", "read_stamps_paged")):
        (OUT / name).write_text(
            (_build.CSRC / name).read_text()
            + f"\nextern \"C\" int {reader}(void* dst, int n) {{\n"
              "  return (int)cudaMemcpyFromSymbol(dst, rt::g_stamps,\n"
              "      sizeof(long long) * n);\n}\n")
    objs = []
    for name in ("decode_attention.cu", "paged_decode_attention.cu",
                 "errors.cu"):
        obj = OUT / (name + ".o")
        objs.append(str(obj))
        res = subprocess.run(
            [_build.nvcc_path(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-I", str(OUT), "-c", str(OUT / name),
             "-o", str(obj)], capture_output=True, text=True)
        if res.returncode != 0:
            raise SystemExit("decode_timeline: nvcc failed\n" + res.stdout
                             + res.stderr)
    so = OUT / "libdecode_timeline.so"
    subprocess.run([_build.nvcc_path(), *_build.ARCH_FLAGS, "-shared",
                    "-o", str(so), *objs], check=True)
    lib = ctypes.CDLL(str(so))
    for fn in ("decode_attention_fwd", "paged_decode_attention_fwd"):
        getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    lib.kernels_error_string.argtypes = [ctypes.c_int]
    lib.kernels_error_string.restype = ctypes.c_char_p
    for reader in ("read_stamps", "read_stamps_paged"):
        getattr(lib, reader).argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def timeline(read, plan, fn, flush, names=STAMPS):
    """Run ``fn`` once after an L2 flush; the summary of the stamps that
    ``read`` copies out, named ``names``."""
    n = plan.blocks * 8
    fn()                              # warm: the wrapper's scratch exists
    flush.zero_()
    torch.cuda.synchronize()
    fn()
    torch.cuda.synchronize()
    buf = np.zeros(n, np.int64)
    if read(buf.ctypes.data, n) != 0:
        raise SystemExit("decode_timeline: reading the stamps failed")
    t = buf.reshape(plan.blocks, 8).astype(np.float64)
    t0 = t[:, 0].min()
    live = t[:, 1] >= t0
    rel = np.where(t >= t0, (t - t0) / 1e3, np.nan)[live]
    out = {"blocks": plan.blocks, "live_blocks": int(live.sum()),
           "span_us": round(float(np.nanmax(rel)), 2)}
    for k, name in enumerate(names):
        col = rel[:, k]
        if np.isfinite(col).any():
            out[name] = {"median_us": round(float(np.nanmedian(col)), 2),
                         "max_us": round(float(np.nanmax(col)), 2)}
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("decode_timeline: needs a CUDA card")
    dev = torch.device("cuda")
    lib = build()
    _build._lib = lib                 # the wrappers launch the copy
    gen = torch.Generator(device=dev).manual_seed(1)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    s = 544
    q, k, v = rn(4, 32, 1, 96), rn(4, 32, s, 96), rn(4, 32, s, 96)
    st = torch.tensor([472, 412, 262, 212], device=dev)
    res = {"decode_attention q [4,32,1,96] k/v [4,32,544,96] pos 512":
           timeline(lib.read_stamps, decode_plan(4, 32, 32, 96, s, 0, 2),
                    lambda: decode_attention(q, k, v, 512, starts=st),
                    flush)}
    bs, mb = 16, 34
    nb = 1 + 4 * mb
    kp, vp = rn(nb, 32, bs, 96), rn(nb, 32, bs, 96)
    perm = torch.randperm(nb - 1, generator=torch.Generator()
                          .manual_seed(7)) + 1
    tables = perm.reshape(4, mb).to(torch.int32).to(dev)
    pos = torch.tensor([17, 100, 300, 511], dtype=torch.int32, device=dev)
    res["paged_decode_attention q [4,32,1,96] pools [137,32,16,96] "
        "pos [17,100,300,511]"] = timeline(
        lib.read_stamps_paged, decode_plan(4, 32, 32, 96, mb * bs, bs, 2),
        lambda: paged_decode_attention(q, kp, vp, tables, pos), flush)
    # the packed body: recurrentgemma's 16 heads of 256 on one KV head
    # over its wrapped 2048-slot rolling buffer
    s = 2048
    qr, kr, vr = rn(4, 16, 1, 256), rn(4, 1, s, 256), rn(4, 1, s, 256)
    pr = torch.tensor([2048, 2500, 3000, 4127], device=dev)
    res["decode_attention (packed) q [4,16,1,256] rolling k/v "
        "[4,1,2048,256] pos [2048,2500,3000,4127]"] = timeline(
        lib.read_stamps, decode_plan(4, 16, 1, 256, s, 0, 2),
        lambda: decode_attention(qr, kr, vr, pr), flush, PACKED_STAMPS)
    for shape, r in res.items():
        print(json.dumps({"shape": shape, **r}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())


if __name__ == "__main__":
    main()
