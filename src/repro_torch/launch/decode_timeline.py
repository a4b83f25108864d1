"""phi3's attention kernels on the card: each call's time beside a
parent checkout's at the same inputs, and where a split-decode call
spends its time.

    PYTHONPATH=src python -m repro_torch.launch.decode_timeline \\
        [--parent DIR] [--splits] [--times-only] [--out F]

Needs a CUDA card and ``nvcc``.  Two parts:

- ``time`` lines: phi3-mini's three attention kernels at the main
  path's inputs (bf16, 32 heads of 96, MHA): flash ``[1,32,S,96]``,
  causal, at every engine prefill bucket S of 8-512, without and with
  the left-pad ``starts`` of a prompt of that bucket, at 64 and 128
  query rows a block, and ``generate``'s ``[4,32,512,96]``; the paged
  decode of 1, 2 and 4 rows over the engine's ``[137,32,16,96]`` pool
  (positions 17-511, shuffled tables); the contiguous decode
  ``[4,32,544,96]`` at positions 512, 530 and 543 with left-pad starts.
  Each line holds the body this tree's rule runs, its median device ms
  (CUDA events, median of 25 calls, the 50 MB L2 flushed before each,
  the stream kept busy while the host enqueues), the bound (bytes and
  operations the inputs need, at 3.35 TB/s and 989 TFLOP/s), SDPA's ms
  where one call computes the same function, and the worst error as a
  share of the tolerance (2 bf16 ulps of the plain value + 1e-5).  A
  flash line also holds ``err64``: each output's error against the
  float64 attention of the same bf16 inputs (q scaled as the kernels
  scale it), as its maximum, its mean and the share of outputs other
  than that value rounded to bf16, for this tree's kernel, the plain
  version and SDPA.  With ``--parent DIR`` (a checkout of another
  commit, unpacked inside this repository's ``build/``, imported beside
  this tree by ``parent_tree.load_parent``, its library built from its
  sources into its own ``build/kernels/``), each line also holds the
  parent's wrapper on the same inputs under the parent's own rule: its
  ms, its error share and, for flash, its ``err64``, timed in the order
  parent, this tree, this tree, parent in this one process.  The script
  exits 1 after the lines if any call of this tree is outside the
  tolerance.
- ``split`` lines (with ``--splits``): each decode call of the ``time``
  lines at every split of ``SPLIT_SWEEP`` its kernel takes (the keys a
  block walks: a ``DecodeAttentionSchedule``'s ``block_kv``), with the
  plan it gives (splits, cluster, blocks, shared memory) and its ms.
- ``timeline`` lines (not with ``--times-only``): a scratch build of the
  decode sources that stamps ``%globaltimer`` (ns) at each phase of
  every block, run once at the paged and contiguous shapes above and at
  recurrentgemma's rolling decode.  The instrumented copy and its
  library go to ``build/decode_timeline/`` (the kernel library itself
  is not changed).  Phases of a block of the chunked body with keys:
  entry; ``loaded`` (pos, starts, q and the split's table entries
  read); ``k_staged`` (K in shared memory); ``scored``; ``v_staged``
  (softmax done and V in); ``pv_done``; ``ticket`` (partial published,
  ticket drawn); ``end`` (output written by the merging block or by a
  row's only live split).  The packed body (``decode_packed_kernel``)
  has its own phases: entry; ``loaded`` (pos, starts, the group's q,
  the table; a contiguous cache's first tile is already in flight);
  ``tiles`` (every tile's scores and P V done); ``reduced`` (l summed
  over the warps); ``level2`` (the row's last cluster, past its
  ticket); ``end`` (the cluster's combine done, or the last
  cluster's).  Per shape one JSON line: the blocks, the live ones, the
  span from the first block entry to the last stamp, and each stamp's
  median and maximum over the live blocks in us after the first entry
  (the L2 flushed before the call).

The last line is the card's name and power limit.
"""
import argparse
import ctypes
import subprocess

import numpy as np
import torch

from repro_torch.kernels import _build, decode_attention
from repro_torch.kernels import flash_attention, paged_decode_attention
from repro_torch.kernels import _geometry as geo
from repro_torch.kernels._checks import scale_q
from repro_torch.kernels._geometry import decode_plan
from repro_torch.kernels.decode_attention import (decode_attention_ref,
                                                  paged_decode_attention_ref)
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.launch.conv_timeline import Timer, emit
from repro_torch.launch.matmul_timeline import _share_of_tol as share_of_tol
from repro_torch.launch.parent_tree import build_all, load_parent

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


# phi3-mini's attention: heads and head dim (MHA), the engine's prefill
# buckets with a prompt of each (chip_smoke.py's requests where it has
# one), generate's prompts in its 512-token bucket, the pool geometry
HQ, D = 32, 96
FLASH_PROMPTS = {8: 5, 16: 12, 32: 17, 64: 45, 128: 77, 256: 200, 512: 300}
GENERATE_PROMPTS = (40, 100, 250, 300)
POOL_BS, POOL_MB = 16, 34
PAGED_POS = ([300], [17, 511], [17, 100, 300, 511])
CONTIG_S, CONTIG_POS = 544, (512, 530, 543)
HBM_BYTES_PER_S, BF16_OPS_PER_S = 3.35e12, 989e12
SPLIT_SWEEP = (32, 48, 64, 96, 128, 144, 192, 272, 544)


def rule_body(kernel, q, k):
    """The body this tree's rule gives a call."""
    if kernel == "flash_attention":
        return geo.flash_body(q.shape[-1], q.element_size())
    return geo.decode_body(q.shape[1], k.shape[1], q.shape[-1],
                           q.element_size())


def exact_attention(q, k, v, keep):
    """The float64 attention of bf16 q/k/v ([B, H, S, D], one KV head a
    query head) under ``keep`` (a mask that broadcasts to [B, H, S, S]),
    q scaled in bf16 as the kernels scale it; rows with no key give
    zeros, as the kernels do."""
    scores = scale_q(q).double() @ k.double().transpose(-1, -2)
    p = torch.softmax(scores.masked_fill(~keep, float("-inf")), dim=-1)
    return torch.nan_to_num(p, nan=0.0) @ v.double()


def err64(got, exact):
    """{max, mean, off}: |got - exact| at its largest and on average, and
    the share of outputs other than ``exact`` rounded to bf16."""
    d = (got.double() - exact).abs()
    return {"max": d.max().item(), "mean": d.mean().item(),
            "off": (got != exact.to(got.dtype)).double().mean().item()}


def bound_ms(n_bytes, n_ops):
    """(least ms, what bounds it) at the card's memory and bf16 rates."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, n_ops / BF16_OPS_PER_S
    return (t_b * 1e3, "bytes") if t_b >= t_o else (t_o * 1e3, "operations")


def phi3_cases(dev):
    """(kernel, label, args, kwargs, bound, mask for SDPA or None) of
    every timed call, on inputs from a seeded generator."""
    gen = torch.Generator(device=dev).manual_seed(1)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    cases = []
    for s, real in FLASH_PROMPTS.items():
        q, k, v = rn(1, HQ, s, D), rn(1, HQ, s, D), rn(1, HQ, s, D)
        for st in (None, s - real):
            n = s if st is None else real
            kw = {} if st is None else {"starts": torch.tensor([st],
                                                               device=dev)}
            keep = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
            keep = keep & (torch.arange(s, device=dev)[None, :] >= (st or 0))
            b = bound_ms((3 * n + s) * HQ * D * 2, 2 * D * HQ * n * (n + 1))
            for rows in geo.FLASH_ROW_CHOICES:
                cases.append(("flash_attention",
                              f"[1,{HQ},{s},{D}] causal starts="
                              f"{[st] if st is not None else None} "
                              f"block_q={rows}", (q, k, v),
                              dict(kw, block_q=rows), b, keep))
    s = 512
    q, k, v = rn(4, HQ, s, D), rn(4, HQ, s, D), rn(4, HQ, s, D)
    sts = [s - p for p in GENERATE_PROMPTS]
    kp = torch.arange(s, device=dev)
    keep = (kp[None, None, :] <= kp[None, :, None]) & (
        kp[None, None, :] >= torch.tensor(sts, device=dev)[:, None, None])
    n_ops = sum(2 * D * HQ * p * (p + 1) for p in GENERATE_PROMPTS)
    b = bound_ms((3 * sum(GENERATE_PROMPTS) + 4 * s) * HQ * D * 2, n_ops)
    cases.append(("flash_attention", f"[4,{HQ},{s},{D}] causal starts={sts}",
                  (q, k, v), {"starts": torch.tensor(sts, device=dev)}, b,
                  keep[:, None]))
    for pos in PAGED_POS:
        rows = len(pos)
        nb = 1 + rows * POOL_MB
        qd = rn(rows, HQ, 1, D)
        kpool, vpool = rn(nb, HQ, POOL_BS, D), rn(nb, HQ, POOL_BS, D)
        perm = torch.randperm(nb - 1, generator=torch.Generator()
                              .manual_seed(7)) + 1
        tables = perm.reshape(rows, POOL_MB).to(torch.int32).to(dev)
        ctx = sum(p + 1 for p in pos)
        b = bound_ms(2 * rows * HQ * D * 2 + ctx * HQ * D * 2 * 2
                     + rows * POOL_MB * 4, 4 * D * HQ * ctx)
        cases.append(("paged_decode_attention",
                      f"q [{rows},{HQ},1,{D}] pools [{nb},{HQ},{POOL_BS},"
                      f"{D}] pos={pos}",
                      (qd, kpool, vpool, tables,
                       torch.tensor(pos, dtype=torch.int32, device=dev)),
                      {}, b, None))
    s = CONTIG_S
    qd, kc, vc = rn(4, HQ, 1, D), rn(4, HQ, s, D), rn(4, HQ, s, D)
    sts = [512 - p for p in GENERATE_PROMPTS]
    st = torch.tensor(sts, device=dev)
    for pos in CONTIG_POS:
        ctx = sum(pos - a + 1 for a in sts)
        b = bound_ms(2 * 4 * HQ * D * 2 + ctx * HQ * D * 2 * 2,
                     4 * D * HQ * ctx)
        kp = torch.arange(s, device=dev)[None, :]
        keep = ((kp <= pos) & (kp >= st[:, None]))[:, None, None, :]
        cases.append(("decode_attention",
                      f"q [4,{HQ},1,{D}] k/v [4,{HQ},{s},{D}] pos {pos} "
                      f"starts={sts}", (qd, kc, vc, pos), {"starts": st},
                      b, keep))
    return cases


REFS = {"flash_attention": flash_attention_ref,
        "decode_attention": decode_attention_ref,
        "paged_decode_attention": paged_decode_attention_ref}


def body_times(timer, parent, sink):
    """The ``time`` lines (module docstring); returns this tree's worst
    error share."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    mine = {"flash_attention": flash_attention,
            "decode_attention": decode_attention,
            "paged_decode_attention": paged_decode_attention}
    worst = 0.0
    for kernel, label, args, kw, (b_ms, b_by), keep in phi3_cases(dev):
        want = REFS[kernel](*args, **{k: v for k, v in kw.items()
                                      if k != "block_q"})
        got = mine[kernel](*args, **kw)
        line = {"time": kernel, "shape": label,
                "body": rule_body(kernel, args[0], args[1]),
                "share_of_tol": share_of_tol(got, want),
                "bound_ms": b_ms, "bound_by": b_by}
        if kernel == "flash_attention":
            exact = exact_attention(*args[:3], keep)
            line["err64"] = {
                "tree": err64(got, exact), "plain": err64(want, exact),
                "sdpa": err64(F.scaled_dot_product_attention(
                    *args[:3], attn_mask=keep), exact)}
        if kernel == "decode_attention":
            line["plan"] = repr(decode_plan(4, HQ, HQ, D, CONTIG_S, 0, 2))
        elif kernel == "paged_decode_attention":
            line["plan"] = repr(decode_plan(args[0].shape[0], HQ, HQ, D,
                                            POOL_MB * POOL_BS, POOL_BS, 2))
        new = lambda: mine[kernel](*args, **kw)  # noqa: E731
        runs = [("ms", new), ("ms", new)]
        if parent is not None:
            old = lambda: parent.wrappers[kernel](*args, **kw)  # noqa: E731
            got = old()
            line["parent_share_of_tol"] = share_of_tol(got, want)
            if kernel == "flash_attention":
                line["err64"]["parent"] = err64(got, exact)
            runs = [("parent_ms", old)] + runs + [("parent_ms", old)]
        for key, fn in runs:
            line.setdefault(key, []).append(timer(fn))
        if keep is not None:
            qs, ks, vs = args[:3]
            line["sdpa_ms"] = timer(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=keep))
        worst = max(worst, line["share_of_tol"])
        emit({k2: (round(v, 4) if isinstance(v, float) else
                   [round(x, 4) for x in v] if isinstance(v, list) else v)
              for k2, v in line.items()}, sink)
    return worst


def split_times(timer, sink):
    """The ``split`` lines (module docstring)."""
    dev = torch.device("cuda")
    for kernel, label, args, kw, _, _ in phi3_cases(dev):
        if kernel == "flash_attention":
            continue
        b = args[0].shape[0]
        for sk in SPLIT_SWEEP:
            if kernel == "paged_decode_attention":
                plan = decode_plan(b, HQ, HQ, D, POOL_MB * POOL_BS, POOL_BS,
                                   2, sk)
                fn = (lambda: paged_decode_attention(  # noqa: E731
                    *args, block_kv=sk))
            else:
                plan = decode_plan(b, HQ, HQ, D, CONTIG_S, 0, 2, sk)
                fn = (lambda: decode_attention(  # noqa: E731
                    *args, block_kv=sk, **kw))
            if plan.error is not None:
                continue
            emit({"split": kernel, "shape": label, "block_kv": sk,
                  "body": plan.body, "splits": plan.splits,
                  "cluster": plan.cluster, "blocks": plan.blocks,
                  "smem": plan.smem, "ms": round(timer(fn), 4)}, sink)


def stamp_lines(sink):
    """The ``timeline`` lines (module docstring)."""
    dev = torch.device("cuda")
    lib = build()
    _build._lib = lib                 # the wrappers launch the copy
    gen = torch.Generator(device=dev).manual_seed(1)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    def names(plan):
        return PACKED_STAMPS if plan.body == "packed" else STAMPS

    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    s = CONTIG_S
    q, k, v = rn(4, HQ, 1, D), rn(4, HQ, s, D), rn(4, HQ, s, D)
    st = torch.tensor([512 - p for p in GENERATE_PROMPTS], device=dev)
    plan = decode_plan(4, HQ, HQ, D, s, 0, 2)
    res = {f"decode_attention ({plan.body}) q [4,32,1,96] k/v [4,32,544,96] "
           f"pos 512": timeline(
               lib.read_stamps, plan,
               lambda: decode_attention(q, k, v, 512, starts=st), flush,
               names(plan))}
    bs, mb = POOL_BS, POOL_MB
    nb = 1 + 4 * mb
    kp, vp = rn(nb, HQ, bs, D), rn(nb, HQ, bs, D)
    perm = torch.randperm(nb - 1, generator=torch.Generator()
                          .manual_seed(7)) + 1
    tables = perm.reshape(4, mb).to(torch.int32).to(dev)
    pos = torch.tensor([17, 100, 300, 511], dtype=torch.int32, device=dev)
    plan = decode_plan(4, HQ, HQ, D, mb * bs, bs, 2)
    res[f"paged_decode_attention ({plan.body}) q [4,32,1,96] pools "
        f"[137,32,16,96] pos [17,100,300,511]"] = timeline(
        lib.read_stamps_paged, plan,
        lambda: paged_decode_attention(q, kp, vp, tables, pos), flush,
        names(plan))
    # recurrentgemma's 16 heads of 256 on one KV head over its wrapped
    # 2048-slot rolling buffer
    s = 2048
    qr, kr, vr = rn(4, 16, 1, 256), rn(4, 1, s, 256), rn(4, 1, s, 256)
    pr = torch.tensor([2048, 2500, 3000, 4127], device=dev)
    plan = decode_plan(4, 16, 1, 256, s, 0, 2)
    res[f"decode_attention ({plan.body}) q [4,16,1,256] rolling k/v "
        f"[4,1,2048,256] pos [2048,2500,3000,4127]"] = timeline(
        lib.read_stamps, plan, lambda: decode_attention(qr, kr, vr, pr),
        flush, names(plan))
    for shape, r in res.items():
        emit({"timeline": shape, **r}, sink)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout of another commit whose "
                    "attention kernels to time beside this tree's")
    ap.add_argument("--splits", action="store_true",
                    help="also time the decode calls at every split of "
                    "SPLIT_SWEEP")
    ap.add_argument("--times-only", action="store_true",
                    help="only the time lines, no instrumented build")
    ap.add_argument("--out", help="also write the lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("decode_timeline: needs a CUDA card")
    if args.out:
        open(args.out, "w").close()
    parent = load_parent(args.parent) if args.parent else None
    build_all([_build.load] + ([parent.build.load] if parent else []))
    timer = Timer(torch.device("cuda"))
    worst = body_times(timer, parent, args.out)
    if args.splits:
        split_times(timer, args.out)
    if not args.times_only:
        stamp_lines(args.out)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    emit({"device": smi.stdout.strip()}, args.out)
    if worst > 1.0:
        raise SystemExit(f"decode_timeline: a call is {worst:.3g}x its "
                         f"tolerance from its plain version")


if __name__ == "__main__":
    main()
