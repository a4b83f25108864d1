"""Variants of the selective-scan kernel side by side on one card: the
library's own build of ``csrc/ssm_scan.cu`` beside scratch builds of the
same source with other states a lane (``kP``) and with
exp taken as ``expf`` or as ``ex2.approx`` of ``dt * (a log2 e)`` with
``a log2 e`` kept as hi + lo parts (the library rounds it once), each
timed at ``chip_smoke.py``'s scan shapes and held to the plain version.

    PYTHONPATH=src python -m repro_torch.launch.scan_variants \\
        [--source NAME=FILE ...]

Needs a CUDA card and ``nvcc``.  ``--source`` adds a variant built from
another copy of the source with the same C entry (an earlier commit's,
say).  Scratch sources and libraries go to ``build/scan_variants/`` (the
kernel library itself is not changed).  Inputs are seeded on the card as
``chip_smoke.py`` makes them (dt softplus'd, a = -(1..N), a zero pad
before each row's real steps).  Times are CUDA-event medians of 25
calls, the 50 MB L2 flushed before each.  Prints one JSON line per
variant (ptxas' registers and spill stores of the bf16 N 16 instance,
ms per shape and block_d, the float32 worst errors and the bf16 worst
share of ``chip_smoke.py``'s tolerance at the default block_d), then
the card's name and power limit.
"""
import argparse
import ctypes
import json
import re
import subprocess
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, ssm_scan
from repro_torch.kernels._geometry import MAX_THREADS
from repro_torch.kernels.ssm_scan import DEFAULT_BLOCK_D, ssm_scan_ref

OUT = _build.BUILD_DIR.parent / "scan_variants"
P_LINE = "constexpr int kP = 4;"
EXP_LINE = "da[j][p] = ex2_approx(dtt * (av[p] * kLog2e));"
# exp(dt a) as the library has it (ex2.approx with a log2 e rounded
# once), as expf, or as ex2.approx with a log2 e kept as hi + lo parts
# (an argument as accurate as expf's own reduction makes it)
EXP = {
    "expf": "expf(dtt * av[p])",
    "hi_lo": "ex2_approx(fmaf(dtt, av[p] * kLog2e, dtt * (fmaf(av[p], "
             "kLog2e, -(av[p] * kLog2e)) + av[p] * 1.92596303e-08f)))",
}
# (name, states a lane, exp); "p4" is the library's own build
VARIANTS = (("p2", 2, None), ("p8", 8, None), ("p4_expf", 4, "expf"),
            ("p4_ex2_hi_lo", 4, "hi_lo"))
BLOCK_DS = (32, 64, 128, 256)
GENERATE_PROMPTS = [40, 100, 250, 300]
DI, N = 8192, 16


def share_of_tol(got, want):
    """Worst |got - want| as a share of the element's tolerance: bf16
    two ulps of |want| + 1e-5, float32 1e-5."""
    diff = (got.float() - want.float()).abs()
    if want.dtype == torch.bfloat16:
        mag = want.float().abs().clamp_min(2.0 ** -126)
        allowed = 2 * torch.exp2(torch.floor(torch.log2(mag)) - 7) + 1e-5
    else:
        allowed = torch.full_like(diff, 1e-5)
    return (diff / allowed).max().item()


def ptxas(log):
    """Registers and spill stores of the bf16 N 16 instance."""
    m = re.search(r"Compiling entry function '[^']*ssm_scan_kernelI13__nv_"
                  r"bfloat16Li16E[^']*'.*?Used (\d+) registers", log,
                  re.DOTALL)
    if not m:
        return {"registers": "not found"}
    spill = re.search(r"(\d+) bytes spill stores",
                      log[m.start():m.end() + 200])
    return {"registers": int(m.group(1)),
            "spill_store_bytes": int(spill.group(1)) if spill else 0}


def scan_inputs(gen, dtype, bt, s, real=(), h0=False):
    """The scan's inputs at Di 8192, N 16 on ``gen``'s device, as
    ``chip_smoke.py`` makes them: ``real`` (one per row) leaves that many
    real steps after a zero pad; h0 in the model dtype, as the engine's
    cache holds it."""
    dev = gen.device

    def rn(shape, dt=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dt)
    x = rn((bt, s, DI), dtype)
    dt = F.softplus(rn((bt, s, DI)) * 0.5 - 1.0)
    b, c = rn((bt, s, N)), rn((bt, s, N))
    for i, r in enumerate(real):
        x[i, :s - r] = 0
        b[i, :s - r] = 0
    a = -torch.arange(1, N + 1, dtype=torch.float32, device=dev).repeat(
        DI, 1)
    return (x, dt, b, c, a, rn((DI,), dtype),
            rn((bt, DI, N), dtype).float() if h0 else None)


def event_ms(fn, flush, iters=25):
    """Median ms of ``fn()`` timed as ``chip_smoke.py`` times a kernel:
    CUDA events, the L2 flushed (``flush`` zeroed) and the stream kept
    busy before each call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    ms = sorted(s.elapsed_time(e) for s, e in pairs)
    return ms[len(ms) // 2]


def build(variants):
    """Compile every variant's source in parallel: name -> (entry or the
    compiler's error, ptxas stats, seconds)."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name, src in variants.items():
        cu, so = OUT / f"{name}.cu", OUT / f"lib{name}.so"
        cu.write_text(src)
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v",
             "-I", str(_build.CSRC), str(cu), "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        secs = round(time.perf_counter() - t0, 1)
        if p.returncode != 0:
            out[name] = (log[-3000:], {}, secs)
            continue
        fn = ctypes.CDLL(str(so)).ssm_scan_fwd
        fn.argtypes = _build.SIGNATURES["ssm_scan_fwd"]
        fn.restype = ctypes.c_int
        out[name] = (fn, ptxas(log), secs)
    return out


def variant_sources(extra):
    """name -> source text of every scratch variant."""
    src = (_build.CSRC / "ssm_scan.cu").read_text()
    for line in (P_LINE, EXP_LINE):
        if src.count(line) != 1:
            raise SystemExit(f"scan_variants: {line!r} not found once in "
                             f"ssm_scan.cu")
    out = {}
    for name, p, exp in VARIANTS:
        text = src.replace(P_LINE, f"constexpr int kP = {p};")
        if exp is not None:
            text = text.replace(EXP_LINE, f"da[j][p] = {EXP[exp]};")
        out[name] = text
    for spec in extra:
        name, _, path = spec.partition("=")
        out[name] = Path(path).read_text()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[],
                    help="NAME=FILE: another ssm_scan.cu to build and time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("scan_variants needs a CUDA card")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.load()
    own = (None, ptxas(_build.build_log), round(time.perf_counter() - t0, 1))
    built = {"p4": own, **build(variant_sources(args.source))}
    states = {"p4": 4, **{n: p for n, p, _ in VARIANTS}}
    gen = torch.Generator(device=dev).manual_seed(1234)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)

    def inputs(*args, **kw):
        return scan_inputs(gen, *args, **kw)

    def runner(name, block_d):
        """The variant as a function of the scan's inputs."""
        fn = built[name][0]
        if fn is None:
            return lambda *a: ssm_scan(*a, block_d=block_d)

        def run(x, dt, b, c, a, d, h0):
            bt, s, di = x.shape
            y = torch.empty_like(x)
            h = torch.empty((bt, di, N), dtype=torch.float32, device=dev)
            rc = fn(x.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(),
                    a.data_ptr(), d.data_ptr(),
                    None if h0 is None else h0.data_ptr(), y.data_ptr(),
                    h.data_ptr(), bt, s, di, N, block_d,
                    int(x.dtype == torch.bfloat16),
                    _build.stream_handle(dev))
            if rc != 0:
                raise RuntimeError(f"{name}: CUDA error {rc}")
            return y, h
        return run

    bf16 = torch.bfloat16
    shapes = {"prefill [1,512,8192] real 300": inputs(bf16, 1, 512, [300]),
              "prefill [4,512,8192] real " + str(GENERATE_PROMPTS):
                  inputs(bf16, 4, 512, GENERATE_PROMPTS),
              "decode [4,1,8192] h0": inputs(bf16, 4, 1, h0=True)}
    checks = {"float32 [1,512,8192] real 300": inputs(torch.float32, 1, 512,
                                                      [300]),
              "float32 [4,1,8192] h0": inputs(torch.float32, 4, 1, h0=True),
              **shapes}
    refs = {k: ssm_scan_ref(*v) for k, v in checks.items()}
    for name, (fn, stats, secs) in built.items():
        line = {"variant": name, "states_per_lane": states.get(name),
                "build_s": secs, "ptxas": stats, "card": smi}
        if isinstance(fn, str):
            print(json.dumps({**line, "build_error": fn}), flush=True)
            continue
        try:
            errs = {}
            for k, v in checks.items():
                y, h = runner(name, DEFAULT_BLOCK_D)(*v)
                torch.cuda.synchronize()
                y_ref, h_ref = refs[k]
                errs[k] = {"y_max_abs_err": (y.float() - y_ref.float())
                           .abs().max().item(),
                           "y_share_of_tol": share_of_tol(y, y_ref),
                           "state_max_abs_err": (h - h_ref).abs().max()
                           .item()}
            ms = {}
            p = states.get(name)
            for k, v in shapes.items():
                ms[k] = {}
                for bd in BLOCK_DS:
                    if p is not None and bd * N // p > MAX_THREADS:
                        continue
                    try:
                        ms[k][bd] = round(event_ms(
                            lambda: runner(name, bd)(*v), flush), 4)
                    except RuntimeError as e:   # a block it cannot take
                        ms[k][bd] = str(e)
            line.update(checks=errs, ms=ms)
        except RuntimeError as e:
            line["run_error"] = str(e)
        print(json.dumps(line), flush=True)
    print(smi)


if __name__ == "__main__":
    main()
