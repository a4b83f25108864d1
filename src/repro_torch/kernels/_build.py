"""Build and load the port's CUDA kernels (route (b): nvcc + ctypes).

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a`` with a plain C interface (no PyTorch headers:
seconds per file instead of minutes), then linked into one shared
library under ``build/kernels/`` at the repository root.  The link line
names no CUDA driver library (libcuda): the TMA tensor maps of the bf16
matmul get the driver API's ``cuTensorMapEncodeTiled`` through the CUDA
runtime's entry-point query.  The library's
name carries a hash of the sources, so an edited kernel is rebuilt and
an unchanged one is reused.  The build happens at first use, never at
import, and any compiler error raises with the compiler's output.

The library is loaded with ``ctypes``; every entry point gets its
``argtypes`` here (``c_void_p`` for pointers and the stream, ``c_int``
for sizes and flags) and returns ``cudaGetLastError()`` as an int, which
:func:`check` turns into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-lineinfo", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argtypes (all return int = cudaError_t).
SIGNATURES = {
    # q, k, v, o, starts, B, HQ, HKV, S, D, causal, window, scale,
    # is_bf16 (the tensor-core body), rows and keys of a block's tile,
    # stream
    "flash_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _I, _F, _I, _I, _I, _P],
    # q, k, v, o, pos (int32), starts (int64, or null), workspace,
    # tickets, B, HQ, HKV, S, D, split_keys, tile_keys, head_chunk, smem
    # (the decode plan), scale, is_bf16, stream
    "decode_attention_fwd": [_P] * 8 + [_I] * 9 + [_F, _I, _P],
    # q, k_pool, v_pool, o, tables, pos, workspace, tickets, B, HQ, HKV,
    # bs, MB, D, split_keys, tile_keys, head_chunk, smem, scale, is_bf16,
    # stream
    "paged_decode_attention_fwd": [_P] * 8 + [_I] * 10 + [_F, _I, _P],
    # x, dt, b, c, a, d, h0, y, hout, Bt, S, Di, N, block_d, is_bf16,
    # stream
    "ssm_scan_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                     _I, _I, _P],
    # img, wgt, out, N, IC, H2, W2, OC, KH, KW, boc, bic, by, bx, groups,
    # per_thread, ord0, ord1, ord2, ic_begin, ic_count, accumulate, stream
    # (float32)
    "conv2d_fwd": [_P, _P, _P] + [_I] * 19 + [_P],
    # img, wgt, out, N, IC, H2, W2, OC, KH, KW, boc, bic, by, bx, warps,
    # ord0, ord1, ord2, ic_begin, ic_count, accumulate, stream (bf16)
    "conv2d_mma_fwd": [_P, _P, _P] + [_I] * 18 + [_P],
    # img, wgt, idx, counts, out, N, IC, H2, W2, OC, KH, KW, boc, bic,
    # max_nnz, by, bx, groups, per_thread, warps, is_bf16, stream
    "sparse_conv2d_fwd": [_P, _P, _P, _P, _P] + [_I] * 16 + [_P],
    # a, b, c, M, N, K, bm, bn, bk, mi, mj, m_outer, k_begin, k_count,
    # accumulate, resident, stream (float32)
    "matmul_fwd": [_P, _P, _P] + [_I] * 13 + [_P],
    # a, b, c, M, N, K, bm, bn, bk, bn_pad, stages, m_outer, k_begin,
    # k_count, accumulate, resident, a_tma, b_tma, stream (bf16)
    "matmul_mma_fwd": [_P, _P, _P] + [_I] * 15 + [_P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
lib_path: Optional[Path] = None   # the shared library in use
build_seconds: Optional[float] = None
build_log: str = ""     # nvcc/ptxas output of the library in use


def sources() -> List[Path]:
    """The CUDA sources that make up the library, in a stable order."""
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    """Hash of every source and header plus the compiler flags."""
    h = hashlib.sha256(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _compile(out: Path) -> str:
    """Compile each source in parallel and link them into ``out``;
    returns the compilers' combined output."""
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        objs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-I", str(CSRC), "-c",
                   str(src), "-o", str(obj)]
            procs.append((src, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = []
        failed = []
        for src, p in procs:
            text, _ = p.communicate()
            log.append(f"== {src.name}\n{text}")
            if p.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed)
                               + "\n" + "\n".join(log))
        tmp_so = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_so),
             *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed\n" + link.stdout)
        tmp_log = Path(tmp) / _log_path(out).name
        tmp_log.write_text("\n".join(log))
        # the log first: whoever finds the .so finds its log beside it
        os.replace(tmp_log, _log_path(out))
        os.replace(tmp_so, out)   # atomic: readers never see a partial .so
    return "\n".join(log)


def _log_path(lib: Path) -> Path:
    """The compilers' output (ptxas register and spill counts) kept
    beside the library it built."""
    return lib.with_suffix(".log")


def load() -> ctypes.CDLL:
    """The kernel library, built on first use (keyed by the sources'
    hash) and loaded once per process."""
    global _lib, build_seconds, build_log, lib_path
    with _lock:
        if _lib is not None:
            return _lib
        out = BUILD_DIR / f"libreprotorch_{_digest()}.so"
        t0 = time.perf_counter()
        if out.exists():
            log_file = _log_path(out)
            build_log = log_file.read_text() if log_file.exists() else ""
        else:
            build_log = _compile(out)
        build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(out))
        lib_path = out
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.kernels_error_string.argtypes = [ctypes.c_int]
        lib.kernels_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        msg = load().kernels_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_handle(device) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``device``."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream


__all__ = ["load", "check", "sources", "stream_handle", "BUILD_DIR"]
