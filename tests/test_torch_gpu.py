"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA card with ``nvcc`` (they build the kernels);
they carry the ``gpu`` marker and skip elsewhere.  The file imports no
JAX, so it also runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py -q

Tolerances, per element: float32 atol 1e-5 (same arithmetic, other
summation order); bf16 two bf16 ulps of the plain value plus 1e-5 (both
sides accumulate in float32 and round once to bf16).  For a
read-modify-write schedule of the thesis kernels the bf16 ulps are those
of the largest magnitude the element takes at any rounding point (a
float32 sum in another order may round the other way at an intermediate
point, and that step stays in the result).
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (decode_attention, flash_attention,  # noqa: E402
                                 paged_decode_attention, ssm_scan)
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_ref, paged_decode_attention_ref)
from repro_torch.kernels.flash_attention import flash_attention_ref  # noqa: E402
from repro_torch.kernels._geometry import decode_plan  # noqa: E402
from repro_torch.kernels.ssm_scan import ssm_scan_ref  # noqa: E402
from repro_torch.kernels import conv2d, matmul, sparse_conv2d  # noqa: E402
from repro_torch.kernels.conv2d import conv2d_plain  # noqa: E402
from repro_torch.kernels.matmul import matmul_plain  # noqa: E402
from repro_torch.kernels.sparse_conv import (analyze_weights,  # noqa: E402
                                             sparse_conv_plain)
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import (build_model, left_pad_prompts,  # noqa: E402
                                prompt_starts)
from repro_torch.runtime import generate  # noqa: E402
from repro_torch.serving import ServeSession  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def cuda_device():
    """The card, with TF32 off for the float32 comparisons; skips
    without one (decided here, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _share_of_tol(got, want, peak=None):
    """Worst |got - want| as a share of each element's tolerance."""
    diff = (got.float() - want.float()).abs()
    if want.dtype == torch.bfloat16:
        mag = (want.float().abs() if peak is None else peak
               ).clamp_min(2.0 ** -126)
        allowed = 2 * torch.exp2(torch.floor(torch.log2(mag)) - 7) + 1e-5
    else:
        allowed = torch.full_like(diff, 1e-5)
    return (diff / allowed).max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 96])
def test_cuda_kernels_match_plain_versions(cuda_device, dtype, d):
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda_device).manual_seed(d)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(dt)

    b, hq, hkv, s = 2, 4, 2, 200
    q, k, v = rn(b, hq, s, d), rn(b, hkv, s, d), rn(b, hkv, s, d)
    starts = torch.tensor([0, 37], device=cuda_device)
    for kw in ({"starts": starts}, {"window": 50}, {}):
        assert _share_of_tol(flash_attention(q, k, v, **kw),
                             flash_attention_ref(q, k, v, **kw)) <= 1.0
    qd = rn(b, hq, 1, d)
    pos = torch.tensor([150, 199], device=cuda_device)
    assert _share_of_tol(decode_attention(qd, k, v, pos, starts=starts),
                         decode_attention_ref(qd, k, v, pos,
                                              starts=starts)) <= 1.0
    nb, bs, mb = 12, 16, 4
    kp, vp = rn(nb, hkv, bs, d), rn(nb, hkv, bs, d)
    perm = np.random.default_rng(d).permutation(np.arange(1, nb))
    tables = np.zeros((b, mb), np.int32)
    tables[0, :3] = perm[:3]
    tables[1, :4] = perm[3:7]
    tables = torch.from_numpy(tables).to(cuda_device)
    pos = torch.tensor([40, 63], device=cuda_device)
    assert _share_of_tol(paged_decode_attention(qd, kp, vp, tables, pos),
                         paged_decode_attention_ref(qd, kp, vp, tables,
                                                    pos)) <= 1.0


@pytest.mark.gpu
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    q = torch.zeros(1, 2, 8, 16, device=cuda_device)
    with pytest.raises(ValueError):
        flash_attention(q, q.transpose(2, 3), q)          # wrong shape
    with pytest.raises(ValueError):
        flash_attention(q.half(), q.half(), q.half())     # dtype
    with pytest.raises(ValueError):
        flash_attention(q, q.cpu(), q)                     # device


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,di,block_d", [(16, 8192, 64), (8, 128, 32),
                                          (8, 100, 64), (16, 8192, 32),
                                          (16, 8192, 128), (16, 8192, 256),
                                          (16, 100, 32)])
def test_cuda_ssm_scan_matches_plain_version(cuda_device, dtype, n, di,
                                             block_d):
    """Prefill without h0 (37 steps: a ragged last tile; 101 steps over
    several tiles with a masked pad prefix on one row and a row masked
    throughout, whose final state and y must be exactly 0) and the S=1
    decode step from a state at 1, 2 and 4 rows, at the block_d values
    chip_smoke.py sweeps; y to the dtype's tolerance, the float32 state
    to 1e-5."""
    dt_ = getattr(torch, dtype)
    g = torch.Generator(device=cuda_device).manual_seed(n + di)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=cuda_device)

    a = -torch.arange(1, n + 1, device=cuda_device,
                      dtype=torch.float32).repeat(di, 1)
    d = rn(di).to(dt_)
    cases = ((2, 37, False, ()), (3, 101, False, (40, 101, 0)),
             (1, 1, True, ()), (2, 1, True, ()), (4, 1, True, ()))
    for bt, s, with_h0, pads in cases:
        x = rn(bt, s, di).to(dt_)
        dt = torch.nn.functional.softplus(rn(bt, s, di) * 0.5 - 1.0)
        b, c = rn(bt, s, n), rn(bt, s, n)
        for row, pad in enumerate(pads):
            x[row, :pad] = 0
            b[row, :pad] = 0
        h0 = rn(bt, di, n) if with_h0 else None
        y, h = ssm_scan(x, dt, b, c, a, d, h0, block_d=block_d)
        y_ref, h_ref = ssm_scan_ref(x, dt, b, c, a, d, h0)
        torch.cuda.synchronize()
        assert _share_of_tol(y, y_ref) <= 1.0
        assert (h - h_ref).abs().max().item() <= 1e-5
        for row, pad in enumerate(pads):
            assert torch.equal(y[row, :pad], torch.zeros_like(y[row, :pad]))
            if pad == s:
                assert torch.equal(h[row], torch.zeros_like(h[row]))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_thesis_kernels_match_plain_versions(cuda_device, dtype):
    """conv2d (scratch and read-modify-write orders, a 1x1 and a 3x3
    layer), matmul (six orders x resident RHS) and the block-sparse conv
    (densities 0 to 1) against their plain versions, with exact launch
    counts."""
    dt_ = getattr(torch, dtype)
    g = torch.Generator(device=cuda_device).manual_seed(7)

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=cuda_device)
                * scale).to(dt_)

    for (n, ic, h, oc, k), block in (
            ((2, 32, 13, 64, 3), {"oc": 16, "ic": 16, "y": 13, "x": 13}),
            ((3, 64, 27, 48, 1), {"oc": 16, "ic": 16, "y": 3, "x": 9})):
        img = rn(n, ic, h + k - 1, h + k - 1)
        wgt = rn(oc, ic, k, k, scale=(ic * k * k) ** -0.5)
        for order in (("oc", "y", "x", "ic"), ("ic", "oc", "y", "x"),
                      ("y", "ic", "x", "oc")):
            before = conv2d.launches
            got = conv2d(img, wgt, block=block, grid_order=order)
            want, peak = conv2d_plain(img, wgt, block=block,
                                      grid_order=order, with_peak=True)
            torch.cuda.synchronize()
            assert conv2d.launches - before == (
                1 if order[-1] == "ic" else ic // block["ic"])
            assert _share_of_tol(got, want, peak) <= 1.0
    a, b = rn(96, 256), rn(256, 80, scale=1 / 16)
    block = {"m": 32, "n": 16, "k": 32}
    for order in __import__("itertools").permutations(("m", "n", "k")):
        for resident in (False, True):
            got = matmul(a, b, block=block, grid_order=order,
                         resident_rhs=resident)
            want, peak = matmul_plain(a, b, block=block, grid_order=order,
                                      resident_rhs=resident, with_peak=True)
            torch.cuda.synchronize()
            assert _share_of_tol(got, want, peak) <= 1.0
    img = rn(2, 32, 27, 27)
    for density in (0.0, 0.25, 0.5, 1.0):
        w = rn(64, 32, 3, 3, scale=1 / 17)
        keep = torch.rand(4, 2, generator=torch.Generator().manual_seed(
            int(density * 8))) < density
        mask = keep.repeat_interleave(16, 0).repeat_interleave(16, 1)
        w = w * mask.to(device=cuda_device, dtype=dt_)[:, :, None, None]
        block = {"oc": 16, "ic": 16}
        sp = analyze_weights(w, block)
        got = sparse_conv2d(img, w, block=block, sparsity=sp)
        want = sparse_conv_plain(img, w, sp.idx, sp.counts, block)
        torch.cuda.synchronize()
        assert _share_of_tol(got, want) <= 1.0


# bf16 edges of the tensor-core bodies: tiles the MMA shape pads (bn 13,
# 169 pixels, boc 40, bic 8, 1 x 13 and 11 x 11 pixel tiles, rounds of
# warp tiles), both staging routes of the matmul (TMA where rows are
# 16-byte multiples, registers otherwise), scratch, read-modify-write and
# resident-RHS variants.
MMA_MATMUL_CASES = [
    # (m, n, k), block, grid order, resident, expected (A, B) route
    ((512, 9216, 3072), {"m": 128, "n": 128, "k": 64}, "mnk", False,
     ("tma", "tma")),
    ((512, 9216, 3072), {"m": 128, "n": 256, "k": 64}, "nmk", False,
     ("tma", "tma")),
    ((512, 9216, 3072), {"m": 128, "n": 32, "k": 3072}, "mnk", True,
     ("tma", "tma")),
    ((512, 9216, 3072), {"m": 64, "n": 96, "k": 512}, "kmn", False,
     ("tma", "tma")),
    ((1000, 169, 512), {"m": 125, "n": 13, "k": 16}, "mnk", False,
     ("tma", "regs")),
    ((1000, 169, 512), {"m": 125, "n": 169, "k": 128}, "kmn", False,
     ("tma", "regs")),
    ((1000, 169, 512), {"m": 100, "n": 13, "k": 32}, "mnk", True,
     ("tma", "regs")),
    ((48, 729, 384), {"m": 48, "n": 243, "k": 48}, "mkn", False,
     ("tma", "regs")),
    ((64, 40, 36), {"m": 64, "n": 40, "k": 12}, "nkm", False,
     ("regs", "tma")),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", MMA_MATMUL_CASES,
                         ids=[f"{c[0]}-{c[1]['m']}x{c[1]['n']}x{c[1]['k']}"
                              f"-{c[2]}-res{int(c[3])}"
                              for c in MMA_MATMUL_CASES])
def test_cuda_bf16_matmul_mma_edges(cuda_device, case):
    from repro_torch.kernels.matmul import staging_route, uses_scratch
    (m, n, k), block, order, resident, route = case
    g = torch.Generator(device=cuda_device).manual_seed(m + n + k)
    a = torch.randn(m, k, generator=g, device=cuda_device).to(torch.bfloat16)
    b = (torch.randn(k, n, generator=g, device=cuda_device)
         * k ** -0.5).to(torch.bfloat16)
    assert staging_route(a, b) == route
    before = matmul.launches
    got = matmul(a, b, block=block, grid_order=tuple(order),
                 resident_rhs=resident)
    torch.cuda.synchronize()
    want, peak = matmul_plain(a, b, block=block, grid_order=tuple(order),
                              resident_rhs=resident, with_peak=True)
    assert matmul.launches - before == (
        1 if uses_scratch(tuple(order), resident) else k // block["k"])
    assert _share_of_tol(got, want, peak) <= 1.0


MMA_CONV_CASES = [
    # (n, ic, h, oc, k), block, grid order
    ((2, 512, 13, 1000, 1), {"oc": 40, "ic": 64, "y": 13, "x": 13},
     ("oc", "y", "x", "ic")),
    ((2, 512, 13, 1000, 1), {"oc": 40, "ic": 64, "y": 13, "x": 13},
     ("ic", "oc", "y", "x")),
    ((2, 16, 55, 64, 3), {"oc": 64, "ic": 8, "y": 5, "x": 11},
     ("ic", "y", "x", "oc")),
    ((2, 512, 13, 1000, 1), {"oc": 125, "ic": 16, "y": 1, "x": 13},
     ("oc", "y", "x", "ic")),
    ((2, 32, 55, 128, 1), {"oc": 128, "ic": 32, "y": 11, "x": 11},
     ("y", "x", "oc", "ic")),
    ((2, 64, 13, 256, 3), {"oc": 128, "ic": 16, "y": 13, "x": 13},
     ("oc", "x", "y", "ic")),
    ((3, 32, 28, 256, 3), {"oc": 16, "ic": 32, "y": 7, "x": 14},
     ("x", "ic", "oc", "y")),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", MMA_CONV_CASES,
                         ids=[f"oc{c[0][3]}-{c[1]['oc']}.{c[1]['ic']}."
                              f"{c[1]['y']}x{c[1]['x']}-"
                              + "".join(a[0] for a in c[2])
                              for c in MMA_CONV_CASES])
def test_cuda_bf16_conv2d_mma_edges(cuda_device, case):
    from repro_torch.kernels.conv2d import uses_scratch
    (n, ic, h, oc, k), block, order = case
    g = torch.Generator(device=cuda_device).manual_seed(ic + oc + k)
    img = torch.randn(n, ic, h + k - 1, h + k - 1, generator=g,
                      device=cuda_device).to(torch.bfloat16)
    wgt = (torch.randn(oc, ic, k, k, generator=g, device=cuda_device)
           * (ic * k * k) ** -0.5).to(torch.bfloat16)
    before = conv2d.launches
    got = conv2d(img, wgt, block=block, grid_order=order)
    torch.cuda.synchronize()
    want, peak = conv2d_plain(img, wgt, block=block, grid_order=order,
                              with_peak=True)
    assert conv2d.launches - before == (
        1 if uses_scratch(order) else ic // block["ic"])
    assert _share_of_tol(got, want, peak) <= 1.0


@pytest.mark.gpu
def test_cuda_bf16_mma_layouts_refuse_what_they_cannot_take(cuda_device):
    """A block the tensor-core layout refuses raises before any launch:
    matmul rows above two warpgroups, a resident panel with its ring
    beyond 227 KB, a conv tile whose two stages exceed 227 KB."""
    a = torch.zeros(512, 3072, dtype=torch.bfloat16, device=cuda_device)
    b = torch.zeros(3072, 256, dtype=torch.bfloat16, device=cuda_device)
    before = matmul.launches
    with pytest.raises(ValueError, match="rows above 128"):
        matmul(a, b, block={"m": 256, "n": 64, "k": 64})
    with pytest.raises(ValueError, match="shared memory"):
        matmul(a, b, block={"m": 128, "n": 64, "k": 64}, resident_rhs=True)
    assert matmul.launches == before
    img = torch.zeros(1, 64, 15, 15, dtype=torch.bfloat16,
                      device=cuda_device)
    wgt = torch.zeros(256, 64, 3, 3, dtype=torch.bfloat16,
                      device=cuda_device)
    before = conv2d.launches
    with pytest.raises(ValueError, match="shared memory"):
        conv2d(img, wgt, block={"oc": 256, "ic": 64, "y": 13, "x": 13})
    assert conv2d.launches == before


# bf16 flash attention on the tensor cores (flash_mma_kernel): head dims
# 16/96/128, 40 (pads to 48) and 20 (rows not 16-byte multiples: the
# register route), lengths 1, 63, 65 and 512 around the 64-row and
# 64-key tiles, GQA group 4, a window, and all-pad rows.
FLASH_MMA_CASES = [
    # (B, HQ, HKV, S, D, kwargs)
    (1, 32, 32, 512, 96, {"starts": [212]}),
    (4, 8, 8, 512, 96, {"starts": [472, 412, 262, 212]}),
    (2, 8, 2, 65, 128, {"window": 9}),
    (2, 4, 1, 63, 16, {"starts": [0, 21]}),
    (3, 4, 4, 1, 16, {}),
    (2, 4, 2, 100, 40, {"starts": [3, 99]}),
    (1, 4, 2, 130, 20, {"causal": False}),
    (2, 4, 4, 200, 128, {"starts": [200, 7]}),    # row 0 all pad: zeros
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", FLASH_MMA_CASES,
                         ids=[f"{c[0]}x{c[1]}/{c[2]}-s{c[3]}-d{c[4]}-"
                              + "-".join(c[5]) for c in FLASH_MMA_CASES])
def test_cuda_bf16_flash_mma_edges(cuda_device, case):
    b, hq, hkv, s, d, kw = case
    g = torch.Generator(device=cuda_device).manual_seed(s + d)

    def rn(*shape):
        return torch.randn(shape, generator=g,
                           device=cuda_device).to(torch.bfloat16)

    q, k, v = rn(b, hq, s, d), rn(b, hkv, s, d), rn(b, hkv, s, d)
    kw = {n: torch.tensor(x, device=cuda_device) if n == "starts" else x
          for n, x in kw.items()}
    before = flash_attention.launches
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches - before == 1
    want = flash_attention_ref(q, k, v, **kw)
    assert _share_of_tol(got, want) <= 1.0
    for i, st in enumerate(kw.get("starts", torch.zeros(0)).tolist()):
        assert (got[i, :, :st] == 0).all()


@pytest.mark.gpu
def test_cuda_bf16_flash_mma_unaligned_base(cuda_device):
    """Tensors whose first element is not 16-byte aligned (a contiguous
    view at an odd offset) take the register route with D % 8 == 0."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    b, h, s, d = 1, 4, 70, 96
    n = b * h * s * d

    def view():
        buf = torch.randn(n + 1, generator=g, device=cuda_device).to(
            torch.bfloat16)
        t = buf[1:].view(b, h, s, d)
        assert t.is_contiguous() and t.data_ptr() % 16 != 0
        return t

    q, k, v = view(), view(), view()
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert _share_of_tol(got, flash_attention_ref(q, k, v)) <= 1.0


# The split decode (decode_split_kernel): D 256 with 16 query heads on
# one KV head (two head chunks) and 8 on 1, group 5, the main geometry,
# windows inside one split (the other splits empty), a row with no valid
# key (zeros), D 20 (rows staged element by element); each called twice
# in a row, which must give the very same result (the merging block
# leaves its ticket at 0 for the next launch).
DECODE_SPLIT_CASES = [
    # (B, HQ, HKV, S, D, pos, starts)
    (2, 16, 1, 512, 256, [511, 300], [0, 290]),
    (2, 8, 1, 512, 256, [40, 511], [0, 500]),
    (3, 5, 1, 200, 64, [199, 5, 100], [0, 0, 90]),
    (4, 32, 32, 544, 96, [512] * 4, [472, 412, 262, 212]),
    (2, 4, 2, 300, 20, [299, 10], [250, 20]),
]


def _twice(fn):
    """Two calls in a row; the second must equal the first."""
    a, b = fn(), fn()
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    return a


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DECODE_SPLIT_CASES,
                         ids=[f"{c[0]}x{c[1]}/{c[2]}-s{c[3]}-d{c[4]}"
                              for c in DECODE_SPLIT_CASES])
def test_cuda_split_decode_matches_plain(cuda_device, dtype, case):
    b, hq, hkv, s, d, pos, starts = case
    dt = getattr(torch, dtype)
    plan = decode_plan(b, hq, hkv, d, s, 0, dt.itemsize)
    assert plan.splits > 1 and plan.error is None
    g = torch.Generator(device=cuda_device).manual_seed(s + d + hq)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(dt)

    q, k, v = rn(b, hq, 1, d), rn(b, hkv, s, d), rn(b, hkv, s, d)
    pos_t = torch.tensor(pos, device=cuda_device)
    st = torch.tensor(starts, device=cuda_device)
    before = decode_attention.launches
    got = _twice(lambda: decode_attention(q, k, v, pos_t, starts=st))
    assert decode_attention.launches - before == 2
    want = decode_attention_ref(q, k, v, pos_t, starts=st)
    assert _share_of_tol(got, want) <= 1.0
    for i in range(b):
        if starts[i] > pos[i]:
            assert (got[i] == 0).all()


@pytest.mark.gpu
def test_cuda_decode_takes_pos_and_starts_as_any_int(cuda_device):
    """The kernel reads int32 pos and int64 starts; pos as an int, an
    int32 or an int64 tensor and starts as an int32 or an int64 tensor
    give the very same output."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v = (torch.randn(shape, generator=g, device=cuda_device)
               for shape in ((4, 8, 1, 64), (4, 2, 300, 64),
                             (4, 2, 300, 64)))
    outs = [decode_attention(q, k, v, p, starts=st)
            for p in (250, torch.full((4,), 250, device=cuda_device,
                                      dtype=torch.int32),
                      torch.full((4,), 250, device=cuda_device))
            for st in (torch.full((4,), 40, device=cuda_device,
                                  dtype=torch.int32),
                       torch.full((4,), 40, device=cuda_device))]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    want = decode_attention_ref(
        q, k, v, 250, starts=torch.full((4,), 40, device=cuda_device))
    assert _share_of_tol(outs[0], want) <= 1.0


PAGED_SPLIT_CASES = [
    # (HQ, HKV, D, bs, MB, pos)
    (16, 1, 256, 16, 34, [511, 3]),
    (8, 1, 256, 16, 34, [17, 300]),
    (5, 1, 64, 4, 40, [159, 0]),
    (32, 32, 96, 16, 34, [17, 100, 300, 511]),
    (4, 2, 20, 16, 8, [127, -1]),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PAGED_SPLIT_CASES,
                         ids=[f"{c[0]}/{c[1]}-d{c[2]}-bs{c[3]}"
                              for c in PAGED_SPLIT_CASES])
def test_cuda_split_paged_decode_matches_plain(cuda_device, dtype, case):
    hq, hkv, d, bs, mb, pos = case
    dt = getattr(torch, dtype)
    b = len(pos)
    plan = decode_plan(b, hq, hkv, d, mb * bs, bs, dt.itemsize)
    assert plan.splits > 1 and plan.split_keys % bs == 0
    g = torch.Generator(device=cuda_device).manual_seed(d + bs + hq)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(dt)

    nb = 1 + b * mb
    q, kp, vp = rn(b, hq, 1, d), rn(nb, hkv, bs, d), rn(nb, hkv, bs, d)
    perm = np.random.default_rng(d).permutation(np.arange(1, nb))
    tables = torch.from_numpy(perm.reshape(b, mb).astype(np.int32)).to(
        cuda_device)
    pos_t = torch.tensor(pos, device=cuda_device)
    before = paged_decode_attention.launches
    got = _twice(lambda: paged_decode_attention(q, kp, vp, tables, pos_t))
    assert paged_decode_attention.launches - before == 2
    want = paged_decode_attention_ref(q, kp, vp, tables, pos_t)
    assert _share_of_tol(got, want) <= 1.0
    for i, p in enumerate(pos):
        if p < 0:
            assert (got[i] == 0).all()


@pytest.mark.gpu
def test_cuda_decode_refuses_head_dims_above_256(cuda_device):
    q = torch.zeros(1, 2, 1, 257, device=cuda_device)
    k = torch.zeros(1, 1, 8, 257, device=cuda_device)
    before = decode_attention.launches
    with pytest.raises(ValueError, match="head_dim"):
        decode_attention(q, k, k, 3)
    with pytest.raises(ValueError, match="multiple"):
        decode_attention(q[:, :, :, :16], k[:, :, :, :16].expand(
            1, 3, 8, 16).contiguous(), k[:, :, :, :16].expand(
            1, 3, 8, 16).contiguous(), 3)
    assert decode_attention.launches == before


# flash at head_dim 256 (and 200: D pads to 224) with 8 and 16 query
# heads on one KV head, in both bodies.
FLASH_WIDE_CASES = [
    # (B, HQ, HKV, S, D, kwargs)
    (1, 8, 1, 512, 256, {"starts": [212]}),
    (1, 16, 1, 512, 256, {"starts": [300]}),
    (2, 5, 1, 100, 200, {"window": 40}),
    (2, 16, 1, 70, 256, {"starts": [0, 69]}),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_WIDE_CASES,
                         ids=[f"{c[0]}x{c[1]}/{c[2]}-s{c[3]}-d{c[4]}"
                              for c in FLASH_WIDE_CASES])
def test_cuda_flash_wide_heads_match_plain(cuda_device, dtype, case):
    b, hq, hkv, s, d, kw = case
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda_device).manual_seed(s + d + hq)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(dt)

    q, k, v = rn(b, hq, s, d), rn(b, hkv, s, d), rn(b, hkv, s, d)
    kw = {n: torch.tensor(x, device=cuda_device) if n == "starts" else x
          for n, x in kw.items()}
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert _share_of_tol(got, flash_attention_ref(q, k, v, **kw)) <= 1.0


# bf16 block-sparse conv on the tensor cores: count-0 oc blocks, the
# blocks of test_cuda_bf16_conv2d_mma_edges that the MMA shape pads, and
# density 1 equal to conv2d at the same blocks and pixel tile.
SPARSE_MMA_CASES = [
    # (n, ic, h, oc, k), skip block
    ((2, 512, 13, 1000, 1), {"oc": 40, "ic": 64}),
    ((2, 16, 55, 64, 3), {"oc": 64, "ic": 8}),
    ((2, 512, 13, 1000, 1), {"oc": 125, "ic": 16}),
    ((32, 128, 25, 128, 3), {"oc": 16, "ic": 16}),
    ((2, 64, 13, 256, 3), {"oc": 32, "ic": 16}),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", SPARSE_MMA_CASES,
                         ids=[f"oc{c[0][3]}-ic{c[0][1]}-k{c[0][4]}-"
                              f"{c[1]['oc']}.{c[1]['ic']}"
                              for c in SPARSE_MMA_CASES])
def test_cuda_bf16_sparse_conv_mma_edges(cuda_device, case):
    from repro_torch.core.loopnest import ConvLayer
    from repro_torch.core.sparsity import sparse_pixel_tile
    (n, ic, h, oc, k), block = case
    g = torch.Generator(device=cuda_device).manual_seed(ic + oc + k)
    img = torch.randn(n, ic, h + k - 1, h + k - 1, generator=g,
                      device=cuda_device).to(torch.bfloat16)
    wgt = (torch.randn(oc, ic, k, k, generator=g, device=cuda_device)
           * (ic * k * k) ** -0.5).to(torch.bfloat16)
    n_oc, n_ic = oc // block["oc"], ic // block["ic"]
    keep = np.random.default_rng(oc + ic).random((n_oc, n_ic)) < 0.4
    if n_oc > 1:
        keep[0] = False                          # a count-0 oc block
        keep[-1] = True                          # a full one
    mask = torch.from_numpy(np.repeat(np.repeat(keep, block["oc"], 0),
                                      block["ic"], 1)).to(cuda_device)
    sw = wgt * mask.to(torch.bfloat16)[:, :, None, None]
    for w, dense in ((sw, False), (wgt, True)):
        sp = analyze_weights(w, block)
        before = sparse_conv2d.launches
        got = sparse_conv2d(img, w, block=block, sparsity=sp)
        again = sparse_conv2d(img, w, block=block, sparsity=sp)
        torch.cuda.synchronize()
        assert sparse_conv2d.launches - before == 2
        assert torch.equal(got, again)
        assert list(sp._on_device) == [img.device]   # one index copy
        want = sparse_conv_plain(img, w, sp.idx, sp.counts, block)
        assert _share_of_tol(got, want) <= 1.0
        if not dense and not keep[0].any():
            assert (got[:, :block["oc"]] == 0).all()
        else:       # every block nonzero: the dense conv's very sums
            by, bx = sparse_pixel_tile(ConvLayer(oc, ic, h, h, k, k),
                                       block["oc"], block["ic"], n)
            ref = conv2d(img, w, block={**block, "y": by, "x": bx},
                         grid_order=("oc", "y", "x", "ic"))
            assert torch.equal(got, ref)


# ------------------------------------------- captured engine and generate

SMOKE_ARCHS = ("phi3-mini-3.8b-smoke", "falcon-mamba-7b-smoke")


def _smoke_serve(arch, dev, capture):
    """The smoke config in float32 through a session and generate(session=);
    (engine tokens, engine launches, generate tokens, generate launches,
    session)."""
    model = build_model(get_config(arch))
    params = model.init(seed=0, device=dev)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 256, n).astype(np.int32)
               for n in (5, 7, 3, 6, 12, 9)]
    s = ServeSession(model, params, kv_block_size=4, batch_sizes=(1, 2, 4),
                     capture=capture)
    reset_launch_counts()
    for i, p in enumerate(prompts):
        s.submit(p, 8, request_id=f"r{i}")
    eng = {r.request_id: r.tokens.tolist() for r in s.drain()}
    eng_counts = launch_counts()
    reset_launch_counts()
    gen, _ = generate(model, params,
                      {"tokens": left_pad_prompts(prompts[:4], 16)},
                      max_new_tokens=10,
                      seq_starts=prompt_starts(prompts[:4], 16), session=s)
    gen_counts = launch_counts()
    torch.cuda.synchronize()
    for k in list(s.exec_cache.compiled_log):
        again = s.exec_cache.peek(k)
        assert (again.graph is not None) == capture, k
    return eng, eng_counts, gen, gen_counts, s, prompts


@pytest.mark.gpu
@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_cuda_graph_steps_equal_eager_steps(cuda_device, arch):
    """Graphs and eager kernels give the same tokens and the same launch
    counts; every step ran as a graph replay; a second drain of the same
    stream captures nothing."""
    g_eng, g_ec, g_gen, g_gc, gs, prompts = _smoke_serve(arch, cuda_device,
                                                         True)
    e_eng, e_ec, e_gen, e_gc, es, _ = _smoke_serve(arch, cuda_device, False)
    assert g_eng == e_eng and np.array_equal(g_gen, e_gen)
    assert g_ec == e_ec and g_gc == e_gc
    assert sum(g_ec.values()) > 0 and sum(g_gc.values()) > 0
    steps = {"prefill": 0, "decode": 0}
    for k in gs.exec_cache.compiled_log:
        steps[k.role] += gs.exec_cache.peek(k).replays
    assert steps == {"prefill": gs.stats.inflight_admissions + 1,
                     "decode": gs.stats.steps + 9}
    assert gs.stats.graph_pool_bytes > 0 and es.stats.graph_pool_bytes == 0
    built = gs.exec_cache.compiles
    for i, p in enumerate(prompts):
        gs.submit(p, 8, request_id=f"r{i}")
    again = {r.request_id: r.tokens.tolist() for r in gs.drain()}
    assert again == g_eng and gs.exec_cache.compiles == built


@pytest.mark.gpu
@pytest.mark.parametrize("order", ["drain_first", "generate_first"])
def test_cuda_engine_and_generate_share_the_ssm_decode_graph(cuda_device,
                                                             order):
    """An ssm engine of 4 rows (prompts of bucket 8, budget 8) and
    generate of [4, 8] + 8 tokens share one decode key and graph; in
    either order both give the tokens of eager fresh sessions."""
    model = build_model(get_config("falcon-mamba-7b-smoke"))
    params = model.init(seed=0, device=cuda_device)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 256, n).astype(np.int32)
               for n in (5, 8, 3, 7)]
    batch = {"tokens": left_pad_prompts(prompts, 8)}
    starts = prompt_starts(prompts, 8)

    def drain(s):
        for i, p in enumerate(prompts):
            s.submit(p, 8, request_id=f"r{i}")
        return {r.request_id: r.tokens.tolist() for r in s.drain()}

    def gen(s):
        return generate(model, params, batch, max_new_tokens=8,
                        seq_starts=starts, session=s)[0]

    want_d = drain(ServeSession(model, params, batch_sizes=(4,),
                                capture=False))
    want_g = gen(ServeSession(model, params, capture=False))
    s = ServeSession(model, params, batch_sizes=(4,))
    if order == "drain_first":
        got_d, got_g = drain(s), gen(s)
    else:
        got_g, got_d = gen(s), drain(s)
    assert got_d == want_d and np.array_equal(got_g, want_g)
    decode = [k for k in s.exec_cache.compiled_log if k.role == "decode"]
    assert [(k.batch, k.length, k.detail) for k in decode] == [(4, 16, None)]
    assert s.exec_cache.peek(decode[0]).graph is not None


@pytest.mark.gpu
def test_cuda_decode_graph_keeps_its_ticket_counters(cuda_device):
    """A decode graph captured before a larger plan grows the capture
    stream's ticket counters still merges right when replayed after the
    allocator has handed memory out again: the counters it holds are
    kept, not freed."""
    from repro_torch.serving.captured import CapturedStep
    g = torch.Generator(device=cuda_device).manual_seed(17)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(
            torch.bfloat16)

    q, k, v = rn(1, 32, 1, 64), rn(1, 32, 4096, 64), rn(1, 32, 4096, 64)
    pos = torch.tensor([4000], device=cuda_device)
    small = decode_plan(1, 32, 32, 64, 4096, 0, 2)
    big = decode_plan(160, 32, 32, 64, 64, 0, 2)
    assert small.splits > 1 and small.tickets <= 4096 < big.tickets
    from repro_torch.kernels.decode_attention import ops as dec_ops
    first = CapturedStep(lambda: decode_attention(q, k, v, pos), cuda_device)
    retired = len(dec_ops._RETIRED)
    q2, k2, v2 = rn(160, 32, 1, 64), rn(160, 32, 64, 64), rn(160, 32, 64, 64)
    grown = CapturedStep(lambda: decode_attention(q2, k2, v2, 63),
                         cuda_device)
    assert len(dec_ops._RETIRED) == retired + 1
    # freed blocks go back to their stream's pool: fill it with junk
    with torch.cuda.stream(torch.cuda.graph.default_capture_stream):
        junk = [torch.full((4096,), 7, dtype=torch.int32,
                           device=cuda_device) for _ in range(256)]
    torch.cuda.synchronize()
    want = decode_attention_ref(q, k, v, pos)
    for _ in range(2):
        got = first.replay().clone()
        torch.cuda.synchronize()
        assert _share_of_tol(got, want) <= 1.0
    assert _share_of_tol(grown.replay(),
                         decode_attention_ref(q2, k2, v2, 63)) <= 1.0
    del junk


CAPTURE_FAILURE = """
import os, sys
import numpy as np
from repro_torch.configs import get_config
from repro_torch.models import Model, build_model
from repro_torch.serving import ServeSession

model = build_model(get_config("phi3-mini-3.8b-smoke"))
params = model.init(seed=0)
real, calls = Model.decode_step, []

def reads_host(self, *a, **k):
    calls.append(1)
    lg, c = real(self, *a, **k)
    if float(lg.abs().sum()) < 0:       # a host read of a device value
        raise AssertionError
    return lg, c

Model.decode_step = reads_host
s = ServeSession(model, params, batch_sizes=(1,))
s.submit(np.arange(1, 6), 4)
try:
    s.drain()
except RuntimeError:
    print("raised", len(calls), s.stats.steps, s.exec_cache.compiles,
          flush=True)
    os._exit(0)
print("ran", len(calls), flush=True)
os._exit(1)
"""


@pytest.mark.gpu
def test_cuda_capture_failure_raises_and_runs_nothing_eagerly(cuda_device):
    """A decode step that reads a host value cannot be captured: drain
    raises after the warm-up and the one capture attempt, with no step
    run and no decode step cached.  In a child process: a failed
    capture can leave the CUDA context unusable."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c",
                          textwrap.dedent(CAPTURE_FAILURE)],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    # warm-up + capture attempt; no step; only the prefill was built
    assert out.stdout.split() == ["raised", "2", "0", "1"], out.stdout
