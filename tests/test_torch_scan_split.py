"""The selective scan's split arithmetic (``csrc/ssm_scan.cu``,
ssm_scan_kernel), on the CPU.

The CUDA body cannot run here, so its float32 arithmetic is emulated in
plain PyTorch in the kernel's order of operations and data movement: a
block of ``block_d`` channels (the last one ragged: its dead channels
stage zeros), each channel's N states split across L = N / P lanes with
P states a lane (``_geometry.scan_layout``), x, dt, b and c staged
``SCAN_TILE_STEPS`` steps at a time (the last tile ragged: its steps go
in groups of L, those past the end skipped), the sequential update
h = 2^(dt (a log2 e)) h + (dt x) b, each lane's partial <h, c> over its
P states in order, the reduce-scatter over the lanes (L / 2, ..., 1
apart) that leaves lane l the sum of step l of a group, y written over
the staged x and copied out.  The reduce-scatter is held bit for bit to
the fixed xor tree it replaces.  The emulation is held to the plain
version and to the JAX package's ``ssm_scan_pallas`` (interpret mode,
as ``tests/test_torch_ssm.py`` runs it) at float32 1e-5: the same
recurrence, with the sums over N in another order and exp taken as a
power of two.  The card runs the kernel itself in
``tests/test_torch_gpu.py``.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssm_scan import ssm_scan_pallas  # noqa: E402
from repro_torch.kernels import _build, _geometry as geo  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as scan_ops  # noqa: E402
from repro_torch.kernels.ssm_scan import ssm_scan_ref  # noqa: E402

ATOL = 1e-5
# (Bt, S, Di, N, block_d): full tiles, a ragged last tile, a ragged last
# channel block, a decode step, several blocks of one row
SHAPES = [
    (2, 64, 64, 16, 32),
    (2, 70, 100, 16, 64),
    (3, 37, 100, 8, 64),
    (1, 33, 96, 8, 32),
    (4, 1, 72, 16, 32),
    (1, 5, 40, 8, 128),
]


def _ids(shapes):
    return ["-".join(map(str, s)) for s in shapes]


def _inputs(seed, bt, s, di, n, h0=False, pad=0):
    """Scan inputs as numpy (softplus'd dt, a = -(1..N) scaled per
    channel); ``pad`` leading steps of every row masked to x = 0 and
    b = 0, as the model masks a left pad."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(bt, s, di)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(-1.0, 0.5, (bt, s, di)))).astype(
        np.float32)
    b = rng.normal(size=(bt, s, n)).astype(np.float32)
    c = rng.normal(size=(bt, s, n)).astype(np.float32)
    a = (-np.arange(1, n + 1, dtype=np.float32)[None, :]
         * rng.uniform(0.5, 1.5, (di, 1)).astype(np.float32))
    d = rng.normal(size=(di,)).astype(np.float32)
    x[:, :pad] = 0
    b[:, :pad] = 0
    hh = rng.normal(size=(bt, di, n)).astype(np.float32) if h0 else None
    return x, dt, b, c, a, d, hh


LOG2E = torch.tensor(1.44269502, dtype=torch.float32)   # kLog2e


def reduce_scatter(part):
    """The kernel's reduce-scatter of partials [..., L lanes, L steps]:
    lane l ends with the whole sum of step l, returned as [..., L]."""
    lanes = part.shape[-1]
    part = part.clone()
    lane = torch.arange(lanes)
    o = lanes // 2
    while o > 0:
        upper = ((lane & o) != 0)[:, None]            # [L, 1]
        lo, hi = part[..., :o], part[..., o:2 * o]
        keep = torch.where(upper, hi, lo)
        send = torch.where(upper, lo, hi)
        part[..., :o] = keep + send[..., lane ^ o, :]
        o //= 2
    return part[..., 0]


def xor_tree(part):
    """The fixed xor tree over the lanes for every step: [..., L]."""
    lanes = part.shape[-2]
    lane = torch.arange(lanes)
    acc = part.clone()
    o = lanes // 2
    while o > 0:
        acc = acc + acc[..., lane ^ o, :]
        o //= 2
    return acc[..., 0, :]


def emulate(x, dt, b, c, a, d, h0, block_d):
    """The kernel's float32 arithmetic on CPU tensors: (y, final state)."""
    bt, s, di = x.shape
    n = b.shape[-1]
    lay = geo.scan_layout(block_d, n, x.element_size())
    assert lay.error is None, lay.error
    p, lanes, tile = lay.states_per_lane, lay.lanes, geo.SCAN_TILE_STEPS
    y = torch.empty((bt, s, di), dtype=x.dtype)
    h_out = torch.empty((bt, di, n), dtype=torch.float32)
    for c0 in range(0, di, block_d):
        live = min(block_d, di - c0)
        # a lane's P states of each channel: [block_d, lanes, P]; dead
        # channels hold zeros
        av = torch.zeros((block_d, n))
        av[:live] = a[c0:c0 + live]
        a2 = (av * LOG2E).view(block_d, lanes, p)
        dv = torch.zeros(block_d)
        dv[:live] = d[c0:c0 + live].float()
        h = torch.zeros((bt, block_d, n))
        if h0 is not None:
            h[:, :live] = h0[:, c0:c0 + live]
        h = h.view(bt, block_d, lanes, p)
        for t0 in range(0, s, tile):
            ln = min(tile, s - t0)
            # the staged tile: rows t0 .. t0 + ln - 1, zeros past Di
            x_s = torch.zeros((bt, tile, block_d), dtype=x.dtype)
            dt_s = torch.zeros((bt, tile, block_d))
            x_s[:, :ln, :live] = x[:, t0:t0 + ln, c0:c0 + live]
            dt_s[:, :ln, :live] = dt[:, t0:t0 + ln, c0:c0 + live]
            b_s = b[:, t0:t0 + ln].reshape(bt, ln, lanes, p)
            c_s = c[:, t0:t0 + ln].reshape(bt, ln, lanes, p)
            ys = {}
            for g in range(0, ln, lanes):
                # a lane's partial of each step of the group
                part = torch.zeros((bt, block_d, lanes, lanes))
                for j in range(lanes):
                    if g + j >= ln:          # past the ragged tile's end
                        continue
                    dtt = dt_s[:, g + j][..., None]          # [bt,bd,1]
                    dx = dtt * x_s[:, g + j].float()[..., None]
                    for q in range(p):
                        da = torch.exp2(dtt * a2[..., q])
                        h[..., q] = (da * h[..., q]
                                     + dx * b_s[:, g + j, None, :, q])
                        part[..., j] = (part[..., j] + h[..., q]
                                        * c_s[:, g + j, None, :, q])
                for j, v in enumerate(reduce_scatter(part).unbind(-1)):
                    if g + j < ln:
                        ys[g + j] = v
            # y over the staged x once the tile's steps have read it
            for t, v in ys.items():
                x_s[:, t] = (v + dv * x_s[:, t].float()).to(x.dtype)
            y[:, t0:t0 + ln, c0:c0 + live] = x_s[:, :ln, :live]
        h_out[:, c0:c0 + live] = h.reshape(bt, block_d, n)[:, :live]
    return y, h_out


def _torch(arrays):
    return [None if v is None else torch.from_numpy(v) for v in arrays]


@pytest.mark.parametrize("h0", [False, True], ids=["zero_h0", "h0"])
@pytest.mark.parametrize("shape", SHAPES, ids=_ids(SHAPES))
def test_emulated_split_scan_matches_plain_and_pallas(shape, h0):
    bt, s, di, n, block_d = shape
    arrays = _inputs(sum(shape), bt, s, di, n, h0)
    args = _torch(arrays)
    y, h = emulate(*args, block_d)
    y_ref, h_ref = ssm_scan_ref(*args)
    torch.testing.assert_close(y, y_ref, rtol=0, atol=ATOL)
    torch.testing.assert_close(h, h_ref, rtol=0, atol=ATOL)
    x, dt, b, c, a, d, hh = arrays
    y_p, h_p = ssm_scan_pallas(
        *map(jnp.asarray, (x, dt, b, c, a, d)),
        h0=None if hh is None else jnp.asarray(hh), block_d=block_d,
        interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_p), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_p), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("n", [8, 16])
def test_emulated_masked_pad_prefix_keeps_the_state_exactly_zero(n):
    """A pad prefix (x = 0 and b = 0) longer than a tile leaves a zero
    state exactly 0 and y exactly 0, so the padded row's final state and
    real outputs equal the row scanned alone, bit for bit."""
    pad, real = geo.SCAN_TILE_STEPS + 7, 20
    args = _torch(_inputs(n, 2, pad + real, 96, n, pad=pad))
    y, h = emulate(*args, 32)
    y_pre, h_pre = emulate(*[v[:, :pad] if v is not None and v.dim() == 3
                             and v.shape[1] == pad + real else v
                             for v in args], 32)
    assert torch.equal(h_pre, torch.zeros_like(h_pre))
    assert torch.equal(y[:, :pad], torch.zeros_like(y[:, :pad]))
    solo = [v[:, pad:] if v is not None and v.dim() == 3
            and v.shape[1] == pad + real else v for v in args]
    y_solo, h_solo = emulate(*solo, 32)
    assert torch.equal(y[:, pad:], y_solo) and torch.equal(h, h_solo)


def test_emulated_bf16_y_rounds_once():
    """bf16 x and d: the staged x is read as float32 and y is rounded to
    bf16 once, as the plain version rounds it."""
    bt, s, di, n = 2, 40, 64, 16
    args = _torch(_inputs(9, bt, s, di, n, h0=True))
    args[0] = args[0].to(torch.bfloat16)
    args[5] = args[5].to(torch.bfloat16)
    y, h = emulate(*args, 32)
    y_ref, h_ref = ssm_scan_ref(*args)
    assert y.dtype == torch.bfloat16
    want = y_ref.float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(
        2.0 ** -126))) - 7)
    assert ((y.float() - want).abs() <= 2 * ulp + 1e-5).all()
    torch.testing.assert_close(h, h_ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("block_d,n,elem,threads,error", [
    (64, 16, 2, 256, None),
    (256, 16, 2, 1024, None),
    (256, 16, 4, 1024, None),
    (512, 8, 2, 1024, None),
    (512, 16, 2, 2048, "threads"),
    (512, 8, 4, 1024, "shared memory"),
    (48, 16, 2, 192, "multiple of 32"),
    (64, 12, 2, 192, "state size"),
])
def test_scan_layout_limits(block_d, n, elem, threads, error):
    lay = geo.scan_layout(block_d, n, elem)
    assert lay.threads == threads
    assert lay.lanes * lay.states_per_lane == n or error == "state size"
    if error is None:
        assert lay.error is None and lay.smem <= geo.SMEM_BYTES
    else:
        assert error in lay.error


@pytest.mark.parametrize("block_d,n", [(512, 16), (1024, 8), (48, 16),
                                       (64, 12), (64, 4)])
def test_wrapper_raises_before_any_launch(monkeypatch, block_d, n):
    """The CUDA path's checks reject a block the kernel cannot take
    before it builds or launches anything (the tensors are CPU tensors
    standing in for CUDA ones: the build is replaced by a failure)."""
    monkeypatch.setattr(scan_ops, "on_cpu", lambda t: False)

    def no_build():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(_build, "load", no_build)
    args = _torch(_inputs(0, 1, 4, 64, n))
    before = scan_ops.ssm_scan.launches
    with pytest.raises(ValueError):
        scan_ops.ssm_scan(*args, block_d=block_d)
    assert scan_ops.ssm_scan.launches == before


@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
def test_reduce_scatter_equals_the_xor_tree_bit_for_bit(lanes):
    """Lane l of the reduce-scatter holds step l's sum of the lanes'
    partials in the xor tree's order (float addition commutes, so the
    pairs added at each round are the same values)."""
    part = torch.from_numpy(np.random.default_rng(lanes).normal(
        size=(3, 5, lanes, lanes)).astype(np.float32)) * 1e3
    assert torch.equal(reduce_scatter(part), xor_tree(part))


def test_scan_timeline_finds_every_anchor():
    """``launch/scan_timeline.py`` splices its stamps into a copy of
    ``ssm_scan.cu`` at text anchors: each must be found once, so a
    kernel edit that moves one fails here rather than on the card."""
    from repro_torch.launch.scan_timeline import (STAMPS,
                                                  instrumented_source)
    src = instrumented_source()
    assert src.count("] = stamp_ns() + ") == len(STAMPS)
    for k in range(len(STAMPS)):
        assert f"* 5 + {k}] = stamp_ns()" in src, STAMPS[k]


def test_source_constants_match_the_layout():
    """``_geometry``'s states a lane and tile steps are the source's, and
    the scratch variants' anchors are found once."""
    from repro_torch.launch.scan_variants import EXP_LINE, P_LINE
    src = (_build.CSRC / "ssm_scan.cu").read_text()
    m = re.search(r"constexpr int kP = (\d+);", src)
    assert m and int(m.group(1)) == geo.SCAN_STATES_PER_LANE
    m = re.search(r"constexpr int kTile = (\d+);", src)
    assert m and int(m.group(1)) == geo.SCAN_TILE_STEPS
    assert src.count(EXP_LINE) == 1 and src.count(P_LINE) == 1
    for n in geo.SCAN_STATES:
        assert f"case {n}:" in src
