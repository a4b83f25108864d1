"""The tensor-core (bf16) layouts of the port's conv2d and matmul, and the
tuning layer that ranks their schedules, on the CPU.

The layouts are pure Python (``repro_torch.kernels._geometry``): the
wrappers launch with them, the cost model times them, the tuner offers
only what they accept.  The parity tests hold the port's conv2d and
matmul at the blocks the MMA shapes pad (channels of 13, 40, 125; 8
input channels; 13 x 13 and 1 x 13 pixel tiles) to the JAX kernels in
interpret mode, in bf16 (per element two bf16 ulps + 1e-5 of the
largest magnitude at a rounding point) and float32 (1e-5).
"""
import dataclasses
import itertools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.conv2d import conv2d_pallas  # noqa: E402
from repro.kernels.matmul import matmul_pallas  # noqa: E402
from repro_torch.configs.squeezenet_layers import TABLE_4_1  # noqa: E402
from repro_torch.core import cost_model as cm  # noqa: E402
from repro_torch.core import registry as reg  # noqa: E402
from repro_torch.core import sparsity, tuner  # noqa: E402
from repro_torch.core.loopnest import ConvLayer  # noqa: E402
from repro_torch.kernels import _geometry as geo  # noqa: E402
from repro_torch.kernels import conv2d, matmul  # noqa: E402
from repro_torch.kernels.conv2d import (conv2d_plain,  # noqa: E402
                                        uses_scratch)
from repro_torch.kernels.matmul import matmul_plain  # noqa: E402

QKV = (512, 9216, 3072)


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _pair(a, dtype):
    return (torch.from_numpy(a).to(getattr(torch, dtype)),
            jnp.asarray(a).astype(getattr(jnp, dtype)))


def _from_jax(x):
    t = torch.from_numpy(np.array(x.astype(jnp.float32)))
    return t.to(torch.bfloat16) if x.dtype == jnp.bfloat16 else t


def _assert_close(got, want, peak=None):
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = (got.float() - want.float()).abs()
    if want.dtype == torch.bfloat16:
        mag = (want.float().abs() if peak is None else peak
               ).clamp_min(2.0 ** -126)
        allowed = 2 * torch.exp2(torch.floor(torch.log2(mag)) - 7) + 1e-5
    else:
        allowed = torch.full_like(diff, 1e-5)
    assert (diff / allowed).max().item() <= 1.0


# ------------------------------------------------------------- geometry

@pytest.mark.parametrize("block,kernel,problem,order,want", [
    # (boc, bic, by, bx), (kh, kw), (oc, ic, h, w) at batch 32, output
    # order -> (rows, rows padded to 64 mt, wgmma N, mt, oc_pad, bic_pad,
    # warps, rounds), (walk, stages, late, fixed halo)
    ((40, 64, 13, 13), (1, 1), (1000, 512, 13, 13), "oyx",
     ((169, 192, 64, 1, 64, 64, 12, 1), (1, 3, False, False))),
    ((125, 16, 1, 13), (1, 1), (1000, 512, 13, 13), "oyx",
     ((13, 64, 64, 1, 128, 16, 8, 1), (1, 3, False, False))),
    ((125, 16, 1, 13), (1, 1), (1000, 512, 13, 13), "yxo",
     ((13, 64, 64, 1, 128, 16, 8, 1), (1, 3, False, True))),
    ((200, 16, 1, 13), (1, 1), (1000, 512, 13, 13), "yxo",
     ((13, 64, 64, 1, 256, 16, 16, 1), (1, 3, False, True))),
    ((32, 32, 14, 28), (3, 3), (256, 32, 28, 28), "yxo",
     ((418, 448, 32, 1, 32, 32, 16, 2), (4, 3, False, True))),
    ((64, 8, 5, 11), (3, 3), (64, 16, 55, 55), "oyx",
     ((63, 64, 64, 1, 64, 16, 8, 1), (7, 3, False, False))),
    ((128, 32, 11, 11), (1, 1), (128, 32, 55, 55), "oyx",
     ((121, 128, 64, 1, 128, 32, 16, 1), (7, 3, False, False))),
    ((128, 16, 13, 13), (3, 3), (256, 64, 13, 13), "oyx",
     ((193, 256, 64, 2, 128, 16, 16, 1), (1, 2, False, False))),
    ((32, 16, 25, 25), (3, 3), (128, 128, 25, 25), "oyx",
     ((673, 768, 32, 3, 32, 16, 16, 1), (1, 3, False, False))),
    ((64, 16, 25, 25), (3, 3), (128, 128, 25, 25), "oyx",
     ((673, 768, 64, 2, 64, 16, 16, 2), (1, 3, False, False))),
    ((13, 1, 1, 1), (1, 1), (13, 1, 1, 1), "oyx",
     ((1, 64, 16, 1, 16, 16, 8, 1), (1, 3, False, False))),
    ((10, 10, 10, 10), (11, 11), (10, 10, 10, 10), "oyx",
     ((190, 192, 16, 1, 16, 16, 12, 1), (1, 2, False, False))),
    ((15, 15, 2, 2), (11, 11), (90, 90, 10, 10), "oyx",
     ((14, 64, 16, 1, 16, 16, 8, 1), (1, 2, True, False))),
], ids=str)
def test_conv_mma_layout_pads_to_the_mma_shape(block, kernel, problem, order,
                                               want):
    """The rows are the halo's pixels up to the last stored one ((by - 1)
    (bx + kw - 1) + bx: a 1 x 1 kernel's are its pixels, a k x k kernel's
    carry kw - 1 junk columns a row) padded to 64 mt, mt the fewest 64-row
    tiles a warpgroup holds (up to 3, 2 at N 64) that take one round where
    a tile sums several channel blocks, else 1; oc pads to the wgmma width
    that reads the fewest bytes (16, 32 or 64), ic to 16; 2 to 4
    warpgroups, rounds past 4; a walk keeps the weights resident (oc
    before the pixel axes) or the halo (oc last) where it takes fewer
    waves times tiles; an 11 x 11 kernel of 16 oc fits two slots of each
    operand at 10 x 10 pixels, and takes the single slot at 2 x 2 pixels
    of 90 channels; every such tile fits, and the layout covers the
    launch's tiles."""
    oc, ic, h, w = problem
    axes = {"o": "oc", "y": "y", "x": "x"}
    t = geo.conv_mma_tile(*block, *kernel, oc=oc, ic=ic, h=h, w=w, batch=32,
                          order=tuple(axes[a] for a in order))
    assert (t.rows, t.m_pad, t.nt, t.mt, t.boc_pad, t.bic_pad, t.warps,
            t.rounds) == want[0]
    assert (t.walk, t.stages, t.late, t.fixed_halo) == want[1]
    assert t.error is None and t.threads == 32 * t.warps
    wg_m, wg_n = t.wg_tiles
    assert t.rounds == -(-wg_m * wg_n // (t.warps // 4))
    # each group's tiles in walks of `walk`, the last one ragged
    assert t.blocks == t.tiles // t.group * -(-t.group // t.walk)


@pytest.mark.parametrize("block,kernel,problem", [
    ((256, 64, 13, 13), (3, 3), (256, 64, 13, 13)),
    ((40, 512, 13, 13), (1, 1), (1000, 512, 13, 13)),
    # 11 x 11 weights of 64 oc x 32 channels: 248 KB a slot
    ((64, 32, 2, 2), (11, 11), (210, 210, 10, 10)),
], ids=str)
def test_conv_mma_layout_refuses_what_does_not_fit(block, kernel, problem):
    oc, ic, h, w = problem
    for batch in (1, 32):
        t = geo.conv_mma_tile(*block, *kernel, oc=oc, ic=ic, h=h, w=w,
                              batch=batch)
        assert "shared memory" in t.error


@pytest.mark.parametrize("ic,blocks", [(90, 6), (210, 14)])
@pytest.mark.parametrize("order", [("oc", "y", "x", "ic"),
                                   ("ic", "oc", "y", "x")])
def test_conv_mma_accumulator_parts_hold_mma_part_k(ic, blocks, order):
    """Table 4.2's long sums at 11 x 11 (10,890 and 25,410 terms in the
    scratch order's one launch; 1,815 in each launch of a
    read-modify-write order): no accumulator part sums more than
    MMA_PART_K terms; the parts are whole channel blocks in order, all
    but the last as many as fit; a channel block of more than MMA_PART_K
    terms is refused."""
    oc, h, w, k = ic, 10, 10, 11
    blk = {"oc": 15, "ic": 15, "y": 2, "x": 2}
    t = geo.conv_mma_tile(blk["oc"], blk["ic"], blk["y"], blk["x"], k, k,
                          oc=oc, ic=ic, h=h, w=w, batch=2,
                          order=tuple(a for a in order if a != "ic"))
    assert t.error is None
    assert blk in tuner.conv_blocks(ConvLayer(oc, ic, h, w, k, k), 2)
    summed = blocks if uses_scratch(order) else 1
    parts = t.parts(summed)
    assert t.block_ksteps == k * k * t.bic_pad // 16
    assert sum(parts) == summed * t.block_ksteps
    # terms: the block's 15 channels of each 16-channel k step
    assert max(parts) * 16 <= geo.MMA_PART_K
    assert max(parts) * blk["ic"] * t.bic_pad // 16 <= geo.MMA_PART_K
    assert all(p % t.block_ksteps == 0 for p in parts)
    assert all(p == parts[0] for p in parts[:-1])
    assert parts[0] + t.block_ksteps > t.part_k or len(parts) == 1
    if summed * k * k * blk["ic"] > geo.MMA_PART_K:
        assert len(parts) > 1
    # 42 channels at 11 x 11 pad to 48: 363 k16 steps a block
    wide = geo.conv_mma_tile(15, 42, 2, 2, k, k, oc=oc, ic=ic, h=h, w=w,
                             batch=2)
    assert "k16 steps" in wide.error
    assert {"oc": 15, "ic": 42, "y": 2, "x": 2} not in tuner.conv_blocks(
        ConvLayer(oc, ic, h, w, k, k), 2)
    # Table 4.1's longest sum (fire9-conv3x3-2, 64 x 9 = 576) is one part
    layer = TABLE_4_1["fire9-conv3x3-2"]
    t41 = geo.conv_mma_tile(64, 64, 13, 13, 3, 3, oc=layer.oc, ic=layer.ic,
                            h=layer.h, w=layer.w)
    assert t41.parts(1) == (36,)


OFFERED_LAYERS = [(n, b) for n in TABLE_4_1 for b in (1, 32)]


@pytest.mark.parametrize("name,batch", OFFERED_LAYERS, ids=str)
def test_every_offered_bf16_block_fits_the_layout(name, batch):
    """Every bf16 block the tuner offers for a Table 4.1 layer fits the
    body's layout (227 KB) in every output order (the read-modify-write
    launches take the scratch launch's)."""
    layer = TABLE_4_1[name]
    blocks = tuner.conv_blocks(layer, 2)
    assert blocks
    for b in blocks:
        for order in itertools.permutations(("oc", "y", "x")):
            t = geo.conv_mma_tile(
                b["oc"], b["ic"], b["y"], b["x"], layer.kh, layer.kw,
                oc=layer.oc, ic=layer.ic, h=layer.h, w=layer.w, batch=batch,
                order=order)
            assert t.error is None and t.smem <= geo.SMEM_BYTES


@pytest.mark.parametrize("batch", [1, 32])
@pytest.mark.parametrize("name", ["fig6.2", "fire9-conv3x3-2"])
def test_every_offered_sparse_block_fits_the_layout(name, batch):
    """Every bf16 skip block the tuner offers for the block-sparse layers
    fits the body's layout at its pixel tile, with every ic block
    resident and the index row (the most a structure can need)."""
    layer = (ConvLayer(128, 128, 25, 25, 3, 3) if name == "fig6.2"
             else TABLE_4_1[name])
    blocks = tuner.sparse_blocks(layer, 2)
    assert blocks
    for b in blocks:
        by, bx = sparsity.sparse_pixel_tile(layer, b["oc"], b["ic"], batch)
        n_ic = layer.ic // b["ic"]
        t = geo.sparse_layout(b["oc"], b["ic"], by, bx, layer.kh, layer.kw,
                              n_ic, 2, oc=layer.oc, ic=layer.ic, h=layer.h,
                              w=layer.w, batch=batch, max_nnz=n_ic)
        assert t.error is None and t.smem <= geo.SMEM_BYTES


@pytest.mark.parametrize("bm,bn,bk,k,resident,want", [
    # -> (bm_pad, bn_pad, ks, stages)
    (128, 128, 64, 3072, False, (128, 128, 64, 7)),
    # stages of 48 KB: four fit
    (128, 256, 64, 3072, False, (128, 256, 64, 4)),
    (125, 13, 16, 512, False, (128, 16, 16, 8)),
    (125, 169, 128, 512, False, (128, 192, 64, 5)),
    (48, 243, 48, 384, False, (64, 256, 64, 5)),
    (64, 96, 32, 3072, False, (64, 96, 32, 8)),
    # two stages of A beside the 192 KB panel
    (128, 32, 3072, 3072, True, (128, 32, 64, 2)),
    (100, 13, 32, 512, True, (128, 16, 32, 8)),
    (128, 192, 64, 3072, False, (128, 192, 64, 5)),
    # k 36 is 3 chunks of 16: no fourth stage
    (64, 40, 12, 36, False, (64, 64, 16, 3)),
], ids=str)
def test_matmul_mma_layout_pads_to_the_wgmma_shape(bm, bn, bk, k,
                                                   resident, want):
    t = geo.matmul_mma_tile(bm, bn, bk, k, resident)
    assert (t.bm_pad, t.bn_pad, t.ks, t.stages) == want
    assert t.error is None and t.smem <= geo.SMEM_BYTES
    assert t.threads == 128 * (t.bm_pad // 64 + 1)
    # the source's mma_smem: 1024-byte aligned ring and panel, then the
    # barriers
    ring = t.stages * (-(-t.bm_pad * t.ks * 2 // 1024) * 1024
                       + (0 if resident else
                          -(-t.bn_pad * t.ks * 2 // 1024) * 1024))
    panel = (-(-t.bn_pad * (-(-k // 64) * 64) * 2 // 1024) * 1024
             if resident else 0)
    assert t.smem == 1024 + ring + panel + geo.MMA_BARRIER_BYTES


@pytest.mark.parametrize("bm,bn,bk,k,resident,match", [
    (256, 64, 64, 3072, False, "rows above 128"),
    (128, 300, 64, 3072, False, "columns above 256"),
    (128, 64, 64, 3072, True, "shared memory"),
    (128, 256, 64, 1024, True, "shared memory"),
], ids=str)
def test_matmul_mma_layout_refuses_what_does_not_fit(bm, bn, bk, k,
                                                     resident, match):
    assert match in geo.matmul_mma_tile(bm, bn, bk, k, resident).error


@pytest.mark.parametrize("k,n,want", [
    (3072, 9216, (True, True)),      # phi3 QKV: TMA for both
    (512, 169, (True, False)),       # 1x1 GEMM forms: B through registers
    (128, 3025, (True, False)),
    (384, 729, (True, False)),
    (36, 40, (False, True)),
], ids=str)
def test_matmul_staging_route_is_a_shape_rule(k, n, want):
    assert geo.matmul_mma_route(k, n) == want


# ------------------------------------------------ the bf16 launch plan

QKV_O_DOWN = [(512, 9216, 3072), (512, 3072, 3072), (512, 3072, 8192)]


def _chunks_of(plan):
    """Every (tile, k chunk) the plan's walks sum, in walk order per
    tile, and the blocks that walk nothing."""
    seen = {}
    idle = 0
    for b in range(plan.grid):
        units = list(plan.walk(b))
        idle += not units
        for u in units:
            t, c0, c1, part = plan.unit(u)
            seen.setdefault(t, []).append((part, list(range(c0, c1))))
    return seen, idle


# (m, n, k) x (bm, bn, bk) where the blocks divide the dims
PLAN_CASES = [(mnk, blk) for mnk in QKV_O_DOWN + [(1000, 169, 512),
                                                  (64, 3025, 128)]
              for blk in [(128, 192, 64), (64, 192, 64), (128, 128, 32),
                          (64, 13, 64), (125, 13, 16), (64, 25, 32)]
              if all(d % b == 0 for d, b in zip(mnk, blk))]


@pytest.mark.parametrize("mnk,block", PLAN_CASES, ids=str)
@pytest.mark.parametrize("rmw", [False, True], ids=["scratch", "rmw"])
@pytest.mark.parametrize("rb", [132, 66, 33, 7, 1])
def test_matmul_plan_covers_each_chunk_once_in_order(mnk, block, rmw, rb):
    """Every k chunk of every tile is summed exactly once, a split
    tile's parts cover its chunks in order, the grid never exceeds the
    resident blocks the caller passes in, and a split only fills blocks
    the last wave leaves idle (its parts are one wave); for the whole k
    and for a read-modify-write pass of one k block."""
    m, n, k = mnk
    bm, bn, bk = block
    plan = geo.matmul_plan(m, n, k, bm, bn, bk,
                           k_count=bk if rmw else None, resident_blocks=rb)
    assert plan.error is None
    assert plan.grid <= rb
    assert plan.tiles == (m // bm) * (n // bn)
    seen, _ = _chunks_of(plan)
    assert sorted(seen) == list(range(plan.tiles))
    for parts in seen.values():
        parts.sort()
        assert [c for _, cs in parts for c in cs] == list(range(plan.chunks))
        assert [p for p, _ in parts] == (
            [-1] if len(parts) == 1 else list(range(plan.splits)))
    if rmw or k <= geo.MMA_PART_K:
        assert plan.tail_tiles * plan.splits <= plan.grid
    else:                 # every tile in parts of at most MMA_PART_K
        assert plan.full_tiles == 0
        assert max(c1 - c0 for c0, c1 in map(plan.split_range, range(
            plan.splits))) * geo.matmul_mma_tile(
                bm, bn, bk, k, False).ks <= geo.MMA_PART_K
    if plan.splits > 1:
        assert plan.full_tiles % plan.grid == 0
        assert 2 <= plan.splits <= plan.chunks
        assert plan.workspace_floats == (plan.tickets * plan.splits
                                         * plan.tile_floats)


@pytest.mark.parametrize("shape", ["qkv", "o", "down"])
def test_matmul_plan_splits_the_qkv_tail_and_the_small_grids(shape):
    """At 128 x 192 tiles on 132 resident blocks: QKV's 192 tiles are
    one full wave and the other 60 split in two over 120 of the 132
    blocks; O's 64 tiles fill 128 blocks in two parts each; down (k
    8192, 64-row tiles) sums every tile in two parts of 4096, whatever
    the idle blocks."""
    m, n, k, bm, want = {
        "qkv": (512, 9216, 3072, 128, (132, 132, 60, 2)),
        "o": (512, 3072, 3072, 128, (128, 0, 64, 2)),
        "down": (512, 3072, 8192, 64, (132, 0, 128, 2)),
    }[shape]
    plan = geo.matmul_plan(m, n, k, bm, 192, 64, resident_blocks=132)
    assert (plan.grid, plan.full_tiles, plan.tail_tiles,
            plan.splits) == want


@pytest.mark.parametrize("rb", [132, 66, 33, 7, 1])
def test_matmul_plan_resident_walks_contiguous_columns(rb):
    """A resident RHS: no split, and each block's units a contiguous
    run, m fastest, so it meets each column once; the runs cover every
    tile once, however many blocks the card holds."""
    plan = geo.matmul_plan(512, 9216, 3072, 128, 32, 3072,
                           resident_rhs=True, resident_blocks=rb)
    assert (plan.splits, plan.grid) == (1, rb)
    n_m = 512 // 128
    walked = []
    for b in range(plan.grid):
        cols = [u // n_m for u in plan.walk(b)]
        assert cols == sorted(cols)
        walked += list(plan.walk(b))
    assert walked == list(range(plan.tiles))


@pytest.mark.parametrize("args,kw,match", [
    ((512, 9216, 3072, 256, 192, 64), {}, "rows above 128"),
    ((512, 9216, 3072, 128, 300, 64), {}, "columns above 256"),
    ((512, 9216, 3072, 128, 64, 3072), {"resident_rhs": True},
     "shared memory"),
    ((512, 9216, 3072, 128, 192, 64), {"k_count": 96}, "must divide"),
    ((512, 9216, 3072, 128, 192, 64), {"resident_blocks": 0},
     "fits on the card"),
    ((512, 3072, 6144, 64, 16, 6144), {"resident_rhs": True},
     "in one part"),
], ids=["rows", "columns", "resident-smem", "k-count", "no-block",
        "resident-long-k"])
def test_matmul_plan_refuses_what_does_not_fit(args, kw, match):
    assert match in geo.matmul_plan(*args, **kw).error


@pytest.mark.parametrize("mnk", QKV_O_DOWN, ids=str)
@pytest.mark.parametrize("rb", [132, 264, 1000])
def test_matmul_plan_rmw_pass_is_never_split(mnk, rb):
    """A read-modify-write pass sums one k block: its chunks (one) cannot
    be split, whatever the idle blocks."""
    m, n, k = mnk
    plan = geo.matmul_plan(m, n, k, 128, 192, 64, k_count=64,
                           resident_blocks=rb)
    assert plan.chunks == 1 and plan.splits == 1
    assert plan.grid == min(rb, plan.tiles)


def test_matmul_timeline_marks_every_phase():
    """``launch/matmul_timeline.py`` builds the matmul with its consumer
    marks defined: every phase it names is marked in the bf16 body,
    between one begin and one end."""
    from repro_torch.launch.matmul_timeline import (PHASES,
                                                    instrumented_source)
    src, phases = instrumented_source()
    assert phases == PHASES
    body = src[src.index("matmul_mma_kernel(const __grid_constant__"):
               src.index("inline bool make_map(")]
    assert body.count("MM_T_BEGIN()") == 1 and body.count("MM_T_END()") == 1
    for k in range(len(PHASES)):
        assert f"MM_T_MARK({k})" in body, PHASES[k]


def test_matmul_timeline_parent_runs_its_own_wrapper_at_its_rank0():
    """``matmul_timeline --parent DIR`` (here the tree itself, imported
    beside it by ``launch/parent_tree.py``) ranks each shape with the
    parent's own tuner and calls the parent's own wrapper, which on the
    CPU runs its plain version."""
    from pathlib import Path
    from repro_torch.launch import matmul_timeline as mt
    root = Path(mt.__file__).resolve().parents[3]
    parent = mt.Parent(root)
    assert parent.tree.tuner is not tuner
    assert parent.tree.kernels.matmul is not matmul
    assert [label for label, _ in mt.SHAPES] == list(parent.rank0)
    for label, (m, n, k) in mt.SHAPES:
        s = tuner.tune_matmul(m, n, k, elem_bytes=2, top_k=1)[0][0]
        assert parent.rank0[label] == (s.block_dict(), tuple(s.grid_order),
                                       s.resident_rhs), label
    block, order, res = parent.rank0["fire9-conv1x1-1"]
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(64, 512, generator=g), torch.randn(512, 169,
                                                         generator=g)
    assert torch.equal(parent.call(a, b, block, order, res),
                       matmul_plain(a, b, block=block, grid_order=order,
                                    resident_rhs=res))


def test_conv_timeline_parent_runs_its_own_wrappers_at_its_rank0():
    """``conv_timeline --parent DIR`` (here the tree itself, imported
    beside it by ``launch/parent_tree.py``) ranks each layer with the
    parent's own tuner and calls the parent's own conv and block-sparse
    conv wrappers, the latter at the parent's own pixel rule (a function
    of the parent that imports a module of the package at call time gets
    the parent's module); on the CPU they run their plain versions."""
    from pathlib import Path
    from repro_torch.kernels import sparse_conv2d
    from repro_torch.kernels.sparse_conv import (analyze_weights,
                                                 sparse_conv_plain)
    from repro_torch.launch import conv_timeline as ct
    root = Path(ct.__file__).resolve().parents[3]
    parent = ct.Parent(root)
    assert parent.tree.tuner is not tuner
    assert parent.tree.kernels.conv2d is not conv2d
    assert parent.tree.kernels.sparse_conv2d is not sparse_conv2d
    layer = TABLE_4_1["fire9-conv3x3-2"]
    for n in (1, 32):
        s = tuner.tune_conv(layer, elem_bytes=2, top_k=1, batch=n)[0][0]
        assert parent.rank0(layer, n) == (s.block_dict(),
                                          tuple(s.grid_order))
    g = torch.Generator().manual_seed(0)
    img = torch.randn(1, 8, 7, 7, generator=g)
    wgt = torch.randn(16, 8, 3, 3, generator=g)
    wgt[8:, :4] = 0.0
    blk, order = {"oc": 8, "ic": 4, "y": 5, "x": 5}, ("oc", "y", "x", "ic")
    assert torch.equal(parent.conv(img, wgt, blk, order),
                       conv2d_plain(img, wgt, block=blk, grid_order=order))
    skip = {"oc": 8, "ic": 4}
    sp = analyze_weights(wgt, skip)
    assert torch.equal(parent.sparse_fn(img, wgt, skip)(),
                       sparse_conv_plain(img, wgt, sp.idx, sp.counts, skip))
    import repro_torch.core.sparsity as mine

    def refuse(*args):
        raise AssertionError("the parent called this tree's pixel rule")

    pick = parent.tree.sparse.ops._pixel_tile.__wrapped__
    want = parent.tree.sparsity.sparse_pixel_tile(layer, 32, 16, 32)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(mine, "sparse_pixel_tile", refuse)
        assert pick(layer, 32, 16, 32) == want
    assert parent.sparse_blocks(ConvLayer(128, 128, 25, 25, 3, 3), 0.25,
                                32) == [
        b.block_dict() for b, _ in tuner.tune_sparse_conv(
            ConvLayer(128, 128, 25, 25, 3, 3), 0.25, elem_bytes=2,
            top_k=1000, batch=32)]


def test_layouts_follow_the_dtype():
    assert geo.tensor_cores(2) and not geo.tensor_cores(4)
    assert isinstance(geo.conv_layout(16, 16, 4, 4, 3, 3, 2),
                      geo.ConvMmaTile)
    assert isinstance(geo.conv_layout(16, 16, 4, 4, 3, 3, 4), geo.ConvTile)
    assert isinstance(geo.matmul_layout(64, 64, 32, 64, 2, False),
                      geo.MatmulMmaTile)
    assert isinstance(geo.matmul_layout(64, 64, 32, 64, 4, False),
                      geo.MatmulTile)


# ------------------------------------------------------ cost model, tuner

def test_bf16_qkv_rank0_lies_between_the_two_units_bounds():
    """The rank-0 bf16 QKV schedule is predicted slower than the
    tensor-core bound and faster than the CUDA-core floor."""
    m, n, k = QKV
    s, c = tuner.tune_matmul(m, n, k, elem_bytes=2, top_k=1)[0]
    tc_bound = 2 * m * n * k / 989e12
    cuda_core_floor = 2 * m * n * k / 67e12
    assert tc_bound < c.time_s < cuda_core_floor
    t = geo.matmul_mma_tile(*(s.block_dict()[x] for x in "mnk"), k,
                            s.resident_rhs)
    assert t.error is None


def test_float32_keeps_the_cuda_core_model():
    """float32 schedules are timed on the CUDA cores: the QKV rank-0 in
    float32 is predicted above the fp32 FMA floor."""
    m, n, k = QKV
    _, c = tuner.tune_matmul(m, n, k, elem_bytes=4, top_k=1)[0]
    assert c.time_s > 2 * m * n * k / 67e12


@pytest.mark.parametrize("name", list(TABLE_4_1))
def test_every_bf16_conv_candidate_is_timed(name):
    layer = TABLE_4_1[name]
    blocks = tuner.conv_blocks(layer, 2)
    assert blocks
    batch = cm.conv_schedule_cost_batch(layer, [("oc", "y", "x", "ic")],
                                        blocks)
    assert np.isfinite(batch.time_s).all() and batch.feasible.all()
    assert (batch.compute_s > 0).all()


@pytest.mark.parametrize("more,less,pad", [
    # a 1 x 13 pixel tile pads 13 rows to 64, a 13 x 13 one 169 to 192
    ({"oc": 50, "ic": 32, "y": 1, "x": 13},
     {"oc": 50, "ic": 32, "y": 13, "x": 13}, (64 / 13) / (192 / 169)),
    # 100 output channels pad to 128, 125 to 128
    ({"oc": 100, "ic": 32, "y": 13, "x": 13},
     {"oc": 125, "ic": 32, "y": 13, "x": 13}, (128 / 100) / (128 / 125)),
], ids=["pixels", "channels"])
def test_bf16_conv_charges_the_mma_padding(more, less, pad,
                                          monkeypatch):
    """With load latency, staging (cp.async and channels-last units,
    steps, the epilogue), memory and shared-memory traffic made free,
    conv-final's time is its padded MMA work: the tile that pads more
    costs at least the padding's ratio more, and at most 10% past it."""
    layer = TABLE_4_1["conv-final"]
    monkeypatch.setattr(cm, "LOAD_LATENCY_S", 0.0)
    monkeypatch.setattr(cm, "UNIT_CYCLES", 0.0)
    monkeypatch.setattr(cm, "CHUNK_CYCLES", 0.0)
    monkeypatch.setattr(cm, "STEP_CYCLES", 0.0)
    monkeypatch.setattr(cm, "EPI_CYCLES", 0.0)
    # one SM: its blocks run in turn, so no partly filled last wave of
    # either tile stands between the times and the padding
    free = dataclasses.replace(cm.H100Spec(), sms=1, launch_s=0.0,
                               l2_bw=1e30, hbm_bw=1e30,
                               smem_read_bytes=10 ** 9)
    t = cm.conv_schedule_cost_batch(layer, [("oc", "y", "x", "ic")],
                                    [more, less], free, batch=4096).time_s[0]
    assert pad * (1 - 1e-9) <= t[0] / t[1] <= pad * 1.1


def test_registry_record_of_h100_1_is_not_returned_under_h100_2(
        tmp_path, monkeypatch):
    """Rankings cached by the CUDA-core-only model (``h100-1``) miss
    under the current model (``h100-6`` since the bf16 conv body was
    redesigned, ``h100-7`` since the bf16 matmul body was redesigned,
    ``h100-8`` since flash has one bf16 body at the models' head dims,
    ``h100-9`` since the bf16 conv body runs on wgmma;
    ``h100-5`` when flash attention and the decode gained
    their second bodies; ``h100-4`` when the serving kernels joined it;
    ``h100-3`` when the bf16 sparse conv moved to the tensor cores): the
    tuner ranks anew."""
    assert cm.COST_MODEL_VERSION == "h100-9"
    path = str(tmp_path / "t.jsonl")
    layer = TABLE_4_1["fire9-conv3x3-2"]
    monkeypatch.setattr(cm, "COST_MODEL_VERSION", "h100-1")
    tuner.cached_tune_conv(layer, registry=reg.TuningRegistry(path))
    old_key = reg.conv_schedule_key(layer, cm.H100Spec())
    monkeypatch.undo()
    fresh = reg.TuningRegistry(path)
    assert fresh.get(old_key) is not None
    new_key = reg.conv_schedule_key(layer, cm.H100Spec())
    assert new_key.cost_model == "h100-9" and fresh.get(new_key) is None
    before = cm.total_evals()
    tuner.cached_tune_conv(layer, registry=fresh)
    assert cm.total_evals() > before


def test_conv_timeline_marks_every_phase():
    """``launch/conv_timeline.py`` builds the conv body with its phase
    marks defined: every phase it names is marked in ``conv_mma.cuh``,
    between one begin and one end, and each ``--without`` edit finds its
    text, so a kernel edit that moves one fails here rather than on the
    card."""
    from repro_torch.launch.conv_timeline import (ABLATIONS, PHASES,
                                                  instrumented_source)
    src, phases = instrumented_source()
    assert phases == PHASES
    body = src[src.index("conv_mma_kernel(const ConvMmaArgs a) {"):
               src.index("inline long long conv_mma_layout(")]
    assert body.count("CM_T_BEGIN()") == 1 and body.count("CM_T_END()") == 1
    for k in range(len(PHASES)):
        assert f"CM_T_MARK({k})" in body, PHASES[k]
    for without in ABLATIONS:        # each ablation's anchor is found once
        assert instrumented_source(without)[0] != src


@pytest.mark.parametrize("kind", ["conv", "sparse_conv"])
def test_registry_record_of_h100_5_is_not_returned_under_h100_6(
        tmp_path, monkeypatch, kind):
    """Rankings cached before the bf16 conv body's redesign (``h100-5``:
    the old body's staging and its blocks) miss under the current model
    (``h100-6``, then ``h100-7``), for the dense and the block-sparse
    conv: the tuner ranks anew."""
    path = str(tmp_path / "t.jsonl")
    layer = TABLE_4_1["fire9-conv3x3-2"]

    def tune(registry):
        if kind == "conv":
            return tuner.cached_tune_conv(layer, registry=registry, batch=32)
        return tuner.cached_tune_sparse_conv(layer, 0.25, registry=registry,
                                             batch=32)

    monkeypatch.setattr(cm, "COST_MODEL_VERSION", "h100-5")
    tune(reg.TuningRegistry(path))
    assert len(reg.TuningRegistry(path)) == 1
    monkeypatch.undo()
    fresh = reg.TuningRegistry(path)
    before = cm.total_evals()
    tune(fresh)
    assert cm.total_evals() > before
    versions = {r.key.cost_model for r in fresh.records()}
    assert versions == {"h100-5", cm.COST_MODEL_VERSION}


def test_matmul_record_of_h100_6_is_not_returned_under_h100_7(tmp_path,
                                                               monkeypatch):
    """A matmul ranking cached before the persistent bf16 body (``h100-6``:
    one block a tile, no tail split) misses under ``h100-7`` and the
    versions after it: the tuner ranks anew, and both records stay in
    the registry."""
    path = str(tmp_path / "t.jsonl")
    m, n, k = QKV
    monkeypatch.setattr(cm, "COST_MODEL_VERSION", "h100-6")
    tuner.cached_tune_matmul(m, n, k, registry=reg.TuningRegistry(path))
    monkeypatch.undo()
    fresh = reg.TuningRegistry(path)
    before = cm.total_evals()
    tuner.cached_tune_matmul(m, n, k, registry=fresh)
    assert cm.total_evals() > before
    assert {r.key.cost_model for r in fresh.records()} == {
        "h100-6", cm.COST_MODEL_VERSION}


def test_qkv_rank0_takes_m_fastest():
    """The tuner breaks the model's tie between m and n fastest toward m
    (QKV's B outgrows the L2), and the plan of its rank-0 splits the
    last wave."""
    m, n, k = QKV
    s, _ = tuner.tune_matmul(m, n, k, elem_bytes=2, top_k=1)[0]
    assert tuple(s.grid_order) == ("n", "m", "k") and not s.resident_rhs
    b = s.block_dict()
    plan = geo.matmul_plan(m, n, k, b["m"], b["n"], b["k"],
                           resident_blocks=132)
    assert plan.error is None and plan.splits > 1


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_sparse_side_does_not_follow_the_dense_model(monkeypatch, dtype):
    """bf16: the sparse estimate follows the dense tensor-core model at
    the nonzero blocks (both bodies are the implicit GEMM), so slowing
    the tensor-core constants slows both sides, and at full density the
    sparse side is the dense scratch launch at the sparse pixel tile plus
    its index row's round trip and its call time.  float32: the sparse
    estimate is the CUDA-core sparse body's own model: the tensor-core
    constants move neither side, its channel constant moves only it."""
    layer = ConvLayer(128, 128, 25, 25, 3, 3)
    block = {"oc": 16, "ic": 16}
    spec = cm.H100Spec()
    eb = 2 if dtype == "bfloat16" else 4
    densities = (0.25, 1.0) if eb == 2 else (0.0, 0.25, 1.0)
    before = [sparsity.choose_algorithm(layer, block, d, spec=spec,
                                        elem_bytes=eb) for d in densities]
    for density, a in zip(densities, before):
        want = cm.sparse_conv_schedule_cost_batch(layer, [block], density,
                                                  1, spec, eb).cost(0)
        assert a.sparse_time_s == pytest.approx(
            max(want.compute_s, want.memory_s) + want.overhead_s)
    if eb == 2:
        by, bx = sparsity.sparse_pixel_tile(layer, 16, 16)
        arr = lambda v: np.array([v])  # noqa: E731
        dense = cm._conv_mma_seconds(layer, arr(by), arr(bx), arr(16),
                                     arr(16), spec)[0][0]
        sparse = cm.sparse_conv_schedule_cost_batch(layer, [block], 1.0, 1,
                                                    spec).cost(0)
        # one tile wave: the index row adds its round trip to the latency
        assert sparse.compute_s == pytest.approx(dense + cm.LOAD_LATENCY_S)
        assert sparse.overhead_s == pytest.approx(spec.launch_s
                                                  + cm.SPARSE_CALL_S)
    monkeypatch.setattr(cm, "LOAD_LATENCY_S", 4 * cm.LOAD_LATENCY_S)
    monkeypatch.setattr(cm, "UNIT_CYCLES", 4 * cm.UNIT_CYCLES)
    slow = dataclasses.replace(spec, tc_peak_flops=spec.tc_peak_flops / 4)
    after = [sparsity.choose_algorithm(layer, block, d, spec=slow,
                                       elem_bytes=eb) for d in densities]
    for a, b in zip(before, after):
        if eb == 2:
            assert b.dense_time_s > a.dense_time_s
            assert b.sparse_time_s > a.sparse_time_s
        else:
            assert b.dense_time_s == a.dense_time_s
            assert b.sparse_time_s == a.sparse_time_s
    if eb == 4:
        monkeypatch.setattr(cm, "SPARSE_CHANNEL_S", 4 * cm.SPARSE_CHANNEL_S)
        for d, a in zip(densities, before):
            b = sparsity.choose_algorithm(layer, block, d, spec=spec,
                                          elem_bytes=eb)
            assert b.dense_time_s == a.dense_time_s
            assert b.sparse_time_s > a.sparse_time_s


SPARSE_LAYERS = {"fig6.2": ConvLayer(128, 128, 25, 25, 3, 3),
                 **{n: l for n, l in TABLE_4_1.items() if l.kh == 3}}


@pytest.mark.parametrize("batch", [1, 32])
@pytest.mark.parametrize("name", list(SPARSE_LAYERS))
def test_sparse_pixel_tile_divides_the_image(name, batch):
    """bf16: for every skip block the tuner offers, the pixel tile is the
    dense conv model's cheapest for that (oc, ic) at the batch, divides H
    and W (the tensor-core body takes no ragged edge), and fits the
    sparse layout with the oc block's index row."""
    layer = SPARSE_LAYERS[name]
    blocks = tuner.sparse_blocks(layer, 2)
    assert blocks
    for blk in blocks:
        by, bx = sparsity.sparse_pixel_tile(layer, blk["oc"], blk["ic"], batch)
        assert layer.h % by == 0 and layer.w % bx == 0
        dense = sparsity._dense_block(layer, blk, ("oc", "y", "x", "ic"),
                                      cm.H100Spec(), 2, batch)
        assert (dense["y"], dense["x"]) == (by, bx)
        n_ic = layer.ic // blk["ic"]
        problem = dict(oc=layer.oc, ic=layer.ic, h=layer.h, w=layer.w,
                       batch=batch)
        tile = geo.sparse_layout(blk["oc"], blk["ic"], by, bx, layer.kh,
                                 layer.kw, n_ic, 2, **problem)
        assert tile.error is None
        # the dense tile in the order (oc, y, x), its resident weights
        # every ic block, and the index row after the ring
        assert tile == geo.conv_mma_tile(
            blk["oc"], blk["ic"], by, bx, layer.kh, layer.kw, **problem,
            order=("oc", "y", "x"), n_fixed=n_ic,
            extra=-(-4 * n_ic // 16) * 16)


def _fig62_weights(density=0.25, seed=0):
    """Fig 6.2's layer's weights zeroed at 16 x 16 blocks where a uniform
    draw is >= ``density``."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((128, 128, 3, 3)).astype(np.float32)
    drop = rng.random((8, 8)) >= density
    for o, i in zip(*np.nonzero(drop)):
        w[o * 16:(o + 1) * 16, i * 16:(i + 1) * 16] = 0.0
    return torch.from_numpy(w)


def test_sparse_tuner_scores_each_block_at_the_weights_structure():
    """Given the weights, the sparse tuner scores each skip block at the
    block density and busiest oc block that ``analyze_weights`` finds at
    that block, not at one density for every granularity: a structure
    zeroed at 16 x 16 leaves at least as large a share of every coarser
    block nonzero."""
    from repro_torch.kernels.sparse_conv import analyze_weights
    layer = ConvLayer(128, 128, 25, 25, 3, 3)
    w = _fig62_weights()
    blocks = tuner.sparse_blocks(layer, 2)
    dens, busiest = sparsity.block_structure(w, blocks)
    fine = analyze_weights(w, {"oc": 16, "ic": 16}).density
    for j, blk in enumerate(blocks):
        sp = analyze_weights(w, blk)
        assert dens[j] == pytest.approx(sp.density)
        assert busiest[j] == sp.counts.max()
        assert dens[j] >= fine - 1e-12
    assert max(dens) > fine
    want = cm.sparse_conv_schedule_cost_batch(layer, blocks, dens, 32,
                                              busiest=busiest).time_s
    ranked = tuner.tune_sparse_conv(layer, 0.25, batch=32,
                                    top_k=len(blocks), weights=w)
    assert len(ranked) == len(blocks)
    for s, c in ranked:
        j = blocks.index(s.block_dict())
        assert c.time_s == pytest.approx(want[j], rel=1e-12)
    assert [c.time_s for _, c in ranked] == sorted(c.time_s
                                                   for _, c in ranked)


@pytest.mark.parametrize("batch", [1, 32])
def test_sparse_cost_charges_the_busiest_oc_block(batch):
    """At the same block density, an oc block with more nonzero channel
    blocks than the mean lengthens the bf16 sparse launch by its excess
    (it runs on one SM), and one at the mean costs what the density
    alone says."""
    layer = ConvLayer(128, 128, 25, 25, 3, 3)
    blk = {"oc": 32, "ic": 16}
    even = cm.sparse_conv_schedule_cost_batch(layer, [blk], 0.5, batch)
    # 0.5 of 8 channel blocks: 4 a block on average
    at_mean = cm.sparse_conv_schedule_cost_batch(layer, [blk], 0.5, batch,
                                                 busiest=[4])
    busy = cm.sparse_conv_schedule_cost_batch(layer, [blk], 0.5, batch,
                                              busiest=[8])
    assert at_mean.time_s[0] == pytest.approx(even.time_s[0], rel=0.05)
    assert busy.time_s[0] > at_mean.time_s[0]
    assert (busy.hbm_bytes == even.hbm_bytes).all()


def test_sparse_structure_keeps_its_device_index():
    """The block index is copied to a device once per structure: a second
    call on the same device gets the same tensors, another structure
    (equal or not) its own, and the copies take no part in equality."""
    from repro_torch.kernels.sparse_conv import analyze_weights
    w = torch.from_numpy(_np((32, 32, 3, 3), 5))
    w[:16, 16:] = 0
    sp = analyze_weights(w, {"oc": 16, "ic": 16})
    cpu = torch.device("cpu")
    idx, counts = sp.device_index(cpu)
    assert idx.dtype == counts.dtype == torch.int32
    assert idx.tolist() == sp.idx.tolist()
    assert counts.tolist() == sp.counts.tolist() == [1, 2]
    again = sp.device_index(cpu)
    assert again[0] is idx and again[1] is counts
    twin = analyze_weights(w, {"oc": 16, "ic": 16})
    assert twin.device_index(cpu)[0] is not idx
    assert twin.block == sp.block and twin.density == sp.density
    assert repr(twin) == repr(sp)


def test_crossover_is_zero_when_sparse_never_wins_and_one_when_it_always_does(
        monkeypatch):
    layer = ConvLayer(128, 128, 25, 25, 3, 3)
    block = {"oc": 16, "ic": 16}
    spec = cm.H100Spec()
    monkeypatch.setattr(cm, "LOAD_LATENCY_S", 1e-12)
    monkeypatch.setattr(cm, "UNIT_CYCLES", 1e-6)
    fast_dense = dataclasses.replace(spec, launch_s=0.0)
    assert sparsity.crossover_density(layer, block, imbalance=1e6,
                                      spec=fast_dense) == 0.0
    monkeypatch.undo()
    # the bf16 sparse side runs the dense body too, so only its
    # imbalance (a straggler-free structure) can make it win everywhere
    monkeypatch.setattr(cm, "LOAD_LATENCY_S", 1e-3)
    assert sparsity.crossover_density(layer, block, imbalance=1e-6,
                                      spec=spec) == 1.0


def _sparse_lines(ms_of, dtype="bfloat16"):
    """Calibration lines of the sparse body on the Fig 6.2 layer, timed
    ``ms_of(layer, block, density, batch)``."""
    layer = ConvLayer(128, 128, 25, 25, 3, 3)
    return [{"kind": "sparse_conv", "layer": "fig6.2-128x128-25x25",
             "batch": n, "block": blk, "density": d, "block_density": d,
             "dtype": dtype, "ms": ms_of(layer, blk, d, n)}
            for blk in ({"oc": 16, "ic": 16}, {"oc": 32, "ic": 16})
            for d in (0.0, 0.25, 0.5, 1.0) for n in (1, 32)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_sparse_fit_recovers_the_constants(monkeypatch, dtype):
    """The least-squares fit returns the constants that made the times:
    bf16 the call time alone (the tensor-core body's model has no other
    sparse constant), float32 the call time and the channel time."""
    calibrate = pytest.importorskip("repro_torch.launch.calibrate_thesis")
    launch = cm.H100Spec().launch_s
    if dtype == "bfloat16":
        def ms_of(layer, blk, d, n):
            with monkeypatch.context() as m:
                m.setattr(cm, "SPARSE_CALL_S", 8e-5)
                return float(cm.sparse_conv_schedule_cost_batch(
                    layer, [blk], d, n).time_s[0]) * 1e3

        fit = calibrate.sparse_fit(_sparse_lines(ms_of))
        assert fit.keys() == {"SPARSE_CALL_S"}
    else:
        def ms_of(layer, blk, d, n):
            work = cm.sparse_channel_waves(layer, [blk], d, n,
                                           elem_bytes=4)[0]
            return (launch + 8e-5 + 3e-6 * work) * 1e3

        fit = calibrate.sparse_fit(_sparse_lines(ms_of, dtype))
        assert fit["SPARSE_CHANNEL_S"] == pytest.approx(3e-6, rel=1e-6)
    assert fit["SPARSE_CALL_S"] == pytest.approx(8e-5, rel=1e-6)


def test_conv_fit_varies_a_spec_and_leaves_the_module(monkeypatch):
    """The conv body's coordinate search passes its trial constants in a
    spec of its own (``H100Spec.conv_body``): on lines timed with the
    epilogue's constant doubled, the spec holding those constants times
    them exactly, the search lowers the error its start (the module's
    constants) has, and the module's constants, which a spec without
    ``conv_body`` reads at each call, are the same after it."""
    calibrate = pytest.importorskip("repro_torch.launch.calibrate_thesis")
    fitted = cm.ConvBodyConsts.fitted()
    true = dataclasses.replace(fitted, epi_cycles=2 * fitted.epi_cycles)
    spec = dataclasses.replace(cm.H100Spec(), conv_body=true)
    lines = []
    for name in ("fire4-conv1x1-2", "fire9-conv3x3-2"):
        layer = TABLE_4_1[name]
        for blk in tuner.conv_blocks(layer, 2)[::7][:4]:
            for n in (1, 32):
                t = cm.conv_schedule_cost_batch(
                    layer, [("oc", "y", "x", "ic")], [blk], spec,
                    batch=n).time_s[0, 0]
                lines.append({"kind": "conv2d", "layer": name, "batch": n,
                              "block": blk, "order": "oyxi",
                              "ms": t * 1e3})
    assert [calibrate._predict_ms(r, spec) for r in lines] == \
        pytest.approx([r["ms"] for r in lines])
    meas = np.log([r["ms"] for r in lines])
    start = float(np.mean((np.log([calibrate._predict_ms(r) for r in lines])
                           - meas) ** 2))
    consts, err = calibrate.conv_fit(lines, rounds=1)
    assert consts.keys() == set(calibrate.CONV_CONSTS)
    assert start > 0 and err < start / 2
    assert cm.ConvBodyConsts.fitted() == fitted
    # the module's constants are read at each call
    monkeypatch.setattr(cm, "EPI_CYCLES", true.epi_cycles)
    assert cm.ConvBodyConsts.fitted() == true


def test_score_reports_each_kind(tmp_path, capsys):
    """``--score`` reads calibration lines and reports every kind: lines
    timed at the model's own predictions score a zero error."""
    calibrate = pytest.importorskip("repro_torch.launch.calibrate_thesis")
    layer = TABLE_4_1["fire9-conv3x3-2"]
    lines = _sparse_lines(lambda l, blk, d, n: float(
        cm.sparse_conv_schedule_cost_batch(l, [blk], d, n).time_s[0]) * 1e3)
    for blk in tuner.conv_blocks(layer, 2)[:3]:
        t = cm.conv_schedule_cost_batch(layer, [("oc", "y", "x", "ic")],
                                        [blk]).time_s[0, 0]
        lines.append({"kind": "conv2d", "layer": "fire9-conv3x3-2",
                      "batch": 1, "block": blk, "order": "oyxi",
                      "ms": t * 1e3})
    path = tmp_path / "cal.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in lines))
    calibrate.main(["--score", str(path)])
    out = capsys.readouterr().out
    for kind in ("conv2d", "sparse_conv"):
        assert f"[score] kind={kind} lines=" in out
        assert "mse 0.0000" in out.split(f"kind={kind} lines=")[1]
    assert "least_squares" in out


# ------------------------------------------ parity at the padding blocks

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("oc,ic,hw,k,block,order", [
    (80, 16, 13, 1, {"oc": 40, "ic": 8, "y": 13, "x": 13},
     ("oc", "y", "x", "ic")),
    (80, 16, 13, 1, {"oc": 40, "ic": 8, "y": 1, "x": 13},
     ("ic", "oc", "y", "x")),
    (16, 16, 11, 3, {"oc": 16, "ic": 8, "y": 11, "x": 11},
     ("ic", "y", "x", "oc")),
    (125, 8, 13, 1, {"oc": 125, "ic": 8, "y": 1, "x": 13},
     ("oc", "x", "y", "ic")),
], ids=lambda x: str(x) if not isinstance(x, dict) else
    "-".join(str(v) for v in x.values()))
def test_conv2d_matches_pallas_at_padding_blocks(oc, ic, hw, k, block, order,
                                                 dtype):
    img_t, img_j = _pair(_np((1, ic, hw + k - 1, hw + k - 1), 11), dtype)
    wgt_t, wgt_j = _pair(_np((oc, ic, k, k), 12, (ic * k * k) ** -0.5),
                         dtype)
    got = conv2d(img_t, wgt_t, block=block, grid_order=order)
    want = _from_jax(conv2d_pallas(img_j, wgt_j, block=block,
                                   grid_order=order))
    _, peak = conv2d_plain(img_t, wgt_t, block=block, grid_order=order,
                           with_peak=True)
    _assert_close(got, want, peak)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mnk,block,order,resident", [
    ((250, 169, 64), {"m": 125, "n": 13, "k": 16}, "mnk", False),
    ((250, 169, 64), {"m": 125, "n": 169, "k": 32}, "kmn", False),
    ((100, 26, 48), {"m": 100, "n": 13, "k": 48}, "nkm", True),
    ((48, 81, 48), {"m": 48, "n": 81, "k": 24}, "mkn", False),
], ids=str)
def test_matmul_matches_pallas_at_padding_blocks(mnk, block, order,
                                                 resident, dtype):
    m, n, k = mnk
    a_t, a_j = _pair(_np((m, k), 13), dtype)
    b_t, b_j = _pair(_np((k, n), 14, k ** -0.5), dtype)
    got = matmul(a_t, b_t, block=block, grid_order=tuple(order),
                 resident_rhs=resident)
    want = _from_jax(matmul_pallas(a_j, b_j, block=block,
                                   grid_order=tuple(order),
                                   resident_rhs=resident))
    _, peak = matmul_plain(a_t, b_t, block=block, grid_order=tuple(order),
                           resident_rhs=resident, with_peak=True)
    _assert_close(got, want, peak)


def test_conv_ranking_depends_on_the_batch(tmp_path):
    """The tensor-core conv is ranked for the caller's batch: a batch of
    32 fills the SMs with fewer, larger tiles than one image wants, and
    each batch has its own registry record."""
    layer = TABLE_4_1["fire4-conv1x1-1"]

    def pixels(s):
        return s.block_dict()["y"] * s.block_dict()["x"]

    one = tuner.tune_conv(layer, top_k=1, batch=1)[0][0]
    many = tuner.tune_conv(layer, top_k=1, batch=32)[0][0]
    assert pixels(many) > pixels(one)
    spec = cm.H100Spec()
    k1 = reg.conv_schedule_key(layer, spec, 2, 1)
    k32 = reg.conv_schedule_key(layer, spec, 2, 32)
    assert k1.canonical() != k32.canonical()
    r = reg.TuningRegistry(str(tmp_path / "t.jsonl"))
    tuner.cached_tune_conv(layer, registry=r, batch=32)
    assert r.get(k32) is not None and r.get(k1) is None


def test_dispatched_conv_slot_holds_the_batch():
    from repro_torch.kernels.conv2d import conv2d_dispatched
    from repro_torch.runtime.dispatch import DispatchService
    svc = DispatchService(reg.TuningRegistry(None), device="cpu")
    img = torch.from_numpy(_np((2, 8, 10, 10), 15))
    wgt = torch.from_numpy(_np((16, 8, 3, 3), 16, 1 / 8.5))
    conv2d_dispatched(img, wgt, service=svc)
    (entry,) = svc.report().values()
    assert entry["problem"]["n"] == 2
