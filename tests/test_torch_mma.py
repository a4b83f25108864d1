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
from repro_torch.kernels.conv2d import conv2d_plain  # noqa: E402
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

@pytest.mark.parametrize("block,kernel,want", [
    # (boc, bic, by, bx), (kh, kw), (p16, boc16, bic_pad, warps, rounds)
    ((40, 64, 13, 13), (1, 1), (176, 48, 64, 12, 1)),
    ((125, 16, 1, 13), (1, 1), (16, 128, 16, 4, 1)),
    ((200, 16, 1, 13), (1, 1), (16, 208, 16, 7, 1)),
    ((64, 8, 5, 11), (3, 3), (64, 64, 16, 4, 1)),
    ((128, 32, 11, 11), (1, 1), (128, 128, 32, 16, 1)),
    ((128, 16, 13, 13), (3, 3), (176, 128, 16, 16, 2)),
    ((13, 1, 1, 1), (1, 1), (16, 16, 16, 1, 1)),
], ids=str)
def test_conv_mma_layout_pads_to_the_mma_shape(block, kernel, want):
    """Pixels, oc and ic pad to 16; 32 x 32 warp tiles, at most 16
    warps, rounds past that; every such tile fits."""
    t = geo.conv_mma_tile(*block, *kernel)
    assert (t.p16, t.boc16, t.bic_pad, t.warps, t.rounds) == want
    assert t.error is None and t.threads == 32 * t.warps


@pytest.mark.parametrize("block,kernel", [
    ((256, 64, 13, 13), (3, 3)),
    ((40, 512, 13, 13), (1, 1)),
], ids=str)
def test_conv_mma_layout_refuses_what_does_not_fit(block, kernel):
    assert "shared memory" in geo.conv_mma_tile(*block, *kernel).error


@pytest.mark.parametrize("bm,bn,bk,k,resident,want", [
    # -> (bm_pad, bn_pad, ks, stages)
    (128, 128, 64, 3072, False, (128, 128, 64, 4)),
    (128, 256, 64, 3072, False, (128, 256, 64, 4)),
    (125, 13, 16, 512, False, (128, 16, 16, 4)),
    (125, 169, 128, 512, False, (128, 192, 64, 4)),
    (48, 243, 48, 384, False, (64, 256, 64, 4)),
    (64, 96, 32, 3072, False, (64, 96, 32, 4)),
    (128, 32, 3072, 3072, True, (128, 32, 64, 2)),
    (100, 13, 32, 512, True, (128, 16, 32, 4)),
], ids=str)
def test_matmul_mma_layout_pads_to_the_wgmma_shape(bm, bn, bk, k,
                                                   resident, want):
    t = geo.matmul_mma_tile(bm, bn, bk, k, resident)
    assert (t.bm_pad, t.bn_pad, t.ks, t.stages) == want
    assert t.error is None and t.smem <= geo.SMEM_BYTES
    assert t.threads == 128 * (t.bm_pad // 64 + 1)


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
    # a 1 x 13 pixel tile pads 13 rows to 16, a 13 x 13 one 169 to 176
    ({"oc": 50, "ic": 32, "y": 1, "x": 13},
     {"oc": 50, "ic": 32, "y": 13, "x": 13}, (16 / 13) / (176 / 169)),
    # 100 output channels pad to 112, 125 to 128
    ({"oc": 100, "ic": 32, "y": 13, "x": 13},
     {"oc": 125, "ic": 32, "y": 13, "x": 13}, (112 / 100) / (128 / 125)),
], ids=["pixels", "channels"])
def test_bf16_conv_charges_the_mma_padding(more, less, pad,
                                          monkeypatch):
    """With load latency, staging units and steps, memory and
    shared-memory reads made free, conv-final's time is its padded MMA work plus each
    block's zeroing of its stages (more blocks for the tile that pads
    more): that tile costs at least the padding's ratio more, and the
    zeroing adds under 10%."""
    layer = TABLE_4_1["conv-final"]
    monkeypatch.setattr(cm, "LOAD_LATENCY_S", 1e-15)
    monkeypatch.setattr(cm, "UNIT_CYCLES", 0.0)
    monkeypatch.setattr(cm, "STEP_CYCLES", 0.0)
    free = dataclasses.replace(cm.H100Spec(), launch_s=0.0, l2_bw=1e30,
                               hbm_bw=1e30, smem_read_bytes=10 ** 9)
    t = cm.conv_schedule_cost_batch(layer, [("oc", "y", "x", "ic")],
                                    [more, less], free, batch=4096).time_s[0]
    assert pad * (1 - 1e-9) <= t[0] / t[1] <= pad * 1.1


def test_registry_record_of_h100_1_is_not_returned_under_h100_2(
        tmp_path, monkeypatch):
    """Rankings cached by the CUDA-core-only model (``h100-1``) miss
    under the current model (``h100-4`` since the serving kernels joined
    it; ``h100-3`` when the bf16 sparse conv moved to the tensor cores):
    the tuner ranks anew."""
    assert cm.COST_MODEL_VERSION == "h100-4"
    path = str(tmp_path / "t.jsonl")
    layer = TABLE_4_1["fire9-conv3x3-2"]
    monkeypatch.setattr(cm, "COST_MODEL_VERSION", "h100-1")
    tuner.cached_tune_conv(layer, registry=reg.TuningRegistry(path))
    old_key = reg.conv_schedule_key(layer, cm.H100Spec())
    monkeypatch.undo()
    fresh = reg.TuningRegistry(path)
    assert fresh.get(old_key) is not None
    new_key = reg.conv_schedule_key(layer, cm.H100Spec())
    assert new_key.cost_model == "h100-4" and fresh.get(new_key) is None
    before = cm.total_evals()
    tuner.cached_tune_conv(layer, registry=fresh)
    assert cm.total_evals() > before


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
        tile = geo.sparse_layout(blk["oc"], blk["ic"], by, bx, layer.kh,
                                 layer.kw, n_ic, 2)
        assert tile.error is None
        assert tile.smem == geo.conv_mma_tile(
            blk["oc"], blk["ic"], by, bx, layer.kh, layer.kw).smem \
            + -(-4 * n_ic // 16) * 16


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
