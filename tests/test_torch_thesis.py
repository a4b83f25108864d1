"""The thesis path of the port (conv2d, matmul, sparse conv, the H100
tuning layer and the dispatch service) against the JAX package, on the
CPU.

Inputs are made with numpy from a seed and handed to both packages.  The
JAX kernels run as the JAX tests run them (Pallas in interpret mode);
the port runs on CPU tensors, where every wrapper runs its plain
version at the kernel's rounding points.

Tolerances, per element: float32 atol 1e-5 (the same sums in another
order); bf16 two bf16 ulps + 1e-5 of the largest magnitude the element
takes at a rounding point (the final value for a scratch schedule; for
a read-modify-write schedule also each intermediate rounding, where a
float32 sum in another order may round to the other neighbour).  Which
reference each test holds the port to is named in the test: the JAX
kernel (output in the input's type) or the JAX ``*_ref`` oracle
(float32 out).
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from repro.core import cost_model as jcm  # noqa: E402
from repro.core.loopnest import ConvLayer as JConvLayer  # noqa: E402
from repro.kernels.conv2d import conv2d_pallas, conv2d_ref  # noqa: E402
from repro.kernels.matmul import matmul_pallas, matmul_ref  # noqa: E402
from repro.kernels.sparse_conv import (  # noqa: E402
    analyze_weights as j_analyze, build_block_index as j_build_index,
    sparse_conv2d_pallas, sparse_conv_ref)
from repro_torch.configs.squeezenet_layers import TABLE_4_1  # noqa: E402
from repro_torch.core import cost_model as cm  # noqa: E402
from repro_torch.core import registry as reg  # noqa: E402
from repro_torch.core import sparsity, tuner  # noqa: E402
from repro_torch.core.loopnest import ConvLayer  # noqa: E402
from repro_torch.kernels import _geometry as geo  # noqa: E402
from repro_torch.kernels import (conv2d, launch_counts, matmul,  # noqa: E402
                                 reset_launch_counts, sparse_conv2d)
from repro_torch.kernels.conv2d import (conv2d_dispatched,  # noqa: E402
                                        conv2d_plain, conv2d_tuned)
from repro_torch.kernels.matmul import (matmul_dispatched,  # noqa: E402
                                        matmul_plain, matmul_tuned)
from repro_torch.kernels.sparse_conv import (  # noqa: E402
    analyze_weights, build_block_index, sparse_conv2d_dispatched)
from repro_torch.runtime.dispatch import (DispatchService,  # noqa: E402
                                          FAMILIES, canonical_problem)

CONV_ORDERS = [("oc", "y", "x", "ic"), ("ic", "oc", "y", "x"),
               ("oc", "ic", "y", "x")]
MATMUL_SHAPES = [(1000, 169, 512), (32, 3025, 128), (128, 3025, 32),
                 (48, 729, 384), (64, 169, 512), (512, 9216, 3072)]
DTYPES = ["float32", "bfloat16"]


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _pair(a, dtype):
    """The same numpy array as a torch tensor and a jax array of dtype
    (both round float32 to bf16 to nearest even)."""
    return (torch.from_numpy(a).to(getattr(torch, dtype)),
            jnp.asarray(a).astype(getattr(jnp, dtype)))


def _from_jax(x):
    """A jax array as a torch tensor of the same dtype."""
    t = torch.from_numpy(np.array(x.astype(jnp.float32)))
    return t.to(torch.bfloat16) if x.dtype == jnp.bfloat16 else t


def _assert_close(got, want, peak=None):
    """Per-element tolerance of the module docstring."""
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = (got.float() - want.float()).abs()
    if want.dtype == torch.bfloat16:
        mag = (want.float().abs() if peak is None else peak)
        mag = mag.clamp_min(2.0 ** -126)
        allowed = 2 * torch.exp2(torch.floor(torch.log2(mag)) - 7) + 1e-5
    else:
        allowed = torch.full_like(diff, 1e-5)
    worst = (diff / allowed).max().item()
    assert worst <= 1.0, f"worst share of the tolerance {worst}"


# ------------------------------------------------------------------ conv2d

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("order", CONV_ORDERS, ids="-".join)
def test_conv2d_matches_pallas_kernel(order, dtype):
    """Both accumulation variants (ic innermost: scratch; otherwise
    read-modify-write, rounded to the output type per ic block) against
    ``conv2d_pallas`` in interpret mode, in the input's type."""
    img_t, img_j = _pair(_np((2, 8, 10, 10), 1), dtype)
    wgt_t, wgt_j = _pair(_np((8, 8, 3, 3), 2, 1 / 72 ** 0.5), dtype)
    block = {"oc": 4, "ic": 4, "y": 4, "x": 4}
    got = conv2d(img_t, wgt_t, block=block, grid_order=order)
    want = _from_jax(conv2d_pallas(img_j, wgt_j, block=block,
                                   grid_order=order))
    _, peak = conv2d_plain(img_t, wgt_t, block=block, grid_order=order,
                           with_peak=True)
    _assert_close(got, want, peak)


@pytest.mark.parametrize("shape", [
    (1, 4, 8, 8, 8, 1, 1),    # 1x1 kernel
    (2, 8, 12, 8, 16, 3, 3),  # rectangular
    (1, 16, 6, 6, 4, 5, 5),   # 5x5 kernel
])
def test_conv2d_matches_reference_shapes(shape):
    """The port's conv (float32 in, float32 out) against the JAX oracle
    ``conv2d_ref`` at its default blocks."""
    n, ic, h, w, oc, kh, kw = shape
    img = _np((n, ic, h + kh - 1, w + kw - 1), 3)
    wgt = _np((oc, ic, kh, kw), 4, 1 / (ic * kh * kw) ** 0.5)
    got = conv2d(torch.from_numpy(img), torch.from_numpy(wgt))
    want = torch.from_numpy(np.asarray(conv2d_ref(jnp.asarray(img),
                                                  jnp.asarray(wgt))))
    _assert_close(got, want)


def test_conv2d_rejects_blocks_that_do_not_divide():
    img, wgt = torch.zeros(1, 8, 10, 10), torch.zeros(8, 8, 3, 3)
    with pytest.raises(ValueError, match="divide"):
        conv2d(img, wgt, block={"oc": 3, "ic": 4, "y": 4, "x": 4})
    with pytest.raises(ValueError, match="permutation"):
        conv2d(img, wgt, block={"oc": 4, "ic": 4, "y": 4, "x": 4},
               grid_order=("oc", "y", "x", "y"))


# ------------------------------------------------------------------ matmul

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("resident", [False, True])
@pytest.mark.parametrize("order", list(itertools.permutations("mnk")),
                         ids="".join)
def test_matmul_matches_pallas_kernel(order, resident, dtype):
    """Six grid orders x resident RHS on/off against ``matmul_pallas``
    in interpret mode, in A's type."""
    a_t, a_j = _pair(_np((32, 48), 5), dtype)
    b_t, b_j = _pair(_np((48, 24), 6, 1 / 48 ** 0.5), dtype)
    block = {"m": 8, "n": 8, "k": 16}
    got = matmul(a_t, b_t, block=block, grid_order=order,
                 resident_rhs=resident)
    want = _from_jax(matmul_pallas(a_j, b_j, block=block, grid_order=order,
                                   resident_rhs=resident))
    _, peak = matmul_plain(a_t, b_t, block=block, grid_order=order,
                           resident_rhs=resident, with_peak=True)
    _assert_close(got, want, peak)


@pytest.mark.parametrize("mnk", [(16, 16, 16), (64, 32, 128), (8, 128, 32)])
def test_matmul_matches_reference(mnk):
    """Default blocks against the JAX oracle ``matmul_ref`` (float32)."""
    m, n, k = mnk
    a, b = _np((m, k), 7), _np((k, n), 8, 1 / k ** 0.5)
    got = matmul(torch.from_numpy(a), torch.from_numpy(b))
    want = torch.from_numpy(np.asarray(matmul_ref(jnp.asarray(a),
                                                  jnp.asarray(b))))
    _assert_close(got, want)


# -------------------------------------------------------------- sparse conv

def _sparse_weights(density, seed, oc=8, ic=16, k=3, boc=4, bic=4):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((oc, ic, k, k)).astype(np.float32) / 12.0
    zero = rng.random((oc // boc, ic // bic)) >= density
    for o, i in zip(*np.nonzero(zero)):
        w[o * boc:(o + 1) * boc, i * bic:(i + 1) * bic] = 0.0
    return w


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("density", [0.0, 0.3, 0.7, 1.0])
def test_sparse_conv_matches_reference_and_kernel(density, dtype):
    """Against ``sparse_conv_ref`` (float32, the dense oracle on the
    zeroed weights) in float32, and ``sparse_conv2d_pallas`` (interpret,
    the input's type) in both types."""
    block = {"oc": 4, "ic": 4}
    w = _sparse_weights(density, 11)
    img_t, img_j = _pair(_np((2, 16, 8, 8), 12), dtype)
    wgt_t, wgt_j = _pair(w, dtype)
    sp = analyze_weights(wgt_t, block)
    got = sparse_conv2d(img_t, wgt_t, block=block, sparsity=sp)
    jsp = j_analyze(np.asarray(wgt_j.astype(jnp.float32)), block)
    want = _from_jax(sparse_conv2d_pallas(
        img_j, wgt_j, jnp.asarray(jsp.idx), jnp.asarray(jsp.counts),
        block=block))
    _assert_close(got, want)
    if dtype == "float32":
        _assert_close(got, torch.from_numpy(np.asarray(
            sparse_conv_ref(img_j, wgt_j))))


def test_sparse_structure_equals_jax():
    """``build_block_index`` and ``analyze_weights`` (idx, counts,
    density, imbalance) equal the JAX package's."""
    for density, seed in ((0.0, 1), (0.3, 2), (0.7, 3), (1.0, 4)):
        w = _sparse_weights(density, seed, oc=16, ic=16)
        for block in ({"oc": 4, "ic": 4}, {"oc": 8, "ic": 2}):
            a, b = analyze_weights(torch.from_numpy(w), block), \
                j_analyze(w, block)
            np.testing.assert_array_equal(a.idx, b.idx)
            np.testing.assert_array_equal(a.counts, b.counts)
            assert (a.density, a.imbalance) == (b.density, b.imbalance)
    mask = np.random.default_rng(5).random((6, 5)) > 0.6
    for x, y in zip(build_block_index(mask), j_build_index(mask)):
        np.testing.assert_array_equal(x, y)
    w = np.zeros((8, 8, 1, 1), np.float32)
    w[:4, :4] = 1.0
    sp = analyze_weights(w, {"oc": 4, "ic": 4})
    assert (sp.density, sp.imbalance) == (0.25, 2.0)


def test_sparse_conv_skips_blocks_outside_the_structure():
    """Blocks the structure does not list are skipped even where the
    weights are nonzero (the kernel's semantics)."""
    block = {"oc": 4, "ic": 4}
    w = torch.from_numpy(_sparse_weights(1.0, 6))
    img = torch.from_numpy(_np((1, 16, 8, 8), 7))
    mask = np.zeros((2, 4), bool)
    mask[0, 1] = mask[1, 3] = True
    idx, counts = build_block_index(mask)
    sp = analyze_weights(w, block)
    sp = type(sp)(idx=idx, counts=counts, block=block, n_ic_blocks=4)
    keep = torch.zeros_like(w)
    keep[0:4, 4:8] = 1
    keep[4:8, 12:16] = 1
    want = torch.from_numpy(np.asarray(conv2d_ref(
        jnp.asarray(img.numpy()), jnp.asarray((w * keep).numpy()))))
    _assert_close(sparse_conv2d(img, w, block=block, sparsity=sp), want)


# -------------------------------------------------------------- cost model

def _jlayer(layer):
    return JConvLayer(layer.oc, layer.ic, layer.h, layer.w, layer.kh,
                      layer.kw)


@pytest.mark.parametrize("name", list(TABLE_4_1))
def test_cost_model_counts_equal_jax(name):
    """HBM bytes and grid steps equal the JAX model's for the same
    (order, block) enumeration; the H100 time terms are finite."""
    layer = TABLE_4_1[name]
    orders = list(itertools.permutations(("oc", "ic", "y", "x")))
    blocks = tuner.conv_blocks(layer, 2)
    ours = cm.conv_schedule_cost_batch(layer, orders, blocks)
    theirs = jcm.conv_schedule_cost_batch(_jlayer(layer), orders, blocks)
    np.testing.assert_array_equal(ours.hbm_bytes, theirs.hbm_bytes)
    np.testing.assert_array_equal(ours.grid_steps, theirs.grid_steps)
    assert np.isfinite(ours.time_s).all() and (ours.time_s > 0).all()

    for density in (0.0, 0.25, 0.5, 1.0):
        sblocks = tuner.sparse_blocks(layer, 2)
        ours = cm.sparse_conv_schedule_cost_batch(layer, sblocks, density)
        theirs = jcm.sparse_conv_schedule_cost_batch(_jlayer(layer), sblocks,
                                                     density)
        np.testing.assert_array_equal(ours.hbm_bytes, theirs.hbm_bytes)
        np.testing.assert_array_equal(ours.grid_steps, theirs.grid_steps)
        assert np.isfinite(ours.time_s).all()


@pytest.mark.parametrize("mnk", MATMUL_SHAPES, ids=str)
def test_matmul_cost_counts_equal_jax(mnk):
    m, n, k = mnk
    blocks = tuner.matmul_blocks(m, n, k)
    ours = cm.matmul_schedule_cost_batch(m, n, k, blocks)
    theirs = jcm.matmul_schedule_cost_batch(m, n, k, blocks)
    np.testing.assert_array_equal(ours.hbm_bytes, theirs.hbm_bytes)
    np.testing.assert_array_equal(ours.grid_steps, theirs.grid_steps)
    assert np.isfinite(ours.time_s).all()


@pytest.mark.parametrize("name", list(TABLE_4_1))
def test_reduction_outer_orders_never_cost_less(name):
    """With the same blocks (split into >= 2 ic blocks), no
    read-modify-write order is predicted faster than the best ic-innermost
    order: every extra pass is a launch and an output round trip."""
    layer = TABLE_4_1[name]
    orders = list(itertools.permutations(("oc", "ic", "y", "x")))
    bics = [d for d in range(4, layer.ic) if layer.ic % d == 0]
    blocks = [dict(b, ic=d) for b in tuner.conv_blocks(layer, 2)
              for d in bics
              if geo.conv_tile(b["oc"], d, b["y"], b["x"], layer.kh,
                               layer.kw, 2).error is None]
    assert blocks
    t = cm.conv_schedule_cost_batch(layer, orders, blocks).time_s
    inner = np.array([o[-1] == "ic" for o in orders])
    assert (t[~inner].min(axis=0) >= t[inner].min(axis=0)).all()


def test_dense_vs_sparse_policy():
    """At a layer whose predicted crossover lies inside (0, 1) (a
    ResNet conv5 3x3 layer: 512 channels, 7 x 7), the policy picks the
    sparse kernel below it and the dense one above it.  At the thesis'
    Fig 6.2 layer, with both sides on the tensor cores, the sparse
    kernel wins below a crossover inside (0, 1) at batch 1 and 32, as
    the thesis' Fig 6.2 finds."""
    layer = ConvLayer(512, 512, 7, 7, 3, 3)
    block = {"oc": 16, "ic": 16}
    x = sparsity.crossover_density(layer, block)
    assert 0.0 < x < 1.0
    assert sparsity.choose_algorithm(layer, block, x / 2).algorithm == \
        "sparse"
    assert sparsity.choose_algorithm(layer, block,
                                     min(1.0, x + 0.05)).algorithm == \
        "dense"
    fig = ConvLayer(128, 128, 25, 25, 3, 3)
    for batch in (1, 32):
        assert 0.0 < sparsity.crossover_density(fig, block,
                                                batch=batch) < 1.0


# ------------------------------------------------------- tuner and registry

@pytest.mark.parametrize("dtype_bytes", [2, 4])
def test_every_ranked_schedule_fits_the_kernels(dtype_bytes):
    """Every schedule the tuners can return for the Table 4.1 layers and
    the matmul shapes is a valid permutation with dividing blocks that
    the CUDA kernel of its dtype accepts: the tensor-core layouts for
    bf16 (the block-sparse conv's at its pixel tile, which divides the
    image), the CUDA-core layouts for float32."""
    for layer in TABLE_4_1.values():
        ranked = tuner.tune_conv(layer, elem_bytes=dtype_bytes, top_k=10 ** 6)
        assert ranked
        for s, c in ranked:
            b = s.block_dict()
            assert sorted(s.grid_order) == ["ic", "oc", "x", "y"]
            assert (layer.oc % b["oc"], layer.ic % b["ic"], layer.h % b["y"],
                    layer.w % b["x"]) == (0, 0, 0, 0)
            tile = (geo.conv_mma_tile(b["oc"], b["ic"], b["y"], b["x"],
                                      layer.kh, layer.kw)
                    if dtype_bytes == 2 else
                    geo.conv_tile(b["oc"], b["ic"], b["y"], b["x"], layer.kh,
                                  layer.kw, dtype_bytes))
            assert tile.error is None
            assert c.time_s < cm.INFEASIBLE_S
        for density in (0.0, 0.25, 0.5, 1.0):
            by, bx = geo.sparse_tile(layer.h, layer.w)
            for s, _ in tuner.tune_sparse_conv(layer, density,
                                               elem_bytes=dtype_bytes,
                                               top_k=10 ** 6):
                b = s.block_dict()
                if dtype_bytes == 2:
                    by, bx = sparsity.sparse_pixel_tile(layer, b["oc"],
                                                        b["ic"])
                    assert layer.h % by == 0 and layer.w % bx == 0
                assert geo.sparse_layout(
                    b["oc"], b["ic"], by, bx, layer.kh, layer.kw,
                    layer.ic // b["ic"], dtype_bytes).error is None
    for m, n, k in MATMUL_SHAPES:
        ranked = tuner.tune_matmul(m, n, k, elem_bytes=dtype_bytes,
                                   top_k=10 ** 6)
        assert ranked
        for s, _ in ranked:
            b = s.block_dict()
            assert sorted(s.grid_order) == ["k", "m", "n"]
            assert (m % b["m"], n % b["n"], k % b["k"]) == (0, 0, 0)
            tile = (geo.matmul_mma_tile(b["m"], b["n"], b["k"], k,
                                        s.resident_rhs)
                    if dtype_bytes == 2 else
                    geo.matmul_tile(b["m"], b["n"], b["k"], k, dtype_bytes,
                                    s.resident_rhs))
            assert tile.error is None


def test_warm_registry_performs_zero_cost_model_evals(tmp_path):
    path = str(tmp_path / "t.jsonl")
    layer = TABLE_4_1["fire9-conv3x3-2"]
    cold = [tuner.cached_tune_conv(layer, registry=reg.TuningRegistry(path)),
            tuner.cached_tune_matmul(1000, 169, 512,
                                     registry=reg.TuningRegistry(path)),
            tuner.cached_tune_sparse_conv(layer, 0.5,
                                          registry=reg.TuningRegistry(path))]
    before = cm.total_evals()
    warm_reg = reg.TuningRegistry(path)   # a fresh process' view
    warm = [tuner.cached_tune_conv(layer, registry=warm_reg),
            tuner.cached_tune_matmul(1000, 169, 512, registry=warm_reg),
            tuner.cached_tune_sparse_conv(layer, 0.5, registry=warm_reg)]
    assert cm.total_evals() == before
    assert [[s for s, _ in r] for r in warm] == \
        [[s for s, _ in r] for r in cold]


def test_card_and_cpu_keys_differ():
    """A measurement key made with the H100 spec and the CPU runtime
    never equals one made for a card, nor the spec-only offline key."""
    spec = cm.H100Spec()
    layer = TABLE_4_1["conv-final"]
    cpu = reg.conv_schedule_key(layer, reg.machine_key(spec, "cpu"))
    offline = reg.conv_schedule_key(layer, spec)
    card = reg.conv_schedule_key(layer, reg.fingerprint(
        {"spec": reg.fingerprint(spec), "runtime": reg.fingerprint(
            {"platform": "cuda", "name": "NVIDIA H100 80GB HBM3",
             "capability": [9, 0], "device_count": 1})}))
    assert len({cpu.canonical(), offline.canonical(),
                card.canonical()}) == 3
    svc = DispatchService(reg.TuningRegistry(None), device="cpu")
    assert svc.machine == cpu.machine


def test_service_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DispatchService(reg.TuningRegistry(None))
    svc = DispatchService(reg.TuningRegistry(None), device="cpu")
    with pytest.raises(ValueError, match="times calls on cpu"):
        with svc.measure("matmul", {"m": 8, "n": 8, "k": 8},
                         device="meta"):
            pass


# ----------------------------------------------------------------- dispatch

def test_dispatched_wrappers_match_jax_dispatched():
    """``*_dispatched`` on the CPU equal the JAX ``*_dispatched`` outputs
    (float32), one observation each in its own slot."""
    from repro.core import registry as jreg
    from repro.kernels.conv2d import conv2d_dispatched as j_conv
    from repro.kernels.matmul import matmul_dispatched as j_mm
    from repro.kernels.sparse_conv import sparse_conv2d_dispatched as j_sp
    from repro.runtime.dispatch import DispatchService as JService
    jsvc = JService(jreg.TuningRegistry(None))
    svc = DispatchService(reg.TuningRegistry(None), device="cpu")
    img, wgt = _np((1, 8, 14, 14), 0), _np((16, 8, 3, 3), 1, 1 / 8.5)
    _assert_close(conv2d_dispatched(torch.from_numpy(img),
                                    torch.from_numpy(wgt), service=svc),
                  torch.from_numpy(np.asarray(j_conv(
                      jnp.asarray(img), jnp.asarray(wgt), service=jsvc))))
    a, b = _np((32, 16), 2), _np((16, 24), 3, 0.25)
    _assert_close(matmul_dispatched(torch.from_numpy(a), torch.from_numpy(b),
                                    service=svc),
                  torch.from_numpy(np.asarray(j_mm(
                      jnp.asarray(a), jnp.asarray(b), service=jsvc))))
    wsp = _np((16, 8, 3, 3), 4, 1 / 8.5)
    wsp[:8, :4] = 0.0
    _assert_close(sparse_conv2d_dispatched(torch.from_numpy(img),
                                           torch.from_numpy(wsp),
                                           service=svc),
                  torch.from_numpy(np.asarray(j_sp(
                      jnp.asarray(img), jnp.asarray(wsp), service=jsvc))))
    rep = svc.report()
    assert sorted(e["kind"] for e in rep.values()) == \
        ["conv2d", "matmul", "sparse_conv"]
    assert all(e["observations"] == 1 for e in rep.values())
    assert svc.observations == 3 and svc.resolves == 3


PROBLEMS = [
    ("conv2d", {"oc": 32, "ic": 16, "h": 13, "w": 13, "kh": 3, "kw": 3}),
    ("matmul", {"m": 64, "n": 169, "k": 512}),
    ("sparse_conv", {"oc": 32, "ic": 32, "h": 13, "w": 13, "kh": 3,
                     "kw": 3, "density_16": 8}),
]


@pytest.mark.parametrize("kind,problem", PROBLEMS, ids=[p[0] for p in PROBLEMS])
def test_slot_commits_argmin_after_its_probes(kind, problem, tmp_path):
    """Steady synthetic times: the slot commits after top_k x probes
    observations, to the fastest candidate (not the model's rank-0), and
    writes it back; a fresh service on the same registry file returns it
    from ``committed_or_best``."""
    path = str(tmp_path / "d.jsonl")
    svc = DispatchService(reg.TuningRegistry(path), device="cpu", top_k=3)
    cands = svc.candidates(kind, problem)
    assert len(cands) == 3
    best = cands[1]
    rng = np.random.default_rng(0)
    obs = 0
    while svc.committed(kind, problem) is None:
        sched = svc.propose(kind, problem)
        base = 1e-3 if sched == best else 3e-3
        svc.observe(kind, problem, base * (1 + 0.02 * rng.random()))
        obs += 1
        assert obs <= 20
    assert obs == 3 * 3
    assert svc.committed(kind, problem) == best and svc.commits == 1
    rec = svc.registry.get(FAMILIES[kind].key(
        canonical_problem(kind, **problem), svc.machine, 2))
    assert rec.measured["time_s"] == pytest.approx(1e-3, rel=0.05)
    assert reg.schedule_from_dict(rec.measured["best"]) == best
    fresh = DispatchService(reg.TuningRegistry(path), device="cpu", top_k=3)
    assert fresh.committed(kind, problem) is None
    assert fresh.committed_or_best(kind, problem) == best
    assert fresh.measured_time(kind, problem) == pytest.approx(1e-3,
                                                               rel=0.05)
    assert fresh.predicted(kind, problem) == svc.predicted(kind, problem)


def test_dispatched_calls_commit_and_count_no_launch_on_cpu():
    svc = DispatchService(reg.TuningRegistry(None), device="cpu", top_k=2,
                          probes_per_candidate=2)
    img = torch.from_numpy(_np((1, 8, 8, 8), 5))
    wgt = torch.from_numpy(_np((8, 8, 1, 1), 6, 0.3))
    reset_launch_counts()
    for _ in range(8):
        conv2d_dispatched(img, wgt, service=svc)
    problem = {"oc": 8, "ic": 8, "h": 8, "w": 8, "kh": 1, "kw": 1}
    assert svc.committed("conv2d", problem, 4) is not None
    assert sum(launch_counts().values()) == 0


# ------------------------------------------------------- the path as a whole

def test_tuned_path_over_reduced_table_matches_jax(tmp_path, monkeypatch):
    """``conv2d_tuned`` and ``matmul_tuned`` over Table 4.1 with the
    channels divided by 8 and images cut to <= 14 equal the JAX
    package's ``conv2d_tuned`` / ``matmul_tuned`` (float32, each with its
    own machine's rank-0 schedule)."""
    from repro.kernels.conv2d import conv2d_tuned as j_conv_tuned
    from repro.kernels.matmul import matmul_tuned as j_mm_tuned
    monkeypatch.setenv("REPRO_TUNE_REGISTRY", str(tmp_path / "jax.jsonl"))
    monkeypatch.setenv("REPRO_TORCH_TUNE_REGISTRY",
                       str(tmp_path / "torch.jsonl"))
    for i, layer in enumerate(TABLE_4_1.values()):
        oc, ic = max(layer.oc // 8, 1), max(layer.ic // 8, 1)
        h, w = min(layer.h, 14), min(layer.w, 14)
        img = _np((1, ic, h + layer.kh - 1, w + layer.kw - 1), 20 + i)
        wgt = _np((oc, ic, layer.kh, layer.kw), 40 + i,
                  1 / (ic * layer.kh * layer.kw) ** 0.5)
        got = conv2d_tuned(torch.from_numpy(img), torch.from_numpy(wgt))
        want = j_conv_tuned(jnp.asarray(img), jnp.asarray(wgt))
        _assert_close(got, torch.from_numpy(np.asarray(want)))
        if layer.kh == 1:
            a, b = wgt[:, :, 0, 0], img[0].reshape(ic, -1)
            _assert_close(matmul_tuned(torch.from_numpy(a),
                                       torch.from_numpy(np.ascontiguousarray(b))),
                          torch.from_numpy(np.asarray(j_mm_tuned(
                              jnp.asarray(a), jnp.asarray(b)))))
    assert (tmp_path / "torch.jsonl").exists()
