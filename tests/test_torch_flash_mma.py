"""The arithmetic and layout of the port's bf16 flash attention on the
tensor cores (``csrc/flash_attention.cu``, flash_mma_kernel), on the CPU.

The CUDA body cannot run here, so its arithmetic is emulated in plain
PyTorch step by step: q scaled in bf16, f32 scores over 64-key tiles, the
f32 online softmax (m from -1e30, masked keys -inf, l == 0 -> zeros), p
split into bf16 hi + lo parts, each multiplied with V in f32 and summed
into one f32 accumulator, 1/l and one rounding to bf16.  The emulation is
held to ``flash_attention_ref`` at the port's bf16 contract (per element
two bf16 ulps of the plain value + 1e-5), and the plain version to
``flash_attention_pallas`` in interpret mode at the same contract, so
the kernel's arithmetic is tied to the JAX kernel through the plain
version.  The layout rule (``_geometry.flash_mma_tile``) is the wrapper's.
The wgmma body (``csrc/flash_wgmma.cu``), the one bf16 body at the
models' head dims, runs the same arithmetic over another tiling (64-key
stages, a block's tiles skipped per 64-row warpgroup, rows past S
zero-filled by TMA and not stored), emulated here over the tiles it
visits, phi3-mini's short prefills among them; its layout
(``_geometry.flash_wgmma_tile``) and the rule that picks it
(``_geometry.flash_body``) are checked too.
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_pallas)
from repro_torch.kernels import _geometry as geo  # noqa: E402
from repro_torch.kernels._checks import scale_q  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_ref)
from repro_torch.kernels.flash_attention.ops import MAX_HEAD_DIM  # noqa: E402
from repro_torch.models import bucket_length  # noqa: E402

KEYS = geo.FLASH_KEYS


def flash_mma_emulation(q, k, v, *, causal=True, window=None, starts=None,
                        split=True, visited=None):
    """The bf16 body's arithmetic on the CPU (``split=False``: p rounded
    to bf16 once, the design the kernel does not take).  ``visited``
    ([B, S, tiles] bool, :func:`flash_tiles_visited`) keeps each row's
    state through the tiles its block and warp do not run."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    qs = scale_q(q).float().reshape(b, hkv, g, s, d)
    kf, vf = k.float(), v.float()
    qpos = torch.arange(s)[:, None]
    st = (torch.zeros(b, dtype=torch.long) if starts is None
          else starts.long())
    m = torch.full((b, hkv, g, s, 1), -1e30)
    l = torch.zeros((b, hkv, g, s, 1))
    o = torch.zeros((b, hkv, g, s, d))
    for k0 in range(0, s, KEYS):
        state = (m, l, o)
        kpos = torch.arange(k0, min(k0 + KEYS, s))[None, :]
        sc = torch.einsum("bhgqd,bhkd->bhgqk", qs, kf[:, :, k0:k0 + KEYS])
        ok = torch.ones(s, kpos.shape[1], dtype=torch.bool)
        if causal:
            ok &= kpos <= qpos
        if window is not None:
            ok &= kpos > qpos - window
        ok = ok[None] & (kpos[None] >= st[:, None, None])
        sc = sc.masked_fill(~ok[:, None, None], float("-inf"))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        m = m_new
        p = torch.exp(sc - m)
        l = l * alpha + p.sum(-1, keepdim=True)
        vt = vf[:, :, k0:k0 + KEYS]
        hi = p.to(torch.bfloat16).float()
        o = o * alpha + torch.einsum("bhgqk,bhkd->bhgqd", hi, vt)
        if split:
            lo = (p - hi).to(torch.bfloat16).float()
            o = o + torch.einsum("bhgqk,bhkd->bhgqd", lo, vt)
        if visited is not None:
            run = visited[:, None, None, :, k0 // KEYS, None]
            m, l, o = (torch.where(run, new, old)
                       for new, old in zip((m, l, o), state))
    o = o * torch.where(l > 0, 1 / l, torch.zeros_like(l))
    return o.reshape(b, hq, s, d).to(q.dtype)


def flash_tiles_visited(b, s, *, rows, causal=True, window=None,
                        starts=None):
    """[B, S, tiles] bool: the key tiles the bf16 body's block structure
    runs for each query row at ``rows`` query rows a block
    (``flash_mma_kernel<DP, ROWS>``): a block visits the tiles of its
    ``[lo, hi)`` range (lo from starts and the window, hi from its last
    row under the causal mask; lo >= hi writes zeros), and each warp of
    16 rows skips a tile none of its rows can see."""
    n_t = -(-s // KEYS)
    out = torch.zeros((b, s, n_t), dtype=torch.bool)
    for bi in range(b):
        start = 0 if starts is None else max(int(starts[bi]), 0)
        for q0 in range(0, s, rows):
            lo = start if window is None else max(start, q0 - window + 1)
            hi = min(s, q0 + rows) if causal else s
            if lo >= hi:
                continue
            for w0 in range(q0, min(s, q0 + rows), 16):
                for t in range(lo // KEYS, -(-hi // KEYS)):
                    k0 = t * KEYS
                    if (causal and k0 > w0 + 15) or k0 + KEYS <= start or (
                            window is not None
                            and k0 + KEYS - 1 <= w0 - window):
                        continue
                    out[bi, w0:min(s, w0 + 16), t] = True
    return out


def flash_tiles_needed(b, s, *, causal=True, window=None, starts=None):
    """[B, S, tiles] bool: the tiles holding a key each row may see."""
    n_t = -(-s // KEYS)
    qp = torch.arange(s)[:, None]
    kp = torch.arange(n_t * KEYS)[None, :]
    ok = (kp < s) & (qp >= 0)                     # [S, tiles x KEYS]
    if causal:
        ok = ok & (kp <= qp)
    if window is not None:
        ok = ok & (kp > qp - window)
    st = (torch.zeros(b, dtype=torch.long) if starts is None
          else starts.long().clamp_min(0))
    ok = ok[None] & (kp[None] >= st[:, None, None])
    return ok.reshape(b, s, n_t, KEYS).any(-1)


def _share_of_tol(got, want):
    """Worst |got - want| as a share of two bf16 ulps of |want| + 1e-5."""
    diff = (got.float() - want.float()).abs()
    mag = want.float().abs().clamp_min(2.0 ** -126)
    allowed = 2 * torch.exp2(torch.floor(torch.log2(mag)) - 7) + 1e-5
    return (diff / allowed).max().item()


def _inputs(b, hq, hkv, s, d, seed):
    rng = np.random.default_rng(seed)

    def mk(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(torch.bfloat16)

    return mk(b, hq, s, d), mk(b, hkv, s, d), mk(b, hkv, s, d)


EMULATION_CASES = [
    # (B, HQ, HKV, S, D, kwargs)
    (1, 8, 8, 512, 96, {"starts": [212]}),        # the engine's largest
    (4, 4, 4, 512, 96, {"starts": [472, 412, 262, 212]}),
    (2, 4, 2, 200, 16, {"starts": [0, 66]}),       # ragged S, GQA 2
    (2, 4, 1, 65, 128, {"window": 9}),             # GQA 4, window
    (1, 4, 4, 63, 128, {}),
    (2, 2, 2, 1, 16, {}),                          # one token
    (2, 4, 2, 100, 40, {"starts": [3, 99]}),       # D 40 pads to 48
    (1, 2, 1, 130, 20, {"causal": False}),         # D % 8 != 0
    (2, 2, 2, 64, 96, {"starts": [64, 10]}),       # an all-pad row
    (1, 16, 1, 128, 256, {"starts": [40]}),        # D 256, group 16
    (1, 5, 1, 70, 200, {"window": 30}),            # D 200 pads to 224
]


@pytest.mark.parametrize("b,hq,hkv,s,d,kw", EMULATION_CASES,
                         ids=[f"{c[0]}x{c[1]}/{c[2]}-s{c[3]}-d{c[4]}-"
                              + "-".join(c[5]) for c in EMULATION_CASES])
def test_emulated_kernel_arithmetic_holds_to_the_plain_version(b, hq, hkv, s,
                                                               d, kw):
    q, k, v = _inputs(b, hq, hkv, s, d, seed=s + d + hq)
    kw = {n: torch.tensor(x) if n == "starts" else x for n, x in kw.items()}
    got = flash_mma_emulation(q, k, v, **kw)
    want = flash_attention_ref(q, k, v, **kw)
    assert got.dtype == want.dtype == torch.bfloat16
    assert _share_of_tol(got, want) <= 1.0
    if "starts" in kw:     # rows with no valid key are zeros in both
        for i, st in enumerate(kw["starts"].tolist()):
            assert (got[i, :, :st] == 0).all() and (want[i, :, :st] == 0).all()


@pytest.mark.parametrize("rows", geo.FLASH_ROW_CHOICES)
@pytest.mark.parametrize("b,hq,hkv,s,d,kw", EMULATION_CASES,
                         ids=[f"{c[0]}x{c[1]}/{c[2]}-s{c[3]}-d{c[4]}-"
                              + "-".join(c[5]) for c in EMULATION_CASES])
def test_block_structure_at_each_row_count_drops_no_needed_tile(b, hq, hkv,
                                                                s, d, kw,
                                                                rows):
    """At 64 and 128 query rows a block (4 and 8 warps), every tile
    holding a key a row may see is run for that row, so the emulated
    arithmetic over only the tiles the blocks and warps run equals the
    emulation over every tile bit for bit (a tile a row cannot see adds
    exactly nothing) and holds to the plain version: the body's rows
    template changes which tiles run, never the output."""
    kw = {n: torch.tensor(x) if n == "starts" else x for n, x in kw.items()}
    mask = {n: kw[n] for n in ("causal", "window", "starts") if n in kw}
    visited = flash_tiles_visited(b, s, rows=rows, **mask)
    needed = flash_tiles_needed(b, s, **mask)
    assert not (needed & ~visited).any()
    q, k, v = _inputs(b, hq, hkv, s, d, seed=s + d + hq)
    got = flash_mma_emulation(q, k, v, visited=visited, **kw)
    assert torch.equal(got, flash_mma_emulation(q, k, v, **kw))
    assert _share_of_tol(got, flash_attention_ref(q, k, v, **kw)) <= 1.0


PALLAS_CASES = [
    # (B, HQ, HKV, S, D, window, starts): S below the Pallas block, so
    # any length is one block
    (2, 4, 2, 37, 16, None, [0, 12]),
    (1, 4, 1, 100, 96, 9, None),
    (2, 2, 2, 65, 128, None, [5, 64]),
    (1, 8, 1, 64, 256, None, [9]),
]


@pytest.mark.parametrize("b,hq,hkv,s,d,window,starts", PALLAS_CASES)
def test_plain_version_holds_to_the_pallas_kernel_in_bf16(b, hq, hkv, s, d,
                                                          window, starts):
    """The plain version the kernel is held to on the card agrees with
    ``flash_attention_pallas`` (interpret) in bf16 at the same contract,
    on every row with a valid key (the TPU kernel's pad rows depend on
    its block structure and are discarded by its callers)."""
    q, k, v = _inputs(b, hq, hkv, s, d, seed=7 * s + d)
    st = None if starts is None else np.array(starts, np.int32)
    ref = flash_attention_pallas(
        *(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
          for x in (q, k, v)), causal=True, window=window,
        starts=None if st is None else jnp.asarray(st), interpret=True)
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32))).to(
        torch.bfloat16)
    want = flash_attention_ref(q, k, v, window=window,
                               starts=None if st is None
                               else torch.from_numpy(st))
    emu = flash_mma_emulation(q, k, v, window=window,
                              starts=None if st is None
                              else torch.from_numpy(st))
    for i in range(b):
        lo = 0 if st is None else int(st[i])
        assert _share_of_tol(want[i, :, lo:], ref[i, :, lo:]) <= 1.0
        assert _share_of_tol(emu[i, :, lo:], want[i, :, lo:]) <= 1.0


def test_rounding_p_once_breaks_the_contract():
    """Why p is split: rounded to bf16 once, the P V products lose up to
    2^-9 of each term, and where |o| cancels against |v| that is many
    times the 2-ulp tolerance; split into hi + lo the same inputs hold."""
    q, k, v = _inputs(1, 8, 8, 512, 96, seed=0)
    st = torch.tensor([212])
    want = flash_attention_ref(q, k, v, starts=st)
    once = flash_mma_emulation(q, k, v, starts=st, split=False)
    split = flash_mma_emulation(q, k, v, starts=st)
    assert _share_of_tol(once, want) > 4.0
    assert _share_of_tol(split, want) <= 1.0


# ---------------------------------------------------------------- layout

@pytest.mark.parametrize("d,dp,staging", [
    (16, 16, "cp.async"), (96, 96, "cp.async"), (128, 128, "cp.async"),
    (40, 48, "cp.async"), (1, 16, "registers"), (20, 32, "registers"),
    (100, 112, "registers"), (127, 128, "registers"),
    (256, 256, "cp.async"), (129, 160, "registers"), (200, 224, "cp.async"),
    (250, 256, "registers"),
])
def test_flash_layout_pads_the_head_dim_to_the_mma_k(d, dp, staging):
    """D pads to 16 (to 32 above 128, where Q's fragments are re-read
    from shared memory); rows of 16-byte multiples go by cp.async, others
    through registers into the same tiles; shared memory holds the Q/O
    tile and two K and V stages of [64][dp + 8] bf16 (rows an odd
    number of 16-byte units)."""
    t = geo.flash_mma_tile(d)
    assert (t.dp, t.staging, t.error) == (dp, staging, None)
    assert t.smem == 5 * geo.FLASH_ROWS * (dp + 8) * 2
    assert ((dp + 8) * 2 // 16) % 2 == 1 and (dp + 8) * 2 % 16 == 0
    assert t.threads == 128 and t.smem <= geo.SMEM_BYTES


@pytest.mark.parametrize("d", [0, 257, 512])
def test_flash_layout_refuses_head_dims_above_128(d):
    """Head dims outside [1, FLASH_MAX_D] are refused.  The name is the
    test's from when the limit was 128; it is 256 now, the widest of the
    repository's configs (paligemma-3b, recurrentgemma-9b)."""
    assert MAX_HEAD_DIM == geo.FLASH_MAX_D == 256
    assert "head_dim" in geo.flash_mma_tile(d).error


def test_flash_body_follows_the_dtype_rule():
    """bf16 takes the tensor-core body, float32 the CUDA-core one; on a
    CPU tensor the wrapper runs the plain version and counts nothing."""
    assert geo.tensor_cores(2) and not geo.tensor_cores(4)
    q, k, v = _inputs(1, 2, 2, 70, 16, seed=3)
    before = flash_attention.launches
    got = flash_attention(q, k, v)
    assert flash_attention.launches == before
    assert torch.equal(got, flash_attention_ref(q, k, v))


# ---------------------------------------------------------------- wgmma body

WG_ROWS = 64        # query rows of a consumer warpgroup


def flash_wgmma_tiles_visited(b, s, *, rows, causal=True, window=None,
                              starts=None):
    """[B, S, tiles] bool: the key tiles the wgmma body runs for each
    query row at ``rows`` rows a block (``flash_wgmma_kernel<DP, WG>``):
    the producer stages the block's ``[lo, hi)`` range, and each 64-row
    warpgroup runs the MMAs of a staged tile unless none of its rows can
    see it (a warpgroup whose rows all lie past S runs none)."""
    n_t = -(-s // KEYS)
    out = torch.zeros((b, s, n_t), dtype=torch.bool)
    for bi in range(b):
        start = 0 if starts is None else max(int(starts[bi]), 0)
        for q0 in range(0, s, rows):
            lo = start if window is None else max(start, q0 - window + 1)
            hi = min(s, q0 + rows) if causal else s
            if lo >= hi:
                continue
            for g0 in range(q0, min(s, q0 + rows), WG_ROWS):
                for t in range(lo // KEYS, -(-hi // KEYS)):
                    k0 = t * KEYS
                    if (causal and k0 > g0 + WG_ROWS - 1) or \
                            k0 + KEYS <= start or (
                                window is not None
                                and k0 + KEYS - 1 <= g0 - window):
                        continue
                    out[bi, g0:min(s, g0 + WG_ROWS), t] = True
    return out


WGMMA_CASES = [
    # (B, HQ, HKV, S, D, kwargs): S not a multiple of the tile, windows
    # whose edges cut tiles, left padding, a group of 5, MQA
    (2, 2, 2, 1500, 64, {"causal": False}),       # whisper's frames
    (1, 4, 1, 300, 256, {"window": 100}),
    (2, 5, 1, 200, 128, {"starts": [0, 77]}),
    (2, 4, 4, 150, 96, {"window": 40, "starts": [3, 149]}),
    (1, 2, 2, 65, 64, {}),
    # phi3-mini's heads below one key tile: a query tile past S, starts
    # at and near S
    (1, 32, 32, 8, 96, {"starts": [3]}),
    (2, 32, 32, 16, 96, {"starts": [15, 16]}),
    (1, 32, 32, 40, 96, {}),
    (2, 32, 32, 100, 96, {"starts": [0, 99]}),
]


@pytest.mark.parametrize("rows", geo.FLASH_ROW_CHOICES)
@pytest.mark.parametrize("b,hq,hkv,s,d,kw", WGMMA_CASES,
                         ids=[f"{c[0]}x{c[1]}/{c[2]}-s{c[3]}-d{c[4]}-"
                              + "-".join(c[5]) for c in WGMMA_CASES])
def test_wgmma_tiling_emulation_holds_to_the_plain_version(b, hq, hkv, s, d,
                                                           kw, rows):
    """The wgmma body's tiling drops no tile a row needs, so its
    arithmetic over only the tiles it visits equals the emulation over
    every tile bit for bit and meets the bf16 contract against the plain
    version; rows with no valid key are zeros."""
    kw = {n: torch.tensor(x) if n == "starts" else x for n, x in kw.items()}
    mask = {n: kw[n] for n in ("causal", "window", "starts") if n in kw}
    visited = flash_wgmma_tiles_visited(b, s, rows=rows, **mask)
    needed = flash_tiles_needed(b, s, **mask)
    assert not (needed & ~visited).any()
    q, k, v = _inputs(b, hq, hkv, s, d, seed=s + d + hq)
    got = flash_mma_emulation(q, k, v, visited=visited, **kw)
    assert torch.equal(got, flash_mma_emulation(q, k, v, **kw))
    want = flash_attention_ref(q, k, v, **kw)
    assert _share_of_tol(got, want) <= 1.0
    if "starts" in kw:
        for i, st in enumerate(kw["starts"].tolist()):
            assert (got[i, :, :st] == 0).all()


@pytest.mark.parametrize("b,hq,hkv,s,d,window,starts,causal", [
    (2, 2, 1, 150, 64, 40, [0, 70], True),
    (1, 4, 4, 130, 96, None, None, False),
    (1, 2, 1, 100, 256, None, [30], True),
    (1, 32, 32, 40, 96, None, [7], True),
])
def test_wgmma_emulation_holds_to_the_pallas_kernel(b, hq, hkv, s, d, window,
                                                    starts, causal):
    """Through the plain version, the wgmma body's emulated arithmetic
    over its visited tiles (S past a tile multiple: the TMA's zero rows
    are masked) agrees with ``flash_attention_pallas`` (interpret, one
    block of S rows) on every row with a valid key."""
    q, k, v = _inputs(b, hq, hkv, s, d, seed=11 * s + d)
    st = None if starts is None else np.array(starts, np.int32)
    ref = flash_attention_pallas(
        *(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
          for x in (q, k, v)), block_q=s, block_kv=s, causal=causal,
        window=window, starts=None if st is None else jnp.asarray(st),
        interpret=True)
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32))).to(
        torch.bfloat16)
    kw = {"causal": causal, "window": window,
          "starts": None if st is None else torch.from_numpy(st)}
    visited = flash_wgmma_tiles_visited(b, s, rows=128, **kw)
    emu = flash_mma_emulation(q, k, v, visited=visited, **kw)
    want = flash_attention_ref(q, k, v, **kw)
    for i in range(b):
        lo = 0 if st is None else int(st[i])
        assert _share_of_tol(want[i, :, lo:], ref[i, :, lo:]) <= 1.0
        assert _share_of_tol(emu[i, :, lo:], want[i, :, lo:]) <= 1.0


@pytest.mark.parametrize("rows", geo.FLASH_ROW_CHOICES)
@pytest.mark.parametrize("d", [64, 96, 128, 256])
def test_wgmma_layout_fits_shared_memory(d, rows):
    """Q [rows][d], two stages of K and V [64][d] and the barriers fit
    227 KB behind a 1024-byte alignment pad, and at one warpgroup up to D
    128 two blocks fit an SM's 228 KB (the source's launch bounds ask
    for 2 or 3); rows of 128 bytes (64 elements) make one swizzle atom,
    D 96 takes 64-byte atoms."""
    t = geo.flash_wgmma_tile(d, rows)
    assert t.error is None and geo.FLASH_WGMMA_STAGES == 2
    assert t.smem == (1024 + rows * d * 2 + 2 * 4 * geo.FLASH_KEYS * d
                      + geo.FLASH_WGMMA_BARRIER_BYTES)
    assert t.smem <= geo.SMEM_BYTES
    if rows == 64 and d <= 128:
        assert 2 * (t.smem + 1024) <= 233472
    if rows == 64 and d <= 64:
        assert 3 * (t.smem + 1024) <= 233472
    assert t.atom == (32 if d == 96 else 64) and d % t.atom == 0
    assert t.threads == 128 * (rows // 64) + 32


@pytest.mark.parametrize("rows", geo.FLASH_ROW_CHOICES)
@pytest.mark.parametrize("d", [64, 96, 128, 256])
def test_wgmma_register_budget_and_the_model_charge_spills(d, rows):
    """The register budget mirrors the source's launch bounds (3 blocks an
    SM at D 64, 2 up to D 128, 1 at D 256 or two warpgroups), and only D
    256 at two warpgroups overruns it (the instance ptxas spills).  The
    cost model charges that tile its serialized work, so it ranks the
    64-row tile first at a long D 256 prefill, as the card measured."""
    from repro_torch.core import cost_model as cm
    from repro_torch.core.tuner import tune_flash_attention
    t = geo.flash_wgmma_tile(d, rows)
    assert t.blocks_per_sm == (1 if rows == 128 else
                               3 if d == 64 else 2 if d <= 128 else 1)
    assert t.spills == (d == 256 and rows == 128)
    feats, _, ok = cm.flash_attention_features(1, 16, 1, 2048, d,
                                               [(rows, 64)])
    assert ok[0] and np.all(feats[0, :3] == 0) and feats[0, 3] > 0
    if d == 256:
        ranked = tune_flash_attention(1, 16, 1, 2048, 256)
        assert [s.block_q for s, _ in ranked] == [64, 128]


@pytest.mark.parametrize("d", [16, 80, 200, 255])
def test_wgmma_layout_refuses_other_head_dims(d):
    assert "head_dim" in geo.flash_wgmma_tile(d).error
    assert geo.flash_body(d, 2) == "mma"


# phi3-mini's engine prompts and generate's batch, and the three family
# prefills: recurrentgemma-9b's 4096 bucket (window 2048, MQA, D 256),
# whisper-large-v3's encoder (1500 frames, no mask) and paligemma-3b's
# 512-token bucket behind its 256 image tokens (MQA, D 256)
PHI3_PROMPTS = (200, 17, 300, 150, 45, 260, 130, 77, 40, 100, 250, 512)
FAMILY_SHAPES = [(256, 4096, True, 2048), (64, 1500, False, None),
                 (256, 768, True, None)]


@pytest.mark.parametrize("rows", geo.FLASH_ROW_CHOICES)
@pytest.mark.parametrize("d", [64, 96, 128, 256])
def test_flash_body_rule_runs_wgmma_at_every_length(d, rows):
    """The head dim and the dtype decide the body, never the length, the
    mask or the rows: every phi3 prefill (buckets 8-512, causal, D 96)
    and the three family prefills take the wgmma body in bf16, with a
    tile it takes at both row counts; float32 keeps its CUDA-core
    body."""
    assert list(inspect.signature(geo.flash_body).parameters) == [
        "d", "elem_bytes"]
    assert geo.flash_body(d, 2) == "wgmma"
    assert geo.flash_body(d, 4) == "float32"
    assert geo.flash_tile_error(d, 2, rows, KEYS) is None
    assert geo.flash_wgmma_tile(d, rows).error is None
    for p in PHI3_PROMPTS:
        assert bucket_length(p) <= 512
    assert {fd for fd, *_ in FAMILY_SHAPES} <= set(geo.FLASH_WGMMA_D)


@pytest.mark.parametrize("d", [16, 80, 200, 224])
def test_flash_body_rule_keeps_mma_for_other_head_dims(d):
    """Head dims outside FLASH_WGMMA_D keep the mma.sync body, whose
    tiles ``flash_tile_error`` then checks."""
    assert geo.flash_body(d, 2) == "mma"
    assert geo.flash_tile_error(d, 2, 128, KEYS) == \
        geo.flash_mma_tile(d, 128).error


def test_flash_wrapper_has_no_body_knob():
    """The wrappers take no body: the rule picks it, and a tile the
    running body refuses is refused by ``flash_tile_error``; on the CPU
    the plain version runs and nothing is counted."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_dispatched, flash_attention_scheduled)
    for fn in (flash_attention, flash_attention_scheduled,
               flash_attention_dispatched):
        assert "body" not in inspect.signature(fn).parameters
    assert not hasattr(flash_attention, "wgmma_launches")
    q, k, v = _inputs(1, 2, 2, 70, 64, seed=4)
    before = flash_attention.launches
    assert torch.equal(flash_attention(q, k, v, block_q=128),
                       flash_attention_ref(q, k, v))
    assert flash_attention.launches == before
    assert "block_kv" in geo.flash_tile_error(96, 2, 64, 32)
