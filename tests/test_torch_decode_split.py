"""The split decode's plan and arithmetic (``csrc/decode_common.cuh``,
decode_split_kernel), on the CPU.

The CUDA body cannot run here, so the plan (``_geometry.decode_plan``)
is checked for what the kernel relies on (every valid key in exactly one
split, paged splits on pool blocks, a plan fixed by static shapes, the
limits), and the kernel's f32 arithmetic is emulated in plain PyTorch
over the plan's splits: only the live splits (those holding a valid
key) are read, each walks its keys in the plan's tiles with an online
softmax (m from -1e30), and a row with more than one live split merges
the partials with exp(m_i - M) factors, MERGE splits at a time (a
running M rescaled where it grows), and one division by the sum of l.
The emulation is held to the plain versions at float32 1e-5, and the
plain versions are held to the Pallas kernels by
``tests/test_torch_kernels.py``.  The packed body (bf16, the KV group's
heads as the rows of tensor-core tiles) is emulated the same way with
its own arithmetic (64-key tiles from each split's first key, bf16
scores' inputs exact in f32, p split into bf16 hi + lo parts) and held
in bf16 to the plain versions and, through them, to the Pallas kernels
in interpret mode, per element at two bf16 ulps + 1e-5.  The card runs
the kernels themselves in ``tests/test_torch_gpu.py`` and
``tests/test_torch_gpu_attention_bodies.py``.
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import REGISTRY  # noqa: E402
from repro.kernels.decode_attention.kernel import (  # noqa: E402
    decode_attention_pallas, paged_decode_attention_pallas)
from repro_torch.kernels import _geometry as geo  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_ref, paged_decode_attention_ref)
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels._checks import scale_q  # noqa: E402

ATOL = 1e-5

# (B, HQ, HKV, D, limit, block_size, elem_bytes)
PLAN_SHAPES = [
    (4, 32, 32, 96, 544, 0, 2),        # generate's cache
    (4, 32, 32, 96, 544, 16, 2),       # the engine's pool, 4 rows
    (1, 32, 32, 96, 544, 16, 2),       # ... 1 row
    (2, 32, 32, 96, 544, 16, 4),
    (1, 16, 1, 256, 512, 0, 2),        # recurrentgemma's heads
    (2, 8, 1, 256, 4096, 16, 4),       # paligemma's heads
    (3, 40, 8, 128, 1000, 0, 2),       # llama4-scout's group 5
    (1, 4, 2, 20, 7, 0, 4),            # fewer keys than a split
    (64, 64, 8, 128, 32768, 16, 2),    # long context, many rows
    (2, 5, 1, 64, 160, 4, 4),
    (1, 1, 1, 1, 300, 100, 2),         # pool blocks wider than a tile
    # the packed body's shapes: recurrentgemma's rolling buffer, the
    # engine's pool at qwen3-32b's and paligemma-3b's heads
    (4, 16, 1, 256, 2048, 0, 2),
    (4, 64, 8, 128, 544, 16, 2),
    (4, 8, 1, 256, 544, 16, 2),
    (1, 8, 1, 256, 4096, 16, 2),
]


def _ids(shapes):
    return ["-".join(map(str, s)) for s in shapes]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=_ids(PLAN_SHAPES))
def test_every_valid_key_falls_in_exactly_one_split(shape):
    plan = geo.decode_plan(*shape)
    assert plan.error is None
    limit = shape[4]
    owner = np.full(limit, -1)
    for i in range(plan.splits):
        lo, hi = plan.split_range(i)
        assert lo < hi
        assert (owner[lo:hi] == -1).all()
        owner[lo:hi] = i
    assert (owner >= 0).all()
    assert plan.splits * plan.split_keys >= limit
    assert (plan.splits - 1) * plan.split_keys < limit
    # any window [lo, hi]: its keys in the live splits lo // SK .. hi // SK
    rng = np.random.default_rng(limit)
    for _ in range(20):
        a, b = sorted(rng.integers(0, limit, 2))
        live = set(range(a // plan.split_keys, b // plan.split_keys + 1))
        assert set(owner[a:b + 1]) == live


@pytest.mark.parametrize("bs", [1, 4, 16, 64, 100, 128])
@pytest.mark.parametrize("rows", [1, 4, 64])
def test_paged_splits_fall_on_pool_blocks(bs, rows):
    plan = geo.decode_plan(rows, 32, 8, 128, 40 * bs, bs, 2)
    assert plan.error is None
    assert plan.split_keys % bs == 0
    for i in range(plan.splits):
        lo, hi = plan.split_range(i)
        assert lo % bs == 0 and (hi % bs == 0 or hi == 40 * bs)


def test_the_plan_depends_on_no_runtime_value():
    """The plan takes static values only: shapes and a schedule's split,
    no pos, no starts, no tensor; the wrappers compute it from them
    before touching either, so a call needs no host sync and a captured
    launch is fixed."""
    params = list(inspect.signature(geo.decode_plan).parameters)
    assert params == ["b", "hq", "hkv", "d", "limit", "block_size",
                      "elem_bytes", "split_keys"]
    assert not hasattr(geo, "body_plan")
    assert list(inspect.signature(dec_ops._plan).parameters) == [
        "name", "q", "hkv", "limit", "block_size", "split_keys"]
    for fn in (dec_ops.decode_attention, dec_ops.paged_decode_attention):
        assert "body" not in inspect.signature(fn).parameters
        assert not hasattr(fn, "packed_launches")
    assert list(inspect.signature(geo.decode_body).parameters) == [
        "hq", "hkv", "d", "elem_bytes"]
    a = geo.decode_plan(4, 32, 32, 96, 544, 0, 2)
    assert a == geo.decode_plan(4, 32, 32, 96, 544, 0, 2)
    assert hash(a) == hash(geo.decode_plan(4, 32, 32, 96, 544, 0, 2))
    with pytest.raises(Exception):
        a.splits = 1                     # frozen


@pytest.mark.parametrize("d,hq,hkv,msg", [
    (257, 8, 1, "head_dim"), (0, 8, 1, "head_dim"), (512, 4, 4, "head_dim"),
    (64, 6, 4, "multiple"), (64, 5, 2, "multiple"),
])
def test_the_plan_and_the_wrappers_refuse(d, hq, hkv, msg):
    assert msg in geo.decode_plan(2, hq, hkv, d, 64, 0, 2).error
    q = torch.zeros(2, hq, 1, d)
    with pytest.raises(ValueError, match=msg):
        dec_ops._check_q("decode_attention", q, hkv)


def test_head_dim_256_with_group_16_is_accepted():
    plan = geo.decode_plan(2, 16, 1, 256, 544, 16, 2)
    assert plan.error is None
    # bf16: the packed body takes the 16 heads of 256 in one block, one
    # 16-row tile; the chunked body (float32) in chunks of 2 heads (512
    # outputs a block)
    assert (plan.body, plan.chunks, plan.head_chunk, plan.m_tiles) == (
        "packed", 1, 16, 1)
    chunked = geo.decode_plan(2, 16, 1, 256, 544, 16, 4)
    assert chunked.error is None
    assert (chunked.body, chunked.chunks, chunked.head_chunk) == (
        "chunked", 8, 2)
    dec_ops._check_q("decode_attention", torch.zeros(2, 16, 1, 256), 1)
    with pytest.raises(ValueError, match="dtype"):
        dec_ops._check_q("decode_attention",
                         torch.zeros(2, 16, 1, 256, dtype=torch.float16), 1)


@pytest.mark.parametrize("eb", [2, 4])
@pytest.mark.parametrize("bs", [0, 16])
def test_every_head_dim_and_group_fits_shared_memory(eb, bs):
    for d in range(1, 257, 5):
        for hq, hkv in ((1, 1), (5, 1), (8, 1), (16, 1), (40, 8), (64, 1)):
            plan = geo.decode_plan(2, hq, hkv, d, 4096, bs, eb)
            assert plan.error is None, (d, hq, hkv, plan.error)
            if plan.body == "packed":      # the whole group in one block
                assert (plan.chunks, plan.head_chunk) == (1, hq // hkv)
                assert 16 * plan.m_tiles >= hq // hkv
            else:
                assert plan.head_chunk <= geo.DEC_MAX_HEADS
            assert plan.head_chunk * plan.chunks >= hq // hkv
            assert plan.smem <= geo.SMEM_BYTES


def test_every_registry_config_fits_the_three_attention_limits():
    """Every config of the JAX package with attention has a head_dim and
    a GQA group that flash, decode and paged decode accept."""
    seen = 0
    for name, cfg in REGISTRY.items():
        if cfg.attention_free:
            continue
        hd, hq, hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
        assert hq % hkv == 0, name
        assert geo.flash_mma_tile(hd).error is None, name
        for bs in (0, 16):
            for eb in (2, 4):
                plan = geo.decode_plan(4, hq, hkv, hd, 4096, bs, eb)
                assert plan.error is None, (name, plan.error)
        dec_ops._check_q(name, torch.zeros(1, hq, 1, hd), hkv)
        seen += 1
    assert seen >= 8


@pytest.mark.parametrize("bs", [0, 16])
def test_packed_plan_serves_every_grouped_config_in_one_chunk(bs):
    """Every registry config whose KV group holds more than one query
    head decodes in bf16 on the packed body: one head chunk (K and V
    read once a KV head), within shared memory, its splits in clusters
    of at most DEC_PACKED_CLUSTER as even as that allows (the grid padded
    to whole clusters by fewer than a cluster of empty blocks), and a
    workspace only for rows of more than one cluster; MHA and float32
    keep the chunked body."""
    seen = 0
    for name, cfg in REGISTRY.items():
        if cfg.attention_free:
            continue
        hd, hq, hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
        for b in (1, 4):
            for limit in (544, 4096, 32768):
                plan = geo.decode_plan(b, hq, hkv, hd, limit, bs, 2)
                assert plan.error is None, (name, plan.error)
                if hq // hkv == 1:
                    assert plan.body == "chunked", name
                    continue
                assert (plan.body, plan.chunks) == ("packed", 1), name
                assert plan.head_chunk == hq // hkv
                assert plan.smem <= geo.SMEM_BYTES
                assert plan.split_keys >= geo.DEC_PACKED_TILE_KEYS or \
                    plan.splits == 1
                assert 1 <= plan.cluster <= geo.DEC_PACKED_CLUSTER
                assert plan.grid_splits % plan.cluster == 0
                assert 0 <= plan.grid_splits - plan.splits < plan.cluster
                clusters = plan.grid_splits // plan.cluster
                assert plan.cluster == -(-plan.splits // clusters)
                assert plan.workspace_floats == (
                    0 if clusters == 1
                    else plan.rows * clusters * plan.part_floats)
                assert plan.part_floats % 4 == 0      # float4 rows
                seen += b == 1 and limit == 544
        assert geo.decode_plan(4, hq, hkv, hd, 4096, bs, 4).body == "chunked"
    assert seen >= 6


@pytest.mark.parametrize("split", [None, 32, 64, 128, 256])
def test_packed_splits_of_one_tile_take_one_stage(split):
    """A packed split of at most one 64-key tile stages one K/V tile, not
    two, so two blocks fit an SM at recurrentgemma's head_dim 256 and its
    clusters can be placed; longer splits double-buffer."""
    plan = geo.decode_plan(4, 16, 1, 256, 2048, 0, 2, split)
    stages = geo.dec_packed_stages(plan.split_keys)
    assert stages == (1 if plan.split_keys <= geo.DEC_PACKED_TILE_KEYS
                      else 2)
    assert plan.smem == geo.dec_packed_smem(256, plan.tile_keys, 1, 0,
                                            stages)
    blocks_per_sm = 233472 // (plan.smem + 1024)
    assert blocks_per_sm == (2 if stages == 1 else 1)
    # the block's combine partial (acc, m, l of the group) fits the
    # stages it reuses
    assert (16 * 256 + 2 * 16) * 4 <= 2 * stages * 64 * (256 + 8) * 2


@pytest.mark.parametrize("d,hq,hkv,eb", [
    (80, 8, 1, 2), (128, 8, 1, 4), (128, 128, 1, 2),
])
def test_the_packed_body_is_refused_where_it_does_not_apply(d, hq, hkv, eb):
    """A head dim outside DEC_PACKED_D, float32 and a group past 64 run
    the chunked body: the plan is the chunked one and runs."""
    assert geo.decode_body(hq, hkv, d, eb) == "chunked"
    plan = geo.decode_plan(2, hq, hkv, d, 512, 0, eb)
    assert plan.error is None and plan.body == "chunked"
    assert plan.m_tiles == 0 and plan.cluster == 1


# phi3-mini's decodes: 32 heads of 96 (MHA) over the engine's pool of
# 16-key blocks (34 a row) at 1, 2 and 4 rows, and generate's contiguous
# [4, 32, 544, 96] cache
PHI3_DECODES = [(rows, 34 * 16, 16) for rows in (1, 2, 4)] + [(4, 544, 0)]


@pytest.mark.parametrize("rows,limit,bs", PHI3_DECODES,
                         ids=[f"r{c[0]}-{'paged' if c[2] else 'contig'}"
                              for c in PHI3_DECODES])
def test_phi3_decode_runs_the_chunked_body_at_group_one(rows, limit, bs):
    """At a group of one the rule keeps the chunked body (the packed one
    lost at phi3's shapes on the card: PERF.md): one head a chunk, a
    tile of 64 keys (48 in float32, whose K and V rows are twice as
    wide), splits for about DEC_TARGET_BLOCKS blocks, no cluster, within
    shared memory."""
    assert geo.decode_body(32, 32, 96, 2) == "chunked"
    for eb in (2, 4):
        plan = geo.decode_plan(rows, 32, 32, 96, limit, bs, eb)
        assert plan.error is None and plan.body == "chunked"
        assert (plan.head_chunk, plan.chunks, plan.m_tiles,
                plan.cluster) == (1, 1, 0, 1)
        assert plan.tile_keys == (64 if eb == 2 else 48)
        assert plan.split_keys % max(bs, 16) == 0
        assert plan.smem <= geo.SMEM_BYTES
        assert plan.blocks == rows * 32 * plan.splits
        assert plan.blocks <= geo.DEC_TARGET_BLOCKS + rows * 32


# ---------------------------------------------------------------- emulation

MERGE = 4       # DEC_MERGE of csrc/decode_common.cuh: splits a batch


def split_decode_emulation(plan, q, kg, vg, lo, hi):
    """The kernel's f32 arithmetic over ``plan``'s splits.  q [B,HQ,1,D];
    kg/vg [B,HKV,limit,D] (a paged pool already gathered through the
    tables); lo/hi: each row's first and last valid key.  Returns the
    output and the keys each row read."""
    b, hq, _, d = q.shape
    hkv = kg.shape[1]
    group = hq // hkv
    qs = scale_q(q).float()[:, :, 0]
    out = torch.zeros(b, hq, d)
    read = [set() for _ in range(b)]
    sk, tk = plan.split_keys, plan.tile_keys
    for r in range(b):
        if lo[r] > hi[r]:
            continue                        # no valid key: zeros
        first, last = lo[r] // sk, hi[r] // sk
        for h in range(hkv):
            heads = slice(h * group, (h + 1) * group)
            parts = []
            for sp in range(first, last + 1):
                klo, khi = max(lo[r], sp * sk), min(hi[r], sp * sk + sk - 1)
                assert klo <= khi
                m = torch.full((group,), -1e30)
                l = torch.zeros(group)
                acc = torch.zeros(group, d)
                for t0 in range(klo, khi + 1, tk):
                    keys = range(t0, min(t0 + tk, khi + 1))
                    read[r].update(keys)
                    kk = kg[r, h, t0:keys[-1] + 1].float()
                    vv = vg[r, h, t0:keys[-1] + 1].float()
                    s = qs[r, heads] @ kk.T                  # [group, nk]
                    m_new = torch.maximum(m, s.amax(-1))
                    alpha = torch.exp(m - m_new)
                    p = torch.exp(s - m_new[:, None])
                    l = l * alpha + p.sum(-1)
                    acc = acc * alpha[:, None] + p @ vv
                    m = m_new
                parts.append((m, l, acc))
            if len(parts) == 1:
                m, l, acc = parts[0]
                out[r, heads] = acc / l[:, None]
                continue
            big_m = torch.full((group,), -1e30)
            total = torch.zeros(group)
            x = torch.zeros(group, d)
            for k0 in range(0, len(parts), MERGE):
                batch = parts[k0:k0 + MERGE]
                m_new = torch.maximum(
                    big_m, torch.stack([p[0] for p in batch]).amax(0))
                c0 = torch.exp(big_m - m_new)
                total, x = total * c0, x * c0[:, None]
                for m, l, acc in batch:
                    c = torch.exp(m - m_new)
                    total = total + l * c
                    x = x + acc * c[:, None]
                big_m = m_new
            out[r, heads] = x / total[:, None]
    return out[:, :, None].to(q.dtype), read


def packed_decode_emulation(plan, q, kg, vg, lo, hi):
    """The packed body's arithmetic over ``plan``'s splits (bf16 q, k, v):
    the group's scaled q rows against 64-key tiles from each split's
    first valid key in f32 (the products of bf16 values are exact), an
    online softmax per row, P V in f32 from p's bf16 hi + lo parts; then
    the combine in two levels: the splits of each cluster (empty
    partials for splits without a key), and, for a row of more than one
    live cluster, the clusters' partials; one rounding to bf16.  Returns
    the output and the keys each row read."""
    b, hq, _, d = q.shape
    hkv = kg.shape[1]
    group = hq // hkv
    qs = scale_q(q).float()[:, :, 0]
    out = torch.zeros(b, hq, d)
    read = [set() for _ in range(b)]
    sk, tk, cl = plan.split_keys, plan.tile_keys, plan.cluster

    def combine(parts):
        big = torch.stack([p[0] for p in parts]).amax(0)
        total = torch.zeros(group)
        x = torch.zeros(group, d)
        for m, l, acc in parts:
            c = torch.exp(m - big)
            total = total + l * c
            x = x + acc * c[:, None]
        return big, total, x

    for r in range(b):
        first, last = lo[r] // sk, hi[r] // sk
        live = lo[r] <= hi[r]
        for h in range(hkv):
            heads = slice(h * group, (h + 1) * group)
            parts = []
            for sp in range(plan.grid_splits):
                m = torch.full((group,), -1e30)
                l = torch.zeros(group)
                acc = torch.zeros(group, d)
                if live and first <= sp <= last:
                    klo = max(lo[r], sp * sk)
                    khi = min(hi[r], sp * sk + sk - 1)
                    for t0 in range(klo, khi + 1, tk):
                        keys = range(t0, min(t0 + tk, khi + 1))
                        read[r].update(keys)
                        kk = kg[r, h, t0:keys[-1] + 1].float()
                        vv = vg[r, h, t0:keys[-1] + 1].float()
                        s = qs[r, heads] @ kk.T
                        m_new = torch.maximum(m, s.amax(-1))
                        alpha = torch.exp(m - m_new)
                        p = torch.exp(s - m_new[:, None])
                        l = l * alpha + p.sum(-1)
                        p_hi = p.to(torch.bfloat16).float()
                        p_lo = (p - p_hi).to(torch.bfloat16).float()
                        acc = acc * alpha[:, None] + p_hi @ vv + p_lo @ vv
                        m = m_new
                parts.append((m, l, acc))
            clusters = [combine(parts[c0:c0 + cl])
                        for c0 in range(0, plan.grid_splits, cl)]
            if not live:
                continue                    # zeros
            ours = clusters[first // cl:last // cl + 1]
            if len(ours) == 1:
                _, total, x = ours[0]
            else:
                _, total, x = combine(ours)
            out[r, heads] = x / total[:, None]
    return out[:, :, None].to(q.dtype), read


def _share_of_tol(got, want):
    """Worst |got - want| as a share of two bf16 ulps of |want| + 1e-5."""
    diff = (got.float() - want.float()).abs()
    mag = want.float().abs().clamp_min(2.0 ** -126)
    allowed = 2 * torch.exp2(torch.floor(torch.log2(mag)) - 7) + 1e-5
    return (diff / allowed).max().item()


def _to_jax(x):
    return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)


def _from_jax(x):
    return torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        torch.bfloat16)


def _rand(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


# (B, HQ, HKV, S, D, pos, starts, a row merges): row 1 of the first case
# has starts past pos (no valid key: zeros); starts past the first
# splits; the last case's windows lie inside one split each; float32
# D 256 walks two 16-key tiles a split; the second case's row merges 29
# live splits in eight batches.
CONTIG_CASES = [
    (3, 4, 2, 200, 16, [199, 10, 150], [0, 20, 100], True),
    (1, 4, 1, 1024, 16, [900], [5], True),
    (2, 16, 1, 300, 256, [299, 40], [250, 0], True),
    (2, 5, 1, 100, 64, [99, 70], [0, 65], True),
    (2, 8, 1, 96, 256, [95, 33], [70, 33], False),
    # the packed body in bf16: recurrentgemma's heads over a wrapped
    # window (every slot valid) and at a pos inside the first split; a
    # group of 5 (llama4-scout) with starts past the first splits and a
    # row with no valid key; a group of 24 (two 16-row tiles) whose
    # windows lie in one split each
    (2, 16, 1, 512, 256, [900, 40], [0, 0], True, "packed"),
    (3, 10, 2, 320, 128, [319, 50, 7], [130, 60, 0], True, "packed"),
    (2, 24, 1, 256, 64, [255, 100], [250, 70], False, "packed"),
]


@pytest.mark.parametrize("case", CONTIG_CASES,
                         ids=[f"{c[1]}/{c[2]}-d{c[4]}" + (
                             f"-{c[8]}" if len(c) > 8 else "")
                             for c in CONTIG_CASES])
def test_split_merge_emulation_matches_decode_ref(case):
    b, hq, hkv, s, d, pos, starts, merges = case[:8]
    packed = len(case) > 8
    rng = np.random.default_rng(s + d)
    q, k, v = _rand(rng, b, hq, 1, d), _rand(rng, b, hkv, s, d), \
        _rand(rng, b, hkv, s, d)
    if packed:
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    plan = geo.decode_plan(b, hq, hkv, d, s, 0, 2 if packed else 4)
    assert plan.body == ("packed" if packed else "chunked")
    assert plan.splits > 1
    lo = [max(x, 0) for x in starts]
    hi = [min(p, s - 1) for p in pos]
    emulate = packed_decode_emulation if packed else split_decode_emulation
    got, read = emulate(plan, q, k, v, lo, hi)
    want = decode_attention_ref(q, k, v, torch.tensor(pos),
                                starts=torch.tensor(starts))
    if packed:
        assert _share_of_tol(got, want) <= 1.0
        # the plain version against the Pallas kernel (interpret), on the
        # rows with a valid key (the TPU kernel's other rows are its own)
        ref = _from_jax(decode_attention_pallas(
            *(_to_jax(x) for x in (q, k, v)),
            jnp.asarray(np.array(pos, np.int32)),
            starts=jnp.asarray(np.array(starts, np.int32)), block_kv=64,
            interpret=True))
        for r in range(b):
            if lo[r] <= hi[r]:
                assert _share_of_tol(want[r], ref[r]) <= 1.0
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    for r in range(b):
        assert read[r] == set(range(lo[r], hi[r] + 1))   # the window only
        if lo[r] > hi[r]:
            assert (got[r] == 0).all()
    live = [hi[r] // plan.split_keys - lo[r] // plan.split_keys + 1
            for r in range(b) if lo[r] <= hi[r]]
    assert plan.splits > min(live)            # a row with empty splits
    assert (max(live) > 1) == merges


# (HQ, HKV, D, bs, MB, pos): pos -1 reads no key (zeros)
PAGED_CASES = [
    (16, 1, 256, 16, 20, [319, 3]),
    (5, 1, 64, 4, 40, [159, -1]),
    (4, 2, 16, 16, 12, [17, 190]),
    # the packed body in bf16: qwen3-32b's heads (group 8 on 8 KV heads,
    # D 128) and paligemma-3b's (group 8 on one, D 256) over the engine's
    # 16-slot pool blocks
    (64, 8, 128, 16, 34, [17, 543, -1], "packed"),
    (8, 1, 256, 16, 34, [300, 100], "packed"),
]


@pytest.mark.parametrize("case", PAGED_CASES,
                         ids=[f"{c[0]}/{c[1]}-d{c[2]}-bs{c[3]}" + (
                             f"-{c[6]}" if len(c) > 6 else "")
                             for c in PAGED_CASES])
def test_split_merge_emulation_matches_paged_ref(case):
    hq, hkv, d, bs, mb, pos = case[:6]
    packed = len(case) > 6
    b = len(pos)
    rng = np.random.default_rng(d + bs)
    nb = 1 + b * mb
    q = _rand(rng, b, hq, 1, d)
    kp, vp = _rand(rng, nb, hkv, bs, d), _rand(rng, nb, hkv, bs, d)
    if packed:
        q, kp, vp = (t.to(torch.bfloat16) for t in (q, kp, vp))
    tables = torch.from_numpy(
        rng.permutation(np.arange(1, nb)).reshape(b, mb).astype(np.int32))
    plan = geo.decode_plan(b, hq, hkv, d, mb * bs, bs, 2 if packed else 4)
    assert plan.body == ("packed" if packed else "chunked")
    assert plan.splits > 1 and plan.split_keys % bs == 0
    idx = tables.long()
    kg = kp[idx].permute(0, 2, 1, 3, 4).reshape(b, hkv, mb * bs, d)
    vg = vp[idx].permute(0, 2, 1, 3, 4).reshape(b, hkv, mb * bs, d)
    hi = [min(p, mb * bs - 1) for p in pos]
    emulate = packed_decode_emulation if packed else split_decode_emulation
    got, read = emulate(plan, q, kg, vg, [0] * b, hi)
    want = paged_decode_attention_ref(q, kp, vp, tables, torch.tensor(pos))
    if packed:
        assert _share_of_tol(got, want) <= 1.0
        ref = _from_jax(paged_decode_attention_pallas(
            *(_to_jax(x) for x in (q, kp, vp)), jnp.asarray(tables.numpy()),
            jnp.asarray(np.array(pos, np.int32)), interpret=True))
        for r in range(b):
            if hi[r] >= 0:
                assert _share_of_tol(want[r], ref[r]) <= 1.0
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    for r in range(b):
        # pool blocks past pos are never touched
        assert all(kpos // bs <= max(hi[r], -1) // bs for kpos in read[r])
        if hi[r] < 0:
            assert (got[r] == 0).all()


def test_decode_timeline_finds_every_anchor():
    """``launch/decode_timeline.py`` splices its stamps into a copy of
    ``decode_common.cuh`` at text anchors, for the chunked and the packed
    body: each must be found once, so a kernel edit that moves one fails
    here rather than on the card."""
    from repro_torch.launch.decode_timeline import (
        ANCHORS, PACKED_ANCHORS, PACKED_STAMPS, STAMPS, instrumented_source)
    src = instrumented_source()
    # every anchor, the direct writes, the merges' ends and the packed
    # merging split
    assert src.count("] = stamp_ns();") == (len(ANCHORS) + 2
                                           + len(PACKED_ANCHORS) + 3)
    for k in range(len(STAMPS)):
        assert f"* 8 + {k}] = stamp_ns();" in src, STAMPS[k]
    packed = src[src.index("decode_packed_kernel(const DecArgs"):]
    for k in range(len(PACKED_STAMPS)):
        assert f"* 8 + {k}] = stamp_ns();" in packed, PACKED_STAMPS[k]


def test_decode_timeline_cases_are_phi3s_inputs():
    """The timeline's ``time`` cases are phi3-mini's main-path calls:
    flash at every engine bucket 8-512 without and with left-pad starts
    at both row counts and generate's [4, 32, 512, 96]; the paged decode
    at 1, 2 and 4 rows over the engine's pool; generate's contiguous
    decode at three positions.  On the CPU each wrapper runs its plain
    version; the rule gives flash the wgmma body and the decodes the
    chunked one; the bounds count what the inputs need."""
    from repro_torch.launch import decode_timeline as tl
    cases = tl.phi3_cases(torch.device("cpu"))
    kinds = [c[0] for c in cases]
    assert kinds.count("flash_attention") == 7 * 2 * 2 + 1
    assert kinds.count("paged_decode_attention") == 3
    assert kinds.count("decode_attention") == len(tl.CONTIG_POS) == 3
    wrappers = {"flash_attention": tl.flash_attention,
                "decode_attention": tl.decode_attention,
                "paged_decode_attention": tl.paged_decode_attention}
    for kernel, label, args, kw, (b_ms, b_by), _ in cases:
        assert b_ms > 0 and b_by == "bytes", label
        plain = {k: v for k, v in kw.items() if k != "block_q"}
        assert torch.equal(wrappers[kernel](*args, **kw),
                           tl.REFS[kernel](*args, **plain))
        assert tl.rule_body(kernel, args[0], args[1]) == (
            "wgmma" if kernel == "flash_attention" else "chunked")


def test_decode_timeline_imports_a_parent_beside_this_tree():
    """``--parent DIR`` imports another checkout's package beside this
    tree's (``launch/parent_tree.py``; here the tree itself): other
    module objects, its own build directory, this tree's modules set
    back, its wrappers running its plain versions on the CPU."""
    import sys
    from pathlib import Path
    from repro_torch import kernels
    from repro_torch.core import tuner
    from repro_torch.launch import decode_timeline as tl
    root = Path(tl.__file__).resolve().parents[3]
    before = {k: v for k, v in sys.modules.items()
              if k.startswith("repro_torch")}
    parent = tl.load_parent(root)
    assert {k: v for k, v in sys.modules.items()
            if k.startswith("repro_torch")} == before
    fa = parent.wrappers["flash_attention"]
    assert fa is not kernels.flash_attention and fa.launches == 0
    assert parent.build is not kernels._build
    assert parent.build.BUILD_DIR == kernels._build.BUILD_DIR
    assert parent.geo is not geo and parent.tuner is not tuner
    assert parent.tuner.geo is parent.geo
    q = torch.randn(1, 2, 9, 96)
    assert torch.equal(fa(q, q, q), tl.REFS["flash_attention"](q, q, q))


# (S, starts): phi3's short buckets, without and with left padding
EXACT_CASES = [(8, None), (8, 3), (16, None), (16, 4), (64, None), (64, 19)]


@pytest.mark.parametrize("s,start", EXACT_CASES)
def test_decode_timeline_exact_reference_rounds_to_the_plain_version(s,
                                                                     start):
    """The timeline's float64 attention (``err64``'s reference) is the
    function the plain version computes: at phi3's heads the plain bf16
    output is within one bf16 ulp of it, its rows before ``starts`` are
    zeros in both, and ``err64`` reads zero for the exact value rounded
    to bf16."""
    from repro_torch.launch import decode_timeline as tl
    g = torch.Generator().manual_seed(s)
    q, k, v = (torch.randn(1, 32, s, 96, generator=g).to(torch.bfloat16)
               for _ in range(3))
    kw = {} if start is None else {"starts": torch.tensor([start])}
    keep = torch.ones(s, s, dtype=torch.bool).tril()
    keep = keep & (torch.arange(s)[None, :] >= (start or 0))
    exact = tl.exact_attention(q, k, v, keep)
    plain = tl.flash_attention_ref(q, k, v, **kw)
    ulp = torch.exp2(torch.floor(torch.log2(
        exact.abs().clamp_min(2.0 ** -126))) - 7)
    assert ((plain.double() - exact).abs() <= ulp + 1e-6).all()
    if start:
        assert not exact[:, :, :start].any() and not plain[:, :, :start].any()
    e = tl.err64(plain, exact)
    assert e["max"] < 2 ** -7 and e["off"] < 0.05
    assert tl.err64(exact.to(torch.bfloat16), exact)["off"] == 0.0


def test_grown_ticket_counters_keep_the_old_ones(monkeypatch):
    """A stream's ticket counters grow when a plan needs more of them;
    the counters they replace stay referenced (a graph captured earlier
    holds their address), and a plan that fits reuses the current ones.
    The card is stood in for by the CPU (one stream, no capture)."""
    monkeypatch.setattr(dec_ops._build, "stream_handle", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(dec_ops, "_TICKETS", {})
    monkeypatch.setattr(dec_ops, "_RETIRED", [])
    cpu = torch.device("cpu")
    small = geo.decode_plan(1, 32, 32, 64, 4096, 0, 2)
    big = geo.decode_plan(160, 32, 32, 64, 64, 0, 2)
    assert small.tickets <= 4096 < big.tickets
    _, first = dec_ops._scratch(small, cpu)
    assert first.numel() == 4096 and not first.any()
    assert dec_ops._scratch(small, cpu)[1] is first
    _, grown = dec_ops._scratch(big, cpu)
    assert grown.numel() == big.tickets and not grown.any()
    assert dec_ops._RETIRED == [first]
    assert dec_ops._scratch(small, cpu)[1] is grown
