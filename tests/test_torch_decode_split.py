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
``tests/test_torch_kernels.py``.  The card runs the kernel itself in
``tests/test_torch_gpu.py``.
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import REGISTRY  # noqa: E402
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
    """The plan takes static shapes only: no pos, no starts, no tensor;
    the wrappers compute it from shapes before touching either, so a
    call needs no host sync and a captured launch is fixed."""
    params = list(inspect.signature(geo.decode_plan).parameters)
    assert params == ["b", "hq", "hkv", "d", "limit", "block_size",
                      "elem_bytes"]
    assert list(inspect.signature(dec_ops._plan).parameters) == [
        "name", "q", "hkv", "limit", "block_size"]
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
    # 16 heads of 256: chunks of 2 heads (512 outputs a block)
    assert (plan.chunks, plan.head_chunk) == (8, 2)
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
]


@pytest.mark.parametrize("case", CONTIG_CASES,
                         ids=[f"{c[1]}/{c[2]}-d{c[4]}" for c in CONTIG_CASES])
def test_split_merge_emulation_matches_decode_ref(case):
    b, hq, hkv, s, d, pos, starts, merges = case
    rng = np.random.default_rng(s + d)
    q, k, v = _rand(rng, b, hq, 1, d), _rand(rng, b, hkv, s, d), \
        _rand(rng, b, hkv, s, d)
    plan = geo.decode_plan(b, hq, hkv, d, s, 0, 4)
    assert plan.splits > 1
    lo = [max(x, 0) for x in starts]
    hi = [min(p, s - 1) for p in pos]
    got, read = split_decode_emulation(plan, q, k, v, lo, hi)
    want = decode_attention_ref(q, k, v, torch.tensor(pos),
                                starts=torch.tensor(starts))
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
]


@pytest.mark.parametrize("case", PAGED_CASES,
                         ids=[f"{c[0]}/{c[1]}-d{c[2]}-bs{c[3]}"
                              for c in PAGED_CASES])
def test_split_merge_emulation_matches_paged_ref(case):
    hq, hkv, d, bs, mb, pos = case
    b = len(pos)
    rng = np.random.default_rng(d + bs)
    nb = 1 + b * mb
    q = _rand(rng, b, hq, 1, d)
    kp, vp = _rand(rng, nb, hkv, bs, d), _rand(rng, nb, hkv, bs, d)
    tables = torch.from_numpy(
        rng.permutation(np.arange(1, nb)).reshape(b, mb).astype(np.int32))
    plan = geo.decode_plan(b, hq, hkv, d, mb * bs, bs, 4)
    assert plan.splits > 1 and plan.split_keys % bs == 0
    idx = tables.long()
    kg = kp[idx].permute(0, 2, 1, 3, 4).reshape(b, hkv, mb * bs, d)
    vg = vp[idx].permute(0, 2, 1, 3, 4).reshape(b, hkv, mb * bs, d)
    hi = [min(p, mb * bs - 1) for p in pos]
    got, read = split_decode_emulation(plan, q, kg, vg, [0] * b, hi)
    want = paged_decode_attention_ref(q, kp, vp, tables, torch.tensor(pos))
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    for r in range(b):
        # pool blocks past pos are never touched
        assert all(kpos // bs <= max(hi[r], -1) // bs for kpos in read[r])
        if hi[r] < 0:
            assert (got[r] == 0).all()


def test_decode_timeline_finds_every_anchor():
    """``launch/decode_timeline.py`` splices its stamps into a copy of
    ``decode_common.cuh`` at text anchors: each must be found once, so a
    kernel edit that moves one fails here rather than on the card."""
    from repro_torch.launch.decode_timeline import (ANCHORS, STAMPS,
                                                    instrumented_source)
    src = instrumented_source()
    # every anchor, the direct write and the merge's end
    assert src.count("] = stamp_ns();") == len(ANCHORS) + 2
    for k in range(len(STAMPS)):
        assert f"* 8 + {k}] = stamp_ns();" in src, STAMPS[k]


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
