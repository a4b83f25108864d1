"""The Hopper attention bodies against their plain versions, on the
card: flash attention's wgmma + TMA body (``csrc/flash_wgmma.cu``, the
one bf16 body at the models' head dims) and the packed split decode
(``csrc/decode_common.cuh``, decode_packed_kernel, for KV groups of 2
and more), at the edge shapes their tiling has to get right (S not a
multiple of the tile and below one tile, a GQA group of 5, window
edges, left-padded ``starts`` at and near S, a paged pool, groups past
one 16-row tile).  The rule (``_geometry.flash_body`` /
``decode_body``) picks each call's body.  The file imports no JAX and
skips without a card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu_attention_bodies.py -q

Tolerance, per element: two bf16 ulps of the plain value plus 1e-5.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (decode_attention, flash_attention,  # noqa: E402
                                 paged_decode_attention)
from repro_torch.kernels._geometry import (decode_body,  # noqa: E402
                                           decode_plan, flash_body)
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_ref, paged_decode_attention_ref)
from repro_torch.kernels.flash_attention import flash_attention_ref  # noqa: E402


@pytest.fixture
def cuda_device():
    """The card; skips without one (decided here, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


def _share_of_tol(got, want):
    """Worst |got - want| as a share of two bf16 ulps of |want| + 1e-5."""
    diff = (got.float() - want.float()).abs()
    mag = want.float().abs().clamp_min(2.0 ** -126)
    allowed = 2 * torch.exp2(torch.floor(torch.log2(mag)) - 7) + 1e-5
    return (diff / allowed).max().item()


def _rn(dev, seed, *shape):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)


# (B, HQ, HKV, S, D, rows, kwargs)
FLASH_CASES = [
    (4, 20, 20, 1500, 64, 64, {"causal": False}),     # whisper's encoder
    (4, 20, 20, 1500, 64, 128, {"causal": False}),
    (1, 16, 1, 1100, 256, 64, {"window": 700}),       # MQA, window edges
    (1, 16, 1, 1100, 256, 128, {"window": 700}),
    (2, 10, 2, 777, 128, 128, {"starts": [0, 300]}),  # group 5, left pad
    (2, 8, 8, 600, 96, 64, {"starts": [37, 599]}),    # D 96, one real row
    (1, 4, 4, 130, 64, 128, {}),                      # S below two tiles
    (2, 4, 2, 700, 128, 64, {"window": 64, "starts": [5, 650]}),
    # phi3-mini's 32 heads of 96 at its shortest buckets
    (1, 32, 32, 8, 96, 64, {"starts": [3]}),
    (2, 32, 32, 16, 96, 128, {"starts": [15, 16]}),
    (1, 32, 32, 40, 96, 128, {}),
    (1, 32, 32, 512, 96, 64, {"starts": [212]}),
]


@pytest.mark.gpu
@pytest.mark.parametrize("b,hq,hkv,s,d,rows,kw", FLASH_CASES,
                         ids=[f"{c[0]}x{c[1]}/{c[2]}-s{c[3]}-d{c[4]}-r{c[5]}-"
                              + "-".join(c[6]) for c in FLASH_CASES])
def test_wgmma_flash_body_matches_plain(cuda_device, b, hq, hkv, s, d, rows,
                                        kw):
    dev = cuda_device
    q = _rn(dev, s + d, b, hq, s, d)
    k, v = _rn(dev, s + 1, b, hkv, s, d), _rn(dev, s + 2, b, hkv, s, d)
    kw = {n: torch.tensor(x, device=dev) if n == "starts" else x
          for n, x in kw.items()}
    assert flash_body(d, 2) == "wgmma"
    before = flash_attention.launches
    got = flash_attention(q, k, v, block_q=rows, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_ref(q, k, v, **kw)
    assert _share_of_tol(got, want) <= 1.0


@pytest.mark.gpu
def test_flash_rule_picks_wgmma_for_the_family_shapes(cuda_device):
    """The rule gives every model's head dim the wgmma body at every
    length (whisper's encoder, a 512-token prefill) and another head dim
    the mma.sync body; each call launches once and holds to plain."""
    assert flash_body(64, 2) == flash_body(96, 2) == "wgmma"
    assert flash_body(80, 2) == "mma"
    q = _rn(cuda_device, 3, 1, 4, 1500, 64)
    q80 = _rn(cuda_device, 4, 1, 4, 300, 80)
    before = flash_attention.launches
    got = [flash_attention(q, q, q, causal=False),
           flash_attention(q[:, :, :512].contiguous(),
                           q[:, :, :512].contiguous(),
                           q[:, :, :512].contiguous()),
           flash_attention(q80, q80, q80)]
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 3
    assert _share_of_tol(got[0], flash_attention_ref(
        q, q, q, causal=False)) <= 1.0
    assert _share_of_tol(got[2], flash_attention_ref(q80, q80, q80)) <= 1.0


# (B, HQ, HKV, S, D, pos, starts)
DECODE_CASES = [
    (4, 16, 1, 2048, 256, [2048, 2500, 3000, 4127], None),   # rolling wrap
    (4, 40, 8, 544, 128, [512, 300, 17, 543], [472, 0, 3, 500]),  # group 5
    (2, 64, 8, 1000, 128, [999, 40], [0, 33]),                # group 8
    (2, 8, 1, 600, 256, [599, 10], [590, 11]),                 # no valid key
    (3, 24, 1, 300, 64, [299, 100, 0], None),                 # two tiles
    (1, 64, 1, 400, 96, [399], [7]),                          # four tiles
    (2, 2, 1, 77, 64, [76, 5], None),
]


@pytest.mark.gpu
@pytest.mark.parametrize("b,hq,hkv,s,d,pos,starts", DECODE_CASES,
                         ids=[f"{c[1]}/{c[2]}-s{c[3]}-d{c[4]}"
                              for c in DECODE_CASES])
def test_packed_decode_body_matches_plain(cuda_device, b, hq, hkv, s, d, pos,
                                          starts):
    dev = cuda_device
    q = _rn(dev, d, b, hq, 1, d)
    k, v = _rn(dev, s, b, hkv, s, d), _rn(dev, s + 1, b, hkv, s, d)
    p = torch.tensor(pos, device=dev)
    st = None if starts is None else torch.tensor(starts, device=dev)
    assert decode_body(hq, hkv, d, 2) == "packed"
    got = decode_attention(q, k, v, p, starts=st)
    torch.cuda.synchronize()
    want = decode_attention_ref(q, k, v, p, starts=st)
    assert _share_of_tol(got, want) <= 1.0
    # a schedule's split replaces the plan's and keeps the body
    got = decode_attention(q, k, v, p, starts=st, block_kv=64)
    assert _share_of_tol(got, want) <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("body", ["packed", "chunked"])
def test_decode_ignores_nan_outside_the_window(cuda_device, body):
    """NaN in the cache before ``starts`` and past ``pos`` (where the
    packed body's first tile of a split is fetched before ``pos`` is
    known, without starts) leaves the output finite and equal to the
    plain value over a cache with zeros there: MQA on the packed body,
    phi3's MHA on the chunked one."""
    dev = cuda_device
    b, s = 4, 544
    hq, hkv, d = (16, 1, 256) if body == "packed" else (32, 32, 96)
    assert decode_body(hq, hkv, d, 2) == body
    q = _rn(dev, 11, b, hq, 1, d)
    k, v = _rn(dev, 12, b, hkv, s, d), _rn(dev, 13, b, hkv, s, d)
    pos, starts = [3, 70, 300, 543], [0, 0, 9, 200]
    keys = torch.arange(s, device=dev)
    p, st = torch.tensor(pos, device=dev), torch.tensor(starts, device=dev)
    outside = ((keys[None, :] > p[:, None])
               | (keys[None, :] < st[:, None]))[:, None, :, None]
    nan = torch.tensor(float("nan"), device=dev, dtype=torch.bfloat16)
    got = decode_attention(q, k.where(~outside, nan), v.where(~outside, nan),
                           p, starts=st)
    want = decode_attention_ref(q, k.where(~outside, 0), v.where(~outside, 0),
                                p, starts=st)
    assert torch.isfinite(got.float()).all()
    assert _share_of_tol(got, want) <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("hq,hkv,d", [(64, 8, 128), (8, 1, 256), (40, 8, 128),
                                      (16, 1, 256)])
def test_packed_paged_decode_matches_plain(cuda_device, hq, hkv, d):
    dev = cuda_device
    bs, mb, pos = 16, 34, [17, 300, 543, 0]
    rows = len(pos)
    nb = 1 + rows * mb
    q = _rn(dev, hq, rows, hq, 1, d)
    kp, vp = _rn(dev, 5, nb, hkv, bs, d), _rn(dev, 6, nb, hkv, bs, d)
    perm = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(7))
    tables = (perm + 1).reshape(rows, mb).to(torch.int32).to(dev)
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    assert decode_body(hq, hkv, d, 2) == "packed"
    got = paged_decode_attention(q, kp, vp, tables, p)
    torch.cuda.synchronize()
    assert _share_of_tol(got, paged_decode_attention_ref(
        q, kp, vp, tables, p)) <= 1.0


@pytest.mark.gpu
def test_packed_body_is_refused_where_it_does_not_apply(cuda_device):
    """float32 and head dims outside the packed set run the chunked body
    (the rule), whose plan the wrapper launches."""
    dev = cuda_device
    q = _rn(dev, 21, 1, 4, 1, 64).float()
    k = _rn(dev, 22, 1, 1, 64, 64).float()
    assert decode_body(4, 1, 64, 4) == "chunked"
    assert decode_plan(1, 4, 1, 64, 64, 0, 4).body == "chunked"
    assert _share_of_tol(decode_attention(q, k, k, 10).to(torch.bfloat16),
                         decode_attention_ref(q, k, k, 10).to(
                             torch.bfloat16)) <= 1.0
    assert decode_body(4, 1, 80, 2) == "chunked"
    assert decode_plan(1, 4, 1, 80, 64, 0, 2).body == "chunked"
    q, k = _rn(dev, 23, 1, 4, 1, 80), _rn(dev, 24, 1, 1, 64, 80)
    assert _share_of_tol(decode_attention(q, k, k, 10),
                         decode_attention_ref(q, k, k, 10)) <= 1.0
