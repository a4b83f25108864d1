"""The port's three attention kernels against the JAX package's Pallas
kernels (interpret mode, as the JAX tests run them on the CPU).

On the CPU each wrapper runs its kernel's plain version, so these tests
hold the plain versions to the Pallas functions, float32, atol 1e-5
(both sum float32 products in a different order; 1e-5 is ~100 ulp at
the O(1) outputs).  Rows whose queries have no valid key (pad rows of a
left-padded batch) are garbage by construction in the Pallas kernel and
are not compared.  The CUDA kernels themselves are held to
the plain versions on the card by ``tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention.kernel import (  # noqa: E402
    decode_attention_pallas, paged_decode_attention_pallas)
from repro.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_pallas)
from repro_torch.kernels import (conv2d, decode_attention,  # noqa: E402
                                 flash_attention, launch_counts, matmul,
                                 paged_decode_attention, reset_launch_counts,
                                 sparse_conv2d, ssm_scan)
from repro_torch.kernels.conv2d import conv2d_ref  # noqa: E402
from repro_torch.kernels.matmul import matmul_ref  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_ref, paged_decode_attention_ref)
from repro_torch.kernels.flash_attention import flash_attention_ref  # noqa: E402
from repro_torch.kernels.ssm_scan import ssm_scan_ref  # noqa: E402

ATOL = 1e-5


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


FLASH_CASES = [
    # (B, HQ, HKV, S, D, window, with_starts)
    (2, 4, 2, 64, 16, None, False),
    (2, 4, 2, 64, 16, None, True),
    (2, 4, 2, 64, 16, 24, False),
    (1, 2, 2, 256, 96, None, True),
    (2, 4, 2, 128, 96, 40, True),
    # head_dim 256 with 8 and 16 query heads on one KV head; group 5
    (1, 8, 1, 64, 256, None, True),
    (2, 16, 1, 64, 256, 24, True),
    (2, 5, 1, 64, 256, None, True),
]


@pytest.mark.parametrize("b,hq,hkv,s,d,window,with_starts", FLASH_CASES)
def test_flash_plain_matches_pallas(b, hq, hkv, s, d, window, with_starts):
    rng = np.random.default_rng(s + d + hq)
    q, k, v = _rand(rng, b, hq, s, d), _rand(rng, b, hkv, s, d), \
        _rand(rng, b, hkv, s, d)
    starts = (np.array([0, s // 3][:b], np.int32) if with_starts
              else None)
    ref = flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window, starts=None if starts is None
        else jnp.asarray(starts), interpret=True)
    got = flash_attention_ref(_t(q), _t(k), _t(v), causal=True,
                              window=window,
                              starts=None if starts is None else _t(starts))
    ref, got = np.asarray(ref), got.numpy()
    for i in range(b):
        lo = 0 if starts is None else int(starts[i])
        np.testing.assert_allclose(got[i, :, lo:], ref[i, :, lo:],
                                   rtol=0, atol=ATOL)


def test_flash_plain_noncausal_matches_pallas():
    rng = np.random.default_rng(3)
    q, k, v = _rand(rng, 1, 4, 32, 16), _rand(rng, 1, 2, 32, 16), \
        _rand(rng, 1, 2, 32, 16)
    ref = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=False,
                                 interpret=True)
    got = flash_attention_ref(_t(q), _t(k), _t(v), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


# (D, HQ, HKV): the original two, then head_dim 256 with group 8 (one KV
# head) and 16, and group 5
DECODE_CASES = [
    pytest.param(16, 4, 2, id="16"),
    pytest.param(96, 4, 2, id="96"),
    pytest.param(256, 8, 1, id="256-g8"),
    pytest.param(256, 16, 1, id="256-g16"),
    pytest.param(256, 5, 1, id="256-g5"),
]


@pytest.mark.parametrize("d,hq,hkv", DECODE_CASES)
def test_decode_plain_matches_pallas(d, hq, hkv):
    # the original cases (4 heads) keep their seeds
    rng = np.random.default_rng(d if hq == 4 else d + hq)
    b, s = 3, 64
    q, k, v = _rand(rng, b, hq, 1, d), _rand(rng, b, hkv, s, d), \
        _rand(rng, b, hkv, s, d)
    pos = np.array([5, 40, 63], np.int32)
    starts = np.array([0, 17, 33], np.int32)
    ref = decode_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(pos),
                                  starts=jnp.asarray(starts), block_kv=16,
                                  interpret=True)
    got = decode_attention_ref(_t(q), _t(k), _t(v), _t(pos),
                               starts=_t(starts))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)
    # a scalar pos is broadcast to every row, as in the Pallas entry
    ref_s = decode_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), 20, interpret=True)
    got_s = decode_attention_ref(_t(q), _t(k), _t(v), 20)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), rtol=0,
                               atol=ATOL)


def _paged_inputs(rng, d, hq=4, hkv=2, bs=4, nb=12, mb=5):
    b = 3
    q = _rand(rng, b, hq, 1, d)
    kp, vp = _rand(rng, nb, hkv, bs, d), _rand(rng, nb, hkv, bs, d)
    blocks = rng.permutation(np.arange(1, nb))
    tables = np.zeros((b, mb), np.int32)
    tables[0, :3] = blocks[:3]          # shuffled, non-contiguous blocks
    tables[1, :5] = blocks[3:8]
    # row 2 is idle: all-zero table and pos 0 -> the reserved sink block
    pos = np.array([9, 17, 0], np.int32)
    return q, kp, vp, tables, pos


@pytest.mark.parametrize("d,hq,hkv", DECODE_CASES)
def test_paged_decode_plain_matches_pallas(d, hq, hkv):
    rng = np.random.default_rng(100 + d if hq == 4 else 100 + d + hq)
    q, kp, vp, tables, pos = _paged_inputs(rng, d, hq=hq, hkv=hkv)
    ref = paged_decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(pos), interpret=True)
    got = paged_decode_attention_ref(_t(q), _t(kp), _t(vp), _t(tables),
                                     _t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


def test_cpu_wrappers_run_plain_versions_without_counting():
    """A CPU tensor reaches the plain version; nothing counts as a
    kernel launch."""
    rng = np.random.default_rng(0)
    reset_launch_counts()
    q, k, v = (_t(_rand(rng, 1, 4, 16, 16)), _t(_rand(rng, 1, 2, 16, 16)),
               _t(_rand(rng, 1, 2, 16, 16)))
    assert torch.equal(flash_attention(q, k, v),
                       flash_attention_ref(q, k, v))
    qd = q[:, :, :1].contiguous()
    assert torch.equal(decode_attention(qd, k, v, 7),
                       decode_attention_ref(qd, k, v, 7))
    qp, kp, vp, tables, pos = map(_t, _paged_inputs(rng, 16))
    assert torch.equal(paged_decode_attention(qp, kp, vp, tables, pos),
                       paged_decode_attention_ref(qp, kp, vp, tables, pos))
    x, dt = _t(_rand(rng, 2, 5, 16)), _t(_rand(rng, 2, 5, 16)).abs()
    bc, a = _t(_rand(rng, 2, 5, 8)), -_t(_rand(rng, 16, 8)).abs()
    d = _t(_rand(rng, 16))
    for got, want in zip(ssm_scan(x, dt, bc, bc, a, d),
                         ssm_scan_ref(x, dt, bc, bc, a, d)):
        assert torch.equal(got, want)
    img, wgt = _t(_rand(rng, 1, 4, 6, 6)), _t(_rand(rng, 4, 4, 3, 3))
    assert torch.equal(conv2d(img, wgt), conv2d_ref(img, wgt))
    assert torch.equal(sparse_conv2d(img, wgt, block={"oc": 2, "ic": 2}),
                       conv2d_ref(img, wgt))
    am, bm = _t(_rand(rng, 8, 16)), _t(_rand(rng, 16, 4))
    assert torch.equal(matmul(am, bm), matmul_ref(am, bm))
    assert launch_counts() == {"flash_attention": 0,
                               "paged_decode_attention": 0,
                               "decode_attention": 0, "ssm_scan": 0,
                               "matmul": 0, "conv2d": 0, "sparse_conv2d": 0}


def test_bf16_q_scale_is_applied_in_q_dtype():
    """The plain versions scale q in q's dtype, as the Pallas entries do
    (``q * jnp.asarray(scale, q.dtype)``)."""
    rng = np.random.default_rng(1)
    q = _rand(rng, 1, 2, 8, 96)
    k, v = _rand(rng, 1, 2, 8, 96), _rand(rng, 1, 2, 8, 96)
    qb = jnp.asarray(q).astype(jnp.bfloat16)
    kb, vb = (jnp.asarray(k).astype(jnp.bfloat16),
              jnp.asarray(v).astype(jnp.bfloat16))
    ref = flash_attention_pallas(qb, kb, vb, interpret=True)
    tb = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        torch.bfloat16) for x in (qb, kb, vb)]
    got = flash_attention_ref(*tb)
    # bf16 outputs: one ulp at |x| < 4 is <= 2**-6
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=0, atol=2 ** -6)
