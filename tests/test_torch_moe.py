"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's (``repro.models.moe``) on the same weights, on the CPU.

Tolerances: float32 outputs atol 1e-5, rtol 1e-5 (the same numbers in
another summation order of the dense products: ~1e-7 apart); the aux
loss 1e-6; routing (top-k experts and their order, the capacity, the
dropped slots) exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import moe as jmoe  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
E, D, F, K = 6, 16, 24, 2


def _params(seed=0, shared=True, zero_router=False):
    rng = np.random.RandomState(seed)
    p = {"router": rng.standard_normal((D, E)).astype(np.float32) / 4,
         "w1": rng.standard_normal((E, D, F)).astype(np.float32) / 4,
         "w3": rng.standard_normal((E, D, F)).astype(np.float32) / 4,
         "w2": rng.standard_normal((E, F, D)).astype(np.float32) / 5}
    if shared:
        p.update(shared_w1=rng.standard_normal((D, F)).astype(np.float32) / 4,
                 shared_w3=rng.standard_normal((D, F)).astype(np.float32) / 4,
                 shared_w2=rng.standard_normal((F, D)).astype(np.float32) / 5)
    if zero_router:
        p["router"] = np.zeros_like(p["router"])
    return p


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def _expected_drops(p, x, k, factor):
    """Dropped slots by the JAX routing: entries past an expert's
    capacity."""
    xt = x.reshape(-1, D)
    probs = jax.nn.softmax(jnp.asarray(xt) @ jnp.asarray(p["router"]), -1)
    _, expert = jax.lax.top_k(probs, k)
    counts = np.bincount(np.asarray(expert).reshape(-1), minlength=E)
    c = jmoe._capacity(xt.shape[0], E, k, factor)
    return int(np.maximum(counts - c, 0).sum())


CASES = [((2, 9), 1.25, True), ((3, 40), 0.5, True), ((1, 4), 1.25, False),
         ((4, 1), 1.25, True), ((2, 64), 0.25, False)]


@pytest.mark.parametrize("shape,factor,shared", CASES)
def test_moe_ffn_matches_jax(shape, factor, shared):
    """Outputs, aux loss and dropped slots, at capacities that drop
    (factor 0.5, 0.25) and that do not."""
    p = _params(shared=shared)
    jp, tp = _both(p)
    x = np.random.RandomState(1).standard_normal(shape + (D,)).astype(
        np.float32)
    oj, aj = jmoe.moe_ffn(jnp.asarray(x), jp, n_experts=E, top_k=K,
                          capacity_factor=factor)
    with tmoe.drop_tally("cpu") as dropped:
        ot, at = tmoe.moe_ffn(torch.from_numpy(x), tp, n_experts=E,
                              top_k=K, capacity_factor=factor)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **TOL)
    assert abs(float(at) - float(aj)) <= 1e-6
    assert int(dropped) == _expected_drops(p, x, K, factor)
    assert tmoe._TALLY is None        # closed with its context


def test_capacities_that_drop_and_that_do_not_are_both_covered():
    drops = [_expected_drops(_params(), np.random.RandomState(1)
                             .standard_normal(s + (D,)).astype(np.float32),
                             K, f) for s, f, _ in CASES]
    assert min(drops) == 0 < max(drops)


def test_moe_ffn_ref_matches_jax_and_ample_capacity():
    p = _params()
    jp, tp = _both(p)
    x = np.random.RandomState(2).standard_normal((2, 7, D)).astype(
        np.float32)
    rj = jmoe.moe_ffn_ref(jnp.asarray(x), jp, n_experts=E, top_k=K)
    rt = tmoe.moe_ffn_ref(torch.from_numpy(x), tp, n_experts=E, top_k=K)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), **TOL)
    # capacity that drops nothing: the sort-based dispatch equals the
    # dense oracle
    ot, _ = tmoe.moe_ffn(torch.from_numpy(x), tp, n_experts=E, top_k=K,
                         capacity_factor=8.0)
    np.testing.assert_allclose(ot.numpy(), rt.numpy(), **TOL)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_zero_router_ties_follow_jax_top_k(k):
    """A zeroed router makes every probability equal: ``jax.lax.top_k``
    takes the lowest experts in order, so every token routes to experts
    0..k-1 and most slots are dropped; the port routes and drops the
    same."""
    p = _params(zero_router=True)
    jp, tp = _both(p)
    x = np.random.RandomState(3).standard_normal((3, 16, D)).astype(
        np.float32)
    oj, aj = jmoe.moe_ffn(jnp.asarray(x), jp, n_experts=E, top_k=k)
    with tmoe.drop_tally("cpu") as dropped:
        ot, at = tmoe.moe_ffn(torch.from_numpy(x), tp, n_experts=E,
                              top_k=k)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **TOL)
    assert abs(float(at) - float(aj)) <= 1e-6
    c = jmoe._capacity(48, E, k, 1.25)
    assert int(dropped) == k * max(48 - c, 0) > 0
    _, ej = jax.lax.top_k(jnp.zeros((5, E)), k)
    _, et = tmoe.sorted_top_k(torch.zeros((5, E)), k)
    assert et.tolist() == np.asarray(ej).tolist() == [list(range(k))] * 5


def test_sorted_top_k_matches_jax_on_bf16_ties():
    """Router logits rounded to bf16 tie often among 60 experts; the
    order among equal values is ``jax.lax.top_k``'s."""
    rng = np.random.RandomState(4)
    logits = np.round(rng.standard_normal((64, 60)) * 4) / 4
    probs = jax.nn.softmax(jnp.asarray(logits, jnp.bfloat16).astype(
        jnp.float32), -1)
    vj, ej = jax.lax.top_k(probs, 4)
    vt, et = tmoe.sorted_top_k(torch.from_numpy(np.array(probs)), 4)
    assert et.tolist() == np.asarray(ej).tolist()
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    ties = sum(len(set(np.asarray(r))) < 4 for r in np.asarray(vj))
    assert ties > 0


def test_aux_loss_matches_jax_without_shared_experts():
    p = _params(seed=5, shared=False)
    jp, tp = _both(p)
    x = np.random.RandomState(5).standard_normal((3, 11, D)).astype(
        np.float32)
    _, aj = jmoe.moe_ffn(jnp.asarray(x), jp, n_experts=E, top_k=3)
    _, at = tmoe.moe_ffn(torch.from_numpy(x), tp, n_experts=E, top_k=3)
    assert at.dtype == torch.float32
    assert abs(float(at) - float(aj)) <= 1e-6


def test_capacity_rule_matches_jax():
    for t in list(range(1, 300)) + [512, 1000, 4096]:
        for e, k, f in ((60, 4, 1.25), (16, 1, 1.25), (4, 2, 1.25),
                        (6, 2, 0.5)):
            assert tmoe.capacity(t, e, k, f) == jmoe._capacity(t, e, k, f)
    # qwen2-moe-a2.7b: a 512-token prefill, a 4-row decode step
    assert tmoe.capacity(512, 60, 4, 1.25) == 48
    assert tmoe.capacity(4, 60, 4, 1.25) == 8


def _dropping_input(seed=1):
    """[3, 40, D] tokens at capacity factor 0.5: slots drop."""
    return np.random.RandomState(seed).standard_normal((3, 40, D)).astype(
        np.float32)


def test_drop_tally_counter_persists_across_tallies():
    """A tally yields its device's one counter, zeroed: a run inside adds
    its dropped slots, a run outside adds nothing, and the counter
    outlives the tally (a graph captured inside keeps its address)."""
    p = _params()
    _, tp = _both(p)
    x = torch.from_numpy(_dropping_input())
    want = _expected_drops(p, x.numpy(), K, 0.5)
    assert want > 0
    with tmoe.drop_tally("cpu") as first:
        tmoe.moe_ffn(x, tp, n_experts=E, top_k=K, capacity_factor=0.5)
        assert int(first) == want
    tmoe.moe_ffn(x, tp, n_experts=E, top_k=K, capacity_factor=0.5)
    assert int(first) == want
    with tmoe.drop_tally("cpu") as second:
        assert second is first and int(second) == 0
        tmoe.moe_ffn(x, tp, n_experts=E, top_k=K, capacity_factor=0.5)
    assert int(first) == want

