"""The port's dense model against the JAX package on
``phi3-mini-3.8b-smoke`` with the same weights (the JAX init, converted
through :func:`repro_torch.bridge.params_from_numpy`).

Tolerances: logits atol 1e-4, rtol 1e-4 (float32 smoke model; two
layers of float32 GEMMs summed in another order differ by ~1e-6, so
1e-4 leaves room without hiding a wrong mask or rope); greedy tokens must
be identical.  Left-padded logits are compared at real positions only:
pad queries are fully masked and garbage by construction.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

ARCH = "phi3-mini-3.8b-smoke"
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def models():
    jm = jax_build_model(jax_get_config(ARCH))
    jp, _ = jm.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, build_model(get_config(ARCH)), tp


def _batch(seed=0, b=3, s=16):
    rng = np.random.RandomState(seed)
    toks = rng.randint(1, 256, size=(b, s)).astype(np.int32)
    starts = np.array([0, 5, 11][:b], np.int32)
    for i, st in enumerate(starts):
        toks[i, :st] = 0
    return toks, starts


def test_config_copy_matches_jax():
    for name in ("phi3-mini-3.8b", ARCH):
        assert get_config(name).__dict__ == jax_get_config(name).__dict__


def test_init_paths_and_shapes_match_jax(models):
    jm, jp, tm, _ = models
    ours = tm.init(seed=0, device="cpu")
    flat_j = {"/".join(str(k.key) for k in path): leaf for path, leaf in
              jax.tree_util.tree_flatten_with_path(jp)[0]}

    def flat(d, pre=""):
        out = {}
        for k, v in d.items():
            out.update(flat(v, pre + k + "/") if isinstance(v, dict)
                       else {pre + k: v})
        return out

    flat_t = flat(ours)
    assert sorted(flat_t) == sorted(flat_j)
    for k, v in flat_t.items():
        assert tuple(v.shape) == flat_j[k].shape, k
        # same std rule: compare empirical stds of the normal leaves
        sj = float(np.std(np.asarray(flat_j[k])))
        assert abs(float(v.std()) - sj) <= 0.1 * sj + 1e-12, k


@pytest.mark.parametrize("backend,jax_backend", [("plain", "xla"),
                                                 ("cuda", "xla"),
                                                 ("cuda", "pallas")])
def test_left_padded_prefill_logits_match_jax(models, backend,
                                              jax_backend):
    jm, jp, tm, tp = models
    toks, starts = _batch()
    lj, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                        backend=jax_backend,
                        seq_starts=jnp.asarray(starts))
    lt, ct = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                        backend=backend,
                        seq_starts=torch.from_numpy(starts))
    lj, lt = np.asarray(lj), lt.numpy()
    for i, st in enumerate(starts):
        np.testing.assert_allclose(lt[i, st:], lj[i, st:], **TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(
                ct["layers"][name].numpy()[:, i, :, st:],
                np.asarray(cj["layers"][name])[:, i, :, st:], **TOL)


def _grow(full, pre, s):
    out = {"layers": {}}
    for name in ("k", "v"):
        buf = full["layers"][name]
        if isinstance(buf, torch.Tensor):
            buf[..., :s, :].copy_(pre["layers"][name])
        else:
            buf = buf.at[..., :s, :].set(pre["layers"][name])
        out["layers"][name] = buf
    return out


@pytest.mark.parametrize("backend", ["plain", "cuda"])
def test_contiguous_decode_steps_match_jax(models, backend):
    jm, jp, tm, tp = models
    toks, starts = _batch(seed=1)
    b, s = toks.shape
    total = s + 4
    lj, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                        seq_starts=jnp.asarray(starts))
    lt, ct = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                        backend=backend,
                        seq_starts=torch.from_numpy(starts))
    cj = _grow(jm.init_cache(b, total), cj, s)
    ct = _grow(tm.init_cache(b, total, torch.device("cpu")), ct, s)
    tj = jnp.argmax(lj[:, -1], -1).astype(jnp.int32)
    tt = torch.argmax(lt[:, -1], -1)
    for i in range(3):
        assert tt.tolist() == np.asarray(tj).tolist()
        lj, cj = jm.decode_step(jp, cj, tj[:, None], jnp.int32(s + i),
                                seq_starts=jnp.asarray(starts))
        lt, ct = tm.decode_step(tp, ct, tt[:, None], s + i,
                                backend=backend,
                                seq_starts=torch.from_numpy(starts))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        tj = jnp.argmax(lj[:, -1], -1).astype(jnp.int32)
        tt = torch.argmax(lt[:, -1], -1)


@pytest.mark.parametrize("backend", ["plain", "cuda"])
def test_paged_decode_steps_match_jax(models, backend):
    """Rows at different depths over shuffled pool blocks, with an idle
    row on the sink block 0."""
    jm, jp, tm, tp = models
    cfg = tm.cfg
    rng = np.random.RandomState(3)
    nb, bs, mb, b = 10, 4, 3, 3
    shape = (cfg.n_layers, nb, cfg.n_kv_heads, bs, cfg.resolved_head_dim)
    pk = rng.standard_normal(shape).astype(np.float32)
    pv = rng.standard_normal(shape).astype(np.float32)
    tables = np.zeros((b, mb), np.int32)
    tables[0] = [7, 2, 9]
    tables[1, :2] = [4, 1]
    pos = np.array([9, 5, 0], np.int32)
    toks = np.array([[3], [17], [0]], np.int32)
    cj = {"layers": {"k": jnp.asarray(pk), "v": jnp.asarray(pv)}}
    ct = {"layers": {"k": torch.from_numpy(pk.copy()),
                     "v": torch.from_numpy(pv.copy())}}
    for step in range(3):
        lj, cj = jm.decode_step(jp, cj, jnp.asarray(toks),
                                jnp.asarray(pos),
                                block_tables=jnp.asarray(tables))
        lt, ct = tm.decode_step(tp, ct, torch.from_numpy(toks),
                                torch.from_numpy(pos), backend=backend,
                                block_tables=torch.from_numpy(tables))
        np.testing.assert_allclose(lt.numpy()[:2], np.asarray(lj)[:2],
                                   **TOL)
        for name in ("k", "v"):
            # live blocks agree (the sink block 0 is garbage by design)
            np.testing.assert_allclose(
                ct["layers"][name].numpy()[:, 1:],
                np.asarray(cj["layers"][name])[:, 1:], **TOL)
        toks = np.asarray(jnp.argmax(lj[:, -1], -1))[:, None].astype(
            np.int32)
        pos = pos + np.array([1, 1, 0], np.int32)


def test_greedy_tokens_identical_to_jax(models):
    jm, jp, tm, tp = models
    toks, starts = _batch(seed=2, b=2, s=8)
    lj, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                        seq_starts=jnp.asarray(starts))
    lt, ct = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                        backend="cuda",
                        seq_starts=torch.from_numpy(starts))
    cj = _grow(jm.init_cache(2, 20), cj, 8)
    ct = _grow(tm.init_cache(2, 20, torch.device("cpu")), ct, 8)
    tj = jnp.argmax(lj[:, -1], -1).astype(jnp.int32)
    tt = torch.argmax(lt[:, -1], -1)
    out_j, out_t = [np.asarray(tj)], [tt.numpy()]
    for i in range(11):
        lj, cj = jm.decode_step(jp, cj, tj[:, None], jnp.int32(8 + i),
                                seq_starts=jnp.asarray(starts))
        lt, ct = tm.decode_step(tp, ct, tt[:, None], 8 + i,
                                backend="cuda",
                                seq_starts=torch.from_numpy(starts))
        tj = jnp.argmax(lj[:, -1], -1).astype(jnp.int32)
        tt = torch.argmax(lt[:, -1], -1)
        out_j.append(np.asarray(tj))
        out_t.append(tt.numpy())
    assert np.array_equal(np.stack(out_t), np.stack(out_j))


@pytest.mark.parametrize("family", ["moe", "hybrid"])
def test_non_dense_families_raise(family):
    """Families the port does not serve yet raise (dense and ssm are
    served; ssm is tested in test_torch_ssm.py)."""
    import dataclasses
    cfg = dataclasses.replace(get_config(ARCH), family=family)
    with pytest.raises(NotImplementedError):
        build_model(cfg).init(seed=0, device="cpu")
    with pytest.raises(NotImplementedError):
        cfg.param_count()
