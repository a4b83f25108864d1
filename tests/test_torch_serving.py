"""The port's serving layer against the JAX package: the in-flight
engine's token streams, the block allocator, and ``generate``.

Both packages serve ``phi3-mini-3.8b-smoke`` with the same weights (the
JAX init, bridged); greedy token streams must be identical.  The JAX
side runs ``ServeSession(backend="reference")``; the port runs its
engine with both backends (``"cuda"`` runs the kernels' plain versions
on CPU tensors).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.runtime.serve_loop import generate as jax_generate  # noqa: E402
from repro.serving.paged_kv import BlockAllocator as JaxAllocator  # noqa: E402
from repro.serving.session import ServeSession as JaxSession  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import (Model, build_model, left_pad_prompts,  # noqa: E402
                                prompt_starts)
from repro_torch.runtime import generate  # noqa: E402
from repro_torch.serving import (RESERVED_BLOCK, BlockAllocator,  # noqa: E402
                                 ServeSession, blocks_needed)

ARCH = "phi3-mini-3.8b-smoke"


@pytest.fixture(scope="module")
def models():
    jm = jax_build_model(jax_get_config(ARCH))
    jp, _ = jm.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, build_model(get_config(ARCH)), tp


def _prompts(lengths, seed=7):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 256, size=n).astype(np.int32) for n in lengths]


# Each scenario: prompts, budgets, session kwargs, and an optional
# mid-stream submission (step, prompt_len, budget) made from on_step.
SCENARIOS = {
    "mixed_depths": ([5, 7, 3, 6, 12], [6, 3, 8, 1, 5],
                     dict(kv_block_size=4), None),
    "mid_stream_admission": ([6], [10], dict(kv_block_size=4), (3, 5, 4)),
    "compaction": ([5, 5, 5, 5, 5, 5], [2, 12, 2, 12, 2, 12],
                   dict(kv_block_size=2, batch_sizes=(4,)), None),
    "backpressure": ([5, 5, 5, 5], [4, 4, 4, 4],
                     dict(kv_block_size=4, kv_blocks=5,
                          batch_sizes=(4,)), None),
}


def _serve(session, prompts, budgets, late):
    for i, (p, b) in enumerate(zip(prompts, budgets)):
        session.submit(p, b, request_id=f"r{i}")
    seen = {}

    def on_step(info):
        if late is not None and info["step"] == late[0] and not seen:
            seen["late"] = True
            session.submit(_prompts([late[1]], seed=11)[0], late[2],
                           request_id="late")

    res = session.drain(on_step=on_step)
    return ({r.request_id: r.tokens.tolist() for r in res},
            [r.request_id for r in res], [r.state for r in res])


@pytest.fixture(scope="module")
def jax_streams(models):
    jm, jp, _, _ = models
    out = {}
    for name, (lens, budgets, kw, late) in SCENARIOS.items():
        s = JaxSession(jm, jp, backend="reference", **kw)
        out[name] = (_serve(s, _prompts(lens), budgets, late), s.stats)
    return out


@pytest.mark.parametrize("backend", ["cuda", "plain"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_engine_token_streams_match_jax(models, jax_streams, scenario,
                                        backend):
    _, _, tm, tp = models
    lens, budgets, kw, late = SCENARIOS[scenario]
    s = ServeSession(tm, tp, backend=backend, **kw)
    (tokens, order, states), = [_serve(s, _prompts(lens), budgets, late)]
    (j_tokens, j_order, j_states), j_stats = jax_streams[scenario]
    assert tokens == j_tokens
    assert order == j_order            # same retirement order
    assert states == j_states == ["COMPLETED"] * len(states)
    for k in ("batches", "steps", "inflight_admissions", "compactions"):
        assert getattr(s.stats, k) == getattr(j_stats, k), k
    # each request's first token comes from its prefill, the rest from
    # decode steps, which alone count toward decode_tok_s
    assert s.stats.tokens_generated == sum(len(t) for t in tokens.values())
    assert s.stats.decode_tokens == sum(len(t) - 1 for t in tokens.values())
    if scenario == "compaction":
        assert s.stats.compactions >= 1
    if scenario == "mid_stream_admission":
        assert s.stats.inflight_admissions == 2 and s.stats.batches == 1


def test_unservable_request_rejected(models):
    _, _, tm, tp = models
    s = ServeSession(tm, tp, kv_block_size=4, kv_blocks=2)
    big, small = _prompts([6, 3])
    s.submit(big, 8, request_id="big")
    s.submit(small, 2, request_id="small")
    res = {r.request_id: r for r in s.drain()}
    assert res["big"].state == "REJECTED" and "kv_blocks" in res["big"].reason
    assert res["small"].state == "COMPLETED"
    assert len(res["small"].tokens) == 2


def test_nan_logits_fail_only_the_poisoned_row(models, monkeypatch):
    """A row whose decode logits are not finite retires FAILED with its
    partial tokens; its batchmate's stream is unchanged."""
    _, _, tm, tp = models
    prompts = _prompts([5, 6])

    def run(poison):
        s = ServeSession(tm, tp, kv_block_size=4, batch_sizes=(2,))
        if poison:
            real = Model.decode_step
            calls = {"n": 0}

            def bad_step(self, *a, **k):
                lg, c = real(self, *a, **k)
                calls["n"] += 1
                if calls["n"] == 2:
                    lg = lg.clone()
                    lg[0, -1, 0] = float("nan")
                return lg, c
            monkeypatch.setattr(Model, "decode_step", bad_step)
        for i, p in enumerate(prompts):
            s.submit(p, 5, request_id=f"p{i}")
        out = {r.request_id: r for r in s.drain()}
        monkeypatch.undo()
        return out, s.stats

    clean, _ = run(False)
    dirty, stats = run(True)
    assert dirty["p0"].state == "FAILED" and stats.poisoned_rows == 1
    assert dirty["p0"].tokens.tolist() == clean["p0"].tokens.tolist()[:2]
    assert dirty["p1"].tokens.tolist() == clean["p1"].tokens.tolist()


def test_block_allocator_matches_jax_allocator():
    """The same alloc/free/compact sequence gives the same blocks, free
    lists, fragmentation, tables and gather map in both copies."""
    ours, ref = BlockAllocator(12, 4), JaxAllocator(12, 4)
    assert RESERVED_BLOCK == 0 and blocks_needed(0, 4) == 1
    assert [blocks_needed(n, 4) for n in (1, 4, 5, 9)] == [1, 1, 2, 3]
    rows_o, rows_r = [], []
    for n in (3, 2, 4, 1):
        rows_o.append(ours.alloc(n))
        rows_r.append(ref.alloc(n))
    assert rows_o == rows_r and ours.alloc(5) is None
    for i in (0, 2):
        ours.free(rows_o[i])
        ref.free(rows_r[i])
    assert ours.num_free == ref.num_free and ours.num_live == ref.num_live
    assert ours.fragmentation() == ref.fragmentation()
    live_o = [rows_o[1], rows_o[3]]
    live_r = [list(rows_r[1]), list(rows_r[3])]
    t_o = np.zeros((2, 3), np.int32)
    t_o[0, :2], t_o[1, :1] = rows_o[1], rows_o[3]
    t_r = t_o.copy()
    perm_o, moved_o = ours.compact_tables(t_o, live_o)
    perm_r, moved_r = ref.compact_tables(t_r, live_r)
    assert moved_o == moved_r > 0
    assert np.array_equal(perm_o, perm_r) and np.array_equal(t_o, t_r)
    assert live_o == live_r and ours.fragmentation() == 0.0
    with pytest.raises(ValueError):
        ours.free([RESERVED_BLOCK])
    with pytest.raises(ValueError):
        ours.free([11])                 # never allocated
    with pytest.raises(ValueError):
        BlockAllocator(1, 4)


@pytest.mark.parametrize("backend", ["cuda", "plain"])
def test_generate_matches_jax_generate(models, backend):
    jm, jp, tm, tp = models
    prompts = _prompts([3, 8, 6])
    toks = left_pad_prompts(prompts, 8)
    starts = prompt_starts(prompts, 8)
    ref, _ = jax_generate(jm, jp, {"tokens": jnp.asarray(toks)},
                          max_new_tokens=7, seq_starts=starts)
    out, stats = generate(tm, tp, {"tokens": toks}, max_new_tokens=7,
                          backend=backend, seq_starts=starts)
    assert out.shape == (3, 7) and stats.tokens_generated == 21
    assert stats.decode_tokens == 18
    assert np.array_equal(out, np.asarray(ref))
