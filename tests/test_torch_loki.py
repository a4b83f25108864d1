"""The port's design-space tools against the JAX package, on the CPU: the
loop-nest footprints, the 720 permutations, the Loki cache model (scalar
and batch), the trace simulator, the ECM tier and its learned
correction, the sweeps' static candidates, pairs and sampling bounds,
both permutohedron searches, and the Loki and ECM registry keys.

Both packages run the same numpy arithmetic in the same order, so every
comparison is exact (``np.array_equal`` / ``==``, tolerance 0) unless a
test says otherwise.  The layers are all of thesis Table 4.1 and a
sample of Table 4.2's 216 drawn with numpy from seed 0.
"""
import dataclasses
import itertools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax  # noqa: F401  (the suite runs beside the JAX reference)

from repro.configs import squeezenet_layers as jsq
from repro.core import cost_model as jcm
from repro.core import ecm as jecm
from repro.core import loopnest as jln
from repro.core import permutations as jperm
from repro.core import registry as jreg
from repro.core import tracesim as jtrace
from repro.core import tuner as jtuner
from repro_torch.configs import squeezenet_layers as sq
from repro_torch.core import cost_model as cm
from repro_torch.core import ecm
from repro_torch.core import loopnest as ln
from repro_torch.core import permutations as perm
from repro_torch.core import registry as reg
from repro_torch.core import tracesim, tuner

REPO = Path(__file__).resolve().parent.parent
ALL = list(itertools.permutations(range(6)))
SAMPLE = [int(i) for i in np.random.default_rng(0).choice(216, 10,
                                                          replace=False)]
LAYERS = ([("table4.1/" + k, v) for k, v in sq.TABLE_4_1.items()]
          + [(f"table4.2/{i}", sq.synthetic_design_space()[i])
             for i in SAMPLE])
LAYER_IDS = [name for name, _ in LAYERS]
MACHINES = ["table2.1"] + sorted(cm.HIERARCHIES)
# small layers for exact traces (a Table 4.1 layer's trace is tens of
# millions of accesses; these are whole traces, not truncated)
SMALL = [(8, 4, 6, 6, 3, 3), (4, 8, 5, 7, 1, 1), (6, 3, 9, 4, 3, 1)]


def jlayer(layer):
    """The JAX package's ConvLayer with the port layer's fields."""
    return jln.ConvLayer(**dataclasses.asdict(layer))


def machines(name):
    """(port, JAX) MachineModel pair by name."""
    if name == "table2.1":
        return cm.MachineModel(), jcm.MachineModel()
    return cm.HIERARCHIES[name], jcm.HIERARCHIES[name]


def assert_batch_equal(a, b):
    """Two BatchSimResult / ECMBatchResult field by field, exactly."""
    for f in ("perms", "cycles", "accesses"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert a.misses.keys() == b.misses.keys()
    for lv in a.misses:
        assert np.array_equal(a.misses[lv], b.misses[lv]), lv


# ------------------------------------------------------------ loop nest

def test_loop_constants_equal():
    assert ln.LOOPS == jln.LOOPS and ln.LOOP_INDEX == jln.LOOP_INDEX
    assert ln.OUTPUT_LOOPS == jln.OUTPUT_LOOPS
    assert ln.REDUCTION_LOOPS == jln.REDUCTION_LOOPS
    assert ln.ARRAY_DIMS == jln.ARRAY_DIMS
    assert ln.ARRAY_LOOPS == jln.ARRAY_LOOPS
    for m in range(ln.SUBSET_COUNT):
        assert ln.subset_loops(m) == jln.subset_loops(m)
    for p in ALL[::37]:
        assert ln.perm_loops(p) == jln.perm_loops(p)
        assert ln.loops_to_perm(ln.perm_loops(p)) == p
        for d in range(7):
            assert ln.inner_set(p, d) == jln.inner_set(p, d)
    for ps in (False, True):
        assert ln.accesses_per_iteration(ps) == \
            jln.accesses_per_iteration(ps)


@pytest.mark.parametrize("name,layer", LAYERS, ids=LAYER_IDS)
def test_footprint_tables_equal(name, layer):
    jl = jlayer(layer)
    for block in (4, 32, 64):
        tab, jtab = (ln.footprint_block_table(layer, block),
                     jln.footprint_block_table(jl, block))
        assert tab.keys() == jtab.keys()
        for a in tab:
            assert np.array_equal(tab[a], jtab[a]), (a, block)
    for m in range(0, ln.SUBSET_COUNT, 5):
        inner = ln.subset_loops(m)
        for a in ln.ARRAY_DIMS:
            assert ln.footprint_elems(layer, a, inner) == \
                jln.footprint_elems(jl, a, inner)
            for g in ln.ARRAY_DIMS[a]:
                assert ln.dim_extent(layer, g, inner) == \
                    jln.dim_extent(jl, g, inner)
    parr = ln.perms_array(ALL)
    assert np.array_equal(parr, jln.perms_array(ALL))
    assert np.array_equal(ln.perm_inner_masks(parr),
                          jln.perm_inner_masks(parr))
    assert np.array_equal(ln.trips_vector(layer), jln.trips_vector(jl))
    assert np.array_equal(ln.out_writes_with_partial_sums_batch(layer, parr),
                          jln.out_writes_with_partial_sums_batch(jl, parr))
    for p in ALL[::61]:
        assert ln.out_writes_with_partial_sums(layer, p) == \
            jln.out_writes_with_partial_sums(jl, p)


def test_stacked_tables_equal():
    layers = [layer for _, layer in LAYERS]
    tab = ln.stacked_footprint_tables(layers, 32)
    jtab = jln.stacked_footprint_tables([jlayer(x) for x in layers], 32)
    for a in tab:
        assert np.array_equal(tab[a], jtab[a])


# --------------------------------------------------------- permutations

@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6])
def test_permutation_orders_equal(n):
    assert perm.sjt_permutations(n) == jperm.sjt_permutations(n)
    assert perm.lex_permutations(n) == jperm.lex_permutations(n)
    for p in itertools.permutations(range(n)):
        assert perm.hamiltonian_index(p) == jperm.hamiltonian_index(p)
        assert perm.lex_index(p) == jperm.lex_index(p)
        assert perm.revlex_index(p) == jperm.revlex_index(p)
        assert perm.permutohedron_neighbors(p) == \
            jperm.permutohedron_neighbors(p)
        assert perm.perm_inverse(p) == jperm.perm_inverse(p)
        assert perm.perm_apply(p, "abcdef"[:n]) == \
            jperm.perm_apply(p, "abcdef"[:n])
    if n <= 4:
        assert perm.permutohedron_graph(n) == jperm.permutohedron_graph(n)


# ------------------------------------------------------------ Loki model

@pytest.mark.parametrize("machine", MACHINES)
@pytest.mark.parametrize("name,layer", LAYERS, ids=LAYER_IDS)
def test_simulate_batch_equal(name, layer, machine):
    m, jm = machines(machine)
    jl = jlayer(layer)
    for threads in (1, 4):
        b = cm.simulate_batch(layer, ALL, m, threads)
        jb = jcm.simulate_batch(jl, ALL, jm, threads)
        assert_batch_equal(b, jb)
        for lv in b.misses_by_array:
            for a in b.misses_by_array[lv]:
                assert np.array_equal(b.misses_by_array[lv][a],
                                      jb.misses_by_array[lv][a])
        assert b.working_set_blocks == jb.working_set_blocks
        assert b.best()[0] == jb.best()[0]


@pytest.mark.parametrize("name,layer", LAYERS[:8] + LAYERS[8::4],
                         ids=LAYER_IDS[:8] + LAYER_IDS[8::4])
def test_simulate_scalar_equal(name, layer):
    jl = jlayer(layer)
    picks = ALL[::53]
    for threads, ps in ((1, True), (4, True), (1, False)):
        for p in picks:
            r = cm.simulate(layer, p, cm.MachineModel(), threads, ps)
            jr = jcm.simulate(jl, p, jcm.MachineModel(), threads, ps)
            assert dataclasses.asdict(r) == dataclasses.asdict(jr)
    sw = cm.sweep_permutations(layer, perms=picks)
    jsw = jcm.sweep_permutations(jl, perms=picks)
    assert [(p, r.cycles) for p, r in sw] == \
        [(p, r.cycles) for p, r in jsw]


def test_machine_models_equal():
    assert dataclasses.asdict(cm.MachineModel()) == \
        dataclasses.asdict(jcm.MachineModel())
    assert sorted(cm.HIERARCHIES) == sorted(jcm.HIERARCHIES)
    for k in cm.HIERARCHIES:
        assert dataclasses.asdict(cm.HIERARCHIES[k]) == \
            dataclasses.asdict(jcm.HIERARCHIES[k])
        assert reg.fingerprint(cm.HIERARCHIES[k]) == \
            jreg.fingerprint(jcm.HIERARCHIES[k])


def test_loki_evaluations_count_like_jax():
    layer = sq.TABLE_4_1["initial-conf"]
    cm.reset_eval_counts()
    jcm.reset_eval_counts()
    for mod, lay in ((cm, layer), (jcm, jlayer(layer))):
        mod.simulate_batch(lay, ALL)
        mod.simulate(lay, ALL[3])
    for k in ("simulate", "simulate_batch"):
        assert cm.EVAL_COUNTS[k] == jcm.EVAL_COUNTS[k] > 0
    assert cm.total_evals() == 721
    # one dict: the H100 model's counters live beside the Loki ones
    from repro_torch.core import loki
    assert loki.EVAL_COUNTS is cm.EVAL_COUNTS
    assert "conv_schedule_cost_batch" in cm.EVAL_COUNTS


# ---------------------------------------------------------- trace sim

@pytest.mark.parametrize("dims", SMALL, ids=str)
def test_trace_simulator_equal(dims):
    layer = ln.ConvLayer(*dims)
    jl = jlayer(layer)
    for p in ALL[::97]:
        for ps in (True, False):
            t, n = tracesim.generate_trace(layer, p, ps)
            jt, jn = jtrace.generate_trace(jl, p, ps)
            assert n == jn and np.array_equal(t, jt)
        for machine in MACHINES:
            m, jm = machines(machine)
            for policy in ("random", "lru"):
                r = tracesim.simulate_trace(layer, p, m, l2_policy=policy)
                jr = jtrace.simulate_trace(jl, p, jm, l2_policy=policy)
                assert dataclasses.asdict(r) == dataclasses.asdict(jr)
        assert tracesim.reuse_analysis(t) == jtrace.reuse_analysis(t)
    blocks = np.random.default_rng(1).integers(0, 64, 500)
    for ways, policy in ((2, "lru"), (4, "random")):
        assert np.array_equal(
            tracesim.simulate_set_associative(blocks, 4, ways, policy),
            jtrace.simulate_set_associative(blocks, 4, ways, policy))
    assert np.array_equal(tracesim.simulate_direct_mapped(blocks, 8),
                          jtrace.simulate_direct_mapped(blocks, 8))


def test_truncated_trace_of_a_table_layer_equal():
    layer = sq.TABLE_4_1["fire9-conv3x3-2"]
    for p in ALL[::240]:
        r = tracesim.simulate_trace(layer, p, max_iters=20_000)
        jr = jtrace.simulate_trace(jlayer(layer), p, max_iters=20_000)
        assert dataclasses.asdict(r) == dataclasses.asdict(jr)


def test_trace_worker_imports_no_torch():
    """An exact-sweep worker unpickles its target and its arguments:
    tracesim, the Loki model and the loop nest, which import numpy
    only, never torch."""
    code = ("import sys; import repro_torch.core.tracesim, "
            "repro_torch.core.loki; "
            "print(sorted(m for m in ('torch', 'jax', 'repro') "
            "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    assert tuner.exact_sweep.__module__ == "repro_torch.core.tuner"
    assert cm.MachineModel.__module__ == "repro_torch.core.loki"


def test_exact_sweep_pool_equals_serial_and_jax():
    layer = ln.ConvLayer(*SMALL[0])
    sample = ALL[::90]
    serial = tuner.exact_sweep(layer, sample)
    pooled = tuner.exact_sweep(layer, sample, workers=2)
    want = jtuner.exact_sweep(jlayer(layer), sample)
    assert np.array_equal(serial, want) and np.array_equal(pooled, want)


# ---------------------------------------------------------------- ECM

@pytest.mark.parametrize("machine", MACHINES)
def test_ecm_predict_equal(machine):
    m, jm = machines(machine)
    layers = [layer for _, layer in LAYERS]
    for threads in (1, 4):
        r = ecm.ecm_predict(layers, ALL, m, threads)
        jr = jecm.ecm_predict([jlayer(x) for x in layers], ALL, jm, threads)
        assert_batch_equal(r, jr)
        for lv in r.fit_depth:
            assert np.array_equal(r.fit_depth[lv], jr.fit_depth[lv])
        assert np.array_equal(r.out_writes, jr.out_writes)
        assert np.array_equal(r.argmin(), jr.argmin())
        assert np.array_equal(ecm.correction_features(r),
                              jecm.correction_features(jr))


def test_correction_fit_json_byte_identical():
    """The correction fitted on exact traces of the small layers: its
    registry JSON is byte for byte the JAX package's, and so are the
    corrected cycles."""
    layers = [ln.ConvLayer(*d) for d in SMALL]
    picks = ALL[::45]
    r = ecm.ecm_predict(layers, picks)
    jr = jecm.ecm_predict([jlayer(x) for x in layers], picks)
    samples = [(li, pi, tracesim.simulate_trace(layers[li],
                                                picks[pi]).cycles)
               for li in range(len(layers)) for pi in range(len(picks))]
    c = ecm.fit_correction(r, samples[::-1])
    jc = jecm.fit_correction(jr, samples)
    assert reg.canonical_json(c.to_dict()) == \
        jreg.canonical_json(jc.to_dict())
    assert np.array_equal(ecm.apply_correction(r, c),
                          jecm.apply_correction(jr, jc))
    assert ecm.apply_correction(r, None) is r.cycles


def test_correction_saved_under_the_jax_key(tmp_path):
    layers = [ln.ConvLayer(*d) for d in SMALL]
    r = ecm.ecm_predict(layers, ALL[:20])
    c = ecm.fit_correction(r, [(0, 1, 2.0e5), (1, 3, 9.0e4), (2, 5, 4e4)])
    path = tmp_path / "p.jsonl"
    key = ecm.save_correction(c, cm.MachineModel(),
                              reg.TuningRegistry(str(path)))
    assert key.canonical() == \
        jreg.ecm_correction_key(jcm.MachineModel()).canonical()
    loaded = ecm.load_correction(cm.MachineModel(),
                                 reg.TuningRegistry(str(path)))
    assert loaded == c
    # the JAX package reads the port's line (same key, same value)
    jloaded = jecm.load_correction(jcm.MachineModel(),
                                   jreg.TuningRegistry(str(path)))
    assert jloaded.to_dict() == c.to_dict()


@pytest.mark.parametrize("consult", [True, False])
def test_ecm_sweep_equal(consult, tmp_path):
    layers = list(sq.TABLE_4_1.values())[:3] + [ln.ConvLayer(*SMALL[0])]
    p_reg = reg.TuningRegistry(str(tmp_path / "p.jsonl"))
    j_reg = jreg.TuningRegistry(str(tmp_path / "j.jsonl"))
    cm.reset_eval_counts()
    jcm.reset_eval_counts()
    r = tuner.ecm_sweep(layers, max_exact_iters=50_000, consult=consult,
                        registry=p_reg)
    jr = jtuner.ecm_sweep([jlayer(x) for x in layers],
                          max_exact_iters=50_000, consult=consult,
                          registry=j_reg)
    assert r.best == jr.best and r.tiers == jr.tiers
    assert r.consulted == jr.consulted
    assert r.consultation_rate == jr.consultation_rate
    assert np.array_equal(r.roofline_cycles, jr.roofline_cycles)
    assert np.array_equal(r.ecm_cycles, jr.ecm_cycles)
    for k in ("simulate_batch", "ecm_batch", "tracesim"):
        assert cm.EVAL_COUNTS[k] == jcm.EVAL_COUNTS[k], k
    assert sorted((tmp_path / "p.jsonl").read_text().splitlines()) == \
        sorted((tmp_path / "j.jsonl").read_text().splitlines())


# ---------------------------------------------- sweeps and searches

@pytest.fixture(scope="module")
def sweeps():
    """Port and JAX sweeps of Table 4.1 plus the Table 4.2 sample."""
    layers = [layer for _, layer in LAYERS]
    return ([tuner.sweep_layer(x) for x in layers],
            [jtuner.sweep_layer(jlayer(x)) for x in layers])


def test_sweep_signatures_equal(sweeps):
    for s, js in zip(*sweeps):
        for f in ("cycles", "l1_misses", "l2_misses"):
            assert np.array_equal(getattr(s, f), getattr(js, f))
        for metric in ("cycles", "l1", "l2"):
            for indexing in ("hamiltonian", "lex", "revlex"):
                assert np.array_equal(s.signature(metric, indexing),
                                      js.signature(metric, indexing))
    assert tuner.ALL_PERMS == jtuner.ALL_PERMS


@pytest.mark.parametrize("threads", [1, 4])
def test_parallel_sweep_equals_per_layer_and_jax(threads):
    """``parallel_sweep`` keeps the input order and gives each layer's
    ``sweep_layer`` arrays, and the JAX package's, exactly."""
    layers = [layer for _, layer in LAYERS[:4]]
    got = tuner.parallel_sweep(layers, threads=threads)
    want = jtuner.parallel_sweep([jlayer(x) for x in layers],
                                 threads=threads)
    assert [s.layer for s in got] == layers
    for s, js, layer in zip(got, want, layers):
        one = tuner.sweep_layer(layer, threads=threads)
        for f in ("cycles", "l1_misses", "l2_misses"):
            assert np.array_equal(getattr(s, f), getattr(one, f))
            assert np.array_equal(getattr(s, f), getattr(js, f))


@pytest.mark.parametrize("metric", ["cycles", "l1", "l2"])
def test_candidates_pairs_and_sampling_equal(sweeps, metric):
    mine, theirs = sweeps
    assert np.array_equal(tuner.speedup_matrix(mine, metric),
                          jtuner.speedup_matrix(theirs, metric))
    assert tuner.top_pairs(mine, metric, n_best=4) == \
        jtuner.top_pairs(theirs, metric, n_best=4)
    for thr, conf in itertools.product((0.8, 0.9, 0.95), (0.683, 0.954)):
        assert tuner.sample_size_for_confidence(mine, thr, conf, metric) == \
            jtuner.sample_size_for_confidence(theirs, thr, conf, metric)
    assert np.array_equal(tuner.good_permutation_counts(mine, 0.9, metric),
                          jtuner.good_permutation_counts(theirs, 0.9,
                                                         metric))
    if metric == "cycles":
        assert tuner.static_candidates(mine) == {
            k: tuner.Candidate(**dataclasses.asdict(v))
            for k, v in jtuner.static_candidates(theirs).items()}


def _recording(score_batch, log):
    """Wrap a batch scorer so every candidate list it scores is logged."""
    def scored(cands):
        log.append(tuple(tuple(c) for c in cands))
        return score_batch(cands)
    return scored


@pytest.mark.parametrize("search", ["neighbor_swap_search", "bfs_search"])
@pytest.mark.parametrize("name,layer", LAYERS[:8] + LAYERS[8::3],
                         ids=LAYER_IDS[:8] + LAYER_IDS[8::3])
def test_search_paths_and_evaluations_equal(name, layer, search):
    """Every candidate each search scores, in order, its answer and its
    evaluation count, with the batch scorer and with the scalar one."""
    starts = [(0, 1, 2, 3, 4, 5), (5, 4, 3, 2, 1, 0), (2, 0, 4, 1, 5, 3)]
    kw = {"bfs_search": {"budget": 80}, "neighbor_swap_search": {}}[search]
    for start in starts:
        log, jlog = [], []
        got = getattr(tuner, search)(
            None, start, score_batch=_recording(
                tuner.batch_perm_scorer(layer), log), **kw)
        want = getattr(jtuner, search)(
            None, start, score_batch=_recording(
                jtuner.batch_perm_scorer(jlayer(layer)), jlog), **kw)
        assert got == want and log == jlog
    one = getattr(tuner, search)(
        lambda p: cm.simulate(layer, p).cycles, starts[0], **kw)
    jone = getattr(jtuner, search)(
        lambda p: jcm.simulate(jlayer(layer), p).cycles, starts[0], **kw)
    assert one == jone


# ------------------------------------------------------------ registry

@pytest.mark.parametrize("machine", MACHINES)
def test_registry_keys_equal(machine):
    m, jm = machines(machine)
    for _, layer in LAYERS:
        for threads in (1, 4):
            assert reg.conv_sweep_key(layer, m, threads).canonical() == \
                jreg.conv_sweep_key(jlayer(layer), jm, threads).canonical()
            assert reg.ecm_sweep_key(layer, m, threads).canonical() == \
                jreg.ecm_sweep_key(jlayer(layer), jm, threads).canonical()
    assert reg.ecm_correction_key(m).canonical() == \
        jreg.ecm_correction_key(jm).canonical()
    # the Loki model's own version, not the H100 model's
    assert reg.conv_sweep_key(layer, m).cost_model == \
        cm.LOKI_MODEL_VERSION == jcm.COST_MODEL_VERSION != \
        cm.COST_MODEL_VERSION
    assert ecm.ECM_MODEL_VERSION == jecm.ECM_MODEL_VERSION
    for kind in ("conv_sweep", "ecm_sweep", "ecm_correction", "exact_sweep"):
        assert reg.kind_tier(kind) == jreg.kind_tier(kind)
    assert reg.conv_layer_from_problem(
        reg.conv_problem(layer, 4, batch=8)) == \
        ln.ConvLayer(layer.oc, layer.ic, layer.h, layer.w, layer.kh,
                     layer.kw)


@dataclasses.dataclass
class MutableMachine:
    """A mutable (unhashable) machine descriptor."""
    name: str
    size_kb: int
    latencies: list


def test_fingerprint_of_a_mutable_dataclass_equals_jax():
    """An unhashable dataclass takes the uncached path in both packages
    and digests to the same string (the JAX package's fallback)."""
    m = MutableMachine("loki", 64, [3, 10, 30])
    with pytest.raises(TypeError):
        hash(m)
    assert reg.fingerprint(m) == jreg.fingerprint(m)
    m.size_kb = 128
    assert reg.fingerprint(m) == jreg.fingerprint(m)
    assert reg.fingerprint(m) != reg.fingerprint(
        MutableMachine("loki", 64, [3, 10, 30]))


def test_cached_sweep_warm_hit_and_lines_equal(tmp_path):
    layer = sq.TABLE_4_1["fire9-conv1x1-1"]
    path, jpath = str(tmp_path / "p.jsonl"), str(tmp_path / "j.jsonl")
    s = tuner.cached_sweep_layer(layer, registry=reg.TuningRegistry(path))
    jtuner.cached_sweep_layer(jlayer(layer),
                              registry=jreg.TuningRegistry(jpath))
    assert Path(path).read_bytes() == Path(jpath).read_bytes()
    evals = cm.total_evals()
    warm = tuner.cached_sweep_layer(layer, registry=reg.TuningRegistry(path))
    assert cm.total_evals() == evals
    assert np.array_equal(warm.cycles, s.cycles)


def test_warm_registry_sweeps_equal_jax(tmp_path):
    layers = list(sq.TABLE_4_1.values())
    p_reg = reg.TuningRegistry(str(tmp_path / "p.jsonl"))
    done = tuner.warm_registry(layers, p_reg)
    jtuner.warm_registry([jlayer(x) for x in layers],
                         jreg.TuningRegistry(str(tmp_path / "j.jsonl")))
    assert done == {"conv_sweep": 8, "conv_schedule": 8, "skipped": 0}

    def sweeps_of(p):
        return [line for line in (tmp_path / p).read_text().splitlines()
                if json.loads(line)["key"]["kind"] == "conv_sweep"]
    assert sweeps_of("p.jsonl") == sweeps_of("j.jsonl")
    # the schedules are the H100 tuner's, at one image
    for layer in layers:
        rec = p_reg.get(reg.conv_schedule_key(layer, cm.H100Spec(), 2))
        assert [reg.schedule_from_dict(d) for d in rec.value["schedules"]] \
            == [s for s, _ in tuner.tune_conv(layer, top_k=5)]
    evals = cm.total_evals()
    again = tuner.warm_registry(layers, reg.TuningRegistry(
        str(tmp_path / "p.jsonl")))
    assert again == {"conv_sweep": 0, "conv_schedule": 0, "skipped": 16}
    assert cm.total_evals() == evals


def test_design_spaces_equal():
    for fn in ("synthetic_design_space", "synthetic_design_space_mt"):
        mine, theirs = getattr(sq, fn)(), getattr(jsq, fn)()
        assert [dataclasses.asdict(x) for x in mine] == \
            [dataclasses.asdict(x) for x in theirs]
    assert len(sq.synthetic_design_space()) == 216
    assert len(sq.synthetic_design_space_mt()) == 36
