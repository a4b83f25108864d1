"""The port's sharding rules against the JAX package's, spec for spec.

``repro_torch.runtime.sharding`` resolves the same logical axes to the
same mesh axes as ``repro.runtime.sharding``: the eight cases of
``tests/test_sharding.py`` on the same mesh shapes (16 x 16 and
2 x 16 x 16), then a sweep of every smoke config's parameter, batch and
cache specs on five meshes (tolerance 0: specs are compared as tuples,
JAX's ``PartitionSpec`` entries of one name normalised to the name).
The axes trees themselves equal JAX's ``Model.init(...)[1]``.  No mesh
runs here: a stand-in with ``mesh_dim_names`` and ``shape`` is all the
rules read (the multi-process checks are
``tests/test_torch_distributed.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.runtime import sharding as jshd  # noqa: E402
from repro_torch.configs import SHAPES, get_config, list_archs  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.runtime import sharding as shd  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402

ARCHS = [a + "-smoke" for a in list_archs()]
MESH_SHAPES = [((16, 16), ("data", "model")),
               ((2, 16, 16), ("pod", "data", "model")),
               ((2, 2), ("data", "model")),
               ((4, 1), ("data", "model")),
               ((1, 1), ("data", "model"))]


class FakeMesh:
    """Axis names and shape: all both packages' rules read.  JAX reads
    ``axis_names`` and ``devices.shape``; the port ``mesh_dim_names``
    and ``shape``."""

    def __init__(self, names, shape):
        self.axis_names = self.mesh_dim_names = tuple(names)
        self.shape = tuple(shape)
        self.devices = np.empty(tuple(shape), dtype=object)


MESH = FakeMesh(("data", "model"), (16, 16))
MESH3 = FakeMesh(("pod", "data", "model"), (2, 16, 16))
RULES = shd.ShardingRules()
JRULES = jshd.ShardingRules()


def _norm(spec):
    """A JAX spec as the port's tuple (``("pod",)`` -> ``"pod"``)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _spec_leaves(tree):
    """A spec tree's specs in JAX's leaf order (sorted keys); a spec is
    a tuple, so the port's tree walkers would open it."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _spec_leaves(tree[k])]
    return [tree]


def _both(axes, shape, mesh, rules=RULES, jrules=JRULES):
    """The port's spec, asserted equal to JAX's."""
    got = shd.resolve_spec(axes, shape, mesh, rules)
    assert got == _norm(jshd.resolve_spec(axes, shape, mesh, jrules))
    return got


def test_basic_tp_fsdp():
    assert _both(("layers", "embed", "ffn"), (64, 5120, 25600),
                 MESH) == (None, "data", "model")


def test_multipod_embed_gets_both():
    assert _both(("layers", "embed", "ffn"), (64, 5120, 25600),
                 MESH3) == (None, ("pod", "data"), "model")


def test_indivisible_drops():
    spec = _both(("layers", "embed", "kv_heads"), (38, 4096, 128), MESH)
    assert spec[2] == "model"
    spec = _both(("layers", "embed", "kv_heads"), (38, 4096, 8), MESH)
    assert spec[2] is None


def test_no_double_axis_use():
    assert _both(("heads", "ffn"), (512, 512), MESH) == ("model", None)


def test_partial_prefix_for_multiaxis_rule():
    assert _both(("embed",), (4,), MESH3) == ("pod",)


def test_batch_spec_decode_batch1():
    for shape, want in (((1, 1), (None, None)), ((256, 4096),
                                                  ("data", None))):
        got = shd.batch_spec(shape, MESH, RULES)
        assert got == want == _norm(jshd.batch_spec(shape, MESH, JRULES))


def test_cache_specs_pattern_match():
    shape = (64, 128, 8, 32768, 128)
    cache = {"layers": {"k": torch.empty(shape, device="meta"),
                        "v": torch.empty(shape, device="meta")}}
    jcache = {"layers": {n: jax.ShapeDtypeStruct(shape, "bfloat16")
                         for n in ("k", "v")}}
    specs = shd.cache_specs(cache, MESH, RULES)
    jspecs = jshd.cache_specs(jcache, MESH, JRULES)
    assert specs["layers"]["k"] == (None, "data", None, None, None)
    for n in ("k", "v"):
        assert specs["layers"][n] == _norm(jspecs["layers"][n])


def test_seq_override_rule():
    rules = RULES.with_overrides(seq=("model",))
    jrules = JRULES.with_overrides(seq=("model",))
    assert _both(("batch", "seq", "act_embed"), (256, 4096, 5120), MESH,
                 rules, jrules) == ("data", "model", None)
    assert RULES.rules["seq"] == ()        # the original is untouched


@pytest.mark.parametrize("arch", ARCHS)
def test_axes_tree_equals_jax(arch):
    """``Model.axes_tree()`` (built on the meta device) is JAX's axes
    tree, and ``abstract_params()`` has JAX's shapes and dtypes."""
    model = build_model(get_config(arch))
    jparams, jaxes = jax_build_model(jax_get_config(arch)).init(
        jax.random.key(0))
    assert model.axes_tree() == jaxes
    got = flatten_with_paths(model.abstract_params())
    want = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert [p for p, _ in got] == ["/".join(k.key for k in path)
                                   for path, _ in want]
    for (_, t), (_, a) in zip(got, want):
        assert t.device.type == "meta"
        assert tuple(t.shape) == a.shape
        assert str(t.dtype).split(".")[-1] == str(a.dtype)


def test_abstract_params_draw_nothing():
    """Building the abstract tree leaves a real init's draws as they
    were (no generator is consumed, no storage made)."""
    model = build_model(get_config("phi3-mini-3.8b-smoke"))
    before = model.init(seed=5, device="cpu")
    model.abstract_params()
    model.axes_tree()
    after = model.init(seed=5, device="cpu")
    for (_, a), (_, b) in zip(flatten_with_paths(before),
                              flatten_with_paths(after)):
        assert torch.equal(a, b)
    full = build_model(get_config("qwen3-32b")).abstract_params()
    assert full["layers"]["mlp"]["w1"].shape == (64, 5120, 25600)


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_sweep_equals_jax(arch):
    """Parameter, batch and cache specs of ``arch`` on five meshes equal
    JAX's leaf for leaf."""
    model = build_model(get_config(arch))
    jmodel = jax_build_model(jax_get_config(arch))
    axes = model.axes_tree()
    abstract = model.abstract_params()
    jabstract = jmodel.abstract_params()
    for shape, names in MESH_SHAPES:
        mesh = FakeMesh(names, shape)
        specs = shd.tree_specs(axes, abstract, mesh, RULES)
        jspecs = jshd.tree_specs(axes, jabstract, mesh, JRULES)
        got = _spec_leaves(specs)
        want = [_norm(s) for s in jax.tree.leaves(
            jspecs, is_leaf=lambda x: isinstance(x, P))]
        assert got == want, (arch, shape)
        for cell in ("train_4k", "decode_32k"):
            small = dataclasses.replace(SHAPES[cell], seq_len=32,
                                        global_batch=32)
            jsmall = dataclasses.replace(JSHAPES[cell], seq_len=32,
                                         global_batch=32)
            batch = {k: torch.empty(s, device="meta")
                     for k, (s, _) in model.input_specs(small).items()}
            bs = shd.batch_specs(batch, mesh, RULES)
            jbs = jshd.batch_specs(jmodel.input_specs(jsmall), mesh,
                                   JRULES)
            assert {k: s for k, s in bs.items()} == {
                k: _norm(s) for k, s in jbs.items()}, (arch, cell)
            if cell == "decode_32k":
                cs = shd.cache_specs(model.cache_specs(small), mesh, RULES)
                jcs = jshd.cache_specs(jmodel.cache_specs(jsmall), mesh,
                                       JRULES)
                assert _spec_leaves(cs) == [
                    _norm(s) for s in jax.tree.leaves(
                        jcs, is_leaf=lambda x: isinstance(x, P))], arch


def test_input_specs_take_a_shape_config():
    """``Model.input_specs`` accepts a ``ShapeConfig`` as JAX's does,
    with JAX's shapes for every family and kind."""
    for arch in ARCHS:
        model = build_model(get_config(arch))
        jmodel = jax_build_model(jax_get_config(arch))
        for name in SHAPES:
            small = dataclasses.replace(SHAPES[name], seq_len=32,
                                        global_batch=4)
            jsmall = dataclasses.replace(JSHAPES[name], seq_len=32,
                                         global_batch=4)
            got = {k: s for k, (s, _) in model.input_specs(small).items()}
            want = {k: v.shape for k, v in
                    jmodel.input_specs(jsmall).items()}
            assert got == want, (arch, name)


def test_placements_follow_mesh_order():
    """A dimension over ``("pod", "data")`` is ``Shard(d)`` on both
    mesh dimensions (DTensor splits mesh-dimension-major, pod first, as
    JAX splits ``P(("pod", "data"))``); an axis out of mesh order is
    refused."""
    from torch.distributed.tensor import Replicate, Shard
    spec = (None, ("pod", "data"), "model")
    assert shd.placements(spec, MESH3) == [Shard(1), Shard(1), Shard(2)]
    assert shd.placements((None, None), MESH) == [Replicate(), Replicate()]
    assert shd.placements(("model", "data"), MESH) == [Shard(1), Shard(0)]
    with pytest.raises(ValueError, match="mesh's axis order"):
        shd.placements(((("data", "pod")),), MESH3)


def test_activation_shard_fn_passes_plain_tensors():
    """Non-DTensors, non-3-D tensors and all-None specs pass unchanged
    (a mesh stand-in suffices: nothing is redistributed)."""
    fn = shd.make_activation_shard_fn(MESH, RULES)
    x = torch.ones(4, 8, 16)
    assert fn(x) is x and fn(x, "experts") is x
    assert shd.mesh_contains(MESH, "model")
    assert not shd.mesh_contains(MESH, "pod")
