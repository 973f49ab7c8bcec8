"""The port's sharding rules against the JAX package's, entry by entry.

``spec_for_axes`` (both guards, the ``explain=`` hook, the recorded
fallbacks), ``rules_for`` in the three modes, ``shardings_for``,
``_pairing_meta_spec`` and ``paired_shardings_for``, on meshes that carry no
process (``_FakeMesh`` on the JAX side, a shape-only ``Mesh`` on the port's:
both read only ``shape`` and ``axis_names``) of shapes (1, 2), (1, 4),
(2, 4), (16, 16) and (2, 16, 16), for all ten configs; and the port's
``param_axes``/``cache_axes`` against ``abstract_params``/``abstract_cache``.
The cases of ``tests/test_sharding.py`` are mirrored on the port's
functions.  Every comparison is exact (specs are names, not numbers).
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.transform import pair_params as jax_pair_params
from repro.launch.steps import abstract_cache, abstract_params
from repro.models import lm as JM
from repro.models.param import pairing_axes as jax_pairing_axes
from repro.models.param import unzip
from repro.parallel import rules as jax_rules
from repro.parallel import sharding as jsh
from repro_torch.configs import ALL_ARCHS, get_config, get_smoke_config
from repro_torch.core.transform import pair_params
from repro_torch.models import lm as M
from repro_torch.models.param import (
    cache_axes,
    cache_axes_and_shapes,
    pairing_axes,
    param_axes,
    param_axes_and_shapes,
)
from repro_torch.parallel import rules as port_rules
from repro_torch.parallel import sharding as psh
from repro_torch.parallel.sharding import Mesh, P, Rules, spec_for_axes


class _FakeMesh:
    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


SHAPES = {
    "1x2": {"data": 1, "model": 2},
    "1x4": {"data": 1, "model": 4},
    "2x4": {"data": 2, "model": 4},
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
}
MODES = ("train", "prefill", "decode")
RULES = Rules({"batch": ("data",), "ff": "model", "vocab": "model", "q_heads": "model",
               "embed": None})
MESH24 = Mesh({"data": 2, "model": 4})


@functools.cache
def _jax_trees(arch: str):
    shapes, axes = abstract_params(jax_config(arch))
    c_shapes, c_axes = abstract_cache(jax_config(arch), 8, 64)
    return shapes, axes, c_shapes, c_axes


def _shape_tree(t):
    if isinstance(t, dict):
        return {k: _shape_tree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_shape_tree(v) for v in t]
    return tuple(t.shape)


def _entries(spec) -> tuple:
    """A spec's entries, a one-axis tuple as its name (JAX stores it so since
    0.4.3x; older JAX kept the tuple)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def _specs(tree):
    """A spec tree as nested dicts/lists of plain tuples."""
    if isinstance(tree, dict):
        return {k: _specs(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_specs(v) for v in tree]
    return _entries(getattr(tree, "spec", tree))


# -- the trees of logical axes ------------------------------------------------


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_and_cache_axes_equal_abstract_trees(arch):
    shapes, axes, c_shapes, c_axes = _jax_trees(arch)
    p_axes, p_shapes = param_axes_and_shapes(get_config(arch))
    assert p_axes == axes == param_axes(get_config(arch))
    assert _shape_tree(p_shapes) == _shape_tree(shapes)
    q_axes, q_shapes = cache_axes_and_shapes(get_config(arch), 8, 64)
    assert q_axes == c_axes == cache_axes(get_config(arch), 8, 64)
    assert _shape_tree(q_shapes) == _shape_tree(c_shapes)


# -- rules and specs, every config × mode × mesh --------------------------------


@pytest.mark.parametrize("mesh_name", list(SHAPES))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_rules_and_specs_equal_jax(arch, mode, mesh_name):
    shape = SHAPES[mesh_name]
    jm, pm = _FakeMesh(shape), Mesh(shape)
    jr = jax_rules.rules_for(jax_config(arch), mode, jm)
    pr = port_rules.rules_for(get_config(arch), mode, pm)
    assert dict(pr.table) == dict(jr.table)
    shapes, axes, c_shapes, c_axes = _jax_trees(arch)
    _, p_shapes = param_axes_and_shapes(get_config(arch))
    _, q_shapes = cache_axes_and_shapes(get_config(arch), 8, 64)
    with jsh.record_spec_fallbacks() as jfb:
        want = jax.tree.map(lambda a, s: _entries(jsh.spec_for_axes(
            a, mesh=jm, rules=jr, dim_sizes=s.shape)), axes, shapes,
            is_leaf=lambda a: isinstance(a, tuple))
        want_c = jax.tree.map(lambda a, s: _entries(jsh.spec_for_axes(
            a, mesh=jm, rules=jr, dim_sizes=s.shape)), c_axes, c_shapes,
            is_leaf=lambda a: isinstance(a, tuple))
    with psh.record_spec_fallbacks() as pfb:
        got = psh.shardings_for(axes, pm, pr, p_shapes)
        got_c = psh.shardings_for(c_axes, pm, pr, q_shapes)
    assert _specs(got) == want
    assert _specs(got_c) == want_c
    assert pfb == jfb


def test_big_model_rules_shard_embed_over_data():
    mesh = Mesh({"data": 1, "model": 2})
    big = port_rules.rules_for(get_config("mistral-large-123b"), "train", mesh)
    assert big.mesh_axes("embed") == "data", "123B trains with FSDP"
    assert port_rules.rules_for(get_config("qwen2-1.5b"), "train", mesh).mesh_axes("embed") is None
    for mode in MODES:
        r = port_rules.rules_for(get_config("qwen2-1.5b"), mode, mesh)
        assert r.mesh_axes("layers") is None and r.mesh_axes("batch") == ("data",)
        assert r.mesh_axes("pairing_meta") is None
    with pytest.raises(ValueError, match="unknown mode"):
        port_rules.rules_for(get_config("qwen2-1.5b"), "serve", mesh)


# -- the cases of tests/test_sharding.py ------------------------------------------


def test_spec_basic_and_without_mesh():
    assert spec_for_axes(("embed", "ff"), mesh=Mesh({"data": 1, "model": 2}),
                         rules=RULES) == P(None, "model")
    assert tuple(spec_for_axes(("embed", "ff"))) == (None, None)  # nothing active
    with psh.activate(MESH24, RULES):
        assert spec_for_axes(("embed", "ff")) == P(None, "model")
    assert psh.current() == (None, None)


@pytest.mark.parametrize("size,want", [(5, (None,)), (12, ("model",))])
def test_divisibility_guard(size, want):
    mesh = Mesh({"data": 1, "model": 4})
    assert tuple(spec_for_axes(("q_heads",), mesh=mesh, rules=RULES, dim_sizes=(size,))) == want
    assert tuple(spec_for_axes(("q_heads",), mesh=Mesh({"data": 1, "model": 1}), rules=RULES,
                               dim_sizes=(size,))) == ("model",)  # a unit axis divides all


def test_mesh_axis_used_once_and_priority():
    assert spec_for_axes(("ff", "vocab"), mesh=MESH24, rules=RULES) == P(None, "model")
    assert spec_for_axes(("vocab", "ff"), mesh=MESH24, rules=RULES) == P("model", None)
    assert spec_for_axes(("ff", "q_heads"), mesh=MESH24, rules=RULES,
                         dim_sizes=(6, 8)) == P(None, "model")


def test_tuple_overlap_drops_whole_candidate_and_explains():
    rules = Rules({"ff": "model", "batch": ("data", "model")})
    got, want = [], []
    spec = spec_for_axes(("batch", "ff"), mesh=MESH24, rules=rules,
                         explain=lambda a, why: got.append((a, why)))
    jspec = jsh.spec_for_axes(("batch", "ff"), mesh=_FakeMesh(MESH24.shape),
                              rules=jsh.Rules(dict(rules.table)),
                              explain=lambda a, why: want.append((a, why)))
    assert tuple(spec) == tuple(jspec) == (None, "model")
    assert got == want and got[0][0] == "batch"
    reasons = []
    spec_for_axes(("q_heads",), mesh=MESH24, rules=RULES, dim_sizes=(6,),
                  explain=lambda a, why: reasons.append((a, why)))
    assert reasons == [("q_heads", "dim 6 not divisible by mesh axes ['model'] (size 4)")]


def test_record_spec_fallbacks_collects_and_counts():
    with psh.record_spec_fallbacks() as fb:
        spec_for_axes(("q_heads",), mesh=MESH24, rules=RULES, dim_sizes=(6,))
        spec_for_axes(("q_heads",), mesh=MESH24, rules=RULES, dim_sizes=(6,))
        spec_for_axes(("ff", "vocab"), mesh=MESH24, rules=RULES)
    assert len(fb) == 2
    (axis, _), n = next(iter(fb.items()))
    assert axis == "q_heads" and n == 2
    spec_for_axes(("q_heads",), mesh=MESH24, rules=RULES, dim_sizes=(6,))
    assert sum(fb.values()) == 3  # nothing records outside the block


def test_constrain_is_identity():
    import torch

    x = torch.ones(4, 4)
    assert psh.constrain(x, "batch", None) is x


META_CASES = [
    ("wq", ("layers", "embed", "q_heads", "head_dim"), (None, None, "model", None),
     (2, 16, 4, 2), (2, 8, 5)),
    ("wo", ("layers", "q_heads", "head_dim", "embed"), (None, "model", None, None),
     (2, 4, 2, 16), (2, 16, 5)),
    ("wq", ("layers", "embed", "ff"), (None, None, "model"), (2, 16, 12), (2, 6, 5)),
    ("wq", ("layers", "embed", "ff"), (None, None, "model"), (2, 16, 8), (2, 7)),
    ("w_up", ("layers", "experts", "embed", "expert_ff"), (None, "model", None, None),
     (2, 4, 8, 8), (2, 4, 8, 5)),
    ("w_up", ("layers", "experts", "embed", "expert_ff"), (None, "model", None, None),
     (2, 4, 8, 8), (2, 4, 5)),
]


@pytest.mark.parametrize("case", range(len(META_CASES)))
def test_pairing_meta_spec_equals_jax(case):
    name, w_axes, w_spec, w_shape, m_shape = META_CASES[case]
    got = psh._pairing_meta_spec(name, w_axes, P(*w_spec), w_shape, m_shape, MESH24)
    want = jsh._pairing_meta_spec(name, w_axes, JP(*w_spec), w_shape, m_shape,
                                  _FakeMesh(MESH24.shape))
    assert tuple(got) == _entries(want)


@pytest.fixture(scope="module")
def smoke_paired():
    """The qwen2 and olmoe smoke trees paired per column and column-blocked
    (bn 16) by both packages, with their axes."""
    out = {}
    for arch in ("qwen2-1.5b", "olmoe-1b-7b"):
        jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32")
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        vals, axes = unzip(JM.init_lm(jcfg, jax.random.key(0)))
        vals = jax.tree.map(np.asarray, vals)
        model = M.lm_params_from_numpy(vals, cfg, device="cpu")
        for mode, bn in (("per_column", 0), ("column_blocked", 16), ("structured", 0)):
            jp, _ = jax_pair_params(vals, 0.05, mode=mode, block_n=bn, leaves=jcfg.paired_leaves)
            pp, _ = pair_params(model, 0.05, mode=mode, block_n=bn, leaves=cfg.paired_leaves)
            out[arch, mode] = (cfg, jp, pp, axes)
    return out


def _paired_value_tree(model):
    """The port's paired model as the JAX package's value tree: its weights
    stacked, and each layer's metadata stacked beside its weight."""
    import torch

    tree = M.lm_value_tree(model)
    start = 0
    for si, (_, count) in enumerate(model.segments):
        for sub_name, sub in model.layers[start].named_children():
            for name in getattr(sub, "pairing", {}):
                tree["segments"][si][sub_name][name + "_pairing"] = {
                    k: torch.stack([getattr(model.layers[start + l], sub_name).pairing[name][k]
                                    for l in range(count)])
                    for k in sub.pairing[name]}
        start += count
    return tree


@pytest.mark.parametrize("mesh_name", ["1x2", "1x4", "2x4"])
@pytest.mark.parametrize("mode", ["per_column", "column_blocked", "structured"])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "olmoe-1b-7b"])
def test_paired_shardings_for_equals_jax(smoke_paired, arch, mode, mesh_name, monkeypatch):
    cfg, jp, pp, axes = smoke_paired[arch, mode]
    shape = SHAPES[mesh_name]
    jm, pm = _FakeMesh(shape), Mesh(shape)
    jr = jax_rules.rules_for(jax_smoke_config(arch), "decode", jm)
    pr = port_rules.rules_for(cfg, "decode", pm)
    # the JAX function's own walk, its NamedSharding (which needs devices) kept as the spec
    monkeypatch.setattr(jsh, "NamedSharding", lambda mesh, spec: _entries(spec))
    want = jsh.paired_shardings_for(jax_pairing_axes(jp, axes), jm, jr, jp)
    tree = _paired_value_tree(pp)
    got = psh.paired_shardings_for(pairing_axes(tree, axes), pm, pr, tree)
    assert _specs(got) == want
    # the metadata shapes agree with the JAX package's, so do the placements
    assert _shape_tree(tree) == _shape_tree(jax.tree.map(np.asarray, jp))


def test_make_mesh_refuses_without_process_group_and_nccl_past_the_cards(monkeypatch):
    import torch
    import torch.distributed as dist

    with pytest.raises(RuntimeError, match="initialised"):
        psh.make_mesh((1, 2), ("data", "model"), backend="gloo", device="cpu")
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 0)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="a card a rank"):
        psh.make_mesh((1, 2), ("data", "model"), backend="nccl", device="cuda")
    with pytest.raises(ValueError, match="runs 'nccl', not 'gloo'"):
        psh.make_mesh((1, 2), ("data", "model"), backend="gloo", device="cpu")
    with pytest.raises(ValueError, match="needs 4 ranks"):
        psh.make_mesh((2, 2), ("data", "model"), backend="nccl", device="cuda")


def test_mesh_coordinates_row_major():
    m = Mesh({"pod": 2, "data": 2, "model": 4}, rank=13)
    assert m.coords == {"pod": 1, "data": 1, "model": 1}
    assert m.index(("pod", "data")) == 3 and m.index("model") == 1
    assert m.axis_size(("pod", "data")) == 4 and m.axis_size(None) == 1
    assert Mesh({"data": 1, "model": 4}).group("data") is None  # one rank: no group
    with pytest.raises(KeyError, match="make_mesh"):  # a shape-only mesh has no processes
        m.group("model")


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_shape_equals_jax(multi_pod, monkeypatch):
    """Over the JAX package's 256 and 512 chips the port lays its ranks out
    as ``repro.launch.mesh.make_production_mesh`` does (its mesh builder
    stubbed to hand back the shape and axes it was given)."""
    from repro.launch import mesh as jmesh
    from repro_torch.launch import mesh as pmesh

    monkeypatch.setattr(jmesh, "make_mesh_compat", lambda shape, axes: (tuple(shape), tuple(axes)))
    want = jmesh.make_production_mesh(multi_pod=multi_pod)
    assert pmesh.production_mesh_shape(512 if multi_pod else 256, multi_pod=multi_pod) == want
    # make_production_mesh reads the world from the process group
    import torch.distributed as dist

    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 512 if multi_pod else 256)
    monkeypatch.setattr(pmesh, "make_mesh", lambda shape, names, **kw: (shape, names, kw))
    assert pmesh.make_production_mesh(multi_pod=multi_pod, backend="gloo", device="cpu") == (
        *want, {"backend": "gloo", "device": "cpu"})


def test_production_mesh_shape_on_fewer_ranks():
    from repro_torch.launch.mesh import production_mesh_shape

    assert production_mesh_shape(4) == ((1, 4), ("data", "model"))
    assert production_mesh_shape(24) == ((3, 8), ("data", "model"))
    assert production_mesh_shape(8, multi_pod=True) == ((2, 1, 4), ("pod", "data", "model"))
    assert production_mesh_shape(96, multi_pod=True) == ((2, 3, 16), ("pod", "data", "model"))
    with pytest.raises(ValueError, match="two pods"):
        production_mesh_shape(3, multi_pod=True)
