"""Shard-boundary pairing against the JAX package's, index for index.

The sharded builders (``pair_rows_structured_sharded``,
``pair_rows_blocked_sharded``, ``concat_structured``) on seeded weights
whose near pairs cross slab boundaries; ``tp_shard_plan`` on the qwen2 and
olmoe smoke trees; ``pair_params(shards=…)``'s reports (``n_pairs``,
``row_shards``, ``col_shards``, ``shard_pairs``) on those trees at
r = 0.05, including the README's 2×4 per-column figures; and each rank's
own build (``pair_shard_params``): its lane lists are the slice of the
shard-aware build that its weight shard reads.  Every comparison is exact.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import pairing as jp
from repro.core.transform import pair_params as jax_pair_params
from repro.core.transform import tp_shard_plan as jax_tp_shard_plan
from repro.models import lm as JM
from repro.models.param import unzip
from repro.parallel.rules import rules_for as jax_rules_for
from repro_torch.configs import get_smoke_config
from repro_torch.core import pairing as pp
from repro_torch.core.transform import pair_params, pair_shard_params, tp_shard_plan
from repro_torch.launch.steps import shard_model
from repro_torch.models import lm as M
from repro_torch.models.param import param_axes_and_shapes
from repro_torch.parallel.rules import rules_for
from repro_torch.parallel.sharding import Mesh, shardings_for


class _FakeMesh:
    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


def _pairable(rng, K, N, noise=0.01):
    """Rows 2i+1 ≈ −row 2i, shuffled so near pairs cross slab boundaries."""
    base = rng.normal(size=(K // 2, N))
    W = np.empty((K, N))
    W[0::2] = base
    W[1::2] = -base + noise * rng.normal(size=base.shape)
    return W[rng.permutation(K)]


def _same_structured(a, b):
    for key in ("I", "J", "resid"):
        np.testing.assert_array_equal(np.asarray(getattr(a, key)), np.asarray(getattr(b, key)))
    np.testing.assert_array_equal(np.asarray(a.Kmat), np.asarray(b.Kmat))
    np.testing.assert_array_equal(np.asarray(a.W_res), np.asarray(b.W_res))
    assert tuple(a.shape) == tuple(b.shape)


@pytest.mark.parametrize("rs", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_structured_sharded_equals_jax(seed, rs):
    W = _pairable(np.random.default_rng(seed), 64, 32)
    got = pp.pair_rows_structured_sharded(W, 0.1, row_shards=rs)
    _same_structured(got, jp.pair_rows_structured_sharded(W, 0.1, row_shards=rs))
    if rs in (2, 4, 8):  # slab-local pairs, fewer than unsharded
        step = 64 // rs
        assert np.array_equal(np.asarray(got.I) // step, np.asarray(got.J) // step)
        assert 0 < len(got.I) <= len(pp.pair_rows_structured(W, 0.1).I)


@pytest.mark.parametrize("rs,bn", [(1, 4), (2, 4), (2, 1), (4, 3), (3, 4), (4, 16)])
def test_blocked_sharded_equals_jax(rs, bn):
    W = _pairable(np.random.default_rng(3), 32, 16)
    got = pp.pair_rows_blocked_sharded(W, 0.1, bn, row_shards=rs)
    want = jp.pair_rows_blocked_sharded(W, 0.1, bn, row_shards=rs)
    assert got.n_blocks == want.n_blocks and got.block_n == want.block_n
    for a, b in zip(got.blocks, want.blocks, strict=True):
        _same_structured(a, b)
    assert got.weighted_pairs == want.weighted_pairs
    lanes = pp.pair_rows_blocked_sharded(W, 0.1, bn, row_shards=rs, magnitudes=False)
    for a, b in zip(lanes.blocks, got.blocks, strict=True):
        np.testing.assert_array_equal(a.I, b.I)
        np.testing.assert_array_equal(a.resid, b.resid)


def test_concat_structured_equals_jax():
    W = _pairable(np.random.default_rng(4), 48, 8)
    parts = [pp.pair_rows_structured(W[o:o + 16], 0.1) for o in (0, 16, 32)]
    jparts = [jp.pair_rows_structured(W[o:o + 16], 0.1) for o in (0, 16, 32)]
    _same_structured(pp.concat_structured(parts, [0, 16, 32], (48, 8)),
                     jp.concat_structured(jparts, [0, 16, 32], (48, 8)))
    empty = pp.concat_structured([], [], (48, 8))
    assert empty.n_pairs == 0 and empty.Kmat.shape == (0, 8)


@pytest.fixture(scope="module")
def smoke():
    """The qwen2 and olmoe smoke trees (JAX init, fp32), in both packages."""
    out = {}
    for arch in ("qwen2-1.5b", "olmoe-1b-7b"):
        jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32")
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        vals, axes = unzip(JM.init_lm(jcfg, jax.random.key(0)))
        vals = jax.tree.map(np.asarray, vals)
        out[arch] = (jcfg, cfg, vals, axes, M.lm_params_from_numpy(vals, cfg, device="cpu"))
    return out


MESHES = {"1x2": {"data": 1, "model": 2}, "1x4": {"data": 1, "model": 4},
          "2x4": {"data": 2, "model": 4}}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "olmoe-1b-7b"])
def test_tp_shard_plan_equals_jax(smoke, arch, mesh_name):
    jcfg, cfg, vals, axes, _ = smoke[arch]
    jm, pm = _FakeMesh(MESHES[mesh_name]), Mesh(MESHES[mesh_name])
    want = jax_tp_shard_plan(axes, vals, jm, jax_rules_for(jcfg, "decode", jm),
                             leaves=jcfg.paired_leaves)
    p_axes, shapes = param_axes_and_shapes(cfg)
    got = tp_shard_plan(p_axes, shapes, pm, rules_for(cfg, "decode", pm), leaves=cfg.paired_leaves)
    assert got == want
    got_vals = tp_shard_plan(p_axes, M.lm_value_tree(smoke[arch][4]), pm,
                             rules_for(cfg, "decode", pm), leaves=cfg.paired_leaves)
    assert got_vals == want
    if arch == "qwen2-1.5b" and mesh_name == "2x4":  # tests/test_shard_pairing.py's case
        assert got[("attn", "wq")] == (1, 4) and got[("attn", "wk")] == (1, 1)
        assert got[("attn", "wo")] == (4, 1) and got[("mlp", "w_down")] == (4, 1)


def _report(rep):
    return [(lr.path, lr.shape, lr.n_weights, lr.n_pairs, lr.row_shards, lr.col_shards,
             lr.shard_pairs) for lr in rep.leaves]


@pytest.mark.parametrize("mode,bn", [("per_column", 0), ("structured", 0), ("column_blocked", 16)])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "olmoe-1b-7b"])
def test_pair_params_shards_report_equals_jax(smoke, arch, mesh_name, mode, bn):
    jcfg, cfg, vals, axes, model = smoke[arch]
    jm = _FakeMesh(MESHES[mesh_name])
    plan = jax_tp_shard_plan(axes, vals, jm, jax_rules_for(jcfg, "decode", jm),
                             leaves=jcfg.paired_leaves)
    _, want = jax_pair_params(vals, 0.05, mode=mode, block_n=bn, leaves=jcfg.paired_leaves,
                              shards=plan)
    _, got = pair_params(model, 0.05, mode=mode, block_n=bn, leaves=cfg.paired_leaves,
                         shards=plan)
    assert _report(got) == _report(want)
    for lr in got.leaves:
        assert lr.shard_pairs is None or sum(lr.shard_pairs) == lr.n_pairs


def test_readme_smoke_ledger_2x4(smoke):
    """The README's "Distributed paired decode" figures on the 2×4 smoke
    mesh, per column at r = 0.05: the column-sharded wq keeps its
    single-host count, the row-sharded wo and w_down lose pairs to the
    slab constraint.  The README's numbers (wq 3656 = 3656; wo 3028 against
    3682; w_down 6986 against 7638) came from another JAX release's random
    stream (JAX 0.9.0 here gives wq 3674 = 3674; wo 3018 against 3667;
    w_down 6941 against 7628), which both packages reproduce."""
    jcfg, cfg, vals, axes, model = smoke["qwen2-1.5b"]
    jm = _FakeMesh(MESHES["2x4"])
    plan = jax_tp_shard_plan(axes, vals, jm, jax_rules_for(jcfg, "decode", jm),
                             leaves=jcfg.paired_leaves)
    _, sharded = pair_params(model, 0.05, mode="per_column", leaves=cfg.paired_leaves,
                             shards=plan)
    _, single = pair_params(model, 0.05, mode="per_column", leaves=cfg.paired_leaves)
    _, jsharded = jax_pair_params(vals, 0.05, mode="per_column", leaves=jcfg.paired_leaves,
                                  shards=plan)
    _, jsingle = jax_pair_params(vals, 0.05, mode="per_column", leaves=jcfg.paired_leaves)
    by = lambda rep: {lr.path.split(".")[-1]: lr.n_pairs for lr in rep.leaves}
    got, one = by(sharded), by(single)
    assert (got, one) == (by(jsharded), by(jsingle))
    assert got["wq"] == one["wq"]
    assert got["wo"] < one["wo"] and got["w_down"] < one["w_down"]
    if jax.__version__ == "0.9.0":
        assert (got["wq"], got["wo"], one["wo"], got["w_down"], one["w_down"]) == (
            3674, 3018, 3667, 6941, 7628)


@pytest.mark.parametrize("mode,bn", [("per_column", 1), ("structured", 0), ("column_blocked", 16)])
@pytest.mark.parametrize("mesh_name", ["1x2", "1x4"])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "olmoe-1b-7b"])
def test_rank_builds_its_slice_of_the_shard_aware_build(smoke, arch, mesh_name, mode, bn):
    """Rank r's metadata (pair_shard_params on its shard) is what the
    shard-aware global build puts on its shard: a row-parallel leaf's slab
    lanes rebased to the slab, a column-blocked leaf's blocks of the rank's
    columns, a structured column-parallel leaf's whole lane lists, every
    expert of the rank's own."""
    _, cfg, _, _, model = smoke[arch]
    shape = MESHES[mesh_name]
    n = shape["model"]
    p_axes, shapes = param_axes_and_shapes(cfg)
    rules = rules_for(cfg, "decode", Mesh(shape))
    plan = tp_shard_plan(p_axes, shapes, Mesh(shape), rules, leaves=cfg.paired_leaves)
    glob, _ = pair_params(model, 0.05, mode=mode, block_n=bn, leaves=cfg.paired_leaves,
                          shards=plan)
    for r in range(n):
        mesh = Mesh(shape, rank=r)
        local = shard_model(model, shardings_for(p_axes, mesh, rules, shapes), mesh)
        mine, rep = pair_shard_params(local, model, 0.05, shards=plan, mode=mode, block_n=bn,
                                      leaves=cfg.paired_leaves)
        assert {lr.path: (lr.row_shards, lr.col_shards) for lr in rep.leaves}
        for lg, ll in zip(glob.layers, mine.layers, strict=True):
            for (sub, name), (rs, cs) in plan.items():
                g = getattr(lg, sub).pairing[name]
                m = getattr(ll, sub).pairing[name]
                w = getattr(getattr(model.layers[0], sub), name)
                expert = sub == "moe"
                if expert:  # the rank's experts, each paired whole
                    E = w.shape[0] // n
                    g = {k: v[r * E:(r + 1) * E] for k, v in g.items()}
                elif cs > 1 and mode != "structured":  # the rank's blocks
                    B = g["I"].shape[0] // cs
                    g = {k: v[r * B:(r + 1) * B] for k, v in g.items()}
                for key in ("I", "J", "resid"):
                    gl, ml = g[key], m[key]
                    gmask = g["pair_mask" if key != "resid" else "resid_mask"] > 0
                    mmask = m["pair_mask" if key != "resid" else "resid_mask"] > 0
                    if rs > 1:  # the slab's lanes, rebased to the slab
                        K = (w.shape[0] * w.shape[1]) if name == "wo" else w.shape[0]
                        step = K // rs
                        gl = gl - r * step
                        gmask = gmask & (gl >= 0) & (gl < step)
                    got = [ml[i][mmask[i]].tolist() for i in range(ml.shape[0])] \
                        if ml.ndim == 2 else ml[mmask].tolist()
                    want = [gl[i][gmask[i]].tolist() for i in range(gl.shape[0])] \
                        if gl.ndim == 2 else gl[gmask].tolist()
                    if ml.ndim == 3:  # experts × blocks
                        got = [[ml[e, b][mmask[e, b]].tolist() for b in range(ml.shape[1])]
                               for e in range(ml.shape[0])]
                        want = [[gl[e, b][gmask[e, b]].tolist() for b in range(gl.shape[1])]
                                for e in range(gl.shape[0])]
                    assert got == want, (r, sub, name, key)
