"""Each mesh rank builds only its own shards, leaf by leaf.

``launch.steps.local_model`` (``models.lm.init_lm_local`` over
``models.lm.lm_leaves``) against the whole-model path, on meshes that carry
no process (a shape-only ``Mesh`` at each rank's coordinates), for every
family's smoke config on (1, 2) and (2, 2), under its own ``train`` and
``decode`` rules and, for mistral-large-123b, under its published config's
(FSDP: ``embed`` over ``data``):

* from an ``init_lm`` seed and from a value tree of the JAX package's
  layout (numpy arrays, what ``lm_params_from_numpy`` reads), every
  block is ``shard_model``'s of the whole model bit for bit, in the same
  parameter order; ``init_lm`` itself is ``init_lm_local`` with every leaf
  kept;
* the pairing made leaf by leaf, while each whole leaf exists
  (``core.transform.premade_entry``, then ``pair_shard_params(premade=…)``),
  equals ``pair_shard_params`` on the rank's shard of the whole model, lane
  for lane (structured and column-blocked at r = 0.05, ``init_lm``'s
  matrices scaled by 0.3 so pairs form), with the same report;
* under FSDP a rank's lane lists are its slab of the JAX-equal shard-aware
  build (``pair_params(shards=…)``): the rows of its data slab (wq, w_gate)
  or of its model slab (wo, w_down), rebased to the slab;
* the train CLI's fold (``--paired-rounding``) made leaf by leaf
  (``core.transform.leaf_folder``) gives the blocks of ``fold_lm_params``'
  whole model, bit for bit, with its pair totals; the CLI on a (1, 2) mesh
  prints the single-device fold's line and its losses.
"""
import dataclasses
import functools

import pytest
import torch

from repro_torch.configs import ALL_ARCHS, get_config, get_smoke_config
from repro_torch.core.transform import (
    fold_lm_params,
    leaf_folder,
    pair_params,
    pair_shard_params,
    premade_entry,
    row_lead_dim,
    tp_shard_plan,
)
from repro_torch.launch.steps import leaf_specs, local_model, shard_model
from repro_torch.models import lm as M
from repro_torch.models.param import param_axes_and_shapes
from repro_torch.parallel.rules import rules_for
from repro_torch.parallel.sharding import Mesh, shardings_for

MESHES = [(1, 2), (2, 2)]
FSDP = "mistral-large-123b"


def _mesh(shape, rank=0):
    return Mesh(dict(zip(("data", "model"), shape, strict=True)), rank=rank)


def _cfg(arch):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32")


def _rules(arch, mode, mesh):
    return rules_for(get_config(arch) if arch == FSDP else _cfg(arch), mode, mesh)


def _specs(arch, mode, mesh):
    axes, shapes = param_axes_and_shapes(_cfg(arch))
    return shardings_for(axes, mesh, _rules(arch, mode, mesh), shapes)


@functools.cache
def _whole(arch, seed=0):
    return M.init_lm(_cfg(arch), seed, device="cpu")


@functools.cache
def _value_tree(arch):
    """A value tree of numpy arrays in the JAX package's layout
    (``models.lm.lm_value_tree``, what ``lm_params_from_numpy`` reads)."""
    def numpy(tree):
        if isinstance(tree, dict):
            return {k: numpy(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [numpy(v) for v in tree]
        return tree.numpy()

    return numpy(M.lm_value_tree(M.init_lm(_cfg(arch), 3, device="cpu")))


@functools.cache
def _scaled(arch):
    """``init_lm``'s weights, every matrix times 0.3 so pairs form at r = 0.05."""
    model = M.init_lm(_cfg(arch), 0, device="cpu")
    with torch.no_grad():
        for p in model.parameters():
            if p.ndim >= 2:
                p.mul_(0.3)
    return model


def _same(a: M.LM, b: M.LM):
    na, nb = list(a.named_parameters()), list(b.named_parameters())
    assert [n for n, _ in na] == [n for n, _ in nb]
    for (n, x), (_, y) in zip(na, nb, strict=True):
        assert x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y), n


@pytest.mark.parametrize("mode", ["train", "decode"])
@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_blocks_from_a_seed_equal_the_whole_models(arch, shape, mode):
    """Every rank's blocks, built leaf by leaf from the seed, are
    ``shard_model``'s of ``init_lm``, bit for bit, in the same order."""
    cfg = _cfg(arch)
    for rank in range(shape[0] * shape[1]):
        mesh = _mesh(shape, rank)
        specs = _specs(arch, mode, mesh)
        _same(local_model(cfg, 0, specs, mesh), shard_model(_whole(arch), specs, mesh))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_init_lm_keeps_every_leaf(arch):
    """``init_lm`` is ``init_lm_local`` with no ``keep``, and a model as the
    source gives its own leaves back: the draws are the same whoever
    consumes them."""
    cfg = _cfg(arch)
    _same(M.init_lm_local(cfg, 7, device="cpu"), M.init_lm(cfg, 7, device="cpu"))
    _same(M.init_lm_local(cfg, _whole(arch), device="cpu"), _whole(arch))
    names = [n for n, _ in M.lm_leaves(cfg, 0, device="cpu")]
    assert sorted(names) == sorted(n for n, _ in _whole(arch).named_parameters())


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_blocks_from_a_value_tree_equal_the_whole_models(arch):
    """From a value tree of the JAX package's layout:
    ``lm_params_from_numpy``'s model sliced, bit for bit; a tree that
    carries pairing metadata is refused."""
    cfg, vals = _cfg(arch), _value_tree(arch)
    whole = M.lm_params_from_numpy(vals, cfg, device="cpu")
    _same(M.init_lm_local(cfg, vals, device="cpu"), whole)
    mesh = _mesh((2, 2), 3)
    specs = _specs(arch, "train", mesh)
    _same(local_model(cfg, vals, specs, mesh), shard_model(whole, specs, mesh))
    seg = dict(vals["segments"][0])
    seg["ln1"] = {**seg["ln1"], "scale_pairing": {}}
    with pytest.raises(ValueError, match="pairing metadata"):
        list(M.lm_leaves(cfg, {**vals, "segments": [seg, *vals["segments"][1:]]},
                         device="cpu"))


def _leaf_paired(arch, shape, rank, mode, block_n, mesh_mode="decode"):
    """(the leaf-by-leaf pairing, ``pair_shard_params`` on the whole model's
    shard), each ``(model, report)``."""
    cfg, whole = _cfg(arch), _scaled(arch)
    mesh = _mesh(shape, rank)
    axes, shapes = param_axes_and_shapes(cfg)
    rules = _rules(arch, mesh_mode, mesh)
    specs = shardings_for(axes, mesh, rules, shapes)
    plan = tp_shard_plan(axes, shapes, mesh, rules, leaves=cfg.paired_leaves)
    kw = dict(shards=plan, mode=mode, block_n=block_n, leaves=cfg.paired_leaves)
    premade = {}

    def on_leaf(name, whole, block, spec):
        got = premade_entry(name, whole, block, spec, mesh, 0.05, **kw)
        if got is not None:
            premade[got[0]] = got[1]

    local = local_model(cfg, whole, specs, mesh, on_leaf=on_leaf)
    mine = pair_shard_params(local, None, 0.05, premade=premade, **kw)
    theirs = pair_shard_params(shard_model(whole, specs, mesh), whole, 0.05, mesh=mesh,
                               specs=specs, **kw)
    return mine, theirs, (whole, specs, plan, mesh)


def _metas(model):
    return {f"{prefix}.{name}": meta for prefix, block in model.named_modules()
            for name, meta in getattr(block, "pairing", {}).items()}


@pytest.mark.parametrize("mode,bn", [("structured", 0), ("column_blocked", 4)])
@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_leaf_by_leaf_pairing_equals_the_whole_models(arch, shape, mode, bn):
    for rank in (0, shape[0] * shape[1] - 1):
        (mine, rep), (theirs, want), _ = _leaf_paired(arch, shape, rank, mode, bn)
        got, exp = _metas(mine), _metas(theirs)
        assert got.keys() == exp.keys() and got
        for key in got:
            for k in got[key]:
                assert torch.equal(got[key][k], exp[key][k]), (rank, key, k)
        assert [(lr.path, lr.n_pairs, lr.row_shards, lr.col_shards) for lr in rep.leaves] == \
            [(lr.path, lr.n_pairs, lr.row_shards, lr.col_shards) for lr in want.leaves]


@pytest.mark.parametrize("mode,bn", [("structured", 0), ("column_blocked", 4)])
def test_fsdp_rank_pairs_its_slab_of_the_shard_aware_build(mode, bn):
    """Under mistral's published ``train`` rules on (2, 2) each rank's lane
    lists are its slab of ``pair_params(shards=…)``'s (the JAX package's:
    ``test_torch_fsdp.py``): wq's rows by its data index, wo's by its model
    index, each rebased to the slab; a column-blocked leaf's blocks are its
    columns'."""
    for rank in range(4):
        (mine, _), _, (whole, specs, plan, mesh) = _leaf_paired(FSDP, (2, 2), rank, mode, bn,
                                                                "train")
        glob, _ = pair_params(whole, 0.05, mode=mode, block_n=bn, leaves=_cfg(FSDP).paired_leaves,
                              shards=plan)
        by = leaf_specs(_cfg(FSDP), specs)
        for (l_g, l_m) in zip(glob.layers, mine.layers, strict=True):
            for (sub, name), (rs, cs) in plan.items():
                g, m = getattr(l_g, sub).pairing[name], getattr(l_m, sub).pairing[name]
                w = getattr(getattr(whole.layers[0], sub), name)
                spec = by[f"layers.0.{sub}.{name}"]
                K = (w.shape[0] * w.shape[1]) if name == "wo" else w.shape[0]
                slab = mesh.index(spec[row_lead_dim(name, False)])
                if mode == "column_blocked" and cs > 1:
                    col = spec[-1] if name == "wo" else spec[1]
                    n_b = g["I"].shape[0] // cs
                    g = {k: v[mesh.index(col) * n_b:(mesh.index(col) + 1) * n_b]
                         for k, v in g.items()}
                for key, mask in (("I", "pair_mask"), ("J", "pair_mask"),
                                  ("resid", "resid_mask")):
                    gl, gm = g[key] - slab * (K // rs), g[mask] > 0
                    gm = gm & (gl >= 0) & (gl < K // rs)
                    ml, mm = m[key], m[mask] > 0
                    got = ([ml[i][mm[i]].tolist() for i in range(ml.shape[0])] if ml.ndim == 2
                           else ml[mm].tolist())
                    want = ([gl[i][gm[i]].tolist() for i in range(gl.shape[0])]
                            if gl.ndim == 2 else gl[gm].tolist())
                    assert got == want, (rank, sub, name, key)
        assert sum(len(v["I"]) for v in _metas(mine).values()) > 0


@functools.cache
def _folded(arch):
    return fold_lm_params(_scaled(arch), 0.05)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_leaf_by_leaf_fold_equals_the_whole_models(arch, shape):
    """Each rank folding every whole leaf before it keeps its block holds
    ``fold_lm_params``' blocks bit for bit, and counts its pairs."""
    cfg = _cfg(arch)
    whole, want = _folded(arch)
    for rank in range(shape[0] * shape[1]):
        mesh = _mesh(shape, rank)
        specs = _specs(arch, "train", mesh)
        fold, report = leaf_folder(0.05)
        _same(local_model(cfg, _scaled(arch), specs, mesh, fold=fold),
              shard_model(whole, specs, mesh))
        assert (report.total_pairs, report.total_weights) == \
            (want.total_pairs, want.total_weights) and report.total_pairs > 0


def test_cli_folds_a_mesh_rank_leaf_by_leaf(capsys):
    """``--paired-rounding`` on ``--mesh 1x2``: each rank folds its leaves
    as it builds them; rank 0 prints the single-device fold's line, and the
    losses are the single-device run's (fp32: within 1e-5)."""
    from repro_torch.launch import train as t_train

    kw = dict(arch="qwen2-1.5b", smoke=True, steps=2, batch=2, seq=16, paired_rounding=0.05,
              device="cpu", dtype="float32", log_every=0)
    base = t_train.train(**kw)
    one = [ln for ln in capsys.readouterr().out.splitlines() if "weight pairs" in ln]
    got = t_train.train(mesh="1x2", **kw)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if "weight pairs" in ln]
    assert lines == one and len(one) == 1
    torch.testing.assert_close([h["loss"] for h in got["history"]],
                               [h["loss"] for h in base["history"]], rtol=1e-5, atol=0)
