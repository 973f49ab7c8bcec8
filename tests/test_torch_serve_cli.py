"""The port's serving CLI at parity with the JAX one, and what stands behind
its new flags.

* the six flags the JAX CLI has (``--block-k``, ``--tile-cache``,
  ``--fallback-gemm``, ``--paired-rounding``, ``--conv``, ``--fuse-pool``)
  exist with its defaults and choices, and each reaches the engines' knobs;
  a ``--tile-cache`` path that does not exist is an error;
* ``core.transform.fold_lm_params`` (``--paired-rounding``) within 1e-6 of
  the JAX package's ``pair_lm_params(..., "column_blocked", block_n=1)``
  folded by its ``fold_lm_weight`` / ``fold_lm_expert_weight``, on
  qwen2's and olmoe's smoke trees (fp32); the vectorised per-column walk
  behind it equal to the per-column structured walk on tied values;
* the front end with ``--fallback-gemm pallas`` (K1's dense form) loses
  nothing under NaN-logit chaos;
* ``launch.steps.build_prefill_step`` / ``build_serve_step`` against the
  JAX functions at r=0, fp32 (the JAX side under a 1×1 mesh and its
  sharding rules): logits ≤ 1e-5;
* the two examples run in-process on the CPU.
"""
import argparse
import dataclasses
import runpy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import transform as j_transform
from repro.kernels import ops as j_ops
from repro.launch import serve as j_serve
from repro.launch.steps import build_prefill_step as j_build_prefill_step
from repro.launch.steps import build_serve_step as j_build_serve_step
from repro.models import lm as JM
from repro.models.param import unzip
from repro.parallel.rules import rules_for
from repro.parallel.sharding import make_mesh_compat, set_mesh_compat
from repro_torch.configs import get_smoke_config
from repro_torch.core import pairing as t_pairing
from repro_torch.core.transform import fold_lm_params, has_lm_pairing
from repro_torch.kernels.ref import rel_err
from repro_torch.launch import serve as t_serve
from repro_torch.launch.steps import build_prefill_step, build_serve_step
from repro_torch.models import lm as TM

NEW_FLAGS = ("block_k", "tile_cache", "fallback_gemm", "paired_rounding", "conv", "fuse_pool")
EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


class _Parsed(Exception):
    """Carries the parser a CLI built, instead of parsing."""


def _parser(main, monkeypatch) -> argparse.ArgumentParser:
    def stop(self, args=None, namespace=None):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    with pytest.raises(_Parsed) as info:
        main()
    monkeypatch.undo()
    return info.value.args[0]


def _action(parser, dest):
    return next(a for a in parser._actions if a.dest == dest)


@pytest.mark.parametrize("dest", NEW_FLAGS)
def test_new_flags_have_the_jax_defaults(monkeypatch, dest):
    want = _action(_parser(j_serve.main, monkeypatch), dest)
    got = _action(_parser(t_serve.main, monkeypatch), dest)
    assert got.option_strings == want.option_strings
    assert got.default == want.default and type(got.default) is type(want.default)
    assert tuple(got.choices or ()) == tuple(want.choices or ())
    assert type(got) is type(want)


@pytest.fixture
def engines(monkeypatch):
    """Every ServeEngine the CLI builds in the test."""
    built = []
    real = t_serve.ServeEngine

    def record(*a, **kw):
        built.append(real(*a, **kw))
        return built[-1]

    monkeypatch.setattr(t_serve, "ServeEngine", record)
    return built


SMOKE = ["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu", "--batch", "1", "--steps", "2",
         "--max-seq", "16", "--gemm", "pallas_paired"]


@pytest.mark.parametrize("args,field,value", [
    (["--block-k", "64"], "block_k", 64),
    (["--conv", "im2col"], "conv", "im2col"),
    (["--conv", "pallas_paired", "--fuse-pool"], "fuse_pool", True),
    (["--tile-cache", "{cache}"], "tile_cache", "{cache}"),
])
def test_each_flag_reaches_the_knobs(engines, tmp_path, args, field, value):
    from repro_torch.kernels import tuning

    cache = str(tmp_path / "tc.json")
    tuning.TileCache(cache).save()
    rec = t_serve.main(SMOKE + [a.replace("{cache}", cache) for a in args])
    (eng,) = engines
    assert rec["engine"] is eng
    want = value.replace("{cache}", cache) if isinstance(value, str) else value
    assert getattr(eng.knobs, field) == want


def test_a_missing_tile_cache_is_an_error(tmp_path, capsys):
    with pytest.raises(SystemExit):
        t_serve.main(SMOKE + ["--tile-cache", str(tmp_path / "missing.json")])
    assert "--tile-cache: no file" in capsys.readouterr().err
    with pytest.raises(FileNotFoundError):
        t_serve.serve(arch="qwen2-1.5b", smoke=True, device="cpu", batch=1, steps=2,
                      tile_cache=str(tmp_path / "missing.json"))


def test_paired_rounding_folds_before_the_engine(engines, capsys):
    """``--paired-rounding`` serves ``fold_lm_params`` of the seeded model:
    the engine's weights are the folded ones (held in the compute dtype once
    paired), and it pairs them anew."""
    t_serve.main(SMOKE + ["--paired-rounding", "0.05", "--pair-rounding", "0.05"])
    (eng,) = engines
    cfg = get_smoke_config("qwen2-1.5b")
    folded, report = fold_lm_params(TM.init_lm(cfg, 0, device="cpu"), 0.05)
    got, want = TM.lm_value_tree(eng.model), TM.lm_value_tree(folded)
    for (path, w), (_, g) in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                                 jax.tree_util.tree_flatten_with_path(got)[0], strict=True):
        assert torch.equal(g, w.to(g.dtype)), jax.tree_util.keystr(path)
    out = capsys.readouterr().out
    assert f"subtractor pairing (per_column): {report.total_pairs} pairs" in out
    assert report.total_pairs > 0 and eng.pair_report is not None


def test_frontend_degrades_to_k1s_dense_form(engines):
    """``--frontend --fallback-gemm pallas``: the fallback runs K1's dense
    form (unpaired, on the folded weights), and no request is lost."""
    from repro_torch.analysis import counting

    with counting() as c:
        report = t_serve.main(["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu",
                               "--gemm", "pallas_paired", "--paired-rounding", "0.05",
                               "--max-seq", "32", "--steps", "4", "--frontend",
                               "--fallback-gemm", "pallas", "--arrival-rate", "20",
                               "--horizon", "0.5", "--inject", "nan_logits:0.3"])
    primary, fallback = engines
    assert fallback.knobs.gemm == "pallas" and fallback.knobs.pair_rounding == 0.0
    assert not has_lm_pairing(fallback.model)
    assert primary.knobs.gemm == "pallas_paired"
    summ = report.summary()
    assert report.lost() == [] and summ["degraded"] > 0
    assert c["k1_calls"] > 0
    with pytest.raises(ValueError, match="fallback_gemm"):
        t_serve.run_frontend(arch="qwen2-1.5b", smoke=True, device="cpu",
                             fallback_gemm="pallas_paired")


# ---------------------------------------------------------------------------
# fold_lm_params against the JAX package's per-column pairing, folded
# ---------------------------------------------------------------------------


def _jax_folded(vals: dict, rounding: float) -> dict:
    """The JAX package's ``pair_lm_params(column_blocked, 1)``, each paired
    leaf folded layer by layer by its ``fold_lm_weight`` (experts:
    ``fold_lm_expert_weight``); the metadata dropped."""
    paired, report = j_transform.pair_lm_params(vals, rounding, mode="column_blocked",
                                                block_n=1)
    fold_w = jax.jit(j_ops.fold_lm_weight, static_argnums=2)
    fold_e = jax.jit(j_ops.fold_lm_expert_weight, static_argnums=2)

    def fold(node):
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            if k.endswith("_pairing"):
                continue
            meta = node.get(k + "_pairing")
            if meta is None:
                out[k] = fold(v) if isinstance(v, dict) else v
                continue
            w = np.asarray(v)
            layers = []
            for l in range(w.shape[0]):
                m = {n: jnp.asarray(a[l]) for n, a in meta.items()}
                if m["I"].ndim == 3:  # per-expert (E, Bc, Pmax)
                    layers.append(np.asarray(fold_e(jnp.asarray(w[l]), m, 1)))
                else:
                    K, N = j_transform._lm_weight_matrix_shape(k, w.shape[1:])
                    layers.append(np.asarray(fold_w(jnp.asarray(w[l].reshape(K, N)), m, 1)
                                             ).reshape(w.shape[1:]))
            out[k] = np.stack(layers)
        return out

    return {k: ([fold(s) for s in v] if k == "segments" else fold(v) if isinstance(v, dict)
                else v) for k, v in paired.items()}, report


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "olmoe-1b-7b"])
def test_fold_lm_params_matches_jax_per_column_fold(arch):
    rounding = 0.05
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32")
    vals = jax.tree.map(np.asarray, unzip(JM.init_lm(jcfg, jax.random.key(0)))[0])
    want, want_report = _jax_folded(vals, rounding)
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    model = TM.lm_params_from_numpy(vals, cfg, device="cpu")
    folded, report = fold_lm_params(model, rounding)
    assert not has_lm_pairing(folded)
    assert report.total_pairs == want_report.total_pairs > 0
    assert [(lf.path, lf.n_pairs) for lf in report.leaves] == [
        (lf.path, lf.n_pairs) for lf in want_report.leaves]
    got = TM.lm_value_tree(folded)
    w_flat = jax.tree_util.tree_flatten_with_path(want)[0]
    g_flat = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [jax.tree_util.keystr(p) for p, _ in g_flat] == [
        jax.tree_util.keystr(p) for p, _ in w_flat]
    orig = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(vals)[0]}
    changed = 0
    for (path, w), (_, g) in zip(w_flat, g_flat, strict=True):
        key, w, g = jax.tree_util.keystr(path), np.asarray(w), g.numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, key
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=key)
        changed += not np.array_equal(w, orig[key])
    assert changed == len(report.leaves)  # every paired leaf moved, nothing else
    # the input model is untouched
    for (path, v), (_, t) in zip(jax.tree_util.tree_flatten_with_path(vals)[0],
                                 jax.tree_util.tree_flatten_with_path(
                                     TM.lm_value_tree(model))[0], strict=True):
        np.testing.assert_array_equal(t.numpy(), v, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("seed", range(3))
def test_per_column_walk_equals_the_structured_walk(seed):
    """``pair_rows_blocked(block_n=1)`` walks all columns at once; each
    block equals ``pair_rows_structured`` of its column alone, ties (bf16
    values), zeros and the magnitudes included."""
    rng = np.random.default_rng(seed)
    w = torch.as_tensor(rng.normal(size=(48, 9)) * 0.1).to(torch.bfloat16).double().numpy()
    w[rng.integers(0, 48, 4)] = 0.0
    for rounding in (0.0, 0.01, 0.05):
        got = t_pairing.pair_rows_blocked(w, rounding, 1)
        for c, sp in enumerate(got.blocks):
            want = t_pairing.pair_rows_structured(w[:, c:c + 1], rounding)
            for f in ("I", "J", "resid", "Kmat", "W_res"):
                np.testing.assert_array_equal(getattr(sp, f), getattr(want, f))
                assert getattr(sp, f).dtype == getattr(want, f).dtype


# ---------------------------------------------------------------------------
# the prefill and serve step builders against the JAX package's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def step_parity():
    """The JAX prefill of a 5-token prompt and a decode step at position 5
    (its cache spliced into an 8-position one), on a one-device mesh."""
    jcfg = dataclasses.replace(jax_smoke_config("qwen2-1.5b"), dtype="float32")
    vals = jax.tree.map(np.asarray, unzip(JM.init_lm(jcfg, jax.random.key(0)))[0])
    knobs = JM.PerfKnobs(q_chunk=8, k_chunk=8, remat="none")
    mesh = make_mesh_compat((1, 1), ("data", "model"))
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab, size=(1, 5)).astype(np.int32)
    prefill = jax.jit(j_build_prefill_step(jcfg, knobs, mesh, rules_for(jcfg, "prefill", mesh)))
    serve = jax.jit(j_build_serve_step(jcfg, mesh, rules_for(jcfg, "decode", mesh), knobs))
    with set_mesh_compat(mesh):
        logits, cache = prefill(vals, {"tokens": jnp.asarray(tokens)})
        full = jax.tree.map(np.array, unzip(JM.init_cache(jcfg, 1, 8))[0])
        for name in ("k", "v"):
            full["segments"][0][name][:, :, :5] = np.asarray(cache["segments"][0][name])
        nxt = np.asarray([[7]], np.int32)
        dec, _ = serve(vals, full, {"tokens": jnp.asarray(nxt), "pos": jnp.asarray([5])})
    return vals, tokens, np.asarray(logits), full, nxt, np.asarray(dec)


def test_build_prefill_step_matches_jax(step_parity):
    vals, tokens, want, *_ = step_parity
    cfg = dataclasses.replace(get_smoke_config("qwen2-1.5b"), dtype="float32")
    model = TM.lm_params_from_numpy(vals, cfg, device="cpu")
    step = build_prefill_step(cfg, TM.PerfKnobs(q_chunk=8, k_chunk=8))
    logits, cache = step(model, {"tokens": torch.as_tensor(tokens, dtype=torch.int64)})
    assert logits.shape == want.shape and not logits.requires_grad
    assert rel_err(logits, torch.from_numpy(want.copy())) <= 1e-5
    assert cache["k"].shape[:3] == (cfg.n_layers, 1, 5)


def test_build_serve_step_matches_jax(step_parity):
    vals, _, _, full, nxt, want = step_parity
    cfg = dataclasses.replace(get_smoke_config("qwen2-1.5b"), dtype="float32")
    model = TM.lm_params_from_numpy(vals, cfg, device="cpu")
    step = build_serve_step(cfg, TM.PerfKnobs(q_chunk=8, k_chunk=8))
    cache = {n: torch.as_tensor(full["segments"][0][n]) for n in ("k", "v")}
    logits, new = step(model, cache, {"tokens": torch.as_tensor(nxt, dtype=torch.int64),
                                      "pos": torch.as_tensor([5])})
    assert logits.shape == want.shape
    assert rel_err(logits, torch.from_numpy(want.copy())) <= 1e-5
    assert set(new) == {"k", "v"}


# ---------------------------------------------------------------------------
# the examples
# ---------------------------------------------------------------------------


def _example(name: str):
    return runpy.run_path(str(EXAMPLES / name), run_name="example")["main"]


def test_quickstart_example_runs_on_the_cpu(capsys):
    rec = _example("quickstart_torch.py")(["--device", "cpu"])
    out = capsys.readouterr().out
    assert rec["device"] == "cpu" and rec["pairs"] > 0 and rec["launches"] == 0
    assert rec["max_err"] < 0.1 and "plain version on cpu" in out


def test_serve_demo_example_runs_on_the_cpu(capsys):
    rec = _example("serve_demo_torch.py")(["--device", "cpu", "--steps", "4"])
    assert rec["report"].total_pairs > 0
    assert all(len(t) == 4 for t in rec["paired"].values())
    assert "tokens agree" in capsys.readouterr().out
