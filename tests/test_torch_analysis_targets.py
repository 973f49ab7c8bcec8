"""The port's schedule linter (``repro_torch.analysis``) against the JAX
package's (``repro.analysis``): the ``lenet_fused`` and ``model_zoo``
targets, corrupted pairing metadata and a standalone pool, and the CLI.

Each JAX context is built once for the module and linted by every JAX rule
but ``vmem/static-budget`` (``_analysis_jax``).  The port's target runs on
the CPU over the same weights, carried across from numpy, and its pairing
of them equals the JAX one index for index.  Rule by rule
(``_analysis_jax.held_to_jax``) the port measures what the JAX package does.

Each corrupted input (a duplicated lane, a non-zero padded lane, a
layer-count mismatch, an index ≥ K) is made the same way in both packages'
metadata of deepseek's smoke weights, and both report the same error
findings at the same locations, with exit code 1.

The CLI runs ``--target all --device cpu`` in a child started with the
module, beside the JAX work.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _analysis_jax import (
    PAIRING_RULES,
    assert_same_metadata,
    held_to_jax,
    j_meta,
    j_path,
    jax_rule_ids,
    np_tree,
)
from repro.analysis import RuleContext as JRuleContext
from repro.analysis import run_rules as j_run_rules
from repro.analysis import targets as j_targets
from repro.configs import get_smoke_config as j_smoke_config
from repro.models import lenet as JL
from repro.models import lm as JM
from repro.models.param import unzip
from repro_torch.analysis import RULE_REGISTRY, record_trace, run_rules
from repro_torch.analysis import targets as t_targets
from repro_torch.analysis.__main__ import main as cli_main
from repro_torch.analysis.core import JAX_RULE
from repro_torch.analysis.rules_pairing import _stacks
from repro_torch.models import lm as TM
from repro_torch.models.lenet import lenet_apply, lenet_params_from_numpy

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def cli_child(tmp_path_factory):
    """``python -m repro_torch.analysis --target all --device cpu --json``,
    started with the module (it runs beside the JAX contexts)."""
    path = tmp_path_factory.mktemp("analysis") / "report.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.analysis", "--target", "all", "--device", "cpu",
         "--json", str(path)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env)
    yield proc, path
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def jax_lenet(cli_child):
    ctx = j_targets.build_context("lenet_fused")
    return ctx, j_run_rules(ctx, rule_ids=jax_rule_ids())


@pytest.fixture(scope="module")
def jax_zoo(cli_child):
    ctx = j_targets.build_context("model_zoo")
    return ctx, j_run_rules(ctx, rule_ids=jax_rule_ids())


# ---------------------------------------------------------------------------
# lenet_fused
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lenet_params():
    """The JAX target's weights (``init_lenet(key(0))``), carried across."""
    return lenet_params_from_numpy(np_tree(JL.init_lenet(jax.random.key(0))), device="cpu")


def test_lenet_fused_equals_jax(jax_lenet, lenet_params):
    j_ctx, want = jax_lenet
    ctx = t_targets.lenet_context(lenet_params)
    for name, art in j_ctx.pairing_artifacts.items():
        got = ctx.pairing_artifacts[name].pairing
        for key in ("I", "J", "resid"):
            np.testing.assert_array_equal(np.asarray(getattr(got, key)),
                                          np.asarray(getattr(art.pairing, key)))
    port = run_rules(ctx)
    held_to_jax(port, want)
    # 3 writebacks (3 expected), no pool, 3 artifacts, no padded one
    assert port.measured("schedule/writebacks-per-program") == 3
    assert port.measured("schedule/no-standalone-pool") == 0
    assert port.measured("schedule/writebacks-per-decode-layer") == 0
    assert port.measured("pairing/valid-permutation") == 3
    assert port.measured("pairing/padding-consistent") == 0
    assert port.measured("dtype/no-f64") == 0
    assert port.measured("dtype/reduce-precision-on-bf16") == 0
    assert set(port.rules_skipped) == {"moves/pairing-in-step",
                                       "schedule/standalone-residual-adds"}
    assert 0 < port.measured("smem/static-budget") <= 232_448


def test_standalone_pool_on_the_fused_path_fires(jax_lenet, lenet_params):
    """The unfused forward held to the fused expectations: its two pools
    are the error in both packages (the JAX rule's ``reduce_window_max``,
    the port's ``pool2_reference``)."""
    j_ctx, _ = jax_lenet
    x = np.zeros((4, 32, 32, 1), np.float32)
    jaxpr = jax.make_jaxpr(lambda p, xb: JL.lenet_apply(
        p, xb, conv_impl="pallas_paired", paired=j_ctx.pairing_artifacts))(
            JL.init_lenet(jax.random.key(0)), x)
    want = j_run_rules(JRuleContext(target="lenet_fused", jaxpr=jaxpr, expect=j_ctx.expect),
                       rule_ids=["schedule/no-standalone-pool"])
    ctx = t_targets.lenet_context(lenet_params)
    with torch.no_grad():
        ctx.trace = record_trace(lenet_apply, lenet_params, torch.as_tensor(x),
                                 conv_impl="paired", paired=ctx.pairing_artifacts)
    got = run_rules(ctx, rule_ids=["schedule/no-standalone-pool"])
    assert got.exit_code == want.exit_code == 1
    assert [(f.location, f.measured) for f in got.errors()] == [
        (f.location, f.measured) for f in want.errors()] == [("lenet_fused", 2)]


# ---------------------------------------------------------------------------
# model_zoo
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def zoo_ctx():
    """The port's ``model_zoo`` context on the JAX target's weights."""
    cfg = t_targets.zoo_cfg()
    values = np_tree(unzip(JM.init_lm(j_smoke_config("deepseek-v2-lite-16b"),
                                      jax.random.key(0)))[0])
    return t_targets.zoo_context(cfg, TM.lm_params_from_numpy(values, cfg, device="cpu"))


def test_model_zoo_equals_jax(jax_zoo, zoo_ctx):
    """deepseek's smoke metadata (MLA, experts, shared experts, a leading
    dense layer): the port pairs the JAX weights index for index, and its
    pairing rules count what the JAX ones do (3928 / 3928 / 17)."""
    j_ctx, want = jax_zoo
    assert assert_same_metadata(zoo_ctx.params, j_ctx.params) == 17
    port = run_rules(zoo_ctx)
    held_to_jax(port, want)
    assert [port.measured(r) for r in PAIRING_RULES] == [3928, 3928, 17]


# ---------------------------------------------------------------------------
# corrupted metadata: the same errors in both packages
# ---------------------------------------------------------------------------

#: the corrupted stack: MLA's query projection over the MoE segment's 2 layers
CORRUPT = "segments[1].attn.wq_pairing"


def _corrupt(case: str, meta: dict) -> dict:
    """``meta`` (numpy, stacked ``(L, blocks, Pmax)``) with one defect."""
    m = {k: np.array(v) for k, v in meta.items()}
    real = np.argwhere(m["pair_mask"] > 0)
    if case == "duplicated_lane":  # a pair lane's J repeats its I
        layer, b, p = real[len(real) // 2]
        m["J"][layer, b, p] = m["I"][layer, b, p]
    elif case == "padded_lane_nonzero":  # a padded pair lane off row 0
        layer, b, p = np.argwhere(m["pair_mask"] == 0)[0]
        m["I"][layer, b, p] = 1
    elif case == "layer_count":  # metadata of one layer for a stack of two
        m = {k: v[:1] for k, v in m.items()}
    elif case == "index_ge_k":  # a real lane past the contraction
        layer, b, p = real[0]
        m["J"][layer, b, p] += 1000
    return m


def _with_meta(params: dict, path: str, meta: dict) -> dict:
    """A copy of the JAX tree along ``path`` with ``meta`` in place."""
    (_, si), sub, key = j_path(path)
    out = dict(params)
    out["segments"] = list(params["segments"])
    node = out["segments"][si] = dict(params["segments"][si])
    for part in sub.split("."):
        node[part] = dict(node[part])
        node = node[part]
    node[key] = meta
    return out


@pytest.mark.parametrize("case", ["duplicated_lane", "padded_lane_nonzero", "layer_count",
                                  "index_ge_k"])
def test_corrupted_metadata_same_errors(case, jax_zoo, zoo_ctx, monkeypatch):
    j_ctx, _ = jax_zoo
    bad = _corrupt(case, j_meta(j_ctx.params, CORRUPT))
    want = j_run_rules(JRuleContext(target="model_zoo",
                                    params=_with_meta(j_ctx.params, CORRUPT, bad)),
                       rule_ids=PAIRING_RULES)
    stack = next(s for s in _stacks(zoo_ctx.params) if s.path == CORRUPT)
    (_, si), sub, key = j_path(CORRUPT)
    start = sum(n for _, n in zoo_ctx.params.segments[:si])
    for layer in range(len(stack.weights)):
        block = zoo_ctx.params.layers[start + layer].get_submodule(sub)
        w_name = key.removesuffix("_pairing")
        if layer < len(bad["I"]):
            monkeypatch.setitem(block.pairing, w_name,
                                {k: torch.as_tensor(v[layer]) for k, v in bad.items()})
        else:
            monkeypatch.delitem(block.pairing, w_name)
    got = run_rules(zoo_ctx, rule_ids=PAIRING_RULES)
    assert got.exit_code == want.exit_code == 1
    errors = [(JAX_RULE[f.rule], f.location, f.message, f.measured) for f in got.errors()]
    assert errors == [(f.rule, f.location, f.message, f.measured) for f in want.errors()]
    assert {r for r, *_ in errors} >= {
        "duplicated_lane": {"pairing/valid-permutation"},
        "padded_lane_nonzero": {"pairing/padding-consistent"},
        "layer_count": {"pairing/stacked-shapes"},
        "index_ge_k": {"pairing/stacked-shapes", "pairing/valid-permutation"}}[case]
    assert all(loc.startswith(CORRUPT) for _, loc, *_ in errors)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_list_rules_prints_twelve_ids(capsys):
    assert cli_main(["--list-rules"]) == 0
    ids = [line.split()[0] for line in capsys.readouterr().out.splitlines()]
    assert ids == sorted(RULE_REGISTRY) == sorted(JAX_RULE)
    assert len(ids) == 12


def test_cli_all_targets_writes_the_jax_schema(cli_child, jax_lenet):
    """``--target all --device cpu --json``: exit 0, every target's report
    with the JAX report's keys and the JAX findings' keys, and lenet_fused's
    findings those of the in-process run."""
    proc, path = cli_child
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, (out[-3000:], err[-3000:])
    payload = json.loads(path.read_text())
    assert list(payload) == ["targets"]
    assert [r["target"] for r in payload["targets"]] == list(t_targets.TARGETS)
    want = jax_lenet[1].as_dict()
    for rep in payload["targets"]:
        assert list(rep) == list(want), rep["target"]
        assert rep["errors"] == 0, rep
        for f in rep["findings"]:
            assert list(f) == list(want["findings"][0])
    lenet = payload["targets"][0]
    assert {f["rule"]: f["measured"] for f in lenet["findings"]}["pairing/valid-permutation"] == 3
    assert f"wrote {path}" in out
