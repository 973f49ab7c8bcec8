"""The port's schedule linter without the JAX package: the trace, every
rule family, the registry and the report, and the port's import guard.

The cases mirror ``tests/test_analysis.py`` where a case has a meaning in
the port: synthetic traces (``analysis.trace.Op`` nodes) or short real
ones (``record_trace`` on CPU tensors, where every kernel wrapper runs its
plain version) feed each rule a clean and a deliberately broken input, and
the error finding must fire on the broken one.  The bf16 probe of
``dtype/reduce-precision-on-bf16`` runs through K1's wrapper on the CPU and
fails against a plain version monkeypatched to subtract in fp32.  The guard
holds the port (and ``chip_smoke.py``) to importing nothing of ``repro``,
``jax`` or the root ``benchmarks``.
"""
import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.analysis import (
    RULE_REGISTRY,
    AnalysisReport,
    Finding,
    RuleContext,
    count_ops,
    count_shape_adds,
    kernels_by_layer,
    record_trace,
    run_rules,
)
from repro_torch.analysis import rules_pairing as rp
from repro_torch.analysis import targets
from repro_torch.analysis.core import JAX_RULE
from repro_torch.analysis.rules_schedule import POOL_OPS
from repro_torch.analysis.trace import Op, Trace, k1_node_info
from repro_torch.core.pairing import BlockedPairing, StructuredPairing
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import paired_matmul as pm
from repro_torch.kernels import tuning

ROOT = Path(__file__).resolve().parent.parent
F32 = "float32"


def _run(ctx, *rule_ids):
    return run_rules(ctx, rule_ids=rule_ids)


def _op(name, *, ins=(), outs=(), layer=None, pairing=False, kind="op"):
    return Op(name, kind, tuple(ins), tuple(outs), layer, pairing)


def _k1(layer=None, problem=(4, 8, 16, 1, 32, "none", 4)):
    """A K1 node of ``problem`` (M, P, R, n_blocks, bn, pool, itemsize)."""
    M, P, R, B, bn, pool, itemsize = problem
    info = k1_node_info((M, 2 * P + R), (P, bn), (R, bn), pool, itemsize, False)
    return Op(f"K1/{info['form']}", "kernel", (), (), layer, False, info)


def _trace(ops, n_layers=0, **kw) -> Trace:
    return Trace(ops=list(ops), n_layers=n_layers, **kw)


# ---------------------------------------------------------------------------
# the trace and its walks
# ---------------------------------------------------------------------------


def test_kernel_call_is_one_opaque_node():
    """K1's wrapper on CPU tensors: one node with its problem and plan, and
    none of the plain version's ops (its residual add included)."""
    g = torch.Generator().manual_seed(0)
    x, kmat, w_res = (torch.randn(s, generator=g) for s in ((4, 40), (8, 32), (24, 32)))
    res = torch.randn((4, 32), generator=g)
    t = record_trace(pm.paired_matmul_cuda, x, kmat, w_res, residual=res)
    assert [op.name for op in t.ops] == ["K1/paired_matmul"]
    node = t.ops[0]
    assert node.info["problem"] == (4, 8, 24, 1, 32, "none", 4)
    assert node.info["plan"] == tuning.resolve_plan(4, 8, 24, 1, 32, "none", 4, residual=True)
    assert node.outs == (("float32", (4, 32), "cpu"),)
    assert count_shape_adds(t, (4, 32)) == 0
    torch.testing.assert_close(t.result, pm.paired_matmul_plain(x, kmat, w_res, residual=res))
    assert t.launches == {"K1": 0, "K2": 0, "K3": 0}


def test_decode_attention_call_is_one_node_with_its_plan():
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 1, 4, 16), generator=g)
    k, v = (torch.randn((2, 32, 2, 16), generator=g) for _ in range(2))
    pos = torch.tensor([5, 11], dtype=torch.int32)
    t = record_trace(da.decode_attention_cuda, q, k, v, pos)
    assert [op.name for op in t.ops] == ["K2/decode_attention"]
    assert t.ops[0].info["plan"] == tuning.k2_plan(2, 32, 4, 2, 16, 0, 1, 0, 0, 4)


def test_count_shape_adds_matches_full_shape_only():
    h = (2, 1, 8)
    a, b, bias = torch.ones(h), torch.ones(h), torch.ones(8)
    t = record_trace(lambda: (a + b, a + bias, a.add_(b)))
    assert count_shape_adds(t, h) == 2
    assert count_ops(t, "aten.add") == 2 and count_ops(t, "aten.add_") == 1


def test_kernels_by_layer_attributes_to_layers():
    t = _trace([_k1(), _k1(0), _k1(0), _k1(1)], n_layers=3)
    assert kernels_by_layer(t) == (4, {0: 2, 1: 1, 2: 0})


def test_layer_boundaries_from_layer_decode():
    """The paired decode step of qwen2's smoke config: two layers, each its
    seven K1 calls, the embedding and head outside them."""
    ctx = targets.build_lm_decode(device="cpu")
    total, per = kernels_by_layer(ctx.trace)
    assert (ctx.trace.n_layers, total, per) == (2, 14, {0: 7, 1: 7})
    assert {op.layer for op in ctx.trace.ops if op.kind == "kernel"} == {0, 1}


# ---------------------------------------------------------------------------
# schedule rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", POOL_OPS)
def test_no_standalone_pool_fires_on_fused_expectation(name):
    t = _trace([_op(name, kind="call" if name.startswith("call/") else "op")])
    bad = _run(RuleContext(target="t", trace=t, expect={"fused_pool": True}),
               "schedule/no-standalone-pool")
    assert bad.exit_code == 1 and bad.errors()[0].measured == 1
    ok = _run(RuleContext(target="t", trace=t), "schedule/no-standalone-pool")
    assert ok.exit_code == 0 and ok.measured("schedule/no-standalone-pool") == 1


def test_real_pool_is_seen():
    t = record_trace(F.max_pool2d, torch.ones((1, 1, 4, 4)), 2)
    rep = _run(RuleContext(target="t", trace=t, expect={"fused_pool": True}),
               "schedule/no-standalone-pool")
    assert rep.exit_code == 1


def test_writebacks_per_program_gate():
    t = _trace([_k1() for _ in range(3)])
    bad = _run(RuleContext(target="t", trace=t, expect={"pallas_calls": 2}),
               "schedule/writebacks-per-program")
    assert bad.exit_code == 1 and bad.errors()[0].measured == 3
    ok = _run(RuleContext(target="t", trace=t, expect={"pallas_calls": 3}),
              "schedule/writebacks-per-program")
    assert ok.exit_code == 0


def test_writebacks_per_decode_layer_budget():
    t = _trace([_k1(layer) for layer in (0, 1) for _ in range(9)], n_layers=2)
    bad = _run(RuleContext(target="t", trace=t, expect={"writebacks_per_layer": 7}),
               "schedule/writebacks-per-decode-layer")
    assert bad.exit_code == 1
    assert [(f.location, f.measured, f.expected) for f in bad.errors()] == [
        ("t/layer0", 9, 7), ("t/layer1", 9, 7)]
    ok = _run(RuleContext(target="t", trace=t, expect={"writebacks_per_layer": 9}),
              "schedule/writebacks-per-decode-layer")
    assert ok.exit_code == 0
    # an expectation with no decode layer in the trace is an error, not a pass
    none = _run(RuleContext(target="t", trace=_trace([_k1()]),
                            expect={"writebacks_per_layer": 7}),
                "schedule/writebacks-per-decode-layer")
    assert none.exit_code == 1
    info = _run(RuleContext(target="t", trace=_trace([_k1()])),
                "schedule/writebacks-per-decode-layer")
    assert info.exit_code == 0 and info.measured("schedule/writebacks-per-decode-layer") == 0


def test_standalone_residual_adds_gate():
    h = (2, 1, 8)
    t = record_trace(torch.add, torch.ones(h), torch.ones(h))
    bad = _run(RuleContext(target="t", trace=t, hidden_shape=h, expect={"residual_adds": 0}),
               "schedule/standalone-residual-adds")
    assert bad.exit_code == 1 and bad.errors()[0].measured == 1


# ---------------------------------------------------------------------------
# dtype rules
# ---------------------------------------------------------------------------


def test_no_f64_flags_wide_outputs():
    bad = _run(RuleContext(target="t", trace=record_trace(lambda x: x.double() + 1,
                                                          torch.ones(4))), "dtype/no-f64")
    assert bad.exit_code == 1 and bad.errors()[0].measured == 2
    ok = _run(RuleContext(target="t", trace=record_trace(torch.sin, torch.ones(4))),
              "dtype/no-f64")
    assert ok.exit_code == 0


def _bf16_k1(form: str):
    """One bf16 K1 call of ``form`` on CPU tensors, traced."""
    g = torch.Generator().manual_seed(0)
    pool = "max2" if form.endswith("_pool") else "none"
    lead = (4,) if pool != "none" else ()
    rnd = lambda *s: torch.randn(s, generator=g).to(torch.bfloat16)
    if form.startswith("blocked"):
        return record_trace(pm.paired_matmul_blocked_cuda, rnd(3, *lead, 4, 11), rnd(3, 3, 2),
                            rnd(3, 5, 2), n_cols=6, pool=pool)
    return record_trace(pm.paired_matmul_cuda, rnd(*lead, 4, 24), rnd(8, 6), rnd(8, 6),
                        pool=pool)


FORMS = ["structured", "structured_pool", "blocked", "blocked_pool"]


@pytest.mark.parametrize("form", FORMS)
def test_bf16_probe_passes_on_the_subtractor_at_input_precision(form):
    rep = _run(RuleContext(target="t", trace=_bf16_k1(form)), "dtype/reduce-precision-on-bf16")
    assert rep.exit_code == 0
    assert rep.measured("dtype/reduce-precision-on-bf16") == 1


@pytest.mark.parametrize("form", FORMS)
def test_bf16_probe_fails_on_a_subtract_in_fp32(form, monkeypatch):
    def fp32_subtract(x, kmat, w_res):
        P = kmat.shape[-2]
        diff = x[..., :P].float() - x[..., P:2 * P].float()
        return diff @ kmat.float() + x[..., 2 * P:].float() @ w_res.float()

    monkeypatch.setattr(pm, "_segments_matmul", fp32_subtract)
    rep = _run(RuleContext(target="t", trace=_bf16_k1(form)), "dtype/reduce-precision-on-bf16")
    assert rep.exit_code == 1
    err = rep.errors()[0]
    assert err.measured == 1.005859375 and err.expected == 1.0078125


def test_bf16_probe_skips_fp32_and_dense_calls():
    x = torch.ones((4, 16))
    t = record_trace(lambda: (pm.paired_matmul_cuda(x, torch.ones((4, 3)), torch.ones((8, 3))),
                              pm.paired_matmul_cuda(x.bfloat16(), torch.ones((0, 3)),
                                                    torch.ones((16, 3)))))
    rep = _run(RuleContext(target="t", trace=t), "dtype/reduce-precision-on-bf16")
    assert rep.exit_code == 0 and rep.measured("dtype/reduce-precision-on-bf16") == 0


def test_convert_churn_warns_over_budget():
    def f(x):
        for _ in range(3):
            x = x.to(torch.bfloat16).to(torch.float32)
        return x

    rep = _run(RuleContext(target="t", trace=record_trace(f, torch.ones(4)),
                           expect={"max_converts": 2}), "dtype/convert-churn")
    assert rep.exit_code == 0  # a warning, not an error
    assert len(rep.warnings()) == 1 and rep.warnings()[0].measured == 6


# ---------------------------------------------------------------------------
# the shared-memory rule
# ---------------------------------------------------------------------------


def test_smem_budget_charges_every_plan():
    problem = (4, 8, 16, 1, 32, "max2", 4)
    node = _k1(problem=problem)
    want = tuning.plan_smem(node.info["plan"], 8, 16, 4, 4)
    k3 = Op("K3/flash_attention", "kernel", info={"kernel": "K3", "form": "flash_attention"})
    t = _trace([node, k3])
    ok = _run(RuleContext(target="t", trace=t), "smem/static-budget")
    assert ok.exit_code == 0
    assert ok.measured("smem/static-budget") == want and 0 < want <= tuning.SMEM_PER_BLOCK
    bad = _run(RuleContext(target="t", trace=t, expect={"smem_budget_bytes": want - 1}),
               "smem/static-budget")
    assert bad.exit_code == 1 and bad.errors()[0].location == "t/K1/paired_matmul_pool"


def test_smem_budget_reads_k2_plans():
    q = torch.ones((2, 1, 4, 16))
    t = record_trace(da.decode_attention_cuda, q, torch.ones((2, 32, 2, 16)),
                     torch.ones((2, 32, 2, 16)), torch.tensor([5, 11]))
    rep = _run(RuleContext(target="t", trace=t), "smem/static-budget")
    assert rep.measured("smem/static-budget") == t.ops[0].info["plan"].smem > 0


# ---------------------------------------------------------------------------
# pairing-artifact rules
# ---------------------------------------------------------------------------


def _structured(I, J, resid, K, N=2):
    I, J, resid = (np.asarray(a, np.int64) for a in (I, J, resid))
    return StructuredPairing(I=I, J=J, Kmat=np.ones((len(I), N)), resid=resid,
                             W_res=np.ones((len(resid), N)), shape=(K, N))


def test_valid_permutation_accepts_good_and_flags_bad():
    good = {"conv1": _structured([0, 1], [3, 2], [4, 5], K=6)}
    assert _run(RuleContext(target="t", pairing_artifacts=good),
                "pairing/valid-permutation").exit_code == 0
    # row 3 appears twice, row 2 never: not a permutation
    bad = {"conv1": _structured([0, 1], [3, 3], [4, 5], K=6)}
    rep = _run(RuleContext(target="t", pairing_artifacts=bad), "pairing/valid-permutation")
    assert rep.exit_code == 1 and "conv1" in rep.errors()[0].location


def test_blocked_pairing_artifacts_validate_through_masks():
    blocks = [_structured([0, 1], [3, 2], [4, 5], K=6), _structured([5], [0], [1, 2, 3, 4], K=6)]
    bp = BlockedPairing(blocks=blocks, block_n=2, shape=(6, 4))
    rep = _run(RuleContext(target="t", pairing_artifacts={"conv1": bp}),
               "pairing/valid-permutation", "pairing/padding-consistent")
    assert rep.exit_code == 0
    assert rep.measured("pairing/valid-permutation", location="t") == 2


def test_padding_consistency_flags_nonzero_padded_lanes(monkeypatch):
    bp = BlockedPairing(blocks=[_structured([1], [4], [0, 3, 5], K=6)], block_n=2, shape=(6, 2))
    rep = _run(RuleContext(target="t", pairing_artifacts={"conv1": bp}),
               "pairing/padding-consistent")
    assert rep.exit_code == 0  # the real builder pads correctly
    bad = rp._Artifact(location="conv1/block0", K=6, I=np.array([1, 2]), J=np.array([4, 2]),
                       resid=np.array([0, 3, 5]), pair_mask=np.array([1.0, 0.0]),
                       resid_mask=np.array([1.0, 1.0, 1.0]))
    monkeypatch.setattr(rp, "_all_artifacts", lambda _ctx: [bad])
    rep2 = _run(RuleContext(target="t", pairing_artifacts={}), "pairing/padding-consistent")
    assert rep2.exit_code == 1 and "point at row 0" in rep2.errors()[0].message


@pytest.fixture()
def paired_smoke():
    """qwen2's smoke model, paired per column at r = 0.05 (the lm_decode
    target's)."""
    return targets.paired_lm(targets.smoke_lm_cfg(), targets.paired_knobs(), "cpu")


def test_real_paired_lm_passes_all_pairing_rules(paired_smoke):
    rep = _run(RuleContext(target="t", params=paired_smoke), *rp_ids())
    assert rep.exit_code == 0, [f.as_dict() for f in rep.errors()]
    assert [rep.measured(r) for r in rp_ids()] == [1024, 7, 1024]


def rp_ids():
    return sorted(r for r in RULE_REGISTRY if r.startswith("pairing/"))


def test_stacked_shapes_flags_layer_mismatch(paired_smoke):
    del paired_smoke.layers[1].attn.pairing["wq"]
    rep = _run(RuleContext(target="t", params=paired_smoke), "pairing/stacked-shapes")
    assert rep.exit_code == 1
    err = rep.errors()[0]
    assert err.location == "segments[0].attn.wq_pairing"
    assert "I stacks 1 layer(s), weight stacks 2" in err.message


def test_stacked_shapes_flags_bad_index_and_ragged_padding(paired_smoke):
    meta = paired_smoke.layers[0].mlp.pairing["w_up"]
    meta["J"][0, 0] = 64 + 3  # past the weight's contraction
    other = paired_smoke.layers[1].mlp.pairing["w_gate"]
    for k in ("I", "J", "pair_mask"):
        other[k] = other[k][:, :-1]  # a (Pmax, Rmax) of its own on one layer
    rep = _run(RuleContext(target="t", params=paired_smoke), "pairing/stacked-shapes")
    msgs = {f.location: f.message for f in rep.errors()}
    assert "outside the weight's K=64" in msgs["segments[0].mlp.w_up_pairing"]
    assert "across the segment's layers" in msgs["segments[0].mlp.w_gate_pairing"]


# ---------------------------------------------------------------------------
# moves/pairing-in-step
# ---------------------------------------------------------------------------

_IDX = ("int64", (64, 32), "cpu")


@pytest.mark.parametrize("case,moved", [
    ("clean", 0),
    ("copy", 1),  # a copy of a registered pairing storage
    ("send", 1),  # a collective's send of one
    ("upload", 1),  # an index-shaped integer tensor uploaded from the host
    ("other_copy", 0),  # a copy of a tensor that is not pairing metadata
])
def test_pairing_in_step(case, moved):
    ops = [_op("aten.index", ins=[_IDX], pairing=True), _k1(0)]
    ops += {"clean": [],
            "copy": [_op("aten._to_copy", ins=[_IDX], outs=[("int32", (64, 32), "cpu")],
                         layer=0, pairing=True)],
            "send": [_op("call/all_gather", ins=[_IDX], kind="call", pairing=True)],
            "upload": [_op("aten._to_copy", ins=[_IDX], outs=[("int64", (64, 32), "cuda")])],
            "other_copy": [_op("aten.clone", ins=[(F32, (64, 32), "cpu")],
                               outs=[(F32, (64, 32), "cpu")])]}[case]
    step = _trace(ops, n_layers=1, pairing_buffers=5, pairing_index_shapes={(64, 32)})
    rep = _run(RuleContext(target="t", step=step), "moves/pairing-in-step")
    assert rep.exit_code == int(moved > 0)
    assert len(rep.errors()) == moved
    assert rep.findings[-1].severity == "info" and rep.findings[-1].measured == moved


def test_pairing_in_step_without_metadata_is_info():
    rep = _run(RuleContext(target="t", step=_trace([_k1()])), "moves/pairing-in-step")
    assert rep.exit_code == 0 and rep.findings[0].measured == 0
    assert "no pairing-metadata buffers" in rep.findings[0].message


def test_decode_step_that_copies_pairing_fires(paired_smoke):
    """The lm_decode step, with the layer-0 query projection's lane list
    copied inside it: the rule finds the one copy."""
    ctx = targets.decode_context("lm_decode", targets.smoke_lm_cfg(), paired_smoke,
                                 targets.paired_knobs())
    served = ctx.params
    clean = _run(ctx, "moves/pairing-in-step")
    assert clean.exit_code == 0 and clean.measured("moves/pairing-in-step") == 0

    def step():
        return served.layers[0].attn.pairing["wq"]["I"].to(torch.int32)

    ctx.step = record_trace(step, pairing=served)
    rep = _run(ctx, "moves/pairing-in-step")
    assert rep.exit_code == 1 and rep.errors()[0].measured == "aten._to_copy"


# ---------------------------------------------------------------------------
# the registry and the report
# ---------------------------------------------------------------------------


def test_registry_contains_all_twelve_rules():
    run_rules(RuleContext(target="t"))  # force registration
    assert sorted(RULE_REGISTRY) == [
        "dtype/convert-churn",
        "dtype/no-f64",
        "dtype/reduce-precision-on-bf16",
        "moves/pairing-in-step",
        "pairing/padding-consistent",
        "pairing/stacked-shapes",
        "pairing/valid-permutation",
        "schedule/no-standalone-pool",
        "schedule/standalone-residual-adds",
        "schedule/writebacks-per-decode-layer",
        "schedule/writebacks-per-program",
        "smem/static-budget",
    ]
    assert sorted(JAX_RULE) == sorted(RULE_REGISTRY)
    renamed = {k: v for k, v in JAX_RULE.items() if k != v}
    assert renamed == {"smem/static-budget": "vmem/static-budget",
                       "moves/pairing-in-step": "hlo/pairing-resharding-in-loop"}


def test_unmet_needs_are_recorded_not_dropped():
    rep = run_rules(RuleContext(target="t"))  # the context provides nothing
    assert rep.rules_run == []
    assert set(rep.rules_skipped) == set(RULE_REGISTRY)
    assert rep.rules_skipped["moves/pairing-in-step"] == "step"
    assert rep.rules_skipped["dtype/no-f64"] == "trace"
    assert rep.rules_skipped["pairing/valid-permutation"] == "pairing"
    assert rep.exit_code == 0


def test_unknown_rule_id_is_refused():
    with pytest.raises(ValueError, match="schedule/no-such-rule"):
        run_rules(RuleContext(target="t"), rule_ids=["schedule/no-such-rule"])


def test_a_rule_that_raises_is_an_error_not_a_skip(monkeypatch):
    def boom(ctx):
        raise RuntimeError("broken rule")
        yield

    monkeypatch.setattr(RULE_REGISTRY["dtype/no-f64"], "fn", boom)
    rep = run_rules(RuleContext(target="t", trace=_trace([])),
                    rule_ids=["dtype/no-f64", "dtype/convert-churn"])
    assert rep.exit_code == 1 and rep.rules_run == ["dtype/convert-churn", "dtype/no-f64"]
    assert "RuntimeError: broken rule" in rep.errors()[0].message


def test_report_json_round_trip_and_measured_lookup():
    rep = AnalysisReport(
        target="t",
        findings=[Finding("r/a", "info", "t", "m", measured=7, expected=7),
                  Finding("r/b", "error", "t/x", "boom", measured=9, expected=7)],
        rules_run=["r/a", "r/b"],
        rules_skipped={"r/c": "step"},
    )
    assert rep.exit_code == 1
    assert rep.measured("r/a") == 7
    assert rep.measured("r/b", location="t/x") == 9
    with pytest.raises(KeyError):
        rep.measured("r/absent")
    d = json.loads(rep.to_json())
    assert list(d) == ["target", "errors", "warnings", "rules_run", "rules_skipped", "findings"]
    assert d["errors"] == 1 and d["rules_skipped"] == {"r/c": "step"}
    assert d["findings"][1]["severity"] == "error"
    assert any("ERROR r/b" in line for line in rep.summary_lines())
    with pytest.raises(ValueError):
        Finding("r/a", "fatal", "t", "m")


def test_cli_refuses_unknown_rules_and_needs_a_target(capsys):
    from repro_torch.analysis.__main__ import main

    for argv in (["--target", "lenet_fused", "--rules", "nope/x"], []):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert e.value.code == 2
    capsys.readouterr()


def test_a_target_that_fails_to_build_is_an_error(monkeypatch):
    def broken(cfg, knobs, device):
        raise RuntimeError("no such weights")

    monkeypatch.setitem(targets._BUILDERS, "model_zoo", broken)
    rep = targets.run_target("model_zoo", device="cpu")
    assert rep.exit_code == 1
    assert rep.errors()[0].rule == "target/build" and "no such weights" in rep.errors()[0].message


# ---------------------------------------------------------------------------
# the import guard
# ---------------------------------------------------------------------------

FORBIDDEN = {"repro", "jax", "jaxlib", "benchmarks"}


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_port_imports_nothing_of_jax_or_the_jax_package():
    files = [*sorted((ROOT / "src" / "repro_torch").rglob("*.py")), ROOT / "chip_smoke.py"]
    bad = {str(p.relative_to(ROOT)): sorted(_imports(p) & FORBIDDEN) for p in files}
    assert not {k: v for k, v in bad.items() if v}
    # and at run time: every module of the port, imported, pulls none in
    code = ("import importlib, pkgutil, sys, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            f"print(sorted(n for n in sys.modules if n.split('.')[0] in {sorted(FORBIDDEN)}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
