"""The port's decode targets (``repro_torch.analysis.targets``) against the
JAX package's: ``lm_decode``, ``fused_attn_decode``, ``serve_step``,
``serve_frontend`` and ``sharded_decode``.

The JAX contexts are built once for the module and linted by every JAX rule
but ``vmem/static-budget`` (``_analysis_jax``).  The port's targets run on
the CPU over the JAX targets' qwen2 smoke weights (fp32, 2 layers), carried
across from numpy and paired by the port, index for index the JAX pairing;
their traces hold each kernel call as one node, so K2's plain version does
not show its residual add.  Rule by rule (``_analysis_jax.held_to_jax``):
the port's count a decode layer is the JAX count a scan trip, its count a
step (writebacks, residual adds) the trip's times the 2 layers.

``sharded_decode`` runs its two gloo ranks of a (1, 2) mesh on the CPU (in
a thread started with the module, beside the JAX work).  Its rank's
metadata are its shards' (``launch.steps.wire_serve_cell``), so each rank's
pairing counts are held to its shards' plan (``core.transform.
tp_shard_plan``: a column-split leaf's blocks are its share of the
columns), not to the JAX (1, 1) numbers; ``moves/pairing-in-step`` finds
nothing moved on any rank, as the JAX rule finds nothing resharded.
"""
import dataclasses
import threading

import jax
import pytest

from _analysis_jax import PAIRING_RULES, assert_same_metadata, held_to_jax, jax_rule_ids, np_tree
from repro.analysis import run_rules as j_run_rules
from repro.analysis import targets as j_targets
from repro.models import lm as JM
from repro.models.param import unzip
from repro_torch.analysis import decode_launches, run_rules
from repro_torch.analysis import targets as t_targets
from repro_torch.core.transform import LM_PAIRED_WEIGHTS, _lm_weight_matrix_shape, tp_shard_plan
from repro_torch.models import lm as TM
from repro_torch.models.param import param_axes_and_shapes
from repro_torch.parallel.rules import rules_for
from repro_torch.parallel.sharding import Mesh

DECODE = ("lm_decode", "fused_attn_decode", "serve_step", "serve_frontend")
LAYERS = 2
#: the Motivation table's values a trip: kernel writebacks, residual adds
PER_TRIP = {"lm_decode": (7, 0), "fused_attn_decode": (5, 0), "serve_step": (7, 0),
            "serve_frontend": (7, 2)}


@pytest.fixture(scope="module")
def sharded_port():
    """The port's ``sharded_decode`` report, run in a thread started with the
    module (its ranks are processes of their own)."""
    box = {}

    def run():
        try:
            box["report"] = t_targets.run_target("sharded_decode", device="cpu")
        except BaseException as e:  # noqa: BLE001 — re-raised by the test
            box["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    yield thread, box
    thread.join(timeout=300)


@pytest.fixture(scope="module")
def jax_reports(sharded_port):
    ids = jax_rule_ids()
    out = {}
    for name in (*DECODE, "sharded_decode"):
        ctx = j_targets.build_context(name)
        out[name] = ctx, j_run_rules(ctx, rule_ids=ids)
    return out


@pytest.fixture(scope="module")
def values():
    """The JAX targets' weights (``init_lm(smoke qwen2, key(0))``) as numpy."""
    return np_tree(unzip(JM.init_lm(j_targets._smoke_lm_cfg(), jax.random.key(0)))[0])


def _port_context(name: str, values):
    """The port's context of ``name`` on ``values``, and its knobs."""
    cfg = t_targets.smoke_lm_cfg()
    model = TM.lm_params_from_numpy(values, cfg, device="cpu")
    if name == "serve_frontend":
        knobs = TM.PerfKnobs(q_chunk=16, k_chunk=16, remat="none", gemm="pallas")
        return t_targets.decode_context(name, cfg, model, knobs), knobs
    knobs = t_targets.paired_knobs()
    if name == "fused_attn_decode":
        knobs = dataclasses.replace(knobs, attn="pallas_fused")
    return t_targets.decode_context(name, cfg, t_targets.pair_model(model, knobs), knobs,
                                    engine_step=name == "serve_step"), knobs


@pytest.mark.parametrize("name", DECODE)
def test_decode_target_equals_jax(name, jax_reports, values):
    j_ctx, want = jax_reports[name]
    ctx, knobs = _port_context(name, values)
    # the port pairs the JAX weights as the JAX target does
    assert assert_same_metadata(ctx.params, j_ctx.params) == (0 if name == "serve_frontend"
                                                                else 7)
    port = run_rules(ctx)
    held_to_jax(port, want, layers=LAYERS)
    per_layer, adds = PER_TRIP[name]
    assert port.measured("schedule/writebacks-per-program") == per_layer * LAYERS
    assert [f.measured for f in port.findings
            if f.rule == "schedule/writebacks-per-decode-layer"] == [per_layer] * LAYERS
    assert port.measured("schedule/standalone-residual-adds") == adds * LAYERS
    # as many as the paired route launches (K1's dense form under "pallas")
    paired = dataclasses.replace(knobs, gemm="pallas_paired")
    assert per_layer == sum(decode_launches(t_targets.smoke_lm_cfg(), "dense", paired).values())
    assert port.measured("moves/pairing-in-step") == 0
    assert [port.measured(r) for r in PAIRING_RULES] == (
        [0, 0, 0] if name == "serve_frontend" else [1024, 1024, 7])
    assert port.measured("dtype/no-f64") == 0
    assert port.measured("dtype/reduce-precision-on-bf16") == 0
    assert 0 < port.measured("smem/static-budget") <= 232_448
    # the trace counts the kernels' calls on the CPU; nothing launched
    assert set(ctx.trace.launches.values()) == {0}


def _rank_blocks(cfg) -> int:
    """Column blocks (``pair_block_n=1``: one a column) of a (1, 2) rank's
    paired shards over every layer: a column-split leaf's N / 2, a
    row-split one's N."""
    mesh = Mesh({"data": 1, "model": 2})
    p_axes, shapes = param_axes_and_shapes(cfg)
    plan = tp_shard_plan(p_axes, shapes, mesh, rules_for(cfg, "decode", mesh),
                         leaves=cfg.paired_leaves)
    assert set(plan) == set(LM_PAIRED_WEIGHTS)
    model = TM.init_lm(cfg, 0, device="cpu")
    total = 0
    for (sub, name), (_, cs) in plan.items():
        w = getattr(getattr(model.layers[0], sub), name)
        total += _lm_weight_matrix_shape(name, tuple(w.shape))[1] // cs
    return total * cfg.n_layers


def test_sharded_decode_moves_nothing_on_any_rank(sharded_port, jax_reports):
    thread, box = sharded_port
    thread.join(timeout=300)
    assert "error" not in box, box.get("error")
    port = box["report"]
    _, want = jax_reports["sharded_decode"]
    assert want.exit_code == 0 and want.measured("hlo/pairing-resharding-in-loop") == 0
    assert port.exit_code == 0, [f.as_dict() for f in port.errors()]
    assert port.rules_run == ["moves/pairing-in-step", *sorted(PAIRING_RULES)]
    blocks = _rank_blocks(t_targets.smoke_lm_cfg())
    for rank in (0, 1):
        loc = f"sharded_decode/rank{rank}"
        assert port.measured("moves/pairing-in-step", location=loc) == 0
        assert [port.measured(r, location=loc) for r in PAIRING_RULES] == [blocks, blocks, 7]
    assert blocks == 640  # qwen2 smoke: wq 32, wk 16, wv 16, wo 64, gate 64, up 64, down 64
