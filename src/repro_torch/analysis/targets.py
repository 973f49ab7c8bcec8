"""Analysis targets: the :class:`RuleContext` of each traced program the CLI lints.

The port of ``repro.analysis.targets``: the same seven names, inputs and
expectations.  Each target runs one real path of the port once, with the
same knobs the benches and the serving engine use, under
``analysis.trace``, then declares what the schedule must look like.  Weights
are seeded inits, drawn on the CPU whatever the device (:func:`seeded_lm`),
so a card trace pairs what a CPU trace pairs: every rule checks structure
(schedule, dtypes, plans, index validity), none of which depends on trained
values, but K1's plans follow the pairing's (Pmax, Rmax).

Each builder takes ``cfg`` (default: the JAX target's smoke config),
``knobs`` and ``device`` (default: the GPU; ``"cpu"`` runs the kernels'
plain versions, whose trace has the same nodes).  The decode targets trace
the serving engine's path: a frozen copy of the model (``LM.copy(frozen=
True)``: the compute-dtype casts and the kernels' segments are derived once)
after one warm-up step, so the trace is a steady step, as the JAX rule
reads the body of the compiled decode loop.  ``*_context`` functions build
a target's context from given weights (the tests hand them the JAX
package's).

Eager PyTorch runs every layer, so a decode target's expectations are the
JAX ones a layer (``writebacks_per_layer``) and times the layers for the
whole step (``pallas_calls``, ``residual_adds``).  ``sharded_decode``
spawns the ranks of a (1, 2) mesh (``launch.mesh.spawn``; gloo), traces
every rank's decode step and runs the rules there: :func:`run_target`
merges the ranks' reports, each finding's location naming its rank.
"""
from __future__ import annotations

import dataclasses as dc
import traceback

import torch

from repro_torch.analysis.core import AnalysisReport, Finding, RuleContext, run_rules
from repro_torch.analysis.trace import record_trace

TARGETS = ("lenet_fused", "lm_decode", "serve_step", "serve_frontend",
           "fused_attn_decode", "model_zoo", "sharded_decode")

#: the decode targets' batch: 2 slots of a 32-position cache, one token each
#: at positions 5 and 11 (the JAX targets')
DECODE_BATCH, DECODE_SEQ, DECODE_POS = 2, 32, (5, 11)
SHARDED_MESH = (1, 2)


def smoke_lm_cfg():
    """qwen2-1.5b's smoke config in fp32 (the JAX targets': aligned with the
    parity benches)."""
    from repro_torch.configs import get_smoke_config

    return dc.replace(get_smoke_config("qwen2-1.5b"), dtype="float32")


def paired_knobs():
    """The paired decode knobs: per-column pairing at r = 0.05."""
    from repro_torch.models import lm as M

    return M.PerfKnobs(q_chunk=16, k_chunk=16, remat="none", gemm="pallas_paired",
                       pair_block_n=1, pair_rounding=0.05)


def writebacks_per_layer(cfg, knobs) -> int:
    """Kernel writebacks of the costliest decode layer of ``cfg`` under
    ``knobs``: ``analysis.decode_launches``' K1 and K2 launches.  Under
    ``gemm="pallas"`` every GEMM runs K1's dense form: as many launches as
    the paired route makes without fused attention."""
    from repro_torch.analysis import decode_launches

    if knobs.gemm == "pallas":
        knobs = dc.replace(knobs, gemm="pallas_paired", attn="xla")
    return max(sum(decode_launches(cfg, cfg.layer_kind(i), knobs).values())
               for i in range(cfg.n_layers))


def _device(device) -> torch.device:
    from repro_torch.device import resolve_device

    return resolve_device(device)


# ---------------------------------------------------------------------------
# LeNet
# ---------------------------------------------------------------------------


def lenet_context(params: dict, *, target: str = "lenet_fused") -> RuleContext:
    """The fused conv→pool LeNet forward on K1 (r = 0, structured), four
    zero images, on ``params``' device."""
    from repro_torch.core.transform import build_conv_pairings
    from repro_torch.models.lenet import LENET_CONV_POSITIONS, lenet_apply

    arts = build_conv_pairings(params, 0.0, positions=LENET_CONV_POSITIONS)
    x = torch.zeros((4, 32, 32, 1), device=params["conv1"]["w"].device)
    with torch.no_grad():
        trace = record_trace(lenet_apply, params, x, conv_impl="paired", paired=arts,
                             fuse_pool=True)
    return RuleContext(
        target=target,
        trace=trace,
        pairing_artifacts=arts,
        expect={
            "fused_pool": True,
            # one kernel writeback per conv layer, nothing else
            "pallas_calls": len(arts),
        },
    )


def build_lenet_fused(cfg=None, knobs=None, device=None) -> RuleContext:
    """Fused conv→pool LeNet forward on the paired kernel (seeded weights;
    LeNet has no config or knobs)."""
    from repro_torch.models.lenet import init_lenet

    return lenet_context(init_lenet(0, device=_device(device)))


# ---------------------------------------------------------------------------
# the LM decode targets
# ---------------------------------------------------------------------------


def _decode_batch(device) -> tuple[torch.Tensor, torch.Tensor]:
    tok = torch.zeros((DECODE_BATCH, 1), dtype=torch.int64, device=device)
    return tok, torch.tensor(DECODE_POS, dtype=torch.int32, device=device)


def decode_context(target: str, cfg, model, knobs, *, engine_step: bool = False) -> RuleContext:
    """One decode step of ``model`` (paired, or unpaired under
    ``gemm="pallas"``) under ``knobs``: ``models.lm.decode_step``, or with
    ``engine_step`` the engine's step (``serving.steps.build_serve_step``),
    on a frozen copy after a warm-up step, its pairing storages registered."""
    from repro_torch.kernels.ops import tile_cache_context
    from repro_torch.models import lm as M
    from repro_torch.serving.steps import build_serve_step

    served = model.copy(frozen=True)
    dev = served.embed.device
    cache = M.init_cache(cfg, DECODE_BATCH, DECODE_SEQ, device=dev)
    tok, pos = _decode_batch(dev)
    if engine_step:
        serve_step = build_serve_step(cfg, knobs)

        def step(m, c):
            return serve_step(m, c, {"tokens": tok, "pos": pos})
    else:
        def step(m, c):
            with torch.no_grad(), tile_cache_context(knobs):
                return M.decode_step(cfg, m, c, tok, pos, knobs=knobs)

    step(served, {k: v.clone() for k, v in cache.items()})
    trace = record_trace(step, served, cache, pairing=served)
    per_layer = writebacks_per_layer(cfg, knobs)
    return RuleContext(
        target=target,
        trace=trace,
        step=trace,
        params=served,
        hidden_shape=(DECODE_BATCH, 1, cfg.d_model),
        expect={
            # the paired path fuses both skips into the kernel's epilogue;
            # the unpaired fallback adds them after K1's dense form, two a layer
            "residual_adds": 2 * cfg.n_layers if knobs.gemm == "pallas" else 0,
            "writebacks_per_layer": per_layer,
            "pallas_calls": per_layer * cfg.n_layers,  # all inside the layers
        },
    )


def pair_model(model, knobs):
    """``model`` paired as ``knobs`` say (per column under
    ``pair_block_n=1``, structured under 0) at ``knobs.pair_rounding``."""
    from repro_torch.core.transform import pair_lm_params
    from repro_torch.kernels.ops import paired_mode_of

    mode, block_n = paired_mode_of(knobs)
    return pair_lm_params(model, knobs.pair_rounding, mode=mode, block_n=block_n)[0]


def seeded_lm(cfg, device):
    """``cfg``'s seed-0 model, drawn on the CPU and placed on ``device``: a
    generator on the card draws other weights, whose pairing (and so K1's
    problems and plans) would differ from the CPU trace's.  (A model as
    ``init_lm_local``'s source keeps its leaves where they are, so each
    leaf is moved here.)"""
    from repro_torch.models import lm as M

    dev = _device(device)
    return M.init_lm_local(cfg, M.init_lm(cfg, 0, device="cpu"), lambda _, t: t.to(dev))


def paired_lm(cfg, knobs, device):
    """The seeded model of ``cfg`` (:func:`seeded_lm`), paired as ``knobs`` say."""
    return pair_model(seeded_lm(cfg, device), knobs)


def build_lm_decode(cfg=None, knobs=None, device=None) -> RuleContext:
    """Single-host paired LM decode step (the ServeEngine path)."""
    cfg, knobs = cfg or smoke_lm_cfg(), knobs or paired_knobs()
    return decode_context("lm_decode", cfg, paired_lm(cfg, knobs, device), knobs)


def build_fused_attn_decode(cfg=None, knobs=None, device=None) -> RuleContext:
    """The fused-attention paired decode step (``attn="pallas_fused"``): K2
    consumes the KV cache and applies the paired out-projection and the
    sublayer residual in its flush, and the q|k|v projections run as one
    concatenated K1 launch — five writebacks a layer instead of seven."""
    cfg = cfg or smoke_lm_cfg()
    knobs = knobs or dc.replace(paired_knobs(), attn="pallas_fused")
    return decode_context("fused_attn_decode", cfg, paired_lm(cfg, knobs, device), knobs)


def build_serve_step(cfg=None, knobs=None, device=None) -> RuleContext:
    """The engine's decode step (``serving.steps.build_serve_step``; the JAX
    target's one-device mesh is no mesh here)."""
    cfg, knobs = cfg or smoke_lm_cfg(), knobs or paired_knobs()
    return decode_context("serve_step", cfg, paired_lm(cfg, knobs, device), knobs,
                          engine_step=True)


def build_serve_frontend(cfg=None, knobs=None, device=None) -> RuleContext:
    """The hardened front end's degraded path: the unpaired ``gemm="pallas"``
    decode step the numeric watchdog retries quarantined requests on
    (``serving.guards``).  No pairing metadata, but a sane schedule: the
    seven GEMMs a layer on K1's dense form, the two residual adds a layer
    standalone, no f64."""
    from repro_torch.models import lm as M

    cfg = cfg or smoke_lm_cfg()
    knobs = knobs or M.PerfKnobs(q_chunk=16, k_chunk=16, remat="none", gemm="pallas")
    return decode_context("serve_frontend", cfg, seeded_lm(cfg, device), knobs)


# ---------------------------------------------------------------------------
# the model zoo's pairing metadata
# ---------------------------------------------------------------------------


def zoo_cfg():
    """deepseek-v2-lite-16b's smoke config in fp32."""
    from repro_torch.configs import get_smoke_config

    return dc.replace(get_smoke_config("deepseek-v2-lite-16b"), dtype="float32")


def zoo_context(cfg, model, *, target: str = "model_zoo") -> RuleContext:
    """The per-column r = 0.05 pairing metadata of ``model`` over its
    config's paired leaves: the pairing rules alone."""
    from repro_torch.core.transform import pair_params

    pm, _ = pair_params(model, 0.05, mode="per_column", leaves=cfg.paired_leaves or None)
    return RuleContext(target=target, params=pm, expect={})


def build_model_zoo(cfg=None, knobs=None, device=None) -> RuleContext:
    """Pairing metadata of the hardest zoo member (deepseek: MLA latents,
    leading-expert-axis MoE weights, shared experts, a leading dense
    layer): the valid-permutation, padding and stacked-shape invariants on
    the expert metadata the expert grid consumes."""
    cfg = cfg or zoo_cfg()
    return zoo_context(cfg, seeded_lm(cfg, device))


# ---------------------------------------------------------------------------
# the sharded decode cell
# ---------------------------------------------------------------------------


def sharded_rank(mesh, cfg=None, knobs=None, rule_ids=None, source=0) -> AnalysisReport:
    """One rank of ``sharded_decode`` (run by ``launch.mesh.spawn``): wire
    the rank's part of the paired decode cell (``launch.steps.wire_serve_cell``:
    its shards paired per shard, its metadata placed beside them), trace its
    decode step after a warm-up step, and run the rules on the rank.  The
    trace is the context's ``step`` alone, as the JAX target gives the
    compiled HLO alone."""
    from repro_torch.launch.steps import wire_serve_cell
    from repro_torch.models import lm as M

    cfg, knobs = cfg or smoke_lm_cfg(), knobs or paired_knobs()
    cell = wire_serve_cell(cfg, source, mesh, batch_size=DECODE_BATCH, max_seq=DECODE_SEQ,
                           knobs=knobs)
    cache = M.init_cache(cfg, DECODE_BATCH, DECODE_SEQ, device=mesh.device, tp=cell.tp)
    tok, pos = _decode_batch(mesh.device)
    batch = {"tokens": tok, "pos": pos}
    cell.decode(cell.model, {k: v.clone() for k, v in cache.items()}, batch)
    trace = record_trace(cell.decode, cell.model, cache, batch, pairing=cell.model)
    ctx = RuleContext(target=f"sharded_decode/rank{mesh.rank}", step=trace,
                      params=cell.model, expect={})
    return run_rules(ctx, rule_ids)


def run_sharded_decode(cfg=None, knobs=None, device=None, rule_ids=None) -> AnalysisReport:
    """Every rank's report of the sharded decode cell on a (1, 2) mesh of
    gloo ranks, merged: the findings of all ranks, located by rank."""
    from repro_torch.launch.mesh import spawn

    dev = _device(device).type
    reports = spawn(sharded_rank, SHARDED_MESH, backend="gloo", device=dev,
                    kwargs={"cfg": cfg, "knobs": knobs, "rule_ids": rule_ids})
    return AnalysisReport(
        target="sharded_decode",
        findings=[f for r in reports for f in r.findings],
        rules_run=reports[0].rules_run,
        rules_skipped=reports[0].rules_skipped,
    )


_BUILDERS = {
    "lenet_fused": build_lenet_fused,
    "lm_decode": build_lm_decode,
    "serve_step": build_serve_step,
    "serve_frontend": build_serve_frontend,
    "fused_attn_decode": build_fused_attn_decode,
    "model_zoo": build_model_zoo,
}


def build_context(target: str, *, cfg=None, knobs=None, device=None) -> RuleContext:
    """The context of one single-process target (``sharded_decode``'s ranks
    run their rules where they trace: :func:`run_target`)."""
    if target not in _BUILDERS:
        raise ValueError(f"no single-process context for target {target!r}; "
                         f"choose from {tuple(_BUILDERS)}")
    return _BUILDERS[target](cfg, knobs, device)


def run_target(target: str, *, rule_ids=None, cfg=None, knobs=None,
               device=None) -> AnalysisReport:
    """The report of one target.  A target that fails to build is not
    skipped: its report is one error finding (``target/build``) with the
    exception, and the exit code is 1."""
    if target not in TARGETS:
        raise ValueError(f"unknown target {target!r}; choose from {TARGETS}")
    try:
        if target == "sharded_decode":
            return run_sharded_decode(cfg, knobs, device, rule_ids)
        ctx = build_context(target, cfg=cfg, knobs=knobs, device=device)
    except Exception as e:  # noqa: BLE001 — a target that breaks is an error finding
        return AnalysisReport(target=target, findings=[Finding(
            rule="target/build", severity="error", location=target,
            message=f"the target failed to build: {type(e).__name__}: {e}",
            measured=traceback.format_exc()[-4000:], expected="the target builds")],
            rules_run=[], rules_skipped={})
    return run_rules(ctx, rule_ids)
