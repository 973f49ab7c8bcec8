"""The port's serving bench (``repro_torch.benchmarks.serving``) against the
JAX front end, as ``benchmarks/serving.py`` drives it in its quick run.

Both sides serve the JAX package's qwen2-1.5b smoke weights (fp32, seed 0)
over the bench's workload (``poisson_workload`` from seed 0 at 10 and 40
req/s, then the chaos run at 20 req/s with the six pinned faults).  The
JAX side runs its ``ServeFrontend`` over XLA engines, fresh ones a load as
the JAX bench builds them (as ``tests/test_torch_frontend_parity.py`` does:
the JAX bench's paired primary would run K1 in interpret mode); the port's
``serving.run(quick=True)`` runs its own engines, the primary paired at
r=0 (K1's plain version), the fallback and reference on ``torch.matmul``.
The sweep's rows and the chaos record equal the JAX runs' field for field,
but for the host's wall seconds.  The bench on its own seed passes its
three gates.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest

from benchmarks import serving as bench
from repro import serving as J
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import lm as JM
from repro.models.param import unzip
from repro_torch.benchmarks import common, serving
from repro_torch.configs import get_smoke_config
from repro_torch.models import lm as M
from repro_torch.serving import chaos

QUICK_RATE = bench.LOADS_RPS_QUICK[-1] / 2


def _jax_row(rate: float, s: dict) -> dict:
    """The JAX bench's sweep row from a JAX summary, then the port's extra
    fields of the same summary."""
    return {"offered_rps": rate, "requests": s["n_requests"], "completed": s["completed"],
            "shed": s["shed"], "p50_s": s["latency_s"]["p50"], "p99_s": s["latency_s"]["p99"],
            "ttft_p50_s": s["ttft_s"]["p50"], "tok_per_s": s["tokens_per_s_virtual"],
            **{k: s[k] for k in ("degraded", "lost", "shed_reasons", "steps",
                                 "generated_tokens", "incidents", "wall_s")}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jcfg = dataclasses.replace(jax_smoke_config("qwen2-1.5b"), dtype="float32")
    values = jax.tree.map(np.asarray, unzip(JM.init_lm(jcfg, jax.random.key(0)))[0])
    jknobs = JM.PerfKnobs(q_chunk=16, k_chunk=16, remat="none")

    def jax_frontend(faults=None):
        engines = [J.ServeEngine(jcfg, values, max_seq=bench.MAX_SEQ, batch_size=bench.BATCH,
                                 knobs=jknobs) for _ in range(2)]
        return J.ServeFrontend(*engines, bench._frontend_cfg(), faults=faults)

    def jax_workload(rate):
        return J.poisson_workload(vocab=jcfg.vocab, rate_rps=rate, horizon_s=bench.HORIZON_S,
                                  seed=bench.SEED, prompt_len=bench.PROMPT_LEN,
                                  new_tokens=bench.NEW_TOKENS)

    jsweep = [_jax_row(rate, jax_frontend().run(jax_workload(rate),
                                                offered_load_rps=rate).summary())
              for rate in bench.LOADS_RPS_QUICK]
    jfaults = bench._chaos_schedule(quick=True)
    jrep = jax_frontend(jfaults).run(jax_workload(QUICK_RATE), offered_load_rps=QUICK_RATE)

    results = tmp_path_factory.mktemp("results")
    saved, common.RESULTS_DIR = common.RESULTS_DIR, results
    try:
        cfg = dataclasses.replace(get_smoke_config("qwen2-1.5b"), dtype="float32")
        out = serving.run(quick=True, device="cpu",
                          model=M.lm_params_from_numpy(values, cfg, device="cpu"))
    finally:
        common.RESULTS_DIR = saved
    payload = json.loads((results / "torch_serving.json").read_text())
    return {"jax": (jsweep, jfaults, jrep), "port": (out, payload)}


def _no_wall(d: dict) -> dict:
    return {k: v for k, v in d.items() if k != "wall_s"}


def test_sweep_rows_match_field_for_field(runs):
    jsweep, _, _ = runs["jax"]
    out, payload = runs["port"]
    got = out["perf_summary"]["load_sweep"]
    assert [r["offered_rps"] for r in got] == list(bench.LOADS_RPS_QUICK)
    assert [_no_wall(r) for r in got] == [_no_wall(r) for r in jsweep]
    assert payload["load_sweep"] == json.loads(json.dumps(got))
    assert all(r["lost"] == 0 and r["completed"] > 0 for r in got)


def test_chaos_record_matches_field_for_field(runs):
    _, jfaults, jrep = runs["jax"]
    out, payload = runs["port"]
    rec = payload["chaos"]
    jsum = jrep.summary()
    assert _no_wall({k: rec[k] for k in jsum}) == json.loads(json.dumps(_no_wall(jsum)))
    assert rec["offered_load_rps"] == QUICK_RATE
    assert rec["scheduled_faults"] == len(jfaults.events) == 6
    assert rec["fired_faults"] == len(jfaults.fired)
    assert rec["faulted_requests"] == sorted(J.faulted_request_ids(jrep))
    assert rec["incident_log"] == json.loads(json.dumps(jrep.incidents.as_dicts()))
    assert _no_wall(out["perf_summary"]["chaos"]) == _no_wall(
        {k: v for k, v in rec.items() if k != "incident_log"})


def test_quick_run_passes_its_gates(runs):
    """On the JAX weights: no failure, every completion token-exact against
    the reference, a degraded one among them."""
    _, payload = runs["port"]
    rec = payload["chaos"]
    assert payload["failures"] == [] and rec["diverged"] == []
    assert rec["lost"] == 0 and rec["faulted_requests"]
    assert rec["parity_checked"] == {"completed": rec["completed"],
                                     "degraded": rec["degraded"]}
    assert rec["degraded"] >= 1


def test_run_on_its_own_seed(tmp_path, monkeypatch):
    monkeypatch.setattr(common, "RESULTS_DIR", tmp_path)
    out = serving.run(quick=True, device="cpu")
    payload = json.loads((tmp_path / "torch_serving.json").read_text())
    assert payload["failures"] == [] and payload["device"] == "cpu"
    assert payload["chaos"]["parity_checked"]["degraded"] >= 1
    assert len(out["perf_summary"]["load_sweep"]) == len(chaos.LOADS_RPS_QUICK)


def test_divergence_names_the_step_and_margin():
    """A request whose tokens leave the reference's: the first differing
    step and the reference's top-2 margin there."""
    cfg = dataclasses.replace(get_smoke_config("qwen2-1.5b"), dtype="float32")
    model = M.init_lm(cfg, 0, device="cpu")
    _, _, ref = serving.engines(cfg, model)
    prompt = np.arange(3, 9, dtype=np.int32)
    want = ref.generate({0: prompt}, n_steps=4)[0]
    ref.release_slot(0)
    req = chaos.chaos_workload(cfg.vocab, 10.0)[0]
    req = dataclasses.replace(req, prompt=prompt, tokens=want[:2] + [(want[2] + 1) % cfg.vocab])
    d = serving.divergence(ref, req, want)
    assert (d["step"], d["got"], d["want"]) == (2, [(want[2] + 1) % cfg.vocab], want[2])
    assert d["ref_top2_margin"] >= 0
