"""One chaos workload through both front ends: the JAX package's over its XLA
engines, and the port's over ``gemm="xla"`` engines on the same weights.

The workload is ``benchmarks/serving.py``'s chaos run: ``poisson_workload``
at 30 req/s over 0.6 virtual s from seed 0 (prompts of 3–19 tokens, 2–7 new
tokens), batch 4, ``max_seq`` 48, the bench's front-end config and its full
fault schedule (six pinned faults plus the seeded background draw).  Each
package builds its own workload and schedule from the seeds (the port's from
``repro_torch.serving.chaos``, as ``chip_smoke.py``'s frontend phase builds
them); the test holds them and their settings equal,
then the two runs field for field: the report's summary (all but
``wall_s``), every request's lifecycle and tokens, the incident log and the
faults that fired.
"""
import dataclasses

import jax
import numpy as np
import pytest

from benchmarks import serving as bench
from repro import serving as J
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import lm as JM
from repro.models.param import unzip
from repro_torch import serving as T
from repro_torch.configs import get_smoke_config
from repro_torch.models import lm as M
from repro_torch.serving import chaos

RATE = chaos.CHAOS_RPS
REQUEST_FIELDS = ("rid", "arrival", "state", "tokens", "admit_time", "first_token_time",
                  "finish_time", "shed_reason", "retries", "degraded", "prefill_done")


@pytest.fixture(scope="module")
def runs():
    jcfg = dataclasses.replace(jax_smoke_config("qwen2-1.5b"), dtype="float32")
    values = jax.tree.map(np.asarray, unzip(JM.init_lm(jcfg, jax.random.key(0)))[0])
    jknobs = JM.PerfKnobs(q_chunk=16, k_chunk=16, remat="none")
    jeng = [J.ServeEngine(jcfg, values, max_seq=bench.MAX_SEQ, batch_size=bench.BATCH,
                          knobs=jknobs) for _ in range(2)]
    jwl = J.poisson_workload(vocab=jcfg.vocab, rate_rps=RATE, horizon_s=bench.HORIZON_S,
                             seed=bench.SEED, prompt_len=bench.PROMPT_LEN,
                             new_tokens=bench.NEW_TOKENS)
    jfaults = bench._chaos_schedule(quick=False)
    jrep = J.ServeFrontend(*jeng, bench._frontend_cfg(), faults=jfaults).run(
        jwl, offered_load_rps=RATE)

    cfg = dataclasses.replace(get_smoke_config("qwen2-1.5b"), dtype="float32")
    model = M.lm_params_from_numpy(values, cfg, device="cpu")
    knobs = M.PerfKnobs(q_chunk=16, k_chunk=16, gemm="xla")
    teng = [T.ServeEngine(cfg, model, max_seq=chaos.MAX_SEQ, batch_size=chaos.BATCH,
                          knobs=knobs) for _ in range(2)]
    twl = chaos.chaos_workload(cfg.vocab, RATE)
    tfaults = chaos.chaos_schedule()
    tcfg = chaos.frontend_config()
    trep = T.ServeFrontend(*teng, tcfg, faults=tfaults).run(twl, offered_load_rps=RATE)
    return {"jax": (jwl, jfaults, jrep), "torch": (twl, tfaults, trep),
            "configs": (bench._frontend_cfg(), tcfg)}


def test_same_workload_schedule_and_config(runs):
    jwl, jfaults, _ = runs["jax"]
    twl, tfaults, _ = runs["torch"]
    assert len(jwl) == len(twl) > 10
    for a, b in zip(jwl, twl, strict=True):
        assert (a.rid, a.arrival, a.max_new_tokens) == (b.rid, b.arrival, b.max_new_tokens)
        np.testing.assert_array_equal(a.prompt, b.prompt)
    assert [dataclasses.asdict(e) for e in jfaults.events] == \
        [dataclasses.asdict(e) for e in tfaults.events]
    jcfg, tcfg = runs["configs"]
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    names = ("SEED", "BATCH", "MAX_SEQ", "HORIZON_S", "PROMPT_LEN", "NEW_TOKENS", "LOADS_RPS",
             "LOADS_RPS_QUICK")
    assert {n: getattr(chaos, n) for n in names} == {n: getattr(bench, n) for n in names}
    # the bench's quick run: the pinned faults alone
    assert [dataclasses.asdict(e) for e in bench._chaos_schedule(quick=True).events] == \
        [dataclasses.asdict(e) for e in chaos.chaos_schedule(quick=True).events]
    # the bench's chaos run offers half its top load
    assert RATE == bench.LOADS_RPS[-1] / 2


def test_summary_matches_field_for_field(runs):
    jsum, tsum = runs["jax"][2].summary(), runs["torch"][2].summary()
    jsum.pop("wall_s"), tsum.pop("wall_s")
    assert tsum == jsum
    # the chaos run exercises every path the comparison should cover
    assert jsum["lost"] == 0 and jsum["degraded"] >= 1 and jsum["completed"] >= 1
    assert jsum["incidents"].get("injected:kv_poison", 0) >= 1


def test_requests_match(runs):
    jrep, trep = runs["jax"][2], runs["torch"][2]
    for a, b in zip(jrep.requests, trep.requests, strict=True):
        want = {f: getattr(a, f) for f in REQUEST_FIELDS}
        got = {f: getattr(b, f) for f in REQUEST_FIELDS}
        assert got == want, f"rid {a.rid}"
    assert J.faulted_request_ids(jrep) == T.faulted_request_ids(trep) != set()


def test_incident_log_and_fired_faults_match(runs):
    _, jfaults, jrep = runs["jax"]
    _, tfaults, trep = runs["torch"]
    assert trep.incidents.as_dicts() == jrep.incidents.as_dicts()
    assert [dataclasses.asdict(e) for e in tfaults.fired] == \
        [dataclasses.asdict(e) for e in jfaults.fired]
