"""The port's hardened serving front end, on the port alone: the gates of
``tests/test_serve_frontend.py`` and ``benchmarks/serving.py``.

Setup: the qwen2 smoke config in fp32; the primary engine runs the paired
GEMMs at rounding 0 with the fused decode attention (``gemm="pallas_paired"``,
``attn="pallas_fused"``: on CPU tensors the kernels' plain versions), the
fallback is unpaired (``torch.matmul``).  The invariant every test circles:
a request either completes with the exact greedy token stream of a fresh
unpaired reference engine, or is shed with a structured reason — never
lost, never garbage tokens.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models import lm as M
from repro_torch.serving import (
    FAULT_KINDS,
    SLOT_FAULTS,
    FaultEvent,
    FaultInjector,
    FrontendConfig,
    GuardConfig,
    Request,
    ServeEngine,
    ServeFrontend,
    check_logits,
    faulted_request_ids,
    poisson_workload,
)
from repro_torch.serving.faults import poison_slot_cache

CFG = dataclasses.replace(get_smoke_config("qwen2-1.5b"), dtype="float32")
MAX_SEQ = 32
BATCH = 2
BASE = dict(q_chunk=16, k_chunk=16)
PRIMARY = M.PerfKnobs(**BASE, gemm="pallas_paired", attn="pallas_fused", pair_rounding=0.0)


@pytest.fixture(scope="module")
def stack():
    """(model, primary, fallback); _reset() clears slot state between tests."""
    model = M.init_lm(CFG, 0, device="cpu")
    primary = ServeEngine(CFG, model, max_seq=MAX_SEQ, batch_size=BATCH, knobs=PRIMARY)
    fallback = ServeEngine(CFG, model, max_seq=MAX_SEQ, batch_size=BATCH,
                           knobs=M.PerfKnobs(**BASE))
    return model, primary, fallback


def _reset(*engines):
    for eng in engines:
        for s in range(eng.batch_size):
            eng.clear_quarantine(s)
            eng.release_slot(s)


def _reference(model, requests, max_seq=MAX_SEQ):
    ref = ServeEngine(CFG, model, max_seq=max_seq, batch_size=1, knobs=M.PerfKnobs(**BASE))
    out = {}
    for r in requests:
        out[r.rid] = ref.generate({0: r.prompt}, n_steps=r.max_new_tokens)[0]
        ref.release_slot(0)
    return out


def _req(rid, prompt, n, arrival=0.0):
    return Request(rid=rid, prompt=np.asarray(prompt, np.int32), max_new_tokens=n,
                   arrival=arrival)


def _rand(seed, n):
    return np.random.default_rng(seed).integers(0, CFG.vocab, size=(n,)).astype(np.int32)


# ---------------------------------------------------------------------------
# workload generation
# ---------------------------------------------------------------------------


def test_poisson_workload_is_seeded_and_bounded():
    a = poisson_workload(rate_rps=50, horizon_s=1.0, seed=3, vocab=64,
                         prompt_len=(2, 9), new_tokens=(1, 5))
    b = poisson_workload(rate_rps=50, horizon_s=1.0, seed=3, vocab=64,
                         prompt_len=(2, 9), new_tokens=(1, 5))
    assert len(a) == len(b) > 10
    for ra, rb in zip(a, b, strict=True):
        assert ra.arrival == rb.arrival
        assert ra.max_new_tokens == rb.max_new_tokens
        np.testing.assert_array_equal(ra.prompt, rb.prompt)
        assert 2 <= ra.plen < 9 and 1 <= ra.max_new_tokens < 5
        assert 0.0 < ra.arrival <= 1.0
    arrivals = [r.arrival for r in a]
    assert arrivals == sorted(arrivals)


# ---------------------------------------------------------------------------
# clean load: continuous batching + chunked prefill
# ---------------------------------------------------------------------------


def test_clean_load_completes_all_with_reference_parity(stack):
    model, primary, fallback = stack
    _reset(primary, fallback)
    wl = poisson_workload(rate_rps=25, horizon_s=0.4, seed=1, vocab=CFG.vocab,
                          prompt_len=(3, 18), new_tokens=(2, 5))
    fe = ServeFrontend(primary, fallback, FrontendConfig(prefill_chunk=5))
    report = fe.run(wl, offered_load_rps=25)

    assert report.lost() == []
    summary = report.summary()
    assert summary["completed"] == len(wl) and summary["shed"] == 0
    assert summary["latency_s"]["p50"] is not None
    assert summary["tokens_per_s_virtual"] > 0
    assert summary["wall_s"] >= 0
    ref = _reference(model, report.requests)
    for r in report.requests:
        assert r.tokens == ref[r.rid], f"rid {r.rid} diverged"
        assert r.first_token_time is not None
        assert r.finish_time >= r.admit_time >= r.arrival


def test_chunked_prefill_matches_monolithic_prefill(stack):
    """A prompt far longer than prefill_chunk rides the shared decode steps
    one token per step and still emits exactly the full-prefill stream."""
    model, primary, fallback = stack
    _reset(primary, fallback)
    r = _req(0, _rand(9, 21), 5)
    fe = ServeFrontend(primary, fallback, FrontendConfig(prefill_chunk=4))
    fe.run([r])
    assert r.state == "completed"
    assert r.tokens == _reference(model, [r])[0]


# ---------------------------------------------------------------------------
# faults → watchdog → degradation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["nan_logits", "inf_logits", "kv_poison"])
def test_numeric_fault_degrades_to_exact_fallback(stack, kind):
    """kv_poison reaches the logits through the model itself: the NaN rows
    pass the fused decode attention's softmax into the slot's logits."""
    model, primary, fallback = stack
    _reset(primary, fallback)
    r = _req(0, _rand(13, 4), 6)
    faults = FaultInjector([FaultEvent(step=1, kind=kind, slot=0)])
    fe = ServeFrontend(primary, fallback, FrontendConfig(prefill_chunk=8), faults=faults)
    report = fe.run([r])

    assert faulted_request_ids(report) == {0}
    assert r.state == "degraded" and r.retries == 1
    assert r.tokens == _reference(model, [r])[0], \
        "degraded completion must be token-exact vs the reference"
    actions = [i.action for i in report.incidents.for_request(0)]
    assert actions == ["injected", "quarantined", "retried_degraded"]
    quarantined = next(i for i in report.incidents.records if i.action == "quarantined")
    assert quarantined.kind == ("inf" if kind == "inf_logits" else "nan")
    # the quarantined slot sat out, then returned to service, scrubbed
    assert not primary.quarantined.any()
    assert not any(torch.isnan(t).any() for t in primary.cache.values())


def test_poison_writes_nan_into_the_attended_rows_only(stack):
    _, primary, fallback = stack
    _reset(primary, fallback)
    primary.add_request(1, _rand(3, 7))
    poison_slot_cache(primary, 1)
    for t in primary.cache.values():
        assert torch.isnan(t[:, 1, :7]).all()
        assert not torch.isnan(t[:, 1, 7:]).any() and not torch.isnan(t[:, 0]).any()
    primary.release_slot(1)
    primary.add_request(0, _rand(4, 3))
    primary.release_slot(0, scrub=False)  # pos 0: the first row still goes
    poison_slot_cache(primary, 0)
    assert all(torch.isnan(t[:, 0, 0]).all() and not torch.isnan(t[:, 0, 1:]).any()
               for t in primary.cache.values())
    _reset(primary)


def test_kernel_failure_transient_is_retried_without_loss(stack):
    model, primary, fallback = stack
    _reset(primary, fallback)
    r = _req(0, _rand(17, 5), 4)
    faults = FaultInjector([FaultEvent(step=1, kind="kernel_failure", magnitude=2)])
    fe = ServeFrontend(primary, fallback, FrontendConfig(prefill_chunk=8, max_kernel_retries=3),
                       faults=faults)
    report = fe.run([r])
    assert r.state == "completed" and not r.degraded
    assert r.tokens == _reference(model, [r])[0]
    assert report.incidents.counts() == {"injected:kernel_failure": 1}


def test_kernel_failure_exhausted_degrades_active_slots(stack):
    model, primary, fallback = stack
    _reset(primary, fallback)
    reqs = [_req(i, _rand(19 + i, 4 + i), 4) for i in range(2)]
    faults = FaultInjector([FaultEvent(step=1, kind="kernel_failure", magnitude=10)])
    fe = ServeFrontend(primary, fallback, FrontendConfig(prefill_chunk=8, max_kernel_retries=2),
                       faults=faults)
    report = fe.run(reqs)
    assert report.lost() == []
    ref = _reference(model, reqs)
    for r in reqs:
        assert r.state == "degraded", "persistent launch failure must degrade"
        assert r.tokens == ref[r.rid]


def test_real_kernel_exceptions_propagate(stack, monkeypatch):
    """Only the simulated failures are handled: an exception raised by an
    engine step (a kernel launch that fails for real) leaves the front end."""
    _, primary, fallback = stack
    _reset(primary, fallback)

    def broken_step(*args, **kwargs):
        raise RuntimeError("decode_attention kernel launch failed: invalid argument (1)")

    monkeypatch.setattr(primary, "step", broken_step)
    fe = ServeFrontend(primary, fallback, FrontendConfig(prefill_chunk=8))
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        fe.run([_req(0, _rand(5, 4), 4)])
    monkeypatch.undo()
    _reset(primary, fallback)


def test_retries_exhausted_sheds_with_structured_reason(stack):
    _, primary, fallback = stack
    _reset(primary, fallback)
    r = _req(0, _rand(23, 4), 6)
    faults = FaultInjector([FaultEvent(step=1, kind="nan_logits", slot=0)])
    fe = ServeFrontend(primary, fallback,
                       FrontendConfig(prefill_chunk=8, guard=GuardConfig(max_retries=0)),
                       faults=faults)
    report = fe.run([r])
    assert report.lost() == []
    assert r.state == "shed" and r.shed_reason == "retries_exhausted:nan"


# ---------------------------------------------------------------------------
# admission policy: deadlines, queue bounds, length bucketing
# ---------------------------------------------------------------------------


def test_deadline_and_too_long_shed_reasons(stack):
    _, primary, fallback = stack
    _reset(primary, fallback)
    too_long = _req(0, _rand(29, MAX_SEQ - 2), 8)
    fine = _req(1, _rand(30, 4), 20, arrival=0.0)
    fe = ServeFrontend(primary, fallback,
                       FrontendConfig(prefill_chunk=8, deadline_s=0.05, step_cost_s=0.01))
    report = fe.run([too_long, fine])
    assert report.lost() == []
    assert too_long.state == "shed" and too_long.shed_reason == "too_long"
    assert fine.state == "shed" and fine.shed_reason == "deadline"
    assert not primary.active.any()  # the deadline shed freed its slot


def test_queue_full_sheds_overflow_arrivals(stack):
    _, primary, fallback = stack
    _reset(primary, fallback)
    reqs = [_req(i, _rand(31 + i, 6), 3, arrival=0.0) for i in range(6)]
    fe = ServeFrontend(primary, fallback, FrontendConfig(prefill_chunk=8, max_queue=3))
    report = fe.run(reqs)
    assert report.lost() == []
    by = report.by_state()
    assert [r.shed_reason for r in by["shed"]] == ["queue_full"] * len(by["shed"])
    assert len(by["shed"]) >= 1
    assert len(by["completed"]) == len(reqs) - len(by["shed"])


def test_length_bucketed_admission_prefers_lead_bucket(stack):
    _, primary, fallback = stack
    fe = ServeFrontend(primary, fallback, FrontendConfig(bucket_width=8, prefill_chunk=8))
    # the oldest request is short → its bucket (short prompts) admits first
    # even though a long request arrived in between
    queue = [_req(0, _rand(37, 3), 2, 0.0), _req(1, _rand(38, 20), 2, 0.001),
             _req(2, _rand(39, 4), 2, 0.002)]
    assert [r.rid for r in fe._bucket_order(queue, now=1.0)] == [0, 2, 1]
    queue[0].not_before = 2.0  # backoff: not eligible yet
    assert [r.rid for r in fe._bucket_order(queue, now=1.0)] == [1, 2]


# ---------------------------------------------------------------------------
# the bench's chaos gates, on the port alone
# ---------------------------------------------------------------------------


def test_chaos_gates(stack):
    """``benchmarks/serving.py``'s chaos run at batch 2: zero lost, every
    slot-targeted fault ends degraded or shed with a reason, and every
    completion (clean or degraded) token-exact vs the reference — none of
    the gates vacuous."""
    model, primary, fallback = stack
    _reset(primary, fallback)
    wl = poisson_workload(rate_rps=30, horizon_s=0.6, seed=0, vocab=CFG.vocab,
                          prompt_len=(3, 20), new_tokens=(2, 8))
    faults = FaultInjector([
        FaultEvent(step=3, kind="nan_logits", slot=0),
        FaultEvent(step=5, kind="kv_poison", slot=1),
        FaultEvent(step=7, kind="inf_logits", slot=0),
        FaultEvent(step=9, kind="kernel_failure", magnitude=2),
        FaultEvent(step=11, kind="latency_spike", magnitude=8.0),
        FaultEvent(step=14, kind="kv_poison", slot=1),
    ])
    fe = ServeFrontend(primary, fallback, FrontendConfig(
        prefill_chunk=6, queue_timeout_s=1.0, guard=GuardConfig(max_retries=2, quarantine_steps=2)),
        faults=faults)
    report = fe.run(wl, offered_load_rps=30)
    assert report.lost() == []
    faulted = faulted_request_ids(report)
    assert faulted, "the schedule hit no occupied slot: the gate gated nothing"
    by_rid = {r.rid: r for r in report.requests}
    for rid in faulted:
        r = by_rid[rid]
        assert r.state == "degraded" or (r.state == "shed" and r.shed_reason), (rid, r.state)
    done = [r for r in report.requests if r.state in ("completed", "degraded")]
    assert any(r.state == "degraded" for r in done)
    ref = _reference(model, done)
    for r in done:
        assert r.tokens == ref[r.rid], f"rid {r.rid} ({r.state}) diverged"
    assert json.loads(json.dumps(report.summary()))["lost"] == 0
    assert len(report.incidents.as_dicts()) == len(report.incidents)


# ---------------------------------------------------------------------------
# guards and the injector
# ---------------------------------------------------------------------------


def test_check_logits_flags_only_active_corrupt_slots():
    logits = np.zeros((4, 8), np.float32)
    logits[0, 3] = np.nan
    logits[1, 1] = np.inf
    logits[2, 0] = 1e9  # overflow
    active = np.array([True, True, True, False])
    assert check_logits(logits, active, overflow=1e6) == {0: "nan", 1: "inf", 2: "overflow"}
    assert check_logits(logits, np.zeros(4, bool)) == {}
    assert check_logits(None, active) == {}


def test_fault_injector_from_rates_is_deterministic():
    a = FaultInjector.from_rates(7, n_steps=200, batch_size=4,
                                 rates={"nan_logits": 0.1, "kv_poison": 0.05})
    b = FaultInjector.from_rates(7, n_steps=200, batch_size=4,
                                 rates={"nan_logits": 0.1, "kv_poison": 0.05})
    assert a.events == b.events and len(a.events) > 5
    assert set(SLOT_FAULTS) < set(FAULT_KINDS)
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultInjector.from_rates(0, 10, 2, rates={"bitrot": 1.0})
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultEvent(step=0, kind="bitrot")


def test_cli_frontend_serves_without_loss(capsys):
    report = serve_cli.run_frontend(
        arch="qwen2-1.5b", smoke=True, gemm="pallas_paired", attn="pallas_fused",
        device="cpu", arrival_rate=20, horizon=0.3, max_seq=32,
        inject="nan_logits:0.05,kv_poison:0.05")
    assert report.lost() == [] and report.summary()["n_requests"] >= 1
    out = capsys.readouterr().out
    assert "[serve] front end:" in out and '"lost": 0' in out
    assert serve_cli._parse_fault_rates("nan_logits:0.05, kv_poison:") == {
        "nan_logits": 0.05, "kv_poison": 0.0}
