"""The port's serving engine: token parity with the JAX engine, and the slot
lifecycle.

Parity: fig8's mixed-length batch (prompts of 5 and 11 tokens, batch 2,
6 tokens per slot, fp32, the JAX smoke init handed to the port through
``lm_params_from_numpy``) served by the JAX plain engine and by the port's
engines in every schedule at r=0, then a slot refill.  Lifecycle: the
capacity, release, quarantine and refill cases of ``tests/test_serving.py``,
on the port's engine.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import lm as JM
from repro.models.param import unzip
from repro.serving.engine import ServeEngine as JaxEngine
from repro_torch.configs import get_smoke_config
from repro_torch.core.transform import pair_lm_params
from repro_torch.kernels.ref import rel_err
from repro_torch.launch import serve
from repro_torch.models import lm as M
from repro_torch.serving.engine import INACTIVE_TOKEN, CapacityError, ServeEngine

CFG = dataclasses.replace(get_smoke_config("qwen2-1.5b"), dtype="float32")
BASE = dict(q_chunk=16, k_chunk=16)


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return {0: rng.integers(0, vocab, size=(5,)).astype(np.int32),
            1: rng.integers(0, vocab, size=(11,)).astype(np.int32)}


def _refill(vocab):
    return np.random.default_rng(11).integers(0, vocab, size=(6,)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_run():
    """Weights, and the JAX plain engine's tokens and logits: the batch, then
    slot 0 released and refilled while slot 1 decodes on."""
    cfg = dataclasses.replace(jax_smoke_config("qwen2-1.5b"), dtype="float32")
    values = jax.tree.map(np.asarray, unzip(JM.init_lm(cfg, jax.random.key(0)))[0])
    eng = JaxEngine(cfg, values, max_seq=32, batch_size=2,
                    knobs=JM.PerfKnobs(**BASE, remat="none"))
    out = eng.generate(_prompts(cfg.vocab), 6)
    logits = eng.last_logits
    eng.release_slot(0)
    refill = [eng.add_request(0, _refill(cfg.vocab))] + [eng.step().tolist() for _ in range(3)]
    return values, out, logits, refill


@pytest.mark.parametrize("gemm,attn,block_n", [
    ("xla", "xla", 0),
    ("pallas_paired", "xla", 0),
    ("pallas_paired", "pallas_fused", 0),
    ("pallas_paired", "pallas_fused", 1),
    ("pallas_paired", "pallas_fused", 16),
])
def test_token_parity_with_jax_engine(jax_run, gemm, attn, block_n):
    values, want, want_logits, want_refill = jax_run
    model = M.lm_params_from_numpy(values, CFG, device="cpu")
    eng = ServeEngine(CFG, model, max_seq=32, batch_size=2,
                      knobs=M.PerfKnobs(**BASE, gemm=gemm, attn=attn, pair_block_n=block_n))
    assert (eng.pair_report is not None) == (gemm == "pallas_paired")
    assert eng.generate(_prompts(CFG.vocab), 6) == want
    assert rel_err(eng.last_logits, want_logits) <= 1e-5
    eng.release_slot(0)
    got = [eng.add_request(0, _refill(CFG.vocab))] + [eng.step().tolist() for _ in range(3)]
    assert got == want_refill


def test_engine_keeps_given_pairing():
    """A model that already carries metadata is served as it is."""
    model = M.init_lm(CFG, 0, device="cpu")
    paired, _ = pair_lm_params(model, 0.0, mode="column_blocked", block_n=16)
    knobs = M.PerfKnobs(**BASE, gemm="pallas_paired", attn="pallas_fused", pair_block_n=16)
    eng = ServeEngine(CFG, paired, max_seq=32, batch_size=2, knobs=knobs)
    assert eng.pair_report is None
    assert eng.model.layers[0].attn.pairing["wq"] is paired.layers[0].attn.pairing["wq"]
    plain = ServeEngine(CFG, model, max_seq=32, batch_size=2, knobs=M.PerfKnobs(**BASE))
    assert eng.generate(_prompts(CFG.vocab), 4) == plain.generate(_prompts(CFG.vocab), 4)


def _mini_engine(max_seq=8, batch_size=2, seed=5, **knob_kw):
    model = M.init_lm(CFG, seed, device="cpu")
    return model, ServeEngine(CFG, model, max_seq=max_seq, batch_size=batch_size,
                              knobs=M.PerfKnobs(**BASE, **knob_kw))


def _rand(n, seed):
    return np.random.default_rng(seed).integers(0, CFG.vocab, size=(n,)).astype(np.int32)


def test_add_request_validates_capacity():
    _, eng = _mini_engine(max_seq=8)
    ok = _rand(4, 0)
    with pytest.raises(CapacityError, match="prompt length 8"):
        eng.add_request(0, _rand(8, 1))
    with pytest.raises(CapacityError, match="empty prompt"):
        eng.add_request(0, ok[:0])
    with pytest.raises(CapacityError, match="out of range"):
        eng.add_request(2, ok)
    eng.add_request(0, ok)
    with pytest.raises(CapacityError, match="still active"):
        eng.add_request(0, ok)
    assert isinstance(CapacityError("x"), ValueError)


def test_step_raises_at_max_seq():
    _, eng = _mini_engine(max_seq=6)
    eng.add_request(0, _rand(4, 1))
    eng.step()  # writes at pos 4
    eng.step()  # writes at pos 5 == max_seq - 1
    with pytest.raises(CapacityError, match="no cache rows left"):
        eng.step()


def test_release_slot_stops_emission_and_scrubs_cache():
    _, eng = _mini_engine(max_seq=16)
    eng.add_request(0, _rand(3, 2))
    eng.add_request(1, _rand(5, 3))
    eng.step()
    eng.release_slot(0)
    for name, t in eng.cache.items():
        assert not t[:, 0].any(), f"cache {name!r} kept stale rows after release"
    nxt = eng.step()
    assert nxt[0] == INACTIVE_TOKEN and 0 <= nxt[1] < CFG.vocab
    assert eng.pos[0] == 0


def test_quarantined_slot_refuses_admission_until_cleared():
    _, eng = _mini_engine(max_seq=16)
    prompt = _rand(4, 3)
    eng.add_request(0, prompt)
    eng.quarantine_slot(0)
    assert eng.free_slots() == [1]
    with pytest.raises(CapacityError, match="quarantined"):
        eng.add_request(0, prompt)
    eng.clear_quarantine(0)
    assert eng.free_slots() == [0, 1]
    eng.add_request(0, prompt)


@pytest.mark.parametrize("knob_kw", [{}, {"gemm": "pallas_paired"},
                                     {"gemm": "pallas_paired", "attn": "pallas_fused",
                                      "pair_block_n": 16}])
def test_quarantine_then_refill_leaks_no_stale_state(knob_kw):
    """A quarantined-then-refilled slot gives exactly a fresh engine's tokens."""
    model, eng = _mini_engine(max_seq=24, seed=7, **knob_kw)
    eng.add_request(0, _rand(9, 11))
    eng.add_request(1, _rand(5, 12))  # keeps decoding across the episode
    for _ in range(2):
        eng.step()
    eng.quarantine_slot(0)
    eng.clear_quarantine(0)
    refill = _rand(6, 13)
    got = [eng.add_request(0, refill)] + [int(eng.step()[0]) for _ in range(3)]
    fresh = ServeEngine(CFG, model, max_seq=24, batch_size=2, knobs=eng.knobs)
    assert got == fresh.generate({0: refill}, n_steps=4)[0]


def test_two_slot_batch_decodes_independently():
    model, eng = _mini_engine(max_seq=32, seed=1)
    pa, pb = _rand(5, 1), _rand(9, 2)
    outs = eng.generate({0: pa, 1: pb}, n_steps=4)
    alone = ServeEngine(CFG, model, max_seq=32, batch_size=2, knobs=eng.knobs)
    assert outs[0] == alone.generate({0: pa}, n_steps=4)[0]


def test_force_token_feeds_the_next_step():
    _, eng = _mini_engine(max_seq=16)
    _, ref = _mini_engine(max_seq=16)
    for e in (eng, ref):
        e.add_request(0, _rand(4, 5))
    eng.force_token(0, 17)
    ref.tokens[0, 0] = 17
    np.testing.assert_array_equal(eng.step(), ref.step())


def test_serve_driver_on_cpu(capsys):
    """The launcher end to end on the CPU, smoke config, paired and fused."""
    serve.main(["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu", "--batch", "2",
                "--steps", "3", "--max-seq", "32", "--gemm", "pallas_paired",
                "--attn", "pallas_fused", "--pair-block-n", "16", "--pair-rounding", "0.05"])
    out = capsys.readouterr().out
    assert "paired-kernel LM path (column_blocked, block_n=16, rounding 0.05)" in out
    assert "slot 0: prompt 8 toks" in out and "slot 1: prompt 12 toks" in out
    assert "tokens in" in out
