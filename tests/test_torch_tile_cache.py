"""K1's tile cache, plan check and measured plan search
(``repro_torch.kernels.tuning``), case for case beside the JAX package's
``tests/test_tile_cache.py``.

The keys are the JAX ``cache_key`` strings of the same problems; the cache
file round-trips, and a version mismatch, an unreadable file, an entry
without a plan's fields or a file the JAX package wrote loads as empty; an
explicit block_k beats the cache, which beats the heuristic; installs nest
and restore; the candidates of a problem hold the heuristic plan, fit the
card and are distinct; the autotuner keeps the fastest; a launch's plan is
the cached one, and a cached plan the kernel would refuse raises naming its
key.  No JAX kernel runs: the JAX side is its key and its cache file.
"""
import dataclasses
import importlib
import json

import pytest
import torch

from repro_torch.kernels import ops, tuning
from repro_torch.kernels import paired_matmul as pm
from repro_torch.launch.steps import build_prefill_step, build_serve_step, build_train_step
from repro_torch.models import lm as TM

j_tuning = importlib.import_module("repro.kernels.tuning")

# (M, N, P, R, dtype, pool, blocks, residual): LeNet's, qwen2's decode,
# prefill and training rows, the column-blocked and expert-grid layouts
KEY_SWEEP = [
    (100, 16, 20, 110, "float32", "max2", 1, False),
    (196, 16, 30, 90, "", "avg2", 1, True),
    (4, 1536, 690, 156, "bfloat16", "none", 1, True),
    (20, 8960, 766, 70, "bfloat16", "none", 1, False),
    (1024, 1536, 4478, 316, "bfloat16", "none", 1, True),
    (1024, 256, 0, 1536, "bfloat16", "none", 1, False),
    (4, 64, 300, 100, "float32", "none", 24, True),
    (2, 1024, 0, 2048, "bfloat16", "none", 64, False),
    (501, 1, 11, 3, "float32", "max2", 6, False),
    (7, 0, 0, 0, "", "none", 3, False),
]
KMAT_LAYOUTS = [  # (M, P, R, n_blocks, bn, pool, itemsize)
    (4, 690, 156, 1, 1536, "none", 2),
    (20, 4478, 316, 1, 1536, "none", 2),
    (1024, 767, 62, 1, 1536, "none", 2),
    (1024, 4478, 316, 1, 1536, "none", 2),
    (4, 1018, 12, 64, 1024, "none", 2),
    (160, 1018, 12, 64, 1024, "none", 2),
    (515, 9, 7, 1, 6, "max2", 4),
    (300, 0, 0, 1, 16, "avg2", 4),
    (1, 3, 2, 1, 7, "none", 4),
    (4, 800, 0, 1, 320, "none", 2),
    (2, 0, 1536, 24, 64, "none", 4),
]


def _operands(M, P, R, n_blocks, bn, pool, itemsize):
    dt = torch.bfloat16 if itemsize == 2 else torch.float32
    lead = (n_blocks,) if n_blocks > 1 else ()
    win = (4,) if pool != "none" else ()
    return (torch.zeros(*lead, *win, M, 2 * P + R, dtype=dt),
            torch.zeros(*lead, P, bn, dtype=dt), torch.zeros(*lead, R, bn, dtype=dt))


def _window(pool):
    return tuning.POOL_WINDOWS[pool]


@pytest.mark.parametrize("M,N,P,R,dtype,pool,blocks,residual", KEY_SWEEP)
def test_cache_key_is_the_jax_key(M, N, P, R, dtype, pool, blocks, residual):
    kw = dict(dtype=dtype, dtype_bytes=4 if dtype == "float32" else 2, pool=pool,
              blocks=blocks, residual=residual)
    assert tuning.cache_key(M, N, P, R, **kw) == j_tuning.cache_key(M, N, P, R, **kw)


@pytest.mark.parametrize("layout", KMAT_LAYOUTS)
def test_launch_key_names_the_jax_problem(layout):
    """A launch's key is the JAX package's ``cache_key`` of the call its
    ``kernels.ops`` makes: (M, N, P, R) of the structured GEMM, the
    per-block (bn, P, R) and ``blocks`` of the blocked one; ``key_problem``
    reads the launch back."""
    M, P, R, B, bn, pool, item = layout
    x, kmat, w_res = _operands(*layout)
    want = j_tuning.cache_key(M, bn, P, R, dtype="bfloat16" if item == 2 else "float32",
                              dtype_bytes=item, pool=pool, blocks=B, residual=True)
    assert pm.launch_key(x, kmat, w_res, pool, residual=True) == want
    assert tuning.key_problem(want) == (*layout, True)  # and back


def test_tile_cache_round_trip_and_version(tmp_path):
    path = tmp_path / "tc.json"
    key = tuning.cache_key(100, 16, 20, 110, dtype="float32", pool="max2")
    assert key == "M100-N16-K150-float32-p20r110-max2"
    c = tuning.TileCache(path)
    assert c.get(key) is None and len(c) == 0
    p = tuning.plan(100, 20, 110, 1, 16, 4, 4)
    c.put(key, p, time_s=0.01)
    c.save()
    # a fresh instance (a new process) sees the entry, its provenance too
    c2 = tuning.TileCache(path)
    assert c2.get(key) == p and key in c2
    assert c2.entries[key]["time_s"] == 0.01 and c2.entries[key]["source"] == "measured"
    raw = json.loads(path.read_text())
    assert raw["version"] == tuning.CACHE_VERSION
    # a version mismatch loads as empty: a stale schema is never trusted
    raw["version"] = 99
    path.write_text(json.dumps(raw))
    assert len(tuning.TileCache(path)) == 0
    # an unreadable file loads as empty
    path.write_text("{not json")
    assert len(tuning.TileCache(path)) == 0


@pytest.mark.parametrize("entry", [
    {"block_m": 50, "block_n": 16, "block_k": 128},  # a Pallas tile
    {"form": "skinny", "rows": 4, "cols": 256, "tn": 8, "splits": 1, "lanes": 0, "subtiles": 1},
    {"form": "wide", "rows": 4, "cols": 256, "tn": 8, "splits": 1, "lanes": 0, "subtiles": 1,
     "stages": 5},
    {"form": "skinny", "rows": 4.0, "cols": 256, "tn": 8, "splits": 1, "lanes": 0,
     "subtiles": 1, "stages": 5},
    [4, 256, 8],
])
def test_malformed_entries_load_as_empty(tmp_path, entry):
    path = tmp_path / "tc.json"
    good = dataclasses.asdict(tuning.plan(4, 690, 156, 1, 1536, 1, 2))
    path.write_text(json.dumps({"version": tuning.CACHE_VERSION,
                                "entries": {"bad": entry, "good": good}}))
    c = tuning.TileCache(path)
    assert sorted(c.entries) == ["good"] and c.get("bad") is None


def test_a_jax_cache_file_supplies_no_plan(tmp_path):
    """The JAX package's TileCache (version 1, Pallas tiles) at the same
    path loads as an empty port cache, key for key."""
    path = tmp_path / "tc.json"
    key = j_tuning.cache_key(4, 1536, 690, 156, dtype="bfloat16")
    jc = j_tuning.TileCache(path)
    jc.put(key, j_tuning.TileConfig(8, 128, 256), time_s=0.01)
    jc.save()
    c = tuning.TileCache(path)
    assert len(c) == 0 and c.get(key) is None
    with tuning.use_tile_cache(c):
        assert tuning.resolve_plan(4, 690, 156, 1, 1536, "none", 2) == tuning.plan(
            4, 690, 156, 1, 1536, 1, 2)


def test_load_tile_cache_refuses_a_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError, match="no tile cache"):
        tuning.load_tile_cache(tmp_path / "missing.json")
    assert len(tuning.TileCache(tmp_path / "missing.json")) == 0  # the autotuner's start


def _other_plan(layout):
    """A candidate of ``layout`` that is not its heuristic plan."""
    M, P, R, B, bn, pool, item = layout
    cands = tuning.candidate_plans(M, P, R, B, bn, _window(pool), item)
    return cands[0], next(p for p in cands[1:] if p.splits != cands[0].splits)


@pytest.mark.parametrize("layout", KMAT_LAYOUTS[:6])
def test_warm_cache_hit_beats_heuristic(tmp_path, layout):
    """Under an installed cache a launch takes the cached plan of its key;
    another problem (a residual, another pool) misses and takes the
    heuristic; outside the install, the heuristic again."""
    M, P, R, B, bn, pool, item = layout
    heur, cached = _other_plan(layout)
    c = tuning.TileCache(tmp_path / "tc.json")
    c.put(tuning.launch_key(M, P, R, B, bn, pool, item), cached)
    c.save()
    x, kmat, w_res = _operands(*layout)
    with tuning.use_tile_cache(tmp_path / "tc.json"):
        assert pm.launch_plan(x, kmat, w_res, pool) == cached
        assert pm.launch_plan(x, kmat, w_res, pool, residual=True) == heur
    assert tuning.active_tile_cache() is None
    assert pm.launch_plan(x, kmat, w_res, pool) == heur


def test_resolve_plan_explicit_block_k_beats_cache(tmp_path):
    """An explicit block_k wins over the cache: the fewest K-slices of at
    most block_k lanes; one that needs more than a cluster raises."""
    layout = (4, 690, 156, 1, 1536, "none", 2)
    M, P, R, B, bn, pool, item = layout
    heur, cached = _other_plan(layout)
    c = tuning.TileCache(tmp_path / "tc.json")
    c.put(tuning.launch_key(*layout), cached)
    ke = P + R
    with tuning.use_tile_cache(c):
        for block_k in (ke, 400, 212, 106):
            with tuning.use_block_k(block_k):
                p = tuning.resolve_plan(*layout)
            assert p.splits == -(-ke // block_k) and tuning.slice_step(ke, p.splits) <= block_k
            assert (p.form, p.rows, p.tn) == (heur.form, heur.rows, heur.tn)
            assert tuning.refusal(p, M, P, R, B, bn, 1, item) is None
        with tuning.use_block_k(ke // 9), pytest.raises(ValueError, match="block_k"):
            tuning.resolve_plan(*layout)
        assert tuning.resolve_plan(*layout) == cached
    assert tuning.resolve_plan(*layout) == heur


@pytest.mark.parametrize("layout", [(1024, 767, 62, 1, 1536, "none", 2),
                                    (515, 9, 7, 1, 6, "max2", 4)])
def test_block_k_on_the_tall_form(layout):
    """The tall form takes a split contraction at one sub-tile a CTA."""
    M, P, R, B, bn, pool, item = layout
    with tuning.use_block_k(-(-(P + R) // 2)):
        p = tuning.resolve_plan(*layout)
    assert p.form == "tall" and p.splits == 2 and p.subtiles == 1
    assert tuning.refusal(p, M, P, R, B, bn, _window(pool), item) is None


def test_use_tile_cache_nesting(tmp_path):
    a, b = tuning.TileCache(tmp_path / "a.json"), tuning.TileCache(tmp_path / "b.json")
    assert tuning.active_tile_cache() is None and tuning.active_block_k() == 0
    with tuning.use_tile_cache(a) as got_a:
        assert got_a is a and tuning.active_tile_cache() is a
        with tuning.use_tile_cache(b), tuning.use_block_k(64):
            assert tuning.active_tile_cache() is b and tuning.active_block_k() == 64
        assert tuning.active_tile_cache() is a and tuning.active_block_k() == 0
    assert tuning.active_tile_cache() is None


def test_tile_cache_context_installs_the_knobs(tmp_path):
    """``ops.tile_cache_context`` installs ``knobs.tile_cache`` (a missing
    file raises) and ``knobs.block_k``; empty knobs install nothing."""
    path = tmp_path / "tc.json"
    tuning.TileCache(path).save()
    knobs = TM.PerfKnobs(tile_cache=str(path), block_k=128)
    with ops.tile_cache_context(knobs) as cache:
        assert tuning.active_tile_cache() is cache and cache.path == path
        assert tuning.active_block_k() == 128
    assert tuning.active_tile_cache() is None and tuning.active_block_k() == 0
    with ops.tile_cache_context(TM.PerfKnobs()) as cache:
        assert cache is None and tuning.active_tile_cache() is None
    with pytest.raises(FileNotFoundError), ops.tile_cache_context(
            TM.PerfKnobs(tile_cache=str(tmp_path / "none.json"))):
        pass


def test_steps_run_under_the_tile_cache(tmp_path, monkeypatch):
    """The step builders read the cache once and install it (and block_k)
    around each call: prefill, decode and the training step."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.train.optimizer import sgd

    path = tmp_path / "tc.json"
    tuning.TileCache(path).save()
    cfg = dataclasses.replace(get_smoke_config("qwen2-1.5b"), n_layers=1, dtype="float32")
    knobs = TM.PerfKnobs(q_chunk=8, k_chunk=8, tile_cache=str(path), block_k=32)
    seen = []
    real = TM.lm_forward

    def spy(*a, **kw):
        seen.append((tuning.active_tile_cache(), tuning.active_block_k()))
        return real(*a, **kw)

    monkeypatch.setattr(TM, "lm_forward", spy)
    model = TM.init_lm(cfg, 0, device="cpu")
    tokens = torch.zeros((1, 5), dtype=torch.int64)
    prefill = build_prefill_step(cfg, knobs)
    logits, cache = prefill(model, {"tokens": tokens})
    decode = build_serve_step(cfg, knobs)
    real_decode = TM.layer_decode
    monkeypatch.setattr(TM, "layer_decode", lambda *a, **kw: (
        seen.append((tuning.active_tile_cache(), tuning.active_block_k())),
        real_decode(*a, **kw))[1])
    full = TM.init_cache(cfg, 1, 8, device="cpu")
    decode(model, full, {"tokens": tokens[:, :1], "pos": torch.zeros(1, dtype=torch.int64)})
    step = build_train_step(cfg, sgd(0.0), knobs)
    opt = step.init(model)
    monkeypatch.setattr(TM, "_hidden_for_loss", lambda *a, real=TM._hidden_for_loss, **kw: (
        seen.append((tuning.active_tile_cache(), tuning.active_block_k())), real(*a, **kw))[1])
    step(model, opt, 0, {"tokens": tokens, "labels": tokens})
    assert len(seen) == 3 and all(c is not None and c.path == path and k == 32 for c, k in seen)
    assert tuning.active_tile_cache() is None
    assert logits.shape[0] == 1 and set(cache) == {"k", "v"}


@pytest.mark.parametrize("layout", KMAT_LAYOUTS)
def test_candidate_plans_fit_and_hold_the_heuristic(layout):
    M, P, R, B, bn, pool, item = layout
    w = _window(pool)
    cands = tuning.candidate_plans(M, P, R, B, bn, w, item)
    assert cands[0] == tuning.plan(M, P, R, B, bn, w, item)
    assert len(cands) == len(set(cands)) and 1 <= len(cands) <= 25
    assert len({p.form for p in cands}) == 1
    for p in cands:
        assert tuning.refusal(p, M, P, R, B, bn, w, item) is None
        assert p.smem == tuning.plan_smem(p, P, R, w, item) <= tuning.SMEM_PER_BLOCK
        gx, gy = p.grid(M, B, bn)
        assert gy <= tuning.MAX_GRID_Y and gx <= 2**31 - 1
        assert p.splits <= tuning.MAX_CLUSTER


@pytest.mark.parametrize("change,why", [
    (dict(form="wide"), "form"),
    (dict(rows=5), "no skinny instance"),
    (dict(tn=3), "out of range"),
    (dict(splits=9), "K-slices"),
    (dict(cols=96), "column tile"),
    (dict(stages=4), "stages"),
    (dict(subtiles=2), "sub-tile"),
])
def test_refusal_names_what_the_kernel_refuses(change, why):
    layout = (4, 690, 156, 1, 1536, 1, 2)
    p = dataclasses.replace(tuning.plan(*layout), **change)
    assert why in tuning.refusal(p, *layout)


@pytest.mark.parametrize("change,why", [
    (dict(lanes=3), "threads a window-row"),
    (dict(lanes=64), "threads a window-row"),
    (dict(rows=7), "do not fill the threads"),
    (dict(tn=2, cols=2), "no tall instance"),
    (dict(splits=2), "one sub-tile"),
    (dict(stages=0), "stages"),
    (dict(rows=4096), "shared memory"),
])
def test_refusal_of_tall_plans(change, why):
    layout = (1024, 767, 62, 1, 1536, 1, 2)
    p = tuning.plan(*layout)
    assert p.form == "tall" and p.subtiles > 1
    assert why in tuning.refusal(dataclasses.replace(p, **change), *layout)


def test_autotune_persists_winner(tmp_path):
    """autotune_plans measures every candidate through the runner, keeps the
    fastest and writes it through to the cache, where a launch finds it."""
    layout = (4, 690, 156, 1, 1536, "none", 2)
    M, P, R, B, bn, pool, item = layout
    cands = tuning.candidate_plans(M, P, R, B, bn, 1, item)
    fastest = cands[3]
    calls = []

    def runner(plan):
        calls.append(plan)
        if plan != fastest:
            sum(range(20_000))  # host work: the slower plans
        return torch.zeros(1)

    cache = tuning.TileCache(tmp_path / "tc.json")
    best, records = tuning.autotune_plans(runner, *layout, cache=cache, reps=3)
    assert best == fastest and set(calls) == set(cands)
    assert [r["form"] for r in records] == [p.form for p in cands]
    assert records[0]["heuristic"] and not any(r["heuristic"] for r in records[1:])
    assert all(r["time_s"] > 0 for r in records)
    reloaded = tuning.TileCache(cache.path)
    key = tuning.launch_key(*layout)
    assert reloaded.get(key) == fastest and reloaded.entries[key]["time_s"] > 0
    x, kmat, w_res = _operands(*layout)
    with tuning.use_tile_cache(reloaded):
        assert pm.launch_plan(x, kmat, w_res) == fastest


def test_a_refused_cached_plan_raises_naming_its_key(tmp_path):
    """A cached plan K1 would refuse is an error, not a quiet fall back to
    the heuristic: resolve_plan raises naming the key and the reason."""
    layout = (4, 690, 156, 1, 1536, "none", 2)
    key = tuning.launch_key(*layout)
    c = tuning.TileCache(tmp_path / "tc.json")
    c.put(key, dataclasses.replace(tuning.plan(4, 690, 156, 1, 1536, 1, 2), rows=16, tn=8))
    x, kmat, w_res = _operands(*layout)
    with tuning.use_tile_cache(c), pytest.raises(RuntimeError, match=key) as info:
        pm.launch_plan(x, kmat, w_res)
    assert "no skinny instance" in str(info.value)


def test_cached_smem_is_worked_out_again(tmp_path):
    """The cache's ``smem`` is not trusted: the plan's is the planner's model."""
    layout = (4, 690, 156, 1, 1536, "none", 2)
    p = tuning.plan(4, 690, 156, 1, 1536, 1, 2)
    c = tuning.TileCache(tmp_path / "tc.json")
    c.put(tuning.launch_key(*layout), dataclasses.replace(p, smem=1))
    with tuning.use_tile_cache(c):
        assert tuning.resolve_plan(*layout) == p


def test_measure_returns_positive_time():
    t = tuning.measure(lambda: sum(range(100)), reps=2, warmup=1)
    assert t > 0
