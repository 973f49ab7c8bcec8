"""The port's LM training steps, CLI and the LM parts of Fig. 8 against the
JAX package's.

* 16 AdamW steps of ``build_train_step`` from the JAX package's smoke init,
  batches of its token stream, under ``gemm="xla"`` and ``"pallas"``
  (JAX's Pallas kernels in interpret mode), against the JAX
  ``build_train_step`` jitted on a one-device mesh: every step's loss
  within 1e-5 relative, the weights after them within 1e-4;
* the CLI (``repro_torch.launch.train``): the JAX CLI's log lines at
  ``--smoke``, every ``--gemm`` giving the plain path's losses at r = 0
  (bf16 smoke config: within 2e-3), ``--paired-rounding`` folding the
  weights, and a run killed after its checkpoint resuming to the straight
  run's losses, to the bit; the example ``examples/lm_train_torch.py``;
* Fig. 8's LM parts: the pair rates of the JAX-trained tiny LM's weights
  equal to the JAX package's pairing of them, and the port's decode bench
  (r = 0 token parity, 7 and 5 K1/K2 calls a decode layer) on them.
"""
import dataclasses
import functools
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import fig8 as j_fig8
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import transform as j_transform
from repro.data.tokens import token_batches as j_token_batches
from repro.launch.steps import build_train_step as j_build_train_step
from repro.models import lm as JM
from repro.models.param import unzip
from repro.parallel.rules import rules_for
from repro.parallel.sharding import make_mesh_compat, set_mesh_compat
from repro.train import optimizer as j_opt
from repro_torch.benchmarks import fig8 as t_fig8
from repro_torch.configs import get_smoke_config
from repro_torch.launch import train as t_train
from repro_torch.launch.steps import build_train_step
from repro_torch.models import lm as TM
from repro_torch.train import optimizer as t_opt

LOSS_RTOL = 1e-5  # every step's loss
PARAM_ATOL = 1e-4  # the weights after 16 steps (the LeNet loop test's)
STEPS = 16


@functools.cache
def _jax_run(gemm: str):
    """16 steps of the JAX package's build_train_step: (losses, params)."""
    cfg = dataclasses.replace(jax_smoke_config("qwen2-1.5b"), dtype="float32")
    params = unzip(JM.init_lm(cfg, jax.random.key(0)))[0]
    init = jax.tree.map(np.asarray, params)
    mesh = make_mesh_compat((1, 1), ("data", "model"))
    opt = j_opt.adamw(j_opt.cosine_schedule(3e-3, STEPS, warmup_steps=2))
    knobs = JM.PerfKnobs(q_chunk=16, k_chunk=16, gemm=gemm)
    step = jax.jit(j_build_train_step(cfg, opt, knobs, mesh, rules_for(cfg, "train", mesh)))
    opt_state = opt.init(params)
    losses = []
    data = j_token_batches(4, 16, cfg.vocab, seed=1)
    with set_mesh_compat(mesh):
        for i in range(STEPS):
            tok, lab = next(data)
            params, opt_state, metrics = step(params, opt_state, jnp.int32(i),
                                              {"tokens": jnp.asarray(tok),
                                               "labels": jnp.asarray(lab)})
            losses.append(float(metrics["loss"]))
    return init, losses, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("gemm", ["xla", "pallas"])
def test_16_adamw_steps_match_jax(gemm):
    init, want_losses, want_params = _jax_run(gemm)
    cfg = dataclasses.replace(get_smoke_config("qwen2-1.5b"), dtype="float32")
    model = TM.lm_params_from_numpy(init, cfg, device="cpu")
    step = build_train_step(cfg, t_opt.adamw(t_opt.cosine_schedule(3e-3, STEPS, warmup_steps=2)),
                            TM.PerfKnobs(q_chunk=16, k_chunk=16, gemm=gemm))
    opt_state = step.init(model)
    from repro_torch.data.tokens import token_batches

    data = token_batches(4, 16, cfg.vocab, seed=1)
    losses = []
    for i in range(STEPS):
        tok, lab = (torch.as_tensor(a, dtype=torch.int64) for a in next(data))
        losses.append(float(step(model, opt_state, i, {"tokens": tok, "labels": lab})["loss"]))
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    assert losses[-1] < losses[0]
    got = jax.tree.map(lambda t: t.numpy(), TM.lm_value_tree(model))
    for (path, w), (_, g) in zip(jax.tree_util.tree_flatten_with_path(want_params)[0],
                                 jax.tree_util.tree_flatten_with_path(got)[0], strict=True):
        np.testing.assert_allclose(g, w, rtol=0, atol=PARAM_ATOL,
                                   err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

LOG_STEP = re.compile(r"^\[train\] step (\d+) loss (\d+\.\d{4}) xent (\d+\.\d{4}) "
                      r"\(\d+\.\d{2} it/s\)$")
LOG_DONE = re.compile(r"^\[train\] done: (\d+) steps in \d+\.\ds, final loss (\d+\.\d{4})$")


def _cli(capsys, *args) -> tuple[list[float], list[str]]:
    t_train.main(["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu", "--batch", "2",
                  "--seq", "16", "--log-every", "1", *args])
    lines = capsys.readouterr().out.splitlines()
    losses = [float(m.group(2)) for m in map(LOG_STEP.match, lines) if m]
    return losses, lines


def test_cli_log_lines(capsys):
    """The JAX CLI's lines: ``[train] step N loss … xent …`` every
    ``--log-every`` steps, and ``[train] done: …``."""
    losses, lines = _cli(capsys, "--steps", "3", "--gemm", "pallas_paired")
    steps = [int(m.group(1)) for m in map(LOG_STEP.match, lines) if m]
    assert steps == [1, 2, 3] and len(losses) == 3
    done = LOG_DONE.match(lines[-1])
    assert done and int(done.group(1)) == 3 and float(done.group(2)) == losses[-1]
    assert any(line.startswith("[train] paired-kernel GEMMs (structured") for line in lines)


def test_cli_gemm_policies_agree_at_r0(capsys):
    """The smoke config computes in bf16: K1's plain versions round once,
    torch.matmul too, so the losses agree within bf16's noise (2e-3
    relative), while the fp32 parity is held to 1e-5 elsewhere."""
    base, _ = _cli(capsys, "--steps", "2")
    for gemm in ("pallas", "pallas_paired"):
        got, _ = _cli(capsys, "--steps", "2", "--gemm", gemm)
        np.testing.assert_allclose(got, base, rtol=2e-3)


def test_cli_paired_rounding_folds_the_weights(capsys):
    """``--paired-rounding`` trains ``core.transform.fold_lm_params`` of the
    seeded model (each decoder matrix folded per column; the JAX CLI's
    ``pair_model_params`` pairs the wrong axes of the LM tree): the CLI's
    line reports its pairs, and the model a run trains (one step at
    learning rate 0) holds the folded weights."""
    from repro_torch.core.transform import fold_lm_params

    losses, lines = _cli(capsys, "--steps", "1", "--paired-rounding", "0.05")
    (line,) = [x for x in lines if x.startswith("[train] paired ") and "weight pairs" in x]
    n_pairs = int(line.split()[2])
    folded, report = fold_lm_params(TM.init_lm(get_smoke_config("qwen2-1.5b"), 0, device="cpu"),
                                    0.05)
    assert n_pairs == report.total_pairs > 0 and "power_saving" in line and len(losses) == 1
    rec = t_train.train(arch="qwen2-1.5b", smoke=True, steps=1, batch=2, seq=16, lr=0.0,
                        paired_rounding=0.05, device="cpu", log_every=0)
    want = jax.tree_util.tree_flatten_with_path(TM.lm_value_tree(folded))[0]
    got = jax.tree_util.tree_flatten_with_path(TM.lm_value_tree(rec["model"]))[0]
    for (path, w), (_, g) in zip(want, got, strict=True):
        assert torch.equal(g.detach(), w), jax.tree_util.keystr(path)


def test_cli_resumes_from_its_checkpoint(capsys, tmp_path):
    """A run checkpointing every 2 steps, its newest checkpoint removed (a
    run killed after step 2), restarted: steps 3–4 give the straight run's
    losses, to the bit."""
    ckpt = tmp_path / "ckpt"
    straight, _ = _cli(capsys, "--steps", "4", "--gemm", "pallas_paired",
                       "--ckpt-dir", str(ckpt), "--ckpt-every", "2")
    assert sorted(p.name for p in ckpt.iterdir()) == ["step_0000000002", "step_0000000004"]
    shutil.rmtree(ckpt / "step_0000000004")
    resumed, lines = _cli(capsys, "--steps", "4", "--gemm", "pallas_paired",
                          "--ckpt-dir", str(ckpt), "--ckpt-every", "2")
    assert "[train] resumed from step 2" in lines
    assert resumed == straight[2:]


def test_train_record():
    rec = t_train.train(arch="qwen2-1.5b", smoke=True, steps=2, batch=2, seq=8, device="cpu",
                        gemm="pallas", log_every=0)
    assert rec["start"] == 0 and len(rec["history"]) == len(rec["step_ms"]) == 2
    assert all(np.isfinite(v) for h in rec["history"] for v in h.values())
    assert rec["knobs"].gemm == "pallas" and rec["pairing_s"] == 0.0
    assert all(p.requires_grad for p in rec["model"].parameters())


# ---------------------------------------------------------------------------
# Fig. 8's LM parts
# ---------------------------------------------------------------------------


@functools.cache
def _jax_trained():
    """The JAX package's trained tiny LM (its fig8 recipe, 200 steps)."""
    cfg = dataclasses.replace(jax_smoke_config("qwen2-1.5b"), dtype="float32")
    params, losses = j_fig8._train_tiny_lm(cfg, 200)
    return cfg, jax.tree.map(np.asarray, params), losses


def test_fig8_pair_rates_of_the_jax_trained_lm():
    """The port pairs the JAX-trained weights at r = 0.05 as the JAX package
    does: per mode, the baseline lanes and the lanes saved equal."""
    cfg, params, _ = _jax_trained()
    tcfg = dataclasses.replace(get_smoke_config("qwen2-1.5b"), dtype="float32")
    got = t_fig8.lm_pair_rates(TM.lm_params_from_numpy(params, tcfg, device="cpu"))
    for tag, kw in (("structured", dict(mode="structured")),
                    ("block_4", dict(mode="column_blocked", block_n=4)),
                    ("per_column", dict(mode="per_column"))):
        _, rep = j_transform.pair_lm_params(params, j_fig8.LM_HEADLINE_ROUNDING, **kw)
        assert got[tag]["baseline_lanes_per_token"] == rep.total_weights
        assert got[tag]["lanes_saved_per_token"] == rep.total_pairs
    assert got["per_column"]["lanes_saved_per_token"] > got["block_4"]["lanes_saved_per_token"]


def test_fig8_lm_decode_bench_on_the_jax_trained_lm():
    cfg, params, losses = _jax_trained()
    tcfg = dataclasses.replace(get_smoke_config("qwen2-1.5b"), dtype="float32")
    model = TM.lm_params_from_numpy(params, tcfg, device="cpu")
    out = t_fig8.lm_paired_decode_bench(quick=True, trained=(model, losses))
    assert out["parity"]["token_identical"] and out["parity"]["fused_attn_token_identical"]
    assert out["launch_audit"]["launches_per_layer"] == {"paired": 7, "fused": 5}
    assert out["ledger"]["rates"]["per_column"]["pair_rate"] > 0
    assert out["train_loss"]["last_10_mean"] < out["train_loss"]["first_10_mean"]


def test_fig8_trains_the_tiny_lm_itself():
    """The port's own recipe (seeded init of its own, the token stream):
    the loss falls over 200 steps, as the JAX recipe's does."""
    cfg = dataclasses.replace(get_smoke_config("qwen2-1.5b"), dtype="float32")
    model, losses = t_fig8._train_tiny_lm(cfg, 200, device="cpu")
    assert len(losses) == 200 and np.mean(losses[-10:]) < np.mean(losses[:10])
    assert not any(p.requires_grad for p in model.parameters())


def test_lm_train_example_runs(monkeypatch, capsys):
    """``examples/lm_train_torch.py`` (the ~100M config) for two short steps
    on the CPU under K1's dense form."""
    import runpy
    from pathlib import Path

    example = Path(__file__).resolve().parents[1] / "examples" / "lm_train_torch.py"
    monkeypatch.setattr("sys.argv", [str(example), "--steps", "2", "--batch", "1", "--seq", "8",
                                     "--gemm", "pallas", "--device", "cpu"])
    runpy.run_path(str(example), run_name="__main__")
    out = capsys.readouterr().out
    assert "[lm_train] qwen2-100m" in out and "[lm_train] loss" in out
