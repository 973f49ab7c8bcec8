"""The port's Table I and Fig. 8 (LeNet parts) against the JAX package's.

On the reference's trained LeNet (the ``trained_lenet`` fixture), carried
across with ``lenet_params_from_numpy``, the port's benchmark pieces give
the reference's numbers: ``paired_lenet``'s folded weights bit for bit and
its op counts at every rounding; Table I's rows and kernel ledgers;
``measured_conv_path``'s ledgers (and r = 0 within 1e-5 of the unpaired
conv on both sides; the reference's Pallas kernel in interpret mode);
``pairing_block_sweep``'s points; accuracy on the folded weights within
one image of 512.  The pieces are compared, not the reference's
``table1.run``, which raises on its spectrum-ordering assert on these
weights.  Then the port's own ``table1.run``, ``fig8.run`` and the example
end to end on the CPU, on a small port-trained model.
"""
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from benchmarks import fig8 as j_fig8
from repro.core import pairing as j_pairing
from repro.core.transform import build_conv_pairings as j_build
from repro.models import lenet as j_lenet
from repro_torch import analysis
from repro_torch.benchmarks import common, fig8, table1
from repro_torch.core.transform import build_conv_pairings
from repro_torch.models.lenet import (
    LENET_CONV_POSITIONS,
    lenet_accuracy,
    lenet_apply,
    lenet_params_from_numpy,
)
from repro_torch.train import lenet_trainer

ROOT = Path(__file__).resolve().parent.parent
MEASURED = [("structured", 0), ("column_blocked", 4), ("column_blocked", 1)]


@pytest.fixture(scope="module")
def carried(trained_lenet):
    params, test_x, test_y, info = trained_lenet
    j_params = jax.tree_util.tree_map(np.asarray, params)
    return j_params, lenet_params_from_numpy(j_params, device="cpu"), test_x, test_y, info


@pytest.fixture(autouse=True)
def results_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(common, "RESULTS_DIR", tmp_path / "results")
    return tmp_path / "results"


@pytest.mark.parametrize("r", fig8.ROUNDINGS)
def test_paired_lenet_matches_reference(carried, r):
    j_params, t_params, *_ = carried
    j_new, j_ops = j_fig8.paired_lenet(j_params, r)
    t_new, t_ops = fig8.paired_lenet(t_params, r)
    for name in j_new:
        np.testing.assert_array_equal(t_new[name]["w"].numpy(), np.asarray(j_new[name]["w"]))
        np.testing.assert_array_equal(t_new[name]["b"].numpy(), np.asarray(j_new[name]["b"]))
    assert (t_ops.mults, t_ops.adds, t_ops.subs) == (j_ops.mults, j_ops.adds, j_ops.subs)


def _j_ledger(arts):
    """The reference table1's ``measured_ledger`` on its own artifacts."""
    counts = {n: a.measured_op_counts() for n, a in arts.items()}
    return {
        "per_layer": {n: {"n_pairs": arts[n].n_pairs, **c} for n, c in counts.items()},
        "subs_per_image": sum(c["subs_executed"] for c in counts.values()),
        "lanes_saved": sum(c["lanes_saved"] for c in counts.values()),
    }


@pytest.fixture(scope="module")
def port_table1(carried, tmp_path_factory):
    _, t_params, test_x, test_y, info = carried
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(common, "RESULTS_DIR", tmp_path_factory.mktemp("results"))
        return table1.run(trained=(t_params, test_x, test_y, info))


@pytest.mark.parametrize("r", table1.ROUNDINGS)
def test_table1_matches_reference(carried, port_table1, r):
    """One Table I row and its kernel ledgers (structured and every block
    size) equal to the reference's pieces, and the spectrum's ordering
    reported as the reference would assert it."""
    j_params = carried[0]
    mats = [np.asarray(j_params[n]["w"], np.float64).reshape(-1, s[-1])
            for n, (s, _) in j_lenet.LENET_CONV_SHAPES.items()]
    (analytic,) = j_pairing.sweep_rounding(mats, list(j_lenet.LENET_CONV_POSITIONS.values()), [r])
    want = _j_ledger(j_build(j_params, r, positions=j_lenet.LENET_CONV_POSITIONS))
    want["blocked"] = {
        bn: _j_ledger(j_build(j_params, r, positions=j_lenet.LENET_CONV_POSITIONS,
                              mode="column_blocked", block_n=bn))
        for bn in table1.KERNEL_BLOCK_NS
    }
    assert port_table1["kernel_measured"][r] == want
    row = next(row for row in port_table1["rows"] if row["rounding"] == r)
    assert {k: row[k] for k in analytic} == analytic
    assert (row["kernel_subs"], row["kernel_lanes_saved"]) == (
        want["subs_per_image"], want["lanes_saved"])
    for bn in table1.KERNEL_BLOCK_NS:
        assert row[f"b{bn}_lanes_saved"] == want["blocked"][bn]["lanes_saved"]
    saved = [want["lanes_saved"]] + [want["blocked"][bn]["lanes_saved"] for bn in (8, 4, 2, 1)]
    assert port_table1["spectrum_ordered"][r] == all(
        a <= b for a, b in zip(saved, saved[1:], strict=False))


@pytest.mark.parametrize("r", [0.0, 0.05])
@pytest.mark.parametrize("mode,block_n", MEASURED)
def test_measured_conv_path_matches_reference(carried, mode, block_n, r):
    """Per-layer and total ledgers equal; at r = 0 both paths within 1e-5
    of their unpaired conv (the reference's kernel in interpret mode)."""
    j_params, t_params, test_x, *_ = carried
    want = j_fig8.measured_conv_path(j_params, test_x, r, batch=4, mode=mode, block_n=block_n)
    got = fig8.measured_conv_path(t_params, test_x, r, batch=4, mode=mode, block_n=block_n)
    assert got["per_layer"] == want["per_layer"]
    for key in ("total_baseline_lanes", "total_paired_lanes", "total_subs_per_image"):
        assert got[key] == want[key]
    assert got["k1_launches"] == 0  # the plain version: no kernel on the CPU
    if r == 0:
        assert want["rel_err_vs_xla"] <= 1e-5
        assert got["rel_err_vs_conv2d"] <= 1e-5


@pytest.mark.parametrize("r", [0.01, 0.05, 0.3])
def test_pairing_block_sweep_matches_reference(carried, r):
    j_params, t_params, *_ = carried
    assert fig8.pairing_block_sweep(t_params, r) == j_fig8.pairing_block_sweep(j_params, r)


@pytest.mark.parametrize("r", fig8.QUICK_ROUNDINGS)
def test_folded_accuracy_matches_reference(carried, r):
    """F.conv2d on the folded weights scores the reference's XLA conv on
    them, within one image of 512."""
    j_params, t_params, test_x, test_y, _ = carried
    x, y = test_x[:512], test_y[:512]
    want = j_lenet.lenet_accuracy(j_fig8.paired_lenet(j_params, r)[0], x, y)
    got = lenet_accuracy(fig8.paired_lenet(t_params, r)[0], x, y)
    assert abs(got - want) * 512 <= 1


@pytest.mark.parametrize("mode,block_n", [("structured", 0), ("column_blocked", 4)])
@pytest.mark.parametrize("conv_impl,fuse_pool,want", [
    ("torch", False, {"k1_calls": 0, "pool_ops": 2}),
    ("paired", False, {"k1_calls": 3, "pool_ops": 2}),
    ("paired", True, {"k1_calls": 3, "pool_ops": 0}),
])
def test_schedule_counts(carried, mode, block_n, conv_impl, fuse_pool, want):
    """The counterpart of the reference's schedule rules: one K1 call a
    conv layer; the pools leave the path only when fused into K1."""
    _, t_params, test_x, *_ = carried
    arts = build_conv_pairings(t_params, 0.0, positions=LENET_CONV_POSITIONS, mode=mode,
                               block_n=block_n)
    kw = {} if conv_impl == "torch" else dict(paired=arts, fuse_pool=fuse_pool)
    with analysis.counting() as counts:
        lenet_apply(t_params, torch.as_tensor(test_x[:2], dtype=torch.float32),
                    conv_impl=conv_impl, **kw)
    assert counts == {**want, "k1_launches": 0}


def test_counting_leaves_nothing_behind(carried):
    """Outside the block nothing is counted, and the tool id is free again."""
    _, t_params, test_x, *_ = carried
    with analysis.counting() as counts:
        pass
    lenet_apply(t_params, torch.as_tensor(test_x[:2], dtype=torch.float32))
    assert dict(counts) == {"k1_calls": 0, "pool_ops": 0, "k1_launches": 0}
    with analysis.counting() as again:
        lenet_apply(t_params, torch.as_tensor(test_x[:2], dtype=torch.float32))
    assert again["pool_ops"] == 2


@pytest.fixture(scope="module")
def small_trained():
    """A port-trained LeNet at a small budget, on the CPU."""
    return lenet_trainer.get_trained_lenet(epochs=1, train_n=1024, test_n=256, cache=False,
                                           device="cpu")


def test_table1_run_end_to_end(small_trained, results_dir):
    out = table1.run(quick=True, trained=small_trained)
    assert [row["rounding"] for row in out["rows"]] == table1.QUICK_ROUNDINGS
    assert all(row["adds"] + row["subs"] == 405600 for row in out["rows"])
    assert set(out["spectrum_ordered"]) == set(table1.QUICK_ROUNDINGS)
    assert (results_dir / "torch_table1.json").exists()


def test_fig8_run_end_to_end(small_trained, results_dir):
    out = fig8.run(quick=True, trained=small_trained)
    assert [row["rounding"] for row in out["rows"]] == fig8.QUICK_ROUNDINGS
    assert out["rows"][0]["acc_loss_%"] == 0.0  # r = 0 folds nothing
    assert out["headline"]["rounding"] == 0.05 and out["paper_headline"]["power_saving_%"] == 32.03
    assert out["device"] == "cpu"
    assert out["measured_conv_path"]["r0"]["rel_err_vs_conv2d"] <= 1e-5
    fused = out["fused_pool_path"]["variants"]
    assert fused["paired_fused"]["pool_ops"] == 0 and fused["paired_fused"]["k1_calls"] == 3
    assert fused["paired_unfused"]["pool_ops"] == 2
    assert all(v["ms"] is None for v in fused.values())  # no device time on the CPU
    assert set(out["kernel_plans"]) == {"conv1", "conv2", "conv3"}
    assert (results_dir / "torch_fig8.json").exists()


def test_example_runs_on_the_cpu(small_trained, tmp_path, monkeypatch, capsys):
    """``examples/lenet_mnist_torch.py --quick --device cpu``, its trainer
    reading a cache file at the default budget's name."""
    params = small_trained[0]
    monkeypatch.setattr(lenet_trainer, "CACHE", tmp_path)
    np.savez(tmp_path / "lenet_torch_e3_n20000_s0.npz",
             **{f"{k}_{f}": v[f].numpy() for k, v in params.items() for f in ("w", "b")})
    spec = importlib.util.spec_from_file_location(
        "lenet_mnist_torch", ROOT / "examples" / "lenet_mnist_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    assert example.main(["--quick", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Table I" in out and "Fig. 8" in out and "cached" in out
