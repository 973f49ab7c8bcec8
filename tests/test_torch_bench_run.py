"""The port's benchmark harness (``python -m repro_torch.benchmarks.run``):
the JAX harness's benches in its order, one ``torch_BENCH_<name>.json`` a
bench under the results folder (nothing else written), exit code 1 when a
selected bench fails, argparse's 2 on an unknown bench name, and a raise on
an unknown family."""
import json

import pytest

from benchmarks import run as jax_run
from repro_torch.benchmarks import common, run


@pytest.fixture(autouse=True)
def results_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(common, "RESULTS_DIR", tmp_path / "results")
    return tmp_path / "results"


def test_benches_in_the_jax_harness_order():
    assert [name for name, _, _ in run.BENCHES] == [name for name, _, _ in jax_run.BENCHES]


def test_quick_pairing_rate_lm(results_dir, capsys):
    assert run.main(["--quick", "--only", "pairing_rate_lm", "--device", "cpu"]) == 0
    assert sorted(p.name for p in results_dir.iterdir()) == [
        "torch_BENCH_pairing_rate_lm.json", "torch_pairing_rate_lm.json"]
    rec = json.loads((results_dir / "torch_BENCH_pairing_rate_lm.json").read_text())
    assert (rec["bench"], rec["status"], rec["error"], rec["quick"], rec["device"]) == (
        "pairing_rate_lm", "ok", None, True, "cpu")
    # the plain versions run on the CPU: no kernel launched
    assert rec["kernel_launches"] == {"paired_matmul": 0, "decode_attention": 0,
                                      "flash_attention": 0}
    assert rec["wall_clock_s"] > 0
    assert "1/1 benches succeeded" in capsys.readouterr().out


def test_unknown_bench_is_an_argparse_error(results_dir):
    with pytest.raises(SystemExit) as exc:
        run.main(["--only", "fig9", "--device", "cpu"])
    assert exc.value.code == 2
    assert not results_dir.exists()


def test_unknown_family_raises(results_dir):
    with pytest.raises(ValueError, match="unknown family"):
        run.main(["--only", "model_zoo", "--family", "gpt-5", "--device", "cpu"])
    assert not results_dir.exists()


def test_a_failing_bench_exits_1_and_the_rest_run(results_dir, monkeypatch, capsys):
    def boom(quick, device, family):
        raise RuntimeError("kernel refused")

    calls = []
    monkeypatch.setattr(run, "BENCHES", [
        ("boom", "raises", boom),
        ("fine", "returns", lambda quick, device, family: calls.append(
            (quick, device, family)) or {"perf_summary": {"x": 1}}),
    ])
    assert run.main(["--family", "qwen2-1.5b", "--device", "cpu"]) == 1
    assert calls == [(False, "cpu", "qwen2-1.5b")]
    bad = json.loads((results_dir / "torch_BENCH_boom.json").read_text())
    assert (bad["status"], bad["error"], bad["summary"]) == (
        "error", "RuntimeError: kernel refused", {})
    good = json.loads((results_dir / "torch_BENCH_fine.json").read_text())
    assert (good["status"], good["summary"]) == ("ok", {"x": 1})
    out = capsys.readouterr()
    assert "[boom] FAILED: RuntimeError: kernel refused" in out.out
    assert "Traceback" in out.err
    assert "1/2 benches succeeded" in out.out
