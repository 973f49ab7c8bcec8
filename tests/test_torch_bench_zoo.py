"""The port's model-zoo bench (``repro_torch.benchmarks.model_zoo``)
against the JAX bench (``benchmarks/model_zoo.py``) on the JAX package's
weights, for the first five of the ten archs (the other five:
``test_torch_bench_zoo_families.py``; the shared pieces: ``_bench_zoo.py``).
Each arch's JAX smoke init goes to the port through
``lm_params_from_numpy``, and ``family_record`` runs on it with
``make_batch``'s prefill batch, in fp32:

* its r=0.05 per-column ledger equals the JAX ``pair_params`` ledger (the
  JAX bench's call) leaf for leaf: path, shape and pairs; fractions to
  1e-12;
* its r=0 parity (K1's plain version against ``torch.matmul``) is within
  the bench's 1e-5;
* each leaf's ``is_expert`` is the JAX bench's ``_is_expert_leaf``.

Besides: the bench's constants and knobs are the JAX bench's, its ``run``
passes on its own seed, an unknown family raises.  The JAX bench's
``run`` is not called: it writes into the repository's results folder and
runs ten families' Pallas kernels in interpret mode.
"""
import json

import pytest

from _bench_zoo import check_expert_leaves, check_ledger, check_parity, zoo_records
from benchmarks import model_zoo as J
from repro import configs as j_configs
from repro_torch.benchmarks import common, model_zoo

ARCHS = tuple(j_configs.ALL_ARCHS[:5])


def test_constants_match_the_jax_bench():
    names = ("B", "S", "QUICK_FAMILIES", "PARITY_TOL", "LEDGER_ROUNDING")
    assert {n: getattr(model_zoo, n) for n in names} == {n: getattr(J, n) for n in names}
    for port, jax_knobs in ((model_zoo.KNOBS_XLA, J.KNOBS_XLA),
                            (model_zoo.KNOBS_PAIRED, J.KNOBS_PAIRED)):
        for f in ("q_chunk", "k_chunk", "remat", "gemm", "conv"):
            assert getattr(port, f) == getattr(jax_knobs, f), f


@pytest.mark.parametrize("arch", ARCHS)
def test_ledger_equals_jax_pair_params(arch):
    check_ledger(*zoo_records(arch, ARCHS))


@pytest.mark.parametrize("arch", ARCHS)
def test_r0_parity(arch):
    check_parity(zoo_records(arch, ARCHS)[0])


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_leaves_as_the_jax_bench(arch):
    check_expert_leaves(arch, zoo_records(arch, ARCHS)[0])


def test_run_quick_writes_the_ledger(tmp_path, monkeypatch):
    """``run`` on its own seed: the quick families pass, the record is written."""
    monkeypatch.setattr(common, "RESULTS_DIR", tmp_path)
    out = model_zoo.run(quick=True, device="cpu")
    assert list(out["perf_summary"]["families"]) == list(model_zoo.QUICK_FAMILIES)
    payload = json.loads((tmp_path / "torch_model_zoo.json").read_text())
    assert payload["failures"] == [] and payload["device"] == "cpu"
    assert all(f["parity_ok"] for f in payload["families"].values())


def test_unknown_family_raises():
    with pytest.raises(ValueError, match="unknown family"):
        model_zoo.families(family="gpt-5")
