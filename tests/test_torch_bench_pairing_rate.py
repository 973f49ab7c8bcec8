"""The port's LM pairing-rate bench (``repro_torch.benchmarks.pairing_rate_lm``)
against the JAX bench (``benchmarks/pairing_rate_lm.py``), on the JAX
package's weights (each arch's smoke init, ``init_lm(cfg, key(0))``,
through ``lm_params_from_numpy``):

* the relative rounding within 1e-6 of the JAX bench's (0.25 × the median
  nonzero per-leaf std of the JAX value tree), for all ten archs;
* the rows at that rounding equal to the JAX ``pair_params(...,
  min_dim=4)`` reports, per column and structured (the bench's quick
  archs);
* the JAX bench's own rows pinned as different: its ``pair_model_params``
  on the whole tree pairs qwen2's embedding and its 4-D attention stacks
  read as conv filters (40 960 weights), not the seven GEMMs of each
  layer (73 728 weights).

The ten JAX inits run on four threads (``_bench_zoo.jax_values``).
"""
import functools
import json

import jax
import numpy as np
import pytest

from _bench_zoo import jax_values
from benchmarks import pairing_rate_lm as JP
from repro import configs as j_configs
from repro.core import transform as j_transform
from repro_torch import configs as t_configs
from repro_torch.benchmarks import common, pairing_rate_lm
from repro_torch.models import lm as TM

ARCHS = tuple(j_configs.ALL_ARCHS)


def _jax_values(arch):
    return jax_values(arch, ARCHS)


@functools.cache
def _model(arch):
    return TM.lm_params_from_numpy(_jax_values(arch), t_configs.get_smoke_config(arch),
                                   device="cpu")


@functools.cache
def _jax_reports(arch):
    """The JAX bench's rounding of ``arch`` and the JAX ``pair_params``
    reports at it, per column and structured, with the bench's ``min_dim``."""
    values = _jax_values(arch)
    r_abs = _jax_rounding(values)
    return r_abs, *(j_transform.pair_params(values, r_abs, mode=mode, min_dim=4)[1]
                    for mode in ("per_column", "structured"))


def _jax_rounding(values) -> float:
    """The JAX bench's rounding, as its ``run`` computes it."""
    stds = [float(np.std(np.asarray(leaf))) for leaf in jax.tree.leaves(values)]
    return JP.ROUNDING_REL * float(np.median([s for s in stds if s > 0]))


def test_constants_match_the_jax_bench():
    assert pairing_rate_lm.ROUNDING_REL == JP.ROUNDING_REL


@pytest.mark.parametrize("arch", ARCHS)
def test_relative_rounding(arch):
    want = _jax_rounding(_jax_values(arch))
    assert abs(pairing_rate_lm.relative_rounding(_model(arch)) - want) <= 1e-6
    assert want > 0


@pytest.mark.parametrize("arch", ARCHS[:3])  # the bench's quick archs
def test_rows_equal_jax_per_gemm_pairing(arch):
    r_abs, rep, rep_s = _jax_reports(arch)
    s = rep.savings()
    assert pairing_rate_lm.rows(_model(arch), r_abs) == {
        "weights": rep.total_weights,
        "pair_frac_%": 100 * rep.pair_fraction,
        "power_saving_%": 100 * s["power_saving"],
        "area_saving_%": 100 * s["area_saving"],
        "structured_frac_%": 100 * rep_s.pair_fraction,
    }
    assert 0 <= rep_s.pair_fraction < rep.pair_fraction


def test_jax_bench_pairs_the_wrong_leaves():
    """The reference fault the port departs from: the JAX bench's whole-tree
    ``pair_model_params`` against the per-GEMM pairing, on qwen2-1.5b."""
    r_abs, per_gemm, _ = _jax_reports("qwen2-1.5b")
    _, whole = j_transform.pair_model_params(_jax_values("qwen2-1.5b"), r_abs, min_dim=4)
    assert whole.total_weights == 40960
    assert per_gemm.total_weights == 73728
    assert {leaf.path.split("]")[0] + "]" for leaf in whole.leaves} == {"['embed']",
                                                                         "['segments']"}
    assert sorted(len(leaf.shape) for leaf in whole.leaves) == [2, 4, 4, 4, 4]
    assert len(per_gemm.leaves) == 7
    assert pairing_rate_lm.rows(_model("qwen2-1.5b"), r_abs)["weights"] == 73728


def test_run_quick(tmp_path, monkeypatch):
    monkeypatch.setattr(common, "RESULTS_DIR", tmp_path)
    out = pairing_rate_lm.run(quick=True, device="cpu")
    assert [r["arch"] for r in out["rows"]] == list(ARCHS[:3])
    assert json.loads((tmp_path / "torch_pairing_rate_lm.json").read_text()) == json.loads(
        json.dumps(out))
    for r in out["rows"]:
        assert 0 <= r["structured_frac_%"] < r["pair_frac_%"] <= 100
        assert r["power_saving_%"] > 0 and r["area_saving_%"] > 0
