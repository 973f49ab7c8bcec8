"""The port's LM pairing and configs equal the JAX package's.

``pair_lm_params`` on the same weights (the JAX qwen2 smoke init, matrices
scaled by 0.3 so that r=0.05 pairs lanes in every mode) must give the JAX
package's metadata index for index, each layer's slice of its stacked
arrays, segment-wide padding and masks included, and the same report.  The
live-weight ops over that metadata (``fold_lm_weight``,
``fused_paired_dense``) are held to the JAX package's at the same time.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.core import transform as j_transform
from repro.kernels import ops as j_ops
from repro.models import lm as JM
from repro.models.param import unzip
from repro_torch import configs as t_configs
from repro_torch.core import transform as t_transform
from repro_torch.kernels import ops
from repro_torch.kernels.ref import rel_err
from repro_torch.models import lm as TM

MODES = [("structured", 0), ("column_blocked", 1), ("column_blocked", 16)]


@pytest.fixture(scope="module")
def values():
    cfg = j_configs.get_smoke_config("qwen2-1.5b")
    vals = jax.tree.map(np.asarray, unzip(JM.init_lm(cfg, jax.random.key(0)))[0])
    for sub in ("attn", "mlp"):
        blk = vals["segments"][0][sub]
        for name in [n for n in blk if n.startswith("w")]:
            blk[name] = blk[name] * np.float32(0.3)
    return vals


@pytest.mark.parametrize("get", ["get_config", "get_smoke_config"])
def test_config_fields_equal(get):
    port, ref = getattr(t_configs, get)("qwen2-1.5b"), getattr(j_configs, get)("qwen2-1.5b")
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.head_dim == ref.head_dim
    assert port.segments() == ref.segments()
    assert port.param_count() == ref.param_count()
    assert TM.padded_vocab(port) == JM.padded_vocab(ref)


def test_unported_archs_raise():
    """Every architecture of the JAX package resolves; any other name raises."""
    assert sorted(t_configs.PORTED) == sorted(j_configs.ALL_ARCHS)
    for name in j_configs.ALL_ARCHS:
        assert t_configs.get_config(name).name == j_configs.get_config(name).name
    with pytest.raises(KeyError, match="unknown"):
        t_configs.get_smoke_config("gpt-2")


@pytest.mark.parametrize("rounding", [0.0, 0.05])
@pytest.mark.parametrize("mode,block_n", MODES)
def test_pair_lm_params_equal(values, mode, block_n, rounding):
    ref, ref_report = j_transform.pair_lm_params(values, rounding, mode=mode, block_n=block_n)
    model = TM.lm_params_from_numpy(values, t_configs.get_smoke_config("qwen2-1.5b"),
                                    device="cpu")
    assert not t_transform.has_lm_pairing(model)
    paired, report = t_transform.pair_lm_params(model, rounding, mode=mode, block_n=block_n)
    assert t_transform.has_lm_pairing(paired) and not t_transform.has_lm_pairing(model)
    seg = ref["segments"][0]
    for sub, name in t_transform.LM_PAIRED_WEIGHTS:
        want = seg[sub][name + "_pairing"]
        for l, layer in enumerate(paired.layers):
            block = getattr(layer, sub)
            assert getattr(block, name) is getattr(getattr(model.layers[l], sub), name)
            got = block.pairing[name]
            assert sorted(got) == sorted(want)
            for key, arr in want.items():
                np.testing.assert_array_equal(got[key].numpy(), np.asarray(arr)[l],
                                              err_msg=f"{sub}.{name}[{l}].{key}")
    assert (report.rounding, report.mode) == (ref_report.rounding, ref_report.mode)
    assert len(report.leaves) == len(ref_report.leaves) == 7
    for a, b in zip(report.leaves, ref_report.leaves, strict=True):
        assert (a.path, a.shape, a.n_weights, a.n_pairs) == (b.path, b.shape, b.n_weights,
                                                            b.n_pairs)
        assert a.pair_fraction == b.pair_fraction
    assert report.savings() == ref_report.savings()
    if rounding:
        assert report.total_pairs > 0


def test_pair_params_validates_specs(values):
    model = TM.lm_params_from_numpy(values, t_configs.get_smoke_config("qwen2-1.5b"),
                                    device="cpu")
    with pytest.raises(ValueError, match="no weight matched"):
        t_transform.pair_params(model, 0.0, leaves=(("attn", "wq"), ("moe", "w_up")))
    with pytest.raises(ValueError, match="needs block_n"):
        t_transform.pair_params(model, 0.0, mode="column_blocked")
    _, report = t_transform.pair_params(model, 0.0, leaves=(("mlp", "w_down"),))
    assert [leaf.path for leaf in report.leaves] == ["segments[0].mlp.w_down"]


def _layer_meta(values, mode, block_n, rounding=0.3):
    """The JAX metadata of layer 0's w_gate, and the weight, as (numpy, torch)."""
    paired, _ = j_transform.pair_lm_params(values, rounding, mode=mode, block_n=block_n)
    mlp = paired["segments"][0]["mlp"]
    meta = {k: np.asarray(v)[0] for k, v in mlp["w_gate_pairing"].items()}
    tmeta = {k: torch.as_tensor(v).long() if v.dtype.kind == "i" else torch.as_tensor(v)
             for k, v in meta.items()}
    return np.asarray(mlp["w_gate"])[0], meta, tmeta


@pytest.mark.parametrize("mode,block_n", MODES)
def test_fold_lm_weight_equal(values, mode, block_n):
    w, meta, tmeta = _layer_meta(values, mode, block_n)
    assert meta["pair_mask"].sum() > 0
    want = j_ops.fold_lm_weight(jnp.asarray(w), {k: jnp.asarray(v) for k, v in meta.items()},
                                block_n)
    got = ops.fold_lm_weight(torch.as_tensor(w), tmeta, block_n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode,block_n", MODES)
def test_fused_paired_dense_matches_fold_and_residual(values, mode, block_n):
    """x through the paired GEMM from live weights equals x @ fold, the
    activation and the residual fused; 3-D activations keep their shape."""
    w, _, tmeta = _layer_meta(values, mode, block_n)
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.normal(size=(2, 3, w.shape[0])).astype(np.float32))
    res = torch.as_tensor(rng.normal(size=(2, 3, w.shape[1])).astype(np.float32))
    tw = torch.as_tensor(w)
    got = ops.fused_paired_dense(x, tw, tmeta, activation="silu", residual=res,
                                 pair_block_n=block_n)
    want = torch.nn.functional.silu(x @ ops.fold_lm_weight(tw, tmeta, block_n)) + res
    assert got.shape == (2, 3, w.shape[1])
    assert rel_err(got, want) <= 1e-5


def test_blocked_metadata_needs_block_n(values):
    w, _, tmeta = _layer_meta(values, "column_blocked", 16)
    with pytest.raises(ValueError, match="pair_block_n"):
        ops.fused_paired_dense(torch.zeros((1, w.shape[0])), torch.as_tensor(w), tmeta)
