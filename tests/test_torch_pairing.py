"""The port's pairing metadata and op ledgers equal the JAX package's.

Same float64 numpy weights into ``repro.core`` (the reference) and
``repro_torch.core`` (the port): structured, column-blocked and per-column
pairings must agree index for index — ``I``/``J``/``resid``, ``Kmat``,
``index_arrays`` and ``packed_weights`` — and the Table-I ledgers number for
number.  Weights are LeNet-shaped (He-initialised conv matrices) and random,
plus a coarsely quantised matrix full of exact ties and zeros, which is
where a different sort or comparison order would show.
"""
import numpy as np
import pytest
import torch

from repro.core import cost_model as j_cost
from repro.core import pairing as j_pair
from repro.core import transform as j_transform
from repro_torch.core import cost_model as t_cost
from repro_torch.core import pairing as t_pair
from repro_torch.core import transform as t_transform

ROUNDINGS = [0.0, 0.005, 0.05, 0.2]
LENET_KN = {"conv1": (25, 6), "conv2": (150, 16), "conv3": (400, 120)}


def _weights(kind: str) -> np.ndarray:
    rng = np.random.default_rng(sum(map(ord, kind)))
    if kind in LENET_KN:
        K, N = LENET_KN[kind]
        return rng.normal(size=(K, N)) * np.sqrt(2.0 / K)
    if kind == "random":
        return rng.normal(size=(37, 9)) * 0.3
    # quantised to a 0.05 grid: many exact ties, zero rows and zero weights
    w = np.round(rng.normal(size=(40, 8)) * 4) / 20
    w[5] = 0.0
    return w


KINDS = ["conv1", "conv2", "conv3", "random", "quantised"]


def _assert_structured_equal(a, b):
    for f in ("I", "J", "resid", "Kmat", "W_res"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.perm(), b.perm())
    np.testing.assert_array_equal(a.fold(), b.fold())
    assert (a.n_pairs, a.weighted_pairs) == (b.n_pairs, b.weighted_pairs)


@pytest.mark.parametrize("r", ROUNDINGS)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("criterion", ["rms", "max"])
def test_structured_pairing_equal(kind, r, criterion):
    w = _weights(kind)
    _assert_structured_equal(
        t_pair.pair_rows_structured(w, r, criterion=criterion),
        j_pair.pair_rows_structured(w, r, criterion=criterion),
    )


@pytest.mark.parametrize("block_n", [1, 2, 4, "N"])
@pytest.mark.parametrize("r", ROUNDINGS)
@pytest.mark.parametrize("kind", KINDS)
def test_blocked_pairing_equal(kind, r, block_n):
    w = _weights(kind)
    bn = w.shape[1] if block_n == "N" else block_n
    got, want = t_pair.pair_rows_blocked(w, r, bn), j_pair.pair_rows_blocked(w, r, bn)
    assert (got.n_blocks, got.block_n, got.shape) == (want.n_blocks, want.block_n, want.shape)
    for a, b in zip(got.blocks, want.blocks, strict=True):
        _assert_structured_equal(a, b)
    gi, wi = got.index_arrays(), want.index_arrays()
    assert gi.keys() == wi.keys()
    for k in wi:
        np.testing.assert_array_equal(gi[k], wi[k], err_msg=k)
        assert gi[k].dtype == wi[k].dtype, k
    for a, b in zip(got.packed_weights(), want.packed_weights(), strict=True):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.fold(), want.fold())
    assert (got.n_pairs, got.weighted_pairs, got.Pmax, got.Rmax) == (
        want.n_pairs, want.weighted_pairs, want.Pmax, want.Rmax
    )
    assert [got.block_cols(b) for b in range(got.n_blocks)] == [
        want.block_cols(b) for b in range(want.n_blocks)
    ]


@pytest.mark.parametrize("r", ROUNDINGS)
@pytest.mark.parametrize("kind", KINDS)
def test_column_pairing_and_algorithm1_equal(kind, r):
    w = _weights(kind)
    got, want = t_pair.pair_columns(w, r), j_pair.pair_columns(w, r)
    for f in ("pair_pos", "pair_neg", "pair_mag", "n_pairs"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert got.total_pairs == want.total_pairs
    np.testing.assert_array_equal(t_pair.fold_columns(w, got), j_pair.fold_columns(w, want))
    for n in range(min(w.shape[1], 4)):
        a, b = t_pair.pair_list_twopointer(w[:, n], r), j_pair.pair_list_twopointer(w[:, n], r)
        for f in ("pair_pos", "pair_neg", "pair_mag", "uncombined"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def test_conv_column_pairing_equal():
    kernel = _weights("conv2").reshape(5, 5, 6, 16)
    got = t_pair.column_pairing_for_conv(kernel, 0.05)
    want = j_pair.column_pairing_for_conv(kernel, 0.05)
    np.testing.assert_array_equal(got.pair_pos, want.pair_pos)
    np.testing.assert_array_equal(got.pair_mag, want.pair_mag)


def test_table1_ledgers_equal():
    """sweep_rounding / pairing_op_counts on LeNet's conv matrices at every
    Table-I rounding, and the paper's table and ASIC model, number for number."""
    mats = [_weights(k) for k in LENET_KN]
    positions = [28 * 28, 10 * 10, 1]
    roundings = [row["rounding"] for row in j_cost.paper_table1()]
    got = t_pair.sweep_rounding(mats, positions, roundings)
    assert got == j_pair.sweep_rounding(mats, positions, roundings)
    for row in got:
        assert row["adds"] == row["mults"]
        assert row["adds"] + row["subs"] == 405600
    for args in [(150, 0, 1), (2400, 37, 100), (48000, 20000, 1)]:
        assert t_pair.pairing_op_counts(*args) == j_pair.pairing_op_counts(*args)
    assert t_cost.paper_table1() == j_cost.paper_table1()
    base, new = (405600, 405600, 0), (242153, 242153, 163447)
    tm, jm = t_cost.AsicCostModel(), j_cost.AsicCostModel()
    tb, tn = t_cost.OpCounts(*base), t_cost.OpCounts(*new)
    jb, jn = j_cost.OpCounts(*base), j_cost.OpCounts(*new)
    assert tm.power_saving(tb, tn) == jm.power_saving(jb, jn)
    assert tm.area_saving(tb, tn) == jm.area_saving(jb, jn)
    assert tn.total == jn.total


@pytest.mark.parametrize(
    "mode,block_n", [("structured", 0), ("column_blocked", 4), ("per_column", 0)]
)
@pytest.mark.parametrize("r", [0.0, 0.05])
def test_build_conv_pairings_equal(mode, block_n, r):
    """Conv artifacts from HWIO float32 weights (paired on float64 copies on
    both sides), from numpy and from torch tensors, and their ledgers."""
    rng = np.random.default_rng(3)
    params = {
        name: {
            "w": (rng.normal(size=(5, 5, k // 25, n)) * np.sqrt(2.0 / k)).astype(np.float32),
            "b": np.zeros(n, np.float32),
        }
        for name, (k, n) in LENET_KN.items()
    }
    params["fc1"] = {"w": np.ones((120, 84), np.float32), "b": np.zeros(84, np.float32)}
    positions = {"conv1": 784, "conv2": 100, "conv3": 1}
    kw = dict(mode=mode, block_n=block_n, positions=positions)
    want = j_transform.build_conv_pairings(params, r, **kw)
    tensors = {k: {f: torch.as_tensor(v) for f, v in leaf.items()} for k, leaf in params.items()}
    for got in (
        t_transform.build_conv_pairings(params, r, **kw),
        t_transform.build_conv_pairings(tensors, r, **kw),
    ):
        assert got.keys() == want.keys() == set(LENET_KN)
        for name in want:
            a, b = got[name], want[name]
            assert (a.name, a.kernel_shape, a.rounding, a.positions) == (
                b.name, b.kernel_shape, b.rounding, b.positions
            )
            assert a.n_pairs == b.n_pairs
            assert a.measured_op_counts() == b.measured_op_counts()
            np.testing.assert_array_equal(a.pairing.fold(), b.pairing.fold())
    total = sum(a.measured_op_counts()["baseline_lanes"] for a in want.values())
    assert total == 405600


def test_build_conv_pairings_rejects_bad_mode():
    params = {"c": {"w": np.ones((1, 1, 2, 2), np.float32)}}
    with pytest.raises(ValueError):
        t_transform.build_conv_pairings(params, 0.0, mode="column_blocked")
    with pytest.raises(ValueError):
        t_transform.build_conv_pairings(params, 0.0, mode="diagonal")
