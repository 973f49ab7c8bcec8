"""Shared pieces of the model-zoo and pairing-rate bench tests: the JAX
package's smoke weights and the checks of the port's model-zoo record.

``jax_values(arch, group)`` is the arch's JAX smoke init (``init_lm(cfg,
key(0))`` as a numpy value tree; its values do not depend on the config's
dtype), made for every arch of ``group`` at once on four threads (XLA
compiles each eager op once, outside the interpreter lock: about half the
time of one after the other).  ``zoo_records(arch)`` runs the port's
``model_zoo.family_record`` on those weights and the JAX bench's
``pair_params`` call beside it; the ``check_*`` functions hold the one to
the other.
"""
import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np

from benchmarks import model_zoo as J
from repro import configs as j_configs
from repro.core import transform as j_transform
from repro.models import lm as JM
from repro.models.param import unzip
from repro_torch import configs as t_configs
from repro_torch.benchmarks import model_zoo
from repro_torch.launch.inputs import make_batch
from repro_torch.models import lm as TM

MOE_ARCHS = ("olmoe-1b-7b", "deepseek-v2-lite-16b")


def _init(arch):
    return jax.tree.map(np.asarray,
                        unzip(JM.init_lm(j_configs.get_smoke_config(arch), jax.random.key(0)))[0])


@functools.cache
def _group_values(group: tuple[str, ...]) -> dict:
    with ThreadPoolExecutor(4) as ex:
        return dict(zip(group, ex.map(_init, group), strict=True))


def jax_values(arch: str, group: tuple[str, ...]) -> dict:
    return _group_values(group)[arch]


@functools.cache
def zoo_records(arch: str, group: tuple[str, ...]):
    """(the port's model-zoo record, the JAX ``pair_params`` report at the
    bench's rounding) of one arch, on the JAX weights, in fp32."""
    values = jax_values(arch, group)
    jcfg = j_configs.get_smoke_config(arch)
    _, jrep = j_transform.pair_params(values, J.LEDGER_ROUNDING, mode="per_column",
                                      leaves=jcfg.paired_leaves or None)
    cfg = dataclasses.replace(t_configs.get_smoke_config(arch), dtype="float32")
    model = TM.lm_params_from_numpy(values, cfg, device="cpu")
    batch = make_batch(cfg, model_zoo.B, model_zoo.S, "prefill", device="cpu")
    return model_zoo.family_record(cfg, model, batch), jrep


def check_ledger(rec, jrep) -> None:
    """The r=0.05 ledger leaf for leaf: path, shape, pairs; fractions to 1e-12."""
    assert rec["n_leaves"] == len(jrep.leaves) == len(rec["leaves"]) > 0
    for got, want in zip(rec["leaves"], jrep.leaves, strict=True):
        assert (got["path"], tuple(got["shape"]), got["n_pairs"]) == (
            want.path, tuple(want.shape), want.n_pairs)
        assert abs(got["pair_fraction"] - want.pair_fraction) <= 1e-12, got["path"]
    assert abs(rec["pair_fraction_r005"] - jrep.pair_fraction) <= 1e-12
    assert rec["pair_fraction_r005"] > 0


def check_parity(rec) -> None:
    assert rec["parity_rel_err"] <= model_zoo.PARITY_TOL
    assert rec["parity_ok"]


def check_expert_leaves(arch, rec) -> None:
    """Each leaf's ``is_expert`` as the JAX bench's ``_is_expert_leaf``."""
    flags = [leaf["is_expert"] for leaf in rec["leaves"]]
    assert flags == [J._is_expert_leaf(leaf["path"]) for leaf in rec["leaves"]]
    fracs = [leaf["pair_fraction"] for leaf in rec["leaves"] if leaf["is_expert"]]
    assert rec["moe_expert_pair_fraction"] == (max(fracs) if fracs else None)
    assert any(flags) == (arch in MOE_ARCHS)
