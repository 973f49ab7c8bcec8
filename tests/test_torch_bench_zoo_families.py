"""The port's model-zoo bench against the JAX bench for the last five of
the ten archs: the vision prefix, SSM, MLA with shared experts, MoE and
hybrid families (the first five, and what the checks hold:
``test_torch_bench_zoo.py``; the shared pieces: ``_bench_zoo.py``)."""
import pytest

from _bench_zoo import check_expert_leaves, check_ledger, check_parity, zoo_records
from repro import configs as j_configs

ARCHS = tuple(j_configs.ALL_ARCHS[5:])


@pytest.mark.parametrize("arch", ARCHS)
def test_ledger_equals_jax_pair_params(arch):
    check_ledger(*zoo_records(arch, ARCHS))


@pytest.mark.parametrize("arch", ARCHS)
def test_r0_parity(arch):
    check_parity(zoo_records(arch, ARCHS)[0])


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_leaves_as_the_jax_bench(arch):
    check_expert_leaves(arch, zoo_records(arch, ARCHS)[0])
