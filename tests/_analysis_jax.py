"""Shared pieces of the schedule-linter tests that hold the port
(``repro_torch.analysis``) to the JAX package (``repro.analysis``).

The JAX side is linted by every JAX rule but ``vmem/static-budget``, which
raises on this JAX release (``kernels/tuning.py`` reads a ``Blocked``
block dim as an int; the seed's ``test_vmem_budget_flags_oversized_blocks``
fails on the same drift).  :func:`held_to_jax` compares two reports rule by
rule under ``core.JAX_RULE``'s names: eager PyTorch runs every decode layer,
so a decode layer's count is a scan trip's, and a step's count and its
residual adds are a trip's times the layers.  ``dtype/convert-churn`` is
reported but not compared (no target caps it), nor is
``smem/static-budget`` (no JAX run to compare).
"""
import jax
import numpy as np

from repro.analysis import RULE_REGISTRY as J_REGISTRY
from repro.analysis.core import _load_rules as j_load_rules
from repro_torch.analysis.core import JAX_RULE
from repro_torch.analysis.rules_pairing import _stacks

NOT_COMPARED = {"dtype/convert-churn", "smem/static-budget"}
#: what the JAX package calls a port need
NEED = {"jaxpr": "trace", "hlo": "step"}
#: counts over a whole eager step: a scan trip's times the layers
PER_STEP = {"schedule/writebacks-per-program", "schedule/standalone-residual-adds"}
PAIRING_RULES = ("pairing/valid-permutation", "pairing/padding-consistent",
                 "pairing/stacked-shapes")


def jax_rule_ids() -> list[str]:
    j_load_rules()
    return sorted(r for r in J_REGISTRY if r != "vmem/static-budget")


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def held_to_jax(port, want, layers: int = 1) -> None:
    """The port's report measures what the JAX report does, rule by rule:
    the same rules run and skipped (for the same need), and each rule's
    findings of the same severity and measured value (``PER_STEP`` rules
    ``layers`` times the JAX value; one per-layer finding a decode layer,
    each the JAX trip's)."""
    assert not port.errors(), [f.as_dict() for f in port.errors()]
    mapped = {JAX_RULE[r] for r in port.rules_run if r != "smem/static-budget"}
    assert mapped == set(want.rules_run)
    assert ({JAX_RULE[r]: n for r, n in port.rules_skipped.items() if r != "smem/static-budget"}
            == {r: NEED.get(n, n) for r, n in want.rules_skipped.items()})
    for rid in port.rules_run:
        if rid in NOT_COMPARED:
            continue
        got = [f for f in port.findings if f.rule == rid]
        exp = [f for f in want.findings if f.rule == JAX_RULE[rid]]
        if rid == "schedule/writebacks-per-decode-layer":
            assert {(f.severity, f.measured) for f in got} == {
                (f.severity, f.measured) for f in exp}, rid
            if any(f.location.endswith("/scan0") for f in exp):
                assert len(got) == layers
            continue
        scale = layers if rid in PER_STEP else 1
        assert [(f.severity, f.measured) for f in got] == [
            (f.severity, f.measured * scale) for f in exp], rid


def j_path(path: str):
    """``segments[1].moe.shared.w_up_pairing`` → (("segments", 1),
    "moe.shared", "w_up_pairing")."""
    head, rest = path.split("].", 1)
    stack, si = head.split("[")
    sub, key = rest.rsplit(".", 1)
    return (stack, int(si)), sub, key


def j_meta(params: dict, path: str) -> dict:
    """The JAX param tree's stacked metadata dict at a port stack's path."""
    (stack, si), sub, key = j_path(path)
    node = (params["encoder"] if stack.startswith("encoder") else params)["segments"][si]
    for part in sub.split("."):
        node = node[part]
    return node[key]


def assert_same_metadata(model, params: dict) -> int:
    """Every metadata stack of the port's ``model`` equals the JAX
    ``params``' stacked ``"<w>_pairing"`` arrays, index for index; returns
    the stacks compared."""
    stacks = _stacks(model)
    for stack in stacks:
        for k, arr in j_meta(params, stack.path).items():
            got = np.stack([m[k].cpu().numpy() for m in stack.metas])
            np.testing.assert_array_equal(got, np.asarray(arr), err_msg=f"{stack.path} {k}")
    return len(stacks)
