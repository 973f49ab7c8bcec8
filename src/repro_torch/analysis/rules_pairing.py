"""Pairing-artifact validation rules.

The port of ``repro.analysis.rules_pairing``.  The pairing artifacts are
offline preprocessing outputs (built once, on the host) that the kernels
then trust completely: a lane index list that is not a permutation silently
drops or double-counts contraction lanes, padding whose mask does not zero
it contracts garbage, and per-layer metadata that disagrees with the
weights it shadows gathers the wrong lanes.  These rules validate the
concrete artifacts, no trace required:

* conv artifacts (``core.transform.build_conv_pairings`` →
  ``{name: PairedLayer}``) via ``RuleContext.pairing_artifacts``;
* an LM's per-layer metadata (``core.transform.pair_params`` → each block's
  ``pairing[name]``, decoder and encoder, nested blocks and the expert axis
  included) via ``RuleContext.params``.

The JAX package stacks a segment's layers into one ``(L, …)`` array a key;
the port keeps one dict a layer.  ``pairing/stacked-shapes`` groups each
weight's per-layer metadata across its segment, as the JAX stack does, so
it counts one entry a stack, and locations name the JAX paths
(``segments[0].attn.wq_pairing[layer 1]``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.analysis.core import Finding, RuleContext, rule
from repro_torch.analysis.trace import META_KEYS


@dataclasses.dataclass
class _Artifact:
    """One per-layer (or per-layer-per-block) lane structure to validate."""

    location: str
    K: int  # contraction length the lanes must cover
    I: np.ndarray  # (P,) padded pair indices
    J: np.ndarray  # (P,)
    resid: np.ndarray  # (R,)
    pair_mask: np.ndarray | None  # (P,) 1.0 real / 0.0 padding; None → unpadded
    resid_mask: np.ndarray | None


@dataclasses.dataclass
class _Stack:
    """One weight's metadata across the layers of one segment: the JAX
    package's ``"<name>_pairing"`` stack."""

    path: str  # "segments[0].attn.wq_pairing"
    w_name: str
    weights: list  # each layer's weight
    metas: list  # each layer's metadata dict, or None where a layer has none
    expert: bool  # (E, K, F) weights, (E, …) metadata


def _conv_artifacts(arts: dict) -> list[_Artifact]:
    from repro_torch.core.pairing import BlockedPairing, StructuredPairing

    out = []
    for name, layer in arts.items():
        p = getattr(layer, "pairing", layer)
        if isinstance(p, StructuredPairing):
            out.append(_Artifact(
                location=name, K=p.shape[0], I=np.asarray(p.I), J=np.asarray(p.J),
                resid=np.asarray(p.resid), pair_mask=None, resid_mask=None,
            ))
        elif isinstance(p, BlockedPairing):
            idx = p.index_arrays()
            for b in range(p.n_blocks):
                out.append(_Artifact(
                    location=f"{name}/block{b}", K=p.shape[0],
                    I=idx["I"][b], J=idx["J"][b], resid=idx["resid"][b],
                    pair_mask=idx["pair_mask"][b],
                    resid_mask=idx["resid_mask"][b],
                ))
    return out


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def _stacks(model) -> list[_Stack]:
    """Every weight's metadata stack of an LM's segments, decoder then
    encoder, in the order its layers' blocks carry them."""
    out = []
    groups = [("segments", model.layers, model.segments)]
    if getattr(model, "encoder", None) is not None:
        groups.append(("encoder.segments", model.encoder.layers, model.encoder.segments))
    for prefix, layers, segments in groups:
        start = 0
        for si, (_, count) in enumerate(segments):
            seg = list(layers[start:start + count])
            start += count
            found: dict[tuple[str, str], None] = {}
            for layer in seg:
                for sub_path, block in layer.named_modules():
                    for w_name in getattr(block, "pairing", {}):
                        if sub_path and hasattr(block, w_name):
                            found[sub_path, w_name] = None
            for sub_path, w_name in found:
                blocks = [layer.get_submodule(sub_path) for layer in seg]
                weights = [getattr(b, w_name) for b in blocks]
                out.append(_Stack(
                    path=f"{prefix}[{si}].{sub_path}.{w_name}_pairing", w_name=w_name,
                    weights=weights, metas=[b.pairing.get(w_name) for b in blocks],
                    expert=sub_path.rsplit(".", 1)[-1] == "moe" and weights[0].ndim == 3))
    return out


def _stack_K(s: _Stack) -> int:
    from repro_torch.core.transform import _lm_weight_matrix_shape

    shape = tuple(s.weights[0].shape)
    return _lm_weight_matrix_shape(s.w_name, shape[1:] if s.expert else shape)[0]


def _lm_artifacts(model) -> list[_Artifact]:
    out = []
    for s in _stacks(model):
        K = _stack_K(s)
        tag = "layer·expert" if s.expert else "layer"
        for layer, meta in enumerate(s.metas):
            if meta is None:
                continue
            m = {k: _numpy(meta[k]) for k in META_KEYS}
            # an expert's rows follow each other: flat index layer·E + expert
            rows = [(layer * len(m["I"]) + e, {k: v[e] for k, v in m.items()})
                    for e in range(len(m["I"]))] if s.expert else [(layer, m)]
            for i, r in rows:
                if r["I"].ndim == 2:  # blocked: (blocks, Pmax)
                    for b in range(r["I"].shape[0]):
                        out.append(_Artifact(
                            location=f"{s.path}[{tag} {i}, block {b}]", K=K,
                            I=r["I"][b], J=r["J"][b], resid=r["resid"][b],
                            pair_mask=r["pair_mask"][b], resid_mask=r["resid_mask"][b]))
                else:  # structured: (Pmax,)
                    out.append(_Artifact(
                        location=f"{s.path}[{tag} {i}]", K=K, I=r["I"], J=r["J"],
                        resid=r["resid"], pair_mask=r["pair_mask"],
                        resid_mask=r["resid_mask"]))
    return out


def _all_artifacts(ctx: RuleContext) -> list[_Artifact]:
    arts: list[_Artifact] = []
    if ctx.pairing_artifacts:
        arts.extend(_conv_artifacts(ctx.pairing_artifacts))
    if ctx.params is not None:
        arts.extend(_lm_artifacts(ctx.params))
    return arts


def _valid_lanes(a: _Artifact) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(I, J, resid) restricted to mask-valid entries."""
    if a.pair_mask is None:
        return a.I, a.J, a.resid
    p = a.pair_mask > 0
    r = a.resid_mask > 0
    return a.I[p], a.J[p], a.resid[r]


@rule("pairing/valid-permutation", needs=("pairing",))
def valid_permutation(ctx: RuleContext):
    """Per-block lane lists ``[I | J | resid]`` must permute ``range(K)``."""
    arts = _all_artifacts(ctx)
    bad = 0
    for a in arts:
        I, J, resid = _valid_lanes(a)
        lanes = np.concatenate([np.ravel(I), np.ravel(J), np.ravel(resid)])
        if lanes.size != a.K or not np.array_equal(np.sort(lanes), np.arange(a.K)):
            bad += 1
            yield Finding(
                rule="pairing/valid-permutation",
                severity="error",
                location=a.location,
                message=f"lane lists cover {lanes.size} lane(s) of K={a.K} and "
                        f"are not a permutation — the kernel would drop or "
                        f"double-count contraction lanes",
                measured=sorted(np.ravel(lanes).tolist())[:8],
                expected=f"permutation of range({a.K})",
            )
    yield Finding(
        rule="pairing/valid-permutation",
        severity="info",
        location=ctx.target,
        message=f"{len(arts) - bad}/{len(arts)} artifact blocks carry valid "
                f"lane permutations",
        measured=len(arts),
        expected=None,
    )


@rule("pairing/padding-consistent", needs=("pairing",))
def padding_consistent(ctx: RuleContext):
    """Padded (Pmax, Rmax) metadata: masks are prefix-shaped 0/1, padded
    lanes point at row 0, and I/J/mask shapes agree."""
    arts = [a for a in _all_artifacts(ctx) if a.pair_mask is not None]
    bad = 0
    for a in arts:
        problems = []
        if a.I.shape != a.J.shape or a.I.shape != a.pair_mask.shape:
            problems.append(
                f"pair shapes disagree: I{a.I.shape} J{a.J.shape} "
                f"mask{a.pair_mask.shape}"
            )
        if a.resid.shape != a.resid_mask.shape:
            problems.append(
                f"resid shapes disagree: resid{a.resid.shape} "
                f"mask{a.resid_mask.shape}"
            )
        for mask, idxs, tag in (
            (a.pair_mask, (a.I, a.J), "pair"),
            (a.resid_mask, (a.resid,), "resid"),
        ):
            m = np.ravel(mask)
            if not np.isin(m, (0.0, 1.0)).all():
                problems.append(f"{tag}_mask is not 0/1")
                continue
            nz = np.flatnonzero(m)
            if nz.size and (nz[-1] + 1 != nz.size):
                problems.append(f"{tag}_mask is not a prefix of ones")
            for idx in idxs:
                if idx.shape == mask.shape and np.any(np.ravel(idx)[m == 0] != 0):
                    problems.append(f"padded {tag} lanes do not point at row 0")
                    break
        if problems:
            bad += 1
            yield Finding(
                rule="pairing/padding-consistent",
                severity="error",
                location=a.location,
                message="; ".join(problems),
                measured=problems,
                expected="prefix 0/1 masks, zero-row padding, matching shapes",
            )
    yield Finding(
        rule="pairing/padding-consistent",
        severity="info",
        location=ctx.target,
        message=f"{len(arts) - bad}/{len(arts)} padded artifact blocks "
                f"consistent",
        measured=len(arts),
        expected=None,
    )


def _stack_problems(s: _Stack, K: int) -> list[str]:
    """What disagrees between one weight's stack of metadata and its
    weights: keys, layer count (and expert count), one (Pmax, Rmax) across
    the layers, indices inside K."""
    L = len(s.weights)
    have = [m for m in s.metas if m is not None]
    problems = []
    missing = sorted({k for m in have for k in META_KEYS if k not in m},
                     key=META_KEYS.index)
    if missing:
        problems.append(f"metadata keys missing: {missing}")
    E = s.weights[0].shape[0] if s.expert else None
    for k in META_KEYS:
        arrs = [_numpy(m[k]) for m in have if k in m]
        if len(arrs) != L:
            problems.append(f"{k} stacks {len(arrs)} layer(s), weight stacks {L}")
        elif s.expert and any(a.shape[0] != E for a in arrs):
            got = sorted({a.shape[0] for a in arrs})
            problems.append(f"{k} stacks ({len(arrs)}, {got}), weight stacks ({L}, {E})")
        shapes = sorted({a.shape for a in arrs})
        if len(shapes) > 1:
            problems.append(f"{k} has shapes {shapes} across the segment's layers")
        if k in ("I", "J", "resid"):
            sized = [a for a in arrs if a.size]
            lo = min((int(a.min()) for a in sized), default=0)
            hi = max((int(a.max()) for a in sized), default=0)
            if sized and (lo < 0 or hi >= K):
                problems.append(f"{k} indexes rows [{lo}, {hi}] outside the weight's K={K}")
    return problems


@rule("pairing/stacked-shapes", needs=("pairing",))
def stacked_shapes(ctx: RuleContext):
    """Each weight's metadata, stacked over its segment's layers, must agree
    with the weights it shadows: same keys, same layer count, one
    (Pmax, Rmax) on every layer, all indices inside the weight's K."""
    if ctx.params is None:
        return
    stacks = _stacks(ctx.params)
    bad = 0
    for s in stacks:
        K = _stack_K(s)
        problems = _stack_problems(s, K)
        if problems:
            bad += 1
            yield Finding(
                rule="pairing/stacked-shapes",
                severity="error",
                location=s.path,
                message="; ".join(problems),
                measured=problems,
                expected=f"(layers={len(s.weights)}, …) index arrays into K={K}",
            )
    yield Finding(
        rule="pairing/stacked-shapes",
        severity="info",
        location=ctx.target,
        message=f"{len(stacks) - bad}/{len(stacks)} stacked metadata entries "
                f"agree with their weights",
        measured=len(stacks),
        expected=None,
    )
