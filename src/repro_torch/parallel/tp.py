"""One rank's view of a tensor-parallel LM: which of its tensors are split.

The JAX package's partitioner reads the resolved specs and rewrites the
program; the port's forward reads a :class:`TensorParallel`, made once from
the same specs (:func:`layout_for`), and closes each split with a
collective (``models.layers`` and ``models.lm``).  The model-wide splits:

* ``vocab_split`` — the embedding's rows and the head's columns over
  ``model``: a masked lookup and an all-reduce; local logits and an
  all-gather;
* ``batch_split`` — the decode slots over data axes of more than one rank:
  each data row decodes its slots, and the logits are gathered over the
  data axes;
* ``cache_seq`` — the attention cache's positions (GQA's K/V, MLA's latent
  ``c_kv``/``k_rope``) over ``model`` (where no head axis claims it first):
  each rank attends its keys, the partial softmaxes are gathered and merged
  in fp32.

And each segment of layers' own (:meth:`TensorParallel.layer`; the
encoder's under :meth:`TensorParallel.encoder_view`), since a segment's
blocks resolve alike and segments differ (deepseek's dense first layer, its
MoE layers):

* ``q_split`` — the query heads over ``model`` (wq, its bias, MLA's
  ``w_uk``/``w_uv``, and wo's rows): wo's partial sums all-reduced in fp32;
* ``kv_split`` — the KV heads too (wk, wv, their biases, the cache's heads);
  where they are not, a rank's q heads read the global KV heads ``h // G``;
* ``xq_split`` / ``xkv_split`` — the same of the cross-attention (the
  cross cache ``xk``/``xv`` split with its KV heads);
* ``ff_split`` — the MLP's hidden columns (w_down's rows);
* ``experts_split`` / ``router_split`` / ``shared_split`` — the routed
  experts, the router's expert columns (its logits all-gathered) and the
  shared experts' hidden columns over ``model``; one all-reduce closes the
  routed and the shared partial sums together;
* ``ssm_in_split`` / ``ssm_heads_split`` — an SSM block's channels (w_z,
  w_x, conv_x, the gated norm, w_out's rows; the conv tail's channels) and
  its heads (w_dt, A_log, D, dt_bias; the state's heads).  Where both split
  a rank's channels are its heads'; where only the channels do (hymba's 50
  heads on 4 ranks), the conv'd channels are all-gathered and every rank
  steps all heads.  The gated norm's statistic is all-reduced either way.

A training rank's layout (:func:`train_layout_for`, from the ``train``
rules' specs; ``train`` set) splits the same weights and adds:

* ``seq_split`` — the decoder's residual stream over ``model`` (the
  ``train`` rules' ``seq``, where its ``meta_tokens + S`` positions
  divide): between sublayers a rank holds its chunk of them; an all-gather
  along the sequence enters each block (attention, MLA, an SSM block, a
  hybrid layer's two branches together, the cross-attention's query, the
  FFN), a reduce-scatter of the fp32 partial sums closes a block whose
  weights split (``models.layers.seq_enter``, ``close_partial``), and a
  block whose weights are whole keeps the rank's positions
  (``close_whole``).  The encoder's frames stay whole (its view has
  ``seq_split`` off): its blocks close with an all-reduce whose gradient is
  all-reduced too;
* ``batch_split`` — the batch's rows over the data axes: the loss's
  denominators and the router's statistics are summed over them, and so is
  every gradient after the backward.

Its gradients follow one rule: a rank's gradient of a tensor every rank
holds whole is its part of the whole gradient (its positions', its vocab
columns', its heads'), so the gradient of a weight left whole under
``model`` is summed over ``model`` after the backward, beside the split
weights' sum over the data axes.

FSDP (the rules put ``embed`` over ``data`` for a model past
``rules.FSDP_PARAM_THRESHOLD`` parameters; every mode): a rank holds its
(data × model) block of each weight whose spec splits it over a data axis,
and the forward gathers the blocks over those axes before it reads them
(``fsdp_axes``; ``gathers``, each layer's data-split leaves and the dim
each splits, a layer's in one ``parallel.collectives.gather_blocks`` call
at its top; ``top_gathers``, the embedding's, the head's and the final
norms').  The gathered model shard is the tensor-parallel shard the splits
above describe: every check below reads the specs with their data entries
taken out.  The gather's backward reduce-scatters the gradient over the
data axes, which sums a data-split block's gradient over them (the batch's
rows with it): a training rank's FSDP batch splits over the same axes.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

from repro_torch.configs.base import ModelConfig
from repro_torch.models.param import cache_axes_and_shapes, param_axes_and_shapes
from repro_torch.parallel.sharding import (
    DATA_AXES,
    Mesh,
    PartitionSpec,
    Rules,
    shardings_for,
    spec_for_axes,
)

MODEL_AXIS = "model"

#: the splits a segment of layers sets for itself (:meth:`TensorParallel.layer`)
LAYER_SPLITS = ("q_split", "kv_split", "xq_split", "xkv_split", "ff_split", "experts_split",
                "router_split", "shared_split", "ssm_in_split", "ssm_heads_split")


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    mesh: Mesh
    n_heads: int
    n_kv_heads: int
    vocab_split: bool
    q_split: bool
    kv_split: bool
    cache_seq: bool
    ff_split: bool
    experts_split: bool
    batch_split: bool
    xq_split: bool = False
    xkv_split: bool = False
    router_split: bool = False
    shared_split: bool = False
    ssm_in_split: bool = False
    ssm_heads_split: bool = False
    #: ((layer count, ((split, bool), …)), …) a segment of the decoder
    segment_splits: tuple = ()
    #: the encoder's ((split, bool), …), or None
    encoder_splits: tuple | None = None
    #: ((cache entry, its spec without the layers dim), …): the rank's cache
    cache_specs: tuple = ()
    #: a training rank's layout (:func:`train_layout_for`)
    train: bool = False
    #: training: the residual stream's positions split over ``model``
    seq_split: bool = False
    #: FSDP: the data axes the weights split over (empty: none)
    fsdp_axes: tuple = ()
    #: FSDP: ((leaf path in the layer, dim), …) of a layer's data-split
    #: leaves (set by the segment's view, :meth:`layer`)
    gathers: tuple = ()
    #: FSDP: ((parameter name, dim), …) of the data-split leaves outside the
    #: layers (``embed``, ``lm_head``, ``final_norm.*``, ``encoder.final_norm.*``)
    top_gathers: tuple = ()

    @property
    def model_group(self):
        return self.mesh.group(MODEL_AXIS) if MODEL_AXIS in self.mesh.shape else None

    @property
    def data_axes(self) -> tuple[str, ...]:
        return tuple(a for a in DATA_AXES if a in self.mesh.shape)

    @property
    def data_group(self):
        return self.mesh.group(self.data_axes) if self.data_axes else None

    @property
    def fsdp_group(self):
        """The process group the data-split weights gather over (None: no FSDP)."""
        return self.mesh.group(self.fsdp_axes) if self.fsdp_axes else None

    def top(self, prefix: str) -> tuple:
        """``top_gathers`` under ``prefix`` (``"embed"``, ``"final_norm."``, …),
        the prefix cut."""
        return tuple((name[len(prefix):], dim) for name, dim in self.top_gathers
                     if name.startswith(prefix))

    @property
    def mesh_group(self):
        """The process group of every rank of the mesh (None on one rank)."""
        return self.mesh.group(self.mesh.axis_names)

    @property
    def n(self) -> int:
        """Ranks along ``model``."""
        return self.mesh.shape.get(MODEL_AXIS, 1)

    @property
    def r(self) -> int:
        """This rank's index along ``model``."""
        return self.mesh.coords.get(MODEL_AXIS, 0) if MODEL_AXIS in self.mesh.shape else 0

    @property
    def dp(self) -> int:
        """Ranks along the data axes."""
        return self.mesh.axis_size(self.data_axes) if self.data_axes else 1

    @property
    def dr(self) -> int:
        """This rank's index along the data axes."""
        return self.mesh.index(self.data_axes) if self.data_axes else 0

    @property
    def local_heads(self) -> tuple[int, int]:
        """(first, count) of the query heads this rank computes."""
        if not self.q_split:
            return 0, self.n_heads
        per = self.n_heads // self.n
        return self.r * per, per

    @functools.cached_property
    def _layer_views(self) -> tuple[TensorParallel, ...]:
        return tuple(view for count, splits in self.segment_splits
                     for view in [dataclasses.replace(self, **dict(splits))] * count)

    def layer(self, i: int) -> TensorParallel:
        """The view of decoder layer ``i``: its segment's splits."""
        return self._layer_views[i]

    def encoder_view(self) -> TensorParallel:
        """The view of the encoder's layers."""
        if self.encoder_splits is None:
            raise ValueError("the layout has no encoder")
        return dataclasses.replace(self, **dict(self.encoder_splits))

    def own(self, size: int) -> slice:
        """This rank's chunk of ``size`` positions along ``model`` (the
        ``r``-th of ``n`` chunks; the first ``size % n`` chunks one longer):
        the positions whose loss and router statistics it counts."""
        per, extra = divmod(size, self.n)
        start = self.r * per + min(self.r, extra)
        return slice(start, start + per + (self.r < extra))

    def local_dim(self, name: str, dim: int, size: int) -> int:
        """The rank's length of dim ``dim`` (without the layers dim) of cache
        entry ``name`` whose whole length is ``size``."""
        entry = dict(self.cache_specs)[name][dim]
        return size // self.mesh.axis_size(entry) if entry is not None else size


def _on(spec, dim: int) -> bool:
    return spec[dim] is not None


def _refuse(cfg: ModelConfig, what: str) -> None:
    raise NotImplementedError(f"{cfg.name}: {what}; the port's tensor-parallel forward does "
                              "not close that split")


def _same(cfg: ModelConfig, block: dict, dims: dict[str, int], path: str) -> bool:
    """Whether the leaves ``dims`` (name → the dim of the split axis in the
    stacked spec) of ``block`` are all split or all whole; raises where they
    disagree (a split the forward cannot close)."""
    got = {name: _on(block[name], d) for name, d in dims.items() if name in block}
    if len(set(got.values())) > 1:
        _refuse(cfg, f"{path} splits {sorted(k for k, v in got.items() if v)} but not "
                     f"{sorted(k for k, v in got.items() if not v)}")
    return next(iter(got.values()), False)


def _whole(cfg: ModelConfig, block: dict, names, path: str) -> None:
    for name in names:
        spec = block.get(name)
        if spec is not None and any(e is not None for e in spec):
            _refuse(cfg, f"{path}.{name} is split {tuple(spec)}")


def _segment_splits(cfg: ModelConfig, seg: dict, path: str) -> dict[str, bool]:
    """One segment's splits from its resolved (stacked) specs."""
    out = dict.fromkeys(LAYER_SPLITS, False)
    attn = seg.get("attn")
    if attn is not None:
        if "w_dkv" in attn:  # MLA: the heads of wq, w_uk, w_uv and wo together
            out["q_split"] = _same(cfg, attn, {"wq": 2, "w_uk": 2, "w_uv": 2, "wo": 1},
                                   f"{path}.attn")
            _whole(cfg, attn, ("w_dkv", "w_kr", "kv_norm"), f"{path}.attn")
            if _on(attn["wq"], 3) or _on(attn["w_uk"], 1) or _on(attn["w_uv"], 3):
                _refuse(cfg, f"{path}.attn splits a head_dim or the latent rank")
        else:
            out["q_split"] = _same(cfg, attn, {"wq": 2, "bq": 1, "wo": 1}, f"{path}.attn")
            out["kv_split"] = _same(cfg, attn, {"wk": 2, "wv": 2, "bk": 1, "bv": 1},
                                    f"{path}.attn")
            if any(_on(attn[n], d) for n, d in (("wq", 3), ("wk", 3), ("wo", 2))):
                _refuse(cfg, f"{path}.attn splits a head_dim")
            if out["kv_split"] and not out["q_split"]:
                _refuse(cfg, f"{path}.attn splits its KV heads but not its query heads")
        _whole(cfg, attn, ("q_norm", "k_norm"), f"{path}.attn")
    xattn = seg.get("xattn")
    if xattn is not None:
        out["xq_split"] = _same(cfg, xattn, {"wq": 2, "wo": 1}, f"{path}.xattn")
        out["xkv_split"] = _same(cfg, xattn, {"wk": 2, "wv": 2}, f"{path}.xattn")
        if out["xkv_split"] and not out["xq_split"]:
            _refuse(cfg, f"{path}.xattn splits its KV heads but not its query heads")
    if "mlp" in seg:
        out["ff_split"] = _same(cfg, seg["mlp"], {"w_gate": 2, "w_up": 2, "w_down": 1},
                                f"{path}.mlp")
    moe = seg.get("moe")
    if moe is not None:
        out["experts_split"] = _same(cfg, moe, {"w_gate": 1, "w_up": 1, "w_down": 1},
                                     f"{path}.moe")
        out["router_split"] = _on(moe["router"], 2)
        if any(_on(moe[n], d) for n, d in (("w_gate", 3), ("w_up", 3), ("w_down", 2))):
            _refuse(cfg, f"{path}.moe splits an expert's hidden columns")
        if "shared" in moe:
            out["shared_split"] = _same(cfg, moe["shared"], {"w_gate": 2, "w_up": 2,
                                                             "w_down": 1}, f"{path}.moe.shared")
    mamba = seg.get("mamba")
    if mamba is not None:
        out["ssm_in_split"] = _same(cfg, mamba, {"w_z": 2, "w_x": 2, "conv_x": 2, "norm": 1,
                                                 "w_out": 1}, f"{path}.mamba")
        out["ssm_heads_split"] = _same(cfg, mamba, {"w_dt": 2, "A_log": 1, "D": 1,
                                                    "dt_bias": 1}, f"{path}.mamba")
        _whole(cfg, mamba, ("w_B", "w_C", "conv_B", "conv_C"), f"{path}.mamba")
        if out["ssm_heads_split"] and not out["ssm_in_split"]:
            _refuse(cfg, f"{path}.mamba splits its heads but not their channels")
        if out["ssm_heads_split"] and cfg.ssm.n_groups > 1:
            _refuse(cfg, f"{path}.mamba splits the heads of {cfg.ssm.n_groups} B/C groups")
    for block in ("ln1", "ln2", "lnx", "ln_attn_out", "ln_ssm_out"):
        if block in seg:
            _whole(cfg, seg[block], ("scale", "bias"), f"{path}.{block}")
    return out


def _cache_splits(cfg: ModelConfig, c_seg: dict, splits: dict[str, bool], path: str
                  ) -> tuple[bool, dict]:
    """A cache segment's position split and its entries' specs (without the
    layers dim), checked against the segment's weight splits: the cache
    holds what the rank's projections write."""
    specs = {name: tuple(spec[1:]) for name, spec in c_seg.items()}
    seq = None
    for name in ("k", "v", "c_kv", "k_rope"):
        if name not in specs:
            continue
        spec = specs[name]  # (batch, cache_seq, kv_heads, head_dim) or (batch, cache_seq, R)
        if any(e is not None for e in spec[3 if name in ("k", "v") else 2:]):
            _refuse(cfg, f"{path}.{name} splits its {'head_dim' if name in ('k', 'v') else 'width'}"
                         f" {spec}")
        if name in ("k", "v") and _on(spec, 2) != splits["kv_split"]:
            _refuse(cfg, f"the cache split {spec} of {path}.{name} that its KV projections' do "
                         "not match")
        seq = _on(spec, 1) if seq is None else seq
        if _on(spec, 1) != seq:
            _refuse(cfg, f"{path}: the attention cache's entries split their positions unlike")
    for name in ("xk", "xv"):
        if name in specs:
            spec = specs[name]  # (batch, frames, kv_heads, head_dim)
            if _on(spec, 1) or _on(spec, 3) or _on(spec, 2) != splits["xkv_split"]:
                _refuse(cfg, f"the cross cache split {spec} of {path}.{name} that its KV "
                             "projections' do not match")
    if "h" in specs:  # (batch, ssm_heads, head_dim, ssm_state)
        if _on(specs["h"], 2) or _on(specs["h"], 3) or (
                _on(specs["h"], 1) != splits["ssm_heads_split"]):
            _refuse(cfg, f"the SSM state split {specs['h']} of {path} that its heads' do not "
                         "match")
        if _on(specs["conv_x"], 1) or _on(specs["conv_x"], 2) != splits["ssm_in_split"]:
            _refuse(cfg, f"the conv tail split {specs['conv_x']} of {path} that its channels' "
                         "do not match")
        for name in ("conv_B", "conv_C"):
            if any(e is not None for e in specs[name][1:]):
                _refuse(cfg, f"{path}.{name} is split {specs[name]}")
    return bool(seq), specs


def _with_leaves(tree, fn, path: tuple = ()):
    """``fn(path, spec)`` over every leaf of a spec tree (dicts and lists)."""
    if isinstance(tree, dict):
        return {k: _with_leaves(v, fn, (*path, k)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_with_leaves(v, fn, (*path, i)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _fsdp(cfg: ModelConfig, specs: dict, mesh: Mesh) -> tuple[dict, dict]:
    """The weights' specs with their data-axis entries taken out (the gathered
    model shard's: what the tensor-parallel forward reads) and the FSDP
    fields of :class:`TensorParallel`: ``fsdp_axes``, the ``gathers`` of
    each segment and of the encoder (leaf path in the layer, its dim
    without the layers dim) and the ``top_gathers``.  A data axis of one
    rank splits nothing.  Raises where a leaf splits a dim over data and
    ``model`` at once, two dims over data axes, or where the leaves split
    over different data axes, and for a data-split ``meta`` or
    ``vision_proj`` (the forward does not gather them)."""
    splits: dict[tuple, tuple[int, Any]] = {}

    def strip(path: tuple, spec) -> PartitionSpec:
        out = []
        for dim, e in enumerate(spec):
            names = () if e is None else (e,) if isinstance(e, str) else tuple(e)
            on_data = all(a in DATA_AXES for a in names)
            data = [a for a in names if a in DATA_AXES and mesh.axis_size(a) > 1]
            if data and not on_data:
                _refuse(cfg, f"{'.'.join(map(str, path))} splits dim {dim} over {e} (data and "
                             "model together)")
            if data:
                if path in splits:
                    _refuse(cfg, f"{'.'.join(map(str, path))} splits two dims over data axes")
                splits[path] = (dim, e)
            out.append(None if names and on_data else e)
        return PartitionSpec(*out)

    model_specs = _with_leaves(specs, strip)
    entries = {e for _, e in splits.values()}
    if len(entries) > 1:
        _refuse(cfg, f"the weights split over unlike data axes {sorted(map(str, entries))}")
    for name in ("meta", "vision_proj"):
        if (name,) in splits:
            _refuse(cfg, f"{name} splits over {splits[(name,)][1]!r} (FSDP): the forward "
                         "gathers the layers, the embedding, the head and the norms only")

    def layer_gathers(prefix: tuple) -> tuple:
        return tuple((".".join(path[len(prefix):]), dim - 1) for path, (dim, _) in splits.items()
                     if path[:len(prefix)] == prefix)

    n_segments = len(specs["segments"])
    info = {"fsdp_axes": next(iter(entries), ()),
            "segments": [layer_gathers(("segments", si)) for si in range(n_segments)],
            "encoder": layer_gathers(("encoder", "segments", 0)) if "encoder" in specs else (),
            "top_gathers": tuple((".".join(path), dim) for path, (dim, _) in splits.items()
                                 if path[0] in ("embed", "lm_head", "final_norm")
                                 or path[:2] == ("encoder", "final_norm"))}
    if isinstance(info["fsdp_axes"], str):
        info["fsdp_axes"] = (info["fsdp_axes"],)
    return model_specs, info


def fsdp_layout(cfg: ModelConfig, mesh: Mesh, rules: Rules) -> dict:
    """The FSDP fields of the weights' resolved specs (``fsdp_axes``; the
    ``gathers`` of each segment, ``"segments"``, and of the encoder,
    ``"encoder"``; the ``top_gathers``), all empty without FSDP."""
    axes, shapes = param_axes_and_shapes(cfg)
    return _fsdp(cfg, shardings_for(axes, mesh, rules, shapes), mesh)[1]


def train_layout_for(cfg: ModelConfig, mesh: Mesh, rules: Rules, batch_size: int,
                     seq_len: int) -> TensorParallel:
    """The :class:`TensorParallel` of one training rank of ``cfg`` on
    ``mesh`` under ``rules`` (``rules_for(cfg, "train", mesh)``) for global
    batches of ``batch_size`` rows of ``seq_len`` tokens: each segment's
    weight splits as :func:`layout_for` reads them (MLA's heads, the shared
    experts' and an SSM block's columns and heads among them), the
    encoder's, ``batch_split`` where the activations' ``batch`` axis splits
    over data axes, ``seq_split`` where their ``seq`` axis splits
    (``spec_for_axes`` of ``("batch", "seq", "embed")`` at the decoder's
    stream, ``meta_tokens + seq_len`` positions: a stream that does not
    divide ``model`` stays whole, as a weight that does not divide does).
    The encoder's view keeps its frames whole (the ``train`` rules give
    ``frames`` no mesh axis): its blocks close with an all-reduce.  Raises
    ``NotImplementedError`` for any split :func:`layout_for` refuses, and
    for FSDP weights whose data axes the batch does not split over (the
    gather's reduce-scatter would count a whole batch's gradient once a data
    rank)."""
    axes, shapes = param_axes_and_shapes(cfg)
    specs, fsdp = _fsdp(cfg, shardings_for(axes, mesh, rules, shapes), mesh)
    seg_splits, enc = _weight_splits(cfg, specs, fsdp)
    if enc is not None:
        enc = (*enc, ("seq_split", False))
    act = spec_for_axes(("batch", "seq", "embed"), mesh=mesh, rules=rules,
                        dim_sizes=(batch_size, cfg.meta_tokens + seq_len, cfg.d_model))
    batch_axes = () if act[0] is None else (act[0],) if isinstance(act[0], str) else act[0]
    if not set(fsdp["fsdp_axes"]) <= set(batch_axes):
        _refuse(cfg, f"the weights split over {fsdp['fsdp_axes']} (FSDP) but the batch of "
                     f"{batch_size} rows does not")
    if act[2] is not None:
        _refuse(cfg, f"the residual stream's width is split {tuple(act)}")
    if act[1] not in (None, MODEL_AXIS):
        _refuse(cfg, f"the sequence is split over {act[1]!r}, not 'model'")
    first = dict(seg_splits[0][1])
    return TensorParallel(
        mesh=mesh, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        vocab_split=_on(specs["embed"], 0), cache_seq=False,
        batch_split=act[0] is not None and mesh.axis_size(act[0]) > 1,
        segment_splits=tuple(seg_splits), encoder_splits=enc, train=True,
        seq_split=act[1] is not None, fsdp_axes=fsdp["fsdp_axes"],
        top_gathers=fsdp["top_gathers"], **first)


def _weight_splits(cfg: ModelConfig, specs: dict, fsdp: dict) -> tuple[list, tuple | None]:
    """Each segment's ``(count, ((split, value), …))`` and the encoder's
    splits, read from the weights' specs without their data entries, each
    with its ``gathers``."""
    _whole(cfg, specs["final_norm"], ("scale", "bias"), "final_norm")
    for name in ("meta", "vision_proj"):
        if name in specs and any(e is not None for e in specs[name]):
            _refuse(cfg, f"{name} is split {tuple(specs[name])}")
    seg_splits = [(count, (*_segment_splits(cfg, seg, f"segments[{si}]").items(),
                           ("gathers", fsdp["segments"][si])))
                  for si, ((_, count), seg) in enumerate(zip(cfg.segments(), specs["segments"],
                                                             strict=True))]
    enc = None
    if "encoder" in specs:
        _whole(cfg, specs["encoder"]["final_norm"], ("scale", "bias"), "encoder.final_norm")
        enc = (*_segment_splits(cfg, specs["encoder"]["segments"][0],
                                "encoder.segments[0]").items(), ("gathers", fsdp["encoder"]))
    return seg_splits, enc


def layout_for(cfg: ModelConfig, mesh: Mesh, rules: Rules, batch_size: int,
               max_seq: int) -> TensorParallel:
    """The :class:`TensorParallel` of ``cfg`` served on ``mesh`` under
    ``rules`` with ``batch_size`` slots of ``max_seq`` positions, read from
    the resolved specs of every segment's weights and cache entries, and of
    the encoder's weights.  Raises ``NotImplementedError`` where the specs
    ask for a split the port's forward does not close (and names it): a
    head_dim, half of a block's leaves split and half whole, a cache entry
    split unlike the projection that writes it, a dim split over data and
    ``model`` at once.  Weights split over data axes (FSDP) are gathered
    over them before the forward reads them (``gathers``, ``top_gathers``)."""
    axes, shapes = param_axes_and_shapes(cfg)
    specs, fsdp = _fsdp(cfg, shardings_for(axes, mesh, rules, shapes), mesh)
    c_axes, c_shapes = cache_axes_and_shapes(cfg, batch_size, max_seq)
    c_specs = shardings_for(c_axes, mesh, rules, c_shapes)
    seg_splits, enc = _weight_splits(cfg, specs, fsdp)
    seqs, cache_specs = set(), {}
    for si, ((_, splits), cseg) in enumerate(zip(seg_splits, c_specs["segments"], strict=True)):
        seq, entry_specs = _cache_splits(cfg, cseg, dict(splits), f"cache segments[{si}]")
        if any(n in cseg for n in ("k", "c_kv")):
            seqs.add(seq)
        for name, spec in entry_specs.items():
            if cache_specs.setdefault(name, spec) != spec:
                _refuse(cfg, f"cache entry {name} splits unlike in two segments")
    if len(seqs) > 1:
        _refuse(cfg, "the attention cache splits its positions in some segments only")
    batch = {s[0] for s in cache_specs.values()}
    if len(batch) > 1:
        _refuse(cfg, "the cache entries split their slots unlike")
    b = next(iter(batch), None)
    first = dict(seg_splits[0][1])
    return TensorParallel(
        mesh=mesh, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        vocab_split=_on(specs["embed"], 0), cache_seq=bool(seqs and seqs.pop()),
        batch_split=b is not None and mesh.axis_size(b) > 1,
        segment_splits=tuple(seg_splits), encoder_splits=enc,
        cache_specs=tuple(cache_specs.items()), fsdp_axes=fsdp["fsdp_axes"],
        top_gathers=fsdp["top_gathers"], **first)
