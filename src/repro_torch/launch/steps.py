"""The LM step builders: training, prefill and decode.

The port of ``repro.launch.steps`` ``build_train_step``,
``build_prefill_step`` and ``build_serve_step``, and of ``wire_serve_cell``,
which wires one rank of a tensor-parallel serve cell over a
``parallel.sharding.Mesh``, and of the dry run's ``wire_cell`` /
``LoweredCell``, ``abstract_opt_state`` and ``opt_state_axes`` (one rank's
step of a cell wired and run on fake tensors, ``launch.dryrun``; the other
abstract-shape builders have ``models.param``'s axes and shapes).  The
training step runs on one device, or as one rank of a mesh
(``build_train_step(cfg, opt, knobs, mesh, rules)``, the JAX signature):
the rank holds its shards of the ``train`` rules' specs, paired
per shard, runs the sequence- and tensor-parallel forward and backward of
``parallel.tp.train_layout_for``, sums the gradients over the mesh and
clips by the whole model's norm (:class:`TrainStep`).  Each step runs
under ``kernels.ops.tile_cache_context(knobs)`` (the tile cache is read
once, when the step is built), as the JAX package's steps run under
``perf_context(knobs)``; the serving steps live in ``serving.steps`` and
run without autograd.  The GEMM
policy comes from ``knobs``, as the JAX package's ``perf_context(knobs)``
sets it: under ``gemm="pallas"`` every layer GEMM's forward is a launch of
K1's dense form, under ``"pallas_paired"`` every weight that carries
pairing metadata is one of K1's paired forms, an MoE layer's experts one
launch a projection over the expert grid; the backward is ``torch.matmul``
or ``torch.einsum`` on the folded weights either way (``kernels.ops``).
Every family trains on one device: dense, MoE (olmoe, deepseek with MLA and
shared experts), SSM, hybrid, encoder-decoder and vision-language models,
the last two with their ``frames`` or ``patches`` in the batch; and on a
mesh too (the ``meta`` tokens, ``vision_proj`` and the encoder's weights
among the rank's parameters), FSDP's data-split weights as well (each
layer gathered over the data axes, its gradient reduce-scattered).  A mesh
rank builds only its own shards (:func:`local_model`: each whole leaf of
the source exists while its block is taken and it is paired).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import time
from collections.abc import Callable
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.transform import (
    has_lm_pairing,
    pair_shard_params,
    premade_entry,
    row_lead_dim,
    tp_shard_plan,
)
from repro_torch.kernels import ops, tuning
from repro_torch.models import layers as Lyr
from repro_torch.models import lm as M
from repro_torch.models.param import (
    cache_axes_and_shapes,
    pairing_axes,
    param_axes_and_shapes,
)
from repro_torch.parallel.collectives import all_gather, all_reduce
from repro_torch.parallel.rules import rules_for
from repro_torch.parallel.sharding import (
    DATA_AXES,
    Mesh,
    PartitionSpec,
    Rules,
    paired_shardings_for,
    record_spec_fallbacks,
    shardings_for,
    spec_for_axes,
)
from repro_torch.parallel.tp import (
    MODEL_AXIS,
    TensorParallel,
    fsdp_layout,
    layout_for,
    train_layout_for,
)
from repro_torch.train.optimizer import mesh_global_norm
from repro_torch.serving.steps import (  # noqa: F401  (the JAX module's three builders)
    build_prefill_step,
    build_serve_step,
    load_knobs_tile_cache,
)


@dataclasses.dataclass(frozen=True)
class TrainStep:
    """``step(model, opt_state, step, batch) -> metrics``: the gradient of
    ``lm_loss`` and one optimizer update, as step ``step`` (the index the
    JAX package passes to ``opt.update``; the schedule and bias corrections
    see ``step + 1``).  ``opt_state`` is the optimizer :meth:`init` builds,
    which holds the moments and updates the model's weights in place.
    ``metrics`` holds ``loss``, ``xent`` and ``aux``, detached fp32 scalars
    on the device.

    With a ``mesh`` the step is one rank's: ``model`` is the rank's part
    (:meth:`shard`), ``batch`` the global batch, of which the rank takes its
    rows; the loss and metrics are the global batch's, the same on every
    rank.  After the backward each gradient is summed over the data axes
    that split the batch, and a weight left whole under ``model`` also over
    ``model`` (each rank's is its part: ``parallel.tp``), in one all-reduce
    a group; the optimizer clips by the whole model's norm
    (``train.optimizer.mesh_global_norm``), so every rank's update of a
    weight it shares is the same."""

    cfg: ModelConfig
    opt: Callable[..., torch.optim.Optimizer]  # train.optimizer.adamw(...) or sgd(...)
    knobs: M.PerfKnobs
    tile_cache: tuning.TileCache | None = None  # the one knobs.tile_cache names
    mesh: Mesh | None = None
    rules: Rules | None = None
    #: the layouts by (batch, seq), and the weights' resolved specs
    _layouts: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    def shard(self, source, fold=None) -> TrainCell:
        """This rank's part of the model ``source`` names, the same on every
        rank (an ``init_lm`` seed, the JAX package's value tree, or the whole
        unpaired model: ``models.lm.lm_leaves``), built leaf by leaf
        (:func:`local_model`): each weight sliced by its resolved ``train``
        spec and, under ``gemm="pallas_paired"``, paired per shard (no pair
        crosses a shard boundary), as :func:`wire_serve_cell` wires a serve
        cell; each whole leaf first through ``fold`` where it is given
        (:func:`local_model`)."""
        if self.mesh is None:
            raise ValueError("a step without a mesh trains the whole model")
        local, _, report, _, seconds = _shard_and_pair(self.cfg, source, self.mesh, self.rules,
                                                       self.knobs, fold=fold)
        return TrainCell(local, report, seconds)

    def layout(self, batch_size: int, seq_len: int) -> TensorParallel:
        """The rank's :func:`~repro_torch.parallel.tp.train_layout_for` for
        global batches of ``batch_size`` × ``seq_len`` tokens."""
        key = (batch_size, seq_len)
        if key not in self._layouts:
            self._layouts[key] = train_layout_for(self.cfg, self.mesh, self.rules, batch_size,
                                                  seq_len)
        return self._layouts[key]

    def param_specs(self, model: M.LM) -> dict[str, PartitionSpec]:
        """Each of the rank's parameters (by name) and its resolved spec."""
        if "specs" not in self._layouts:
            axes, shapes = param_axes_and_shapes(self.cfg)
            self._layouts["specs"] = shardings_for(axes, self.mesh, self.rules, shapes)
        return named_specs(model, self._layouts["specs"])

    def init(self, model: M.LM) -> torch.optim.Optimizer:
        """Make ``model``'s weights trainable and build the optimizer over
        them (the JAX package's ``opt.init(params)``).  Copies of the model
        share these weights; the serving engines run under ``no_grad``, so
        theirs track nothing.  On a mesh the optimizer clips by the norm of
        the whole model: each weight's squares summed over the mesh axes that
        split it (``model``, FSDP's data axes, both)."""
        model.requires_grad_(True)
        opt = self.opt(list(model.parameters()))
        if self.mesh is not None:
            specs = self.param_specs(model)
            over = [_split_axes(specs[n], self.mesh) for n, _ in model.named_parameters()]
            keys = {axes for axes in over if axes} | {(MODEL_AXIS,)}  # every split over model
            opt.norm_fn = functools.partial(
                mesh_global_norm, split=over,
                groups={axes: self.mesh.group(axes) for axes in keys
                        if self.mesh.group(axes) is not None})
        return opt

    def __call__(self, model: M.LM, opt_state: torch.optim.Optimizer, step: int,
                 batch: dict, *, block_of: tuple[int, int] | None = None
                 ) -> dict[str, torch.Tensor]:
        """``block_of=(B, S)`` (a mesh rank): ``batch`` is the rank's block of
        a global batch of B × S tokens by its resolved specs
        (``launch.inputs.batch_logical_axes`` under the rules), as the JAX
        package's sharded step takes it: the rank's rows, and its positions
        of the ids where the ``seq`` axis splits them, which the step
        all-gathers (one call for the tokens and labels together)."""
        opt_state.zero_grad(set_to_none=True)
        tp = None
        if self.mesh is not None and block_of is not None:
            tp = self.layout(*block_of)
            batch = self._whole_rows(batch, *block_of)
        elif self.mesh is not None:
            tp = self.layout(*batch["tokens"].shape)
            if tp.batch_split:
                rows = batch["tokens"].shape[0] // tp.dp
                batch = {k: v[tp.dr * rows:(tp.dr + 1) * rows] for k, v in batch.items()}
        with ops.tile_cache_context(self.knobs, self.tile_cache):
            loss, metrics = M.lm_loss(self.cfg, model, batch, knobs=self.knobs, tp=tp)
            loss.backward()
        if tp is not None:
            self._sum_grads(model, tp)
        for group in opt_state.param_groups:
            group["step"] = int(step)
        opt_state.step()
        return {"loss": loss.detach(), **{k: v.detach() for k, v in metrics.items()}}

    def _whole_rows(self, block: dict, batch_size: int, seq_len: int) -> dict:
        """The rank's rows of the ids over all ``seq_len`` positions, from its
        block: the tokens and labels gathered along the sequence over the
        mesh axes the ``seq`` axis splits them on (none where it does not)."""
        seq = spec_for_axes(("batch", "seq"), mesh=self.mesh, rules=self.rules,
                            dim_sizes=(batch_size, seq_len))[1]
        if seq is None or block["tokens"].shape[1] == seq_len:
            return block
        ids = all_gather(torch.stack([block["tokens"], block["labels"]]),
                         self.mesh.group(seq), dim=2)
        return dict(block, tokens=ids[0], labels=ids[1])

    def _sum_grads(self, model: M.LM, tp: TensorParallel) -> None:
        """Sum the rank's gradients over the mesh: a weight's over ``model``
        where it is whole there, and over the data axes that split the batch
        where it is whole there; one all-reduce of the flattened gradients a
        group of axes (none over a group of one rank).  A block FSDP splits
        over data axes has its gradient summed over them already, by the
        gather's reduce-scatter (``parallel.collectives.gather_blocks``)."""
        specs = self.param_specs(model)
        batch = tp.data_axes if tp.batch_split else ()
        groups: dict[tuple, list] = {}
        for name, p in model.named_parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            split = _split_axes(specs[name], self.mesh)
            axes = tuple(a for a in self.mesh.axis_names
                         if a not in split and (a == MODEL_AXIS or a in batch))
            groups.setdefault(axes, []).append(p.grad)
        for axes, grads in groups.items():
            group = self.mesh.group(axes) if axes else None
            if group is None:
                continue
            flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), group)
            for g, part in zip(grads, flat.split([g.numel() for g in grads]), strict=True):
                g.copy_(part.view_as(g))

    def whole(self, model: M.LM):
        """``fn(name, t)``: the whole tensor of the rank's parameter ``name``
        (or its optimizer moment) ``t``, all-gathered over ``model`` along
        its split dim (a checkpoint stores whole arrays)."""
        specs = self.param_specs(model)

        def fn(name: str, t: torch.Tensor) -> torch.Tensor:
            t = t.detach()
            for dim, entry in enumerate(specs[name]):
                if entry is not None:
                    t = all_gather(t, self.mesh.group(entry), dim=dim)
            return t

        return fn

    def take(self, model: M.LM):
        """``fn(name, array)``: the rank's block of the whole array saved
        for parameter ``name`` (or its moment), by its resolved spec."""
        specs = self.param_specs(model)
        return lambda name, a: _take(torch.as_tensor(a), specs[name], self.mesh)


def _split_axes(spec, mesh: Mesh) -> tuple[str, ...]:
    """The mesh axes (of more than one rank) a resolved spec splits its
    tensor over, in the mesh's order."""
    used = {a for e in spec if e is not None for a in ((e,) if isinstance(e, str) else e)}
    return tuple(a for a in mesh.axis_names if a in used and mesh.shape[a] > 1)


@dataclasses.dataclass
class TrainCell:
    """One training rank's part of a model: the sliced (and per-shard
    paired) ``model``, the pairing report and the wiring's seconds
    (``"build"``, ``"pair"``: :func:`_shard_and_pair`)."""

    model: M.LM
    pair_report: Any
    seconds: dict


def named_specs(model: M.LM, specs: dict) -> dict[str, PartitionSpec]:
    """``model.named_parameters()``'s names mapped to their resolved specs
    (``specs``: ``shardings_for`` of ``models.param.param_axes``; a stacked
    layer weight's spec without its ``"layers"`` entry)."""
    out = {name: specs[name] for name in ("embed", "lm_head", "meta", "vision_proj")
           if getattr(model, name, None) is not None}

    def stack(prefix: str, layers, segments, seg_specs) -> None:
        start = 0
        for (_, count), seg in zip(segments, seg_specs, strict=True):
            for i in range(start, start + count):
                for name, _ in layers[i].named_parameters():
                    node = seg
                    for part in name.split("."):
                        node = node[part]
                    out[f"{prefix}.{i}.{name}"] = PartitionSpec(*node[1:])
            start += count

    for name, _ in model.final_norm.named_parameters():
        out[f"final_norm.{name}"] = specs["final_norm"][name]
    stack("layers", model.layers, model.segments, specs["segments"])
    if model.encoder is not None:
        enc = model.encoder
        stack("encoder.layers", enc.layers, enc.segments, specs["encoder"]["segments"])
        for name, _ in enc.final_norm.named_parameters():
            out[f"encoder.final_norm.{name}"] = specs["encoder"]["final_norm"][name]
    return out


def build_train_step(cfg: ModelConfig, opt: Callable[..., torch.optim.Optimizer],
                     knobs: M.PerfKnobs, mesh: Mesh | None = None,
                     rules: Rules | None = None) -> TrainStep:
    """The training step of ``cfg`` under ``knobs`` with optimizer ``opt``
    (a constructor over the parameters, the JAX package's ``Optimizer``);
    with a ``mesh`` (made by ``parallel.sharding.make_mesh``), one rank's
    step under ``rules`` (``rules_for(cfg, "train", mesh)`` unless given).
    Raises ``NotImplementedError`` on a mesh for ``attn="pallas_fused"``
    (K3 has no backward) and for any split the forward does not close
    (``parallel.tp.train_layout_for`` names it); FSDP's data-split weights
    train (each layer gathered over the data axes)."""
    if mesh is None:
        return TrainStep(cfg, opt, knobs, load_knobs_tile_cache(knobs))
    if knobs.attn != "xla":
        raise NotImplementedError("attn='pallas_fused' does not train: the flash-attention "
                                  "kernel has no backward, so the mesh trains under "
                                  "attn='xla'")
    rules = rules or rules_for(cfg, "train", mesh)
    # the refusals, before any wiring (a batch of a row a data rank; the
    # fallbacks this probe's one position takes are no step's)
    with record_spec_fallbacks():
        train_layout_for(cfg, mesh, rules, mesh.axis_size(tuple(a for a in DATA_AXES
                                                                if a in mesh.shape)), 1)
    return TrainStep(cfg, opt, knobs, load_knobs_tile_cache(knobs), mesh, rules)


# ---------------------------------------------------------------------------
# one rank of a tensor-parallel serve cell
# ---------------------------------------------------------------------------

def _take(t: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec``: each split dim narrowed to
    the rank's chunk along its mesh axes, copied (so the whole can go)."""
    for dim, entry in enumerate(spec):
        if entry is not None:
            size = t.shape[dim] // mesh.axis_size(entry)
            t = t.narrow(dim, mesh.index(entry) * size, size)
    return t.detach().clone()


def leaf_specs(cfg: ModelConfig, specs: dict) -> dict[str, PartitionSpec]:
    """Each parameter name of the model of ``cfg`` (``named_parameters``')
    mapped to its resolved spec (``specs``: ``shardings_for`` of
    ``models.param.param_axes``), a layer weight's without its ``"layers"``
    entry."""
    out = {}

    def leaves(tree: dict, prefix: str, stacked: bool) -> None:
        for k, v in tree.items():
            if isinstance(v, dict):
                leaves(v, f"{prefix}{k}.", stacked)
            else:
                out[f"{prefix}{k}"] = PartitionSpec(*v[1:]) if stacked else v

    def stack(prefix: str, segments, seg_specs) -> None:
        start = 0
        for (_, count), seg in zip(segments, seg_specs, strict=True):
            for i in range(start, start + count):
                leaves(seg, f"{prefix}.{i}.", True)
            start += count

    leaves({k: v for k, v in specs.items() if k not in ("segments", "encoder")}, "", False)
    stack("layers", cfg.segments(), specs["segments"])
    if "encoder" in specs:
        stack("encoder.layers", (("encoder", cfg.encoder.n_layers),),
              specs["encoder"]["segments"])
        leaves(specs["encoder"]["final_norm"], "encoder.final_norm.", False)
    return out


#: what a rank building its blocks leaf by leaf (:func:`local_model`) holds
#: on its device beside them at most, in its largest whole leaf's bytes: the
#: leaf being built, and a workspace of one more for its pairing (the rows
#: the pairing reads, and the allocator's rounding)
WIRING_WHOLE_LEAVES = 2


def local_model(cfg: ModelConfig, source, specs: dict, mesh: Mesh, *, on_leaf=None,
                fold=None) -> M.LM:
    """This rank's part of the model ``source`` names (``models.lm.lm_leaves``:
    an ``init_lm`` seed, the JAX package's value tree, or the whole model),
    built leaf by leaf on the rank's device (``models.lm.init_lm_local``):
    each whole leaf is made, the rank's block of it taken by its resolved
    spec (``specs``, as :func:`shard_model` reads them), ``on_leaf(name,
    whole, block, spec)`` called (the pairing of the leaf while it is whole),
    and the whole dropped; so a rank holds its blocks, and one whole leaf
    beside them.  Its blocks are :func:`shard_model`'s of the whole model,
    bit for bit.  ``fold(name, whole)`` first replaces each whole leaf
    (``core.transform.leaf_folder``: the train CLI's ``--paired-rounding``;
    its workspace is the fold's, beside the whole leaf)."""
    by_name = leaf_specs(cfg, specs)

    def keep(name: str, whole: torch.Tensor) -> torch.Tensor:
        if fold is not None:
            whole = fold(name, whole)
        block = _take(whole, by_name[name], mesh)
        if on_leaf is not None:
            on_leaf(name, whole, block, by_name[name])
        return block

    return M.init_lm_local(cfg, source, keep, device=mesh.device)


def held_bytes(model: M.LM) -> int:
    """The bytes a rank's model holds on its device: its weights (its
    blocks) and their pairing metadata (its own and the data-gathered)."""
    metas = [meta for block in model.modules()
             for group in (getattr(block, "pairing", {}), getattr(block, "gathered", {}))
             for meta in group.values()]
    return (sum(p.numel() * p.element_size() for p in model.parameters())
            + sum(t.numel() * t.element_size() for meta in metas for t in meta.values()))


def wiring_excess(rec: dict) -> float | None:
    """How far a rank's wiring peak (``wire_peak_bytes``, on the card) passes
    the bound of building its blocks leaf by leaf: what it holds after the wiring
    (``held_bytes``: its blocks, their metadata, a serve cell's cache) plus
    :data:`WIRING_WHOLE_LEAVES` of its largest whole leaf
    (``leaf_bytes``); ≤ 0 within it, None off the card."""
    if rec.get("wire_peak_bytes") is None:
        return None
    return rec["wire_peak_bytes"] - rec["held_bytes"] - WIRING_WHOLE_LEAVES * rec["leaf_bytes"]


def largest_leaf_bytes(cfg) -> int:
    """The fp32 bytes of the largest per-layer weight of ``cfg`` (a layer
    weight without its layers axis): the one whole leaf a rank that builds
    its blocks leaf by leaf holds beside them."""
    _, shapes = param_axes_and_shapes(cfg)
    out = 0

    def walk(tree, stacked: bool) -> None:
        nonlocal out
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, stacked)
            elif isinstance(v, list):
                for seg in v:
                    walk(seg, True)
            else:
                out = max(out, 4 * (v.numel() // (v.shape[0] if stacked else 1)))

    walk(shapes, False)
    return out


def shard_model(model: M.LM, specs: dict, mesh: Mesh) -> M.LM:
    """The rank's part of ``model``: every weight sliced by its resolved spec
    (``specs``, :func:`~repro_torch.parallel.sharding.shardings_for` of
    ``models.param.param_axes``; a stacked layer weight's spec without its
    ``"layers"`` entry), the encoder's by its own, the router's expert
    columns too; the ``meta`` tokens and ``vision_proj`` as their specs
    give them (whole); new tensors on the weights' device, no pairing
    metadata."""

    def block(b: Lyr.Block, spec_tree: dict, stacked: bool) -> Lyr.Block:
        weights = {name: _take(t, spec_tree[name][1:] if stacked else spec_tree[name], mesh)
                   for name, t in b.named_parameters(recurse=False)}
        kids = {n: block(c, spec_tree[n], stacked) for n, c in b.named_children()}
        return type(b)(**weights, **kids)

    def stack(all_layers, segments, seg_specs) -> list[Lyr.DecoderLayer]:
        layers, start = [], 0
        for (_, count), seg in zip(segments, seg_specs, strict=True):
            for layer in all_layers[start:start + count]:
                layers.append(Lyr.DecoderLayer(**{n: block(c, seg[n], True)
                                                 for n, c in layer.named_children()}))
            start += count
        return layers

    top = {name: _take(getattr(model, name), specs[name], mesh)
           for name in ("embed", "lm_head", "meta", "vision_proj")
           if getattr(model, name, None) is not None}
    encoder = None
    if model.encoder is not None:
        enc, enc_specs = model.encoder, specs["encoder"]
        encoder = M.Encoder(stack(enc.layers, enc.segments, enc_specs["segments"]),
                            block(enc.final_norm, enc_specs["final_norm"], False))
    return M.LM(final_norm=block(model.final_norm, specs["final_norm"], False),
                layers=stack(model.layers, model.segments, specs["segments"]),
                segments=model.segments, encoder=encoder, **top)


def _paired_shapes(cfg: ModelConfig, shapes: dict, mode: str, block_n: int) -> dict:
    """``shapes`` (``param_axes_and_shapes``'s) with a ``"<name>_pairing"``
    sibling beside every paired weight, shaped as the JAX package's stacked
    metadata ``(L, [E,] [B,] lanes)`` (the lane count, which placement never
    reads, as 0): the tree ``paired_shardings_for`` places."""
    def copy(tree):
        return {k: copy(v) for k, v in tree.items()} if isinstance(tree, dict) else tree

    def paired(segments: list) -> list:
        return [with_meta(copy(seg)) for seg in segments]

    def with_meta(seg: dict) -> dict:
        for sub_path, w_name in cfg.paired_leaves:
            parts = sub_path.split(".")
            node = seg
            for part in parts:
                node = node.get(part) if isinstance(node, dict) else None
            if not isinstance(node, dict) or w_name not in node:
                continue
            shape = tuple(node[w_name].shape)
            expert = parts[-1] == "moe" and len(shape) == 4
            mat = shape[2:] if expert else shape[1:]
            N = mat[-1] if w_name == "wo" else math.prod(mat[1:])
            lead = shape[:2] if expert else shape[:1]
            blocks = (-(-N // min(block_n, N)),) if mode == "column_blocked" else ()
            meta = torch.empty((*lead, *blocks, 0), device="meta")
            node[w_name + "_pairing"] = {k: meta for k in
                                         ("I", "J", "resid", "pair_mask", "resid_mask")}
        return seg

    out = dict(shapes, segments=paired(shapes["segments"]))
    if "encoder" in shapes:
        out["encoder"] = dict(shapes["encoder"], segments=paired(shapes["encoder"]["segments"]))
    return out


#: why the mesh refuses the fused decode attention: the JAX engine's words
MESH_FUSED_REFUSAL = (
    "attn='pallas_fused' is single-host only: the sharded serve "
    "cell decodes against a sequence-sharded cache, and the fused "
    "decode-attention kernel has no cross-shard softmax yet — "
    "the mesh path keeps the dense decode attention")


@dataclasses.dataclass
class ServeCell:
    """One rank's wired decode cell: its part of the model (sliced, paired
    per shard, frozen), the steps over it, the placements they follow (the
    weights' and metadata's specs ``p_shard``, the cache's ``c_shard``), the
    rule table, the rank's :class:`~repro_torch.parallel.tp.TensorParallel`
    and its pairing report."""

    model: M.LM
    decode: Any  # serve_step(model, cache, {"tokens", "pos"})
    prefill: Any  # prefill_step(model, batch)
    p_shard: Any
    c_shard: Any
    rules: Rules
    tp: TensorParallel
    pair_report: Any
    plan: dict | None = None
    seconds: dict = dataclasses.field(default_factory=dict)  # "build", "pair"


def wire_serve_cell(
    cfg: ModelConfig,
    source,
    mesh: Mesh,
    *,
    batch_size: int,
    max_seq: int,
    knobs: M.PerfKnobs = M.DEFAULT_KNOBS,
    rules: Rules | None = None,
) -> ServeCell:
    """Wire this rank's part of a decode cell of the model ``source`` names
    (the same on every rank: an ``init_lm`` seed, the JAX package's value
    tree, or the whole unpaired model) on ``mesh``.

    The JAX package's chain, rank by rank: the weights' axes resolve against
    (mesh, rules) (``rules_for(cfg, "decode", mesh)`` unless given) to a
    tensor-parallel shard plan (``core.transform.tp_shard_plan``); the rank
    builds its blocks of the weights by their resolved specs, leaf by leaf
    (:func:`local_model`), and pairs only what it reads
    (``core.transform.pair_shard_params``: no pair crosses a shard
    boundary), each leaf while it is whole; the metadata's placement comes from its
    weight's resolved spec (``parallel.sharding.paired_shardings_for``),
    and the rank's metadata is checked to hold that placement's blocks.  The
    steps are ``serving.steps``' with the rank's
    :class:`~repro_torch.parallel.tp.TensorParallel`, which serves every
    family.  Raises ``NotImplementedError`` for a split the forward does not
    close (``parallel.tp.layout_for`` names it) and for
    ``attn="pallas_fused"`` (the one place it is checked: the steps and the
    forward assume it).
    """
    if knobs.attn != "xla":
        raise NotImplementedError(MESH_FUSED_REFUSAL)
    rules = rules or rules_for(cfg, "decode", mesh)
    tp = layout_for(cfg, mesh, rules, batch_size, max_seq)
    local, p_shard, report, plan, seconds = _shard_and_pair(cfg, source, mesh, rules, knobs)
    c_axes, c_shapes = cache_axes_and_shapes(cfg, batch_size, max_seq)
    c_shard = shardings_for(c_axes, mesh, rules, c_shapes)
    tile_cache = load_knobs_tile_cache(knobs)
    return ServeCell(model=local.copy(frozen=True),
                     decode=build_serve_step(cfg, knobs, tile_cache, tp=tp),
                     prefill=build_prefill_step(cfg, knobs, tile_cache, tp=tp),
                     p_shard=p_shard, c_shard=c_shard, rules=rules, tp=tp,
                     pair_report=report, plan=plan, seconds=seconds)


def _shard_and_pair(cfg: ModelConfig, source, mesh: Mesh, rules: Rules, knobs: M.PerfKnobs, *,
                    fold=None):
    """The rank's part of the unpaired model ``source`` names: ``(local,
    p_shard, pair report, shard plan, seconds)``.  The weights' axes resolve
    against (mesh, rules); the rank builds its blocks by their specs
    (:func:`local_model`) and, under ``gemm="pallas_paired"``, pairs only
    what it reads at the shard plan's splits, each leaf while it is whole
    (``core.transform.tp_shard_plan``, ``premade_entry``,
    ``pair_shard_params``); the metadata's placement comes from its weight's
    resolved spec and is checked against what the rank built.  Under FSDP
    each layer's data-gathered metadata is gathered once here
    (:func:`_gather_pairing`).  ``seconds``: ``"build"`` (the blocks and
    the pairing of each leaf), ``"pair"`` (the stacking, the placement's
    check and the gathered metadata)."""
    if isinstance(source, M.LM) and has_lm_pairing(source):
        raise ValueError("a mesh pairs each rank's shards itself: hand it the unpaired model")
    axes, shapes = param_axes_and_shapes(cfg)
    t0 = time.perf_counter()
    p_shard = shardings_for(axes, mesh, rules, shapes)
    paired = knobs.gemm == "pallas_paired"
    mode, block_n = ops.paired_mode_of(knobs) if paired else ("structured", 0)
    plan = tp_shard_plan(axes, shapes, mesh, rules, leaves=cfg.paired_leaves) if paired else None
    premade: dict = {}

    def on_leaf(name, whole, block, spec) -> None:
        got = premade_entry(name, whole, block, spec, mesh, knobs.pair_rounding, shards=plan,
                            mode=mode, block_n=block_n, leaves=cfg.paired_leaves)
        if got is not None:
            premade[got[0]] = got[1]

    local = local_model(cfg, source, p_shard, mesh, on_leaf=on_leaf if paired else None,
                        fold=fold)
    seconds = {"build": time.perf_counter() - t0}
    report = None
    if paired:
        local, report = pair_shard_params(local, None, knobs.pair_rounding, shards=plan,
                                          mode=mode, block_n=block_n, leaves=cfg.paired_leaves,
                                          premade=premade)
        meta_shapes = _paired_shapes(cfg, shapes, mode, block_n)
        p_shard = paired_shardings_for(pairing_axes(meta_shapes, axes), mesh, rules, meta_shapes)
        _check_meta_placement(local, p_shard, meta_shapes, mesh)
        _gather_pairing(cfg, local, mesh, rules)
        seconds["pair"] = time.perf_counter() - t0 - seconds["build"]
    return local, p_shard, report, plan, seconds


def _gather_pairing(cfg: ModelConfig, local: M.LM, mesh: Mesh, rules: Rules) -> None:
    """FSDP: each paired leaf that splits over data axes gets, as its block's
    ``gathered`` metadata, that of its data-gathered model shard, gathered
    from the data ranks once: a row split's slabs' lane lists concatenated,
    each rebased by its slab's first row (no pair crosses a slab, so it is a
    valid pairing of the gathered rows); a column split's blocks
    concatenated (column-blocked), or the rank's own (structured: every
    slab pairs the same whole rows).  The lane lists pad to the longest
    slab's with masked lanes."""
    fsdp = fsdp_layout(cfg, mesh, rules)
    if not fsdp["fsdp_axes"]:
        return
    group, n = mesh.group(fsdp["fsdp_axes"]), mesh.axis_size(fsdp["fsdp_axes"])

    def gather(meta: dict, rows: int | None) -> dict:
        P, R = meta["I"].shape[-1], meta["resid"].shape[-1]
        lens = all_reduce(torch.tensor([P, R], device=meta["I"].device), group, op="max")
        Pm, Rm = (int(v) for v in lens.tolist())
        pad = lambda t, m: F.pad(t, (0, m - t.shape[-1]))
        packed = torch.cat([pad(meta["I"], Pm), pad(meta["J"], Pm), pad(meta["resid"], Rm),
                            pad(meta["pair_mask"].long(), Pm), pad(meta["resid_mask"].long(), Rm)],
                           dim=-1)
        parts = all_gather(packed[None], group, dim=0).split([Pm, Pm, Rm, Pm, Rm], dim=-1)
        out = dict(zip(("I", "J", "resid", "pair_mask", "resid_mask"), parts, strict=True))
        if rows is not None:  # the slabs' lanes, each rebased by its first row
            shift = (torch.arange(n, device=packed.device) * rows).view(n, *[1] * packed.ndim)
            out.update({k: out[k] + shift for k in ("I", "J", "resid")})
        dim = -1 if rows is not None else -2  # lanes, or blocks
        return {k: torch.cat(list(v), dim=dim).float() if k.endswith("mask")
                else torch.cat(list(v), dim=dim) for k, v in out.items()}

    def walk(layers, segments, seg_gathers) -> None:
        start = 0
        for (_, count), gathers in zip(segments, seg_gathers, strict=True):
            for layer in layers[start:start + count]:
                for path, dim in gathers:
                    sub, name = path.rsplit(".", 1)
                    block = layer.get_submodule(sub)
                    meta = block.pairing.get(name)
                    if meta is None:
                        continue
                    w = getattr(block, name)
                    expert = isinstance(block, Lyr.MoE) and w.ndim == 3
                    row = row_lead_dim(name, expert)
                    col = w.ndim - 1 if name == "wo" else row + 1
                    if dim == row:
                        rows = math.prod(w.shape[:-1]) if name == "wo" else w.shape[row]
                        block.gathered[name] = gather(meta, rows)
                    elif dim == col and meta["I"].ndim > (2 if expert else 1):
                        block.gathered[name] = gather(meta, None)
                    elif dim != col:
                        raise NotImplementedError(
                            f"{cfg.name}: {path} splits dim {dim} over the data axes, neither "
                            "the first of its GEMM rows nor of its columns")
            start += count

    walk(local.layers, local.segments, fsdp["segments"])
    if local.encoder is not None:
        walk(local.encoder.layers, local.encoder.segments, [fsdp["encoder"]])
def _check_meta_placement(local: M.LM, p_shard: dict, meta_shapes: dict, mesh: Mesh) -> None:
    """Each blocked metadata leaf the rank built holds the blocks its
    placement gives it: all of them where the block axis is replicated,
    ``B / n`` where it rides the weight's column split; every paired block
    of every layer (the shared experts' ``moe.shared``, an SSM block's, the
    encoder's too)."""

    def at(tree: dict, path: str):
        for part in path.split("."):
            tree = tree[part]
        return tree

    def check(layers, segments, seg_specs, seg_shapes) -> None:
        start = 0
        for (_, count), seg_spec, seg_shape in zip(segments, seg_specs, seg_shapes, strict=True):
            for layer in layers[start:start + count]:
                for path, sub in layer.named_modules():
                    for name, meta in getattr(sub, "pairing", {}).items():
                        spec = at(seg_spec, path)[name + "_pairing"]["I"]
                        shape = tuple(at(seg_shape, path)[name + "_pairing"]["I"].shape)
                        # stacked (L, [E,] [B,] lanes); the rank's per layer ([E,] [B,] lanes)
                        expert = isinstance(sub, Lyr.MoE) and getattr(sub, name).ndim == 3
                        dims = [1] if expert else []
                        if meta["I"].ndim == (3 if expert else 2):
                            dims.append(2 if expert else 1)
                        for dim in dims:
                            want = shape[dim] // mesh.axis_size(spec[dim])
                            if meta["I"].shape[dim - 1] != want:
                                raise AssertionError(
                                    f"{path}.{name}: the rank holds {meta['I'].shape[dim - 1]} "
                                    f"along metadata dim {dim}, its placement {tuple(spec)} "
                                    f"gives it {want}")
            start += count

    check(local.layers, local.segments, p_shard["segments"], meta_shapes["segments"])
    if local.encoder is not None:
        enc = local.encoder
        check(enc.layers, enc.segments, p_shard["encoder"]["segments"],
              meta_shapes["encoder"]["segments"])


# ---------------------------------------------------------------------------
# the dry run: one rank's step of one (arch × shape × mesh) cell, on fake tensors
# ---------------------------------------------------------------------------


def abstract_opt_state(opt: Callable[..., torch.optim.Optimizer], param_shapes):
    """The optimizer state ``opt`` (a constructor, ``train.optimizer.adamw``)
    makes for a tree of parameter shapes (``models.param``'s meta tensors):
    ``{slot: tree}``, one tree a state slot (AdamW's ``m`` and ``v``, the
    JAX package's ``m``/``v``), each leaf the slot's tensor for that
    parameter (fp32, on the parameters' device)."""
    leaves: list[torch.Tensor] = []

    def collect(tree):
        if isinstance(tree, dict):
            return {k: collect(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [collect(v) for v in tree]
        leaves.append(torch.empty_like(tree))
        return len(leaves) - 1

    index = collect(param_shapes)
    state = opt(leaves).state

    def rebuild(tree, slot: str):
        if isinstance(tree, dict):
            return {k: rebuild(v, slot) for k, v in tree.items()}
        if isinstance(tree, list):
            return [rebuild(v, slot) for v in tree]
        return state[leaves[tree]][slot]

    return {slot: rebuild(index, slot) for slot in state[leaves[0]]}


def opt_state_axes(param_axes, opt_state_shapes):
    """Optimizer state shards exactly like its parameter (moments are
    elementwise): every top-level state slot — adamw's m/v, sgd's mom —
    mirrors the param axes tree."""
    return {k: param_axes for k in opt_state_shapes}


@dataclasses.dataclass
class LoweredCell:
    """One rank's step of a dry-run cell, wired on fake tensors: ``args``,
    the step's arguments by group (``"params"``: the rank's part of the
    model; ``"opt_state"`` and ``"step"`` in training; ``"cache"`` in
    decode; ``"batch"``: the rank's block of the batch by its specs), all
    fake tensors on the rank's ``device``; ``run()`` runs the step on them
    once.  :meth:`lower` runs it under the cell's ``FakeTensorMode`` and
    ``parallel.cost.record``: the JAX package's ``lower()``, whose trace
    ``parallel.cost`` reads as the JAX package reads the compiled HLO."""

    run: Callable[[], Any]
    args: dict
    mode: str
    device: torch.device
    rules: Rules
    fake_mode: Any

    def lower(self):
        from repro_torch.parallel import cost

        if self.fake_mode is None:
            raise ValueError("a cell wired on real tensors (a seed) runs; it is not traced")
        with self.fake_mode, cost.record(self.args, self.device,
                                         backward=self.mode == "train") as trace:
            self.run()
        return trace


def _batch_block(cfg: ModelConfig, mesh: Mesh, rules: Rules, batch: int, seq: int, kind: str,
                 device, seed: int | None = None) -> dict:
    """The rank's block of each batch entry of ``launch.inputs.batch_specs``
    by its resolved spec (each split dim cut to its share), as the JAX
    package's ``in_shardings`` place it, on ``device``: empty tensors, or
    with a ``seed`` drawn (token ids below the vocab, positions 0, the stub
    embeddings normals times 0.02)."""
    from repro_torch.launch.inputs import batch_logical_axes, batch_specs

    specs = batch_specs(cfg, batch, seq, kind)
    gen = None if seed is None else torch.Generator(device=device).manual_seed(seed)
    out = {}
    for k, axes in batch_logical_axes(cfg, kind).items():
        full = tuple(specs[k].shape)
        spec = spec_for_axes(axes, mesh=mesh, rules=rules, dim_sizes=full)
        shape = tuple(n // mesh.axis_size(e) for n, e in zip(full, spec, strict=True))
        dt = specs[k].dtype
        if gen is None:
            out[k] = torch.empty(shape, dtype=dt, device=device)
        elif k == "pos":
            out[k] = torch.zeros(shape, dtype=dt, device=device)
        elif dt == torch.int32:
            out[k] = torch.randint(0, cfg.vocab, shape, generator=gen, device=device, dtype=dt)
        else:
            out[k] = (torch.randn(shape, generator=gen, device=device) * 0.02).to(dt)
    return out


def wire_cell(
    cfg: ModelConfig,
    mesh: Mesh,
    *,
    seq_len: int,
    global_batch: int,
    mode: str,
    knobs: M.PerfKnobs = M.DEFAULT_KNOBS,
    rules: Rules | None = None,
    seed: int | None = None,
) -> LoweredCell:
    """Wire this rank's step of one dry-run cell on ``mesh`` (a
    ``parallel.sharding.Mesh`` over a process group, the fake one of the
    dry run: ``launch.mesh.fake_process_group``), under a ``FakeTensorMode``
    of its own, so nothing is allocated and no kernel is built.

    ``mode="train"``: :func:`build_train_step` with AdamW at 1e-4 and weight
    decay 0.1 (the JAX dry run's), the rank's fp32 shards and their moments,
    the step index, and the rank's block of a ``global_batch`` ×
    ``seq_len`` batch (``TrainStep(..., block_of=)``).  ``"prefill"`` and
    ``"decode"``: :func:`wire_serve_cell`'s steps over the rank's shards
    held in the compute dtype (the JAX dry run's ``abstract_params(cfg,
    dtype)``), decode against the rank's part of a ``global_batch`` ×
    ``seq_len`` cache.  The rank's shards come leaf by leaf from
    ``models.lm.SHAPES_ONLY`` (:func:`local_model`).  ``rules``:
    ``rules_for(cfg, mode, mesh)`` unless given.

    With a ``seed`` the same rank's step is wired on real tensors instead
    (its shards from that ``init_lm`` seed, a batch drawn from it), which
    ``run()`` runs for real: the card's check of the dry run's prediction
    (``launch.dryrun.measure_cell``); :meth:`LoweredCell.lower` then
    refuses."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.train.optimizer import adamw

    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    rules = rules or rules_for(cfg, mode, mesh)
    fake = FakeTensorMode() if seed is None else None
    source = M.SHAPES_ONLY if seed is None else seed
    dev = mesh.device
    with fake if fake is not None else contextlib.nullcontext():
        block = _batch_block(cfg, mesh, rules, global_batch, seq_len, mode, dev, seed)
        if mode == "train":
            step = build_train_step(cfg, adamw(1e-4, weight_decay=0.1), knobs, mesh, rules)
            model = step.shard(source).model
            opt = step.init(model)
            # the JAX step's int32 index on the device; the port's optimizer
            # reads the host int
            args = {"params": model, "opt_state": opt,
                    "step": torch.zeros((), dtype=torch.int32, device=dev), "batch": block}
            run = functools.partial(step, model, opt, 0, block,
                                    block_of=(global_batch, seq_len))
            return LoweredCell(run, args, mode, dev, rules, fake)
        cell = wire_serve_cell(cfg, source, mesh, batch_size=global_batch,
                               max_seq=seq_len, knobs=knobs, rules=rules)
        cdt = M.compute_dtype(cfg)
        for p in cell.model.parameters():
            if p.is_floating_point():
                p.data = p.data.to(cdt)
        args = {"params": cell.model, "batch": block}
        if mode == "prefill":
            run = functools.partial(cell.prefill, cell.model, block)
        else:
            args["cache"] = M.init_cache(cfg, global_batch, seq_len, device=dev, tp=cell.tp)
            run = functools.partial(cell.decode, cell.model, args["cache"], block)
        return LoweredCell(run, args, mode, dev, rules, fake)
