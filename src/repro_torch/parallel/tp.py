"""One rank's view of a tensor-parallel LM: which of its tensors are split.

The JAX package's partitioner reads the resolved specs and rewrites the
program; the port's forward reads a :class:`TensorParallel`, made once from
the same specs (:func:`layout_for`), and closes each split with a
collective (``models.layers`` and ``models.lm``):

* ``vocab_split`` — the embedding's rows and the head's columns over
  ``model``: a masked lookup and an all-reduce; local logits and an
  all-gather;
* ``q_split`` — the query heads over ``model`` (wq, its bias, and wo's rows):
  wo's partial sums all-reduced in fp32;
* ``kv_split`` — the KV heads too (wk, wv, their biases, the cache's heads);
  where they are not, a rank's q heads read the global KV heads ``h // G``;
* ``cache_seq`` — the cache's positions over ``model`` (where its heads do
  not claim the axis): each rank attends its keys, the partial softmaxes
  are gathered and merged in fp32;
* ``ff_split`` / ``experts_split`` — the MLP's hidden columns (w_down's
  rows) or the experts over ``model``, closed by one all-reduce;
* ``batch_split`` — the decode slots over data axes of more than one rank:
  each data row decodes its slots, and the logits are gathered over the
  data axes.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.models.param import cache_axes_and_shapes, param_axes_and_shapes
from repro_torch.parallel.sharding import DATA_AXES, Mesh, Rules, shardings_for

MODEL_AXIS = "model"


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


def _on(spec, dim: int) -> bool:
    return spec[dim] is not None


def layout_for(cfg: ModelConfig, mesh: Mesh, rules: Rules, batch_size: int,
               max_seq: int) -> TensorParallel:
    """The :class:`TensorParallel` of ``cfg`` served on ``mesh`` under
    ``rules`` with ``batch_size`` slots of ``max_seq`` positions, read from
    the resolved specs of the first layer's weights and cache (every layer
    of a dense or MoE model resolves alike).  Raises ``NotImplementedError``
    where the specs ask for a split the port's forward does not close: a
    weight over a data axis (FSDP), a head_dim, a cache entry other than
    GQA's K/V."""
    axes, shapes = param_axes_and_shapes(cfg)
    specs = shardings_for(axes, mesh, rules, shapes)
    c_axes, c_shapes = cache_axes_and_shapes(cfg, batch_size, max_seq)
    c_specs = shardings_for(c_axes, mesh, rules, c_shapes)

    def entries(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                yield from entries(v)
        elif isinstance(tree, list):
            for v in tree:
                yield from entries(v)
        else:
            yield from (e for e in tree if e is not None)

    # a split over a data axis of one rank is no split
    off_model = {e for e in entries(specs) if e != MODEL_AXIS and mesh.axis_size(e) > 1}
    if off_model:
        raise NotImplementedError(
            f"{cfg.name}: the rules shard weights over {sorted(map(str, off_model))} "
            "(FSDP); the port's tensor-parallel forward splits weights over 'model' only "
            "(ROADMAP queue 1, item 9)")
    seg, cseg = specs["segments"][0], c_specs["segments"][0]
    attn = seg["attn"]
    k_spec = cseg["k"]  # (layers, batch, cache_seq, kv_heads, head_dim)
    if _on(k_spec, 4) or _on(k_spec, 3) != _on(attn["wk"], 2):
        raise NotImplementedError(f"{cfg.name}: a cache split {tuple(k_spec)} that its "
                                  f"KV projections' {tuple(attn['wk'])} do not match")
    ffn = seg.get("mlp") or seg.get("moe")
    return TensorParallel(
        mesh=mesh, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        vocab_split=_on(specs["embed"], 0),
        q_split=_on(attn["wq"], 2), kv_split=_on(attn["wk"], 2),
        cache_seq=_on(k_spec, 2),
        ff_split="mlp" in seg and _on(ffn["w_gate"], 2),
        experts_split="moe" in seg and _on(ffn["w_gate"], 1),
        batch_split=_on(k_spec, 1) and mesh.axis_size(k_spec[1]) > 1,
    )
