"""Per-(architecture × mode) sharding rule tables.

The port of ``repro.parallel.rules``, table for table:

* ``train``   — batch over (pod, data); tensor parallelism over ``model``
  for ff / heads / experts / vocab / ssm; the residual stream's saved
  activations sequence-sharded over ``model``; FSDP (d_model over ``data``)
  for models past :data:`FSDP_PARAM_THRESHOLD` parameters.  The training
  mesh (``launch.steps.build_train_step`` with a mesh, the train CLI's
  ``--mesh``) reads it through ``parallel.tp.train_layout_for``: each
  FSDP rank holds its (data × model) blocks and gathers a layer's over
  ``data`` before it runs (``parallel.tp``);
* ``prefill`` — tensor parallelism as in train, no sequence sharding, the KV
  cache sharded over ``model`` along its sequence;
* ``decode``  — weights tensor-parallel over ``model`` where they divide;
  the KV cache over ``model`` along its sequence where its heads do not
  claim the axis first (``sharding.PRIORITY``).  Attention against a
  sequence-sharded cache is a partial softmax merged across ``model``,
  written out in ``models.layers`` (XLA's partitioner emits it for the JAX
  package).

Divisibility is guarded downstream (``sharding.spec_for_axes``): an axis
that does not divide its mesh axes is replicated, e.g. qwen2-1.5b's 2 KV
heads on a 4-way ``model`` axis.

The train CLI and the mesh benches shard a mesh by :func:`arch_rules`: the
published config's rules, whatever depth or width they cut it to.
"""
from __future__ import annotations

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.parallel.sharding import DATA_AXES, Rules

FSDP_PARAM_THRESHOLD = 20e9  # params; above this, shard d_model over `data`


def rules_for(cfg: ModelConfig, mode: str, mesh) -> Rules:
    data = tuple(a for a in DATA_AXES if a in mesh.axis_names)
    big = cfg.param_count() > FSDP_PARAM_THRESHOLD

    base = {
        "batch": data,
        "vocab": "model",
        "ff": "model",
        "expert_ff": None,  # `model` is taken by `experts` for MoE weights
        "experts": "model",
        "q_heads": "model",
        "kv_heads": "model",
        "ssm_in": "model",
        "ssm_heads": "model",
        "kv_lora": None,
        "head_dim": None,
        "ssm_state": None,
        "conv": None,
        "layers": None,
        "meta": None,
        "frames": None,
        "seq": None,
        "cache_seq": None,
        # pairing-metadata lane dims never shard by rule: the block axis of a
        # "<name>_pairing" sibling copies the weight's resolved spec
        # (sharding.paired_shardings_for)
        "pairing_meta": None,
    }

    if mode == "train":
        base["seq"] = "model"  # sequence-parallel residual checkpoints
        if big:
            base["embed"] = "data"  # FSDP 2-D weights
    elif mode == "prefill":
        base["cache_seq"] = "model"  # the emitted KV cache sharded along seq
        if big:
            base["embed"] = "data"
    elif mode == "decode":
        base["cache_seq"] = "model"  # the KV cache sequence-sharded
        if big:
            base["embed"] = "data"
    else:
        raise ValueError(f"unknown mode {mode!r}")

    return Rules(table=base)


def arch_rules(arch: str, mode: str, mesh) -> Rules:
    """The rules a mesh run of ``arch`` is sharded by at any depth or width
    (the CLIs' ``--smoke`` and ``--layers`` cuts): those of its published
    config.  They differ from a cut config's own only where the cut falls
    under :data:`FSDP_PARAM_THRESHOLD`: mistral-large-123b keeps ``embed``
    over ``data`` at 1 layer and at its smoke widths."""
    return rules_for(get_config(arch), mode, mesh)
