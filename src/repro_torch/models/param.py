"""Logical axes of the LM's weights, caches and pairing metadata.

The JAX package annotates every parameter with logical axes as it builds it
(``repro.models.param.Param``) and reads the trees back through
``launch.steps.abstract_params`` / ``abstract_cache``.  The port's weights
live in modules, so the trees are spelled out here from the config:
:func:`param_axes` is the axes tree over ``models.lm.lm_value_tree``'s
layout (each segment's layers stacked along a leading ``"layers"`` axis),
:func:`cache_axes` the one over the JAX package's segmented cache layout
(``{"segments": [{"k": …, "v": …}, …]}``; the port's cache holds the same
entries stacked over all layers, ``models.lm.init_cache``).  Each comes with
its shapes, as tensors on the ``meta`` device (no memory), for the
divisibility guards.  :func:`pairing_axes` extends a weights' axes tree
over its ``"<name>_pairing"`` siblings, as the JAX package's does.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig

PAIRING_META_AXIS = "pairing_meta"


def _padded_vocab(cfg: ModelConfig) -> int:
    return ((cfg.vocab + 127) // 128) * 128


def _norm(cfg: ModelConfig, d: int) -> dict:
    p = {"scale": ((d,), ("embed",))}
    if cfg.norm == "layernorm":
        p["bias"] = ((d,), ("embed",))
    return p


def _attention(cfg: ModelConfig, *, qkv_bias: bool, qk_norm: bool) -> dict:
    d, H, KH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": ((d, H, hd), ("embed", "q_heads", "head_dim")),
         "wk": ((d, KH, hd), ("embed", "kv_heads", "head_dim")),
         "wv": ((d, KH, hd), ("embed", "kv_heads", "head_dim")),
         "wo": ((H, hd, d), ("q_heads", "head_dim", "embed"))}
    if qkv_bias:
        p.update(bq=((H, hd), ("q_heads", "head_dim")), bk=((KH, hd), ("kv_heads", "head_dim")),
                 bv=((KH, hd), ("kv_heads", "head_dim")))
    if qk_norm:
        p.update(q_norm=((hd,), ("head_dim",)), k_norm=((hd,), ("head_dim",)))
    return p


def _mla(cfg: ModelConfig) -> dict:
    d, H, m = cfg.d_model, cfg.n_heads, cfg.mla
    return {"wq": ((d, H, m.qk_nope_dim + m.qk_rope_dim), ("embed", "q_heads", "head_dim")),
            "w_dkv": ((d, m.kv_lora_rank), ("embed", "kv_lora")),
            "w_kr": ((d, m.qk_rope_dim), ("embed", "head_dim")),
            "w_uk": ((m.kv_lora_rank, H, m.qk_nope_dim), ("kv_lora", "q_heads", "head_dim")),
            "w_uv": ((m.kv_lora_rank, H, m.v_head_dim), ("kv_lora", "q_heads", "head_dim")),
            "wo": ((H, m.v_head_dim, d), ("q_heads", "head_dim", "embed")),
            "kv_norm": ((m.kv_lora_rank,), ("kv_lora",))}


def _mlp(d: int, f: int) -> dict:
    return {"w_gate": ((d, f), ("embed", "ff")), "w_up": ((d, f), ("embed", "ff")),
            "w_down": ((f, d), ("ff", "embed"))}


def _moe(cfg: ModelConfig) -> dict:
    d, mo = cfg.d_model, cfg.moe
    E, F = mo.n_experts, mo.d_ff_expert
    p = {"router": ((d, E), ("embed", "experts")),
         "w_gate": ((E, d, F), ("experts", "embed", "expert_ff")),
         "w_up": ((E, d, F), ("experts", "embed", "expert_ff")),
         "w_down": ((E, F, d), ("experts", "expert_ff", "embed"))}
    if mo.n_shared:
        p["shared"] = _mlp(d, F * mo.n_shared)
    return p


def _ssm(cfg: ModelConfig) -> dict:
    s, d = cfg.ssm, cfg.d_model
    d_in = s.expand * d
    H, GN, W = d_in // s.head_dim, s.n_groups * s.d_state, s.conv_width
    return {"w_z": ((d, d_in), ("embed", "ssm_in")), "w_x": ((d, d_in), ("embed", "ssm_in")),
            "w_B": ((d, GN), ("embed", "ssm_state")), "w_C": ((d, GN), ("embed", "ssm_state")),
            "w_dt": ((d, H), ("embed", "ssm_heads")),
            "conv_x": ((W, d_in), ("conv", "ssm_in")),
            "conv_B": ((W, GN), ("conv", "ssm_state")),
            "conv_C": ((W, GN), ("conv", "ssm_state")),
            "A_log": ((H,), ("ssm_heads",)), "D": ((H,), ("ssm_heads",)),
            "dt_bias": ((H,), ("ssm_heads",)), "norm": ((d_in,), ("ssm_in",)),
            "w_out": ((d_in, d), ("ssm_in", "embed"))}


def _layer(cfg: ModelConfig, kind: str) -> dict:
    """One layer's ``{block: {name: (shape, axes)}}``, as the JAX package's
    ``_init_layer`` builds it."""
    d = cfg.d_model
    p: dict[str, Any] = {"ln1": _norm(cfg, d)}
    if kind in ("dense", "moe", "hybrid_full", "hybrid_swa", "encdec"):
        p["attn"] = (_mla(cfg) if cfg.mla else
                     _attention(cfg, qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm))
    if kind == "encdec":
        p["lnx"] = _norm(cfg, d)
        p["xattn"] = _attention(cfg, qkv_bias=False, qk_norm=False)
    if kind in ("ssm", "hybrid_full", "hybrid_swa"):
        p["mamba"] = _ssm(cfg)
    if kind in ("hybrid_full", "hybrid_swa"):
        p["ln_attn_out"] = _norm(cfg, d)
        p["ln_ssm_out"] = _norm(cfg, d)
    if kind == "moe":
        p["ln2"] = _norm(cfg, d)
        p["moe"] = _moe(cfg)
    elif kind == "dense" and cfg.moe is not None:
        p["ln2"] = _norm(cfg, d)
        p["mlp"] = _mlp(d, cfg.moe.d_ff_dense)
    elif kind != "ssm" and cfg.d_ff:
        p["ln2"] = _norm(cfg, d)
        p["mlp"] = _mlp(d, cfg.d_ff)
    return p


def _stacked(tree: dict, count: int):
    """(axes tree, shapes tree) of ``count`` stacked layers of ``tree``."""
    if isinstance(tree, dict):
        pairs = {k: _stacked(v, count) for k, v in tree.items()}
        return {k: a for k, (a, _) in pairs.items()}, {k: s for k, (_, s) in pairs.items()}
    shape, axes = tree
    return ("layers", *axes), torch.empty((count, *shape), device="meta")


def _segment_kinds(cfg: ModelConfig) -> list[tuple[str, int]]:
    if cfg.family == "encdec":
        return [("encdec", n) for _, n in cfg.segments()]
    return list(cfg.segments())


def param_axes_and_shapes(cfg: ModelConfig) -> tuple[dict, dict]:
    """(axes tree, shapes tree) of the model's weights in
    ``lm_value_tree``'s layout; the shapes are ``meta`` tensors."""
    d, Vp = cfg.d_model, _padded_vocab(cfg)
    flat: dict[str, Any] = {"embed": ((Vp, d), ("vocab", "embed")),
                            "final_norm": _norm(cfg, d)}
    if not cfg.tie_embeddings:
        flat["lm_head"] = ((d, Vp), ("embed", "vocab"))
    if cfg.meta_tokens:
        flat["meta"] = ((cfg.meta_tokens, d), ("meta", "embed"))
    if cfg.vision_prefix:
        flat["vision_proj"] = ((cfg.vision_embed_dim, d), ("head_dim", "embed"))

    def unstacked(tree):
        if isinstance(tree, dict):
            pairs = {k: unstacked(v) for k, v in tree.items()}
            return {k: a for k, (a, _) in pairs.items()}, {k: s for k, (_, s) in pairs.items()}
        shape, axes = tree
        return axes, torch.empty(shape, device="meta")

    axes, shapes = unstacked(flat)
    segs = [_stacked(_layer(cfg, kind), count) for kind, count in _segment_kinds(cfg)]
    axes["segments"] = [a for a, _ in segs]
    shapes["segments"] = [s for _, s in segs]
    if cfg.encoder is not None:
        enc_layer = {"ln1": _norm(cfg, d), "attn": _attention(cfg, qkv_bias=False, qk_norm=False),
                     "ln2": _norm(cfg, d), "mlp": _mlp(d, cfg.d_ff)}
        ea, es = _stacked(enc_layer, cfg.encoder.n_layers)
        fa, fs = unstacked(_norm(cfg, d))
        axes["encoder"] = {"segments": [ea], "final_norm": fa}
        shapes["encoder"] = {"segments": [es], "final_norm": fs}
    return axes, shapes


def param_axes(cfg: ModelConfig) -> dict:
    """The logical axes of every weight, the tree of
    ``repro.launch.steps.abstract_params(cfg)[1]``."""
    return param_axes_and_shapes(cfg)[0]


def cache_axes_and_shapes(cfg: ModelConfig, batch: int, max_seq: int) -> tuple[dict, dict]:
    """(axes tree, shapes tree) of the decode cache in the JAX package's
    segmented layout; ``max_seq`` counts token positions, the meta tokens
    extend it."""
    S = max_seq + cfg.meta_tokens
    axes_segs, shape_segs = [], []
    for kind, count in _segment_kinds(cfg):
        entry: dict[str, Any] = {}
        if kind in ("dense", "moe", "encdec", "hybrid_full", "hybrid_swa"):
            if cfg.mla:
                m = cfg.mla
                entry["c_kv"] = ((count, batch, S, m.kv_lora_rank),
                                 ("layers", "batch", "cache_seq", "kv_lora"))
                entry["k_rope"] = ((count, batch, S, m.qk_rope_dim),
                                   ("layers", "batch", "cache_seq", "head_dim"))
            else:
                for name in ("k", "v"):
                    entry[name] = ((count, batch, S, cfg.n_kv_heads, cfg.head_dim),
                                   ("layers", "batch", "cache_seq", "kv_heads", "head_dim"))
        if kind in ("ssm", "hybrid_full", "hybrid_swa"):
            s = cfg.ssm
            d_in = s.expand * cfg.d_model
            GN, W = s.n_groups * s.d_state, s.conv_width
            entry["h"] = ((count, batch, d_in // s.head_dim, s.head_dim, s.d_state),
                          ("layers", "batch", "ssm_heads", "head_dim", "ssm_state"))
            entry["conv_x"] = ((count, batch, W - 1, d_in), ("layers", "batch", "conv", "ssm_in"))
            for name in ("conv_B", "conv_C"):
                entry[name] = ((count, batch, W - 1, GN),
                               ("layers", "batch", "conv", "ssm_state"))
        if kind == "encdec":
            for name in ("xk", "xv"):
                entry[name] = ((count, batch, cfg.encoder.frames, cfg.n_kv_heads, cfg.head_dim),
                               ("layers", "batch", "frames", "kv_heads", "head_dim"))
        axes_segs.append({k: a for k, (_, a) in entry.items()})
        shape_segs.append({k: torch.empty(s, device="meta") for k, (s, _) in entry.items()})
    return {"segments": axes_segs}, {"segments": shape_segs}


def cache_axes(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """The logical axes of the decode cache, the tree of
    ``repro.launch.steps.abstract_cache(cfg, batch, max_seq)[1]``."""
    return cache_axes_and_shapes(cfg, batch, max_seq)[0]


def _meta_axes_for(leaf: Any, stacked: bool) -> tuple[str, ...]:
    nd = len(getattr(leaf, "shape", ()))
    if stacked and nd:
        return ("layers",) + (PAIRING_META_AXIS,) * (nd - 1)
    return (PAIRING_META_AXIS,) * nd


def pairing_axes(values: Any, axes: Any) -> Any:
    """Axes tree for a *paired* value tree: ``axes`` (the unpaired weights')
    mirrored onto ``values``, every ``"<name>_pairing"`` sibling dict gaining
    ``"layers"`` on its stacked layer dim (where the sibling weight is
    layer-stacked) and :data:`PAIRING_META_AXIS` on every other dim."""
    if isinstance(values, dict):
        out = {}
        for k, v in values.items():
            if k.endswith("_pairing") and not (isinstance(axes, dict) and k in axes):
                w_axes = axes.get(k[: -len("_pairing")]) if isinstance(axes, dict) else None
                stacked = isinstance(w_axes, tuple) and w_axes[:1] == ("layers",)
                out[k] = {mk: _meta_axes_for(leaf, stacked) for mk, leaf in v.items()}
            else:
                out[k] = pairing_axes(v, axes[k])
        return out
    if isinstance(values, list | tuple):
        return type(values)(pairing_axes(v, a) for v, a in zip(values, axes, strict=False))
    return axes
