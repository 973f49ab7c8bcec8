"""The LM, decoder-only (dense, MoE, SSM, hybrid), encoder-decoder or
vision-language: init, forward, prefill and decode, in PyTorch.

The port of ``repro.models.lm``:

* :func:`lm_forward` — the forward over a prompt (logits, and optionally
  the cache entries it produced); an encoder-decoder model's ``frames``
  and a vision-language model's ``patches`` come in ``extras``;
* :func:`prefill` — last-position logits and a filled cache;
* :func:`init_cache` — an empty decode cache: ``{"k", "v"}`` of shape
  ``(layers, batch, seq, kv_heads, head_dim)`` for GQA, the latent
  ``{"c_kv", "k_rope"}`` ``(layers, batch, seq, kv_lora_rank | qk_rope_dim)``
  for MLA, and for an SSM block its state ``"h"`` ``(layers, batch, heads,
  head_dim, d_state)`` (fp32) and conv tails ``"conv_x"``/``"conv_B"``/
  ``"conv_C"`` ``(layers, batch, conv_width − 1, channels)``; for cross-attention the
  encoder output's keys and values ``"xk"``/``"xv"`` ``(layers, batch,
  frames, kv_heads, head_dim)``;
* :func:`encoder_fwd` — the audio encoder over precomputed frame
  embeddings (whisper), run once a prefill;
* :func:`decode_step` — one new token per slot against the cache;
* :func:`lm_loss` — the training forward: masked next-token cross-entropy
  (:func:`chunked_xent`, the head a chunk of the sequence at a time) plus
  the MoE router's load-balance loss, each decoder layer checkpointed under
  ``knobs.remat``.

On a mesh (``tp``, a ``parallel.tp.TensorParallel``; every family)
:func:`prefill`, :func:`decode_step` and :func:`init_cache` run one rank's
part of the model it holds (``launch.steps.wire_serve_cell`` slices it):
the embedding vocab-parallel (a masked lookup, then an all-reduce), the head
over the rank's vocab columns (then an all-gather, so every rank holds all
the logits), the cache in the layout its resolved spec gives (heads or
positions over ``model``, an SSM state's heads and conv tails' channels,
slots over the data axes), the encoder over its own split, and each layer as
``models.layers`` splits it under its segment's view (``tp.layer(i)``).
:func:`lm_loss` runs one training rank's part (``tp`` from
``parallel.tp.train_layout_for``; every family): the rank's rows, its
positions of the residual stream (the meta tokens' among them) under
sequence parallelism, the encoder over all frames, the vocab-parallel
cross-entropy, and the global batch's loss.

The model is an :class:`LM` module: the embedding (tied as the head, or an
``lm_head`` of its own), learned ``meta`` token rows (hybrid) that precede
every prompt, a ``vision_proj`` (vlm) that maps patch embeddings to the
model width, an :class:`Encoder` (encdec), the final norm and one
:class:`~repro_torch.models.layers.DecoderLayer` per layer, with GQA or MLA
attention, a Mamba-2 block or both side by side, cross-attention over the
encoder output, and a gated MLP or routed (and shared) experts.  The JAX
package stacks a segment's layers for ``lax.scan``; the port
keeps them apart and remembers the segments (``LM.segments``), which only
decide how pairing metadata is padded.  :func:`lm_params_from_numpy` builds
the model from the JAX package's value tree, so both packages can compute
from the same weights; :func:`init_lm` makes seeded random weights of its
own (``jax.random`` streams cannot be reproduced in torch).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
    set_checkpoint_early_stop,
)

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.parallel.collectives import all_gather, all_reduce
from repro_torch.models.layers import (
    MLA,
    MLP,
    Attention,
    Block,
    DecoderLayer,
    Mamba,
    MoE,
    Norm,
    _leaf_dense,
    attention_block,
    attention_decode_block,
    attn_out_proj,
    close_partial,
    decode_attention,
    full_attention,
    gather_layer,
    gather_weights,
    local_kv,
    mla_block,
    mla_decode_block,
    mlp_block,
    moe_block,
    seq_enter,
    ssm_decode_block,
    ssm_forward,
)

GEMMS = ("xla", "pallas", "pallas_paired")
ATTNS = ("xla", "pallas_fused")
#: the JAX package's conv lowerings (``repro.models.lenet.CONV_IMPLS``): the
#: LM archs have no 2-D convs, so none changes their path
CONVS = ("xla", "im2col", "pallas_paired")
REMATS = ("full", "dots", "none")
#: the SSM block's cache entries: one state a slot, no sequence axis
SSM_ENTRIES = ("h", "conv_x", "conv_B", "conv_C")
#: the attention cache's entries, whose positions a prefill fills from 0
#: (and a mesh may split over ``model``)
SEQ_ENTRIES = ("k", "v", "c_kv", "k_rope")
#: what a batch may carry beside its tokens (and labels): an
#: encoder-decoder model's frame embeddings, a vision-language one's patches
EXTRAS = ("frames", "patches")


@dataclasses.dataclass(frozen=True)
class PerfKnobs:
    """Schedule knobs of the LM path (the fields of the JAX package's
    ``PerfKnobs`` that this path reads).

    ``gemm="pallas"`` runs every decoder GEMM on K1's dense form;
    ``gemm="pallas_paired"`` runs every decoder GEMM whose weight carries
    pairing metadata on the paired kernel, with the sublayer residual adds
    in its epilogue; ``pair_rounding`` and ``pair_block_n`` (0 → structured,
    n ≥ 1 → column-blocked, 1 == the paper's per-column pairing) set the
    pairing the serving engine builds.  ``attn="pallas_fused"`` runs decode
    attention and the out-projection as one decode-attention launch, and
    non-causal attention over a sequence (whisper's encoder and its
    cross-attention prefill) on the flash-attention kernel.
    ``q_chunk``/``k_chunk`` are prefill attention's blocks.  Training
    (:func:`lm_loss`) reads ``remat`` (``"full"``: recompute each decoder
    layer in the backward; ``"dots"``: keep the GEMMs' outputs, recompute
    the rest; ``"none"``) and ``xent_chunk`` (sequence positions a chunk of
    the cross-entropy; 0 → one chunk).  ``block_k`` (0: none) is the
    K-slice width of every K1 launch and ``tile_cache`` (a path; "" → none)
    the persisted tile cache whose measured plans beat the heuristic
    (``kernels.ops.tile_cache_context``, which the step builders of
    ``launch.steps`` enter around each step).  ``conv`` (one of
    :data:`CONVS`) and ``fuse_pool`` are the JAX package's conv lowering and
    conv→pool megakernel knobs: no LM arch has a 2-D conv, so they change
    nothing here, as in the JAX package.
    """

    q_chunk: int = 1024
    k_chunk: int = 1024
    remat: str = "full"
    xent_chunk: int = 512
    gemm: str = "xla"
    attn: str = "xla"
    pair_rounding: float = 0.0
    pair_block_n: int = 0
    block_k: int = 0
    tile_cache: str = ""
    conv: str = "xla"
    fuse_pool: bool = False

    def __post_init__(self):
        if self.gemm not in GEMMS:
            raise ValueError(f"unknown knobs.gemm {self.gemm!r} (expected one of {GEMMS})")
        if self.attn not in ATTNS:
            raise ValueError(f"unknown knobs.attn {self.attn!r} (expected one of {ATTNS})")
        if self.conv not in CONVS:
            raise ValueError(f"unknown knobs.conv {self.conv!r} (expected one of {CONVS})")
        if type(self.block_k) is not int or self.block_k < 0:
            raise ValueError(f"knobs.block_k must be an int >= 0, got {self.block_k!r}")
        if not isinstance(self.tile_cache, str):
            raise ValueError(f"knobs.tile_cache must be a path string, got {self.tile_cache!r}")
        if not isinstance(self.fuse_pool, bool):
            raise ValueError(f"knobs.fuse_pool must be a bool, got {self.fuse_pool!r}")
        if self.remat not in REMATS:
            raise ValueError(f"unknown knobs.remat {self.remat!r} (expected one of {REMATS})")


DEFAULT_KNOBS = PerfKnobs()


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def padded_vocab(cfg: ModelConfig) -> int:
    """Vocab rounded up to 128, as in the JAX package."""
    return ((cfg.vocab + 127) // 128) * 128


def _copy_layers(layers, frozen: bool, layer_pairing: list[dict] | None) -> list[DecoderLayer]:
    per_layer = layer_pairing or [None] * len(layers)
    return [layer.copy(frozen=frozen, pairing=lp)
            for layer, lp in zip(layers, per_layer, strict=True)]


class Encoder(nn.Module):
    """The audio encoder of an encoder-decoder model: pre-norm layers of
    non-causal self-attention and a gated MLP (each a
    :class:`~repro_torch.models.layers.DecoderLayer` of ``attn`` and
    ``mlp``), then ``final_norm``.  Its layers are one segment, as the JAX
    package stacks them."""

    def __init__(self, layers: list[DecoderLayer], final_norm: Norm):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm
        self.segments = (("encoder", len(layers)),)

    def copy(self, *, frozen: bool, layer_pairing: list[dict] | None = None) -> Encoder:
        return Encoder(_copy_layers(self.layers, frozen, layer_pairing),
                       self.final_norm.copy(frozen=frozen))


class LM(Block):
    """Embedding ``embed`` (Vp, d), tied as the head unless an ``lm_head``
    (d, Vp) is given, the ``meta`` tokens (M, d) of a hybrid model, the
    ``vision_proj`` (vision_embed_dim, d) of a vision-language one, the
    :class:`Encoder` of an encoder-decoder one, the final norm, the decoder
    layers, and the config's segments."""

    REQUIRED = ("embed",)

    def __init__(self, *, final_norm: Norm, layers: list[DecoderLayer],
                 segments: tuple[tuple[str, int], ...], encoder: Encoder | None = None,
                 pairing: dict | None = None, **weights):
        super().__init__(pairing=pairing, **weights)
        if sum(n for _, n in segments) != len(layers):
            raise ValueError(f"segments {segments} do not cover {len(layers)} layers")
        self.final_norm = final_norm
        self.layers = nn.ModuleList(layers)
        self.segments = tuple(segments)
        self.encoder = encoder

    def copy(self, *, frozen: bool, layer_pairing: list[dict] | None = None,
             encoder_pairing: list[dict] | None = None) -> LM:
        """A model sharing these weights (nothing is copied), with empty
        caches; ``layer_pairing[l]`` replaces decoder layer ``l``'s pairing
        dicts, keyed by sub-path (``{"attn": {...}, "xattn": {...},
        "mamba": {...}, "mlp" or "moe": {...}, "moe.shared": {...}}``), and
        ``encoder_pairing[l]`` encoder layer ``l``'s."""
        enc = self.encoder
        new = LM(final_norm=self.final_norm.copy(frozen=frozen),
                 layers=_copy_layers(self.layers, frozen, layer_pairing),
                 segments=self.segments,
                 encoder=None if enc is None else enc.copy(frozen=frozen,
                                                           layer_pairing=encoder_pairing),
                 **dict(self.named_parameters(recurse=False)))
        new.frozen = frozen
        return new


# ---------------------------------------------------------------------------
# init / weights from the JAX package
# ---------------------------------------------------------------------------


def _trunc_normal(shape, fan_in: int, gen: torch.Generator, device) -> torch.Tensor:
    """Normal truncated to ±2 standard deviations, over sqrt(fan_in) (the
    JAX package's initialiser), by inverse transform of a uniform draw."""
    lim = math.erf(2.0 / math.sqrt(2.0))
    t = torch.empty(shape, dtype=torch.float32, device=device)
    t.uniform_(-lim, lim, generator=gen)
    return t.erfinv_().mul_(math.sqrt(2.0) / math.sqrt(fan_in)).clamp_(
        -2.0 / math.sqrt(fan_in), 2.0 / math.sqrt(fan_in))


def init_lm(cfg: ModelConfig, seed: int = 0, *, device=None) -> LM:
    """Seeded random fp32 weights of the JAX package's shapes and scales
    (qkv and LayerNorm biases zero, norm scales one; an expert weight's fan-in is its
    second axis, ``wo``'s its first two, MLA's up-projections' the latent
    rank; an SSM block's as ``init_ssm`` makes them: ``A_log = log(1…H)``,
    ``dt_bias`` the inverse softplus of a log-uniform ``dt`` in [dt_min,
    dt_max], the B/C convs passing their input through), made on ``device``
    (the GPU unless ``"cpu"`` is asked for): :func:`lm_leaves` of the seed,
    every leaf kept whole."""
    return init_lm_local(cfg, seed, device=device)


def init_lm_local(cfg: ModelConfig, source, keep=None, *, device=None) -> LM:
    """The model of ``source`` (:func:`lm_leaves`: an :func:`init_lm` seed,
    the JAX package's value tree, or a model) built leaf by leaf: each
    whole leaf is made on ``device`` (the GPU unless ``"cpu"`` is asked
    for), handed to ``keep(name, whole)``, and only what that returns is
    held (a mesh rank's block of it: ``launch.steps.local_model``), so the
    whole model never exists at once; ``keep=None`` holds every leaf
    whole."""
    named = {}
    for name, whole in lm_leaves(cfg, source, device=device):
        named[name] = whole if keep is None else keep(name, whole)
        del whole  # before the next leaf is made
    return _assemble(cfg, named)


#: a decoder layer's blocks by name, and their classes (``attn`` is MLA's
#: where the config has MLA)
_BLOCKS = {"ln1": Norm, "attn": Attention, "mamba": Mamba, "ln_attn_out": Norm,
           "ln_ssm_out": Norm, "lnx": Norm, "xattn": Attention, "ln2": Norm, "mlp": MLP,
           "moe": MoE}


def _assemble(cfg: ModelConfig, named: dict) -> LM:
    """The :class:`LM` whose parameters are ``named`` (``named_parameters``'
    names), each block's in ``named``'s order."""
    tree: dict = {}
    for name, t in named.items():
        node, *parts = name.split(".")
        at = tree.setdefault(node, {}) if parts else tree
        for part in parts[:-1]:
            at = at.setdefault(part, {})
        at[parts[-1] if parts else node] = t

    def block(cls, values: dict):
        return cls(**{k: v if not isinstance(v, dict) else block(MLP, v)  # an MoE's shared experts
                      for k, v in values.items()})

    def layer(values: dict) -> DecoderLayer:
        return DecoderLayer(**{k: block(MLA if k == "attn" and cfg.mla is not None else _BLOCKS[k],
                                        v) for k, v in values.items()})

    encoder = None
    if "encoder" in tree:
        enc = tree["encoder"]
        encoder = Encoder([layer(enc["layers"][str(j)]) for j in range(len(enc["layers"]))],
                          Norm(**enc["final_norm"]))
    return LM(embed=tree["embed"], lm_head=tree.get("lm_head"), meta=tree.get("meta"),
              vision_proj=tree.get("vision_proj"), final_norm=Norm(**tree["final_norm"]),
              layers=[layer(tree["layers"][str(i)]) for i in range(cfg.n_layers)],
              segments=cfg.segments(), encoder=encoder)


def lm_leaves(cfg: ModelConfig, source, *, device=None):
    """``(name, whole tensor)`` of every weight of the model ``source``
    names, one at a time (``named_parameters``' names): an :func:`init_lm`
    seed (an int: the leaves drawn on ``device`` in the order of
    :func:`init_lm`'s random draws, so any consumer sees the same values),
    the JAX package's unpaired value tree of numpy arrays (each leaf a
    tensor on ``device`` as :func:`lm_params_from_numpy` makes it), or an
    :class:`LM` (its own parameters, detached)."""
    if isinstance(source, LM):
        yield from ((name, p.detach()) for name, p in source.named_parameters())
    elif isinstance(source, int):
        yield from _init_leaves(cfg, source, resolve_device(device))
    else:
        yield from _numpy_leaves(cfg, source, resolve_device(device))


def _init_leaves(cfg: ModelConfig, seed: int, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, H, KH, hd, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    tn = lambda shape, fan_in: _trunc_normal(shape, fan_in, gen, dev)
    ones = lambda *shape: torch.ones(shape, device=dev)
    zeros = lambda *shape: torch.zeros(shape, device=dev)

    def norm(p: str):
        yield f"{p}.scale", ones(d)
        if cfg.norm == "layernorm":
            yield f"{p}.bias", zeros(d)

    def mlp(p: str, f: int):
        yield f"{p}.w_gate", tn((d, f), d)
        yield f"{p}.w_up", tn((d, f), d)
        yield f"{p}.w_down", tn((f, d), f)

    def ffn(p: str, kind: str):
        mo = cfg.moe
        if kind == "moe":
            E, fe = mo.n_experts, mo.d_ff_expert
            yield f"{p}.moe.router", tn((d, E), d)
            yield f"{p}.moe.w_gate", tn((E, d, fe), d)
            yield f"{p}.moe.w_up", tn((E, d, fe), d)
            yield f"{p}.moe.w_down", tn((E, fe, d), fe)
            if mo.n_shared:
                yield from mlp(f"{p}.moe.shared", fe * mo.n_shared)
        else:
            yield from mlp(f"{p}.mlp", mo.d_ff_dense if mo is not None else f)

    def plain_attention(p: str):  # no biases, no qk-norm: cross and encoder
        yield f"{p}.wq", tn((d, H, hd), d)
        yield f"{p}.wk", tn((d, KH, hd), d)
        yield f"{p}.wv", tn((d, KH, hd), d)
        yield f"{p}.wo", tn((H, hd, d), H * hd)

    def attention(p: str):
        if cfg.mla is not None:
            m = cfg.mla
            R, nope, rp, v = m.kv_lora_rank, m.qk_nope_dim, m.qk_rope_dim, m.v_head_dim
            yield f"{p}.wq", tn((d, H, nope + rp), d)
            yield f"{p}.w_dkv", tn((d, R), d)
            yield f"{p}.w_kr", tn((d, rp), d)
            yield f"{p}.w_uk", tn((R, H, nope), R)
            yield f"{p}.w_uv", tn((R, H, v), R)
            yield f"{p}.wo", tn((H, v, d), H * v)
            yield f"{p}.kv_norm", ones(R)
            return
        yield from plain_attention(p)
        if cfg.qkv_bias:
            yield from ((f"{p}.{n}", zeros(h, hd)) for n, h in (("bq", H), ("bk", KH), ("bv", KH)))
        if cfg.qk_norm:
            yield f"{p}.q_norm", ones(hd)
            yield f"{p}.k_norm", ones(hd)

    def mamba(p: str):
        s = cfg.ssm
        d_in, GN, W = s.expand * d, s.n_groups * s.d_state, s.conv_width
        H_s = d_in // s.head_dim
        passthrough = zeros(W, GN)
        passthrough[-1] = 1.0
        u = torch.rand((H_s,), generator=gen, device=dev)
        dt0 = torch.exp(u * (math.log(s.dt_max) - math.log(s.dt_min)) + math.log(s.dt_min))
        conv_x = torch.randn((W, d_in), generator=gen, device=dev) / math.sqrt(W)
        yield f"{p}.w_z", tn((d, d_in), d)
        yield f"{p}.w_x", tn((d, d_in), d)
        yield f"{p}.w_B", tn((d, GN), d)
        yield f"{p}.w_C", tn((d, GN), d)
        yield f"{p}.w_dt", tn((d, H_s), d)
        yield f"{p}.conv_x", conv_x
        yield f"{p}.conv_B", passthrough
        yield f"{p}.conv_C", passthrough.clone()
        yield f"{p}.A_log", torch.log(torch.arange(1, H_s + 1, dtype=torch.float32, device=dev))
        yield f"{p}.D", ones(H_s)
        yield f"{p}.dt_bias", dt0 + torch.log(-torch.expm1(-dt0))
        yield f"{p}.norm", ones(d_in)
        yield f"{p}.w_out", tn((d_in, d), d_in)

    def layer(p: str, kind: str):
        yield from norm(f"{p}.ln1")
        if kind == "ssm":
            yield from mamba(f"{p}.mamba")
        elif kind in ("hybrid_full", "hybrid_swa"):
            if f:  # drawn before the attention and the SSM block, as init_lm always has
                yield from norm(f"{p}.ln2")
                yield from mlp(f"{p}.mlp", f)
            yield from attention(f"{p}.attn")
            yield from mamba(f"{p}.mamba")
            yield from norm(f"{p}.ln_attn_out")
            yield from norm(f"{p}.ln_ssm_out")
        elif kind == "encdec":
            yield from attention(f"{p}.attn")
            yield from norm(f"{p}.ln2")
            yield from mlp(f"{p}.mlp", f)
            yield from norm(f"{p}.lnx")
            yield from plain_attention(f"{p}.xattn")
        else:
            yield from attention(f"{p}.attn")
            yield from norm(f"{p}.ln2")
            yield from ffn(p, kind)

    yield "embed", tn((padded_vocab(cfg), d), d)
    for i in range(cfg.n_layers):
        yield from layer(f"layers.{i}", cfg.layer_kind(i))
    if not cfg.tie_embeddings:
        yield "lm_head", tn((d, padded_vocab(cfg)), d)
    if cfg.meta_tokens:
        yield "meta", torch.randn((cfg.meta_tokens, d), generator=gen, device=dev) * 0.02
    if cfg.vision_prefix:
        E = cfg.vision_embed_dim
        yield "vision_proj", tn((E, d), E)
    if cfg.encoder is not None:
        for j in range(cfg.encoder.n_layers):
            p = f"encoder.layers.{j}"
            yield from norm(f"{p}.ln1")
            yield from plain_attention(f"{p}.attn")
            yield from norm(f"{p}.ln2")
            yield from mlp(f"{p}.mlp", f)
        yield from norm("encoder.final_norm")
    yield from norm("final_norm")


def _numpy_leaves(cfg: ModelConfig, values: dict, dev):
    def tensor(a) -> torch.Tensor:
        return torch.as_tensor(np.array(a), device=dev).float()

    def block(prefix: str, sub: dict, l: int):
        for k, v in sub.items():
            if k.endswith("_pairing"):
                raise ValueError("the value tree carries pairing metadata: a mesh pairs each "
                                 "rank's shards itself")
            if isinstance(v, dict):  # an MoE's shared experts
                yield from block(f"{prefix}.{k}", v, l)
            else:
                yield f"{prefix}.{k}", tensor(v[l])

    def stack(prefix: str, segments: list, counts):
        i = 0
        for count, seg in zip(counts, segments, strict=True):
            for l in range(count):
                for name, sub in seg.items():
                    yield from block(f"{prefix}.{i}.{name}", sub, l)
                i += 1

    yield "embed", tensor(values["embed"])
    yield from stack("layers", values["segments"], [n for _, n in cfg.segments()])
    for name in ("lm_head", "meta", "vision_proj"):
        if values.get(name) is not None:
            yield name, tensor(values[name])
    if "encoder" in values:
        enc = values["encoder"]
        yield from stack("encoder.layers", enc["segments"],
                         [len(np.asarray(seg["ln1"]["scale"])) for seg in enc["segments"]])
        yield from ((f"encoder.final_norm.{k}", tensor(a)) for k, a in enc["final_norm"].items())
    yield from ((f"final_norm.{k}", tensor(a)) for k, a in values["final_norm"].items())


def lm_params_from_numpy(values: dict, cfg: ModelConfig, *, device=None) -> LM:
    """The model from the JAX package's value tree (``param.unzip(init_lm(…))[0]``
    with every leaf mapped to a numpy array).

    Each segment's stacked ``(L, …)`` leaves split into per-layer weights;
    ``"<name>_pairing"`` siblings (``core.transform.pair_lm_params``) carry
    over as each layer's pairing metadata (lane lists as int64), an MoE
    layer's ``(E, …)`` per-expert metadata and its nested ``shared`` block
    included; so do an SSM block (``mamba``), a hybrid layer's output norms,
    the ``meta`` tokens, the cross-attention (``lnx``, ``xattn``), the
    ``encoder`` (its segments and final norm), every LayerNorm's ``bias``
    and the ``vision_proj``.
    """
    dev = resolve_device(device)

    def tensor(a) -> torch.Tensor:
        t = torch.as_tensor(np.array(a), device=dev)
        return t.long() if not t.is_floating_point() else t.float()

    def block(cls, sub: dict, l: int):
        pairing = {k[: -len("_pairing")]: {mk: tensor(mv[l]) for mk, mv in v.items()}
                   for k, v in sub.items() if k.endswith("_pairing")}
        weights = {k: tensor(v[l]) for k, v in sub.items() if not isinstance(v, dict)}
        shared = {k: block(MLP, v, l) for k, v in sub.items()  # an MoE's shared experts
                  if isinstance(v, dict) and not k.endswith("_pairing")}
        return cls(pairing=pairing, **weights, **shared)

    classes = {**_BLOCKS, "attn": MLA if cfg.mla is not None else Attention}

    def stack_of(segments: list, counts) -> list[DecoderLayer]:
        layers = []
        for count, seg in zip(counts, segments, strict=True):
            for l in range(count):
                layers.append(DecoderLayer(**{name: block(cls, seg[name], l)
                                              for name, cls in classes.items() if name in seg}))
        return layers

    def norm_of(v: dict) -> Norm:
        return Norm(**{k: tensor(a) for k, a in v.items()})

    encoder = None
    if "encoder" in values:
        enc = values["encoder"]
        counts = [len(np.asarray(seg["ln1"]["scale"])) for seg in enc["segments"]]
        encoder = Encoder(stack_of(enc["segments"], counts), norm_of(enc["final_norm"]))
    layers = stack_of(values["segments"], [n for _, n in cfg.segments()])
    opt = {name: None if values.get(name) is None else tensor(values[name])
           for name in ("lm_head", "meta", "vision_proj")}
    return LM(embed=tensor(values["embed"]), final_norm=norm_of(values["final_norm"]),
              layers=layers, segments=cfg.segments(), encoder=encoder, **opt)


def _block_values(block: nn.Module) -> dict:
    """A block's weights by name, a child block's nested under its name."""
    return {**dict(block.named_parameters(recurse=False)),
            **{name: _block_values(child) for name, child in block.named_children()}}


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack([t.detach() for t in trees])


def _stacked_segments(layers, segments) -> list[dict]:
    out, start = [], 0
    for _, count in segments:
        out.append(_stack([{name: _block_values(b) for name, b in layer.named_children()}
                           for layer in layers[start:start + count]]))
        start += count
    return out


def _norm_values(norm: Norm) -> dict:
    return {k: t.detach().clone() for k, t in norm.named_parameters()}


def lm_value_tree(model: LM) -> dict:
    """The model's weights in the JAX package's value-tree layout (what
    :func:`lm_params_from_numpy` reads, without pairing metadata): each
    segment's per-layer weights stacked along a leading layers axis (the
    encoder's too), as new tensors on the weights' device."""
    tree = {"embed": model.embed.detach().clone(), "final_norm": _norm_values(model.final_norm),
            "segments": _stacked_segments(model.layers, model.segments)}
    for name in ("lm_head", "meta", "vision_proj"):
        if getattr(model, name, None) is not None:
            tree[name] = getattr(model, name).detach().clone()
    if model.encoder is not None:
        enc = model.encoder
        tree["encoder"] = {"segments": _stacked_segments(enc.layers, enc.segments),
                           "final_norm": _norm_values(enc.final_norm)}
    return tree


def load_lm_values(model: LM, tree: dict) -> None:
    """Copy a value tree of :func:`lm_value_tree`'s layout into the model's
    weights, in place."""
    def load(block: nn.Module, values: dict, l: int | None):
        for name, t in block.named_parameters(recurse=False):
            t.copy_(values[name] if l is None else values[name][l])
        for name, child in block.named_children():
            load(child, values[name], l)

    def load_stack(layers, segments, seg_trees):
        start = 0
        for (_, count), seg in zip(segments, seg_trees, strict=True):
            for l in range(count):
                for name, block in layers[start + l].named_children():
                    load(block, seg[name], l)
            start += count

    with torch.no_grad():
        load_stack(model.layers, model.segments, tree["segments"])
        load(model.final_norm, tree["final_norm"], None)
        if model.encoder is not None:
            enc = model.encoder
            load_stack(enc.layers, enc.segments, tree["encoder"]["segments"])
            load(enc.final_norm, tree["encoder"]["final_norm"], None)
        for name in ("embed", "lm_head", "meta", "vision_proj"):
            if getattr(model, name, None) is not None:
                getattr(model, name).copy_(tree[name])


def hold_paired_in_compute_dtype(cfg: ModelConfig, model: LM) -> None:
    """Store every weight of ``model`` that carries pairing metadata in the
    compute dtype, in place.

    For serving once pairing is done (it reads the fp32 masters): every use
    of such a weight casts it to the compute dtype first (``Block.matrix``,
    the expert GEMMs, the paired segments), so the results keep their bits,
    but every model sharing these parameters (the unpaired one it was paired
    from, too) holds them so from here.  The router, norms and the unpaired
    weights stay as they are.
    """
    cdt = compute_dtype(cfg)
    for block in model.modules():
        for name in getattr(block, "pairing", {}):
            w = getattr(block, name)
            w.data = w.data.to(cdt)


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------


def _sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(B, S) positions → (B, S, d) fp32 sinusoidal embedding (whisper's),
    the sines then the cosines of ``half = d // 2`` frequencies
    ``10000^(−i / max(half − 1, 1))``, as in the JAX package."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=positions.device)
                      / max(half - 1, 1))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def embed_tokens(cfg: ModelConfig, model: LM, tokens: torch.Tensor, cdt,
                 tp=None, lead: int = 0) -> torch.Tensor:
    """Rows of the embedding in the compute dtype, scaled by sqrt(d_model)
    in that dtype when it is tied as the head, after ``lead`` zero rows
    (the positions of the meta tokens that precede the tokens).  With the
    vocab split over a mesh, each rank looks up the tokens its rows hold
    (zeros for the rest) and an all-reduce over ``model`` sums them: the
    one row, exactly.  A token no rank holds raises ``IndexError`` on every
    rank (they all see the same tokens), as the whole table's lookup does
    on one device.

    A training rank (``tp.train``) returns its positions of that stream of
    ``lead + S`` rows: under sequence parallelism the split lookup is
    reduce-scattered along the stream (``layers.close_partial``), and a
    whole table's rows are sliced to the rank's positions.  An FSDP rank
    gathers its columns of the table over the data axes first, in the
    compute dtype (the rows it looks up are cast to it anyway)."""
    lead_rows = (lambda t: F.pad(t, (0, 0, lead, 0))) if lead else (lambda t: t)
    embed = _top(model, tp, ("embed",), cdt)["embed"]
    if tp is not None and tp.vocab_split:
        rows = embed.shape[0]
        bad = (tokens < 0) | (tokens >= rows * tp.n)
        if bool(bad.any()):
            raise IndexError(f"token ids {tokens[bad].tolist()[:8]} outside the "
                             f"embedding's {rows * tp.n} rows")
        local = tokens - tp.r * rows
        held = (local >= 0) & (local < rows)
        # the rows in the masters' dtype (exact from the gathered compute dtype)
        h = (embed[local.clamp(0, rows - 1)] * held[..., None].to(embed.dtype)).to(
            model.embed.dtype)
        h = (close_partial(tp, lead_rows(h), cdt) if tp.train
             else lead_rows(all_reduce(h, tp.model_group).to(cdt)))
    elif tp is not None and tp.train and tp.seq_split:
        h = lead_rows(embed[tokens].to(cdt))[:, tp.own(lead + tokens.shape[1])]
    else:
        h = lead_rows(embed[tokens].to(cdt))
    if not cfg.tie_embeddings:
        return h
    return h * torch.tensor(math.sqrt(cfg.d_model), dtype=cdt, device=h.device)


def _top(model: LM, tp, names: tuple[str, ...], cdt) -> dict[str, torch.Tensor]:
    """The model's weights ``names`` (``"embed"``, ``"final_norm.scale"``, …)
    as the forward reads them: on an FSDP rank those its layout gathers
    (``tp.top_gathers``) gathered over the data axes, in one call
    (``layers.gather_weights``), the rest its own."""
    got = {} if tp is None else gather_weights(
        tp, model, tuple((n, d) for n, d in tp.top_gathers if n in names), cdt)
    return {n: got[n] if n in got else model.get_parameter(n) for n in names}


def _head_weights(cfg: ModelConfig, model: LM, tp, cdt) -> tuple[Norm, torch.Tensor]:
    """The final norm and the head's weight (the tied embedding (Vp, d) or
    ``lm_head`` (d, Vp)), gathered together on an FSDP rank (:func:`_top`)."""
    norm = tuple(f"final_norm.{n}" for n, _ in model.final_norm.named_parameters())
    head = "embed" if cfg.tie_embeddings else "lm_head"
    got = _top(model, tp, (*norm, head), cdt)
    swapped = {n[len("final_norm."):]: got[n] for n in norm
               if tp is not None and n in dict(tp.top_gathers)}
    return model.final_norm.rebound(swapped), got[head]


def lm_logits(cfg: ModelConfig, model: LM, h: torch.Tensor, tp=None) -> torch.Tensor:
    """Final norm, then the head (the tied embedding, or ``lm_head``) in the
    compute dtype; fp32 logits with the padded vocab set to −1e9.  With the
    vocab split over a mesh, each rank's logits over its vocab columns are
    all-gathered over ``model``; an FSDP rank gathers the norm and the head
    over the data axes first (:func:`_head_weights`)."""
    if tp is not None and tp.top_gathers:
        norm, w = _head_weights(cfg, model, tp, h.dtype)
        h, w = norm(h), (w.t() if cfg.tie_embeddings else w).to(h.dtype)
    else:
        h = model.final_norm(h)
        w = model.derived(("head", h.dtype), lambda: model.embed.to(h.dtype).t()
                          if cfg.tie_embeddings else model.lm_head.to(h.dtype))
    logits = torch.matmul(h, w).float()
    if tp is not None and tp.vocab_split:
        logits = all_gather(logits, tp.model_group, dim=-1)
    logits[..., cfg.vocab:] = -1e9
    return logits


# ---------------------------------------------------------------------------
# forward / prefill
# ---------------------------------------------------------------------------


def _window_for(cfg: ModelConfig, kind: str) -> int:
    """The sliding window of a layer of ``kind`` (0: full attention): the
    config's on a hybrid model's ``hybrid_swa`` layers and on dense and MoE
    layers, none on ``hybrid_full`` ones."""
    return cfg.sliding_window if kind in ("dense", "moe", "hybrid_swa") else 0


def _ffn(cfg: ModelConfig, p: DecoderLayer, h: torch.Tensor, knobs: PerfKnobs, tp=None):
    """``(h + ffn(ln2(h)), aux)``: the skip connection rides the MLP's
    down-projection (the paired kernel's epilogue under gemm="pallas_paired");
    the experts' gated sum is added after their combine, as in the JAX
    package, and ``aux`` is their load-balance loss (0 without experts)."""
    if p.ffn is None:  # an SSM layer
        return h, _no_aux(h)
    x = seq_enter(tp, p.ln2(h))
    if p.ffn == "moe":
        y, aux = moe_block(cfg, p.moe, x, knobs, tp=tp)
        return h + y, aux
    return mlp_block(cfg, p.mlp, x, knobs, residual=h, tp=tp), _no_aux(h)


def _no_aux(h: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=h.device)


def _mla_with_cache(cfg: ModelConfig, p: MLA, x: torch.Tensor, positions: torch.Tensor,
                    knobs: PerfKnobs, tp=None):
    """MLA prefill that also returns its compressed cache entries:
    ``(y, {"c_kv": (B, S, R), "k_rope": (B, S, rope)})``."""
    y, c_kv, k_rope = mla_block(cfg, p, x, positions, knobs, tp=tp)
    return y, {"c_kv": c_kv, "k_rope": k_rope}


def _ssm_with_cache(cfg: ModelConfig, p: Mamba, x: torch.Tensor, knobs: PerfKnobs, tp=None):
    """SSM prefill that also returns the block's decode cache entries: ``(y,
    {"h": (B, H, P, N) fp32, "conv_x"/"conv_B"/"conv_C": (B, W − 1, C)})``.

    A conv tail is the last W − 1 conv inputs, left-padded with zero rows
    when the sequence is shorter: the causal conv pads so too, and a decode
    step then continues the prompt exactly.  (The JAX package takes
    ``x[:, -(W - 1):]``, which is short for a prompt of fewer than W − 1
    tokens.)
    """
    y, h, raw = ssm_forward(cfg, p, x, knobs, tp)
    W = cfg.ssm.conv_width
    tails = {name: F.pad(t, (0, 0, W - 1, 0))[:, -(W - 1):] for name, t in raw.items()}
    return y, {"h": h, **tails}


def _hybrid_mix(p: DecoderLayer, a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """A hybrid layer's sublayer output: the mean of the normed attention and
    SSM outputs."""
    return 0.5 * (p.ln_attn_out(a) + p.ln_ssm_out(m))


def _xattn_q(p: Attention, xq: torch.Tensor, knobs: PerfKnobs) -> torch.Tensor:
    """The cross-attention's query (B, S, H, hd) through ``dense``, so its
    ``wq`` pairing reaches the paired kernel."""
    return _leaf_dense(p, "wq", xq, knobs).reshape(*xq.shape[:-1], *p.wq.shape[-2:])


def _cross_kv(p: Attention, enc_out: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The encoder output's keys and values (B, F, KH, hd): plain products
    against ``wk``/``wv`` (run once a prefill, never paired)."""
    cdt = enc_out.dtype

    def proj(name):
        w = p.derived(("matrix", name, cdt), lambda: p.matrix(name, cdt))
        return torch.matmul(enc_out, w).reshape(*enc_out.shape[:-1], *getattr(p, name).shape[-2:])

    return proj("wk"), proj("wv")


def _cross_view(tp):
    """The view of a layer's cross-attention: its own head splits."""
    return None if tp is None else dataclasses.replace(tp, q_split=tp.xq_split,
                                                       kv_split=tp.xkv_split)


def _cross_attention(p: Attention, xq: torch.Tensor, enc_out: torch.Tensor, knobs: PerfKnobs,
                     residual: torch.Tensor | None = None, tp=None):
    """Cross-attention of ``xq`` (B, S, d) over the encoder output:
    ``(residual + wo(attention), xk, xv)``, the attention every query
    against every frame (:func:`~repro_torch.models.layers.full_attention`,
    K3 under ``attn="pallas_fused"``), the skip connection fused into the
    out-projection; ``xk``/``xv`` fill the decode cache.  On a mesh the
    rank's query heads read the KV heads its ``wk``/``wv`` slices make
    (the ones its cross cache holds), and wo is row-parallel."""
    xtp = _cross_view(tp)
    xk, xv = _cross_kv(p, enc_out)
    out = full_attention(_xattn_q(p, xq, knobs), *local_kv(xtp, xk, xv), knobs)
    return attn_out_proj(p, out, knobs, residual=residual, tp=xtp), xk, xv


def _encoder_layer(cfg: ModelConfig, p: DecoderLayer, knobs: PerfKnobs, tp,
                   h: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """One encoder layer: non-causal self-attention (no qkv bias, no
    qk-norm), then the MLP, each added to ``h`` after it (on a mesh each
    all-reduced first: wo and w_down are row-parallel; an FSDP rank's
    data-split weights gathered at its top)."""
    p = gather_layer(tp, p, h.dtype)
    a, _, _ = attention_block(cfg, p.attn, p.ln1(h), positions, knobs, causal=False, tp=tp)
    h = h + a
    return h + mlp_block(cfg, p.mlp, p.ln2(h), knobs, tp=tp)


def encoder_fwd(cfg: ModelConfig, enc: Encoder, frames: torch.Tensor,
                knobs: PerfKnobs = DEFAULT_KNOBS, *, train: bool = False,
                tp=None) -> torch.Tensor:
    """The audio encoder over ``frames`` (B, F, d), precomputed frame
    embeddings in the compute dtype (the conv front end is a stub): the
    sinusoid added, the layers, the final norm → (B, F, d).  With ``train``
    each layer runs under :func:`_remat`, as the JAX package's scan does.
    On a mesh (``tp``, the encoder's view) every rank runs it over its
    heads and hidden columns, and every rank ends with the whole output."""
    B, n = frames.shape[:2]
    positions = torch.arange(n, device=frames.device).expand(B, n)
    h = frames + _sinusoid(positions, cfg.d_model).to(frames.dtype)
    ecfg = dataclasses.replace(cfg, qkv_bias=False, qk_norm=False)
    for layer in enc.layers:
        step = functools.partial(_encoder_layer, ecfg, layer, knobs, tp)
        h = (_remat(step, knobs) if train else step)(h, positions)
    if tp is None or not tp.top("encoder.final_norm."):
        return enc.final_norm(h)
    return enc.final_norm.rebound(gather_weights(tp, enc.final_norm,
                                                 tp.top("encoder.final_norm."), h.dtype))(h)


def layer_fwd(cfg: ModelConfig, kind: str, p: DecoderLayer, h: torch.Tensor,
              positions: torch.Tensor, knobs: PerfKnobs = DEFAULT_KNOBS,
              enc_out: torch.Tensor | None = None, tp=None):
    """One decoder layer over a sequence. Returns (h, cache entries, aux):
    the post-rope K/V of this layer, ``{"k", "v"}`` (B, S, KH, hd), or MLA's
    latent ``{"c_kv", "k_rope"}``; an SSM block's ``{"h", "conv_x",
    "conv_B", "conv_C"}`` (a hybrid layer's beside its K/V); an
    encoder-decoder layer's cross-attention keys and values over
    ``enc_out``, ``{"xk", "xv"}`` (B, F, KH, hd), beside its K/V; the MoE
    load-balance loss (fp32 scalar, 0 without experts).  On a mesh (``tp``,
    the layer's view) the rank's part of it: the K/V, latent and SSM entries
    in the layout the rank's cache holds, over all positions.  A
    sequence-parallel training rank's ``h`` is its positions of the stream:
    every block runs on all of them (``layers.seq_enter``; a hybrid layer's
    two branches on one gather) and returns the rank's.  An FSDP rank gathers
    the layer's data-split weights over the data axes first (inside the
    layer's checkpoint: the backward gathers them again)."""
    p = gather_layer(tp, p, h.dtype)
    # a sequence-parallel training rank gathers the block's positions first
    x = seq_enter(tp, p.ln1(h))
    if kind == "ssm":
        y, c = _ssm_with_cache(cfg, p.mamba, x, knobs, tp)
        return h + y, c, _no_aux(h)
    if kind in ("hybrid_full", "hybrid_swa"):
        # attention (windowed on hybrid_swa, the meta tokens its sinks) beside
        # the SSM block; no skip connection rides the out-projection here:
        # each branch is normed whole (a mesh's row-parallel sums closed
        # first; the norms act on each position alone, so a training rank's
        # run on its positions)
        a, k, v = attention_block(cfg, p.attn, x, positions, knobs,
                                  window=_window_for(cfg, kind), n_sink=cfg.meta_tokens, tp=tp)
        m, c = _ssm_with_cache(cfg, p.mamba, x, knobs, tp)
        h, aux = _ffn(cfg, p, h + _hybrid_mix(p, a, m), knobs, tp)
        return h, {"k": k, "v": v, **c}, aux
    if cfg.mla is not None:
        # the JAX package adds MLA's output after its out-projection
        y, c = _mla_with_cache(cfg, p.attn, x, positions, knobs, tp)
        h, aux = _ffn(cfg, p, h + y, knobs, tp)
        return h, c, aux
    # the skip connections ride the out- and down-projections (fused into
    # the paired kernel's epilogue under gemm="pallas_paired")
    h, k, v = attention_block(cfg, p.attn, x, positions, knobs,
                              window=_window_for(cfg, kind), residual=h, tp=tp)
    c = {"k": k, "v": v}
    if kind == "encdec":
        h, c["xk"], c["xv"] = _cross_attention(p.xattn, seq_enter(tp, p.lnx(h)), enc_out, knobs,
                                               residual=h, tp=tp)
    h, aux = _ffn(cfg, p, h, knobs, tp)
    return h, c, aux


def _extra(cfg: ModelConfig, extras: dict | None, name: str) -> torch.Tensor:
    if not extras or extras.get(name) is None:
        raise ValueError(f"{cfg.name} ({cfg.family}) needs extras[{name!r}] beside the tokens "
                         "(launch.inputs.make_batch makes seeded stubs)")
    return extras[name]


def _splice(h: torch.Tensor, rows: torch.Tensor, at: int, own: slice) -> torch.Tensor:
    """``h`` (B, ·, d), the positions ``own`` of a stream, with those of the
    stream's positions ``at …`` that ``rows`` (B, n, d) hold and ``own``
    covers replaced by them (a rank's share of a prefix; ``h`` itself where
    it holds none)."""
    a, b = max(own.start, at), min(own.stop, at + rows.shape[1])
    if a >= b:
        return h
    return torch.cat([h[:, :a - own.start], rows[:, a - at:b - at], h[:, b - own.start:]],
                     dim=1)


def _prepare_inputs(cfg: ModelConfig, model: LM, tokens: torch.Tensor, extras: dict | None,
                    knobs: PerfKnobs, *, train: bool = False, tp=None):
    """The embedded tokens (B, meta_tokens + S, d) in the compute dtype, a
    hybrid model's ``meta`` rows first, a vision-language model's first
    ``vision_prefix`` rows replaced by ``extras["patches"] @ vision_proj``,
    an encoder-decoder model's with the sinusoid added; their positions
    (B, meta_tokens + S); and the encoder's output over ``extras["frames"]``
    (None without an encoder).  A sequence-parallel training rank's rows
    are its positions of that stream (:func:`embed_tokens`): the meta rows,
    patch rows and sinusoid of those positions alone (the rank that holds
    no patch position replaces none); the positions stay the whole
    stream's.  The encoder runs over all frames on every rank (its view's
    stream is whole)."""
    cdt = compute_dtype(cfg)
    B, S = tokens.shape[0], cfg.meta_tokens + tokens.shape[1]
    h = embed_tokens(cfg, model, tokens, cdt, tp, lead=cfg.meta_tokens)
    own = tp.own(S) if tp is not None and tp.train and tp.seq_split else slice(0, S)
    if cfg.vision_prefix:  # vision_proj is whole on every rank of a mesh
        proj = model.derived(("vision_proj", cdt), lambda: model.vision_proj.to(cdt))
        pe = torch.matmul(_extra(cfg, extras, "patches").to(cdt), proj)
        h = _splice(h, pe, cfg.meta_tokens, own)
    if cfg.meta_tokens:
        h = _splice(h, model.meta.to(cdt)[None].expand(B, *model.meta.shape), 0, own)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    enc_out = None
    if cfg.encoder is not None:
        h = h + _sinusoid(positions[:, own], cfg.d_model).to(cdt)
        enc_out = encoder_fwd(cfg, model.encoder, _extra(cfg, extras, "frames").to(cdt), knobs,
                              train=train, tp=None if tp is None else tp.encoder_view())
    return h, positions, enc_out


def lm_forward(cfg: ModelConfig, model: LM, tokens: torch.Tensor, *,
               knobs: PerfKnobs = DEFAULT_KNOBS, collect_cache: bool = False,
               extras: dict | None = None):
    """tokens (B, S) → (logits (B, S, Vp) fp32, cache or None); the cache
    holds each layer's entries of :func:`layer_fwd` stacked, (L, B, …).

    A hybrid model's ``meta`` tokens precede the prompt: the layers see
    ``meta_tokens + S`` positions (their K/V cache entries too), and the
    logits are the prompt's S.  ``extras`` holds an encoder-decoder model's
    ``"frames"`` (B, F, d) or a vision-language model's ``"patches"`` (B,
    vision_prefix, vision_embed_dim); the encoder runs once."""
    h, positions, enc_out = _prepare_inputs(cfg, model, tokens, extras, knobs)
    entries = []
    for i, layer in enumerate(model.layers):
        h, c, _ = layer_fwd(cfg, cfg.layer_kind(i), layer, h, positions, knobs, enc_out=enc_out)
        if collect_cache:
            entries.append(c)
    cache = ({name: torch.stack([c[name] for c in entries]) for name in entries[0]}
             if collect_cache else None)
    return lm_logits(cfg, model, h[:, cfg.meta_tokens:]), cache


def prefill(cfg: ModelConfig, model: LM, tokens: torch.Tensor, *,
            knobs: PerfKnobs = DEFAULT_KNOBS, extras: dict | None = None, tp=None):
    """Forward over the prompt; returns (last-position logits (B, 1, Vp),
    cache of :func:`init_cache`'s names: attention entries ``meta_tokens +
    S`` positions long, SSM entries the state after the prompt, the
    cross-attention's over all frames).  The encoder runs once, where the
    JAX package's ``prefill`` runs it a second time for the cross keys and
    values (the same ones).

    On a mesh (``tp``) every rank runs the prompt (the same tokens and
    extras on every data row) through its shards, the encoder's too; the
    head runs on the last position alone (the logits of the others are never
    read), and the cache entries are in the layout the rank's cache holds
    (its heads, channels, and all of a state's heads where they are whole),
    over all ``meta_tokens + S`` positions (the engine keeps the rank's own
    positions of a sequence-sharded cache)."""
    if tp is not None:
        tp = dataclasses.replace(tp, batch_split=False)  # every data row runs the prompt
        h, positions, enc_out = _prepare_inputs(cfg, model, tokens, extras, knobs, tp=tp)
        entries = []
        for i, layer in enumerate(model.layers):
            h, c, _ = layer_fwd(cfg, cfg.layer_kind(i), layer, h, positions, knobs,
                                enc_out=enc_out, tp=tp.layer(i))
            entries.append(c)
        cache = {name: torch.stack([c[name] for c in entries]) for name in entries[0]}
        return lm_logits(cfg, model, h[:, -1:], tp), cache
    logits, cache = lm_forward(cfg, model, tokens, knobs=knobs, collect_cache=True,
                               extras=extras)
    return logits[:, -1:], cache


# ---------------------------------------------------------------------------
# training: remat, the chunked cross-entropy, the loss
# ---------------------------------------------------------------------------


def _dots_policy(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep what a GEMM without batch dimensions computes
    (K1, as its operator ``repro_torch::k1``, and ``aten.mm``/``addmm``, the
    JAX package's ``dots_with_no_batch_dims_saveable``); recompute the
    rest (attention's batched products included)."""
    if op in (torch.ops.repro_torch.k1.default, torch.ops.aten.mm.default,
              torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, knobs: PerfKnobs):
    """``fn`` checkpointed as ``knobs.remat`` says: ``"none"`` runs it as it
    is; ``"full"`` keeps only its inputs and reruns the whole of it in the
    backward (no early stop, as the JAX package's ``jax.checkpoint`` reruns
    the whole layer); ``"dots"`` keeps the GEMMs' outputs
    (:func:`_dots_policy`).  The layers draw no random numbers, so no RNG
    state is kept."""
    if knobs.remat == "none":
        return fn
    context_fn = (functools.partial(create_selective_checkpoint_contexts, _dots_policy)
                  if knobs.remat == "dots" else noop_context_fn)

    def run(*args):
        with set_checkpoint_early_stop(False):
            return checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn,
                              preserve_rng_state=False)

    return run


def _train_layer(cfg: ModelConfig, kind: str, p: DecoderLayer, knobs: PerfKnobs, tp,
                 h: torch.Tensor, positions: torch.Tensor, enc_out: torch.Tensor | None):
    """One decoder layer for the loss: ``(h, aux)``, no cache."""
    h, _, aux = layer_fwd(cfg, kind, p, h, positions, knobs, enc_out=enc_out, tp=tp)
    return h, aux


def _hidden_for_loss(cfg: ModelConfig, model: LM, tokens: torch.Tensor, knobs: PerfKnobs,
                     extras: dict | None = None, tp=None):
    """The forward up to the final-normed hidden states (B, S, d), skipping
    the logits, and the summed router aux loss; each layer (the encoder's
    too) under :func:`_remat`.  A training rank (``tp``, its layout) returns
    its positions of the stream, the meta tokens' included (their loss is
    masked: :func:`chunked_xent`'s ``lead``): (B, (meta_tokens + S)/n, d)
    under sequence parallelism.  Also returns the head's weight
    (:func:`_head_weights`: gathered with the final norm on an FSDP rank)."""
    h, positions, enc_out = _prepare_inputs(cfg, model, tokens, extras, knobs, train=True,
                                            tp=tp)
    aux_total = _no_aux(h)
    for i, layer in enumerate(model.layers):
        step = functools.partial(_train_layer, cfg, cfg.layer_kind(i), layer, knobs,
                                 None if tp is None else tp.layer(i))
        h, aux = _remat(step, knobs)(h, positions, enc_out)
        aux_total = aux_total + aux
    norm, head = _head_weights(cfg, model, tp, h.dtype)
    return norm(h if tp is not None else h[:, cfg.meta_tokens:]), aux_total, head


def _xent_chunk(cfg: ModelConfig, w: torch.Tensor, hx, lx, mx) -> torch.Tensor:
    """Summed masked cross-entropy of one chunk: its fp32 logits against the
    head ``w`` (the tied embedding (Vp, d) or ``lm_head`` (d, Vp)) in the
    hiddens' dtype, the padded vocab at −1e9, the label logit by a masked
    sum (as the JAX package takes it)."""
    w = w.to(hx.dtype)
    logits = torch.matmul(hx, w.t() if cfg.tie_embeddings else w).float()
    vocab = torch.arange(logits.shape[-1], device=hx.device)
    logits = torch.where(vocab < cfg.vocab, logits, -1e9)
    lse = torch.logsumexp(logits, dim=-1)  # (B, chunk)
    lab = torch.where(lx[..., None] == vocab, logits, 0.0).sum(-1)
    return ((lse - lab) * mx).sum()


def _xent_chunk_vocab_split(cfg: ModelConfig, tp, w: torch.Tensor, hx, lx, mx) -> torch.Tensor:
    """:func:`_xent_chunk` on a training rank that holds the head's vocab
    columns ``tp.r·V/n …``: its logits (B, chunk, V/n) fp32, the padded
    vocab at −1e9 where this rank holds it; the log-sum-exp from the largest
    logit over ``model`` (an all-reduce of the maxima, outside the gradient)
    and the sum of the shifted exps, and the label logit from the rank that
    holds it (one all-reduce of both sums, whose gradient each rank's logits
    take whole): the (B, chunk, V) logits are never gathered."""
    w = w.to(hx.dtype)
    logits = torch.matmul(hx, w.t() if cfg.tie_embeddings else w).float()
    vocab = tp.r * logits.shape[-1] + torch.arange(logits.shape[-1], device=hx.device)
    logits = torch.where(vocab < cfg.vocab, logits, -1e9)
    m = all_reduce(logits.detach().amax(-1), tp.model_group, op="max")  # (B, chunk)
    sum_exp = torch.exp(logits - m[..., None]).sum(-1)
    lab = torch.where(lx[..., None] == vocab, logits, 0.0).sum(-1)
    sum_exp, lab = all_reduce(torch.stack([sum_exp, lab]), tp.model_group).unbind(0)
    return ((m + torch.log(sum_exp) - lab) * mx).sum()


def chunked_xent(cfg: ModelConfig, model: LM, h: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor, chunk: int, tp=None, lead: int = 0,
                 w: torch.Tensor | None = None) -> torch.Tensor:
    """Sequence-chunked softmax cross-entropy, summed over the masked
    positions: ``h`` (B, S, d) final-normed hiddens, ``labels`` (B, S) (no
    negatives), ``mask`` (B, S) fp32.

    S is padded to a multiple of ``chunk`` (0 → one chunk of S); each
    chunk's (B, chunk, Vp) fp32 logits are built, reduced and freed, and the
    chunk body is checkpointed, so the backward rebuilds them instead of
    keeping them: the (B, S, Vp) logits never exist.  The head is
    ``torch.matmul``, as the JAX package's is an XLA einsum.

    On a training rank (``tp``) ``h`` is its positions of the stream of
    ``lead + S`` rows (the meta tokens' first), (B, (lead + S)/n, d) under
    sequence parallelism, and the sum is over the rank's rows of the whole
    sequence: with the vocab split over ``model``, ``h`` all-gathered along
    the sequence (``layers.seq_enter``), the lead rows cut, meets the rank's
    vocab columns (:func:`_xent_chunk_vocab_split`); with the head whole,
    each rank sums its own positions (``tp.own``) of the stream, whose
    ``lead`` positions carry masked labels, and an all-reduce over
    ``model`` adds them.
    """
    if tp is not None:
        if tp.vocab_split:
            h = seq_enter(tp, h)[:, lead:]
        else:
            if lead:
                labels, mask = F.pad(labels, (lead, 0)), F.pad(mask, (lead, 0))
            own = tp.own(labels.shape[1])
            if not tp.seq_split:
                h = h[:, own]
            labels, mask = labels[:, own], mask[:, own]
    B, S, _ = h.shape
    if w is None:
        w = model.embed if cfg.tie_embeddings else model.lm_head
    chunk = min(chunk, S) if chunk else S
    n = -(-S // chunk)
    pad = n * chunk - S
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels, mask = F.pad(labels, (0, pad)), F.pad(mask, (0, pad))
    body = (functools.partial(_xent_chunk_vocab_split, cfg, tp)
            if tp is not None and tp.vocab_split else functools.partial(_xent_chunk, cfg))
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(n):
        cols = slice(c * chunk, (c + 1) * chunk)
        total = total + checkpoint(body, w, h[:, cols], labels[:, cols], mask[:, cols],
                                   use_reentrant=False, preserve_rng_state=False)
    if tp is not None and not tp.vocab_split:
        total = all_reduce(total, tp.model_group)
    return total


def lm_loss(cfg: ModelConfig, model: LM, batch: dict, *, knobs: PerfKnobs = DEFAULT_KNOBS,
            tp=None):
    """Masked next-token cross-entropy plus the router's aux loss.

    ``batch`` holds ``"tokens"`` and ``"labels"`` (B, S), and the
    :data:`EXTRAS` the model needs; a negative label masks its position, as
    does a vision-language model's patch positions (a sequence no longer
    than ``vision_prefix`` raises).  Returns ``(loss,
    {"xent", "aux"})``, fp32 scalars, as the JAX package's ``lm_loss``.
    Under ``knobs.gemm="pallas"`` or ``"pallas_paired"`` every layer GEMM's
    forward is a K1 launch and its backward ``torch.matmul``
    (``kernels.ops``).

    On a training rank (``tp``, ``parallel.tp.train_layout_for``'s; the
    rank's shards in ``model``, its rows in ``batch``) the loss is the
    global batch's, the same on every rank: the masked sum and its
    denominator are summed over the data axes that split the batch (one
    all-reduce; the gradient reaches the rank's rows alone), and the aux
    loss is the global batch's (``layers.moe_block``)."""
    labels = batch["labels"]
    if cfg.vision_prefix and labels.shape[1] <= cfg.vision_prefix:
        # the JAX package's lm_loss fails on a shorter one and returns 0 on
        # one of vision_prefix tokens
        raise ValueError(f"{cfg.name}: a sequence of {labels.shape[1]} tokens leaves no "
                         f"labelled position after the {cfg.vision_prefix} patch positions")
    mask = (labels >= 0).float()
    if cfg.vision_prefix:  # patch positions carry no token labels
        mask = mask * (torch.arange(labels.shape[1], device=labels.device) >= cfg.vision_prefix)
    extras = {k: batch[k] for k in EXTRAS if k in batch}
    h, aux, head = _hidden_for_loss(cfg, model, batch["tokens"], knobs, extras, tp)
    total = chunked_xent(cfg, model, h, labels.clamp_min(0), mask, knobs.xent_chunk, tp,
                         lead=cfg.meta_tokens if tp is not None else 0, w=head)
    count = mask.sum()
    if tp is not None and tp.batch_split:
        total, count = all_reduce(torch.stack([total, count]), tp.data_group).unbind(0)
    xent = total / count.clamp_min(1.0)
    return xent + aux, {"xent": xent, "aux": aux}


# ---------------------------------------------------------------------------
# caches + decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int, *, device=None,
               tp=None) -> dict:
    """Empty decode cache in the compute dtype: ``{"k", "v"}`` zeros (L, B,
    S, KH, hd), or for MLA the latent ``{"c_kv": (L, B, S, R), "k_rope":
    (L, B, S, rope)}``, with ``S = max_seq + meta_tokens`` (``max_seq``
    counts token positions, the meta tokens extend it); an SSM block's state
    ``"h"`` (L, B, H, P, N) in fp32 and conv tails ``"conv_x"`` (L, B, W − 1,
    d_in), ``"conv_B"``/``"conv_C"`` (L, B, W − 1, G·N).  A hybrid model has
    both; its sliding-window layers keep the full-length K/V, as the JAX
    package's do (the decode writes at absolute positions).  An
    encoder-decoder model's cross-attention keys and values ``"xk"``/``"xv"``
    (L, B, F, KH, hd) cover all F frames.

    On a mesh (``tp``) the rank's part of every entry, as its resolved spec
    splits it (``TensorParallel.cache_specs``): ``B / dp`` slots where the
    batch is split over the data axes, ``S / n`` positions where the
    attention cache is sequence-sharded, ``KH / n`` heads where the (cross)
    heads are split, the SSM state's heads and the conv tail's channels
    where they are."""
    L, dev = (cfg.n_layers, batch_size), resolve_device(device)
    cdt, S = compute_dtype(cfg), max_seq + cfg.meta_tokens
    shapes = {}
    if cfg.family != "ssm":
        if cfg.mla is not None:
            shapes = {"c_kv": (*L, S, cfg.mla.kv_lora_rank), "k_rope": (*L, S, cfg.mla.qk_rope_dim)}
        else:
            shapes = {name: (*L, S, cfg.n_kv_heads, cfg.head_dim) for name in ("k", "v")}
    if cfg.encoder is not None:
        shapes.update({name: (*L, cfg.encoder.frames, cfg.n_kv_heads, cfg.head_dim)
                       for name in ("xk", "xv")})
    dtypes = dict.fromkeys(shapes, cdt)
    if cfg.ssm is not None:
        s = cfg.ssm
        d_in, GN, W = s.expand * cfg.d_model, s.n_groups * s.d_state, s.conv_width
        shapes["h"] = (*L, d_in // s.head_dim, s.head_dim, s.d_state)
        dtypes["h"] = torch.float32
        for name, width in (("conv_x", d_in), ("conv_B", GN), ("conv_C", GN)):
            shapes[name], dtypes[name] = (*L, W - 1, width), cdt
    if tp is not None:  # the rank's part: each dim (past the layers) as its spec splits it
        shapes = {name: (shape[0], *(tp.local_dim(name, d, n) for d, n in enumerate(shape[1:])))
                  for name, shape in shapes.items()}
    return {name: torch.zeros(shape, dtype=dtypes[name], device=dev)
            for name, shape in shapes.items()}


def layer_decode(cfg: ModelConfig, kind: str, p: DecoderLayer, c: dict,
                 h: torch.Tensor, pos: torch.Tensor, knobs: PerfKnobs = DEFAULT_KNOBS,
                 tp=None):
    """One decoder layer for one token per slot; ``c`` (this layer's cache
    entries, (B, …)) is written in place: attention entries at ``pos`` (the
    absolute position, meta tokens included), the SSM state whole.  On a
    mesh (``tp``, the layer's view) the rank's part of it, an FSDP rank's
    data-split weights gathered first."""
    p = gather_layer(tp, p, h.dtype)
    x = p.ln1(h)
    if kind == "ssm":
        y, c = ssm_decode_block(cfg, p.mamba, x, c, knobs, tp)
        return h + y, c
    if kind in ("hybrid_full", "hybrid_swa"):
        a, _ = attention_decode_block(cfg, p.attn, x, c, pos, knobs,
                                      window=_window_for(cfg, kind), n_sink=cfg.meta_tokens,
                                      tp=tp)
        m, _ = ssm_decode_block(cfg, p.mamba, x, c, knobs, tp)
        return _ffn(cfg, p, h + _hybrid_mix(p, a, m), knobs, tp)[0], c
    if cfg.mla is not None:
        y, c = mla_decode_block(cfg, p.attn, x, c, pos, knobs, tp)
        return _ffn(cfg, p, h + y, knobs, tp)[0], c
    h, c = attention_decode_block(cfg, p.attn, x, c, pos, knobs,
                                  window=_window_for(cfg, kind), residual=h, tp=tp)
    if kind == "encdec":
        # every frame attended (plain, as in the JAX package); wq and wo
        # through dense, the skip connection fused into wo
        xtp = _cross_view(tp)
        q = _xattn_q(p.xattn, p.lnx(h), knobs)
        frames = torch.full_like(pos, c["xk"].shape[1] - 1)
        h = attn_out_proj(p.xattn, decode_attention(q, *local_kv(xtp, c["xk"], c["xv"]), frames),
                          knobs, residual=h, tp=xtp)
    return _ffn(cfg, p, h, knobs, tp)[0], c


def decode_step(cfg: ModelConfig, model: LM, cache: dict, tokens: torch.Tensor,
                pos: torch.Tensor, *, knobs: PerfKnobs = DEFAULT_KNOBS, tp=None):
    """One decode step: tokens (B, 1), pos (B,) in token coordinates →
    (logits (B, 1, Vp), cache); a hybrid model's layers see ``pos +
    meta_tokens``, an encoder-decoder model's embeddings the sinusoid at
    ``pos``.

    The cache is updated in place (and returned): the port's caches are
    mutable, which saves a copy of every layer's K/V per step.

    On a mesh (``tp``) ``tokens`` and ``pos`` cover all slots: where the
    batch is split over the data axes the rank decodes its data row's slots
    against its cache, and the logits of all slots are all-gathered over the
    data axes, so every rank returns (B, 1, Vp).
    """
    if tp is not None and tp.batch_split:
        B_loc = tokens.shape[0] // tp.dp
        rows = slice(tp.dr * B_loc, (tp.dr + 1) * B_loc)
        tokens, pos = tokens[rows], pos[rows]
    cdt = compute_dtype(cfg)
    h = embed_tokens(cfg, model, tokens, cdt, tp)
    pos_abs = pos + cfg.meta_tokens if cfg.meta_tokens else pos
    if cfg.encoder is not None:
        h = h + _sinusoid(pos_abs[:, None], cfg.d_model).to(cdt)
    for i, layer in enumerate(model.layers):
        c: dict[str, Any] = {name: t[i] for name, t in cache.items()}
        h, _ = layer_decode(cfg, cfg.layer_kind(i), layer, c, h, pos_abs, knobs,
                            None if tp is None else tp.layer(i))
    logits = lm_logits(cfg, model, h, tp)
    if tp is not None and tp.batch_split:
        logits = all_gather(logits, tp.data_group, dim=0)
    return logits, cache
