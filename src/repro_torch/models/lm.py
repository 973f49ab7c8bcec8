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
    decode_attention,
    full_attention,
    mla_block,
    mla_decode_block,
    mlp_block,
    moe_block,
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
    (the GPU unless ``"cpu"`` is asked for)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, H, KH, hd, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    tn = lambda shape, fan_in: _trunc_normal(shape, fan_in, gen, dev)
    ones = lambda *shape: torch.ones(shape, device=dev)
    zeros = lambda *shape: torch.zeros(shape, device=dev)

    def norm() -> Norm:
        return Norm(scale=ones(d), bias=zeros(d) if cfg.norm == "layernorm" else None)

    def mlp(f: int) -> MLP:
        return MLP(w_gate=tn((d, f), d), w_up=tn((d, f), d), w_down=tn((f, d), f))

    def ffn(kind: str) -> dict:
        mo = cfg.moe
        if kind == "moe":
            E, fe = mo.n_experts, mo.d_ff_expert
            return {"moe": MoE(router=tn((d, E), d), w_gate=tn((E, d, fe), d),
                               w_up=tn((E, d, fe), d), w_down=tn((E, fe, d), fe),
                               shared=mlp(fe * mo.n_shared) if mo.n_shared else None)}
        return {"mlp": mlp(mo.d_ff_dense if mo is not None else f)}

    def plain_attention() -> Attention:  # no biases, no qk-norm: cross and encoder
        return Attention(wq=tn((d, H, hd), d), wk=tn((d, KH, hd), d), wv=tn((d, KH, hd), d),
                         wo=tn((H, hd, d), H * hd))

    def attention() -> Attention | MLA:
        if cfg.mla is not None:
            m = cfg.mla
            R, nope, rp, v = m.kv_lora_rank, m.qk_nope_dim, m.qk_rope_dim, m.v_head_dim
            return MLA(wq=tn((d, H, nope + rp), d), w_dkv=tn((d, R), d), w_kr=tn((d, rp), d),
                       w_uk=tn((R, H, nope), R), w_uv=tn((R, H, v), R),
                       wo=tn((H, v, d), H * v), kv_norm=ones(R))
        attn = {"wq": tn((d, H, hd), d), "wk": tn((d, KH, hd), d),
                "wv": tn((d, KH, hd), d), "wo": tn((H, hd, d), H * hd)}
        if cfg.qkv_bias:
            attn.update(bq=zeros(H, hd), bk=zeros(KH, hd), bv=zeros(KH, hd))
        if cfg.qk_norm:
            attn.update(q_norm=ones(hd), k_norm=ones(hd))
        return Attention(**attn)

    def mamba() -> Mamba:
        s = cfg.ssm
        d_in, GN, W = s.expand * d, s.n_groups * s.d_state, s.conv_width
        H_s = d_in // s.head_dim
        passthrough = zeros(W, GN)
        passthrough[-1] = 1.0
        u = torch.rand((H_s,), generator=gen, device=dev)
        dt0 = torch.exp(u * (math.log(s.dt_max) - math.log(s.dt_min)) + math.log(s.dt_min))
        conv_x = torch.randn((W, d_in), generator=gen, device=dev) / math.sqrt(W)
        return Mamba(w_z=tn((d, d_in), d), w_x=tn((d, d_in), d), w_B=tn((d, GN), d),
                     w_C=tn((d, GN), d), w_dt=tn((d, H_s), d), conv_x=conv_x,
                     conv_B=passthrough, conv_C=passthrough.clone(),
                     A_log=torch.log(torch.arange(1, H_s + 1, dtype=torch.float32, device=dev)),
                     D=ones(H_s), dt_bias=dt0 + torch.log(-torch.expm1(-dt0)), norm=ones(d_in),
                     w_out=tn((d_in, d), d_in))

    def layer(kind: str) -> DecoderLayer:
        if kind == "ssm":
            return DecoderLayer(norm(), mamba=mamba())
        if kind in ("hybrid_full", "hybrid_swa"):
            ffn_of = {"ln2": norm(), "mlp": mlp(f)} if f else {}
            return DecoderLayer(norm(), attention(), mamba=mamba(),
                                ln_attn_out=norm(), ln_ssm_out=norm(), **ffn_of)
        if kind == "encdec":
            return DecoderLayer(norm(), attention(), norm(), mlp(f), lnx=norm(),
                                xattn=plain_attention())
        return DecoderLayer(norm(), attention(), norm(), **ffn(kind))

    embed = tn((padded_vocab(cfg), d), d)
    layers = [layer(cfg.layer_kind(i)) for i in range(cfg.n_layers)]
    head = None if cfg.tie_embeddings else tn((d, padded_vocab(cfg)), d)
    meta = (torch.randn((cfg.meta_tokens, d), generator=gen, device=dev) * 0.02
            if cfg.meta_tokens else None)
    E = cfg.vision_embed_dim
    vision_proj = tn((E, d), E) if cfg.vision_prefix else None
    encoder = None
    if cfg.encoder is not None:
        encoder = Encoder([DecoderLayer(norm(), plain_attention(), norm(), mlp(f))
                           for _ in range(cfg.encoder.n_layers)], norm())
    return LM(embed=embed, lm_head=head, meta=meta, vision_proj=vision_proj, final_norm=norm(),
              layers=layers, segments=cfg.segments(), encoder=encoder)


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

    classes = {"ln1": Norm, "attn": MLA if cfg.mla is not None else Attention, "mamba": Mamba,
               "ln_attn_out": Norm, "ln_ssm_out": Norm, "lnx": Norm, "xattn": Attention,
               "ln2": Norm, "mlp": MLP, "moe": MoE}

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


def embed_tokens(cfg: ModelConfig, model: LM, tokens: torch.Tensor, cdt) -> torch.Tensor:
    """Rows of the embedding in the compute dtype, scaled by sqrt(d_model)
    in that dtype when it is tied as the head."""
    h = model.embed[tokens].to(cdt)
    if not cfg.tie_embeddings:
        return h
    return h * torch.tensor(math.sqrt(cfg.d_model), dtype=cdt, device=h.device)


def lm_logits(cfg: ModelConfig, model: LM, h: torch.Tensor) -> torch.Tensor:
    """Final norm, then the head (the tied embedding, or ``lm_head``) in the
    compute dtype; fp32 logits with the padded vocab set to −1e9."""
    h = model.final_norm(h)
    w = model.derived(("head", h.dtype), lambda: model.embed.to(h.dtype).t()
                      if cfg.tie_embeddings else model.lm_head.to(h.dtype))
    logits = torch.matmul(h, w).float()
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


def _ffn(cfg: ModelConfig, p: DecoderLayer, h: torch.Tensor, knobs: PerfKnobs):
    """``(h + ffn(ln2(h)), aux)``: the skip connection rides the MLP's
    down-projection (the paired kernel's epilogue under gemm="pallas_paired");
    the experts' gated sum is added after their combine, as in the JAX
    package, and ``aux`` is their load-balance loss (0 without experts)."""
    if p.ffn is None:  # an SSM layer
        return h, _no_aux(h)
    x = p.ln2(h)
    if p.ffn == "moe":
        y, aux = moe_block(cfg, p.moe, x, knobs)
        return h + y, aux
    return mlp_block(cfg, p.mlp, x, knobs, residual=h), _no_aux(h)


def _no_aux(h: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=h.device)


def _mla_with_cache(cfg: ModelConfig, p: MLA, x: torch.Tensor, positions: torch.Tensor,
                    knobs: PerfKnobs):
    """MLA prefill that also returns its compressed cache entries:
    ``(y, {"c_kv": (B, S, R), "k_rope": (B, S, rope)})``."""
    y, c_kv, k_rope = mla_block(cfg, p, x, positions, knobs)
    return y, {"c_kv": c_kv, "k_rope": k_rope}


def _ssm_with_cache(cfg: ModelConfig, p: Mamba, x: torch.Tensor, knobs: PerfKnobs):
    """SSM prefill that also returns the block's decode cache entries: ``(y,
    {"h": (B, H, P, N) fp32, "conv_x"/"conv_B"/"conv_C": (B, W − 1, C)})``.

    A conv tail is the last W − 1 conv inputs, left-padded with zero rows
    when the sequence is shorter: the causal conv pads so too, and a decode
    step then continues the prompt exactly.  (The JAX package takes
    ``x[:, -(W - 1):]``, which is short for a prompt of fewer than W − 1
    tokens.)
    """
    y, h, raw = ssm_forward(cfg, p, x, knobs)
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


def _cross_attention(p: Attention, xq: torch.Tensor, enc_out: torch.Tensor, knobs: PerfKnobs,
                     residual: torch.Tensor | None = None):
    """Cross-attention of ``xq`` (B, S, d) over the encoder output:
    ``(residual + wo(attention), xk, xv)``, the attention every query
    against every frame (:func:`~repro_torch.models.layers.full_attention`,
    K3 under ``attn="pallas_fused"``), the skip connection fused into the
    out-projection; ``xk``/``xv`` fill the decode cache."""
    xk, xv = _cross_kv(p, enc_out)
    out = full_attention(_xattn_q(p, xq, knobs), xk, xv, knobs)
    return attn_out_proj(p, out, knobs, residual=residual), xk, xv


def _encoder_layer(cfg: ModelConfig, p: DecoderLayer, knobs: PerfKnobs, h: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
    """One encoder layer: non-causal self-attention (no qkv bias, no
    qk-norm), then the MLP, each added to ``h`` after it."""
    a, _, _ = attention_block(cfg, p.attn, p.ln1(h), positions, knobs, causal=False)
    h = h + a
    return h + mlp_block(cfg, p.mlp, p.ln2(h), knobs)


def encoder_fwd(cfg: ModelConfig, enc: Encoder, frames: torch.Tensor,
                knobs: PerfKnobs = DEFAULT_KNOBS, *, train: bool = False) -> torch.Tensor:
    """The audio encoder over ``frames`` (B, F, d), precomputed frame
    embeddings in the compute dtype (the conv front end is a stub): the
    sinusoid added, the layers, the final norm → (B, F, d).  With ``train``
    each layer runs under :func:`_remat`, as the JAX package's scan does."""
    B, n = frames.shape[:2]
    positions = torch.arange(n, device=frames.device).expand(B, n)
    h = frames + _sinusoid(positions, cfg.d_model).to(frames.dtype)
    ecfg = dataclasses.replace(cfg, qkv_bias=False, qk_norm=False)
    for layer in enc.layers:
        step = functools.partial(_encoder_layer, ecfg, layer, knobs)
        h = (_remat(step, knobs) if train else step)(h, positions)
    return enc.final_norm(h)


def layer_fwd(cfg: ModelConfig, kind: str, p: DecoderLayer, h: torch.Tensor,
              positions: torch.Tensor, knobs: PerfKnobs = DEFAULT_KNOBS,
              enc_out: torch.Tensor | None = None):
    """One decoder layer over a sequence. Returns (h, cache entries, aux):
    the post-rope K/V of this layer, ``{"k", "v"}`` (B, S, KH, hd), or MLA's
    latent ``{"c_kv", "k_rope"}``; an SSM block's ``{"h", "conv_x",
    "conv_B", "conv_C"}`` (a hybrid layer's beside its K/V); an
    encoder-decoder layer's cross-attention keys and values over
    ``enc_out``, ``{"xk", "xv"}`` (B, F, KH, hd), beside its K/V; the MoE
    load-balance loss (fp32 scalar, 0 without experts)."""
    x = p.ln1(h)
    if kind == "ssm":
        y, c = _ssm_with_cache(cfg, p.mamba, x, knobs)
        return h + y, c, _no_aux(h)
    if kind in ("hybrid_full", "hybrid_swa"):
        # attention (windowed on hybrid_swa, the meta tokens its sinks) beside
        # the SSM block; no skip connection rides the out-projection here
        a, k, v = attention_block(cfg, p.attn, x, positions, knobs,
                                  window=_window_for(cfg, kind), n_sink=cfg.meta_tokens)
        m, c = _ssm_with_cache(cfg, p.mamba, x, knobs)
        h, aux = _ffn(cfg, p, h + _hybrid_mix(p, a, m), knobs)
        return h, {"k": k, "v": v, **c}, aux
    if cfg.mla is not None:
        # the JAX package adds MLA's output after its out-projection
        y, c = _mla_with_cache(cfg, p.attn, x, positions, knobs)
        h, aux = _ffn(cfg, p, h + y, knobs)
        return h, c, aux
    # the skip connections ride the out- and down-projections (fused into
    # the paired kernel's epilogue under gemm="pallas_paired")
    h, k, v = attention_block(cfg, p.attn, x, positions, knobs,
                              window=_window_for(cfg, kind), residual=h)
    c = {"k": k, "v": v}
    if kind == "encdec":
        h, c["xk"], c["xv"] = _cross_attention(p.xattn, p.lnx(h), enc_out, knobs, residual=h)
    h, aux = _ffn(cfg, p, h, knobs)
    return h, c, aux


def _extra(cfg: ModelConfig, extras: dict | None, name: str) -> torch.Tensor:
    if not extras or extras.get(name) is None:
        raise ValueError(f"{cfg.name} ({cfg.family}) needs extras[{name!r}] beside the tokens "
                         "(launch.inputs.make_batch makes seeded stubs)")
    return extras[name]


def _prepare_inputs(cfg: ModelConfig, model: LM, tokens: torch.Tensor, extras: dict | None,
                    knobs: PerfKnobs, *, train: bool = False):
    """The embedded tokens (B, meta_tokens + S, d) in the compute dtype, a
    hybrid model's ``meta`` rows first, a vision-language model's first
    ``vision_prefix`` rows replaced by ``extras["patches"] @ vision_proj``,
    an encoder-decoder model's with the sinusoid added; their positions
    (B, meta_tokens + S); and the encoder's output over ``extras["frames"]``
    (None without an encoder)."""
    cdt = compute_dtype(cfg)
    h = embed_tokens(cfg, model, tokens, cdt)
    B = tokens.shape[0]
    if cfg.vision_prefix:
        proj = model.derived(("vision_proj", cdt), lambda: model.vision_proj.to(cdt))
        pe = torch.matmul(_extra(cfg, extras, "patches").to(cdt), proj)
        h = torch.cat([pe, h[:, cfg.vision_prefix:]], dim=1)
    if cfg.meta_tokens:
        meta = model.meta.to(cdt)[None].expand(B, *model.meta.shape)
        h = torch.cat([meta, h], dim=1)
    S = h.shape[1]
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    enc_out = None
    if cfg.encoder is not None:
        h = h + _sinusoid(positions, cfg.d_model).to(cdt)
        enc_out = encoder_fwd(cfg, model.encoder, _extra(cfg, extras, "frames").to(cdt), knobs,
                              train=train)
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
            knobs: PerfKnobs = DEFAULT_KNOBS, extras: dict | None = None):
    """Forward over the prompt; returns (last-position logits (B, 1, Vp),
    cache of :func:`init_cache`'s names: attention entries ``meta_tokens +
    S`` positions long, SSM entries the state after the prompt, the
    cross-attention's over all frames).  The encoder runs once, where the
    JAX package's ``prefill`` runs it a second time for the cross keys and
    values (the same ones)."""
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


def _train_layer(cfg: ModelConfig, kind: str, p: DecoderLayer, knobs: PerfKnobs,
                 h: torch.Tensor, positions: torch.Tensor, enc_out: torch.Tensor | None):
    """One decoder layer for the loss: ``(h, aux)``, no cache."""
    h, _, aux = layer_fwd(cfg, kind, p, h, positions, knobs, enc_out=enc_out)
    return h, aux


def _hidden_for_loss(cfg: ModelConfig, model: LM, tokens: torch.Tensor, knobs: PerfKnobs,
                     extras: dict | None = None):
    """The forward up to the final-normed hidden states (B, S, d), skipping
    the logits, and the summed router aux loss; each layer (the encoder's
    too) under :func:`_remat`."""
    h, positions, enc_out = _prepare_inputs(cfg, model, tokens, extras, knobs, train=True)
    aux_total = _no_aux(h)
    for i, layer in enumerate(model.layers):
        step = functools.partial(_train_layer, cfg, cfg.layer_kind(i), layer, knobs)
        h, aux = _remat(step, knobs)(h, positions, enc_out)
        aux_total = aux_total + aux
    return model.final_norm(h[:, cfg.meta_tokens:]), aux_total


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


def chunked_xent(cfg: ModelConfig, model: LM, h: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor, chunk: int) -> torch.Tensor:
    """Sequence-chunked softmax cross-entropy, summed over the masked
    positions: ``h`` (B, S, d) final-normed hiddens, ``labels`` (B, S) (no
    negatives), ``mask`` (B, S) fp32.

    S is padded to a multiple of ``chunk`` (0 → one chunk of S); each
    chunk's (B, chunk, Vp) fp32 logits are built, reduced and freed, and the
    chunk body is checkpointed, so the backward rebuilds them instead of
    keeping them: the (B, S, Vp) logits never exist.  The head is
    ``torch.matmul``, as the JAX package's is an XLA einsum.
    """
    B, S, _ = h.shape
    w = model.embed if cfg.tie_embeddings else model.lm_head
    chunk = min(chunk, S) if chunk else S
    n = -(-S // chunk)
    pad = n * chunk - S
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels, mask = F.pad(labels, (0, pad)), F.pad(mask, (0, pad))
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(n):
        cols = slice(c * chunk, (c + 1) * chunk)
        total = total + checkpoint(_xent_chunk, cfg, w, h[:, cols], labels[:, cols],
                                   mask[:, cols], use_reentrant=False,
                                   preserve_rng_state=False)
    return total


def lm_loss(cfg: ModelConfig, model: LM, batch: dict, *, knobs: PerfKnobs = DEFAULT_KNOBS):
    """Masked next-token cross-entropy plus the router's aux loss.

    ``batch`` holds ``"tokens"`` and ``"labels"`` (B, S), and the
    :data:`EXTRAS` the model needs; a negative label masks its position, as
    does a vision-language model's patch positions (a sequence no longer
    than ``vision_prefix`` raises).  Returns ``(loss,
    {"xent", "aux"})``, fp32 scalars, as the JAX package's ``lm_loss``.
    Under ``knobs.gemm="pallas"`` or ``"pallas_paired"`` every layer GEMM's
    forward is a K1 launch and its backward ``torch.matmul``
    (``kernels.ops``)."""
    labels = batch["labels"]
    if cfg.vision_prefix and labels.shape[1] <= cfg.vision_prefix:
        # the JAX package's lm_loss fails on a shorter one and returns 0 on
        # one of vision_prefix tokens
        raise ValueError(f"{cfg.name}: a sequence of {labels.shape[1]} tokens leaves no "
                         f"labelled position after the {cfg.vision_prefix} patch positions")
    mask = (labels >= 0).float()
    if cfg.vision_prefix:  # patch positions carry no token labels
        mask = mask * (torch.arange(labels.shape[1], device=labels.device) >= cfg.vision_prefix)
    denom = mask.sum().clamp_min(1.0)
    extras = {k: batch[k] for k in EXTRAS if k in batch}
    h, aux = _hidden_for_loss(cfg, model, batch["tokens"], knobs, extras)
    total = chunked_xent(cfg, model, h, labels.clamp_min(0), mask, knobs.xent_chunk)
    xent = total / denom
    return xent + aux, {"xent": xent, "aux": aux}


# ---------------------------------------------------------------------------
# caches + decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int, *, device=None) -> dict:
    """Empty decode cache in the compute dtype: ``{"k", "v"}`` zeros (L, B,
    S, KH, hd), or for MLA the latent ``{"c_kv": (L, B, S, R), "k_rope":
    (L, B, S, rope)}``, with ``S = max_seq + meta_tokens`` (``max_seq``
    counts token positions, the meta tokens extend it); an SSM block's state
    ``"h"`` (L, B, H, P, N) in fp32 and conv tails ``"conv_x"`` (L, B, W − 1,
    d_in), ``"conv_B"``/``"conv_C"`` (L, B, W − 1, G·N).  A hybrid model has
    both; its sliding-window layers keep the full-length K/V, as the JAX
    package's do (the decode writes at absolute positions).  An
    encoder-decoder model's cross-attention keys and values ``"xk"``/``"xv"``
    (L, B, F, KH, hd) cover all F frames."""
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
    cache = {name: torch.zeros(shape, dtype=cdt, device=dev) for name, shape in shapes.items()}
    if cfg.ssm is not None:
        s = cfg.ssm
        d_in, GN, W = s.expand * cfg.d_model, s.n_groups * s.d_state, s.conv_width
        cache["h"] = torch.zeros((*L, d_in // s.head_dim, s.head_dim, s.d_state),
                                 dtype=torch.float32, device=dev)
        for name, width in (("conv_x", d_in), ("conv_B", GN), ("conv_C", GN)):
            cache[name] = torch.zeros((*L, W - 1, width), dtype=cdt, device=dev)
    return cache


def layer_decode(cfg: ModelConfig, kind: str, p: DecoderLayer, c: dict,
                 h: torch.Tensor, pos: torch.Tensor, knobs: PerfKnobs = DEFAULT_KNOBS):
    """One decoder layer for one token per slot; ``c`` (this layer's cache
    entries, (B, …)) is written in place: attention entries at ``pos`` (the
    absolute position, meta tokens included), the SSM state whole."""
    x = p.ln1(h)
    if kind == "ssm":
        y, c = ssm_decode_block(cfg, p.mamba, x, c, knobs)
        return h + y, c
    if kind in ("hybrid_full", "hybrid_swa"):
        a, _ = attention_decode_block(cfg, p.attn, x, c, pos, knobs,
                                      window=_window_for(cfg, kind), n_sink=cfg.meta_tokens)
        m, _ = ssm_decode_block(cfg, p.mamba, x, c, knobs)
        return _ffn(cfg, p, h + _hybrid_mix(p, a, m), knobs)[0], c
    if cfg.mla is not None:
        y, c = mla_decode_block(cfg, p.attn, x, c, pos, knobs)
        return _ffn(cfg, p, h + y, knobs)[0], c
    h, c = attention_decode_block(cfg, p.attn, x, c, pos, knobs,
                                  window=_window_for(cfg, kind), residual=h)
    if kind == "encdec":
        # every frame attended (plain, as in the JAX package); wq and wo
        # through dense, the skip connection fused into wo
        q = _xattn_q(p.xattn, p.lnx(h), knobs)
        frames = torch.full_like(pos, c["xk"].shape[1] - 1)
        h = attn_out_proj(p.xattn, decode_attention(q, c["xk"], c["xv"], frames), knobs,
                          residual=h)
    return _ffn(cfg, p, h, knobs)[0], c


def decode_step(cfg: ModelConfig, model: LM, cache: dict, tokens: torch.Tensor,
                pos: torch.Tensor, *, knobs: PerfKnobs = DEFAULT_KNOBS):
    """One decode step: tokens (B, 1), pos (B,) in token coordinates →
    (logits (B, 1, Vp), cache); a hybrid model's layers see ``pos +
    meta_tokens``, an encoder-decoder model's embeddings the sinusoid at
    ``pos``.

    The cache is updated in place (and returned): the port's caches are
    mutable, which saves a copy of every layer's K/V per step.
    """
    cdt = compute_dtype(cfg)
    h = embed_tokens(cfg, model, tokens, cdt)
    pos_abs = pos + cfg.meta_tokens if cfg.meta_tokens else pos
    if cfg.encoder is not None:
        h = h + _sinusoid(pos_abs[:, None], cfg.d_model).to(cdt)
    for i, layer in enumerate(model.layers):
        c: dict[str, Any] = {name: t[i] for name, t in cache.items()}
        h, _ = layer_decode(cfg, cfg.layer_kind(i), layer, c, h, pos_abs, knobs)
    return lm_logits(cfg, model, h), cache
