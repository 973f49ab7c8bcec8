"""The decoder-only LM, dense, MoE, SSM or hybrid: init, forward, prefill and
decode, in PyTorch.

The port of the dense, MoE, SSM and hybrid subset of ``repro.models.lm``:

* :func:`lm_forward` — the forward over a prompt (logits, and optionally
  the cache entries it produced);
* :func:`prefill` — last-position logits and a filled cache;
* :func:`init_cache` — an empty decode cache: ``{"k", "v"}`` of shape
  ``(layers, batch, seq, kv_heads, head_dim)`` for GQA, the latent
  ``{"c_kv", "k_rope"}`` ``(layers, batch, seq, kv_lora_rank | qk_rope_dim)``
  for MLA, and for an SSM block its state ``"h"`` ``(layers, batch, heads,
  head_dim, d_state)`` (fp32) and conv tails ``"conv_x"``/``"conv_B"``/
  ``"conv_C"`` ``(layers, batch, conv_width − 1, channels)``;
* :func:`decode_step` — one new token per slot against the cache;
* :func:`lm_loss` — the training forward: masked next-token cross-entropy
  (:func:`chunked_xent`, the head a chunk of the sequence at a time) plus
  the MoE router's load-balance loss, each decoder layer checkpointed under
  ``knobs.remat``.

The model is an :class:`LM` module: the embedding (tied as the head, or an
``lm_head`` of its own), learned ``meta`` token rows (hybrid) that precede
every prompt, the final norm and one
:class:`~repro_torch.models.layers.DecoderLayer` per layer, with GQA or MLA
attention, a Mamba-2 block or both side by side, and a gated MLP or routed
(and shared) experts.  The JAX package stacks a segment's layers for ``lax.scan``; the port
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
    attention_block,
    attention_decode_block,
    mla_block,
    mla_decode_block,
    mlp_block,
    moe_block,
    ssm_decode_block,
    ssm_forward,
)

GEMMS = ("xla", "pallas", "pallas_paired")
ATTNS = ("xla", "pallas_fused")
REMATS = ("full", "dots", "none")
#: the SSM block's cache entries: one state a slot, no sequence axis
SSM_ENTRIES = ("h", "conv_x", "conv_B", "conv_C")


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
    attention and the out-projection as one decode-attention launch.
    ``q_chunk``/``k_chunk`` are prefill attention's blocks.  Training
    (:func:`lm_loss`) reads ``remat`` (``"full"``: recompute each decoder
    layer in the backward; ``"dots"``: keep the GEMMs' outputs, recompute
    the rest; ``"none"``) and ``xent_chunk`` (sequence positions a chunk of
    the cross-entropy; 0 → one chunk).
    """

    q_chunk: int = 1024
    k_chunk: int = 1024
    remat: str = "full"
    xent_chunk: int = 512
    gemm: str = "xla"
    attn: str = "xla"
    pair_rounding: float = 0.0
    pair_block_n: int = 0

    def __post_init__(self):
        if self.gemm not in GEMMS:
            raise ValueError(f"unknown knobs.gemm {self.gemm!r} (expected one of {GEMMS})")
        if self.attn not in ATTNS:
            raise ValueError(f"unknown knobs.attn {self.attn!r} (expected one of {ATTNS})")
        if self.remat not in REMATS:
            raise ValueError(f"unknown knobs.remat {self.remat!r} (expected one of {REMATS})")


DEFAULT_KNOBS = PerfKnobs()


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def padded_vocab(cfg: ModelConfig) -> int:
    """Vocab rounded up to 128, as in the JAX package."""
    return ((cfg.vocab + 127) // 128) * 128


class LM(Block):
    """Embedding ``embed`` (Vp, d), tied as the head unless an ``lm_head``
    (d, Vp) is given, the ``meta`` tokens (M, d) of a hybrid model, the
    final norm, the decoder layers, and the config's segments."""

    REQUIRED = ("embed",)

    def __init__(self, *, final_norm: Norm, layers: list[DecoderLayer],
                 segments: tuple[tuple[str, int], ...], pairing: dict | None = None,
                 **weights):
        super().__init__(pairing=pairing, **weights)
        if sum(n for _, n in segments) != len(layers):
            raise ValueError(f"segments {segments} do not cover {len(layers)} layers")
        self.final_norm = final_norm
        self.layers = nn.ModuleList(layers)
        self.segments = tuple(segments)

    def copy(self, *, frozen: bool, layer_pairing: list[dict] | None = None) -> LM:
        """A model sharing these weights (nothing is copied), with empty
        caches; ``layer_pairing[l]`` replaces layer ``l``'s pairing dicts,
        keyed by sub-path (``{"attn": {...}, "mamba": {...}, "mlp" or "moe":
        {...}, "moe.shared": {...}}``)."""
        per_layer = layer_pairing or [None] * len(self.layers)
        new = LM(final_norm=self.final_norm.copy(frozen=frozen),
                 layers=[layer.copy(frozen=frozen, pairing=lp)
                         for layer, lp in zip(self.layers, per_layer, strict=True)],
                 segments=self.segments, **dict(self.named_parameters(recurse=False)))
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
    (qkv biases zero, norm scales one; an expert weight's fan-in is its
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
            return DecoderLayer(Norm(scale=ones(d)), mamba=mamba())
        if kind in ("hybrid_full", "hybrid_swa"):
            ffn_of = {"ln2": Norm(scale=ones(d)), "mlp": mlp(f)} if f else {}
            return DecoderLayer(Norm(scale=ones(d)), attention(), mamba=mamba(),
                                ln_attn_out=Norm(scale=ones(d)), ln_ssm_out=Norm(scale=ones(d)),
                                **ffn_of)
        return DecoderLayer(Norm(scale=ones(d)), attention(), Norm(scale=ones(d)), **ffn(kind))

    embed = tn((padded_vocab(cfg), d), d)
    layers = [layer(cfg.layer_kind(i)) for i in range(cfg.n_layers)]
    head = None if cfg.tie_embeddings else tn((d, padded_vocab(cfg)), d)
    meta = (torch.randn((cfg.meta_tokens, d), generator=gen, device=dev) * 0.02
            if cfg.meta_tokens else None)
    return LM(embed=embed, lm_head=head, meta=meta, final_norm=Norm(scale=ones(d)),
              layers=layers, segments=cfg.segments())


def lm_params_from_numpy(values: dict, cfg: ModelConfig, *, device=None) -> LM:
    """The model from the JAX package's value tree (``param.unzip(init_lm(…))[0]``
    with every leaf mapped to a numpy array).

    Each segment's stacked ``(L, …)`` leaves split into per-layer weights;
    ``"<name>_pairing"`` siblings (``core.transform.pair_lm_params``) carry
    over as each layer's pairing metadata (lane lists as int64), an MoE
    layer's ``(E, …)`` per-expert metadata and its nested ``shared`` block
    included; so do an SSM block (``mamba``), a hybrid layer's output norms
    and the ``meta`` tokens.
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
               "ln_attn_out": Norm, "ln_ssm_out": Norm, "ln2": Norm, "mlp": MLP, "moe": MoE}
    layers = []
    for (_, count), seg in zip(cfg.segments(), values["segments"], strict=True):
        for l in range(count):
            layers.append(DecoderLayer(**{name: block(cls, seg[name], l)
                                          for name, cls in classes.items() if name in seg}))
    head, meta = values.get("lm_head"), values.get("meta")
    return LM(embed=tensor(values["embed"]), lm_head=None if head is None else tensor(head),
              meta=None if meta is None else tensor(meta),
              final_norm=Norm(scale=tensor(values["final_norm"]["scale"])), layers=layers,
              segments=cfg.segments())


def _block_values(block: nn.Module) -> dict:
    """A block's weights by name, a child block's nested under its name."""
    return {**dict(block.named_parameters(recurse=False)),
            **{name: _block_values(child) for name, child in block.named_children()}}


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack([t.detach() for t in trees])


def lm_value_tree(model: LM) -> dict:
    """The model's weights in the JAX package's value-tree layout (what
    :func:`lm_params_from_numpy` reads, without pairing metadata): each
    segment's per-layer weights stacked along a leading layers axis, as new
    tensors on the weights' device."""
    segments, start = [], 0
    for _, count in model.segments:
        layers = model.layers[start:start + count]
        segments.append(_stack([{name: _block_values(b) for name, b in layer.named_children()}
                                for layer in layers]))
        start += count
    tree = {"embed": model.embed.detach().clone(),
            "final_norm": {"scale": model.final_norm.scale.detach().clone()},
            "segments": segments}
    for name in ("lm_head", "meta"):
        if getattr(model, name, None) is not None:
            tree[name] = getattr(model, name).detach().clone()
    return tree


def load_lm_values(model: LM, tree: dict) -> None:
    """Copy a value tree of :func:`lm_value_tree`'s layout into the model's
    weights, in place."""
    def load(block: nn.Module, values: dict, l: int | None):
        for name, t in block.named_parameters(recurse=False):
            t.copy_(values[name] if l is None else values[name][l])
        for name, child in block.named_children():
            load(child, values[name], l)

    with torch.no_grad():
        start = 0
        for (_, count), seg in zip(model.segments, tree["segments"], strict=True):
            for l in range(count):
                for name, block in model.layers[start + l].named_children():
                    load(block, seg[name], l)
            start += count
        model.final_norm.scale.copy_(tree["final_norm"]["scale"])
        for name in ("embed", "lm_head", "meta"):
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


def layer_fwd(cfg: ModelConfig, kind: str, p: DecoderLayer, h: torch.Tensor,
              positions: torch.Tensor, knobs: PerfKnobs = DEFAULT_KNOBS):
    """One decoder layer over a sequence. Returns (h, cache entries, aux):
    the post-rope K/V of this layer, ``{"k", "v"}`` (B, S, KH, hd), or MLA's
    latent ``{"c_kv", "k_rope"}``; an SSM block's ``{"h", "conv_x",
    "conv_B", "conv_C"}`` (a hybrid layer's beside its K/V); the MoE
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
    h, aux = _ffn(cfg, p, h, knobs)
    return h, {"k": k, "v": v}, aux


def _prepare_inputs(cfg: ModelConfig, model: LM, tokens: torch.Tensor):
    """The embedded tokens (B, meta_tokens + S, d) in the compute dtype, a
    hybrid model's ``meta`` rows first, and their positions (B, meta_tokens + S)."""
    cdt = compute_dtype(cfg)
    h = embed_tokens(cfg, model, tokens, cdt)
    B = tokens.shape[0]
    if cfg.meta_tokens:
        meta = model.meta.to(cdt)[None].expand(B, *model.meta.shape)
        h = torch.cat([meta, h], dim=1)
    S = h.shape[1]
    return h, torch.arange(S, device=tokens.device).expand(B, S)


def lm_forward(cfg: ModelConfig, model: LM, tokens: torch.Tensor, *,
               knobs: PerfKnobs = DEFAULT_KNOBS, collect_cache: bool = False):
    """tokens (B, S) → (logits (B, S, Vp) fp32, cache or None); the cache
    holds each layer's entries of :func:`layer_fwd` stacked, (L, B, …).

    A hybrid model's ``meta`` tokens precede the prompt: the layers see
    ``meta_tokens + S`` positions (their K/V cache entries too), and the
    logits are the prompt's S."""
    h, positions = _prepare_inputs(cfg, model, tokens)
    entries = []
    for i, layer in enumerate(model.layers):
        h, c, _ = layer_fwd(cfg, cfg.layer_kind(i), layer, h, positions, knobs)
        if collect_cache:
            entries.append(c)
    cache = ({name: torch.stack([c[name] for c in entries]) for name in entries[0]}
             if collect_cache else None)
    return lm_logits(cfg, model, h[:, cfg.meta_tokens:]), cache


def prefill(cfg: ModelConfig, model: LM, tokens: torch.Tensor, *,
            knobs: PerfKnobs = DEFAULT_KNOBS):
    """Forward over the prompt; returns (last-position logits (B, 1, Vp),
    cache of :func:`init_cache`'s names: attention entries ``meta_tokens +
    S`` positions long, SSM entries the state after the prompt)."""
    logits, cache = lm_forward(cfg, model, tokens, knobs=knobs, collect_cache=True)
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
                 h: torch.Tensor, positions: torch.Tensor):
    """One decoder layer for the loss: ``(h, aux)``, no cache."""
    h, _, aux = layer_fwd(cfg, kind, p, h, positions, knobs)
    return h, aux


def _hidden_for_loss(cfg: ModelConfig, model: LM, tokens: torch.Tensor, knobs: PerfKnobs):
    """The forward up to the final-normed hidden states (B, S, d), skipping
    the logits, and the summed router aux loss; each layer under
    :func:`_remat`."""
    h, positions = _prepare_inputs(cfg, model, tokens)
    aux_total = _no_aux(h)
    for i, layer in enumerate(model.layers):
        step = functools.partial(_train_layer, cfg, cfg.layer_kind(i), layer, knobs)
        h, aux = _remat(step, knobs)(h, positions)
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

    ``batch`` holds ``"tokens"`` and ``"labels"`` (B, S); a negative label
    masks its position.  Returns ``(loss, {"xent", "aux"})``, fp32 scalars,
    as the JAX package's ``lm_loss``.  Under ``knobs.gemm="pallas"`` or
    ``"pallas_paired"`` every layer GEMM's forward is a K1 launch and its
    backward ``torch.matmul`` (``kernels.ops``)."""
    labels = batch["labels"]
    mask = (labels >= 0).float()
    denom = mask.sum().clamp_min(1.0)
    h, aux = _hidden_for_loss(cfg, model, batch["tokens"], knobs)
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
    package's do (the decode writes at absolute positions)."""
    L, dev = (cfg.n_layers, batch_size), resolve_device(device)
    cdt, S = compute_dtype(cfg), max_seq + cfg.meta_tokens
    shapes = {}
    if cfg.family != "ssm":
        if cfg.mla is not None:
            shapes = {"c_kv": (*L, S, cfg.mla.kv_lora_rank), "k_rope": (*L, S, cfg.mla.qk_rope_dim)}
        else:
            shapes = {name: (*L, S, cfg.n_kv_heads, cfg.head_dim) for name in ("k", "v")}
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
    return _ffn(cfg, p, h, knobs)[0], c


def decode_step(cfg: ModelConfig, model: LM, cache: dict, tokens: torch.Tensor,
                pos: torch.Tensor, *, knobs: PerfKnobs = DEFAULT_KNOBS):
    """One decode step: tokens (B, 1), pos (B,) in token coordinates →
    (logits (B, 1, Vp), cache); a hybrid model's layers see ``pos +
    meta_tokens``.

    The cache is updated in place (and returned): the port's caches are
    mutable, which saves a copy of every layer's K/V per step.
    """
    h = embed_tokens(cfg, model, tokens, compute_dtype(cfg))
    pos_abs = pos + cfg.meta_tokens if cfg.meta_tokens else pos
    for i, layer in enumerate(model.layers):
        c: dict[str, Any] = {name: t[i] for name, t in cache.items()}
        h, _ = layer_decode(cfg, cfg.layer_kind(i), layer, c, h, pos_abs, knobs)
    return lm_logits(cfg, model, h), cache
