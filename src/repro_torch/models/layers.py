"""Layers of the decoder and encoder (GQA or multi-head latent attention,
cross-attention, a gated MLP or routed experts, Mamba-2 SSD blocks,
RMSNorm or LayerNorm), in PyTorch.

The port of ``repro.models.layers``, its expert-parallel ``_moe_shard_map``
included.  Conventions, as in the JAX package:

* activations ``(batch, seq, d_model)`` in the compute dtype (the config's);
* softmax and normalisation statistics in fp32;
* attention weights keep heads explicit: ``wq`` ``(d, H, hd)``, ``wk``/``wv``
  ``(d, KH, hd)``, ``wo`` ``(H, hd, d)``;
* prefill attention goes through :func:`flash_attention` (blocked online
  softmax, plain PyTorch: the JAX package's is XLA code, not a kernel);
  non-causal attention (whisper's encoder and cross-attention) through
  :func:`full_attention`, on the flash-attention kernel (K3) with
  ``knobs.attn == "pallas_fused"``; a single decode row through
  :func:`decode_attention` or, with
  ``knobs.attn == "pallas_fused"``, the decode-attention kernel that applies
  the paired out-projection in its flush (``kernels.ops.attn_decode``);
* MLA (DeepSeek-V2) caches a compressed latent ``(c_kv, k_rope)`` and decodes
  in the latent space (:func:`mla_decode_block`, einsums as in the JAX
  package, no kernel); its down- and out-projections are paired GEMMs;
* MoE layers route each token to its top-k experts; every expert's GEMM of
  one projection runs as one paired launch over the expert grid
  (``kernels.ops.expert_dense``, or ``fused_paired_expert_dense`` under
  autograd); shared experts run beside them as a gated MLP;
* a Mamba-2 block (:class:`Mamba`) projects through :func:`dense` (six
  paired GEMMs), runs a depthwise causal conv and the chunked SSD scan
  (:func:`ssd_scan`) over a prompt, or one step of the state recurrence
  (:func:`ssm_decode_block`) per decode token: plain PyTorch, as the JAX
  package's are XLA code, not kernels.

On a mesh (``tp``, a ``parallel.tp.TensorParallel``: one rank's view of a
layer, every family) each rank holds its shards and closes every split
with a collective (``parallel.collectives``): the row-parallel out-, down-
and SSM output projections (:func:`row_parallel_dense`) store fp32 partial
sums, the skip connection on the first model rank only, and all-reduce them
before the one cast; attention reads the KV heads of the rank's query heads
(:func:`local_kv`), or, against a sequence-sharded cache (GQA's K/V, MLA's
latent), merges the ranks' partial softmaxes
(:func:`merge_partial_softmax`); the experts run on the ranks that hold
them (:func:`_moe_shard_map` on a prompt, the dense branch on decode rows),
their gated sums all-reduced with the shared experts'; an SSM block scans
the rank's heads, its gated norm's statistic all-reduced.  A training rank
(``tp.train``) enters each block with its positions gathered along the
sequence and closes it with a reduce-scatter (:func:`seq_enter`,
:func:`close_partial`), or keeps its positions of a block whose weights are
whole (:func:`close_whole`: MLA's or an SSM block's too); its shared
experts' partial sums join the routed ones before the one close, an SSM
block's gated-norm statistic has its gradient all-reduced, and its MoE aux
loss is the global batch's.

Weights live in :class:`Block` modules (fp32 masters, as the JAX package
keeps them) with each weight's pairing metadata beside it; every GEMM goes
through :func:`dense`, the one dispatch point between ``torch.matmul`` and
the paired kernel.  A *frozen* block (the serving engine's copy, whose
weights never change) keeps what it derives from its weights, the
compute-dtype casts and the paired kernel's segments, after the first call;
an unfrozen block recomputes them on every call, as the JAX package does.
Knobs arrive as an explicit ``PerfKnobs`` argument.
"""
from __future__ import annotations

import math
from collections.abc import Callable
from typing import Any

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import decode_mask
from repro_torch.parallel.collectives import (
    all_gather,
    all_reduce,
    gather_blocks,
    grad_all_reduce,
    reduce_scatter,
)

# ---------------------------------------------------------------------------
# weight containers
# ---------------------------------------------------------------------------


def _below(paths: dict, name: str) -> dict:
    """The entries of ``paths`` (keyed by dotted sub-paths) under child
    ``name``, keyed relative to it."""
    return {k[len(name) + 1:]: v for k, v in paths.items() if k.startswith(name + ".")}


class Block(nn.Module):
    """Named weights (parameters), nested child blocks, their pairing
    metadata, and a cache of tensors derived from them.

    ``pairing[name]`` is one layer's metadata of weight ``name``
    (``core.transform.pair_lm_params``): lane lists ``I``/``J``/``resid``
    (int64) and masks ``pair_mask``/``resid_mask`` (fp32).  A child block
    (an MoE layer's ``shared`` experts) keeps its own.
    """

    REQUIRED: tuple[str, ...] = ()

    def __init__(self, *, pairing: dict | None = None,
                 **weights: torch.Tensor | Block | None):
        super().__init__()
        missing = [n for n in self.REQUIRED if weights.get(n) is None]
        if missing:
            raise ValueError(f"{type(self).__name__} needs weights {missing}")
        for name, t in weights.items():
            if isinstance(t, Block):
                self.add_module(name, t)
            elif t is not None:
                if not isinstance(t, nn.Parameter):
                    t = nn.Parameter(t, requires_grad=False)
                self.register_parameter(name, t)
        self.pairing: dict[str, dict[str, torch.Tensor]] = dict(pairing or {})
        #: FSDP: the metadata of a weight's data-gathered model shard (its
        #: data slabs' lane lists, concatenated and rebased), where it
        #: differs from ``pairing`` (the rank's own block's)
        self.gathered: dict[str, dict[str, torch.Tensor]] = {}
        self.frozen = False
        self._derived: dict[Any, Any] = {}

    def copy(self, *, frozen: bool, pairing: dict | None = None,
             children: dict | None = None) -> Block:
        """A block sharing these weights (not copied), with ``pairing`` (or
        this block's, and its ``gathered``) and an empty cache; its child
        blocks are copied the same way, ``children`` mapping a dotted
        sub-path below this block (``"shared"``) to that block's new pairing
        dict."""
        children = children or {}
        kids = {n: c.copy(frozen=frozen, pairing=children.get(n), children=_below(children, n))
                for n, c in self.named_children()}
        new = type(self)(pairing=self.pairing if pairing is None else pairing,
                         **dict(self.named_parameters(recurse=False)), **kids)
        if pairing is None:
            new.gathered = self.gathered
        new.frozen = frozen
        return new

    def rebound(self, tensors: dict) -> Block:
        """A block of this one's kind whose weights are ``tensors`` (dotted
        names below it: ``"w_gate"``, ``"shared.w_up"``) where given and its
        own elsewhere, each with its gathered metadata (``gathered``, else
        ``pairing``): an FSDP rank's layer as the forward reads it, its
        gathered tensors tracked by autograd back to the rank's blocks."""
        if not tensors:
            return self
        kids = {n: c.rebound(_below(tensors, n)) for n, c in self.named_children()}
        new = type(self)(pairing={**self.pairing, **self.gathered},
                         **dict(self.named_parameters(recurse=False)), **kids)
        for name, t in tensors.items():
            if "." not in name:
                new._parameters[name] = t
        new.frozen = self.frozen
        return new

    def derived(self, key, fn: Callable[[], Any]):
        """``fn()``, kept under ``key`` after the first call when frozen."""
        if not self.frozen:
            return fn()
        if key not in self._derived:
            self._derived[key] = fn()
        return self._derived[key]

    def matrix(self, name: str, dtype: torch.dtype) -> torch.Tensor:
        """Weight ``name`` as its (K, N) GEMM view, in ``dtype``: ``wo``
        contracts over all but its last axis, every other weight over its
        first."""
        w = getattr(self, name)
        w = w.reshape(-1, w.shape[-1]) if name == "wo" else w.reshape(w.shape[0], -1)
        return w.to(dtype)


class Norm(Block):
    """RMSNorm scale ``(d,)``; with a ``bias`` ``(d,)``, LayerNorm."""

    REQUIRED = ("scale",)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_norm(x, self.scale, self._parameters.get("bias"))


class Attention(Block):
    """GQA attention: ``wq`` (d, H, hd), ``wk``/``wv`` (d, KH, hd), ``wo``
    (H, hd, d); optional biases ``bq`` (H, hd), ``bk``/``bv`` (KH, hd) and
    qk-norm scales ``q_norm``/``k_norm`` (hd,)."""

    REQUIRED = ("wq", "wk", "wv", "wo")


class MLA(Block):
    """Multi-head latent attention: ``wq`` (d, H, nope + rope), the latent
    down-projection ``w_dkv`` (d, R) with its norm ``kv_norm`` (R,), the
    shared rope key ``w_kr`` (d, rope), the up-projections ``w_uk`` (R, H,
    nope) and ``w_uv`` (R, H, v), and ``wo`` (H, v, d)."""

    REQUIRED = ("wq", "w_dkv", "w_kr", "w_uk", "w_uv", "wo", "kv_norm")


class MLP(Block):
    """Gated MLP: ``w_gate``/``w_up`` (d, f), ``w_down`` (f, d)."""

    REQUIRED = ("w_gate", "w_up", "w_down")


class MoE(Block):
    """Routed experts: ``router`` (d, E), ``w_gate``/``w_up`` (E, d, F),
    ``w_down`` (E, F, d); pairing metadata per expert (``(E, Pmax)``, or
    ``(E, Bc, Pmax)`` column-blocked within each expert).  Optional
    ``shared`` experts: one gated :class:`MLP` of width ``n_shared · F``
    that every token runs."""

    REQUIRED = ("router", "w_gate", "w_up", "w_down")


class Mamba(Block):
    """Mamba-2 (SSD) block: input projections ``w_z``/``w_x`` (d, d_in),
    ``w_B``/``w_C`` (d, G·N) and ``w_dt`` (d, H); depthwise causal convs
    ``conv_x`` (W, d_in), ``conv_B``/``conv_C`` (W, G·N); per-head ``A_log``,
    ``D`` and ``dt_bias`` (H,); the gated RMSNorm scale ``norm`` (d_in,); the
    output projection ``w_out`` (d_in, d)."""

    REQUIRED = ("w_z", "w_x", "w_B", "w_C", "w_dt", "conv_x", "conv_B", "conv_C", "A_log",
                "D", "dt_bias", "norm", "w_out")


class DecoderLayer(nn.Module):
    """Pre-norm decoder layer, by the blocks it holds (``x = ln1(h)``):

    * attention (``attn``: GQA :class:`Attention` or :class:`MLA`):
      ``h + attn(x)``;
    * SSM (``mamba``: :class:`Mamba`): ``h + mamba(x)``;
    * hybrid (both, with their output norms ``ln_attn_out`` and
      ``ln_ssm_out``): ``h + ½·(ln_attn_out(attn(x)) + ln_ssm_out(mamba(x)))``;

    then, in an encoder-decoder model's layer, cross-attention (``xattn``:
    an :class:`Attention` whose keys and values are the encoder output's)
    ``h + xattn(lnx(h))``; then, with a feed-forward block ``ffn`` (a gated
    ``mlp`` or a ``moe``), ``h + ffn(ln2(h))``; an SSM layer has none.  An
    encoder layer is one of attention and an MLP."""

    def __init__(self, ln1: Norm, attn: Attention | MLA | None = None, ln2: Norm | None = None,
                 mlp: MLP | None = None, *, moe: MoE | None = None, mamba: Mamba | None = None,
                 ln_attn_out: Norm | None = None, ln_ssm_out: Norm | None = None,
                 lnx: Norm | None = None, xattn: Attention | None = None):
        super().__init__()
        if (lnx is None) != (xattn is None) or (xattn is not None and attn is None):
            raise ValueError("cross-attention (xattn) takes lnx, and follows self-attention")
        if mlp is not None and moe is not None:
            raise ValueError("a decoder layer takes at most one of mlp and moe")
        if (ln2 is None) != (mlp is None and moe is None):
            raise ValueError("ln2 goes with a feed-forward block (mlp or moe), and only with one")
        if attn is None and mamba is None:
            raise ValueError("a decoder layer needs attn, mamba or both")
        if (attn is not None and mamba is not None) != (
                ln_attn_out is not None and ln_ssm_out is not None):
            raise ValueError("a hybrid layer (attn and mamba) takes ln_attn_out and ln_ssm_out, "
                             "and only it")
        self.ffn = "mlp" if mlp is not None else "moe" if moe is not None else None
        blocks = dict(ln1=ln1, attn=attn, mamba=mamba, ln_attn_out=ln_attn_out,
                      ln_ssm_out=ln_ssm_out, lnx=lnx, xattn=xattn, ln2=ln2, mlp=mlp, moe=moe)
        for name, block in blocks.items():
            if block is not None:
                setattr(self, name, block)

    def copy(self, *, frozen: bool, pairing: dict | None = None) -> DecoderLayer:
        """A layer sharing these weights; ``pairing`` maps a sub-block's
        dotted path (``"attn"``, ``"xattn"``, ``"mamba"``, ``"mlp"``,
        ``"moe"``, ``"moe.shared"``) to that block's new pairing dict."""
        pairing = pairing or {}
        return DecoderLayer(**{n: b.copy(frozen=frozen, pairing=pairing.get(n),
                                         children=_below(pairing, n))
                               for n, b in self.named_children()})

    def rebound(self, tensors: dict) -> DecoderLayer:
        """The layer with the weights ``tensors`` (dotted names: ``"attn.wq"``)
        in place of its own (:meth:`Block.rebound`)."""
        return DecoderLayer(**{n: b.rebound(_below(tensors, n))
                               for n, b in self.named_children()})


# ---------------------------------------------------------------------------
# norms / rope / activations
# ---------------------------------------------------------------------------


def apply_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor | None = None,
               eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis, or LayerNorm when there is a ``bias``;
    statistics in fp32."""
    xf = x.float()
    if bias is not None:
        mu = xf.mean(-1, keepdim=True)
        xc = xf - mu
        y = xc * torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
        return (y * scale.float() + bias.float()).to(x.dtype)
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rms_head_norm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMS norm over head_dim (qk_norm). x: (..., head_dim)."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, rotate-half convention, in fp32 then cast.

    x: (B, S, H, D) with D even; positions: (B, S).
    """
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    angles = positions[..., None].float() * freqs  # (B, S, D/2)
    cos, sin = torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def activation(name: str, x: torch.Tensor) -> torch.Tensor:
    # gelu is the tanh approximation, jax.nn.gelu's default
    return F.silu(x) if name == "silu" else F.gelu(x, approximate="tanh")


def dense(
    x: torch.Tensor,
    w: torch.Tensor | None,
    bias: torch.Tensor | None = None,
    act: str | None = None,
    *,
    pairing: dict | None = None,
    residual: torch.Tensor | None = None,
    knobs,
    segments: ops.PairedSegments | None = None,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """GEMM over the last axis with optional bias + activation + residual.

    The single dispatch point, as in the JAX package:

    * ``knobs.gemm == "pallas_paired"``: a call that carries ``pairing``
      metadata runs the paired kernel, bias, activation and ``residual``
      fused into its one store: differentiably from the live ``w``
      (``ops.fused_paired_dense``), or forward only on ``segments`` that the
      caller keeps (a frozen serving block; ``w`` may then be None);
    * ``knobs.gemm == "pallas"``: every call runs K1's dense form
      (``ops.fused_dense``, differentiable), bias and activation in its
      epilogue, ``residual`` added after it;
    * otherwise ``torch.matmul`` and plain adds (``pairing`` is ignored
      there: the live weights are the r=0-exact reference).

    ``residual`` is an output-shaped skip connection added after the
    activation.  ``out_dtype=torch.float32`` returns the result before its
    cast to x's dtype (a tensor-parallel rank's partial sum): K1's fp32
    epilogue stored uncast, under autograd too; under ``torch.matmul`` the
    product in x's dtype, then the epilogue in fp32.
    """
    if pairing is not None and knobs.gemm == "pallas_paired":
        if segments is None:
            return ops.fused_paired_dense(x, w, pairing, bias, activation=act or "none",
                                          residual=residual, pair_block_n=knobs.pair_block_n,
                                          out_dtype=out_dtype)
        return ops.paired_dense(x, segments, bias, activation=act or "none", residual=residual,
                                out_dtype=out_dtype)
    if knobs.gemm == "pallas":
        y = ops.fused_dense(x, w, bias, activation=act or "none", out_dtype=out_dtype)
        return y if residual is None else y + residual.to(y.dtype)
    y = torch.matmul(x, w)
    if out_dtype is not None:
        y = y.to(out_dtype)
    if bias is not None:
        y = y + bias
    if act:
        y = activation(act, y)
    if residual is not None:
        y = y + residual.to(y.dtype)
    return y


def _cast(p: Block, name: str, dtype: torch.dtype) -> torch.Tensor:
    """Weight ``name`` of ``p`` in ``dtype``, kept on a frozen block."""
    return p.derived(("matrix", name, dtype), lambda: getattr(p, name).to(dtype))


def _leaf_dense(p: Block, name: str, x: torch.Tensor, knobs, *, act=None, residual=None,
                out_dtype=None):
    """:func:`dense` of ``x`` against weight ``name`` of ``p`` (its (K, N)
    view in x's dtype).  A frozen block keeps its casts and paired segments
    (forward only); an unfrozen one computes them from the live weight on
    every call, through the differentiable GEMMs."""
    cdt = x.dtype
    meta = p.pairing.get(name)
    if meta is not None and knobs.gemm == "pallas_paired" and p.frozen:
        seg = p.derived(("paired", name, cdt), lambda: ops.lm_paired_segments(
            p.matrix(name, cdt), meta, knobs.pair_block_n))
        return dense(x, None, act=act, pairing=meta, residual=residual, knobs=knobs,
                     segments=seg, out_dtype=out_dtype)
    w = p.derived(("matrix", name, cdt), lambda: p.matrix(name, cdt))
    return dense(x, w, act=act, pairing=meta, residual=residual, knobs=knobs,
                 out_dtype=out_dtype)


#: weights the forward reads in fp32 (beside every 1-D one): an FSDP
#: gather moves them in their own dtype, every other one in the compute dtype
FP32_WEIGHTS = ("router",)


def gather_dtype(name: str, t: torch.Tensor, cdt: torch.dtype) -> torch.dtype:
    """The dtype an FSDP gather moves weight ``name`` in: its own for a norm's
    scale or bias and what else the forward reads in fp32, the compute dtype
    for a matrix (every use casts it first, so the gathered bits are the
    same)."""
    return t.dtype if t.ndim == 1 or name.rsplit(".", 1)[-1] in FP32_WEIGHTS else cdt


def gather_weights(tp, owner: nn.Module, leaves: tuple, cdt: torch.dtype) -> dict:
    """FSDP: the data-split weights ``leaves`` (``((dotted name, dim), …)``)
    of ``owner`` gathered over ``tp.fsdp_axes`` in one call
    (``parallel.collectives.gather_blocks``), by name."""
    if not leaves:
        return {}
    names = [name for name, _ in leaves]
    blocks = [owner.get_parameter(name) for name in names]
    got = gather_blocks(blocks, [dim for _, dim in leaves], tp.fsdp_group,
                        [gather_dtype(n, b, cdt) for n, b in zip(names, blocks, strict=True)])
    return dict(zip(names, got, strict=True))


def gather_layer(tp, p, cdt: torch.dtype):
    """The layer (or block) ``p`` as the forward reads it on an FSDP rank:
    its data-split weights (``tp.gathers``, the layer's view) gathered over
    the data axes, the rest its own (``p`` itself where nothing splits).
    Called inside the layer's checkpoint, so the backward gathers again
    instead of keeping the gathered weights."""
    if tp is None or not tp.gathers:
        return p
    return p.rebound(gather_weights(tp, p, tp.gathers, cdt))


def row_parallel_dense(p: Block, name: str, x: torch.Tensor, knobs, tp, *,
                       residual: torch.Tensor | None = None) -> torch.Tensor:
    """A row-parallel GEMM on a mesh (``wo``, ``w_down``: the rank holds a
    slab of the contraction rows and ``x``'s matching columns): the partial
    sum stored in fp32 (the paired kernel's ``out_dtype``), the skip
    connection fused on the first model rank only, one all-reduce over
    ``model`` in fp32, then the one cast to x's dtype.  A training rank
    closes it with :func:`close_partial` (the skip connection added after
    the sum: under sequence parallelism it is the rank's positions only)."""
    if tp.train:
        y = _leaf_dense(p, name, x, knobs, out_dtype=torch.float32)
        return close_partial(tp, y, x.dtype, residual)
    y = _leaf_dense(p, name, x, knobs, residual=residual if tp.r == 0 else None,
                    out_dtype=torch.float32)
    return all_reduce(y, tp.model_group).to(x.dtype)


# ---------------------------------------------------------------------------
# a training rank's way into and out of a tensor-parallel block
# ---------------------------------------------------------------------------
#
# A training rank (``tp.train``) holds, between sublayers, the residual
# stream's positions its layout gives it: its ``S/n`` chunk under sequence
# parallelism (``tp.seq_split``), all of them otherwise.  Each block runs
# on all positions: under sequence parallelism :func:`seq_enter`
# all-gathers them (the gradient reduce-scattered back), and
# :func:`close_partial` reduce-scatters the block's fp32 partial sums (the
# gradient all-gathered back); otherwise the partial sums are all-reduced,
# and so is their gradient, since every rank's gradient of a tensor it holds
# whole is its own part (``parallel.tp``).  A block whose weights are whole
# runs on every rank alike and keeps its positions (:func:`close_whole`).


def seq_enter(tp, x: torch.Tensor) -> torch.Tensor:
    """The (B, S, d) input of a block on a training rank: its positions
    all-gathered along the sequence under sequence parallelism, else ``x``
    (and ``x`` off a training mesh)."""
    if tp is None or not tp.train or not tp.seq_split:
        return x
    return all_gather(x, tp.model_group, dim=1)


def close_partial(tp, y: torch.Tensor, cdt: torch.dtype,
                  residual: torch.Tensor | None = None) -> torch.Tensor:
    """A training rank's fp32 partial sum ``y`` (B, S, d) over ``model``,
    closed: reduce-scattered to its positions under sequence parallelism,
    else all-reduced (the gradient all-reduced too); ``residual`` (the
    rank's positions of the skip connection) added in fp32; then the one
    cast to ``cdt``."""
    if tp.seq_split:
        y = reduce_scatter(y, tp.model_group, dim=1)
    else:
        y = grad_all_reduce(all_reduce(y, tp.model_group), tp.model_group)
    if residual is not None:
        y = y + residual.to(y.dtype)
    return y.to(cdt)


def close_whole(tp, y: torch.Tensor, cdt: torch.dtype,
                residual: torch.Tensor | None = None) -> torch.Tensor:
    """The fp32 output ``y`` (B, S, d) of a block whose weights are whole
    on a training rank under sequence parallelism: the rank's positions,
    ``residual`` added in fp32, then the one cast to ``cdt``."""
    n = y.shape[1] // tp.n
    y = y[:, tp.r * n:(tp.r + 1) * n]
    if residual is not None:
        y = y + residual.to(y.dtype)
    return y.to(cdt)


def _whole_seq_split(tp) -> bool:
    """A block whose weights are whole, on a sequence-parallel training rank."""
    return tp is not None and tp.train and tp.seq_split


def _own_positions(tp, y: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """A training rank's output ``y`` (B, S, d) of a block whose weights are
    whole, in ``cdt``: its positions under sequence parallelism
    (:func:`close_whole`), else all of them."""
    return close_whole(tp, y.float(), cdt) if tp.seq_split else y.to(cdt)


# ---------------------------------------------------------------------------
# flash attention (blocked online softmax, plain PyTorch)
# ---------------------------------------------------------------------------


def _block_mask(pos_q, pos_k, *, causal: bool, window: int, n_sink: int):
    """(Q, K) bool mask for one (q-block, k-block) pair of position vectors."""
    pq, pk = pos_q[:, None], pos_k[None, :]
    ok = torch.ones((pq.shape[0], pk.shape[1]), dtype=torch.bool, device=pos_q.device)
    if causal:
        ok = pk <= pq
    if window:
        in_window = pk > pq - window
        if n_sink:
            in_window = in_window | (pk < n_sink)
        ok = ok & in_window
    return ok


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    n_sink: int = 0,
    q_offset: int = 0,
    q_chunk: int = 1024,
    k_chunk: int = 1024,
) -> torch.Tensor:
    """Blocked attention with online softmax (fp32 statistics).

    q: (B, Sq, H, D);  k, v: (B, Sk, KH, D) with H = KH * G (GQA).  Returns
    (B, Sq, H, D).  Score and probability blocks are fp32; probabilities are
    cast to v's dtype before the product with V, as in the JAX package.  Under
    a causal mask a q-block stops at the last KV block its rows can see (the
    blocks past it are fully masked and would add exact zeros).
    """
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    G = H // KH
    scale = 1.0 / math.sqrt(D)
    q_chunk, k_chunk = min(q_chunk, Sq), min(k_chunk, Sk)
    nq, nk = -(-Sq // q_chunk), -(-Sk // k_chunk)
    q = F.pad(q, (0, 0, 0, 0, 0, nq * q_chunk - Sq))
    k = F.pad(k, (0, 0, 0, 0, 0, nk * k_chunk - Sk))
    v = F.pad(v, (0, 0, 0, 0, 0, nk * k_chunk - Sk))
    qb = q.reshape(B, nq, q_chunk, KH, G, D).float()
    kb = k.reshape(B, nk, k_chunk, KH, D).float()
    vb = v.reshape(B, nk, k_chunk, KH, D)
    pos_k_all = torch.arange(nk * k_chunk, device=q.device)
    blocks = []
    for qi in range(nq):
        pos_q = q_offset + qi * q_chunk + torch.arange(q_chunk, device=q.device)
        m = torch.full((B, KH, G, q_chunk), -math.inf, device=q.device)
        l = torch.zeros((B, KH, G, q_chunk), device=q.device)
        acc = torch.zeros((B, KH, G, q_chunk, D), device=q.device)
        hi = min(nk, -(-(q_offset + (qi + 1) * q_chunk) // k_chunk)) if causal else nk
        for ki in range(hi):
            s = torch.einsum("bqkgd,bckd->bkgqc", qb[:, qi], kb[:, ki]) * scale
            pos_k = pos_k_all[ki * k_chunk:(ki + 1) * k_chunk]
            ok = _block_mask(pos_q, pos_k, causal=causal, window=window, n_sink=n_sink)
            ok = ok & (pos_k < Sk)[None, :]  # padded keys are never attended
            s = s.masked_fill(~ok, -math.inf)
            m_new = torch.maximum(m, s.amax(-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
            p = torch.exp(s - m_safe[..., None]).masked_fill(~ok, 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), torch.zeros_like(m))
            l = l * corr + p.sum(-1)
            pv = torch.einsum("bkgqc,bckd->bkgqd", p.to(vb.dtype).float(), vb[:, ki].float())
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / l.clamp_min(1e-30)[..., None]
        blocks.append(out.permute(0, 3, 1, 2, 4))  # (B, q_chunk, KH, G, D)
    out = torch.stack(blocks, dim=1).reshape(B, nq * q_chunk, H, D)
    return out[:, :Sq].to(q.dtype)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, knobs) -> torch.Tensor:
    """Non-causal attention with no window and no sinks, every query
    against every key (whisper's encoder self-attention and the decoder's
    cross-attention over a prompt).

    Under ``knobs.attn == "pallas_fused"`` it is one launch of the
    flash-attention kernel (K3, ``kernels.flash_attention.flash_attention_fwd``,
    whose plain version runs for CPU tensors; p stays in fp32 for the PV
    product), forward only; otherwise :func:`flash_attention`, as the JAX
    package computes it (p cast to v's dtype first).
    """
    if knobs.attn != "pallas_fused":
        return flash_attention(q, k, v, causal=False, q_chunk=knobs.q_chunk,
                               k_chunk=knobs.k_chunk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError("the flash-attention kernel is forward only: train "
                                  "under attn='xla'")
    return fa.flash_attention_fwd(q, k, v, causal=False, q_chunk=knobs.q_chunk,
                                  k_chunk=knobs.k_chunk)


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, D)
    k_cache: torch.Tensor,  # (B, S, KH, D)
    v_cache: torch.Tensor,
    pos: torch.Tensor,  # (B,) current position of the new token
    *,
    window: int = 0,
    n_sink: int = 0,
) -> torch.Tensor:
    """Single-token attention against a (possibly longer) cache: fp32 scores
    and softmax, probabilities cast to the cache dtype for the product."""
    B, _, H, D = q.shape
    S, KH = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, KH, H // KH, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) * (1.0 / math.sqrt(D))
    ok = decode_mask(pos, S, window, n_sink)[:, None, None, :]
    p = torch.softmax(s.masked_fill(~ok, -math.inf), dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(B, 1, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------


def _qkv_post(cfg: ModelConfig, p: Attention, q, k, v, positions: torch.Tensor):
    """Bias / qk-norm / rope applied to freshly projected (…, heads, hd)."""
    cdt = q.dtype
    if cfg.qkv_bias:
        q, k, v = q + p.bq.to(cdt), k + p.bk.to(cdt), v + p.bv.to(cdt)
    if cfg.qk_norm:
        q, k = rms_head_norm(p.q_norm, q), rms_head_norm(p.k_norm, k)
    if cfg.rope_theta:
        q, k = rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta)
    return q, k, v


def _qkv(cfg: ModelConfig, p: Attention, x: torch.Tensor, positions, knobs):
    """Three projections, each through :func:`dense` (one paired launch each
    under ``gemm="pallas_paired"``)."""
    def proj(name):
        heads, hd = getattr(p, name).shape[-2:]
        return _leaf_dense(p, name, x, knobs).reshape(*x.shape[:-1], heads, hd)

    return _qkv_post(cfg, p, proj("wq"), proj("wk"), proj("wv"), positions)


def _fused_qkv_proj(p: Attention, x: torch.Tensor, knobs):
    """All three QKV projections as ONE paired launch, when possible.

    The q/k/v weights concatenate along their output columns and their
    blocked pairing metadata along the block axis (lane lists padded to a
    common Pmax/Rmax with masked zero lanes).  Needs blocked metadata on all
    three and a block size dividing the wq and wk column counts, so blocks
    stay inside one weight.  Returns ``(q, k, v)`` shaped ``(…, heads, hd)``,
    or None when the layout does not allow it.
    """
    names = ("wq", "wk", "wv")
    metas = [p.pairing.get(n) for n in names]
    if any(m is None or m["I"].ndim != 2 for m in metas):
        return None
    bn, cdt = knobs.pair_block_n, x.dtype
    ns = [getattr(p, n).shape[-2] * getattr(p, n).shape[-1] for n in names]
    if bn < 1 or ns[0] % bn or ns[1] % bn:
        return None

    def segments():
        pmax = max(m["I"].shape[1] for m in metas)
        rmax = max(m["resid"].shape[1] for m in metas)
        width = {"I": pmax, "J": pmax, "pair_mask": pmax, "resid": rmax, "resid_mask": rmax}
        meta = {key: torch.cat([F.pad(m[key], (0, n - m[key].shape[1])) for m in metas])
                for key, n in width.items()}
        w = torch.cat([p.matrix(n, cdt) for n in names], dim=1)
        return ops.lm_paired_segments(w, meta, bn)

    y = ops.paired_dense(x, p.derived(("paired_qkv", cdt), segments))
    yq, yk, yv = torch.split(y, ns, dim=-1)
    shape = lambda t, n: t.reshape(*x.shape[:-1], *getattr(p, n).shape[-2:])
    return shape(yq, "wq"), shape(yk, "wk"), shape(yv, "wv")


def attn_out_proj(p: Attention, out: torch.Tensor, knobs,
                  residual: torch.Tensor | None = None, tp=None) -> torch.Tensor:
    """Attention output projection through :func:`dense`, flattened-head
    view; ``residual`` (the sublayer's skip connection) fuses into the
    paired kernel's epilogue.  With query heads split over a mesh, the
    rank's heads are wo's row slab: :func:`row_parallel_dense`."""
    o2 = out.reshape(*out.shape[:-2], -1)
    if tp is not None and tp.q_split:
        return row_parallel_dense(p, "wo", o2, knobs, tp, residual=residual)
    if _whole_seq_split(tp):
        return close_whole(tp, _leaf_dense(p, "wo", o2, knobs, out_dtype=torch.float32),
                           o2.dtype, residual)
    return _leaf_dense(p, "wo", o2, knobs, residual=residual)


def local_kv(tp, k: torch.Tensor, v: torch.Tensor):
    """The KV heads ``(B, S, KH', D)`` that this rank's query heads read.

    Its own where the KV heads split as the query heads do (or nothing is
    split).  Where only the query heads split, local head ``i`` is global
    head ``h0 + i`` and reads global KV head ``(h0 + i) // G``: a slice of
    whole groups, or the one KV head a rank's heads share (then all of them
    are its group), or else a gather of one KV head a query head."""
    if tp is None or not tp.q_split or tp.kv_split:
        return k, v
    h0, n_loc = tp.local_heads
    G = tp.n_heads // tp.n_kv_heads
    if n_loc % G == 0 or G % n_loc == 0:
        sl = slice(h0 // G, h0 // G + max(n_loc // G, 1))
        return k[:, :, sl], v[:, :, sl]
    idx = torch.div(h0 + torch.arange(n_loc, device=k.device), G, rounding_mode="floor")
    return k[:, :, idx], v[:, :, idx]


def attention_block(
    cfg: ModelConfig,
    p: Attention,
    x: torch.Tensor,
    positions: torch.Tensor,
    knobs,
    *,
    causal: bool = True,
    window: int = 0,
    n_sink: int = 0,
    residual: torch.Tensor | None = None,
    tp=None,
):
    """Full attention sublayer (projections + flash attention + out
    projection).  Returns ``(y, k, v)``: the post-rope K/V fill the cache.
    Without the causal mask (an encoder's) the attention is
    :func:`full_attention`, on K3 under ``attn="pallas_fused"``.  On a mesh
    (``tp``) the rank's query heads attend the KV heads they read
    (:func:`local_kv`: the prompt's keys are all here), and the K/V returned
    are the ones its cache holds."""
    q, k, v = _qkv(cfg, p, x, positions, knobs)
    kq, vq = local_kv(tp, k, v)
    if not causal and not window:
        out = full_attention(q, kq, vq, knobs)
    else:
        out = flash_attention(q, kq, vq, causal=causal, window=window, n_sink=n_sink,
                              q_chunk=knobs.q_chunk, k_chunk=knobs.k_chunk)
    return attn_out_proj(p, out, knobs, residual=residual, tp=tp), k, v


def attention_decode_block(
    cfg: ModelConfig,
    p: Attention,
    x: torch.Tensor,  # (B, 1, d)
    cache: dict,  # {"k": (B, S, KH, hd), "v": ...}, updated in place
    pos: torch.Tensor,  # (B,)
    knobs,
    *,
    window: int = 0,
    n_sink: int = 0,
    residual: torch.Tensor | None = None,
    tp=None,
) -> tuple[torch.Tensor, dict]:
    """One decode token: QKV, cache write at ``pos`` (in place: the port's
    caches are mutable, unlike the JAX package's), attention and the
    out-projection with ``residual`` fused.

    With ``knobs.attn == "pallas_fused"`` the attention and out-projection
    run as one decode-attention launch, and under paired GEMMs with blocked
    metadata the QKV projections as one paired launch.  On a mesh (``tp``;
    the attention is plain there, as the JAX package's mesh engine keeps it)
    the rank's query heads attend its cache: the KV heads they read
    (:func:`local_kv`), or against a sequence-sharded cache
    :func:`seq_sharded_decode_attention`; wo is row-parallel.
    """
    if tp is not None:
        q, k, v = _qkv(cfg, p, x, pos[:, None], knobs)
        if tp.cache_seq:
            out = seq_sharded_decode_attention(tp, q, k, v, cache, pos, window=window,
                                               n_sink=n_sink)
        else:
            bidx = torch.arange(x.shape[0], device=x.device)
            cache["k"][bidx, pos] = k[:, 0].to(cache["k"].dtype)
            cache["v"][bidx, pos] = v[:, 0].to(cache["v"].dtype)
            kc, vc = local_kv(tp, cache["k"], cache["v"])
            out = decode_attention(q, kc, vc, pos, window=window, n_sink=n_sink)
        return attn_out_proj(p, out, knobs, residual=residual, tp=tp), cache
    fused = knobs.attn == "pallas_fused" and x.shape[1] == 1
    paired = knobs.gemm == "pallas_paired"
    qkv = _fused_qkv_proj(p, x, knobs) if fused and paired else None
    if qkv is None:
        q, k, v = _qkv(cfg, p, x, pos[:, None], knobs)
    else:
        q, k, v = _qkv_post(cfg, p, *qkv, pos[:, None])
    bidx = torch.arange(x.shape[0], device=x.device)
    k_cache, v_cache = cache["k"], cache["v"]
    k_cache[bidx, pos] = k[:, 0].to(k_cache.dtype)
    v_cache[bidx, pos] = v[:, 0].to(v_cache.dtype)
    if not fused:
        out = decode_attention(q, k_cache, v_cache, pos, window=window, n_sink=n_sink)
        return attn_out_proj(p, out, knobs, residual=residual), cache
    cdt = x.dtype
    meta = p.pairing.get("wo") if paired else None
    bn = knobs.pair_block_n if paired else 0
    if not p.frozen and torch.is_grad_enabled():  # from the live weights, differentiably
        y = ops.fused_attn_decode(q, k_cache, v_cache, pos, p.matrix("wo", cdt), meta,
                                  residual=residual, pair_block_n=bn, window=window,
                                  n_sink=n_sink)
        return y, cache
    seg = p.derived(("attn_out", cdt, meta is not None), lambda: ops.attn_outproj_segments(
        p.matrix("wo", cdt), meta, bn))
    y = ops.attn_decode(q, k_cache, v_cache, pos, seg, residual=residual,
                        window=window, n_sink=n_sink)
    return y, cache


def seq_sharded_decode_attention(tp, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 cache: dict, pos: torch.Tensor, *, window: int = 0,
                                 n_sink: int = 0) -> torch.Tensor:
    """One decode token's attention against a cache whose positions are
    split over ``model``: the rank holds keys ``[r·S', (r + 1)·S')``.

    The new K/V ``(B, 1, KH, D)`` are written only by the rank that holds
    ``pos`` (each slot's own).  Every rank needs every query head for its
    keys, so the queries are all-gathered over ``model`` (where they are
    split); each rank computes the fp32 partial softmax ``(m, l, acc)`` of
    its keys under the window/sink mask, the partials are all-gathered and
    merged in fp32 in rank order, and the rank keeps its own heads.  A rank
    with no admitted key contributes ``m = −inf`` and zeros (its
    ``exp(−inf − (−inf))`` is never formed).  Returns ``(B, 1, H', D)`` in
    q's dtype.
    """
    k_cache, v_cache = cache["k"], cache["v"]
    B, S_loc = k_cache.shape[0], k_cache.shape[1]
    lo = tp.r * S_loc
    _write_at(tp, k_cache, k[:, 0], pos)
    _write_at(tp, v_cache, v[:, 0], pos)

    h0, n_loc = tp.local_heads
    qf = all_gather(q, tp.model_group, dim=2) if tp.q_split else q  # (B, 1, H, D)
    H, D = qf.shape[2], qf.shape[3]
    KH = k_cache.shape[2]
    qg = qf.reshape(B, KH, H // KH, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) * (1.0 / math.sqrt(D))
    pk = lo + torch.arange(S_loc, device=q.device)[None, :]
    p_ = pos.to(torch.int64)[:, None]
    ok = pk <= p_
    if window:
        in_w = pk > p_ - window
        if n_sink:
            in_w = in_w | (pk < n_sink)
        ok = ok & in_w
    s = s.masked_fill(~ok[:, None, None, :], -math.inf)
    m = s.amax(-1)  # (B, KH, G); −inf where no key is admitted
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe[..., None])  # masked keys: exp(−inf) = 0
    l = p.sum(-1)
    acc = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    out = merge_partial_softmax(tp, m, l, acc)  # (B, KH, G, D)
    out = out.reshape(B, 1, H, D)[:, :, h0:h0 + n_loc]
    return out.to(q.dtype)


def merge_partial_softmax(tp, m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor
                          ) -> torch.Tensor:
    """The softmax-weighted sum of every rank's keys from each rank's fp32
    partials over its own: the row maximum ``m`` (−inf where the rank
    admitted no key), the sum ``l`` of ``exp(s − m)`` and ``acc`` (…, D),
    the values weighted so.  One all-gather over ``model`` brings them
    together, merged in fp32 in rank order."""
    parts = all_gather(torch.cat([m[..., None], l[..., None], acc], dim=-1)[None],
                       tp.model_group, dim=0)  # (n, …, D + 2)
    m_all, l_all, acc_all = parts[..., 0], parts[..., 1], parts[..., 2:]
    m_max = m_all.amax(0)
    m_max = torch.where(torch.isfinite(m_max), m_max, torch.zeros_like(m_max))
    w = torch.where(torch.isfinite(m_all), torch.exp(m_all - m_max), torch.zeros_like(m_all))
    return (w[..., None] * acc_all).sum(0) / (w * l_all).sum(0).clamp_min(1e-30)[..., None]


def _write_at(tp, cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor) -> None:
    """Write each slot's ``new`` (B, …) into ``cache`` (B, S', …) at its
    position ``pos``, in place; with the positions split over ``model``
    (``tp.cache_seq``) only the rank that holds ``pos`` writes, at
    ``pos − r·S'``."""
    B, S_loc = cache.shape[0], cache.shape[1]
    bidx = torch.arange(B, device=cache.device)
    if tp is None or not tp.cache_seq:
        cache[bidx, pos] = new.to(cache.dtype)
        return
    lo = tp.r * S_loc
    mine = ((pos >= lo) & (pos < lo + S_loc)).reshape(B, *[1] * (new.dim() - 1))
    at = (pos - lo).clamp(0, S_loc - 1)
    cache[bidx, at] = torch.where(mine, new.to(cache.dtype), cache[bidx, at])


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------


def _mla_latent(cfg: ModelConfig, p: MLA, x: torch.Tensor, positions: torch.Tensor, knobs):
    """The normed latent ``c_kv`` (B, S, R) and the post-rope shared key
    ``k_rope`` (B, S, rope) of ``x``: what the cache holds."""
    c_kv = rms_head_norm(p.kv_norm, _leaf_dense(p, "w_dkv", x, knobs))
    k_rope = rope(_leaf_dense(p, "w_kr", x, knobs)[:, :, None, :], positions, cfg.rope_theta)
    return c_kv, k_rope[:, :, 0, :]


def _mla_query(cfg: ModelConfig, p: MLA, x: torch.Tensor, positions: torch.Tensor, knobs):
    """``(q_nope, q_rope)`` of ``x``, (B, S, H, nope) and (B, S, H, rope)
    post-rope."""
    m = cfg.mla
    q = _leaf_dense(p, "wq", x, knobs).reshape(*x.shape[:-1], p.wq.shape[-2],
                                               m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = torch.split(q, [m.qk_nope_dim, m.qk_rope_dim], dim=-1)
    return q_nope, rope(q_rope, positions, cfg.rope_theta)


def _mla_up(p: MLA, cdt: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """The latent up-projections ``w_uk``, ``w_uv`` in the compute dtype."""
    return _cast(p, "w_uk", cdt), _cast(p, "w_uv", cdt)


def _mla_out(p: MLA, out: torch.Tensor, knobs, tp) -> torch.Tensor:
    """MLA's out-projection of the heads' values (…, H·v): row-parallel
    (:func:`row_parallel_dense`, no skip connection) where the heads are
    split over a mesh; whole on a sequence-parallel training rank, the
    rank's positions of it (:func:`close_whole`)."""
    if tp is not None and tp.q_split:
        return row_parallel_dense(p, "wo", out, knobs, tp)
    if _whole_seq_split(tp):
        return close_whole(tp, _leaf_dense(p, "wo", out, knobs, out_dtype=torch.float32),
                           out.dtype)
    return _leaf_dense(p, "wo", out, knobs)


def mla_block(cfg: ModelConfig, p: MLA, x: torch.Tensor, positions: torch.Tensor, knobs,
              tp=None):
    """Prefill MLA: per-head K/V materialised from the latent, then
    :func:`flash_attention` (``v`` padded to the q/k head width, as in the
    JAX package) and the out-projection.  Returns ``(y, c_kv, k_rope)``:
    ``y`` (B, S, d) without the skip connection (the JAX package adds it
    after), and the latent cache entries of :func:`_mla_latent`.

    The down-projections ``wq``/``w_dkv``/``w_kr`` and ``wo`` go through
    :func:`dense` (paired launches when they carry metadata); the
    up-projections ``w_uk``/``w_uv`` stay einsums.  On a mesh the rank's
    heads (its slices of ``wq``, ``w_uk`` and ``w_uv``) attend every key of
    the prompt, and ``wo`` is row-parallel; the latent is whole on every
    rank (``w_dkv``/``w_kr`` are replicated).
    """
    m, H = cfg.mla, p.wq.shape[-2]
    cdt = x.dtype
    c_kv, k_rope = _mla_latent(cfg, p, x, positions, knobs)
    q_nope, q_rope = _mla_query(cfg, p, x, positions, knobs)
    w_uk, w_uv = _mla_up(p, cdt)
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv, w_uk)
    v = torch.einsum("bsr,rhk->bshk", c_kv, w_uv)
    k_rope_h = k_rope[:, :, None, :].expand(*k_rope.shape[:2], H, m.qk_rope_dim)
    qc = torch.cat([q_nope, q_rope], dim=-1)
    kc = torch.cat([k_nope, k_rope_h], dim=-1)
    out = flash_attention(qc, kc, F.pad(v, (0, qc.shape[-1] - m.v_head_dim)), causal=True,
                          q_chunk=knobs.q_chunk, k_chunk=knobs.k_chunk)[..., : m.v_head_dim]
    y = _mla_out(p, out.reshape(*out.shape[:-2], H * m.v_head_dim), knobs, tp)
    return y, c_kv, k_rope


def mla_decode_block(
    cfg: ModelConfig,
    p: MLA,
    x: torch.Tensor,  # (B, 1, d)
    cache: dict,  # {"c_kv": (B, S, R), "k_rope": (B, S, rope)}, updated in place
    pos: torch.Tensor,  # (B,)
    knobs,
    tp=None,
) -> tuple[torch.Tensor, dict]:
    """Absorbed-matrix MLA decode: the new latent and rope key written into
    the cache at ``pos`` (in place), then attention in the latent space,
    ``w_uk`` folded into the query and ``w_uv`` into the output.  Returns
    ``(y, cache)``, ``y`` (B, 1, d) without the skip connection.

    The JAX package's rounding points: ``q_lat`` and the ``w_uv`` product in
    the compute dtype; both scores and ``o_lat`` accumulated in fp32 (the
    operands cast up, as ``preferred_element_type=float32``); the
    probabilities cast to the compute dtype before ``o_lat``.

    On a mesh the rank computes its heads' absorbed queries; against a cache
    whose positions are split over ``model`` (``tp.cache_seq``) only the
    rank that holds ``pos`` writes it, the queries ``[q_lat | q_rope]``
    (576 lanes a head at full width) are all-gathered where the heads are
    split, each rank takes the fp32 partial softmax of every head over its
    positions (:func:`merge_partial_softmax`; the probabilities stay fp32)
    and keeps its own heads' ``o_lat`` for ``w_uv``; ``wo`` is row-parallel.
    """
    m, H = cfg.mla, p.wq.shape[-2]
    cdt, B = x.dtype, x.shape[0]
    q_nope, q_rope = _mla_query(cfg, p, x, pos[:, None], knobs)
    c_new, kr_new = _mla_latent(cfg, p, x, pos[:, None], knobs)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    _write_at(tp, c_kv, c_new[:, 0], pos)
    _write_at(tp, k_rope, kr_new[:, 0], pos)

    w_uk, w_uv = _mla_up(p, cdt)
    q_lat = torch.einsum("bhk,rhk->bhr", q_nope[:, 0], w_uk)
    ckv = c_kv.float()
    scale = math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    if tp is not None and tp.cache_seq:
        q = torch.cat([q_lat, q_rope[:, 0]], dim=-1)  # (B, H', R + rope)
        q = all_gather(q, tp.model_group, dim=1) if tp.q_split else q
        q_lat_all, q_rope_all = torch.split(q, [q_lat.shape[-1], m.qk_rope_dim], dim=-1)
        s = torch.einsum("bhr,bsr->bhs", q_lat_all.float(), ckv)
        s = s + torch.einsum("bhk,bsk->bhs", q_rope_all.float(), k_rope.float())
        s = s / scale
        S_loc = c_kv.shape[1]
        pk = tp.r * S_loc + torch.arange(S_loc, device=x.device)[None, :]
        s = s.masked_fill(~(pk <= pos.to(torch.int64)[:, None])[:, None], -math.inf)
        mx = s.amax(-1)  # (B, H); −inf where the rank admits no key
        pr = torch.exp(s - torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))[..., None])
        o_all = merge_partial_softmax(tp, mx, pr.sum(-1), torch.einsum("bhs,bsr->bhr", pr, ckv))
        h0 = tp.local_heads[0]
        o_lat = o_all[:, h0:h0 + H].to(cdt)
    else:
        s = torch.einsum("bhr,bsr->bhs", q_lat.float(), ckv)
        s = s + torch.einsum("bhk,bsk->bhs", q_rope[:, 0].float(), k_rope.float())
        s = s / scale
        ok = torch.arange(c_kv.shape[1], device=x.device)[None, :] <= pos[:, None]
        pr = torch.softmax(s.masked_fill(~ok[:, None], -math.inf), dim=-1)
        o_lat = torch.einsum("bhs,bsr->bhr", pr.to(cdt).float(), ckv).to(cdt)
    out = torch.einsum("bhr,rhk->bhk", o_lat, w_uv)
    y = _mla_out(p, out.reshape(B, H * m.v_head_dim), knobs, tp)
    return y[:, None], cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_block(cfg: ModelConfig, p: MLP, x: torch.Tensor, knobs,
              residual: torch.Tensor | None = None, tp=None) -> torch.Tensor:
    """Gated MLP; ``residual`` fuses the sublayer skip connection into the
    down-projection (the paired kernel's epilogue, or a plain add).  With
    the hidden columns split over a mesh, w_gate and w_up are
    column-parallel and w_down row-parallel (:func:`row_parallel_dense`)."""
    g = _leaf_dense(p, "w_gate", x, knobs, act=cfg.act)
    u = _leaf_dense(p, "w_up", x, knobs)
    if tp is not None and tp.ff_split:
        return row_parallel_dense(p, "w_down", g * u, knobs, tp, residual=residual)
    if _whole_seq_split(tp):
        return close_whole(tp, _leaf_dense(p, "w_down", g * u, knobs, out_dtype=torch.float32),
                           x.dtype, residual)
    return _leaf_dense(p, "w_down", g * u, knobs, residual=residual)


# ---------------------------------------------------------------------------
# MoE (top-k routing with per-sequence capacity, sort-based dispatch)
# ---------------------------------------------------------------------------


def _top_k(gates: torch.Tensor, k: int):
    """The ``k`` largest gates of each row and their experts, ties to the
    lower expert index (``jax.lax.top_k``'s order): a stable descending sort."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _moe_route(cfg: ModelConfig, x: torch.Tensor, topi: torch.Tensor, topw: torch.Tensor):
    """Per-sequence dispatch buffers and their inverse maps.

    Each sequence's (token, choice) pairs are sorted by expert (stably, so a
    token keeps its place in its expert's queue) and the first ``C`` of each
    expert kept.  Returns ``xb`` (B, E, C, d), the token ``inv_tok`` (B, E·C)
    of each buffer slot (``S`` for an empty one) with its gate ``inv_w``
    (B, E·C, fp32; 0 for an empty one), the per-sequence ``counts`` (B, E)
    of choices of each expert, and ``C``.  Choices past capacity write the
    overflow slot ``E·C``, which is cut off.
    """
    mo = cfg.moe
    B, S, d = x.shape
    E, K = mo.n_experts, mo.top_k
    C = max(1, int(math.ceil(S * K / E * mo.capacity_factor)))
    SK, dev = S * K, x.device
    bidx = torch.arange(B, device=dev)[:, None]
    flat_e = topi.reshape(B, SK)
    sort_idx = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, sort_idx)
    counts = torch.zeros((B, E), dtype=torch.int64, device=dev).scatter_add_(
        1, flat_e, torch.ones_like(flat_e))
    starts = counts.cumsum(-1) - counts
    pos_in_e = torch.arange(SK, device=dev)[None] - torch.gather(starts, 1, sorted_e)
    keep = pos_in_e < C
    tok_of = sort_idx // K
    buf_slot = torch.where(keep, sorted_e * C + pos_in_e, E * C)

    xb = x.new_zeros((B, E * C + 1, d))
    xb[bidx, buf_slot] = x[bidx, tok_of]
    xb = xb[:, : E * C].reshape(B, E, C, d)
    w_sorted = torch.gather(topw.reshape(B, SK).float(), 1, sort_idx)
    inv_tok = torch.full((B, E * C + 1), S, dtype=torch.int64, device=dev)
    inv_tok[bidx, buf_slot] = tok_of
    inv_w = torch.zeros((B, E * C + 1), dtype=torch.float32, device=dev)
    inv_w[bidx, buf_slot] = w_sorted * keep
    return xb, inv_tok[:, : E * C], inv_w[:, : E * C], counts, C


def _moe_combine(B: int, S: int, d: int, yb: torch.Tensor, inv_tok: torch.Tensor,
                 inv_w: torch.Tensor, cdt: torch.dtype, top_k: int) -> torch.Tensor:
    """(B, S, d): each token's sum of its slots' gated outputs ``yb``
    (B, E, C, d), added in the compute dtype in slot order.

    The JAX package scatter-adds the slots in order; here each token gathers
    its (at most ``top_k``) slots, in ascending order, and adds them one by
    one: the same sums, with no atomics, so a rerun gives the same bits.
    """
    dev = yb.device
    EC = inv_tok.shape[1]
    bidx = torch.arange(B, device=dev)[:, None]
    order = torch.argsort(inv_tok, dim=-1, stable=True)  # slots by token, ascending
    tok = torch.gather(inv_tok, 1, order)
    n_of = torch.zeros((B, S + 1), dtype=torch.int64, device=dev).scatter_add_(
        1, tok, torch.ones_like(tok))
    rank = torch.arange(EC, device=dev)[None] - torch.gather(n_of.cumsum(-1) - n_of, 1, tok)
    # (B, S + 1, EC) would do; a token has at most top_k slots, the dummy
    # token S many more, and its row is cut off
    table = torch.full((B, S + 1, top_k), EC, dtype=torch.int64, device=dev)
    real = tok < S
    # every empty slot writes the dummy row's first entry (a shape that does
    # not depend on the routing, so a trace on fake tensors runs it)
    table[bidx.expand_as(tok), tok, torch.where(real, rank, 0)] = torch.where(real, order, EC)
    contrib = yb.reshape(B, EC, d) * inv_w[..., None].to(cdt)
    contrib = torch.cat([contrib, contrib.new_zeros((B, 1, d))], dim=1)  # slot EC: zeros
    y = torch.zeros((B, S, d), dtype=cdt, device=dev)
    for k in range(top_k):
        y = y + contrib[bidx, table[:, :S, k]]
    return y


def _expert_dense(p: MoE, name: str, x: torch.Tensor, knobs, *, act=None,
                  per_expert: bool = False) -> torch.Tensor:
    """Every expert's GEMM against weight ``name`` of ``p`` as one paired
    launch over the expert grid → (M, E, F): under grad with a trainable
    weight, differentiably from its live values
    (``ops.fused_paired_expert_dense``); otherwise on segments, kept on a
    frozen block."""
    cdt = x.dtype
    w = getattr(p, name)
    if torch.is_grad_enabled() and w.requires_grad:
        return ops.fused_paired_expert_dense(x, w.to(cdt), p.pairing[name],
                                             activation=act or "none", x_per_expert=per_expert,
                                             pair_block_n=knobs.pair_block_n)
    seg = p.derived(("paired", name, cdt), lambda: ops.lm_expert_segments(
        getattr(p, name).to(cdt), p.pairing[name], knobs.pair_block_n))
    return ops.expert_dense(x, seg, activation=act or "none", x_per_expert=per_expert)


def moe_block(cfg: ModelConfig, p: MoE, x: torch.Tensor, knobs, tp=None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Routed experts over ``x`` (B, S, d). Returns ``(y, aux)``: the
    experts' gated sum (B, S, d) in x's dtype, without the skip connection,
    and the Switch load-balance loss (fp32 scalar; 0 on the dense branch).

    The router runs in fp32: softmax gates, top-k, renormalised.  Two
    branches, as in the JAX package:

    * **dense** (``T·K ≤ 2E``, decode and short prompts): every expert runs
      on every token, no capacity and no drops;
    * **routed**: per-sequence capacity ``C``, sort-based dispatch into
      (B, E, C, d) buffers, each expert's rows through its own weights,
      then the gated combine.  Choices past capacity are dropped.

    Shared experts (``p.shared``) run on every token on both branches, their
    three projections through :func:`dense`, and add to the routed sum, as
    in the JAX package.

    With the experts split over a mesh (``tp.experts_split``), a rank runs
    its own ``E/n`` experts: on the dense branch every token through them,
    their gated sum in fp32; on the routed branch :func:`_moe_shard_map`.
    Where the router's expert columns are split too (``tp.router_split``)
    each rank's logits are all-gathered over ``model`` first, so every rank
    routes alike.  Shared experts split over their hidden columns
    (``tp.shared_split``) add their row-parallel partial sum in fp32 beside
    the routed one; one all-reduce over ``model`` in fp32 closes both before
    the cast.

    Under ``knobs.gemm == "pallas_paired"`` with expert pairing metadata,
    each projection of all experts is one paired launch over the expert grid
    (:func:`_expert_dense`), on both branches and in training too: its
    backward is autograd of the einsum on the folded experts, as the JAX
    package's custom VJP; otherwise ``torch.einsum`` as the JAX package's
    ``jnp.einsum``.

    A training rank (``tp.train``) runs the block over all positions of its
    rows (``x`` is what :func:`seq_enter` gathered) and returns its own
    positions of ``y``: the routed and the shared experts' partial sums
    closed together by one :func:`close_partial`, or kept at the rank's
    positions where they are whole (:func:`close_whole`); the branch is
    chosen by the global batch's tokens, and the aux loss is the global
    batch's (:func:`_train_aux`).
    """
    mo = cfg.moe
    B, S, d = x.shape
    T, E, K = B * S, mo.n_experts, mo.top_k
    cdt = x.dtype
    paired = knobs.gemm == "pallas_paired" and "w_gate" in p.pairing

    shared = getattr(p, "shared", None)
    split = tp is not None and tp.experts_split
    shared_split = tp is not None and tp.shared_split and shared is not None
    train = tp is not None and tp.train
    # the global batch's tokens: a data-split training rank holds some of its rows
    T_all = T * (tp.dp if train and tp.batch_split else 1)

    def shared_experts(x2, partial=False):
        """The shared experts' gated MLP over (T, d) rows, no skip
        connection; ``partial``: the rank's fp32 row-parallel sum."""
        g = _leaf_dense(shared, "w_gate", x2, knobs, act=cfg.act)
        return _leaf_dense(shared, "w_down", g * _leaf_dense(shared, "w_up", x2, knobs), knobs,
                           out_dtype=torch.float32 if partial else None)

    def close(y2, partial):
        """The routed sum ``y2`` (T, d) — the rank's fp32 partial sum where
        ``partial`` — with the shared experts added, as (B, S, d); one
        all-reduce over ``model`` closes whatever is partial.  A training
        rank's: its positions (B, S/n, d) under sequence parallelism."""
        if train:
            return _close_train(y2.reshape(B, S, d), partial)
        return _close_shared(y2, partial).reshape(B, S, d)

    def _close_train(y3, partial):
        """A training rank's close: the fp32 partial sums (the routed one
        where ``partial``, the shared experts' where their columns split)
        closed together by one :func:`close_partial`, what is whole kept at
        the rank's positions (:func:`_own_positions`), the shared experts'
        output added to the routed one."""
        if shared is None:
            return close_partial(tp, y3, cdt) if partial else _own_positions(tp, y3, cdt)
        y_sh = shared_experts(x2, partial=True).reshape(B, S, d)
        if partial and shared_split:
            return close_partial(tp, y3 + y_sh, cdt)
        routed = close_partial(tp, y3, cdt) if partial else _own_positions(tp, y3, cdt)
        return routed + (close_partial(tp, y_sh, cdt) if shared_split
                         else _own_positions(tp, y_sh, cdt))

    def _close_shared(y2, partial):
        if shared is None:
            return all_reduce(y2, tp.model_group).to(cdt) if partial else y2
        if shared_split:
            y_sh = shared_experts(x2, partial=True)
            if partial:
                return all_reduce(y2 + y_sh, tp.model_group).to(cdt)
            return y2 + all_reduce(y_sh, tp.model_group).to(cdt)
        if partial:
            return all_reduce(y2, tp.model_group).to(cdt) + shared_experts(x2)
        return y2 + shared_experts(x2)

    def experts(xe, per_expert):
        """gate, up and down of every expert; xe (M, d) or (E, M, d) → (M, E, d)."""
        if paired:
            g = _expert_dense(p, "w_gate", xe, knobs, act=cfg.act, per_expert=per_expert)
            u = _expert_dense(p, "w_up", xe, knobs, per_expert=per_expert)
            return _expert_dense(p, "w_down", (g * u).movedim(1, 0), knobs, per_expert=True)
        eq = "etd,edf->tef" if per_expert else "td,edf->tef"
        g = activation(cfg.act, torch.einsum(eq, xe, _cast(p, "w_gate", cdt)))
        u = torch.einsum(eq, xe, _cast(p, "w_up", cdt))
        return torch.einsum("tef,efd->ted", g * u, _cast(p, "w_down", cdt))

    x2 = x.reshape(T, d)
    logits = x2.float() @ p.router.float()
    if tp is not None and tp.router_split:
        logits = all_gather(logits, tp.model_group, dim=-1)  # (T, E)
    gates = torch.softmax(logits, dim=-1)  # (T, E)
    topw, topi = _top_k(gates, K)
    topw = topw / topw.sum(-1, keepdim=True).clamp_min(1e-9)

    if T_all * K <= 2 * E:
        y_all = experts(x2, per_expert=False)  # (T, E, d), or (T, E/n, d) on a mesh
        w_full = torch.zeros((T, E), dtype=cdt, device=x.device).scatter_(1, topi, topw.to(cdt))
        if split:
            e0 = tp.r * y_all.shape[1]
            w_loc = w_full[:, e0:e0 + y_all.shape[1]]
            y2 = torch.einsum("ted,te->td", y_all.float(), w_loc.float())
        else:
            y2 = torch.einsum("ted,te->td", y_all, w_full)
        return close(y2, split), torch.zeros((), dtype=torch.float32, device=x.device)

    if split:
        y2, counts = _moe_shard_map(cfg, x, topi, topw, experts, tp)
        if train:
            return close(y2.reshape(T, d), True), _train_aux(cfg, tp, gates, topi, B, S, T_all)
        me = gates.mean(0)
        ce = counts.float() / max(T * K, 1)
        return close(y2.reshape(T, d), True), (me * ce).sum() * (E * mo.router_aux_weight)

    xb, inv_tok, inv_w, counts, C = _moe_route(cfg, x, topi, topw)
    # experts as the grid's blocks: the (B, C) token rows of each expert's
    # buffer are that expert's rows of the GEMM
    yb = experts(xb.permute(1, 0, 2, 3).reshape(E, B * C, d), per_expert=True)
    yb = yb.reshape(B, C, E, d).permute(0, 2, 1, 3)
    y2 = close(_moe_combine(B, S, d, yb, inv_tok, inv_w, cdt, K).reshape(T, d), False)
    if train:
        return y2, _train_aux(cfg, tp, gates, topi, B, S, T_all)

    me = gates.mean(0)  # mean router probability of each expert
    ce = counts.sum(0).float() / max(T * K, 1)  # share of the choices it got
    aux = (me * ce).sum() * (E * mo.router_aux_weight)
    return y2, aux


def _train_aux(cfg: ModelConfig, tp, gates: torch.Tensor, topi: torch.Tensor, B: int, S: int,
               T_all: int) -> torch.Tensor:
    """The Switch load-balance loss of the global batch on a training rank:
    the mean router probability ``me`` and the share of the choices ``ce``
    of each expert over all ``T_all`` tokens.  Every rank holds the gates
    (T, E) and choices (T, K) of all positions of its rows; it sums those
    of its own positions (``tp.own``), and one all-reduce over the model
    axis and the data axes that split the batch adds every rank's (each
    position of each row counted once).  The gradient reaches the gates of
    the rank's own positions only: its part of theirs."""
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    own = tp.own(S)
    g = gates.reshape(B, S, E)[:, own].sum((0, 1))
    chosen = topi.reshape(B, S, K)[:, own].reshape(-1)
    c = torch.zeros(E, dtype=torch.float32, device=gates.device).index_add_(
        0, chosen, torch.ones(chosen.shape, dtype=torch.float32, device=gates.device))
    stat = all_reduce(torch.stack([g, c]), tp.mesh_group if tp.batch_split else tp.model_group)
    me = stat[0] / T_all
    ce = stat[1] / max(T_all * K, 1)
    return (me * ce).sum() * (E * cfg.moe.router_aux_weight)


def _moe_shard_map(cfg: ModelConfig, x: torch.Tensor, topi: torch.Tensor,
                   topw: torch.Tensor, experts, tp) -> tuple[torch.Tensor, torch.Tensor]:
    """The expert-parallel routed branch, the JAX package's
    ``_moe_shard_map`` with its collectives written out: routing is
    replicated (every rank of a data row holds the same tokens and gates),
    each rank slices its own experts' dispatch buffers from the full
    dispatch, runs them (``experts``, the rank's ``E/n`` expert weights: one
    K1 launch a projection over the grid under ``gemm="pallas_paired"``),
    and combines its slots' gated outputs into a partial sum in fp32, which
    the caller's one all-reduce over ``model`` closes (beside the shared
    experts' partial sum); there is no all-to-all.  Returns ``(y (B, S, d)
    fp32, the rank's partial sum; counts (E,))``, the choices of each expert
    summed over the sequences and, where the batch is split over the data
    axes, over them (one all-reduce)."""
    mo = cfg.moe
    B, S, d = x.shape
    E = mo.n_experts
    E_loc = E // tp.n
    e0 = tp.r * E_loc
    xb, inv_tok, inv_w, counts, C = _moe_route(cfg, x, topi, topw)
    xb_mine = xb[:, e0:e0 + E_loc]  # (B, E/n, C, d)
    yb = experts(xb_mine.permute(1, 0, 2, 3).reshape(E_loc, B * C, d), per_expert=True)
    yb = yb.reshape(B, C, E_loc, d).permute(0, 2, 1, 3)
    inv_tok_m = inv_tok.reshape(B, E, C)[:, e0:e0 + E_loc].reshape(B, E_loc * C)
    inv_w_m = inv_w.reshape(B, E, C)[:, e0:e0 + E_loc].reshape(B, E_loc * C)
    y2 = _moe_combine(B, S, d, yb.float(), inv_tok_m, inv_w_m, torch.float32, mo.top_k)
    counts = counts.sum(0)
    if tp.batch_split and not tp.train:  # a training rank counts its own positions instead
        counts = all_reduce(counts, tp.data_group)
    return y2, counts


# ---------------------------------------------------------------------------
# Mamba-2 (SSD) block
# ---------------------------------------------------------------------------


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along the sequence, then SiLU. x: (B, S, C);
    w: (W, C); the sequence left-padded with W − 1 zero rows."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    return F.silu(sum(xp[:, i:i + S] * w[i] for i in range(W)))


def _segsum_decay(dA_chunk: torch.Tensor) -> torch.Tensor:
    """Lower-triangular decay matrix ``L[q, t] = exp(sum_{t<i<=q} dA_i)``.

    dA_chunk: (..., Q). Returns (..., Q, Q) with zeros above the diagonal.
    Those are masked to −inf before the exp: above the diagonal ``diff`` is
    a sum of −dA, which overflows fp32 at full width (hymba-1.5b's 50 heads
    over a 256-position chunk), and the exp's gradient there, 0 · inf, was
    NaN in every weight's gradient.  The JAX package masks after the exp
    (``jnp.where``) and takes that NaN; the values and every finite
    gradient are the same.
    """
    Q = dA_chunk.shape[-1]
    cs = torch.cumsum(dA_chunk, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]  # sum over (t, q]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=dA_chunk.device).tril()
    return torch.exp(diff.masked_fill(~mask, -math.inf))


def ssd_scan(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H), softplus'd: positive
    A: torch.Tensor,  # (H,) negative
    B_: torch.Tensor,  # (B, S, G, N)
    C_: torch.Tensor,  # (B, S, G, N)
    *,
    chunk: int,
    h0: torch.Tensor | None = None,  # (B, H, P, N) fp32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD (Mamba-2 Listing 1, the matmul form): returns ``(y,
    h_final)``, y (B, S, H, P) in x's dtype, h_final (B, H, P, N) fp32.

    The sequence is zero-padded to whole chunks (``dt = 0`` there: the
    padding neither decays nor feeds the state).  Within a chunk the output
    is a masked (Q, Q) product against the decay matrix; the chunk states
    pass from chunk to chunk through the sequential recurrence ``h ← h ·
    exp(Σ dA) + state``, starting at ``h0``.  Heads share ``B``/``C`` within
    each of the G groups.  The JAX package's rounding points: the scores
    ``C·B`` accumulate in fp32 from the compute-dtype ``C``/``B``; ``dt``,
    the decays, states and both output terms are fp32; y is cast to x's
    dtype at the end.
    """
    Bb, S, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    rep = H // G
    nc = -(-S // chunk)
    pad = nc * chunk - S
    if pad:
        x, B_, C_ = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, B_, C_))
        dt = F.pad(dt, (0, 0, 0, pad))
    Q = chunk
    xc = x.reshape(Bb, nc, Q, H, P)
    dtc = dt.reshape(Bb, nc, Q, H).float()
    Bc = B_.reshape(Bb, nc, Q, G, N).float()
    Cc = C_.reshape(Bb, nc, Q, G, N).float()

    dA = dtc * A  # (B, nc, Q, H), negative
    cs = torch.cumsum(dA, dim=2)  # within each chunk

    # intra-chunk (the diagonal blocks): scores[b,c,g,q,t] = C[q]·B[t], shared
    # by the heads of a group, times the decay from t to q
    scores = torch.einsum("bcqgn,bctgn->bcgqt", Cc, Bc)
    L = _segsum_decay(dA.transpose(2, 3))  # (B, nc, H, Q, Q)
    W = scores[:, :, :, None] * L.reshape(Bb, nc, G, rep, Q, Q)
    xdt = (xc.float() * dtc[..., None]).reshape(Bb, nc, Q, G, rep, P)
    y_diag = torch.einsum("bcgrqt,bctgrp->bcqgrp", W, xdt)

    # each chunk's state: its inputs decayed to the chunk's end
    decay_end = torch.exp(cs[:, :, -1:, :] - cs)  # (B, nc, Q, H)
    dg = (decay_end * dtc).reshape(Bb, nc, Q, G, rep)
    xg = xc.float().reshape(Bb, nc, Q, G, rep, P) * dg[..., None]
    states = torch.einsum("bctgn,bctgrp->bcgrpn", Bc, xg)

    # inter-chunk recurrence, sequential over chunks: the state before each
    chunk_decay = torch.exp(cs[:, :, -1, :]).reshape(Bb, nc, G, rep, 1, 1)
    h = (h0.float().reshape(Bb, G, rep, P, N) if h0 is not None
         else torch.zeros((Bb, G, rep, P, N), dtype=torch.float32, device=x.device))
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c] + states[:, c]
    h_prev = torch.stack(h_prevs, dim=1)  # (B, nc, G, rep, P, N)

    # inter-chunk output: C against the state before the chunk, decayed from
    # the chunk's start to q
    decay_in = torch.exp(cs).reshape(Bb, nc, Q, G, rep)
    y_off = torch.einsum("bcqgn,bcgrpn->bcqgrp", Cc, h_prev) * decay_in[..., None]

    y = (y_diag + y_off).reshape(Bb, nc * Q, H, P)[:, :S]
    return y.to(x.dtype), h.reshape(Bb, H, P, N)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + eˣ) as ``jax.nn.softplus`` computes it (``logaddexp(x, 0)``)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _ssm_projections(p: Mamba, x: torch.Tensor, knobs):
    """The five input projections of ``x``, each through :func:`dense`:
    ``(z, x_in, B_in, C_in, dt)`` in x's dtype."""
    return tuple(_leaf_dense(p, name, x, knobs) for name in ("w_z", "w_x", "w_B", "w_C", "w_dt"))


def _gated_out(cfg: ModelConfig, p: Mamba, y: torch.Tensor, z: torch.Tensor, knobs, tp=None):
    """``y`` (fp32, (…, d_in)) in the compute dtype, gated by SiLU(z), the
    RMSNorm in fp32, then the output projection through :func:`dense`.
    With the channels split over a mesh (``tp.ssm_in_split``) the norm's
    sum of squares is all-reduced over ``model`` (its mean is over the
    whole d_in), and so is its gradient under autograd (each rank's is its
    channels' part), and w_out is row-parallel (:func:`row_parallel_dense`);
    with them whole, a sequence-parallel training rank keeps its positions
    of w_out's product (:func:`close_whole`)."""
    y = y.to(z.dtype) * F.silu(z)
    yf = y.float()
    if tp is None or not tp.ssm_in_split:
        y = (yf * torch.rsqrt((yf * yf).mean(-1, keepdim=True) + 1e-6) * p.norm).to(z.dtype)
        if _whole_seq_split(tp):
            return close_whole(tp, _leaf_dense(p, "w_out", y, knobs, out_dtype=torch.float32),
                               z.dtype)
        return _leaf_dense(p, "w_out", y, knobs)
    ss = all_reduce((yf * yf).sum(-1, keepdim=True), tp.model_group)
    ms = grad_all_reduce(ss, tp.model_group) / (cfg.ssm.expand * cfg.d_model)
    y = (yf * torch.rsqrt(ms + 1e-6) * p.norm).to(z.dtype)
    return row_parallel_dense(p, "w_out", y, knobs, tp)


def _ssm_gathered(tp) -> bool:
    """Whether an SSM block all-gathers its conv'd channels: its channels are
    split over ``model`` and its heads are not, so each rank steps every
    head (hymba's 50 heads on 4 ranks)."""
    return tp is not None and tp.ssm_in_split and not tp.ssm_heads_split


def _own_channels(tp, y: torch.Tensor, width: int) -> torch.Tensor:
    """The rank's ``width`` channels of ``y`` (…, d_in) gathered whole."""
    return y[..., tp.r * width:(tp.r + 1) * width]


def ssm_forward(cfg: ModelConfig, p: Mamba, x: torch.Tensor, knobs, tp=None):
    """Mamba-2 block over a sequence ``x`` (B, S, d). Returns ``(y, h_final,
    raw)``: ``y`` (B, S, d) without the skip connection, the final SSM state
    (B, H, P, N) fp32, and ``raw`` the conv inputs ``{"conv_x", "conv_B",
    "conv_C"}`` (B, S, C) whose last W − 1 rows the decode cache keeps.

    Projections and the conv in the compute dtype; ``dt``, ``A``, the scan's
    state, the ``D`` skip and the gated RMSNorm in fp32, as in the JAX
    package's ``ssm_block``.

    On a mesh ``d_in`` and ``H`` are the rank's: its channels (w_z, w_x and
    the conv over them, their left padding kept) and, where the heads split
    with them, its heads (the scan per local head group); where only the
    channels split, the conv'd channels are all-gathered, the scan steps
    every head, and the rank keeps its channels for the gate, the norm and
    the row-parallel w_out (:func:`_gated_out`).
    """
    s = cfg.ssm
    cdt = x.dtype
    z, xi0, Bi0, Ci0, dt = _ssm_projections(p, x, knobs)
    xi = _causal_conv(xi0, _cast(p, "conv_x", cdt))
    Bi = _causal_conv(Bi0, _cast(p, "conv_B", cdt))
    Ci = _causal_conv(Ci0, _cast(p, "conv_C", cdt))
    gathered = _ssm_gathered(tp)
    if gathered:
        xi = all_gather(xi, tp.model_group, dim=-1)
    Bb, S, d_in = xi.shape
    H = d_in // s.head_dim  # the rank's heads where they are split (one B/C group)
    xh = xi.reshape(Bb, S, H, s.head_dim)
    dtp = _softplus(dt.float() + p.dt_bias)
    A = -torch.exp(p.A_log)
    y, h = ssd_scan(xh, dtp, A, Bi.reshape(Bb, S, s.n_groups, s.d_state),
                    Ci.reshape(Bb, S, s.n_groups, s.d_state), chunk=s.chunk)
    y = (y + xh.float() * p.D[None, None, :, None]).reshape(Bb, S, d_in)
    if gathered:
        y = _own_channels(tp, y, z.shape[-1])
    return (_gated_out(cfg, p, y, z, knobs, tp), h,
            {"conv_x": xi0, "conv_B": Bi0, "conv_C": Ci0})


def ssm_block(cfg: ModelConfig, p: Mamba, x: torch.Tensor, knobs) -> torch.Tensor:
    """Mamba-2 block forward over a sequence (prefill): (B, S, d) → (B, S, d),
    without the skip connection."""
    return ssm_forward(cfg, p, x, knobs)[0]


def ssm_decode_block(
    cfg: ModelConfig,
    p: Mamba,
    x: torch.Tensor,  # (B, 1, d)
    cache: dict,  # {"h": (B, H, P, N) fp32, "conv_x": (B, W-1, d_in), "conv_B", "conv_C"}
    knobs,
    tp=None,
) -> tuple[torch.Tensor, dict]:
    """One decode token per slot: the conv over the cached last W − 1 inputs
    and the new one, then one step of the state recurrence ``h ← h ·
    exp(dt·A) + dt·x ⊗ B`` and ``y = h·C + D·x``.  The cache entries are
    updated in place (the port's caches are mutable).  Returns ``(y,
    cache)``, y (B, 1, d) without the skip connection.  Unlike attention the
    state carries time: no position is needed.  On a mesh the rank's
    channels and heads, as :func:`ssm_forward` splits them (the cache's conv
    tail holds the rank's channels, its state the heads it steps)."""
    s = cfg.ssm
    cdt = x.dtype
    Bb = x.shape[0]
    z, xi, Bi, Ci, dt = (t[:, 0] for t in _ssm_projections(p, x, knobs))

    def conv_step(name: str, new: torch.Tensor) -> torch.Tensor:
        window = torch.cat([cache[name], new[:, None]], dim=1)  # (B, W, C)
        cache[name].copy_(window[:, 1:])
        return F.silu((window * _cast(p, name, cdt)[None]).sum(1))

    xc = conv_step("conv_x", xi)
    gathered = _ssm_gathered(tp)
    if gathered:
        xc = all_gather(xc, tp.model_group, dim=-1)
    d_in = xc.shape[-1]
    H = d_in // s.head_dim
    xh = xc.reshape(Bb, H, s.head_dim).float()
    rep = H // s.n_groups
    Bh = conv_step("conv_B", Bi).reshape(Bb, s.n_groups, s.d_state).float()
    Ch = conv_step("conv_C", Ci).reshape(Bb, s.n_groups, s.d_state).float()
    Bh, Ch = Bh.repeat_interleave(rep, dim=1), Ch.repeat_interleave(rep, dim=1)  # (B, H, N)
    dtp = _softplus(dt.float() + p.dt_bias)  # (B, H)
    dA = torch.exp(dtp * -torch.exp(p.A_log))
    h = cache["h"] * dA[..., None, None] + torch.einsum("bhp,bhn->bhpn", xh * dtp[..., None], Bh)
    cache["h"].copy_(h)
    y = (torch.einsum("bhpn,bhn->bhp", h, Ch) + xh * p.D[None, :, None]).reshape(Bb, d_in)
    if gathered:
        y = _own_channels(tp, y, z.shape[-1])
    return _gated_out(cfg, p, y, z, knobs, tp)[:, None], cache
