"""Layers of the decoder (GQA or multi-head latent attention, a gated MLP
or routed experts, Mamba-2 SSD blocks), in PyTorch.

The port of the dense, MoE and SSM subset of ``repro.models.layers``.
Conventions, as in the JAX package:

* activations ``(batch, seq, d_model)`` in the compute dtype (the config's);
* softmax and normalisation statistics in fp32;
* attention weights keep heads explicit: ``wq`` ``(d, H, hd)``, ``wk``/``wv``
  ``(d, KH, hd)``, ``wo`` ``(H, hd, d)``;
* prefill attention goes through :func:`flash_attention` (blocked online
  softmax, plain PyTorch: the JAX package's is XLA code, not a kernel), a
  single decode row through :func:`decode_attention` or, with
  ``knobs.attn == "pallas_fused"``, the decode-attention kernel that applies
  the paired out-projection in its flush (``kernels.ops.attn_decode``);
* MLA (DeepSeek-V2) caches a compressed latent ``(c_kv, k_rope)`` and decodes
  in the latent space (:func:`mla_decode_block`, einsums as in the JAX
  package, no kernel); its down- and out-projections are paired GEMMs;
* MoE layers route each token to its top-k experts; every expert's GEMM of
  one projection runs as one paired launch over the expert grid
  (``kernels.ops.expert_dense``); shared experts run beside them as a gated
  MLP;
* a Mamba-2 block (:class:`Mamba`) projects through :func:`dense` (six
  paired GEMMs), runs a depthwise causal conv and the chunked SSD scan
  (:func:`ssd_scan`) over a prompt, or one step of the state recurrence
  (:func:`ssm_decode_block`) per decode token: plain PyTorch, as the JAX
  package's are XLA code, not kernels.

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
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import decode_mask

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
        self.frozen = False
        self._derived: dict[Any, Any] = {}

    def copy(self, *, frozen: bool, pairing: dict | None = None,
             children: dict | None = None) -> Block:
        """A block sharing these weights (not copied), with ``pairing`` (or
        this block's) and an empty cache; its child blocks are copied the
        same way, ``children`` mapping a dotted sub-path below this block
        (``"shared"``) to that block's new pairing dict."""
        children = children or {}
        kids = {n: c.copy(frozen=frozen, pairing=children.get(n), children=_below(children, n))
                for n, c in self.named_children()}
        new = type(self)(pairing=self.pairing if pairing is None else pairing,
                         **dict(self.named_parameters(recurse=False)), **kids)
        new.frozen = frozen
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
    """RMSNorm scale ``(d,)``."""

    REQUIRED = ("scale",)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_norm(x, self.scale)


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

    then, with a feed-forward block ``ffn`` (a gated ``mlp`` or a ``moe``),
    ``h + ffn(ln2(h))``; an SSM layer has none."""

    def __init__(self, ln1: Norm, attn: Attention | MLA | None = None, ln2: Norm | None = None,
                 mlp: MLP | None = None, *, moe: MoE | None = None, mamba: Mamba | None = None,
                 ln_attn_out: Norm | None = None, ln_ssm_out: Norm | None = None):
        super().__init__()
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
                      ln_ssm_out=ln_ssm_out, ln2=ln2, mlp=mlp, moe=moe)
        for name, block in blocks.items():
            if block is not None:
                setattr(self, name, block)

    def copy(self, *, frozen: bool, pairing: dict | None = None) -> DecoderLayer:
        """A layer sharing these weights; ``pairing`` maps a sub-block's
        dotted path (``"attn"``, ``"mamba"``, ``"mlp"``, ``"moe"``,
        ``"moe.shared"``) to that block's new pairing dict."""
        pairing = pairing or {}
        return DecoderLayer(**{n: b.copy(frozen=frozen, pairing=pairing.get(n),
                                         children=_below(pairing, n))
                               for n, b in self.named_children()})


# ---------------------------------------------------------------------------
# norms / rope / activations
# ---------------------------------------------------------------------------


def apply_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis, statistics in fp32."""
    xf = x.float()
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
    activation.
    """
    if pairing is not None and knobs.gemm == "pallas_paired":
        if segments is None:
            return ops.fused_paired_dense(x, w, pairing, bias, activation=act or "none",
                                          residual=residual, pair_block_n=knobs.pair_block_n)
        return ops.paired_dense(x, segments, bias, activation=act or "none", residual=residual)
    if knobs.gemm == "pallas":
        y = ops.fused_dense(x, w, bias, activation=act or "none")
        return y if residual is None else y + residual.to(y.dtype)
    y = torch.matmul(x, w)
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


def _leaf_dense(p: Block, name: str, x: torch.Tensor, knobs, *, act=None, residual=None):
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
                     segments=seg)
    w = p.derived(("matrix", name, cdt), lambda: p.matrix(name, cdt))
    return dense(x, w, act=act, pairing=meta, residual=residual, knobs=knobs)


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
                  residual: torch.Tensor | None = None) -> torch.Tensor:
    """Attention output projection through :func:`dense`, flattened-head
    view; ``residual`` (the sublayer's skip connection) fuses into the
    paired kernel's epilogue."""
    o2 = out.reshape(*out.shape[:-2], -1)
    return _leaf_dense(p, "wo", o2, knobs, residual=residual)


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
):
    """Full attention sublayer (projections + flash attention + out
    projection).  Returns ``(y, k, v)``: the post-rope K/V fill the cache."""
    q, k, v = _qkv(cfg, p, x, positions, knobs)
    out = flash_attention(q, k, v, causal=causal, window=window, n_sink=n_sink,
                          q_chunk=knobs.q_chunk, k_chunk=knobs.k_chunk)
    return attn_out_proj(p, out, knobs, residual=residual), k, v


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
) -> tuple[torch.Tensor, dict]:
    """One decode token: QKV, cache write at ``pos`` (in place: the port's
    caches are mutable, unlike the JAX package's), attention and the
    out-projection with ``residual`` fused.

    With ``knobs.attn == "pallas_fused"`` the attention and out-projection
    run as one decode-attention launch, and under paired GEMMs with blocked
    metadata the QKV projections as one paired launch.
    """
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
    seg = p.derived(("attn_out", cdt, meta is not None), lambda: ops.attn_outproj_segments(
        p.matrix("wo", cdt), meta, knobs.pair_block_n if paired else 0))
    y = ops.attn_decode(q, k_cache, v_cache, pos, seg, residual=residual,
                        window=window, n_sink=n_sink)
    return y, cache


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
    q = _leaf_dense(p, "wq", x, knobs).reshape(*x.shape[:-1], cfg.n_heads,
                                               m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = torch.split(q, [m.qk_nope_dim, m.qk_rope_dim], dim=-1)
    return q_nope, rope(q_rope, positions, cfg.rope_theta)


def _mla_up(p: MLA, cdt: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """The latent up-projections ``w_uk``, ``w_uv`` in the compute dtype."""
    return _cast(p, "w_uk", cdt), _cast(p, "w_uv", cdt)


def mla_block(cfg: ModelConfig, p: MLA, x: torch.Tensor, positions: torch.Tensor, knobs):
    """Prefill MLA: per-head K/V materialised from the latent, then
    :func:`flash_attention` (``v`` padded to the q/k head width, as in the
    JAX package) and the out-projection.  Returns ``(y, c_kv, k_rope)``:
    ``y`` (B, S, d) without the skip connection (the JAX package adds it
    after), and the latent cache entries of :func:`_mla_latent`.

    The down-projections ``wq``/``w_dkv``/``w_kr`` and ``wo`` go through
    :func:`dense` (paired launches when they carry metadata); the
    up-projections ``w_uk``/``w_uv`` stay einsums.
    """
    m, H = cfg.mla, cfg.n_heads
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
    y = _leaf_dense(p, "wo", out.reshape(*out.shape[:-2], H * m.v_head_dim), knobs)
    return y, c_kv, k_rope


def mla_decode_block(
    cfg: ModelConfig,
    p: MLA,
    x: torch.Tensor,  # (B, 1, d)
    cache: dict,  # {"c_kv": (B, S, R), "k_rope": (B, S, rope)}, updated in place
    pos: torch.Tensor,  # (B,)
    knobs,
) -> tuple[torch.Tensor, dict]:
    """Absorbed-matrix MLA decode: the new latent and rope key written into
    the cache at ``pos`` (in place), then attention in the latent space,
    ``w_uk`` folded into the query and ``w_uv`` into the output.  Returns
    ``(y, cache)``, ``y`` (B, 1, d) without the skip connection.

    The JAX package's rounding points: ``q_lat`` and the ``w_uv`` product in
    the compute dtype; both scores and ``o_lat`` accumulated in fp32 (the
    operands cast up, as ``preferred_element_type=float32``); the
    probabilities cast to the compute dtype before ``o_lat``.
    """
    m, H = cfg.mla, cfg.n_heads
    cdt, B = x.dtype, x.shape[0]
    q_nope, q_rope = _mla_query(cfg, p, x, pos[:, None], knobs)
    c_new, kr_new = _mla_latent(cfg, p, x, pos[:, None], knobs)
    bidx = torch.arange(B, device=x.device)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    c_kv[bidx, pos] = c_new[:, 0].to(c_kv.dtype)
    k_rope[bidx, pos] = kr_new[:, 0].to(k_rope.dtype)

    w_uk, w_uv = _mla_up(p, cdt)
    q_lat = torch.einsum("bhk,rhk->bhr", q_nope[:, 0], w_uk)
    ckv = c_kv.float()
    s = torch.einsum("bhr,bsr->bhs", q_lat.float(), ckv)
    s = s + torch.einsum("bhk,bsk->bhs", q_rope[:, 0].float(), k_rope.float())
    s = s / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    ok = torch.arange(c_kv.shape[1], device=x.device)[None, :] <= pos[:, None]
    pr = torch.softmax(s.masked_fill(~ok[:, None], -math.inf), dim=-1)
    o_lat = torch.einsum("bhs,bsr->bhr", pr.to(cdt).float(), ckv).to(cdt)
    out = torch.einsum("bhr,rhk->bhk", o_lat, w_uv)
    y = _leaf_dense(p, "wo", out.reshape(B, H * m.v_head_dim), knobs)
    return y[:, None], cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_block(cfg: ModelConfig, p: MLP, x: torch.Tensor, knobs,
              residual: torch.Tensor | None = None) -> torch.Tensor:
    """Gated MLP; ``residual`` fuses the sublayer skip connection into the
    down-projection (the paired kernel's epilogue, or a plain add)."""
    g = _leaf_dense(p, "w_gate", x, knobs, act=cfg.act)
    u = _leaf_dense(p, "w_up", x, knobs)
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
    table[bidx.expand_as(tok)[real], tok[real], rank[real]] = order[real]
    contrib = yb.reshape(B, EC, d) * inv_w[..., None].to(cdt)
    contrib = torch.cat([contrib, contrib.new_zeros((B, 1, d))], dim=1)  # slot EC: zeros
    y = torch.zeros((B, S, d), dtype=cdt, device=dev)
    for k in range(top_k):
        y = y + contrib[bidx, table[:, :S, k]]
    return y


def _expert_dense(p: MoE, name: str, x: torch.Tensor, knobs, *, act=None,
                  per_expert: bool = False) -> torch.Tensor:
    """Every expert's GEMM against weight ``name`` of ``p`` as one paired
    launch over the expert grid → (M, E, F); the segments kept on a frozen
    block."""
    cdt = x.dtype
    if torch.is_grad_enabled() and getattr(p, name).requires_grad:
        raise NotImplementedError(
            "the paired expert grid is forward only: its backward (the JAX package's "
            "_fused_paired_expert_dense_grad) is not ported; train MoE models under "
            "gemm='xla' or 'pallas'")
    seg = p.derived(("paired", name, cdt), lambda: ops.lm_expert_segments(
        getattr(p, name).to(cdt), p.pairing[name], knobs.pair_block_n))
    return ops.expert_dense(x, seg, activation=act or "none", x_per_expert=per_expert)


def moe_block(cfg: ModelConfig, p: MoE, x: torch.Tensor, knobs
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Routed experts over ``x`` (B, S, d). Returns ``(y, aux)``: the
    experts' gated sum (B, S, d) in x's dtype, without the skip connection,
    and the Switch load-balance loss (fp32 scalar; 0 on the dense branch).

    The router runs in fp32: softmax gates, top-k, renormalised.  Two
    branches, as in the JAX package (whose shard_map branch waits for tensor
    parallelism):

    * **dense** (``T·K ≤ 2E``, decode and short prompts): every expert runs
      on every token, no capacity and no drops;
    * **routed**: per-sequence capacity ``C``, sort-based dispatch into
      (B, E, C, d) buffers, each expert's rows through its own weights,
      then the gated combine.  Choices past capacity are dropped.

    Shared experts (``p.shared``) run on every token on both branches, their
    three projections through :func:`dense`, and add to the routed sum, as
    in the JAX package.

    Under ``knobs.gemm == "pallas_paired"`` with expert pairing metadata,
    each projection of all experts is one paired launch
    (:func:`_expert_dense`); otherwise ``torch.einsum`` as the JAX package's
    ``jnp.einsum``.
    """
    mo = cfg.moe
    B, S, d = x.shape
    T, E, K = B * S, mo.n_experts, mo.top_k
    cdt = x.dtype
    paired = knobs.gemm == "pallas_paired" and "w_gate" in p.pairing

    shared = getattr(p, "shared", None)

    def shared_experts(x2):
        """The shared experts' gated MLP over (T, d) rows, no skip connection."""
        g = _leaf_dense(shared, "w_gate", x2, knobs, act=cfg.act)
        return _leaf_dense(shared, "w_down", g * _leaf_dense(shared, "w_up", x2, knobs), knobs)

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
    gates = torch.softmax(logits, dim=-1)  # (T, E)
    topw, topi = _top_k(gates, K)
    topw = topw / topw.sum(-1, keepdim=True).clamp_min(1e-9)

    if T * K <= 2 * E:
        y_all = experts(x2, per_expert=False)  # (T, E, d)
        w_full = torch.zeros((T, E), dtype=cdt, device=x.device).scatter_(1, topi, topw.to(cdt))
        y2 = torch.einsum("ted,te->td", y_all, w_full)
        if shared is not None:
            y2 = y2 + shared_experts(x2)
        return y2.reshape(B, S, d), torch.zeros((), dtype=torch.float32, device=x.device)

    xb, inv_tok, inv_w, counts, C = _moe_route(cfg, x, topi, topw)
    # experts as the grid's blocks: the (B, C) token rows of each expert's
    # buffer are that expert's rows of the GEMM
    yb = experts(xb.permute(1, 0, 2, 3).reshape(E, B * C, d), per_expert=True)
    yb = yb.reshape(B, C, E, d).permute(0, 2, 1, 3)
    y2 = _moe_combine(B, S, d, yb, inv_tok, inv_w, cdt, K)
    if shared is not None:
        y2 = y2 + shared_experts(x2).reshape(B, S, d)

    me = gates.mean(0)  # mean router probability of each expert
    ce = counts.sum(0).float() / max(T * K, 1)  # share of the choices it got
    aux = (me * ce).sum() * (E * mo.router_aux_weight)
    return y2, aux


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
    """
    Q = dA_chunk.shape[-1]
    cs = torch.cumsum(dA_chunk, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]  # sum over (t, q]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=dA_chunk.device).tril()
    return torch.where(mask, torch.exp(diff), torch.zeros((), device=diff.device))


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


def _gated_out(cfg: ModelConfig, p: Mamba, y: torch.Tensor, z: torch.Tensor, knobs):
    """``y`` (fp32, (…, d_in)) in the compute dtype, gated by SiLU(z), the
    RMSNorm in fp32, then the output projection through :func:`dense`."""
    y = y.to(z.dtype) * F.silu(z)
    yf = y.float()
    y = (yf * torch.rsqrt((yf * yf).mean(-1, keepdim=True) + 1e-6) * p.norm).to(z.dtype)
    return _leaf_dense(p, "w_out", y, knobs)


def ssm_forward(cfg: ModelConfig, p: Mamba, x: torch.Tensor, knobs):
    """Mamba-2 block over a sequence ``x`` (B, S, d). Returns ``(y, h_final,
    raw)``: ``y`` (B, S, d) without the skip connection, the final SSM state
    (B, H, P, N) fp32, and ``raw`` the conv inputs ``{"conv_x", "conv_B",
    "conv_C"}`` (B, S, C) whose last W − 1 rows the decode cache keeps.

    Projections and the conv in the compute dtype; ``dt``, ``A``, the scan's
    state, the ``D`` skip and the gated RMSNorm in fp32, as in the JAX
    package's ``ssm_block``.
    """
    s = cfg.ssm
    cdt = x.dtype
    d_in = s.expand * cfg.d_model
    H = d_in // s.head_dim
    z, xi0, Bi0, Ci0, dt = _ssm_projections(p, x, knobs)
    xi = _causal_conv(xi0, _cast(p, "conv_x", cdt))
    Bi = _causal_conv(Bi0, _cast(p, "conv_B", cdt))
    Ci = _causal_conv(Ci0, _cast(p, "conv_C", cdt))
    Bb, S = x.shape[:2]
    xh = xi.reshape(Bb, S, H, s.head_dim)
    dtp = _softplus(dt.float() + p.dt_bias)
    A = -torch.exp(p.A_log)
    y, h = ssd_scan(xh, dtp, A, Bi.reshape(Bb, S, s.n_groups, s.d_state),
                    Ci.reshape(Bb, S, s.n_groups, s.d_state), chunk=s.chunk)
    y = (y + xh.float() * p.D[None, None, :, None]).reshape(Bb, S, d_in)
    return _gated_out(cfg, p, y, z, knobs), h, {"conv_x": xi0, "conv_B": Bi0, "conv_C": Ci0}


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
) -> tuple[torch.Tensor, dict]:
    """One decode token per slot: the conv over the cached last W − 1 inputs
    and the new one, then one step of the state recurrence ``h ← h ·
    exp(dt·A) + dt·x ⊗ B`` and ``y = h·C + D·x``.  The cache entries are
    updated in place (the port's caches are mutable).  Returns ``(y,
    cache)``, y (B, 1, d) without the skip connection.  Unlike attention the
    state carries time: no position is needed."""
    s = cfg.ssm
    cdt = x.dtype
    d_in = s.expand * cfg.d_model
    H = d_in // s.head_dim
    Bb = x.shape[0]
    z, xi, Bi, Ci, dt = (t[:, 0] for t in _ssm_projections(p, x, knobs))

    def conv_step(name: str, new: torch.Tensor) -> torch.Tensor:
        window = torch.cat([cache[name], new[:, None]], dim=1)  # (B, W, C)
        cache[name].copy_(window[:, 1:])
        return F.silu((window * _cast(p, name, cdt)[None]).sum(1))

    xh = conv_step("conv_x", xi).reshape(Bb, H, s.head_dim).float()
    rep = H // s.n_groups
    Bh = conv_step("conv_B", Bi).reshape(Bb, s.n_groups, s.d_state).float()
    Ch = conv_step("conv_C", Ci).reshape(Bb, s.n_groups, s.d_state).float()
    Bh, Ch = Bh.repeat_interleave(rep, dim=1), Ch.repeat_interleave(rep, dim=1)  # (B, H, N)
    dtp = _softplus(dt.float() + p.dt_bias)  # (B, H)
    dA = torch.exp(dtp * -torch.exp(p.A_log))
    h = cache["h"] * dA[..., None, None] + torch.einsum("bhp,bhn->bhpn", xh * dtp[..., None], Bh)
    cache["h"].copy_(h)
    y = torch.einsum("bhpn,bhn->bhp", h, Ch) + xh * p.D[None, :, None]
    return _gated_out(cfg, p, y.reshape(Bb, d_in), z, knobs)[:, None], cache
