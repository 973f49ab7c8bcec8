"""ModelConfig of the port: ``repro.configs.base`` for the dense, MoE, SSM,
hybrid, encoder-decoder and vision-language families, with GQA or
multi-head latent attention (MLA).

The decoder stack is described by *segments*, maximal runs of identical
layers, as in the JAX package; the port keeps one module per layer, and the
segments only decide how pairing metadata is padded (segment-wide
``(Pmax, Rmax)``, ``core.transform.pair_params``).  MoE runs routed experts,
shared experts beside them and dense leading layers.  SSM layers are Mamba-2
(SSD) blocks; a hybrid layer (hymba) runs attention and an SSM block side by
side on the same input, with meta tokens prepended to every prompt and a
sliding window on all but its ``full_attn_layers``.  An encoder-decoder
model (whisper) runs an audio encoder (:class:`EncoderConfig`) over
precomputed frame embeddings, and each decoder layer cross-attends its
output; a vision-language model (internvl2) takes precomputed patch
embeddings, projected by ``vision_proj``, at its first ``vision_prefix``
positions.  ``norm`` is RMSNorm or LayerNorm (with a bias).
:data:`SHAPES` holds the four input shapes every arch is dry-run at
(:class:`ShapeConfig`), and :func:`supports_shape` the skips.
"""
from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class MlaConfig:
    """DeepSeek-V2 multi-head latent attention (the JAX package's fields and
    defaults)."""

    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    """Top-k routed experts with per-sequence capacity (the JAX package's
    fields and defaults)."""

    n_experts: int = 64
    top_k: int = 6
    d_ff_expert: int = 1408
    n_shared: int = 2
    first_k_dense: int = 0  # leading layers with a dense FFN instead of MoE
    d_ff_dense: int = 0  # d_ff of those dense layers
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SsmConfig:
    """Mamba-2 (SSD) block geometry (the JAX package's fields and defaults)."""

    d_state: int = 128
    head_dim: int = 64
    expand: int = 2  # d_inner = expand * d_model
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 256  # SSD chunk length
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style audio encoder (the JAX package's fields and defaults):
    its inputs are precomputed frame embeddings (B, frames, d_model), the
    conv front end a stub."""

    n_layers: int = 6
    frames: int = 1500


FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0  # 0 → d_model // n_heads

    # attention flavour
    qkv_bias: bool = False
    qk_norm: bool = False
    sliding_window: int = 0  # 0 → full attention
    full_attn_layers: tuple[int, ...] = ()  # hybrid: layers using full attn
    rope_theta: float = 10000.0

    mla: MlaConfig | None = None
    moe: MoeConfig | None = None
    ssm: SsmConfig | None = None
    encoder: EncoderConfig | None = None

    # hybrid (hymba): every layer runs attention ∥ SSM heads in parallel;
    # ``meta_tokens`` learned rows precede every prompt (and are the sinks
    # of the sliding window)
    meta_tokens: int = 0

    # vlm (internvl2): the first ``vision_prefix`` positions take precomputed
    # patch embeddings of ``vision_embed_dim`` (a stub front end) through
    # ``vision_proj`` instead of token embeddings
    vision_prefix: int = 0
    vision_embed_dim: int = 1024

    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    act: Literal["silu", "gelu"] = "silu"
    tie_embeddings: bool = True
    dtype: str = "bfloat16"

    # Pairing-eligible weight leaves as (sub-path, weight-name) pairs, the
    # spec list core.transform.pair_params(..., leaves=...) consumes; ()
    # means the model-agnostic default.
    paired_leaves: tuple[tuple[str, str], ...] = ()

    def __post_init__(self):
        if self.norm not in ("rmsnorm", "layernorm"):
            raise ValueError(f"unknown norm {self.norm!r}")
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if (self.family == "encdec") != (self.encoder is not None):
            raise ValueError(f"family={self.family!r} with encoder={self.encoder!r}")
        if (self.family == "vlm") != (self.vision_prefix > 0):
            raise ValueError(f"family={self.family!r} with vision_prefix={self.vision_prefix}")
        if (self.family == "moe") != (self.moe is not None):
            raise ValueError(f"family={self.family!r} with moe={self.moe!r}")
        if (self.family in ("ssm", "hybrid")) != (self.ssm is not None):
            raise ValueError(f"family={self.family!r} with ssm={self.ssm!r}")

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def attention_kind(self) -> str:
        if self.family == "ssm":
            return "none"
        if self.mla is not None:
            return "mla"
        return "gqa"

    def layer_kind(self, i: int) -> str:
        """Kind string for decoder layer i: ``"ssm"`` in an SSM model,
        ``"hybrid_full"`` (one of ``full_attn_layers``) or ``"hybrid_swa"``
        in a hybrid one, ``"moe"`` in an MoE model past its
        ``first_k_dense`` leading dense layers, ``"encdec"`` (self- and
        cross-attention) in an encoder-decoder one, else ``"dense"``.  (The
        JAX package's ``layer_kind`` says ``"dense"`` for an encoder-decoder
        layer and its ``models.lm.segment_kinds`` ``"encdec"``: the port
        keeps the second.)"""
        if self.family == "encdec":
            return "encdec"
        if self.family == "ssm":
            return "ssm"
        if self.family == "hybrid":
            return "hybrid_full" if i in self.full_attn_layers else "hybrid_swa"
        if self.moe is not None and i >= self.moe.first_k_dense:
            return "moe"
        return "dense"

    def segments(self) -> tuple[tuple[str, int], ...]:
        """Maximal runs of identical layer kinds."""
        segs: list[tuple[str, int]] = []
        for i in range(self.n_layers):
            kind = self.layer_kind(i)
            if segs and segs[-1][0] == kind:
                segs[-1] = (kind, segs[-1][1] + 1)
            else:
                segs.append((kind, 1))
        return tuple(segs)

    def param_count(self, active_only: bool = False) -> int:
        """Parameter count, embeddings included once (norms, biases, the SSM
        blocks' convs and per-head vectors and the meta tokens not counted,
        as in the JAX package); ``active_only`` counts the top-k and shared
        experts a token runs instead of all of them."""
        d, ff, V, hd, H = self.d_model, self.d_ff, self.vocab, self.head_dim, self.n_heads
        n = V * d if self.tie_embeddings else 2 * V * d  # embedding, and the head
        ssm = 0
        if self.ssm is not None:
            s = self.ssm
            d_in = s.expand * d
            # w_z, w_x, w_B, w_C, w_dt, then w_out
            ssm = d * (2 * d_in + 2 * s.n_groups * s.d_state + d_in // s.head_dim) + d_in * d
        if self.family == "ssm":
            return n + self.n_layers * ssm
        if self.mla is not None:
            m = self.mla
            att = (d * H * (m.qk_nope_dim + m.qk_rope_dim)  # wq
                   + d * (m.kv_lora_rank + m.qk_rope_dim)  # w_dkv, w_kr
                   + m.kv_lora_rank * H * (m.qk_nope_dim + m.v_head_dim)  # w_uk, w_uv
                   + H * m.v_head_dim * d)  # wo
        else:
            att = d * H * hd + 2 * d * self.n_kv_heads * hd + H * hd * d
        for i in range(self.n_layers):
            if self.layer_kind(i) == "moe":
                mo = self.moe
                per_expert = 3 * d * mo.d_ff_expert
                experts = (mo.top_k if active_only else mo.n_experts) + mo.n_shared
                n += att + experts * per_expert + d * mo.n_experts
            else:
                n += att + 3 * d * (self.moe.d_ff_dense if self.moe is not None else ff) + ssm
        return n


def default_paired_leaves(
    *, attn: bool = True, mla: bool = False, mlp: bool = True, moe: bool = False,
    moe_shared: bool = False, ssm: bool = False, xattn: bool = False,
) -> tuple[tuple[str, str], ...]:
    """The pairing-eligible leaf specs of a decoder (or encoder) layer, by
    block type: ``(sub-path, weight-name)`` into a layer, a dotted sub-path
    (``"moe.shared"``) naming a nested block.  The router, MLA's latent
    up-projections ``w_uk``/``w_uv`` (einsums, never a plain GEMM) and the
    SSM block's depthwise convs are not eligible; ``xattn`` declares the
    cross-attention's ``wq``/``wo`` (its ``wk``/``wv`` run once over the
    encoder output at prefill, plain products)."""
    leaves: list[tuple[str, str]] = []
    if mla:
        leaves += [("attn", "wq"), ("attn", "w_dkv"), ("attn", "w_kr"), ("attn", "wo")]
    elif attn:
        leaves += [("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo")]
    if xattn:
        leaves += [("xattn", "wq"), ("xattn", "wo")]
    if mlp:
        leaves += [("mlp", "w_gate"), ("mlp", "w_up"), ("mlp", "w_down")]
    if moe:
        leaves += [("moe", "w_gate"), ("moe", "w_up"), ("moe", "w_down")]
    if moe_shared:
        leaves += [("moe.shared", "w_gate"), ("moe.shared", "w_up"), ("moe.shared", "w_down")]
    if ssm:
        leaves += [("mamba", n) for n in ("w_z", "w_x", "w_B", "w_C", "w_dt", "w_out")]
    return tuple(leaves)


# The four assigned input shapes (identical for every LM-family arch), as the
# JAX package names them; the dry run (``launch.dryrun``) runs each against
# every arch.
@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def supports_shape(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """The mandated skips: long_500k needs sub-quadratic attention."""
    if shape.name == "long_500k":
        if cfg.family == "ssm":
            return True, "ssm: O(1) state decode"
        if cfg.family == "hybrid":
            return True, "hybrid: sliding-window attn + ssm state"
        return (
            False,
            "full quadratic attention at 524k context — skipped per task spec "
            "(noted in DESIGN.md)",
        )
    return True, ""
