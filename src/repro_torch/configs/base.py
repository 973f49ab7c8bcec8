"""ModelConfig of the port: the dense / GQA subset of ``repro.configs.base``.

The decoder stack is described by *segments*, maximal runs of identical
layers, as in the JAX package; the port keeps one module per layer, and the
segments only decide how pairing metadata is padded (segment-wide
``(Pmax, Rmax)``, ``core.transform.pair_params``).  MoE, MLA, SSM, hybrid,
encoder-decoder and vision fields are not ported yet, nor layernorm or an
untied head: a config asking for them raises.
"""
from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense"]
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
    rope_theta: float = 10000.0

    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    act: Literal["silu", "gelu"] = "silu"
    tie_embeddings: bool = True
    dtype: str = "bfloat16"

    # Pairing-eligible weight leaves as (sub-path, weight-name) pairs, the
    # spec list core.transform.pair_params(..., leaves=...) consumes; ()
    # means the model-agnostic default.
    paired_leaves: tuple[tuple[str, str], ...] = ()

    def __post_init__(self):
        ported = {"family": "dense", "norm": "rmsnorm", "tie_embeddings": True}
        for name, value in ported.items():
            if getattr(self, name) != value:
                raise NotImplementedError(f"{name}={getattr(self, name)!r} is not ported yet")

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // self.n_heads if self.n_heads else 0

    def layer_kind(self, i: int) -> str:
        """Kind string for decoder layer i (every ported layer is dense)."""
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

    def param_count(self) -> int:
        """Parameter count, embeddings included once (norms and biases not
        counted, as in the JAX package)."""
        d, ff, V, hd = self.d_model, self.d_ff, self.vocab, self.head_dim
        n = V * d  # tied: one embedding serves as the head
        att = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        return n + self.n_layers * (att + 3 * d * ff)


def default_paired_leaves(
    *, attn: bool = True, mlp: bool = True
) -> tuple[tuple[str, str], ...]:
    """The pairing-eligible leaf specs of a dense layer, by block type:
    ``(sub-path, weight-name)`` into a decoder layer."""
    leaves: list[tuple[str, str]] = []
    if attn:
        leaves += [("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo")]
    if mlp:
        leaves += [("mlp", "w_gate"), ("mlp", "w_up"), ("mlp", "w_down")]
    return tuple(leaves)
