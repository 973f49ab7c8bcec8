"""whisper-base — encoder-decoder, 6L each, d=512, 8H MHA, GELU+LayerNorm.
Conv frontend is a STUB: the inputs are precomputed frame embeddings
(``launch.inputs.make_batch`` supplies seeded stubs).
[arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import EncoderConfig, ModelConfig, default_paired_leaves


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base",
        family="encdec",
        n_layers=6,  # decoder layers
        d_model=512,
        n_heads=8,
        n_kv_heads=8,
        d_ff=2048,
        vocab=51865,
        encoder=EncoderConfig(n_layers=6, frames=1500),
        norm="layernorm",
        act="gelu",
        rope_theta=0.0,  # whisper uses absolute (sinusoidal) positions, no rope
        tie_embeddings=True,
        paired_leaves=default_paired_leaves(xattn=True),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke",
        family="encdec",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=256,
        encoder=EncoderConfig(n_layers=2, frames=30),
        norm="layernorm",
        act="gelu",
        rope_theta=0.0,
        tie_embeddings=True,
        paired_leaves=default_paired_leaves(xattn=True),
    )
