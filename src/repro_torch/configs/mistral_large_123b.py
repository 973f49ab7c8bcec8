"""mistral-large-123b — dense, GQA (kv=8).
[hf:mistralai/Mistral-Large-Instruct-2407; unverified]"""
from repro_torch.configs.base import ModelConfig, default_paired_leaves


def config() -> ModelConfig:
    return ModelConfig(
        name="mistral-large-123b",
        family="dense",
        n_layers=88,
        d_model=12288,
        n_heads=96,
        n_kv_heads=8,
        d_ff=28672,
        vocab=32768,
        d_head=128,
        rope_theta=1e6,
        tie_embeddings=False,  # the JAX package's default: an lm_head of its own
        paired_leaves=default_paired_leaves(),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mistral-large-smoke",
        family="dense",
        n_layers=2,
        d_model=96,
        n_heads=6,
        n_kv_heads=2,
        d_ff=192,
        vocab=256,
        d_head=16,
        tie_embeddings=False,
        paired_leaves=default_paired_leaves(),
    )
