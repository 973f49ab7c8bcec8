"""granite-3-2b — dense, GQA (kv=8). [hf:ibm-granite/granite-3.0-2b-base; hf]"""
from repro_torch.configs.base import ModelConfig, default_paired_leaves


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-2b",
        family="dense",
        n_layers=40,
        d_model=2048,
        n_heads=32,
        n_kv_heads=8,
        d_ff=8192,
        vocab=49155,
        rope_theta=1e4,
        tie_embeddings=True,
        paired_leaves=default_paired_leaves(),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        tie_embeddings=True,
        paired_leaves=default_paired_leaves(),
    )
