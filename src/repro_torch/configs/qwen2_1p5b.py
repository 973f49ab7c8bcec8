"""qwen2-1.5b — dense, GQA (kv=2), QKV bias. [arXiv:2407.10671; hf]"""
from repro_torch.configs.base import ModelConfig, default_paired_leaves


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b",
        family="dense",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        d_ff=8960,
        vocab=151936,
        qkv_bias=True,
        rope_theta=1e6,
        tie_embeddings=True,  # Qwen2-1.5B ties embeddings
        paired_leaves=default_paired_leaves(),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        qkv_bias=True,
        tie_embeddings=True,
        paired_leaves=default_paired_leaves(),
    )
