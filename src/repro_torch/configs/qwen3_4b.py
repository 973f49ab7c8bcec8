"""qwen3-4b — dense, GQA (kv=8), per-head QK-norm. [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs.base import ModelConfig, default_paired_leaves


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b",
        family="dense",
        n_layers=36,
        d_model=2560,
        n_heads=32,
        n_kv_heads=8,
        d_ff=9728,
        vocab=151936,
        d_head=128,
        qk_norm=True,
        rope_theta=1e6,
        tie_embeddings=True,
        paired_leaves=default_paired_leaves(),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        d_head=16,
        qk_norm=True,
        tie_embeddings=True,
        paired_leaves=default_paired_leaves(),
    )
