"""olmoe-1b-7b — MoE: 16L d=2048 16H (MHA kv=16), 64 experts top-8,
expert d_ff=1024. [arXiv:2409.02060; hf]"""
from repro_torch.configs.base import ModelConfig, MoeConfig, default_paired_leaves


def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b",
        family="moe",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1024,
        vocab=50304,
        qk_norm=True,  # OLMoE uses QK-norm
        tie_embeddings=False,  # the JAX package's default: an lm_head of its own
        moe=MoeConfig(
            n_experts=64,
            top_k=8,
            d_ff_expert=1024,
            n_shared=0,
            first_k_dense=0,
        ),
        paired_leaves=default_paired_leaves(mlp=False, moe=True),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=96,
        vocab=256,
        qk_norm=True,
        tie_embeddings=False,
        moe=MoeConfig(n_experts=8, top_k=2, d_ff_expert=96, n_shared=0, capacity_factor=4.0),
        paired_leaves=default_paired_leaves(mlp=False, moe=True),
    )
