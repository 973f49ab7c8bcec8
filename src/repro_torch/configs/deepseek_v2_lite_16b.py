"""deepseek-v2-lite-16b — MoE with multi-head latent attention (MLA).

27L, d=2048, 16H, MLA kv_lora_rank=512 (qk_nope 128 + qk_rope 64, v 128),
MoE: 64 routed experts top-6 + 2 shared, expert d_ff=1408, first layer dense
(d_ff 10944). [arXiv:2405.04434; hf]  The JAX package's config: 64 routed
and 2 shared experts, top-6, as published.
"""
from repro_torch.configs.base import MlaConfig, ModelConfig, MoeConfig, default_paired_leaves


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=10944,  # dense first layer
        vocab=102400,
        mla=MlaConfig(kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
        moe=MoeConfig(
            n_experts=64,
            top_k=6,
            d_ff_expert=1408,
            n_shared=2,
            first_k_dense=1,
            d_ff_dense=10944,
        ),
        tie_embeddings=False,  # the JAX package's default: an lm_head of its own
        paired_leaves=default_paired_leaves(mla=True, moe=True, moe_shared=True),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-smoke",
        family="moe",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=192,
        vocab=256,
        mla=MlaConfig(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16),
        moe=MoeConfig(
            n_experts=8,
            top_k=2,
            d_ff_expert=48,
            n_shared=1,
            first_k_dense=1,
            d_ff_dense=192,
            capacity_factor=4.0,  # smoke: no capacity drops
        ),
        tie_embeddings=False,
        paired_leaves=default_paired_leaves(mla=True, moe=True, moe_shared=True),
    )
