"""hymba-1.5b — hybrid-head: every layer runs attention ∥ Mamba heads in
parallel on the same input; 128 learned meta-tokens are prepended; 3 layers
(first/middle/last) use full attention, the rest sliding-window.
32L d=1600 25H (GQA kv=5) d_ff=5504 ssm_state=16. [arXiv:2411.13676; hf]
"""
from repro_torch.configs.base import ModelConfig, SsmConfig, default_paired_leaves


def config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b",
        family="hybrid",
        n_layers=32,
        d_model=1600,
        n_heads=25,
        n_kv_heads=5,
        d_ff=5504,
        vocab=32001,
        d_head=64,
        sliding_window=1024,
        full_attn_layers=(0, 15, 31),
        meta_tokens=128,
        ssm=SsmConfig(d_state=16, head_dim=64, expand=2, n_groups=1, chunk=256),
        tie_embeddings=True,
        paired_leaves=default_paired_leaves(ssm=True),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="hymba-smoke",
        family="hybrid",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        d_head=16,
        sliding_window=16,
        full_attn_layers=(0, 2),
        meta_tokens=8,
        ssm=SsmConfig(d_state=8, head_dim=16, expand=2, n_groups=1, chunk=16),
        tie_embeddings=True,
        paired_leaves=default_paired_leaves(ssm=True),
    )
