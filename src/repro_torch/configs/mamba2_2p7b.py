"""mamba2-2.7b — attention-free SSM (SSD / state-space duality).
64L d=2560, d_state=128, head_dim=64, expand=2. [arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import ModelConfig, SsmConfig, default_paired_leaves


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b",
        family="ssm",
        n_layers=64,
        d_model=2560,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,  # mamba blocks have no separate FFN
        vocab=50280,
        ssm=SsmConfig(d_state=128, head_dim=64, expand=2, n_groups=1, chunk=256),
        tie_embeddings=True,
        paired_leaves=default_paired_leaves(attn=False, mlp=False, ssm=True),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke",
        family="ssm",
        n_layers=2,
        d_model=64,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab=256,
        ssm=SsmConfig(d_state=16, head_dim=16, expand=2, n_groups=1, chunk=32),
        tie_embeddings=True,
        paired_leaves=default_paired_leaves(attn=False, mlp=False, ssm=True),
    )
