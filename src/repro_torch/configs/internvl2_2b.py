"""internvl2-2b — VLM: InternLM2-1.8B backbone (24L d=2048 16H kv=8) with the
InternViT frontend STUBBED: the first `vision_prefix` positions take
precomputed patch embeddings (``launch.inputs.make_batch`` supplies seeded
stubs). [arXiv:2404.16821; hf]
"""
from repro_torch.configs.base import ModelConfig, default_paired_leaves


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b",
        family="vlm",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        d_ff=8192,
        vocab=92553,
        vision_prefix=256,  # one 448x448 tile → 256 patch embeddings
        rope_theta=1e6,
        tie_embeddings=False,  # the JAX package's default: an lm_head of its own
        paired_leaves=default_paired_leaves(),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-smoke",
        family="vlm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        vision_prefix=8,
        tie_embeddings=False,
        paired_leaves=default_paired_leaves(),
    )
