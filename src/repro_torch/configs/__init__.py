"""Architecture configs of the port.

``get_config(name)`` / ``get_smoke_config(name)`` resolve all ten
architectures of the JAX package: the dense GQA ``qwen2-1.5b``,
``qwen3-4b`` (per-head qk-norm), ``granite-3-2b`` and
``mistral-large-123b``; ``olmoe-1b-7b`` (MoE, 64 routed experts top-8),
``deepseek-v2-lite-16b`` (MLA, 64 routed experts top-6 beside 2 shared
ones, a dense first layer), ``mamba2-2.7b`` (SSM: Mamba-2 SSD blocks, no
attention), ``hymba-1.5b`` (hybrid: attention beside SSM heads in every
layer, 128 meta tokens, sliding windows on 29 of its 32 layers),
``whisper-base`` (encoder-decoder over 1500 precomputed audio frames,
LayerNorm, GELU) and ``internvl2-2b`` (256 precomputed patch embeddings
before the text).  Any other name raises ``KeyError``.
"""
from __future__ import annotations

import dataclasses
import importlib

# The architectures the JAX package defines; the port resolves PORTED (all).
ALL_ARCHS = [
    "qwen2-1.5b",
    "mistral-large-123b",
    "granite-3-2b",
    "qwen3-4b",
    "whisper-base",
    "internvl2-2b",
    "mamba2-2.7b",
    "deepseek-v2-lite-16b",
    "olmoe-1b-7b",
    "hymba-1.5b",
]
PORTED = ["qwen2-1.5b", "olmoe-1b-7b", "deepseek-v2-lite-16b", "mamba2-2.7b", "hymba-1.5b",
          "qwen3-4b", "granite-3-2b", "mistral-large-123b", "whisper-base", "internvl2-2b"]


def _module(name: str):
    if name not in PORTED:
        raise KeyError(f"arch {name!r} is unknown; the port runs {PORTED}")
    return importlib.import_module(
        f"repro_torch.configs.{name.replace('-', '_').replace('.', 'p')}"
    )


def get_config(name: str):
    """Full-size config of a ported architecture."""
    return _module(name).config()


def get_smoke_config(name: str):
    """Reduced config of the same family for CPU tests."""
    return _module(name).smoke_config()


def cut_layers(cfg, n_layers: int):
    """``cfg`` at its widths with its decoder, and its encoder if it has
    one, cut to ``n_layers`` layers (a model too deep for one card, or a
    parity run at a few layers)."""
    enc = cfg.encoder and dataclasses.replace(cfg.encoder, n_layers=n_layers)
    return dataclasses.replace(cfg, n_layers=n_layers, encoder=enc)
