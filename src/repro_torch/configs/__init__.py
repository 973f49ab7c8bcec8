"""Architecture configs of the port.

``get_config(name)`` / ``get_smoke_config(name)`` resolve the architectures
the port runs; so far ``qwen2-1.5b`` (dense GQA), ``olmoe-1b-7b`` (MoE,
64 routed experts top-8), ``deepseek-v2-lite-16b`` (MLA, 64 routed
experts top-6 beside 2 shared ones, a dense first layer), ``mamba2-2.7b``
(SSM: Mamba-2 SSD blocks, no attention) and ``hymba-1.5b`` (hybrid:
attention beside SSM heads in every layer, 128 meta tokens, sliding windows
on 29 of its 32 layers).  Every other name
the JAX package knows raises ``KeyError`` saying it is not ported yet.
"""
from __future__ import annotations

import importlib

# The architectures the JAX package defines; the port resolves PORTED only.
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
PORTED = ["qwen2-1.5b", "olmoe-1b-7b", "deepseek-v2-lite-16b", "mamba2-2.7b", "hymba-1.5b"]


def _module(name: str):
    if name not in PORTED:
        known = "not ported yet" if name in ALL_ARCHS else "unknown"
        raise KeyError(f"arch {name!r} is {known}; the port runs {PORTED}")
    return importlib.import_module(
        f"repro_torch.configs.{name.replace('-', '_').replace('.', 'p')}"
    )


def get_config(name: str):
    """Full-size config of a ported architecture."""
    return _module(name).config()


def get_smoke_config(name: str):
    """Reduced config of the same family for CPU tests."""
    return _module(name).smoke_config()
