"""Model inputs for smoke runs and the serving CLI: a concrete seeded
batch, as ``repro.launch.inputs.make_batch`` makes it.

The modality front ends are stubs, as in the JAX package: an
encoder-decoder model (whisper) gets precomputed frame embeddings, a
vision-language one (internvl2) precomputed patch embeddings, both seeded
normals times 0.02 in the compute dtype.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device


def make_batch(cfg: ModelConfig, batch: int, seq: int, kind: str = "train", seed: int = 0, *,
               device=None) -> dict:
    """A random batch drawn from ``numpy.random.default_rng(seed)`` in the
    JAX package's order: ``"tokens"`` (batch, seq); for ``kind="train"``
    ``"labels"`` (batch, seq); ``"patches"`` (batch, vision_prefix,
    vision_embed_dim) for a vision-language model; ``"frames"`` (batch,
    frames, d_model) for an encoder-decoder one.  ``kind="decode"`` gives
    ``"tokens"`` (batch, 1) and ``"pos"`` zeros (batch,).  Token ids are
    int64; the embeddings are cast to the compute dtype, then scaled by 0.02
    rounded to it (the JAX package's weakly typed scalar), bit for bit the
    JAX package's.  Tensors on ``device`` (the GPU unless ``"cpu"`` is asked for)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    cdt = getattr(torch, cfg.dtype)
    ids = lambda shape: torch.as_tensor(rng.integers(0, cfg.vocab, shape), dtype=torch.int64,
                                        device=dev)
    if kind == "decode":
        return {"tokens": ids((batch, 1)), "pos": torch.zeros((batch,), dtype=torch.int32,
                                                                device=dev)}
    out = {"tokens": ids((batch, seq))}
    if kind == "train":
        out["labels"] = ids((batch, seq))
    scale = torch.tensor(0.02, dtype=cdt, device=dev)  # JAX's weakly typed 0.02
    stub = lambda shape: torch.as_tensor(rng.normal(size=shape), device=dev).to(cdt) * scale
    if cfg.vision_prefix:
        out["patches"] = stub((batch, cfg.vision_prefix, cfg.vision_embed_dim))
    if cfg.encoder is not None:
        out["frames"] = stub((batch, cfg.encoder.frames, cfg.d_model))
    return out
