"""Model inputs: a concrete seeded batch for smoke runs and the serving
CLI, as ``repro.launch.inputs.make_batch`` makes it, and the shape-only
stand-ins of the dry run (:func:`batch_specs`, empty tensors that allocate
nothing on ``meta`` or under a ``FakeTensorMode``) with each entry's
logical sharding axes (:func:`batch_logical_axes`).

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


def batch_logical_axes(cfg: ModelConfig, kind: str) -> dict:
    """Logical sharding axes for each batch entry (leading dim = batch)."""
    ax: dict = {"tokens": ("batch", "seq")}
    if kind == "train":
        ax["labels"] = ("batch", "seq")
    if cfg.vision_prefix:
        ax["patches"] = ("batch", None, None)
    if cfg.encoder is not None:
        ax["frames"] = ("batch", None, None)
    if kind == "decode":
        ax = {"tokens": ("batch", None), "pos": ("batch",)}
    return ax


def batch_specs(cfg: ModelConfig, batch: int, seq: int, kind: str, *,
                device="meta") -> dict:
    """Stand-ins for one step's inputs, the JAX package's ShapeDtypeStructs:
    empty tensors of the same shapes and dtypes (int32 ids and positions,
    the stub frames and patches in the compute dtype) on ``device``, which
    allocate nothing on ``meta`` or under a ``FakeTensorMode``."""
    cdt = getattr(torch, cfg.dtype)
    empty = lambda shape, dtype: torch.empty(shape, dtype=dtype, device=device)
    if kind == "decode":
        return {"tokens": empty((batch, 1), torch.int32), "pos": empty((batch,), torch.int32)}
    specs = {"tokens": empty((batch, seq), torch.int32)}
    if kind == "train":
        specs["labels"] = empty((batch, seq), torch.int32)
    if cfg.vision_prefix:
        specs["patches"] = empty((batch, cfg.vision_prefix, cfg.vision_embed_dim), cdt)
    if cfg.encoder is not None:
        specs["frames"] = empty((batch, cfg.encoder.frames, cfg.d_model), cdt)
    return specs


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
