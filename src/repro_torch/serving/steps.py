"""The serving step builders: prefill and decode.

The port of ``repro.launch.steps`` ``build_prefill_step`` and
``build_serve_step``, on one device (the JAX package's mesh and sharding
rules wait for tensor parallelism).  Each returns a plain function over the
model, the cache and a batch that runs without autograd under
``kernels.ops.tile_cache_context(knobs)``, as the JAX package's steps run
under ``perf_context(knobs)``; ``launch.steps`` exports them beside the
training step, and ``serving.engine.ServeEngine`` prefills and decodes
through them.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops, tuning
from repro_torch.models import lm as M


def load_knobs_tile_cache(knobs: M.PerfKnobs) -> tuning.TileCache | None:
    """The tile cache ``knobs.tile_cache`` names, loaded (a missing file
    raises), or None where it names none."""
    return tuning.load_tile_cache(knobs.tile_cache) if knobs.tile_cache else None


def build_prefill_step(cfg: ModelConfig, knobs: M.PerfKnobs = M.DEFAULT_KNOBS,
                       tile_cache: tuning.TileCache | None = None):
    """``prefill_step(model, batch) -> (logits, cache)``: ``models.lm.prefill``
    of ``batch["tokens"]`` (B, S), with an encoder-decoder model's
    ``"frames"`` or a vision-language one's ``"patches"`` beside them, under
    ``knobs``; the logits of the last position (B, 1, V) and the cache the
    prompt filled.  ``tile_cache``: the one ``knobs`` names, already loaded
    (else it is loaded here, once)."""
    tile_cache = tile_cache or load_knobs_tile_cache(knobs)

    def prefill_step(model: M.LM, batch: dict):
        extras = {k: batch[k] for k in M.EXTRAS if k in batch}
        with torch.no_grad(), ops.tile_cache_context(knobs, tile_cache):
            return M.prefill(cfg, model, batch["tokens"], knobs=knobs, extras=extras)

    return prefill_step


def build_serve_step(cfg: ModelConfig, knobs: M.PerfKnobs = M.DEFAULT_KNOBS,
                     tile_cache: tuning.TileCache | None = None):
    """``serve_step(model, cache, batch) -> (logits, cache)``: one
    ``models.lm.decode_step`` of ``batch["tokens"]`` (B, 1) at positions
    ``batch["pos"]`` (B,) against ``cache``, under ``knobs``;
    ``tile_cache`` as :func:`build_prefill_step`'s."""
    tile_cache = tile_cache or load_knobs_tile_cache(knobs)

    def serve_step(model: M.LM, cache: dict, batch: dict):
        with torch.no_grad(), ops.tile_cache_context(knobs, tile_cache):
            return M.decode_step(cfg, model, cache, batch["tokens"], batch["pos"], knobs=knobs)

    return serve_step
