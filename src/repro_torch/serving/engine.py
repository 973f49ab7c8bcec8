"""Batched serving engine: prefill once, decode step by step.

The port of ``repro.serving.engine``, the mesh variant included
(:mod:`~repro_torch.serving.frontend` drives it under load).  The engine owns
a fixed-capacity batch of
sequence slots: each slot tracks its own position, so requests of different
lengths decode together, and a finished slot is refilled by the next
request.  With ``knobs.gemm="pallas_paired"`` it pairs the decoder weights
(``core.transform.pair_lm_params``) unless the model already carries
metadata; it then serves from a frozen copy of the model, which shares the
caller's weights and keeps the compute-dtype casts and the paired kernels'
segments after their first use (serving never updates weights).  Its
prefill and decode are the step functions of ``serving.steps``
(``build_prefill_step``, ``build_serve_step``), which run under the knobs'
tile cache.

With a ``mesh`` (``parallel.sharding.make_mesh``; one engine a rank, every
rank fed the same requests) the engine is one rank of a tensor-parallel
cell (``launch.steps.wire_serve_cell``): it holds its shards of the weights,
paired per shard, and its part of the cache; its steps close each split
with a collective, and every rank returns every slot's token.  With a
``data`` axis the slots are split over the data rows: a request's cache
lives on its slot's row, and every row prefills it alike; under FSDP
(mistral-large-123b's rules) each layer's weights are gathered over the
data rows before it runs.  ``model`` may then be the model's source, an
``init_lm`` seed or the JAX package's value tree, of which the rank builds
only its shards (``launch.steps.local_model``).
"""
from __future__ import annotations

from collections.abc import Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.transform import has_lm_pairing, pair_lm_params
from repro_torch.kernels.ops import paired_mode_of
from repro_torch.models import lm as M
from repro_torch.serving.steps import (
    build_prefill_step,
    build_serve_step,
    load_knobs_tile_cache,
)

class CapacityError(ValueError):
    """A request or decode step would exceed the engine's hard bounds."""


#: token emitted for slots that are not active — callers must never treat it
#: as model output (vocab ids are non-negative, so -1 can't collide)
INACTIVE_TOKEN = -1


class ServeEngine:
    def __init__(self, cfg: ModelConfig, model: M.LM, max_seq: int, batch_size: int,
                 knobs: M.PerfKnobs = M.DEFAULT_KNOBS, mesh=None, rules=None):
        self.cfg, self.max_seq, self.batch_size, self.knobs = cfg, max_seq, batch_size, knobs
        self.mesh, self.rules, self.tp, self.cell = mesh, rules, None, None
        self.pair_report = None
        if mesh is not None:
            from repro_torch.launch.steps import wire_serve_cell

            cell = wire_serve_cell(cfg, model, mesh, batch_size=batch_size, max_seq=max_seq,
                                   knobs=knobs, rules=rules)
            self.model, self.rules, self.tp = cell.model, cell.rules, cell.tp
            self.pair_report, self.cell = cell.pair_report, cell
            self._prefill, self._decode = cell.prefill, cell.decode
            self.device = mesh.device
        else:
            self.device = model.embed.device
            if knobs.gemm == "pallas_paired" and not has_lm_pairing(model):
                mode, block_n = paired_mode_of(knobs)
                model, self.pair_report = pair_lm_params(
                    model, knobs.pair_rounding, mode=mode, block_n=block_n)
            self.model = model.copy(frozen=True)
            tile_cache = load_knobs_tile_cache(knobs)  # read once, for both steps
            self._prefill = build_prefill_step(cfg, knobs, tile_cache)
            self._decode = build_serve_step(cfg, knobs, tile_cache)
        self.cache = M.init_cache(cfg, batch_size, max_seq, device=self.device, tp=self.tp)
        self.pos = np.zeros((batch_size,), np.int32)
        self.tokens = torch.zeros((batch_size, 1), dtype=torch.int64, device=self.device)
        self.active = np.zeros((batch_size,), bool)
        # slots pulled out of service: they refuse admission until
        # clear_quarantine() runs
        self.quarantined = np.zeros((batch_size,), bool)
        # decode-step logits of the last step() (host copy, (batch, vocab))
        self.last_logits: np.ndarray | None = None

    # -- request management -------------------------------------------------
    def add_request(self, slot: int, prompt: np.ndarray, extras: dict | None = None) -> int:
        """Prefill a prompt (plen,) into one slot; returns its first token.

        ``extras`` holds what the model reads beside the tokens, with a
        batch axis of 1: an encoder-decoder model's ``"frames"`` (1, F, d),
        a vision-language model's ``"patches"`` (1, vision_prefix,
        vision_embed_dim), as numpy arrays or tensors.  Raises
        :class:`CapacityError` on any bound violation, and for a
        vision-language prompt of ``vision_prefix`` tokens or fewer (the
        JAX package's engine keeps ``vision_prefix`` positions of such a
        prompt but decodes from ``plen``, over the patches' keys); a
        quarantined slot refuses admission until :meth:`clear_quarantine`.
        """
        plen = len(prompt)
        if not 0 <= slot < self.batch_size:
            raise CapacityError(f"slot {slot} out of range for batch_size={self.batch_size}")
        if self.active[slot]:
            raise CapacityError(f"slot {slot} is still active — release_slot() it first")
        if self.quarantined[slot]:
            raise CapacityError(f"slot {slot} is quarantined — clear_quarantine() it first")
        if plen < 1:
            raise CapacityError("empty prompt")
        if plen >= self.max_seq:
            raise CapacityError(
                f"prompt length {plen} leaves no decode room in "
                f"max_seq={self.max_seq} (need plen < max_seq)")
        if plen <= self.cfg.vision_prefix:
            raise CapacityError(
                f"prompt length {plen} is not longer than the {self.cfg.vision_prefix} "
                "patch positions it starts with: no text token would be read")
        tokens = torch.as_tensor(np.asarray(prompt)[None, :], dtype=torch.int64,
                                 device=self.device)
        batch = {"tokens": tokens, **{k: torch.as_tensor(v, device=self.device)
                                       for k, v in (extras or {}).items()}}
        last_logits, cache = self._prefill(self.model, batch)
        # splice this request's cache into the slot: an SSM entry (L, 1, …)
        # and a cross-attention one (L, 1, frames, …) whole, an attention
        # entry (L, 1, meta_tokens + plen, …) over its positions
        local, lo = self._local_slot(slot)
        for name, dst in self.cache.items() if local is not None else ():
            src = cache[name][:, 0].to(dst.dtype)
            if name not in M.SEQ_ENTRIES:
                dst[:, local] = src
            else:  # a sequence-sharded cache keeps its own positions [lo, lo + S')
                src = src[:, lo:lo + dst.shape[2]]
                dst[:, local, :src.shape[1]] = src
        self.pos[slot] = plen
        next_tok = int(torch.argmax(last_logits[0, -1, : self.cfg.vocab]))
        self.tokens[slot, 0] = next_tok
        self.active[slot] = True
        return next_tok

    def step(self, sample: Callable | None = None) -> np.ndarray:
        """One decode step for every slot. Returns (batch,) next tokens.

        Inactive slots emit :data:`INACTIVE_TOKEN` and keep their position.
        Raises :class:`CapacityError` when an active slot has no cache row
        left (``pos >= max_seq``).
        """
        over = self.active & (self.pos >= self.max_seq)
        if over.any():
            raise CapacityError(
                f"slot(s) {np.flatnonzero(over).tolist()} at pos "
                f"{self.pos[over].tolist()} have no cache rows "
                f"left (max_seq={self.max_seq}) — evict or raise max_seq")
        pos = torch.as_tensor(self.pos, device=self.device)
        logits, self.cache = self._decode(self.model, self.cache,
                                          {"tokens": self.tokens, "pos": pos})
        logits = logits[:, 0, : self.cfg.vocab]
        nxt = torch.argmax(logits, dim=-1) if sample is None else sample(logits)
        self.pos = self.pos + self.active.astype(np.int32)
        self.tokens = nxt[:, None].to(torch.int64)
        self.last_logits = logits.cpu().numpy()
        return np.where(self.active, nxt.cpu().numpy(), INACTIVE_TOKEN)

    def _local_slot(self, slot: int) -> tuple[int | None, int]:
        """(this rank's cache row of ``slot``, or None where another data row
        holds it; the first position its cache holds)."""
        tp = self.tp
        if tp is None:
            return slot, 0
        seq = [t for name, t in self.cache.items() if name in M.SEQ_ENTRIES]
        lo = tp.r * seq[0].shape[2] if tp.cache_seq else 0
        if not tp.batch_split:
            return slot, lo
        per = self.batch_size // tp.dp
        return (slot - tp.dr * per if slot // per == tp.dr else None), lo

    def force_token(self, slot: int, token: int) -> None:
        """Override the next input token of one slot."""
        self.tokens[slot, 0] = int(token)

    def release_slot(self, slot: int, *, scrub: bool = True) -> None:
        """Evict a slot: mark it free and (by default) zero its cache rows
        (K/V or latents, SSM state and conv tails), so a later request in the
        slot never sees the previous occupant's."""
        if not 0 <= slot < self.batch_size:
            raise CapacityError(f"slot {slot} out of range for batch_size={self.batch_size}")
        self.active[slot] = False
        self.pos[slot] = 0
        self.tokens[slot, 0] = 0
        local, _ = self._local_slot(slot)
        if scrub and local is not None:
            for t in self.cache.values():
                t[:, local] = 0

    def quarantine_slot(self, slot: int) -> None:
        """Evict + scrub a slot and refuse admission until :meth:`clear_quarantine`."""
        self.release_slot(slot, scrub=True)
        self.quarantined[slot] = True

    def clear_quarantine(self, slot: int) -> None:
        self.quarantined[slot] = False

    def free_slots(self) -> list[int]:
        """Slots admission may use right now (inactive and not quarantined)."""
        return [i for i in range(self.batch_size)
                if not self.active[i] and not self.quarantined[i]]

    def generate(self, slot_prompts: dict[int, np.ndarray], n_steps: int,
                 extras: dict | None = None) -> dict[int, list[int]]:
        """Prefill the given slots (each with the same ``extras``, as the JAX
        package's engine does), then decode greedily: ``n_steps`` tokens per
        slot, the first from the prefill."""
        outs = {slot: [self.add_request(slot, prompt, extras)]
                for slot, prompt in slot_prompts.items()}
        for _ in range(n_steps - 1):
            nxt = self.step()
            for slot in slot_prompts:
                outs[slot].append(int(nxt[slot]))
        return outs
