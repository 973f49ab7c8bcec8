"""The training CLI of the port on the encoder-decoder and vision-language
families: the batch it builds beside the tokens, as the JAX CLI builds it.

``repro.launch.train`` feeds zero ``frames`` (batch, encoder frames,
d_model) to an encoder-decoder model and zero ``patches`` (batch,
vision_prefix, vision_embed_dim) to a vision-language one, in the config's
dtype; ``repro_torch.launch.train`` does the same (``train_extras``).

* ``train(..., smoke=True, steps=2, device="cpu")`` runs for whisper-base
  and internvl2-2b at the smoke configs (bf16), and so does the command
  line (at batch 2 × seq 24);
* its first loss, at the smoke config in fp32, equals the JAX ``lm_loss``
  of the same initial weights on the same zero extras and the same
  ``token_batches`` batch within 1e-5 relative;
* a sequence no longer than internvl2's ``vision_prefix`` is refused with a
  clear error (the JAX ``lm_loss`` raises a reshape error on a shorter one
  and returns 0 on one of ``vision_prefix`` tokens).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.data.tokens import token_batches as j_token_batches
from repro.models import lm as JM
from repro_torch.configs import get_smoke_config
from repro_torch.launch import train as t_train
from repro_torch.models import lm as TM

ARCHS = ["whisper-base", "internvl2-2b"]
BATCH, SEQ = 4, 24  # internvl2's 24 tokens run past its 8 patch positions


@pytest.mark.parametrize("arch", ARCHS)
def test_train_runs_on_the_smoke_config(arch):
    rec = t_train.train(arch=arch, smoke=True, steps=2, device="cpu", log_every=0)
    assert len(rec["history"]) == 2
    assert all(np.isfinite(v) for h in rec["history"] for v in h.values())
    assert rec["cfg"].dtype == "bfloat16"


@pytest.mark.parametrize("arch", ARCHS)
def test_train_extras_are_the_jax_clis(arch):
    cfg = get_smoke_config(arch)
    extras = t_train.train_extras(cfg, 3, "cpu")
    name, shape = (("patches", (3, cfg.vision_prefix, cfg.vision_embed_dim))
                   if cfg.vision_prefix else ("frames", (3, cfg.encoder.frames, cfg.d_model)))
    assert list(extras) == [name]
    assert extras[name].shape == shape and extras[name].dtype == torch.bfloat16
    assert not extras[name].any()
    assert t_train.train_extras(get_smoke_config("qwen2-1.5b"), 3, "cpu") == {}


@pytest.mark.parametrize("arch", ARCHS)
def test_first_loss_equals_jax_lm_loss_on_zero_extras(arch, monkeypatch):
    """The CLI at the smoke config in fp32: its first step's loss against
    the JAX ``lm_loss`` (the JAX CLI's knobs) of the port's seed-0 initial
    weights, on the JAX CLI's first batch and zero extras."""
    fp32 = lambda name: dataclasses.replace(get_smoke_config(name), dtype="float32")
    monkeypatch.setattr(t_train, "get_smoke_config", fp32)
    rec = t_train.train(arch=arch, smoke=True, steps=1, batch=BATCH, seq=SEQ, device="cpu",
                        log_every=0)
    cfg = fp32(arch)
    values = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                          TM.lm_value_tree(TM.init_lm(cfg, 0, device="cpu")))
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32")
    tok, lab = next(j_token_batches(BATCH, SEQ, jcfg.vocab, seed=1))
    batch = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}
    if jcfg.vision_prefix:
        batch["patches"] = jnp.zeros((BATCH, jcfg.vision_prefix, jcfg.vision_embed_dim),
                                     jnp.float32)
    if jcfg.encoder is not None:
        batch["frames"] = jnp.zeros((BATCH, jcfg.encoder.frames, jcfg.d_model), jnp.float32)
    want, _ = JM.lm_loss(jcfg, values, batch, knobs=JM.PerfKnobs(q_chunk=min(1024, SEQ)))
    np.testing.assert_allclose(rec["history"][0]["loss"], float(want), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_command_line_runs(arch, capsys):
    t_train.main(["--arch", arch, "--smoke", "--steps", "2", "--batch", "2", "--seq",
                  str(SEQ), "--device", "cpu", "--log-every", "1"])
    lines = capsys.readouterr().out.splitlines()
    assert [line.split()[2] for line in lines if line.startswith("[train] step ")] == ["1", "2"]
    assert lines[-1].startswith("[train] done: 2 steps")


def test_short_sequence_of_a_vision_model_is_refused():
    with pytest.raises(ValueError, match="patch positions"):
        t_train.train(arch="internvl2-2b", smoke=True, steps=1, batch=2, seq=8, device="cpu")
    cfg = dataclasses.replace(get_smoke_config("internvl2-2b"), dtype="float32")
    model = TM.init_lm(cfg, 0, device="cpu")
    for seq in (4, 8):
        tokens = torch.zeros((1, seq), dtype=torch.int64)
        batch = {"tokens": tokens, "labels": tokens,
                 "patches": torch.zeros((1, cfg.vision_prefix, cfg.vision_embed_dim))}
        with pytest.raises(ValueError, match="patch positions"):
            TM.lm_loss(cfg, model, batch)
    batch = {"tokens": torch.zeros((1, 9), dtype=torch.int64),
             "labels": torch.zeros((1, 9), dtype=torch.int64),
             "patches": torch.zeros((1, cfg.vision_prefix, cfg.vision_embed_dim))}
    assert float(TM.lm_loss(cfg, model, batch)[0]) > 0
