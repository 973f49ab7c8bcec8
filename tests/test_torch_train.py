"""The port's training path against the JAX package's.

Same numpy inputs through ``repro.train`` and ``repro_torch.train``:

* optimizers on seeded random trees — AdamW (clipping, weight decay, a
  schedule), SGD, the cosine schedule at steps 0–60, the global norm and
  clipping — within 1e-6, and bf16 params with fp32 state;
* checkpoints: round trip, keep-N, atomicity, loop resume (the cases of
  ``tests/test_train.py``);
* ``batches`` index for index, ``lenet_loss`` and its gradients within 1e-5;
* 16 training steps from the reference's initial params: every loss within
  1e-5 relative, the params after them within 1e-4;
* the port's LeNet trainer above 0.9 test accuracy, and its cache.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import mnist as j_mnist
from repro.models import lenet as j_lenet
from repro.train import loop as j_loop
from repro.train import optimizer as j_opt
from repro_torch.data import mnist as t_mnist
from repro_torch.models import lenet as t_lenet
from repro_torch.train import lenet_trainer
from repro_torch.train import loop as t_loop
from repro_torch.train import optimizer as t_opt
from repro_torch.train.checkpoint import latest_step, restore_checkpoint, save_checkpoint

OPT_TOL = 1e-6
SHAPES = {"a": (7, 5), "b": (11,), "c": (3, 4, 2)}


def _tree(rng, scale=1.0, dtype=np.float32):
    return {k: (rng.normal(size=s) * scale).astype(dtype) for k, s in SHAPES.items()}


def _run_both(j_make, t_make, steps=6, seed=0, grad_scale=1.0, dtype=np.float32):
    """The same params and gradient sequence through both optimizers;
    returns (jax params, jax state, torch params, torch optimizer)."""
    rng = np.random.default_rng(seed)
    p0 = _tree(rng)
    grads = [_tree(rng, grad_scale) for _ in range(steps)]
    jo = j_make()
    jp = {k: jnp.asarray(v, dtype=jnp.dtype(dtype) if dtype != "bf16" else jnp.bfloat16)
          for k, v in p0.items()}
    js = jo.init(jp)
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    tp = {k: torch.tensor(v, dtype=tdt) for k, v in p0.items()}
    keys = sorted(tp)
    to = t_make()([tp[k] for k in keys])
    for i, g in enumerate(grads):
        jg = {k: jnp.asarray(v).astype(jp[k].dtype) for k, v in g.items()}
        jp, js = jo.update(jg, js, jp, i)
        for k in keys:
            tp[k].grad = torch.tensor(g[k]).to(tdt)
        to.step()
    return jp, js, tp, to, keys


def _close(got: torch.Tensor, want, tol=OPT_TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("weight_decay", [0.0, 0.05])
@pytest.mark.parametrize("grad_clip,grad_scale", [(None, 1.0), (1.0, 1.0), (1.0, 1e-3)])
@pytest.mark.parametrize("schedule", [False, True])
def test_adamw_matches_reference(weight_decay, grad_clip, grad_scale, schedule):
    """Clipping engaged (norm ≫ 1) and not (norm ≪ 1), decoupled decay, a
    constant rate and the cosine schedule with warm-up: params and both
    moments within 1e-6 after six steps."""
    def lr(mod):
        return mod.cosine_schedule(1e-2, 10, warmup_steps=3) if schedule else 1e-2

    jp, js, tp, to, keys = _run_both(
        lambda: j_opt.adamw(lr(j_opt), weight_decay=weight_decay, grad_clip=grad_clip),
        lambda: t_opt.adamw(lr(t_opt), weight_decay=weight_decay, grad_clip=grad_clip),
        grad_scale=grad_scale,
    )
    for k in keys:
        _close(tp[k], jp[k])
        _close(to.state[tp[k]]["m"], js["m"][k])
        _close(to.state[tp[k]]["v"], js["v"][k])
    assert all(g["step"] == 6 for g in to.param_groups)


@pytest.mark.parametrize("momentum,grad_clip", [(0.9, None), (0.5, 1.0), (0.0, None)])
def test_sgd_matches_reference(momentum, grad_clip):
    jp, js, tp, to, keys = _run_both(
        lambda: j_opt.sgd(j_opt.cosine_schedule(0.05, 8, warmup_steps=2), momentum=momentum,
                          grad_clip=grad_clip),
        lambda: t_opt.sgd(t_opt.cosine_schedule(0.05, 8, warmup_steps=2), momentum=momentum,
                          grad_clip=grad_clip),
    )
    for k in keys:
        _close(tp[k], jp[k])
        _close(to.state[tp[k]]["mom"], js["mom"][k])


@pytest.mark.parametrize("total,warmup,min_ratio", [(50, 10, 0.1), (60, 0, 0.0), (7, 50, 0.1)])
def test_cosine_schedule_matches_reference(total, warmup, min_ratio):
    """Within 1e-6 relative, or 1e-6 of the base rate where the rate nears
    0: at ``min_ratio`` 0, ``1 + cos(π·frac)`` cancels near the end, and fp32
    ``cos`` differs by an ulp between XLA and PyTorch there."""
    base = 1e-3
    j_lr = j_opt.cosine_schedule(base, total, warmup_steps=warmup, min_ratio=min_ratio)
    t_lr = t_opt.cosine_schedule(base, total, warmup_steps=warmup, min_ratio=min_ratio)
    for step in range(61):
        got = t_lr(step)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(j_lr(step)), rtol=OPT_TOL,
                                   atol=OPT_TOL * base)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 30.0])
def test_global_norm_and_clipping_match_reference(scale):
    g = _tree(np.random.default_rng(1), scale)
    j_norm = j_opt.global_norm(g)
    keys = sorted(g)
    t_grads = [torch.tensor(g[k]) for k in keys]
    np.testing.assert_allclose(float(t_opt.global_norm(t_grads)), float(j_norm), rtol=OPT_TOL)
    j_clipped, j_n = j_opt.clip_by_global_norm(g, 1.0)
    t_clipped, t_n = t_opt.clip_by_global_norm(t_grads, 1.0)
    np.testing.assert_allclose(float(t_n), float(j_n), rtol=OPT_TOL)
    for k, t in zip(keys, t_clipped, strict=True):
        _close(t, j_clipped[k])
    assert float(t_opt.global_norm(t_clipped)) <= 1.0 + 1e-6


def test_adamw_bf16_params_fp32_state():
    """Moments stay fp32 over bf16 params; the params come back bf16, each
    within one bf16 rounding of the reference's."""
    jp, js, tp, to, keys = _run_both(
        lambda: j_opt.adamw(0.01), lambda: t_opt.adamw(0.01), dtype="bf16")
    for k in keys:
        assert tp[k].dtype == torch.bfloat16
        assert to.state[tp[k]]["m"].dtype == torch.float32
        _close(to.state[tp[k]]["m"], js["m"][k])
        _close(to.state[tp[k]]["v"], js["v"][k])
        want = np.asarray(jp[k].astype(jnp.float32))
        np.testing.assert_allclose(tp[k].float().numpy(), want, rtol=2**-8, atol=0)


def test_missing_gradient_counts_as_zero():
    """A parameter without a gradient moves as the reference's zero
    gradient moves it (weight decay alone)."""
    jo = j_opt.adamw(0.1, weight_decay=0.5)
    p = {"w": jnp.ones((3,))}
    want, _ = jo.update({"w": jnp.zeros((3,))}, jo.init(p), p, 0)
    w = torch.ones(3)
    t_opt.adamw(0.1, weight_decay=0.5)([w]).step()
    _close(w, want["w"])


def _quad(target):
    def loss_fn(params, t):
        err = params["w"] - t
        return torch.sum(err * err), torch.sum(err.abs())
    return loss_fn


@pytest.mark.parametrize("make,steps", [(lambda: t_opt.adamw(0.1), 300),
                                        (lambda: t_opt.sgd(0.05, momentum=0.5), 200)])
def test_optimizers_converge_on_quadratic(make, steps):
    target = torch.tensor([1.0, -2.0, 3.0, 0.5])
    params, info = t_loop.train({"w": torch.zeros(4)}, _quad(target), make(),
                                [(target,)] * steps, log_every=0, verbose=False)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(), atol=1e-2)
    assert info["steps"] == steps and len(info["losses"]) == steps


# ---------------------------------------------------------------------------
# checkpoints (the cases of tests/test_train.py)
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": np.float32(2.5) * np.ones(4), "h": torch.ones(3, dtype=torch.bfloat16)},
            "n": [3, 0.5]}
    save_checkpoint(tmp_path, 7, tree, metadata={"hello": 1})
    assert latest_step(tmp_path) == 7
    like = {"a": torch.zeros(2, 3), "b": {"c": np.zeros(4), "h": torch.zeros(3, dtype=torch.bfloat16)},
            "n": [0, 0.0]}
    restored, meta = restore_checkpoint(tmp_path, like)
    assert meta == {"hello": 1}
    assert torch.equal(restored["a"], tree["a"])
    np.testing.assert_array_equal(restored["b"]["c"], tree["b"]["c"])
    assert restored["b"]["h"].dtype == torch.bfloat16 and torch.equal(restored["b"]["h"], tree["b"]["h"])
    assert restored["n"] == [3, 0.5]


def test_checkpoint_refuses_another_tree(tmp_path):
    save_checkpoint(tmp_path, 1, {"x": torch.zeros(2)})
    with pytest.raises(ValueError, match="do not match"):
        restore_checkpoint(tmp_path, {"y": torch.zeros(2)})
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(tmp_path / "none", {"x": torch.zeros(2)})


def test_checkpoint_keep_n(tmp_path):
    for s in range(5):
        save_checkpoint(tmp_path, s, {"x": torch.zeros(1)}, keep=2)
    steps = sorted(p.name for p in tmp_path.iterdir() if p.name.startswith("step_"))
    assert len(steps) == 2
    assert latest_step(tmp_path) == 4


def test_checkpoint_atomicity_no_partial_dirs(tmp_path):
    """Temporary directories are gone after a save, also after a failed one;
    the final directory only ever appears complete."""
    save_checkpoint(tmp_path, 1, {"x": torch.zeros(3)})
    assert [p for p in tmp_path.iterdir() if p.name.startswith(".tmp_")] == []
    final = tmp_path / "step_0000000001"
    assert (final / "manifest.json").exists() and (final / "shard_0.npz").exists()
    with pytest.raises(TypeError, match="cannot checkpoint"):
        save_checkpoint(tmp_path, 2, {"x": object()})
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_0000000001"]


def test_train_loop_resume(tmp_path):
    """Kill-and-restart: resuming continues the step counter, the params and
    the moments, exactly as one uninterrupted run."""
    target = torch.tensor([1.0, 2.0])
    opt = t_opt.adamw(t_opt.cosine_schedule(0.05, 60, warmup_steps=5))
    kw = dict(ckpt_dir=str(tmp_path), ckpt_every=10, log_every=0, verbose=False)
    p0 = {"w": torch.zeros(2)}
    p1, info1 = t_loop.train(p0, _quad(target), opt, [(target,)] * 30, **kw)
    assert latest_step(tmp_path) == 30 and info1["steps"] == 30
    p2, info2 = t_loop.train(p0, _quad(target), opt, [(target,)] * 30, **kw)
    assert latest_step(tmp_path) == 60 and info2["steps"] == 30
    assert torch.equal(p0["w"], torch.zeros(2))  # the caller's params are not trained
    straight, _ = t_loop.train(p0, _quad(target), opt, [(target,)] * 60, log_every=0,
                               verbose=False)
    assert torch.equal(p2["w"], straight["w"])
    assert float(((p2["w"] - target) ** 2).sum()) <= float(((p1["w"] - target) ** 2).sum())


# ---------------------------------------------------------------------------
# data, loss, and training parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,batch,epochs,seed", [(100, 16, 1, 0), (257, 32, 3, 5), (64, 64, 2, 1)])
def test_batches_match_reference(n, batch, epochs, seed):
    images = np.arange(n * 4, dtype=np.float32).reshape(n, 2, 2, 1)
    labels = np.arange(n, dtype=np.int32)
    got = list(t_mnist.batches(images, labels, batch, seed=seed, epochs=epochs))
    want = list(j_mnist.batches(images, labels, batch, seed=seed, epochs=epochs))
    assert len(got) == len(want) == epochs * (n // batch)
    for (gx, gy), (wx, wy) in zip(got, want, strict=True):
        np.testing.assert_array_equal(gy, wy)
        np.testing.assert_array_equal(gx, wx)


@pytest.fixture(scope="module")
def reference_start():
    """The reference's initial LeNet and 1024 synthetic training images."""
    j_params = jax.tree_util.tree_map(np.asarray, j_lenet.init_lenet(jax.random.key(0)))
    x, y, _ = t_mnist.load_mnist("train", synthetic_n=1024, seed=0)
    return j_params, t_mnist.pad_to_32(x), y


def test_lenet_loss_and_grads_match_reference(reference_start):
    j_params, x, y = reference_start
    xb, yb = x[:64], y[:64]
    (j_loss, j_acc), j_grads = jax.value_and_grad(j_lenet.lenet_loss, has_aux=True)(
        j_params, jnp.asarray(xb), jnp.asarray(yb))
    t_params = t_lenet.lenet_params_from_numpy(j_params, device="cpu")
    for sub in t_params.values():
        for t in sub.values():
            t.requires_grad_()
    loss, acc = t_lenet.lenet_loss(t_params, torch.as_tensor(xb), torch.as_tensor(yb))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-5)
    assert float(acc) == float(j_acc)
    for layer, sub in t_params.items():
        for k, t in sub.items():
            want = np.asarray(j_grads[layer][k])
            np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max())


def test_training_matches_reference(reference_start):
    """16 AdamW steps (1024 images, batch 128, 2 epochs, the trainer's
    schedule shape): each loss within 1e-5 relative, params within 1e-4."""
    j_params, x, y = reference_start

    def opt(mod):
        return mod.adamw(mod.cosine_schedule(1e-3, 16, warmup_steps=50))

    j_step = j_loop.make_train_step(j_lenet.lenet_loss, opt(j_opt))
    params, state, j_losses = j_params, opt(j_opt).init(j_params), []
    for i, (bx, by) in enumerate(j_mnist.batches(x, y, 128, seed=0, epochs=2)):
        params, state, loss, _ = j_step(params, state, i, jnp.asarray(bx), jnp.asarray(by))
        j_losses.append(float(loss))
    j_final, j_info = j_loop.train(j_params, j_lenet.lenet_loss, opt(j_opt),
                                   j_mnist.batches(x, y, 128, seed=0, epochs=2),
                                   log_every=0, verbose=False)

    t_params = t_lenet.lenet_params_from_numpy(j_params, device="cpu")
    t_final, t_info = t_loop.train(t_params, t_lenet.lenet_loss, opt(t_opt),
                                   t_mnist.batches(x, y, 128, seed=0, epochs=2),
                                   log_every=0, verbose=False)
    assert t_info["steps"] == j_info["steps"] == len(j_losses) == 16
    np.testing.assert_allclose(t_info["losses"], j_losses, rtol=1e-5, atol=0)
    np.testing.assert_allclose(t_info["last_loss"], j_info["last_loss"], rtol=1e-5)
    for layer, sub in t_final.items():
        for k, t in sub.items():
            np.testing.assert_allclose(t.numpy(), np.asarray(j_final[layer][k]), rtol=0,
                                       atol=1e-4)
            np.testing.assert_array_equal(np.asarray(j_final[layer][k]),
                                          np.asarray(params[layer][k]))


def test_port_trainer_trains_and_caches(tmp_path, monkeypatch):
    """The port's trainer at the reference's system-test budget scores above
    0.9; a second call reads the cache file back (its own name, the
    reference's keys) with the same accuracy."""
    monkeypatch.setattr(lenet_trainer, "CACHE", tmp_path)
    kw = dict(epochs=2, train_n=8000, test_n=2000, device="cpu")
    params, test_x, test_y, info = lenet_trainer.get_trained_lenet(**kw)
    assert info["cached"] is False and info["train_steps"] == 2 * (8000 // 128)
    assert np.isfinite(info["losses"]).all()
    assert info["test_acc"] > 0.9, info["test_acc"]
    assert test_x.shape == (2000, 32, 32, 1)
    cache_file = tmp_path / "lenet_torch_e2_n8000_s0.npz"
    assert sorted(p.name for p in tmp_path.iterdir()) == [cache_file.name]
    with np.load(cache_file) as z:
        assert sorted(z.files) == sorted(f"{layer}_{k}" for layer in t_lenet.LENET_LAYERS
                                         for k in ("w", "b"))
        assert z["conv2_w"].shape == (5, 5, 6, 16)
    again = lenet_trainer.get_trained_lenet(**kw)
    assert again[3]["cached"] is True and again[3]["test_acc"] == info["test_acc"]
    for layer in params:
        assert torch.equal(again[0][layer]["w"], params[layer]["w"])
