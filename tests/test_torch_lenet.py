"""The port's LeNet, MNIST data and package boundary against the JAX package.

* Weights made by the reference's ``init_lenet`` (or its trainer) carry
  across with ``lenet_params_from_numpy``; logits then agree with the
  reference's ``lenet_apply`` for every ``conv_impl`` × ``fuse_pool`` ×
  pairing mode, and the trained model scores the same accuracy.
* The synthetic MNIST split and the IDX reader give the reference's data.
* Guards: nothing under ``src/repro_torch/`` (nor ``chip_smoke.py`` or
  ``examples/*_torch.py``) imports ``jax``, ``repro`` or ``benchmarks``;
  every module of the port imports; and the entry points refuse to run without
  CUDA unless the caller asks for the CPU.
"""
import ast
import gzip
import importlib
import struct
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.transform import build_conv_pairings as j_build
from repro.data import mnist as j_mnist
from repro.models import lenet as j_lenet
from repro_torch import device as t_device
from repro_torch.core.transform import build_conv_pairings as t_build
from repro_torch.data import mnist as t_mnist
from repro_torch.kernels.ref import rel_err
from repro_torch.models import lenet as t_lenet

ROOT = Path(__file__).resolve().parent.parent
RTOL = 1e-5
MODES = [("structured", 0), ("column_blocked", 4), ("per_column", 0)]


@pytest.fixture(scope="module")
def carried():
    """Reference-initialised weights, a small input batch, and both trees."""
    j_params = jax.tree_util.tree_map(np.asarray, j_lenet.init_lenet(jax.random.key(3)))
    x = np.random.default_rng(0).random((3, 32, 32, 1)).astype(np.float32)
    return j_params, t_lenet.lenet_params_from_numpy(j_params, device="cpu"), x


def test_params_carry_across(carried):
    j_params, t_params, _ = carried
    assert t_params.keys() == j_params.keys()
    for layer in j_params:
        for k in ("w", "b"):
            np.testing.assert_array_equal(t_params[layer][k].numpy(), j_params[layer][k])


@pytest.mark.parametrize("conv_impl", ["torch", "im2col"])
def test_unpaired_logits_match_reference(carried, conv_impl):
    j_params, t_params, x = carried
    want = j_lenet.lenet_apply(
        j_params, jnp.asarray(x), conv_impl={"torch": "xla"}.get(conv_impl, conv_impl)
    )
    got = t_lenet.lenet_apply(t_params, torch.as_tensor(x), conv_impl=conv_impl)
    assert tuple(got.shape) == want.shape == (3, 10)
    assert rel_err(got, want) <= RTOL


@pytest.mark.parametrize("fuse_pool", [False, True])
@pytest.mark.parametrize("mode,block_n", MODES)
@pytest.mark.parametrize("r", [0.0, 0.05])
def test_paired_logits_match_reference(carried, mode, block_n, fuse_pool, r):
    """Each package pairs the same weights itself; the paired logits agree,
    and at r=0 they equal the unpaired conv's."""
    j_params, t_params, x = carried
    jp = j_build(j_params, r, mode=mode, block_n=block_n)
    tp = t_build(t_params, r, mode=mode, block_n=block_n)
    want = j_lenet.lenet_apply(
        j_params, jnp.asarray(x), conv_impl="pallas_paired", paired=jp, fuse_pool=fuse_pool
    )
    got = t_lenet.lenet_apply(
        t_params, torch.as_tensor(x), conv_impl="paired", paired=tp, fuse_pool=fuse_pool
    )
    assert rel_err(got, want) <= RTOL
    if r == 0:
        plain = t_lenet.lenet_apply(t_params, torch.as_tensor(x))
        assert rel_err(got, plain.numpy()) <= RTOL


def test_trained_accuracy_matches_reference(trained_lenet, tmp_path):
    """The trained reference model, carried across as its param tree and as
    the trainer's .npz, scores the same on 512 test images."""
    params, test_x32, test_y, _ = trained_lenet
    x, y = test_x32[:512], test_y[:512]
    np_params = jax.tree_util.tree_map(np.asarray, params)
    want = j_lenet.lenet_accuracy(np_params, x, y)
    npz = tmp_path / "lenet.npz"
    np.savez(npz, **{f"{k}_{f}": v[f] for k, v in np_params.items() for f in ("w", "b")})
    for src in (np_params, npz):
        t_params = t_lenet.lenet_params_from_numpy(src, device="cpu")
        assert t_lenet.lenet_accuracy(t_params, x, y) == want
    paired = t_build(t_params, 0.0)
    assert t_lenet.lenet_accuracy(
        t_params, x, y, conv_impl="paired", paired=paired, fuse_pool=True
    ) == want
    assert want > 0.5  # a trained model, not chance


def test_paired_impl_needs_artifacts(carried):
    _, t_params, x = carried
    with pytest.raises(ValueError, match="pairing artifacts"):
        t_lenet.lenet_apply(t_params, torch.as_tensor(x), conv_impl="paired")
    with pytest.raises(ValueError, match="conv_impl"):
        t_lenet.lenet_apply(t_params, torch.as_tensor(x), conv_impl="xla")


def test_init_lenet_is_seeded_he_init():
    a, b = t_lenet.init_lenet(7, device="cpu"), t_lenet.init_lenet(7, device="cpu")
    for layer, (shape, _) in t_lenet.LENET_CONV_SHAPES.items():
        assert tuple(a[layer]["w"].shape) == shape
        assert torch.equal(a[layer]["w"], b[layer]["w"])
        std = float(a[layer]["w"].std())
        assert 0.7 < std / np.sqrt(2.0 / np.prod(shape[:3])) < 1.3
    assert not torch.equal(a["conv1"]["w"], t_lenet.init_lenet(8, device="cpu")["conv1"]["w"])


def test_synthetic_mnist_matches_reference():
    got_x, got_y, got_src = t_mnist.load_mnist("test", synthetic_n=64, seed=2)
    want_x, want_y, want_src = j_mnist.load_mnist("test", synthetic_n=64, seed=2)
    assert got_src == want_src == "synthetic"
    assert got_x.dtype == np.float32
    np.testing.assert_array_equal(got_x, want_x.astype(np.float32))
    np.testing.assert_array_equal(got_y, want_y)
    np.testing.assert_array_equal(t_mnist.pad_to_32(got_x), j_mnist.pad_to_32(got_x))


def _write_idx(path: Path, arr: np.ndarray, gz: bool):
    head = struct.pack(">I", 0x0800 | arr.ndim) + struct.pack(">" + "I" * arr.ndim, *arr.shape)
    data = head + arr.astype(np.uint8).tobytes()
    if gz:
        with gzip.open(str(path) + ".gz", "wb") as f:
            f.write(data)
    else:
        path.write_bytes(data)


def test_idx_reader_matches_reference(tmp_path):
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, size=(5, 28, 28))
    labels = rng.integers(0, 10, size=5)
    _write_idx(tmp_path / "t10k-images-idx3-ubyte", images, gz=True)
    _write_idx(tmp_path / "t10k-labels-idx1-ubyte", labels, gz=False)
    got = t_mnist.load_mnist("test", data_dir=str(tmp_path))
    want = j_mnist.load_mnist("test", data_dir=str(tmp_path))
    assert got[2] == want[2] == "real"
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def _imported_modules(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            names.update(a.value for a in node.args if isinstance(a, ast.Constant))
    return names


PORT = ROOT / "src" / "repro_torch"
PORT_PACKAGES = ("benchmarks", "configs", "core", "data", "kernels", "launch", "models",
                 "serving", "train")
PORT_MODULES = sorted(
    ".".join(f.relative_to(PORT.parent).with_suffix("").parts).removesuffix(".__init__")
    for f in PORT.rglob("*.py")
)


def test_port_imports_neither_jax_nor_the_reference():
    """Nothing of the port, its smoke script or its examples imports JAX,
    the JAX package or the JAX package's top-level ``benchmarks``."""
    files = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "examples").glob("*_torch.py")))
    assert {f.parent.name for f in files} >= set(PORT_PACKAGES)
    assert {f"repro_torch.{p}" for p in PORT_PACKAGES} <= set(PORT_MODULES)
    assert ROOT / "examples" / "lenet_mnist_torch.py" in files
    for f in files:
        for name in _imported_modules(f):
            top = name.split(".")[0]
            assert top not in {"jax", "jaxlib", "repro", "benchmarks"}, (
                f"{f.relative_to(ROOT)} imports {name}")


@pytest.mark.parametrize("module", PORT_MODULES)
def test_port_module_imports(module):
    """Every module of the port imports on a machine without a card."""
    importlib.import_module(module)


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_device.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_device.resolve_device("cuda:0")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_lenet.init_lenet(0)
    assert t_device.resolve_device("cpu") == torch.device("cpu")
