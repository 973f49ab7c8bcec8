"""Meshes of ranks, and a launcher that starts one process a rank.

The port of ``repro.launch.mesh``.  The JAX package's meshes are TPU chips
(single pod (16, 16) as (data, model), two pods (2, 16, 16) as (pod, data,
model)); the port's are processes over ``torch.distributed``, one a rank:
:func:`make_production_mesh` lays the ranks the process group has out the
same way, and :func:`spawn` starts ``prod(shape)`` processes on this host,
each with its :class:`~repro_torch.parallel.sharding.Mesh`, runs a function
in each and returns what each returned.

    # every rank of a (1, 2) mesh over gloo on the CPU runs fn(mesh, *args)
    results = spawn(fn, (1, 2), backend="gloo", device="cpu", args=(...))

The function must be importable by its module and name (the children start
with ``python -m repro_torch.launch.mesh``, ``PYTHONPATH`` naming this
package's directory); its arguments and result are pickled.  The children
share a rendezvous file of their own, write their output to logs (shown when
a rank fails, never on this process's standard output) and are stopped when
one fails or the time runs out.
"""
from __future__ import annotations

import importlib
import math
import os
import pickle
import subprocess
import sys
import tempfile
import time
import traceback
from collections.abc import Callable, Sequence
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import DATA_AXES, Mesh, make_mesh


def data_axes(mesh) -> tuple[str, ...]:
    """The mesh axes that carry the batch dimension."""
    return tuple(a for a in DATA_AXES if a in mesh.axis_names)


def production_mesh_shape(world: int, *, multi_pod: bool = False
                          ) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """The JAX package's production axes over ``world`` ranks: ``(data,
    model)`` with ``model`` the largest power of two up to 16 that divides
    the world (a pod's ranks with ``multi_pod``: ``(pod, data, model)`` over
    two pods); (16, 16) and (2, 16, 16) at 256 and 512 ranks, as
    ``repro.launch.mesh`` lays out its TPU chips."""
    if not multi_pod:
        model = math.gcd(world, 16)
        return (world // model, model), ("data", "model")
    if world % 2:
        raise ValueError(f"{world} ranks do not make two pods")
    model = math.gcd(world // 2, 16)
    return (2, world // (2 * model), model), ("pod", "data", "model")


def make_production_mesh(*, multi_pod: bool = False, backend: str = "nccl",
                         device: str = "cuda") -> Mesh:
    """This rank's mesh over the ranks of the initialised process group, laid
    out by :func:`production_mesh_shape`.  No path of the port calls it yet:
    the train CLI's ``--mesh`` names its shape, and the dry run will lay out
    the production meshes (ROADMAP queue 1, item 2)."""
    shape, names = production_mesh_shape(dist.get_world_size(), multi_pod=multi_pod)
    return make_mesh(shape, names, backend=backend, device=device)


def _names(shape: Sequence[int]) -> tuple[str, ...]:
    return {1: ("model",), 2: ("data", "model"), 3: ("pod", "data", "model")}[len(shape)]


def spawn(fn: Callable, mesh_shape: Sequence[int], *, backend: str, device: str,
          args: tuple = (), kwargs: dict | None = None, timeout: float = 600.0) -> list:
    """Run ``fn(mesh, *args, **kwargs)`` on every rank of a ``mesh_shape`` mesh, one
    process a rank on this host, and return the ranks' results in rank
    order.

    ``backend`` (``"gloo"`` or ``"nccl"``) and ``device`` (``"cuda"`` or
    ``"cpu"``) go to :func:`~repro_torch.parallel.sharding.make_mesh`
    unchanged; the axes are ``(model,)``, ``(data, model)`` or ``(pod,
    data, model)`` by the shape's length.  Each child gives PyTorch its
    share of this process's intra-op threads.  A rank that raises, exits
    non-zero or outlives ``timeout`` seconds stops every rank, and this
    raises with its error and the tail of its log.
    """
    world = math.prod(mesh_shape)
    names = _names(mesh_shape)
    threads = max(1, torch.get_num_threads() // world)
    src = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ)
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    module = fn.__module__
    if module == "__main__":  # a module run with -m: its importable name
        spec = getattr(sys.modules["__main__"], "__spec__", None)
        if spec is None:
            raise ValueError(f"{fn.__qualname__} lives in a script: the ranks import it by "
                             "module and name, so it must live in an importable module")
        module = spec.name
    with tempfile.TemporaryDirectory(prefix="repro_torch_mesh_") as tmp:
        job = {"module": module, "name": fn.__qualname__, "shape": tuple(mesh_shape),
               "names": names, "backend": backend, "device": device, "args": args,
               "kwargs": kwargs or {},
               "threads": threads, "rendezvous": f"file://{tmp}/rendezvous"}
        with open(f"{tmp}/job.pkl", "wb") as f:
            pickle.dump(job, f)
        logs = [open(f"{tmp}/rank{r}.log", "w") for r in range(world)]
        procs = [subprocess.Popen([sys.executable, "-m", "repro_torch.launch.mesh", tmp, str(r)],
                                  env=env, stdout=logs[r], stderr=subprocess.STDOUT,
                                  stdin=subprocess.DEVNULL)
                 for r in range(world)]
        failed = None
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs):
                bad = next((r for r, p in enumerate(procs)
                            if p.returncode not in (None, 0)), None)
                if bad is not None:
                    failed = (bad, f"exit code {procs[bad].returncode}")
                    break
                if time.monotonic() > deadline:
                    failed = (0, f"timed out after {timeout:.0f} s")
                    break
                time.sleep(0.05)
            if failed is None:
                bad = next((r for r, p in enumerate(procs) if p.returncode != 0), None)
                if bad is not None:
                    failed = (bad, f"exit code {procs[bad].returncode}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
            for f in logs:
                f.close()
        results, errors = [], []
        for r in range(world):
            out = Path(f"{tmp}/rank{r}.out")
            if out.exists():
                with open(out, "rb") as f:
                    ok, value = pickle.load(f)
                results.append(value)
                if not ok:
                    errors.append((r, value))
        if failed is not None or errors:
            r, why = errors[0] if errors else failed
            log = Path(f"{tmp}/rank{r}.log").read_text()[-4000:]
            raise RuntimeError(f"mesh rank {r} of {world} failed: {why}\n{log}")
        return results


def _rank_main(tmp: str, rank: int) -> int:
    """A child of :func:`spawn`: join the process group, make the mesh, run
    the function, write its result (or its error) for the parent."""
    with open(f"{tmp}/job.pkl", "rb") as f:
        job = pickle.load(f)
    torch.set_num_threads(job["threads"])
    world = math.prod(job["shape"])
    result: tuple = (False, "did not finish")
    try:
        dist.init_process_group(job["backend"], init_method=job["rendezvous"],
                                world_size=world, rank=rank)
        mesh = make_mesh(job["shape"], job["names"], backend=job["backend"],
                         device=job["device"])
        if mesh.device.type == "cuda":
            torch.cuda.set_device(mesh.device)
        fn = importlib.import_module(job["module"])
        for part in job["name"].split("."):
            fn = getattr(fn, part)
        result = (True, fn(mesh, *job["args"], **job["kwargs"]))
    except Exception:
        result = (False, traceback.format_exc())
    finally:
        with open(f"{tmp}/rank{rank}.out.tmp", "wb") as f:
            pickle.dump(result, f)
        os.replace(f"{tmp}/rank{rank}.out.tmp", f"{tmp}/rank{rank}.out")
        if dist.is_initialized():
            if result[0]:
                dist.barrier()
            dist.destroy_process_group()
    return 0 if result[0] else 1


if __name__ == "__main__":
    sys.exit(_rank_main(sys.argv[1], int(sys.argv[2])))
