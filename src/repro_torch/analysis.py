"""Schedule checks of the port: counts of what a forward really ran.

The JAX package audits the traced program (``repro.analysis``: jaxpr rules
such as ``schedule/no-standalone-pool`` and
``schedule/writebacks-per-program``).  PyTorch runs eagerly, so the port
counts while the function runs:

* ``k1_launches`` — launches of the paired GEMM kernel (K1), read from its
  wrappers' ``LAUNCHES`` counter: CUDA tensors only;
* ``k1_calls`` — calls of K1's wrappers, whether they launch the kernel or
  run its plain version on the CPU: one a conv layer, each with one store
  (the counterpart of the jaxpr's kernel writebacks);
* ``pool_ops`` — standalone 2×2 pools (``pool2_reference``) outside K1.

Calls are counted with ``sys.monitoring`` (Python 3.12+) on those
functions' code objects alone, so nothing on the path changes and nothing
is counted outside the ``with`` block.
"""
from __future__ import annotations

import collections
import contextlib
import sys

from repro_torch.kernels import paired_matmul as pm
from repro_torch.kernels.paired_conv import pool2_reference

_COUNTED = {
    "k1_calls": (pm.paired_matmul_cuda, pm.paired_matmul_blocked_cuda),
    "pool_ops": (pool2_reference,),
}


@contextlib.contextmanager
def counting():
    """Count K1 launches, K1 calls and standalone pools inside the block;
    yields a ``Counter`` that is complete once the block exits."""
    mon = sys.monitoring
    tool = next((i for i in range(6) if mon.get_tool(i) is None), None)
    if tool is None:
        raise RuntimeError("no free sys.monitoring tool id")
    codes = {fn.__code__: key for key, fns in _COUNTED.items() for fn in fns}
    counts = collections.Counter({key: 0 for key in (*_COUNTED, "k1_launches")})

    def on_start(code, offset):
        counts[codes[code]] += 1

    mon.use_tool_id(tool, __name__)
    try:
        mon.register_callback(tool, mon.events.PY_START, on_start)
        for code in codes:
            mon.set_local_events(tool, code, mon.events.PY_START)
        before = pm.launch_count()
        yield counts
        counts["k1_launches"] = pm.launch_count() - before
    finally:
        for code in codes:
            mon.set_local_events(tool, code, 0)
        mon.register_callback(tool, mon.events.PY_START, None)
        mon.free_tool_id(tool)

