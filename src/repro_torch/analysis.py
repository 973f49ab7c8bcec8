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

:func:`decode_launches` says what one decode layer should launch, by layer
kind and schedule, for the launch counters of the serving paths to be held
to.

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
def counting(**extra):
    """Count K1 launches, K1 calls and standalone pools inside the block;
    yields a ``Counter`` that is complete once the block exits.  ``extra``
    names more functions to count calls of, by key (for instance
    ``moe_routes=(models.layers._moe_route,)``: the routed MoE dispatches)."""
    mon = sys.monitoring
    tool = next((i for i in range(6) if mon.get_tool(i) is None), None)
    if tool is None:
        raise RuntimeError("no free sys.monitoring tool id")
    counted = {**_COUNTED, **extra}
    codes = {fn.__code__: key for key, fns in counted.items() for fn in fns}
    counts = collections.Counter({key: 0 for key in (*counted, "k1_launches")})

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



def decode_launches(cfg, kind: str, knobs) -> dict[str, int]:
    """Kernel launches of one decode layer of ``kind`` (``"dense"``,
    ``"moe"``, ``"ssm"``, ``"hybrid_full"`` or ``"hybrid_swa"``) under
    ``knobs`` (``models.lm.PerfKnobs``), every decoder weight paired, keyed
    as ``launch.serve.kernel_launches``.

    Under ``gemm="pallas_paired"`` K1 runs the attention's projections and
    the feed-forward block's three: a gated MLP's, or all experts' gate, up
    and down, one launch each over the expert grid, whatever the expert
    count, and three more for shared experts.  GQA attention: the QKV
    projections (one launch when decode attention is fused and column
    blocks of ``pair_block_n`` tile q, k and v; three otherwise) and the
    out-projection unless K2 fuses it; ``attn="pallas_fused"`` is one K2
    launch.  MLA: ``wq``, ``w_dkv``, ``w_kr`` and ``wo``, and no K2 under
    any ``attn`` (its decode attention is latent einsums, as in the JAX
    package).  An SSM block: its six projections (``w_z``, ``w_x``,
    ``w_B``, ``w_C``, ``w_dt``, ``w_out``; the conv and the state update are
    plain PyTorch), alone in an ``"ssm"`` layer, beside GQA attention and
    the MLP in a hybrid one.  K3 runs on no decode path.
    """
    if kind not in ("dense", "moe", "ssm", "hybrid_full", "hybrid_swa"):
        raise ValueError(f"no decode layer of kind {kind!r} is ported")
    paired, fused = knobs.gemm == "pallas_paired", knobs.attn == "pallas_fused"
    if kind == "ssm":
        return {"paired_matmul": 6 if paired else 0, "decode_attention": 0, "flash_attention": 0}
    hybrid = kind.startswith("hybrid")
    ffn = 6 if kind == "moe" and cfg.moe.n_shared else 3 if not hybrid or cfg.d_ff else 0
    if cfg.mla is not None:
        return {"paired_matmul": 4 + ffn if paired else 0, "decode_attention": 0,
                "flash_attention": 0}
    bn, hd = knobs.pair_block_n, cfg.head_dim
    one_qkv = fused and bn >= 1 and not (cfg.n_heads * hd) % bn and not (
        cfg.n_kv_heads * hd) % bn
    k1 = (1 if one_qkv else 3) + (0 if fused else 1) + ffn + (6 if hybrid else 0) if paired else 0
    return {"paired_matmul": k1, "decode_attention": int(fused), "flash_attention": 0}
