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
kind and schedule, :func:`prefill_launches`
what one request's prefill should, and :func:`train_launches` what one
training step should, for the launch counters of the serving and training
paths to be held to; :func:`mesh_decode_collectives` and
:func:`mesh_prefill_collectives` say which collectives one rank of a
tensor-parallel serve cell should make a decode step and a prefill, and
:func:`mesh_train_collectives` which (calls and bytes) one rank of the
training mesh should make a step, for ``parallel.collectives``' counter to
be held to (the counterpart of the JAX package's ``collective_stats`` over a
compiled step).

Calls are counted with ``sys.monitoring`` (Python 3.12+) on those
functions' code objects alone, so nothing on the path changes and nothing
is counted outside the ``with`` block.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
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
    ``"moe"``, ``"ssm"``, ``"hybrid_full"``, ``"hybrid_swa"`` or
    ``"encdec"``; a vision-language model's layers are ``"dense"``) under
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
    the MLP in a hybrid one.  An ``"encdec"`` layer is a dense one and its
    cross-attention's ``wq`` and ``wo``, two more K1 launches (the attention
    over the frames is plain, as in the JAX package).  K3 runs on no decode
    path.

    One rank of a mesh (every family, ``attn="xla"``) launches each
    projection once on the shard it holds, whatever the split: a
    column-parallel one on its columns (MLA's wq, an SSM block's w_z, w_x
    and w_dt), a row-parallel one on its rows (wo, w_down, w_out), a
    replicated one whole (MLA's w_dkv and w_kr, the SSM's w_B and w_C), the
    expert grid over its own experts; so its count is a single device's.
    """
    if kind not in ("dense", "moe", "ssm", "hybrid_full", "hybrid_swa", "encdec"):
        raise ValueError(f"no decode layer of kind {kind!r}")
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
    xattn = 2 if kind == "encdec" else 0
    k1 = ((1 if one_qkv else 3) + (0 if fused else 1) + ffn + (6 if hybrid else 0) + xattn
          if paired else 0)
    return {"paired_matmul": k1, "decode_attention": int(fused), "flash_attention": 0}


def prefill_launches(cfg, knobs) -> dict[str, int]:
    """Kernel launches of one request's prefill under ``knobs``, every
    weight paired, keyed as :func:`decode_launches`: each decoder layer runs
    each of its paired GEMMs once, as a decode layer without the fused
    attention does (three QKV launches and the out-projection; K2 is decode
    only); an encoder layer runs seven (its attention's four and the
    MLP's three).  Under ``attn="pallas_fused"`` K3 runs each encoder
    layer's self-attention and each decoder layer's cross-attention, one
    launch each; a decoder's causal self-attention stays plain."""
    plain_attn = dataclasses.replace(knobs, attn="xla")
    k1 = sum(decode_launches(cfg, cfg.layer_kind(i), plain_attn)["paired_matmul"]
             for i in range(cfg.n_layers))
    k3 = 0
    if cfg.encoder is not None:
        k1 += 7 * cfg.encoder.n_layers if knobs.gemm == "pallas_paired" else 0
        k3 = cfg.encoder.n_layers + cfg.n_layers if knobs.attn == "pallas_fused" else 0
    return {"paired_matmul": k1, "decode_attention": 0, "flash_attention": k3}


def _forward_gemms(cfg, kind: str, knobs) -> int:
    """K1 launches of one layer's forward over a sequence under ``knobs``:
    each :func:`~repro_torch.models.layers.dense` call under ``gemm="pallas"``
    (attention's four projections, GQA or MLA; an SSM block's six; a gated
    MLP's or shared experts' three; the routed experts are einsums), each
    paired weight's under ``"pallas_paired"`` (every decoder weight is
    paired), and there an MoE layer's three expert-grid launches (gate, up
    and down of every expert, on either branch) besides."""
    if knobs.gemm == "xla":
        return 0
    attn = 4 if kind != "ssm" else 0
    if kind == "encdec":  # and the cross-attention's wq and wo
        attn += 2
    ssm = 6 if kind in ("ssm", "hybrid_full", "hybrid_swa") else 0
    if kind == "moe":
        ffn = (3 if knobs.gemm == "pallas_paired" else 0) + (3 if cfg.moe.n_shared else 0)
    else:
        ffn = 3 if kind != "ssm" and (not kind.startswith("hybrid") or cfg.d_ff) else 0
    return attn + ssm + ffn


def train_launches(cfg, knobs) -> int:
    """K1 launches of one training step (``launch.steps.build_train_step``)
    of ``cfg`` under ``knobs`` (``models.lm.PerfKnobs``), every decoder
    weight paired under ``gemm="pallas_paired"``: each layer's forward
    GEMMs (7 in a dense GQA or MLA layer or an encoder layer, 9 with
    cross-attention; an MoE layer 7 under ``"pallas_paired"``, 10 with
    shared experts, and under ``"pallas"`` 4, or 7 with shared experts),
    and the same again under
    ``remat="full"``, which reruns every layer's forward in the backward
    (``"dots"`` keeps K1's outputs).  The backward's GEMMs and the head are
    ``torch.matmul``; K2 and K3 run on no training path.  One rank of the
    training mesh launches the same: each GEMM once on its shard (the
    column-parallel ones on its columns, the row-parallel ones on its rows,
    the expert grid over its own experts)."""
    fwd = sum(_forward_gemms(cfg, cfg.layer_kind(i), knobs) for i in range(cfg.n_layers))
    if cfg.encoder is not None:  # an encoder layer is a dense one
        fwd += cfg.encoder.n_layers * _forward_gemms(cfg, "dense", knobs)
    return fwd * (2 if knobs.remat == "full" else 1)


def _tp_layout(cfg, mesh, batch_size: int, max_seq: int, rules=None):
    from repro_torch.parallel.rules import rules_for
    from repro_torch.parallel.tp import layout_for

    return layout_for(cfg, mesh, rules or rules_for(cfg, "decode", mesh), batch_size, max_seq)


def _fsdp_gathers(tp, n_layers: int, *, encoder: int = 0) -> int:
    """FSDP's all-gathers one forward makes (``layers.gather_layer``, the
    embedding's, the head's): one a decoder layer with data-split weights,
    one an encoder layer (``encoder`` of them) and the encoder's final norm,
    the embedding's, the head's with the final norm."""
    if not tp.fsdp_axes:
        return 0
    calls = sum(bool(tp.layer(i).gathers) for i in range(n_layers)) + bool(tp.top("embed"))
    if encoder:
        calls += encoder * bool(tp.encoder_view().gathers) + bool(tp.top("encoder.final_norm."))
    return calls + bool(tp.top("final_norm.") or tp.top("lm_head") or tp.top("embed"))


def _layer_collectives(cfg, kind: str, tp, *, decode: bool) -> tuple[int, int]:
    """(all-reduces, all-gathers) over ``model`` of one decoder layer of
    ``kind`` under its view ``tp`` (``TensorParallel.layer``), a decode step
    or a prompt (``decode=False``)."""
    if tp.n == 1:  # a split over a model axis of one rank sends nothing
        return 0, 0
    reduce = gather = 0
    if kind != "ssm":  # attention, GQA or MLA: wo's partial sums
        reduce += tp.q_split
        if decode and tp.cache_seq:  # the queries, then the partial softmaxes
            gather += tp.q_split + 1
    if kind == "encdec":  # the cross-attention's wo
        reduce += tp.xq_split
    if kind in ("ssm", "hybrid_full", "hybrid_swa"):
        # the gated norm's statistic and w_out's partial sums; the conv'd
        # channels where the heads are whole
        reduce += 2 * tp.ssm_in_split
        gather += tp.ssm_in_split and not tp.ssm_heads_split
    if kind == "moe":  # the router's logits; the routed and shared sums, closed together
        gather += tp.router_split
        reduce += tp.experts_split or (tp.shared_split and bool(cfg.moe.n_shared))
    else:
        reduce += tp.ff_split
    return int(reduce), int(gather)


def mesh_decode_collectives(cfg, knobs, mesh, *, batch_size: int,
                            max_seq: int, rules=None) -> dict[str, int]:
    """Collectives one rank makes in one decode step of a tensor-parallel
    serve cell of ``cfg`` on ``mesh`` (``batch_size`` slots of ``max_seq``
    positions, ``rules_for(cfg, "decode", mesh)``), by kind, as
    ``parallel.collectives.collective_stats`` counts calls:

    * all-reduce over ``model``: the vocab-parallel embedding's lookup; in
      each layer wo's partial sums where the query heads are split (GQA,
      MLA, and the cross-attention's), the MLP's (w_down's) where it is
      split, one for the experts' routed and shared sums together, and an
      SSM block's two where its channels are split (the gated norm's sum of
      squares, then w_out's partial sums);
    * all-gather over ``model``: in each layer against a sequence-sharded
      cache (GQA's K/V, MLA's latent) the queries (where the heads are
      split) and the partial softmaxes; the router's logits where its
      expert columns are split; an SSM block's conv'd channels where its
      channels are split and its heads are not; the head's vocab columns;
      over the data axes, the logits of the slots, where they are split
      there, and under FSDP (``rules``: ``rules_for(cfg, "decode", mesh)``
      unless given) each layer's data-split weights, the embedding's and the
      head's with the final norm (:func:`_fsdp_gathers`).

    ``knobs`` picks nothing here: the GEMM route does not change the
    collectives."""
    tp = _tp_layout(cfg, mesh, batch_size, max_seq, rules)
    m = tp.n > 1
    reduce = m * tp.vocab_split
    gather = m * tp.vocab_split + tp.batch_split + _fsdp_gathers(tp, cfg.n_layers)
    for i in range(cfg.n_layers):
        r, g = _layer_collectives(cfg, cfg.layer_kind(i), tp.layer(i), decode=True)
        reduce, gather = reduce + r, gather + g
    return {"all_reduce": int(reduce), "all_gather": int(gather), "reduce_scatter": 0}


def mesh_prefill_collectives(cfg, knobs, mesh, *, batch_size: int,
                             max_seq: int, rules=None) -> dict[str, int]:
    """Collectives one rank makes in one request's prefill, by kind, as
    :func:`mesh_decode_collectives` counts them: the embedding's all-reduce;
    each encoder layer's two (wo's and w_down's partial sums, where split);
    each decoder layer's as in a decode step (the expert-parallel route's
    combine on a routed prompt, the dense branch's sum on a short one: one
    each), but no attention gathers: a prompt's attention reads only keys
    the rank just computed; the head's all-gather; FSDP's gathers over the
    data axes (:func:`_fsdp_gathers`, the encoder's too).  Every data row
    prefills alike, so nothing else crosses them."""
    tp = _tp_layout(cfg, mesh, batch_size, max_seq, rules)
    m = tp.n > 1
    reduce = m * tp.vocab_split
    gather = m * tp.vocab_split + _fsdp_gathers(
        tp, cfg.n_layers, encoder=cfg.encoder.n_layers if cfg.encoder is not None else 0)
    if cfg.encoder is not None:
        enc = tp.encoder_view()
        reduce += m * cfg.encoder.n_layers * (enc.q_split + enc.ff_split)
    for i in range(cfg.n_layers):
        r, g = _layer_collectives(cfg, cfg.layer_kind(i), tp.layer(i), decode=False)
        reduce, gather = reduce + r, gather + g
    return {"all_reduce": int(reduce), "all_gather": int(gather), "reduce_scatter": 0}


def mesh_train_collectives(cfg, knobs, mesh, batch: int, seq: int, *,
                           clip: bool = True, rules=None,
                           block: bool = False) -> dict[str, dict[str, int]]:
    """Collectives one rank of the training mesh makes in one step
    (``launch.steps.build_train_step`` with ``mesh``; global batches of
    ``batch`` × ``seq`` tokens, ``rules_for(cfg, "train", mesh)``), by kind,
    calls and bytes (of each call's local input), as
    ``parallel.collectives.collective_stats`` counts them.  The decoder's
    stream is ``meta_tokens + seq`` positions (S below):

    * each decoder block (attention, GQA or MLA; an SSM block; a hybrid
      layer's two branches, on one gather; the cross-attention's query; the
      FFN) under sequence parallelism: an all-gather of the rank's positions
      (compute dtype) enters it and a reduce-scatter of the input's gradient
      (B, S, d) leaves it in the backward; a block whose weights split over
      ``model`` (its query heads, an MLP's or the shared experts' columns,
      the experts, an SSM block's channels) closes with a reduce-scatter of
      its fp32 partial sums (B, S, d), whose gradient is all-gathered (B,
      S/n, d, fp32); without sequence parallelism, an all-reduce of the
      partial sums and one of their gradient.  A block whose weights are
      whole closes with none;
    * an SSM block with its channels split: the gated norm's statistic (B,
      S, 1, fp32) all-reduced, and its gradient; where its heads stay whole,
      the conv'd channels (B, S, d_in/n, compute dtype) all-gathered, their
      gradient (B, S, d_in) reduce-scattered;
    * an MoE layer: the router's logits (T, E/n, fp32) all-gathered where
      its expert columns split (their gradient reduce-scattered); on the
      routed branch the aux loss's statistics (2, E, fp32) in one all-reduce
      over ``model`` and the data axes that split the batch; the routed and
      the shared experts' partial sums close together, as one block;
    * the encoder (its frames F whole on every rank): each layer's
      attention and MLP, where split, an all-reduce of the fp32 partial
      sums (B, F, d) and one of their gradient;
    * the embedding, vocab split: its rows (the meta tokens' zero rows
      first) closed as a block's partial sums (fp32); the head, vocab split:
      the final-normed positions all-gathered (their gradient
      reduce-scattered), and each chunk of the cross-entropy over the
      ``seq`` token positions (``knobs.xent_chunk`` positions) an all-reduce
      of the logits' maxima (B, chunk) and one of the exps' and the label
      logits' sums (2, B, chunk); whole, one all-reduce of the rank's sum;
    * the loss's sum and its denominator over the data axes that split the
      batch (one all-reduce of 2 fp32);
    * after the backward, the gradients (fp32): those of the weights whole
      under ``model`` (the meta tokens, ``vision_proj`` and whole encoder
      weights among them) in one all-reduce over ``model`` (and those data
      axes), the split ones in one over those data axes; the clip's norm
      (``clip``: AdamW's default) one all-reduce of one fp32 over
      ``model``.

    Each layer's forward collectives run twice under ``knobs.remat``
    ``"full"`` or ``"dots"`` (the backward recomputes the layer; the
    encoder's too), each cross-entropy chunk's twice always (it is
    checkpointed).

    Under FSDP (``rules``, ``rules_for(cfg, "train", mesh)`` unless given,
    splitting weights over data axes) each layer's data-split blocks are
    all-gathered in one call (``redo`` times; the matrices in the compute
    dtype, the norms and the router in fp32) and their gradients
    reduce-scattered in one, in fp32; the embedding's, the head's with the
    final norm and the encoder's final norm the same, once.  After the
    backward a weight's gradient is summed over the mesh axes it is whole
    on (``model``; the data axes where the batch splits), one all-reduce a
    set of axes, and the clip's norm sums each set of split axes' squares
    in one of its own (``model``'s always).  A group of one rank sends
    nothing.  ``block``: the step takes the rank's block of the batch by its
    specs (the dry run's ``TrainStep(..., block_of=)``), and where the
    ``seq`` axis splits the ids, one all-gather of its tokens and labels
    (int32) along the sequence comes first."""
    from repro_torch.models.layers import gather_dtype
    from repro_torch.models.lm import compute_dtype
    from repro_torch.models.param import param_axes_and_shapes
    from repro_torch.parallel.rules import rules_for
    from repro_torch.parallel.sharding import shardings_for
    from repro_torch.parallel.tp import MODEL_AXIS, train_layout_for

    rules = rules or rules_for(cfg, "train", mesh)
    tp = train_layout_for(cfg, mesh, rules, batch, seq)
    n, c = tp.n, compute_dtype(cfg).itemsize
    b = batch // tp.dp if tp.batch_split else batch
    d, S = cfg.d_model, cfg.meta_tokens + seq
    out = {k: {"calls": 0, "bytes": 0} for k in ("all_reduce", "all_gather", "reduce_scatter")}

    def add(kind: str, nbytes: int, times: int = 1) -> None:
        out[kind]["calls"] += times
        out[kind]["bytes"] += times * nbytes

    m = n > 1
    redo = 2 if knobs.remat in ("full", "dots") else 1
    # a block's (B, S, d) and a rank's (B, S/n, d), in fp32 and in the compute dtype
    full32, own32 = b * S * d * 4, b * S // n * d * 4
    full_c, own_c = b * S * d * c, b * S // n * d * c

    def enter() -> None:
        """A block's way in, forward (``redo`` times) and backward."""
        if m and tp.seq_split:
            add("all_gather", own_c, redo)
            add("reduce_scatter", full_c)

    def close(split: bool, whole32: int = full32, seq_split: bool = tp.seq_split) -> None:
        """A block's way out, forward (``redo`` times) and backward."""
        if not (m and split):
            return
        if seq_split:
            add("reduce_scatter", whole32, redo)
            add("all_gather", whole32 // n)
        else:
            add("all_reduce", whole32, redo)
            add("all_reduce", whole32)

    def ssm(view) -> None:
        """An SSM block's gated-norm statistic and its gathered channels."""
        if not (m and view.ssm_in_split):
            return
        add("all_reduce", b * S * 4, redo)
        add("all_reduce", b * S * 4)
        if not view.ssm_heads_split:
            d_in = cfg.ssm.expand * d
            add("all_gather", b * S * d_in // n * c, redo)
            add("reduce_scatter", b * S * d_in * c)

    for i in range(cfg.n_layers):
        view, kind = tp.layer(i), cfg.layer_kind(i)
        enter()
        if kind != "ssm":  # attention, GQA or MLA
            close(view.q_split)
        if kind in ("ssm", "hybrid_full", "hybrid_swa"):
            ssm(view)
            close(view.ssm_in_split)
        if kind == "encdec":  # the cross-attention
            enter()
            close(view.xq_split)
        if kind == "moe":
            E, K = cfg.moe.n_experts, cfg.moe.top_k
            enter()
            if m and view.router_split:
                add("all_gather", b * S * E // n * 4, redo)
                add("reduce_scatter", b * S * E * 4)
            close(view.experts_split or (view.shared_split and bool(cfg.moe.n_shared)))
            routed = b * S * (tp.dp if tp.batch_split else 1) * K > 2 * E
            if routed and (m or tp.batch_split):
                add("all_reduce", 2 * E * 4, redo)
        elif kind != "ssm" and (not kind.startswith("hybrid") or cfg.d_ff):
            enter()
            close(view.ff_split)
    if cfg.encoder is not None:
        enc = tp.encoder_view()
        enc32 = b * cfg.encoder.frames * d * 4
        for _ in range(cfg.encoder.n_layers):
            close(enc.q_split, enc32, seq_split=False)
            close(enc.ff_split, enc32, seq_split=False)
    if m and tp.vocab_split:
        # the embedding's rows, closed as a block's partial sums (fp32 masters)
        if tp.seq_split:
            add("reduce_scatter", full32)
            add("all_gather", own32)
        else:
            add("all_reduce", full32, 2)
        if tp.seq_split:
            add("all_gather", own_c)
            add("reduce_scatter", full_c)
        chunk = min(knobs.xent_chunk, seq) if knobs.xent_chunk else seq
        chunks = -(-seq // chunk)
        add("all_reduce", b * chunk * 4, 2 * chunks)
        add("all_reduce", 2 * b * chunk * 4, 2 * chunks)
    elif m:
        add("all_reduce", 4)
    if tp.batch_split:
        add("all_reduce", 8)
    axes, shapes = param_axes_and_shapes(cfg)
    specs = shardings_for(axes, mesh, rules, shapes)
    cdt = compute_dtype(cfg)
    batch_axes = tp.data_axes if tp.batch_split else ()
    sums: dict[tuple, int] = {}  # the gradients' sums: fp32 bytes by set of mesh axes
    norms = {(MODEL_AXIS,)} if mesh.shape.get(MODEL_AXIS, 1) > 1 else set()
    moved: dict[tuple, list[int]] = {}  # FSDP, by gather: bytes gathered, bytes reduced

    def gathers(path: tuple) -> list[tuple]:
        """The FSDP gathers a data-split leaf rides in: its segment's layers'
        (the decoder's or the encoder's), or one of the top ones."""
        if path[0] == "segments":
            return [("decoder", path[1])]
        if path[0] == "encoder":
            return [("encoder", path[2]) if path[1] == "segments" else ("encoder norm",)]
        if path == ("embed",):
            return [("embed",), ("head",)] if cfg.tie_embeddings else [("embed",)]
        return [("head",)]  # lm_head, the final norm

    def leaf(path: tuple, spec, shape) -> None:
        on = {a for e in spec if e is not None for a in ((e,) if isinstance(e, str) else e)
              if mesh.shape[a] > 1}
        stacked = "segments" in path  # a layer's leaf, stacked: count one layer's
        per = shape.shape[0] if stacked else 1
        numel = shape.numel() // per // math.prod(mesh.axis_size(e) for e in spec)
        over = tuple(a for a in mesh.axis_names if a not in on and mesh.shape[a] > 1
                     and (a == MODEL_AXIS or a in batch_axes))
        sums[over] = sums.get(over, 0) + per * numel * 4
        if on:
            norms.add(tuple(a for a in mesh.axis_names if a in on))
        if on & set(tp.fsdp_axes):
            item = gather_dtype(str(path[-1]), shape[0] if stacked else shape, cdt).itemsize
            for key in gathers(path):
                got = moved.setdefault(key, [0, 0])
                got[0] += numel * item
                got[1] += numel * 4 * mesh.axis_size(tp.fsdp_axes)

    def walk(spec_tree, shape_tree, path=()) -> None:
        if isinstance(spec_tree, dict):
            for k in spec_tree:
                walk(spec_tree[k], shape_tree[k], (*path, k))
        elif isinstance(spec_tree, list):
            for i, (sp, sh) in enumerate(zip(spec_tree, shape_tree, strict=True)):
                walk(sp, sh, (*path, i))
        else:
            leaf(path, spec_tree, shape_tree)

    walk(specs, shapes)
    counts = {"decoder": [n for _, n in cfg.segments()],
              "encoder": [cfg.encoder.n_layers if cfg.encoder is not None else 0]}
    for key, (nbytes, rbytes) in moved.items():
        # a segment's layers, each checkpointed: gathered again in the backward
        times = counts[key[0]][key[1]] if len(key) == 2 else 1
        add("all_gather", nbytes, times * (redo if len(key) == 2 else 1))
        add("reduce_scatter", rbytes, times)
    for over, nbytes in sums.items():
        if over:
            add("all_reduce", nbytes)
    if clip:
        add("all_reduce", 4, len(norms))
    if block:
        from repro_torch.parallel.sharding import spec_for_axes

        rows, ids = spec_for_axes(("batch", "seq"), mesh=mesh, rules=rules,
                                  dim_sizes=(batch, seq))
        if ids is not None and mesh.axis_size(ids) > 1:
            ids_bytes = 2 * (batch // mesh.axis_size(rows)) * (seq // mesh.axis_size(ids)) * 4
            add("all_gather", ids_bytes)
    return out
