#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

These paths run through the port (``src/repro_torch``): the paper's workload,
LeNet-5 with its three conv layers on the paired subtractor GEMM kernel (K1),
served on seeded weights and then trained on the card and put through the
paper's Table I and Fig. 8;
the paired LM serving path of qwen2-1.5b, every decoder GEMM on K1 and
decode attention with the paired out-projection on the decode-attention
kernel (K2); the flash-attention forward (K3) through its entry point
``flash_attention_fwd``; the hardened serving front end over the LM
engines (K1 + K2); the MoE serving paths of olmoe-1b-7b, every expert
projection of a layer one K1 launch over the expert grid (K1 + K2), and
deepseek-v2-lite-16b (MLA, shared experts; K1); and the state-space paths
of mamba2-2.7b (SSM layers; K1) and hymba-1.5b (attention beside SSM
heads, windowed decode attention with meta-token sinks; K1 + K2); the rest
of the model zoo, qwen3-4b, granite-3-2b, internvl2-2b (vision prefix),
whisper-base (encoder-decoder: its encoder's self-attention and the
cross-attention prefill on K3) and mistral-large-123b (K1 + K2, and K3);
the LM training path of qwen2-1.5b, every layer GEMM's forward on K1
under autograd (its backward ``torch.matmul``); and the MoE training path
of olmoe-1b-7b and deepseek-v2-lite-16b, every expert projection's forward
one K1 launch over the expert grid (its backward ``torch.einsum`` on the
folded experts), with the fused decode attention's VJP (K2); K1's
measured tile cache over qwen2's serving and training problems, and the
serving CLI with the JAX CLI's flags (the weights folded per column, the
cache's plans, the front end degrading to K1's dense form); the
tensor-parallel paired decode of every family on gloo ranks that share the
card (K1 on every rank); and training on such a mesh, every family, K1 on
every rank under autograd; both under FSDP too (mistral-large-123b's
``embed`` over ``data``), every mesh rank building only its own shards.
Phases,
each printing one JSON line; any failure exits non-zero and prints no
result:

1. build      — compile the three CUDA sources from ``src/repro_torch/kernels/csrc``
                (one nvcc each, in parallel): seconds, registers, spills, and
                per K1, K2 and K3 instance its registers, stack frame and
                spills (gates: K3 spills nothing and compiles 4 tensor-core
                and 6 FMA instances; K2 compiles 8 instances, none
                spilling; K1 compiles exactly the instances its plans can
                name, and its skinny form spills nothing);
2. kernel     — K1 against its plain PyTorch version on the card, in every
                form (dense, structured, blocked at bn=1 and bn=4 with a
                short last block, max2/avg2 pooling, fp32/bf16 residuals, all
                activations, ragged edges, the empty contraction P + R = 0,
                fp32 stores of bf16 operands: a tensor-parallel rank's partial
                sums at qwen2's wo and w_down slabs, ≤ 1e-5, and the bf16
                store their cast)
                at qwen2's decode and prefill rows and at olmoe's expert grid
                (64 blocks of 1024 or 2048 columns; ``kernels/k1_cases.py``):
                fp32 ≤ 1e-5 relative to the largest output, bf16 ≤ 2 output
                ulps of the fp32 oracle, a second launch bit-identical; each
                row prints its launch plan (``kernels/tuning.py``);
3. decode_attention — K2 against its plain version, bare and fused, fp32
                and bf16: G ∈ {1, 6, 48}, D ∈ {64, 128, 256} (G = 48 at
                D = 256 cuts the heads into groups and the lanes into
                chunks), S not a multiple of the 32-key tile, slots at 0 /
                mid-cache / S−1, the serve engine's
                shape (S 256, slots at 8-51), windows with and without
                sinks, structured / blocked bn=1 / bn=64 (short last block) /
                unpaired out-projections, residual present and absent,
                hymba-1.5b's swa shape (G = 5 over 5 KV heads, D 64, S 1408,
                window 1024 with 128 sinks, 1600 columns, no residual): fp32
                ≤ 2e-5 relative, bf16 ≤ 2 output ulps (the fused form
                against the plain projection of the bare kernel's bf16
                rows: see fused_decode_attention_plain), a second launch
                bit-identical; each row prints its launch plan
                (``kernels/tuning.py`` ``k2_plan``, which lays out the
                kernel's shared memory);
4. flash_attention — K3 through ``flash_attention_fwd`` against
                ``flash_attention_plain``, fp32 and bf16: the CPU parity
                file's shapes (grid, MQA, ragged, causal and full) and
                qwen2-1.5b's heads (H 12, KH 2, D 128, B 4): causal S = 256,
                2048 and ragged 333, causal 64 × 512 (top-left), full
                200 × 512, and whisper-base's (B 1, H = KH = 8, D 64,
                full): its encoder 1500 × 1500 and cross-attention 24 ×
                1500; fp32 ≤ 1e-5 relative, bf16 ≤ 1 output ulp (whisper's
                2), all
                finite, one launch per case; device ms by CUDA graph beside
                the plain version, ``F.scaled_dot_product_attention`` and
                the bound, with the kernel's form (tensor-core or FMA) and
                its achieved TFLOP/s;
5. layers     — K1 at LeNet's shapes (1000 images, every layer and pairing
                mode) against its plain version, timed beside the plain
                version, ``F.conv2d`` on the folded weights, its
                memory/operation bound and ``read_bound_ms`` (the bytes it
                really reads, the B-fold operand, at 3.35 TB/s), with its plan;
6. serve      — LeNet's main path: seeded weights, the synthetic MNIST test
                split, pairings at r ∈ {0, 0.05} × {structured,
                column_blocked bn=4, per_column}, four requests of 1000 images
                with the pool fused and unfused: r=0 logits match
                ``F.conv2d`` ≤ 1e-5 with identical argmax; r=0.05 logits match
                the folded-weight conv; exactly 3 kernel launches per forward;
7. paper      — the paper's workload on trained weights: LeNet-5 trained by
                the port's ``get_trained_lenet`` on the card at its defaults
                (3 epochs of 20000 synthetic images, 468 steps of 128, no
                cache): wall seconds, steps/s, every loss finite, test
                accuracy ≥ 0.9 on the 4000-image split; Table I
                (``repro_torch.benchmarks.table1``) at every rounding with its
                asserts; Fig. 8 (``benchmarks.fig8``): accuracy per rounding on
                the folded weights, the six measured paired paths through K1
                (3 launches each, r = 0 ≤ 1e-5 of ``F.conv2d``), the block
                sweep at r = 0.05, the fused conv→pool counts
                (``repro_torch.analysis``: 3 launches, 0 standalone pools
                fused, 2 unfused), the r = 0.05 headline beside the paper's;
                one trained-weight request of 1000 images (per_column r = 0.05,
                pool fused) timed beside the serve phase's random-weight one,
                and K1's three launches of it against their plain versions;
8. lm_parity  — qwen2-1.5b at full width, 2 layers, fp32: the plain engine
                against the paired (column-blocked bn=64, r=0) engine with
                fused decode attention, batch 2, prompts of 5 and 11 tokens,
                6 tokens per slot: identical tokens, logits ≤ 1e-5; 5 kernel
                launches per decode layer (one fused QKV K1, one K2, three
                MLP K1: ``repro_torch.analysis.decode_launches``), counted by
                the wrappers and by ``torch.profiler``;
9. lm_serve   — qwen2-1.5b at full width and depth (28 layers), bf16,
                structured pairing at r=0.05, through the launcher's
                ``serve``: batch 4, prompts of 8/12/16/20 tokens, max_seq
                256, 32 tokens per slot; pairing seconds, prefill ms per
                request, decode ms per step, tokens/s, 7 launches per decode
                layer (3 QKV K1, one K2, 3 MLP K1: ``analysis.decode_launches``),
                a ``torch.profiler`` split
                of one decode step, and K1 (all six decoder weights, with
                their plans) and K2 timed at the serving shapes beside their
                plain versions, library calls and bounds (K2 fused and bare:
                the bare time is the attention, the rest the projection; a
                relaunch bit-identical);
10. frontend  — ``serving.frontend`` over the LM engines.  (a) chaos: full
                width, 2 layers, fp32, the lm_parity phase's paired engine
                (bn=64, r=0, fused decode attention) with an unpaired
                fallback, ``benchmarks/serving.py``'s chaos workload (30
                req/s over 0.6 virtual s, batch 4) and fault schedule: 0
                lost, every faulted request degraded or shed with a reason,
                at least one of each, and every completion token-exact
                against a fresh unpaired engine (the top-2 logit margin is
                printed at any divergence).  (b) load sweep: the lm_serve
                phase's engine (28 layers, bf16) with an unpaired fallback
                on the same weights, the same workload shape at 10, 25 and
                60 req/s: 0 lost; requests, steps, tokens, wall seconds and
                wall tokens/s (a smoke-sized functional run, a few dozen
                requests: not a throughput measurement), and the
                virtual-clock figures labelled so;
11. tile_cache — K1's measured tile cache (``kernels/tuning.py``
                ``TileCache``, ``autotune_plans``): every distinct K1 problem
                of the lm_serve engine (a prefill of 20 tokens, decode at
                batch 4), of the training step's 1024 rows (layer 0's wq,
                wk, wo, w_gate, w_down, paired and dense) and of the
                lm_parity engine (fp32, bn=64); each problem's
                ``candidate_plans`` launched on seeded operands and held to
                K1's plain version (fp32 ≤ 1e-5 relative, bf16 ≤ 2 output
                ulps), each plan's shared memory to the kernel's own, then
                timed (CUDA-graph replays) and the fastest written to
                ``.cache/tile_cache.json``: the heuristic's and the winner's
                ms beside the bound and ``torch.matmul``; then the serve
                engine over the same weights with the cache launches exactly
                the cached plans (counted by plan), and the r=0 fp32 parity
                engine with the cache gives the tokens of the one without,
                logits ≤ 1e-5; the card's name and power limit;
12. serve_cli — ``launch.serve.main`` with the flags of the JAX CLI:
                qwen2-1.5b at full width (1 layer), ``--paired-rounding
                0.05`` (the weights folded per column), ``--tile-cache``
                (the phase above's), ``--conv``/``--fuse-pool`` (no-ops),
                ``--frontend --fallback-gemm pallas --inject
                nan_logits:0.05``: 0 lost, a request degraded, the fallback
                on K1's dense form; and ``--block-k 1024``: every launch's
                K-slices at most 1024 lanes;
13. mesh_decode — tensor-parallel paired decode, ``ServeEngine(mesh=...)``
                on ranks of ``launch.mesh.spawn`` (one process each, gloo,
                all on this one card: they time-share it, so no
                tensor-parallel speed is measured).  Parity, fp32, r=0,
                seed-0 weights on every rank: qwen2-1.5b at full width, 2
                layers, column-blocked bn=16, meshes (1, 2), (1, 4) (its 2
                KV heads do not divide 4: a sequence-sharded cache, partial
                softmaxes merged) and (2, 2) (slots over the data rows);
                olmoe-1b-7b, 2 layers, structured, (1, 2) and (1, 4), a
                40-token prompt on the expert-parallel route; the other five
                families at full width, structured, (1, 2) and (1, 4):
                deepseek-v2-lite-16b (2 layers: dense, then MLA with shared
                experts; a sequence-sharded latent cache; a routed 40-token
                prompt), mamba2-2.7b (2), hymba-1.5b (3; on (1, 4) its 50
                SSM heads stay whole while its channels split), whisper-base
                (2 + 2 over 1500 stub frames) and internvl2-2b (2, 256 stub
                patches; on (2, 2) too): every rank's tokens equal the
                single-rank engine's, logits ≤ 1e-5, every weight and cache
                entry of a rank shaped as its resolved spec gives.  Served,
                bf16, structured r=0.05, (1, 2): qwen2-1.5b at 2 of its 28
                layers (batch 4, 16 tokens a slot), olmoe at 2 of its 16 and
                the five (batch 4, 16 tokens a slot) at the depths of
                ``MESH_SERVED_LAYERS``; K1 launches and collectives a decode
                step and a prefill held to ``analysis.decode_launches`` /
                ``prefill_launches`` / ``mesh_decode_collectives`` /
                ``mesh_prefill_collectives``; decode ms (median, p90 of 8
                timed steps), each
                rank's wiring seconds and peak memory; the r=0.05 ledger
                gates of ``repro_torch/benchmarks/mesh_decode.py`` (bn=16).
                It runs last, beside phase 28, on the same spawns
                (``phase_mesh``: one a mesh shape, its ranks running both
                phases' jobs, in two lanes at once), so its decode ms are
                taken while other ranks share the card.
                Every rank builds only its blocks, leaf by leaf
                from the seed, and its wiring peak is held to what it holds
                after the wiring plus two whole leaves
                (``launch.steps.wiring_excess``); deepseek's served wiring
                peak is recorded.  Under FSDP (``phase_mesh_fsdp``, right
                after the build, alone on the card): mistral-large-123b at full
                width, 1 of 88 layers, fp32, r=0, under its published
                config's decode rules on (2, 2), a prompt on each data row
                (slots 0 and 2): every rank's tokens equal
                the single-rank engine's (``torch.matmul``), logits ≤ 1e-5,
                collectives (each layer's, the embedding's and the head's
                gathers over ``data``) held to ``analysis``;
14. moe_parity — olmoe-1b-7b at full width, 2 layers, fp32: the plain
                engine (``torch.einsum`` experts, plain attention) against
                the paired one (structured, r=0; K1 + K2), batch 2, prompts
                of 11 tokens (the dense expert branch) and 24 (routed), 6
                tokens per slot: identical tokens, logits ≤ 1e-5, the routed
                prefill counted, 7 launches per decode layer (3 QKV K1, one
                K2, 3 expert K1), by the wrappers and by ``torch.profiler``;
15. moe_serve — olmoe-1b-7b at full width, 4 of its 16 layers since PR 27
                (the script's time limit), bf16, structured r=0.05, through
                ``launch.serve.serve``:
                batch 4, prompts of 12/16 (dense branch) and 24/64 tokens
                (routed: two prefills each dispatch in every layer), max_seq
                256, 32 tokens per slot; pairing seconds and pair fraction,
                prefill ms per request, decode ms per step (median, p90),
                tokens/s, 7 launches per decode layer, a ``torch.profiler``
                split of one decode step, and K1 at the three expert-grid
                shapes of layer 0 (gate on shared decode rows, down on
                per-expert decode rows, gate on a routed prompt's capacity
                rows) against its plain version and timed beside it,
                ``torch.einsum`` on the folded experts and the bound; K2 at
                olmoe's G = 1 heads;
16. mla_parity, 17. mla_serve — deepseek-v2-lite-16b the same way (2
                layers: dense, MoE; then 3 of its 27 since PR 27), K1 at its
                new shapes,
                peak device memory and its reckoning;
18. ssm_parity — mamba2-2.7b at full width, 2 layers, fp32: the plain
                engine against the paired one (structured, r=0), prompts
                of 11 and 300 tokens (300 crosses the 256-token chunk),
                6 tokens a slot: identical tokens, logits, state and conv
                tails ≤ 1e-5, launches of the prefills and of a decode step
                (6 K1 a layer, no K2) by the wrappers and the profiler;
19. ssm_serve — mamba2-2.7b at 8 of its 64 layers since PR 27, bf16,
                structured r=0.05:
                batch 4, prompts 12/16/24/300, max_seq 512, 32 tokens a
                slot; what moe_serve records, K1 timed at w_x, w_B, w_dt,
                w_out, peak memory;
20. hybrid_parity — hymba-1.5b, 3 layers (full, swa, swa), fp32, r=0,
                prompts of 11 and 1200 tokens (the window of 1024 drops
                keys past the 128 meta-token sinks in the prefill and the
                decode): ssm_parity's gates, the K/V caches too (12 K1 and
                one K2 a layer);
21. hybrid_serve — hymba-1.5b at 16 of its 32 layers (full, swa, full), bf16,
                r=0.05: batch 4,
                prompts 12/16/24/1200, max_seq 1280; ssm_serve's record,
                K1 at hymba's GEMMs, its K2 launches by window and sinks
                (every windowed one on a slot whose window drops keys), K2
                at layer 1 (swa) fused and bare against its plain version,
                its bound and SDPA + ``torch.matmul`` under the same mask;
22. zoo_parity — qwen3-4b, granite-3-2b, internvl2-2b, whisper-base and
                mistral-large-123b at full width, 2 layers (whisper 2 + 2
                over its 1500 stub frames; mistral 1 since PR 27), fp32,
                r=0: ssm_parity's gates
                (tokens identical; logits and every cache entry, whisper's
                cross-attention ``xk``/``xv`` too, ≤ 1e-5), internvl2's
                prompts of 260 and 300 tokens after its 256 stub patches,
                the others' 11 and 24; the prefills' launches held to
                ``analysis.prefill_launches`` (whisper's K3: one an encoder
                layer and one a decoder layer's cross-attention);
23. zoo_serve — the same five at full width, whisper at its published
                depth (6 + 6), internvl2 at 4 of 24, qwen3 at 2 of 36 and
                granite at 2 of 40, mistral-large-123b at 1 of
                its 88 (123
                G parameters are 246 GB in bf16), bf16, structured r=0.05,
                batch 4, 32 tokens a
                slot: ssm_serve's record, K1 at qwen3's wq, mistral's w_gate
                and w_down and whisper's cross wq/wo (4 rows), K2 at layer 0
                of each, whisper's K3 launches a prefill;
24. lm_train_parity — qwen2-1.5b at full width, 2 layers, fp32, r=0,
                batch 8 × seq 128: ``lm_loss`` and the gradient of every
                weight under gemm="pallas" (K1's dense form), "pallas_paired"
                structured and column-blocked at bn=64 against gemm="xla"
                (loss ≤ 1e-5 relative, gradients within rtol 1e-4, atol
                1e-5); K1 launches a step equal to ``analysis.train_launches``
                under remat "full" and "none"; 4 AdamW steps from the same
                init, xla against pallas_paired, within 1e-5; K1's
                differentiable GEMMs (``ops.fused_dense``,
                ``ops.fused_paired_dense`` structured and blocked) against
                their plain versions forward and backward (≤ 1e-5, one launch
                forward, none backward);
25. lm_train  — qwen2-1.5b at full width, 4 of its 28 layers since PR 27
                (the script's time limit), trained
                through ``launch.train.train``: bf16 compute, fp32 masters,
                structured r=0.05 (``pair_lm_params``), remat "full", batch
                8 × seq 128, AdamW 3e-4 with the cosine schedule, 5 steps,
                a checkpoint at step 3 (``build/lm_train_ckpt``, removed at
                the end): every metric finite, the last loss below the first,
                K1 launches a step equal to ``train_launches``, and the run
                resumed from step 3 giving steps 4–5's losses (≤ 1e-5, and
                whether bit-identical); pairing seconds, ms a step (median of
                steps 2–5), tokens/s, a profiled step (busy, idle share, K1
                ms and launches, the library GEMMs' ms: the backward's and
                the head's ``torch.matmul``), peak memory; K1 timed at 1024
                rows on layer 0's wq, wk, wo, w_gate and w_down, paired and
                dense, beside its plain version, ``torch.matmul`` on the
                folded weight, its bound and its plan;
26. moe_train_parity — olmoe-1b-7b and deepseek-v2-lite-16b at full width,
                2 layers (deepseek's: its dense first layer, one MoE layer),
                fp32, r=0: ``lm_loss``, the router's aux loss and every
                weight's gradient under "pallas_paired" structured and
                column-blocked at bn=64 against gemm="xla" (``torch.einsum``
                experts), on the routed branch (batch 8 × seq 128) and the
                dense one (2 × 8 tokens: T·K ≤ 2E), lm_train_parity's
                tolerances; K1 launches a step equal to ``train_launches``
                under remat "full" and "none"; ``ops.fused_attn_decode`` at
                qwen2-1.5b's decode shapes (fp32, structured r=0.05 with the
                residual): its output and the gradients of q, the caches, w
                and the residual against autograd of the plain composition,
                one K2 launch forward, none backward;
27. moe_train — olmoe-1b-7b at full width, 6 of its 16 layers (16 layers of
                fp32 masters, gradients and Adam moments would not fit one
                card), through ``launch.steps.build_train_step`` and
                ``train.optimizer.adamw`` as the training CLI sets them: bf16
                compute, fp32 masters, structured r=0.05, remat "full", batch
                8 × seq 128, 6 steps: every metric finite, the last loss
                below the first, K1 launches = 6 × ``train_launches`` and a
                profiled step's = ``train_launches``; pairing seconds, ms a
                step (median of steps 2–6), tokens/s, the profiled step (busy,
                idle share, K1 ms and launches, library GEMMs, index
                kernels), peak memory beside its reckoning (16 bytes a
                parameter); K1 timed on layer 0's gate, up and down over the
                expert grid at the step's routed rows (160 an expert) beside
                its plain version, ``torch.einsum`` on the folded experts
                and its bound; the device ms of the expert fold and of its
                backward (the index kernels the expert grid's backward adds);
28. mesh_train — the training mesh (``launch.steps.build_train_step``
                with a mesh; the train CLI's ``--mesh``) on ranks of
                ``launch.mesh.spawn`` (gloo, all on this one card: no
                tensor-parallel speed is measured).  Parity, fp32, r=0,
                ``pallas_paired``, seed-0 weights on every rank, one AdamW
                step (lr 1e-4, eps 1e-6) on batch 8 × seq 128 (internvl2:
                384, past its 256 patch positions) of seeded random tokens
                and seeded random frames or patches
                (``benchmarks.mesh_train.smoke_batches``), every model at
                full width, 2 layers: qwen2-1.5b on (1, 2), (2, 1), (2, 2)
                and (1, 4), olmoe-1b-7b on (1, 2) and (2, 2),
                deepseek-v2-lite-16b (its dense layer 0 and an MoE layer with
                shared experts), mamba2-2.7b, hymba-1.5b (full layer 0,
                windowed layer 1, 128 meta tokens), whisper-base (2 + 2
                layers over 1500 frames) and internvl2-2b on (1, 2),
                deepseek and internvl2 on (2, 2), hymba on (1, 4) (its 50
                SSM heads whole over split channels): every rank's loss,
                xent, aux and gradients, shard by shard, within
                rtol 1e-4 / atol 1e-5 of the single-rank ``TrainStep``'s
                (run in this process, saved under ``build/``, off the card
                before a rank that reads them starts); r=0.05 (structured, per-shard pairing) against
                its fold oracle, qwen2 on (1, 2) and (2, 2), deepseek and
                hymba on (1, 2); collectives (calls and bytes) and K1
                launches a step equal to ``analysis.mesh_train_collectives``
                and ``train_launches``.
                Trained on (1, 2) through the CLI's
                ``launch.train.train_rank`` (bf16, fp32 masters, structured
                r=0.05, remat full, 3 steps; in a spawn of their own, last in
                the first lane):
                qwen2-1.5b at 2 of its 28
                layers and deepseek-v2-lite-16b at 2 of its 27 (the dense
                layer 0 and an MoE layer): finite losses, K1
                launches and collectives a step held to ``analysis``, ms a
                step, peak memory and wiring seconds per rank.  Resume:
                qwen2 at 2 layers, fp32, saved on (1, 2) at step 2 and
                resumed on (2, 1): step 3's loss ≤ 1e-5 of the straight
                run's.  K1 at a rank's training shards of qwen2's
                layer 0 (wq and w_gate at half their columns, wo and w_down
                at half their rows; 1024 rows, bf16, structured r=0.05)
                beside ``torch.matmul`` on the folded shard and the bound.
                Every job's wiring peak held as in phase 13.  Under FSDP
                (``phase_mesh_fsdp``, right after the build, its ranks alone
                on the card):
                mistral-large-123b at full width, 1 of 88 layers, under its
                published config's train rules (``embed`` over ``data``):
                parity on (2, 2) ((2, 1)'s in the CPU tests, for the time
                limit; fp32, r=0, remat full as in the trained run, one
                AdamW step, batch 8 × seq 128): every rank's loss, gradients and updated
                weights, block by block, within rtol 1e-4 / atol 1e-5 of the
                single-rank step's (``torch.matmul``, saved under ``build/``),
                a NaN failing; trained on (2, 2) (bf16, fp32 masters,
                structured r=0.05, remat full, 2 steps): equal finite losses on every
                rank, ms a step, peak memory and bytes held a rank beside
                the reckoning; collectives (calls and bytes) and K1
                launches held to ``analysis`` with the FSDP rules;
29. the kernels table, the card's name and power limit, and the ``ok`` line.
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path


# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 FMA-unit FLOP/s and
# dense bf16 tensor-core FLOP/s.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
FP32_RTOL = 1e-5
ATTN_RTOL = 2e-5  # the JAX decode-attention tests' tolerance
BF16_MAX_ULPS = 2.0
REQUESTS, REQUEST_IMAGES = 4, 1000
MODES = (("structured", 0), ("column_blocked", 4), ("per_column", 1))
ROUNDINGS = (0.0, 0.05)
HEADLINE = ("per_column", 0.05)  # the paper's own pairing at its headline rounding

failures: list[str] = []


_T0 = time.perf_counter()


def emit(obj: dict) -> None:
    """Print one JSON line; a phase's line also gets ``at_s``, the script's
    wall seconds when it was printed."""
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - _T0}
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        failures.append(what)


def graph_ms(fn, reps: int = 10, replays: int = 5) -> float:
    """Device time of one ``fn()``: ``reps`` calls captured in a CUDA graph,
    replayed ``replays`` times between CUDA events (no host overhead)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def request_stats(fn, n: int = 40, warmup: int = 3) -> dict:
    """Per-call wall times on the card's clock: median, p75 (the highest
    percentile with at least ten samples above it) and max, over ``n``."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return {"median": times[n // 2], "p75": times[(3 * n) // 4 - 1], "max": times[-1], "n": n}


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------


def phase_build() -> dict:
    import re

    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paired_matmul as pm
    from repro_torch.kernels import tuning

    t0 = time.perf_counter()
    infos = _build.build_all()  # one nvcc per source, in parallel
    pm._kernel()  # load the libraries and bind their entry points
    da._kernel()
    fa._kernel()
    sources, k1_instances = {}, []
    func = None
    for line in infos["paired_matmul"]["log"].splitlines():  # -Xptxas -v, per kernel
        if m := re.search(r"Compiling entry function '\w*paired_matmul_kernel_(skinny|tall)"
                          r"I(\w+?)EEv\w*'", line):
            func = {"form": m.group(1), "template": m.group(2)}
        elif func and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                                      r"(\d+) bytes spill loads", line)):
            func["stack_bytes"] = int(m.group(1))
            func["spill_bytes"] = int(m.group(2)) + int(m.group(3))
        elif func and (m := re.search(r"Used (\d+) registers", line)):
            func["registers"] = int(m.group(1))
            k1_instances.append(func)
            func = None
    def instances(log: str, kernel: str) -> list[dict]:
        """Registers, stack and spills of each compiled instance of ``kernel``
        (its mangled template arguments name it)."""
        found, cur = [], None
        for line in log.splitlines():
            if m := re.search(rf"Compiling entry function '\w*?{kernel}(\w*?)I(\w+?)EEv\w*'", line):
                cur = {"kernel": kernel + m.group(1), "template": m.group(2)}
            elif cur and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                                         r"(\d+) bytes spill loads", line)):
                cur["stack_bytes"] = int(m.group(1))
                cur["spill_bytes"] = int(m.group(2)) + int(m.group(3))
            elif cur and (m := re.search(r"Used (\d+) registers", line)):
                cur["registers"] = int(m.group(1))
                found.append(cur)
                cur = None
        return found

    k2_instances = instances(infos["decode_attention"]["log"], "decode_attention_kernel")
    k3_instances = instances(infos["flash_attention"]["log"], "flash_attention_kernel")
    if infos["decode_attention"]["built"]:
        # (fp32, bf16 inputs) x (fp32, bf16 output) x (16-byte vectors, single columns)
        check(len(k2_instances) == 8, f"decode_attention instances: {k2_instances}")
        check(all(f.get("spill_bytes", 1) == 0 for f in k2_instances),
              f"decode_attention spills: {k2_instances}")
    if infos["flash_attention"]["built"]:
        tc = [f for f in k3_instances if f["kernel"].endswith("_tc")]
        check(len(tc) == 4 and len(k3_instances) == 10,  # tc D 16-128; fma fp32 x 5 D, bf16 D 8
              f"flash_attention instances: {k3_instances}")
        check(all(f.get("spill_bytes", 1) == 0 for f in tc),
              f"flash_attention tensor-core form spills: {tc}")
    for name, info in infos.items():
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", info["log"])]
        spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", info["log"])]
        sources[name] = {
            "seconds": info["seconds"], "built": info["built"],
            "kernels_compiled": len(regs), "max_registers": max(regs, default=None),
            "spill_bytes": sum(spills),
        }
    if infos["flash_attention"]["built"]:
        check(sources["flash_attention"]["spill_bytes"] == 0,
              f"flash_attention spills {sources['flash_attention']['spill_bytes']} bytes")
    if infos["paired_matmul"]["built"]:
        # the instances the plans can name (kernels/tuning.py), and no other
        n_skinny = sum(len(shapes) for shapes in tuning.SKINNY_SHAPES.values())
        n_tall = 2 * 2 * len(tuning.TALL_TN)  # fp32 / bf16 x pool window 1 / 4
        skinny = [f for f in k1_instances if f["form"] == "skinny"]
        check(len(skinny) == n_skinny and len(k1_instances) == n_skinny + n_tall,
              f"paired_matmul instances: {len(skinny)} skinny of {len(k1_instances)}")
        check(all(f.get("spill_bytes", 0) == 0 for f in skinny),
              f"paired_matmul skinny form spills: {skinny}")
    out = {
        "phase": "build",
        "seconds": time.perf_counter() - t0,
        "nvcc": _build.nvcc_version(),
        "sources": sources,
        "paired_matmul_instances": k1_instances,
        "decode_attention_instances": k2_instances,
        "flash_attention_instances": k3_instances,
    }
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase 2: K1 against its plain version, every form
# ---------------------------------------------------------------------------


def phase_kernel() -> dict:
    import dataclasses
    import functools

    import torch

    from repro_torch.kernels import paired_matmul as pm
    from repro_torch.kernels.k1_cases import k1_cases
    from repro_torch.kernels.ref import bf16_ulps, rel_err

    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    cases = [(name, blocked, M, P, R, N, pool, act, getattr(torch, dt),
              res_dt and getattr(torch, res_dt))
             for name, blocked, M, P, R, N, pool, act, dt, res_dt in k1_cases()]
    f32 = torch.float32

    results, max_abs, max_rel, max_ulps = [], 0.0, 0.0, 0.0
    for name, blocked, M, P, R, N, pool, act, dt, res_dt in cases:
        W = (4,) if pool != "none" else ()
        if blocked:
            B, bn, n_cols = N
            x = rnd(B, *W, M, 2 * P + R, dtype=dt)
            kmat, w_res = rnd(B, P, bn, dtype=dt), rnd(B, R, bn, dtype=dt)
            kmat[-1, :, n_cols - (B - 1) * bn:] = 0  # the short block's padded columns
            w_res[-1, :, n_cols - (B - 1) * bn:] = 0
        else:
            n_cols = N
            x = rnd(*W, M, 2 * P + R, dtype=dt)
            if name.startswith("act_"):
                x = x * 0.1
            kmat, w_res = rnd(P, N, dtype=dt), rnd(R, N, dtype=dt)
        bias = rnd(n_cols)
        residual = None if res_dt is None else rnd(M, n_cols, dtype=res_dt)
        kw = dict(residual=residual, activation=act, pool=pool)
        if blocked:
            launch = functools.partial(pm.paired_matmul_blocked_cuda, x, kmat, w_res, bias,
                                       n_cols=n_cols, **kw)
            got = launch()
            want = pm.paired_matmul_blocked_plain(
                x, kmat, w_res, bias, n_cols=n_cols, out_dtype=torch.float32, **kw
            )
        elif name.startswith("dense"):
            launch = functools.partial(pm.dense_matmul_cuda, x, w_res, bias, residual=residual,
                                       activation=act)
            got = launch()
            want = pm.paired_matmul_plain(x, kmat, w_res, bias, out_dtype=torch.float32, **kw)
        else:
            launch = functools.partial(pm.paired_matmul_cuda, x, kmat, w_res, bias, **kw)
            got = launch()
            want = pm.paired_matmul_plain(x, kmat, w_res, bias, out_dtype=torch.float32, **kw)
        torch.cuda.synchronize()
        plan = pm.launch_plan(x, kmat, w_res, pool)
        row = {"case": name, "dtype": str(dt).removeprefix("torch."), "shape": list(got.shape),
               "plan": dataclasses.asdict(plan)}
        # the planner's model of the kernel's shared memory is the kernel's own
        smem = pm.kernel_smem(plan, P, R, 4 if pool != "none" else 1, x.element_size())
        check(smem == plan.smem, f"kernel {name}: plan smem {plan.smem}, kernel's {smem}")
        # one launch is deterministic: a second one gives the same bits
        check(torch.equal(launch(), got), f"kernel {name} {row['dtype']}: two launches differ")
        if dt == f32:
            row["rel_err"] = rel_err(got, want)
            row["max_abs_err"] = float((got - want).abs().max())
            max_abs = max(max_abs, row["max_abs_err"])
            max_rel = max(max_rel, row["rel_err"])
            check(row["rel_err"] <= FP32_RTOL, f"kernel {name} fp32 rel err {row['rel_err']:.3g}")
        else:
            row["ulps"] = bf16_ulps(got, want)
            max_ulps = max(max_ulps, row["ulps"])
            check(row["ulps"] <= BF16_MAX_ULPS, f"kernel {name} bf16 {row['ulps']:.3g} ulps")
        check(bool(torch.isfinite(got).all()), f"kernel {name} non-finite output")
        results.append(row)
    # fp32 stores of bf16 operands (out_dtype): a tensor-parallel rank's
    # partial sums, qwen2-1.5b's row-parallel wo and w_down slabs at (1, 2)
    # (K 768 and 4480 a rank, r=0.05-like splits), decode rows and a prompt's,
    # the skip connection fused, structured and column-blocked bn=16
    bf16 = torch.bfloat16
    for name, M, P, R, N, blocked in (("wo_slab", 4, 300, 168, 1536, False),
                                      ("w_down_slab", 4, 2000, 480, 1536, False),
                                      ("wo_slab_prompt", 24, 300, 168, 1536, False),
                                      ("w_down_slab_blocked16", 4, 1800, 880, 1536, True)):
        residual = rnd(M, N, dtype=bf16)
        if blocked:
            B = N // 16
            x, kmat, w_res = rnd(B, M, 2 * P + R, dtype=bf16), rnd(B, P, 16, dtype=bf16), \
                rnd(B, R, 16, dtype=bf16)
            launch = functools.partial(pm.paired_matmul_blocked_cuda, x, kmat, w_res, n_cols=N,
                                       residual=residual)
            want = pm.paired_matmul_blocked_plain(x, kmat, w_res, n_cols=N, residual=residual,
                                                  out_dtype=f32)
        else:
            x, kmat, w_res = rnd(M, 2 * P + R, dtype=bf16), rnd(P, N, dtype=bf16), \
                rnd(R, N, dtype=bf16)
            launch = functools.partial(pm.paired_matmul_cuda, x, kmat, w_res, residual=residual)
            want = pm.paired_matmul_plain(x, kmat, w_res, residual=residual, out_dtype=f32)
        got = launch(out_dtype=f32)
        torch.cuda.synchronize()
        row = {"case": f"fp32_partial_{name}", "dtype": "bfloat16->float32",
               "shape": list(got.shape), "rel_err": rel_err(got, want),
               "max_abs_err": float((got - want).abs().max())}
        check(got.dtype == f32 and row["rel_err"] <= FP32_RTOL,
              f"kernel fp32 partial {name}: {got.dtype}, rel err {row['rel_err']:.3g}")
        check(torch.equal(launch(), got.to(bf16)),
              f"kernel fp32 partial {name}: the bf16 store is not the fp32 store's cast")
        max_abs, max_rel = max(max_abs, row["max_abs_err"]), max(max_rel, row["rel_err"])
        results.append(row)
    out = {
        "phase": "kernel",
        "cases": len(results),
        "fp32_max_rel_err": max_rel,
        "fp32_max_abs_err": max_abs,
        "bf16_max_ulps": max_ulps,
        "tolerance": {"fp32_rel": FP32_RTOL, "bf16_ulps": BF16_MAX_ULPS},
        "results": results,
    }
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase 3: K2 against its plain version
# ---------------------------------------------------------------------------


def _outproj_segments(w2, rounding: float, block_n):
    """The decode kernel's out-projection segments of ``w2`` (K, N): paired
    per ``block_n`` columns (0 → structured), or unpaired (None)."""
    import torch

    from repro_torch.core.pairing import pair_rows_blocked, pair_rows_structured
    from repro_torch.core.transform import _stack_blocked, _stack_structured
    from repro_torch.kernels import ops

    if block_n is None:
        return ops.attn_outproj_segments(w2, None)
    w64 = w2.double().cpu().numpy()
    if block_n:
        stacked = _stack_blocked([pair_rows_blocked(w64, rounding, block_n)])
    else:
        stacked = _stack_structured([pair_rows_structured(w64, rounding)])
    meta = {k: torch.as_tensor(v[0], device=w2.device) for k, v in stacked.items()}
    meta.update({k: meta[k].long() for k in ("I", "J", "resid")})
    return ops.attn_outproj_segments(w2, meta, block_n)


def phase_decode_attention() -> dict:
    import dataclasses

    import torch

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels.ref import bf16_ulps, rel_err

    gen = torch.Generator(device="cuda").manual_seed(1)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    B = 4
    # (name, G, KH, D, S, window, n_sink, out-projection block_n (0
    #  structured, None unpaired), N, residual, slot positions)
    cases = [
        ("qwen_heads_structured", 6, 2, 128, 300, 0, 0, 0, 1536, True, (0, 150, 299, 5)),
        # the serve engine's shape: max_seq 256, slots after prompts of 8-20
        # tokens and up to 32 decode steps
        ("qwen_serving_shape", 6, 2, 128, 256, 0, 0, 0, 1536, True, (8, 23, 37, 51)),
        ("mha_bn64_short_block", 1, 2, 64, 77, 0, 0, 64, 1000, False, (0, 38, 76, 5)),
        ("window_bn1", 6, 2, 64, 77, 16, 0, 1, 200, True, (0, 38, 76, 5)),
        ("window_sink_unpaired", 1, 2, 128, 300, 40, 4, None, 700, True, (0, 150, 299, 5)),
        ("window_sink_structured", 6, 2, 128, 77, 16, 3, 0, 320, False, (0, 38, 76, 5)),
        # G = 48 at D = 256: the plan cuts the heads into groups and the
        # block's 24576 lanes into chunks
        ("wide_heads_grouped", 48, 2, 256, 300, 0, 0, 0, 300, True, (0, 150, 299, 5)),
        # hymba-1.5b's swa layers: 25 heads over 5 KV heads (G = 5, odd KH),
        # D 64, the cache of max_seq 1280 + 128 meta rows, window 1024 with
        # the 128 meta tokens as sinks, 1600 columns and no residual; slots
        # whose window drops keys (1359, 1200), one inside it, one at 0
        ("hymba_swa_g5", 5, 5, 64, 1408, 1024, 128, 0, 1600, False, (1359, 1200, 500, 0)),
    ]
    results, max_abs, max_rel, max_ulps = [], 0.0, 0.0, 0.0
    for name, G, KH, D, S, window, n_sink, block_n, N, has_res, slots in cases:
        H = G * KH
        # weights of std 0.1 against r=0.3: 94-99% of lanes pair in every mode
        seg = _outproj_segments(rnd(H * D, N) * 0.1, 0.3, block_n)
        q, kc, vc, res = rnd(B, 1, H, D), rnd(B, S, KH, D), rnd(B, S, KH, D), rnd(B, N)
        pos = torch.tensor(slots, dtype=torch.int32, device="cuda")
        kw = dict(window=window, n_sink=n_sink)
        for dt in (torch.float32, torch.bfloat16):
            q_, kc_, vc_ = q.to(dt), kc.to(dt), vc.to(dt)
            proj = (seg.idx_i, seg.idx_j, seg.idx_r, seg.kmat.to(dt), seg.w_res.to(dt),
                    res.to(dt) if has_res else None)
            bare = da.decode_attention_cuda(q_, kc_, vc_, pos, **kw)
            fused = da.fused_decode_attention_cuda(q_, kc_, vc_, pos, *proj, n_cols=N, **kw)
            Bw, P, bn = seg.kmat.shape
            R = seg.w_res.shape[1]
            plans = {"bare": da.launch_plan(q_, kc_),
                     "fused": da.launch_plan(q_, kc_, N, bn, P, R)}
            # the cluster merges its partials in rank order: a second launch
            # gives the same bits
            check(torch.equal(da.decode_attention_cuda(q_, kc_, vc_, pos, **kw), bare)
                  and torch.equal(da.fused_decode_attention_cuda(q_, kc_, vc_, pos, *proj,
                                                                 n_cols=N, **kw), fused),
                  f"decode_attention {name} {dt}: two launches differ")
            f32 = dict(out_dtype=torch.float32)
            forms = {
                "bare": (bare, da.decode_attention_plain(q_, kc_, vc_, pos, **kw, **f32)),
                # bf16: the projection of the kernel's own rounded rows (see
                # fused_decode_attention_plain); fp32: the whole plain version
                "fused": (fused, da.outproj_plain(bare, *proj, n_cols=N, **f32)
                          if dt == torch.bfloat16 else
                          da.fused_decode_attention_plain(q_, kc_, vc_, pos, *proj, n_cols=N,
                                                          **kw, **f32)),
            }
            torch.cuda.synchronize()
            for form, (got, want) in forms.items():
                row = {"case": name, "form": form, "dtype": str(dt).removeprefix("torch."),
                       "shape": list(got.shape), "plan": dataclasses.asdict(plans[form])}
                label = f"decode_attention {name} {form} {row['dtype']}"
                if dt == torch.float32:
                    row["rel_err"] = rel_err(got, want)
                    row["max_abs_err"] = float((got - want).abs().max())
                    max_abs, max_rel = max(max_abs, row["max_abs_err"]), max(max_rel, row["rel_err"])
                    check(row["rel_err"] <= ATTN_RTOL, f"{label} rel err {row['rel_err']:.3g}")
                else:
                    row["ulps"] = bf16_ulps(got, want)
                    max_ulps = max(max_ulps, row["ulps"])
                    check(row["ulps"] <= BF16_MAX_ULPS, f"{label} {row['ulps']:.3g} ulps")
                check(bool(torch.isfinite(got).all()), f"{label} non-finite output")
                results.append(row)
    out = {
        "phase": "decode_attention", "cases": len(results),
        "fp32_max_rel_err": max_rel, "fp32_max_abs_err": max_abs, "bf16_max_ulps": max_ulps,
        "tolerance": {"fp32_rel": ATTN_RTOL, "bf16_ulps": BF16_MAX_ULPS},
        "results": results,
    }
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase 4: K3 through its entry point, against its plain version
# ---------------------------------------------------------------------------

K3_RTOL, K3_BF16_ULPS = 1e-5, 1.0
K3_BF16_ULPS_WHISPER = 2.0  # whisper's shapes (1500 keys a row)


def _flash_bound(B, Sq, Sk, H, KH, D, causal, itemsize, flop_per_s):
    """Bytes (q, k, v read once, the output written once), the FLOP of the
    (query, key) pairs the mask admits (4·D each: QK and PV), and the least
    time of each at the card's peaks."""
    pairs = sum(min(i + 1, Sk) for i in range(Sq)) if causal else Sq * Sk
    nbytes = (2 * B * Sq * H * D + 2 * B * Sk * KH * D) * itemsize
    flops = 4 * B * H * D * pairs
    return nbytes, flops, nbytes / HBM_BYTES_PER_S * 1e3, flops / flop_per_s * 1e3


def phase_flash_attention() -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import bf16_ulps, rel_err

    gen = torch.Generator(device="cuda").manual_seed(4)
    # (name, B, Sq, Sk, H, KH, D, causal): tests/test_torch_flash_attention.py's
    # shapes, then qwen2-1.5b's heads at batch 4
    cases = [(f"{name}_{'causal' if causal else 'full'}", *shape, causal)
             for causal in (True, False) for name, shape in (
                 ("grid_64x64", (2, 64, 64, 4, 2, 16)), ("grid_128x128", (1, 128, 128, 2, 2, 32)),
                 ("mqa_32x32", (2, 32, 32, 4, 1, 8)), ("ragged_37x53", (2, 37, 53, 4, 2, 16)),
                 ("ragged_17x64", (2, 17, 64, 4, 2, 16)), ("ragged_64x21", (2, 64, 21, 4, 2, 16)),
                 ("bf16_64x64", (1, 64, 64, 2, 2, 32)))]
    qwen = [("qwen_causal_256", 4, 256, 256, 12, 2, 128, True),
            ("qwen_causal_2048", 4, 2048, 2048, 12, 2, 128, True),
            ("qwen_causal_ragged_333", 4, 333, 333, 12, 2, 128, True),
            ("qwen_causal_64x512", 4, 64, 512, 12, 2, 128, True),
            ("qwen_full_200x512", 4, 200, 512, 12, 2, 128, False),
            # whisper-base's encoder (one request: 1500 frames, not a multiple
            # of the 64-key tile) and its cross-attention prefill (24 tokens)
            ("whisper_encoder_1500", 1, 1500, 1500, 8, 8, 64, False),
            ("whisper_cross_24x1500", 1, 24, 1500, 8, 8, 64, False)]
    inputs = {}
    results, max_abs, max_rel, max_ulps = [], 0.0, 0.0, 0.0
    fa.reset_launches()  # the entry point's own count from here
    for name, B, Sq, Sk, H, KH, D, causal in cases + qwen:
        base = [torch.randn(*shape, generator=gen, device="cuda")
                for shape in ((B, Sq, H, D), (B, Sk, KH, D), (B, Sk, KH, D))]
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = (t.to(dt) for t in base)
            inputs[name, dt] = (q, k, v)
            got = fa.flash_attention_fwd(q, k, v, causal=causal)
            want = fa.flash_attention_plain(q, k, v, causal=causal, out_dtype=torch.float32)
            torch.cuda.synchronize()
            row = {"case": name, "dtype": str(dt).removeprefix("torch."),
                   "shape": [B, Sq, Sk, H, KH, D], "causal": causal}
            label = f"flash_attention {name} {row['dtype']}"
            if dt == torch.float32:
                row["rel_err"] = rel_err(got, want)
                row["max_abs_err"] = float((got - want).abs().max())
                max_abs, max_rel = max(max_abs, row["max_abs_err"]), max(max_rel, row["rel_err"])
                check(row["rel_err"] <= K3_RTOL, f"{label} rel err {row['rel_err']:.3g}")
            else:
                row["ulps"] = bf16_ulps(got, want)
                max_ulps = max(max_ulps, row["ulps"])
                gate = K3_BF16_ULPS_WHISPER if name.startswith("whisper") else K3_BF16_ULPS
                check(row["ulps"] <= gate, f"{label} {row['ulps']:.3g} ulps")
            check(bool(torch.isfinite(got.float()).all()) and got.dtype == dt
                  and got.shape == q.shape, f"{label}: bad output")
            results.append(row)
    launches = fa.launch_count()
    check(launches == len(results), f"flash_attention launched {launches} times "
                                     f"for {len(results)} cases")

    # device times at qwen2's shapes (CUDA graphs; these launches are not the
    # path's), bf16 rows and the fp32 S = 2048 row
    timed = []
    for name, B, Sq, Sk, H, KH, D, causal in qwen:
        for dt in (torch.bfloat16,) + ((torch.float32,) if Sq in (2048, 1500) else ()):
            q, k, v = inputs[name, dt]
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            peak = BF16_FLOP_PER_S if dt == torch.bfloat16 else FP32_FLOP_PER_S
            nbytes, flops, t_bytes, t_ops = _flash_bound(B, Sq, Sk, H, KH, D, causal,
                                                          q.element_size(), peak)
            ms = graph_ms(lambda q=q, k=k, v=v, c=causal: fa.flash_attention_fwd(q, k, v, causal=c))
            timed.append({
                "case": name, "dtype": str(dt).removeprefix("torch."),
                "form": fa.kernel_form(dt, D), "ms": ms,
                "plain_ms": graph_ms(lambda q=q, k=k, v=v, c=causal:
                                     fa.flash_attention_plain(q, k, v, causal=c)),
                "library_ms": graph_ms(lambda qt=qt, kt=kt, vt=vt, c=causal:
                                       F.scaled_dot_product_attention(qt, kt, vt, is_causal=c,
                                                                      enable_gqa=True)),
                "bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bound_fp32_fma_ms": max(t_bytes, flops / FP32_FLOP_PER_S * 1e3),
                "kernel_over_bound": ms / max(t_bytes, t_ops),
                "achieved_tflop_s": flops / ms / 1e9,
            })
    out = {
        "phase": "flash_attention", "cases": len(results), "main_path_launches": launches,
        "fp32_max_rel_err": max_rel, "fp32_max_abs_err": max_abs, "bf16_max_ulps": max_ulps,
        "tolerance": {"fp32_rel": K3_RTOL, "bf16_ulps": K3_BF16_ULPS},
        "library_call": "F.scaled_dot_product_attention(is_causal, enable_gqa=True)",
        "timed": timed, "results": results,
    }
    emit(out)
    return out


# ---------------------------------------------------------------------------
# main-path set-up
# ---------------------------------------------------------------------------


def setup():
    import torch

    from repro_torch.core.transform import build_conv_pairings
    from repro_torch.data.mnist import load_mnist, pad_to_32
    from repro_torch.kernels.paired_conv import folded_conv_weight
    from repro_torch.models.lenet import LENET_CONV_POSITIONS, init_lenet

    t0 = time.perf_counter()
    params = init_lenet(0)  # the entry points default to the card
    images, labels, source = load_mnist("test", synthetic_n=REQUESTS * REQUEST_IMAGES, seed=0)
    images = pad_to_32(images)[: REQUESTS * REQUEST_IMAGES]
    labels = labels[: REQUESTS * REQUEST_IMAGES]
    t_data = time.perf_counter() - t0
    pairings, folded = {}, {}
    t0 = time.perf_counter()
    for r in ROUNDINGS:
        for mode, bn in MODES:
            pr = build_conv_pairings(
                params, r, mode=mode, block_n=bn, positions=LENET_CONV_POSITIONS
            )
            pairings[mode, r] = pr
            folded[mode, r] = {
                k: {"w": folded_conv_weight(v["w"], pr[k]) if k in pr else v["w"], "b": v["b"]}
                for k, v in params.items()
            }
    t_pair = time.perf_counter() - t0
    requests = [
        torch.as_tensor(images[i * REQUEST_IMAGES : (i + 1) * REQUEST_IMAGES],
                        dtype=torch.float32, device="cuda")
        for i in range(REQUESTS)
    ]
    return {
        "params": params, "images": images, "labels": labels, "source": source,
        "pairings": pairings, "folded": folded, "requests": requests,
        "seconds": {"data": t_data, "pairing": t_pair},
    }


# ---------------------------------------------------------------------------
# phase 5: K1 at LeNet's shapes
# ---------------------------------------------------------------------------


def _layer_inputs(params, x):
    """Inputs of conv1..conv3 for a request, from the F.conv2d path."""
    import torch.nn.functional as F

    from repro_torch.kernels.paired_conv import pool2_reference
    from repro_torch.models.lenet import _torch_conv

    def conv_pool(name, x):
        w, b = params[name]["w"], params[name]["b"]
        return pool2_reference(F.relu(_torch_conv(x, w, b)), "max2")

    x2 = conv_pool("conv1", x)
    return {"conv1": x, "conv2": x2, "conv3": conv_pool("conv2", x2)}


def _live_blocks(pairing) -> list[tuple[int, int, int]]:
    """(pairs, residual lanes, columns) of each column block of a pairing,
    without the lanes that pad blocks to a common split."""
    from repro_torch.core.pairing import BlockedPairing

    blocks = pairing.blocks if isinstance(pairing, BlockedPairing) else [pairing]
    return [(sp.n_pairs, len(sp.resid), sp.shape[1]) for sp in blocks]


def _bound(pairing, rows: int, k: int, n_out: int, n_cols: int, itemsize: int):
    """Least bytes and operations of one launch over ``rows`` GEMM rows.

    Bytes: the ``rows × k`` im2col operand read once (not the B-fold,
    lane-padded copy the blocked forms build), the live weights, the fp32
    bias and the ``n_out`` outputs written once.  Operations: one subtract
    per pair and one multiply-add (2 FLOP) per live lane and column.
    """
    blocks = _live_blocks(pairing)
    weights = sum((p + r) * c for p, r, c in blocks)
    nbytes = (rows * k + weights + n_out) * itemsize + n_cols * 4
    flops = sum(rows * (2 * c * (p + r) + p) for p, r, c in blocks)
    return nbytes, flops


def _measure_layer(x, w, b, w_folded, layer, pool) -> dict:
    """One conv layer at the main path's shapes: the kernel against its plain
    version on the operands ``paired_conv`` builds, their device times, the
    im2col + gather time, ``F.conv2d`` on the folded weights, the bound,
    and the time the bytes the kernel really reads take at the card's rate."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from repro_torch.core.pairing import BlockedPairing
    from repro_torch.kernels import paired_matmul as pm
    from repro_torch.kernels.paired_conv import conv_gemm_operands
    from repro_torch.kernels.ref import rel_err

    xg, kmat, w_res, out_shape = conv_gemm_operands(x, w, layer, pool=pool)
    xg = xg.contiguous()
    kw = dict(activation="relu", pool=pool)
    if isinstance(layer.pairing, BlockedPairing):
        kw["n_cols"] = out_shape[-1]
        kern, plain = pm.paired_matmul_blocked_cuda, pm.paired_matmul_blocked_plain
    else:
        kern, plain = pm.paired_matmul_cuda, pm.paired_matmul_plain
    got, want = kern(xg, kmat, w_res, b, **kw), plain(xg, kmat, w_res, b, **kw)
    torch.cuda.synchronize()
    x_nchw = x.permute(0, 3, 1, 2).contiguous()
    w_oihw = w_folded.permute(3, 2, 0, 1).contiguous()
    rows = xg.shape[-2] * (4 if pool != "none" else 1)
    k = w.shape[0] * w.shape[1] * w.shape[2]  # im2col lanes (kh, kw, cin)
    nbytes, flops = _bound(layer.pairing, rows, k, got.numel(), got.shape[-1],
                           xg.element_size())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    # what the kernel really reads: the (B-fold, lane-padded) operand, the
    # packed weights and the bias, and writes: the output
    read_bytes = sum(t.numel() * t.element_size() for t in (xg, kmat, w_res, b, got)
                     if t is not None)
    ms = graph_ms(lambda: kern(xg, kmat, w_res, b, **kw))
    plain_ms = graph_ms(lambda: plain(xg, kmat, w_res, b, **kw))
    return {
        "x_shape": list(xg.shape), "out_shape": list(got.shape),
        "rel_err": rel_err(got, want), "max_abs_err": float((got - want).abs().max()),
        "ms": ms, "plain_ms": plain_ms, "kernel_over_plain": ms / plain_ms,
        "library_ms": graph_ms(lambda: F.conv2d(x_nchw, w_oihw, b)),
        "operands_ms": request_stats(
            lambda: conv_gemm_operands(x, w, layer, pool=pool))["median"],
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "read_bound_ms": read_bytes / HBM_BYTES_PER_S * 1e3, "read_bytes": read_bytes,
        "bytes": nbytes, "flops": flops,
        "plan": dataclasses.asdict(pm.launch_plan(xg, kmat, w_res, pool)),
    }


def phase_layers(ctx) -> dict:
    params = ctx["params"]
    inputs = _layer_inputs(params, ctx["requests"][0])
    rows_out = []
    for mode, _ in MODES:
        r = 0.05
        pr, folded = ctx["pairings"][mode, r], ctx["folded"][mode, r]
        for fused in (True, False):
            for name in ("conv1", "conv2", "conv3"):
                pool = "max2" if fused and name != "conv3" else "none"
                row = {"mode": mode, "rounding": r, "fused_pool": fused, "layer": name}
                row.update(_measure_layer(
                    inputs[name], params[name]["w"], params[name]["b"],
                    folded[name]["w"], pr[name], pool,
                ))
                check(row["rel_err"] <= FP32_RTOL,
                      f"layer {mode} {name} pool={pool} rel err {row['rel_err']:.3g}")
                rows_out.append(row)
    max_abs = max(row["max_abs_err"] for row in rows_out)
    # not a gate: the kernel is simple and right first, fast later (PERF.md)
    slower = [f"{row['mode']} {row['layer']} fused={row['fused_pool']}"
              for row in rows_out if row["kernel_over_plain"] > 1]
    out = {"phase": "layers", "images": REQUEST_IMAGES, "max_abs_err": max_abs,
           "kernel_slower_than_plain": slower, "rows": rows_out}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase 6: serving LeNet — the first main path
# ---------------------------------------------------------------------------


def phase_serve(ctx) -> dict:
    import torch

    from repro_torch.kernels import paired_matmul as pm
    from repro_torch.kernels.ref import rel_err
    from repro_torch.models.lenet import lenet_accuracy, lenet_apply

    params, requests = ctx["params"], ctx["requests"]
    labels = torch.as_tensor(ctx["labels"], device="cuda")
    with torch.no_grad():
        ref = [lenet_apply(params, x) for x in requests]
        folded_ref = {
            key: [lenet_apply(fp, x) for x in requests] for key, fp in ctx["folded"].items()
        }
    configs = [(mode, r, fused) for r in ROUNDINGS for mode, _ in MODES for fused in (True, False)]

    pm.reset_launches()  # counts from here on are the main path's
    served = []
    with torch.no_grad():
        for mode, r, fused in configs:
            pr = ctx["pairings"][mode, r]
            hits, errs, argmax_same, per_forward = 0, [], True, set()
            for i, x in enumerate(requests):
                before = pm.launch_count()
                logits = lenet_apply(params, x, conv_impl="paired", paired=pr, fuse_pool=fused)
                per_forward.add(pm.launch_count() - before)
                want = ref[i] if r == 0 else folded_ref[mode, r][i]
                errs.append(rel_err(logits, want))
                argmax_same &= bool((logits.argmax(-1) == want.argmax(-1)).all())
                batch_labels = labels[i * REQUEST_IMAGES : (i + 1) * REQUEST_IMAGES]
                hits += int((logits.argmax(-1) == batch_labels).sum())
                check(bool(torch.isfinite(logits).all()) and logits.shape == (REQUEST_IMAGES, 10),
                      f"serve {mode} r={r} fused={fused}: bad logits")
            served.append({
                "mode": mode, "rounding": r, "fused_pool": fused,
                "accuracy": hits / (REQUESTS * REQUEST_IMAGES),
                "rel_err_vs": "F.conv2d" if r == 0 else "F.conv2d on folded weights",
                "max_rel_err": max(errs), "argmax_identical": argmax_same,
                "launches_per_forward": sorted(per_forward),
            })
            check(max(errs) <= FP32_RTOL,
                  f"serve {mode} r={r} fused={fused} rel err {max(errs):.3g}")
            check(per_forward == {3}, f"serve {mode} r={r} fused={fused} launches {per_forward}")
            if r == 0:
                check(argmax_same, f"serve {mode} r=0 fused={fused}: argmax differs from F.conv2d")
    # the accuracy entry point, over the same requests
    pr = ctx["pairings"]["structured", 0.0]
    acc = lenet_accuracy(params, ctx["images"], ctx["labels"], batch=REQUEST_IMAGES,
                         conv_impl="paired", paired=pr, fuse_pool=True)
    launches = dict(pm.LAUNCHES)
    total = pm.launch_count()
    check(total == (len(configs) + 1) * REQUESTS * 3,
          f"main path launched the kernel {total} times")
    acc_served = next(s["accuracy"] for s in served if s["mode"] == "structured"
                      and s["rounding"] == 0 and s["fused_pool"])
    check(acc == acc_served, f"lenet_accuracy {acc} != served accuracy {acc_served}")

    # ms per request of 1000 images, one request at a time (closed loop,
    # host overhead included), after warm-up
    x = requests[0]
    with torch.no_grad():
        request_ms = {
            "torch_conv2d": request_stats(lambda: lenet_apply(params, x)),
            "im2col": request_stats(lambda: lenet_apply(params, x, conv_impl="im2col")),
        }
        for mode, r, fused in configs:
            if r != 0.05:
                continue
            pr = ctx["pairings"][mode, r]
            request_ms[f"paired_{mode}_{'fused' if fused else 'unfused'}"] = request_stats(
                lambda pr=pr, fused=fused: lenet_apply(
                    params, x, conv_impl="paired", paired=pr, fuse_pool=fused)
            )

    ledger = []
    for (mode, r), pr in ctx["pairings"].items():
        counts = [layer.measured_op_counts() for layer in pr.values()]
        ledger.append({
            "mode": mode, "rounding": r,
            "baseline_lanes": sum(c["baseline_lanes"] for c in counts),
            "lanes_saved": sum(c["lanes_saved"] for c in counts),
            "subs_executed": sum(c["subs_executed"] for c in counts),
        })
        check(ledger[-1]["baseline_lanes"] == 405600, f"ledger baseline {ledger[-1]}")
    out = {
        "phase": "serve", "source": ctx["source"], "requests": REQUESTS,
        "images_per_request": REQUEST_IMAGES, "set_up_seconds": ctx["seconds"],
        "main_path_launches": total, "launches_by_form": launches,
        "accuracy_entry_point": acc, "served": served, "ms_per_request": request_ms,
        "table1_ledger": ledger,
    }
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase 7: the paper's workload on trained weights — Table I and Fig. 8
# ---------------------------------------------------------------------------

PAPER_TRAIN_STEPS = 3 * (20000 // 128)  # the trainer's defaults: 3 epochs of 20000
PAPER_MIN_ACCURACY = 0.9


def _warm_training(params, images, labels) -> dict:
    """Training once the trainer's run has paid its one-time costs (imports,
    cuDNN set-up): steps/s over two epochs of ``images`` with the trainer's
    recipe, and one step under ``torch.profiler``."""
    import torch

    from repro_torch.data.mnist import batches
    from repro_torch.models.lenet import lenet_loss
    from repro_torch.train.loop import make_train_step, train
    from repro_torch.train.optimizer import adamw, cosine_schedule

    opt = adamw(cosine_schedule(1e-3, 2 * (len(labels) // 128), warmup_steps=50))
    t0 = time.perf_counter()
    _, info = train(params, lenet_loss, opt, batches(images, labels, 128, epochs=2),
                    log_every=0, verbose=False)
    seconds = time.perf_counter() - t0
    live = {k: {n: t.detach().clone().requires_grad_() for n, t in v.items()}
            for k, v in params.items()}
    step = make_train_step(lenet_loss, opt([t for v in live.values() for t in v.values()]))
    xb = torch.as_tensor(images[:128], device="cuda")
    yb = torch.as_tensor(labels[:128], device="cuda")
    return {"warm_steps": info["steps"], "warm_steps_per_s": info["steps"] / seconds,
            "profiled_step": profile_step(lambda: step(live, 0, xb, yb))}


def phase_paper(serve) -> dict:
    import math

    import torch

    from repro_torch.benchmarks import fig8, table1
    from repro_torch.core.transform import build_conv_pairings
    from repro_torch.kernels import paired_matmul as pm
    from repro_torch.kernels.paired_conv import folded_conv_weight
    from repro_torch.kernels.ref import rel_err
    from repro_torch.models.lenet import LENET_CONV_POSITIONS, lenet_apply
    from repro_torch.train.lenet_trainer import get_trained_lenet

    pm.reset_launches()  # counts from here on are the paper path's
    t0 = time.perf_counter()
    trained = get_trained_lenet(cache=False)  # on the card, the default budget
    wall = time.perf_counter() - t0
    params, test_x, test_y, info = trained
    losses = info["losses"]
    train_launches = pm.launch_count()
    check(info["train_steps"] == PAPER_TRAIN_STEPS == len(losses),
          f"paper: {info['train_steps']} training steps, want {PAPER_TRAIN_STEPS}")
    check(all(math.isfinite(x) for x in losses), "paper: a training loss is not finite")
    check(info["test_acc"] >= PAPER_MIN_ACCURACY,
          f"paper: trained LeNet scores {info['test_acc']} < {PAPER_MIN_ACCURACY}")
    check(params["conv1"]["w"].is_cuda and train_launches == 0,
          f"paper: training ran on {params['conv1']['w'].device} with {train_launches} K1 "
          "launches (it runs F.conv2d on the card)")
    training = {
        "wall_seconds": wall, "train_seconds": info["train_seconds"],
        "steps": info["train_steps"], "steps_per_s": info["train_steps"] / info["train_seconds"],
        "first_loss": losses[0], "last_loss": losses[-1], "test_accuracy": info["test_acc"],
        "test_images": len(test_y), "source": info["source"],
        **_warm_training(params, test_x, test_y),
    }
    emit({"phase": "paper_training", **training})

    # Table I and Fig. 8 assert their own gates (Table I's invariants, r = 0
    # within 1e-5, the fused path's counts): a failed one raises and fails the run
    t0 = time.perf_counter()
    t1 = table1.run(trained=trained)
    t_table1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    f8 = fig8.run(trained=trained)
    t_fig8 = time.perf_counter() - t0
    launches = pm.launch_count()
    by_form = dict(pm.LAUNCHES)
    for tag, m in f8["measured_conv_path"].items():
        check(m["k1_launches"] == 3, f"paper: measured path {tag} launched K1 "
              f"{m['k1_launches']} times, want 3")
    for tag, v in f8["fused_pool_path"]["variants"].items():
        if tag != "torch":
            check(v["k1_launches"] == 3, f"paper: {tag} launched K1 {v['k1_launches']} times")

    # one request of 1000 trained-weight images: per_column r = 0.05, pool fused
    mode, r = HEADLINE
    pr = build_conv_pairings(params, r, mode=mode, positions=LENET_CONV_POSITIONS)
    folded = {k: {"w": folded_conv_weight(v["w"], pr[k]) if k in pr else v["w"], "b": v["b"]}
              for k, v in params.items()}
    x = torch.as_tensor(test_x[:REQUEST_IMAGES], dtype=torch.float32, device="cuda")
    with torch.no_grad():
        logits = lenet_apply(params, x, conv_impl="paired", paired=pr, fuse_pool=True)
        want = lenet_apply(folded, x)
        req_err = rel_err(logits, want)
        check(req_err <= FP32_RTOL, f"paper request: rel err {req_err:.3g} vs folded F.conv2d")
        request_ms = {
            "paired_per_column_fused": request_stats(lambda: lenet_apply(
                params, x, conv_impl="paired", paired=pr, fuse_pool=True)),
            "torch_conv2d": request_stats(lambda: lenet_apply(params, x)),
        }
    # K1's three launches of that forward, on the trained pairing
    inputs = _layer_inputs(params, x)
    layer_rows = []
    for name in ("conv1", "conv2", "conv3"):
        pool = "max2" if name != "conv3" else "none"
        row = {"layer": name, "pool": pool, "n_pairs": pr[name].n_pairs,
               **pr[name].measured_op_counts()}
        row.update(_measure_layer(inputs[name], params[name]["w"], params[name]["b"],
                                  folded[name]["w"], pr[name], pool))
        check(row["rel_err"] <= FP32_RTOL, f"paper layer {name}: rel err {row['rel_err']:.3g}")
        layer_rows.append(row)
    random_ms = serve["ms_per_request"][f"paired_{mode}_fused"]
    out = {
        "phase": "paper", "training": training, "seconds": {"table1": t_table1, "fig8": t_fig8},
        "main_path_launches": launches, "launches_by_form": by_form,
        "table1": {"rows": t1["rows"], "spectrum_ordered": t1["spectrum_ordered"]},
        "fig8": {k: f8[k] for k in ("rows", "headline", "paper_headline", "kernel_plans",
                                     "pairing_block_sweep", "baseline_accuracy")},
        "measured_conv_path": {tag: {k: m[k] for k in (
            "rounding", "mode", "block_n", "total_paired_lanes", "total_subs_per_image",
            "k1_launches", "rel_err_vs_conv2d")} for tag, m in f8["measured_conv_path"].items()},
        "fused_pool_path": f8["fused_pool_path"],
        "request": {"mode": mode, "rounding": r, "images": REQUEST_IMAGES,
                    "rel_err_vs_folded_conv2d": req_err, "ms": request_ms,
                    "random_weight_ms": random_ms},
        "k1_headline_forward": {
            "ms": sum(row["ms"] for row in layer_rows),
            "plain_ms": sum(row["plain_ms"] for row in layer_rows),
            "bound_ms": sum(row["bound_ms"] for row in layer_rows),
            "library_ms": sum(row["library_ms"] for row in layer_rows),
            "rows": layer_rows,
        },
    }
    emit(out)
    h, ph = f8["headline"], f8["paper_headline"]
    print(f"paper: trained {training['steps']} steps in {training['train_seconds']:.2f} s "
          f"({training['steps_per_s']:.1f} steps/s, warm {training['warm_steps_per_s']:.1f}), "
          f"test accuracy {info['test_acc']:.4f}; "
          f"r=0.05 power {h['power_saving_%']:.2f} % / area {h['area_saving_%']:.2f} % / "
          f"accuracy loss {h['acc_loss_%']:.2f} % (paper {ph['power_saving_%']} / "
          f"{ph['area_saving_%']} / {ph['acc_loss_%']}); request "
          f"{request_ms['paired_per_column_fused']['median']:.3f} ms trained vs "
          f"{random_ms['median']:.3f} ms random weights", file=sys.stderr)
    return out


# ---------------------------------------------------------------------------
# phases 8 and 9: the LM serving path
# ---------------------------------------------------------------------------

K1_KERNEL, K2_KERNEL = "paired_matmul_kernel", "decode_attention_kernel"
# name fragments of cuBLAS's and CUTLASS's GEMM kernels (torch.matmul) on Hopper
GEMM_KERNEL_TAGS = ("gemm", "xmma", "nvjet", "cutlass")


def _reset_launches() -> None:
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paired_matmul as pm

    pm.reset_launches()
    da.reset_launches()
    fa.reset_launches()


def profile_step(step) -> dict:
    """One call of ``step`` (an engine's decode step, a training step) under
    ``torch.profiler``: device ms and launches of K1, K2 and every other
    kernel, and the step's wall ms.  The tracer can start capturing late and
    lose a window's first kernels (``repro_torch.benchmarks.profiler_window``
    measures it), so ``trace_step`` runs the step well inside the window
    between two marker kernels; a trace missing a marker did not see the whole
    step and is taken again, at most three times."""
    from repro_torch.benchmarks.profiler_window import MARK_KERNEL, device_kernels, trace_step

    tries = 3
    for trace in range(1, tries + 1):
        prof, wall = trace_step(step)
        split = {k: {"ms": 0.0, "launches": 0} for k in ("K1", "K2", "other")}
        gemm = {"ms": 0.0, "launches": 0}  # library GEMMs (torch.matmul), within "other"
        index = {"ms": 0.0, "launches": 0}  # gathers and scatters (indexing), within "other"
        others, marks = [], 0
        for kernel, count, us in device_kernels(prof):
            if MARK_KERNEL in kernel:
                marks += count
                continue
            key = "K1" if K1_KERNEL in kernel else "K2" if K2_KERNEL in kernel else "other"
            split[key]["ms"] += us / 1e3
            split[key]["launches"] += count
            if key == "other":
                others.append({"kernel": kernel[:80], "ms": us / 1e3, "launches": count})
                if any(tag in kernel.lower() for tag in GEMM_KERNEL_TAGS):
                    gemm["ms"] += us / 1e3
                    gemm["launches"] += count
                if "index" in kernel.lower():
                    index["ms"] += us / 1e3
                    index["launches"] += count
        if marks == 2:
            break
    check(marks == 2, f"profiler: {tries} traces each lost a marker of the traced step")
    device_ms = sum(v["ms"] for v in split.values())
    return {"wall_ms": wall, "device_ms": device_ms if device_ms else "not measured",
            "idle_share": 1 - device_ms / wall if device_ms else "not measured", **split,
            "library_gemm": gemm, "index_kernels": index,
            "traces": trace, "markers": marks,
            "other_top": sorted(others, key=lambda o: -o["ms"])[:5]}


def phase_lm_parity() -> dict:
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.analysis import decode_launches
    from repro_torch.configs import get_config
    from repro_torch.kernels.ref import rel_err
    from repro_torch.launch.serve import kernel_launches
    from repro_torch.models import lm as M
    from repro_torch.serving.engine import ServeEngine

    cfg = dataclasses.replace(get_config("qwen2-1.5b"), n_layers=2, dtype="float32")
    model = M.init_lm(cfg, 0)
    base = dict(q_chunk=32, k_chunk=32)
    t0 = time.perf_counter()
    plain = ServeEngine(cfg, model, max_seq=32, batch_size=2, knobs=M.PerfKnobs(**base))
    fused = ServeEngine(cfg, model, max_seq=32, batch_size=2, knobs=M.PerfKnobs(
        **base, gemm="pallas_paired", attn="pallas_fused", pair_block_n=64))
    pairing_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    prompts = {0: rng.integers(0, cfg.vocab, size=5), 1: rng.integers(0, cfg.vocab, size=11)}
    errs = []
    for prompt in prompts.values():
        tokens = torch.as_tensor(prompt[None], device="cuda")
        want = M.prefill(cfg, plain.model, tokens, knobs=plain.knobs)[0]
        errs.append(rel_err(M.prefill(cfg, fused.model, tokens, knobs=fused.knobs)[0], want))

    _reset_launches()  # the path's own counts from here
    toks = {name: {s: [eng.add_request(s, p)] for s, p in prompts.items()}
            for name, eng in (("plain", plain), ("fused", fused))}
    before = kernel_launches()
    for _ in range(5):
        for name, eng in (("plain", plain), ("fused", fused)):
            nxt = eng.step()
            for s in prompts:
                toks[name][s].append(int(nxt[s]))
        errs.append(rel_err(fused.last_logits, plain.last_logits))
    decode = {k: v - before[k] for k, v in kernel_launches().items()}
    launches = kernel_launches()
    per_layer = {k: v / (5 * cfg.n_layers) for k, v in decode.items()}
    prof = profile_step(fused.step)
    prof_per_layer = {k: prof[k]["launches"] / cfg.n_layers for k in ("K1", "K2")}
    check(toks["fused"] == toks["plain"], f"lm_parity tokens differ: {toks}")
    check(max(errs) <= FP32_RTOL, f"lm_parity logits rel err {max(errs):.3g}")
    want = decode_launches(cfg, "dense", fused.knobs)
    check(per_layer == want, f"lm_parity launches per decode layer {per_layer}, want {want}")
    check(prof_per_layer == {"K1": want["paired_matmul"], "K2": want["decode_attention"]}
          or prof["device_ms"] == "not measured",
          f"lm_parity profiler launches per decode layer {prof_per_layer}")
    out = {
        "phase": "lm_parity", "arch": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype,
        "pairing": "column_blocked bn=64, r=0", "pairing_s": pairing_s,
        "tokens": toks["fused"], "tokens_identical": toks["fused"] == toks["plain"],
        "max_logit_rel_err": max(errs), "main_path_launches": launches,
        "decode_launches_per_layer": per_layer, "profiled_step": prof,
        "profiled_launches_per_layer": prof_per_layer,
    }
    emit(out)
    # the frontend phase serves these weights again
    return out, {"cfg": cfg, "plain_model": model, "paired_model": fused.model}


def _k1_at(block, name, x, residual=None, *, dense: bool = False) -> dict:
    """K1 on one decoder weight of a model (its real segments, or with
    ``dense`` the weight itself in K1's dense form, P = 0), for activations
    ``x`` (M, K): device ms beside the plain version, ``torch.matmul`` on
    the folded weight, and the bound."""
    import dataclasses

    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import paired_matmul as pm
    from repro_torch.kernels.ref import bf16_ulps

    dt = x.dtype
    w = block.matrix(name, dt)
    if dense:
        xg, kmat, w_res, folded = x, w.new_zeros((0, w.shape[1])), w.contiguous(), w
        p_live, r_live = 0, w.shape[0]
    else:
        meta = block.pairing[name]
        seg = ops.lm_paired_segments(w, meta)
        xg = x[:, seg.perm].contiguous()
        kmat, w_res = seg.kmat.contiguous(), seg.w_res.contiguous()
        folded = ops.fold_lm_weight(w, meta)
        p_live, r_live = int(meta["pair_mask"].sum()), int(meta["resid_mask"].sum())
    got = pm.paired_matmul_cuda(xg, kmat, w_res, residual=residual)
    want = pm.paired_matmul_plain(xg, kmat, w_res, residual=residual, out_dtype=torch.float32)
    M, K = x.shape
    P, N = kmat.shape
    R = w_res.shape[0]
    item = x.element_size()
    nbytes = (M * K + (p_live + r_live) * N + M * N * (2 if residual is not None else 1)) * item
    flops = M * (2 * N * (p_live + r_live) + p_live)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
    lib = (lambda: torch.matmul(x, folded) + residual) if residual is not None else (
        lambda: torch.matmul(x, folded))
    ms = graph_ms(lambda: pm.paired_matmul_cuda(xg, kmat, w_res, residual=residual))
    plain_ms = graph_ms(lambda: pm.paired_matmul_plain(xg, kmat, w_res, residual=residual))
    return {
        "weight": name, "M": M, "K": K, "N": N, "P": P, "R": R, "pairs_live": p_live,
        "plan": dataclasses.asdict(pm.launch_plan(xg, kmat, w_res)),
        "ulps": bf16_ulps(got, want), "ms": ms, "plain_ms": plain_ms,
        "library_ms": graph_ms(lib), "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "kernel_over_bound": ms / max(t_bytes, t_ops),
    }


def _k2_at(eng, layer: int = 0) -> dict:
    """K2 at the serving shapes: one layer's cache and out-projection
    segments of the engine, the slots at their positions (meta tokens
    included), the layer's window and sinks, its skip connection fused where
    the layer fuses one (dense and MoE layers; a hybrid layer has none);
    device ms of the fused and the bare form beside the plain version, the
    library calls under the same mask, and the bounds (the keys the mask
    admits); a relaunch gives the same bits."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import bf16_ulps
    from repro_torch.models import lm as M

    cfg, attn = eng.cfg, eng.model.layers[layer].attn
    kind = cfg.layer_kind(layer)
    window = M._window_for(cfg, kind)
    n_sink = cfg.meta_tokens if window else 0
    dt = eng.cache["k"].dtype
    B, H, D, KH = eng.batch_size, cfg.n_heads, cfg.head_dim, cfg.n_kv_heads
    w = attn.matrix("wo", dt)
    meta = attn.pairing["wo"]
    seg = ops.attn_outproj_segments(w, meta)
    gen = torch.Generator(device="cuda").manual_seed(2)
    q = torch.randn(B, 1, H, D, generator=gen, device="cuda").to(dt)
    res = torch.randn(B, cfg.d_model, generator=gen, device="cuda").to(dt)
    if kind.startswith("hybrid"):
        res = None
    kc, vc = eng.cache["k"][layer], eng.cache["v"][layer]
    pos = torch.as_tensor(eng.pos + cfg.meta_tokens, device="cuda")
    kw = dict(window=window, n_sink=n_sink)
    args = (q, kc, vc, pos, seg.idx_i, seg.idx_j, seg.idx_r, seg.kmat, seg.w_res, res)
    got = da.fused_decode_attention_cuda(*args, n_cols=seg.n_cols, **kw)
    want = da.outproj_plain(da.decode_attention_cuda(q, kc, vc, pos, **kw), *args[4:],
                            n_cols=seg.n_cols, out_dtype=torch.float32)
    check(torch.equal(da.fused_decode_attention_cuda(*args, n_cols=seg.n_cols, **kw), got),
          f"K2 at {cfg.name} layer {layer}: two launches differ")
    Bw, P, bn = seg.kmat.shape
    folded = ops.fold_lm_weight(w, meta)
    mask = da.decode_mask(pos, kc.shape[1], window, n_sink)
    n_res = 0 if res is None else 1

    def sdpa():
        return F.scaled_dot_product_attention(q.transpose(1, 2), kc.transpose(1, 2),
                                              vc.transpose(1, 2), attn_mask=mask[:, None, None],
                                              enable_gqa=True)

    def library():  # two calls: no single PyTorch call computes K2
        y = torch.matmul(sdpa().reshape(B, H * D), folded)
        return y if res is None else y + res

    live_keys = int(mask.sum())
    p_live, r_live = int(meta["pair_mask"].sum()), int(meta["resid_mask"].sum())
    N, item = seg.n_cols, q.element_size()
    nbytes = (q.numel() + 2 * live_keys * KH * D + (p_live + r_live) * N + (1 + n_res) * B * N) \
        * item + (2 * p_live + r_live) * 4
    flops = 4 * live_keys * H * D + B * (2 * N * (p_live + r_live) + p_live)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
    ms = graph_ms(lambda: da.fused_decode_attention_cuda(*args, n_cols=seg.n_cols, **kw))
    # the bare form at the same shape: the attention alone (the rest of the
    # fused time is the out-projection)
    bare_bytes = (2 * q.numel() + 2 * live_keys * KH * D) * item
    bare_ms = graph_ms(lambda: da.decode_attention_cuda(q, kc, vc, pos, **kw))
    return {
        "layer": layer, "kind": kind, "window": window, "n_sink": n_sink,
        "B": B, "H": H, "KH": KH, "D": D, "S": kc.shape[1], "pos": pos.tolist(),
        "live_keys": live_keys,
        "masked_keys": [int(p) + 1 - int(k) for p, k in zip(pos.tolist(), mask.sum(-1).tolist())],
        "residual": res is not None,
        "N": N, "pairs_live": p_live, "resid_live": r_live, "ulps": bf16_ulps(got, want),
        "plan": dataclasses.asdict(da.launch_plan(q, kc, N, bn, P, seg.w_res.shape[1])),
        "bare_plan": dataclasses.asdict(da.launch_plan(q, kc)),
        "ms": ms, "bare_ms": bare_ms, "projection_ms": ms - bare_ms,
        "bare_bound_ms": max(bare_bytes / HBM_BYTES_PER_S,
                             4 * live_keys * H * D / BF16_FLOP_PER_S) * 1e3,
        "bare_library_ms": graph_ms(sdpa),
        "plain_ms": graph_ms(lambda: da.fused_decode_attention_plain(*args, n_cols=seg.n_cols,
                                                                     **kw)),
        "library_ms": graph_ms(library),
        "library_calls": "F.scaled_dot_product_attention(enable_gqa=True, the same mask) + "
                         "torch.matmul(folded wo)" + (" + residual add" if n_res else ""),
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "kernel_over_bound": ms / max(t_bytes, t_ops), "bytes": nbytes, "flops": flops,
    }


def phase_lm_serve() -> dict:
    import numpy as np
    import torch

    from repro_torch.analysis import decode_launches
    from repro_torch.launch.serve import kernel_launches, serve

    steps, batch = 32, 4
    _reset_launches()  # the path's own counts from here
    rec = serve(arch="qwen2-1.5b", batch=batch, max_seq=256, steps=steps,
                pair_rounding=0.05, gemm="pallas_paired", attn="pallas_fused")
    launches = kernel_launches()
    eng = rec["engine"]
    cfg, L = eng.cfg, eng.cfg.n_layers
    dec = rec["launches"]["decode"]
    per_layer = {k: v / ((steps - 1) * L) for k, v in dec.items()}
    toks = rec["outputs"]
    want = decode_launches(cfg, "dense", eng.knobs)
    check(per_layer == want, f"lm_serve launches per decode layer {per_layer}, want {want}")
    check(all(len(t) == steps and all(0 <= x < cfg.vocab for x in t) for t in toks.values()),
          "lm_serve: tokens out of range")
    check(bool(np.isfinite(eng.last_logits).all())
          and eng.last_logits.shape == (batch, cfg.vocab), "lm_serve: bad logits")
    prof = profile_step(eng.step)
    prof_per_layer = {k: prof[k]["launches"] / L for k in ("K1", "K2")}
    check(prof_per_layer == {"K1": want["paired_matmul"], "K2": want["decode_attention"]}
          or prof["device_ms"] == "not measured",
          f"lm_serve profiler launches per decode layer {prof_per_layer}")
    layer0 = eng.model.layers[0]
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = lambda k: torch.randn(batch, k, generator=gen, device="cuda").to(torch.bfloat16)
    d, f = cfg.d_model, cfg.d_ff
    k1 = [_k1_at(layer0.attn, "wq", x(d)), _k1_at(layer0.attn, "wk", x(d)),
          _k1_at(layer0.attn, "wv", x(d)), _k1_at(layer0.mlp, "w_gate", x(d)),
          _k1_at(layer0.mlp, "w_up", x(d)), _k1_at(layer0.mlp, "w_down", x(f), x(d))]
    k2 = _k2_at(eng)
    for row in k1:
        check(row["ulps"] <= BF16_MAX_ULPS, f"lm_serve K1 {row['weight']} {row['ulps']:.3g} ulps")
    check(k2["ulps"] <= BF16_MAX_ULPS, f"lm_serve K2 {k2['ulps']:.3g} ulps")
    step_ms = sorted(rec["step_ms"])
    rp = eng.pair_report
    out = {
        "phase": "lm_serve", "arch": cfg.name, "layers": L, "dtype": cfg.dtype,
        "batch": batch, "max_seq": 256, "tokens_per_slot": steps,
        "pairing": {"mode": rp.mode, "rounding": rp.rounding, "total_pairs": rp.total_pairs,
                    "pair_fraction": rp.pair_fraction, "seconds": rec["pairing_s"]},
        "prefill_ms": rec["prefill_ms"],
        "decode_ms": {"median": step_ms[len(step_ms) // 2],
                      "p90": step_ms[int(0.9 * (len(step_ms) - 1))], "n": len(step_ms)},
        "tokens_per_s": rec["tokens_per_s"], "seconds": rec["seconds"],
        "main_path_launches": launches, "prefill_launches": rec["launches"]["prefill"],
        "decode_launches_per_layer": per_layer, "profiled_step": prof,
        "profiled_launches_per_layer": prof_per_layer, "k1_decode_shapes": k1, "k2": k2,
        "tokens": {s: t[:8] for s, t in toks.items()},
    }
    emit(out)
    return out, eng


# ---------------------------------------------------------------------------
# phase 10: the serving front end over the LM engines
# ---------------------------------------------------------------------------

def _reset_slots(*engines) -> None:
    for eng in engines:
        for slot in range(eng.batch_size):
            eng.clear_quarantine(slot)
            eng.release_slot(slot)


def _divergence(cfg, model, r, want) -> dict:
    """Where a request's tokens leave the reference's, and the reference's
    top-2 logit margin there (a near tie on random weights, or a fault)."""
    import torch

    from repro_torch.models import lm as M

    t = next(i for i, (a, b) in enumerate(zip(r.tokens + [None], want)) if a != b)
    seq = torch.as_tensor(list(r.prompt) + want[:t], device="cuda")[None]
    logits = M.lm_forward(cfg, model, seq)[0][0, -1, : cfg.vocab]
    top2 = torch.topk(logits, 2).values
    return {"rid": r.rid, "state": r.state, "step": t, "got": r.tokens[t: t + 1],
            "want": want[t], "ref_top2_margin": float(top2[0] - top2[1])}


def _fe_row(report, launches: dict) -> dict:
    summ = report.summary()
    return {
        "offered_rps": report.offered_load_rps, "requests": summ["n_requests"],
        "completed": summ["completed"], "degraded": summ["degraded"], "shed": summ["shed"],
        "shed_reasons": summ["shed_reasons"], "lost": summ["lost"], "steps": report.steps,
        "generated_tokens": summ["generated_tokens"], "wall_s": report.wall_s,
        "wall_ms_per_step": report.wall_s / max(report.steps, 1) * 1e3,
        "wall_tokens_per_s": summ["generated_tokens"] / report.wall_s,
        "virtual_clock": {k: summ[k] for k in ("latency_s", "ttft_s", "tokens_per_s_virtual",
                                                "virtual_time_s")},
        "incidents": summ["incidents"], "launches": launches,
    }


def phase_frontend(parity_ctx, lm_engine) -> dict:
    import torch

    from repro_torch.launch.serve import kernel_launches
    from repro_torch.models import lm as M
    from repro_torch.serving import ServeEngine, ServeFrontend, chaos, faulted_request_ids

    # (a) chaos at full width, 2 layers, fp32: K1 + K2 primary, exact fallback
    cfg, plain_model = parity_ctx["cfg"], parity_ctx["plain_model"]
    base = dict(q_chunk=16, k_chunk=16)
    primary = ServeEngine(cfg, parity_ctx["paired_model"], max_seq=chaos.MAX_SEQ,
                          batch_size=chaos.BATCH, knobs=M.PerfKnobs(
                              **base, gemm="pallas_paired", attn="pallas_fused",
                              pair_block_n=64))
    fallback = ServeEngine(cfg, plain_model, max_seq=chaos.MAX_SEQ, batch_size=chaos.BATCH,
                           knobs=M.PerfKnobs(**base))
    workload = chaos.chaos_workload(cfg.vocab, chaos.CHAOS_RPS)
    faults = chaos.chaos_schedule()
    _reset_launches()  # the path's own counts from here
    report = ServeFrontend(primary, fallback, chaos.frontend_config(), faults=faults).run(
        workload, offered_load_rps=chaos.CHAOS_RPS)
    chaos_run = _fe_row(report, kernel_launches())
    faulted = faulted_request_ids(report)
    by_rid = {r.rid: r for r in report.requests}
    unaccounted = [rid for rid in faulted if not (
        by_rid[rid].state == "degraded"
        or (by_rid[rid].state == "shed" and by_rid[rid].shed_reason))]
    done = [r for r in report.requests if r.state in ("completed", "degraded")]
    ref = ServeEngine(cfg, plain_model, max_seq=chaos.MAX_SEQ, batch_size=1,
                      knobs=M.PerfKnobs(**base))
    diverged, n_parity = [], {"completed": 0, "degraded": 0}
    for r in done:
        want = ref.generate({0: r.prompt}, n_steps=r.max_new_tokens)[0]
        ref.release_slot(0)
        if r.tokens == want:
            n_parity[r.state] += 1
        else:
            diverged.append(_divergence(cfg, ref.model, r, want))
    check(chaos_run["lost"] == 0, f"frontend chaos lost {chaos_run['lost']} request(s)")
    check(bool(faulted), "frontend chaos: no slot fault hit an occupied slot")
    check(not unaccounted, f"frontend chaos: faulted requests {unaccounted} ended "
                           "without degrading or a shed reason")
    check(n_parity["degraded"] >= 1, "frontend chaos: no degraded completion")
    check(not diverged, f"frontend chaos: token parity failed {diverged}")
    launches = chaos_run["launches"]
    check(launches["paired_matmul"] > 0 and launches["decode_attention"] > 0,
          f"frontend chaos launches {launches}")
    chaos_run.update({"arch": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype,
                      "primary": "column_blocked bn=64 r=0, pallas_paired + pallas_fused",
                      "fallback": "unpaired (torch.matmul, plain decode attention)",
                      "scheduled_faults": len(faults.events), "fired_faults": len(faults.fired),
                      "faulted_requests": sorted(faulted), "parity_checked": n_parity,
                      "diverged": diverged})

    # (b) load sweep at full width and depth, bf16: the lm_serve engine
    eng = lm_engine
    fb = ServeEngine(eng.cfg, eng.model, max_seq=eng.max_seq, batch_size=eng.batch_size,
                     knobs=M.PerfKnobs(q_chunk=32, k_chunk=32))  # gemm="xla": unpaired
    sweep = []
    for rate in chaos.LOADS_RPS:
        _reset_slots(eng, fb)
        _reset_launches()
        report = ServeFrontend(eng, fb, chaos.frontend_config()).run(
            chaos.chaos_workload(eng.cfg.vocab, rate), offered_load_rps=rate)
        torch.cuda.synchronize()
        row = _fe_row(report, kernel_launches())
        check(row["lost"] == 0, f"frontend load {rate}: lost {row['lost']} request(s)")
        check(row["launches"]["paired_matmul"] > 0, f"frontend load {rate}: {row['launches']}")
        sweep.append(row)
    out = {
        "phase": "frontend", "chaos": chaos_run,
        "load_sweep": {"arch": eng.cfg.name, "layers": eng.cfg.n_layers, "dtype": eng.cfg.dtype,
                       "batch": eng.batch_size, "max_seq": eng.max_seq,
                       "primary": "structured r=0.05, pallas_paired + pallas_fused",
                       "fallback": "unpaired (torch.matmul) on the same weights",
                       "wall_clock_note": "smoke-sized functional run (6-29 requests of 2-7 "
                                          "tokens): wall figures are not a throughput "
                                          "measurement",
                       "rows": sweep},
    }
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phases 11 and 12: K1's measured tile cache, and the serving CLI with it
# ---------------------------------------------------------------------------

TILE_CACHE_REPLAYS = 2  # CUDA-graph replays (of 10 calls) a candidate plan is timed over


def _card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "not measured"


def _problem(key: str) -> dict:
    """The K1 problem a tile-cache key names (``tuning.key_problem``)."""
    from repro_torch.kernels import tuning

    names = ("M", "P", "R", "n_blocks", "bn", "pool", "itemsize", "residual")
    return {"key": key, **dict(zip(names, tuning.key_problem(key), strict=True))}


def _engine_keys(eng, prompts: dict, steps: int) -> dict:
    """K1's launches by (key, plan) in one run of ``eng``: a prefill of each
    prompt into its slot, then ``steps`` decode steps; the run's tokens and
    logits beside them."""
    import torch

    from repro_torch.kernels import paired_matmul as pm

    _reset_slots(eng)
    _reset_launches()
    toks = {s: [eng.add_request(s, p)] for s, p in prompts.items()}
    logits = []
    for _ in range(steps):
        nxt = eng.step()
        logits.append(eng.last_logits)
        for s in prompts:
            toks[s].append(int(nxt[s]))
    torch.cuda.synchronize()
    return {"by_plan": pm.launches_by_plan(), "tokens": toks, "logits": logits}


def _tune(prob: dict, cache) -> dict:
    """Every candidate plan of one K1 problem (seeded operands of its
    shapes) held to K1's plain version at the kernel phase's tolerance, its
    shared memory to the kernel's own, then ``tuning.autotune_plans``
    writing the fastest into ``cache``; the heuristic's and the winner's ms
    beside the bound and ``torch.matmul`` at the same (M, K, N)."""
    import dataclasses

    import torch

    from repro_torch.kernels import paired_matmul as pm
    from repro_torch.kernels import tuning
    from repro_torch.kernels.ref import bf16_ulps, rel_err

    M, P, R, B, bn, pool = (prob[k] for k in ("M", "P", "R", "n_blocks", "bn", "pool"))
    item, window, K, n_cols = prob["itemsize"], tuning.POOL_WINDOWS[pool], 2 * P + R, B * bn
    dt = torch.bfloat16 if item == 2 else torch.float32
    gen = torch.Generator(device="cuda").manual_seed(11)
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dt)
    lead, win = ((B,) if B > 1 else ()), ((4,) if window == 4 else ())
    x, kmat, w_res = rnd(*lead, *win, M, K), rnd(*lead, P, bn), rnd(*lead, R, bn)
    res = rnd(M, n_cols) if prob["residual"] else None
    kw = dict(residual=res, pool=pool)
    if B > 1:
        run = lambda plan: pm.paired_matmul_blocked_cuda(x, kmat, w_res, n_cols=n_cols,
                                                         plan=plan, **kw)
        want = pm.paired_matmul_blocked_plain(x, kmat, w_res, n_cols=n_cols,
                                              out_dtype=torch.float32, **kw)
    else:
        run = lambda plan: pm.paired_matmul_cuda(x, kmat, w_res, plan=plan, **kw)
        want = pm.paired_matmul_plain(x, kmat, w_res, out_dtype=torch.float32, **kw)
    cands = tuning.candidate_plans(M, P, R, B, bn, window, item)
    worst = 0.0
    for p in cands:
        got = run(p)
        torch.cuda.synchronize()
        err = bf16_ulps(got, want) if dt == torch.bfloat16 else rel_err(got, want)
        worst = max(worst, err)
        check(err <= (BF16_MAX_ULPS if dt == torch.bfloat16 else FP32_RTOL)
              and bool(torch.isfinite(got).all()), f"tile_cache {prob['key']} {p}: err {err:.3g}")
        smem = pm.kernel_smem(p, P, R, window, item)
        check(smem == p.smem, f"tile_cache {prob['key']} {p}: kernel smem {smem}")
    winner, records = tuning.autotune_plans(run, M, P, R, B, bn, pool, item,
                                            residual=res is not None, cache=cache,
                                            candidates=cands, reps=TILE_CACHE_REPLAYS)
    heur = records[0]  # candidate_plans lists the heuristic first
    nbytes = (x.numel() + (P + R) * n_cols + M * n_cols * (2 if res is not None else 1)) * item
    flops = M * (2 * n_cols * (P + R) + B * P)
    peak = BF16_FLOP_PER_S if dt == torch.bfloat16 else FP32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    xm, wm = rnd(M, K), rnd(K, n_cols)
    lib = (lambda: torch.matmul(xm, wm) + res) if res is not None else (
        lambda: torch.matmul(xm, wm))
    best = min(records, key=lambda r: r["time_s"])
    return {
        **{k: prob[k] for k in ("key", "M", "P", "R", "n_blocks", "bn", "residual")},
        "dtype": str(dt).removeprefix("torch."),
        "candidates": len(cands), "max_err": worst, "err_unit": "ulps" if item == 2 else "rel",
        "heuristic": {k: heur[k] for k in tuning.PLAN_FIELDS},
        "heuristic_ms": heur["time_s"] * 1e3,
        "winner": dataclasses.asdict(winner), "winner_ms": best["time_s"] * 1e3,
        "winner_is_heuristic": bool(best["heuristic"]),
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": graph_ms(lib), "library_call": "torch.matmul (M, K) @ (K, n_cols)",
        "all_ms": sorted(r["time_s"] * 1e3 for r in records),
    }


def phase_tile_cache(parity_ctx, lm_engine) -> dict:
    """K1's tile cache over the qwen2 serve engine's problems (decode and
    prefill rows), the training step's 1024-row ones (layer 0's wq, wk, wo,
    w_gate, w_down, paired and dense, as ``_k1_training_rows``) and the r=0
    fp32 parity engine's; then the engines served with the cache."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.kernels import tuning
    from repro_torch.kernels.ref import rel_err
    from repro_torch.launch.serve import kernel_launches
    from repro_torch.models import lm as M
    from repro_torch.serving.engine import ServeEngine

    t0 = time.perf_counter()
    path = Path(__file__).resolve().parent / ".cache" / "tile_cache.json"
    path.unlink(missing_ok=True)
    cache = tuning.TileCache(path)
    eng = lm_engine
    rng = np.random.default_rng(0)
    # one prompt (20 tokens): the prefill rows of one length are tuned (the
    # script's time limit)
    serve_prompts = {0: rng.integers(0, eng.cfg.vocab, size=20)}
    serve_keys = set(_engine_keys(eng, serve_prompts, 3)["by_plan"])  # (key, plan)
    layer0 = eng.model.layers[0]
    rows, dt = TRAIN_BATCH * TRAIN_SEQ, torch.bfloat16
    train_keys = set()
    for block, name, res in ((layer0.attn, "wq", False), (layer0.attn, "wk", False),
                             (layer0.attn, "wo", True), (layer0.mlp, "w_gate", False),
                             (layer0.mlp, "w_down", True)):
        meta, (K, N) = block.pairing[name], block.matrix(name, dt).shape
        for P, R in ((meta["I"].shape[-1], meta["resid"].shape[-1]), (0, K)):  # paired, dense
            train_keys.add(tuning.launch_key(rows, P, R, 1, N, "none", 2, res))
    cfg_p, base = parity_ctx["cfg"], dict(q_chunk=32, k_chunk=32, gemm="pallas_paired",
                                          attn="pallas_fused", pair_block_n=64)
    parity_prompts = {0: rng.integers(0, cfg_p.vocab, size=5),
                      1: rng.integers(0, cfg_p.vocab, size=11)}
    fused = ServeEngine(cfg_p, parity_ctx["paired_model"], max_seq=32, batch_size=2,
                        knobs=M.PerfKnobs(**base))
    plain_run = _engine_keys(fused, parity_prompts, 5)
    parity_keys = {k for k, _ in plain_run["by_plan"]}
    keys = sorted({k for k, _ in serve_keys} | train_keys | parity_keys)
    problems = [_tune(_problem(k), cache) for k in keys]
    tune_s = time.perf_counter() - t0
    reloaded = tuning.TileCache(path)
    check(sorted(reloaded.entries) == keys, f"tile_cache: {len(reloaded)} entries saved of "
                                            f"{len(keys)} problems")

    # the serve engine over the same paired model with the cache: it launches
    # exactly the cached plans
    cached = ServeEngine(eng.cfg, eng.model, max_seq=eng.max_seq, batch_size=eng.batch_size,
                         knobs=dataclasses.replace(eng.knobs, tile_cache=str(path)))
    run = _engine_keys(cached, serve_prompts, 3)
    launches = kernel_launches()
    by_plan = run["by_plan"]
    wrong = [(k, str(p)) for k, p in by_plan
             if k not in reloaded or p != _cached_plan(reloaded, k)]
    check(not wrong, f"tile_cache: launched plans not the cached ones: {wrong[:4]}")
    check({k for k, _ in by_plan} == {k for k, _ in serve_keys},
          "tile_cache: the cached engine launched other problems than the engine")
    changed = sum(1 for k, p in by_plan if (k, p) not in serve_keys)
    # the r=0 fp32 parity engines, with the cache and without: the same tokens,
    # logits within 1e-5 (the cached plans may split the sum differently)
    fused_c = ServeEngine(cfg_p, parity_ctx["paired_model"], max_seq=32, batch_size=2,
                          knobs=M.PerfKnobs(**base, tile_cache=str(path)))
    cached_run = _engine_keys(fused_c, parity_prompts, 5)
    wrong_p = [k for k, p in cached_run["by_plan"] if p != _cached_plan(reloaded, k)]
    parity_err = max(rel_err(torch.as_tensor(a), torch.as_tensor(b))
                     for a, b in zip(cached_run["logits"], plain_run["logits"], strict=True))
    check(not wrong_p, f"tile_cache parity: launched plans not the cached ones: {wrong_p}")
    check(cached_run["tokens"] == plain_run["tokens"],
          f"tile_cache parity: tokens differ {cached_run['tokens']} vs {plain_run['tokens']}")
    check(parity_err <= FP32_RTOL, f"tile_cache parity: logits rel err {parity_err:.3g}")
    out = {
        "phase": "tile_cache", "card": _card(), "path": str(path), "entries": len(reloaded),
        "problems": problems, "tune_s": tune_s,
        "serve": {"arch": eng.cfg.name, "layers": eng.cfg.n_layers, "dtype": eng.cfg.dtype,
                  "prompts": [len(p) for p in serve_prompts.values()], "decode_steps": 3,
                  "launches_by_plan": len(by_plan), "plans_changed": changed,
                  "tokens": run["tokens"]},
        "main_path_launches": launches,
        "parity": {"arch": cfg_p.name, "layers": cfg_p.n_layers, "dtype": cfg_p.dtype,
                   "max_logit_rel_err": parity_err,
                   "tokens_identical": cached_run["tokens"] == plain_run["tokens"]},
    }
    emit(out)
    return out


def _cached_plan(cache, key: str):
    """The plan a launch under ``cache`` takes for ``key``."""
    from repro_torch.kernels import tuning

    *launch, residual = tuning.key_problem(key)
    with tuning.use_tile_cache(cache):
        return tuning.resolve_plan(*launch, residual=residual)


def phase_serve_cli(cache_path: str) -> dict:
    """``launch.serve.main`` with the flags the JAX CLI has: qwen2-1.5b at
    full width (1 layer: folding per column is host work a layer), the
    weights folded at r=0.05 (``--paired-rounding``), K1's plans from the
    tile cache, the front end under NaN-logit chaos degrading to the
    unpaired fallback on K1's dense form; then a short run with
    ``--block-k``, whose every launch cuts K in slices of at most that."""
    from repro_torch.kernels import paired_matmul as pm
    from repro_torch.kernels import tuning
    from repro_torch.launch import serve as S

    t0 = time.perf_counter()
    _reset_launches()
    report = S.main(["--arch", "qwen2-1.5b", "--layers", "1", "--batch", "4", "--max-seq",
                     "128", "--steps", "8", "--gemm", "pallas_paired", "--attn",
                     "pallas_fused", "--pair-rounding", "0.05", "--paired-rounding", "0.05",
                     "--tile-cache", cache_path, "--conv", "pallas_paired", "--fuse-pool",
                     "--frontend", "--fallback-gemm", "pallas", "--inject", "nan_logits:0.05"])
    launches = S.kernel_launches()
    forms = dict(pm.LAUNCHES)
    summ = report.summary()
    check(summ["lost"] == 0, f"serve_cli lost {summ['lost']}")
    check(summ["degraded"] > 0, "serve_cli: no request degraded to the fallback")
    check(forms.get("dense_matmul", 0) > 0, f"serve_cli: no K1 dense-form launch {forms}")
    cli_s = time.perf_counter() - t0

    block_k = 1024  # w_down's ~4800 lanes at r=0.05 in 5 slices (a cluster holds 8)
    _reset_launches()
    S.main(["--arch", "qwen2-1.5b", "--layers", "1", "--batch", "2", "--max-seq", "64",
            "--steps", "3", "--gemm", "pallas_paired", "--pair-rounding", "0.05",
            "--block-k", str(block_k)])
    slices = {key: tuning.slice_step(_problem(key)["P"] + _problem(key)["R"], plan.splits)
              for key, plan in pm.launches_by_plan()}
    check(bool(slices) and max(slices.values()) <= block_k,
          f"serve_cli --block-k {block_k}: K-slices {slices}")
    out = {
        "phase": "serve_cli", "arch": "qwen2-1.5b", "layers": 1, "seconds": cli_s,
        "frontend": {k: summ[k] for k in ("n_requests", "completed", "degraded", "shed", "lost")},
        "fallback": "gemm='pallas' (K1's dense form), pair_rounding 0",
        "k1_forms": forms, "main_path_launches": launches,
        "block_k": {"block_k": block_k, "launches": sum(pm.LAUNCHES.values()),
                    "max_slice": max(slices.values(), default=0)},
    }
    emit(out)
    return out

# ---------------------------------------------------------------------------
# phase 13: tensor-parallel paired decode (gloo ranks sharing the card)
# ---------------------------------------------------------------------------


def _mesh_knobs(rounding: float, block_n: int):
    from repro_torch.models import lm as M

    return M.PerfKnobs(q_chunk=64, k_chunk=64, remat="none", gemm="pallas_paired",
                       pair_rounding=rounding, pair_block_n=block_n)


def _mesh_ref(cfg, knobs, prompts: dict, steps: int, batch: int, max_seq: int,
              extras: dict | None = None):
    """The single-rank port engine on the card over the ranks' weights (seed
    0), slot ``i`` with row ``i`` of ``extras``: its tokens and last
    logits."""
    from repro_torch.benchmarks.mesh_decode import generate
    from repro_torch.models import lm as M
    from repro_torch.serving.engine import ServeEngine

    eng = ServeEngine(cfg, M.init_lm(cfg, 0), max_seq=max_seq, batch_size=batch, knobs=knobs)
    out = generate(eng, prompts, steps, extras)
    return out, eng.last_logits


#: the other five families on the mesh: (arch, parity layers, served layers,
#: prompt lengths, max_seq).  Served below published depth, 2 layers each
#: (deepseek its dense layer and an MoE layer, hymba a full and a windowed
#: one), as qwen2 and olmoe are: the script's time limit pays for the
#: mesh_train and FSDP phases there (PERF.md §4).
MESH_SERVED_QWEN2_LAYERS = 2
MESH_SERVED_OLMOE_LAYERS = 2
MESH_FAMILIES = (
    ("deepseek-v2-lite-16b", 2, 2, (11, 40), 64),
    ("mamba2-2.7b", 2, 2, (11, 40), 64),
    ("hymba-1.5b", 3, 2, (11, 40), 64),
    ("whisper-base", 2, 2, (11, 24), 64),
    ("internvl2-2b", 2, 2, (260, 280), 336),
)
MESH_SERVED_LAYERS = {arch: served for arch, _, served, _, _ in MESH_FAMILIES}


def _mesh_extras(cfg, batch: int) -> dict | None:
    """``make_batch``'s stub frames or patches as numpy rows, one a slot."""
    from repro_torch.launch.inputs import make_batch

    b = make_batch(cfg, batch, 4, "prefill", seed=1)
    return {k: b[k].float().cpu().numpy() for k in ("frames", "patches") if k in b} or None


def _mesh_decode_plan() -> dict:
    """Phase 13's rank jobs by mesh shape (``serve_rank``'s arguments), and
    what the single-rank references need; nothing runs on the card here."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import cut_layers, get_config

    rng = np.random.default_rng(0)
    q_cfg = dataclasses.replace(cut_layers(get_config("qwen2-1.5b"), 2), dtype="float32")
    q_knobs = _mesh_knobs(0.0, 16)
    q_prompts = {i: rng.integers(1, q_cfg.vocab, size=n) for i, n in enumerate((12, 16, 24))}
    m_cfg = dataclasses.replace(cut_layers(get_config(MOE_ARCH), 2), dtype="float32")
    m_knobs = _mesh_knobs(0.0, 0)
    m_prompts = {0: rng.integers(1, m_cfg.vocab, size=11), 1: rng.integers(1, m_cfg.vocab, size=40)}
    # the references: (cfg, knobs, prompts, steps, batch, max_seq, extras) by job
    refs = {"qwen2": (q_cfg, q_knobs, q_prompts, 6, 4, 64, None),
            "olmoe": (m_cfg, m_knobs, m_prompts, 6, 3, 64, None)}
    # the five other families: parity runs (fp32, r = 0, structured), then
    # their served runs
    fam_knobs, served_knobs = _mesh_knobs(0.0, 0), _mesh_knobs(0.05, 0)
    fam, fam_served = {}, {}
    for arch, layers, served, lens, max_seq in MESH_FAMILIES:
        name = arch.split("-")[0]
        cfg = dataclasses.replace(cut_layers(get_config(arch), layers), dtype="float32")
        prompts = {i: rng.integers(1, cfg.vocab, size=n) for i, n in enumerate(lens)}
        extras = _mesh_extras(cfg, 4)
        refs[name] = (cfg, fam_knobs, prompts, 6, 4, max_seq, extras)
        fam[name] = ((cfg, 0, fam_knobs, prompts, 6),
                     {"max_seq": max_seq, "batch_size": 4, "extras": extras, "cycle": True})
        s_cfg = cut_layers(get_config(arch), served)
        s_lens = (260, 270, 280, 300) if cfg.vision_prefix else (12, 16, 24, 40)
        s_prompts = {i: rng.integers(1, cfg.vocab, size=n) for i, n in enumerate(s_lens)}
        fam_served[name + "_served"] = (
            (s_cfg, 0, served_knobs, s_prompts, 16),
            {"max_seq": max_seq + 64, "batch_size": 4, "hold": True, "timed_steps": 8,
             "extras": _mesh_extras(s_cfg, 4)})

    sq_cfg = cut_layers(get_config("qwen2-1.5b"), MESH_SERVED_QWEN2_LAYERS)
    sm_cfg = cut_layers(get_config(MOE_ARCH), MESH_SERVED_OLMOE_LAYERS)
    s_lens = (12, 16, 24, 40)
    s_prompts = {i: rng.integers(1, sq_cfg.vocab, size=n) for i, n in enumerate(s_lens)}
    sm_prompts = {i: rng.integers(1, sm_cfg.vocab, size=n) for i, n in enumerate(s_lens)}
    parity_kw = {"max_seq": 64, "batch_size": 4}
    jobs = {(1, 2): {"qwen2": ((q_cfg, 0, q_knobs, q_prompts, 6), parity_kw),
                     "olmoe": ((m_cfg, 0, m_knobs, m_prompts, 6),
                               {"max_seq": 64, "batch_size": 3}),
                     **fam,
                     "qwen2_served": ((sq_cfg, 0, served_knobs, s_prompts, 16),
                                      {"max_seq": 128, "batch_size": 4, "hold": True,
                                       "timed_steps": 8}),
                     "olmoe_served": ((sm_cfg, 0, served_knobs, sm_prompts, 16),
                                      {"max_seq": 128, "batch_size": 4, "hold": True,
                                       "timed_steps": 8}),
                     **fam_served},
            (1, 4): {"qwen2": ((q_cfg, 0, q_knobs, q_prompts, 6), parity_kw),
                     "olmoe": ((m_cfg, 0, m_knobs, m_prompts, 6),
                               {"max_seq": 64, "batch_size": 3}),
                     **fam},
            (2, 2): {"qwen2": ((q_cfg, 0, q_knobs, q_prompts, 6), parity_kw),
                     "internvl2": fam["internvl2"]}}
    return {"jobs": jobs, "refs": refs, "q_cfg": q_cfg}


def _mesh_decode_refs(plan: dict) -> dict:
    """The single-rank engine's tokens and logits of every parity job (on
    the card, in this process), then the ledger gates (host work)."""
    import torch

    from repro_torch.benchmarks.mesh_decode import ledger_checks
    from repro_torch.models import lm as M

    t0 = time.perf_counter()
    wants = {}
    for name, (cfg, knobs, prompts, steps, batch, max_seq, extras) in plan["refs"].items():
        wants[name] = _mesh_ref(cfg, knobs, prompts, steps, batch, max_seq, extras)
        gc.collect()
        torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    q_cfg = plan["q_cfg"]
    rows, slices, failures = ledger_checks(q_cfg, M.init_lm(q_cfg, 0, device="cpu"),
                                           {"data": 1, "model": 2}, 0.05, 16)
    return {"wants": wants, "reference_s": ref_s, "ledger": (rows, slices, failures),
            "ledger_s": time.perf_counter() - t1}


def phase_mesh_decode(plan: dict, refs: dict, ranks_by_shape: dict, spawns: dict) -> dict:
    """Tensor-parallel paired decode: ranks of ``launch.mesh.spawn`` (one
    process each, gloo, every rank on this one card) each serving its
    shards through ``ServeEngine(mesh=...)``; the spawns are
    :func:`phase_mesh`'s, shared with phase 28.  Parity (fp32, r = 0, seed-0
    weights regenerated on every rank): qwen2-1.5b at full width, 2 layers,
    column-blocked bn=16 on meshes (1, 2), (1, 4), (2, 2); olmoe-1b-7b at
    full width, 2 layers, structured, on (1, 2) and (1, 4), a 40-token
    prompt on the expert-parallel route; the five other families of
    :data:`MESH_FAMILIES` at full width, structured, on (1, 2) and (1, 4)
    (internvl2 on (2, 2) too), batch 4, each slot with its row of stub
    frames or patches: every rank's tokens equal the single-rank engine's
    on the card, logits ≤ 1e-5, and every weight and cache entry a rank
    holds shaped as its resolved spec gives (``mesh_decode.shard_shapes``).
    Served (bf16, structured r = 0.05, batch 4, (1, 2)): qwen2-1.5b at
    ``MESH_SERVED_QWEN2_LAYERS``, 16 tokens a slot, olmoe at
    ``MESH_SERVED_OLMOE_LAYERS`` and the five at ``MESH_SERVED_LAYERS``, 16
    tokens a slot: K1 launches and collectives a decode step and a prefill
    held to ``analysis``; decode ms (two ranks time-share one card, beside
    the other lane's ranks: no tensor-parallel speed is measured), each rank's
    wiring seconds (building its blocks leaf by leaf, and pairing them) and
    peak memory, the wiring's held to the bound of building rank-locally
    (``launch.steps.wiring_excess``: what the rank holds after it, plus two
    whole leaves); deepseek's served wiring peak recorded (a rank that built
    the whole model held 13.58 GB at 4 layers).  Ledgers: the
    three gates of ``repro_torch/benchmarks/mesh_decode.py`` at r = 0.05,
    bn=16, on the parity qwen2's weights at (1, 2)."""
    from repro_torch import analysis
    from repro_torch.benchmarks.mesh_decode import shard_shapes
    from repro_torch.kernels.ref import rel_err
    from repro_torch.launch.steps import WIRING_WHOLE_LEAVES, wiring_excess
    from repro_torch.parallel.sharding import Mesh

    t0 = time.perf_counter()
    wants = refs["wants"]
    meshes, k1_total, job_s = [], 0, {}
    for shape, mesh_jobs in plan["jobs"].items():
        ranks = ranks_by_shape.get(shape)
        if ranks is None:
            continue  # its spawn failed, and said so
        mesh_jobs = {n: j for n, j in mesh_jobs.items() if n in ranks[0]}
        job_s[str(shape)] = {name: max(r[name]["job_s"] for r in ranks) for name in mesh_jobs}
        mesh = Mesh(dict(zip(("data", "model"), shape, strict=True)))
        for name, ((cfg, _, knobs, prompts, steps), kw) in mesh_jobs.items():
            batch, max_seq = kw["batch_size"], kw["max_seq"]
            coll = analysis.mesh_decode_collectives(cfg, knobs, mesh, batch_size=batch,
                                                    max_seq=max_seq)
            pre_coll = analysis.mesh_prefill_collectives(cfg, knobs, mesh, batch_size=batch,
                                                         max_seq=max_seq)
            k1 = sum(analysis.decode_launches(cfg, cfg.layer_kind(i), knobs)["paired_matmul"]
                     for i in range(cfg.n_layers))
            k1_pre = analysis.prefill_launches(cfg, knobs)["paired_matmul"]
            want_tp = None
            if name.split("_")[0] in ("qwen2", "olmoe"):
                # the split the rules give: qwen2's 2 KV heads divide 2 ranks, not 4
                # (then the cache's positions take the axis); olmoe's 16 divide both
                kv = cfg.n_kv_heads % shape[1] == 0
                want_tp = {"vocab_split": True, "q_split": True, "kv_split": kv,
                           "cache_seq": not kv, "ff_split": cfg.moe is None,
                           "experts_split": cfg.moe is not None, "batch_split": shape[0] > 1}
            row = {"mesh": list(shape), "job": name, "arch": cfg.name, "layers": cfg.n_layers,
                   "dtype": cfg.dtype, "want_collectives_per_step": coll,
                   "want_collectives_per_prefill": pre_coll, "want_k1_per_step": k1,
                   "want_k1_per_prefill": k1_pre, "want_tp": want_tp, "ranks": []}
            for rec in ranks:
                got = rec[name]
                where = f"mesh_decode {shape} {name} rank {got['rank']}"
                k1_total += got["k1_launches"]
                if want_tp is not None:
                    check(got["tp"] == want_tp, f"{where}: layout {got['tp']}, want {want_tp}")
                rank_mesh = Mesh(mesh.shape, rank=got["rank"])
                w_shapes, c_shapes = shard_shapes(cfg, rank_mesh, batch, max_seq)
                check(got["shapes"] == w_shapes and got["cache_shapes"] == c_shapes,
                      f"{where}: weights or cache not shaped as the resolved specs give")
                calls = {k: v["calls"] for k, v in got["step_collectives"].items()}
                check(calls == coll, f"{where}: collectives a step {calls}, want {coll}")
                check(got["step_k1"] == k1, f"{where}: K1 launches a step {got['step_k1']}, "
                                            f"want {k1}")
                if got["prefill_k1"] is not None:
                    pre = {k: v["calls"] for k, v in got["prefill_collectives"].items()}
                    check(pre == pre_coll and got["prefill_k1"] == k1_pre,
                          f"{where}: a prefill's collectives {pre} and K1 launches "
                          f"{got['prefill_k1']}, want {pre_coll} and {k1_pre}")
                excess = wiring_excess(got)
                check(excess is not None and excess <= 0,
                      f"{where}: wiring peak {got.get('wire_peak_bytes')} B past its blocks, "
                      f"metadata and cache ({got['held_bytes']} B) and "
                      f"{WIRING_WHOLE_LEAVES} whole leaves of {got['leaf_bytes']} B")
                r = {"rank": got["rank"], "coords": got["coords"], "wire_s": got["wire_s"],
                     "build_s": got["wire_seconds"].get("build"),
                     "pair_s": got["wire_seconds"].get("pair"),
                     "held_gb": got["held_bytes"] / 1e9, "leaf_gb": got["leaf_bytes"] / 1e9,
                     "wiring_excess_gb": excess / 1e9,
                     "k1_launches": got["k1_launches"], "step_k1": got["step_k1"],
                     "step_collectives": got["step_collectives"],
                     "wire_peak_gb": (got["wire_peak_bytes"] or 0) / 1e9,
                     "serve_peak_gb": got.get("peak_bytes", 0) / 1e9, "tp": got["tp"],
                     "tp_segments": got["tp_segments"], "tp_encoder": got["tp_encoder"],
                     "moe_shard_map_calls": got["moe_shard_map_calls"]}
                if name in wants:
                    want_tok, want_logits = wants[name]
                    r["tokens_identical"] = got["tokens"] == want_tok
                    r["max_logit_rel_err"] = rel_err(got["logits"], want_logits)
                    check(r["tokens_identical"], f"{where}: tokens {got['tokens']} vs "
                                                 f"single-rank {want_tok}")
                    check(r["max_logit_rel_err"] <= FP32_RTOL,
                          f"{where}: logits {r['max_logit_rel_err']:.3g}")
                if name in ("olmoe", "deepseek"):  # the 40-token prefill dispatches
                    mo = cfg.moe
                    routed = sum(len(p) * mo.top_k > 2 * mo.n_experts for p in prompts.values())
                    n_moe = sum(cfg.layer_kind(i) == "moe" for i in range(cfg.n_layers))
                    check(routed >= 1 and got["moe_shard_map_calls"] == routed * n_moe,
                          f"{where}: {got['moe_shard_map_calls']} expert-parallel prefill "
                          f"layers for {routed} routed prompt(s)")
                if "step_ms" in got:
                    ms = sorted(got["step_ms"])
                    r["decode_ms_median"] = ms[len(ms) // 2]
                    r["decode_ms_p90"] = ms[int(0.9 * (len(ms) - 1))]
                    r["tokens"] = {s: t[:8] for s, t in got["tokens"].items()}
                    check(all(len(t) == steps for t in got["tokens"].values()),
                          f"{where}: tokens")
                row["ranks"].append(r)
            if name.endswith("served"):
                toks = [rec[name]["tokens"] for rec in ranks]
                check(all(t == toks[0] for t in toks),
                      f"mesh_decode {name}: the ranks returned different tokens")
            meshes.append(row)
    rows, slices, failures = refs["ledger"]
    for f in failures:
        check(False, f"mesh_decode ledger: {f}")
    check(len(slices) == 2, f"mesh_decode ledger: slice checks {slices}")
    out = {"phase": "mesh_decode", "card": _card(), "backend": "gloo",
           "ranks_share_one_card": True, "reference_s": refs["reference_s"],
           "spawns": spawns, "job_s": job_s, "ledger_s": refs["ledger_s"],
           "check_s": time.perf_counter() - t0,
           "served_layers": {"qwen2-1.5b": MESH_SERVED_QWEN2_LAYERS,
                             MOE_ARCH: MESH_SERVED_OLMOE_LAYERS,
                             **MESH_SERVED_LAYERS},
           "main_path_launches": {"paired_matmul": k1_total, "decode_attention": 0,
                                  "flash_attention": 0},
           "runs": meshes,
           # a rank that built the whole fp32 model held 13.58 GB at 4 layers
           "deepseek_served_wire_peak_gb": [
               r["wire_peak_gb"] for row in meshes if row["job"] == "deepseek_served"
               for r in row["ranks"]],
           "ledger": {"mesh": [1, 2], "rounding": 0.05, "block_n": 16, "rows": rows,
                      "slice_checks": slices}}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phases 14 and 15: the MoE serving path (olmoe-1b-7b)
# ---------------------------------------------------------------------------

MOE_ARCH = "olmoe-1b-7b"


def _moe_routes():
    """Counts of the routed MoE dispatches (``_moe_route`` calls) in a block."""
    from repro_torch.analysis import counting
    from repro_torch.models.layers import _moe_route

    return counting(moe_routes=(_moe_route,))


def phase_moe_parity() -> dict:
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.analysis import decode_launches
    from repro_torch.configs import get_config
    from repro_torch.kernels.ref import rel_err
    from repro_torch.launch.serve import kernel_launches
    from repro_torch.models import lm as M
    from repro_torch.serving.engine import ServeEngine

    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=2, dtype="float32")
    model = M.init_lm(cfg, 0)
    base = dict(q_chunk=32, k_chunk=32)
    t0 = time.perf_counter()
    plain = ServeEngine(cfg, model, max_seq=64, batch_size=2, knobs=M.PerfKnobs(**base))
    paired = ServeEngine(cfg, model, max_seq=64, batch_size=2, knobs=M.PerfKnobs(
        **base, gemm="pallas_paired", attn="pallas_fused"))
    pairing_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    prompts = {0: rng.integers(0, cfg.vocab, size=11), 1: rng.integers(0, cfg.vocab, size=24)}
    errs = []
    for prompt in prompts.values():
        tokens = torch.as_tensor(prompt[None], device="cuda")
        want = M.prefill(cfg, plain.model, tokens, knobs=plain.knobs)[0]
        errs.append(rel_err(M.prefill(cfg, paired.model, tokens, knobs=paired.knobs)[0], want))

    _reset_launches()  # the path's own counts from here
    with _moe_routes() as routes:
        toks = {name: {s: [eng.add_request(s, p)] for s, p in prompts.items()}
                for name, eng in (("plain", plain), ("paired", paired))}
    prefill_launches = kernel_launches()
    before = kernel_launches()
    for _ in range(5):
        for name, eng in (("plain", plain), ("paired", paired)):
            nxt = eng.step()
            for s in prompts:
                toks[name][s].append(int(nxt[s]))
        errs.append(rel_err(paired.last_logits, plain.last_logits))
    decode = {k: v - before[k] for k, v in kernel_launches().items()}
    launches = kernel_launches()
    per_layer = {k: v / (5 * cfg.n_layers) for k, v in decode.items()}
    prof = profile_step(paired.step)
    prof_per_layer = {k: prof[k]["launches"] / cfg.n_layers for k in ("K1", "K2")}
    want = decode_launches(cfg, "moe", paired.knobs)
    mo = cfg.moe
    routed = [len(p) for p in prompts.values() if len(p) * mo.top_k > 2 * mo.n_experts]
    check(toks["paired"] == toks["plain"], f"moe_parity tokens differ: {toks}")
    check(max(errs) <= FP32_RTOL, f"moe_parity logits rel err {max(errs):.3g}")
    # the 24-token prompt dispatches in every layer of both engines, the
    # 11-token one takes the dense branch
    check(routes["moe_routes"] == 2 * len(routed) * cfg.n_layers and routed == [24],
          f"moe_parity routed prefills {routes['moe_routes']} for prompts {routed}")
    # a prefill layer: 3 QKV, the out-projection and 3 expert launches of K1
    check(prefill_launches["paired_matmul"] == 7 * cfg.n_layers * len(prompts),
          f"moe_parity prefill launches {prefill_launches}")
    check(per_layer == want, f"moe_parity launches per decode layer {per_layer}, want {want}")
    check(prof_per_layer == {"K1": want["paired_matmul"], "K2": want["decode_attention"]}
          or prof["device_ms"] == "not measured",
          f"moe_parity profiler launches per decode layer {prof_per_layer}")
    out = {
        "phase": "moe_parity", "arch": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype,
        "pairing": "structured, r=0", "pairing_s": pairing_s,
        "prompts": [len(p) for p in prompts.values()], "routed_prompts": routed,
        "routed_prefills": routes["moe_routes"],
        "tokens": toks["paired"], "tokens_identical": toks["paired"] == toks["plain"],
        "max_logit_rel_err": max(errs), "main_path_launches": launches,
        "prefill_launches": prefill_launches, "decode_launches_per_layer": per_layer,
        "profiled_step": prof, "profiled_launches_per_layer": prof_per_layer,
    }
    emit(out)
    return out


def _k1_expert_at(block, name, x, act: str = "none", tag: str = "moe_serve") -> dict:
    """K1 over the expert grid on one expert weight of the serving engine
    (its real per-expert segments, one block an expert), for activations
    ``x``: shared (M, K) or per-expert (E, M, K).  The kernel against its
    plain version (bf16 ulps, a relaunch bit-identical), device ms beside
    the plain version, ``torch.einsum`` on the folded experts and the bound
    (the live weight rows, the gathered x and the output, once each)."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels import paired_matmul as pm
    from repro_torch.kernels.ref import bf16_ulps

    dt = x.dtype
    w = getattr(block, name).to(dt)
    meta = block.pairing[name]
    seg = ops.lm_expert_segments(w, meta)
    E, K, n_ff = w.shape
    per_expert = x.ndim == 3
    M = x.shape[-2]
    xg = ops.expert_rows(x, seg, per_expert).contiguous()
    kmat, w_res = seg.kmat.contiguous(), seg.w_res.contiguous()
    kw = dict(n_cols=seg.n_cols, activation=act)
    launch = lambda: pm.paired_matmul_blocked_cuda(xg, kmat, w_res, **kw)
    got = launch()
    check(torch.equal(launch(), got), f"{tag} K1 {name}: two launches differ")
    check(torch.equal(got.reshape(M, E, n_ff),
                      ops.expert_dense(x, seg, activation=act, x_per_expert=per_expert)),
          f"{tag} K1 {name}: expert_dense differs from its own launch")
    want = pm.paired_matmul_blocked_plain(xg, kmat, w_res, out_dtype=torch.float32, **kw)
    folded = ops.fold_lm_expert_weight(w, meta)
    eq = "etd,edf->tef" if per_expert else "td,edf->tef"
    fn = {"none": lambda t: t, "silu": F.silu}[act]
    p_live, r_live = int(meta["pair_mask"].sum()), int(meta["resid_mask"].sum())
    item = x.element_size()
    nbytes = (M * (2 * p_live + r_live) + (p_live + r_live) * n_ff + M * E * n_ff) * item
    flops = M * (2 * n_ff * (p_live + r_live) + p_live)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
    ms = graph_ms(launch)
    library_ms = graph_ms(lambda: fn(torch.einsum(eq, x, folded)))
    return {
        "weight": name, "x": "per_expert" if per_expert else "shared", "M": M, "E": E,
        "K": K, "bn": n_ff, "n_cols": seg.n_cols, "Pmax": kmat.shape[1],
        "Rmax": w_res.shape[1], "pairs_live": p_live, "resid_live": r_live,
        "plan": dataclasses.asdict(pm.launch_plan(xg, kmat, w_res)),
        "ulps": bf16_ulps(got, want), "ms": ms,
        "plain_ms": graph_ms(lambda: pm.paired_matmul_blocked_plain(xg, kmat, w_res, **kw)),
        "library_ms": library_ms,
        "library_call": f"activation(torch.einsum('{eq}', x, folded experts))",
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "flops": flops, "kernel_over_bound": ms / max(t_bytes, t_ops),
        # the weight stream unpaired: every expert's K × F matrix
        "unpaired_weight_bytes": E * K * n_ff * item,
    }


def phase_moe_serve() -> dict:
    import math

    import numpy as np
    import torch

    from repro_torch.analysis import decode_launches
    from repro_torch.launch.serve import kernel_launches, serve

    steps, batch, lens = 32, 4, [12, 16, 24, 64]
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()  # the path's own counts from here
    with _moe_routes() as routes:
        rec = serve(arch=MOE_ARCH, batch=batch, max_seq=256, steps=steps, pair_rounding=0.05,
                    gemm="pallas_paired", attn="pallas_fused", prompt_lens=lens,
                    layers=SERVE_DEPTH_CUTS[MOE_ARCH])
    launches = kernel_launches()
    eng = rec["engine"]
    cfg, L = eng.cfg, eng.cfg.n_layers
    mo = cfg.moe
    routed = [n for n in lens if n * mo.top_k > 2 * mo.n_experts]
    dec = rec["launches"]["decode"]
    per_layer = {k: v / ((steps - 1) * L) for k, v in dec.items()}
    want = decode_launches(cfg, "moe", eng.knobs)
    toks = rec["outputs"]
    check(routes["moe_routes"] == len(routed) * L and len(routed) == 2,
          f"moe_serve routed prefills {routes['moe_routes']} for prompts {lens}")
    check(per_layer == want, f"moe_serve launches per decode layer {per_layer}, want {want}")
    check(all(len(t) == steps and all(0 <= x < cfg.vocab for x in t) for t in toks.values()),
          "moe_serve: tokens out of range")
    check(bool(np.isfinite(eng.last_logits).all())
          and eng.last_logits.shape == (batch, cfg.vocab), "moe_serve: bad logits")
    prof = profile_step(eng.step)
    prof_per_layer = {k: prof[k]["launches"] / L for k in ("K1", "K2")}
    check(prof_per_layer == {"K1": want["paired_matmul"], "K2": want["decode_attention"]}
          or prof["device_ms"] == "not measured",
          f"moe_serve profiler launches per decode layer {prof_per_layer}")

    moe0 = eng.model.layers[0].moe
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = lambda *shape: torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)
    d, E, F = cfg.d_model, mo.n_experts, mo.d_ff_expert
    cap = max(1, math.ceil(max(lens) * mo.top_k / E * mo.capacity_factor))
    k1 = [_k1_expert_at(moe0, "w_gate", x(batch, d), "silu"),
          _k1_expert_at(moe0, "w_down", x(E, batch, F)),
          _k1_expert_at(moe0, "w_gate", x(E, cap, d), "silu")]
    k2 = _k2_at(eng)
    for row in k1:
        check(row["ulps"] <= BF16_MAX_ULPS, f"moe_serve K1 {row['weight']} {row['ulps']:.3g} ulps")
    check(k2["ulps"] <= BF16_MAX_ULPS, f"moe_serve K2 {k2['ulps']:.3g} ulps")
    step_ms = sorted(rec["step_ms"])
    rp = eng.pair_report
    experts = [leaf for leaf in rp.leaves if ".moe." in leaf.path]
    out = {
        "phase": "moe_serve", "arch": cfg.name, "layers": L, "dtype": cfg.dtype,
        "batch": batch, "max_seq": 256, "tokens_per_slot": steps, "prompts": lens,
        "routed_prompts": routed, "routed_prefills": routes["moe_routes"],
        "capacity_of_longest": cap,
        "pairing": {"mode": rp.mode, "rounding": rp.rounding, "total_pairs": rp.total_pairs,
                    "pair_fraction": rp.pair_fraction, "seconds": rec["pairing_s"],
                    "expert_pair_fraction": 2 * sum(leaf.n_pairs for leaf in experts)
                    / sum(leaf.n_weights for leaf in experts)},
        "prefill_ms": rec["prefill_ms"],
        "decode_ms": {"median": step_ms[len(step_ms) // 2],
                      "p90": step_ms[int(0.9 * (len(step_ms) - 1))], "n": len(step_ms)},
        "tokens_per_s": rec["tokens_per_s"], "seconds": rec["seconds"],
        "main_path_launches": launches, "prefill_launches": rec["launches"]["prefill"],
        "decode_launches_per_layer": per_layer, "profiled_step": prof,
        "profiled_launches_per_layer": prof_per_layer, "k1_expert_grid": k1, "k2": k2,
        "device_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "tokens": {s: t[:8] for s, t in toks.items()},
    }
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phases 16 and 17: the MLA serving path (deepseek-v2-lite-16b)
# ---------------------------------------------------------------------------

MLA_ARCH = "deepseek-v2-lite-16b"

#: serve phases run below their published depth, so that the whole script
#: fits its time limit with the mesh_train phase (PERF.md §4): arch →
#: layers (published: olmoe 16, deepseek 27, mamba2 64, hymba 32, qwen3 36,
#: granite 40, internvl2 24, mistral 88, of which one card holds 4); deepseek
#: keeps its dense layer and two MoE layers, hymba its full layers 0 and 15
SERVE_DEPTH_CUTS = {"olmoe-1b-7b": 4, "deepseek-v2-lite-16b": 3, "mamba2-2.7b": 8,
                    "hymba-1.5b": 16, "qwen3-4b": 2, "granite-3-2b": 2, "internvl2-2b": 4,
                    "mistral-large-123b": 1}


def _per_step_want(cfg, knobs) -> dict[str, int]:
    """Launches of one decode step: ``decode_launches`` summed over the
    layers (their kinds differ: a dense first layer, then MoE)."""
    from repro_torch.analysis import decode_launches

    per = [decode_launches(cfg, cfg.layer_kind(i), knobs) for i in range(cfg.n_layers)]
    return {k: sum(p[k] for p in per) for k in per[0]}


def phase_mla_parity() -> dict:
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.analysis import decode_launches
    from repro_torch.configs import get_config
    from repro_torch.kernels.ref import rel_err
    from repro_torch.launch.serve import kernel_launches
    from repro_torch.models import lm as M
    from repro_torch.serving.engine import ServeEngine

    # layer 0 dense, layer 1 MoE: both kinds of layer
    cfg = dataclasses.replace(get_config(MLA_ARCH), n_layers=2, dtype="float32")
    model = M.init_lm(cfg, 0)
    base = dict(q_chunk=32, k_chunk=32)
    t0 = time.perf_counter()
    plain = ServeEngine(cfg, model, max_seq=64, batch_size=2, knobs=M.PerfKnobs(**base))
    paired = ServeEngine(cfg, model, max_seq=64, batch_size=2, knobs=M.PerfKnobs(
        **base, gemm="pallas_paired", attn="pallas_fused"))
    pairing_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    prompts = {0: rng.integers(0, cfg.vocab, size=11), 1: rng.integers(0, cfg.vocab, size=24)}
    errs = []
    for prompt in prompts.values():
        tokens = torch.as_tensor(prompt[None], device="cuda")
        want, want_cache = M.prefill(cfg, plain.model, tokens, knobs=plain.knobs)
        got, got_cache = M.prefill(cfg, paired.model, tokens, knobs=paired.knobs)
        errs += [rel_err(got, want)] + [rel_err(got_cache[k], want_cache[k]) for k in want_cache]

    _reset_launches()  # the path's own counts from here
    with _moe_routes() as routes:
        toks = {name: {s: [eng.add_request(s, p)] for s, p in prompts.items()}
                for name, eng in (("plain", plain), ("paired", paired))}
    prefill_launches = kernel_launches()
    before = kernel_launches()
    for _ in range(5):
        for name, eng in (("plain", plain), ("paired", paired)):
            nxt = eng.step()
            for s in prompts:
                toks[name][s].append(int(nxt[s]))
        errs.append(rel_err(paired.last_logits, plain.last_logits))
    decode = {k: v - before[k] for k, v in kernel_launches().items()}
    launches = kernel_launches()
    per_step = {k: v / 5 for k, v in decode.items()}
    prof = profile_step(paired.step)
    prof_per_step = {k: prof[k]["launches"] for k in ("K1", "K2")}
    want = _per_step_want(cfg, paired.knobs)
    mo = cfg.moe
    routed = [len(p) for p in prompts.values() if len(p) * mo.top_k > 2 * mo.n_experts]
    n_moe = sum(cfg.layer_kind(i) == "moe" for i in range(cfg.n_layers))
    check(toks["paired"] == toks["plain"], f"mla_parity tokens differ: {toks}")
    check(max(errs) <= FP32_RTOL, f"mla_parity logits/cache rel err {max(errs):.3g}")
    # the 24-token prompt dispatches in the MoE layer of both engines, the
    # 11-token one takes the dense branch
    check(routes["moe_routes"] == 2 * len(routed) * n_moe and routed == [24],
          f"mla_parity routed prefills {routes['moe_routes']} for prompts {routed}")
    # a prefill launches what a decode step does: 7 K1 (dense), 10 (MoE)
    check(prefill_launches == {**want, "paired_matmul": want["paired_matmul"] * len(prompts)},
          f"mla_parity prefill launches {prefill_launches}")
    check(per_step == want, f"mla_parity launches per decode step {per_step}, want {want}")
    check(prof_per_step == {"K1": want["paired_matmul"], "K2": want["decode_attention"]}
          or prof["device_ms"] == "not measured",
          f"mla_parity profiler launches per decode step {prof_per_step}")
    out = {
        "phase": "mla_parity", "arch": cfg.name, "layers": cfg.n_layers,
        "layer_kinds": [cfg.layer_kind(i) for i in range(cfg.n_layers)], "dtype": cfg.dtype,
        "pairing": "structured, r=0", "pairing_s": pairing_s,
        "prompts": [len(p) for p in prompts.values()], "routed_prompts": routed,
        "routed_prefills": routes["moe_routes"],
        "tokens": toks["paired"], "tokens_identical": toks["paired"] == toks["plain"],
        "max_logit_rel_err": max(errs), "main_path_launches": launches,
        "prefill_launches": prefill_launches, "decode_launches_per_step": per_step,
        "decode_launches_per_layer": {k: decode_launches(cfg, k, paired.knobs)
                                      for k in ("dense", "moe")},
        "profiled_step": prof, "profiled_launches_per_step": prof_per_step,
    }
    emit(out)
    return out


def _memory_reckoning(eng) -> dict:
    """The engine's bytes on the card by kind: every parameter as an fp32
    master (what ``init_lm`` made), as held now, and the segments and casts
    its frozen blocks derived."""
    import torch

    params = list(eng.model.parameters())
    seen = {p.data_ptr() for p in params}  # a cast to a weight's own dtype is the weight
    derived = 0
    for block in eng.model.modules():
        for v in getattr(block, "_derived", {}).values():
            for t in v if isinstance(v, tuple) else (v,):
                if isinstance(t, torch.Tensor) and t.data_ptr() not in seen:
                    seen.add(t.data_ptr())
                    derived += t.numel() * t.element_size()
    cache = sum(t.numel() * t.element_size() for t in eng.cache.values())
    return {"fp32_masters_gb": sum(p.numel() for p in params) * 4 / 1e9,
            "weights_held_gb": sum(p.numel() * p.element_size() for p in params) / 1e9,
            "derived_segments_gb": derived / 1e9, "cache_gb": cache / 1e9,
            "allocated_gb": torch.cuda.memory_allocated() / 1e9,
            "card_total_gb": torch.cuda.get_device_properties(0).total_memory / 1e9}


def phase_mla_serve() -> dict:
    import math

    import numpy as np
    import torch

    from repro_torch.analysis import decode_launches
    from repro_torch.launch.serve import kernel_launches, serve

    steps, batch, lens = 32, 4, [12, 16, 24, 64]
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()  # the path's own counts from here
    with _moe_routes() as routes:
        rec = serve(arch=MLA_ARCH, batch=batch, max_seq=256, steps=steps, pair_rounding=0.05,
                    gemm="pallas_paired", attn="pallas_fused", prompt_lens=lens,
                    layers=SERVE_DEPTH_CUTS[MLA_ARCH])
    launches = kernel_launches()
    peak = torch.cuda.max_memory_allocated()
    eng = rec["engine"]
    cfg, L = eng.cfg, eng.cfg.n_layers
    mo = cfg.moe
    routed = [n for n in lens if n * mo.top_k > 2 * mo.n_experts]
    n_moe = sum(cfg.layer_kind(i) == "moe" for i in range(L))
    dec = rec["launches"]["decode"]
    per_step = {k: v / (steps - 1) for k, v in dec.items()}
    want = _per_step_want(cfg, eng.knobs)
    toks = rec["outputs"]
    memory = {"peak_gb": peak / 1e9, **_memory_reckoning(eng)}
    check(L == SERVE_DEPTH_CUTS[MLA_ARCH]
          and cfg.segments() == (("dense", 1), ("moe", L - 1)),
          f"mla_serve runs {cfg.segments()}, not {SERVE_DEPTH_CUTS[MLA_ARCH]} layers")
    check(routes["moe_routes"] == len(routed) * n_moe and len(routed) == 2,
          f"mla_serve routed prefills {routes['moe_routes']} for prompts {lens}")
    check(per_step == want, f"mla_serve launches per decode step {per_step}, want {want}")
    check(rec["launches"]["prefill"]["paired_matmul"] == want["paired_matmul"] * len(lens),
          f"mla_serve prefill launches {rec['launches']['prefill']}")
    check(all(len(t) == steps and all(0 <= x < cfg.vocab for x in t) for t in toks.values()),
          "mla_serve: tokens out of range")
    check(bool(np.isfinite(eng.last_logits).all())
          and eng.last_logits.shape == (batch, cfg.vocab), "mla_serve: bad logits")
    check(peak < memory["card_total_gb"] * 1e9, f"mla_serve peak memory {memory}")
    prof = profile_step(eng.step)
    prof_per_step = {k: prof[k]["launches"] for k in ("K1", "K2")}
    check(prof_per_step == {"K1": want["paired_matmul"], "K2": want["decode_attention"]}
          or prof["device_ms"] == "not measured",
          f"mla_serve profiler launches per decode step {prof_per_step}")

    layer0, layer1 = eng.model.layers[0], eng.model.layers[1]
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = lambda *shape: torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)
    d, E, F = cfg.d_model, mo.n_experts, mo.d_ff_expert
    attn, moe1 = layer1.attn, layer1.moe
    k1 = [_k1_at(attn, "wq", x(batch, d)), _k1_at(attn, "w_dkv", x(batch, d)),
          _k1_at(attn, "w_kr", x(batch, d)),
          _k1_at(layer0.mlp, "w_down", x(batch, mo.d_ff_dense), x(batch, d)),
          _k1_at(moe1.shared, "w_gate", x(batch, d))]
    k1_grid = [_k1_expert_at(moe1, "w_gate", x(batch, d), "silu", tag="mla_serve"),
               _k1_expert_at(moe1, "w_down", x(E, batch, F), tag="mla_serve")]
    for row in k1 + k1_grid:
        check(row["ulps"] <= BF16_MAX_ULPS, f"mla_serve K1 {row['weight']} {row['ulps']:.3g} ulps")
    step_ms = sorted(rec["step_ms"])
    rp = eng.pair_report
    experts = [leaf for leaf in rp.leaves if ".moe.w_" in leaf.path]
    out = {
        "phase": "mla_serve", "arch": cfg.name, "layers": L, "segments": cfg.segments(),
        "dtype": cfg.dtype, "batch": batch, "max_seq": 256, "tokens_per_slot": steps,
        "prompts": lens, "routed_prompts": routed, "routed_prefills": routes["moe_routes"],
        "capacity_of_longest": max(1, math.ceil(max(lens) * mo.top_k / E * mo.capacity_factor)),
        "pairing": {"mode": rp.mode, "rounding": rp.rounding, "total_pairs": rp.total_pairs,
                    "pair_fraction": rp.pair_fraction, "seconds": rec["pairing_s"],
                    "expert_pair_fraction": 2 * sum(leaf.n_pairs for leaf in experts)
                    / sum(leaf.n_weights for leaf in experts)},
        "prefill_ms": rec["prefill_ms"],
        "decode_ms": {"median": step_ms[len(step_ms) // 2],
                      "p90": step_ms[int(0.9 * (len(step_ms) - 1))], "n": len(step_ms)},
        "tokens_per_s": rec["tokens_per_s"], "seconds": rec["seconds"],
        "main_path_launches": launches, "prefill_launches": rec["launches"]["prefill"],
        "decode_launches_per_step": per_step,
        "decode_launches_per_layer": {k: decode_launches(cfg, k, eng.knobs)
                                      for k in ("dense", "moe")},
        "profiled_step": prof, "profiled_launches_per_step": prof_per_step,
        "k1_new_shapes": k1, "k1_expert_grid": k1_grid, "device_memory": memory,
        "tokens": {s: t[:8] for s, t in toks.items()},
    }
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phases 18-21: the SSM (mamba2-2.7b) and hybrid (hymba-1.5b) serving paths
# ---------------------------------------------------------------------------

SSM_ARCH, HYBRID_ARCH = "mamba2-2.7b", "hymba-1.5b"


def _prefill_want(cfg, knobs, n_prompts: int) -> dict[str, int]:
    """Launches of ``n_prompts`` prefills (``analysis.prefill_launches``:
    a prefill layer runs each of its GEMMs once, as a decode layer without
    the fused attention does; K2 is decode only; K3 runs whisper's encoder
    and cross-attention)."""
    from repro_torch.analysis import prefill_launches

    return {k: v * n_prompts for k, v in prefill_launches(cfg, knobs).items()}


def _slot_extras(cfg, n: int) -> dict[int, dict]:
    """Each slot's stub frames or patches (``launch.inputs.make_batch``,
    seed 0, row ``slot``), as ``launch.serve.serve`` feeds them; empty for
    a model that reads tokens alone."""
    from repro_torch.launch.inputs import make_batch
    from repro_torch.models import lm as M

    stubs = make_batch(cfg, n, 1, "prefill", seed=0)
    return {s: {k: stubs[k][s:s + 1] for k in M.EXTRAS if k in stubs} for s in range(n)}


def _masked_keys(cfg, eng) -> list[int]:
    """Keys at or before each slot's position that its swa layers' window
    drops (0 without a window)."""
    import torch

    from repro_torch.kernels.decode_attention import decode_mask

    if not cfg.sliding_window:
        return [0] * eng.batch_size
    pos = torch.as_tensor(eng.pos + cfg.meta_tokens)
    S = int(pos.max()) + 1
    ok = decode_mask(pos, S, cfg.sliding_window, cfg.meta_tokens).sum(-1)
    return [int(p) + 1 - int(k) for p, k in zip(pos.tolist(), ok.tolist())]


def phase_state_parity(tag: str, cfg, lens: list[int], max_seq: int) -> dict:
    """The plain engine (``torch.matmul``, plain attention) against the
    paired one (structured r=0; K1, K2 for decode attention, K3 for
    whisper's encoder and cross-attention) at full width, a few layers,
    fp32: the prefills' logits and every cache entry, tokens and logits of
    6 tokens a slot, and the caches after them, identical tokens and ≤ 1e-5
    relative; launches of the prefills and of a decode step held to
    ``analysis.prefill_launches`` and ``decode_launches``, by the wrappers
    and the profiler.  An encoder-decoder or vision-language slot gets its
    stub frames or patches (:func:`_slot_extras`)."""
    import numpy as np
    import torch

    from repro_torch.kernels.ref import rel_err
    from repro_torch.launch.serve import kernel_launches
    from repro_torch.models import lm as M
    from repro_torch.serving.engine import ServeEngine

    model = M.init_lm(cfg, 0)
    base = dict(q_chunk=32, k_chunk=32)
    t0 = time.perf_counter()
    plain = ServeEngine(cfg, model, max_seq=max_seq, batch_size=len(lens),
                        knobs=M.PerfKnobs(**base))
    paired = ServeEngine(cfg, model, max_seq=max_seq, batch_size=len(lens), knobs=M.PerfKnobs(
        **base, gemm="pallas_paired", attn="pallas_fused"))
    pairing_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    prompts = {s: rng.integers(0, cfg.vocab, size=n) for s, n in enumerate(lens)}
    extras = _slot_extras(cfg, len(lens))
    errs: dict[str, float] = {}

    def err(name: str, got, want) -> None:
        errs[name] = max(errs.get(name, 0.0), rel_err(got, want))

    for s, prompt in prompts.items():
        tokens = torch.as_tensor(prompt[None], device="cuda")
        want, want_cache = M.prefill(cfg, plain.model, tokens, knobs=plain.knobs,
                                     extras=extras[s])
        got, got_cache = M.prefill(cfg, paired.model, tokens, knobs=paired.knobs,
                                   extras=extras[s])
        err("prefill_logits", got, want)
        for k in want_cache:
            err(f"prefill_{k}", got_cache[k], want_cache[k])

    _reset_launches()  # the path's own counts from here
    toks = {name: {s: [eng.add_request(s, p, extras[s])] for s, p in prompts.items()}
            for name, eng in (("plain", plain), ("paired", paired))}
    prefill_launches = kernel_launches()
    before = kernel_launches()
    for _ in range(5):
        for name, eng in (("plain", plain), ("paired", paired)):
            nxt = eng.step()
            for s in prompts:
                toks[name][s].append(int(nxt[s]))
        err("decode_logits", paired.last_logits, plain.last_logits)
    decode = {k: v - before[k] for k, v in kernel_launches().items()}
    launches = kernel_launches()
    for k in plain.cache:
        err(f"cache_{k}", paired.cache[k], plain.cache[k])
    masked = _masked_keys(cfg, paired)
    per_step = {k: v / 5 for k, v in decode.items()}
    prof = profile_step(paired.step)
    prof_per_step = {k: prof[k]["launches"] for k in ("K1", "K2")}
    want = _per_step_want(cfg, paired.knobs)
    check(toks["paired"] == toks["plain"], f"{tag} tokens differ: {toks}")
    check(max(errs.values()) <= FP32_RTOL, f"{tag} logits/cache rel err {errs}")
    check(prefill_launches == _prefill_want(cfg, paired.knobs, len(prompts)),
          f"{tag} prefill launches {prefill_launches}")
    check(per_step == want, f"{tag} launches per decode step {per_step}, want {want}")
    check(prof_per_step == {"K1": want["paired_matmul"], "K2": want["decode_attention"]}
          or prof["device_ms"] == "not measured",
          f"{tag} profiler launches per decode step {prof_per_step}")
    if cfg.sliding_window:  # the long prompt's window drops keys in the decode
        check(max(masked) > 0, f"{tag}: no slot's window masks a key ({masked})")
    out = {
        "phase": tag, "arch": cfg.name, "layers": cfg.n_layers,
        "layer_kinds": [cfg.layer_kind(i) for i in range(cfg.n_layers)], "dtype": cfg.dtype,
        "pairing": "structured, r=0", "pairing_s": pairing_s, "prompts": lens,
        "window": cfg.sliding_window, "n_sink": cfg.meta_tokens,
        "masked_keys_at_last_step": masked,
        "tokens": toks["paired"], "tokens_identical": toks["paired"] == toks["plain"],
        "max_rel_err": max(errs.values()), "rel_err": errs, "main_path_launches": launches,
        "prefill_launches": prefill_launches, "decode_launches_per_step": per_step,
        "decode_launches_per_layer": _per_kind(cfg, paired.knobs),
        "profiled_step": prof, "profiled_launches_per_step": prof_per_step,
    }
    emit(out)
    return out


def _per_kind(cfg, knobs) -> dict:
    """``decode_launches`` of each layer kind of ``cfg``."""
    from repro_torch.analysis import decode_launches

    kinds = dict.fromkeys(cfg.layer_kind(i) for i in range(cfg.n_layers))
    return {k: decode_launches(cfg, k, knobs) for k in kinds}


def phase_ssm_parity() -> dict:
    import dataclasses

    from repro_torch.configs import get_config

    # a 300-token prompt crosses the 256-token chunk: the inter-chunk
    # recurrence runs
    cfg = dataclasses.replace(get_config(SSM_ARCH), n_layers=2, dtype="float32")
    return phase_state_parity("ssm_parity", cfg, [11, 300], max_seq=320)


def phase_hybrid_parity() -> dict:
    import dataclasses

    from repro_torch.configs import get_config

    # layers full, swa, swa; at 1200 tokens + 128 meta the window drops keys
    # 128…pos − 1024 in the prefill and the decode
    cfg = dataclasses.replace(get_config(HYBRID_ARCH), n_layers=3, full_attn_layers=(0,),
                              dtype="float32")
    return phase_state_parity("hybrid_parity", cfg, [11, 1200], max_seq=1216)


def _k2_windows(eng) -> dict:
    """The window, sinks and slot positions of every K2 launch of one decode
    step, recorded at ``ops``' call of the kernel's wrapper (which alone
    counts the launches)."""
    import collections

    from repro_torch.kernels import ops

    seen, real = collections.Counter(), ops.fused_decode_attention_cuda
    masking = []

    def record(*args, window=0, n_sink=0, **kw):
        seen[(window, n_sink)] += 1
        pos = args[3]
        if window:
            masking.append(int(pos.max()) + 1 - window > n_sink)
        return real(*args, window=window, n_sink=n_sink, **kw)

    ops.fused_decode_attention_cuda = record
    try:
        eng.step()
    finally:
        ops.fused_decode_attention_cuda = real
    return {"launches_by_window_sinks": {f"{w},{n}": c for (w, n), c in seen.items()},
            "windowed_launches_masking_keys": sum(masking)}


def phase_state_serve(tag: str, arch: str, lens: list[int], max_seq: int, k1_at,
                      layers: int | None = None) -> dict:
    """``arch`` at full width and depth (or ``layers`` layers), bf16,
    structured r=0.05, through ``launch.serve.serve``: batch 4, 32 tokens a
    slot; pairing seconds and pair fraction, prefill ms per request, decode
    ms per step, tokens/s, peak memory and its reckoning, launches of the
    prefills and a decode step held to ``prefill_launches`` and
    ``decode_launches``, a profiled step, K1 at the arch's shapes
    (``k1_at(eng, x)``) against its plain version and timed."""
    import numpy as np
    import torch

    from repro_torch.launch.serve import kernel_launches, serve

    steps, batch = 32, len(lens)
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()  # the path's own counts from here
    rec = serve(arch=arch, batch=batch, max_seq=max_seq, steps=steps, pair_rounding=0.05,
                gemm="pallas_paired", attn="pallas_fused", prompt_lens=lens, layers=layers)
    launches = kernel_launches()
    peak = torch.cuda.max_memory_allocated()
    eng = rec["engine"]
    cfg, L = eng.cfg, eng.cfg.n_layers
    per_step = {k: v / (steps - 1) for k, v in rec["launches"]["decode"].items()}
    want = _per_step_want(cfg, eng.knobs)
    toks = rec["outputs"]
    memory = {"peak_gb": peak / 1e9, **_memory_reckoning(eng)}
    check(per_step == want, f"{tag} launches per decode step {per_step}, want {want}")
    check(rec["launches"]["prefill"] == _prefill_want(cfg, eng.knobs, len(lens)),
          f"{tag} prefill launches {rec['launches']['prefill']}")
    check(all(len(t) == steps and all(0 <= x < cfg.vocab for x in t) for t in toks.values()),
          f"{tag}: tokens out of range")
    check(bool(np.isfinite(eng.last_logits).all())
          and eng.last_logits.shape == (batch, cfg.vocab), f"{tag}: bad logits")
    check(peak < memory["card_total_gb"] * 1e9, f"{tag} peak memory {memory}")
    prof = profile_step(eng.step)
    prof_per_step = {k: prof[k]["launches"] for k in ("K1", "K2")}
    check(prof_per_step == {"K1": want["paired_matmul"], "K2": want["decode_attention"]}
          or prof["device_ms"] == "not measured",
          f"{tag} profiler launches per decode step {prof_per_step}")
    gen = torch.Generator(device="cuda").manual_seed(6)
    x = lambda *shape: torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)
    k1 = k1_at(eng, x)
    for row in k1:
        check(row["ulps"] <= BF16_MAX_ULPS, f"{tag} K1 {row['weight']} {row['ulps']:.3g} ulps")
    step_ms = sorted(rec["step_ms"])
    rp = eng.pair_report
    pairing = {"mode": rp.mode, "rounding": rp.rounding, "total_pairs": rp.total_pairs,
               "pair_fraction": rp.pair_fraction, "seconds": rec["pairing_s"]}
    if cfg.ssm is not None:
        ssm = [leaf for leaf in rp.leaves if ".mamba." in leaf.path]
        pairing["ssm_pair_fraction"] = (2 * sum(leaf.n_pairs for leaf in ssm)
                                        / sum(leaf.n_weights for leaf in ssm))
    out = {
        "phase": tag, "arch": cfg.name, "layers": L, "segments": cfg.segments(),
        "encoder_layers": cfg.encoder and cfg.encoder.n_layers,
        "dtype": cfg.dtype, "batch": batch, "max_seq": max_seq, "tokens_per_slot": steps,
        "prompts": lens, "meta_tokens": cfg.meta_tokens, "window": cfg.sliding_window,
        "pairing": pairing,
        "prefill_ms": rec["prefill_ms"],
        "decode_ms": {"median": step_ms[len(step_ms) // 2],
                      "p90": step_ms[int(0.9 * (len(step_ms) - 1))], "n": len(step_ms)},
        "tokens_per_s": rec["tokens_per_s"], "seconds": rec["seconds"],
        "main_path_launches": launches, "prefill_launches": rec["launches"]["prefill"],
        "decode_launches_per_step": per_step,
        "decode_launches_per_layer": _per_kind(cfg, eng.knobs),
        "profiled_step": prof, "profiled_launches_per_step": prof_per_step,
        "k1_shapes": k1, "device_memory": memory,
        "tokens": {s: t[:8] for s, t in toks.items()},
    }
    return out, eng


def phase_ssm_serve() -> dict:
    def k1_at(eng, x):
        mamba, d = eng.model.layers[0].mamba, eng.cfg.d_model
        d_in = eng.cfg.ssm.expand * d
        return [_k1_at(mamba, "w_x", x(4, d)), _k1_at(mamba, "w_B", x(4, d)),
                _k1_at(mamba, "w_dt", x(4, d)), _k1_at(mamba, "w_out", x(4, d_in))]

    n = SERVE_DEPTH_CUTS[SSM_ARCH]
    out, eng = phase_state_serve("ssm_serve", SSM_ARCH, [12, 16, 24, 300], 512, k1_at,
                                 layers=n)
    check(out["layers"] == n and out["segments"] == (("ssm", n),),
          f"ssm_serve runs {out['segments']}, not {n} layers")
    emit(out)
    return out


def phase_hybrid_serve() -> dict:
    def k1_at(eng, x):
        layer, cfg = eng.model.layers[1], eng.cfg
        d, d_in = cfg.d_model, cfg.ssm.expand * cfg.d_model
        return [_k1_at(layer.attn, "wq", x(4, d)), _k1_at(layer.attn, "wk", x(4, d)),
                _k1_at(layer.mlp, "w_gate", x(4, d)),
                _k1_at(layer.mlp, "w_down", x(4, cfg.d_ff), x(4, d)),
                _k1_at(layer.mamba, "w_z", x(4, d)), _k1_at(layer.mamba, "w_B", x(4, d)),
                _k1_at(layer.mamba, "w_dt", x(4, d)), _k1_at(layer.mamba, "w_out", x(4, d_in))]

    n = SERVE_DEPTH_CUTS[HYBRID_ARCH]
    out, eng = phase_state_serve("hybrid_serve", HYBRID_ARCH, [12, 16, 24, 1200], 1280, k1_at,
                                 layers=n)
    cfg = eng.cfg
    check(out["layers"] == n and len(out["segments"]) == 3,
          f"hybrid_serve runs {out['segments']}, not {n} layers (full, swa, full)")
    # K2 on the swa layers with window 1024 and the 128 meta tokens as sinks,
    # on a slot whose window drops keys; no window on the full layers (the
    # sinks are passed, and mean nothing without one)
    k2_windows = _k2_windows(eng)
    n_swa = sum(cfg.layer_kind(i) == "hybrid_swa" for i in range(cfg.n_layers))
    check(k2_windows["launches_by_window_sinks"] == {
        f"{cfg.sliding_window},{cfg.meta_tokens}": n_swa,
        f"0,{cfg.meta_tokens}": cfg.n_layers - n_swa}
        and k2_windows["windowed_launches_masking_keys"] == n_swa,
        f"hybrid_serve K2 windows {k2_windows}")
    k2 = _k2_at(eng, layer=1)
    check(k2["ulps"] <= BF16_MAX_ULPS, f"hybrid_serve K2 {k2['ulps']:.3g} ulps")
    check(k2["window"] == cfg.sliding_window and max(k2["masked_keys"]) > 0,
          f"hybrid_serve K2 at layer 1: window {k2['window']}, masked {k2['masked_keys']}")
    out.update({"k2_windows": k2_windows, "masked_keys": _masked_keys(cfg, eng), "k2": k2})
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phases 22–23: the rest of the zoo (qwen3-4b, granite-3-2b, internvl2-2b,
# whisper-base, mistral-large-123b)
# ---------------------------------------------------------------------------

# arch → (parity prompts, parity max_seq, serve prompts, serve max_seq, serve
# layers: None is the published depth); internvl2's prompts are longer than
# its 256 patch positions.  SERVE_DEPTH_CUTS is defined with the MLA phases
ZOO = {
    "qwen3-4b": ([11, 24], 32, [12, 16, 24, 64], 128, SERVE_DEPTH_CUTS["qwen3-4b"]),
    "granite-3-2b": ([11, 24], 32, [12, 16, 24, 64], 128, SERVE_DEPTH_CUTS["granite-3-2b"]),
    "internvl2-2b": ([260, 300], 320, [260, 270, 280, 300], 336,
                     SERVE_DEPTH_CUTS["internvl2-2b"]),
    "whisper-base": ([11, 24], 32, [12, 16, 24, 64], 128, None),
    # 88 layers are 123 G parameters, 246 GB in bf16: one 80 GB card holds 4
    "mistral-large-123b": ([11, 24], 32, [12, 16, 24, 64], 128,
                           SERVE_DEPTH_CUTS["mistral-large-123b"]),
}


#: zoo_parity's depth but 2: mistral at 1 since PR 27 (its fp32 pairing,
#: 13 s at 2 layers, pays for the mesh_train phase)
ZOO_PARITY_LAYERS = {"mistral-large-123b": 1}


def phase_zoo_parity() -> list[dict]:
    """Each zoo arch at full width, 2 layers (whisper 2 + 2 over its 1500
    frames; mistral 1, :data:`ZOO_PARITY_LAYERS`), fp32, r=0:
    :func:`phase_state_parity` (whisper's K3 launches of the prefills
    counted)."""
    import dataclasses

    from repro_torch.configs import cut_layers, get_config

    out = []
    for arch, (lens, max_seq, *_) in ZOO.items():
        cfg = dataclasses.replace(cut_layers(get_config(arch), ZOO_PARITY_LAYERS.get(arch, 2)),
                                  dtype="float32")
        out.append(phase_state_parity("zoo_parity", cfg, lens, max_seq))
        gc.collect()
    return out


def _zoo_k1_at(eng, x) -> list[dict]:
    """K1 at layer 0's projections, 4 decode rows: qwen3's wq (2560 ×
    4096), mistral's w_gate (12288 × 28672) and w_down (28672 × 12288,
    residual fused), whisper's cross wq and wo; wq and w_down elsewhere."""
    layer, cfg = eng.model.layers[0], eng.cfg
    d, f = cfg.d_model, cfg.d_ff
    rows = [_k1_at(layer.attn, "wq", x(4, d))]
    if cfg.name == "mistral-large-123b":
        rows.append(_k1_at(layer.mlp, "w_gate", x(4, d)))
    if cfg.encoder is not None:
        rows += [_k1_at(layer.xattn, "wq", x(4, d)),
                 _k1_at(layer.xattn, "wo", x(4, cfg.n_heads * cfg.head_dim), x(4, d))]
    return rows + [_k1_at(layer.mlp, "w_down", x(4, f), x(4, d))]


def phase_zoo_serve() -> list[dict]:
    """Each zoo arch at full width and the depth of :data:`ZOO` (mistral at
    1 layer), bf16, structured r=0.05, batch 4, 32 tokens a slot:
    :func:`phase_state_serve`, K1 at its shapes, K2 at layer 0 (whisper
    G = 1 and qwen3 G = 4 among them), and whisper's K3 launches a
    prefill."""
    from repro_torch.analysis import prefill_launches

    out = []
    for arch, (_, _, lens, max_seq, layers) in ZOO.items():
        rec, eng = phase_state_serve("zoo_serve", arch, lens, max_seq, _zoo_k1_at,
                                     layers=layers)
        cfg = eng.cfg
        want_layers = layers or {"qwen3-4b": 36, "granite-3-2b": 40, "internvl2-2b": 24,
                                 "whisper-base": 6}[arch]
        check(rec["layers"] == want_layers and (cfg.encoder is None
                                                or cfg.encoder.n_layers == want_layers),
              f"zoo_serve {arch} runs {rec['layers']} layers, not {want_layers}")
        k2 = _k2_at(eng)
        check(k2["ulps"] <= BF16_MAX_ULPS, f"zoo_serve {arch} K2 {k2['ulps']:.3g} ulps")
        rec["k2"] = k2
        rec["k3_launches_per_prefill"] = rec["prefill_launches"]["flash_attention"] / len(lens)
        if cfg.encoder is not None:
            check(rec["k3_launches_per_prefill"]
                  == prefill_launches(cfg, eng.knobs)["flash_attention"] > 0,
                  f"zoo_serve {arch} K3 launches a prefill {rec['k3_launches_per_prefill']}")
        emit(rec)
        out.append({k: rec[k] for k in ("arch", "layers", "encoder_layers", "prefill_ms",
                                        "decode_ms", "tokens_per_s", "pairing",
                                        "device_memory", "decode_launches_per_step",
                                        "prefill_launches", "main_path_launches", "k1_shapes",
                                        "k2", "k3_launches_per_prefill")})
        del eng, rec
        gc.collect()
        import torch

        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases 24–25: LM training (qwen2-1.5b), every layer GEMM's forward on K1
# ---------------------------------------------------------------------------

TRAIN_ARCH = "qwen2-1.5b"
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5  # the JAX package's test_lm_loss_grad_r0_parity
TRAIN_BATCH, TRAIN_SEQ = 8, 128  # the JAX train CLI's defaults: K1 at 1024 rows
#: ``lm_train``'s depth: 4 of qwen2-1.5b's 28 layers since PR 27, which pays
#: for the five families on the training mesh (PERF.md §4)
LM_TRAIN_LAYERS = 4


def _train_batch(cfg, step: int) -> dict:
    """Step ``step`` of the training CLI's token stream (seed 1), on the card."""
    import torch

    from repro_torch.data.tokens import token_batches

    tok, lab = next(token_batches(TRAIN_BATCH, TRAIN_SEQ, cfg.vocab, seed=1, start_step=step))
    return {k: torch.as_tensor(a, dtype=torch.int64, device="cuda")
            for k, a in (("tokens", tok), ("labels", lab))}


def _grad_violation(got, want) -> float:
    """max(|got − want| − (atol + rtol·|want|)): ≤ 0 where allclose holds."""
    return float(((got - want).abs() - (GRAD_ATOL + GRAD_RTOL * want.abs())).max())


def _k1_function_checks() -> list[dict]:
    """K1's differentiable GEMMs on the card against their plain versions,
    fp32, at a training layer's shape (1024 rows, K = N = 1536): the output,
    and the gradients of x, w, the bias and the residual for one random
    cotangent, each ≤ 1e-5 relative; one launch forward, none backward."""
    import torch

    from repro_torch.core.pairing import pair_rows_blocked, pair_rows_structured
    from repro_torch.kernels import ops
    from repro_torch.kernels import paired_matmul as pm
    from repro_torch.kernels.ref import rel_err

    gen = torch.Generator(device="cuda").manual_seed(11)
    M_, K, N = 1024, 1536, 1536
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    w0 = rnd(K, N) * K ** -0.5
    w64 = w0.double().cpu().numpy()
    sp = pair_rows_structured(w64, 0.05)
    structured = {"I": sp.I, "J": sp.J, "resid": sp.resid,
                  "pair_mask": [1.0] * sp.n_pairs, "resid_mask": [1.0] * len(sp.resid)}
    blocked = pair_rows_blocked(w64, 0.05, 64).index_arrays()
    to_meta = lambda m: {k: torch.as_tensor(v, device="cuda").to(
        torch.float32 if k.endswith("mask") else torch.int64) for k, v in m.items()}
    cases = {
        "fused_dense (silu, bias)": (
            lambda x, w, b, r: ops.fused_dense(x, w, b, activation="silu"),
            lambda x, w, b, r: pm.ACTIVATIONS["silu"](torch.matmul(x, w) + b), (0, 1, 2)),
        "fused_paired_dense structured (residual)": (
            lambda x, w, b, r: ops.fused_paired_dense(x, w, to_meta(structured), residual=r),
            lambda x, w, b, r: ops.fused_paired_dense_ref(x, w, to_meta(structured), residual=r),
            (0, 1, 3)),
        "fused_paired_dense blocked bn=64 (silu, bias)": (
            lambda x, w, b, r: ops.fused_paired_dense(x, w, to_meta(blocked), b,
                                                      activation="silu", pair_block_n=64),
            lambda x, w, b, r: ops.fused_paired_dense_ref(x, w, to_meta(blocked), b,
                                                          activation="silu", pair_block_n=64),
            (0, 1, 2)),
    }
    rows = []
    dy = rnd(M_, N)
    for name, (fn, plain, live) in cases.items():
        args = [rnd(M_, K), w0.clone(), rnd(N), rnd(M_, N)]
        for i in live:
            args[i].requires_grad_()
        before = pm.launch_count()
        y = fn(*args)
        fwd_launches = pm.launch_count() - before
        grads = torch.autograd.grad(y, [args[i] for i in live], dy)
        bwd_launches = pm.launch_count() - before - fwd_launches
        y_ref = plain(*args)
        grads_ref = torch.autograd.grad(y_ref, [args[i] for i in live], dy)
        errs = {"out": rel_err(y, y_ref),
                **{("x", "w", "bias", "residual")[i]: rel_err(g, r)
                   for i, g, r in zip(live, grads, grads_ref, strict=True)}}
        rows.append({"case": name, "rel_err": errs, "launches": [fwd_launches, bwd_launches]})
        check(max(errs.values()) <= FP32_RTOL, f"K1 Function {name}: {errs}")
        check([fwd_launches, bwd_launches] == [1, 0],
              f"K1 Function {name}: launches forward/backward {fwd_launches}/{bwd_launches}")
    return rows


def phase_lm_train_parity() -> dict:
    import dataclasses

    from repro_torch.analysis import train_launches
    from repro_torch.configs import get_config
    from repro_torch.core.transform import pair_lm_params
    from repro_torch.kernels import paired_matmul as pm
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import lm as M
    from repro_torch.train.optimizer import adamw, cosine_schedule

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=2, dtype="float32")
    batch = _train_batch(cfg, 0)
    base = dict(q_chunk=TRAIN_SEQ, k_chunk=TRAIN_SEQ)
    model = M.init_lm(cfg, 0)
    model.requires_grad_(True)
    variants = {
        "pallas": (model, M.PerfKnobs(**base, gemm="pallas")),
        "paired_structured": (pair_lm_params(model, 0.0)[0],
                              M.PerfKnobs(**base, gemm="pallas_paired")),
        "paired_blocked_64": (pair_lm_params(model, 0.0, mode="column_blocked", block_n=64)[0],
                              M.PerfKnobs(**base, gemm="pallas_paired", pair_block_n=64)),
    }

    def loss_and_grads(m, knobs):
        m.zero_grad(set_to_none=True)
        loss, _ = M.lm_loss(cfg, m, batch, knobs=knobs)
        loss.backward()
        return float(loss), {n: p.grad.detach().clone() for n, p in m.named_parameters()}

    _reset_launches()  # the path's own counts from here
    ref_loss, ref_grads = loss_and_grads(model, M.PerfKnobs(**base))
    check(pm.launch_count() == 0, "lm_train_parity: gemm='xla' launched K1")
    rows = {}
    for tag, (m, knobs) in variants.items():
        launches = {}
        for remat in ("full", "none"):
            k = dataclasses.replace(knobs, remat=remat)
            before = pm.launch_count()
            loss, grads = loss_and_grads(m, k)
            launches[remat] = {"counted": pm.launch_count() - before,
                               "want": train_launches(cfg, k)}
            check(launches[remat]["counted"] == launches[remat]["want"],
                  f"lm_train_parity {tag} remat={remat}: launches {launches[remat]}")
            if remat == "full":
                rel = abs(loss - ref_loss) / abs(ref_loss)
                worst = {n: _grad_violation(g, ref_grads[n]) for n, g in grads.items()}
                worst_name = max(worst, key=worst.get)
                rows[tag] = {"loss": loss, "loss_rel_err": rel,
                             "grad_max_abs_err": max(float((g - ref_grads[n]).abs().max())
                                                     for n, g in grads.items()),
                             "grad_worst": {"param": worst_name,
                                            "excess_over_tolerance": worst[worst_name]},
                             "grads_checked": len(grads)}
                check(rel <= FP32_RTOL, f"lm_train_parity {tag}: loss rel err {rel:.3g}")
                check(worst[worst_name] <= 0, f"lm_train_parity {tag}: grad of {worst_name} "
                      f"beyond rtol {GRAD_RTOL}, atol {GRAD_ATOL} by {worst[worst_name]:.3g}")
        rows[tag]["launches"] = launches
    del ref_grads, grads

    def four_steps(knobs, paired: bool) -> list[float]:
        m = M.init_lm(cfg, 0)
        if paired:
            m = pair_lm_params(m, 0.0)[0]
        step = build_train_step(cfg, adamw(cosine_schedule(3e-4, 4)), knobs)
        opt_state = step.init(m)
        return [float(step(m, opt_state, i, _train_batch(cfg, i))["loss"]) for i in range(4)]

    steps_xla = four_steps(M.PerfKnobs(**base), False)
    steps_paired = four_steps(M.PerfKnobs(**base, gemm="pallas_paired"), True)
    step_err = max(abs(a - b) / abs(a) for a, b in zip(steps_xla, steps_paired, strict=True))
    check(step_err <= FP32_RTOL, f"lm_train_parity: 4 AdamW steps differ by {step_err:.3g}")
    launches = pm.launch_count()
    functions = _k1_function_checks()
    out = {
        "phase": "lm_train_parity", "arch": cfg.name, "layers": cfg.n_layers,
        "dtype": cfg.dtype, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "rounding": 0.0,
        "reference": "gemm='xla' (torch.matmul, autograd)", "xla_loss": ref_loss,
        "variants": rows, "adamw_4_steps": {"xla": steps_xla, "pallas_paired": steps_paired,
                                            "max_rel_err": step_err},
        "main_path_launches": launches, "k1_functions": functions,
    }
    emit(out)
    return out


def _k1_training_rows(layer) -> list[dict]:
    """K1 at a training step's rows (batch 8 × seq 128 = 1024, bf16) on one
    layer's weights, paired (the model's structured r = 0.05 metadata) and
    dense: wq, wk, wo (its residual fused, as in the step), w_gate and
    w_down (residual fused)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(5)
    M_ = TRAIN_BATCH * TRAIN_SEQ
    x = lambda k: torch.randn(M_, k, generator=gen, device="cuda").to(torch.bfloat16)
    d, f = layer.mlp.w_down.shape[1], layer.mlp.w_down.shape[0]
    shapes = [(layer.attn, "wq", d, False), (layer.attn, "wk", d, False),
              (layer.attn, "wo", d, True), (layer.mlp, "w_gate", d, False),
              (layer.mlp, "w_down", f, True)]
    rows = []
    for block, name, k, with_res in shapes:
        xs, res = x(k), x(d) if with_res else None
        rows.append({**_k1_at(block, name, xs, res), "form": "paired structured r=0.05"})
        rows.append({**_k1_at(block, name, xs, res, dense=True), "form": "dense"})
    for row in rows:
        check(row["ulps"] <= BF16_MAX_ULPS,
              f"lm_train K1 {row['weight']} ({row['form']}) {row['ulps']:.3g} ulps")
    return rows


def phase_lm_train() -> dict:
    import math
    import shutil

    import torch

    from repro_torch.analysis import train_launches
    from repro_torch.kernels import paired_matmul as pm
    from repro_torch.launch.train import train

    ckpt = Path(__file__).resolve().parent / "build" / "lm_train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    # 5 steps, so the one checkpoint (18.5 GB at 28 layers) is step 3's (PERF.md §6)
    kw = dict(arch=TRAIN_ARCH, steps=5, batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=3e-4,
              gemm="pallas_paired", pair_rounding=0.05, log_every=1, ckpt_dir=str(ckpt),
              layers=LM_TRAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()  # the path's own counts from here
    rec = train(**kw, ckpt_every=3)
    launches = pm.launch_count()
    peak = torch.cuda.max_memory_allocated()
    cfg, knobs, model = rec["cfg"], rec["knobs"], rec["model"]
    want = train_launches(cfg, knobs)
    losses, xents = [h["loss"] for h in rec["history"]], [h["xent"] for h in rec["history"]]
    check(launches == 5 * want, f"lm_train: {launches} K1 launches in 5 steps, want 5 × {want}")
    check(all(math.isfinite(v) for h in rec["history"] for v in h.values()),
          f"lm_train: metrics not finite: {rec['history']}")
    check(losses[-1] < losses[0], f"lm_train: loss did not fall: {losses}")
    step_ms, pairing_s = rec["step_ms"], [rec["pairing_s"]]
    median = sorted(step_ms[1:])[(len(step_ms) - 1) // 2]
    prof = profile_step(lambda: rec["step"](model, rec["opt_state"], 6, _train_batch(cfg, 6)))
    check(prof["K1"]["launches"] == want or prof["device_ms"] == "not measured",
          f"lm_train: profiled step launched K1 {prof['K1']['launches']} times, want {want}")
    k1_rows = _k1_training_rows(model.layers[0])
    n_params = sum(p.numel() for p in model.parameters())
    del rec, model
    gc.collect()
    torch.cuda.empty_cache()

    # resume: the checkpoint of step 3, the run again from there
    resumed = train(**kw)
    check(resumed["start"] == 3, f"lm_train: resumed from step {resumed['start']}, want 3")
    again = [h["loss"] for h in resumed["history"]]
    pairing_s.append(resumed["pairing_s"])
    resume_err = max(abs(a - b) / abs(a) for a, b in zip(losses[3:], again, strict=True))
    check(resume_err <= FP32_RTOL, f"lm_train: resumed losses {again} vs {losses[3:]}")
    shutil.rmtree(ckpt, ignore_errors=True)
    out = {
        "phase": "lm_train", "arch": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype,
        "masters": "float32", "params": n_params, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "pairing": {"mode": "structured", "rounding": 0.05, "seconds": pairing_s},
        "remat": knobs.remat, "optimizer": "adamw 3e-4, cosine, clip 1.0",
        "losses": losses, "xent": xents,
        "step_ms": step_ms,
        "median_step_ms_2_5": median, "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / median * 1e3,
        "k1_launches_per_step": want, "main_path_launches": launches,
        "profiled_step": prof, "peak_memory_gb": peak / 1e9,
        "resume": {"from_step": 3, "losses": again, "max_rel_err": resume_err,
                   "bit_identical": again == losses[3:]},
        "k1_training_rows": k1_rows,
    }
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phases 26–27: MoE training (olmoe-1b-7b, deepseek-v2-lite-16b), every
# expert projection's forward one K1 launch over the expert grid
# ---------------------------------------------------------------------------

MOE_DENSE_BATCH = (2, 8)  # 16 tokens: T·K ≤ 2E, every expert on every token


def _attn_decode_vjp_check() -> dict:
    """``ops.fused_attn_decode`` on the card at qwen2-1.5b's layer-0 decode
    shapes (batch 4, H 12 over KH 2, D 128, a cache of 256, N 1536), fp32,
    a structured r = 0.05 out-projection with the residual: the output and
    the gradients of q, both caches, w and the residual against autograd of
    the plain composition (``fused_attn_decode_ref``), ≤ 1e-5 relative
    (the output ≤ 2e-5); one K2 launch forward, none backward."""
    import torch

    from repro_torch.core.pairing import pair_rows_structured
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import rel_err

    gen = torch.Generator(device="cuda").manual_seed(12)
    B, S, H, KH, D, N = 4, 256, 12, 2, 128, 1536
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    w = rnd(H * D, N) * (H * D) ** -0.5
    sp = pair_rows_structured(w.double().cpu().numpy(), 0.05)
    meta = {k: torch.as_tensor(v, device="cuda").to(torch.float32 if k.endswith("mask")
                                                      else torch.int64)
            for k, v in {"I": sp.I, "J": sp.J, "resid": sp.resid,
                         "pair_mask": [1.0] * sp.n_pairs,
                         "resid_mask": [1.0] * len(sp.resid)}.items()}
    live = [t.requires_grad_() for t in (rnd(B, 1, H, D), rnd(B, S, KH, D), rnd(B, S, KH, D),
                                         w, rnd(B, 1, N))]
    pos = torch.tensor([0, 23, 130, S - 1], dtype=torch.int32, device="cuda")
    q, kc, vc, tw, res = live
    before = da.launch_count()
    y = ops.fused_attn_decode(q, kc, vc, pos, tw, meta, residual=res)
    fwd = da.launch_count() - before
    dy = rnd(*y.shape)
    grads = torch.autograd.grad(y, live, dy)
    bwd = da.launch_count() - before - fwd
    want = ops.fused_attn_decode_ref(q, kc, vc, pos, tw, meta, residual=res)
    want_grads = torch.autograd.grad(want, live, dy)
    errs = {"out": rel_err(y, want),
            **{name: rel_err(g, r) for name, g, r in zip(("q", "k_cache", "v_cache", "w",
                                                           "residual"), grads, want_grads,
                                                          strict=True)}}
    check(errs["out"] <= ATTN_RTOL and max(v for k, v in errs.items() if k != "out")
          <= FP32_RTOL, f"fused_attn_decode VJP: {errs}")
    check([fwd, bwd] == [1, 0], f"fused_attn_decode VJP: K2 launches forward/backward "
          f"{fwd}/{bwd}")
    return {"shape": {"B": B, "S": S, "H": H, "KH": KH, "D": D, "N": N},
            "pairing": "structured r=0.05", "pairs": sp.n_pairs, "pos": pos.tolist(),
            "rel_err": errs, "max_abs_err": float((y - want).abs().max()),
            "launches": [fwd, bwd]}


def phase_moe_train_parity() -> dict:
    import dataclasses

    import torch

    from repro_torch.analysis import train_launches
    from repro_torch.configs import get_config
    from repro_torch.core.transform import pair_lm_params
    from repro_torch.data.tokens import token_batches
    from repro_torch.kernels import paired_matmul as pm
    from repro_torch.models import lm as M

    def loss_and_grads(cfg, m, batch, knobs):
        m.zero_grad(set_to_none=True)
        loss, metrics = M.lm_loss(cfg, m, batch, knobs=knobs)
        loss.backward()
        return (float(loss), float(metrics["aux"]),
                {n: p.grad.detach().clone() for n, p in m.named_parameters()})

    _reset_launches()  # the path's own counts from here
    rows, pairing_s = {}, {}
    for arch in (MOE_ARCH, MLA_ARCH):
        # deepseek's 2 layers: its dense first layer and one MoE layer
        cfg = dataclasses.replace(get_config(arch), n_layers=2, dtype="float32")
        mo = cfg.moe
        tok, lab = next(token_batches(*MOE_DENSE_BATCH, cfg.vocab, seed=1))
        batches = {"routed": _train_batch(cfg, 0),
                   "dense": {k: torch.as_tensor(a, dtype=torch.int64, device="cuda")
                             for k, a in (("tokens", tok), ("labels", lab))}}
        for name, b in batches.items():
            check((b["tokens"].numel() * mo.top_k > 2 * mo.n_experts) == (name == "routed"),
                  f"moe_train_parity {arch}: the {name} batch takes the other branch")
        model = M.init_lm(cfg, 0)
        model.requires_grad_(True)
        base = dict(q_chunk=TRAIN_SEQ, k_chunk=TRAIN_SEQ)
        t0 = time.perf_counter()
        variants = {
            "paired_structured": (pair_lm_params(model, 0.0)[0],
                                  M.PerfKnobs(**base, gemm="pallas_paired")),
            "paired_blocked_64": (pair_lm_params(model, 0.0, mode="column_blocked",
                                                 block_n=64)[0],
                                  M.PerfKnobs(**base, gemm="pallas_paired", pair_block_n=64)),
        }
        pairing_s[arch] = time.perf_counter() - t0
        for branch, batch in batches.items():
            before = pm.launch_count()
            ref_loss, ref_aux, ref_grads = loss_and_grads(cfg, model, batch, M.PerfKnobs(**base))
            check(pm.launch_count() == before, f"moe_train_parity {arch}: gemm='xla' launched K1")
            for tag, (m, knobs) in variants.items():
                launches = {}
                for remat in ("full", "none"):
                    k = dataclasses.replace(knobs, remat=remat)
                    before = pm.launch_count()
                    loss, aux, grads = loss_and_grads(cfg, m, batch, k)
                    launches[remat] = {"counted": pm.launch_count() - before,
                                       "want": train_launches(cfg, k)}
                    check(launches[remat]["counted"] == launches[remat]["want"],
                          f"moe_train_parity {arch} {tag} {branch} remat={remat}: "
                          f"launches {launches[remat]}")
                    if remat != "full":
                        continue
                    rel = abs(loss - ref_loss) / abs(ref_loss)
                    worst = {n: _grad_violation(g, ref_grads[n]) for n, g in grads.items()}
                    worst_name = max(worst, key=worst.get)
                    experts = [n for n in grads if ".moe.w_" in n]
                    row = {"loss": loss, "xla_loss": ref_loss, "loss_rel_err": rel,
                           "aux": aux, "xla_aux": ref_aux,
                           "grad_max_abs_err": max(float((g - ref_grads[n]).abs().max())
                                                   for n, g in grads.items()),
                           "grad_worst": {"param": worst_name,
                                          "excess_over_tolerance": worst[worst_name]},
                           "grads_checked": len(grads), "expert_grads_checked": len(experts)}
                    label = f"moe_train_parity {arch} {tag} {branch}"
                    check(rel <= FP32_RTOL, f"{label}: loss rel err {rel:.3g}")
                    check(worst[worst_name] <= 0, f"{label}: grad of {worst_name} beyond rtol "
                          f"{GRAD_RTOL}, atol {GRAD_ATOL} by {worst[worst_name]:.3g}")
                    check(len(experts) == 3 * sum(cfg.layer_kind(i) == "moe"
                                                  for i in range(cfg.n_layers)),
                          f"{label}: expert gradients {experts}")
                rows[f"{arch}/{tag}/{branch}"] = {**row, "launches": launches}
            del ref_grads, grads
        del model, variants
        gc.collect()
        torch.cuda.empty_cache()
    launches = pm.launch_count()
    vjp = _attn_decode_vjp_check()
    out = {
        "phase": "moe_train_parity", "archs": [MOE_ARCH, MLA_ARCH], "layers": 2,
        "dtype": "float32", "rounding": 0.0,
        "batches": {"routed": [TRAIN_BATCH, TRAIN_SEQ], "dense": list(MOE_DENSE_BATCH)},
        "reference": "gemm='xla' (torch.einsum experts, torch.matmul, autograd)",
        "pairing_s": pairing_s, "variants": rows, "main_path_launches": launches,
        "fused_attn_decode_vjp": vjp,
    }
    emit(out)
    return out


def _expert_fold_ms(block, name: str) -> dict:
    """Device ms of ``fold_lm_expert_weight`` on one expert weight of the
    trained model (bf16, its structured metadata) and of the fold's
    backward: the index kernels (gathers, scatter-adds) the expert grid's
    backward runs once a projection a step, beside the einsums."""
    import torch

    from repro_torch.kernels import ops

    w = getattr(block, name).detach().to(torch.bfloat16).requires_grad_()
    meta = block.pairing[name]
    cot = torch.randn_like(w)
    with torch.no_grad():
        fwd = request_stats(lambda: ops.fold_lm_expert_weight(w, meta), n=10, warmup=1)
    both = request_stats(lambda: torch.autograd.grad(ops.fold_lm_expert_weight(w, meta), w, cot),
                         n=10, warmup=1)
    return {"weight": name, "shape": list(w.shape), "forward_ms": fwd["median"],
            "backward_ms": both["median"] - fwd["median"]}


def phase_moe_train() -> dict:
    import dataclasses
    import math

    import torch

    from repro_torch.analysis import train_launches
    from repro_torch.configs import get_config
    from repro_torch.core.transform import pair_lm_params
    from repro_torch.kernels import paired_matmul as pm
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import lm as M
    from repro_torch.train.optimizer import adamw, cosine_schedule

    steps, layers = 6, 6
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=layers)
    mo = cfg.moe
    torch.cuda.reset_peak_memory_stats()
    model = M.init_lm(cfg, 0)
    t0 = time.perf_counter()
    model, rp = pair_lm_params(model, 0.05)
    pairing_s = time.perf_counter() - t0
    # the training CLI's knobs and optimizer (launch.train.train)
    knobs = M.PerfKnobs(q_chunk=TRAIN_SEQ, gemm="pallas_paired", pair_rounding=0.05)
    step = build_train_step(cfg, adamw(cosine_schedule(3e-4, steps, warmup_steps=0)), knobs)
    opt_state = step.init(model)
    want = train_launches(cfg, knobs)
    _reset_launches()  # the path's own counts from here
    history, step_ms = [], []
    for i in range(steps):
        batch = _train_batch(cfg, i)
        t_step = time.perf_counter()
        history.append({k: float(v) for k, v in step(model, opt_state, i, batch).items()})
        step_ms.append((time.perf_counter() - t_step) * 1e3)
    launches = pm.launch_count()
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in history]
    check(launches == steps * want, f"moe_train: {launches} K1 launches in {steps} steps, "
          f"want {steps} × {want}")
    check(all(math.isfinite(v) for h in history for v in h.values()),
          f"moe_train: metrics not finite: {history}")
    check(losses[-1] < losses[0], f"moe_train: loss did not fall: {losses}")
    median = sorted(step_ms[1:])[(len(step_ms) - 1) // 2]
    prof = profile_step(lambda: step(model, opt_state, steps, _train_batch(cfg, steps)))
    check(prof["K1"]["launches"] == want or prof["device_ms"] == "not measured",
          f"moe_train: profiled step launched K1 {prof['K1']['launches']} times, want {want}")
    n_params = sum(p.numel() for p in model.parameters())
    moe0 = model.layers[0].moe
    cap = max(1, math.ceil(TRAIN_SEQ * mo.top_k / mo.n_experts * mo.capacity_factor))
    rows_per_expert = TRAIN_BATCH * cap  # the step's routed rows: (B, C) a buffer
    gen = torch.Generator(device="cuda").manual_seed(6)
    x = lambda *shape: torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)
    d, E, F = cfg.d_model, mo.n_experts, mo.d_ff_expert
    with torch.no_grad():
        k1 = [_k1_expert_at(moe0, "w_gate", x(E, rows_per_expert, d), "silu", tag="moe_train"),
              _k1_expert_at(moe0, "w_up", x(E, rows_per_expert, d), tag="moe_train"),
              _k1_expert_at(moe0, "w_down", x(E, rows_per_expert, F), tag="moe_train")]
    for row in k1:
        check(row["ulps"] <= BF16_MAX_ULPS, f"moe_train K1 {row['weight']} {row['ulps']:.3g} ulps")
    fold = [_expert_fold_ms(moe0, name) for name in ("w_gate", "w_up", "w_down")]
    experts = [leaf for leaf in rp.leaves if ".moe." in leaf.path]
    out = {
        "phase": "moe_train", "arch": cfg.name, "layers": layers,
        "published_layers": get_config(MOE_ARCH).n_layers, "dtype": cfg.dtype,
        "masters": "float32", "params": n_params, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "capacity": cap, "rows_per_expert": rows_per_expert,
        "pairing": {"mode": rp.mode, "rounding": rp.rounding, "total_pairs": rp.total_pairs,
                    "pair_fraction": rp.pair_fraction, "seconds": pairing_s,
                    "expert_pair_fraction": 2 * sum(leaf.n_pairs for leaf in experts)
                    / sum(leaf.n_weights for leaf in experts)},
        "remat": knobs.remat, "optimizer": "adamw 3e-4, cosine, clip 1.0",
        "losses": losses, "aux": [h["aux"] for h in history], "step_ms": step_ms,
        "median_step_ms_2_6": median, "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / median * 1e3,
        "k1_launches_per_step": want, "main_path_launches": launches,
        "profiled_step": prof, "peak_memory_gb": peak / 1e9,
        "memory_reckoning_gb": {"fp32_masters": 4 * n_params / 1e9, "grads": 4 * n_params / 1e9,
                                "adam_moments": 8 * n_params / 1e9,
                                "sum_16_bytes_a_param": 16 * n_params / 1e9,
                                "card_total": torch.cuda.get_device_properties(0).total_memory
                                / 1e9},
        "peak_bytes_per_param": peak / n_params,
        "k1_expert_grid_rows": k1,
        "expert_fold_ms": fold,
        "expert_fold_ms_per_step": layers * sum(f["forward_ms"] + f["backward_ms"]
                                                for f in fold),
    }
    emit(out)
    return out



# ---------------------------------------------------------------------------
# phase 28: the training mesh (every family but FSDP's mistral-large-123b)
# ---------------------------------------------------------------------------

MESH_TRAIN_ARCHS = {"qwen2": TRAIN_ARCH, "olmoe": MOE_ARCH, "deepseek": MLA_ARCH,
                    "mamba2": SSM_ARCH, "hymba": HYBRID_ARCH, "whisper": "whisper-base",
                    "internvl2": "internvl2-2b"}
MESH_TRAIN_PARITY = {(1, 2): ("qwen2", "olmoe", "deepseek", "mamba2", "hymba", "whisper",
                              "internvl2"),
                     (2, 1): ("qwen2",),
                     (2, 2): ("qwen2", "olmoe", "deepseek", "internvl2"),
                     (1, 4): ("qwen2", "hymba")}
#: r = 0.05 (structured, per-shard pairing) against the fold oracle
MESH_TRAIN_R05 = {(1, 2): ("qwen2", "deepseek", "hymba"), (2, 2): ("qwen2",)}
#: the parity runs' sequence: internvl2's 256 patch positions need labelled
#: tokens after them
MESH_TRAIN_SEQ = {"internvl2": 384}
#: the trained runs on (1, 2): (arch, layers); qwen2 and deepseek at 2 layers,
#: which pays for the FSDP phase
MESH_TRAINED = {"trained": (TRAIN_ARCH, 2), "trained_deepseek": (MLA_ARCH, 2)}


def _mesh_train_ref(cfg, knobs, batch, path: Path) -> dict:
    """The single-rank ``TrainStep`` on the card (the whole model paired by
    ``pair_lm_params``): its metrics and gradients of one AdamW step, saved
    to ``path`` for the ranks to hold theirs to; nothing of it stays on the
    card."""
    import torch

    from repro_torch.benchmarks.mesh_train import PARITY_EPS, PARITY_LR, batch_dict
    from repro_torch.core.transform import pair_lm_params
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import lm as M
    from repro_torch.train.optimizer import adamw

    model = pair_lm_params(M.init_lm(cfg, 0, device="cuda"), knobs.pair_rounding)[0]
    step = build_train_step(cfg, adamw(PARITY_LR, eps=PARITY_EPS), knobs)
    opt = step.init(model)
    m = step(model, opt, 0, batch_dict(cfg, batch, "cuda"))
    rec = {k: float(v) for k, v in m.items()}
    # whole before it has its name: a rank waits for the name after its step
    part = path.with_name(path.name + ".part")
    torch.save({**rec, "grads": {n: p.grad.cpu() for n, p in model.named_parameters()}}, part)
    part.replace(path)
    del model, opt, step
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _k1_shard_rows() -> list[dict]:
    """K1 at a (1, 2) training rank's shards of qwen2-1.5b's layer 0: the
    rank-0 block of each weight under the ``train`` rules, paired per shard
    (structured r = 0.05, ``pair_shard_params``), 1024 bf16 rows."""
    import torch

    from repro_torch.configs import cut_layers, get_config
    from repro_torch.core.transform import pair_shard_params, tp_shard_plan
    from repro_torch.launch.steps import shard_model
    from repro_torch.models import lm as M
    from repro_torch.models.param import param_axes_and_shapes
    from repro_torch.parallel.rules import rules_for
    from repro_torch.parallel.sharding import Mesh, shardings_for

    cfg = cut_layers(get_config(TRAIN_ARCH), 1)
    mesh = Mesh({"data": 1, "model": 2}, rank=0, device="cuda")
    rules = rules_for(cfg, "train", mesh)
    axes, shapes = param_axes_and_shapes(cfg)
    whole = M.init_lm(cfg, 0, device="cuda")
    local = shard_model(whole, shardings_for(axes, mesh, rules, shapes), mesh)
    local, _ = pair_shard_params(local, whole, 0.05,
                                 shards=tp_shard_plan(axes, shapes, mesh, rules,
                                                      leaves=cfg.paired_leaves),
                                 leaves=cfg.paired_leaves)
    del whole
    layer = local.layers[0]
    gen = torch.Generator(device="cuda").manual_seed(6)
    rows = []
    for block, name in ((layer.attn, "wq"), (layer.attn, "wo"), (layer.mlp, "w_gate"),
                        (layer.mlp, "w_down")):
        k = block.matrix(name, torch.bfloat16).shape[0]
        x = torch.randn(TRAIN_BATCH * TRAIN_SEQ, k, generator=gen, device="cuda")
        row = _k1_at(block, name, x.to(torch.bfloat16))
        check(row["ulps"] <= BF16_MAX_ULPS, f"mesh_train K1 {name} shard {row['ulps']:.3g} ulps")
        rows.append({**row, "shard": "rank 0 of (1, 2)"})
    del local, layer
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def _mesh_trained_row(recs: list, mesh, where: str) -> dict:
    """The trained run's record per rank, its gates checked: finite
    metrics, every rank's losses the same, K1 launches and collectives a
    step as ``analysis`` says."""
    import math

    from repro_torch import analysis

    cfg, knobs = recs[0]["cfg"], recs[0]["knobs"]
    want_k1 = analysis.train_launches(cfg, knobs)
    want_coll = analysis.mesh_train_collectives(cfg, knobs, mesh, TRAIN_BATCH, TRAIN_SEQ)
    losses = [[h["loss"] for h in r["history"]] for r in recs]
    check(all(math.isfinite(v) for r in recs for h in r["history"] for v in h.values()),
          f"{where}: metrics not finite")
    check(all(x == losses[0] for x in losses), f"{where}: the ranks' losses differ: {losses}")
    ranks = []
    for r in recs:
        check(r["k1_launches"] == [want_k1] * len(r["history"]),
              f"{where} rank {r['rank']}: K1 launches {r['k1_launches']}, want {want_k1}")
        check(all(c == want_coll for c in r["collectives"]),
              f"{where} rank {r['rank']}: collectives {r['collectives']}, want {want_coll}")
        ranks.append({"rank": r["rank"], "coords": r["coords"], "losses": losses[r["rank"]],
                      "step_ms": r["step_ms"], "max_step_ms_2_3": max(r["step_ms"][1:]),
                      "peak_gb": (r["peak_bytes"] or 0) / 1e9, "wiring_s": r["wiring_s"],
                      "pairing_s": r["pairing_s"], "k1_launches_per_step": r["k1_launches"][0],
                      "collectives_per_step": r["collectives"][0]})
    return {"arch": cfg.name, "layers": cfg.n_layers, "params": cfg.param_count(),
            "dtype": cfg.dtype, "masters": "float32",
            "pairing": {"mode": "structured", "rounding": knobs.pair_rounding},
            "remat": knobs.remat, "want_k1_per_step": want_k1,
            "want_collectives_per_step": want_coll, "ranks": ranks,
            "note": "two ranks time-share one card and one host: no tensor-parallel speed"}


def _mesh_train_plan() -> dict:
    """Phase 28's rank jobs by mesh shape (``train_many``'s), and the
    single-rank references they are held to (:func:`_mesh_train_refs` runs
    them); nothing runs on the card here."""
    import dataclasses
    import shutil

    from repro_torch.benchmarks.mesh_train import PARITY_EPS, PARITY_LR, smoke_batches
    from repro_torch.configs import cut_layers, get_config
    from repro_torch.models import lm as M

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    knobs = M.PerfKnobs(q_chunk=TRAIN_SEQ, gemm="pallas_paired", pair_rounding=0.0)
    knobs05 = dataclasses.replace(knobs, pair_rounding=0.05)
    # full width, 2 layers (deepseek's dense layer 0 and an MoE layer with
    # shared experts; hymba's full layer 0 and windowed layer 1; whisper 2 + 2)
    cfgs = {k: dataclasses.replace(cut_layers(get_config(a), 2), dtype="float32")
            for k, a in MESH_TRAIN_ARCHS.items()}
    # seeded random tokens, and seeded random frames or patches
    batches = {k: smoke_batches(c, TRAIN_BATCH, MESH_TRAIN_SEQ.get(k, TRAIN_SEQ), 1)
               for k, c in cfgs.items()}
    ref_paths = {key: str(build / f"mesh_train_ref_{key}.pt") for key in cfgs}
    ckpt = build / "mesh_train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    # 3 steps: the one checkpoint is step 2's, and step 3 runs on both shapes
    resume_kw = dict(arch=TRAIN_ARCH, smoke=False, steps=3, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                     lr=3e-4, ckpt_dir=str(ckpt), ckpt_every=2, paired_rounding=0.0,
                     log_every=1, gemm="pallas_paired", pair_rounding=0.0, pair_block_n=0,
                     layers=2, dtype="float32")
    jobs = {}
    for shape, archs in MESH_TRAIN_PARITY.items():
        jobs[shape] = {key: ("train_job", (cfgs[key], 0, knobs, batches[key]),
                             {"lr": PARITY_LR, "eps": PARITY_EPS, "want": ref_paths[key]})
                       for key in archs}
        for key in MESH_TRAIN_R05.get(shape, ()):
            jobs[shape][key + "_r05"] = ("train_job", (cfgs[key], 0, knobs05, batches[key]),
                                         {"lr": PARITY_LR, "eps": PARITY_EPS,
                                          "fold_oracle": True})
    for name, (arch, layers) in MESH_TRAINED.items():
        jobs[(1, 2)][name] = ("train_rank", (), dict(resume_kw, arch=arch, ckpt_dir="",
                                                     ckpt_every=0, pair_rounding=0.05,
                                                     layers=layers, dtype=""))
    jobs[(1, 2)]["resume_straight"] = ("train_rank", (), resume_kw)
    jobs[(2, 1)]["resume"] = ("train_rank", (), resume_kw)
    return {"jobs": jobs, "cfgs": cfgs, "knobs": knobs, "batches": batches,
            "ref_paths": ref_paths, "ckpt": ckpt}


def _mesh_train_refs(plan: dict) -> None:
    """The single-rank steps of :func:`_mesh_train_plan`'s parity jobs, on
    the card in this process, saved where the ranks read them; their
    metrics and seconds go into ``plan``."""
    plan["refs"], plan["reference_s"] = {}, {}
    for key, cfg in plan["cfgs"].items():
        t1 = time.perf_counter()
        plan["refs"][key] = _mesh_train_ref(cfg, plan["knobs"], plan["batches"][key][0],
                                            Path(plan["ref_paths"][key]))
        plan["reference_s"][key] = time.perf_counter() - t1


def phase_mesh_train(plan: dict, ranks_by_shape: dict, spawns: dict) -> dict:
    """The training mesh on ranks of ``launch.mesh.spawn`` (gloo, every rank
    on this one card, so they time-share it; the spawns are
    :func:`phase_mesh`'s, shared with phase 13): parity, the trained runs (in
    a spawn of their own), the resume across shapes, and K1 at a
    rank's training shards (phase 28 of the module docstring)."""
    import math
    import shutil

    import numpy as np

    from repro_torch import analysis
    from repro_torch.benchmarks.mesh_train import PARITY_EPS, PARITY_LR
    from repro_torch.launch.steps import wiring_excess
    from repro_torch.parallel.sharding import Mesh

    t0 = time.perf_counter()
    refs, ref_paths, ckpt = plan["refs"], plan["ref_paths"], plan["ckpt"]
    runs, k1_total, job_s, trained, resume = [], 0, {}, {}, {}
    for shape, mesh_jobs in plan["jobs"].items():
        ranks = ranks_by_shape.get(shape)
        if ranks is None:
            continue  # its spawn failed, and said so
        mesh_jobs = {n: j for n, j in mesh_jobs.items() if n in ranks[0]}
        job_s[str(shape)] = {name: max(r[name]["job_s"] for r in ranks) for name in mesh_jobs}
        mesh = Mesh(dict(zip(("data", "model"), shape, strict=True)))
        for name, (fn, args, _) in mesh_jobs.items():
            where = f"mesh_train {shape} {name}"
            for r in ranks:
                excess = wiring_excess(r[name])
                check(excess is not None and excess <= 0,
                      f"{where} rank {r[name]['rank']}: wiring peak "
                      f"{r[name].get('wire_peak_bytes')} B past the rank-local bound")
            if fn == "train_rank":
                recs = [r[name] for r in ranks]
                k1_total += sum(sum(r["k1_launches"]) for r in recs)
                if name in MESH_TRAINED:
                    trained[name] = _mesh_trained_row(recs, mesh, where)
                else:
                    resume[name] = [[h["loss"] for h in r["history"]] for r in recs]
                    resume[name + "_start"] = [r["start"] for r in recs]
                continue
            cfg, knob = args[0], args[2]
            B, S = np.asarray(args[3][0][0]).shape
            want_coll = analysis.mesh_train_collectives(cfg, knob, mesh, B, S)
            want_k1 = analysis.train_launches(cfg, knob)
            row = {"mesh": list(shape), "job": name, "arch": cfg.name, "layers": cfg.n_layers,
                   "batch": B, "seq": S, "want_collectives": want_coll, "want_k1": want_k1,
                   "ranks": []}
            for rank in ranks:
                got = rank[name]
                k1_total += sum(got["k1"])
                check(got["collectives"][0] == want_coll,
                      f"{where} rank {got['rank']}: collectives {got['collectives'][0]}, "
                      f"want {want_coll}")
                check(got["k1"] == [want_k1], f"{where} rank {got['rank']}: K1 launches "
                                              f"{got['k1']}, want {want_k1}")
                r = {k: got.get(k) for k in ("rank", "coords", "wire_s", "wiring",
                                             "wire_peak_bytes", "held_bytes", "metrics",
                                             "grad_violation", "params_violation",
                                             "loss_violation", "oracle_loss_violation",
                                             "oracle_grad_violation", "clip_norm", "tp",
                                             "pair_report")}
                for gate in ("grad_violation", "params_violation", "loss_violation",
                             "oracle_loss_violation", "oracle_grad_violation"):
                    if got.get(gate) is not None:
                        check(got[gate] <= 0, f"{where} rank {got['rank']}: {gate} "
                                              f"{got[gate]:.3g}")
                row["ranks"].append(r)
            runs.append(row)
    straight, again = resume.get("resume_straight"), resume.get("resume")
    resume_err = None
    if straight and again:
        check(resume["resume_start"] == [2, 2], f"mesh_train resume: started at "
                                                f"{resume['resume_start']}, want step 2")
        resume_err = max(abs(a - b) / abs(b) for r in again
                         for a, b in zip(r, straight[0][2:], strict=True))
        check(resume_err <= FP32_RTOL, f"mesh_train resume on (2, 1): {again} vs "
                                       f"{straight[0][2:]}")
    else:
        check(False, "mesh_train: the resume runs did not both report")
    check(set(trained) == set(MESH_TRAINED), f"mesh_train: of the trained runs only "
                                             f"{sorted(trained)} reported")
    shutil.rmtree(ckpt, ignore_errors=True)
    for path in ref_paths.values():
        Path(path).unlink(missing_ok=True)
    t2 = time.perf_counter()
    k1_rows = _k1_shard_rows()
    check(all(math.isfinite(v) for r in refs.values() for v in r.values()),
          "mesh_train: reference loss")
    out = {"phase": "mesh_train", "card": _card(), "backend": "gloo",
           "ranks_share_one_card": True, "adamw": {"lr": PARITY_LR, "eps": PARITY_EPS},
           "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "seq_by_arch": MESH_TRAIN_SEQ, "references": refs,
           "reference_s": plan["reference_s"], "spawns": spawns, "job_s": job_s, "runs": runs,
           **trained,
           "resume": {"saved_on": [1, 2], "resumed_on": [2, 1], "straight": straight,
                      "resumed": again, "max_rel_err": resume_err},
           "k1_shard_rows": k1_rows, "k1_rows_s": time.perf_counter() - t2,
           "main_path_launches": k1_total, "check_s": time.perf_counter() - t0}
    emit(out)
    return out


#: the spawns of phases 13 and 28: one a mesh shape, both phases' jobs on
#: its ranks, but (1, 2)'s, which are split three ways: phase 13's parity and
#: served runs, phase 28's parity runs, and its trained runs.  The spawns of
#: a lane run one after another, the two lanes at once, the trained runs
#: last in the first (beside the other lane's ranks: the script's time
#: limit).  (2, 1)'s resume reads the checkpoint that (1, 2)'s straight run
#: writes; the lanes never run phase 28's deepseek parity jobs on (1, 2) and
#: on (2, 2) at once.
MESH_LANES = (("(1, 2) decode", "(1, 4)", "(2, 1)", "(1, 2) timed"), ("(1, 2)", "(2, 2)"))
MESH_AFTER = {"(2, 1)": "(1, 2)"}


def _mesh_unit(phase: str, shape: tuple, name: str) -> str:
    if shape == (1, 2) and phase == "decode":
        return "(1, 2) decode"
    return f"{shape} timed" if name in MESH_TRAINED else str(shape)


def phase_mesh() -> tuple[dict, dict]:
    """Phases 13 and 28 on shared spawns (:data:`MESH_LANES`): each rank
    runs its spawn's jobs of both phases through
    ``benchmarks.mesh_train.train_many`` (``serve_rank`` for phase 13's).
    Phase 13's (1, 2) spawn starts first, its served runs first; meanwhile
    this process runs phase 28's single-rank references, then phase 13's
    references and
    ledger gates.  The spawns do not wait for the references: a
    parity job runs its step, then waits for its reference's file (written
    under another name and renamed when whole).  Returns the two phases'
    records."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from repro_torch.benchmarks.mesh_train import train_many
    from repro_torch.launch.mesh import spawn

    t0 = time.perf_counter()
    dec, trn = _mesh_decode_plan(), _mesh_train_plan()
    units: dict[str, tuple] = {}  # spawn → (shape, {"<phase>/<job>": (fn, args, kwargs)})
    for phase, jobs_by_shape in (("decode", {s: {n: ("serve_rank", *j) for n, j in js.items()}
                                             for s, js in dec["jobs"].items()}),
                                 ("train", trn["jobs"])):
        for shape, jobs in jobs_by_shape.items():
            # the served runs first: (1, 2)'s whole fp32 models are built before
            # the other lane starts
            for name in sorted(jobs, key=lambda n: not n.endswith("_served")):
                unit = units.setdefault(_mesh_unit(phase, shape, name), (shape, {}))
                unit[1][f"{phase}/{name}"] = jobs[name]
    check(sorted(units) == sorted(u for lane in MESH_LANES for u in lane),
          f"mesh: spawns {sorted(units)} not those of the lanes")
    done = {unit: threading.Event() for unit in units}
    results, spawn_s, started = {}, {}, {}

    def run(unit: str) -> None:
        shape, jobs = units[unit]
        if unit in MESH_AFTER:
            done[MESH_AFTER[unit]].wait()
        started[unit] = time.perf_counter() - t0
        try:
            results[unit] = spawn(train_many, shape, backend="gloo", device="cuda",
                                  args=(jobs,), timeout=900)
        except RuntimeError as e:
            check(False, f"mesh {unit}: {str(e)[-2000:]}")
        finally:
            spawn_s[unit] = time.perf_counter() - t0 - started[unit]
            done[unit].set()

    def lane(names) -> None:
        for unit in names:
            run(unit)

    with ThreadPoolExecutor(max_workers=len(MESH_LANES)) as pool:
        lanes = [pool.submit(lane, names) for names in MESH_LANES]
        _mesh_train_refs(trn)
        gc.collect()
        torch.cuda.empty_cache()
        dec_refs = _mesh_decode_refs(dec)
        for f in lanes:
            f.result()
    spawns = {"started_s": started, "spawn_s": spawn_s, "lanes": MESH_LANES,
              "seconds": time.perf_counter() - t0}
    by_phase: dict[str, dict] = {"decode": {}, "train": {}}
    for unit, ranks in results.items():
        for phase, by_shape in by_phase.items():
            merged = by_shape.setdefault(units[unit][0], [{} for _ in ranks])
            for mine, rank in zip(merged, ranks, strict=True):
                mine.update({n.split("/", 1)[1]: v for n, v in rank.items()
                             if n.startswith(phase + "/")})
    del results
    gc.collect()
    return (phase_mesh_decode(dec, dec_refs, by_phase["decode"], spawns),
            phase_mesh_train(trn, by_phase["train"], spawns))


# ---------------------------------------------------------------------------
# phases 13 and 28 under FSDP: mistral-large-123b, embed over data
# ---------------------------------------------------------------------------

FSDP_ARCH = "mistral-large-123b"
#: 1 of its 88 layers at full width: 2.19 G parameters (a layer 1.38 G, the
#: embedding and the head 0.40 G each), 35.0 GB of training state at 16
#: bytes a parameter, a quarter of it a rank on (2, 2)
FSDP_LAYERS = 1
#: the spawn starts with the phase: its ranks build the parity job's blocks
#: beside the reference, then run the train parity, the served parity and
#: the trained run one after another once the reference has left the card.
#: (2, 1)'s train parity (a spawn of its own: 75-90 s of gloo's host
#: copies) is left to the CPU tests (``test_torch_fsdp.py``) for the
#: script's time limit
FSDP_SHAPES = ((2, 2),)
#: a prompt on each data row, 2 tokens: every forward gathers the layer over
#: gloo's host copies (about 5 s in fp32), and the harness adds a step and a
#: prefill
FSDP_SERVE_STEPS = 2
#: 2 steps (the first warms up): 3 cost 11-12 s more of the time limit
FSDP_TRAINED_STEPS = 2


def _fsdp_plan() -> dict:
    """The FSDP jobs by mesh shape (``train_many``'s) under the published
    config's rules (``rules_for(get_config(FSDP_ARCH), mode, mesh)``: the
    cut config is under the FSDP threshold), and what the references need;
    nothing runs on the card here."""
    import dataclasses

    import numpy as np

    from repro_torch.benchmarks.mesh_train import PARITY_EPS, PARITY_LR, smoke_batches
    from repro_torch.configs import cut_layers, get_config
    from repro_torch.models import lm as M
    from repro_torch.parallel.rules import rules_for
    from repro_torch.parallel.sharding import Mesh

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    published = get_config(FSDP_ARCH)
    cfg = cut_layers(published, FSDP_LAYERS)  # bf16 compute, fp32 masters
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    # remat full, as in the trained run: the recompute gathers each layer
    # again, and the parity holds its reduce-scatter to the reference
    knobs = M.PerfKnobs(q_chunk=TRAIN_SEQ, gemm="pallas_paired", pair_rounding=0.0)
    batches = smoke_batches(cfg32, TRAIN_BATCH, TRAIN_SEQ, FSDP_TRAINED_STEPS)
    # slots 0 and 2: a live request on each data row of the batch of 4
    rng = np.random.default_rng(7)
    prompts = {0: rng.integers(1, cfg.vocab, size=16), 2: rng.integers(1, cfg.vocab, size=11)}
    rules = {(shape, mode): rules_for(published, mode,
                                      Mesh(dict(zip(("data", "model"), shape, strict=True))))
             for shape in FSDP_SHAPES for mode in ("train", "prefill", "decode")}
    ref_path = str(build / "mesh_fsdp_ref.pt")
    # made when the card is free for a spawn's first job
    go = {shape: build / f"mesh_fsdp_go_{shape[0]}x{shape[1]}" for shape in FSDP_SHAPES}
    for path in go.values():
        path.unlink(missing_ok=True)
    serve = {"max_seq": 64, "batch_size": 4, "rules": rules[((2, 2), "decode")]}

    def parity(shape):
        return ("train_job", (cfg32, 0, knobs, batches[:1]),
                {"lr": PARITY_LR, "eps": PARITY_EPS, "want": ref_path,
                 "rules": rules[(shape, "train")], "start_after": str(go[shape])})

    jobs = {(2, 2): {"parity": parity((2, 2)),
                     "serve": ("serve_rank", (cfg32, 0, _mesh_knobs(0.0, 0), prompts,
                                              FSDP_SERVE_STEPS), serve),
                     "trained": ("train_job", (cfg, 0, dataclasses.replace(
                         knobs, pair_rounding=0.05), batches),
                                 {"rules": rules[((2, 2), "train")]})}}
    return {"cfg": cfg, "cfg32": cfg32, "knobs": knobs, "batches": batches,
            "prompts": prompts, "rules": rules, "ref_path": ref_path, "jobs": jobs, "go": go}


def _fsdp_refs(plan: dict):
    """The single-rank step (fp32, ``torch.matmul``: at r = 0 the paired
    kernel computes the same product) on the whole model, its gradients and
    updated weights copied to the host and written, in a thread, where the
    ranks read their blocks of them (under another name, renamed when whole:
    a rank waits for it after its step); then the single-rank engine's
    tokens and logits over the same weights.  Nothing of either stays on the
    card.  Returns the record and the writing thread."""
    import dataclasses
    import os
    import threading

    import torch

    from repro_torch.benchmarks.mesh_decode import generate
    from repro_torch.benchmarks.mesh_train import PARITY_EPS, PARITY_LR, batch_dict
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import lm as M
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.train.optimizer import adamw

    cfg, t0 = plan["cfg32"], time.perf_counter()
    model = M.init_lm(cfg, 0, device="cuda")
    step = build_train_step(cfg, adamw(PARITY_LR, eps=PARITY_EPS),
                            dataclasses.replace(plan["knobs"], gemm="xla"))
    opt = step.init(model)
    m = {k: float(v) for k, v in
         step(model, opt, 0, batch_dict(cfg, plan["batches"][0], "cuda")).items()}
    t1 = time.perf_counter()
    ref = {**m, "grads": {n: p.grad.cpu() for n, p in model.named_parameters()},
           "params": {n: p.detach().cpu() for n, p in model.named_parameters()}}
    del model, opt, step
    gc.collect()
    torch.cuda.empty_cache()
    saved = {}

    def write() -> None:
        t = time.perf_counter()
        torch.save(ref, plan["ref_path"] + ".part")
        os.replace(plan["ref_path"] + ".part", plan["ref_path"])
        saved["save_s"] = time.perf_counter() - t

    writer = threading.Thread(target=write)
    writer.start()
    t2 = time.perf_counter()
    eng = ServeEngine(cfg, M.init_lm(cfg, 0), max_seq=64, batch_size=4,
                      knobs=dataclasses.replace(_mesh_knobs(0.0, 0), gemm="xla"))
    tokens = generate(eng, plan["prompts"], FSDP_SERVE_STEPS)
    logits = eng.last_logits
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return {"train": m, "tokens": tokens, "logits": logits, "train_s": t1 - t0,
            "to_host_s": t2 - t1, "serve_s": time.perf_counter() - t2, "saved": saved}, writer


def phase_mesh_fsdp() -> dict:
    """Phases 13 and 28 under FSDP: mistral-large-123b at full width, 1 of
    its 88 layers, under its published config's rules (``embed`` over
    ``data``: each layer's blocks gathered over ``data`` before it runs, its
    gradient reduce-scattered), on gloo ranks that share this one card, each
    building only its own blocks.  Train parity on (2, 2) (fp32, r = 0,
    remat full, one AdamW step, batch 8 × seq 128; (2, 1)'s in the CPU
    tests, for the script's time limit): every rank's loss, gradients
    and updated weights held to the single-rank step's, its block of them at
    a time, rtol 1e-4 / atol 1e-5 (a NaN fails); served parity on (2, 2)
    (fp32, r = 0, a prompt on each data row): every rank's tokens the
    single-rank engine's, logits ≤ 1e-5; the trained run on (2, 2) (bf16,
    fp32 masters, structured r = 0.05, 2 steps): finite, equal losses on every rank, ms a step, peak
    memory and what a rank holds beside the reckoning (a quarter of 35.0 GB,
    and one gathered layer); collectives and K1 launches held to
    ``analysis`` throughout, with the FSDP rules; every rank's wiring peak
    within the bound of building rank-locally."""
    import math
    import os
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from repro_torch import analysis
    from repro_torch.benchmarks.mesh_decode import PARITY_TOL
    from repro_torch.benchmarks.mesh_train import train_many
    from repro_torch.kernels.ref import rel_err
    from repro_torch.launch.mesh import spawn
    from repro_torch.launch.steps import WIRING_WHOLE_LEAVES, wiring_excess
    from repro_torch.parallel.sharding import Mesh

    t0 = time.perf_counter()
    parent_gb = torch.cuda.memory_allocated() / 1e9  # this process's, beside the ranks'
    plan = _fsdp_plan()
    ranks, done_s = {}, {}
    # four ranks at 16-18 GB each on the one card: segments that grow in place
    # spare the allocator's fragments
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    writer = None
    try:
        # the spawn starts now (a spawn's start is 15-20 s); its first job
        # builds its blocks, then waits for its file: the reference to leave
        # the card
        with ThreadPoolExecutor(max_workers=len(FSDP_SHAPES)) as pool:
            runs = {shape: pool.submit(spawn, train_many, shape, backend="gloo", device="cuda",
                                       args=(plan["jobs"][shape],), timeout=900)
                    for shape in FSDP_SHAPES}
            try:
                refs, writer = _fsdp_refs(plan)
            finally:
                plan["go"][(2, 2)].touch()  # a failed reference fails the ranks' gates
            for shape in FSDP_SHAPES:
                try:
                    ranks[shape] = runs[shape].result()
                except RuntimeError as e:
                    check(False, f"mesh_fsdp {shape}: {str(e)[-2000:]}")
                done_s[str(shape)] = time.perf_counter() - t0
    finally:
        for path in plan["go"].values():
            path.touch()
        if alloc is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
    if writer is not None:
        writer.join()
    for path in plan["go"].values():
        path.unlink(missing_ok=True)
    Path(plan["ref_path"]).unlink(missing_ok=True)
    t2 = time.perf_counter()
    B, S = TRAIN_BATCH, TRAIN_SEQ
    runs, k1_total = {}, 0
    jobs = [(shape, name, job) for shape, by_name in plan["jobs"].items() if shape in ranks
            for name, job in by_name.items()]
    for shape, name, (fn, args, kw) in jobs:
        mesh = Mesh(dict(zip(("data", "model"), shape, strict=True)))
        where = f"mesh_fsdp {shape} {name}"
        cfg, knobs = args[0], args[2]
        rows = []
        for rank in ranks[shape]:
            got = rank[name]
            excess = wiring_excess(got)
            check(excess is not None and excess <= 0,
                  f"{where} rank {got['rank']}: wiring peak {got.get('wire_peak_bytes')} B "
                  f"past {got['held_bytes']} B held and {WIRING_WHOLE_LEAVES} whole "
                  f"leaves of {got['leaf_bytes']} B")
            row = {"rank": got["rank"], "coords": got["coords"], "wire_s": got["wire_s"],
                   "job_s": got["job_s"], "wire_peak_gb": (got.get("wire_peak_bytes") or 0) / 1e9,
                   "held_gb": got["held_bytes"] / 1e9, "leaf_gb": got["leaf_bytes"] / 1e9,
                   "peak_gb": got.get("peak_bytes", 0) / 1e9, "tp": got["tp"]}
            if fn == "serve_rank":
                k1_total += got["k1_launches"]
                rules = {m: plan["rules"][(shape, m)] for m in ("decode", "prefill")}
                dec = analysis.mesh_decode_collectives(cfg, knobs, mesh, batch_size=4,
                                                       max_seq=64, rules=rules["decode"])
                pre = analysis.mesh_prefill_collectives(cfg, knobs, mesh, batch_size=4,
                                                        max_seq=64, rules=rules["prefill"])
                calls = lambda c: {k: v["calls"] for k, v in c.items()}
                row.update(tokens_identical=got["tokens"] == refs["tokens"],
                           max_logit_rel_err=rel_err(got["logits"], refs["logits"]),
                           step_collectives=got["step_collectives"])
                check(row["tokens_identical"], f"{where} rank {got['rank']}: tokens "
                                               f"{got['tokens']} vs {refs['tokens']}")
                check(row["max_logit_rel_err"] <= PARITY_TOL,
                      f"{where} rank {got['rank']}: logits {row['max_logit_rel_err']:.3g}")
                check(calls(got["step_collectives"]) == dec
                      and calls(got["prefill_collectives"]) == pre,
                      f"{where} rank {got['rank']}: collectives {got['step_collectives']} "
                      f"/ {got['prefill_collectives']}, want {dec} / {pre}")
                rows.append(row)
                continue
            k1_total += sum(got["k1"])
            want_coll = analysis.mesh_train_collectives(cfg, knobs, mesh, B, S,
                                                        rules=plan["rules"][(shape, "train")])
            want_k1 = analysis.train_launches(cfg, knobs)
            check(all(c == want_coll for c in got["collectives"]),
                  f"{where} rank {got['rank']}: collectives {got['collectives']}, "
                  f"want {want_coll}")
            check(got["k1"] == [want_k1] * len(got["k1"]),
                  f"{where} rank {got['rank']}: K1 launches {got['k1']}, want {want_k1}")
            check(all(math.isfinite(v) for m in got["metrics"] for v in m.values()),
                  f"{where} rank {got['rank']}: metrics not finite")
            row.update(losses=[m["loss"] for m in got["metrics"]], step_ms=got["step_ms"],
                       collectives_per_step=got["collectives"][0],
                       k1_per_step=got["k1"][0], wiring=got["wiring"],
                       check_s=got.get("check_s"))
            for gate in ("loss_violation", "grad_violation", "params_violation"):
                if name.startswith("parity"):
                    row[gate] = got[gate]
                    check(got[gate] <= 0, f"{where} rank {got['rank']}: {gate} "
                                          f"{got[gate]:.3g}")
            rows.append(row)
        if fn == "train_job":
            losses = [r["losses"] for r in rows]
            check(all(x == losses[0] for x in losses), f"{where}: the ranks' losses differ")
        check(len(rows) == mesh.axis_size(("data", "model")),
              f"{where}: {len(rows)} ranks reported")
        runs[f"{shape} {name}"] = rows
    cfg = plan["cfg"]
    params = cfg.param_count()
    out = {"phase": "mesh_fsdp", "card": _card(), "backend": "gloo",
           "ranks_share_one_card": True, "arch": FSDP_ARCH, "layers": FSDP_LAYERS,
           "params": params, "batch": B, "seq": S, "parent_allocated_gb": parent_gb,
           "rules": {"embed": "data", "of": f"{FSDP_ARCH} (published)"},
           # the reckoning: 16 bytes a parameter (fp32 master, gradient, two
           # moments) over four ranks, and one layer's model shard gathered in bf16
           "reckoning_gb": {"state_a_rank": 16 * params / 4 / 1e9,
                            # the layer's weights (the embedding and the head
                            # aside) at 2 bytes, over 2 model ranks
                            "gathered_layer_bf16": (params - 2 * cfg.d_model * (
                                (cfg.vocab + 127) // 128 * 128)) / 1e9},
           "reference": {"train": refs["train"], "train_s": refs["train_s"],
                         "to_host_s": refs["to_host_s"], "serve_s": refs["serve_s"],
                         "save_s": refs["saved"].get("save_s")},
           "done_s": done_s, "runs": runs, "main_path_launches": k1_total,
           "check_s": time.perf_counter() - t2, "seconds": time.perf_counter() - t0,
           "note": "ranks time-share one card through gloo's host copies: no speed claim"}
    emit(out)
    torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    build = phase_build()
    # phases 13 and 28 under FSDP first: their ranks need the card (up to
    # 18 GB each of four) while this process holds nothing yet
    fsdp = phase_mesh_fsdp()
    kernel = phase_kernel()
    attn = phase_decode_attention()
    flash = phase_flash_attention()
    ctx = setup()
    layers = phase_layers(ctx)
    lenet = phase_serve(ctx)
    paper = phase_paper(lenet)
    parity, parity_ctx = phase_lm_parity()
    lm, lm_engine = phase_lm_serve()
    fe = phase_frontend(parity_ctx, lm_engine)
    tile = phase_tile_cache(parity_ctx, lm_engine)
    del parity_ctx, lm_engine  # qwen2's weights and segments leave the card
    gc.collect()
    torch.cuda.empty_cache()
    cli = phase_serve_cli(tile["path"])
    gc.collect()
    torch.cuda.empty_cache()
    moe_parity = phase_moe_parity()
    moe = phase_moe_serve()
    gc.collect()
    torch.cuda.empty_cache()  # olmoe's weights leave the card
    mla_parity = phase_mla_parity()
    gc.collect()
    torch.cuda.empty_cache()
    mla = phase_mla_serve()
    gc.collect()
    torch.cuda.empty_cache()  # deepseek's weights leave the card
    ssm_parity = phase_ssm_parity()
    ssm = phase_ssm_serve()
    gc.collect()
    torch.cuda.empty_cache()  # mamba2's weights leave the card
    hybrid_parity = phase_hybrid_parity()
    hybrid = phase_hybrid_serve()
    gc.collect()
    torch.cuda.empty_cache()  # hymba's weights leave the card
    zoo_parity = phase_zoo_parity()
    gc.collect()
    torch.cuda.empty_cache()
    zoo = phase_zoo_serve()
    train_parity = phase_lm_train_parity()
    gc.collect()
    torch.cuda.empty_cache()
    lm_train = phase_lm_train()
    gc.collect()
    torch.cuda.empty_cache()
    moe_train_parity = phase_moe_train_parity()
    gc.collect()
    torch.cuda.empty_cache()
    moe_train = phase_moe_train()
    gc.collect()
    torch.cuda.empty_cache()
    mesh, mesh_train = phase_mesh()  # phases 13 and 28, on shared spawns

    head = [row for row in layers["rows"]
            if (row["mode"], row["rounding"]) == HEADLINE and row["fused_pool"]]
    fe_runs = {"frontend_chaos": fe["chaos"]["launches"],
               **{f"frontend_load_{row['offered_rps']:g}": row["launches"]
                  for row in fe["load_sweep"]["rows"]}}
    state_paths = {"ssm_parity": ssm_parity, "ssm_serve": ssm, "hybrid_parity": hybrid_parity,
                   "hybrid_serve": hybrid,
                   **{f"zoo_parity_{r['arch']}": r for r in zoo_parity},
                   **{f"zoo_serve_{r['arch']}": r for r in zoo}}
    paths = {"lenet_serve": lenet["main_path_launches"],
             "paper": paper["main_path_launches"],
             "lm_parity": parity["main_path_launches"]["paired_matmul"],
             "lm_serve": lm["main_path_launches"]["paired_matmul"],
             **{k: v["paired_matmul"] for k, v in fe_runs.items()},
             "tile_cache": tile["main_path_launches"]["paired_matmul"],
             "serve_cli": cli["main_path_launches"]["paired_matmul"],
             "mesh_decode": mesh["main_path_launches"]["paired_matmul"],
             "moe_parity": moe_parity["main_path_launches"]["paired_matmul"],
             "moe_serve": moe["main_path_launches"]["paired_matmul"],
             "mla_parity": mla_parity["main_path_launches"]["paired_matmul"],
             "mla_serve": mla["main_path_launches"]["paired_matmul"],
             **{k: v["main_path_launches"]["paired_matmul"] for k, v in state_paths.items()},
             "lm_train_parity": train_parity["main_path_launches"],
             "moe_train_parity": moe_train_parity["main_path_launches"],
             "lm_train": lm_train["main_path_launches"],
             "moe_train": moe_train["main_path_launches"],
             "mesh_train": mesh_train["main_path_launches"],
             "mesh_fsdp": fsdp["main_path_launches"]}
    k2_paths = {"lm_parity": parity["main_path_launches"]["decode_attention"],
                "lm_serve": lm["main_path_launches"]["decode_attention"],
                **{k: v["decode_attention"] for k, v in fe_runs.items()},
                "tile_cache": tile["main_path_launches"]["decode_attention"],
                "serve_cli": cli["main_path_launches"]["decode_attention"],
                "moe_parity": moe_parity["main_path_launches"]["decode_attention"],
                "moe_serve": moe["main_path_launches"]["decode_attention"],
                "mla_parity": mla_parity["main_path_launches"]["decode_attention"],
                "mla_serve": mla["main_path_launches"]["decode_attention"],
                **{k: v["main_path_launches"]["decode_attention"]
                   for k, v in state_paths.items()}}
    # K3 runs through its own entry point and whisper's encoder and
    # cross-attention prefill (the zoo paths); the other serving paths' prefill
    # attention is causal, and plain
    k3_paths = {"flash_attention": flash["main_path_launches"],
                "lm_parity": parity["main_path_launches"]["flash_attention"],
                "lm_serve": lm["main_path_launches"]["flash_attention"],
                **{k: v["flash_attention"] for k, v in fe_runs.items()},
                "tile_cache": tile["main_path_launches"]["flash_attention"],
                "serve_cli": cli["main_path_launches"]["flash_attention"],
                "moe_parity": moe_parity["main_path_launches"]["flash_attention"],
                "moe_serve": moe["main_path_launches"]["flash_attention"],
                "mla_parity": mla_parity["main_path_launches"]["flash_attention"],
                "mla_serve": mla["main_path_launches"]["flash_attention"],
                **{k: v["main_path_launches"]["flash_attention"]
                   for k, v in state_paths.items()}}
    k2 = lm["k2"]
    k3 = next(row for row in flash["timed"]
              if (row["case"], row["dtype"]) == ("qwen_causal_2048", "bfloat16"))
    zoo_by = {r["arch"]: r for r in zoo}
    timing_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{
        "name": "paired_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paired_matmul.cu",
        "replaces": "src/repro/kernels/paired_matmul.py:158",
        "launches": sum(paths.values()),
        "launches_by_path": paths,
        "max_abs_err": max(kernel["fp32_max_abs_err"], layers["max_abs_err"],
                           *(row["max_abs_err"] for row in paper["k1_headline_forward"]["rows"])),
        # one fused LeNet forward of 1000 images, per_column pairing at
        # r=0.05: the sum over its three launches
        "ms": sum(row["ms"] for row in head),
        "plain_ms": sum(row["plain_ms"] for row in head),
        "kernel_over_plain": sum(r["ms"] for r in head) / sum(r["plain_ms"] for r in head),
        "bound_ms": sum(row["bound_ms"] for row in head),
        "bound_by": "bytes" if sum(r["bytes"] / HBM_BYTES_PER_S for r in head)
        >= sum(r["flops"] / FP32_FLOP_PER_S for r in head) else "operations",
        "library_ms": sum(row["library_ms"] for row in head),
        # olmoe-1b-7b layer 0 on the expert grid (bf16, structured r=0.05):
        # gate on 4 shared decode rows, down on 4 rows an expert, gate on a
        # routed prompt's capacity rows
        "expert_grid": [{k: row[k] for k in ("weight", "x", "M", "n_cols", "ms", "plain_ms",
                                             "bound_ms", "bound_by", "library_ms")}
                        for row in moe["k1_expert_grid"]],
        # deepseek-v2-lite-16b (bf16, structured r=0.05) at 4 decode rows:
        # MLA's wq, w_dkv, w_kr (layer 1), the dense layer's w_down (K 10944,
        # residual fused), the shared experts' gate, and the expert grid at
        # 1408 columns an expert (gate on shared rows, down per expert)
        "deepseek": [{k: row[k] for k in ("weight", "M", "K", "N", "ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms") if k in row}
                     for row in mla["k1_new_shapes"] + mla["k1_expert_grid"]],
        # mamba2-2.7b's SSM projections (layer 0) and hymba-1.5b's GEMMs
        # (layer 1), bf16, structured r=0.05, at 4 decode rows
        **{arch: [{k: row[k] for k in ("weight", "M", "K", "N", "ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")}
                  for row in rec["k1_shapes"]]
           for arch, rec in (("mamba2", ssm), ("hymba", hybrid))},
        # qwen2-1.5b's training step (bf16, 1024 rows: batch 8 × seq 128),
        # layer 0's wq, wk, wo, w_gate, w_down, paired (structured r=0.05)
        # and dense, the residual fused into wo and w_down as in the step
        "training": [{k: row[k] for k in ("weight", "form", "M", "K", "N", "ms", "plain_ms",
                                          "bound_ms", "bound_by", "library_ms")}
                     for row in lm_train["k1_training_rows"]],
        # a (1, 2) training rank's shards of qwen2-1.5b's layer 0 (bf16,
        # 1024 rows, structured r=0.05): wq and w_gate at half their
        # columns, wo and w_down at half their rows
        "mesh_training": [{k: row[k] for k in ("weight", "M", "K", "N", *timing_keys)}
                          for row in mesh_train["k1_shard_rows"]],
        # olmoe-1b-7b's training step (bf16, structured r=0.05), layer 0's
        # gate, up and down on the expert grid at the step's routed rows
        # (batch 8 × capacity 20 = 160 rows an expert), launches a step
        "moe_training": {
            "launches_per_step": moe_train["k1_launches_per_step"],
            "rows": [{k: row[k] for k in ("weight", "x", "M", "E", "K", "bn", "n_cols",
                                          *timing_keys)} for row in moe_train[
                                              "k1_expert_grid_rows"]]},
        # the zoo's layer 0 at 4 decode rows (bf16, structured r=0.05):
        # qwen3-4b's wq, mistral-large-123b's w_gate and w_down, whisper's
        # cross wq and wo, and the others' wq and w_down
        "zoo": {arch: [{k: row[k] for k in ("weight", "M", "K", "N", *timing_keys)}
                       for row in rec["k1_shapes"]] for arch, rec in zoo_by.items()},
        # the tile cache's problems (qwen2-1.5b's serve engine, training rows,
        # the parity engine): the heuristic plan's ms and the measured winner's
        "tile_cache": [{k: row[k] for k in ("key", "heuristic_ms", "winner_ms", "bound_ms",
                                            "bound_by", "library_ms")}
                       for row in tile["problems"]],
    }, {
        "name": "decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:80",
        "launches": sum(k2_paths.values()),
        "launches_by_path": k2_paths,
        "max_abs_err": attn["fp32_max_abs_err"],
        # ops.fused_attn_decode's forward (one K2 launch) and its backward
        # (autograd of the plain composition) at qwen2's decode shapes, fp32
        "vjp": {k: moe_train_parity["fused_attn_decode_vjp"][k]
                for k in ("rel_err", "max_abs_err", "launches")},
        # one fused launch at the serving shapes: qwen2-1.5b layer 0, bf16,
        # batch 4, structured out-projection at r=0.05
        "ms": k2["ms"],
        "bare_ms": k2["bare_ms"],
        "plain_ms": k2["plain_ms"],
        "kernel_over_plain": k2["ms"] / k2["plain_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"],
        "library_ms": k2["library_ms"],
        "library_calls": k2["library_calls"],
        # olmoe-1b-7b layer 0 (H = KH = 16, G = 1, D 128, batch 4)
        "olmoe_g1": {k: moe["k2"][k] for k in ("ms", "bare_ms", "plain_ms", "bound_ms",
                                               "bound_by", "library_ms")},
        # hymba-1.5b layer 1 (swa: window 1024, 128 sinks; H 25 over KH 5,
        # D 64, 1600 columns, no residual; batch 4)
        "hymba_swa": {k: hybrid["k2"][k] for k in ("ms", "bare_ms", "plain_ms", "bound_ms",
                                                   "bound_by", "library_ms", "live_keys",
                                                   "masked_keys")},
        # layer 0 of each zoo engine: whisper G = 1 at D 64, qwen3 G = 4,
        # granite G = 4 at D 64, internvl2 G = 2, mistral G = 12 (batch 4)
        "zoo": {arch: {k: rec["k2"][k] for k in ("H", "KH", "D", "S", "bare_ms", *timing_keys)}
                for arch, rec in zoo_by.items()},
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:51",
        "launches": sum(k3_paths.values()),
        "launches_by_path": k3_paths,
        "max_abs_err": flash["fp32_max_abs_err"],
        # one launch at qwen2-1.5b's heads: B 4, causal S = 2048, bf16
        "form": k3["form"],
        "ms": k3["ms"],
        "plain_ms": k3["plain_ms"],
        "kernel_over_plain": k3["ms"] / k3["plain_ms"],
        "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"],
        "bound_fp32_fma_ms": k3["bound_fp32_fma_ms"],
        "library_ms": k3["library_ms"],
        "library_calls": flash["library_call"],
        # whisper-base's encoder self-attention (B 1, 1500 × 1500 frames,
        # H = KH = 8, D 64, full), bf16 and fp32, as the serving path runs it
        "whisper_encoder": [{k: row[k] for k in ("dtype", "form", "bound_fp32_fma_ms",
                                                 "achieved_tflop_s", *timing_keys)}
                            for row in flash["timed"] if row["case"] == "whisper_encoder_1500"],
    }]})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: no output")
    if failures:
        for f in failures:
            print(f"chip_smoke FAILED: {f}", file=sys.stderr)
        return 1
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s "
          f"(build {build['seconds']:.1f} s)", file=sys.stderr)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
