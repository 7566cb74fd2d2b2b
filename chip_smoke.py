#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py              # the smoke test below
    python3 chip_smoke.py --profile    # where one VGG round's time goes

1. Prints the card (``nvidia-smi`` name and power limit) and the torch and
   CUDA versions, and builds the port's CUDA sources
   (``src/repro_torch/kernels/csrc/fedavg.cu``, ``flash_attention.cu``,
   ``swa_attention.cu`` and ``netchange.cu``, one nvcc each, started
   together).
2. fedavg kernel phase: holds each aggregation kernel (``weighted_sum``,
   ``plane_agg``, ``plane_accum``, ``plane_finish``) against its plain
   PyTorch version on the card — at the VGG main path's shapes (the plane
   of the paper's union VGG-19-Wider, P = 40,717,642, K = 20 clients,
   stream chunks of 16 and 4 rows), at a lane-odd P, at k_chunk in
   {1, 2, K-1, K}, on the w = 0 corner, and streamed == whole-plane —
   and times kernel, the op that wraps it as the engine calls it, the
   plain version, the bound and, where one PyTorch call computes the
   same function (``weighted_sum``: the GEMV ``w @ x``; the unmasked
   ``plane_accum``: ``num.addmv_(x.t(), w)``), that call. Then the same
   for this slice's kernels: ``plane_accum_q`` (int8 chunks with per-tile
   scales: plain, masks + mult and the fold, at the main path's 16- and
   4-row chunks, at a lane-odd N with an all-zero tile and tile 512),
   ``weighted_sum_masked`` and ``weighted_sum_masked_mult`` at K = 20,
   and ``plane_accum`` on a bf16 chunk. ``plane_accum_q``'s rows also
   carry ``device_ms`` (20 launches captured in one CUDA graph and
   replayed between CUDA events: the card's own time; the launches
   cycle through copies of the operands, enough that three L2 caches'
   worth is moved before a copy is read again), ``call_ms`` (the
   old ``ms``: events around 20 back-to-back wrapper calls, which
   measure the host when it is the slower) and ``host_us``
   (``perf_counter`` over 200 calls enqueued without a synchronise),
   and ptxas's registers and spills of its four instances are printed.
3. VGG main path: the paper's 20-client fedadp round at full VGG width
   through ``FLRunConfig`` -> ``Simulator`` -> ``UnifiedEngine``:
   ``agg_layout="auto"`` (which resolves to the streaming layout), the
   streaming layout under ``agg_mode="coverage"``, then the whole-plane
   layout under "filler" and "coverage". The launch counts show that
   each kernel ran (``widen_2d`` too: NetChange's To-Wider at every
   round start); the streamed coverage round must equal the
   whole-plane coverage round; accuracies must be finite.
3b. Baselines phase (after the VGG main path): on the same cohort at full
   width, clustered, flexifed and standalone one round each with
   ``engine="auto"`` (which must resolve to the unified engine: the
   clients embedded at the fixed seed, one ``weighted_sum`` per cluster,
   one more for flexifed's prefix) and ``engine="loop"`` (each client in
   its own architecture, the averages through ``core.aggregation.fedavg``
   on client trees), from the same generator and samplers; then fedadp
   on the loop, filler and coverage (its aggregation streams at K = 20:
   ``plane_accum`` per 16-row chunk, ``plane_finish`` for coverage).
   Every run's launch counts must equal what the cohort gives
   (``fedavg_expected`` per average; ``widen_2d`` from one ``up`` /
   ``down`` per client counted on zero trees, ``netchange_launches``).
   Loop vs unified, logits of 16 test images: within 1e-4 x max|logits|
   for every client the union does not widen (VGG-16-Wider, VGG-19-Wider),
   and for every client the logits of its trained loop params in its
   own architecture against the same params embedded in the union's; a
   widened client's loop vs unified difference is printed (PERF.md §6:
   a Net2Net split sum rounds otherwise, and a fc0 ReLU that rounds to
   the other side of 0 moves the gradient by a whole sample's share). The loop's fedadp globals must match the unified rounds of
   step 3 from the same init and data (filler: round 1 of the ``auto``
   run; coverage: the streamed run) within 1e-4. Prints each run's
   round wall, final accuracy and peak memory.
4. The compressed wire on the same cohort through the same entry points:
   (a) ``wire="int8"``, ``agg_layout="auto"``, filler, 2 rounds; (b)
   ``wire="bf16"``, filler, 1 round; (c) ``wire="int8"``,
   ``wire_sparse=True``, ``agg_mode="coverage"``, 1 round. Checks: the
   int8 round ships exactly 20 x (P + 4 ceil(P/256)) = 827,077,160
   bytes, bf16 exactly half of f32, the sparse wire >= 4x fewer;
   ``plane_accum_q`` launches twice per int8 round (``plane_accum``,
   on bf16 chunks, twice per bf16 round); finite results; and the
   round-1 identity: from the same init and data as the f32 run of 3,
   ``max |g_wire - (g_f32 - sum_k w_k e'_k)| <= 1e-4`` after round 1,
   e' the error-feedback residuals (``engine.wire_residuals()``).
5. ``fedavg_stacked`` at full width: the 20 clients' round-start models
   in the union VGG-19-Wider as a stacked tree (3.26 GB), with their
   coverage masks, multiplicity trees and the global model as the
   fallback, aggregated on the plane, stream and leaf layouts (unmasked,
   masks, masks + mult + fallback). The layouts must agree within the
   fedavg tolerance; the leaf layout launches ``weighted_sum`` /
   ``weighted_sum_masked`` / ``weighted_sum_masked_mult`` once per leaf.
6. Flash kernel phase: holds ``flash_fwd`` (out, lse), ``flash_bwd_dq``
   (dq) and ``flash_bwd_dkv`` (dk, dv) against the plain versions
   (``kernels/flash_attention/ref.py``) at the transformer main path's
   shapes (B = 4 clients x 2 sequences, 2 KV heads x 16 query heads,
   S = 2048, hd = 128, causal), at S = 1000 padded to 1024 with -1
   positions, with a 256-token window, with KV = 4, G = 1, and with query
   rows that see no key; shows two launches of the forward and of each
   backward kernel bit-equal; prints ptxas's registers, shared memory
   and spills of the three kernels; times kernel, plain version, the
   bound and ``torch.nn.functional.scaled_dot_product_attention``
   (forward, and its backward for the two backward kernels, with
   ``enable_gqa``: the ``library`` column, and the backend it took) at
   the main shapes, and beside it the memory-efficient backend's forward
   and backward on heads expanded to KV * G (PyTorch's own split-TF32
   f32 attention; the backend named). All three kernels run split-TF32
   tensor-core products. Rows 8, 9 and 11 carry two operation bounds:
   f32 FFMA at 67 TFLOP/s, and split TF32 ("3xTF32", three tensor-core
   products per f32 one) at 495 / 3 TFLOP/s; ``bound_ms`` is the
   smaller, the least time f32-accurate work can take on the card.
7. Transformer main path: FedADP over a K = 4 cohort of glm4-9b at its
   published widths (d_model 4096, 32 query / 2 KV heads of 128, d_ff
   13696 and 6848 alternating, QKV bias, SwiGLU, RoPE) cut to 2 layers
   and a 512-token vocabulary, S = 2048, 2 sequences per client step,
   2 steps per round, SGD lr 0.05, through ``Simulator``:
   1 round with ``attn_backend="auto"`` (the flash kernels, one launch
   per layer per step for all 4 clients — the launch counts must say
   exactly that) and a breakdown of one training step. Eval losses must
   be finite. (The recurrentgemma and internvl2 cohorts hold a flash
   round against a blockwise one.)
8. Serving kernel phase: holds ``swa_decode`` against its plain version
   (``kernels/swa_attention/ref.py``) on a partly written ring (W = 1024,
   q_pos 37), bf16 k/v, an odd S, a query that sees no slot (the mean of
   v), the serve path's local (ring) and global caches and the JAX
   benchmark's shape (S = 16384, window 1024); ``swa_prefill`` on the
   JAX tests' four cases, an odd S, bf16, full bidirectional, the serve
   shape (B = 4, KV = 16, G = 2, S = 4096, window 1024; also against
   ``flash_fwd`` with the same window) and its refusal of
   ``causal=False`` with a window; ``widen_2d`` at the JAX benchmark's
   shape and the transformer cohort's FFN widening (8192 x 6848 ->
   13696, duplicate and split, columns and rows), bit-equal to its plain
   version and to ``core.netchange.widen_in`` / ``widen_out``. Prints
   ptxas's lines of ``swa_prefill_kernel`` and of ``swa_decode_kernel``
   at hd 128. ``swa_decode``'s rows carry ``device_ms``, ``call_ms`` and
   ``host_us`` as ``plane_accum_q``'s do. Times kernel, op, plain
   version, bound, SDPA with the same mask (attention; the backend it
   took named) or ``index_select`` (widen), ``flash_fwd`` with the same
   window and the memory-efficient backend with the band mask on
   expanded heads beside ``swa_prefill``, and ``flash_fwd`` at the serve
   path's global-layer shape (B = 4, KV = 16, G = 2, S = 4096, causal)
   against its plain version, SDPA and the memory-efficient backend.
9. Serve path: ``repro_torch.launch.serve.run("gemma3-27b", n_layers=12,
   batch=4, prompt_len=4096, gen=32)`` at the published widths, greedy.
   Its launch counts must be one ``swa_prefill`` per local layer and one
   ``flash_fwd`` per global layer in prefill, one ``swa_decode`` per
   layer per token. Prefill's last logits must match ``forward_hidden``
   of the prompt (flash kernels on every layer) within 2e-4 x
   max|logits|, the last step's those of prompt + generated tokens
   within 2e-3 x max|logits| (``tests/test_smoke_archs.py``'s
   tolerances); ``ops.decode_attention`` on a local (ring) and a global
   layer's real cache, after prefill and after the last step, must match
   the model's plain ``decode_attention`` within 1e-4
   (``tests/test_kernels.py``'s). Prints prefill s (and a warm second
   prefill), decode ms per token (the first step apart), the peak and the
   decode step's bound (every weight read once per token), and where one
   decode step's time goes (a local block, a global block, the
   vocabulary projection, the rest), each part beside its bound, and the
   host's time to enqueue one step.
10. Head dims 8 and 256: the five attention kernels against their plain
   versions at both head dims (causal, a window, GQA, MQA with 16 query
   heads, a cross shape, rows that see no key; ring, bf16, MQA and
   no-visible-slot decode; windowed, bf16, MQA and ragged prefill),
   ptxas's lines of the decode instances
   at hd 8 and 256 (phases 6 and 8 print the others) and each kernel's
   dynamic shared memory as the libraries compute it (``attn_smem``);
   then each held against its plain version and timed at gemma-7b's
   shapes (``HD_TIMES``: training B = 8, KV = 16, G = 1, S = 2048,
   causal, forward and both backward kernels, the shape the cohort and
   the trainer run; serve prefill B = 4, S = 4096; decode B = 4, S =
   4128, window 0) and ``swa_prefill`` at recurrentgemma-9b's local
   layers (MQA, window 2048), beside the bounds, the plain versions and
   the memory-efficient backend on the same heads (a ``hd_variants``
   line).
11. The dense configs served at their published widths through
   ``launch.serve.run``: gemma-7b cut to 8 of 28 layers (4 x 4096
   prompt tokens + 32) and
   command-r-plus-104b cut to 4 of 64 layers (2 x 2048 + 16; GQA with
   12 query heads a kv head). Launches: one ``flash_fwd`` a layer in
   prefill, one ``swa_decode`` a layer a token. Prefill's and the last
   step's logits against one ``forward_hidden`` of prompt + generated
   tokens (2e-4 and 2e-3 x max|logits|), ``ops.decode_attention`` on a
   real cache against the plain version (1e-4).
12. The gemma-7b FedADP cohort (``GEMMA_COHORT``: K = 2 clients, d_ff
   24576 and 12288 at d_model 3072, 16 heads of 256,
   cut to 1 layer and a 512-token vocabulary; S = 2048, batch 2, 2
   steps, SGD lr 0.05): one f32 round through the flash kernels and one
   round under the bf16 compute policy, held against the f32 round (1e-2,
   the reference's bf16 contract; the global model stays f32) and, leaf
   by leaf, at a tenth of what the f32 round moved the leaf (printed
   with the round's movement, global after - global before). Flash
   launches: one forward a layer a step (plus one a client view for the
   eval) and one of each backward kernel.
13. The trainer: ``launch.train.run("gemma-7b")`` at published widths,
   2 of 28 layers, the 256,000-token vocabulary, batch 2 x 2048 tokens,
   5 AdamW steps with a cosine warm-up. The first loss must match a
   blockwise step's within 1e-4 x the loss, every loss be finite, and
   the flash kernels launch once a layer a step each; prints ms/step,
   the peak and the losses.
14. Head dim 192 (MLA's qk head dim, the MoE slice): ptxas's lines and
   the shared memory of the three flash kernels at hd 192; the refusals
   that stay (``swa_prefill`` at 192, every kernel at 96); the kernels
   against their plain versions on edge cases (MLA's KV = H, G = 1 at S
   = 300, the 64-row tile's edges, a window, cross, rows that see no
   key); then at deepseek-v2's serve prefill (B 2, KV 128, S 2048) and
   trainer (B 1) shapes through ``flash_attention``, held against the
   float64 function in ``tests/test_flash.py``'s elementwise form
   (value ``atol=1e-4, rtol=1e-5``; dq, dk, dv ``1e-5, 1e-5``; the plain
   f32 version's own distance printed beside), and timed beside the
   bounds, the plain versions and the memory-efficient backend on the
   same heads (an ``mla_variants`` line).
15. mixtral-8x7b served at published widths through
   ``launch.serve.run``, 4 of 32 layers (2 × 8192 prompt tokens, so the
   4096-slot rings wrap, + 32 greedy): 4 ``swa_prefill`` and 128
   ``swa_decode`` launches; prefill's logits against ``forward_hidden``
   of the prompt (2e-4 × max|logits|); the last decode step again on a
   copy of the final cache with the plain attention (1e-4 ×
   max|logits|, the same greedy tokens); ``swa_decode`` against the
   plain decode attention on a real ring cache (1e-4), ``swa_prefill``
   against its plain version on random heads at the prompt's shape
   (B 2, KV 8, G 4, S 8192, window 4096); each part timed alone
   (``moe_breakdown``: one layer's attention and MoE FFN at the prompt
   and at a decode token, the vocabulary projection, the step).
16. deepseek-v2-236b served, 3 of 60 layers (2 × 2048 + 32): 3
   ``flash_fwd`` launches at hd 192, MLA's decode plain (no kernel);
   prefill logits and the breakdown as in 15; the last step again in
   the absorbed MLA form (1e-4 × max|logits|, the same greedy tokens).
17. The mixtral FedADP cohort (vocabulary 512, S 2048, batch 2, 2
   steps, SGD lr 0.05, fedadp filler): first the three flash kernels
   against their plain versions at the cohort's shapes (B 2 and 4, KV
   8, G 4, S 2048, window 4096); (a) clients of 2, 4 and 8
   experts, 1 layer, ``engine="auto"`` (resolves to the loop: expert
   count is not segment-representable), streamed a client row at a
   time; each client's round model against its union
   embedding (1e-4 × max|logits| for the unwidened 8-expert client, the
   widened ones printed); (b) a depth cohort of 1 and 2 layers on 3
   experts (top-2) on the unified engine (``"auto"``, one client a
   chunk) and on the loop from the same init and data, globals within
   1e-4. Every run's flash,
   ``swa_prefill`` (the no-gradient eval of local layers), aggregation
   and ``widen_2d`` launches equal the cohort's; each run's local
   training time is printed beside its wall.
18. The trainer on deepseek-v2-236b (1 of 60 layers, 16 of 160 routed
   experts, the whole 102,400-token vocabulary, batch 1 × 2048, 3
   AdamW steps): the three flash kernels at hd 192, 3 launches each;
   the first loss against a blockwise step's (1e-4 × the loss).
19. The recurrent family's kernels: ``swa_decode`` at recurrentgemma-9b's
   decode (MQA, 16 query heads on one kv head of 256, the 2048-slot ring
   wrapped) and the flash pair at its cohort's chunk (S 4096, window
   2048 cutting in) against their plain versions, then timed beside the
   bounds, the plain versions and the memory-efficient backend.
20. recurrentgemma-9b (RG-LRU + local attention, 12 of 38 layers) and
   xlstm-125m (mLSTM / sLSTM, 12 layers) served whole at published
   widths through ``launch.serve.run`` (4 × 4096 + 32 and 4 × 256 +
   32): 4 ``swa_prefill`` and 128 ``swa_decode`` launches (none for
   xlstm); prefill's and the last step's logits against one
   ``forward_hidden`` (2e-4 / 2e-3 × max|logits|: the recurrent states
   carried through every step); ``swa_decode`` on a real ring cache
   (1e-4); decode ms a token beside its bound (the weights read once a
   token); each layer kind's prefill timed alone.
21. The recurrentgemma-9b cohort (one unit, full width, vocabulary 512,
   S 4096): (a) K 2, d_ff 12288 and 6144, on the unified engine,
   one f32 round through the flash kernels against a blockwise round
   (1e-4), one of each flash kernel a local layer a step a chunk, a
   ``swa_prefill`` a client view in the eval, ``widen_2d`` > 0; (b) a
   d_rnn 4096 / 2048 pair, ``engine="auto"`` resolving to the loop,
   each client's embedding within 1e-4 × max|logits|,
   the round's ``widen_2d`` launches (RG-LRU leaves only) as counted.
22. xlstm-125m's depth cohort (1 and 3 units, S 32) on the unified
   engine and the loop: globals within 1e-4, launches as counted.
23. The trainer on xlstm-125m whole (2 × 64, 2 AdamW steps): finite
   losses, no kernel launched (it has no attention).
24. The front ends' kernels at hd 64 (``FRONT_FLASH``, ``FRONT_DECODE``):
   the flash kernels at whisper-small's encoder (B 4, 12 heads, 1500
   frames, bidirectional: a 28-key tail past 23 tiles of 64) and
   cross-attention (448 rows onto the 1500 frames, every position 0) and
   at internvl2-1b's prefill (G 7, causal 4096) and trainer chunk (2 x
   2048); ``swa_decode`` on whisper's cross cache (positions all 0, the
   query at 0) and internvl2-1b's self cache (G 7, 4128 slots). Each
   against its plain version, then timed beside the bounds, the plain
   versions and the memory-efficient backend.
25. whisper-small and internvl2-1b served whole through
   ``launch.serve.run`` (``FRONT_SERVE``: 4 x 416 + 32 over 1500
   frames; 4 x (256 patches + 3840) + 32): 36 / 24 ``flash_fwd`` (the
   encoder, self- and cross-attention) and 768 ``swa_decode`` launches;
   prefill's and the last step's logits against one ``forward_hidden``
   with the same ``aux`` (2e-4 / 2e-3 x max|logits|); the cross kv
   after decoding against the encoder's output projected again;
   ``swa_decode`` on the real self and cross caches (1e-4); decode ms a
   token beside the decoder's weights and caches read once.
26. The trainers (``FRONT_TRAIN``): whisper whole, 4 x 448 over 1500
   frames, and internvl2-1b whole, 2 x (256 + 1792), each on zero aux
   (the reference trainer's) and on N(0, 1) aux, 5 AdamW steps (one on
   internvl2-1b's zero patches): the first loss against the blockwise
   attention's (1e-4 x the loss), one of each flash kernel a flash layer
   a step; the N(0, 1) runs' losses and parameters finite, the zero
   runs' non-finite parameters counted (exact zero rows overflow the
   gradient through their RMSNorms, in the reference too: PERF.md §6).
27. The internvl2-1b cohort (``IV_COHORT``): K 2, 24 layers x d_ff
   4864 and 12 layers x 2432, at the published widths and vocabulary,
   text-only, S 512, on the unified engine both clients in one chunk:
   the f32 flash round against a blockwise round (1e-4), exact flash
   launches, ``widen_2d`` > 0.
28. whisper's To-Wider (``WH_UP``): a d_ff 1536 client up to the union
   (the encoder's FFN too, through ``widen_2d``) keeps its logits over
   the same frames (rtol = atol = 5e-4); a whisper cohort without frames
   raises the engine's ``ValueError``.

The analysis phase (``analysis_phase``), once every source is built:
the kernels pass of ``repro_torch.analysis`` (ptxas's registers, spills
and shared bytes of every instantiation of the four sources against an
H100 block's limits, each printed; every op wrapper's launch case
launching its own CUDA kernel at the caller's shape, each kernel name
printed), clean; and the dry run's predictions (``launch.dryrun``,
counted on meta tensors in a process of its own started with the
script, ``dryrun_cases``) of the FSDP ranks' parameters, parameter and
AdamW bytes and data-axis gathers, reduce-scatters, loss sums and
combines, and of glm4-9b's model-axis all_reduces at model 2, which
``tp_path``'s reports hold the ranks' measurements to, exactly (their
peaks at least the predicted resident bytes). The main path's two-round
run also holds, with ``analysis.retrace``, that its round 2 builds and
loads no library.

The mesh phases (``MESH``, ``EP``, ``REMAT``): after the wire phase,
the client mesh (``mesh_path``): the same 20-client
full-width cohort and round config over 4 ranks spawned on the one card
(``launch.mesh.run_ranks``, gloo), 5 clients a rank, one round each of
plane filler, plane coverage (the edge reduce: ``plane_accum`` into a
partial triple, one ``all_reduce``, ``plane_finish``) and auto (the
stream layout, its accumulator all_reduced); every rank's globals
within 1e-4 of the main path's single-process round of the same config
(round 1 of the auto run), ``agg_stats`` "edge" (plane) with 4 edges;
per rank the launches, round wall, all_reduce time and peak. The same
ranks then run the per-client methods, wires and checkpoints
(``mesh_methods_path``,
``MESH_METHODS``; the baselines and wire phases hand over their
single-process runs of the same configs): clustered, flexifed and
standalone one
round each, clustered at participation 0.2 for two (rows change rank),
the int8 wire for two rounds (it checkpoints every round), the bf16 wire
at 0.2 for two (residual rows move with their clients), sparse int8 under
coverage for one, and the int8 run resumed from its round-1 file on the
mesh and in one process: every rank's state (the per-client plane, or
the globals, and the residual plane) equal to every other rank's and
within 1e-4 of the single process's run of the same config (a wire's
round 2 within 1e-4 plus its largest participant weight times its
largest quantization step, with at most 1 in 10^5 entries over 1e-4,
see ``_wire_tol``; the residual rows a rank encodes in round 2 against
the single process's round-1 rows), ``bytes_per_round`` the single
process's, the resume restoring the round-1 state bit for bit and its
round 2 bit-equal to the uninterrupted run's, one file a round (and its
residual sibling); per rank and run the round walls, the all_reduce
seconds and bytes, the rows moved, the peak and the launches. Last,
expert parallelism (``ep_path``): mixtral-8x7b at its published widths
on 2 ranks of 4 experts — prefill logits at 2 layers (2 x 2048) within
2e-5 x max|logits| of the single process's, one AdamW step at 1 layer
with the loss and every gradient leaf (a rank's expert slice, every
other leaf whole) within 2e-5 (x the loss, x max|g|); then remat
(``remat_path``): gemma-7b at 2 layers, the trainer's 2 x 2048 and
vocabulary, plain vs ``ShardCtx(remat=True)`` with the "full" and the
"dots" policy: equal losses, gradients within 2e-5 x max|g|
(bit-equality reported), ``flash_fwd`` twice a layer under remat and
once plain, each backward kernel once, and the batch-free products'
counter (``models.layers.dot_counts``): "full" computes every one again
in the backward, "dots" none; the gradient's working set, AdamW ms a
step and peaks printed. The tensor-parallel phase (``tp_path``) also
trains whisper-small at model 2 through ``launch.train.run(ctx=, ckpt=)``: the
file has the one-process tree and shapes, ``tp_slice`` of it is each
rank's params bit for bit, and its forward in one process is within
1e-5 x max|logits| of the ranks' logits.

``--profile`` instead traces one warm round of the streamed filler and
of the whole-plane coverage layout of the VGG path with ``torch.profiler``
and prints, per round, its wall time, training share, device time by
kernel name (summed event durations) and the device's busy share (the
union of device-activity intervals inside the round's window, over the
window).

Tolerance for a fedavg kernel vs its plain version: max |diff| <= 1e-6 *
max|x| * sum|w| (x the dequantized chunk for ``plane_accum_q``, or the
base row it folds in; for the den and cov buffers sum|w| and the row
count). Both sum the same <= 20 f32 products per coordinate, in
different orders (the kernel sequentially per column, the plain version
in the library's order), so they differ by a few f32 roundings of the
weighted sum, which is bounded by max|x| * sum|w|.

Tolerance for the wire's round-1 identity: 1e-4, the JAX package's
width-cohort tolerance, as for the streamed vs whole-plane round: the
two runs' training differs only by cuDNN's run-to-run summation order,
and the aggregation by f32 summation order.

Tolerance for a flash kernel vs its plain version: max |diff| <= 1e-4 *
the largest finite |value| of the plain version (at least 1). Both sum
the same f32 terms in different orders — 128 products per score, up to
2048 keys per softmax row and output entry, up to G * S = 32768 (query,
key) terms per dk/dv entry — and f32 reordering error grows as sqrt(n)
* 6e-8 typically and n * 6e-8 at worst, relative to the summed
magnitudes. Rows that see no key carry lse = -1e30 in both and must
match exactly.

Tolerance for ``swa_decode`` / ``swa_prefill`` vs their plain versions:
that of the flash kernels (1e-4 x the largest |value|), for the same
reason; ``widen_2d`` must be bit-equal (a gather times one f32 scale).

Tolerance for the flash round vs the blockwise round: max |diff| of the
global parameters <= 1e-4, the JAX package's width-cohort tolerance: the
two differ only in the attention's and the aggregation's f32 summation
order, carried through two SGD steps.

The ``kernels`` line lists all 13 CUDA kernels (the 12 TPU kernels;
``flash_bwd`` is two), each with its launches on its main paths (flash:
the glm4, gemma-7b, mixtral, recurrentgemma and internvl2 cohorts, the
trainers, deepseek's and the front ends' prefills and whisper's up
check; swa: the serve runs and the mixtral and recurrentgemma cohorts'
evals; widen: every cohort's round starts and whisper's up),
each path's counts set to 0 just before it and read just after;
``swa_decode``'s and ``plane_accum_q``'s entries add ``device_ms``,
``call_ms`` and ``host_us``; the flash entries add ``hd_192``, the
kernel's numbers at deepseek-v2's trainer shape, and the flash and
``swa_decode`` entries ``recurrentgemma``, theirs at recurrentgemma-9b's
shapes (19), and ``whisper`` and ``internvl``, theirs at the front ends'
(24: the flash entries' ``whisper`` holds the encoder and the cross
shapes).

Any failure raises (exit code != 0). The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
# Segments that grow and shrink: the unified mixtral round peaks near the
# card's memory, and fixed segments left 7.8 GiB reserved in pieces too
# small for its 4.27 GiB gradient row (one run in three ran out)
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

K_MAIN = 20
REPS = 20
HOST_REPS = 200
L2_ROTATION = 3             # card_times: L2s moved before a copy's reuse
TOL = 1e-6
FLASH_TOL = 1e-4
TFFN_TOL = 1e-4
TPU_KERNELS = "src/repro/kernels/fedavg/fedavg.py"
SOURCE = "src/repro_torch/kernels/csrc/fedavg.cu"
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
FLASH_TPU = {"flash_fwd": "src/repro/kernels/flash_attention/fwd.py:92",
             "flash_bwd_dq": "src/repro/kernels/flash_attention/bwd.py:146",
             "flash_bwd_dkv": "src/repro/kernels/flash_attention/bwd.py:160"}
# the transformer main path: K clients x batch sequences of S tokens, the
# glm4-9b attention geometry
TFFN = dict(arch="glm4-9b", K=4, batch=2, S=2048, n_per_client=8,
            n_layers=2, vocab=512)
FLASH_MAIN = dict(B=TFFN["K"] * TFFN["batch"], KV=2, G=16, S=TFFN["S"],
                  hd=128)
# the serve path: gemma3-27b at its published widths, 12 of 62 layers
SERVE = dict(arch="gemma3-27b", n_layers=12, batch=4, prompt_len=4096,
             gen=32)
SERVE_GEOM = dict(KV=16, G=2, hd=128, window=1024)   # gemma3-27b attention
# the JAX package's decode benchmark shape (benchmarks/kernels.py:54)
DECODE_BENCH = dict(B=1, KV=8, G=2, hd=128, S=16384, window=1024)
SERVE_PREFILL_TOL = 2e-4      # x max|logits|, tests/test_smoke_archs.py:74
SERVE_DECODE_TOL = 2e-3       # x max|logits|, tests/test_smoke_archs.py:79
SERVE_KERNEL_TOL = 1e-4       # tests/test_kernels.py:140
# head dims 8 and 256: the kernels timed at gemma-7b's attention shapes
# (16 heads of 256, one kv head each): training (the cohort's 4 clients x
# 2 sequences), serve prefill and serve decode; swa_prefill also at
# recurrentgemma-9b's local layers (MQA: 1 kv head of 16 query heads,
# window 2048)
HD_TIMES = {"train": dict(B=8, KV=16, G=1, S=2048),
            "prefill": dict(B=4, KV=16, G=1, S=4096),
            "decode": dict(B=4, KV=16, G=1, S=4128)}
RG_LOCAL = dict(B=4, KV=1, G=16, S=4096, window=2048)
# the dense configs served at published widths: gemma-7b cut to 8 of 28
# layers (whole, 34.2 GB of f32 weights, it took 13-15 s of the script's
# time limit with its reference forward), command-r-plus-104b to 4 of 64
DENSE_SERVE = (dict(arch="gemma-7b", n_layers=8, batch=4, prompt_len=4096,
                    gen=32),
               dict(arch="command-r-plus-104b", n_layers=4, batch=2,
                    prompt_len=2048, gen=16))
# the gemma-7b FedADP cohort: K clients alternating d_ff 24576 and 12288,
# cut to 1 of 28 layers (each layer's dense E Eᵀ matrices take K x 24576²
# x 4 B, built on the host every round: at K 4, 9.66 GB and ~20 s of each
# ~23 s round on an NVIDIA H100 80GB HBM3, 700.00 W) and the 512-token
# seed vocabulary; K 2, one client of each width, since the script must
# fit its time limit
GEMMA_COHORT = dict(arch="gemma-7b", K=2, batch=2, S=2048, n_per_client=8,
                    n_layers=1, vocab=512)
BF16_TOL = 1e-2               # bf16 round vs f32 round, tests/test_flash.py
# ... and leaf by leaf at most a tenth of what the f32 round moved the
# leaf (tests/test_torch_bf16.py BF16_UPDATE_RTOL): the absolute 1e-2
# cannot tell a round that trained from one that did not
BF16_UPDATE_RTOL = 0.1
# the standalone trainer: gemma-7b at published widths, 2 of 28 layers,
# the whole 256,000-token vocabulary, AdamW with a cosine warm-up
TRAIN = dict(arch="gemma-7b", n_layers=2, batch=2, seq=2048, steps=5,
             lr=3e-4)
TRAIN_LOSS_TOL = 1e-4         # x the loss: flash vs blockwise, first step
# the MoE family: head dim 192 (MLA's qk dim, deepseek-v2's 128 heads, one
# kv head each) timed at deepseek's serve prefill and trainer shapes
MLA_HD = 192
MLA_TIMES = {"prefill": dict(B=2, KV=128, G=1, S=2048),
             "train": dict(B=1, KV=128, G=1, S=2048)}
# tests/test_flash.py's elementwise form: the value (out . cot) and the
# gradients
REF_VALUE_TOL = (1e-4, 1e-5)  # atol, rtol
REF_GRAD_TOL = (1e-5, 1e-5)
# mixtral-8x7b served at published widths, 4 of 32 layers (every layer
# local, window 4096: 8192-token prompts wrap the rings); deepseek-v2-236b
# 3 of 60 layers (MLA: prefill through flash_fwd at hd 192, decode plain)
MOE_SERVE = (dict(arch="mixtral-8x7b", n_layers=4, batch=2, prompt_len=8192,
                  gen=32),
             dict(arch="deepseek-v2-236b", n_layers=3, batch=2,
                  prompt_len=2048, gen=32))
MOE_DECODE_TOL = 1e-4         # x max|logits|: a decode step, two routes
# the mixtral FedADP cohort at published widths, the 512-token vocabulary:
# (a) the loop (engine "auto" must resolve to it): 1 layer, clients of 2,
# 4 and 8 experts (with a second 8-expert client the round peaked at
# 75.75 GB on an NVIDIA H100 80GB HBM3, 700.00 W: past ~70 GB), streamed
# one client row at a time (k_chunk 1: the 5.81 GB union updates, their
# stack and one row); (b) a depth-only cohort of 1 and 2 layers on 3 of
# the 8 experts (top-2 kept, so each token's router chooses), on the
# unified engine one client a chunk and on the loop from the same init
# and data. The unified round's peak is its local training: beside the
# engine's mask and filler planes, the global model and the round start
# (8 union planes P), the vmapped gradient holds the forward's and the
# backward's hidden-width tensors (~28 GB at 2 experts) and the
# gradients. Both clients in one chunk ran out of that
# card at 3 experts; one a chunk peaks at 69.93 GB (4 experts: out)
MOE_COHORT = dict(arch="mixtral-8x7b", vocab=512, batch=2, S=2048,
                  n_per_client=8, loop_experts=(2, 4, 8), loop_k_chunk=1,
                  unified_layers=(1, 2), unified_experts=3,
                  unified_k_chunk=1)
EMBED_TOL = 1e-4              # x max|logits|: a client vs its embedding
# the trainer on deepseek-v2-236b: 1 of 60 layers, 16 of 160 routed
# experts (top-6 and the 2 shared kept), the whole 102,400-token vocabulary
MOE_TRAIN = dict(arch="deepseek-v2-236b", n_layers=1, n_experts=16, batch=1,
                 seq=2048, steps=3, lr=3e-4)
# the recurrent family at published widths: recurrentgemma-9b (RG-LRU and
# local MQA attention, pattern (rglru, rglru, local), window 2048) cut to
# 4 of its 12 units and (rglru, rglru) (whole, 38 layers took 16 s of the
# script's time limit with its reference forward) at gemma-7b's serve shape,
# the 4096-token prompts wrapping the 2048-slot rings; xlstm-125m (12
# layers, 3 mLSTM : 1 sLSTM, no attention) on 256-token prompts (its
# prefill is a loop over time on the host: 1024 took 13-17 s of the
# script's time limit with its reference forward)
RECURRENT_SERVE = (dict(arch="recurrentgemma-9b", n_layers=12, batch=4,
                        prompt_len=4096, gen=32),
                   dict(arch="xlstm-125m", batch=4, prompt_len=256,
                        gen=32))
# recurrentgemma-9b's decode attention: 16 query heads on one kv head of
# 256 (four clusters share it: swa_decode serves 4 query heads a cluster
# at hd 256), the ring after the serve run's last token
RG_DECODE = dict(B=4, KV=1, G=16, hd=256, window=2048, q_pos=4127)
# the recurrentgemma-9b FedADP cohort at one pattern unit (rglru, rglru,
# local) and full width, the 512-token vocabulary, S 4096 so the window of
# 2048 cuts inside the training step: (a) unified, K 2 clients, d_ff 12288
# and 6144 (E Eᵀ: 2 x 12288² x 4 B = 1.2 GB a FFN layer; K 4 took ~16 s a
# round, the script's time limit asks for fewer), one client a chunk (two
# ran out of the card's 80 GB: the f32 round peaks at 62.47 GB, the
# blockwise one at 71.52 with one), the f32 flash round against a
# blockwise round; (b) the loop ("auto" must resolve to it), d_rnn 4096
# and 2048
RG_COHORT = dict(arch="recurrentgemma-9b", K=2, batch=1, S=4096,
                 n_per_client=4, n_layers=3, vocab=512, k_chunk=1)
RG_LOOP = dict(arch="recurrentgemma-9b", vocab=512, batch=1, S=4096,
               n_per_client=4, d_rnn=(4096, 2048))
# xlstm-125m's depth cohort (1, 2, 3 and 3 of its 3 units, the whole
# 50,304-token vocabulary) and its trainer. The sequential mLSTM keeps
# about 3 tensors of B x 4 x 384² x 4 B (~7 MB x B) a step a layer for
# autograd: the 9 mLSTM layers of the whole model at B 1 hold ~33 GB at S
# 512 (the trainer peaked at 51.86 GB there: torch.func's gradient keeps
# the backward's graph too) and the steps are paced by the host, one
# time step at a time: 19.4 s a trainer step at 1 x 512, 8.1-10.8 at 1 x
# 256, 3.85-5.84 at 2 x 128 (NVIDIA H100 80GB HBM3, 700.00 W; the host
# paces it). The script's time limit leaves the trainer 2 steps at 2 x 64
# and the cohort S 32 and two clients (1 and 3 units: 4 clients of 1, 2,
# 3, 3 units at S 128 took 38 s for the two rounds), in one vmapped chunk
XL_COHORT = dict(arch="xlstm-125m", vocab=50304, batch=1, S=32,
                 n_per_client=2, units=(1, 3), k_chunk=2)
XL_TRAIN = dict(arch="xlstm-125m", batch=2, seq=64, steps=2, lr=3e-4)
# the front ends, whole and at published widths: whisper-small (a 12-layer
# bidirectional encoder over 1500 frame embeddings, 12 "crossdec" layers,
# 12 heads of 64) and internvl2-1b (24 layers, 14 query heads on 2 kv heads
# of 64, 256 patch embeddings ahead of the text). The kernels at their
# shapes (hd 64, f32): the encoder, B 4 over 1500 frames, bidirectional;
# cross-attention, 448 text rows onto the 1500 frames, every position 0;
# internvl2-1b's prefill (4 x (256 + 3840), causal, a group of 7) and its
# trainer's chunk (2 x (256 + 1792)); which kernels each shape times
FRONT_HD = 64
FRONT_FLASH = {
    "whisper encoder": dict(B=4, KV=12, G=1, Sq=1500, Sk=1500, causal=False,
                            zeros=False, time=("flash_fwd", "flash_bwd_dq",
                                               "flash_bwd_dkv")),
    "whisper cross": dict(B=4, KV=12, G=1, Sq=448, Sk=1500, causal=False,
                          zeros=True, time=("flash_fwd", "flash_bwd_dq",
                                            "flash_bwd_dkv")),
    "internvl prefill": dict(B=4, KV=2, G=7, Sq=4096, Sk=4096, causal=True,
                             zeros=False, time=("flash_fwd",)),
    "internvl train": dict(B=2, KV=2, G=7, Sq=2048, Sk=2048, causal=True,
                           zeros=False, time=("flash_bwd_dq",
                                              "flash_bwd_dkv"))}
# swa_decode on whisper's cross cache (1500 slots, every position 0, the
# query at 0) and on internvl2-1b's self cache after the serve run's last
# token (G 7: one cluster of 8 query lanes a kv head, one lane idle)
FRONT_DECODE = {
    "whisper cross": dict(B=4, KV=12, G=1, S=1500, q_pos=0, kind="zeros"),
    "internvl self": dict(B=4, KV=2, G=7, S=4128, q_pos=4127, kind="iota")}
# served whole: whisper 4 x 416 prompt tokens + 32 (448, its text context)
# over 1500 frames; internvl2-1b 4 x (256 patches + 3840) + 32
FRONT_SERVE = (dict(arch="whisper-small", batch=4, prompt_len=416, gen=32),
               dict(arch="internvl2-1b", batch=4, prompt_len=3840, gen=32))
# trained whole, 5 AdamW steps: whisper 4 x 448 over 1500 frames and
# internvl2-1b 2 x (256 + 1792), each on zero aux (the reference
# trainer's) and on N(0, 1) aux (``launch.train.modality_aux``). Zero aux
# stays exact zero rows through every layer, and an RMSNorm's Jacobian at
# a zero row is 1/sqrt(eps) = 1000 a layer: the gradient through them
# overflows f32 (internvl2-1b in its first step; whisper's encoder within
# 10; NVIDIA H100 80GB HBM3, 700.00 W), as in the reference, so the
# zero-aux runs hold their first loss and have their non-finite
# parameters counted, and the N(0, 1) runs are held finite throughout
FRONT_TRAIN = (dict(arch="whisper-small", batch=4, seq=448, steps=5,
                    lr=3e-4, aux="zeros", hold_finite=False),
               dict(arch="whisper-small", batch=4, seq=448, steps=5,
                    lr=3e-4, aux="normal", hold_finite=True),
               dict(arch="internvl2-1b", batch=2, seq=1792, steps=5,
                    lr=3e-4, aux="normal", hold_finite=True),
               dict(arch="internvl2-1b", batch=2, seq=1792, steps=1,
                    lr=3e-4, aux="zeros", hold_finite=False))
# the internvl2-1b FedADP cohort at published widths, text-only (the
# federated batches carry tokens and labels): K 2, 24 layers x d_ff 4864
# and 12 layers x 2432 (depth and width at once; K 4, every pair, took
# ~18 s, more than the script's time limit leaves it), the whole
# 151,655-token vocabulary, S 512, batch 2, both clients in one vmapped
# chunk; the blockwise round one client a chunk (its score blocks are
# kept for the backward)
IV_COHORT = dict(arch="internvl2-1b", K=2, batch=2, S=512, n_per_client=8,
                 n_layers=24, vocab=151655, k_chunk=2, blockwise_k_chunk=1,
                 variants=(dict(), dict(n_units=12, ffn_scale=0.5)))
# whisper's To-Wider: a d_ff 1536 client up to the union at 3072 (the
# encoder's FFN with it) keeps its logits on 2 x 448 tokens over the same
# frames, tests/test_tfamily.py's form (rtol = atol = 5e-4)
WH_UP = dict(arch="whisper-small", batch=2, S=448, ffn_scale=0.5)
UP_TOL = 5e-4
SWA_SOURCE = "src/repro_torch/kernels/csrc/swa_attention.cu"
SWA_TPU = {"swa_decode": "src/repro/kernels/swa_attention/decode.py:79",
           "swa_prefill": "src/repro/kernels/swa_attention/prefill.py:105"}
WIDEN_SOURCE = "src/repro_torch/kernels/csrc/netchange.cu"
WIDEN_TPU = "src/repro/kernels/netchange/widen.py:57"
# data-sheet HBM bandwidth by card name (bytes/s); the SXM H100 otherwise
HBM_BYTES_PER_S = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12),
                   ("H200", 4.8e12), ("H100", 3.35e12))
F32_FLOPS_PER_S = 67e12       # H100 SXM data sheet, f32 outside tensor cores
TF32_FLOPS_PER_S = 495e12     # H100 SXM data sheet, dense TF32 tensor cores


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def hbm_rate(name: str) -> float:
    for key, rate in HBM_BYTES_PER_S:
        if key in name:
            return rate
    return 3.35e12


def op_bounds(nbytes: int, flops: int, tensor_cores: bool = False) -> dict:
    """The least time for a function: its bytes over the HBM rate, its
    f32 operations over the FFMA rate or, with ``tensor_cores``, the
    faster of that and split TF32 (three TF32 products per f32-accurate
    one, at 495 / 3 TFLOP/s); both operation bounds are kept."""
    bytes_ms = nbytes / hbm_rate(torch.cuda.get_device_name(0)) * 1e3
    ffma_ms = flops / F32_FLOPS_PER_S * 1e3
    tf32x3_ms = 3 * flops / TF32_FLOPS_PER_S * 1e3
    ops_ms = min(ffma_ms, tf32x3_ms) if tensor_cores else ffma_ms
    out = {"bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    if tensor_cores:
        out.update(bound_ffma_ms=ffma_ms, bound_3xtf32_ms=tf32x3_ms)
    return out


def cuda_ms(fn, reps: int = REPS) -> float:
    """Mean milliseconds per call over ``reps`` calls (CUDA events), after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Errors:
    """Largest error seen per kernel, each check against the tolerance."""

    def __init__(self):
        self.max = {}

    def hold(self, kernel: str, got, want, scale: float, what: str,
             tol_factor: float = TOL) -> None:
        err = float((got.float() - want.float()).abs().max())
        tol = tol_factor * scale
        print(f"  {kernel:12s} {what:44s} max_abs_err={err:.3e} "
              f"tol={tol:.3e}")
        check(math.isfinite(err) and err <= tol,
              f"{kernel} {what}: max abs err {err} > {tol}")
        self.max[kernel] = max(self.max.get(kernel, 0.0), err)


def cohort_inputs(K, n, gen, dev, *, zero_rows=0):
    """Random plane x, weights w (normalized, the first ``zero_rows``
    zero), coverage masks m, multiplicities mu (0 where m is 0) and
    fallback fb — built on the card."""
    x = torch.randn(K, n, generator=gen, device=dev)
    w = torch.rand(K, generator=gen, device=dev) + 0.1
    w[:zero_rows] = 0.0
    w /= w.sum()
    m = (torch.rand(K, n, generator=gen, device=dev) < 0.6).float()
    if zero_rows:
        # columns 0:256 are covered only by the zero-weight clients
        m[:, :256] = 0.0
        m[:zero_rows, :256] = 1.0
    m[:, -128:] = 0.0                         # uncovered tail -> fallback
    mu = torch.randint(1, 4, (K, n), generator=gen, device=dev).float() * m
    fb = torch.randn(n, generator=gen, device=dev)
    return x, w, m, mu, fb


def stream(ops, n, K, kc, x, w, m=None, mu=None, fb=None, renorm=True):
    acc = ops.PlaneAccumulator(n, device=x.device)
    for lo in range(0, K, kc):
        hi = min(lo + kc, K)
        acc.update(x[lo:hi], w[lo:hi],
                   masks=None if m is None else m[lo:hi],
                   mult=None if mu is None else mu[lo:hi])
    return acc.finish(renorm=renorm, fallback=fb)


def with_copies(fn, *tensors):
    """``fn`` over copy ``i`` of ``tensors`` (the originals for i = 0,
    clones after): what ``time_row``'s ``card`` takes."""
    def make(i):
        args = tensors if i == 0 else tuple(t.clone() for t in tensors)
        return lambda: fn(*args)
    return make


def card_times(make, nbytes: int, reps: int = REPS,
               host_reps: int = HOST_REPS) -> dict:
    """The card's and the host's shares of one wrapper call.
    ``device_ms``: ``reps`` calls captured in one CUDA graph (buffers
    allocated ahead, or by the wrapper from the graph's own pool), the
    graph warmed up and replayed between two CUDA events, over ``reps``:
    the card's time per launch with no host in the way. The calls cycle
    through ``copies`` copies of the operands (``make(i)``: the call on
    copy i), enough that ``L2_ROTATION`` times the card's L2 cache is
    moved before a copy comes round again, so a call of ``nbytes`` finds
    its operands in device memory, not in the L2, as the main path's
    calls do (one per layer, each on its own cache). ``host_us``:
    ``time.perf_counter`` over ``host_reps`` calls enqueued without a
    synchronise, over ``host_reps``: what enqueueing one call costs the
    host."""
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    copies = max(1, min(reps, math.ceil(L2_ROTATION * l2 / nbytes)))
    fns = [make(i) for i in range(copies)]
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fns[0]()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fns[i % copies]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    device_ms = start.elapsed_time(end) / reps
    del graph
    t0 = time.perf_counter()
    for _ in range(host_reps):
        fns[0]()
    host_us = (time.perf_counter() - t0) / host_reps * 1e6
    torch.cuda.synchronize()
    del fns
    return {"device_ms": device_ms, "host_us": host_us, "copies": copies,
            "l2_bytes": l2}


def time_row(rows, name, kernel_fn, op_fn, plain_fn, nbytes, flops,
             library_fn=None, tensor_cores=False, card=None, reps=REPS,
             plain_reps=REPS):
    """Time one kernel variant: the kernel, the op that wraps it as the
    engine calls it (``op_fn``; None: not timed), the plain version and,
    where one PyTorch call computes the same function, that call, over
    ``reps`` calls (``plain_reps`` for the plain version); the bound from
    the bytes the function must move and its f32 operations
    (``op_bounds``). With
    ``card`` (``with_copies`` of the kernel's call), also the kernel's
    ``device_ms`` and ``host_us`` (``card_times``) and ``call_ms``, the
    same number as ``ms``: CUDA events around back-to-back wrapper
    calls, which measure the host where enqueueing a call takes it
    longer than the card takes to run it."""
    ms = cuda_ms(kernel_fn, reps)
    op_ms = cuda_ms(op_fn, reps) if op_fn is not None else None
    plain_ms = cuda_ms(plain_fn, plain_reps)
    lib_ms = cuda_ms(library_fn, reps) if library_fn is not None else None
    rows[name] = {"ms": ms, "op_ms": op_ms, "plain_ms": plain_ms,
                  **op_bounds(nbytes, flops, tensor_cores),
                  "library_ms": lib_ms, "bytes": nbytes, "flops": flops}
    extra = ""
    if card is not None:
        rows[name].update(call_ms=ms, **card_times(card, nbytes))
        r = rows[name]
        extra = (f" device={r['device_ms']:.4f} ms "
                 f"({r['bound_ms'] / r['device_ms']:.1%} of bound, "
                 f"{r['copies']} operand copies) "
                 f"host={r['host_us']:.1f} us")
    print(f"  time {name:32s} kernel={ms:.4f} "
          + (f"op={op_ms:.4f} " if op_ms is not None else "")
          + f"plain={plain_ms:.4f} bound={rows[name]['bound_ms']:.4f} ms"
          + (f" (FFMA {rows[name]['bound_ffma_ms']:.4f}, 3xTF32 "
             f"{rows[name]['bound_3xtf32_ms']:.4f})" if tensor_cores else "")
          + (f" library={lib_ms:.4f} ms" if lib_ms is not None else "")
          + extra)


def kernel_phase(dev, P: int, errs: Errors):
    """Correctness everywhere; timings at the main path's shapes."""
    from repro_torch.kernels.fedavg import fedavg as fk
    from repro_torch.kernels.fedavg import ops, ref

    gen = torch.Generator(device=dev).manual_seed(0)

    # -- the corners: lane-odd P, every chunking, the w = 0 corner
    for n, zero_rows in ((1000, 0), (1_000_003, 0), (1_000_003, 5)):
        x, w, m, mu, fb = cohort_inputs(K_MAIN, n, gen, dev,
                                        zero_rows=zero_rows)
        scale = float(x.abs().max()) * float(w.abs().sum())
        tag = f"P={n} zero_rows={zero_rows}"
        plain_f = ref.weighted_sum_ref(x, w)
        plain_c = ref.plane_agg_ref(x, w, masks=m, mult=mu, fallback=fb)
        plane_f = ops.plane_agg(x, w)
        plane_c = ops.plane_agg(x, w, masks=m, mult=mu, fallback=fb)
        errs.hold("weighted_sum", plane_f, plain_f, scale, tag)
        errs.hold("plane_agg", plane_c, plain_c, scale, tag + " m,mu,fb")
        plain_m = ref.plane_agg_ref(x, w, masks=m, renorm=False)
        errs.hold("plane_agg", ops.plane_agg(x, w, masks=m, renorm=False),
                  plain_m, scale, tag + " m no-renorm")
        for kc in (1, 2, K_MAIN - 1, K_MAIN):
            s_f = stream(ops, n, K_MAIN, kc, x, w, renorm=False)
            s_c = stream(ops, n, K_MAIN, kc, x, w, m, mu, fb)
            errs.hold("plane_accum", s_f, plain_f, scale,
                      f"{tag} kc={kc} filler vs plain")
            errs.hold("plane_finish", s_c, plain_c, scale,
                      f"{tag} kc={kc} coverage vs plain")
            errs.hold("plane_accum", s_c, plane_c, scale,
                      f"{tag} kc={kc} stream == plane")
        # the functional faces of the streaming pair
        z = torch.zeros(n, device=dev)
        trip = ops.plane_accum(z, z, z, x, w, masks=m, mult=mu)
        want = ref.plane_accum_ref(z, z, z, x, w, m, mu)
        for got, exp in zip(trip, want):
            errs.hold("plane_accum", got, exp, scale, tag + " functional")
        errs.hold("plane_finish", ops.plane_finish(*trip, fallback=fb),
                  ref.plane_finish_ref(*want, fb), scale,
                  tag + " functional")
        errs.hold("plane_finish",
                  fk.plane_finish_2d(*[t[None] for t in trip], fb[None],
                                     renorm=False)[0],
                  ref.plane_finish_ref(*want, fb, renorm=False), scale,
                  tag + " fb no-renorm")
        del x, w, m, mu, fb

    # -- the main path's shapes: K = 20 rows of the full-width plane
    x, w, m, mu, fb = cohort_inputs(K_MAIN, P, gen, dev)
    scale = float(x.abs().max()) * float(w.abs().sum())
    errs.hold("weighted_sum", ops.plane_agg(x, w),
              ref.weighted_sum_ref(x, w), scale, f"P={P} K=20")
    want_c = ref.plane_agg_ref(x, w, masks=m, mult=mu, fallback=fb)
    errs.hold("plane_agg", ops.plane_agg(x, w, masks=m, mult=mu,
                                         fallback=fb),
              want_c, scale, f"P={P} K=20 m,mu,fb")
    errs.hold("plane_accum", stream(ops, P, K_MAIN, 16, x, w, renorm=False),
              ref.weighted_sum_ref(x, w), scale, f"P={P} kc=16 filler")
    errs.hold("plane_finish", stream(ops, P, K_MAIN, 16, x, w, m, mu, fb),
              want_c, scale, f"P={P} kc=16 coverage")
    del want_c
    torch.cuda.empty_cache()

    # -- times: the kernel, the op that wraps it as the engine calls it,
    # the plain version, and one library call where there is one
    rate = hbm_rate(torch.cuda.get_device_name(0))
    acc = [torch.zeros(1, P, device=dev) for _ in range(3)]
    op_acc = ops.PlaneAccumulator(P, device=dev)
    fb2 = fb[None]
    rows = {}

    def row(*args, **kw):
        time_row(rows, *args, **kw)

    col = P * 4                                  # one f32 row of the plane
    x16, w16 = x[:16], w[:16].contiguous()
    x4, w4 = x[16:], w[16:].contiguous()
    m16, mu16 = m[:16], mu[:16]
    row("weighted_sum K=20",
        lambda: fk.weighted_sum_2d(x, w),
        lambda: ops.plane_agg(x, w),
        lambda: ref.weighted_sum_ref(x, w),
        K_MAIN * col + col, 2 * K_MAIN * P, lambda: w @ x)
    row("plane_agg K=20 m,mu,fb",
        lambda: fk.plane_agg_2d(x, w, m, mu, fb),
        lambda: ops.plane_agg(x, w, masks=m, mult=mu, fallback=fb),
        lambda: ref.plane_agg_ref(x, w, masks=m, mult=mu, fallback=fb),
        3 * K_MAIN * col + 2 * col, 6 * K_MAIN * P + 2 * P)
    row("plane_accum filler kc=16",
        lambda: fk.plane_accum_2d(*acc, x16, w16),
        lambda: op_acc.update(x16, w16),
        lambda: ref.plane_accum_ref(*acc, x16, w16),
        16 * col + 6 * col, 4 * 16 * P + 3 * P,
        lambda: acc[0][0].addmv_(x16.t(), w16))
    # addmv_ updates num only: it moves x and num's row, 18 of the
    # kernel's 22 rows, so it is held to its own bound
    r = rows["plane_accum filler kc=16"]
    r["library_bound_ms"] = op_bounds(16 * col + 2 * col,
                                      2 * 16 * P + P)["bound_ms"]
    print(f"  plane_accum filler kc=16: addmv_ (num only, 18 of 22 rows) "
          f"{r['library_ms']:.4f} ms, its bound {r['library_bound_ms']:.4f} "
          f"ms; kernel {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms")
    row("plane_accum filler kc=4",
        lambda: fk.plane_accum_2d(*acc, x4, w4),
        lambda: op_acc.update(x4, w4),
        lambda: ref.plane_accum_ref(*acc, x4, w4),
        4 * col + 6 * col, 4 * 4 * P + 3 * P)
    row("plane_accum coverage kc=16",
        lambda: fk.plane_accum_2d(*acc, x16, w16, m16, mu16),
        lambda: op_acc.update(x16, w16, masks=m16, mult=mu16),
        lambda: ref.plane_accum_ref(*acc, x16, w16, m16, mu16),
        3 * 16 * col + 6 * col, 6 * 16 * P + 3 * P)
    row("plane_finish renorm+fb",
        lambda: fk.plane_finish_2d(*acc, fb2, renorm=True),
        lambda: op_acc.finish(fallback=fb),
        lambda: ref.plane_finish_ref(*acc, fb2, renorm=True),
        5 * col, 3 * P)
    print(json.dumps({"kernel_variants": rows, "P": P,
                      "hbm_bytes_per_s": rate,
                      "f32_flops_per_s": F32_FLOPS_PER_S}))
    del x, w, m, mu, fb, acc, op_acc, x16, x4, m16, mu16
    torch.cuda.empty_cache()
    return rows


def wire_kernel_phase(dev, P: int, errs: Errors):
    """This slice's kernels vs their plain versions: ``plane_accum_q``
    (int8 chunks: plain, masks + mult, fold) at the VGG main path's
    16- and 4-row chunks, at a lane-odd N with an all-zero tile and tile
    512; ``weighted_sum_masked[_mult]`` at K = 20; ``plane_accum`` on a
    bf16 chunk. Times at the main shapes, as ``kernel_phase``'s."""
    from repro_torch.core import quant
    from repro_torch.kernels.fedavg import fedavg as fk
    from repro_torch.kernels.fedavg import ops, ref

    for line in ptxas_lines("fedavg", "plane_accum_q"):
        print(f"  ptxas {line}")
    gen = torch.Generator(device=dev).manual_seed(2)

    def hold_q(tag, xq, s, w, tile, m=None, mu=None, base=None):
        """num within 1e-6 · max|x| · Σ|w| (x the dequantized chunk, or
        the base row it folds in), den within 1e-6 · Σ|w|, cov (sums of
        0/1) within 1e-6 · rows."""
        n = xq.shape[1]
        z = torch.zeros(n, device=dev)
        kw = dict(masks=m, mult=mu, base=base, tile=tile)
        got = ops.plane_accum_q(z, z, z, xq, s, w, **kw)
        want = ops.plane_accum_q(z, z, z, xq, s, w, use_kernel=False, **kw)
        big = float((xq.abs().amax(1).float() * s.amax(1)).max())
        if base is not None:
            big = max(big, float(base.abs().max()))
        wsum = float(w.abs().sum())
        for what, g, e, sc in zip(("num", "den", "cov"), got, want,
                                  (big * wsum, wsum, xq.shape[0])):
            errs.hold("plane_accum_q", g, e, sc, f"{tag} {what}")

    # -- the corners: lane-odd N, a straddling last tile, all-zero tile,
    # tile 512, rows at odd byte offsets
    for n, tile, kc in ((1_000_003, 512, 3), (1_000_003, 256, 16),
                        (4_097, 128, 4)):
        x, w, m, mu, fb = cohort_inputs(kc, n, gen, dev)
        x[:, :tile] = 0.0                    # an all-zero tile
        xq, s = quant.quantize(x, "int8", tile=tile)
        tag = f"N={n} tile={tile} kc={kc}"
        hold_q(tag + " plain", xq, s, w, tile)
        hold_q(tag + " m,mu", xq, s, w, tile, m, mu)
        hold_q(tag + " fold", xq, s, w, tile, m, base=fb)
        check(float(s[:, 0].abs().max()) == 0.0, "all-zero tile scale")
        del x, w, m, mu, fb, xq, s

    # -- the main shapes: K = 20 rows of the full-width plane
    x, w, m, mu, fb = cohort_inputs(K_MAIN, P, gen, dev)
    scale = float(x.abs().max()) * float(w.abs().sum())
    errs.hold("weighted_sum_masked", ops.weighted_sum_masked(x, w, m),
              ref.weighted_sum_masked_ref(x, w, m), scale, f"P={P} K=20")
    errs.hold("weighted_sum_masked",
              ops.weighted_sum_masked(x, w, m, renorm=False),
              ref.weighted_sum_masked_ref(x, w, m, renorm=False), scale,
              f"P={P} K=20 no-renorm")
    errs.hold("weighted_sum_masked_mult",
              ops.weighted_sum_masked(x, w, m, mult=mu),
              ref.weighted_sum_masked_ref(x, w, m, mult=mu), scale,
              f"P={P} K=20")
    tile = 256
    x16, w16, m16, mu16 = x[:16], w[:16].contiguous(), m[:16], mu[:16]
    x4, w4 = x[16:], w[16:].contiguous()
    xq16, s16 = quant.quantize(x16, "int8", tile=tile)
    xq4, s4 = quant.quantize(x4, "int8", tile=tile)
    hold_q(f"P={P} kc=16 plain", xq16, s16, w16, tile)
    hold_q(f"P={P} kc=4 plain", xq4, s4, w4, tile)
    hold_q(f"P={P} kc=16 m,mu", xq16, s16, w16, tile, m16, mu16)
    hold_q(f"P={P} kc=16 fold", xq16, s16, w16, tile, m16, base=fb)
    xb16 = x16.to(torch.bfloat16)
    z = torch.zeros(P, device=dev)
    bf_want = ref.plane_accum_ref(z, z, z, xb16, w16)
    bf_got = ops.PlaneAccumulator(P, device=dev).update(xb16,
                                                        w16).partials()
    wsum = float(w16.abs().sum())
    for what, g, e, sc in zip(("num", "den", "cov"), bf_got, bf_want,
                              (float(xb16.abs().max()) * wsum, wsum, 16)):
        errs.hold("plane_accum", g, e, sc, f"P={P} kc=16 bf16 chunk {what}")
    del bf_want, bf_got
    torch.cuda.empty_cache()

    # -- times at the main shapes
    rate = hbm_rate(torch.cuda.get_device_name(0))
    acc = [torch.zeros(1, P, device=dev) for _ in range(3)]
    op_q = ops.PlaneAccumulator(P, device=dev, q_tile=tile)
    op_f = ops.PlaneAccumulator(P, device=dev)
    base = fb[None]
    rows = {}
    col = P * 4
    nt = quant.n_tiles(P, tile)
    bufs = 6 * col                          # num, den, cov read + written

    def row(*args, **kw):
        time_row(rows, *args, **kw)

    row("plane_accum_q filler kc=16",
        lambda: fk.plane_accum_q_2d(*acc, xq16, s16, w16, tile=tile),
        lambda: op_q.update_q(xq16, s16, w16),
        lambda: ref.plane_accum_q_ref(*acc, xq16, s16, w16, tile=tile),
        16 * P + 16 * nt * 4 + bufs, 5 * 16 * P + 3 * P,
        card=with_copies(lambda xq: fk.plane_accum_q_2d(
            *acc, xq, s16, w16, tile=tile), xq16))
    row("plane_accum_q filler kc=4",
        lambda: fk.plane_accum_q_2d(*acc, xq4, s4, w4, tile=tile),
        lambda: op_q.update_q(xq4, s4, w4),
        lambda: ref.plane_accum_q_ref(*acc, xq4, s4, w4, tile=tile),
        4 * P + 4 * nt * 4 + bufs, 5 * 4 * P + 3 * P,
        card=with_copies(lambda xq: fk.plane_accum_q_2d(
            *acc, xq, s4, w4, tile=tile), xq4))
    row("plane_accum_q coverage kc=16",
        lambda: fk.plane_accum_q_2d(*acc, xq16, s16, w16, m16, mu16,
                                    tile=tile),
        lambda: op_q.update_q(xq16, s16, w16, masks=m16, mult=mu16),
        lambda: ref.plane_accum_q_ref(*acc, xq16, s16, w16, m16, mu16,
                                      tile=tile),
        16 * P + 16 * nt * 4 + 2 * 16 * col + bufs, 7 * 16 * P + 3 * P,
        card=with_copies(lambda xq, m, mu: fk.plane_accum_q_2d(
            *acc, xq, s16, w16, m, mu, tile=tile), xq16, m16, mu16))
    row("plane_accum_q fold kc=16",
        lambda: fk.plane_accum_q_2d(*acc, xq16, s16, w16, m16, None, base,
                                    tile=tile),
        lambda: op_q.update_q(xq16, s16, w16, masks=m16, base=fb),
        lambda: ref.plane_accum_q_ref(*acc, xq16, s16, w16, m16, None,
                                      base, tile=tile),
        16 * P + 16 * nt * 4 + 16 * col + col + bufs, 9 * 16 * P + 3 * P,
        card=with_copies(lambda xq, m: fk.plane_accum_q_2d(
            *acc, xq, s16, w16, m, None, base, tile=tile), xq16, m16))
    row("weighted_sum_masked K=20",
        lambda: fk.weighted_sum_masked_2d(x, w, m),
        lambda: ops.weighted_sum_masked(x, w, m),
        lambda: ref.weighted_sum_masked_ref(x, w, m),
        2 * K_MAIN * col + col, 4 * K_MAIN * P + P)
    row("weighted_sum_masked_mult K=20",
        lambda: fk.weighted_sum_masked_mult_2d(x, w, m, mu),
        lambda: ops.weighted_sum_masked(x, w, m, mult=mu),
        lambda: ref.weighted_sum_masked_ref(x, w, m, mult=mu),
        3 * K_MAIN * col + col, 5 * K_MAIN * P + P)
    row("plane_accum bf16 kc=16",
        lambda: fk.plane_accum_2d(*acc, xb16, w16),
        lambda: op_f.update(xb16, w16),
        lambda: ref.plane_accum_ref(*acc, xb16, w16),
        16 * P * 2 + bufs, 4 * 16 * P + 3 * P)
    print(json.dumps({"wire_kernel_variants": rows, "P": P, "tile": tile,
                      "hbm_bytes_per_s": rate}))
    del x, w, m, mu, fb, acc, op_q, op_f, xq16, s16, xq4, s4, xb16, base
    del x16, x4, m16, mu16
    torch.cuda.empty_cache()
    return rows


def paper_cohort():
    """The main path's cohort: the paper's 20 clients at full VGG width
    on synth-easy (4000 train samples, 20% per round, batch 64), and the
    run config of its fedadp protocol."""
    from repro_torch.configs.vgg_family import paper_client_archs, vgg
    from repro_torch.data import (EASY, ClientSampler, image_classification,
                                  iid_partition)
    from repro_torch.fl import FLRunConfig

    cfgs = [vgg(a) for a in paper_client_archs()]
    n_train = 4000
    data = image_classification(EASY, n_train, seed=0)
    test = image_classification(EASY, 800, seed=999)
    parts = iid_partition(n_train, len(cfgs), seed=0)

    def samplers():
        return [ClientSampler(data, p, round_fraction=0.2, batch_size=64,
                              seed=i) for i, p in enumerate(parts)]

    def run_cfg(layout, agg_mode, rounds, method="fedadp", **kw):
        return FLRunConfig(method=method, rounds=rounds, local_epochs=2,
                           lr=0.03, momentum=0.9, seed=0, eval_every=1,
                           agg_layout=layout, agg_mode=agg_mode, **kw)

    return cfgs, samplers, test, run_cfg


def after_round1(fed, fn):
    """Call ``fn(engine, global_after_round_1)`` inside the run, right
    after its first round (before round 2 overwrites what it reads)."""
    run_round = fed.backend.run_round

    def wrapped(state, r, selected):
        out = run_round(state, r, selected)
        if r == 0:
            fn(fed.backend.engine, out)
        return out
    fed.backend.run_round = wrapped


def main_path():
    """The paper's 20-client cohort at full width, one run per layout;
    returns per-kernel launch counts summed over the runs, the global
    model after round 1 of the ``auto`` filler run and the global model
    of the one-round streamed coverage run, both packed, on the host
    (what the wire runs and the loop's fedadp rounds are held
    against)."""
    from repro_torch.analysis.retrace import RetraceDetector
    from repro_torch.core import PlaneSpec, VGGFamily, plane
    from repro_torch.fl import Simulator
    from repro_torch.kernels.fedavg import fedavg as fk
    from repro_torch.kernels.netchange import widen as wk
    from repro_torch import tree as tu

    # a vmap over the convs that silently loops per client is a fault
    warnings.filterwarnings("error", message=".*batching rule.*")
    cfgs, samplers, test, run_cfg = paper_cohort()
    launches = dict.fromkeys(fk.KERNELS + wk.KERNELS, 0)
    results = {}
    round1 = {}
    runs = (("auto", "filler", 2), ("stream", "coverage", 1),
            ("plane", "filler", 1), ("plane", "coverage", 1))
    for layout, agg_mode, rounds in runs:
        rc = run_cfg(layout, agg_mode, rounds)
        sim = Simulator(VGGFamily(), cfgs, samplers(), rc, test)
        fed = sim._build()
        engine = fed.backend.engine
        det = RetraceDetector()
        if (layout, agg_mode) == ("auto", "filler"):
            # round 2 builds no library and loads none (the attention
            # sources build on other threads meanwhile: not this run's)
            after_round1(fed, lambda eng, g: (round1.setdefault(
                "g", plane.pack(g, eng.plane_spec).cpu()), round1.setdefault(
                "builds", dict(det.counts))))
        engine.timing = True
        records = []
        fed.callbacks.append(records.append)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fk.reset_launch_counts()
        wk.reset_launch_counts()
        t0 = time.perf_counter()
        with det:
            res = fed.run(torch.Generator().manual_seed(rc.seed))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if "builds" in round1 and "round2" not in round1:
            later = {k: det.counts[k] - round1["builds"][k]
                     for k in det.counts}
            round1["round2"] = later
            print(f"  run-time builds (analysis.retrace) of the {layout} "
                  f"{agg_mode} run: round 1 {round1['builds']}, round 2 "
                  f"{later} (cache misses: the round's NetChange seeds' "
                  f"segment matrices)")
            check(later["build"] == 0 and later["load"] == 0,
                  f"round 2 built or loaded a library: {later}")
        counts = {**fk.launch_counts(), **wk.launch_counts()}
        for k, v in counts.items():
            launches[k] += v
        stats = engine.agg_stats()
        gleaves = tu.leaves(res["global_params"])
        finite = all(bool(torch.isfinite(t).all()) for t in gleaves)
        round_walls = [records[0]["wall_s"]] + [
            b["wall_s"] - a["wall_s"] for a, b in zip(records, records[1:])]
        info = {
            "agg_layout": layout, "agg_mode": agg_mode, "rounds": rounds,
            "resolved_layout": stats["layout"], "k_chunk": stats["k_chunk"],
            "round_wall_s": round_walls, "run_wall_s": wall,
            "phase_stats": engine.phase_stats(), "agg_stats": stats,
            "history": res["history"], "final_acc": res["final_acc"],
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "launches": counts, "P": engine.plane_spec.size}
        print(json.dumps({"main_path_run": info}))
        check(finite, f"{layout}/{agg_mode}: non-finite global params")
        check(all(math.isfinite(a) for a in res["history"]),
              f"{layout}/{agg_mode}: non-finite accuracy")
        check(len(gleaves) == engine.plane_spec.n_leaves,
              "global params do not match the union layout")
        # keep only the global model: the next run's peak memory is its own
        results[(layout, agg_mode)] = (res["global_params"], stats)
        del sim, fed, engine, res, gleaves
        torch.cuda.empty_cache()

    check(results[("auto", "filler")][1]["layout"] == "stream",
          "agg_layout='auto' did not resolve to 'stream' at K=20, full width")
    check(launches["plane_accum"] >= 2 and launches["plane_finish"] >= 1,
          f"streamed rounds did not launch the streaming pair: {launches}")
    check(launches["weighted_sum"] >= 1 and launches["plane_agg"] >= 1,
          f"whole-plane rounds did not launch their kernels: {launches}")
    # one coverage round, streamed and whole-plane: the same math on the
    # same data and init
    diff = max(float((a - b).abs().max()) for a, b in zip(
        tu.leaves(results[("stream", "coverage")][0]),
        tu.leaves(results[("plane", "coverage")][0])))
    print(f"  stream vs plane coverage round: max |diff| of global params "
          f"= {diff:.3e} (tol 1e-4)")
    check(diff <= 1e-4, f"stream round != plane round: {diff}")
    g_cov = plane.pack(results[("stream", "coverage")][0],
                       PlaneSpec.from_tree(results[("stream", "coverage")][0])
                       ).cpu()
    # the whole-plane rounds' globals: what the client-mesh rounds of the
    # same config are held against
    g_plane = {mode: plane.pack(results[("plane", mode)][0], PlaneSpec.
                                from_tree(results[("plane", mode)][0])).cpu()
               for mode in ("filler", "coverage")}
    return launches, round1["g"], g_cov, g_plane


def wire_path(g_f32, refs=None):
    """The compressed wire on the paper's cohort through ``FLRunConfig``
    -> ``Simulator`` -> ``UnifiedEngine``: (a) int8, ``auto`` (stream,
    chunks of 16 + 4), filler, 2 rounds; (b) bf16, filler, 1 round; (c)
    int8 on the sparse coverage wire, 1 round. Checks the wire bytes,
    the launches, finite results, and the round-1 identity: from the
    same init and data the wire round's global equals the f32 round's
    (``g_f32``) minus ``Σ_k w_k e'_k``, e' the residuals after round 1
    (e = 0 before it). Runs (a) and (c) are ``MESH_METHODS`` runs: given
    ``refs``, their single-process results go there (``mm_ref``).
    Returns the launch counts summed over the runs."""
    from repro_torch import tree as tu
    from repro_torch.core import VGGFamily, plane, quant
    from repro_torch.core.aggregation import subset_weights
    from repro_torch.fl import Simulator
    from repro_torch.kernels.fedavg import fedavg as fk
    from repro_torch.kernels.netchange import widen as wk

    cfgs, samplers, test, run_cfg = paper_cohort()
    launches = dict.fromkeys(fk.KERNELS + wk.KERNELS, 0)
    f32_bytes = None
    runs = (("a", dict(wire="int8"), "filler", 2),
            ("b", dict(wire="bf16"), "filler", 1),
            ("c", dict(wire="int8", wire_sparse=True), "coverage", 1))
    for tag, wire, agg_mode, rounds in runs:
        rc = run_cfg("auto", agg_mode, rounds, **wire)
        fed = Simulator(VGGFamily(), cfgs, samplers(), rc, test)._build()
        engine = fed.backend.engine
        engine.timing = True
        records = []
        fed.callbacks.append(records.append)
        ident, g1 = {}, {}

        def identity(eng, g, ident=ident, g1=g1):
            w = torch.as_tensor(subset_weights(eng.n_samples),
                                device=eng.device)
            corr = w @ eng.wire_residuals()        # Σ_k w_k e'_k
            gw = plane.pack(g, eng.plane_spec)
            ident["err"] = float((gw - (g_f32.to(gw.device) - corr)
                                  ).abs().max())
            ident["max_abs_residual"] = float(
                eng.wire_residuals().abs().max())
            g1["g"] = gw.cpu()
            if refs is not None and rounds > 1:
                g1["res"] = eng.wire_residuals().to("cpu", copy=True)
        if agg_mode == "filler":
            after_round1(fed, identity)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fk.reset_launch_counts()
        wk.reset_launch_counts()
        t0 = time.perf_counter()
        res = fed.run(torch.Generator().manual_seed(rc.seed))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {**fk.launch_counts(), **wk.launch_counts()}
        for k, v in counts.items():
            launches[k] += v
        ws = engine.wire_stats()
        round_walls = [records[0]["wall_s"]] + [
            b["wall_s"] - a["wall_s"] for a, b in zip(records, records[1:])]
        info = {"run": tag, **wire, "agg_mode": agg_mode, "rounds": rounds,
                "resolved_layout": engine.agg_stats()["layout"],
                "k_chunk": engine.agg_stats()["k_chunk"],
                "round_wall_s": round_walls, "run_wall_s": wall,
                "phase_stats": engine.phase_stats(),
                "agg_stats": engine.agg_stats(), "wire_stats": ws,
                "wire_bytes_records": [r.get("wire_bytes") for r in records],
                "history": res["history"],
                "max_memory_allocated": torch.cuda.max_memory_allocated(),
                "launches": counts, "round1_identity": ident}
        print(json.dumps({"wire_run": info}))
        gleaves = tu.leaves(res["global_params"])
        check(all(bool(torch.isfinite(t).all()) for t in gleaves),
              f"wire run {tag}: non-finite global params")
        check(all(math.isfinite(a) for a in res["history"]),
              f"wire run {tag}: non-finite accuracy")
        check(engine.agg_stats()["layout"] == "stream",
              f"wire run {tag} did not stream")
        check(all(r.get("wire_bytes") == ws["bytes_per_round"]
                  for r in records), f"wire run {tag}: record wire_bytes")
        f32_bytes = ws["f32_bytes"]
        if tag == "a":
            # 20 x (P + 4 ceil(P / 256)): 827,077,160 at P = 40,717,642
            want = len(cfgs) * quant.payload_nbytes(
                "int8", engine.plane_spec.size, tile=rc.wire_tile)
            check(ws["bytes_per_round"] == want,
                  f"int8 wire bytes {ws['bytes_per_round']} != {want}")
            check(counts["plane_accum_q"] == 2 * rounds
                  and counts["plane_accum"] == 0,
                  f"int8 rounds: launches {counts}")
        elif tag == "b":
            check(2 * ws["bytes_per_round"] == f32_bytes
                  and ws["reduction"] == 2.0, f"bf16 wire bytes {ws}")
            check(counts["plane_accum"] == 2 * rounds
                  and counts["plane_accum_q"] == 0,
                  f"bf16 round: launches {counts}")
        else:
            check(ws["reduction"] >= 4.0, f"sparse wire reduction {ws}")
            check(counts["plane_accum_q"] == 2 * rounds
                  and counts["plane_finish"] == rounds,
                  f"sparse coverage round: launches {counts}")
        if agg_mode == "filler":
            print(f"  wire {tag} round-1 identity: max |g_wire - (g_f32 - "
                  f"sum_k w_k e'_k)| = {ident['err']:.3e} (tol 1e-4)")
            check(ident["err"] <= 1e-4,
                  f"wire run {tag}: round-1 identity off by {ident['err']}")
        if refs is not None and tag in ("a", "c"):
            mm_ref(refs, ("fedadp", 1.0, wire, rounds), fed, records,
                   counts, g1.get("g"), g1.get("res"))
        del fed, engine, res, gleaves, g1
        free_device()
    return launches


BASELINE_TOL = 1e-4        # x max|logits|: loop vs unified client functions
FEDADP_LOOP_TOL = 1e-4     # loop vs unified fedadp globals (width cohort)
AUTO_STREAM_BYTES = 256 * 2 ** 20   # "auto" streams a plane past this


def fedavg_expected(k: int, n: int, masked: bool = False) -> dict:
    """Kernel launches of one ``core.aggregation.fedavg[_masked]`` over k
    trees of n coordinates under layout "auto": one whole-plane pass
    (``weighted_sum``; ``plane_agg`` with masks) up to 32 rows and 256
    MiB, else 16-row streamed chunks (one ``plane_accum`` each, and one
    ``plane_finish`` closing a masked average)."""
    if k > 32 or 4 * k * n > AUTO_STREAM_BYTES:
        return {"plane_accum": -(-k // 16), "plane_finish": int(masked)}
    return {"plane_agg" if masked else "weighted_sum": 1}


def netchange_launches(family, cfgs, gcfg, dev, seed_of):
    """``widen_2d`` launches of one ``up`` (client -> union) and one
    ``down`` (union -> client) per client at the seeds ``seed_of(k)``
    gives, counted on zero trees on the card: what a round's NetChange
    steps launch, client by client."""
    from repro_torch import tree as tu
    from repro_torch.kernels.netchange import widen as wk

    def zeros(cfg):
        return tu.tree_map(lambda t: torch.zeros(t.shape, device=dev),
                           family.shapes(cfg))

    def count(fn):
        wk.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        return wk.launch_counts()["widen_2d"]

    g0 = zeros(gcfg)
    ups, downs = [], []
    for k, cfg in enumerate(cfgs):
        z = zeros(cfg)
        ups.append(count(lambda: family.up(z, cfg, gcfg, seed=seed_of(k))))
        downs.append(count(lambda: family.down(g0, gcfg, cfg,
                                               seed=seed_of(k))))
    wk.reset_launch_counts()
    return ups, downs


def baselines_path(dev, g_filler, g_cov, refs=None):
    """The paper's three baselines and the per-client loop on the main
    path's cohort at full width: clustered, flexifed and standalone one
    round each with ``engine="auto"`` (which must resolve to the unified
    engine) and ``engine="loop"``, from the same generator (so the same
    per-client init) and samplers; then fedadp one round on the loop,
    filler and coverage. Checks each run's exact launch counts against
    the cohort's (``fedavg_expected``, ``netchange_launches``); the
    loop's client logits against the unified client views' (16 test
    images, 1e-4 x max|logits|) for every client the union does not
    widen, and for every client the logits of its trained loop params in
    its own and in the union architecture (the widened clients' loop vs
    unified difference is printed); the loop's fedadp globals against
    the unified rounds' of the main path (``g_filler``, ``g_cov``: same
    init and data, 1e-4); given ``refs``, the unified runs' results go
    there (``mm_ref``: they are ``MESH_METHODS`` runs); returns the
    launch counts summed over the runs."""
    from repro_torch import tree as tu
    from repro_torch.core import PlaneSpec, VGGFamily, plane
    from repro_torch.core.netchange import round_embed_seed
    from repro_torch.fl import Simulator
    from repro_torch.kernels.fedavg import fedavg as fk
    from repro_torch.kernels.netchange import widen as wk
    from repro_torch.models import vgg as vmodel

    warnings.filterwarnings("error", message=".*batching rule.*")
    cfgs, samplers, test, run_cfg = paper_cohort()
    family = VGGFamily()
    gcfg = family.union(cfgs)
    K = len(cfgs)
    names = fk.KERNELS + wk.KERNELS
    clusters = {}
    for k, c in enumerate(cfgs):
        clusters.setdefault(c.name, []).append(k)

    def size(cfg, path=()):
        return sum(t.numel() for t in tu.leaves(
            tu.get(family.shapes(cfg), path)))

    P = size(gcfg)
    seed = run_cfg("auto", "filler", 1).resolved_embed_seed
    up_embed, _ = netchange_launches(family, cfgs, gcfg, dev,
                                     lambda k: seed)
    up_r0, down_r0 = netchange_launches(
        family, cfgs, gcfg, dev, lambda k: round_embed_seed(seed, 0, k))
    _, down_r1 = netchange_launches(
        family, cfgs, gcfg, dev, lambda k: round_embed_seed(seed, 1, k))
    chains = [family.chain_paths(c) for c in cfgs]
    common = 0
    while (common < min(map(len, chains))
           and len({c[common][0] for c in chains}) == 1):
        common += 1

    def expected(method, engine, agg_mode):
        out = dict.fromkeys(names, 0)

        def add(part):
            for n_, v in part.items():
                out[n_] += v
        if engine == "unified":
            # the per-client state is embedded once, at the fixed seed;
            # one weighted_sum per cluster, one more for flexifed's prefix
            out["widen_2d"] = sum(up_embed)
            if method != "standalone":
                out["weighted_sum"] = (len(clusters)
                                       + (method == "flexifed"))
        elif method == "fedadp":
            masked = agg_mode == "coverage"
            add(fedavg_expected(K, P, masked))
            # distribute + collect at round 0, the coverage mask (one up
            # of ones) at round 0, the eval and the result's client
            # views (a distribute each) at round 1
            out["widen_2d"] = sum(down_r0) + sum(up_r0) * (1 + masked) \
                + 2 * sum(down_r1)
        elif method == "clustered":
            for ids in clusters.values():
                add(fedavg_expected(len(ids), size(cfgs[ids[0]])))
        elif method == "flexifed":
            for pos in range(common):
                add(fedavg_expected(K, size(cfgs[0], chains[0][pos][1])))
            for ids in clusters.values():
                ch = chains[ids[0]]
                for pos in range(common, len(ch)):
                    add(fedavg_expected(len(ids), size(cfgs[ids[0]],
                                                       ch[pos][1])))
        return out

    x16 = torch.as_tensor(test["x"][:16], device=dev)
    launches = dict.fromkeys(names, 0)

    def run(method, engine, agg_mode="filler"):
        rc = run_cfg("auto", agg_mode, 1, method=method, engine=engine)
        sim = Simulator(family, cfgs, samplers(), rc, test)
        fed = sim._build()
        records = []
        fed.callbacks.append(records.append)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fk.reset_launch_counts()
        wk.reset_launch_counts()
        t0 = time.perf_counter()
        res = fed.run(torch.Generator().manual_seed(rc.seed))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {**fk.launch_counts(), **wk.launch_counts()}
        for n_, v in counts.items():
            launches[n_] += v
        kind = fed.backend.name
        want = expected(method, kind, agg_mode)
        info = {"method": method, "engine": engine, "resolved": kind,
                "agg_mode": agg_mode,
                "round_wall_s": records[0]["wall_s"], "run_wall_s": wall,
                "final_acc": res["final_acc"],
                "max_memory_allocated": torch.cuda.max_memory_allocated(),
                "launches": counts, "expected": want}
        print(json.dumps({"baselines_run": info}))
        tag = f"{method}/{engine}/{agg_mode}"
        check(counts == want, f"{tag}: launches {counts} != {want}")
        check(all(math.isfinite(a) for a in res["history"]),
              f"{tag}: non-finite accuracy")
        check(all(bool(torch.isfinite(t).all())
                  for t in tu.leaves(res["client_params"])),
              f"{tag}: non-finite client params")
        check((res["global_params"] is None) == (method != "fedadp"),
              f"{tag}: global params of the wrong kind")
        if refs is not None and kind == "unified":
            mm_ref(refs, (method, 1.0, {}, 1), fed, records, counts)
        del sim, fed
        return res, kind

    # clients the union does not widen (their embedding is depth only:
    # identity convs, exact): the engine must reproduce the loop, as
    # tests/test_unified.py holds on its depth cohort. A widened client's
    # Net2Net split sums round otherwise, and a fc0 pre-activation that
    # rounds to the other side of 0 moves its ReLU gradient by a whole
    # sample's share (PERF.md §6): its total is measured, and the
    # embedding's own fidelity (the loop's trained client in its
    # architecture and embedded in the union's) is held for every client
    depth_emb = [family.depth_only([c, gcfg]) for c in cfgs]
    worst = {}

    def rel(a, b):
        return float((a - b).abs().max()) / float(b.abs().max())
    for method in ("clustered", "flexifed", "standalone"):
        res, kind = run(method, "auto")
        check(kind == "unified", f"{method}: engine='auto' took {kind}")
        with torch.no_grad():
            uni = [vmodel.apply(p, gcfg, x16) for p in res["client_params"]]
        del res
        free_device()
        res, kind = run(method, "loop")
        check(kind == "loop", f"{method}: engine='loop' took {kind}")
        total, arch = [], []
        with torch.no_grad():
            for k, (p, cfg) in enumerate(zip(res["client_params"], cfgs)):
                la = vmodel.apply(p, cfg, x16)
                total.append(rel(uni[k], la))
                arch.append(rel(vmodel.apply(
                    family.up(p, cfg, gcfg, seed=seed), gcfg, x16), la))
        del res, uni
        free_device()
        held = max(t for t, d in zip(total, depth_emb) if d)
        widened = max(t for t, d in zip(total, depth_emb) if not d)
        worst[method] = {"depth_embedded": held, "widened": widened,
                         "embedding": max(arch)}
        print(f"  {method}: loop vs unified client logits, max |diff| / "
              f"max|logits|: depth-embedded clients {held:.3e} (tol "
              f"{BASELINE_TOL:g}); widened clients {widened:.3e} "
              f"(measured); the embedding of every trained loop client "
              f"{max(arch):.3e} (tol {BASELINE_TOL:g})")
        check(held <= BASELINE_TOL,
              f"{method}: loop and unified depth-embedded clients "
              f"disagree: {total}")
        check(max(arch) <= BASELINE_TOL,
              f"{method}: the union embedding changes a trained client's "
              f"function: {arch}")
    spec = PlaneSpec.from_tree(family.shapes(gcfg))
    for agg_mode, want in (("filler", g_filler), ("coverage", g_cov)):
        res, kind = run("fedadp", "loop", agg_mode)
        g = plane.pack(res["global_params"], spec).cpu()
        del res
        free_device()
        worst[f"fedadp {agg_mode}"] = diff = float((g - want).abs().max())
        print(f"  fedadp {agg_mode}: loop vs unified global params, max "
              f"|diff| = {diff:.3e} (tol {FEDADP_LOOP_TOL:g})")
        check(diff <= FEDADP_LOOP_TOL,
              f"fedadp {agg_mode}: loop round != unified round: {diff}")
    check(launches["plane_accum"] >= 2 and launches["plane_finish"] >= 1,
          f"the loop's fedadp rounds did not stream: {launches}")
    print(json.dumps({"baselines_path": {"P": P, "prefix_layers": common,
                                         "clusters": len(clusters),
                                         "loop_vs_unified": worst,
                                         "launches": launches}}))
    return launches


def stacked_path(dev):
    """``fedavg_stacked`` at full width: the 20 clients' round-start
    models in the union VGG-19-Wider as a stacked ``(20, ...)`` tree with
    their coverage masks, multiplicity trees and the global model as the
    fallback, aggregated on the plane, stream and leaf layouts —
    unmasked, with masks, and with masks + mult + fallback. The three
    layouts must agree within the fedavg tolerance; the leaf layout
    launches one kernel per leaf. Returns the launch counts."""
    from repro_torch import tree as tu
    from repro_torch.core import VGGFamily, plane
    from repro_torch.core import aggregation as agg
    from repro_torch.fl import UnifiedEngine
    from repro_torch.kernels.fedavg import fedavg as fk

    cfgs = paper_cohort()[0]
    n = [200] * len(cfgs)
    engine = UnifiedEngine(VGGFamily(), cfgs, n, agg_mode="coverage",
                           device=dev)
    spec = engine.plane_spec
    gp = engine.init_global(torch.Generator().manual_seed(0))
    ks = list(range(len(cfgs)))
    seeds = [engine._round_seed(0, k) for k in ks]

    def tree_of(rows):
        """A contiguous stacked tree from a (20, P) plane (then freed)."""
        out = tu.tree_map(lambda t: t.contiguous(),
                          plane.unpack_stacked(rows, spec))
        del rows
        return out

    stacked = tree_of(engine._round_start_width(gp, None, 0))
    masks = tree_of(torch.stack([engine._client_cov_row(k, s)
                                 for k, s in zip(ks, seeds)]))
    mult = tree_of(torch.stack([engine._client_mult_row(k, s)
                                for k, s in zip(ks, seeds)]))
    del engine
    free_device()
    w = agg.subset_weights(n)
    scale = max(float(t.abs().max()) for t in tu.leaves(stacked)) * \
        float(np.abs(w).sum())
    launches = dict.fromkeys(fk.KERNELS, 0)
    modes = (("unmasked", {}, "weighted_sum"),
             ("masks", dict(masks=masks), "weighted_sum_masked"),
             ("masks,mult,fb", dict(masks=masks, mult=mult, fallback=gp),
              "weighted_sum_masked_mult"))
    info = {"P": spec.size, "leaves": spec.n_leaves, "layouts": {}}
    for mode, kw, leaf_kernel in modes:
        outs = {}
        for layout in ("plane", "stream", "leaf"):
            fk.reset_launch_counts()
            out, t, peak = _synced(lambda: agg.fedavg_stacked(
                stacked, w, layout=layout, **kw))
            counts = fk.launch_counts()
            for k, v in counts.items():
                launches[k] += v
            outs[layout] = out
            info["layouts"][f"{mode}/{layout}"] = {
                "s": t, "peak_bytes": peak, "launches": counts,
                "stats": agg.last_agg_stats()}
            print(f"  fedavg_stacked {mode:14s} {layout:6s} {t:.4f} s "
                  f"peak {peak / 1e9:.2f} GB launches "
                  f"{ {k: v for k, v in counts.items() if v} }")
        check(info["layouts"][f"{mode}/leaf"]["launches"][leaf_kernel]
              == spec.n_leaves,
              f"leaf layout ({mode}) did not launch {leaf_kernel} once per "
              f"leaf")
        for layout in ("stream", "leaf"):
            diff = max(float((a.float() - b.float()).abs().max())
                       for a, b in zip(tu.leaves(outs["plane"]),
                                       tu.leaves(outs[layout])))
            info["layouts"][f"{mode}/{layout}"]["vs_plane"] = diff
            print(f"  fedavg_stacked {mode:14s} {layout} vs plane: "
                  f"max |diff| {diff:.3e} (tol {TOL * scale:.3e})")
            check(diff <= TOL * scale,
                  f"fedavg_stacked {mode} {layout} != plane: {diff}")
        check(all(bool(torch.isfinite(t).all())
                  for t in tu.leaves(outs["plane"])),
              f"fedavg_stacked {mode}: non-finite")
        del outs, out
        free_device()
    print(json.dumps({"fedavg_stacked": info}))
    del stacked, masks, mult, gp
    free_device()
    return launches


# ------------------------------------------------------------ flash
def finite_scale(t) -> float:
    """The largest finite |value| (rows that see no key carry lse =
    -1e30 and are held exactly instead), at least 1."""
    a = t.abs()
    a = a[a < 1e29]
    return max(1.0, float(a.max())) if a.numel() else 1.0


def flash_case(dev, gen, errs, tag, *, B, KV, G, Sq, Sk, hd, causal=True,
               window=0, qp=None, kp=None):
    """Kernels vs plain versions on one shape; returns the operands."""
    from repro_torch.kernels.flash_attention import flash as ff
    from repro_torch.kernels.flash_attention import ref as fref

    if qp is None:
        qp = torch.arange(Sq, dtype=torch.int32, device=dev)
    if kp is None:
        kp = torch.arange(Sk, dtype=torch.int32, device=dev)
    q = torch.randn(B, KV, G, Sq, hd, generator=gen, device=dev)
    k = torch.randn(B, Sk, KV, hd, generator=gen, device=dev)
    v = torch.randn(B, Sk, KV, hd, generator=gen, device=dev)
    dout = torch.randn(B, KV, G, Sq, hd, generator=gen, device=dev)
    kw = dict(causal=causal, window=window)
    out, lse = ff.flash_fwd(q, k, v, qp, kp, **kw)
    delta = (dout * out).sum(-1)
    dq = ff.flash_bwd_dq(q, k, v, qp, kp, lse, delta, dout, **kw)
    dk, dv = ff.flash_bwd_dkv(q, k, v, qp, kp, lse, delta, dout, **kw)
    torch.cuda.synchronize()
    bk = 128 if Sk % 128 == 0 else Sk
    w_out, w_lse = fref.flash_fwd_ref(q, k, v, qp, kp, block_kv=bk, **kw)
    w_dq, w_dk, w_dv = fref.flash_bwd_ref(q, k, v, qp, kp, w_out, w_lse,
                                          dout, block_kv=bk, **kw)
    for name, got, want, what in (
            ("flash_fwd", out, w_out, "out"), ("flash_fwd", lse, w_lse, "lse"),
            ("flash_bwd_dq", dq, w_dq, "dq"), ("flash_bwd_dkv", dk, w_dk, "dk"),
            ("flash_bwd_dkv", dv, w_dv, "dv")):
        errs.hold(name, got, want, finite_scale(want), f"{tag} {what}",
                  FLASH_TOL)
    dead = w_lse <= -1e29                 # rows that see no key
    check(bool((lse[dead] == w_lse[dead]).all()),
          f"{tag}: lse of rows that see no key differs")
    print(f"  {'':12s} {tag}: {int(dead.sum())} (row, head) entries see "
          f"no key")
    return q, k, v, dout, qp, kp, out, lse, delta


def flash_kernel_phase(dev, errs: Errors):
    """The flash kernels vs their plain versions in every case; times at
    the transformer main path's shapes."""
    from repro_torch.kernels.flash_attention import flash as ff
    from repro_torch.kernels.flash_attention import ref as fref

    for line in ptxas_lines("flash_attention", "flash_"):
        print(f"  ptxas {line}")
    gen = torch.Generator(device=dev).manual_seed(1)
    m = FLASH_MAIN
    # -- the corners first, the main shapes last (kept for the timings)
    pad = torch.arange(1024, dtype=torch.int32, device=dev)
    pad[1000:] = -1                       # S = 1000 block-padded to 1024
    flash_case(dev, gen, errs, "S=1000 padded to 1024", B=2, KV=2, G=16,
               Sq=1024, Sk=1024, hd=128, qp=pad, kp=pad)
    flash_case(dev, gen, errs, "window=256", B=2, KV=2, G=16, Sq=2048,
               Sk=2048, hd=128, window=256)
    flash_case(dev, gen, errs, "KV=4 G=1", B=2, KV=4, G=1, Sq=2048, Sk=2048,
               hd=128)
    dead_q = torch.arange(1024, dtype=torch.int32, device=dev)
    dead_q[100:228] = -1                  # query rows that see no key
    dead_k = torch.arange(1024, dtype=torch.int32, device=dev)
    dead_k[:3] = -1
    flash_case(dev, gen, errs, "rows with no key", B=1, KV=2, G=16,
               Sq=1024, Sk=1024, hd=128, qp=dead_q, kp=dead_k)
    torch.cuda.empty_cache()
    q, k, v, dout, qp, kp, out, lse, delta = flash_case(
        dev, gen, errs, "main B=8 KV=2 G=16 S=2048", B=m["B"], KV=m["KV"],
        G=m["G"], Sq=m["S"], Sk=m["S"], hd=m["hd"])

    # -- the backward sums in one fixed order: two launches are bit-equal
    args = (q, k, v, qp, kp, lse, delta, dout)
    first = (ff.flash_bwd_dq(*args), *ff.flash_bwd_dkv(*args))
    second = (ff.flash_bwd_dq(*args), *ff.flash_bwd_dkv(*args))
    torch.cuda.synchronize()
    for what, x, y in zip(("dq", "dk", "dv"), first, second):
        check(torch.equal(x, y), f"two backward launches differ in {what}")
    print("  flash_bwd_dq, flash_bwd_dkv: two launches bit-equal (dq, dk, "
          "dv)")
    first = ff.flash_fwd(q, k, v, qp, kp)
    second = ff.flash_fwd(q, k, v, qp, kp)
    torch.cuda.synchronize()
    for what, x, y in zip(("out", "lse"), first, second):
        check(torch.equal(x, y), f"two forward launches differ in {what}")
    print("  flash_fwd: two launches bit-equal (out, lse)")
    del first, second

    # -- times at the main shapes: kernel, plain version, bound, library
    B, KV, G, S, hd = m["B"], m["KV"], m["G"], m["S"], m["hd"]
    H = KV * G
    pairs = int(fref._block_mask(qp, kp, True, 0).sum()) * B * H
    f32 = 4
    qb, kb, rowb = B * H * S * hd * f32, B * KV * S * hd * f32, B * H * S * f32
    posb = 2 * S * 4
    work = {   # (bytes moved, products of hd-long dot products per pair)
        "flash_fwd": (2 * qb + 2 * kb + rowb + posb, 2),
        "flash_bwd_dq": (3 * qb + 2 * kb + 2 * rowb + posb, 3),
        "flash_bwd_dkv": (2 * qb + 4 * kb + 2 * rowb + posb, 4)}
    qh = q.reshape(B, H, S, hd)            # head h = kv * G + g: SDPA's GQA
    kh = k.permute(0, 2, 1, 3).contiguous()
    vh = v.permute(0, 2, 1, 3).contiguous()
    doh = dout.reshape(B, H, S, hd)
    qg, kg, vg = (t.clone().requires_grad_() for t in (qh, kh, vh))
    oh, took = sdpa_ops(lambda: F.scaled_dot_product_attention(
        qg, kg, vg, is_causal=True, enable_gqa=True))
    print(f"  SDPA f32 GQA call (enable_gqa=True) took: {took}")
    sdpa_err = float((oh.detach() - out.reshape(B, H, S, hd)).abs().max())
    print(f"  SDPA forward vs flash_fwd: max |diff| {sdpa_err:.3e}")
    # PyTorch's own split-TF32 f32 attention: the memory-efficient backend
    # on k and v repeated over the G query heads of each group
    qe, ke, ve = (t.detach().clone().requires_grad_() for t in
                  (qh, kh.repeat_interleave(G, 1), vh.repeat_interleave(G, 1)))
    oe = eff_bwd_ms = eff_fwd_ms = eff_err = eff_took = None
    try:
        oe, eff_took = sdpa_ops(lambda: efficient_sdpa(
            qe, ke, ve, is_causal=True))
        eff_err = float((oe.detach() - out.reshape(B, H, S, hd)).abs().max())
        with torch.no_grad():
            eff_fwd_ms = cuda_ms(lambda: efficient_sdpa(
                qe, ke, ve, is_causal=True), reps=5)
        eff_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
            oe, (qe, ke, ve), doh, retain_graph=True), reps=5)
        print(f"  SDPA efficient backend, heads expanded to {H} (took "
              f"{eff_took}): forward vs flash_fwd max |diff| {eff_err:.3e}; "
              f"forward {eff_fwd_ms:.4f} ms, backward {eff_bwd_ms:.4f} ms")
    except RuntimeError as e:
        print(f"  SDPA efficient backend refused the expanded heads: "
              f"{str(e).splitlines()[0]}")
    timers = {
        "flash_fwd": (lambda: ff.flash_fwd(q, k, v, qp, kp),
                      lambda: fref.flash_fwd_ref(q, k, v, qp, kp),
                      lambda: F.scaled_dot_product_attention(
                          qh, kh, vh, is_causal=True, enable_gqa=True)),
        "flash_bwd_dq": (lambda: ff.flash_bwd_dq(*args),
                         lambda: fref.flash_bwd_ref(q, k, v, qp, kp, out,
                                                    lse, dout),
                         lambda: torch.autograd.grad(oh, (qg, kg, vg), doh,
                                                     retain_graph=True)),
    }
    timers["flash_bwd_dkv"] = (lambda: ff.flash_bwd_dkv(*args),
                               *timers["flash_bwd_dq"][1:])
    rows = {}
    plain_cache = {}
    for name, (kern, plain, lib) in timers.items():
        nbytes, products = work[name]
        flops = 2 * hd * products * pairs
        ms = cuda_ms(kern, reps=5)
        # the two backward kernels share one plain version and one
        # library call (each computes dq, dk and dv together)
        key = id(plain) if name == "flash_fwd" else "bwd"
        if key not in plain_cache:
            plain_cache[key] = (cuda_ms(plain, reps=3), cuda_ms(lib, reps=5))
        plain_ms, lib_ms = plain_cache[key]
        rows[name] = {"ms": ms, "plain_ms": plain_ms,
                      **op_bounds(nbytes, flops, tensor_cores=True),
                      "library_ms": lib_ms, "bytes": nbytes, "flops": flops,
                      "tflops_per_s": flops / ms / 1e9}
        r = rows[name]
        print(f"  time {name:14s} kernel={ms:.4f} plain={plain_ms:.4f} "
              f"bound={r['bound_ms']:.4f} ms ({r['bound_by']}; FFMA "
              f"{r['bound_ffma_ms']:.4f} = {r['bound_ffma_ms'] / ms:.1%}, "
              f"3xTF32 {r['bound_3xtf32_ms']:.4f} = "
              f"{r['bound_3xtf32_ms'] / ms:.1%}) library={lib_ms:.4f} ms "
              f"{r['tflops_per_s']:.2f} TFLOP/s")
    bwd = rows["flash_bwd_dq"]["ms"] + rows["flash_bwd_dkv"]["ms"]
    print(f"  backward pair {bwd:.4f} ms; SDPA backward (GQA) "
          f"{rows['flash_bwd_dq']['library_ms']:.4f} ms; efficient backend "
          + (f"{eff_bwd_ms:.4f} ms" if eff_bwd_ms is not None else "refused"))
    print(f"  forward {rows['flash_fwd']['ms']:.4f} ms; SDPA forward (GQA, "
          f"{took}) {rows['flash_fwd']['library_ms']:.4f} ms; efficient "
          "backend " + (f"{eff_fwd_ms:.4f} ms" if eff_fwd_ms is not None
                        else "refused"))
    rows["flash_fwd"]["efficient_ms"] = eff_fwd_ms
    print(json.dumps({"flash_variants": rows, "shape": m,
                      "visible_pairs": pairs,
                      "f32_flops_per_s": F32_FLOPS_PER_S,
                      "tf32_flops_per_s": TF32_FLOPS_PER_S,
                      "sdpa_gqa_ops": took,
                      "sdpa_efficient_ops": eff_took,
                      "sdpa_efficient_fwd_ms": eff_fwd_ms,
                      "sdpa_efficient_bwd_ms": eff_bwd_ms,
                      "sdpa_efficient_fwd_err": eff_err}))
    del q, k, v, dout, out, lse, delta, qh, kh, vh, doh, qg, kg, vg, oh
    del qe, ke, ve, oe, timers, args
    torch.cuda.empty_cache()
    return rows


def ptxas_lines(name: str, kernel: str):
    """ptxas's registers, shared memory and spill lines of every instance
    of the kernel templates of ``csrc/<name>.cu`` whose names start with
    ``kernel``, each under its name and template arguments as the
    mangled name spells them (``Li128E`` an int 128, ``Lb1E`` true,
    ``f`` float, ``13__nv_bfloat16`` bf16): ``flash_fwd_kernel<128>``,
    ``swa_prefill_kernel<128, f32>``."""
    from repro_torch.kernels import build as kbuild

    words = {"f": "f32", "13__nv_bfloat16": "bf16"}
    out, cur = [], None
    for line in kbuild.ptxas_report(name).splitlines():
        if "Compiling entry function" in line:
            hit = re.search(r"\d(" + kernel + r"\w*?)I((?:L[ib]\d+E|f|"
                            r"13__nv_bfloat16)+)E", line)
            cur = None
            if hit:
                args = re.findall(r"L(i|b)(\d+)E|(f|13__nv_bfloat16)",
                                  hit.group(2))
                cur = (f"{hit.group(1)}<" + ", ".join(
                    words[t] if t else n if kind == "i" else
                    ("false", "true")[int(n)] for kind, n, t in args) + ">")
        elif cur and ("registers" in line or "spill" in line):
            out.append(f"{cur}: {line.split(':', 1)[-1].strip()}")
    return out


def sdpa_ops(fn):
    """Runs ``fn`` once; returns its result and the scaled-dot-product-
    attention ops it dispatched to: the backend PyTorch took."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, sorted({e.key for e in prof.key_averages()
                        if e.key.startswith("aten::_scaled_dot_product")
                        or e.key.startswith("aten::_efficient_attention")
                        or e.key.startswith("aten::_flash_attention")})


def efficient_sdpa(q, k, v, **kw):
    """PyTorch's memory-efficient attention backend (split-TF32 f32
    products, like the port's kernels) on heads already expanded."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
        return F.scaled_dot_product_attention(q, k, v, **kw)


# ------------------------------------------------------- transformer path
def tffn_cohort(t=TFFN):
    """A transformer cohort: K clients alternating ``t["arch"]`` at full
    and half FFN width (``benchmarks/unified_bench.py``'s
    ``_tffn_cohort`` at the published widths), cut to ``t["n_layers"]``
    layers and the 512-token seed vocabulary (or ``t["variants"]``, the
    clients' ``make_variant`` arguments, and ``t["vocab"]``); token data
    from ``default_rng(0)``. The main path's is glm4-9b's (``TFFN``)."""
    from repro_torch.configs import get_config
    from repro_torch.core import tfamily
    from repro_torch.data import ClientSampler, iid_partition
    from repro_torch.fl import FLRunConfig

    base = dataclasses.replace(get_config(t["arch"]),
                               n_layers=t["n_layers"], vocab_size=t["vocab"])
    cfgs = ([tfamily.make_variant(base, **kw) for kw in t["variants"]]
            if "variants" in t else
            [tfamily.make_variant(base, ffn_scale=0.5) if k % 2
             else tfamily.make_variant(base) for k in range(t["K"])])
    n = t["n_per_client"] * t["K"]
    rng = np.random.default_rng(0)
    toks = rng.integers(0, base.vocab_size,
                        size=(n, t["S"] + 1)).astype(np.int32)
    data = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    test = {"tokens": toks[:4, :-1], "labels": toks[:4, 1:]}
    parts = iid_partition(n, t["K"], seed=0)

    def samplers():
        return [ClientSampler(data, p, round_fraction=0.5,
                              batch_size=t["batch"], seed=i)
                for i, p in enumerate(parts)]

    def run_cfg(attn_backend, rounds, k_chunk=None, compute_dtype="f32"):
        return FLRunConfig(method="fedadp", rounds=rounds, local_epochs=1,
                           lr=0.05, momentum=0.0, seed=0, eval_every=1,
                           attn_backend=attn_backend, k_chunk=k_chunk,
                           compute_dtype=compute_dtype)

    return cfgs, samplers, test, run_cfg, data


def free_device():
    """Drop what the last run left: the run hooks make reference cycles
    (backend -> hook -> bound method -> backend), so collect them before
    returning the cached blocks."""
    gc.collect()
    torch.cuda.empty_cache()


def _synced(fn):
    """(fn(), seconds, peak bytes allocated while it ran)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def step_breakdown(engine, state, data, kernel_ms):
    """One local-training step of the whole cohort taken apart, each
    piece timed between synchronisations: the host build and upload of
    the E Eᵀ segment matrices, the round start, ``vmap(grad)`` (of which
    the flash kernels' share is launches x their kernel-phase time), the
    E Eᵀ projection, and pack + mask + SGD update, with the peak device
    memory of each."""
    from torch.func import vmap

    from repro_torch import tree as tu
    from repro_torch.core import plane
    from repro_torch.core import segments as sg
    from repro_torch.kernels.flash_attention import flash as ff

    K, b = TFFN["K"], TFFN["batch"]
    ks = list(range(K))
    seeds = [engine._round_seed(99, k) for k in ks]
    mats, t_seg_host, _ = _synced(
        lambda: [engine._client_seg(k, s) for k, s in zip(ks, seeds)])
    seg_mats, t_seg_copy, m_seg = _synced(
        lambda: sg.stack_matrices(mats, engine.device))
    del mats
    sp, t_start, m_start = _synced(
        lambda: engine._round_start_width(state, None, 99))
    masks = engine._mask_views(ks)
    bt = {key: torch.as_tensor(v[:K * b].reshape(K, b, -1),
                               device=engine.device)
          for key, v in data.items()}
    gf = engine.family.loss_and_grad(engine.global_cfg)
    grads_fn = vmap(lambda p, x: gf(p, x)[1])
    ff.reset_launch_counts()
    grads, t_grad, m_grad = _synced(
        lambda: grads_fn(plane.unpack_stacked(sp, engine.plane_spec), bt))
    launches = ff.launch_counts()
    proj, t_proj, m_proj = _synced(
        lambda: sg.project_stacked(grads, engine._seg_axes, seg_mats))
    del grads

    def pack_mask_update():
        gp = plane.pack_stacked(proj, engine.plane_spec)
        for row, m in zip(gp, masks):
            row.mul_(m)
        engine._opt.update(gp, {}, sp, 0)

    _, t_update, m_update = _synced(pack_mask_update)
    attn_s = sum(launches[k] * kernel_ms[k] for k in launches) / 1e3
    # E Eᵀ along each widened axis a of a leaf: a (U, U) matrix times
    # every fiber along a, per client
    proj_flops = 0
    for path, axes in engine._axes_map.items():
        shape = tuple(tu.get(engine._gshapes, path).shape)
        for a in axes:
            proj_flops += 2 * K * int(np.prod(shape)) * shape[a]
    # the dense stack's matmuls, forward (2) and backward (4) per weight
    # per token; attention's own products are the flash kernels'
    cfg = engine.global_cfg
    hd = cfg.resolved_head_dim
    weights = cfg.n_layers * (2 * cfg.d_model * cfg.n_heads * hd
                              + 2 * cfg.d_model * cfg.n_kv_heads * hd
                              + 3 * cfg.d_model * cfg.d_ff)
    weights += cfg.d_model * cfg.vocab_size
    matmul_flops = 6 * K * b * TFFN["S"] * weights
    info = {"seg_matrices_host_s": t_seg_host,
            "seg_matrices_upload_s": t_seg_copy,
            "seg_matrices_bytes": sum(
                int(m.numel()) * 4 for m in {id(m): m for ms in
                                             seg_mats.values()
                                             for m in ms}.values()),
            "round_start_s": t_start, "vmap_grad_s": t_grad,
            "flash_launches": launches, "flash_kernel_s": attn_s,
            "vmap_grad_other_s": t_grad - attn_s,
            "dense_matmul_flops": matmul_flops,
            "segment_projection_s": t_proj,
            "segment_projection_flops": proj_flops,
            "pack_mask_update_s": t_update,
            "peak_bytes": {"seg_upload": m_seg, "round_start": m_start,
                           "vmap_grad": m_grad, "projection": m_proj,
                           "pack_mask_update": m_update}}
    print(json.dumps({"step_breakdown": info}))
    del sp, masks, seg_mats, proj, bt
    torch.cuda.empty_cache()
    return info


def tffn_run(attn_backend, rounds, k_chunk=None, t=TFFN,
             compute_dtype="f32", on_init=None):
    """One Simulator run of a transformer cohort (``tffn_cohort(t)``);
    returns (result, info, launch counts, engine, data).
    ``on_init(state)`` sees the initial state."""
    from repro_torch import tree as tu
    from repro_torch.core import TransformerFamily
    from repro_torch.fl import Simulator
    from repro_torch.kernels.fedavg import fedavg as fk
    from repro_torch.kernels.flash_attention import flash as ff
    from repro_torch.kernels.netchange import widen as wk

    cfgs, samplers, test, run_cfg, data = tffn_cohort(t)
    rc = run_cfg(attn_backend, rounds, k_chunk, compute_dtype)
    fed = Simulator(TransformerFamily(), cfgs, samplers(), rc, test)._build()
    engine = fed.backend.engine
    engine.timing = True
    records = []
    fed.callbacks.append(records.append)
    if on_init is not None:
        init_state = fed.backend.init_state

        def seen(generator=None):
            state = init_state(generator)
            on_init(state)
            return state
        fed.backend.init_state = seen
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fk.reset_launch_counts()
    ff.reset_launch_counts()
    wk.reset_launch_counts()
    t0 = time.perf_counter()
    res = fed.run(torch.Generator().manual_seed(rc.seed))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {**ff.launch_counts(), **fk.launch_counts(),
              **wk.launch_counts()}
    steps = samplers()[0].steps_per_epoch() * rc.local_epochs
    round_walls = [records[0]["wall_s"]] + [
        b["wall_s"] - a["wall_s"] for a, b in zip(records, records[1:])]
    info = {"arch": t["arch"], "attn_backend": attn_backend,
            "compute_dtype": compute_dtype, "rounds": rounds,
            "steps_per_round": steps, "round_wall_s": round_walls,
            "run_wall_s": wall, "phase_stats": engine.phase_stats(),
            "agg_stats": engine.agg_stats(), "history": res["history"],
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "launches": counts, "P": engine.plane_spec.size,
            "cache_stats": engine.cache_stats()}
    print(json.dumps({"tffn_run": info}))
    gleaves = tu.leaves(res["global_params"])
    check(all(bool(torch.isfinite(x).all()) for x in gleaves),
          f"{attn_backend}: non-finite global params")
    check(len(res["history"]) == rounds
          and all(math.isfinite(a) for a in res["history"]),
          f"{attn_backend}: non-finite eval loss {res['history']}")
    return res, info, counts, engine, data


def tffn_main_path(kernel_ms):
    """The transformer cohort: 1 flash round (the launch counts must be
    one per layer per step for the whole cohort) and a step breakdown (a
    blockwise round held against it did not fit the script's time
    limit: the recurrentgemma and internvl2 cohorts hold theirs)."""
    t = TFFN
    res, info, counts, engine, data = tffn_run("auto", 1)
    L, K, rounds = t["n_layers"], t["K"], info["rounds"]
    steps = info["steps_per_round"]
    train = rounds * steps * L
    evals = len(info["history"]) * K * L  # one forward per client view
    check(counts["flash_bwd_dq"] == counts["flash_bwd_dkv"] == train,
          f"backward launches {counts} != {train} (rounds x steps x layers)")
    check(counts["flash_fwd"] == train + evals,
          f"forward launches {counts['flash_fwd']} != {train} + {evals}")
    check(counts["plane_accum"] == rounds,
          f"aggregation launches {counts}")
    check(info["agg_stats"]["layout"] == "stream",
          "agg_layout='auto' did not stream at full width")
    state = res["global_params"]
    del res
    free_device()
    breakdown = step_breakdown(engine, state, data, kernel_ms)
    del engine, state
    free_device()
    return counts, {"flash": info, "breakdown": breakdown}


def profile_rounds():
    """One warm round per layout under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.core import VGGFamily
    from repro_torch.fl import Simulator

    cfgs, samplers, test, run_cfg = paper_cohort()
    selected = list(range(len(cfgs)))
    for layout, agg_mode in (("auto", "filler"), ("plane", "coverage")):
        fed = Simulator(VGGFamily(), cfgs, samplers(),
                        run_cfg(layout, agg_mode, 2), test)._build()
        backend, engine = fed.backend, fed.backend.engine
        engine.timing = True
        state = backend.init_state(torch.Generator().manual_seed(0))
        state = backend.run_round(state, 0, selected)       # warm-up round
        torch.cuda.synchronize()
        engine.phase_stats(reset=True)
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with record_function("fedadp_round"):
                state = backend.run_round(state, 1, selected)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = prof.events()
        window = next(e.time_range for e in events
                      if e.name == "fedadp_round"
                      and e.device_type == DeviceType.CPU)
        # device activity: kernels, copies and sets — not the annotation's
        # own device-side span, which covers the whole window; an event
        # listed twice (same name and interval) counts once
        device = [e for e in events if e.device_type == DeviceType.CUDA
                  and e.name != "fedadp_round"
                  and not getattr(e, "is_user_annotation", False)]
        unique = {(e.name, e.time_range.start, e.time_range.end)
                  for e in device}
        spans = sorted((lo, hi) for _, lo, hi in unique)
        by_name = {}
        for name, lo, hi in unique:
            n_us = by_name.setdefault(name, [0, 0.0])
            n_us[0] += 1
            n_us[1] += hi - lo
        busy_us, cur_lo, cur_hi = 0.0, None, None
        for lo, hi in spans:                 # union of device intervals
            lo, hi = max(lo, window.start), min(hi, window.end)
            if hi <= lo:
                continue
            if cur_hi is None or lo > cur_hi:
                if cur_hi is not None:
                    busy_us += cur_hi - cur_lo
                cur_lo, cur_hi = lo, hi
            else:
                cur_hi = max(cur_hi, hi)
        if cur_hi is not None:
            busy_us += cur_hi - cur_lo
        window_us = window.end - window.start
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
        print(json.dumps({"profile": {
            "agg_layout": layout, "agg_mode": agg_mode,
            "resolved_layout": engine.agg_stats()["layout"],
            "round_wall_s": wall, "train_s": engine.phase_stats()["train"],
            "window_s": window_us / 1e6,
            "device_events": len(device), "unique_device_events": len(unique),
            "device_event_s": sum(hi - lo for lo, hi in spans) / 1e6,
            "device_busy_s": busy_us / 1e6,
            "device_busy_share": busy_us / window_us,
            "device_span_s": (spans[-1][1] - spans[0][0]) / 1e6,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "top": [{"name": name[:100], "count": c, "device_ms": us / 1e3}
                    for name, (c, us) in top[:25]]}}))
        del fed, backend, engine, state, prof
        torch.cuda.empty_cache()


# ------------------------------------------------------ serving kernels
def decode_case(dev, gen, errs, tag, *, B, KV, G, hd, S, window, q_pos,
                kind="iota", dtype=torch.float32):
    """swa_decode vs its plain version on one cache; returns the
    operands. ``kind``: "iota" slots at positions 0..S-1, "ring" a ring
    of S slots after writing ``q_pos``, "late" every slot after q_pos
    (no slot visible), "zeros" every slot at position 0 (a cross
    cache)."""
    from repro_torch.kernels.swa_attention import ref as sref
    from repro_torch.kernels.swa_attention import swa as sk
    from repro_torch.models.attention import ring_positions

    q = torch.randn(B, KV, G, hd, generator=gen, device=dev)
    k = torch.randn(B, S, KV, hd, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, S, KV, hd, generator=gen, device=dev).to(dtype)
    kp = torch.arange(S, dtype=torch.int32, device=dev)
    if kind == "ring":
        kp = ring_positions(q_pos, S, device=dev).to(torch.int32)
    elif kind == "late":
        kp = kp + q_pos + 1
    elif kind == "zeros":
        kp = torch.zeros_like(kp)
    got = sk.swa_decode(q, k, v, kp, q_pos, window=window)
    want = sref.decode_ref(q, k, v, kp, q_pos, window=window)
    errs.hold("swa_decode", got, want, finite_scale(want), tag, FLASH_TOL)
    if kind == "late":           # the reference's answer: the mean of v
        mean_v = v.float().mean(1)[:, :, None].expand_as(got)
        errs.hold("swa_decode", got, mean_v, finite_scale(mean_v),
                  tag + " == mean of v", FLASH_TOL)
    return q, k, v, kp


def band_pairs(S, window):
    """Visible (query, key) pairs of causal attention over S positions
    with a window (0 = none)."""
    return sum(min(i + 1, window) if window else i + 1 for i in range(S))


def swa_kernel_phase(dev, errs: Errors):
    """swa_decode and swa_prefill vs their plain versions in every case;
    times at the serve path's shapes (and the JAX benchmark's decode
    shape), beside SDPA with the same mask and, for prefill, flash_fwd
    with the same window."""
    from repro_torch.kernels.flash_attention import flash as ff
    from repro_torch.kernels.swa_attention import ops as sops
    from repro_torch.kernels.swa_attention import ref as sref
    from repro_torch.kernels.swa_attention import swa as sk

    for line in ptxas_lines("swa_attention", "swa_prefill"):
        print(f"  ptxas {line}")
    for line in ptxas_lines("swa_attention", "swa_decode"):
        if "<128," in line:              # the serve path's head dim
            print(f"  ptxas {line}")
    gen = torch.Generator(device=dev).manual_seed(2)
    s, geo = SERVE, SERVE_GEOM
    B, KV, G, hd, W = (s["batch"], geo["KV"], geo["G"], geo["hd"],
                       geo["window"])
    L, H = s["prompt_len"] + s["gen"], KV * G
    last = L - 1
    rows = {}

    # -- decode: the corners first
    decode_case(dev, gen, errs, f"ring W={W} q_pos=37 (partly written)",
                B=B, KV=KV, G=G, hd=hd, S=W, window=W, q_pos=37, kind="ring")
    decode_case(dev, gen, errs, "bf16 k/v ring wrapped", B=B, KV=KV, G=G,
                hd=hd, S=W, window=W, q_pos=last, kind="ring",
                dtype=torch.bfloat16)
    decode_case(dev, gen, errs, "odd S=3001 window=500", B=2, KV=4, G=2,
                hd=hd, S=3001, window=500, q_pos=2999)
    decode_case(dev, gen, errs, "no visible slot", B=2, KV=4, G=2, hd=hd,
                S=777, window=0, q_pos=40, kind="late")

    def decode_row(name, q, k, v, kp, q_pos, window):
        Bq, KVq, Gq, hdq = q.shape
        Hq = KVq * Gq
        valid = (kp >= 0) & (kp <= q_pos)
        if window > 0:
            valid = valid & (q_pos - kp < window)
        n_vis = int(valid.sum())
        nbytes = (2 * Bq * n_vis * KVq * hdq * k.element_size()
                  + kp.numel() * 4 + 2 * q.numel() * 4)
        flops = 4 * Bq * Hq * hdq * n_vis
        qh, q3 = q.reshape(Bq, Hq, 1, hdq), q.reshape(Bq, Hq, hdq)
        kh, vh = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
        mask = valid.view(1, 1, 1, -1)
        time_row(rows, name,
                 lambda: sk.swa_decode(q, k, v, kp, q_pos, window=window),
                 lambda: sops.decode_attention(q3, k, v, kp, q_pos,
                                               window=window),
                 lambda: sref.decode_ref(q, k, v, kp, q_pos, window=window),
                 nbytes, flops,
                 lambda: F.scaled_dot_product_attention(
                     qh, kh, vh, attn_mask=mask, enable_gqa=True),
                 card=with_copies(lambda kk, vv: sk.swa_decode(
                     q, kk, vv, kp, q_pos, window=window), k, v))
        rows[name]["visible_slots"] = n_vis

    # -- decode at the serve shapes and the JAX benchmark's
    args = decode_case(dev, gen, errs, f"serve local: ring W={W} wrapped",
                       B=B, KV=KV, G=G, hd=hd, S=W, window=W, q_pos=last,
                       kind="ring")
    decode_row(f"swa_decode serve local W={W}", *args, last, W)
    args = decode_case(dev, gen, errs, f"serve global: S={L} window=0",
                       B=B, KV=KV, G=G, hd=hd, S=L, window=0, q_pos=last)
    decode_row(f"swa_decode serve global S={L}", *args, last, 0)
    bb = DECODE_BENCH
    args = decode_case(dev, gen, errs, f"benchmark {bb}", B=bb["B"],
                       KV=bb["KV"], G=bb["G"], hd=bb["hd"], S=bb["S"],
                       window=bb["window"], q_pos=bb["S"] - 1)
    decode_row(f"swa_decode benchmark S={bb['S']} w={bb['window']}", *args,
               bb["S"] - 1, bb["window"])
    del args
    torch.cuda.empty_cache()

    # -- prefill: the JAX tests' cases, an odd S, bf16, the refusal
    def prefill_case(tag, *, B, KV, G, S, hd, window, causal=True,
                     dtype=torch.float32):
        q = torch.randn(B, KV, G, S, hd, generator=gen, device=dev).to(dtype)
        k = torch.randn(B, S, KV, hd, generator=gen, device=dev).to(dtype)
        v = torch.randn(B, S, KV, hd, generator=gen, device=dev).to(dtype)
        got = sk.swa_prefill(q, k, v, window=window, causal=causal)
        want = sref.prefill_ref(q, k, v, window=window, causal=causal)
        errs.hold("swa_prefill", got, want, finite_scale(want), tag,
                  FLASH_TOL)
        return q, k, v, got

    for dims in ((1, 2, 2, 256, 32, 64), (2, 1, 4, 512, 64, 128),
                 (1, 2, 1, 256, 32, 0), (1, 1, 2, 128, 16, 16)):
        b_, kv_, g_, s_, hd_, w_ = dims
        prefill_case(f"JAX test case {dims}", B=b_, KV=kv_, G=g_, S=s_,
                     hd=hd_, window=w_)
    prefill_case("odd S=1001 window=300", B=2, KV=4, G=2, S=1001, hd=hd,
                 window=300)
    prefill_case(f"bf16 S={2 * W} window={W}", B=1, KV=KV, G=G, S=2 * W,
                 hd=hd, window=W, dtype=torch.bfloat16)
    prefill_case("bidirectional S=300", B=1, KV=2, G=2, S=300, hd=64,
                 window=0, causal=False)
    try:
        sops.swa_prefill(*[torch.zeros(1, 1, 1, 64, 16, device=dev)],
                         torch.zeros(1, 64, 1, 16, device=dev),
                         torch.zeros(1, 64, 1, 16, device=dev), window=8,
                         causal=False)
        raise AssertionError("swa_prefill(causal=False, window>0) ran")
    except ValueError as e:
        check("not defined" in str(e), f"wrong refusal: {e}")
        print("  swa_prefill  causal=False window>0 refused (ValueError)")
    torch.cuda.empty_cache()

    # -- prefill at the serve shape: kernel, plain, SDPA, and flash_fwd
    S = s["prompt_len"]
    q, k, v, out = prefill_case(f"serve B={B} KV={KV} G={G} S={S} w={W}",
                                B=B, KV=KV, G=G, S=S, hd=hd, window=W)
    torch.cuda.empty_cache()
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    f_out, _ = ff.flash_fwd(q, k, v, pos, pos, causal=True, window=W)
    errs.hold("swa_prefill", out, f_out, finite_scale(f_out),
              "serve shape == flash_fwd with the window", FLASH_TOL)
    del out, f_out
    pairs = band_pairs(S, W)
    nbytes = (3 * B * H * S * hd + 2 * B * S * KV * hd) * 4
    flops = 4 * B * H * hd * pairs
    qh = q.reshape(B, H, S, hd)
    kh, vh = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    band = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < W)
    name = f"swa_prefill serve S={S} w={W}"
    sdpa_band = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qh, kh, vh, attn_mask=band, enable_gqa=True)
    time_row(rows, name,
             lambda: sk.swa_prefill(q, k, v, window=W),
             lambda: sops.swa_prefill(q, k, v, window=W),
             lambda: sref.prefill_ref(q, k, v, window=W),
             nbytes, flops, sdpa_band, tensor_cores=True)
    r = rows[name]
    r["library_ops"] = sdpa_ops(sdpa_band)[1]
    r["flash_fwd_same_window_ms"] = cuda_ms(
        lambda: ff.flash_fwd(q, k, v, pos, pos, causal=True, window=W),
        reps=5)
    r["visible_pairs"] = pairs
    print(f"  SDPA band mask (GQA) took {r['library_ops']}; flash_fwd on "
          f"the same inputs and window: {r['flash_fwd_same_window_ms']:.4f} "
          f"ms (swa_prefill {r['ms']:.4f} ms)")
    r["efficient_ms"] = r["efficient_ops"] = None
    ke, ve = kh.repeat_interleave(G, 1), vh.repeat_interleave(G, 1)
    try:
        r["efficient_ops"] = sdpa_ops(lambda: efficient_sdpa(
            qh, ke, ve, attn_mask=band))[1]
        r["efficient_ms"] = cuda_ms(lambda: efficient_sdpa(
            qh, ke, ve, attn_mask=band), reps=5)
        print(f"  SDPA efficient backend, heads expanded to {H}, band mask "
              f"(took {r['efficient_ops']}): {r['efficient_ms']:.4f} ms")
    except RuntimeError as e:
        print(f"  SDPA efficient backend refused the band mask: "
              f"{str(e).splitlines()[0]}")
    del ke, ve, q, k, v, qh, kh, vh, band
    torch.cuda.empty_cache()
    rows.update(flash_serve_global(dev, gen, errs))
    rows.update(lse_decode_rows(dev, gen, errs))
    print(json.dumps({"swa_variants": rows}))
    return rows


# swa_decode with its log-sum-exp (``return_lse``: the sequence-split
# decode cache's parts), each case whole and as the two halves of its
# slots merged by it (``collectives.merge_parts``) against the whole
# cache's launch: long_500k's geometry (INPUT_SHAPES["long_500k"], batch
# 1 over 524,288 slots) at gemma3-27b's global layer (KV 16 x G 2, hd
# 128: 8.59 GB of f32 k and v, 4.29 GB a half), a gemma3 local ring of
# 1024 wrapped past its window, partly written (half 1 partly masked)
# and written only in half 0 (half 1 sees no slot), whisper-small's
# self cache at the card path's batch 1 (420 slots, 210 a data rank; KV
# 12 at model 1, 6 at model 2). ``time``: which launches are timed.
# (B, KV, G, hd, S, window, q_pos, key_pos kind, time)
LSE_DECODE = {
    "long_500k gemma3 global": (1, 16, 2, 128, 524288, 0, 524287, "iota",
                                ("whole", "half")),
    "gemma3 local W=1024 wrapped": (1, 16, 2, 128, 1024, 1024, 1500, "ring",
                                    ("half",)),
    "gemma3 local W=1024 partly written": (1, 16, 2, 128, 1024, 1024, 700,
                                           "ring", ()),
    "gemma3 local W=1024 half 1 unwritten": (1, 16, 2, 128, 1024, 1024, 300,
                                             "ring", ()),
    "whisper self KV=12": (1, 12, 1, 64, 420, 0, 419, "iota", ("half",)),
    "whisper self KV=6": (1, 6, 1, 64, 420, 0, 419, "iota", ("half",)),
}
LSE_TOL = 1e-6          # relative: the kernel's lse vs the plain version's
LSE_ERR = {"max_rel": 0.0}


def hold_lse(tag, got, want):
    """The kernel's log-sum-exp against ``want``: -inf at the same heads,
    elsewhere within ``LSE_TOL`` relative."""
    empty = torch.isneginf(want)
    check(torch.equal(torch.isneginf(got), empty),
          f"swa_decode lse {tag}: -inf at other heads than the plain one")
    seen = ~empty
    rel = (float(((got - want).abs() / want.abs())[seen].max())
           if bool(seen.any()) else 0.0)
    print(f"  swa_decode   lse {tag:40s} max_rel_err={rel:.3e} "
          f"tol={LSE_TOL:.0e} ({int(empty.sum())} of {empty.numel()} heads "
          f"see no slot)")
    check(rel <= LSE_TOL, f"swa_decode lse {tag}: relative error {rel}")
    LSE_ERR["max_rel"] = max(LSE_ERR["max_rel"], rel)


def lse_library(q, k, v):
    """One PyTorch call that returns attention and its log-sum-exp: the
    memory-efficient backend's op with ``compute_log_sumexp``, on the kv
    heads repeated to the query heads (made here, outside the timing);
    None where it refuses. q (B, KV, G, hd); k, v (B, S, KV, hd), every
    slot visible."""
    B, KV, G, hd = q.shape
    qh = q.reshape(B, KV * G, 1, hd)
    kh = k.permute(0, 2, 1, 3).repeat_interleave(G, 1)
    vh = v.permute(0, 2, 1, 3).repeat_interleave(G, 1)

    def fn():
        return torch.ops.aten._scaled_dot_product_efficient_attention(
            qh, kh, vh, None, True)
    try:
        fn()
        return fn
    except RuntimeError as e:
        print(f"  the memory-efficient backend refused: "
              f"{str(e).splitlines()[0]}")
        return None


def lse_decode_row(rows, name, q, k, v, kp, q_pos, window):
    """Time ``swa_decode(..., return_lse=True)`` as ``decode_row`` times
    it: the bound is the visible slots' k and v bytes (and key_pos, q,
    out and lse) over the card's memory rate."""
    from repro_torch.kernels.swa_attention import ops as sops
    from repro_torch.kernels.swa_attention import ref as sref
    from repro_torch.kernels.swa_attention import swa as sk

    B, KV, G, hd = q.shape
    valid = (kp >= 0) & (kp <= q_pos)
    if window > 0:
        valid = valid & (q_pos - kp < window)
    n_vis = int(valid.sum())
    nbytes = (2 * B * n_vis * KV * hd * k.element_size() + kp.numel() * 4
              + 2 * q.numel() * 4 + B * KV * G * 4)
    q3 = q.reshape(B, KV * G, hd)
    library = lse_library(q, k, v) if n_vis == kp.numel() else None
    time_row(rows, name,
             lambda: sk.swa_decode(q, k, v, kp, q_pos, window=window,
                                   return_lse=True),
             lambda: sops.decode_attention(q3, k, v, kp, q_pos,
                                           window=window, return_lse=True),
             lambda: sref.decode_ref(q, k, v, kp, q_pos, window=window,
                                     return_lse=True),
             nbytes, 4 * B * KV * G * hd * n_vis, library,
             card=with_copies(lambda kk, vv: sk.swa_decode(
                 q, kk, vv, kp, q_pos, window=window, return_lse=True),
                 k, v))
    rows[name]["visible_slots"] = n_vis
    del library
    free_device()


def lse_decode_rows(dev, gen, errs: Errors):
    """``LSE_DECODE``: each case's kernel (out and lse) against its plain
    version, whole and a half at a time, the halves merged against the
    whole cache's launch, and the ``time`` launches timed."""
    from repro_torch.kernels.swa_attention import ref as sref
    from repro_torch.kernels.swa_attention import swa as sk
    from repro_torch.models.attention import ring_positions
    from repro_torch.sharding.collectives import merge_parts

    rows = {}
    for name, (B, KV, G, hd, S, window, q_pos, kind,
               timed) in LSE_DECODE.items():
        q = torch.randn(B, KV, G, hd, generator=gen, device=dev)
        k = torch.randn(B, S, KV, hd, generator=gen, device=dev)
        v = torch.randn(B, S, KV, hd, generator=gen, device=dev)
        kp = (ring_positions(q_pos, S, device=dev) if kind == "ring"
              else torch.arange(S, device=dev)).to(torch.int32)
        h = S // 2
        # B = 1: a block of slots is a contiguous view of the cache, on
        # the kernel's 16-byte alignment (a row is KV x hd x 4 bytes);
        # key_pos's block is copied, as a view of it may start off it
        halves = [(k[:, i * h:(i + 1) * h], v[:, i * h:(i + 1) * h],
                   kp[i * h:(i + 1) * h].clone()) for i in range(2)]
        out, lse = sk.swa_decode(q, k, v, kp, q_pos, window=window,
                                 return_lse=True)
        want, want_lse = sref.decode_ref(q, k, v, kp, q_pos, window=window,
                                         return_lse=True)
        errs.hold("swa_decode", out, want, finite_scale(want),
                  f"lse {name} whole", FLASH_TOL)
        hold_lse(f"{name} whole", lse, want_lse)
        del want, want_lse
        parts = []
        for i, (kk, vv, pp) in enumerate(halves):
            o, l_ = sk.swa_decode(q, kk, vv, pp, q_pos, window=window,
                                  return_lse=True)
            want, want_lse = sref.decode_ref(q, kk, vv, pp, q_pos,
                                             window=window, return_lse=True)
            errs.hold("swa_decode", o, want, finite_scale(want),
                      f"lse {name} half {i}", FLASH_TOL)
            hold_lse(f"{name} half {i}", l_, want_lse)
            parts.append((o, l_))
            del want, want_lse
        merged = merge_parts(torch.stack([o for o, _ in parts]),
                             torch.stack([l_ for _, l_ in parts]))
        errs.hold("swa_decode", merged, out, finite_scale(out),
                  f"lse {name} halves merged == whole", FLASH_TOL)
        hold_lse(f"{name} halves merged", torch.logsumexp(
            torch.stack([l_ for _, l_ in parts]), 0), lse)
        del out, lse, parts, merged
        if "whole" in timed:
            lse_decode_row(rows, f"swa_decode lse {name} whole S={S}", q, k,
                           v, kp, q_pos, window)
        if "half" in timed:
            lse_decode_row(rows, f"swa_decode lse {name} half S={h}", q,
                           *halves[1], q_pos, window)
        del q, k, v, kp, halves
        free_device()
    return rows


def flash_serve_global(dev, gen, errs: Errors):
    """flash_fwd at the serve path's global-layer shape (causal over the
    whole prompt): held against its plain version and timed beside it,
    its bound, SDPA (GQA) and the memory-efficient backend on heads
    expanded to KV * G."""
    from repro_torch.kernels.flash_attention import flash as ff
    from repro_torch.kernels.flash_attention import ref as fref

    geo = SERVE_GEOM
    B, KV, G, hd = SERVE["batch"], geo["KV"], geo["G"], geo["hd"]
    S, H = SERVE["prompt_len"], geo["KV"] * geo["G"]
    q = torch.randn(B, KV, G, S, hd, generator=gen, device=dev)
    k = torch.randn(B, S, KV, hd, generator=gen, device=dev)
    v = torch.randn(B, S, KV, hd, generator=gen, device=dev)
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    out, lse = ff.flash_fwd(q, k, v, pos, pos)
    bk = 128 if S % 128 == 0 else S
    w_out, w_lse = fref.flash_fwd_ref(q, k, v, pos, pos, block_kv=bk)
    tag = f"serve global B={B} KV={KV} G={G} S={S}"
    errs.hold("flash_fwd", out, w_out, finite_scale(w_out), f"{tag} out",
              FLASH_TOL)
    errs.hold("flash_fwd", lse, w_lse, finite_scale(w_lse), f"{tag} lse",
              FLASH_TOL)
    del out, lse, w_out, w_lse
    pairs = band_pairs(S, 0)
    nbytes = (2 * B * H * S * hd + 2 * B * S * KV * hd + B * H * S) * 4 \
        + 2 * S * 4
    qh = q.reshape(B, H, S, hd)
    kh, vh = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qh, kh, vh, is_causal=True, enable_gqa=True)
    rows = {}
    name = f"flash_fwd {tag}"
    time_row(rows, name, lambda: ff.flash_fwd(q, k, v, pos, pos),
             lambda: ff.flash_fwd(q, k, v, pos, pos),
             lambda: fref.flash_fwd_ref(q, k, v, pos, pos, block_kv=bk),
             nbytes, 4 * B * H * hd * pairs, sdpa, tensor_cores=True)
    r = rows[name]
    r["library_ops"] = sdpa_ops(sdpa)[1]
    ke, ve = kh.repeat_interleave(G, 1), vh.repeat_interleave(G, 1)
    r["efficient_ops"] = sdpa_ops(lambda: efficient_sdpa(
        qh, ke, ve, is_causal=True))[1]
    r["efficient_ms"] = cuda_ms(lambda: efficient_sdpa(
        qh, ke, ve, is_causal=True), reps=5)
    print(f"  SDPA (GQA) took {r['library_ops']}; efficient backend, heads "
          f"expanded to {H} (took {r['efficient_ops']}): "
          f"{r['efficient_ms']:.4f} ms")
    del q, k, v, qh, kh, vh, ke, ve
    torch.cuda.empty_cache()
    return rows


def widen_kernel_phase(dev, errs: Errors):
    """widen_2d vs its plain version and NetChange's widen_in / widen_out
    at the JAX benchmark's shape and the transformer cohort's FFN
    widening (glm4-9b's 6848 -> 13696, both units of a client stacked);
    times beside ``index_select`` where that one call is the function."""
    from repro_torch.core import netchange as nc
    from repro_torch.kernels.netchange import ops as wops
    from repro_torch.kernels.netchange import ref as wref
    from repro_torch.kernels.netchange import widen as wk

    gen = torch.Generator(device=dev).manual_seed(3)
    rows = {}
    d_model, d_half = 4096, 6848
    for tag, R, old, new in (
            ("benchmark", 4096, 14336 // 8, 21504 // 8),
            ("glm4 FFN", TFFN["n_layers"] * d_model, d_half, 2 * d_half)):
        x = torch.randn(R, old, generator=gen, device=dev)
        m = nc.dup_mapping(old, new, tag="u/b0/ffn")
        mt = torch.as_tensor(m, device=dev)
        st = torch.as_tensor(wops.split_scale(m, old), device=dev)
        sc = float(x.abs().max())
        shape = f"{R}x{old}->{new}"
        for split in (False, True):
            got = wops.widen_cols(x, m, split=split)
            want = wops.widen_cols(x, m, split=split, use_kernel=False)
            errs.hold("widen_2d", got, want, sc, f"{shape} split={split}")
            check(torch.equal(got, want), f"widen {shape} not bit-equal")
        # NetChange's To-Wider on the same weights (the JAX package's
        # test_widen_kernel_matches_core_semantics)
        errs.hold("widen_2d", wops.widen_cols(x, m), nc.widen_in(x, m, -1),
                  sc, f"{shape} == widen_in")
        xt = x.t().contiguous()                     # (old, R): rows
        errs.hold("widen_2d", wops.widen_cols(x, m, split=True),
                  nc.widen_out(xt, m, old, axis=0).t(), sc,
                  f"{shape} == widen_out")
        errs.hold("widen_2d", wops.widen(xt, m, axis=0, split=True),
                  wref.widen_ref(xt, mt, st, axis=0), sc,
                  f"rows {old}->{new} x{R} split")
        io = R * old * 4 + R * new * 4
        time_row(rows, f"widen cols dup {tag} {shape}",
                 lambda: wk.widen_2d(x, mt),
                 lambda: wops.widen_cols(x, m),
                 lambda: wref.widen_ref(x, mt, None),
                 io + new * 4, 0, lambda: x.index_select(1, mt))
        time_row(rows, f"widen cols split {tag} {shape}",
                 lambda: wk.widen_2d(x, mt, st),
                 lambda: wops.widen_cols(x, m, split=True),
                 lambda: wref.widen_ref(x, mt, st),
                 io + new * 8, R * new)
        x3 = xt.view(1, old, R)
        time_row(rows, f"widen rows split {tag} {old}->{new} x{R}",
                 lambda: wk.widen_2d(x3, mt, st),
                 lambda: wops.widen(xt, m, axis=0, split=True),
                 lambda: wref.widen_ref(xt, mt, st, axis=0),
                 io + new * 8, R * new)
        del x, xt, x3
    print(json.dumps({"widen_variants": rows}))
    torch.cuda.empty_cache()
    return rows


def serve_path(dev):
    """gemma3-27b at its published widths, depth cut to 12 layers (10
    local + 2 global), through ``launch.serve.run``: prefill B = 4
    prompts of 4096 tokens, then 32 greedy tokens. The launch counts of
    that run must show every attention layer in the kernels; then the
    logits are held against ``forward_hidden`` and the kernel against the
    model's plain decode attention on the real caches."""
    from repro_torch import tree as tu
    from repro_torch.kernels.flash_attention import flash as ff
    from repro_torch.kernels.swa_attention import ops as sops
    from repro_torch.kernels.swa_attention import swa as sk
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import attention as A
    from repro_torch.models import transformer as T
    from repro_torch.sharding.ctx import ShardCtx

    s = SERVE
    sk.reset_launch_counts()
    ff.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = serve.run(s["arch"], use_reduced=False, n_layers=s["n_layers"],
                    batch=s["batch"], prompt_len=s["prompt_len"],
                    gen=s["gen"], seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {**sk.launch_counts(), **ff.launch_counts()}
    peak = torch.cuda.max_memory_allocated()
    cfg, params = res["cfg"], res["params"]
    kinds = [cfg.layer_pattern[i % cfg.pattern_len]
             for i in range(cfg.n_layers)]
    n_local = kinds.count("local")
    n_global = len(kinds) - n_local
    print(f"  serve run: {wall:.1f} s; launches {counts}")
    check(counts["swa_prefill"] == n_local,
          f"prefill: {counts['swa_prefill']} swa_prefill launches for "
          f"{n_local} local layers")
    check(counts["flash_fwd"] == n_global,
          f"prefill: {counts['flash_fwd']} flash_fwd launches for "
          f"{n_global} global layers")
    check(counts["swa_decode"] == cfg.n_layers * s["gen"],
          f"decode: {counts['swa_decode']} swa_decode launches for "
          f"{cfg.n_layers} layers x {s['gen']} tokens")
    check(counts["flash_bwd_dq"] == counts["flash_bwd_dkv"] == 0,
          "serving launched a backward kernel")

    P_L, L = s["prompt_len"], s["prompt_len"] + s["gen"]
    ref_ctx = ShardCtx(attn_backend="flash")
    w_out = params["embed"].t()                      # tied embeddings
    param_bytes = sum(t.numel() * t.element_size()
                      for t in tu.leaves(params))
    with torch.inference_mode():
        # prefill's last logits vs the training forward (flash kernels
        # on every layer, local ones with their window)
        h = T.forward_hidden(params, cfg, res["prompts"], ctx=ref_ctx)
        want = (h[:, -1] @ w_out).float()
        del h
        err_p = float((res["prefill_logits"] - want).abs().max())
        tol_p = SERVE_PREFILL_TOL * float(want.abs().max())
        print(f"  prefill logits vs forward_hidden: max |diff| {err_p:.3e} "
              f"(tol {tol_p:.3e})")
        check(err_p <= tol_p, f"prefill logits off by {err_p} > {tol_p}")
        # the last decode step vs the forward of prompt + generated tokens
        seq = torch.cat([res["prompts"], res["tokens"]], dim=1)
        h = T.forward_hidden(params, cfg, seq, ctx=ref_ctx)
        want = (h[:, -1] @ w_out).float()
        del h
        err_d = float((res["logits"] - want).abs().max())
        tol_d = SERVE_DECODE_TOL * float(want.abs().max())
        print(f"  last decode logits vs forward_hidden of {L} tokens: "
              f"max |diff| {err_d:.3e} (tol {tol_d:.3e})")
        check(err_d <= tol_d, f"decode logits off by {err_d} > {tol_d}")
        del want, seq
        torch.cuda.empty_cache()

        # a second (warm) prefill: its time, and the caches as prefill
        # leaves them (the run's caches hold the decoded tokens too)
        prefill = make_prefill_step(cfg, ctx=ShardCtx(), cache_len=L)
        (logits, cache), warm_s, _ = _synced(
            lambda: prefill(params, {"tokens": res["prompts"]}))
        errs_c = []
        gen = torch.Generator(device=dev).manual_seed(4)
        H, hd = cfg.n_heads, cfg.resolved_head_dim
        local_b = cfg.layer_pattern.index("local")
        global_b = cfg.layer_pattern.index("global")
        for when, c, q_pos in (("after prefill", cache, P_L - 1),
                               ("after the last step", res["cache"],
                                L - 1)):
            for kind, b in (("local", local_b), ("global", global_b)):
                ck = c["units"][f"b{b}"]["k"][0]
                cv = c["units"][f"b{b}"]["v"][0]
                Sc = ck.shape[1]
                window = cfg.window if kind == "local" else 0
                kp = (A.ring_positions(q_pos, Sc, device=dev)
                      if kind == "local" else torch.arange(Sc, device=dev))
                q = torch.randn(s["batch"], H, hd, generator=gen, device=dev)
                got = sops.decode_attention(q, ck, cv, kp, q_pos,
                                            window=window)
                want = A.decode_attention(q, ck, cv, kp, q_pos,
                                          window=window)
                err = float((got - want).abs().max())
                errs_c.append(err)
                print(f"  swa_decode vs decode_attention, {kind} layer "
                      f"cache {tuple(ck.shape)} {when}: max |diff| "
                      f"{err:.3e} (tol {SERVE_KERNEL_TOL:g})")
                check(err <= SERVE_KERNEL_TOL,
                      f"swa_decode on the {kind} cache {when}: {err}")
        err_w = float((logits - res["prefill_logits"]).abs().max())
        check(err_w <= tol_p, f"second prefill differs by {err_w}")
        del cache, logits
        breakdown = decode_breakdown(params, cfg, res, L - 1,
                                     (local_b, global_b), n_local, n_global)
    info = {"arch": cfg.name, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "vocab": cfg.vocab_size,
            "batch": s["batch"], "prompt_len": P_L, "gen": s["gen"],
            "param_bytes": param_bytes,
            "run_wall_s": wall, "prefill_s": res["prefill_s"],
            "prefill_warm_s": warm_s,
            "decode_first_s": res["decode_first_s"],
            "decode_ms_per_token": res["decode_ms_per_token"],
            "decode_bound_ms": param_bytes / hbm_rate(
                torch.cuda.get_device_name(0)) * 1e3,
            "max_memory_allocated": peak, "launches": counts,
            "prefill_logits_err": err_p, "decode_logits_err": err_d,
            "kernel_vs_plain_on_caches": max(errs_c),
            "decode_breakdown": breakdown}
    print(json.dumps({"serve_path": info}))
    del res, params
    free_device()
    return counts, info


def decode_breakdown(params, cfg, res, pos, blocks, n_local, n_global):
    """Where one decode step's time goes (CUDA events, 10 calls each, on
    the serve run's final cache at its last position): the whole step,
    one local and one global block, and the vocabulary projection; the
    rest (embedding, final norm, launches between) is the difference.
    Each part beside its weight-read bound."""
    from repro_torch import tree as tu
    from repro_torch.models import transformer as T
    from repro_torch.sharding.ctx import ShardCtx

    rate = hbm_rate(torch.cuda.get_device_name(0))
    tok = res["tokens"][:, -1:]
    h = T._embed(params, cfg, tok)
    w_out = params["embed"].t()

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tu.leaves(tree))

    def block(b):
        p = tu.tree_map(lambda t: t[0], params["units"][f"b{b}"])
        c = res["cache"]["units"][f"b{b}"]
        cache = {"k": c["k"][0], "v": c["v"][0]}
        kind = cfg.layer_pattern[b]
        return (lambda: T.block_apply_decode(p, cfg, kind, h, pos, cache,
                                             ctx=ShardCtx())), nbytes(p)

    def step():
        return T.decode_step(params, cfg, tok, res["cache"], pos)

    step_ms = cuda_ms(step, reps=10)
    # the host's time to enqueue one step (~500 launches, fewer than the
    # launch queue holds, so the host does not wait on the card): about
    # the step's time when the host, not the card, sets the pace
    enqueue = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        enqueue.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    (local_fn, local_bytes), (global_fn, global_bytes) = map(block, blocks)
    local_ms = cuda_ms(local_fn, reps=10)
    global_ms = cuda_ms(global_fn, reps=10)
    vocab_ms = cuda_ms(lambda: (h @ w_out).float(), reps=10)
    out = {"step_ms": step_ms, "host_enqueue_ms": min(enqueue),
           "local_block_ms": local_ms,
           "global_block_ms": global_ms, "vocab_projection_ms": vocab_ms,
           "rest_ms": step_ms - n_local * local_ms - n_global * global_ms
           - vocab_ms,
           "local_block_bound_ms": local_bytes / rate * 1e3,
           "global_block_bound_ms": global_bytes / rate * 1e3,
           "vocab_projection_bound_ms": nbytes(params["embed"]) / rate * 1e3}
    print(f"  decode step {step_ms:.3f} ms = {n_local} x local block "
          f"{local_ms:.3f} + {n_global} x global block {global_ms:.3f} + "
          f"vocabulary projection {vocab_ms:.3f} + rest {out['rest_ms']:.3f}"
          f" (bounds {out['local_block_bound_ms']:.3f}, "
          f"{out['global_block_bound_ms']:.3f}, "
          f"{out['vocab_projection_bound_ms']:.3f})")
    print(f"  host enqueue of one decode step: {out['host_enqueue_ms']:.3f} "
          f"ms (min of 5)")
    return out



# --------------------------------------------- head dims 8 and 256 (hd)
def hd_kernel_phase(dev, errs: Errors):
    """The five attention kernels at head dims 8 and 256 vs their plain
    versions (causal, windowed, GQA and MQA, ragged S, bf16 for the swa
    kernels, rows and a decode query that see no key), then timed at
    gemma-7b's shapes (``HD_TIMES``) and recurrentgemma-9b's local
    prefill (``RG_LOCAL``) beside their bounds, their plain versions and
    PyTorch's memory-efficient attention on the same heads."""
    from repro_torch.kernels.flash_attention import flash as ff
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.swa_attention import ref as sref
    from repro_torch.kernels.swa_attention import swa as sk

    # the flash and prefill instances' lines are printed by the flash and
    # serving kernel phases; ptxas reports only static shared memory, so
    # the dynamic size each launch requests is read from the libraries
    for line in ptxas_lines("swa_attention", "swa_decode"):
        if "<256," in line or "<8," in line:
            print(f"  ptxas {line}")
    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    for hd in (8, 256):
        smem = attn_smem(hd)
        print(f"  shared memory at hd={hd}: " + ", ".join(
            f"{k} {v:,} B" for k, v in smem.items()))
        check(all(0 < v <= optin for v in smem.values()),
              f"hd={hd}: shared memory {smem} past the card's {optin} B")
    gen = torch.Generator(device=dev).manual_seed(19)
    for hd in (8, 256):
        dead = torch.arange(300, dtype=torch.int32, device=dev)
        dead[40:90] = -1                  # query rows that see no key
        kdead = torch.arange(300, dtype=torch.int32, device=dev)
        kdead[:3] = -1
        for tag, kw in (
                ("causal S=300", dict(B=2, KV=2, G=2, Sq=300, Sk=300)),
                ("window=100 S=517", dict(B=1, KV=2, G=2, Sq=517, Sk=517,
                                          window=100)),
                ("GQA G=4 S=129", dict(B=1, KV=2, G=4, Sq=129, Sk=129)),
                ("MQA G=16 S=200", dict(B=1, KV=1, G=16, Sq=200, Sk=200)),
                ("cross Sq=65 Sk=90", dict(B=2, KV=1, G=2, Sq=65, Sk=90,
                                           causal=False)),
                ("rows with no key", dict(B=1, KV=2, G=2, Sq=300, Sk=300,
                                          qp=dead, kp=kdead))):
            flash_case(dev, gen, errs, f"hd={hd} {tag}", hd=hd, **kw)
        for tag, kw in (
                ("ring W=256 wrapped", dict(B=2, KV=4, G=2, S=256,
                                            window=256, q_pos=700,
                                            kind="ring")),
                ("bf16 k/v odd S=3001 window=500",
                 dict(B=2, KV=2, G=2, S=3001, window=500, q_pos=2999,
                      dtype=torch.bfloat16)),
                ("MQA G=16 S=777", dict(B=1, KV=1, G=16, S=777, window=0,
                                        q_pos=776)),
                ("no visible slot", dict(B=2, KV=2, G=2, S=300, window=0,
                                         q_pos=40, kind="late"))):
            decode_case(dev, gen, errs, f"hd={hd} {tag}", hd=hd, **kw)
        for tag, (B, KV, G, S, window, dtype) in (
                ("window=100 S=517", (1, 2, 2, 517, 100, torch.float32)),
                ("bf16 window=64 S=301", (2, 2, 2, 301, 64, torch.bfloat16)),
                ("MQA G=16 window=128", (1, 1, 16, 400, 128, torch.float32)),
                ("causal S=65", (1, 2, 1, 65, 0, torch.float32))):
            q = torch.randn(B, KV, G, S, hd, generator=gen,
                            device=dev).to(dtype)
            k = torch.randn(B, S, KV, hd, generator=gen, device=dev).to(dtype)
            v = torch.randn(B, S, KV, hd, generator=gen, device=dev).to(dtype)
            got = sk.swa_prefill(q, k, v, window=window)
            want = sref.prefill_ref(q, k, v, window=window)
            errs.hold("swa_prefill", got, want, finite_scale(want),
                      f"hd={hd} {tag}", FLASH_TOL)
    torch.cuda.empty_cache()

    rows = {}

    def row(name, kern, plain, lib, nbytes, flops, tensor_cores=True,
            card=None, **extra):
        time_row(rows, name, kern, None, plain, nbytes, flops, lib,
                 tensor_cores, card, reps=5, plain_reps=2)
        rows[name].update(extra)

    f32 = 4
    for hd in (256, 8):
        # -- training: forward and the backward pair, causal, held against
        # the plain versions at the shape the cohort and the trainer run
        m = HD_TIMES["train"]
        B, KV, G, S = m["B"], m["KV"], m["G"], m["S"]
        H = KV * G
        q, k, v, dout, qp, kp, out, lse, delta = flash_case(
            dev, gen, errs, f"hd={hd} train B={B} KV={KV} G={G} S={S}",
            B=B, KV=KV, G=G, Sq=S, Sk=S, hd=hd)
        torch.cuda.empty_cache()
        args = (q, k, v, qp, kp, lse, delta, dout)
        pairs = band_pairs(S, 0) * B * H
        qb, kb, rowb = B * H * S * hd * f32, B * KV * S * hd * f32, \
            B * H * S * f32
        qh = q.reshape(B, H, S, hd)
        kh = k.permute(0, 2, 1, 3).contiguous()
        vh = v.permute(0, 2, 1, 3).contiguous()
        if G > 1:
            kh, vh = kh.repeat_interleave(G, 1), vh.repeat_interleave(G, 1)
        qe, ke, ve = (x.clone().requires_grad_() for x in (qh, kh, vh))
        try:
            oe = efficient_sdpa(qe, ke, ve, is_causal=True)
            eff_bwd = lambda: torch.autograd.grad(  # noqa: E731
                oe, (qe, ke, ve), dout.reshape(B, H, S, hd),
                retain_graph=True)
            eff_bwd()
        except RuntimeError as e:
            print(f"  efficient backend refused hd={hd}: "
                  f"{str(e).splitlines()[0]}")
            eff_bwd = None
        eff_fwd = lambda: efficient_sdpa(qh, kh, vh,  # noqa: E731
                                         is_causal=True)
        tag = f"hd={hd} train B={B} KV={KV} G={G} S={S}"
        row(f"flash_fwd {tag}", lambda: ff.flash_fwd(q, k, v, qp, kp),
            lambda: fref.flash_fwd_ref(q, k, v, qp, kp),
            eff_fwd if eff_bwd is not None else None,
            2 * qb + 2 * kb + rowb, 4 * hd * pairs, visible_pairs=pairs)
        plain_bwd = lambda: fref.flash_bwd_ref(  # noqa: E731
            q, k, v, qp, kp, out, lse, dout)
        row(f"flash_bwd_dq {tag}", lambda: ff.flash_bwd_dq(*args), plain_bwd,
            eff_bwd, 3 * qb + 2 * kb + 2 * rowb, 6 * hd * pairs)
        row(f"flash_bwd_dkv {tag}", lambda: ff.flash_bwd_dkv(*args),
            plain_bwd, eff_bwd, 2 * qb + 4 * kb + 2 * rowb, 8 * hd * pairs)
        del q, k, v, dout, out, lse, delta, args, qh, kh, vh, qe, ke, ve
        eff_bwd = eff_fwd = plain_bwd = oe = None
        torch.cuda.empty_cache()

        # -- serve prefill (global layers): flash_fwd over the prompt
        m = HD_TIMES["prefill"]
        B, KV, G, S = m["B"], m["KV"], m["G"], m["S"]
        H = KV * G
        q = torch.randn(B, KV, G, S, hd, generator=gen, device=dev)
        k = torch.randn(B, S, KV, hd, generator=gen, device=dev)
        v = torch.randn(B, S, KV, hd, generator=gen, device=dev)
        pos = torch.arange(S, dtype=torch.int32, device=dev)
        qh = q.reshape(B, H, S, hd)
        kh, vh = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
        pairs = band_pairs(S, 0) * B * H
        tag = f"hd={hd} serve prefill B={B} KV={KV} S={S}"
        got, got_lse = ff.flash_fwd(q, k, v, pos, pos)
        want, want_lse = fref.flash_fwd_ref(q, k, v, pos, pos, block_kv=128)
        errs.hold("flash_fwd", got, want, finite_scale(want), f"{tag} out",
                  FLASH_TOL)
        errs.hold("flash_fwd", got_lse, want_lse, finite_scale(want_lse),
                  f"{tag} lse", FLASH_TOL)
        del got, got_lse, want, want_lse
        got = sk.swa_prefill(q, k, v, window=0)
        want = sref.prefill_ref(q, k, v, window=0)
        errs.hold("swa_prefill", got, want, finite_scale(want), f"{tag} w=0",
                  FLASH_TOL)
        del got, want
        torch.cuda.empty_cache()
        row(f"flash_fwd hd={hd} serve prefill B={B} KV={KV} S={S}",
            lambda: ff.flash_fwd(q, k, v, pos, pos),
            lambda: fref.flash_fwd_ref(q, k, v, pos, pos, block_kv=128),
            lambda: efficient_sdpa(qh, kh, vh, is_causal=True),
            (2 * B * H * S * hd + 2 * B * S * KV * hd + B * H * S) * f32,
            4 * hd * pairs, visible_pairs=pairs)
        band = (pos[None, :] <= pos[:, None])
        row(f"swa_prefill hd={hd} serve prefill B={B} KV={KV} S={S} w=0",
            lambda: sk.swa_prefill(q, k, v, window=0),
            lambda: sref.prefill_ref(q, k, v, window=0),
            lambda: efficient_sdpa(qh, kh, vh, attn_mask=band),
            (3 * B * H * S * hd + 2 * B * S * KV * hd) * f32,
            4 * hd * pairs, visible_pairs=pairs)
        del q, k, v, qh, kh, vh, band
        torch.cuda.empty_cache()

        # -- recurrentgemma-9b's local layers: MQA, window 2048
        m = RG_LOCAL
        B, KV, G, S, W = m["B"], m["KV"], m["G"], m["S"], m["window"]
        H = KV * G
        q = torch.randn(B, KV, G, S, hd, generator=gen, device=dev)
        k = torch.randn(B, S, KV, hd, generator=gen, device=dev)
        v = torch.randn(B, S, KV, hd, generator=gen, device=dev)
        pos = torch.arange(S, dtype=torch.int32, device=dev)
        got = sk.swa_prefill(q, k, v, window=W)
        want = sref.prefill_ref(q, k, v, window=W)
        errs.hold("swa_prefill", got, want, finite_scale(want),
                  f"hd={hd} recurrentgemma local MQA w={W}", FLASH_TOL)
        del got, want
        qh = q.reshape(B, H, S, hd)
        ke = k.permute(0, 2, 1, 3).repeat_interleave(G, 1)
        ve = v.permute(0, 2, 1, 3).repeat_interleave(G, 1)
        band = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :]
                                                 < W)
        pairs = band_pairs(S, W) * B * H
        row(f"swa_prefill hd={hd} recurrentgemma local B={B} KV=1 G={G} "
            f"S={S} w={W}",
            lambda: sk.swa_prefill(q, k, v, window=W),
            lambda: sref.prefill_ref(q, k, v, window=W),
            lambda: efficient_sdpa(qh, ke, ve, attn_mask=band),
            (3 * B * H * S * hd + 2 * B * S * KV * hd) * f32,
            4 * hd * pairs, visible_pairs=pairs)
        del q, k, v, qh, ke, ve, band
        torch.cuda.empty_cache()

        # -- serve decode (global layers, window 0)
        m = HD_TIMES["decode"]
        B, KV, G, S = m["B"], m["KV"], m["G"], m["S"]
        H = KV * G
        q, k, v, kp = decode_case(dev, gen, errs,
                                  f"hd={hd} serve decode S={S}", B=B, KV=KV,
                                  G=G, hd=hd, S=S, window=0, q_pos=S - 1)
        qh = q.reshape(B, H, 1, hd)
        kh, vh = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
        row(f"swa_decode hd={hd} serve decode B={B} KV={KV} S={S}",
            lambda: sk.swa_decode(q, k, v, kp, S - 1),
            lambda: sref.decode_ref(q, k, v, kp, S - 1),
            lambda: efficient_sdpa(qh, kh, vh),
            (2 * B * S * KV * hd + 2 * B * H * hd) * f32 + S * 4,
            4 * B * H * hd * S, tensor_cores=False,
            card=with_copies(lambda kk, vv: sk.swa_decode(
                q, kk, vv, kp, S - 1), k, v))
        del q, k, v, kp, qh, kh, vh
        torch.cuda.empty_cache()
    print(json.dumps({"hd_variants": rows}))
    return rows


def attn_smem(hd: int) -> dict:
    """Dynamic shared memory each attention kernel's launch requests at
    head dim ``hd``, in bytes, as the built libraries compute it
    (``flash_smem_bytes``, ``swa_prefill_smem_bytes``)."""
    from repro_torch.kernels.flash_attention import flash as ff
    from repro_torch.kernels.swa_attention import swa as sk

    return {**ff.smem_bytes(hd),
            **{f"swa_prefill {k}": v
               for k, v in sk.prefill_smem_bytes(hd).items()}}


def dense_serve_path(dev, spec):
    """A dense all-global config at its published widths through
    ``launch.serve.run``: the launch counts must show every layer in the
    kernels (one ``flash_fwd`` a layer in prefill, one ``swa_decode`` a
    layer a token); prefill's and the last step's logits are held against
    one ``forward_hidden`` of prompt + generated tokens, and the kernel
    against the model's plain decode attention on the real cache."""
    from repro_torch import tree as tu
    from repro_torch.kernels.flash_attention import flash as ff
    from repro_torch.kernels.swa_attention import ops as sops
    from repro_torch.kernels.swa_attention import swa as sk
    from repro_torch.launch import serve
    from repro_torch.models import attention as A
    from repro_torch.models import transformer as T
    from repro_torch.sharding.ctx import ShardCtx

    s = spec
    sk.reset_launch_counts()
    ff.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = serve.run(s["arch"], use_reduced=False, n_layers=s["n_layers"],
                    batch=s["batch"], prompt_len=s["prompt_len"],
                    gen=s["gen"], seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {**sk.launch_counts(), **ff.launch_counts()}
    peak = torch.cuda.max_memory_allocated()
    cfg, params = res["cfg"], res["params"]
    print(f"  {cfg.name} serve run ({cfg.n_layers} layers): {wall:.1f} s; "
          f"launches {counts}; peak {peak / 1e9:.2f} GB")
    check(counts["flash_fwd"] == cfg.n_layers,
          f"prefill: {counts['flash_fwd']} flash_fwd launches for "
          f"{cfg.n_layers} layers")
    check(counts["swa_decode"] == cfg.n_layers * s["gen"],
          f"decode: {counts['swa_decode']} swa_decode launches for "
          f"{cfg.n_layers} layers x {s['gen']} tokens")
    check(counts["swa_prefill"] == counts["flash_bwd_dq"]
          == counts["flash_bwd_dkv"] == 0,
          f"serving launched another kernel: {counts}")
    P_L, L = s["prompt_len"], s["prompt_len"] + s["gen"]
    param_bytes = sum(t.numel() * t.element_size()
                      for t in tu.leaves(params))
    with torch.inference_mode():
        # one causal forward of prompt + generated tokens gives both
        # references: position P_L - 1 is prefill's, the last position
        # the last decode step's
        seq = torch.cat([res["prompts"], res["tokens"]], dim=1)
        h = T.forward_hidden(params, cfg, seq,
                             ctx=ShardCtx(attn_backend="flash"))
        w_out = params["embed"].t()                  # tied embeddings
        want_p = (h[:, P_L - 1] @ w_out).float()
        want_d = (h[:, -1] @ w_out).float()
        del h, seq
        err_p = float((res["prefill_logits"] - want_p).abs().max())
        tol_p = SERVE_PREFILL_TOL * float(want_p.abs().max())
        err_d = float((res["logits"] - want_d).abs().max())
        tol_d = SERVE_DECODE_TOL * float(want_d.abs().max())
        print(f"  prefill logits vs forward_hidden: max |diff| {err_p:.3e} "
              f"(tol {tol_p:.3e}); last decode logits vs forward_hidden of "
              f"{L} tokens: {err_d:.3e} (tol {tol_d:.3e})")
        check(err_p <= tol_p, f"prefill logits off by {err_p} > {tol_p}")
        check(err_d <= tol_d, f"decode logits off by {err_d} > {tol_d}")
        del want_p, want_d
        c = res["cache"]["units"]["b0"]
        ck, cv = c["k"][0], c["v"][0]
        gen = torch.Generator(device=dev).manual_seed(5)
        q = torch.randn(s["batch"], cfg.n_heads, cfg.resolved_head_dim,
                        generator=gen, device=dev)
        kp = torch.arange(ck.shape[1], device=dev)
        got = sops.decode_attention(q, ck, cv, kp, L - 1)
        want = A.decode_attention(q, ck, cv, kp, L - 1)
        err_c = float((got - want).abs().max())
        print(f"  swa_decode vs decode_attention on the cache "
              f"{tuple(ck.shape)}: max |diff| {err_c:.3e} "
              f"(tol {SERVE_KERNEL_TOL:g})")
        check(err_c <= SERVE_KERNEL_TOL, f"swa_decode on the cache: {err_c}")
    check(all(bool(torch.isfinite(x).all())
              for x in (res["prefill_logits"], res["logits"])),
          "non-finite logits")
    info = {"arch": cfg.name, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "n_heads": cfg.n_heads,
            "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.resolved_head_dim,
            "vocab": cfg.vocab_size, "batch": s["batch"],
            "prompt_len": P_L, "gen": s["gen"], "param_bytes": param_bytes,
            "run_wall_s": wall, "prefill_s": res["prefill_s"],
            "decode_first_s": res["decode_first_s"],
            "decode_ms_per_token": res["decode_ms_per_token"],
            "decode_bound_ms": param_bytes / hbm_rate(
                torch.cuda.get_device_name(0)) * 1e3,
            "max_memory_allocated": peak, "launches": counts,
            "prefill_logits_err": err_p, "decode_logits_err": err_d,
            "kernel_vs_plain_on_cache": err_c}
    print(json.dumps({"dense_serve_path": info}))
    del res, params, c, ck, cv
    free_device()
    return counts, info


def gemma_cohort_path():
    """The gemma-7b FedADP cohort (``GEMMA_COHORT``), the glm4 path's
    protocol: one f32 round through the flash kernels ("auto": one
    forward a layer a step and an eval forward a client view, one of
    each backward kernel a layer a step), then one bf16 round
    (the unified engine's compute policy) held against the f32 round
    (``BF16_TOL``, the reference's bf16 contract) and, leaf by leaf,
    against what the f32 round moved the leaf (``BF16_UPDATE_RTOL``).
    (A blockwise round held against the f32 one did not fit the script's
    time limit: the glm4, recurrentgemma (hd 256) and internvl2 cohorts
    hold theirs, ``hd_kernel_phase`` the kernels at gemma-7b's shapes.)"""
    from repro_torch import tree as tu

    def cpu_leaves(tree):
        return [x.detach().to("cpu", copy=True) for x in tu.leaves(tree)]

    def leaf_diffs(a, b):
        return [float((x - y.cpu()).abs().max()) for x, y in zip(a, b)]

    t = GEMMA_COHORT
    init = {}
    res, info, counts, _, _ = tffn_run(
        "auto", 1, t=t, on_init=lambda p: init.setdefault("f32",
                                                          cpu_leaves(p)))
    L, K = t["n_layers"], t["K"]
    train = info["steps_per_round"] * L
    evals = len(info["history"]) * K * L
    check(counts["flash_bwd_dq"] == counts["flash_bwd_dkv"] == train,
          f"backward launches {counts} != {train} (steps x layers)")
    check(counts["flash_fwd"] == train + evals,
          f"forward launches {counts['flash_fwd']} != {train} + {evals}")
    check(counts["widen_2d"] > 0, "the cohort's round start never widened")
    paths = [p for p, _ in tu.flatten(res["global_params"])]
    g32 = cpu_leaves(res["global_params"])
    moves = leaf_diffs(g32, init["f32"])          # the f32 round's update
    move = max(moves)
    print(f"  gemma-7b cohort: the f32 round moved the global params by "
          f"max |global - init| = {move:.3e} (smallest leaf "
          f"{min(moves):.3e})")
    check(min(moves) > 0, "the f32 round left a leaf where it was")
    del res
    free_device()
    res_h, info_h, counts_h, _, _ = tffn_run(
        "auto", 1, t=t, compute_dtype="bf16",
        on_init=lambda p: init.setdefault("bf16", cpu_leaves(p)))
    check(all(torch.equal(a, b) for a, b in zip(init["f32"], init["bf16"])),
          "the bf16 round started from another init")
    check(counts_h["flash_bwd_dq"] == train and
          counts_h["flash_fwd"] == train + evals,
          f"bf16 round's flash launches {counts_h}")
    gl = tu.leaves(res_h["global_params"])
    check(all(x.dtype == torch.float32 for x in gl),
          "the bf16 round's global model left f32")
    diffs_h = leaf_diffs(g32, gl)
    diff_h = max(diffs_h)
    ratios = [d / m for d, m in zip(diffs_h, moves)]
    worst = int(np.argmax(ratios))
    move_h = max(leaf_diffs(init["bf16"], gl))
    print(f"  gemma-7b cohort: bf16 vs f32 round: max |diff| of global "
          f"params = {diff_h:.3e} (tol {BF16_TOL:g}); the bf16 round moved "
          f"them by {move_h:.3e}; leaf by leaf |diff| / f32 move at most "
          f"{ratios[worst]:.3e} ({'.'.join(paths[worst])}: "
          f"{diffs_h[worst]:.3e} / {moves[worst]:.3e}; tol "
          f"{BF16_UPDATE_RTOL:g})")
    for p, d, m in zip(paths, diffs_h, moves):
        print(f"    {'.'.join(p):28s} f32 move {m:.3e} bf16 diff {d:.3e} "
              f"ratio {d / m:.3e}")
    check(0 < diff_h <= BF16_TOL, f"bf16 round vs f32 round: {diff_h}")
    check(ratios[worst] <= BF16_UPDATE_RTOL,
          f"bf16 round's update off the f32 update: {ratios[worst]}")
    del res_h, gl, g32, init
    free_device()
    total = {k: counts[k] + counts_h[k] for k in counts}
    return total, {"f32": info, "bf16": info_h, "bf16_vs_f32": diff_h,
                   "f32_move": move, "bf16_move": move_h,
                   "bf16_update_ratio": ratios[worst],
                   "leaf_moves": dict(zip([".".join(p) for p in paths],
                                          moves))}


def trainer_path(dev):
    """``launch.train.run`` on gemma-7b at its published widths, 2 of 28
    layers, the whole vocabulary: one blockwise step for the reference
    loss, then ``TRAIN["steps"]`` AdamW steps through the flash kernels
    (one forward and one of each backward kernel a layer a step). The
    first loss must match the blockwise one within ``TRAIN_LOSS_TOL`` x
    the loss, and every loss must be finite."""
    from repro_torch.kernels.flash_attention import flash as ff
    from repro_torch.launch import train

    t = TRAIN
    kw = dict(use_reduced=False, n_layers=t["n_layers"], batch=t["batch"],
              seq=t["seq"], lr=t["lr"], seed=0, device=dev,
              log_every=t["steps"])
    ff.reset_launch_counts()
    ref = train.run(t["arch"], steps=1, attn="blockwise", **kw)
    loss_b = ref["losses"][0]
    check(sum(ff.launch_counts().values()) == 0,
          f"the blockwise step launched {ff.launch_counts()}")
    del ref
    free_device()
    ff.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = train.run(t["arch"], steps=t["steps"], attn="auto", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ff.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = res["losses"]
    n = t["steps"] * t["n_layers"]
    check(counts == dict.fromkeys(ff.KERNELS, n),
          f"trainer launches {counts}, expected {n} of each")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    err = abs(losses[0] - loss_b)
    print(f"  trainer: first loss {losses[0]:.6f} (blockwise {loss_b:.6f}, "
          f"|diff| {err:.3e}, tol {TRAIN_LOSS_TOL * abs(loss_b):.3e}); "
          f"last {losses[-1]:.6f}; {res['ms_per_step']:.1f} ms/step; peak "
          f"{peak / 1e9:.2f} GB")
    check(err <= TRAIN_LOSS_TOL * abs(loss_b),
          f"first loss {losses[0]} vs blockwise {loss_b}")
    info = {"arch": t["arch"], "n_layers": t["n_layers"],
            "batch": t["batch"], "seq": t["seq"], "steps": t["steps"],
            "losses": losses, "blockwise_first_loss": loss_b,
            "ms_per_step": res["ms_per_step"], "run_wall_s": wall,
            "max_memory_allocated": peak, "launches": counts}
    print(json.dumps({"trainer_path": info}))
    del res
    free_device()
    return counts, info


# ------------------------------------------------------- the MoE family
def elementwise_used(got, want, tol) -> float:
    """The largest share of ``tests/test_flash.py``'s elementwise bound,
    |got - want| <= atol + rtol |want|, that ``got`` uses."""
    atol, rtol = tol
    diff = (got.double() - want.double()).abs()
    return float((diff / (atol + rtol * want.double().abs())).max())


def attention_f64(q5, k5, v5, cot, grads: bool):
    """Causal attention in float64 on the model's layout (q5 (B, S, KV,
    G, hd), k5, v5 (B, S, KV, hd)): the value ``(out . cot).sum()`` and,
    with ``grads``, its gradients — the exact function, against which
    the f32 kernels and the f32 plain version are each held."""
    B, S, KV, G, hd = q5.shape
    leaves = [t.double().requires_grad_(grads) for t in (q5, k5, v5)]
    q, k, v = leaves
    with torch.set_grad_enabled(grads):
        s = torch.einsum("bqkgd,bskd->bkgqs", q, k) * hd ** -0.5
        pos = torch.arange(S, device=q.device)
        s = s.masked_fill(pos[None, :] > pos[:, None], float("-inf"))
        out = torch.einsum("bkgqs,bskd->bqkgd", torch.softmax(s, -1), v)
        del s
        val = (out.reshape(B, S, KV * G, hd) * cot.double()).sum()
        del out
        return [val.detach()] + (list(torch.autograd.grad(val, leaves))
                                 if grads else [])


def hold_reference_form(errs, kernel, got, want, exact, what, tol):
    """``tests/test_flash.py``'s elementwise form at the timed shapes:
    the kernel against the exact (float64) function, held; beside it the
    kernel against the f32 plain version and the plain version against
    the exact function, printed (two f32 sums of thousands of terms in
    different orders)."""
    used = elementwise_used(got, exact, tol)
    err = float((got.double() - exact.double()).abs().max())
    vs_plain = elementwise_used(got, want, tol)
    plain = elementwise_used(want, exact, tol)
    print(f"  {kernel:12s} {what:44s} vs float64: max_abs_err={err:.3e}, "
          f"{used:.3f} of the elementwise bound (atol {tol[0]:g}, rtol "
          f"{tol[1]:g}); kernel vs plain {vs_plain:.3f}, plain vs float64 "
          f"{plain:.3f}")
    check(math.isfinite(used) and used <= 1.0,
          f"{kernel} {what}: {used} of the elementwise bound")
    errs.max[kernel] = max(errs.max.get(kernel, 0.0),
                           float((got - want).abs().max()))


def mla_kernel_phase(dev, errs: Errors):
    """The three flash kernels at head dim 192 (MLA's qk head dim): ptxas's
    registers and spills and the shared memory each launch requests;
    the refusals that stay (``swa_prefill`` at 192, every kernel at 96);
    the kernels against their plain versions on edge cases (tile edges,
    a window, GQA, cross, rows that see no key) in the flash tolerance,
    then at deepseek-v2's shapes (``MLA_TIMES``) through
    ``flash_attention``, kernels and plain version, each against the
    float64 function in ``tests/test_flash.py``'s elementwise form
    (value and dq, dk, dv; the kernels held, the plain version printed),
    and the kernels on their own layout in the flash tolerance; each
    timed beside its bound, its plain version and PyTorch's
    memory-efficient attention on the same heads."""
    from repro_torch.kernels.flash_attention import flash as ff
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.swa_attention import swa as sk

    hd = MLA_HD
    for line in ptxas_lines("flash_attention", "flash_"):
        if f"<{hd}>" in line:
            print(f"  ptxas {line}")
    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    smem = ff.smem_bytes(hd)
    print(f"  shared memory at hd={hd}: " + ", ".join(
        f"{k} {v:,} B" for k, v in smem.items()))
    check(all(0 < v <= optin for v in smem.values()),
          f"hd={hd}: shared memory {smem} past the card's {optin} B")
    pos = torch.arange(16, dtype=torch.int32, device=dev)
    for name, fn, d in (
            ("swa_prefill", lambda x, y: sk.swa_prefill(x, y, y, window=0),
             hd),
            ("flash_fwd", lambda x, y: ff.flash_fwd(x, y, y, pos, pos), 96),
            ("swa_prefill", lambda x, y: sk.swa_prefill(x, y, y, window=0),
             96)):
        try:
            fn(torch.zeros(1, 1, 1, 16, d, device=dev),
               torch.zeros(1, 16, 1, d, device=dev))
            raise AssertionError(f"{name} took head dim {d}")
        except ValueError as e:
            check("built for" in str(e), f"wrong refusal of hd {d}: {e}")
            print(f"  {name:12s} hd={d} refused ({e})")
    gen = torch.Generator(device=dev).manual_seed(20)
    dead = torch.arange(300, dtype=torch.int32, device=dev)
    dead[40:90] = -1
    kdead = torch.arange(300, dtype=torch.int32, device=dev)
    kdead[:3] = -1
    for tag, kw in (
            ("MLA KV=8 G=1 S=300", dict(B=2, KV=8, G=1, Sq=300, Sk=300)),
            ("tile edges S=65", dict(B=1, KV=4, G=1, Sq=65, Sk=65)),
            ("window=100 S=517", dict(B=1, KV=2, G=2, Sq=517, Sk=517,
                                      window=100)),
            ("cross Sq=63 Sk=90", dict(B=2, KV=1, G=2, Sq=63, Sk=90,
                                       causal=False)),
            ("rows with no key", dict(B=1, KV=2, G=1, Sq=300, Sk=300,
                                      qp=dead, kp=kdead))):
        flash_case(dev, gen, errs, f"hd={hd} {tag}", hd=hd, **kw)
    torch.cuda.empty_cache()

    rows = {}

    def row(name, kern, plain, lib, nbytes, flops, **extra):
        time_row(rows, name, kern, None, plain, nbytes, flops, lib, True,
                 None, reps=5, plain_reps=2)
        rows[name].update(extra)

    f32 = 4
    for shape, m in MLA_TIMES.items():
        B, KV, G, S = m["B"], m["KV"], m["G"], m["S"]
        H = KV * G
        tag = f"hd={hd} deepseek {shape} B={B} KV={KV} G={G} S={S}"
        # the reference's form, through the autograd binding as the model
        # calls it: (B, S, KV, G, hd) in, kernels vs plain versions
        q5 = torch.randn(B, S, KV, G, hd, generator=gen, device=dev)
        k5 = torch.randn(B, S, KV, hd, generator=gen, device=dev)
        v5 = torch.randn(B, S, KV, hd, generator=gen, device=dev)
        cot = torch.randn(B, S, H, hd, generator=gen, device=dev)
        sp = torch.arange(S, device=dev)
        runs = []
        for use_kernel in (True, False):
            leaves = [t.clone().requires_grad_() for t in (q5, k5, v5)]
            out = flash_attention(*leaves, sp, sp, causal=True,
                                  use_kernel=use_kernel)
            val = (out * cot).sum()
            grads = (torch.autograd.grad(val, leaves) if shape == "train"
                     else ())
            runs.append([val.detach(), *grads])
            del leaves, out, val, grads
        runs.append(attention_f64(q5, k5, v5, cot, shape == "train"))
        torch.cuda.synchronize()
        for name, i, what, tol in (
                ("flash_fwd", 0, "value", REF_VALUE_TOL),
                ("flash_bwd_dq", 1, "dq", REF_GRAD_TOL),
                ("flash_bwd_dkv", 2, "dk", REF_GRAD_TOL),
                ("flash_bwd_dkv", 3, "dv", REF_GRAD_TOL)):
            if i < len(runs[0]):
                hold_reference_form(errs, name, *(r[i] for r in runs),
                                    f"{tag} {what}", tol)
        del runs, q5, k5, v5, cot
        torch.cuda.empty_cache()
        # the kernels on the kernel layout, held in the flash tolerance
        q, k, v, dout, qp, kp, out, lse, delta = flash_case(
            dev, gen, errs, tag, B=B, KV=KV, G=G, Sq=S, Sk=S, hd=hd)
        torch.cuda.empty_cache()
        args = (q, k, v, qp, kp, lse, delta, dout)
        pairs = band_pairs(S, 0) * B * H
        qb, kb, rowb = (B * H * S * hd * f32, B * KV * S * hd * f32,
                        B * H * S * f32)
        qh = q.reshape(B, H, S, hd)
        kh = k.permute(0, 2, 1, 3).contiguous()
        vh = v.permute(0, 2, 1, 3).contiguous()
        eff_fwd = eff_bwd = None
        try:
            efficient_sdpa(qh, kh, vh, is_causal=True)
            eff_fwd = lambda: efficient_sdpa(  # noqa: E731
                qh, kh, vh, is_causal=True)
        except RuntimeError as e:
            print(f"  efficient backend refused hd={hd} forward: "
                  f"{str(e).splitlines()[0]}")
        if shape == "train" and eff_fwd is not None:
            qe, ke, ve = (x.clone().requires_grad_() for x in (qh, kh, vh))
            try:
                oe = efficient_sdpa(qe, ke, ve, is_causal=True)
                eff_bwd = lambda: torch.autograd.grad(  # noqa: E731
                    oe, (qe, ke, ve), dout.reshape(B, H, S, hd),
                    retain_graph=True)
                eff_bwd()
            except RuntimeError as e:
                print(f"  efficient backend refused hd={hd} backward: "
                      f"{str(e).splitlines()[0]}")
                eff_bwd = None
        row(f"flash_fwd {tag}", lambda: ff.flash_fwd(q, k, v, qp, kp),
            lambda: fref.flash_fwd_ref(q, k, v, qp, kp),
            eff_fwd, 2 * qb + 2 * kb + rowb, 4 * hd * pairs,
            visible_pairs=pairs)
        if shape == "train":
            plain_bwd = lambda: fref.flash_bwd_ref(  # noqa: E731
                q, k, v, qp, kp, out, lse, dout)
            row(f"flash_bwd_dq {tag}", lambda: ff.flash_bwd_dq(*args),
                plain_bwd, eff_bwd, 3 * qb + 2 * kb + 2 * rowb,
                6 * hd * pairs)
            row(f"flash_bwd_dkv {tag}", lambda: ff.flash_bwd_dkv(*args),
                plain_bwd, eff_bwd, 2 * qb + 4 * kb + 2 * rowb,
                8 * hd * pairs)
        del q, k, v, dout, out, lse, delta, args, qh, kh, vh
        eff_fwd = eff_bwd = plain_bwd = None
        free_device()
    print(json.dumps({"mla_variants": rows}))
    return rows


def moe_breakdown(params, cfg, res, prompts):
    """A MoE config's serving parts, each timed alone (CUDA events): one
    layer's attention and MoE FFN sublayers (norm included) at the
    prompt's shape and at one decode token on the final cache, the
    vocabulary projection, and the whole decode step. Decode parts beside
    their weight-read bounds; the prefill FFN beside its f32 operation
    bound (the expert products over the capacity buffer, and the shared
    experts). A part timed alone is paced by its own launches, so the
    decode parts do not add up to the step: they bound each sublayer's
    cost, not the step's breakdown."""
    from repro_torch import tree as tu
    from repro_torch.models import attention as A
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import rms_norm

    rate = hbm_rate(torch.cuda.get_device_name(0))
    m, L, D = cfg.moe, cfg.n_layers, cfg.d_model
    kind = cfg.layer_pattern[0]
    p = tu.tree_map(lambda t: t[0], params["units"]["b0"])
    # a copy: the timed decode sublayer writes its token into the cache
    cache = {n: t[0].clone() for n, t in res["cache"]["units"]["b0"].items()}
    pos = prompts.shape[1] + res["tokens"].shape[1] - 1
    tok = res["tokens"][:, -1:]
    B, S = prompts.shape

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tu.leaves(tree))

    def attn_seq(h):
        x = rms_norm(h, p["ln1"], cfg.norm_eps)
        positions = torch.arange(S, device=h.device)
        if cfg.mla is not None:
            return A.mla_apply_seq(p["attn"], cfg, x, positions)[0]
        return A.attn_apply_seq(p["attn"], cfg, x, positions, kind=kind)[0]

    def attn_decode(h):
        x = rms_norm(h, p["ln1"], cfg.norm_eps)
        if cfg.mla is not None:
            return A.mla_apply_decode(p["attn"], cfg, x, pos, cache)[0]
        return A.attn_apply_decode(p["attn"], cfg, x, pos, cache,
                                   kind=kind)[0]

    def ffn(h):
        return M.moe_apply(p["moe"], cfg, rms_norm(h, p["ln2"],
                                                   cfg.norm_eps))

    g = torch.Generator(device=prompts.device).manual_seed(7)
    hs = torch.randn(B, S, D, generator=g, device=prompts.device)
    hd = torch.randn(B, 1, D, generator=g, device=prompts.device)
    N = B * S
    C = M._capacity(N, m.top_k, m.n_experts, m.capacity_factor)
    ffn_flops = 2 * 3 * D * (m.n_experts * C * m.d_ff_expert
                             + N * m.n_shared * m.d_ff_shared)
    out = {"prefill_attn_ms": cuda_ms(lambda: attn_seq(hs), reps=3),
           "prefill_ffn_ms": cuda_ms(lambda: ffn(hs), reps=3),
           "prefill_ffn_flops": ffn_flops,
           "prefill_ffn_bound_ms": ffn_flops / F32_FLOPS_PER_S * 1e3,
           "decode_step_ms": cuda_ms(lambda: T.decode_step(
               params, cfg, tok, res["cache"], pos), reps=10),
           "decode_attn_ms": cuda_ms(lambda: attn_decode(hd), reps=10),
           "decode_ffn_ms": cuda_ms(lambda: ffn(hd), reps=10),
           "vocab_ms": cuda_ms(lambda: (hd[:, 0] @ params["lm_head"]).float(),
                               reps=10),
           "decode_attn_bound_ms": nbytes(p["attn"]) / rate * 1e3,
           "decode_ffn_bound_ms": nbytes(p["moe"]) / rate * 1e3,
           "vocab_bound_ms": nbytes(params["lm_head"]) / rate * 1e3}
    print(f"  prefill, one layer: attention {out['prefill_attn_ms']:.2f} "
          f"ms, MoE FFN {out['prefill_ffn_ms']:.2f} ms (f32 bound "
          f"{out['prefill_ffn_bound_ms']:.2f}, {C} slots an expert)")
    print(f"  decode step ({L} layers) {out['decode_step_ms']:.3f} ms; "
          f"alone, a layer's attention {out['decode_attn_ms']:.3f}, its MoE "
          f"FFN {out['decode_ffn_ms']:.3f}, the vocabulary "
          f"{out['vocab_ms']:.3f} (bounds {out['decode_attn_bound_ms']:.3f}, "
          f"{out['decode_ffn_bound_ms']:.3f}, {out['vocab_bound_ms']:.3f})")
    return out


def prefill_ref_by_head(q, k, v, window):
    """``swa_attention.ref.prefill_ref`` one (sequence, kv head) at a
    time: the same function, without its (B, KV, G, S, S) scores at
    once (17 GB at mixtral's serve prefill)."""
    from repro_torch.kernels.swa_attention import ref as sref

    out = torch.empty(q.shape, device=q.device)
    for b in range(q.shape[0]):
        for h in range(q.shape[1]):
            out[b, h] = sref.prefill_ref(
                q[b:b + 1, h:h + 1], k[b:b + 1, :, h:h + 1],
                v[b:b + 1, :, h:h + 1], window=window)[0, 0]
    return out


def moe_serve_path(dev, spec, errs: Errors):
    """A MoE config at its published widths through ``launch.serve.run``
    (``MOE_SERVE``). Launch counts: one ``swa_prefill`` a local layer and
    one ``flash_fwd`` a global layer in prefill, one ``swa_decode`` a
    layer a token (MLA's decode runs no kernel). Prefill's logits against
    one ``forward_hidden`` of the prompt (the same tokens, so the same
    expert capacity; 2e-4 x max|logits|). The last decode step again on
    a copy of the final cache by the other route — the plain attention
    (mixtral) or the absorbed MLA form (deepseek) — within
    ``MOE_DECODE_TOL`` x max|logits|, the same greedy tokens; mixtral's
    ``swa_decode`` against the plain decode attention on a real ring
    cache (1e-4), and its ``swa_prefill`` against the plain version on
    random heads at the prompt's shape (the band wraps the rings;
    ``FLASH_TOL``)."""
    from repro_torch import tree as tu
    from repro_torch.kernels.flash_attention import flash as ff
    from repro_torch.kernels.swa_attention import ops as sops
    from repro_torch.kernels.swa_attention import swa as sk
    from repro_torch.launch import serve
    from repro_torch.models import attention as A
    from repro_torch.models import transformer as T
    from repro_torch.sharding.ctx import ShardCtx

    s = spec
    sk.reset_launch_counts()
    ff.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = serve.run(s["arch"], use_reduced=False, n_layers=s["n_layers"],
                    batch=s["batch"], prompt_len=s["prompt_len"],
                    gen=s["gen"], seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {**sk.launch_counts(), **ff.launch_counts()}
    peak = torch.cuda.max_memory_allocated()
    cfg, params = res["cfg"], res["params"]
    mla = cfg.mla is not None
    n_local = sum(k == "local" for k in cfg.layer_kinds())
    print(f"  {cfg.name} serve run ({cfg.n_layers} layers): {wall:.1f} s; "
          f"launches {counts}; peak {peak / 1e9:.2f} GB")
    want = {"swa_prefill": n_local, "flash_fwd": cfg.n_layers - n_local,
            "swa_decode": 0 if mla else cfg.n_layers * s["gen"],
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    check(counts == want, f"{cfg.name} serve launches {counts} != {want}")
    P_L, L = s["prompt_len"], s["prompt_len"] + s["gen"]
    param_bytes = sum(t.numel() * t.element_size()
                      for t in tu.leaves(params))
    err_c = None
    with torch.inference_mode():
        h = T.forward_hidden(params, cfg, res["prompts"],
                             ctx=ShardCtx(attn_backend="flash"))
        want_p = (h[:, -1] @ params["lm_head"]).float()
        del h
        err_p = float((res["prefill_logits"] - want_p).abs().max())
        tol_p = SERVE_PREFILL_TOL * float(want_p.abs().max())
        del want_p
        other = (ShardCtx(mla_absorb=True) if mla
                 else ShardCtx(attn_backend="blockwise"))
        cache = tu.tree_map(lambda t: t.clone(), res["cache"])
        logits2, _ = T.decode_step(params, cfg, res["tokens"][:, -1:], cache,
                                   L - 1, ctx=other)
        err_d = float((logits2 - res["logits"]).abs().max())
        tol_d = MOE_DECODE_TOL * float(res["logits"].abs().max())
        same = bool(torch.equal(logits2.argmax(-1), res["logits"].argmax(-1)))
        del cache, logits2
        route = "the absorbed MLA form" if mla else "the plain attention"
        print(f"  prefill logits vs forward_hidden: max |diff| {err_p:.3e} "
              f"(tol {tol_p:.3e}); the last decode step by {route}: "
              f"{err_d:.3e} (tol {tol_d:.3e}), same greedy tokens: {same}")
        check(err_p <= tol_p, f"prefill logits off by {err_p} > {tol_p}")
        check(err_d <= tol_d and same,
              f"decode by {route} off by {err_d} > {tol_d} ({same})")
        if not mla:
            c = res["cache"]["units"]["b0"]
            ck, cv = c["k"][0], c["v"][0]
            W = ck.shape[1]
            g = torch.Generator(device=dev).manual_seed(5)
            q = torch.randn(s["batch"], cfg.n_heads, cfg.resolved_head_dim,
                            generator=g, device=dev)
            kp = A.ring_positions(L - 1, W, device=dev)
            got = sops.decode_attention(q, ck, cv, kp, L - 1,
                                        window=cfg.window)
            ref = A.decode_attention(q, ck, cv, kp, L - 1, window=cfg.window)
            err_c = float((got - ref).abs().max())
            print(f"  swa_decode vs decode_attention on the ring cache "
                  f"{tuple(ck.shape)}: max |diff| {err_c:.3e} (tol "
                  f"{SERVE_KERNEL_TOL:g})")
            check(err_c <= SERVE_KERNEL_TOL,
                  f"swa_decode on the ring cache: {err_c}")
            del c, ck, cv
        breakdown = moe_breakdown(params, cfg, res, res["prompts"])
    check(all(bool(torch.isfinite(x).all())
              for x in (res["prefill_logits"], res["logits"])),
          "non-finite logits")
    info = {"arch": cfg.name, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "n_heads": cfg.n_heads,
            "n_kv_heads": cfg.n_kv_heads, "n_experts": cfg.moe.n_experts,
            "top_k": cfg.moe.top_k, "mla": mla,
            "vocab": cfg.vocab_size, "batch": s["batch"],
            "prompt_len": P_L, "gen": s["gen"], "param_bytes": param_bytes,
            "run_wall_s": wall, "prefill_s": res["prefill_s"],
            "decode_first_s": res["decode_first_s"],
            "decode_ms_per_token": res["decode_ms_per_token"],
            "decode_bound_ms": param_bytes / hbm_rate(
                torch.cuda.get_device_name(0)) * 1e3,
            "max_memory_allocated": peak, "launches": counts,
            "prefill_logits_err": err_p, "decode_other_route_err": err_d,
            "kernel_vs_plain_on_cache": err_c, "breakdown": breakdown}
    print(json.dumps({"moe_serve_path": info}))
    del res, params
    free_device()
    if not mla:
        g = torch.Generator(device=dev).manual_seed(6)
        B, KV, hd = s["batch"], cfg.n_kv_heads, cfg.resolved_head_dim
        G = cfg.n_heads // KV
        q = torch.randn(B, KV, G, P_L, hd, generator=g, device=dev)
        k = torch.randn(B, P_L, KV, hd, generator=g, device=dev)
        v = torch.randn(B, P_L, KV, hd, generator=g, device=dev)
        got = sk.swa_prefill(q, k, v, window=cfg.window)
        want = prefill_ref_by_head(q, k, v, cfg.window)
        errs.hold("swa_prefill", got, want, finite_scale(want),
                  f"{cfg.name} B={B} KV={KV} G={G} S={P_L} w={cfg.window}",
                  FLASH_TOL)
        del q, k, v, got, want
        free_device()
    return counts, info


def cohort_data(t, K):
    """Token data of a FedADP cohort of K clients (``t``'s vocabulary,
    sequence length and clients' sample count) from ``default_rng(0)``:
    (data, test, iid partition)."""
    from repro_torch.data import iid_partition

    n = t["n_per_client"] * K
    rng = np.random.default_rng(0)
    toks = rng.integers(0, t["vocab"],
                        size=(n, t["S"] + 1)).astype(np.int32)
    data = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    test = {"tokens": toks[:4, :-1], "labels": toks[:4, 1:]}
    parts = iid_partition(n, K, seed=0)
    return data, test, parts


def attn_layers(cfg):
    """(local, global) attention layers of a config."""
    kinds = cfg.layer_kinds()
    return kinds.count("local"), kinds.count("global")


def fedadp_round(dev, family, cfgs, engine, t, launches, k_chunk=None,
                 tag="cohort_run"):
    """One fedadp filler round of ``cfgs`` on ``engine`` (``t``: the
    cohort's data and batch), its flash, swa, aggregation and
    ``widen_2d`` launches held to the cohort's and added to
    ``launches``. Training launches one of each flash kernel an
    attention layer a step (for each chunk of the stacked cohort on the
    unified engine); the eval, with no gradient, one banded swa_prefill
    a local layer and one flash_fwd a global layer for each client view.
    Returns (result, resolved engine, info, embedding seed, test
    data)."""
    from repro_torch import tree as tu
    from repro_torch.core import PlaneSpec
    from repro_torch.core.netchange import round_embed_seed
    from repro_torch.data import ClientSampler
    from repro_torch.fl import FLRunConfig, Simulator
    from repro_torch.kernels.fedavg import fedavg as fk
    from repro_torch.kernels.flash_attention import flash as ff
    from repro_torch.kernels.netchange import widen as wk
    from repro_torch.kernels.swa_attention import swa as sk

    mods = (fk, ff, sk, wk)
    data, test, parts = cohort_data(t, len(cfgs))
    samplers = [ClientSampler(data, p, round_fraction=0.5,
                              batch_size=t["batch"], seed=i)
                for i, p in enumerate(parts)]
    rc = FLRunConfig(method="fedadp", rounds=1, local_epochs=1, lr=0.05,
                     momentum=0.0, seed=0, eval_every=1, engine=engine,
                     k_chunk=k_chunk)
    fed = Simulator(family, cfgs, samplers, rc, test)._build()
    ueng = getattr(fed.backend, "engine", None)     # the unified one
    train_s = [0.0]
    if ueng is not None:
        ueng.timing = True
    else:
        # the loop's local training, timed between synchronisations
        inner = fed.backend._local_train

        def timed(k, params):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner(k, params)
            torch.cuda.synchronize()
            train_s[0] += time.perf_counter() - t0
            return out
        fed.backend._local_train = timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for m in mods:
        m.reset_launch_counts()
    t0 = time.perf_counter()
    res = fed.run(torch.Generator().manual_seed(rc.seed))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v for m in mods for k, v in m.launch_counts().items()}
    for k, v in counts.items():
        launches[k] += v
    gcfg = family.union(cfgs)
    steps = samplers[0].steps_per_epoch()
    kind = fed.backend.name
    if kind == "loop":
        views = [attn_layers(c) for c in cfgs]
        trained = views
        seed = rc.resolved_embed_seed
        up_r0, down_r0 = netchange_launches(
            family, cfgs, gcfg, dev, lambda k: round_embed_seed(seed, 0,
                                                                k))
        _, down_r1 = netchange_launches(
            family, cfgs, gcfg, dev, lambda k: round_embed_seed(seed, 1,
                                                                k))
        widen = sum(down_r0) + sum(up_r0) + 2 * sum(down_r1)
        P = PlaneSpec.from_tree(family.shapes(gcfg)).size
        agg = ({"plane_accum": -(-len(cfgs) // k_chunk)} if k_chunk
               else fedavg_expected(len(cfgs), P))
    else:
        # one launch a layer a step for each chunk of the stacked
        # cohort; a depth-only round start pads and slices: no
        # widening
        chunks = -(-len(cfgs) // (k_chunk or len(cfgs)))
        trained = [attn_layers(gcfg)] * chunks
        views = [attn_layers(gcfg)] * len(cfgs)
        widen = 0
        agg = {"plane_accum": chunks}
    want = dict.fromkeys(launches, 0)
    want.update(agg)
    want["widen_2d"] = widen
    # training: one of each flash kernel an attention layer a step (the
    # local layers' window in flash_fwd); the eval, with no gradient, one
    # banded swa_prefill a local layer and one flash_fwd a global layer
    # for each client view
    train = steps * sum(lo + gl for lo, gl in trained)
    want["flash_bwd_dq"] = want["flash_bwd_dkv"] = train
    want["flash_fwd"] = train + sum(gl for _, gl in views)
    want["swa_prefill"] = sum(lo for lo, _ in views)
    info = {"engine": engine, "resolved": kind,
            "clients": [c.name for c in cfgs], "P": PlaneSpec.from_tree(
                family.shapes(gcfg)).size,
            "steps": steps, "run_wall_s": wall,
            "phase_stats": (ueng.phase_stats() if ueng is not None
                            else {"train": train_s[0]}),
            "history": res["history"],
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "launches": counts, "expected": want}
    print(json.dumps({tag: info}))
    check(counts == want, f"{engine}/{kind}: launches {counts} != {want}")
    check(all(math.isfinite(a) for a in res["history"]),
          f"{engine}: non-finite eval loss {res['history']}")
    check(all(bool(torch.isfinite(x).all())
              for x in tu.leaves(res["global_params"])),
          f"{engine}: non-finite global params")
    del fed, ueng
    return res, kind, info, rc.resolved_embed_seed, test


def moe_cohort_path(dev, errs: Errors):
    """The mixtral FedADP cohort (``MOE_COHORT``), one fedadp filler
    round a run. (a) clients of 2, 4 and 8 experts, ``engine="auto"``
    (must resolve to the loop: expert count is not segment-
    representable); (b) a depth-only
    cohort of 1 and 2 layers on 3 experts (top-2) on the unified engine
    (``"auto"`` must take it; one client a chunk) and on the loop from
    the same init and data: globals within ``FEDADP_LOOP_TOL``. Every run's flash, aggregation and
    ``widen_2d`` launches must equal the cohort's (steps and evals by
    layers and chunks; ``fedavg_expected``; ``netchange_launches``). For every
    client of (a), its round's model in its own architecture against its
    embedding in the union's (test logits): within ``EMBED_TOL`` x
    max|logits| for the clients the union does not widen (8 experts),
    printed for the widened ones (exact only under soft routing). First
    the three flash kernels against their plain versions at the shapes
    the cohort gives them (a client's batch on the loop, the two
    clients' batches folded into one on the unified engine; the window
    of 4096 spans the 2048 tokens)."""
    from repro_torch import tree as tu
    from repro_torch.configs import get_config
    from repro_torch.core import TransformerFamily, tfamily
    from repro_torch.kernels.fedavg import fedavg as fk
    from repro_torch.kernels.flash_attention import flash as ff
    from repro_torch.kernels.netchange import widen as wk
    from repro_torch.kernels.swa_attention import swa as sk
    from repro_torch.models import transformer as T

    warnings.filterwarnings("error", message=".*batching rule.*")
    t = MOE_COHORT
    family = TransformerFamily()
    base = dataclasses.replace(get_config(t["arch"]), vocab_size=t["vocab"])
    gen = torch.Generator(device=dev).manual_seed(20)
    KV = base.n_kv_heads
    for B in (t["batch"], len(t["unified_layers"]) * t["batch"]):
        flash_case(dev, gen, errs, f"mixtral cohort B={B} S={t['S']} "
                   f"w={base.window}", B=B, KV=KV, G=base.n_heads // KV,
                   Sq=t["S"], Sk=t["S"], hd=base.resolved_head_dim,
                   window=base.window)
    free_device()
    launches = {k: 0 for m in (fk, ff, sk, wk) for k in m.KERNELS}

    def run(cfgs, engine, k_chunk=None):
        return fedadp_round(dev, family, cfgs, engine, t, launches, k_chunk,
                            tag="moe_cohort_run")

    # (a) the expert-count cohort on the loop, once: a second run held
    # bit-equal did not fit the script's time limit (tests/test_torch_moe.py
    # holds two calls bit-equal; ep_path holds the card's MoE forward
    # bit-equal across processes)
    base1 = dataclasses.replace(base, n_layers=1)
    cfgs_a = [tfamily.make_variant(base1, n_experts=e)
              for e in t["loop_experts"]]
    gcfg_a = family.union(cfgs_a)
    res, kind, info_a, seed, test = run(cfgs_a, "auto", t["loop_k_chunk"])
    check(kind == "loop", f"engine='auto' took {kind} on an expert-count "
          f"cohort")
    x1 = torch.as_tensor(test["tokens"][:1], device=dev)
    emb = []
    with torch.inference_mode():
        for k, (p, cfg) in enumerate(zip(res["client_params"], cfgs_a)):
            own = T.forward(p, cfg, x1)
            up = family.up(p, cfg, gcfg_a, seed=seed)
            union = T.forward(up, gcfg_a, x1)
            del up
            emb.append(float((union - own).abs().max())
                       / float(own.abs().max()))
            del own, union
    del res, p
    free_device()
    widened = [c.moe.n_experts < gcfg_a.moe.n_experts for c in cfgs_a]
    held = max(e for e, w in zip(emb, widened) if not w)
    print(f"  expert-count cohort: a client's round model vs its union "
          f"embedding, max |diff| / max|logits|: "
          + ", ".join(f"{c.moe.n_experts} experts {e:.3e}"
                      for c, e in zip(cfgs_a, emb))
          + f" (tol {EMBED_TOL:g} on the {sum(not w for w in widened)} "
          f"clients the union does not widen; the widened ones measured: "
          f"top-{gcfg_a.moe.top_k} routing can give both halves of a "
          f"split expert a token's two slots)")
    check(held <= EMBED_TOL, f"an unwidened client's embedding is off by "
          f"{held}")
    # (b) the depth-only cohort on both engines
    base_b = dataclasses.replace(
        base, n_layers=max(t["unified_layers"]),
        moe=dataclasses.replace(base.moe, n_experts=t["unified_experts"]))
    cfgs_b = [tfamily.make_variant(base_b, n_units=n)
              for n in t["unified_layers"]]
    res_u, kind, info_u, _, _ = run(cfgs_b, "auto", t["unified_k_chunk"])
    check(kind == "unified", f"engine='auto' took {kind} on a depth cohort")
    gu = [x.detach().to("cpu", copy=True)
          for x in tu.leaves(res_u["global_params"])]
    del res_u
    free_device()
    res_l, kind, info_l, _, _ = run(cfgs_b, "loop")
    diff = max(float((a - b.cpu()).abs().max())
               for a, b in zip(gu, tu.leaves(res_l["global_params"])))
    print(f"  depth cohort: loop vs unified global params, max |diff| = "
          f"{diff:.3e} (tol {FEDADP_LOOP_TOL:g})")
    check(diff <= FEDADP_LOOP_TOL, f"depth cohort: loop != unified: {diff}")
    del res_l, gu
    free_device()
    return launches, {"expert_count_loop": info_a,
                      "embedding_rel_err": emb,
                      "depth_unified": info_u, "depth_loop": info_l,
                      "depth_loop_vs_unified": diff}


def moe_trainer_path(dev):
    """``launch.train.run`` on deepseek-v2-236b (``MOE_TRAIN``: 1 of 60
    layers, 16 of 160 routed experts, the whole vocabulary): one
    blockwise step for the reference loss, then the steps through the
    flash kernels at head dim 192 (one forward and one of each backward
    kernel a layer a step). The first loss must match the blockwise one
    within ``TRAIN_LOSS_TOL`` x the loss, every loss be finite."""
    from repro_torch.kernels.flash_attention import flash as ff
    from repro_torch.launch import train

    t = MOE_TRAIN
    kw = dict(use_reduced=False, n_layers=t["n_layers"],
              n_experts=t["n_experts"], batch=t["batch"], seq=t["seq"],
              lr=t["lr"], seed=0, device=dev, log_every=t["steps"])
    ff.reset_launch_counts()
    ref = train.run(t["arch"], steps=1, attn="blockwise", **kw)
    loss_b = ref["losses"][0]
    check(sum(ff.launch_counts().values()) == 0,
          f"the blockwise step launched {ff.launch_counts()}")
    del ref
    free_device()
    ff.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = train.run(t["arch"], steps=t["steps"], attn="auto", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ff.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = res["losses"]
    n = t["steps"] * t["n_layers"]
    check(counts == dict.fromkeys(ff.KERNELS, n),
          f"trainer launches {counts}, expected {n} of each")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    err = abs(losses[0] - loss_b)
    print(f"  deepseek trainer: first loss {losses[0]:.6f} (blockwise "
          f"{loss_b:.6f}, |diff| {err:.3e}, tol "
          f"{TRAIN_LOSS_TOL * abs(loss_b):.3e}); last {losses[-1]:.6f}; "
          f"{res['ms_per_step']:.1f} ms/step; peak {peak / 1e9:.2f} GB")
    check(err <= TRAIN_LOSS_TOL * abs(loss_b),
          f"first loss {losses[0]} vs blockwise {loss_b}")
    info = {**t, "losses": losses, "blockwise_first_loss": loss_b,
            "ms_per_step": res["ms_per_step"], "run_wall_s": wall,
            "max_memory_allocated": peak, "launches": counts}
    print(json.dumps({"moe_trainer_path": info}))
    del res
    free_device()
    return counts, info


# ------------------------------------------------------ the recurrent family
def recurrent_kernel_phase(dev, errs: Errors):
    """``swa_decode`` and the flash pair at recurrentgemma-9b's shapes
    (MQA: one kv head of 16 query heads, hd 256, window 2048) against
    their plain versions, then timed beside their bounds, the plain
    versions and the memory-efficient backend: ``swa_decode`` on the
    wrapped ring of the serve run's last token (``RG_DECODE``; its bound
    reads the cache once, where the kernel's four clusters each read
    it), the flash pair at the unified cohort's chunk (``RG_COHORT``: B
    = k_chunk x batch, S 4096, the window cutting in)."""
    from repro_torch.kernels.flash_attention import flash as ff
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.swa_attention import ref as sref
    from repro_torch.kernels.swa_attention import swa as sk

    gen = torch.Generator(device=dev).manual_seed(23)
    rows = {}
    f32 = 4
    m = RG_DECODE
    B, KV, G, hd, W, qp = (m["B"], m["KV"], m["G"], m["hd"], m["window"],
                           m["q_pos"])
    H = KV * G
    q, k, v, kp = decode_case(dev, gen, errs, f"recurrentgemma decode ring "
                              f"W={W}", B=B, KV=KV, G=G, hd=hd, S=W,
                              window=W, q_pos=qp, kind="ring")
    qh = q.reshape(B, H, 1, hd)
    kh = k.permute(0, 2, 1, 3).repeat_interleave(G, 1)
    vh = v.permute(0, 2, 1, 3).repeat_interleave(G, 1)
    cache_bytes = 2 * B * W * KV * hd * f32
    name = f"swa_decode recurrentgemma B={B} KV={KV} G={G} W={W}"
    time_row(rows, name, lambda: sk.swa_decode(q, k, v, kp, qp, window=W),
             None, lambda: sref.decode_ref(q, k, v, kp, qp, window=W),
             cache_bytes + 2 * B * H * hd * f32 + W * 4,
             4 * B * H * hd * W, lambda: efficient_sdpa(qh, kh, vh),
             card=with_copies(lambda kk, vv: sk.swa_decode(
                 q, kk, vv, kp, qp, window=W), k, v))
    # the kernel as launched: G / 4 clusters read each kv head's cache
    rows[name]["cache_reads"] = G // 4
    rows[name]["launched_bytes"] = (G // 4) * cache_bytes
    del q, k, v, kp, qh, kh, vh
    torch.cuda.empty_cache()

    c = RG_COHORT
    B, S = c["k_chunk"] * c["batch"], c["S"]
    q, k, v, dout, qpos, kpos, out, lse, delta = flash_case(
        dev, gen, errs, f"recurrentgemma cohort B={B} S={S} w={W}", B=B,
        KV=KV, G=G, Sq=S, Sk=S, hd=hd, window=W)
    torch.cuda.empty_cache()
    args = (q, k, v, qpos, kpos, lse, delta, dout)
    kw = dict(window=W)
    pairs = band_pairs(S, W) * B * H
    qb, kb, rowb = B * H * S * hd * f32, B * KV * S * hd * f32, B * H * S * f32
    qh = q.reshape(B, H, S, hd)
    ke = k.permute(0, 2, 1, 3).repeat_interleave(G, 1)
    ve = v.permute(0, 2, 1, 3).repeat_interleave(G, 1)
    pos = torch.arange(S, device=dev)
    band = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < W)
    qe, kee, vee = (x.clone().requires_grad_() for x in (qh, ke, ve))
    try:
        oe = efficient_sdpa(qe, kee, vee, attn_mask=band)
        eff_bwd = lambda: torch.autograd.grad(  # noqa: E731
            oe, (qe, kee, vee), dout.reshape(B, H, S, hd), retain_graph=True)
        eff_bwd()
    except RuntimeError as e:
        print(f"  efficient backend refused the banded backward: "
              f"{str(e).splitlines()[0]}")
        eff_bwd = None
    tag = f"recurrentgemma B={B} KV={KV} G={G} S={S} w={W}"
    time_row(rows, f"flash_fwd {tag}",
             lambda: ff.flash_fwd(q, k, v, qpos, kpos, **kw), None,
             lambda: fref.flash_fwd_ref(q, k, v, qpos, kpos, **kw),
             2 * qb + 2 * kb + rowb, 4 * hd * pairs,
             lambda: efficient_sdpa(qh, ke, ve, attn_mask=band), True,
             reps=5, plain_reps=2)
    plain_bwd = lambda: fref.flash_bwd_ref(  # noqa: E731
        q, k, v, qpos, kpos, out, lse, dout, **kw)
    time_row(rows, f"flash_bwd_dq {tag}",
             lambda: ff.flash_bwd_dq(*args, **kw), None, plain_bwd,
             3 * qb + 2 * kb + 2 * rowb, 6 * hd * pairs, eff_bwd, True,
             reps=5, plain_reps=2)
    time_row(rows, f"flash_bwd_dkv {tag}",
             lambda: ff.flash_bwd_dkv(*args, **kw), None, plain_bwd,
             2 * qb + 4 * kb + 2 * rowb, 8 * hd * pairs, eff_bwd, True,
             reps=5, plain_reps=2)
    for r in list(rows.values())[-3:]:
        r["visible_pairs"] = pairs
    del q, k, v, dout, out, lse, delta, args, qh, ke, ve, band, qe, kee, vee
    eff_bwd = plain_bwd = oe = None
    free_device()
    print(json.dumps({"recurrent_variants": rows}))
    return rows


def recurrent_layer_ms(params, cfg, B, S, dev):
    """Each layer kind's full-sequence apply at (B, S), timed alone
    (unit 0's block, one warm-up call, the mean of 3, no gradient)."""
    from repro_torch import tree as tu
    from repro_torch.models import transformer as T
    from repro_torch.sharding.ctx import ShardCtx

    out = {}
    gen = torch.Generator(device=dev).manual_seed(29)
    x = torch.randn(B, S, cfg.d_model, generator=gen, device=dev)
    positions = torch.arange(S, device=dev)
    with torch.inference_mode():
        for i, kind in enumerate(cfg.layer_pattern):
            if kind in out:
                continue
            blk = tu.tree_map(lambda t: t[0], params["units"][f"b{i}"])
            out[kind] = cuda_ms(lambda: T.block_apply_seq(
                blk, cfg, kind, x, positions, ctx=ShardCtx()), reps=3)
    print(f"  {cfg.name} one layer's prefill alone (B={B}, S={S}): "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in out.items()))
    return out


def recurrent_serve_path(dev, spec, errs: Errors):
    """A recurrent config, whole and at its published widths, through
    ``launch.serve.run``: the launch counts show every attention layer in
    the kernels (one ``swa_prefill`` a local layer in prefill, one
    ``swa_decode`` an attention layer a token; xlstm-125m has none); the
    prefill's and the last step's logits are held against one
    ``forward_hidden`` of prompt + generated tokens (the recurrent states
    carried from prefill through every decode step), ``swa_decode``
    against the model's plain decode attention on a real ring cache.
    Prints decode ms a token beside its bound (the weights read once a
    token over the HBM rate) and each layer kind's prefill timed
    alone."""
    from repro_torch import tree as tu
    from repro_torch.kernels.flash_attention import flash as ff
    from repro_torch.kernels.swa_attention import ops as sops
    from repro_torch.kernels.swa_attention import swa as sk
    from repro_torch.launch import serve
    from repro_torch.models import attention as A
    from repro_torch.models import transformer as T
    from repro_torch.sharding.ctx import ShardCtx

    s = spec
    sk.reset_launch_counts()
    ff.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = serve.run(s["arch"], use_reduced=False, batch=s["batch"],
                    n_layers=s.get("n_layers"), prompt_len=s["prompt_len"],
                    gen=s["gen"], seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {**sk.launch_counts(), **ff.launch_counts()}
    peak = torch.cuda.max_memory_allocated()
    cfg, params = res["cfg"], res["params"]
    n_local, n_global = attn_layers(cfg)
    print(f"  {cfg.name} serve run ({cfg.n_layers} layers, {n_local} local)"
          f": {wall:.1f} s; launches {counts}; peak {peak / 1e9:.2f} GB")
    want = dict.fromkeys(counts, 0)
    want.update(swa_prefill=n_local, flash_fwd=n_global,
                swa_decode=(n_local + n_global) * s["gen"])
    check(counts == want, f"{cfg.name} serving launches {counts} != {want}")
    P_L, L = s["prompt_len"], s["prompt_len"] + s["gen"]
    param_bytes = sum(t.numel() * t.element_size()
                      for t in tu.leaves(params))
    err_c = None
    with torch.inference_mode():
        seq = torch.cat([res["prompts"], res["tokens"]], dim=1)
        h = T.forward_hidden(params, cfg, seq,
                             ctx=ShardCtx(attn_backend="flash"))
        w_out = params["embed"].t()                  # tied embeddings
        want_p = (h[:, P_L - 1] @ w_out).float()
        want_d = (h[:, -1] @ w_out).float()
        del h, seq
        err_p = float((res["prefill_logits"] - want_p).abs().max())
        tol_p = SERVE_PREFILL_TOL * float(want_p.abs().max())
        err_d = float((res["logits"] - want_d).abs().max())
        tol_d = SERVE_DECODE_TOL * float(want_d.abs().max())
        print(f"  prefill logits vs forward_hidden: max |diff| {err_p:.3e} "
              f"(tol {tol_p:.3e}); last decode logits vs forward_hidden of "
              f"{L} tokens: {err_d:.3e} (tol {tol_d:.3e})")
        check(err_p <= tol_p, f"prefill logits off by {err_p} > {tol_p}")
        check(err_d <= tol_d, f"decode logits off by {err_d} > {tol_d}")
        del want_p, want_d
        if n_local:
            i = cfg.layer_pattern.index("local")
            c = res["cache"]["units"][f"b{i}"]
            ck, cv = c["k"][0], c["v"][0]
            W = ck.shape[1]
            check(P_L > W, f"the prompt of {P_L} does not wrap the ring")
            gen = torch.Generator(device=dev).manual_seed(5)
            q = torch.randn(s["batch"], cfg.n_heads, cfg.resolved_head_dim,
                            generator=gen, device=dev)
            kp = A.ring_positions(L - 1, W, device=dev)
            got = sops.decode_attention(q, ck, cv, kp, L - 1, window=W)
            ref = A.decode_attention(q, ck, cv, kp, L - 1, window=W)
            err_c = float((got - ref).abs().max())
            print(f"  swa_decode vs decode_attention on the ring cache "
                  f"{tuple(ck.shape)}: max |diff| {err_c:.3e} "
                  f"(tol {SERVE_KERNEL_TOL:g})")
            check(err_c <= SERVE_KERNEL_TOL,
                  f"swa_decode on the cache: {err_c}")
            errs.max["swa_decode"] = max(errs.max.get("swa_decode", 0.0),
                                         err_c)
            del c, ck, cv, q, got, ref
    check(all(bool(torch.isfinite(x).all())
              for x in (res["prefill_logits"], res["logits"])),
          "non-finite logits")
    bound = param_bytes / hbm_rate(torch.cuda.get_device_name(0)) * 1e3
    print(f"  {cfg.name} decode: {res['decode_ms_per_token']:.2f} ms a "
          f"token (bound {bound:.2f} ms: {param_bytes / 1e9:.2f} GB of "
          f"weights read once a token)")
    layer_ms = recurrent_layer_ms(params, cfg, s["batch"], P_L, dev)
    info = {"arch": cfg.name, "n_layers": cfg.n_layers,
            "layer_pattern": list(cfg.layer_pattern),
            "d_model": cfg.d_model, "d_rnn": cfg.d_rnn,
            "vocab": cfg.vocab_size, "batch": s["batch"],
            "prompt_len": P_L, "gen": s["gen"], "param_bytes": param_bytes,
            "run_wall_s": wall, "prefill_s": res["prefill_s"],
            "decode_first_s": res["decode_first_s"],
            "decode_ms_per_token": res["decode_ms_per_token"],
            "decode_bound_ms": bound, "max_memory_allocated": peak,
            "launches": counts, "prefill_logits_err": err_p,
            "decode_logits_err": err_d, "kernel_vs_plain_on_cache": err_c,
            "layer_prefill_ms": layer_ms}
    print(json.dumps({"recurrent_serve_path": info}))
    del res, params
    free_device()
    return counts, info


def rg_cohort_path(dev, errs: Errors):
    """The recurrentgemma-9b FedADP cohort. (a) ``RG_COHORT`` on the
    unified engine: one f32 round through the flash kernels (one of each
    a local layer a step for each chunk; the eval's banded
    ``swa_prefill`` a client view) held against a blockwise round from
    the same init and data (``TFFN_TOL``); ``widen_2d`` widens the
    half-width clients' FFNs. (b) ``RG_LOOP``, a d_rnn pair, with
    ``engine="auto"`` (must resolve to the loop; once: a second run held
    bit-equal did not fit the script's time limit), every
    launch the cohort's (``fedadp_round``: ``widen_2d`` moves only the
    RG-LRU leaves here), each client's round model against its embedding
    in the union (``EMBED_TOL`` x max|logits|: widening d_rnn is
    exact)."""
    from repro_torch import tree as tu
    from repro_torch.configs import get_config
    from repro_torch.core import TransformerFamily, tfamily
    from repro_torch.kernels.fedavg import fedavg as fk
    from repro_torch.kernels.flash_attention import flash as ff
    from repro_torch.kernels.netchange import widen as wk
    from repro_torch.kernels.swa_attention import swa as sk
    from repro_torch.models import transformer as T

    t = RG_COHORT
    launches = {k: 0 for m in (fk, ff, sk, wk) for k in m.KERNELS}
    sk.reset_launch_counts()
    res, info, counts, _, _ = tffn_run("auto", 1, k_chunk=t["k_chunk"],
                                       t=t)
    counts = {**counts, **sk.launch_counts()}
    for k, v in counts.items():
        launches[k] += v
    chunks = -(-t["K"] // t["k_chunk"])
    n_local = attn_layers(dataclasses.replace(get_config(t["arch"]),
                                              n_layers=t["n_layers"]))[0]
    train = info["steps_per_round"] * chunks * n_local
    evals = len(info["history"]) * t["K"] * n_local
    check(counts["flash_bwd_dq"] == counts["flash_bwd_dkv"]
          == counts["flash_fwd"] == train,
          f"flash launches {counts} != {train} (steps x chunks x local "
          f"layers)")
    check(counts["swa_prefill"] == evals,
          f"eval launches {counts['swa_prefill']} != {evals}")
    check(counts["widen_2d"] > 0, "the cohort's round start never widened")
    g32 = [x.detach().to("cpu", copy=True)
           for x in tu.leaves(res["global_params"])]
    del res
    free_device()
    res_b, info_b, _, _, _ = tffn_run("blockwise", 1,
                                      k_chunk=t["k_chunk"], t=t)
    diff = max(float((a - b.cpu()).abs().max())
               for a, b in zip(g32, tu.leaves(res_b["global_params"])))
    print(f"  recurrentgemma cohort: flash vs blockwise round: max |diff| "
          f"of global params = {diff:.3e} (tol {TFFN_TOL:g})")
    check(diff <= TFFN_TOL, f"flash round != blockwise round: {diff}")
    del res_b, g32
    free_device()

    # (b) the d_rnn pair on the loop
    lt = RG_LOOP
    family = TransformerFamily()
    base = dataclasses.replace(get_config(lt["arch"]), n_layers=3,
                               vocab_size=lt["vocab"])
    cfgs = [tfamily.make_variant(base, d_rnn=r) for r in lt["d_rnn"]]
    gcfg = family.union(cfgs)
    res, kind, info_l, seed, test = fedadp_round(
        dev, family, cfgs, "auto", lt, launches, tag="rg_loop_run")
    check(kind == "loop", f"engine='auto' took {kind} on a d_rnn cohort")
    check(info_l["expected"]["widen_2d"] > 0,
          "the d_rnn cohort's round never widened the RG-LRU leaves")
    x1 = torch.as_tensor(test["tokens"][:1], device=dev)
    emb = []
    with torch.inference_mode():
        for p, cfg in zip(res["client_params"], cfgs):
            own = T.forward(p, cfg, x1)
            union = T.forward(family.up(p, cfg, gcfg, seed=seed), gcfg, x1)
            emb.append(float((union - own).abs().max())
                       / float(own.abs().max()))
            del own, union
    del res, p
    free_device()
    print(f"  d_rnn cohort: a client's round model vs its union embedding, "
          f"max |diff| / max|logits|: "
          + ", ".join(f"d_rnn {c.d_rnn} {e:.3e}" for c, e in zip(cfgs, emb))
          + f" (tol {EMBED_TOL:g})")
    check(max(emb) <= EMBED_TOL, f"a client's embedding is off by {emb}")
    return launches, {"unified_f32": info, "unified_blockwise": info_b,
                      "flash_vs_blockwise": diff, "loop": info_l,
                      "embedding_rel_err": emb}


def xlstm_cohort_path(dev):
    """xlstm-125m's depth cohort (``XL_COHORT``: 1 and 3 units, the
    whole vocabulary) one fedadp filler round on the unified engine
    (``"auto"`` must take it; both clients in one chunk) and on the loop from
    the same init and data: globals within ``FEDADP_LOOP_TOL``; every
    launch the cohort's (aggregation only: no attention, no widening)."""
    from repro_torch import tree as tu
    from repro_torch.configs import get_config
    from repro_torch.core import TransformerFamily, tfamily
    from repro_torch.kernels.fedavg import fedavg as fk
    from repro_torch.kernels.flash_attention import flash as ff
    from repro_torch.kernels.netchange import widen as wk
    from repro_torch.kernels.swa_attention import swa as sk

    t = XL_COHORT
    family = TransformerFamily()
    launches = {k: 0 for m in (fk, ff, sk, wk) for k in m.KERNELS}
    base = get_config(t["arch"])
    cfgs = [tfamily.make_variant(base, n_units=u) for u in t["units"]]
    res_u, kind, info_u, _, _ = fedadp_round(
        dev, family, cfgs, "auto", t, launches, t["k_chunk"],
        tag="xlstm_cohort_run")
    check(kind == "unified", f"engine='auto' took {kind} on a depth cohort")
    gu = [x.detach().to("cpu", copy=True)
          for x in tu.leaves(res_u["global_params"])]
    del res_u
    free_device()
    res_l, kind, info_l, _, _ = fedadp_round(
        dev, family, cfgs, "loop", t, launches, tag="xlstm_cohort_run")
    diff = max(float((a - b.cpu()).abs().max())
               for a, b in zip(gu, tu.leaves(res_l["global_params"])))
    print(f"  xlstm depth cohort: loop vs unified global params, max |diff| "
          f"= {diff:.3e} (tol {FEDADP_LOOP_TOL:g})")
    check(diff <= FEDADP_LOOP_TOL, f"xlstm cohort: loop != unified: {diff}")
    del res_l, gu
    free_device()
    return launches, {"unified": info_u, "loop": info_l,
                      "loop_vs_unified": diff}


def xlstm_trainer_path(dev):
    """``launch.train.run`` on xlstm-125m whole (``XL_TRAIN``): AdamW
    steps through the sequential mLSTM / sLSTM, every loss finite; no
    kernel of the port is on this path (no attention)."""
    from repro_torch.kernels.flash_attention import flash as ff
    from repro_torch.launch import train

    t = XL_TRAIN
    ff.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = train.run(t["arch"], use_reduced=False, steps=t["steps"],
                    batch=t["batch"], seq=t["seq"], lr=t["lr"], seed=0,
                    device=dev, log_every=t["steps"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = res["losses"]
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(sum(ff.launch_counts().values()) == 0,
          f"the xlstm trainer launched {ff.launch_counts()}")
    print(f"  xlstm trainer: losses {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"{res['ms_per_step']:.1f} ms/step; peak {peak / 1e9:.2f} GB")
    info = {**t, "losses": losses, "ms_per_step": res["ms_per_step"],
            "run_wall_s": wall, "max_memory_allocated": peak}
    print(json.dumps({"xlstm_trainer_path": info}))
    del res
    free_device()
    return info


# ------------------------------------------------------- the front ends
def front_kernel_phase(dev, errs: Errors):
    """The attention kernels at the front ends' shapes (``FRONT_FLASH``,
    ``FRONT_DECODE``; hd 64, f32) against their plain versions, then
    timed beside their bounds, the plain versions and the
    memory-efficient backend on the same heads (no mask: every pair is
    visible in the encoder and the cross-attention; the causal mask for
    internvl2-1b)."""
    rows = attn_kernel_rows(dev, errs, FRONT_FLASH, FRONT_DECODE, FRONT_HD,
                            seed=31)
    print(json.dumps({"front_variants": rows}))
    return rows


def attn_kernel_rows(dev, errs: Errors, flash_cases, decode_cases, hd,
                     seed):
    """The flash kernels at each of ``flash_cases``' shapes and
    ``swa_decode`` at each of ``decode_cases``' (head dim ``hd``, f32)
    against their plain versions, then timed (the kernels each case
    names; every decode case) beside their bounds, the plain versions
    and the memory-efficient backend on the same heads. A decode case's
    every slot is visible (its ``window``, 0 by default, does not cut
    in)."""
    from repro_torch.kernels.flash_attention import flash as ff
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.swa_attention import ref as sref
    from repro_torch.kernels.swa_attention import swa as sk

    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = {}
    f32 = 4
    for name, c in flash_cases.items():
        B, KV, G, Sq, Sk = c["B"], c["KV"], c["G"], c["Sq"], c["Sk"]
        H, causal = KV * G, c["causal"]
        qp = kp = None
        if c["zeros"]:
            qp = torch.zeros(Sq, dtype=torch.int32, device=dev)
            kp = torch.zeros(Sk, dtype=torch.int32, device=dev)
        tag = f"{name} B={B} KV={KV} G={G} Sq={Sq} Sk={Sk}"
        q, k, v, dout, qp, kp, out, lse, delta = flash_case(
            dev, gen, errs, tag + f" hd={hd}", B=B, KV=KV, G=G, Sq=Sq,
            Sk=Sk, hd=hd, causal=causal, qp=qp, kp=kp)
        args = (q, k, v, qp, kp, lse, delta, dout)
        kw = dict(causal=causal)
        bk = 128 if Sk % 128 == 0 else Sk
        pairs = B * H * (band_pairs(Sq, 0) if causal else Sq * Sk)
        qb, kb, rowb = (B * H * Sq * hd * f32, B * KV * Sk * hd * f32,
                        B * H * Sq * f32)
        qh = q.reshape(B, H, Sq, hd)
        ke = k.permute(0, 2, 1, 3).repeat_interleave(G, 1)
        ve = v.permute(0, 2, 1, 3).repeat_interleave(G, 1)
        lib_kw = dict(is_causal=True) if causal else {}
        plain_bwd = lambda: fref.flash_bwd_ref(  # noqa: E731
            q, k, v, qp, kp, out, lse, dout, block_kv=bk, **kw)
        eff_bwd = None
        if set(c["time"]) & {"flash_bwd_dq", "flash_bwd_dkv"}:
            qe, kee, vee = (x.clone().requires_grad_() for x in (qh, ke, ve))
            oe = efficient_sdpa(qe, kee, vee, **lib_kw)
            eff_bwd = lambda: torch.autograd.grad(  # noqa: E731
                oe, (qe, kee, vee), dout.reshape(B, H, Sq, hd),
                retain_graph=True)
        if "flash_fwd" in c["time"]:
            time_row(rows, f"flash_fwd {tag}",
                     lambda: ff.flash_fwd(q, k, v, qp, kp, **kw), None,
                     lambda: fref.flash_fwd_ref(q, k, v, qp, kp,
                                                block_kv=bk, **kw),
                     2 * qb + 2 * kb + rowb, 4 * hd * pairs,
                     lambda: efficient_sdpa(qh, ke, ve, **lib_kw), True,
                     reps=5, plain_reps=2)
        if "flash_bwd_dq" in c["time"]:
            time_row(rows, f"flash_bwd_dq {tag}",
                     lambda: ff.flash_bwd_dq(*args, **kw), None, plain_bwd,
                     3 * qb + 2 * kb + 2 * rowb, 6 * hd * pairs, eff_bwd,
                     True, reps=5, plain_reps=2)
        if "flash_bwd_dkv" in c["time"]:
            time_row(rows, f"flash_bwd_dkv {tag}",
                     lambda: ff.flash_bwd_dkv(*args, **kw), None, plain_bwd,
                     2 * qb + 4 * kb + 2 * rowb, 8 * hd * pairs, eff_bwd,
                     True, reps=5, plain_reps=2)
        for n in c["time"]:
            rows[f"{n} {tag}"]["visible_pairs"] = pairs
        del q, k, v, dout, out, lse, delta, args, qh, ke, ve
        plain_bwd = eff_bwd = qe = kee = vee = oe = None
        free_device()
    for name, c in decode_cases.items():
        B, KV, G, S, qpos = c["B"], c["KV"], c["G"], c["S"], c["q_pos"]
        H, W = KV * G, c.get("window", 0)
        q, k, v, kp = decode_case(dev, gen, errs, f"{name} B={B} KV={KV} "
                                  f"G={G} S={S} hd={hd}", B=B, KV=KV, G=G,
                                  hd=hd, S=S, window=W, q_pos=qpos,
                                  kind=c["kind"])
        qh = q.reshape(B, H, 1, hd)
        kh = k.permute(0, 2, 1, 3).repeat_interleave(G, 1)
        vh = v.permute(0, 2, 1, 3).repeat_interleave(G, 1)
        time_row(rows, f"swa_decode {name} B={B} KV={KV} G={G} S={S}",
                 lambda: sk.swa_decode(q, k, v, kp, qpos, window=W), None,
                 lambda: sref.decode_ref(q, k, v, kp, qpos, window=W),
                 2 * B * S * KV * hd * f32 + 2 * B * H * hd * f32 + S * 4,
                 4 * B * H * hd * S, lambda: efficient_sdpa(qh, kh, vh),
                 card=with_copies(lambda kk, vv: sk.swa_decode(
                     q, kk, vv, kp, qpos, window=W), k, v))
        del q, k, v, kp, qh, kh, vh
        free_device()
    return rows


def front_launches(cfg) -> int:
    """Flash attention layers one full-sequence pass of ``cfg`` runs: the
    encoder's, every decoder layer's self-attention and each "crossdec"
    layer's cross-attention."""
    n_enc = cfg.encoder.n_layers if cfg.encoder is not None else 0
    return n_enc + cfg.n_layers + cfg.layer_kinds().count("crossdec")


def front_serve_path(dev, spec, errs: Errors):
    """A front-end config, whole and at its published widths, through
    ``launch.serve.run`` (random normal ``aux``: whisper's frames,
    internvl2-1b's patches ahead of the prompt). Launches: one
    ``flash_fwd`` an encoder layer, a self-attention and a
    cross-attention in prefill; one ``swa_decode`` a self-attention and a
    cross-attention a token. Prefill's and the last step's logits against
    one ``forward_hidden`` of prompt + generated tokens with the same
    ``aux`` (2e-4 / 2e-3 x max|logits|); the cross kv in the final cache
    against the encoder's output projected again (decode only read it);
    ``swa_decode`` against the model's plain decode attention on the real
    self and cross caches (1e-4). Decode ms a token beside its bound: the
    decoder's weights and the caches read once a token."""
    from repro_torch import tree as tu
    from repro_torch.kernels.flash_attention import flash as ff
    from repro_torch.kernels.swa_attention import ops as sops
    from repro_torch.kernels.swa_attention import swa as sk
    from repro_torch.launch import serve
    from repro_torch.models import attention as A
    from repro_torch.models import transformer as T
    from repro_torch.sharding.ctx import ShardCtx

    s = spec
    sk.reset_launch_counts()
    ff.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = serve.run(s["arch"], use_reduced=False, batch=s["batch"],
                    prompt_len=s["prompt_len"], gen=s["gen"], seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {**sk.launch_counts(), **ff.launch_counts()}
    peak = torch.cuda.max_memory_allocated()
    cfg, params, aux = res["cfg"], res["params"], res["aux"]
    n_cross = cfg.layer_kinds().count("crossdec")
    print(f"  {cfg.name} serve run ({cfg.n_layers} layers, aux "
          f"{tuple(aux.shape)}): {wall:.1f} s; launches {counts}; peak "
          f"{peak / 1e9:.2f} GB")
    want = dict.fromkeys(counts, 0)
    want.update(flash_fwd=front_launches(cfg),
                swa_decode=(cfg.n_layers + n_cross) * s["gen"])
    check(counts == want, f"{cfg.name} serving launches {counts} != {want}")
    npx = T.vision_prefix(cfg)
    P_L, L = npx + s["prompt_len"], npx + s["prompt_len"] + s["gen"]
    enc_bytes = sum(t.numel() * t.element_size()
                    for t in tu.leaves(params.get("encoder", {})))
    param_bytes = sum(t.numel() * t.element_size()
                      for t in tu.leaves(params))
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in tu.leaves(res["cache"]))
    flash = ShardCtx(attn_backend="flash")
    err_x = None
    with torch.inference_mode():
        seq = torch.cat([res["prompts"], res["tokens"]], dim=1)
        h = T.forward_hidden(params, cfg, seq, ctx=flash, aux=aux)
        w_out = params["embed"].t()                  # tied embeddings
        want_p = (h[:, P_L - 1] @ w_out).float()
        want_d = (h[:, -1] @ w_out).float()
        del h, seq
        err_p = float((res["prefill_logits"] - want_p).abs().max())
        tol_p = SERVE_PREFILL_TOL * float(want_p.abs().max())
        err_d = float((res["logits"] - want_d).abs().max())
        tol_d = SERVE_DECODE_TOL * float(want_d.abs().max())
        print(f"  prefill logits vs forward_hidden: max |diff| {err_p:.3e} "
              f"(tol {tol_p:.3e}); last decode logits vs forward_hidden of "
              f"{L} positions: {err_d:.3e} (tol {tol_d:.3e})")
        check(err_p <= tol_p, f"prefill logits off by {err_p} > {tol_p}")
        check(err_d <= tol_d, f"decode logits off by {err_d} > {tol_d}")
        del want_p, want_d
        c = res["cache"]["units"]["b0"]
        gen = torch.Generator(device=dev).manual_seed(5)
        q = torch.randn(s["batch"], cfg.n_heads, cfg.resolved_head_dim,
                        generator=gen, device=dev)
        caches = [("self", c["k"][0], c["v"][0],
                   torch.arange(c["k"].shape[2], device=dev), L - 1)]
        if n_cross:
            enc = T.encode(params["encoder"], cfg, aux, ctx=flash)
            xp = tu.tree_map(lambda t: t[0], params["units"]["b0"]["xattn"])
            ckv = A.cross_kv(xp, cfg, enc)
            err_x = max(float((c["xk"][0] - ckv["k"]).abs().max()),
                        float((c["xv"][0] - ckv["v"]).abs().max()))
            scale = finite_scale(ckv["k"])
            print(f"  the cross kv after {s['gen']} decode steps vs the "
                  f"encoder's output projected again: max |diff| "
                  f"{err_x:.3e} (tol {SERVE_KERNEL_TOL * scale:.3e})")
            check(err_x <= SERVE_KERNEL_TOL * scale,
                  f"the cross kv moved: {err_x}")
            caches.append(("cross", c["xk"][0], c["xv"][0],
                           torch.zeros(c["xk"].shape[2], dtype=torch.int32,
                                       device=dev), 0))
            del enc, ckv
        err_c = {}
        for what, ck, cv, kp, qpos in caches:
            got = sops.decode_attention(q, ck, cv, kp, qpos)
            ref = A.decode_attention(q, ck, cv, kp, qpos)
            err_c[what] = float((got - ref).abs().max())
            print(f"  swa_decode vs decode_attention on the {what} cache "
                  f"{tuple(ck.shape)}: max |diff| {err_c[what]:.3e} (tol "
                  f"{SERVE_KERNEL_TOL:g})")
            check(err_c[what] <= SERVE_KERNEL_TOL,
                  f"swa_decode on the {what} cache: {err_c[what]}")
            errs.max["swa_decode"] = max(errs.max.get("swa_decode", 0.0),
                                         err_c[what])
        del caches, c, q
    check(all(bool(torch.isfinite(x).all())
              for x in (res["prefill_logits"], res["logits"])),
          "non-finite logits")
    read = param_bytes - enc_bytes + cache_bytes
    bound = read / hbm_rate(torch.cuda.get_device_name(0)) * 1e3
    print(f"  {cfg.name}: prefill {res['prefill_s']:.4f} s; decode "
          f"{res['decode_ms_per_token']:.2f} ms a token (bound {bound:.3f} "
          f"ms: {(param_bytes - enc_bytes) / 1e9:.3f} GB of decoder weights "
          f"and {cache_bytes / 1e9:.3f} GB of caches read once a token); "
          f"peak {peak / 1e9:.2f} GB")
    info = {"arch": cfg.name, "n_layers": cfg.n_layers,
            "encoder_layers": cfg.encoder.n_layers if cfg.encoder else 0,
            "aux_shape": list(aux.shape), "d_model": cfg.d_model,
            "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
            "head_dim": cfg.resolved_head_dim, "vocab": cfg.vocab_size,
            "batch": s["batch"], "prompt_len": s["prompt_len"],
            "prefix": npx, "gen": s["gen"], "param_bytes": param_bytes,
            "encoder_bytes": enc_bytes, "cache_bytes": cache_bytes,
            "run_wall_s": wall, "prefill_s": res["prefill_s"],
            "decode_first_s": res["decode_first_s"],
            "decode_ms_per_token": res["decode_ms_per_token"],
            "decode_bound_ms": bound, "max_memory_allocated": peak,
            "launches": counts, "prefill_logits_err": err_p,
            "decode_logits_err": err_d, "cross_kv_err": err_x,
            "kernel_vs_plain_on_cache": err_c}
    print(json.dumps({"front_serve_path": info}))
    del res, params, aux
    free_device()
    return counts, info


def front_trainer_path(dev, spec):
    """``launch.train.run`` on a front-end config whole (``FRONT_TRAIN``:
    its ``aux``): the first loss against the blockwise attention's loss of
    the same parameters, first batch and ``aux`` (``TRAIN_LOSS_TOL`` x the
    loss), then ``steps`` AdamW steps through the flash kernels, one of
    each a flash layer (``front_launches``) a step; with ``hold_finite``
    every loss and the parameters after the last step finite (else the
    non-finite parameters are counted)."""
    from repro_torch import tree as tu
    from repro_torch.configs import get_config
    from repro_torch.data import LMPipeline
    from repro_torch.kernels.flash_attention import flash as ff
    from repro_torch.launch import steps as st
    from repro_torch.launch import train
    from repro_torch.models import transformer as T
    from repro_torch.sharding.ctx import ShardCtx

    t = spec
    cfg = get_config(t["arch"])
    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                           device=dev)
    first = next(iter(LMPipeline(cfg.vocab_size, t["batch"], t["seq"],
                                 seed=0)))
    b = {k: torch.as_tensor(v, device=dev) for k, v in first.items()}
    b["aux"] = train.modality_aux(cfg, t["batch"], t["aux"], seed=0,
                                  device=dev)
    n_aux = b["aux"].shape[1]
    ff.reset_launch_counts()
    with torch.inference_mode():
        loss_b = float(st.lm_loss(params, cfg, b,
                                  ctx=ShardCtx(attn_backend="blockwise"))[0])
    check(sum(ff.launch_counts().values()) == 0,
          f"the blockwise loss launched {ff.launch_counts()}")
    del b
    free_device()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = train.run(t["arch"], use_reduced=False, steps=t["steps"],
                    batch=t["batch"], seq=t["seq"], lr=t["lr"], seed=0,
                    device=dev, log_every=t["steps"], params=params,
                    aux=t["aux"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ff.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = res["losses"]
    n = t["steps"] * front_launches(cfg)
    check(counts == dict.fromkeys(ff.KERNELS, n),
          f"{cfg.name} trainer launches {counts}, expected {n} of each")
    bad = sum(int((~torch.isfinite(p)).sum())
              for p in tu.leaves(res["params"]))
    n_params = sum(p.numel() for p in tu.leaves(res["params"]))
    check(math.isfinite(losses[0]), f"first loss {losses[0]}")
    if t["hold_finite"]:
        check(all(math.isfinite(x) for x in losses) and bad == 0,
              f"losses {losses}, {bad} non-finite parameters")
    err = abs(losses[0] - loss_b)
    print(f"  {cfg.name} trainer ({t['aux']} aux, {t['steps']} steps): "
          f"{bad} of {n_params} parameters non-finite after the last step")
    print(f"  {cfg.name} trainer: first loss {losses[0]:.6f} (blockwise "
          f"{loss_b:.6f}, |diff| {err:.3e}, tol "
          f"{TRAIN_LOSS_TOL * abs(loss_b):.3e}); last {losses[-1]:.6f}; "
          f"{res['ms_per_step']:.1f} ms/step; peak {peak / 1e9:.2f} GB")
    check(err <= TRAIN_LOSS_TOL * abs(loss_b),
          f"first loss {losses[0]} vs blockwise {loss_b}")
    info = {**t, "aux_rows": n_aux, "losses": losses,
            "non_finite_params": bad, "blockwise_first_loss": loss_b,
            "ms_per_step": res["ms_per_step"], "run_wall_s": wall,
            "max_memory_allocated": peak, "launches": counts}
    print(json.dumps({"front_trainer_path": info}))
    del res, params
    free_device()
    return counts, info


def iv_cohort_path(dev, errs: Errors):
    """The internvl2-1b FedADP cohort (``IV_COHORT``, text-only) on the
    unified engine: one f32 round through the flash kernels (one of each
    a layer a step for each chunk of the stacked cohort at the union's
    24 layers, and one forward a layer for each client view's eval), held
    against a blockwise round from the same init and data
    (``TFFN_TOL``); the half-width clients' round start widens
    (``widen_2d``)."""
    from repro_torch import tree as tu

    t = IV_COHORT
    res, info, counts, _, _ = tffn_run("auto", 1, k_chunk=t["k_chunk"],
                                       t=t)
    L = t["n_layers"]
    chunks = -(-t["K"] // t["k_chunk"])
    train = info["steps_per_round"] * chunks * L
    evals = len(info["history"]) * t["K"] * L
    check(counts["flash_bwd_dq"] == counts["flash_bwd_dkv"] == train,
          f"backward launches {counts} != {train} (steps x chunks x layers)")
    check(counts["flash_fwd"] == train + evals,
          f"forward launches {counts['flash_fwd']} != {train} + {evals}")
    check(counts["widen_2d"] > 0, "the cohort's round start never widened")
    g32 = [x.detach().to("cpu", copy=True)
           for x in tu.leaves(res["global_params"])]
    del res
    free_device()
    res_b, info_b, _, _, _ = tffn_run(
        "blockwise", 1, k_chunk=t["blockwise_k_chunk"], t=t)
    diff = max(float((a - b.cpu()).abs().max())
               for a, b in zip(g32, tu.leaves(res_b["global_params"])))
    print(f"  internvl2-1b cohort: flash vs blockwise round: max |diff| of "
          f"global params = {diff:.3e} (tol {TFFN_TOL:g})")
    check(diff <= TFFN_TOL, f"flash round != blockwise round: {diff}")
    del res_b, g32
    free_device()
    return counts, {"flash": info, "blockwise": info_b,
                    "flash_vs_blockwise": diff}


def whisper_up_path(dev):
    """whisper-small's To-Wider at full width (``WH_UP``): a half-FFN
    client moved up to the union (the decoder's and the encoder's FFNs,
    through ``widen_2d``) keeps its logits on the same tokens and frames
    (``UP_TOL``, ``tests/test_tfamily.py``'s form); then a whisper cohort
    on the unified engine, whose token batches carry no frames, must
    raise the engine's ``ValueError`` naming them. Returns the launches
    of the ``up`` and the two forwards."""
    from repro_torch.configs import get_config
    from repro_torch.core import TransformerFamily, tfamily
    from repro_torch.fl import UnifiedEngine
    from repro_torch.kernels.flash_attention import flash as ff
    from repro_torch.kernels.netchange import widen as wk
    from repro_torch.models import transformer as T

    t = WH_UP
    cfg = get_config(t["arch"])
    var = tfamily.make_variant(cfg, ffn_scale=t["ffn_scale"])
    uni = tfamily.union([var, cfg])
    gen = torch.Generator(device=dev).manual_seed(41)
    p = T.init_params(gen, var, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (t["batch"], t["S"]),
                         generator=gen, device=dev)
    aux = torch.randn((t["batch"], cfg.encoder.n_ctx, cfg.d_model),
                      generator=gen, device=dev)
    wk.reset_launch_counts()
    ff.reset_launch_counts()
    with torch.inference_mode():
        y0 = T.forward(p, var, toks, aux=aux)
        pu = tfamily.up(p, var, uni, seed=3)
        n_widen = wk.launch_counts()["widen_2d"]
        y1 = T.forward(pu, uni, toks, aux=aux)
    used = float(((y1 - y0).abs() / (UP_TOL + UP_TOL * y0.abs())).max())
    err = float((y1 - y0).abs().max())
    print(f"  whisper up (d_ff {var.d_ff} -> {uni.d_ff}, encoder FFN too): "
          f"logits max |diff| {err:.3e}, {used:.3f} of the elementwise bound "
          f"(rtol = atol = {UP_TOL:g}); widen_2d launches {n_widen}; flash "
          f"{ff.launch_counts()}")
    check(used <= 1.0, f"whisper up changed the logits: {used}")
    check(n_widen > 0, "whisper up never launched widen_2d")
    flash = ff.launch_counts()
    check(flash == dict(dict.fromkeys(ff.KERNELS, 0),
                        flash_fwd=2 * front_launches(cfg)),
          f"the two forwards launched {flash}")
    del p, pu, y0, y1
    free_device()
    eng = UnifiedEngine(TransformerFamily(), [var, cfg], [8, 8], device=dev,
                        lr=0.05, embed_seed=3)
    gp = eng.init_global(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 2, t["S"] + 1)).astype(
        np.int32)
    batches = [{"tokens": toks[..., :-1], "labels": toks[..., 1:]}]
    try:
        eng.run_round(gp, batches, round_idx=1)
        raised = None
    except ValueError as e:
        raised = str(e)
    print(f"  a whisper cohort without frames: ValueError {raised!r}")
    check(raised is not None and "frames" in raised,
          "the engine ran a whisper cohort without frames")
    del eng, gp
    free_device()
    return ({**flash, "widen_2d": n_widen},
            {"up_max_abs_diff": err, "up_bound_used": used,
             "engine_error": raised})


# ------------------------------------------- the mesh, EP and remat slice
# the client mesh: the main path's cohort and round config over ranks
# sharing the one card (gloo: NCCL takes one card a rank), five clients
# a rank; one round each of the whole-plane layout (the edge reduce)
# under filler and coverage, and of "auto" (which streams at K = 20)
MESH = dict(world=4, runs=(("plane", "filler"), ("plane", "coverage"),
                           ("auto", "filler")),
            timeout_s=300, wall_s=600)
MESH_TOL = 1e-4        # the reference's mesh-vs-flat tolerance,
                       # tests/test_streaming.py:275-282
MESH_FLIPS = 1e-5      # the share of a wire's entries that may part by
                       # more than MESH_TOL after round 1 (``_wire_tol``)
# expert parallelism: mixtral-8x7b at its published widths, 2 ranks of 4
# of the 8 experts; prefill at 2 of 32 layers (each rank draws the whole
# model before it keeps its half, and the draws pace the phase), one
# AdamW step at 1 layer
EP = dict(arch="mixtral-8x7b", world=2, n_layers=2, grad_layers=1, batch=2,
          S=2048, lr=3e-4, timeout_s=300, wall_s=600)
EP_LOGIT_TOL = 2e-5    # x max|logits|
EP_GRAD_TOL = 2e-5     # the parity tolerance, x max|g| of each leaf
# layer rematerialisation: gemma-7b at its published widths, the trainer
# phase's batch, sequence and whole vocabulary, at 2 layers (4 layers as
# well took ~14 s more, which the script's time limit does not leave)
REMAT = dict(arch="gemma-7b", layers=(2,), batch=2, seq=2048, steps=3,
             lr=3e-4)
REMAT_TOL = 2e-5       # x max|g| of each leaf: remat vs the plain step


def rank_dir(name):
    """An empty directory under build/ for one multi-rank run."""
    import shutil
    d = os.path.join(ROOT, "build", name)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    return d


def mesh_rank(rank, world, expected_path, device_type, mm_dir=None):
    """One rank of the client mesh phase (``mesh_path``), then, given
    ``mm_dir``, of ``mesh_methods_path`` (``mesh_methods_rank``)."""
    from repro_torch import tree as tu
    from repro_torch.core import VGGFamily, plane
    from repro_torch.fl import Simulator
    from repro_torch.kernels.fedavg import fedavg as fk
    from repro_torch.kernels.netchange import widen as wk
    from repro_torch.sharding import cohort_mesh

    dev = (torch.device("cuda", torch.cuda.current_device())
           if device_type == "cuda" else torch.device(device_type))
    expected = torch.load(expected_path, map_location=dev)
    cfgs, samplers, test, run_cfg = paper_cohort()
    mesh = cohort_mesh(len(cfgs), device_type=device_type)
    out = {"rank": rank, "mesh": None if mesh is None else
           mesh.mesh.tolist(), "runs": {}}
    for layout, mode in MESH["runs"]:
        rc = run_cfg(layout, mode, 1)
        sim = Simulator(VGGFamily(), cfgs, samplers(), rc, test, mesh=mesh)
        fed = sim._build()
        engine = fed.backend.engine
        engine.timing = True
        records = []
        fed.callbacks.append(records.append)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fk.reset_launch_counts()
        wk.reset_launch_counts()
        res = fed.run(torch.Generator().manual_seed(rc.seed))
        torch.cuda.synchronize()
        counts = {**fk.launch_counts(), **wk.launch_counts()}
        g = plane.pack(res["global_params"], engine.plane_spec)
        want = expected[f"{layout}/{mode}"]
        out["runs"][f"{layout}/{mode}"] = {
            "max_abs_diff": float((g - want).abs().max()),
            "finite": bool(torch.isfinite(g).all()),
            "agg_stats": engine.agg_stats(),
            "phase_stats": engine.phase_stats(),
            "round_wall_s": records[0]["wall_s"],
            "history": res["history"],
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "launches": counts}
        del sim, fed, engine, res, g
        free_device()
    del expected
    if mm_dir is not None:
        out["methods"] = mesh_methods_rank(rank, world, mm_dir, device_type)
    return out


def mesh_path(g_plane, g_auto, refs=None):
    """The client-axis mesh (``MESH``): the main path's 20-client cohort
    at full width over 4 ranks on the one card, spawned
    (``launch.mesh.run_ranks``, gloo), five clients a rank: each rank
    trains its rows and reduces them to one partial (num, den, cov)
    triple (``plane_accum``), one ``all_reduce`` sums the triples and
    ``plane_finish`` closes (coverage). Holds every rank's globals within
    ``MESH_TOL`` of the main path's single-process round of the same
    config (the whole-plane rounds; round 1 of the "auto" run), and the
    whole-plane runs' ``agg_stats`` at layout "edge", 4 edges. Prints per
    rank and run the launches, the round wall, the all_reduce time and
    the peak; returns the launches summed over ranks and runs. Given
    ``refs`` (the baselines and wire phases' single-process runs), the
    same ranks then run ``mesh_methods_path``'s (``mm_prepare`` before
    the spawn, ``mm_check`` after), and its launches are added."""
    from repro_torch.kernels.fedavg import fedavg as fk
    from repro_torch.kernels.netchange import widen as wk
    from repro_torch.launch.mesh import run_ranks

    d = rank_dir("mesh_ranks")
    path = os.path.join(d, "expected.pt")
    torch.save({"plane/filler": g_plane["filler"],
                "plane/coverage": g_plane["coverage"],
                "auto/filler": g_auto}, path)
    mm = None if refs is None else mm_prepare(refs)
    t0 = time.perf_counter()
    outs = run_ranks(mesh_rank, MESH["world"],
                     (path, "cuda", None if mm is None else mm[0]),
                     rdv_dir=d, backend="gloo", device_type="cuda",
                     timeout_s=MESH["timeout_s"],
                     wall_s=MESH["wall_s"] + MESH_METHODS["wall_s"])
    wall = time.perf_counter() - t0
    launches = dict.fromkeys(fk.KERNELS + wk.KERNELS, 0)
    for o in outs:
        check(o["mesh"] == list(range(MESH["world"])),
              f"rank {o['rank']}: cohort_mesh gave {o['mesh']}")
        for tag, r in o["runs"].items():
            for k, v in r["launches"].items():
                launches[k] += v
            st = r["agg_stats"]
            print(f"  rank {o['rank']} {tag}: max |diff| vs the single-"
                  f"process round {r['max_abs_diff']:.3e} (tol {MESH_TOL});"
                  f" layout {st['layout']} edges {st.get('edges')}; round "
                  f"{r['round_wall_s']:.2f} s, all_reduce "
                  f"{r['phase_stats']['all_reduce']:.3f} s, train "
                  f"{r['phase_stats']['train']:.2f} s; peak "
                  f"{r['max_memory_allocated'] / 1e9:.2f} GB; plane_accum "
                  f"{r['launches']['plane_accum']} plane_finish "
                  f"{r['launches']['plane_finish']} widen_2d "
                  f"{r['launches']['widen_2d']}")
            check(r["finite"], f"rank {o['rank']} {tag}: non-finite")
            check(r["max_abs_diff"] <= MESH_TOL,
                  f"rank {o['rank']} {tag}: {r['max_abs_diff']} vs the "
                  f"single-process round")
            check(st.get("edges") == MESH["world"],
                  f"rank {o['rank']} {tag}: agg_stats {st}")
            if tag.startswith("plane/"):
                check(st["layout"] == "edge",
                      f"rank {o['rank']} {tag}: agg_stats {st}")
            check(r["launches"]["plane_accum"] >= 1
                  and r["launches"]["widen_2d"] >= 1,
                  f"rank {o['rank']} {tag}: launches {r['launches']}")
            if tag == "plane/coverage":
                check(r["launches"]["plane_finish"] == 1,
                      f"rank {o['rank']} {tag}: launches {r['launches']}")
    methods = [o.pop("methods") for o in outs] if mm is not None else None
    print(json.dumps({"mesh_path": {
        "world": MESH["world"], "backend": "gloo", "wall_s": wall,
        "ranks": outs}}))
    if methods is not None:
        print("mesh methods checks")
        for k, v in mm_check(*mm, methods, wall).items():
            launches[k] += v
    return launches


# the per-client methods, the compressed wires and checkpoints on the
# client mesh (``mesh_methods_path``): the main path's cohort over 4
# ranks, five clients a rank. A run is (method, participation, wire
# knobs, rounds); at participation 0.2 (seed 0) one client a rank trains,
# and client 11 trains on rank 2 in round 1 and on rank 1 in round 2.
# The run at index ``ckpt`` checkpoints every round and is then resumed
# from its round-1 file. Runs of one method and wire follow each other,
# so a rank builds each engine once
MESH_METHODS = dict(
    world=4, seed=0, ckpt=6, timeout_s=300, wall_s=900,
    runs=(("clustered", 1.0, {}, 1), ("clustered", 0.2, {}, 2),
          ("flexifed", 1.0, {}, 1), ("standalone", 1.0, {}, 1),
          ("fedadp", 0.2, {"wire": "bf16"}, 2),
          ("fedadp", 1.0, {"wire": "int8", "wire_sparse": True}, 1),
          ("fedadp", 1.0, {"wire": "int8"}, 2)))
CKPT_FILES = ["round_0001.npz", "round_0001.wire.npz", "round_0002.npz",
              "round_0002.wire.npz"]


def mm_tag(run):
    method, part, wire, rounds = run
    w = wire.get("wire", "f32") + ("-sparse" if wire.get("wire_sparse")
                                   else "")
    return f"{method} p={part} {w} x{rounds}"


_MM_COHORT: list = []


def _mm_federation(run, mesh, sims=None, **fed_kw):
    """The Federation ``Simulator`` builds for one ``MESH_METHODS`` run,
    without its per-round evaluation (``fed_kw``: a checkpoint
    directory). ``sims`` keeps the last run's ``Simulator``: a run of the
    same method and wire takes its engine (participation is not part of
    it); another drops it first (an engine holds GBs at full width)."""
    from repro_torch.core import VGGFamily
    from repro_torch.fl import Federation, Simulator

    method, part, wire, rounds = run
    if not _MM_COHORT:
        _MM_COHORT.append(paper_cohort())
    cfgs, samplers, test, run_cfg = _MM_COHORT[0]
    rc = run_cfg("auto", "coverage" if wire.get("wire_sparse") else
                 "filler", rounds, method=method, participation=part,
                 participation_seed=MESH_METHODS["seed"], **wire)
    key = (method, tuple(sorted(wire.items())))
    sim = None if sims is None else sims.get(key)
    if sim is None:
        if sims:
            sims.clear()
            free_device()
        sim = Simulator(VGGFamily(), cfgs, samplers(), rc, test, mesh=mesh)
        if sims is not None:
            sims[key] = sim
    else:
        sim.cfg, sim.samplers = rc, samplers()
    fed = sim._build()
    return Federation(fed.strategy, fed.backend, rounds=rounds,
                      participation=fed.participation, **fed_kw), rc


def mm_ref(refs, run, fed, records, launches, round1=None, res1=None):
    """Keep a finished single-process run of ``MESH_METHODS`` (another
    phase ran the same config) for ``mesh_methods_path``: its end state,
    round-1 globals and round-1 residual plane (``res1``; the rows of
    round 2's participants are kept) on the host, and the numbers it is
    printed beside."""
    engine = fed.backend.engine
    selected = [r["selected"] for r in records]
    refs[mm_tag(run)] = (
        {"state": _mm_state(fed).cpu(), "round1": round1,
         "res1": _res1_rows(res1, selected)},
        {"round_wall_s": [records[0]["wall_s"]] + [
            b["wall_s"] - a["wall_s"] for a, b in zip(records, records[1:])],
         "wire_stats": engine.wire_stats(), "selected": selected,
         "max_memory_allocated": torch.cuda.max_memory_allocated(),
         "launches": launches})


def _res1_rows(res1, selected):
    """The round-1 residual rows (host) of round 2's participants
    (``selected``: each round's), what a mesh rank holds after placing
    them (``_placed_probe``)."""
    if res1 is None or len(selected) < 2:
        return None
    return {k: res1[k].clone() for k in selected[1]}


def _mm_state(fed):
    """A finished run's state packed: the (P,) globals, or the (K, P)
    per-client plane (the engine's own, when the state's leaves are views
    of it: no copy)."""
    from repro_torch import tree as tu
    from repro_torch.core import plane
    spec = fed.backend.plane_spec
    if fed.strategy.kind == "global":
        return plane.pack(fed.state, spec)
    leaves = tu.leaves(fed.state)
    base = leaves[0]._base
    if (base is not None
            and tuple(base.shape) == (leaves[0].shape[0], spec.size)
            and all(t._base is base for t in leaves)):
        return base
    return plane.pack_stacked(fed.state, spec)


def _checksum(x, chunk=1 << 24):
    """Two sums that equal tensors share and unequal ones almost surely
    do not: the int32 words summed in int64, and the values in f64, a
    ``chunk`` of elements at a time (a whole plane's int64 copy would
    not fit beside the other ranks)."""
    flat = x.contiguous().reshape(-1)
    words, total = 0, 0.0
    for lo in range(0, flat.numel(), chunk):
        c = flat[lo:lo + chunk]
        words += int(torch.sum(c.view(torch.int32), dtype=torch.int64))
        total += float(c.double().sum())
    return words, total


def _mm_timed_run(fed, rc, *, at_round1=None, before_round=None, **run_kw):
    """Run ``fed`` with the engine's clocks on: (result, the run's
    numbers: per-round walls, the all_reduce seconds, calls and bytes, the
    rows moved, the wire's largest quantization step (``_encode_steps``)
    and its participants' largest weight, the peak and the launches).
    ``at_round1(engine, globals)`` runs right after round 1,
    ``before_round(engine, state, r)`` before each round."""
    from repro_torch.core.aggregation import subset_weights
    from repro_torch.kernels.fedavg import fedavg as fk
    from repro_torch.kernels.netchange import widen as wk

    engine = fed.backend.engine
    # the hooks wrap the backend's run_round for this run only (a later
    # run may share the backend)
    own = fed.backend.__dict__.get("run_round")
    if at_round1 is not None:
        after_round1(fed, at_round1)
    if before_round is not None:
        inner = fed.backend.run_round

        def run_round(state, r, selected):
            before_round(engine, state, r)
            return inner(state, r, selected)
        fed.backend.run_round = run_round
    engine.timing = True
    engine.phase_stats(reset=True)
    engine.comm_stats(reset=True)
    records = []
    fed.callbacks.append(records.append)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fk.reset_launch_counts()
    wk.reset_launch_counts()
    try:
        with _encode_steps() as steps:
            res = fed.run(torch.Generator().manual_seed(rc.seed), **run_kw)
    finally:
        if own is None:
            fed.backend.__dict__.pop("run_round", None)
        else:
            fed.backend.run_round = own
    torch.cuda.synchronize()
    walls = [records[0]["wall_s"]] + [
        b["wall_s"] - a["wall_s"] for a, b in zip(records, records[1:])]
    return res, {
        "round_wall_s": walls, "history": res["history"],
        "all_reduce_s": engine.phase_stats()["all_reduce"],
        "train_s": engine.phase_stats()["train"],
        "comm": engine.comm_stats(),
        "wire_stats": engine.wire_stats(), "step": steps["step"],
        "w_max": max(float(max(subset_weights(engine.n_samples,
                                              r["selected"])))
                     for r in records),
        "selected": [r["selected"] for r in records],
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches": {**fk.launch_counts(), **wk.launch_counts()}}


@contextlib.contextmanager
def _encode_steps():
    """Yield a dict whose ``"step"`` is, on exit, the largest
    quantization step of the payloads the wire encoded meanwhile (an int8
    tile's scale; a bf16 value's spacing, at most ``|v|·2⁻⁷``): what one
    rounding flip moves a shipped value by. Observes
    ``core.quant.encode``'s results; the engine calls it unchanged."""
    from repro_torch.core import quant

    inner, out = quant.encode, {"step": 0.0}

    def encode(x, residual, fmt, **kw):
        values, scales, res = inner(x, residual, fmt, **kw)
        step = (float(scales.max()) if fmt == "int8" else
                float(values.abs().max()) * 2.0 ** -7 if fmt == "bf16"
                else 0.0)
        out["step"] = max(out["step"], step)
        return values, scales, res
    quant.encode = encode
    try:
        yield out
    finally:
        quant.encode = inner


def _mm_diff(state, want):
    """(max |state - want|, how many entries differ by more than
    ``MESH_TOL``), row by row (``want`` on the host)."""
    rows = [state] if state.dim() == 1 else state
    wants = [want] if state.dim() == 1 else want
    worst, over = 0.0, 0
    for a, b in zip(rows, wants):
        d = (a - b.to(a.device)).abs()
        worst = max(worst, float(d.max()))
        over += int((d > MESH_TOL).sum())
    return worst, over


def _wire_tol(runs):
    """What a compressed wire's round-2 state may part by from one
    process's run of the same config: ``MESH_TOL`` plus the largest
    participant weight times two of the largest quantization step of
    ``runs`` (``_mm_timed_run``'s numbers). The two train round 2 from
    globals ~2e-7 apart (the sums reassociated): a value at a rounding
    boundary then ships one step apart, which moves a global coordinate
    by its client's weight times the step, and where the training itself
    switches (a ReLU or max-pool choice) a client's value can part by
    more; twice the step bounds what the card showed (int8: 5.9e-4
    against w 0.05 x step 0.0088). Such flips are rare: ``_wire_ok``
    lets at most ``MESH_FLIPS`` of the entries part by more than
    ``MESH_TOL`` (a lost or misplaced residual row moves a whole row's
    worth). From the same round-1 state a round is held to ``MESH_TOL``
    (one process resumed from the mesh's file) or bit for bit (the
    mesh's own resume)."""
    return (MESH_TOL + 2 * max(r["w_max"] for r in runs)
            * max(r["step"] for r in runs))


def _wire_ok(err, over, n, tol):
    """A wire state's gap from another run's within ``tol`` with at most
    ``MESH_FLIPS`` of its ``n`` entries over ``MESH_TOL``."""
    return err <= tol and over <= MESH_FLIPS * n


def _round1_probe(out, residuals=False, keep=False):
    """``at_round1`` hook: the packed globals after round 1, and with
    ``residuals`` the checksum of the whole residual plane (a collective
    on a mesh), or with ``keep`` the plane itself on the host."""
    from repro_torch.core import plane

    def probe(eng, g):
        out["g1"] = plane.pack(g, eng.plane_spec)
        if residuals:
            out["res1"] = _checksum(eng.wire_residuals())
        if keep:
            out["res1_plane"] = eng.wire_residuals().to("cpu", copy=True)
    return probe


@contextlib.contextmanager
def _placed_probe(engine, want, out):
    """Observe ``engine._place_residuals`` (called unchanged): after
    round 2's placement, the residual rows this rank encodes against the
    single process's round-1 rows of the same clients (``want``: client
    -> row). A client's round-1 encode may flip one value by a step
    (``_wire_tol``), which its residual then carries whole: held within
    ``MESH_TOL`` plus the step with ``MESH_FLIPS`` of the entries over
    ``MESH_TOL``; bit-equality reported."""
    inner, calls = engine._place_residuals, []

    def place(groups):
        inner(groups)
        calls.append(groups)
        if len(calls) != 2:
            return
        mine = groups[engine._ctx.edge_rank]
        worst, over, equal = 0.0, 0, True
        for k in mine:
            a = engine._wire_res[k]
            b = want[k].to(a.device)
            equal = equal and bool(torch.equal(a, b))
            d = (a - b).abs()
            worst = max(worst, float(d.max()))
            over += int((d > MESH_TOL).sum())
        out.update(placed_rows=list(mine), placed_diff=worst,
                   placed_over=over, placed_equal=equal,
                   placed_n=len(mine) * engine.plane_spec.size)
    engine._place_residuals = place
    try:
        yield
    finally:
        del engine._place_residuals


def mesh_methods_rank(rank, world, ref_dir, device_type):
    """One rank of ``mesh_methods_path``: every run of ``MESH_METHODS``,
    then the checkpointed run resumed from its round-1 file."""
    from repro_torch.core import plane
    from repro_torch.sharding import cohort_mesh

    dev = (torch.device("cuda", torch.cuda.current_device())
           if device_type == "cuda" else torch.device(device_type))
    cfgs = paper_cohort()[0]
    mesh = cohort_mesh(len(cfgs), device_type=device_type)
    out = {"rank": rank, "mesh": None if mesh is None else
           mesh.mesh.tolist(), "runs": {}}
    ck = os.path.join(ref_dir, "ck")
    uninterrupted = None
    sims = {}
    init = []
    for i, run in enumerate(MESH_METHODS["runs"]):
        is_ck = i == MESH_METHODS["ckpt"]
        kw = {"checkpoint_dir": ck, "checkpoint_every": 1} if is_ck else {}
        t0 = time.perf_counter()
        fed, rc = _mm_federation(run, mesh, sims, **kw)
        start, keep = {}, None
        spec = fed.backend.plane_spec
        if fed.strategy.kind != "global":
            # the per-client methods start from one init (the same
            # generator): the first run draws and embeds it (20 full-width
            # VGGs drawn on the host; ``widen_2d`` embeds them) and keeps
            # a host copy, the later ones start from a device copy
            # (``Federation.run(init_state=)``)
            if init:
                start["init_state"] = plane.unpack_stacked(
                    init[0].to(dev, copy=True), spec)
            else:
                def keep(eng, state, r):
                    if r == 0:
                        init.append(plane.pack_stacked(state, spec).to(
                            "cpu", copy=True))
        want = torch.load(os.path.join(ref_dir, f"{i}.pt"), mmap=True)
        r1, placed = {}, {}
        wire2 = bool(run[2]) and run[3] > 1
        with (_placed_probe(fed.backend.engine, want["res1"], placed)
              if wire2 else contextlib.nullcontext()):
            res, o = _mm_timed_run(
                fed, rc, at_round1=(_round1_probe(r1, residuals=is_ck)
                                    if wire2 else None), before_round=keep,
                **start)
        o["drew_init"] = "init_state" not in start
        state = _mm_state(fed)
        # a per-client plane: this rank's block of rows (the ranks' states
        # are held bit-equal by checksum, so the blocks cover the plane)
        mine = (slice(None) if state.dim() == 1 else
                slice(rank * state.shape[0] // world,
                      (rank + 1) * state.shape[0] // world))
        o["max_abs_diff"], o["n_over_tol"] = _mm_diff(state[mine],
                                                      want["state"][mine])
        o.update(placed, n=state[mine].numel(),
                 finite=bool(torch.isfinite(state).all()),
                 checksum=_checksum(state))
        if "g1" in r1:
            o["round1_diff"], _ = _mm_diff(r1["g1"], want["round1"])
            o["round1_checksum"] = _checksum(r1["g1"])
            o["res1_checksum"] = r1.get("res1")
        if is_ck:
            uninterrupted = state.clone()
            if rank == 0:
                # what one process resumed from the mesh's round-1 file
                # is held against
                torch.save(state.cpu(), os.path.join(ref_dir,
                                                     "mesh_final.pt"))
            # the residual plane (whole on every rank after the
            # checkpoint's gather)
            o["res_checksum"] = _checksum(fed.backend.wire_residuals())
        o["run_s"] = time.perf_counter() - t0
        out["runs"][mm_tag(run)] = o
        del fed, res, state, want, r1, start
        free_device()
    del init
    files = sorted(os.listdir(ck))
    run = MESH_METHODS["runs"][MESH_METHODS["ckpt"]]
    fed, rc = _mm_federation(run, mesh, sims)
    loaded = {}

    def restored(eng, state, r):
        # what the resume restored, before its first round trains
        loaded["g"] = _checksum(plane.pack(state, eng.plane_spec))
        loaded["res"] = _checksum(eng.wire_residuals())
    res, o = _mm_timed_run(fed, rc, before_round=restored,
                           resume_from=os.path.join(ck, "round_0001.npz"))
    state = _mm_state(fed)
    o["max_abs_diff"], o["n_over_tol"] = _mm_diff(state, uninterrupted.cpu())
    o.update(files=files, n=state.numel(), checksum=_checksum(state),
             restored=loaded,
             res_checksum=_checksum(fed.backend.wire_residuals()))
    out["resumed"] = o
    del fed, res, state, uninterrupted, sims
    free_device()
    return out


def mesh_methods_path(refs=None):
    """The per-client methods, wires and checkpoints (``MESH_METHODS``), on
    the main path's 20-client cohort at full width over 4 gloo ranks on
    the one card (a rank holds a per-client plane's block of rows against
    the single process's, every rank's plane held bit-equal by checksum):
    clustered, flexifed and standalone (each rank trains its
    clients; one ``weighted_sum`` a (cluster ∩ its clients), the stacked
    cluster / prefix partials summed by one ``all_reduce``; standalone's
    rows gathered), clustered at participation 0.2 (rows change rank),
    the int8 wire (``plane_accum_q``; it checkpoints every round), the
    bf16 wire at 0.2 (``plane_accum``; residual rows move with their
    clients), sparse int8 under coverage (``plane_finish``), and the
    checkpointed run resumed from round 1, on the mesh and in one
    process. The single-process runs come first, in this process (or from
    ``refs``, where the baselines and wire phases ran the same config:
    ``mm_ref``), their end states written under build/ and freed. The
    main script runs the ranks in ``mesh_path``'s spawn (``mm_dir``: the
    processes' start and first convolutions paid once). Holds every
    rank's state equal to every other's (checksums); within ``MESH_TOL``
    of the single process (a compressed wire's round 1 within
    ``MESH_TOL``, its round 2 within ``_wire_tol`` (``_wire_ok``), and the
    residual rows a rank encodes in round 2 against the single process's
    round-1 rows, ``_placed_probe``); the wire's ``bytes_per_round`` equal
    to the single process's; the resume restoring the uninterrupted run's
    round-1 globals and residual plane bit for bit and its round 2
    bit-equal to the uninterrupted one's; one process resumed from the
    mesh's file within ``_wire_tol`` of the mesh's round 2; the
    checkpoint files one a round (with the residual sibling). Prints per rank and run the round
    walls, the all_reduce seconds and bytes, the rows moved, the peak
    and the launches; returns the launches summed over the ranks and
    runs."""
    from repro_torch.launch.mesh import run_ranks

    d, single = mm_prepare(refs)
    t0 = time.perf_counter()
    outs = run_ranks(mesh_methods_rank, MESH_METHODS["world"], (d, "cuda"),
                     rdv_dir=d, backend="gloo", device_type="cuda",
                     timeout_s=MESH_METHODS["timeout_s"],
                     wall_s=MESH_METHODS["wall_s"])
    return mm_check(d, single, outs, time.perf_counter() - t0)


def mm_prepare(refs=None):
    """``mesh_methods_path``'s single-process half, before the ranks: the
    runs ``refs`` does not hold, every end state written under
    build/mesh_methods/. Returns (that directory, the runs' numbers)."""
    import shutil

    t = MESH_METHODS
    d = rank_dir("mesh_methods")
    single = {}
    t0 = time.perf_counter()
    refs = refs or {}
    for i, run in enumerate(t["runs"]):
        tag = mm_tag(run)
        if tag in refs:
            saved, o = refs.pop(tag)
        else:
            fed, rc = _mm_federation(run, None)
            r1 = {}
            res, o = _mm_timed_run(fed, rc, at_round1=(
                _round1_probe(r1, keep=True) if run[2] and run[3] > 1
                else None))
            saved = {"state": _mm_state(fed).cpu(),
                     "round1": r1["g1"].cpu() if "g1" in r1 else None,
                     "res1": _res1_rows(r1.get("res1_plane"),
                                        o["selected"])}
            del fed, res, r1
        torch.save(saved, os.path.join(d, f"{i}.pt"))
        single[tag] = o
        print(f"  single process {tag}: rounds "
              f"{', '.join(f'{w:.2f}' for w in o['round_wall_s'])} s, peak "
              f"{o['max_memory_allocated'] / 1e9:.2f} GB, launches "
              f"{ {k: v for k, v in o['launches'].items() if v} }")
        del saved
        free_device()
    du = shutil.disk_usage(d)
    print(f"  single-process runs {time.perf_counter() - t0:.1f} s; build/: "
          f"{du.free / 1e9:.1f} GB free of {du.total / 1e9:.1f}")
    return d, single


def mm_check(d, single, outs, wall):
    """``mesh_methods_path``'s checks on the ranks' results (``outs``),
    then one process resumed from the mesh's round-1 file; removes
    build/mesh_methods/ and returns the ranks' launches."""
    import shutil
    from repro_torch.kernels.fedavg import fedavg as fk
    from repro_torch.kernels.netchange import widen as wk

    t = MESH_METHODS
    print(f"  the ranks took {wall:.1f} s")
    launches = dict.fromkeys(fk.KERNELS + wk.KERNELS, 0)
    for o in outs:
        check(o["mesh"] == list(range(t["world"])),
              f"rank {o['rank']}: cohort_mesh gave {o['mesh']}")
    for i, run in enumerate(t["runs"]):
        tag = mm_tag(run)
        method, part, wire, rounds = run
        rs = [o["runs"][tag] for o in outs]
        one = single[tag]
        for o, r in zip(outs, rs):
            who = f"mesh rank {o['rank']} {tag}"
            for k, v in r["launches"].items():
                launches[k] += v
            got = {k: v for k, v in r["launches"].items() if v}
            wire2 = bool(wire) and rounds > 1
            tol = _wire_tol(rs) if wire2 else MESH_TOL
            print(f"  {who}: run {r['run_s']:.1f} s, rounds "
                  f"{', '.join(f'{w:.2f}' for w in r['round_wall_s'])} s "
                  f"(single {', '.join(f'{w:.2f}' for w in one['round_wall_s'])}),"
                  f" train {r['train_s']:.2f} s, all_reduce "
                  f"{r['all_reduce_s']:.3f} s over {r['comm']['all_reduces']}"
                  f" calls, {r['comm']['bytes'] / 1e9:.3f} GB, rows moved "
                  f"{r['comm']['moved_rows']}; peak "
                  f"{r['max_memory_allocated'] / 1e9:.2f} GB (single "
                  f"{one['max_memory_allocated'] / 1e9:.2f}); max |diff| vs "
                  f"the single process {r['max_abs_diff']:.3e} (tol "
                  f"{tol:.3e}; {r['n_over_tol']} entries over {MESH_TOL})"
                  + (f", after round 1 {r['round1_diff']:.3e} (tol "
                     f"{MESH_TOL})" if "round1_diff" in r else "")
                  + (f"; round 2's residual rows {r['placed_rows']} after "
                     f"placing vs the single process's round 1: bit-equal "
                     f"{r['placed_equal']}, max |diff| "
                     f"{r['placed_diff']:.3e} (tol "
                     f"{MESH_TOL + r['step']:.3e}; {r['placed_over']} "
                     f"entries over {MESH_TOL})" if wire2 else "")
                  + f"; launches {got}")
            check(r["finite"], f"{who}: non-finite")
            check(_wire_ok(r["max_abs_diff"], r["n_over_tol"], r["n"], tol)
                  if wire2 else r["max_abs_diff"] <= tol,
                  f"{who}: {r['max_abs_diff']} ({r['n_over_tol']} entries "
                  f"over {MESH_TOL}) vs the single process")
            if wire2:
                check(_wire_ok(r["placed_diff"], r["placed_over"],
                               r["placed_n"], MESH_TOL + r["step"]),
                      f"{who}: placed residual rows {r['placed_diff']} "
                      f"({r['placed_over']} entries over {MESH_TOL})")
            if "round1_diff" in r:
                check(r["round1_diff"] <= MESH_TOL,
                      f"{who}: round 1 {r['round1_diff']} vs the single "
                      f"process")
            check(r["checksum"] == rs[0]["checksum"]
                  and r.get("res_checksum") == rs[0].get("res_checksum")
                  and r["history"] == rs[0]["history"],
                  f"{who}: differs from rank 0")
            check(r["selected"] == one["selected"],
                  f"{who}: participants {r['selected']}")
            if wire:
                check(r["wire_stats"]["bytes_per_round"]
                      == one["wire_stats"]["bytes_per_round"],
                      f"{who}: wire {r['wire_stats']} vs "
                      f"{one['wire_stats']}")
                q = wire["wire"] == "int8"
                check(got.get("plane_accum_q" if q else "plane_accum", 0)
                      >= rounds, f"{who}: launches {got}")
                if wire.get("wire_sparse"):
                    check(got.get("plane_finish") == rounds,
                          f"{who}: launches {got}")
            elif method != "standalone":
                check(got.get("weighted_sum", 0) >= rounds,
                      f"{who}: launches {got}")
            if r["drew_init"]:
                # a per-client run from a given init embeds none
                check(got.get("widen_2d", 0) >= 1,
                      f"{who}: launches {got}")
        if wire:
            moved = rs[0]["comm"]["moved_rows"]
            check((moved > 0) == (part < 1.0),
                  f"{tag}: {moved} residual rows moved")
    ck_tag = mm_tag(t["runs"][t["ckpt"]])
    for o in outs:
        r, u = o["resumed"], o["runs"][ck_tag]
        who = f"mesh rank {o['rank']} resumed {ck_tag}"
        print(f"  {who} from round 1: round {r['round_wall_s'][0]:.2f} s; "
              f"restored the round-1 globals and residual plane bit for "
              f"bit: {r['restored']['g'] == u['round1_checksum']} / "
              f"{r['restored']['res'] == u['res1_checksum']}; round 2 vs "
              f"the uninterrupted run: bit-equal "
              f"{r['checksum'] == u['checksum']}, max |diff| "
              f"{r['max_abs_diff']:.3e} ({r['n_over_tol']} entries over "
              f"{MESH_TOL}); files {r['files']}")
        check(r["files"] == CKPT_FILES, f"{who}: files {r['files']}")
        check(r["restored"]["g"] == u["round1_checksum"]
              and r["restored"]["res"] == u["res1_checksum"],
              f"{who}: did not restore the round-1 state")
        check(r["checksum"] == u["checksum"]
              and r["res_checksum"] == u["res_checksum"],
              f"{who}: round 2 parts from the uninterrupted run's by "
              f"{r['max_abs_diff']}")
        check(r["checksum"] == outs[0]["resumed"]["checksum"]
              and r["res_checksum"] == outs[0]["resumed"]["res_checksum"],
              f"{who}: differs from rank 0")
    check(sorted(os.listdir(os.path.join(d, "ck"))) == CKPT_FILES,
          "checkpoint files")
    # the mesh's round-1 file resumed in one process: its round 2 against
    # the mesh's
    fed, rc = _mm_federation(t["runs"][t["ckpt"]], None)
    _, o = _mm_timed_run(fed, rc, resume_from=os.path.join(
        d, "ck", "round_0001.npz"))
    final = _mm_state(fed)
    err, over = _mm_diff(final, torch.load(os.path.join(d, "mesh_final.pt")))
    print(f"  one process resumed from the mesh's round-1 file: round "
          f"{o['round_wall_s'][0]:.2f} s; max |diff| vs the mesh's round 2 "
          f"{err:.3e} (tol {MESH_TOL})")
    check(err <= MESH_TOL, f"one process from the mesh's file: {err}")
    single["resumed_from_mesh"] = {**o, "max_abs_diff": err,
                                   "n_over_tol": over}
    del fed, final
    free_device()
    print(json.dumps({"mesh_methods_path": {
        "world": t["world"], "backend": "gloo", "wall_s": wall,
        "single": single, "ranks": outs}}))
    shutil.rmtree(d, ignore_errors=True)
    return launches


def _mixtral(n_layers):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(EP["arch"]), n_layers=n_layers)


def _ep_batch(cfg, dev, S=None):
    """Random tokens and labels, ``EP``'s batch at ``S`` (``EP``'s)."""
    g = torch.Generator(device=dev).manual_seed(1)
    S = EP["S"] if S is None else S
    toks = torch.randint(0, cfg.vocab_size, (EP["batch"], S + 1),
                         generator=g, device=dev)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _grabbing(opt, keep):
    """``opt`` that keeps the gradients it is given in ``keep``."""
    from repro_torch.optim.optimizers import Optimizer

    def update(grads, state, params, step=0):
        keep["g"] = grads
        return opt.update(grads, state, params, step)
    return Optimizer(opt.init, update)


def _ep_step(cfg, params, batch, ctx):
    """One AdamW ``make_train_step`` step: (loss, gradients)."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw

    keep = {}
    opt = _grabbing(adamw(EP["lr"]), keep)
    step = make_train_step(cfg, opt, ctx=ctx)
    _, _, m = step(params, opt.init(params), 0, batch)
    return float(m["loss"]), keep["g"]


def ep_rank(rank, world, ref_dir, device_type):
    """One rank of the expert-parallel phase (``ep_path``): its half of
    mixtral's experts, the prefill logits and one training step."""
    from torch.distributed.device_mesh import init_device_mesh
    import torch.distributed as dist
    from repro_torch import tree as tu
    from repro_torch.kernels.flash_attention import flash as ff
    from repro_torch.kernels.swa_attention import swa as sk
    from repro_torch.models import transformer as T
    from repro_torch.sharding import ShardCtx, expert_slice

    dev = (torch.device("cuda", torch.cuda.current_device())
           if device_type == "cuda" else torch.device(device_type))
    mesh = init_device_mesh(device_type, (1, world),
                            mesh_dim_names=("data", "model"))
    ctx = ShardCtx(mesh=mesh, data_axes=("data",), model_axis="model")
    out = {"rank": rank, "model_rank": ctx.model_rank}

    def my_params(cfg):
        # one rank draws the whole model at a time, then keeps its slice
        mine = None
        for r in range(world):
            if r == rank:
                g = torch.Generator(device=dev).manual_seed(0)
                full = T.init_params(g, cfg, device=dev)
                mine = expert_slice(full, ctx, cfg.moe.n_experts)
                del full
                free_device()
            dist.barrier()
        return mine

    cfg = _mixtral(EP["n_layers"])
    params = my_params(cfg)
    out["expert_bytes_per_layer"] = sum(
        t[0].numel() * t.element_size() for p, t in tu.flatten(params)
        if "moe" in p and p[-1] in ("wg", "wu", "wd"))
    batch = _ep_batch(cfg, dev)
    torch.cuda.reset_peak_memory_stats()
    ff.reset_launch_counts()
    sk.reset_launch_counts()
    with torch.inference_mode():
        # the first call in this process pays cuBLAS's and the kernels'
        # start-up; the second is timed warm
        (logits, _), out["prefill_cold_s"], _ = _synced(
            lambda: T.prefill(params, cfg, batch["tokens"], ctx=ctx))
        out["prefill_launches"] = {**ff.launch_counts(),
                                   **sk.launch_counts()}
        del logits
        (logits, _), out["prefill_s"], _ = _synced(
            lambda: T.prefill(params, cfg, batch["tokens"], ctx=ctx))
    out["prefill_peak"] = torch.cuda.max_memory_allocated()
    want = torch.load(os.path.join(ref_dir, "logits.pt"), map_location=dev)
    out["logits_max_abs_diff"] = float((logits - want).abs().max())
    out["logits_scale"] = float(want.abs().max())
    del params, logits, want
    free_device()

    cfg = _mixtral(EP["grad_layers"])
    params = my_params(cfg)
    torch.cuda.reset_peak_memory_stats()
    ff.reset_launch_counts()
    sk.reset_launch_counts()
    (loss, grads), out["step_cold_s"], _ = _synced(
        lambda: _ep_step(cfg, params, batch, ctx))
    out["step_launches"] = {**ff.launch_counts(), **sk.launch_counts()}
    out["loss"] = loss
    # a second step from the updated model, timed warm (not compared)
    _, out["step_s"], _ = _synced(
        lambda: _ep_step(cfg, params, batch, ctx))
    out["step_peak"] = torch.cuda.max_memory_allocated()
    ref = torch.load(os.path.join(ref_dir, f"grads{ctx.model_rank}.pt"),
                     map_location=dev, mmap=True)
    errs = {}
    for path, gv in tu.flatten(grads):
        key = "/".join(path)
        want = ref[key]
        errs[key] = (float((gv - want).abs().max()),
                     float(want.abs().max()))
    out["grad_errs"] = errs
    del params, grads, ref
    free_device()
    return out


def ep_path(dev):
    """Expert parallelism (``EP``): mixtral-8x7b at its published widths
    on 2 ranks of the one card (gloo), 4 of the 8 experts each. The
    single-process runs go first and are freed before the ranks start:
    prefill logits at ``EP["n_layers"]`` layers (2 x 2048 tokens) and
    one AdamW ``make_train_step`` step at 1 layer, whose gradients are
    written per rank slice under build/. Holds each rank's prefill
    logits within ``EP_LOGIT_TOL`` x max|logits|, its loss equal to the
    single-process loss (``EP_GRAD_TOL`` x the loss) and every gradient
    leaf (the
    rank's expert slice, every other leaf whole) within ``EP_GRAD_TOL``
    x max|g|. Prints each rank's expert bytes a layer, peaks and times;
    returns the flash and swa launches of the ranks' runs."""
    from repro_torch import tree as tu
    from repro_torch.kernels.flash_attention import flash as ff
    from repro_torch.kernels.swa_attention import swa as sk
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import transformer as T
    from repro_torch.sharding.ctx import ShardCtx
    from repro_torch.sharding.rules import EXPERT_LEAF

    d = rank_dir("ep_ranks")
    cfg = _mixtral(EP["n_layers"])
    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                           device=dev)
    batch = _ep_batch(cfg, dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.inference_mode():
        logits, _ = T.prefill(params, cfg, batch["tokens"])
    torch.cuda.synchronize()
    single = {"prefill_s": time.perf_counter() - t0,
              "prefill_peak": torch.cuda.max_memory_allocated()}
    torch.save(logits.cpu(), os.path.join(d, "logits.pt"))
    del params, logits
    free_device()
    cfg1 = _mixtral(EP["grad_layers"])
    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg1,
                           device=dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, grads = _ep_step(cfg1, params, batch, ShardCtx())
    torch.cuda.synchronize()
    single.update(step_s=time.perf_counter() - t0,
                  step_peak=torch.cuda.max_memory_allocated(), loss=loss)
    del params
    E, m = cfg1.moe.n_experts, EP["world"]
    for r in range(m):
        part = {}
        for path, g in tu.flatten(grads):
            key = "/".join(path)
            if EXPERT_LEAF.search(key):
                g = g.narrow(g.dim() - 3, r * E // m, E // m)
            part[key] = g.cpu()
        torch.save(part, os.path.join(d, f"grads{r}.pt"))
        del part
    del grads
    free_device()
    print(f"  single process: prefill {single['prefill_s']:.2f} s, peak "
          f"{single['prefill_peak'] / 1e9:.2f} GB; step "
          f"{single['step_s']:.2f} s, peak {single['step_peak'] / 1e9:.2f}"
          f" GB, loss {loss:.6f}")
    t0 = time.perf_counter()
    outs = run_ranks(ep_rank, EP["world"], (d, "cuda"), rdv_dir=d,
                     backend="gloo",
                     device_type="cuda", timeout_s=EP["timeout_s"],
                     wall_s=EP["wall_s"])
    wall = time.perf_counter() - t0
    launches = dict.fromkeys(ff.KERNELS + sk.KERNELS, 0)
    for o in outs:
        for k in launches:
            launches[k] += (o["prefill_launches"][k]
                            + o["step_launches"][k])
        tol = EP_LOGIT_TOL * o["logits_scale"]
        worst = max(e / max(s, 1e-30) for e, s in o["grad_errs"].values())
        per = cfg1.moe.n_experts // EP["world"]
        print(f"  rank {o['rank']} (experts {o['model_rank'] * per}-"
              f"{o['model_rank'] * per + per - 1}): expert bytes a layer "
              f"{o['expert_bytes_per_layer'] / 1e9:.2f} GB; prefill "
              f"{o['prefill_s']:.2f} s warm ({o['prefill_cold_s']:.2f} "
              f"cold), peak {o['prefill_peak'] / 1e9:.2f} "
              f"GB, logits max |diff| {o['logits_max_abs_diff']:.3e} (tol "
              f"{tol:.3e}); step {o['step_s']:.2f} s warm "
              f"({o['step_cold_s']:.2f} cold), peak "
              f"{o['step_peak'] / 1e9:.2f} GB, loss {o['loss']:.6f} "
              f"(single {loss:.6f}); worst gradient leaf max |diff| / "
              f"max|g| {worst:.3e} (tol {EP_GRAD_TOL}); launches "
              f"{o['prefill_launches']} + {o['step_launches']}")
        check(o["logits_max_abs_diff"] <= tol,
              f"EP rank {o['rank']}: logits {o['logits_max_abs_diff']}")
        check(abs(o["loss"] - loss) <= EP_GRAD_TOL * abs(loss),
              f"EP rank {o['rank']}: loss {o['loss']} vs {loss}")
        check(worst <= EP_GRAD_TOL, f"EP rank {o['rank']}: gradients "
              f"{worst} x max|g|")
        check(sum(o["step_launches"][k] for k in ff.KERNELS) > 0,
              f"EP rank {o['rank']}: the step launched no flash kernel")
    print(json.dumps({"ep_path": {**EP, "single": single, "wall_s": wall,
                                  "ranks": outs}}))
    return launches


def remat_path(dev):
    """Layer rematerialisation (``REMAT``): gemma-7b at its published
    widths, the trainer phase's batch, sequence and vocabulary, at
    ``REMAT["layers"]``. The ``lm_loss`` gradients of the plain
    traversal, of remat "full" and of remat "dots"
    (``torch.func.grad``): losses equal, every leaf within
    ``REMAT_TOL`` x max|g| of the plain one (bit-equality
    reported, and "dots" against "full"), ``flash_fwd`` twice a layer
    under remat (forward and recompute: "dots" keeps only the batch-free
    products) and once plain, each backward kernel once a layer; the
    batch-free products' counter (``models.layers.dot_counts``): "full"
    computes every one again in the backward, "dots" none and reads each
    back; then ``make_train_step`` (AdamW) timed for all three, ms a step
    and peaks. Returns the flash launches."""
    from repro_torch import tree as tu
    from repro_torch.configs import get_config
    from repro_torch.data import LMPipeline
    from repro_torch.kernels.flash_attention import flash as ff
    from repro_torch.launch.steps import lm_loss, make_train_step
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.sharding.ctx import ShardCtx

    t = REMAT
    policies = (("plain", ShardCtx()), ("full", ShardCtx(remat=True)),
                ("dots", ShardCtx(remat=True, remat_policy="dots")))
    launches = dict.fromkeys(ff.KERNELS, 0)
    rows = []
    for n_layers in t["layers"]:
        cfg = dataclasses.replace(get_config(t["arch"]), n_layers=n_layers)
        params = T.init_params(torch.Generator(device=dev).manual_seed(0),
                               cfg, device=dev)
        pipe = iter(LMPipeline(cfg.vocab_size, t["batch"], t["seq"], seed=0))
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in next(pipe).items()}
        row = {"n_layers": n_layers}
        grads = {}
        for tag, ctx in policies:
            gv = torch.func.grad_and_value(
                lambda p, b: lm_loss(p, cfg, b, ctx=ctx), has_aux=True)
            ff.reset_launch_counts()
            L.dot_counts(reset=True)
            free_device()
            base = torch.cuda.memory_allocated()
            (g, (loss, _)), secs, peak = _synced(lambda: gv(params, batch))
            row[f"{tag}_launches"] = ff.launch_counts()
            row[f"{tag}_dots"] = L.dot_counts(reset=True)
            # the gradient's working set: what it allocated above the
            # model (and the other run's gradients) it started beside
            row[f"{tag}_grad_s"] = secs
            row[f"{tag}_grad_peak_above_start"] = peak - base
            for k, v in row[f"{tag}_launches"].items():
                launches[k] += v
            row[f"{tag}_loss"] = float(loss)
            grads[tag] = g
        for tag, ref in (("full", "plain"), ("dots", "plain"),
                         ("dots", "full")):
            worst, equal = 0.0, True
            for (path, a), (_, b) in zip(tu.flatten(grads[tag]),
                                         tu.flatten(grads[ref])):
                equal = equal and bool(torch.equal(a, b))
                worst = max(worst, float((a - b).abs().max())
                            / max(float(b.abs().max()), 1e-30))
            row[f"{tag}_vs_{ref}"] = {"worst": worst, "bit_equal": equal}
        worst = row["full_vs_plain"]["worst"]
        equal = row["full_vs_plain"]["bit_equal"]
        row.update(grad_worst=worst, bit_equal=equal)
        del grads, g
        free_device()
        n = n_layers
        check(row["plain_launches"] == {"flash_fwd": n, "flash_bwd_dq": n,
                                        "flash_bwd_dkv": n},
              f"remat {n} layers: plain launches {row['plain_launches']}")
        for tag in ("full", "dots"):
            check(row[f"{tag}_launches"] == {"flash_fwd": 2 * n,
                                             "flash_bwd_dq": n,
                                             "flash_bwd_dkv": n},
                  f"remat {n} layers: {tag} launches "
                  f"{row[f'{tag}_launches']}")
            check(row[f"{tag}_loss"] == row["plain_loss"],
                  f"remat {n} layers: {tag} loss {row[f'{tag}_loss']} vs "
                  f"{row['plain_loss']}")
            for ref in ("plain", "full"):
                if f"{tag}_vs_{ref}" in row:
                    check(row[f"{tag}_vs_{ref}"]["worst"] <= REMAT_TOL,
                          f"remat {n} layers: {tag} gradients vs {ref} "
                          f"{row[f'{tag}_vs_{ref}']}")
        full, dots = row["full_dots"], row["dots_dots"]
        check(full["forward"] > 0 and full["recomputed"] == full["forward"]
              and full["replayed"] == 0,
              f"remat {n} layers: full's batch-free products {full}")
        check(dots["forward"] == full["forward"] and dots["recomputed"] == 0
              and dots["replayed"] == dots["forward"],
              f"remat {n} layers: dots' batch-free products {dots}")
        # the trainer's step (AdamW, in place on the one model: each
        # policy's steps go on from where the last left it)
        for tag, ctx in policies:
            opt = adamw(t["lr"])
            state = opt.init(params)
            step = make_train_step(cfg, opt, ctx=ctx)
            params, state, _ = step(params, state, 0, batch)      # warm
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for i in range(1, t["steps"]):
                params, state, _ = step(params, state, i, batch)
            torch.cuda.synchronize()
            row[f"{tag}_ms_per_step"] = ((time.perf_counter() - t0)
                                         / (t["steps"] - 1) * 1e3)
            row[f"{tag}_peak"] = torch.cuda.max_memory_allocated()
            del state, step
            free_device()
        def eq(c):
            return ("bit-equal" if c["bit_equal"]
                    else f"worst {c['worst']:.3e} x max|g|")
        print(f"  remat gemma-7b {n} layers: loss {row['plain_loss']:.6f} "
              f"(full {row['full_loss']:.6f}, dots {row['dots_loss']:.6f});"
              f" gradients full vs plain {eq(row['full_vs_plain'])}, dots "
              f"vs plain {eq(row['dots_vs_plain'])}, dots vs full "
              f"{eq(row['dots_vs_full'])}; gradient "
              f"{row['plain_grad_s'] * 1e3:.1f} ms plain, "
              f"{row['full_grad_s'] * 1e3:.1f} full, "
              f"{row['dots_grad_s'] * 1e3:.1f} dots; working set "
              f"{row['plain_grad_peak_above_start'] / 1e9:.2f} / "
              f"{row['full_grad_peak_above_start'] / 1e9:.2f} / "
              f"{row['dots_grad_peak_above_start'] / 1e9:.2f} GB; AdamW "
              f"step {row['plain_ms_per_step']:.1f} / "
              f"{row['full_ms_per_step']:.1f} / "
              f"{row['dots_ms_per_step']:.1f} ms; peak "
              f"{row['plain_peak'] / 1e9:.2f} / {row['full_peak'] / 1e9:.2f}"
              f" / {row['dots_peak'] / 1e9:.2f} GB (plain / full / dots); "
              f"batch-free products full {row['full_dots']}, dots "
              f"{row['dots_dots']}; flash launches {row['plain_launches']} "
              f"/ {row['full_launches']} / {row['dots_launches']}")
        rows.append(row)
        del params
        free_device()
    print(json.dumps({"remat_path": {**t, "rows": rows}}))
    return launches


# tensor parallelism over ``model`` (``tp_path``): glm4-9b at its
# published widths, 2 of 40 layers served over model 2 ("kv": 1 kv head,
# 16 query heads a rank) and model 4 ("expand": 8 query heads a rank on
# the kv head they read), 2 layers trained at model 2; mixtral-8x7b with
# 3 experts (MOE_COHORT's unified_experts: 3 % 2 != 0, so each expert's
# F is split, 7168 of 14336 columns a rank), 2 of 32 layers served (the
# script's time limit) and 1 trained at model 2. Prefill 2 x 2048, then
# 32 greedy tokens; one AdamW step at 2 x 2048. The rest of the model at
# published widths, 4 greedy tokens each (gloo's host-staged all_reduce
# paces their decode, 47-344 ms a token), steps at 2 x 2048 unless named:
#   * deepseek-v2-236b (MLA, 64 / 32 heads a rank, the latent cache
#     whole): 2 of 60 layers on 16 of 160 routed experts (MOE_TRAIN's:
#     each rank draws the whole model before it keeps its part, and two
#     160-expert draws do not fit beside each other), served at model 2
#     and 4 with the absorbed decode's last step too, 1 layer trained;
#   * recurrentgemma-9b, one unit (rglru, rglru, local: 3 of 38 layers;
#     2048 of the 4096 RG-LRU channels a rank, the MQA local layer
#     "expand");
#   * xlstm-125m whole (2 / 1 of its 4 heads a rank): 128-token prompts
#     and a 2 x 16 step (its cells are a Python loop over time: 12.74 s a
#     step at 2 x 64 on an NVIDIA H100 80GB HBM3, 700.00 W), held at the
#     tolerances or, where larger, at TP_ULP_FACTOR x how far one f32 ulp
#     on its parameters moves one process (``_ulp_serve_gaps``);
#   * whisper-small whole (6 / 3 of 12 heads a rank in the encoder, self-
#     and cross-attention): 416-token prompts over 1500 frames, a 2 x 448
#     step;
#   * internvl2-1b whole (7 query heads on 1 kv head a rank; its 14 heads
#     give model 4 nothing to split): 256 patch rows ahead of 1024 tokens,
#     a 2 x 512 step.
# Front ends train on N(0, 1) ``aux``.
TP = dict(batch=2, prompt_len=2048, gen=32, timeout_s=300, wall_s=600,
          models={"glm4": dict(arch="glm4-9b", n_layers=2, grad_layers=2,
                               n_experts=None, worlds=(2, 4)),
                  "mixtral": dict(arch="mixtral-8x7b", n_layers=2,
                                  grad_layers=1, n_experts=3, worlds=(2,)),
                  "deepseek": dict(arch="deepseek-v2-236b", n_layers=2,
                                   grad_layers=1, n_experts=16,
                                   worlds=(2, 4), gen=4),
                  "recurrentgemma": dict(arch="recurrentgemma-9b",
                                         n_layers=3, grad_layers=3,
                                         n_experts=None, worlds=(2,),
                                         gen=4),
                  "xlstm": dict(arch="xlstm-125m", n_layers=None,
                                grad_layers=None, n_experts=None,
                                worlds=(2, 4), prompt_len=128, gen=4,
                                train_seq=16, ulp_probe=True),
                  "whisper": dict(arch="whisper-small", n_layers=None,
                                  grad_layers=None, n_experts=None,
                                  worlds=(2, 4), prompt_len=416, gen=4,
                                  train_seq=448),
                  "internvl2": dict(arch="internvl2-1b", n_layers=None,
                                    grad_layers=None, n_experts=None,
                                    worlds=(2,), prompt_len=1024, gen=4,
                                    train_seq=512)})
TP_LOGIT_TOL = 1e-5    # x max|logits|: a rank vs the single process
TP_SP_TOL = 1e-6       # x max|logits|: seq_parallel vs the plain prefill
TP_LOSS_TOL = 1e-6     # relative: a rank's loss vs the single process's
TP_GRAD_TOL = 1e-5     # x max|g| (the whole gradient): every leaf
# the attention kernels at the ranks' shapes (hd 128, f32): glm4's prefill
# and training at model 2 (KV 1 x G 16), its prefill at model 4 (k/v
# repeated to the rank's 8 query heads: KV 8 x G 1), its decode over the
# 2080-slot cache at both, mixtral's (KV 4 x G 4) prefill and decode
TP_FLASH = {
    "glm4 model=2": dict(B=2, KV=1, G=16, Sq=2048, Sk=2048, causal=True,
                         zeros=False, time=("flash_fwd", "flash_bwd_dq",
                                            "flash_bwd_dkv")),
    "glm4 model=4": dict(B=2, KV=8, G=1, Sq=2048, Sk=2048, causal=True,
                         zeros=False, time=("flash_fwd",))}
TP_DECODE = {
    "glm4 model=2": dict(B=2, KV=1, G=16, S=2080, q_pos=2079, kind="iota"),
    "glm4 model=4": dict(B=2, KV=1, G=8, S=2080, q_pos=2079, kind="iota"),
    "mixtral model=2": dict(B=2, KV=4, G=4, S=2080, q_pos=2079, kind="ring",
                            window=4096)}
TP_PREFILL = {"mixtral model=2": dict(B=2, KV=4, G=4, S=2048, window=4096,
                                     hd=128),
              # recurrentgemma's local layer at model 2: "expand" repeats
              # the one kv head to the rank's 8 query heads (KV 8 x G 1)
              "recurrentgemma model=2": dict(B=2, KV=8, G=1, S=2048,
                                             window=2048, hd=256)}
# MLA's prefill at model 2 (64 of deepseek's 128 heads a rank, qk dim
# 192) and the whisper encoder's at model 2 (6 of 12 heads, 1500 frames,
# bidirectional, hd 64): (cases, hd)
TP_FLASH_HD = ({"deepseek model=2": dict(B=2, KV=64, G=1, Sq=2048, Sk=2048,
                                         causal=True, zeros=False,
                                         time=("flash_fwd",))}, MLA_HD), (
    {"whisper encoder model=2": dict(B=2, KV=6, G=1, Sq=1500, Sk=1500,
                                     causal=False, zeros=False,
                                     time=("flash_fwd",))}, FRONT_HD)


def tp_kernel_phase(dev, errs: Errors):
    """The attention kernels at the tensor-parallel ranks' shapes
    (``TP_FLASH``, ``TP_DECODE``, ``TP_PREFILL``) against their plain
    versions, timed beside their bounds, the plain versions and a library
    call (the memory-efficient backend on expanded heads; SDPA with the
    band mask for ``swa_prefill``). Not redesigned: timed only."""
    from repro_torch.kernels.swa_attention import ref as sref
    from repro_torch.kernels.swa_attention import swa as sk

    rows = attn_kernel_rows(dev, errs, TP_FLASH, TP_DECODE, 128, seed=37)
    for i, (cases, hd) in enumerate(TP_FLASH_HD):
        rows.update(attn_kernel_rows(dev, errs, cases, {}, hd, seed=39 + i))
    gen = torch.Generator(device=dev).manual_seed(38)
    for name, c in TP_PREFILL.items():
        B, KV, G, S, W = c["B"], c["KV"], c["G"], c["S"], c["window"]
        hd = c["hd"]
        H = KV * G
        q = torch.randn(B, KV, G, S, hd, generator=gen, device=dev)
        k = torch.randn(B, S, KV, hd, generator=gen, device=dev)
        v = torch.randn(B, S, KV, hd, generator=gen, device=dev)
        tag = f"{name} B={B} KV={KV} G={G} S={S} w={W}"
        want = sref.prefill_ref(q, k, v, window=W)
        errs.hold("swa_prefill", sk.swa_prefill(q, k, v, window=W), want,
                  finite_scale(want), tag, FLASH_TOL)
        del want
        pairs = band_pairs(S, W)
        pos = torch.arange(S, device=dev)
        band = ((pos[None, :] <= pos[:, None])
                & (pos[:, None] - pos[None, :] < W))
        qh = q.reshape(B, H, S, hd)
        kh, vh = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
        time_row(rows, f"swa_prefill {tag}",
                 lambda: sk.swa_prefill(q, k, v, window=W), None,
                 lambda: sref.prefill_ref(q, k, v, window=W),
                 (3 * B * H * S * hd + 2 * B * S * KV * hd) * 4,
                 4 * B * H * hd * pairs,
                 lambda: F.scaled_dot_product_attention(
                     qh, kh, vh, attn_mask=band, enable_gqa=True),
                 tensor_cores=True, reps=5, plain_reps=2)
        rows[f"swa_prefill {tag}"]["visible_pairs"] = pairs
        del q, k, v, qh, kh, vh, band
        free_device()
    print(json.dumps({"tp_variants": rows}))
    return rows


def _tp_cfg(spec, n_layers):
    """``spec``'s config at ``n_layers`` (None: its published depth)."""
    from repro_torch.configs import get_config
    cfg = get_config(spec["arch"])
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if spec["n_experts"] is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=spec["n_experts"],
            top_k=min(cfg.moe.top_k, spec["n_experts"])))
    return cfg


def _tp_len(spec, key):
    """``spec``'s prompt_len / gen, else ``TP``'s."""
    return spec.get(key, TP[key])


def _tp_serve(spec, dev, ctx=None, batch=None):
    """``spec`` served through ``launch.serve.run`` (``ctx``: the rank's)
    at ``batch`` rows (default ``TP``'s); for MLA also the absorbed
    decode's last step again, at the last position (its cache slot holds
    the same latents already): ``absorbed``."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.sharding import ShardCtx

    res = serve.run(spec["arch"], use_reduced=False,
                    batch=batch or TP["batch"],
                    prompt_len=_tp_len(spec, "prompt_len"),
                    gen=_tp_len(spec, "gen"), n_layers=spec["n_layers"],
                    n_experts=spec["n_experts"], device=dev, ctx=ctx)
    cfg = res["cfg"]
    if cfg.mla is not None:
        absorb = dataclasses.replace(ctx or ShardCtx(), mla_absorb=True)
        pos = (T.vision_prefix(cfg) + _tp_len(spec, "prompt_len")
               + _tp_len(spec, "gen") - 1)
        with torch.inference_mode():
            res["absorbed"], _ = T.decode_step(
                res["params"], cfg, res["tokens"][:, -1:], res["cache"], pos,
                ctx=absorb)
    return res


def _tp_batch(spec, cfg, dev):
    """The AdamW step's batch: ``_ep_batch``'s at ``spec``'s
    ``train_seq``, with N(0, 1) ``aux`` for a front end (zero ``aux``
    overflows the gradient: ``FRONT_TRAIN``)."""
    from repro_torch.launch.train import modality_aux
    b = _ep_batch(cfg, dev, spec.get("train_seq"))
    aux = modality_aux(cfg, EP["batch"], "normal", device=dev)
    if aux is not None:
        b["aux"] = aux
    return b


def _timed_all_reduce():
    """Put a clock around ``torch.distributed.all_reduce`` in this process
    (the card synchronised before and after each call: gloo stages a
    CUDA tensor through the host and waits for it anyway). Returns the
    running tally: seconds, calls and bytes; a call over one of
    ``tally["data_groups"]`` (FSDP's data axis) is also added to
    ``tally["data"][label]``, the label the FSDP collective that made it
    set (``_label_data_collectives``)."""
    import torch.distributed as dist
    tally = {"s": 0.0, "n": 0, "bytes": 0, "data": {}, "label": None,
             "data_groups": ()}
    inner = dist.all_reduce

    def timed(t, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(t, *args, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        nbytes = t.numel() * t.element_size()
        tally["s"] += dt
        tally["n"] += 1
        tally["bytes"] += nbytes
        if any(kw.get("group") is g for g in tally["data_groups"]):
            row = tally["data"].setdefault(tally["label"] or "other",
                                           [0.0, 0, 0])
            row[0] += dt
            row[1] += 1
            row[2] += nbytes
        return out
    dist.all_reduce = timed
    _label_data_collectives(tally)
    return tally


def _label_data_collectives(tally):
    """Make FSDP's collectives (``sharding/collectives.py``) name what
    their all_reduces are while they run: the unit gathers ("gather"),
    the gradients' reduce-scatters ("reduce_scatter", with the sums of
    the leaves held whole over data), the loss's sums ("loss_sum") and
    the sequence-split decode cache's combine of the ranks' attention
    ("combine")."""
    from repro_torch.sharding import collectives as C

    def wrap(cls, name, label):
        inner = getattr(cls, name)

        def labelled(*a):
            prev, tally["label"] = tally["label"], label
            try:
                return inner(*a)
            finally:
                tally["label"] = prev
        setattr(cls, name, staticmethod(labelled))
    wrap(C._GatherUnit, "forward", "gather")
    wrap(C._GatherUnit, "backward", "reduce_scatter")
    wrap(C._ReduceFromData, "forward", "loss_sum")
    # the sequence-split cache's combine, where the attention calls it
    from repro_torch.models import attention as A
    combine = A.combine_seq

    def labelled_combine(*a):
        prev, tally["label"] = tally["label"], "combine"
        try:
            return combine(*a)
        finally:
            tally["label"] = prev
    A.combine_seq = labelled_combine


def tp_rank(rank, world, ref_dir, device_type):
    """One rank of the tensor-parallel phase (``tp_path``): serve each
    model of ``TP`` at this world size through ``launch.serve.run`` with
    the rank's ctx, then (model 2) one AdamW step at the training depth;
    report the rank's logits, tokens, loss and gradients against the
    single-process ones, its held fractions, times and launches."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import tree as tu
    from repro_torch.kernels.flash_attention import flash as ff
    from repro_torch.kernels.swa_attention import swa as sk
    from repro_torch.models import transformer as T
    from repro_torch.sharding import ShardCtx, head_plan, tp_slice
    from repro_torch.sharding.rules import tp_cache_slice, tp_leaf_slice

    dev = (torch.device("cuda", torch.cuda.current_device())
           if device_type == "cuda" else torch.device(device_type))
    mesh = init_device_mesh(device_type, (1, world),
                            mesh_dim_names=("data", "model"))
    ctx = ShardCtx(mesh=mesh, data_axes=("data",), model_axis="model")
    tally = _timed_all_reduce()
    out = {"rank": rank, "model_rank": ctx.model_rank, "models": {}}

    def counts():
        return {**ff.launch_counts(), **sk.launch_counts()}

    def reset():
        ff.reset_launch_counts()
        sk.reset_launch_counts()
        tally.update(s=0.0, n=0, bytes=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    for name, spec in TP["models"].items():
        if world not in spec["worlds"]:
            continue
        o = out["models"][name] = {}
        ref = torch.load(os.path.join(ref_dir, f"{name}.pt"))
        reset()
        res = _tp_serve(spec, dev, ctx)
        o.update(serve_launches=counts(), prefill_s=res["prefill_s"],
                 decode_first_s=res["decode_first_s"],
                 decode_ms_per_token=res["decode_ms_per_token"],
                 serve_all_reduce_s=tally["s"], serve_all_reduce_n=tally["n"],
                 serve_all_reduce_bytes=tally["bytes"],
                 serve_peak=torch.cuda.max_memory_allocated())
        cfg, params = res["cfg"], res["params"]
        lo = T.vocab_lo(params, cfg, ctx)
        for key in ("prefill_logits", "logits", "absorbed"):
            if key not in res:
                continue
            got = res[key].float().cpu()
            want = ref[key] if lo is None else ref[key][
                :, lo:lo + got.shape[-1]]
            o[f"{key}_err"] = float((got - want).abs().max())
            o[f"{key}_scale"] = float(ref[key].abs().max())
        o["tokens_equal"] = bool(torch.equal(res["tokens"].cpu(),
                                             ref["tokens"]))
        # what the rank holds: its part of the cache (tp_cache_slice),
        # 1/m of every leaf the plan cuts evenly, its kv heads of the kv
        # projections
        L = (T.vision_prefix(cfg) + _tp_len(spec, "prompt_len")
             + _tp_len(spec, "gen"))
        whole_cache = T.init_cache(cfg, TP["batch"], L, device="meta")
        held_cache = 0
        for path, t in tu.flatten(whole_cache):
            cut = tp_cache_slice("/".join(path), tuple(t.shape), cfg, world,
                                 ctx.model_rank)
            held_cache += (t.numel() if cut is None else
                           t.numel() // t.shape[cut[0]] * cut[2])
        o["cache_held"] = (sum(t.numel() for t in tu.leaves(res["cache"])),
                           held_cache,
                           sum(t.numel() for t in tu.leaves(whole_cache)))
        heads = head_plan(cfg.n_heads, cfg.n_kv_heads, world, ctx.model_rank)
        o["kv_heads"] = (heads.k0, heads.nk, cfg.n_kv_heads)
        held = {"even": [0, 0], "kv": [0, 0]}
        shapes = T.init_params(None, cfg, device="meta")
        for path, w in tu.flatten(shapes):
            key = "/".join(path)
            cut = tp_leaf_slice(key, tuple(w.shape), cfg, world,
                                ctx.model_rank)
            if cut is None:
                continue
            part = ("kv" if heads.layout == "expand"
                    and key.endswith(("attn/wk", "attn/wv", "attn/bk",
                                      "attn/bv")) else "even")
            held[part][0] += tu.get(params, path).numel()
            held[part][1] += w.numel()
        o["held"] = held
        if name == "glm4" and world == 2:
            reset()
            with torch.inference_mode():
                plain, _ = T.prefill(params, cfg, res["prompts"], ctx=ctx)
                sp, _ = T.prefill(params, cfg, res["prompts"],
                                  ctx=dataclasses.replace(
                                      ctx, seq_parallel=True))
            o["sp_err"] = float((sp - plain).abs().max())
            o["sp_launches"] = counts()
            del plain, sp
        del res, params
        free_device()
        if world != 2:
            continue
        cfg1 = _tp_cfg(spec, spec["grad_layers"])
        mine = None
        for r in range(world):
            # one rank draws the whole model at a time, keeps its part
            if r == rank:
                full = T.init_params(
                    torch.Generator(device=dev).manual_seed(0), cfg1,
                    device=dev)
                mine = tp_slice(full, ctx, cfg1)
                del full
                free_device()
            dist.barrier()
        batch = _tp_batch(spec, cfg1, dev)
        reset()
        (loss, grads), o["step_s"], o["step_peak"] = _synced(
            lambda: _ep_step(cfg1, mine, batch, ctx))
        o.update(step_launches=counts(), loss=loss, loss_ref=ref["loss"],
                 step_all_reduce_s=tally["s"], step_all_reduce_n=tally["n"],
                 step_all_reduce_bytes=tally["bytes"])
        want = torch.load(os.path.join(ref_dir,
                                       f"{name}_grads{ctx.model_rank}.pt"),
                          map_location=dev, mmap=True)
        o["grad_errs"] = {}
        for path, g in tu.flatten(grads):
            key = "/".join(path)
            o["grad_errs"][key] = (float((g - want[key]).abs().max()),
                                   float(want[key].abs().max()))
        del mine, grads, want, batch
        free_device()
    out["fsdp"] = fsdp_rank(world, ref_dir, dev, device_type, tally, counts,
                            reset)
    return out


# the meshes' checkpoint (``fsdp_rank`` at (data 2, model 2)):
# whisper-small's trainer (``launch.train.run``, whole, AdamW, on N(0, 1)
# ``aux``) writes one file, so ``tp_gather`` puts back both cuts: the data
# parts, then the model parts of the encoder, the cross-attention and
# the rest (0.95 GB; glm4-9b's 2 layers at model 2 wrote 6.60 GB, whose
# gather and load took ~36 s of the script's time on an NVIDIA H100 80GB
# HBM3, 700.00 W); its forward is held on the
# first ``forward_len`` tokens of a 2-row batch over the same frames,
# each rank's row and vocabulary columns
CKPT = dict(model="whisper", steps=1, forward_len=256, batch=2)


def _ckpt_inputs(cfg, dev):
    """The checkpoint check's forward inputs: ``forward_len`` tokens and,
    for a front end, N(0, 1) ``aux`` (``CKPT["batch"]`` rows)."""
    from repro_torch.data import LMPipeline
    from repro_torch.launch.train import modality_aux
    toks = torch.as_tensor(next(iter(LMPipeline(
        cfg.vocab_size, CKPT["batch"], CKPT["forward_len"], seed=5)))[
            "tokens"], device=dev)
    return toks, modality_aux(cfg, CKPT["batch"], "normal", seed=5,
                              device=dev)


def _ckpt_rank(ctx, dev, ref_dir, spec):
    """One rank's part of the checkpoint check: ``train.run(ctx=,
    ckpt=)``, then the checksums of the rank's params (leaf by leaf) and
    its logits (its rows, its vocabulary columns) of a forward, for the
    parent to hold against the file's cut (``tp_slice_rank`` +
    ``data_slice_rank``) and forward."""
    from repro_torch import tree as tu
    from repro_torch.launch import train
    from repro_torch.models import transformer as T
    from repro_torch.sharding.rules import data_rows

    path = os.path.join(ref_dir, f"{CKPT['model']}_ckpt.npz")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = train.run(spec["arch"], use_reduced=False,
                    n_layers=spec["grad_layers"], steps=CKPT["steps"],
                    batch=TP["batch"], seq=spec.get("train_seq",
                                                    TP["prompt_len"]),
                    device=dev, ctx=ctx, ckpt=path, aux="normal",
                    log_every=10 ** 9)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    params, cfg = res["params"], res["cfg"]
    sums = {"/".join(p): _checksum(t) for p, t in tu.flatten(params)}
    toks, aux = _ckpt_inputs(cfg, dev)
    rows = data_rows(CKPT["batch"], ctx)
    with torch.no_grad():
        logits = T.forward(params, cfg, toks[rows], ctx=ctx,
                           aux=aux[rows]).cpu()
    out = {"wall_s": wall, "peak": peak, "losses": res["losses"],
           "data_rank": ctx.data_rank, "model_rank": ctx.model_rank,
           "checksums": sums, "logits": logits, "rows": rows,
           "lo": T.vocab_lo(params, cfg, ctx),
           "file_bytes": os.path.getsize(path)}
    del res, params
    free_device()
    return out


def _ckpt_check(dev, d, outs):
    """The parent's half: the file loaded in one process. Its tree and
    shapes are the one-process run's (``init_params``'), each rank's cut
    of it (``tp_slice_rank`` + ``data_slice_rank``) has the rank's
    params' checksums leaf for leaf (bit for bit), and its forward is
    within ``TP_LOGIT_TOL`` x max|logits| of every rank's rows and
    vocabulary columns."""
    from repro_torch import tree as tu
    from repro_torch.checkpoint import load_pytree
    from repro_torch.models import transformer as T
    from repro_torch.sharding.rules import data_slice_rank, tp_slice_rank

    name = CKPT["model"]
    spec = TP["models"][name]
    cfg = _tp_cfg(spec, spec["grad_layers"])
    path = os.path.join(d, f"{name}_ckpt.npz")
    t0 = time.perf_counter()
    whole, extra = load_pytree(path)
    whole = tu.tree_map(lambda t: t.to(dev), whole)
    load_s = time.perf_counter() - t0
    meta = T.init_params(None, cfg, device="meta")
    shapes = ([(p, tuple(t.shape)) for p, t in tu.flatten(whole)]
              == [(p, tuple(t.shape)) for p, t in tu.flatten(meta)])
    toks, aux = _ckpt_inputs(cfg, dev)
    with torch.no_grad():
        want = T.forward(whole, cfg, toks, aux=aux).cpu()
    scale = float(want.abs().max())
    for o in outs:
        c = o.pop("ckpt")
        m = o["mesh"][1]
        mine = data_slice_rank(tp_slice_rank(whole, cfg, m, c["model_rank"]),
                               cfg, m, o["mesh"][0], c["data_rank"])
        equal = all(_checksum(t) == c["checksums"]["/".join(p)]
                    for p, t in tu.flatten(mine))
        del mine
        c.pop("checksums")
        got = c.pop("logits")
        ref = want[c.pop("rows")]
        if c["lo"] is not None:
            ref = ref[..., c["lo"]:c["lo"] + got.shape[-1]]
        err = float((got - ref).abs().max())
        who = (f"checkpoint at data={o['mesh'][0]} model={m} rank "
               f"{o['rank']}")
        print(f"  {who}: train.run ({CKPT['steps']} AdamW step, gather over "
              f"data and model, write) {c['wall_s']:.2f} s, peak "
              f"{c['peak'] / 1e9:.2f} GB, loss {c['losses'][0]:.6f}; the "
              f"file {c['file_bytes'] / 1e9:.2f} GB (loaded in one process "
              f"in {load_s:.2f} s): the one-process tree and shapes "
              f"{shapes}, its cut == the rank's params {equal}; its forward "
              f"vs the rank's logits max |diff| {err:.3e} (tol "
              f"{TP_LOGIT_TOL * scale:.3e})")
        check(shapes and extra["arch"] == cfg.name,
              f"{who}: the file's tree {extra}")
        check(equal, f"{who}: the file's cut != the params")
        check(err <= TP_LOGIT_TOL * scale, f"{who}: logits {err}")
        o["ckpt"] = {**c, "logits_err": err, "logits_scale": scale,
                     "load_s": load_s}
    del whole
    free_device()
    os.remove(path)


def tp_path(dev):
    """Tensor parallelism over ``model`` (``TP``), then FSDP over a data
    axis of 2 in the same spawns (``FSDP``, ``fsdp_rank``, with the
    checkpoint check ``CKPT``): the single-process runs first (serving
    through ``launch.serve.run``; one AdamW step whose
    gradients are written as each rank's slice under build/), freed
    before the ranks start; then gloo ranks on the one card: 2 ranks
    (glm4-9b "kv", mixtral-8x7b F split), 4 ranks (glm4-9b "expand").
    Holds each rank's prefill and last decode logits (its vocabulary
    columns) within ``TP_LOGIT_TOL`` x max|logits|, its greedy tokens
    equal, the ``seq_parallel`` prefill within ``TP_SP_TOL``, its loss
    within ``TP_LOSS_TOL`` (relative) and every gradient leaf, the
    ranks' slices put together, within ``TP_GRAD_TOL`` x max|g|
    (``_tp_grads``); the rank's cache its kv heads and each
    evenly cut leaf 1/m. Prints per rank prefill s, decode ms a token,
    the all_reduce share, peaks and launches; returns the attention
    kernels' launches of the ranks' runs."""
    from repro_torch import tree as tu
    from repro_torch.kernels.flash_attention import flash as ff
    from repro_torch.kernels.swa_attention import swa as sk
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.sharding.ctx import ShardCtx
    from repro_torch.sharding.rules import tp_slice_rank

    d = rank_dir("tp_ranks")
    single = {}
    for name, spec in TP["models"].items():
        t0 = time.perf_counter()
        res = _tp_serve(spec, dev)
        single[name] = {"prefill_s": res["prefill_s"],
                        "decode_ms_per_token": res["decode_ms_per_token"]}
        ref = {k: res[k].float().cpu() for k in ("prefill_logits",
                                                 "logits", "absorbed")
               if k in res}
        ref["tokens"] = res["tokens"].cpu()
        if spec.get("ulp_probe"):
            single[name]["ulp"] = _ulp_serve_gaps(spec, res)
        del res
        free_device()
        if name == FSDP["model"]:
            # the batch-1 reference of the FSDP phase's sequence-split
            # cache: logits, tokens and the self-attention caches
            res = _tp_serve(spec, dev, batch=1)
            b1 = {k: res[k].float().cpu() for k in ("prefill_logits",
                                                    "logits")}
            b1["tokens"] = res["tokens"].cpu()
            b1["cache"] = {"/".join(p): t.cpu() for p, t in
                           tu.flatten(res["cache"]) if p[-1] in ("k", "v")}
            single[name]["b1"] = {
                "prefill_s": res["prefill_s"],
                "decode_ms_per_token": res["decode_ms_per_token"]}
            torch.save(b1, os.path.join(d, f"{name}_b1.pt"))
            del res, b1
            free_device()
        cfg1 = _tp_cfg(spec, spec["grad_layers"])
        params = _tp_init(cfg1, dev)
        batch = _tp_batch(spec, cfg1, dev)
        nudged = _ulp_nudged(params) if spec.get("ulp_probe") else None
        (loss, grads), secs, peak = _synced(
            lambda: _ep_step(cfg1, params, batch, ShardCtx()))
        single[name].update(step_s=secs, step_peak=peak, loss=loss)
        if nudged is not None:
            _, g_nudged = _ep_step(cfg1, nudged, batch, ShardCtx())
            single[name]["ulp"]["grads"] = max(
                float((a - b).abs().max()) for a, b in
                zip(tu.leaves(grads), tu.leaves(g_nudged)))
            del nudged, g_nudged
        ref["loss"] = loss
        torch.save(ref, os.path.join(d, f"{name}.pt"))
        del params, batch
        for r in range(2):
            part = tp_slice_rank(grads, cfg1, 2, r)
            torch.save({"/".join(p): g.cpu() for p, g in tu.flatten(part)},
                       os.path.join(d, f"{name}_grads{r}.pt"))
            del part
        del grads
        free_device()
        single[name]["wall_s"] = time.perf_counter() - t0
        print(f"  single process {name}: prefill "
              f"{single[name]['prefill_s']:.2f} s, decode "
              f"{single[name]['decode_ms_per_token']:.2f} ms a token; step "
              f"{secs:.2f} s, peak {peak / 1e9:.2f} GB, loss {loss:.6f}")
    launches = dict.fromkeys(ff.KERNELS + sk.KERNELS + ("swa_decode_lse",),
                             0)
    walls = {}
    for world in (2, 4):
        t0 = time.perf_counter()
        # a rendezvous of its own each spawn, as run_ranks asks: the
        # world-2 spawn's file store, left in place, can hand a world-4
        # rank a dead address (gloo: connection refused)
        outs = run_ranks(tp_rank, world, (d, "cuda"),
                         rdv_dir=os.path.join(d, f"rdv{world}"),
                         backend="gloo", device_type="cuda",
                         timeout_s=TP["timeout_s"], wall_s=TP["wall_s"])
        walls[world] = time.perf_counter() - t0
        fsdp = [o.pop("fsdp") for o in outs]
        if world == FSDP["ckpt_world"]:
            _ckpt_check(dev, d, fsdp)
        print(json.dumps({"tp_path": {"world": world, "wall_s": walls[world],
                                      "ranks": outs}}))
        for o in outs:
            for name, r in o["models"].items():
                _tp_report(world, o, name, r, single[name], launches)
        for name in TP["models"]:
            parts = [o["models"][name]["grad_errs"] for o in outs
                     if "grad_errs" in o["models"].get(name, {})]
            if parts:
                _tp_grads(name, world, parts, TP_ULP_FACTOR
                          * single[name].get("ulp", {}).get("grads", 0.0))
        print(json.dumps({"fsdp_path": {"world": world, "ranks": [
            {k: v for k, v in o.items() if k != "grad_errs"}
            for o in fsdp]}}))
        for o in fsdp:
            _fsdp_report(o, single[FSDP["model"]], launches)
        _fsdp_grads(world, [o["grad_errs"] for o in fsdp])
    print(json.dumps({"tp_path": {**TP, "single": single,
                                  "wall_s": walls}}))
    return launches


TP_ULP = 2.0 ** -23    # one f32 ulp, relative: the probe's nudge
# the ranks' rounding enters every product of every layer, the probe's
# only the parameters: the xLSTM's ranks are held at this many times the
# probe's gap (ranks measured at up to 1.9 x on an NVIDIA H100 80GB HBM3,
# 700.00 W)
TP_ULP_FACTOR = 4


def _ulp_nudged(params, seed=7):
    """A copy of ``params`` with every entry moved by one f32 ulp up or
    down (a random sign from ``seed``): the probe of how far f32 rounding
    alone moves one process's output (``ulp_probe``)."""
    from repro_torch import tree as tu
    g = torch.Generator(device=next(iter(tu.leaves(params))).device)
    g.manual_seed(seed)
    return tu.tree_map(lambda p: p * (1 + TP_ULP * (2 * torch.randint(
        0, 2, p.shape, generator=g, device=p.device) - 1)), params)


def _ulp_serve_gaps(spec, res):
    """How far one process's prefill and last decode logits move when its
    parameters move by one ulp (``_ulp_nudged``), the serve run's tokens
    fed again: its f32 noise floor, where the ranks' rounding cannot be
    told apart from a bug by a fixed tolerance (the xLSTM cells amplify
    rounding through their state)."""
    from repro_torch.models import transformer as T

    cfg = res["cfg"]
    npx = T.vision_prefix(cfg)
    P, gen = _tp_len(spec, "prompt_len"), _tp_len(spec, "gen")
    nudged = _ulp_nudged(res["params"])
    with torch.inference_mode():
        first, cache = T.prefill(nudged, cfg, res["prompts"], aux=res["aux"],
                                 cache_len=npx + P + gen)
        for i in range(gen):
            last, cache = T.decode_step(nudged, cfg,
                                        res["tokens"][:, i:i + 1], cache,
                                        npx + P + i)
    return {"prefill_logits": float((first - res["prefill_logits"]).abs()
                                    .max()),
            "logits": float((last - res["logits"]).abs().max())}


def _tp_init(cfg, dev):
    from repro_torch.models import transformer as T
    return T.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         device=dev)


def _tp_grads(name, world, parts, floor=0.0):
    """Hold the ranks' gradient slices put together (``tp_path``): every
    leaf's largest |diff| over the ranks within ``TP_GRAD_TOL`` x max|g|,
    the largest entry of the whole gradient (as the logits are held
    against max|logits|), or within ``floor`` where that is larger
    (``TP_ULP_FACTOR`` x the one-ulp probe of ``ulp_probe``). Also
    printed: the worst leaves against their own max|g|, where a leaf
    whose entries cancel (the router bias) shows f32 rounding most
    (``tools/tp_grad_probe.py`` puts both against float64)."""
    rows = []
    for key in parts[0]:
        err = max(p[key][0] for p in parts)
        scale = max(p[key][1] for p in parts)
        rows.append((err / max(scale, 1e-30), key, err, scale))
    g_max = max(r[3] for r in rows)
    worst = max(r[2] for r in rows)
    tol = max(TP_GRAD_TOL * g_max, floor)
    rows.sort(reverse=True)
    print(f"  TP {name} model={world}: gradients, the ranks' slices put "
          f"together: worst max |diff| {worst:.3e} = {worst / g_max:.3e} x "
          f"max|g| {g_max:.3e} (tol {tol / g_max:.3e} x max|g|"
          + (f", {TP_ULP_FACTOR} x the one-ulp floor "
             f"{floor / TP_ULP_FACTOR:.3e}" if floor else "")
          + "); worst against the leaf's own max|g|: " + "; ".join(
              f"{k} {q:.3e} ({e:.3e} / {s:.3e})" for q, k, e, s in rows[:4]))
    check(worst <= tol, f"TP {name} model={world}: gradients "
          f"{worst / g_max} x max|g|")


def _tp_launches(cfg, gen: int, grad: bool) -> dict:
    """The attention kernels' launches of one serve run of ``cfg``
    (prefill, then ``gen`` decode steps) or, ``grad``, one training step:
    ``flash_fwd`` for every full-sequence attention (the encoder's, each
    global or "crossdec" layer's self- and cross-attention; under a
    gradient the local layers' too), ``swa_prefill`` for a local layer's
    prefill, ``swa_decode`` for every attention a decode step runs (MLA
    decodes in plain einsums); the recurrent blocks none."""
    kinds = cfg.layer_kinds()
    n_local = kinds.count("local")
    n_full = (kinds.count("global") + 2 * kinds.count("crossdec")
              + (cfg.encoder.n_layers if cfg.encoder is not None else 0))
    if grad:
        n = n_full + n_local
        want = dict.fromkeys(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                             n)
    else:
        n_dec = 0 if cfg.mla is not None else (
            n_local + kinds.count("global") + 2 * kinds.count("crossdec"))
        want = {"flash_fwd": n_full, "swa_prefill": n_local,
                "swa_decode": n_dec * gen}
    return {k: v for k, v in want.items() if v}


def _tp_report(world, o, name, r, single, launches):
    """Print one rank's run of one model and hold it (``tp_path``)."""
    spec = TP["models"][name]
    cfg = _tp_cfg(spec, spec["n_layers"])
    gen = _tp_len(spec, "gen")
    who = f"TP {name} model={world} rank {o['rank']}"
    ulp = single.get("ulp", {})
    tol = max(TP_LOGIT_TOL * r["prefill_logits_scale"],
              TP_ULP_FACTOR * ulp.get("prefill_logits", 0.0))
    tol_last = max(TP_LOGIT_TOL * r["logits_scale"],
                   TP_ULP_FACTOR * ulp.get("logits", 0.0))
    busy = r["prefill_s"] + r["decode_first_s"] + (
        r["decode_ms_per_token"] * (gen - 1) / 1e3)
    k0, nk, KV = r["kv_heads"]
    even, kv = r["held"]["even"], r["held"]["kv"]
    c_got, c_want, c_whole = r["cache_held"]
    absorbed = ""
    if "absorbed_err" in r:
        absorbed = (f", absorbed last {r['absorbed_err']:.3e} (tol "
                    f"{TP_LOGIT_TOL * r['absorbed_scale']:.3e})")
    print(f"  {who}: prefill {r['prefill_s']:.3f} s (single "
          f"{single['prefill_s']:.3f}), decode "
          f"{r['decode_ms_per_token']:.2f} ms a token (single "
          f"{single['decode_ms_per_token']:.2f}); all_reduce "
          f"{r['serve_all_reduce_s']:.3f} s over {r['serve_all_reduce_n']} "
          f"calls, {r['serve_all_reduce_bytes'] / 1e9:.2f} GB "
          f"({r['serve_all_reduce_s'] / busy:.1%} of the serve run); peak "
          f"{r['serve_peak'] / 1e9:.2f} GB; logits max |diff| prefill "
          f"{r['prefill_logits_err']:.3e} last {r['logits_err']:.3e} (tol "
          f"{tol:.3e}, {tol_last:.3e}"
          f"{f', {TP_ULP_FACTOR} x the one-ulp floor' if ulp else ''})"
          f"{absorbed}; tokens "
          f"{'equal' if r['tokens_equal'] else 'DIFFER'}; kv heads "
          f"{k0}-{k0 + nk - 1} of {KV}, cache {c_got / c_whole:.4f} of the "
          f"whole, cut leaves {even[0] / even[1]:.4f}"
          + (f", kv leaves {kv[0] / kv[1]:.4f}" if kv[1] else "")
          + f"; launches {r['serve_launches']}")
    check(r["prefill_logits_err"] <= tol and r["logits_err"] <= tol_last,
          f"{who}: logits {r['prefill_logits_err']}, {r['logits_err']}")
    if "absorbed_err" in r:
        check(r["absorbed_err"] <= TP_LOGIT_TOL * r["absorbed_scale"],
              f"{who}: absorbed decode logits {r['absorbed_err']}")
    check(r["tokens_equal"], f"{who}: greedy tokens differ")
    check(c_got == c_want,
          f"{who}: cache holds {c_got} of {c_whole} entries, not {c_want}")
    check(even[0] * world == even[1], f"{who}: cut leaves {even}")
    check(kv[0] * KV == kv[1] * nk, f"{who}: kv leaves {kv}")
    want = _tp_launches(cfg, gen, grad=False)
    got = {k: v for k, v in r["serve_launches"].items() if v}
    check(got == want, f"{who}: serve launches {got}, not {want}")
    for part in ("serve_launches", "sp_launches", "step_launches"):
        for k, v in r.get(part, {}).items():
            launches[k] += v
    if "sp_err" in r:
        sp_tol = TP_SP_TOL * r["prefill_logits_scale"]
        print(f"  {who}: seq_parallel prefill max |diff| vs plain "
              f"{r['sp_err']:.3e} (tol {sp_tol:.3e})")
        check(r["sp_err"] <= sp_tol, f"{who}: seq_parallel {r['sp_err']}")
    if name == "glm4" and world == 2 and "glm4 serve (1, 2)" in PREDICTED:
        p = PREDICTED["glm4 serve (1, 2)"]
        _hold_predicted(who, "glm4 serve (1, 2)", {
            "serve all_reduce [calls, bytes]": (
                [r["serve_all_reduce_n"], r["serve_all_reduce_bytes"]],
                _coll_all(p)),
            "peak serving": (r["serve_peak"],
                             p["param_bytes"] + p["cache_bytes"])})
    if "loss" not in r:
        return
    if name == "glm4" and world == 2 and "glm4 train (1, 2)" in PREDICTED:
        p = PREDICTED["glm4 train (1, 2)"]
        _hold_predicted(who, "glm4 train (1, 2)", {
            "step all_reduce [calls, bytes]": (
                [r["step_all_reduce_n"], r["step_all_reduce_bytes"]],
                _coll_all(p)),
            "peak of the step": (r["step_peak"],
                                 p["param_bytes"] + p["opt_bytes"])})
    worst = max(e / max(s, 1e-30) for e, s in r["grad_errs"].values())
    cfg1 = _tp_cfg(spec, spec["grad_layers"])
    print(f"  {who}: AdamW step at {cfg1.n_layers} layers {r['step_s']:.2f} "
          f"s (single {single['step_s']:.2f}), peak "
          f"{r['step_peak'] / 1e9:.2f} GB (single "
          f"{single['step_peak'] / 1e9:.2f}); all_reduce "
          f"{r['step_all_reduce_s']:.3f} s over {r['step_all_reduce_n']} "
          f"calls ({r['step_all_reduce_s'] / r['step_s']:.1%}); loss "
          f"{r['loss']:.6f} (single {r['loss_ref']:.6f}); its slices' "
          f"worst max |diff| / the slice's max|g| {worst:.3e}; launches "
          f"{r['step_launches']}")
    check(abs(r["loss"] - r["loss_ref"]) <= TP_LOSS_TOL * abs(r["loss_ref"]),
          f"{who}: loss {r['loss']} vs {r['loss_ref']}")
    got = {k: v for k, v in r["step_launches"].items() if v}
    want = _tp_launches(cfg1, 0, grad=True)
    check(got == want, f"{who}: step launches {got}, not {want}")


# FSDP over the data axes (``tp_path``'s spawns, ``fsdp_rank``): whisper-
# small whole at published widths on a second mesh over the same ranks,
# (data 2, model 1) on the 2 and (data 2, model 2) on the 4, with the TP
# phase's inputs (batch 2: one row a data rank; 416-token prompts over
# 1500 frames, 4 greedy tokens; one AdamW step at 2 x 448) and its
# one-process reference; the (data 2, model 2) trainer writes the
# checkpoint that ``_ckpt_check`` cuts back bit-equal (``CKPT``).
FSDP = dict(model="whisper", ckpt_world=4)


def _fsdp_held(cfg, data, model, model_rank):
    """(parameters the executed cut leaves a rank: ``tp_leaf_slice``'s
    model part, then 1/data of each leaf ``data_cut_dim`` cuts; the
    plan's count, ``param_specs`` at (data, model); the whole model's)."""
    from repro_torch import tree as tu
    from repro_torch.models import transformer as T
    from repro_torch.sharding.rules import (data_cut_dim, param_specs,
                                            tp_leaf_slice)
    shapes = T.init_params(None, cfg, device="meta")
    sizes = {"data": data, "model": model}
    plan = dict(tu.flatten(param_specs(shapes, sizes, ("data",))))
    held = planned = whole = 0
    for path, t in tu.flatten(shapes):
        key, n = "/".join(path), t.numel()
        whole += n
        cut = tp_leaf_slice(key, tuple(t.shape), cfg, model, model_rank)
        h = n if cut is None else n // t.shape[cut[0]] * cut[2]
        if data_cut_dim(key, tuple(t.shape), cfg, model, data) is not None:
            h //= data
        held += h
        ext = 1
        for e in plan[path]:
            for a in (e if isinstance(e, tuple) else (e,) if e else ()):
                ext *= sizes[a]
        planned += n // ext
    return held, planned, whole


def fsdp_rank(world, ref_dir, dev, device_type, tally, counts, reset):
    """One rank of the FSDP phase (``FSDP``) on a (data 2, model world/2)
    mesh over ``tp_rank``'s ranks: serve whisper-small through
    ``launch.serve.run`` (its row of the 2 prompts; every prefill and
    decode step gathers the units' data parts), one AdamW step on its row
    of the batch, its gradients gathered over data and held against the
    one-process slices under ``ref_dir``; the resident bytes, the
    gathers' and reduce-scatters' seconds, peaks and launches."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import tree as tu
    from repro_torch.models import transformer as T
    from repro_torch.sharding import ShardCtx, tp_slice
    from repro_torch.sharding.collectives import gather_padded
    from repro_torch.sharding.rules import (data_rows, fsdp_dims,
                                            tp_slice_rank)

    name = FSDP["model"]
    spec = TP["models"][name]
    m = world // 2
    mesh = init_device_mesh(device_type, (2, m),
                            mesh_dim_names=("data", "model"))
    ctx = ShardCtx(mesh=mesh, data_axes=("data",), model_axis="model")
    tally["data_groups"] = tuple(ctx.data_groups())
    ref = torch.load(os.path.join(ref_dir, f"{name}.pt"))
    o = {"rank": dist.get_rank(), "mesh": (2, m), "data_rank": ctx.data_rank,
         "model_rank": ctx.model_rank}

    def data_tally():
        return {k: list(v) for k, v in tally["data"].items()}

    reset()
    tally["data"] = {}
    res = _tp_serve(spec, dev, ctx)
    o.update(serve_launches=counts(), prefill_s=res["prefill_s"],
             decode_first_s=res["decode_first_s"],
             decode_ms_per_token=res["decode_ms_per_token"],
             serve_all_reduce_s=tally["s"], serve_data=data_tally(),
             serve_peak=torch.cuda.max_memory_allocated())
    cfg, params, rows = res["cfg"], res["params"], res["rows"]
    lo = T.vocab_lo(params, cfg, ctx)
    for key in ("prefill_logits", "logits"):
        got = res[key].float().cpu()
        want = ref[key][rows]
        if lo is not None:
            want = want[:, lo:lo + got.shape[-1]]
        o[f"{key}_err"] = float((got - want).abs().max())
        o[f"{key}_scale"] = float(ref[key].abs().max())
    o["tokens_equal"] = bool(torch.equal(res["tokens"].cpu(), ref["tokens"]))
    o["held"] = (sum(t.numel() for t in tu.leaves(params)),) + _fsdp_held(
        cfg, 2, m, ctx.model_rank)
    del res, params
    free_device()
    o["b1"] = _fsdp_seq_serve(spec, ctx, dev, ref_dir, tally, counts, reset)

    cfg1 = _tp_cfg(spec, spec["grad_layers"])
    mine = None
    for r in range(world):
        # one rank draws the whole model at a time, keeps its part
        if r == dist.get_rank():
            full = T.init_params(torch.Generator(device=dev).manual_seed(0),
                                 cfg1, device=dev)
            mine = tp_slice(full, ctx, cfg1)
            del full
            free_device()
        dist.barrier()
    batch = _tp_batch(spec, cfg1, dev)
    mine_rows = data_rows(EP["batch"], ctx)
    batch = {k: v[mine_rows] for k, v in batch.items()}
    reset()
    tally["data"] = {}
    (loss, grads), o["step_s"], o["step_peak"] = _synced(
        lambda: _ep_step(cfg1, mine, batch, ctx))
    n_held = sum(t.numel() for t in tu.leaves(mine))
    # AdamW keeps m, v and an f32 master copy beside each f32 parameter
    o.update(step_launches=counts(), loss=loss, loss_ref=ref["loss"],
             step_all_reduce_s=tally["s"], step_data=data_tally(),
             resident_bytes=4 * n_held * 4)
    del mine, batch
    dims = fsdp_dims(cfg1, ctx)
    model_part = tu.map_with_path(
        lambda p, g: g if dims["/".join(p)] is None else gather_padded(
            g.contiguous(), dims["/".join(p)], ctx.data_rank, 2,
            ctx.data_sum), grads)
    del grads
    o["grad_errs"] = {}
    for r in (range(2) if m == 1 else (ctx.model_rank,)):
        want = torch.load(os.path.join(ref_dir, f"{name}_grads{r}.pt"),
                          map_location=dev, mmap=True)
        part = model_part if m > 1 else tp_slice_rank(model_part, cfg1, 2, r)
        for path, g in tu.flatten(part):
            key = "/".join(path)
            err = float((g - want[key]).abs().max())
            prev = o["grad_errs"].get(key, (0.0, 0.0))
            o["grad_errs"][key] = (max(prev[0], err),
                                   max(prev[1], float(want[key].abs().max())))
        del want, part
    del model_part
    free_device()
    if world == FSDP["ckpt_world"]:
        o["ckpt"] = _ckpt_rank(ctx, dev, ref_dir, spec)
    tally["data_groups"] = ()
    return o


def _fsdp_seq_serve(spec, ctx, dev, ref_dir, tally, counts, reset):
    """``fsdp_rank``'s batch 1: whisper-small served through
    ``launch.serve.run`` at one row, which the data axis of 2 does not
    split: both data ranks serve it whole, each self-attention cache
    holds the rank's 210 of the 420 slots and every decode step's
    attention is combined over data. The rank's logits and tokens
    against one process's, the data ranks' logits and tokens bit-equal,
    the rank's cache blocks (its slots, its heads) against one process's
    cache; times, the combine's calls, bytes and seconds, the peak, the
    launches (of them, the ones with the log-sum-exp)."""
    from repro_torch import tree as tu
    from repro_torch.kernels.swa_attention import swa as sk
    from repro_torch.models import transformer as T
    from repro_torch.sharding.collectives import gather_padded
    from repro_torch.sharding.rules import (batch_ctx, cache_slot_cut,
                                            tp_cache_slice)

    name = FSDP["model"]
    ref = torch.load(os.path.join(ref_dir, f"{name}_b1.pt"))
    reset()
    tally["data"] = {}
    res = _tp_serve(spec, dev, ctx, batch=1)
    o = {"launches": counts(), "lse_launches": sk.lse_launches(),
         "prefill_s": res["prefill_s"],
         "decode_first_s": res["decode_first_s"],
         "decode_ms_per_token": res["decode_ms_per_token"],
         "data": {k: list(v) for k, v in tally["data"].items()},
         "peak": torch.cuda.max_memory_allocated()}
    cfg = res["cfg"]
    lo = T.vocab_lo(res["params"], cfg, ctx)

    def both(t):
        # every data rank's t, in order: a zero-padded sum, exact
        return gather_padded(t[None].contiguous(), 0, ctx.data_rank, 2,
                             ctx.data_sum)
    for key in ("prefill_logits", "logits"):
        got = res[key].float()
        pair = both(got)
        o[f"{key}_bit_equal"] = bool(torch.equal(pair[0], pair[1]))
        want = ref[key]
        if lo is not None:
            want = want[:, lo:lo + got.shape[-1]]
        o[f"{key}_err"] = float((got.cpu() - want).abs().max())
        o[f"{key}_scale"] = float(ref[key].abs().max())
    pair = both(res["tokens"])
    o["tokens_bit_equal"] = bool(torch.equal(pair[0], pair[1]))
    o["tokens_equal"] = bool(torch.equal(res["tokens"].cpu(), ref["tokens"]))
    seq = batch_ctx(1, ctx)
    m = ctx.model_size
    o["cache"] = {}
    for p, t in tu.flatten(res["cache"]):
        key = "/".join(p)
        if key not in ref["cache"]:
            continue
        want = ref["cache"][key]
        slots = cache_slot_cut(key, tuple(want.shape), seq)  # dim, lo, hi
        heads = tp_cache_slice(key, tuple(want.shape), cfg, m,
                               ctx.model_rank)                # dim, lo, n
        if slots is not None:
            want = want.narrow(slots[0], slots[1], slots[2] - slots[1])
        if heads is not None:
            want = want.narrow(*heads)
        o["cache"][key] = (float((t.cpu() - want).abs().max()),
                           float(ref["cache"][key].abs().max()),
                           None if slots is None else slots[1:])
    del res
    free_device()
    return o


def _fsdp_seq_report(o, who, single):
    """Print an FSDP rank's batch-1 run (``_fsdp_seq_serve``) and hold
    it; returns its launches."""
    spec = TP["models"][FSDP["model"]]
    cfg = _tp_cfg(spec, spec["n_layers"])
    gen = _tp_len(spec, "gen")
    b = o["b1"]
    L = _tp_len(spec, "prompt_len") + gen
    tol = TP_LOGIT_TOL * b["prefill_logits_scale"]
    tol_last = TP_LOGIT_TOL * b["logits_scale"]
    n_self = sum(k in ("global", "crossdec") for k in cfg.layer_kinds())
    comb = b["data"].get("combine", [0.0, 0, 0])
    cache_err = max(e / s for e, s, _ in b["cache"].values())
    half = L // 2
    cuts = {c for _, _, c in b["cache"].values()}
    want_cut = (o["data_rank"] * half, (o["data_rank"] + 1) * half)
    print(f"  {who} batch 1 (sequence-split cache, {half} of {L} self "
          f"slots a data rank): prefill {b['prefill_s']:.3f} s (single "
          f"{single['b1']['prefill_s']:.3f}), decode "
          f"{b['decode_ms_per_token']:.2f} ms a token (single "
          f"{single['b1']['decode_ms_per_token']:.2f}); combine "
          f"{comb[0]:.4f} s over {comb[1]} calls, {comb[2]} bytes; data "
          f"axis all: " + ", ".join(
              f"{k} {v[0]:.3f} s / {v[1]} calls / {v[2] / 1e9:.3f} GB"
              for k, v in sorted(b["data"].items()))
          + f"; peak {b['peak'] / 1e9:.2f} GB; logits max |diff| prefill "
          f"{b['prefill_logits_err']:.3e} last {b['logits_err']:.3e} (tol "
          f"{tol:.3e}, {tol_last:.3e}); data ranks bit-equal: logits "
          f"{b['prefill_logits_bit_equal'] and b['logits_bit_equal']}, "
          f"tokens {b['tokens_bit_equal']}; tokens "
          f"{'equal' if b['tokens_equal'] else 'DIFFER'}; self cache blocks "
          f"{sorted(cuts, key=str)} worst |diff| / max {cache_err:.3e}; "
          f"launches {b['launches']}, {b['lse_launches']} with the lse")
    check(b["prefill_logits_err"] <= tol and b["logits_err"] <= tol_last,
          f"{who} batch 1: logits {b['prefill_logits_err']}, "
          f"{b['logits_err']}")
    check(b["prefill_logits_bit_equal"] and b["logits_bit_equal"]
          and b["tokens_bit_equal"],
          f"{who} batch 1: the data ranks' logits or tokens differ")
    check(b["tokens_equal"], f"{who} batch 1: greedy tokens differ")
    check(cache_err <= TP_LOGIT_TOL, f"{who} batch 1: cache {cache_err}")
    check(cuts == {want_cut},
          f"{who} batch 1: self cache slot blocks {cuts}, not {want_cut}")
    want = _tp_launches(cfg, gen, grad=False)
    got = {k: v for k, v in b["launches"].items() if v}
    check(got == want, f"{who} batch 1: launches {got}, not {want}")
    check(b["lse_launches"] == n_self * gen and comb[1] == n_self * gen,
          f"{who} batch 1: {b['lse_launches']} lse launches, {comb[1]} "
          f"combines, not {n_self * gen}")
    return b["launches"], b["lse_launches"]


def _fsdp_report(o, single, launches):
    """Print one FSDP rank's run (``fsdp_rank``) and hold it."""
    spec = TP["models"][FSDP["model"]]
    cfg = _tp_cfg(spec, spec["n_layers"])
    gen = _tp_len(spec, "gen")
    m = o["mesh"][1]
    who = (f"FSDP {FSDP['model']} data=2 model={m} rank {o['rank']} "
           f"(data {o['data_rank']}, model {o['model_rank']})")
    tol = TP_LOGIT_TOL * o["prefill_logits_scale"]
    tol_last = TP_LOGIT_TOL * o["logits_scale"]
    busy = o["prefill_s"] + o["decode_first_s"] + (
        o["decode_ms_per_token"] * (gen - 1) / 1e3)
    held, planned, whole = o["held"][1:]

    def data_line(rows, wall):
        return ", ".join(f"{k} {v[0]:.3f} s over {v[1]} calls, "
                         f"{v[2] / 1e9:.2f} GB ({v[0] / wall:.1%})"
                         for k, v in sorted(rows.items()))
    print(f"  {who}: params {o['held'][0] / 1e6:.2f} M a rank (the executed "
          f"cut {held / 1e6:.2f} M, the plan {planned / 1e6:.2f} M, one "
          f"process {whole / 1e6:.2f} M); params + AdamW "
          f"{o['resident_bytes'] / 1e9:.3f} GB a rank (one process "
          f"{16 * whole / 1e9:.3f} GB); prefill {o['prefill_s']:.3f} s "
          f"(single {single['prefill_s']:.3f}), decode "
          f"{o['decode_ms_per_token']:.2f} ms a token (single "
          f"{single['decode_ms_per_token']:.2f}); serve data axis: "
          f"{data_line(o['serve_data'], busy)}; all_reduce "
          f"{o['serve_all_reduce_s']:.3f} s; peak "
          f"{o['serve_peak'] / 1e9:.2f} GB; logits max |diff| prefill "
          f"{o['prefill_logits_err']:.3e} last {o['logits_err']:.3e} (tol "
          f"{tol:.3e}, {tol_last:.3e}); tokens "
          f"{'equal' if o['tokens_equal'] else 'DIFFER'}; launches "
          f"{o['serve_launches']}")
    print(f"  {who}: AdamW step {o['step_s']:.2f} s (single "
          f"{single['step_s']:.2f}), peak {o['step_peak'] / 1e9:.2f} GB "
          f"(single {single['step_peak'] / 1e9:.2f}); step data axis: "
          f"{data_line(o['step_data'], o['step_s'])}; all_reduce "
          f"{o['step_all_reduce_s']:.3f} s; loss {o['loss']:.6f} (single "
          f"{o['loss_ref']:.6f}); launches {o['step_launches']}")
    check(o["prefill_logits_err"] <= tol and o["logits_err"] <= tol_last,
          f"{who}: logits {o['prefill_logits_err']}, {o['logits_err']}")
    check(o["tokens_equal"], f"{who}: greedy tokens differ")
    check(o["held"][0] == held, f"{who}: holds {o['held'][0]}, not {held}")
    check(abs(o["loss"] - o["loss_ref"]) <= TP_LOSS_TOL * abs(o["loss_ref"]),
          f"{who}: loss {o['loss']} vs {o['loss_ref']}")
    want = _tp_launches(cfg, gen, grad=False)
    got = {k: v for k, v in o["serve_launches"].items() if v}
    check(got == want, f"{who}: serve launches {got}, not {want}")
    want = _tp_launches(_tp_cfg(spec, spec["grad_layers"]), 0, grad=True)
    got = {k: v for k, v in o["step_launches"].items() if v}
    check(got == want, f"{who}: step launches {got}, not {want}")
    _fsdp_predicted(o, who, m)
    b1, n_lse = _fsdp_seq_report(o, who, single)
    for part in (o["serve_launches"], o["step_launches"], b1):
        for k, v in part.items():
            launches[k] += v
    launches["swa_decode_lse"] += n_lse


def _fsdp_grads(world, parts):
    """The ranks' gradients, gathered over data, against the one-process
    slices: every leaf within ``TP_GRAD_TOL`` x max|g| (``_tp_grads``)."""
    errs = {}
    for p in parts:
        for key, (e, s) in p.items():
            prev = errs.get(key, (0.0, 0.0))
            errs[key] = (max(prev[0], e), max(prev[1], s))
    g_max = max(s for _, s in errs.values())
    worst = max(e for e, _ in errs.values())
    print(f"  FSDP {FSDP['model']} data=2 model={world // 2}: gradients, "
          f"gathered over data, worst max |diff| {worst:.3e} = "
          f"{worst / g_max:.3e} x max|g| {g_max:.3e} (tol {TP_GRAD_TOL:.0e} "
          f"x max|g|)")
    check(worst <= TP_GRAD_TOL * g_max,
          f"FSDP model={world // 2}: gradients {worst / g_max} x max|g|")


# the analysis phase (``analysis_phase``): the kernels pass of
# ``repro_torch.analysis``, and the dry run's predictions of what the FSDP
# and TP phases' ranks hold and move, counted on meta tensors under a
# fake process group (``launch.dryrun``) in a process of its own (the
# fake group must not share a process with the gloo spawns), started
# with the script (``start_predictions``) on the host's CPU and read
# before the tensor-parallel phase; ``tp_path``'s reports hold the
# ranks' measurements to them (``_hold_predicted``)
DRYRUN_TIMEOUT = 600
PREDICTED = {}          # case name -> the dry run's result
HELD = set()            # the cases a rank's measurement was held to


def dryrun_cases():
    """name -> (arch, INPUT_SHAPES name or None, ``count_pair``
    keywords): the runs of ``fsdp_rank`` (whisper-small whole, served at
    ``TP``'s batch and at batch 1, one AdamW step at ``EP``'s batch and
    its train length, on (data 2, model 1) and (2, 2)) and of
    ``tp_rank``'s glm4-9b at model 2 (served at ``TP``'s shapes, one
    step at ``EP``'s batch and length), f32, without remat, as the card
    runs them."""
    wh, glm = TP["models"]["whisper"], TP["models"]["glm4"]
    f32 = dict(dtype="float32", ctx_kw={"remat": False})
    out = {}
    for m in (1, 2):
        mesh = (2, m)
        for tag, batch in (("", TP["batch"]), (" b1", 1)):
            out[f"whisper serve{tag} {mesh}"] = (
                "whisper-small", None, dict(
                    mesh_shape=mesh, batch=batch, serve=(
                        _tp_len(wh, "prompt_len"), _tp_len(wh, "gen")),
                    n_layers=wh["n_layers"], **f32))
        out[f"whisper train {mesh}"] = ("whisper-small", "train_4k", dict(
            mesh_shape=mesh, batch=EP["batch"], seq=wh["train_seq"],
            n_layers=wh["grad_layers"], loss_chunk=0, **f32))
    out["glm4 serve (1, 2)"] = ("glm4-9b", None, dict(
        mesh_shape=(1, 2), n_layers=glm["n_layers"], batch=TP["batch"],
        serve=(_tp_len(glm, "prompt_len"), _tp_len(glm, "gen")), **f32))
    out["glm4 train (1, 2)"] = ("glm4-9b", "train_4k", dict(
        mesh_shape=(1, 2), n_layers=glm["grad_layers"], batch=EP["batch"],
        seq=EP["S"], loss_chunk=0, **f32))
    return out


def predict(path):
    """``chip_smoke.py --predict PATH``: every ``dryrun_cases`` run
    through ``launch.dryrun.run_pair`` (the function ``--all`` calls),
    written to PATH as JSON. Needs no card."""
    from repro_torch.launch import dryrun
    out = {}
    for name, (arch, shape, kw) in dryrun_cases().items():
        out[name] = dryrun.run_pair(arch, shape, **kw)
    with open(path, "w") as f:
        json.dump(out, f)
    return 0


def start_predictions():
    """``predict`` in a process of its own, on the CPU (no card), beside
    the first phases; returns (the process, its output path)."""
    import atexit
    d = rank_dir("dryrun")
    path = os.path.join(d, "predicted.json")
    log = open(os.path.join(d, "predict.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--predict", path],
        stdout=log, stderr=subprocess.STDOUT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, path


def _coll(res, axis, label):
    """[calls, bytes] of the dry run's collectives ``label`` on ``axis``
    (zeros when it issued none)."""
    return res["counts"]["collectives"].get(axis, {}).get(label, [0, 0])


def _coll_all(res):
    """[calls, bytes] of every collective of a dry run."""
    rows = [v for t in res["counts"]["collectives"].values()
            for v in t.values()]
    return [sum(r[0] for r in rows), sum(r[1] for r in rows)]


def _hold_predicted(who, name, pairs: dict):
    """Print and hold a rank's measurements to the dry run's predictions
    for ``PREDICTED[name]``: ``pairs[key] = (measured, predicted)``,
    equal; a ``peak ...`` key's measurement must be at least the
    predicted resident bytes (the ratio printed)."""
    HELD.add(name)
    for key, (g, w) in pairs.items():
        if key.startswith("peak"):
            print(f"  {who}: {key} measured {g / 1e9:.3f} GB, the dry run's "
                  f"resident bytes {w / 1e9:.3f} GB (ratio {g / w:.3f})")
            check(g >= w, f"{who}: {key} {g} below the predicted {w}")
        else:
            print(f"  {who}: {key} {g} (dry run {w})")
            check(g == w, f"{who}: {key} {g}, the dry run predicted {w}")


def _fsdp_predicted(o, who, m):
    """An FSDP rank (``fsdp_rank`` at (data 2, model m)) held to the dry
    run: its parameters, the data axis's unit gathers of the serve run,
    its parameter + AdamW bytes and the step's gathers, reduce-scatters
    and loss sums, the batch-1 serve's gathers and combines, exactly;
    its serving and step peaks at least the resident bytes predicted."""
    name = f"whisper serve (2, {m})"
    if name in PREDICTED:
        r = PREDICTED[name]
        _hold_predicted(who, name, {
            "parameters": (o["held"][0], r["params"]),
            "serve data gather [calls, bytes]": (
                o["serve_data"]["gather"][1:], _coll(r, "data", "gather")),
            "peak serving": (o["serve_peak"],
                             r["param_bytes"] + r["cache_bytes"])})
    name = f"whisper train (2, {m})"
    if name in PREDICTED:
        r = PREDICTED[name]
        resident = r["param_bytes"] + r["opt_bytes"]
        _hold_predicted(who, name, {
            "parameters + AdamW bytes": (o["resident_bytes"], resident),
            **{f"step data {k} [calls, bytes]": (
                o["step_data"].get(k, [0, 0, 0])[1:], _coll(r, "data", k))
               for k in ("gather", "reduce_scatter", "loss_sum")},
            "peak of the step": (o["step_peak"], resident)})
    name = f"whisper serve b1 (2, {m})"
    if name in PREDICTED:
        r, b = PREDICTED[name], o["b1"]
        _hold_predicted(who + " batch 1", name, {
            f"data {k} [calls, bytes]": (b["data"].get(k, [0, 0, 0])[1:],
                                         _coll(r, "data", k))
            for k in ("gather", "combine")})


def analysis_phase(pred_proc, pred_path):
    """(a) The kernels pass of ``repro_torch.analysis`` over the four
    built libraries (every instantiation's registers, shared bytes and
    spills from ptxas against the H100's per-block limits) and the op
    wrappers' launch surface (each case's CUDA kernel names); clean.
    (b) The dry run's predictions (``start_predictions``): each case
    ``OK``, kept in ``PREDICTED`` for ``tp_path``'s reports."""
    from repro_torch.analysis import kernels_check as kc

    t0 = time.perf_counter()
    findings, n = kc.check_all(verbose=True)
    for f in findings:
        print(f"  finding {f.format()}")
    print(f"  kernels pass: {n} checks ({len(kc.resources())} "
          f"instantiations of {len(kc.SOURCES)} sources, "
          f"{len(kc.cases())} launch cases), {len(findings)} finding(s), "
          f"{time.perf_counter() - t0:.1f} s")
    check(not findings, f"kernels pass: {len(findings)} finding(s)")
    t0 = time.perf_counter()
    try:
        pred_proc.wait(timeout=DRYRUN_TIMEOUT)
    finally:
        if pred_proc.poll() is None:
            pred_proc.kill()
    check(pred_proc.returncode == 0,
          f"the dry run's predictions exited {pred_proc.returncode} (see "
          f"{os.path.join(os.path.dirname(pred_path), 'predict.log')})")
    with open(pred_path) as f:
        PREDICTED.update(json.load(f))
    for name, r in PREDICTED.items():
        check(r["status"] == "OK", f"dry run {name}: {r}")
        print(f"  dry run {name}: {r['params'] / 1e6:.2f} M parameters, "
              f"{r['param_bytes'] / 1e9:.3f} GB + optimizer "
              f"{r['opt_bytes'] / 1e9:.3f} GB + cache "
              f"{r['cache_bytes'] / 1e9:.3f} GB a rank, activation peak "
              f"{r['activation_peak_bytes'] / 1e9:.3f} GB, "
              f"{r['counts']['dot_flops']:.4e} dot FLOPs, collectives "
              f"{json.dumps(r['counts']['collectives'])}; counted in "
              f"{r['t_lower_s']:.1f} s")
    print(f"  dry run predictions waited for "
          f"{time.perf_counter() - t0:.1f} s")


def build_kernels(wait=True):
    """Every CUDA source of the port, one nvcc each, started together.
    With ``wait=False`` it returns once the aggregation and NetChange
    libraries (the VGG phases' kernels) are built, and gives back a
    function that waits for the attention libraries: their builds go on
    beside the first phases."""
    from repro_torch.kernels.fedavg import fedavg as fk
    from repro_torch.kernels.flash_attention import flash as ff
    from repro_torch.kernels.netchange import widen as wk
    from repro_torch.kernels.swa_attention import swa as sk

    def beside(build):
        # nvcc at a lower priority (the nice value is a thread's on Linux,
        # and the compiler inherits it), so the phases it runs beside
        # keep the cores
        def run():
            os.nice(10)
            return build()
        return run

    t0 = time.perf_counter()
    builders = (fk.build, wk.build) + tuple(
        b if wait else beside(b) for b in (ff.build, sk.build))
    pool = ThreadPoolExecutor(max_workers=len(builders))
    futures = [pool.submit(b) for b in builders]

    def done(fs, what):
        paths = [f.result() for f in fs]
        print(f"built {', '.join(p.name for p in paths)} {what}"
              f"{time.perf_counter() - t0:.1f} s")

    def join():
        done(futures[2:], "in ")
        pool.shutdown()
    if wait:
        done(futures, "in ")
        pool.shutdown()
        return None
    done(futures[:2], "in ")
    return join


def front_row(rows, kernel, name, decode=False):
    """The ``kernels`` line's numbers of ``kernel`` at a front-end shape
    (``front_kernel_phase``'s row whose key starts with ``kernel name``)."""
    key = next(k for k in rows if k.startswith(f"{kernel} {name} "))
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return {"shape": key[len(kernel) + 1:],
            **{k: rows[key][k] for k in keys + (("device_ms",) if decode
                                                else ())}}


def tp_kernel_rows(rows, kernel):
    """The ``kernels`` line's numbers of ``kernel`` at the tensor-parallel
    ranks' shapes (``tp_kernel_phase``), by shape."""
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return {k[len(kernel) + 1:]: {x: r[x] for x in keys + tuple(
        x for x in ("device_ms",) if x in r)}
        for k, r in rows.items() if k.startswith(f"{kernel} ")}


def kernel_entry(name, route_source, replaces, launches, err, r):
    return {"name": name, "route": "cuda", "source": route_source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            **{k: r[k] for k in ("device_ms", "call_ms", "host_us")
               if k in r}}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="trace one warm VGG round per layout instead")
    ap.add_argument("--predict", metavar="PATH",
                    help="write the dry run's predictions of the FSDP and "
                         "TP phases to PATH and exit (no card needed)")
    args = ap.parse_args()
    if args.predict:
        return predict(args.predict)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from repro_torch.configs.vgg_family import paper_client_archs, vgg
    from repro_torch.core import PlaneSpec, VGGFamily
    from repro_torch.device import strict_f32
    from repro_torch.kernels.fedavg import fedavg as fk
    from repro_torch.kernels.flash_attention import flash as ff
    from repro_torch.kernels.swa_attention import swa as sk

    card = card_line()
    print(card)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda", 0)
    strict_f32(dev)
    # the phases' hand-over files under build/ (reference gradients a
    # rank reads back within the run) skip the zip CRC, most of
    # torch.save's time on gigabytes
    torch.serialization.set_crc32_options(False)
    if args.profile:
        build_kernels()
        profile_rounds()
        print(card)
        return 0
    t_start = time.perf_counter()
    # the dry run's predictions count on the host's CPU meanwhile
    pred_proc, pred_path = start_predictions()
    # the attention sources build while the VGG phases run
    join_builds = build_kernels(wait=False)
    family = VGGFamily()
    union = family.union([vgg(a) for a in paper_client_archs()])
    P = PlaneSpec.from_tree(family.shapes(union)).size
    errs = Errors()
    print("fedavg kernel phase")
    rows = kernel_phase(dev, P, errs)
    rows.update(wire_kernel_phase(dev, P, errs))
    print(f"VGG main-path phase ({time.perf_counter() - t_start:.0f} s)")
    launches, g_f32, g_cov, g_plane = main_path()
    print(f"baselines phase ({time.perf_counter() - t_start:.0f} s)")
    mm_refs = {}
    for k, v in baselines_path(dev, g_f32, g_cov, refs=mm_refs).items():
        launches[k] += v
    del g_cov
    print(f"wire phase ({time.perf_counter() - t_start:.0f} s)")
    for k, v in wire_path(g_f32, refs=mm_refs).items():
        launches[k] += v
    join_builds()       # before the spawned ranks load any library
    print(f"analysis phase ({time.perf_counter() - t_start:.0f} s)")
    analysis_phase(pred_proc, pred_path)
    print(f"client mesh phase ({time.perf_counter() - t_start:.0f} s)")
    for k, v in mesh_path(g_plane, g_f32, refs=mm_refs).items():
        launches[k] += v
    del g_plane, mm_refs
    del g_f32
    print(f"fedavg_stacked phase ({time.perf_counter() - t_start:.0f} s)")
    for k, v in stacked_path(dev).items():
        launches[k] += v
    print(f"flash kernel phase ({time.perf_counter() - t_start:.0f} s)")
    frows = flash_kernel_phase(dev, errs)
    print(f"transformer main-path phase "
          f"({time.perf_counter() - t_start:.0f} s)")
    flaunches, tinfo = tffn_main_path({k: r["ms"] for k, r in frows.items()})
    print(json.dumps({"transformer_main_path": {
        "round_wall_s": tinfo["flash"]["round_wall_s"],
        "train_s": tinfo["flash"]["phase_stats"]["train"],
        "max_memory_allocated": tinfo["flash"]["max_memory_allocated"]}}))
    print(f"serving kernel phase ({time.perf_counter() - t_start:.0f} s)")
    srows = swa_kernel_phase(dev, errs)
    wrows = widen_kernel_phase(dev, errs)
    print(f"serve path phase ({time.perf_counter() - t_start:.0f} s)")
    slaunches, sinfo = serve_path(dev)
    print(f"head dims 8 and 256 kernel phase "
          f"({time.perf_counter() - t_start:.0f} s)")
    hd_kernel_phase(dev, errs)
    for spec in DENSE_SERVE:
        print(f"{spec['arch']} serve path phase "
              f"({time.perf_counter() - t_start:.0f} s)")
        for k, v in dense_serve_path(dev, spec)[0].items():
            slaunches[k] += v
    print(f"gemma-7b cohort phase ({time.perf_counter() - t_start:.0f} s)")
    glaunches, ginfo = gemma_cohort_path()
    for k in ff.KERNELS:
        flaunches[k] += glaunches[k]
    print(f"trainer phase ({time.perf_counter() - t_start:.0f} s)")
    for k, v in trainer_path(dev)[0].items():
        flaunches[k] += v
    print(f"head dim 192 kernel phase "
          f"({time.perf_counter() - t_start:.0f} s)")
    mrows = mla_kernel_phase(dev, errs)
    for spec in MOE_SERVE:
        print(f"{spec['arch']} serve path phase "
              f"({time.perf_counter() - t_start:.0f} s)")
        for k, v in moe_serve_path(dev, spec, errs)[0].items():
            (slaunches if k in sk.KERNELS else flaunches)[k] += v
    print(f"mixtral cohort phase ({time.perf_counter() - t_start:.0f} s)")
    mlaunches, _ = moe_cohort_path(dev, errs)
    for k in fk.KERNELS:
        launches[k] += mlaunches[k]
    for k in ff.KERNELS:
        flaunches[k] += mlaunches[k]
    slaunches["swa_prefill"] += mlaunches["swa_prefill"]
    print(f"deepseek trainer phase ({time.perf_counter() - t_start:.0f} s)")
    for k, v in moe_trainer_path(dev)[0].items():
        flaunches[k] += v
    print(f"recurrent kernel phase ({time.perf_counter() - t_start:.0f} s)")
    rrows = recurrent_kernel_phase(dev, errs)
    for spec in RECURRENT_SERVE:
        print(f"{spec['arch']} serve path phase "
              f"({time.perf_counter() - t_start:.0f} s)")
        for k, v in recurrent_serve_path(dev, spec, errs)[0].items():
            (slaunches if k in sk.KERNELS else flaunches)[k] += v
    print(f"recurrentgemma cohort phase "
          f"({time.perf_counter() - t_start:.0f} s)")
    rlaunches, _ = rg_cohort_path(dev, errs)
    print(f"xlstm cohort phase ({time.perf_counter() - t_start:.0f} s)")
    xlaunches, _ = xlstm_cohort_path(dev)
    for part in (rlaunches, xlaunches):
        for k in fk.KERNELS:
            launches[k] += part[k]
        for k in ff.KERNELS:
            flaunches[k] += part[k]
        for k in sk.KERNELS:
            slaunches[k] += part[k]
    print(f"xlstm trainer phase ({time.perf_counter() - t_start:.0f} s)")
    xlstm_trainer_path(dev)
    t_front = time.perf_counter()
    print(f"front-end kernel phase ({t_front - t_start:.0f} s)")
    front_rows = front_kernel_phase(dev, errs)
    for spec in FRONT_SERVE:
        print(f"{spec['arch']} serve path phase "
              f"({time.perf_counter() - t_start:.0f} s)")
        for k, v in front_serve_path(dev, spec, errs)[0].items():
            (slaunches if k in sk.KERNELS else flaunches)[k] += v
    for spec in FRONT_TRAIN:
        print(f"{spec['arch']} trainer phase "
              f"({time.perf_counter() - t_start:.0f} s)")
        for k, v in front_trainer_path(dev, spec)[0].items():
            flaunches[k] += v
    print(f"internvl2-1b cohort phase "
          f"({time.perf_counter() - t_start:.0f} s)")
    ivlaunches, _ = iv_cohort_path(dev, errs)
    for k in fk.KERNELS:
        launches[k] += ivlaunches[k]
    for k in ff.KERNELS:
        flaunches[k] += ivlaunches[k]
    print(f"whisper up phase ({time.perf_counter() - t_start:.0f} s)")
    uplaunches, _ = whisper_up_path(dev)
    for k in ff.KERNELS:
        flaunches[k] += uplaunches[k]
    print(f"front-end phases took {time.perf_counter() - t_front:.0f} s")
    t_slice = time.perf_counter()
    print(f"expert-parallel phase ({t_slice - t_start:.0f} s)")
    for k, v in ep_path(dev).items():
        (slaunches if k in sk.KERNELS else flaunches)[k] += v
    print(f"remat phase ({time.perf_counter() - t_start:.0f} s)")
    for k, v in remat_path(dev).items():
        flaunches[k] += v
    print(f"expert-parallel and remat phases took "
          f"{time.perf_counter() - t_slice:.0f} s")
    t_tp = time.perf_counter()
    print(f"tensor-parallel kernel phase ({t_tp - t_start:.0f} s)")
    tp_rows = tp_kernel_phase(dev, errs)
    print(f"tensor-parallel phase ({time.perf_counter() - t_start:.0f} s)")
    tp_launches = tp_path(dev)
    lse_launches = tp_launches.pop("swa_decode_lse")
    for k, v in tp_launches.items():
        (slaunches if k in sk.KERNELS else flaunches)[k] += v
    print(f"tensor-parallel phases took {time.perf_counter() - t_tp:.0f} s")
    check(HELD == set(PREDICTED), f"the dry run's cases "
          f"{sorted(set(PREDICTED) - HELD)} were held to no rank's run")
    print(f"phases done in {time.perf_counter() - t_start:.0f} s")

    main_row = {"weighted_sum": ("weighted_sum K=20", 425),
                "plane_agg": ("plane_agg K=20 m,mu,fb", 403),
                "plane_accum": ("plane_accum filler kc=16", 265),
                "plane_finish": ("plane_finish renorm+fb", 363),
                "plane_accum_q": ("plane_accum_q filler kc=16", 330),
                "weighted_sum_masked": ("weighted_sum_masked K=20", 459),
                "weighted_sum_masked_mult":
                    ("weighted_sum_masked_mult K=20", 494)}
    kernels = []
    for name in fk.KERNELS:
        variant, line = main_row[name]
        check(launches[name] > 0, f"{name} never launched on the main path")
        kernels.append(kernel_entry(name, SOURCE, f"{TPU_KERNELS}:{line}",
                                    launches[name], errs.max[name],
                                    rows[variant]))
    mla_tag = "hd=192 deepseek {} B={B} KV={KV} G={G} S={S}"
    rc, rd = RG_COHORT, RG_DECODE
    rg_tag = (f"recurrentgemma B={rc['k_chunk'] * rc['batch']} KV={rd['KV']}"
              f" G={rd['G']} S={rc['S']} w={rd['window']}")
    for name in ff.KERNELS:
        check(flaunches[name] > 0,
              f"{name} never launched on the transformer main path")
        kernels.append(kernel_entry(name, FLASH_SOURCE, FLASH_TPU[name],
                                    flaunches[name], errs.max[name],
                                    frows[name]))
        # the same kernel at MLA's head dim, at deepseek's trainer shape
        r = mrows[f"{name} " + mla_tag.format("train", **MLA_TIMES["train"])]
        kernels[-1]["hd_192"] = {k: r[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        # and at recurrentgemma-9b's cohort chunk (MQA, hd 256, window)
        r = rrows[f"{name} " + rg_tag]
        kernels[-1]["recurrentgemma"] = {k: r[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        # and at the front ends' shapes (hd 64): whisper's encoder and
        # cross-attention, internvl2-1b's prefill (forward) or trainer
        # chunk (backward)
        kernels[-1]["whisper"] = {
            part: front_row(front_rows, name, f"whisper {part}")
            for part in ("encoder", "cross")}
        kernels[-1]["internvl"] = front_row(
            front_rows, name, "internvl prefill" if name == "flash_fwd"
            else "internvl train")
        # and at the tensor-parallel ranks' shapes
        kernels[-1]["tp"] = tp_kernel_rows(tp_rows, name)
    # the serving kernels: launches of the serve path's run; widen_2d:
    # NetChange's To-Wider at every round start of the VGG, wire and
    # transformer paths
    W = SERVE_GEOM["window"]
    swa_main = {"swa_decode": f"swa_decode serve local W={W}",
                "swa_prefill": (f"swa_prefill serve S={SERVE['prompt_len']}"
                                f" w={W}")}
    for name in sk.KERNELS:
        check(slaunches[name] > 0, f"{name} never launched on the serve path")
        kernels.append(kernel_entry(name, SWA_SOURCE, SWA_TPU[name],
                                    slaunches[name], errs.max[name],
                                    srows[swa_main[name]]))
    # swa_decode at recurrentgemma-9b's serve decode (MQA, G 16, hd 256)
    r = rrows[f"swa_decode recurrentgemma B={rd['B']} KV={rd['KV']} "
              f"G={rd['G']} W={rd['window']}"]
    kernels[-2]["recurrentgemma"] = {k: r[k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "device_ms",
        "cache_reads")}
    # swa_decode on whisper's cross cache and internvl2-1b's self cache
    kernels[-2]["whisper"] = front_row(front_rows, "swa_decode",
                                       "whisper cross", decode=True)
    kernels[-2]["internvl"] = front_row(front_rows, "swa_decode",
                                        "internvl self", decode=True)
    for i, name in ((-2, "swa_decode"), (-1, "swa_prefill")):
        kernels[i]["tp"] = tp_kernel_rows(tp_rows, name)
    # swa_decode with its log-sum-exp (the sequence-split cache's parts):
    # its launches on the FSDP phase's batch-1 serve (counted in the
    # entry's launches too) and its rows (LSE_DECODE)
    check(lse_launches > 0, "swa_decode's lse variant never launched")
    kernels[-2]["lse_launches"] = lse_launches
    kernels[-2]["lse_max_rel_err"] = LSE_ERR["max_rel"]
    kernels[-2]["lse"] = {
        k[len("swa_decode lse "):]: {x: r[x] for x in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "device_ms")}
        for k, r in srows.items() if k.startswith("swa_decode lse ")}
    n_widen = (launches["widen_2d"] + flaunches["widen_2d"]
               + glaunches["widen_2d"] + mlaunches["widen_2d"]
               + rlaunches["widen_2d"] + xlaunches["widen_2d"]
               + ivlaunches["widen_2d"] + uplaunches["widen_2d"])
    check(n_widen > 0, "widen_2d never launched on the main paths")
    widen_main = (f"widen cols dup glm4 FFN {TFFN['n_layers'] * 4096}x6848"
                  f"->13696")
    kernels.append(kernel_entry("widen_2d", WIDEN_SOURCE, WIDEN_TPU, n_widen,
                                errs.max["widen_2d"], wrows[widen_main]))
    # 12 TPU kernels; flash_bwd is two CUDA kernels (dq, dk/dv)
    check(len(kernels) == 13, f"{len(kernels)} kernels in the line, not 13")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
