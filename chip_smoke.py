#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
Hopper card: builds the port's CUDA kernels, holds each against its plain
PyTorch version, drives greedy SpecEE decode and T3 tree speculative
decoding of Llama-2-7B through the port's public entry points, serves
requests through its continuous-batching ``ServingEngine`` on the paged KV
cache, in AR and in tree mode, runs all three with weight-only int8
and int4 quantization, serves on an int8 KV cache
(``ModelFlags(kv_quant=True)``), alone and with int8 weights, decodes
and serves Mamba2 (mamba2-130m) with the SSD intra-chunk kernel, and
runs the whole-batch and serving paths again as megaticks
(``step(num_ticks=4)``, ``ServingEngine(megatick=4)``), trains
SpecEE bundles on the card (the target, the draft, the predictors and the
offline schedule) and decodes with them, runs the dense-family configs
(Llama-2-13B/70B, DeepSeek-7B, MiniCPM-2B, StarCoder2-15B, Command R+),
serves sampled requests, cancels requests, prefills a long prompt
through chunked attention and runs the serving launcher, and runs the MoE
(DBRX, Qwen3-MoE), RG-LRU hybrid (RecurrentGemma) and frontend (InternVL2,
HuBERT) configs, and serves through injected faults, evictions from an
oversubscribed pool and a checkpoint restored into a fresh engine,
serves tensor-parallel over a (1, P) mesh whose shards share the card,
through a device loss and a replica pool, serves every other family
(MoE, Mamba2, the RG-LRU hybrid, the VLM and the encoder) over such a
mesh, trains under a (DATA, MODEL) mesh at fsdp_tp, and serves over
(DATA, MODEL) meshes with DATA > 1, and holds the meta device's dry
run against what placement allocates on the card.

    python3 chip_smoke.py

Phases (lines ``[phase +seconds since the start] ...``):
  1. device + build — the card's name and power limit, then ``nvcc`` builds
     the seventeen kernels of ``src/repro_torch/csrc`` for sm_90a (in
     parallel);
  2. kernels — each kernel vs its plain version in fp32 and bf16 at the
     main paths' shapes (B=4, D=4096, V=32000, k=4, H=512, 32 heads of 128;
     the gate also at a serve tick's B=8, beside its byte bound and its
     bound in 32-byte sectors; dense caches of 162, 1024 and 4096 slots
     with 150, 1024 and 4096 live keys, each timed beside SDPA; paged:
     B=8, 128-token pages, a shuffled page table, 785, 4563, 4103 (one
     4096-token row among fresh ones) and 32768 (8 x 4096) live keys,
     windows None/20/300, ragged lengths with a retired all-trash row;
     flash: B in {1, 4},
     S in {77, 512}, window None/64, GQA n_rep=4), then timed beside its
     plain version, a library call as yardstick, and the least time the
     card could take (bound); the int8 paged kernel (paged_decode_attention_q:
     int8 pools with fp32 scale pools, fp32 and bf16 queries, the same
     four shapes, windows None/64/300, n_rep 1/4, the retired row reading
     the zeroed trash page),
     timed beside the fp paged kernel at the same live keys, SDPA on the
     gathered view dequantized to bf16 (a yardstick) and its byte bound;
     then the tree path's kernels at its row
     counts: the fp spec head's two stages, spec_head_gather (bit-equal)
     and the spec_head dot (R in {1, 160, 320}, random ids with edge and
     repeated ones, and a tree step's ids: the B*N node tokens gathered
     once, the nodes' children read from them; timed both ways),
     predictor_mlp (R in {1, 108, 216}, F in {12, 15, 24}: both of its
     feature-unroll instances) and the verify kernels at R in
     {9, 160, 320} with planted ties, timed at R = 8/160/320; then the
     quantized kernels (argmax_verify_q, topk_verify_q, the quantized spec
     head's two stages spec_head_gather_q and the spec_head_q dot, and
     predictor_mlp_q) in int8 and int4 with fp32 and bf16 activations at
     R in {4, 160, 320} (the MLP at {4, 108, 216}), planted ties and edge
     ids, against their plain versions and the fp kernels on the
     dequantized head (bf16 rows: top-k_q's first column bit-equal to
     argmax_q's max; the spec head also at a tree step's ids, B = 4 and 8,
     its gather bit-equal), timed in bf16 beside the fp kernel on the
     dequantized bf16 head (a yardstick: no one PyTorch call computes the
     same function; the spec head's stages at the tree's ids, the gather
     beside index_select, with a step's gather + dots and the per-call
     composition at the step's and at random ids, the predictor at R in
     {4, 108, 216}); then the quantized exit gate (exit_gate_q: fp32 and
     bf16 hidden rows, B in {1, 4, 8, 33}, Llama-2-7B's and mamba2-130m's
     widths, every (head, bank) pair of fp / int8 / int4 but the fp one,
     k in {1, 3, 4}, ids 0, V-1, repeated and out of range, two calls
     bit-equal) against its plain version, timed in bf16 at B = 4 and 8
     (int8, int4) beside the plain version, the piecewise chain it
     replaced (the quantized spec head, softmax, difference,
     concatenation, predictor_mlp_q) in one CUDA graph as a yardstick, its
     byte bound and
     its bound in 32-byte sectors; and the host time per call of the fp
     and the quantized gate (fused and piecewise) and verify entry points;
     then the SSD intra-chunk
     kernel (ssd_chunk: fp32 and bf16 B/C, 24, 12 and 6 heads (mamba2-130m
     and its P = 2 and P = 4 shards), c 32/40/64, d_state 16/128, head dim
     32/48/64, 1/8/32 cells, decay steep enough that exp(cum_t - cum_s)
     overflows for s > t) against its plain version, timed at a 512-token
     mamba2-130m admission beside a yardstick (bmm + batched product), and
     the gate and verify kernels at mamba2's D=768, V=50280 on a tied head
     made contiguous; then the dense family's shapes: the three attention
     kernels at 12 query heads per KV head (48 over 4 of 128, fp32 and
     bf16, rows of one and of several splits), timed at 150 of 162 and
     4096 of 4096 slots (dense) and a serve tick's 2203 live keys (paged,
     bf16 and int8 pools) beside SDPA; the four verify tiles at MiniCPM's
     head (D=2304, odd V=122753) and Command R+'s (D=12288, V=256000), the
     fp and int8 gates at D 5120, 6144 and 12288, flash at 48 over 4 heads
     and at 36 heads of 64, each against its plain version and timed; then
     the new families' shapes: the three attention kernels at 48 over 8
     of 128, 64 over 4 of 64 and 16 over 1 of 256 (fp32 and bf16, windows
     None/64/300), timed at 150 of 162 and 2150 of 2240 slots (dense; the
     MQA shape under its 2048-key window) and a serve tick (paged) beside
     SDPA, and the same at 8 and 4 over 1 of 256 (a P = 2 and a P = 4
     shard of recurrentgemma-9b, phase 17); checked, not timed, at phase
     17's other shards: 24 over 4 and 12 over 2 of 128 (dbrx-132b and
     internvl2-26b at P = 2, 4), 16 over 1 of 64 (qwen3-moe at P = 4);
     flash at hd 256 (16 over 1
     heads, S = 2112, windows None/64/2048) timed beside SDPA with the same
     mask, and at 48 over 8 of 128 and 64 over 4 of 64;
  3. parity — llama2-7b at full width, 4 layers, fp32, seeded weights:
     Engine.create → new_session → prefill(4 prompts) → step x 8 at
     thresholds 1.5, 0.4, -0.1, with the kernels and with the plain
     versions; tokens, exit points and exits must match, threshold 1.5 must
     equal dense decoding, and an oracle speculative set must force exits.
     Then ServingEngine with every kernel (paged and dense caches, blocking
     and 64-token chunked admission) against ServingEngine on the plain
     paths: 8 requests through 4 slots, per-request tokens and exit points
     identical, with the draft's speculative set and with an oracle set
     that forces exits (skipped layers' K/V propagated through the page
     table and read back by the paged kernel). Then T3 tree decoding
     (TreeSpec(3, 3): 40 nodes, 27 paths) with every kernel on
     (spec_head_kernel, exit_gate_kernel, decode_kernel, flash_attention)
     against the plain paths on dense and paged caches at thresholds 1.5
     (must equal dense greedy), 0.4 and -0.1 (must force exits), an oracle
     tree whose first chain follows dense greedy (accepted length = depth
     every step), and tree-mode ServingEngine on the paged cache
     (per-request tokens, exit points and accept lengths). Then
     Engine.create(quant="int8"/"int4"): kernels vs plain for AR (the
     draft's set and an oracle set that forces exits), dense and tree
     decoding (int8 on the dense cache, int4 on the paged one), a
     quantized ServingEngine (blocking and chunked), and the quantized
     engine against the plain engine on ``dequantized_reference``; no fp
     gate kernel may launch. Then ModelFlags(kv_quant=True): AR on dense
     and paged caches at thresholds 1.5, 0.4, -0.1 and an oracle set that
     forces exits, kv_quant ServingEngine (blocking and 64-token chunked,
     each against the plain run of its own admission mode, which differ by
     design under kv_quant), and the same with quant="int8". Then
     mamba2-130m at full width, 4 layers, fp32: AR sessions with every
     kernel (ssd_kernel too) against the plain paths on dense and paged
     caches at thresholds 1.5 (must equal dense greedy), 0.4, -0.1 and an
     oracle set that forces exits (frozen SSD states, shifted conv
     windows), the same as megaticks of 4 ticks against the single steps,
     and ServingEngine blocking and with 64-token chunks (which fall back
     to whole-prompt admission). Then megaticks on llama2-7b (4 layers,
     fp32): whole-batch sessions with every kernel as megaticks of K=4 and
     K=3 (a budget of 8 runs out inside one) against single steps with
     the kernels and on the plain paths (SpecEE with the draft's and an
     oracle set on dense and paged caches, tree on paged, dense decoding:
     tokens, per-tick exit points and accept lengths, units_run
     identical), and ServingEngine(megatick=4) (async) against the
     per-tick engine, 8 requests through 4 slots (SpecEE, both sets, and
     tree);
  4. full run — llama2-7b, 32 layers, bf16, 4 prompts of 128 tokens,
     32 SpecEE decode steps (whole-batch session, dense cache);
  5. serve — the same weights, ServingEngine(cache="paged") with
     max_batch 8, 4096-token rows of 128-token pages: 16 requests with
     prompts of 64-512 tokens, 32 new tokens each, once with blocking
     admission and once with 256-token chunks; for each request on which
     the two differ, the top-2 logit margin at the first differing token;
     then a profile of serving ticks by kernel family;
  6. tree — the same weights in T3 tree mode (TreeSpec(3, 3)): a
     whole-batch session (B=4, prompt 128, 16 tree steps, dense cache) and
     ServingEngine(strategy="tree", cache="paged") with max_batch 8:
     8 requests with prompts of 64-512 tokens, 32 new tokens each;
  7. quant — the same weights through Engine.create(quant="int8"), then
     "int4" (each engine freed before the next): whole-batch AR (B=4,
     prompt 128, 32 steps) and whole-batch tree decoding (4 steps); then
     ServingEngine(quant="int8", cache="paged") serving the first 8 serve
     prompts, then a profile of its serving ticks; each run must launch
     every kernel its fp path launches, with the gate and verify kernels
     replaced by their quantized siblings (``quantized``: the AR and serve
     gate by exit_gate_q, and none of spec_head_gather_q, spec_head_q and
     predictor_mlp_q; the tree gate by all three, spec_head_gather_q at
     most once per step), and none of exit_gate, argmax_verify,
     topk_verify, spec_head_gather and spec_head; then a profile of 3 more
     whole-batch tree steps of each, by kernel family;
  8. kvq — the same weights with ModelFlags(kv_quant=True): phase 5's
     serve cell on int8 page pools, blocking and 256-token chunked, each
     compared with phase 5's run of the same admission (requests that
     differ, with the top-2 margin at the first differing token), the pool
     size against the bf16 pools', a profile of serving ticks; then
     ServingEngine(quant="int8") on the first 8 serve prompts, compared with
     phase 7's int8 run; each run must launch paged_decode_attention_q and
     never paged_decode_attention;
  9. mamba — mamba2-130m at published size (24 layers, D=768, V=50280
     tied, bf16, seeded): whole-batch AR SpecEE (B=4, prompt 128, 32
     steps, dense cache) and ServingEngine(cache="paged") with max_batch 8:
     16 requests with prompts of 64-512 tokens, 32 new tokens each; each
     must launch ssd_chunk (once per layer per prefill), exit_gate,
     argmax_verify and topk_verify; then profiles of steps and ticks;
 10. mega — megaticks of 4 ticks at published width on the same weights:
     whole-batch SpecEE (phase 4's prompts, 8 megaticks), tree (phase 6's,
     4 megaticks) and mamba2 (phase 9's, 8 megaticks), each bit-identical
     to its phase's single steps (tokens, per-tick exit points, exits,
     accept lengths, units_run), with ms/tick and tokens/s beside the
     single steps' (SpecEE and tree also run as single steps here, in
     turns: single, megatick, megatick, single);
     ServingEngine(cache="paged", megatick=4) (async) on phase 5's 16
     requests with blocking admission, then the per-tick engine again,
     and mamba2 serving on phase 9's, each against its phase's run
     (requests/s, tokens/s, ms per step() call; each llama request that
     differs with its top-2 margin at the first differing token); then
     profiles of 4 whole-batch single steps and of 1 megatick;
 11. trained — a SpecEE bundle trained on the card with the port's
     modules alone, in the order of benchmarks/common.py::get_bundle
     (TrainLoop on the synthetic DataPipeline for 30 steps, train_draft 250
     steps over 8 batches, collect_dataset on 4 of them, train_predictors
     300 steps, offline_exit_counts with 12 new tokens on the AR kernel
     path, offline_mask_from_counts), for (a) llama2-7b at published width
     with 2 of its 32 layers in fp32 (fp32 params with AdamW state at 32
     layers do not fit one card; batches of 4 x 256) and (b) get_bundle's
     own config (the smoke config deepened to 12 layers, fp32, batches of
     4 x 32); each stage's seconds, ms per step, first and last loss, the
     draft's top-4 hit rate, the predictors' accuracy and positive rate,
     the exit histogram and the offline mask; a loss that does not fall,
     predictors below max(pos, 1 - pos) - 0.02 or a tensor off the card
     fails the run. Then dense, SpecEE (the AR kernels) and tree decoding
     (the tree kernels) with each trained bundle, (a) in fp32 and cast to
     bf16, (b) in fp32, in turns, 3 runs each (B=4 pipeline prompts of 128
     tokens, 32 tokens a row): tokens/s, mean units_run, the exit points
     over tokens, the share of tokens equal to dense and the tree's mean
     accepted length; a second SpecEE run must emit the first's tokens;
 12. dense — the dense-family configs, seeded bf16, one model at a time:
     first each at published widths, 2 layers, fp32, SpecEE (threshold
     0.4) on dense and paged caches and tree decoding with every kernel
     against the plain paths (tokens and exit points identical); then, at
     published widths and 4 layers, llama2-13b (AR whole-batch B=4,
     prompt 128, 32 steps; tree, 8 steps; phase 5's 16 requests, 16 new
     tokens each, served on the paged cache), starcoder2-15b (48 heads
     over 4 KV heads: n_rep 12 in the
     dense, paged and int8 paged attention kernels; AR, serving, kv_quant
     serving, AR with an int8 head and predictors), deepseek-7b (AR,
     V=102400), minicpm-2b (odd V=122753, hd 64, tied: AR, tree, int8
     AR), llama2-70b at 2 of its 80 layers (AR, serving) and
     command-r-plus-104b at 2 of its 64 (AR); each run zeroes the launch
     counts and requires its path's kernels; tokens/s, ms/step or tick,
     peak memory;
 13. serve2 — the rest of serving on phase 5's llama2-7b weights:
     sampled whole-batch decode (DenseStrategy(temperature=0.8,
     top_k=50)), megaticks of 4 equal to single steps, and the sampler on
     the card against the CPU's on the same logits and keys; sampled
     serving of 8 of the 16 requests, 16 new tokens each (the same seed
     replays, another differs, megatick=4 equals the per-tick run); cancel of 4 of the 16
     greedy requests (one queued, one mid chunked admission, two slotted):
     every page freed, ``completed`` in finish order, the other 12 against
     a run without them (a differing request only at a near-tie); a
     3000-token prompt through chunked and pruned chunked attention (fp32,
     4 layers, flash off) equal to unchunked attention; and ``python -m
     repro_torch.launch.serve --smoke --ci`` for specee, tree and dense
     --temperature 0.8, three subprocesses at once;
 14. newfam — the new families, seeded bf16, one model at a time, each
     freed before the next: dbrx-132b and qwen3-moe-235b-a22b at published
     widths, 1 of their 40 and 94 layers (AR SpecEE B=4, 32 steps, with
     moe_impl "dense" and again "topk": equal tokens, or each differing
     row's top-2 margin at a near-tie; paged serving of 8 requests, 16 new
     tokens each; tree, 8 steps); recurrentgemma-9b at published size (AR
     SpecEE B=4 over 2112-token prompts, past its 2048-token window, so
     flash and the decode kernel (16 heads over 1 of 256) cut the window;
     serving on the paged hybrid cache); internvl2-26b at published size
     (256 image patches + 128 text tokens, dense decode through a session
     sized for the patches, 32 steps); hubert-xlarge at published size
     (frame logits of 4 x 512 frames, then 3 fp32 TrainLoop steps); each
     run zeroes the launch counts and requires its path's kernels;
     tokens/s, units_run, peak memory, launches;
 15. faults — fault-tolerant serving on phase 5's weights (seeded
     again): ServingEngine(strategy="specee", megatick=4, blocking
     admission, max_batch 8, 1024-token rows of 128-token pages) serves
     phase 5's 16 requests, 32 new tokens each, over a pool of 40 pages
     (5 row reservations for 8 slots) under JAX's acceptance schedule
     (dispatch at visit 1, finish_timeout 3, nan_logits 5, pool_exhausted
     2-7, sigterm 6; no backoff sleep, evict_patience 2, cooldown_ticks 2,
     a temporary checkpoint directory); each Preempted closes the engine
     and a fresh one on the same weights restores the checkpoint. Every
     site but device_lost fires; every request's tokens, exit points and
     accept lengths equal a fault-free run on 64 pages; every request is
     done with 32 tokens and every page free; the fault log holds retry,
     recover, evict, checkpoint and restore; every engine, the restored
     ones too, turns the paged decode kernel on and launches exit_gate,
     argmax_verify, topk_verify, paged_decode_attention and
     flash_attention. Logged: evictions, tokens replayed, checkpoint and
     restore GB and seconds, wall time against the reference. Then 4
     requests with watchdog_s=1e-9 (sync fallbacks, the reference's
     tokens); ``python -m repro_torch.launch.serve --smoke --ci
     --checkpoint-dir D`` sent a real SIGTERM after its first tick (exit
     17, a committed step), then ``--restore`` (CI smoke OK), beside
     ``--megatick 2 --inject SITE`` for the five sites, six subprocesses at
     once; a TrainLoop restart on get_bundle's 12-layer smoke config in
     fp32 (2 steps, save, 1 step; a fresh loop restores step 2 and runs 1:
     step 3's batch bit-equal, its loss within rel 1e-5);
 16. tp — multi-GPU serving with every shard on the one card (the card
     holds P shards of a (1, P) mesh: shard-local kernels, merges,
     all-reduce points and replay across degrees run; no copy between
     cards): (a) the sharded argmax and top-k verify over P = 2 and 4
     vocabulary slices of a bf16 D=4096 head, V = 32000 and 32001 (the
     last slice narrower), R = 4 and 320, ties across every shard,
     bit-equal to the unsharded kernel in tokens and values, each slice's
     and the merge's time; (e) the collectives against plain sums; (b)
     llama2-7b at published width, fp32, 4 layers: SpecEE and tree on
     dense and paged caches at P = 2 and 4 token-identical to P = 1;
     16 layers bf16 SpecEE paged at P = 4 (cut from one host copy, the
     card's copy freed) against P = 1, a row's first divergence held to
     a near-tie (top-2 margin within 8 bf16 spacings) and the peak card
     memory under 1.5x the weights; (c) ServingEngine(mesh=P4)
     with device_lost at tick 2 remeshes to P = 2 and finishes with the
     unsharded fault-free tokens (fp32), the remesh timed; (d) a
     ReplicaPool of two unsharded bf16 llama2-7b replicas sharing one
     param tree, device_lost in a replica: kill, requeue and replay give
     one engine's fault-free outputs. Each of tp_decode, tp_remesh,
     tp_deep and tp_pool is a main path;
 17. tpfam — tensor-parallel serving of the remaining families, every
     shard on the one card, each model fp32 and freed before the next; its
     P = 1 runs on the card, then its weights moved to the host and the
     card's copy freed before P = 2 and 4, whose tokens, exit points and
     units_run must equal P = 1's and whose peak card memory must stay
     under 1.5x the weights (mamba2-130m alone, whose P = 1 runs already
     hold more than half its weights again in activations and workspaces:
     under 1.5x the weights plus what P = 1 held beyond them): mamba2-130m
     at published size (SpecEE B=4,
     8 steps, at P = 1, 2, 4, ssd_chunk once per layer and shard a
     prefill; ServingEngine(mesh=P2), 8 requests); recurrentgemma-9b's
     widths at 3 layers (rglru, rglru, local attention; rows of 128-300
     prompt tokens; SpecEE on dense and paged caches at P = 1, 2, 4: the
     decode kernels at 8 and 4 heads over one of 256; the int8 KV cache
     at P = 2); dbrx-132b's widths at 1 layer, both MoE forms, P = 1, 2,
     4; qwen3-moe's at 1 layer, top-k, paged, P = 4; internvl2-26b's at 2
     layers, dense decode over 256 patches, P = 2, 4; hubert-xlarge at
     published size, frame logits at P = 2, 4 against P = 1's (max
     |diff| logged). Each family's run at each degree is a main path
     (``tpfam_*``);
 18. trainmesh — training under a (DATA, MODEL) mesh at fsdp_tp, every
     slot on the one card, fp32 with TF32 off: llama2-7b's widths at 2
     layers, B=8 x 256, remat full, 3 TrainLoop steps unsharded, then at
     (2, 2) and (1, 4) (microbatch by JAX's rule, max(B // 16, DATA)):
     losses and grad norms within rtol 1e-4, the largest param
     difference, step ms, peak memory and the collectives over 'data' a
     step by kind (calls, bytes); qwen3-moe's widths at 1 layer (E 128,
     top-8) with expert parallelism at (2, 2), plain, ``moe_ep_quant``
     and ``moe_bf16_reduce``, loss and gradients of one batch against
     the unsharded run with the same flags; mamba2-130m at published
     size at (2, 2) (loss and gradients; then a TrainLoop checkpoint
     saved at (2, 2) and restored at (1, 2) and without a mesh,
     bit-equal); recurrentgemma-9b's widths at 3 layers at (1, 4). The
     path runs no kernel (no backward for flash or SSD): its launches,
     counted from 0, must stay 0 (``trainmesh``);
 19. tpdata — serving over (DATA, MODEL) meshes with DATA > 1 inside one
     engine, every slot on the one card, each model fp32 and freed
     before the next: its (1, 1) runs on the card, then its weights moved
     to the host and each mesh's copy cut from there: llama2-70b's
     widths at 2 layers, SpecEE B=4 on the dense cache and
     ServingEngine on the paged one (8 requests, 4 slots) at (2, 1)
     tp2d, (2, 2) tp_dp / tp2d / fsdp_tp and (4, 1) tp2d, tree and
     quant="int8" at (2, 2) tp2d; dbrx-132b's at 1 layer, both MoE
     forms, expert parallelism at (2, 2); qwen3-moe's at 1 layer, top-k,
     paged, (2, 2); mamba2-130m at published size, ServingEngine at
     (2, 2); recurrentgemma-9b's at 3 layers, dense and paged, (2, 2).
     Tokens, exit points and units_run must equal (1, 1)'s; logged: ms a
     step or tick, the peak card memory against the weights and the
     'data' collectives a step by kind. Each config's run at each mesh
     is a main path (``tpdata_*``);
 20. dryrun — the dry run on the meta device (``repro_torch.launch.
     dryrun``) held against the card: llama2-70b's widths at 2 layers,
     fp32, the decode cell of B=4 rows of 256 slots at (2, 2) under tp_dp,
     tp2d and fsdp_tp. The card's allocation growth across placing the
     cell's arguments (the engine's weights from a host copy, then its
     empty decode state; every slot on cuda:0, so the sum over the slots)
     must be within 1 % of the meta run's summed per-slot argument bytes,
     and one step's per-device collectives of both axes (those the lead
     slot takes part in), counted on the card with the step taking the
     meta step's branches (every unit, every gate and verify), must
     equal the meta step's. The step takes the dry run's
     flags, which turn on no kernel. Then llama2-7b's decode_32k cell at
     published size on a (4, 4) mesh of meta slots: its largest slot's
     bytes, flops and collectives, logged;
 21. the ``{"kernels": [...]}`` line (17 kernels), the card line, and as
     the last line ``{"ok": true, "device": {...}}``.

With random draft and predictor weights the tree accepts about no draft
token per step (one emitted token per tree step), so the tree runs of
phases 3 to 10 measure the mechanism's cost, not its gain; phase 11's
trained bundles are the ones that exit and accept.

Each main path (phases 4 to 20, each run on its own) zeroes the
kernel launch counts right before it and reads them right after; a kernel
of that path that never launched fails the run. Any failure exits non-zero
without the last line. Without a CUDA card, or without the repository
beside this file, it fails at once.
"""
from __future__ import annotations

import itertools
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): HBM rate and
# the arithmetic rate for each input type (bf16 on the tensor cores, fp32
# outside them).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

REPLACES = {
    "exit_gate": "src/repro/kernels/exit_gate/exit_gate.py:126",
    "argmax_verify": "src/repro/kernels/exit_gate/exit_gate.py:232",
    "topk_verify": "src/repro/kernels/exit_gate/exit_gate.py:336",
    "decode_attention":
        "src/repro/kernels/decode_attention/decode_attention.py:143",
    "paged_decode_attention":
        "src/repro/kernels/decode_attention/decode_attention.py:270",
    "flash_attention":
        "src/repro/kernels/flash_attention/flash_attention.py:116",
    # the fp spec head's two stages (column gather, then dot)
    "spec_head": "src/repro/kernels/spec_head/spec_head.py:63",
    "spec_head_gather": "src/repro/kernels/spec_head/spec_head.py:63",
    "predictor_mlp": "src/repro/kernels/predictor_mlp/predictor_mlp.py:47",
    "argmax_verify_q": "src/repro/kernels/exit_gate/exit_gate.py:604",
    "topk_verify_q": "src/repro/kernels/exit_gate/exit_gate.py:647",
    # the quantized spec head's two stages (code-column gather, then dot)
    "spec_head_q": "src/repro/kernels/spec_head/spec_head.py:152",
    "spec_head_gather_q": "src/repro/kernels/spec_head/spec_head.py:152",
    "predictor_mlp_q":
        "src/repro/kernels/predictor_mlp/predictor_mlp.py:119",
    "paged_decode_attention_q":
        "src/repro/kernels/decode_attention/decode_attention.py:173",
    "ssd_chunk": "src/repro/kernels/ssd_chunk/ssd_chunk.py:47",
    # the two Pallas kernels that the JAX package composes into its
    # quantized gate (src/repro/kernels/exit_gate/ops.py)
    "exit_gate_q": "src/repro/kernels/spec_head/spec_head.py:152 + "
                   "src/repro/kernels/predictor_mlp/predictor_mlp.py:119",
}
QUANT_KERNELS = ("argmax_verify_q", "topk_verify_q", "spec_head_q",
                 "predictor_mlp_q", "exit_gate_q", "spec_head_gather_q")
# the quantized gate's pieces, which only the tree gate launches
PIECEWISE_Q = ("spec_head_gather_q", "spec_head_q", "predictor_mlp_q")
FP_GATE_KERNELS = ("exit_gate", "argmax_verify", "topk_verify")
# the fp spec head's two stages, which no quantized path may launch
FP_SPEC_HEAD = ("spec_head_gather", "spec_head")
# The kernels each main path must launch: whole-batch AR on the dense
# cache, serving on the paged one (plus flash_attention under blocking
# admission), and tree decoding.
AR_PATH = ("exit_gate", "argmax_verify", "topk_verify", "decode_attention")
SERVE_PATH = ("paged_decode_attention", "exit_gate", "argmax_verify",
              "topk_verify")
# serving on an int8 KV cache: the int8 paged kernel in the fp one's place
KVQ_SERVE_PATH = tuple("paged_decode_attention_q" if k ==
                       "paged_decode_attention" else k for k in SERVE_PATH)
TREE_PATH = ("spec_head_gather", "spec_head", "predictor_mlp",
             "argmax_verify", "flash_attention")
# Mamba2 (no attention): the SSD kernel in prefill and admission, the fp
# gate and verify kernels in every decode step
MAMBA_PATH = ("ssd_chunk", "exit_gate", "argmax_verify", "topk_verify")
# Under weight quantization each gate or verify kernel becomes its
# quantized sibling (the tree gate's pieces each theirs); attention is
# unchanged.
QUANTIZED = {"exit_gate": ("exit_gate_q",),
             "argmax_verify": ("argmax_verify_q",),
             "topk_verify": ("topk_verify_q",),
             "spec_head_gather": ("spec_head_gather_q",),
             "spec_head": ("spec_head_q",),
             "predictor_mlp": ("predictor_mlp_q",)}


def quantized(path):
    """``path`` with each fp gate or verify kernel replaced as above."""
    return tuple(q for k in path for q in QUANTIZED.get(k, (k,)))

B, D, V, K_SPEC, H_PRED = 4, 4096, 32000, 4, 512
HEADS, HD = 32, 128
FULL_PROMPT, FULL_STEPS = 128, 32
PAGE = 128                                   # tokens per page when serving
SERVE_BATCH, SERVE_SEQ, SERVE_REQS, SERVE_NEW = 8, 4096, 16, 32
GATE_BATCH = SERVE_BATCH                     # a full serve tick's gate rows
SERVE_PROMPTS = (64, 512)                    # prompt lengths, inclusive
TREE_DEPTH, TREE_BRANCH = 3, 3               # 40 nodes, 27 root-leaf paths
TREE_STEPS, TREE_SERVE_REQS = 16, 8
MEGA_K = 4                                   # ticks per megatick
QUANT_TREE_STEPS = 4                         # tree steps of the quant phase
# mamba2-130m (src/repro_torch/configs/mamba2_130m.py): D=768, V=50280 tied,
# 24 SSD layers of 24 heads of 64, d_state 128, 64-token chunks
M_D, M_V, M_NH, M_HD, M_DS, M_CHUNK = 768, 50280, 24, 64, 128, 64


T_START = time.perf_counter()


def log(phase: str, msg: str) -> None:
    """One line, tagged with its phase and the seconds since the start."""
    print(f"[{phase} +{time.perf_counter() - T_START:.1f}s] {msg}",
          flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
def graph_ms(torch, calls) -> float:
    """Device time of one call, from a CUDA graph replaying ``calls`` (a
    list of closures, e.g. over distinct buffers so caches start cold)
    back to back; host launch cost is outside the graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm up off the default stream
        for fn in calls[:3]:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for fn in calls:
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reps = 5
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * len(calls))


def bound_ms(nbytes: float, ops: float, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------
def check_kernels(torch, dev):
    import torch.nn.functional as F
    from repro_torch import kernels as K
    from repro_torch.kernels.decode_attention.decode_attention import (
        decode_attention_fwd, dense_split_keys)
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.exit_gate import exit_gate as eg
    from repro_torch.kernels.exit_gate import ref as gref

    gen = torch.Generator(device=dev).manual_seed(1234)

    def rnd(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).to(dtype)

    rows = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        hn = rnd((B, D), dt)
        w = rnd((D, V), dt, 0.05)
        # tolerances: the kernels and the plain versions both sum fp32
        # products of the same (upcast) inputs, in different orders —
        # atol = rtol = 1e-4 on logits of size ~3; ids exact (the top-2 gap
        # of random logits dwarfs fp32 rounding)
        tok, mx = eg.argmax_verify_fused(hn, w)
        tok_r, mx_r = gref.verify_argmax_ref(hn, w)
        require(torch.equal(tok, tok_r), f"argmax ids differ ({name})")
        torch.testing.assert_close(mx, mx_r, atol=1e-4, rtol=1e-4)
        err_av = (mx - mx_r).abs().max().item()
        ids, vals = eg.topk_verify_fused(hn, w, K_SPEC)
        ids_r, vals_r = gref.verify_topk_ref(hn, w, K_SPEC)
        require(torch.equal(ids, ids_r), f"top-k ids differ ({name})")
        torch.testing.assert_close(vals, vals_r, atol=1e-4, rtol=1e-4)
        err_tk = (vals - vals_r).abs().max().item()
        # ties: duplicated best columns resolve to the lowest id
        wt = w.clone()
        best = int(tok[0])
        for j in (3, (best + 1) % V, V - 1):
            wt[:, j] = wt[:, best]
        want = sorted({3, best, (best + 1) % V, V - 1})
        require(int(eg.argmax_verify_fused(hn, wt)[0][0]) == want[0],
                f"argmax tie-break ({name})")
        require(eg.topk_verify_fused(hn, wt, K_SPEC)[0][0].tolist()
                == want[:4], f"top-k tie-break ({name})")
        del wt

        w1 = rnd((3 * K_SPEC, H_PRED), torch.float32, 12 ** -0.5)
        b1 = rnd((H_PRED,), torch.float32, 0.1)
        w2 = rnd((H_PRED, 1), torch.float32, H_PRED ** -0.5)
        b2 = rnd((1,), torch.float32, 0.1)
        pred = {"layers": [{"w": w1, "b": b1}, {"w": w2, "b": b2}]}
        err_eg = 0.0
        for rows_g in (B, GATE_BATCH):       # the AR batch and a full serve
            hg = hn if rows_g == B else rnd((rows_g, D), dt)
            spec_ids = torch.randint(0, V, (rows_g, K_SPEC), generator=gen,
                                     device=dev, dtype=torch.int32)
            prev = torch.softmax(rnd((rows_g, K_SPEC), torch.float32), -1)
            got = eg.exit_gate_fused(hg, w, spec_ids, prev, w1, b1, w2, b2)
            want_g = gref.exit_gate_ref(hg, w, spec_ids, prev, pred)
            for a, b in zip(got, want_g):
                # fp32 gate on upcast inputs: atol = rtol = 1e-4
                torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
                err_eg = max(err_eg, (a - b).abs().max().item())

        err_da = 0.0
        # attention: the kernel keeps scores, probabilities and sums in
        # fp32, so the plain version runs on the same inputs upcast to fp32
        # (exact for bf16). atol 1e-4 covers the summation order; in bf16
        # rtol 2**-7: rounding the output to bf16 errs by at most 2**-8
        # relative — dropping one of 150 keys moves an output by ~5 %
        rtol = 1e-4 if dt == torch.float32 else 2.0 ** -7
        # a 4096-slot cache cuts each row into splits: lengths one past a
        # split boundary and on it; window 700 leaves whole splits before
        # the first key of the full row
        split = dense_split_keys(4096, HD, hn.element_size())
        long_rows = [4096, 1, split + 1, split]
        for S, clen, window in ((FULL_PROMPT + FULL_STEPS + 2,
                                 [150, 150, 150, 150], None),
                                (1024, [1024, 700, 300, 1], None),
                                (1024, [1024, 700, 300, 1], 256),
                                (4096, long_rows, None),
                                (4096, long_rows, 700)):
            q = rnd((B, 1, HEADS, HD), dt)
            kc = rnd((B, S, HEADS, HD), dt)
            vc = rnd((B, S, HEADS, HD), dt)
            cl = torch.tensor(clen, dtype=torch.int32, device=dev)
            o = decode_attention_fwd(q, kc, vc, cl, window=window).float()
            o_r = decode_attention_ref(q.float(), kc.float(), vc.float(), cl,
                                       window)
            torch.testing.assert_close(o, o_r, atol=1e-4, rtol=rtol)
            err_da = max(err_da, (o - o_r).abs().max().item())
        torch.cuda.synchronize()
        log("kernels", f"{name}: argmax ids exact, max err {err_av:.3g}; "
            f"top-k ids exact, err {err_tk:.3g}; ties -> lowest id; "
            f"exit_gate err {err_eg:.3g}; decode_attention err {err_da:.3g}")
        rows[name] = {"argmax_verify": err_av, "topk_verify": err_tk,
                      "exit_gate": err_eg, "decode_attention": err_da}
        del hn, w

    # ---- timing at the full run's shapes and dtype (bf16) ----
    dt, dname = torch.bfloat16, "bfloat16"
    hn = rnd((B, D), dt)
    w = rnd((D, V), dt, 0.05)
    n = 20
    t = {}
    t["argmax_verify"] = (
        graph_ms(torch, [lambda: eg.argmax_verify_fused(hn, w)] * n),
        graph_ms(torch, [lambda: gref.verify_argmax_ref(hn, w)] * n),
        graph_ms(torch, [lambda: torch.argmax(hn @ w, -1)] * n),
        bound_ms(B * D * 2 + D * V * 2 + B * 8, 2 * B * D * V, dname))
    t["topk_verify"] = (
        graph_ms(torch, [lambda: eg.topk_verify_fused(hn, w, K_SPEC)] * n),
        graph_ms(torch, [lambda: gref.verify_topk_ref(hn, w, K_SPEC)] * n),
        graph_ms(torch, [lambda: torch.topk(hn @ w, K_SPEC, -1)] * n),
        bound_ms(B * D * 2 + D * V * 2 + B * K_SPEC * 8, 2 * B * D * V,
                 dname))
    w1 = rnd((3 * K_SPEC, H_PRED), torch.float32, 12 ** -0.5)
    b1 = rnd((H_PRED,), torch.float32)
    w2 = rnd((H_PRED, 1), torch.float32, H_PRED ** -0.5)
    b2 = rnd((1,), torch.float32)
    pred = {"layers": [{"w": w1, "b": b1}, {"w": w2, "b": b2}]}
    gate_rows = {}
    for rows_g in (B, GATE_BATCH):
        hg = hn if rows_g == B else rnd((rows_g, D), dt)
        ids_sets = [torch.randint(0, V, (rows_g, K_SPEC), generator=gen,
                                  device=dev, dtype=torch.int32)
                    for _ in range(n)]
        prev = torch.softmax(rnd((rows_g, K_SPEC), torch.float32), -1)
        fixed = (rows_g * D * 2 + rows_g * K_SPEC * 8
                 + (3 * K_SPEC * H_PRED + 2 * H_PRED + 1) * 4
                 + rows_g * (1 + 2 * K_SPEC) * 4)
        gate_ops = rows_g * (2 * K_SPEC * D + 2 * 3 * K_SPEC * H_PRED
                             + 4 * H_PRED)
        # distinct speculative ids per call: the gathered columns start
        # cold; the sector bound counts the 32-byte sector each gathered
        # element of the strided head costs
        gate_rows[rows_g] = (
            graph_ms(torch, [lambda i=i: eg.exit_gate_fused(
                hg, w, i, prev, w1, b1, w2, b2) for i in ids_sets]),
            graph_ms(torch, [lambda i=i: gref.exit_gate_ref(hg, w, i, prev,
                                                            pred)
                             for i in ids_sets]),
            None,
            bound_ms(fixed + rows_g * K_SPEC * D * 2, gate_ops, "float32"))
        ms, plain, _, (bnd, by) = gate_rows[rows_g]
        sectors = bound_ms(fixed + rows_g * K_SPEC * D * 32, gate_ops,
                           "float32")[0]
        log("kernels", f"exit_gate bf16, B={rows_g}: kernel {ms:.4f} ms, "
            f"plain {plain:.4f} ms, bound {bnd:.5f} ms ({by}), "
            f"{sectors:.5f} ms in 32-byte sectors")
    t["exit_gate"] = gate_rows[B]
    # the full run's attention: S slots, 150 live per row; 8 distinct
    # caches (>50 MB together) so each call reads its K/V from memory, as a
    # decode step does after the layer's weights have passed through L2;
    # then longer contexts, each beside SDPA on the same cache
    q = rnd((B, 1, HEADS, HD), dt)
    qs = q.transpose(1, 2)
    contexts = {}
    for S, live, n_c in ((FULL_PROMPT + FULL_STEPS + 2, 150, 8),
                         (4096, 150, 8), (1024, 1024, 2), (4096, 4096, 2)):
        cl = torch.full((B,), live, dtype=torch.int32, device=dev)
        caches = [(rnd((B, S, HEADS, HD), dt), rnd((B, S, HEADS, HD), dt))
                  for _ in range(n_c)]
        mask = (None if live == S else
                (torch.arange(S, device=dev) < live)[None, None, None, :])
        kv_t = [(k.transpose(1, 2), v.transpose(1, 2)) for k, v in caches]
        da_bytes = (2 * B * live * HEADS * HD * 2 + 2 * B * HEADS * HD * 2
                    + B * 4)
        da_ops = 4 * B * live * HEADS * HD
        reps = 24 // n_c
        row = (graph_ms(torch, [lambda c=c: decode_attention_fwd(
                   q, c[0], c[1], cl) for c in caches] * reps),
               graph_ms(torch, [lambda c=c: decode_attention_ref(
                   q, c[0], c[1], cl) for c in caches] * reps),
               graph_ms(torch, [lambda c=c: F.scaled_dot_product_attention(
                   qs, c[0], c[1], attn_mask=mask) for c in kv_t] * reps),
               bound_ms(da_bytes, da_ops, dname))
        contexts[(S, live)] = row
        log("kernels", f"decode_attention bf16, {live} live keys of {S} "
            f"slots: kernel {row[0]:.4f} ms, plain {row[1]:.4f} ms, SDPA "
            f"{row[2]:.4f} ms, bound {row[3][0]:.4f} ms ({row[3][1]})")
        del caches, kv_t
    t["decode_attention"] = contexts[(FULL_PROMPT + FULL_STEPS + 2, 150)] + (
        contexts,)
    t["exit_gate"] += (gate_rows,)
    errs_attn, t_attn = check_attention_kernels(torch, dev, rnd)
    t.update(t_attn)
    for name in rows:
        rows[name].update(errs_attn[name])
    for name, row in t.items():
        ms, plain, lib, (bnd, by) = row[:4]
        lib_s = "n/a" if lib is None else f"{lib:.4f} ms"
        log("kernels", f"{name} bf16 timing: kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, library {lib_s}, bound {bnd:.4f} ms ({by})")
    K.reset_launches()
    return rows["bfloat16"], t


def _paged_case(torch, dev, rnd, dt, P, lens, seed, heads=HEADS,
                kvh=HEADS, hd=HD):
    """B = len(lens) rows of P pages each, a shuffled table over a pool with
    spare pages; a last row of length 1 is retired (every entry the trash
    page)."""
    import numpy as np
    Bp = len(lens)
    NP = Bp * P + 5                              # + spare, then the trash
    q = rnd((Bp, 1, heads, hd), dt)
    kp = rnd((NP + 1, PAGE, kvh, hd), dt)
    vp = rnd((NP + 1, PAGE, kvh, hd), dt)
    perm = np.random.default_rng(seed).permutation(NP)[:Bp * P]
    table = torch.as_tensor(perm.reshape(Bp, P).astype(np.int32), device=dev)
    if lens[-1] == 1:
        table[-1] = NP
    cl = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, kp, vp, table, cl


def _live_keys(lens, window) -> int:
    return sum(min(n, window) if window else n for n in lens)


def check_attention_kernels(torch, dev, rnd):
    """Phase 2 for the paged decode-attention and flash-attention kernels:
    each against its plain version in fp32 and bf16, then bf16 timings."""
    import torch.nn.functional as F
    from repro_torch.core import paged as paged_lib
    from repro_torch.kernels.decode_attention.decode_attention import (
        paged_decode_attention_fwd)
    from repro_torch.kernels.decode_attention.ref import (
        paged_decode_attention_ref)
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_fwd)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    # live spans of about 150 (a serving tick early in a request) and 1024;
    # one full 4096-token row among fresh ones; the serve cell's full rows
    # (8 x 4096, no retired row). The kernels cut the long rows into
    # splits; window 300 leaves whole splits before its first key.
    paged_cases = ((2, [150, 1, 77, 149, 150, 128, 129, 1]),
                   (8, [1024, 1, 700, 1000, 513, 1024, 300, 1]),
                   (32, [4096, 1, 1, 1, 1, 1, 1, 1]),
                   (32, [4096] * 8))
    flash_cases = ((1, 77, HEADS), (1, 512, HEADS), (4, 77, HEADS),
                   (4, 512, HEADS), (1, 512, HEADS // 4))
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        # both kernels keep scores, probabilities and sums in fp32, so the
        # plain versions run on the inputs upcast to fp32 (exact for bf16);
        # atol 1e-4 covers the summation order, and in bf16 rtol 2**-7
        # covers rounding the output to bf16 (2**-8 relative at most)
        rtol = 1e-4 if dt == torch.float32 else 2.0 ** -7
        err_pd = 0.0
        for i, (P, lens) in enumerate(paged_cases):
            q, kp, vp, table, cl = _paged_case(torch, dev, rnd, dt, P, lens,
                                               i)
            live = len(lens) - (lens[-1] == 1)
            for window in (None, 20, 300):
                o = paged_decode_attention_fwd(q, kp, vp, table, cl,
                                               window=window).float()
                o_r = paged_decode_attention_ref(q.float(), kp.float(),
                                                 vp.float(), table, cl,
                                                 window)
                # the retired row's output is never read: compare live rows
                torch.testing.assert_close(o[:live], o_r[:live], atol=1e-4,
                                           rtol=rtol)
                err_pd = max(err_pd,
                             (o[:live] - o_r[:live]).abs().max().item())
            del kp, vp
        err_fa = 0.0
        for Bf, S, kvh in flash_cases:
            q = rnd((Bf, S, HEADS, HD), dt)
            k = rnd((Bf, S, kvh, HD), dt)
            v = rnd((Bf, S, kvh, HD), dt)
            for window in (None, 64):
                o = flash_attention_fwd(q, k, v, causal=True,
                                        window=window).float()
                o_r = flash_attention_ref(q.float(), k.float(), v.float(),
                                          True, window)
                torch.testing.assert_close(o, o_r, atol=1e-4, rtol=rtol)
                err_fa = max(err_fa, (o - o_r).abs().max().item())
        torch.cuda.synchronize()
        log("kernels", f"{name}: paged_decode_attention err {err_pd:.3g} "
            f"(785, 4563, 4103 and 32768 live keys, window None/20/300, "
            f"retired row); "
            f"flash_attention err {err_fa:.3g} (B 1/4, S 77/512, window "
            f"None/64, n_rep 1/4)")
        errs[name] = {"paged_decode_attention": err_pd,
                      "flash_attention": err_fa}

    # ---- bf16 timings at the serving shapes ----
    dt, dname = torch.bfloat16, "bfloat16"
    t = {}
    for P, lens in paged_cases:
        # 4 distinct pools (~0.6 GB together) so each call reads its pages
        # from memory, as a decode tick does after the layer's weights
        cases = [_paged_case(torch, dev, rnd, dt, P, lens, 10 + j)
                 for j in range(4)]
        live = _live_keys(lens, None)
        nbytes = (2 * live * HEADS * HD * 2 + 2 * len(lens) * HEADS * HD * 2
                  + len(lens) * (P + 1) * 4)
        ops = 4 * live * HEADS * HD
        views = []
        for q, kp, vp, table, cl in cases:
            kv = paged_lib.gather_view(kp, table).transpose(1, 2)
            vv = paged_lib.gather_view(vp, table).transpose(1, 2)
            mask = (torch.arange(kv.shape[2], device=dev)[None, :]
                    < cl[:, None])[:, None, None, :]
            views.append((q.transpose(1, 2), kv, vv, mask))
        row = (graph_ms(torch, [lambda c=c: paged_decode_attention_fwd(*c)
                                for c in cases] * 3),
               graph_ms(torch, [lambda c=c: paged_decode_attention_ref(*c)
                                for c in cases] * 3),
               graph_ms(torch, [lambda w=w: F.scaled_dot_product_attention(
                   w[0], w[1], w[2], attn_mask=w[3]) for w in views] * 3),
               bound_ms(nbytes, ops, dname))
        log("kernels", f"paged_decode_attention bf16, B=8, {live} live keys "
            f"({P} pages/row): kernel {row[0]:.4f} ms, plain {row[1]:.4f} "
            f"ms, SDPA on the gathered view {row[2]:.4f} ms, bound "
            f"{row[3][0]:.4f} ms ({row[3][1]})")
        if P == paged_cases[0][0]:
            t["paged_decode_attention"] = row
        del cases, views
    for Bf, S, kvh in flash_cases:
        q = rnd((Bf, S, HEADS, HD), dt)
        k = rnd((Bf, S, kvh, HD), dt)
        v = rnd((Bf, S, kvh, HD), dt)
        qs, ks, vs = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        ops = 4 * Bf * HEADS * HD * S * (S + 1) // 2
        n = 10
        row = (graph_ms(torch, [lambda: flash_attention_fwd(q, k, v)] * n),
               graph_ms(torch, [lambda: flash_attention_ref(q, k, v)] * n),
               graph_ms(torch, [lambda: F.scaled_dot_product_attention(
                   qs, ks, vs, is_causal=True,
                   enable_gqa=kvh != HEADS)] * n),
               bound_ms(nbytes, ops, dname))
        log("kernels", f"flash_attention bf16, B={Bf}, S={S}, n_rep="
            f"{HEADS // kvh}: kernel {row[0]:.4f} ms, plain {row[1]:.4f} "
            f"ms, causal SDPA {row[2]:.4f} ms, bound {row[3][0]:.4f} ms "
            f"({row[3][1]})")
        if (Bf, S, kvh) == (1, 512, HEADS):     # one serving prefill
            t["flash_attention"] = row
    errs_q, t_q = check_kv_quant_kernel(torch, dev, rnd, paged_cases)
    for name in errs:
        errs[name].update(errs_q[name])
    t.update(t_q)
    return errs, t


def _paged_q_case(torch, dev, rnd, dt, P, lens, kvh, seed, heads=HEADS,
                  hd=HD):
    """``_paged_case`` over int8 pools: codes and fp32 scales quantized as
    the model stores them, the trash page (the last) zeroed, scales too.
    Returns (q, k, v, table, cache_len, k_scale, v_scale)."""
    import numpy as np
    from repro_torch.models.model import _kv_quantize
    Bp = len(lens)
    NP = Bp * P + 5
    q = rnd((Bp, 1, heads, hd), dt)
    pools = []
    for _ in range(2):
        codes, scale = _kv_quantize(rnd((NP + 1, PAGE, kvh, hd),
                                        torch.float32))
        codes[-1], scale[-1] = 0, 0.0
        pools += [codes, scale]
    perm = np.random.default_rng(seed).permutation(NP)[:Bp * P]
    table = torch.as_tensor(perm.reshape(Bp, P).astype(np.int32), device=dev)
    if lens[-1] == 1:
        table[-1] = NP
    cl = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, pools[0], pools[2], table, cl, pools[1], pools[3]


def check_kv_quant_kernel(torch, dev, rnd, paged_cases):
    """Phase 2 for the int8 paged decode-attention kernel: against its
    plain version (codes and scales gathered, dequantized and attended in
    fp32) with fp32 and bf16 queries, windows None, 64 and 300, n_rep 1
    and 4,
    the retired row included (it reads the zeroed trash page); then bf16
    timings beside the fp paged kernel at the same live keys, SDPA on the
    gathered view dequantized to bf16 (a yardstick: no one PyTorch call
    takes int8 codes) and the byte bound."""
    import torch.nn.functional as F
    from repro_torch.core import paged as paged_lib
    from repro_torch.kernels.decode_attention.decode_attention import (
        paged_decode_attention_fwd)
    from repro_torch.kernels.decode_attention.ref import (
        paged_decode_attention_ref)
    from repro_torch.models.model import _kv_dequantize

    def run(c, window=None):
        return paged_decode_attention_fwd(*c[:5], window=window,
                                          k_scale=c[5], v_scale=c[6])

    def plain(c, window=None):
        return paged_decode_attention_ref(*c[:5], window, c[5], c[6])

    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        # the kernel and the plain version (on q upcast to fp32, exact)
        # dequantize the same codes in fp32 and sum in fp32 in other
        # orders: atol 1e-4; in bf16 rtol 2**-7 covers rounding the output
        # to bf16
        rtol = 1e-4 if dt == torch.float32 else 2.0 ** -7
        err = 0.0
        for i, (P, lens) in enumerate(paged_cases):
            for kvh in (HEADS, HEADS // 4):
                c = _paged_q_case(torch, dev, rnd, dt, P, lens, kvh, 20 + i)
                for window in (None, 64, 300):
                    o = run(c, window).float()
                    o_r = plain((c[0].float(),) + c[1:], window)
                    require(bool(torch.isfinite(o).all()),
                            "paged_decode_attention_q: non-finite output")
                    torch.testing.assert_close(o, o_r, atol=1e-4, rtol=rtol)
                    err = max(err, (o - o_r).abs().max().item())
                del c
        torch.cuda.synchronize()
        log("kernels", f"{name}: paged_decode_attention_q err {err:.3g} "
            f"(int8 pools, B=8, 785, 4563, 4103 and 32768 live keys, "
            f"window None/64/300, n_rep 1/4, the retired row included)")
        errs[name] = {"paged_decode_attention_q": err}

    dt, dname = torch.bfloat16, "bfloat16"
    t = {}
    for P, lens in paged_cases:
        cases = [_paged_q_case(torch, dev, rnd, dt, P, lens, HEADS, 30 + j)
                 for j in range(4)]
        fp_cases = [_paged_case(torch, dev, rnd, dt, P, lens, 30 + j)
                    for j in range(4)]
        live = _live_keys(lens, None)
        nbytes = (live * HEADS * (2 * HD + 8) + 2 * len(lens) * HEADS * HD * 2
                  + len(lens) * (P + 1) * 4)
        ops = 4 * live * HEADS * HD
        views = []
        for c in cases:
            kv = _kv_dequantize(paged_lib.gather_view(c[1], c[3]),
                                paged_lib.gather_view(c[5], c[3]), dt)
            vv = _kv_dequantize(paged_lib.gather_view(c[2], c[3]),
                                paged_lib.gather_view(c[6], c[3]), dt)
            mask = (torch.arange(kv.shape[1], device=dev)[None, :]
                    < c[4][:, None])[:, None, None, :]
            views.append((c[0].transpose(1, 2), kv.transpose(1, 2),
                          vv.transpose(1, 2), mask))
        ms = graph_ms(torch, [lambda c=c: run(c) for c in cases] * 3)
        fp_ms = graph_ms(torch, [lambda c=c: paged_decode_attention_fwd(*c)
                                 for c in fp_cases] * 3)
        plain_ms = graph_ms(torch, [lambda c=c: plain(c) for c in cases] * 3)
        sdpa_ms = graph_ms(torch, [lambda w=w: F.scaled_dot_product_attention(
            w[0], w[1], w[2], attn_mask=w[3]) for w in views] * 3)
        bnd = bound_ms(nbytes, ops, dname)
        log("kernels", f"paged_decode_attention_q bf16, B=8, {live} live "
            f"keys ({P} pages/row): kernel {ms:.4f} ms, fp paged kernel "
            f"{fp_ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA on the gathered "
            f"dequantized view {sdpa_ms:.4f} ms, bound {bnd[0]:.4f} ms "
            f"({bnd[1]})")
        if P == paged_cases[0][0]:
            t["paged_decode_attention_q"] = (ms, plain_ms, None, bnd, sdpa_ms,
                                             fp_ms)
        del cases, fp_cases, views
    return errs, t


def _plant_ties(torch, hn, w, rows):
    """Copy each listed row's best column to id 0 and to a higher id, in
    order (a later row's copy may overwrite an earlier row's, so only the
    last row's tie at id 0 is sure): the verify kernels must give the
    lowest id among equal logits."""
    V = w.shape[1]
    for r in rows:
        best = int((hn[r].float() @ w.float()).argmax())
        for j in (0, (best + 5) % V):
            w[:, j] = w[:, best]


def tree_ids(torch, dev, gen, B_rows: int):
    """A tree step's spec-head ids (TreeSpec(TREE_DEPTH, TREE_BRANCH), k =
    K_SPEC): node tokens (B_rows, N) int32 with ids 0, V - 1 and repeats,
    the rows of their gathered columns that each node's k children read
    (B_rows*N, k) int32, as core/engine.py builds them, and the children's
    ids (B_rows*N, k) int32."""
    from repro_torch.core.tree import TreeSpec
    tree = TreeSpec(TREE_DEPTH, TREE_BRANCH)
    N = tree.num_nodes
    toks = torch.randint(0, V, (B_rows, N), generator=gen, device=dev,
                         dtype=torch.int32)
    toks[0, :4] = torch.tensor([0, V - 1, V - 1, 0], dtype=torch.int32)
    child = torch.as_tensor(tree.children, device=dev).long().clamp(min=0)
    if TREE_BRANCH < K_SPEC:
        child = torch.cat([child, child[:, :1].expand(
            N, K_SPEC - TREE_BRANCH)], 1)
    child = child[:, :K_SPEC]
    rows = (torch.arange(B_rows, device=dev)[:, None, None] * N
            + child[None]).reshape(B_rows * N, K_SPEC).to(torch.int32)
    ids = toks.reshape(-1)[rows.long()].contiguous()
    return toks, rows, ids


def check_tree_kernels(torch, dev):
    """Phase 2 for the tree path: the spec head's two stages and
    predictor_mlp against their plain versions, and the verify kernels past
    one 8-row group, at the row counts the tree gives them (B*N node rows,
    B*P paths), in fp32 and bf16; then bf16 timings. Returns (max errors
    by kernel in bf16, timing rows, verify timings by row count, spec-head
    timings at a tree step's ids)."""
    from repro_torch.kernels.exit_gate import exit_gate as eg
    from repro_torch.kernels.exit_gate import ref as gref
    from repro_torch.kernels.predictor_mlp.predictor_mlp import (
        predictor_mlp_fused)
    from repro_torch.kernels.predictor_mlp.ref import predictor_mlp_ref
    from repro_torch.kernels.spec_head.ref import (spec_dot_ref,
                                                   spec_gather_ref,
                                                   spec_logits_ref)
    from repro_torch.kernels.spec_head.spec_head import (spec_head_dot,
                                                         spec_head_gather,
                                                         spec_head_logits)

    gen = torch.Generator(device=dev).manual_seed(4321)

    def rnd(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).to(dtype)

    def ids_for(R):
        ids = torch.randint(0, V, (R, K_SPEC), generator=gen, device=dev,
                            dtype=torch.int32)
        ids[0] = torch.tensor([0, V - 1, V - 1, 0], dtype=torch.int32)
        return ids

    F = 3 * K_SPEC
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        w = rnd((D, V), dt, 0.05)
        # the spec head: the gather bit-equal; the dot fp32 sums of the
        # same (upcast) products in another order, logits of size ~3:
        # atol = rtol = 1e-4; at random ids (spec_head_logits: a gather of
        # the R*k ids, then the dot) and at a tree step's (B = 4 and 8:
        # the node tokens gathered once, the children read from them)
        err_sh = 0.0
        for R in (1, 160, 320):
            hn = rnd((R, D), dt)
            ids = ids_for(R)
            got = spec_head_logits(hn, w, ids)
            want = spec_logits_ref(hn, w, ids)
            torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
            err_sh = max(err_sh, (got - want).abs().max().item())
            if R == 1:
                continue
            toks, rows, t_ids = tree_ids(torch, dev, gen, R // 40)
            cols = spec_head_gather(w, toks.reshape(-1))
            require(torch.equal(cols, spec_gather_ref(w, toks.reshape(-1))),
                    f"spec_head_gather differs from its plain version "
                    f"({name}, {R // 40} trees)")
            got = spec_head_dot(hn, cols, rows)
            torch.testing.assert_close(got, spec_dot_ref(hn, cols, rows),
                                       atol=1e-4, rtol=1e-4)
            torch.testing.assert_close(got, spec_logits_ref(hn, w, t_ids),
                                       atol=1e-4, rtol=1e-4)
            require(torch.equal(got, spec_head_logits(hn, w, t_ids)),
                    f"spec_head at tree ids: the step's composition and "
                    f"spec_head_logits differ ({name})")
            err_sh = max(err_sh, (got - spec_logits_ref(hn, w, t_ids))
                         .abs().max().item())
        # verify kernels at row counts past one 8-row group, planted ties;
        # ids exact, values atol = rtol = 1e-4
        err_av = err_tk = 0.0
        for R in (9, 160, 320):
            hn = rnd((R, D), dt)
            wt = w.clone()
            _plant_ties(torch, hn, wt, (0, R // 2, R - 1))
            tok, mx = eg.argmax_verify_fused(hn, wt)
            tok_r, mx_r = gref.verify_argmax_ref(hn, wt)
            require(torch.equal(tok, tok_r), f"argmax ids differ at R={R} "
                    f"({name})")
            require(int(tok[R - 1]) == 0, f"argmax tie-break at R={R}")
            torch.testing.assert_close(mx, mx_r, atol=1e-4, rtol=1e-4)
            ids, vals = eg.topk_verify_fused(hn, wt, K_SPEC)
            ids_r, vals_r = gref.verify_topk_ref(hn, wt, K_SPEC)
            require(torch.equal(ids, ids_r), f"top-k ids differ at R={R} "
                    f"({name})")
            require(int(ids[R - 1, 0]) == 0, f"top-k tie-break at R={R}")
            torch.testing.assert_close(vals, vals_r, atol=1e-4, rtol=1e-4)
            err_av = max(err_av, (mx - mx_r).abs().max().item())
            err_tk = max(err_tk, (vals - vals_r).abs().max().item())
            del wt
        del w
        # predictor MLP (fp32 weights whatever the model dtype): atol =
        # rtol = 1e-5 on probabilities; F = 12 (k = 4) runs the instance
        # unrolled to 12, F = 15 and 24 the one unrolled to 32
        err_pm = 0.0
        for R in (1, 108, 216):
            for f in (F, 15, 24):
                x = rnd((R, f), torch.float32)
                w1 = rnd((f, H_PRED), torch.float32, f ** -0.5)
                b1 = rnd((H_PRED,), torch.float32, 0.1)
                w2 = rnd((H_PRED, 1), torch.float32, H_PRED ** -0.5)
                b2 = rnd((1,), torch.float32, 0.1)
                got = predictor_mlp_fused(x, w1, b1, w2, b2)
                want = predictor_mlp_ref(x, w1, b1, w2, b2)
                torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
                err_pm = max(err_pm, (got - want).abs().max().item())
        torch.cuda.synchronize()
        log("kernels", f"{name}: spec_head err {err_sh:.3g} (R 1/160/320, "
            f"ids 0 and V-1, repeated; tree ids at R 160/320, the gather "
            f"bit-equal); verify at R 9/160/320: argmax and "
            f"top-k ids exact, ties -> lowest id, err {err_av:.3g} / "
            f"{err_tk:.3g}; predictor_mlp err {err_pm:.3g} (R 1/108/216, F "
            f"{F}/15/24)")
        errs[name] = {"spec_head": err_sh, "spec_head_gather": 0.0,
                      "predictor_mlp": err_pm,
                      "argmax_verify": err_av, "topk_verify": err_tk}

    # ---- bf16 timings at the tree path's shapes ----
    dt, dname = torch.bfloat16, "bfloat16"
    w = rnd((D, V), dt, 0.05)
    t, by_rows, sh_rows = {}, {}, {}
    for R in (160, 320):                    # B = 4 and 8 trees of 40 nodes
        rows, times = spec_head_stage_times(
            torch, dev, gen, rnd, rnd((R, D), dt), "spec_head bf16",
            ("spec_head_gather", "spec_head"),
            (lambda i: spec_head_gather(w, i),
             lambda i: spec_gather_ref(w, i),
             lambda i: torch.index_select(w, 1, i),
             spec_head_dot, spec_dot_ref,
             lambda a, i: spec_head_logits(a, w, i),
             lambda a, i: spec_logits_ref(a, w, i)),
            col_bytes=D * 2, col_sectors=D)
        sh_rows[R] = rows
        if R == 160:                        # whole-batch tree, B=4 x 40
            for name, row in times.items():
                t[name] = row[:4]
    for R in (108, 216):
        x = rnd((R, F), torch.float32)
        w1 = rnd((F, H_PRED), torch.float32, F ** -0.5)
        b1 = rnd((H_PRED,), torch.float32)
        w2 = rnd((H_PRED, 1), torch.float32, H_PRED ** -0.5)
        b2 = rnd((1,), torch.float32)
        nbytes = (R * F + F * H_PRED + 2 * H_PRED + 1 + R) * 4
        ops = R * (2 * F * H_PRED + 2 * H_PRED)
        n = 20
        row = (graph_ms(torch, [lambda: predictor_mlp_fused(
                   x, w1, b1, w2, b2)] * n),
               graph_ms(torch, [lambda: predictor_mlp_ref(
                   x, w1, b1, w2, b2)] * n),
               None,
               bound_ms(nbytes, ops, "float32"))
        log("kernels", f"predictor_mlp fp32, R={R}: kernel {row[0]:.4f} ms,"
            f" plain {row[1]:.4f} ms, bound {row[3][0]:.4f} ms "
            f"({row[3][1]})")
        if R == 108:                        # whole-batch tree, B=4 x 27
            t["predictor_mlp"] = row
    for R in (8, 160, 320):
        hn = rnd((R, D), dt)
        n = 5
        nbytes = R * D * 2 + D * V * 2
        rows = {}
        for name, ker, plain, lib, out_b in (
                ("argmax_verify", lambda: eg.argmax_verify_fused(hn, w),
                 lambda: gref.verify_argmax_ref(hn, w),
                 lambda: torch.argmax(hn @ w, -1), R * 8),
                ("topk_verify", lambda: eg.topk_verify_fused(hn, w, K_SPEC),
                 lambda: gref.verify_topk_ref(hn, w, K_SPEC),
                 lambda: torch.topk(hn @ w, K_SPEC, -1), R * K_SPEC * 8)):
            bnd = bound_ms(nbytes + out_b, 2 * R * D * V, dname)
            rows[name] = (graph_ms(torch, [ker] * n),
                          graph_ms(torch, [plain] * n),
                          graph_ms(torch, [lib] * n), bnd)
            ms, p_ms, l_ms, (b, by) = rows[name]
            # both bf16 verifies run on the tensor cores
            log("kernels", f"{name} bf16, R={R}: kernel {ms:.4f} ms, plain "
                f"{p_ms:.4f} ms, library {l_ms:.4f} ms, bound {b:.4f} ms "
                f"({by})")
        by_rows[R] = rows
    return errs["bfloat16"], t, by_rows, sh_rows


def _plant_ties_q(torch, hn, qt, rows):
    """``_plant_ties`` for a quantized head: each listed row's best column
    (codes and scale) copied to id 0 and a higher id."""
    from repro_torch.kernels.exit_gate import ref as gref
    V = qt.shape[1]
    for r in rows:
        best = int(gref.verify_argmax_q_ref(hn[r:r + 1], qt)[0][0])
        for j in (0, (best + 5) % V):
            qt.q[:, j], qt.scale[j] = qt.q[:, best], qt.scale[best]


# Top-k_q ids must equal the plain version's. fp32 sums of the same
# D = 4096 products in another order (the tile's k-steps, the plain
# product's) stray from the exact sum by ~1e-6 of |v|: at R=320, int8,
# bf16, row 153 the tile gave 14.059741 where the fp64 sum is 14.0597662
# (1.8e-6), and gave columns 6255 and 19836 one value, 12.1521358, where
# the fp64 sums are 12.1521456 and 12.1521539 (PERF.md, PR 22). Two
# columns can change places only where their exact logits lie within the
# two sums' errors of each other; SWAP_RTOL * |v| bounds that with a
# margin of ~2.5 over 2 * 2e-6.
SWAP_RTOL = 1e-5


def _exact_logits(torch, quant, hn_row, qt, cols):
    """The logits of one hidden row at head columns ``cols``, summed in
    fp64: each product of a bf16 or fp32 value and an integer code is
    exact there, so this is the sum the fp32 versions round."""
    qcols = qt.q[:, cols]
    codes = (torch.cat(quant.unpack_int4(qcols), dim=0) if qt.bits == 4
             else qcols)
    return (hn_row.double() @ codes.double()) * qt.scale[cols].double()


def _topk_ids_exact(torch, hn, qt, ids, ids_r, what):
    """Top-k_q ids against the plain version's: equal, but for one narrow
    exception. At a rank where they differ, the two ids' fp64 logits may
    lie within SWAP_RTOL * |v| of each other (a near-tie: fp32 sums may
    order it either way), unless the two columns are equal (an exact tie:
    lowest id first, as the plain version orders it). Returns a
    description of each excepted row; raises on any other difference."""
    from repro_torch import quant
    out = []
    for r in (ids != ids_r).any(dim=1).nonzero().flatten().tolist():
        got, want = ids[r].long(), ids_r[r].long()
        require(len(set(got.tolist())) == len(got),
                f"{what}: row {r} repeats an id: {got.tolist()}")
        rank = (got != want).nonzero().flatten()
        a, b = got[rank], want[rank]
        la, lb = (_exact_logits(torch, quant, hn[r], qt, c) for c in (a, b))
        same = ((qt.q[:, a] == qt.q[:, b]).all(dim=0)
                & (qt.scale[a] == qt.scale[b]))
        gap = (la - lb).abs()
        require(not bool(same.any()),
                f"{what}: row {r} ids {got.tolist()} against the plain "
                f"version's {want.tolist()}: an exact tie not lowest id first")
        require(bool((gap <= SWAP_RTOL * lb.abs()).all()),
                f"{what}: row {r} ids {got.tolist()} differ from the plain "
                f"version's {want.tolist()} beyond a near-tie: fp64 logits "
                f"{la.tolist()} against {lb.tolist()}")
        out.append(f"{what} row {r}: {got.tolist()} against "
                   f"{want.tolist()}, fp64 logits {la.tolist()} against "
                   f"{lb.tolist()} (gap {gap.max().item():.3g}, "
                   f"{gap.max().item() / lb.abs().min().item():.3g} of |v|)")
    return out


def check_quant_kernels(torch, dev):
    """Phase 2 for the weight-only quantized kernels: each against its
    plain version in int8 and int4, with fp32 and bf16 activations, at the
    AR path's B=4 rows and the tree's R=160/320 (predictor MLP: B=4 and the
    tree's 108/216 paths), planted ties and edge ids; the verify and
    spec-head kernels also against the fp kernels on the dequantized fp32
    head; the spec head also at a tree step's ids (its code-column gather
    bit-equal). Then bf16 timings beside the plain version, the fp kernel
    on the dequantized bf16 head as a yardstick (no one PyTorch call
    computes the same function), and the bound: the spec head's two
    stages at the tree's ids (R = 160, 320), the rest at B=4 too. Returns
    (max errors by kernel, timing rows of int8 at B=4 and, for the spec
    head, at R=160, {bits: {rows: timing row}}, {bits: {rows: the spec
    head's timings at the tree's ids}})."""
    from repro_torch import quant
    from repro_torch.kernels.exit_gate import exit_gate as eg
    from repro_torch.kernels.exit_gate import ref as gref
    from repro_torch.kernels.predictor_mlp.predictor_mlp import (
        predictor_mlp_fused, predictor_mlp_fused_q)
    from repro_torch.kernels.predictor_mlp.ref import predictor_mlp_q_ref
    from repro_torch.kernels.spec_head.ref import (spec_dot_q_ref,
                                                   spec_gather_q_ref,
                                                   spec_logits_ref)
    from repro_torch.kernels.spec_head.spec_head import (
        spec_head_dot_q, spec_head_gather_q, spec_head_logits,
        spec_head_logits_q)

    gen = torch.Generator(device=dev).manual_seed(2468)

    def rnd(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).to(dtype)

    def ids_for(R):
        ids = torch.randint(0, V, (R, K_SPEC), generator=gen, device=dev,
                            dtype=torch.int32)
        ids[0] = torch.tensor([0, V - 1, V - 1, 0], dtype=torch.int32)
        return ids

    F = 3 * K_SPEC
    errs = {k: 0.0 for k in QUANT_KERNELS}          # the gathers are exact

    def note(name, a, b, atol, rtol):
        # the kernels and the plain versions sum the same fp32 products of
        # the widened codes in different orders, and scale after the sum:
        # atol = rtol = 1e-4 on logits of size ~3, 1e-5 on probabilities
        torch.testing.assert_close(a, b, atol=atol, rtol=rtol)
        errs[name] = max(errs[name], (a - b).abs().max().item())

    near_ties = []
    for bits in (8, 4):
        w = rnd((D, V), torch.float32, 0.05)
        qt0 = quant.quantize_tensor(w, bits)
        wdq = qt0.dequantize()
        del w
        for dt in (torch.float32, torch.bfloat16):
            name = f"int{bits}, {str(dt).split('.')[1]}"
            for R in (B, 160, 320):
                hn = rnd((R, D), dt)
                qt = quant.QTensor(qt0.q.clone(), qt0.scale.clone(), bits)
                _plant_ties_q(torch, hn, qt, (0, R // 2, R - 1))
                tok, mx = eg.argmax_verify_fused_q(hn, qt)
                tok_r, mx_r = gref.verify_argmax_q_ref(hn, qt)
                require(torch.equal(tok, tok_r), f"argmax_q ids differ at "
                        f"R={R} ({name})")
                require(int(tok[R - 1]) == 0, f"argmax_q tie-break, R={R}")
                note("argmax_verify_q", mx, mx_r, 1e-4, 1e-4)
                ids, vals = eg.topk_verify_fused_q(hn, qt, K_SPEC)
                ids_r, vals_r = gref.verify_topk_q_ref(hn, qt, K_SPEC)
                near_ties += _topk_ids_exact(
                    torch, hn, qt, ids, ids_r, f"top-k_q at R={R} ({name})")
                require(int(ids[R - 1, 0]) == 0, f"top-k_q tie-break, R={R}")
                note("topk_verify_q", vals, vals_r, 1e-4, 1e-4)
                if dt == torch.bfloat16:
                    # one tile main loop and k-order for both kernels
                    require(torch.equal(ids[:, 0], tok)
                            and torch.equal(vals[:, 0], mx), f"top-k_q's "
                            f"first column differs from argmax_q, R={R} "
                            f"({name})")
                if R != 320:
                    # the fp kernels on the dequantized fp32 head
                    wq = qt.dequantize()
                    require(torch.equal(eg.argmax_verify_fused(
                        hn.float(), wq)[0], tok), f"argmax_q vs fp kernel "
                        f"on the dequantized head, R={R} ({name})")
                    require(torch.equal(eg.topk_verify_fused(
                        hn.float(), wq, K_SPEC)[0], ids), f"top-k_q vs fp "
                        f"kernel on the dequantized head, R={R} ({name})")
                    del wq
                sids = ids_for(R)
                got = spec_head_logits_q(hn, qt0, sids)
                note("spec_head_q", got, spec_logits_ref(hn, qt0, sids),
                     1e-4, 1e-4)
                torch.testing.assert_close(got, spec_head_logits(
                    hn.float(), wdq, sids), atol=1e-4, rtol=1e-4)
                del qt
                if R == B:
                    continue
                # a tree step's ids (B = 4 and 8): the node tokens' code
                # columns gathered once, the children read from them
                toks, rws, t_ids = tree_ids(torch, dev, gen, R // 40)
                cols = spec_head_gather_q(qt0, toks.reshape(-1))
                want = spec_gather_q_ref(qt0, toks.reshape(-1))
                require(torch.equal(cols.codes, want.codes)
                        and torch.equal(cols.scales, want.scales),
                        f"spec_head_gather_q differs from its plain version "
                        f"({name}, {R // 40} trees)")
                got = spec_head_dot_q(hn, cols, rws)
                note("spec_head_q", got, spec_dot_q_ref(hn, cols, rws), 1e-4,
                     1e-4)
                torch.testing.assert_close(got, spec_logits_ref(
                    hn, qt0, t_ids), atol=1e-4, rtol=1e-4)
                require(torch.equal(got, spec_head_logits_q(hn, qt0, t_ids)),
                        f"spec_head_q at tree ids: the step's composition "
                        f"and spec_head_logits_q differ ({name})")
        for R in (B, 108, 216):
            x = rnd((R, F), torch.float32)
            q1 = quant.quantize_tensor(rnd((F, H_PRED), torch.float32,
                                           F ** -0.5), bits)
            q2 = quant.quantize_tensor(rnd((H_PRED, 1), torch.float32,
                                           H_PRED ** -0.5), bits)
            b1 = rnd((H_PRED,), torch.float32, 0.1)
            b2 = rnd((1,), torch.float32, 0.1)
            got = predictor_mlp_fused_q(x, q1, b1, q2, b2)
            note("predictor_mlp_q", got,
                 predictor_mlp_q_ref(x, q1, b1, q2, b2), 1e-5, 1e-5)
            torch.testing.assert_close(got, predictor_mlp_fused(
                x, q1.dequantize(), b1, q2.dequantize(), b2), atol=1e-5,
                rtol=1e-5)
        del qt0, wdq
        torch.cuda.synchronize()
        log("kernels", f"int{bits}: argmax_verify_q and topk_verify_q at R "
            f"{B}/160/320 (fp32 and bf16): ids exact (but for the near-ties "
            f"logged below), ties -> lowest id, "
            f"equal to the fp kernels on the dequantized head, bf16 top-k_q's "
            f"first column bit-equal to argmax_q; spec_head_logits_q "
            f"(ids 0 and V-1, repeated) and predictor_mlp_q (R {B}/108/216) "
            f"match their plain versions and the fp kernels; at tree ids "
            f"(R 160/320) spec_head_gather_q is bit-equal and the "
            f"spec_head_q dot matches")
    log("kernels", "quantized kernels, max err over int8/int4 and fp32/"
        "bf16: " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    log("kernels", f"top-k_q: {len(near_ties)} rows of "
        f"{2 * 2 * (B + 160 + 320)} ordered a near-tie (fp64 logits within "
        f"{SWAP_RTOL:g} of |v|) otherwise than the plain version"
        + "".join(f"; {t}" for t in near_ties))

    # ---- bf16 timings: B=4 (AR) and R=160/320 (tree), int8 and int4 ----
    # Every int8 or int4 code is exact in bf16, so with bf16 hidden rows
    # the products' rate is the bf16 one (as for the fp kernels).
    dt, dname = torch.bfloat16, "bfloat16"
    by_bits, sh_rows = {}, {}
    for bits in (8, 4):
        qt = quant.quantize_tensor(rnd((D, V), torch.float32, 0.05), bits)
        yard_w = qt.dequantize().to(dt)
        code_b = qt.q.numel() + 4 * V                 # codes + scales
        rows = {}
        for R in (B, 160, 320):
            hn = rnd((R, D), dt)
            n = 20 if R == B else 5
            out = {}
            for name, ker, plain, yard, out_b in (
                    ("argmax_verify_q",
                     lambda: eg.argmax_verify_fused_q(hn, qt),
                     lambda: gref.verify_argmax_q_ref(hn, qt),
                     lambda: eg.argmax_verify_fused(hn, yard_w), R * 8),
                    ("topk_verify_q",
                     lambda: eg.topk_verify_fused_q(hn, qt, K_SPEC),
                     lambda: gref.verify_topk_q_ref(hn, qt, K_SPEC),
                     lambda: eg.topk_verify_fused(hn, yard_w, K_SPEC),
                     R * K_SPEC * 8)):
                out[name] = (graph_ms(torch, [ker] * n),
                             graph_ms(torch, [plain] * n), None,
                             bound_ms(R * D * 2 + code_b + out_b,
                                      2 * R * D * V, dname),
                             graph_ms(torch, [yard] * n))
            if R != B:
                out.update(quant_spec_head_times(
                    torch, dev, gen, rnd, qt, yard_w, hn,
                    sh_rows.setdefault(bits, {})))
            for name, (ms, p_ms, _, (b, by), y_ms) in out.items():
                log("kernels", f"{name} int{bits}, bf16, R={R}: kernel "
                    f"{ms:.4f} ms, plain {p_ms:.4f} ms, fp kernel on the "
                    f"dequantized bf16 head {y_ms:.4f} ms, bound {b:.4f} ms "
                    f"({by})")
            rows[R] = out
        for R in (B, 108, 216):
            x = rnd((R, F), torch.float32)
            q1 = quant.quantize_tensor(rnd((F, H_PRED), torch.float32,
                                           F ** -0.5), bits)
            q2 = quant.quantize_tensor(rnd((H_PRED, 1), torch.float32,
                                           H_PRED ** -0.5), bits)
            b1 = rnd((H_PRED,), torch.float32)
            b2 = rnd((1,), torch.float32)
            w1, w2 = q1.dequantize(), q2.dequantize()
            nbytes = (R * F * 4 + q1.nbytes() + q2.nbytes()
                      + (H_PRED + 1) * 4 + R * 4)
            n = 20
            row = (graph_ms(torch, [lambda: predictor_mlp_fused_q(
                       x, q1, b1, q2, b2)] * n),
                   graph_ms(torch, [lambda: predictor_mlp_q_ref(
                       x, q1, b1, q2, b2)] * n),
                   None,
                   bound_ms(nbytes, R * (2 * F * H_PRED + 2 * H_PRED),
                            "float32"),
                   graph_ms(torch, [lambda: predictor_mlp_fused(
                       x, w1, b1, w2, b2)] * n))
            log("kernels", f"predictor_mlp_q int{bits}, R={R}: kernel "
                f"{row[0]:.4f} ms, plain {row[1]:.4f} ms, fp kernel on the "
                f"dequantized weights {row[4]:.4f} ms, bound {row[3][0]:.5f}"
                f" ms ({row[3][1]})")
            rows.setdefault(R, {})["predictor_mlp_q"] = row
        by_bits[bits] = rows
        del qt, yard_w
    errs["exit_gate_q"], gate_rows = check_exit_gate_q(torch, dev, rnd)
    for bits, rows in gate_rows.items():
        for R, row in rows.items():
            by_bits[bits].setdefault(R, {})["exit_gate_q"] = row
    host_gate_times(torch, dev, rnd)
    timing = {name: by_bits[8][160 if name in ("spec_head_q",
                                               "spec_head_gather_q") else B]
              [name] for name in QUANT_KERNELS}
    return errs, timing, by_bits, sh_rows


def spec_head_stage_times(torch, dev, gen, rnd, hn, label, names, stages,
                          col_bytes, col_sectors, yard=None):
    """bf16 timings of a spec head's two stages at a tree step's ids (R =
    hn's rows = B*N node rows, k = K_SPEC), the fp head's and the quantized
    head's alike: the gather of the R node tokens' columns (once per step;
    the head is 262 MB in bf16, 131 / 66 MB of int8 / int4 codes, so every
    call starts cold) beside its plain version and ``torch.index_select``;
    the dot at each exit point over distinct hidden rows and column buffers
    (more than the 50 MB L2 in all: a layer's weights pass between two exit
    points) beside its plain version; one CUDA graph of a step's gather then
    3 dots; and the composed logits per call at the step's ids (as every
    exit point ran the spec head before the gather was hoisted) and at
    random ids (on no main path).

    ``names`` = (gather, dot) kernel names; ``stages`` = (gather(ids),
    gather_plain(ids), index_select(ids), dot(hn, cols, rows),
    dot_plain(hn, cols, rows), logits(hn, ids), logits_plain(hn, ids));
    ``col_bytes`` the bytes of one gathered column (its scale included),
    ``col_sectors`` the 32-byte sectors that one column's gather reads;
    ``yard`` an optional (gather(ids), dot(hn, cols, rows)) pair of the fp
    stages on the dequantized bf16 head, timed beside the stages. Returns
    ({name: row} for the kernels line, {name: (ms, plain, library, bound,
    yardstick)})."""
    gather, gather_plain, gather_lib, dot, dot_plain, logits, logits_plain = (
        stages)
    g_name, d_name = names
    dname = "bfloat16"
    R = hn.shape[0]
    trees = [tree_ids(torch, dev, gen, R // 40) for _ in range(4)]
    toks = [tk.reshape(-1) for tk, _, _ in trees]

    def over_ids(fn):
        return graph_ms(torch, [lambda t=t: fn(t) for t in toks] * 3)

    def over_sets(fn, sets):
        return graph_ms(torch, [lambda a=a, c=c, r=r: fn(a, c, r)
                                for a, c, r in sets])

    g_ms, g_plain, g_lib = (over_ids(gather), over_ids(gather_plain),
                            over_ids(gather_lib))
    # ids read, the columns read and written once
    g_bnd = bound_ms(2 * R * col_bytes + R * 4, 0, dname)
    g_sectors = ((R * col_sectors * 32 + R * col_bytes + R * 4)
                 / HBM_BYTES_PER_S * 1e3)
    n_sets = max(4, int(64e6 // (R * D * 2 + R * col_bytes)) + 1)
    hns = [rnd((R, D), torch.bfloat16) for _ in range(n_sets)]
    sets = [(a, gather(toks[q % 4]), trees[q % 4][1])
            for q, a in enumerate(hns)]
    d_ms, d_plain = over_sets(dot, sets), over_sets(dot_plain, sets)
    d_bnd = bound_ms(R * D * 2 + R * col_bytes + 2 * R * K_SPEC * 4,
                     2 * R * K_SPEC * D, dname)
    y_ms = (None, None)
    if yard is not None:
        y_sets = [(a, yard[0](toks[q % 4]), trees[q % 4][1])
                  for q, a in enumerate(hns)]
        y_ms = (over_ids(yard[0]), over_sets(yard[1], y_sets))
        del y_sets
    del sets

    def step(q):                            # a gather, a dot at 3 exit points
        cols = gather(toks[q % 4])
        for j in range(3):
            dot(hns[(3 * q + j) % n_sets], cols, trees[q % 4][1])

    step_ms = graph_ms(torch, [lambda q=q: step(q)
                               for q in range(max(4, n_sets // 3))])
    tree_call_ms = graph_ms(torch, [lambda a=a, q=q: logits(a, trees[q % 4][2])
                                    for q, a in enumerate(hns)])
    del hns
    id_sets = []
    for _ in range(4):
        ids = torch.randint(0, V, (R, K_SPEC), generator=gen, device=dev,
                            dtype=torch.int32)
        ids[0] = torch.tensor([0, V - 1, V - 1, 0], dtype=torch.int32)
        id_sets.append(ids)
    uniq = len(torch.unique(torch.cat(id_sets)))
    rand_ms = graph_ms(torch, [lambda i=i: logits(hn, i)
                               for i in id_sets] * 3)
    rand_plain = graph_ms(torch, [lambda i=i: logits_plain(hn, i)
                                  for i in id_sets] * 3)
    rand_bnd = bound_ms(R * D * 2 + uniq * col_bytes / len(id_sets)
                        + R * K_SPEC * 8, 2 * R * K_SPEC * D, dname)
    yard_g = (f", fp gather of the dequantized bf16 head {y_ms[0]:.4f}"
              if yard is not None else "")
    yard_d = (f", fp dot on the dequantized head's columns {y_ms[1]:.4f}"
              if yard is not None else "")
    log("kernels", f"{label}, R={R} ({R // 40} trees of 40 nodes): gather "
        f"of the {R} node tokens' columns ({g_name}) {g_ms:.4f} ms (plain "
        f"{g_plain:.4f}, index_select {g_lib:.4f}{yard_g}, bound "
        f"{g_bnd[0]:.5f} ms in bytes, {g_sectors:.4f} in 32-byte sectors); "
        f"dot ({d_name}) {d_ms:.4f} ms (plain {d_plain:.4f}{yard_d}, bound "
        f"{d_bnd[0]:.5f} ms ({d_bnd[1]})); one step's gather then 3 dots, "
        f"one graph, {step_ms:.4f} ms; per call at the step's ids "
        f"{tree_call_ms:.4f} ms, at random ids {rand_ms:.4f} ms (plain "
        f"{rand_plain:.4f}, bound {rand_bnd[0]:.5f} ms ({rand_bnd[1]}))")
    rows = {
        g_name: {"ms": g_ms, "plain_ms": g_plain, "library_ms": g_lib,
                 "bound_ms": g_bnd[0], "bound_by": g_bnd[1]},
        d_name: {"ms": d_ms, "plain_ms": d_plain, "library_ms": None,
                 "bound_ms": d_bnd[0], "bound_by": d_bnd[1],
                 "step_gather_then_3_dots_ms": step_ms,
                 "per_call_tree_ids_ms": tree_call_ms,
                 "per_call_random_ids": {
                     "ms": rand_ms, "plain_ms": rand_plain,
                     "bound_ms": rand_bnd[0], "bound_by": rand_bnd[1]}}}
    if yard is not None:
        rows[g_name]["yardstick_ms"], rows[d_name]["yardstick_ms"] = y_ms
    return rows, {g_name: (g_ms, g_plain, g_lib, g_bnd, y_ms[0]),
                  d_name: (d_ms, d_plain, None, d_bnd, y_ms[1])}


def quant_spec_head_times(torch, dev, gen, rnd, qt, yard_w, hn, sh_rows):
    """The quantized spec head's two stages timed at a tree step's ids
    (``spec_head_stage_times``), with the fp stages on the dequantized
    bf16 head as the yardstick. Records the rows in ``sh_rows[R]``;
    returns the two stages' timing rows (ms, plain, library, bound,
    yardstick)."""
    from repro_torch.kernels.spec_head.ref import (spec_dot_q_ref,
                                                   spec_gather_q_ref,
                                                   spec_logits_ref)
    from repro_torch.kernels.spec_head.spec_head import (
        spec_head_dot, spec_head_dot_q, spec_head_gather, spec_head_gather_q,
        spec_head_logits_q)
    Dp = qt.q.shape[0]
    rows, times = spec_head_stage_times(
        torch, dev, gen, rnd, hn, f"quantized spec head int{qt.bits} bf16",
        ("spec_head_gather_q", "spec_head_q"),
        (lambda i: spec_head_gather_q(qt, i),
         lambda i: spec_gather_q_ref(qt, i),
         lambda i: torch.index_select(qt.q, 1, i),
         spec_head_dot_q, spec_dot_q_ref,
         lambda a, i: spec_head_logits_q(a, qt, i),
         lambda a, i: spec_logits_ref(a, qt, i)),
        col_bytes=Dp + 4, col_sectors=Dp + 1,
        yard=(lambda i: spec_head_gather(yard_w, i), spec_head_dot))
    sh_rows[hn.shape[0]] = rows
    return times


def piecewise_gate_q(torch, hn, head, ids, prev, l1, l2):
    """The quantized AR gate as pieces, as the port ran it before
    exit_gate_q: the spec-head kernels (over a quantized head its column
    gather and its dot) with their softmax, the difference, the
    concatenation, then the predictor-MLP kernel (the quantized one for a
    quantized bank)."""
    from repro_torch.kernels.predictor_mlp.ops import predictor_mlp
    from repro_torch.kernels.spec_head.ops import spec_head
    logits, probs = spec_head(hn, head, ids)
    feats = torch.cat([logits, probs, probs - prev], -1)
    return predictor_mlp(feats, {"layers": [l1, l2]}), probs, logits


def check_exit_gate_q(torch, dev, rnd):
    """Phase 2 for the quantized gate (exit_gate_q): against its plain
    version with fp32 and bf16 hidden rows, B in {1, 4, 8, 33}, at
    Llama-2-7B's and mamba2-130m's widths, every (head, bank) pair of fp /
    int8 / int4 but the fp pair, k in {1, 3, 4} (k = 3: F = 9, whose W1
    stays int8 under int4), ids 0, V-1, repeated and out of range (the
    plain version on the ids clamped to [0, V)); two calls bit-equal.
    Then bf16 timings at B = 4 and 8 on int8 and int4 heads and banks (the
    AR and serve gate under quant="int8" / "int4"), beside the plain
    version, the piecewise chain it replaced in one CUDA graph (a
    yardstick: no one PyTorch call computes the gate), the byte bound and
    the bound in 32-byte sectors. Returns (max error, {bits: {B: timing
    row}})."""
    from repro_torch import quant
    from repro_torch.kernels.exit_gate import exit_gate as eg
    from repro_torch.kernels.exit_gate import ref as gref
    gen = torch.Generator(device=dev).manual_seed(1357)

    def bank(k, bits):
        F = 3 * k
        w1 = rnd((F, H_PRED), torch.float32, F ** -0.5)
        w2 = rnd((H_PRED, 1), torch.float32, H_PRED ** -0.5)
        if bits:
            w1, w2 = (quant.quantize_tensor(w1, bits),
                      quant.quantize_tensor(w2, bits))
        return ({"w": w1, "b": rnd((H_PRED,), torch.float32, 0.1)},
                {"w": w2, "b": rnd((1,), torch.float32, 0.1)})

    combos = [(h, b) for h in (0, 8, 4) for b in (0, 8, 4) if h or b]
    banks = {(k, bits): bank(k, bits) for k in (1, 3, 4)
             for bits in (0, 8, 4)}
    err, n_calls = 0.0, 0
    for d, v in ((D, V), (M_D, M_V)):
        w32 = rnd((d, v), torch.float32, 0.05)
        heads = {8: quant.quantize_tensor(w32, 8),
                 4: quant.quantize_tensor(w32, 4)}
        for dt in (torch.float32, torch.bfloat16):
            heads[0] = w32.to(dt)
            for R in (1, 4, 8, 33):
                hn = rnd((R, d), dt)
                for k in (1, 3, 4):
                    ids = torch.randint(0, v, (R, k), generator=gen,
                                        device=dev, dtype=torch.int32)
                    edge = torch.tensor([0, v - 1, -5, v + 7, 0, v - 1],
                                        dtype=torch.int32, device=dev)
                    ids.view(-1)[:min(6, R * k)] = edge[:min(6, R * k)]
                    if R > 1:
                        ids[-1] = ids[-1, 0].item()      # a repeated id
                    prev = torch.softmax(rnd((R, k), torch.float32), -1)
                    clamped = ids.clamp(0, v - 1)
                    for hb, bb in combos:
                        l1, l2 = banks[(k, bb)]
                        got = eg.exit_gate_fused_q(hn, heads[hb], ids, prev,
                                                   l1, l2)
                        again = eg.exit_gate_fused_q(hn, heads[hb], ids,
                                                     prev, l1, l2)
                        want = gref.exit_gate_q_ref(hn, heads[hb], clamped,
                                                    prev, l1, l2)
                        what = (f"exit_gate_q D={d} {dt} R={R} k={k} head "
                                f"{hb or 'fp'} bank {bb or 'fp'}")
                        for a, a2, b in zip(got, again, want):
                            require(torch.equal(a, a2), f"{what}: two calls "
                                    "differ")
                            # fp32 sums of the same products in another
                            # order, the scales after them: 1e-4
                            torch.testing.assert_close(a, b, atol=1e-4,
                                                       rtol=1e-4)
                            err = max(err, (a - b).abs().max().item())
                        n_calls += 2
        del w32, heads
    torch.cuda.synchronize()
    log("kernels", f"exit_gate_q: {n_calls} calls (fp32 and bf16 rows, B "
        f"1/4/8/33, D {D} and {M_D}, k 1/3/4, {len(combos)} head x bank "
        f"pairs, edge, repeated and out-of-range ids) match the plain "
        f"version, max err {err:.3g}; every pair of calls bit-equal")

    dt = torch.bfloat16
    w32 = rnd((D, V), torch.float32, 0.05)
    rows = {}
    for bits in (8, 4):
        head = quant.quantize_tensor(w32, bits)
        l1, l2 = bank(K_SPEC, bits)
        Dp = D // 2 if bits == 4 else D             # stored head rows
        bank_b = (l1["w"].nbytes() + l2["w"].nbytes() + (H_PRED + 1) * 4)
        rows[bits] = {}
        for R in (B, GATE_BATCH):
            hn = rnd((R, D), dt)
            # distinct speculative ids per call: the columns start cold
            id_sets = [torch.randint(0, V, (R, K_SPEC), generator=gen,
                                     device=dev, dtype=torch.int32)
                       for _ in range(20)]
            prev = torch.softmax(rnd((R, K_SPEC), torch.float32), -1)
            fixed = (R * D * 2 + R * K_SPEC * 8 + bank_b
                     + R * (1 + 2 * K_SPEC) * 4)
            ops = R * (2 * K_SPEC * D + 2 * 3 * K_SPEC * H_PRED
                       + 4 * H_PRED)
            row = (graph_ms(torch, [lambda i=i: eg.exit_gate_fused_q(
                       hn, head, i, prev, l1, l2) for i in id_sets]),
                   graph_ms(torch, [lambda i=i: gref.exit_gate_q_ref(
                       hn, head, i, prev, l1, l2) for i in id_sets]),
                   None,
                   bound_ms(fixed + R * K_SPEC * (Dp + 4), ops, "float32"),
                   graph_ms(torch, [lambda i=i: piecewise_gate_q(
                       torch, hn, head, i, prev, l1, l2) for i in id_sets]),
                   bound_ms(fixed + R * K_SPEC * Dp * 32, ops,
                            "float32")[0])
            rows[bits][R] = row
            log("kernels", f"exit_gate_q int{bits}, bf16, B={R}: kernel "
                f"{row[0]:.4f} ms, plain {row[1]:.4f} ms, piecewise chain "
                f"(5 launches) {row[4]:.4f} ms, bound {row[3][0]:.5f} ms "
                f"({row[3][1]}), {row[5]:.5f} ms in 32-byte sectors")
        del head
    return err, rows


def host_gate_times(torch, dev, rnd, n: int = 200) -> None:
    """Host time per call (launches enqueued, no sync inside) of the AR
    gate and verify entry points at B=4 in bf16: the fused fp gate, the
    quantized one as it ran before exit_gate_q (spec head, features,
    predictor MLP: ``piecewise_gate_q``) and as it runs now (one launch),
    and the fp against the quantized verify. The AR step makes 32 gate
    calls, so this is the host cost the quantized path adds per step."""
    from repro_torch import quant
    from repro_torch.core.predictor import init_predictors, predictor_at
    from repro_torch.kernels.exit_gate import ops as gate_ops
    from repro_torch.models.model import build_model
    spec = build_model(llama(32, "bfloat16")).run.specee
    bank = init_predictors(spec, 32, torch.Generator(device=dev)
                           .manual_seed(3), dev)
    qbank = {"layers": [{"w": quant.quantize_tensor(l["w"], 8), "b": l["b"]}
                        for l in bank["layers"]]}
    w = rnd((D, V), torch.bfloat16, 0.05)
    qt = quant.quantize_tensor(w, 8)
    hn = rnd((B, D), torch.bfloat16)
    ids = torch.randint(0, V, (B, K_SPEC), device=dev, dtype=torch.int32)
    prev = torch.full((B, K_SPEC), 1.0 / K_SPEC, device=dev)

    def host_us(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t = time.perf_counter() - t0
        torch.cuda.synchronize()
        return t / n * 1e6

    q1, q2 = predictor_at(qbank, 5)["layers"]
    times = {"gate fp fused": host_us(lambda: gate_ops.exit_gate(
                 hn, w, ids, prev, bank, 5, impl="kernel")),
             "gate int8 piecewise": host_us(lambda: piecewise_gate_q(
                 torch, hn, qt, ids, prev, q1, q2)),
             "gate int8 fused": host_us(lambda: gate_ops.exit_gate(
                 hn, qt, ids, prev, qbank, 5, impl="kernel"))}
    times.update({f"verify {k}": host_us(lambda h=h: gate_ops.verify_argmax(
        hn, h, impl="kernel")) for k, h in (("fp", w), ("int8", qt))})
    log("kernels", "host time per call at B=4, bf16 (launches enqueued, "
        "mean of 200): " + ", ".join(f"{k} {v:.1f} us"
                                     for k, v in times.items()))


# ---------------------------------------------------------------------------
# phases 3 and 4: the decode path through the public entry points
# ---------------------------------------------------------------------------
def llama(layers: int, dtype: str, **serve):
    """llama2-7b at full width with ``layers`` layers in ``dtype``; keyword
    arguments replace ``ServeConfig`` fields."""
    import dataclasses
    from repro_torch.configs import get_config
    run = get_config("llama2-7b")
    return dataclasses.replace(
        run, model=dataclasses.replace(run.model, num_layers=layers,
                                       dtype=dtype),
        serve=dataclasses.replace(run.serve, **serve))


ALL_KERNELS = dict(flash_attention=True, decode_kernel=True,
                   exit_gate_kernel=True, exit_gate_impl="kernel")
TREE_KERNELS = dict(ALL_KERNELS, spec_head_kernel=True)


def drive(model, params, sw, strategy, prompts, new_tokens, cache=None,
          quant=None):
    from repro_torch.api import Engine
    session = Engine.create(model, params, sw, strategy=strategy,
                            quant=quant).new_session(cache=cache)
    results = [session.prefill(prompts, max_new_tokens=new_tokens)]
    while not session.all_done():
        results.append(session.step())
    return results


def parity(torch, dev):
    import numpy as np
    from repro_torch.api import DenseStrategy, SpecEEStrategy
    from repro_torch.core import engine as eng
    from repro_torch.models.model import ModelFlags, build_model
    run = llama(4, "float32")
    m_plain = build_model(run)
    m_ker = build_model(run, ModelFlags(exit_gate_kernel=True,
                                        exit_gate_impl="kernel",
                                        decode_kernel=True))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = m_plain.init(gen, dev)
    sw = eng.init_specee(m_plain, gen, dev)
    prompts = np.random.default_rng(0).integers(0, V, (B, 16))

    def summary(results):
        return [(r.tokens.tolist(), r.exit_layer.tolist(), r.exited.tolist(),
                 r.units_run) for r in results]

    for thresh in (1.5, 0.4, -0.1):
        a = summary(drive(m_ker, params, sw,
                          SpecEEStrategy(threshold=thresh), prompts, 9))
        b = summary(drive(m_plain, params, sw,
                          SpecEEStrategy(threshold=thresh), prompts, 9))
        require(a == b, f"kernel vs plain run differs at threshold {thresh}")
        exits = sum(sum(x) for _, _, x, _ in a[1:])
        log("parity", f"threshold {thresh}: 8 steps, tokens/exit points/"
            f"exits identical with kernels and plain versions "
            f"({exits} exits)")
        if thresh == 1.5:
            dense = summary(drive(m_ker, params, sw, DenseStrategy(),
                                  prompts, 9))
            require([r[0] for r in dense] == [r[0] for r in a],
                    "specee at threshold 1.5 differs from dense")
            log("parity", "threshold 1.5 equals dense greedy decoding")

    # oracle speculative set: the full-head argmax after unit 1 forces an
    # exit there (threshold < 0) — exercises verify, exit and propagation
    toks = {"tokens": torch.as_tensor(prompts, device=dev)}
    first, probe = eng.init_decode_state(m_plain, params, sw, toks, 24)
    h = m_plain.embed(params, first[:, None])[:, 0, :]
    layer_argmax = []
    for u in range(2):
        h, _ = m_plain.run_unit(params, 0, u, h, probe.cache["segments"][0],
                                probe.cache["len"])
        layer_argmax.append(torch.argmax(m_plain.logits(params, h), -1))
    oracle = layer_argmax[1].to(torch.int32)
    # a row exits at the first unit whose argmax is in the set: unit 0 if
    # its argmax already equals the oracle token, else unit 1
    expect = torch.where(layer_argmax[0] == layer_argmax[1], 0, 1).tolist()
    outs = []
    for m in (m_ker, m_plain):
        _, st = eng.init_decode_state(m, params, sw, toks, 24)
        tok, st, info = eng.ar_decode_step(
            m, params, sw, st, threshold=-0.1,
            spec_ids_override=oracle[:, None].expand(B, K_SPEC))
        require(bool(info.exited.all())
                and info.exit_point.tolist() == expect
                and info.units_run == max(expect) + 1
                and torch.equal(tok, oracle),
                f"oracle set: exits {info.exit_point.tolist()}, expected "
                f"{expect}")
        outs.append((tok.tolist(), st.cache["segments"][0]["u0"]["k"]))
    require(outs[0][0] == outs[1][0], "oracle exit tokens differ")
    torch.testing.assert_close(outs[0][1], outs[1][1], atol=1e-4, rtol=1e-4)
    log("parity", f"oracle set: every row exits (exit points {expect}) with "
        "the verified token; propagated K/V equal (atol 1e-4) with kernels "
        "and plain")
    serving_parity(torch, dev, params, sw)
    tree_parity(torch, dev, params, sw)
    quant_parity(torch, dev, params, sw)
    kvq_parity(torch, dev, params, sw)
    megatick_parity(torch, dev, params, sw)
    del params, sw


def megatick_parity(torch, dev, params, sw):
    """Phase 3, megaticks: llama2-7b at full width, 4 layers, fp32.
    Whole-batch sessions (B=4, a budget of 8) with every kernel, stepped
    as megaticks of K=4 and K=3 (the budget runs out inside one), against
    single steps with the kernels and on the plain paths: SpecEE with the
    draft's set and with an oracle set that forces exits (threshold -0.1)
    on dense and paged caches, tree on the paged cache, dense decoding;
    tokens, per-tick exit points and accept lengths, and units_run must be
    identical, and the path's kernels must launch inside the megaticks.
    Then ServingEngine(megatick=4) (async) against the per-tick blocking
    engine: 8 requests through 4 slots, SpecEE (both sets) and tree."""
    import numpy as np
    from repro_torch import kernels as K
    from repro_torch.api import DenseStrategy, Engine, SpecEEStrategy
    from repro_torch.models.model import ModelFlags, build_model
    run = llama(4, "float32")
    m_plain = build_model(run, ModelFlags(exit_gate_impl="ref"))
    m_ker = build_model(run, ModelFlags(**ALL_KERNELS))
    m_tree = build_model(run, ModelFlags(**TREE_KERNELS))
    prompts = np.random.default_rng(9).integers(0, V, (B, 16))

    def stream(model, strategy, cache, ticks):
        s = Engine.create(model, params, sw,
                          strategy=strategy).new_session(cache=cache)
        first = s.prefill(prompts, max_new_tokens=8)
        toks = [first.row_tokens(b) for b in range(B)]
        stats = [[] for _ in range(B)]
        units = 0
        while not s.all_done():
            r = s.step(num_ticks=ticks)
            units += int(r.units_run)
            for b in range(B):
                toks[b] += r.row_tokens(b)
                stats[b] += list(zip(r.row_exit_points(b),
                                     r.row_accept_lens(b)))
        return toks, stats, units

    dec = ("decode_attention", "paged_decode_attention")
    cells = (
        ("SpecEE draft set, dense", m_ker, SpecEEStrategy(threshold=-0.1),
         "dense", ("exit_gate", "argmax_verify", "topk_verify", dec[0])),
        ("SpecEE draft set, paged", m_ker, SpecEEStrategy(threshold=-0.1),
         "paged", ("exit_gate", "argmax_verify", "topk_verify", dec[1])),
        ("SpecEE oracle set, paged", m_ker, oracle_strategy(-0.1), "paged",
         ("exit_gate", "argmax_verify", "topk_verify", dec[1])),
        # tree attention is plain SDPA over the gathered view
        ("tree, paged", m_tree, tree_strategy(0.4), "paged",
         ("spec_head_gather", "spec_head", "predictor_mlp",
          "argmax_verify")),
        ("dense, dense", m_ker, DenseStrategy(), "dense",
         ("argmax_verify", dec[0])))
    for label, m, strat, cache, path in cells:
        want = stream(m_plain, strat, cache, None)
        require(stream(m, strat, cache, None) == want,
                f"megatick parity, {label}: single steps with kernels vs "
                "plain differ")
        notes = []
        for ticks in (MEGA_K, 3):
            K.reset_launches()
            got = stream(m, strat, cache, ticks)
            missing = [k for k in path if K.LAUNCHES[k] == 0]
            require(got == want, f"megatick parity, {label}, K={ticks}: "
                    f"{got} vs single steps {want}")
            require(not missing, f"megatick parity, {label}, K={ticks}: "
                    f"kernels not launched: {missing}")
            notes.append(f"K={ticks}")
        exits = sum(e < m.num_exit_points for row in want[1] for e, _ in row)
        require(not label.startswith("SpecEE oracle") or exits > 0,
                "the oracle set forced no exit under megaticks")
        log("parity", f"megaticks, {label}: {' and '.join(notes)} identical "
            f"to single steps with kernels and plain (tokens, per-tick exit "
            f"points and accept lengths, units_run {want[2]}; {exits} exits "
            f"of {sum(len(r) for r in want[1])} row ticks)")

    srun = llama(4, "float32", max_batch=4, max_seq_len=512, page_size=PAGE)
    s_ker = build_model(srun, ModelFlags(**ALL_KERNELS))
    s_tree = build_model(srun, ModelFlags(**TREE_KERNELS))
    rng = np.random.default_rng(10)
    sprompts = [rng.integers(0, V, int(n)) for n in rng.integers(20, 201, 8)]
    ar_path = ("exit_gate", "argmax_verify", "paged_decode_attention")
    for label, m, strat, path in (
            ("SpecEE draft set", s_ker, SpecEEStrategy(threshold=-0.1),
             ar_path),
            ("SpecEE oracle set", s_ker, oracle_strategy(-0.1), ar_path),
            ("tree", s_tree, tree_strategy(0.4),
             ("spec_head_gather", "spec_head", "argmax_verify"))):
        want = _serve(m, params, sw, sprompts, 8, accept=True,
                      strategy=strat, cache="paged", prefill_chunk=0)
        K.reset_launches()
        got = _serve(m, params, sw, sprompts, 8, accept=True,
                     strategy=strat, cache="paged", prefill_chunk=0,
                     megatick=MEGA_K)
        missing = [k for k in path if K.LAUNCHES[k] == 0]
        require(not missing, f"megatick serving ({label}): kernels not "
                f"launched: {missing}")
        require(got == want, f"megatick serving ({label}) differs from the "
                "blocking per-tick engine")
        exits = sum(e < m.num_exit_points for _, eps, _ in want for e in eps)
        log("parity", f"megatick serving, {label}: ServingEngine(megatick="
            f"{MEGA_K}) (async) equals the per-tick engine on 8 requests "
            f"through 4 slots (tokens, exit points, accept lengths; {exits} "
            f"exits); every page returned")


def _serve(model, params, sw, prompts, new_tokens, accept=False, **kw):
    from repro_torch.serving import ServingEngine
    se = ServingEngine(model, params, sw, **kw)
    reqs = [se.submit(p, max_new_tokens=new_tokens) for p in prompts]
    se.run_to_completion()
    mgr = se.session.cache_mgr
    require(mgr.free_pages == getattr(mgr, "num_pages", 0),
            f"{mgr.free_pages} pages free after serving, expected all")
    if accept:
        return [(r.output, r.exit_points, r.accept_lens) for r in reqs]
    return [(r.output, r.exit_points) for r in reqs]


def top2_margin(torch, model, params, tokens):
    """(top-2 logit margin, top logit) of the plain model's next token
    after ``tokens`` (the ROADMAP parity rule: a flipped token is reported
    with its margin, not hidden behind a looser check)."""
    logits, _, _ = model.prefill(
        params, {"tokens": torch.as_tensor([tokens], device=params[
            "embed"]["tok"].device)})
    top = torch.topk(logits[0].float(), 2).values
    return float(top[0] - top[1]), float(top[0])


def oracle_strategy(threshold: float):
    """SpecEE with an oracle speculative set, so that rows really exit and
    the skipped layers' K/V is propagated (through the page table on a
    paged cache) and read back by later ticks. The set is the plain
    full-head argmax after unit 1, got by running units 0 and 1 ahead of
    the step (they write the same K/V the step then writes again); on
    every third position a row gets a set that misses it instead, so it
    runs to full depth."""
    import dataclasses
    import torch
    from repro_torch.api import SpecEEStrategy
    from repro_torch.api.strategies import _single_token_result
    from repro_torch.core import engine as eng
    from repro_torch.kernels.exit_gate import ref as gref
    from repro_torch.models.common import lm_head_weight

    @dataclasses.dataclass(frozen=True)
    class OracleSpecEE(SpecEEStrategy):
        def step(self, model, params, sw, state, qw=None):
            pos = state.cache["len"]
            pages = state.cache.get("page_table")
            h = model.embed(params, state.last_token[:, None])[:, 0, :]
            # running ahead rewrites the same K/V, but would advance an
            # SSD state twice: per-row state entries run on a copy
            seg = {k: ({n: x.clone() for n, x in e.items()}
                       if "state" in e else e)
                   for k, e in state.cache["segments"][0].items()}
            for u in range(2):
                h, seg = model.run_unit(params, 0, u, h, seg, pos,
                                        pages=pages)
            # the plain argmax of the head the verify reads (a quantized
            # head's dequantized copy under ``qw``)
            head = (qw["lm_head"] if qw and qw.get("lm_head") is not None
                    else lm_head_weight(params))
            hit = gref.verify_argmax_ref(model.final_norm(params, h), head,
                                         compute_dtype=h.dtype)[0]
            miss = (hit + 1) % model.cfg.vocab_size
            ids = torch.where(pos % 3 == 0, miss, hit)
            token, new_state, info = eng.ar_decode_step(
                model, params, sw, state, threshold=self.threshold,
                spec_ids_override=ids[:, None].expand(-1, K_SPEC), qw=qw)
            return _single_token_result(token, info), new_state

    return OracleSpecEE(threshold=threshold)


def serving_parity(torch, dev, params, sw):
    """ServingEngine with every kernel vs ServingEngine on the plain paths
    (flags off, reference gate, dense cache — on the card a paged cache
    always takes the paged kernel): 8 requests with prompts of 20-200
    tokens through 4 slots of 512 tokens, so slots are reused; blocking and
    64-token chunked admission. Threshold -0.1 sends every active exit
    point through the verify; with the draft's own set no row exits, so
    the check is run again with an oracle set that forces exits (and must
    give some)."""
    import numpy as np
    from repro_torch.api import SpecEEStrategy
    from repro_torch.models.model import ModelFlags, build_model
    run = llama(4, "float32", max_batch=4, max_seq_len=512, page_size=PAGE)
    m_ker = build_model(run, ModelFlags(**ALL_KERNELS))
    m_plain = build_model(run, ModelFlags(exit_gate_impl="ref"))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, V, int(n)) for n in rng.integers(20, 201, 8)]
    cells = (("kernels, paged, blocking", m_ker, True, "paged", 0),
             ("kernels, paged, chunked", m_ker, True, "paged", 64),
             ("kernels, dense, blocking", m_ker, True, "dense", 0),
             ("plain, dense, chunked", m_plain, False, "dense", 64))
    for set_name, strat in (("draft", SpecEEStrategy(threshold=-0.1)),
                            ("oracle", oracle_strategy(-0.1))):
        want = _serve(m_plain, params, sw, prompts, 8, strategy=strat,
                      fused_gate=False, cache="dense", prefill_chunk=0)
        for label, m, fused, cache, chunk in cells:
            label = f"{set_name} set, {label}"
            got = _serve(m, params, sw, prompts, 8, strategy=strat,
                         fused_gate=fused, cache=cache, prefill_chunk=chunk)
            for i, ((out, eps), (out_w, eps_w)) in enumerate(zip(got, want)):
                if out != out_w:
                    j = next(j for j, (a, b) in enumerate(zip(out, out_w))
                             if a != b)
                    margin, _ = top2_margin(torch, m_plain, params,
                                            list(prompts[i]) + out_w[:j])
                    raise AssertionError(
                        f"serving parity ({label}): request {i} token {j} "
                        f"is {out[j]}, plain dense blocking gives "
                        f"{out_w[j]}; top-2 logit margin there {margin:.3g}")
                require(eps == eps_w, f"serving parity ({label}): request "
                        f"{i} exit points {eps} vs {eps_w}")
        exits = sum(e < m_ker.num_exit_points for _, eps in want for e in eps)
        require(set_name == "draft" or exits > 0,
                "the oracle set forced no exit in serving")
        log("parity", f"serving, {set_name} set: 8 requests through 4 "
            f"slots, per-request tokens and exit points identical for "
            f"{len(cells)} kernel/cache/admission cells and the plain dense "
            f"blocking run ({exits} exits of "
            f"{sum(len(e) for _, e in want)} ticks); every page returned")


def tree_strategy(threshold=None):
    from repro_torch.api import TreeStrategy
    from repro_torch.core.tree import TreeSpec
    return TreeStrategy(tree=TreeSpec(TREE_DEPTH, TREE_BRANCH),
                        threshold=threshold)


def tree_parity(torch, dev, params, sw):
    """T3 tree decoding at full width, 4 layers, fp32: every kernel on
    against the plain paths on dense and paged caches at thresholds 1.5,
    0.4 and -0.1; an oracle tree whose first chain is dense greedy; tree
    serving on the paged cache against plain tree serving."""
    import numpy as np
    from repro_torch import kernels as K
    from repro_torch.api import DenseStrategy, Engine
    from repro_torch.core import engine as eng
    from repro_torch.models.model import ModelFlags, build_model
    run = llama(4, "float32")
    m_plain = build_model(run)
    m_ker = build_model(run, ModelFlags(**TREE_KERNELS))
    prompts = np.random.default_rng(5).integers(0, V, (B, 16))
    new = 12

    def summary(results):
        return [(r.tokens.tolist(), r.counts.tolist(), r.accept_len.tolist(),
                 r.exit_layer.tolist(), r.exited.tolist(), r.units_run)
                for r in results]

    def stream(results):
        return [sum((r.row_tokens(b) for r in results), [])
                for b in range(B)]

    # 16 dense tokens: the first 12 are the no-exit reference, all 16 the
    # oracle's chains (3 steps of depth + 1)
    dense = drive(m_plain, params, sw, DenseStrategy(), prompts, 16)
    greedy = [row[:new] for row in stream(dense)]
    for cache in ("dense", "paged"):
        for thresh in (1.5, 0.4, -0.1):
            K.reset_launches()
            a = drive(m_ker, params, sw, tree_strategy(thresh), prompts, new,
                      cache=cache)
            launched = {k: K.LAUNCHES[k] for k in
                        ("spec_head_gather", "spec_head", "predictor_mlp",
                         "argmax_verify")}
            b = drive(m_plain, params, sw, tree_strategy(thresh), prompts,
                      new, cache=cache)
            require(summary(a) == summary(b), f"tree: kernel vs plain run "
                    f"differs ({cache} cache, threshold {thresh})")
            require(all(launched.values()), f"tree kernels not launched: "
                    f"{launched}")
            # the node columns are gathered once per step, at most
            require(launched["spec_head_gather"] <= len(a) - 1
                    <= launched["spec_head"], f"tree: {launched} in "
                    f"{len(a) - 1} steps")
            exits = sum(int(r.exited.sum()) for r in a[1:])
            if thresh > 1:
                require(stream(a) == greedy, f"tree at threshold "
                        f"{thresh} differs from dense greedy ({cache})")
            if thresh < 0:
                require(exits > 0, "threshold -0.1 forced no exit")
            log("parity", f"tree {cache} cache, threshold {thresh}: "
                f"{len(a) - 1} steps, tokens/accept lengths/exit points "
                f"identical with kernels and plain versions ({exits} exits; "
                + ("equals dense greedy; " if thresh > 1 else "")
                + "launches " + ", ".join(f"{k} {v}"
                                          for k, v in launched.items()) + ")")

    # oracle: the first chain of every tree follows dense greedy decoding,
    # so each step accepts `depth` draft tokens + the bonus
    tree = tree_strategy().tree
    ref = np.stack([np.concatenate([r.tokens[b, :r.counts[b]]
                                    for r in dense]) for b in range(B)])
    chain = [tree.level_offsets[d] for d in range(1, tree.depth + 1)]
    for cache in ("dense", "paged"):
        outs = []
        for m in (m_ker, m_plain):
            s = Engine.create(m, params, sw,
                              strategy=tree_strategy()).new_session(
                                  cache=cache)
            s.prefill(prompts, max_seq=64)
            st = s._state
            ptr, got = 1, []
            for step in range(3):
                toks = np.random.default_rng(step).integers(
                    0, V, (B, tree.num_nodes)).astype(np.int32)
                toks[:, chain] = ref[:, ptr:ptr + tree.depth]
                out, n, st, info = eng.tree_decode_step(
                    m, params, sw, st, tree, threshold=1.5,
                    node_tokens_override=torch.as_tensor(toks, device=dev))
                require(info.accepted_len.tolist() == [tree.depth] * B,
                        f"oracle accepted {info.accepted_len.tolist()}")
                require(np.array_equal(out.cpu().numpy(),
                                       ref[:, ptr:ptr + tree.depth + 1]),
                        "oracle tree tokens differ from dense greedy")
                ptr += tree.depth + 1
                got.append(out.tolist())
            outs.append(got)
        require(outs[0] == outs[1], f"oracle tree: kernels vs plain differ "
                f"({cache})")
        log("parity", f"tree oracle, {cache} cache: 3 steps, accepted "
            f"length {tree.depth} every step, {3 * (tree.depth + 1)} tokens "
            "per row equal dense greedy, with kernels and plain versions")

    # tree serving: 8 requests through 4 slots, paged kernels vs plain
    srun = llama(4, "float32", max_batch=4, max_seq_len=512, page_size=PAGE)
    s_ker = build_model(srun, ModelFlags(**TREE_KERNELS))
    s_plain = build_model(srun, ModelFlags(exit_gate_impl="ref"))
    rng = np.random.default_rng(6)
    sprompts = [rng.integers(0, V, int(n)) for n in rng.integers(20, 201, 8)]
    strat = tree_strategy(0.4)
    K.reset_launches()
    got = _serve(s_ker, params, sw, sprompts, 8, strategy=strat,
                 fused_gate=True, cache="paged", prefill_chunk=0,
                 accept=True)
    launched = dict(K.LAUNCHES)
    want = _serve(s_plain, params, sw, sprompts, 8, strategy=strat,
                  fused_gate=False, cache="dense", prefill_chunk=0,
                  accept=True)
    require(got == want, "tree serving: kernels (paged) vs plain (dense) "
            "differ in tokens, exit points or accept lengths")
    missing = [k for k in ("spec_head_gather", "spec_head", "predictor_mlp",
                           "argmax_verify", "flash_attention")
               if launched[k] == 0]
    require(not missing, f"tree serving never launched {missing}")
    exits = sum(e < s_ker.num_exit_points for _, eps, _ in want for e in eps)
    log("parity", f"tree serving: 8 requests through 4 slots, per-request "
        f"tokens, exit points and accept lengths identical, paged kernels "
        f"vs plain dense ({exits} exits of {sum(len(e) for _, e, _ in want)}"
        f" ticks); every page returned")


def quant_parity(torch, dev, params, sw):
    """Weight-only quantization at full width, 4 layers, fp32:
    Engine.create(quant=...) with every kernel against the plain paths —
    AR SpecEE (the draft's set at threshold -0.1, and an oracle set that
    forces exits), dense decoding and tree decoding (thresholds 1.5, which
    must equal quantized dense greedy, and -0.1), int8 on the dense cache
    and int4 on the paged one, and a quantized ServingEngine (paged kernels vs plain dense,
    blocking and chunked admission, oracle set); then the quantized engine
    against the plain engine on ``dequantized_reference``. Every kernel run
    must launch the quantized kernels and none of the fp gate kernels."""
    import numpy as np
    from repro_torch import kernels as K
    from repro_torch import quant
    from repro_torch.api import DenseStrategy, SpecEEStrategy
    from repro_torch.models.model import ModelFlags, build_model
    run = llama(4, "float32")
    m_plain = build_model(run)
    m_ker = build_model(run, ModelFlags(**TREE_KERNELS))
    prompts = np.random.default_rng(7).integers(0, V, (B, 16))

    def summary(results):
        return [(r.tokens.tolist(), r.counts.tolist(), r.accept_len.tolist(),
                 r.exit_layer.tolist(), r.exited.tolist(), r.units_run)
                for r in results]

    def both(strategy, spec, cache, new=9):
        K.reset_launches()
        a = drive(m_ker, params, sw, strategy, prompts, new, cache=cache,
                  quant=spec)
        launched = dict(K.LAUNCHES)
        b = drive(m_plain, params, sw, strategy, prompts, new, cache=cache,
                  quant=spec)
        require(summary(a) == summary(b), f"quant {spec}: kernel vs plain "
                f"differs ({strategy}, {cache} cache)")
        fp = [k for k in FP_GATE_KERNELS + FP_SPEC_HEAD if launched[k]]
        require(not fp, f"quant {spec}: fp gate kernels launched {fp}")
        require(launched["argmax_verify_q"] > 0, "argmax_verify_q idle")
        return a, launched

    # int8 on the dense cache, int4 on the paged one: quantization changes
    # the weights, the cache layout only the attention
    for spec, cache in (("int8", "dense"), ("int4", "paged")):
        notes = []
        for label, strat in (("draft", SpecEEStrategy(threshold=-0.1)),
                             ("oracle", oracle_strategy(-0.1))):
            a, launched = both(strat, spec, cache)
            exits = sum(int(r.exited.sum()) for r in a[1:])
            require(label == "draft" or exits > 0,
                    f"quant {spec}: the oracle set forced no exit")
            missing = [k for k in quantized(FP_GATE_KERNELS)
                       if not launched[k]]
            require(not missing, f"quant {spec} AR never launched "
                    f"{missing}")
            pieces = [k for k in PIECEWISE_Q if launched[k]]
            require(not pieces, f"quant {spec} AR launched the piecewise "
                    f"gate's {pieces}")
            notes.append(f"AR {label} {cache} ({exits} exits)")
        dense, _ = both(DenseStrategy(), spec, cache)
        notes.append(f"dense {cache}")
        greedy = [r.tokens[:, 0].tolist() for r in dense]
        for thresh in (1.5, -0.1):
            a, launched = both(tree_strategy(thresh), spec, cache, new=12)
            # the node tokens' code columns gathered once per step, at most
            require(0 < launched["spec_head_gather_q"] <= len(a) - 1
                    <= launched["spec_head_q"], f"quant {spec} tree: "
                    f"{launched} in {len(a) - 1} steps")
            if thresh > 1:
                rows = [sum((r.row_tokens(b) for r in a), [])[:9]
                        for b in range(B)]
                require(rows == [list(t) for t in zip(*greedy)],
                        f"quant {spec} tree at 1.5 differs from "
                        f"quantized dense greedy ({cache})")
            exits = sum(int(r.exited.sum()) for r in a[1:])
            require(thresh > 1 or exits > 0,
                    "quant tree at -0.1 forced no exit")
            notes.append(f"tree {thresh} {cache} ({exits} exits)")
        log("parity", f"quant {spec}: kernels equal plain versions for "
            + "; ".join(notes) + "; no fp gate kernel launched")

    # quantized serving: 8 requests through 4 slots, oracle set
    srun = llama(4, "float32", max_batch=4, max_seq_len=512, page_size=PAGE)
    s_ker = build_model(srun, ModelFlags(**ALL_KERNELS))
    s_plain = build_model(srun, ModelFlags(exit_gate_impl="ref"))
    rng = np.random.default_rng(8)
    sprompts = [rng.integers(0, V, int(n)) for n in rng.integers(20, 201, 8)]
    strat = oracle_strategy(-0.1)
    want = _serve(s_plain, params, sw, sprompts, 8, strategy=strat,
                  fused_gate=False, cache="dense", prefill_chunk=0,
                  quant="int4")
    for chunk in (0, 64):
        K.reset_launches()
        got = _serve(s_ker, params, sw, sprompts, 8, strategy=strat,
                     fused_gate=True, cache="paged", prefill_chunk=chunk,
                     quant="int4")
        require(got == want, f"quant serving (int4, chunk {chunk}): paged "
                "kernels vs plain dense differ")
        fp = [k for k in FP_GATE_KERNELS + FP_SPEC_HEAD if K.LAUNCHES[k]]
        require(not fp, f"quant serving launched fp gate kernels {fp}")
    exits = sum(e < s_ker.num_exit_points for _, eps in want for e in eps)
    require(exits > 0, "quant serving: the oracle set forced no exit")
    log("parity", f"quant serving int4: 8 requests through 4 slots, paged "
        f"kernels (blocking and 64-token chunks) equal plain dense "
        f"({exits} exits); every page returned")

    # the contract of the JAX package's quant parity test
    for spec in ("int8", "int4"):
        from repro_torch.api import Engine
        e = Engine.create(m_ker, params, sw, quant=spec)
        pv, sv = quant.dequantized_reference(params, sw, e.qw)
        for strat in (SpecEEStrategy(threshold=-0.1), DenseStrategy()):
            a = drive(m_ker, params, sw, strat, prompts, 9, cache="paged",
                      quant=spec)
            b = drive(m_ker, pv, sv, strat, prompts, 9, cache="paged")
            require(summary(a) == summary(b), f"quant {spec}: engine vs "
                    f"plain engine on the dequantized reference differ "
                    f"({strat.name})")
        del e, pv, sv
    log("parity", "quant int8/int4: the quantized engine equals the plain "
        "engine on dequantized_reference (specee and dense, paged cache)")


def kvq_parity(torch, dev, params, sw):
    """The int8 KV cache (``ModelFlags(kv_quant=True)``) at full width, 4
    layers, fp32, kernels against plain versions: AR SpecEE on the dense
    cache (the dense kernel on the dequantized view) and the paged one (the
    int8 paged kernel) at thresholds 1.5, 0.4 and -0.1 and with an oracle
    set that forces exits, so propagated codes and scales are read back;
    then ``ServingEngine`` (paged kernels vs plain dense) with blocking and
    64-token chunked admission, each against the plain run of the same
    admission mode (the two modes differ by design under kv_quant), with
    the draft's set and the oracle set; then the same with quant="int8"."""
    import numpy as np
    from repro_torch import kernels as K
    from repro_torch.api import SpecEEStrategy
    from repro_torch.models.model import ModelFlags, build_model
    run = llama(4, "float32")
    m_plain = build_model(run, ModelFlags(kv_quant=True))
    m_ker = build_model(run, ModelFlags(exit_gate_kernel=True,
                                        exit_gate_impl="kernel",
                                        decode_kernel=True, kv_quant=True))
    prompts = np.random.default_rng(9).integers(0, V, (B, 16))

    def summary(results):
        return [(r.tokens.tolist(), r.exit_layer.tolist(), r.exited.tolist(),
                 r.units_run) for r in results]

    attn = {"dense": "decode_attention", "paged": "paged_decode_attention_q"}
    for cache in ("dense", "paged"):
        notes = []
        for label, strat in (("1.5", SpecEEStrategy(threshold=1.5)),
                             ("0.4", SpecEEStrategy(threshold=0.4)),
                             ("-0.1", SpecEEStrategy(threshold=-0.1)),
                             ("oracle -0.1", oracle_strategy(-0.1))):
            K.reset_launches()
            a = summary(drive(m_ker, params, sw, strat, prompts, 9,
                              cache=cache))
            launched = dict(K.LAUNCHES)
            b = summary(drive(m_plain, params, sw, strat, prompts, 9,
                              cache=cache))
            require(a == b, f"kv_quant AR ({cache}, {label}): kernel vs "
                    "plain differs")
            require(launched[attn[cache]] > 0
                    and launched["paged_decode_attention"] == 0,
                    f"kv_quant AR ({cache}): attention launches {launched}")
            exits = sum(sum(x) for _, _, x, _ in a[1:])
            require(not label.startswith("oracle") or exits > 0,
                    f"kv_quant AR ({cache}): the oracle set forced no exit")
            notes.append(f"{label} ({exits} exits)")
        log("parity", f"kv_quant AR, {cache} cache: tokens/exit points/"
            f"exits identical with kernels ({attn[cache]}) and plain "
            "versions at " + ", ".join(notes))

    srun = llama(4, "float32", max_batch=4, max_seq_len=512, page_size=PAGE)
    s_ker = build_model(srun, ModelFlags(**ALL_KERNELS, kv_quant=True))
    s_plain = build_model(srun, ModelFlags(exit_gate_impl="ref",
                                           kv_quant=True))
    rng = np.random.default_rng(10)
    sprompts = [rng.integers(0, V, int(n)) for n in rng.integers(20, 201, 8)]
    for spec in (None, "int8"):
        notes = []
        sets = ((("draft", SpecEEStrategy(threshold=-0.1)),)
                if spec is None else ()) + (("oracle", oracle_strategy(-0.1)),)
        for set_name, strat in sets:
            for chunk in (0, 64):
                want = _serve(s_plain, params, sw, sprompts, 8,
                              strategy=strat, fused_gate=False,
                              cache="dense", prefill_chunk=chunk, quant=spec)
                K.reset_launches()
                got = _serve(s_ker, params, sw, sprompts, 8, strategy=strat,
                             fused_gate=True, cache="paged",
                             prefill_chunk=chunk, quant=spec)
                require(got == want, f"kv_quant serving (quant {spec}, "
                        f"{set_name} set, chunk {chunk}): paged kernels vs "
                        "plain dense differ")
                require(K.LAUNCHES["paged_decode_attention_q"] > 0
                        and K.LAUNCHES["paged_decode_attention"] == 0,
                        "kv_quant serving: attention launches "
                        f"{dict(K.LAUNCHES)}")
                exits = sum(e < s_ker.num_exit_points
                            for _, eps in want for e in eps)
                require(set_name == "draft" or exits > 0,
                        "kv_quant serving: the oracle set forced no exit")
                notes.append(f"{set_name} set, chunk {chunk} ({exits} "
                             "exits)")
        log("parity", f"kv_quant serving{'' if spec is None else ' ' + spec}"
            ": 8 requests through 4 slots, paged kernels equal plain dense "
            "for " + "; ".join(notes) + "; every page returned")


def full_weights(torch, dev):
    """llama2-7b, 32 layers, bf16, seeded once on the card; phases 4 and 5
    share these weights."""
    from repro_torch.core import engine as eng
    from repro_torch.models.model import build_model
    model = build_model(llama(32, "bfloat16"))
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(7)
    params = model.init(gen, dev)
    sw = eng.init_specee(model, gen, dev)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    log("full", f"llama2-7b 32 layers bf16: {n_params / 1e9:.3f} B params "
        f"seeded on the card in {time.perf_counter() - t0:.1f} s")
    return params, sw


def full_run(torch, dev, params, sw):
    import numpy as np
    from repro_torch import kernels as K
    from repro_torch.api import DenseStrategy, Engine, SpecEEStrategy
    from repro_torch.models.model import ModelFlags, build_model
    run = llama(32, "bfloat16")
    model = build_model(run, ModelFlags(exit_gate_kernel=True,
                                        exit_gate_impl="kernel",
                                        decode_kernel=True))
    prompts = np.random.default_rng(1).integers(0, V, (B, FULL_PROMPT))
    torch.cuda.reset_peak_memory_stats()

    K.reset_launches()                     # ---- the main path ----
    session = Engine.create(model, params, sw,
                            strategy=SpecEEStrategy()).new_session()
    t0 = time.perf_counter()
    first = session.prefill(prompts, max_new_tokens=FULL_STEPS + 1)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    steps = []
    t0 = time.perf_counter()
    for _ in range(FULL_STEPS):
        steps.append(session.step())
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)            # ---- read right after ----

    require(session.all_done(), "session not done after the budget")
    toks = np.stack([r.tokens[:, 0] for r in [first] + steps], 1)
    require(toks.shape == (B, FULL_STEPS + 1), f"token shape {toks.shape}")
    require(((toks >= 0) & (toks < V)).all(), "token out of vocabulary")
    require(bool(torch.isfinite(session._state.h_last.float()).all()),
            "non-finite hidden state")
    exits = sum(int(r.exited.sum()) for r in steps)
    units = [r.units_run for r in steps]
    log("full", f"prefill {B}x{FULL_PROMPT} in {t_prefill:.3f} s; "
        f"{FULL_STEPS} steps in {t_decode:.3f} s = "
        f"{B * FULL_STEPS / t_decode:.2f} tokens/s "
        f"({t_decode / FULL_STEPS * 1e3:.2f} ms/step); exits per token "
        f"{exits / (B * FULL_STEPS):.4f}; mean units_run "
        f"{sum(units) / len(units):.2f} of {model.num_exit_points}; peak "
        f"card memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log("full", "launches: " + ", ".join(
        f"{k} {v} ({v / FULL_STEPS:.2f}/step)" for k, v in launches.items()))
    missing = [k for k in AR_PATH if launches[k] == 0]
    require(not missing, f"kernels never launched on the main path: "
            f"{missing}")
    if exits == 0:
        # no row exited, so SpecEE must emit dense greedy decoding's tokens
        dense = drive(model, params, sw, DenseStrategy(), prompts,
                      FULL_STEPS + 1)
        require(np.array_equal(np.stack([r.tokens[:, 0] for r in dense], 1),
                               toks), "full run differs from dense greedy")
        log("full", "no row exited: tokens equal dense greedy decoding")
    profile_steps(torch, model, params, sw, prompts, t_decode / FULL_STEPS)
    return launches, {"prompts": prompts, "steps": steps,
                      "t_decode": t_decode}


# ---------------------------------------------------------------------------
# phase 5: continuous-batching serving on the paged cache
# ---------------------------------------------------------------------------
def serve_prompts(vocab: int = V):
    import numpy as np
    rng = np.random.default_rng(11)
    lo, hi = SERVE_PROMPTS
    return [rng.integers(0, vocab, int(n))
            for n in rng.integers(lo, hi + 1, SERVE_REQS)]


def serve_engine(torch, params, sw, chunk, kv_quant=False):
    from repro_torch.models.model import ModelFlags, build_model
    from repro_torch.serving import ServingEngine
    run = llama(32, "bfloat16", max_batch=SERVE_BATCH,
                max_seq_len=SERVE_SEQ, page_size=PAGE)
    model = build_model(run, ModelFlags(**ALL_KERNELS, kv_quant=kv_quant))
    return ServingEngine(model, params, sw, cache="paged",
                         prefill_chunk=chunk)


def serve_run(torch, dev, params, sw, chunk: int, kv_quant: bool = False):
    """One serving run: 16 requests, blocking (chunk 0) or chunked
    admission, on bf16 or (``kv_quant``) int8 page pools. The launch counts
    are zeroed right before the requests are submitted and read right
    after the last one completes. Returns (launches, per-request (output,
    exit points), pool GB)."""
    import numpy as np
    from repro_torch import kernels as K
    label = ("kv_quant " if kv_quant else "") + (
        "blocking" if chunk == 0 else f"chunked {chunk}")
    phase = "kvq" if kv_quant else "serve"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    se = serve_engine(torch, params, sw, chunk, kv_quant)
    mgr = se.session.cache_mgr
    pool_gb = sum(x.numel() * x.element_size()
                  for x in _leaves(se.session._state.cache["segments"])) / 1e9
    weights_gb = sum(x.numel() * x.element_size()
                     for x in _leaves([params, sw])) / 1e9
    prompts = serve_prompts()
    prefill_s = [0.0]
    tick = se.scheduler.tick

    def timed_tick(*a, **kw):                # admission time, synced
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tick(*a, **kw)
        torch.cuda.synchronize()
        prefill_s[0] += time.perf_counter() - t0
        return out

    se.scheduler.tick = timed_tick
    seen, reused, ticks = set(), 0, 0
    K.reset_launches()                       # ---- the main path ----
    t0 = time.perf_counter()
    reqs = [se.submit(p, max_new_tokens=SERVE_NEW) for p in prompts]
    while se.busy:
        occupants = [r.uid if r is not None else None for r in se.slots]
        se.step()
        ticks += 1
        for slot, r in enumerate(se.slots):
            if r is not None and r.uid != occupants[slot]:
                reused += slot in seen
                seen.add(slot)
        if ticks > 10_000:
            raise AssertionError("serving did not finish in 10000 ticks")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)              # ---- read right after ----
    del se.scheduler.tick                    # the wrapper pins the engine

    require(all(r.done and len(r.output) == SERVE_NEW for r in reqs),
            "a request did not finish with its 32 tokens")
    require(all(0 <= t < V for r in reqs for t in r.output),
            "token out of vocabulary")
    require(mgr.free_pages == mgr.num_pages,
            f"{mgr.free_pages} of {mgr.num_pages} pages free at the end")
    require(bool(torch.isfinite(se.session._state.h_last.float()).all()),
            "non-finite hidden state")
    path = ((KVQ_SERVE_PATH if kv_quant else SERVE_PATH)
            + (("flash_attention",) if chunk == 0 else ()))
    missing = [k for k in path if launches[k] == 0]
    require(not missing, f"kernels never launched on the serving path "
            f"({label}): {missing}")
    require(launches["decode_attention"] == 0,
            "the dense decode kernel ran on the paged serving path")
    other = "paged_decode_attention" + ("" if kv_quant else "_q")
    require(launches[other] == 0, f"{other} ran on the {label} serving "
            "path")
    tokens = sum(len(r.output) for r in reqs)
    decode_ticks = sum(len(r.exit_points) for r in reqs)
    exits = sum(e < se.model.num_exit_points for r in reqs
                for e in r.exit_points)
    log(phase, f"{label}: {SERVE_REQS} requests (prompts "
        f"{min(map(len, prompts))}-{max(map(len, prompts))} tokens, "
        f"{SERVE_NEW} new each) through {SERVE_BATCH} slots in {wall:.3f} s "
        f"= {SERVE_REQS / wall:.3f} requests/s, {tokens / wall:.2f} tokens/s;"
        f" {ticks} ticks, {wall / ticks * 1e3:.2f} ms/tick "
        f"({(wall - prefill_s[0]) / ticks * 1e3:.2f} ms/tick without "
        f"admission); admission (prefill) {prefill_s[0]:.3f} s; exits per "
        f"token {exits / max(decode_ticks, 1):.4f}; admissions after "
        f"retirement {reused}; free pages at the end {mgr.free_pages} of "
        f"{mgr.num_pages}")
    cfg = se.model.cfg
    # one row's prefill cache holds SERVE_SEQ token slots of the pools'
    # layout
    row_gb = pool_gb * SERVE_SEQ / ((mgr.num_pages + 1) * PAGE)
    leaves = "codes + scales" if kv_quant else "K,V"
    log(phase, f"{label}: memory reckoned {weights_gb:.2f} GB weights + "
        f"{pool_gb:.2f} GB page pools ({mgr.num_pages + 1} pages of {PAGE} "
        f"tokens x {cfg.num_layers} layers x {leaves}) + {row_gb:.2f} GB "
        f"for one row's {SERVE_SEQ}-token prefill cache = "
        f"{weights_gb + pool_gb + row_gb:.2f} GB before activations; peak "
        f"card memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    log(phase, f"{label} launches: " + ", ".join(
        f"{k} {v} ({v / ticks:.2f}/tick)" for k, v in launches.items()))
    outs = [(r.output, r.exit_points) for r in reqs]
    del se
    return launches, outs, {"pool_gb": pool_gb, "wall": wall,
                            "ticks": ticks}


def profile_serving(torch, se, phase: str, n: int = 4) -> None:
    """torch.profiler over ``n`` steady ticks of the idle serving engine
    ``se`` (8 live rows, no admission): device time per kernel family per
    tick and the device's busy share of the profiled wall time."""
    for p in serve_prompts()[:SERVE_BATCH]:
        se.submit(p, max_new_tokens=n + 4)
    se.step()                                 # admits all 8, one tick
    se.step()
    torch.cuda.synchronize()
    profile_ticks(torch, phase, se.step, n)


def serve_phase(torch, dev, params, sw):
    """Phase 5. Returns the launches by path and, for phase 8, the
    per-request outputs of both runs and the bf16 pool size."""
    torch.cuda.empty_cache()
    l_block, out_block, stats = serve_run(torch, dev, params, sw, 0)
    torch.cuda.empty_cache()
    l_chunk, out_chunk, _ = serve_run(torch, dev, params, sw, 256)
    same = sum(a == b for (ra, _), (rb, _) in zip(out_block, out_chunk)
               for a, b in zip(ra, rb))
    log("serve", f"blocking vs chunked admission: {same} of "
        f"{SERVE_REQS * SERVE_NEW} tokens identical (bf16; the exact "
        f"parity of the two is phase 3's, in fp32)")
    flip_margins(torch, params, out_block, out_chunk, "serve",
                 "blocking and chunked admission")
    torch.cuda.empty_cache()
    profile_serving(torch, serve_engine(torch, params, sw, 0),
                    "profile-serve")
    return ({"serve_blocking": l_block, "serve_chunked": l_chunk},
            {"blocking": out_block, "chunked": out_chunk,
             "pool_gb": stats["pool_gb"], "blocking_stats": stats})


# ---------------------------------------------------------------------------
# phase 6: T3 tree decoding at full width
# ---------------------------------------------------------------------------
def _per_step(launches, n):
    return ", ".join(f"{k} {launches[k]} ({launches[k] / n:.2f}/step)"
                     for k in ("spec_head_gather", "spec_head",
                               "predictor_mlp", "argmax_verify"))


def tree_phase(torch, dev, params, sw):
    """Whole-batch tree session (B=4, prompt 128, 16 tree steps, dense
    cache), then tree serving on the paged cache (8 requests, 8 slots).
    Each zeroes the launch counts right before and reads them right
    after."""
    import numpy as np
    from repro_torch import kernels as K
    from repro_torch.api import Engine
    from repro_torch.models.model import ModelFlags, build_model
    from repro_torch.serving import ServingEngine
    model = build_model(llama(32, "bfloat16"), ModelFlags(**TREE_KERNELS))
    tree = tree_strategy().tree
    prompts = np.random.default_rng(1).integers(0, V, (B, FULL_PROMPT))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    K.reset_launches()                       # ---- the main path ----
    session = Engine.create(model, params, sw,
                            strategy=tree_strategy()).new_session()
    t0 = time.perf_counter()
    session.prefill(prompts,
                    max_new_tokens=(TREE_STEPS + 4) * (tree.depth + 1))
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    steps = [session.step() for _ in range(TREE_STEPS)]
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)              # ---- read right after ----

    require(all(((r.tokens >= 0) & (r.tokens < V)).all() for r in steps),
            "tree token out of vocabulary")
    require(all((r.counts >= 1).all() for r in steps), "a row emitted none")
    require(bool(torch.isfinite(session._state.h_last.float()).all()),
            "non-finite hidden state")
    missing = [k for k in TREE_PATH if launches[k] == 0]
    require(not missing, f"kernels never launched on the tree path: "
            f"{missing}")
    tokens = sum(int(r.counts.sum()) for r in steps)
    accept = np.mean([r.accept_len for r in steps])
    exits = sum(int(r.exited.sum()) for r in steps)
    units = np.mean([r.units_run for r in steps])
    log("tree", f"whole batch, TreeSpec({tree.depth}, {tree.branch}) "
        f"({tree.num_nodes} nodes, {len(tree.path_nodes)} paths): prefill "
        f"{B}x{FULL_PROMPT} in {t_prefill:.3f} s; {TREE_STEPS} tree steps in "
        f"{t_decode:.3f} s = {t_decode / TREE_STEPS * 1e3:.2f} ms/step, "
        f"{tokens} tokens = {tokens / t_decode:.2f} tokens/s; mean accepted "
        f"length {accept:.3f} (random draft weights: ~0 expected); exits "
        f"per step {exits / TREE_STEPS:.2f} of {B} rows; mean units_run "
        f"{units:.2f} of {model.num_exit_points}; peak card memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log("tree", "whole batch launches: " + _per_step(launches, TREE_STEPS))
    profile_ticks(torch, "profile-tree", session.step, 3,
                  f" ({t_decode / TREE_STEPS * 1e3:.2f} unprofiled)")
    del session
    torch.cuda.empty_cache()

    srun = llama(32, "bfloat16", max_batch=SERVE_BATCH,
                 max_seq_len=SERVE_SEQ, page_size=PAGE)
    se = ServingEngine(build_model(srun, ModelFlags(**TREE_KERNELS)), params,
                       sw, strategy=tree_strategy(), cache="paged",
                       prefill_chunk=0)
    mgr = se.session.cache_mgr
    sprompts = serve_prompts()[:TREE_SERVE_REQS]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tick_s = []
    K.reset_launches()                       # ---- the main path ----
    t0 = time.perf_counter()
    reqs = [se.submit(p, max_new_tokens=SERVE_NEW) for p in sprompts]
    while se.busy:
        t1 = time.perf_counter()
        se.step()
        torch.cuda.synchronize()
        tick_s.append(time.perf_counter() - t1)
        require(len(tick_s) <= 10_000, "tree serving did not finish")
    wall = time.perf_counter() - t0
    ticks = len(tick_s)
    s_launches = dict(K.LAUNCHES)            # ---- read right after ----

    require(all(r.done and len(r.output) == SERVE_NEW for r in reqs),
            "a tree request did not finish with its 32 tokens")
    require(all(0 <= t < V for r in reqs for t in r.output),
            "token out of vocabulary")
    require(mgr.free_pages == mgr.num_pages,
            f"{mgr.free_pages} of {mgr.num_pages} pages free at the end")
    missing = [k for k in TREE_PATH if s_launches[k] == 0]
    require(not missing, f"kernels never launched on the tree serving "
            f"path: {missing}")
    row_ticks = sum(len(r.accept_lens) for r in reqs)
    exits = sum(e < se.model.num_exit_points for r in reqs
                for e in r.exit_points)
    log("tree", f"serve: {TREE_SERVE_REQS} requests (prompts "
        f"{min(map(len, sprompts))}-{max(map(len, sprompts))} tokens, "
        f"{SERVE_NEW} new each) through {SERVE_BATCH} slots of "
        f"{mgr.pages_per_row} pages in {wall:.3f} s = "
        f"{TREE_SERVE_REQS / wall:.3f} requests/s, "
        f"{TREE_SERVE_REQS * SERVE_NEW / wall:.2f} tokens/s; {ticks} ticks, "
        f"{wall / ticks * 1e3:.2f} ms/tick (median "
        f"{sorted(tick_s)[ticks // 2] * 1e3:.2f}, first tick, with the "
        f"admissions, {tick_s[0] * 1e3:.2f}); mean accepted length "
        f"{sum(sum(r.accept_lens) for r in reqs) / row_ticks:.3f}; exits per "
        f"row tick {exits / row_ticks:.4f}; peak card memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; free pages at "
        f"the end {mgr.free_pages} of {mgr.num_pages}")
    log("tree", "serve launches: " + _per_step(s_launches, ticks)
        .replace("/step", "/tick"))
    for p in sprompts:                       # 8 live rows, no admission
        se.submit(p, max_new_tokens=8)
    se.step()
    se.step()
    torch.cuda.synchronize()
    profile_ticks(torch, "profile-tree-serve", se.step, 3)
    del se
    return ({"tree_whole_batch": launches, "tree_serve": s_launches},
            {"prompts": prompts, "steps": steps, "t_decode": t_decode})


# ---------------------------------------------------------------------------
# phase 7: weight-only quantized decode at full width
# ---------------------------------------------------------------------------
def _require_quant_path(launches, path, label):
    """Each kernel of the quantized ``path`` launched, no fp gate kernel,
    and neither piece of the piecewise gate off the tree path."""
    want = quantized(path)
    missing = [k for k in want if launches[k] == 0]
    require(not missing, f"{label}: kernels never launched {missing}")
    fp = [k for k in FP_GATE_KERNELS + FP_SPEC_HEAD if launches[k]]
    require(not fp, f"{label}: fp gate kernels launched {fp}")
    pieces = [k for k in PIECEWISE_Q if launches[k] and k not in want]
    require(not pieces, f"{label}: the piecewise gate's {pieces} launched")


def quant_phase(torch, dev, params, sw):
    """Engine.create(quant="int8"), then "int4", on the phase-4 weights:
    whole-batch AR (B=4, prompt 128, 32 steps, dense cache; int8 then
    profiled over 3 more steps) and a whole-batch tree run (4 steps, then
    profiled over 3 more); then
    ServingEngine(quant="int8", cache="paged") serving the first 8 serve
    prompts, profiled over 4 more ticks. Each run zeroes the launch counts
    right before and reads them right after; each engine is freed before
    the next is built."""
    import numpy as np
    from repro_torch import kernels as K
    from repro_torch.api import DenseStrategy, Engine, SpecEEStrategy
    from repro_torch.models.model import ModelFlags, build_model
    model = build_model(llama(32, "bfloat16"), ModelFlags(**TREE_KERNELS))
    prompts = np.random.default_rng(1).integers(0, V, (B, FULL_PROMPT))
    by_path = {}
    for spec in ("int8", "int4"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        engine = Engine.create(model, params, sw, strategy=SpecEEStrategy(),
                               quant=spec)
        engine.prefill_weights()             # the dequantized view, once
        torch.cuda.synchronize()
        t_quant = time.perf_counter() - t0
        code_gb = sum(x.nbytes() if hasattr(x, "bits") else
                      x.numel() * x.element_size()
                      for x in _leaves(engine.qw) if x is not None) / 1e9

        K.reset_launches()                   # ---- the main path ----
        session = engine.new_session()
        t0 = time.perf_counter()
        first = session.prefill(prompts, max_new_tokens=FULL_STEPS + 1)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        t0 = time.perf_counter()
        steps = [session.step() for _ in range(FULL_STEPS)]
        torch.cuda.synchronize()
        t_decode = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)          # ---- read right after ----

        toks = np.stack([r.tokens[:, 0] for r in [first] + steps], 1)
        require(toks.shape == (B, FULL_STEPS + 1), f"token shape "
                f"{toks.shape}")
        require(((toks >= 0) & (toks < V)).all(), "token out of vocabulary")
        require(bool(torch.isfinite(session._state.h_last.float()).all()),
                "non-finite hidden state")
        _require_quant_path(launches, AR_PATH, f"quant {spec} AR")
        exits = sum(int(r.exited.sum()) for r in steps)
        units = np.mean([r.units_run for r in steps])
        log("quant", f"{spec}: quantized in {t_quant:.2f} s ({code_gb:.2f} "
            f"GB of codes and scales); prefill {B}x{FULL_PROMPT} in "
            f"{t_prefill:.3f} s; {FULL_STEPS} steps in {t_decode:.3f} s = "
            f"{B * FULL_STEPS / t_decode:.2f} tokens/s "
            f"({t_decode / FULL_STEPS * 1e3:.2f} ms/step); exits per token "
            f"{exits / (B * FULL_STEPS):.4f}; mean units_run {units:.2f}; "
            f"peak card memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
            f" GB")
        log("quant", f"{spec} AR launches: " + ", ".join(
            f"{k} {launches[k]} ({launches[k] / FULL_STEPS:.2f}/step)"
            for k in QUANT_KERNELS + FP_GATE_KERNELS))
        if exits == 0:
            # no row exited: the quantized dense strategy gives the tokens
            dense = Engine.create(model, params, sw, strategy=DenseStrategy(),
                                  quant=spec)
            s = dense.new_session()
            res = [s.prefill(prompts, max_new_tokens=FULL_STEPS + 1)]
            res += [s.step() for _ in range(FULL_STEPS)]
            require(np.array_equal(np.stack([r.tokens[:, 0] for r in res],
                                            1), toks),
                    f"quant {spec} AR differs from quantized dense greedy")
            log("quant", f"{spec}: no row exited; tokens equal quantized "
                "dense greedy decoding")
            del dense, s, res
        if spec == "int8":                   # one profile keeps the time
            profile_ticks(torch, "profile-quant-int8", session.step, 3,
                          f" ({t_decode / FULL_STEPS * 1e3:.2f} unprofiled)")
        del session, engine
        torch.cuda.empty_cache()
        by_path[f"quant_{spec}_whole_batch"] = launches

        tree = tree_strategy()
        engine = Engine.create(model, params, sw, strategy=tree, quant=spec)
        K.reset_launches()                   # ---- the main path ----
        session = engine.new_session()
        session.prefill(prompts, max_new_tokens=(QUANT_TREE_STEPS + 4)
                        * (tree.tree.depth + 1))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tsteps = [session.step() for _ in range(QUANT_TREE_STEPS)]
        torch.cuda.synchronize()
        t_tree = time.perf_counter() - t0
        t_launch = dict(K.LAUNCHES)          # ---- read right after ----
        require(all(((r.tokens >= 0) & (r.tokens < V)).all()
                    for r in tsteps), "tree token out of vocabulary")
        tree_path = quantized(TREE_PATH)
        _require_quant_path(t_launch, TREE_PATH, f"quant {spec} tree")
        require(t_launch["spec_head_gather_q"] <= QUANT_TREE_STEPS
                and t_launch["spec_head_gather_q"]
                <= t_launch["spec_head_q"], f"quant {spec} tree: the node "
                f"columns gathered more than once a step ({t_launch})")
        tokens = sum(int(r.counts.sum()) for r in tsteps)
        log("quant", f"{spec} tree: {QUANT_TREE_STEPS} steps in "
            f"{t_tree:.3f} s = {t_tree / QUANT_TREE_STEPS * 1e3:.2f} ms/step,"
            f" {tokens / t_tree:.2f} tokens/s; mean units_run "
            f"{np.mean([r.units_run for r in tsteps]):.2f}; launches "
            + ", ".join(f"{k} {t_launch[k]} "
                        f"({t_launch[k] / QUANT_TREE_STEPS:.2f}/step)"
                        for k in tree_path))
        by_path[f"quant_{spec}_tree"] = t_launch
        profile_ticks(torch, f"profile-quant-{spec}-tree", session.step, 3,
                      f" ({t_tree / QUANT_TREE_STEPS * 1e3:.2f} unprofiled)")
        del session, engine
        torch.cuda.empty_cache()

    # serving: the first 8 serve prompts through 8 paged slots, int8
    s_launch, outs, se = quant_serve_run(torch, params, sw, "quant",
                                         "serve int8")
    by_path["quant_int8_serve"] = s_launch
    profile_serving(torch, se, "profile-quant-serve")
    del se
    torch.cuda.empty_cache()
    return by_path, outs


def quant_serve_run(torch, params, sw, phase: str, label: str,
                    kv_quant: bool = False):
    """ServingEngine(quant="int8", cache="paged") with every kernel, on bf16
    or (``kv_quant``) int8 page pools: the first 8 serve prompts through 8
    slots, blocking admission (phases 7 and 8). The launch counts are
    zeroed right before the requests are submitted and read right after the
    last one completes. Returns (launches, per-request (output, exit
    points), the engine)."""
    from repro_torch import kernels as K
    from repro_torch.models.model import ModelFlags, build_model
    from repro_torch.serving import ServingEngine
    srun = llama(32, "bfloat16", max_batch=SERVE_BATCH,
                 max_seq_len=SERVE_SEQ, page_size=PAGE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    se = ServingEngine(build_model(srun, ModelFlags(**ALL_KERNELS,
                                                    kv_quant=kv_quant)),
                       params, sw, cache="paged", prefill_chunk=0,
                       quant="int8")
    mgr = se.session.cache_mgr
    sprompts = serve_prompts()[:TREE_SERVE_REQS]
    tick_s = []
    K.reset_launches()                       # ---- the main path ----
    t0 = time.perf_counter()
    reqs = [se.submit(p, max_new_tokens=SERVE_NEW) for p in sprompts]
    while se.busy:
        t1 = time.perf_counter()
        se.step()
        torch.cuda.synchronize()
        tick_s.append(time.perf_counter() - t1)
        require(len(tick_s) <= 10_000, f"{label} did not finish")
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)              # ---- read right after ----
    ticks = len(tick_s)
    require(all(r.done and len(r.output) == SERVE_NEW for r in reqs),
            f"{label}: a request did not finish with its 32 tokens")
    require(all(0 <= t < V for r in reqs for t in r.output),
            "token out of vocabulary")
    require(mgr.free_pages == mgr.num_pages,
            f"{mgr.free_pages} of {mgr.num_pages} pages free at the end")
    _require_quant_path(launches, (KVQ_SERVE_PATH if kv_quant else SERVE_PATH)
                        + ("flash_attention",), label)
    other = "paged_decode_attention" + ("" if kv_quant else "_q")
    require(launches[other] == 0, f"{other} ran on the {label} path")
    log(phase, f"{label}: {TREE_SERVE_REQS} requests (prompts "
        f"{min(map(len, sprompts))}-{max(map(len, sprompts))} tokens, "
        f"{SERVE_NEW} new each) through {SERVE_BATCH} slots in {wall:.3f} s"
        f" = {TREE_SERVE_REQS / wall:.3f} requests/s, "
        f"{TREE_SERVE_REQS * SERVE_NEW / wall:.2f} tokens/s; {ticks} ticks, "
        f"{wall / ticks * 1e3:.2f} ms/tick (median "
        f"{sorted(tick_s)[ticks // 2] * 1e3:.2f}, first tick, with the "
        f"admissions, {tick_s[0] * 1e3:.2f}); peak card memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; free pages at "
        f"the end {mgr.free_pages} of {mgr.num_pages}")
    log(phase, f"{label} launches: " + ", ".join(
        f"{k} {v} ({v / ticks:.2f}/tick)" for k, v in launches.items()))
    return launches, [(r.output, r.exit_points) for r in reqs], se


# ---------------------------------------------------------------------------
# phase 8: serving on an int8 KV cache at full width
# ---------------------------------------------------------------------------
def kvq_phase(torch, dev, params, sw, fp_serve, q8_outs):
    """``ModelFlags(kv_quant=True)`` on the phase-4 weights: phase 5's AR
    serve cell, blocking and 256-token chunked, then
    ``ServingEngine(quant="int8")`` on the first 8 serve prompts. Each run
    must launch the int8 paged kernel and never the fp one. Outputs are
    compared with phase 5's fp runs and phase 7's int8 serve run (the same
    admission mode), with the top-2 margin at each first differing token."""
    by_path = {}
    for chunk, ref_name in ((0, "blocking"), (256, "chunked")):
        torch.cuda.empty_cache()
        launches, outs, stats = serve_run(torch, dev, params, sw, chunk,
                                          kv_quant=True)
        pool_gb = stats["pool_gb"]
        by_path[f"kvq_serve_{ref_name}"] = launches
        log("kvq", f"kv_quant {ref_name}: int8 page pools {pool_gb:.2f} GB "
            f"against the bf16 pools' {fp_serve['pool_gb']:.2f} GB "
            f"({fp_serve['pool_gb'] / pool_gb:.3f}x smaller)")
        flip_margins(torch, params, fp_serve[ref_name], outs, "kvq",
                     f"phase 5's fp {ref_name} run and the kv_quant one")
    torch.cuda.empty_cache()
    profile_serving(torch, serve_engine(torch, params, sw, 0, True),
                    "profile-kvq")

    # composed with weight-only int8: the first 8 serve prompts, blocking
    torch.cuda.empty_cache()
    launches, outs, se = quant_serve_run(torch, params, sw, "kvq",
                                         "kv_quant + int8 weights serve",
                                         kv_quant=True)
    by_path["kvq_quant_int8_serve"] = launches
    view, _ = se.engine.prefill_weights()
    flip_margins(torch, view, q8_outs, outs, "kvq",
                 "phase 7's int8 serve run and the kv_quant one (margins "
                 "on the dequantized weights)")
    del se, view
    torch.cuda.empty_cache()
    return by_path


def flip_margins(torch, params, out_block, out_chunk, phase: str,
                 what: str) -> None:
    """For each request whose two runs' outputs differ (``out_block`` the
    reference run): the plain model's top-2 logit margin on ``params`` at
    the first differing token, after the prompt and the reference run's
    tokens before it, beside the spacing of bf16 numbers at the top logit
    (the logits are a bf16 product), and the exit points both runs took
    there."""
    import math
    from repro_torch.models.model import build_model
    plain = build_model(llama(32, "bfloat16"))
    E = plain.num_exit_points
    prompts = serve_prompts()
    notes = []
    for i, ((out_b, eps_b), (out_c, eps_c)) in enumerate(
            zip(out_block, out_chunk)):
        j = next((j for j, (a, b) in enumerate(zip(out_b, out_c)) if a != b),
                 None)
        if j is None:
            continue
        margin, top = top2_margin(torch, plain, params,
                                  list(prompts[i]) + out_b[:j])
        ulp = 2.0 ** (math.floor(math.log2(abs(top))) - 7) if top else 0.0
        eps = ("the prefill's token" if j == 0 else
               f"exit points {eps_b[j - 1]}/{eps_c[j - 1]} of {E}")
        notes.append(f"request {i} token {j}: margin {margin:.4g} "
                     f"(top {top:.4g}, bf16 spacing {ulp:.4g}; {eps})")
    log(phase, f"{len(notes)} of {len(out_block)} requests diverged between "
        f"{what}" + (": " if notes else "") + "; ".join(notes))


# ---------------------------------------------------------------------------
# phase 2 (continued): the dense family's shapes
# ---------------------------------------------------------------------------
# StarCoder2-15B (src/repro_torch/configs/starcoder2_15b.py): 48 query heads
# over 4 KV heads of 128 — 12 query heads per KV head, which the three
# split-KV attention kernels take since they gained the n_rep-12 instance
SC_HEADS, SC_KVH = 48, 4
# a phase-5 serve tick's 8 rows (2203 live keys), in 4096-token rows
TICK_LENS = [150, 300, 500, 220, 180, 400, 260, 193]
# (name, D, V) of the heads whose gate and verifies phase 12 runs: MiniCPM's
# odd vocabulary and D = 2304, Command R+'s widest head
DF_HEADS = (("minicpm-2b", 2304, 122753), ("command-r-plus-104b", 12288,
                                           256000))
# (name, D, V) of the gate widths phase 12 runs beside Llama-2-7B's
DF_GATES = (("llama2-13b", 5120, 32000), ("starcoder2-15b", 6144, 49152),
            ("command-r-plus-104b", 12288, 256000))


def check_dense_family_kernels(torch, dev):
    """Phase 2 at the dense family's shapes. (1) The dense, paged and int8
    paged attention kernels at 12 query heads per KV head (StarCoder2-15B's
    decode: 48 heads over 4, hd 128, B = 4): fp32 and bf16 against their
    plain versions (windows None/300, rows of one and of several splits,
    a retired paged row), then bf16 timings at 150 live keys of 162 slots
    and 4096 of 4096 (dense) and at a serve tick's 2203 live keys (both
    paged), beside SDPA (enable_gqa; on the gathered, for int8 the
    dequantized, view) and the byte bound. (2) The four verify tiles
    (argmax_verify_fused, topk_verify_fused and, int8, their quantized
    variants) on bf16 rows at MiniCPM-2B's head (D = 2304, odd V = 122753)
    and Command R+'s (D = 12288, V = 256000): B = 4 and 160 rows against
    the plain version with a planted tie, then timed at B = 4. (3) The fp
    gate and exit_gate_q (int8 head and bank) at D = 5120, 6144 and 12288
    against their plain versions, timed at B = 4. (4) Flash at 48 over 4
    heads of 128 and at MiniCPM's 36 heads of 64 (S = 512), fp32 and bf16
    against the plain version, timed beside causal SDPA. Returns (max
    error by kernel, {kernel: {shape: timing row}})."""
    import torch.nn.functional as F
    from repro_torch import quant
    from repro_torch.core import paged as paged_lib
    from repro_torch.kernels.decode_attention.decode_attention import (
        decode_attention_fwd, paged_decode_attention_fwd)
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_ref, paged_decode_attention_ref)
    from repro_torch.kernels.exit_gate import exit_gate as eg
    from repro_torch.kernels.exit_gate import ref as gref
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_fwd)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models.model import _kv_dequantize
    gen = torch.Generator(device=dev).manual_seed(2468)

    def rnd(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).to(dtype)

    errs = {}

    def note(name, a, b, **tol):
        torch.testing.assert_close(a, b, **tol)
        errs[name] = max(errs.get(name, 0.0), (a - b).abs().max().item())

    def paged(dt, lens, int8, seed):
        """A paged case in 32-page rows at n_rep 12: (the wrapper's
        positional arguments, its scale keyword arguments)."""
        if not int8:
            return _paged_case(torch, dev, rnd, dt, 32, lens, seed,
                               SC_HEADS, SC_KVH), {}
        c = _paged_q_case(torch, dev, rnd, dt, 32, lens, SC_KVH, seed,
                          SC_HEADS)
        return c[:5], dict(k_scale=c[5], v_scale=c[6])

    # ---- (1) attention at n_rep 12 ----
    for dt in (torch.float32, torch.bfloat16):
        rtol = 1e-4 if dt == torch.float32 else 2.0 ** -7
        for S, lens in ((162, [150, 150, 1, 77]), (4096, [4096, 1, 2049,
                                                          2048])):
            q = rnd((B, 1, SC_HEADS, HD), dt)
            k = rnd((B, S, SC_KVH, HD), dt)
            v = rnd((B, S, SC_KVH, HD), dt)
            cl = torch.tensor(lens, dtype=torch.int32, device=dev)
            for window in (None, 300):
                note("decode_attention",
                     decode_attention_fwd(q, k, v, cl, window).float(),
                     decode_attention_ref(q.float(), k.float(), v.float(),
                                          cl, window), atol=1e-4, rtol=rtol)
        for int8 in (False, True):
            name = "paged_decode_attention" + ("_q" if int8 else "")
            for i, lens in enumerate((TICK_LENS, [4096, 150, 259, 1])):
                args, kw = paged(dt, lens, int8, i)
                live = len(lens) - (lens[-1] == 1)
                q, kp, vp, table, cl = args
                for window in (None, 300):
                    got = paged_decode_attention_fwd(*args, window=window,
                                                     **kw).float()
                    want = paged_decode_attention_ref(
                        q.float(), kp if int8 else kp.float(),
                        vp if int8 else vp.float(), table, cl, window,
                        kw.get("k_scale"), kw.get("v_scale"))
                    note(name, got[:live], want[:live], atol=1e-4,
                         rtol=rtol)
    torch.cuda.synchronize()
    log("kernels", f"n_rep 12 ({SC_HEADS} heads over {SC_KVH} KV heads "
        f"of {HD}): "
        f"decode_attention err {errs['decode_attention']:.3g}, "
        f"paged_decode_attention err {errs['paged_decode_attention']:.3g}, "
        f"paged_decode_attention_q err "
        f"{errs['paged_decode_attention_q']:.3g} (fp32 and bf16, windows "
        "None/300, rows of one and of several splits, a retired row)")
    t = {"decode_attention": {}, "paged_decode_attention": {},
         "paged_decode_attention_q": {}}
    dt, dname = torch.bfloat16, "bfloat16"
    for S, live, n_c in ((162, 150, 8), (4096, 4096, 2)):
        q = rnd((B, 1, SC_HEADS, HD), dt)
        qs = q.transpose(1, 2)
        cl = torch.full((B,), live, dtype=torch.int32, device=dev)
        caches = [(rnd((B, S, SC_KVH, HD), dt), rnd((B, S, SC_KVH, HD), dt))
                  for _ in range(n_c)]
        mask = (None if live == S else
                (torch.arange(S, device=dev) < live)[None, None, None, :])
        kv_t = [(k.transpose(1, 2), v.transpose(1, 2)) for k, v in caches]
        reps = 24 // n_c
        row = (graph_ms(torch, [lambda c=c: decode_attention_fwd(
                   q, c[0], c[1], cl) for c in caches] * reps),
               graph_ms(torch, [lambda c=c: decode_attention_ref(
                   q, c[0], c[1], cl) for c in caches] * reps),
               graph_ms(torch, [lambda c=c: F.scaled_dot_product_attention(
                   qs, c[0], c[1], attn_mask=mask, enable_gqa=True)
                   for c in kv_t] * reps),
               bound_ms(2 * B * live * SC_KVH * HD * 2
                        + 2 * B * SC_HEADS * HD * 2 + B * 4,
                        4 * B * live * SC_HEADS * HD, dname))
        t["decode_attention"][f"n_rep 12, {live} live of {S} slots"] = row
        log("kernels", f"decode_attention bf16, n_rep 12, {live} live keys "
            f"of {S} slots: kernel {row[0]:.4f} ms, plain {row[1]:.4f} ms, "
            f"SDPA {row[2]:.4f} ms, bound {row[3][0]:.4f} ms ({row[3][1]})")
        del caches, kv_t
    live = sum(TICK_LENS)
    for int8 in (False, True):
        name = "paged_decode_attention" + ("_q" if int8 else "")
        cases = [paged(dt, TICK_LENS, int8, 10 + j) for j in range(4)]
        views = []
        for (q, kp, vp, table, cl), kw in cases:
            kv = paged_lib.gather_view(kp, table)
            vv = paged_lib.gather_view(vp, table)
            if int8:
                kv = _kv_dequantize(kv, paged_lib.gather_view(
                    kw["k_scale"], table), dt)
                vv = _kv_dequantize(vv, paged_lib.gather_view(
                    kw["v_scale"], table), dt)
            mask = (torch.arange(kv.shape[1], device=dev)[None, :]
                    < cl[:, None])[:, None, None, :]
            views.append((q.transpose(1, 2), kv.transpose(1, 2),
                          vv.transpose(1, 2), mask))
        esize = 1 if int8 else 2
        nbytes = (2 * live * SC_KVH * HD * esize
                  + (2 * live * SC_KVH * 4 if int8 else 0)
                  + 2 * len(TICK_LENS) * SC_HEADS * HD * 2
                  + len(TICK_LENS) * 33 * 4)
        row = (graph_ms(torch, [lambda c=c: paged_decode_attention_fwd(
                   *c[0], **c[1]) for c in cases] * 3),
               graph_ms(torch, [lambda c=c: paged_decode_attention_ref(
                   *c[0], None, c[1].get("k_scale"), c[1].get("v_scale"))
                   for c in cases] * 3),
               graph_ms(torch, [lambda w=w: F.scaled_dot_product_attention(
                   w[0], w[1], w[2], attn_mask=w[3], enable_gqa=True)
                   for w in views] * 3),
               bound_ms(nbytes, 4 * live * SC_HEADS * HD, dname))
        t[name][f"n_rep 12, serve tick, {live} live keys"] = row
        log("kernels", f"{name} bf16, n_rep 12, a serve tick's {live} live "
            f"keys (B=8): kernel {row[0]:.4f} ms, plain {row[1]:.4f} ms, "
            f"SDPA on the gathered{' dequantized' if int8 else ''} view "
            f"{row[2]:.4f} ms, bound {row[3][0]:.4f} ms ({row[3][1]})")
        del cases, views

    # ---- (2) the verify tiles and (3) the gates at the new widths ----
    for name in ("argmax_verify", "topk_verify", "argmax_verify_q",
                 "topk_verify_q", "exit_gate", "exit_gate_q"):
        t[name] = {}

    def plant(w, hn):
        best = int((hn[-1].float() @ w.float()).argmax())
        dups = {best, (best + 3 * 128) % w.shape[1], best % 128}
        for j in dups:
            w[:, j] = w[:, best]
        return min(dups)

    n = 10
    for label, d, v in DF_HEADS:
        w32 = rnd((d, v), torch.float32, 0.05)
        hn4 = rnd((B, d), dt)
        for R in (B, 160):
            hn = hn4 if R == B else rnd((R, d), dt)
            w = w32.to(dt)
            lowest = plant(w, hn)
            tok, mx = eg.argmax_verify_fused(hn, w)
            tok_r, mx_r = gref.verify_argmax_ref(hn, w)
            require(torch.equal(tok, tok_r) and int(tok[-1]) == lowest,
                    f"argmax_verify at {label}'s head, R={R}: ids differ")
            note("argmax_verify", mx, mx_r, atol=1e-4, rtol=1e-4)
            ids, vals = eg.topk_verify_fused(hn, w, K_SPEC)
            ids_r, vals_r = gref.verify_topk_ref(hn, w, K_SPEC)
            require(torch.equal(ids, ids_r) and int(ids[-1, 0]) == lowest,
                    f"topk_verify at {label}'s head, R={R}: ids differ")
            note("topk_verify", vals, vals_r, atol=1e-4, rtol=1e-4)
            del w
            qt = quant.quantize_tensor(w32, 8)
            tok, mx = eg.argmax_verify_fused_q(hn, qt)
            tok_r, mx_r = gref.verify_argmax_q_ref(hn, qt)
            require(torch.equal(tok, tok_r),
                    f"argmax_verify_q at {label}'s head, R={R}: ids differ")
            note("argmax_verify_q", mx, mx_r, atol=1e-4, rtol=1e-4)
            ids, vals = eg.topk_verify_fused_q(hn, qt, K_SPEC)
            ids_r, vals_r = gref.verify_topk_q_ref(hn, qt, K_SPEC)
            require(torch.equal(ids, ids_r),
                    f"topk_verify_q at {label}'s head, R={R}: ids differ")
            note("topk_verify_q", vals, vals_r, atol=1e-4, rtol=1e-4)
            del qt
        w = w32.to(dt)
        qt = quant.quantize_tensor(w32, 8)
        wq = qt.dequantize(dt)
        del w32
        head_b = d * v * 2 + B * d * 2
        ops = 2 * B * d * v
        shape = f"{label}, D={d}, V={v}, B={B}"
        rows = {
            "argmax_verify": (
                graph_ms(torch, [lambda: eg.argmax_verify_fused(hn4, w)] * n),
                graph_ms(torch, [lambda: gref.verify_argmax_ref(hn4, w)] * n),
                graph_ms(torch, [lambda: torch.argmax(hn4 @ w, -1)] * n),
                bound_ms(head_b + B * 8, ops, dname)),
            "topk_verify": (
                graph_ms(torch, [lambda: eg.topk_verify_fused(
                    hn4, w, K_SPEC)] * n),
                graph_ms(torch, [lambda: gref.verify_topk_ref(
                    hn4, w, K_SPEC)] * n),
                graph_ms(torch, [lambda: torch.topk(hn4 @ w, K_SPEC,
                                                    -1)] * n),
                bound_ms(head_b + B * K_SPEC * 8, ops, dname)),
            # yardsticks: the fp tile on the dequantized bf16 head
            "argmax_verify_q": (
                graph_ms(torch, [lambda: eg.argmax_verify_fused_q(
                    hn4, qt)] * n),
                graph_ms(torch, [lambda: gref.verify_argmax_q_ref(
                    hn4, qt)] * n),
                graph_ms(torch, [lambda: eg.argmax_verify_fused(
                    hn4, wq)] * n),
                bound_ms(qt.nbytes() + B * d * 2 + B * 8, ops, dname)),
            "topk_verify_q": (
                graph_ms(torch, [lambda: eg.topk_verify_fused_q(
                    hn4, qt, K_SPEC)] * n),
                graph_ms(torch, [lambda: gref.verify_topk_q_ref(
                    hn4, qt, K_SPEC)] * n),
                graph_ms(torch, [lambda: eg.topk_verify_fused(
                    hn4, wq, K_SPEC)] * n),
                bound_ms(qt.nbytes() + B * d * 2 + B * K_SPEC * 8, ops,
                         dname))}
        for name, row in rows.items():
            t[name][shape] = row
            lib = "fp tile on the dequantized head" if name.endswith(
                "_q") else "matmul + " + name.split("_")[0]
            log("kernels", f"{name} bf16 at {shape}: kernel {row[0]:.4f} "
                f"ms, plain {row[1]:.4f} ms, {lib} {row[2]:.4f} ms, bound "
                f"{row[3][0]:.4f} ms ({row[3][1]})")
        del w, qt, wq
        torch.cuda.empty_cache()
    log("kernels", "verify tiles at " + " and ".join(
        f"{n}'s head (D={d}, V={v})" for n, d, v in DF_HEADS)
        + ", B 4 and 160: ids equal the plain versions', planted ties to "
        "the lowest id; errors: "
        + ", ".join(f"{k} {errs[k]:.3g}" for k in (
            "argmax_verify", "topk_verify", "argmax_verify_q",
            "topk_verify_q")))
    for label, d, v in DF_GATES:
        w32 = rnd((d, v), torch.float32, 0.05)
        w, qt = w32.to(dt), quant.quantize_tensor(w32, 8)
        del w32
        w1 = rnd((3 * K_SPEC, H_PRED), torch.float32, 12 ** -0.5)
        b1 = rnd((H_PRED,), torch.float32, 0.1)
        w2 = rnd((H_PRED, 1), torch.float32, H_PRED ** -0.5)
        b2 = rnd((1,), torch.float32, 0.1)
        pred = {"layers": [{"w": w1, "b": b1}, {"w": w2, "b": b2}]}
        l1 = {"w": quant.quantize_tensor(w1, 8), "b": b1}
        l2 = {"w": quant.quantize_tensor(w2, 8), "b": b2}
        hn = rnd((B, d), dt)
        id_sets = [torch.randint(0, v, (B, K_SPEC), generator=gen,
                                 device=dev, dtype=torch.int32)
                   for _ in range(20)]
        prev = torch.softmax(rnd((B, K_SPEC), torch.float32), -1)
        wf = w.float()
        for hh, head in ((hn, w), (hn.float(), wf)):
            for a, b in zip(eg.exit_gate_fused(hh, head, id_sets[0], prev,
                                               w1, b1, w2, b2),
                            gref.exit_gate_ref(hh, head, id_sets[0], prev,
                                               pred)):
                note("exit_gate", a, b, atol=1e-4, rtol=1e-4)
            for a, b in zip(eg.exit_gate_fused_q(hh, qt, id_sets[0], prev,
                                                 l1, l2),
                            gref.exit_gate_q_ref(hh, qt, id_sets[0], prev,
                                                 l1, l2)):
                note("exit_gate_q", a, b, atol=1e-4, rtol=1e-4)
        del wf
        fixed = (B * d * 2 + B * K_SPEC * 8 + B * (1 + 2 * K_SPEC) * 4)
        ops = B * (2 * K_SPEC * d + 2 * 3 * K_SPEC * H_PRED + 4 * H_PRED)
        shape = f"{label}, D={d}, B={B}"
        rows = {
            "exit_gate": (
                graph_ms(torch, [lambda i=i: eg.exit_gate_fused(
                    hn, w, i, prev, w1, b1, w2, b2) for i in id_sets]),
                graph_ms(torch, [lambda i=i: gref.exit_gate_ref(
                    hn, w, i, prev, pred) for i in id_sets]),
                None,
                bound_ms(fixed + (3 * K_SPEC * H_PRED + 2 * H_PRED + 1) * 4
                         + B * K_SPEC * d * 2, ops, "float32")),
            "exit_gate_q": (
                graph_ms(torch, [lambda i=i: eg.exit_gate_fused_q(
                    hn, qt, i, prev, l1, l2) for i in id_sets]),
                graph_ms(torch, [lambda i=i: gref.exit_gate_q_ref(
                    hn, qt, i, prev, l1, l2) for i in id_sets]),
                None,
                bound_ms(fixed + l1["w"].nbytes() + l2["w"].nbytes()
                         + (H_PRED + 1) * 4 + B * K_SPEC * (d + 4), ops,
                         "float32"))}
        for name, row in rows.items():
            t[name][shape] = row
            log("kernels", f"{name} bf16 at {shape}: kernel {row[0]:.4f} "
                f"ms, plain {row[1]:.4f} ms, bound {row[3][0]:.5f} ms "
                f"({row[3][1]})")
        del w, qt
        torch.cuda.empty_cache()
    log("kernels", "gates at D " + ", ".join(str(d) for _, d, _ in DF_GATES)
        + f" (fp32 and bf16 rows): exit_gate err {errs['exit_gate']:.3g}, "
        f"exit_gate_q (int8 head and bank) err {errs['exit_gate_q']:.3g}")

    # ---- (4) flash at 48 over 4 heads of 128 and 36 heads of 64 ----
    t["flash_attention"] = {}
    for label, H, KVH, hd in (("starcoder2-15b", SC_HEADS, SC_KVH, HD),
                              ("minicpm-2b", 36, 36, 64)):
        for d_t in (torch.float32, torch.bfloat16):
            rtol = 1e-4 if d_t == torch.float32 else 2.0 ** -7
            q = rnd((1, 512, H, hd), d_t)
            k = rnd((1, 512, KVH, hd), d_t)
            v = rnd((1, 512, KVH, hd), d_t)
            for window in (None, 64):
                note("flash_attention",
                     flash_attention_fwd(q, k, v, causal=True,
                                         window=window).float(),
                     flash_attention_ref(q.float(), k.float(), v.float(),
                                         True, window), atol=1e-4, rtol=rtol)
        qs, ks, vs = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        row = (graph_ms(torch, [lambda: flash_attention_fwd(q, k, v)] * n),
               graph_ms(torch, [lambda: flash_attention_ref(q, k, v)] * n),
               graph_ms(torch, [lambda: F.scaled_dot_product_attention(
                   qs, ks, vs, is_causal=True,
                   enable_gqa=KVH != H)] * n),
               bound_ms(nbytes, 4 * H * hd * 512 * 513 // 2, dname))
        shape = f"{label}, {H} heads over {KVH} of {hd}, B=1, S=512"
        t["flash_attention"][shape] = row
        log("kernels", f"flash_attention bf16 at {shape}: kernel "
            f"{row[0]:.4f} ms, plain {row[1]:.4f} ms, causal SDPA "
            f"{row[2]:.4f} ms, bound {row[3][0]:.4f} ms ({row[3][1]})")
    log("kernels", "flash at 48 over 4 heads of 128 and 36 of 64 (fp32 and "
        f"bf16, windows None/64): err {errs['flash_attention']:.3g}")
    torch.cuda.empty_cache()
    return errs, t


# ---------------------------------------------------------------------------
# phase 2 (continued): the MoE, hybrid and VLM configs' head shapes
# ---------------------------------------------------------------------------
# (label, query heads, KV heads, head dim) of the attention shapes phases
# 14 and 17 decode with: n_rep 6 at 128, 16 at 64 and 16 at 256 (MQA), and
# a tensor-parallel shard of recurrentgemma-9b's at P = 2 and 4 (8 and 4
# heads over its one KV head of 256), each an instance of the three
# split-KV kernels
NF_HEADS = (("dbrx-132b / internvl2-26b", 48, 8, 128),
            ("qwen3-moe-235b-a22b", 64, 4, 64),
            ("recurrentgemma-9b", 16, 1, 256),
            ("recurrentgemma-9b, a P = 2 shard", 8, 1, 256),
            ("recurrentgemma-9b, a P = 4 shard", 4, 1, 256))
# the other shards phase 17 decodes with: the same instances over fewer KV
# heads, so fewer CTAs and other splits; checked, not timed
TP_SHARD_HEADS = (("dbrx-132b / internvl2-26b, a P = 2 shard", 24, 4, 128),
                  ("dbrx-132b / internvl2-26b, a P = 4 shard", 12, 2, 128),
                  ("qwen3-moe-235b-a22b, a P = 4 shard", 16, 1, 64))
RG_WINDOW = 2048             # recurrentgemma-9b's local attention window
RG_PROMPT = 2112             # phase 14's hybrid prompt: past the window


def check_new_family_kernels(torch, dev):
    """Phase 2 at the new families' shapes. (1) The dense, paged and int8
    paged attention kernels at each of NF_HEADS and TP_SHARD_HEADS: fp32
    and bf16 against
    their plain versions (windows None/64/300, rows of one and of several
    splits, a retired paged row; the MQA rows cut by the fill rule), then
    bf16 timings at 150 live keys of 162 slots (a whole-batch decode step)
    and at 2150 live of 2240 (recurrentgemma-9b's under its 2048-key
    window; the others unwindowed), and at a serve tick's 2203 live keys
    (both paged), beside SDPA (enable_gqa; on the gathered, for int8 the
    dequantized, view) and the byte bound. (2) Flash at hd 256 (16 heads
    over one): fp32 at S = 300 and bf16 at S = 2112 against the plain
    version, windows None/64/2048, timed at B = 1, S = 2112 under the 2048
    window beside SDPA with the same mask; and at 48 over 8 of 128 and 64
    over 4 of 64 (S = 512, bf16). Returns (max error by kernel, {kernel:
    {shape: timing row}})."""
    import torch.nn.functional as F
    from repro_torch.core import paged as paged_lib
    from repro_torch.kernels.decode_attention.decode_attention import (
        decode_attention_fwd, paged_decode_attention_fwd)
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_ref, paged_decode_attention_ref)
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_fwd)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models.model import _kv_dequantize
    gen = torch.Generator(device=dev).manual_seed(1357)

    def rnd(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).to(dtype)

    errs = {}

    def note(name, a, b, **tol):
        torch.testing.assert_close(a, b, **tol)
        errs[name] = max(errs.get(name, 0.0), (a - b).abs().max().item())

    def paged(dt, lens, int8, seed, H, KVH, hd):
        if not int8:
            return _paged_case(torch, dev, rnd, dt, 32, lens, seed, H, KVH,
                               hd), {}
        c = _paged_q_case(torch, dev, rnd, dt, 32, lens, KVH, seed, H, hd)
        return c[:5], dict(k_scale=c[5], v_scale=c[6])

    # ---- (1) correctness at each new (n_rep, hd) and each shard ----
    for label, H, KVH, hd in NF_HEADS + TP_SHARD_HEADS:
        for dt in (torch.float32, torch.bfloat16):
            rtol = 1e-4 if dt == torch.float32 else 2.0 ** -7
            for S, lens in ((162, [150, 150, 1, 77]),
                            (2300, [2300, 1, 2113, 2048])):
                q = rnd((B, 1, H, hd), dt)
                k = rnd((B, S, KVH, hd), dt)
                v = rnd((B, S, KVH, hd), dt)
                cl = torch.tensor(lens, dtype=torch.int32, device=dev)
                for window in (None, 64, 300):
                    note("decode_attention",
                         decode_attention_fwd(q, k, v, cl, window).float(),
                         decode_attention_ref(q.float(), k.float(),
                                              v.float(), cl, window),
                         atol=1e-4, rtol=rtol)
            for int8 in (False, True):
                name = "paged_decode_attention" + ("_q" if int8 else "")
                for i, lens in enumerate((TICK_LENS, [4096, 150, 259, 1])):
                    args, kw = paged(dt, lens, int8, i, H, KVH, hd)
                    live = len(lens) - (lens[-1] == 1)
                    q, kp, vp, table, cl = args
                    for window in (None, 64, 300):
                        got = paged_decode_attention_fwd(
                            *args, window=window, **kw).float()
                        want = paged_decode_attention_ref(
                            q.float(), kp if int8 else kp.float(),
                            vp if int8 else vp.float(), table, cl, window,
                            kw.get("k_scale"), kw.get("v_scale"))
                        note(name, got[:live], want[:live], atol=1e-4,
                             rtol=rtol)
                    del args, kw
        torch.cuda.synchronize()
        log("kernels", f"{label} ({H} heads over {KVH} of {hd}, n_rep "
            f"{H // KVH}): decode_attention, paged_decode_attention and "
            "paged_decode_attention_q equal their plain versions (fp32 and "
            "bf16, windows None/64/300, rows of one and of several splits, "
            "a retired row)")
    log("kernels", "new head shapes: errors " + ", ".join(
        f"{k} {errs[k]:.3g}" for k in ("decode_attention",
                                       "paged_decode_attention",
                                       "paged_decode_attention_q")))

    # ---- timings, bf16 ----
    t = {"decode_attention": {}, "paged_decode_attention": {},
         "paged_decode_attention_q": {}, "flash_attention": {}}
    dt, dname = torch.bfloat16, "bfloat16"
    for label, H, KVH, hd in NF_HEADS:
        win = RG_WINDOW if label.startswith("recurrentgemma") else None
        for S, live, n_c in ((162, 150, 8), (2240, 2150, 2)):
            q = rnd((B, 1, H, hd), dt)
            qs = q.transpose(1, 2)
            cl = torch.full((B,), live, dtype=torch.int32, device=dev)
            caches = [(rnd((B, S, KVH, hd), dt), rnd((B, S, KVH, hd), dt))
                      for _ in range(n_c)]
            kpos = torch.arange(S, device=dev)
            keep = kpos < live
            if win:
                keep = keep & (kpos >= live - win)
            mask = keep[None, None, None, :]
            kv_t = [(k.transpose(1, 2), v.transpose(1, 2)) for k, v in caches]
            eff = min(live, win) if win else live
            reps = 24 // n_c
            row = (graph_ms(torch, [lambda c=c: decode_attention_fwd(
                       q, c[0], c[1], cl, win) for c in caches] * reps),
                   graph_ms(torch, [lambda c=c: decode_attention_ref(
                       q, c[0], c[1], cl, win) for c in caches] * reps),
                   graph_ms(torch, [lambda c=c: F.scaled_dot_product_attention(
                       qs, c[0], c[1], attn_mask=mask, enable_gqa=True)
                       for c in kv_t] * reps),
                   bound_ms(2 * B * eff * KVH * hd * 2
                            + 2 * B * H * hd * 2 + B * 4,
                            4 * B * eff * H * hd, dname))
            shape = (f"{label}, n_rep {H // KVH} of {hd}, {live} live of "
                     f"{S} slots" + (f", window {win}" if win else ""))
            t["decode_attention"][shape] = row
            log("kernels", f"decode_attention bf16 at {shape}: kernel "
                f"{row[0]:.4f} ms, plain {row[1]:.4f} ms, SDPA "
                f"{row[2]:.4f} ms, bound {row[3][0]:.4f} ms ({row[3][1]})")
            del caches, kv_t
        live = sum(TICK_LENS)
        for int8 in (False, True):
            name = "paged_decode_attention" + ("_q" if int8 else "")
            cases = [paged(dt, TICK_LENS, int8, 10 + j, H, KVH, hd)
                     for j in range(4)]
            views = []
            for (q, kp, vp, table, cl), kw in cases:
                kv = paged_lib.gather_view(kp, table)
                vv = paged_lib.gather_view(vp, table)
                if int8:
                    kv = _kv_dequantize(kv, paged_lib.gather_view(
                        kw["k_scale"], table), dt)
                    vv = _kv_dequantize(vv, paged_lib.gather_view(
                        kw["v_scale"], table), dt)
                m = (torch.arange(kv.shape[1], device=dev)[None, :]
                     < cl[:, None])[:, None, None, :]
                views.append((q.transpose(1, 2), kv.transpose(1, 2),
                              vv.transpose(1, 2), m))
            esize = 1 if int8 else 2
            nbytes = (2 * live * KVH * hd * esize
                      + (2 * live * KVH * 4 if int8 else 0)
                      + 2 * len(TICK_LENS) * H * hd * 2
                      + len(TICK_LENS) * 33 * 4)
            row = (graph_ms(torch, [lambda c=c: paged_decode_attention_fwd(
                       *c[0], **c[1]) for c in cases] * 3),
                   graph_ms(torch, [lambda c=c: paged_decode_attention_ref(
                       *c[0], None, c[1].get("k_scale"),
                       c[1].get("v_scale")) for c in cases] * 3),
                   graph_ms(torch, [lambda w=w: F.scaled_dot_product_attention(
                       w[0], w[1], w[2], attn_mask=w[3], enable_gqa=True)
                       for w in views] * 3),
                   bound_ms(nbytes, 4 * live * H * hd, dname))
            shape = (f"{label}, n_rep {H // KVH} of {hd}, serve tick, "
                     f"{live} live keys")
            t[name][shape] = row
            log("kernels", f"{name} bf16 at {shape} (B=8): kernel "
                f"{row[0]:.4f} ms, plain {row[1]:.4f} ms, SDPA on the "
                f"gathered{' dequantized' if int8 else ''} view "
                f"{row[2]:.4f} ms, bound {row[3][0]:.4f} ms ({row[3][1]})")
            del cases, views
        torch.cuda.empty_cache()

    # ---- (2) flash at hd 256, and at 48 over 8 and 64 over 4 ----
    for d_t, S in ((torch.float32, 300), (torch.bfloat16, RG_PROMPT)):
        rtol = 1e-4 if d_t == torch.float32 else 2.0 ** -7
        q = rnd((1, S, 16, 256), d_t)
        k = rnd((1, S, 1, 256), d_t)
        v = rnd((1, S, 1, 256), d_t)
        for window in (None, 64, RG_WINDOW):
            note("flash_attention",
                 flash_attention_fwd(q, k, v, causal=True,
                                     window=window).float(),
                 flash_attention_ref(q.float(), k.float(), v.float(), True,
                                     window), atol=1e-4, rtol=rtol)
    S, W = RG_PROMPT, RG_WINDOW
    qs, ks, vs = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    pos = torch.arange(S, device=dev)
    wmask = ((pos[None, :] <= pos[:, None])
             & (pos[None, :] > pos[:, None] - W))[None, None]
    n = 10
    pairs = sum(min(i + 1, W) for i in range(S))
    row = (graph_ms(torch, [lambda: flash_attention_fwd(q, k, v, True,
                                                        W)] * n),
           graph_ms(torch, [lambda: flash_attention_ref(q, k, v, True,
                                                        W)] * n),
           graph_ms(torch, [lambda: F.scaled_dot_product_attention(
               qs, ks, vs, attn_mask=wmask, enable_gqa=True)] * n),
           bound_ms(2 * (2 * q.numel() + k.numel() + v.numel()),
                    4 * 16 * 256 * pairs, dname))
    shape = f"recurrentgemma-9b, 16 heads over 1 of 256, B=1, S={S}, window {W}"
    t["flash_attention"][shape] = row
    log("kernels", f"flash_attention bf16 at {shape}: kernel {row[0]:.4f} "
        f"ms, plain {row[1]:.4f} ms, SDPA (windowed causal mask) "
        f"{row[2]:.4f} ms, bound {row[3][0]:.4f} ms ({row[3][1]})")
    for H, KVH, hd in ((48, 8, 128), (64, 4, 64)):
        q = rnd((1, 512, H, hd), dt)
        k = rnd((1, 512, KVH, hd), dt)
        v = rnd((1, 512, KVH, hd), dt)
        note("flash_attention", flash_attention_fwd(q, k, v).float(),
             flash_attention_ref(q.float(), k.float(), v.float()),
             atol=1e-4, rtol=2.0 ** -7)
    log("kernels", "flash at 16 over 1 of 256 (fp32 S=300, bf16 S="
        f"{RG_PROMPT}; windows None/64/{RG_WINDOW}), 48 over 8 of 128 and "
        f"64 over 4 of 64 (bf16, S=512): err {errs['flash_attention']:.3g}")
    torch.cuda.empty_cache()
    return errs, t


# ---------------------------------------------------------------------------
# Mamba2 (mamba2-130m): the SSD kernel (phase 2), parity (phase 3) and the
# model at published size (phase 9)
# ---------------------------------------------------------------------------
def check_ssd_kernel(torch, dev):
    """Phase 2, SSD: ``ssd_chunk`` against its plain version with fp32 and
    bf16 B/C, c in {32, 64}, ds in {16, 128}, hd in {32, 64} and the
    ragged c = 40, hd = 48 (the tensor-core tiles' zero fill), 1, 8 and 32
    cells, mild decay and steep decay (cum falls by up to 40 per token, so
    exp(cum_t - cum_s) for s > t overflows fp32 and must not be evaluated);
    then timed at a 512-token admission of mamba2-130m (8 cells, c=64,
    nh=24, hd=64, ds=128, bf16 B/C) beside its plain version, a yardstick
    (``torch.bmm`` for C.B^T, then the masked decayed scores, built
    outside the timed call, times x in one batched product; no one PyTorch
    call computes the function) and its bound. Then the gate and verify
    kernels at mamba2's widths (D=768, V=50280) on a tied head made
    contiguous, and the refusal of the strided ``embed.T`` view."""
    from repro_torch.kernels.exit_gate import exit_gate as eg
    from repro_torch.kernels.exit_gate import ref as gref
    from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref
    from repro_torch.kernels.ssd_chunk.ssd_chunk import ssd_chunk_fwd
    from repro_torch.models.common import lm_head_weight, with_contiguous_head
    gen = torch.Generator(device=dev).manual_seed(4321)

    def rnd(shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).to(dtype)

    def inputs(cells, c, hd, ds, bc_dtype, steep, nh=M_NH):
        cum = -torch.cumsum(torch.rand((cells, c, nh), generator=gen,
                                       device=dev) * steep, dim=1)
        return (rnd((cells, c, nh, hd)), cum,
                rnd((cells, c, ds), bc_dtype, ds ** -0.25),
                rnd((cells, c, ds), bc_dtype, ds ** -0.25))

    # fp32 accumulation of the same (upcast) inputs in another order:
    # atol = rtol = 1e-4; mamba2-130m's 24 heads and a P = 2 and P = 4
    # shard's 12 and 6 (phase 17)
    err, cases = 0.0, 0
    for bc, nh in itertools.product((torch.float32, torch.bfloat16),
                                    (M_NH, M_NH // 2, M_NH // 4)):
        for c, ds, hd in ((32, 16, 32), (64, 128, 64), (64, 16, 32),
                          (32, 128, 64), (40, 16, 48)):
            for cells in (1, 8, 32):
                for steep in (1.0, 40.0):
                    args = inputs(cells, c, hd, ds, bc, steep, nh)
                    got, want = ssd_chunk_fwd(*args), ssd_chunk_ref(*args)
                    require(bool(torch.isfinite(got).all()),
                            f"ssd_chunk: non-finite output (c {c}, ds "
                            f"{ds}, hd {hd}, steep {steep})")
                    torch.testing.assert_close(got, want, atol=1e-4,
                                               rtol=1e-4)
                    err = max(err, (got - want).abs().max().item())
                    cases += 1
    torch.cuda.synchronize()
    log("kernels", f"ssd_chunk: {cases} cases (fp32/bf16 B,C; {M_NH}/"
        f"{M_NH // 2}/{M_NH // 4} heads; c 32/40/64; ds 16/128; hd 32/48/64; "
        f"1/8/32 cells; decay up to 40 per token) equal the plain version, "
        f"max err {err:.3g}")

    cells, c = 8, M_CHUNK
    sets = [inputs(cells, c, M_HD, M_DS, torch.bfloat16, 1.0)
            for _ in range(16)]
    causal = torch.ones(c, c, dtype=torch.bool, device=dev).tril()
    yard_in = []
    for xdt, cum, bm, cm in sets:             # prepared outside the timing
        rel = cum[:, :, None, :] - cum[:, None, :, :]
        dec = torch.where(causal[None, :, :, None], torch.exp(rel),
                          torch.zeros((), device=dev))
        yard_in.append((bm.float(), cm.float(),
                        dec.permute(0, 3, 1, 2).contiguous(),
                        xdt.permute(0, 2, 1, 3).contiguous()))

    def yardstick(bm, cm, dec, xt):
        cb = torch.bmm(cm, bm.transpose(1, 2))            # (cells, c, c)
        return torch.matmul(cb[:, None] * dec, xt)        # (cells, nh, c, hd)

    nbytes = (2 * cells * c * M_DS * 2 + cells * c * M_NH * 4
              + 2 * cells * c * M_NH * M_HD * 4)
    ops = cells * (2 * c * c * M_DS + 2 * c * c * M_NH * M_HD)
    timing = {"ssd_chunk": (
        graph_ms(torch, [lambda a=a: ssd_chunk_fwd(*a) for a in sets]),
        graph_ms(torch, [lambda a=a: ssd_chunk_ref(*a) for a in sets]),
        None,
        bound_ms(nbytes, ops, "float32"),
        graph_ms(torch, [lambda a=a: yardstick(*a) for a in yard_in]))}
    ms, plain, _, (bnd, by), yard = timing["ssd_chunk"]
    log("kernels", f"ssd_chunk at a 512-token admission ({cells} cells of "
        f"{c}, {M_NH} heads of {M_HD}, d_state {M_DS}, bf16 B/C): kernel "
        f"{ms:.4f} ms, plain {plain:.4f} ms, yardstick (bmm + batched "
        f"product) {yard:.4f} ms, bound {bnd:.4f} ms ({by}: "
        f"{nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP fp32)")
    del sets, yard_in

    # the gate and verify kernels at mamba2's widths, tied head
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        params = {"embed": {"tok": rnd((M_V, M_D), dt, 0.05)}}
        head = lm_head_weight(with_contiguous_head(params))
        hn = rnd((B, M_D), dt)
        tok, mx = eg.argmax_verify_fused(hn, head)
        tok_r, mx_r = gref.verify_argmax_ref(hn, head)
        require(torch.equal(tok, tok_r), f"mamba2 width: argmax ids ({name})")
        torch.testing.assert_close(mx, mx_r, atol=1e-4, rtol=1e-4)
        ids, vals = eg.topk_verify_fused(hn, head, K_SPEC)
        ids_r, vals_r = gref.verify_topk_ref(hn, head, K_SPEC)
        require(torch.equal(ids, ids_r), f"mamba2 width: top-k ids ({name})")
        torch.testing.assert_close(vals, vals_r, atol=1e-4, rtol=1e-4)
        spec = torch.randint(M_V - 8, M_V, (B, K_SPEC), generator=gen,
                             device=dev, dtype=torch.int32)   # ragged tail
        prev = torch.softmax(rnd((B, K_SPEC)), -1)
        w1, b1 = rnd((3 * K_SPEC, H_PRED), scale=12 ** -0.5), rnd((H_PRED,))
        w2, b2 = rnd((H_PRED, 1), scale=H_PRED ** -0.5), rnd((1,))
        pred = {"layers": [{"w": w1, "b": b1}, {"w": w2, "b": b2}]}
        e_gate = 0.0
        for a, b in zip(eg.exit_gate_fused(hn, head, spec, prev, w1, b1, w2,
                                           b2),
                        gref.exit_gate_ref(hn, head, spec, prev, pred)):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
            e_gate = max(e_gate, (a - b).abs().max().item())
        try:
            eg.argmax_verify_fused(hn, lm_head_weight(params))
            require(False, "the strided embed.T head was not refused")
        except ValueError:
            pass
        errs[name] = ((mx - mx_r).abs().max().item(),
                      (vals - vals_r).abs().max().item(), e_gate)
        del params, head
    log("kernels", "gate and verify at D=768, V=50280 on the contiguous "
        "tied head: ids exact; max err argmax/top-k/gate " + "; ".join(
            f"{k} {a:.3g}/{b:.3g}/{g:.3g}" for k, (a, b, g) in errs.items())
        + "; the strided embed.T view raises")
    return {"ssd_chunk": err}, timing


def mamba(layers: int, dtype: str, **serve):
    """mamba2-130m at full width with ``layers`` layers in ``dtype``;
    keyword arguments replace ``ServeConfig`` fields."""
    import dataclasses
    from repro_torch.configs import get_config
    run = get_config("mamba2-130m")
    return dataclasses.replace(
        run, model=dataclasses.replace(run.model, num_layers=layers,
                                       dtype=dtype),
        serve=dataclasses.replace(run.serve, **serve))


MAMBA_KERNELS = dict(ALL_KERNELS, ssd_kernel=True)


def _same_streams(torch, m_plain, params, prompts, got, want, label):
    """Session summaries (tokens, exit points, exits, units_run per
    result) must be equal; a flipped token is reported with the plain
    model's top-2 logit margin there."""
    for step, (g, w) in enumerate(zip(got, want)):
        if g[0] != w[0]:
            row = next(r for r in range(len(g[0])) if g[0][r] != w[0][r])
            before = [res[0][row][0] for res in want[:step]]
            margin, _ = top2_margin(torch, m_plain, params,
                                    list(prompts[row]) + before)
            raise AssertionError(
                f"{label}: row {row} token {step} is {g[0][row][0]}, plain "
                f"gives {w[0][row][0]}; top-2 logit margin {margin:.3g}")
    require(got == want, f"{label}: exit points or units differ")


def mamba_parity(torch, dev):
    """Phase 3, Mamba2: mamba2-130m at full width, 4 layers, fp32, seeded
    weights. AR SpecEE sessions with every kernel flag (``ssd_kernel``
    too) against the plain paths on dense and paged caches at thresholds
    1.5 (must equal dense greedy), 0.4 and -0.1, and with an oracle set
    that forces exits (frozen SSD states, shifted conv windows); then
    ``ServingEngine`` blocking and with ``prefill_chunk=64`` (falls back to
    whole-prompt admission), draft and oracle sets, against the plain
    blocking dense run."""
    import numpy as np
    from repro_torch import kernels as K
    from repro_torch.api import DenseStrategy, Engine, SpecEEStrategy
    from repro_torch.core import engine as eng
    from repro_torch.models.model import ModelFlags, build_model
    run = mamba(4, "float32", max_batch=4, max_seq_len=512, page_size=PAGE)
    m_plain = build_model(run, ModelFlags(exit_gate_impl="ref"))
    m_ker = build_model(run, ModelFlags(**MAMBA_KERNELS))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = m_plain.init(gen, dev)
    sw = eng.init_specee(m_plain, gen, dev)
    # 100 tokens: one whole 64-token chunk and a ragged one
    prompts = np.random.default_rng(6).integers(0, M_V, (B, 100))

    def summary(results):
        return [(r.tokens.tolist(), r.exit_layer.tolist(), r.exited.tolist(),
                 r.units_run) for r in results]

    dense = summary(drive(m_plain, params, sw, DenseStrategy(), prompts, 9))
    for cache in ("dense", "paged"):
        for label, strat in (("threshold 1.5", SpecEEStrategy(1.5)),
                             ("threshold 0.4", SpecEEStrategy(0.4)),
                             ("threshold -0.1", SpecEEStrategy(-0.1)),
                             ("oracle set", oracle_strategy(-0.1))):
            K.reset_launches()
            a = summary(drive(m_ker, params, sw, strat, prompts, 9,
                              cache=cache))
            launched = {k: K.LAUNCHES[k] for k in MAMBA_PATH}
            b = summary(drive(m_plain, params, sw, strat, prompts, 9,
                              cache=cache))
            _same_streams(torch, m_plain, params, prompts, a, b,
                          f"mamba2 {cache} cache, {label}")
            require(all(launched.values()), f"mamba2 {label}: kernels not "
                    f"launched: {launched}")
            require(launched["ssd_chunk"] == 4, "mamba2: ssd_chunk "
                    f"launched {launched['ssd_chunk']} times in one prefill "
                    "of 4 layers")
            exits = sum(sum(x) for _, _, x, _ in a[1:])
            if label == "threshold 1.5":
                require([r[0] for r in a] == [r[0] for r in dense],
                        "mamba2 at threshold 1.5 differs from dense greedy")
            if label == "oracle set":
                require(exits > 0, "mamba2: the oracle set forced no exit")
            log("parity", f"mamba2 {cache} cache, {label}: 8 steps, tokens/"
                f"exit points/exits identical with kernels and plain "
                f"versions ({exits} exits"
                + ("; equals dense greedy" if label == "threshold 1.5"
                   else "") + "; launches " + ", ".join(
                    f"{k} {v}" for k, v in launched.items()) + ")")

    # megaticks: 8 ticks as 2 of MEGA_K, held to the single steps
    for label, strat in (("threshold -0.1", SpecEEStrategy(-0.1)),
                         ("oracle set", oracle_strategy(-0.1))):
        want = drive(m_ker, params, sw, strat, prompts, 9)
        K.reset_launches()
        session = Engine.create(m_ker, params, sw,
                                strategy=strat).new_session()
        first = session.prefill(prompts, max_new_tokens=9)
        megas = []
        while not session.all_done():
            megas.append(session.step(num_ticks=MEGA_K))
        launched = {k: K.LAUNCHES[k] for k in MAMBA_PATH}
        require(all(launched.values()), f"mamba2 megaticks ({label}): "
                f"kernels not launched: {launched}")
        got = _tick_planes(megas)
        require(np.array_equal(first.tokens, want[0].tokens)
                and got == _tick_planes(want[1:]),
                f"mamba2 megaticks ({label}) differ from single steps")
        exits = sum(sum(e) for _, _, e, _ in got[0])
        log("parity", f"mamba2 dense cache, {label}: {len(megas)} "
            f"megaticks of K={MEGA_K} identical to {len(got[0])} single "
            f"steps with the kernels (tokens, exit points, exits; units_run "
            f"{got[1]}; {exits} exits)")

    rng = np.random.default_rng(7)
    sprompts = [rng.integers(0, M_V, int(n)) for n in rng.integers(20, 201, 8)]
    for set_name, strat in (("draft", SpecEEStrategy(threshold=-0.1)),
                            ("oracle", oracle_strategy(-0.1))):
        want = _serve(m_plain, params, sw, sprompts, 8, strategy=strat,
                      fused_gate=False, cache="dense", prefill_chunk=0)
        for cache, chunk in (("paged", 0), ("paged", 64), ("dense", 64)):
            K.reset_launches()
            got = _serve(m_ker, params, sw, sprompts, 8, strategy=strat,
                         fused_gate=True, cache=cache, prefill_chunk=chunk)
            require(K.LAUNCHES["ssd_chunk"] == 8 * 4, "mamba2 serving: "
                    f"ssd_chunk launched {K.LAUNCHES['ssd_chunk']} times for "
                    "8 whole-prompt admissions of 4 layers")
            for i, ((out, eps), (out_w, eps_w)) in enumerate(zip(got, want)):
                if out != out_w:
                    j = next(j for j, (a, b) in enumerate(zip(out, out_w))
                             if a != b)
                    margin, _ = top2_margin(torch, m_plain, params,
                                            list(sprompts[i]) + out_w[:j])
                    raise AssertionError(
                        f"mamba2 serving ({set_name} set, {cache}, chunk "
                        f"{chunk}): request {i} token {j} is {out[j]}, plain "
                        f"gives {out_w[j]}; top-2 logit margin {margin:.3g}")
                require(eps == eps_w, f"mamba2 serving ({set_name} set, "
                        f"{cache}, chunk {chunk}): request {i} exit points")
        exits = sum(e < m_ker.num_exit_points for _, eps in want for e in eps)
        require(set_name == "draft" or exits > 0,
                "mamba2 serving: the oracle set forced no exit")
        log("parity", f"mamba2 serving, {set_name} set: 8 requests through "
            "4 slots, per-request tokens and exit points identical for "
            "paged blocking, paged and dense 64-token chunks (whole-prompt "
            f"fallback) and the plain dense blocking run ({exits} exits); "
            "every page returned")
    del params, sw


def mamba_phase(torch, dev):
    """Phase 9: mamba2-130m at published size (24 layers, bf16, seeded):
    whole-batch AR SpecEE (B=4, 128-token prompts, 32 steps, dense cache)
    and ``ServingEngine(cache="paged")`` (max_batch 8, 16 requests with
    prompts of 64-512 tokens, 32 new tokens each; the default 512-token
    chunked admission falls back to whole prompts). Each run zeroes the
    launch counts right before it and reads them right after."""
    import numpy as np
    from repro_torch import kernels as K
    from repro_torch.api import DenseStrategy, Engine, SpecEEStrategy
    from repro_torch.core import engine as eng
    from repro_torch.models.model import ModelFlags, build_model
    from repro_torch.serving import ServingEngine
    model = build_model(mamba(24, "bfloat16"), ModelFlags(**MAMBA_KERNELS))
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(8)
    params = model.init(gen, dev)
    sw = eng.init_specee(model, gen, dev)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    n_draft = sum(x.numel() for x in _leaves(sw))
    log("mamba", f"mamba2-130m 24 layers bf16: {n_params / 1e6:.1f} M "
        f"params (+{n_draft / 1e6:.1f} M draft and predictors) seeded on "
        f"the card in {time.perf_counter() - t0:.1f} s")
    prompts = np.random.default_rng(12).integers(0, M_V, (B, FULL_PROMPT))
    torch.cuda.reset_peak_memory_stats()

    K.reset_launches()                     # ---- the main path ----
    session = Engine.create(model, params, sw,
                            strategy=SpecEEStrategy()).new_session()
    t0 = time.perf_counter()
    first = session.prefill(prompts, max_new_tokens=FULL_STEPS + 1)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    steps = []
    t0 = time.perf_counter()
    for _ in range(FULL_STEPS):
        steps.append(session.step())
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)            # ---- read right after ----

    require(session.all_done(), "mamba2 session not done after the budget")
    toks = np.stack([r.tokens[:, 0] for r in [first] + steps], 1)
    require(toks.shape == (B, FULL_STEPS + 1), f"token shape {toks.shape}")
    require(((toks >= 0) & (toks < M_V)).all(), "token out of vocabulary")
    require(bool(torch.isfinite(session._state.h_last.float()).all()),
            "non-finite hidden state")
    require(launches["ssd_chunk"] == model.num_exit_points,
            f"ssd_chunk launched {launches['ssd_chunk']} times in one "
            "whole-batch prefill of 24 layers")
    missing = [k for k in MAMBA_PATH if launches[k] == 0]
    require(not missing, f"kernels never launched on the mamba2 path: "
            f"{missing}")
    exits = sum(int(r.exited.sum()) for r in steps)
    units = [r.units_run for r in steps]
    log("mamba", f"whole batch: prefill {B}x{FULL_PROMPT} in "
        f"{t_prefill:.3f} s; {FULL_STEPS} steps in {t_decode:.3f} s = "
        f"{B * FULL_STEPS / t_decode:.2f} tokens/s "
        f"({t_decode / FULL_STEPS * 1e3:.2f} ms/step); exits per token "
        f"{exits / (B * FULL_STEPS):.4f}; mean units_run "
        f"{sum(units) / len(units):.2f} of {model.num_exit_points}; peak "
        f"card memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log("mamba", "whole batch launches: " + ", ".join(
        f"{k} {launches[k]} ({launches[k] / FULL_STEPS:.2f}/step)"
        for k in MAMBA_PATH))
    if exits == 0:
        dense = drive(model, params, sw, DenseStrategy(), prompts,
                      FULL_STEPS + 1)
        require(np.array_equal(np.stack([r.tokens[:, 0] for r in dense], 1),
                               toks), "mamba2 run differs from dense greedy")
        log("mamba", "no row exited: tokens equal dense greedy decoding")
    del session
    profile_steps(torch, model, params, sw, prompts, t_decode / FULL_STEPS,
                  phase="profile-mamba")

    srun = mamba(24, "bfloat16", max_batch=SERVE_BATCH,
                 max_seq_len=SERVE_SEQ, page_size=PAGE)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    se = ServingEngine(build_model(srun, ModelFlags(**MAMBA_KERNELS)),
                       params, sw, cache="paged")
    mgr = se.session.cache_mgr
    sprompts = serve_prompts(M_V)
    admit_s = [0.0]
    tick = se.scheduler.tick

    def timed_tick(*a, **kw):                # admission time, synced
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tick(*a, **kw)
        torch.cuda.synchronize()
        admit_s[0] += time.perf_counter() - t0
        return out

    se.scheduler.tick = timed_tick
    ticks = 0
    K.reset_launches()                       # ---- the main path ----
    t0 = time.perf_counter()
    reqs = [se.submit(p, max_new_tokens=SERVE_NEW) for p in sprompts]
    while se.busy:
        se.step()
        ticks += 1
        require(ticks <= 10_000, "mamba2 serving did not finish")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    s_launches = dict(K.LAUNCHES)            # ---- read right after ----
    del se.scheduler.tick

    require(all(r.done and len(r.output) == SERVE_NEW for r in reqs),
            "a mamba2 request did not finish with its 32 tokens")
    require(all(0 <= t < M_V for r in reqs for t in r.output),
            "token out of vocabulary")
    require(mgr.free_pages == mgr.num_pages, "pages not returned")
    require(s_launches["ssd_chunk"] == SERVE_REQS * 24,
            f"ssd_chunk launched {s_launches['ssd_chunk']} times for "
            f"{SERVE_REQS} whole-prompt admissions of 24 layers")
    missing = [k for k in MAMBA_PATH if s_launches[k] == 0]
    require(not missing, f"kernels never launched on the mamba2 serving "
            f"path: {missing}")
    tokens = sum(len(r.output) for r in reqs)
    decode_ticks = sum(len(r.exit_points) for r in reqs)
    exits = sum(e < model.num_exit_points for r in reqs
                for e in r.exit_points)
    state_gb = sum(x.numel() * x.element_size() for x in _leaves(
        se.session._state.cache["segments"])) / 1e9
    log("mamba", f"serve: {SERVE_REQS} requests (prompts "
        f"{min(map(len, sprompts))}-{max(map(len, sprompts))} tokens, "
        f"{SERVE_NEW} new each) through {SERVE_BATCH} slots in {wall:.3f} s "
        f"= {SERVE_REQS / wall:.3f} requests/s, {tokens / wall:.2f} "
        f"tokens/s; {ticks} ticks, {wall / ticks * 1e3:.2f} ms/tick "
        f"({(wall - admit_s[0]) / ticks * 1e3:.2f} ms/tick without "
        f"admission); admission (prefill) {admit_s[0]:.3f} s; exits per "
        f"token {exits / max(decode_ticks, 1):.4f}; SSD state + conv "
        f"{state_gb:.3f} GB, no page pool; peak card memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    log("mamba", "serve launches: " + ", ".join(
        f"{k} {s_launches[k]} ({s_launches[k] / ticks:.2f}/tick)"
        for k in MAMBA_PATH))
    del se
    se = ServingEngine(build_model(srun, ModelFlags(**MAMBA_KERNELS)),
                       params, sw, cache="paged")
    for p in sprompts[:SERVE_BATCH]:
        se.submit(p, max_new_tokens=8)
    lens = sorted(len(p) for p in sprompts[:SERVE_BATCH])
    profile_ticks(torch, "profile-mamba-admission", se.step, 1,
                  f" (one tick admitting {SERVE_BATCH} prompts of "
                  f"{lens[0]}-{lens[-1]} tokens, {SERVE_BATCH * 24} "
                  f"ssd_chunk launches)")
    se.step()
    torch.cuda.synchronize()
    profile_ticks(torch, "profile-mamba-serve", se.step, 4)
    del se
    return ({"mamba_whole_batch": launches, "mamba_serve": s_launches},
            {"model": model, "params": params, "sw": sw, "prompts": prompts,
             "steps": steps, "t_decode": t_decode,
             "serve": [(r.output, r.exit_points) for r in reqs],
             "serve_wall": wall, "serve_ticks": ticks})


# ---------------------------------------------------------------------------
# phase 10: megaticks at published width
# ---------------------------------------------------------------------------
def _tick_planes(results):
    """Per-tick (tokens, exit points, exits, accept lengths) of every row,
    and units_run summed, from single-step or megatick results, for
    whole-batch runs where every row is live on every tick."""
    ticks, units = [], 0
    for r in results:
        units += int(r.units_run)
        if not r.is_megatick:
            ticks.append(([r.row_tokens(b) for b in range(B)],
                          r.exit_layer.tolist(), r.exited.tolist(),
                          r.accept_len.tolist()))
            continue
        require(bool(r.tick_live[:, :r.ticks].all()), "a row left the batch")
        off = [0] * B
        for t in range(r.ticks):
            toks = []
            for b in range(B):
                n = int(r.tick_counts[b, t])
                toks.append([int(x) for x in r.tokens[b, off[b]:off[b] + n]])
                off[b] += n
            ticks.append((toks, r.exit_layer[:, t].tolist(),
                          r.exited[:, t].tolist(),
                          r.accept_len[:, t].tolist()))
    return ticks, units


def _mega_whole_batch(torch, label, model, params, sw, strategy, prompts,
                      budget, ref, path, vocab, pairs=False):
    """A whole-batch session stepped as megaticks of MEGA_K ticks, as many
    ticks as ``ref`` (an earlier phase's single steps on the same weights,
    prompts and kernels); its tokens and per-tick planes must equal
    ``ref``'s bit for bit. With ``pairs`` the same session is also run as
    single steps before and after, and the megaticks once more (single,
    megatick, megatick, single), each bit-identical to ``ref``, so the
    times compare within this phase. Returns the launches of the first
    megatick run."""
    from repro_torch import kernels as K
    from repro_torch.api import Engine
    n_ticks = len(ref["steps"])
    want = _tick_planes(ref["steps"])

    def run(ticks):
        torch.cuda.synchronize()
        K.reset_launches()                   # ---- the main path ----
        session = Engine.create(model, params, sw,
                                strategy=strategy).new_session()
        session.prefill(prompts, max_new_tokens=budget)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = [session.step(num_ticks=ticks)
               for _ in range(n_ticks // ticks)]
        torch.cuda.synchronize()
        t_decode = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)          # ---- read right after ----
        got = _tick_planes(res)
        require(len(got[0]) == n_ticks, f"{label}: {len(got[0])} ticks ran, "
                f"expected {n_ticks}")
        for t, (g, w) in enumerate(zip(got[0], want[0])):
            require(g == w, f"{label}, {ticks} tick(s) a call: tick {t} "
                    f"differs from the single steps (tokens, exit points, "
                    f"exits, accept lengths): {g} vs {w}")
        require(got[1] == want[1], f"{label}: units_run {got[1]} vs "
                f"{want[1]}")
        require(all(0 <= x < vocab for r in res for b in range(B)
                    for x in r.row_tokens(b)), "token out of vocabulary")
        return launches, t_decode, sum(int(r.counts.sum()) for r in res)

    order = (1, MEGA_K, MEGA_K, 1) if pairs else (MEGA_K,)
    times = {1: [], MEGA_K: []}
    launches = None
    for ticks in order:
        got_launches, t_decode, tokens = run(ticks)
        times[ticks].append(t_decode)
        if ticks == MEGA_K and launches is None:
            launches = got_launches
    missing = [k for k in path if launches[k] == 0]
    require(not missing, f"{label}: kernels never launched: {missing}")

    def rate(t):
        return (f"{t:.3f} s = {t / n_ticks * 1e3:.2f} ms/tick, "
                f"{tokens / t:.2f} tokens/s, {t / tokens * 1e3:.3f} ms/token")

    log("mega", f"{label}: {n_ticks // MEGA_K} megaticks of {MEGA_K} = "
        f"{n_ticks} ticks bit-identical to its phase's single steps "
        f"(tokens, exit points, exits, accept lengths; units_run {want[1]})"
        + (f", and so are this phase's single steps and second megatick "
           f"run (order: single, megatick, megatick, single)" if pairs
           else "") + "; megaticks " + "; ".join(map(rate, times[MEGA_K]))
        + "".join(f"; single steps here {rate(t)}" for t in times[1])
        + f"; single steps in its phase {rate(ref['t_decode'])}")
    log("mega", f"{label} launches: " + ", ".join(
        f"{k} {launches[k]} ({launches[k] / n_ticks:.2f}/tick)"
        for k in path))
    return launches


def _mega_serve(torch, label, model, params, sw, prompts, vocab, path,
                chunk, megatick=MEGA_K):
    """``ServingEngine(megatick=megatick)`` (async when megatick > 1) on
    the paged cache with ``prefill_chunk=chunk``. Returns (launches,
    per-request (output, exit points), wall s, step() calls)."""
    from repro_torch import kernels as K
    from repro_torch.serving import ServingEngine
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    se = ServingEngine(model, params, sw, cache="paged", prefill_chunk=chunk,
                       megatick=megatick)
    require(se.async_ticks == (megatick > 1),
            "async ticks not on exactly when megatick > 1")
    mgr = se.session.cache_mgr
    calls = 0
    K.reset_launches()                       # ---- the main path ----
    t0 = time.perf_counter()
    reqs = [se.submit(p, max_new_tokens=SERVE_NEW) for p in prompts]
    while se.busy:
        se.step()
        calls += 1
        require(calls <= 10_000, f"{label} did not finish")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)              # ---- read right after ----
    require(not se.in_flight, f"{label}: a megatick left in flight")
    require(all(r.done and len(r.output) == SERVE_NEW for r in reqs),
            f"{label}: a request did not finish with its 32 tokens")
    require(all(0 <= t < vocab for r in reqs for t in r.output),
            "token out of vocabulary")
    require(mgr.free_pages == getattr(mgr, "num_pages", 0),
            f"{label}: {mgr.free_pages} pages free at the end")
    missing = [k for k in path if launches[k] == 0]
    require(not missing, f"{label}: kernels never launched: {missing}")
    tokens = sum(len(r.output) for r in reqs)
    row_ticks = sum(len(r.exit_points) for r in reqs)
    log("mega", f"{label}, megatick={megatick}: {len(reqs)} requests "
        f"through {SERVE_BATCH} slots in {wall:.3f} s = "
        f"{len(reqs) / wall:.3f} requests/s, {tokens / wall:.2f} tokens/s; "
        f"{calls} step() calls, {wall / calls * 1e3:.2f} ms/call; "
        f"{row_ticks} row ticks; peak card memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; every page "
        f"returned")
    if megatick > 1:
        log("mega", f"{label} launches: " + ", ".join(
            f"{k} {launches[k]} ({launches[k] / calls:.2f}/call)"
            for k in path))
    return launches, [(r.output, r.exit_points) for r in reqs], wall, calls


def mega_phase(torch, dev, params, sw, ar_ref, fp_serve, tree_ref,
               mamba_ref):
    """Phase 10: megaticks of MEGA_K ticks at published width, on phase 4's
    llama2-7b weights (bf16) and phase 9's mamba2-130m ones. Whole-batch
    SpecEE, tree and mamba2 sessions must be bit-identical to phases 4, 6
    and 9's single steps (the same kernels on the same batch in the same
    order); ServingEngine(megatick=MEGA_K) on phase 5's 16 requests is
    compared with phase 5's blocking run (the batch mix per tick differs,
    so bf16 near-ties may flip: each differing request is logged with its
    top-2 margin), and mamba2 serving with phase 9's; then torch.profiler
    over 4 single steps and over 1 megatick of a whole-batch session. The
    AR and tree sessions also run as single steps before and after their
    megaticks, and the AR serve per tick right after, so the times compare
    in turns."""
    from repro_torch.api import SpecEEStrategy
    from repro_torch.models.model import ModelFlags, build_model
    by_path = {}
    model = build_model(llama(32, "bfloat16"), ModelFlags(
        exit_gate_kernel=True, exit_gate_impl="kernel", decode_kernel=True))
    by_path["mega_whole_batch"] = _mega_whole_batch(
        torch, "AR whole batch", model, params, sw, SpecEEStrategy(),
        ar_ref["prompts"], FULL_STEPS + 1, ar_ref, AR_PATH, V, pairs=True)
    torch.cuda.empty_cache()
    tree = tree_strategy().tree
    by_path["mega_tree"] = _mega_whole_batch(
        torch, "tree whole batch",
        build_model(llama(32, "bfloat16"), ModelFlags(**TREE_KERNELS)),
        params, sw, tree_strategy(), tree_ref["prompts"],
        (TREE_STEPS + 4) * (tree.depth + 1), tree_ref, TREE_PATH, V,
        pairs=True)
    torch.cuda.empty_cache()

    srun = llama(32, "bfloat16", max_batch=SERVE_BATCH, max_seq_len=SERVE_SEQ,
                 page_size=PAGE)
    smodel = build_model(srun, ModelFlags(**ALL_KERNELS))
    launches, outs, wall, calls = _mega_serve(
        torch, "AR serve", smodel, params, sw, serve_prompts(), V,
        SERVE_PATH + ("flash_attention",), 0)
    by_path["mega_serve"] = launches
    # the per-tick engine again, right after, for a comparison in turns
    _, outs1, wall1, calls1 = _mega_serve(
        torch, "AR serve", smodel, params, sw, serve_prompts(), V,
        SERVE_PATH + ("flash_attention",), 0, megatick=1)
    st = fp_serve["blocking_stats"]
    log("mega", f"AR serve, megatick={MEGA_K} against megatick=1 here and "
        f"phase 5's blocking run: {SERVE_REQS / wall:.3f} vs "
        f"{SERVE_REQS / wall1:.3f} and {SERVE_REQS / st['wall']:.3f} "
        f"requests/s; {calls} calls of {wall / calls * 1e3:.2f} ms vs "
        f"{calls1} of {wall1 / calls1 * 1e3:.2f} and {st['ticks']} of "
        f"{st['wall'] / st['ticks'] * 1e3:.2f} ms")
    differ = [i for i, (a, b) in enumerate(zip(fp_serve["blocking"], outs1))
              if a != b]
    log("mega", f"AR serve, megatick=1: requests whose tokens or exit "
        f"points differ from phase 5's blocking run: {differ or 'none'}")
    flip_margins(torch, params, fp_serve["blocking"], outs, "mega",
                 "phase 5's blocking run and the megatick one")

    # device busy against wall time over 1 megatick, and over as many
    # single steps right before (the host's speed drifts between phases)
    from repro_torch.api import Engine
    for ticks, note in ((1, "single steps, before the megaticks"),
                        (MEGA_K, f"one call: a megatick of {MEGA_K} steps")):
        session = Engine.create(model, params, sw,
                                strategy=SpecEEStrategy()).new_session()
        session.prefill(ar_ref["prompts"], max_new_tokens=5 * MEGA_K + 1)
        session.step(num_ticks=MEGA_K)
        torch.cuda.synchronize()
        profile_ticks(torch, "profile-mega",
                      lambda: session.step(num_ticks=ticks),
                      MEGA_K // ticks, f" ({note})")
        del session
    torch.cuda.empty_cache()

    m = mamba_ref
    by_path["mega_mamba_whole_batch"] = _mega_whole_batch(
        torch, "mamba2 whole batch", m["model"], m["params"], m["sw"],
        SpecEEStrategy(), m["prompts"], FULL_STEPS + 1, m, MAMBA_PATH, M_V)
    msrun = mamba(24, "bfloat16", max_batch=SERVE_BATCH,
                  max_seq_len=SERVE_SEQ, page_size=PAGE)
    launches, outs, wall, calls = _mega_serve(
        torch, "mamba2 serve", build_model(msrun, ModelFlags(**MAMBA_KERNELS)),
        m["params"], m["sw"], serve_prompts(M_V), M_V, MAMBA_PATH, None)
    by_path["mega_mamba_serve"] = launches
    differ = [i for i, (a, b) in enumerate(zip(m["serve"], outs)) if a != b]
    log("mega", f"mamba2 serve against phase 9's: {SERVE_REQS / wall:.3f} vs "
        f"{SERVE_REQS / m['serve_wall']:.3f} requests/s; {calls} calls of "
        f"{wall / calls * 1e3:.2f} ms vs {m['serve_ticks']} of "
        f"{m['serve_wall'] / m['serve_ticks'] * 1e3:.2f} ms; requests whose "
        f"tokens or exit points differ: {differ or 'none'}")
    return by_path


# ---------------------------------------------------------------------------
# phase 11: a SpecEE bundle trained on the card with the port alone
# ---------------------------------------------------------------------------
# the recipe of benchmarks/common.py::get_bundle, stage by stage
TRAIN_STEPS, DRAFT_STEPS, PRED_STEPS, EXIT_NEW = 30, 250, 300, 12
DRAFT_BATCHES, PRED_BATCHES = 8, 4
# (a): llama2-7b at published width, 2 of its 32 layers (fp32 params with
# AdamW's m and v at 32 layers would not fit one card), batches of 4 x 256;
# (b): get_bundle's own config, the smoke config deepened to 12 layers,
# its batches 4 x 32
TRAINED_A_LAYERS, TRAINED_A_SEQ = 2, 256
TRAINED_B_LAYERS, TRAINED_B_SEQ = 12, 32
TRAINED_PROMPT, TRAINED_NEW, TRAINED_RUNS = 128, 32, 3
TRAINED_PATH = tuple(dict.fromkeys(AR_PATH + TREE_PATH))
AR_KERNELS = dict(exit_gate_kernel=True, exit_gate_impl="kernel",
                  decode_kernel=True)


def bundle_b_run():
    """get_bundle's config: llama2-7b's smoke config with 12 layers."""
    from repro_torch.core.bundle import bundle_run
    return bundle_run("llama2-7b", TRAINED_B_LAYERS)


def train_bundle(torch, dev, label: str, run, seq: int):
    """get_bundle's recipe with the port's modules alone
    (``repro_torch.core.bundle.train_bundle``): the target for TRAIN_STEPS
    ``TrainLoop`` steps on the pipeline (seed 0), the draft against it for
    DRAFT_STEPS steps over DRAFT_BATCHES batches of 4 x ``seq`` (pipeline
    seed 0), features over the first PRED_BATCHES of them, the predictors
    for PRED_STEPS steps, offline exit counts over the first batch with
    EXIT_NEW new tokens on the AR kernel path, and the offline mask from
    them. Each stage's time, losses and metrics are logged; a loss that
    does not fall, predictors below the trivial rate or a tensor that left
    the card fails the phase. Returns (params, sw)."""
    from repro_torch.core.bundle import train_bundle as train

    def on_card(what, tree):
        require(all(x.is_cuda for x in _leaves(tree)),
                f"{label}: {what} left the card")

    params, sw, st = train(run, dev, seq, train_steps=TRAIN_STEPS,
                           draft_steps=DRAFT_STEPS,
                           draft_batches=DRAFT_BATCHES,
                           pred_batches=PRED_BATCHES, pred_steps=PRED_STEPS,
                           exit_new=EXIT_NEW, inspect=on_card)
    tg, dm, pm, off = st["target"], st["draft"], st["predictors"], \
        st["offline"]
    losses, step_ms = tg["losses"], tg["step_ms"]
    log("trained", f"{label}: target {run.model.param_count() / 1e9:.3f} B "
        f"params, {TRAIN_STEPS} TrainLoop steps of {run.train.global_batch}x"
        f"{run.train.seq_len} in {tg['seconds']:.1f} s (init included), "
        f"median {sorted(step_ms)[len(step_ms) // 2]:.1f} ms/step (first "
        f"{step_ms[0]:.1f}); loss {losses[0]:.4f} -> {losses[-1]:.4f}; peak "
        f"card memory {tg['peak_bytes'] / 1e9:.2f} GB")
    require(losses[-1] < losses[0], f"{label}: target loss did not fall "
            f"({losses[0]:.4f} -> {losses[-1]:.4f})")
    n_draft = sum(x.numel() for x in _leaves(sw.draft))
    log("trained", f"{label}: draft {n_draft / 1e6:.1f} M params, "
        f"{DRAFT_STEPS} steps over {DRAFT_BATCHES} batches of 4x{seq} in "
        f"{dm['seconds']:.1f} s = {dm['seconds'] / DRAFT_STEPS * 1e3:.2f} "
        f"ms/step (hit rate included); loss {dm['first_loss']:.4f} -> "
        f"{dm['final_loss']:.4f}; "
        f"top-{run.specee.num_speculative} hit rate {dm['topk_hit_rate']:.4f}")
    require(dm["final_loss"] < dm["first_loss"],
            f"{label}: draft loss did not fall")
    pos = pm["positive_rate"]
    log("trained", f"{label}: features {pm['features_shape']} in "
        f"{pm['collect_seconds']:.2f} s; predictors {PRED_STEPS} steps in "
        f"{pm['seconds']:.2f} s = {pm['seconds'] / PRED_STEPS * 1e3:.2f} "
        f"ms/step; loss {pm['first_loss']:.4f} -> {pm['final_loss']:.4f}; "
        f"accuracy {pm['accuracy']:.4f}, positive rate {pos:.4f} (by exit "
        f"point: {', '.join(f'{p:.3f}' for p in pm['per_exit'])})")
    require(pm["final_loss"] < pm["first_loss"],
            f"{label}: predictor loss did not fall")
    require(pm["accuracy"] >= max(pos, 1 - pos) - 0.02,
            f"{label}: predictor accuracy {pm['accuracy']:.4f} below the "
            f"trivial rate {max(pos, 1 - pos):.4f} - 0.02")
    log("trained", f"{label}: offline exit counts over 4x{seq} prompts, "
        f"{EXIT_NEW} new tokens, every predictor on, in "
        f"{off['seconds']:.2f} s: {off['counts']} (last = full "
        f"depth); offline mask {off['mask']}")
    return params, sw


def _decode_once(torch, model, params, sw, strategy, prompts):
    """One whole-batch session: prefill, then steps to the budget. Returns
    (per-row tokens (B, TRAINED_NEW), decode seconds, the steps)."""
    import numpy as np
    from repro_torch.api import Engine
    session = Engine.create(model, params, sw,
                            strategy=strategy).new_session()
    first = session.prefill(prompts, max_new_tokens=TRAINED_NEW)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = []
    while not session.all_done():
        steps.append(session.step())
        require(len(steps) <= TRAINED_NEW, "decode did not finish")
    torch.cuda.synchronize()
    dt_s = time.perf_counter() - t0
    rows = [first.row_tokens(r) + [t for s in steps for t in s.row_tokens(r)]
            for r in range(prompts.shape[0])]
    require(all(len(r) == TRAINED_NEW for r in rows),
            "a row did not emit its budget")
    return np.array(rows), dt_s, steps


def trained_decode(torch, dev, label: str, model_run, params, sw, prompts):
    """Dense, SpecEE (the AR kernels) and tree (the tree kernels) with the
    trained bundle, in turns, TRAINED_RUNS runs each: tokens/s, mean
    units_run, the histogram of exit points over tokens, the share of
    tokens equal to dense and the tree's mean accepted length. A second
    SpecEE run must emit the first's tokens."""
    import numpy as np
    from repro_torch.api import DenseStrategy, SpecEEStrategy
    from repro_torch.models.model import ModelFlags, build_model
    ar = build_model(model_run, ModelFlags(**AR_KERNELS))
    tree = build_model(model_run, ModelFlags(**TREE_KERNELS))
    E = ar.num_exit_points
    modes = (("dense", ar, DenseStrategy()), ("specee", ar, SpecEEStrategy()),
             ("tree", tree, tree_strategy()))
    runs = {name: [] for name, _, _ in modes}
    for _ in range(TRAINED_RUNS):
        for name, model, strat in modes:
            runs[name].append(_decode_once(torch, model, params, sw, strat,
                                           prompts))
    dense = runs["dense"][0][0]
    B = prompts.shape[0]
    for name, _, _ in modes:
        toks, _, steps = runs[name][0]
        rates = [(B * TRAINED_NEW - B) / r[1] for r in runs[name]]
        live = [s.counts > 0 for s in steps]
        pts = np.concatenate([s.exit_layer[m] for s, m in zip(steps, live)])
        hist = np.bincount(np.minimum(pts, E), minlength=E + 1)
        exits = sum(int(s.exited[m].sum()) for s, m in zip(steps, live))
        emitted = sum(int(s.counts.sum()) for s in steps)
        units = float(np.mean([s.units_run for s in steps]))
        same = float((toks == dense).mean())
        acc = (float(np.mean(np.concatenate(
            [s.accept_len[m] for s, m in zip(steps, live)])))
            if name == "tree" else 0.0)
        log("trained", f"{label} {name}: tokens/s "
            f"{', '.join(f'{r:.2f}' for r in rates)} (runs in turns, "
            f"{B}x{TRAINED_PROMPT} prompts, {TRAINED_NEW} tokens a row, "
            f"{len(steps)} steps); mean units_run {units:.2f} of {E}; exits "
            f"per token {exits / emitted:.4f}; exit points over tokens "
            f"{hist.tolist()} (last = full depth); share of tokens equal to "
            f"dense {same:.4f}; {np.unique(toks).size} distinct tokens "
            f"emitted" + (f"; mean accepted length {acc:.3f}"
                          if name == "tree" else ""))
    spec = [r[0] for r in runs["specee"]]
    require(all(np.array_equal(spec[0], t) for t in spec[1:]),
            f"{label}: a second SpecEE run emitted other tokens")
    same_tree = all(np.array_equal(runs["tree"][0][0], r[0])
                    for r in runs["tree"][1:])
    log("trained", f"{label}: SpecEE runs identical; tree runs identical: "
        f"{same_tree}")


def trained_phase(torch, dev):
    """Phase 11: bundles (a) and (b) trained on the card, then decoded
    with: (a) in fp32 and cast to bf16, (b) in fp32. The launch counts are
    zeroed right before the first stage and read right after the last
    decode: training itself launches no kernel (the port's kernels have no
    backward); the offline exit counts and the decodes launch the AR and
    tree kernels."""
    import dataclasses
    import math
    from repro_torch import kernels as K
    from repro_torch.data import DataPipeline
    from repro_torch.models.common import tree_map
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run_a = llama(TRAINED_A_LAYERS, "float32")
    run_a = dataclasses.replace(run_a, train=dataclasses.replace(
        run_a.train, global_batch=4, seq_len=TRAINED_A_SEQ,
        steps=TRAIN_STEPS))
    run_b = bundle_b_run()
    K.reset_launches()                       # ---- the main path ----
    params, sw = train_bundle(torch, dev, "(a) llama2-7b width, "
                                       f"{TRAINED_A_LAYERS} layers, fp32",
                                       run_a, TRAINED_A_SEQ)
    prompts_a = DataPipeline(run_a.model, B, TRAINED_PROMPT,
                             seed=1).next()["tokens"]
    trained_decode(torch, dev, "(a) fp32", run_a, params, sw, prompts_a)
    bf = torch.bfloat16
    params_bf = tree_map(lambda x: x.to(bf), params)
    sw_bf = sw._replace(draft=tree_map(lambda x: x.to(bf), sw.draft))
    del params
    trained_decode(torch, dev, "(a) bf16", llama(TRAINED_A_LAYERS, "bfloat16"),
                   params_bf, sw_bf, prompts_a)
    del params_bf, sw_bf, sw
    torch.cuda.empty_cache()
    params, sw = train_bundle(torch, dev, "(b) get_bundle's config, "
                                       f"{TRAINED_B_LAYERS} layers, fp32",
                                       run_b, TRAINED_B_SEQ)
    prompts_b = DataPipeline(run_b.model, B, TRAINED_PROMPT,
                             seed=1).next()["tokens"]
    trained_decode(torch, dev, "(b) fp32", run_b, params, sw, prompts_b)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)              # ---- read right after ----
    missing = [k for k in TRAINED_PATH if launches[k] == 0]
    require(not missing, f"kernels never launched on the trained path: "
            f"{missing}")
    log("trained", "launches: " + ", ".join(
        f"{k} {v}" for k, v in launches.items() if v))
    log("trained", f"phase in {time.perf_counter() - t_phase:.1f} s; peak "
        f"card memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del params, sw
    torch.cuda.empty_cache()
    return {"trained": launches}


# ---------------------------------------------------------------------------
# phase 12: the dense-family configs, seeded bf16, one model at a time
# ---------------------------------------------------------------------------
# (arch, layers, the runs): every config at published widths; the four
# that fit the card whole (PERF.md keeps their published-size runs) at
# DF_DEPTH layers since phases 17 and 18 took their time, llama2-70b
# (140 GB of bf16 weights) and command-r-plus-104b (208 GB) with their
# depth cut to what one card holds beside its runs. "int8_head_ar" keeps
# the projections bf16 and makes the LM head and predictors int8: a 15B
# model's bf16 params, its int8 codes and the dequantized projections the
# quantized engine holds (ROADMAP queue 2, item 4) do not fit one card
DF_DEPTH = 4
DF_RUNS = (("llama2-13b", DF_DEPTH, ("ar", "tree", "serve")),
           ("starcoder2-15b", DF_DEPTH, ("ar", "serve", "kvq_serve",
                                         "int8_head_ar")),
           ("deepseek-7b", DF_DEPTH, ("ar",)),
           ("minicpm-2b", DF_DEPTH, ("ar", "tree", "int8_ar")),
           ("llama2-70b", 2, ("ar", "serve")),
           ("command-r-plus-104b", 2, ("ar",)))
DF_STEPS, DF_TREE_STEPS, DF_PARITY_NEW = 32, 8, 8
DF_SERVE_NEW = 16             # new tokens a request in phase 12's serving
DF_AR_PATH = AR_PATH + ("flash_attention",)
DF_SERVE_PATH = SERVE_PATH + ("flash_attention",)


def df_config(name: str, layers, dtype: str, **serve):
    """``name``'s config in ``dtype`` with ``layers`` layers (None: its
    published depth); keyword arguments replace ``ServeConfig`` fields."""
    import dataclasses
    from repro_torch.configs import get_config
    run = get_config(name)
    return dataclasses.replace(
        run, model=dataclasses.replace(
            run.model, dtype=dtype,
            num_layers=layers or run.model.num_layers),
        serve=dataclasses.replace(run.serve, **serve))


def _seeded(torch, dev, run, seed: int):
    from repro_torch.core import engine as eng
    from repro_torch.models.model import build_model
    model = build_model(run)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = model.init(gen, dev)
    return params, eng.init_specee(model, gen, dev)


def df_parity(torch, dev):
    """Each new config at published widths, 2 layers, fp32: SpecEE at
    threshold 0.4 on the dense and the paged cache and tree decoding
    (TreeSpec(3, 3)), with every kernel against the plain paths: tokens
    and exit points identical."""
    import numpy as np
    from repro_torch.api import SpecEEStrategy, TreeStrategy
    from repro_torch.core.tree import TreeSpec
    from repro_torch.models.model import ModelFlags, build_model
    for name, _, _ in DF_RUNS:
        run = df_config(name, 2, "float32", max_seq_len=512, page_size=128)
        params, sw = _seeded(torch, dev, run, 5)
        prompts = np.random.default_rng(2).integers(
            0, run.model.vocab_size, (B, 64))
        notes = []
        for label, strategy, cache, flags in (
                ("AR dense", SpecEEStrategy(threshold=0.4), "dense",
                 ALL_KERNELS),
                ("AR paged", SpecEEStrategy(threshold=0.4), "paged",
                 ALL_KERNELS),
                ("tree", TreeStrategy(tree=TreeSpec(3, 3), threshold=0.4),
                 "dense", TREE_KERNELS)):
            outs = [[(r.tokens.tolist(), r.exit_layer.tolist())
                     for r in drive(build_model(run, ModelFlags(**f)),
                                    params, sw, strategy, prompts,
                                    DF_PARITY_NEW, cache=cache)]
                    for f in (flags, {})]
            require(outs[0] == outs[1], f"{name} {label}: the kernel path "
                    "differs from the plain path (2 layers, fp32)")
            exits = sum(e < 2 for _, el in outs[0][1:] for e in el)
            notes.append(f"{label} {exits} exits")
        log("dense", f"{name} parity at published widths, 2 layers, fp32: "
            f"kernels = plain ({', '.join(notes)})")
        del params, sw
        torch.cuda.empty_cache()


def df_whole_batch(torch, label: str, model, params, sw, strategy, steps,
                   path, quant=None, phase: str = "dense",
                   prompt_len: int = FULL_PROMPT, patches=None, out=None):
    """One whole-batch session (B=4 prompts of ``prompt_len``, dense cache,
    ``steps`` steps; ``patches`` (B, P, 1024) image patches prepended, the
    session then sized for them) with its launch counts zeroed right
    before and read right after; the path's kernels must have launched.
    ``out``: a list that receives each row's emitted tokens."""
    import numpy as np
    from repro_torch import kernels as K
    from repro_torch.api import Engine
    vocab = model.cfg.vocab_size
    prompts = np.random.default_rng(1).integers(0, vocab, (B, prompt_len))
    batch, max_seq = prompts, None
    if patches is not None:
        batch = {"tokens": prompts, "patches": patches}
        max_seq = (patches.shape[1] + prompt_len
                   + steps * strategy.emit_width(model) + 2)
    engine = Engine.create(model, params, sw, strategy=strategy, quant=quant)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()                     # ---- the main path ----
    session = engine.new_session()
    t0 = time.perf_counter()
    first = session.prefill(batch, max_new_tokens=steps * engine.emit_width
                            + 1, max_seq=max_seq)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    res = []
    t0 = time.perf_counter()
    for _ in range(steps):
        res.append(session.step())
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)            # ---- read right after ----
    toks = sum(int(r.counts.sum()) for r in res)
    require(all(((r.tokens >= 0) & (r.tokens < vocab)).all() for r in res),
            f"{label}: token out of vocabulary")
    if out is not None:
        out.extend([first.row_tokens(b) + sum(
            (r.row_tokens(b) for r in res), []) for b in range(B)])
    require(bool(torch.isfinite(session._state.h_last.float()).all()),
            f"{label}: non-finite hidden state")
    missing = [k for k in path if launches[k] == 0]
    require(not missing, f"{label}: kernels never launched: {missing}")
    exits = sum(int(r.exited.sum()) for r in res)
    units = sum(r.units_run for r in res) / steps
    extra = "" if patches is None else f" + {patches.shape[1]} patches"
    log(phase, f"{label}: prefill {B}x{prompt_len}{extra} in "
        f"{t_prefill:.3f} s;"
        f" {steps} steps in {t_decode:.3f} s = {toks / t_decode:.2f} "
        f"tokens/s ({t_decode / steps * 1e3:.2f} ms/step); exits "
        f"{exits}; mean units_run {units:.2f} of {model.num_exit_points}; "
        f"peak card memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB;"
        " launches " + ", ".join(f"{k} {v}" for k, v in launches.items()
                                  if v))
    del session, engine
    return launches


def df_serve(torch, label: str, run, params, sw, path, kv_quant=False,
             phase: str = "dense", n_reqs: int = SERVE_REQS, flags=None):
    """The first ``n_reqs`` of phase 5's 16 requests (DF_SERVE_NEW new
    tokens each, blocking admission) through ServingEngine(cache="paged")
    with max_batch 8 and 4096-token rows of 128-token pages (``flags``:
    further ModelFlags fields); launches zeroed right before the requests
    and read right after the last completes."""
    import dataclasses
    from repro_torch import kernels as K
    from repro_torch.models.model import ModelFlags, build_model
    from repro_torch.serving import ServingEngine
    run = dataclasses.replace(run, serve=dataclasses.replace(
        run.serve, max_batch=SERVE_BATCH, max_seq_len=SERVE_SEQ,
        page_size=PAGE))
    vocab = run.model.vocab_size
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    se = ServingEngine(build_model(run, ModelFlags(**ALL_KERNELS,
                                                   kv_quant=kv_quant,
                                                   **(flags or {}))),
                       params, sw, cache="paged", prefill_chunk=0)
    mgr = se.session.cache_mgr
    prompts = serve_prompts(vocab)[:n_reqs]
    K.reset_launches()                     # ---- the main path ----
    t0 = time.perf_counter()
    reqs = [se.submit(p, max_new_tokens=DF_SERVE_NEW) for p in prompts]
    ticks = 0
    while se.busy:
        se.step()
        ticks += 1
        require(ticks <= 10_000, f"{label}: serving did not finish")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)            # ---- read right after ----
    require(all(r.done and len(r.output) == DF_SERVE_NEW for r in reqs),
            f"{label}: a request did not finish with its tokens")
    require(all(0 <= t < vocab for r in reqs for t in r.output),
            f"{label}: token out of vocabulary")
    require(mgr.free_pages == mgr.num_pages,
            f"{label}: {mgr.free_pages} of {mgr.num_pages} pages free")
    missing = [k for k in path if launches[k] == 0]
    require(not missing, f"{label}: kernels never launched: {missing}")
    tokens = sum(len(r.output) for r in reqs)
    log(phase, f"{label}: {n_reqs} requests through {SERVE_BATCH} "
        f"slots in {wall:.3f} s = {n_reqs / wall:.3f} requests/s, "
        f"{tokens / wall:.2f} tokens/s; {ticks} ticks, "
        f"{wall / ticks * 1e3:.2f} ms/tick; pages free at the end "
        f"{mgr.free_pages} of {mgr.num_pages}; peak card memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
        + ", ".join(f"{k} {v}" for k, v in launches.items() if v))
    del se
    return launches


def dense_family_phase(torch, dev):
    """Phase 12. Returns the launches by path."""
    from repro_torch.api import SpecEEStrategy, TreeStrategy
    from repro_torch.core.tree import TreeSpec
    from repro_torch.models.model import ModelFlags, build_model
    from repro_torch.quant import QuantSpec
    t_phase = time.perf_counter()
    df_parity(torch, dev)
    by_path = {}
    for name, layers, runs in DF_RUNS:
        run = df_config(name, layers, "bfloat16")
        t0 = time.perf_counter()
        params, sw = _seeded(torch, dev, run, 9)
        torch.cuda.synchronize()
        cfg = run.model
        n_params = sum(x.numel() for x in _leaves(params))
        depth = ("published size" if layers is None else
                 f"published widths, {layers} of its "
                 f"{df_config(name, None, 'bfloat16').model.num_layers} "
                 "layers")
        log("dense", f"{name} ({depth}): {n_params / 1e9:.3f} B params, "
            f"{n_params * 2 / 1e9:.1f} GB in bf16, seeded in "
            f"{time.perf_counter() - t0:.1f} s; D={cfg.d_model}, "
            f"{cfg.num_heads} heads over {cfg.num_kv_heads} of "
            f"{cfg.resolved_head_dim()}, V={cfg.vocab_size}, {cfg.norm}, "
            f"{cfg.activation}, bias {cfg.use_bias}, tied "
            f"{cfg.tie_embeddings}")
        for what in runs:
            label = f"{name} {what}"
            if what == "ar":
                got = df_whole_batch(torch, label, build_model(
                    run, ModelFlags(**ALL_KERNELS)), params, sw,
                    SpecEEStrategy(), DF_STEPS, DF_AR_PATH)
            elif what == "tree":
                got = df_whole_batch(torch, label, build_model(
                    run, ModelFlags(**TREE_KERNELS)), params, sw,
                    TreeStrategy(tree=TreeSpec(TREE_DEPTH, TREE_BRANCH)),
                    DF_TREE_STEPS, TREE_PATH)
            elif what in ("int8_ar", "int8_head_ar"):
                spec = QuantSpec(bits=8, proj=what == "int8_ar")
                got = df_whole_batch(torch, label, build_model(
                    run, ModelFlags(**ALL_KERNELS)), params, sw,
                    SpecEEStrategy(), DF_STEPS, quantized(DF_AR_PATH),
                    quant=spec)
                for k in FP_GATE_KERNELS:
                    require(got[k] == 0, f"{label}: {k} ran")
            elif what == "serve":
                got = df_serve(torch, label, run, params, sw, DF_SERVE_PATH)
            else:
                got = df_serve(torch, label, run, params, sw,
                               KVQ_SERVE_PATH + ("flash_attention",),
                               kv_quant=True)
            by_path[f"dense_{name}_{what}"] = got
            torch.cuda.empty_cache()
        del params, sw
        torch.cuda.empty_cache()
    log("dense", f"phase in {time.perf_counter() - t_phase:.1f} s")
    return by_path


# ---------------------------------------------------------------------------
# phase 13: the rest of serving on phase 5's llama2-7b weights
# ---------------------------------------------------------------------------
SAMPLE_T, SAMPLE_K = 0.8, 50
SAMPLE_NEW = 16               # new tokens a sampled serving request
SAMPLE_REQS = 8               # sampled serving's requests (of phase 5's)
SAMPLED_PATH = ("paged_decode_attention", "flash_attention")
CHUNKED_PROMPT = 3000
CANCEL_CHUNK = 256                 # admission chunk of the cancel run


def _sampled_serve(torch, params, sw, seed: int, megatick: int = 1):
    from repro_torch import kernels as K
    from repro_torch.api import DenseStrategy
    from repro_torch.models.model import ModelFlags, build_model
    from repro_torch.serving import ServingEngine
    run = llama(32, "bfloat16", max_batch=SERVE_BATCH, max_seq_len=SERVE_SEQ,
                page_size=PAGE)
    se = ServingEngine(build_model(run, ModelFlags(**ALL_KERNELS)), params,
                       sw, strategy=DenseStrategy(temperature=SAMPLE_T,
                                                  top_k=SAMPLE_K),
                       prng_seed=seed, cache="paged", prefill_chunk=0,
                       megatick=megatick)
    torch.cuda.synchronize()
    K.reset_launches()                     # ---- the main path ----
    t0 = time.perf_counter()
    reqs = [se.submit(p, max_new_tokens=SAMPLE_NEW)
            for p in serve_prompts()[:SAMPLE_REQS]]
    se.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)            # ---- read right after ----
    mgr = se.session.cache_mgr
    require(all(r.done and len(r.output) == SAMPLE_NEW for r in reqs),
            "sampled serving: a request did not finish with its tokens")
    require(mgr.free_pages == mgr.num_pages, "sampled serving: pages leak")
    missing = [k for k in SAMPLED_PATH if launches[k] == 0]
    require(not missing, f"sampled serving: kernels never launched: "
            f"{missing}")
    require(launches["argmax_verify"] == 0 and launches["exit_gate"] == 0,
            "sampled serving ran the greedy verify or the gate")
    return [r.output for r in reqs], wall, launches


def _sampler_card_vs_cpu(torch, logits, keys):
    """Draws of the sampler on the card against the CPU's on the same fp32
    logits and keys: (equal, total); a differing draw must be a near-tie
    of the CPU's perturbed scores (the fp64 noise's logarithms may differ
    by an ulp between the two)."""
    from repro_torch.serving import sampler
    same = total = 0
    lc, kc = logits.float().cpu(), keys.cpu()
    for temperature, top_k in ((1.0, None), (SAMPLE_T, SAMPLE_K)):
        got = sampler.sample_rows(logits.float(), keys, temperature,
                                  top_k).cpu()
        want = sampler.sample_rows(lc, kc, temperature, top_k)
        total += got.numel()
        same += int((got == want).sum())
        for r in torch.nonzero(got != want).flatten().tolist():
            s = (sampler._scale(lc[r:r + 1], temperature, top_k).double()
                 + sampler._gumbel(kc[r:r + 1, None],
                                   torch.arange(lc.shape[1])[None]))[0]
            top2 = torch.topk(s, 2).values
            require(float(top2[0] - top2[1]) < 1e-12 * float(
                top2[0].abs()), f"sampler: row {r} differs from the CPU's "
                "away from a near-tie")
    return same, total


def serving_rest_phase(torch, dev):
    """Phase 13. Returns the launches by path."""
    import numpy as np
    from repro_torch import kernels as K
    from repro_torch.api import DenseStrategy, Engine
    from repro_torch.models.model import ModelFlags, build_model
    from repro_torch.serving import ServingEngine, sampler
    t_phase = time.perf_counter()
    by_path = {}
    params, sw = full_weights(torch, dev)       # phase 5's weights (seed 7)
    model = build_model(llama(32, "bfloat16"), ModelFlags(**ALL_KERNELS))
    sampled = DenseStrategy(temperature=SAMPLE_T, top_k=SAMPLE_K)

    # ---- sampled whole-batch decode: megaticks of 4 = single steps ----
    prompts = np.random.default_rng(1).integers(0, V, (B, FULL_PROMPT))
    outs = {}
    for ticks in (1, MEGA_K):
        s = Engine.create(model, params, sw, strategy=sampled).new_session(
            prng_seed=3)
        first = s.prefill(prompts, max_new_tokens=FULL_STEPS + 1)
        rows = [first.row_tokens(b) for b in range(B)]
        while not s.all_done():
            res = s.step(num_ticks=ticks)
            for b in range(B):
                rows[b].extend(res.row_tokens(b))
        outs[ticks] = rows
        state = s._state
    require(outs[1] == outs[MEGA_K], "sampled decode: megaticks of 4 differ "
            "from single steps")
    logits = model.logits(params, state.h_last)
    keys = sampler.row_keys(3, state.cache["len"], state.last_token)
    same, total = _sampler_card_vs_cpu(torch, logits, keys)
    gen = torch.Generator(device=dev).manual_seed(5)
    rnd_logits = torch.randn((64, V), generator=gen, device=dev) * 4
    rnd_keys = sampler.row_keys(9, torch.arange(64, device=dev),
                                torch.arange(64, device=dev) * 7)
    same2, total2 = _sampler_card_vs_cpu(torch, rnd_logits, rnd_keys)
    log("serve2", f"sampled whole-batch decode (T={SAMPLE_T}, top-k "
        f"{SAMPLE_K}, {B}x{FULL_STEPS} tokens): megaticks of {MEGA_K} emit "
        f"the single steps' tokens; the sampler on the card drew the CPU's "
        f"token for {same} of {total} rows of the model's logits and "
        f"{same2} of {total2} random rows")

    # ---- sampled serving: replay, another seed, megaticks ----
    a, wall_a, launches = _sampled_serve(torch, params, sw, 0)
    by_path["sampled_serve"] = launches
    a2, wall_a2, _ = _sampled_serve(torch, params, sw, 0)
    b, _, _ = _sampled_serve(torch, params, sw, 1)
    m4, wall_m4, launches_m4 = _sampled_serve(torch, params, sw, 0, MEGA_K)
    by_path["sampled_serve_megatick"] = launches_m4
    require(a == a2, "sampled serving: the same seed did not replay")
    n_diff = sum(x != y for x, y in zip(a, b))
    require(n_diff > 0, "sampled serving: another seed drew the same tokens")
    differ_m4 = [i for i, (x, y) in enumerate(zip(a, m4)) if x != y]
    # every tick runs all 8 slots, so a row's numbers do not depend on
    # which rows are beside it, nor on when megaticks admit it
    require(not differ_m4, f"sampled serving: megaticks of {MEGA_K} differ "
            f"from single ticks in requests {differ_m4}")
    n = SAMPLE_REQS
    log("serve2", f"sampled serving, {n} requests x {SAMPLE_NEW} "
        f"tokens: {n / wall_a:.3f} requests/s "
        f"({n * SAMPLE_NEW / wall_a:.2f} tokens/s), again "
        f"{n / wall_a2:.3f}; seed 0 replays token for token; seed "
        f"1 differs in {n_diff} of {n} requests; megatick="
        f"{MEGA_K} (async) {n / wall_m4:.3f} requests/s, every "
        "request's tokens equal to the per-tick run's")

    # ---- cancel: one queued, one mid chunked admission, two slotted ----
    run = llama(32, "bfloat16", max_batch=SERVE_BATCH, max_seq_len=SERVE_SEQ,
                page_size=PAGE)
    sp = serve_prompts()

    def cancel_engine():
        return ServingEngine(build_model(run, ModelFlags(**ALL_KERNELS)),
                             params, sw, cache="paged",
                             prefill_chunk=CANCEL_CHUNK)

    # budgets that end rows apart, so that admissions run beside live rows
    # a chunk a tick (rows that all end together would leave the next
    # admissions no live row, and they run whole)
    budget = [SERVE_NEW - 4 * (i % 4) for i in range(SERVE_REQS)]
    se = cancel_engine()
    K.reset_launches()                     # ---- the main path ----
    reqs = [se.submit(p, max_new_tokens=n) for p, n in zip(sp, budget)]
    finished = list(se.step())
    cancelled = [se.scheduler.queued[-1]]
    require(se.cancel(cancelled[0]), "cancel of a queued request")
    for _ in range(200):
        if se.scheduler.admitting:
            break
        finished += se.step()
    require(bool(se.scheduler.admitting), "no chunked admission to cancel")
    cancelled.append(se.scheduler.admitting[0])
    require(se.cancel(cancelled[-1]), "cancel mid chunked admission")
    slotted = [r.uid for r in se.slots if r is not None][:2]
    for uid in slotted:
        require(se.cancel(uid), "cancel of a slotted request")
    cancelled += slotted
    require(not se.cancel(slotted[0]), "a cancelled uid was found again")
    while se.busy:
        finished += se.step()
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)            # ---- read right after ----
    by_path["cancel_serve"] = launches
    mgr = se.session.cache_mgr
    require(mgr.free_pages == mgr.num_pages, "cancel: pages leak")
    require([r.uid for r in se.completed] == [r.uid for r in finished],
            "completed is not in finish order")
    kept = [r for r in reqs if r.uid not in cancelled]
    require(sorted(r.uid for r in se.completed) == [r.uid for r in kept],
            "completed does not hold exactly the uncancelled requests")
    missing = [k for k in SERVE_PATH if launches[k] == 0]
    require(not missing, f"cancel serving: kernels never launched: "
            f"{missing}")
    ref = cancel_engine()
    ref_reqs = [ref.submit(sp[r.uid], max_new_tokens=budget[r.uid])
                for r in kept]
    ref.run_to_completion()
    plain = build_model(llama(32, "bfloat16"))
    notes = []
    for r, q in zip(kept, ref_reqs):
        j = next((j for j, (x, y) in enumerate(zip(r.output, q.output))
                  if x != y), None)
        if j is None:
            continue
        margin, top = top2_margin(torch, plain, params,
                                  list(sp[r.uid]) + q.output[:j])
        spacing = 2.0 ** (np.floor(np.log2(abs(top))) - 7)
        require(margin <= 8 * spacing, f"cancel: request {r.uid} differs "
                f"from the run without the cancelled ones at token {j}, "
                f"top-2 margin {margin:.4g} (bf16 spacing {spacing:.4g})")
        notes.append(f"request {r.uid} token {j}: margin {margin:.4g} "
                     f"(bf16 spacing {spacing:.4g})")
    log("serve2", f"cancel of uids {cancelled} (queued, mid chunked "
        f"admission, two slotted) among {SERVE_REQS}: every page freed, "
        f"completed in finish order {[r.uid for r in se.completed]}; the "
        f"other {len(kept)} against a run without them: "
        f"{len(notes)} differ" + (": " + "; ".join(notes) if notes else ""))
    del se, ref, model
    del params, sw
    torch.cuda.empty_cache()

    # ---- chunked attention: a 3000-token prompt, fp32, no flash ----
    run4 = llama(4, "float32")
    p4, sw4 = _seeded(torch, dev, run4, 13)
    prompt = np.random.default_rng(3).integers(0, V, (1, CHUNKED_PROMPT))
    toks = {}
    for label, flags in (("unchunked", ModelFlags(chunk_threshold=1 << 30)),
                         ("chunked", ModelFlags()),
                         ("chunked, pruned", ModelFlags(attn_prune=True))):
        res = drive(build_model(run4, flags), p4, sw4, DenseStrategy(),
                    prompt, 8)
        toks[label] = np.concatenate([r.tokens[:, :1] for r in res], 1)
    require(all(np.array_equal(t, toks["unchunked"]) for t in
                toks.values()), "chunked attention emits other tokens")
    log("serve2", f"a {CHUNKED_PROMPT}-token prompt (llama2-7b widths, 4 "
        "layers, fp32, flash off): chunked (512-query chunks) and pruned "
        "chunked attention emit the unchunked plain tokens "
        f"{toks['unchunked'][0].tolist()}")
    del p4, sw4
    torch.cuda.empty_cache()

    # ---- the launcher, three subprocesses at once ----
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmds = [["--mode", "specee"], ["--mode", "tree"],
            ["--mode", "dense", "--temperature", "0.8"]]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", *LAUNCHER, *c],
        cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for c in cmds]
    t0 = time.perf_counter()
    for c, p in zip(cmds, procs):
        out, _ = p.communicate(timeout=600)
        summary = next((ln for ln in out.splitlines()
                        if ln.startswith("[serve] 4 requests")), "")
        require(p.returncode == 0 and "CI smoke OK" in out,
                f"launcher {' '.join(c)} failed:\n{out[-3000:]}")
        log("serve2", f"python -m repro_torch.launch.serve --smoke --ci "
            f"{' '.join(c)}: {summary}; CI smoke OK")
    log("serve2", f"launchers in {time.perf_counter() - t0:.1f} s; phase "
        f"in {time.perf_counter() - t_phase:.1f} s")
    return by_path


# where the device time of a decode step goes, by kernel family (the paged
# kernels are pa::paged_split_kernel, the dense one pa::dense_split_kernel,
# each with its merge in the same launch; the spec head's two stages count
# as spec_head_gather and spec_head, over a quantized head as
# spec_head_gather_q (the gather template on int8 codes, signed char) and
# spec_head_q);
# the quantized verify, spec-head and paged-attention kernels are the fp
# ones' templates on an Int8Cols / Int4Cols / Int8Pools reader (the
# quantized argmax and top-k with bf16 hidden rows: the tile's Int8Tile /
# Int4Tile), and count under the family's "_q" name
QUANT_READERS = ("Int8Cols", "Int4Cols", "Int8Tile", "Int4Tile",
                 "Int8Pools")
FAMILIES = (("argmax_verify", ("argmax_partial", "argmax_merge")),
            ("topk_verify", ("topk_partial", "topk_merge")),
            ("exit_gate", ("exit_gate_kernel",)),
            ("exit_gate_q", ("exit_gate_q_kernel",)),
            ("spec_head_gather_q", ("spec_gather_kernel<signed char",)),
            ("spec_head_gather", ("spec_gather_kernel",)),
            ("spec_head_q", ("spec_head_q_dot_kernel",)),
            ("spec_head", ("spec_head_dot_kernel",)),
            ("predictor_mlp", ("predictor_mlp_kernel",)),
            ("predictor_mlp_q", ("predictor_mlp_q_kernel",)),
            ("paged_decode_attention", ("paged_split_kernel",)),
            ("decode_attention", ("dense_split_kernel",)),
            ("flash_attention", ("flash_attention_kernel",)),
            ("ssd_chunk", ("ssd_chunk_kernel",)),
            ("matmul", ("gemm", "gemv", "cutlass", "cublas", "sm90_xmma",
                        "splitK", "nvjet")))


# ---------------------------------------------------------------------------
# phase 14: the MoE, RG-LRU hybrid and frontend configs
# ---------------------------------------------------------------------------
# (name, layers or None for the published depth): DBRX's and Qwen3-MoE's
# published widths with their depth cut to what one card holds beside its
# runs (the whole models need multi-GPU: 264 and 470 GB of bf16 weights)
NF_RUNS = (("dbrx-132b", 1), ("qwen3-moe-235b-a22b", 1),
           ("recurrentgemma-9b", None), ("internvl2-26b", None),
           ("hubert-xlarge", None))
NF_SERVE_REQS = 8             # requests of phase 14's serving runs
NF_PATCHES = 256              # internvl2-26b's image patches
HUBERT_S, HUBERT_TRAIN_STEPS = 512, 3
VLM_PATH = ("decode_attention", "flash_attention", "argmax_verify")


def _nf_seed(torch, dev, label, run, seed, layers):
    t0 = time.perf_counter()
    params, sw = _seeded(torch, dev, run, seed)
    torch.cuda.synchronize()
    cfg = run.model
    n_params = sum(x.numel() for x in _leaves(params))
    depth = ("published size" if layers is None else
             f"published widths, {layers} of its "
             f"{df_config(label, None, 'bfloat16').model.num_layers} layers "
             "(the whole model does not fit one card)")
    extra = ""
    if cfg.moe is not None:
        extra = (f", {cfg.moe.num_experts} experts top-"
                 f"{cfg.moe.num_experts_per_tok} of width "
                 f"{cfg.moe.expert_d_ff}")
    if cfg.rglru is not None:
        extra = (f", RG-LRU width {cfg.rglru.lru_width}, window "
                 f"{cfg.rglru.window}")
    log("newfam", f"{label} ({depth}): {n_params / 1e9:.3f} B params, "
        f"{n_params * 2 / 1e9:.1f} GB in bf16, seeded in "
        f"{time.perf_counter() - t0:.1f} s; D={cfg.d_model}, "
        f"{cfg.num_heads} heads over {cfg.num_kv_heads} of "
        f"{cfg.resolved_head_dim()}, V={cfg.vocab_size}{extra}")
    return params, sw


def _moe_forms_agree(torch, label, run, params, dense, topk):
    """Whole-batch token streams of the two MoE forms: equal, or each
    differing row reported with the plain dense model's top-2 margin at
    its first differing token, beside the bf16 spacing at the top logit
    (the forms sum the experts in other orders)."""
    import math
    import numpy as np
    from repro_torch.models.model import build_model
    if dense == topk:
        log("newfam", f"{label}: moe_impl dense and topk emit the same "
            f"{sum(map(len, dense))} tokens")
        return
    plain = build_model(run)
    prompts = np.random.default_rng(1).integers(
        0, run.model.vocab_size, (B, FULL_PROMPT))
    notes = []
    for b, (a, c) in enumerate(zip(dense, topk)):
        j = next((j for j, (x, y) in enumerate(zip(a, c)) if x != y), None)
        if j is None:
            continue
        margin, top = top2_margin(torch, plain, params,
                                  list(prompts[b]) + a[:j])
        ulp = 2.0 ** (math.floor(math.log2(abs(top))) - 7) if top else 0.0
        notes.append(f"row {b} token {j}: margin {margin:.4g} (top "
                     f"{top:.4g}, bf16 spacing {ulp:.4g})")
        require(margin <= 8 * ulp, f"{label}: the MoE forms diverge at row "
                f"{b} token {j} with a top-2 margin of {margin:.4g}, not a "
                "near-tie")
    log("newfam", f"{label}: moe_impl dense and topk diverge at near-ties "
        "only: " + "; ".join(notes))


def new_family_phase(torch, dev):
    """Phase 14. Returns the launches by path."""
    import numpy as np
    from repro_torch.api import DenseStrategy, SpecEEStrategy, TreeStrategy
    from repro_torch.core.tree import TreeSpec
    from repro_torch.models.model import ModelFlags, build_model
    t_phase = time.perf_counter()
    by_path = {}
    for name, layers in NF_RUNS:
        t_model = time.perf_counter()
        run = df_config(name, layers, "bfloat16")
        cfg = run.model
        if cfg.frontend == "audio_frames":
            by_path.update(hubert_run(torch, dev, run))
            log("newfam", f"{name} in {time.perf_counter() - t_model:.1f} s")
            continue
        params, sw = _nf_seed(torch, dev, name, run, 9, layers)
        if cfg.moe is not None:
            streams = {}
            for impl in ("dense", "topk"):
                streams[impl] = []
                by_path[f"newfam_{name}_ar_{impl}"] = df_whole_batch(
                    torch, f"{name} AR moe_impl={impl}", build_model(
                        run, ModelFlags(**ALL_KERNELS, moe_impl=impl)),
                    params, sw, SpecEEStrategy(), DF_STEPS, DF_AR_PATH,
                    phase="newfam", out=streams[impl])
                torch.cuda.empty_cache()
            _moe_forms_agree(torch, name, run, params, streams["dense"],
                             streams["topk"])
            by_path[f"newfam_{name}_serve"] = df_serve(
                torch, f"{name} serve moe_impl=topk", run, params, sw,
                DF_SERVE_PATH, phase="newfam", n_reqs=NF_SERVE_REQS,
                flags=dict(moe_impl="topk"))
            torch.cuda.empty_cache()
            by_path[f"newfam_{name}_tree"] = df_whole_batch(
                torch, f"{name} tree moe_impl=topk", build_model(
                    run, ModelFlags(**TREE_KERNELS, moe_impl="topk")),
                params, sw, TreeStrategy(tree=TreeSpec(TREE_DEPTH,
                                                       TREE_BRANCH)),
                DF_TREE_STEPS, TREE_PATH, phase="newfam")
        elif cfg.rglru is not None:
            by_path[f"newfam_{name}_ar"] = df_whole_batch(
                torch, f"{name} AR, prompt {RG_PROMPT} > window "
                f"{cfg.rglru.window}", build_model(
                    run, ModelFlags(**ALL_KERNELS)), params, sw,
                SpecEEStrategy(), DF_STEPS, DF_AR_PATH, phase="newfam",
                prompt_len=RG_PROMPT)
            torch.cuda.empty_cache()
            by_path[f"newfam_{name}_serve"] = df_serve(
                torch, f"{name} serve (paged attention, per-row RG-LRU "
                "state)", run, params, sw, DF_SERVE_PATH, phase="newfam",
                n_reqs=NF_SERVE_REQS)
        else:
            patches = np.random.default_rng(3).standard_normal(
                (B, NF_PATCHES, 1024)).astype(np.float32)
            by_path[f"newfam_{name}_dense"] = df_whole_batch(
                torch, f"{name} dense decode over {NF_PATCHES} patches + "
                "text", build_model(run, ModelFlags(**ALL_KERNELS)), params,
                None, DenseStrategy(), DF_STEPS, VLM_PATH, phase="newfam",
                patches=patches)
        del params, sw
        torch.cuda.empty_cache()
        log("newfam", f"{name} in {time.perf_counter() - t_model:.1f} s")
    log("newfam", f"phase in {time.perf_counter() - t_phase:.1f} s")
    return by_path


def hubert_run(torch, dev, run):
    """hubert-xlarge at published size: the encoder's frame logits over
    B x HUBERT_S frames (bf16; bidirectional attention, which the JAX
    package computes without a kernel, so the path launches none), then
    HUBERT_TRAIN_STEPS TrainLoop steps in fp32 on the pipeline's frame
    batches; finite logits and losses."""
    import dataclasses
    import math
    from repro_torch import kernels as K
    from repro_torch.data import DataPipeline
    from repro_torch.models.common import tree_map
    from repro_torch.models.model import ModelFlags, build_model
    from repro_torch.train import TrainLoop
    run32 = dataclasses.replace(
        run, model=dataclasses.replace(run.model, dtype="float32"),
        train=dataclasses.replace(run.train, global_batch=B,
                                  seq_len=HUBERT_S,
                                  steps=HUBERT_TRAIN_STEPS))
    model32 = build_model(run32)
    gen = torch.Generator(device=dev).manual_seed(12)
    t0 = time.perf_counter()
    params = model32.init(gen, dev)
    n_params = sum(x.numel() for x in _leaves(params))
    log("newfam", f"hubert-xlarge (published size): {n_params / 1e9:.3f} B "
        f"params, seeded in fp32 in {time.perf_counter() - t0:.1f} s")
    model = build_model(run, ModelFlags(**ALL_KERNELS))
    p16 = tree_map(lambda x: x.to(torch.bfloat16), params)
    batch = DataPipeline(run.model, B, HUBERT_S, seed=4).next()
    frames = torch.as_tensor(batch["frames"], device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()                     # ---- the main path ----
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, cache, _ = model.prefill(p16, {"frames": frames})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)            # ---- read right after ----
    require(cache is None and tuple(logits.shape) == (
        B, HUBERT_S, run.model.vocab_size), "hubert-xlarge: frame logits "
        f"of shape {tuple(logits.shape)}")
    require(bool(torch.isfinite(logits).all()),
            "hubert-xlarge: non-finite frame logits")
    log("newfam", f"hubert-xlarge prefill frame logits {B}x{HUBERT_S} in "
        f"{wall:.3f} s = {B * HUBERT_S / wall:.1f} frames/s; peak card "
        f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
        f"launches {sum(launches.values())} (bidirectional attention "
        "takes no kernel, as in the JAX package)")
    del p16, logits
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    loop = TrainLoop(model32, run32, params)
    t0 = time.perf_counter()
    losses = [loop.run_steps(1)["loss"] for _ in range(HUBERT_TRAIN_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    require(all(math.isfinite(float(x)) for x in losses),
            f"hubert-xlarge: non-finite training loss {losses}")
    log("newfam", f"hubert-xlarge TrainLoop fp32, batch {B}x{HUBERT_S} "
        f"frames: {HUBERT_TRAIN_STEPS} steps in {wall:.3f} s, losses "
        + ", ".join(f"{x:.4f}" for x in losses) + f"; peak card memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del loop, params
    return {"newfam_hubert-xlarge_prefill": launches}


# ---------------------------------------------------------------------------
# phase 15: fault-tolerant serving and checkpoints
# ---------------------------------------------------------------------------
FAULT_SEQ = 1024              # tokens a row: 8 pages of PAGE
FAULT_PAGES = 40              # 5 row reservations for SERVE_BATCH slots
FAULT_REF_PAGES = 64          # every slot's reservation: no eviction
FAULT_SITES = ("dispatch", "finish_timeout", "nan_logits", "pool_exhausted",
               "sigterm")
FAULT_PATH = ("exit_gate", "argmax_verify", "topk_verify",
              "paged_decode_attention", "flash_attention")
FAULT_ACTIONS = ("retry", "recover", "evict", "checkpoint", "restore")
WATCHDOG_REQS = 4
LAUNCHER = ("--smoke", "--ci")          # the launcher runs of phases 13, 15
TRAIN_RESTART_STEPS = (2, 1)            # steps before and after the save


def fault_engine(torch, params, sw, num_pages: int, **kw):
    """Phase 15's engine: llama2-7b (32 layers, bf16), SpecEE, megaticks of
    MEGA_K (async), blocking admission, SERVE_BATCH slots of FAULT_SEQ
    tokens over ``num_pages`` pages. The model is built without
    ``decode_kernel``: the engine turns it on for a paged cache on the
    card, and an engine rebuilt by a restore must do so again."""
    from repro_torch.api import CacheSpec
    from repro_torch.models.model import ModelFlags, build_model
    from repro_torch.serving import ServingEngine
    run = llama(32, "bfloat16", max_batch=SERVE_BATCH,
                max_seq_len=FAULT_SEQ, page_size=PAGE)
    flags = dict(ALL_KERNELS, decode_kernel=False)
    kw.setdefault("megatick", MEGA_K)
    return ServingEngine(build_model(run, ModelFlags(**flags)), params, sw,
                         strategy="specee", prefill_chunk=0,
                         cache=CacheSpec("paged", page_size=PAGE,
                                         num_pages=num_pages), **kw)


def _state_gb(se) -> float:
    return sum(x.numel() * x.element_size() for x in _leaves(se.session._state)
               if hasattr(x, "element_size")) / 1e9


def _record(reqs):
    return {r.uid: (list(r.output), list(r.exit_points), list(r.accept_lens))
            for r in reqs}


def fault_reference(torch, params, sw, prompts):
    """The fault-free run on every slot's reservation. Returns (outcome by
    uid, wall seconds, launches)."""
    from repro_torch import kernels as K
    se = fault_engine(torch, params, sw, FAULT_REF_PAGES)
    torch.cuda.synchronize()
    K.reset_launches()                     # ---- the main path ----
    t0 = time.perf_counter()
    for p in prompts:
        se.submit(p, max_new_tokens=SERVE_NEW)
    se.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)            # ---- read right after ----
    require(len(se.completed) == len(prompts) and all(
        r.done and len(r.output) == SERVE_NEW for r in se.completed),
        "faults: the reference did not finish every request")
    out = _record(se.completed)
    se.close()
    return out, wall, launches


def faulted_run(torch, params, sw, prompts, ckdir: str):
    """JAX's acceptance schedule on the oversubscribed pool; on each
    ``Preempted`` the engine is closed and a fresh one restores the
    checkpoint. Returns (outcome by uid, the final engine, per-incarnation
    launches and decode_kernel flags, fault log, fired sites, wall seconds,
    checkpoint and restore (GB, seconds))."""
    from repro_torch import kernels as K
    from repro_torch.runtime import faultinject
    from repro_torch.runtime.faultinject import FaultSchedule
    from repro_torch.serving import Backoff, Preempted
    schedule = FaultSchedule.at(dispatch=[1], finish_timeout=[3],
                                nan_logits=[5], pool_exhausted=range(2, 8),
                                sigterm=[6])
    kw = dict(checkpoint_dir=ckdir, backoff=Backoff(base_s=0.0),
              evict_patience=2, cooldown_ticks=2)
    saves, restores, runs, events = [], [], [], []

    def timed_checkpoints(se):
        save = se.checkpoint_now

        def checkpoint_now():
            gb = _state_gb(se)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tick = save()
            saves.append((gb, time.perf_counter() - t0))
            return tick
        se.checkpoint_now = checkpoint_now
        return se

    with faultinject.injected(schedule) as inj:
        se = timed_checkpoints(fault_engine(torch, params, sw, FAULT_PAGES,
                                            **kw))
        torch.cuda.synchronize()
        K.reset_launches()                 # ---- the main path ----
        t0 = time.perf_counter()
        for p in prompts:
            se.submit(p, max_new_tokens=SERVE_NEW)
        for _ in range(8):                 # preemption / restart cycles
            try:
                se.run_to_completion()
                break
            except Preempted:
                torch.cuda.synchronize()
                runs.append((dict(K.LAUNCHES), se.model.flags.decode_kernel))
                events.extend(se.fault_log)
                se.close()
                del se
                se = timed_checkpoints(fault_engine(torch, params, sw,
                                                    FAULT_PAGES, **kw))
                torch.cuda.synchronize()
                t_r = time.perf_counter()
                require(se.restore_checkpoint(),
                        "faults: restore_checkpoint() found no checkpoint")
                torch.cuda.synchronize()
                restores.append((_state_gb(se), time.perf_counter() - t_r))
                K.reset_launches()
        else:
            raise AssertionError("faults: the engine never ran to completion")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs.append((dict(K.LAUNCHES), se.model.flags.decode_kernel))
        events.extend(se.fault_log)         # ---- read right after ----
        se.close()
        fired = inj.fired_sites()
    return (_record(se.completed), se, runs, events, fired, wall, saves,
            restores)


def watchdog_run(torch, params, sw, prompts):
    """``watchdog_s=1e-9``: every finish is slow, so the engine keeps the
    results and runs synchronous ticks. Returns (outcome, fault log,
    launches)."""
    from repro_torch import kernels as K
    se = fault_engine(torch, params, sw, FAULT_REF_PAGES, watchdog_s=1e-9)
    K.reset_launches()                     # ---- the main path ----
    for p in prompts:
        se.submit(p, max_new_tokens=SERVE_NEW)
    se.run_to_completion()
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)            # ---- read right after ----
    se.close()
    return _record(se.completed), list(se.fault_log), launches


def _launcher(args, env):
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", *LAUNCHER, *args],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def train_restart(torch, dev, ckdir: str):
    """JAX's ``test_train_restart_reproduces_stream`` on the card, on
    get_bundle's 12-layer smoke config in fp32: 2 steps, save, 1 step; a
    fresh loop (other init) restores step 2 and runs 1 step. Returns (the
    two batches of step 3, the two losses)."""
    import dataclasses
    from repro_torch.models.model import build_model
    from repro_torch.train import TrainLoop
    run = bundle_b_run()
    run = dataclasses.replace(run, train=dataclasses.replace(
        run.train, checkpoint_every=100))
    model = build_model(run)

    def loop_from(seed):
        loop = TrainLoop(model, run, model.init(
            torch.Generator(device=dev).manual_seed(seed), dev),
            ckpt_dir=ckdir)
        return loop

    def recorded(loop):
        seen, nxt = [], loop.pipeline.next

        def next_batch():
            seen.append(nxt())
            return seen[-1]
        loop.pipeline.next = next_batch
        return seen

    first, after = TRAIN_RESTART_STEPS
    loop = loop_from(0)
    loop.run_steps(first)
    loop.save()
    loop.ckpt.wait()
    seen = recorded(loop)
    loop.run_steps(after)
    loop2 = loop_from(5)
    require(loop2.try_restore() and loop2.step == first,
            "faults: TrainLoop did not restore its saved step")
    seen2 = recorded(loop2)
    loop2.run_steps(after)
    return (seen[0], seen2[0]), (loop.history[-1]["loss"],
                                 loop2.history[-1]["loss"])


def faults_phase(torch, dev):
    """Phase 15. Returns the launches by path."""
    import os
    import shutil
    import signal
    import tempfile
    import numpy as np
    from repro_torch.checkpoint import CheckpointManager
    t_phase = time.perf_counter()
    params, sw = full_weights(torch, dev)       # phase 5's weights (seed 7)
    prompts = serve_prompts()
    ref, ref_wall, ref_launches = fault_reference(torch, params, sw, prompts)
    torch.cuda.empty_cache()
    ckdir = tempfile.mkdtemp(prefix="faults-ckpt-")
    try:
        (got, se, runs, events, fired, wall, saves,
         restores) = faulted_run(torch, params, sw, prompts, ckdir)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    require(fired == frozenset(FAULT_SITES),
            f"faults: fired {sorted(fired)}, want every site but "
            "device_lost")
    differ = [u for u in ref if got.get(u) != ref[u]]
    require(not differ, f"faults: requests {differ} differ from the "
            "fault-free reference (tokens, exit points or accept lengths)")
    require(len(se.completed) == len(prompts) and all(
        r.done and len(r.output) == SERVE_NEW for r in se.completed),
        f"faults: not every request is done with {SERVE_NEW} tokens")
    mgr = se.session.cache_mgr
    require(mgr.free_pages == mgr.num_pages, f"faults: {mgr.free_pages} of "
            f"{mgr.num_pages} pages free at the end")
    actions = [e.action for e in events]
    missing = [a for a in FAULT_ACTIONS if a not in actions]
    require(not missing, f"faults: the fault log lacks {missing}")
    for i, (launches, decode_kernel) in enumerate(runs):
        require(decode_kernel, f"faults: engine {i} runs without the paged "
                "decode kernel")
        absent = [k for k in FAULT_PATH if launches[k] == 0]
        require(not absent, f"faults: engine {i} never launched {absent}")
    by_path = {f"faults_serve_{i}": launches
               for i, (launches, _) in enumerate(runs)}
    by_path["faults_reference"] = ref_launches
    evicts = [e for e in events if e.action == "evict"]
    replayed = sum(int(e.detail.split("progress=")[1].split()[0])
                   for e in evicts)
    log("faults", f"{len(prompts)} requests x {SERVE_NEW} tokens, pool of "
        f"{FAULT_PAGES} pages ({FAULT_PAGES * PAGE // FAULT_SEQ} row "
        f"reservations for {SERVE_BATCH} slots): every site but device_lost "
        f"fired; {len(runs)} engines ({len(runs) - 1} rebuilt by a "
        f"restore, each launching {', '.join(FAULT_PATH)}, decode_kernel "
        f"on); {len(evicts)} evictions, {replayed} tokens replayed and "
        f"verified; every request's tokens, exit points and accept lengths "
        f"equal the fault-free run on {FAULT_REF_PAGES} pages; every page "
        f"free; wall {wall:.3f} s against the reference's {ref_wall:.3f} s "
        f"({wall / ref_wall:.2f}x)")
    log("faults", "fault log: " + ", ".join(
        f"{e.site}:{e.action}@{e.tick}" for e in events))
    for gb, sec in saves:
        log("faults", f"checkpoint: {gb:.3f} GB of state (page pools, page "
            f"table, draft cache, scheduler, last tokens) saved in "
            f"{sec:.3f} s ({gb / sec:.2f} GB/s, the card to npz files)")
    for gb, sec in restores:
        log("faults", f"restore: {gb:.3f} GB into a fresh engine in "
            f"{sec:.3f} s ({gb / sec:.2f} GB/s, npz files to the card; the "
            "read was warm in the page cache)")
    del se
    torch.cuda.empty_cache()

    wd, wd_log, wd_launches = watchdog_run(torch, params, sw,
                                           prompts[:WATCHDOG_REQS])
    by_path["faults_watchdog"] = wd_launches
    falls = [e for e in wd_log if e.action == "sync_fallback"]
    require(falls and falls[0].site == "watchdog",
            "faults: watchdog_s=1e-9 logged no sync_fallback")
    differ = [u for u in wd if wd[u] != ref[u]]
    require(not differ, f"faults: watchdog run requests {differ} differ "
            "from the same requests in the 16-request reference")
    log("faults", f"watchdog_s=1e-9, {WATCHDOG_REQS} requests: "
        f"{len(falls)} sync fallbacks; tokens, exit points and accept "
        f"lengths equal the same requests among {len(prompts)} in the "
        "reference")
    del params, sw
    torch.cuda.empty_cache()

    # ---- the launcher: a real SIGTERM, then --inject for each site ----
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    launch_dir = tempfile.mkdtemp(prefix="faults-launch-")
    t0 = time.perf_counter()
    try:
        term = _launcher(["--checkpoint-dir", launch_dir], env)
        sites = [_launcher(["--megatick", "2", "--inject", site], env)
                 for site in FAULT_SITES]
        head = []
        for line in term.stdout:
            head.append(line)
            if line.startswith("[serve] tick 1 done"):
                term.send_signal(signal.SIGTERM)
                break
        rest, _ = term.communicate(timeout=600)
        require(term.returncode == 17, f"faults: the launcher exited "
                f"{term.returncode} on SIGTERM, want 17:\n"
                f"{(''.join(head) + rest)[-3000:]}")
        step = CheckpointManager(launch_dir).latest_step()
        require(step is not None, "faults: the launcher's SIGTERM left no "
                "committed step")
        again = _launcher(["--checkpoint-dir", launch_dir, "--restore"], env)
        out, _ = again.communicate(timeout=600)
        require(again.returncode == 0 and "CI smoke OK" in out
                and "[serve] restored tick" in out,
                f"faults: --restore --ci failed:\n{out[-3000:]}")
        log("faults", f"launcher: SIGTERM after its first tick -> exit 17 "
            f"with step {step} committed; --restore --ci: " + next(
                ln for ln in out.splitlines() if "restored tick" in ln)
            + "; CI smoke OK")
        for site, proc in zip(FAULT_SITES, sites):
            out, _ = proc.communicate(timeout=600)
            require(proc.returncode == 0 and "CI smoke OK" in out,
                    f"faults: --inject {site} failed:\n{out[-3000:]}")
            log("faults", f"--inject {site} --ci: " + next(
                ln for ln in out.splitlines() if "injected" in ln))
    finally:
        shutil.rmtree(launch_dir, ignore_errors=True)
    log("faults", f"launchers in {time.perf_counter() - t0:.1f} s")

    # ---- TrainLoop restart ----
    train_dir = tempfile.mkdtemp(prefix="faults-train-")
    try:
        (b1, b2), (l1, l2) = train_restart(torch, dev, train_dir)
    finally:
        shutil.rmtree(train_dir, ignore_errors=True)
    require(set(b1) == set(b2) and all(
        np.array_equal(np.asarray(b1[k]), np.asarray(b2[k])) for k in b1),
        "faults: the restored pipeline's batch differs")
    rel = abs(l2 - l1) / abs(l1)
    require(rel <= 1e-5, f"faults: restarted loss {l2!r} against "
            f"{l1!r}, rel {rel:.3g} > 1e-5")
    log("faults", f"TrainLoop restart (get_bundle's 12-layer smoke config, "
        f"fp32): step 3's batch bit-equal after the restore; loss "
        f"{l1!r} uninterrupted, {l2!r} restarted, rel difference "
        f"{rel:.3g}")
    log("faults", f"phase in {time.perf_counter() - t_phase:.1f} s")
    return by_path



# ---------------------------------------------------------------------------
# phase 16: multi-GPU serving — tensor-parallel decode over a device mesh
# ---------------------------------------------------------------------------
TP_DEGREES = (2, 4)
TP_VOCABS = (V, V + 1)        # llama2-7b's head, and one that splits unevenly
TP_ROWS = (4, 320)            # a B = 4 step's rows, a B = 8 tree step's
TP_LAYERS = 4                 # the fp32 decode runs' depth
TP_DEEP_LAYERS = 16           # the bf16 comparison's depth
TP_STEPS = 16                 # whole-batch decode steps of each run
TP_REQS, TP_NEW = 8, 16       # requests and new tokens of (c) and (d)
TP_PATH = ("exit_gate", "argmax_verify", "topk_verify", "decode_attention",
           "paged_decode_attention", "flash_attention", "spec_head_gather",
           "spec_head", "predictor_mlp")
TP_SERVE_PATH = SERVE_PATH + ("flash_attention",)


def tp_mesh(P: int):
    """A (1, P) mesh with every shard on cuda:0: the one card holds all P
    shards, so every shard-local kernel, merge and reduction runs and no
    byte crosses between cards."""
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh(1, P, device="cuda:0")


def check_sharded_verify(torch, dev):
    """(a) The sharded verify against the unsharded kernel, bf16 head of
    D x V for V in TP_VOCABS, P in TP_DEGREES, R in TP_ROWS, with each
    row's best column copied to columns on every shard (cross-shard ties):
    tokens and values bit-equal. Logs the unsharded kernel's time, each
    slice's kernel time, the merge's and the whole sharded call's. Returns
    {(name, V, P, R): timings}."""
    from repro_torch.kernels.exit_gate import ops
    from repro_torch.sharding import ShardCtx
    from repro_torch.sharding.serving import split_vocab
    gen = torch.Generator(device=dev).manual_seed(160)
    out = {}
    for Vt in TP_VOCABS:
        w = (torch.randn(D, Vt, generator=gen, device=dev) * D ** -0.5).to(
            torch.bfloat16)
        for R in TP_ROWS:
            hn = torch.randn(R, D, generator=gen, device=dev).to(
                torch.bfloat16)
            for r in range(min(R, 4)):    # ties across every shard
                best = int((hn[r].float() @ w.float()).argmax())
                for j in range(4):
                    w[:, (best + j * (Vt // 4) + 1) % Vt] = w[:, best]
            t0, v0 = ops.verify_argmax(hn, w, impl="kernel")
            i0, x0 = ops.verify_topk(hn, w, K_SPEC, impl="kernel")
            for P in TP_DEGREES:
                shard = ShardCtx.from_mesh(tp_mesh(P))
                sl = split_vocab(w, shard)
                t1, v1 = ops.verify_argmax(hn, sl, impl="kernel")
                i1, x1 = ops.verify_topk(hn, sl, K_SPEC, impl="kernel")
                require(torch.equal(t0, t1) and torch.equal(v0, v1),
                        f"sharded argmax differs at V={Vt} P={P} R={R}")
                require(torch.equal(i0, i1) and torch.equal(x0, x1),
                        f"sharded top-k differs at V={Vt} P={P} R={R}")
                for name, full, one, merge in (
                        ("argmax_verify",
                         lambda: ops.verify_argmax(hn, w, impl="kernel"),
                         lambda p: ops.verify_argmax(hn, p, impl="kernel"),
                         ops.merge_argmax),
                        ("topk_verify",
                         lambda: ops.verify_topk(hn, w, K_SPEC,
                                                 impl="kernel"),
                         lambda p: ops.verify_topk(hn, p, K_SPEC,
                                                   impl="kernel"),
                         lambda parts: ops.merge_topk(parts, K_SPEC))):
                    parts = [one(p) for p in sl]
                    rec = {"unsharded_ms": graph_ms(torch, [full]),
                           "shard_ms": [graph_ms(torch, [lambda p=p: one(p)])
                                        for p in sl],
                           "merge_ms": graph_ms(
                               torch, [lambda: merge(parts)]),
                           "sharded_ms": graph_ms(torch, [
                               (lambda: ops.verify_argmax(hn, sl,
                                                          impl="kernel"))
                               if name == "argmax_verify" else
                               (lambda: ops.verify_topk(hn, sl, K_SPEC,
                                                        impl="kernel"))]),
                           "widths": [p.shape[1] for p in sl]}
                    out[(name, Vt, P, R)] = rec
                    log("tp", f"{name} V={Vt} P={P} R={R}: bit-equal to "
                        f"the unsharded kernel (tokens and values, ties "
                        f"on every shard); unsharded "
                        f"{rec['unsharded_ms']:.4f} ms, slices "
                        f"{rec['widths']} "
                        + "/".join(f"{t:.4f}" for t in rec["shard_ms"])
                        + f" ms, merge {rec['merge_ms']:.4f} ms, sharded "
                        f"call {rec['sharded_ms']:.4f} ms")
            del hn
        del w
    return out


def _tp_drive(model, params, sw, strategy, prompts, cache, mesh):
    """Whole-batch decode of ``TP_STEPS`` steps; every row's tokens."""
    from repro_torch.api import Engine
    e = Engine.create(model, params, sw, strategy=strategy, mesh=mesh)
    s = e.new_session(cache=cache)
    first = s.prefill(prompts, max_new_tokens=TP_STEPS + 1)
    toks = [list(first.row_tokens(b)) for b in range(first.batch)]
    while not s.all_done():
        r = s.step()
        for b in range(r.batch):
            toks[b].extend(int(t) for t in r.row_tokens(b))
    return toks


def tp_decode(torch, dev):
    """(b) llama2-7b at published width, fp32, TP_LAYERS layers: SpecEE
    and tree on dense and paged caches at P = 1, 2 and 4, every shard on
    the one card, cut from one host copy of the weights; tokens at P = 2
    and 4 equal P = 1's. Returns the P > 1 runs' launches, the model and
    the weights on the card and on the host."""
    import numpy as np
    from repro_torch import kernels as K
    from repro_torch.models.model import ModelFlags, build_model
    from repro_torch.sharding.serving import to_host
    run = llama(TP_LAYERS, "float32")
    params, sw = _seeded(torch, dev, run, 16)
    host = to_host(params), to_host(sw)
    model = build_model(run, ModelFlags(**TREE_KERNELS))
    prompts = np.random.default_rng(16).integers(0, V, (B, FULL_PROMPT))
    cases = [(s, c) for s in ("specee", "tree") for c in ("dense", "paged")]
    ref = {}
    for strategy, cache in cases:
        st = tree_strategy() if strategy == "tree" else strategy
        ref[(strategy, cache)] = _tp_drive(model, params, sw, st, prompts,
                                           cache, None)
    torch.cuda.synchronize()
    K.reset_launches()                     # ---- the main path ----
    t0 = time.perf_counter()
    for P in TP_DEGREES:
        for strategy, cache in cases:
            st = tree_strategy() if strategy == "tree" else strategy
            got = _tp_drive(model, *host, st, prompts, cache, tp_mesh(P))
            require(got == ref[(strategy, cache)],
                    f"tp: {strategy}/{cache} at P={P} differs from P=1")
            torch.cuda.empty_cache()
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)            # ---- read right after ----
    for k in TP_PATH:
        require(launches[k] > 0, f"tp decode never launched {k}")
    log("tp", f"llama2-7b {TP_LAYERS} layers fp32, B={B}, {TP_STEPS} "
        f"steps: SpecEE and tree x dense and paged at P = "
        f"{', '.join(map(str, TP_DEGREES))} (all shards on cuda:0) "
        f"token-identical to P = 1 in {time.perf_counter() - t0:.1f} s; "
        f"peak card memory {torch.cuda.max_memory_allocated() / 1e9:.2f} "
        "GB; launches: " + ", ".join(f"{k} {launches[k]}" for k in TP_PATH))
    return launches, (model, params, sw, host)


def _first_layers(params, sw, n: int):
    """The first ``n`` layers of phase 5's one-segment stack and the
    SpecEE weights' predictor bank and offline mask cut to match (views:
    the leading dims are sliced, so every leaf stays contiguous)."""
    from repro_torch.models.common import tree_map
    params = dict(params, segments=[tree_map(lambda x: x[:n], seg)
                                    for seg in params["segments"]])
    return params, sw._replace(
        predictors=tree_map(lambda x: x[:n], sw.predictors),
        offline_mask=sw.offline_mask[:n])


def tp_deep_bf16(torch, dev):
    """(b, deep bf16) llama2-7b, TP_DEEP_LAYERS layers (not its full 32),
    bf16, SpecEE on the paged cache at P = 1, then (d)'s pool on the same
    weights on the card, then P = 4 cut from one host copy with the
    card's copy freed: tokens
    compared, and a row's first divergence, if any, must be a near-tie of
    the P = 1 model (top-2 margin within 8 bf16 spacings of the top
    logit, as phase 14 holds). The P = 4 run's peak card memory must stay
    under 1.5x the whole weights (no whole copy beside the shards).
    Returns the P = 4 run's and the pool's launches."""
    import gc
    import numpy as np
    from repro_torch import kernels as K
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.model import ModelFlags, build_model
    from repro_torch.sharding.serving import to_host, unplace
    params, sw = _first_layers(*full_weights(torch, dev), TP_DEEP_LAYERS)
    run = llama(TP_DEEP_LAYERS, "bfloat16")
    model = build_model(run, ModelFlags(**ALL_KERNELS))
    prompts = np.random.default_rng(17).integers(0, V, (B, FULL_PROMPT))
    ref = _tp_drive(model, params, sw, "specee", prompts, "paged", None)
    pool_launches = tp_pool(torch, dev, params, sw)
    whole = sum(x.numel() * x.element_size()
                for x in tree_leaves((params, sw))
                if isinstance(x, torch.Tensor))
    host = to_host(params), to_host(sw)
    del params, sw
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()                     # ---- the main path ----
    t0 = time.perf_counter()
    got = _tp_drive(model, *host, "specee", prompts, "paged", tp_mesh(4))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)            # ---- read right after ----
    peak = torch.cuda.max_memory_allocated()
    for k in SERVE_PATH + ("flash_attention",):
        require(launches[k] > 0, f"tp deep bf16 never launched {k}")
    require(peak < 1.5 * whole, f"tp deep bf16: peak card memory "
            f"{peak / 1e9:.2f} GB at P=4 for {whole / 1e9:.2f} GB of "
            "weights (a whole copy beside the shards)")
    notes, params = [], None
    for b in range(B):
        n = next((i for i, (x, y) in enumerate(zip(ref[b], got[b]))
                  if x != y), None)
        if n is None:
            continue
        if params is None:
            params = unplace(host[0], dev)
        margin, top = top2_margin(torch, build_model(run), params,
                                  list(prompts[b]) + ref[b][:n])
        spacing = 2.0 ** (np.floor(np.log2(abs(top))) - 7)
        require(margin <= 8 * spacing, f"tp deep bf16: row {b} differs "
                f"at token {n} ({ref[b][n]} vs {got[b][n]}), P=1 top-2 "
                f"margin {margin:.4g} (bf16 spacing {spacing:.4g})")
        notes.append(f"row {b} first differs at token {n} "
                     f"({ref[b][n]} vs {got[b][n]}; P=1 top-2 margin "
                     f"{margin:.4g} of {top:.4g}, bf16 spacing "
                     f"{spacing:.4g})")
    log("tp", f"llama2-7b {TP_DEEP_LAYERS} layers bf16 SpecEE paged, "
        f"B={B}, "
        f"{TP_STEPS} steps, P=4 against P=1: "
        + ("; ".join(notes) if notes else "every token equal")
        + f"; P=4 run {wall:.2f} s, peak card memory {peak / 1e9:.2f} GB "
        f"for {whole / 1e9:.2f} GB of weights (the whole tree on the "
        "host, the card's copy freed)")
    return launches, pool_launches


def tp_remesh(torch, dev, model, params, sw, host):
    """(c) ServingEngine(mesh=P4) on phase (b)'s fp32 weights (its host
    copy): device_lost fires at the second tick; the engine remeshes to
    ``plan_replica_remesh``'s degree and finishes with the unsharded
    fault-free run's tokens. Returns its launches."""
    from repro_torch import kernels as K
    from repro_torch.runtime import faultinject
    from repro_torch.runtime.fault import plan_replica_remesh
    from repro_torch.runtime.faultinject import FaultSchedule
    from repro_torch.serving import ServingEngine
    from repro_torch.models.model import ModelFlags, build_model
    prompts = serve_prompts()[:TP_REQS]
    model = build_model(llama(TP_LAYERS, "float32", max_batch=SERVE_BATCH,
                              max_seq_len=1024, page_size=PAGE),
                        ModelFlags(**ALL_KERNELS))
    kw = dict(strategy="specee", megatick=2, prefill_chunk=0)
    want = _serve(model, params, sw, prompts, TP_NEW, **kw)
    se = ServingEngine(model, *host, mesh=tp_mesh(4), **kw)
    secs = []
    remesh = se.remesh

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        remesh(*a, **kw)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)

    se.remesh = timed
    reqs = [se.submit(p, max_new_tokens=TP_NEW) for p in prompts]
    torch.cuda.synchronize()
    K.reset_launches()                     # ---- the main path ----
    with faultinject.injected(FaultSchedule.once("device_lost", visit=2)):
        se.run_to_completion()
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)            # ---- read right after ----
    del se.remesh                          # the timer held se in a cycle
    for k in TP_SERVE_PATH:
        require(launches[k] > 0, f"tp remesh never launched {k}")
    new_tp = plan_replica_remesh(3, 4)
    require(se.tp_degree == new_tp == 2, f"remeshed to {se.tp_degree}")
    detail = [e.detail for e in se.fault_log if e.action == "remesh"][0]
    require(int(detail.split("readmitted=")[1].split(";")[0]) > 0,
            f"tp remesh re-admitted no request ({detail})")
    got = [(r.output, r.exit_points) for r in reqs]
    require(got == want, "tp remesh: tokens differ from the fault-free run")
    mgr = se.session.cache_mgr
    require(mgr.free_pages == mgr.num_pages, "tp remesh: pages leaked")
    log("tp", f"ServingEngine(mesh=P4) fp32 {TP_LAYERS} layers, "
        f"{TP_REQS} requests x {TP_NEW} tokens, device_lost at tick 2: "
        f"remeshed tp 4->{se.tp_degree} in {secs[0]:.3f} s ({detail}); "
        "tokens and exit points equal the unsharded fault-free run; "
        "every page returned")
    se.close()
    return launches


def tp_pool(torch, dev, params, sw):
    """(d) ReplicaPool of two unsharded llama2-7b bf16 replicas (the
    TP_DEEP_LAYERS layers of (b)) sharing one
    param tree: device_lost fires in a replica, which cannot remesh, so
    the pool kills it and requeues its requests; the outputs equal one
    engine's fault-free run. Returns the pool's launches."""
    from repro_torch import kernels as K
    from repro_torch.models.model import ModelFlags, build_model
    from repro_torch.runtime import faultinject
    from repro_torch.runtime.faultinject import FaultSchedule
    from repro_torch.serving import ReplicaPool, ServingEngine
    run = llama(TP_DEEP_LAYERS, "bfloat16", max_batch=4, max_seq_len=1024,
                page_size=PAGE)
    model = build_model(run, ModelFlags(**ALL_KERNELS))
    prompts = serve_prompts()[:TP_REQS]
    kw = dict(strategy="specee", megatick=2, prefill_chunk=0)
    want = [o for o, _ in _serve(model, params, sw, prompts, TP_NEW, **kw)]
    pool = ReplicaPool([ServingEngine(model, params, sw, **kw)
                        for _ in range(2)])
    prs = [pool.submit(p, max_new_tokens=TP_NEW) for p in prompts]
    torch.cuda.synchronize()
    K.reset_launches()                     # ---- the main path ----
    t0 = time.perf_counter()
    with faultinject.injected(
            FaultSchedule.once("device_lost", visit=3)) as inj:
        pool.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)            # ---- read right after ----
    for k in TP_SERVE_PATH:
        require(launches[k] > 0, f"tp pool never launched {k}")
    require(inj.fired_sites() == frozenset({"device_lost"}),
            "tp pool: device_lost never fired")
    require(sorted(pool.alive) == [False, True], f"alive {pool.alive}")
    require([list(pr.output) for pr in prs] == want,
            "tp pool: outputs differ from one engine's fault-free run")
    moved = sum(pr.migrations for pr in prs)
    require(moved > 0, "tp pool: no request migrated")
    log("tp", f"ReplicaPool of 2 llama2-7b bf16 replicas (one param tree), "
        f"{TP_REQS} requests x {TP_NEW} tokens, device_lost on a replica: "
        f"{[(e.site, e.action) for e in pool.fault_log]}, {moved} "
        f"requests migrated and replay-verified, outputs equal one "
        f"engine's fault-free run; {wall:.2f} s")
    pool.close()
    return launches


def check_collectives(torch, dev):
    """(e) The collectives on the card against plain sums: all_reduce_sum
    in shard order, compressed_psum against the CPU's bit for bit over 8
    steps of error feedback, collective_matmul_ag against one matmul per
    row block."""
    from repro_torch.runtime import collectives as coll
    gen = torch.Generator(device=dev).manual_seed(161)
    parts = [torch.randn(SERVE_BATCH, D, generator=gen, device=dev)
             .to(torch.bfloat16) for _ in range(4)]
    got = coll.all_reduce_sum(parts, dev)
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    require(torch.equal(got, want), "all_reduce_sum is not in shard order")
    errs = [torch.zeros(D, device=dev) for _ in range(4)]
    errs_c = [e.cpu() for e in errs]
    max_amax = 0.0
    for _ in range(8):
        xs = [torch.randn(D, generator=gen, device=dev) for _ in range(4)]
        max_amax = max(max_amax, float(max((x + e).abs().max()
                                           for x, e in zip(xs, errs))))
        tot, errs = coll.compressed_psum(xs, errs)
        tot_c, errs_c = coll.compressed_psum([x.cpu() for x in xs], errs_c)
        require(torch.equal(tot[0].cpu(), tot_c[0]) and all(
            torch.equal(a.cpu(), b) for a, b in zip(errs, errs_c)),
            "compressed_psum on the card differs from the CPU's")
        # a step: the fresh and the fed-back residual, P shared scales
        require(float((tot[0] - sum(xs)).abs().max())
                <= 4 * max_amax / 127 + 1e-4,
                "compressed_psum outside its bound")
    x = torch.randn(4 * 64, D, generator=gen, device=dev)
    w = torch.randn(D, 1024, generator=gen, device=dev)
    outs = coll.collective_matmul_ag(list(x.chunk(4)), [w] * 4)
    plain = torch.cat([b @ w for b in x.chunk(4)])
    require(all(torch.equal(o, plain) for o in outs),
            "collective_matmul_ag differs from the plain row-block matmuls")
    log("tp", "collectives on the card: all_reduce_sum in shard order; "
        "compressed_psum bit-equal to the CPU's over 8 steps; "
        "collective_matmul_ag equal to the plain matmuls")


def tp_phase(torch, dev):
    """Phase 16: multi-GPU serving with every shard on the one card. Returns
    the launches by path."""
    import gc
    gc.collect()            # earlier phases' engines that sit in cycles
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    timing = check_sharded_verify(torch, dev)
    torch.cuda.empty_cache()
    check_collectives(torch, dev)
    by_path = {}
    by_path["tp_decode"], (model, params, sw, host) = tp_decode(torch, dev)
    torch.cuda.empty_cache()
    by_path["tp_remesh"] = tp_remesh(torch, dev, model, params, sw, host)
    del model, params, sw, host
    gc.collect()
    torch.cuda.empty_cache()
    by_path["tp_deep"], by_path["tp_pool"] = tp_deep_bf16(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    log("tp", f"phase 16 took {time.perf_counter() - t0:.1f} s; no copy "
        "between cards was made or measured (one card holds every shard)")
    return by_path, timing


# ---------------------------------------------------------------------------
# phase 17: tensor-parallel serving of the remaining families
# ---------------------------------------------------------------------------
TPF_STEPS = 8                 # whole-batch decode steps of each run
TPF_RG_LAYERS = 3             # one unit: rglru, rglru, local attention
TPF_RG_PROMPTS = (128, 300, 211, 177)   # recurrentgemma's rows' prompts
TPF_VLM_LAYERS = 2
TPF_SERVE_REQS = 8            # mamba2's ServingEngine(mesh=P2) requests
TPF_SERVE_NEW = 16
TPF_MOE_PATH = ("decode_attention", "flash_attention", "exit_gate",
                "argmax_verify", "topk_verify")
TPF_RG_PATH = {2: TPF_MOE_PATH + ("paged_decode_attention",
                                  "paged_decode_attention_q"),
               4: TPF_MOE_PATH + ("paged_decode_attention",)}


def _tpf_drive(model, params, sw, strategy, prompts, cache, mesh,
               patches=None):
    """A whole-batch session of TPF_STEPS steps on ``mesh`` (None: one
    device): ``prompts`` (B, T) through ``prefill`` (with ``patches``
    prepended) or a list of rows of any length through ``prefill_row``.
    Returns each row's tokens and each step's exit points, exits and
    units_run."""
    from repro_torch.api import Engine
    e = Engine.create(model, params, sw, strategy=strategy, mesh=mesh)
    new = TPF_STEPS * e.emit_width + 1
    if isinstance(prompts, list):
        s = e.new_session(batch=len(prompts), cache=cache,
                          max_seq=max(map(len, prompts)) + new + 2)
        toks = [[s.prefill_row(b, p, max_new_tokens=new)]
                for b, p in enumerate(prompts)]
    else:
        s = e.new_session(cache=cache)
        batch, max_seq = prompts, None
        if patches is not None:
            batch = {"tokens": prompts, "patches": patches}
            max_seq = patches.shape[1] + prompts.shape[1] + new + 2
        first = s.prefill(batch, max_new_tokens=new, max_seq=max_seq)
        toks = [list(first.row_tokens(b)) for b in range(first.batch)]
    info = []
    while not s.all_done():
        r = s.step()
        info.append((r.exit_layer.tolist(), r.exited.tolist(),
                     int(r.units_run)))
        for b in range(r.batch):
            toks[b].extend(int(t) for t in r.row_tokens(b))
    return toks, info


def _tpf_serve(model, params, sw, mesh):
    """mamba2's ServingEngine on the paged cache (its SSD rows per row):
    TPF_SERVE_REQS of phase 5's prompt lengths, every request's tokens and
    exit points, every page returned."""
    prompts = serve_prompts(model.cfg.vocab_size)[:TPF_SERVE_REQS]
    return _serve(model, params, sw, prompts, TPF_SERVE_NEW,
                  strategy="specee", cache="paged", prefill_chunk=0,
                  mesh=mesh)


def _tpf_family(torch, dev, label, run, cases, degrees, path, seed=17,
                check=None, small=False):
    """One family at fp32: its weights seeded on the card, every case run
    at P = 1 there, the weights moved to the host and the card's copy
    freed, then each degree of ``degrees`` (every shard on cuda:0) with
    its launch counts zeroed right before and read right after: each
    case's tokens, exit points and units_run must equal P = 1's, the
    path's kernels must launch (``path``: the kernels, or a dict of them
    by degree) and the peak card memory stay under 1.5x the whole
    weights: no whole copy beside the shards. A ``small`` model, whose
    P = 1 runs already hold more than half its weights beyond them
    (activations and the kernels' workspaces: mamba2-130m), is held under
    1.5x its weights plus what its P = 1 runs held beyond them, which
    still fails a whole extra copy. ``cases``: (name, model, strategy,
    cache, prompts, patches, degrees or None: all); a "serve" strategy
    runs ``_tpf_serve``. ``check(P, launches_after_case)`` adds a family's
    checks. Returns the launches by path."""
    import gc
    from repro_torch import kernels as K
    from repro_torch.models.common import tree_leaves, with_contiguous_head
    from repro_torch.sharding.serving import to_host
    t0 = time.perf_counter()
    params, sw = _seeded(torch, dev, run, seed)
    whole = sum(x.numel() * x.element_size() for x in tree_leaves(
        (with_contiguous_head(params), sw)) if isinstance(x, torch.Tensor))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def go(case, p, s, mesh):
        name, model, strategy, cache, prompts, patches, _ = case
        if strategy == "serve":
            return _tpf_serve(model, p, s, mesh)
        if strategy == "dense":         # no draft, no predictors
            s = None
        return _tpf_drive(model, p, s, strategy, prompts, cache, mesh,
                          patches)

    ref = {c[0]: go(c, params, sw, None) for c in cases}
    torch.cuda.synchronize()
    over = max(0, torch.cuda.max_memory_allocated() - whole)  # beyond them
    host = to_host(params), to_host(sw)
    del params, sw
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t_ref = time.perf_counter() - t0
    by_path, notes = {}, []
    for P in degrees:
        mine = [c for c in cases if c[6] is None or P in c[6]]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        K.reset_launches()                 # ---- the main path ----
        for c in mine:
            got = go(c, *host, tp_mesh(P))
            require(got == ref[c[0]], f"tpfam {label} {c[0]} at P={P} "
                    "differs from P=1")
            if check is not None:
                check(P, c[0], dict(K.LAUNCHES))
            torch.cuda.empty_cache()
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)        # ---- read right after ----
        peak = torch.cuda.max_memory_allocated()
        missing = [k for k in (path[P] if isinstance(path, dict) else path)
                   if launches[k] == 0]
        require(not missing, f"tpfam {label} P={P}: kernels never "
                f"launched: {missing}")
        limit = 1.5 * whole + (over if small else 0)
        require(peak < limit, f"tpfam {label} P={P}: peak card memory "
                f"{peak / 1e9:.2f} GB over its limit {limit / 1e9:.2f} GB "
                f"({whole / 1e9:.2f} GB of weights, {over / 1e9:.2f} GB "
                "beyond them at P=1)")
        by_path[f"tpfam_{label}_p{P}"] = launches
        notes.append(f"P={P}: {', '.join(c[0] for c in mine)} equal P=1 "
                     f"in {time.perf_counter() - t1:.1f} s, peak "
                     f"{peak / 1e9:.2f} GB (limit {limit / 1e9:.2f}); "
                     "launches " + ", ".join(
                         f"{k} {v}" for k, v in launches.items() if v))
    del host
    gc.collect()
    torch.cuda.empty_cache()
    log("tpfam", f"{label}: {whole / 1e9:.2f} GB of fp32 weights, P=1 "
        f"references {t_ref:.1f} s holding {over / 1e9:.2f} GB beyond "
        "them; " + "; ".join(notes))
    return by_path


def tpf_hubert(torch, dev):
    """hubert-xlarge at published size, fp32: the frame logits of B x 512
    frames at P = 2 and 4 (Engine.create(strategy="dense", mesh=) places
    the encoder; Model.prefill over the engine's params) against P = 1's;
    the maximum absolute difference logged and held within 1e-4 (fp32
    sums in another order differ by a few 1e-6; a bf16 or a partly wrong
    reduction by far more), the peak under 1.5x the weights. Bidirectional
    attention takes no kernel. Returns the launches by path."""
    import gc
    import numpy as np
    from repro_torch import kernels as K
    from repro_torch.api import Engine
    from repro_torch.data import DataPipeline
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.model import ModelFlags, build_model
    from repro_torch.sharding.serving import to_host
    run = df_config("hubert-xlarge", None, "float32")
    model = build_model(run, ModelFlags(**ALL_KERNELS))
    params = model.init(torch.Generator(device=dev).manual_seed(12), dev)
    whole = sum(x.numel() * x.element_size() for x in tree_leaves(params))
    frames = torch.as_tensor(DataPipeline(run.model, B, HUBERT_S, seed=4)
                             .next()["frames"], device=dev)
    with torch.no_grad():
        ref, _, _ = model.prefill(params, {"frames": frames})
    torch.cuda.synchronize()
    host = to_host(params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    by_path, notes = {}, []
    top = float(ref.abs().max())
    for P in TP_DEGREES:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()                 # ---- the main path ----
        e = Engine.create(model, host, None, strategy="dense",
                          mesh=tp_mesh(P))
        with torch.no_grad():
            got, cache, _ = e.model.prefill(e.params, {"frames": frames})
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)        # ---- read right after ----
        peak = torch.cuda.max_memory_allocated()
        diff = float((got - ref).abs().max())
        require(cache is None and got.shape == ref.shape and bool(
            torch.isfinite(got).all()), f"tpfam hubert P={P}: frame logits")
        require(diff <= 1e-4, f"tpfam hubert P={P}: frame logits differ "
                f"from P=1 by {diff:.3g} (largest {top:.3g})")
        require(peak < 1.5 * whole, f"tpfam hubert P={P}: peak "
                f"{peak / 1e9:.2f} GB for {whole / 1e9:.2f} GB of weights")
        by_path[f"tpfam_hubert-xlarge_p{P}"] = launches
        notes.append(f"P={P} max |diff| {diff:.3g}, peak {peak / 1e9:.2f} "
                     "GB")
        del e, got
        torch.cuda.empty_cache()
    log("tpfam", f"hubert-xlarge (published size, fp32, {whole / 1e9:.2f} "
        f"GB): frame logits {B}x{HUBERT_S} at P = 2, 4 against P = 1 "
        f"(largest |logit| {top:.4g}): " + "; ".join(notes)
        + f"; launches {sum(by_path[k][n] for k in by_path for n in by_path[k])}"
        " (bidirectional attention takes no kernel)")
    del host, ref
    gc.collect()
    torch.cuda.empty_cache()
    return by_path


def tp_family_phase(torch, dev):
    """Phase 17: tensor-parallel serving of the remaining families with
    every shard on the one card, each model at fp32 and freed before the
    next. Returns the launches by path."""
    import dataclasses
    import gc
    import numpy as np
    from repro_torch.api import SpecEEStrategy
    from repro_torch.models.model import ModelFlags, build_model
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log("tpfam", card_line())
    by_path = {}
    rng = np.random.default_rng(170)

    # mamba2-130m at published size: SpecEE (P = 1, 2, 4), serving (P = 2)
    run = mamba(24, "float32", max_batch=SERVE_BATCH, max_seq_len=1024,
                page_size=PAGE)
    m = build_model(run, ModelFlags(**MAMBA_KERNELS))
    prompts = rng.integers(0, M_V, (B, FULL_PROMPT))
    n_ssd = {}

    def ssd_once_per_shard(P, case, launches):
        if case == "specee":            # one prefill: a launch per layer
            n_ssd[P] = launches["ssd_chunk"]   # and shard
            require(n_ssd[P] == 24 * P, f"tpfam mamba2 P={P}: ssd_chunk "
                    f"launched {n_ssd[P]} times in a prefill, not 24 x {P}")

    by_path.update(_tpf_family(
        torch, dev, "mamba2-130m", run,
        [("specee", m, SpecEEStrategy(), "dense", prompts, None, None),
         ("serve", m, "serve", "paged", None, None, (2,))],
        TP_DEGREES, MAMBA_PATH, check=ssd_once_per_shard, small=True))

    # recurrentgemma-9b's widths, one unit of 3 layers: dense and paged
    # caches, and the int8 KV cache at P = 2 (n_rep 8 and 4 at hd 256)
    run = df_config("recurrentgemma-9b", None, "float32")
    run = dataclasses.replace(run, model=dataclasses.replace(
        run.model, num_layers=TPF_RG_LAYERS,
        block_pattern=run.model.block_pattern[:TPF_RG_LAYERS]))
    rows = [rng.integers(0, run.model.vocab_size, n) for n in TPF_RG_PROMPTS]
    m = build_model(run, ModelFlags(**ALL_KERNELS))
    mq = build_model(run, ModelFlags(**ALL_KERNELS, kv_quant=True))
    by_path.update(_tpf_family(
        torch, dev, "recurrentgemma-9b", run,
        [("specee dense", m, SpecEEStrategy(), "dense", rows, None, None),
         ("specee paged", m, SpecEEStrategy(), "paged", rows, None, None),
         ("specee paged kv_quant", mq, SpecEEStrategy(), "paged", rows,
          None, (2,))],
        TP_DEGREES, TPF_RG_PATH))

    # dbrx-132b's widths, one layer: both MoE forms
    run = df_config("dbrx-132b", 1, "float32")
    prompts = rng.integers(0, run.model.vocab_size, (B, FULL_PROMPT))
    by_path.update(_tpf_family(
        torch, dev, "dbrx-132b", run,
        [(f"specee moe_impl={impl}", build_model(run, ModelFlags(
            **ALL_KERNELS, moe_impl=impl)), SpecEEStrategy(), "dense",
          prompts, None, None) for impl in ("dense", "topk")],
        TP_DEGREES, TPF_MOE_PATH))

    # qwen3-moe's widths, one layer, the top-k form at P = 4
    run = df_config("qwen3-moe-235b-a22b", 1, "float32")
    prompts = rng.integers(0, run.model.vocab_size, (B, FULL_PROMPT))
    by_path.update(_tpf_family(
        torch, dev, "qwen3-moe-235b-a22b", run,
        [("specee moe_impl=topk", build_model(run, ModelFlags(
            **ALL_KERNELS, moe_impl="topk")), SpecEEStrategy(), "paged",
          prompts, None, None)],
        (4,), TPF_MOE_PATH[1:] + ("paged_decode_attention",)))

    # internvl2-26b's widths, 4 layers: dense decode over 256 patches
    run = df_config("internvl2-26b", TPF_VLM_LAYERS, "float32")
    prompts = rng.integers(0, run.model.vocab_size, (B, FULL_PROMPT))
    patches = rng.standard_normal((B, NF_PATCHES, 1024)).astype(np.float32)
    by_path.update(_tpf_family(
        torch, dev, "internvl2-26b", run,
        [("dense", build_model(run, ModelFlags(**ALL_KERNELS)), "dense",
          "dense", prompts, patches, None)],
        TP_DEGREES, VLM_PATH))

    by_path.update(tpf_hubert(torch, dev))
    log("tpfam", f"phase 17 took {time.perf_counter() - t0:.1f} s; every "
        "shard on cuda:0 (no copy between cards made or measured)")
    return by_path


# ---------------------------------------------------------------------------
# phase 18: training under a (DATA, MODEL) mesh
# ---------------------------------------------------------------------------
TM_LAYERS, TM_B, TM_SEQ, TM_STEPS = 2, 8, 256, 3   # llama2-7b's run
TM_MESHES = ((2, 2), (1, 4))
TM_MOE_B, TM_MOE_SEQ = 2, 128                      # qwen3-moe, 1 layer
TM_MAMBA_B, TM_MAMBA_SEQ = 4, 256                  # mamba2-130m, 24 layers
TM_RG_LAYERS, TM_RG_B, TM_RG_SEQ = 3, 2, 128       # recurrentgemma-9b
TM_FP32_REL = 1e-3          # |grad diff| over the leaf's largest |grad|
TM_BF16_REL = 4 * 2.0 ** -8  # four bf16 spacings of the leaf's largest
TM_BF16_LOSS = 2.0 ** -8     # the loss within one bf16 spacing


def tm_mesh(D: int, P: int):
    """A (D, P) mesh with every slot on cuda:0."""
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh(D, P, device="cuda:0")


def _tm_grads(torch, model, params, batch, tm=None):
    """(loss, gradients) of one batch: unsharded through ``train_loss``
    (the gradients whole), or over ``tm``'s mesh through
    ``train_loss_rows`` with the copies' all-reduce (the gradients
    placed)."""
    from repro_torch.models.common import tree_leaves, tree_unflatten
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
    p = tree_unflatten(params, leaves)
    if tm is None:
        loss, _ = model.train_loss(p, batch)
    else:
        loss, _ = model.train_loss_rows(p, tm.split_batch(batch), tm)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = tree_unflatten(params, [torch.zeros_like(x) if g is None else g
                                    for x, g in zip(leaves, grads)])
    del leaves, p
    if tm is not None:
        grads = tm.reduce_grads(grads)
    return float(loss.detach()), grads


def _tm_worst(torch, dev, tm, got, want) -> float:
    """The largest |got - want| over the leaf's largest |want|, leaf by
    leaf on the card (``got`` placed on ``tm``'s mesh, or whole; ``want``
    whole, on the host or the card)."""
    if isinstance(want, dict):
        return max(_tm_worst(torch, dev, tm, got[k], want[k]) for k in want)
    if isinstance(want, (list, tuple)):
        return max(_tm_worst(torch, dev, tm, g, w) for g, w in
                   zip(got, want))
    g = tm.unplace(got, dev) if tm is not None else got
    w = want.to(dev)
    return float((g.float() - w.float()).abs().max()
                 / w.float().abs().max().clamp(min=1e-30))


def _tm_free(torch) -> None:
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _tm_counts():
    from repro_torch.runtime import collectives as C
    return {k: dict(v) for k, v in C.COUNTS.items()}


def _tm_counts_str(counts, per: int = 1) -> str:
    """The collectives over 'data' (per step when ``per`` is the steps)."""
    return ", ".join(f"{k} {v['calls'] / per:g} calls "
                     f"{v['bytes'] / per / 1e9:.3f} GB"
                     for k, v in counts.items())


def tm_llama(torch, dev):
    """llama2-7b at full width, 2 layers, remat="full" (the launcher's
    default): 3 TrainLoop steps unsharded, then at (2, 2) and (1, 4)
    under fsdp_tp (microbatch by JAX's rule, max(B // 16, D)); losses and
    grad norms at rtol 1e-4."""
    import dataclasses
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.model import ModelFlags, build_model
    from repro_torch.runtime import collectives as C
    from repro_torch.train import TrainLoop
    run = llama(TM_LAYERS, "float32")
    model = build_model(run, ModelFlags(remat="full"))
    gen = torch.Generator(device=dev).manual_seed(180)
    host = tree_map(lambda x: x.cpu(), model.init(gen, dev))
    n_params = sum(x.numel() for x in tree_leaves(host))

    def train(mesh, D):
        r = dataclasses.replace(run, train=dataclasses.replace(
            run.train, global_batch=TM_B, seq_len=TM_SEQ,
            microbatch=max(TM_B // 16, D)))
        _tm_free(torch)
        params = host if mesh is not None else tree_map(
            lambda x: x.to(dev), host)
        loop = TrainLoop(model, r, params, mesh=mesh)
        del params
        C.reset_counts()
        stats = [loop.run_steps(1) for _ in range(TM_STEPS)]
        torch.cuda.synchronize()
        return loop, stats, _tm_counts(), \
            torch.cuda.max_memory_allocated() / 1e9

    loop, ref, _, peak0 = train(None, 1)
    step0 = sum(s["step_time"] for s in ref[1:]) / (TM_STEPS - 1) * 1e3
    want = tree_map(lambda x: x.cpu(), loop.params)
    del loop
    log("trainmesh", f"llama2-7b {TM_LAYERS} layers fp32 "
        f"({n_params / 1e9:.3f} B params), B={TM_B} x {TM_SEQ}, remat full, "
        f"unsharded (microbatch 1): losses "
        f"{[round(s['loss'], 6) for s in ref]}, grad norms "
        f"{[round(s['grad_norm'], 6) for s in ref]}, step "
        f"{step0:.1f} ms (steps 2-{TM_STEPS}), peak {peak0:.2f} GB")
    results = {"unsharded": (step0, peak0, None)}
    for D, P in TM_MESHES:
        loop, stats, counts, peak = train(tm_mesh(D, P), D)
        for a, b in zip(stats, ref):
            for key in ("loss", "grad_norm"):
                require(abs(a[key] - b[key]) <= 1e-4 * abs(b[key]),
                        f"trainmesh llama ({D}, {P}) step {key} "
                        f"{a[key]} vs unsharded {b[key]}")
        worst = max(float((x - y.to(dev)).abs().max()) for x, y in zip(
            tree_leaves(loop.whole(dev)["params"]), tree_leaves(want)))
        ms = sum(s["step_time"] for s in stats[1:]) / (TM_STEPS - 1) * 1e3
        results[(D, P)] = (ms, peak, counts)
        log("trainmesh", f"llama2-7b at ({D}, {P}) fsdp_tp, microbatch "
            f"{max(TM_B // 16, D)}: losses "
            f"{[round(s['loss'], 6) for s in stats]}, grad norms "
            f"{[round(s['grad_norm'], 6) for s in stats]} (rtol 1e-4 "
            f"of unsharded: ok), largest param diff after {TM_STEPS} "
            f"steps {worst:.3e}; step {ms:.1f} ms (unsharded "
            f"{step0:.1f}), peak {peak:.2f} GB (unsharded {peak0:.2f}); "
            f"per step: {_tm_counts_str(counts, TM_STEPS)}")
        del loop
    return results


def tm_moe(torch, dev):
    """qwen3-moe-235b-a22b at full width, 1 layer (E 128, top-8, D 4096,
    F 1536): loss and gradients of one batch at (2, 2) with expert
    parallelism, plain, with moe_ep_quant (act_batch_axes "data") and
    with moe_bf16_reduce, each against the unsharded run with the same
    flags made first. Its gradients stay on the card while the whole
    weights are dropped (joined again from the placed tree for the next
    run), so the two sets of gradients fit beside the placed weights.
    Forward and backward only: params, gradients and two AdamW moments
    would be ~60 GB before the mesh's copies."""
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.model import ModelFlags, build_model
    from repro_torch.runtime import collectives as C
    from repro_torch.sharding.training import TrainMesh
    run = df_config("qwen3-moe-235b-a22b", 1, "float32")
    gen = torch.Generator(device=dev).manual_seed(181)
    params = build_model(run).init(gen, dev)
    gb = sum(x.numel() for x in tree_leaves(params)) * 4 / 1e9
    tokens = torch.randint(0, run.model.vocab_size, (TM_MOE_B, TM_MOE_SEQ),
                           generator=torch.Generator().manual_seed(182))
    batch = {"tokens": tokens.to(dev)}
    mesh = tm_mesh(2, 2)
    tm = TrainMesh(build_model(run), mesh)
    placed = tm.place(params, tm.specs(params))
    out = {}
    for label, flags, bound, loss_rel in (
            ("EP", {}, TM_FP32_REL, 1e-4),
            ("EP + moe_ep_quant", dict(moe_ep_quant=True,
                                       act_batch_axes="data"), TM_BF16_REL,
             1e-4),
            ("EP + moe_bf16_reduce", dict(moe_bf16_reduce=True),
             TM_BF16_REL, TM_BF16_LOSS)):
        model = build_model(run, ModelFlags(**flags))
        if params is None:              # the whole weights, joined again
            params = tm.unplace(placed, dev)
        _tm_free(torch)
        t0 = time.perf_counter()
        loss1, ref = _tm_grads(torch, model, params, batch)
        torch.cuda.synchronize()
        ms1 = (time.perf_counter() - t0) * 1e3
        peak1 = torch.cuda.max_memory_allocated() / 1e9
        params = None                   # the gradients stay on the card
        tm = TrainMesh(model, mesh)
        _tm_free(torch)
        C.reset_counts()
        t0 = time.perf_counter()
        loss2, g = _tm_grads(torch, model, placed, batch, tm)
        torch.cuda.synchronize()
        ms2 = (time.perf_counter() - t0) * 1e3
        peak2 = torch.cuda.max_memory_allocated() / 1e9
        counts = _tm_counts()
        worst = _tm_worst(torch, dev, tm, g, ref)
        del g, ref
        require(abs(loss2 - loss1) <= loss_rel * abs(loss1),
                f"trainmesh qwen3-moe {label}: loss {loss2} vs {loss1}")
        require(worst <= bound, f"trainmesh qwen3-moe {label}: gradient "
                f"diff {worst:.3e} of the leaf's largest > {bound:.3e}")
        out[label] = (ms1, ms2, peak1, peak2, counts)
        log("trainmesh", f"qwen3-moe-235b-a22b 1 layer fp32 ({gb:.2f} GB "
            f"of weights), B={TM_MOE_B} x {TM_MOE_SEQ}, {label} at (2, 2): "
            f"loss {loss2:.7f} vs unsharded {loss1:.7f} (rel "
            f"{abs(loss2 - loss1) / abs(loss1):.2e}, bound {loss_rel:.1e}), "
            f"largest grad diff {worst:.3e} of the leaf's largest (bound "
            f"{bound:.3e}); forward+backward {ms2:.1f} ms (unsharded "
            f"{ms1:.1f}, first calls), peak {peak2:.2f} GB beside the "
            f"unsharded gradients (unsharded {peak1:.2f} beside the placed "
            f"weights); {_tm_counts_str(counts)}")
    del params, placed
    return out


def tm_family(torch, dev, label, run, D, P, B, S, seed):
    """One batch's loss and gradients at (D, P) against unsharded, both
    on the card, in fp32. Returns the weights (on the card)."""
    from repro_torch.models.model import build_model
    from repro_torch.runtime import collectives as C
    from repro_torch.sharding.training import TrainMesh
    model = build_model(run)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = model.init(gen, dev)
    tokens = torch.randint(0, run.model.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(seed))
    batch = {"tokens": tokens.to(dev)}
    _tm_free(torch)
    loss1, ref = _tm_grads(torch, model, params, batch)
    peak1 = torch.cuda.max_memory_allocated() / 1e9
    tm = TrainMesh(model, tm_mesh(D, P))
    placed = tm.place(params, tm.specs(params))
    C.reset_counts()
    loss2, g = _tm_grads(torch, model, placed, batch, tm)
    peak2 = torch.cuda.max_memory_allocated() / 1e9
    worst = _tm_worst(torch, dev, tm, g, ref)
    require(abs(loss2 - loss1) <= 1e-4 * abs(loss1),
            f"trainmesh {label}: loss {loss2} vs {loss1}")
    require(worst <= TM_FP32_REL, f"trainmesh {label}: gradient diff "
            f"{worst:.3e} of the leaf's largest")
    log("trainmesh", f"{label} at ({D}, {P}), B={B} x {S}: loss "
        f"{loss2:.7f} vs unsharded {loss1:.7f}, largest grad diff "
        f"{worst:.3e} of the leaf's largest; peak {peak2:.2f} GB "
        f"(unsharded {peak1:.2f}); {_tm_counts_str(_tm_counts())}")
    del placed, g, ref
    return params


def tm_checkpoint(torch, dev, run, params):
    """A TrainLoop at (2, 2) for TM_STEPS steps, saved, and restored at
    (1, 2) and without a mesh: params, AdamW m and v and the step
    bit-equal once gathered (mamba2-130m at published size; llama2-7b's
    8.00 GB of params, m and v took 17.5 s to save and 19.2 s to restore
    in this phase, PR 32's first chip run, so the round trip uses the
    smaller model)."""
    import dataclasses
    import tempfile
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.model import build_model
    from repro_torch.train import TrainLoop
    model = build_model(run)
    host = tree_map(lambda x: x.cpu(), params)
    r = dataclasses.replace(run, train=dataclasses.replace(
        run.train, global_batch=TM_MAMBA_B, seq_len=TM_MAMBA_SEQ,
        microbatch=max(TM_MAMBA_B // 16, 2)))
    with tempfile.TemporaryDirectory() as ck:
        loop = TrainLoop(model, r, host, ckpt_dir=ck, mesh=tm_mesh(2, 2))
        losses = [loop.run_steps(1)["loss"] for _ in range(TM_STEPS)]
        t0 = time.perf_counter()
        loop.save()
        loop.ckpt.wait()
        t1 = time.perf_counter()
        saved = loop.whole(dev)
        gb = sum(x.numel() * x.element_size()
                 for x in tree_leaves(saved)) / 1e9
        del loop
        times = []
        for label, mesh in (("(1, 2)", tm_mesh(1, 2)), ("no mesh", None)):
            t2 = time.perf_counter()
            back = TrainLoop(model, r, host if mesh is not None else
                             tree_map(lambda x: x.to(dev), host),
                             ckpt_dir=ck, mesh=mesh)
            require(back.try_restore() and back.step == TM_STEPS,
                    f"trainmesh: the (2, 2) checkpoint did not restore at "
                    f"{label}")
            got = back.whole(dev)
            require(all(torch.equal(x, y) for x, y in zip(
                tree_leaves(got), tree_leaves(saved))),
                f"trainmesh: the checkpoint restored at {label} differs")
            times.append(time.perf_counter() - t2)
            del back, got
    log("trainmesh", f"mamba2-130m TrainLoop at (2, 2), {TM_STEPS} steps "
        f"(losses {[round(x, 6) for x in losses]}); checkpoint of "
        f"{gb:.2f} GB (params, AdamW m and v, whole) saved in "
        f"{t1 - t0:.1f} s, restored at (1, 2) in {times[0]:.1f} s and "
        f"without a mesh in {times[1]:.1f} s: bit-equal")


def trainmesh_phase(torch, dev):
    """Phase 18: training under a (DATA, MODEL) mesh at fsdp_tp, every
    slot on cuda:0, fp32 with TF32 off. The path runs no kernel (the
    flash and SSD kernels have no backward, so training never takes
    them): its launches are counted and must stay 0. Returns the launches
    by path."""
    import dataclasses
    from repro_torch import kernels as K
    _tm_free(torch)
    t0 = time.perf_counter()
    log("trainmesh", card_line())
    K.reset_launches()
    tm_llama(torch, dev)
    _tm_free(torch)
    tm_moe(torch, dev)
    _tm_free(torch)
    run = mamba(24, "float32")
    params = tm_family(torch, dev, "mamba2-130m (published size; "
                       "head-aligned SSD leaves, B/C whole on every "
                       "shard, the tied head)", run, 2, 2, TM_MAMBA_B,
                       TM_MAMBA_SEQ, 183)
    tm_checkpoint(torch, dev, run, params)
    del params
    _tm_free(torch)
    run = df_config("recurrentgemma-9b", None, "float32")
    run = dataclasses.replace(run, model=dataclasses.replace(
        run.model, num_layers=TM_RG_LAYERS,
        block_pattern=run.model.block_pattern[:TM_RG_LAYERS]))
    tm_family(torch, dev, f"recurrentgemma-9b {TM_RG_LAYERS} layers (one "
              "KV head on 4 shards)", run, 1, 4, TM_RG_B, TM_RG_SEQ, 184)
    _tm_free(torch)
    launches = dict(K.LAUNCHES)
    require(not any(launches.values()),
            f"trainmesh: the training path launched kernels {launches}")
    log("trainmesh", f"phase 18 took {time.perf_counter() - t0:.1f} s; "
        "every slot on cuda:0 (ZeRO-3 saves no memory on one card; no copy "
        "between cards made or measured); no kernel launched")
    return {"trainmesh": launches}


# ---------------------------------------------------------------------------
# phase 19: serving with DATA > 1 — a (DATA, MODEL) mesh inside one engine
# ---------------------------------------------------------------------------
TPD_LAYERS = 2                # llama2-70b's depth here: 8.9 GB of fp32
TPD_PROMPT, TPD_STEPS = 64, 8  # whole-batch rows of B prompt tokens; steps
TPD_SLOTS, TPD_REQS, TPD_NEW = 4, 8, 8   # ServingEngine slots, requests
TPD_MESHES = ((2, 1, "tp2d"), (2, 2, "tp_dp"), (2, 2, "tp2d"),
              (2, 2, "fsdp_tp"), (4, 1, "tp2d"))
TPD_RG_LAYERS = 3             # recurrentgemma-9b: one unit
TPD_AR_PATH = AR_PATH + ("flash_attention",)
TPD_SERVE_PATH = SERVE_PATH + ("flash_attention",)


def dp_mesh(D: int, P: int):
    """A (D, P) mesh with every slot on cuda:0 (no copy between cards)."""
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh(D, P, device="cuda:0")


def _tpd_whole(torch, model, params, sw, strategy, prompts, mesh, policy,
               cache="dense", quant=None):
    """A whole-batch session over ``mesh`` (None: the card alone):
    ``prefill`` then TPD_STEPS steps. Returns ((each row's tokens, each
    step's exit points, exits and units_run), ms a step by the host clock
    over the steps after the first two (each step ends in its host reads),
    the 'data' collectives' calls and bytes a step by kind)."""
    from repro_torch.api import Engine
    from repro_torch.runtime import collectives as C
    e = Engine.create(model, params, sw, strategy=strategy, quant=quant,
                      mesh=mesh, policy=policy)
    s = e.new_session(cache=cache)
    first = s.prefill(prompts, max_new_tokens=TPD_STEPS * e.emit_width + 1)
    toks = [list(first.row_tokens(b)) for b in range(first.batch)]
    info, stamps = [], []
    torch.cuda.synchronize()
    C.reset_counts()
    stamps.append(time.perf_counter())
    while not s.all_done():
        r = s.step()
        stamps.append(time.perf_counter())
        info.append((r.exit_layer.tolist(), r.exited.tolist(),
                     int(r.units_run)))
        for b in range(r.batch):
            toks[b].extend(int(t) for t in r.row_tokens(b))
    n = len(info)
    warm = stamps[2:] if n > 2 else stamps
    ms = (warm[-1] - warm[0]) * 1e3 / max(1, len(warm) - 1)
    return (toks, info), ms, {k: (v["calls"] / n, v["bytes"] / n)
                              for k, v in C.COUNTS.items()}


def _tpd_serve(torch, model, params, sw, prompts, mesh, policy):
    """``ServingEngine`` on the paged cache, TPD_SLOTS slots, blocking
    admission: every request's tokens and exit points, every page back.
    Returns (outputs, ms a tick, the 'data' collectives a tick)."""
    from repro_torch.runtime import collectives as C
    from repro_torch.serving import ServingEngine
    se = ServingEngine(model, params, sw, strategy="specee", cache="paged",
                       prefill_chunk=0, mesh=mesh, policy=policy)
    reqs = [se.submit(p, max_new_tokens=TPD_NEW) for p in prompts]
    torch.cuda.synchronize()
    C.reset_counts()
    t0 = time.perf_counter()
    se.run_to_completion()
    torch.cuda.synchronize()
    ticks = max(1, se._tick)
    ms = (time.perf_counter() - t0) * 1e3 / ticks
    mgr = se.session.cache_mgr
    require(mgr.free_pages == mgr.num_pages,
            f"tpdata: {mgr.free_pages} of {mgr.num_pages} pages free")
    out = [(r.output, r.exit_points) for r in reqs]
    se.close()
    return out, ms, {k: (v["calls"] / ticks, v["bytes"] / ticks)
                     for k, v in C.COUNTS.items()}


def _tpd_counts_str(counts) -> str:
    return ", ".join(f"{k} {c:.1f} calls {b / 1e9:.3f} GB"
                     for k, (c, b) in counts.items() if c) or "none"


def _tpd_family(torch, dev, label, run, cases, meshes, seed=19):
    """One config at fp32: its weights seeded on the card and each case
    run there (a mesh engine quantizes on its lead card too), the weights
    moved to the host and the card's copy freed, then each (D, P, policy) of
    ``meshes`` (every slot on cuda:0) with the launch counts zeroed right
    before and read right after: each case's tokens, exit points and
    units_run must equal the (1, 1) run's and its path's kernels must
    launch. ``cases``: (name, model, kind "whole" | "serve", strategy,
    cache, prompts, quant, path, meshes or None: all). Logs ms a step or
    tick, the peak card memory against the weights and the 'data'
    collectives. Returns the launches by path."""
    import gc
    from repro_torch import kernels as K
    from repro_torch.models.common import tree_leaves, with_contiguous_head
    from repro_torch.sharding.serving import to_host
    t0 = time.perf_counter()
    params, sw = _seeded(torch, dev, run, seed)
    whole = sum(x.numel() * x.element_size() for x in tree_leaves(
        (with_contiguous_head(params), sw)) if isinstance(x, torch.Tensor))
    torch.cuda.synchronize()
    t_seed = time.perf_counter() - t0

    def go(case, p, s, mesh, policy):
        name, model, kind, strategy, cache, prompts, quant, _, _ = case
        if kind == "serve":
            return _tpd_serve(torch, model, p, s, prompts, mesh, policy)
        return _tpd_whole(torch, model, p, s if strategy != "dense" else
                          None, strategy, prompts, mesh, policy, cache,
                          quant)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ref = {c[0]: go(c, params, sw, None, "tp_dp") for c in cases}
    torch.cuda.synchronize()
    peak1 = torch.cuda.max_memory_allocated()
    t_ref = time.perf_counter() - t0 - t_seed
    host = to_host(params), to_host(sw)
    del params, sw
    gc.collect()
    torch.cuda.empty_cache()
    t_host = time.perf_counter() - t0 - t_seed - t_ref
    notes = [f"seeded {t_seed:.1f} s, (1, 1) runs {t_ref:.1f} s, to the "
             f"host {t_host:.1f} s; (1, 1): " + "; ".join(
                 f"{n} {r[1]:.2f} ms" for n, r in ref.items())
             + f", peak {peak1 / 1e9:.2f} GB"]
    by_path = {}
    for D, P, policy in meshes:
        mine = [c for c in cases if c[8] is None or (D, P, policy) in c[8]]
        if not mine:
            continue
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        K.reset_launches()                 # ---- the main path ----
        got = {c[0]: go(c, *host, dp_mesh(D, P), policy) for c in mine}
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)        # ---- read right after ----
        peak = torch.cuda.max_memory_allocated()
        for c in mine:
            require(got[c[0]][0] == ref[c[0]][0], f"tpdata {label} {c[0]} "
                    f"at ({D}, {P}) {policy} differs from (1, 1)")
        need = sorted({k for c in mine for k in c[7]})
        missing = [k for k in need if launches[k] == 0]
        require(not missing, f"tpdata {label} ({D}, {P}) {policy}: kernels "
                f"never launched: {missing}")
        by_path[f"tpdata_{label}_{D}x{P}_{policy}"] = launches
        notes.append(
            f"({D}, {P}) {policy}: " + "; ".join(
                f"{n} {r[1]:.2f} ms ({ref[n][1]:.2f} at (1, 1)), 'data' "
                f"per step or tick: {_tpd_counts_str(r[2])}"
                for n, r in got.items())
            + f"; equal (1, 1) in {time.perf_counter() - t1:.1f} s, peak "
            f"{peak / 1e9:.2f} GB ({peak / whole:.2f}x the weights); "
            "launches " + ", ".join(f"{k} {v}" for k, v in launches.items()
                                    if v))
    del host
    gc.collect()
    torch.cuda.empty_cache()
    log("tpdata", f"{label}: {whole / 1e9:.2f} GB of fp32 weights, "
        f"{time.perf_counter() - t0:.1f} s; " + " | ".join(notes))
    return by_path


def tpdata_phase(torch, dev):
    """Phase 19: serving over (DATA, MODEL) meshes with DATA > 1, every
    slot on the one card, each model at fp32 and freed before the next.
    Returns the launches by path."""
    import dataclasses
    import gc
    import numpy as np
    from repro_torch.api import SpecEEStrategy, TreeStrategy
    from repro_torch.core.tree import TreeSpec
    from repro_torch.models.model import ModelFlags, build_model
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log("tpdata", card_line())
    by_path = {}
    rng = np.random.default_rng(190)

    def rows(run, n=B):
        return rng.integers(0, run.model.vocab_size, (n, TPD_PROMPT))

    def requests(run):
        return [rng.integers(0, run.model.vocab_size, int(n))
                for n in rng.integers(16, 96, TPD_REQS)]

    # llama2-70b's widths at 2 layers: SpecEE on the dense cache and
    # ServingEngine on the paged one over every mesh; tree and int8 at
    # (2, 2) tp2d
    run = df_config("llama2-70b", TPD_LAYERS, "float32",
                    max_batch=TPD_SLOTS, max_seq_len=256, page_size=PAGE)
    m = build_model(run, ModelFlags(**ALL_KERNELS))
    mt = build_model(run, ModelFlags(**TREE_KERNELS))
    at = ((2, 2, "tp2d"),)
    by_path.update(_tpd_family(torch, dev, "llama2-70b", run, [
        ("specee dense", m, "whole", SpecEEStrategy(), "dense", rows(run),
         None, TPD_AR_PATH, None),
        ("serve paged", m, "serve", None, "paged", requests(run), None,
         TPD_SERVE_PATH, None),
        ("tree dense", mt, "whole",
         TreeStrategy(TreeSpec(TREE_DEPTH, TREE_BRANCH)), "dense",
         rows(run), None, TREE_PATH, at),
        ("specee int8", m, "whole", SpecEEStrategy(), "dense", rows(run),
         "int8", quantized(AR_PATH), at)], TPD_MESHES))

    # dbrx-132b's widths, 1 layer, both MoE forms: expert parallelism at
    # (2, 2) (16 experts over 2 rows)
    run = df_config("dbrx-132b", 1, "float32")
    prompts = rows(run)
    by_path.update(_tpd_family(torch, dev, "dbrx-132b", run, [
        (f"specee moe_impl={impl}", build_model(run, ModelFlags(
            **ALL_KERNELS, moe_impl=impl)), "whole", SpecEEStrategy(),
         "dense", prompts, None, TPD_AR_PATH, None)
        for impl in ("dense", "topk")], ((2, 2, "tp_dp"),)))

    # qwen3-moe's widths, 1 layer, top-k on the paged cache at (2, 2)
    run = df_config("qwen3-moe-235b-a22b", 1, "float32")
    by_path.update(_tpd_family(torch, dev, "qwen3-moe-235b-a22b", run, [
        ("specee moe_impl=topk paged", build_model(run, ModelFlags(
            **ALL_KERNELS, moe_impl="topk")), "whole", SpecEEStrategy(),
         "paged", rows(run), None, TPD_AR_PATH[:3] + (
             "flash_attention", "paged_decode_attention"), None)],
        ((2, 2, "tp_dp"),)))

    # mamba2-130m at published size: ServingEngine at (2, 2)
    run = mamba(24, "float32", max_batch=TPD_SLOTS, max_seq_len=256,
                page_size=PAGE)
    by_path.update(_tpd_family(torch, dev, "mamba2-130m", run, [
        ("serve", build_model(run, ModelFlags(**MAMBA_KERNELS)), "serve",
         None, "paged", requests(run), None, MAMBA_PATH, None)],
        ((2, 2, "tp2d"),)))

    # recurrentgemma-9b's widths, one unit of 3 layers: dense and paged
    run = df_config("recurrentgemma-9b", None, "float32")
    run = dataclasses.replace(run, model=dataclasses.replace(
        run.model, num_layers=TPD_RG_LAYERS,
        block_pattern=run.model.block_pattern[:TPD_RG_LAYERS]))
    m = build_model(run, ModelFlags(**ALL_KERNELS))
    prompts = rows(run)
    by_path.update(_tpd_family(torch, dev, "recurrentgemma-9b", run, [
        (f"specee {cache}", m, "whole", SpecEEStrategy(), cache, prompts,
         None, TPD_AR_PATH[:3] + ("flash_attention", "decode_attention"
                                  if cache == "dense" else
                                  "paged_decode_attention"), None)
        for cache in ("dense", "paged")], ((2, 2, "tp2d"),)))
    log("tpdata", f"phase 19 took {time.perf_counter() - t0:.1f} s; every "
        "slot on cuda:0 (no copy between cards made or measured)")
    return by_path


# ---------------------------------------------------------------------------
# phase 20: the dry run on the meta device held against the card
# ---------------------------------------------------------------------------
DRY_MESHES = ((2, 2, "tp_dp"), (2, 2, "tp2d"), (2, 2, "fsdp_tp"))
DRY_B, DRY_S = 4, 256          # the decode cell's rows and cache slots
DRY_FULL_MESH = (4, 4)         # llama2-7b decode_32k at published size
DRY_RTOL = 0.01                # predicted placement bytes vs allocated


def _dry_counts():
    """One device's collectives by axis (``collectives.PER_DEVICE``)."""
    from repro_torch.runtime import collectives as C
    return {ax: {k: dict(c) for k, c in rec.items()}
            for ax, rec in C.PER_DEVICE.items()}


def _meta_answer(flag, on_meta: bool) -> bool:
    """``core.engine.host_read`` as on meta: the dry run's branch."""
    return on_meta


def _dry_counts_str(by_axis) -> str:
    return "; ".join(f"{ax} {k} {c['calls']} calls {c['bytes'] / 1e9:.4f} GB"
                     for ax, rec in by_axis.items()
                     for k, c in rec.items() if c["calls"]) or "none"


def dryrun_phase(torch, dev):
    """Phase 20: each mesh's dry run on meta, then the same placement and
    step on the card from a host copy of seeded weights: the allocation
    growth within DRY_RTOL of the predicted bytes summed over the slots,
    the step's per-device collectives equal, the card's step taking the
    meta step's branches (every unit, every exit point's gate and verify:
    ``core.engine.host_read`` answers as on meta). Then the production
    cell on meta. No kernel runs (the dry run's flags): the card part's
    launches are counted and must stay 0. Returns the launches by path."""
    import dataclasses
    import gc
    from repro_torch import kernels as K
    from repro_torch.config import ShapeCell
    from repro_torch.core import engine as eng
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import build_model
    from repro_torch.runtime import collectives as C
    from repro_torch.sharding.serving import to_host
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log("dryrun", card_line())
    cell = ShapeCell("decode_32k", "decode", DRY_S, DRY_B)
    base = df_config("llama2-70b", TPD_LAYERS, "float32")
    model = build_model(base)
    gen = torch.Generator(device=dev).manual_seed(20)
    params = model.init(gen, dev)
    sw = eng.init_specee(model, gen, dev)
    host = to_host(params), to_host(sw)
    del params, sw
    gc.collect()
    torch.cuda.empty_cache()
    log("dryrun", f"llama2-70b widths, {TPD_LAYERS} layers, fp32: seeded "
        f"and moved to the host in {time.perf_counter() - t0:.1f} s")
    K.reset_launches()                     # ---- the card's part ----
    for D, P, policy in DRY_MESHES:
        run = dataclasses.replace(base, sharding=dataclasses.replace(
            base.sharding, policy=policy))
        r = dryrun.run_cell("llama2-70b", cell.name, run=run, cell=cell,
                            mesh=make_host_mesh(D, P, "meta"))
        predicted = sum(map(sum, r["analytic_arg_bytes_per_slot"]))
        m = build_model(run, dryrun.dryrun_flags(run, cell, False, False, D))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        t1 = time.perf_counter()
        placed, step_model, _ = dryrun.place(m, run, cell, dp_mesh(D, P),
                                             host + (None,), False)
        torch.cuda.synchronize()
        grown = torch.cuda.memory_allocated() - before
        t_place = time.perf_counter() - t1
        fn = dryrun.step_fn_for(step_model, run, cell, data_extent=D)
        C.reset_counts()
        host_read, eng.host_read = eng.host_read, _meta_answer
        try:
            out = fn(*placed)
        finally:
            eng.host_read = host_read
        torch.cuda.synchronize()
        counts = _dry_counts()
        units_run = out[-1]
        del placed, out, fn, step_model
        gc.collect()
        torch.cuda.empty_cache()
        label = f"({D}, {P}) {policy}"
        log("dryrun", f"{label} predicted: argument bytes summed over the "
            f"slots {predicted} ({predicted / 1e9:.4f} GB), largest slot "
            f"{r['analytic_arg_bytes_per_device'] / 1e9:.4f} GB, temp (all "
            f"slots) {r['memory']['temp_size_in_bytes_all_slots'] / 1e9:.4f}"
            f" GB, {r['cost']['flops'] / 1e9:.3f} GFLOP, collectives "
            f"{_dry_counts_str(r['collectives_exact']['by_axis'])}; meta "
            f"run {r['lower_s']} s")
        log("dryrun", f"{label} measured: allocation growth {grown} "
            f"({grown / 1e9:.4f} GB, {grown / predicted - 1:+.4%} against "
            f"the prediction) in {t_place:.1f} s; collectives "
            f"{_dry_counts_str(counts)}; units_run {units_run} of "
            f"{r['units']}")
        require(abs(grown - predicted) <= DRY_RTOL * predicted,
                f"dryrun {label}: the card grew {grown} bytes, the dry run "
                f"predicted {predicted}")
        require(counts == r["collectives_exact"]["by_axis"],
                f"dryrun {label}: collectives {counts} on the card, "
                f"{r['collectives_exact']['by_axis']} on meta")
        require(units_run == r["units"] == r["units_run"],
                f"dryrun {label}: units_run {units_run} on the card, "
                f"{r['units_run']} on meta of {r['units']}")
    launches = dict(K.LAUNCHES)            # ---- read right after ----
    require(not any(launches.values()), f"dryrun: kernels launched "
            f"{ {k: v for k, v in launches.items() if v} }")
    del host
    gc.collect()
    torch.cuda.empty_cache()
    D, P = DRY_FULL_MESH
    r = dryrun.run_cell("llama2-7b", "decode_32k",
                        mesh=make_host_mesh(D, P, "meta"))
    slots = r["analytic_arg_bytes_per_slot"]
    log("dryrun", f"llama2-7b decode_32k (B=128, 32768 slots) at ({D}, {P})"
        f" on meta in {r['lower_s']} s: largest slot (the lead) "
        f"{slots[0][0] / 1e9:.3f} GB, the others {slots[-1][-1] / 1e9:.3f}"
        f" GB; temp (all slots) "
        f"{r['memory']['temp_size_in_bytes_all_slots'] / 1e9:.3f} GB; "
        f"{r['cost']['flops'] / 1e12:.3f} TFLOP; units_run "
        f"{r['units_run']} of {r['units']}; collectives "
        f"{_dry_counts_str(r['collectives_exact']['by_axis'])}")
    require(r["units_run"] == r["units"] == 32,
            f"dryrun llama2-7b decode_32k: units_run {r['units_run']}")
    log("dryrun", f"phase 20 took {time.perf_counter() - t0:.1f} s; every "
        "slot on cuda:0 (no copy between cards made or measured); no "
        "kernel launched")
    return {"dryrun": launches}


def profile_steps(torch, model, params, sw, prompts, step_s: float,
                  n: int = 4, phase: str = "profile") -> None:
    """torch.profiler over ``n`` more whole-batch SpecEE steps."""
    from repro_torch.api import Engine, SpecEEStrategy
    session = Engine.create(model, params, sw,
                            strategy=SpecEEStrategy()).new_session()
    session.prefill(prompts, max_new_tokens=n + 1)
    torch.cuda.synchronize()
    profile_ticks(torch, phase, session.step, n,
                  f" ({step_s * 1e3:.2f} unprofiled)")


def profile_ticks(torch, phase: str, tick, n: int, note: str = "") -> None:
    """Device time per kernel family per call of ``tick`` over ``n`` calls,
    and the device's busy share of the profiled wall time (the profiler's
    own cost inflates that wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            tick()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    fam = {name: 0.0 for name, _ in FAMILIES}
    fam.update({f"{name}_q": 0.0 for name in
                ("argmax_verify", "topk_verify", "spec_head",
                 "paged_decode_attention")})
    fam["other"] = 0.0
    total = 0.0
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        total += us / 1e3
        for name, keys in FAMILIES:
            if any(k in evt.key for k in keys):
                if (not name.endswith("_q")
                        and any(r in evt.key for r in QUANT_READERS)):
                    name += "_q"
                fam[name] += us / 1e3
                break
        else:
            fam["other"] += us / 1e3
    if total == 0.0:
        log(phase, "the profiler recorded no device time")
        return
    log(phase, f"{n} ticks: wall {wall_ms / n:.2f} ms/tick profiled{note}, "
        f"device busy {total / n:.2f} ms/tick = "
        f"{100 * total / wall_ms:.1f}% of the profiled wall; " + ", ".join(
            f"{k} {v / n:.3f} ms/tick" for k, v in
            sorted(fam.items(), key=lambda kv: -kv[1]) if v > 0))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device (torch.cuda.is_available() is False)",
              flush=True)
        return 1
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"FAIL: the port (src/repro_torch) is not beside {__file__}",
              flush=True)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 stays fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    card = card_line()
    log("device", f"{card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} card(s)")
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    reports = build.build_all()
    for name, rep in reports.items():
        regs = [ln.strip() for ln in rep.splitlines() if "registers" in ln]
        log("build", f"{rep.splitlines()[0]}; " + " | ".join(regs[:6]))
    log("build", f"{len(build.SOURCES)} kernels ready in "
        f"{time.perf_counter() - t0:.1f} s")

    errs, timing = check_kernels(torch, dev)
    torch.cuda.empty_cache()
    errs_tree, t_tree, verify_rows, sh_rows = check_tree_kernels(torch, dev)
    for name, err in errs_tree.items():
        errs[name] = max(errs.get(name, 0.0), err)
    timing.update(t_tree)
    torch.cuda.empty_cache()
    errs_q, t_q, quant_rows, qsh_rows = check_quant_kernels(torch, dev)
    errs.update(errs_q)
    timing.update(t_q)
    torch.cuda.empty_cache()
    errs_ssd, t_ssd = check_ssd_kernel(torch, dev)
    errs.update(errs_ssd)
    timing.update(t_ssd)
    torch.cuda.empty_cache()
    errs_df, t_df = check_dense_family_kernels(torch, dev)
    for name, err in errs_df.items():
        errs[name] = max(errs.get(name, 0.0), err)
    torch.cuda.empty_cache()
    errs_nf, t_nf = check_new_family_kernels(torch, dev)
    for name, err in errs_nf.items():
        errs[name] = max(errs.get(name, 0.0), err)
    torch.cuda.empty_cache()
    parity(torch, dev)
    torch.cuda.empty_cache()
    mamba_parity(torch, dev)
    torch.cuda.empty_cache()
    params, sw = full_weights(torch, dev)
    ar_launches, ar_ref = full_run(torch, dev, params, sw)
    by_path = {"whole_batch": ar_launches}
    torch.cuda.empty_cache()
    serve_launches, fp_serve = serve_phase(torch, dev, params, sw)
    by_path.update(serve_launches)
    torch.cuda.empty_cache()
    tree_launches, tree_ref = tree_phase(torch, dev, params, sw)
    by_path.update(tree_launches)
    torch.cuda.empty_cache()
    quant_launches, q8_outs = quant_phase(torch, dev, params, sw)
    by_path.update(quant_launches)
    by_path.update(kvq_phase(torch, dev, params, sw, fp_serve, q8_outs))
    del q8_outs
    torch.cuda.empty_cache()
    mamba_launches, mamba_ref = mamba_phase(torch, dev)
    by_path.update(mamba_launches)
    torch.cuda.empty_cache()
    by_path.update(mega_phase(torch, dev, params, sw, ar_ref, fp_serve,
                              tree_ref, mamba_ref))
    del params, sw, fp_serve, mamba_ref, ar_ref, tree_ref
    torch.cuda.empty_cache()
    by_path.update(trained_phase(torch, dev))
    torch.cuda.empty_cache()
    by_path.update(dense_family_phase(torch, dev))
    torch.cuda.empty_cache()
    by_path.update(serving_rest_phase(torch, dev))
    torch.cuda.empty_cache()
    by_path.update(new_family_phase(torch, dev))
    torch.cuda.empty_cache()
    by_path.update(faults_phase(torch, dev))
    torch.cuda.empty_cache()
    tp_launches, tp_timing = tp_phase(torch, dev)
    by_path.update(tp_launches)
    torch.cuda.empty_cache()
    by_path.update(tp_family_phase(torch, dev))
    torch.cuda.empty_cache()
    by_path.update(trainmesh_phase(torch, dev))
    torch.cuda.empty_cache()
    by_path.update(tpdata_phase(torch, dev))
    torch.cuda.empty_cache()
    by_path.update(dryrun_phase(torch, dev))
    log("total", f"script {time.perf_counter() - T_START:.1f} s before the "
        "kernels line")

    kernels = []
    for name in build.SOURCES:
        ms, plain, lib, (bnd, by) = timing[name][:4]
        row = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": sum(l[name] for l in by_path.values()),
            "launches_by_path": {p: l[name] for p, l in by_path.items()},
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain,
            "bound_ms": bnd, "bound_by": by, "library_ms": lib}
        if name in ("argmax_verify", "topk_verify"):
            row["at_rows"] = {
                str(R): {"ms": r[name][0], "plain_ms": r[name][1],
                         "library_ms": r[name][2], "bound_ms": r[name][3][0],
                         "bound_by": r[name][3][1]}
                for R, r in verify_rows.items()}
        if name in ("spec_head", "spec_head_gather"):
            # R = 160 above (a B = 4 tree step's node rows), B = 8's 320
            # here; the dot's with one graph of a step's gather then 3 dots
            # and the composed spec_head_logits per call at tree and random
            # ids. The gather's library_ms is torch.index_select(w, 1, ids):
            # the same elements laid out (D, C).
            row["at_rows"] = {str(R): r[name] for R, r in sh_rows.items()}
        if name == "decode_attention":
            # the full run's 150 live keys above; longer contexts here
            row["at_contexts"] = {
                f"{live} live of {S} slots": {
                    "ms": r[0], "plain_ms": r[1], "library_ms": r[2],
                    "bound_ms": r[3][0], "bound_by": r[3][1]}
                for (S, live), r in timing[name][4].items()}
        if name == "exit_gate":
            # B=4 above; every measured batch here
            row["at_rows"] = {
                str(R): {"ms": r[0], "plain_ms": r[1], "bound_ms": r[3][0],
                         "bound_by": r[3][1]}
                for R, r in timing[name][4].items()}
        if name in ("argmax_verify", "topk_verify"):
            # phase 16: the verify over P vocabulary slices of the bf16
            # head against this kernel unsharded (bit-equal), per slice
            # and for the merge
            row["at_shards"] = {
                f"V={Vt} P={P} R={R}": r
                for (n, Vt, P, R), r in tp_timing.items() if n == name}
        if name in t_df:
            # phase 2 at the dense family's shapes (n_rep 12 attention,
            # MiniCPM's and Command R+'s heads, the wider gates, flash at
            # 48 over 4 heads and at hd 64); the verify_q rows' and the
            # paged int8 row's library_ms is a yardstick (the fp tile on
            # the dequantized head; SDPA on the dequantized view)
            row["at_dense_family"] = {
                shape: {"ms": r[0], "plain_ms": r[1], "library_ms": r[2],
                        "bound_ms": r[3][0], "bound_by": r[3][1]}
                for shape, r in t_df[name].items()}
        if name in t_nf:
            # phase 2 at the new families' head shapes (n_rep 6 at 128, 16
            # at 64 and 16 at 256 in the split-KV kernels, flash at hd
            # 256); library_ms as at_dense_family's
            row["at_new_families"] = {
                shape: {"ms": r[0], "plain_ms": r[1], "library_ms": r[2],
                        "bound_ms": r[3][0], "bound_by": r[3][1]}
                for shape, r in t_nf[name].items()}
        if name == "ssd_chunk":
            # library_ms is null: no one PyTorch call computes the term
            row["yardstick_ms"] = timing[name][4]    # bmm + batched product
        if name == "paged_decode_attention_q":
            # library_ms is null: no one PyTorch call takes int8 codes
            row["yardstick_ms"] = timing[name][4]    # SDPA, dequantized
            row["fp_kernel_ms"] = timing[name][5]    # at the same keys
        if name in ("spec_head_q", "spec_head_gather_q"):
            # int8 at R = 160 above (a B = 4 tree step's node rows); every
            # measured row count, int8 and int4, at the tree's ids: the
            # dot's with one graph of a step's gather then 3 dots and the
            # composed spec_head_logits_q per call at tree and random ids,
            # both stages' with the fp stages on the dequantized head. The
            # gather's library_ms is torch.index_select(codes, 1, ids):
            # the codes alone, laid out (Dp, C).
            row["at_rows"] = {f"int{bits}": {str(R): r[name]
                                             for R, r in rows.items()}
                              for bits, rows in qsh_rows.items()}
        if name in QUANT_KERNELS:
            # int8 at B=4 above (the spec head: R=160); every measured
            # shape, int8 and int4, with
            # the fp kernel on the dequantized bf16 head as a yardstick
            # (the quantized gate's: the piecewise chain it replaced)
            row["yardstick_ms"] = timing[name][4]
            row["by_bits"] = {
                f"int{bits}": {str(R): {
                    "ms": r[name][0], "plain_ms": r[name][1],
                    "yardstick_ms": r[name][4], "bound_ms": r[name][3][0],
                    "bound_by": r[name][3][1]}
                    for R, r in rows.items() if name in r}
                for bits, rows in quant_rows.items()}
        kernels.append(row)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:                      # any failed phase fails the run
        traceback.print_exc()
        print("FAIL: a phase failed (traceback above)", flush=True)
        code = 1
    sys.exit(code)
