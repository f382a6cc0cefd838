#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``gke_ray_train_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # the default phases, one card

Phases, each printing one JSON line; any failure exits non-zero:

1. device  — nvidia-smi name and power limit, torch / CUDA versions.
2. build   — compile every CUDA kernel of the port from ``csrc/`` with
             nvcc for sm_90a (all sources at once); the line carries
             ptxas's registers and spills per entry, those of the dQ and
             fused cross-entropy wgmma kernels and of the rms_norm's
             registers body also on their own, and fails if one of those
             spills.
3. kernels — hold each kernel (flash forward, dQ, dK/dV, fused rms_norm,
             fused q/k RoPE, per-head rms_norm + RoPE, fused
             cross-entropy row statistics, dx and dhead) against its
             plain PyTorch version on the card over the
             listed cases, and time kernel, plain version and the PyTorch
             library call at the serving shapes (forward), the Llama
             training shape (the flash and the cross-entropy kernels; for
             the latter the unfused route, matmul_f32 then
             F.cross_entropy, forward and backward) and the Gemma-2
             training shape (the fused rms_norm / RoPE): device time from
             torch.profiler, per-call time between CUDA events beside it
             at the serving shapes. The flash kernels are also held and
             timed at the Gemma-2 training shape (one packed row of
             4,096, head dim 256, softcap, with and without the window),
             and timed at one 4,096-token document a row; the dQ and
             dK/dV kernels must repeat bitwise. dQ + dK/dV are timed
             against SDPA's whole backward in alternated turns. At the Llama
             shape the cross-entropy row statistics, dx and dhead must
             take the wgmma body, which is also timed against the
             mma.sync body it replaced, in alternated turns; the row
             statistics must repeat bitwise. The fused rms_norm (at
             every width its registers body is built for, and at D 64 on
             the two-pass body) must take the body ``norm_route`` picks;
             at Gemma-2's and at Llama-3.1-8B's training shapes it must
             take the registers body and repeat bitwise, and is timed
             against F.rms_norm and against the two-pass body it
             replaced, each in alternated turns.
             The per-head rms_norm + RoPE is timed at the Llama-3.1-8B q
             of the training microbatch and the Gemma-2-9B q of one
             packed row. Under tensor parallelism the kernels take a
             rank's part: flash and RoPE are held at the local heads of
             Llama-3.1-8B at model 2 and Llama-3.1-70B at model 4, and
             the cross-entropy kernels over 2 and 4 vocab shards of the
             Llama head (64,128 and 32,064 columns) through the port's
             shift and merge, against the unsharded kernel and the plain
             version, and timed on one shard with its bound and the
             two-call route on it. The pre-train entry's shapes are held
             too: flash forward, dQ and dK/dV at 16 rows of 256, 16
             heads of 128 (no GQA); rows 4-6 at its char vocab (V 45,
             under one 128-column tile, on ``mma.sync``) over 4,096 rows
             of 2,048; row 7 at D 2,048 (the two-pass body). Context
             parallelism's situations of the flash kernels (``ring_cases``:
             a rank's queries against a K/V shard wholly in the past,
             wholly in the future, whose out, lse and dQ / dK / dV must be
             exactly 0 / NEG_INF / 0, straddling packed documents, and
             with the ring's external lse and dvec) at Gemma-2's heads on
             2,048 tokens and Llama's on 1,024, bf16 and fp32; the a2a
             call on 8 of 16 heads over 4,096 tokens; RoPE at positions
             2,048 onwards.
4. serve   — Llama-3.1-8B at full width and depth (bf16, random weights
             from a seed) through ``BatchEngine``: 24 requests over the
             256 and 512 buckets; the flash kernel must have run once per
             layer per prefill.
5. parity  — the same widths in float32 at 4 layers: flash-path prefill
             logits against the dense path, and every engine completion
             token-identical to the sequential ``greedy_generate_cached``.
5b. serve_tenants — the serve phase's model cut to 8 of its 32 layers
             and its 24 requests through an
             ``AdapterPool`` of 2 slots with a loader over three random
             r-64 tenants (alpha 16, the seven projections), tagged in
             turn None, t0, t1, t2: all complete; a miss, an eviction and
             a pinned retry happen; flash once per layer per prefill; the
             None rows bitwise a no-pool engine's. Printed: tokens/s,
             TTFT, per-token p50/p99, the pool's bytes, peak memory, the
             tenant rows' agreement with single-adapter engines, and two
             sub-runs on 8 requests: SPEC_DRAFT=self with SPEC_K 4
             (acceptance share) and SERVE_QUANT=nf4 (the base's bytes).
5c. serve_tenants_parity — float32 at 4 layers, TF32 off: the
             mixed-tenant pooled batch, the self draft, a 2-layer random
             distilled draft, speculation with the pool and
             SERVE_QUANT=nf4, each token-identical to the sequential
             ``greedy_generate_cached`` (per tenant; on the quantized
             model).
6. train   — the Llama-3.1-8B QLoRA job (ray-jobs/fine_tune_config.json:
             NF4 base, r 64, microbatch 2 x grad-accum 4 at 1024 tokens)
             at full width and depth through the port's loop,
             ``train/loop.py::run_training``, as the job calls it: the
             offline input path (``data/``: synthetic SQL rows,
             downsampled, ByteTokenizer, prompt-masked, padded,
             ``sft_epoch_batches``) placed on the card by the prefetcher
             (pinned copies on a side stream, depth 2), a
             ThroughputMeter, the goodput ledger, a log line every step,
             a TensorBoard writer, eval (``sharded_eval_loss`` over
             ``make_eval_step``: 16 held-out rows every 3 steps, cut from
             the job's 200 rows every 50 steps), all under
             TRANSFER_GUARD=disallow. One warm-up and 5 timed steps; a
             timer around the step synchronizes before and after it (the
             step time of earlier runs). Finite loss, grad_norm and
             eval_loss, the adapters change, every delivered batch equals
             its numpy batch, per step the forward kernel runs 2 x 32 x 4
             times (forward and remat recomputation), dQ and dK/dV
             32 x 4 times, each eval pass 32 forwards a batch; the ledger's
             terms sum to the loop's wall within 1 ms. The line carries
             step p50 and the meter's tokens/s per card, MFU and
             data_stall_frac (its window holds the warm-up step),
             compile_s (eager: the first step's wall time),
             restart_to_first_step_s, the eval pauses, the ledger, the
             TensorBoard backend and scalar count.
7. train_parity — float32, 4 layers at full width: QLoRA and full
             fine-tuning through the kernels against the dense attention
             path, 3 steps each: loss / grad_norm streams and the trained
             tensors agree.
8. train_fused — the train phase's loop on Gemma-2-9B at full width and
             depth with ray-jobs/fine_tune_config_gemma2_4k.json's
             settings plus FUSED_OPS=1 (NF4 base, r 32, microbatch 1 x
             grad-accum 4 at 4,096 tokens, packed rows of a stand-in
             document mix, placed by the prefetcher; no eval): one
             warm-up and 2 timed steps; finite loss and grad_norm, the
             adapters change, and per step the fused rms_norm runs
             4 x 42 x 4 x 2 times, every launch on its registers body,
             the fused RoPE 42 x 4 x 3 times (forward, recomputation,
             backward), the flash forward 2 x 42 x 4 and dQ, dK/dV
             42 x 4 times.
9. train_fused_parity — float32, Gemma-2 at full width and 4 layers:
             FUSED_OPS=1 against FUSED_OPS=0, both through the flash
             kernels, for QLoRA and full fine-tuning, 3 steps each on
             packed rows: loss / grad_norm streams and the trained tensors
             agree.
10. train_fused_ce — the train phase (its loop, eval and guard) on the
             same Llama-3.1-8B QLoRA job with FUSED_OPS=1: the loss
             through the fused cross-entropy (no [2 x 1,024, 128,256]
             fp32 logits); per step row statistics and dx 4 times (dhead
             0: the head is frozen), row statistics and dx on the wgmma
             body, the fused rms_norm 2 x 32 x 4 x 2 times, every launch
             on its registers body, and RoPE 32 x 4 x 3 times.
11. train_fused_ce_parity — float32, Llama at full width and 4 layers:
             FUSED_OPS=1 against FUSED_OPS=0, both through the flash
             kernels, QLoRA and full fine-tuning (where dhead launches and
             the lm_head trains, held alike on both sides by the
             trained-tensor check); dx and dhead on the fp32 body.
11b. train_mesh — the train_fused_ce job at 8 of its 32 layers on a
             world-1 NCCL group's
             data 1 x fsdp 1 mesh (``parallel/``): every weight a DTensor
             sharded by FSDP2, the NF4 codes and scales too; one warm-up
             and 3 timed steps through ``run_training``, the per-step
             launches of the unmeshed run, losses within 1e-3 of an
             unmeshed run of the same seed and rows (run first); both
             runs' p50 and peak memory.
11c. train_mesh_parity — float32 (TF32 off), Llama at full width and 4
             layers, QLoRA and full fine-tuning, 3 steps: meshed (world
             1) against unmeshed and ``remat_policy="dots"`` against
             ``"full"``, within 1e-6; ``OPTIM=adafactor`` through the
             kernels against its plain run, finite and moving.
11d. train_remat_dots — Llama-3.1-8B QLoRA (FUSED_OPS=1) at full width
             and 8 of its 32 layers: 1 + 3 steps with ``"dots"`` against
             ``"full"`` (p50, peak, losses), and OPTIM=adafactor against
             AdamW (p50, the optimizer state's bytes), both of these steps
             under TRANSFER_GUARD=disallow.
11e. train_tp — tensor parallelism on one card: the train_mesh job at
             full width cut to 2 layers, in this process, then as two
             ranks of this card over gloo at model 2 x fsdp 1 (gloo's
             collectives on the card's tensors probed first; where one
             the path makes is missing the line says so and the phase
             rests on the kernels phase's local-head and vocab-shard
             cases): 1 + 3 steps, each rank's losses and grad_norms
             within 1e-2 of this process's and per step the launches of
             the unmeshed step (flash on 16 of 32 heads, the
             cross-entropy on a 64,128-column vocab shard on wgmma); 1 +
             1 steps at LORA_DROPOUT 0.1 whose first column-parallel masks
             agree across the ranks and row-parallel masks differ; the
             job in fp32 (TF32 off) at 2 layers within 1e-3.
11f. train_cp — context parallelism on one card: the Gemma-2 4k job
             (ray-jobs/fine_tune_config_gemma2_4k.json, FUSED_OPS=1) at
             full width and 8 of its 42 layers, one 4,096-token row a
             step, in this
             process, then as two ranks of this card over gloo at fsdp 1
             x context 2 (the ring / all-to-all transport staged through
             host memory): under a2a and ring, 1 + 3 steps, each rank's
             losses and grad_norms within 1e-2 of this process's, the
             launches per step (flash C times a layer under ring), each
             rank's peak; at the job's LORA_DROPOUT every projection's
             first mask differs across the context ranks; the job in fp32
             (TF32 off) at 2 layers under both within 1e-3.
11g. serve_mesh — serving on a sharded model, on one card: Llama-3.1-8B
             at full width, 4 layers, an NF4 base from seed 0 with an
             r-64 adapter on the seven projections (as the entry serves
             a QLoRA run); four prompts of 100-400 tokens in a 512
             bucket, 32 new tokens each, through
             ``greedy_generate_cached`` and through ``post_train_smoke``
             with every prompt tagged with the adapter, and the generate
             in fp32 at 2 layers (TF32 off): first in this process, then
             as two ranks of this card over gloo (``--serve-mesh-worker``)
             at model 2 (all three runs), at fsdp 2 (the bf16
             generate, cut to 1 new token: a gloo step gathers 5.1 GB
             through host memory in about 4.5 s) and at pipe 2 (the bf16
             and fp32 generates, each rank 2 of the 4 layers, a token
             handed from stage to stage through host memory, the logits
             on the last stage only), each after the collectives its
             decode makes are probed. Each rank against this process: the prefill's
             last-position logits (under TP the ranks' vocab shards side
             by side) within 5e-2 of the logits' scale, their largest
             |logit|, in bf16 (each rank sums the row-parallel partials
             in bf16; the line prints how far bf16 alone moves them in
             one process) and 1e-4 in fp32; the bf16 tokens equal up to
             each row's first position where this process's top-2 margin
             is under 1e-2 of the scale or that noise (the line prints
             it), the fp32 tokens all equal, the ranks'
             tokens equal, row 1's launches exact (4 for the generate, 16
             for the smoke's four prefills) on 16 of 32 query and 4 of 8
             KV heads at model 2, a stage's layers' at pipe 2; per rank
             the per-token decode p50 (and its ratio to this process's),
             tokens/s and peak memory, and at fsdp 2 the bytes gathered a
             decode step (from the shapes). The model-2 and pipe-2 cases
             must run;
             where gloo lacks a collective of the fsdp case the line says
             which and the case runs in serve_mesh_multi only.
12. kernelcheck — run right after the kernels phase: the port's kernel
             sweep (``analysis/kernelcheck.py`` over
             ``ops/registry.py``) on the card: every registered case
             that runs there, values and gradients, held within its
             committed CUDA pin (``analysis/tolerances/*.json``), the
             full-width per-head rms_norm + RoPE cases among them; the
             sweep's launches count as a driven path's.

13. train_profile — the train phase's job for one warm-up and one traced
             step through ``run_training`` with the port's
             ``TraceProfiler`` (PROFILE_START_STEP 1, PROFILE_NUM_STEPS
             1): the Chrome trace it wrote must hold the step's flash
             launches; device busy share and kernel time by group.

14. entry — ``gke_ray_train_tpu_torch/fine_tune.py``'s worker, as
             ``python -m gke_ray_train_tpu_torch.fine_tune`` runs it, on
             ray-jobs/fine_tune_config_offline_8b.json at full width,
             ``ENTRY_LAYERS`` (2) of its 32 layers (Llama-3.1-8B, random
             NF4 base from seed 0,
             r 64,
             dropout 0, 2 x 4 microbatches of 1,024, synthetic SQL rows),
             cut to 8 steps with a save and an eval of 16 rows every 4:
             run A uninterrupted; run B (ASYNC_CKPT=1) preempted after
             step 5 by a SIGTERM from the context's heartbeat sink; run C
             resuming B's directory. C's losses of steps 6-8 and its last
             checkpoint are held against A's (bitwise expected; a loss
             more than 1e-3 off fails); A's merged bf16 export is read
             back quantized and its NF4 codes, scales, norms, embedding
             and head must equal the merged weights quantized directly,
             bitwise. Run A also runs with INFERENCE and
             SERVE_AFTER_TRAIN (64 new tokens an answer, cut from 300):
             inference_comparison.json must hold its 2 records, each
             tuned answer non-empty text from generated tokens, and
             serve_smoke.json every prompt completed through the
             adapter pool. A line per run (the meter, the host time
             between step returns, eval pauses, the ledger, restore /
             save / commit seconds, checkpoint bytes, peak memory,
             launches, the comparison and the smoke) and one for the
             export (seconds, bytes, shards, read-back). Then the Gemma-2
             4k config through the same worker at 4 layers with its own
             ATTN_IMPL a2a (the flash path on one card): finite losses,
             the launches of a flash model, the export written.
15. train_moe — the train phase's loop on Mixtral-8x7B QLoRA at full
             width and 8 of its 32 layers (8 experts top 2) with
             ray-jobs/fine_tune_config_mixtral.json's settings (NF4 with
             QUANT_STORE=uint4, drawn and quantized one expert slice at a
             time; r 64 on attention only, dropout 0.05; 1 x 8
             microbatches of 1,024 on the offline SQL rows), under
             TRANSFER_GUARD=disallow: one warm-up and 2 timed steps, one
             eval of 8 rows. Finite loss, grad_norm, eval_loss and router
             aux; the adapters change, the routers and a bank do not; per
             step the flash forward 2 x 8 x 8 times, dQ and dK/dV 8 x 8.
             The line adds the base's bytes on the card and the routing
             (router aux, dropped (token, slot) share) read from every
             ``moe_mlp`` call.
16. train_moe_parity — float32, Mixtral at full width and 2 layers,
             QLoRA, 3 steps: flash against dense attention within the
             train-parity bounds, and a uint4 base against an int8 one,
             bitwise.
17. serve_moe — Mixtral at full width and 4 layers in float32 through
             ``BatchEngine`` at capacity_factor 4.0 (drop-free): 8
             requests over the 256 and 512 buckets, every completion
             equal to sequential greedy, flash once per layer per prefill.
18. entry_moe — the entry's worker on the Mixtral job at full width,
             depth cut to 2 layers (the full export is 93.4 GB), 4 steps
             with a save and an eval of 8 rows every 2; ``df`` of the
             output directory first; the merged export read back
             quantized, bitwise.
19. entry_full (opt-in) — the same worker on that config unchanged (~125
             steps, eval of 200 rows and a save every 50, the export).
19b. train_mesh_multi (opt-in) — a host with N >= 2 cards (fewer
             fails): the train_mesh job with LoRA dropout off, first on
             one card as one-row microbatches, then with one rank per
             card on an fsdp=N NCCL mesh, the same 8 rows a step as
             one-row microbatches (spawned as N processes under one
             deadline): every step's loss and grad_norm within 1e-2 of
             the one-card run's; per card p50, tokens/s, peak, the bytes
             all-gathered a step from the shapes. Then the entry
             (``fine_tune.train_loop_per_worker``) under torchrun on the
             N cards, on the entry phase's job cut to 4 layers and 4
             steps, a save and an eval every 2: every rank exits 0 with
             the same finite loss and eval loss, and the sharded export
             converts to an HF directory of finite tensors; the
             export's peak memory a card.
19c. train_tp_multi (opt-in) — the four-card host (fewer fails): one
             card first (the 70B config at 1 layer; the train_mesh job,
             dropout off, one-row microbatches), then one rank a card
             over NCCL: ray-jobs/fine_tune_config_70b.json (full
             fine-tuning of a bf16 base over fp32 masters, AdamW,
             FUSED_OPS=1) on fsdp 1 x model 4, every step within 1e-2
             of one card at 1 layer, and at 8 of its 80 layers per card
             p50, tokens/s, peak and the bytes all-reduced a step; the
             8B job at data 2 x fsdp 2 and fsdp 2 x model 2, each within
             1e-2 of one card; then the entry under torchrun at
             MESH_MODEL 2 with its export converted.
20. train_moe_profile (opt-in) — the train_profile route over one step
             of the train_moe job, with its device time by MoE group
             (dequantize, expert GEMMs, dispatch, flash).
21. pretrain — ``gke_ray_train_tpu_torch/pretrain.py``'s worker through
             ``rayint/trainer.py::TorchTrainer.fit()`` on the local path
             (basic_lm at full width: 2,048 d / 16 heads / 8,192 ff, the
             synthetic corpus's char vocab, seq 256, 16 rows a step, bf16
             over fp32 masters, FUSED_OPS=1), cut to 8 steps. Run A at
             4 of the job's 24 layers (its one save at 24 would write
             19 GB) with SERVE_AFTER_TRAIN: step p50
             between synchronizes, tokens/s, MFU, peak memory, the
             ledger, exact launches (rows 1-8; CE on ``mma.sync`` at V
             45); the smoke's bf16 completions against bf16 greedy
             decoding, where a differing token must have lost a near tie
             (within 4 bf16 ulps of greedy's top logit at the first
             divergent position; the decode GEMMs take other shapes than
             greedy's), the same prompts through the engine equal to
             greedy in float32, and the same weights through a
             two-replica ``ServeDeployment`` equal to the single engine
             with both replicas on the board. Then the fault drill at 2 layers
             (depth cut: the full-depth saves are 19 GB each), a save
             every 2 steps, under deterministic algorithms (measured
             first: the embedding's backward repeats bitwise only so):
             A' uninterrupted, B under ``FAULT_SPEC`` kill at 5 and
             SIGTERM at 7 with one failure allowed: 3 attempts, 1
             failure, 1 preemption, status ok, every loss and the last
             checkpoint (per-tensor digests) bitwise A''s, the retried
             attempts' peaks within 1 GB of the first's. The free disk
             is checked first.
21b. train_cp_multi (opt-in) — the four-card host (fewer fails): the
             Gemma-2 4k job at full width and depth, its 4 rows a step as
             one-row microbatches, on one card, then one rank a card over
             NCCL at fsdp 2 x context 2 under a2a and ring: every step
             within 1e-2 of one card, per card p50, tokens/s and peak; the
             state saved after the a2a run and read back at world 1, equal
             by digest.
22. pretrain_multi (opt-in) — the four-card host (fewer fails): the
             entry's worker under torchrun at fsdp 4 with ASYNC_CKPT=1
             (6 layers, each rank ``chip_smoke.py --pretrain-worker``):
             an uninterrupted run; a run under ``kill_during_commit`` at
             step 4 (a 2 s storage delay holds the commit open) that
             must exit non-zero leaving COMMITTING.4 without
             COMMITTED.4; its resume, from step 2, every loss bitwise the
             uninterrupted run's.
22b. serve_mesh_multi (opt-in) — the four-card host (fewer fails),
             NCCL: the 70B layout (ray-jobs/fine_tune_config_70b.json's
             model) at fsdp 1 x model 4, 8 of 80 layers in bf16, serve_mesh's
             prompts through the generate on one card (about 18 GB) and
             then one rank a card (``--serve-multi-worker``), held as
             serve_mesh holds its bf16 generate, each rank's per-token p50
             and tokens/s beside the card's; the same model decoding at
             pipe 4 (2 layers a card), likewise, each rank's p50 beside
             its model-4 p50; serve_mesh's model at fsdp 4
             likewise, with the bytes gathered a decode step; the
             fine-tune entry on the
             offline_8b job cut as the entry phase cuts it, with INFERENCE
             and SERVE_AFTER_TRAIN, on this card and then under torchrun at
             fsdp 4 (``--serve-entry-worker``): exit 0, the comparison and
             the smoke written once, by rank 0, the base answers the
             card's; the pre-train entry at fsdp 4 (6 layers) with
             SERVE_AFTER_TRAIN: exit 0, the smoke's stats on rank 0 alone.
22c. train_overlap — ``OVERLAP`` on one card: two gloo ranks of this
             card at fsdp 2 (``--ov-worker``; CUDA tensors staged through
             page-locked host memory), Llama-3.1-8B full fine-tuning at
             full width cut to 2 layers, bf16, FUSED_OPS=1, remat full,
             1 + 1 steps under each of off, xla (FSDP2's explicit
             prefetch) and manual (``train/overlap.py``'s hand-placed
             gathers): xla's losses and grad norms bitwise off's,
             manual's within 1e-2 of off's; every mode's launches of rows
             1-8 the full fine-tuning step's; manual's gathered bytes a
             step equal to those reckoned from the shapes (the root once,
             each block in its forward and in its recomputation) and its
             peak at most two layers' gathered weights over off's; fp32
             (TF32 off) at 2 layers, one step, manual bitwise off. Each
             mode's step p50, peak and gathered bytes a rank.
22d. train_overlap_multi (opt-in) — the four-card host (fewer fails),
             NCCL, one rank a card (``--ov-multi-worker``): at fsdp 4 and
             at data 2 x fsdp 2, the same job at 4 layers and 8 rows a
             step under each mode within 1e-2 of one card's (xla bitwise
             off's), then at full depth, the modes alternated, 1 + 3
             steps a run: each mode's step p50 and spread, tokens/s and
             peak a card, and from one profiled step the NCCL
             all-gather and reduce-scatter ms and the part of it no
             compute kernel ran beside; off and manual once more with
             deterministic algorithms off.
22e. train_hier — multi-slice training on one card: four gloo ranks of
             this card (``--hier-worker``) at data 2 x fsdp 2 over two
             emulated slices, each running the pre-train entry's worker
             through ``TorchTrainer.fit()`` at full width cut to 2 of 24
             layers, OVERLAP=manual, FUSED_OPS=1, bf16 over fp32
             parameters, 1 + 1 steps under DCN_SYNC flat, hier and hier +
             DCN_COMPRESS=bf16: hier's losses and grad norms bitwise
             flat's, bf16's within 1e-2 of hier's and not bitwise; rows
             1-8 launched as the pre-train step does; the cross-slice
             bytes a step (the manual path's tally) as reckoned from the
             shapes, hier's at most (1/2 + 0.01) of flat's. Each arm's
             step p50, peak and bytes a rank.
22f. train_hier_multi (opt-in) — the four-card host (fewer fails),
             NCCL, two slices of two cards at data 2 x fsdp 2: (a) the
             fine-tune job's full fine-tuning of Llama-3.1-8B at full
             depth (``--hier-multi-worker``; fp32 parameters, bf16
             compute, OPTIM=adafactor, FUSED_OPS=1, 8 rows a step), the
             arms alternated, 1 + 3 steps a run: hier bitwise flat, bf16
             within 1e-2 of hier, the cross-slice bytes as reckoned; each
             arm's step p50 and spread, tokens/s and peak a card; (b) the
             slice_evict drill through the pre-train entry
             (``--hier-drill-worker``, fp32, 2 layers, DCN_SYNC=hier):
             slice 1 evicted at step 2, a shrink to 2 cards recorded, the
             next attempt on one slice under the downgraded flat plan,
             its losses within 1e-5 of an uninterrupted run's. No number
             of either is a cross-node time.

The second-to-last line is the ``{"kernels": [...]}`` summary; the last
line is ``{"ok": true, "device": {...}}``. Without CUDA, or without the
package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import glob
import itertools
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
# when this process started running the script (a spawned rank reports
# its start-up and its work apart)
_T0 = time.perf_counter()

H100_BYTES_PER_S = 3.35e12          # HBM3, NVIDIA data sheet (SXM)
H100_BF16_FLOPS = 989e12            # dense tensor-core bf16
H100_F32_FLOPS = 67e12              # fp32 outside the tensor cores

# kernel-vs-plain tolerances (absolute), by dtype. float32: both sides
# accumulate in fp32 in different orders. bfloat16: probabilities are
# rounded to bf16 against the running (kernel) or final (plain) row max,
# up to 2^-9 relative each, and out is rounded to bf16 (2^-8 relative).
TOL = {"float32": {"out": 2e-5, "lse": 2e-5},
       "bfloat16": {"out": 2e-2, "lse": 1e-4}}
# backward kernels against flash_attention_bwd_reference: max |error| of
# dq, dk and dv relative to max(1, max |reference|). float32: fp32 sums
# in other orders (dK/dV sums up to G * S products). bfloat16: the
# recomputed P and dS round to bf16 at the same points on both sides, but
# a last-bit difference in fp32 can round either way (2^-8 relative on
# that term), and the outputs round to bf16 (2^-8).
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# fp32 logits of the flash prefill path against the dense path, 4 layers
PARITY_LOGITS_TOL = 1e-3
# train-parity phase: flash against dense attention at fp32, 4 layers.
# loss and grad_norm streams: relative; trained tensors: the change each
# run made, ||d_flash - d_dense|| / ||d_dense|| (an element whose
# gradient sits at rounding level may take Adam's step of +-lr on one
# side and the opposite on the other, so elementwise limits do not fit)
TRAIN_PARITY_RTOL = 1e-4
TRAIN_PARITY_DELTA_RTOL = 1e-3
# fused rms_norm / RoPE kernels against their plain versions: max |error|
# relative to max(1, max |reference|). Both sides compute in fp32 and
# round once; the fp32 sum order and rsqrtf may move the last fp32 bit,
# which can round a bf16 output to its neighbour (2^-8 relative)
FUSED_TOL = {"float32": 1e-5, "bfloat16": 8e-3}
# fused cross-entropy kernels against their plain versions. "stats": lse
# and the target logit, max |error| relative to max(1, max |reference|):
# fp32 sums over D and the vocab in other orders (bf16 products are
# exact in fp32). "grads": dx and dhead, max |error| relative to
# max |reference|: bf16 rounds dl to bf16 (2^-9 relative) before the
# products where the plain version keeps fp32, and both sides round the
# outputs (a neighbour is 2^-7 relative). The one-hot term sets that
# scale when labels are in range, so each case runs a second time with
# every label out of range: dl is then the softmax term alone, held on
# its own scale
CE_TOL = {"float32": {"stats": 2e-5, "grads": 1e-4},
          "bfloat16": {"stats": 1e-4, "grads": 1e-2}}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Milliseconds per call between CUDA events around ``iters`` calls:
    device time plus any host launch overhead the device waits on."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# how many device_ms calls each timer served; once the profiler records
# no device time in a process (CUPTI tracing unavailable to it), every
# later call times with CUDA events
TIMER_CALLS = {"profiler": 0, "cuda_events": 0}


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device milliseconds per call: the summed time of every kernel
    ``fn`` launches (torch.profiler / CUPTI), without the host gaps
    between them. Where the profiler records no device time, the time
    between CUDA events around ``iters`` calls (``cuda_ms``) stands in,
    host launch gaps included, and ``TIMER_CALLS`` counts it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if TIMER_CALLS["cuda_events"] == 0:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        cuda = torch.autograd.DeviceType.CUDA
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == cuda)
        if us > 0:
            TIMER_CALLS["profiler"] += 1
            return us / iters / 1e3
        print("device_ms: the profiler recorded no device time; timing "
              "with CUDA events from here on", file=sys.stderr, flush=True)
    TIMER_CALLS["cuda_events"] += 1
    return cuda_ms(fn, iters, warmup)


# ---------------------------------------------------------------------------
# phase 3: kernels
# ---------------------------------------------------------------------------

def _attn_inputs(case, dev):
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(case.get("seed", 0))
    dt = getattr(torch, case["dtype"])
    B, S, T, H, K, dh = (case[x] for x in ("B", "S", "T", "H", "K", "dh"))
    q = torch.randn((B, S, H, dh), generator=g, device=dev).to(dt)
    k = torch.randn((B, T, K, dh), generator=g, device=dev).to(dt)
    v = torch.randn((B, T, K, dh), generator=g, device=dev).to(dt)
    qp = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    kp = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T)
    qs = torch.ones((B, S), dtype=torch.int32, device=dev)
    ks = torch.ones((B, T), dtype=torch.int32, device=dev)
    if case.get("packed"):
        # two packed documents and trailing padding (segment 0)
        third = T // 3
        seg = torch.cat([torch.full((third,), 1), torch.full((third,), 2),
                         torch.zeros(T - 2 * third)]).to(torch.int32)
        qs = ks = seg.to(dev).expand(B, T)
    if case.get("packed_rows"):
        # segment ids and positions of the train_fused phase's first
        # packed rows (S = T)
        from gke_ray_train_tpu_torch.models import gemma2_9b
        rows = _packed_batch(B, T, gemma2_9b().vocab_size,
                             np.random.default_rng(1234))
        qs = ks = torch.as_tensor(rows["segment_ids"], device=dev)
        qp = kp = torch.as_tensor(rows["positions"], device=dev)
    if case.get("masked_rows"):
        # rows 5..9 carry a segment no key has: they attend nothing
        qs = qs.clone()
        qs[:, 5:10] = 7
    kw = dict(q_positions=qp.contiguous(), kv_positions=kp.contiguous(),
              q_segment_ids=qs.contiguous(), kv_segment_ids=ks.contiguous(),
              causal=case.get("causal", True),
              sliding_window=case.get("window"),
              scale=dh ** -0.5, logit_softcap=case.get("softcap"))
    return q, k, v, kw


KERNEL_CASES = {
    "causal_bf16": dict(B=2, S=256, T=256, H=8, K=2, dh=128,
                        dtype="bfloat16"),
    "causal_f32": dict(B=2, S=256, T=256, H=8, K=2, dh=128,
                       dtype="float32"),
    "gqa_32_8": dict(B=1, S=384, T=384, H=32, K=8, dh=128,
                     dtype="bfloat16"),
    "packed_padding": dict(B=2, S=255, T=255, H=4, K=4, dh=64,
                           dtype="float32", packed=True),
    "window_softcap_dh256": dict(B=1, S=320, T=320, H=4, K=2, dh=256,
                                 dtype="float32", window=64, softcap=50.0),
    "window_softcap_dh256_bf16": dict(B=1, S=320, T=320, H=4, K=2, dh=256,
                                      dtype="bfloat16", window=64,
                                      softcap=50.0),
    "ragged_T": dict(B=1, S=130, T=200, H=4, K=2, dh=128, dtype="float32",
                     causal=False),
    "fully_masked_rows": dict(B=1, S=128, T=128, H=4, K=2, dh=64,
                              dtype="float32", masked_rows=True),
    # the bf16 tensor-core body (dh 64 / 128) through the same cases
    "packed_padding_bf16": dict(B=2, S=255, T=255, H=4, K=4, dh=64,
                                dtype="bfloat16", packed=True),
    "window_softcap_bf16": dict(B=1, S=320, T=320, H=4, K=2, dh=128,
                                dtype="bfloat16", window=64, softcap=50.0),
    "ragged_T_bf16": dict(B=1, S=130, T=200, H=4, K=2, dh=128,
                          dtype="bfloat16", causal=False),
    "fully_masked_rows_bf16": dict(B=1, S=128, T=128, H=4, K=2, dh=64,
                                   dtype="bfloat16", masked_rows=True),
    # the edges of the bf16 wgmma bodies: TMA tails with S < T, a
    # cluster of 7 query heads (Qwen2's 28 / 4) and of 1 (MHA), dh 256
    # with packed documents, window, softcap and rows that attend
    # nothing, and a row of interior tiles only (one segment, not causal)
    "tail_s_lt_t_bf16": dict(B=2, S=77, T=333, H=8, K=2, dh=128,
                             dtype="bfloat16"),
    "gqa7_bf16": dict(B=1, S=300, T=300, H=14, K=2, dh=128,
                      dtype="bfloat16"),
    "mha_dh64_bf16": dict(B=2, S=256, T=256, H=4, K=4, dh=64,
                          dtype="bfloat16"),
    "packed_window_softcap_dh256_bf16": dict(
        B=1, S=700, T=700, H=4, K=2, dh=256, dtype="bfloat16", packed=True,
        window=128, softcap=50.0, masked_rows=True),
    "interior_bf16": dict(B=1, S=512, T=512, H=4, K=2, dh=128,
                          dtype="bfloat16", causal=False),
    # a rank's local heads under tensor parallelism: Llama-3.1-8B at
    # model 2 (train_tp: 32 / 2 query over 8 / 2 KV heads) and
    # Llama-3.1-70B at model 4 (train_tp_multi: 64 / 4 over 8 / 4)
    "llama3_8b_tp2_bf16": dict(B=2, S=1024, T=1024, H=16, K=4, dh=128,
                               dtype="bfloat16"),
    "llama3_70b_tp4_bf16": dict(B=1, S=1024, T=1024, H=16, K=2, dh=128,
                                dtype="bfloat16"),
    # the pre-train entry's step: basic_lm (16 heads of 128, no GQA), 16
    # rows of 256
    "basic_lm_train_bf16": dict(B=16, S=256, T=256, H=16, K=16, dh=128,
                                dtype="bfloat16"),
}

# the serving path's prefill shapes: Llama-3.1-8B, one prompt per prefill
SERVE_SHAPES = {f"llama3_8b_prefill_{n}": dict(B=1, S=n, T=n, H=32, K=8,
                                               dh=128, dtype="bfloat16")
                for n in (256, 512)}
# the train phase's attention shape: Llama-3.1-8B, microbatch 2 x 1024
TRAIN_SHAPE = dict(B=2, S=1024, T=1024, H=32, K=8, dh=128, dtype="bfloat16")
# the train_fused phase's attention: Gemma-2-9B, one packed row of 4,096
# (its segments and positions), bf16, softcap 50, scale 256^-0.5; the
# sliding layers' window of 4,096 and the global layers' none
GEMMA_ATTN_SHAPE = dict(B=1, S=4096, T=4096, H=16, K=8, dh=256,
                        dtype="bfloat16", softcap=50.0, packed_rows=True)
GEMMA_ATTN_CASES = {
    "gemma2_9b_train_4096_sliding": dict(GEMMA_ATTN_SHAPE, window=4096),
    "gemma2_9b_train_4096_global": GEMMA_ATTN_SHAPE,
}
# the other committed length mix: one 4,096-token document a row
GEMMA_ONE_DOC_SHAPE = dict(GEMMA_ATTN_SHAPE, packed_rows=False)


def _check_case(name, case, dev):
    import torch
    from gke_ray_train_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)
    q, k, v, kw = _attn_inputs(case, dev)
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    ref_out, ref_lse = flash_attention_reference(
        q, k, v, kw["q_positions"], kw["kv_positions"],
        kw["q_segment_ids"], kw["kv_segment_ids"], causal=kw["causal"],
        sliding_window=kw["sliding_window"], scale=kw["scale"],
        logit_softcap=kw["logit_softcap"])
    err_out = float((out.float() - ref_out.float()).abs().max())
    err_lse = float((lse - ref_lse).abs().max())
    tol = TOL[case["dtype"]]
    row = {"case": name, "max_abs_err_out": err_out,
           "max_abs_err_lse": err_lse, "tol_out": tol["out"],
           "tol_lse": tol["lse"],
           "ok": err_out <= tol["out"] and err_lse <= tol["lse"]
           and bool(torch.isfinite(out.float()).all())}
    if case.get("masked_rows"):
        dead_out = float(out[:, 5:10].float().abs().max())
        dead_lse = lse[:, :, 5:10]
        row["masked_rows_ok"] = (dead_out == 0.0
                                 and bool((dead_lse == -2.0e38).all()))
        row["ok"] = row["ok"] and row["masked_rows_ok"]
    return row, (q, k, v, kw)


def _mask_kw(kw):
    return {k: kw[k] for k in ("causal", "sliding_window", "scale",
                               "logit_softcap")}


def _mask_args(kw):
    return (kw["q_positions"], kw["kv_positions"], kw["q_segment_ids"],
            kw["kv_segment_ids"])


def _bwd_inputs(q, k, v, kw, seed):
    """(out, lse) from the forward kernel, an output gradient dO and
    D = rowsum(dO * O) [B, H, S] fp32, as FlashAttention.backward forms
    them."""
    import torch
    from gke_ray_train_tpu_torch.ops.flash_attention import flash_attention
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    g = torch.Generator(device=q.device)
    g.manual_seed(seed + 1)
    do = torch.randn(q.shape, generator=g, device=q.device).to(q.dtype)
    dvec = torch.sum(do.float() * out.float(), dim=-1).transpose(
        1, 2).contiguous()
    return out, lse, do, dvec


def _check_bwd_case(name, case, dev):
    """Both backward kernels against flash_attention_bwd_reference on the
    same (q, k, v, out, lse, dO)."""
    import torch
    from gke_ray_train_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_reference, flash_bwd_dkv, flash_bwd_dq)
    q, k, v, kw = _attn_inputs(case, dev)
    out, lse, do, dvec = _bwd_inputs(q, k, v, kw, case.get("seed", 0))
    args = (q, k, v, do, lse, dvec) + _mask_args(kw)
    dq = flash_bwd_dq(*args, **_mask_kw(kw))
    dk, dv = flash_bwd_dkv(*args, **_mask_kw(kw))
    torch.cuda.synchronize()
    ref = flash_attention_bwd_reference(q, k, v, out, lse, do,
                                        *_mask_args(kw), **_mask_kw(kw))
    row = {"case": name, "dtype": case["dtype"],
           "tol_rel": BWD_TOL[case["dtype"]], "ok": True}
    for nm, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        err = float((got.float() - want.float()).abs().max())
        scale = max(1.0, float(want.float().abs().max()))
        row[f"max_abs_err_{nm}"] = err
        row[f"max_abs_ref_{nm}"] = scale
        row["ok"] = (row["ok"] and err <= BWD_TOL[case["dtype"]] * scale
                     and bool(torch.isfinite(got.float()).all()))
    if case.get("masked_rows"):
        row["masked_rows_ok"] = float(dq[:, 5:10].float().abs().max()) == 0.0
        row["ok"] = row["ok"] and row["masked_rows_ok"]
    # every dQ element and the GQA group sum have a fixed order (no
    # atomics): a second launch gives the same bits
    again = flash_bwd_dkv(*args, **_mask_kw(kw))
    row["dkv_bitwise_repeat"] = all(bool(torch.equal(a, b))
                                    for a, b in zip((dk, dv), again))
    row["dq_bitwise_repeat"] = bool(torch.equal(
        dq, flash_bwd_dq(*args, **_mask_kw(kw))))
    row["ok"] = (row["ok"] and row["dkv_bitwise_repeat"]
                 and row["dq_bitwise_repeat"])
    return row


def _bound(nbytes, flops, dtype):
    """(bound ms, what bounds it): bytes over the memory rate against
    FLOPs over the peak rate of the input type."""
    import torch
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _live_pairs(kw):
    """Unmasked (q, kv) pairs of these inputs, summed over batch rows."""
    from gke_ray_train_tpu_torch.ops.attention import make_attention_mask
    return int(make_attention_mask(*_mask_args(kw), causal=kw["causal"],
                                   sliding_window=kw["sliding_window"]).sum())


def _bound_ms(q, k, v, kw):
    """Least time for the forward on these inputs: bytes each input read
    once and each output written once, against the FLOPs of the (q, kv)
    pairs these inputs' mask keeps (QK^T and PV, 2 FLOPs a MAC)."""
    B, S, H, dh = q.shape
    T = k.shape[1]
    es = q.element_size()
    nbytes = (q.numel() + k.numel() + v.numel() + q.numel()) * es \
        + B * H * S * 4 + 4 * 2 * B * (S + T)
    flops = 4.0 * dh * H * _live_pairs(kw)
    return _bound(nbytes, flops, q.dtype) + (nbytes, flops)


def _bwd_bounds(q, k, v, kw):
    """{kernel: (bound ms, by, bytes, flops)} of the two backward kernels:
    dQ reads q, k, v, dO, lse, D and writes dQ, with 3 products (S, dP,
    dS K) over the live pairs; dK/dV reads the same and writes dK, dV,
    with 4 (S, dP, P^T dO, dS^T Q)."""
    B, S, H, dh = q.shape
    T = k.shape[1]
    es = q.element_size()
    ins = (2 * q.numel() + k.numel() + v.numel()) * es + 2 * 4 * B * H * S \
        + 4 * 2 * B * (S + T)
    pairs = _live_pairs(kw)
    out = {}
    for name, n_out, n_mm in (("flash_bwd_dq", q.numel(), 3),
                              ("flash_bwd_dkv", k.numel() + v.numel(), 4)):
        nbytes = ins + n_out * es
        flops = 2.0 * dh * H * pairs * n_mm
        out[name] = _bound(nbytes, flops, q.dtype) + (nbytes, flops)
    return out


def _turns(plain, kernel, library, iters: int = 20):
    """Device ms in turns plain, kernel, kernel, plain, library (None
    where there is no library call), all on one timer."""
    fns = (plain, kernel, kernel, plain) + (
        (library,) if library is not None else ())
    profiled = TIMER_CALLS["cuda_events"] == 0
    ms = [device_ms(f, iters) for f in fns]
    if profiled and TIMER_CALLS["cuda_events"]:
        # the profiler gave out part-way: every turn again on CUDA events
        ms = [device_ms(f, iters) for f in fns]
    plain_a, kern_a, kern_b, plain_b = ms[:4]
    lib = ms[4] if library is not None else None
    return {"kernel_ms": min(kern_a, kern_b), "kernel_ms_runs": [kern_a,
                                                                  kern_b],
            "plain_ms": min(plain_a, plain_b),
            "plain_ms_runs": [plain_a, plain_b], "library_ms": lib}


def _alternated(a, b, fa, fb, pairs: int = 2, iters: int = 3,
                warmup: int = 1):
    """Device ms of ``fa`` (named ``a``) and ``fb`` (``b``) in one
    process, in alternated turns a, b, b, a, ``pairs`` times (``iters``
    calls a turn): per name the best turn, every turn, and the spread
    (max - min) / min over its turns."""
    runs = {a: [], b: []}
    for _ in range(pairs):
        for name, fn in ((a, fa), (b, fb), (b, fb), (a, fa)):
            runs[name].append(device_ms(fn, iters=iters, warmup=warmup))
    return {name: {"ms": min(r), "spread": (max(r) - min(r)) / min(r),
                   "ms_runs": r} for name, r in runs.items()}


def _time_routes(wrapper, launch, old, bound, flops, pairs: int = 2,
                 iters: int = 3):
    """The wgmma body of a routed kernel against the body ``old`` it
    replaced, on the same inputs (``launch(route)``), in alternated turns
    (``_alternated``): both times and spreads, TFLOP/s, the share of the
    bound, the speed-up, and the launches per route on ``wrapper``."""
    before = dict(wrapper.routes)
    out = _alternated(old, "wgmma", lambda: launch(old),
                      lambda: launch("wgmma"), pairs, iters)
    for r in out.values():
        r.update({"tflops_per_s": flops / r["ms"] / 1e9,
                  "bound_share": bound / r["ms"]})
    out["speedup"] = out[old]["ms"] / out["wgmma"]["ms"]
    out["launches"] = {r: n - before[r] for r, n in wrapper.routes.items()}
    return out


def _time_train_shape(dev):
    """The three kernels at the training shape (TRAIN_SHAPE), each
    against its plain version and a PyTorch library call: SDPA forward
    for flash_fwd, and for both backward kernels the device time of the
    kernels SDPA's backward launches (dQ, dK and dV together). Then the
    like-for-like backward: dQ and dK/dV together against SDPA's whole
    backward (``bwd_vs_sdpa``), in alternated turns."""
    import torch
    from gke_ray_train_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_bwd_reference,
        flash_attention_reference, flash_bwd_dkv, flash_bwd_dq)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    case = TRAIN_SHAPE
    q, k, v, kw = _attn_inputs(case, dev)
    mkw, margs = _mask_kw(kw), _mask_args(kw)
    out, lse, do, dvec = _bwd_inputs(q, k, v, kw, 0)
    args = (q, k, v, do, lse, dvec) + margs
    ref_out, _ = flash_attention_reference(q, k, v, *margs, **mkw)
    ref = flash_attention_bwd_reference(q, k, v, out, lse, do, *margs, **mkw)
    dq = flash_bwd_dq(*args, **mkw)
    dk, dv = flash_bwd_dkv(*args, **mkw)
    torch.cuda.synchronize()

    def err(a, b):
        return float((a.float() - b.float()).abs().max())
    errs = {"flash_fwd": err(out, ref_out), "flash_bwd_dq": err(dq, ref[0]),
            "flash_bwd_dkv": max(err(dk, ref[1]), err(dv, ref[2]))}
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    lib_out = sdpa(qt, kt, vt, is_causal=True, scale=mkw["scale"],
                   enable_gqa=True)
    do_t = do.transpose(1, 2).contiguous()

    def lib_fwd():
        with torch.no_grad():
            return sdpa(qt, kt, vt, is_causal=True, scale=mkw["scale"],
                        enable_gqa=True)

    def lib_bwd():
        return torch.autograd.grad(lib_out, (qt, kt, vt), do_t,
                                   retain_graph=True)

    def plain_bwd():
        return flash_attention_bwd_reference(q, k, v, out, lse, do, *margs,
                                             **mkw)
    runs = {
        "flash_fwd": _turns(
            lambda: flash_attention_reference(q, k, v, *margs, **mkw),
            lambda: flash_attention(q, k, v, **kw), lib_fwd),
        "flash_bwd_dq": _turns(plain_bwd,
                               lambda: flash_bwd_dq(*args, **mkw), lib_bwd),
        "flash_bwd_dkv": _turns(plain_bwd,
                                lambda: flash_bwd_dkv(*args, **mkw),
                                lib_bwd),
    }
    bounds = _bwd_bounds(q, k, v, kw)
    bounds["flash_fwd"] = _bound_ms(q, k, v, kw)
    for name, r in runs.items():
        bound, by, nbytes, flops = bounds[name]
        r.update({"shape": "llama3_8b_train_1024", "bound_ms": bound,
                  "bound_by": by, "bytes": nbytes, "flops": flops,
                  "max_abs_err": errs[name]})
    def ours_bwd():
        return flash_bwd_dq(*args, **mkw), flash_bwd_dkv(*args, **mkw)
    both = _alternated("sdpa_backward", "dq_plus_dkv", lib_bwd, ours_bwd,
                       iters=10)
    both["ratio"] = both["dq_plus_dkv"]["ms"] / both["sdpa_backward"]["ms"]
    runs["flash_bwd_dq"]["bwd_vs_sdpa"] = both
    return runs


# context parallelism's situations of the flash kernels (ops/
# ring_attention.py): one rank's queries against a visiting K/V shard of
# the same rows, Gemma-2-9B's heads (16 / 8 of 256, softcap 50) at
# train_cp's shard of 2,048 tokens and Llama-3.1-8B's (32 / 8 of 128) at
# 1,024, bf16 and fp32
RING_SHAPES = {"gemma2_9b": dict(S=2048, H=16, K=8, dh=256, softcap=50.0),
               "llama3_8b": dict(S=1024, H=32, K=8, dh=128)}
# the a2a strategy's one call: the whole sequence on 8 of 16 query and 4
# of 8 KV heads (context 2), the packed row of the train_fused phase
GEMMA_A2A_CASE = dict(GEMMA_ATTN_SHAPE, H=8, K=4)


def _ring_inputs(shape, dtype, packed, dev, seed):
    """Two token shards of one sequence of ``2 S`` tokens: (q, k, v) per
    shard and the global positions / segment ids. Packed: documents of
    300-900 tokens restarting their positions, the one at the boundary
    straddling it, a padded tail of segment 0."""
    import torch
    S, H, K, dh = (shape[x] for x in ("S", "H", "K", "dh"))
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    dt = getattr(torch, dtype)

    def rnd(*shp):
        return torch.randn(shp, generator=g, device=dev).to(dt)
    qs = [rnd(1, S, H, dh) for _ in range(2)]
    ks = [rnd(1, S, K, dh) for _ in range(2)]
    vs = [rnd(1, S, K, dh) for _ in range(2)]
    pos = np.arange(2 * S, dtype=np.int32)
    seg = np.ones(2 * S, np.int32)
    if packed:
        rng = np.random.default_rng(seed)
        t, doc = 0, 1
        while t < 2 * S - 64:
            n = min(int(rng.integers(300, 901)), 2 * S - 64 - t)
            if t < S < t + n:
                n = max(n, S - t + 200)       # straddles the boundary
            n = min(n, 2 * S - 64 - t)
            seg[t:t + n] = doc
            pos[t:t + n] = np.arange(n)
            t, doc = t + n, doc + 1
        seg[t:] = 0
    pos = torch.as_tensor(pos, device=dev)[None]
    seg = torch.as_tensor(seg, device=dev)[None]
    return qs, ks, vs, pos, seg


def _ring_case(name, shape, dtype, dev, seed):
    """Each situation of rank 1's queries (shard 1) or rank 0's (shard 0)
    against one K/V shard, the kernels against their plain versions:
    ``past`` (every kv position before every query: interior tiles; the
    backward from this launch's lse), ``future`` (every kv position
    after: out 0, lse NEG_INF, dQ, dK and dV exactly 0, given the lse
    and dvec of the rank's own launch), ``straddling`` (packed documents
    across the boundary) and ``external_lse`` (unpacked); the last two's
    dQ and dK/dV from the ring's final lse and dvec = rowsum(dO * O) of
    the output merged with the rank's own shard."""
    import torch
    from gke_ray_train_tpu_torch.ops.flash_attention import (
        _forward, flash_attention_bwd_reference, flash_attention_reference,
        flash_bwd_dkv, flash_bwd_dq)
    from gke_ray_train_tpu_torch.ops.ring_attention import merge
    S = shape["S"]
    kw = dict(causal=True, sliding_window=shape.get("window"),
              scale=shape["dh"] ** -0.5, logit_softcap=shape.get("softcap"))
    rows = []

    def half(t, i):
        return t[:, i * S:(i + 1) * S].contiguous()

    def hold(situation, qi, ki, packed):
        qs, ks, vs, pos, seg = _ring_inputs(shape, dtype, packed, dev, seed)
        if not packed:
            seg = torch.ones_like(seg)
        q, k, v = qs[qi], ks[ki], vs[ki]
        m = (half(pos, qi), half(pos, ki), half(seg, qi), half(seg, ki))
        # the rank's own shard first: its lse and output
        own_out, own_lse = _forward(q, ks[qi], vs[qi], m[0], m[0], m[2],
                                    m[2], kw)
        out, lse = _forward(q, k, v, *m, kw)
        ref_out, ref_lse = flash_attention_reference(q, k, v, *m, **kw)
        g = torch.Generator(device=dev)
        g.manual_seed(seed + 7)
        do = torch.randn(q.shape, generator=g, device=dev).to(q.dtype)
        if situation == "future":
            # the rank's own lse and output stand for the ring's
            fin_out, fin_lse = own_out, own_lse
        elif situation == "past":
            # this launch's own lse and output
            fin_out, fin_lse = out, lse
        else:
            o, fin_lse = merge(own_out.float(), own_lse, out.float(), lse)
            fin_out = o.to(q.dtype)
        dvec = torch.sum(do.float() * fin_out.float(), dim=-1).transpose(
            1, 2).contiguous()
        args = (q, k, v, do, fin_lse, dvec) + m
        dq = flash_bwd_dq(*args, **kw)
        dk, dv = flash_bwd_dkv(*args, **kw)
        torch.cuda.synchronize()
        ref = flash_attention_bwd_reference(q, k, v, fin_out, fin_lse, do,
                                            *m, **kw)
        row = {"case": f"{name}_{situation}_{dtype}", "dtype": dtype,
               "q_shard": qi, "kv_shard": ki, "ok": True}
        tol, btol = TOL[dtype], BWD_TOL[dtype]
        row["max_abs_err_out"] = float((out.float() - ref_out.float())
                                       .abs().max())
        row["max_abs_err_lse"] = float((lse - ref_lse).abs().max())
        row["ok"] = (row["max_abs_err_out"] <= tol["out"]
                     and row["max_abs_err_lse"] <= tol["lse"])
        for nm, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
            err, scale = _rel_err(got, want)
            row[f"max_abs_err_{nm}"] = err
            row["ok"] = (row["ok"] and err <= btol * scale
                         and bool(torch.isfinite(got.float()).all()))
        if situation == "future":
            row["dead_exact"] = (
                float(out.float().abs().max()) == 0.0
                and bool((lse == -2.0e38).all())
                and all(float(t.float().abs().max()) == 0.0
                        for t in (dq, dk, dv)))
            row["ok"] = row["ok"] and row["dead_exact"]
        rows.append(row)
    hold("past", 1, 0, False)
    hold("future", 0, 1, False)
    hold("straddling", 1, 0, True)
    hold("external_lse", 1, 0, False)
    return rows


def _check_ring_cases(dev):
    """``_ring_case`` at RING_SHAPES in bf16 and fp32, and the a2a call
    (GEMMA_A2A_CASE) forward and backward against their plain versions."""
    rows = []
    for i, (name, shape) in enumerate(RING_SHAPES.items()):
        for dtype in ("bfloat16", "float32"):
            rows += _ring_case(name, shape, dtype, dev, seed=40 + i)
    a2a = _check_case("gemma2_9b_a2a_4096", GEMMA_A2A_CASE, dev)[0]
    a2a_bwd = _check_bwd_case("gemma2_9b_a2a_4096", GEMMA_A2A_CASE, dev)
    return rows + [a2a, a2a_bwd]


def _time_gemma_attn(dev):
    """Device ms of the three kernels at the train_fused phase's attention
    (the global layers' case of GEMMA_ATTN_CASES; the sliding layers'
    window of 4,096 masks no pair more on rows of documents up to 1,024
    tokens), with the live pairs of that packed row and each kernel's
    bound on them; then the same at one 4,096-token document a row
    (GEMMA_ONE_DOC_SHAPE), the other length mix the numbers hold for."""
    from gke_ray_train_tpu_torch.ops.flash_attention import (
        flash_attention, flash_bwd_dkv, flash_bwd_dq)
    mixes = {"stand_in_mix": GEMMA_ATTN_CASES["gemma2_9b_train_4096_global"],
             "one_doc": GEMMA_ONE_DOC_SHAPE}
    res = {}
    for mix, case in mixes.items():
        q, k, v, kw = _attn_inputs(case, dev)
        mkw = _mask_kw(kw)
        out, lse, do, dvec = _bwd_inputs(q, k, v, kw, 0)
        args = (q, k, v, do, lse, dvec) + _mask_args(kw)
        bounds = _bwd_bounds(q, k, v, kw)
        bounds["flash_fwd"] = _bound_ms(q, k, v, kw)
        fns = {"flash_fwd": lambda: flash_attention(q, k, v, **kw),
               "flash_bwd_dq": lambda: flash_bwd_dq(*args, **mkw),
               "flash_bwd_dkv": lambda: flash_bwd_dkv(*args, **mkw)}
        rows = {}
        for name, fn in fns.items():
            bound, by, nbytes, flops = bounds[name]
            ms = device_ms(fn)
            rows[name] = {"shape": f"gemma2_9b_train_4096_{mix}",
                          "kernel_ms": ms, "bound_ms": bound, "bound_by": by,
                          "flops": flops, "tflops_per_s": flops / ms / 1e9}
        res[mix] = {"live_pairs_per_head": _live_pairs(kw),
                    "all_causal_pairs": q.shape[1] * (q.shape[1] + 1) // 2,
                    "kernels": rows}
    return res


# fused rms_norm cases: rows (3 x 37) that no block or row group divides,
# D of the small tests and of the pre-train entry's basic_lm (2,048; both
# on the two-pass body), and every width the registers body is built for:
# Gemma-2 (3,584, not a power of two), Llama (4,096), Llama-2-13B (5,120),
# 70B (8,192)
NORM_CASES = [dict(D=D, dtype=dt, scale_plus_one=sp1)
              for dt in ("float32", "bfloat16")
              for D in (64, 2048, 3584, 4096, 5120, 8192)
              for sp1 in (False, True)]
# fused RoPE cases (B, S, H, K, dh): tiny, Gemma-2's training shape,
# Llama's, the local heads of Llama-3.1-8B at model 2 and of
# Llama-3.1-70B at model 4, and the pre-train entry's basic_lm step (16
# rows of 256, 16 heads of 128, no GQA)
ROPE_CASES = [dict(shape=shp, dtype=dt) for dt in ("float32", "bfloat16")
              for shp in ((1, 128, 4, 2, 32), (1, 4096, 16, 8, 256),
                          (2, 1024, 32, 8, 128), (2, 1024, 16, 4, 128),
                          (1, 1024, 16, 2, 128), (16, 256, 16, 16, 128))]
# and context rank 1's shard of the Gemma-2 row at context 2 (train_cp):
# 2,048 tokens at positions 2,048 onwards
ROPE_CASES += [dict(shape=(1, 2048, 16, 8, 256), dtype=dt, offset=2048)
               for dt in ("float32", "bfloat16")]
# the train_fused phase's shapes: Gemma-2-9B, one packed row of 4,096
GEMMA_NORM_SHAPE = (1, 4096, 3584)
GEMMA_ROPE_SHAPE = (1, 4096, 16, 8, 256)
# the train_fused_ce phase's rms_norm: Llama-3.1-8B, microbatch 2 x 1,024
LLAMA_NORM_SHAPE = (2, 1024, 4096)


def _rel_err(got, want):
    """(max |got - want|, max(1, max |want|))."""
    err = float((got.float() - want.float()).abs().max())
    return err, max(1.0, float(want.float().abs().max()))


def _packed_rope_positions(B, S, dev, g):
    """Positions that restart at S // 3 (a second document), and over the
    last third of the last row random positions up to 8,191."""
    import torch
    pos = torch.arange(S, dtype=torch.int32, device=dev).repeat(B, 1)
    pos[:, S // 3:] -= S // 3
    tail = S - 2 * S // 3
    pos[-1, -tail:] = torch.randint(0, 8192, (tail,), generator=g,
                                    device=dev, dtype=torch.int32)
    return pos


def _rope_freqs(dh, dev):
    import torch
    from gke_ray_train_tpu_torch.ops.rope import rope_frequencies
    return torch.from_numpy(rope_frequencies(dh)).to(dev)


def _check_fused_cases(dev):
    """Both fused kernels against their plain versions over NORM_CASES and
    ROPE_CASES; RoPE forward and its negated-frequency backward launch."""
    import torch
    from gke_ray_train_tpu_torch.ops.fused_norm_rope import (
        fused_rmsnorm, fused_rmsnorm_reference, fused_rope_qk,
        fused_rope_qk_reference, norm_route)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    rows = []
    for c in NORM_CASES:
        dt = getattr(torch, c["dtype"])
        sp1 = c["scale_plus_one"]
        x = torch.randn((3, 37, c["D"]), generator=g, device=dev).to(dt)
        s = (torch.randn((c["D"],), generator=g, device=dev) * 0.1
             + (0.0 if sp1 else 1.0)).to(dt)
        before = dict(fused_rmsnorm.routes)
        y = fused_rmsnorm(x, s, eps=1e-6, scale_plus_one=sp1)
        torch.cuda.synchronize()
        took = [r for r, n in fused_rmsnorm.routes.items()
                if n != before[r]]
        err, scale = _rel_err(y, fused_rmsnorm_reference(
            x, s, eps=1e-6, scale_plus_one=sp1))
        tol = FUSED_TOL[c["dtype"]]
        rows.append({"kernel": "fused_rmsnorm", **c, "route": took,
                     "max_abs_err": err, "max_abs_ref": scale,
                     "tol_rel": tol,
                     "ok": err <= tol * scale
                     and took == [norm_route(dt, c["D"])]
                     and bool(torch.isfinite(y.float()).all())})
    for c in ROPE_CASES:
        dt = getattr(torch, c["dtype"])
        B, S, H, K, dh = c["shape"]
        q = torch.randn((B, S, H, dh), generator=g, device=dev).to(dt)
        k = torch.randn((B, S, K, dh), generator=g, device=dev).to(dt)
        if c.get("offset"):
            pos = (c["offset"] + torch.arange(
                S, dtype=torch.int32, device=dev)).repeat(B, 1)
        else:
            pos = _packed_rope_positions(B, S, dev, g)
        f = _rope_freqs(dh, dev)
        oq, ok = fused_rope_qk(q, k, pos, f)
        bq, bk = fused_rope_qk(oq, ok, pos, -f)      # the backward launch
        torch.cuda.synchronize()
        tol = FUSED_TOL[c["dtype"]]
        row = {"kernel": "fused_rope_qk", **c, "tol_rel": tol, "ok": True}
        outs = zip(("q", "k", "dq", "dk"), (oq, ok, bq, bk),
                   fused_rope_qk_reference(q, k, pos, f)
                   + fused_rope_qk_reference(oq, ok, pos, -f))
        for name, got, want in outs:
            err, scale = _rel_err(got, want)
            row[f"max_abs_err_{name}"] = err
            row["ok"] = (row["ok"] and err <= tol * scale
                         and bool(torch.isfinite(got.float()).all()))
        rows.append(row)
    return rows


def _time_norm(x, s, nkw, shape_name):
    """The fused rms_norm at one shape (bf16), held against its plain
    version and timed against it and against
    ``torch.nn.functional.rms_norm`` (the weight, ``1 + scale`` under
    Gemma's form, formed beforehand), plain / kernel / kernel / plain /
    library. Then in alternated turns with their spreads: the kernel
    against ``F.rms_norm`` (``kernel_vs_library``) and the registers body
    against the two-pass body it replaced (``registers_vs_two_pass``).
    The public call must take the registers body and repeat bitwise.
    Bound: each input read once and each output written once over the
    memory rate, against fp32 FLOPs (the arithmetic runs in fp32 outside
    the tensor cores) over the fp32 rate. Repeated calls on one x find it
    in the 50 MB L2 where it fits (the Llama shape's 16.8 MB), so both
    alternated comparisons run again with x cold (``cold``): each call
    takes the next of copies of x that together pass 100 MB, so that the
    one it reads is the least recently used."""
    import torch
    from gke_ray_train_tpu_torch.ops import fused_norm_rope as fnr
    D = x.shape[-1]
    eps, sp1 = nkw["eps"], nkw["scale_plus_one"]
    w = (1.0 + s.float()).to(s.dtype) if sp1 else s
    tol = FUSED_TOL["bfloat16"]
    before = dict(fnr.fused_rmsnorm.routes)
    y = fnr.fused_rmsnorm(x, s, **nkw)
    again = fnr.fused_rmsnorm(x, s, **nkw)
    torch.cuda.synchronize()
    took = {r: n - before[r] for r, n in fnr.fused_rmsnorm.routes.items()}
    repeat = bool(torch.equal(y, again))
    err, ref = _rel_err(y, fnr.fused_rmsnorm_reference(x, s, **nkw))
    old_err, _ = _rel_err(fnr._rmsnorm_launch(x, s, eps, sp1,
                                              route="two_pass"), y)
    del again

    def compare(get_x):
        """Both alternated comparisons, each call on ``get_x()``."""
        vs = _alternated(
            "library", "kernel",
            lambda: torch.nn.functional.rms_norm(get_x(), (D,), w, eps),
            lambda: fnr.fused_rmsnorm(get_x(), s, **nkw), pairs=3, iters=50)
        vs["ratio"] = vs["kernel"]["ms"] / vs["library"]["ms"]
        bodies = _alternated(
            "two_pass", "registers",
            lambda: fnr._rmsnorm_launch(get_x(), s, eps, sp1,
                                        route="two_pass"),
            lambda: fnr._rmsnorm_launch(get_x(), s, eps, sp1,
                                        route="registers"),
            pairs=3, iters=50)
        bodies["speedup"] = (bodies["two_pass"]["ms"]
                             / bodies["registers"]["ms"])
        for name in ("two_pass", "registers"):
            bodies[name]["bound_share"] = bound / bodies[name]["ms"]
        return {"kernel_vs_library": vs, "registers_vs_two_pass": bodies}

    norm = _turns(lambda: fnr.fused_rmsnorm_reference(x, s, **nkw),
                  lambda: fnr.fused_rmsnorm(x, s, **nkw),
                  lambda: torch.nn.functional.rms_norm(x, (D,), w, eps))
    nbytes = 2 * x.numel() * x.element_size() + D * s.element_size()
    flops = 4.0 * x.numel()          # square-add, x * r, times s
    bound, by = _bound(nbytes, flops, torch.float32)
    norm.update({"shape": shape_name, "dims": list(x.shape),
                 "max_abs_err": err, "max_abs_ref": ref, "tol_rel": tol,
                 "max_abs_diff_two_pass": old_err, "routes": took,
                 "bitwise_repeat": repeat,
                 "ok": (err <= tol * ref and repeat
                        and took["registers"] == 2 and took["two_pass"] == 0
                        and bool(torch.isfinite(y.float()).all())),
                 "bytes": nbytes, "flops": flops, "bound_ms": bound,
                 "bound_by": by, "library": "torch.nn.functional.rms_norm",
                 **compare(lambda: x)})
    copies = max(2, -(-100_000_000 // (x.numel() * x.element_size())) + 1)
    xs = [x] + [x.clone() for _ in range(copies - 1)]
    turn = [0]

    def cold_x():
        turn[0] = (turn[0] + 1) % copies
        return xs[turn[0]]
    norm["cold"] = {"copies": copies, **compare(cold_x)}
    return norm


def _time_llama_norm_shape(dev):
    """The fused rms_norm at the train_fused_ce phase's Llama-3.1-8B
    microbatch (LLAMA_NORM_SHAPE, bf16, eps 1e-5, the plain scale), as
    ``_time_norm``."""
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    x = torch.randn(LLAMA_NORM_SHAPE, generator=g,
                    device=dev).to(torch.bfloat16)
    s = (torch.randn((x.shape[-1],), generator=g, device=dev) * 0.1
         + 1.0).to(torch.bfloat16)
    return _time_norm(x, s, dict(eps=1e-5, scale_plus_one=False),
                      "llama3_8b_train_2x1024")


def _time_fused_gemma_shape(dev):
    """Both fused kernels at the train_fused phase's Gemma-2-9B shapes
    (bf16): the rms_norm as ``_time_norm``, the RoPE against its plain
    version (it has no single PyTorch call). RoPE's bound: bytes of each
    input read once and each output written once over the memory rate,
    against fp32 FLOPs over the fp32 rate."""
    import torch
    from gke_ray_train_tpu_torch.ops.fused_norm_rope import (
        fused_rope_qk, fused_rope_qk_reference)
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    bf = torch.bfloat16
    x = torch.randn(GEMMA_NORM_SHAPE, generator=g, device=dev).to(bf)
    D = x.shape[-1]
    s = (torch.randn((D,), generator=g, device=dev) * 0.1).to(bf)
    norm = _time_norm(x, s, dict(eps=1e-6, scale_plus_one=True),
                      "gemma2_9b_train_4096")
    tol = FUSED_TOL["bfloat16"]

    B, S, H, K, dh = GEMMA_ROPE_SHAPE
    q = torch.randn((B, S, H, dh), generator=g, device=dev).to(bf)
    k = torch.randn((B, S, K, dh), generator=g, device=dev).to(bf)
    pos = _packed_rope_positions(B, S, dev, g)
    f = _rope_freqs(dh, dev)
    got = fused_rope_qk(q, k, pos, f)
    want = fused_rope_qk_reference(q, k, pos, f)
    errs = [_rel_err(a, b) for a, b in zip(got, want)]
    rope_err = max(e for e, _ in errs)
    rope_ok = (all(e <= tol * r for e, r in errs)
               and all(bool(torch.isfinite(a.float()).all()) for a in got))
    rope = _turns(lambda: fused_rope_qk_reference(q, k, pos, f),
                  lambda: fused_rope_qk(q, k, pos, f), None)
    nbytes = (2 * (q.numel() + k.numel()) * q.element_size()
              + pos.numel() * 4 + f.numel() * 4)
    # 6 FLOPs a rotated pair, and one sincosf per (row, frequency) counted
    # as 2
    flops = 3.0 * (q.numel() + k.numel()) + 2.0 * B * S * dh // 2
    rope.update({"shape": "gemma2_9b_train_4096", "max_abs_err": rope_err,
                 "max_abs_ref": max(r for _, r in errs), "tol_rel": tol,
                 "ok": rope_ok, "bytes": nbytes, "flops": flops,
                 "library": None})
    rope["bound_ms"], rope["bound_by"] = _bound(nbytes, flops, torch.float32)
    return {"fused_rmsnorm": norm, "fused_rope_qk": rope}


# per-head rms_norm + RoPE cases: every head dim of the shipped families
# (32 for the small tests), both dtypes and scale parameterizations, 37
# sequence rows (no 8-row tile divides them)
NORM_ROPE_CASES = [dict(shape=(2, 37, 4, dh), dtype=dt, scale_plus_one=sp1)
                   for dt in ("float32", "bfloat16")
                   for dh in (32, 64, 128, 256) for sp1 in (False, True)]
# the registry's full-width cases: the Llama-3.1-8B q of the training
# microbatch, the Gemma-2-9B q of one packed row
NORM_ROPE_SHAPES = {"llama3_8b_train_2x1024": ((2, 1024, 32, 128), False),
                    "gemma2_9b_train_4096": ((1, 4096, 16, 256), True)}


def _norm_rope_inputs(shape, dtype, sp1, dev, g, unaligned=False):
    """x, scale, positions (restarting per document, and the last row's
    last third from 4,095 down), frequencies. ``unaligned``: x is a
    contiguous view 4 bytes past a 16-byte boundary."""
    import torch
    B, S, H, dh = shape
    dt = getattr(torch, dtype)
    n = B * S * H * dh
    flat = torch.randn((n + 8,), generator=g, device=dev).to(dt)
    off = 4 // flat.element_size() if unaligned else 0
    x = flat[off:off + n].view(shape)
    s = (torch.randn((dh,), generator=g, device=dev) * 0.1
         + (0.0 if sp1 else 1.0)).to(dt)
    pos = _packed_rope_positions(B, S, dev, g)
    tail = S - 2 * S // 3
    pos[-1, -tail:] = 4095 - torch.arange(tail, dtype=torch.int32,
                                          device=dev)
    return x, s, pos, _rope_freqs(dh, dev)


def _norm_rope_errors(x, s, pos, f, kw):
    """(max |error|, its scale) of the kernel against its plain version
    on these inputs: the value and the gradients of x and scale under a
    random probe, the plain version's by autograd."""
    import torch
    from gke_ray_train_tpu_torch.ops.fused_norm_rope import (
        fused_rmsnorm_rope, fused_rmsnorm_rope_reference)
    g = torch.Generator(device=x.device)
    g.manual_seed(5)
    probe = torch.randn(x.shape, generator=g, device=x.device)
    outs = []
    for fn in (fused_rmsnorm_rope, fused_rmsnorm_rope_reference):
        # the value from x itself (a clone would realign an unaligned
        # view), the gradients from a leaf copy
        y = fn(x, s, pos, f, **kw)
        xg = x.detach().clone().requires_grad_(True)
        sg = s.detach().clone().requires_grad_(True)
        (fn(xg, sg, pos, f, **kw).float() * probe).sum().backward()
        outs.append((y, xg.grad, sg.grad))
    torch.cuda.synchronize()
    errs = {}
    for name, got, want in zip(("value", "dx", "dscale"), *outs):
        e = float((got.float() - want.float()).abs().max())
        if not bool(torch.isfinite(got.float()).all()):
            e = float("inf")
        scale = float(want.float().abs().max())
        errs[name] = (e, scale if name != "value" else max(1.0, scale))
    return errs


def _check_norm_rope_cases(dev):
    """The per-head rms_norm + RoPE kernel against its plain version over
    NORM_ROPE_CASES (values, dx and dscale), and once on an unaligned
    view of x per dtype (the scalar path)."""
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(6)
    cases = NORM_ROPE_CASES + [
        dict(shape=(2, 37, 4, 64), dtype=dt, scale_plus_one=False,
             unaligned=True) for dt in ("float32", "bfloat16")]
    rows = []
    for c in cases:
        x, s, pos, f = _norm_rope_inputs(c["shape"], c["dtype"],
                                         c["scale_plus_one"], dev, g,
                                         c.get("unaligned", False))
        if c.get("unaligned") and not (x.is_contiguous()
                                       and x.data_ptr() % 16):
            raise SystemExit("kernel phase: the unaligned norm + rope case "
                             "got an aligned or strided view")
        kw = dict(eps=1e-6, scale_plus_one=c["scale_plus_one"])
        tol = FUSED_TOL[c["dtype"]]
        row = {"kernel": "fused_rmsnorm_rope", **c, "tol_rel": tol,
               "ok": True}
        for name, (e, scale) in _norm_rope_errors(x, s, pos, f,
                                                  kw).items():
            row[f"max_abs_err_{name}"] = e
            row["ok"] = row["ok"] and e <= tol * scale
        rows.append(row)
    return rows


def _time_norm_rope(dev):
    """The per-head rms_norm + RoPE at NORM_ROPE_SHAPES (bf16), held
    against its plain version and timed against it (no single PyTorch
    call computes it). Bound: x read once and y written once (plus the
    positions, frequencies and scale) over the memory rate, against fp32
    FLOPs (7 an element: square-add, two scalings, half a rotated pair's
    6; and a sincosf per (row, frequency) counted as 2) over the fp32
    rate."""
    import torch
    from gke_ray_train_tpu_torch.ops.fused_norm_rope import (
        fused_rmsnorm_rope, fused_rmsnorm_rope_reference)
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    tol = FUSED_TOL["bfloat16"]
    out = {}
    for name, (shape, sp1) in NORM_ROPE_SHAPES.items():
        x, s, pos, f = _norm_rope_inputs(shape, "bfloat16", sp1, dev, g)
        kw = dict(eps=1e-6 if sp1 else 1e-5, scale_plus_one=sp1)
        errs = _norm_rope_errors(x, s, pos, f, kw)
        r = _turns(lambda: fused_rmsnorm_rope_reference(x, s, pos, f, **kw),
                   lambda: fused_rmsnorm_rope(x, s, pos, f, **kw), None)
        B, S, H, dh = shape
        nbytes = (2 * x.numel() * x.element_size() + s.numel()
                  * s.element_size() + pos.numel() * 4 + f.numel() * 4)
        flops = 7.0 * x.numel() + 2.0 * B * S * dh // 2
        bound, by = _bound(nbytes, flops, torch.float32)
        r.update({"shape": name, "dims": list(shape),
                  "max_abs_err": errs["value"][0],
                  "max_abs_ref": errs["value"][1],
                  "grad_errs": {k: list(v) for k, v in errs.items()
                                if k != "value"},
                  "tol_rel": tol,
                  "ok": all(e <= tol * sc for e, sc in errs.values()),
                  "bound_ms": bound, "bound_by": by, "bytes": nbytes,
                  "flops": flops, "library": None,
                  "bound_share": bound / r["kernel_ms"]})
        out[name] = r
        del x, s, pos
        torch.cuda.empty_cache()
    return out


# fused cross-entropy cases (N rows, D, V): ragged row tiles (300), the
# hidden widths of the small tests, Gemma-2 and Llama, the vocab sizes of
# Llama-2 / Mistral (32,000) and Llama-3 (128,256) and one no tile
# divides; then odd D and V (no 16-byte rows), and V = 1
CE_CASES = ([dict(N=300, D=D, V=V, dtype=dt)
             for dt in ("float32", "bfloat16") for D in (64, 3584, 4096)
             for V in (1000, 32000, 128256)]
            + [dict(N=130, D=100, V=1001, dtype=dt)
               for dt in ("float32", "bfloat16")]
            + [dict(N=5, D=64, V=1, dtype="bfloat16")]
            # the pre-train entry's char vocab (the synthetic corpus's 45
            # columns, under one 128-column tile) at its step's rows
            + [dict(N=4096, D=2048, V=45, dtype=dt)
               for dt in ("float32", "bfloat16")])
# the train_fused_ce phase's microbatch: Llama-3.1-8B, 2 x 1,024 rows
CE_LLAMA_SHAPE = dict(N=2048, D=4096, V=128256, dtype="bfloat16")


def _ce_inputs(case, dev, seed=0, in_range=False):
    """Hidden rows of unit scale, a head of std 0.05 (logits of std
    0.05 sqrt(D): 0.4 at D 64, 3.2 at D 4,096), random labels and weights
    in [0.5, 1.5]; unless ``in_range``, one label V + 5, one -1 and five
    weight-0 rows."""
    import torch
    N, D, V = case["N"], case["D"], case["V"]
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    dt = getattr(torch, case["dtype"])
    x = torch.randn((N, D), generator=g, device=dev).to(dt)
    head = (torch.randn((D, V), generator=g, device=dev) * 0.05).to(dt)
    t = torch.randint(0, V, (N,), generator=g, device=dev, dtype=torch.int32)
    w = torch.rand((N,), generator=g, device=dev) + 0.5
    if not in_range:
        t[min(3, N - 1)] = V + 5
        t[N // 2] = -1
        w[N // 3:N // 3 + 5] = 0.0
    return x, head, t, w


def _ce_errors(case, x, head, t, w):
    """Each cross-entropy kernel against its plain version on these
    inputs (dx and dhead from the plain version's lse), and dx and dhead
    again with every label out of range (``..._softmax``: dl is the
    softmax term alone): ({check: (max |error|, its scale, tolerance)},
    the kernel's target logits, its dx)."""
    import torch
    from gke_ray_train_tpu_torch.ops.fused_ce import (
        fused_ce_dhead, fused_ce_dx, fused_ce_grads_reference,
        fused_ce_row_stats, fused_ce_row_stats_reference)
    tol = CE_TOL[case["dtype"]]

    def err(got, want, floor):
        e = float((got.float() - want.float()).abs().max())
        if not bool(torch.isfinite(got.float()).all()):
            e = float("inf")
        return e, max(floor, float(want.float().abs().max()))
    lse, tgt = fused_ce_row_stats(x, head, t)
    ref_lse, ref_tgt = fused_ce_row_stats_reference(x, head, t)
    (e_l, s_l), (e_t, s_t) = err(lse, ref_lse, 1.0), err(tgt, ref_tgt, 1.0)
    errs = {"fused_ce_row_stats": (max(e_l, e_t), max(s_l, s_t),
                                   tol["stats"])}
    V = head.shape[1]
    off = torch.where(torch.arange(len(t), device=t.device) % 2 == 0,
                      V + 5, -1).to(torch.int32)
    for labels, suffix in ((t, ""), (off, "_softmax")):
        dx = fused_ce_dx(x, head, labels, w, ref_lse)
        dh = fused_ce_dhead(x, head, labels, w, ref_lse)
        torch.cuda.synchronize()
        ref_dx, ref_dh = fused_ce_grads_reference(x, head, labels, w,
                                                  ref_lse)
        errs["fused_ce_dx" + suffix] = err(dx, ref_dx, 0.0) + (tol["grads"],)
        errs["fused_ce_dhead" + suffix] = (err(dh, ref_dh, 0.0)
                                           + (tol["grads"],))
        if not suffix:
            dx_labelled = dx
        del dh, ref_dx, ref_dh
    return errs, tgt, dx_labelled


def _check_ce_cases(dev):
    """The three cross-entropy kernels against their plain versions over
    CE_CASES (dx and dhead also with the softmax term alone, see
    ``_ce_errors``); out-of-range labels give a target logit of 0 and
    weight-0 rows a dx of 0."""
    import torch
    rows = []
    for c in CE_CASES:
        x, head, t, w = _ce_inputs(c, dev)
        errs, tgt, dx = _ce_errors(c, x, head, t, w)
        row = {"kernel": "fused_ce", **c, "ok": True}
        for name, (e, scale, tol) in errs.items():
            row[f"max_abs_err_{name}"] = e
            row[f"scale_{name}"] = scale
            row[f"tol_rel_{name}"] = tol
            row["ok"] = row["ok"] and e <= tol * scale
        N = c["N"]
        row["label_rule_ok"] = (float(tgt[min(3, N - 1)]) == 0.0
                                and float(tgt[N // 2]) == 0.0)
        row["weight0_ok"] = float(
            dx[N // 3:N // 3 + 5].float().abs().max()) == 0.0
        row["ok"] = row["ok"] and row["label_rule_ok"] and row["weight0_ok"]
        rows.append(row)
        del x, head, t, w, tgt, dx
        torch.cuda.empty_cache()
    return rows


def _time_ce_llama_shape(dev):
    """The three cross-entropy kernels at the train_fused_ce phase's
    microbatch (CE_LLAMA_SHAPE, in-range labels), each held against its
    plain version (the bf16 kernels' dl rounding against fp32 dl; dx and
    dhead also with the softmax term alone, see ``_ce_errors``) and
    timed against it and against the unfused route: ``matmul_f32`` to
    fp32 logits, then ``F.cross_entropy`` — two calls — forward (row
    statistics) and its backward to x (dx) or to the head (dhead). Bounds:
    each input read once and each output written once, against 2 N D V
    bf16 FLOPs for the row statistics and 4 N D V (the recompute and the
    gradient product) for dx and dhead. The public calls here must all
    take the wgmma body (``routes``), which is also timed against the
    mma.sync body it replaced, in alternated turns
    (``wgmma_vs_mma_sync``); the row statistics must repeat bitwise."""
    import torch
    import torch.nn.functional as F
    from gke_ray_train_tpu_torch.ops import fused_ce
    from gke_ray_train_tpu_torch.ops.fused_ce import (
        fused_ce_dhead, fused_ce_dx, fused_ce_grads_reference,
        fused_ce_row_stats, fused_ce_row_stats_reference)
    from gke_ray_train_tpu_torch.ops.matmul import matmul_f32
    case = CE_LLAMA_SHAPE
    x, head, t, w = _ce_inputs(case, dev, seed=4, in_range=True)
    routes_before = _route_counts()
    errs = _ce_errors(case, x, head, t, w)[0]
    lse, tgt = fused_ce_row_stats(x, head, t)
    again = fused_ce_row_stats(x, head, t)
    stats_repeat = bool(torch.equal(lse, again[0])
                        and torch.equal(tgt, again[1]))
    del again
    N, D, V = case["N"], case["D"], case["V"]
    tl = t.long()

    def unfused_nll(xx, hh):
        return torch.sum(F.cross_entropy(matmul_f32(xx, hh), tl,
                                         reduction="none") * w)
    xg = x.clone().requires_grad_(True)
    hg = head.clone().requires_grad_(True)
    nll_x = unfused_nll(xg, head)
    nll_h = unfused_nll(x, hg)

    def lib_fwd():
        with torch.no_grad():
            return unfused_nll(x, head)
    runs = {
        "fused_ce_row_stats": _turns(
            lambda: fused_ce_row_stats_reference(x, head, t),
            lambda: fused_ce_row_stats(x, head, t), lib_fwd, iters=5),
        "fused_ce_dx": _turns(
            lambda: fused_ce_grads_reference(x, head, t, w, lse),
            lambda: fused_ce_dx(x, head, t, w, lse),
            lambda: torch.autograd.grad(nll_x, xg, retain_graph=True),
            iters=5),
        "fused_ce_dhead": _turns(
            lambda: fused_ce_grads_reference(x, head, t, w, lse),
            lambda: fused_ce_dhead(x, head, t, w, lse),
            lambda: torch.autograd.grad(nll_h, hg, retain_graph=True),
            iters=5),
    }
    # the bodies the public calls above took at this shape
    taken = {k: {r: n - routes_before[k][r] for r, n in v.items()}
             for k, v in _route_counts().items()}
    es = x.element_size()
    ins = (N * D + D * V) * es + 4 * N
    work = {"fused_ce_row_stats": (ins + 8 * N, 2.0 * N * D * V),
            "fused_ce_dx": (ins + 8 * N + N * D * es, 4.0 * N * D * V),
            "fused_ce_dhead": (ins + 8 * N + D * V * es, 4.0 * N * D * V)}
    for name, r in runs.items():
        nbytes, flops = work[name]
        bound, by = _bound(nbytes, flops, x.dtype)
        e, scale, tol = errs[name]
        if name + "_softmax" in errs:
            es_, ss_, _ = errs[name + "_softmax"]
            r.update({"max_abs_err_softmax": es_, "max_abs_ref_softmax": ss_,
                      "ok_softmax": es_ <= tol * ss_})
        r.update({"shape": "llama3_8b_train_2x1024", "bound_ms": bound,
                  "bound_by": by, "bytes": nbytes, "flops": flops,
                  "tflops_per_s": flops / r["kernel_ms"] / 1e9,
                  "max_abs_err": e, "max_abs_ref": scale, "tol_rel": tol,
                  "ok": e <= tol * scale and r.get("ok_softmax", True),
                  "library": "matmul_f32 + F.cross_entropy (two calls"
                  + (", forward)" if name == "fused_ce_row_stats"
                     else ", their backward)")})
        # every public call at this shape went through the wgmma body
        r["routes"] = taken[name]
        r["ok"] = r["ok"] and taken[name]["wgmma"] > 0 and sum(
            taken[name].values()) == taken[name]["wgmma"]
        if name == "fused_ce_row_stats":
            launch = functools.partial(fused_ce._row_stats_launch, x, head,
                                       t)
            r["bitwise_repeat"] = stats_repeat
            r["ok"] = r["ok"] and stats_repeat
        else:
            launch = functools.partial(fused_ce._grad_launch, name, x, head,
                                       t, w, lse)
        r["wgmma_vs_mma_sync"] = _time_routes(
            getattr(fused_ce, name), lambda route: launch(route=route),
            "mma_sync", r["bound_ms"], flops)
    del nll_x, nll_h, xg, hg
    torch.cuda.empty_cache()
    return runs


# the vocab shards of the Llama-3.1-8B head the TP paths give the
# cross-entropy kernels: model 2 (V / 2 = 64,128) and model 4 (V / 4 =
# 32,064, no multiple of a 128-column vocab tile)
CE_SHARDS = (2, 4)


def _time_ce_vocab_shards(dev):
    """Rows 4-6 over the vocab shards of the Llama-3.1-8B head
    (CE_LLAMA_SHAPE split ``CE_SHARDS`` ways), in one process through the
    port's own shift and merge (``parallel/tensor.py::shift_labels``,
    ``merge_shard_stats``): every shard's row statistics of its shifted
    labels, merged, and dx summed over the shards and the dhead shards
    side by side, held against the unsharded plain version and the
    unsharded kernel. Shard 1 (labels off it on both sides: negative and
    past its end) is held kernel against plain on its own and timed,
    better of two turns: kernel, plain version, and ``matmul_f32`` +
    ``F.cross_entropy`` on the same shard (labels taken modulo the shard's
    width: F.cross_entropy takes no label outside it), with its bound."""
    import torch
    import torch.nn.functional as F
    from gke_ray_train_tpu_torch.ops.fused_ce import (
        fused_ce_dhead, fused_ce_dx, fused_ce_grads_reference,
        fused_ce_row_stats, fused_ce_row_stats_reference)
    from gke_ray_train_tpu_torch.ops.matmul import matmul_f32
    from gke_ray_train_tpu_torch.parallel.tensor import (
        merge_shard_stats, shift_labels)
    case = CE_LLAMA_SHAPE
    tol = CE_TOL[case["dtype"]]
    x, head, t, w = _ce_inputs(case, dev, seed=6, in_range=True)
    N, D, V = case["N"], case["D"], case["V"]
    ref_lse, ref_tgt = fused_ce_row_stats_reference(x, head, t)
    ref_dx, ref_dh = fused_ce_grads_reference(x, head, t, w, ref_lse)
    un_lse, un_tgt = fused_ce_row_stats(x, head, t)
    un_dx = fused_ce_dx(x, head, t, w, un_lse)
    un_dh = fused_ce_dhead(x, head, t, w, un_lse)

    def err(got, want, floor=0.0):
        e = float((got.float() - want.float()).abs().max())
        if not bool(torch.isfinite(got.float()).all()):
            e = float("inf")
        return e, max(floor, float(want.float().abs().max()))
    out = {}
    for n in CE_SHARDS:
        vl = V // n
        shards = [s.contiguous() for s in head.split(vl, dim=1)]
        labels = [shift_labels(t, k, vl) for k in range(n)]
        stats = [fused_ce_row_stats(x, s, lab)
                 for s, lab in zip(shards, labels)]
        lse, tgt = merge_shard_stats(torch.stack([a for a, _ in stats]),
                                     torch.stack([b for _, b in stats]))
        dx = sum(fused_ce_dx(x, s, lab, w, lse).float()
                 for s, lab in zip(shards, labels)).to(x.dtype)
        dh = torch.cat([fused_ce_dhead(x, s, lab, w, lse)
                        for s, lab in zip(shards, labels)], dim=1)
        torch.cuda.synchronize()
        row = {"shards": n, "v_local": vl,
               "labels_off_shard_1": {
                   "negative": int((labels[1] < 0).sum()),
                   "past_end": int((labels[1] >= vl).sum())}}
        checks = {
            "merged_stats_vs_plain": (max(err(lse, ref_lse, 1.0)[0],
                                          err(tgt, ref_tgt, 1.0)[0]),
                                      max(err(lse, ref_lse, 1.0)[1],
                                          err(tgt, ref_tgt, 1.0)[1]),
                                      tol["stats"]),
            "merged_stats_vs_unsharded_kernel": (
                max(err(lse, un_lse, 1.0)[0], err(tgt, un_tgt, 1.0)[0]),
                max(err(lse, un_lse, 1.0)[1], err(tgt, un_tgt, 1.0)[1]),
                tol["stats"]),
            "dx_vs_plain": err(dx, ref_dx) + (tol["grads"],),
            "dx_vs_unsharded_kernel": err(dx, un_dx) + (tol["grads"],),
            "dhead_vs_plain": err(dh, ref_dh) + (tol["grads"],),
            "dhead_vs_unsharded_kernel": err(dh, un_dh) + (tol["grads"],)}
        del dx, dh, stats
        # shard 1 alone: kernel against plain, then timed
        s1, l1 = shards[1], labels[1]
        p_lse, p_tgt = fused_ce_row_stats_reference(x, s1, l1)
        k_lse, k_tgt = fused_ce_row_stats(x, s1, l1)
        p_dx, p_dh = fused_ce_grads_reference(x, s1, l1, w, p_lse)
        checks["shard1_row_stats"] = (
            max(err(k_lse, p_lse, 1.0)[0], err(k_tgt, p_tgt, 1.0)[0]),
            max(err(k_lse, p_lse, 1.0)[1], err(k_tgt, p_tgt, 1.0)[1]),
            tol["stats"])
        checks["shard1_dx"] = err(fused_ce_dx(x, s1, l1, w, p_lse),
                                  p_dx) + (tol["grads"],)
        checks["shard1_dhead"] = err(fused_ce_dhead(x, s1, l1, w, p_lse),
                                     p_dh) + (tol["grads"],)
        del p_dx, p_dh
        row["checks"] = {k: {"max_abs_err": e, "max_abs_ref": sc,
                             "tol_rel": tl, "ok": e <= tl * sc}
                         for k, (e, sc, tl) in checks.items()}
        row["ok"] = all(c["ok"] for c in row["checks"].values())
        tl_mod = (l1.long() % vl)

        def unfused_nll(xx, hh):
            return torch.sum(F.cross_entropy(matmul_f32(xx, hh), tl_mod,
                                             reduction="none") * w)
        xg = x.clone().requires_grad_(True)
        hg = s1.clone().requires_grad_(True)
        nll_x, nll_h = unfused_nll(xg, s1), unfused_nll(x, hg)

        def lib_fwd():
            with torch.no_grad():
                return unfused_nll(x, s1)
        es = x.element_size()
        ins = (N * D + D * vl) * es + 4 * N
        work = {"fused_ce_row_stats": (ins + 8 * N, 2.0 * N * D * vl),
                "fused_ce_dx": (ins + 8 * N + N * D * es,
                                4.0 * N * D * vl),
                "fused_ce_dhead": (ins + 8 * N + D * vl * es,
                                   4.0 * N * D * vl)}
        timed = {
            "fused_ce_row_stats": _turns(
                lambda: fused_ce_row_stats_reference(x, s1, l1),
                lambda: fused_ce_row_stats(x, s1, l1), lib_fwd, iters=5),
            "fused_ce_dx": _turns(
                lambda: fused_ce_grads_reference(x, s1, l1, w, k_lse),
                lambda: fused_ce_dx(x, s1, l1, w, k_lse),
                lambda: torch.autograd.grad(nll_x, xg, retain_graph=True),
                iters=5),
            "fused_ce_dhead": _turns(
                lambda: fused_ce_grads_reference(x, s1, l1, w, k_lse),
                lambda: fused_ce_dhead(x, s1, l1, w, k_lse),
                lambda: torch.autograd.grad(nll_h, hg, retain_graph=True),
                iters=5)}
        for name, r in timed.items():
            nbytes, flops = work[name]
            bound, by = _bound(nbytes, flops, x.dtype)
            r.update({"bound_ms": bound, "bound_by": by, "bytes": nbytes,
                      "flops": flops, "bound_ratio": r["kernel_ms"] / bound,
                      "tflops_per_s": flops / r["kernel_ms"] / 1e9,
                      "library": "matmul_f32 + F.cross_entropy on the "
                      "shard"})
        row["timed_shard1"] = timed
        out[f"v_over_{n}"] = row
        del nll_x, nll_h, xg, hg, shards, labels
        torch.cuda.empty_cache()
    return out


def phase_kernels(dev):
    import torch
    from gke_ray_train_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)
    rows = [_check_case(n, c, dev)[0] for n, c in KERNEL_CASES.items()]
    bwd_rows = [_check_bwd_case(n, c, dev) for n, c in KERNEL_CASES.items()]
    bwd_rows.append(_check_bwd_case("llama3_8b_train_1024", TRAIN_SHAPE, dev))
    for n, c in GEMMA_ATTN_CASES.items():
        rows.append(_check_case(n, c, dev)[0])
        bwd_rows.append(_check_bwd_case(n, c, dev))
    timings = []
    for name, case in SERVE_SHAPES.items():
        row, (q, k, v, kw) = _check_case(name, case, dev)
        rows.append(row)
        ref_args = (q, k, v, kw["q_positions"], kw["kv_positions"],
                    kw["q_segment_ids"], kw["kv_segment_ids"])
        ref_kw = dict(causal=kw["causal"],
                      sliding_window=kw["sliding_window"],
                      scale=kw["scale"], logit_softcap=kw["logit_softcap"])
        # the library yardstick: SDPA with the same boolean mask
        from gke_ray_train_tpu_torch.ops.attention import (
            make_attention_mask)
        mask = make_attention_mask(
            kw["q_positions"], kw["kv_positions"], kw["q_segment_ids"],
            kw["kv_segment_ids"], causal=kw["causal"],
            sliding_window=kw["sliding_window"])[:, None]
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention

        def plain():
            return flash_attention_reference(*ref_args, **ref_kw)

        def kernel():
            return flash_attention(q, k, v, **kw)

        def library():
            return sdpa(qt, kt, vt, attn_mask=mask, scale=kw["scale"],
                        enable_gqa=True)
        # device time, in turns: plain, kernel, kernel, plain, library
        t = _turns(plain, kernel, library)
        bound, bound_by, nbytes, flops = _bound_ms(q, k, v, kw)
        t.update({"shape": name, "bound_ms": bound, "bound_by": bound_by,
                  "bytes": nbytes, "flops": flops,
                  # per call between CUDA events, host overhead in
                  "call_ms": {"kernel": cuda_ms(kernel),
                              "plain": cuda_ms(plain),
                              "library": cuda_ms(library)},
                  "max_abs_err_out": row["max_abs_err_out"]})
        timings.append(t)
    train = _time_train_shape(dev)
    gemma_attn = _time_gemma_attn(dev)
    fused_rows = _check_fused_cases(dev)
    fused = _time_fused_gemma_shape(dev)
    llama_norm = _time_llama_norm_shape(dev)
    norm_rope_rows = _check_norm_rope_cases(dev)
    norm_rope = _time_norm_rope(dev)
    ce_rows = _check_ce_cases(dev)
    ce = _time_ce_llama_shape(dev)
    ce_shards = _time_ce_vocab_shards(dev)
    ring_rows = _check_ring_cases(dev)
    ok = all(r["ok"] for r in rows + bwd_rows + fused_rows + norm_rope_rows
             + ce_rows + ring_rows + list(fused.values())
             + list(norm_rope.values()) + list(ce.values())
             + list(ce_shards.values()) + [llama_norm])
    emit({"phase": "kernels", "ok": ok, "cases": rows, "bwd_cases": bwd_rows,
          "ring_cases": ring_rows,
          "fused_cases": fused_rows, "norm_rope_cases": norm_rope_rows,
          "ce_cases": ce_rows, "timings": timings, "train_shape": train,
          "gemma_train_shape": fused, "gemma_attn_shape": gemma_attn,
          "llama_norm_shape": llama_norm,
          "norm_rope_shapes": norm_rope, "llama_ce_shape": ce,
          "llama_ce_vocab_shards": ce_shards,
          "device_ms_timer_calls": dict(TIMER_CALLS)})
    if not ok:
        raise SystemExit("kernel phase: a case disagrees with the plain "
                         "version beyond its tolerance")
    # the summary line carries the Llama shape
    return {**train, **fused, **ce,
            "fused_rmsnorm_rope": norm_rope["llama3_8b_train_2x1024"]}


# ---------------------------------------------------------------------------
# kernelcheck
# ---------------------------------------------------------------------------

def phase_kernelcheck(dev):
    """The port's kernel sweep on the card against the committed CUDA
    pins, with the launch counts at 0 just before it; fails on any
    finding. Returns the sweep's launches per kernel."""
    from gke_ray_train_tpu_torch.analysis import kernelcheck
    _reset_launch_counts()
    t0 = time.perf_counter()
    results = kernelcheck.sweep(device=dev)
    seconds = time.perf_counter() - t0
    launches = _launch_counts()
    findings = (kernelcheck.registration_findings()
                + kernelcheck.ledger_findings(results, "cuda"))
    cases = []
    for r in results:
        pins = kernelcheck.pinned(r, "cuda") or {}
        cases.append({"kernel": r.kernel, "case": r.case,
                      "value_err": r.value_err, "grad_err": r.grad_err,
                      "pin_value": pins.get("value"),
                      "pin_grad": pins.get("grad"), "seconds": r.seconds})
    emit({"phase": "kernelcheck", "ok": not findings, "seconds": seconds,
          "cases": cases, "findings": [str(f) for f in findings],
          "launches": launches})
    if findings:
        raise SystemExit(f"kernelcheck phase: {len(findings)} finding(s)")
    return launches


# ---------------------------------------------------------------------------
# phase 4: serve
# ---------------------------------------------------------------------------

def _requests(n, vocab, seed, plen=(16, 400), new=(16, 64)):
    from gke_ray_train_tpu_torch.serve import Request
    rng = np.random.default_rng(seed)
    return [Request(rid=f"r{i}",
                    token_ids=rng.integers(0, vocab, size=int(
                        rng.integers(plen[0], plen[1] + 1))).astype(np.int32),
                    max_new_tokens=int(rng.integers(new[0], new[1] + 1)))
            for i in range(n)]


def phase_serve(dev):
    import torch
    from gke_ray_train_tpu_torch.models import init_params, llama3_8b
    from gke_ray_train_tpu_torch.ops.flash_attention import flash_attention
    from gke_ray_train_tpu_torch.plan import ExecutionPlan
    from gke_ray_train_tpu_torch.serve import BatchEngine
    cfg = dataclasses.replace(
        llama3_8b(param_dtype="bfloat16", dtype="bfloat16", remat=False),
        max_seq_len=512)
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    plan = ExecutionPlan.resolve(env={"MAX_BATCH": "8",
                                      "DECODE_BUCKETS": "256,512"})
    eos = (128001, 128009)
    # warm-up: one short request per bucket on a throwaway engine
    warm = BatchEngine(model, cfg, plan=plan, eos_ids=eos, device=dev)
    warm.run_until_drained(_requests(2, cfg.vocab_size, seed=7,
                                     plen=(100, 300), new=(4, 4)))
    del warm

    reqs = _requests(24, cfg.vocab_size, seed=1234)
    engine = BatchEngine(model, cfg, plan=plan, eos_ids=eos, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    t0 = time.perf_counter()
    comps = engine.run_until_drained(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_attention.launches
    stats = engine.stats()

    buckets = sorted({c.bucket for c in comps})
    gen = [c.length - c.prompt_len for c in comps]
    problems = []
    for r, c in zip(reqs, comps):
        g = c.generated
        if not (1 <= len(g) <= r.max_new_tokens):
            problems.append(f"{r.rid}: {len(g)} tokens generated")
        if c.finish_reason == "length" and len(g) != r.max_new_tokens:
            problems.append(f"{r.rid}: length stop after {len(g)}")
        if len(g) and (g.min() < 0 or g.max() >= cfg.vocab_size):
            problems.append(f"{r.rid}: token out of vocab")
        if not np.array_equal(c.tokens[:c.prompt_len], r.token_ids):
            problems.append(f"{r.rid}: prompt region changed")
    if len(comps) != 24 or stats["completed"] != 24:
        problems.append(f"{stats['completed']} of 24 completed")
    if buckets != [256, 512]:
        problems.append(f"buckets used {buckets}, want [256, 512]")
    if stats["refills"] < 1:
        problems.append("no mid-batch refill happened")
    if stats["prefills"] != 24 or launches != cfg.n_layers * 24:
        problems.append(f"flash launches {launches} != n_layers "
                        f"{cfg.n_layers} x prefills {stats['prefills']}")
    ttft = sorted(c.first_token_s for c in comps)
    row = {"phase": "serve", "ok": not problems, "problems": problems,
           "model": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "params": cfg.param_count(), "dtype": cfg.dtype,
           "init_s": init_s, "requests": len(comps),
           "generated_tokens": int(sum(gen)), "wall_s": wall,
           "tokens_per_s": sum(gen) / wall,
           "ttft_p50_s": ttft[len(ttft) // 2],
           "ttft_max_s": ttft[-1],
           "token_latency_p50_s": stats["p50_token_latency_s"],
           "token_latency_p99_s": stats["p99_token_latency_s"],
           "batch_occupancy": stats["batch_occupancy"],
           "iterations": stats["iterations"], "refills": stats["refills"],
           "prefills": stats["prefills"], "flash_launches": launches,
           "buckets": buckets,
           "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    emit(row)
    if problems:
        raise SystemExit("serve phase failed: " + "; ".join(problems))
    del model, engine
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 5: parity
# ---------------------------------------------------------------------------

def phase_parity(dev):
    import torch
    from gke_ray_train_tpu_torch.models import (
        forward_step, greedy_generate_cached, init_cache, init_params,
        llama3_8b)
    from gke_ray_train_tpu_torch.ops.flash_attention import flash_attention
    from gke_ray_train_tpu_torch.plan import ExecutionPlan
    from gke_ray_train_tpu_torch.serve import BatchEngine, form_prompt_buffer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(
        llama3_8b(dtype="float32", param_dtype="float32", remat=False),
        max_seq_len=512, n_layers=4)
    model = init_params(cfg, seed=1, device=dev)
    rng = np.random.default_rng(5)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 512)),
                             dtype=torch.int32, device=dev)
    zero = torch.zeros((1,), dtype=torch.int32, device=dev)
    with torch.no_grad():
        before = flash_attention.launches
        lf, cf = forward_step(model, prompt,
                              dataclasses.replace(cfg, attn_impl="flash"),
                              init_cache(cfg, 1, 512, device=dev), zero)
        flash_used = flash_attention.launches - before
        lx, cx = forward_step(model, prompt,
                              dataclasses.replace(cfg, attn_impl="xla"),
                              init_cache(cfg, 1, 512, device=dev), zero)
    torch.cuda.synchronize()
    logits_err = float((lf - lx).abs().max())
    cache_err = float(max((cf[n] - cx[n]).abs().max() for n in ("k", "v")))
    finite = bool(torch.isfinite(lf).all())

    plan = ExecutionPlan.from_kwargs(max_batch=4, decode_buckets="256,512")
    eos = (128001, 128009)
    reqs = _requests(10, cfg.vocab_size, seed=99, new=(8, 32))
    engine = BatchEngine(model, cfg, plan=plan, eos_ids=eos, device=dev)
    comps = engine.run_until_drained(reqs)
    mismatched = []
    for r, c in zip(reqs, comps):
        buf, plen = form_prompt_buffer(r.token_ids, c.bucket)
        ref = greedy_generate_cached(
            model, buf, [plen], cfg, max_new_tokens=r.max_new_tokens,
            eos_ids=eos, device=dev)
        if not np.array_equal(ref[0].cpu().numpy(), c.tokens):
            mismatched.append(r.rid)
    stats = engine.stats()
    ok = (logits_err <= PARITY_LOGITS_TOL and finite and not mismatched
          and flash_used == cfg.n_layers and stats["refills"] >= 1)
    emit({"phase": "parity", "ok": ok, "dtype": "float32",
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "prefill_logits_max_abs_err": logits_err,
          "tol": PARITY_LOGITS_TOL, "prefill_cache_max_abs_err": cache_err,
          "flash_launches_in_prefill": flash_used,
          "engine_requests": len(comps), "refills": stats["refills"],
          "buckets": sorted({c.bucket for c in comps}),
          "token_identical_to_sequential": not mismatched,
          "mismatched": mismatched})
    if not ok:
        raise SystemExit("parity phase failed")


# ---------------------------------------------------------------------------
# phases 5b / 5c: multi-tenant and speculative serving
# ---------------------------------------------------------------------------

# ray-jobs/fine_tune_config.json's adapters: r 64, alpha 16, the seven
# projections
TENANT_RANK = 64
TENANT_ALPHA = 16
TENANTS = ("t0", "t1", "t2")
# requests tagged in turn: the base model, then each tenant
TENANT_TAGS = (None,) + TENANTS
# tenant slots of the pool: fewer than the tenants, so a miss, an
# eviction and a pinned retry all happen
TENANT_SLOTS = 2
SPEC_K = 4
SUBRUN_REQUESTS = 8
# serve_tenants' depth cut of Llama-3.1-8B's 32 layers (full width)
SERVE_TENANT_LAYERS = 8


def _tenant_adapters(cfg, dev, seed, rank=TENANT_RANK, b_std=0.02):
    """One random fp32 adapter on the seven projections: A ~ N(0, 1/r) as
    ``train/lora.py::init_lora`` draws it, B ~ N(0, ``b_std``) instead of
    0, so that each tenant moves the output (at alpha / r = 0.25 the
    delta is about a quarter of a base projection's output)."""
    import torch
    from gke_ray_train_tpu_torch.models.transformer import proj_shapes
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    shapes = proj_shapes(cfg)
    out = []
    for _ in range(cfg.n_layers):
        layer = {}
        for t in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            d_in, d_out = shapes[t]
            layer[t] = {
                "a": torch.randn((d_in, rank), generator=gen, device=dev)
                / rank ** 0.5,
                "b": torch.randn((rank, d_out), generator=gen, device=dev)
                * b_std}
        out.append(layer)
    return out


def _counting_pool(template, **kw):
    """An ``AdapterPool`` whose ``acquire`` counts in ``pinned_refusals``
    the admissions it refused because every slot was pinned (the engine
    retries them next iteration)."""
    from gke_ray_train_tpu_torch.serve import AdapterPool, AdapterPoolPinned

    class CountingPool(AdapterPool):
        pinned_refusals = 0

        def acquire(self, adapter_id):
            try:
                return super().acquire(adapter_id)
            except AdapterPoolPinned:
                self.pinned_refusals += 1
                raise
    return CountingPool(template, **kw)


def _tagged(reqs, tags=TENANT_TAGS):
    return [dataclasses.replace(r, adapter_id=tags[i % len(tags)])
            for i, r in enumerate(reqs)]


def _serve_run(engine, reqs, dev):
    """Drain ``reqs`` through ``engine`` from launch counts at 0; returns
    (completions, wall seconds, flash launches, the engine's stats)."""
    import torch
    from gke_ray_train_tpu_torch.ops.flash_attention import flash_attention
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_launch_counts()
    t0 = time.perf_counter()
    comps = engine.run_until_drained(reqs)
    torch.cuda.synchronize(dev)
    return (comps, time.perf_counter() - t0, flash_attention.launches,
            engine.stats())


def _serve_numbers(comps, wall, stats, dev):
    import torch
    gen = sum(c.length - c.prompt_len for c in comps)
    ttft = sorted(c.first_token_s for c in comps)
    return {"requests": len(comps), "generated_tokens": int(gen),
            "wall_s": wall, "tokens_per_s": gen / wall,
            "ttft_p50_s": ttft[len(ttft) // 2], "ttft_max_s": ttft[-1],
            "token_latency_p50_s": stats["p50_token_latency_s"],
            "token_latency_p99_s": stats["p99_token_latency_s"],
            "batch_occupancy": stats["batch_occupancy"],
            "iterations": stats["iterations"], "prefills": stats["prefills"],
            "peak_mem_bytes": torch.cuda.max_memory_allocated(dev)}


def _completion_problems(reqs, comps, vocab):
    problems = []
    if len(comps) != len(reqs):
        problems.append(f"{len(comps)} of {len(reqs)} completed")
    for r, c in zip(reqs, comps):
        g = c.generated
        if not (1 <= len(g) <= r.max_new_tokens):
            problems.append(f"{r.rid}: {len(g)} tokens generated")
        if len(g) and (g.min() < 0 or g.max() >= vocab):
            problems.append(f"{r.rid}: token out of vocab")
        if c.adapter_id != r.adapter_id:
            problems.append(f"{r.rid}: served as {c.adapter_id}")
    return problems


def _module_nbytes(module):
    """Bytes of a model's parameters and buffers (a QTensor's codes and
    scales are buffers)."""
    return sum(t.numel() * t.element_size()
               for t in itertools.chain(module.parameters(),
                                        module.buffers()))


def phase_serve_tenants(dev, cfg=None):
    """Llama-3.1-8B at full width and ``SERVE_TENANT_LAYERS`` deep (bf16,
    random weights from seed 0, ``max_seq_len`` 512) through
    ``BatchEngine`` with an ``AdapterPool`` of ``TENANT_SLOTS`` slots and
    a loader over three random r-64 tenants on the seven projections
    (alpha 16): the serve phase's 24 requests (seed 1234), tagged in
    turn None, t0, t1, t2. Gates: every request completes within its
    budget and the vocab; a miss, an eviction and a pinned retry happen;
    the flash forward runs once per layer per prefill; the None-tagged
    completions are bitwise a no-pool engine's. Printed: t0's rows' token
    agreement with a single ``lora=`` engine (bf16 bmm against a 2-D
    product rounds apart), and, with the pool and tenants released, two
    sub-runs on
    ``SUBRUN_REQUESTS`` requests beside a plain one: ``SPEC_DRAFT=self``
    (``SPEC_K`` 4: acceptance share, tokens/s) and ``SERVE_QUANT=nf4``
    (the quantized base's bytes, tokens/s, peak memory, with the bf16
    model released first). Returns the flash launches of the main run."""
    import torch
    from gke_ray_train_tpu_torch.models import init_params, llama3_8b
    from gke_ray_train_tpu_torch.ops.quant import quantize_for_serving
    from gke_ray_train_tpu_torch.plan import ExecutionPlan
    from gke_ray_train_tpu_torch.serve import BatchEngine
    cfg = cfg or dataclasses.replace(
        llama3_8b(param_dtype="bfloat16", dtype="bfloat16", remat=False),
        max_seq_len=512, n_layers=SERVE_TENANT_LAYERS)
    model = init_params(cfg, seed=0, device=dev)
    tenants = {t: _tenant_adapters(cfg, dev, seed=100 + i)
               for i, t in enumerate(TENANTS)}
    env = {"MAX_BATCH": "8", "DECODE_BUCKETS": "256,512",
           "MAX_ADAPTERS": str(TENANT_SLOTS)}
    plan = ExecutionPlan.resolve(env=env)
    eos = (128001, 128009)
    scale = TENANT_ALPHA / TENANT_RANK
    pool = _counting_pool(tenants["t0"], max_adapters=plan.max_adapters,
                         loader=tenants.__getitem__)
    engine = BatchEngine(model, cfg, plan=plan, eos_ids=eos, adapters=pool,
                         lora_scale=scale, device=dev)
    engine.warm_up()
    reqs = _tagged(_requests(24, cfg.vocab_size, seed=1234))
    comps, wall, launches, stats = _serve_run(engine, reqs, dev)
    main = _serve_numbers(comps, wall, stats, dev)
    problems = _completion_problems(reqs, comps, cfg.vocab_size)
    pinned_retries = pool.pinned_refusals
    if stats["adapter_misses"] < 1 or stats["adapter_evictions"] < 1 \
            or pinned_retries < 1:
        problems.append(
            f"misses {stats['adapter_misses']}, evictions "
            f"{stats['adapter_evictions']}, pinned retries "
            f"{pinned_retries}: want each >= 1")
    if launches != cfg.n_layers * stats["prefills"] or \
            stats["prefills"] != len(reqs):
        problems.append(f"flash launches {launches} != n_layers "
                        f"{cfg.n_layers} x prefills {stats['prefills']}")
    del engine

    # the zero slot: bitwise a no-pool engine's completions
    base_reqs = [r for r in reqs if r.adapter_id is None]
    plain = BatchEngine(model, cfg, plan=plan, eos_ids=eos, device=dev)
    want = plain.run_until_drained(
        [dataclasses.replace(r, rid=r.rid + "p") for r in base_reqs])
    del plain
    got = {c.rid: c for c in comps}
    zero_differ = [r.rid for r, w in zip(base_reqs, want)
                   if not np.array_equal(got[r.rid].tokens, w.tokens)]
    if zero_differ:
        problems.append(f"zero-slot rows differ from the no-pool engine: "
                        f"{zero_differ}")

    # one tenant's rows against a single-adapter engine (not gated)
    agree = {}
    for t in TENANTS[:1]:
        rs = [r for r in reqs if r.adapter_id == t]
        single = BatchEngine(model, cfg, plan=plan, eos_ids=eos,
                             lora=tenants[t], lora_scale=scale, device=dev)
        ws = single.run_until_drained([dataclasses.replace(
            r, rid=r.rid + "s", adapter_id=None) for r in rs])
        del single
        same = total = 0
        for r, w in zip(rs, ws):
            a, b = got[r.rid].generated, w.generated
            n = min(len(a), len(b))
            same += int(np.sum(a[:n] == b[:n]))
            total += max(len(a), len(b))
        agree[t] = {"requests": len(rs), "tokens_equal": same,
                    "tokens": total,
                    "identical_requests": sum(
                        np.array_equal(got[r.rid].tokens, w.tokens)
                        for r, w in zip(rs, ws))}

    pool_bytes = pool.nbytes()
    del pool, tenants
    torch.cuda.empty_cache()

    # sub-runs on the first SUBRUN_REQUESTS requests, untagged
    sub = [dataclasses.replace(r, adapter_id=None)
           for r in reqs[:SUBRUN_REQUESTS]]
    plain = BatchEngine(model, cfg, plan=plan, eos_ids=eos, device=dev)
    plain.warm_up()
    pc, pwall, _, pstats = _serve_run(plain, [
        dataclasses.replace(r, rid=r.rid + "b") for r in sub], dev)
    plain_numbers = _serve_numbers(pc, pwall, pstats, dev)
    del plain
    spec_plan = ExecutionPlan.resolve(env=dict(
        env, SPEC_DRAFT="self", SPEC_K=str(SPEC_K)))
    spec = BatchEngine(model, cfg, plan=spec_plan, eos_ids=eos, device=dev)
    spec.warm_up()
    sc, swall, slaunch, sstats = _serve_run(spec, [
        dataclasses.replace(r, rid=r.rid + "x") for r in sub], dev)
    del spec
    problems += [f"spec {p}" for p in _completion_problems(
        sub, sc, cfg.vocab_size)]
    spec_numbers = dict(
        _serve_numbers(sc, swall, sstats, dev),
        spec_k=SPEC_K, spec_proposed=sstats["spec_proposed"],
        spec_accepted=sstats["spec_accepted"],
        acceptance_share=(sstats["spec_accepted"]
                          / max(sstats["spec_proposed"], 1)),
        flash_launches=slaunch,
        tokens_equal_to_plain=sum(
            np.array_equal(a.tokens, b.tokens) for a, b in zip(sc, pc)))
    # the target's prefill and the self draft's: 2 x n_layers each
    if slaunch != 2 * cfg.n_layers * sstats["prefills"]:
        problems.append(f"spec flash launches {slaunch} != 2 x n_layers x "
                        f"prefills {sstats['prefills']}")

    bf16_bytes = _module_nbytes(model)
    nf4 = quantize_for_serving(model, "nf4")
    del model           # the bf16 projections go; embed / norms are shared
    torch.cuda.empty_cache()
    nf4_plan = ExecutionPlan.resolve(env=dict(env, SERVE_QUANT="nf4"))
    qeng = BatchEngine(nf4, cfg, plan=nf4_plan, eos_ids=eos, device=dev)
    qeng.warm_up()
    qc, qwall, _, qstats = _serve_run(qeng, [
        dataclasses.replace(r, rid=r.rid + "q") for r in sub], dev)
    problems += [f"nf4 {p}" for p in _completion_problems(
        sub, qc, cfg.vocab_size)]
    nf4_numbers = dict(_serve_numbers(qc, qwall, qstats, dev),
                       base_bytes=_module_nbytes(qeng.params),
                       bf16_base_bytes=bf16_bytes,
                       tokens_equal_to_bf16=sum(
                           np.array_equal(a.tokens, b.tokens)
                           for a, b in zip(qc, pc)))
    del qeng, nf4
    torch.cuda.empty_cache()

    row = {"phase": "serve_tenants", "ok": not problems,
           "problems": problems, "nvidia_smi": nvidia_smi_line(),
           "model": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "dtype": cfg.dtype,
           "tenants": len(TENANTS), "rank": TENANT_RANK,
           "alpha": TENANT_ALPHA, "max_adapters": plan.max_adapters,
           "pool_bytes": pool_bytes, **main,
           "flash_launches": launches,
           "adapter_counters": {k: stats[k] for k in (
               "adapter_hits", "adapter_misses", "adapter_evictions",
               "adapter_resident")},
           "pinned_retries": pinned_retries,
           "zero_slot_bitwise": not zero_differ,
           "tenant_agreement_with_single_lora": agree,
           "subrun_plain": plain_numbers, "subrun_spec_self": spec_numbers,
           "subrun_nf4": nf4_numbers}
    emit(row)
    if problems:
        raise SystemExit("serve_tenants phase failed: " + "; ".join(problems))
    return launches


def phase_serve_tenants_parity(dev, cfg=None):
    """float32, Llama-3.1-8B at full width cut to 4 layers, TF32 off:
    token equality with the sequential oracles (``greedy_generate_cached``
    per request) for the mixed-tenant pooled batch (each tagged request
    with its tenant's adapter, the None rows with none; a pool of
    ``TENANT_SLOTS`` slots and a loader), the ``self`` draft and a
    2-layer random ``distilled`` draft (the garbage draft), speculation
    composed with the pool, and ``SERVE_QUANT=nf4`` against the oracle on
    the quantized model."""
    import torch
    from gke_ray_train_tpu_torch.models import (
        greedy_generate_cached, init_params, llama3_8b)
    from gke_ray_train_tpu_torch.ops.quant import quantize_for_serving
    from gke_ray_train_tpu_torch.plan import ExecutionPlan
    from gke_ray_train_tpu_torch.serve import BatchEngine, form_prompt_buffer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg or dataclasses.replace(
        llama3_8b(dtype="float32", param_dtype="float32", remat=False),
        max_seq_len=512, n_layers=4)
    model = init_params(cfg, seed=1, device=dev)
    tenants = {t: _tenant_adapters(cfg, dev, seed=200 + i)
               for i, t in enumerate(TENANTS)}
    scale = TENANT_ALPHA / TENANT_RANK
    eos = (128001, 128009)
    env = {"MAX_BATCH": "4", "DECODE_BUCKETS": "256,512",
           "MAX_ADAPTERS": str(TENANT_SLOTS)}
    reqs = _tagged(_requests(12, cfg.vocab_size, seed=77, new=(8, 32)))

    memo = {}

    def oracle(kind, r, width):
        """The sequential greedy decode of ``r`` at its engine's bucket
        ``width``: on the base ("base"), with its tenant ("tuned"), or on
        the quantized model ("nf4")."""
        key = (kind, r.rid, width)
        if key not in memo:
            params = qmodel if kind == "nf4" else model
            lora = (tenants[r.adapter_id] if kind == "tuned"
                    and r.adapter_id else None)
            buf, plen = form_prompt_buffer(r.token_ids, width)
            memo[key] = greedy_generate_cached(
                params, buf, [plen], cfg, max_new_tokens=r.max_new_tokens,
                eos_ids=eos, lora=lora, lora_scale=scale if lora else 1.0,
                device=dev)[0].cpu().numpy()
        return memo[key]

    def run(name, kind, plan_env, rs, params=None, **kw):
        eng = BatchEngine(params if params is not None else model, cfg,
                          plan=ExecutionPlan.resolve(env=plan_env),
                          eos_ids=eos, device=dev, **kw)
        comps = eng.run_until_drained(rs)
        st = eng.stats()
        results[name] = {
            "differ": [c.rid for r, c in zip(rs, comps)
                       if not np.array_equal(
                           c.tokens, oracle(kind, r, c.bucket))],
            "buckets": sorted({c.bucket for c in comps})}
        for k in ("spec_accepted", "spec_proposed", "adapter_misses",
                  "adapter_evictions"):
            if k in st:
                results[name][k] = st[k]

    def pool():
        return _counting_pool(tenants["t0"], max_adapters=TENANT_SLOTS,
                             loader=tenants.__getitem__)
    results = {}
    qmodel = None
    spec_env = dict(env, SPEC_DRAFT="self", SPEC_K=str(SPEC_K))
    untagged = [dataclasses.replace(r, adapter_id=None) for r in reqs]
    run("mixed_tenants", "tuned", env, reqs, adapters=pool(),
        lora_scale=scale)
    run("spec_self", "base", spec_env, untagged)
    dcfg = dataclasses.replace(cfg, n_layers=2)
    draft = init_params(dcfg, seed=7, device=dev)
    run("spec_garbage_draft", "base",
        dict(env, SPEC_DRAFT="distilled", SPEC_K=str(SPEC_K)), untagged,
        draft=(draft, dcfg))
    del draft
    run("spec_with_adapters", "tuned", spec_env, reqs, adapters=pool(),
        lora_scale=scale)
    qmodel = quantize_for_serving(model, "nf4")
    run("nf4", "nf4", dict(env, SERVE_QUANT="nf4"), untagged[:6],
        params=qmodel)
    del qmodel, model, tenants, memo
    torch.cuda.empty_cache()
    problems = [f"{k}: {v['differ']}" for k, v in results.items()
                if v["differ"]]
    mixed = results["mixed_tenants"]
    if mixed["adapter_misses"] < 1 or mixed["adapter_evictions"] < 1:
        problems.append(f"mixed-tenant run counters {mixed}")
    garbage = results["spec_garbage_draft"]
    if garbage["spec_accepted"] >= garbage["spec_proposed"]:
        problems.append("the garbage draft was never rejected")
    emit({"phase": "serve_tenants_parity", "ok": not problems,
          "problems": problems, "dtype": "float32", "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "requests": len(reqs), "results": results})
    if problems:
        raise SystemExit("serve_tenants_parity phase failed: "
                         + "; ".join(problems))


# ---------------------------------------------------------------------------
# phase 6: train
# ---------------------------------------------------------------------------

FINE_TUNE_CONFIG = os.path.join(HERE, "ray-jobs", "fine_tune_config.json")
GEMMA2_CONFIG = os.path.join(HERE, "ray-jobs",
                             "fine_tune_config_gemma2_4k.json")


def _sft_batch(n_rows, seq, vocab, rng):
    """Random SFT rows, not packed: each row a real length in
    [seq / 4, seq] of random token ids, then a padding tail of weight 0;
    targets are the inputs shifted by one."""
    toks = rng.integers(0, vocab, (n_rows, seq + 1)).astype(np.int32)
    weights = np.zeros((n_rows, seq), np.float32)
    for i, n in enumerate(rng.integers(seq // 4, seq + 1, n_rows)):
        weights[i, :n] = 1.0
        toks[i, n + 1:] = 0
    return {"inputs": toks[:, :-1], "targets": toks[:, 1:],
            "weights": weights}


def _packed_batch(n_rows, seq, vocab, rng):
    """``n_rows`` packed rows (``data/packing.py``) of random documents:
    lengths uniform over 64-1,024 tokens, random ids, the first quarter
    of each a prompt of loss weight 0. A stand-in mix: no length or
    prompt-share statistic of the Gemma-2 job's dataset (tatsu-lab/alpaca
    under the Gemma tokenizer) is in the repository, and the mix sets
    how many documents share a row, so the share of attention tiles that
    are live."""
    from gke_ray_train_tpu_torch.data import pack_examples

    def docs():
        while True:
            n = int(rng.integers(64, 1025))
            w = np.ones(n, np.float32)
            w[:n // 4] = 0.0
            yield {"input_ids": rng.integers(0, vocab, n).astype(np.int32),
                   "loss_weights": w}
    rows = []
    for row in pack_examples(docs(), seq):
        rows.append(row)
        if len(rows) == n_rows:
            return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


def _counted():
    """{kernel name: its wrapper, which counts its launches}."""
    from gke_ray_train_tpu_torch.ops.flash_attention import (
        flash_attention, flash_bwd_dkv, flash_bwd_dq)
    from gke_ray_train_tpu_torch.ops.fused_ce import (
        fused_ce_dhead, fused_ce_dx, fused_ce_row_stats)
    from gke_ray_train_tpu_torch.ops.fused_norm_rope import (
        fused_rmsnorm, fused_rmsnorm_rope, fused_rope_qk)
    return {"flash_fwd": flash_attention, "flash_bwd_dq": flash_bwd_dq,
            "flash_bwd_dkv": flash_bwd_dkv, "fused_rmsnorm": fused_rmsnorm,
            "fused_rope_qk": fused_rope_qk,
            "fused_rmsnorm_rope": fused_rmsnorm_rope,
            "fused_ce_row_stats": fused_ce_row_stats,
            "fused_ce_dx": fused_ce_dx, "fused_ce_dhead": fused_ce_dhead}


def _launch_counts():
    return {name: fn.launches for name, fn in _counted().items()}


# the kernels that count launches per body: the cross-entropy entries
# (``ops/fused_ce.py::ROUTES``) and the rms_norm
# (``ops/fused_norm_rope.py::NORM_ROUTES``)
_ROUTED = ("fused_ce_row_stats", "fused_ce_dx", "fused_ce_dhead",
           "fused_rmsnorm")


def _route_counts():
    """{routed kernel: {route: launches}}."""
    counted = _counted()
    return {name: dict(counted[name].routes) for name in _ROUTED}


def _reset_launch_counts():
    for name, fn in _counted().items():
        fn.launches = 0
        if name in _ROUTED:
            fn.routes = dict.fromkeys(fn.routes, 0)


def _expected_routes(cfg, launches):
    """The route counts of the routed kernels' ``launches`` on ``cfg``'s
    model: every cross-entropy launch on the body ``grad_route`` picks for
    its dtype, d_model and vocab, every rms_norm launch on the body
    ``norm_route`` picks for its dtype and d_model (the train step's
    operands are fresh, aligned allocations): at the shipped widths, the
    registers body."""
    import torch
    from gke_ray_train_tpu_torch.ops.fused_ce import ROUTES, grad_route
    from gke_ray_train_tpu_torch.ops.fused_norm_rope import (
        NORM_ROUTES, norm_route)
    dtype = getattr(torch, cfg.dtype)
    picked = {"fused_rmsnorm": (norm_route(dtype, cfg.d_model), NORM_ROUTES)}
    ce = grad_route(dtype, cfg.d_model, cfg.vocab_size)
    out = {}
    for name in _ROUTED:
        route, routes = picked.get(name, (ce, ROUTES))
        out[name] = {r: launches[name] if r == route else 0 for r in routes}
    return out


# the eval of the Llama train phases, cut from the job's NUM_EVAL_SAMPLES
# 200 and EVAL_STEPS_SFT 50 so that it runs twice in 1 + 5 steps
EVAL_ROWS = 16
EVAL_EVERY = 3
# the train phases' loop runs under TRANSFER_GUARD=disallow: a wait on
# the card in the hot loop outside the loop's allow-list raises
TRAIN_GUARD = "disallow"


def _sft_rows(ft, seq, split="train", n_eval=EVAL_ROWS):
    """The offline input of an unpacked job (ray-jobs/
    fine_tune_llama_ray.py:207-255 where the hub is unreachable): gretel-
    shaped synthetic SQL rows (train: seed 0, NUM_TRAIN_SAMPLES of at
    least 64 drawn; eval: seed 1, ``n_eval`` of at least 16, as the
    job draws them), rendered by the fallback chat template and tokenized
    by bytes (``ByteTokenizer``) to ``seq + 1`` tokens, prompt weight 0,
    each padded to a row of ``seq``. Made once a (count, length, split)
    in a run (~3 s for the job's 1,000 rows) and handed out as copies."""
    n, least, seed = ((int(ft["NUM_TRAIN_SAMPLES"]), 64, 0)
                      if split == "train" else (n_eval, 16, 1))
    return {k: v.copy() for k, v in _sft_rows_made(n, least, seed,
                                                    seq).items()}


@functools.lru_cache(maxsize=None)
def _sft_rows_made(n, least, seed, seq):
    from gke_ray_train_tpu_torch.data import (
        ByteTokenizer, downsample, format_gretel_sql_example, pad_sft_rows,
        synthetic_sql_rows, tokenize_sft_example)
    rows = downsample(synthetic_sql_rows(max(n, least), seed=seed), n)
    tok = ByteTokenizer()
    return pad_sft_rows([tokenize_sft_example(
        tok, format_gretel_sql_example(r), max_len=seq + 1) for r in rows],
        seq)


def _fine_tune_setup(dev, cfg, n_batches, config=None, *, mesh=None,
                     optim="adamw", params=None, ft_over=None,
                     **plan_overrides):
    """The QLoRA job of ``config`` (default ray-jobs/fine_tune_config.json)
    at ``cfg`` (default the job's MODEL_ID preset, bf16, remat): NF4 base
    from seed 0, adapters, optimizer and schedule, the step function with
    the job's plan and ``plan_overrides``, and ``n_batches`` numpy
    batches (``batches``), which ``run_training`` places on the card
    (``place``: ``make_place_batch(dev)``, pinned copies on a side
    stream) through the job's prefetcher (``plan.prefetch``, 2). An
    unpacked job (PACKING false) takes the job's offline input path,
    ``_sft_rows`` batched by ``sft_epoch_batches`` (epoch 0, seed 42, as
    the job shuffles); a packed job the stand-in mix of
    ``_packed_batch`` (numpy seed 1234).

    ``mesh``: the base is sharded as it is made and the state over the
    mesh (``parallel/``), the step and its placement run on it; ``optim``
    "adafactor" swaps AdamW for the job's ``OPTIM=adafactor`` chain;
    ``params``: a base already made (not rebuilt, not timed);
    ``ft_over``: keys that replace the job's (``LORA_DROPOUT``). A job
    with ``USE_QLORA`` false is full fine-tuning of a random base in
    ``cfg.param_dtype`` (no adapters), as the entry builds it."""
    import torch
    from gke_ray_train_tpu_torch.config import optimizer_from_config
    from gke_ray_train_tpu_torch.data import (
        make_place_batch, sft_epoch_batches)
    from gke_ray_train_tpu_torch.models import (
        init_quantized_params, preset_for_model_id)
    from gke_ray_train_tpu_torch.plan import ExecutionPlan
    from gke_ray_train_tpu_torch.train import (
        LoraConfig, make_train_state, make_train_step,
        warmup_cosine_schedule)
    with open(config or FINE_TUNE_CONFIG) as f:
        ft = dict(json.load(f), **(ft_over or {}))
    seq = int(ft["MAX_SEQ_LENGTH"])
    if cfg is None:
        cfg = dataclasses.replace(
            preset_for_model_id(ft["MODEL_ID"], dtype="bfloat16",
                                param_dtype="bfloat16", remat=True),
            max_seq_len=seq)
    plan = ExecutionPlan.resolve(config=ft, env={}, **plan_overrides)
    micro = int(ft["PER_DEVICE_TRAIN_BATCH_SIZE"])
    batch_rows = micro * plan.grad_accum
    # the job's length: NUM_TRAIN_SAMPLES over the global batch
    total = -(-int(ft["NUM_TRAIN_SAMPLES"]) // batch_rows)
    schedule = warmup_cosine_schedule(
        float(ft["LEARNING_RATE"]), total,
        warmup_frac=float(ft["WARMUP_RATIO"]))
    # the job's clip and decay (OPTIM adamw: make_optimizer's spec)
    spec = optimizer_from_config(dict(ft, OPTIM=optim), schedule)
    use_lora = bool(ft.get("USE_QLORA", True))
    lcfg = LoraConfig.from_dict(ft) if use_lora else None
    t0 = time.perf_counter()
    if params is None and use_lora:
        params = init_quantized_params(cfg, seed=0, kind=ft["QUANT_KIND"],
                                       device=dev, mesh=mesh)
    elif params is None:
        from gke_ray_train_tpu_torch.models import init_params
        params = init_params(cfg, seed=0, device=dev)
    state = make_train_state(cfg, spec, seed=0, lora_cfg=lcfg, params=params,
                             device=dev, mesh=mesh)
    step_fn = make_train_step(cfg, spec, lora_cfg=lcfg, schedule=schedule,
                              plan=plan, device=dev, mesh=mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    if ft.get("PACKING"):
        rng = np.random.default_rng(1234)
        batches = [_packed_batch(batch_rows, seq, cfg.vocab_size, rng)
                   for _ in range(n_batches)]
        input_path = "packed_stand_in"
    else:
        batches = list(itertools.islice(sft_epoch_batches(
            _sft_rows(ft, seq), batch_rows), n_batches))
        input_path = "offline_sft"
    return dict(cfg=cfg, ft=ft, plan=plan, lcfg=lcfg, micro=micro,
                batch_rows=batch_rows, seq=seq, state=state, step_fn=step_fn,
                batches=batches, place=make_place_batch(dev),
                input_path=input_path, init_s=init_s, mesh=mesh,
                spec=spec, base_bytes=_module_bytes(params))


def _module_bytes(module):
    """Bytes of a module's parameters and buffers (a QLoRA base: codes,
    scales and the full-precision rest); a sharded tensor counts its
    local shard."""
    from gke_ray_train_tpu_torch.parallel.sharding import local
    return sum(local(t).numel() * t.element_size()
               for t in itertools.chain(module.parameters(),
                                        module.buffers()))


def expected_launches(cfg, grad_accum: int, fused_ops: bool,
                      full_ft: bool = False, ring: int = 1) -> dict:
    """Kernel launches of one train step: under remat each block's
    forward runs twice (forward and recomputation), its backward once.
    Per layer and microbatch: flash forward once a forward, dQ and dK/dV
    once; with ``fused_ops`` the 2 (4 with post-block norms) rms_norms
    once a forward (their backward is plain torch) and the RoPE once a
    forward and once in the backward. Per microbatch, with ``fused_ops``
    on a config without a logit softcap: the cross-entropy's row
    statistics and dx once (each entry walks every vocab chunk), dhead
    once in full fine-tuning (the head is frozen under LoRA). The
    per-head rms_norm + RoPE never: no model family calls it. Under
    ring attention over ``ring`` context ranks each flash kernel runs
    once a visiting shard: ``ring`` times."""
    runs = 2 if cfg.remat else 1
    lm = cfg.n_layers * grad_accum
    norms = 4 if cfg.post_block_norm else 2
    ce = grad_accum if fused_ops and cfg.logit_softcap is None else 0
    return {"flash_fwd": runs * lm * ring, "flash_bwd_dq": lm * ring,
            "flash_bwd_dkv": lm * ring,
            "fused_rmsnorm": norms * runs * lm if fused_ops else 0,
            "fused_rope_qk": (runs + 1) * lm if fused_ops else 0,
            "fused_rmsnorm_rope": 0,
            "fused_ce_row_stats": ce, "fused_ce_dx": ce,
            "fused_ce_dhead": ce if full_ft else 0}


def _drive(dev, job, eval_rows=None, profiler=None):
    """The job's batches through the port's ``run_training``, as
    ray-jobs/fine_tune_llama_ray.py:401-430 calls it: epochs 1, prefetch
    ``plan.prefetch`` with ``job["place"]``, log_every 1, a
    ``ThroughputMeter(trainable="lora", n_devices=1)``, report_fn,
    heartbeat_fn, ``tb_writer=writer_from_config(ft, <tmp dir>)``, with
    ``eval_rows`` the job's ``sharded_eval_loss`` over the port's
    ``make_eval_step`` every ``EVAL_EVERY`` steps at host batch
    PER_DEVICE_TRAIN_BATCH_SIZE, ``guards=plan.runtime_guards()`` and
    ``profiler``.

    ``step_fn`` is wrapped in a timer that synchronizes before and after
    each call (the step time of earlier runs), reads the kernels' launch
    counts around it, and holds the delivered batch against its numpy
    batch; all three run inside ``allow_transfers()``. After the first
    (warm-up) call it sets the launch counters to 0 and resets the peak
    memory. Returns what the phase lines print."""
    import shutil
    import tempfile
    import torch
    from gke_ray_train_tpu_torch.analysis.guards import allow_transfers
    from gke_ray_train_tpu_torch.rayint import get_context
    from gke_ray_train_tpu_torch.train import (
        ThroughputMeter, make_eval_step, sharded_eval_loss)
    from gke_ray_train_tpu_torch.train.loop import run_training
    from gke_ray_train_tpu_torch.train.metrics import finish_ledger
    from gke_ray_train_tpu_torch.train.tb import writer_from_config
    cfg, ft, batches = job["cfg"], job["ft"], job["batches"]
    out = dict(step_s=[], metrics=[], placed_equal=[], reports=[],
               heartbeats=[], eval_s=[], eval_losses=[], eval_calls=0,
               step_launches=dict.fromkeys(_counted(), 0))

    def timed_step(state, batch):
        i = len(out["step_s"])
        with allow_transfers():
            torch.cuda.synchronize()
            before = _launch_counts()
            t = time.perf_counter()
            state, m = job["step_fn"](state, batch)
            torch.cuda.synchronize()
            out["step_s"].append(time.perf_counter() - t)
            after = _launch_counts()
            # the placement's round trip, outside the timed call
            out["placed_equal"].append(sorted(batch) == sorted(
                batches[i]) and all(np.array_equal(
                    np.asarray(v.cpu()) if hasattr(v, "cpu") else v,
                    batches[i][k]) for k, v in batch.items()))
        out["metrics"].append(m)
        if i == 0:
            _reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
        else:
            for k, n in after.items():
                out["step_launches"][k] += n - before[k]
        return state, m

    eval_fn = None
    if eval_rows is not None:
        eval_step = make_eval_step(cfg, lora_cfg=job["lcfg"], device=dev,
                                   mesh=job.get("mesh"))

        def counted_eval(st, b):
            out["eval_calls"] += 1
            return eval_step(st, b)

        def eval_fn(st):
            t = time.perf_counter()
            loss = sharded_eval_loss(st, counted_eval, eval_rows,
                                     host_batch=job["micro"],
                                     place_batch=job["place"])
            out["eval_s"].append(time.perf_counter() - t)
            out["eval_losses"].append(loss)
            return {"eval_loss": loss}
    tb_dir = tempfile.mkdtemp(prefix="chip_smoke_tb_")
    tb = writer_from_config(ft, tb_dir)
    meter = ThroughputMeter(cfg, seq_len=job["seq"], n_devices=1,
                            trainable="lora", device=dev)
    try:
        t0 = time.perf_counter()
        state, last = run_training(
            job["state"], timed_step, lambda epoch: iter(batches), epochs=1,
            log_every=1, meter=meter, report_fn=out["reports"].append,
            eval_fn=eval_fn, eval_every=EVAL_EVERY if eval_fn else None,
            place_batch=job["place"], prefetch=job["plan"].prefetch,
            profiler=profiler, tb_writer=tb,
            heartbeat_fn=lambda s, done=False: out["heartbeats"].append(
                (s, done)),
            guards=job["plan"].runtime_guards())
        out["wall_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tb_dir, ignore_errors=True)
    out["launches"] = _launch_counts()
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    out["ledger"] = finish_ledger(get_context().goodput, out["wall_s"])
    out["metrics"] = [{k: float(v) for k, v in m.items()}
                      for m in out["metrics"]]
    out.update(state=state, last=last, tb_backend=tb and tb.backend,
               tb_scalars=tb.scalars if tb else 0)
    return out


def phase_train(dev, cfg=None, steps: int = 5, config=None,
                phase: str = "train", guard=TRAIN_GUARD,
                n_eval: int = EVAL_ROWS, **plan_overrides):
    """QLoRA fine-tune steps at full width and depth with the settings of
    a job config, through the port's ``run_training`` (``_drive``); by
    default Llama-3.1-8B with ray-jobs/fine_tune_config.json: NF4 base,
    LoRA r 64 / alpha 16 / dropout 0.1 on all projections, microbatch 2
    x grad-accum 4 at 1024 tokens, AdamW (lr 2e-4, wd 0.001) with
    warmup-cosine and clip 0.3, on the job's offline input path
    (``_fine_tune_setup``), with eval (``n_eval`` held-out rows every
    ``EVAL_EVERY`` steps); a packed job (Gemma-2) runs without eval. One
    warm-up step, then ``steps`` timed ones; the step launch counts, the
    routes of the cross-entropy's and the rms_norm's launches and the
    input wait (the ledger's ``data_stall_s``) cover the timed steps;
    every delivered batch must equal its numpy batch; the eval passes
    launch the flash forward once a layer, nothing else; the goodput
    ledger's terms sum to the loop's wall within 1 ms; with ``guard``
    the loop runs under that TRANSFER_GUARD mode. On an MoE model
    (Mixtral) every ``moe_mlp`` call of the run is read by ``_MoeProbe``
    (router aux, dropped assignments), the router and expert banks must
    stay as they were, and the line adds the base's bytes on the card."""
    import torch
    from gke_ray_train_tpu_torch.train import (
        peak_flops_per_device, train_flops_per_token)
    from gke_ray_train_tpu_torch.train.metrics import LEDGER_TERMS
    job = _fine_tune_setup(dev, cfg, steps + 1, config,
                           transfer_guard=guard, **plan_overrides)
    cfg, ft, plan, lcfg = job["cfg"], job["ft"], job["plan"], job["lcfg"]
    micro, batch_rows, seq = job["micro"], job["batch_rows"], job["seq"]
    packed = bool(ft.get("PACKING"))
    watch = job["state"].lora[0]["wq"]["b"]
    before = watch.detach().clone()
    eval_rows = None if packed else _sft_rows(ft, seq, split="eval",
                                              n_eval=n_eval)
    moe = cfg.n_experts > 0
    frozen = {}
    if moe:
        # the base must not move: every router, and one bank's codes
        blocks = job["state"].params.blocks
        frozen = {f"blocks.{i}.router": (b.router, b.router.detach().clone())
                  for i, b in enumerate(blocks)}
        frozen["blocks.0.w_gate.codes"] = (
            blocks[0].w_gate.codes, blocks[0].w_gate.codes.clone())
    with _MoeProbe(dev, enabled=moe) as probe:
        run = _drive(dev, job, eval_rows=eval_rows)
    state = run.pop("state")
    init_s, input_path = job["init_s"], job["input_path"]
    base_bytes = job["base_bytes"]
    del job
    rows, times = run["metrics"], run["step_s"][1:]
    warm_s = run["step_s"][0]
    for i, (m, dt) in enumerate(zip(rows, run["step_s"])):
        emit({"phase": f"{phase}_step", "step": i, "warmup": i == 0,
              "seconds": dt, **m})
    launches = run["step_launches"]
    routes = _route_counts()
    per_step = {k: v / steps for k, v in launches.items()}
    want = expected_launches(cfg, plan.grad_accum, plan.fused_ops)
    eval_launches = {k: run["launches"][k] - launches[k] for k in launches}
    want_eval = {k: cfg.n_layers * run["eval_calls"]
                 if k == "flash_fwd" else 0 for k in launches}
    p50 = sorted(times)[len(times) // 2]
    tokens = batch_rows * seq
    name = torch.cuda.get_device_name(dev)
    flops_tok = train_flops_per_token(cfg, seq, trainable="lora")
    last, led = run["last"], run["ledger"]
    ledger_sum = sum(led[t] for t in LEDGER_TERMS)
    problems = []
    if not all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in rows):
        problems.append("non-finite loss or grad_norm")
    if per_step != want:
        problems.append(f"launches per step {per_step} != {want}")
    if routes != _expected_routes(cfg, launches):
        problems.append(f"routes {routes} != "
                        f"{_expected_routes(cfg, launches)}")
    if eval_launches != want_eval:
        problems.append(f"eval launches {eval_launches} != {want_eval}")
    if torch.equal(before, watch.detach()):
        problems.append("the adapters did not change")
    moved = [k for k, (t, t0) in frozen.items() if not torch.equal(t, t0)]
    if moved:
        problems.append(f"the frozen base moved: {moved}")
    del frozen
    routing = probe.read() if moe else None
    if moe and not np.isfinite(routing["router_aux_mean"]):
        problems.append(f"router aux {routing['router_aux_mean']}")
    if not all(run["placed_equal"]):
        problems.append(f"delivered batches differ from their numpy "
                        f"batches: {run['placed_equal']}")
    if eval_rows is not None and not (
            len(run["eval_losses"]) == (steps + 1) // EVAL_EVERY
            and np.all(np.isfinite(run["eval_losses"]))):
        problems.append(f"eval losses {run['eval_losses']}, "
                        f"{(steps + 1) // EVAL_EVERY} passes expected")
    if abs(ledger_sum - run["wall_s"]) > 1e-3:
        problems.append(f"ledger terms sum to {ledger_sum} s, the loop's "
                        f"wall is {run['wall_s']} s")
    if run["heartbeats"] != [(i, False) for i in range(1, steps + 2)] + [
            (steps + 1, True)]:
        problems.append(f"heartbeats {run['heartbeats']}")
    if [r["step"] for r in run["reports"]] != [steps + 1]:
        problems.append(f"reports {run['reports']}")
    real = float(np.median([r["tokens"] for r in rows[1:]]))
    row = {"phase": phase, "ok": not problems, "problems": problems,
           "nvidia_smi": nvidia_smi_line(),
           "model": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "params": cfg.param_count(), "dtype": cfg.dtype,
           "fused_ops": plan.fused_ops, "packed": packed,
           "quant": ft["QUANT_KIND"], "lora_r": lcfg.r,
           "lora_alpha": lcfg.alpha, "lora_dropout": lcfg.dropout,
           "trainable_params": sum(
               t.numel() for layer in state.lora for ab in layer.values()
               for t in ab.values()),
           "microbatch": micro, "grad_accum": plan.grad_accum, "seq": seq,
           "loop": "train/loop.py::run_training",
           "transfer_guard": plan.transfer_guard or "off",
           "init_s": init_s,
           "warmup_step_s": warm_s, "steps": steps,
           "step_s": times, "step_s_p50": p50,
           "tokens_per_s": tokens / p50,
           "real_tokens_per_s": real / p50,
           "real_token_share": real / tokens,
           "mfu": tokens / p50 * flops_tok / peak_flops_per_device(name),
           # the loop's meter: its window starts at the first trained
           # batch, so it holds the warm-up step that the p50 leaves out
           "meter": {k: last[k] for k in (
               "tokens_per_sec_per_chip", "mfu", "data_stall_frac",
               "tokens_per_sec_per_chip_incl_stalls", "mfu_incl_stalls")},
           # eager PyTorch: the first step's wall time (kernel libraries
           # loaded, cuBLAS and the allocator warmed; no trace, no compile)
           "compile_s": last["compile_s"],
           "restart_to_first_step_s": last["restart_to_first_step_s"],
           "eval": ({"rows": n_eval, "every": EVAL_EVERY,
                     "cut_from": {"NUM_EVAL_SAMPLES":
                                  ft.get("NUM_EVAL_SAMPLES"),
                                  "EVAL_STEPS_SFT":
                                  ft.get("EVAL_STEPS_SFT")},
                     "host_batch": micro, "passes": len(run["eval_s"]),
                     "eval_step_calls": run["eval_calls"],
                     "eval_loss": run["eval_losses"],
                     "pause_s": run["eval_s"],
                     "ledger_eval_ckpt_stall_s": led["eval_ckpt_stall_s"]}
                    if eval_rows is not None else
                    "none: the packed stand-in job runs without eval"),
           "goodput_ledger": led, "ledger_sum_s": ledger_sum,
           "loop_wall_s": run["wall_s"],
           "tensorboard": {"backend": run["tb_backend"],
                           "scalars": run["tb_scalars"]},
           "input": input_path, "prefetch_depth": plan.prefetch,
           "consume_wait_s": led["data_stall_s"],
           "placed_batches_equal": run["placed_equal"],
           "train_flops_per_token": flops_tok,
           "peak_mem_bytes": run["peak_mem_bytes"],
           "base_bytes": base_bytes,
           "launches": launches, "launches_per_step": per_step,
           "eval_launches": eval_launches, "routes": routes,
           "losses": [r["loss"] for r in rows],
           "grad_norms": [r["grad_norm"] for r in rows]}
    if moe:
        from gke_ray_train_tpu_torch.ops.moe import expert_capacity
        row.update(active_params=cfg.active_param_count(),
                   experts=cfg.n_experts, top_k=cfg.expert_top_k,
                   capacity_factor=cfg.capacity_factor,
                   capacity=expert_capacity(cfg, seq),
                   quant_store=os.environ.get("QUANT_STORE", "int8"),
                   routing=routing)
    emit(row)
    if problems:
        raise SystemExit(f"{phase} phase failed: " + "; ".join(problems))
    del state, run
    torch.cuda.empty_cache()
    # the launches of the kernels this path runs: the timed steps' and
    # the eval passes'
    return {k: launches[k] + eval_launches[k] for k in launches
            if want[k] or want_eval[k]}


def phase_train_fused(dev, cfg=None, steps: int = 2):
    """QLoRA steps of Gemma-2-9B at full width and depth (42 layers, d_model
    3,584, vocab 256,128, head dim 256) with the settings of
    ray-jobs/fine_tune_config_gemma2_4k.json plus FUSED_OPS=1: NF4 base,
    LoRA r 32 / alpha 16 / dropout 0.05, microbatch 1 x grad-accum 4 at
    4,096 tokens of packed documents, AdamW (lr 2e-4, wd 0.001),
    warmup-cosine, clip 0.3. The job's v5e-16 mesh becomes one card and
    its ATTN_IMPL a2a the flash kernels (``auto``)."""
    return phase_train(dev, cfg, steps, config=GEMMA2_CONFIG,
                       phase="train_fused", fused_ops=True)


def phase_train_profile(dev, cfg=None, config=None,
                        phase: str = "train_profile", **plan_overrides):
    """Where a QLoRA step's time goes: the train phase's job (or
    ``config``'s) for one warm-up and one traced step through
    ``run_training`` with the port's ``TraceProfiler`` (PROFILE_START_STEP
    1, PROFILE_NUM_STEPS 1). Reads the Chrome trace the profiler wrote:
    it must exist and hold the step's flash launches
    (``expected_launches``). Device busy share = summed kernel time in
    the trace over the traced step's wall time (one stream). On an MoE
    model the line adds the step's device time by MoE group
    (``_moe_groups``: dequantize, expert GEMMs, dispatch, flash)."""
    import shutil
    import tempfile
    import torch
    from gke_ray_train_tpu_torch.train.profiling import profiler_from_config
    job = _fine_tune_setup(dev, cfg, 2, config, **plan_overrides)
    cfg, plan = job["cfg"], job["plan"]
    trace_dir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        prof = profiler_from_config({"PROFILE": trace_dir,
                                     "PROFILE_START_STEP": 1,
                                     "PROFILE_NUM_STEPS": 1}, trace_dir)
        with _moe_ranges(enabled=cfg.n_experts > 0):
            run = _drive(dev, job, profiler=prof)
        del job, run["state"]
        path = prof.trace_path
        size = os.path.getsize(path) if path else 0
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    moe_groups = _moe_groups(events) if cfg.n_experts else None
    kern = [e for e in events if e.get("cat") == "kernel"]
    del events
    wall = run["step_s"][1]
    busy_us = sum(e.get("dur", 0) for e in kern)
    flash = {"flash_fwd": "flash_fwd", "flash_bwd_dq": "flash_bwd_dq",
             "flash_bwd_dkv": "flash_bwd_dkv"}
    in_trace = {k: sum(pat in e["name"] for e in kern)
                for k, pat in flash.items()}
    want = {k: v for k, v in expected_launches(
        cfg, plan.grad_accum, plan.fused_ops).items() if k in flash}
    groups = {"gemm": ("nvjet", "gemm", "cutlass", "sm90_xmma"),
              "flash_kernels": ("flash_fwd", "flash_bwd"),
              "fused_norm_rope": ("rmsnorm_kernel", "rmsnorm_reg_kernel",
                                  "rope_qk_kernel"),
              "fused_ce": ("row_stats_kernel", "merge_kernel",
                           "dlogits_kernel", "dx_kernel", "dhead_kernel",
                           "ce_wgmma_kernel"),
              "nf4_lookup": ("index_elementwise",)}
    by_group = {g: 0.0 for g in list(groups) + ["other"]}
    by_name = {}
    for e in kern:
        g = next((g for g, keys in groups.items()
                  if any(k in e["name"] for k in keys)), "other")
        by_group[g] += e.get("dur", 0) / 1e3
        ms, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (ms + e.get("dur", 0) / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]
    problems = []
    if busy_us <= 0:
        problems.append("the trace shows no device time")
    if in_trace != want:
        problems.append(f"flash launches in the trace {in_trace} != {want}")
    emit({"phase": phase, "ok": not problems, "problems": problems,
          "profiler": "train/profiling.py::TraceProfiler via run_training",
          "trace_bytes": size, "wall_s": wall,
          "device_busy_s": busy_us / 1e6,
          "device_busy_share": busy_us / 1e6 / wall,
          "kernel_launches": len(kern), "flash_launches": in_trace,
          "device_ms_by_group": by_group,
          **({"moe_device_ms_by_group": moe_groups} if moe_groups else {}),
          "top_kernels": [{"name": k[:90], "ms": ms, "calls": n}
                          for k, (ms, n) in top]})
    if problems:
        raise SystemExit(f"{phase} phase: " + "; ".join(problems))
    del run
    torch.cuda.empty_cache()


def phase_train_fused_profile(dev, cfg=None):
    """The profile of ``phase_train_profile`` over one step of the
    train_fused phase's job."""
    phase_train_profile(dev, cfg, GEMMA2_CONFIG, phase="train_fused_profile",
                        fused_ops=True)


# ---------------------------------------------------------------------------
# phase 7: train-parity
# ---------------------------------------------------------------------------

def _release():
    """Free what earlier runs left: a sharded model's FSDP2 hooks hold it
    in reference cycles, which only the collector breaks."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _train_run(cfg, mode, impl, dev, steps, batches, fused_ops=False,
               mesh=None, remat_policy=None, optim="adamw"):
    """``steps`` steps of full fine-tuning or QLoRA with attention
    through ``impl`` (and with ``fused_ops`` the fused rms_norm / RoPE
    kernels, and the fused cross-entropy where the config has no logit
    softcap); on ``mesh`` sharded over it, with ``remat_policy`` in
    place of the config's, and ``optim`` "adafactor" in place of AdamW
    (the config's clip-then-adafactor chain); returns the metric streams
    and {name: the change that trained tensor underwent} (a sharded
    tensor's whole)."""
    import torch
    from gke_ray_train_tpu_torch.models import init_params
    from gke_ray_train_tpu_torch.models import init_quantized_params
    from gke_ray_train_tpu_torch.plan import ExecutionPlan
    from gke_ray_train_tpu_torch.train import (
        LoraConfig, make_train_state, make_train_step,
        warmup_cosine_schedule)
    from gke_ray_train_tpu_torch.config import optimizer_from_config
    from gke_ray_train_tpu_torch.train.step import trainable_tensors
    cfg = dataclasses.replace(cfg, attn_impl=impl)
    if remat_policy is not None:
        cfg = dataclasses.replace(cfg, remat_policy=remat_policy)
    lcfg = LoraConfig(r=64, alpha=16) if mode == "qlora" else None
    params = (init_quantized_params(cfg, seed=3, device=dev)
              if mode == "qlora" else init_params(cfg, seed=3, device=dev))
    sched = warmup_cosine_schedule(2e-4, 10, warmup_frac=0.1)
    spec = optimizer_from_config(
        {"OPTIM": optim, "WEIGHT_DECAY": 0.001, "MAX_GRAD_NORM": 0.3}, sched)
    state = make_train_state(cfg, spec, seed=3, lora_cfg=lcfg,
                             params=params, device=dev, mesh=mesh)

    def whole(t):
        t = t.detach()
        return t.full_tensor() if hasattr(t, "full_tensor") else t
    start = {n: whole(t).clone() for n, t in
             trainable_tensors(state.params, state.lora)}
    fn = make_train_step(cfg, spec, lora_cfg=lcfg, schedule=sched,
                         plan=ExecutionPlan(grad_accum=2,
                                            fused_ops=fused_ops),
                         device=dev, mesh=mesh)
    streams = {"loss": [], "grad_norm": []}
    for b in batches[:steps]:
        state, m = fn(state, b)
        for k in streams:
            streams[k].append(float(m[k]))
    deltas = {n: whole(t) - start[n] for n, t in
              trainable_tensors(state.params, state.lora)}
    del state, params, start, fn
    _release()
    return streams, deltas


def _parity_runs(cfg, dev, steps, batches, kernel, plain,
                 rtol=TRAIN_PARITY_RTOL, delta_rtol=TRAIN_PARITY_DELTA_RTOL,
                 modes=("qlora", "full")):
    """For QLoRA and full fine-tuning: the ``kernel`` run (keyword
    arguments of ``_train_run``) against the ``plain`` one — relative
    errors of the loss / grad_norm streams, the relative error of the
    trained tensors' change, and the kernel run's launches against
    ``expected_launches`` (2 microbatches a step), and the cross-entropy
    routed kernels' launches against ``_expected_routes``. Full
    fine-tuning also reports the lm_head's change on each side
    (``lm_head_delta_norm``)."""
    import torch
    rows, ok = [], True
    for mode in modes:
        before, routes_before = _launch_counts(), _route_counts()
        got, d_got = _train_run(cfg, mode, dev=dev, steps=steps,
                                batches=batches, **kernel)
        used = {k: v - before[k] for k, v in _launch_counts().items()}
        routes = {k: {r: n - routes_before[k][r] for r, n in v.items()}
                  for k, v in _route_counts().items()}
        ref, d_ref = _train_run(cfg, mode, dev=dev, steps=steps,
                                batches=batches, **plain)
        num = sum(float(torch.sum((d_got[n] - b) ** 2))
                  for n, b in d_ref.items())
        den = sum(float(torch.sum(b ** 2)) for b in d_ref.values())
        delta_rel = (num / den) ** 0.5 if den > 0 else float("inf")
        rel = {k: max(abs(a - b) / abs(b) for a, b in zip(got[k], ref[k]))
               for k in got}
        want = {k: v * steps for k, v in expected_launches(
            cfg, 2, kernel.get("fused_ops", False),
            full_ft=mode == "full").items()}
        row_ok = (all(v <= rtol for v in rel.values())
                  and delta_rel <= delta_rtol
                  and used == want
                  and routes == _expected_routes(cfg, used)
                  and all(np.isfinite(got["loss"] + ref["loss"])))
        ok = ok and row_ok
        rows.append({"mode": mode, "ok": row_ok, "kernel_run": got,
                     "plain_run": ref, "max_rel_err": rel,
                     "delta_rel_err": delta_rel, "launches": used,
                     "routes": routes})
        if "lm_head" in d_ref:
            rows[-1]["lm_head_delta_norm"] = [
                float(torch.linalg.vector_norm(d["lm_head"]))
                for d in (d_got, d_ref)]
        del d_got, d_ref
    return rows, ok


def phase_train_parity(dev, cfg=None, steps: int = 3):
    """fp32 (TF32 off), 4 layers at full width, dropout 0: QLoRA and full
    fine-tuning, each with attention through the kernels (flash) and
    through the dense path (xla), hold each other's loss and grad_norm
    streams and trained tensors."""
    import torch
    from gke_ray_train_tpu_torch.models import llama3_8b
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cfg is None:
        cfg = dataclasses.replace(
            llama3_8b(dtype="float32", param_dtype="float32", remat=True),
            max_seq_len=1024, n_layers=4)
    rng = np.random.default_rng(77)
    batches = [_sft_batch(2, cfg.max_seq_len, cfg.vocab_size, rng)
               for _ in range(steps)]
    rows, ok = _parity_runs(cfg, dev, steps, batches, dict(impl="flash"),
                            dict(impl="xla"))
    emit({"phase": "train_parity", "ok": ok, "dtype": "float32",
          "n_layers": cfg.n_layers, "d_model": cfg.d_model, "steps": steps,
          "kernel_run": "flash", "plain_run": "xla",
          "tol_streams_rel": TRAIN_PARITY_RTOL,
          "tol_delta_rel": TRAIN_PARITY_DELTA_RTOL, "runs": rows})
    if not ok:
        raise SystemExit("train-parity phase failed")


def phase_train_fused_parity(dev, cfg=None, steps: int = 3):
    """fp32 (TF32 off), Gemma-2 at full width and 4 layers, dropout 0,
    packed rows of 1,024 tokens: QLoRA and full fine-tuning with
    FUSED_OPS=1 against FUSED_OPS=0, attention through the flash kernels
    on both sides, hold each other's loss and grad_norm streams (the
    1e-4 relative bound of the JAX package's tests/test_overlap.py) and
    trained tensors."""
    import torch
    from gke_ray_train_tpu_torch.models import gemma2_9b
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cfg is None:
        cfg = dataclasses.replace(
            gemma2_9b(dtype="float32", param_dtype="float32", remat=True),
            max_seq_len=1024, n_layers=4)
    rng = np.random.default_rng(78)
    batches = [_packed_batch(2, cfg.max_seq_len, cfg.vocab_size, rng)
               for _ in range(steps)]
    rows, ok = _parity_runs(cfg, dev, steps, batches,
                            dict(impl="flash", fused_ops=True),
                            dict(impl="flash", fused_ops=False))
    emit({"phase": "train_fused_parity", "ok": ok, "dtype": "float32",
          "model": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "steps": steps,
          "kernel_run": "FUSED_OPS=1", "plain_run": "FUSED_OPS=0",
          "tol_streams_rel": TRAIN_PARITY_RTOL,
          "tol_delta_rel": TRAIN_PARITY_DELTA_RTOL, "runs": rows})
    if not ok:
        raise SystemExit("train-fused-parity phase failed")


def phase_train_fused_ce(dev, cfg=None, steps: int = 5):
    """The train phase's job (Llama-3.1-8B QLoRA with
    ray-jobs/fine_tune_config.json's settings, full width and depth) with
    FUSED_OPS=1: Llama has no logit softcap, so the loss runs through the
    fused cross-entropy on the final-normed hidden state, and the blocks'
    rms_norms and q/k RoPE through the fused kernels."""
    return phase_train(dev, cfg, steps, phase="train_fused_ce",
                       fused_ops=True)


def phase_train_fused_ce_parity(dev, cfg=None, steps: int = 3):
    """fp32 (TF32 off), Llama-3.1-8B at full width (vocab 128,256) and 4
    layers, dropout 0: QLoRA and full fine-tuning with FUSED_OPS=1 (the
    fused cross-entropy, rms_norm and RoPE) against FUSED_OPS=0, attention
    through the flash kernels on both sides, hold each other's loss and
    grad_norm streams and trained tensors (the lm_head among them in full
    fine-tuning, where it must move). Returns the dhead
    launches of the fused full fine-tuning run, the one path that forms
    dhead."""
    import torch
    from gke_ray_train_tpu_torch.models import llama3_8b
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cfg is None:
        cfg = dataclasses.replace(
            llama3_8b(dtype="float32", param_dtype="float32", remat=True),
            max_seq_len=1024, n_layers=4)
    rng = np.random.default_rng(79)
    batches = [_sft_batch(2, cfg.max_seq_len, cfg.vocab_size, rng)
               for _ in range(steps)]
    rows, ok = _parity_runs(cfg, dev, steps, batches,
                            dict(impl="flash", fused_ops=True),
                            dict(impl="flash", fused_ops=False))
    for row in rows:
        if row["mode"] == "full":
            # the delta check holds the lm_head's change alike on both
            # sides; this holds that there is one
            row["ok"] = row["ok"] and min(row["lm_head_delta_norm"]) > 0
            ok = ok and row["ok"]
    emit({"phase": "train_fused_ce_parity", "ok": ok, "dtype": "float32",
          "model": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "vocab": cfg.vocab_size, "steps": steps,
          "kernel_run": "FUSED_OPS=1", "plain_run": "FUSED_OPS=0",
          "tol_streams_rel": TRAIN_PARITY_RTOL,
          "tol_delta_rel": TRAIN_PARITY_DELTA_RTOL, "runs": rows})
    if not ok:
        raise SystemExit("train-fused-ce-parity phase failed")
    return {"fused_ce_dhead": next(r["launches"]["fused_ce_dhead"]
                                   for r in rows if r["mode"] == "full")}


def phase_train_fused_ce_profile(dev, cfg=None):
    """The profile of ``phase_train_profile`` over one step of the
    train_fused_ce phase's job."""
    phase_train_profile(dev, cfg, phase="train_fused_ce_profile",
                        fused_ops=True)


# ---------------------------------------------------------------------------
# the multi-card slice: the data x fsdp mesh (FSDP2), remat "dots",
# adafactor
# ---------------------------------------------------------------------------

MESH_STEPS = 3                  # after the warm-up: 4 steps a run
MESH_LAYERS = 8                 # train_mesh's depth cut of the 32
DOTS_LAYERS = 8                 # train_remat_dots' depth cut of the 32
MESH_LOSS_RTOL = 1e-3           # meshed against unmeshed, bf16
MESH_PARITY_RTOL = 1e-6         # fp32, TF32 off
DOTS_STEPS = 3
MESH_MULTI_TIMEOUT_S = 240          # each of the phase's two multi-process runs


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def _world1_mesh(dev):
    """A world-1 NCCL group in this process (127.0.0.1, a free port) and
    its data 1 x fsdp 1 mesh; the group is destroyed on the way out."""
    import torch.distributed as dist
    from gke_ray_train_tpu_torch.parallel import (
        MeshConfig, build_mesh, distributed_init)
    distributed_init(dev, world_size=1, rank=0,
                     init_method=f"tcp://127.0.0.1:{_free_port()}")
    try:
        yield build_mesh(MeshConfig(data=1, fsdp=1))
    finally:
        dist.destroy_process_group()


def _sharded_report(params):
    """(every parameter a DTensor, {placement: count})."""
    from torch.distributed.tensor import DTensor
    kinds = {}
    for p in params.parameters():
        key = (",".join(str(x) for x in p.placements)
               if isinstance(p, DTensor) else "local")
        kinds[key] = kinds.get(key, 0) + 1
    return "local" not in kinds, kinds


def _mesh_run(dev, mesh, steps=MESH_STEPS):
    """The train_fused_ce job (Llama-3.1-8B QLoRA, FUSED_OPS=1, the job's
    rows) at ``MESH_LAYERS`` layers through ``_drive``, sharded on
    ``mesh`` or not; guard off on both sides so they run the same code
    around the step."""
    import torch
    job = _fine_tune_setup(dev, _llama_cfg(FINE_TUNE_CONFIG, MESH_LAYERS),
                           steps + 1, mesh=mesh, fused_ops=True,
                           transfer_guard=None)
    sharded = _sharded_report(job["state"].params) if mesh is not None \
        else (False, {})
    run = _drive(dev, job, eval_rows=None)
    cfg, plan = job["cfg"], job["plan"]
    times = run["step_s"][1:]
    out = {"losses": [m["loss"] for m in run["metrics"]],
           "grad_norms": [m["grad_norm"] for m in run["metrics"]],
           "step_s": times, "step_s_p50": sorted(times)[len(times) // 2],
           "peak_mem_bytes": run["peak_mem_bytes"],
           "init_s": job["init_s"], "base_bytes": job["base_bytes"],
           "launches_per_step": {k: v / steps for k, v in
                                 run["step_launches"].items()},
           "launches": run["step_launches"], "sharded": sharded[0],
           "placements": sharded[1], "tokens": job["batch_rows"] * job["seq"]}
    want = expected_launches(cfg, plan.grad_accum, plan.fused_ops)
    del job, run
    _release()
    out["held_after_bytes"] = torch.cuda.memory_allocated()
    return out, want, cfg


def phase_train_mesh(dev):
    """The Llama-3.1-8B QLoRA job with FUSED_OPS=1 (train_fused_ce's) at
    full width and ``MESH_LAYERS`` deep on a world-1 NCCL group's data 1
    x fsdp 1 mesh: every weight a DTensor, sharded by FSDP2
    (``parallel/sharding.py``), one warm-up and 3 timed steps through
    ``run_training``; per step the kernels launch as in the unmeshed run
    (flash forward 8 a layer, dQ and dK/dV 4 a layer, CE row statistics
    and dx 4, rms_norm 16 and RoPE 12 a layer), and the losses stay
    within 1e-3 of an unmeshed run of the same seed and rows, run first
    in this phase. Both runs' p50 and peak memory."""
    plain, want, cfg = _mesh_run(dev, None)
    with _world1_mesh(dev) as mesh:
        meshed, _, _ = _mesh_run(dev, mesh)
        _release()
    gaps = [abs(a - b) / abs(b) for a, b in zip(meshed["losses"],
                                                plain["losses"])]
    problems = []
    if not meshed["sharded"]:
        problems.append(f"weights not all sharded: {meshed['placements']}")
    for name, run in (("meshed", meshed), ("unmeshed", plain)):
        if run["launches_per_step"] != want:
            problems.append(f"{name} launches per step "
                            f"{run['launches_per_step']} != {want}")
        if not all(np.isfinite(run["losses"] + run["grad_norms"])):
            problems.append(f"{name}: non-finite loss or grad_norm")
    if max(gaps) > MESH_LOSS_RTOL:
        problems.append(f"meshed losses {max(gaps)} off the unmeshed")
    emit({"phase": "train_mesh", "ok": not problems, "problems": problems,
          "nvidia_smi": nvidia_smi_line(), "model": cfg.name,
          "n_layers": cfg.n_layers, "world": 1,
          "mesh": {"data": 1, "fsdp": 1}, "backend": "nccl",
          "fused_ops": True, "steps": MESH_STEPS, "meshed": meshed,
          "unmeshed": plain, "loss_rel_gaps": gaps,
          "max_loss_rel_gap": max(gaps), "tol_loss_rel": MESH_LOSS_RTOL,
          "fsdp_overhead_p50": meshed["step_s_p50"] / plain["step_s_p50"],
          "peak_mem_ratio": meshed["peak_mem_bytes"]
          / plain["peak_mem_bytes"]})
    if problems:
        raise SystemExit("train_mesh phase failed: " + "; ".join(problems))
    return meshed["launches"]


def phase_train_mesh_parity(dev, cfg=None, steps: int = 2):
    """fp32 (TF32 off), Llama-3.1-8B at full width and 4 layers, flash
    and FUSED_OPS=1, QLoRA and full fine-tuning, 2 steps each (3 until
    train_overlap's time was paid for): on a
    world-1 NCCL mesh against unmeshed, and ``remat_policy="dots"``
    against ``"full"``, each within 1e-6 (streams and the trained
    tensors' change); then ``OPTIM=adafactor`` (QLoRA: the unfactored
    branch; full fine-tuning: the factored one) through the kernels
    against the same step with every kernel on its plain version (dense
    attention, FUSED_OPS=0), within the train-parity bounds, finite and
    moving."""
    import torch
    from gke_ray_train_tpu_torch.models import llama3_8b
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cfg is None:
        cfg = dataclasses.replace(
            llama3_8b(dtype="float32", param_dtype="float32", remat=True),
            max_seq_len=1024, n_layers=4)
    rng = np.random.default_rng(80)
    batches = [_sft_batch(2, cfg.max_seq_len, cfg.vocab_size, rng)
               for _ in range(steps)]
    kernel = dict(impl="flash", fused_ops=True)
    launches = {}

    def count(rows):
        for r in rows:
            for k, n in r["launches"].items():
                launches[k] = launches.get(k, 0) + n
    with _world1_mesh(dev) as mesh:
        mesh_rows, mesh_ok = _parity_runs(
            cfg, dev, steps, batches, dict(kernel, mesh=mesh), kernel,
            rtol=MESH_PARITY_RTOL, delta_rtol=MESH_PARITY_RTOL)
    count(mesh_rows)
    dots_rows, dots_ok = _parity_runs(
        cfg, dev, steps, batches, dict(kernel, remat_policy="dots"),
        dict(kernel, remat_policy="full"), rtol=MESH_PARITY_RTOL,
        delta_rtol=MESH_PARITY_RTOL)
    count(dots_rows)
    ada_rows, ada_ok = _parity_runs(
        cfg, dev, steps, batches, dict(kernel, optim="adafactor"),
        dict(impl="xla", fused_ops=False, optim="adafactor"))
    count(ada_rows)
    for r in ada_rows:
        losses = r["kernel_run"]["loss"]
        moving = len(set(losses)) == len(losses)
        r["ok"] = r["ok"] and moving and r["delta_rel_err"] < 1.0
        ada_ok = ada_ok and r["ok"]
    ok = mesh_ok and dots_ok and ada_ok
    emit({"phase": "train_mesh_parity", "ok": ok, "dtype": "float32",
          "model": cfg.name, "n_layers": cfg.n_layers, "steps": steps,
          "mesh_vs_unmeshed": {"ok": mesh_ok, "runs": mesh_rows,
                               "tol_rel": MESH_PARITY_RTOL},
          "dots_vs_full": {"ok": dots_ok, "runs": dots_rows,
                           "tol_rel": MESH_PARITY_RTOL},
          "adafactor_kernels_vs_plain": {
              "ok": ada_ok, "runs": ada_rows,
              "tol_streams_rel": TRAIN_PARITY_RTOL,
              "tol_delta_rel": TRAIN_PARITY_DELTA_RTOL}})
    if not ok:
        raise SystemExit("train_mesh_parity phase failed")
    return launches


def _opt_state_bytes(opt):
    return sum(t.numel() * t.element_size()
               for st in opt.state.values() for t in st.values())


def _timed_steps(dev, job, steps, guard=None):
    """One warm-up and ``steps`` timed steps of ``job`` (synchronized
    around each); the peak memory after the warm-up, and the memory held
    before the first step (the base, the adapters, the optimizer
    state). ``guard``: each step runs under that TRANSFER_GUARD mode
    (``disallow`` raises on any wait of the host for the card)."""
    import torch
    from gke_ray_train_tpu_torch.analysis.guards import transfer_guard_ctx
    state, fn = job["state"], job["step_fn"]
    losses, norms, times = [], [], []
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    for i, b in enumerate(job["batches"][:steps + 1]):
        b = job["place"](b)
        b = b.wait() if hasattr(b, "wait") else b
        torch.cuda.synchronize()
        t = time.perf_counter()
        with transfer_guard_ctx(guard):
            state, m = fn(state, b)
        torch.cuda.synchronize()
        if i == 0:
            torch.cuda.reset_peak_memory_stats()
        else:
            times.append(time.perf_counter() - t)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"losses": losses, "grad_norms": norms, "step_s": times,
            "transfer_guard": guard or "off",
            "step_s_p50": sorted(times)[len(times) // 2] if times else None,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "held_before_bytes": held,
            "opt_state_bytes": _opt_state_bytes(state.opt_state)}


def phase_train_remat_dots(dev, steps: int = DOTS_STEPS):
    """Llama-3.1-8B QLoRA at full width and ``DOTS_LAYERS`` deep (the
    train_fused_ce job, one NF4 base for every run): 1 + 3 steps with
    ``remat_policy="dots"`` against 1 + 3 with ``"full"`` (p50, peak
    memory, losses), then ``OPTIM=adafactor`` against AdamW under
    ``"full"`` (p50, peak, the optimizer state's bytes), these two under
    TRANSFER_GUARD=disallow. The saved
    activations the dots policy adds are reckoned from the shapes: every
    2-D product's output per token and layer (the seven base
    projections' and, with LoRA, the two adapter products of each)."""
    import torch
    from gke_ray_train_tpu_torch.models.transformer import proj_shapes
    runs, base = {}, None
    # AdamW and adafactor under "full" step under TRANSFER_GUARD=disallow
    for name, policy, optim, guard in (
            ("full", "full", "adamw", "disallow"),
            ("dots", "dots", "adamw", None),
            ("adafactor", "full", "adafactor", "disallow")):
        _release()
        cfg = None
        if base is not None:
            cfg = dataclasses.replace(base.cfg, remat_policy=policy)
        else:
            from gke_ray_train_tpu_torch.models import preset_for_model_id
            with open(FINE_TUNE_CONFIG) as f:
                ft = json.load(f)
            cfg = dataclasses.replace(
                preset_for_model_id(ft["MODEL_ID"], dtype="bfloat16",
                                    param_dtype="bfloat16", remat=True,
                                    remat_policy=policy),
                max_seq_len=int(ft["MAX_SEQ_LENGTH"]), n_layers=DOTS_LAYERS)
        job = _fine_tune_setup(dev, cfg, steps + 1, params=base,
                               optim=optim, fused_ops=True,
                               transfer_guard=None)
        base = job["state"].params
        before = _launch_counts()
        runs[name] = _timed_steps(dev, job, steps, guard=guard)
        runs[name]["launches"] = {k: v - before[k]
                                  for k, v in _launch_counts().items()}
        micro, seq, lcfg = job["micro"], job["seq"], job["lcfg"]
        del job
    cfg = base.cfg
    shapes = proj_shapes(cfg)
    per_tok = sum(d_out for _, d_out in shapes.values())
    lora_per_tok = sum(lcfg.r + d_out for _, d_out in shapes.values())
    tokens = micro * seq
    saved = 2 * (per_tok + lora_per_tok) * tokens * cfg.n_layers
    problems = []
    for name, r in runs.items():
        if not all(np.isfinite(r["losses"])):
            problems.append(f"{name}: non-finite loss")
    gap = max(abs(a - b) / abs(b) for a, b in zip(runs["dots"]["losses"],
                                                  runs["full"]["losses"]))
    if gap > MESH_LOSS_RTOL:
        problems.append(f"dots losses {gap} off full's")
    if runs["dots"]["launches"] != runs["full"]["launches"]:
        problems.append("dots launched other kernels than full")
    emit({"phase": "train_remat_dots", "ok": not problems,
          "problems": problems, "nvidia_smi": nvidia_smi_line(),
          "model": cfg.name, "n_layers": cfg.n_layers, "steps": steps,
          "microbatch_tokens": tokens, "runs": runs,
          "dots_loss_rel_gap": gap,
          "dots_saved_bytes_reckoned": saved,
          "dots_saved_per_token_layer": {"base": per_tok,
                                         "lora": lora_per_tok},
          "dots_extra_peak_bytes": runs["dots"]["peak_mem_bytes"]
          - runs["full"]["peak_mem_bytes"],
          "dots_p50_ratio": runs["dots"]["step_s_p50"]
          / runs["full"]["step_s_p50"],
          "adafactor_state_ratio": runs["adafactor"]["opt_state_bytes"]
          / runs["full"]["opt_state_bytes"]})
    del base
    torch.cuda.empty_cache()
    if problems:
        raise SystemExit("train_remat_dots phase failed: "
                         + "; ".join(problems))
    return runs["dots"]["launches"]


def _gathered_bytes_per_step(cfg, n, grad_accum, base):
    """Bytes one rank receives by FSDP2 all-gathers in a step, reckoned
    from the shapes: per microbatch each block's weights are gathered
    for its forward and again for its backward (under remat the
    recomputation reuses the backward's), the root's once; a rank
    receives (n - 1) / n of each gathered tensor."""
    block = sum(t.numel() * t.element_size()
                for t in itertools.chain(base.blocks[0].parameters(),
                                         base.blocks[0].buffers()))
    root = sum(t.numel() * t.element_size()
               for t in (base.embed, base.final_norm, base.lm_head)
               if t is not None)
    whole = grad_accum * (2 * block * cfg.n_layers + root)
    return int(whole * (n - 1) / n), whole


# train_mesh_multi: LoRA dropout off on both sides, so that a step's
# masks do not depend on how the rows fall into microbatches
MESH_MULTI_FT = {"LORA_DROPOUT": 0.0}
# every step's loss and grad_norm across N ranks against one card, both
# as one-row microbatches (relative): a few bf16 roundings (2 ** -8) of
# the summation order of the adapters' gradients and the sums of nll
MESH_MULTI_RTOL = 1e-2
# the entry under torchrun: the entry phase's job cut to 4 layers, 4
# steps of the N-card global batch, a save and an eval of 16 rows every
# 2, the rank agreement on preemption at every boundary
MESH_MULTI_ENTRY_LAYERS = 4
MESH_MULTI_ENTRY_CUT = {"NUM_EVAL_SAMPLES": 16, "SAVE_STEPS_SFT": 2,
                        "EVAL_STEPS_SFT": 2, "LOGGING_STEPS": 1,
                        "REPORT_TO": "none"}
MESH_MULTI_ENTRY_STEPS = 4


def _one_row_step(job, dev, mesh=None):
    """``job``'s step taking each of a batch's rows as its own
    microbatch (the job's plan, schedule and optimizer)."""
    from gke_ray_train_tpu_torch.train import make_train_step
    rows = len(job["batches"][0]["inputs"])
    return make_train_step(job["cfg"], job["spec"], lora_cfg=job["lcfg"],
                           plan=job["plan"], grad_accum=rows, device=dev,
                           mesh=mesh)


def _mesh_worker(out_path):
    """One rank of train_mesh_multi (env: RANK / WORLD_SIZE / LOCAL_RANK /
    MASTER_ADDR / MASTER_PORT): the train_mesh job, dropout off, on an
    fsdp=N mesh, each rank the global batch's rows ``rank::N`` as one-row
    microbatches (8 / N of them), one warm-up and 3 timed steps."""
    import torch
    import torch.distributed as dist
    from gke_ray_train_tpu_torch.parallel import (
        MeshConfig, build_mesh, distributed_init)
    dev = distributed_init()
    world = dist.get_world_size()
    mesh = build_mesh(MeshConfig(data=1, fsdp=world))
    rank = dist.get_rank()
    job = _fine_tune_setup(dev, None, MESH_STEPS + 1, mesh=mesh,
                           ft_over=MESH_MULTI_FT, fused_ops=True,
                           transfer_guard=None)
    global_rows = job["batch_rows"]
    job["batches"] = [{k: v[rank::world] for k, v in b.items()}
                      for b in job["batches"]]
    local_rows = global_rows // world
    job["step_fn"] = _one_row_step(job, dev, mesh)
    sharded = _sharded_report(job["state"].params)
    r = _timed_steps(dev, job, MESH_STEPS)
    recv, whole = _gathered_bytes_per_step(
        job["cfg"], world, local_rows, job["state"].params)
    tokens = global_rows * job["seq"]
    r.update(rank=rank, world=world, sharded=sharded[0],
             placements=sharded[1], local_rows=local_rows,
             grad_accum=local_rows,
             tokens_per_s_per_card=tokens / r["step_s_p50"] / world,
             allgather_bytes_received_per_step=recv,
             allgather_bytes_gathered_per_step=whole,
             base_bytes_local=job["base_bytes"],
             device_name=torch.cuda.get_device_name(dev))
    with open(out_path + f".{rank}", "w") as f:
        json.dump(r, f)
    dist.barrier()
    dist.destroy_process_group()


def _entry_worker(config_path, out_path):
    """One rank of train_mesh_multi's entry run, started by torchrun
    (its env): ``fine_tune.train_loop_per_worker`` on the job of
    ``config_path`` cut to ``MESH_MULTI_ENTRY_LAYERS`` layers (or the
    ``ENTRY_WORKER_LAYERS`` the phase sets in its env); each eval
    loss read from ``sharded_eval_loss``, the training's peak memory and
    the export's seconds and peak read around ``save_export``."""
    import torch
    import torch.distributed as dist
    from gke_ray_train_tpu_torch import fine_tune as ft
    with open(config_path) as f:
        config = json.load(f)
    rec = {"evals": []}
    orig, orig_eval = ft.save_export, ft.sharded_eval_loss

    def sharded_eval_loss(*a, **kw):
        loss = orig_eval(*a, **kw)
        rec["evals"].append(float(loss))
        return loss

    def save_export(params, cfg, export_dir, step, **kw):
        torch.cuda.synchronize()
        rec["train_peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        rec["held_before_export_bytes"] = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = orig(params, cfg, export_dir, step, **kw)
        torch.cuda.synchronize()
        rec["export"] = dict(out, dir=export_dir, step=int(step),
                             seconds=time.perf_counter() - t,
                             peak_mem_bytes=torch.cuda.max_memory_allocated())
        return out
    ft.save_export, ft.sharded_eval_loss = save_export, sharded_eval_loss
    t0 = time.perf_counter()
    try:
        with _depth_cut(int(os.environ.get("ENTRY_WORKER_LAYERS",
                                           MESH_MULTI_ENTRY_LAYERS))):
            metrics = ft.train_loop_per_worker(config)
    finally:
        ft.save_export, ft.sharded_eval_loss = orig, orig_eval
    rank, world = dist.get_rank(), dist.get_world_size()
    rec.update(rank=rank, world=world, wall_s=time.perf_counter() - t0,
               metrics={k: v for k, v in (metrics or {}).items()
                        if isinstance(v, (int, float))},
               device_name=torch.cuda.get_device_name())
    with open(out_path + f".{rank}", "w") as f:
        json.dump(rec, f)
    dist.barrier()
    dist.destroy_process_group()


def _descendants(pid):
    """Every process below ``pid`` (Linux ``/proc``): torchrun starts
    its workers in sessions of their own, out of its process group."""
    out, todo = [], [pid]
    while todo:
        p = todo.pop()
        for task in glob.glob(f"/proc/{p}/task/*/children"):
            try:
                with open(task) as f:
                    kids = [int(x) for x in f.read().split()]
            except OSError:
                continue
            out += kids
            todo += kids
    return out


def _wait_all(procs, timeout):
    """Wait for ``procs`` under one deadline; kill what is left, with
    every process below it. Returns (hung indices, exit codes)."""
    import signal
    deadline = time.monotonic() + timeout
    hung = []
    for i, p in enumerate(procs):
        try:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            hung.append(i)
    for p in procs:
        if p.poll() is None:
            for pid in _descendants(p.pid) + [p.pid]:
                try:
                    os.kill(pid, signal.SIGKILL)
                except OSError:
                    pass
            p.wait()
    return hung, [p.returncode for p in procs]


def _read_ranks(out, n):
    ranks = []
    for rank in range(n):
        try:
            with open(out + f".{rank}") as f:
                ranks.append(json.load(f))
        except OSError:
            ranks.append(None)
    return ranks


def _multi_reference(dev):
    """The train_mesh job, dropout off, on this card unmeshed with every
    row its own microbatch: what the ranks' streams are held to."""
    import torch
    job = _fine_tune_setup(dev, None, MESH_STEPS + 1, ft_over=MESH_MULTI_FT,
                           fused_ops=True, transfer_guard=None)
    job["step_fn"] = _one_row_step(job, dev)
    r = _timed_steps(dev, job, MESH_STEPS)
    r["tokens_per_s"] = job["batch_rows"] * job["seq"] / r["step_s_p50"]
    del job
    _release()
    torch.cuda.empty_cache()
    return r


def _multi_entry(n, extra=None, path=None, layers=None, expect_files=()):
    """The entry under torchrun on ``n`` cards (module doc, 19b) on the
    job of ``path``, the config's keys ``extra`` replaced
    (``MESH_MODEL``: the global batch spans the n / model batch ranks);
    then its sharded export converted here (an MoE model's expert
    tensors among the names it must hold). ``path`` defaults to
    ``ENTRY_CONFIG``; ``layers`` the depth (default
    ``MESH_MULTI_ENTRY_LAYERS``); ``expect_files``: names the run must
    have written under its output dir (``INFERENCE``'s comparison,
    ``SERVE_AFTER_TRAIN``'s smoke). Returns (line, problems)."""
    import tempfile
    import numpy as np
    from safetensors import safe_open
    from gke_ray_train_tpu_torch.ckpt.convert import convert
    from gke_ray_train_tpu_torch.ckpt.hf_io import (
        _hf_expert_names, _hf_layer_names)
    os.environ["HF_HUB_OFFLINE"] = "1"
    root = tempfile.mkdtemp(prefix="chip_smoke_mesh_entry_")
    path = path or ENTRY_CONFIG
    with open(path) as f:
        job = json.load(f)
    extra = dict(extra or {})
    batch_ranks = n // (int(extra.get("MESH_MODEL", 1))
                        * int(extra.get("MESH_PIPE", 1)))
    rows = (int(extra.get("PER_DEVICE_TRAIN_BATCH_SIZE",
                          job["PER_DEVICE_TRAIN_BATCH_SIZE"])) * batch_ranks
            * int(extra.get("GRADIENT_ACCUMULATION_STEPS",
                            job["GRADIENT_ACCUMULATION_STEPS"])))
    config = _entry_config(
        os.path.join(root, "run"), path=path, cut=dict(
            MESH_MULTI_ENTRY_CUT, **extra,
            NUM_TRAIN_SAMPLES=rows * MESH_MULTI_ENTRY_STEPS))
    cfg, lcfg, _ = _entry_setup(config, None,
                                layers or MESH_MULTI_ENTRY_LAYERS)
    disk = _entry_disk(root, cfg, lcfg, 1)
    cfg_path = os.path.join(root, "config.json")
    with open(cfg_path, "w") as f:
        json.dump(config, f)
    out = os.path.join(root, "rank")
    log_path = os.path.join(root, "torchrun.log")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
           "--nproc-per-node", str(n), "--master-addr", "127.0.0.1",
           "--master-port", str(_free_port()), os.path.abspath(__file__),
           "--entry-worker", cfg_path, out]
    env = dict(os.environ, PREEMPT_SYNC_EVERY="1",
               ENTRY_WORKER_LAYERS=str(layers or MESH_MULTI_ENTRY_LAYERS))
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, env=env, cwd=HERE, stdout=log,
                                stderr=subprocess.STDOUT)
        hung, rcs = _wait_all([proc], MESH_MULTI_TIMEOUT_S)
    wall = time.perf_counter() - t0
    ranks = _read_ranks(out, n)
    problems = []
    line = {"torchrun": " ".join(cmd[1:6] + [str(n)]), "wall_s": wall,
            "exit_code": rcs[0], "n_layers": cfg.n_layers, "disk": disk,
            "config": {k: config[k] for k in sorted(
                dict(MESH_MULTI_ENTRY_CUT, **extra))},
            "ranks": ranks}
    if hung or rcs[0] != 0 or None in ranks:
        with open(log_path) as f:
            line["log_tail"] = f.read()[-6000:]
        problems.append(f"torchrun entry: hung {bool(hung)}, exit code "
                        f"{rcs[0]}, ranks written "
                        f"{[r is not None for r in ranks]}")
        return line, problems
    line["wrote"] = {name: os.path.exists(os.path.join(
        config["OUTPUT_DIR_BASE"], name)) for name in expect_files}
    if not all(line["wrote"].values()):
        problems.append(f"torchrun entry: files written {line['wrote']}")
    ms = [r["metrics"] for r in ranks]
    streams = {"loss": [[m.get("loss")] for m in ms],
               "eval_loss": [r["evals"] for r in ranks]}
    for key, vals in streams.items():
        flat = [v for vs in vals for v in vs]
        if not vals[0] or None in flat or not all(np.isfinite(flat)):
            problems.append(f"torchrun entry: {key} {vals}")
        elif any(vs != vals[0] for vs in vals):
            problems.append(f"torchrun entry: ranks disagree on {key}: "
                            f"{vals}")
    if any(m.get("step") != MESH_MULTI_ENTRY_STEPS for m in ms):
        problems.append(f"torchrun entry: steps {[m.get('step') for m in ms]}"
                        f" != {MESH_MULTI_ENTRY_STEPS}")
    # the sharded export, converted in this process
    hf_dir = os.path.join(root, "hf")
    t = time.perf_counter()
    convert(ranks[0]["export"]["dir"], hf_dir)
    want = {"model.embed_tokens.weight": (cfg.vocab_size, cfg.d_model),
            "model.norm.weight": (cfg.d_model,)}
    if not cfg.tie_embeddings:
        want["lm_head.weight"] = (cfg.vocab_size, cfg.d_model)
    names = {n for i in range(cfg.n_layers)
             for n in _hf_layer_names(cfg, i).values()}
    names |= {n for i in range(cfg.n_layers) for e in range(cfg.n_experts)
              for n in _hf_expert_names(i, e).values()}
    got, bad = {}, []
    for path in sorted(glob.glob(os.path.join(hf_dir, "*.safetensors"))):
        with safe_open(path, "pt") as f:
            for k in f.keys():
                x = f.get_tensor(k)
                got[k] = tuple(x.shape)
                if not bool(x.float().isfinite().all()):
                    bad.append(k)
    if set(got) != set(want) | names:
        problems.append(f"converted export: {len(got)} tensors, missing "
                        f"{sorted(set(want) | names - set(got))[:4]}, "
                        f"extra {sorted(set(got) - set(want) - names)[:4]}")
    wrong = [k for k, shape in want.items() if got.get(k) != shape]
    if wrong or bad:
        problems.append(f"converted export: shapes {wrong}, non-finite "
                        f"{bad[:4]}")
    line["convert"] = {"seconds": time.perf_counter() - t,
                       "tensors": len(got), "non_finite": len(bad),
                       "bytes": sum(os.path.getsize(p) for p in glob.glob(
                           os.path.join(hf_dir, "*.safetensors")))}
    import shutil
    shutil.rmtree(root, ignore_errors=True)
    return line, problems


def phase_train_mesh_multi(dev):
    """Opt-in, a host with N >= 2 cards (module doc, 19b). Prints the
    card count first. The train_mesh job, LoRA dropout off, on this card
    as one-row microbatches; then one rank per card on an fsdp=N NCCL
    mesh (torchrun's env, set here), the same 8 rows a step as one-row
    microbatches, spawned as N processes under one deadline: each step's
    loss and grad_norm within ``MESH_MULTI_RTOL`` of the one-card run's;
    per card p50, tokens/s, peak and the bytes all-gathered a step (from
    the shapes). Then the entry under torchrun (``_multi_entry``). Fewer
    than 2 cards fails."""
    import tempfile
    import torch
    n = torch.cuda.device_count()
    emit({"phase": "train_mesh_multi_devices", "ok": n >= 2,
          "device_count": n, "nvidia_smi": nvidia_smi_line()})
    if n < 2:
        raise SystemExit(f"train_mesh_multi needs 2 or more cards; this "
                         f"host has {n}")
    ref = _multi_reference(dev)
    out = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_mesh_"), "rank")
    hung, rcs, ranks = _spawn_ranks("--mesh-worker", out, n, list(range(n)),
                                    MESH_MULTI_TIMEOUT_S)
    problems, gaps = [], {}
    if hung or any(rcs) or None in ranks:
        problems.append(f"ranks hung {hung}, exit codes {rcs}")
    else:
        for r in ranks:
            if not r["sharded"]:
                problems.append(f"rank {r['rank']}: not all sharded "
                                f"{r['placements']}")
            for key in ("losses", "grad_norms"):
                g = [abs(a - b) / abs(b)
                     for a, b in zip(r[key], ref[key])]
                gaps.setdefault(key, []).append(g)
                if not (all(np.isfinite(r[key]))
                        and max(g) <= MESH_MULTI_RTOL):
                    problems.append(f"rank {r['rank']}: {key} {r[key]} "
                                    f"against one card's {ref[key]}")
    entry, entry_problems = _multi_entry(n)
    problems += entry_problems
    emit({"phase": "train_mesh_multi", "ok": not problems,
          "problems": problems, "nvidia_smi": nvidia_smi_line(),
          "world": n, "mesh": {"data": 1, "fsdp": n},
          "lora_dropout": MESH_MULTI_FT["LORA_DROPOUT"],
          "one_card": ref, "ranks": ranks, "rel_gaps": gaps,
          "max_rel_gap": {k: max(max(g) for g in v)
                          for k, v in gaps.items()},
          "tol_rel": MESH_MULTI_RTOL, "entry": entry})
    if problems:
        raise SystemExit("train_mesh_multi phase failed: "
                         + "; ".join(problems))
    return None


# ---------------------------------------------------------------------------
# the tensor-parallel slice: the model axis (DTensor), HSDP, the 70B layout
# ---------------------------------------------------------------------------

# train_tp: the train_mesh job cut to 2 layers (4 until train_hier came),
# as two ranks of one card
# at model 2 x fsdp 1 over gloo (NCCL takes one rank a card); its bf16
# streams against one process within MESH_MULTI_RTOL (the bound of bf16
# runs whose sums are cut across ranks: each rank's partial products are
# rounded to bf16 before they are summed), and the same job in fp32 (TF32
# off) at TP_PARITY_LAYERS layers within MESH_LOSS_RTOL
TP_LAYERS = 2
TP_PARITY_LAYERS = 2
# 1 + 1 steps a run (train_mesh's 1 + 3 cut to 1 + 2 for the pipeline
# phase's time, to 1 + 1 for train_overlap's); the fp32 run 1 + 1 (cut for
# train_pp's pipe x model world, which also holds the TP step in fp32)
TP_STEPS = 1
TP_FP32_STEPS = 1
TP_MODEL = 2
TP_TIMEOUT_S = 420
# the second run's LORA_DROPOUT: fine_tune_config.json's own
TP_DROPOUT = 0.1
# the collectives of the TP path on the card's tensors, by the group they
# run on, and whether train_tp's QLoRA step makes them: the model group's
# sums (bf16 row-parallel outputs, fp32 statistics) and max, the world's
# broadcast of the adapters, FSDP2's all-gather on the fsdp group of one
# rank; its reduce-scatter only where the base trains (full fine-tuning)
TP_PROBE = {"all_reduce_sum_bf16_model": True,
            "all_reduce_sum_f32_model": True,
            "all_reduce_max_f32_model": True,
            "broadcast_f32_world": True,
            "all_gather_into_tensor_fsdp": True,
            "reduce_scatter_tensor_fsdp": False}
# train_tp_multi on the four-card host: ray-jobs/fine_tune_config_70b.json
# (full fine-tuning, bf16 compute over fp32 masters, AdamW) on fsdp 1 x
# model 4, cut in depth to what four cards hold; held against one card
# at a depth one card holds
FT_70B_CONFIG = os.path.join(HERE, "ray-jobs", "fine_tune_config_70b.json")
TP_70B_LAYERS = 8
TP_70B_REF_LAYERS = 1
# the loss through the fused cross-entropy (its dhead on each rank's
# [8,192, 32,064] head shard); the job sets no FUSED_OPS
TP_70B_PLAN = {"fused_ops": True}
# the 8B job's meshes on four cards, each against one card
TP_MULTI_MESHES = {"hsdp": dict(data=2, fsdp=2),
                   "fsdp_model": dict(fsdp=2, model=2)}
TP_MULTI_TIMEOUT_S = 900
# the entry under torchrun at MESH_MODEL 2
TP_MULTI_ENTRY = {"MESH_MODEL": 2}


def _llama_cfg(config, n_layers, dtype="bfloat16", param_dtype="bfloat16"):
    """The MODEL_ID preset of ``config`` at full width, ``n_layers``
    deep, remat on, at the job's MAX_SEQ_LENGTH."""
    from gke_ray_train_tpu_torch.models import preset_for_model_id
    with open(config) as f:
        ft = json.load(f)
    return dataclasses.replace(
        preset_for_model_id(ft["MODEL_ID"], dtype=dtype,
                            param_dtype=param_dtype, remat=True),
        max_seq_len=int(ft["MAX_SEQ_LENGTH"]), n_layers=n_layers)


def _digest(t):
    """The first 16 hex digits of the sha256 of a tensor's bytes."""
    import hashlib
    import torch
    return hashlib.sha256(t.detach().cpu().contiguous().view(-1).view(
        torch.uint8).numpy().tobytes()).hexdigest()[:16]


def _first_masks(run):
    """Run ``run()`` with the LoRA dropout hook recording the digest of
    the first mask each projection draws (layer 0, microbatch 0)."""
    from gke_ray_train_tpu_torch.models import transformer as tr
    masks = {}
    tr.dropout_hook = lambda name, m: masks.setdefault(
        name, {"digest": _digest(m), "shape": list(m.shape),
               "kept": float(m.float().mean())})
    try:
        out = run()
    finally:
        tr.dropout_hook = None
    return out, masks


def _tp_probe(dev, mesh):
    """Each collective of ``TP_PROBE`` once on this card's tensors:
    {name: "ok" or the error}."""
    import torch
    import torch.distributed as dist
    out = {}
    model, fsdp = mesh["model"].get_group(), mesh["fsdp"].get_group()
    n = mesh["fsdp"].size()
    calls = {
        "all_reduce_sum_bf16_model": lambda: dist.all_reduce(
            torch.ones(64, dtype=torch.bfloat16, device=dev), group=model),
        "all_reduce_sum_f32_model": lambda: dist.all_reduce(
            torch.ones(64, device=dev), group=model),
        "all_reduce_max_f32_model": lambda: dist.all_reduce(
            torch.ones(64, device=dev), op=dist.ReduceOp.MAX, group=model),
        "broadcast_f32_world": lambda: dist.broadcast(
            torch.ones(64, device=dev), src=0),
        "all_gather_into_tensor_fsdp": lambda: dist.all_gather_into_tensor(
            torch.empty(64 * n, dtype=torch.uint8, device=dev),
            torch.ones(64, dtype=torch.uint8, device=dev), group=fsdp),
        "reduce_scatter_tensor_fsdp": lambda: dist.reduce_scatter_tensor(
            torch.empty(64, device=dev), torch.ones(64 * n, device=dev),
            group=fsdp)}
    for name in TP_PROBE:
        try:
            calls[name]()
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as e:  # noqa: BLE001 - the probe reports it
            out[name] = f"{type(e).__name__}: {e}"[:400]
    return out


def _tp_rank_run(dev, cfg, mesh, dropout, steps, config=None, rows=None,
                 one_row=False, plan=None, keep=None, ft_over=None):
    """One training run of a rank (or of one card without ``mesh``):
    the job of ``config`` (default the train_mesh job) at ``cfg``,
    ``steps`` timed steps after a warm-up, the launch counts set to 0
    just before the timed steps and read just after; ``rows`` (count,
    index) keeps this batch rank's rows ``index::count`` of every batch;
    ``one_row``: each row its own microbatch; on a mesh whose
    ``context`` exceeds 1 each batch is placed context-sharded (this
    rank's tokens of its rows) and the flash launches are expected once
    a visiting shard under ``ring``; ``keep`` is handed the trained
    state before the run lets it go; ``ft_over``: more of the job's keys
    replaced."""
    import torch
    from gke_ray_train_tpu_torch.data import make_place_batch
    from gke_ray_train_tpu_torch.parallel.mesh import context_size
    job = _fine_tune_setup(dev, cfg, steps + 1, config=config, mesh=mesh,
                           ft_over={"LORA_DROPOUT": dropout,
                                    **(ft_over or {})},
                           transfer_guard=None,
                           **(plan or {"fused_ops": True}))
    if context_size(mesh) > 1:
        job["place"] = make_place_batch(dev, mesh=mesh)
    global_rows = job["batch_rows"]
    if rows is not None:
        job["batches"] = [{k: v[rows[1]::rows[0]] for k, v in b.items()}
                          for b in job["batches"]]
    if one_row:
        job["step_fn"] = _one_row_step(job, dev, mesh)
    grad_accum = (len(job["batches"][0]["inputs"]) if one_row
                  else job["plan"].grad_accum)
    counts = {}
    fn = job["step_fn"]

    def step(state, b):
        if not counts:
            counts["calls"] = 0
        if counts["calls"] == 1:
            _reset_launch_counts()
        counts["calls"] += 1
        return fn(state, b)
    job["step_fn"] = step
    r = _timed_steps(dev, job, steps)
    launches = _launch_counts()
    routes = _route_counts()
    r.update(launches_per_step={k: v / steps for k, v in launches.items()},
             routes=routes, tokens=global_rows * job["seq"],
             base_bytes=job["base_bytes"], grad_accum=grad_accum,
             want_launches=expected_launches(
                 job["cfg"], grad_accum, job["plan"].fused_ops,
                 full_ft=job["lcfg"] is None,
                 ring=(context_size(mesh) if job["cfg"].attn_impl == "ring"
                       else 1)),
             n_layers=job["cfg"].n_layers)
    if keep is not None:
        keep(job["state"])
    del job
    _release()
    return r, launches


@contextlib.contextmanager
def _tf32_off():
    """float32 products in full precision (no TF32) inside the block."""
    import torch
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = was


def _tp_fp32_cfg():
    return _llama_cfg(FINE_TUNE_CONFIG, TP_PARITY_LAYERS, dtype="float32",
                      param_dtype="float32")


def _tp_worker(out_path):
    """One of train_tp's two ranks on the one card (env: RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT): a gloo group with the card's
    tensors, the model 2 x fsdp 1 mesh, the collectives probed
    (``TP_PROBE``); if those the path makes run, the train_mesh job at ``TP_LAYERS`` layers
    (dropout 0, 1 + ``TP_STEPS`` steps), then at LORA_DROPOUT
    ``TP_DROPOUT`` (1 + 1
    steps) with the digests of the first masks drawn."""
    import torch
    import torch.distributed as dist
    from gke_ray_train_tpu_torch.parallel import MeshConfig, build_mesh
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method="env://")
    rank = dist.get_rank()
    rec = {"rank": rank, "backend": dist.get_backend(),
           "device_name": torch.cuda.get_device_name(dev)}
    try:
        mesh = build_mesh(MeshConfig(fsdp=1, model=TP_MODEL),
                          device_type="cuda")
        rec["probe"] = _tp_probe(dev, mesh)
        if all(rec["probe"][k] == "ok" for k, need in TP_PROBE.items()
               if need):
            cfg = _llama_cfg(FINE_TUNE_CONFIG, TP_LAYERS)
            rec["run"], rec["launches"] = _tp_rank_run(
                dev, cfg, mesh, 0.0, TP_STEPS)
            (rec["dropout_run"], _), rec["masks"] = _first_masks(
                lambda: _tp_rank_run(dev, cfg, mesh, TP_DROPOUT, 1))
            with _tf32_off():
                rec["fp32_run"], _ = _tp_rank_run(
                    dev, _tp_fp32_cfg(), mesh, 0.0, TP_FP32_STEPS)
    finally:
        with open(out_path + f".{rank}", "w") as f:
            json.dump(rec, f)
        dist.barrier()
        dist.destroy_process_group()


def _spawn_ranks(flag, out, n, local_ranks, timeout):
    """``n`` processes of this script with ``flag out`` and torchrun's
    env (rank r on card ``local_ranks[r]``) under one deadline: (hung,
    exit codes, what each rank wrote)."""
    port = _free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(n),
                   LOCAL_RANK=str(local_ranks[rank]),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   HF_HUB_OFFLINE="1")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), flag, out],
            env=env, cwd=HERE))
    hung, rcs = _wait_all(procs, timeout)
    return hung, rcs, _read_ranks(out, n)


def _gaps(got, want):
    return [abs(a - b) / abs(b) for a, b in zip(got, want)]


def _hold_streams(name, got, want, tol, problems,
                  held=("losses", "grad_norms")):
    """Every step's loss and grad_norm of ``got`` against ``want``'s,
    relative: the gaps; a problem where one is not finite or, for the
    streams in ``held``, off."""
    gaps = {}
    for key in ("losses", "grad_norms"):
        g = _gaps(got[key], want[key])
        gaps[key] = g
        if not (len(g) == len(want[key]) and all(np.isfinite(got[key]))
                and (key not in held or max(g) <= tol)):
            problems.append(f"{name}: {key} {got[key]} against {want[key]}")
    return gaps


def phase_train_tp(dev):
    """Tensor parallelism on the one-card host: the train_mesh job
    (Llama-3.1-8B QLoRA, FUSED_OPS=1, the job's rows) at full width cut
    to 4 layers, first in this process, then as two ranks of this card
    at model 2 x fsdp 1 over gloo (``_tp_worker``), whose collectives are
    probed first. Where they run: both ranks' losses and grad_norms of 1
    + 2 steps within MESH_MULTI_RTOL of this process's, per step the
    launches of the unmeshed step (flash on 16 of 32 query heads, the
    cross-entropy on a 64,128-column vocab shard, all on wgmma); then at
    LORA_DROPOUT 0.1 finite losses, the first masks of the column-parallel
    projections equal across the ranks and of the row-parallel ones
    different; then the job in fp32 (TF32 off) at 2 layers, 1 + 1 steps,
    within MESH_LOSS_RTOL of this process's. Where a collective is missing on gloo the line says which,
    and the phase holds the kernels at these inputs alone (the kernels
    phase's local-head and vocab-shard cases); the TP path then runs on
    the four-card host only (train_tp_multi)."""
    import tempfile
    cfg = _llama_cfg(FINE_TUNE_CONFIG, TP_LAYERS)
    ref, _ = _tp_rank_run(dev, cfg, None, 0.0, TP_STEPS)
    with _tf32_off():
        ref32, _ = _tp_rank_run(dev, _tp_fp32_cfg(), None, 0.0,
                                TP_FP32_STEPS)
    out = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_tp_"), "rank")
    hung, rcs, ranks = _spawn_ranks("--tp-worker", out, TP_MODEL,
                                    [0] * TP_MODEL, TP_TIMEOUT_S)
    problems, line = [], {"phase": "train_tp", "nvidia_smi":
                          nvidia_smi_line(), "model": cfg.name,
                          "n_layers": cfg.n_layers, "mesh": {
                              "data": 1, "fsdp": 1, "model": TP_MODEL},
                          "backend": "gloo", "ranks_on_one_card": TP_MODEL,
                          "one_process": ref, "one_process_fp32": ref32}
    if hung or any(rcs) or None in ranks:
        problems.append(f"ranks hung {hung}, exit codes {rcs}")
        line["ranks"] = ranks
    probe = ranks[0].get("probe", {}) if ranks[0] else {}
    missing = {k: v for k, v in probe.items()
               if v != "ok" and TP_PROBE[k]}
    line["probe"] = probe
    launches = None
    if not problems and missing:
        # gloo lacks a collective on the card's tensors: no TP run here
        line["tp_run"] = "not run: gloo misses " + ", ".join(sorted(missing))
        line["held_instead"] = ("kernels phase: flash / RoPE at the local "
                                "heads, rows 4-6 over 2 and 4 vocab shards")
    elif not problems:
        line["ranks"] = ranks
        gaps = {}
        for r in ranks:
            run = r["run"]
            gaps[r["rank"]] = {
                "bf16": _hold_streams(f"rank {r['rank']}", run, ref,
                                      MESH_MULTI_RTOL, problems),
                "fp32": _hold_streams(f"rank {r['rank']} fp32",
                                      r["fp32_run"], ref32, MESH_LOSS_RTOL,
                                      problems)}
            for key in ("run", "fp32_run"):
                got = r[key]
                if got["launches_per_step"] != got["want_launches"]:
                    problems.append(f"rank {r['rank']} {key} launches per "
                                    f"step {got['launches_per_step']} != "
                                    f"{got['want_launches']}")
            ce = {k: v for k, v in run["routes"].items()
                  if k.startswith("fused_ce")}
            if any(n and route != "wgmma" for rr in ce.values()
                   for route, n in rr.items()):
                problems.append(f"rank {r['rank']} CE routes {ce}")
            if not all(np.isfinite(r["dropout_run"]["losses"])):
                problems.append(f"rank {r['rank']}: dropout run losses "
                                f"{r['dropout_run']['losses']}")
        m0, m1 = ranks[0]["masks"], ranks[1]["masks"]
        col = {k: m0[k]["digest"] == m1[k]["digest"]
               for k in ("wq", "wk", "wv", "w_gate", "w_up")}
        row = {k: m0[k]["digest"] != m1[k]["digest"]
               for k in ("wo", "w_down")}
        if not (all(col.values()) and all(row.values())):
            problems.append(f"masks: column equal {col}, row differ {row}")
        line.update(rel_gaps=gaps, tol_rel={"bf16": MESH_MULTI_RTOL,
                                            "fp32": MESH_LOSS_RTOL},
                    masks_column_equal=col, masks_row_differ=row,
                    dropout=TP_DROPOUT, p50_ratio=[
                        r["run"]["step_s_p50"] / ref["step_s_p50"]
                        for r in ranks])
        launches = {}
        for r in ranks:
            for k, n in r["launches"].items():
                launches[k] = launches.get(k, 0) + n
    line.update(ok=not problems, problems=problems)
    emit(line)
    if problems:
        raise SystemExit("train_tp phase failed: " + "; ".join(problems))
    return launches


def _tp_allreduce_bytes(cfg, mb_rows, seq, grad_accum):
    """Bytes a rank all-reduces over ``model`` in a step, from the
    shapes, per microbatch: each layer's attention and MLP outputs (the
    row-parallel partial sums) in the forward and again in the
    recomputation under remat, and the gradients of their inputs in the
    backward, all ``[rows, seq, d_model]`` in the compute dtype; the
    embedding's rows and the fused loss's dx (the same size each), and
    its row statistics (3 fp32 a token)."""
    import torch
    es = torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    tok = mb_rows * seq
    per_layer = 2 * (2 if cfg.remat else 1) + 2
    return grad_accum * ((per_layer * cfg.n_layers + 2) * tok * cfg.d_model
                         * es + 3 * 4 * tok)


def _tp_multi_worker(out_path):
    """One rank of train_tp_multi (NCCL, one card a rank): the 70B job
    on fsdp 1 x model N at ``TP_70B_REF_LAYERS`` and ``TP_70B_LAYERS``
    layers, then the train_mesh job (dropout off, one-row microbatches)
    on each of ``TP_MULTI_MESHES``."""
    import torch
    import torch.distributed as dist
    from gke_ray_train_tpu_torch.parallel import (
        MeshConfig, build_mesh, distributed_init)
    from gke_ray_train_tpu_torch.parallel.placement import (
        input_shard_layout)
    dev = distributed_init()
    rank, world = dist.get_rank(), dist.get_world_size()
    rec = {"rank": rank, "world": world,
           "device_name": torch.cuda.get_device_name(dev)}
    try:
        mesh = build_mesh(MeshConfig(fsdp=-1, model=world))
        for key, layers in (("70b_ref", TP_70B_REF_LAYERS),
                            ("70b", TP_70B_LAYERS)):
            cfg = _llama_cfg(FT_70B_CONFIG, layers, param_dtype="float32")
            torch.cuda.reset_peak_memory_stats()
            r, launches = _tp_rank_run(dev, cfg, mesh, 0.0, MESH_STEPS,
                                       config=FT_70B_CONFIG,
                                       plan=TP_70B_PLAN)
            r["tokens_per_s_per_card"] = r["tokens"] / r["step_s_p50"] / world
            r["allreduce_bytes_per_step"] = _tp_allreduce_bytes(
                cfg, 1, cfg.max_seq_len, r["grad_accum"])
            rec[key] = r
            rec["launches"] = launches
        cfg8 = _llama_cfg(FINE_TUNE_CONFIG, 32)
        for key, kw in TP_MULTI_MESHES.items():
            m = build_mesh(MeshConfig(**kw))
            r, _ = _tp_rank_run(dev, cfg8, m, 0.0, MESH_STEPS,
                                rows=input_shard_layout(m), one_row=True)
            r["tokens_per_s_per_card"] = r["tokens"] / r["step_s_p50"] / world
            rec[key] = r
    finally:
        with open(out_path + f".{rank}", "w") as f:
            json.dump(rec, f)
        dist.barrier()
        dist.destroy_process_group()


def phase_train_tp_multi(dev):
    """Opt-in, the four-card host (fewer than 4 cards fails). Prints the
    card count first. One card first: the 70B job
    (ray-jobs/fine_tune_config_70b.json: full fine-tuning, bf16 compute
    over fp32 masters, AdamW, 1 x 8 rows of 1,024, FUSED_OPS=1) at
    ``TP_70B_REF_LAYERS`` layer, and the train_mesh job with dropout off
    as one-row microbatches. Then one rank a card over NCCL
    (``_tp_multi_worker``): the 70B job on fsdp 1 x model 4 at the same
    depth, each step's loss and grad_norm within MESH_MULTI_RTOL of the
    one card's, and at ``TP_70B_LAYERS`` layers its per-card p50,
    tokens/s, peak memory and the bytes all-reduced a step (from the
    shapes); the 8B job at data 2 x fsdp 2 and fsdp 2 x model 2, each
    within MESH_MULTI_RTOL of the one card. Last the entry under torchrun
    at MESH_MODEL 2 (``_multi_entry``): every rank exits 0 and the
    sharded export converts to finite tensors."""
    import tempfile
    import torch
    n = torch.cuda.device_count()
    emit({"phase": "train_tp_multi_devices", "ok": n >= 4,
          "device_count": n, "nvidia_smi": nvidia_smi_line()})
    if n < 4:
        raise SystemExit(f"train_tp_multi needs 4 cards; this host has {n}")
    ref70, _ = _tp_rank_run(
        dev, _llama_cfg(FT_70B_CONFIG, TP_70B_REF_LAYERS,
                        param_dtype="float32"),
        None, 0.0, MESH_STEPS, config=FT_70B_CONFIG, plan=TP_70B_PLAN)
    ref8 = _multi_reference(dev)
    torch.cuda.empty_cache()
    out = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_tp_multi_"),
                       "rank")
    hung, rcs, ranks = _spawn_ranks("--tp-multi-worker", out, n,
                                    list(range(n)), TP_MULTI_TIMEOUT_S)
    problems, gaps = [], {}
    line = {"phase": "train_tp_multi", "nvidia_smi": nvidia_smi_line(),
            "world": n, "one_card": {"70b_ref": ref70, "8b": ref8},
            "cut": {"70b": f"{TP_70B_LAYERS} of 80 layers (held against one "
                    f"card at {TP_70B_REF_LAYERS}), FUSED_OPS=1, 1 + "
                    f"{MESH_STEPS} steps", "8b": "LORA_DROPOUT 0, one-row "
                    "microbatches, 1 + 3 steps"}}
    if hung or any(rcs) or None in ranks:
        problems.append(f"ranks hung {hung}, exit codes {rcs}")
    else:
        for r in ranks:
            gaps[r["rank"]] = {
                "70b_ref": _hold_streams(f"rank {r['rank']} 70B",
                                         r["70b_ref"], ref70,
                                         MESH_MULTI_RTOL, problems),
                **{k: _hold_streams(f"rank {r['rank']} 8B {k}", r[k], ref8,
                                    MESH_MULTI_RTOL, problems)
                   for k in TP_MULTI_MESHES}}
            for key in ("70b_ref", "70b"):
                run = r[key]
                if run["launches_per_step"] != run["want_launches"]:
                    problems.append(f"rank {r['rank']} {key} launches "
                                    f"{run['launches_per_step']} != "
                                    f"{run['want_launches']}")
    line.update(ranks=ranks, rel_gaps=gaps, tol_rel=MESH_MULTI_RTOL)
    entry, entry_problems = _multi_entry(n, TP_MULTI_ENTRY)
    problems += entry_problems
    line.update(entry=entry, ok=not problems, problems=problems)
    emit(line)
    if problems:
        raise SystemExit("train_tp_multi phase failed: "
                         + "; ".join(problems))
    if ranks and None not in ranks:
        launches = {}
        for r in ranks:
            for k, v in r["launches"].items():
                launches[k] = launches.get(k, 0) + v
        return launches
    return None


# ---------------------------------------------------------------------------
# context parallelism: ring and all-to-all attention over `context`
# ---------------------------------------------------------------------------

CP_CONTEXT = 2
CP_IMPLS = ("a2a", "ring")
# train_cp's cut of the Gemma-2 4k job: one 4,096-token row a step (the
# job's 4 microbatches cut to 1 for the run's time) at full width,
# CP_LAYERS of its 42 layers deep (train_cp_multi runs all 42)
CP_PLAN = {"fused_ops": True, "grad_accum": 1}
CP_LAYERS = 8
CP_FP32_LAYERS = 2
# train_cp's runs, one process and ranks, bf16 and fp32: 1 + 1 steps (1 + 3
# until train_overlap's time was paid for)
CP_STEPS = 1
CP_TIMEOUT_S = 600
# the collectives the context path makes on the card's tensors as they
# are, probed before the job (the ring's send / recv and the all-to-all
# stage through host memory under gloo, ops/ring_attention.py::
# TRANSPORT): the token sums over context, the adapters' all-reduce and
# broadcast over the world, FSDP2's all-gather on the fsdp group
CP_PROBE = ("all_reduce_sum_f32_context", "broadcast_f32_world",
            "all_gather_into_tensor_fsdp")
# train_cp_multi on the four-card host: the job's own layout cut to four
# cards, fsdp 2 x context 2, at full width and depth, one-row
# microbatches (the job's 4 rows a step)
CP_MULTI_MESH = dict(fsdp=2, context=2)
CP_MULTI_PLAN = {"fused_ops": True}
CP_MULTI_TIMEOUT_S = 1200


def _gemma_cfg(impl, n_layers=42, dtype="bfloat16"):
    """Gemma-2-9B of the 4k job at full width, ``n_layers`` deep, remat
    on, at ``impl`` attention."""
    return dataclasses.replace(
        _llama_cfg(GEMMA2_CONFIG, n_layers, dtype=dtype, param_dtype=dtype),
        attn_impl=impl)


def _cp_probe(dev, mesh):
    """Each collective of ``CP_PROBE`` once on this card's tensors:
    {name: "ok" or the error}."""
    import torch
    import torch.distributed as dist
    ctx, fsdp = mesh["context"].get_group(), mesh["fsdp"].get_group()
    n = mesh["fsdp"].size()
    calls = {
        "all_reduce_sum_f32_context": lambda: dist.all_reduce(
            torch.ones(64, device=dev), group=ctx),
        "broadcast_f32_world": lambda: dist.broadcast(
            torch.ones(64, device=dev), src=0),
        "all_gather_into_tensor_fsdp": lambda: dist.all_gather_into_tensor(
            torch.empty(64 * n, dtype=torch.uint8, device=dev),
            torch.ones(64, dtype=torch.uint8, device=dev), group=fsdp)}
    out = {}
    for name in CP_PROBE:
        try:
            calls[name]()
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as e:  # noqa: BLE001 - the probe reports it
            out[name] = f"{type(e).__name__}: {e}"[:400]
    return out


def _cp_run(dev, cfg, mesh, dropout=0.0, steps=MESH_STEPS, plan=None,
            **kw):
    """``_tp_rank_run`` of the Gemma-2 4k job (``plan``, default
    ``CP_PLAN``), context-sharded on a mesh; with the transport the ring /
    all-to-all last used."""
    from gke_ray_train_tpu_torch.ops.ring_attention import TRANSPORT
    TRANSPORT["last"] = None
    r, launches = _tp_rank_run(dev, cfg, mesh, dropout, steps,
                               config=GEMMA2_CONFIG, plan=plan or CP_PLAN,
                               **kw)
    r["transport"] = TRANSPORT["last"]
    return r, launches


def _cp_worker(out_path):
    """One of train_cp's two ranks on the one card (env: RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT): a gloo group with the card's
    tensors, the fsdp 1 x context 2 mesh, the collectives probed
    (``CP_PROBE``); if they run,
    the Gemma-2 4k job under each of ``CP_IMPLS`` (1 + ``CP_STEPS``
    steps, dropout
    0), at the job's LORA_DROPOUT under a2a (``CP_FP32_LAYERS`` layers,
    1 + 1 steps, the digests of the first masks), then in fp32 at
    ``CP_FP32_LAYERS`` layers."""
    import torch
    import torch.distributed as dist
    from gke_ray_train_tpu_torch.parallel import MeshConfig, build_mesh
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method="env://")
    rank = dist.get_rank()
    rec = {"rank": rank, "backend": dist.get_backend(),
           "device_name": torch.cuda.get_device_name(dev)}
    try:
        mesh = build_mesh(MeshConfig(fsdp=1, context=CP_CONTEXT),
                          device_type="cuda")
        rec["context_rank"] = mesh["context"].get_local_rank()
        rec["probe"] = _cp_probe(dev, mesh)
        if all(v == "ok" for v in rec["probe"].values()):
            rec["launches"] = {}
            for impl in CP_IMPLS:
                torch.cuda.reset_peak_memory_stats()
                rec[impl], launches = _cp_run(
                    dev, _gemma_cfg(impl, CP_LAYERS), mesh, steps=CP_STEPS)
                for k, v in launches.items():
                    rec["launches"][k] = rec["launches"].get(k, 0) + v
            with open(GEMMA2_CONFIG) as f:
                drop = float(json.load(f)["LORA_DROPOUT"])
            # the masks at the width of the step, two layers deep
            (rec["dropout_run"], _), rec["masks"] = _first_masks(
                lambda: _cp_run(dev, _gemma_cfg("a2a", CP_FP32_LAYERS),
                                mesh, drop, 1))
            with _tf32_off():
                for impl in CP_IMPLS:
                    rec[f"fp32_{impl}"], _ = _cp_run(
                        dev, _gemma_cfg(impl, CP_FP32_LAYERS, "float32"),
                        mesh, steps=CP_STEPS)
    finally:
        with open(out_path + f".{rank}", "w") as f:
            json.dump(rec, f)
        dist.barrier()
        dist.destroy_process_group()


def phase_train_cp(dev):
    """Context parallelism on the one-card host: the Gemma-2 4k job
    (ray-jobs/fine_tune_config_gemma2_4k.json: Gemma-2-9B QLoRA at full
    width and depth, one packed 4,096-token row a step of ``CP_PLAN``,
    FUSED_OPS=1) first in this process (a2a without a context axis is
    the flash path), then as two ranks of this card at fsdp 1 x context
    2 over gloo (``_cp_worker``), whose collectives are probed first.
    Where those the path makes run: under a2a (as shipped) and under
    ring, both ranks' losses and grad_norms of 1 + ``CP_STEPS`` steps within
    MESH_MULTI_RTOL of this process's; per step the launches (flash once
    a layer and forward under a2a on 8 of 16 query heads over the whole
    row, C times under ring on the rank's 2,048 tokens); at the job's
    LORA_DROPOUT every projection's first mask differs between the
    context ranks; then the job in fp32 (TF32 off) at ``CP_FP32_LAYERS``
    layers under both, within MESH_LOSS_RTOL of this process's. Each
    rank's peak memory beside the card's name and power limit; the
    ranks' ring / all-to-all transport is host-staged under gloo (its
    times say nothing of a context-parallel step's speed: NCCL's path is
    train_cp_multi's)."""
    import tempfile
    ref, _ = _cp_run(dev, _gemma_cfg("a2a", CP_LAYERS), None, steps=CP_STEPS)
    with _tf32_off():
        ref32, _ = _cp_run(dev, _gemma_cfg("a2a", CP_FP32_LAYERS, "float32"),
                           None, steps=CP_STEPS)
    out = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_cp_"), "rank")
    hung, rcs, ranks = _spawn_ranks("--cp-worker", out, CP_CONTEXT,
                                    [0] * CP_CONTEXT, CP_TIMEOUT_S)
    cfg = _gemma_cfg("a2a", CP_LAYERS)
    problems, line = [], {"phase": "train_cp", "nvidia_smi":
                          nvidia_smi_line(), "model": cfg.name,
                          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
                          "seq": cfg.max_seq_len, "mesh": {
                              "data": 1, "fsdp": 1,
                              "context": CP_CONTEXT},
                          "impls": list(CP_IMPLS), "plan": CP_PLAN,
                          "cut": "GRADIENT_ACCUMULATION_STEPS 4 -> 1 (one "
                          f"4,096-token row a step); {CP_LAYERS} of 42 "
                          "layers at full width",
                          "backend": "gloo", "ranks_on_one_card": CP_CONTEXT,
                          "one_process": ref, "one_process_fp32": ref32}
    if hung or any(rcs) or None in ranks:
        problems.append(f"ranks hung {hung}, exit codes {rcs}")
        line["ranks"] = ranks
    probe = ranks[0].get("probe", {}) if ranks and ranks[0] else {}
    line["probe"] = probe
    missing = {k: v for k, v in probe.items() if v != "ok"}
    if not problems and missing:
        problems.append("gloo misses " + ", ".join(sorted(missing)))
    launches = None
    if not problems:
        line["ranks"] = ranks
        gaps = {}
        for r in ranks:
            g = gaps[r["rank"]] = {}
            for impl in CP_IMPLS:
                run = r[impl]
                g[impl] = _hold_streams(f"rank {r['rank']} {impl}", run, ref,
                                        MESH_MULTI_RTOL, problems)
                g[f"fp32_{impl}"] = _hold_streams(
                    f"rank {r['rank']} fp32 {impl}", r[f"fp32_{impl}"],
                    ref32, MESH_LOSS_RTOL, problems)
                for key in (impl, f"fp32_{impl}"):
                    got = r[key]
                    if got["launches_per_step"] != got["want_launches"]:
                        problems.append(
                            f"rank {r['rank']} {key} launches per step "
                            f"{got['launches_per_step']} != "
                            f"{got['want_launches']}")
                    if got["transport"] != "host":
                        problems.append(f"rank {r['rank']} {key}: transport "
                                        f"{got['transport']}")
            if not all(np.isfinite(r["dropout_run"]["losses"])):
                problems.append(f"rank {r['rank']}: dropout run losses "
                                f"{r['dropout_run']['losses']}")
        m0, m1 = ranks[0]["masks"], ranks[1]["masks"]
        differ = {k: m0[k]["digest"] != m1[k]["digest"]
                  and m0[k]["shape"] == m1[k]["shape"] for k in m0}
        if len(differ) != 7 or not all(differ.values()):
            problems.append(f"masks across context ranks: {differ}")
        line.update(rel_gaps=gaps, tol_rel={"bf16": MESH_MULTI_RTOL,
                                            "fp32": MESH_LOSS_RTOL},
                    masks_differ=differ,
                    transport="host: gloo's send / recv abort on a CUDA "
                    "pointer (writev: Bad address)",
                    peak_mem_bytes={r["rank"]: {
                        impl: r[impl]["peak_mem_bytes"] for impl in CP_IMPLS}
                        for r in ranks},
                    p50_ratio={impl: [r[impl]["step_s_p50"]
                                      / ref["step_s_p50"] for r in ranks]
                               for impl in CP_IMPLS})
        launches = {}
        for r in ranks:
            for k, n in r["launches"].items():
                launches[k] = launches.get(k, 0) + n
    line.update(ok=not problems, problems=problems)
    emit(line)
    if problems:
        raise SystemExit("train_cp phase failed: " + "; ".join(problems))
    return launches


def _cp_multi_worker(out_path):
    """One rank of train_cp_multi (NCCL, one card a rank): the Gemma-2 4k
    job on ``CP_MULTI_MESH`` at full width and depth, one-row
    microbatches of the rank's batch rows, under each of ``CP_IMPLS``;
    after the a2a run its state saved (``<out>.ckpt``) with the digests
    of its adapters and of one block's NF4 codes whole."""
    import torch
    import torch.distributed as dist
    from gke_ray_train_tpu_torch.ckpt import CheckpointManager
    from gke_ray_train_tpu_torch.parallel import (
        MeshConfig, build_mesh, distributed_init)
    from gke_ray_train_tpu_torch.parallel.placement import (
        input_shard_layout)
    dev = distributed_init()
    rank, world = dist.get_rank(), dist.get_world_size()
    rec = {"rank": rank, "world": world, "backend": dist.get_backend(),
           "device_name": torch.cuda.get_device_name(dev)}
    saved = {}

    def keep_state(job_state):
        saved["state"] = job_state
    try:
        mesh = build_mesh(MeshConfig(**CP_MULTI_MESH))
        rec["context_rank"] = mesh["context"].get_local_rank()
        rows = input_shard_layout(mesh)
        rec["launches"] = {}
        for impl in CP_IMPLS:
            torch.cuda.reset_peak_memory_stats()
            r, launches = _cp_run(dev, _gemma_cfg(impl), mesh,
                                  plan=CP_MULTI_PLAN, rows=rows,
                                  one_row=True,
                                  keep=keep_state if impl == "a2a" else None)
            r["tokens_per_s_per_card"] = r["tokens"] / r["step_s_p50"] / world
            rec[impl] = r
            for k, v in launches.items():
                rec["launches"][k] = rec["launches"].get(k, 0) + v
            if impl == "a2a":
                st = saved.pop("state")
                mgr = CheckpointManager(out_path + ".ckpt",
                                        score_attribute=None)
                t = time.perf_counter()
                mgr.save(st.step, st, force=True)
                mgr.close()
                rec["save_s"] = time.perf_counter() - t
                rec["digests"] = {
                    f"lora/{i}.{p}.{ab}": _digest(layer[p][ab])
                    for i, layer in enumerate(st.lora) for p in layer
                    for ab in ("a", "b")}
                codes = st.params.blocks[0].wq.codes
                rec["digests"]["params/blocks.0.wq.codes"] = _digest(
                    codes.full_tensor())
                del st
                _release()
    finally:
        with open(out_path + f".{rank}", "w") as f:
            json.dump(rec, f)
        dist.barrier()
        dist.destroy_process_group()


def phase_train_cp_multi(dev):
    """Opt-in, the four-card host (fewer than 4 cards fails). The Gemma-2
    4k job's own layout (fsdp 8 x context 2) cut to four cards: fsdp 2 x
    context 2 over NCCL, Gemma-2-9B at full width and depth, the job's 4
    rows a step as one-row microbatches, under a2a and ring, each rank's
    losses and grad_norms of 1 + 3 steps within MESH_MULTI_RTOL of this
    card's unmeshed run of the same rows; per card p50, tokens/s and
    peak memory beside the card's name and power limit. After the a2a
    run the ranks save their state (the NF4 base replicated over context
    and sharded over fsdp, the adapters); one process reads it back
    (``restore_raw``, at world 1): every adapter and block 0's wq codes
    equal what the ranks held, by digest."""
    import shutil
    import tempfile
    import torch
    n = torch.cuda.device_count()
    emit({"phase": "train_cp_multi_devices", "ok": n >= 4,
          "device_count": n, "nvidia_smi": nvidia_smi_line()})
    if n < 4:
        raise SystemExit(f"train_cp_multi needs 4 cards; this host has {n}")
    ref, _ = _cp_run(dev, _gemma_cfg("a2a"), None, plan=CP_MULTI_PLAN,
                     one_row=True)
    ref["tokens_per_s"] = ref["tokens"] / ref["step_s_p50"]
    _release()
    root = tempfile.mkdtemp(prefix="chip_smoke_cp_multi_")
    try:
        out = os.path.join(root, "rank")
        hung, rcs, ranks = _spawn_ranks("--cp-multi-worker", out, 4,
                                        list(range(4)), CP_MULTI_TIMEOUT_S)
        problems, gaps = [], {}
        line = {"phase": "train_cp_multi", "nvidia_smi": nvidia_smi_line(),
                "world": 4, "mesh": CP_MULTI_MESH, "impls": list(CP_IMPLS),
                "one_card": ref, "cut": "the job's fsdp 8 x context 2 on "
                "four cards: fsdp 2 x context 2; one-row microbatches, "
                "1 + 3 steps"}
        if hung or any(rcs) or None in ranks:
            problems.append(f"ranks hung {hung}, exit codes {rcs}")
        else:
            for r in ranks:
                gaps[r["rank"]] = {impl: _hold_streams(
                    f"rank {r['rank']} {impl}", r[impl], ref,
                    MESH_MULTI_RTOL, problems) for impl in CP_IMPLS}
                for impl in CP_IMPLS:
                    run = r[impl]
                    if run["launches_per_step"] != run["want_launches"]:
                        problems.append(f"rank {r['rank']} {impl} launches "
                                        f"{run['launches_per_step']} != "
                                        f"{run['want_launches']}")
                    if run["transport"] != "direct":
                        problems.append(f"rank {r['rank']} {impl}: "
                                        f"transport {run['transport']}")
            from gke_ray_train_tpu_torch.ckpt import CheckpointManager
            mgr = CheckpointManager(out + ".ckpt", score_attribute=None)
            t = time.perf_counter()
            raw = mgr.restore_raw()
            restore_s = time.perf_counter() - t
            mgr.close()
            got = {}
            for i, layer in enumerate(raw["lora"]):
                for p, ab in layer.items():
                    for k, v in ab.items():
                        got[f"lora/{i}.{p}.{k}"] = _digest(v)
            got["params/blocks.0.wq.codes"] = _digest(
                raw["params"]["blocks.0.wq.codes"])
            want = ranks[0]["digests"]
            differ = sorted(k for k in want if got.get(k) != want[k])
            if differ or any(r["digests"] != want for r in ranks):
                problems.append(f"restored at world 1: {len(differ)} "
                                f"entries differ {differ[:4]}")
            line["restore"] = {"entries_held": len(want),
                               "differ": differ, "restore_s": restore_s,
                               "save_s": [r["save_s"] for r in ranks]}
        line.update(ranks=ranks, rel_gaps=gaps, tol_rel=MESH_MULTI_RTOL,
                    ok=not problems, problems=problems)
        emit(line)
        if problems:
            raise SystemExit("train_cp_multi phase failed: "
                             + "; ".join(problems))
        launches = {}
        for r in ranks:
            for k, v in r["launches"].items():
                launches[k] = launches.get(k, 0) + v
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# the Mixture-of-Experts slice: Mixtral-8x7B
# ---------------------------------------------------------------------------

MIXTRAL_CONFIG = os.path.join(HERE, "ray-jobs",
                              "fine_tune_config_mixtral.json")
# train_moe's cut of the Mixtral job (1,000 rows, ~125 steps, an eval of
# 200 rows every 50): one warm-up and 2 timed steps, one eval pass of 8
# held-out rows after step 3
MOE_STEPS = 2
MOE_EVAL_ROWS = 8
# and its depth: 8 of the 32 layers at full width (one card holds all
# 32: train_ep_multi's one-card reference and train_moe_profile run them)
MOE_LAYERS = 8
# the NF4 store of the MoE train phases: two codes a byte (base 26.7 GB
# in place of 49.9 GB with int8 codes)
MOE_STORE = "uint4"


@contextlib.contextmanager
def _quant_store(store):
    """``QUANT_STORE`` set to ``store`` inside the block, restored after
    (the port reads it at each quantization)."""
    old = os.environ.get("QUANT_STORE")
    os.environ["QUANT_STORE"] = store
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("QUANT_STORE", None)
        else:
            os.environ["QUANT_STORE"] = old


class _MoeProbe:
    """While entered (and ``enabled``), ``ops.moe.moe_mlp`` is wrapped:
    each call's routing is read again (``moe.route``, no grad) and summed
    on the device, so nothing waits for the card inside the loop: the
    (token, slot) assignments kept and dropped, over all tokens and over
    tokens of weight > 0, the router aux and the calls (training
    forwards, remat recomputations and eval forwards alike). ``read()``
    after the run."""

    def __init__(self, dev, enabled=True):
        self.dev, self.enabled = dev, enabled

    def __enter__(self):
        if not self.enabled:
            return self
        import torch
        from gke_ray_train_tpu_torch.ops import moe
        self._orig = orig = moe.moe_mlp
        self.sums = sums = torch.zeros(6, dtype=torch.float64,
                                       device=self.dev)

        def probed(x, router_w, w_gate, w_up, w_down, cfg, dtype,
                   weights=None, mesh=None):
            y, aux = orig(x, router_w, w_gate, w_up, w_down, cfg, dtype,
                          weights=weights, mesh=mesh)
            with torch.no_grad():
                r = moe.route(x, router_w, cfg,
                              context=moe.context_group(mesh))
                real = (torch.ones_like(r.keep) if weights is None else
                        (weights > 0)[..., None].expand_as(r.keep))
                sums[0] += r.keep.sum()
                sums[1] += (~r.keep).sum()
                sums[2] += (r.keep & real).sum()
                sums[3] += (~r.keep & real).sum()
                sums[4] += aux.detach()
                sums[5] += 1
            return y, aux
        moe.moe_mlp = probed
        return self

    def __exit__(self, *exc):
        if self.enabled:
            from gke_ray_train_tpu_torch.ops import moe
            moe.moe_mlp = self._orig

    def read(self):
        kept, dropped, kept_real, dropped_real, aux, calls = (
            float(v) for v in self.sums.cpu())
        return {"moe_calls": int(calls),
                "router_aux_mean": aux / max(calls, 1.0),
                "assignments": int(kept + dropped),
                "dropped_share": dropped / max(kept + dropped, 1.0),
                "dropped_share_real_tokens": dropped_real / max(
                    kept_real + dropped_real, 1.0)}


@contextlib.contextmanager
def _moe_ranges(enabled=True):
    """While entered (and ``enabled``), ``ops.quant.dequantize`` and
    ``ops.moe.moe_mlp`` run inside ``torch.profiler.record_function``
    ranges (``chip_smoke::dequantize``, ``chip_smoke::moe_mlp``), which
    ``_moe_groups`` reads back from the trace."""
    if not enabled:
        yield
        return
    from torch.profiler import record_function
    from gke_ray_train_tpu_torch.ops import moe, quant
    orig = (quant.dequantize, moe.moe_mlp)

    def ranged(name, fn):
        def inner(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return inner
    quant.dequantize = ranged("chip_smoke::dequantize", quant.dequantize)
    moe.moe_mlp = ranged("chip_smoke::moe_mlp", moe.moe_mlp)
    try:
        yield
    finally:
        quant.dequantize, moe.moe_mlp = orig


_GEMM_KEYS = ("nvjet", "gemm", "cutlass", "sm90_xmma")


def _moe_groups(events):
    """Device ms of a traced MoE step by group. Each kernel is tied to
    the host call that launched it (its ``correlation`` with a runtime or
    driver launch, then the CPU ops and ranges open on that thread at
    that moment): ``flash`` (the flash kernels), ``expert_gemm``
    (launched inside ``aten::bmm``, the expert FFN's products forward,
    recomputed and backward), ``dequantize`` (inside a
    ``chip_smoke::dequantize`` range: the banks' and the attention
    projections' NF4 lookups), ``moe_dispatch`` (the rest of
    ``moe_mlp``: routing, placing the tokens, the activation, the
    combine; and their backward, found by the sequence number autograd
    gives a backward function and the forward op it came from),
    ``other_gemm`` (the attention projections, LoRA, the head) and
    ``rest``."""
    launch, spans = {}, {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat"), e.get("args", {})
        if cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launch[args["correlation"]] = (e["tid"], e["ts"])
        elif cat in ("cpu_op", "user_annotation"):
            spans.setdefault(e["tid"], []).append(
                (e["ts"], e["ts"] + e.get("dur", 0), e["name"],
                 args.get("Sequence number")))
    points = {}
    for corr, (tid, ts) in launch.items():
        points.setdefault(tid, []).append((ts, corr))
    chain_of, moe_seqs = {}, set()
    for tid, sp in spans.items():
        sp.sort(key=lambda s: (s[0], -s[1]))
        stack, i = [], 0
        for ts, corr in sorted(points.get(tid, [])) + [(float("inf"),
                                                         None)]:
            while i < len(sp) and sp[i][0] <= ts:
                while stack and stack[-1][1] <= sp[i][0]:
                    stack.pop()
                if sp[i][3] is not None and not sp[i][2].startswith(
                        "autograd::") and any(
                        s[2] == "chip_smoke::moe_mlp" for s in stack):
                    moe_seqs.add(sp[i][3])
                stack.append(sp[i])
                i += 1
            while stack and stack[-1][1] < ts:
                stack.pop()
            if corr is not None:
                chain_of[corr] = tuple(stack)
    out = dict.fromkeys(("flash", "expert_gemm", "dequantize",
                         "moe_dispatch", "other_gemm", "rest"), 0.0)
    for e in events:
        if e.get("cat") != "kernel":
            continue
        name = e["name"]
        chain = chain_of.get(e.get("args", {}).get("correlation"), ())
        names = {s[2] for s in chain}
        if "flash_" in name:
            g = "flash"
        elif "aten::bmm" in names:
            g = "expert_gemm"
        elif "chip_smoke::dequantize" in names:
            g = "dequantize"
        elif "chip_smoke::moe_mlp" in names or any(
                s[2].startswith("autograd::engine::evaluate_function")
                and s[3] in moe_seqs for s in chain):
            g = "moe_dispatch"
        elif any(k in name for k in _GEMM_KEYS):
            g = "other_gemm"
        else:
            g = "rest"
        out[g] += e.get("dur", 0) / 1e3
    return out


def phase_train_moe(dev, cfg=None, steps: int = MOE_STEPS):
    """Mixtral-8x7B QLoRA at full width (d_model 4,096, 8 experts top 2,
    d_ff 14,336, vocab 32,000), ``MOE_LAYERS`` of its 32 layers, with
    ray-jobs/fine_tune_config_mixtral.json's settings through
    ``run_training`` (the train phase's ``_drive``): NF4 base from seed 0
    with ``QUANT_STORE=uint4``, quantized one expert slice at a time, LoRA
    r 64 / alpha 16 / dropout 0.05 on attention only, microbatch 1 x
    grad-accum 8 at 1,024 tokens, AdamW (lr 2e-4, wd 0.001), warmup-
    cosine, clip 0.3, on the offline SQL rows through the prefetcher,
    under TRANSFER_GUARD=disallow. One warm-up and ``steps`` timed steps,
    an eval pass of ``MOE_EVAL_ROWS`` held-out rows after step 3; per
    step the flash forward 2 x n_layers x 8 times, dQ and dK/dV
    n_layers x 8. The job's v5e-16 mesh (MESH_FSDP 4, MESH_MODEL 4)
    becomes one card."""
    with _quant_store(MOE_STORE):
        return phase_train(dev, cfg or _mixtral_cfg(MOE_LAYERS), steps,
                           config=MIXTRAL_CONFIG, phase="train_moe",
                           n_eval=MOE_EVAL_ROWS)


def phase_train_moe_profile(dev, cfg=None):
    """The profile of ``phase_train_profile`` over one step of the
    train_moe phase's job, with its device time by MoE group."""
    with _quant_store(MOE_STORE):
        phase_train_profile(dev, cfg, MIXTRAL_CONFIG,
                            phase="train_moe_profile")


def phase_train_moe_parity(dev, cfg=None, steps: int = 3):
    """fp32 (TF32 off), Mixtral at full width and 2 layers, QLoRA (NF4,
    r 64, dropout 0), 3 steps of 2 microbatches of 1,024 tokens: the
    flash kernels against dense attention (loss / grad_norm streams and
    the adapters' change within the train-parity bounds), and a uint4
    base against an int8 one, both through flash: the same codes, so the
    loss and grad_norm streams must be equal bitwise. Returns the flash
    launches of the two flash runs."""
    import torch
    from gke_ray_train_tpu_torch.models import mixtral_8x7b
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cfg is None:
        cfg = dataclasses.replace(
            mixtral_8x7b(dtype="float32", param_dtype="float32", remat=True),
            max_seq_len=1024, n_layers=2)
    rng = np.random.default_rng(80)
    batches = [_sft_batch(2, cfg.max_seq_len, cfg.vocab_size, rng)
               for _ in range(steps)]
    runs, used = {}, {}
    for label, impl, store in (("flash_int8", "flash", "int8"),
                               ("xla_int8", "xla", "int8"),
                               ("flash_uint4", "flash", "uint4")):
        before = _launch_counts()
        with _quant_store(store):
            runs[label] = _train_run(cfg, "qlora", impl, dev, steps, batches)
        used[label] = {k: v - before[k] for k, v in _launch_counts().items()}
    (got, d_got), (ref, d_ref), (u4, d_u4) = (
        runs["flash_int8"], runs["xla_int8"], runs["flash_uint4"])
    num = sum(float(torch.sum((d_got[n] - b) ** 2)) for n, b in d_ref.items())
    den = sum(float(torch.sum(b ** 2)) for b in d_ref.values())
    delta_rel = (num / den) ** 0.5 if den > 0 else float("inf")
    rel = {k: max(abs(a - b) / abs(b) for a, b in zip(got[k], ref[k]))
           for k in got}
    want = {k: v * steps for k, v in expected_launches(cfg, 2, False).items()}
    u4_bitwise = got == u4 and all(torch.equal(d_got[n], d_u4[n])
                                   for n in d_got)
    problems = []
    if not (all(v <= TRAIN_PARITY_RTOL for v in rel.values())
            and delta_rel <= TRAIN_PARITY_DELTA_RTOL):
        problems.append(f"flash against dense: {rel}, delta {delta_rel}")
    if got != u4:
        problems.append(f"uint4 streams {u4} != int8 streams {got}")
    if not all(np.isfinite(got["loss"] + ref["loss"])):
        problems.append("non-finite loss")
    for label in ("flash_int8", "flash_uint4"):
        if used[label] != want:
            problems.append(f"{label} launches {used[label]} != {want}")
    if any(used["xla_int8"].values()):
        problems.append(f"the dense run launched {used['xla_int8']}")
    emit({"phase": "train_moe_parity", "ok": not problems,
          "problems": problems, "dtype": "float32", "model": cfg.name,
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "experts": cfg.n_experts, "steps": steps,
          "tol_streams_rel": TRAIN_PARITY_RTOL,
          "tol_delta_rel": TRAIN_PARITY_DELTA_RTOL,
          "flash_vs_dense": {"kernel_run": got, "plain_run": ref,
                             "max_rel_err": rel,
                             "delta_rel_err": delta_rel},
          "uint4_vs_int8": {"uint4_run": u4, "bitwise_streams": got == u4,
                            "bitwise_adapters": u4_bitwise},
          "launches": used})
    if problems:
        raise SystemExit("train_moe_parity phase failed: "
                         + "; ".join(problems))
    return {k: used["flash_int8"][k] + used["flash_uint4"][k]
            for k, n in want.items() if n}


# served at 4 layers in fp32: each layer's banks are 5.64 GB
SERVE_MOE_LAYERS = 4


def phase_serve_moe(dev, cfg=None):
    """Mixtral at full width and ``SERVE_MOE_LAYERS`` layers in fp32 (TF32
    off; random weights from seed 2, about 24 GB) through ``BatchEngine``:
    8 requests over the 256 and 512 buckets, 4 slots, capacity_factor 4.0
    so that routing drops nothing (E / K = 4: JAX tests/test_kvcache.py's
    rule). Every completion must equal the sequential batch-1
    ``greedy_generate_cached`` token for token, and the flash kernel must
    run once per layer per prefill. Returns the engine's flash
    launches."""
    import torch
    from gke_ray_train_tpu_torch.models import (
        greedy_generate_cached, init_params, mixtral_8x7b)
    from gke_ray_train_tpu_torch.ops.flash_attention import flash_attention
    from gke_ray_train_tpu_torch.plan import ExecutionPlan
    from gke_ray_train_tpu_torch.serve import BatchEngine, form_prompt_buffer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cfg is None:
        cfg = dataclasses.replace(
            mixtral_8x7b(dtype="float32", param_dtype="float32",
                         remat=False),
            max_seq_len=512, n_layers=SERVE_MOE_LAYERS, capacity_factor=4.0)
    t0 = time.perf_counter()
    model = init_params(cfg, seed=2, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    plan = ExecutionPlan.from_kwargs(max_batch=4, decode_buckets="256,512")
    eos = (2,)
    reqs = _requests(8, cfg.vocab_size, seed=98, new=(8, 24))
    engine = BatchEngine(model, cfg, plan=plan, eos_ids=eos, device=dev)
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    t0 = time.perf_counter()
    comps = engine.run_until_drained(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_attention.launches
    stats = engine.stats()
    mismatched = []
    for r, c in zip(reqs, comps):
        buf, plen = form_prompt_buffer(r.token_ids, c.bucket)
        ref = greedy_generate_cached(
            model, buf, [plen], cfg, max_new_tokens=r.max_new_tokens,
            eos_ids=eos, device=dev)
        if not np.array_equal(ref[0].cpu().numpy(), c.tokens):
            mismatched.append(r.rid)
    buckets = sorted({c.bucket for c in comps})
    gen = [c.length - c.prompt_len for c in comps]
    problems = []
    if mismatched:
        problems.append(f"completions differ from sequential greedy: "
                        f"{mismatched}")
    if len(comps) != 8 or buckets != [256, 512]:
        problems.append(f"{len(comps)} completions over buckets {buckets}")
    if stats["prefills"] != 8 or launches != cfg.n_layers * 8:
        problems.append(f"flash launches {launches} != n_layers "
                        f"{cfg.n_layers} x prefills {stats['prefills']}")
    emit({"phase": "serve_moe", "ok": not problems, "problems": problems,
          "model": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "experts": cfg.n_experts,
          "capacity_factor": cfg.capacity_factor, "dtype": cfg.dtype,
          "params": cfg.param_count(), "init_s": init_s,
          "requests": len(comps), "generated_tokens": int(sum(gen)),
          "wall_s": wall, "tokens_per_s": sum(gen) / wall,
          "token_latency_p50_s": stats["p50_token_latency_s"],
          "refills": stats["refills"], "prefills": stats["prefills"],
          "flash_launches": launches, "buckets": buckets,
          "token_identical_to_sequential": not mismatched,
          "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    if problems:
        raise SystemExit("serve_moe phase failed: " + "; ".join(problems))
    del model, engine
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# optional phase: profile (not run by default)
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# expert parallelism: Mixtral's experts over `model`
# ---------------------------------------------------------------------------

# train_ep: the Mixtral job (train_moe's model, NF4 uint4, the job's LoRA
# r 64 on attention, the offline SQL rows) at full width cut to 4 layers,
# first in this process, then as two ranks of this card at fsdp 1 x
# model 2 over gloo: 4 experts a rank, attention on 16 of 32 query and 4
# of 8 KV heads; its bf16 streams within MESH_MULTI_RTOL of one process,
# the same job in fp32 (TF32 off) at EP_PARITY_LAYERS within
# MESH_LOSS_RTOL, then a cached greedy decode in fp32 whose tokens equal
# one process's
EP_LAYERS = 4
EP_PARITY_LAYERS = 2
EP_MODEL = 2
# the job's grad-accum 8 cut to 2, 1 + 1 steps (1 + 2 until train_overlap
# came): a gloo microbatch makes ~50 host-staged collectives on one card
EP_STEPS = 1
EP_PLAN = {"fused_ops": True, "grad_accum": 2}
EP_TIMEOUT_S = 600
# the fp32 decode: two prompts of these lengths in a 512 bucket
EP_DECODE = {"plens": (100, 300), "bucket": 512, "new": 16}
# train_ep_multi on the four-card host: the job at full depth on fsdp 1 x
# model 4 (2 experts a rank) against one card at full depth, and fsdp 2 x
# model 2 at 8 layers against one card at 8, each in bf16 with the job's
# grad-accum 8 (the timed runs) and in fp32 (TF32 off) with grad-accum 2
# (the held runs); the entry under torchrun at MESH_MODEL 4 (the
# config's own layout is fsdp 4 x model 4 on 16 chips), 4 layers.
# {run: (mesh, layers or None for the full 32, dtype)}
EP_MULTI_RUNS = {"model4": (dict(fsdp=1, model=4), None, "bfloat16"),
                 "model4_fp32": (dict(fsdp=1, model=4), None, "float32"),
                 "fsdp2_model2": (dict(fsdp=2, model=2), 8, "bfloat16"),
                 "fsdp2_model2_fp32": (dict(fsdp=2, model=2), 8,
                                       "float32")}
EP_MULTI_PLAN = {"bfloat16": {"fused_ops": True},
                 "float32": {"fused_ops": True, "grad_accum": 2}}
# the run whose ranks take the one card's routing decisions (``_routing``)
EP_MULTI_FORCED = "model4_fp32"
EP_MULTI_TIMEOUT_S = 1500
EP_MULTI_ENTRY = {"MESH_FSDP": 1, "MESH_MODEL": 4}


def _mixtral_cfg(n_layers=None, dtype="bfloat16"):
    """The Mixtral job's MODEL_ID preset at full width (``n_layers``
    deep, or its 32), remat on, at the job's MAX_SEQ_LENGTH."""
    return _llama_cfg(MIXTRAL_CONFIG, n_layers or 32, dtype=dtype,
                      param_dtype=dtype)


@contextlib.contextmanager
def _flash_heads(rec):
    """While entered, the (query, KV) heads of each attention call of
    the train path into ``rec["heads"]`` (as a set)."""
    from gke_ray_train_tpu_torch.ops import dispatch
    orig = dispatch.attention_dispatch
    rec["heads"] = set()

    def attend(impl, q, k, *a, **kw):
        rec["heads"].add((int(q.shape[2]), int(k.shape[2])))
        return orig(impl, q, k, *a, **kw)
    dispatch.attention_dispatch = attend
    try:
        yield rec
    finally:
        dispatch.attention_dispatch = orig
        rec["heads"] = sorted(rec["heads"])


def _ep_run(dev, cfg, mesh, steps=EP_STEPS, plan=None, rows=None,
            ft_over=None):
    """``_tp_rank_run`` of the Mixtral job (uint4 codes, dropout 0) at
    ``cfg``: its record, launches, the heads each flash call ran on and
    the experts a rank holds of each bank (the local leading dim).
    ``rows`` (count, index): this batch rank's rows, each its own
    microbatch; ``ft_over``: more of the job's keys replaced. The record
    also names the layers the rank holds."""
    from gke_ray_train_tpu_torch.models.transformer import layer_ids
    from gke_ray_train_tpu_torch.parallel.sharding import local
    held, layers = {}, []

    def keep(state):
        blk = state.params.blocks[0]
        held.update({k: int(local(getattr(blk, k).codes).shape[0])
                     for k in ("w_gate", "w_up", "w_down")})
        layers.extend(layer_ids(state.params))
    with _quant_store(MOE_STORE), _flash_heads({}) as rec:
        r, launches = _tp_rank_run(dev, cfg, mesh, 0.0, steps,
                                   config=MIXTRAL_CONFIG,
                                   plan=plan or EP_PLAN, rows=rows,
                                   one_row=rows is not None, keep=keep,
                                   ft_over=ft_over)
    r.update(heads=rec["heads"], experts_held=held, layers=layers)
    return r, launches


def _ep_prompts(vocab):
    r = np.random.default_rng(23)
    buf = np.zeros((len(EP_DECODE["plens"]), EP_DECODE["bucket"]), np.int32)
    for i, n in enumerate(EP_DECODE["plens"]):
        buf[i, :n] = r.integers(1, vocab, n)
    return buf


def _ep_decode(dev, cfg, mesh):
    """fp32 (TF32 off): a cached greedy decode of ``EP_DECODE`` on the
    Mixtral base from seed 0 (uint4 codes), sharded over ``mesh`` when
    given: the tokens written after each prompt, the seconds."""
    import torch
    from gke_ray_train_tpu_torch.models import init_quantized_params
    from gke_ray_train_tpu_torch.models.kvcache import (
        greedy_generate_cached)
    from gke_ray_train_tpu_torch.parallel.sharding import shard_model
    with _quant_store(MOE_STORE), _tf32_off():
        params = init_quantized_params(cfg, seed=0, device=dev, mesh=mesh)
        if mesh is not None:
            params = shard_model(params, mesh)
        prompt = torch.as_tensor(_ep_prompts(cfg.vocab_size), device=dev)
        plen = torch.as_tensor(EP_DECODE["plens"], dtype=torch.int32,
                               device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = greedy_generate_cached(params, prompt, plen, cfg,
                                     max_new_tokens=EP_DECODE["new"],
                                     device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    new = [out[i, n:n + EP_DECODE["new"]].tolist()
           for i, n in enumerate(EP_DECODE["plens"])]
    del params
    _release()
    return {"tokens": new, "seconds": wall}


def _ep_allreduce_bytes(cfg, mb_rows, seq, grad_accum):
    """Bytes a rank all-reduces over ``model`` in a train step, from the
    shapes, per microbatch: each layer's attention output (the
    row-parallel partial sums, in the compute dtype) and its MoE output
    (the experts' partial combine, fp32) in the forward and again in the
    recomputation under remat; in the backward the gradients of the
    attention input and of the dispatched MoE input (compute dtype) and
    of the per-slot gates; the embedding's rows and the fused loss's dx,
    and its row statistics (3 fp32 a token)."""
    import torch
    es = torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    tok = mb_rows * seq
    runs = 2 if cfg.remat else 1
    per_layer = tok * (cfg.d_model * (runs * es + runs * 4 + 2 * es)
                       + cfg.expert_top_k * es)
    return grad_accum * (per_layer * cfg.n_layers
                         + 2 * tok * cfg.d_model * es + 3 * 4 * tok)


def _ep_buffer_bytes(cfg, seq=4096):
    """A rank's MoE buffers for one row of ``seq`` tokens, from the
    shapes (``ops/moe.py``), in the compute dtype: the dispatched input
    ``[E / model, 1, C, d_model]`` and the gate and up products ``[E /
    model, 1, C, d_ff]`` each, at model 1 and 2; C is the whole row's
    capacity whatever the context size (a context rank's tokens take
    their global positions), where routing each shard on its own took
    ``expert_capacity(cfg, seq / context)``."""
    import torch
    from gke_ray_train_tpu_torch.ops.moe import expert_capacity
    es = torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    C = expert_capacity(cfg, seq)
    out = {"seq": seq, "capacity": C, "shard_capacity": {
        c: expert_capacity(cfg, seq // c) for c in (2, 4)}}
    for m in (1, EP_MODEL):
        n = cfg.n_experts // m
        out[f"model{m}"] = {"input": n * C * cfg.d_model * es,
                            "gate_up_each": n * C * cfg.d_ff * es}
    return out


def _ep_worker(out_path):
    """One of train_ep's two ranks on the one card (env: RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT): a gloo group with the card's
    tensors, the fsdp 1 x model 2 mesh, the collectives probed
    (``TP_PROBE``); where those the path makes run, the Mixtral job at
    ``EP_LAYERS`` layers (1 + ``EP_STEPS`` steps), at
    ``EP_PARITY_LAYERS`` in fp32, and the fp32 decode."""
    import torch
    import torch.distributed as dist
    from gke_ray_train_tpu_torch.parallel import MeshConfig, build_mesh
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method="env://")
    rank = dist.get_rank()
    rec = {"rank": rank, "backend": dist.get_backend(),
           "device_name": torch.cuda.get_device_name(dev)}
    try:
        mesh = build_mesh(MeshConfig(fsdp=1, model=EP_MODEL),
                          device_type="cuda")
        rec["probe"] = _tp_probe(dev, mesh)
        if all(rec["probe"][k] == "ok" for k, need in TP_PROBE.items()
               if need):
            torch.cuda.reset_peak_memory_stats()
            rec["run"], rec["launches"] = _ep_run(
                dev, _mixtral_cfg(EP_LAYERS), mesh)
            cfg32 = _mixtral_cfg(EP_PARITY_LAYERS, dtype="float32")
            with _tf32_off():
                rec["fp32_run"], _ = _ep_run(dev, cfg32, mesh)
            rec["decode"] = _ep_decode(dev, cfg32, mesh)
    finally:
        with open(out_path + f".{rank}", "w") as f:
            json.dump(rec, f)
        dist.barrier()
        dist.destroy_process_group()


def _ep_hold(name, run, cfg, model, problems):
    """A rank's run: launches per step as one process's (rows 1-3 on
    this rank's heads), the heads and the experts it holds."""
    heads = [(cfg.n_heads // model, cfg.n_kv_heads // model)]
    if run["launches_per_step"] != run["want_launches"]:
        problems.append(f"{name} launches per step "
                        f"{run['launches_per_step']} != "
                        f"{run['want_launches']}")
    if [tuple(h) for h in run["heads"]] != heads:
        problems.append(f"{name} flash heads {run['heads']} != {heads}")
    if set(run["experts_held"].values()) != {cfg.n_experts // model}:
        problems.append(f"{name} experts held {run['experts_held']}")


def phase_train_ep(dev):
    """Expert parallelism on the one-card host: the Mixtral job
    (ray-jobs/fine_tune_config_mixtral.json: NF4 uint4 base, LoRA r 64 on
    attention, the offline SQL rows; FUSED_OPS=1, grad-accum cut to 2)
    at full width cut to ``EP_LAYERS`` layers, first in this process,
    then as two ranks of this card at fsdp 1 x model 2 over gloo
    (``_ep_worker``), whose collectives are probed first. Where they
    run: each rank holds 4 of 8 experts of every bank; both ranks'
    losses and grad_norms of 1 + 2 steps within MESH_MULTI_RTOL of this
    process's; per step the launches of the one-process step, flash on
    16 of 32 query and 4 of 8 KV heads; then the job in fp32 (TF32 off)
    at 2 layers within MESH_LOSS_RTOL; then a cached greedy decode of
    two prompts in fp32 whose tokens equal one process's. The line
    carries a rank's p50, peak memory and the bytes it all-reduces a
    step (from the shapes)."""
    import tempfile
    cfg = _mixtral_cfg(EP_LAYERS)
    cfg32 = _mixtral_cfg(EP_PARITY_LAYERS, dtype="float32")
    ref, _ = _ep_run(dev, cfg, None)
    with _tf32_off():
        ref32, _ = _ep_run(dev, cfg32, None)
    ref_decode = _ep_decode(dev, cfg32, None)
    out = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_ep_"), "rank")
    hung, rcs, ranks = _spawn_ranks("--ep-worker", out, EP_MODEL,
                                    [0] * EP_MODEL, EP_TIMEOUT_S)
    problems, line = [], {"phase": "train_ep", "nvidia_smi":
                          nvidia_smi_line(), "model": cfg.name,
                          "n_layers": cfg.n_layers, "mesh": {
                              "data": 1, "fsdp": 1, "model": EP_MODEL},
                          "backend": "gloo", "ranks_on_one_card": EP_MODEL,
                          "quant_store": MOE_STORE,
                          "cut": f"{EP_LAYERS} of 32 layers (fp32 at "
                          f"{EP_PARITY_LAYERS}), grad-accum 2 of 8, 1 + "
                          f"{EP_STEPS} steps", "one_process": ref,
                          "one_process_fp32": ref32,
                          "one_process_decode": ref_decode}
    if hung or any(rcs) or None in ranks:
        problems.append(f"ranks hung {hung}, exit codes {rcs}")
        line["ranks"] = ranks
    probe = ranks[0].get("probe", {}) if ranks[0] else {}
    missing = {k: v for k, v in probe.items()
               if v != "ok" and TP_PROBE[k]}
    line["probe"] = probe
    launches = None
    if not problems and missing:
        problems.append("gloo misses " + ", ".join(sorted(missing)))
    elif not problems:
        line["ranks"] = ranks
        gaps = {}
        for r in ranks:
            name = f"rank {r['rank']}"
            gaps[r["rank"]] = {
                "bf16": _hold_streams(name, r["run"], ref, MESH_MULTI_RTOL,
                                      problems),
                "fp32": _hold_streams(name + " fp32", r["fp32_run"], ref32,
                                      MESH_LOSS_RTOL, problems)}
            _ep_hold(name, r["run"], cfg, EP_MODEL, problems)
            _ep_hold(name + " fp32", r["fp32_run"], cfg32, EP_MODEL,
                     problems)
            if r["decode"]["tokens"] != ref_decode["tokens"]:
                problems.append(f"{name} fp32 decode tokens "
                                f"{r['decode']['tokens']} != "
                                f"{ref_decode['tokens']}")
        mb = int(ref["tokens"] // ref["grad_accum"] // cfg.max_seq_len)
        line.update(rel_gaps=gaps, tol_rel={"bf16": MESH_MULTI_RTOL,
                                            "fp32": MESH_LOSS_RTOL},
                    allreduce_bytes_per_step=_ep_allreduce_bytes(
                        cfg, mb, cfg.max_seq_len, ref["grad_accum"]),
                    expert_buffer_bytes=_ep_buffer_bytes(cfg),
                    p50_ratio=[r["run"]["step_s_p50"] / ref["step_s_p50"]
                               for r in ranks])
        launches = {}
        for r in ranks:
            for k, n in r["launches"].items():
                if n:
                    launches[k] = launches.get(k, 0) + n
    line.update(ok=not problems, problems=problems)
    emit(line)
    if problems:
        raise SystemExit("train_ep phase failed: " + "; ".join(problems))
    return launches


@contextlib.contextmanager
def _routing(record=None, forced=None, flips=None):
    """While entered, each ``ops.moe.route`` call, in call order: with
    ``record`` (a list) its decisions (expert, position, keep) appended,
    copied to the host; with ``forced`` (such a list from another run)
    its decisions replaced by the recorded ones (the gates taken from
    this call's router probabilities at the recorded experts and
    renormalised, the aux its own) and, into ``flips``, the count of
    (token, slot) assignments this call would have decided otherwise. A
    run held against another under the same routing compares the
    dispatch, experts and combine free of top-k flips: at random weights
    the router's top 2 of 8 sit near ties, and the rounding of sums
    taken in another order moves a token to another expert."""
    import torch
    from gke_ray_train_tpu_torch.ops import moe
    if record is None and forced is None:
        yield
        return
    orig = moe.route
    calls = []

    def route(x, router_w, cfg, weights=None, context=None):
        r = orig(x, router_w, cfg, weights, context=context)
        i = len(calls)
        calls.append(i)
        if record is not None:
            record.append(tuple(t.cpu() for t in (r.expert, r.pos, r.keep)))
            return r
        e, p, k = (t.to(x.device) for t in forced[i])
        flips.append(((e != r.expert) | (k != r.keep)).sum())
        probs = torch.softmax(x.float() @ router_w.float(), dim=-1)
        gate = torch.gather(probs, -1, e)
        return moe.Routing(gate / torch.sum(gate, dim=-1, keepdim=True),
                           e, p, k, r.aux)
    moe.route = route
    try:
        yield
    finally:
        moe.route = orig


@contextlib.contextmanager
def _routing_by_layer(record=None, forced=None, flips=None):
    """``_routing`` keyed by layer and microbatch instead of call order:
    a decision is stored under (its router's digest, whether it is a
    recomputation in the backward, its count among such calls of that
    router), so a pipeline stage, which runs a layer's microbatches
    forward in one tick loop and recomputes them in the backward's, finds
    the decisions one card made for the same layer and microbatch
    (``record`` / ``forced``: dicts). The router is frozen and whole on
    every rank (QLoRA adapts attention only)."""
    import hashlib
    import torch
    from gke_ray_train_tpu_torch.ops import moe
    if record is None and forced is None:
        yield
        return
    orig = moe.route
    counts = {}

    def route(x, router_w, cfg, weights=None, context=None):
        r = orig(x, router_w, cfg, weights, context=context)
        # a copy: numpy's view would pin the parameter's storage
        w = router_w.detach().to("cpu", torch.float32, copy=True).numpy()
        kind = torch._C._current_graph_task_id() != -1
        base = (hashlib.sha1(w.tobytes()).hexdigest(), kind)
        key = base + (counts.get(base, 0),)
        counts[base] = key[2] + 1
        if record is not None:
            record[key] = tuple(t.cpu() for t in (r.expert, r.pos, r.keep))
            return r
        e, p, k = (t.to(x.device) for t in forced[key])
        flips.append(((e != r.expert) | (k != r.keep)).sum())
        probs = torch.softmax(x.float() @ router_w.float(), dim=-1)
        gate = torch.gather(probs, -1, e)
        return moe.Routing(gate / torch.sum(gate, dim=-1, keepdim=True),
                           e, p, k, r.aux)
    moe.route = route
    try:
        yield
    finally:
        moe.route = orig


def _ep_multi_run(dev, layers, dtype, mesh=None, rows=None, **routing):
    """One run of ``EP_MULTI_RUNS`` (fp32 with TF32 off), under
    ``_routing(**routing)``."""
    with contextlib.ExitStack() as stack:
        if dtype == "float32":
            stack.enter_context(_tf32_off())
        stack.enter_context(_routing(**routing))
        return _ep_run(dev, _mixtral_cfg(layers, dtype), mesh,
                       plan=EP_MULTI_PLAN[dtype], rows=rows)


def _ep_multi_worker(out_path):
    """One rank of train_ep_multi (NCCL, one card a rank): the Mixtral
    job of each of ``EP_MULTI_RUNS``."""
    import torch
    import torch.distributed as dist
    from gke_ray_train_tpu_torch.parallel import (
        MeshConfig, build_mesh, distributed_init)
    from gke_ray_train_tpu_torch.parallel.placement import (
        input_shard_layout)
    dev = distributed_init()
    rank, world = dist.get_rank(), dist.get_world_size()
    rec = {"rank": rank, "world": world,
           "device_name": torch.cuda.get_device_name(dev)}
    try:
        for key, (kw, layers, dtype) in EP_MULTI_RUNS.items():
            mesh = build_mesh(MeshConfig(**kw))
            torch.cuda.reset_peak_memory_stats()
            rows = input_shard_layout(mesh)
            routing = {}
            if key == EP_MULTI_FORCED:
                routing = dict(forced=torch.load(out_path + ".routing.pt"),
                               flips=[])
            r, launches = _ep_multi_run(dev, layers, dtype, mesh,
                                        rows if rows[0] > 1 else None,
                                        **routing)
            if routing:
                per = len(routing["flips"]) // (EP_STEPS + 1)
                r["routing_flips_per_step"] = [
                    int(sum(routing["flips"][i:i + per]))
                    for i in range(0, len(routing["flips"]), per)]
            r["tokens_per_s_per_card"] = r["tokens"] / r["step_s_p50"] / world
            r["allreduce_bytes_per_step"] = _ep_allreduce_bytes(
                _mixtral_cfg(layers, dtype), 1, 1024, r["grad_accum"])
            rec[key] = r
            rec.setdefault("launches", {})[key] = launches
    finally:
        with open(out_path + f".{rank}", "w") as f:
            json.dump(rec, f)
        dist.barrier()
        dist.destroy_process_group()


def phase_train_ep_multi(dev):
    """Opt-in, the four-card host (fewer than 4 cards fails). One card
    first: the Mixtral job (FUSED_OPS=1) at full depth and at 8 layers,
    in bf16 with the job's grad-accum 8 and in fp32 (TF32 off) with
    grad-accum 2. Then one rank a card over NCCL (``_ep_multi_worker``):
    fsdp 1 x model 4 at full depth (2 experts a rank, flash on 8 of 32 /
    2 of 8 heads) and fsdp 2 x model 2 at 8 layers, each in both dtypes:
    fp32 each step's loss and grad_norm within MESH_LOSS_RTOL of the one
    card's, at full depth under the one card's routing decisions
    (``_routing``: the ranks count the assignments they would have
    decided otherwise, reported as ``routing_flips_per_step``); bf16 each
    loss within MESH_MULTI_RTOL, its grad_norm gap reported, not held
    (at random weights the router's top 2 of 8 sit near ties, and the
    rounding of the row-parallel attention sums moves tokens between
    experts: on H100s the bf16 gap grew with depth, 0.8% at 4 layers,
    1.8% at 8, 6% at 32); per card p50, tokens/s, peak memory and the
    bytes
    all-reduced a step. Last the entry under torchrun on the Mixtral job
    at MESH_FSDP 1 x MESH_MODEL 4, 4 layers, uint4 (``_multi_entry``):
    every rank exits 0 and the sharded export, each bank written by the
    ranks that hold its experts, converts to finite tensors."""
    import tempfile
    import torch
    n = torch.cuda.device_count()
    emit({"phase": "train_ep_multi_devices", "ok": n >= 4,
          "device_count": n, "nvidia_smi": nvidia_smi_line()})
    if n < 4:
        raise SystemExit(f"train_ep_multi needs 4 cards; this host has {n}")
    refs, record = {}, []
    for key, (_, layers, dtype) in EP_MULTI_RUNS.items():
        torch.cuda.reset_peak_memory_stats()
        refs[key], _ = _ep_multi_run(
            dev, layers, dtype,
            record=record if key == EP_MULTI_FORCED else None)
    torch.cuda.empty_cache()
    out = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_ep_multi_"),
                       "rank")
    torch.save(record, out + ".routing.pt")
    hung, rcs, ranks = _spawn_ranks("--ep-multi-worker", out, n,
                                    list(range(n)), EP_MULTI_TIMEOUT_S)
    problems, gaps = [], {}
    line = {"phase": "train_ep_multi", "nvidia_smi": nvidia_smi_line(),
            "world": n, "one_card": refs, "quant_store": MOE_STORE,
            "cut": {"model4": "full depth, 1 + 2 steps (fp32: grad-accum "
                    "2)", "fsdp2_model2": "8 of 32 layers, 1 + 2 steps",
                    "entry": "MESH_FSDP 1 x MESH_MODEL 4 (the config's "
                    "fsdp 4 x model 4 needs 16 cards), 4 layers"}}
    if hung or any(rcs) or None in ranks:
        problems.append(f"ranks hung {hung}, exit codes {rcs}")
    else:
        for r in ranks:
            name = f"rank {r['rank']}"
            gaps[r["rank"]] = {}
            for k, (kw, layers, dtype) in EP_MULTI_RUNS.items():
                # fp32 holds both streams; bf16 the losses, its grad_norm
                # gap reported (module doc of phase_train_ep_multi)
                fp32 = dtype == "float32"
                gaps[r["rank"]][k] = _hold_streams(
                    f"{name} {k}", r[k], refs[k],
                    MESH_LOSS_RTOL if fp32 else MESH_MULTI_RTOL, problems,
                    held=("losses", "grad_norms") if fp32 else ("losses",))
                _ep_hold(f"{name} {k}", r[k], _mixtral_cfg(layers, dtype),
                         kw["model"], problems)
    line.update(ranks=ranks, rel_gaps=gaps,
                tol_rel={"bfloat16": MESH_MULTI_RTOL,
                         "float32": MESH_LOSS_RTOL})
    with _quant_store(MOE_STORE):
        entry, entry_problems = _multi_entry(n, EP_MULTI_ENTRY,
                                             path=MIXTRAL_CONFIG)
    problems += entry_problems
    line.update(entry=entry, ok=not problems, problems=problems)
    emit(line)
    if problems:
        raise SystemExit("train_ep_multi phase failed: "
                         + "; ".join(problems))
    launches = {}
    for r in ranks:
        for per in r["launches"].values():
            for k, v in per.items():
                if v:
                    launches[k] = launches.get(k, 0) + v
    return launches


# ---------------------------------------------------------------------------
# pipeline parallelism: Llama's layers over `pipe`
# ---------------------------------------------------------------------------

# train_pp: the offline_8b job (Llama-3.1-8B QLoRA, NF4, LoRA r 64,
# LORA_DROPOUT 0 as a pipelined mesh requires, the offline SQL rows;
# FUSED_OPS=1) at full width cut to 4 of 32 layers, first in this
# process, then as two ranks of this card at pipe 2 over gloo (2 pipe
# microbatches in each of the job's 4 grad-accum microbatches: one a
# hop); its bf16 streams within MESH_MULTI_RTOL of one process; the job in
# fp32 (TF32 off) at 2 layers with the grad-accum folded into the pipe
# microbatches (GRADIENT_ACCUMULATION_STEPS 1, PIPE_MICROBATCHES 8 of one
# row) within PP_PARITY_RTOL of one process at grad-accum 8 of the same
# rows (the same microbatches in the same order), and within
# MESH_LOSS_RTOL of one process at the job's grad-accum 4 of two rows;
# then the same two runs as four ranks of this card at pipe 2 x model 2
# (tensor parallelism inside each stage: 16 of 32 query heads and half
# the vocab a rank), the fp32 run within MESH_LOSS_RTOL of both (the
# row-parallel sums add in another order, as in train_tp)
# the bf16 job's depth: 2 layers, one a stage (4 until train_hier came)
PP_LAYERS = 2
PP_PARITY_LAYERS = 2
PP_PIPE = 2
PP_TP_MODEL = 2
# 1 + 1 steps (1 + 2 until train_overlap came)
PP_STEPS = 1
# the fp32 runs 1 + 1 steps (cut for the pipe x model world's time)
PP_FP32_STEPS = 1
PP_TIMEOUT_S = 600
PP_PARITY_RTOL = 1e-6
PP_FT = {"QUANT_KIND": "nf4", "LORA_DROPOUT": 0.0}
PP_PLAN = {"fused_ops": True}
# the folded fp32 runs: {run: (plan, the job's keys replaced)}
PP_FOLD = {"pipe": ({"fused_ops": True, "grad_accum": 1,
                     "pipe_microbatches": 8},
                    {"PER_DEVICE_TRAIN_BATCH_SIZE": 8}),
           "one_row": ({"fused_ops": True, "grad_accum": 8},
                       {"PER_DEVICE_TRAIN_BATCH_SIZE": 1}),
           "job": ({"fused_ops": True}, {})}
# train_pp_multi on the four-card host: (a) ray-jobs/fine_tune_config_70b
# .json as QLoRA (NF4, r 64, dropout 0) at pipe 4, full depth (20 of its
# 80 layers a card), 8 pipe microbatches of one row (grad-accum folded),
# and in fp32 at 8 layers against one card; (b) the offline_8b job at
# pipe 2 x fsdp 2, 8 layers, against one card; (c) the entry under
# torchrun at MESH_PIPE 4 on offline_8b at 8 layers
PP_70B_FT = {"USE_QLORA": True, "QUANT_KIND": "nf4", "LORA_DROPOUT": 0.0,
             "PER_DEVICE_TRAIN_BATCH_SIZE": 8,
             "GRADIENT_ACCUMULATION_STEPS": 1}
PP_70B_PLAN = {"fused_ops": True, "grad_accum": 1, "pipe_microbatches": 8}
PP_70B_PARITY_LAYERS = 8
PP_70B_PARITY_RTOL = 1e-5
PP_MULTI_8B_LAYERS = 8
# (b): 8 rows a step, 4 a batch rank, grad-accum 2 of 2 rows, 2 pipe
# microbatches of one row
PP_MULTI_8B_PLAN = {"fused_ops": True, "grad_accum": 2}
PP_MULTI_8B_FT = {"PER_DEVICE_TRAIN_BATCH_SIZE": 4}
PP_MULTI_ENTRY = {"MESH_PIPE": 4, "MESH_FSDP": 1,
                  "PER_DEVICE_TRAIN_BATCH_SIZE": 8,
                  "GRADIENT_ACCUMULATION_STEPS": 1, "PIPE_MICROBATCHES": 8}
PP_MULTI_ENTRY_LAYERS = 8
PP_MULTI_TIMEOUT_S = 1500
# and at pipe 2 x model 2 (tensor and expert parallelism inside each
# stage): (d) the 70B QLoRA at full depth (40 of 80 layers a stage, half
# of each a card), fp32 at 8 layers against one card within
# MESH_LOSS_RTOL; (e) the entry under torchrun at MESH_PIPE 2 x
# MESH_MODEL 2 with INFERENCE and SERVE_AFTER_TRAIN.
# train_pp_moe_multi on the four-card host: the Mixtral job (uint4 base,
# LoRA r 64 on attention, 8 one-row pipe microbatches, grad-accum folded)
# at pipe 2 x model 2, at full depth in bf16 and at
# ``PP_MOE_FP32_LAYERS`` in fp32, each under the one card's routing
# decisions by layer and microbatch (``_routing_by_layer``): bf16 losses
# within MESH_MULTI_RTOL of the one card's 8 one-row microbatches (the
# grad_norm gap reported, as train_ep_multi holds bf16), fp32 both
# streams within MESH_LOSS_RTOL
PP_TP_MULTI = dict(fsdp=1, model=2, pipe=2)
PP_MOE_FT = {"PER_DEVICE_TRAIN_BATCH_SIZE": 8,
             "GRADIENT_ACCUMULATION_STEPS": 1}
PP_MOE_PLAN = {"fused_ops": True, "grad_accum": 1, "pipe_microbatches": 8}
PP_MOE_ONE_CARD = ({"fused_ops": True, "grad_accum": 8},
                   {"PER_DEVICE_TRAIN_BATCH_SIZE": 1})
PP_MOE_FP32_LAYERS = 8
PP_MOE_TIMEOUT_S = 900
PP_TP_MULTI_ENTRY = {"MESH_PIPE": 2, "MESH_MODEL": 2, "MESH_FSDP": 1,
                     "PER_DEVICE_TRAIN_BATCH_SIZE": 8,
                     "GRADIENT_ACCUMULATION_STEPS": 1,
                     "PIPE_MICROBATCHES": 8, "INFERENCE": True,
                     "SERVE_AFTER_TRAIN": True,
                     "NUM_EVAL_SAMPLES_INFERENCE": 2,
                     "MAX_NEW_GENERATION_TOKENS_INFERENCE": 32}


def _pp_run(dev, cfg, mesh, plan, ft_over=None, config=None, rows=None,
            steps=PP_STEPS):
    """``_tp_rank_run`` of the pipe jobs: its record and launches, the
    layers this rank holds and, on a pipelined mesh, the launches one
    stage makes a step (``expected_launches`` of its layers at grad-accum
    x pipe microbatches; the cross-entropy's on the last stage only), the
    ticks and stage passes of its schedule and the bytes it sends to and
    receives from its neighbours a step, from the shapes (the [Bm, S, D]
    activations forward, their gradients back)."""
    import torch
    from gke_ray_train_tpu_torch.models.transformer import layer_ids
    from gke_ray_train_tpu_torch.parallel.mesh import pipe_size
    held = {}

    def keep(state):
        held["layers"] = list(layer_ids(state.params))
    r, launches = _tp_rank_run(dev, cfg, mesh, 0.0, steps,
                               config=config or ENTRY_CONFIG,
                               plan=plan, keep=keep, rows=rows,
                               ft_over=dict(PP_FT, **(ft_over or {})))
    r["layers"] = held["layers"]
    if pipe_size(mesh) > 1:
        rows_local = r["tokens"] // cfg.max_seq_len // (
            rows[0] if rows else 1)
        es = torch.finfo(getattr(torch, cfg.dtype)).bits // 8
        r.update(_stage_launches(r, cfg, mesh, plan),
                 stage_bytes_per_step=2 * rows_local * cfg.max_seq_len
                 * cfg.d_model * es)
    return r, launches


def _pp_layers(cfg, rank, pipe):
    from gke_ray_train_tpu_torch.models.pipeline import stage_layers
    return stage_layers(cfg, pipe, cfg.pipe_virtual, rank)


def _pp_worker(out_path):
    """One of train_pp's ranks on the one card (env: RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT): a gloo group with the card's tensors, the
    pipe 2 mesh (two ranks) or pipe 2 x model 2 (four); the job at
    ``PP_LAYERS`` (1 + ``PP_STEPS`` steps), then folded in fp32 at
    ``PP_PARITY_LAYERS``."""
    import torch
    import torch.distributed as dist
    from gke_ray_train_tpu_torch.parallel import (
        MeshConfig, build_mesh, model_rank, pipe_rank)
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method="env://")
    rank = dist.get_rank()
    rec = {"rank": rank, "backend": dist.get_backend(),
           "device_name": torch.cuda.get_device_name(dev)}
    try:
        mesh = build_mesh(MeshConfig(
            fsdp=1, model=dist.get_world_size() // PP_PIPE, pipe=PP_PIPE),
            device_type="cuda")
        rec.update(pipe_rank=pipe_rank(mesh), model_rank=model_rank(mesh))
        torch.cuda.reset_peak_memory_stats()
        rec["run"], rec["launches"] = _pp_run(
            dev, _llama_cfg(ENTRY_CONFIG, PP_LAYERS), mesh, PP_PLAN)
        plan, over = PP_FOLD["pipe"]
        with _tf32_off():
            rec["fp32_run"], _ = _pp_run(
                dev, _llama_cfg(ENTRY_CONFIG, PP_PARITY_LAYERS, "float32",
                                "float32"), mesh, plan, over,
                steps=PP_FP32_STEPS)
    finally:
        with open(out_path + f".{rank}", "w") as f:
            json.dump(rec, f)
        dist.barrier()
        dist.destroy_process_group()


def _pp_hold(name, run, cfg, rank, pipe, problems):
    """A stage's run: its layers, its launches a step, the ticks."""
    layers = _pp_layers(cfg, rank, pipe)
    if run["layers"] != layers:
        problems.append(f"{name} holds layers {run['layers']} != {layers}")
    if run["launches_per_step"] != run["want_launches"]:
        problems.append(f"{name} launches per step "
                        f"{run['launches_per_step']} != "
                        f"{run['want_launches']}")
    want_ticks = run["pipe_microbatches"] + cfg.pipe_virtual * pipe - 1
    if run["ticks"] != want_ticks:
        problems.append(f"{name} ticks {run['ticks']} != {want_ticks}")


def phase_train_pp(dev):
    """Pipeline parallelism on the one-card host: the offline_8b job
    (Llama-3.1-8B QLoRA, NF4, LoRA r 64, dropout 0, FUSED_OPS=1, the
    offline SQL rows) at full width cut to ``PP_LAYERS`` layers, first in
    this process, then as two ranks of this card at pipe 2 over gloo
    (``_pp_worker``; each rank holds 1 of the 2 layers, the activations
    between them staged through host memory). Both ranks' losses and
    grad_norms of 1 + 2 steps within MESH_MULTI_RTOL of this process's;
    per step a rank's launches are its stage's (rows 1-3, 7 and 8 of
    half the layers at twice the microbatches, rows 4-5 on the last
    stage only), in M + P - 1 ticks. Then fp32 (TF32 off) at 2 layers,
    the grad-accum folded into 8 pipe microbatches of one row, within
    PP_PARITY_RTOL of one process at grad-accum 8 of the same rows, and
    within MESH_LOSS_RTOL of one process at the job's grad-accum 4. The
    line carries a rank's p50 against one process's, its peak memory,
    its layers, the ticks and the bytes a stage sends and receives a
    step (from the shapes). Then the same two runs as four ranks of this
    card at pipe 2 x model 2 (``pipe_tp``): each rank its stage's 2
    layers at 16 of 32 query heads, rows 4-5 on a V/2 shard on the last
    stage only; bf16 within MESH_MULTI_RTOL, fp32 within MESH_LOSS_RTOL
    of one process."""
    import tempfile
    cfg = _llama_cfg(ENTRY_CONFIG, PP_LAYERS)
    cfg32 = _llama_cfg(ENTRY_CONFIG, PP_PARITY_LAYERS, "float32", "float32")
    ref, _ = _pp_run(dev, cfg, None, PP_PLAN)
    ref32 = {}
    with _tf32_off():
        for key in ("one_row", "job"):
            plan, over = PP_FOLD[key]
            ref32[key], _ = _pp_run(dev, cfg32, None, plan, over,
                                    steps=PP_FP32_STEPS)
    out = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_pp_"), "rank")
    hung, rcs, ranks = _spawn_ranks("--pp-worker", out, PP_PIPE,
                                    [0] * PP_PIPE, PP_TIMEOUT_S)
    problems, line = [], {
        "phase": "train_pp", "nvidia_smi": nvidia_smi_line(),
        "model": cfg.name, "n_layers": cfg.n_layers,
        "mesh": {"data": 1, "fsdp": 1, "pipe": PP_PIPE}, "backend": "gloo",
        "ranks_on_one_card": PP_PIPE,
        "cut": f"{PP_LAYERS} of 32 layers (fp32 at {PP_PARITY_LAYERS}), "
               f"1 + {PP_STEPS} steps (fp32 1 + {PP_FP32_STEPS})",
        "one_process": ref,
        "one_process_fp32": ref32}
    launches = None
    if hung or any(rcs) or None in ranks:
        problems.append(f"ranks hung {hung}, exit codes {rcs}")
        line["ranks"] = ranks
    else:
        line["ranks"] = ranks
        gaps = {}
        for r in ranks:
            name = f"rank {r['rank']}"
            gaps[r["rank"]] = {
                "bf16": _hold_streams(name, r["run"], ref, MESH_MULTI_RTOL,
                                      problems),
                "fp32_one_row": _hold_streams(
                    name + " fp32", r["fp32_run"], ref32["one_row"],
                    PP_PARITY_RTOL, problems),
                "fp32_job": _hold_streams(
                    name + " fp32 against grad-accum 4", r["fp32_run"],
                    ref32["job"], MESH_LOSS_RTOL, problems)}
            _pp_hold(name, r["run"], cfg, r["pipe_rank"], PP_PIPE, problems)
            _pp_hold(name + " fp32", r["fp32_run"], cfg32, r["pipe_rank"],
                     PP_PIPE, problems)
        line.update(
            rel_gaps=gaps, tol_rel={"bf16": MESH_MULTI_RTOL,
                                    "fp32_one_row": PP_PARITY_RTOL,
                                    "fp32_job": MESH_LOSS_RTOL},
            p50_ratio=[r["run"]["step_s_p50"] / ref["step_s_p50"]
                       for r in ranks],
            peak_mem_bytes=[r["run"]["peak_mem_bytes"] for r in ranks],
            layers=[r["run"]["layers"] for r in ranks],
            ticks=ranks[0]["run"]["ticks"],
            stage_bytes_per_step=ranks[0]["run"]["stage_bytes_per_step"],
            launches_per_rank=[r["launches"] for r in ranks])
        launches = {}
        for r in ranks:
            for k, n in r["launches"].items():
                if n:
                    launches[k] = launches.get(k, 0) + n
    line["pipe_tp"], tp_launches = _pp_tp_world(cfg, cfg32, ref, ref32,
                                                problems)
    if launches is not None:
        for k, n in tp_launches.items():
            launches[k] = launches.get(k, 0) + n
    line.update(ok=not problems, problems=problems)
    emit(line)
    if problems:
        raise SystemExit("train_pp phase failed: " + "; ".join(problems))
    return launches


def _pp_tp_world(cfg, cfg32, ref, ref32, problems):
    """train_pp's pipe 2 x model 2 world: four ranks of this card over
    gloo (``_pp_worker`` at a world of four), held to this process's
    runs; (its part of the line, its launches)."""
    import tempfile
    n = PP_PIPE * PP_TP_MODEL
    out = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_pp_tp_"), "rank")
    t0 = time.perf_counter()
    hung, rcs, ranks = _spawn_ranks("--pp-worker", out, n, [0] * n,
                                    PP_TIMEOUT_S)
    line = {"mesh": {"data": 1, "fsdp": 1, "model": PP_TP_MODEL,
                     "pipe": PP_PIPE}, "ranks_on_one_card": n,
            "wall_s": time.perf_counter() - t0}
    if hung or any(rcs) or None in ranks:
        problems.append(f"pipe_tp ranks hung {hung}, exit codes {rcs}")
        line["ranks"] = ranks
        return line, {}
    gaps, launches = {}, {}
    heads = (cfg.n_heads // PP_TP_MODEL, cfg.n_kv_heads // PP_TP_MODEL)
    for r in ranks:
        name = f"pipe_tp rank {r['rank']}"
        gaps[r["rank"]] = {
            "bf16": _hold_streams(name, r["run"], ref, MESH_MULTI_RTOL,
                                  problems),
            "fp32_one_row": _hold_streams(
                name + " fp32", r["fp32_run"], ref32["one_row"],
                MESH_LOSS_RTOL, problems),
            "fp32_job": _hold_streams(
                name + " fp32 against grad-accum 4", r["fp32_run"],
                ref32["job"], MESH_LOSS_RTOL, problems)}
        _pp_hold(name, r["run"], cfg, r["pipe_rank"], PP_PIPE, problems)
        _pp_hold(name + " fp32", r["fp32_run"], cfg32, r["pipe_rank"],
                 PP_PIPE, problems)
        for k, v in r["launches"].items():
            if v:
                launches[k] = launches.get(k, 0) + v
    line.update(
        ranks=ranks, rel_gaps=gaps,
        tol_rel={"bf16": MESH_MULTI_RTOL, "fp32": MESH_LOSS_RTOL},
        heads_a_rank=heads, vocab_a_rank=cfg.vocab_size // PP_TP_MODEL,
        p50_ratio=[r["run"]["step_s_p50"] / ref["step_s_p50"]
                   for r in ranks],
        step_s_p50=[r["run"]["step_s_p50"] for r in ranks],
        peak_mem_bytes=[r["run"]["peak_mem_bytes"] for r in ranks],
        layers=[r["run"]["layers"] for r in ranks],
        launches_per_rank=[r["launches"] for r in ranks])
    return line, launches


def _pp_moe_run(dev, layers, dtype, mesh=None, **routing):
    """The Mixtral job of train_pp_moe_multi at ``layers`` in ``dtype``
    (fp32 with TF32 off) under ``_routing_by_layer(**routing)``: on the
    pipelined ``mesh`` 8 one-row pipe microbatches a step, the launches
    a stage makes a step; one card its 8 one-row microbatches."""
    plan, over = ((PP_MOE_PLAN, PP_MOE_FT) if mesh is not None
                  else PP_MOE_ONE_CARD)
    cfg = _mixtral_cfg(layers, dtype)
    with contextlib.ExitStack() as stack:
        if dtype == "float32":
            stack.enter_context(_tf32_off())
        stack.enter_context(_routing_by_layer(**routing))
        r, launches = _ep_run(dev, cfg, mesh, plan=plan, ft_over=over)
    if mesh is not None:
        r.update(_stage_launches(r, cfg, mesh, plan))
    return r, launches


def _stage_launches(r, cfg, mesh, plan):
    """What a pipeline stage of ``mesh`` holding ``r["layers"]`` launches
    a step (``expected_launches`` of its layers at grad-accum x pipe
    microbatches; the cross-entropy's on the last stage only), its
    schedule's ticks and stage passes (``_pp_hold`` reads them)."""
    from gke_ray_train_tpu_torch.models.pipeline import schedule_of
    from gke_ray_train_tpu_torch.parallel.mesh import pipe_size
    P = pipe_size(mesh)
    M = plan.get("pipe_microbatches") or cfg.pipe_virtual * P
    sch = schedule_of(cfg, mesh, M)
    want = expected_launches(
        dataclasses.replace(cfg, n_layers=len(r["layers"])),
        r["grad_accum"] * M, plan.get("fused_ops", False))
    if sch.rank != P - 1:
        for k in ("fused_ce_row_stats", "fused_ce_dx", "fused_ce_dhead"):
            want[k] = 0
    return {"want_launches": want, "ticks": sch.ticks, "passes": sch.passes,
            "pipe_microbatches": M}


def _pp_multi_worker(out_path):
    """One rank of train_pp_multi (NCCL, one card a rank): the 70B
    QLoRA at pipe 4, full depth, then in fp32 at 8 layers; the 8B job at
    pipe 2 x fsdp 2, 8 layers; then the 70B at pipe 2 x model 2 (full
    depth, fp32 at 8 layers)."""
    import torch
    import torch.distributed as dist
    from gke_ray_train_tpu_torch.parallel import (
        MeshConfig, build_mesh, distributed_init, model_rank, pipe_rank)
    from gke_ray_train_tpu_torch.parallel.placement import (
        input_shard_layout)
    dev = distributed_init()
    rank, world = dist.get_rank(), dist.get_world_size()
    rec = {"rank": rank, "world": world,
           "device_name": torch.cuda.get_device_name(dev)}
    try:
        mesh = build_mesh(MeshConfig(fsdp=1, pipe=world))
        torch.cuda.reset_peak_memory_stats()
        rec["70b"], rec["launches"] = _pp_run(
            dev, _llama_cfg(FT_70B_CONFIG, 80), mesh, PP_70B_PLAN,
            PP_70B_FT, config=FT_70B_CONFIG)
        with _tf32_off():
            rec["70b_fp32"], _ = _pp_run(
                dev, _llama_cfg(FT_70B_CONFIG, PP_70B_PARITY_LAYERS,
                                "float32", "float32"), mesh, PP_70B_PLAN,
                PP_70B_FT, config=FT_70B_CONFIG)
        mesh = build_mesh(MeshConfig(fsdp=2, pipe=2))
        torch.cuda.reset_peak_memory_stats()
        rec["8b_fsdp2"], _ = _pp_run(
            dev, _llama_cfg(ENTRY_CONFIG, PP_MULTI_8B_LAYERS), mesh,
            PP_MULTI_8B_PLAN, PP_MULTI_8B_FT, rows=input_shard_layout(mesh))
        mesh = build_mesh(MeshConfig(**PP_TP_MULTI))
        rec.update(pipe_rank=pipe_rank(mesh), model_rank=model_rank(mesh))
        torch.cuda.reset_peak_memory_stats()
        rec["70b_tp"], rec["launches_tp"] = _pp_run(
            dev, _llama_cfg(FT_70B_CONFIG, 80), mesh, PP_70B_PLAN,
            PP_70B_FT, config=FT_70B_CONFIG)
        with _tf32_off():
            rec["70b_tp_fp32"], _ = _pp_run(
                dev, _llama_cfg(FT_70B_CONFIG, PP_70B_PARITY_LAYERS,
                                "float32", "float32"), mesh, PP_70B_PLAN,
                PP_70B_FT, config=FT_70B_CONFIG)
    finally:
        with open(out_path + f".{rank}", "w") as f:
            json.dump(rec, f)
        dist.barrier()
        dist.destroy_process_group()


def phase_train_pp_multi(dev):
    """Opt-in, the four-card host (fewer than 4 cards fails). One card
    first: the 70B job as QLoRA (NF4, r 64, dropout 0; FUSED_OPS=1) in
    fp32 (TF32 off) at 8 layers as 8 one-row microbatches, and the 8B
    job at 8 layers. Then one rank a card over NCCL (``_pp_multi_worker``):
    (a) the 70B at pipe 4 and full depth, 20 layers a card, 8 pipe
    microbatches of one row (grad-accum folded): a rank's p50, peak and
    base bytes; whether one card holds the full-depth QLoRA 70B is
    reckoned from the stages' bytes; the fp32 run at 8 layers within
    PP_70B_PARITY_RTOL of the one card's; (b) the 8B job at pipe 2 x
    fsdp 2, 8 layers, within MESH_MULTI_RTOL of the one card's; (c) the
    entry under torchrun at MESH_PIPE 4 on offline_8b at 8 layers
    (``_multi_entry``): every rank exits 0, the ranks agree, and the
    sharded export, each layer written by its stage, converts to finite
    tensors. Then at pipe 2 x model 2 (tensor parallelism inside each
    stage): (d) the 70B QLoRA at full depth (40 layers a stage, half of
    each a card), its p50, peak and base bytes, and in fp32 at 8 layers
    within MESH_LOSS_RTOL of the one card's; (e) the entry under
    torchrun at MESH_PIPE 2 x MESH_MODEL 2 with INFERENCE and
    SERVE_AFTER_TRAIN: exit 0, the comparison and the smoke written.
    Expert parallelism inside a stage is ``train_pp_moe_multi``."""
    import tempfile
    import torch
    n = torch.cuda.device_count()
    emit({"phase": "train_pp_multi_devices", "ok": n >= 4,
          "device_count": n, "nvidia_smi": nvidia_smi_line()})
    if n < 4:
        raise SystemExit(f"train_pp_multi needs 4 cards; this host has {n}")
    refs = {}
    with _tf32_off():
        refs["70b_fp32"], _ = _pp_run(
            dev, _llama_cfg(FT_70B_CONFIG, PP_70B_PARITY_LAYERS, "float32",
                            "float32"), None,
            dict(PP_70B_PLAN, grad_accum=8, pipe_microbatches=0),
            dict(PP_70B_FT, PER_DEVICE_TRAIN_BATCH_SIZE=1),
            config=FT_70B_CONFIG)
    refs["8b_fsdp2"], _ = _pp_run(
        dev, _llama_cfg(ENTRY_CONFIG, PP_MULTI_8B_LAYERS), None,
        PP_MULTI_8B_PLAN, PP_MULTI_8B_FT)
    torch.cuda.empty_cache()
    out = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_pp_multi_"),
                       "rank")
    hung, rcs, ranks = _spawn_ranks("--pp-multi-worker", out, n,
                                    list(range(n)), PP_MULTI_TIMEOUT_S)
    problems, gaps = [], {}
    line = {"phase": "train_pp_multi", "nvidia_smi": nvidia_smi_line(),
            "world": n, "one_card": refs,
            "cut": {"70b": "full depth (20 of 80 layers a card), 1 + 2 "
                    "steps; fp32 at 8 layers", "8b_fsdp2": "8 of 32 "
                    "layers, grad-accum 2 of 4", "entry": "offline_8b at "
                    f"{PP_MULTI_ENTRY_LAYERS} layers", "70b_tp": "full "
                    "depth, 1 + 2 steps; fp32 at 8 layers",
                    "entry_pipe_tp": "offline_8b at "
                    f"{PP_MULTI_ENTRY_LAYERS} layers"}}
    if hung or any(rcs) or None in ranks:
        problems.append(f"ranks hung {hung}, exit codes {rcs}")
    else:
        for r in ranks:
            name = f"rank {r['rank']}"
            gaps[r["rank"]] = {
                "70b_fp32": _hold_streams(f"{name} 70b fp32", r["70b_fp32"],
                                          refs["70b_fp32"],
                                          PP_70B_PARITY_RTOL, problems),
                "8b_fsdp2": _hold_streams(f"{name} 8b fsdp2", r["8b_fsdp2"],
                                          refs["8b_fsdp2"], MESH_MULTI_RTOL,
                                          problems)}
            for k in ("70b", "70b_fp32"):
                cfg = _llama_cfg(FT_70B_CONFIG, r[k]["n_layers"])
                _pp_hold(f"{name} {k}", r[k], cfg, r["rank"], n, problems)
            if not all(np.isfinite(r["70b"]["losses"])):
                problems.append(f"{name} 70b losses {r['70b']['losses']}")
            # pipe 2 x model 2 in fp32: both streams
            gaps[r["rank"]]["tp_70b_fp32"] = _hold_streams(
                f"{name} 70b pipe x model fp32", r["70b_tp_fp32"],
                refs["70b_fp32"], MESH_LOSS_RTOL, problems)
            for k in ("70b_tp", "70b_tp_fp32"):
                cfg = _llama_cfg(FT_70B_CONFIG, r[k]["n_layers"])
                _pp_hold(f"{name} {k}", r[k], cfg, r["pipe_rank"], 2,
                         problems)
            if not all(np.isfinite(r["70b_tp"]["losses"])):
                problems.append(f"{name} 70b pipe x model losses "
                                f"{r['70b_tp']['losses']}")
        held = [r["70b"]["held_before_bytes"] for r in ranks]
        line.update(
            ranks=ranks, rel_gaps=gaps,
            tol_rel={"70b_fp32": PP_70B_PARITY_RTOL,
                     "8b_fsdp2": MESH_MULTI_RTOL},
            p50_70b=[r["70b"]["step_s_p50"] for r in ranks],
            peak_70b=[r["70b"]["peak_mem_bytes"] for r in ranks],
            base_bytes_70b=[r["70b"]["base_bytes"] for r in ranks],
            one_card_full_depth={
                "held_bytes_all_stages": sum(held),
                "card_bytes": torch.cuda.get_device_properties(
                    0).total_memory,
                "fits": sum(held) < torch.cuda.get_device_properties(
                    0).total_memory},
            pipe_tp={
                "mesh": PP_TP_MULTI,
                "p50_70b": [r["70b_tp"]["step_s_p50"] for r in ranks],
                "peak_70b": [r["70b_tp"]["peak_mem_bytes"] for r in ranks],
                "base_bytes_70b": [r["70b_tp"]["base_bytes"]
                                   for r in ranks]})
    entry, entry_problems = _multi_entry(n, PP_MULTI_ENTRY,
                                         layers=PP_MULTI_ENTRY_LAYERS)
    problems += entry_problems
    entry_tp, entry_problems = _multi_entry(
        n, PP_TP_MULTI_ENTRY, layers=PP_MULTI_ENTRY_LAYERS,
        expect_files=("inference_comparison.json", "serve_smoke.json"))
    problems += entry_problems
    line.update(entry=entry, entry_pipe_tp=entry_tp, ok=not problems,
                problems=problems)
    emit(line)
    if problems:
        raise SystemExit("train_pp_multi phase failed: "
                         + "; ".join(problems))
    launches = {}
    for r in ranks:
        for per in (r["launches"], r["launches_tp"]):
            for k, v in per.items():
                if v:
                    launches[k] = launches.get(k, 0) + v
    return launches


def _pp_moe_multi_worker(out_path):
    """One rank of train_pp_moe_multi (NCCL, one card a rank): the
    Mixtral job at pipe 2 x model 2, at full depth in bf16 and at
    ``PP_MOE_FP32_LAYERS`` in fp32, each under the one card's routing
    (``<out_path>.routing_<dtype>.pt``)."""
    import torch
    import torch.distributed as dist
    from gke_ray_train_tpu_torch.parallel import (
        MeshConfig, build_mesh, distributed_init, model_rank, pipe_rank)
    dev = distributed_init()
    rank, world = dist.get_rank(), dist.get_world_size()
    rec = {"rank": rank, "world": world,
           "device_name": torch.cuda.get_device_name(dev)}
    try:
        mesh = build_mesh(MeshConfig(**PP_TP_MULTI))
        rec.update(pipe_rank=pipe_rank(mesh), model_rank=model_rank(mesh))
        for key, layers, dtype in (("bf16", None, "bfloat16"),
                                   ("fp32", PP_MOE_FP32_LAYERS, "float32")):
            torch.cuda.reset_peak_memory_stats()
            flips = []
            rec[key], launches = _pp_moe_run(
                dev, layers, dtype, mesh, flips=flips,
                forced=torch.load(out_path + f".routing_{dtype}.pt"))
            rec[key]["routing_flips"] = int(sum(flips))
            rec.setdefault("launches", {})[key] = launches
            _release()
    finally:
        with open(out_path + f".{rank}", "w") as f:
            json.dump(rec, f)
        dist.barrier()
        dist.destroy_process_group()


def phase_train_pp_moe_multi(dev):
    """Opt-in, the four-card host (fewer than 4 cards fails): expert
    parallelism inside the pipeline stages. One card first: the Mixtral
    job (uint4 base, LoRA r 64, FUSED_OPS=1) as 8 one-row microbatches a
    step at full depth in bf16 and at ``PP_MOE_FP32_LAYERS`` in fp32
    (TF32 off), each recording its routing decisions by layer and
    microbatch (``_routing_by_layer``). Then one rank a card over NCCL
    at pipe 2 x model 2 (``_pp_moe_multi_worker``), 8 one-row pipe
    microbatches a step (grad-accum folded), under those decisions: each
    rank holds its stage's layers and 4 of 8 experts of each bank, flash
    on 16 of 32 query heads, its stage's launches; bf16 losses within
    MESH_MULTI_RTOL of the one card's (the grad_norm gap reported), fp32
    both streams within MESH_LOSS_RTOL; the assignments a rank would
    have decided otherwise (``routing_flips``), a rank's p50 and peak
    against one card's. (At random weights the router's top 2 of 8 sit
    near ties: unforced, the bf16 run at full depth drifted 1.6% from
    one card's loss at step 3 on four H100s.)"""
    import tempfile
    import torch
    n = torch.cuda.device_count()
    emit({"phase": "train_pp_moe_multi_devices", "ok": n >= 4,
          "device_count": n, "nvidia_smi": nvidia_smi_line()})
    if n < 4:
        raise SystemExit(f"train_pp_moe_multi needs 4 cards; this host has "
                         f"{n}")
    out = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_pp_moe_multi_"),
                       "rank")
    refs = {}
    for key, layers, dtype in (("bf16", None, "bfloat16"),
                               ("fp32", PP_MOE_FP32_LAYERS, "float32")):
        torch.cuda.reset_peak_memory_stats()
        record = {}
        refs[key], _ = _pp_moe_run(dev, layers, dtype, record=record)
        torch.save(record, out + f".routing_{dtype}.pt")
        _release()
    hung, rcs, ranks = _spawn_ranks("--pp-moe-multi-worker", out, n,
                                    list(range(n)), PP_MOE_TIMEOUT_S)
    problems, gaps = [], {}
    line = {"phase": "train_pp_moe_multi", "nvidia_smi": nvidia_smi_line(),
            "world": n, "mesh": PP_TP_MULTI, "one_card": refs,
            "quant_store": MOE_STORE,
            "cut": {"bf16": "full depth, 1 + 2 steps", "fp32":
                    f"{PP_MOE_FP32_LAYERS} of 32 layers, 1 + 2 steps"}}
    launches = {}
    if hung or any(rcs) or None in ranks:
        problems.append(f"ranks hung {hung}, exit codes {rcs}")
    else:
        for r in ranks:
            name = f"rank {r['rank']}"
            gaps[r["rank"]] = {
                "bf16": _hold_streams(f"{name} bf16", r["bf16"], refs["bf16"],
                                      MESH_MULTI_RTOL, problems,
                                      held=("losses",)),
                "fp32": _hold_streams(f"{name} fp32", r["fp32"], refs["fp32"],
                                      MESH_LOSS_RTOL, problems)}
            for key, dtype in (("bf16", "bfloat16"), ("fp32", "float32")):
                cfg = _mixtral_cfg(r[key]["n_layers"], dtype)
                _pp_hold(f"{name} {key}", r[key], cfg, r["pipe_rank"], 2,
                         problems)
                _ep_hold(f"{name} {key}", r[key], cfg, 2, problems)
            for per in r["launches"].values():
                for k, v in per.items():
                    if v:
                        launches[k] = launches.get(k, 0) + v
        line.update(
            rel_gaps=gaps, tol_rel={"bf16": MESH_MULTI_RTOL,
                                    "fp32": MESH_LOSS_RTOL},
            p50=[r["bf16"]["step_s_p50"] for r in ranks],
            p50_one_card=refs["bf16"]["step_s_p50"],
            peak_mem_bytes=[r["bf16"]["peak_mem_bytes"] for r in ranks],
            routing_flips={k: [r[k]["routing_flips"] for r in ranks]
                           for k in ("bf16", "fp32")},
            ranks=ranks)
    line.update(ok=not problems, problems=problems)
    emit(line)
    if problems:
        raise SystemExit("train_pp_moe_multi phase failed: "
                         + "; ".join(problems))
    return launches


def phase_profile(dev, steps: int = 10):
    """Where a decode iteration's time goes at the serve phase's model:
    torch.profiler over ``steps`` pure-decode iterations of a full batch
    (8 slots, bucket 512). Device busy share = summed kernel time over
    the window's wall time (one stream, so kernels do not overlap)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from gke_ray_train_tpu_torch.models import init_params, llama3_8b
    from gke_ray_train_tpu_torch.plan import ExecutionPlan
    from gke_ray_train_tpu_torch.serve import BatchEngine
    cfg = dataclasses.replace(
        llama3_8b(param_dtype="bfloat16", dtype="bfloat16", remat=False),
        max_seq_len=512)
    model = init_params(cfg, seed=0, device=dev)
    plan = ExecutionPlan.from_kwargs(max_batch=8, decode_buckets="512")
    engine = BatchEngine(model, cfg, plan=plan, device=dev)
    for r in _requests(8, cfg.vocab_size, seed=3, plen=(300, 400),
                       new=(64, 64)):
        engine.submit(r)
    for _ in range(3):              # admits all 8, then decodes
        engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    kern = [e for e in prof.key_averages() if e.device_type == cuda]
    busy_us = sum(e.self_device_time_total for e in kern)
    launches = sum(e.count for e in kern)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    emit({"phase": "profile", "ok": busy_us > 0, "steps": steps,
          "batch": 8, "bucket": 512, "wall_s": wall,
          "wall_ms_per_step": wall / steps * 1e3,
          "device_busy_ms_per_step": busy_us / steps / 1e3,
          "device_busy_share": busy_us / 1e6 / wall,
          "kernel_launches_per_step": launches / steps,
          "top_kernels": [{"name": e.key[:80],
                           "ms_per_step": e.self_device_time_total
                           / steps / 1e3,
                           "calls_per_step": e.count / steps}
                          for e in top]})
    if busy_us <= 0:
        raise SystemExit("profile phase: the trace shows no device time")


# ---------------------------------------------------------------------------
# phases 14-15: the GPU fine-tune entry
# ---------------------------------------------------------------------------

ENTRY_CONFIG = os.path.join(HERE, "ray-jobs",
                            "fine_tune_config_offline_8b.json")
# the entry phase's cut of that job (1,000 rows, ~125 steps, eval of 200
# rows and a save every 50 steps): 8 steps, a save and an eval of 16
# rows every 4, a log line every 2, TensorBoard on
ENTRY_CUT = {"NUM_TRAIN_SAMPLES": 64, "NUM_EVAL_SAMPLES": 16,
             "SAVE_STEPS_SFT": 4, "EVAL_STEPS_SFT": 4, "LOGGING_STEPS": 2,
             "REPORT_TO": "tensorboard"}
# and in depth: the three runs at this many of the job's 32 layers (the
# default run's time limit, 4 until train_overlap came; entry_full runs
# the job at full depth)
ENTRY_LAYERS = 2
# run B is preempted after this step and run C resumes from it
ENTRY_PREEMPT_AFTER = 5
# run A also compares base and tuned answers and serves the tuned adapter
# after training; the job's 300 new tokens an answer are cut to 64
ENTRY_SERVE = {"INFERENCE": True, "SERVE_AFTER_TRAIN": True,
               "MAX_NEW_GENERATION_TOKENS_INFERENCE": 64}
# a resumed run's losses against the uninterrupted run's (relative); the
# expectation is bitwise: dropout 0, and the seed rebuilds the same base
ENTRY_LOSS_RTOL = 1e-3


def _entry_hooks(rec):
    """Wrap what ``fine_tune.train_loop_per_worker`` calls, to read each
    run: the step (its loss tensors, read after the run so the loop is
    not synchronized, and the host time each step returns), the
    checkpoint manager through its public calls (save, wait and restore
    seconds; the background commits from its ``commit_log``), the eval
    walk (pause seconds, loss) and the export (seconds, shards, bytes).
    Returns the originals, for ``_entry_unhook``; ``_entry_run`` fails
    when a wrapped name went unused."""
    from gke_ray_train_tpu_torch import fine_tune as ft
    from gke_ray_train_tpu_torch import inference
    orig = {n: getattr(ft, n) for n in (
        "make_train_step", "CheckpointManager", "sharded_eval_loss",
        "save_hf_checkpoint", "run_inference_comparison",
        "post_train_smoke")}
    orig["inference.greedy_generate_cached"] = \
        inference.greedy_generate_cached

    def make_train_step(*a, **kw):
        step = orig["make_train_step"](*a, **kw)

        def recorded(state, batch):
            state, m = step(state, batch)
            rec["losses"][state.step] = m["loss"].detach()
            rec["step_done"].append(time.perf_counter())
            return state, m
        return recorded

    class TimedManager(orig["CheckpointManager"]):
        def __init__(self, directory, **kw):
            super().__init__(directory, **kw)
            rec["ckpt_dir"] = directory
            rec["commits"] = self.commit_log

        def save(self, step, state, metrics=None, force=False):
            t = time.perf_counter()
            saved = super().save(step, state, metrics, force)
            if saved:
                rec["saves"].append({"step": step, "force": force,
                                     "call_s": time.perf_counter() - t})
            return saved

        def wait(self, timeout=None):
            t = time.perf_counter()
            super().wait(timeout)
            rec["wait_s"].append(time.perf_counter() - t)

        def restore_if_available(self, state_like):
            t = time.perf_counter()
            out = super().restore_if_available(state_like)
            rec["restore"] = {"step": out[1],
                              "seconds": time.perf_counter() - t}
            return out

    def sharded_eval_loss(*a, **kw):
        t = time.perf_counter()
        loss = orig["sharded_eval_loss"](*a, **kw)
        rec["evals"].append({"seconds": time.perf_counter() - t,
                             "eval_loss": loss})
        return loss

    def save_hf_checkpoint(*a, **kw):
        t = time.perf_counter()
        info = orig["save_hf_checkpoint"](*a, **kw)
        rec["export"] = {"seconds": time.perf_counter() - t, **info,
                         "dir": a[2]}
        return info

    def run_inference_comparison(*a, **kw):
        t = time.perf_counter()
        records = orig["run_inference_comparison"](*a, **kw)
        rec["inference"] = {"seconds": time.perf_counter() - t,
                            "records": records}
        return records

    def post_train_smoke(*a, **kw):
        t = time.perf_counter()
        out = orig["post_train_smoke"](*a, **kw)
        rec["smoke"] = {"seconds": time.perf_counter() - t,
                        "returned": out is not None,
                        "stats": out[1] if out is not None else None}
        return out

    def greedy_generate_cached(params, prompt, prompt_len, cfg, **kw):
        # the new tokens of each answer: the byte tokenizer decodes ids
        # 4-259 only, so a random model's text says little
        out = orig["inference.greedy_generate_cached"](
            params, prompt, prompt_len, cfg, **kw)
        plen = int(np.asarray(prompt_len).reshape(-1)[0])
        row = out[0].cpu().numpy()
        rec["generated"].append(int(np.count_nonzero(
            row[plen:plen + kw["max_new_tokens"]])))
        return out

    for name, fn in (("make_train_step", make_train_step),
                     ("CheckpointManager", TimedManager),
                     ("sharded_eval_loss", sharded_eval_loss),
                     ("save_hf_checkpoint", save_hf_checkpoint),
                     ("run_inference_comparison", run_inference_comparison),
                     ("post_train_smoke", post_train_smoke)):
        setattr(ft, name, fn)
    inference.greedy_generate_cached = greedy_generate_cached
    return orig


def _entry_unhook(orig):
    from gke_ray_train_tpu_torch import fine_tune as ft
    from gke_ray_train_tpu_torch import inference
    for name, fn in orig.items():
        mod, _, attr = name.rpartition(".")
        setattr(inference if mod == "inference" else ft, attr, fn)


def _entry_run(dev, config, label, preempt_after=None):
    """One call of ``fine_tune.train_loop_per_worker(config)`` on the card,
    with the launch counts at 0 just before it and read just after; with
    ``preempt_after`` the context's heartbeat sink sends this process a
    SIGTERM after that step, the loop's own preemption path (a forced
    save, ``Preempted``). Returns what the run's line prints."""
    import gc
    import signal
    import torch
    from gke_ray_train_tpu_torch import fine_tune as ft
    from gke_ray_train_tpu_torch.rayint import get_context
    from gke_ray_train_tpu_torch.train import preempt
    from gke_ray_train_tpu_torch.train.metrics import finish_ledger
    rec = dict(losses={}, step_done=[], saves=[], commits=[], wait_s=[],
               evals=[], restore=None, export=None, ckpt_dir=None,
               inference=None, smoke=None, generated=[])
    ctx = get_context()
    orig = _entry_hooks(rec)

    def sink(rank, step, done):
        if step == preempt_after and not done:
            os.kill(os.getpid(), signal.SIGTERM)
    preempted = None
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_launch_counts()
    if preempt_after is not None:
        preempt.reset()
        preempt.install()
        ctx.set_heartbeat_sink(sink)
    t0 = time.perf_counter()
    try:
        metrics = ft.train_loop_per_worker(config, device=dev)
    except preempt.Preempted as e:
        metrics = None
        preempted = {"step": e.step, "save_s": e.save_s,
                     "grace_s": e.grace_s}
    finally:
        wall = time.perf_counter() - t0
        _entry_unhook(orig)
        if preempt_after is not None:
            ctx.set_heartbeat_sink(None)
            preempt.uninstall()
            preempt.reset()
    torch.cuda.synchronize(dev)
    launches = _launch_counts()
    unused = [n for n, hit in (
        ("make_train_step", rec["losses"]),
        ("CheckpointManager", rec["ckpt_dir"]),
        ("sharded_eval_loss", rec["evals"]),
        ("save_hf_checkpoint", rec["export"] or preempted)) if not hit]
    if unused:
        raise SystemExit(f"entry run {label}: the entry no longer calls "
                         f"{unused} by those names, so the run went unread")
    losses = {s: float(v) for s, v in sorted(rec["losses"].items())}
    gaps = np.diff(rec["step_done"]).tolist()
    ckpt = None
    if rec["ckpt_dir"] is not None:
        from gke_ray_train_tpu_torch.ckpt import CheckpointManager
        mgr = CheckpointManager(rec["ckpt_dir"], score_attribute=None)
        latest = mgr.latest_step()
        ckpt = {"dir": rec["ckpt_dir"], "steps": mgr.all_steps(),
                "latest": latest,
                "bytes": mgr.step_nbytes(latest) if latest else None}
    out = {"label": label, "wall_s": wall, "metrics": metrics,
           "preempted": preempted, "resumed_step": ctx.resumed_step,
           "losses": losses,
           # the host clock between consecutive step returns: the loop
           # synchronizes only where it fetches metrics (log steps,
           # saves, eval), so this is the loop's own rhythm
           "step_gap_s": gaps,
           "step_gap_s_p50": (sorted(gaps)[len(gaps) // 2]
                              if gaps else None),
           "ledger": finish_ledger(ctx.goodput, wall),
           "restore": rec["restore"], "saves": rec["saves"],
           "commits": rec["commits"], "wait_s": rec["wait_s"],
           "checkpoint": ckpt, "evals": rec["evals"],
           "export": rec["export"],
           "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
           "launches": launches, "inference": rec["inference"],
           "generated": rec["generated"], "smoke": rec["smoke"]}
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _entry_config(root, full=False, path=ENTRY_CONFIG, cut=ENTRY_CUT,
                  **over):
    with open(path) as f:
        config = json.load(f)
    if not full:
        config.update(cut)
    config.update(over)
    config["OUTPUT_DIR_BASE"] = root
    return config


def _entry_setup(config, dev, n_layers=None):
    """The model config, LoRA config and the job's shape the entry
    resolves from ``config``: one card, no pretrained directory; with
    ``n_layers`` the depth cut ``_depth_cut`` gives the entry."""
    from gke_ray_train_tpu_torch.models import preset_for_model_id
    from gke_ray_train_tpu_torch.plan import ExecutionPlan
    from gke_ray_train_tpu_torch.train import LoraConfig
    cfg = preset_for_model_id(config["MODEL_ID"], dtype=config["TRAIN_DTYPE"],
                              param_dtype=config["TRAIN_DTYPE"])
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    plan = ExecutionPlan.resolve(config, env={})
    return cfg, LoraConfig.from_dict(config), plan


@contextlib.contextmanager
def _depth_cut(n_layers):
    """While entered, the entry's ``preset_for_model_id`` gives the preset
    cut to ``n_layers`` layers (its widths unchanged)."""
    from gke_ray_train_tpu_torch import fine_tune as ft
    orig = ft.preset_for_model_id
    ft.preset_for_model_id = lambda *a, **kw: dataclasses.replace(
        orig(*a, **kw), n_layers=n_layers)
    try:
        yield
    finally:
        ft.preset_for_model_id = orig


def _entry_disk(root, cfg, lcfg, runs):
    """Free bytes where the entry writes, and what the phase needs: the
    bf16 export (2 bytes a parameter) and ``runs`` checkpoint directories
    of 2 kept steps (adapters and two moments, fp32); fails loudly when
    the disk is short."""
    import shutil
    from gke_ray_train_tpu_torch.models.transformer import proj_shapes
    from gke_ray_train_tpu_torch.train.lora import _effective_targets
    shapes = proj_shapes(cfg)
    trainable = sum(lcfg.r * sum(shapes[t])
                    for t in _effective_targets(cfg, lcfg)) * cfg.n_layers
    need = 2 * cfg.param_count() + runs * 2 * 3 * 4 * trainable + (1 << 30)
    free = shutil.disk_usage(root).free
    if free < need:
        raise SystemExit(
            f"entry phase: {free / 1e9:.2f} GB free under {root}, the "
            f"export and checkpoints need {need / 1e9:.2f} GB")
    return {"root": root, "free_bytes": free, "need_bytes": need}


def _entry_launch_check(cfg, plan, run, n_eval_rows):
    """Launches of one run: each trained step's (``expected_launches``),
    one flash forward a layer per eval batch, per answer the inference
    comparison generates and per prefill of the serving smoke."""
    trained = len(run["losses"])
    per_step = expected_launches(cfg, plan.grad_accum, plan.fused_ops)
    batch = plan.per_device_batch * plan.grad_accum
    eval_batches = len(run["evals"]) * -(-n_eval_rows // batch)
    smoke = (run["smoke"] or {}).get("stats") or {}
    prefills = (eval_batches + len(run["generated"])
                + smoke.get("prefills", 0))
    want = {k: trained * v + (cfg.n_layers * prefills
                              if k == "flash_fwd" else 0)
            for k, v in per_step.items()}
    return want


def _entry_line(phase, run, cfg, plan, want_launches):
    m = run["metrics"] or {}
    keys = ("tokens_per_sec_per_chip", "mfu", "data_stall_frac",
            "tokens_per_sec_per_chip_incl_stalls", "mfu_incl_stalls",
            "compile_s", "restart_to_first_step_s", "loss", "grad_norm",
            "learning_rate", "step", "eval_loss")
    return {"phase": phase, "run": run["label"],
            "nvidia_smi": nvidia_smi_line(), "model": cfg.name,
            "n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "grad_accum": plan.grad_accum, "seq": plan.max_seq_len,
            "meter": {k: m[k] for k in keys if k in m},
            "step_gap_s_p50": run["step_gap_s_p50"],
            "step_gap_s": run["step_gap_s"], "losses": run["losses"],
            "preempted": run["preempted"],
            "resumed_step": run["resumed_step"],
            "restore": run["restore"],
            "restore_s": run["ledger"].get("restore_s"),
            "eval_pause_s": [e["seconds"] for e in run["evals"]],
            "eval_loss": [e["eval_loss"] for e in run["evals"]],
            "saves": run["saves"], "commits": run["commits"],
            "wait_s": run["wait_s"], "checkpoint": run["checkpoint"],
            # the attempt's ledger: lost_s is the entry's time outside
            # the loop (weights, rows, the export)
            "goodput_ledger": run["ledger"],
            "goodput_frac": run["ledger"]["step_s"] / run["wall_s"],
            "wall_s": run["wall_s"],
            "peak_mem_bytes": run["peak_mem_bytes"],
            "launches": {k: run["launches"][k] for k in want_launches},
            "expected_launches": want_launches,
            "inference": _inference_line(run), "serve_smoke": run["smoke"]}


def _inference_line(run):
    inf = run["inference"]
    if inf is None:
        return None
    return {"seconds": inf["seconds"], "records": len(inf["records"]),
            "answer_chars": [
                [len(r["base_model_answer"]),
                 len(r["finetuned_model_answer"])] for r in inf["records"]],
            "generated_tokens": run["generated"]}


def _entry_serve_problems(run, config):
    """Run A's INFERENCE / SERVE_AFTER_TRAIN gates: the comparison file
    holds NUM_EVAL_SAMPLES_INFERENCE records with non-empty tuned answers
    (the trained adapters emit byte-tokenizer ids; the random base's
    answers mostly decode to nothing), each from generated tokens, and
    the smoke returned and wrote every prompt completed through the
    adapter pool."""
    root = config["OUTPUT_DIR_BASE"]
    n = int(config.get("NUM_EVAL_SAMPLES_INFERENCE", 2))
    problems = []
    path = os.path.join(root, "inference_comparison.json")
    records = []
    if os.path.exists(path):
        with open(path) as f:
            records = json.load(f)
    if len(records) != n or run["inference"] is None:
        problems.append(f"inference_comparison.json holds {len(records)} "
                        f"records, want {n}")
    # base and tuned answer per record, in that order
    tuned = run["generated"][1::2]
    if len(run["generated"]) != 2 * n or not all(g >= 1 for g in tuned):
        problems.append(f"tuned answers' new tokens {run['generated']}")
    if not all(r["finetuned_model_answer"] for r in records):
        problems.append("a tuned answer is empty")
    path = os.path.join(root, "serve_smoke.json")
    smoke = run["smoke"] or {}
    if not smoke.get("returned") or not os.path.exists(path):
        problems.append(f"post_train_smoke returned nothing: {smoke}")
    else:
        with open(path) as f:
            stats = json.load(f)
        if stats["completed"] != n or stats["adapter_requests"] != n \
                or stats["pending"]:
            problems.append(f"serve_smoke.json: {stats}")
    return problems


def _entry_adapters(mgr_dir, step, cfg, lcfg, dev):
    """The adapters and moments of a saved step, restored into a fresh
    LoRA view through the port's manager."""
    from gke_ray_train_tpu_torch.ckpt import CheckpointManager, flat_state
    from gke_ray_train_tpu_torch.train import init_lora, make_optimizer
    from gke_ray_train_tpu_torch.train.step import (
        TrainState, trainable_tensors)
    lora = init_lora(cfg, lcfg, seed=1, device=dev)
    view = TrainState(params=None, lora=lora, opt_state=make_optimizer(
        0.0).build(trainable_tensors(None, lora)), step=0)
    CheckpointManager(mgr_dir, score_attribute=None).restore(view, step)
    return view, flat_state(view)


def _same_bf16(x, y):
    """Equal in the export's dtype (the base's own, bf16, at 8B)."""
    import torch
    return torch.equal(x.to(torch.bfloat16), y.to(torch.bfloat16))


_HF_FAMILY = {"llama": ("LlamaForCausalLM", "llama"),
              "mixtral": ("MixtralForCausalLM", "mixtral")}


def _entry_readback(export_dir, cfg, lcfg, view, dev):
    """Read the export back with ``load_hf_checkpoint(quantize="nf4")``
    and hold it against the merged weights quantized directly: the NF4
    base from seed 0 (what the entry trained on) dequantized to fp32,
    plus ``(alpha / r) A B`` of ``view``'s adapters where a projection has
    one (an MoE model's expert banks have none), cast to bf16, then
    quantized. Codes, scales, norms, router, embedding and head must be
    equal bitwise; config.json must be a Llama (Mixtral) config of the
    model's shape."""
    import torch
    from gke_ray_train_tpu_torch.ckpt import load_hf_checkpoint
    from gke_ray_train_tpu_torch.models import init_quantized_params
    from gke_ray_train_tpu_torch.ops.quant import (
        QUANT_TARGETS, dequantize, quantize_tensor)
    t = time.perf_counter()
    back = load_hf_checkpoint(export_dir, cfg, quantize="nf4", device=dev)
    load_s = time.perf_counter() - t
    base = init_quantized_params(cfg, seed=0, kind="nf4", device=dev)
    differ = []
    with torch.no_grad():
        for i, (b, r) in enumerate(zip(base.blocks, back.blocks)):
            for key in QUANT_TARGETS:
                merged = dequantize(getattr(b, key), torch.float32)
                if key in view.lora[i]:
                    ab = view.lora[i][key]
                    merged = merged + (ab["a"].float() @ ab["b"].float()
                                       ) * lcfg.scale
                q = quantize_tensor(merged.to(torch.bfloat16), "nf4")
                got = getattr(r, key)
                del merged
                if not (torch.equal(q.codes, got.codes)
                        and torch.equal(q.scales, got.scales)):
                    differ.append(f"{i}.{key}")
            for key in ("attn_norm", "mlp_norm") + (
                    ("router",) if cfg.n_experts else ()):
                if not _same_bf16(getattr(b, key), getattr(r, key)):
                    differ.append(f"{i}.{key}")
        for key in ("embed", "final_norm", "lm_head"):
            if not _same_bf16(getattr(base, key), getattr(back, key)):
                differ.append(key)
    with open(os.path.join(export_dir, "config.json")) as f:
        hf = json.load(f)
    arch, model_type = _HF_FAMILY["mixtral" if cfg.n_experts else "llama"]
    want = {"architectures": [arch], "model_type": model_type,
            "hidden_size": cfg.d_model, "num_hidden_layers": cfg.n_layers,
            "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads,
            "intermediate_size": cfg.d_ff, "vocab_size": cfg.vocab_size,
            "rope_scaling": ({"rope_type": "llama3",
                              **dict(cfg.rope_scaling)}
                             if cfg.rope_scaling else None)}
    if cfg.n_experts:
        want.update(num_local_experts=cfg.n_experts,
                    num_experts_per_tok=cfg.expert_top_k)
    config_ok = all(hf.get(k) == v for k, v in want.items())
    del back, base
    torch.cuda.empty_cache()
    return {"load_quantized_s": load_s, "projections": cfg.n_layers * len(
        QUANT_TARGETS), "differ": differ, "config_json": config_ok,
        "tokenizer": sorted(f for f in os.listdir(export_dir)
                            if "tokenizer" in f)}


# the Gemma-2 4k job through the entry on one card, with its own
# ATTN_IMPL a2a (the flash path without a context axis): cut as ENTRY_CUT
# cuts the Llama job, and in depth (a merged export of 4 layers)
GEMMA_ENTRY_LAYERS = 4
GEMMA_ENTRY_CUT = dict(ENTRY_CUT, SAVE_STEPS_SFT=1, EVAL_STEPS_SFT=1,
                       LOGGING_STEPS=1)


def _entry_gemma(dev, root):
    """``fine_tune.py``'s worker on ray-jobs/fine_tune_config_gemma2_4k.
    json, ``GEMMA_ENTRY_CUT`` and ``GEMMA_ENTRY_LAYERS`` deep, with the
    config's ATTN_IMPL (``a2a``, no override): the model the entry built
    must carry it, every step and eval batch launch the flash kernels as
    a step of that model does, the losses be finite and the export be
    written. Returns (line, launches)."""
    from gke_ray_train_tpu_torch import fine_tune as ft
    config = _entry_config(os.path.join(root, "gemma"), path=GEMMA2_CONFIG,
                           cut=GEMMA_ENTRY_CUT)
    cfg, lcfg, plan = _entry_setup(config, dev, n_layers=GEMMA_ENTRY_LAYERS)
    seen = []
    orig = ft.make_train_step

    def make_train_step(mcfg, *a, **kw):
        seen.append(mcfg.attn_impl)
        return orig(mcfg, *a, **kw)
    ft.make_train_step = make_train_step
    try:
        with _depth_cut(GEMMA_ENTRY_LAYERS):
            run = _entry_run(dev, config, "gemma")
    finally:
        ft.make_train_step = orig
    want = _entry_launch_check(cfg, plan, run,
                               int(config["NUM_EVAL_SAMPLES"]))
    line = _entry_line("entry_gemma", run, cfg, plan, want)
    problems = []
    if seen != [config["ATTN_IMPL"]] or seen != ["a2a"]:
        problems.append(f"the entry built attn_impl {seen}")
    if line["launches"] != want:
        problems.append(f"launches {line['launches']} != {want}")
    if not run["losses"] or not all(np.isfinite(v)
                                    for v in run["losses"].values()):
        problems.append(f"losses {run['losses']}")
    if not (run["export"] or {}).get("bytes"):
        problems.append(f"export {run['export']}")
    line.update(ok=not problems, problems=problems, attn_impl=seen,
                config=os.path.relpath(GEMMA2_CONFIG, HERE),
                cut=GEMMA_ENTRY_CUT, export={
                    k: (run["export"] or {}).get(k)
                    for k in ("seconds", "bytes")})
    return line, {k: run["launches"][k] for k, n in want.items() if n}


def phase_entry(dev):
    """``python -m gke_ray_train_tpu_torch.fine_tune``'s worker on the card:
    ray-jobs/fine_tune_config_offline_8b.json at full width, cut in depth
    to ``ENTRY_LAYERS`` layers (Llama-3.1-8B, bf16, random NF4 base from
    seed 0, LoRA r 64 / alpha 16 / dropout 0, 2 x 4 microbatches of 1,024
    on synthetic SQL rows), cut to ``ENTRY_CUT`` (8 steps, a save and an
    eval of 16 rows every 4), written under a temporary directory.
    Three runs: A uninterrupted; B in a fresh directory with
    ASYNC_CKPT=1, preempted after step
    ``ENTRY_PREEMPT_AFTER`` (SIGTERM, forced save, ``Preempted``); C
    resuming B's directory (restore, fast-forward, steps 6-8). C's losses
    of steps 6-8 and its last checkpoint's adapters and moments are held
    against A's (bitwise expected; a loss more than ``ENTRY_LOSS_RTOL``
    off fails); A's export is read back quantized and held bitwise
    against the merged weights (``_entry_readback``). One line per run
    and one for the export; the free disk is checked first."""
    import shutil
    import tempfile
    import torch
    os.environ["HF_HUB_OFFLINE"] = "1"
    os.environ["HF_DATASETS_OFFLINE"] = "1"
    root = tempfile.mkdtemp(prefix="chip_smoke_entry_")
    try:
        ca = _entry_config(os.path.join(root, "a"))
        cfg, lcfg, plan = _entry_setup(ca, dev, n_layers=ENTRY_LAYERS)
        disk = _entry_disk(root, cfg, lcfg, runs=2)
        n_eval = int(ca["NUM_EVAL_SAMPLES"])
        problems = []
        lines = {}
        runs = {}
        ca.update(ENTRY_SERVE)
        with _depth_cut(ENTRY_LAYERS):
            for label, config, kw in (
                    ("A", ca, {}),
                    ("B", _entry_config(os.path.join(root, "b"),
                                        ASYNC_CKPT=1),
                     {"preempt_after": ENTRY_PREEMPT_AFTER}),
                    ("C", _entry_config(os.path.join(root, "b")), {})):
                run = _entry_run(dev, config, label, **kw)
                want = _entry_launch_check(cfg, plan, run, n_eval)
                line = _entry_line("entry", run, cfg, plan, want)
                emit(line)
                lines[label], runs[label] = line, run
                if line["launches"] != want:
                    problems.append(f"{label}: launches "
                                    f"{line['launches']} != {want}")
                if not all(np.isfinite(v) for v in run["losses"].values()):
                    problems.append(f"{label}: non-finite loss")
                if label == "A":
                    problems += _entry_serve_problems(run, config)
                    adapters_a, flat_a = _entry_adapters(
                        run["checkpoint"]["dir"],
                        run["checkpoint"]["latest"], cfg, lcfg, dev)
                    export = dict(run["export"])
                    export["readback"] = _entry_readback(
                        export["dir"], cfg, lcfg, adapters_a, dev)
                    del adapters_a
                    shutil.rmtree(export["dir"])
        a, b, c = runs["A"], runs["B"], runs["C"]
        steps = sorted(a["losses"])
        if steps != list(range(1, 9)) or sorted(b["losses"]) != list(
                range(1, ENTRY_PREEMPT_AFTER + 1)) or sorted(
                c["losses"]) != list(range(ENTRY_PREEMPT_AFTER + 1, 9)):
            problems.append(f"trained steps A {sorted(a['losses'])} B "
                            f"{sorted(b['losses'])} C {sorted(c['losses'])}")
        if (b["preempted"] or {}).get("step") != ENTRY_PREEMPT_AFTER:
            problems.append(f"B was not preempted at step "
                            f"{ENTRY_PREEMPT_AFTER}: {b['preempted']}")
        if c["resumed_step"] != ENTRY_PREEMPT_AFTER:
            problems.append(f"C resumed from {c['resumed_step']}")
        rel = {s: abs(c["losses"][s] - a["losses"][s])
               / max(abs(a["losses"][s]), 1e-30) for s in c["losses"]}
        # B's steps before the preemption: the same run as A's
        rel.update({f"B{s}": abs(b["losses"][s] - a["losses"][s])
                    / max(abs(a["losses"][s]), 1e-30)
                    for s in b["losses"]})
        if any(r > ENTRY_LOSS_RTOL for r in rel.values()):
            problems.append(f"losses off by {rel}")
        _, flat_c = _entry_adapters(c["checkpoint"]["dir"],
                                    c["checkpoint"]["latest"], cfg, lcfg,
                                    dev)
        # per entry: max |C - A| relative to max |A|
        differ = {}
        for k, v in flat_a.items():
            if not torch.is_tensor(v):
                if v != flat_c[k]:
                    differ[k] = float("inf")
            elif not torch.equal(v, flat_c[k]):
                differ[k] = float((v - flat_c[k]).abs().max()
                                  / v.abs().max().clamp_min(1e-30))
        flat_keys = list(flat_a)
        del flat_a, flat_c
        if any(r > ENTRY_LOSS_RTOL for r in differ.values()):
            problems.append(f"{len(differ)} checkpoint entries differ: "
                            f"{dict(list(differ.items())[:4])}")
        rb = export["readback"]
        if rb["differ"] or not rb["config_json"]:
            problems.append(f"export read-back: {rb}")
        emit({"phase": "entry_export", "run": "A",
              "seconds": export["seconds"], "bytes": export["bytes"],
              "shards": len(export["shards"]), "readback": rb,
              "disk": disk})
        gemma, gemma_launches = _entry_gemma(dev, root)
        emit(gemma)
        problems += [f"gemma: {p}" for p in gemma["problems"]]
        emit({"phase": "entry", "ok": not problems, "problems": problems,
              "resumed_vs_uninterrupted": {
                  "loss_rel_diff": rel, "bitwise_losses": all(
                      r == 0 for r in rel.values()),
                  "checkpoint_entries": len(flat_keys),
                  "checkpoint_entries_differ": differ},
              "config": os.path.relpath(ENTRY_CONFIG, HERE),
              "cut": ENTRY_CUT, "serve_run_A": ENTRY_SERVE,
              "preempt_after": ENTRY_PREEMPT_AFTER})
        if problems:
            raise SystemExit("entry phase failed: " + "; ".join(problems))
        launches = {k: sum(runs[r]["launches"][k] for r in runs)
                    for k, n in lines["A"]["expected_launches"].items()
                    if n}
        for k, n in gemma_launches.items():
            launches[k] = launches.get(k, 0) + n
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_entry_full(dev):
    """The entry on ray-jobs/fine_tune_config_offline_8b.json unchanged
    (1,000 rows, ~125 steps, eval of 200 rows and a save every 50 steps,
    the export), but for its output directory, a temporary one: the
    loop's meter, MFU, goodput and ledger at the job's length, without
    a synchronize around each step."""
    import shutil
    import tempfile
    os.environ["HF_HUB_OFFLINE"] = "1"
    os.environ["HF_DATASETS_OFFLINE"] = "1"
    root = tempfile.mkdtemp(prefix="chip_smoke_entry_full_")
    try:
        config = _entry_config(root, full=True)
        cfg, lcfg, plan = _entry_setup(config, dev)
        disk = _entry_disk(root, cfg, lcfg, runs=1)
        run = _entry_run(dev, config, "full")
        want = _entry_launch_check(cfg, plan, run,
                                   int(config["NUM_EVAL_SAMPLES"]))
        line = _entry_line("entry_full", run, cfg, plan, want)
        problems = []
        if line["launches"] != want:
            problems.append(f"launches {line['launches']} != {want}")
        if not all(np.isfinite(v) for v in run["losses"].values()):
            problems.append("non-finite loss")
        line.update(ok=not problems, problems=problems, disk=disk,
                    export={k: v for k, v in (run["export"] or {}).items()
                            if k != "dir"})
        emit(line)
        if problems:
            raise SystemExit("entry_full phase failed: "
                             + "; ".join(problems))
        return {k: run["launches"][k] for k, n in want.items() if n}
    finally:
        shutil.rmtree(root, ignore_errors=True)


# 4 -> 2 layers: cut for the pipe x model and pipelined-decode cases'
# time (train_pp, serve_mesh)
MOE_ENTRY_LAYERS = 2
# entry_moe's cut of the Mixtral job (1,000 rows, ~125 steps, an eval of
# 200 rows and a save every 50): 4 steps of 8 rows, a save and an eval of
# 8 rows every 2, a log line every 2
MOE_ENTRY_CUT = {"NUM_TRAIN_SAMPLES": 32, "NUM_EVAL_SAMPLES": 8,
                 "SAVE_STEPS_SFT": 2, "EVAL_STEPS_SFT": 2,
                 "LOGGING_STEPS": 2}


def phase_entry_moe(dev):
    """``fine_tune.py``'s worker on ray-jobs/fine_tune_config_mixtral.json
    at full width with the depth cut to ``MOE_ENTRY_LAYERS`` layers (the
    merged bf16 export of the full depth is 93.4 GB; at 2 layers about 7
    GB) and ``MOE_ENTRY_CUT`` (4 steps, a save and an eval of 8 rows every
    2), ``QUANT_STORE=uint4``, written under a temporary directory whose
    free disk (``df``) is printed first. The launches must be the
    trained steps' and the eval batches'; the merged export is read back
    quantized and its NF4 codes and scales (expert banks included),
    router, norms, embedding and head must equal the merged weights
    quantized directly, bitwise (``_entry_readback``)."""
    import shutil
    import tempfile
    os.environ["HF_HUB_OFFLINE"] = "1"
    os.environ["HF_DATASETS_OFFLINE"] = "1"
    root = tempfile.mkdtemp(prefix="chip_smoke_entry_moe_")
    try:
        config = _entry_config(root, path=MIXTRAL_CONFIG, cut=MOE_ENTRY_CUT)
        cfg, lcfg, plan = _entry_setup(config, dev,
                                       n_layers=MOE_ENTRY_LAYERS)
        df = subprocess.run(["df", "-B1", root], capture_output=True,
                            text=True, timeout=60).stdout
        disk = _entry_disk(root, cfg, lcfg, runs=1)
        emit({"phase": "entry_moe_disk", "df": df.strip().splitlines(),
              **disk})
        with _depth_cut(MOE_ENTRY_LAYERS), _quant_store(MOE_STORE):
            run = _entry_run(dev, config, "A")
            want = _entry_launch_check(cfg, plan, run,
                                       int(config["NUM_EVAL_SAMPLES"]))
            line = _entry_line("entry_moe", run, cfg, plan, want)
            problems = []
            if line["launches"] != want:
                problems.append(f"launches {line['launches']} != {want}")
            if sorted(run["losses"]) != [1, 2, 3, 4] or not all(
                    np.isfinite(v) for v in run["losses"].values()):
                problems.append(f"losses {run['losses']}")
            if len(run["evals"]) < 2:
                problems.append(f"evals {run['evals']}")
            ckpt = run["checkpoint"]
            view, _ = _entry_adapters(ckpt["dir"], ckpt["latest"], cfg,
                                      lcfg, dev)
            export = dict(run["export"])
            rb = _entry_readback(export["dir"], cfg, lcfg, view, dev)
            del view
        if rb["differ"] or not rb["config_json"]:
            problems.append(f"export read-back: {rb}")
        line.update(ok=not problems, problems=problems,
                    config=os.path.relpath(MIXTRAL_CONFIG, HERE),
                    cut=MOE_ENTRY_CUT, quant_store=MOE_STORE,
                    export={"seconds": export["seconds"],
                            "bytes": export["bytes"],
                            "shards": len(export["shards"]),
                            "readback": rb})
        emit(line)
        if problems:
            raise SystemExit("entry_moe phase failed: " + "; ".join(problems))
        return {k: run["launches"][k] for k, n in want.items() if n}
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# phases 21 / 22: the pre-train entry through the trainer
# ---------------------------------------------------------------------------

# pretrain.py::job_config at full width (2,048 d / 24 layers / 16 heads
# / 8,192 ff, seq 256, 16 rows a step, bf16 over fp32 masters) on the
# synthetic corpus, cut to this many steps, a log line every step
PRETRAIN_STEPS = 8
# run A's depth cut: its one save of the 24-layer state (fp32 params and
# two moments, 12 bytes a parameter) would write ~19 GB; 8 until
# train_overlap came
PRETRAIN_LAYERS = 4
# the fault drill's: a save every 2 steps, two of them kept
PRETRAIN_DRILL_LAYERS = 2
# pretrain_multi's runs (fsdp 4: a rank writes a quarter of each save)
PRETRAIN_MULTI_LAYERS = 6
PRETRAIN_DRILL_EVERY = 2
PRETRAIN_DRILL_SPEC = "kind=kill:step=5;kind=sigterm:step=7"
# the retried attempts' peak memory against the first attempt's
PRETRAIN_PEAK_SLACK = 1 << 30
# a bf16 smoke token that differs from bf16 greedy's must have lost a
# near tie: greedy's logit for it within this many bf16 ulps (at greedy's
# top logit) of greedy's top
BF16_FLIP_ULPS = 4
PRETRAIN_MULTI_RANKS = 4
PRETRAIN_MULTI_KILL_STEP = 4
PRETRAIN_MULTI_TIMEOUT_S = 420


def _pretrain_config(root, n_layers=None, **over):
    from gke_ray_train_tpu_torch import pretrain
    config = pretrain.job_config(env={})
    config.update(max_samples=PRETRAIN_STEPS
                  * config["batch_size_per_device"], log_every=1,
                  data_dir=os.path.join(root, "data"),
                  storage_path=os.path.join(root, "runs"))
    if n_layers is not None:
        config["n_layers"] = n_layers
    config.update(over)
    return config


def _pretrain_hooks(rec, sync, ckpt_every=None):
    """Wrap ``pretrain.make_train_step`` (each step's loss tensor, read
    after the run, and with ``sync`` its time between synchronizes),
    ``pretrain.post_train_smoke`` (its completions and inputs) and
    ``pretrain.run_training`` (with ``ckpt_every``, a save every that
    many steps; the entry saves once an epoch)."""
    import torch
    from gke_ray_train_tpu_torch import pretrain
    orig = {n: getattr(pretrain, n) for n in (
        "make_train_step", "post_train_smoke", "run_training")}

    def make_train_step(*a, **kw):
        step = orig["make_train_step"](*a, **kw)

        def recorded(state, batch):
            if sync:
                torch.cuda.synchronize()
            t = time.perf_counter()
            state, m = step(state, batch)
            if sync:
                torch.cuda.synchronize()
                rec["step_s"].append(time.perf_counter() - t)
            rec["calls"] += 1
            rec["losses"][int(state.step)] = m["loss"].detach()
            return state, m
        return recorded

    def post_train_smoke(params, cfg, plan, prompts, **kw):
        out = orig["post_train_smoke"](params, cfg, plan, prompts, **kw)
        rec["smoke"] = dict(out=out, params=params, cfg=cfg, plan=plan,
                            prompts=prompts, kw=kw)
        return out
    def run_training(*a, **kw):
        if ckpt_every:
            kw["ckpt_every"] = ckpt_every
        return orig["run_training"](*a, **kw)
    pretrain.make_train_step = make_train_step
    pretrain.post_train_smoke = post_train_smoke
    pretrain.run_training = run_training
    return orig


def _pretrain_fit(dev, config, label, spec=None, max_failures=0,
                  sync=False, ckpt_every=None):
    """``pretrain.train_loop_per_worker`` through ``TorchTrainer.fit()``
    on the local path, on the card, with the launch counts at 0 just
    before and read just after, and ``FAULT_SPEC=spec`` while it runs;
    each attempt's memory at its start and its peak."""
    import gc
    import torch
    from gke_ray_train_tpu_torch import pretrain
    from gke_ray_train_tpu_torch.rayint import (
        FailureConfig, RunConfig, TorchTrainer)
    from gke_ray_train_tpu_torch.testing import faults
    rec = dict(losses={}, step_s=[], calls=0, smoke=None, attempts=[])

    def worker(cfg):
        torch.cuda.synchronize(dev)
        att = {"start_bytes": torch.cuda.memory_allocated(dev)}
        rec["attempts"].append(att)
        torch.cuda.reset_peak_memory_stats(dev)
        try:
            return pretrain.train_loop_per_worker(cfg, device=dev)
        finally:
            att["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    orig = _pretrain_hooks(rec, sync, ckpt_every)
    faults.reset_fired()
    faults.reset_pool()
    if spec:
        os.environ["FAULT_SPEC"] = spec
    gc.collect()
    torch.cuda.empty_cache()
    _reset_launch_counts()
    t0 = time.perf_counter()
    try:
        result = TorchTrainer(
            worker, train_loop_config=config,
            run_config=RunConfig(
                name=f"pretrain-{label}", retry_backoff_s=0.0,
                failure_config=FailureConfig(max_failures=max_failures)),
            use_ray=False).fit()
    finally:
        wall = time.perf_counter() - t0
        os.environ.pop("FAULT_SPEC", None)
        for name, fn in orig.items():
            setattr(pretrain, name, fn)
        faults.reset_fired()
    torch.cuda.synchronize(dev)
    rec.update(label=label, wall_s=wall, result=result,
               launches=_launch_counts(),
               failures=sum(e["status"] == "failed"
                            for e in result.attempt_log))
    return rec


def _ckpt_digests(run_dir):
    """{key: sha256 of the bytes} of the latest checkpoint of
    ``run_dir``, read one step to the CPU, and that step."""
    import hashlib
    import torch
    from gke_ray_train_tpu_torch.ckpt import CheckpointManager
    mgr = CheckpointManager(run_dir, score_attribute=None)
    step = mgr.latest_step()
    out = {}
    for head, v in mgr.restore_raw(step).items():
        for k, x in (v.items() if isinstance(v, dict) else [(None, v)]):
            key = head if k is None else f"{head}/{k}"
            if torch.is_tensor(x):
                out[key] = hashlib.sha256(
                    x.contiguous().view(torch.uint8).numpy()).hexdigest()
            else:
                out[key] = repr(x)
    return step, out


def _pretrain_disk(root, cfg_full, cfg_cut):
    """Free bytes where the phase writes against what it needs: run A's
    one save (12 bytes a parameter) or a drill run's two kept saves of
    the cut depth, one run directory at a time."""
    import shutil
    need = max(12 * cfg_full.param_count(),
               2 * 12 * cfg_cut.param_count()) + (1 << 30)
    free = shutil.disk_usage(root).free
    if free < need:
        raise SystemExit(
            f"pretrain phase: {free / 1e9:.2f} GB free under {root}, the "
            f"checkpoints need {need / 1e9:.2f} GB")
    return {"root": root, "free_bytes": free, "need_bytes": need}


def _pretrain_serve(dev, smoke, problems):
    """The smoke's prompts on the trained weights against sequential
    greedy decoding, then the same weights through a two-replica
    ``ServeDeployment``: its completions must be the single engine's, and
    its board must hold both replicas' iterations.

    The smoke's bf16 completions are held against bf16 greedy: the
    engine's decode step ([max_batch, 1]) and greedy's ([1, 1]) take
    GEMMs of other shapes, so a near-tied pair of logits may flip. At
    each mismatch the first divergent position is read in greedy's own
    logits, and the engine's token must lie within ``BF16_FLIP_ULPS``
    bf16 ulps (at greedy's top logit) of greedy's; greedy's closest
    top-1 / top-2 gap over each completion is reported. The same prompts
    then go through the engine and ``greedy_generate_cached`` in float32
    (TF32 off), which must agree token for token."""
    import torch
    from gke_ray_train_tpu_torch.models import greedy_generate_cached
    from gke_ray_train_tpu_torch.models import kvcache
    from gke_ray_train_tpu_torch.rayint import ServeDeployment
    from gke_ray_train_tpu_torch.serve import (
        BatchEngine, Request, form_prompt_buffer)
    comps, stats = smoke["out"]
    params, cfg, plan = smoke["params"], smoke["cfg"], smoke["plan"]
    prompts = {c.rid: np.asarray(smoke["prompts"][int(c.rid[len("smoke"):])],
                                 np.int32) for c in comps}

    def greedy(c, model_cfg):
        """greedy's buffer and the float32 logits of each of its
        ``forward_step`` calls (the prefill's [T, V], then one [1, V] a
        decode step), and the prompt's length."""
        buf, plen = form_prompt_buffer(prompts[c.rid], c.bucket)
        seen, orig = [], kvcache.forward_step

        def logged(*a, **kw):
            logits, cache = orig(*a, **kw)
            seen.append(logits[0].float())
            return logits, cache
        kvcache.forward_step = logged
        try:
            ref = greedy_generate_cached(
                params, buf, [plen], model_cfg,
                max_new_tokens=c.length - c.prompt_len, device=dev)
        finally:
            kvcache.forward_step = orig
        return ref[0].cpu().numpy(), seen, plen

    def bf16_ulp(x):
        return 2.0 ** (math.floor(math.log2(max(abs(x), 2.0 ** -126))) - 7)

    def greedy_mismatches(completions, model_cfg, margins=None,
                          closest=None):
        out = []
        for c in completions:
            ref, seen, plen = greedy(c, model_cfg)
            # the logits that chose each generated position: the
            # prefill's at the prompt's last token, then one a decode step
            chose = [seen[0][plen - 1]] + [x[0] for x in seen[1:]]
            chose = chose[:c.length - plen]
            if closest is not None:
                top = [lv.topk(2).values for lv in chose]
                closest[c.rid] = min(float(t[0] - t[1]) / bf16_ulp(float(
                    t[0])) for t in top) if top else None
            if np.array_equal(ref, c.tokens):
                continue
            out.append(c.rid)
            if margins is None:
                continue
            n = min(len(ref), len(c.tokens))
            diff = np.flatnonzero(ref[:n] != c.tokens[:n])
            j = int(diff[0]) if len(diff) else None
            m = {"rid": c.rid, "pos": j, "prompt_len": plen}
            if j is not None and plen <= j < plen + len(chose):
                lv = chose[j - plen]
                want, got = int(ref[j]), int(c.tokens[j])
                top = lv.topk(2).values
                ulp = bf16_ulp(float(top[0]))
                gap = float(lv[want] - lv[got])
                m.update(greedy_token=want, engine_token=got,
                         logit_top1=float(top[0]),
                         gap_top2=float(top[0] - top[1]),
                         gap_engine_token=gap, bf16_ulp=ulp,
                         gap_ulps=gap / ulp)
            margins.append(m)
        return out
    bf16_margins, bf16_closest = [], {}
    bf16_mismatched = greedy_mismatches(comps, cfg, bf16_margins,
                                        bf16_closest)
    wide = [m for m in bf16_margins
            if m.get("gap_ulps") is None or m["gap_ulps"] > BF16_FLIP_ULPS]
    fp32 = dataclasses.replace(cfg, dtype="float32")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        fp32_comps = BatchEngine(params, fp32, plan=plan,
                                 device=dev).run_until_drained([
            Request(rid=c.rid, token_ids=prompts[c.rid],
                    max_new_tokens=c.length - c.prompt_len)
            for c in comps])
        mismatched = greedy_mismatches(fp32_comps, fp32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    dep = ServeDeployment(
        lambda: BatchEngine(params, cfg, plan=plan, device=dev),
        num_replicas=2, use_ray=False)
    dep.start(warm=False)
    try:
        got = dep.serve([{"rid": c.rid, "token_ids": prompts[c.rid],
                          "max_new_tokens": smoke["kw"].get(
                              "max_new_tokens", 32)} for c in comps])
        board = dep.board_snapshot()
    finally:
        dep.shutdown()
    single = {c.rid: c.tokens.tolist() for c in comps}
    differ = [p["rid"] for p in got if p["tokens"] != single[p["rid"]]]
    if mismatched or len(fp32_comps) != len(comps):
        problems.append(f"fp32 engine completions {mismatched} differ from "
                        "sequential greedy decoding")
    if wide:
        problems.append(f"bf16 engine completions differ from greedy "
                        f"beyond {BF16_FLIP_ULPS} bf16 ulps of a near tie: "
                        f"{wide}")
    if differ or len(got) != len(comps):
        problems.append(f"deployment completions {differ} differ from the "
                        f"single engine's ({len(got)} of {len(comps)})")
    if sorted(board) != [0, 1] or any(v["step"] < 1 for v in board.values()):
        problems.append(f"deployment board {board}")
    return {"requests": len(comps), "generated": [
        c.length - c.prompt_len for c in comps],
        "greedy_equal_fp32": not mismatched, "mismatched_fp32": mismatched,
        "greedy_equal_bf16": not bf16_mismatched,
        "mismatched_bf16": bf16_mismatched, "bf16_margins": bf16_margins,
        "bf16_greedy_closest_top2_ulps": bf16_closest,
        "bf16_flip_ulps": BF16_FLIP_ULPS,
        "deployment_equal": not differ, "board": board,
        "smoke_stats": {k: stats.get(k) for k in (
            "prefills", "generated_tokens", "wall_s", "batch_occupancy",
            "p50_token_latency_s")}}


def _embedding_determinism(dev, cfg, rows, seq):
    """``F.embedding``'s backward at the pre-train step's shape (the
    char vocab, ``rows`` x ``seq`` tokens, an fp32 table under a bf16
    cast), five times each under the default algorithms and under
    ``torch.use_deterministic_algorithms``: whether the table's gradient
    repeats bitwise, and by how much it moves when it does not."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator(device=dev).manual_seed(0)
    table = torch.randn(cfg.vocab_size, cfg.d_model, device=dev,
                        requires_grad=True)
    idx = torch.randint(0, cfg.vocab_size, (rows, seq), device=dev,
                        generator=g)
    up = torch.randn(rows, seq, cfg.d_model, device=dev,
                     generator=g).to(torch.bfloat16)
    out = {}
    prev = torch.are_deterministic_algorithms_enabled()
    try:
        for name, det in (("default", False), ("deterministic", True)):
            torch.use_deterministic_algorithms(det, warn_only=True)
            grads = []
            for _ in range(5):
                table.grad = None
                F.embedding(idx, table).to(torch.bfloat16).backward(up)
                grads.append(table.grad.clone())
            out[name] = {
                "bitwise": all(torch.equal(grads[0], x) for x in grads[1:]),
                "max_abs_diff": max(float((grads[0] - x).abs().max())
                                    for x in grads[1:])}
    finally:
        torch.use_deterministic_algorithms(prev)
    return out


def _pretrain_launches(cfg, rec, prefills=0):
    per = expected_launches(cfg, 1, True, full_ft=True)
    return {k: rec["calls"] * v + (cfg.n_layers * prefills
                                   if k == "flash_fwd" else 0)
            for k, v in per.items()}


def phase_pretrain(dev):
    """``gke_ray_train_tpu_torch/pretrain.py``'s worker through
    ``TorchTrainer.fit()`` on the card (module doc, 21): run A at full
    width and ``PRETRAIN_LAYERS`` deep with SERVE_AFTER_TRAIN, then the
    fault drill at ``PRETRAIN_DRILL_LAYERS``, A' uninterrupted against B
    under ``PRETRAIN_DRILL_SPEC`` with one failure allowed."""
    import shutil
    import tempfile
    import torch
    from gke_ray_train_tpu_torch.models import basic_lm
    from gke_ray_train_tpu_torch.train.metrics import (
        peak_flops_per_device, train_flops_per_token)
    os.environ["HF_HUB_OFFLINE"] = "1"
    os.environ["HF_DATASETS_OFFLINE"] = "1"
    prev_fused = os.environ.get("FUSED_OPS")
    os.environ["FUSED_OPS"] = "1"
    root = tempfile.mkdtemp(prefix="chip_smoke_pretrain_")
    problems = []
    try:
        config = _pretrain_config(root, n_layers=PRETRAIN_LAYERS,
                                  SERVE_AFTER_TRAIN=True)
        # the char vocab is the corpus's: sized here for the disk check
        # with the widest vocab a byte corpus could give
        full = basic_lm(256, d_model=config["d_model"],
                        n_layers=config["n_layers"],
                        n_heads=config["n_heads"], d_ff=config["d_ff"])
        cut = dataclasses.replace(full, n_layers=PRETRAIN_DRILL_LAYERS)
        disk = _pretrain_disk(root, full, cut)
        a = _pretrain_fit(dev, config, "A", sync=True)
        res = a["result"]
        if res.error or res.attempts != 1:
            raise SystemExit(f"pretrain run A: {res.status} after "
                             f"{res.attempts} attempt(s): {res.error}")
        smoke = a.pop("smoke")
        cfg = smoke["cfg"] if smoke else None
        if cfg is None:
            raise SystemExit("pretrain run A: SERVE_AFTER_TRAIN never ran")
        serve = _pretrain_serve(dev, smoke, problems)
        del smoke
        seq, rows = config["dataset_seq_len"], config["batch_size_per_device"]
        step_s = a["step_s"][1:]
        p50 = sorted(step_s)[len(step_s) // 2]
        tokens = seq * rows
        peak = peak_flops_per_device(torch.cuda.get_device_name(dev))
        want = _pretrain_launches(cfg, a,
                                  serve["smoke_stats"]["prefills"] or 0)
        if a["launches"] != want:
            problems.append(f"A: launches {a['launches']} != {want}")
        losses_a = {s: float(v) for s, v in sorted(a["losses"].items())}
        if sorted(losses_a) != list(range(1, PRETRAIN_STEPS + 1)) or \
                not all(np.isfinite(list(losses_a.values()))):
            problems.append(f"A: losses {losses_a}")
        m = res.metrics
        line_a = {
            "phase": "pretrain", "run": "A", "nvidia_smi": nvidia_smi_line(),
            "model": cfg.name, "params": cfg.param_count(),
            "d_model": cfg.d_model, "n_layers": cfg.n_layers,
            "vocab": cfg.vocab_size, "seq": seq, "rows": rows,
            "dtype": cfg.dtype, "param_dtype": cfg.param_dtype,
            "step_s": a["step_s"], "step_s_p50": p50,
            "tokens_per_s": tokens / p50,
            "mfu": train_flops_per_token(cfg, seq) * tokens / p50 / peak,
            "peak_flops": peak,
            "meter": {k: m.get(k) for k in (
                "tokens_per_sec_per_chip", "mfu", "compile_s",
                "restart_to_first_step_s", "loss", "grad_norm",
                "learning_rate", "step")},
            "losses": losses_a,
            "peak_mem_bytes": a["attempts"][0]["peak_bytes"],
            "goodput": res.goodput, "wall_s": a["wall_s"],
            "launches": a["launches"], "expected_launches": want,
            "serve": serve}
        emit(line_a)
        shutil.rmtree(os.path.join(config["storage_path"]),
                      ignore_errors=True)
        del a
        # the fault drill, under deterministic algorithms: by default the
        # embedding's backward sums its rows in no fixed order, so two
        # uninterrupted runs already differ in the fp32 table
        embed_det = _embedding_determinism(dev, cfg, rows, seq)
        drill = {}
        digests = {}
        torch.use_deterministic_algorithms(True, warn_only=True)
        for label, spec, budget in (("A'", None, 0),
                                    ("B", PRETRAIN_DRILL_SPEC, 1)):
            dconfig = _pretrain_config(
                root, n_layers=PRETRAIN_DRILL_LAYERS,
                run_name=f"drill_{len(drill)}")
            run = _pretrain_fit(dev, dconfig, label, spec=spec,
                                max_failures=budget,
                                ckpt_every=PRETRAIN_DRILL_EVERY)
            run_dir = os.path.join(dconfig["storage_path"],
                                   dconfig["run_name"])
            digests[label] = _ckpt_digests(run_dir)
            shutil.rmtree(run_dir, ignore_errors=True)
            want = _pretrain_launches(cut, run)
            if run["launches"] != want:
                problems.append(f"{label}: launches {run['launches']} != "
                                f"{want}")
            drill[label] = run
            r = run["result"]
            emit({"phase": "pretrain", "run": label,
                  "n_layers": PRETRAIN_DRILL_LAYERS,
                  "ckpt_every": PRETRAIN_DRILL_EVERY, "fault_spec": spec,
                  "max_failures": budget, "status": r.status,
                  "error": r.error, "attempts": r.attempts,
                  "failures": run["failures"],
                  "preemptions": r.preemptions,
                  "attempt_log": [{k: v for k, v in e.items()
                                   if k != "goodput"}
                                  for e in r.attempt_log],
                  "goodput": r.goodput,
                  "attempt_memory": run["attempts"],
                  "steps_trained": run["calls"],
                  "losses": {s: float(v) for s, v in
                             sorted(run["losses"].items())},
                  "checkpoint_step": digests[label][0],
                  "wall_s": run["wall_s"], "launches": run["launches"]})
        torch.use_deterministic_algorithms(False)
        ref, b = drill["A'"], drill["B"]
        r = b["result"]
        if (r.status, r.attempts, b["failures"], r.preemptions) != \
                ("ok", 3, 1, 1):
            problems.append(f"B: status {r.status}, attempts {r.attempts}, "
                            f"failures {b['failures']}, preemptions "
                            f"{r.preemptions} (want ok / 3 / 1 / 1)")
        if sorted(ref["losses"]) != list(range(1, PRETRAIN_STEPS + 1)) or \
                sorted(b["losses"]) != sorted(ref["losses"]):
            problems.append(f"drill steps A' {sorted(ref['losses'])} B "
                            f"{sorted(b['losses'])}")
        unequal = [s for s in ref["losses"] if s in b["losses"] and
                   not torch.equal(ref["losses"][s], b["losses"][s])]
        if unequal:
            problems.append(f"B's losses at steps {unequal} are not A''s")
        (sa, da), (sb, db) = digests["A'"], digests["B"]
        differ = sorted(k for k in da if da[k] != db.get(k))
        if sa != PRETRAIN_STEPS or sb != PRETRAIN_STEPS or differ \
                or set(da) != set(db):
            problems.append(f"last checkpoints: steps {sa} / {sb}, "
                            f"{len(differ)} entries differ: {differ[:4]}")
        peaks = [x["peak_bytes"] for x in b["attempts"]]
        over = [p - peaks[0] for p in peaks[1:]]
        if len(peaks) != 3 or any(d > PRETRAIN_PEAK_SLACK for d in over):
            problems.append(f"B's attempt peaks {peaks}: retries over the "
                            f"first by {over} bytes")
        emit({"phase": "pretrain", "ok": not problems, "problems": problems,
              "nvidia_smi": nvidia_smi_line(), "disk": disk,
              "embedding_backward": embed_det,
              "drill": {"spec": PRETRAIN_DRILL_SPEC,
                        "n_layers": PRETRAIN_DRILL_LAYERS,
                        "deterministic_algorithms": True,
                        "bitwise_losses": not unequal,
                        "checkpoint_entries": len(da),
                        "checkpoint_entries_differ": differ,
                        "attempt_peaks": peaks,
                        "retry_peak_over_first": over}})
        if problems:
            raise SystemExit("pretrain phase failed: " + "; ".join(problems))
        counts = {}
        for run in [line_a] + [drill[k] for k in drill]:
            for k, n in run["launches"].items():
                counts[k] = counts.get(k, 0) + n
        return {k: n for k, n in counts.items() if n}
    finally:
        torch.use_deterministic_algorithms(False)
        if prev_fused is None:
            os.environ.pop("FUSED_OPS", None)
        else:
            os.environ["FUSED_OPS"] = prev_fused
        shutil.rmtree(root, ignore_errors=True)


def _pretrain_worker(config_path, out_path):
    """One rank of pretrain_multi, started by torchrun (its env): the
    entry's worker through ``TorchTrainer.fit()`` (one in-process worker
    a rank, no retry), each step's loss recorded; writes
    ``<out_path>.<rank>`` and exits 1 on an error ``Result``."""
    import torch
    from gke_ray_train_tpu_torch.rayint import TorchTrainer
    with open(config_path) as f:
        config = json.load(f)
    # the embedding's backward repeats bitwise only so (phase 21)
    torch.use_deterministic_algorithms(True, warn_only=True)
    rec = dict(losses={}, step_s=[], calls=0, smoke=None)
    _pretrain_hooks(rec, sync=False, ckpt_every=PRETRAIN_DRILL_EVERY)
    from gke_ray_train_tpu_torch import pretrain
    result = TorchTrainer(pretrain.train_loop_per_worker,
                          train_loop_config=config, use_ray=False).fit()
    rank = int(os.environ["RANK"])
    with open(out_path + f".{rank}", "w") as f:
        json.dump({"rank": rank, "status": result.status,
                   "error": result.error, "attempts": result.attempts,
                   "resumed_step": result.attempt_log[0].get(
                       "resumed_step"),
                   "losses": {s: float(v).hex()
                              for s, v in sorted(rec["losses"].items())},
                   # what post_train_smoke returned here (rank 0's stats)
                   "smoke": (rec["smoke"]["out"][1] if rec["smoke"]
                             and rec["smoke"]["out"] else None)},
                  f)
    if result.error:
        raise SystemExit(1)


def phase_pretrain_multi(dev):
    """The entry under torchrun on the four-card host (module doc, 22):
    at fsdp 4 with ASYNC_CKPT=1, an uninterrupted run, then a run killed
    during the commit of step ``PRETRAIN_MULTI_KILL_STEP`` (it must exit
    non-zero and leave COMMITTING without COMMITTED), then its resume:
    from the previous committed step, every loss bitwise the
    uninterrupted run's."""
    import shutil
    import tempfile
    import torch
    n = torch.cuda.device_count()
    if n < PRETRAIN_MULTI_RANKS:
        raise SystemExit(f"pretrain_multi needs {PRETRAIN_MULTI_RANKS} "
                         f"cards, this host has {n}")
    os.environ["HF_HUB_OFFLINE"] = "1"
    root = tempfile.mkdtemp(prefix="chip_smoke_pretrain_multi_")
    problems = []
    lines = {}
    try:
        env = dict(os.environ, FUSED_OPS="1", ASYNC_CKPT="1",
                   PREEMPT_SYNC_EVERY="1", CKPT_STORAGE_DELAY_S="2")
        rows = PRETRAIN_STEPS * 16 * PRETRAIN_MULTI_RANKS
        for label, run_name, spec in (
                ("U", "u", None),
                ("K", "k", f"kind=kill_during_commit:step="
                           f"{PRETRAIN_MULTI_KILL_STEP}"),
                ("R", "k", None)):
            config = _pretrain_config(
                root, n_layers=PRETRAIN_MULTI_LAYERS, run_name=run_name,
                max_samples=rows, MESH_FSDP=PRETRAIN_MULTI_RANKS)
            cfg_path = os.path.join(root, f"{label}.json")
            with open(cfg_path, "w") as f:
                json.dump(config, f)
            out = os.path.join(root, f"{label}.rank")
            cmd = [sys.executable, "-m", "torch.distributed.run",
                   "--nnodes", "1", "--nproc-per-node",
                   str(PRETRAIN_MULTI_RANKS), "--master-addr", "127.0.0.1",
                   "--master-port", str(_free_port()),
                   os.path.abspath(__file__), "--pretrain-worker", cfg_path,
                   out]
            run_env = dict(env, **({"FAULT_SPEC": spec} if spec else {}))
            log_path = os.path.join(root, f"{label}.log")
            t0 = time.perf_counter()
            with open(log_path, "w") as log:
                proc = subprocess.Popen(cmd, env=run_env, cwd=HERE,
                                        stdout=log, stderr=subprocess.STDOUT)
                hung, rcs = _wait_all([proc], PRETRAIN_MULTI_TIMEOUT_S)
            ranks = _read_ranks(out, PRETRAIN_MULTI_RANKS)
            run_dir = os.path.join(config["storage_path"], run_name)
            markers = sorted(os.path.basename(p) for p in glob.glob(
                os.path.join(run_dir, "COMMITT*")))
            line = {"phase": "pretrain_multi", "run": label,
                    "fault_spec": spec, "exit_code": rcs[0],
                    "hung": bool(hung), "wall_s": time.perf_counter() - t0,
                    "markers": markers, "ranks": ranks}
            if hung or (rcs[0] == 0) != (spec is None) or (
                    spec is None and None in ranks):
                with open(log_path) as f:
                    line["log_tail"] = f.read()[-6000:]
                problems.append(f"{label}: exit code {rcs[0]}, hung "
                                f"{bool(hung)}")
            emit(line)
            lines[label] = line
        k = PRETRAIN_MULTI_KILL_STEP
        prev = k - PRETRAIN_DRILL_EVERY
        if f"COMMITTING.{k}" not in lines["K"]["markers"] or \
                f"COMMITTED.{k}" in lines["K"]["markers"]:
            problems.append(f"K left markers {lines['K']['markers']}")
        u = lines["U"]["ranks"][0] or {}
        for r in lines["R"]["ranks"]:
            r = r or {}
            if r.get("resumed_step") != prev:
                problems.append(f"R resumed from {r.get('resumed_step')}, "
                                f"not {prev}")
            diff = [s for s, v in r.get("losses", {}).items()
                    if u.get("losses", {}).get(s) != v]
            if diff or sorted(r.get("losses", {}), key=int) != [
                    str(s) for s in range(prev + 1, PRETRAIN_STEPS + 1)]:
                problems.append(f"R rank {r.get('rank')}: losses at "
                                f"{diff} differ from U's, or steps "
                                f"{sorted(r.get('losses', {}), key=int)}")
        emit({"phase": "pretrain_multi", "ok": not problems,
              "problems": problems, "nvidia_smi": nvidia_smi_line(),
              "ranks": PRETRAIN_MULTI_RANKS,
              "n_layers": PRETRAIN_MULTI_LAYERS,
              "kill_during_commit_step": k})
        if problems:
            raise SystemExit("pretrain_multi failed: " + "; ".join(problems))
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# serving across ranks: the decode path on a model sharded as trained
# ---------------------------------------------------------------------------

# serve_mesh: the 8B job's model (NF4 base from seed 0, an r-64 adapter on
# the seven projections, as the entry serves a QLoRA run) at full width
# cut to 4 layers; fp32 at 2; four prompts of 100-400 tokens in a 512
# bucket, 32 new tokens each
SERVE_MESH_LAYERS = 4
SERVE_MESH_FP32_LAYERS = 2
SERVE_MESH_PLENS = (100, 200, 300, 400)
SERVE_MESH_BUCKET = 512
SERVE_MESH_NEW = 32
# the prefill's last-position logits against one process, in units of
# the one-process logits' scale (their largest |logit|): fp32, and bf16,
# where each rank sums the row-parallel partials in bf16 as JAX's GSPMD
# does (on an H100: 0.020 of the scale at model 2 and 4 layers, 0.034 at
# model 4 and 8 layers of the 70B; the same prompts prefilled one at a
# time against all four at once move the 8B's logits by 0.018 of it in
# one process, ``_prefill_noise``)
SERVE_MESH_LOGITS_TOL = {"bfloat16": 5e-2, "float32": 1e-4}
# bf16: the top-2 margin, in units of that scale or of the one-process
# noise where that is more, under which one process's pick is a near tie
SERVE_MESH_MARGIN = 1e-2
SERVE_MESH_CASES = {"model2": dict(fsdp=1, model=2), "fsdp2": dict(fsdp=2),
                    "pipe2": dict(fsdp=1, pipe=2)}
# what each case runs on the one card, with its new tokens: the model-2
# case the generate and the smoke in bf16 and the generate in fp32; the
# fsdp-2 case the bf16 generate cut to 2 new tokens (each step gathers
# the 2.1 GB root twice and the blocks through gloo's host-staged pair,
# 4.6 s a step; serve_mesh_multi decodes 32 at fsdp 4 over NCCL); the
# pipe-2 case (each rank 2 of the 4 layers, the activations handed from
# stage to stage through host memory) the bf16 and fp32 generates
SERVE_MESH_RUNS = {"model2": {"generate": 32, "smoke": 32, "fp32": 32},
                   "fsdp2": {"generate": 1},
                   "pipe2": {"generate": 32, "fp32": 32}}
SERVE_MESH_TIMEOUT_S = 600
# the collectives of each case on the card's tensors: the model group's
# sums (the row-parallel outputs, the vocab-sharded lookup) and the pick's
# max and min, the world's broadcast of the picked tokens, FSDP2's
# all-gather on the fsdp group, a stage's hand-over to the next
SERVE_MESH_PROBE = {"all_reduce_sum_bf16_model": ("model2",),
                    "all_reduce_max_f32_model": ("model2",),
                    "all_reduce_min_i64_model": ("model2",),
                    "broadcast_i32_world": ("model2", "fsdp2", "pipe2"),
                    "all_gather_into_tensor_fsdp": ("fsdp2",),
                    "send_recv_bf16_pipe": ("pipe2",)}

# serve_mesh_multi: the 70B layout at fsdp 1 x model 4, 8 of 80 layers
SERVE_70B_LAYERS = 8
SERVE_MULTI_TIMEOUT_S = 900
SERVE_MULTI_PRETRAIN_LAYERS = 6


def _serve_probe(dev, mesh, case):
    """The collectives of ``SERVE_MESH_PROBE`` ``case`` makes, once each
    on this card's tensors: {name: "ok" or the error}."""
    import torch
    import torch.distributed as dist
    calls = {
        "all_reduce_sum_bf16_model": lambda: dist.all_reduce(
            torch.ones(64, dtype=torch.bfloat16, device=dev),
            group=mesh["model"].get_group()),
        "all_reduce_max_f32_model": lambda: dist.all_reduce(
            torch.ones(64, device=dev), op=dist.ReduceOp.MAX,
            group=mesh["model"].get_group()),
        "all_reduce_min_i64_model": lambda: dist.all_reduce(
            torch.ones(64, dtype=torch.int64, device=dev),
            op=dist.ReduceOp.MIN, group=mesh["model"].get_group()),
        "broadcast_i32_world": lambda: dist.broadcast(
            torch.ones(64, dtype=torch.int32, device=dev), src=0),
        "all_gather_into_tensor_fsdp": lambda: dist.all_gather_into_tensor(
            torch.empty(64 * mesh["fsdp"].size(), dtype=torch.uint8,
                        device=dev),
            torch.ones(64, dtype=torch.uint8, device=dev),
            group=mesh["fsdp"].get_group()),
        "send_recv_bf16_pipe": lambda: _probe_hand_over(dev, mesh)}
    out = {}
    for name, cases in SERVE_MESH_PROBE.items():
        if case not in cases:
            continue
        try:
            calls[name]()
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as e:  # noqa: BLE001 - the probe reports it
            out[name] = f"{type(e).__name__}: {e}"[:400]
    return out


def _probe_hand_over(dev, mesh):
    """One stage-to-stage hand-over of the decode on this card's tensors
    (``ops/ring_attention.py::send_recv`` over the pipe group: rank 0 of
    the pipe sends, the next receives) and its value checked."""
    import torch
    from gke_ray_train_tpu_torch.ops.ring_attention import send_recv
    group, p = mesh["pipe"].get_group(), mesh["pipe"].get_local_rank()
    x = torch.full((4, 1, 64), 3.0, dtype=torch.bfloat16, device=dev)
    if p == 0:
        send_recv([x], 1, [], 1, group)
    elif p == 1:
        got = send_recv([], 0, [x], 0, group)[0]
        if not torch.equal(got, x):
            raise RuntimeError("the hand-over changed the activations")


def _serve_prompts(vocab):
    """The four prompts, right-padded in one bucket-wide buffer, and
    their lengths."""
    rng = np.random.default_rng(23)
    buf = np.zeros((len(SERVE_MESH_PLENS), SERVE_MESH_BUCKET), np.int32)
    for i, n in enumerate(SERVE_MESH_PLENS):
        buf[i, :n] = rng.integers(1, vocab, n)
    return buf, np.asarray(SERVE_MESH_PLENS, np.int32)


def _serve_model(cfg, dev, mesh, quant=True):
    """(the served model, its adapter or None): with ``quant`` the NF4
    base from seed 0 and an r-64 adapter (``_tenant_adapters``), else
    the full-precision model from seed 0; sharded over ``mesh`` when
    given."""
    from gke_ray_train_tpu_torch.models import (
        init_params, init_quantized_params)
    from gke_ray_train_tpu_torch.parallel.sharding import shard_model
    if quant:
        params = init_quantized_params(cfg, seed=0, kind="nf4", device=dev,
                                       mesh=mesh)
    else:
        params = init_params(cfg, seed=0, device=dev)
    if mesh is not None:
        shard_model(params, mesh)
    return params, (_tenant_adapters(cfg, dev, 7) if quant else None)


@contextlib.contextmanager
def _serve_watch(rec):
    """While entered, into ``rec``: the first picks' logits (the
    prefill's at each prompt's last position: one pick of all rows, or
    the engine's one a prompt; a vocab shard under TP), each pick's
    top-2 margin where its logits span the vocab, each decode
    step's seconds (one ``forward_step`` of T = 1 between synchronizes)
    and the (query, KV) heads of each flash call."""
    from gke_ray_train_tpu_torch.device import synchronize
    from gke_ray_train_tpu_torch.models import kvcache
    from gke_ray_train_tpu_torch.ops import dispatch
    from gke_ray_train_tpu_torch.serve import engine
    orig = (kvcache.greedy_pick, kvcache.forward_step,
            dispatch.attention_dispatch)
    rec.update(picks=[], margins=[], step_s=[], heads=[])

    def pick(logits, params, cfg):
        if len(rec["picks"]) < len(SERVE_MESH_PLENS):
            rec["picks"].append(logits.detach().float().cpu())
        if logits.shape[-1] == cfg.vocab_size:
            top = logits.detach().float().topk(2, dim=-1).values
            rec["margins"].append((top[..., 0] - top[..., 1]).cpu())
        return orig[0](logits, params, cfg)

    def step(params, tokens, cfg, cache, lens, **kw):
        if tokens.shape[1] != 1:
            return orig[1](params, tokens, cfg, cache, lens, **kw)
        synchronize(tokens.device)
        t = time.perf_counter()
        out = orig[1](params, tokens, cfg, cache, lens, **kw)
        synchronize(tokens.device)
        rec["step_s"].append(time.perf_counter() - t)
        return out

    def attend(impl, q, k, *a, **kw):
        rec["heads"].append((int(q.shape[2]), int(k.shape[2])))
        return orig[2](impl, q, k, *a, **kw)
    kvcache.greedy_pick = engine.greedy_pick = pick
    kvcache.forward_step = engine.forward_step = step
    dispatch.attention_dispatch = attend
    try:
        yield rec
    finally:
        kvcache.greedy_pick = engine.greedy_pick = orig[0]
        kvcache.forward_step = engine.forward_step = orig[1]
        dispatch.attention_dispatch = orig[2]


def _serve_timed(dev, fn):
    """``fn()`` from launch counts at 0 and a fresh peak, watched:
    (its result, the record)."""
    import torch
    from gke_ray_train_tpu_torch.device import synchronize
    from gke_ray_train_tpu_torch.ops.flash_attention import flash_attention
    synchronize(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _reset_launch_counts()
    t0 = time.perf_counter()
    with _serve_watch({}) as rec:
        out = fn()
    synchronize(dev)
    wall = time.perf_counter() - t0
    steps = sorted(rec["step_s"])
    rec.update(wall_s=wall, flash_launches=flash_attention.launches,
               step_s_p50=steps[len(steps) // 2] if steps else None,
               decode_steps=len(steps),
               peak_mem_bytes=(torch.cuda.max_memory_allocated(dev)
                               if dev.type == "cuda" else 0),
               heads=sorted(set(rec["heads"])))
    return out, rec


def _serve_runs(dev, cfg, mesh, runs, quant=True):
    """``runs`` ({kind: new tokens}) of serve_mesh on this rank (or the
    one card without ``mesh``): "generate" (``greedy_generate_cached``
    over the four prompts with the adapter), "smoke" (``post_train_smoke``
    of the same prompts, each tagged with the adapter) and "fp32" (the
    generate at ``SERVE_MESH_FP32_LAYERS`` layers in float32, TF32 off).
    Each: the generated tokens a row and the watch's record (the
    prefill's logits: "prefill", rows stacked)."""
    import torch
    from gke_ray_train_tpu_torch.models.kvcache import (
        greedy_generate_cached)
    from gke_ray_train_tpu_torch.plan import ExecutionPlan
    from gke_ray_train_tpu_torch.serve import post_train_smoke
    buf, plen = _serve_prompts(cfg.vocab_size)
    scale = TENANT_ALPHA / TENANT_RANK
    out = {}

    def generate(params, lora, c, new):
        toks = greedy_generate_cached(
            params, buf, plen, c, max_new_tokens=new, lora=lora,
            lora_scale=scale, device=dev).cpu().numpy()
        return [toks[i, n:n + new].tolist() for i, n in enumerate(plen)]

    def prefill(rec, kind):
        # the generate's first pick holds every row; the engine's first
        # picks one prompt each
        picks = rec.pop("picks")
        return picks[0] if kind != "smoke" else torch.cat(picks)
    if "generate" in runs or "smoke" in runs:
        params, lora = _serve_model(cfg, dev, mesh, quant)
        if mesh is None:
            out["unit_bytes"] = {
                "block": _module_nbytes(params.blocks[0]),
                "root": sum(t.numel() * t.element_size() for t in (
                    params.embed, params.final_norm, params.lm_head)
                    if t is not None)}
        if "generate" in runs:
            toks, rec = _serve_timed(dev, lambda: generate(
                params, lora, cfg, runs["generate"]))
            out["generate"] = dict(rec, tokens=toks,
                                   prefill=prefill(rec, "generate"))
            if mesh is None:
                out["noise"] = _prefill_noise(
                    params, lora, scale, cfg, dev, buf, plen,
                    out["generate"])
        if "smoke" in runs:
            plan = ExecutionPlan.from_kwargs(
                max_batch=len(plen), decode_buckets=str(SERVE_MESH_BUCKET))
            res, rec = _serve_timed(dev, lambda: post_train_smoke(
                params, cfg, plan, [buf[i, :n] for i, n in enumerate(plen)],
                lora=lora, lora_scale=scale,
                adapter_ids=["tuned"] * len(plen),
                max_new_tokens=runs["smoke"], device=dev))
            out["smoke"] = dict(rec, returned=res is not None,
                                prefill=prefill(rec, "smoke"))
            if res is not None:
                comps, stats = res
                out["smoke"].update(
                    tokens=[c.generated.tolist() for c in comps],
                    stats={k: v for k, v in stats.items()
                           if isinstance(v, (int, float))})
        del params, lora
        _release()
    if "fp32" in runs:
        c32 = dataclasses.replace(cfg, n_layers=SERVE_MESH_FP32_LAYERS,
                                  dtype="float32", param_dtype="float32")
        with _tf32_off():
            params, lora = _serve_model(c32, dev, mesh, quant)
            toks, rec = _serve_timed(dev, lambda: generate(
                params, lora, c32, runs["fp32"]))
        out["fp32"] = dict(rec, tokens=toks, prefill=prefill(rec, "fp32"))
        del params, lora
        _release()
    return out


def _prefill_noise(params, lora, scale, cfg, dev, buf, plen, gen):
    """What bf16 alone moves this process's prefill logits: each prompt
    prefilled on its own (batch 1) against the generate's prefill of all
    four (batch 4), same weights and width, max |difference| at each
    prompt's last position; beside the generate's first picks' top-2
    margins."""
    import torch
    from gke_ray_train_tpu_torch.models.kvcache import (
        forward_step, init_cache)
    rows = []
    with torch.no_grad():
        for i, n in enumerate(plen):
            cache = init_cache(cfg, 1, buf.shape[1], device=dev)
            lg, _ = forward_step(
                params, torch.as_tensor(buf[i:i + 1], device=dev), cfg,
                cache, torch.zeros(1, dtype=torch.int32, device=dev),
                lora=lora, lora_scale=scale)
            rows.append(lg[0, int(n) - 1].float().cpu())
    return {"batch1_vs_batch4_prefill_max_abs": float(
        (torch.stack(rows) - gen["prefill"]).abs().max()),
        "first_pick_margins": [float(m) for m in gen["margins"][0]]}


def _near_tie_cut(margins, n_rows, margin, engine=False):
    """Each row's first generated position whose one-process pick had a
    top-2 margin under ``margin`` (``SERVE_MESH_NEW`` where none had):
    the picks in call order, ``greedy_generate_cached``'s one [rows] a
    step, or the engine's prefills of one row each (in admission order)
    and then its decode steps over every slot (slot i request i)."""
    per_row = [[] for _ in range(n_rows)]
    calls = list(margins)
    if engine:
        for i in range(n_rows):
            per_row[i].append(float(calls[i].reshape(-1)[0]))
        calls = calls[n_rows:]
    for m in calls:
        for i in range(n_rows):
            per_row[i].append(float(m.reshape(-1)[i]))
    cut = []
    for row in per_row:
        low = [p for p, m in enumerate(row[:SERVE_MESH_NEW]) if m < margin]
        cut.append(low[0] if low else SERVE_MESH_NEW)
    return cut


def _serve_hold(name, got, want, new, problems, margin=None,
                engine=False):
    """``got``'s ``new`` tokens a row against the first ``new`` of
    ``want``'s (one process's; greedy decoding is prefix-consistent):
    all equal without a ``margin``, else up to each row's first near tie
    of ``want``; a problem otherwise. Returns each row's cut."""
    rows = len(want["tokens"])
    cut = ([SERVE_MESH_NEW] * rows if margin is None
           else _near_tie_cut(want["margins"], rows, margin, engine))
    cut = [min(c, new) for c in cut]
    for i, (g, w) in enumerate(zip(got["tokens"], want["tokens"])):
        if len(g) != new or g[:cut[i]] != w[:cut[i]]:
            problems.append(f"{name}: row {i} tokens differ before its "
                            f"near tie at {cut[i]}: {g[:8]} against "
                            f"{w[:8]}")
    return cut


def _serve_gathered_bytes(units, n_layers, n):
    """Bytes one rank receives by FSDP2 all-gathers in a decode step
    (one ``forward_step``) at fsdp ``n``, reckoned from the unsharded
    model's ``units`` bytes: the root (embedding, final norm, head) is
    gathered around the embedding and again around the head, each block
    once; a rank receives (n - 1) / n of each."""
    whole = 2 * units["root"] + n_layers * units["block"]
    return dict(units, whole=whole, per_rank=int(whole * (n - 1) / n))


def _serve_mesh_worker(out_path):
    """One of serve_mesh's two ranks on the one card (env: RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT): a gloo group with the card's
    tensors; for each of ``SERVE_MESH_CASES`` the mesh, the collectives
    its decode makes probed, and where they run its
    ``SERVE_MESH_RUNS``; writes ``<out_path>.<rank>.pt``."""
    import torch
    import torch.distributed as dist
    from gke_ray_train_tpu_torch.parallel import MeshConfig, build_mesh
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method="env://")
    rank = dist.get_rank()
    rec = {"rank": rank, "backend": dist.get_backend(), "probe": {},
           "runs": {}}
    try:
        cfg = _llama_cfg(FINE_TUNE_CONFIG, SERVE_MESH_LAYERS)
        for case, axes in SERVE_MESH_CASES.items():
            mesh = build_mesh(MeshConfig(**axes), device_type="cuda")
            rec["probe"][case] = probe = _serve_probe(dev, mesh, case)
            if all(v == "ok" for v in probe.values()):
                rec["runs"][case] = _serve_runs(dev, cfg, mesh,
                                                SERVE_MESH_RUNS[case])
    finally:
        torch.save(rec, out_path + f".{rank}.pt")
        dist.barrier()
        dist.destroy_process_group()


def _serve_ranks(flag, out, n, local_ranks, timeout):
    """``n`` ranks of this script with ``flag out`` (``_spawn_ranks``):
    (hung, exit codes, what each rank saved or None)."""
    import torch
    hung, rcs, _ = _spawn_ranks(flag, out, n, local_ranks, timeout)
    ranks = []
    for rank in range(n):
        path = out + f".{rank}.pt"
        ranks.append(torch.load(path, weights_only=False)
                     if os.path.exists(path) else None)
    return hung, rcs, ranks


def _serve_summary(run):
    """A run's numbers for the line (no tensors): tokens/s where the run
    returned its tokens."""
    out = {k: run[k] for k in ("wall_s", "step_s_p50", "decode_steps",
                               "flash_launches", "peak_mem_bytes", "heads")
           if k in run}
    if run.get("tokens"):
        gen = sum(len(t) for t in run["tokens"])
        # over the call (the prefill and a first call's set-up in it),
        # and in the steady decode: the rows over the per-token p50
        out.update(generated_tokens=gen, tokens_per_s=gen / run["wall_s"])
        if run.get("step_s_p50"):
            out["decode_tokens_per_s"] = len(run["tokens"]) / run[
                "step_s_p50"]
    return out


def _serve_hold_ranks(one, ranks, case, problems, cfg, model, runs_new,
                      pipe=1):
    """A case's ranks against one process, for each kind of
    ``runs_new`` ({kind: new tokens}): the prefill's last-position logits
    (under TP the ranks' vocab shards side by side; over ``pipe`` the
    last stage's, the others holding none) within
    ``SERVE_MESH_LOGITS_TOL`` of the one-process logits' scale (their
    largest |logit|); in bf16 the tokens up to each row's first pick
    whose one-process top-2 margin is under ``SERVE_MESH_MARGIN`` of
    that scale or the one-process bf16 noise (``one["noise"]``),
    whichever is more, in fp32 every token; the ranks' tokens equal; row
    1's launches (a stage's layers') and heads; a rank's per-token p50
    against one process's. Returns the case's line."""
    import torch
    line = {}
    runs = [r["runs"][case] for r in ranks]
    layers = {"generate": cfg.n_layers, "smoke": cfg.n_layers,
              "fp32": SERVE_MESH_FP32_LAYERS}
    prefills = {"generate": 1, "smoke": len(SERVE_MESH_PLENS), "fp32": 1}
    heads = [(cfg.n_heads // model, cfg.n_kv_heads // model)]
    for kind, new in runs_new.items():
        want = one[kind]
        entry = {"new_tokens": new,
                 "ranks": [_serve_summary(r[kind]) for r in runs],
                 "one_process": _serve_summary(want)}
        # the stages without the head hold no vocab shard
        shards = [r[kind]["prefill"] for r in runs
                  if r[kind]["prefill"].shape[-1]]
        logits = torch.cat(shards, dim=-1) if model > 1 else shards[0]
        scale = float(want["prefill"].abs().max())
        noise = one["noise"]["batch1_vs_batch4_prefill_max_abs"]
        err = float((logits - want["prefill"]).abs().max())
        bf16 = kind != "fp32"
        tol = SERVE_MESH_LOGITS_TOL["bfloat16" if bf16 else "float32"]
        margin = max(SERVE_MESH_MARGIN * scale, noise)
        entry.update(prefill_max_abs_err=err, logit_scale=scale,
                     prefill_rel_err=err / scale, prefill_tol_rel=tol)
        if want.get("step_s_p50"):
            entry["p50_ratio"] = [r[kind]["step_s_p50"] / want["step_s_p50"]
                                  for r in runs]
        if bf16:
            entry["near_tie_margin"] = margin
        if not err <= tol * scale:
            problems.append(f"{case} {kind} prefill logits off by {err}, "
                            f"over {tol} of their scale {scale}")
        if kind == "smoke" and [r[kind]["returned"] for r in runs] != [
                True] + [False] * (len(runs) - 1):
            problems.append(f"{case} smoke returned on "
                            f"{[r[kind]['returned'] for r in runs]}")
        held = [r[kind] for r in runs if r[kind].get("tokens")]
        for i, r in enumerate(held):
            entry["near_tie_cut"] = _serve_hold(
                f"{case} {kind} rank {i}", r, want, new, problems,
                margin=margin if bf16 else None,
                engine=kind == "smoke")
            if r["tokens"] != held[0]["tokens"]:
                problems.append(f"{case} {kind}: ranks' tokens differ")
        want_launches = layers[kind] // pipe * prefills[kind]
        for i, r in enumerate(runs):
            if r[kind]["flash_launches"] != want_launches:
                problems.append(f"{case} {kind} rank {i}: flash launches "
                                f"{r[kind]['flash_launches']} != "
                                f"{want_launches}")
            if [tuple(h) for h in r[kind]["heads"]] != heads:
                problems.append(f"{case} {kind} rank {i}: flash on heads "
                                f"{r[kind]['heads']}, want {heads}")
        entry["want_flash_launches"] = want_launches
        line[kind] = entry
    return line


def phase_serve_mesh(dev):
    """Serving on a sharded model, two ranks of the one card over gloo
    (module doc, 11g): this process's one-process runs first, then the
    ranks (``_serve_mesh_worker``) at model 2, at fsdp 2 and at pipe 2
    (decode across the stages: each rank 2 of the 4 layers), each case
    after its collectives are probed; the model-2 and pipe-2 cases must
    run, the fsdp-2 case is reported as not run where gloo lacks a
    collective it makes. Returns the ranks' flash launches."""
    import tempfile
    import torch
    cfg = _llama_cfg(FINE_TUNE_CONFIG, SERVE_MESH_LAYERS)
    # this process runs what the model-2 case runs; the fsdp-2 case's 2
    # tokens are the first 2 of its 32
    one = _serve_runs(dev, cfg, None, SERVE_MESH_RUNS["model2"])
    torch.cuda.empty_cache()
    out = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_serve_mesh_"),
                       "rank")
    hung, rcs, ranks = _serve_ranks("--serve-mesh-worker", out, 2, [0, 0],
                                    SERVE_MESH_TIMEOUT_S)
    problems = []
    line = {"phase": "serve_mesh", "nvidia_smi": nvidia_smi_line(),
            "model": cfg.name, "n_layers": cfg.n_layers,
            "fp32_layers": SERVE_MESH_FP32_LAYERS,
            "prompts": list(SERVE_MESH_PLENS), "bucket": SERVE_MESH_BUCKET,
            "new_tokens": SERVE_MESH_NEW, "base": "nf4",
            "one_process_noise": one["noise"],
            "adapter_rank": TENANT_RANK, "backend": "gloo",
            "ranks_on_one_card": 2,
            "tol": {"prefill_logits_of_scale": SERVE_MESH_LOGITS_TOL,
                    "near_tie_margin_of_scale": SERVE_MESH_MARGIN}}
    launches = 0
    if hung or any(rcs) or None in ranks:
        problems.append(f"ranks hung {hung}, exit codes {rcs}")
    else:
        line["probe"] = ranks[0]["probe"]
        for case, axes in SERVE_MESH_CASES.items():
            missing = sorted(k for k, v in ranks[0]["probe"][case].items()
                             if v != "ok")
            if missing:
                line[case] = ("not run: gloo misses " + ", ".join(missing)
                              + "; the case runs in serve_mesh_multi")
                if case != "fsdp2":
                    problems.append(line[case])
                continue
            line[case] = _serve_hold_ranks(one, ranks, case, problems, cfg,
                                           axes.get("model", 1),
                                           SERVE_MESH_RUNS[case],
                                           pipe=axes.get("pipe", 1))
            # the bf16 path's launches (the fp32 run is a parity check)
            launches += sum(r["runs"][case][k]["flash_launches"]
                            for r in ranks for k in ("generate", "smoke")
                            if k in r["runs"][case])
        if "fsdp2" in ranks[0]["runs"]:
            line["fsdp2_gathered_bytes_per_decode_step"] = \
                _serve_gathered_bytes(one["unit_bytes"], cfg.n_layers, 2)
    line.update(ok=not problems, problems=problems)
    emit(line)
    if problems:
        raise SystemExit("serve_mesh phase failed: " + "; ".join(problems))
    return {"flash_fwd": launches}


class _JsonWrites:
    """While entered, the names of the files ``json.dump`` writes in this
    process."""

    def __enter__(self):
        self.names, self._orig = [], json.dump

        def dump(obj, fp, *a, **kw):
            self.names.append(os.path.basename(getattr(fp, "name", "")))
            return self._orig(obj, fp, *a, **kw)
        json.dump = dump
        return self

    def __exit__(self, *exc):
        json.dump = self._orig


def _serve_entry_worker(config_path, out_path):
    """One rank of serve_mesh_multi's entry run, started by torchrun
    (its env): ``fine_tune.train_loop_per_worker`` on the job of
    ``config_path`` at ``ENTRY_LAYERS`` layers, the files it writes
    recorded; writes ``<out_path>.<rank>``."""
    import torch
    import torch.distributed as dist
    from gke_ray_train_tpu_torch import fine_tune as ft
    with open(config_path) as f:
        config = json.load(f)
    t0 = time.perf_counter()
    with _depth_cut(ENTRY_LAYERS), _JsonWrites() as w:
        metrics = ft.train_loop_per_worker(config)
    rank = dist.get_rank()
    rec = {"rank": rank, "world": dist.get_world_size(), "wrote": w.names,
           "wall_s": time.perf_counter() - t0,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "metrics": {k: v for k, v in (metrics or {}).items()
                       if isinstance(v, (int, float))}}
    with open(out_path + f".{rank}", "w") as f:
        json.dump(rec, f)
    dist.barrier()
    dist.destroy_process_group()


def _serve_multi_worker(out_path):
    """One rank of serve_mesh_multi (NCCL, one card a rank): the 70B
    layout at fsdp 1 x model N, ``SERVE_70B_LAYERS`` layers in bf16, the
    same model at pipe N (decode across the stages), and serve_mesh's
    model at fsdp N, each the generate of serve_mesh's prompts; writes
    ``<out_path>.<rank>.pt``."""
    import torch
    import torch.distributed as dist
    from gke_ray_train_tpu_torch.parallel import (
        MeshConfig, build_mesh, distributed_init)
    dev = distributed_init()
    rank, world = dist.get_rank(), dist.get_world_size()
    rec = {"rank": rank, "world": world, "runs": {}}
    try:
        mesh = build_mesh(MeshConfig(fsdp=1, model=world))
        cfg = _llama_cfg(FT_70B_CONFIG, SERVE_70B_LAYERS)
        rec["runs"]["70b"] = _serve_runs(
            dev, cfg, mesh, {"generate": SERVE_MESH_NEW}, quant=False)
        _release()
        rec["runs"]["70b_pipe"] = _serve_runs(
            dev, cfg, build_mesh(MeshConfig(fsdp=1, pipe=world)),
            {"generate": SERVE_MESH_NEW}, quant=False)
        _release()
        rec["runs"]["fsdp"] = _serve_runs(
            dev, _llama_cfg(FINE_TUNE_CONFIG, SERVE_MESH_LAYERS),
            build_mesh(MeshConfig(fsdp=world)), {"generate": SERVE_MESH_NEW})
    finally:
        torch.save(rec, out_path + f".{rank}.pt")
        dist.barrier()
        dist.destroy_process_group()


def _serve_torchrun(root, label, n, flag, config, timeout):
    """``flag config`` of this script under torchrun on ``n`` cards:
    (exit code, hung, what each rank wrote, the log's tail)."""
    cfg_path = os.path.join(root, f"{label}.json")
    with open(cfg_path, "w") as f:
        json.dump(config, f)
    out = os.path.join(root, f"{label}.rank")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
           "--nproc-per-node", str(n), "--master-addr", "127.0.0.1",
           "--master-port", str(_free_port()), os.path.abspath(__file__),
           flag, cfg_path, out]
    log_path = os.path.join(root, f"{label}.log")
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, env=dict(os.environ, HF_HUB_OFFLINE="1"),
                                cwd=HERE, stdout=log,
                                stderr=subprocess.STDOUT)
        hung, rcs = _wait_all([proc], timeout)
    with open(log_path) as f:
        tail = f.read()[-6000:]
    return rcs[0], bool(hung), _read_ranks(out, n), tail


def _serve_multi_entry(dev, root, n, problems):
    """The entry (offline_8b cut as the entry phase cuts it, with
    INFERENCE and SERVE_AFTER_TRAIN) on this card, then under torchrun at
    fsdp ``n``: exit 0, the comparison and the smoke written once, by
    rank 0, the base answers this card's."""
    from gke_ray_train_tpu_torch import fine_tune as ft

    def base_answers(run_root):
        with open(os.path.join(run_root, "inference_comparison.json")) as f:
            return [r["base_model_answer"] for r in json.load(f)]
    one_root = os.path.join(root, "one")
    t0 = time.perf_counter()
    with _depth_cut(ENTRY_LAYERS):
        ft.train_loop_per_worker(_entry_config(one_root, **ENTRY_SERVE),
                                 device=dev)
    line = {"one_card_wall_s": time.perf_counter() - t0}
    _release()
    multi_root = os.path.join(root, "multi")
    config = _entry_config(multi_root, **ENTRY_SERVE, MESH_FSDP=n)
    t0 = time.perf_counter()
    rc, hung, ranks, tail = _serve_torchrun(
        root, "entry", n, "--serve-entry-worker", config,
        SERVE_MULTI_TIMEOUT_S)
    line.update(exit_code=rc, wall_s=time.perf_counter() - t0, ranks=ranks,
                n_layers=ENTRY_LAYERS)
    if rc or hung or None in ranks:
        line["log_tail"] = tail
        problems.append(f"entry at fsdp {n}: exit code {rc}, hung {hung}")
        return line
    for name in ("inference_comparison.json", "serve_smoke.json"):
        counts = [r["wrote"].count(name) for r in ranks]
        if counts != [1] + [0] * (n - 1):
            problems.append(f"entry at fsdp {n}: {name} written {counts}")
    got, want = base_answers(multi_root), base_answers(one_root)
    line["base_answers_equal"] = got == want
    if got != want:
        problems.append(f"entry at fsdp {n}: base answers differ from one "
                        "card's")
    return line


def _serve_multi_pretrain(root, n, problems):
    """The pre-train entry under torchrun at fsdp ``n`` with
    SERVE_AFTER_TRAIN (``SERVE_MULTI_PRETRAIN_LAYERS`` layers): exit 0,
    the smoke's stats on rank 0 alone."""
    config = _pretrain_config(
        root, n_layers=SERVE_MULTI_PRETRAIN_LAYERS, run_name="serve",
        max_samples=PRETRAIN_STEPS * 16 * n, MESH_FSDP=n,
        SERVE_AFTER_TRAIN=True)
    t0 = time.perf_counter()
    rc, hung, ranks, tail = _serve_torchrun(
        root, "pretrain", n, "--pretrain-worker", config,
        SERVE_MULTI_TIMEOUT_S)
    line = {"exit_code": rc, "wall_s": time.perf_counter() - t0,
            "n_layers": SERVE_MULTI_PRETRAIN_LAYERS,
            "smoke": [r and r.get("smoke") for r in ranks]}
    if rc or hung or None in ranks:
        line["log_tail"] = tail
        problems.append(f"pretrain at fsdp {n}: exit code {rc}, hung "
                        f"{hung}")
    elif not (ranks[0]["smoke"] and ranks[0]["smoke"]["generated_tokens"]
              and all(r["smoke"] is None for r in ranks[1:])):
        problems.append(f"pretrain at fsdp {n}: smoke {line['smoke']}")
    return line


def phase_serve_mesh_multi(dev):
    """Opt-in, the four-card host (fewer fails): serving across cards
    over NCCL (module doc, 22b). The 70B layout at fsdp 1 x model 4,
    ``SERVE_70B_LAYERS`` of 80 layers in bf16, the same model decoding
    across 4 pipe stages (2 layers a card; a rank's per-token p50 beside
    model 4's), and serve_mesh's model at fsdp 4, each on this card and
    then a rank a card (``_serve_multi_worker``), held as serve_mesh
    holds its bf16 generate; the fine-tune entry at fsdp 4 and the pre-train entry at
    fsdp 4, each with its serving switches, under torchrun."""
    import shutil
    import tempfile
    import torch
    n = torch.cuda.device_count()
    if n < 4:
        raise SystemExit(f"serve_mesh_multi needs 4 cards; this host has {n}")
    os.environ["HF_HUB_OFFLINE"] = "1"
    problems = []
    cfg = _llama_cfg(FT_70B_CONFIG, SERVE_70B_LAYERS)
    one = _serve_runs(dev, cfg, None, {"generate": SERVE_MESH_NEW},
                      quant=False)
    _release()
    cfg8 = _llama_cfg(FINE_TUNE_CONFIG, SERVE_MESH_LAYERS)
    one8 = _serve_runs(dev, cfg8, None, {"generate": SERVE_MESH_NEW})
    _release()
    root = tempfile.mkdtemp(prefix="chip_smoke_serve_multi_")
    line = {"phase": "serve_mesh_multi", "nvidia_smi": nvidia_smi_line(),
            "world": n, "backend": "nccl"}
    try:
        out = os.path.join(root, "rank")
        hung, rcs, ranks = _serve_ranks("--serve-multi-worker", out, n,
                                        list(range(n)),
                                        SERVE_MULTI_TIMEOUT_S)
        if hung or any(rcs) or None in ranks:
            problems.append(f"70B ranks hung {hung}, exit codes {rcs}")
        else:
            line["70b"] = dict(_serve_hold_ranks(
                one, ranks, "70b", problems, cfg, n,
                {"generate": SERVE_MESH_NEW}),
                n_layers=SERVE_70B_LAYERS, mesh={"fsdp": 1, "model": n})
            line["70b_pipe"] = dict(_serve_hold_ranks(
                one, ranks, "70b_pipe", problems, cfg, 1,
                {"generate": SERVE_MESH_NEW}, pipe=n),
                n_layers=SERVE_70B_LAYERS, mesh={"fsdp": 1, "pipe": n},
                p50_against_model=[
                    r["runs"]["70b_pipe"]["generate"]["step_s_p50"]
                    / r["runs"]["70b"]["generate"]["step_s_p50"]
                    for r in ranks])
            line["fsdp"] = dict(_serve_hold_ranks(
                one8, ranks, "fsdp", problems, cfg8, 1,
                {"generate": SERVE_MESH_NEW}),
                n_layers=SERVE_MESH_LAYERS, mesh={"fsdp": n},
                gathered_bytes_per_decode_step=_serve_gathered_bytes(
                    one8["unit_bytes"], cfg8.n_layers, n))
        line["entry"] = _serve_multi_entry(dev, root, n, problems)
        line["pretrain"] = _serve_multi_pretrain(root, n, problems)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    line.update(ok=not problems, problems=problems)
    emit(line)
    if problems:
        raise SystemExit("serve_mesh_multi phase failed: "
                         + "; ".join(problems))
    return {"flash_fwd": sum(run["generate"]["flash_launches"]
                             for r in ranks for run in r["runs"].values())}


# ---------------------------------------------------------------------------
# OVERLAP: FSDP2's explicit prefetch (xla) and the hand-placed,
# double-buffered fsdp gathers of train/overlap.py (manual)
# ---------------------------------------------------------------------------

# the slice's path: full fine-tuning of Llama-3.1-8B at full width (the
# 70B job's full-FT mode on the 8B model), FUSED_OPS=1, remat full,
# dropout off, one microbatch of the job's 2 rows a step
OV_FT = {"USE_QLORA": False, "LORA_DROPOUT": 0.0}
OV_PLAN = {"fused_ops": True, "grad_accum": 1}
OV_MODES = ("off", "xla", "manual")
# train_overlap: two gloo ranks of one card at fsdp 2, 2 of 32 layers,
# bf16 weights, 1 + 1 steps a mode; fp32 at 2 layers, off and manual, one
# step each (its loss and the grad norm over every reduced gradient)
OV_LAYERS = 2
OV_STEPS = 1
OV_FP32_LAYERS = 2
OV_FP32_STEPS = 0
OV_TIMEOUT_S = 420
# train_overlap_multi: one rank a card over NCCL, full depth at each mesh
# (bf16 weights and AdamW: 8.03 G params x 12 B = 96 GB of state over 4
# cards), 1 + 3 steps a run, the modes alternated (off, xla, manual,
# manual, xla, off: the p50 of each mode's 6 timed steps, its first run
# profiled one more step); one card's run and the meshes at
# OV_MULTI_REF_LAYERS for the loss gate
OV_MULTI_MESHES = {"fsdp4": dict(fsdp=4), "hsdp": dict(data=2, fsdp=2)}
# the global batch: 8 rows, 2 a batch rank
OV_MULTI_FT = {"PER_DEVICE_TRAIN_BATCH_SIZE": 8}
OV_MULTI_LAYERS = 32
OV_MULTI_REF_LAYERS = 4
OV_MULTI_STEPS = 3
OV_MULTI_TIMEOUT_S = 1500


def _gather_tally():
    """Count the bytes of every all-gather into one tensor
    (``dist.all_gather_into_tensor``, which FSDP2 and the manual path
    call, and ``all_gather_single`` where torch has it), each call once,
    in this process: the tally dict, installed once."""
    import torch.distributed as dist
    tally = getattr(dist, "_chip_smoke_tally", None)
    if tally is not None:
        return tally
    tally = dist._chip_smoke_tally = {"bytes": 0, "calls": 0, "depth": 0}

    def counting(orig):
        def counted(*a, **kw):
            out = kw.get("output_tensor", a[0] if a else None)
            if tally["depth"] == 0:
                tally["bytes"] += out.numel() * out.element_size()
                tally["calls"] += 1
            tally["depth"] += 1
            try:
                return orig(*a, **kw)
            finally:
                tally["depth"] -= 1
        return counted
    for name in ("all_gather_into_tensor", "all_gather_single"):
        if hasattr(dist, name):
            setattr(dist, name, counting(getattr(dist, name)))
    return tally


def _ov_bytes(cfg):
    """(a block's, the root's) gathered bytes in the param dtype, from
    the shapes: the projections and the two norms; the embedding, the
    head and the final norm."""
    import torch
    from gke_ray_train_tpu_torch.models.transformer import proj_shapes
    es = torch.finfo(getattr(torch, cfg.param_dtype)).bits // 8
    block = sum(math.prod(s) for s in proj_shapes(cfg).values()) \
        + 2 * cfg.d_model
    root = (1 if cfg.tie_embeddings else 2) * cfg.vocab_size * cfg.d_model \
        + cfg.d_model
    return block * es, root * es


def _ov_run(dev, cfg, mesh, mode, steps, rows=None, ft_over=None,
            profile=False, optim="adamw", plan_over=None):
    """One mode's run of the slice's job on ``mesh`` (or one card):
    ``steps`` timed steps after a warm-up, the launch counts, the gather
    tally and the manual path's own tally set to 0 just before the timed
    steps and read just after (with ``steps`` 0, the warm-up step alone
    and no counts); ``rows`` (count, index) keeps this batch
    rank's rows ``index::count`` of every batch; ``ft_over``: job keys
    over ``OV_FT``; ``profile``: one more step under torch.profiler, its
    NCCL collectives' ms (:func:`_exposed_collective_ms`); ``optim`` the
    job's OPTIM; ``plan_over``: plan fields over ``OV_PLAN``."""
    from gke_ray_train_tpu_torch.train import overlap as tov
    t0 = time.perf_counter()
    job = _fine_tune_setup(dev, cfg, steps + 1 + profile, mesh=mesh,
                           ft_over=dict(OV_FT, **(ft_over or {})),
                           optim=optim, transfer_guard=None, overlap=mode,
                           **dict(OV_PLAN, **(plan_over or {})))
    global_rows = job["batch_rows"]
    if rows is not None:
        job["batches"] = [{k: v[rows[1]::rows[0]] for k, v in b.items()}
                          for b in job["batches"]]
    tally = _gather_tally()
    calls = {"n": 0}
    fn = job["step_fn"]

    def step(state, b):
        if calls["n"] == 1:
            _reset_launch_counts()
            tov.reset_counts()
            tally.update(bytes=0, calls=0)
        calls["n"] += 1
        return fn(state, b)
    job["step_fn"] = step
    r = _timed_steps(dev, job, steps)
    launches = _launch_counts()
    counted = dict(tally, manual=dict(tov.COUNTS))
    if profile:
        import torch
        from torch.profiler import ProfilerActivity, profile as tprofile
        b = job["place"](job["batches"][steps + 1])
        b = b.wait() if hasattr(b, "wait") else b
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            fn(job["state"], b)
            torch.cuda.synchronize()
        r["profile"] = _exposed_collective_ms(prof)
        del prof
    block, root = _ov_bytes(job["cfg"])

    def per_step(v):
        # with no timed step the counts were never set to 0
        return v / steps if steps else None
    r.update(mode=mode, n_layers=job["cfg"].n_layers,
             launches_per_step={k: per_step(v) for k, v in launches.items()},
             want_launches=expected_launches(job["cfg"], 1, True,
                                             full_ft=True),
             gathered_bytes_per_step=per_step(counted["bytes"]),
             gathers_per_step=per_step(counted["calls"]),
             manual_counts={k: per_step(v)
                            for k, v in counted["manual"].items()},
             reckoned_bytes_per_step=root + 2 * job["cfg"].n_layers * block,
             layer_bytes=block, root_bytes=root,
             tokens=global_rows * job["seq"], init_s=job["init_s"],
             wall_s=time.perf_counter() - t0)
    del job
    _release()
    return r, launches


def _ov_worker(out_path):
    """One of train_overlap's two ranks on the one card (env: RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT): a gloo group with the card's
    tensors, fsdp 2; deterministic algorithms on (the embedding's
    backward), so two modes that compute alike compute bit for bit. The
    job at ``OV_LAYERS`` under each of ``OV_MODES`` (bf16 weights, 1 +
    ``OV_STEPS`` steps), then in fp32 (TF32 off) at ``OV_FP32_LAYERS``
    under off and manual."""
    import torch
    import torch.distributed as dist
    from gke_ray_train_tpu_torch.parallel import MeshConfig, build_mesh
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method="env://")
    rank = dist.get_rank()
    rec = {"rank": rank, "backend": dist.get_backend(),
           "device_name": torch.cuda.get_device_name(dev), "runs": {},
           "fp32": {}, "since_start_s": time.perf_counter() - _T0}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        mesh = build_mesh(MeshConfig(fsdp=dist.get_world_size()),
                          device_type="cuda")
        cfg = _llama_cfg(FINE_TUNE_CONFIG, OV_LAYERS)
        for mode in OV_MODES:
            rec["runs"][mode], launches = _ov_run(dev, cfg, mesh, mode,
                                                  OV_STEPS)
            if mode == "manual":
                rec["launches"] = launches
        cfg32 = _llama_cfg(FINE_TUNE_CONFIG, OV_FP32_LAYERS, "float32",
                           "float32")
        with _tf32_off():
            for mode in ("off", "manual"):
                rec["fp32"][mode], _ = _ov_run(dev, cfg32, mesh, mode,
                                               OV_FP32_STEPS)
    finally:
        torch.use_deterministic_algorithms(False)
        rec["done_s"] = time.perf_counter() - _T0
        with open(out_path + f".{rank}", "w") as f:
            json.dump(rec, f)
        dist.barrier()
        dist.destroy_process_group()


def _ov_hold(name, runs, problems, rtol=MESH_MULTI_RTOL):
    """One rank's modes against its own ``off``: ``xla`` bit for bit,
    ``manual`` within ``rtol``; the launches of every mode the off
    step's, which are the full fine-tuning step's; manual's gathered
    bytes those reckoned from the shapes, the root once and each block
    twice (forward and recomputation), and its own tally the same;
    manual's peak at most two layers' gathered weights over off's.
    Returns the relative gaps of manual."""
    off = runs["off"]
    for key in ("losses", "grad_norms"):
        if "xla" in runs and runs["xla"][key] != off[key]:
            problems.append(f"{name}: xla {key} {runs['xla'][key]} are not "
                            f"off's {off[key]} bit for bit")
    gaps = _hold_streams(f"{name} manual", runs["manual"], off, rtol,
                         problems)
    for mode, run in runs.items():
        if run["launches_per_step"] != off["want_launches"]:
            problems.append(f"{name} {mode}: launches per step "
                            f"{run['launches_per_step']} != "
                            f"{off['want_launches']}")
    man = runs["manual"]
    # the manual path's own tally; dist's all-gathers count it too where
    # the transport is one (NCCL; under gloo's host staging the gather is
    # an all-reduce, which they do not count)
    if man["manual_counts"]["gather_bytes"] != man[
            "reckoned_bytes_per_step"] or man["gathered_bytes_per_step"] \
            not in (0, man["reckoned_bytes_per_step"]):
        problems.append(f"{name} manual: gathered "
                        f"{man['gathered_bytes_per_step']} B a step (its "
                        f"tally {man['manual_counts']}), reckoned "
                        f"{man['reckoned_bytes_per_step']}")
    over = man["peak_mem_bytes"] - off["peak_mem_bytes"]
    if over > 2 * man["layer_bytes"]:
        problems.append(f"{name} manual: peak {man['peak_mem_bytes']} B is "
                        f"{over} over off's, more than two layers' "
                        f"{2 * man['layer_bytes']}")
    return gaps


def _ov_summary(runs):
    """What the line prints of each mode: step p50, peak, gathered bytes
    (counted by dist's all-gathers, the manual path's own tally, and
    reckoned) and the gathers a step."""
    return {mode: {k: run[k] for k in (
        "step_s_p50", "step_s", "peak_mem_bytes", "held_before_bytes",
        "gathered_bytes_per_step", "gathers_per_step", "manual_counts",
        "reckoned_bytes_per_step", "losses", "grad_norms", "init_s",
        "wall_s")}
        for mode, run in runs.items()}


def phase_train_overlap(dev):
    """``OVERLAP`` on the one-card host: two ranks of this card over gloo
    at fsdp 2 (``_ov_worker``; CUDA tensors staged through page-locked
    host memory), Llama-3.1-8B full fine-tuning at full width cut to
    ``OV_LAYERS`` layers, bf16, FUSED_OPS=1, remat full, the job's rows,
    1 + ``OV_STEPS`` steps under each of off, xla and manual. Gates per
    rank (``_ov_hold``): xla's losses and grad norms equal off's bit for
    bit, manual's within MESH_MULTI_RTOL; every mode launches rows 1-8 as
    the full fine-tuning step does; manual gathers the bytes reckoned
    from the shapes (and its own tally agrees) and peaks at most two
    layers' gathered weights over off; fp32 (TF32 off) at
    ``OV_FP32_LAYERS`` layers, manual's losses and grad norms are off's
    bit for bit. The line prints each mode's step p50, peak and
    gathered bytes a step, off's and xla's counted beside manual's."""
    import tempfile
    out = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_ov_"), "rank")
    n = 2
    hung, rcs, ranks = _spawn_ranks("--ov-worker", out, n, [0] * n,
                                    OV_TIMEOUT_S)
    problems = []
    line = {"phase": "train_overlap", "nvidia_smi": nvidia_smi_line(),
            "model": "llama3-8b", "mesh": {"data": 1, "fsdp": n},
            "backend": "gloo", "ranks_on_one_card": n,
            "cut": f"{OV_LAYERS} of 32 layers, full fine-tuning, bf16, 1 + "
                   f"{OV_STEPS} steps a mode; fp32 at {OV_FP32_LAYERS} "
                   f"layers, 1 + {OV_FP32_STEPS} steps, off and manual"}
    launches = None
    if hung or any(rcs) or None in ranks or not all(
            r.get("launches") for r in ranks):
        problems.append(f"ranks hung {hung}, exit codes {rcs}")
        line["ranks"] = ranks
    else:
        gaps = {}
        for r in ranks:
            name = f"rank {r['rank']}"
            gaps[r["rank"]] = _ov_hold(name, r["runs"], problems)
            f32 = r["fp32"]
            for key in ("losses", "grad_norms"):
                if f32["manual"][key] != f32["off"][key]:
                    problems.append(f"{name} fp32: manual {key} "
                                    f"{f32['manual'][key]} are not off's "
                                    f"{f32['off'][key]} bit for bit")
        line.update(
            rel_gaps=gaps, tol_rel=MESH_MULTI_RTOL,
            modes={r["rank"]: _ov_summary(r["runs"]) for r in ranks},
            fp32={r["rank"]: _ov_summary(r["fp32"]) for r in ranks},
            manual_bitwise_bf16=[
                r["runs"]["manual"]["losses"] == r["runs"]["off"]["losses"]
                for r in ranks],
            launches_per_step={r["rank"]: {
                m: run["launches_per_step"] for m, run in r["runs"].items()}
                for r in ranks},
            layer_bytes=ranks[0]["runs"]["off"]["layer_bytes"],
            root_bytes=ranks[0]["runs"]["off"]["root_bytes"],
            rank_start_s=[r["since_start_s"] for r in ranks],
            rank_done_s=[r["done_s"] for r in ranks])
        launches = {}
        for r in ranks:
            for k, v in r["launches"].items():
                launches[k] = launches.get(k, 0) + v
    line.update(ok=not problems, problems=problems)
    emit(line)
    if problems:
        raise SystemExit("train_overlap phase failed: " + "; ".join(problems))
    return launches


def _exposed_collective_ms(prof):
    """From a torch.profiler trace: the NCCL all-gather and
    reduce-scatter kernels' device ms, and the part of it no compute
    kernel ran beside (the union of the non-NCCL kernels' intervals
    subtracted). None where the trace holds no device kernels."""
    from torch.autograd import DeviceType
    comm, compute = [], []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        span = (e.time_range.start, e.time_range.end)
        name = e.name.lower()
        if "nccl" in name:
            if "allgather" in name or "reducescatter" in name:
                comm.append(span)
        else:
            compute.append(span)
    if not comm and not compute:
        return None
    merged = []
    for s, t in sorted(compute):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    total = exposed = 0.0
    for s, t in comm:
        total += t - s
        covered = sum(max(0.0, min(t, b) - max(s, a)) for a, b in merged)
        exposed += (t - s) - covered
    return {"collective_ms": total / 1e3, "exposed_ms": exposed / 1e3,
            "collective_kernels": len(comm)}


def _ov_multi_worker(out_path):
    """One rank of train_overlap_multi (NCCL, one card a rank): at each
    of ``OV_MULTI_MESHES``, the job at ``OV_MULTI_REF_LAYERS`` under each
    mode (held against one card), then at ``OV_MULTI_LAYERS`` the modes
    alternated, each with one profiled step after its timed ones, then
    off and manual with deterministic algorithms off."""
    import torch
    import torch.distributed as dist
    from gke_ray_train_tpu_torch.parallel import (
        MeshConfig, build_mesh, distributed_init)
    from gke_ray_train_tpu_torch.parallel.placement import (
        input_shard_layout)
    dev = distributed_init()
    rank, world = dist.get_rank(), dist.get_world_size()
    rec = {"rank": rank, "world": world,
           "device_name": torch.cuda.get_device_name(dev)}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for key, kw in OV_MULTI_MESHES.items():
            mesh = build_mesh(MeshConfig(**kw))
            rows = input_shard_layout(mesh)
            ref = _llama_cfg(FINE_TUNE_CONFIG, OV_MULTI_REF_LAYERS)
            rec[key] = {"ref": {m: _ov_run(dev, ref, mesh, m, OV_STEPS,
                                           rows=rows, ft_over=OV_MULTI_FT)[0]
                                for m in OV_MODES}}
            cfg = _llama_cfg(FINE_TUNE_CONFIG, OV_MULTI_LAYERS)
            full = {}
            for m in OV_MODES + tuple(reversed(OV_MODES)):
                r, launches = _ov_run(dev, cfg, mesh, m, OV_MULTI_STEPS,
                                      rows=rows, ft_over=OV_MULTI_FT,
                                      profile=m not in full)
                if m in full:
                    full[m]["step_s"] += r["step_s"]
                    full[m]["peak_mem_bytes"] = max(
                        full[m]["peak_mem_bytes"], r["peak_mem_bytes"])
                else:
                    full[m] = r
                if m == "manual":
                    rec["launches"] = launches
            for m, r in full.items():
                ts = sorted(r["step_s"])
                r["step_s_p50"] = ts[len(ts) // 2]
                r["tokens_per_s_per_card"] = r["tokens"] / r[
                    "step_s_p50"] / world
            rec[key]["full"] = full
            # off and manual once more with deterministic algorithms off:
            # what the gates' determinism costs each mode
            torch.use_deterministic_algorithms(False)
            try:
                rec[key]["nondeterministic"] = {
                    m: {k: v for k, v in _ov_run(
                        dev, cfg, mesh, m, OV_MULTI_STEPS, rows=rows,
                        ft_over=OV_MULTI_FT)[0].items()
                        if k in ("step_s", "step_s_p50", "losses")}
                    for m in ("off", "manual")}
            finally:
                torch.use_deterministic_algorithms(True, warn_only=True)
    finally:
        torch.use_deterministic_algorithms(False)
        with open(out_path + f".{rank}", "w") as f:
            json.dump(rec, f)
        dist.barrier()
        dist.destroy_process_group()


def phase_train_overlap_multi(dev):
    """Opt-in, the four-card host (fewer than 4 cards fails): OVERLAP
    over NCCL, one rank a card (``_ov_multi_worker``), at fsdp 4 and at
    data 2 x fsdp 2, each rank its rows of the job's batches. One card
    first: the job at ``OV_MULTI_REF_LAYERS`` layers under off. At each
    mesh: the same depth under each mode, every step's loss within
    MESH_MULTI_RTOL of one card's and xla's bitwise off's; then full
    depth (``OV_MULTI_LAYERS``), 1 + ``OV_MULTI_STEPS`` steps a run, the
    modes alternated: a rank's step p50 with its spread, tokens/s a
    card, peak a card, and from one profiled step a mode the NCCL
    all-gather and reduce-scatter ms and the part no compute kernel ran
    beside ("exposed collective ms"); then off and manual once more, 1 +
    ``OV_MULTI_STEPS`` steps, with deterministic algorithms off (the
    gates need them on: the embedding's backward)."""
    import tempfile
    import torch
    n = torch.cuda.device_count()
    emit({"phase": "train_overlap_multi_devices", "ok": n >= 4,
          "device_count": n, "nvidia_smi": nvidia_smi_line()})
    if n < 4:
        raise SystemExit(f"train_overlap_multi needs 4 cards; this host "
                         f"has {n}")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        one, _ = _ov_run(dev, _llama_cfg(FINE_TUNE_CONFIG,
                                         OV_MULTI_REF_LAYERS), None, "off",
                         OV_STEPS, ft_over=OV_MULTI_FT)
    finally:
        torch.use_deterministic_algorithms(False)
    out = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_ov_multi_"),
                       "rank")
    hung, rcs, ranks = _spawn_ranks("--ov-multi-worker", out, n,
                                    list(range(n)), OV_MULTI_TIMEOUT_S)
    problems = []
    line = {"phase": "train_overlap_multi", "nvidia_smi": nvidia_smi_line(),
            "world": n, "backend": "nccl", "one_card": _ov_summary(
                {"off": one}),
            "cut": f"the loss gate at {OV_MULTI_REF_LAYERS} of 32 layers "
                   f"(what one card holds with AdamW), 1 + {OV_STEPS} "
                   f"steps; timings at {OV_MULTI_LAYERS} layers, 1 + "
                   f"{OV_MULTI_STEPS} steps a run, two runs a mode"}
    launches = None
    if hung or any(rcs) or None in ranks or not all(
            r.get("launches") for r in ranks):
        problems.append(f"ranks hung {hung}, exit codes {rcs}")
        line["ranks"] = ranks
    else:
        for key in OV_MULTI_MESHES:
            per = {}
            for r in ranks:
                name = f"rank {r['rank']} {key}"
                ref = r[key]["ref"]
                for m, run in ref.items():
                    _hold_streams(f"{name} {m} vs one card", run, one,
                                  MESH_MULTI_RTOL, problems)
                for k2 in ("losses", "grad_norms"):
                    if ref["xla"][k2] != ref["off"][k2]:
                        problems.append(f"{name}: xla {k2} are not off's "
                                        "bit for bit")
                full = r[key]["full"]
                per[r["rank"]] = {m: {
                    "step_s_p50": run["step_s_p50"],
                    "step_s": run["step_s"],
                    "tokens_per_s_per_card": run["tokens_per_s_per_card"],
                    "peak_mem_bytes": run["peak_mem_bytes"],
                    "held_before_bytes": run["held_before_bytes"],
                    "gathered_bytes_per_step":
                        run["gathered_bytes_per_step"],
                    "reckoned_bytes_per_step":
                        run["reckoned_bytes_per_step"],
                    "losses": run["losses"], "profile": run["profile"]}
                    for m, run in full.items()}
                per[r["rank"]]["ref_losses"] = {
                    m: run["losses"] for m, run in ref.items()}
                per[r["rank"]]["full_losses_bitwise_off"] = {
                    m: run["losses"] == full["off"]["losses"]
                    for m, run in full.items()}
                per[r["rank"]]["nondeterministic"] = r[key][
                    "nondeterministic"]
            line[key] = dict(per, mesh=OV_MULTI_MESHES[key],
                             n_layers=OV_MULTI_LAYERS)
        launches = {}
        for r in ranks:
            for k, v in r["launches"].items():
                launches[k] = launches.get(k, 0) + v
    line.update(tol_rel=MESH_MULTI_RTOL, ok=not problems, problems=problems)
    emit(line)
    if problems:
        raise SystemExit("train_overlap_multi phase failed: "
                         + "; ".join(problems))
    return launches


# ---------------------------------------------------------------------------
# phases 22e / 22f: multi-slice training (NUM_SLICES, DCN_SYNC, DCN_COMPRESS)
# ---------------------------------------------------------------------------

# train_hier: the pre-train entry (pretrain.py::job_config: basic_lm at full
# width, 256-token rows, 16 a rank, bf16 over fp32 parameters) cut to this
# many of its 24 layers, four gloo ranks of one card at data 2 x fsdp 2 over
# two emulated slices, OVERLAP=manual, FUSED_OPS=1, 1 + 1 steps an arm
HIER_ARMS = {"flat": ("flat", "none"), "hier": ("hier", "none"),
             "bf16": ("hier", "bf16")}
HIER_MESH = {"MESH_DATA": 2, "MESH_FSDP": 2, "NUM_SLICES": 2}
HIER_LAYERS = 2
HIER_STEPS = 2
HIER_RANKS = 4
HIER_TIMEOUT_S = 480
# train_hier_multi: (a) the fine-tune job as full fine-tuning of
# Llama-3.1-8B at full depth, fp32 parameters and bf16 compute, Adafactor,
# FUSED_OPS=1, 8 rows a step (2 a batch rank), 1 + 3 steps a run, the arms
# alternated; (b) the slice_evict drill through the pre-train entry at
# HIER_DRILL_LAYERS in fp32 (TF32 off), a save every 2 steps
HIER_MULTI_FT = {"PER_DEVICE_TRAIN_BATCH_SIZE": 8}
HIER_MULTI_LAYERS = 32
HIER_MULTI_STEPS = 3
HIER_MULTI_TIMEOUT_S = 1200
HIER_DRILL_LAYERS = 2
HIER_DRILL_STEPS = 8
HIER_DRILL_SPEC = "kind=slice_evict:step=2"
HIER_DRILL_TIMEOUT_S = 420
HIER_DRILL_RTOL = 1e-5


def _hier_reckoned(cfg, arm, data=2, fsdp=2, grad_accum=1):
    """The cross-slice bytes one rank sends in a step, from the leaf
    shapes (each block's projections and two norms, the root's embedding,
    final norm and head) through ``leaf_payload_split``: the full payload
    (``flat``), the fsdp-scattered one (``hier``), and under ``bf16`` each
    microbatch's fsdp shard in bf16; the parameter dtype's bytes else."""
    import torch
    from gke_ray_train_tpu_torch.models.transformer import proj_shapes
    from gke_ray_train_tpu_torch.parallel.hierarchical import (
        SliceTopology, leaf_payload_split)
    shapes = (list(proj_shapes(cfg).values()) + [(cfg.d_model,)] * 2) \
        * cfg.n_layers + [(cfg.vocab_size, cfg.d_model), (cfg.d_model,)]
    if not cfg.tie_embeddings:
        shapes.append((cfg.d_model, cfg.vocab_size))
    es = torch.finfo(getattr(torch, cfg.param_dtype)).bits // 8
    flat, hier = leaf_payload_split(shapes, SliceTopology(2, data, fsdp))
    if arm == "flat":
        return es * flat
    if arm == "hier":
        return es * hier
    return grad_accum * 2 * sum(math.prod(s) // fsdp for s in shapes)


def _hier_run(dev, root, arm):
    """One arm of train_hier on this rank: ``pretrain.train_loop_per_worker``
    through ``TorchTrainer.fit()`` (the local path) on the job cut to
    ``HIER_LAYERS`` and ``HIER_STEPS`` steps at ``HIER_MESH``, with the
    launch counts and the manual path's tally at 0 just before the last
    step and read after it; each step's time between synchronizes, loss and
    grad norm. The run's checkpoint is removed after."""
    import shutil
    import torch
    import torch.distributed as dist
    from gke_ray_train_tpu_torch import pretrain
    from gke_ray_train_tpu_torch.rayint import RunConfig, TorchTrainer
    from gke_ray_train_tpu_torch.train import overlap as tov
    sync, compress = HIER_ARMS[arm]
    config = _pretrain_config(root, n_layers=HIER_LAYERS, OVERLAP="manual",
                              DCN_SYNC=sync, DCN_COMPRESS=compress,
                              run_name=f"hier_{arm}", **HIER_MESH)
    config["max_samples"] = HIER_STEPS * config["batch_size_per_device"] \
        * dist.get_world_size()
    rec = {"losses": [], "grad_norms": [], "step_s": []}
    orig = pretrain.make_train_step

    def make_train_step(cfg, *a, **kw):
        step = orig(cfg, *a, **kw)
        plan = kw["plan"]
        rec.update(cfg=cfg, plan=[plan.num_slices, plan.dcn_sync,
                                  plan.dcn_compress])

        def timed(state, batch):
            if len(rec["step_s"]) == HIER_STEPS - 1:
                _reset_launch_counts()
                tov.reset_counts()
            torch.cuda.synchronize(dev)
            t = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize(dev)
            rec["step_s"].append(time.perf_counter() - t)
            rec["losses"].append(float(m["loss"]))
            rec["grad_norms"].append(float(m["grad_norm"]))
            return state, m
        return timed
    pretrain.make_train_step = make_train_step
    _release()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    try:
        result = TorchTrainer(
            functools.partial(pretrain.train_loop_per_worker, device=dev),
            train_loop_config=config,
            run_config=RunConfig(name=f"hier-{arm}", retry_backoff_s=0.0),
            use_ray=False).fit()
    finally:
        pretrain.make_train_step = orig
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    counts, launches = dict(tov.COUNTS), _launch_counts()
    dist.barrier()
    if dist.get_rank() == 0:
        shutil.rmtree(os.path.join(config["storage_path"],
                                   config["run_name"]), ignore_errors=True)
    cfg = rec.pop("cfg", None)
    out = dict(rec, arm=arm, status=result.status, error=result.error,
               attempts=result.attempts, wall_s=wall, peak_mem_bytes=peak,
               step_s_p50=(sorted(rec["step_s"][1:])[
                   (len(rec["step_s"]) - 1) // 2]
                   if len(rec["step_s"]) > 1 else None),
               cross_bytes_per_step=counts["cross_bytes"],
               cross_reductions_per_step=counts["cross_reductions"],
               launches_per_step=launches)
    if cfg is not None:
        out.update(reckoned_bytes_per_step=_hier_reckoned(cfg, arm),
                   want_launches=expected_launches(cfg, 1, True,
                                                   full_ft=True),
                   params=cfg.param_count(), vocab=cfg.vocab_size,
                   n_layers=cfg.n_layers, d_model=cfg.d_model,
                   tokens=config["dataset_seq_len"]
                   * config["batch_size_per_device"] * dist.get_world_size())
    _release()
    return out


def _hier_worker(out_path):
    """One of train_hier's four ranks on the one card (env: RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT): a gloo group with the card's
    tensors (CUDA tensors staged through page-locked host memory), which
    the entry's ``distributed_init`` is pointed at (it gives NCCL on a
    card), deterministic algorithms on (the embedding's backward), so two
    arms that sum alike compute bit for bit. Each of ``HIER_ARMS``
    (``_hier_run``) in the directory of ``out_path``."""
    import torch
    import torch.distributed as dist
    from gke_ray_train_tpu_torch import pretrain
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method="env://")
    rank = dist.get_rank()
    rec = {"rank": rank, "backend": dist.get_backend(),
           "device_name": torch.cuda.get_device_name(dev), "runs": {},
           "since_start_s": time.perf_counter() - _T0}
    torch.use_deterministic_algorithms(True, warn_only=True)
    orig = pretrain.distributed_init
    pretrain.distributed_init = lambda device=None, **kw: dev
    prev_fused = os.environ.get("FUSED_OPS")
    os.environ["FUSED_OPS"] = "1"
    try:
        for arm in HIER_ARMS:
            rec["runs"][arm] = _hier_run(dev, os.path.dirname(out_path), arm)
    finally:
        pretrain.distributed_init = orig
        if prev_fused is None:
            os.environ.pop("FUSED_OPS", None)
        else:
            os.environ["FUSED_OPS"] = prev_fused
        torch.use_deterministic_algorithms(False)
        rec["done_s"] = time.perf_counter() - _T0
        with open(out_path + f".{rank}", "w") as f:
            json.dump(rec, f)
        dist.barrier()
        dist.destroy_process_group()


def _hier_hold(name, runs, problems, rtol=MESH_MULTI_RTOL):
    """One rank's arms: each trained its steps to finite numbers on the
    plan it asked for; ``hier``'s losses and grad norms are ``flat``'s bit
    for bit, ``bf16``'s are not ``hier``'s bit for bit and within
    ``rtol`` of them; every arm launches rows 1-8 as the full-training
    step does; the cross-slice bytes of a step are those reckoned from the
    shapes, ``hier``'s at most (1/2 + 0.01) of ``flat``'s. Returns bf16's
    relative gaps to hier."""
    for arm, run in runs.items():
        sync, compress = HIER_ARMS[arm]
        if run["status"] != "ok" or len(run["losses"]) != HIER_STEPS or \
                not all(np.isfinite(run["losses"] + run["grad_norms"])):
            problems.append(f"{name} {arm}: {run['status']} "
                            f"{run['error']}, losses {run['losses']}")
            return None
        if run["plan"] != [2, sync, compress]:
            problems.append(f"{name} {arm}: ran the plan {run['plan']}")
        if run["launches_per_step"] != run["want_launches"]:
            problems.append(f"{name} {arm}: launches per step "
                            f"{run['launches_per_step']} != "
                            f"{run['want_launches']}")
        if run["cross_bytes_per_step"] != run["reckoned_bytes_per_step"]:
            problems.append(f"{name} {arm}: {run['cross_bytes_per_step']} "
                            "cross-slice bytes a step, reckoned "
                            f"{run['reckoned_bytes_per_step']}")
    flat, hier, bf16 = runs["flat"], runs["hier"], runs["bf16"]
    for key in ("losses", "grad_norms"):
        if hier[key] != flat[key]:
            problems.append(f"{name}: hier {key} {hier[key]} are not "
                            f"flat's {flat[key]} bit for bit")
    if (bf16["losses"], bf16["grad_norms"]) == (hier["losses"],
                                                hier["grad_norms"]):
        problems.append(f"{name}: bf16 is hier bit for bit (nothing "
                        "compressed)")
    gaps = _hold_streams(f"{name} bf16", bf16, hier, rtol, problems)
    if hier["cross_bytes_per_step"] > (0.5 + 0.01) * \
            flat["cross_bytes_per_step"]:
        problems.append(f"{name}: hier sends {hier['cross_bytes_per_step']}"
                        f" B a step, over half of flat's "
                        f"{flat['cross_bytes_per_step']}")
    return gaps


def _hier_summary(runs):
    return {arm: {k: run.get(k) for k in (
        "step_s_p50", "step_s", "peak_mem_bytes", "cross_bytes_per_step",
        "reckoned_bytes_per_step", "cross_reductions_per_step", "losses",
        "grad_norms", "wall_s")} for arm, run in runs.items()}


def phase_train_hier(dev):
    """Multi-slice training on the one-card host: four gloo ranks of this
    card (``--hier-worker``) at data 2 x fsdp 2 over two emulated slices
    (ranks {0, 1} and {2, 3}; the intra-slice width 2), each running
    ``pretrain.py::train_loop_per_worker`` through ``TorchTrainer.fit()``
    on the pre-train job at full width cut to ``HIER_LAYERS`` layers,
    OVERLAP=manual, FUSED_OPS=1, bf16 over fp32 parameters, 1 + 1 steps
    under DCN_SYNC flat, hier and hier + DCN_COMPRESS=bf16. Gates per
    rank (``_hier_hold``): hier bit for bit flat; bf16 not bit for bit
    hier and within MESH_MULTI_RTOL; rows 1-8 launched as the pre-train
    step does; the cross-slice bytes a step as reckoned from the shapes,
    hier at most (1/2 + 0.01) of flat. The line prints each arm's step
    p50, peak and bytes. The slices are emulated on one card: no number
    here is a cross-node time."""
    import shutil
    import tempfile
    root = tempfile.mkdtemp(prefix="chip_smoke_hier_")
    try:
        hung, rcs, ranks = _spawn_ranks(
            "--hier-worker", os.path.join(root, "rank"), HIER_RANKS,
            [0] * HIER_RANKS, HIER_TIMEOUT_S)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    problems = []
    line = {"phase": "train_hier", "nvidia_smi": nvidia_smi_line(),
            "model": "basic_lm", "mesh": {"data": 2, "fsdp": 2,
                                          "num_slices": 2},
            "backend": "gloo", "ranks_on_one_card": HIER_RANKS,
            "slices": "emulated on one card; no cross-node time",
            "cut": f"{HIER_LAYERS} of 24 layers, 1 + {HIER_STEPS - 1} "
                   "steps an arm"}
    launches = None
    if hung or any(rcs) or None in ranks:
        problems.append(f"ranks hung {hung}, exit codes {rcs}")
        line["ranks"] = ranks
    else:
        gaps = {r["rank"]: _hier_hold(f"rank {r['rank']}", r["runs"],
                                      problems) for r in ranks}
        first = ranks[0]["runs"]["flat"]
        line.update(
            bf16_rel_gaps=gaps, tol_rel=MESH_MULTI_RTOL,
            params=first.get("params"), vocab=first.get("vocab"),
            d_model=first.get("d_model"), tokens_per_step=first.get("tokens"),
            arms={r["rank"]: _hier_summary(r["runs"]) for r in ranks},
            launches_per_step={r["rank"]: {
                a: run["launches_per_step"] for a, run in r["runs"].items()}
                for r in ranks},
            rank_start_s=[r["since_start_s"] for r in ranks],
            rank_done_s=[r["done_s"] for r in ranks])
        launches = {}
        for r in ranks:
            for run in r["runs"].values():
                for k, v in run["launches_per_step"].items():
                    launches[k] = launches.get(k, 0) + v
    line.update(ok=not problems, problems=problems)
    emit(line)
    if problems:
        raise SystemExit("train_hier phase failed: " + "; ".join(problems))
    return launches


def _hier_multi_worker(out_path):
    """One rank of train_hier_multi's part (a) (NCCL, one card a rank) at
    data 2 x fsdp 2 over two slices: the fine-tune job's full fine-tuning
    of Llama-3.1-8B at ``HIER_MULTI_LAYERS`` layers, fp32 parameters,
    Adafactor, under each arm, alternated (flat, hier, bf16, bf16, hier,
    flat), deterministic algorithms on."""
    import torch
    import torch.distributed as dist
    from gke_ray_train_tpu_torch.parallel import (
        MeshConfig, build_mesh, distributed_init)
    from gke_ray_train_tpu_torch.parallel.placement import (
        input_shard_layout)
    dev = distributed_init()
    rank, world = dist.get_rank(), dist.get_world_size()
    rec = {"rank": rank, "world": world,
           "device_name": torch.cuda.get_device_name(dev), "runs": {}}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        mesh = build_mesh(MeshConfig(data=2, fsdp=2, num_slices=2))
        rows = input_shard_layout(mesh)
        cfg = _llama_cfg(FINE_TUNE_CONFIG, HIER_MULTI_LAYERS, "bfloat16",
                         "float32")
        for arm in tuple(HIER_ARMS) + tuple(reversed(HIER_ARMS)):
            sync, compress = HIER_ARMS[arm]
            r, launches = _ov_run(
                dev, cfg, mesh, "manual", HIER_MULTI_STEPS, rows=rows,
                ft_over=HIER_MULTI_FT, optim="adafactor",
                plan_over={"num_slices": 2, "dcn_sync": sync,
                           "dcn_compress": compress})
            r["reckoned_cross_bytes"] = _hier_reckoned(cfg, arm)
            rec["runs"].setdefault(arm, []).append(r)
            rec["launches"] = launches
    finally:
        torch.use_deterministic_algorithms(False)
        with open(out_path + f".{rank}", "w") as f:
            json.dump(rec, f)
        dist.barrier()
        dist.destroy_process_group()


def _hier_drill_worker(out_path):
    """One rank of train_hier_multi's slice_evict drill, started with
    torchrun's env (NCCL, one card a rank), on the job of
    ``<out_path>.job.json``: {"config", "env" (set first), "elastic",
    "max_preemptions", "worker_env"}. Without "worker_env" the pre-train
    entry's worker through ``TorchTrainer.fit()``; with it one attempt as
    the trainer's Ray path starts an elastic one (``_run_worker`` with the
    pool notice). A save every 2 steps, TF32 off, deterministic algorithms
    on. Writes ``<out_path>.<rank>``: the result, every step's loss (hex)
    and the plan each step was built with."""
    import torch
    from gke_ray_train_tpu_torch import pretrain
    from gke_ray_train_tpu_torch.rayint import (
        FailureConfig, RunConfig, TorchTrainer)
    from gke_ray_train_tpu_torch.rayint.trainer import _run_worker
    with open(out_path + ".job.json") as f:
        job = json.load(f)
    os.environ.update(job.get("env", {}))
    torch.use_deterministic_algorithms(True, warn_only=True)
    rec = dict(losses={}, step_s=[], calls=0, smoke=None)
    orig = _pretrain_hooks(rec, sync=False, ckpt_every=2)
    hooked = pretrain.make_train_step
    plans = []

    def make_train_step(*a, **kw):
        p = kw["plan"]
        plans.append([p.num_slices, p.dcn_sync, p.dcn_compress,
                      p.fingerprint(), dataclasses.replace(
                          p, dcn_sync="flat",
                          dcn_compress="none").fingerprint()])
        return hooked(*a, **kw)
    pretrain.make_train_step = make_train_step
    try:
        with _tf32_off():
            if "worker_env" in job:
                got = _run_worker(pretrain.train_loop_per_worker,
                                  job["config"], job["worker_env"])
                res = {"status": "ok", "error": None, "attempts": 1,
                       "log": [{"resumed_step": got["resumed_step"]}]}
            else:
                r = TorchTrainer(
                    pretrain.train_loop_per_worker,
                    train_loop_config=job["config"],
                    run_config=RunConfig(
                        elastic=job.get("elastic"), retry_backoff_s=0.0,
                        failure_config=FailureConfig(
                            max_failures=0,
                            max_preemptions=job.get("max_preemptions", 8))),
                    use_ray=False).fit()
                res = {"status": r.status, "error": r.error,
                       "attempts": r.attempts,
                       "log": [{k: v for k, v in e.items()
                                if k != "goodput"} for e in r.attempt_log]}
    finally:
        for name, fn in orig.items():
            setattr(pretrain, name, fn)
        torch.use_deterministic_algorithms(False)
    rank = int(os.environ["RANK"])
    with open(out_path + f".{rank}", "w") as f:
        json.dump(dict(res, rank=rank, plans=plans,
                       losses={s: float(v).hex()
                               for s, v in sorted(rec["losses"].items())}),
                  f)


def _hier_drill(problems):
    """train_hier_multi's part (b): the pre-train entry at data 2 x fsdp 2
    over two slices, DCN_SYNC=hier, OVERLAP=manual, fp32, on four cards:
    an uninterrupted run (U); a run under ``HIER_DRILL_SPEC`` (S), which
    must record a shrink to a pool of 2 at step 2 and stop (no preemption
    left); then its next attempt on two cards (R), started as the
    trainer's Ray path starts an elastic one: one slice, the downgraded
    flat plan (its fingerprint flat's), resumed from step 2, each later
    loss within ``HIER_DRILL_RTOL`` of U's. Returns the line's fields."""
    import shutil
    import tempfile
    root = tempfile.mkdtemp(prefix="chip_smoke_hier_drill_")
    env = {"NUM_SLICES": "2", "DCN_SYNC": "hier", "OVERLAP": "manual",
           "PREEMPT_SYNC_EVERY": "1", "PYTHONHASHSEED": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    out = {}
    try:
        def spawn(label, n, storage, **job):
            config = _pretrain_config(root, n_layers=HIER_DRILL_LAYERS,
                                      dtype="float32", OVERLAP="manual",
                                      DCN_SYNC="hier",
                                      storage_path=os.path.join(root,
                                                                storage),
                                      **HIER_MESH)
            config["max_samples"] = HIER_DRILL_STEPS \
                * config["batch_size_per_device"] * 4
            path = os.path.join(root, label)
            with open(path + ".job.json", "w") as f:
                json.dump(dict(job, config=config), f)
            t = time.perf_counter()
            hung, rcs, ranks = _spawn_ranks("--hier-drill-worker", path, n,
                                            list(range(n)),
                                            HIER_DRILL_TIMEOUT_S)
            out[label] = {"exit_codes": rcs, "hung": hung,
                          "wall_s": time.perf_counter() - t,
                          "ranks": ranks}
            if hung or any(rcs) or None in ranks:
                problems.append(f"drill {label}: hung {hung}, exit codes "
                                f"{rcs}")
                return None
            return ranks
        u = spawn("U", 4, "u")
        s = spawn("S", 4, "s", env={"FAULT_SPEC": HIER_DRILL_SPEC},
                  elastic=True, max_preemptions=0)
        r = spawn("R", 2, "s", worker_env={
            "ELASTIC": "1", "ELASTIC_N_DEVICES": "2",
            "ELASTIC_FULL_POOL": "4"}) if s else None
        if u and s and r:
            for x in u:
                if x["status"] != "ok" or {tuple(p[:2]) for p in x["plans"]} \
                        != {(2, "hier")}:
                    problems.append(f"drill U rank {x['rank']}: "
                                    f"{x['status']} {x['plans']}")
            for x in s:
                log = x["log"][0] if x["log"] else {}
                if (x["status"], x["attempts"], log.get("event"),
                        log.get("pool"), log.get("step")) != (
                        "preempted", 1, "shrink", 2, 2):
                    problems.append(f"drill S rank {x['rank']}: "
                                    f"{x['status']} {x['log']}")
            gaps = []
            for x in r:
                plan = x["plans"][-1] if x["plans"] else None
                if x["status"] != "ok" or x["log"][0]["resumed_step"] != 2 \
                        or plan is None or plan[:3] != [1, "flat", "none"] \
                        or plan[3] != plan[4]:
                    problems.append(f"drill R rank {x['rank']}: "
                                    f"{x['status']} {x['log']} {plan}")
                want = {k: float.fromhex(v) for k, v in u[0]["losses"].items()}
                got = {k: float.fromhex(v) for k, v in x["losses"].items()}
                steps = [str(i) for i in range(3, HIER_DRILL_STEPS + 1)]
                if sorted(got, key=int) != steps:
                    problems.append(f"drill R rank {x['rank']}: steps "
                                    f"{sorted(got, key=int)}")
                    continue
                g = [abs(got[k] - want[k]) / abs(want[k]) for k in steps]
                gaps.append(max(g))
                if max(g) > HIER_DRILL_RTOL:
                    problems.append(f"drill R rank {x['rank']}: losses "
                                    f"{got} against U's {want}")
            out["resume_max_rel_gap"] = max(gaps) if gaps else None
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)
    for label in ("U", "S", "R"):
        if label in out:
            out[label]["ranks"] = [
                {k: x[k] for k in ("rank", "status", "attempts", "log",
                                   "plans", "losses")} if x else None
                for x in out[label]["ranks"]]
    return out


def phase_train_hier_multi(dev):
    """Multi-slice training on the four-card host (fewer fails), NCCL, one
    rank a card, data 2 x fsdp 2 over two slices of two cards: (a) the
    fine-tune job's full fine-tuning of Llama-3.1-8B at full depth
    (``--hier-multi-worker``), the arms alternated, 1 + 3 steps a run:
    hier bit for bit flat, bf16 within MESH_MULTI_RTOL of hier and not bit
    for bit, the cross-slice bytes a step as reckoned, rows 1-8 launched
    as the full fine-tuning step does; each arm's step p50 and spread,
    tokens/s and peak a card; (b) the slice_evict drill (``_hier_drill``).
    The slices are cards of one node: no number here is a cross-node
    time."""
    import tempfile
    import torch
    n = torch.cuda.device_count()
    if n < 4:
        raise SystemExit(f"train_hier_multi needs 4 cards, this host has "
                         f"{n}")
    out = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_hier_multi_"),
                       "rank")
    hung, rcs, ranks = _spawn_ranks("--hier-multi-worker", out, 4,
                                    list(range(4)), HIER_MULTI_TIMEOUT_S)
    problems = []
    line = {"phase": "train_hier_multi", "nvidia_smi": nvidia_smi_line(),
            "model": "llama3-8b", "mesh": {"data": 2, "fsdp": 2,
                                           "num_slices": 2},
            "backend": "nccl", "cards": 4,
            "slices": "two cards of one node each; no cross-node time",
            "cut": f"{HIER_MULTI_LAYERS} layers, full fine-tuning, fp32 "
                   f"parameters, bf16 compute, adafactor, 1 + "
                   f"{HIER_MULTI_STEPS} steps a run, arms alternated"}
    launches = None
    if hung or any(rcs) or None in ranks:
        problems.append(f"ranks hung {hung}, exit codes {rcs}")
        line["ranks"] = ranks
    else:
        arms = {}
        for r in ranks:
            name = f"rank {r['rank']}"
            runs = r["runs"]
            first = {arm: rs[0] for arm, rs in runs.items()}
            for key in ("losses", "grad_norms"):
                if first["hier"][key] != first["flat"][key]:
                    problems.append(f"{name}: hier {key} "
                                    f"{first['hier'][key]} are not flat's "
                                    f"{first['flat'][key]} bit for bit")
            if first["bf16"]["grad_norms"] == first["hier"]["grad_norms"]:
                problems.append(f"{name}: bf16 is hier bit for bit")
            gaps = _hold_streams(f"{name} bf16", first["bf16"],
                                 first["hier"], MESH_MULTI_RTOL, problems)
            summary = {}
            for arm, rs in runs.items():
                steps = [t for x in rs for t in x["step_s"]]
                p50 = sorted(steps)[len(steps) // 2]
                for x in rs:
                    if x["launches_per_step"] != x["want_launches"]:
                        problems.append(f"{name} {arm}: launches "
                                        f"{x['launches_per_step']} != "
                                        f"{x['want_launches']}")
                    got = x["manual_counts"]["cross_bytes"]
                    if got != x["reckoned_cross_bytes"]:
                        problems.append(f"{name} {arm}: {got} cross-slice "
                                        "bytes a step, reckoned "
                                        f"{x['reckoned_cross_bytes']}")
                summary[arm] = {
                    "step_s": steps, "step_s_p50": p50,
                    "step_s_spread": max(steps) - min(steps),
                    "tokens_per_s_per_card": rs[0]["tokens"] / p50 / 4,
                    "peak_mem_bytes": max(x["peak_mem_bytes"] for x in rs),
                    "cross_bytes_per_step":
                        rs[0]["manual_counts"]["cross_bytes"],
                    "reckoned_cross_bytes": rs[0]["reckoned_cross_bytes"],
                    "losses": [x["losses"] for x in rs],
                    "grad_norms": [x["grad_norms"] for x in rs]}
            arms[r["rank"]] = {"arms": summary, "bf16_rel_gaps": gaps}
        line.update(per_rank=arms, tol_rel=MESH_MULTI_RTOL)
        launches = {}
        for r in ranks:
            for k, v in r["launches"].items():
                launches[k] = launches.get(k, 0) + v
    line["drill"] = _hier_drill(problems)
    line.update(ok=not problems, problems=problems)
    emit(line)
    if problems:
        raise SystemExit("train_hier_multi phase failed: "
                         + "; ".join(problems))
    return launches


# ---------------------------------------------------------------------------

PHASES = ("device", "build", "kernels", "kernelcheck", "serve", "parity",
          "serve_tenants", "serve_tenants_parity", "train", "train_parity", "train_fused", "train_fused_parity",
          "train_fused_ce", "train_fused_ce_parity", "train_mesh",
          "train_mesh_parity", "train_remat_dots", "train_tp", "train_cp",
          "train_profile", "entry", "train_moe", "train_moe_parity",
          "serve_moe", "entry_moe", "profile", "train_fused_profile",
          "train_fused_ce_profile", "train_moe_profile", "entry_full",
          "train_mesh_multi", "train_tp_multi", "pretrain",
          "pretrain_multi", "train_cp_multi", "serve_mesh",
          "serve_mesh_multi", "train_ep", "train_ep_multi", "train_pp",
          "train_pp_multi", "train_pp_moe_multi", "train_overlap",
          "train_overlap_multi", "train_hier", "train_hier_multi")
# run only when asked for
OPT_IN_PHASES = ("profile", "train_fused_profile", "train_fused_ce_profile",
                 "train_moe_profile", "entry_full", "train_mesh_multi",
                 "train_tp_multi", "pretrain_multi", "train_cp_multi",
                 "serve_mesh_multi", "train_ep_multi", "train_pp_multi",
                 "train_pp_moe_multi", "train_overlap_multi",
                 "train_hier_multi")
DEFAULT_PHASES = tuple(p for p in PHASES if p not in OPT_IN_PHASES)

KERNEL_SOURCES = {
    "flash_fwd": ("gke_ray_train_tpu_torch/csrc/flash_fwd.cu",
                  "gke_ray_train_tpu/ops/flash_attention.py:175"),
    "flash_bwd_dq": ("gke_ray_train_tpu_torch/csrc/flash_bwd.cu",
                     "gke_ray_train_tpu/ops/flash_attention.py:303"),
    "flash_bwd_dkv": ("gke_ray_train_tpu_torch/csrc/flash_bwd.cu",
                      "gke_ray_train_tpu/ops/flash_attention.py:339"),
    "fused_rmsnorm": ("gke_ray_train_tpu_torch/csrc/fused_norm_rope.cu",
                      "gke_ray_train_tpu/ops/fused_norm_rope.py:96"),
    "fused_rope_qk": ("gke_ray_train_tpu_torch/csrc/fused_norm_rope.cu",
                      "gke_ray_train_tpu/ops/fused_norm_rope.py:103"),
    "fused_rmsnorm_rope": ("gke_ray_train_tpu_torch/csrc/fused_norm_rope.cu",
                           "gke_ray_train_tpu/ops/fused_norm_rope.py:112"),
    "fused_ce_row_stats": ("gke_ray_train_tpu_torch/csrc/fused_ce.cu",
                           "gke_ray_train_tpu/ops/fused_ce.py:70"),
    "fused_ce_dx": ("gke_ray_train_tpu_torch/csrc/fused_ce.cu",
                    "gke_ray_train_tpu/ops/fused_ce.py:106"),
    "fused_ce_dhead": ("gke_ray_train_tpu_torch/csrc/fused_ce.cu",
                       "gke_ray_train_tpu/ops/fused_ce.py:133"),
}


# the wgmma entries the build line reports on their own: (source, entry
# pattern, {template argument: name})
_WGMMA_ENTRIES = (
    ("flash_bwd", r"flash_bwd_dq_wgmma_kernelILi(\d+)E",
     {"64": "dq_dh64", "128": "dq_dh128", "256": "dq_dh256"}),
    ("fused_ce", r"ce_wgmma_kernelILi(\d)E",
     {"0": "dlogits", "1": "dx", "2": "dhead", "3": "row_stats"}),
)


def _wgmma_ptxas(report):
    """The dQ and fused cross-entropy wgmma entries from the build report:
    {source: {name: {"registers", "stack", "spill_stores",
    "spill_loads"}}}, and ptxas's warnings on those sources."""
    out = {}
    for source, pattern, names in _WGMMA_ENTRIES:
        rows = out.setdefault(source, {})
        for e in report.get(source, {}).get("ptxas", []):
            m = re.search(pattern, e.get("entry", ""))
            if m:
                rows[names[m.group(1)]] = {k: v for k, v in e.items()
                                           if k != "entry"}
            elif "warning" in e:
                rows.setdefault("warnings", []).append(e["warning"])
    return out


_NORM_TYPES = {"13__nv_bfloat16": "bf16", "f": "f32"}


def _norm_ptxas(report):
    """The rms_norm registers body's entries from the build report:
    {"fused_norm_rope": {"<x>_<scale>_D<width>[_sp1]": {"registers",
    "stack", "spill_stores", "spill_loads"}}}. In the mangled name the
    scale type is bf16 where it repeats x's (a substitution)."""
    rows = {}
    for e in report.get("fused_norm_rope", {}).get("ptxas", []):
        m = re.search(r"rmsnorm_reg_kernelI(13__nv_bfloat16|f)"
                      r"(13__nv_bfloat16|S\d*_|f)Li(\d+)ELb([01])E",
                      e.get("entry", ""))
        if m:
            t = _NORM_TYPES[m.group(1)]
            ts = _NORM_TYPES.get(m.group(2), "bf16")
            name = f"{t}_{ts}_D{m.group(3)}" + ("_sp1" if m.group(4) == "1"
                                                else "")
            rows[name] = {k: v for k, v in e.items() if k != "entry"}
    return {"fused_norm_rope": rows}


def _spills(*ptxas):
    """The reported entries that spill ("source/name")."""
    return sorted(f"{src}/{name}" for report in ptxas
                  for src, rows in report.items()
                  for name, e in rows.items() if name != "warnings"
                  and (e.get("spill_stores") or e.get("spill_loads")))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(DEFAULT_PHASES),
                    help="comma-separated subset of " + ",".join(PHASES)
                    + " (default: all but " + ",".join(OPT_IN_PHASES)
                    + ")")
    ap.add_argument("--mesh-worker", metavar="OUT",
                    help=argparse.SUPPRESS)
    ap.add_argument("--entry-worker", nargs=2, metavar=("CONFIG", "OUT"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--tp-worker", metavar="OUT", help=argparse.SUPPRESS)
    ap.add_argument("--cp-worker", metavar="OUT", help=argparse.SUPPRESS)
    ap.add_argument("--cp-multi-worker", metavar="OUT",
                    help=argparse.SUPPRESS)
    ap.add_argument("--tp-multi-worker", metavar="OUT",
                    help=argparse.SUPPRESS)
    ap.add_argument("--pretrain-worker", nargs=2, metavar=("CONFIG", "OUT"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--serve-mesh-worker", metavar="OUT",
                    help=argparse.SUPPRESS)
    ap.add_argument("--serve-multi-worker", metavar="OUT",
                    help=argparse.SUPPRESS)
    ap.add_argument("--serve-entry-worker", nargs=2,
                    metavar=("CONFIG", "OUT"), help=argparse.SUPPRESS)
    ap.add_argument("--ep-worker", metavar="OUT", help=argparse.SUPPRESS)
    ap.add_argument("--ep-multi-worker", metavar="OUT",
                    help=argparse.SUPPRESS)
    ap.add_argument("--pp-worker", metavar="OUT", help=argparse.SUPPRESS)
    ap.add_argument("--pp-multi-worker", metavar="OUT",
                    help=argparse.SUPPRESS)
    ap.add_argument("--pp-moe-multi-worker", metavar="OUT",
                    help=argparse.SUPPRESS)
    ap.add_argument("--ov-worker", metavar="OUT", help=argparse.SUPPRESS)
    ap.add_argument("--ov-multi-worker", metavar="OUT",
                    help=argparse.SUPPRESS)
    ap.add_argument("--hier-worker", metavar="OUT", help=argparse.SUPPRESS)
    ap.add_argument("--hier-multi-worker", metavar="OUT",
                    help=argparse.SUPPRESS)
    ap.add_argument("--hier-drill-worker", metavar="OUT",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    workers = {"mesh_worker": _mesh_worker, "tp_worker": _tp_worker,
               "tp_multi_worker": _tp_multi_worker, "cp_worker": _cp_worker,
               "cp_multi_worker": _cp_multi_worker,
               "serve_mesh_worker": _serve_mesh_worker,
               "serve_multi_worker": _serve_multi_worker,
               "ep_worker": _ep_worker, "ep_multi_worker": _ep_multi_worker,
               "pp_worker": _pp_worker, "pp_multi_worker": _pp_multi_worker,
               "pp_moe_multi_worker": _pp_moe_multi_worker,
               "ov_worker": _ov_worker, "ov_multi_worker": _ov_multi_worker,
               "hier_worker": _hier_worker,
               "hier_multi_worker": _hier_multi_worker,
               "hier_drill_worker": _hier_drill_worker}
    if args.entry_worker or args.pretrain_worker or \
            args.serve_entry_worker or any(getattr(args, k) for k in workers):
        # one rank of a multi-process phase, spawned by that phase
        sys.path.insert(0, HERE)
        if args.entry_worker:
            _entry_worker(*args.entry_worker)
        if args.pretrain_worker:
            _pretrain_worker(*args.pretrain_worker)
        if args.serve_entry_worker:
            _serve_entry_worker(*args.serve_entry_worker)
        for key, fn in workers.items():
            if getattr(args, key):
                fn(getattr(args, key))
        return 0
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from gke_ray_train_tpu_torch import kernels

    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    emit({"phase": "device", "ok": True, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "device_name": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    report = kernels.build()
    wgmma = _wgmma_ptxas(report)
    norm = _norm_ptxas(report)
    spills = _spills(wgmma, norm)
    emit({"phase": "build", "ok": not spills,
          "seconds": time.perf_counter() - t0, "wgmma_ptxas": wgmma,
          "norm_ptxas": norm, "spills": spills, "kernels": report})
    if spills:
        raise SystemExit(f"build phase: reported kernels spill: {spills}")

    # launches on the main paths: each path driven with the counts at 0
    launches = {name: None for name in KERNEL_SOURCES}
    seconds = {}

    def run(phase, fn):
        if phase not in phases:
            return None
        t = time.perf_counter()
        out = fn(dev)
        seconds[phase] = time.perf_counter() - t
        return out

    def add(counts):
        for name, n in (counts or {}).items():
            launches[name] = (launches[name] or 0) + n
    timings = run("kernels", phase_kernels) or {}
    add(run("kernelcheck", phase_kernelcheck))
    serve = run("serve", phase_serve)
    add({"flash_fwd": serve} if serve is not None else None)
    run("parity", phase_parity)
    tenants = run("serve_tenants", phase_serve_tenants)
    add({"flash_fwd": tenants} if tenants is not None else None)
    run("serve_tenants_parity", phase_serve_tenants_parity)
    add(run("train", phase_train))
    run("train_parity", phase_train_parity)
    add(run("train_fused", phase_train_fused))
    run("train_fused_parity", phase_train_fused_parity)
    add(run("train_fused_ce", phase_train_fused_ce))
    add(run("train_fused_ce_parity", phase_train_fused_ce_parity))
    add(run("train_mesh", phase_train_mesh))
    add(run("train_mesh_parity", phase_train_mesh_parity))
    add(run("train_remat_dots", phase_train_remat_dots))
    add(run("train_tp", phase_train_tp))
    add(run("train_cp", phase_train_cp))
    add(run("serve_mesh", phase_serve_mesh))
    add(run("train_ep", phase_train_ep))
    add(run("train_pp", phase_train_pp))
    add(run("train_overlap", phase_train_overlap))
    add(run("train_hier", phase_train_hier))
    run("train_profile", phase_train_profile)
    add(run("entry", phase_entry))
    add(run("train_moe", phase_train_moe))
    add(run("train_moe_parity", phase_train_moe_parity))
    serve_moe = run("serve_moe", phase_serve_moe)
    add({"flash_fwd": serve_moe} if serve_moe is not None else None)
    add(run("entry_moe", phase_entry_moe))
    run("profile", phase_profile)
    run("train_fused_profile", phase_train_fused_profile)
    run("train_fused_ce_profile", phase_train_fused_ce_profile)
    run("train_moe_profile", phase_train_moe_profile)
    add(run("entry_full", phase_entry_full))
    run("train_mesh_multi", phase_train_mesh_multi)
    add(run("train_tp_multi", phase_train_tp_multi))
    add(run("pretrain", phase_pretrain))
    run("pretrain_multi", phase_pretrain_multi)
    add(run("train_cp_multi", phase_train_cp_multi))
    add(run("serve_mesh_multi", phase_serve_mesh_multi))
    add(run("train_ep_multi", phase_train_ep_multi))
    add(run("train_pp_multi", phase_train_pp_multi))
    add(run("train_pp_moe_multi", phase_train_pp_moe_multi))
    add(run("train_overlap_multi", phase_train_overlap_multi))
    add(run("train_hier_multi", phase_train_hier_multi))
    emit({"phase": "seconds", "ok": True, "seconds": seconds})
    idle = sorted(name for name, n in launches.items() if n == 0)
    if idle:
        raise SystemExit(f"kernels of a driven path never launched: {idle}")

    entries = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        t = timings.get(name, {})
        entries.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": t.get("max_abs_err"),
                        "ms": t.get("kernel_ms"),
                        "plain_ms": t.get("plain_ms"),
                        "bound_ms": t.get("bound_ms"),
                        "bound_by": t.get("bound_by"),
                        "library_ms": t.get("library_ms")})
    print(smi, flush=True)
    emit({"kernels": entries})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
