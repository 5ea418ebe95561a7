#!/usr/bin/env python3
"""Drive mimic_tpu_torch's serving, training and eval paths once on one CUDA card and check them.

    python3 chip_smoke.py        # from the repository root, on a machine with a card

Phases (any failure propagates: non-zero exit, no result line):

1. build   — compile the CUDA kernels (mimic_tpu_torch/ops/csrc/*.cu) with nvcc
             for sm_90a, one nvcc per source started together; print the build
             time and the card's name and power limit.
2. kernels — each kernel against its plain PyTorch version on the card, bf16,
             at the shapes its path gives it: the forward kernels at the
             serving and training shapes (ViT rows at B1 and B4, eval-protocol
             prefill, the record pass, long prefill at B1 and B2, ragged key
             axes), at masks whose first or interior key tiles hold no
             attendable key, at T != S, and each at the other's main shape;
             the backward pair at the shift pass (B2 T=S=256,
             left-padded, lse_u), B1 T=S=2048, a ragged B2 T=S=1000,
             without need_unmasked, and B2 T=S=512 with whole padded key
             tiles; max error against stated tolerances, a second launch
             bit-identical, and both times from CUDA events (the backward
             kernels' as device time through CUDA graphs), beside the backward
             of scaled_dot_product_attention at the shift pass as a yardstick;
             then the CLIP towers' rows (idefics-9b's at head dim 80,
             llava-1.5's at 64) as device time through CUDA graphs, onepass_fwd
             through its wrapper and scaled_dot_product_attention in turns,
             beside the bound; then the row-norm kernel (ops/norms.py) at the
             idefics2-8b train step's rows (NORM_SHAPES): within one bf16 ulp
             of its plain version, the share of elements bit-equal, its device
             time through CUDA graphs beside the plain version's, the bound of
             its bytes and F.layer_norm / F.rms_norm (the yardstick).
3. slice   — a tiny idefics2 in fp32 (ViT head dim 72, text head dim 128): the
             serving path through the kernels on the card must give the beam-3
             tokens of the plain path on the CPU, and prefill logits within 1e-4;
             then 3 MimIC train steps (make_train_step) through the kernels on
             the card against 3 through the plain path on the CPU: per-step
             metrics and the final shift tree within 1e-4.
4. main    — build_model("idefics2-8b-base") at full width and depth with random
             bf16 parameters made on the card, a MimIC shift (logz2="unmasked"),
             runner.generate with beam 3 and 10 new tokens: call A, 4 requests
             with one 980 px image each, bucketed to a 512-token prompt; call B,
             2 requests with a long context, bucketed to 4096 tokens so the
             prefill takes flash_fwd.  One warm-up of each call, then the counted
             and timed run.  Both kernels must have launched in that run, every
             prefill must have taken the "flash" path, and the 8B prefill logits
             through the kernels must match the plain attention path's.  Then
             one more run of each call under torch.profiler prints the device
             time by kernel group and the top kernels.
5. train   — the MimIC dual-pass train step on the same 8B runner: the mimic
             preset's shift in fp32 (logz2="unmasked"), build_optimizer at lr
             5e-3, make_train_step with attn_impl="flash"; a batch shaped like
             scripts/bench_8b_train.py (B2, record pass 2048 tokens with 8 demo
             images + the query image at 980 px, shift pass 256 tokens with the
             query image, 64 gathered query tokens per row).  One warm-up step,
             then 3 counted and timed steps: every decoder call took "flash",
             both backward kernels launched L - 1 = 31 times per step (layer
             0's attention inputs carry no gradient), the forward kernel
             launched, loss and grad_norm finite and grad_norm > 0, frozen
             weights bit-unchanged, shift changed.  Then one step under
             torch.profiler, the per-leaf gradients of one step through the
             kernels against the plain attention path (cosine >= 0.99), and the
             step timed again on precomputed image features (what the training
             vision-feature cache leaves of it; phase 12 runs the cache), once
             under the profiler.
6. int8 kernels — int8_matmul, fused_mlp_int8 and prompt_attn_int8 against their
             plain versions on the card, bf16, at the decode shapes of the int8
             serving path (phase 2's rules: max error against stated tolerances,
             both times from CUDA events), a second launch bit-identical,
             prompt_attn_int8 one kernel per call (torch.profiler); beside
             each int8 product the bf16 torch.matmul it stands in for (a
             yardstick of the mode, never called by the port); qdot's cut-off:
             int8_matmul against dequantize + bf16 torch.matmul for M 16-512.
7. tiny int8 — phase 3's tiny idefics2 (text width 128) with quant="int8" and a
             MimIC shift: beam-3 tokens on the card identical to the CPU's,
             prefill and first-decode-step logits within 1e-4, exact int8 kernel
             launch counts, and the int8 trees quantized on the card bit-identical
             to the CPU's; then one decoder_forward decode step over an int8
             prompt cache, card (kernels) against CPU (plain versions), 1e-4.
8. 8B int8 — after phase 5, on the same runner: set_quant("int8"), calls A and B
             with the shift (exact launch counts, q/s), the first decode step's
             logits through the kernels against a bf16 tree dequantized from the
             same int8 handles (row cosine >= 0.99), one int8 call A under the
             profiler; call B without a shift, which takes the int8 prompt KV,
             timed against the same call with quant_kv=False at Tp 4096 and at
             Tp 1024 (QUANT_KV_MIN_PROMPT's cut-off); then
             set_quant("int8-memory"): call A, peak device memory, kernels in the
             prefill (lm head) and the decode steps.

9. W8A8 kernels — w8a8_matmul against w8a8_matmul_plain at the 8B prefill shapes
             of call A (M = 2048: q/k/v, o, gate/up, down; stacked, at a layer other
             than 0), a ragged M, a lane-padded N through qdot and a K below the
             tile: fp32 and bf16 outputs EQUAL; times cold, as device time through
             CUDA graphs, beside torch._int_mm + scales, the dequantize + bf16
             matmul path and a bf16 torch.matmul (the yardstick); the quantize_rows
             kernel timed against its plain version per shape and bit-identical to
             the CPU's at K 80 / 4096 / 14336; W8A8_MIN_M's cut-off: quantize_rows +
             w8a8_matmul against int8_matmul at M 256 / 384 / 480.
10. tiny W8A8 — phase 7's tiny idefics2 in "int8-w8a8" at 256 prompt rows: exact
             launches (4 per layer per prefill), prefill logits on the card against
             a CPU computation through the plain W8A8 functions.
11. 8B eval — run_train on the bf16 8B runner writes epoch-10 (after phase 12),
             then (after phase 8) the CLI's eval entry on a model
             built anew: checkpoint load, set_quant("int8-w8a8"), run_eval on
             2 x 4 requests (bucket 512, beam 3, 10 new tokens, shift active).
             Both vision-feature caches are on, as by default: their hit rates
             are printed.
             The record file holds the metric; every prefill took "flash";
             w8a8_matmul launched 4 x 32 times per prefill and the decode kernels
             as in "int8-memory"; first-step logits against a bf16 tree
             dequantized from the same handles (row cosine >= 0.99); q/s, peak
             memory, and the prefill timed in "int8-w8a8" beside "int8-memory".
12. caches, sampling, converter — on the phase-5 runner, after phase 5:
             (a) the 8-shot step through TrainVisionCache at phase 5's batch, one
             cold step and 3 warm ones, counted and timed: each warm step launches
             onepass_fwd 2 x 32 times (no ViT rows) and each backward kernel 31
             times; loss (relative 1e-3) and shift gradients (cosine >= 0.99)
             against the uncached step on the same state and batch; one warm step
             under torch.profiler.  (b) call A through enable_vision_cache, cold
             then warm: every image hits and the ViT launches nothing on the warm
             call, whose tokens and logits are bit-identical to the cold call's;
             first-step logits against the uncached runner (row cosine >= 0.99);
             three cold / warm pairs timed (the cache emptied before each cold
             call) and the encode a warm call skips (CUDA events); a batch
             sharing one demo image encodes it once.  (c)
             do_sample=True at call A's shape: top_k=1 gives the greedy tokens
             wherever the largest logit is unique (bf16 logits tie at the top,
             and the draw picks among the tied tokens),
             temperature 0.7 / top_k 50 / top_p 0.9 repeats under one seed and
             differs under another, tokens below the vocabulary, scores finite;
             once at call B's shape (flash_fwd).  (d) the converter at full width
             and depth: the random tree under HF's names (a helper of this script)
             and back through convert_idefics2 on the card, every leaf bit-equal,
             time and peak memory.  (e) a tiny idefics2 as two safetensors shards
             through python -m mimic_tpu_torch.models.convert, params.msgpack and
             build_model(paths=...): logits equal to the source runner's.
13. LoRA and prefix — on the phase-5 runner, after phase 12, on phase 5's batch
             with its images encoded once (what the warm training cache hands
             the step): (a) 3 counted steps of the lora preset (r 16, alpha 32,
             dropout 0.05 on q/k/v/o, Strategy.LM_LOSS: the shift pass alone,
             flash path), B drawn N(0, 0.05^2) so that A has a gradient: each
             step launches onepass_fwd and both backward kernels once per layer
             (32: layer 0's adapters give its attention inputs a gradient); the
             same state and seed repeat the loss, consecutive steps differ; the
             loss (relative 1e-3) and per-leaf gradients (cosine >= 0.99)
             against the plain attention path with the same dropout masks; one
             step under torch.profiler.  (b) The MimIC step with shift_remat
             against the same step without: loss equal, gradient cosine >=
             0.9999, seconds and peak memory of each, in turns.  (d) 3
             prefix-tuning steps (P 16; the plain cached path, no kernel
             launches), then beam-3 call A with the trained prefix: the prefill
             logs "flash+prefix" and launches onepass_fwd for the prompt block,
             its logits against the plain cached path (row cosine >= 0.99);
             under the profiler.  (e) call B in "int8" without a shift with the
             prefix: flash_fwd in the prefill, prompt_attn_int8 over the
             P + 4096 prompt slots in every decode step; under the profiler.
             (c) run_train with the lora preset (11 one-step epochs) writes
             epoch-10, then the CLI's eval (quant=int8-w8a8, preset=lora) on a
             model built anew: the adapters merged into the weights (no live
             adapters, the bf16 base kept), exact launches, q/s, peak memory;
             call A's prefill logits of the merged bf16 tree against live
             adapters (row cosine >= 0.99).

14. idefics-9b — after phase 11, once every idefics2-8b runner is gone:
             build_model("idefics-9b") at full width and depth (32 text layers,
             8 gated cross-attention layers, a 32-layer CLIP ViT-H/14 at head dim
             80, a 6-layer resampler with 64 latents), random bf16 weights, the
             cross-attention gates opened.  (b) Config 1's few-shot ICL call:
             4 requests x 16 shots, 17 images at 224 px each, beam 3, 10 new
             tokens through LVLMRunner.generate: exact launches (onepass_fwd
             32 ViT + 32 prefill layers), wall, busy, peak memory; the prefill
             logits against the plain attention path (row cosine >= 0.99).
             (d) 3 counted steps each of the licv preset and the mimic preset on
             the collator's idefics1 batch (B2, 8 shots, 9 images at 224 px):
             the backward pair 31 times a step, s/step, busy, peak memory, the
             shift gradient against the plain path (cosine >= 0.99).  (c) The
             ICL call in "int8-w8a8": exact launches, the cross layers' 2-D
             int8_matmul launches counted by shape, the first decode step's
             logits against the bf16 tree and a dequantized one (row cosine >=
             0.97).  Then the kernels against their plain versions at the shapes
             idefics-9b gives them (MHA, the 2-D cross products, F 11008, the
             W8A8 prefill).  Phase 2 holds the ViT's attention at head dim 80
             (B68, 384 slots, 257 keys) in bf16 and fp32.
15. llava — after phase 14: (a) build_model("llava-interleave-7b") at full width
             and depth (a Qwen2 text tower with q/k/v biases, 28 query heads on 4
             KV heads, a 26-layer SigLIP tower without its post-layernorm, the MLP
             projector), random bf16 weights, a MimIC shift: 4 requests with one
             384 px image each (729 image tokens), bucket 1024, beam 3, 10 new
             tokens, warm-up then the counted and timed call (exact launches), the
             prefill logits against the plain attention path, one call under
             torch.profiler; the same call in "int8" (exact launches; the first
             decode step against a bf16 tree dequantized from the same handles)
             and without a shift, where the int8 prompt KV takes prompt_attn_int8
             at 21 folded rows (3 beams x G 7); the MimIC step (B2, 4 shots: a
             4096-token record pass with 5 images, a 1024-token shift pass; the
             backward pair 27 times a step, frozen weights bit-unchanged, the
             shift changed); run_train (the training cache) and the CLI's eval in
             "int8-w8a8" on 2 x 4 requests (both caches on); the call in
             "int8-w8a8" (exact launches; first-step logits against a dequantized
             tree).  (b) build_model("llava-1.5-7b") (LLaMA, a 23-layer CLIP
             ViT-L/14-336 at head dim 64, the class token dropped): one bf16 call,
             4 requests x one 336 px image, bucket 1024, beam 3; onepass_fwd
             launched at head dim 64 in the tower, counted.  (c) A tiny qwen2-like
             tower (G 7) and a tiny mistral-like one with a window narrower than T
             in fp32: beam tokens on the card equal the CPU's, prefill logits
             within 1e-4.  Then the kernels at the shapes llava gives them (G 7
             forward and backward, the int8 and W8A8 widths).  Phase 2 holds the
             attention forward at head dim 64 (the CLIP ViT-L rows, a wholly
             masked first tile, fp32); phase 6 prompt_attn_int8 at G 7.
16. serve engine and tracing — on the bf16 phase-4 runner, after phase 13:
             mimic_tpu_torch.serve.ServeEngine at scripts/bench_serve.py's
             traffic (64 text requests, prompts uniform in [96, 512), 10 new
             tokens; 32 slots, max_len 544, buckets 128 / 256 / 512,
             decode_block 5) with a MimIC shift.  (a) bf16: warm-up, then the
             counted and timed run (q/s, peak memory; launches exactly
             onepass_fwd 32 per prefill wave, nothing else), one run under
             torch.profiler; every request's prefill logits in its left-padded
             wave against the prompt prefilled alone (row cosine >= 0.99); the
             static baseline (batches of 16 padded to 512 through
             greedy_generate) timed beside it, and how many requests' tokens
             equal its tokens (printed, not gated).  (b) decode_params from
             set_quant("int8"): exact launches (int8_matmul 65 and
             fused_mlp_int8 32 per decode step, onepass_fwd as in (a)); the
             first decode step against a dequantized bf16 tree (row cosine >=
             0.99).  (d) scripts/bench_serve_varlen.py's traffic (a budget of
             64, decode_block 8, the EOS column of the lm head x4) with
             max_len 576, reclaim on and off: tokens identical, blocks reclaimed,
             q/s and host syncs of each.  (e) 8 requests with one 980 px image
             each, encoded once through VisionFeatureCache and admitted as
             (base, row), against the same requests admitted with pixels:
             prefill logits (row cosine >= 0.99), the ViT's launches in the
             wave.  (f) the tracing utilities on a one-image prompt in a
             256-token bucket through the kernels: capture_forward's shapes and
             launches, capture_grads (flash_bwd_dq / flash_bwd_dkv 31 each,
             gradients against the plain path at cosine >= 0.99),
             attention_probs of layer 16 (rows sum to 1 within 1e-3, nothing
             above the diagonal), profile's trace listing kernels on the card.
             (c) the engine on quantize_lm_params(act_quant=True) of the bf16
             tree (the "int8-w8a8" tree; the runner keeps its bf16 one): exact
             launches (w8a8_matmul and quantize_rows 128 in every wave of M >=
             256); every wave's prefill again through the plain W8A8
             functions on the card: logits equal bit for bit; the prefill
             logits against a bf16 tree dequantized from the same handles
             (printed: phase 11 holds that comparison at call A).  (g) a
             tiny fp32 engine: the card's tokens equal the CPU's.
17. parallel — on the bf16 phase-4 runner, after phase 16: (a) the ring of
             ops/ring_attention.py at idefics2-8b width (B2, H32/8, D128,
             causal, a left-padded key mask, lse_u), 4 ranks at T=S=4096 and 2
             at 2048 in one process: each rank's chunk over every rank's block
             through ring_block and RingMerge (the exchange replaced by
             indexing), against one forward-kernel call on the whole sequence
             by phase 2's bf16 gates, exactly n² forward launches, both device
             times.  (b) on a one-rank NCCL group (file:// store in a temporary
             directory): phase 5's step on precomputed image features with
             attn_impl="ring", a (data 1 x sp 1) ring mesh and ring_min_len
             1024: the record pass logs "ring" and launches onepass_fwd once per
             layer (n² = 1), the shorter shift pass logs "flash" and runs the
             forward and backward kernels, the launches equal the "flash"
             step's, the loss and the updated shift beside the "flash" step's,
             one step's gradients against the flash path's (cosine >= 0.99).
             (c) the ring's backward at (a)'s shapes in one process
             (ring_attention_backward_chunks: the package's schedule, the
             exchange replaced by indexing): each rank's chunk over every
             block through ring_block_backward with the merged forward, the
             partials summed in fp32, against one flash_attention_backward
             call on the whole sequence by TOL_BWD_BF16 on dq, dk and dv, with
             bf16 g_out and an fp32 g_lse_u (exactly n² launches of each
             backward kernel) and with g_lse without need_unmasked
             (n(n+1)/2); both device times and the Δ passes saved; at n 4 the
             kernels on one block of each kind the ring runs (past,
             non-causal; diagonal; future, all keys masked, with lse_u only)
             against the plain backward on that block by TOL_BWD_BF16, and
             their times beside their bounds.  (d)
             (b)'s step at ring_min_len 0, and once more under shift_remat:
             both passes log "ring", the shift pass's backward runs through
             RingAttentionDiff, the launches equal the "flash" step's (the
             backward pair L - 1 each), the loss within 1e-6 relative and
             every leaf's gradient cosine >= 0.9999 against the flash step's
             (a ring of one rank is one diagonal block through the same
             kernels).  Call A under use_mesh(make_mesh(1, 1)) gives the
             tokens of call A without it; the group is destroyed at the end.
18. head split — a (data 1 x model 8) mesh whose model axis cuts inside
             a head, as 8 processes sharing the card over gloo (each checks
             first that gloo's all_reduce and all_gather take CUDA tensors),
             each with its shard_params trees: llava-interleave-7b's decoder at
             full width cut to 4 layers (q 3.5 heads, k/v half a head a rank:
             the gathered region) and idefics2-8b-base's connector (k/v half a
             head), bf16 random weights from fixed seeds, each against one
             process on the card.  (a) greedy_generate, B4 x T1024 with a
             left-padded row, 8 new tokens, a MimIC shift: one onepass_fwd a
             layer per rank over all 28 heads, every rank's KV cache bytes
             (every KV head), and the prefill's and each decode step's logits
             with one process's tokens (min row cosine >= MIN_LOGIT_COSINE, rms
             distance to the same function in fp32 <= HEADSPLIT_NOISE_RATIO x
             one process's); (b) the MimIC
             step's loss (relative 1e-3) and shift gradients (cosine >= 0.99)
             through the forward and backward kernels, record T 1024, shift T
             256; (c) the connector on one row of phase 5's 8-shot image
             features (9 x 4900 patches), by (a)'s gates.  The attention per rank and layer
             at all 28 heads beside model 4's 7 (CUDA events, one process).
19. model axis, rest — MODEL_AXIS_RANKS processes share the card over gloo,
             idefics2-8b-base's text tower at full width cut to 4 layers, bf16.
             First a probe of gloo's batch_isend_irecv (the ring's exchange)
             on CUDA tensors: where it refuses them, no ring crosses processes
             here.  (a) the MimIC step's loss and gradients on the ring at
             ring_min_len 0 on a ("data", "sp", "model") mesh ((1, 2, 2), or
             (1, 1, 4) after a refusal), held to one process (loss 1e-3
             relative, gradient cosine >= 0.99); (b) the record pass at T 4096
             on the ring (over "model" with every head gathered, or (a)'s
             ring of one); (c) make_mesh(1, 4) with the runner in "int8",
             "int8-memory" and "int8-w8a8": its handles bit-equal to one
             process's, beam 3 on B4 x T1024 (the int8 prompt KV in "int8"),
             the logits of the prefill and 8 forced decode steps (min row
             cosine >= MIN_LOGIT_COSINE); every rank's launches of each run
             against the counts the phase expects.

20. Kimi-VL — last, its kernels first (in the full run, after phase 2's): the
             latent-attention instantiations (q / k heads 192 wide, v heads 128)
             through the wrappers at the kimi-vl-a3b.mimic-train-8shot cell's
             shapes against their plain versions by phase 2's tolerances:
             flash_fwd at the record pass (B2 H16 T=S=5376, causal, right-padded,
             no lse_u; scaled_dot_product_attention on the same inputs as the
             library time), onepass_fwd and the backward pair at the shift pass
             (B2 T=S=768, lse_u); the routed experts' grouped products
             (torch._grouped_mm) timed at both passes' rows.  Then
             build_model("kimi-vl-a3b-instruct") whole, random bf16 weights made
             on the card, and its MimIC train step on a batch from the port's
             collator (8 demos and the query, COCO-sized images at native
             resolution, Kimi's chat format): one warm-up step, then 3 counted
             steps in which the attention launches are counted by head widths and
             every MoE block runs under set_sync_debug_mode("error"): each of the
             27 decoder layers takes the (192, 128) forward in both passes and the
             backward pair in layers 1-26, and no decoder call leaves "flash".
             The kernels line's *_192_128 entries hold the kernels' errors and
             times and the step's launches.

Every phase prints its seconds ("[time]").

Every kernel's entry in the next-to-last line carries its time, its plain
version's, the least time the card could take (bound_ms, bound_by) and the time
of the one PyTorch call that computes the same function where there is one
(library_ms: timed here, never used by the port).
The build fails the run where ptxas serializes a wgmma (a "Performance Loss" line)
in w8a8_matmul.cu, prompt_attn_int8.cu or quantize_rows.cu, or in the head-dim-64
and head-dim-80 instantiations of the bf16 attention forward (attn_mma.cuh).
The next-to-last line is {"kernels": [...]}, the last {"ok": true, "device": ...}.
Without a CUDA card the script exits non-zero and prints no result.

    python3 chip_smoke.py --eval-only   # phase 11 alone, while working on it: exit 3, no result line
    python3 chip_smoke.py --norms-only  # build and phase 2's row-norm kernel: exit 3, no result line
    python3 chip_smoke.py --idefics1-only  # build, phase 2's head-dim-80 cases, the CLIP rows'
                                           # device times and phase 14: exit 3, no result line
    python3 chip_smoke.py --llava-only     # build, phase 2's head-dim-64 cases, the CLIP rows'
                                           # device times, phase 6's G 7 case and phase 15:
                                           # exit 3, no result line
    python3 chip_smoke.py --cache-only  # build, the 8B runner and phase 12: exit 3, no result line
    python3 chip_smoke.py --peft-only   # build, the 8B runner and phase 13: exit 3, no result line
    python3 chip_smoke.py --serve-only  # build, the 8B runner and phase 16: exit 3, no result line
    python3 chip_smoke.py --parallel-only  # build, the 8B runner and phase 17: exit 3, no result line
    python3 chip_smoke.py --headsplit-only  # build and phase 18: exit 3, no result line
    python3 chip_smoke.py --model-axis-only  # build and phase 19: exit 3, no result line
    python3 chip_smoke.py --mla-only         # build, phase 20 and the HGMMA opcodes of the
                                             # latent-attention kernels' SASS: exit 3, no result line
    python3 chip_smoke.py --attention-only   # build + phase 2's forward kernels, then the tensor-core
                                             # and TMA opcodes in the SASS of all 10 instantiations
                                             # (head dims 64, 72, 80, 128 and 192 / 128, with and
                                             # without lse_u):
                                             # exit 3, no result line
    python3 chip_smoke.py --int8-only        # build + phase 6 and qdot's cut-off, the K-split and
                                             # prompt_attn_int8 cluster-split sweeps, then the HMMA
                                             # opcodes of the int8 kernels' SASS: exit 3, no result line
    python3 chip_smoke.py --int8-only DIR    # the same on the kernels of the checkout in DIR (no SASS)
    python3 chip_smoke.py --backward-only    # build + phase 2's backward cases, a cluster-split sweep,
                                             # then the HGMMA opcodes of the bf16 backward kernels' SASS:
                                             # exit 3, no result line
    python3 chip_smoke.py --backward-only DIR  # the backward cases on the kernels of the checkout in DIR
    python3 chip_smoke.py --w8a8-only [DIR]  # build + phase 9 and W8A8_MIN_M's cut-off (on DIR's
                                             # kernels), then the IGMMA opcodes of w8a8_matmul's
                                             # SASS (this tree only): exit 3, no result line
"""

from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

MAX_NEW_TOKENS = 10
NUM_BEAMS = 3
# bf16 tolerances of a kernel against its plain version (same bf16 inputs):
# out may differ by a rounding step of the bf16 output (|out| < 4); lse and
# lse_u are fp32 from identical inputs, differing in summation order only
TOL_OUT_BF16 = 3e-2
TOL_LSE_BF16 = 2e-3
# |out| depends on the shape: over thousands of attendable keys the ViT's rows
# average v down to |out| < 0.2, where 3e-2 is as large as a value.  So the
# forward kernels' out is held to its own reference: the largest error to one
# rounding step of a bf16 number at the largest |reference| (2^-7 of it) plus
# OUT_BF16_ABS; every row's largest error to two such steps at that row's own
# largest |reference|; and the rms error to OUT_BF16_REL_RMS of the reference's
# rms (a bf16 rounding is 2^-9 / sqrt(3) of a value in rms; a lost key tile, two
# v rows exchanged or a missed rescale of the accumulator move every element of
# a row).  Measured on an NVIDIA H100 80GB HBM3 over phase 2's shapes: one step
# at the most in any row, rms 0.9e-3 to 2.4e-3.
OUT_BF16_STEP = 2.0 ** -7
OUT_BF16_ABS = 1e-4
OUT_BF16_ROW_STEPS = 2
OUT_BF16_REL_RMS = 2.0 ** -7
TOL_TINY_FP32 = 1e-4
MIN_LOGIT_COSINE = 0.99
# "int8-w8a8" against the same weights dequantized: every text prefill matmul
# also rounds its input rows to 127 steps of their peak.  The down projection's
# rows (silu(g) * u, heavy-tailed) have a peak far above their rms, so their
# rounding noise is several times the weights'; phase 11 prints each product's
# error beside what its rows' peak / rms predicts, and holds the kernel path
# to the plain W8A8 functions bit for bit, so none of the difference is the
# kernel's.  Measured 0.982 on random weights (NVIDIA H100 80GB HBM3).
MIN_W8A8_COSINE = 0.97
# backward kernels against their plain version (same bf16 inputs, same saved
# forward): dq/dk/dv are fp32 sums rounded once to bf16 (2^-8 = 3.9e-3 of the
# value) and summed in another order; error relative to max |reference|
TOL_BWD_BF16 = 1e-2
MIN_GRAD_COSINE = 0.99
TRAIN_STEPS = 3
# int8 kernels against their plain versions (same bf16 inputs): matmul, MLP,
# and prompt-attention o and l within 1e-2 of max |reference| (one bf16
# rounding of an fp32 sum, plus the MLP's bf16 intermediate and the rounded
# p·vscale); the prompt attention's m (fp32 from identical scores) 1e-3 absolute
TOL_INT8_REL = 1e-2
TOL_INT8_M = 1e-3

KERNEL_META = {
    "flash_fwd": {
        "route": "cuda",
        "source": "mimic_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "mimic_tpu/ops/flash_attention.py:52",
    },
    "onepass_fwd": {
        "route": "cuda",
        "source": "mimic_tpu_torch/ops/csrc/onepass_fwd.cu",
        "replaces": "mimic_tpu/ops/flash_attention.py:316",
    },
    "flash_bwd_dq": {
        "route": "cuda",
        "source": "mimic_tpu_torch/ops/csrc/flash_bwd.cu",
        "replaces": "mimic_tpu/ops/flash_backward.py:70",
    },
    "flash_bwd_dkv": {
        "route": "cuda",
        "source": "mimic_tpu_torch/ops/csrc/flash_bwd.cu",
        "replaces": "mimic_tpu/ops/flash_backward.py:109",
    },
    # one kernel for both Pallas matmuls: a stacked layer is a pointer offset
    "int8_matmul": {
        "route": "cuda",
        "source": "mimic_tpu_torch/ops/csrc/int8_matmul.cu",
        "replaces": "mimic_tpu/ops/quant.py:232",
        "also_replaces": ["mimic_tpu/ops/quant.py:299"],
    },
    "fused_mlp_int8": {
        "route": "cuda",
        "source": "mimic_tpu_torch/ops/csrc/fused_mlp_int8.cu",
        "replaces": "mimic_tpu/ops/quant.py:511",
    },
    "prompt_attn_int8": {
        "route": "cuda",
        "source": "mimic_tpu_torch/ops/csrc/prompt_attn_int8.cu",
        "replaces": "mimic_tpu/ops/decode_attention.py:87",
    },
    # one kernel for both Pallas W8A8 matmuls, again by a pointer offset
    "w8a8_matmul": {
        "route": "cuda",
        "source": "mimic_tpu_torch/ops/csrc/w8a8_matmul.cu",
        "replaces": "mimic_tpu/ops/quant.py:382",
        "also_replaces": ["mimic_tpu/ops/quant.py:403"],
    },
    # not a Pallas kernel: the port's form of the fused XLA pass that feeds w8a8_matmul
    "quantize_rows": {
        "route": "cuda",
        "source": "mimic_tpu_torch/ops/csrc/quantize_rows.cu",
        "replaces": "mimic_tpu/ops/quant.py:370",
    },
}
# the kernels line: KERNEL_META's kernels, whose launches ``_counts()`` reports on
# every path, and the row-norm kernel, counted on phase 4's serving path alone.  Not
# a Pallas kernel: the port's form of the XLA fusions of both norms (the vision
# towers' and connectors' calls)
RESULT_META = {**KERNEL_META, "row_norm": {
    "route": "cuda",
    "source": "mimic_tpu_torch/ops/csrc/row_norm.cu",
    "replaces": "mimic_tpu/models/layers.py:28",
    "also_replaces": ["mimic_tpu/models/layers.py:20"],
}}
# and the attention kernels' latent-attention instantiations (q / k heads 192 wide,
# v heads 128: Kimi-VL's), counted on phase 20's Kimi-VL step alone: the same
# entry points and sources as the kernels they are named after, at other widths
MLA_RESULT = tuple(f"{name}_192_128" for name in
                   ("flash_fwd", "onepass_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
RESULT_META.update({name: {**KERNEL_META[name[:-len("_192_128")]], "head_widths": [192, 128]}
                    for name in MLA_RESULT})

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense, at 700 W): device
# memory bytes/s and tensor-core operations/s by input type.
PEAK_BYTES = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def kv_nbytes(k, v, allowed, need_unmasked: bool, mean_of_v: bool) -> int:
    """The bytes of an attention's k [B, S, Hkv, D] and v [B, S, Hkv, Dv] that its
    function needs, each read once: every key for lse_u; else a batch's keys that
    some row may attend to (``allowed`` [B, T, S]), and all of its v where a row
    attends to none and ``mean_of_v`` (onepass_fwd: that row is the mean of v over
    every key)."""
    if need_unmasked:
        return nbytes(k, v)
    S = k.shape[1]
    keys = allowed.any(1).sum(-1)
    v_keys = torch.where(~allowed.any(-1).all(-1), S, keys) if mean_of_v else keys
    return (int(keys.sum().item()) * k[0, 0].numel() * k.element_size()
            + int(v_keys.sum().item()) * v[0, 0].numel() * v.element_size())


def bound(n_bytes: int, n_ops: int, op_type: str) -> dict:
    """The least time the card could take: every input byte read once and every
    output byte written once at the memory peak, or the operations at the
    tensor cores' peak for their type, whichever is larger."""
    by_bytes, by_ops = n_bytes / PEAK_BYTES * 1e3, n_ops / PEAK_OPS[op_type] * 1e3
    return {"bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops
            else "operations", "bytes": n_bytes, "operations": n_ops}


def bound_text(b: dict) -> str:
    return (f"bound {b['bound_ms']:.4f} ms by {b['bound_by']} ({b['bytes'] / 1e6:.1f} MB, "
            f"{b['operations'] / 1e9:.2f} G operations)")


# what a kernel's entry in the last-but-one line holds beside its error
TIMING_KEYS = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, graph: bool = False) -> float:
    """ms per call of ``fn`` by CUDA events over ``reps`` calls after a warm-up.
    ``graph``: the calls are captured once into a CUDA graph and the graph is
    timed, so the host's time per call (Python, the wrappers' checks, the
    launch) is left out: the device time of the work alone."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        g.replay()
        torch.cuda.synchronize()
        start.record()
        g.replay()
        end.record()
        torch.cuda.synchronize()
        del g
        return start.elapsed_time(end) / reps
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_inputs(seed, B, T, S, H, Hkv, D, key_mask, Dv=None):
    """q [B,T,H,D], k [B,S,Hkv,D], v [B,S,Hkv,Dv] (Dv = D unless given) and the mask."""
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    q, k, v = (
        torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev, torch.bfloat16)
        for shape in ((B, T, H, D), (B, S, Hkv, D), (B, S, Hkv, Dv or D))
    )
    return q, k, v, torch.from_numpy(key_mask).to(dev)


def check_kernel(label, name, seed, B, T, S, H, Hkv, D, key_mask, causal, need_unmasked, reps,
                 plain_reps=None, Dv=None):
    """``Dv``: v's head width where it is not D (latent attention's 192 / 128)."""
    from mimic_tpu_torch.ops import flash_attention as tfa

    Dv = Dv or D
    q, k, v, km = kernel_inputs(seed, B, T, S, H, Hkv, D, key_mask, Dv)
    got = tfa._launch(name, q, k, v, km, causal, None, need_unmasked)
    torch.cuda.synchronize()
    want = tfa.attention_plain(q, k, v, km, causal=causal, need_unmasked=need_unmasked)
    torch.cuda.synchronize()
    allowed = km[:, None, :] > 0
    if causal:
        allowed = allowed & torch.ones(T, S, dtype=torch.bool, device=q.device).tril()[None]
    valid = allowed.any(-1).expand(B, T)  # rows with an attendable key
    # onepass_fwd, and flash_fwd with need_unmasked, visit every key: all rows agree
    every_key = name == "onepass_fwd" or need_unmasked
    errs, faults = {}, []
    for field, a, b, rows in (
        ("out", got[0], want[0], None if every_key else valid),
        ("lse", got[1], want[1], valid),
        ("lse_u", got[2], want[2], None if need_unmasked else valid),
    ):
        if not torch.isfinite(a.float()).all():
            raise AssertionError(f"{label}: {field} has non-finite values")
        d = (a.float() - b.float()).abs()
        errs[field] = (d if rows is None else d[rows]).max().item()
    # out is held relative to this shape's reference, by its largest element, row
    # by row and by its rms (see OUT_BF16_STEP), and never beyond TOL_OUT_BF16
    sel = (lambda x: x.float()) if every_key else (lambda x: x.float()[valid])
    ref, diff = sel(want[0]), sel(got[0]) - sel(want[0])
    tol_out = min(TOL_OUT_BF16, OUT_BF16_STEP * ref.abs().max().item() + OUT_BF16_ABS)
    rel_rms = (diff.square().mean().sqrt() / ref.square().mean().sqrt()).item()
    # the worst row: its largest error over its largest reference element
    row_ratio = (diff.abs().amax(-1) / (ref.abs().amax(-1) + OUT_BF16_ABS)).max().item()
    for what, value, limit in (("out max abs err", errs["out"], tol_out),
                               ("out rms err / rms", rel_rms, OUT_BF16_REL_RMS),
                               ("out worst row's err / its largest", row_ratio,
                                OUT_BF16_ROW_STEPS * OUT_BF16_STEP),
                               ("lse max abs err", errs["lse"], TOL_LSE_BF16),
                               ("lse_u max abs err", errs["lse_u"], TOL_LSE_BF16)):
        if not value <= limit:
            faults.append(f"{what} {value} > {limit}")
    del want
    ms = cuda_ms(lambda: tfa._launch(name, q, k, v, km, causal, None, need_unmasked), reps)
    plain_ms = cuda_ms(
        lambda: tfa.attention_plain(q, k, v, km, causal=causal, need_unmasked=need_unmasked),
        plain_reps or reps,
    )
    # work these inputs need: scores (width D) on every (query, key) pair when
    # lse_u is wanted, else on the attendable pairs; p @ v (width Dv) on the
    # attendable pairs
    pairs = int(allowed.expand(B, T, S).sum().item())
    b = bound(nbytes(q, km, got[0], got[1], got[2] if need_unmasked else None)
              + kv_nbytes(k, v, allowed.expand(B, T, S), need_unmasked, name == "onepass_fwd"),
              2 * H * (D * (B * T * S if need_unmasked else pairs) + Dv * pairs), "bf16")
    # one PyTorch call gives the same out only without lse_u (it returns no lse)
    library_ms = None
    if not need_unmasked:
        mask = (km > 0)[:, None, None, :]
        if causal:
            mask = mask & torch.ones(T, S, dtype=torch.bool, device=q.device).tril()
        try:
            library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask, enable_gqa=H != Hkv), reps)
        except RuntimeError as e:  # no backend of this torch takes these inputs
            log(f"[kernels] {label}: scaled_dot_product_attention refused the inputs: {e}")
        del mask
    widths = f"D{D}" if Dv == D else f"D{D}/{Dv}"
    log(f"[kernels] {label}: {name} B{B} T{T} S{S} H{H}/{Hkv} {widths} causal={causal} "
        f"need_unmasked={need_unmasked}: max abs err out {errs['out']:.3e} (tol {tol_out:.3e}), "
        f"out rms err / rms {rel_rms:.3e} (tol {OUT_BF16_REL_RMS:.3e}), worst row's err / its "
        f"largest {row_ratio:.3e} (tol {OUT_BF16_ROW_STEPS * OUT_BF16_STEP:.3e}), lse {errs['lse']:.3e} lse_u {errs['lse_u']:.3e} "
        f"(tol {TOL_LSE_BF16}); kernel {ms:.3f} ms "
        f"({b['operations'] / ms / 1e9:.1f} TFLOP/s of the operations counted), "
        f"plain {plain_ms:.3f} ms, {bound_text(b)}, scaled_dot_product_attention "
        f"{'none (no call returns lse_u)' if library_ms is None else f'{library_ms:.3f} ms'}")
    if faults:
        raise AssertionError(f"{label}: " + "; ".join(faults))
    return {"name": name, "max_abs_err": errs["out"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"], "library_ms": library_ms}


def left_padded_mask(B, S, pads):
    km = np.ones((B, S), np.int32)
    for b, p in enumerate(pads):
        km[b, :p] = 0
    return km


def tile_mask(B, S, zero_spans):
    """All ones but keys [a, b) of every row: whole key tiles without an attendable key."""
    km = np.ones((B, S), np.int32)
    for a, b in zero_spans:
        km[:, a:b] = 0
    return km


def phase_kernels():
    # ViT rows of a 980 px image at a 980×742 aspect: a 70×53 valid patch grid
    # (interior zeros at every row end) inside 70×70 = 4900 patches, padded to 4992
    grid = np.zeros((70, 70), np.int32)
    grid[:, :53] = 1
    vit_mask = np.zeros((1, 4992), np.int32)
    vit_mask[0, :4900] = grid.reshape(-1)
    lp = left_padded_mask
    # (label, kernel, seed, B, T, S, H, Hkv, D, key mask, causal, need_unmasked, reps,
    #  plain reps, the kernel's main-path shape)
    cases = [
        ("vit", "onepass_fwd", 0, 1, 4992, 4992, 16, 16, 72, vit_mask, False, False, 10, 3, True),
        # the ViT at the batch call A gives it
        ("vit-B4", "onepass_fwd", 5, 4, 4992, 4992, 16, 16, 72, np.repeat(vit_mask, 4, 0),
         False, False, 5, 1, False),
        ("prefill-512", "onepass_fwd", 1, 4, 512, 512, 32, 8, 128, lp(4, 512, [0, 37, 120, 300]),
         True, True, 20, 5, False),
        # the train step's record pass
        ("record-2048", "onepass_fwd", 6, 2, 2048, 2048, 32, 8, 128, lp(2, 2048, [0, 300]),
         True, True, 10, 2, False),
        ("prefill-4096", "flash_fwd", 2, 1, 4096, 4096, 32, 8, 128, lp(1, 4096, [250]),
         True, True, 10, 2, True),
        # call B's own batch
        ("prefill-4096-B2", "flash_fwd", 7, 2, 4096, 4096, 32, 8, 128, lp(2, 4096, [0, 250]),
         True, True, 5, 1, False),
        ("ragged-1000", "flash_fwd", 3, 2, 1000, 1000, 32, 8, 128, lp(2, 1000, [0, 77]),
         True, True, 20, 5, False),
        ("ragged-1000-vit", "flash_fwd", 4, 2, 1000, 1000, 16, 16, 72,
         lp(2, 1000, [0, 0]) * (np.arange(1000) < 930), False, False, 20, 5, False),
        # head dim 72 under the causal mask, with and without lse_u
        ("causal-d72", "onepass_fwd", 14, 2, 1000, 1000, 16, 16, 72, lp(2, 1000, [0, 77]),
         True, False, 10, 3, False),
        ("causal-d72-lse_u", "flash_fwd", 15, 2, 1000, 1000, 16, 16, 72, lp(2, 1000, [0, 150]),
         True, True, 10, 3, False),
        # whole key tiles without an attendable key: the first ones, and interior ones
        ("first-tiles-masked", "flash_fwd", 8, 2, 1024, 1024, 32, 8, 128, lp(2, 1024, [200, 517]),
         True, True, 10, 3, False),
        ("interior-tiles-masked", "onepass_fwd", 9, 2, 1024, 1024, 16, 16, 72,
         tile_mask(2, 1024, [(128, 330), (700, 900)]), False, False, 10, 3, False),
        ("interior-tiles-masked-skip", "flash_fwd", 10, 2, 1000, 1000, 32, 8, 128,
         tile_mask(2, 1000, [(128, 330), (700, 900)]), True, False, 10, 3, False),
        ("interior-tiles-masked-lse_u", "flash_fwd", 11, 2, 1000, 1000, 32, 8, 128,
         tile_mask(2, 1000, [(0, 70), (128, 330), (700, 900)]), True, True, 10, 3, False),
        # T != S
        ("t512-s640", "onepass_fwd", 12, 2, 512, 640, 16, 16, 72, tile_mask(2, 640, [(600, 640)]),
         False, False, 10, 3, False),
        ("t512-s640-lse_u", "flash_fwd", 13, 2, 512, 640, 32, 8, 128, lp(2, 640, [0, 90]),
         False, True, 10, 3, False),
        # each kernel at the other's main shape (the dispatch rule sends prefill-512 to
        # onepass_fwd and 4096 to flash_fwd: the cut-offs were decided on the TPU)
        ("prefill-512 by flash_fwd", "flash_fwd", 1, 4, 512, 512, 32, 8, 128,
         lp(4, 512, [0, 37, 120, 300]), True, True, 20, 5, False),
        ("prefill-4096 by onepass_fwd", "onepass_fwd", 2, 1, 4096, 4096, 32, 8, 128,
         lp(1, 4096, [250]), True, True, 10, 2, False),
        ("vit by flash_fwd", "flash_fwd", 0, 1, 4992, 4992, 16, 16, 72, vit_mask,
         False, False, 10, 3, False),
        CLIP_VIT_CASE,
        *D64_CASES,
    ]
    # per kernel: the worst error over its shapes, the times at its main-path shape
    summary = {}
    for *args, main_shape in cases:
        r = check_kernel(*args)
        s = summary.setdefault(r["name"], {"max_abs_err": 0.0})
        s["max_abs_err"] = max(s["max_abs_err"], r["max_abs_err"])
        if main_shape:
            s.update({k: r[k] for k in TIMING_KEYS})
    for case in CLIP_FP32_CASES + D64_FP32_CASES:
        check_kernel_fp32(*case)
    clip_device_times()
    return summary


def clip_device_times():
    """The CLIP towers' rows (idefics-9b's at head dim 80, llava-1.5's at 64) as
    device time through CUDA graphs, in turns: onepass_fwd through its wrapper, as
    the towers call it, and scaled_dot_product_attention on the same inputs, with
    the bound beside them."""
    from mimic_tpu_torch.ops import flash_attention as tfa

    for label, name, seed, B, T, S, H, Hkv, D, key_mask, *_ in (CLIP_VIT_CASE,
                                                                CLIP_L_VIT_CASE_ARGS):
        q, k, v, km = kernel_inputs(seed, B, T, S, H, Hkv, D, key_mask)
        mask = (km > 0)[:, None, None, :]
        runs = {
            name: lambda: tfa._launch(name, q, k, v, km, False, None, False),
            "scaled_dot_product_attention": lambda: torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask),
        }
        times = {run: [] for run in runs}
        for run in (*runs, *reversed(runs)) * 2:
            times[run].append(cuda_ms(runs[run], 50, graph=True))
        # as check_kernel counts it: k and v of the attendable keys, both products
        # on the attendable pairs
        got = runs[name]()
        allowed = mask[:, 0].expand(B, T, S)
        b = bound(nbytes(q, km, got[0], got[1]) + kv_nbytes(k, v, allowed, False, True),
                  2 * H * D * 2 * int(allowed.sum().item()), "bf16")
        kernel_min = min(times[name])
        log(f"[kernels] {label} as device time through CUDA graphs (B{B} T{T} S{S} H{H} D{D}, "
            f"{int(km[0].sum().item())} keys), in turns: " + "; ".join(
                f"{run} {', '.join(f'{t:.4f}' for t in ts)} ms" for run, ts in times.items())
            + f"; {bound_text(b)}: the kernel at {b['bound_ms'] / kernel_min:.1%} of it, "
            f"SDPA / kernel {min(times['scaled_dot_product_attention']) / kernel_min:.2f}")


def clip_vit_mask(B):
    """The idefics-9b CLIP tower's key mask: the class token and 16 x 16
    patches of a 224 px image (257 keys), padded to 384."""
    km = np.zeros((B, 384), np.int32)
    km[:, :257] = 1
    return km


# the idefics-9b ViT's attention (CLIP ViT-H/14, head dim 80) at phase 14's ICL
# batch: 4 requests x 17 images, 16 heads, 384 slots with 257 real keys
CLIP_VIT_CASE = ("clip-vit-d80", "onepass_fwd", 16, 68, 384, 384, 16, 16, 80, clip_vit_mask(68),
                 False, False, 10, 3, False)
# fp32 at D80, each entry point (the scalar kernels): (label, kernel, seed, B, T, S, H, Hkv,
# D, key mask, causal, need_unmasked)
CLIP_FP32_CASES = [
    ("clip-vit-d80-fp32", "onepass_fwd", 17, 68, 384, 384, 16, 16, 80, clip_vit_mask(68),
     False, False),
    ("clip-vit-d80-fp32 by flash_fwd", "flash_fwd", 18, 8, 384, 384, 16, 16, 80,
     clip_vit_mask(8), False, True),
]


def clip_l_vit_mask(B):
    """The llava-1.5 CLIP ViT-L/14-336 tower's key mask: the class token and
    24 x 24 patches of a 336 px image (577 keys), padded to 640."""
    km = np.zeros((B, 640), np.int32)
    km[:, :577] = 1
    return km


# the attention forward at head dim 64 (one 64-column block, no tail): the llava-1.5
# ViT's rows at phase 15's call (4 requests x 1 image, 16 heads, 640 slots, 577
# keys); a wholly masked first key tile under both entry points; causal with lse_u
CLIP_L_VIT_CASE_ARGS = ("clip-l-vit-d64", "onepass_fwd", 19, 4, 640, 640, 16, 16, 64,
                        clip_l_vit_mask(4))
D64_CASES = [
    (*CLIP_L_VIT_CASE_ARGS, False, False, 20, 5, False),
    ("first-tile-masked-d64", "onepass_fwd", 20, 2, 640, 640, 16, 16, 64,
     left_padded_mask(2, 640, [100, 70]), False, False, 10, 3, False),
    ("first-tile-masked-d64 by flash_fwd", "flash_fwd", 21, 2, 640, 640, 16, 16, 64,
     left_padded_mask(2, 640, [100, 70]), False, False, 10, 3, False),
    ("causal-d64-lse_u", "flash_fwd", 22, 2, 1000, 1000, 16, 16, 64,
     left_padded_mask(2, 1000, [0, 150]), True, True, 10, 3, False),
]
D64_FP32_CASES = [
    ("clip-l-vit-d64-fp32", "onepass_fwd", 23, 4, 640, 640, 16, 16, 64, clip_l_vit_mask(4),
     False, False),
    ("clip-l-vit-d64-fp32 by flash_fwd", "flash_fwd", 24, 4, 640, 640, 16, 16, 64,
     clip_l_vit_mask(4), False, True),
]
# fp32 kernels against the plain version: summation order only
TOL_OUT_FP32, TOL_LSE_FP32 = 2e-5, 1e-5


def check_kernel_fp32(label, name, seed, B, T, S, H, Hkv, D, key_mask, causal, need_unmasked):
    """A forward kernel's fp32 instantiation against the plain version on the
    same inputs: out on every row it must agree on, lse and lse_u."""
    from mimic_tpu_torch.ops import flash_attention as tfa

    q, k, v, km = (x.float() if x.is_floating_point() else x
                   for x in kernel_inputs(seed, B, T, S, H, Hkv, D, key_mask))
    got = tfa._launch(name, q, k, v, km, causal, None, need_unmasked)
    want = tfa.attention_plain(q, k, v, km, causal=causal, need_unmasked=need_unmasked)
    torch.cuda.synchronize()
    valid = (km[:, None, :] > 0).any(-1).expand(B, T)
    every_key = name == "onepass_fwd" or need_unmasked
    errs = {}
    for field, a, b, rows, tol in (
            ("out", got[0], want[0], None if every_key else valid, TOL_OUT_FP32),
            ("lse", got[1], want[1], valid, TOL_LSE_FP32),
            ("lse_u", got[2], want[2], None if need_unmasked else valid, TOL_LSE_FP32)):
        if not torch.isfinite(a).all():
            raise AssertionError(f"{label}: {field} has non-finite values")
        d = (a - b).abs()
        errs[field] = (d if rows is None else d[rows]).max().item()
        if errs[field] > tol:
            raise AssertionError(f"{label}: {field} max abs err {errs[field]} > {tol}")
    log(f"[kernels] {label}: {name} fp32 B{B} T{T} S{S} H{H}/{Hkv} D{D} causal={causal} "
        f"need_unmasked={need_unmasked}: max abs err out {errs['out']:.3e} (tol {TOL_OUT_FP32}), "
        f"lse {errs['lse']:.3e} lse_u {errs['lse_u']:.3e} (tol {TOL_LSE_FP32})")


def sass_counts(library: str, kernels, ops, instantiations: int) -> None:
    """Opcodes ``ops`` counted in each instantiation of the kernels whose name
    holds one of ``kernels``, from ``cuobjdump -sass``; each must occur."""
    from mimic_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", library], capture_output=True, text=True,
                          check=True, timeout=600).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif fn is not None and any(k in fn for k in kernels):
            c = counts.setdefault(fn, dict.fromkeys(ops, 0))
            for op in c:
                c[op] += f" {op}" in line
    if len(counts) != instantiations:
        raise AssertionError(f"expected {instantiations} instantiations of {kernels}: {list(counts)}")
    for fn, c in sorted(counts.items()):
        log(f"[sass] {fn}: " + ", ".join(f"{op} {n}" for op, n in c.items()))
        if min(c.values()) == 0:
            raise AssertionError(f"{fn}: an opcode of {ops} is missing from its SASS")


def ptxas_lines(info: dict, kernels, strict_sources=(), strict_kernels=()) -> None:
    """What ``-Xptxas=-v`` said of the registers, spills and shared memory of
    the kernels whose mangled name holds one of ``kernels``; a "Performance
    Loss" line (wgmma serialized) in the output of one of ``strict_sources``,
    or one that names a kernel whose mangled name holds one of
    ``strict_kernels``, fails the run."""
    lines = info["ptxas"].splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and any(k in line for k in kernels):
            log("[build] " + " | ".join(x.replace("ptxas info    :", "").strip()
                                        for x in lines[i:i + 4]))
        if "Performance Loss" in line:  # e.g. wgmma serialized for want of registers
            log("[build] " + line)
    for src in strict_sources:
        bad = [x for x in info.get("ptxas_by_source", {}).get(src, "").splitlines()
               if "Performance Loss" in x]
        if bad:
            raise AssertionError(f"ptxas serializes in {src}: {bad}")
    bad = [x for x in lines if "Performance Loss" in x and any(k in x for k in strict_kernels)]
    if bad:
        raise AssertionError(f"ptxas serializes {strict_kernels}: {bad}")


# the idefics2-8b train step's norm rows (PERF.md §4): the SigLIP tower's LayerNorms
# over 20 images x 4992 padded patches x 1152, the connector's RMSNorms of the
# context (20 x 4900 x 4096) and of the latents (20 x 64 x 4096)
NORM_SHAPES = (("layer_norm", 99840, 1152), ("rms_norm", 98000, 4096), ("rms_norm", 1280, 4096))
NORM_REPS = 20


def bf16_ulps(got, want):
    """|got - want| in units of bf16's spacing at max(|want|, 2^-10) (as
    tests/test_torch_kernels.py::_bf16_ulps)."""
    g, w = got.float(), want.float()
    return (g - w).abs() / torch.exp2(torch.floor(torch.log2(torch.clamp(w.abs(), min=2.0 ** -10))) - 7)


def phase_norm_kernels():
    """ops.norms' row-norm kernel against its plain version on the card, bf16
    rows and weights, at NORM_SHAPES: at most one ulp apart, the share of
    elements bit-equal; device times through CUDA graphs of the kernel, the
    plain version and F.layer_norm / F.rms_norm (the yardstick, never called by
    the port), beside the bound of the bytes (rows read once and written once,
    w and b once).  The entry of the kernels line is the SigLIP shape's."""
    import torch.nn.functional as F

    from mimic_tpu_torch.ops import norms as tn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23)
    rows, eps = [], 1e-6
    for norm, M, D in NORM_SHAPES:
        x = (torch.randn(M, D, generator=gen, device=dev) * 3 + 0.5).to(torch.bfloat16)
        w = (1 + 0.1 * torch.randn(D, generator=gen, device=dev)).to(torch.bfloat16)
        b = (0.1 * torch.randn(D, generator=gen, device=dev)).to(torch.bfloat16)
        if norm == "layer_norm":
            kernel = lambda: tn.layer_norm(x, w, b, eps)  # noqa: E731
            plain = lambda: tn.layer_norm_plain(x, w, b, eps)  # noqa: E731
            library = lambda: F.layer_norm(x, (D,), w, b, eps)  # noqa: E731
        else:
            kernel = lambda: tn.rms_norm(x, w, eps)  # noqa: E731
            plain = lambda: tn.rms_norm_plain(x, w, eps)  # noqa: E731
            library = (lambda: F.rms_norm(x, (D,), w, eps)) if hasattr(F, "rms_norm") else None
        before = tn.LAUNCHES[norm]
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        if tn.LAUNCHES[norm] != before + 1:
            raise AssertionError(f"{norm}: {tn.LAUNCHES[norm] - before} launches, want 1")
        ulps = bf16_ulps(got, want).max().item()
        equal = (got == want).float().mean().item()
        err = (got.float() - want.float()).abs().max().item()
        if not ulps <= 1:
            raise AssertionError(f"{norm} [{M}, {D}]: {ulps} bf16 ulps from the plain version")
        del got, want
        ms = cuda_ms(kernel, NORM_REPS, True)
        plain_ms = cuda_ms(plain, NORM_REPS, True)
        library_ms = None if library is None else cuda_ms(library, NORM_REPS, True)
        bnd = bound(2 * nbytes(x) + nbytes(w) + (nbytes(b) if norm == "layer_norm" else 0), 0,
                    "bf16")
        lanes, vectors = tn.kernel_plan(D, x.dtype)
        yardstick = (f"F.{norm} {library_ms:.4f} ms" if library is not None
                     else f"no F.rms_norm in torch {torch.__version__}")
        log(f"[norms] {norm} [{M}, {D}] bf16 ({lanes} lanes a row, {vectors} x 16 B a lane): "
            f"kernel {ms:.4f} ms ({bnd['bound_ms'] / ms:.1%} of the bound), plain {plain_ms:.4f} "
            f"ms, {yardstick}; {bound_text(bnd)}; max {ulps:.0f} ulp ({err:.3g} abs), "
            f"{equal:.4%} of the elements bit-equal (device time through CUDA graphs)")
        rows.append({"norm": norm, "M": M, "D": D, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": library_ms, "bound_ms": bnd["bound_ms"], "max_abs_err": err,
                     "bit_equal": equal})
        del x
        torch.cuda.empty_cache()
    first = rows[0]
    return {"row_norm": {"max_abs_err": max(r["max_abs_err"] for r in rows), "ms": first["ms"],
                         "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
                         "bound_by": "bytes", "library_ms": first["library_ms"], "shapes": rows}}


def backward_launcher(args, name, split=None):
    """A function that launches backward kernel ``name`` straight through the
    library on the inputs the wrapper would give it, and nothing else: the
    kernel's own device time, without the wrapper's Δ and mask preparation.
    ``split``: the bf16 dkv kernel's cluster split (a library without
    ``mimic_flash_bwd_tiling`` predates it and takes none)."""
    from mimic_tpu_torch.ops import _build
    from mimic_tpu_torch.ops.flash_attention import _KERNEL_DTYPES

    q, k, v, km, out, lse, lse_u, g_out, g_lse, g_lse_u, causal, _, need_unmasked = args
    B, T, H, D = q.shape
    S, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    lib = _build.load_library()
    delta = (g_out.float() * out.float()).sum(-1).contiguous()
    g_lse_u = g_lse_u if need_unmasked else torch.zeros_like(g_lse)
    inputs = (q, k, v, g_out, (km != 0).to(torch.int32), lse, lse_u, delta, g_lse, g_lse_u)
    outs = (torch.empty_like(q),) if name == "flash_bwd_dq" else (torch.empty_like(k),
                                                                  torch.empty_like(v))
    extra = ()
    if name == "flash_bwd_dkv" and hasattr(lib, "mimic_flash_bwd_tiling"):
        from mimic_tpu_torch.ops import flash_backward as tfb
        from mimic_tpu_torch.ops.quant import _sm_count

        extra = (split or tfb.dkv_split(B, T, S, H, Hkv, _sm_count(q.device.index)),)
    ptrs = [x.data_ptr() for x in (*inputs, *outs)]
    fn = getattr(lib, f"mimic_{name}")
    # an entry point that takes D_v has eleven scalars between its pointers and
    # the split or stream; a library that predates it (one head width) ten
    takes_dv = len(fn.argtypes) - len(ptrs) - len(extra) - 1 == 11
    if not takes_dv and Dv != D:
        raise ValueError(f"{name}: this library takes one head width, not {(D, Dv)}")
    shape = (B, T, S, H, Hkv, D, *((Dv,) if takes_dv else ()), _KERNEL_DTYPES[q.dtype],
             1.0 / D**0.5, int(causal), int(need_unmasked))

    # on the current stream (a graph's capture runs on a stream of its own); the
    # default argument keeps the tensors made here alive while the closure lives
    def launch(_inputs=inputs):
        err = fn(*ptrs, *shape, *extra, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err} ({lib.mimic_cuda_error_string(err).decode()})")
        return outs
    return launch


def device_ms(fn, reps: int) -> float:
    """Device time per call of ``fn``: the durations of the kernels it
    launches over ``reps`` calls under torch.profiler, after a warm-up (the
    host's time between them left out, as a CUDA graph would)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")) / reps / 1e3


def sdpa_backward_ms(q, k, v, reps):
    """The backward of torch's scaled_dot_product_attention (causal, no key mask)
    on the same q, k, v, as the device time of forward + backward less the
    forward's: a yardstick of what a library attention backward costs at this
    shape.  It is not this function (no lse or lse_u cotangent, no key mask),
    so the result line's library_ms stays null."""
    H, Hkv = q.shape[2], k.shape[2]
    leaves = [x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v)]
    g = torch.randn_like(leaves[0])

    def fwd():
        return torch.nn.functional.scaled_dot_product_attention(
            *leaves, is_causal=True, enable_gqa=H != Hkv)

    def fwd_bwd():
        torch.autograd.grad(fwd(), leaves, g)

    with torch.no_grad():
        fwd_ms = device_ms(fwd, reps)
    return device_ms(fwd_bwd, reps) - fwd_ms, fwd_ms


def backward_bounds(args) -> dict:
    """Each backward kernel's bound on the wrapper's arguments ``args``: the
    work these inputs need.  With lse_u the scores and ds cover every (query,
    key) pair, else the attendable pairs; dp = dO vT (and dv = pT dO) the
    attendable pairs.  dq: scores, dp, ds k; dk/dv: scores, dp, dv, dsT q."""
    q, k, v, km, out, lse, lse_u, g_out, g_lse, g_lse_u, causal, _, need_unmasked = args
    B, T, H, D = q.shape
    S, Dv = k.shape[1], v.shape[-1]
    allowed = (km[:, None, :] > 0).expand(B, T, S)
    if causal:
        allowed = allowed & torch.ones(T, S, dtype=torch.bool, device=q.device).tril()[None]
    pairs = int(allowed.sum().item())
    wide = B * T * S if need_unmasked else pairs
    delta = torch.empty(B, T, H, device=q.device)  # fp32 [B,T,H], made by the wrapper
    read = nbytes(q, k, v, g_out, km, lse, lse_u if need_unmasked else None, delta, g_lse,
                  g_lse_u if need_unmasked else None)
    # scores and ds at the q / k width D, dp (and dv) at v's width Dv
    return {"flash_bwd_dq": bound(read + nbytes(q), 2 * H * (2 * D * wide + Dv * pairs),
                                  "bf16"),
            "flash_bwd_dkv": bound(read + nbytes(k, v), 2 * H * (2 * D * wide + 2 * Dv * pairs),
                                   "bf16")}


def check_backward(label, seed, B, T, S, H, Hkv, key_mask, causal, need_unmasked, reps,
                   sdpa=False, D=128, Dv=128):
    """Both backward kernels against the plain backward on the same bf16
    inputs and the same saved forward (from the plain forward); a second
    launch must give the same bits.  Times: each kernel alone, device time
    through a CUDA graph of launches straight through the library.  ``D`` /
    ``Dv``: the q / k and v head widths."""
    from mimic_tpu_torch.ops import flash_attention as tfa
    from mimic_tpu_torch.ops import flash_backward as tfb

    q, k, v, km = kernel_inputs(seed, B, T, S, H, Hkv, D, key_mask, Dv)
    out, lse, lse_u = tfa.attention_plain(q, k, v, km, causal=causal, need_unmasked=need_unmasked)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g_out = torch.randn(out.shape, generator=gen, device="cuda").to(torch.bfloat16)
    g_lse, g_lse_u = (torch.randn(B, T, H, generator=gen, device="cuda") for _ in range(2))
    args = (q, k, v, km, out, lse, lse_u, g_out, g_lse, g_lse_u, causal, None, need_unmasked)
    got = tfb._launch_backward(*args)
    again = tfb._launch_backward(*args)
    torch.cuda.synchronize()
    for field, a, b in zip(("dq", "dk", "dv"), got, again):
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: two launches gave different {field}")
    want = tfb.flash_attention_backward_plain(*args)
    torch.cuda.synchronize()
    errs = {}
    for field, a, b in zip(("dq", "dk", "dv"), got, want):
        if not torch.isfinite(a.float()).all():
            raise AssertionError(f"{label}: {field} has non-finite values")
        ref = b.float().abs().max().item()
        errs[field] = (a.float() - b.float()).abs().max().item() / ref
        if errs[field] > TOL_BWD_BF16:
            raise AssertionError(f"{label}: {field} max err {errs[field]:.3e} of max |ref| "
                                 f"{ref:.3e} > {TOL_BWD_BF16}")
    bounds = backward_bounds(args)
    del got, again, want
    ms = {name: cuda_ms(backward_launcher(args, name), reps, graph=True) for name in tfb.KERNELS}
    wrapper_ms = cuda_ms(lambda: tfb._launch_backward(*args), reps, graph=True)
    plain_ms = cuda_ms(lambda: tfb.flash_attention_backward_plain(*args), reps)
    yardstick = ""
    if sdpa:
        bwd_ms, fwd_ms = sdpa_backward_ms(q, k, v, reps)
        yardstick = (f"; yardstick: scaled_dot_product_attention backward (causal, no key "
                     f"mask, no lse cotangents; device time) {bwd_ms:.4f} ms (its forward "
                     f"{fwd_ms:.4f} ms)")
    widths = f"D{D}" if Dv == D else f"D{D}/{Dv}"
    log(f"[kernels] {label}: backward B{B} T{T} S{S} H{H}/{Hkv} {widths} causal={causal} "
        f"need_unmasked={need_unmasked}: max err / max |ref| dq {errs['dq']:.3e} "
        f"dk {errs['dk']:.3e} dv {errs['dv']:.3e} (tol {TOL_BWD_BF16}: one bf16 rounding "
        f"of an fp32 sum), second launch bit-identical; flash_bwd_dq {ms['flash_bwd_dq']:.4f} ms "
        f"({bounds['flash_bwd_dq']['bound_ms'] / ms['flash_bwd_dq']:.1%} of its bound), "
        f"flash_bwd_dkv {ms['flash_bwd_dkv']:.4f} ms "
        f"({bounds['flash_bwd_dkv']['bound_ms'] / ms['flash_bwd_dkv']:.1%}), the wrapper (Δ, "
        f"both kernels) {wrapper_ms:.4f} ms, plain backward (dq, dk, dv) {plain_ms:.3f} ms; "
        f"dq {bound_text(bounds['flash_bwd_dq'])}, dkv {bound_text(bounds['flash_bwd_dkv'])}; "
        f"no single PyTorch call gives these gradients (lse and lse_u carry gradient){yardstick}")
    return [
        {"name": name, "max_abs_err": err, "ms": ms[name], "plain_ms": plain_ms,
         "bound_ms": bounds[name]["bound_ms"], "bound_by": bounds[name]["bound_by"],
         "library_ms": None}
        for name, err in (("flash_bwd_dq", errs["dq"]),
                          ("flash_bwd_dkv", max(errs["dk"], errs["dv"])))
    ]


def phase_backward_kernels():
    """The backward pair at (a) the shift pass, (b) B1 T=S=2048 (where the JAX
    package would have taken its Pallas backward), (c) a ragged B2 T=S=1000,
    (d) without need_unmasked, (e) whole padded key tiles with need_unmasked
    (every tile visited, p = 0 on the padded ones).  Errors are relative to max
    |reference|; the times reported for the kernels are the shift pass's."""
    lp = left_padded_mask
    cases = [
        ("bwd-shift-256", 10, 2, 256, 256, 32, 8, lp(2, 256, [0, 61]), True, True, 20, True),
        ("bwd-2048", 11, 1, 2048, 2048, 32, 8, lp(1, 2048, [0]), True, True, 5, False),
        ("bwd-ragged-1000", 12, 2, 1000, 1000, 32, 8, lp(2, 1000, [0, 77]), True, True, 5, False),
        ("bwd-no-lse_u", 13, 2, 512, 512, 32, 8, lp(2, 512, [0, 100]), True, False, 5, False),
        ("bwd-padded-tiles", 14, 2, 512, 512, 32, 8, lp(2, 512, [0, 200]), True, True, 5, False),
    ]
    summary = {}
    for i, case in enumerate(cases):
        for r in check_backward(*case):
            s = summary.setdefault(r["name"], {"max_abs_err": 0.0})
            s["max_abs_err"] = max(s["max_abs_err"], r["max_abs_err"])
            if i == 0:
                s.update({k: r[k] for k in TIMING_KEYS})
    return summary


# with the latent-attention pair (mla_bwd_dq_mma_kernel, mla_bwd_dkv_mma_kernel): 4
BWD_MMA_KERNELS = ("bwd_dq_mma_kernel", "bwd_dkv_mma_kernel")


def backward_split_sweep():
    """The bf16 dkv kernel at the shift pass and at B1 T=S=2048 under every
    cluster split, launched straight through the library, so that dkv_split's
    choice (marked) can be read against the others."""
    from mimic_tpu_torch.ops import flash_attention as tfa
    from mimic_tpu_torch.ops import flash_backward as tfb
    from mimic_tpu_torch.ops.quant import _sm_count

    sms = _sm_count(torch.cuda.current_device())
    for label, B, T, pads in (("shift-256", 2, 256, [0, 61]), ("2048", 1, 2048, [0])):
        q, k, v, km = kernel_inputs(20, B, T, T, 32, 8, 128, left_padded_mask(B, T, pads))
        out, lse, lse_u = tfa.attention_plain(q, k, v, km)
        g_out = torch.randn_like(q)
        g = torch.randn(B, T, 32, device="cuda")
        args = (q, k, v, km, out, lse, lse_u, g_out, g, g, True, None, True)
        chosen = tfb.dkv_split(B, T, T, 32, 8, sms)
        ref = None
        times = []
        for split in (1, 2, 4, 8):
            launch = backward_launcher(args, "flash_bwd_dkv", split)
            got = [x.clone() for x in launch()]
            ref = ref or got
            if max((a.float() - b.float()).abs().max().item() for a, b in zip(got, ref)) > 0.02 * max(
                    b.float().abs().max().item() for b in ref):
                raise AssertionError(f"dkv split {split} disagrees with split 1")
            ms = cuda_ms(launch, 20, graph=True)
            times.append(f"{split}{'*' if split == chosen else ''} {ms:.4f}")
        log(f"[sweep] flash_bwd_dkv {label}: ms by cluster split (* dkv_split's choice): "
            + ", ".join(times))


# ---------------------------------------------------------------------------
# phase 3: tiny fp32 slice, kernels on the card against the plain path on the CPU
# ---------------------------------------------------------------------------


def tiny_cfg(tk, **text_kw):
    """tiny idefics2 with text head dim 128 (the flash path's) and a 70 px
    SigLIP with head dim 72 (the ViT's); ``text_kw`` overrides the text tower."""
    import dataclasses

    from mimic_tpu_torch.models.config import tiny_text

    cfg = tiny_text("idefics2", head_dim=128, **text_kw)
    return cfg.replace(
        text=dataclasses.replace(cfg.text, vocab_size=tk.vocab_size),
        vision=dataclasses.replace(cfg.vision, hidden_size=144, num_heads=2, image_size=70),
        image_token_id=tk.image_token_id, pad_token_id=tk.pad_token_id,
        bos_token_id=tk.bos_token_id, eos_token_id=tk.eos_token_id,
    )


def phase_tiny_reference():
    from mimic_tpu_torch.models import generate as tg
    from mimic_tpu_torch.models.lvlm import init_lvlm_params
    from mimic_tpu_torch.models.runner import LVLMRunner
    from mimic_tpu_torch.config import get_preset
    from mimic_tpu_torch.models.tokenizer import SimpleTokenizer
    from mimic_tpu_torch.ops.flash_attention import LAUNCHES, reset_launch_counts
    from mimic_tpu_torch.shift.params import init_shift_params

    tk = SimpleTokenizer(padding_side="left")
    cfg = tiny_cfg(tk)
    cpu = torch.device("cpu")
    params = init_lvlm_params(cfg, torch.Generator().manual_seed(0), cpu)
    shift = init_shift_params(get_preset("mimic")[0], cfg.text, torch.Generator().manual_seed(1), cpu)
    shift["attn_v"] = shift["attn_v"] * 300.0  # make log Z2 matter to the tokens
    rng = np.random.default_rng(5)
    # 70 px images need no resize, so the processor stays on numpy
    images = [[rng.integers(0, 255, (70, 70, 3)).astype(np.uint8)] for _ in range(2)]
    texts = ["Image:<image> Question: what is it? Answer:",
             "Image:<image> Question: and what colour is the thing on the left? Answer:"]
    runners = {}
    for dev in ("cpu", "cuda"):
        r = LVLMRunner(cfg, params, SimpleTokenizer(padding_side="left"), device=dev)
        r.set_shift(shift)
        runners[dev] = r
    reset_launch_counts()
    logits, tokens = {}, {}
    for dev, r in runners.items():
        batch = r.process_input(images, texts, pad_to=128)
        T = batch.input_ids.shape[1]
        attn_impl = "flash" if dev == "cuda" else "xla"
        logits[dev], _, _ = tg._prefill(r.params, cfg, batch, T + 6, r.shift, "unmasked",
                                        torch.float32, attn_impl)
        tokens[dev] = tg.beam_generate(
            r.params, cfg, batch, max_new_tokens=6, num_beams=NUM_BEAMS,
            eos_token_id=tk.eos_token_id, pad_token_id=tk.pad_token_id, shift=r.shift,
            logz2="unmasked", attn_impl=attn_impl,
        ).tokens.cpu()
    torch.cuda.synchronize()
    # every tiny attention row is short: only the full-row kernel serves them
    if LAUNCHES["onepass_fwd"] == 0:
        raise AssertionError(f"tiny slice on the card did not launch onepass_fwd: {LAUNCHES}")
    got, want = logits["cuda"].cpu(), logits["cpu"]
    err = (got - want).abs().max().item()
    close = torch.allclose(got, want, rtol=TOL_TINY_FP32, atol=TOL_TINY_FP32)
    same = torch.equal(tokens["cuda"], tokens["cpu"])
    log(f"[tiny] fp32 prefill last logits, kernels on the card vs plain on the CPU: "
        f"max abs err {err:.3e} of max |logit| {want.abs().max().item():.3f} "
        f"(rtol = atol = {TOL_TINY_FP32}: {close}); beam-3 tokens identical: {same}; "
        f"tokens {tokens['cuda'].tolist()}")
    if not close or not same:
        raise AssertionError("tiny slice: the kernel path disagrees with the plain path")


def phase_tiny_train():
    """3 MimIC steps through the kernels on the card against 3 through the
    plain attention path on the CPU, fp32, same parameters and batch."""
    from mimic_tpu_torch.config import get_preset
    from mimic_tpu_torch.models.lvlm import init_lvlm_params
    from mimic_tpu_torch.models.processor import LVLMProcessor
    from mimic_tpu_torch.models.tokenizer import SimpleTokenizer
    from mimic_tpu_torch.ops import flash_backward as tfb
    from mimic_tpu_torch.shift.params import init_shift_params
    from mimic_tpu_torch.train import step as ts
    from mimic_tpu_torch.train.collate import TrainCollator
    from mimic_tpu_torch.train.optim import build_optimizer

    tk = SimpleTokenizer(padding_side="right")
    cfg = tiny_cfg(tk)
    enc, peft = get_preset("mimic")
    cpu = torch.device("cpu")
    params = init_lvlm_params(cfg, torch.Generator().manual_seed(0), cpu)
    shift = init_shift_params(enc, cfg.text, torch.Generator().manual_seed(1), cpu)
    rng = np.random.default_rng(6)
    images = [[rng.integers(0, 255, (70, 70, 3)).astype(np.uint8) for _ in range(2)]
              for _ in range(2)]
    # the flash path needs 128-aligned sequences: the collator's default pads to 64
    collator = TrainCollator(LVLMProcessor(cfg, tk), enc.strategy(), pad_multiple=128)
    tb = collator({
        "prefix_texts": ["Image:<image> Question: what is this? Answer: a cat\n",
                         "Image:<image> Question: how many? Answer: two\n"],
        "query_texts": ["Image:<image> Question: what now? Answer:",
                        "Image:<image> Question: who is it? Answer:"],
        "answers": ["a dog", "three"],
        "images": images,
    })
    history, final = {}, {}
    tfb.reset_launch_counts()
    for attn_impl, dev in (("flash", "cuda"), ("xla", "cpu")):
        tree = {"shift": {k: v.to(dev) for k, v in shift.items()}}
        frozen = _to(params, dev)
        tx = build_optimizer(tree, lr=peft.lr, weight_decay=1e-3, warmup_steps=1,
                             total_steps=10, grad_clip=1.0)
        step = ts.make_train_step(cfg, enc, tx, ce_loss_weight=peft.ce_loss_weight,
                                  align_loss_weight=peft.align_loss_weight, attn_impl=attn_impl)
        state = ts.TrainState(tree, tx.init(tree), 0)
        batch = ts.to_device_batch(tb, dev)
        rows = []
        for _ in range(TRAIN_STEPS):
            state, m = step(state, frozen, batch)
            rows.append({k: float(m[k]) for k in ("loss", "ce_loss", "ffn_mse_loss", "grad_norm")})
        history[attn_impl] = rows
        final[attn_impl] = {k: v.detach().cpu() for k, v in state.trainable["shift"].items()}
    launches = dict(tfb.LAUNCHES)
    per_step = cfg.text.num_layers - 1
    if launches != {"flash_bwd_dq": per_step * TRAIN_STEPS, "flash_bwd_dkv": per_step * TRAIN_STEPS}:
        raise AssertionError(f"tiny train on the card: backward launches {launches}")
    worst = 0.0
    for got, want in zip(history["flash"], history["xla"]):
        for k in want:
            worst = max(worst, abs(got[k] - want[k]) / max(abs(want[k]), 1e-12))
    tree_err = max((final["flash"][k] - v).norm().item() / v.norm().item()
                   for k, v in final["xla"].items())
    log(f"[tiny-train] fp32, kernels on the card vs plain attention on the CPU, "
        f"{TRAIN_STEPS} steps: per-step metrics {history['flash']}; worst relative diff "
        f"{worst:.3e}; final shift tree |diff|/|ref| {tree_err:.3e} (tol {TOL_TINY_FP32}); "
        f"backward launches {launches}")
    if worst > TOL_TINY_FP32 or tree_err > TOL_TINY_FP32:
        raise AssertionError("tiny train: the kernel path disagrees with the plain path")


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# phase 4: idefics2-8b-base at full width and depth
# ---------------------------------------------------------------------------


def synthetic_image(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(980, 980, 3), dtype=np.uint8)


WORDS = ("red blue green small large dog cat bus tree sky table person two three "
         "standing sitting water street kitchen field plate window").split()


def synthetic_text(seed: int, n_chars: int) -> str:
    rng = np.random.default_rng(seed)
    parts, size = [], 0
    while size < n_chars:
        w = " ".join(rng.choice(WORDS, size=6))
        line = f"Question: what is {w}? Answer: {rng.choice(WORDS)}\n"
        parts.append(line)
        size += len(line)
    return "".join(parts)[:n_chars]


# device seconds by kernel group of each profile_run, by its label
PROFILES = {}


def kernel_group(key: str) -> str:
    k = key.lower()
    # int8_matmul_kernel / int8_matmul_mma_kernel; fused_mlp_kernel and the
    # bf16 path's fused_mlp_gateup_kernel / fused_mlp_down_kernel
    return ("attention backward kernels" if "flash_bwd" in key or "bwd::" in key
            else "attention forward kernels" if "mimic::" in key
            else "int8_matmul" if "int8_matmul" in key
            else "w8a8_matmul" if "w8a8" in key
            else "quantize_rows" if "quantize_rows" in key
            else "fused_mlp" if "fused_mlp" in key
            else "prompt_attn" if "prompt_attn" in key
            else "int8 split-K reduce" if "splitk_reduce" in key
            else "matmuls" if any(w in k for w in ("gemm", "nvjet", "xmma", "cutlass"))
            else "other")


def covered_us(spans) -> float:
    """Length of the union of (start, end) spans: device time during which at
    least one of the kernels ran.  A sum of kernel durations counts twice what
    overlaps (a programmatic dependent launch starts before its predecessor
    ends)."""
    total, cur = 0.0, None
    for start, end in sorted(spans):
        if cur is None or start > cur[1]:
            total += 0.0 if cur is None else cur[1] - cur[0]
            cur = [start, end]
        else:
            cur[1] = max(cur[1], end)
    return total + (0.0 if cur is None else cur[1] - cur[0])


def profile_run(label, run):
    """One run under torch.profiler: device time by kernel group (sums of
    kernel durations), the device's busy time (the union of the kernels'
    spans) and share of the wall time, and the top kernels; kept in PROFILES,
    with the union of each group's spans under "covered".  ``run()`` returns
    its synchronised wall seconds."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        secs = run()
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    us = {e.key: e.self_device_time_total for e in kernels}
    if sum(us.values()) == 0:
        log(f"[profile] {label}: the profiler recorded no device time")
        return
    groups = dict.fromkeys(("attention forward kernels", "attention backward kernels",
                            "int8_matmul", "fused_mlp", "prompt_attn", "int8 split-K reduce",
                            "w8a8_matmul", "quantize_rows", "matmuls", "other"), 0.0)
    for key, t in us.items():
        groups[kernel_group(key)] += t
    spans = {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            spans.setdefault(kernel_group(e.name), []).append((e.time_range.start,
                                                               e.time_range.end))
    busy = covered_us([x for v in spans.values() for x in v])
    PROFILES[label] = {**{g: t / 1e6 for g, t in groups.items()},
                       "covered": {g: covered_us(v) / 1e6 for g, v in spans.items()}}
    log(f"[profile] {label}: {secs:.3f} s wall under the profiler, device busy "
        f"{busy / 1e6:.3f} s ({busy / 1e6 / secs:.1%}; kernel durations sum to "
        f"{sum(us.values()) / 1e6:.3f} s); " + ", ".join(f"{g} {t / 1e6:.3f} s"
                                                        for g, t in groups.items())
        + f" (tracing and reading the trace: {time.perf_counter() - t0:.1f} s)")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]:
        log(f"[profile]   {e.self_device_time_total / 1e3:10.2f} ms {e.count:6d}x {e.key[:110]}")


def profile_call(name, run):
    profile_run(f"call {name}", lambda: run(name)[1])


def serving_calls():
    """name → (images, texts, prompt bucket) of the two serving calls."""
    return {
        "A": ([[synthetic_image(10 + i)] for i in range(4)],
              [f"Image:<image> {synthetic_text(20 + i, 250 + 40 * i)}Question: what is in "
               f"the image? Answer:" for i in range(4)], 512),
        "B": ([[synthetic_image(30 + i)] for i in range(2)],
              [f"Image:<image> {synthetic_text(40 + i, 3700 + 150 * i)}Question: what is in "
               f"the image? Answer:" for i in range(2)], 4096),
    }


def timed_generate(runner, calls, name):
    """runner.generate on call ``name``: (decoded strings, synchronised wall s)."""
    images, texts, _ = calls[name]
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = runner.generate(images, texts, num_beams=NUM_BEAMS, max_new_tokens=MAX_NEW_TOKENS)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def main_runner():
    """idefics2-8b-base with random bf16 parameters made on the card and a MimIC shift."""
    from mimic_tpu_torch.config import get_preset
    from mimic_tpu_torch.models.factory import build_model
    from mimic_tpu_torch.shift.params import init_shift_params

    t0 = time.perf_counter()
    runner = build_model("idefics2-8b-base", device="cuda", dtype=torch.bfloat16, seed=0,
                         length_buckets=(512, 4096))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in runner.module.buffers())
    log(f"[main] idefics2-8b-base: {n_params / 1e9:.3f} B random bf16 parameters made on "
        f"the card in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    gen = torch.Generator(device="cuda").manual_seed(1)
    runner.set_shift(init_shift_params(get_preset("mimic")[0], runner.cfg.text, gen,
                                       torch.device("cuda")))
    assert runner.logz2 == "unmasked"
    return runner


def phase_main():
    from mimic_tpu_torch.models import generate as tg
    from mimic_tpu_torch.models.decoder import ATTN_PATH_LOG
    from mimic_tpu_torch.ops import norms as tn
    from mimic_tpu_torch.ops.flash_attention import LAUNCHES, reset_launch_counts

    runner = main_runner()

    calls = serving_calls()
    for name, (images, texts, bucket) in calls.items():
        width = runner.processor(None, texts)["input_ids"].shape[1]
        if not bucket // 2 < width <= bucket:
            raise AssertionError(f"call {name}: prompt width {width} misses the {bucket} bucket")

    def run(name):
        return timed_generate(runner, calls, name)

    for name in calls:  # warm-up
        _, secs = run(name)
        log(f"[main] warm-up call {name}: {secs:.3f} s")

    reset_launch_counts()
    tn.reset_launch_counts()
    ATTN_PATH_LOG.clear()
    timings = {}
    for name, (images, texts, bucket) in calls.items():
        out, secs = run(name)
        timings[name] = secs
        if len(out) != len(texts) or not all(isinstance(s, str) for s in out):
            raise AssertionError(f"call {name}: bad output {out!r}")
        log(f"[main] call {name}: {len(texts)} requests, prompt bucket {bucket}, beam "
            f"{NUM_BEAMS}, {MAX_NEW_TOKENS} new tokens: {secs:.3f} s = "
            f"{len(texts) / secs:.3f} q/s; decoded {json.dumps(out)}")
    launches = {**LAUNCHES, "row_norm": sum(tn.LAUNCHES.values())}
    paths = list(ATTN_PATH_LOG)
    log(f"[main] kernel launches in the counted run: {launches}")
    log(f"[main] decoder attention paths: {paths.count('flash')} flash, "
        f"{paths.count('cached')} cached, {paths.count('xla')} xla")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    if paths != (["flash"] + ["cached"] * (MAX_NEW_TOKENS - 1)) * len(calls):
        raise AssertionError(f"unexpected attention paths {paths}")
    for name in calls:
        profile_call(name, run)

    # the 8B prefill's last logits through the kernels against the plain path
    images, texts, bucket = calls["A"]
    runner.tokenizer.padding_side = "left"  # as generate() pads
    batch = runner.process_input(images, texts, pad_to=bucket)
    logits = {}
    for attn_impl in ("flash", "xla"):
        logits[attn_impl], _, _ = tg._prefill(
            runner.params, runner.cfg, batch, bucket + MAX_NEW_TOKENS, runner.shift,
            "unmasked", torch.bfloat16, attn_impl,
        )
    a, b = logits["flash"], logits["xla"]
    if a.shape != (4, runner.cfg.text.vocab_size) or not torch.isfinite(a).all():
        raise AssertionError(f"8B prefill logits: shape {tuple(a.shape)} or non-finite values")
    cos = torch.nn.functional.cosine_similarity(a, b, dim=-1).min().item()
    same_top = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    log(f"[main] 8B prefill last logits, kernels vs plain attention (bf16): max abs diff "
        f"{(a - b).abs().max().item():.4f} of max |logit| {b.abs().max().item():.4f}, "
        f"min row cosine {cos:.6f} (need >= {MIN_LOGIT_COSINE}), top-1 agreement {same_top:.2f}")
    if cos < MIN_LOGIT_COSINE:
        raise AssertionError("8B prefill logits through the kernels disagree with the plain path")

    # the token ids behind call A's strings: with random weights most ids are
    # >= 256, which the byte tokenizer decodes to nothing
    tok = runner.tokenizer
    result = tg.beam_generate(
        runner.params, runner.cfg, batch, max_new_tokens=MAX_NEW_TOKENS, num_beams=NUM_BEAMS,
        eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id, shift=runner.shift,
        logz2="unmasked", attn_impl="flash",
    )
    ids = result.tokens
    if (ids.shape != (4, MAX_NEW_TOKENS) or ids.min() < 0
            or ids.max() >= runner.cfg.text.vocab_size or not torch.isfinite(result.scores).all()):
        raise AssertionError(f"8B beam tokens out of range: {ids.tolist()} {result.scores}")
    log(f"[main] call A beam-3 token ids {ids.tolist()}, scores "
        f"{[round(x, 4) for x in result.scores.tolist()]}")
    log(f"[main] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return runner, launches


# ---------------------------------------------------------------------------
# phase 5: the MimIC train step on idefics2-8b-base
# ---------------------------------------------------------------------------


def make_train_batch(cfg, B=2, T_rec=2048, T_shift=256, n_demo_img=8, M=64):
    """The dual-pass batch of scripts/bench_8b_train.py, as device tensors:
    random token ids with 64 image tokens per image (8 demo images + the query
    image in the record pass, the query image in the shift pass), random 980 px
    pixels with full patch masks, and M gathered query tokens per row (the
    last M of each pass)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    size, S = cfg.vision.image_size, cfg.image_seq_len
    ng = size // cfg.vision.patch_size
    hi = min(32000, cfg.text.vocab_size)
    lo = min(300, hi // 2)
    full_ids = torch.randint(lo, hi, (B, T_rec), generator=gen, device=dev)
    # 128 text tokens after each image where they fit (idefics2's 64-token images)
    gap = min(128, (T_rec - 4 - M - (n_demo_img + 1) * S) // (n_demo_img + 1))
    for i in range(n_demo_img + 1):
        pos = 4 + i * (S + gap)
        full_ids[:, pos:pos + S] = cfg.image_token_id
    query_ids = torch.randint(lo, hi, (B, T_shift), generator=gen, device=dev)
    query_ids[:, 4:4 + S] = cfg.image_token_id

    def pixels(n):
        px = torch.randn(B, n, size, size, 3, generator=gen, device=dev).to(torch.bfloat16)
        return px, torch.ones(B, n, ng, ng, dtype=torch.int32, device=dev)

    full_px, full_patch = pixels(n_demo_img + 1)
    query_px, query_patch = pixels(1)
    idx = torch.arange(M, device=dev)[None].expand(B, M)
    return {
        "full_ids": full_ids, "full_mask": torch.ones(B, T_rec, dtype=torch.int32, device=dev),
        "full_pixels": full_px, "full_patch_mask": full_patch,
        "query_ids": query_ids, "query_mask": torch.ones(B, T_shift, dtype=torch.int32, device=dev),
        "query_pixels": query_px, "query_patch_mask": query_patch,
        "prefix_q_idx": idx + (T_rec - M), "shift_q_idx": idx + (T_shift - M),
        "q_valid": torch.ones(B, M, dtype=torch.bool, device=dev),
    }


def frozen_fingerprint(params) -> dict:
    """An exact per-leaf checksum of the frozen tree, slab by slab (no copy of
    the 16 GB tree): the int64 sum of the bit patterns, position-weighted."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
            return
        if node.requires_grad:
            raise AssertionError(f"frozen leaf {'/'.join(path)} requires grad")
        bits = node.view(torch.int16) if node.element_size() == 2 else node.view(torch.int32)
        slabs = bits if bits.dim() > 2 else bits[None]
        total = 0
        for slab in slabs:
            flat = slab.reshape(-1).to(torch.int64)
            weights = torch.arange(flat.numel(), device=flat.device) % 65521 + 1
            total += int((flat * weights).sum().item()) + int(flat.sum().item())
        out["/".join(path)] = total

    walk(params, ())
    return out


def phase_train_8b(runner):
    from mimic_tpu_torch.config import get_preset
    from mimic_tpu_torch.models.decoder import ATTN_PATH_LOG
    from mimic_tpu_torch.models.lvlm import encode_images
    from mimic_tpu_torch.ops import flash_attention as tfa
    from mimic_tpu_torch.ops import flash_backward as tfb
    from mimic_tpu_torch.shift.params import (init_shift_params, multi_head, needs_attn_capture,
                                               needs_ffn_capture)
    from mimic_tpu_torch.train import step as ts
    from mimic_tpu_torch.train.optim import build_optimizer

    cfg, frozen = runner.cfg, runner.params
    L = cfg.text.num_layers
    enc, peft = get_preset("mimic")
    gen = torch.Generator(device="cuda").manual_seed(2)
    shift = init_shift_params(enc, cfg.text, gen, torch.device("cuda"))
    trainable = {"shift": shift}
    initial = {k: v.clone() for k, v in shift.items()}
    tx = build_optimizer(trainable, lr=peft.lr, weight_decay=1e-3, warmup_steps=10,
                         total_steps=1000, grad_clip=1.0)
    step = ts.make_train_step(cfg, enc, tx, ce_loss_weight=peft.ce_loss_weight,
                              align_loss_weight=peft.align_loss_weight, attn_impl="flash",
                              logz2="unmasked")
    state = ts.TrainState(trainable, tx.init(trainable), 0)
    batch = make_train_batch(cfg)
    torch.cuda.synchronize()
    before = frozen_fingerprint(frozen)
    n_train = sum(v.numel() for v in shift.values())
    log(f"[train] idefics2-8b-base, mimic preset: {n_train / 1e6:.3f} M fp32 shift parameters "
        f"({', '.join(f'{k} {tuple(v.shape)}' for k, v in shift.items())}); batch B2, record pass "
        f"{batch['full_ids'].shape[1]} tokens with {batch['full_pixels'].shape[1]} images, shift "
        f"pass {batch['query_ids'].shape[1]} tokens, {batch['q_valid'].shape[1]} gathered tokens")

    def run_step(b=batch):
        nonlocal state
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, frozen, b)
        torch.cuda.synchronize()
        return m, time.perf_counter() - t

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    m, secs = run_step()
    log(f"[train] warm-up step: {secs:.3f} s, loss {float(m['loss']):.6f}")
    tfa.reset_launch_counts()
    tfb.reset_launch_counts()
    ATTN_PATH_LOG.clear()
    times, rows = [], []
    for i in range(TRAIN_STEPS):
        m, secs = run_step()
        times.append(secs)
        row = {k: float(v) for k, v in m.items()}
        rows.append(row)
        log(f"[train] step {i + 1}: {secs:.3f} s; " + ", ".join(f"{k} {v:.6g}" for k, v in row.items()))
    launches = {**tfa.LAUNCHES, **tfb.LAUNCHES}
    paths = list(ATTN_PATH_LOG)
    STEP_SECONDS["uncached"] = times
    log(f"[train] {TRAIN_STEPS} counted steps: mean {sum(times) / len(times):.3f} s/step "
        f"(min {min(times):.3f}, max {max(times):.3f}); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; kernel launches {launches}; "
        f"decoder attention paths {paths}")
    if paths != ["flash"] * (2 * TRAIN_STEPS):
        raise AssertionError(f"a decoder call of the train step left the flash path: {paths}")
    # layer 0's q/k/v come from frozen embeddings and need no gradient, so the
    # backward kernels run for layers 1..L-1 of the shift pass
    want_bwd = (L - 1) * TRAIN_STEPS
    if launches["flash_bwd_dq"] != want_bwd or launches["flash_bwd_dkv"] != want_bwd:
        raise AssertionError(f"backward kernels launched {launches}, want {want_bwd} each")
    if launches["onepass_fwd"] == 0:
        raise AssertionError(f"the forward kernel never launched in the train step: {launches}")
    for row in rows:
        if not all(np.isfinite(v) for v in row.values()) or not row["grad_norm"] > 0:
            raise AssertionError(f"train metrics not finite or zero gradient: {row}")
    if frozen_fingerprint(frozen) != before:
        raise AssertionError("a frozen parameter changed during training")
    moved = {k: (state.trainable["shift"][k] - v).abs().max().item() for k, v in initial.items()}
    log(f"[train] frozen parameters bit-unchanged (per-leaf checksums); shift max |change| {moved}")
    if not all(x > 0 for x in moved.values()):
        raise AssertionError(f"a shift leaf did not change: {moved}")

    profile_run("train step", lambda: run_step()[1])

    # gradients of one step through the kernels against the plain attention
    # path, on the same image features (the plain path's ViT attention would
    # materialise [18, 16, 4992, 4992] fp32 scores)
    with torch.no_grad():
        feats = {f"{p}_feats": encode_images(frozen, cfg, batch[f"{p}_pixels"],
                                             batch[f"{p}_patch_mask"], attn_impl="flash")
                 for p in ("full", "query")}
    fb = {k: v for k, v in batch.items() if "pixels" not in k and "patch" not in k}
    fb.update(feats)
    loss_kw = dict(cfg=cfg, strategy=enc.strategy(), rec_attn=needs_attn_capture(enc),
                   rec_ffn=needs_ffn_capture(enc), mh=multi_head(enc),
                   ce_loss_weight=peft.ce_loss_weight, align_loss_weight=peft.align_loss_weight,
                   logz2="unmasked")
    grads, losses = {}, {}
    for attn_impl in ("flash", "xla"):
        leaves = {k: v.detach().requires_grad_(True) for k, v in state.trainable["shift"].items()}
        with torch.enable_grad():
            loss, _ = ts.compute_loss({"shift": leaves}, frozen, fb, attn_impl=attn_impl, **loss_kw)
            grads[attn_impl] = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        losses[attn_impl] = float(loss.detach())
        torch.cuda.empty_cache()
    cos = {k: torch.nn.functional.cosine_similarity(
        grads["flash"][k].flatten(), grads["xla"][k].flatten(), dim=0).item()
        for k in grads["flash"]}
    log(f"[train] one step's gradients, kernels vs plain attention (bf16 model): loss "
        f"{losses['flash']:.6f} vs {losses['xla']:.6f}; per-leaf cosine {cos} "
        f"(need >= {MIN_GRAD_COSINE})")
    if min(cos.values()) < MIN_GRAD_COSINE:
        raise AssertionError("8B gradients through the kernels disagree with the plain path")

    # the step on precomputed image features: what the training vision-feature
    # cache leaves of it (phase 12 runs the cache itself)
    run_step(fb)
    vision_free = [run_step(fb)[1] for _ in range(2)]
    STEP_SECONDS["precomputed"] = vision_free
    log(f"[train] step on precomputed image features: {vision_free[0]:.3f} s, "
        f"{vision_free[1]:.3f} s")
    profile_run("train step on precomputed image features", lambda: run_step(fb)[1])
    return launches


# ---------------------------------------------------------------------------
# phase 6: the int8 kernels against their plain versions
# ---------------------------------------------------------------------------


def _int8_weight(gen, shape, scale_base):
    """Random int8 weights and positive fp32 per-column scales around ``scale_base``."""
    wq = torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)
    scale = (torch.rand(shape[:-2] + shape[-1:], generator=gen, device="cuda") + 0.5) * scale_base
    return wq, scale


def cold_ms(fn, layers, reps, graph=False):
    """``cuda_ms`` of ``fn(layer)`` with the layer cycling through a stack larger
    than the card's 50 MB L2 cache, so every launch reads its weights from HBM
    as a decode step does (one layer's weights fit in L2)."""
    order = itertools.cycle(range(layers))
    return cuda_ms(lambda: fn(next(order)), reps, graph)


def check_int8(label, kernel, plain, layers, layer, reps, fields=None):
    """``kernel(layer)`` against ``plain(layer)``: every output within
    TOL_INT8_REL of its max |reference| (``fields`` named "m": TOL_INT8_M
    absolute), a second launch bit-identical; then both timed cold, as device
    time (CUDA graphs: at decode sizes a launch from Python takes longer than
    the kernel).  Returns (per-field max abs err, ms, plain ms)."""
    got, want, again = kernel(layer), plain(layer), kernel(layer)
    torch.cuda.synchronize()
    if isinstance(got, torch.Tensor):
        got, want, again = (got,), (want,), (again,)
    if not all(torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))
               for a, b in zip(got, again)):
        raise AssertionError(f"{label}: two launches on the same inputs gave different bits")
    errs = {}
    for field, a, b in zip(fields or ("out",), got, want):
        if a.shape != b.shape or a.dtype != b.dtype or not torch.isfinite(a).all():
            raise AssertionError(f"{label}: {field} {tuple(a.shape)} {a.dtype} or non-finite values")
        errs[field] = (a.float() - b.float()).abs().max().item()
        tol = TOL_INT8_M if field == "m" else TOL_INT8_REL * b.float().abs().max().item()
        if errs[field] > tol:
            raise AssertionError(f"{label}: {field} max abs err {errs[field]} > {tol}")
    return errs, cold_ms(kernel, layers, reps, True), cold_ms(plain, layers, reps, True)


def check_int8_matmul(label, seed, M, K, N, layers, layer, n_real, reps):
    """int8_matmul (stacked when ``layers``, else on a 2-D weight) at [M, K] x
    [K, N]; ``n_real``: the lm head's handle, N 128-padded in storage and
    sliced back by qdot, fp32 logits out."""
    from mimic_tpu_torch.ops import quant as tq

    gen = torch.Generator(device="cuda").manual_seed(seed)
    wq, scale = _int8_weight(gen, (layers, K, N) if layers else (K, N), 4e-4)
    x = torch.randn(M, K, generator=gen, device="cuda").to(torch.bfloat16)
    if n_real:
        wq[:, n_real:] = 0
        handle = {"q8": wq, "scale": scale[:n_real].contiguous()}
        kernel = lambda _: tq.qdot(x, handle, preferred_element_type=torch.float32)
        plain = lambda _: tq.int8_matmul_plain(x, wq[:, :n_real], handle["scale"], torch.float32)
    elif not layers:  # a 2-D handle (idefics1's cross layers, sliced per layer)
        kernel = lambda _: tq.int8_matmul(x, wq, scale)
        plain = lambda _: tq.int8_matmul_plain(x, wq, scale)
    else:
        kernel = lambda l: tq.int8_matmul_stacked(x, wq, scale, l)
        plain = lambda l: tq.int8_matmul_plain(x, wq[l], scale[l])
    errs, ms, plain_ms = check_int8(label, kernel, plain, max(layers, 1), layer, reps)
    host_ms = cold_ms(kernel, max(layers, 1), reps)
    n_out = n_real or N
    b = bound(nbytes(x) + K * n_out + 4 * n_out + M * n_out * (4 if n_real else 2),
              2 * M * K * n_out, "bf16")
    log(f"[int8] {label}: int8_matmul M{M} K{K} N{n_out}"
        f"{f' layer {layer} of {layers}' if layers else ''}: max abs err {errs['out']:.3e} "
        f"(tol {TOL_INT8_REL} x max |ref|), two launches bit-identical; kernel {ms:.4f} ms "
        f"({b['bound_ms'] / ms:.1%} of the bound), plain {plain_ms:.4f} ms, {bound_text(b)}; "
        f"no PyTorch call multiplies bf16 rows by int8 weights")
    # the product the int8 mode replaces: torch.matmul on the same weights in bf16
    wb = (wq[:, :n_real] if n_real else wq).to(torch.bfloat16).contiguous()
    del wq
    bf16_ms = cold_ms(lambda l: x @ (wb[l] if layers else wb), max(layers, 1), reps, True)
    log(f"[int8] {label}: yardstick, bf16 torch.matmul on a bf16 copy of the weights "
        f"{bf16_ms:.4f} ms (kernel / bf16 {ms / bf16_ms:.2f}); the kernel launched from Python "
        f"call by call {host_ms:.4f} ms")
    return {"name": "int8_matmul", "max_abs_err": errs["out"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"], "library_ms": None}


def check_fused_mlp(label, seed, M, D, F, reps):
    from mimic_tpu_torch.ops import quant as tq

    gen = torch.Generator(device="cuda").manual_seed(seed)
    layers, layer = 4, 3
    gu, gs = _int8_weight(gen, (layers, D, 2 * F), 4e-4)
    dn, ds = _int8_weight(gen, (layers, F, D), 1e-4)
    x = torch.randn(M, D, generator=gen, device="cuda").to(torch.bfloat16)
    kernel = lambda l: tq.fused_mlp_stacked(x, gu, gs, dn, ds, l)
    errs, ms, plain_ms = check_int8(
        label, kernel, lambda l: tq.fused_mlp_plain(x, gu[l], gs[l], dn[l], ds[l]), layers, layer,
        reps)
    host_ms = cold_ms(kernel, layers, reps)
    b = bound(2 * nbytes(x) + nbytes(gu[0], gs[0], dn[0], ds[0]), 2 * M * D * 3 * F, "bf16")
    log(f"[int8] {label}: fused_mlp_int8 M{M} D{D} F{F} layer {layer} of {layers}: max abs err "
        f"{errs['out']:.3e} (tol {TOL_INT8_REL} x max |ref|), two launches bit-identical; "
        f"kernel {ms:.4f} ms ({b['bound_ms'] / ms:.1%} of the bound), plain {plain_ms:.4f} ms, "
        f"{bound_text(b)}; no PyTorch call fuses an int8 MLP")
    # the bf16 MLP the int8 mode replaces: three torch.matmul and silu * u
    g, u = (gu[:, :, i * F:(i + 1) * F].to(torch.bfloat16).contiguous() for i in range(2))
    d = dn.to(torch.bfloat16)
    del gu, dn
    silu = torch.nn.functional.silu
    bf16_ms = cold_ms(lambda l: (silu(x @ g[l]) * (x @ u[l])) @ d[l], layers, reps, True)
    log(f"[int8] {label}: yardstick, the bf16 MLP (three torch.matmul and silu * u) on bf16 "
        f"copies of the weights {bf16_ms:.4f} ms (kernel / bf16 {ms / bf16_ms:.2f}); the kernel "
        f"launched from Python call by call {host_ms:.4f} ms")
    return {"name": "fused_mlp_int8", "max_abs_err": errs["out"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"], "library_ms": None}


def check_prompt_attn(label, seed, B0, beams, Hkv, G, Sp, pads, reps, split_sweep=False,
                      prefix=0):
    """prompt_attn_int8 on a 16-layer int8 prompt cache quantized on the card,
    folded layout, against its plain version (checked at layer 1); one kernel
    launched per call; ``split_sweep``: the kernel under every cluster split,
    the plan's choice marked.  ``prefix``: P prefix-tuning slots lead the Sp
    left-padded prompt slots, as in the beam search with a prefix; the P + Sp
    slots are zero-padded to a multiple of 128 by ``quantize_prompt_kv`` and
    masked there."""
    from mimic_tpu_torch.ops import decode_attention as tda

    gen = torch.Generator(device="cuda").manual_seed(seed)
    D, layers = tda.HEAD_DIM, 16
    Sr = prefix + Sp
    Sq = -(-Sr // tda.KEY_BLOCK) * tda.KEY_BLOCK
    kv = [torch.randn(layers, B0, Sr, Hkv, D, generator=gen, device="cuda").to(torch.bfloat16)
          for _ in range(2)]
    pk, pv = tda.quantize_prompt_kv(*kv, padded_len=Sq)
    del kv
    qg = (torch.randn(B0 * beams, 1, Hkv, G, D, generator=gen, device="cuda") / D**0.5)
    qf = tda._fold(qg.to(torch.bfloat16), B0).contiguous()
    mask = torch.from_numpy(np.concatenate(
        [np.ones((B0, prefix), np.int32), left_padded_mask(B0, Sp, pads),
         np.zeros((B0, Sq - Sr), np.int32)], axis=1)).cuda()
    args = lambda l: (qf, pk["q8"][l], pk["scale"][l], pv["q8"][l], pv["scale"][l], mask)
    errs, ms, plain_ms = check_int8(
        label, lambda l: tda._launch(*args(l)),
        lambda l: tda.prompt_attention_int8_plain(*args(l)), layers, 1, reps, fields="oml")
    slots = f"Sp {Sp}" if Sq == Sp else f"Sp {prefix} prefix + {Sp} = {Sr} stored as {Sq}"
    log(f"[int8] {label}: prompt_attn_int8 B0 {B0} x beams {beams}, Hkv {Hkv}, G {G}, {slots}, "
        f"D {D}, left pads {list(pads)}: max abs err o {errs['o']:.3e} m {errs['m']:.3e} "
        f"l {errs['l']:.3e} (tol o, l {TOL_INT8_REL} x max |ref|, m {TOL_INT8_M}); "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    # one layer's int8 keys and values with their scales, the query, the mask,
    # and the partial (o, m, l) written; scores and p @ v on the unmasked keys
    keys = int(mask.sum().item())
    rows = beams * Hkv * G
    b = bound(nbytes(qf, pk["q8"][0], pk["scale"][0], pv["q8"][0], pv["scale"][0], mask)
              + B0 * rows * (D * 4 + 8), 4 * rows * D * keys, "bf16")
    log(f"[int8] {label}: {bound_text(b)} ({b['bound_ms'] / ms:.1%} of it); no PyTorch call "
        f"attends over int8 keys and returns the partial (o, m, l)")
    if hasattr(tda, "prompt_split"):
        # one kernel per call: no merge kernel, no workspace
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            tda._launch(*args(1))
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if str(e.device_type).endswith("CUDA")]
        log(f"[int8] {label}: kernels of one call {names}")
        if len(names) != 1 or "prompt_attn" not in names[0]:
            raise AssertionError(f"{label}: one call launched {names}, want one prompt_attn kernel")
        if split_sweep:
            M = beams * G
            clusters = {s: tda._clusters(0, s, M) for s in tda.PROMPT_SPLITS}
            plan = tda.prompt_split(B0, Hkv, Sq, clusters.get)
            times = {}
            for split in tda.PROMPT_SPLITS:
                if split <= Sq // tda.KEY_BLOCK:
                    times[split] = cold_ms(lambda l, s=split: tda._launch(*args(l), split=s),
                                           layers, reps, True)
            log(f"[int8] split sweep, prompt_attn_int8 {label} ({B0 * Hkv} clusters; the card "
                f"holds at once " + ", ".join(f"{n} of {s}" for s, n in clusters.items()) + "): "
                + ", ".join(f"split {k} {t:.4f} ms{' (plan)' if k == plan else ''}"
                            for k, t in times.items()))
    return {"name": "prompt_attn_int8", "max_abs_err": max(errs.values()), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "library_ms": None}


# the tensor-core kernels of the bf16 int8 path (csrc/int8_mma.cuh), by name
INT8_MMA_KERNELS = ("int8_matmul_mma_kernel", "fused_mlp_gateup_kernel", "fused_mlp_down_kernel")


def int8_crossover():
    """qdot's cut-off between int8_matmul and a dequantized bf16 torch.matmul
    (its path from KERNEL_MAX_M rows on): both at the q/k/v shape (K 4096, N
    6144, a 32-layer stack cycled as cold_ms does) for M from 16 to 512."""
    from mimic_tpu_torch.ops import quant as tq

    gen = torch.Generator(device="cuda").manual_seed(29)
    wq, scale = _int8_weight(gen, (32, 4096, 6144), 4e-4)
    for M in (16, 32, 64, 128, 255, 384, 512):
        x = torch.randn(M, 4096, generator=gen, device="cuda").to(torch.bfloat16)
        kernel = cold_ms(lambda l: tq.int8_matmul_stacked(x, wq, scale, l), 32, 32, True)
        deq = cold_ms(lambda l: x @ tq.dequantize(
            {"q8": wq, "scale": scale, "layer": l}).to(torch.bfloat16), 32, 32, True)
        log(f"[int8] qdot cut-off, q/k/v M{M}: int8_matmul {kernel:.4f} ms, dequantize + bf16 "
            f"torch.matmul {deq:.4f} ms ({'kernel' if kernel < deq else 'dequantize'} faster)")


def int8_split_sweep():
    """The bf16 tensor-core kernels at call A's decode shapes (M 12) under every
    K split, launched straight through the library with the split given, so
    that mma_plan's choice (marked) can be read against the others."""
    from mimic_tpu_torch.ops import _build
    from mimic_tpu_torch.ops import quant as tq

    lib, gen = _build.load_library(), torch.Generator(device="cuda").manual_seed(30)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    M, D, F = 12, 4096, 14336
    x = torch.randn(M, D, generator=gen, device="cuda").to(torch.bfloat16)
    for label, N, layers in (("qkv", 6144, 32), ("o", 4096, 32), ("lm head", 32128, 1)):
        wq, scale = _int8_weight(gen, (layers, D, N), 4e-4)
        out = torch.empty(M, N, dtype=torch.bfloat16, device="cuda")
        plan = tq.mma_plan(M, D, N // tq.MMA_BLOCK_N, sms)
        times = {}
        for ks in tq.MMA_SPLITS:
            def run(l, ks=ks):
                err = lib.mimic_int8_matmul_mma(x.data_ptr(), D, wq[l].data_ptr(), scale[l].data_ptr(),
                                                out.data_ptr(), M, D, N, ks, 1, stream())
                assert err == 0, err
            times[ks] = cold_ms(run, layers, 32, True)
        log(f"[int8] split sweep, int8_matmul {label} M{M} N{N}: " + ", ".join(
            f"ksplit {ks} {t:.4f} ms{' (plan)' if ks == plan else ''}" for ks, t in times.items()))
        del wq, scale
    gu, gs = _int8_weight(gen, (4, D, 2 * F), 4e-4)
    dn, ds = _int8_weight(gen, (4, F, D), 1e-4)
    h = torch.empty(M, F, dtype=torch.bfloat16, device="cuda")
    out = torch.empty(M, D, dtype=torch.bfloat16, device="cuda")
    plan = (tq.mma_plan(M, D, F // 64, sms), tq.mma_plan(M, F, D // tq.MMA_BLOCK_N, sms))
    for which in range(2):
        times = {}
        for ks in tq.MMA_SPLITS:
            splits = (ks, plan[1]) if which == 0 else (plan[0], ks)
            def run(l, splits=splits):
                err = lib.mimic_fused_mlp_int8_mma(
                    x.data_ptr(), gu[l].data_ptr(), gs[l].data_ptr(), dn[l].data_ptr(),
                    ds[l].data_ptr(), h.data_ptr(), out.data_ptr(), M, D, F, *splits, 1, stream())
                assert err == 0, err
            times[ks] = cold_ms(run, 4, 16, True)
        log(f"[int8] split sweep, fused_mlp_int8 M{M}, the {('gate/up', 'down')[which]} product's "
            f"split (the other's {plan[1 - which]}): " + ", ".join(
                f"ksplit {ks} {t:.4f} ms{' (plan)' if ks == plan[which] else ''}"
                for ks, t in times.items()))


def check_llava_prompt_attn():
    """llava-interleave-7b's call in "int8" without a shift (phase 15): 4 requests x
    3 beams, 4 KV heads of G 7, so 21 folded rows a (request, KV head): the kernel's
    two-m16-tile template; Tp 1024."""
    return check_prompt_attn("llava-G7", 32, 4, NUM_BEAMS, 4, 7, 1024, (0, 37, 130, 300),
                             reps=32)


def phase_int8_kernels(split_sweep=False):
    """The int8 kernels at idefics2-8b's decode shapes (D 4096, 32 heads / 8 kv
    heads, F 14336, vocab 32003): M = 12 is call A's decode (4 requests x 3
    beams), M = 6 call B's; M = 255 the largest M that takes the kernel.  The
    times kept for each kernel are those at its first (main-path) shape."""
    results = [
        check_int8_matmul("qkv-12", 20, 12, 4096, 6144, 32, 5, 0, reps=32),
        check_int8_matmul("o-12", 21, 12, 4096, 4096, 32, 7, 0, reps=32),
        check_int8_matmul("lm-head-12", 22, 12, 4096, 32128, 0, 0, 32003, reps=20),
        check_int8_matmul("qkv-6", 23, 6, 4096, 6144, 32, 31, 0, reps=32),
        check_int8_matmul("qkv-255", 24, 255, 4096, 6144, 32, 1, 0, reps=32),
        check_fused_mlp("mlp-12", 25, 12, 4096, 14336, reps=16),
        check_fused_mlp("mlp-6", 26, 6, 4096, 14336, reps=16),
        check_prompt_attn("call-B", 27, 2, NUM_BEAMS, 8, 4, 4096, (0, 250), reps=32,
                          split_sweep=split_sweep),
        check_prompt_attn("call-A", 28, 4, NUM_BEAMS, 8, 4, 512, (130, 0, 37, 300), reps=32,
                          split_sweep=split_sweep),
        # call B with a 16-slot prefix (phase 13e): 4112 slots padded to 4224
        check_prompt_attn("call-B-prefix", 31, 2, NUM_BEAMS, 8, 4, 4096, (0, 250), reps=32,
                          prefix=16),
        check_llava_prompt_attn(),
    ]
    summary = {}
    for r in results:
        s = summary.setdefault(r["name"], {"max_abs_err": 0.0})
        s["max_abs_err"] = max(s["max_abs_err"], r["max_abs_err"])
        for k in TIMING_KEYS:
            s.setdefault(k, r[k])
    return summary


# ---------------------------------------------------------------------------
# phase 7: the tiny int8 slice, kernels on the card against the CPU
# ---------------------------------------------------------------------------


class LogitSpy:
    """Records the last-position logits of every ``lvlm_forward`` call made by
    ``models/generate.py`` (the prefill first, then one per decode step)."""

    def __init__(self):
        from mimic_tpu_torch.models import generate as tg

        self.tg, self.logits = tg, []

    def __enter__(self):
        self.orig = self.tg.lvlm_forward

        def spy(*args, **kwargs):
            out = self.orig(*args, **kwargs)
            self.logits.append(out.logits[:, -1].float())
            return out

        self.tg.lvlm_forward = spy
        return self

    def __exit__(self, *exc):
        self.tg.lvlm_forward = self.orig


def _same_tree_bytes(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_tree_bytes(a[k], b[k]) for k in a)
    a, b = a.detach().cpu(), b.detach().cpu()
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def _int8_counts():
    from mimic_tpu_torch.ops import decode_attention as tda
    from mimic_tpu_torch.ops import quant as tq

    return {**tq.LAUNCHES, **tq.ROW_LAUNCHES, **tda.LAUNCHES}


def _reset_int8_counts():
    from mimic_tpu_torch.ops import decode_attention as tda
    from mimic_tpu_torch.ops import quant as tq

    tq.reset_launch_counts()
    tda.reset_launch_counts()


def phase_tiny_int8():
    from mimic_tpu_torch.config import get_preset
    from mimic_tpu_torch.models import decoder as td
    from mimic_tpu_torch.models import generate as tg
    from mimic_tpu_torch.models.lvlm import init_lvlm_params
    from mimic_tpu_torch.models.runner import LVLMRunner
    from mimic_tpu_torch.models.tokenizer import SimpleTokenizer
    from mimic_tpu_torch.ops import decode_attention as tda
    from mimic_tpu_torch.shift.params import init_shift_params

    tk = SimpleTokenizer(padding_side="left")
    # text width 128: no lane padding on the down projection, so the fused MLP is eligible
    cfg = tiny_cfg(tk, hidden_size=128)
    L = cfg.text.num_layers
    cpu = torch.device("cpu")
    params = init_lvlm_params(cfg, torch.Generator().manual_seed(0), cpu)
    # the shift as initialised: phase 3 already amplifies it through the attention kernels
    shift = init_shift_params(get_preset("mimic")[0], cfg.text, torch.Generator().manual_seed(1), cpu)
    rng = np.random.default_rng(7)
    images = [[rng.integers(0, 255, (70, 70, 3)).astype(np.uint8)] for _ in range(2)]
    texts = ["Image:<image> Question: what is it? Answer:",
             "Image:<image> Question: and what colour is the thing on the left? Answer:"]
    runners = {dev: LVLMRunner(cfg, params, SimpleTokenizer(padding_side="left"), device=dev,
                               quant="int8") for dev in ("cpu", "cuda")}
    if not _same_tree_bytes(runners["cpu"].decode_params, runners["cuda"].decode_params):
        raise AssertionError("tiny int8: the int8 tree quantized on the card differs from the CPU's")
    new = 6
    logits, tokens = {}, {}
    for dev, r in runners.items():
        r.set_shift(shift)
        batch = r.process_input(images, texts, pad_to=128)
        _reset_int8_counts()
        with LogitSpy() as spy:
            tokens[dev] = tg.beam_generate(
                r.params, cfg, batch, max_new_tokens=new, num_beams=NUM_BEAMS,
                eos_token_id=tk.eos_token_id, pad_token_id=tk.pad_token_id, shift=r.shift,
                logz2="unmasked", attn_impl="flash" if dev == "cuda" else "xla",
                decode_params=r.decode_params,
            ).tokens.cpu()
        logits[dev] = [spy.logits[0].cpu(), spy.logits[1].cpu()]
    torch.cuda.synchronize()
    launches = _int8_counts()
    want = {"int8_matmul": (new - 1) * (2 * L + 1), "fused_mlp_int8": (new - 1) * L,
            "w8a8_matmul": 0, "quantize_rows": 0, "prompt_attn_int8": 0}
    errs = [(g - w).abs().max().item() for g, w in zip(logits["cuda"], logits["cpu"])]
    close = all(torch.allclose(g, w, rtol=TOL_TINY_FP32, atol=TOL_TINY_FP32)
                for g, w in zip(logits["cuda"], logits["cpu"]))
    same = torch.equal(tokens["cuda"], tokens["cpu"])
    log(f"[tiny-int8] fp32, quant='int8' with a MimIC shift, kernels on the card vs plain on the "
        f"CPU: int8 trees bit-identical; prefill logits max abs err {errs[0]:.3e}, first decode "
        f"step {errs[1]:.3e} (rtol = atol = {TOL_TINY_FP32}: {close}); beam-3 tokens identical: "
        f"{same}; tokens {tokens['cuda'].tolist()}; launches {launches} (want {want})")
    if not close or not same or launches != want:
        raise AssertionError("tiny int8 slice: the kernel path disagrees with the plain path")

    # one decode step over an int8 prompt cache (beam 3, 128 prompt slots)
    tcfg = cfg.text
    B0, T = 2, 128
    B = B0 * NUM_BEAMS
    plain_dec = params["lm"]["decoder"]
    qdec = runners["cpu"].decode_params["lm"]["decoder"]
    embeds = torch.from_numpy(rng.normal(size=(B0, T, tcfg.hidden_size)).astype(np.float32))
    step = torch.from_numpy(rng.normal(size=(B, 1, tcfg.hidden_size)).astype(np.float32))
    mask = torch.from_numpy(left_padded_mask(B0, T, [0, 40]))
    pre = td.decoder_forward(plain_dec, tcfg, embeds, td.make_causal_mask(mask),
                             td.positions_from_mask(mask), kv_cache=td.init_kv_cache(tcfg, B0, T, cpu),
                             key_mask=mask, cache_empty=True)
    prompt = [pre.kv_cache["k"], pre.kv_cache["v"]]
    mask_full = torch.cat([mask, torch.zeros(B0, 4, dtype=mask.dtype)], 1).repeat_interleave(
        NUM_BEAMS, 0)
    mask_full[:, T] = 1
    pos = mask.sum(-1).repeat_interleave(NUM_BEAMS)[:, None]
    quantized = {dev: tda.quantize_prompt_kv(*(p.to(dev) for p in prompt)) for dev in ("cpu", "cuda")}
    if not _same_tree_bytes(dict(enumerate(quantized["cpu"])), dict(enumerate(quantized["cuda"]))):
        raise AssertionError("tiny int8: prompt KV quantized on the card differs from the CPU's")
    hidden, paths = {}, {}
    for dev, (pk, pv) in quantized.items():
        gen_shape = (tcfg.num_layers, B, 4, tcfg.num_kv_heads, tcfg.head_size)
        cache = {"prompt_k": pk, "prompt_v": pv, "k": torch.zeros(gen_shape, device=dev),
                 "v": torch.zeros(gen_shape, device=dev), "length": T}
        _reset_int8_counts()
        td.ATTN_PATH_LOG.clear()
        hidden[dev] = td.decoder_forward(
            _to(qdec, dev), tcfg, step.to(dev), None, pos.to(dev), kv_cache=cache,
            key_mask=mask_full.to(dev)).hidden.cpu()
        paths[dev] = (list(td.ATTN_PATH_LOG), _int8_counts())
    err = (hidden["cuda"] - hidden["cpu"]).abs().max().item()
    close = torch.allclose(hidden["cuda"], hidden["cpu"], rtol=TOL_TINY_FP32, atol=TOL_TINY_FP32)
    log(f"[tiny-int8] decode step over an int8 prompt cache (B0 {B0} x beams {NUM_BEAMS}, "
        f"{T} prompt slots), card vs CPU: hidden max abs err {err:.3e} (rtol = atol = "
        f"{TOL_TINY_FP32}: {close}); paths and launches {paths}")
    if (not close or paths["cuda"][0] != ["cached", "quant_kv"]
            or paths["cuda"][1]["prompt_attn_int8"] != L or paths["cpu"][1]["prompt_attn_int8"]):
        raise AssertionError("tiny int8 prompt-KV step: the kernel path disagrees with the plain path")


# ---------------------------------------------------------------------------
# phase 8: the int8 serving modes on idefics2-8b-base
# ---------------------------------------------------------------------------


def dequantized_tree(tree):
    """A copy of ``tree`` with every int8 handle dequantized to bf16 [.., K, N]
    (layer by layer: no fp32 copy of a whole stack); other leaves shared."""
    from mimic_tpu_torch.ops.quant import dequantize, is_quantized

    if is_quantized(tree):
        q8, n = tree["q8"], tree["scale"].shape[-1]
        if q8.dim() == 2:
            return dequantize(tree).to(torch.bfloat16)
        out = torch.empty(q8.shape[0], q8.shape[1], n, dtype=torch.bfloat16, device=q8.device)
        for l in range(q8.shape[0]):
            out[l] = dequantize(dict(tree, layer=l)).to(torch.bfloat16)
        return out
    if isinstance(tree, dict):
        return {k: dequantized_tree(v) for k, v in tree.items()}
    return tree


def _row_cosine(a, b):
    return torch.nn.functional.cosine_similarity(a.float(), b.float(), dim=-1).min().item()


def phase_int8_8b(runner):
    import gc

    from mimic_tpu_torch.models import generate as tg

    calls = serving_calls()
    cfg = runner.cfg
    L = cfg.text.num_layers
    steps = MAX_NEW_TOKENS - 1
    want = {"int8_matmul": steps * (2 * L + 1), "fused_mlp_int8": steps * L, "w8a8_matmul": 0,
            "quantize_rows": 0, "prompt_attn_int8": 0}
    totals = dict.fromkeys(want, 0)
    shift = runner.shift

    def counted(name, label, expect):
        _, secs = timed_generate(runner, calls, name)
        log(f"[int8] warm-up call {name} ({label}): {secs:.3f} s")
        _reset_int8_counts()
        out, secs = timed_generate(runner, calls, name)
        got = _int8_counts()
        n = len(calls[name][1])
        log(f"[int8] call {name} ({label}): {n} requests, bucket {calls[name][2]}, beam "
            f"{NUM_BEAMS}, {MAX_NEW_TOKENS} new tokens: {secs:.3f} s = {n / secs:.3f} q/s; "
            f"launches {got}; decoded {json.dumps(out)}")
        if got != expect or len(out) != n:
            raise AssertionError(f"call {name} ({label}): launches {got}, want {expect}")
        for k in totals:
            totals[k] += got[k]
        return secs

    def batch_of(name):
        images, texts, bucket = calls[name]
        runner.tokenizer.padding_side = "left"  # as generate() pads
        return runner.process_input(images, texts, pad_to=bucket)

    def beam(batch, new, decode_params, **kw):
        tok = runner.tokenizer
        return tg.beam_generate(
            runner.params, cfg, batch, max_new_tokens=new, num_beams=NUM_BEAMS,
            eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id, shift=runner.shift,
            logz2=runner.logz2, attn_impl="flash", decode_params=decode_params, **kw)

    def first_step_logits(batch, decode_params, **kw):
        with LogitSpy() as spy:
            beam(batch, 2, decode_params, **kw)
        return spy.logits[1]

    # 1. "int8": the bf16 tree prefills, the int8 copy decodes; with the shift
    t0 = time.perf_counter()
    runner.set_quant("int8")
    torch.cuda.synchronize()
    log(f"[int8] set_quant('int8'): int8 decode copy made on the card in "
        f"{time.perf_counter() - t0:.1f} s; {torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    for name in calls:
        counted(name, "int8, shift", want)
    profile_run("int8 call A", lambda: timed_generate(runner, calls, "A")[1])
    # "int8" prefills with the bf16 tree and decodes with the int8 one, so the
    # bf16 call's cuBLAS time less this call's is what bf16 spends on the decode
    if "call A" in PROFILES and "int8 call A" in PROFILES:
        bf, q = PROFILES["call A"], PROFILES["int8 call A"]
        cov = q["covered"]
        log(f"[int8] call A decode matmuls: int8 kernels busy {cov.get('int8_matmul', 0) + cov.get('fused_mlp', 0):.4f} s "
            f"of device time (int8_matmul {cov.get('int8_matmul', 0):.4f}, fused_mlp "
            f"{cov.get('fused_mlp', 0):.4f}; their kernel durations sum to "
            f"{q['int8_matmul'] + q['fused_mlp'] + q['int8 split-K reduce']:.4f}) against bf16 "
            f"cuBLAS {bf['matmuls'] - q['matmuls']:.4f} s (bf16 call A {bf['matmuls']:.4f} s of "
            f"matmuls, 'int8' call A {q['matmuls']:.4f} s)")

    batch = batch_of("A")
    deq = dequantized_tree(runner.decode_params)
    a = first_step_logits(batch, runner.decode_params)
    b = first_step_logits(batch, deq)
    del deq
    cos = _row_cosine(a, b)
    log(f"[int8] 8B first decode step (call A, beam {NUM_BEAMS}, shift): logits through the int8 "
        f"kernels vs a bf16 tree dequantized from the same handles: max abs diff "
        f"{(a - b).abs().max().item():.4f} of max |logit| {b.abs().max().item():.4f}, min row "
        f"cosine {cos:.6f} (need >= {MIN_LOGIT_COSINE})")
    if a.shape != (4 * NUM_BEAMS, cfg.text.vocab_size) or not torch.isfinite(a).all():
        raise AssertionError(f"8B int8 logits: shape {tuple(a.shape)} or non-finite values")
    if cos < MIN_LOGIT_COSINE:
        raise AssertionError("8B int8 logits disagree with the dequantized bf16 path")

    # 2. call B without a shift: Tp = 4096 >= 1024 turns the int8 prompt KV on
    runner.set_shift(None)
    counted("B", "int8, no shift: int8 prompt KV", {**want, "prompt_attn_int8": steps * L})
    # QUANT_KV_MIN_PROMPT (1024): quant_kv on against off at Tp 4096 (call B) and at
    # Tp 1024 (call B's images with a 800-character context: the gate itself)
    images_b = calls["B"][0]
    short = runner.process_input(
        images_b, [f"Image:<image> {synthetic_text(60 + i, 800)}Question: what is in the image? "
                   f"Answer:" for i in range(2)], pad_to=1024)
    for tp, batch in ((4096, batch_of("B")), (1024, short)):
        times = {True: [], False: []}
        for quant_kv in (True, False):  # warm-up
            beam(batch, MAX_NEW_TOKENS, runner.decode_params, quant_kv=quant_kv)
        for quant_kv in (True, False, True, False):
            torch.cuda.synchronize()
            t = time.perf_counter()
            beam(batch, MAX_NEW_TOKENS, runner.decode_params, quant_kv=quant_kv)
            torch.cuda.synchronize()
            times[quant_kv].append(time.perf_counter() - t)
        log(f"[int8] QUANT_KV_MIN_PROMPT cut-off, call B without a shift at Tp {tp} "
            f"({batch.input_ids.shape[1]} prompt slots) through beam_generate: quant_kv on "
            f"{', '.join(f'{t:.3f}' for t in times[True])} s, off "
            f"{', '.join(f'{t:.3f}' for t in times[False])} s")
    batch = batch_of("B")
    on = first_step_logits(batch, runner.decode_params, quant_kv=True)
    off = first_step_logits(batch, runner.decode_params, quant_kv=False)
    cos = _row_cosine(on, off)
    log(f"[int8] call B without a shift, first decode step logits quant_kv on vs off: "
        f"max abs diff {(on - off).abs().max().item():.4f}, min row cosine {cos:.6f} "
        f"(need >= {MIN_LOGIT_COSINE})")
    if cos < MIN_LOGIT_COSINE or not torch.isfinite(on).all():
        raise AssertionError("8B int8 prompt-KV logits disagree with the bf16 prompt KV")
    runner.set_shift(shift)

    # 3. "int8-memory": one int8 tree serves the prefill and the decode steps
    t0 = time.perf_counter()
    runner.set_quant("int8-memory")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(f"[int8] set_quant('int8-memory'): {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    # the prefill's lm head (M = 4) is the one kernel launch outside the decode steps
    counted("A", "int8-memory, shift", {**want, "int8_matmul": want["int8_matmul"] + 1})
    log(f"[int8] int8-memory: peak device memory over call A {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB, {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated after it")
    return totals


# ---------------------------------------------------------------------------
# phases 9-11: the W8A8 eval path
# ---------------------------------------------------------------------------


def check_w8a8(label, seed, M, K, N, layers, layer, reps, n_real=0, timed=True):
    """w8a8_matmul (stacked when ``layers``) on rows quantized by quantize_rows
    against w8a8_matmul_plain: fp32 and bf16 outputs must be EQUAL (the int32 sum
    is exact and both multiply (acc * s_x) * s_w).  ``n_real``: a lane-padded
    handle through qdot's a8 branch (scale padded, output sliced).  Timed as
    device time through CUDA graphs with the layer cycling through a stack
    larger than L2, beside torch._int_mm + the two scale multiplies, the
    dequantize + bf16 torch.matmul path, and a bf16 torch.matmul on a bf16 copy
    of the weights (the product the mode stands in for; never called by the
    port); and quantize_rows of the input, kernel against its plain version."""
    from mimic_tpu_torch.ops import quant as tq

    gen = torch.Generator(device="cuda").manual_seed(seed)
    wq, scale = _int8_weight(gen, (layers, K, N) if layers else (K, N), 4e-4)
    x = (torch.randn(M, K, generator=gen, device="cuda")
         * (torch.rand(M, 1, generator=gen, device="cuda") * 4 + 0.25)).to(torch.bfloat16)
    x8, xs = tq.quantize_rows(x)
    worst = 0.0
    if n_real:
        wq[..., n_real:] = 0
        handle = {"q8": wq, "scale": scale[..., :n_real].contiguous(),
                  "a8": torch.zeros(0, dtype=torch.int8, device="cuda")}
        pairs = [(tq.qdot(x, handle, preferred_element_type=dt),
                  tq.w8a8_matmul_plain(x8, xs, wq[:, :n_real], handle["scale"], dt))
                 for dt in (torch.float32, torch.bfloat16)]
    elif layers:
        pairs = [(tq.w8a8_matmul_stacked(x8, xs, wq, scale, layer, out_dtype=dt),
                  tq.w8a8_matmul_plain(x8, xs, wq[layer], scale[layer], dt))
                 for dt in (torch.float32, torch.bfloat16)]
    else:
        pairs = [(tq.w8a8_matmul(x8, xs, wq, scale, out_dtype=dt),
                  tq.w8a8_matmul_plain(x8, xs, wq, scale, dt))
                 for dt in (torch.float32, torch.bfloat16)]
    torch.cuda.synchronize()
    for got, want in pairs:
        if got.shape != want.shape or got.dtype != want.dtype or not torch.isfinite(got).all():
            raise AssertionError(f"{label}: {tuple(got.shape)} {got.dtype} or non-finite values")
        worst = max(worst, (got.float() - want.float()).abs().max().item())
        if not torch.equal(got, want):
            raise AssertionError(f"{label}: {got.dtype} output differs from the plain version "
                                 f"(max abs err {worst}); it must be equal bit for bit")
    ref = pairs[0][1].abs().max().item()
    del pairs
    n_out = n_real or N
    b = bound(nbytes(x8, xs) + K * n_out + 4 * n_out + 2 * M * n_out, 2 * M * K * n_out, "int8")
    result = {"name": "w8a8_matmul", "max_abs_err": worst, "bound_ms": b["bound_ms"],
              "bound_by": b["bound_by"]}
    if not timed:
        log(f"[w8a8] {label}: w8a8_matmul M{M} K{K} N{n_out}"
            f"{f' layer {layer} of {layers}' if layers else ''}: fp32 and bf16 outputs equal to "
            f"the plain version's (max abs err {worst}, max |ref| {ref:.3f})")
        return result
    nl = max(layers, 1)
    sel = (lambda l: (wq[l], scale[l])) if layers else (lambda l: (wq, scale))
    ms = cold_ms(lambda l: tq.w8a8_matmul_stacked(x8, xs, wq, scale, l) if layers
                 else tq.w8a8_matmul(x8, xs, wq, scale), nl, reps, True)
    plain_ms = cold_ms(lambda l: tq.w8a8_matmul_plain(x8, xs, *sel(l)), nl, max(reps // 4, 2), True)

    def int_mm(l):
        w, sw = sel(l)
        return ((torch._int_mm(x8, w).float() * xs[:, None]) * sw[None, :]).to(torch.bfloat16)

    if not torch.equal(int_mm(layer), tq.w8a8_matmul_plain(x8, xs, *sel(layer))):
        raise AssertionError(f"{label}: torch._int_mm + scales differs from the plain version")
    library_ms = cold_ms(int_mm, nl, reps, True)
    product_ms = cold_ms(lambda l: torch._int_mm(x8, sel(l)[0]), nl, reps, True)
    deq_ms = cold_ms(lambda l: x @ tq.dequantize(
        {"q8": wq, "scale": scale, "layer": l if layers else None}).to(x.dtype), nl, reps, True)
    wb = wq.to(torch.bfloat16)
    bf16_ms = cold_ms(lambda l: x @ (wb[l] if layers else wb), nl, reps, True)
    del wb
    rows = quantize_rows_times(x, reps)
    log(f"[w8a8] {label}: w8a8_matmul M{M} K{K} N{n_out}"
        f"{f' layer {layer} of {layers}' if layers else ''}: fp32 and bf16 outputs equal to the "
        f"plain version's (max abs err {worst}, max |ref| {ref:.3f}); kernel {ms:.4f} ms "
        f"({2 * M * K * n_out / ms / 1e9:.1f} TOP/s, {b['bound_ms'] / ms:.1%} of the bound), "
        f"plain (float64 GEMM) {plain_ms:.4f} ms, torch._int_mm + two scale multiplies "
        f"{library_ms:.4f} ms (its int32 product alone {product_ms:.4f} ms), dequantize + bf16 "
        f"torch.matmul {deq_ms:.4f} ms; yardstick, bf16 torch.matmul on a bf16 copy of the "
        f"weights {bf16_ms:.4f} ms (kernel / bf16 {ms / bf16_ms:.2f}); {bound_text(b)} "
        f"(device time through CUDA graphs)")
    result.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, rows=rows)
    return result


def quantize_rows_times(x, reps):
    """quantize_rows on ``x`` (the kernel on the card) against its plain version,
    device time through CUDA graphs, and the bound of its bytes (x read, x8 and
    s written once)."""
    from mimic_tpu_torch.ops import quant as tq

    M, K = x.shape
    plain = getattr(tq, "quantize_rows_plain", tq.quantize_rows)
    ms = cuda_ms(lambda: tq.quantize_rows(x), reps, True)
    plain_ms = cuda_ms(lambda: plain(x), reps, True)
    b = bound(nbytes(x) + M * K + 4 * M, 0, "bf16")
    log(f"[w8a8] quantize_rows [{M}, {K}] {str(x.dtype).replace('torch.', '')}: kernel "
        f"{ms:.4f} ms ({b['bound_ms'] / ms:.1%} of the bound), plain {plain_ms:.4f} ms; "
        f"{bound_text(b)}; no PyTorch call quantizes rows (device time through CUDA graphs)")
    return {"name": "quantize_rows", "ms": ms, "plain_ms": plain_ms, "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"], "library_ms": None}


def w8a8_crossover():
    """W8A8_MIN_M against the weight-only path: at the q/k/v shape (K 4096, N
    6144, a 32-layer stack cycled as cold_ms does) for M 256, 384 and 480, the
    W8A8 prefill (quantize_rows + w8a8_matmul) against int8_matmul on the same
    bf16 rows, device time through CUDA graphs."""
    from mimic_tpu_torch.ops import quant as tq

    gen = torch.Generator(device="cuda").manual_seed(48)
    wq, scale = _int8_weight(gen, (32, 4096, 6144), 4e-4)
    for M in (256, 384, 480):
        x = torch.randn(M, 4096, generator=gen, device="cuda").to(torch.bfloat16)
        w8a8 = cold_ms(lambda l: tq.w8a8_matmul_stacked(*tq.quantize_rows(x), wq, scale, l),
                       32, 32, True)
        weight_only = cold_ms(lambda l: tq.int8_matmul_stacked(x, wq, scale, l), 32, 32, True)
        log(f"[w8a8] W8A8_MIN_M cut-off, q/k/v M{M}: quantize_rows + w8a8_matmul {w8a8:.4f} ms, "
            f"int8_matmul {weight_only:.4f} ms ({'W8A8' if w8a8 < weight_only else 'weight-only'} "
            f"faster)")


def phase_w8a8_kernels():
    """w8a8_matmul at idefics2-8b's prefill shapes of call A (M = 4 x 512): the
    fused q/k/v, o, gate/up and down projections, stacked at a layer other than
    0; then a ragged M, a lane-padded N through qdot, and a K that is no
    multiple of the 128-byte tile; and quantize_rows on the card against the CPU."""
    from mimic_tpu_torch.ops import quant as tq

    results = [
        check_w8a8("qkv-2048", 40, 2048, 4096, 6144, 4, 3, reps=16),
        check_w8a8("o-2048", 41, 2048, 4096, 4096, 6, 5, reps=16),
        check_w8a8("gateup-2048", 42, 2048, 4096, 28672, 2, 1, reps=8),
        check_w8a8("down-2048", 43, 2048, 14336, 4096, 2, 1, reps=8),
        check_w8a8("ragged-1000", 44, 1000, 4096, 6144, 2, 1, reps=0, timed=False),
        check_w8a8("padded-n", 45, 300, 256, 384, 0, 0, reps=0, n_real=300, timed=False),
        check_w8a8("k-80", 46, 257, 80, 144, 0, 0, reps=0, timed=False),
    ]
    gen = torch.Generator(device="cuda").manual_seed(47)
    worst = 0
    for dtype in (torch.float32, torch.bfloat16):
        for K in (80, 4096, 14336):
            x = (torch.randn(2048, K, generator=gen, device="cuda") * 3).to(dtype)
            x[5] = 0  # an all-zero row takes the 1e-8 floor
            on_card, on_cpu = tq.quantize_rows(x), tq.quantize_rows(x.cpu())
            worst = max(worst, (on_card[0].cpu().int() - on_cpu[0].int()).abs().max().item(),
                        (on_card[1].cpu() - on_cpu[1]).abs().max().item())
            if not all(torch.equal(a.cpu(), b) for a, b in zip(on_card, on_cpu)):
                raise AssertionError(f"quantize_rows ({dtype}, K {K}) on the card differs from "
                                     f"the CPU's")
    log("[w8a8] quantize_rows [2048, 80 / 4096 / 14336] fp32 and bf16: int8 rows and fp32 "
        "scales on the card bit-identical to the CPU's")
    summary = {"max_abs_err": max(r["max_abs_err"] for r in results)}
    # the times kept are those of the largest product of the path, gate/up
    summary.update({k: results[2][k] for k in TIMING_KEYS})
    # quantize_rows: its time at the K 4096 rows that feed three of the four products
    rows = {"max_abs_err": worst, **{k: results[0]["rows"][k] for k in TIMING_KEYS}}
    return {"w8a8_matmul": summary, "quantize_rows": rows}


def qdot_w8a8_plain(x, w, preferred_element_type=None):
    """``qdot`` with the a8 branch through the plain W8A8 functions, wherever the
    tensors lie: the reference of the tiny W8A8 phase on the CPU (where ``qdot``
    itself ignores the marker, as the JAX package does off the TPU) and of the
    8B prefill on the card."""
    from mimic_tpu_torch.ops import quant as tq

    xm = x.reshape(-1, x.shape[-1])
    if not (tq.is_quantized(w) and "a8" in w and xm.shape[0] >= tq.W8A8_MIN_M):
        return tq.qdot(x, w, preferred_element_type)
    wq, scale, layer = w["q8"], w["scale"], w.get("layer")
    n = scale.shape[-1]
    if wq.shape[-2] != xm.shape[1]:  # pad_k storage
        xm = torch.nn.functional.pad(xm, (0, wq.shape[-2] - xm.shape[1]))
    scale = torch.nn.functional.pad(scale, (0, wq.shape[-1] - n))
    if layer is not None:
        wq, scale = wq[layer], scale[layer]
    x8, xs = tq.quantize_rows(xm)
    # the plain version by name: on a CUDA tensor the wrapper would launch the kernel
    out = tq.w8a8_matmul_plain(x8, xs, wq, scale, preferred_element_type or x.dtype)
    return out[:, :n].reshape(*x.shape[:-1], n)


# A rounding of x / s that lands within an ulp of a half flips between the card
# and the CPU when their fp32 activations differ in the last bits; one flipped
# int8 step moves a row's product by about 1/127 of its largest term.
TOL_TINY_W8A8 = 5e-3


def phase_tiny_w8a8():
    """The tiny fp32 idefics2 of phase 7 in "int8-w8a8": 2 requests x 128 prompt
    slots = 256 rows, so every text prefill matmul takes w8a8_matmul."""
    from mimic_tpu_torch.config import get_preset
    from mimic_tpu_torch.models import decoder as td
    from mimic_tpu_torch.models import generate as tg
    from mimic_tpu_torch.models.lvlm import init_lvlm_params
    from mimic_tpu_torch.models.runner import LVLMRunner
    from mimic_tpu_torch.models.tokenizer import SimpleTokenizer
    from mimic_tpu_torch.shift.params import init_shift_params

    tk = SimpleTokenizer(padding_side="left")
    cfg = tiny_cfg(tk, hidden_size=128)
    L = cfg.text.num_layers
    cpu = torch.device("cpu")
    params = init_lvlm_params(cfg, torch.Generator().manual_seed(0), cpu)
    shift = init_shift_params(get_preset("mimic")[0], cfg.text, torch.Generator().manual_seed(1), cpu)
    rng = np.random.default_rng(8)
    images = [[rng.integers(0, 255, (70, 70, 3)).astype(np.uint8)] for _ in range(2)]
    texts = ["Image:<image> Question: what is it? Answer:",
             "Image:<image> Question: and what colour is the thing on the left? Answer:"]
    runners = {dev: LVLMRunner(cfg, params, SimpleTokenizer(padding_side="left"), device=dev,
                               quant="int8-w8a8") for dev in ("cpu", "cuda")}
    if not _same_tree_bytes(runners["cpu"].params, runners["cuda"].params):
        raise AssertionError("tiny w8a8: the int8 tree quantized on the card differs from the CPU's")
    layers = runners["cuda"].params["lm"]["decoder"]["layers"]
    marked = sorted(k for k, v in layers.items() if isinstance(v, dict) and "a8" in v)
    if marked != ["down_proj", "gateup_proj", "o_proj", "qkv_proj"]:
        raise AssertionError(f"tiny w8a8: a8 markers on {marked}")
    new = 6
    logits, tokens = {}, {}
    for dev, r in runners.items():
        r.set_shift(shift)
        batch = r.process_input(images, texts, pad_to=128)
        _reset_int8_counts()
        orig = td.qdot
        if dev == "cpu":
            td.qdot = qdot_w8a8_plain
        try:
            with LogitSpy() as spy:
                tokens[dev] = tg.beam_generate(
                    r.params, cfg, batch, max_new_tokens=new, num_beams=NUM_BEAMS,
                    eos_token_id=tk.eos_token_id, pad_token_id=tk.pad_token_id, shift=r.shift,
                    logz2="unmasked", attn_impl="flash" if dev == "cuda" else "xla",
                ).tokens.cpu()
        finally:
            td.qdot = orig
        logits[dev] = spy.logits[0].cpu()
    torch.cuda.synchronize()
    launches = _int8_counts()
    # the prefill: 4 W8A8 matmuls per layer and the lm head at M = 2; then
    # new - 1 decode steps as in "int8-memory"
    want = {"w8a8_matmul": 4 * L, "quantize_rows": 4 * L,
            "int8_matmul": (new - 1) * (2 * L + 1) + 1,
            "fused_mlp_int8": (new - 1) * L, "prompt_attn_int8": 0}
    err = (logits["cuda"] - logits["cpu"]).abs().max().item()
    close = torch.allclose(logits["cuda"], logits["cpu"], rtol=TOL_TINY_W8A8, atol=TOL_TINY_W8A8)
    log(f"[tiny-w8a8] fp32, quant='int8-w8a8' with a MimIC shift: int8 trees bit-identical, a8 on "
        f"{marked}; prefill logits, w8a8_matmul on the card vs the plain W8A8 functions on the "
        f"CPU: max abs err {err:.3e} of max |logit| {logits['cpu'].abs().max().item():.3f} "
        f"(rtol = atol = {TOL_TINY_W8A8}, a flipped activation rounding moves a row by ~1/127 of "
        f"a term: {close}); beam-3 tokens card {tokens['cuda'].tolist()} CPU "
        f"{tokens['cpu'].tolist()} identical: {torch.equal(tokens['cuda'], tokens['cpu'])}; "
        f"launches {launches} (want {want})")
    if not close or launches != want:
        raise AssertionError("tiny w8a8 slice: the kernel path disagrees with the plain path")


def synthetic_vqa_splits(n_train: int, n_val: int, size: int = 980):
    """VQA-shaped train and validation splits with random images, made from seeds."""

    def item(i, split):
        word = WORDS[i % len(WORDS)]
        return {
            "question": f"what is next to the {word} in picture {i}?",
            "question_id": i if split == "train" else 1000 + i,
            "question_type": "what is", "answer_type": "other",
            "answers": [{"answer": word, "answer_confidence": "yes", "answer_id": j}
                        for j in range(10)],
            "answer": word, "image_id": i,
            "image": np.random.default_rng(50 + i + (0 if split == "train" else 500)).integers(
                0, 256, size=(size, size, 3), dtype=np.uint8),
        }

    return {"train": [item(i, "train") for i in range(n_train)],
            "validation": [item(i, "val") for i in range(n_val)]}


EVAL_BATCH = 4
EVAL_BATCHES = 2
EVAL_BUCKET = 512


def phase_train_for_eval(runner, result_dir):
    """run_train on the bf16 8B runner: idefics2-8b-base's schedule for fewer
    than 100 queries saves from epoch 10 on, so 11 epochs of one B2 step each
    write epoch-10 (1-shot: two 980 px images per record row)."""
    from mimic_tpu_torch.config import TrainConfig, get_preset
    from mimic_tpu_torch.models.decoder import ATTN_PATH_LOG
    from mimic_tpu_torch.pipeline import train_entry

    enc, peft = get_preset("mimic")
    cfg = TrainConfig(runname="smoke", model_name="idefics2-8b-base", encoder=enc, peft=peft,
                      epochs=11, batch_size=2, accumulate_grad_batches=1)
    cfg.data.name, cfg.data.num_query_samples, cfg.data.num_shot = "vqav2", 2, 1
    # a query row (64 image tokens + the question, byte-level) passes the default
    # cap of 128 tokens, and a pass capped at its longest row is not 128-aligned
    cfg.data.max_query_len = 256
    made = []

    class CountedCache(train_entry.TrainVisionCache):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    ATTN_PATH_LOG.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_entry.TrainVisionCache = CountedCache
    try:
        state = train_entry.run_train(cfg, result_dir=result_dir, runner=runner,
                                      splits=synthetic_vqa_splits(6, 8))
    finally:
        train_entry.TrainVisionCache = CountedCache.__base__
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if len(made) != 1:
        raise AssertionError("run_train did not build its training vision cache")
    cache = made[0].cache
    log(f"[eval] run_train's training vision cache (on by default): {cache.hits} hits, "
        f"{cache.misses} misses, hit rate {cache.hit_rate:.3f}")
    ckpt = os.path.join(result_dir, "ckpt", "smoke-idefics2-8b-base-vqav2-2-1shot", "epoch-10")
    paths = list(ATTN_PATH_LOG)
    log(f"[eval] run_train (mimic preset, 1-shot, B2, 11 epochs x 1 step): {state.step} steps in "
        f"{secs:.1f} s; attention paths {sorted(set(paths))}; checkpoint {os.path.relpath(ckpt, result_dir)}")
    if state.step != 11 or set(paths) != {"flash"} or not os.path.exists(
            os.path.join(ckpt, "encoder.msgpack")):
        raise AssertionError(f"run_train: {state.step} steps, paths {set(paths)}, or no checkpoint")
    return ckpt, state.trainable["shift"]


def phase_eval_w8a8(ckpt, trained_shift, result_dir):
    """This slice's path: the eval entry builds idefics2-8b-base, loads the
    epoch checkpoint, applies quant="int8-w8a8" and answers 2 x 4 requests."""
    import gc

    from mimic_tpu_torch.models import generate as tg
    from mimic_tpu_torch.models.decoder import ATTN_PATH_LOG
    from mimic_tpu_torch.models.factory import build_model
    from mimic_tpu_torch.ops import flash_attention as tfa
    from mimic_tpu_torch.pipeline import cli

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    # the model the CLI's eval builds (random weights from seed 0, on the card)
    runner = build_model("idefics2-8b-base", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"[eval] build_model('idefics2-8b-base') on {runner.device}: {time.perf_counter() - t0:.1f} s")
    cfg = runner.cfg
    L = cfg.text.num_layers
    splits = synthetic_vqa_splits(6, EVAL_BATCH * EVAL_BATCHES)
    overrides = [
        "model_name=idefics2-8b-base", f"ckpt_path={ckpt}", "preset=mimic", "quant=int8-w8a8",
        f"batch_size={EVAL_BATCH}", f"iterations={EVAL_BATCHES}", "data.name=vqav2",
        f"data.num_query_samples={EVAL_BATCH * EVAL_BATCHES}", "data.num_shot=1",
        f"data.length_buckets=[{EVAL_BUCKET}]",
    ]

    def evaluate(tag):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = cli._eval(overrides + [f"result_dir={os.path.join(result_dir, tag)}"],
                        splits=splits, runner=runner)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    _, secs = evaluate("warm")  # loads the checkpoint and quantizes, then warms up
    log(f"[eval] warm-up eval (checkpoint load, set_quant('int8-w8a8'), {EVAL_BATCHES} batches): "
        f"{secs:.1f} s; {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    if runner.shift is None or not all(
            torch.equal(runner.shift[k].cpu(), v.cpu()) for k, v in trained_shift.items()):
        raise AssertionError("eval: the runner's shift is not the trained checkpoint's")
    layers = runner.params["lm"]["decoder"]["layers"]
    if not all("a8" in layers[k] for k in ("qkv_proj", "o_proj", "gateup_proj", "down_proj")):
        raise AssertionError("eval: the int8-w8a8 tree lacks its a8 markers")

    torch.cuda.reset_peak_memory_stats()
    _reset_int8_counts()
    tfa.reset_launch_counts()
    ATTN_PATH_LOG.clear()
    (records, metrics), secs = evaluate("counted")
    launches = {**tfa.LAUNCHES, **_int8_counts()}
    paths = list(ATTN_PATH_LOG)
    n = EVAL_BATCH * EVAL_BATCHES
    record_file = os.path.join(result_dir, "counted", "record",
                               "smoke-idefics2-8b-base-vqav2-2-1shot", "epoch-10.json")
    with open(record_file) as f:
        saved = json.load(f)
    steps = MAX_NEW_TOKENS - 1
    want = {"w8a8_matmul": EVAL_BATCHES * 4 * L, "quantize_rows": EVAL_BATCHES * 4 * L,
            "int8_matmul": EVAL_BATCHES * (steps * (2 * L + 1) + 1),
            "fused_mlp_int8": EVAL_BATCHES * steps * L, "prompt_attn_int8": 0}
    log(f"[eval] python -m mimic_tpu_torch eval {' '.join(overrides[:4])} ...: {n} requests "
        f"(batch {EVAL_BATCH}, bucket {EVAL_BUCKET}, beam {NUM_BEAMS}, {MAX_NEW_TOKENS} new tokens, "
        f"shift active) in {secs:.3f} s = {n / secs:.3f} q/s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; record "
        f"{os.path.relpath(record_file, result_dir)} eval_result {json.dumps(saved['eval_result'])}; "
        f"launches {launches}; raw outputs {json.dumps([r['raw_output'] for r in records])}")
    vc = runner.vision_cache
    if vc is None or vc.misses == 0:
        raise AssertionError("run_eval did not turn the vision cache on")
    log(f"[eval] the eval's vision cache (on by default; set_quant empties it at each eval): "
        f"{vc.hits} hits, {vc.misses} misses over both evals, hit rate {vc.hit_rate:.3f}")
    got = {k: launches[k] for k in want}
    if got != want or launches["onepass_fwd"] == 0:
        raise AssertionError(f"eval: launches {launches}, want {want}")
    if paths != (["flash"] + ["cached"] * steps) * EVAL_BATCHES:
        raise AssertionError(f"eval: unexpected attention paths {paths}")
    if (len(records) != n or len(saved["records"]) != n or "overall" not in saved["eval_result"]
            or saved["eval_result"] != metrics or saved["eval_config"]["quant"] != "int8-w8a8"
            or not all(isinstance(r["raw_output"], str) for r in records)):
        raise AssertionError(f"eval: bad record {saved['eval_result']} / {len(records)} records")

    # first-step logits against a bf16 tree dequantized from the same handles
    calls = serving_calls()
    images, texts, bucket = calls["A"]
    runner.tokenizer.padding_side = "left"  # as generate() pads
    batch = runner.process_input(images, texts, pad_to=bucket)
    tok = runner.tokenizer

    def first_logits(params):
        with LogitSpy() as spy:
            tg.beam_generate(params, cfg, batch, max_new_tokens=2, num_beams=NUM_BEAMS,
                             eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id,
                             shift=runner.shift, logz2=runner.logz2, attn_impl="flash")
        return spy.logits[:2]

    a = first_logits(runner.params)
    deq = dequantized_tree(runner.params)
    b = first_logits(deq)
    del deq
    cos = [_row_cosine(x, y) for x, y in zip(a, b)]
    same_beams = torch.equal(a[0].topk(NUM_BEAMS).indices, b[0].topk(NUM_BEAMS).indices)
    log(f"[eval] 8B call A in 'int8-w8a8' vs a bf16 tree dequantized from the same handles: "
        f"first-step (prefill) logits min row cosine {cos[0]:.6f} (need >= {MIN_W8A8_COSINE}), max "
        f"abs diff {(a[0] - b[0]).abs().max().item():.4f} of max |logit| "
        f"{b[0].abs().max().item():.4f}; first decode step {cos[1]:.6f}, not held to a bound: the "
        f"two runs' beams chose {'the same' if same_beams else 'different'} first tokens, so their "
        f"second steps read {'the same' if same_beams else 'different'} inputs")
    if cos[0] < MIN_W8A8_COSINE or not all(torch.isfinite(x).all() for x in a):
        raise AssertionError("8B int8-w8a8 logits disagree with the dequantized bf16 path")

    # where that difference comes from, and that none of it is the kernel's: one
    # prefill with every W8A8 product held against the weight-only product of the
    # same rows, then one through the plain W8A8 functions, which must give the
    # kernel path's logits bit for bit
    from mimic_tpu_torch.models import decoder as td
    from mimic_tpu_torch.models.lvlm import encode_images
    from mimic_tpu_torch.ops import quant as tq

    with torch.no_grad():
        feats = encode_images(runner.params, cfg, batch.pixel_values, batch.patch_mask,
                              attn_impl="flash")
    text_batch = batch._replace(pixel_values=None, patch_mask=None)
    kinds = {(4096, 6144): "qkv", (4096, 4096): "o", (4096, 28672): "gate/up", (14336, 4096): "down"}
    stats = {k: [] for k in kinds.values()}
    orig_qdot = td.qdot

    def spy_qdot(x, w, preferred_element_type=None):
        out = orig_qdot(x, w, preferred_element_type)
        xm = x.reshape(-1, x.shape[-1])
        if tq.is_quantized(w) and "a8" in w and xm.shape[0] >= tq.W8A8_MIN_M:
            ref = (xm @ tq.dequantize(w).to(x.dtype)).float()
            got = out.reshape(ref.shape).float()
            xf = xm.float()
            # rounding a row to steps of amax / 127 adds noise of variance step^2 / 12
            # to each element: relative to the row's mean square, (peak / rms)^2 / (12 * 127^2)
            noise = ((xf.abs().amax(-1) / 127) ** 2 / 12 / xf.pow(2).mean(-1).clamp_min(1e-30))
            crest = xf.abs().amax(-1) / xf.pow(2).mean(-1).clamp_min(1e-30).sqrt()
            stats[kinds[(xm.shape[1], ref.shape[1])]].append(
                (((got - ref).norm() / ref.norm()).item(), noise.mean().sqrt().item(),
                 crest.mean().item()))
        return out

    def prefill_with(qdot_fn):
        td.qdot = qdot_fn
        try:
            return lvlm_prefill(runner.params, cfg, text_batch, feats, bucket, runner)
        finally:
            td.qdot = orig_qdot

    before = tq.LAUNCHES["w8a8_matmul"]
    through_kernel = prefill_with(spy_qdot)
    launched = tq.LAUNCHES["w8a8_matmul"] - before
    through_plain = prefill_with(qdot_w8a8_plain)
    torch.cuda.synchronize()
    equal = torch.equal(through_kernel, through_plain) and tq.LAUNCHES["w8a8_matmul"] == before + launched
    log("[eval] call A prefill, every W8A8 product against the weight-only product of the same "
        "rows, mean over 32 layers of |diff| / |ref| (and what rounding the rows alone predicts, "
        "from their peak / rms): " + "; ".join(
            f"{k} {np.mean([r[0] for r in v]):.4f} (predicted {np.mean([r[1] for r in v]):.4f}, "
            f"peak/rms {np.mean([r[2] for r in v]):.1f})" for k, v in stats.items())
        + f". Prefill logits through w8a8_matmul ({launched} launches) equal to those through "
          f"the plain W8A8 functions on the card, bit for bit: {equal} (max abs diff "
          f"{(through_kernel.float() - through_plain.float()).abs().max().item()})")
    if not equal or launched != 4 * L or any(len(v) != L for v in stats.values()):
        raise AssertionError("8B int8-w8a8 prefill: the kernel path differs from the plain W8A8 path")

    # the prefill in "int8-w8a8" beside "int8-memory" (the same tree without its
    # a8 markers) on call A, by CUDA events, in turns
    from mimic_tpu_torch.ops.quant import is_quantized

    def strip(tree):
        if is_quantized(tree):
            return {k: v for k, v in tree.items() if k != "a8"}
        return {k: strip(v) for k, v in tree.items()} if isinstance(tree, dict) else tree

    trees = {"int8-w8a8": runner.params, "int8-memory": strip(runner.params)}

    def prefill_ms(mode, feats):
        b2 = batch if feats is None else batch._replace(pixel_values=None, patch_mask=None)
        fn = lambda: lvlm_prefill(trees[mode], cfg, b2, feats, bucket, runner)
        return cuda_ms(fn, 2)

    order = ("int8-memory", "int8-w8a8", "int8-w8a8", "int8-memory")
    whole = {m: [] for m in trees}
    text = {m: [] for m in trees}
    for mode in order:
        whole[mode].append(prefill_ms(mode, None))
    for mode in order:
        text[mode].append(prefill_ms(mode, feats))
    log("[eval] call A prefill (M = 2048 rows) by CUDA events, ms: whole prefill "
        + ", ".join(f"{m} {', '.join(f'{t:.1f}' for t in ts)}" for m, ts in whole.items())
        + "; text tower alone (image features given) "
        + ", ".join(f"{m} {', '.join(f'{t:.1f}' for t in ts)}" for m, ts in text.items()))
    profile_run("int8-w8a8 call A", lambda: timed_generate(runner, calls, "A")[1])
    return launches


# ---------------------------------------------------------------------------
# phase 12: the vision-feature caches, sampling and the checkpoint converter
# ---------------------------------------------------------------------------

# the cached step against the uncached one on the same state and batch: the
# features are the same encode's (18 record-pass images in one call either
# way), so the two losses differ by bf16 summation order at most
CACHED_LOSS_REL = 1e-3
# wall seconds of the train step, by form (phase 5 and phase 12), for the summary
STEP_SECONDS = {}


class ResultSpy:
    """Records the ``GenerateResult`` of every greedy / beam / sample call the
    runner makes (``runner.generate`` returns decoded strings, and with random
    weights most token ids decode to nothing)."""

    NAMES = ("greedy_generate", "beam_generate", "sample_generate")

    def __init__(self):
        from mimic_tpu_torch.models import runner as trunner

        self.mod, self.results = trunner, []

    def __enter__(self):
        self.orig = {n: getattr(self.mod, n) for n in self.NAMES}
        for n, fn in self.orig.items():
            def spy(*args, _fn=fn, **kwargs):
                out = _fn(*args, **kwargs)
                self.results.append(out)
                return out
            setattr(self.mod, n, spy)
        return self

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.mod, n, fn)


def _bits_equal_tree(a, b) -> bool:
    """Keys, dtypes, shapes and bits equal, compared on the tensors' device."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _bits_equal_tree(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


_VIT_HF = (("ln1_w", "layer_norm1.weight", False), ("ln1_b", "layer_norm1.bias", False),
           ("q_proj", "self_attn.q_proj.weight", True), ("q_bias", "self_attn.q_proj.bias", False),
           ("k_proj", "self_attn.k_proj.weight", True), ("k_bias", "self_attn.k_proj.bias", False),
           ("v_proj", "self_attn.v_proj.weight", True), ("v_bias", "self_attn.v_proj.bias", False),
           ("o_proj", "self_attn.out_proj.weight", True),
           ("o_bias", "self_attn.out_proj.bias", False),
           ("ln2_w", "layer_norm2.weight", False), ("ln2_b", "layer_norm2.bias", False),
           ("fc1", "mlp.fc1.weight", True), ("fc1_bias", "mlp.fc1.bias", False),
           ("fc2", "mlp.fc2.weight", True), ("fc2_bias", "mlp.fc2.bias", False))
_DECODER_HF = (("input_ln", "input_layernorm.weight", False),
               ("q_proj", "self_attn.q_proj.weight", True),
               ("k_proj", "self_attn.k_proj.weight", True),
               ("v_proj", "self_attn.v_proj.weight", True),
               ("o_proj", "self_attn.o_proj.weight", True),
               ("post_ln", "post_attention_layernorm.weight", False),
               ("gate_proj", "mlp.gate_proj.weight", True), ("up_proj", "mlp.up_proj.weight", True),
               ("down_proj", "mlp.down_proj.weight", True))
_PERCEIVER_HF = (("ln_latents", "input_latents_norm.weight", False),
                 ("ln_context", "input_context_norm.weight", False),
                 ("q_proj", "self_attn.q_proj.weight", True),
                 ("k_proj", "self_attn.k_proj.weight", True),
                 ("v_proj", "self_attn.v_proj.weight", True),
                 ("o_proj", "self_attn.o_proj.weight", True),
                 ("post_ln", "post_attention_layernorm.weight", False),
                 ("gate_proj", "mlp.gate_proj.weight", True),
                 ("up_proj", "mlp.up_proj.weight", True),
                 ("down_proj", "mlp.down_proj.weight", True))


def hf_state_dict(tree, cfg):
    """An idefics2 parameter tree under HF's ``Idefics2ForConditionalGeneration``
    names and layouts, on the tree's device (the inverse of
    ``models/convert.py::convert_idefics2``): kernels back to [out, in],
    stacked layers one tensor per layer, the dense patch kernel back to a conv
    kernel [D, C, p, p]."""
    sd = {}

    def unstack(prefix, stacked, names):
        for name, hf, transposed in names:
            for i, w in enumerate(stacked[name].unbind(0)):
                sd[f"{prefix}{i}.{hf}"] = w.T.contiguous() if transposed else w.contiguous()

    lm, vis, conn = tree["lm"], tree["vision"], tree["connector"]
    sd["model.text_model.embed_tokens.weight"] = lm["embed"]
    unstack("model.text_model.layers.", lm["decoder"]["layers"], _DECODER_HF)
    sd["model.text_model.norm.weight"] = lm["decoder"]["final_ln"]
    sd["lm_head.weight"] = lm["lm_head"].T.contiguous()
    p = "model.vision_model."
    kernel = vis["patch_embed"]["kernel"]  # [p*p*C, D]
    ps = cfg.vision.patch_size
    sd[p + "embeddings.patch_embedding.weight"] = kernel.reshape(
        ps, ps, kernel.shape[0] // (ps * ps), kernel.shape[1]).permute(3, 2, 0, 1).contiguous()
    sd[p + "embeddings.patch_embedding.bias"] = vis["patch_embed"]["bias"]
    sd[p + "embeddings.position_embedding.weight"] = vis["pos_embed"]
    unstack(p + "encoder.layers.", vis["layers"], _VIT_HF)
    sd[p + "post_layernorm.weight"] = vis["post_ln_w"]
    sd[p + "post_layernorm.bias"] = vis["post_ln_b"]
    for name, hf in (("gate", "gate_proj"), ("up", "up_proj"), ("down", "down_proj")):
        sd[f"model.connector.modality_projection.{hf}.weight"] = \
            conn["modality_proj"][name].T.contiguous()
    r = "model.connector.perceiver_resampler."
    sd[r + "latents"] = conn["latents"]
    unstack(r + "layers.", conn["layers"], _PERCEIVER_HF)
    sd[r + "norm.weight"] = conn["final_ln"]
    return sd


_ST_NAMES = {torch.bfloat16: "BF16", torch.float16: "F16", torch.float32: "F32",
             torch.int64: "I64"}


def write_safetensors(path, tensors) -> None:
    """``tensors`` as one ``.safetensors`` file (an 8-byte little-endian header
    length, the JSON header padded to 8 bytes, the raw buffers in order)."""
    header, chunks, offset = {}, [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().cpu().contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        chunks.append(raw)
        offset += len(raw)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little") + head + b"".join(chunks))


def phase_cached_train(runner):
    """(a) The 8-shot step through TrainVisionCache at phase 5's batch."""
    from mimic_tpu_torch.config import get_preset
    from mimic_tpu_torch.models.decoder import ATTN_PATH_LOG
    from mimic_tpu_torch.models.feature_cache import image_key
    from mimic_tpu_torch.ops import flash_attention as tfa
    from mimic_tpu_torch.ops import flash_backward as tfb
    from mimic_tpu_torch.shift.params import (init_shift_params, multi_head, needs_attn_capture,
                                               needs_ffn_capture)
    from mimic_tpu_torch.train import step as ts
    from mimic_tpu_torch.train.collate import TrainBatch
    from mimic_tpu_torch.train.optim import build_optimizer
    from mimic_tpu_torch.train.vision_cache import TrainVisionCache

    cfg, frozen = runner.cfg, runner.params
    L = cfg.text.num_layers
    enc, peft = get_preset("mimic")
    shift = init_shift_params(enc, cfg.text, torch.Generator(device="cuda").manual_seed(2),
                              torch.device("cuda"))
    trainable = {"shift": shift}
    tx = build_optimizer(trainable, lr=peft.lr, weight_decay=1e-3, warmup_steps=10,
                         total_steps=1000, grad_clip=1.0)
    step = ts.make_train_step(cfg, enc, tx, ce_loss_weight=peft.ce_loss_weight,
                              align_loss_weight=peft.align_loss_weight, attn_impl="flash",
                              logz2="unmasked")
    state = ts.TrainState(trainable, tx.init(trainable), 0)
    batch = make_train_batch(cfg)
    # the same batch as the collator hands it over: host arrays and content keys
    host = {k: (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
            for k, v in batch.items()}
    keys = {p: [image_key(px) for px in host[f"{p}_pixels"].reshape(
        (-1,) + host[f"{p}_pixels"].shape[2:])] for p in ("full", "query")}
    tb = TrainBatch(query_ids=host["query_ids"], query_mask=host["query_mask"],
                    query_pixels=host["query_pixels"], query_pixel_mask=None, query_img_attn=None,
                    query_patch_mask=host["query_patch_mask"], full_ids=host["full_ids"],
                    full_mask=host["full_mask"], full_pixels=host["full_pixels"],
                    full_patch_mask=host["full_patch_mask"], prefix_q_idx=host["prefix_q_idx"],
                    shift_q_idx=host["shift_q_idx"], q_valid=host["q_valid"],
                    full_image_keys=keys["full"], query_image_keys=keys["query"])
    xform = TrainVisionCache(cfg, frozen)
    n_img = len(keys["full"]) + len(keys["query"])

    def run_step():
        nonlocal state
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, frozen, xform(tb))
        torch.cuda.synchronize()
        return m, time.perf_counter() - t

    tfa.reset_launch_counts()
    tfb.reset_launch_counts()
    m, cold = run_step()
    cold_launches = {**tfa.LAUNCHES, **tfb.LAUNCHES}
    log(f"[cache] cold cached step (TrainVisionCache, {n_img} images encoded into the cache): "
        f"{cold:.3f} s, loss {float(m['loss']):.6f}; launches {cold_launches}; cache "
        f"{xform.cache.misses} misses, {len(xform.cache)} entries, "
        f"{xform.cache.nbytes / 2**20:.1f} MiB")
    if xform.cache.misses != n_img or xform.cache.hits != 0:
        raise AssertionError(f"cold step: {xform.cache.misses} misses, {xform.cache.hits} hits")
    times, total = [], {}
    ATTN_PATH_LOG.clear()
    for i in range(TRAIN_STEPS):
        tfa.reset_launch_counts()
        tfb.reset_launch_counts()
        m, secs = run_step()
        launches = {**tfa.LAUNCHES, **tfb.LAUNCHES}
        times.append(secs)
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
        log(f"[cache] warm cached step {i + 1}: {secs:.3f} s; loss {float(m['loss']):.6g}, "
            f"grad_norm {float(m['grad_norm']):.6g}; launches {launches}")
        # no ViT rows: onepass_fwd only in the decoder, 2 passes x L layers
        want = {"onepass_fwd": 2 * L, "flash_fwd": 0, "flash_bwd_dq": L - 1, "flash_bwd_dkv": L - 1}
        if launches != want:
            raise AssertionError(f"warm cached step launched {launches}, want {want}")
        if not (np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0):
            raise AssertionError(f"warm cached step metrics {m}")
    if xform.cache.misses != n_img or xform.cache.hits != TRAIN_STEPS * n_img:
        raise AssertionError(f"warm steps missed the cache: {xform.cache.misses} misses, "
                             f"{xform.cache.hits} hits")
    if ATTN_PATH_LOG != ["flash"] * (2 * TRAIN_STEPS):
        raise AssertionError(f"a decoder call left the flash path: {ATTN_PATH_LOG}")
    STEP_SECONDS["cached, warm"] = times
    log(f"[cache] {TRAIN_STEPS} warm cached steps: mean {sum(times) / len(times):.3f} s/step "
        f"(min {min(times):.3f}, max {max(times):.3f}); phase 5 in this run: uncached "
        f"{', '.join(f'{t:.3f}' for t in STEP_SECONDS.get('uncached', []))} s, precomputed "
        f"features {', '.join(f'{t:.3f}' for t in STEP_SECONDS.get('precomputed', []))} s")
    profile_run("cached train step, warm", lambda: run_step()[1])

    # loss and shift gradients of the cached step against the uncached step,
    # on the same state and batch
    loss_kw = dict(cfg=cfg, strategy=enc.strategy(), rec_attn=needs_attn_capture(enc),
                   rec_ffn=needs_ffn_capture(enc), mh=multi_head(enc),
                   ce_loss_weight=peft.ce_loss_weight, align_loss_weight=peft.align_loss_weight,
                   logz2="unmasked", attn_impl="flash")
    grads, losses = {}, {}
    for name, b in (("cached", xform(tb)), ("uncached", batch)):
        leaves = {k: v.detach().requires_grad_(True) for k, v in state.trainable["shift"].items()}
        with torch.enable_grad():
            loss, _ = ts.compute_loss({"shift": leaves}, frozen, b, **loss_kw)
            grads[name] = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        losses[name] = float(loss.detach())
    cos = {k: torch.nn.functional.cosine_similarity(
        grads["cached"][k].flatten(), grads["uncached"][k].flatten(), dim=0).item()
        for k in grads["cached"]}
    rel = abs(losses["cached"] - losses["uncached"]) / abs(losses["uncached"])
    log(f"[cache] cached vs uncached step, same state and batch: loss {losses['cached']:.6f} vs "
        f"{losses['uncached']:.6f} (relative {rel:.2e}, need <= {CACHED_LOSS_REL}); per-leaf "
        f"gradient cosine {cos} (need >= {MIN_GRAD_COSINE})")
    if rel > CACHED_LOSS_REL or min(cos.values()) < MIN_GRAD_COSINE:
        raise AssertionError("the cached train step disagrees with the uncached step")
    del xform, state, grads
    torch.cuda.empty_cache()
    return total


def phase_cached_eval(runner):
    """(b) Call A through the runner's vision cache, cold and warm; misses
    deduplicated in a batch whose requests share a demo image."""
    from mimic_tpu_torch.ops import flash_attention as tfa

    calls = serving_calls()
    images, texts, bucket = calls["A"]
    runner.vision_cache = None
    with LogitSpy() as spy:
        timed_generate(runner, calls, "A")
    uncached_first = spy.logits[0]
    cache = runner.enable_vision_cache()
    out, launches = {}, {}
    for name in ("cold", "warm"):
        tfa.reset_launch_counts()
        with LogitSpy() as spy, ResultSpy() as res:
            strings, secs = timed_generate(runner, calls, "A")
        launches[name] = dict(tfa.LAUNCHES)
        out[name] = (res.results[0].tokens, spy.logits, secs)
        log(f"[cache] call A, cache {name}: {secs:.3f} s = {len(texts) / secs:.3f} q/s; cache "
            f"{cache.hits} hits, {cache.misses} misses so far; launches {launches[name]}")
    L, Lv = runner.cfg.text.num_layers, runner.cfg.vision.num_layers
    if cache.misses != 4 or cache.hits != 4:
        raise AssertionError(f"call A: {cache.misses} misses, {cache.hits} hits, want 4 and 4")
    # cold: one ViT encode of the 4 misses (Lv launches) and the prefill's L;
    # warm: the prefill's L alone, no ViT rows
    if launches["cold"]["onepass_fwd"] != Lv + L or launches["warm"]["onepass_fwd"] != L:
        raise AssertionError(f"call A launches {launches}, want {Lv + L} cold and {L} warm")
    same = torch.equal(out["cold"][0], out["warm"][0]) and all(
        torch.equal(a, b) for a, b in zip(out["cold"][1], out["warm"][1]))
    cos = _row_cosine(out["cold"][1][0], uncached_first)
    log(f"[cache] call A warm tokens and logits bit-identical to cold: {same}; tokens "
        f"{out['warm'][0].tolist()}; first-step logits, cached vs uncached runner: min row "
        f"cosine {cos:.6f} (need >= {MIN_LOGIT_COSINE})")
    if not same or cos < MIN_LOGIT_COSINE:
        raise AssertionError("the cached call A differs from itself or from the uncached runner")
    # wall time in pairs (the cache emptied before each cold call)
    walls = {"cold": [], "warm": []}
    for _ in range(3):
        for name in walls:
            if name == "cold":
                cache.clear()
            walls[name].append(timed_generate(runner, calls, "A")[1])
    log("[cache] call A in pairs, cold then warm: " + "; ".join(
        f"{k} {', '.join(f'{t:.3f} s ({len(texts) / t:.3f} q/s)' for t in v)}"
        for k, v in walls.items()))
    # the device time a warm call no longer spends: the encode of its 4 images
    from mimic_tpu_torch.models.lvlm import encode_images

    runner.tokenizer.padding_side = "left"  # as generate() pads
    batch = runner.process_input(images, texts, pad_to=bucket)
    with torch.no_grad():
        encode = cuda_ms(lambda: encode_images(runner.params, runner.cfg, batch.pixel_values,
                                               batch.patch_mask, attn_impl="flash"), 3)
    log(f"[cache] the encode a warm call A skips (4 images, ViT + connector, CUDA events): "
        f"{encode:.1f} ms")

    # four requests sharing one demo image: 5 distinct images in 8 slots
    demo = synthetic_image(70)
    shared = [[demo, synthetic_image(71 + i)] for i in range(4)]
    shared_texts = [f"Image:<image> Question: what is here? Answer: a cat\nImage:<image> "
                    f"{synthetic_text(80 + i, 150)} Question: what is here? Answer:"
                    for i in range(4)]
    cache = runner.enable_vision_cache()
    tfa.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    runner.generate(shared, shared_texts, num_beams=NUM_BEAMS, max_new_tokens=MAX_NEW_TOKENS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    log(f"[cache] 4 requests x 2 images sharing one demo image, cold cache: {secs:.3f} s; "
        f"{cache.misses} misses, {cache.hits} hits, {len(cache)} entries; launches "
        f"{dict(tfa.LAUNCHES)}")
    if (cache.misses, cache.hits, len(cache)) != (5, 3, 5) or \
            tfa.LAUNCHES["onepass_fwd"] != Lv + L:
        raise AssertionError("the shared demo image was not deduplicated into one encode")
    return launches["warm"]


def phase_sampling(runner):
    """(c) do_sample=True at call A's shape (and once at call B's, which takes
    flash_fwd in the prefill)."""
    from mimic_tpu_torch.ops import flash_attention as tfa

    calls = serving_calls()
    images, texts, bucket = calls["A"]
    V = runner.cfg.text.vocab_size
    runner.enable_vision_cache()

    def sample(name="A", **kw):
        images, texts, _ = calls[name]
        with ResultSpy() as res:
            torch.cuda.synchronize()
            t = time.perf_counter()
            runner.generate(images, texts, max_new_tokens=MAX_NEW_TOKENS, **kw)
            torch.cuda.synchronize()
        r = res.results[0]
        if (r.tokens.min() < 0 or r.tokens.max() >= V or not torch.isfinite(r.scores).all()):
            raise AssertionError(f"sampled tokens out of range or scores not finite: {r}")
        return r, time.perf_counter() - t

    greedy, _ = sample()
    tfa.reset_launch_counts()
    with LogitSpy() as spy:
        top1, secs = sample(do_sample=True, top_k=1, seed=0)
    launches = dict(tfa.LAUNCHES)
    # top_k=1 keeps every logit equal to the largest (``x < kth`` filters), and
    # bf16 logits tie at the top: where they do, the noise picks among the tied
    # tokens, where greedy's argmax takes the lowest index.  So each row must
    # equal greedy's up to its first difference, and there both tokens must
    # hold the step's largest logit
    same, ties = torch.equal(top1.tokens, greedy.tokens), 0
    for r in range(top1.tokens.shape[0]):
        diff = (top1.tokens[r] != greedy.tokens[r]).nonzero()
        if len(diff):
            i = int(diff[0])
            row = spy.logits[i][r]
            if not (row[top1.tokens[r, i]] == row.max() == row[greedy.tokens[r, i]]):
                raise AssertionError(f"top_k=1 sampling left greedy's tokens at row {r} step {i} "
                                     f"without a tie: {top1.tokens.tolist()} vs "
                                     f"{greedy.tokens.tolist()}")
            ties += 1
    top_ties = sum(int((x == x.amax(-1, keepdim=True)).sum(-1).gt(1).sum()) for x in spy.logits)
    log(f"[sample] call A, do_sample top_k=1: {secs:.3f} s = {len(texts) / secs:.3f} q/s; "
        f"tokens equal to greedy bit for bit: {same}; {ties} rows left greedy's tokens, each at "
        f"a tie of the largest bf16 logit ({top_ties} of the {len(spy.logits) * len(texts)} "
        f"draws had a tied maximum)")
    kw = dict(do_sample=True, temperature=0.7, top_k=50, top_p=0.9)
    a, secs = sample(seed=1, **kw)
    b, _ = sample(seed=1, **kw)
    c, _ = sample(seed=2, **kw)
    log(f"[sample] call A, temperature 0.7, top_k 50, top_p 0.9: {secs:.3f} s = "
        f"{len(texts) / secs:.3f} q/s; seed 1 twice identical: {torch.equal(a.tokens, b.tokens)}; "
        f"seed 2 differs: {not torch.equal(a.tokens, c.tokens)}; tokens {a.tokens.tolist()}, "
        f"scores {[round(x, 4) for x in a.scores.tolist()]}")
    if not torch.equal(a.tokens, b.tokens) or torch.equal(a.tokens, c.tokens):
        raise AssertionError("sampling is not reproducible under one seed or ignores the seed")
    tfa.reset_launch_counts()
    _, secs = sample("B", seed=3, **kw)
    log(f"[sample] call B (bucket 4096), same options: {secs:.3f} s; launches {dict(tfa.LAUNCHES)}")
    if tfa.LAUNCHES["flash_fwd"] != runner.cfg.text.num_layers:
        raise AssertionError(f"call B's sampled prefill launched {dict(tfa.LAUNCHES)}")
    launches = {k: launches[k] + tfa.LAUNCHES[k] for k in launches}
    runner.vision_cache = None  # the later phases count the ViT's launches
    return launches


def phase_convert_8b(runner):
    """(d) The converter at full width and depth: the random tree under HF's
    names and back, bit for bit."""
    import gc

    from mimic_tpu_torch.models.convert import convert_idefics2

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sd = hf_state_dict(runner.params, runner.cfg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    back = convert_idefics2(sd, runner.cfg)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    equal = _bits_equal_tree(back, runner.params)
    log(f"[convert] idefics2-8b-base: {len(sd)} HF tensors "
        f"({sum(t.numel() for t in sd.values()) / 1e9:.3f} B values) made from the tree in "
        f"{t1 - t0:.2f} s, convert_idefics2 back in {t2 - t1:.2f} s on the card; every leaf "
        f"bit-equal: {equal}; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} "
        f"GiB ({base / 2**30:.1f} GiB before)")
    if not equal:
        raise AssertionError("convert_idefics2 does not invert the HF layout at 8B")
    del sd, back
    gc.collect()
    torch.cuda.empty_cache()


def phase_convert_tiny():
    """(e) A two-shard safetensors checkpoint of a tiny idefics2 through the
    converter's command, params.msgpack and build_model(paths=...)."""
    from mimic_tpu_torch.config.paths import Paths
    from mimic_tpu_torch.models import factory
    from mimic_tpu_torch.models.convert import convert_checkpoint
    from mimic_tpu_torch.models.lvlm import lvlm_forward

    src = factory.build_model("tiny-idefics2", device="cuda", dtype=torch.float32, seed=5)
    sd = hf_state_dict(src.params, src.cfg)
    names = sorted(sd)
    with tempfile.TemporaryDirectory(prefix="mimic_convert_") as d:
        half = len(names) // 2
        for k, part in enumerate((names[:half], names[half:])):
            write_safetensors(os.path.join(d, f"model-0000{k + 1}-of-00002.safetensors"),
                              {n: sd[n] for n in part})
        t = time.perf_counter()
        subprocess.run([sys.executable, "-m", "mimic_tpu_torch.models.convert", "tiny-idefics2", d],
                       cwd=ROOT, check=True, timeout=600)
        secs = time.perf_counter() - t
        # tiny models have no path of their own: read this one through idefics2's field
        factory._MODEL_PATH_FIELD["tiny-idefics2"] = "idefics2_8b_base_path"
        try:
            loaded = factory.build_model("tiny-idefics2", paths=Paths(idefics2_8b_base_path=d),
                                         device="cuda", dtype=torch.float32)
        finally:
            del factory._MODEL_PATH_FIELD["tiny-idefics2"]
    same_params = _bits_equal_tree(loaded.params, src.params)
    images = [[synthetic_image(90 + i)[:56, :84]] for i in range(2)]
    texts = ["Image:<image> Question: what is here? Answer:", "Image:<image> Question: who? Answer:"]
    src.tokenizer.padding_side = loaded.tokenizer.padding_side = "left"
    logits = [lvlm_forward(r.params, r.cfg, r.process_input(images, texts), attn_impl="xla").logits
              for r in (src, loaded)]
    equal = torch.equal(logits[0], logits[1])
    log(f"[convert] tiny-idefics2: 2 safetensors shards ({len(names)} tensors) -> python -m "
        f"mimic_tpu_torch.models.convert in {secs:.2f} s -> params.msgpack -> "
        f"build_model(paths=...): parameters bit-equal {same_params}, logits "
        f"{tuple(logits[0].shape)} equal to the source runner's {equal}")
    if not (same_params and equal):
        raise AssertionError("the converted tiny checkpoint does not reproduce its source")


def phase_caches_8b(runner):
    """Phase 12 on the phase-5 runner: (a)-(e); the launches of the cached
    train steps, the warm cached call and the sampled calls."""
    out = {}
    for label, fn in (("cached training", phase_cached_train), ("cached eval", phase_cached_eval),
                      ("sampling", phase_sampling)):
        t = time.perf_counter()
        out[label] = fn(runner)
        log(f"[time] phase 12 {label}: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_convert_8b(runner)
    phase_convert_tiny()
    log(f"[time] phase 12 converter: {time.perf_counter() - t:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 13: LoRA and prefix tuning
# ---------------------------------------------------------------------------

# the remat step against the same step without remat: the same kernels on the
# same inputs, recomputed, so the gradients agree up to the order of bf16 sums
MIN_REMAT_COSINE = 0.9999
PEFT_LOSS_REL = 1e-3


def _grad_cosines(a, b):
    return {k: torch.nn.functional.cosine_similarity(a[k].flatten().float(),
                                                     b[k].flatten().float(), dim=0).item()
            for k in a}


def _counts():
    from mimic_tpu_torch.ops import flash_attention as tfa
    from mimic_tpu_torch.ops import flash_backward as tfb

    return {**tfa.LAUNCHES, **tfb.LAUNCHES, **_int8_counts()}


def _reset_counts():
    from mimic_tpu_torch.ops import flash_attention as tfa
    from mimic_tpu_torch.ops import flash_backward as tfb

    tfa.reset_launch_counts()
    tfb.reset_launch_counts()
    _reset_int8_counts()


def _sum_counts(*dicts):
    return {k: sum(d.get(k, 0) for d in dicts) for k in KERNEL_META}


def _feature_batch(runner, batch):
    """Phase 5's batch with the images encoded once (what the warm training
    vision cache hands the step)."""
    from mimic_tpu_torch.models.lvlm import encode_images

    with torch.no_grad():
        feats = {f"{p}_feats": encode_images(runner.params, runner.cfg, batch[f"{p}_pixels"],
                                             batch[f"{p}_patch_mask"], attn_impl="flash")
                 for p in ("full", "query")}
    out = {k: v for k, v in batch.items() if "pixels" not in k and "patch" not in k}
    out.update(feats)
    return out


def phase_lora_steps(runner, fb):
    """(a) Three lora-preset steps on the flash path, held to the plain path."""
    from mimic_tpu_torch.config import get_preset
    from mimic_tpu_torch.models.decoder import ATTN_PATH_LOG
    from mimic_tpu_torch.shift.lora import init_lora_params
    from mimic_tpu_torch.train import step as ts
    from mimic_tpu_torch.train.optim import build_optimizer

    cfg, frozen = runner.cfg, runner.params
    L = cfg.text.num_layers
    enc, peft = get_preset("lora")
    gen = torch.Generator(device="cuda").manual_seed(4)
    lora = init_lora_params(peft.lora, cfg.text, gen, torch.device("cuda"))
    # B off zero (at init dA is zero): N(0, 0.05^2)
    for k in lora:
        if k.endswith("_b"):
            lora[k] = torch.randn(lora[k].shape, generator=gen, device="cuda") * 0.05
    trainable = {"lora": lora}
    scaling, rate = peft.lora.scaling(), peft.lora.dropout
    tx = build_optimizer(trainable, lr=peft.lr, weight_decay=1e-3, warmup_steps=10,
                         total_steps=1000, grad_clip=1.0)
    step = ts.make_train_step(cfg, enc, tx, ce_loss_weight=peft.ce_loss_weight,
                              align_loss_weight=peft.align_loss_weight, lora_scaling=scaling,
                              lora_dropout=rate, attn_impl="flash", seed=0)
    state0 = ts.TrainState(trainable, tx.init(trainable), 0)
    n = sum(v.numel() for v in lora.values())
    log(f"[peft] lora preset on idefics2-8b-base: {n / 1e6:.3f} M fp32 adapter parameters "
        f"(r {peft.lora.r}, alpha {peft.lora.alpha}, dropout {rate}, "
        f"{', '.join(peft.lora.target_modules)}), Strategy.LM_LOSS: the shift pass alone, "
        f"{fb['query_ids'].shape[1]} tokens x B{fb['query_ids'].shape[0]} on encoded features")

    def run(state):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, frozen, fb)
        torch.cuda.synchronize()
        return state, m, time.perf_counter() - t

    _, m0, secs = run(state0)  # warm-up, and the seed check below
    _, again, _ = run(state0)
    log(f"[peft] lora warm-up step {secs:.3f} s, loss {float(m0['loss']):.6f}; the same state and "
        f"seed again: loss {float(again['loss']):.6f}")
    if float(again["loss"]) != float(m0["loss"]):
        raise AssertionError("the lora step's loss differs under the same seed")
    state, times, per_step = state0, [], []
    ATTN_PATH_LOG.clear()
    total = {}
    for i in range(TRAIN_STEPS):
        _reset_counts()
        state, m, secs = run(state)
        counts = _counts()
        total = _sum_counts(total, counts)
        times.append(secs)
        per_step.append(float(m["loss"]))
        log(f"[peft] lora step {i + 1}: {secs:.3f} s; loss {float(m['loss']):.6g}, grad_norm "
            f"{float(m['grad_norm']):.6g}; launches {counts}")
        # with adapters on q/k/v, layer 0's attention inputs carry gradient too
        want = {"onepass_fwd": L, "flash_fwd": 0, "flash_bwd_dq": L, "flash_bwd_dkv": L}
        if {k: counts[k] for k in want} != want:
            raise AssertionError(f"lora step launched {counts}, want {want}")
        if not (np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0):
            raise AssertionError(f"lora step metrics {m}")
    if ATTN_PATH_LOG != ["flash"] * TRAIN_STEPS or len(set(per_step)) != TRAIN_STEPS:
        raise AssertionError(f"lora steps: paths {ATTN_PATH_LOG}, losses {per_step}")
    STEP_SECONDS["lora"] = times
    log(f"[peft] {TRAIN_STEPS} lora steps: mean {sum(times) / len(times):.3f} s/step (min "
        f"{min(times):.3f}, max {max(times):.3f}); consecutive steps draw other dropout masks: "
        f"losses {per_step}")
    profile_run("lora train step", lambda: run(state)[2])

    # the first step's loss and gradients against the plain attention path,
    # with the same dropout masks (one seed for both)
    loss_kw = dict(cfg=cfg, strategy=enc.strategy(), rec_attn=False, rec_ffn=False, mh=True,
                   ce_loss_weight=peft.ce_loss_weight, align_loss_weight=peft.align_loss_weight,
                   logz2="unmasked", lora_scaling=scaling, lora_dropout=rate)
    grads, losses = {}, {}
    for attn_impl in ("flash", "xla"):
        leaves = {k: v.detach().requires_grad_(True) for k, v in lora.items()}
        gen = torch.Generator(device="cuda").manual_seed(5)
        with torch.enable_grad():
            loss, _ = ts.compute_loss({"lora": leaves}, frozen, fb, attn_impl=attn_impl,
                                      dropout_generator=gen, **loss_kw)
            grads[attn_impl] = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        losses[attn_impl] = float(loss.detach())
    cos = _grad_cosines(grads["flash"], grads["xla"])
    rel = abs(losses["flash"] - losses["xla"]) / abs(losses["xla"])
    log(f"[peft] lora step, kernels vs plain attention: loss {losses['flash']:.6f} vs "
        f"{losses['xla']:.6f} (relative {rel:.2e}, need <= {PEFT_LOSS_REL}); per-leaf gradient "
        f"cosine min {min(cos.values()):.6f} (need >= {MIN_GRAD_COSINE}): {cos}")
    if rel > PEFT_LOSS_REL or min(cos.values()) < MIN_GRAD_COSINE:
        raise AssertionError("the lora step through the kernels disagrees with the plain path")
    return total


def phase_remat(runner, fb):
    """(b) The MimIC step with shift_remat against the same step without."""
    from mimic_tpu_torch.config import get_preset
    from mimic_tpu_torch.shift.params import (init_shift_params, multi_head, needs_attn_capture,
                                               needs_ffn_capture)
    from mimic_tpu_torch.train import step as ts
    from mimic_tpu_torch.train.optim import build_optimizer

    cfg, frozen = runner.cfg, runner.params
    enc, peft = get_preset("mimic")
    shift = init_shift_params(enc, cfg.text, torch.Generator(device="cuda").manual_seed(2),
                              torch.device("cuda"))
    loss_kw = dict(cfg=cfg, strategy=enc.strategy(), rec_attn=needs_attn_capture(enc),
                   rec_ffn=needs_ffn_capture(enc), mh=multi_head(enc),
                   ce_loss_weight=peft.ce_loss_weight, align_loss_weight=peft.align_loss_weight,
                   logz2="unmasked", attn_impl="flash")
    grads, losses, stats = {}, {}, {}
    for remat in (False, True, True, False):
        leaves = {k: v.detach().requires_grad_(True) for k, v in shift.items()}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with torch.enable_grad():
            loss, _ = ts.compute_loss({"shift": leaves}, frozen, fb, shift_remat=remat, **loss_kw)
            g = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        grads[remat], losses[remat] = g, float(loss.detach())
        stats.setdefault(remat, []).append((secs, peak))
    tx = build_optimizer({"shift": shift}, lr=peft.lr, weight_decay=1e-3, warmup_steps=10,
                         total_steps=1000, grad_clip=1.0)
    launches = {}
    for remat in (False, True):
        step = ts.make_train_step(cfg, enc, tx, ce_loss_weight=peft.ce_loss_weight,
                                  align_loss_weight=peft.align_loss_weight, attn_impl="flash",
                                  logz2="unmasked", shift_remat=remat)
        state = ts.TrainState({"shift": shift}, tx.init({"shift": shift}), 0)
        step(state, frozen, fb)
        _reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(state, frozen, fb)
        torch.cuda.synchronize()
        stats[remat].append((time.perf_counter() - t, None))
        launches[remat] = _counts()
    cos = _grad_cosines(grads[True], grads[False])
    log(f"[peft] MimIC step (phase 5's batch on encoded features), shift_remat off / on: loss "
        f"{losses[False]:.6f} / {losses[True]:.6f}; per-leaf gradient cosine {cos} (need >= "
        f"{MIN_REMAT_COSINE}); loss + backward s and peak GiB above the resident tree, in turns: "
        + "; ".join(f"{'on' if r else 'off'} " + ", ".join(
            f"{s:.3f} s {p:.2f} GiB" for s, p in v if p is not None) for r, v in stats.items())
        + "; whole step (make_train_step) s: "
        + ", ".join(f"{'on' if r else 'off'} {v[-1][0]:.3f}" for r, v in stats.items())
        + f"; launches per step off {launches[False]}, on {launches[True]}")
    if losses[True] != losses[False] or min(cos.values()) < MIN_REMAT_COSINE:
        raise AssertionError("the remat step disagrees with the step without remat")


def phase_lora_eval(runner, result_dir):
    """(c) run_train with the lora preset, then the CLI's eval in "int8-w8a8"
    on a model built anew: the adapters merged into the weights."""
    import gc

    from mimic_tpu_torch.config import TrainConfig, get_preset
    from mimic_tpu_torch.models import generate as tg
    from mimic_tpu_torch.models.decoder import ATTN_PATH_LOG
    from mimic_tpu_torch.models.factory import build_model
    from mimic_tpu_torch.pipeline import cli, train_entry
    from mimic_tpu_torch.shift.lora import merge_lora
    from mimic_tpu_torch.train.checkpoints import load_trainable

    enc, peft = get_preset("lora")
    cfg = TrainConfig(runname="smokelora", model_name="idefics2-8b-base", encoder=enc, peft=peft,
                      epochs=11, batch_size=2, accumulate_grad_batches=1)
    cfg.data.name, cfg.data.num_query_samples, cfg.data.num_shot = "vqav2", 2, 1
    cfg.data.max_query_len = 256
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = train_entry.run_train(cfg, result_dir=result_dir, runner=runner,
                                  splits=synthetic_vqa_splits(6, 8))
    torch.cuda.synchronize()
    ckpt = os.path.join(result_dir, "ckpt", "smokelora-idefics2-8b-base-vqav2-2-1shot", "epoch-10")
    log(f"[peft] run_train (lora preset, 1-shot, B2, 11 epochs x 1 step): {state.step} steps in "
        f"{time.perf_counter() - t0:.1f} s; checkpoint {os.path.relpath(ckpt, result_dir)}")
    if state.step != 11 or not os.path.exists(os.path.join(ckpt, "encoder.msgpack")):
        raise AssertionError("run_train with the lora preset wrote no epoch-10 checkpoint")

    gc.collect()
    torch.cuda.empty_cache()
    ev = build_model("idefics2-8b-base", dtype=torch.bfloat16)
    L = ev.cfg.text.num_layers
    splits = synthetic_vqa_splits(6, EVAL_BATCH * EVAL_BATCHES)
    overrides = [
        "model_name=idefics2-8b-base", f"ckpt_path={ckpt}", "preset=lora", "quant=int8-w8a8",
        f"batch_size={EVAL_BATCH}", f"iterations={EVAL_BATCHES}", "data.name=vqav2",
        f"data.num_query_samples={EVAL_BATCH * EVAL_BATCHES}", "data.num_shot=1",
        f"data.length_buckets=[{EVAL_BUCKET}]",
    ]

    def evaluate(tag):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = cli._eval(overrides + [f"result_dir={os.path.join(result_dir, tag)}"],
                        splits=splits, runner=ev)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    _, secs = evaluate("lora-warm")
    base = ev._unmerged_params
    if ev.adapters is not None or not ev._lora_merged or base is None:
        raise AssertionError("the lora eval runner carries live adapters or no pristine base")
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    ATTN_PATH_LOG.clear()
    (records, metrics), secs = evaluate("lora-counted")
    launches = _counts()
    n = EVAL_BATCH * EVAL_BATCHES
    steps = MAX_NEW_TOKENS - 1
    want = {"w8a8_matmul": EVAL_BATCHES * 4 * L, "quantize_rows": EVAL_BATCHES * 4 * L,
            "int8_matmul": EVAL_BATCHES * (steps * (2 * L + 1) + 1),
            "fused_mlp_int8": EVAL_BATCHES * steps * L, "prompt_attn_int8": 0}
    log(f"[peft] python -m mimic_tpu_torch eval {' '.join(overrides[2:4])} ... (LoRA merged into "
        f"the weights, then quantized): {n} requests in {secs:.3f} s = {n / secs:.3f} q/s; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (the pristine bf16 "
        f"base kept for the next epoch's merge); eval_result {json.dumps(metrics)}; launches "
        f"{launches}")
    if ({k: launches[k] for k in want} != want or len(records) != n
            or ATTN_PATH_LOG != (["flash"] + ["cached"] * steps) * EVAL_BATCHES):
        raise AssertionError(f"lora eval: launches {launches}, want {want}; paths {ATTN_PATH_LOG}")

    # first-step logits of call A in bf16: the merged tree against live adapters
    lora = load_trainable(ckpt, template=train_entry.init_trainable(
        cfg, ev.cfg.text, torch.Generator().manual_seed(0), "cpu"))["lora"]
    lora = {k: v.cuda() for k, v in lora.items()}
    images, texts, bucket = serving_calls()["A"]
    ev.tokenizer.padding_side = "left"
    batch = ev.process_input(images, texts, pad_to=bucket)
    with torch.no_grad():
        merged = merge_lora(base, lora, cfg.peft.lora.scaling())
        live = tg._prefill(base, ev.cfg, batch, bucket + MAX_NEW_TOKENS, None, "unmasked",
                           torch.bfloat16, "flash", adapters=lora,
                           lora_scaling=cfg.peft.lora.scaling())[0]
        folded = tg._prefill(merged, ev.cfg, batch, bucket + MAX_NEW_TOKENS, None, "unmasked",
                             torch.bfloat16, "flash")[0]
        plain = tg._prefill(base, ev.cfg, batch, bucket + MAX_NEW_TOKENS, None, "unmasked",
                            torch.bfloat16, "flash")[0]
    cos = _row_cosine(folded, live)
    moved = (live.float() - plain.float()).abs().max().item()
    log(f"[peft] call A prefill logits, bf16, merged tree vs live adapters: min row cosine "
        f"{cos:.6f} (need >= {MIN_LOGIT_COSINE}), max abs diff "
        f"{(folded.float() - live.float()).abs().max().item():.4f}; the trained adapters move "
        f"the logits by up to {moved:.4f} from the base's")
    if cos < MIN_LOGIT_COSINE or not torch.isfinite(live).all():
        raise AssertionError("merged LoRA logits disagree with the live adapters")
    del ev, base, merged
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_prefix(runner, fb):
    """(d) prefix-tuning steps, then beam-3 call A with the prefix; (e) call B
    without a shift in "int8" with the prefix (the int8 prompt KV)."""
    from mimic_tpu_torch.config import get_preset
    from mimic_tpu_torch.models import generate as tg
    from mimic_tpu_torch.models.decoder import ATTN_PATH_LOG
    from mimic_tpu_torch.models.lvlm import encode_images, lvlm_forward
    from mimic_tpu_torch.shift.prefix import init_prefix_params, prefix_forward_args
    from mimic_tpu_torch.train import step as ts
    from mimic_tpu_torch.train.optim import build_optimizer

    cfg, frozen = runner.cfg, runner.params
    L = cfg.text.num_layers
    enc, peft = get_preset("prefix-tuning")
    prefix = init_prefix_params(peft.prefix, cfg.text, torch.Generator(device="cuda").manual_seed(6),
                                torch.device("cuda"))
    P = prefix["k"].shape[1]
    tx = build_optimizer({"prefix": prefix}, lr=peft.lr, weight_decay=1e-3, warmup_steps=0,
                         total_steps=1000, grad_clip=1.0)
    step = ts.make_train_step(cfg, enc, tx, ce_loss_weight=peft.ce_loss_weight,
                              align_loss_weight=peft.align_loss_weight, attn_impl="flash")
    state = ts.TrainState({"prefix": prefix}, tx.init({"prefix": prefix}), 0)
    t0 = time.perf_counter()
    state, _ = step(state, frozen, fb)  # warm-up
    log(f"[peft] prefix warm-up step: {_since(t0):.3f} s")
    ATTN_PATH_LOG.clear()
    times, total = [], {}
    for i in range(TRAIN_STEPS):
        _reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, frozen, fb)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        counts = _counts()
        total = _sum_counts(total, counts)
        if not (np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0) or any(counts.values()):
            raise AssertionError(f"prefix step: metrics {m}, launches {counts}")
    STEP_SECONDS["prefix"] = times
    moved = max((state.trainable["prefix"][k] - prefix[k]).abs().max().item() for k in prefix)
    log(f"[peft] prefix-tuning (P {P}, {2 * prefix['k'].numel() / 1e6:.3f} M fp32 parameters), "
        f"{TRAIN_STEPS} steps on phase 5's shift pass: {', '.join(f'{t:.3f}' for t in times)} s; "
        f"the text attention takes the plain cached path ({sorted(set(ATTN_PATH_LOG))}), no kernel "
        f"launches; prefix max |change| {moved:.3e}")
    if set(ATTN_PATH_LOG) != {"cached"} or not moved > 0:
        raise AssertionError(f"prefix steps: paths {ATTN_PATH_LOG}, change {moved}")

    saved = (runner.shift, runner.adapters, runner.lora_scaling, runner.prefix)
    runner.set_shift(None, prefix=state.trainable["prefix"])
    calls = serving_calls()
    out = {}
    try:
        # (d) call A: the prompt block through onepass_fwd, the prefix merged in
        log(f"[peft] prefix warm-up call A: {timed_generate(runner, calls, 'A')[1]:.3f} s")
        _reset_counts()
        ATTN_PATH_LOG.clear()
        text, secs = timed_generate(runner, calls, "A")
        out["call A"] = _counts()
        paths = list(ATTN_PATH_LOG)
        log(f"[peft] beam-3 call A with the prefix: {secs:.3f} s = {4 / secs:.3f} q/s; paths "
            f"{paths[:2]}...; launches {out['call A']}")
        # the ViT's rows (one launch per vision layer) and the prompt block's
        if paths != ["flash+prefix"] + ["cached"] * (MAX_NEW_TOKENS - 1) or \
                out["call A"]["onepass_fwd"] != cfg.vision.num_layers + L:
            raise AssertionError(f"prefix call A: paths {paths}, launches {out['call A']}")
        profile_run("prefix call A", lambda: timed_generate(runner, calls, "A")[1])
        images, texts, bucket = calls["A"]
        runner.tokenizer.padding_side = "left"
        t0 = time.perf_counter()
        batch = runner.process_input(images, texts, pad_to=bucket)
        with torch.no_grad():
            merged = tg._prefill(runner.params, cfg, batch, P + bucket + MAX_NEW_TOKENS, None,
                                 "unmasked", torch.bfloat16, "flash", prefix=runner.prefix)[0]
            feats = encode_images(runner.params, cfg, batch.pixel_values, batch.patch_mask,
                                  attn_impl="flash")
            pb, pos, cache, total_len = prefix_forward_args(
                runner.prefix, batch._replace(pixel_values=None, patch_mask=None), torch.bfloat16,
                extra_len=MAX_NEW_TOKENS)
            cached = lvlm_forward(runner.params, cfg, pb, image_feats=feats, position_ids=pos,
                                  kv_cache=cache, kv_total_len=total_len,
                                  last_logit_only=True).logits[:, -1]
        cos = _row_cosine(merged, cached)
        log(f"[peft] call A prefill logits, prefix merged through the kernels vs the plain "
            f"cached path: min row cosine {cos:.6f} (need >= {MIN_LOGIT_COSINE}), max abs diff "
            f"{(merged.float() - cached.float()).abs().max().item():.4f} ({_since(t0):.1f} s)")
        if cos < MIN_LOGIT_COSINE or not torch.isfinite(merged).all():
            raise AssertionError("the prefix-merge prefill disagrees with the cached path")

        # (e) call B in "int8" without a shift: Sp = P + 4096 prompt slots, int8,
        # padded to 33 chunks of 128 keys (the last one P real keys; phase 6
        # holds the kernel to its plain version at that shape)
        t0 = time.perf_counter()
        runner.set_quant("int8")
        log(f"[peft] set_quant('int8'): {_since(t0):.1f} s; warm-up call B with the prefix: "
            f"{timed_generate(runner, calls, 'B')[1]:.3f} s")
        _reset_counts()
        ATTN_PATH_LOG.clear()
        _, secs = timed_generate(runner, calls, "B")
        out["call B"] = _counts()
        paths = list(ATTN_PATH_LOG)
        Sp = P + calls["B"][2]
        log(f"[peft] beam-3 call B in 'int8' with the prefix, no shift: {secs:.3f} s = "
            f"{2 / secs:.3f} q/s; prompt KV {Sp} slots stored int8 as {-(-Sp // 128) * 128}; "
            f"paths {paths[:3]}...; launches {out['call B']}")
        want = {"flash_fwd": L, "prompt_attn_int8": (MAX_NEW_TOKENS - 1) * L}
        if ({k: out["call B"][k] for k in want} != want
                or paths != ["flash+prefix"] + ["cached", "quant_kv"] * (MAX_NEW_TOKENS - 1)):
            raise AssertionError(f"prefix call B: paths {paths}, launches {out['call B']}")
        profile_run("prefix call B, int8", lambda: timed_generate(runner, calls, "B")[1])
        # the first decode step over the int8 prompt KV against a bf16 prompt KV
        images, texts, bucket = calls["B"]
        runner.tokenizer.padding_side = "left"
        batch = runner.process_input(images, texts, pad_to=bucket)
        first, tok = {}, runner.tokenizer
        for quant_kv in (True, False):
            ATTN_PATH_LOG.clear()
            with LogitSpy() as spy:
                tg.beam_generate(runner.params, cfg, batch, max_new_tokens=2, num_beams=NUM_BEAMS,
                                 eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id,
                                 attn_impl="flash", decode_params=runner.decode_params,
                                 quant_kv=quant_kv, prefix=runner.prefix)
            first[quant_kv] = spy.logits[1]
            if ("quant_kv" in ATTN_PATH_LOG) != quant_kv:
                raise AssertionError(f"prefix call B, quant_kv {quant_kv}: paths {ATTN_PATH_LOG}")
        a, b = first[True], first[False]
        cos = _row_cosine(a, b)
        log(f"[peft] call B with the prefix, first decode step logits, int8 prompt KV ({Sp} slots "
            f"stored as {-(-Sp // 128) * 128}) vs bf16 prompt KV: max abs diff "
            f"{(a - b).abs().max().item():.4f} of max |logit| {b.abs().max().item():.4f}, min row "
            f"cosine {cos:.6f} (need >= {MIN_LOGIT_COSINE})")
        if (a.shape != (2 * NUM_BEAMS, cfg.text.vocab_size) or not torch.isfinite(a).all()
                or cos < MIN_LOGIT_COSINE):
            raise AssertionError("prefix call B: the int8 prompt KV disagrees with the bf16 one")
    finally:
        runner.set_quant(None)
        runner.set_shift(saved[0], saved[1], saved[2], prefix=saved[3])
    return _sum_counts(total, *out.values())


def _since(t0):
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_peft_8b(runner):
    """Phase 13 on the phase-5 runner: (a)-(e); the launches of the counted
    LoRA steps, the LoRA eval, the prefix steps and calls."""
    fb = _feature_batch(runner, make_train_batch(runner.cfg))
    out = {}
    t = time.perf_counter()
    out["lora training"] = phase_lora_steps(runner, fb)
    log(f"[time] phase 13 lora steps: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_remat(runner, fb)
    log(f"[time] phase 13 remat: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    out["prefix"] = phase_prefix(runner, fb)
    log(f"[time] phase 13 prefix: {time.perf_counter() - t:.1f} s")
    del fb
    torch.cuda.empty_cache()
    t = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="mimic_smoke_lora_") as result_dir:
        out["lora eval"] = phase_lora_eval(runner, result_dir)
    log(f"[time] phase 13 lora eval: {time.perf_counter() - t:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 14: idefics-9b (the idefics1 family)
# ---------------------------------------------------------------------------

ICL_SHOTS = 16  # BASELINE.json config 1's few-shot ICL eval (scripts/run_icl.sh)
ICL_REQUESTS = 4
TRAIN_SHOTS_9B = 8  # config 3's LIVE step and the MimIC step: 8 demos + the query image


def small_image(seed: int, size: int = 224) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(size, size, 3), dtype=np.uint8)


def _shot(rng) -> str:
    return (f"Image:<image> Question: what is {' '.join(rng.choice(WORDS, size=4))}? "
            f"Answer: {rng.choice(WORDS)}\n")


def icl_call():
    """Config 1's shape: 4 requests of 16 shots and a query, 17 images at 224 px each."""
    images, texts = [], []
    for r in range(ICL_REQUESTS):
        rng = np.random.default_rng(500 + r)
        images.append([small_image(600 + 17 * r + i) for i in range(ICL_SHOTS + 1)])
        texts.append("".join(_shot(rng) for _ in range(ICL_SHOTS))
                     + "Image:<image> Question: what is in the image? Answer:")
    return images, texts


def icl_train_batch(cfg, preset):
    """The collator's idefics1 batch of B2: 8 demos then the query, 9 images at
    224 px per row, with image attention masks, as device tensors."""
    from mimic_tpu_torch.config import get_preset
    from mimic_tpu_torch.models.processor import LVLMProcessor
    from mimic_tpu_torch.models.tokenizer import SimpleTokenizer
    from mimic_tpu_torch.train.collate import TrainCollator
    from mimic_tpu_torch.train.step import to_device_batch

    enc, _ = get_preset(preset)
    rows = []
    for r in range(2):
        rng = np.random.default_rng(700 + r)
        rows.append(("".join(_shot(rng) for _ in range(TRAIN_SHOTS_9B)),
                     "Image:<image> Question: what is in the image? Answer:",
                     str(rng.choice(WORDS)),
                     [small_image(800 + 9 * r + i) for i in range(TRAIN_SHOTS_9B + 1)]))
    prefixes, queries, answers, images = (list(x) for x in zip(*rows))
    collator = TrainCollator(LVLMProcessor(cfg, SimpleTokenizer(padding_side="right")),
                             enc.strategy(), num_image_in_query=1, pad_multiple=128)
    tb = collator({"prefix_texts": prefixes, "query_texts": queries, "answers": answers,
                   "images": images})
    return to_device_batch(tb, torch.device("cuda"))


def phase_icl_serving(runner):
    """(b) config 1's ICL call in bf16: launches, wall, busy, peak memory; the
    prefill logits through the kernels against the plain attention path."""
    from mimic_tpu_torch.models import generate as tg
    from mimic_tpu_torch.models.decoder import ATTN_PATH_LOG
    from mimic_tpu_torch.ops import flash_attention as tfa

    cfg = runner.cfg
    images, texts = icl_call()
    width = runner.processor(None, texts)["input_ids"].shape[1]
    bucket = -(-width // runner.pad_multiple) * runner.pad_multiple
    calls = {"ICL": (images, texts, bucket)}
    _, secs = timed_generate(runner, calls, "ICL")
    log(f"[9b] warm-up ICL call: {secs:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    ATTN_PATH_LOG.clear()
    out, secs = timed_generate(runner, calls, "ICL")
    launches = _counts()
    paths = list(ATTN_PATH_LOG)
    n_img = ICL_REQUESTS * (ICL_SHOTS + 1)
    log(f"[9b] ICL call (bf16): {ICL_REQUESTS} requests x {ICL_SHOTS} shots, {n_img} images at "
        f"{cfg.vision.image_size} px, prompt bucket {bucket} ({width} tokens), beam {NUM_BEAMS}, "
        f"{MAX_NEW_TOKENS} new tokens: {secs:.3f} s = {ICL_REQUESTS / secs:.3f} q/s; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{ {k: v for k, v in launches.items() if v} }; decoded {json.dumps(out)}")
    # the ViT's 32 layers over the 68 images, then the 32 prefill layers; flash_fwd
    # only for a bucket above ONEPASS_MAX_S
    long = bucket > tfa.ONEPASS_MAX_S
    want = {"onepass_fwd": cfg.vision.num_layers + (0 if long else cfg.text.num_layers),
            "flash_fwd": cfg.text.num_layers if long else 0}
    if {k: launches[k] for k in want} != want or sum(launches.values()) != sum(want.values()):
        raise AssertionError(f"ICL call launches {launches}, want {want}")
    if paths != ["flash"] + ["cached"] * (MAX_NEW_TOKENS - 1):
        raise AssertionError(f"ICL call attention paths {paths}")
    profile_run("9b ICL call", lambda: timed_generate(runner, calls, "ICL")[1])

    runner.tokenizer.padding_side = "left"  # as generate() pads
    batch = runner.process_input(images, texts, pad_to=bucket)
    logits = {impl: tg._prefill(runner.params, cfg, batch, bucket + MAX_NEW_TOKENS, None,
                                "unmasked", torch.bfloat16, impl)[0]
              for impl in ("flash", "xla")}
    a, b = logits["flash"], logits["xla"]
    if a.shape != (ICL_REQUESTS, cfg.text.vocab_size) or not torch.isfinite(a).all():
        raise AssertionError(f"9B prefill logits: shape {tuple(a.shape)} or non-finite values")
    cos = _row_cosine(a, b)
    log(f"[9b] first-step logits (the prefill's last), kernels vs plain attention (ViT and "
        f"text): max abs diff {(a - b).abs().max().item():.4f} of max |logit| "
        f"{b.abs().max().item():.4f}, min row cosine {cos:.6f} (need >= {MIN_LOGIT_COSINE})")
    if cos < MIN_LOGIT_COSINE:
        raise AssertionError("9B prefill logits through the kernels disagree with the plain path")
    return launches, (batch, bucket, calls)


def phase_icl_w8a8(runner, batch, calls):
    """(c) the same call in "int8-w8a8": the cross layers' 2-D weight-only
    handles take int8_matmul at decode M, the self layers' stacked ones
    int8_matmul_stacked / fused_mlp_int8, and the prefill w8a8_matmul; launches
    counted exactly, the 2-D ones by a spy; first decode step's logits against
    the bf16 tree and against a bf16 tree dequantized from the same handles."""
    from mimic_tpu_torch.models import generate as tg
    from mimic_tpu_torch.ops import quant as tq

    cfg = runner.cfg
    L, G = cfg.text.num_layers, cfg.text.num_cross_layers
    tok = runner.tokenizer

    def first_step(params):
        with LogitSpy() as spy:
            tg.beam_generate(params, cfg, batch, max_new_tokens=2, num_beams=NUM_BEAMS,
                             eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id,
                             attn_impl="flash")
        return spy.logits[1]

    bf16 = first_step(runner.params)
    t0 = time.perf_counter()
    runner.set_quant("int8-w8a8")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"[9b] set_quant('int8-w8a8'): {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    _, secs = timed_generate(runner, calls, "ICL")
    log(f"[9b] warm-up ICL call (int8-w8a8): {secs:.3f} s")
    shapes = {}
    orig = tq.int8_matmul

    def spy(x, wq, scale, out_dtype=None):
        key = (x.shape[0], x.shape[1], scale.shape[-1])
        shapes[key] = shapes.get(key, 0) + 1
        return orig(x, wq, scale, out_dtype=out_dtype)

    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    tq.int8_matmul = spy
    try:
        out, secs = timed_generate(runner, calls, "ICL")
    finally:
        tq.int8_matmul = orig
    launches = _counts()
    steps = MAX_NEW_TOKENS - 1
    # decode: per self layer qkv and o stacked (the MLP fused), per cross layer q,
    # o, gate, up and down 2-D (k/v over the B x 1088 image rows take the
    # dequantized product), the lm head 2-D; the prefill: the lm head, and four
    # W8A8 products per self layer
    want = {"int8_matmul": steps * (2 * L + 5 * G + 1) + 1, "fused_mlp_int8": steps * L,
            "w8a8_matmul": 4 * L, "quantize_rows": 4 * L}
    two_d = sum(shapes.values())
    log(f"[9b] ICL call (int8-w8a8): {secs:.3f} s = {ICL_REQUESTS / secs:.3f} q/s; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{ {k: v for k, v in launches.items() if v} }; 2-D int8_matmul launches {two_d} by "
        f"(M, K, N) {dict(sorted(shapes.items()))}; decoded {json.dumps(out)}")
    if {k: launches[k] for k in want} != want or two_d != steps * (5 * G + 1) + 1:
        raise AssertionError(f"int8-w8a8 ICL call launches {launches} (2-D {two_d}), want {want}")
    profile_run("9b ICL call int8-w8a8", lambda: timed_generate(runner, calls, "ICL")[1])

    a = first_step(runner.params)
    deq = dequantized_tree(runner.params)
    b = first_step(deq)
    del deq
    torch.cuda.empty_cache()
    cos_deq, cos_bf16 = _row_cosine(a, b), _row_cosine(a, bf16)
    log(f"[9b] first decode step logits in int8-w8a8 (beam {NUM_BEAMS}): against a bf16 tree "
        f"dequantized from the same handles min row cosine {cos_deq:.6f}, against the bf16 tree "
        f"{cos_bf16:.6f} (need >= {MIN_W8A8_COSINE} each); max abs diff to the bf16 tree "
        f"{(a - bf16).abs().max().item():.4f} of max |logit| {bf16.abs().max().item():.4f}")
    if not torch.isfinite(a).all() or min(cos_deq, cos_bf16) < MIN_W8A8_COSINE:
        raise AssertionError("9B int8-w8a8 logits disagree with the bf16 tree")
    return launches, shapes


def phase_9b_train(runner, preset):
    """(d) 3 counted steps of ``preset`` on the collator's idefics1 batch:
    launches (the backward pair L - 1 times a step), s/step, busy, peak memory;
    loss finite; the shift gradient against the plain attention path."""
    from mimic_tpu_torch.config import get_preset
    from mimic_tpu_torch.models.decoder import ATTN_PATH_LOG
    from mimic_tpu_torch.models.lvlm import encode_images
    from mimic_tpu_torch.shift.params import (init_shift_params, multi_head, needs_attn_capture,
                                               needs_ffn_capture)
    from mimic_tpu_torch.train import step as ts
    from mimic_tpu_torch.train.optim import build_optimizer

    cfg, frozen = runner.cfg, runner.params
    L = cfg.text.num_layers
    enc, peft = get_preset(preset)
    gen = torch.Generator(device="cuda").manual_seed(4)
    shift = init_shift_params(enc, cfg.text, gen, torch.device("cuda"))
    trainable = {"shift": shift}
    tx = build_optimizer(trainable, lr=peft.lr, weight_decay=1e-3, warmup_steps=10,
                         total_steps=1000, grad_clip=1.0, scale_lr=peft.scale_lr)
    step = ts.make_train_step(cfg, enc, tx, ce_loss_weight=peft.ce_loss_weight,
                              align_loss_weight=peft.align_loss_weight, attn_impl="flash")
    state = ts.TrainState(trainable, tx.init(trainable), 0)
    batch = icl_train_batch(cfg, preset)
    T_full = batch["full_ids"].shape[1] if "full_ids" in batch else 0
    log(f"[9b] {preset} step: {sum(v.numel() for v in shift.values()) / 1e6:.3f} M fp32 shift "
        f"parameters; batch B2, record pass {T_full} tokens with "
        f"{batch['full_pixels'].shape[1] if 'full_pixels' in batch else 0} images, shift pass "
        f"{batch['query_ids'].shape[1]} tokens with {batch['query_pixels'].shape[1]} image")

    def run_step():
        nonlocal state
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, frozen, batch)
        torch.cuda.synchronize()
        return m, time.perf_counter() - t

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run_step()  # warm-up
    _reset_counts()
    ATTN_PATH_LOG.clear()
    times, rows = [], []
    for _ in range(TRAIN_STEPS):
        m, secs = run_step()
        times.append(secs)
        rows.append({k: float(v) for k, v in m.items()})
    launches = _counts()
    paths = list(ATTN_PATH_LOG)
    log(f"[9b] {preset}: {TRAIN_STEPS} counted steps {', '.join(f'{t:.3f}' for t in times)} s "
        f"(mean {sum(times) / len(times):.3f} s/step); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{ {k: v for k, v in launches.items() if v} }; metrics {rows[-1]}")
    n_pass = 2 if T_full else 1
    if paths != ["flash"] * (n_pass * TRAIN_STEPS):
        raise AssertionError(f"{preset}: a decoder call left the flash path: {paths}")
    # the cross layer before layer 0 is frozen and the shift enters at or after
    # layer 0's attention, so layer 0's q/k/v carry no gradient: L - 1 a step
    want_bwd = (L - 1) * TRAIN_STEPS
    if (launches["flash_bwd_dq"] != want_bwd or launches["flash_bwd_dkv"] != want_bwd
            or launches["onepass_fwd"] == 0):
        raise AssertionError(f"{preset}: launches {launches}, want {want_bwd} of each backward")
    for row in rows:
        if not all(np.isfinite(v) for v in row.values()) or not row["grad_norm"] > 0:
            raise AssertionError(f"{preset}: metrics not finite or zero gradient: {row}")
    profile_run(f"9b {preset} step", lambda: run_step()[1])

    # the shift gradient through the kernels against the plain attention path, on
    # the same image features (the ViT's own kernel path is held in (b))
    with torch.no_grad():
        feats = {f"{p}_feats": encode_images(frozen, cfg, batch[f"{p}_pixels"], None,
                                             attn_impl="flash")
                 for p in ("full", "query") if f"{p}_pixels" in batch}
    fb = {k: v for k, v in batch.items() if "pixels" not in k}
    fb.update(feats)
    loss_kw = dict(cfg=cfg, strategy=enc.strategy(), rec_attn=needs_attn_capture(enc),
                   rec_ffn=needs_ffn_capture(enc), mh=multi_head(enc),
                   ce_loss_weight=peft.ce_loss_weight, align_loss_weight=peft.align_loss_weight,
                   logz2="unmasked")
    grads, losses = {}, {}
    for attn_impl in ("flash", "xla"):
        leaves = {k: v.detach().requires_grad_(True) for k, v in state.trainable["shift"].items()}
        with torch.enable_grad():
            loss, _ = ts.compute_loss({"shift": leaves}, frozen, fb, attn_impl=attn_impl, **loss_kw)
            grads[attn_impl] = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        losses[attn_impl] = float(loss.detach())
    cos = _grad_cosines(grads["flash"], grads["xla"])
    log(f"[9b] {preset}: one step's shift gradient, kernels vs plain attention: loss "
        f"{losses['flash']:.6f} vs {losses['xla']:.6f}; per-leaf cosine {cos} "
        f"(need >= {MIN_GRAD_COSINE})")
    if not np.isfinite(losses["flash"]) or min(cos.values()) < MIN_GRAD_COSINE:
        raise AssertionError(f"{preset}: 9B gradients through the kernels disagree with the "
                             f"plain path")
    return launches, batch


def phase_9b_kernel_shapes(prefill_rows, bucket, batches):
    """The kernels against their plain versions at the shapes idefics-9b gives
    them that no earlier phase holds: MHA (group 1) at the ICL prefill and the
    train steps' record and shift passes, the backward pair at the shift pass,
    the 2-D int8 products of the cross layers, the fused MLP at F 11008 and the
    W8A8 products of the prefill.  Returns the results (errors and times)."""
    out = []
    B = prefill_rows
    out.append(check_kernel("9b-prefill-mha", "onepass_fwd", 50, B, bucket, bucket, 32, 32, 128,
                            np.ones((B, bucket), np.int32), True, True, 5, 1))
    for name, b in batches.items():
        for p in ("full", "query"):
            if f"{p}_ids" not in b:
                continue
            km = b[f"{p}_mask"].cpu().numpy()
            Bp, T = km.shape
            out.append(check_kernel(f"9b-{name}-{p}-mha", "onepass_fwd", 51, Bp, T, T, 32, 32,
                                    128, km, True, True, 5, 1))
            if p == "query":
                out.extend(check_backward(f"9b-{name}-bwd-mha", 52, Bp, T, T, 32, 32, km, True,
                                          True, 5))
    out += [
        check_int8_matmul("9b-cross-q-o-12", 53, 12, 4096, 4096, 0, 0, 0, reps=16),
        check_int8_matmul("9b-cross-gate-up-12", 54, 12, 4096, 11008, 0, 0, 0, reps=16),
        check_int8_matmul("9b-cross-down-12", 55, 12, 11008, 4096, 0, 0, 0, reps=16),
        check_fused_mlp("9b-mlp-12", 56, 12, 4096, 11008, reps=8),
    ]
    M = B * bucket
    for label, K, N in (("qkv", 4096, 3 * 4096), ("o", 4096, 4096), ("gateup", 4096, 2 * 11008),
                        ("down", 11008, 4096)):
        out.append(check_w8a8(f"9b-{label}-{M}", 57, M, K, N, 2, 1, reps=0, timed=False))
    return out


def phase_idefics_9b():
    """Phase 14: idefics-9b at full width and depth, random bf16 weights."""
    import gc

    from mimic_tpu_torch.models.factory import build_model

    t = time.perf_counter()
    runner = build_model("idefics-9b", device="cuda", dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    # the gates start at 0 (HF's init): open them, so that the images reach the logits
    for name, value in (("alpha_attn", 0.5), ("alpha_dense", 0.5)):
        runner.params["lm"]["decoder"]["cross"][name].fill_(value)
    n = sum(x.numel() for x in runner.module.buffers())
    log(f"[9b] idefics-9b: {n / 1e9:.3f} B random bf16 parameters made on the card in "
        f"{time.perf_counter() - t:.1f} s; {torch.cuda.memory_allocated() / 2**30:.1f} GiB "
        f"allocated")
    out = {}
    t = time.perf_counter()
    out["9b ICL serving"], (batch, bucket, calls) = phase_icl_serving(runner)
    log(f"[time] phase 14 ICL serving: {time.perf_counter() - t:.1f} s")
    batches = {}
    for preset in ("licv", "mimic"):
        t = time.perf_counter()
        out[f"9b {preset} training"], batches[preset] = phase_9b_train(runner, preset)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[time] phase 14 {preset} steps: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    out["9b ICL int8-w8a8"], _ = phase_icl_w8a8(runner, batch, calls)
    log(f"[time] phase 14 int8-w8a8: {time.perf_counter() - t:.1f} s")
    del runner, batch
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    results = phase_9b_kernel_shapes(ICL_REQUESTS, bucket, batches)
    log(f"[time] phase 14 kernel shapes: {time.perf_counter() - t:.1f} s")
    return out, results


# ---------------------------------------------------------------------------
# phase 15: the llava family and the text-only towers
# ---------------------------------------------------------------------------

LLAVA_REQUESTS = 4
LLAVA_BUCKET = 1024
LLAVA_SHOTS = 4  # the MimIC step's demos: 5 images of 729 tokens in a 4096-token record pass
LLAVA_EVAL_BUCKET = 2048  # a 1-shot eval prompt: two images of 729 tokens and their text


def llava_calls(cfg):
    """The serving call: 4 requests, each one image at the tower's size (729 or
    576 image tokens) and a short question, in one 1024 bucket."""
    size = cfg.vision.image_size
    images = [[small_image(900 + i, size)] for i in range(LLAVA_REQUESTS)]
    texts = [f"<image>\n{synthetic_text(920 + i, 100 + 40 * i)}Question: what is in the image? "
             f"Answer:" for i in range(LLAVA_REQUESTS)]
    return {"llava": (images, texts, LLAVA_BUCKET)}


def llava_counted_call(runner, calls, tag, want):
    """Warm-up, then the counted and timed call: every kernel launched exactly
    ``want`` times (the others not at all); returns the launches."""
    from mimic_tpu_torch.models.decoder import ATTN_PATH_LOG

    _, secs = timed_generate(runner, calls, "llava")
    log(f"[llava] warm-up call ({tag}): {secs:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    ATTN_PATH_LOG.clear()
    out, secs = timed_generate(runner, calls, "llava")
    launches, paths = _counts(), list(ATTN_PATH_LOG)
    images, texts, bucket = calls["llava"]
    log(f"[llava] {runner.cfg.name} call ({tag}): {len(texts)} requests x one "
        f"{runner.cfg.vision.image_size} px image, bucket {bucket}, beam {NUM_BEAMS}, "
        f"{MAX_NEW_TOKENS} new tokens: {secs:.3f} s = {len(texts) / secs:.3f} q/s; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{ {k: v for k, v in launches.items() if v} }; decoded {json.dumps(out)}")
    full = {k: want.get(k, 0) for k in launches}
    if launches != full or len(out) != len(texts):
        raise AssertionError(f"{tag} call: launches {launches}, want {full}")
    if [p for p in paths if p != "quant_kv"] != ["flash"] + ["cached"] * (MAX_NEW_TOKENS - 1):
        raise AssertionError(f"{tag} call: attention paths {paths}")
    return launches, secs


def llava_first_steps(runner, params, batch, **kw):
    """The prefill's last logits and the first decode step's, through beam_generate."""
    from mimic_tpu_torch.models import generate as tg

    tok = runner.tokenizer
    with LogitSpy() as spy:
        tg.beam_generate(params, runner.cfg, batch, max_new_tokens=2, num_beams=NUM_BEAMS,
                         eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id,
                         shift=runner.shift, logz2=runner.logz2, attn_impl="flash", **kw)
    return spy.logits[:2]


def llava_prefill_check(runner, calls, label):
    """The bucket's prefill logits through the kernels against the plain
    attention path (tower and text), row cosine >= MIN_LOGIT_COSINE."""
    from mimic_tpu_torch.models import generate as tg

    images, texts, bucket = calls["llava"]
    runner.tokenizer.padding_side = "left"  # as generate() pads
    batch = runner.process_input(images, texts, pad_to=bucket)
    logits = {impl: tg._prefill(runner.params, runner.cfg, batch, bucket + MAX_NEW_TOKENS,
                                runner.shift, "unmasked", torch.bfloat16, impl)[0]
              for impl in ("flash", "xla")}
    a, b = logits["flash"], logits["xla"]
    if a.shape != (LLAVA_REQUESTS, runner.cfg.text.vocab_size) or not torch.isfinite(a).all():
        raise AssertionError(f"{label} prefill logits: shape {tuple(a.shape)} or non-finite")
    cos = _row_cosine(a, b)
    log(f"[llava] {label} prefill last logits, kernels vs plain attention (tower and text): "
        f"max abs diff {(a - b).abs().max().item():.4f} of max |logit| "
        f"{b.abs().max().item():.4f}, min row cosine {cos:.6f} (need >= {MIN_LOGIT_COSINE})")
    if cos < MIN_LOGIT_COSINE:
        raise AssertionError(f"{label} prefill logits through the kernels disagree")
    return batch


def phase_llava_train(runner):
    """The MimIC dual-pass step on llava-interleave-7b, 3 counted steps."""
    from mimic_tpu_torch.config import get_preset
    from mimic_tpu_torch.models.decoder import ATTN_PATH_LOG
    from mimic_tpu_torch.shift.params import init_shift_params
    from mimic_tpu_torch.train import step as ts
    from mimic_tpu_torch.train.optim import build_optimizer

    cfg, frozen = runner.cfg, runner.params
    L = cfg.text.num_layers
    enc, peft = get_preset("mimic")
    shift = init_shift_params(enc, cfg.text, torch.Generator(device="cuda").manual_seed(14),
                              torch.device("cuda"))
    initial = {k: v.clone() for k, v in shift.items()}
    trainable = {"shift": shift}
    tx = build_optimizer(trainable, lr=peft.lr, weight_decay=1e-3, warmup_steps=10,
                         total_steps=1000, grad_clip=1.0)
    step = ts.make_train_step(cfg, enc, tx, ce_loss_weight=peft.ce_loss_weight,
                              align_loss_weight=peft.align_loss_weight, attn_impl="flash",
                              logz2="unmasked")
    state = ts.TrainState(trainable, tx.init(trainable), 0)
    # 4 demo images and the query image (5 x 729 tokens) in a 4096-token record
    # pass; llava's processor makes no patch masks
    batch = {k: v for k, v in make_train_batch(cfg, T_rec=4096, T_shift=1024,
                                               n_demo_img=LLAVA_SHOTS).items()
             if "patch" not in k}
    torch.cuda.synchronize()
    before = frozen_fingerprint(frozen)

    def run_step():
        nonlocal state
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, frozen, batch)
        torch.cuda.synchronize()
        return m, time.perf_counter() - t

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    m, secs = run_step()
    log(f"[llava] MimIC step warm-up: {secs:.3f} s, loss {float(m['loss']):.6f}")
    _reset_counts()
    ATTN_PATH_LOG.clear()
    times, rows = [], []
    for _ in range(TRAIN_STEPS):
        m, secs = run_step()
        times.append(secs)
        rows.append({k: float(v) for k, v in m.items()})
    launches, paths = _counts(), list(ATTN_PATH_LOG)
    log(f"[llava] MimIC step (B2, {LLAVA_SHOTS} shots: record pass "
        f"{batch['full_ids'].shape[1]} tokens with {batch['full_pixels'].shape[1]} images, shift "
        f"pass {batch['query_ids'].shape[1]} tokens): {TRAIN_STEPS} counted steps "
        f"{', '.join(f'{t:.3f}' for t in times)} s (mean {sum(times) / len(times):.3f} s/step); "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{ {k: v for k, v in launches.items() if v} }; metrics {rows[-1]}")
    if paths != ["flash"] * (2 * TRAIN_STEPS):
        raise AssertionError(f"llava step: a decoder call left the flash path: {paths}")
    # the record pass (4096 > ONEPASS_MAX_S) takes flash_fwd at every layer; the
    # towers (2 passes x 26 layers) and the shift pass take onepass_fwd; layer 0's
    # q/k/v carry no gradient
    want = {"flash_bwd_dq": (L - 1) * TRAIN_STEPS, "flash_bwd_dkv": (L - 1) * TRAIN_STEPS,
            "flash_fwd": L * TRAIN_STEPS,
            "onepass_fwd": (2 * cfg.vision.num_layers + L) * TRAIN_STEPS}
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"llava step launches {launches}, want {want}")
    for row in rows:
        if not all(np.isfinite(v) for v in row.values()) or not row["grad_norm"] > 0:
            raise AssertionError(f"llava step: metrics not finite or zero gradient: {row}")
    if frozen_fingerprint(frozen) != before:
        raise AssertionError("llava step: a frozen parameter changed")
    moved = {k: (state.trainable["shift"][k] - v).abs().max().item() for k, v in initial.items()}
    log(f"[llava] frozen parameters bit-unchanged; shift max |change| {moved}")
    if not all(x > 0 for x in moved.values()):
        raise AssertionError(f"llava step: a shift leaf did not change: {moved}")
    return launches, times


def phase_llava_eval(runner, result_dir):
    """run_train (mimic, 1-shot, B2, 6 one-step epochs: the llava window saves
    epoch-5) through the training cache, then the CLI's eval in "int8-w8a8" on
    2 x 4 requests with the eval's cache, on the same runner."""
    from mimic_tpu_torch.config import TrainConfig, get_preset
    from mimic_tpu_torch.models.decoder import ATTN_PATH_LOG
    from mimic_tpu_torch.pipeline import cli, train_entry

    name = runner.cfg.name
    enc, peft = get_preset("mimic")
    cfg = TrainConfig(runname="smoke", model_name=name, encoder=enc, peft=peft, epochs=6,
                      batch_size=2, accumulate_grad_batches=1)
    cfg.data.name, cfg.data.num_query_samples, cfg.data.num_shot = "vqav2", 2, 1
    # a query row holds 729 image tokens: within 1024, 128-aligned
    cfg.data.max_query_len = 1024
    made = []

    class CountedCache(train_entry.TrainVisionCache):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    splits = synthetic_vqa_splits(6, EVAL_BATCH * EVAL_BATCHES, size=runner.cfg.vision.image_size)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_entry.TrainVisionCache = CountedCache
    try:
        state = train_entry.run_train(cfg, result_dir=result_dir, runner=runner, splits=splits)
    finally:
        train_entry.TrainVisionCache = CountedCache.__base__
    torch.cuda.synchronize()
    run_dir = os.path.join(result_dir, "ckpt", f"smoke-{name}-vqav2-2-1shot")
    saved = sorted(d for d in os.listdir(run_dir) if d.startswith("epoch"))
    log(f"[llava] run_train (mimic, 1-shot, B2, 6 epochs x 1 step): {state.step} steps in "
        f"{time.perf_counter() - t0:.1f} s; saved {saved}; training cache "
        f"{made[0].cache.hits if made else 0} hits, {made[0].cache.misses if made else 0} misses")
    if state.step != 6 or len(made) != 1 or saved != ["epoch-5"]:
        raise AssertionError(f"llava run_train: {state.step} steps, caches {len(made)}, saved {saved}")
    overrides = [
        f"model_name={name}", f"ckpt_path={os.path.join(run_dir, 'epoch-5')}", "preset=mimic",
        "quant=int8-w8a8", f"batch_size={EVAL_BATCH}", f"iterations={EVAL_BATCHES}",
        "data.name=vqav2", f"data.num_query_samples={EVAL_BATCH * EVAL_BATCHES}",
        "data.num_shot=1", f"data.length_buckets=[{LLAVA_EVAL_BUCKET}]",
    ]
    L = runner.cfg.text.num_layers
    steps = MAX_NEW_TOKENS - 1
    want = {"w8a8_matmul": EVAL_BATCHES * 4 * L, "quantize_rows": EVAL_BATCHES * 4 * L,
            "int8_matmul": EVAL_BATCHES * (steps * (2 * L + 1) + 1),
            "fused_mlp_int8": EVAL_BATCHES * steps * L, "prompt_attn_int8": 0}
    out = {}
    for tag in ("warm", "counted"):
        _reset_counts()
        ATTN_PATH_LOG.clear()
        torch.cuda.synchronize()
        t = time.perf_counter()
        records, metrics = cli._eval(overrides + [f"result_dir={os.path.join(result_dir, tag)}"],
                                     splits=splits, runner=runner)
        torch.cuda.synchronize()
        secs, launches = time.perf_counter() - t, _counts()
        n = EVAL_BATCH * EVAL_BATCHES
        vc = runner.vision_cache
        log(f"[llava] python -m mimic_tpu_torch eval ({tag}) quant=int8-w8a8, {n} requests "
            f"(batch {EVAL_BATCH}, bucket {LLAVA_EVAL_BUCKET}, beam {NUM_BEAMS}, shift active): "
            f"{secs:.3f} s = {n / secs:.3f} q/s; metrics {json.dumps(metrics)}; launches "
            f"{ {k: v for k, v in launches.items() if v} }; vision cache {vc.hits if vc else 0} "
            f"hits, {vc.misses if vc else 0} misses")
        if (len(records) != n or "overall" not in metrics or vc is None
                or {k: launches[k] for k in want} != want or launches["onepass_fwd"] == 0):
            raise AssertionError(f"llava eval ({tag}): {len(records)} records, launches "
                                 f"{launches}, want {want}")
        out = launches
    return out


def phase_llava_interleave():
    """(a) llava-interleave-7b: bf16, "int8", the MimIC step, the eval, "int8-w8a8"."""
    import gc

    from mimic_tpu_torch.config import get_preset
    from mimic_tpu_torch.models.factory import build_model
    from mimic_tpu_torch.shift.params import init_shift_params

    t = time.perf_counter()
    runner = build_model("llava-interleave-7b", device="cuda", dtype=torch.bfloat16, seed=0,
                         length_buckets=(LLAVA_BUCKET,))
    torch.cuda.synchronize()
    cfg = runner.cfg
    Lv, L = cfg.vision.num_layers, cfg.text.num_layers
    log(f"[llava] llava-interleave-7b: {sum(x.numel() for x in runner.module.buffers()) / 1e9:.3f} "
        f"B random bf16 parameters made on the card in {time.perf_counter() - t:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    shift = init_shift_params(get_preset("mimic")[0], cfg.text,
                              torch.Generator(device="cuda").manual_seed(12), torch.device("cuda"))
    runner.set_shift(shift)
    calls = llava_calls(cfg)
    width = runner.processor(None, calls["llava"][1])["input_ids"].shape[1]
    if not LLAVA_BUCKET // 2 < width <= LLAVA_BUCKET:
        raise AssertionError(f"llava call: prompt width {width} misses the {LLAVA_BUCKET} bucket")
    out = {}
    steps = MAX_NEW_TOKENS - 1

    # bf16: the tower's 26 layers and the 28 prefill layers, all onepass_fwd
    t = time.perf_counter()
    out["llava bf16"], _ = llava_counted_call(runner, calls, "bf16", {"onepass_fwd": Lv + L})
    profile_run("llava call bf16", lambda: timed_generate(runner, calls, "llava")[1])
    batch = llava_prefill_check(runner, calls, "llava-interleave-7b")
    log(f"[time] phase 15 llava-interleave bf16: {time.perf_counter() - t:.1f} s")

    # "int8": the bf16 tree prefills, the int8 copy decodes
    t = time.perf_counter()
    runner.set_quant("int8")
    torch.cuda.synchronize()
    int8_want = {"onepass_fwd": Lv + L, "int8_matmul": steps * (2 * L + 1),
                 "fused_mlp_int8": steps * L}
    out["llava int8"], _ = llava_counted_call(runner, calls, "int8, shift", int8_want)
    a = llava_first_steps(runner, runner.params, batch, decode_params=runner.decode_params)[1]
    deq = dequantized_tree(runner.decode_params)
    b = llava_first_steps(runner, runner.params, batch, decode_params=deq)[1]
    del deq
    cos = _row_cosine(a, b)
    log(f"[llava] int8 first decode step, kernels vs a bf16 tree dequantized from the same "
        f"handles: min row cosine {cos:.6f} (need >= {MIN_LOGIT_COSINE})")
    if not torch.isfinite(a).all() or cos < MIN_LOGIT_COSINE:
        raise AssertionError("llava int8 logits disagree with the dequantized tree")
    # without a shift the 1024-slot prompt takes the int8 prompt KV: G 7 x 3 beams
    runner.set_shift(None)
    out["llava int8 prompt KV"], _ = llava_counted_call(
        runner, calls, "int8, no shift: int8 prompt KV",
        {**int8_want, "prompt_attn_int8": steps * L})
    runner.set_shift(shift)
    runner.set_quant(None)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[time] phase 15 llava-interleave int8: {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    out["llava MimIC step"], _ = phase_llava_train(runner)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[time] phase 15 llava-interleave train step: {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="mimic_smoke_llava_") as result_dir:
        out["llava eval"] = phase_llava_eval(runner, result_dir)
    log(f"[time] phase 15 llava-interleave run_train + eval: {time.perf_counter() - t:.1f} s")

    # the eval left the runner in "int8-w8a8" with the trained shift, and its
    # vision-feature cache on: off, so that the call encodes its images
    runner.vision_cache = None
    t = time.perf_counter()
    out["llava int8-w8a8"], _ = llava_counted_call(
        runner, calls, "int8-w8a8", {"onepass_fwd": Lv + L, "w8a8_matmul": 4 * L,
                                     "quantize_rows": 4 * L,
                                     "int8_matmul": steps * (2 * L + 1) + 1,
                                     "fused_mlp_int8": steps * L})
    a = llava_first_steps(runner, runner.params, batch)
    deq = dequantized_tree(runner.params)
    b = llava_first_steps(runner, deq, batch)
    del deq
    cos = [_row_cosine(x, y) for x, y in zip(a, b)]
    log(f"[llava] int8-w8a8 against a bf16 tree dequantized from the same handles: prefill "
        f"logits min row cosine {cos[0]:.6f} (need >= {MIN_LOGIT_COSINE}), first decode step "
        f"{cos[1]:.6f}")
    if not all(torch.isfinite(x).all() for x in a) or cos[0] < MIN_LOGIT_COSINE:
        raise AssertionError("llava int8-w8a8 logits disagree with the dequantized tree")
    del runner, batch
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[time] phase 15 llava-interleave int8-w8a8: {time.perf_counter() - t:.1f} s")
    return out


def phase_llava_15():
    """(b) llava-1.5-7b: one bf16 call; the CLIP tower's attention at head dim 64."""
    import gc

    from mimic_tpu_torch.config import get_preset
    from mimic_tpu_torch.models.factory import build_model
    from mimic_tpu_torch.ops import flash_attention as tfa
    from mimic_tpu_torch.shift.params import init_shift_params

    t = time.perf_counter()
    runner = build_model("llava-1.5-7b", device="cuda", dtype=torch.bfloat16, seed=0,
                         length_buckets=(LLAVA_BUCKET,))
    cfg = runner.cfg
    runner.set_shift(init_shift_params(get_preset("mimic")[0], cfg.text,
                                       torch.Generator(device="cuda").manual_seed(15),
                                       torch.device("cuda")))
    torch.cuda.synchronize()
    log(f"[llava] llava-1.5-7b: {sum(x.numel() for x in runner.module.buffers()) / 1e9:.3f} B "
        f"random bf16 parameters made on the card in {time.perf_counter() - t:.1f} s")
    calls = llava_calls(cfg)
    by_dim = {}
    orig = tfa._launch

    def spy(name, q, *args):
        by_dim[(name, q.shape[-1])] = by_dim.get((name, q.shape[-1]), 0) + 1
        return orig(name, q, *args)

    tfa._launch = spy
    try:
        launches, _ = llava_counted_call(runner, calls, "bf16",
                                         {"onepass_fwd": cfg.vision.num_layers
                                          + cfg.text.num_layers})
    finally:
        tfa._launch = orig
    log(f"[llava] llava-1.5-7b launches by (kernel, head dim) over the warm-up and the counted "
        f"call: {by_dim}")
    if by_dim != {("onepass_fwd", 64): 2 * cfg.vision.num_layers,
                  ("onepass_fwd", 128): 2 * cfg.text.num_layers}:
        raise AssertionError(f"llava-1.5 call: launches by head dim {by_dim}")
    llava_prefill_check(runner, calls, "llava-1.5-7b")
    del runner
    gc.collect()
    torch.cuda.empty_cache()
    return {"llava-1.5 bf16": launches}


def phase_tiny_text_towers():
    """(c) a tiny qwen2-like tower (biases, G 7, head dim 128) and a mistral-like
    one with a 64-slot window under a 128-token prompt, fp32: beam-3 tokens on
    the card (kernels) equal to the CPU's (plain), prefill logits within 1e-4."""
    import dataclasses

    from mimic_tpu_torch.models import generate as tg
    from mimic_tpu_torch.models.config import tiny_text
    from mimic_tpu_torch.models.lvlm import init_lvlm_params
    from mimic_tpu_torch.models.runner import LVLMRunner
    from mimic_tpu_torch.models.tokenizer import SimpleTokenizer
    from mimic_tpu_torch.ops.flash_attention import LAUNCHES, reset_launch_counts

    tk = SimpleTokenizer(padding_side="left")
    texts = [synthetic_text(950, 60), synthetic_text(951, 110)]
    for label, kw, path in (
            ("qwen2-like", dict(attn_bias=True, num_heads=7, num_kv_heads=1, head_dim=128), "flash"),
            ("mistral-like", dict(sliding_window=64, head_dim=128), "xla")):
        cfg = tiny_text("text", **kw)
        cfg = cfg.replace(pad_token_id=tk.pad_token_id, bos_token_id=tk.bos_token_id,
                          eos_token_id=tk.eos_token_id,
                          text=dataclasses.replace(cfg.text, vocab_size=tk.vocab_size))
        params = init_lvlm_params(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
        layers = params["lm"]["decoder"]["layers"]
        gen = torch.Generator().manual_seed(1)
        for name in ("q_bias", "k_bias", "v_bias"):
            if name in layers:
                layers[name] = 0.1 * torch.randn(layers[name].shape, generator=gen)
        logits, tokens, paths = {}, {}, {}
        reset_launch_counts()
        for dev in ("cpu", "cuda"):
            from mimic_tpu_torch.models.decoder import ATTN_PATH_LOG

            r = LVLMRunner(cfg, params, SimpleTokenizer(padding_side="left"), device=dev)
            batch = r.process_input(None, texts, pad_to=128)
            attn_impl = "flash" if dev == "cuda" else "xla"
            ATTN_PATH_LOG.clear()
            logits[dev], _, _ = tg._prefill(r.params, cfg, batch, 128 + 6, None, "unmasked",
                                            torch.float32, attn_impl)
            paths[dev] = list(ATTN_PATH_LOG)
            tokens[dev] = tg.beam_generate(
                r.params, cfg, batch, max_new_tokens=6, num_beams=NUM_BEAMS,
                eos_token_id=tk.eos_token_id, pad_token_id=tk.pad_token_id,
                attn_impl=attn_impl).tokens.cpu()
        torch.cuda.synchronize()
        got, want = logits["cuda"].cpu(), logits["cpu"]
        err = (got - want).abs().max().item()
        close = torch.allclose(got, want, rtol=TOL_TINY_FP32, atol=TOL_TINY_FP32)
        same = torch.equal(tokens["cuda"], tokens["cpu"])
        log(f"[llava] tiny {label} text tower, fp32: prefill path on the card {paths['cuda']}, "
            f"launches {dict(LAUNCHES)}; prefill last logits card vs CPU max abs err {err:.3e} "
            f"(rtol = atol = {TOL_TINY_FP32}: {close}); beam-3 tokens identical: {same}; "
            f"tokens {tokens['cuda'].tolist()}")
        if not close or not same or paths["cuda"] != [path]:
            raise AssertionError(f"tiny {label}: the card disagrees with the CPU")
        if path == "flash" and LAUNCHES["onepass_fwd"] == 0:
            raise AssertionError(f"tiny {label}: no kernel launched")


def phase_llava_kernel_shapes():
    """The kernels against their plain versions at the shapes llava gives them
    that no earlier phase holds: the SigLIP rows at head dim 72 (729 of 768
    keys); G 7 in the forward (the prefill, the record and shift passes) and in
    the backward pair (the shift pass); the int8 products at K 3584 (qkv N 4608,
    o, the 152128-wide lm head, the MLP at F 18944); the W8A8 products of a
    4 x 1024-row prefill."""
    lp = left_padded_mask
    siglip = np.zeros((4, 768), np.int32)
    siglip[:, :729] = 1
    out = [
        check_kernel("siglip-vit-729", "onepass_fwd", 60, 4, 768, 768, 16, 16, 72, siglip,
                     False, False, 10, 3),
        check_kernel("llava-prefill-g7", "onepass_fwd", 61, 4, 1024, 1024, 28, 4, 128,
                     lp(4, 1024, [0, 40, 80, 120]), True, True, 10, 2),
        check_kernel("llava-record-g7", "flash_fwd", 62, 2, 4096, 4096, 28, 4, 128,
                     np.ones((2, 4096), np.int32), True, True, 5, 1),
        check_kernel("llava-shift-g7", "onepass_fwd", 63, 2, 1024, 1024, 28, 4, 128,
                     np.ones((2, 1024), np.int32), True, True, 10, 2),
    ]
    out.extend(check_backward("llava-shift-bwd-g7", 64, 2, 1024, 1024, 28, 4,
                              np.ones((2, 1024), np.int32), True, True, 5))
    out += [
        check_int8_matmul("llava-qkv-12", 65, 12, 3584, 4608, 28, 5, 0, reps=32),
        check_int8_matmul("llava-o-12", 66, 12, 3584, 3584, 28, 7, 0, reps=32),
        check_int8_matmul("llava-lm-head-12", 67, 12, 3584, 152192, 0, 0, 152128, reps=10),
        check_fused_mlp("llava-mlp-12", 68, 12, 3584, 18944, reps=8),
    ]
    M = LLAVA_REQUESTS * LLAVA_BUCKET
    for label, K, N in (("qkv", 3584, 4608), ("o", 3584, 3584), ("gateup", 3584, 2 * 18944),
                        ("down", 18944, 3584)):
        out.append(check_w8a8(f"llava-{label}-{M}", 69, M, K, N, 2, 1, reps=5))
    return out


def phase_llava():
    """Phase 15: the llava family and the text-only towers."""
    out = {}
    t = time.perf_counter()
    out.update(phase_llava_interleave())
    log(f"[time] phase 15 llava-interleave-7b: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    out.update(phase_llava_15())
    log(f"[time] phase 15 llava-1.5-7b: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_tiny_text_towers()
    log(f"[time] phase 15 tiny text towers: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    results = phase_llava_kernel_shapes()
    log(f"[time] phase 15 kernel shapes: {time.perf_counter() - t:.1f} s")
    return out, results


# ---------------------------------------------------------------------------
# phase 16: the serve engine and the tracing utilities on idefics2-8b-base
# ---------------------------------------------------------------------------

# scripts/bench_serve.py's traffic: 64 text requests, prompts uniform in [96, 512),
# 10 new tokens; the engine with 32 slots, buckets (128, 256, 512), decode_block 5;
# the static baseline in batches of 16 padded to 512
SERVE_REQUESTS = 64
SERVE_SLOTS = 32
SERVE_MAX_LEN = 544
SERVE_BUCKETS = (128, 256, 512)
SERVE_BLOCK = 5
STATIC_BATCH = 16
# scripts/bench_serve_varlen.py's: a budget of 64 tokens, max_len 576, decode_block
# 8, the lm head's EOS column scaled by 4 so that greedy decoding ends early and
# unevenly
VARLEN_BUDGET = 64
VARLEN_MAX_LEN = 576
VARLEN_BLOCK = 8
VARLEN_EOS_SCALE = 4.0
SERVE_IMAGES = 8
TRACE_BUCKET = 256


class CallSpy:
    """While the block runs, ``module.name`` is wrapped: ``record(args, kwargs,
    out)`` sees every call (the engine's prefill waves, its decode steps)."""

    def __init__(self, module, name, record):
        self.module, self.name, self.record = module, name, record

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def spy(*args, **kwargs):
            out = self.orig(*args, **kwargs)
            self.record(args, kwargs, out)
            return out

        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def prefill_spy(waves):
    """Records (prompt ids [A, bucket], attention mask, last logits [A, V]) of
    every prefill wave of the engine."""
    from mimic_tpu_torch.serve import engine as teng

    def record(args, kwargs, out):
        batch = args[2]
        waves.append((batch.input_ids, batch.attention_mask, out[0].float()))

    return CallSpy(teng, "_prefill", record)


def wave_logits(waves):
    """{prompt ids (unpadded, as a tuple): its prefill's last logits [V]}."""
    out = {}
    for ids, mask, logits in waves:
        for row in range(ids.shape[0]):
            key = tuple(ids[row][mask[row].bool()].tolist())
            out[key] = logits[row]
    return out


def serve_traffic(n, lo, hi, new, seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi, size=n)
    return [(rng.integers(300, 32000, size=int(L)).astype(np.int32), new) for L in lens]


def serve(eng, reqs, **fields):
    """Submit every request (``fields[name][i]`` as request i's field), run;
    (token lists by uid, synchronised wall s)."""
    from mimic_tpu_torch.serve import ServeRequest

    torch.cuda.synchronize()
    t = time.perf_counter()
    for uid, (ids, new) in enumerate(reqs):
        eng.submit(ServeRequest(uid=uid, input_ids=ids, max_new_tokens=new,
                                **{k: v[uid] for k, v in fields.items()}))
    results = eng.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    if [r.uid for r in results] != list(range(len(reqs))):
        raise AssertionError("the engine lost or reordered requests")
    return [r.tokens for r in results], secs


def check_tokens(label, toks, reqs, vocab, eos):
    """At most the budget, below the vocabulary, cut before any EOS."""
    for t, (_, new) in zip(toks, reqs):
        if len(t) > new or any(not 0 <= x < vocab or x == eos for x in t):
            raise AssertionError(f"{label}: bad tokens {t}")


def serve_expected(waves, steps, L, mode):
    """The exact launches of an engine run from its waves [(rows, bucket)] and
    decode steps: the prefill runs the attention forward in every layer;
    "int8" decodes through int8_matmul (fused qkv and o of each layer, the lm
    head) and fused_mlp_int8; "int8-w8a8" also prefills through the int8
    handles: w8a8_matmul and quantize_rows for the four products of each
    layer where M = rows x bucket reaches W8A8_MIN_M, else as a decode step,
    and its lm head (M = rows) through int8_matmul."""
    from mimic_tpu_torch.ops.quant import W8A8_MIN_M

    want = dict.fromkeys(KERNEL_META, 0)
    want["onepass_fwd"] = L * len(waves)
    if mode == "bf16":
        return want
    want["int8_matmul"] = (2 * L + 1) * steps
    want["fused_mlp_int8"] = L * steps
    if mode == "int8-w8a8":
        for rows, bucket in waves:
            if rows * bucket >= W8A8_MIN_M:
                want["w8a8_matmul"] += 4 * L
                want["quantize_rows"] += 4 * L
                want["int8_matmul"] += 1
            else:
                want["int8_matmul"] += 2 * L + 1
                want["fused_mlp_int8"] += L
    return want


def serve_counted(label, eng, reqs, mode, **fields):
    """Warm-up, then the counted and timed run: its launches must be
    ``serve_expected``'s exactly; returns (tokens, seconds, launches, {prompt:
    prefill logits})."""
    L = eng.cfg.text.num_layers
    serve(eng, reqs, **fields)
    waves = []
    _reset_counts()
    blocks = eng.blocks_run
    torch.cuda.reset_peak_memory_stats()
    with prefill_spy(waves):
        toks, secs = serve(eng, reqs, **fields)
    got = {k: v for k, v in _counts().items() if k in KERNEL_META}
    steps = (eng.blocks_run - blocks) * eng.decode_block
    shapes = [tuple(ids.shape) for ids, _, _ in waves]
    want = serve_expected(shapes, steps, L, mode)
    log(f"[serve] {label}: {len(reqs)} requests in {secs:.3f} s = {len(reqs) / secs:.3f} q/s; "
        f"{len(waves)} prefill waves (rows x bucket {shapes}), {steps} decode steps of "
        f"{eng.S} slots; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"launches {got}")
    if got != want:
        raise AssertionError(f"{label}: launches {got}, want {want}")
    return toks, secs, got, wave_logits(waves)


def first_decode_logits(eng, reqs):
    """The last logits [S, V] of the engine's first decode step on ``reqs``."""
    from mimic_tpu_torch.serve import engine as teng

    logits = []
    with CallSpy(teng, "lvlm_forward", lambda a, k, out: logits.append(out.logits[:, -1].float())):
        serve(eng, reqs)
    return logits[0]


def phase_serve_8b(runner):
    """Phase 16 on the bf16 8B runner: (a), (b), (d), (e), (f), (c), (g);
    returns the launches of each counted run by its name."""
    import tempfile

    from mimic_tpu_torch.config import get_preset
    from mimic_tpu_torch.models import generate as tg
    from mimic_tpu_torch.models.feature_cache import VisionFeatureCache, image_key
    from mimic_tpu_torch.models.lvlm import LVLMBatch
    from mimic_tpu_torch.ops.quant import quantize_lm_params
    from mimic_tpu_torch.serve import ServeEngine
    from mimic_tpu_torch.shift.params import init_shift_params
    from mimic_tpu_torch.utils import tracing as ttr

    cfg, tk = runner.cfg, runner.tokenizer
    V, L, eos, pad = cfg.text.vocab_size, cfg.text.num_layers, tk.eos_token_id, tk.pad_token_id
    params = runner.params
    shift = init_shift_params(get_preset("mimic")[0], cfg.text,
                              torch.Generator(device="cuda").manual_seed(1), torch.device("cuda"))
    engine_kw = dict(num_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN, prefill_buckets=SERVE_BUCKETS,
                     decode_block=SERVE_BLOCK, shift=shift, eos_token_id=eos)
    reqs = serve_traffic(SERVE_REQUESTS, 96, 512, MAX_NEW_TOKENS, seed=0)
    launches = {}
    t0 = time.perf_counter()

    # (a) mixed-prompt serving in bf16 with the shift, against the static baseline
    eng = ServeEngine(cfg, params, **engine_kw)
    toks, secs, launches["engine bf16"], firsts = serve_counted("(a) engine, bf16", eng, reqs,
                                                                 "bf16")
    check_tokens("(a)", toks, reqs, V, eos)
    profile_run("engine bf16", lambda: serve(eng, reqs)[1])
    cos = []
    with torch.no_grad():
        for ids, _ in reqs:
            alone, _, _ = tg._prefill(
                params, cfg, LVLMBatch(input_ids=torch.from_numpy(ids).long()[None].cuda(),
                                       attention_mask=torch.ones(1, len(ids), dtype=torch.int32,
                                                                 device="cuda")),
                len(ids), shift, "masked", torch.bfloat16, "flash")
            cos.append(_row_cosine(firsts[tuple(ids.tolist())][None], alone))
    log(f"[serve] (a) each request's first-token prefill logits in its left-padded wave vs "
        f"prefilled alone, unpadded: min row cosine {min(cos):.6f} (need >= {MIN_LOGIT_COSINE})")
    if min(cos) < MIN_LOGIT_COSINE:
        raise AssertionError("(a) the engine's prefill disagrees with the unpadded prefill")

    def static():
        out = []
        for i in range(0, len(reqs), STATIC_BATCH):
            chunk = reqs[i:i + STATIC_BATCH]
            ids = np.full((len(chunk), SERVE_BUCKETS[-1]), pad, np.int64)
            mask = np.zeros(ids.shape, np.int32)
            for r, (p, _) in enumerate(chunk):
                ids[r, -len(p):], mask[r, -len(p):] = p, 1
            batch = LVLMBatch(input_ids=torch.from_numpy(ids).cuda(),
                              attention_mask=torch.from_numpy(mask).cuda())
            out.append(tg.greedy_generate(params, cfg, batch, max_new_tokens=MAX_NEW_TOKENS,
                                          eos_token_id=eos, pad_token_id=pad, shift=shift,
                                          logz2="masked", attn_impl="flash").tokens)
        return torch.cat(out).cpu()

    static()
    torch.cuda.synchronize()
    start = time.perf_counter()
    stoks = static()
    static_secs = time.perf_counter() - start
    same = sum(got == (row[: row.index(eos)] if eos in row else row)
               for got, row in zip(toks, stoks.tolist()))
    log(f"[serve] (a) static baseline (batches of {STATIC_BATCH} padded to {SERVE_BUCKETS[-1]}, "
        f"greedy_generate): {static_secs:.3f} s = {len(reqs) / static_secs:.3f} q/s against the "
        f"engine's {len(reqs) / secs:.3f} q/s; {same} of {len(reqs)} requests' tokens equal "
        f"the static run's (not gated: bf16 ties can flip tokens)")
    del eng

    # (b) "int8": the bf16 tree prefills, set_quant("int8")'s copy decodes
    runner.set_quant("int8")
    qparams = runner.decode_params
    eng = ServeEngine(cfg, params, decode_params=qparams, **engine_kw)
    toks, _, launches["engine int8"], _ = serve_counted("(b) engine, int8", eng, reqs, "int8")
    check_tokens("(b)", toks, reqs, V, eos)
    first = [(ids, 2) for ids, _ in reqs[:SERVE_SLOTS]]
    a = first_decode_logits(eng, first)
    del eng
    deq = dequantized_tree(qparams)
    b = first_decode_logits(ServeEngine(cfg, params, decode_params=deq, **engine_kw), first)
    del deq, qparams
    runner.set_quant(None)
    c = _row_cosine(a, b)
    log(f"[serve] (b) first decode step of {SERVE_SLOTS} slots, int8 kernels vs a bf16 tree "
        f"dequantized from the same handles: max abs diff {(a - b).abs().max().item():.4f}, "
        f"min row cosine {c:.6f} (need >= {MIN_LOGIT_COSINE})")
    if c < MIN_LOGIT_COSINE or not torch.isfinite(a).all():
        raise AssertionError("(b) the int8 decode disagrees with the dequantized tree")

    # (d) EOS-variable traffic: reclamation on and off, identical tokens
    lm = dict(params["lm"], lm_head=params["lm"]["lm_head"].clone())
    lm["lm_head"][:, eos] *= VARLEN_EOS_SCALE
    eos_params = dict(params, lm=lm)
    var = serve_traffic(SERVE_REQUESTS, 96, 512, VARLEN_BUDGET, seed=0)
    runs = {True: [], False: []}
    for reclaim in (True, False):
        e = ServeEngine(cfg, eos_params, reclaim=reclaim, **dict(
            engine_kw, max_len=VARLEN_MAX_LEN, decode_block=VARLEN_BLOCK))
        vtoks, vsecs = serve(e, var)
        runs[reclaim].append((vtoks, len(var) / vsecs, e.blocks_run, e.reclaimed_blocks,
                              e.host_syncs))
        del e
    (on, *_), (off, *_) = runs[True][-1], runs[False][-1]
    lens = [len(t) for t in on]

    def summary(rs):
        _, _, blocks, reclaimed, syncs = rs[-1]
        return (f"{', '.join(f'{r[1]:.3f}' for r in rs)} q/s ({blocks} blocks, {reclaimed} "
                f"reclaimed, {syncs} host syncs a run)")

    log(f"[serve] (d) EOS-variable traffic ({SERVE_REQUESTS} requests, budget {VARLEN_BUDGET}, "
        f"decode_block {VARLEN_BLOCK}, EOS column x{VARLEN_EOS_SCALE}): generated lengths mean "
        f"{np.mean(lens):.1f}, min {min(lens)}, max {max(lens)}; reclaim on "
        f"{summary(runs[True])}, off {summary(runs[False])}")
    if on != off or runs[True][-1][3] <= 0 or runs[False][-1][4] != 1:
        raise AssertionError("(d) reclamation changed the tokens or reclaimed nothing")
    check_tokens("(d)", on, var, V, eos)
    del runs, eos_params, lm

    # (e) image requests: features encoded once (the feature cache), admitted as
    # (base, row), against the same requests admitted with their pixels
    images = [synthetic_image(70 + i) for i in range(SERVE_IMAGES)]
    encs = [runner.processor([[im]], [f"Image:<image> {synthetic_text(80 + i, 60 + 20 * i)}"
                                      f"Question: what is in the image? Answer:"])
            for i, im in enumerate(images)]
    img_reqs = [(e["input_ids"][0].astype(np.int32), MAX_NEW_TOKENS) for e in encs]
    pixels = np.concatenate([e["pixel_values"] for e in encs])
    masks = np.concatenate([e["patch_mask"] for e in encs])
    base = VisionFeatureCache().get_features(params, cfg, pixels, masks,
                                             [image_key(im) for im in images], attn_impl="flash")
    eng = ServeEngine(cfg, params, **engine_kw)
    ftoks, _, launches["engine features"], fl = serve_counted(
        "(e) 980 px image requests, features from the cache", eng, img_reqs, "bf16",
        image_feats=[(base, i) for i in range(SERVE_IMAGES)])
    _reset_counts()
    waves = []
    with prefill_spy(waves):
        ptoks, _ = serve(eng, img_reqs, pixel_values=list(pixels), patch_mask=list(masks))
    launches["engine pixels"] = {k: v for k, v in _counts().items() if k in KERNEL_META}
    pl = wave_logits(waves)
    c = min(_row_cosine(fl[k][None], pl[k][None]) for k in fl)
    same = sum(x == y for x, y in zip(ftoks, ptoks))
    log(f"[serve] (e) prefill logits, features admitted as (base, row) vs pixels admitted "
        f"(the ViT in each of {len(waves)} waves: launches {launches['engine pixels']}): min row "
        f"cosine {c:.6f} (need >= {MIN_LOGIT_COSINE}); equal tokens in {same} of {SERVE_IMAGES} "
        f"requests")
    if c < MIN_LOGIT_COSINE or launches["engine pixels"]["onepass_fwd"] != (
            (cfg.vision.num_layers + L) * len(waves)):
        raise AssertionError("(e) feature admission disagrees with pixel admission")
    del eng, base

    # (f) the tracing utilities at 8B, attention through the kernels
    runner.tokenizer.padding_side = "left"
    batch = runner.process_input([[images[0]]], ["Image:<image> Question: what is in the image? "
                                                 "Answer:"], pad_to=TRACE_BUCKET)
    T, D = batch.input_ids.shape[1], cfg.text.hidden_size
    with torch.no_grad():
        _reset_counts()
        logits, caps = ttr.capture_forward(params, cfg, batch, attn_impl="flash")
        got = {k: v for k, v in _counts().items() if k in KERNEL_META}
    launches["capture_forward"] = got
    log(f"[trace] (f) capture_forward at 8B: logits {tuple(logits.shape)}, captures attn "
        f"{tuple(caps['attn'].shape)} and ffn {tuple(caps['ffn'].shape)}; launches {got}")
    if (logits.shape != (1, T, V) or caps["attn"].shape != (L, 1, T, D)
            or caps["ffn"].shape != (L, 1, T, D) or not torch.isfinite(logits).all()
            or got["onepass_fwd"] != cfg.vision.num_layers + L):
        raise AssertionError(f"(f) capture_forward: shapes {tuple(logits.shape)}, "
                             f"{tuple(caps['attn'].shape)} or launches {got}")
    del logits, caps
    loss_fn = lambda lg: lg[:, -1].float().logsumexp(-1).sum()
    _reset_counts()
    grads = ttr.capture_grads(params, cfg, batch, loss_fn, attn_impl="flash")
    got = {k: v for k, v in _counts().items() if k in KERNEL_META}
    launches["capture_grads"] = got
    plain = ttr.capture_grads(params, cfg, batch, loss_fn, attn_impl="xla")
    gcos = {k: torch.nn.functional.cosine_similarity(grads[k].flatten().float(),
                                                     plain[k].flatten().float(), dim=0).item()
            for k in grads}
    log(f"[trace] (f) capture_grads at 8B (T {T}): launches {got}; gradients through the "
        f"kernels vs the plain path: cosine attn {gcos['attn']:.6f}, ffn {gcos['ffn']:.6f} "
        f"(need >= {MIN_GRAD_COSINE})")
    if got["flash_bwd_dq"] != L - 1 or got["flash_bwd_dkv"] != L - 1 or min(
            gcos.values()) < MIN_GRAD_COSINE or not torch.isfinite(grads["attn"]).all():
        raise AssertionError("(f) capture_grads: launches or gradients wrong")
    del grads, plain
    with torch.no_grad():
        probs = ttr.attention_probs(params, cfg, batch, layer=L // 2, attn_impl="flash")
    live = batch.attention_mask[0].bool()
    rows = probs[0][:, live]
    upper = torch.ones(T, T, dtype=torch.bool, device="cuda").triu(1)[live]
    serr, uerr = (rows.sum(-1) - 1).abs().max().item(), rows[:, upper].abs().max().item()
    log(f"[trace] (f) attention_probs of layer {L // 2}: {tuple(probs.shape)}, rows sum to 1 "
        f"within {serr:.2e} (need 1e-3), largest probability above the diagonal {uerr:.2e}")
    if probs.shape != (1, cfg.text.num_heads, T, T) or serr > 1e-3 or uerr > 0:
        raise AssertionError("(f) attention_probs: not a causal distribution")
    del probs
    with tempfile.TemporaryDirectory(prefix="mimic_trace_") as trace_dir:
        with torch.no_grad(), ttr.profile(trace_dir):
            ttr.capture_forward(params, cfg, batch, attn_impl="flash")
            torch.cuda.synchronize()
        with open(os.path.join(trace_dir, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    log(f"[trace] (f) profile: trace.json holds {len(events)} events, {len(kernels)} kernels on "
        f"the card (e.g. {kernels[0]['name'][:60] if kernels else None!r})")
    if not kernels:
        raise AssertionError("(f) profile: the trace lists no kernel on the card")

    # (c) "int8-w8a8": the engine on a W8A8 tree (the runner's stays bf16)
    from mimic_tpu_torch.models import decoder as td

    w8 = quantize_lm_params(params, act_quant=True)
    eng = ServeEngine(cfg, w8, **engine_kw)
    wtoks, _, launches["engine int8-w8a8"], wl = serve_counted("(c) engine, int8-w8a8", eng,
                                                               reqs, "int8-w8a8")
    check_tokens("(c)", wtoks, reqs, V, eos)
    del eng
    # none of the rounding is the kernels': every wave prefilled again through the
    # plain W8A8 functions on the card gives the engine's logits bit for bit
    waves, equal = [], []
    with prefill_spy(waves):
        serve(ServeEngine(cfg, w8, **engine_kw), reqs)
    orig_qdot, td.qdot = td.qdot, qdot_w8a8_plain
    try:
        with torch.no_grad():
            for ids, mask, logits in waves:
                plain, _, _ = tg._prefill(w8, cfg, LVLMBatch(input_ids=ids, attention_mask=mask),
                                          ids.shape[1], shift, "masked", torch.bfloat16, "flash")
                equal.append(torch.equal(plain.float(), logits))
    finally:
        td.qdot = orig_qdot
    # what the rows' rounding costs: against a bf16 tree dequantized from the same
    # handles (phase 11's comparison at call A) and against the bf16 tree of (a)
    dwaves = []
    deq = dequantized_tree(w8)
    with prefill_spy(dwaves):
        serve(ServeEngine(cfg, deq, **engine_kw), reqs)
    del deq, w8
    dl = wave_logits(dwaves)
    cos = sorted(_row_cosine(wl[k][None], dl[k][None]) for k in wl)
    cb = min(_row_cosine(wl[k][None], firsts[k][None]) for k in wl)
    log(f"[serve] (c) int8-w8a8 prefill waves through w8a8_matmul equal to the plain W8A8 "
        f"functions on the card, bit for bit: {equal}; prefill logits request by request vs a "
        f"bf16 tree dequantized from the same handles: row cosine min {cos[0]:.6f}, median "
        f"{cos[len(cos) // 2]:.6f}, {sum(c < MIN_W8A8_COSINE for c in cos)} of {len(cos)} below "
        f"{MIN_W8A8_COSINE}; vs the bf16 tree of (a), weights rounded too: min {cb:.6f}")
    if not all(equal) or len(equal) != len(waves):
        raise AssertionError("(c) the W8A8 prefill through the kernels differs from the plain path")

    # (g) a tiny fp32 engine on the card: the CPU's tokens
    phase_tiny_engine()
    log(f"[serve] phase 16 in {time.perf_counter() - t0:.1f} s; {card_line()}")
    return launches


# ---------------------------------------------------------------------------
# phase 17: the parallel layer (ring attention's blocks, the mesh path)
# ---------------------------------------------------------------------------

# (ranks, T) of the ring harness at idefics2-8b's width: B2, H32/8, D128, causal,
# a left-padded key mask and lse_u; each rank's chunk C = T / n = 1024 keys
RING_CASES = ((4, 4096), (2, 2048))


def ring_forward(q, k, v, km, n, need_unmasked):
    """The ring's forward in one process: each of n ranks' query chunks over
    every rank's K/V block through ``ring_block``, merged by ``RingMerge``,
    and the chunks' (out, lse, lse_u) concatenated along T."""
    from mimic_tpu_torch.ops.ring_attention import RingMerge, ring_block

    C = q.shape[1] // n
    parts = []
    for r in range(n):
        merge, rows = RingMerge(), slice(r * C, (r + 1) * C)
        for j in range(n):
            cols = slice(j * C, (j + 1) * C)
            merge.add(*ring_block(q[:, rows], k[:, cols], v[:, cols], km[:, cols], r, j,
                                  True, None, need_unmasked))
        parts.append(merge.result(q.dtype))
    return [torch.cat([p[i] for p in parts], dim=1) for i in range(3)]


def ring_harness(n, T):
    """The ring of n ranks in one process: each rank's query chunk over every
    rank's K/V block through ``ring_block`` and ``RingMerge`` (what
    ``ring_attention`` runs; the exchange is replaced by indexing the n
    chunks), against one forward-kernel call on the whole sequence by phase
    2's bf16 gates; exactly n² forward launches; both device times."""
    from mimic_tpu_torch.ops import flash_attention as tfa

    B, H, Hkv, D = 2, 32, 8, 128
    q, k, v, km = kernel_inputs(70 + n, B, T, T, H, Hkv, D, left_padded_mask(B, T, (0, 300)))

    def ring():
        return ring_forward(q, k, v, km, n, True)

    def single():
        return tfa._dispatch(q, k, v, km, True, None, True)

    tfa.reset_launch_counts()
    got = ring()
    torch.cuda.synchronize()
    launches = dict(tfa.LAUNCHES)
    if sum(launches.values()) != n * n:
        raise AssertionError(f"ring of {n}: {launches} forward launches, want {n * n}")
    want = single()
    allowed = (km[:, None, :] > 0) & torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    valid = allowed.any(-1)  # rows with an attendable key
    for field, a in zip(("out", "lse", "lse_u"), got):
        if not torch.isfinite(a.float()).all():
            raise AssertionError(f"ring of {n}: {field} has non-finite values")
    ref, diff = want[0].float(), got[0].float() - want[0].float()
    err = {"out": diff.abs().max().item(),
           "lse": (got[1] - want[1]).abs()[valid].max().item(),
           "lse_u": (got[2] - want[2]).abs().max().item()}
    tol_out = min(TOL_OUT_BF16, OUT_BF16_STEP * ref.abs().max().item() + OUT_BF16_ABS)
    rel_rms = (diff.square().mean().sqrt() / ref.square().mean().sqrt()).item()
    ring_ms, single_ms = cuda_ms(ring, 5), cuda_ms(single, 5)
    log(f"[parallel] ring of {n} ranks, B{B} T=S={T} H{H}/{Hkv} D{D} causal, left-padded, "
        f"lse_u: launches {launches} (n² = {n * n}); against one {'onepass_fwd' if T <= 3072 else 'flash_fwd'} "
        f"call: max abs err out {err['out']:.3e} (tol {tol_out:.3e}), out rms err / rms "
        f"{rel_rms:.3e} (tol {OUT_BF16_REL_RMS:.3e}), lse {err['lse']:.3e} lse_u "
        f"{err['lse_u']:.3e} (tol {TOL_LSE_BF16}); device time: the ring's blocks and merges "
        f"{ring_ms:.3f} ms, the single call {single_ms:.3f} ms")
    if not (err["out"] <= tol_out and rel_rms <= OUT_BF16_REL_RMS
            and err["lse"] <= TOL_LSE_BF16 and err["lse_u"] <= TOL_LSE_BF16):
        raise AssertionError(f"ring of {n} ranks disagrees with the single call: {err}")


def ring_block_kinds(args, n):
    """Both backward kernels (``flash_attention_backward``, given the chunk's
    Δ as the ring gives it) on one C = T / n block of each kind the ring
    runs (past: rank 1 over block 0, non-causal; diagonal: rank 1 over block
    1, causal; future, with need_unmasked only: rank 1 over block 2, no
    attendable key) against the plain backward on the same block inputs, by
    TOL_BWD_BF16 on dq, dk and dv; then each kernel launched straight through
    the library (device time through a CUDA graph) beside the block's bound,
    and the plain backward's time (dq, dk and dv in one call)."""
    from mimic_tpu_torch.ops import flash_backward as tfb

    q, k, v, km, out, lse, lse_u, g_out, g_lse, g_lse_u, _, _, need_unmasked = args
    C = q.shape[1] // n
    chunk = lambda x, r: x[:, r * C:(r + 1) * C]  # noqa: E731
    rows = [chunk(x, 1) for x in (q, out, lse, lse_u, g_out)]
    g_rows = [chunk(x, 1) if x is not None else torch.zeros_like(rows[2]) for x in (g_lse, g_lse_u)]
    delta = (rows[4].float() * rows[1].float()).sum(-1)
    kinds = (("past", 0, False), ("diagonal", 1, True), ("future", 2, False))
    result = {}
    for kind, j, causal in kinds if need_unmasked else kinds[:2]:
        km_j = chunk(km, j) if kind != "future" else torch.zeros_like(chunk(km, j))
        q_r, o_r, l_r, lu_r, g_r = rows
        block = (q_r, chunk(k, j), chunk(v, j), km_j, o_r, l_r, lu_r, g_r, *g_rows, causal, None,
                 need_unmasked)
        block = tuple(x.contiguous() if torch.is_tensor(x) else x for x in block)
        got = tfb.flash_attention_backward(*block, delta=delta)
        want = tfb.flash_attention_backward_plain(*block, delta=delta)
        torch.cuda.synchronize()
        errs = {}
        for field, a, b in zip(("dq", "dk", "dv"), got, want):
            if not torch.isfinite(a.float()).all():
                raise AssertionError(f"ring block ({kind}): {field} has non-finite values")
            # a future block's dv is exactly zero (no key is attended): there
            # the error is absolute
            ref = b.float().abs().max().item()
            errs[field] = (a.float() - b.float()).abs().max().item() / (ref if ref > 0 else 1.0)
        if not max(errs.values()) <= TOL_BWD_BF16:
            raise AssertionError(f"ring block ({kind}, need_unmasked={need_unmasked}): the "
                                 f"kernels disagree with the plain backward: {errs}")
        del got, want
        bounds = backward_bounds(block)
        plain_ms = cuda_ms(lambda: tfb.flash_attention_backward_plain(*block, delta=delta), 3)
        result[kind] = {"errs": errs, "plain_ms": plain_ms, **{
            name: {"ms": cuda_ms(backward_launcher(block, name), 10, graph=True), **bounds[name]}
            for name in tfb.KERNELS}}
    return result


def ring_backward_harness(n, T):
    """17(c): the ring's backward at idefics2-8b's width in one process
    (``ring_attention_backward_chunks``: the schedule every rank runs, the
    exchange replaced by indexing the n chunks) against one
    ``flash_attention_backward`` call on the whole sequence with the same
    merged forward, by TOL_BWD_BF16 on dq, dk and dv: random bf16 g_out with
    (a) a random fp32 g_lse_u and lse_u, n² launches of each kernel, (b) a
    random g_lse without need_unmasked, n(n+1)/2 (the future blocks add
    exactly zero and are skipped).  Device times of the ring, the single
    call, and the Δ passes that computing Δ once per chunk saves; at n = 4
    each block kind's kernels against the plain backward
    (``ring_block_kinds``)."""
    from mimic_tpu_torch.ops import flash_backward as tfb
    from mimic_tpu_torch.ops.ring_attention import ring_attention_backward_chunks

    B, H, Hkv, D = 2, 32, 8, 128
    q, k, v, km = kernel_inputs(80 + n, B, T, T, H, Hkv, D, left_padded_mask(B, T, (0, 300)))
    gen = torch.Generator(device="cuda").manual_seed(90 + n)
    g_out = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
    g_lse = torch.randn(B, T, H, generator=gen, device="cuda")
    C = T // n
    for label, need_unmasked, cot, want_launches in (
            ("g_out + g_lse_u, lse_u", True, (None, g_lse), n * n),
            ("g_out + g_lse, masked", False, (g_lse, None), n * (n + 1) // 2)):
        fwd = ring_forward(q, k, v, km, n, need_unmasked)
        args = (q, k, v, km, *fwd, g_out, *cot, True, None, need_unmasked)
        # the Δ pass the ring makes once per chunk, on one chunk
        delta_ms = cuda_ms(lambda: (g_out[:, :C].float() * fwd[0][:, :C].float()).sum(-1), 10,
                           graph=True)

        def ring():
            return ring_attention_backward_chunks(*args[:10], n, causal=True,
                                                  need_unmasked=need_unmasked)

        tfb.reset_launch_counts()
        got = ring()
        torch.cuda.synchronize()
        launches = dict(tfb.LAUNCHES)
        if launches != dict.fromkeys(tfb.KERNELS, want_launches):
            raise AssertionError(f"ring backward of {n} ({label}): launches {launches}, want "
                                 f"{want_launches} of each")
        want = tfb.flash_attention_backward(*args)
        torch.cuda.synchronize()
        errs = {}
        for field, a, b in zip(("dq", "dk", "dv"), got, want):
            if not torch.isfinite(a.float()).all():
                raise AssertionError(f"ring backward of {n} ({label}): {field} not finite")
            errs[field] = ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
        del got, want
        ring_ms = cuda_ms(ring, 3)
        single_ms = cuda_ms(lambda: tfb.flash_attention_backward(*args), 3)
        log(f"[parallel] ring backward of {n} ranks, B{B} T=S={T} H{H}/{Hkv} D{D} causal, "
            f"left-padded, {label}: launches {launches}; against one flash_attention_backward "
            f"call on the whole sequence with the same merged forward: max err / max |ref| "
            + " ".join(f"{f} {e:.3e}" for f, e in errs.items()) + f" (tol {TOL_BWD_BF16}); "
            f"device time: the ring's blocks (kernels, Δ and fp32 sums) {ring_ms:.3f} ms, the "
            f"single call {single_ms:.3f} ms; Δ once per chunk instead of once per block saves "
            f"{want_launches - n} Δ passes of {delta_ms:.4f} ms (C {C}, device time) = "
            f"{(want_launches - n) * delta_ms:.4f} ms")
        if not max(errs.values()) <= TOL_BWD_BF16:
            raise AssertionError(f"ring backward of {n} ({label}) disagrees: {errs}")
        if n == 4:
            for kind, t in ring_block_kinds(args, n).items():
                log(f"[parallel] ring block C {C} ({kind}, {label}): the kernels against the "
                    "plain backward on the block: max err / max |ref| (absolute where the "
                    "reference is all zero) " + " ".join(
                        f"{f} {e:.3e}" for f, e in t["errs"].items()) + f" (tol {TOL_BWD_BF16}); "
                    + ", ".join(f"{name} {x['ms']:.4f} ms ({x['bound_ms'] / x['ms']:.1%} of its "
                                f"{bound_text(x)})" for name, x in ((m, t[m]) for m in tfb.KERNELS))
                    + f"; plain backward (dq, dk, dv) {t['plain_ms']:.3f} ms; no PyTorch call "
                    "gives these gradients (lse and lse_u carry gradient)")


# a ring of one rank is one diagonal block through the flash path's kernels, on
# the same inputs: the "ring" step at ring_min_len 0 against the "flash" step
RING1_LOSS_RTOL = 1e-6
RING1_MIN_GRAD_COSINE = 0.9999
# (label, ring_min_len, shift_remat): 17(b) the record pass alone on the ring;
# 17(d) both passes, the shift pass's backward through RingAttentionDiff
RING_STEPS = (("17(b)", 1024, False), ("17(d)", 0, False), ("17(d) remat", 0, True))


def parallel_train_8b(runner):
    """The phase-5 step (mimic preset, phase 5's batch on precomputed image
    features) with attn_impl="ring" on a one-rank (data x sp) mesh, against
    the "flash" step from the same shift: 17(b) at ring_min_len 1024, 17(d)
    at JAX's default 0 (both passes on the ring), once more under
    shift_remat."""
    from torch.distributed.device_mesh import init_device_mesh

    from mimic_tpu_torch.config import get_preset
    from mimic_tpu_torch.models.decoder import ATTN_PATH_LOG
    from mimic_tpu_torch.models.lvlm import encode_images
    from mimic_tpu_torch.ops import flash_attention as tfa
    from mimic_tpu_torch.ops import flash_backward as tfb
    from mimic_tpu_torch.shift.params import (init_shift_params, multi_head, needs_attn_capture,
                                               needs_ffn_capture)
    from mimic_tpu_torch.train import step as ts
    from mimic_tpu_torch.train.optim import build_optimizer

    cfg, frozen = runner.cfg, runner.params
    L = cfg.text.num_layers
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "sp"))
    enc, peft = get_preset("mimic")
    shift0 = init_shift_params(enc, cfg.text, torch.Generator(device="cuda").manual_seed(2),
                               torch.device("cuda"))
    batch = make_train_batch(cfg)
    with torch.no_grad():
        feats = {f"{p}_feats": encode_images(frozen, cfg, batch[f"{p}_pixels"],
                                             batch[f"{p}_patch_mask"], attn_impl="flash")
                 for p in ("full", "query")}
    fb = {k: v for k, v in batch.items() if "pixels" not in k and "patch" not in k}
    fb.update(feats)
    common = dict(ce_loss_weight=peft.ce_loss_weight, align_loss_weight=peft.align_loss_weight,
                  logz2="unmasked")
    loss_kw = dict(cfg=cfg, strategy=enc.strategy(), rec_attn=needs_attn_capture(enc),
                   rec_ffn=needs_ffn_capture(enc), mh=multi_head(enc), **common)

    def one_step(attn_impl, **kw):
        """One counted step: (updated shift, metrics, seconds, launches, paths)."""
        tree = {"shift": {k: v.clone() for k, v in shift0.items()}}
        tx = build_optimizer(tree, lr=peft.lr, weight_decay=1e-3, warmup_steps=0,
                             total_steps=1000, grad_clip=1.0)
        step = ts.make_train_step(cfg, enc, tx, attn_impl=attn_impl, **common, **kw)
        torch.cuda.synchronize()
        tfa.reset_launch_counts()
        tfb.reset_launch_counts()
        ATTN_PATH_LOG.clear()
        t = time.perf_counter()
        state, m = step(ts.TrainState(tree, tx.init(tree), 0), frozen, fb)
        torch.cuda.synchronize()
        return (state.trainable["shift"], {k: float(v) for k, v in m.items()},
                time.perf_counter() - t, {**tfa.LAUNCHES, **tfb.LAUNCHES}, list(ATTN_PATH_LOG))

    def gradients(attn_impl, **kw):
        leaves = {k: v.detach().clone().requires_grad_(True) for k, v in shift0.items()}
        with torch.enable_grad():
            loss, _ = ts.compute_loss({"shift": leaves}, frozen, fb, attn_impl=attn_impl,
                                      **loss_kw, **kw)
            return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

    out = {}
    for i, (label, min_len, remat) in enumerate(RING_STEPS):
        ring_kw = dict(ring_mesh=mesh, ring_axis="sp", ring_batch_axis="data",
                       ring_min_len=min_len)
        if i == 0:
            one_step("ring", **ring_kw)  # warm-up
        ring_shift, ring_m, ring_s, launches, paths = one_step("ring", shift_remat=remat,
                                                               **ring_kw)
        flash_shift, flash_m, flash_s, flash_launches, _ = one_step("flash", shift_remat=remat)
        log(f"[parallel] {label}: 8B step, attn_impl=\"ring\" on a one-rank (data 1 x sp 1) "
            f"NCCL mesh, ring_min_len {min_len}, shift_remat {remat}, precomputed image "
            f"features: {ring_s:.3f} s, paths {paths}, launches {launches}; "
            + ", ".join(f"{k} {v:.6g}" for k, v in ring_m.items()))
        log(f"[parallel] {label}: the same step through \"flash\": {flash_s:.3f} s, launches "
            f"{flash_launches}; " + ", ".join(f"{k} {v:.6g}" for k, v in flash_m.items()))
        # the record pass rides the ring; the shift pass rides it at ring_min_len
        # 0, else stays on the one rank and takes the kernels, forward and backward
        want_paths = ["ring", "ring" if min_len == 0 else "flash"]
        if paths != want_paths:
            raise AssertionError(f"{label}: paths {paths}, want {want_paths}")
        # n² launches per ring attention (n = 1) and one per layer (and the
        # recompute's under remat); layer 0's q/k/v come from frozen embeddings,
        # so the backward pair runs for layers 1..L-1
        want = {**dict.fromkeys(launches, 0), "onepass_fwd": (3 if remat else 2) * L,
                "flash_bwd_dq": L - 1, "flash_bwd_dkv": L - 1}
        if launches != want or flash_launches != want:
            raise AssertionError(f"{label}: ring step launched {launches}, the flash step "
                                 f"{flash_launches}, want {want}")
        if not all(np.isfinite(v) for v in ring_m.values()) or not ring_m["grad_norm"] > 0:
            raise AssertionError(f"{label}: ring step metrics not finite or zero gradient: "
                                 f"{ring_m}")
        rel = abs(ring_m["loss"] - flash_m["loss"]) / abs(flash_m["loss"])
        moved = {k: (ring_shift[k] - v).abs().max().item() for k, v in shift0.items()}
        upd_cos = {k: torch.nn.functional.cosine_similarity(
            (ring_shift[k] - v).flatten().float(), (flash_shift[k] - v).flatten().float(),
            dim=0).item() for k, v in shift0.items()}
        # phase 5's gate: one step's gradients, here the ring's against the kernels'
        g_ring = gradients("ring", ring_kwargs=ring_kw, shift_remat=remat)
        g_flash = gradients("flash", shift_remat=remat)
        cos = {k: torch.nn.functional.cosine_similarity(
            g_ring[k].flatten(), g_flash[k].flatten(), dim=0).item() for k in shift0}
        min_cos = MIN_GRAD_COSINE if min_len else RING1_MIN_GRAD_COSINE
        log(f"[parallel] {label}: ring against flash: loss relative difference {rel:.3e}"
            f"{f' (tol {RING1_LOSS_RTOL})' if not min_len else ''}; gradient cosine {cos} "
            f"(need >= {min_cos}); shift max |change| {moved}; update cosine {upd_cos}")
        if (min(cos.values()) < min_cos or not all(x > 0 for x in moved.values())
                or (not min_len and rel > RING1_LOSS_RTOL)):
            raise AssertionError(f"{label}: the ring step disagrees with the flash step")
        out[f"ring train step {label}"] = launches
    return out


def parallel_call_a(runner):
    """Call A under use_mesh(make_mesh(1, 1)) against call A without a mesh."""
    from mimic_tpu_torch import parallel

    images, texts, _ = serving_calls()["A"]
    tokenizer = runner.tokenizer

    def call_a():
        """Call A's token rows (the ids the runner decodes) and strings."""
        rows, decode = [], tokenizer.decode
        tokenizer.decode = lambda row, **kw: rows.append([int(t) for t in row]) or decode(row, **kw)
        try:
            text = runner.generate(images, texts, num_beams=NUM_BEAMS,
                                   max_new_tokens=MAX_NEW_TOKENS)
        finally:
            del tokenizer.decode
        return rows, text

    want = call_a()
    with parallel.use_mesh(parallel.make_mesh(1, 1)):
        got = call_a()
    log(f"[parallel] call A under use_mesh(make_mesh(1, 1)): tokens {got[0]}, text {got[1]}")
    if got != want or not got[0]:
        raise AssertionError(f"call A under a one-rank mesh {got} != without {want}")


def phase_parallel(runner):
    """Phase 17: (a) the ring's blocks through the forward kernels; (c) its
    backward through the backward kernels; (b), (d) the mesh path on a
    one-rank NCCL group made from a file:// store in a temporary directory."""
    import torch.distributed as dist

    t = time.perf_counter()
    for n, T in RING_CASES:
        ring_harness(n, T)
    log(f"[time] phase 17(a): {_since(t):.1f} s")
    t = time.perf_counter()
    for n, T in RING_CASES:
        ring_backward_harness(n, T)
    log(f"[time] phase 17(c): {_since(t):.1f} s")
    with tempfile.TemporaryDirectory(prefix="mimic_pg_") as store:
        dist.init_process_group("nccl", init_method=f"file://{store}/store", rank=0, world_size=1)
        try:
            t = time.perf_counter()
            launches = parallel_train_8b(runner)
            log(f"[time] phase 17(b), (d): {_since(t):.1f} s")
            parallel_call_a(runner)
        finally:
            dist.destroy_process_group()
    return launches


def phase_tiny_engine():
    from mimic_tpu_torch.config import get_preset
    from mimic_tpu_torch.models.lvlm import init_lvlm_params
    from mimic_tpu_torch.models.tokenizer import SimpleTokenizer
    from mimic_tpu_torch.serve import ServeEngine
    from mimic_tpu_torch.shift.params import init_shift_params

    tk = SimpleTokenizer(padding_side="left")
    cfg = tiny_cfg(tk)
    cpu = torch.device("cpu")
    params = init_lvlm_params(cfg, torch.Generator().manual_seed(0), cpu)
    shift = init_shift_params(get_preset("mimic")[0], cfg.text, torch.Generator().manual_seed(1),
                              cpu)
    shift["attn_v"] = shift["attn_v"] * 300.0  # make log Z2 matter to the tokens
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(4, 250, size=int(n)).astype(np.int32), 6)
            for n in rng.integers(40, 250, size=6)]
    toks = {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(cfg, params, num_slots=3, max_len=264, prefill_buckets=(128, 256),
                          decode_block=3, shift=shift, device=dev)
        toks[dev] = serve(eng, reqs)[0]
    log(f"[serve] (g) tiny fp32 engine, card vs CPU: tokens identical: "
        f"{toks['cuda'] == toks['cpu']}; {toks['cuda']}")
    if toks["cuda"] != toks["cpu"]:
        raise AssertionError("(g) the tiny engine's tokens on the card differ from the CPU's")


def lvlm_prefill(params, cfg, batch, feats, bucket, runner):
    """One cache-empty prefill of ``batch`` (the generation's first forward)."""
    from mimic_tpu_torch.models.decoder import init_kv_cache
    from mimic_tpu_torch.models.lvlm import encode_images, lvlm_forward

    with torch.no_grad():
        if feats is None:
            feats = encode_images(params, cfg, batch.pixel_values, batch.patch_mask,
                                  attn_impl="flash")
        total = bucket + MAX_NEW_TOKENS
        cache = init_kv_cache(cfg.text, batch.input_ids.shape[0], total, batch.input_ids.device,
                              torch.bfloat16)
        return lvlm_forward(params, cfg, batch, image_feats=feats, kv_total_len=total,
                            kv_cache=cache, cache_empty=True, shift=runner.shift,
                            logz2=runner.logz2, attn_impl="flash", last_logit_only=True).logits


# ---------------------------------------------------------------------------
# phase 18: a model axis that cuts inside a head
# ---------------------------------------------------------------------------

HEADSPLIT_RANKS = 8
HEADSPLIT_LAYERS = 4
HEADSPLIT_B, HEADSPLIT_T, HEADSPLIT_NEW, HEADSPLIT_PAD = 4, 1024, 8, 100
HEADSPLIT_T_SHIFT, HEADSPLIT_M = 256, 64
# a row of phase 5's 8-shot batch: 8 demo images + the query image at 980 px
# (both rows, 18 images, hold 8 ranks' activations beside each other past the
# card's 80 GB)
HEADSPLIT_IMAGES, HEADSPLIT_PATCHES = 9, 70 * 70
HEADSPLIT_LOSS_RTOL = 1e-3
# 8 ranks against one process, both bf16, both held to the same function in
# fp32 (the bf16 weights upcast, computed by one process): the 8-rank path
# makes the roundings one process makes (every bf16 activation) and adds its
# own (each row-parallel product's 8 partial sums rounded to bf16 and added in
# bf16 by gloo).  Were the added roundings as large as all of one process's,
# the two would add in quadrature to sqrt(2) x its distance; the ranks may be
# HEADSPLIT_NOISE_RATIO x as far from fp32 as one process, and no further.
# Rows are held by phase 4's logit gate (MIN_LOGIT_COSINE) besides.
HEADSPLIT_NOISE_RATIO = 1.5


def headsplit_cfg():
    """llava-interleave-7b's decoder at full width (H28/4, D128, F18944, vocab
    152128), cut to HEADSPLIT_LAYERS layers; the SigLIP tower cut to one layer
    (its weights are made, no image reaches it)."""
    import dataclasses

    from mimic_tpu_torch.models.config import get_model_config

    cfg = get_model_config("llava-interleave-7b")
    return cfg.replace(text=dataclasses.replace(cfg.text, num_layers=HEADSPLIT_LAYERS),
                       vision=dataclasses.replace(cfg.vision, num_layers=1))


def headsplit_trees(dev, mesh=None):
    """The three trees of phase 18, from fixed seeds, made on ``dev`` (bf16
    weights, the fp32 MimIC shift): llava's, the shift, and idefics2-8b-base's
    connector.  With ``mesh``: each frozen tree as ``shard_params`` cuts it (the
    whole tree freed before the next is made), the connector's moved to the
    host and back, as a tree cut on the host and then moved to the card is."""
    from mimic_tpu_torch import parallel
    from mimic_tpu_torch.bridge import tree_map
    from mimic_tpu_torch.config import get_preset
    from mimic_tpu_torch.models.config import get_model_config
    from mimic_tpu_torch.models.lvlm import init_lvlm_params
    from mimic_tpu_torch.models.vision import init_perceiver_params
    from mimic_tpu_torch.shift.params import init_shift_params

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def cut(tree):
        return tree if mesh is None else parallel.shard_params(tree, mesh)

    cfg = headsplit_cfg()
    params = cut(init_lvlm_params(cfg, gen(18), dev, torch.bfloat16))
    shift = init_shift_params(get_preset("mimic")[0], cfg.text, gen(19), dev)
    shift = {k: v * 50.0 for k, v in shift.items()}  # so that the shift moves the logits
    c2 = get_model_config("idefics2-8b-base")  # 16 query heads on 4 KV heads of 96
    connector = cut({"connector": init_perceiver_params(
        c2.perceiver, c2.vision.hidden_size, c2.text.hidden_size, gen(20), dev, torch.bfloat16,
        project_first=True)})["connector"]
    if mesh is not None:
        connector = tree_map(lambda t: t.cpu().to(dev), connector)
    return cfg, params, shift, c2, connector


def headsplit_batches(dev, cfg, c2):
    """(a)'s prompt batch (B4 x T1024, row 1 left-padded by HEADSPLIT_PAD),
    (b)'s dual-pass batch (record T 1024, shift T 256, the last 64 tokens of
    each gathered) and (c)'s image features (phase 5's 8-shot images as the
    SigLIP tower hands them on: 9 x 4900 patches x 1152, N(0, 1))."""
    from mimic_tpu_torch.models.lvlm import LVLMBatch

    g = torch.Generator(device=dev).manual_seed(21)
    B, T, Ts, M = HEADSPLIT_B, HEADSPLIT_T, HEADSPLIT_T_SHIFT, HEADSPLIT_M
    hi = min(32000, cfg.text.vocab_size)
    ids = torch.randint(hi // 2, hi, (B, T), generator=g, device=dev)
    mask = torch.ones(B, T, dtype=torch.int32, device=dev)
    mask[1, :HEADSPLIT_PAD] = 0
    prompt = LVLMBatch(input_ids=ids, attention_mask=mask)
    idx = torch.arange(M, device=dev)[None].expand(B, M)
    train = {"full_ids": ids, "full_mask": torch.ones_like(mask),
             "query_ids": torch.randint(hi // 2, hi, (B, Ts), generator=g, device=dev),
             "query_mask": torch.ones(B, Ts, dtype=torch.int32, device=dev),
             "prefix_q_idx": idx + (T - M), "shift_q_idx": idx + (Ts - M),
             "q_valid": torch.ones(B, M, dtype=torch.bool, device=dev)}
    feats = torch.randn(HEADSPLIT_IMAGES, HEADSPLIT_PATCHES, c2.vision.hidden_size, generator=g,
                        device=dev)
    return prompt, train, feats.to(torch.bfloat16)


def forced_decode(params, cfg, batch, forced, shift, dtype=torch.bfloat16, decode_params=None):
    """fp32 logits [1 + new, B, V]: the prefill's last row, then each decode
    step's, the steps fed ``forced`` [B, new] (greedy_generate's loop with the
    tokens given, so that two runs read the same inputs; the steps read
    ``decode_params`` where given, as the ``"int8"`` mode's do)."""
    from mimic_tpu_torch.models import generate as tg
    from mimic_tpu_torch.models.decoder import holds_handles
    from mimic_tpu_torch.models.lvlm import LVLMBatch, lvlm_forward

    B, T = batch.input_ids.shape
    new = forced.shape[1]
    dparams = params if decode_params is None else decode_params
    with torch.no_grad():
        last, cache, _ = tg._prefill(params, cfg, batch, T + new, shift, "unmasked", dtype,
                                     "flash", handles=holds_handles(dparams["lm"]["decoder"]))
        rows, n_real = [last.float()], batch.attention_mask.sum(-1)
        mask = torch.cat([batch.attention_mask, batch.attention_mask.new_zeros(B, new)], dim=-1)
        for i in range(new):
            mask[:, T + i] = 1
            out = lvlm_forward(dparams, cfg, LVLMBatch(input_ids=forced[:, i:i + 1],
                                                       attention_mask=mask),
                               position_ids=(n_real + i)[:, None], kv_cache=cache,
                               kv_total_len=T + new, shift=shift, logz2="unmasked")
            cache = out.decoder.kv_cache
            rows.append(out.logits[:, -1].float())
    return torch.stack(rows)


def headsplit_loss_grads(cfg, params, shift, batch, attn_impl="flash", **kw):
    """The MimIC step's loss and every shift leaf's gradient (compute_loss and
    its backward through the kernels: what make_train_step runs before the
    optimizer); ``kw`` goes to compute_loss (phase 19's ``ring_kwargs``)."""
    from mimic_tpu_torch.config import get_preset
    from mimic_tpu_torch.shift.params import multi_head, needs_attn_capture, needs_ffn_capture
    from mimic_tpu_torch.train import step as ts

    enc, peft = get_preset("mimic")
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in shift.items()}
    with torch.enable_grad():
        loss, _ = ts.compute_loss(
            {"shift": leaves}, params, batch, cfg=cfg, strategy=enc.strategy(),
            rec_attn=needs_attn_capture(enc), rec_ffn=needs_ffn_capture(enc),
            mh=multi_head(enc), ce_loss_weight=peft.ce_loss_weight,
            align_loss_weight=peft.align_loss_weight, logz2="unmasked", attn_impl=attn_impl,
            **kw)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), {k: g.float().cpu() for k, g in zip(leaves, grads)}


def headsplit_connector(c2, connector, feats):
    from mimic_tpu_torch.models.vision import perceiver_forward

    with torch.no_grad():
        return perceiver_forward(connector, c2.perceiver, feats, norm_eps=c2.text.norm_eps,
                                 context_mask=torch.ones(feats.shape[:2], dtype=torch.int32,
                                                         device=feats.device))


def headsplit_rank(rank, n, workdir):
    """One rank of phase 18: a ``gloo`` group of n processes on cuda:0, a (data
    1 x model n) mesh, the package's tensor parallelism on each frozen tree as
    ``shard_params`` cuts it.  Writes ``rank-{rank}.pt``."""
    import torch.distributed as dist

    from mimic_tpu_torch import parallel
    from mimic_tpu_torch.models import generate as tg
    from mimic_tpu_torch.models.decoder import ATTN_PATH_LOG, init_kv_cache

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store", rank=rank,
                            world_size=n)
    try:
        dev = torch.device("cuda")
        # gloo must take CUDA tensors in both collectives tensor parallelism calls
        x = torch.full((4,), rank + 1.0, dtype=torch.bfloat16, device=dev)
        dist.all_reduce(x)
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x)
        if not (x == n * (n + 1) // 2).all() or torch.cat(parts).unique().numel() != 1:
            raise AssertionError(f"rank {rank}: gloo's collectives on CUDA tensors are wrong")
        # a gloo mesh ("cpu" names its backend); its collectives take the CUDA tensors
        mesh = parallel.make_mesh(1, n, device_type="cpu")
        trees = None
        for turn in range(n):  # one whole tree on the card at a time
            if turn == rank:
                trees = headsplit_trees(dev, mesh)
                torch.cuda.empty_cache()
            dist.barrier()
        cfg, params, shift, c2, connector = trees
        prompt, train, feats = headsplit_batches(dev, cfg, c2)
        forced = torch.load(os.path.join(workdir, "forced.pt")).to(dev)
        out = {}
        with parallel.use_mesh(mesh):
            cache = init_kv_cache(cfg.text, HEADSPLIT_B, HEADSPLIT_T + HEADSPLIT_NEW, dev,
                                  torch.bfloat16)
            out["cache_bytes"] = cache["k"].nbytes + cache["v"].nbytes
            out["cache_heads"] = cache["k"].shape[3]
            del cache
            dist.barrier()
            _reset_counts()
            ATTN_PATH_LOG.clear()
            t = time.perf_counter()
            with torch.no_grad():
                out["greedy"] = tg.greedy_generate(
                    params, cfg, prompt, HEADSPLIT_NEW, cfg.eos_token_id, cfg.pad_token_id,
                    shift=shift, attn_impl="flash").tokens.cpu()
            out["greedy_s"] = _since(t)
            out["launches_a"], out["paths_a"] = _counts(), list(ATTN_PATH_LOG)
            dist.barrier()
            t = time.perf_counter()
            out["logits"] = forced_decode(params, cfg, prompt, forced, shift).cpu()
            out["forced_s"] = _since(t)
            dist.barrier()
            _reset_counts()
            t = time.perf_counter()
            out["loss"], out["grads"] = headsplit_loss_grads(cfg, params, shift, train)
            out["step_s"] = _since(t)
            out["launches_b"] = _counts()
            dist.barrier()
            torch.cuda.empty_cache()  # 8 processes share the card
            t = time.perf_counter()
            out["connector"] = headsplit_connector(c2, connector, feats).cpu()
            out["connector_s"] = _since(t)
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        torch.save(out, os.path.join(workdir, f"rank-{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _rel_rms(a, b):
    return ((a.float() - b.float()).pow(2).mean().sqrt() / b.float().pow(2).mean().sqrt()).item()


def headsplit_attention_ms():
    """The prefill's attention per rank and layer, by CUDA events in this
    process: all 28 heads (B4 H28/4 T=S=1024, the gathered region of model 8)
    against 7 (H7/1, a rank of model 4's whole-head split)."""
    from mimic_tpu_torch.ops.flash_attention import flash_attention

    out = {}
    km = torch.ones(HEADSPLIT_B, HEADSPLIT_T, dtype=torch.int32, device="cuda")
    for H, Hkv in ((28, 4), (7, 1)):
        g = torch.Generator(device="cuda").manual_seed(22)
        q, k, v = (torch.randn(HEADSPLIT_B, HEADSPLIT_T, h, 128, generator=g, device="cuda")
                   .to(torch.bfloat16) for h in (H, Hkv, Hkv))
        out[f"H{H}/{Hkv}"] = cuda_ms(lambda: flash_attention(q, k, v, km, causal=True), 20)
    return out


def phase_headsplit():
    """Phase 18: llava-interleave-7b's decoder (cut to 4 layers) and
    idefics2-8b-base's connector at full width on a (data 1 x model 8) mesh of
    8 processes sharing the card over ``gloo``, where the model axis cuts
    inside a head (q 3.5 heads a rank, k/v half a head; the connector's k/v
    half a head): (a) greedy decoding of B4 x T1024 with the MimIC shift, and
    the prefill and every decode step with one process's tokens, (b) the MimIC
    step's loss and gradients, (c) the connector on one row of phase 5's image
    features, each against one process on the card.  Returns the ranks'
    launches."""
    import multiprocessing as mp

    from mimic_tpu_torch.bridge import tree_map
    from mimic_tpu_torch.models import generate as tg

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    torch.cuda.empty_cache()  # 8 processes share the card
    n, L = HEADSPLIT_RANKS, HEADSPLIT_LAYERS
    cfg, params, shift, c2, connector = headsplit_trees(dev)
    prompt, train, feats = headsplit_batches(dev, cfg, c2)
    with torch.no_grad():
        ref_tokens = tg.greedy_generate(params, cfg, prompt, HEADSPLIT_NEW, cfg.eos_token_id,
                                        cfg.pad_token_id, shift=shift, attn_impl="flash").tokens
    ref_logits = forced_decode(params, cfg, prompt, ref_tokens, shift).cpu()
    ref_loss, ref_grads = headsplit_loss_grads(cfg, params, shift, train)
    ref_conn = headsplit_connector(c2, connector, feats).cpu()
    plain = forced_decode(params, cfg, prompt, ref_tokens, None).cpu()
    # the same functions in fp32 (the bf16 weights upcast), one tree at a time
    params = {k: v for k, v in params.items() if k == "lm"}  # no image reaches the tower
    params = tree_map(lambda x: x.float(), params)
    fp32_logits = forced_decode(params, cfg, prompt, ref_tokens, shift, torch.float32).cpu()
    del params
    connector = tree_map(lambda x: x.float(), connector)
    fp32_conn = headsplit_connector(c2, connector, feats.float()).cpu()
    del connector, feats, train, prompt
    torch.cuda.empty_cache()
    attn_ms = headsplit_attention_ms()
    log(f"[headsplit] one process: greedy tokens {ref_tokens.tolist()}, loss {ref_loss:.6g}; "
        f"{_since(t0):.1f} s")
    with tempfile.TemporaryDirectory(prefix="mimic_headsplit_") as workdir:
        torch.save(ref_tokens.cpu(), os.path.join(workdir, "forced.pt"))
        t = time.perf_counter()
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=headsplit_rank, args=(r, n, workdir)) for r in range(n)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(600)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise AssertionError(f"phase 18: rank exit codes {codes}")
        ranks = [torch.load(os.path.join(workdir, f"rank-{r}.pt"), weights_only=False)
                 for r in range(n)]
        ranks_s = time.perf_counter() - t
    log(f"[headsplit] {n} ranks (spawn, trees, (a)-(c)): {ranks_s:.1f} s; attention per rank and "
        f"layer (B4 T=S=1024 D128, CUDA events, one process): gathered H28/4 "
        f"{attn_ms['H28/4']:.4f} ms, model 4's whole-head split H7/1 {attn_ms['H7/1']:.4f} ms")
    shift_moves = _rel_rms(ref_logits, plain)
    one_logits, one_conn = _rel_rms(ref_logits, fp32_logits), _rel_rms(ref_conn, fp32_conn)
    t = cfg.text
    # every KV head on every rank: layers x rows x slots x heads x head size, k and v, bf16
    want_cache = (t.num_layers * HEADSPLIT_B * (HEADSPLIT_T + HEADSPLIT_NEW) * t.num_kv_heads
                  * t.head_size * 2 * 2)
    # (a) the prefill's onepass_fwd once a layer over all 28 heads, the decode
    # steps none; (b) the record and shift passes' once a layer each, the
    # backward pair for layers 1..L-1 (layer 0's attention inputs carry no gradient)
    want_a = {**dict.fromkeys(KERNEL_META, 0), "onepass_fwd": L}
    want_b = {**want_a, "onepass_fwd": 2 * L, "flash_bwd_dq": L - 1, "flash_bwd_dkv": L - 1}
    for r, out in enumerate(ranks):
        logit_cos = _row_cosine(out["logits"].flatten(0, 1), ref_logits.flatten(0, 1))
        logit_rms = _rel_rms(out["logits"], ref_logits)
        logit_fp32 = _rel_rms(out["logits"], fp32_logits)
        conn_cos = _row_cosine(out["connector"].flatten(0, 1), ref_conn.flatten(0, 1))
        conn_rms = _rel_rms(out["connector"], ref_conn)
        conn_fp32 = _rel_rms(out["connector"], fp32_conn)
        loss_rel = abs(out["loss"] - ref_loss) / abs(ref_loss)
        grad_cos = {k: torch.nn.functional.cosine_similarity(
            out["grads"][k].flatten(), g.flatten(), dim=0).item() for k, g in ref_grads.items()}
        same = int((out["greedy"] == ref_tokens.cpu()).sum())
        log(f"[headsplit] rank {r}: (a) KV cache {out['cache_bytes']} B ({out['cache_heads']} KV "
            f"heads); greedy {out['greedy_s']:.3f} s, {same} of {ref_tokens.numel()} tokens as "
            f"one process's; launches {({k: v for k, v in out['launches_a'].items() if v})}; "
            f"logits of the prefill and {HEADSPLIT_NEW} decode steps: min row cosine "
            f"{logit_cos:.6f}, rms difference {logit_rms:.3e} of one process's; from fp32 "
            f"{logit_fp32:.3e} (one process {one_logits:.3e}; the shift moves them by "
            f"{shift_moves:.3e}); "
            f"forced decode {out['forced_s']:.3f} s. (b) loss {out['loss']:.6g} (relative "
            f"{loss_rel:.3e}), gradient cosines {({k: round(c, 6) for k, c in grad_cos.items()})}, "
            f"{out['step_s']:.3f} s, launches {({k: v for k, v in out['launches_b'].items() if v})}. "
            f"(c) connector min row cosine {conn_cos:.6f}, rms difference {conn_rms:.3e}; from "
            f"fp32 {conn_fp32:.3e} (one process {one_conn:.3e}), "
            f"{out['connector_s']:.3f} s; peak {out['peak_gib']:.2f} GiB")
        got_a, got_b = ({k: d.get(k, 0) for k in KERNEL_META}
                        for d in (out["launches_a"], out["launches_b"]))
        if got_a != want_a or out["paths_a"] != ["flash"] + ["cached"] * HEADSPLIT_NEW:
            raise AssertionError(f"(a) rank {r}: launches {out['launches_a']}, paths "
                                 f"{out['paths_a']}; want {want_a}")
        if got_b != want_b:
            raise AssertionError(f"(b) rank {r}: launches {out['launches_b']}, want {want_b}")
        if out["cache_bytes"] != want_cache or out["cache_heads"] != t.num_kv_heads:
            raise AssertionError(f"(a) rank {r}: cache {out['cache_bytes']} B, want {want_cache}")
        if not (logit_cos >= MIN_LOGIT_COSINE
                and logit_fp32 <= HEADSPLIT_NOISE_RATIO * one_logits):
            raise AssertionError(f"(a) rank {r}: logits disagree with one process's")
        if not (loss_rel <= HEADSPLIT_LOSS_RTOL and min(grad_cos.values()) >= MIN_GRAD_COSINE):
            raise AssertionError(f"(b) rank {r}: the step disagrees with one process's")
        if not (conn_cos >= MIN_LOGIT_COSINE and conn_fp32 <= HEADSPLIT_NOISE_RATIO * one_conn):
            raise AssertionError(f"(c) rank {r}: the connector disagrees with one process's")
    if not shift_moves > 10 * one_logits:
        raise AssertionError(f"the shift moves the logits by {shift_moves:.3e} only")
    log(f"[time] phase 18 head split: {_since(t0):.1f} s")
    return {f"head split (a), {n} ranks": _sum_counts(*(o["launches_a"] for o in ranks)),
            f"head split (b), {n} ranks": _sum_counts(*(o["launches_b"] for o in ranks))}


# ---------------------------------------------------------------------------
# phase 19: the rest of the model axis
# ---------------------------------------------------------------------------

MODEL_AXIS_RANKS = 4
MODEL_AXIS_LAYERS = 4
# (a) the MimIC step at phase 5's sequence shape (B2, record T 2048, shift T
# 256, 64 gathered tokens); (b) the record pass at T 4096 (a ring of one rank:
# its block C 4096 > ONEPASS_MAX_S takes flash_fwd); (c) B4 x T1024 with a
# left-padded row, 8 new tokens, beam 3 (the prompt KV int8 in "int8")
STEP_B, STEP_T, STEP_T_SHIFT, STEP_M = 2, 2048, 256, 64
RECORD_T = 4096
QUANT_B, QUANT_T, QUANT_NEW, QUANT_PAD = 4, 1024, 8, 100
QUANT_MODES = ("int8", "int8-memory", "int8-w8a8")
MODEL_AXIS_LOSS_RTOL = 1e-3


def model_axis_cfg():
    """idefics2-8b-base at full width (D4096, H32/8, D128, F14336), the text
    tower cut to MODEL_AXIS_LAYERS layers, the vision tower and the connector
    to one (their weights are made, no image reaches them)."""
    import dataclasses

    from mimic_tpu_torch.models.config import get_model_config

    cfg = get_model_config("idefics2-8b-base")
    return cfg.replace(text=dataclasses.replace(cfg.text, num_layers=MODEL_AXIS_LAYERS),
                       vision=dataclasses.replace(cfg.vision, num_layers=1),
                       perceiver=dataclasses.replace(cfg.perceiver, num_layers=1))


def model_axis_inputs(dev, cfg):
    """From fixed seeds: the bf16 tree, the fp32 MimIC shift, (a)'s dual-pass
    batch, (b)'s record batch and (c)'s prompt batch."""
    from mimic_tpu_torch.config import get_preset
    from mimic_tpu_torch.models.lvlm import LVLMBatch, init_lvlm_params
    from mimic_tpu_torch.shift.params import init_shift_params

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    params = init_lvlm_params(cfg, gen(24), dev, torch.bfloat16)
    shift = init_shift_params(get_preset("mimic")[0], cfg.text, gen(25), dev)
    g = gen(26)
    hi = min(32000, cfg.text.vocab_size)

    def ids(B, T):
        return torch.randint(hi // 2, hi, (B, T), generator=g, device=dev)

    def ones(B, T, dtype=torch.int32):
        return torch.ones(B, T, dtype=dtype, device=dev)

    idx = torch.arange(STEP_M, device=dev)[None].expand(STEP_B, STEP_M)
    train = {"full_ids": ids(STEP_B, STEP_T), "full_mask": ones(STEP_B, STEP_T),
             "query_ids": ids(STEP_B, STEP_T_SHIFT), "query_mask": ones(STEP_B, STEP_T_SHIFT),
             "prefix_q_idx": idx + (STEP_T - STEP_M), "shift_q_idx": idx + (STEP_T_SHIFT - STEP_M),
             "q_valid": ones(STEP_B, STEP_M, torch.bool)}
    record = LVLMBatch(input_ids=ids(1, RECORD_T), attention_mask=ones(1, RECORD_T))
    mask = ones(QUANT_B, QUANT_T)
    mask[1, :QUANT_PAD] = 0
    prompt = LVLMBatch(input_ids=ids(QUANT_B, QUANT_T), attention_mask=mask)
    return params, shift, train, record, prompt


def model_axis_record(cfg, params, batch, **kw):
    """The record pass's attention and MLP block outputs at its last
    STEP_M positions, [2, L, 1, STEP_M, D] on the host."""
    from mimic_tpu_torch.models.lvlm import lvlm_forward

    idx = torch.arange(RECORD_T - STEP_M, RECORD_T, device=batch.input_ids.device)[None]
    with torch.no_grad():
        out = lvlm_forward(params, cfg, batch, capture_attn=True, capture_ffn=True,
                           capture_gather_idx=idx, **kw).decoder
    return torch.stack([out.attn_capture, out.ffn_capture]).cpu()


def quantized_handles(tree, path=""):
    """Every int8 handle of a tree, by key path."""
    from mimic_tpu_torch.ops.quant import is_quantized

    if is_quantized(tree):
        return {path: tree}
    if not isinstance(tree, dict):
        return {}
    return {p: h for k, v in tree.items() for p, h in quantized_handles(v, f"{path}/{k}").items()}


def model_axis_quant(cfg, params, prompt, mode, forced=None):
    """(c) in ``mode``: ``LVLMRunner(quant=mode)`` on ``params`` (the whole tree,
    or this rank's cut under the current mesh), its handles' fingerprint,
    the counted beam-3 run and the launches in it, then the logits of the
    prefill and each decode step fed ``forced`` (one process's tokens; the
    beam's best where None)."""
    from mimic_tpu_torch.models import generate as tg
    from mimic_tpu_torch.models.runner import LVLMRunner
    from mimic_tpu_torch.models.tokenizer import SimpleTokenizer

    out = {}
    t = time.perf_counter()
    runner = LVLMRunner(cfg, params, SimpleTokenizer(padding_side="left"), device="cuda",
                        quant=mode)
    out["set_quant_s"] = _since(t)
    base, dparams = runner.params, runner.decode_params
    out["handles"] = frozen_fingerprint(quantized_handles(base if dparams is None else dparams))
    _reset_counts()
    t = time.perf_counter()
    with torch.no_grad():
        beam = tg.beam_generate(base, cfg, prompt, QUANT_NEW, NUM_BEAMS, cfg.eos_token_id,
                                cfg.pad_token_id, decode_params=dparams, attn_impl="flash")
    out["beam_s"], out["launches"] = _since(t), _counts()
    out["beam"] = beam.tokens.cpu()
    forced = beam.tokens if forced is None else forced.to(beam.tokens.device)
    out["logits"] = forced_decode(base, cfg, prompt, forced, None, decode_params=dparams).cpu()
    return out


def model_axis_rank(rank, n, n_sp, workdir):
    """One rank of phase 19: a ``gloo`` group of n processes on cuda:0.  (a) on a
    ("data", "sp", "model") mesh of (1, n_sp, n / n_sp); (b) with
    ``ring_axis="model"`` on ``make_mesh(1, n)`` where the ring may cross
    processes (n_sp > 1), else on (a)'s mesh; (c) on ``make_mesh(1, n)``; each
    tree ``shard_params``' cut.  Writes ``rank-{rank}.pt``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from mimic_tpu_torch import parallel
    from mimic_tpu_torch.models.decoder import ATTN_PATH_LOG, init_kv_cache

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store", rank=rank,
                            world_size=n)
    try:
        dev = torch.device("cuda")
        cfg = model_axis_cfg()
        whole, shift, train, record, prompt = model_axis_inputs(dev, cfg)
        # gloo meshes ("cpu" names the backend); their collectives take the CUDA tensors
        mesh3 = init_device_mesh("cpu", (1, n_sp, n // n_sp),
                                 mesh_dim_names=("data", "sp", "model"))
        mesh = parallel.make_mesh(1, n, device_type="cpu")
        step_tree = parallel.shard_params(whole, mesh3)
        params = parallel.shard_params(whole, mesh)
        del whole
        torch.cuda.empty_cache()
        refs = torch.load(os.path.join(workdir, "forced.pt"))
        out = {}
        dist.barrier()
        _reset_counts()
        ATTN_PATH_LOG.clear()
        t = time.perf_counter()
        with parallel.use_mesh(mesh3):
            out["loss"], out["grads"] = headsplit_loss_grads(
                cfg, step_tree, shift, train, attn_impl="ring",
                ring_kwargs=dict(ring_mesh=mesh3, ring_axis="sp", ring_min_len=0))
        out["a_s"], out["launches_a"], out["paths_a"] = _since(t), _counts(), list(ATTN_PATH_LOG)
        ring_tree, ring_mesh, ring_axis = ((params, mesh, "model") if n_sp > 1
                                           else (step_tree, mesh3, "sp"))
        dist.barrier()
        _reset_counts()
        ATTN_PATH_LOG.clear()
        t = time.perf_counter()
        with parallel.use_mesh(ring_mesh):
            out["record"] = model_axis_record(cfg, ring_tree, record, attn_impl="ring",
                                              ring_mesh=ring_mesh, ring_axis=ring_axis)
        out["b_s"], out["launches_b"], out["paths_b"] = _since(t), _counts(), list(ATTN_PATH_LOG)
        del step_tree, ring_tree
        # the KV cache's bytes a token on this rank: its own KV heads, and every
        # one (what a call whose decode steps read int8 handles holds)
        with parallel.use_mesh(mesh):
            out["kv_token_bytes"] = {
                handles: sum(c.nbytes for c in init_kv_cache(
                    cfg.text, 1, 1, dev, torch.bfloat16, handles=handles).values()
                    if isinstance(c, torch.Tensor))
                for handles in (False, True)}
        out["c"] = {}
        for mode in QUANT_MODES:
            dist.barrier()
            torch.cuda.empty_cache()  # 4 processes share the card
            with parallel.use_mesh(mesh):
                out["c"][mode] = model_axis_quant(cfg, params, prompt, mode, refs[mode])
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        torch.save(out, os.path.join(workdir, f"rank-{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _p2p_probe_rank(rank, n, workdir):
    """One rank of the probe: the ring's own exchange (``_exchange``, gloo's
    ``batch_isend_irecv``) of a CUDA tensor to the next rank, in bf16 and fp32.
    Writes ``probe-{rank}.pt``: per dtype "ok", "wrong values" or the error
    (after an error the pair's connection is gone: no barrier follows)."""
    import torch.distributed as dist

    from mimic_tpu_torch.ops.ring_attention import _exchange, _wait

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/probe-store", rank=rank,
                            world_size=n)
    try:
        result = {}
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.full((1 << 20,), rank + 1.0, dtype=dtype, device="cuda")
            try:
                recv, reqs = _exchange([x], (rank + 1) % n, (rank - 1) % n, None)
                _wait(reqs)
                torch.cuda.synchronize()
                want = (rank - 1) % n + 1.0
                result[str(dtype)] = "ok" if bool((recv[0] == want).all()) else "wrong values"
            except RuntimeError as e:
                result[str(dtype)] = f"refused: {str(e).splitlines()[0][:200]}"
        torch.save(result, os.path.join(workdir, f"probe-{rank}.pt"))
    finally:
        dist.destroy_process_group()


def start_p2p_probe(workdir, n: int = 2):
    """Start the probe of gloo's point-to-point ops on CUDA tensors: n
    processes on cuda:0 (``finish_p2p_probe`` reads them)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_p2p_probe_rank, args=(r, n, workdir)) for r in range(n)]
    for p in procs:
        p.start()
    return procs, workdir


def finish_p2p_probe(procs, workdir) -> bool:
    """Whether every rank of the probe received what its peer sent.  A rank
    that gloo refuses aborts inside gloo, and its peer may wait on it: one
    deadline for all."""
    deadline = time.perf_counter() + 60
    for p in procs:
        p.join(max(0.0, deadline - time.perf_counter()))
    ranks = []
    for r, p in enumerate(procs):
        if p.is_alive():
            p.kill()
            p.join()
            ranks.append("hung, killed")
        elif p.exitcode:
            ranks.append(f"exit code {p.exitcode}")
        else:
            ranks.append(torch.load(os.path.join(workdir, f"probe-{r}.pt")))
    ok = all(isinstance(r, dict) and set(r.values()) == {"ok"} for r in ranks)
    log(f"[model axis] probe: gloo's batch_isend_irecv (the ring's exchange) of CUDA bf16 and "
        f"fp32 tensors between {len(procs)} processes on one card: "
        f"{'takes them' if ok else 'refuses them'} ({ranks})")
    return ok


def phase_model_axis():
    """Phase 19: the rest of the model axis, as MODEL_AXIS_RANKS processes
    sharing the card over ``gloo``, idefics2-8b-base cut to 4 layers (bf16).
    First the probe of gloo's point-to-point ops on CUDA tensors, the ring's
    exchange: where it takes them (a) runs a ring of 2 under model 2 and (b)
    the ring over ``model`` itself, every head gathered; else both run a ring
    of one rank under model 4, and a ring across processes is held on the CPU
    only.  (a) The MimIC step (``compute_loss`` and its backward) on the ring
    at ``ring_min_len`` 0; (b) the record pass at T 4096; (c) the runner in the three int8 modes under ``make_mesh(1,
    4)``: its handles, a beam-3 run with the int8 prompt KV in ``"int8"``,
    and the logits of the prefill and each decode step; each against one
    process on the card.  Returns the ranks' launches."""
    import multiprocessing as mp

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    n, L = MODEL_AXIS_RANKS, MODEL_AXIS_LAYERS
    with tempfile.TemporaryDirectory(prefix="mimic_model_axis_") as workdir:
        probe = start_p2p_probe(workdir)
        cfg = model_axis_cfg()
        params, shift, train, record, prompt = model_axis_inputs(dev, cfg)
        ref_loss, ref_grads = headsplit_loss_grads(cfg, params, shift, train, attn_impl="flash")
        ref_record = model_axis_record(cfg, params, record, attn_impl="flash")
        ref_c = {mode: model_axis_quant(cfg, params, prompt, mode) for mode in QUANT_MODES}
        del params, shift, train, record, prompt
        torch.cuda.empty_cache()
        torch.save({mode: r["beam"] for mode, r in ref_c.items()},
                   os.path.join(workdir, "forced.pt"))
        one_s = _since(t0)
        n_sp = 2 if finish_p2p_probe(*probe) else 1
        t = time.perf_counter()
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=model_axis_rank, args=(r, n, n_sp, workdir))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.perf_counter() + 600
        for p in procs:
            p.join(max(0.0, deadline - time.perf_counter()))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise AssertionError(f"phase 19: rank exit codes {codes}")
        ranks = [torch.load(os.path.join(workdir, f"rank-{r}.pt"), weights_only=False)
                 for r in range(n)]
        ranks_s = time.perf_counter() - t
    log(f"[model axis] one process (a)-(c) {one_s:.1f} s; {n} ranks (spawn, trees, (a)-(c)) "
        f"{ranks_s:.1f} s; (a) on a (data 1, sp {n_sp}, model {n // n_sp}) mesh, (b) "
        + (f"ring_axis 'model' on (data 1, model {n})" if n_sp > 1 else "on (a)'s mesh"))
    steps = QUANT_NEW - 1
    zero = dict.fromkeys(KERNEL_META, 0)
    want_a = {**zero, "onepass_fwd": 2 * L * n_sp ** 2, "flash_bwd_dq": (L - 1) * n_sp ** 2,
              "flash_bwd_dkv": (L - 1) * n_sp ** 2}
    # a ring of n over model: n² blocks of C T/n a layer; a ring of one: one
    # block of C 4096, flash_fwd's
    want_b = ({**zero, "onepass_fwd": L * n ** 2} if n_sp > 1 else {**zero, "flash_fwd": L})
    # the prefill's attention once a layer; each decode step q/k/v and o a layer
    # and the lm head (2-D), the MLP a layer; "int8": the prompt attention a
    # layer; "int8-memory" / "int8-w8a8": the prefill's lm head (M 4); W8A8: the
    # prefill's four products a layer, each with its row quantization
    want_c = {mode: {**zero, "onepass_fwd": L, "int8_matmul": steps * (2 * L + 1),
                     "fused_mlp_int8": steps * L} for mode in QUANT_MODES}
    want_c["int8"]["prompt_attn_int8"] = steps * L
    for mode in ("int8-memory", "int8-w8a8"):
        want_c[mode]["int8_matmul"] += 1
    want_c["int8-w8a8"].update(w8a8_matmul=4 * L, quantize_rows=4 * L)

    def counted(d):
        return {k: d.get(k, 0) for k in KERNEL_META}

    for mode, r in ref_c.items():
        log(f"[model axis] one process (c) {mode}: set_quant {r['set_quant_s']:.3f} s, beam "
            f"{r['beam_s']:.3f} s, tokens {r['beam'].tolist()}")
        if counted(r["launches"]) != want_c[mode]:
            raise AssertionError(f"(c) {mode}, one process: launches {r['launches']}, want "
                                 f"{want_c[mode]}")
    for r, out in enumerate(ranks):
        loss_rel = abs(out["loss"] - ref_loss) / abs(ref_loss)
        grad_cos = _grad_cosines(out["grads"], ref_grads)
        rec_cos = _row_cosine(out["record"].flatten(0, -2), ref_record.flatten(0, -2))
        rec_rms = _rel_rms(out["record"], ref_record)
        log(f"[model axis] rank {r}: (a) loss {out['loss']:.6g} (relative {loss_rel:.3e}), "
            f"gradient cosines {({k: round(c, 6) for k, c in grad_cos.items()})}, "
            f"{out['a_s']:.3f} s, paths {out['paths_a']}, launches "
            f"{({k: v for k, v in out['launches_a'].items() if v})}. (b) record pass captures: "
            f"min row cosine {rec_cos:.6f}, rms difference {rec_rms:.3e} of one process's, "
            f"{out['b_s']:.3f} s, paths {out['paths_b']}, launches "
            f"{({k: v for k, v in out['launches_b'].items() if v})}. (c) KV cache "
            f"{out['kv_token_bytes'][True]} B a token (every KV head; "
            f"{out['kv_token_bytes'][False]} B with its own); peak {out['peak_gib']:.2f} GiB")
        if counted(out["launches_a"]) != want_a or out["paths_a"] != ["ring", "ring"]:
            raise AssertionError(f"(a) rank {r}: launches {out['launches_a']}, paths "
                                 f"{out['paths_a']}; want {want_a}")
        if counted(out["launches_b"]) != want_b or out["paths_b"] != ["ring"]:
            raise AssertionError(f"(b) rank {r}: launches {out['launches_b']}, paths "
                                 f"{out['paths_b']}; want {want_b}")
        if not (loss_rel <= MODEL_AXIS_LOSS_RTOL and min(grad_cos.values()) >= MIN_GRAD_COSINE):
            raise AssertionError(f"(a) rank {r}: the step disagrees with one process's")
        if not rec_cos >= MIN_LOGIT_COSINE:
            raise AssertionError(f"(b) rank {r}: the record pass disagrees with one process's")
        for mode in QUANT_MODES:
            got, ref = out["c"][mode], ref_c[mode]
            cos = _row_cosine(got["logits"].flatten(0, 1), ref["logits"].flatten(0, 1))
            diff = (got["logits"] - ref["logits"]).abs().max().item()
            same = int((got["beam"] == ref["beam"]).sum())
            log(f"[model axis] rank {r}: (c) {mode}: handles {len(got['handles'])} parts, "
                f"{'equal' if got['handles'] == ref['handles'] else 'NOT equal'} to one "
                f"process's; set_quant {got['set_quant_s']:.3f} s, beam {got['beam_s']:.3f} s, "
                f"{same} of {ref['beam'].numel()} tokens as one process's; logits of the prefill "
                f"and {QUANT_NEW} decode steps: min row cosine {cos:.6f}, max difference "
                f"{diff:.3e}; launches {({k: v for k, v in got['launches'].items() if v})}")
            if got["handles"] != ref["handles"] or not ref["handles"]:
                raise AssertionError(f"(c) {mode} rank {r}: handles differ from one process's")
            if counted(got["launches"]) != want_c[mode]:
                raise AssertionError(f"(c) {mode} rank {r}: launches {got['launches']}, want "
                                     f"{want_c[mode]}")
            if not cos >= MIN_LOGIT_COSINE:
                raise AssertionError(f"(c) {mode} rank {r}: logits disagree with one process's")
    log(f"[time] phase 19 model axis: {_since(t0):.1f} s")
    out = {f"model axis (a), {n} ranks": _sum_counts(*(o["launches_a"] for o in ranks)),
           f"model axis (b), {n} ranks": _sum_counts(*(o["launches_b"] for o in ranks))}
    for mode in QUANT_MODES:
        out[f"model axis (c) {mode}, {n} ranks"] = _sum_counts(
            *(o["c"][mode]["launches"] for o in ranks))
    return out


# ---------------------------------------------------------------------------
# phase 20: Kimi-VL-A3B: latent attention's kernels and its MimIC train step
# ---------------------------------------------------------------------------

# the passes of the kimi-vl-a3b.mimic-train-8shot cell: B2, record pass 5376
# tokens (8 demo images and the query image), shift pass 768 (the query image)
KIMI_RECORD_LEN, KIMI_SHIFT_LEN = 5376, 768
# Kimi-VL's chat format around each demo and the query (an <image> becomes one
# token a 2 x 2 patch merge of that image)
KIMI_DEMO = ("<|im_user|>user<|im_middle|><|media_start|>image<|media_content|><image>"
             "<|media_end|>{q}<|im_end|><|im_assistant|>assistant<|im_middle|>{a}<|im_end|>")
KIMI_QUERY = ("<|im_user|>user<|im_middle|><|media_start|>image<|media_content|><image>"
              "<|media_end|>{q}<|im_end|><|im_assistant|>assistant<|im_middle|>")
# COCO's sizes (h, w), as the cell draws them
KIMI_IMAGE_SIZES = ((480, 640), (640, 480), (427, 640), (480, 640), (640, 427), (480, 640),
                    (512, 640), (480, 640), (640, 480))
# routed experts' grouped products: rows a pass, experts a row, experts, D, F
KIMI_MOE = dict(k=6, E=64, D=2048, F=1408)


def right_padded_mask(B, S, pads):
    km = np.ones((B, S), np.int32)
    for b, p in enumerate(pads):
        km[b, S - p:] = 0
    return km


def phase_mla_kernels():
    """Latent attention's instantiations (q / k heads 192 wide, v heads 128,
    bf16) through their wrappers at the Kimi-VL cell's shapes, against the
    plain versions by phase 2's tolerances: flash_fwd at the record pass (B2
    H16 T=S=5376, causal, right-padded keys, no lse_u; beside it
    scaled_dot_product_attention on the same q, k, v and mask, which returns out
    without lse), onepass_fwd at the shift pass (B2 T=S=768, causal, lse_u),
    and the backward pair there (lse_u carries gradient).  Then the routed
    experts' grouped products (torch._grouped_mm) at both passes' rows, timed
    beside their bound.  Returns the kernels line's entries, by MLA_RESULT name."""
    from mimic_tpu_torch.ops import flash_attention as tfa

    if (192, 128) not in tfa.KERNEL_HEAD_DIMS:
        raise AssertionError(f"the kernels take no (192, 128): {tfa.KERNEL_HEAD_DIMS}")
    R, Q = KIMI_RECORD_LEN, KIMI_SHIFT_LEN
    summary = {}
    for r in (
        check_kernel("mla-record", "flash_fwd", 40, 2, R, R, 16, 16, 192,
                     right_padded_mask(2, R, [37, 290]), True, False, 10, 1, Dv=128),
        check_kernel("mla-shift", "onepass_fwd", 41, 2, Q, Q, 16, 16, 192,
                     right_padded_mask(2, Q, [0, 141]), True, True, 20, 5, Dv=128),
        *check_backward("mla-bwd-shift", 42, 2, Q, Q, 16, 16, right_padded_mask(2, Q, [0, 141]),
                        True, True, 20, D=192, Dv=128),
    ):
        summary[f"{r['name']}_192_128"] = {"max_abs_err": r["max_abs_err"],
                                          **{k: r[k] for k in TIMING_KEYS}}
    m = KIMI_MOE
    offs_of = {}
    for rows in (2 * Q, 2 * R):
        n = rows * m["k"]
        gen = torch.Generator(device="cuda").manual_seed(rows)
        # every expert gets rows, unevenly, as a router would send them
        cuts = torch.rand(m["E"], generator=gen, device="cuda") + 0.5
        offs_of[rows] = (cuts.cumsum(0) / cuts.sum() * n).round().to(torch.int32)
        offs_of[rows][-1] = n
        for what, K, N in (("gate / up", m["D"], m["F"]), ("down", m["F"], m["D"])):
            x = torch.randn(n, K, generator=gen, device="cuda").to(torch.bfloat16)
            w = torch.randn(m["E"], K, N, generator=gen, device="cuda").to(torch.bfloat16)
            offs = offs_of[rows]
            ms = cuda_ms(lambda: torch._grouped_mm(x, w, offs=offs), 20)
            b = bound(nbytes(x, w) + n * N * 2, 2 * n * K * N, "bf16")
            log(f"[kernels] grouped product {what}: {rows} rows x {m['k']} experts over "
                f"{m['E']}, [{n}, {K}] x [{m['E']}, {K}, {N}]: torch._grouped_mm {ms:.4f} ms "
                f"({b['bound_ms'] / ms:.1%} of its bound), {bound_text(b)}")
            del x, w
    torch.cuda.empty_cache()
    return summary


def kimi_train_batch(runner, enc, seed=5):
    """One B2 MimIC batch for Kimi-VL through the port's own collator: per row
    an instruction, 8 demos and the query in Kimi's chat format, nine images at
    COCO's sizes at native resolution."""
    from mimic_tpu_torch.train.collate import TrainCollator

    rng = np.random.default_rng(seed)
    rows = {"prefix_texts": [], "query_texts": [], "answers": [], "images": []}
    for r in range(2):
        demos = "".join(KIMI_DEMO.format(q=synthetic_text(seed + 10 * r + i, 32 + 6 * i),
                                         a=synthetic_text(seed + 10 * r + i + 5, 3))
                        for i in range(8))
        rows["prefix_texts"].append("<|im_system|>system<|im_middle|>Provide an answer to the "
                                    "question. Use the image to answer.<|im_end|>" + demos)
        rows["query_texts"].append(KIMI_QUERY.format(q=synthetic_text(seed + 100 + r, 44 + 16 * r)))
        rows["answers"].append(synthetic_text(seed + 200 + r, 3 - r))
        sizes = KIMI_IMAGE_SIZES[r:] + KIMI_IMAGE_SIZES[:r]
        rows["images"].append([rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
                               for h, w in sizes])
    return TrainCollator(runner.processor, enc.strategy(), pad_multiple=256)(rows)


def phase_kimi_step():
    """build_model("kimi-vl-a3b-instruct") whole and at its published widths,
    random bf16 weights made on the card, the mimic preset's shift, and the
    MimIC train step (make_train_step, attn_impl="flash") on kimi_train_batch.
    One warm-up step, then 3 counted steps in which every attention launch is
    counted by its head widths, and every MoE block runs under
    torch.cuda.set_sync_debug_mode("error"), so that a host sync inside one
    raises.  The decoder's 27 layers take the (192, 128) kernels in both passes
    and the backward pair in layers 1-26 (layer 0's q, k and v carry no
    gradient); no decoder call leaves "flash"; loss and gradient norm finite.
    Returns the counts of the kernels line's MLA entries."""
    import collections

    from mimic_tpu_torch.config import get_preset
    from mimic_tpu_torch.models import decoder as tdec
    from mimic_tpu_torch.models.factory import build_model
    from mimic_tpu_torch.ops import flash_attention as tfa
    from mimic_tpu_torch.ops import flash_backward as tfb
    from mimic_tpu_torch.shift.params import init_shift_params
    from mimic_tpu_torch.train import step as ts
    from mimic_tpu_torch.train.optim import build_optimizer
    from mimic_tpu_torch.bridge import tree_leaves

    t = time.perf_counter()
    runner = build_model("kimi-vl-a3b-instruct", dtype=torch.bfloat16)
    cfg, frozen = runner.cfg, runner.params
    torch.cuda.synchronize()
    L = cfg.text.num_layers
    n_frozen = sum(x.numel() for x in tree_leaves(frozen))
    log(f"[kimi] kimi-vl-a3b-instruct: {n_frozen / 1e9:.3f} B bf16 parameters made on the card "
        f"in {time.perf_counter() - t:.1f} s; {L} text layers, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    enc, peft = get_preset("mimic")
    shift = init_shift_params(enc, cfg.text, torch.Generator(device="cuda").manual_seed(2),
                              torch.device("cuda"))
    trainable = {"shift": shift}
    tx = build_optimizer(trainable, lr=peft.lr, weight_decay=1e-3, warmup_steps=10,
                         total_steps=1000, grad_clip=1.0)
    step = ts.make_train_step(cfg, enc, tx, ce_loss_weight=peft.ce_loss_weight,
                              align_loss_weight=peft.align_loss_weight, attn_impl="flash",
                              logz2="unmasked")
    state = ts.TrainState(trainable, tx.init(trainable), 0)
    hb = kimi_train_batch(runner, enc)
    batch = ts.to_device_batch(hb, torch.device("cuda"))
    T_rec, T_shift = batch["full_ids"].shape[1], batch["query_ids"].shape[1]
    log(f"[kimi] shift {', '.join(f'{k} {tuple(v.shape)}' for k, v in shift.items())}; batch B2, "
        f"record pass {T_rec} tokens ({int(batch['full_mask'].sum())} real) with "
        f"{batch['full_pixels'].shape[1]} images of up to {batch['full_pixels'].shape[2]} patches, "
        f"shift pass {T_shift} tokens (the cell: {KIMI_RECORD_LEN} and {KIMI_SHIFT_LEN})")

    seen = collections.Counter()
    launch_fwd, launch_bwd, block = tfa._launch, tfb._launch_backward, tdec.moe_block

    def by_widths(module, fn):
        def counted(*args, **kw):
            q, k, v = (args[1:4] if module is tfa else args[:3])
            before = dict(module.LAUNCHES)
            out = fn(*args, **kw)
            for name, n in module.LAUNCHES.items():
                if n > before[name]:
                    seen[(name, q.shape[-1], v.shape[-1])] += n - before[name]
            return out
        return counted

    def no_sync_block(*args, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return block(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    def run_step():
        nonlocal state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, frozen, batch)
        m = {k: float(v) for k, v in m.items()}
        return m, time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    m, secs = run_step()
    log(f"[kimi] warm-up step: {secs:.3f} s, loss {m['loss']:.6f}")
    tfa._launch, tfb._launch_backward = by_widths(tfa, launch_fwd), by_widths(tfb, launch_bwd)
    tdec.moe_block = no_sync_block
    tdec.ATTN_PATH_LOG.clear()
    try:
        times = []
        for i in range(TRAIN_STEPS):
            m, secs = run_step()
            times.append(secs)
            log(f"[kimi] step {i + 1}: {secs:.3f} s; " + ", ".join(f"{k} {v:.6g}" for k, v in m.items()))
            if not all(np.isfinite(v) for v in m.values()) or not m["grad_norm"] > 0:
                raise AssertionError(f"Kimi-VL train metrics not finite or zero gradient: {m}")
    finally:
        tfa._launch, tfb._launch_backward, tdec.moe_block = launch_fwd, launch_bwd, block
    paths = list(tdec.ATTN_PATH_LOG)
    counts = {f"{name}@{d}/{dv}": n for (name, d, dv), n in sorted(seen.items())}
    log(f"[kimi] {TRAIN_STEPS} counted steps: {', '.join(f'{x:.3f}' for x in times)} s; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; attention launches by head "
        f"widths {counts}; decoder attention paths {paths}; every MoE block ran without a host "
        f"sync (set_sync_debug_mode error)")
    if paths != ["flash"] * (2 * TRAIN_STEPS):
        raise AssertionError(f"a decoder call of the Kimi-VL step left the flash path: {paths}")
    mla = {f"{name}_192_128": seen[(name, 192, 128)] // TRAIN_STEPS
           for name in (*tfa.LAUNCHES, *tfb.LAUNCHES)}
    want = {"forward": 2 * L, "flash_bwd_dq_192_128": L - 1, "flash_bwd_dkv_192_128": L - 1}
    got = {"forward": mla["flash_fwd_192_128"] + mla["onepass_fwd_192_128"],
           "flash_bwd_dq_192_128": mla["flash_bwd_dq_192_128"],
           "flash_bwd_dkv_192_128": mla["flash_bwd_dkv_192_128"]}
    other = {key: n for key, n in counts.items() if not key.endswith(("@192/128", "@72/72"))}
    if got != want or other:
        raise AssertionError(f"Kimi-VL step: (192, 128) launches a step {got}, want {want}; "
                             f"at other widths {other}")
    del runner, frozen, state, batch
    torch.cuda.empty_cache()
    return {"Kimi-VL step": {name: n * TRAIN_STEPS for name, n in mla.items()}}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    other = None
    if sys.argv[1:2] in (["--int8-only"], ["--backward-only"], ["--w8a8-only"]) and len(sys.argv) == 3:
        # phase 6 or phase 2's backward cases on another checkout's kernels (e.g.
        # the parent commit's, unpacked with git archive), measured as this script measures
        other = os.path.abspath(sys.argv[2])
        sys.path.insert(0, other)
    from mimic_tpu_torch.ops import _build

    if other is not None and not _build.__file__.startswith(other):
        raise AssertionError(f"{_build.__file__} is not under {other}")

    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} card(s)")
    card = card_line()
    log(card)
    t0 = time.perf_counter()
    info = _build.build()
    log(f"[build] {info['command'] or 'cached: ' + info['path']}")
    log(f"[build] nvcc for sm_90a: {info['seconds']:.1f} s compiling, "
        f"{time.perf_counter() - t0:.1f} s in all; library {os.path.relpath(info['path'], ROOT)}")
    # registers, spills and shared memory of the tensor-core kernels; a serialized
    # wgmma (or mma) in the kernels redesigned last fails the run
    ptxas_lines(info, ("attn_fwd_mma", "bwd_dq_mma", "bwd_dkv_mma", "int8_matmul", "fused_mlp",
                       "w8a8", "prompt_attn_mma", "quantize_rows", "row_norm"),
                ("w8a8_matmul.cu", "prompt_attn_int8.cu", "quantize_rows.cu"),
                # the bf16 forward's head-dim-64, -72 and -80 instantiations (the towers)
                ("attn_fwd_mma_kernelILi64", "attn_fwd_mma_kernelILi72",
                 "attn_fwd_mma_kernelILi80"))
    _build.load_library()

    if sys.argv[1:] == ["--attention-only"]:
        phase_kernels()
        # head dims 64, 72, 80, 128 and latent attention's 192 / 128, each with and
        # without lse_u
        sass_counts(info["path"], ("attn_fwd_mma_kernel",), ("HGMMA", "UTMALDG"), 10)
        log("[card] partial run (--attention-only): phase 2's forward kernels passed; "
            "no result line")
        return 3

    if sys.argv[1:2] == ["--int8-only"]:
        phase_int8_kernels(split_sweep=other is None)
        int8_crossover()
        if other is None:
            int8_split_sweep()
            # int8_matmul and the MLP's two products, for one and two n8 operands
            sass_counts(info["path"], INT8_MMA_KERNELS, ("HMMA",), 6)
        log(f"[card] partial run (--int8-only{'' if other is None else ' ' + other}): phase 6's "
            "int8 kernels passed; no result line")
        return 3

    if sys.argv[1:2] == ["--w8a8-only"]:
        phase_w8a8_kernels()
        w8a8_crossover()
        if other is None:
            # the integer wgmma of both output types
            sass_counts(info["path"], ("w8a8_wgmma_kernel",), ("IGMMA",), 2)
        log(f"[card] partial run (--w8a8-only{'' if other is None else ' ' + other}): phase 9's "
            "W8A8 kernels passed; no result line")
        return 3

    if sys.argv[1:2] == ["--backward-only"]:
        phase_backward_kernels()
        if other is None:
            backward_split_sweep()
            sass_counts(info["path"], BWD_MMA_KERNELS, ("HGMMA",), 4)
        log(f"[card] partial run (--backward-only{'' if other is None else ' ' + other}): "
            "phase 2's backward kernels passed; no result line")
        return 3

    if sys.argv[1:] == ["--mla-only"]:
        phase_mla_kernels()
        # the latent-attention instantiations: the forward with and without lse_u, the
        # backward pair
        sass_counts(info["path"], ("mla_attn_fwd_mma_kernel", "mla_bwd_dq_mma_kernel",
                                   "mla_bwd_dkv_mma_kernel"), ("HGMMA",), 4)
        phase_kimi_step()
        log("[card] partial run (--mla-only): phase 20 passed; no result line")
        return 3

    if sys.argv[1:] == ["--norms-only"]:
        phase_norm_kernels()
        log("[card] partial run (--norms-only): phase 2's row-norm kernel passed; no result line")
        return 3

    if sys.argv[1:] == ["--cache-only"]:
        runner, _ = phase_main()
        phase_caches_8b(runner)
        log("[card] partial run (--cache-only): phase 12 passed; no result line")
        return 3

    if sys.argv[1:] == ["--peft-only"]:
        runner, _ = phase_main()
        phase_peft_8b(runner)
        log("[card] partial run (--peft-only): phase 13 passed; no result line")
        return 3

    if sys.argv[1:] == ["--serve-only"]:
        runner, _ = phase_main()
        t = time.perf_counter()
        phase_serve_8b(runner)
        log(f"[time] phase 16 serve engine and tracing: {time.perf_counter() - t:.1f} s")
        log("[card] partial run (--serve-only): phase 16 passed; no result line")
        return 3

    if sys.argv[1:] == ["--parallel-only"]:
        t = time.perf_counter()
        phase_parallel(main_runner())
        log(f"[time] phase 17 parallel: {time.perf_counter() - t:.1f} s")
        log("[card] partial run (--parallel-only): phase 17 passed; no result line")
        return 3

    if sys.argv[1:] == ["--headsplit-only"]:
        phase_headsplit()
        log("[card] partial run (--headsplit-only): phase 18 passed; no result line")
        return 3

    if sys.argv[1:] == ["--model-axis-only"]:
        phase_model_axis()
        log("[card] partial run (--model-axis-only): phase 19 passed; no result line")
        return 3

    if sys.argv[1:] == ["--idefics1-only"]:
        check_kernel(*CLIP_VIT_CASE[:-1])
        for case in CLIP_FP32_CASES:
            check_kernel_fp32(*case)
        clip_device_times()
        t = time.perf_counter()
        phase_idefics_9b()
        log(f"[time] phase 14 idefics-9b: {time.perf_counter() - t:.1f} s")
        log("[card] partial run (--idefics1-only): phase 2's head-dim-80 cases and phase 14 "
            "passed; no result line")
        return 3

    if sys.argv[1:] == ["--llava-only"]:
        for case in D64_CASES:
            check_kernel(*case[:-1])
        for case in D64_FP32_CASES:
            check_kernel_fp32(*case)
        clip_device_times()
        check_llava_prompt_attn()
        t = time.perf_counter()
        phase_llava()
        log(f"[time] phase 15 llava: {time.perf_counter() - t:.1f} s")
        log("[card] partial run (--llava-only): phase 2's head-dim-64 cases, phase 6's G 7 case "
            "and phase 15 passed; no result line")
        return 3

    if sys.argv[1:] == ["--eval-only"]:
        from mimic_tpu_torch.models.factory import build_model

        runner = build_model("idefics2-8b-base", dtype=torch.bfloat16)
        with tempfile.TemporaryDirectory(prefix="mimic_smoke_") as result_dir:
            ckpt, trained_shift = phase_train_for_eval(runner, result_dir)
            del runner
            phase_eval_w8a8(ckpt, trained_shift, result_dir)
        log("[card] partial run (--eval-only): phase 11 passed; no result line")
        return 3

    def timed(label, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        log(f"[time] {label}: {time.perf_counter() - t:.1f} s")
        return out

    summary = timed("phase 2 kernels", phase_kernels)
    summary.update(timed("phase 2 backward kernels", phase_backward_kernels))
    summary.update(timed("phase 2 row-norm kernel", phase_norm_kernels))
    summary.update(timed("phase 20 latent-attention kernels", phase_mla_kernels))
    summary.update(timed("phase 6 int8 kernels", phase_int8_kernels))
    timed("phase 6 qdot cut-off", int8_crossover)
    summary.update(timed("phase 9 W8A8 kernels", phase_w8a8_kernels))
    timed("phase 9 W8A8_MIN_M cut-off", w8a8_crossover)
    timed("phase 3 tiny serving", phase_tiny_reference)
    timed("phase 3 tiny training", phase_tiny_train)
    timed("phase 7 tiny int8", phase_tiny_int8)
    timed("phase 10 tiny W8A8", phase_tiny_w8a8)
    runner, serve_launches = timed("phase 4 8B serving", phase_main)
    train_launches = timed("phase 5 8B train step", phase_train_8b, runner)
    cache_launches = timed("phase 12 caches, sampling, converter", phase_caches_8b, runner)
    peft_launches = timed("phase 13 LoRA and prefix", phase_peft_8b, runner)
    serve_engine_launches = timed("phase 16 serve engine and tracing", phase_serve_8b, runner)
    parallel_launches = timed("phase 17 parallel", phase_parallel, runner)
    with tempfile.TemporaryDirectory(prefix="mimic_smoke_") as result_dir:
        ckpt, trained_shift = timed("phase 11 run_train", phase_train_for_eval, runner,
                                    result_dir)
        int8_launches = timed("phase 8 8B int8", phase_int8_8b, runner)
        del runner  # the eval entry builds its own model
        eval_launches = timed("phase 11 eval", phase_eval_w8a8, ckpt, trained_shift, result_dir)
    torch.cuda.empty_cache()
    idefics_launches, idefics_kernels = timed("phase 14 idefics-9b", phase_idefics_9b)
    llava_launches, llava_kernels = timed("phase 15 llava", phase_llava)
    headsplit_launches = phase_headsplit()
    model_axis_launches = phase_model_axis()
    kimi_launches = timed("phase 20 Kimi-VL step", phase_kimi_step)
    # the kernels at idefics-9b's and llava's shapes: their errors count, the times
    # stay those of the main-path shapes above
    for r in idefics_kernels + llava_kernels:
        summary[r["name"]]["max_abs_err"] = max(summary[r["name"]]["max_abs_err"],
                                                r["max_abs_err"])

    # launches: each path's counted run (serving, training, the cached train
    # steps, the warm cached call A, the sampled calls, the LoRA steps, the
    # prefix steps and calls, the LoRA eval, the serve engine's runs and the
    # tracing utilities, int8 serving, the W8A8 eval, the idefics-9b ICL calls
    # and train steps, the llava calls, step and eval, the head split's ranks,
    # the model axis's ranks, the Kimi-VL step),
    # each driven with the counts at 0 and read just after, summed
    paths = {"serving": serve_launches, "training": train_launches, **cache_launches,
             **peft_launches, **serve_engine_launches, **parallel_launches,
             "int8 serving": int8_launches,
             "W8A8 eval": eval_launches, **idefics_launches, **llava_launches,
             **headsplit_launches, **model_axis_launches, **kimi_launches}
    launches = {name: sum(d.get(name, 0) for d in paths.values()) for name in RESULT_META}
    log("[card] kernel launches: " + ", ".join(f"{k} {v}" for k, v in paths.items()))
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel never launched on its main path: {launches}")
    kernels = [
        {"name": name, **RESULT_META[name], "launches": launches[name], **summary[name]}
        for name in ("onepass_fwd", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                     "int8_matmul", "fused_mlp_int8", "prompt_attn_int8", "w8a8_matmul",
                     "quantize_rows", "row_norm", *MLA_RESULT)
    ]
    for k in kernels:
        missing = [key for key in ("max_abs_err", *TIMING_KEYS) if key not in k]
        if missing:
            raise AssertionError(f"kernel {k['name']} lacks {missing} in the result line")
    log(f"[card] {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
