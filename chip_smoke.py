#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port: greedy DVI serving on one NVIDIA
GPU through the port's five hand-written CUDA kernels: vicuna-7b on the
batch-synchronous path and on the continuous-batching path over a paged KV
pool, and mamba2-370m (attention-free, its prefill on the ``ssd_scan``
kernel) through both schedulers; then the training path (mamba2-370m
pretraining, vicuna-7b's teacher-forced DVI step, the quickstart),
vicuna-7b's speculative sampling and per-lane adaptive depth, chunked
prefill on both models' continuous paths, the prefix cache behind the
HTTP front end and the launchers, the paper's baselines (Medusa-lite on
vicuna-7b, two-model SpS on the qwen3 pair) with qwen2.5-14b's DVI, and the
hybrid and MoE decoders (recurrentgemma-9b, llama4-scout-17b-a16e),
DeepSeek-V3's multi-head latent attention with its MTP head
(deepseek-v3-671b), whisper-large-v3's encoder with cross-attention and
paligemma-3b's patch prefix, through ``aux_inputs``, and the int8 KV cache
(``kv_quant``) on vicuna-7b and recurrentgemma-9b, with the port's last two
examples.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. the card's name and power limit, as nvidia-smi reports them;
2. build of the kernels from ``src/repro_torch/csrc`` (nvcc, in parallel);
3. each kernel against its plain PyTorch version on the card, at the paths'
   vicuna-7b shapes in bf16 (attention at both the verify pass's Tq = K+1
   and the draft feeds' Tq = 1), plus a ragged GQA attention case (Tq = 1
   and 5), an r = 1 LoRA case, an exact argmax tie case, and paged cases
   over a shuffled page assignment (a -1 entry mid-row, an all -1 lane, a
   lane past the table, GQA G = 4, ps = 4); the attention kernels' split
   of a lane over C CTAs at its edges, at the main shapes and both Tq (a
   lane of length 1, one shorter than a CTA's share, lanes at the capacity
   and one past it, an idle lane, -1 entries on both sides of a share
   border), every query that sees no slot exactly 0; paged cases with
   ``page_counts`` (below ceil(len/ps), 0 and past MPS, both clipped; None
   bit-identical to the call without it); ``ssd_scan`` at the mamba2
   paths' prefill shapes (B 8, T = Q = 127 from strided views of a conv
   output; B = 1 admissions, T = Q = 95 and 63; a padded T = 256, Q = 128
   with dt = 0 on the last 56 rows; a carried h0), checking y and the final
   state, with ``ops.ssd_plan``'s split P beside each; ``verify_argmax``
   and ``lora_logits`` at mamba2-370m's d = 1024 and tied V = 50280, tie
   rule included, and at their edge cases (V about the 128-column strip
   and with rows off 16 bytes, T in one, two and several row passes, r = 1
   and 512, ties at every offset of a strip and a fragment), each gated
   to the loader ``ops.vocab_fast`` must pick (the paths' shapes the fast
   one).  Then each kernel's device time
   (``time_ms``: L2 flushed, the host's enqueue hidden behind a spin kernel
   and checked on every call) and per-call time, its plain version's, a
   library call's where one computes the same function, and the least
   time the card could take, at the main shapes and at the draft feed
   (attention), mamba2's d and V (vocab kernels) and the B = 1 admission
   (``ssd_scan``, its bound on the tensor cores at the kernel's split
   count, the earlier all-float32 CUDA-core figure beside it as
   ``f32_core_bound_ms``); beside each vocab kernel cuBLAS's bf16 h @ w alone
   (``gemm_ms``, a yardstick without the argmax or the LoRA term); and
   ``lora_logits`` at the online update's shape (T = 256 rows, 4 passes of
   64, bf16, r 64): its forward through the differentiable wrapper against
   the plain version, its dA and dB against autograd through the plain
   version, and its device time beside ``gemm_ms`` at T = 256; for the
   training path (phase 11), ``ssd_scan`` at mamba2 pretraining's shape (B
   8, T 256, Q 128, bf16) with inputs that require gradients (``ops.SsdScan``:
   one kernel launch forward) and its gradients against autograd through
   the plain version (``TOL["ssd_scan backward"]``), the backward timed
   alone, and ``lora_logits`` at the DVI step's 8184 rows (forward, dA and
   dB, its time beside ``gemm_ms`` and its bound); for adaptive depth
   (phase 12), both attention kernels at the verify pass's Tq = K_blk + 1
   = 2, 3 and 4 with the split's edge cases, timed at Tq 2 and 3; for
   chunked prefill (phase 13), both attention kernels at a chunk step's Tq
   32 and 128 (vicuna's G = 1; 1 and 2 row tiles of 64 query rows) and Tq
   64 at G = 2 (qwen3-0.6b's 16 heads over 8 kv heads; 2 row tiles), each
   checked and timed with its bound and SDPA's time; for phase 15,
   ``verify_argmax`` at the qwen3 pair's heads (d 1024 and 2048, V 151936)
   and qwen2.5-14b's (d 5120, V 152064) at T 8 and 40, ``lora_logits`` at
   qwen2.5-14b's draft head (T 8), and ``decode_attention`` at qwen3's G 2
   (Tq 1, 4, 5) and qwen2.5-14b's G 5 (Tq 1, 5), each checked and timed;
   for phase 19, the int8 forms of the attention kernels (int8 K/V with
   one float32 scale a slot and kv head, slot 0 of lane 0 all zeros): the
   causal form at vicuna's verify pass and draft feed, the ring form at
   recurrentgemma's local layers (wrapped lanes), the paged form at phase
   8's pool with and without page counts, both forms at a chunk step's
   shapes (Tq 32 and 128 at G 1, 64 at G 2; contiguous and paged) and the
   paged form at the prefix cache's warm tails (Tq 32 from offsets on a
   page border and inside a page), every launch counted as int8
   (``ops.attn_kv``), each timed with its bound at hd + 4 bytes a slot and
   kv head and SDPA over the dequantised bf16 view (not timed);
4. the sync path: vicuna-7b at full width and depth in bf16, random weights
   drawn on the card from a seed, a sync ``ServingEngine`` (drafter frozen,
   ``learn=False``, as in phases 8 and 9) answering 8
   requests (prompts of 64-128 tokens, 32 new tokens each), then the same
   requests once more under torch.profiler for the device's busy share
   and the attention and vocab kernels' device time a launch and per
   block-step, beside phase 3's; every vocab launch on the fast loader;
5. the kernels' launch counts over phase 4 against the per-block formula;
6. greedy losslessness on the card: speculative streams against
   ``ar_generate`` streams;
8. the continuous path: a continuous ``ServingEngine`` over a paged pool
   (8 lanes, pages of 16 tokens, supersteps of 4 blocks) answering 16
   requests submitted at once (prompts of 64, 96 or 128 tokens, 16 or 32
   new tokens), once over an ample pool and once over a pool tight enough
   to preempt, then the ample traffic under torch.profiler.  It checks
   every completion against ``ar_generate`` on its exact prompt, an empty
   pool at the end, the per-block launch formula, and that no dispatch
   synchronises with the device (sync debug mode "error"); it reports the
   synchronising operations per tick; the profile gives the paged
   and vocab kernels' device time a launch beside phase 3's;
9. mamba2-370m at full width cut to M_LAYERS of its 48 layers in bf16, random weights
   drawn on the card from a seed: a sync ``ServingEngine`` answering 8
   requests (prompts of 64-128 tokens, left-padded to their bucket, 32 new
   tokens each), then a continuous one over the contiguous layout (8
   lanes, supersteps of 4 blocks) answering 16 requests, each profiled
   once more for the device's busy share and the vocab kernels' and
   ``ssd_scan``'s device time a launch (and per prefill call) beside
   phase 3's.  It checks every completion
   against ``ar_generate`` on the prompt the engine decoded (bucket-padded,
   in one batch, on the sync path; exact and alone on the continuous one);
   on the continuous path a first difference outside a near-tie passes
   only if greedy AR decoded at the engine's row counts (``ar_at_engine_rows``)
   gives the completion bit for bit; then the launch formula (per
   block 0 attention, 5 ``lora_logits``, 1 ``verify_argmax``, 0
   ``ssd_scan``; 48 ``ssd_scan`` per prefill call), no synchronising
   operation inside a continuous dispatch, all lanes empty at the end,
   every vocab launch on the fast loader;
10. the Improve loop on vicuna-7b, after phase 8 on the same weights: the
   continuous engine of phase 8 (ample pool) with ``learn=True`` (an update
   every 4 blocks, mode "full", lr 1e-3, the trainer state drawn from the
   seed) answering phase 8's 16 requests, and the sync engine with one
   update a batch answering phase 4's 8, each eagerly and graphed.  It
   checks graphed against eager bit for bit, streams and the final drafter
   state (A, B, moments, baseline, steps); each completion against the
   frozen drafter's (or AR's, near-ties allowed); the launch formula plus 2
   ``lora_logits`` an update; the reference's update cadence counted on the
   host; 0 synchronising operations inside every dispatch and update; A
   and B at their addresses; every ``dvi_train_*`` gauge finite.  It
   reports the first and last update's loss terms, acceptance over the
   first and last quarter of the blocks, an update's host and device ms,
   and the graphed path's wall and device ms a block-step and tokens/s
   against phase 8's;
11. the training path, through the port's launcher (``launch/train.py``):
   (b, after phase 10, on its vicuna-7b weights) ``--mode dvi-batch
   --pretrain-steps 0``, 8 teacher-forced drafter steps of 8 x 1024 tokens
   (8184 positions), with gates: the backbone's bits unchanged (checksummed
   on the device), A and B changed, finite loss, gnorm and acc_rate, one
   ``lora_logits`` launch a step, 0 synchronising operations in a step
   after the first; (a, after phase 9) mamba2-370m at full width and depth
   (48 layers, bf16, weights from the seed) ``--mode pretrain``, 40 steps
   of 8 x 256 at lr 2e-3, with gates: step 1's gradient non-zero and finite
   in every layer's A_log, dt_bias, in_proj and conv_w (the scan's
   backward), finite losses and gnorms, 48 ``ssd_scan`` launches a step,
   ``lm_head`` == ``embed.T`` at its address after every step, the
   checkpoint loading back bit for bit with exactly the trained tree's
   keys; then 5 steps on one batch alone, which must cut its loss by 0.5
   nats (the streaming loss's first and last 5 steps are reported), the
   last of them profiled; (c)
   ``examples/torch_quickstart.py`` at its own tiny float32 size, lossless
   against AR.  It reports each step's wall, host and device ms, tokens/s,
   peak memory, the scan backward's share of a pretraining step, and the
   quickstart's acceptance, MAT and AR / DVI wall ratio;
12. speculative sampling and adaptive depth on vicuna-7b, after phase 11b
   on the same weights: (a) ``speculative_generate`` at temperature 0.8 on
   phase 4's 8 requests (padded to 128, 32 new tokens) from a generator
   seeded from SEED, with gates: tokens in the vocabulary, lengths as
   asked, tuples logged, the same seed giving the same streams bit for bit
   and another seed other streams, one sampled block under sync debug mode
   "error", 40 ``decode_attention``, 5 ``lora_logits`` and 0
   ``verify_argmax`` launches a block; ``rejection_commit`` alone at V 64
   over 2^20 lanes, the emitted token within total variation 0.01 of p;
   a sampled and a greedy block's device ms on one cache.  (b) phase 8's
   continuous engine (ample pool, its 16 requests, graphed) with
   ``adaptive_k``: pinned at K (k_min = k_max = k_init = 4) equal to phase
   8's graphed run bit for bit (streams, drafted, blocks); the default
   controller (k_min 1, k_max 4) with gates: each completion equal to
   phase 8's or passing the AR near-tie rule, every lane's depth within
   [k_min, its ceiling k_cap] after each harvest, the launch formula at
   each dispatched draft width (2 K_blk + 32 ``paged_decode_attention``,
   K_blk + 1 ``lora_logits``, 1 ``verify_argmax`` a block), each graph's
   kernel nodes equal to its capture's launches, at most 4 captures, 0
   synchronising operations in a dispatch, host syncs == dispatches, the
   pool empty; then an adversarial swing (cooldown 1, k_init 1, hi 0.1)
   from phase 8's tight pool size down until it preempts, lossless, the
   pool drained.  It reports each mode's wall and device ms a block-step,
   tokens/s, busy share, mean depth, draft efficiency, captures, graph
   pool and peak memory beside phase 8's fixed-K run;
13. chunked prefill (``prefill_chunk`` 32) on the continuous engine: (a,
   after phase 12, on its vicuna-7b weights) phase 8's ample pool and 16
   requests, graphed and eagerly; (b) phase 8's tight pool size, swung
   down until a lane is preempted, counting the victims caught
   mid-prefill; (d) the ample pool with ``learn=True`` and ``adaptive_k``
   (graphed); (c, after phase 9) mamba2-370m at M_LAYERS on the
   contiguous engine (graphed).  Gates: graphed == eager bit for bit (a);
   every completion == ``ar_generate`` on its exact prompt or the near-tie
   rule (a; b and d through the equal completions of a and of phase 8,
   the rest against AR; c through phase 9's, the rest against AR alone or
   at the chunked engine's row counts), with the count equal to phase 8's
   or 9's one-shot streams reported; the largest tick's prefill at most 8
   x 32 tokens; 0 synchronising operations inside a chunk step and a
   dispatch, host syncs == dispatches; the pool or the lanes empty; A and
   B at their addresses (d); launches exact: the per-block formula plus 32
   ``paged_decode_attention`` a chunk step (vicuna), 48 ``ssd_scan`` a
   first-chunk admission and no attention (mamba2), 2 ``lora_logits`` an
   update (d); each graph's kernel nodes == its capture's launches; the
   port's metrics schema gate (``scripts/torch_check_metrics_schema.py``)
   on the drained engines of a and d.  It reports wall and device ms a
   block-step, tokens/s, busy share, tick percentiles, the chunk graph's
   nodes and capture seconds, peak memory and the host ms a block-step per
   tick phase (``admit`` and ``pre_admit`` beside phase 8's);
14. the prefix cache and the serving front end, after phase 13abd on its
   vicuna-7b weights: (a) an engine with ``prefix_cache`` (8 lanes, 152
   pages of 16, chunks of 32, supersteps of 4, learning on, the lifecycle
   tracer and a profiler window of 2 dispatches) behind
   ``serving.http.make_server`` on 127.0.0.1, its graphs captured on the
   driver's thread before any traffic; a first request of its own, over
   whose first 2 dispatches the profiler window runs, then, the counters
   reset, 24 requests of 4 tenants (system prompts of 100 tokens, tails of
   8-40, two exact repeats) streamed over SSE by
   ``launch.load_gen.run_request`` in 3 waves of 8, one client leaving
   mid-stream.  Gates: every SSE stream equal to the engine called
   directly without the cache, or to AR or a near-tie of it (the count
   equal reported); hits, copies on write and a wholly cached admission,
   hits + misses == lookups, one prefill call a miss and none (and no
   kernel launch) in a warm admission; the port's metrics schema gate; the
   launch formula (phase 13's with 2 ``lora_logits`` an update), each
   graph's kernel nodes == its capture's launches; 0 synchronising
   operations in a dispatch, a chunk step, an update and a warm admission,
   host syncs == dispatches; the departed client's lane cancelled, its
   tokens a prefix of its stream, its tenant's system prompt still cached;
   no page used at the end beyond the evictable cached ones; the profiler
   window's trace written with its superstep ranges.  It reports TTFT and
   e2e p50 / p95 (``load_gen.build_report``), warm and cold host ms an
   admission, wall ms a block-step, tokens/s, the window's device ms and
   busy share and the host seconds its close took, the prefix stats, ``replay()`` host ms and the tick phases
   beside phase 13a's.  (b) ``python -m repro_torch.launch.serve`` with
   the prefix cache, and ``launch.api_server`` driven by ``launch.load_gen
   --verify-direct`` then sent SIGTERM, each in a process of its own on the
   tiny vicuna-7b: exit 0, 0 mismatches, the drain line;
15. the paper's baselines: (c, after phase 14 on its vicuna-7b weights)
   Medusa-lite, 3 heads trained 8 steps of 8 x 256 synthetic tokens (drawn
   under PYTHONHASHSEED 0) with gates: finite losses, the heads changed, the
   backbone's bits unchanged; (a) two-model SpS, qwen3-0.6b drafting for
   qwen3-1.7b (bf16, weights from the seed, K 4); (b) qwen3-0.6b drafting
   for itself (the d_K clamp); each on phase 12a's 8 prompts padded to 128
   (32 new tokens) through its runner (``graphs.TwoModelRunner``,
   ``graphs.MedusaRunner``), eagerly and graphed, with gates: graphed ==
   eager bit for bit, every lane equal to the target's ``ar_generate`` or
   a bf16 near-tie, launches exact (SpS L_d K + L_t ``decode_attention`` and
   K + 1 ``verify_argmax`` a block; Medusa 2 x 32 and 2), each graph's
   kernel nodes == its capture's launches, 0 synchronising operations in a
   block-step (sync debug mode "error"), Medusa's MAT >= 1.9; (d)
   qwen2.5-14b at full width (48 layers, d 5120, ``qkv_bias``) serving the
   same prompts through the sync engine, graphed (DVI, split 2), with
   gates: lossless by the near-tie rule, launches exact (56 / 5 / 1 a
   block), nodes == launches, the profile's gate.  It reports each mode's
   wall and device ms a block-step, tokens/s, MAT, acceptance, graph
   nodes, ``replay()`` host ms and peak memory;
16. the hybrid and MoE decoders, weights drawn on the card (bf16, seed 0),
   eagerly and graphed: (a) recurrentgemma-9b at full width cut to R_LAYERS
   of its 38 layers of (rglru, rglru, local), rings of 2048 + 128 slots, through the
   sync engine (phase 4's requests, the graphed run profiled with its
   records gate; then R_LONG lanes of prompts longer than the ring, whose
   prefill keeps the ring's last 2176 positions and whose decode wraps) and
   the contiguous continuous engine (phase 8's requests and one prompt past
   the ring, so a lane's ring wraps there too); (b) llama4-scout-17b-a16e
   at full width cut to L4_LAYERS of its 48 layers (the experts' 4.4 GB a
   layer), its weights drawn after (a)'s are freed, through the paged
   continuous engine (rings per lane, global layers pooled).  Gates:
   graphed == eager bit for bit, each completion == ``ar_generate`` on its
   exact prompt (the sync path's bucket-padded) or the bf16 near-tie rule
   (llama4: its AR logits from AR's own one-token steps; beyond a near-tie
   the float32 witness, ``llama4_witness``: the same engine, graphed, at 4
   layers in float32, every completion == float32 AR or a float32
   near-tie), launches exact (recurrentgemma 12 ring ``decode_attention``,
   5 ``lora_logits``, 1 ``verify_argmax`` a block; llama4 at L4_LAYERS = 4
   layers 2 (K+1) + 1 ring, 1 ``paged_decode_attention``, 5, 1), each graph's
   nodes == its capture's launches, 0 syncs in a dispatch and host syncs
   == dispatches; phase 3 holds the ring form at both configs' shapes
   (wrapped, stale writes) and the vocab pair at V 256000 / d 4096 and
   V 202048 / d 5120;
17. DeepSeek-V3's MLA and MTP head, weights drawn on the card (seed 0):
   (a) deepseek-v3-671b at full width cut to DS_LAYERS of its 61 layers (3
   dense, then 1 MoE of 256 experts, top 8, and a shared one; at most 2 MoE
   layers of 22.5 GB fit one card), bf16, through the sync engine
   (phase 4's requests, the graphed run profiled with its records gate)
   and the contiguous continuous engine (phase 8's requests; MLA has no
   paged cache), eagerly and graphed, and ``mtp_logits`` once on the sync
   prefill's hidden states (shape, finite, device time); (b) its float32
   witness at DS_WIT_LAYERS layers (3 dense + 1 MoE, no MTP) through the
   same engines, graphed, all requests of both.  Gates: graphed == eager
   bit for bit, launches exact (0 ``decode_attention``, 0
   ``paged_decode_attention``, K+1 ``lora_logits``, 1 ``verify_argmax`` a
   block: MLA attends in plain PyTorch, as the reference does in jnp),
   each graph's nodes == its capture's launches, 0 syncs in a dispatch,
   host syncs == dispatches, lanes empty, each bf16 completion == AR on
   its exact (sync: bucket-padded) prompt alone or a bf16 near-tie, beyond
   one held by the witness, whose every completion == float32 AR alone or
   a float32 near-tie; phase 3 holds the vocab pair at d 7168 / V 129280;
18. whisper-large-v3 (32 encoder and 32 decoder layers, d 1280, 1500 stub
   frames) and then paligemma-3b (18 layers, d 2048, MQA of 8 heads of 256,
   256 stub patches) at full width and depth, bf16, weights, drafter and
   stubs drawn on the card from the seed, each on phase 4's 8 requests
   padded to 128 (32 new tokens) with its stubs as ``aux_inputs``: (a, b)
   ``speculative_generate`` eagerly, then ``graphs.GenerateRunner``
   graphed (timed, then profiled with the records gate), with gates:
   launches exact (whisper 80 ``decode_attention`` a block, 40 causal and
   40 of the non-causal form that carries cross-attention, 5
   ``lora_logits``, 1 ``verify_argmax``; paligemma 26 / 5 / 1), every vocab
   launch on the head's loader (whisper's V 51866 rows are not 16-byte
   multiples: the element one), graphed == eager bit for bit, each graph's
   kernel nodes == its capture's launches, 0 synchronising operations in
   a block-step, the static cache at its addresses after the eager
   prefill, each lane == ``ar_generate`` or a bf16 near-tie; (c) one
   ``lm_loss`` step at 4 x 128 tokens with the stubs, forward and backward:
   the loss and every gradient finite, the encoder's or ``vision_proj``'s
   non-zero.  It reports the prefill's and the encoder's device ms, wall
   and device ms a block-step against the bound of the weights and cross
   K/V a block-step reads, tokens/s, busy share, graph nodes, ``replay()``
   host ms and peak memory; phase 3 holds decode_attention at both
   models' widths (Tq 1 and 5), its non-causal form over 1500 frames, and
   the vocab pair at d 1280 / V 51866 and d 2048 / V 257216;
19. the int8 KV cache (``cfg.replace(kv_quant=True)``, the same weights):
   (a, after 15c on phase 4's vicuna-7b weights) the sync engine on phase
   4's requests, eagerly and graphed (the graphed run profiled with its
   records gate), a graphed ``GenerateRunner`` block-step under sync debug
   mode "error" on them padded to 128 (== ``speculative_generate`` bit for
   bit), the continuous engine over phase 8's ample pool on its 16
   requests (graphed, one-shot admission, profiled), and the first 2 of
   phase 14a's waves through a warm (prefix cache, chunks of 32), a cold
   chunked and a one-shot int8 engine; (b, inside phase 16 on its
   recurrentgemma-9b weights) the sync engine, graphed, on phase 4's
   requests and the R_LONG lanes past the ring, then its float32 witness
   (R_WIT_LAYERS layers, the same engine and lanes); (c, after 18)
   ``examples/torch_multi_arch.py`` and ``examples/torch_train_100m.py
   --steps 60 --dvi-prompts 80`` in processes of their own.  Gates:
   graphed == eager (a, sync); each completion == the int8 model's
   ``ar_generate`` or the near-tie rule under its own one-token steps; the
   warm completions == the cold chunked ones or a near-tie, hits and a
   copy on write; each cold chunked completion == the one-shot int8 one
   or first different at a near-tie of int8 AR, any other held by a
   float32 witness that runs every time (vicuna at V_WIT_LAYERS layers
   through the same cold engine, each completion == the chunked function
   outside the engine, ``ar_at_engine_rows`` over a contiguous cache, or a
   float32 near-tie);
   recurrentgemma's float32 witness: each lane == float32 int8 AR or a
   float32 near-tie; the hidden-state drift of the reference test under
   its bound 0.05; launches exact (40 / 0 / 5 / 1, 0 / 40 / 5 / 1 and the
   chunked formula, 12 / 0 / 5 / 1) with every attention launch int8
   (``ops.attn_kv``); nodes == launches; 0 syncs in a block-step and a
   dispatch, host syncs == dispatches; the caches' bytes within 1 % of
   (hd + 4) / (2 hd) of the bf16 ones at the same shapes (vicuna's sync
   cache and pool 0.516, recurrentgemma's rings 0.508); both examples exit
   0 with every ``lossless=True``.  It reports wall and device ms a
   block-step, nodes, busy share and peak beside phases 4 and 8, the
   hidden-state drift, and the completions equal to
   the bf16 ones and (chunked) to the one-shot int8 ones;
20. the multi-device layer, on phase 4's vicuna-7b weights and requests:
   (a, after 19a) ``launch.distributed.init_runtime(require_cuda=True)`` at
   world size 1 from torchrun's variables (set here, a free port, NCCL), a
   1 x 1 mesh on the card, an ``all_reduce`` that returns its tensor
   unchanged, ``production_mesh_or_dryrun()`` raising; (b) phase 4's
   graphed sync path again under ``hint_mesh`` of that mesh: streams bit
   for bit phase 4's, the same graph nodes and capture launches, launches
   40 / 0 / 5 / 1 / 0 a block; the group destroyed; one eager block-step's
   peak memory on the card (phase 4's B 8, cache 294, K 4); (c, in a
   process of its own on the host, started with 19c, after every timed
   window of phases 4-19, and read after it) ``launch.dryrun.run_case`` on fake tensors at a 1 x 1 mesh:
   vicuna-7b at that shape, its argument bytes == the bytes of the params,
   drafter, cache and pending tokens the card holds, exactly, and its peak
   within 10 % of the card's; deepseek-v3-671b at DS_LAYERS and phase
   17's sync shape, its peak within 10 % of phase 17's eager sync peak;
   from DS_LAYERS + 1 layers the layers of deepseek that fit one card, and
   the smallest ("data", "model") mesh with "model" 8 whose decode_32k
   case fits all 61; (d, beside c) ``python -m repro_torch.launch.dryrun
   --arch llama3-405b --shape decode_32k`` at 32 x 8 in a process of its
   own: status, peak, fit, FLOPs, collectives, the roofline's terms,
   seconds; (e, beside 19c's examples) ``examples/torch_serve_drift.py``
   exits 0 with its curves and the post-shift acceptance, frozen against
   online;
7. a ``{"kernels": [...]}`` JSON line, then the ``{"ok": true, ...}`` line.

The float32 witnesses of 16b, 17, 19a and 19b run at the end, beside
19c's examples and 20c-e's processes (``run_witnesses``), after every timed
window.

Phases 4, 8 and 9 run every path twice: eagerly (``graphs=False``) and
replaying one CUDA graph a block-step (the engine's default, the main
path).  The graphed streams must equal the eager ones bit for bit, every
gate above holds on both, each graph's kernel nodes (counted through
libcuda) must equal the launches its capture recorded, and one line per
mode gives the wall and device time per block-step, tokens/s, the busy
share, host launches, captures, nodes, the graph pool and peak memory
(the eager runs of phases 4, 8, 9, 15 and 16 and the graphed runs of
phase 16 but recurrentgemma's sync one are not profiled, to keep the
script within its time limit: no device time or busy share for them).
The graphed continuous paths are traced once more for the host's time per
tick phase.

It imports torch, numpy and the port; nothing of JAX.  It needs one card and
exits non-zero without one.
"""
from __future__ import annotations

import atexit
import gc
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12           # float32 outside the tensor cores

DEV = "cuda"
SEED = 0
N_REQUESTS = 8
MAX_NEW = 32
# bf16 tolerances (ROADMAP parity rules): logits against a float32 plain
# version differ only by float32 summation order; attention outputs differ
# by the plain version's bf16 rounding of the probabilities; the SSD scan
# computes in float32 on both sides, so only the order of summation differs
TOL = {"verify_argmax": (2e-3, 1e-3), "lora_logits": (2e-3, 1e-3),
       "decode_attention": (2e-2, 2e-2), "paged_decode_attention": (2e-2, 2e-2),
       "ssd_scan": (1e-4, 1e-4),
       # the scan's gradient (ops.SsdScan: the plain version's recompute on the
       # card) against autograd through the plain version: float32 on both
       # sides, in other orders; (atol x the gradient's largest entry, rtol)
       "ssd_scan backward": (1e-4, 1e-4)}
GAP_RTOL = 2e-2                  # bf16 top-2 logit gap treated as a tie
GEMM_NOTE = ("gemm_ms: cuBLAS torch.matmul(h, w) in bf16 alone, a yardstick: it writes "
             "the logits and computes neither the argmax nor the LoRA term")
# the continuous path (phase 8)
C_SLOTS, C_PAGE, C_SYNC, C_REQUESTS = 8, 16, 4, 16
C_PROMPTS, C_NEW = (64, 96, 128), (16, 32)
C_PAGES_AMPLE, C_PAGES_TIGHT = 152, 48
# the Improve loop (phase 10): phase 8's continuous path and phase 4's sync
# path with learn=True, the reference engine's defaults
L_UPDATE_EVERY, L_LR, L_MODE = 4, 1e-3, "full"
# rows of h one pass of the vocab kernels holds (csrc/vocab_tile.cuh: MAX_NT
# n8 tiles); the update's lora_logits at dvi.batch_size = 256 rows takes 4
VOCAB_PASS_ROWS = 64
# the LoraLogits backward (dA, dB) against autograd through the plain
# version: both are float32 products on the card, in other orders
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-4   # atol x the gradient's largest entry
# the mamba2 paths (phase 9): the sync path's 8 requests and the continuous
# path's 16, as for vicuna; the continuous cache is contiguous; phases 9 and
# 13c cut mamba2-370m to M_LAYERS of its 48 layers (the script's time limit)
M_NAME, M_LAYERS = "mamba2-370m", 8
# the training path (phase 11): mamba2-370m pretraining, B 8 x T 256 at the
# reference launcher's lr, 40 steps (each batch one task category, in turn:
# at this depth each step overshoots toward its batch's category, so the
# streaming loss does not fall in 40 steps at any rate tried,
# repro_torch/launch/lr_sweep.py), then P_DESCENT more steps on one batch,
# which must cut that batch's loss by at least P_DROP nats; vicuna-7b
# dvi-batch, 8 steps of B 8 x T 1024, whose 8 x 1023 = 8184 positions stay
# under the reference's 8192
P_STEPS, P_B, P_T, P_DESCENT, P_DROP = 40, 8, 256, 5, 0.5
D_STEPS, D_B, D_T = 8, 8, 1024
D_ROWS = D_B * (D_T - 1)
# speculative sampling (phase 12a): phase 4's requests at this temperature;
# rejection_commit alone over 2^20 lanes at V = 64, in chunks of 2^18
S_TEMP, S_TV_V, S_TV_LANES, S_TV_CHUNK = 0.8, 64, 1 << 20, 1 << 18
# adaptive depth (phase 12b): the default controller's depth range
A_KMIN, A_KMAX = 1, 4
# chunked prefill (phase 13): phase 8's continuous paths with prompts
# prefilled in chunks of this many tokens (phase 8's prompts of 64-128
# tokens take 2-4 chunks); phase 3 times both attention kernels at a chunk
# step's Tq 32 and 128 (vicuna's G = 1) and 64 at G = 2 (qwen3-0.6b's 16
# query heads over 8 kv heads)
P_CHUNK = 32
CHUNK_ATTN = ((32, 32, 32), (128, 32, 32), (64, 16, 8))      # (Tq, H, KV)
# phase 13c's witness for a mamba2 chunked completion that differs from AR
# beyond a bf16 near-tie (chunk_witness): in float32 a top-2 logit gap
# within this share of the top logit is a tie, and the chunk-built SSM
# states and conv windows equal one-shot prefill's within F32_STATE_RTOL a
# layer (the two paths differ in float32 summation order alone); in bf16
# the chunk-built ones lie at most BF16_STATE_RATIO times as far from the
# float32 one-shot ones as bf16 one-shot prefill's do
F32_GAP_RTOL, F32_STATE_RTOL, BF16_STATE_RATIO = 1e-3, 1e-3, 4.0
# the prefix cache behind the HTTP front end (phase 14a): 24 requests of 4
# tenants in 3 waves of 8, each a tenant's system prompt of H_SYS tokens
# (6 full pages of 16 and 4 tokens into a seventh) and a tail of its own;
# the first request of each tenant has a tail of 8-11 tokens, so its prompt
# ends inside the seventh page, which later requests copy on write; wave 3
# opens with two exact repeats of wave-2 prompts (wholly cached), and one
# client of wave 3 closes its socket after H_CANCEL_AFTER tokens; the
# engine's profiler window spans H_PROFILE_STEPS dispatches
H_TENANTS, H_SYS, H_WAVES, H_WAVE = 4, 100, 3, 8
H_REPEATS = {16: 8, 17: 11}          # request -> the wave-2 request it repeats
H_CANCEL, H_CANCEL_AFTER = 20, 8
H_PROFILE_STEPS, H_TIMEOUT = 2, 600.0
# phase 3's warm tails: a chunk step's lanes starting at these cached offsets
WARM_STARTS = (96, 100, 101, 112, 117, 16, 64, 133)
# the launchers (phase 14b) on the tiny vicuna-7b, in their own processes
LAUNCH_TIMEOUT = 300.0
# the baselines and qwen2.5-14b (phase 15): phase 12a's 8 prompts padded to
# B_TP tokens, MAX_NEW new each; the qwen3 pair's and qwen2.5-14b's vocab
# heads (tag, d, V) and attention widths (Tq, query heads over Q_KV kv
# heads) that phase 3 checks; Medusa-lite's heads, trained for M_STEPS
# steps of M_B x M_T synthetic tokens (seeded with PYTHONHASHSEED 0 in a
# process of their own) at M_LR, and its least MAT
B_TP, SPS_K = 128, 4
# the SpS pair cut to Q_LAYERS of their 28 layers since PR 28 (the script's
# time limit)
Q_LAYERS = 14
Q_HEADS = (("qwen3_0_6b", 1024, 151936), ("qwen3_1_7b", 2048, 151936),
           ("qwen25_14b", 5120, 152064))
Q_ATTN, Q_KV = ((1, 16), (4, 16), (5, 16), (1, 40), (5, 40)), 8
M_HEADS, M_STEPS, M_B, M_T, M_LR, M_MAT = 3, 8, 8, 256, 1e-3, 1.9
# the hybrid and MoE decoders (phase 16): recurrentgemma-9b at full width cut
# to R_LAYERS, llama4-scout-17b-a16e at full width cut to L4_LAYERS of its 48
# layers (each 4.4 GB in bf16: all 48 do not fit one card; 8 are two
# (local x 3, attn) periods, so two paged layers); phase 3 checks
# their ring attention and vocab heads (tags "rg" and "l4"); the sync run of
# long prompts: R_LONG lanes of prompts longer than recurrentgemma's ring
# (2176 slots), padded to the engine's one bucket R_BUCKET, so the prefill
# takes the ring's wrapped write and decoding wraps
R_NAME, L4_NAME, L4_LAYERS = "recurrentgemma-9b", "llama4-scout-17b-a16e", 8
# recurrentgemma-9b cut to R_LAYERS of its 38 layers since PR 28 (the
# script's time limit): 4 periods of (rglru, rglru, local) and 2 RG-LRU
# layers, so 4 ring layers, all in the verify pass
R_LAYERS = 14
# layers of the float32 engine that witnesses llama4's (``llama4_witness``:
# at 8 layers its float32 weights take 73.4 GiB, beside 3 GiB of rings)
L4_WIT_LAYERS = 4
R_LONG, R_BUCKET = 2, 2400
R_LONG_PROMPTS = (2200, 2400)
# DeepSeek-V3 (phase 17): deepseek-v3-671b at full width cut to DS_LAYERS of
# its 61 layers, 3 dense and 1 MoE (one MoE layer's routed experts alone are
# 22.5 GB in bf16, so a third would not fit one card; a second fits, but the
# script's time limit keeps one); its float32 witness at DS_WIT_LAYERS layers,
# 3 dense and 1 MoE without the MTP head (15.1 B parameters, 60.4 GB); phase
# 3 checks its vocab heads (tag "ds": d 7168, V 129280)
DS_NAME, DS_LAYERS, DS_WIT_LAYERS = "deepseek-v3-671b", 4, 4
# the multi-device layer (phase 20): phase 4's decode shape for the dry run
# held against the card (8 lanes at 128 committed tokens, a cache of 294),
# the tolerance of its peak, and the production case run beside it
D20_B, D20_S, D20_CAP = N_REQUESTS, 128, 294
D20_PEAK_RTOL = 0.10
D20_CASE = ("llama3-405b", "decode_32k")
D20_TIMEOUT = 600.0
# Whisper and PaliGemma (phase 18): whisper-large-v3 (32 encoder and 32
# decoder layers, 1500 stub frames of 1280) and paligemma-3b (18 layers, 256
# stub patches of 1152) at full width and depth in bf16, weights and stubs
# drawn on the card from SEED; phase 4's 8 requests padded to B_TP through
# speculative_generate (eager) and graphs.GenerateRunner (graphed) with the
# stubs as aux_inputs; AUX_CAP cache slots past paligemma's patches (B_TP +
# MAX_NEW + K + 2 + 128, K = 4: the port's default capacity); one training
# step each of AUX_TRAIN_B x AUX_TRAIN_T tokens
W_NAME, PG_NAME = "whisper-large-v3", "paligemma-3b"
AUX_CAP = B_TP + MAX_NEW + 4 + 2 + 128
AUX_TRAIN_B, AUX_TRAIN_T = 4, 128
# the int8 KV cache (phase 19): the chunked prefix-cache run serves the
# first Q_WAVES of phase 14a's waves, Q_NEW new tokens a request (the
# script's time limit)
Q_WAVES, Q_NEW = 2, 16
# layers of the float32 engine that witnesses the cold chunked int8
# completions (``int8_chunk_witness``) and of the one that witnesses
# recurrentgemma's int8 lanes (``rg_int8_witness``: two (rglru, rglru, local)
# periods, so two ring layers)
V_WIT_LAYERS, R_WIT_LAYERS = 8, 6
# the int8 cache's drift from bf16 (``int8_hidden_drift``) stays under the
# bound of the reference's tests/test_kv_quant.py
INT8_DRIFT = 0.05


def phase(n: int, msg: str) -> None:
    print(f"[phase {n}] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


_SPIN: dict = {}


def spin_cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` per millisecond, measured once."""
    if not _SPIN:
        n = 1 << 21
        torch.cuda._sleep(n)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(n)
        b.record()
        b.synchronize()
        _SPIN["cycles_per_ms"] = n / a.elapsed_time(b)
    return _SPIN["cycles_per_ms"]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> tuple:
    """(device ms, call ms): medians over `iters` calls of `fn`, with the
    50 MB L2 flushed before each call (the model path finds these operands
    cold).

    Device ms: after the flush a spin kernel (``torch.cuda._sleep``) holds
    the device while the host enqueues event a, the call and event b, so
    the events time the call's kernels back to back and none of the host's
    work (the wrapper's checks, ctypes, PyTorch's dispatch).  The spin is 10
    times the slowest warm enqueue, at least 10 ms, so that a stall of the
    shared host hides behind it too; the host's enqueue time
    is measured on every call, from before the spin's launch, and the
    timing fails if it ever reaches the spin.  Call ms: the same events
    without the spin, so they also hold any wait for the host, as an idle
    device sees the call."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)
    enqueue = []
    for _ in range(warmup):
        t0 = time.perf_counter()
        fn()
        enqueue.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    spin_ms = max(10.0, 10e3 * max(enqueue[1:]))
    cycles = int(spin_ms * spin_cycles_per_ms())
    dev, call, worst = [], [], 0.0
    gc.disable()
    try:
        for _ in range(iters):
            flush.zero_()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            torch.cuda._sleep(cycles)
            a.record()
            fn()
            b.record()
            worst = max(worst, time.perf_counter() - t0)
            b.synchronize()
            dev.append(a.elapsed_time(b))
            flush.zero_()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            call.append(a.elapsed_time(b))
    finally:
        gc.enable()
    check(worst * 1e3 < spin_ms, f"timing: the host took {worst * 1e3:.3f} ms to enqueue a "
                                 f"call, not hidden by the {spin_ms:.3f} ms spin")
    return float(np.median(dev)), float(np.median(call))


def timing(kernel, plain, b: tuple, library=None) -> dict:
    """The timing keys of a row: the kernel's, its plain version's and the
    library call's device and call ms (``time_ms``), the bound and the
    share of it the kernel reaches."""
    ms, call_ms = time_ms(kernel)
    plain_ms, plain_call_ms = time_ms(plain)
    lib_ms, lib_call_ms = time_ms(library) if library is not None else (None, None)
    return dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, plain_call_ms=plain_call_ms,
                library_ms=lib_ms, library_call_ms=lib_call_ms, bound_ms=b[0],
                bound_by=b[1], bound_share=b[0] / ms)


def bound(nbytes: float, op_seconds: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_bytes, op_seconds) * 1e3,
            "bytes" if t_bytes >= op_seconds else "operations")


def max_err(x: torch.Tensor, y: torch.Tensor) -> tuple:
    d = (x.float() - y.float()).abs()
    return float(d.max()), float((d / y.float().abs().clamp(min=1e-3)).max())


def close(name: str, x, y) -> tuple:
    atol, rtol = TOL[name]
    err, rel = max_err(x, y)
    ok = bool(((x.float() - y.float()).abs() <= atol + rtol * y.float().abs()).all())
    return err, rel, ok


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def loader_used(ops, name: str) -> str:
    """The loader of the one vocab launch since the last reset."""
    paths = ops.vocab_paths[name]
    check(sum(paths.values()) == 1, f"{name}: {paths} launches by loader, expected one")
    return "fast" if paths["fast"] else "element"


def check_verify(ops, ref, gen, T, d, V, label, loader="fast"):
    """verify_argmax at (T, d, V) in bf16 against its plain version, on the
    loader the path's head takes (`loader`: whisper's V 51866 rows of
    103732 bytes take the element one)."""
    h = torch.randn((T, d), generator=gen, device=DEV).to(torch.bfloat16)
    w = (torch.randn((d, V), generator=gen, device=DEV) / d ** 0.5).to(torch.bfloat16)
    ops.reset_launches()
    arg, mx = ops.verify_argmax(h, w)
    check(loader_used(ops, "verify_argmax") == loader,
          f"verify_argmax {label}: this shape must take the {loader} loader")
    logits = h.float() @ w.float()
    top2 = logits.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    arg_ref, mx_ref = ref.verify_argmax(h, w)
    err, rel, ok = close("verify_argmax", mx, mx_ref)
    atol, rtol = TOL["verify_argmax"]
    near_tie = gap <= atol + rtol * top2[:, 0].abs()
    bad = (arg != arg_ref) & ~near_tie
    phase(3, f"verify_argmax {label}: T={T} d={d} V={V} bf16 max abs err {err:.3e} "
             f"rel {rel:.3e} (atol {atol} rtol {rtol}); index mismatches "
             f"{int((arg != arg_ref).sum())} of {T}, all at near-ties: {not bool(bad.any())}")
    check(ok and not bool(bad.any()), f"verify_argmax {label} disagrees with its plain version")
    # exact tie rule: w repeated across vocab tiles gives bit-equal logits, and
    # the lowest index must win — the same answer as on the first copy alone
    w_tie = w[:, :1000].repeat(1, 32).contiguous()
    arg_t, mx_t = ops.verify_argmax(h, w_tie)
    arg_1, mx_1 = ops.verify_argmax(h, w[:, :1000].contiguous())
    check(torch.equal(arg_t, arg_1) and torch.equal(mx_t, mx_1) and bool((arg_t < 1000).all()),
          "verify_argmax tie rule: the lowest index must win")
    phase(3, f"verify_argmax tie rule: w repeated 32x across the vocab -> lowest index, exact: True")
    return h, w, err


def check_lora(ops, ref, gen, T, d, V, r, label, loader="fast"):
    h = torch.randn((T, d), generator=gen, device=DEV).to(torch.bfloat16)
    w = (torch.randn((d, V), generator=gen, device=DEV) / d ** 0.5).to(torch.bfloat16)
    a = torch.randn((d, r), generator=gen, device=DEV) / d ** 0.5
    b = torch.randn((r, V), generator=gen, device=DEV) * 0.05
    gamma = 2.0
    ops.reset_launches()
    out = ops.lora_logits(h, w, a, b, gamma)
    check(loader_used(ops, "lora_logits") == loader,
          f"lora_logits {label}: this shape must take the {loader} loader")
    err, rel, ok = close("lora_logits", out, ref.lora_logits(h, w, a, b, gamma))
    atol, rtol = TOL["lora_logits"]
    phase(3, f"lora_logits {label}: T={T} d={d} V={V} r={r} max abs err {err:.3e} "
             f"rel {rel:.3e} (atol {atol} rtol {rtol}) ok={ok}")
    check(ok, f"lora_logits {label} disagrees with its plain version")
    return (h, w, a, b, gamma), err


def check_lora_update(ops, ref, gen, T, d, V, r, gamma, label="the update"):
    """lora_logits at the online update's shape (T = dvi.batch_size rows in
    bf16, A and B requiring gradients): the forward through the
    differentiable wrapper (the kernel, on the fast loader) against the
    plain version at ``TOL``, and its dA and dB against autograd through
    ``ref.lora_logits`` at GRAD_RTOL / GRAD_ATOL.  Returns the timing
    arguments, the forward's and the gradients' max abs errors."""
    h = torch.randn((T, d), generator=gen, device=DEV).to(torch.bfloat16)
    w = (torch.randn((d, V), generator=gen, device=DEV) / d ** 0.5).to(torch.bfloat16)
    a = (torch.randn((d, r), generator=gen, device=DEV) / d ** 0.5).requires_grad_()
    b = (torch.randn((r, V), generator=gen, device=DEV) * 0.05).requires_grad_()
    g = torch.randn((T, V), generator=gen, device=DEV) / (T * V) ** 0.5
    ops.reset_launches()
    out = ops.lora_logits(h, w, a, b, gamma)
    check(out.requires_grad and loader_used(ops, "lora_logits") == "fast",
          "lora_logits at the update's shape must run the kernel on the fast loader")
    (out * g).sum().backward()
    da, db = a.grad.clone(), b.grad.clone()
    a.grad = b.grad = None
    plain = ref.lora_logits(h, w, a, b, gamma)
    (plain * g).sum().backward()
    err, rel, ok = close("lora_logits", out.detach(), plain.detach())
    grad_err, grad_ok = {}, True
    for name, got, want in (("dA", da, a.grad), ("dB", db, b.grad)):
        diff = (got - want).abs()
        grad_err[name] = float(diff.max())
        grad_ok &= bool((diff <= GRAD_ATOL * float(want.abs().max())
                         + GRAD_RTOL * want.abs()).all())
    atol, rtol = TOL["lora_logits"]
    phase(3, f"lora_logits at {label} (T={T}, {-(-T // VOCAB_PASS_ROWS)} row passes): d={d} "
             f"V={V} r={r} forward max abs err {err:.3e} rel {rel:.3e} (atol {atol} rtol "
             f"{rtol}); backward max abs err dA {grad_err['dA']:.3e}, dB {grad_err['dB']:.3e} "
             f"(rtol {GRAD_RTOL}, atol {GRAD_ATOL} x max |grad|), launches "
             f"{ops.launches['lora_logits']}; ok={ok and grad_ok}")
    check(ok and grad_ok and ops.launches["lora_logits"] == 1,
          f"lora_logits at {label}'s shape disagrees with its plain version")
    return (h, w, a.detach(), b.detach(), gamma), err, grad_err


# the vocab kernels' edge cases (phase 3): widths about the 128-column strip
# (8 and 1 short of it, exactly it, 1 and 8 past it) and rows that are not
# 16-byte multiples (odd V in bf16: the element loader); row counts in one,
# two and several passes; ties placed at every offset of a strip and a
# fragment (the first L columns repeated n times; 1001 and 5 are odd); r = 1
# and the largest rank the kernel takes
VOCAB_EDGE_V = (120, 127, 128, 129, 136, 1001)
VOCAB_EDGE_T = (1, 9, 41, 49, 67)
VOCAB_EDGE_TIES = ((1001, 32), (5, 200), (3, 43))
LORA_EDGE_R = (1, 512)


def vocab_edges(ops, ref, gen, d, V):
    """verify_argmax and lora_logits (r = 64) in bf16 at the edge cases,
    each against its plain version at ``TOL``, each on the loader that
    ``vocab_fast`` must pick (fast iff V * 2 is a multiple of 16, d and the
    pointers being aligned); the exact tie rule at every offset."""
    def loader_ok(name, V_):
        return loader_used(ops, name) == ("fast" if V_ * 2 % 16 == 0 else "element")

    def verify_case(T, V_, w=None):
        h = torch.randn((T, d), generator=gen, device=DEV).to(torch.bfloat16)
        if w is None:
            w = (torch.randn((d, V_), generator=gen, device=DEV) / d ** 0.5).to(torch.bfloat16)
        ops.reset_launches()
        arg, mx = ops.verify_argmax(h, w)
        ok = loader_ok("verify_argmax", V_)
        arg_r, mx_r = ref.verify_argmax(h, w)
        err, _, close_ok = close("verify_argmax", mx, mx_r)
        top2 = (h.float() @ w.float()).topk(min(2, V_), dim=-1).values
        atol, rtol = TOL["verify_argmax"]
        near = top2[:, 0] - top2[:, -1] <= atol + rtol * top2[:, 0].abs()
        return err, ok and close_ok and not bool(((arg != arg_r) & ~near).any())

    def lora_case(T, V_, r):
        h = torch.randn((T, d), generator=gen, device=DEV).to(torch.bfloat16)
        w = (torch.randn((d, V_), generator=gen, device=DEV) / d ** 0.5).to(torch.bfloat16)
        a = torch.randn((d, r), generator=gen, device=DEV) / d ** 0.5
        b = torch.randn((r, V_), generator=gen, device=DEV) * 0.05
        ops.reset_launches()
        out = ops.lora_logits(h, w, a, b, 2.0)
        ok = loader_ok("lora_logits", V_)
        err, _, close_ok = close("lora_logits", out, ref.lora_logits(h, w, a, b, 2.0))
        return err, ok and close_ok

    cases = ([("verify_argmax", f"T=40 V={v}", lambda v=v: verify_case(40, v))
              for v in VOCAB_EDGE_V]
             + [("verify_argmax", f"T={t} V={V}", lambda t=t: verify_case(t, V))
                for t in VOCAB_EDGE_T]
             + [("lora_logits", f"T=8 V={v} r=64", lambda v=v: lora_case(8, v, 64))
                for v in VOCAB_EDGE_V]
             + [("lora_logits", f"T={t} V={V} r=64", lambda t=t: lora_case(t, V, 64))
                for t in VOCAB_EDGE_T]
             + [("lora_logits", f"T=8 V={V} r={r}", lambda r=r: lora_case(8, V, r))
                for r in LORA_EDGE_R])
    for name, label, run in cases:
        err, ok = run()
        atol, rtol = TOL[name]
        phase(3, f"{name} edge {label} d={d}: max abs err {err:.3e} (atol {atol} rtol "
                 f"{rtol}), loader {'fast' if ops.vocab_paths[name]['fast'] else 'element'}: "
                 f"ok={ok}")
        check(ok, f"{name} edge {label} disagrees with its plain version or took the "
                  f"wrong loader")
    for L, n in VOCAB_EDGE_TIES:
        h = torch.randn((41, d), generator=gen, device=DEV).to(torch.bfloat16)
        w = torch.randn((d, L), generator=gen, device=DEV).to(torch.bfloat16)
        arg1, mx1 = ops.verify_argmax(h, w)
        argn, mxn = ops.verify_argmax(h, w.repeat(1, n).contiguous())
        ok = torch.equal(arg1, argn) and torch.equal(mx1, mxn) and bool((argn < L).all())
        phase(3, f"verify_argmax tie rule: {L} columns repeated {n}x (copies at offsets "
                 f"{sorted({L * i % 16 for i in range(n)})} mod 16), T=41 d={d}: lowest "
                 f"index, bit-equal maxima: {ok}")
        check(ok, f"verify_argmax tie rule at offsets of {L} columns")


def close_visible(name, out, plain, visible):
    """Kernel output against its plain version on the (lane, query) rows
    that see a slot; the other rows must be exactly 0 (the plain version
    gives them the reference's uniform average).  visible (B, Tq) bool.
    Returns (max abs err, ok)."""
    B, Tq = visible.shape
    out4, plain4 = out.reshape(B, Tq, *out.shape[-2:]), plain.reshape(B, Tq, *out.shape[-2:])
    vis = torch.as_tensor(visible, device=out.device)
    err, ok = 0.0, True
    if bool(vis.any()):
        err, _, ok = close(name, out4[vis], plain4[vis])
    return err, ok and bool((out4[~vis] == 0).all()) and bool(torch.isfinite(plain4).all())


def check_attention(ops, ref, gen, B, Tq, H, KV, hd, S, lengths, label):
    q = torch.randn((B, Tq, H, hd), generator=gen, device=DEV).to(torch.bfloat16)
    k = torch.randn((B, S, KV, hd), generator=gen, device=DEV).to(torch.bfloat16)
    v = torch.randn((B, S, KV, hd), generator=gen, device=DEV).to(torch.bfloat16)
    lens = torch.as_tensor(np.asarray(lengths), dtype=torch.int32, device=DEV)
    q_in = q[:, 0].contiguous() if Tq == 1 else q
    out = ops.decode_attention(q_in, k, v, lens)
    visible = np.array([[min(int(n) - (Tq - 1 - t), S) > 0 for t in range(Tq)]
                        for n in lengths])
    err, ok = close_visible("decode_attention", out, ref.decode_attention(q_in, k, v, lens),
                            visible)
    atol, rtol = TOL["decode_attention"]
    phase(3, f"decode_attention {label}: B={B} Tq={Tq} H={H} KV={KV} hd={hd} S={S} "
             f"C={ops.attn_splits(S, B * KV * ops.attn_row_tiles(Tq * (H // KV)))} row tiles "
             f"{ops.attn_row_tiles(Tq * (H // KV))} lengths {list(map(int, lengths))} max abs err "
             f"{err:.3e} on {int(visible.sum())} of {visible.size} queries that see a slot "
             f"(atol {atol} rtol {rtol}), the others exactly 0: ok={ok}")
    check(ok, f"decode_attention {label} disagrees with its plain version")
    return (q_in, k, v, lens), err


def check_cross(ops, ref, gen, B, Tq, H, hd, F, label):
    """The non-causal form of decode_attention (a decoder's cross-attention
    over an encoder's F frames of K/V, lengths all F) against its plain
    version: every query sees every frame."""
    q = torch.randn((B, Tq, H, hd), generator=gen, device=DEV).to(torch.bfloat16)
    k = torch.randn((B, F, H, hd), generator=gen, device=DEV).to(torch.bfloat16)
    v = torch.randn((B, F, H, hd), generator=gen, device=DEV).to(torch.bfloat16)
    lens = torch.full((B,), F, dtype=torch.int32, device=DEV)
    ops.reset_launches()
    out = ops.decode_attention(q, k, v, lens, causal=False)
    err, _, ok = close("decode_attention", out, ref.decode_attention(q, k, v, lens, causal=False))
    atol, rtol = TOL["decode_attention"]
    phase(3, f"decode_attention non-causal {label}: B={B} Tq={Tq} H=KV={H} hd={hd} S=F={F} "
             f"C={ops.attn_splits(F, B * H * ops.attn_row_tiles(Tq))} max abs err {err:.3e} "
             f"(atol {atol} rtol {rtol}), forms {dict(ops.attn_forms)}: ok={ok}")
    check(ok and ops.attn_forms == {"causal": 0, "ring": 0, "cross": 1},
          f"decode_attention non-causal {label} disagrees with its plain version")
    return (q, k, v, lens), err


def cross_bound(args) -> tuple:
    """The least time of one non-causal call: q read and the output written
    once, every lane's F frames of K and V read once, the lengths; QK^T and
    P.V over every frame for every query, at the bf16 rate."""
    q, k, v, lens = args
    B, Tq, H, hd = q.shape
    F = k.shape[1]
    return bound(q.numel() * 2 * 2 + B * F * H * hd * 2 * 2 + B * 4,
                 4 * hd * F * Tq * H * B / BF16_FLOP_PER_S)


def attn_bound(q, lengths, cap, KV, hd, row_bytes=None) -> tuple:
    """The least time of one contiguous attention call: q read and the
    output written once, each lane's live K and V rows read once, the
    lengths; QK^T and P.V over the slots each query sees, at the bf16 rate.
    `row_bytes`: the bytes of one slot's K (or V) row of a kv head, 2 hd in
    bf16 by default; the int8 cache's hd + 4 (values and the scale)."""
    B, H = q.shape[0], q.shape[-2]
    Tq = q.shape[1] if q.ndim == 4 else 1
    live = sum(min(int(n), cap) for n in lengths)
    row_live = sum(max(0, min(int(n) - (Tq - 1 - t), cap)) for n in lengths
                   for t in range(Tq)) * H
    return bound(q.numel() * 2 * 2 + live * KV * (row_bytes or 2 * hd) * 2 + B * 4,
                 4 * hd * row_live / BF16_FLOP_PER_S)


def sdpa_inputs(q, k, v, lens):
    """The same attention for torch's scaled_dot_product_attention: heads
    first, K/V heads repeated for GQA, the length mask as a boolean mask."""
    B, Tq, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    t = torch.arange(Tq, device=DEV)
    lim = lens.long()[:, None] - (Tq - 1 - t)[None, :]
    mask = torch.arange(S, device=DEV)[None, None, :] < lim[:, :, None]
    rep = H // KV
    return (q.transpose(1, 2), k.repeat_interleave(rep, 2).transpose(1, 2),
            v.repeat_interleave(rep, 2).transpose(1, 2), mask[:, None])


def ring_pos(n: int, C: int, stale: int = 0) -> np.ndarray:
    """A ring's slot positions (C,) after positions 0..n-1 were written in
    order, position p at slot p % C, and `stale` eager writes past them (a
    rejected draft's, p in [n, n + stale)) left in place; -1 where nothing
    was written."""
    pos = np.full(C, -1, np.int32)
    p = np.arange(max(0, n + stale - C), n + stale)
    pos[p % C] = p
    return pos


def ring_visible(pos: torch.Tensor, lens: torch.Tensor, Tq: int, W: int) -> torch.Tensor:
    """(B, Tq, C) bool: query t at qpos = lens - Tq + t sees slot j iff
    0 <= pos[j] <= qpos and pos[j] > qpos - W (the ring step mask)."""
    qend = lens.long()[:, None, None] - Tq + 1 + torch.arange(Tq, device=DEV)[None, :, None]
    p = pos.long()[:, None, :]
    return (p >= 0) & (p < qend) & (p >= qend - W)


def check_ring(ops, ref, gen, B, Tq, H, KV, hd, W, lengths, label, stale: int = 3):
    """The ring form of decode_attention against its plain version: a ring
    of C = W + 128 slots per lane holding positions 0..n-1 (n the lane's
    post-write length, wrapped once n > C) and `stale` rejected writes past
    them, masked to the window W."""
    C = W + 128
    q = torch.randn((B, Tq, H, hd), generator=gen, device=DEV).to(torch.bfloat16)
    k = torch.randn((B, C, KV, hd), generator=gen, device=DEV).to(torch.bfloat16)
    v = torch.randn((B, C, KV, hd), generator=gen, device=DEV).to(torch.bfloat16)
    lens = torch.as_tensor(np.asarray(lengths), dtype=torch.int32, device=DEV)
    pos = torch.as_tensor(np.stack([ring_pos(int(n), C, stale) for n in lengths]), device=DEV)
    q_in = q[:, 0].contiguous() if Tq == 1 else q
    out = ops.decode_attention(q_in, k, v, lens, pos=pos, window=W)
    visible = ring_visible(pos, lens, Tq, W).any(dim=2).cpu().numpy()
    err, ok = close_visible("decode_attention", out,
                            ref.decode_attention(q_in, k, v, lens, pos=pos, window=W), visible)
    atol, rtol = TOL["decode_attention"]
    wrapped = sum(int(n) > C for n in lengths)
    phase(3, f"decode_attention ring {label}: B={B} Tq={Tq} H={H} KV={KV} hd={hd} C={C} "
             f"W={W} C-split={ops.attn_splits(C, B * KV * ops.attn_row_tiles(Tq * (H // KV)))} "
             f"row tiles {ops.attn_row_tiles(Tq * (H // KV))} lengths {list(map(int, lengths))} "
             f"({wrapped} wrapped, {stale} stale writes a lane) max abs err {err:.3e} on "
             f"{int(visible.sum())} of {visible.size} queries that see a slot (atol {atol} "
             f"rtol {rtol}), the others exactly 0: ok={ok}")
    check(ok, f"decode_attention ring {label} disagrees with its plain version")
    return (q_in, k, v, lens, pos, W), err


def ring_bound(args, row_bytes=None) -> tuple:
    """The least time of one ring call: q read and the output written once,
    each lane's live K and V rows (its first min(n, C) slots) and their
    positions read once, the lengths; QK^T and P.V over the slots each
    query sees, at the bf16 rate.  `row_bytes` as in ``attn_bound``."""
    q, k, v, lens, pos, W = args[:6]
    B, C, KV, hd = k.shape
    H = q.shape[-2]
    Tq = q.shape[1] if q.ndim == 4 else 1
    live = sum(min(int(n), C) for n in lens.tolist())
    seen = int(ring_visible(pos, lens, Tq, W).sum()) * H
    return bound(q.numel() * 2 * 2 + live * (KV * (row_bytes or 2 * hd) * 2 + 4) + B * 4,
                 4 * hd * seen / BF16_FLOP_PER_S)


def ring_sdpa_inputs(args):
    """The ring call for torch's scaled_dot_product_attention: heads first,
    K/V heads repeated for GQA, the ring step mask as a boolean mask."""
    q, k, v, lens, pos, W = args
    q4 = q if q.ndim == 4 else q[:, None]
    rep = q4.shape[2] // k.shape[2]
    return (q4.transpose(1, 2), k.repeat_interleave(rep, 2).transpose(1, 2),
            v.repeat_interleave(rep, 2).transpose(1, 2),
            ring_visible(pos, lens, q4.shape[1], W)[:, None])


def paged_tables(rng, lengths, ps, mps, holes=(), unmapped=()):
    """Block tables over a shuffled, non-contiguous page assignment: each
    lane maps the pages covering its length plus one (at most mps), from a
    pool with a few spare pages; `holes` (lane, page) entries and whole
    `unmapped` lanes are -1.  Returns (tbl int32 numpy, physical pages)."""
    mapped = [min(-(-int(n) // ps) + 1, mps) for n in lengths]
    P = sum(mapped) + 1 + 8
    perm = rng.permutation(np.arange(1, P))
    tbl = np.full((len(lengths), mps), -1, np.int32)
    i = 0
    for b, m in enumerate(mapped):
        tbl[b, :m] = perm[i:i + m]
        i += m
    for b, pg in holes:
        tbl[b, pg] = -1
    for b in unmapped:
        tbl[b] = -1
    return tbl, P


def paged_live_slots(tbl, lengths, ps, Tq):
    """Per lane and query, the mapped slots the query sees (the data the
    kernel must read and the dot products it must take)."""
    mps = tbl.shape[1]
    out = []
    for b, n in enumerate(lengths):
        page = tbl[b, np.arange(mps * ps) // ps]
        out.append([int(((page >= 0) & (np.arange(mps * ps) < min(int(n) - (Tq - 1 - t),
                                                                   mps * ps))).sum())
                    for t in range(Tq)])
    return out


def check_paged(ops, ref, gen, rng, B, Tq, H, KV, hd, ps, mps, lengths, label,
                holes=(), unmapped=()):
    tbl, P = paged_tables(rng, lengths, ps, mps, holes, unmapped)
    q = torch.randn((B, Tq, H, hd), generator=gen, device=DEV).to(torch.bfloat16)
    kp = torch.randn((P, ps, KV, hd), generator=gen, device=DEV).to(torch.bfloat16)
    vp = torch.randn((P, ps, KV, hd), generator=gen, device=DEV).to(torch.bfloat16)
    lens = torch.as_tensor(np.asarray(lengths), dtype=torch.int32, device=DEV)
    tbl_t = torch.as_tensor(tbl, device=DEV)
    q_in = q[:, 0].contiguous() if Tq == 1 else q
    out = ops.paged_decode_attention(q_in, kp, vp, lens, tbl_t)
    plain = ref.paged_decode_attention(q_in, kp, vp, lens, tbl_t)
    visible = np.array(paged_live_slots(tbl, lengths, ps, Tq)) > 0
    err, ok = close_visible("paged_decode_attention", out, plain, visible)
    atol, rtol = TOL["paged_decode_attention"]
    tiles = ops.attn_row_tiles(Tq * (H // KV))
    phase(3, f"paged_decode_attention {label}: B={B} Tq={Tq} H={H} KV={KV} hd={hd} ps={ps} "
             f"MPS={mps} C={ops.attn_splits(mps * ps, B * KV * tiles)} "
             f"row tiles {tiles} P={P} lengths "
             f"{list(map(int, lengths))} holes {list(holes)} max abs err {err:.3e} on "
             f"{int(visible.sum())} of {visible.size} queries that see a mapped slot (atol "
             f"{atol} rtol {rtol}), the others exactly 0 (plain: finite): ok={ok}")
    check(ok, f"paged_decode_attention {label} disagrees with its plain version")
    return (q_in, kp, vp, lens, tbl_t, tbl), err


def check_paged_counts(ops, ref, gen, rng, B, Tq, H, KV, hd, ps, mps, lengths, label):
    """Paged attention with per-lane ``page_counts`` at the given widths: the
    lanes take counts below ceil(len/ps), 0 (clipped to 1), past MPS
    (clipped to MPS) and at ceil(len/ps) in turn; every query sees a slot
    (page 0 is mapped), so all rows are held against the plain version.
    The call with page_counts=None must be bit-identical to the call
    without it, and the counts below ceil(len/ps) must change the lanes
    that take them."""
    tbl, P = paged_tables(rng, lengths, ps, mps)
    q = torch.randn((B, Tq, H, hd), generator=gen, device=DEV).to(torch.bfloat16)
    kp = torch.randn((P, ps, KV, hd), generator=gen, device=DEV).to(torch.bfloat16)
    vp = torch.randn((P, ps, KV, hd), generator=gen, device=DEV).to(torch.bfloat16)
    lens = torch.as_tensor(np.asarray(lengths), dtype=torch.int32, device=DEV)
    tbl_t = torch.as_tensor(tbl, device=DEV)
    q_in = q[:, 0].contiguous() if Tq == 1 else q
    need = [-(-int(n) // ps) for n in lengths]
    counts = [(max(1, need[b] // 2), 0, mps + 3, need[b])[b % 4] for b in range(B)]
    pc = torch.as_tensor(np.asarray(counts, np.int32), device=DEV)
    out = ops.paged_decode_attention(q_in, kp, vp, lens, tbl_t, page_counts=pc)
    plain = ref.paged_decode_attention(q_in, kp, vp, lens, tbl_t, page_counts=pc)
    err, _, ok = close("paged_decode_attention", out, plain)
    full = ops.paged_decode_attention(q_in, kp, vp, lens, tbl_t)
    same = torch.equal(ops.paged_decode_attention(q_in, kp, vp, lens, tbl_t,
                                                  page_counts=None), full)
    cut = [b for b in range(B) if min(max(counts[b], 1), mps) < need[b]]
    changed = all(not torch.equal(out[b], full[b]) for b in cut)
    phase(3, f"paged_decode_attention page_counts {label}: B={B} Tq={Tq} MPS={mps} lengths "
             f"{list(map(int, lengths))} pages needed {need} page_counts {counts} max abs err "
             f"{err:.3e} on every query: ok={ok}; page_counts=None bit-identical to the call "
             f"without it: {same}; lanes {cut} cut below their length changed: {changed}")
    check(ok and same and changed and len(cut) > 0,
          f"paged_decode_attention page_counts {label} failed")


def paged_bound(q, tbl, lengths, ps, KV, hd, row_bytes=None) -> tuple:
    """The least time of one paged attention call: q and the output once,
    each lane's live mapped K and V rows once, the lengths and the table
    entries of its live pages; QK^T and P.V over the mapped slots each query
    sees, at the bf16 rate.  `row_bytes` as in ``attn_bound``."""
    B, H = q.shape[0], q.shape[-2]
    Tq = q.shape[1] if q.ndim == 4 else 1
    mps = tbl.shape[1]
    seen = paged_live_slots(tbl, lengths, ps, Tq)
    n_pages = sum(min(-(-int(n) // ps), mps) for n in lengths)
    return bound(q.numel() * 2 * 2 + sum(max(row) for row in seen) * KV * (row_bytes or 2 * hd)
                 * 2 + B * 4 + n_pages * 4,
                 4 * hd * H * sum(sum(row) for row in seen) / BF16_FLOP_PER_S)


def paged_sdpa_inputs(q, kp, vp, lens, tbl_t):
    """SDPA's inputs for a paged call: each lane's logical view gathered
    into a contiguous (B, MPS * ps, KV, hd) copy (before the clock starts;
    the gather is not timed), unmapped slots masked."""
    P, ps, KV, hd = kp.shape
    jj = torch.arange(tbl_t.shape[1] * ps, device=DEV)
    phys = tbl_t.long().clamp(min=0)[:, jj // ps] * ps + jj % ps
    q4 = q if q.ndim == 4 else q[:, None]
    sq, sk, sv, smask = sdpa_inputs(q4, kp.reshape(P * ps, KV, hd)[phys],
                                    vp.reshape(P * ps, KV, hd)[phys], lens)
    return sq, sk, sv, smask & (tbl_t[:, jj // ps] >= 0)[:, None, None, :]


def int8_kv(gen, shape):
    """bf16 K or V of `shape` (..., KV, hd) quantised as the int8 KV cache
    holds them (``kv_quantize``), slot 0 of lane (or page) 0 all zeros, its
    scale at the 1e-6 floor: (int8 values, float32 scales)."""
    from repro_torch.models.layers import kv_quantize
    x = torch.randn(shape, generator=gen, device=DEV).to(torch.bfloat16)
    x[0, 0] = 0
    return kv_quantize(x)


def check_int8(ops, ref, fn: str, label: str, q, k, v, ks, vs, args, kw, visible):
    """One int8 form (``fn``: decode_attention, or paged_decode_attention;
    `args` after q, k, v, `kw` besides) against its plain version, which
    dequantises to bf16 first: the rows that see a slot within ``TOL``, the
    others exactly 0; the launch counted once, as int8.  Returns the max
    abs error."""
    ops.reset_launches()
    out = getattr(ops, fn)(q, k, v, *args, k_scale=ks, v_scale=vs, **kw)
    plain = getattr(ref, fn)(q, k, v, *args, k_scale=ks, v_scale=vs, **kw)
    err, ok = close_visible(fn, out, plain, visible)
    kv = dict(ops.attn_kv)
    atol, rtol = TOL[fn]
    phase(3, f"{fn} int8 {label}: int8 K/V with float32 scales, a zero slot at the 1e-6 floor: "
             f"max abs err {err:.3e} on {int(visible.sum())} of {visible.size} queries that see "
             f"a slot (atol {atol} rtol {rtol}), the others exactly 0; launches by storage "
             f"{kv}: ok={ok}")
    check(ok and kv == {"model": 0, "int8": 1} and ops.launches[fn] == 1,
          f"{fn} int8 {label} disagrees with its plain version")
    return err


def int8_causal_case(ops, ref, gen, B, Tq, H, KV, hd, cap, lens, label):
    """The causal form over an int8 contiguous cache of `cap` slots at
    post-write `lens`, checked by ``check_int8``: a case for ``int8_timing``."""
    q = torch.randn((B, Tq, H, hd), generator=gen, device=DEV).to(torch.bfloat16)
    q = q[:, 0].contiguous() if Tq == 1 else q
    (k, ks), (v, vs) = int8_kv(gen, (B, cap, KV, hd)), int8_kv(gen, (B, cap, KV, hd))
    lens_t = torch.as_tensor(np.asarray(lens), dtype=torch.int32, device=DEV)
    visible = np.array([[min(int(n) - (Tq - 1 - t), cap) > 0 for t in range(Tq)] for n in lens])
    err = check_int8(ops, ref, "decode_attention", label, q, k, v, ks, vs, (lens_t,), {},
                     visible)
    return ("causal", (q, k, v, lens_t), ks, vs, lens, err)


def int8_paged_case(ops, ref, gen, rng, B, Tq, H, KV, hd, mps, lens, label, holes=()):
    """The paged form over int8 pages of C_PAGE slots (lane 0's first page
    the one holding the zero slot) at post-write `lens`, checked by
    ``check_int8``: a case for ``int8_timing``."""
    tbl, P = paged_tables(rng, lens, C_PAGE, mps, holes=holes)
    tbl[0, 0] = 0
    tbl_t = torch.as_tensor(tbl, device=DEV)
    q = torch.randn((B, Tq, H, hd), generator=gen, device=DEV).to(torch.bfloat16)
    q = q[:, 0].contiguous() if Tq == 1 else q
    (k, ks), (v, vs) = int8_kv(gen, (P, C_PAGE, KV, hd)), int8_kv(gen, (P, C_PAGE, KV, hd))
    lens_t = torch.as_tensor(np.asarray(lens), dtype=torch.int32, device=DEV)
    visible = np.array(paged_live_slots(tbl, lens, C_PAGE, Tq)) > 0
    err = check_int8(ops, ref, "paged_decode_attention", label, q, k, v, ks, vs,
                     (lens_t, tbl_t), {}, visible)
    return ("paged", (q, k, v, lens_t, tbl_t, tbl), ks, vs, lens, err)


def int8_chunk_cases(ops, ref, B, H, KV, hd, cap, mps) -> tuple:
    """The int8 forms at chunked prefill's chunk step (phase 19a's cold and
    warm engines), from a generator of their own: CHUNK_ATTN's (Tq, H, KV)
    over a contiguous cache of `cap` slots and over the pool, post-write
    lengths in [Tq, capacity]; then the prefix cache's warm tails, a chunk
    step of Tq = P_CHUNK whose lanes start at the cached WARM_STARTS, on a
    page border (16 n) or inside a page copied on write (16 n + c).
    Returns (contiguous cases, paged cases) by row key."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 20)
    rng = np.random.RandomState(SEED + 20)
    causal, paged = {}, {}
    for Tq, Hc, KVc in CHUNK_ATTN:
        key = f"at_int8_chunk_tq{Tq}" + ("" if Hc == KVc else f"_g{Hc // KVc}")
        label = f"prefill chunk Tq={Tq} G={Hc // KVc}"
        causal[key] = int8_causal_case(ops, ref, gen, B, Tq, Hc, KVc, hd, cap,
                                       list(rng.randint(Tq, cap + 1, size=B)), label)
        paged[key] = int8_paged_case(ops, ref, gen, rng, B, Tq, Hc, KVc, hd, mps,
                                     list(rng.randint(Tq, mps * C_PAGE + 1, size=B)), label)
    paged[f"at_int8_warm_tq{P_CHUNK}"] = int8_paged_case(
        ops, ref, gen, rng, B, P_CHUNK, H, KV, hd, mps, [w + P_CHUNK for w in WARM_STARTS],
        f"prefix-cache warm tails Tq={P_CHUNK}")
    return causal, paged


def int8_dequantized(k, ks, v, vs):
    """The int8 cache's bf16 view (not timed): SDPA's K and V."""
    from repro_torch.models.layers import kv_dequantize
    return kv_dequantize(k, ks, torch.bfloat16), kv_dequantize(v, vs, torch.bfloat16)


def ssd_inputs(gen, B, T, H, hd, ds, pad_rows=0):
    """The scan's inputs as ``ssm_forward_full`` hands them over: xh, Bc and
    Cc bf16 strided views of one (B, T, H*hd + 2*ds) conv output after silu,
    dt after softplus in float32 (0 on the last `pad_rows` rows, as on
    padded rows), A = -exp(A_log) with the model's A_log."""
    xbc = torch.nn.functional.silu(
        torch.randn((B, T, H * hd + 2 * ds), generator=gen, device=DEV)).to(torch.bfloat16)
    xh = xbc[..., :H * hd].reshape(B, T, H, hd)
    Bc = xbc[..., H * hd:H * hd + ds].reshape(B, T, 1, ds)
    Cc = xbc[..., H * hd + ds:].reshape(B, T, 1, ds)
    dt = torch.nn.functional.softplus(torch.randn((B, T, H), generator=gen, device=DEV) - 2.0)
    if pad_rows:
        dt[:, T - pad_rows:] = 0.0
    A = -torch.linspace(1.0, 16.0, H, device=DEV)
    return xh, Bc, Cc, dt, A


def check_ssd(ops, ref, gen, B, T, Q, H, hd, ds, label, pad_rows=0, with_h0=False):
    xh, Bc, Cc, dt, A = ssd_inputs(gen, B, T, H, hd, ds, pad_rows)
    h0 = torch.randn((B, H, hd, ds), generator=gen, device=DEV) if with_h0 else None
    y, h = ops.ssd_scan(xh, Bc, Cc, dt, A, Q, h0=h0)
    y_r, h_r = ref.ssd_scan(xh, Bc, Cc, dt, A, Q, h0=h0)
    err_y, _, ok_y = close("ssd_scan", y, y_r)
    err_h, _, ok_h = close("ssd_scan", h, h_r)
    ok = ok_y and ok_h and y.dtype == h.dtype == torch.float32
    if pad_rows:                   # dt = 0 rows leave the state where it was
        _, h_np = ref.ssd_scan(xh[:, :T - pad_rows], Bc[:, :T - pad_rows],
                               Cc[:, :T - pad_rows], dt[:, :T - pad_rows], A, 1, h0=h0)
        ok = ok and close("ssd_scan", h, h_np)[2]
    atol, rtol = TOL["ssd_scan"]
    P = ops.ssd_plan(B, H, hd, ds, T, Q)
    phase(3, f"ssd_scan {label}: B={B} T={T} Q={Q} H={H} hd={hd} ds={ds} bf16 inputs, "
             f"P={P} (ops.ssd_plan: slices of {hd // P} of hd), max abs err y {err_y:.3e} "
             f"state {err_h:.3e} (atol {atol} rtol {rtol}), float32 outputs ok={ok}")
    check(ok, f"ssd_scan {label} disagrees with its plain version")
    return (xh, Bc, Cc, dt, A, Q, h0), max(err_y, err_h)


def ssd_bound(xh, Bc, dt, Q, h0) -> dict:
    """The least time of one scan: every input read once, y and the final
    state written once in float32, against its products on the tensor
    cores at the kernel's split count: C.B^T on and below the diagonal once
    per lane and chunk, and per head the intra-chunk term (W in three bf16
    terms), the carried-state term (h in three terms) only on chunks that
    start from a state that may be nonzero (after the first chunk, or with
    h0), and the state update (u x in two terms); float32 inputs split x, B
    and C too (six products each).  ``f32_core_bound_ms`` keeps the earlier
    figure beside it: every product, the carried term on every chunk, at the
    float32 CUDA-core rate."""
    B, T, H, hd = xh.shape
    ds = Bc.shape[3]
    nc = T // Q
    f32 = xh.dtype == torch.float32
    nbytes = (xh.numel() * xh.element_size() + 2 * Bc.numel() * Bc.element_size()
              + dt.numel() * 4 + H * 4 + (h0.numel() * 4 if h0 is not None else 0)
              + B * T * H * hd * 4 + B * H * hd * ds * 4)
    tri = Q * (Q + 1) // 2 * nc
    carried_rows = Q * (nc - (0 if h0 is not None else 1))
    cb, intra = 2 * B * tri * ds, 2 * B * H * tri * hd
    carried, update = 2 * B * H * carried_rows * ds * hd, 2 * B * H * T * ds * hd
    terms = (6, 6, 6, 6) if f32 else (1, 3, 3, 2)
    tc = sum(n * f for n, f in zip(terms, (cb, intra, carried, update)))
    ms, by = bound(nbytes, tc / BF16_FLOP_PER_S)
    f32_flop = cb + intra + 2 * update
    return dict(bound=(ms, by), f32_core_bound_ms=bound(nbytes, f32_flop / F32_FLOP_PER_S)[0])


def check_ssd_grad(ops, ref, gen, B, T, Q, H, hd, ds):
    """``ssd_scan`` at mamba2 pretraining's shape with inputs that require
    gradients (``ops.SsdScan``): bf16 xh, Bc and Cc strided views of a conv
    output, float32 dt and A, as ``ssm_forward_full`` hands them over.  The
    forward (the kernel, one launch) against the plain version at ``TOL``,
    the gradients in the conv output, dt and A against autograd through
    ``ref.ssd_scan`` at ``TOL["ssd_scan backward"]``; the backward launches
    no kernel.  Returns the forward's timing arguments, its max abs error,
    the gradients' max abs errors and the backward as a call."""
    xbc = torch.nn.functional.silu(
        torch.randn((B, T, H * hd + 2 * ds), generator=gen, device=DEV)).to(torch.bfloat16)
    xbc.requires_grad_()
    dt = torch.nn.functional.softplus(torch.randn((B, T, H), generator=gen, device=DEV) - 2.0)
    dt.requires_grad_()
    A = (-torch.linspace(1.0, 16.0, H, device=DEV)).requires_grad_()
    xh = xbc[..., :H * hd].reshape(B, T, H, hd)
    Bc = xbc[..., H * hd:H * hd + ds].reshape(B, T, 1, ds)
    Cc = xbc[..., H * hd + ds:].reshape(B, T, 1, ds)
    gy = torch.randn((B, T, H, hd), generator=gen, device=DEV) / (B * T * H * hd) ** 0.5
    leaves = (xbc, dt, A)
    ops.reset_launches()
    y, _ = ops.ssd_scan(xh, Bc, Cc, dt, A, Q)
    check(y.requires_grad and ops.launches["ssd_scan"] == 1,
          "ssd_scan with a gradient must run the kernel once (SsdScan)")
    got = torch.autograd.grad(y, leaves, gy, retain_graph=True)
    y_r, _ = ref.ssd_scan(xh, Bc, Cc, dt, A, Q)
    want = torch.autograd.grad(y_r, leaves, gy)
    err, _, ok = close("ssd_scan", y.detach(), y_r.detach())
    atol, rtol = TOL["ssd_scan backward"]
    grad_err, grad_ok = {}, True
    for name, g, w in zip(("dxBC", "ddt", "dA"), got, want):
        diff = (g.float() - w.float()).abs()
        grad_err[name] = float(diff.max())
        grad_ok &= bool(torch.isfinite(g).all()) and bool(
            (diff <= atol * float(w.float().abs().max()) + rtol * w.float().abs()).all())
    phase(3, f"ssd_scan with its gradient (training): B={B} T={T} Q={Q} H={H} hd={hd} ds={ds}, "
             f"bf16 inputs; forward max abs err {err:.3e}, backward max abs err "
             + ", ".join(f"{k} {v:.3e}" for k, v in grad_err.items())
             + f" (atol {atol} x max |grad|, rtol {rtol}); launches "
             f"{ops.launches['ssd_scan']}; ok={ok and grad_ok}")
    check(ok and grad_ok and ops.launches["ssd_scan"] == 1,
          "ssd_scan's gradient disagrees with autograd through its plain version")
    fwd = (xh.detach(), Bc.detach(), Cc.detach(), dt.detach(), A.detach(), Q, None)
    return fwd, err, grad_err, lambda: torch.autograd.grad(y, leaves, gy, retain_graph=True)


def kernels_phase(cfg, mcfg):
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    hybrids = (("rg", get_config(R_NAME)), ("l4", get_config(L4_NAME)))
    ds = get_config(DS_NAME)
    wcfg, pcfg = get_config(W_NAME), get_config(PG_NAME)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    d, V, H, KV, hd = (cfg.d_model, cfg.vocab_size, cfg.num_heads, cfg.num_kv_heads,
                       cfg.resolved_head_dim)
    K, B = cfg.dvi.k_spec, N_REQUESTS
    T_verify = B * (K + 1)
    cap = 128 + MAX_NEW + K + 2 + 128       # the engine's cache capacity
    rng = np.random.RandomState(SEED)
    main_lens = list(rng.randint(64 + K + 1, 128 + MAX_NEW + K + 1, size=B))
    e = 2                                    # bf16 bytes

    h, w, err_v = check_verify(ops, ref, gen, T_verify, d, V, "main")
    check_verify(ops, ref, gen, 67, 320, 1000, "ragged (T>48, odd tiles)")
    lora_args, err_l = check_lora(ops, ref, gen, B, d, V, cfg.dvi.lora_rank, "main")
    check_lora(ops, ref, gen, B, d, V, 1, "r=1 (ar_generate)")
    # the online update's shape, from a generator of its own so that the
    # other cases keep their inputs
    upd_args, upd_err, upd_grad_err = check_lora_update(
        ops, ref, torch.Generator(device=DEV).manual_seed(SEED + 6), cfg.dvi.batch_size, d, V,
        cfg.dvi.lora_rank, cfg.dvi.lora_alpha / cfg.dvi.lora_rank)
    vocab_edges(ops, ref, torch.Generator(device=DEV).manual_seed(SEED + 4), d, V)
    att_args, err_a = check_attention(ops, ref, gen, B, K + 1, H, KV, hd, cap,
                                      main_lens, "main (verify pass)")
    # a draft feed: one query per lane; its post-write length is the
    # committed length + 1, K below the verify pass's
    feed_lens = [n - K for n in main_lens]
    feed_args, _ = check_attention(ops, ref, gen, B, 1, H, KV, hd, cap, feed_lens,
                                   "draft feed")
    ragged = list(rng.randint(5, 301, size=3))
    check_attention(ops, ref, gen, 3, 1, 32, 8, 128, 300, ragged, "GQA G=4 Tq=1")
    check_attention(ops, ref, gen, 3, 5, 32, 8, 128, 300, ragged, "GQA G=4 Tq=5")
    # the continuous path's pool: pages of C_PAGE tokens, a table row covers
    # the engine's capacity; post-write lengths of its verify pass
    mps = -(-cap // C_PAGE)
    paged_lens = list(rng.randint(min(C_PROMPTS) + K + 1, max(C_PROMPTS) + MAX_NEW + K + 1,
                                  size=B))
    paged_args, err_p = check_paged(ops, ref, gen, rng, B, K + 1, H, KV, hd, C_PAGE, mps,
                                    paged_lens, "main (verify pass)")
    paged_feed_lens = [n - K for n in paged_lens]
    paged_feed_args, _ = check_paged(ops, ref, gen, rng, B, 1, H, KV, hd, C_PAGE, mps,
                                     paged_feed_lens, "draft feed")
    check_paged(ops, ref, gen, rng, 4, K + 1, 32, 8, 128, C_PAGE, mps,
                [mps * C_PAGE + 3, 100, 60, 0],
                "GQA G=4, lane past the table, -1 mid-row, all -1 lanes",
                holes=((1, 2),), unmapped=(2, 3))
    check_paged(ops, ref, gen, rng, 3, 1, H, KV, hd, 4, -(-cap // 4),
                list(rng.randint(5, cap + 1, size=3)), "ps=4, -1 mid-row", holes=((0, 1),))
    # the split's edge cases at the main widths, for the paths' 8 lanes (one
    # CTA a lane and kv head) and in pairs of lanes (each lane split over a
    # cluster), with their own generators so the cases above keep their
    # inputs: a lane of length 1; one shorter than a CTA's share (the other
    # CTAs of its cluster empty); lanes at the capacity and one past it; an
    # idle lane; a paged lane with -1 entries on both sides of a share border
    egen = torch.Generator(device=DEV).manual_seed(SEED + 3)
    erng = np.random.RandomState(SEED + 3)
    pcap = mps * C_PAGE
    edges = [1, 10, cap, cap + 1, 0, 40, 150, cap - 1]
    pedges = [1, 10, pcap, pcap + 1, 0, 200, 150, 40]
    for lanes in (list(range(B)), [1, 5], [3, 0], [4, 2]):
        nb = len(lanes)
        sh = ops.attn_share(pedges[5], ops.attn_splits(pcap, nb * KV))
        border = sh // C_PAGE if sh < pedges[5] else 1
        holes = ((lanes.index(5), border - 1), (lanes.index(5), border)) if 5 in lanes else ()
        for Tq in (K + 1, 1):
            check_attention(ops, ref, egen, nb, Tq, H, KV, hd, cap, [edges[i] for i in lanes],
                            f"split edges, {nb} lanes, Tq={Tq}")
            check_paged(ops, ref, egen, erng, nb, Tq, H, KV, hd, C_PAGE, mps,
                        [pedges[i] for i in lanes], f"split edges, {nb} lanes, Tq={Tq}",
                        holes=holes, unmapped=(lanes.index(4),) if 4 in lanes else ())
    # page_counts: the reference's optional per-lane page count
    cgen = torch.Generator(device=DEV).manual_seed(SEED + 5)
    crng = np.random.RandomState(SEED + 5)
    for Tq in (K + 1, 1):
        check_paged_counts(ops, ref, cgen, crng, B, Tq, H, KV, hd, C_PAGE, mps,
                           paged_lens, f"at the main widths, Tq={Tq}")
    # adaptive depth's verify pass (phase 12b): Tq = K_blk + 1 in 2..K at the
    # main widths and post-write lengths, with the split's edge cases as
    # above, from generators of their own so the cases above keep their inputs
    agen = torch.Generator(device=DEV).manual_seed(SEED + 9)
    arng = np.random.RandomState(SEED + 9)
    adapt = {}
    for Tq in range(2, K + 1):
        lens_q = [n - (K + 1) + Tq for n in main_lens]
        plens_q = [n - (K + 1) + Tq for n in paged_lens]
        a_args, _ = check_attention(ops, ref, agen, B, Tq, H, KV, hd, cap, lens_q,
                                    f"adaptive verify pass Tq={Tq}")
        p_args, _ = check_paged(ops, ref, agen, arng, B, Tq, H, KV, hd, C_PAGE, mps, plens_q,
                                f"adaptive verify pass Tq={Tq}")
        adapt[Tq] = (a_args, lens_q, p_args, plens_q)
        for lanes in (list(range(B)), [1, 5], [3, 0], [4, 2]):
            nb = len(lanes)
            sh = ops.attn_share(pedges[5], ops.attn_splits(pcap, nb * KV))
            border = sh // C_PAGE if sh < pedges[5] else 1
            holes = ((lanes.index(5), border - 1), (lanes.index(5), border)) if 5 in lanes else ()
            check_attention(ops, ref, agen, nb, Tq, H, KV, hd, cap, [edges[i] for i in lanes],
                            f"split edges, {nb} lanes, Tq={Tq}")
            check_paged(ops, ref, agen, arng, nb, Tq, H, KV, hd, C_PAGE, mps,
                        [pedges[i] for i in lanes], f"split edges, {nb} lanes, Tq={Tq}",
                        holes=holes, unmapped=(lanes.index(4),) if 4 in lanes else ())
    # chunked prefill's chunk step (phase 13): Tq queries a lane whose
    # Tq * G rows a kv head take 1, 2 and 2 row tiles of 64, each lane's
    # post-write length in [Tq, capacity], from generators of their own so
    # the cases above keep their inputs
    kgen = torch.Generator(device=DEV).manual_seed(SEED + 10)
    krng = np.random.RandomState(SEED + 10)
    chunk_cases = {}
    for Tq, Hc, KVc in CHUNK_ATTN:
        label = f"prefill chunk Tq={Tq} G={Hc // KVc}"
        lens_c = list(krng.randint(Tq, cap + 1, size=B))
        a_args, _ = check_attention(ops, ref, kgen, B, Tq, Hc, KVc, hd, cap, lens_c, label)
        plens_c = list(krng.randint(Tq, mps * C_PAGE + 1, size=B))
        p_args, _ = check_paged(ops, ref, kgen, krng, B, Tq, Hc, KVc, hd, C_PAGE, mps, plens_c,
                                label)
        chunk_cases[f"at_chunk_tq{Tq}" + ("" if Hc == KVc else f"_g{Hc // KVc}")] = (
            a_args, lens_c, p_args, plens_c, KVc)
    # the prefix cache's warm tails (phase 14): a chunk step whose lanes
    # start at a cached offset, on a page border (16 n) or inside a page
    # copied on write (16 n + c)
    check_paged(ops, ref, kgen, krng, B, P_CHUNK, H, KV, hd, C_PAGE, mps,
                [w + P_CHUNK for w in WARM_STARTS], f"prefix-cache warm tails Tq={P_CHUNK}")
    # the baselines and the dense config copies (phase 15), from generators
    # of their own so the cases above keep their inputs: the verify heads of
    # the qwen3 pair (d 1024 and 2048, V 151936) and of qwen2.5-14b (d 5120,
    # V 152064) at a block's 8 lanes and a verify pass's 40 rows,
    # qwen2.5-14b's draft head, and attention at qwen3's G = 2 (a feed's Tq
    # 1, Medusa's verify Tq 4, SpS's Tq 5) and qwen2.5-14b's G = 5 (Tq 1, 5)
    qgen = torch.Generator(device=DEV).manual_seed(SEED + 11)
    qrng = np.random.RandomState(SEED + 11)
    qwen_vocab = {}
    for tag, d_q, V_q in Q_HEADS:
        for T_q in (B, T_verify):
            h_q, w_q, _ = check_verify(ops, ref, qgen, T_q, d_q, V_q, f"{tag} head T={T_q}")
            qwen_vocab[f"at_{tag}_t{T_q}"] = (h_q, w_q, T_q, d_q, V_q)
    q_lora, _ = check_lora(ops, ref, qgen, B, Q_HEADS[-1][1], Q_HEADS[-1][2], cfg.dvi.lora_rank,
                           f"{Q_HEADS[-1][0]} draft head")
    qwen_attn = {}
    for Tq, Hq in Q_ATTN:
        lens_q = list(qrng.randint(64 + Tq, 128 + MAX_NEW + K + 1, size=B))
        a_args, _ = check_attention(ops, ref, qgen, B, Tq, Hq, Q_KV, hd, cap, lens_q,
                                    f"GQA G={Hq // Q_KV} Tq={Tq} (phase 15)")
        qwen_attn[f"at_g{Hq // Q_KV}_tq{Tq}"] = (a_args, lens_q)
    # the hybrid and MoE decoders (phase 16), from generators of their own so
    # the cases above keep their inputs: the ring form at recurrentgemma-9b's
    # local layers (MQA, hd 256, G 16, C 2176: a verify pass's 80 rows take
    # two row tiles) and llama4-scout's (hd 128, G 5, C 8320), lanes short of
    # the ring and wrapped past it, at a draft feed's Tq 1 and a verify pass's
    # K + 1; the verify and draft heads at both vocabularies
    hgen = torch.Generator(device=DEV).manual_seed(SEED + 12)
    hrng = np.random.RandomState(SEED + 12)
    ring_cases, hybrid_vocab = {}, {}
    for tag, hcfg in hybrids:
        W_h = hcfg.local_window
        C_h = W_h + 128
        short = list(hrng.randint(64 + K + 1, 128 + MAX_NEW + K + 1, size=B - 3))
        long_ = list(hrng.randint(C_h + 1, C_h + 300, size=2)) + [C_h - 2]
        for Tq in (K + 1, 1):
            args, _ = check_ring(ops, ref, hgen, B, Tq, hcfg.num_heads, hcfg.num_kv_heads,
                                 hcfg.resolved_head_dim, W_h, short + long_,
                                 f"{tag} Tq={Tq}")
            ring_cases[f"at_ring_{tag}_tq{Tq}"] = args
        check_ring(ops, ref, hgen, 2, K + 1, hcfg.num_heads, hcfg.num_kv_heads,
                   hcfg.resolved_head_dim, W_h, [K + 1, C_h + 1], f"{tag} edges", stale=0)
        for T_h in (B, T_verify):
            h_h, w_h, _ = check_verify(ops, ref, hgen, T_h, hcfg.d_model, hcfg.vocab_size,
                                       f"{tag} head T={T_h}")
            hybrid_vocab[f"at_{tag}_t{T_h}"] = (h_h, w_h, T_h, hcfg.d_model, hcfg.vocab_size)
        l_h, _ = check_lora(ops, ref, hgen, B, hcfg.d_model, hcfg.vocab_size,
                            hcfg.dvi.lora_rank, f"{tag} draft head")
        hybrid_vocab[f"lora_{tag}"] = l_h
    # deepseek-v3's verify and draft heads (phase 17: d 7168, V 129280), from
    # a generator of their own
    dgen = torch.Generator(device=DEV).manual_seed(SEED + 13)
    for T_h in (B, T_verify):
        h_h, w_h, _ = check_verify(ops, ref, dgen, T_h, ds.d_model, ds.vocab_size,
                                   f"ds head T={T_h}")
        hybrid_vocab[f"at_ds_t{T_h}"] = (h_h, w_h, T_h, ds.d_model, ds.vocab_size)
    hybrid_vocab["lora_ds"], _ = check_lora(ops, ref, dgen, B, ds.d_model, ds.vocab_size,
                                            ds.dvi.lora_rank, "ds draft head")
    # whisper-large-v3 and paligemma-3b (phase 18), from generators of their
    # own: self-attention at whisper's MHA of 20 heads of 64 and paligemma's
    # MQA of 8 heads of 256 (at Tq 1 and K + 1, lengths of phase 18's
    # prompts padded to B_TP; paligemma's 256 patches ahead of them, in a
    # cache of AUX_CAP + 256 slots), the non-causal form over whisper's 1500
    # encoder frames, and both heads at a block's 8 lanes and a verify
    # pass's 40 rows (whisper's V 51866 rows are not 16-byte multiples: the
    # element loader)
    agen18 = torch.Generator(device=DEV).manual_seed(SEED + 14)
    arng18 = np.random.RandomState(SEED + 14)
    aux_attn, aux_vocab = {}, {}
    P = pcfg.vision.num_patches
    for tag, acfg, pre in (("whisper", wcfg, 0), ("pg", pcfg, P)):
        lens18 = list(pre + arng18.randint(B_TP + K + 1, B_TP + MAX_NEW + K + 1, size=B))
        for Tq in (K + 1, 1):
            lens_q = [n - (K + 1) + Tq for n in lens18]
            a_args, _ = check_attention(ops, ref, agen18, B, Tq, acfg.num_heads,
                                        acfg.num_kv_heads, acfg.resolved_head_dim, AUX_CAP + pre,
                                        lens_q, f"{tag} Tq={Tq} (phase 18)")
            aux_attn[f"at_{tag}_tq{Tq}"] = (a_args, lens_q, AUX_CAP + pre, acfg.num_kv_heads,
                                            acfg.resolved_head_dim)
        loader = "fast" if acfg.vocab_size * 2 % 16 == 0 else "element"
        for T_h in (B, T_verify):
            h_h, w_h, _ = check_verify(ops, ref, agen18, T_h, acfg.d_model, acfg.vocab_size,
                                       f"{tag} head T={T_h}", loader=loader)
            aux_vocab[f"at_{tag}_t{T_h}"] = (h_h, w_h, T_h, acfg.d_model, acfg.vocab_size, loader)
        l_h, _ = check_lora(ops, ref, agen18, B, acfg.d_model, acfg.vocab_size,
                            acfg.dvi.lora_rank, f"{tag} draft head", loader=loader)
        aux_vocab[f"lora_{tag}"] = (l_h, acfg, loader)
    F = wcfg.encoder.num_frames
    cross_cases = {}
    for Tq in (K + 1, 1):
        cross_cases[f"at_cross_tq{Tq}"], _ = check_cross(ops, ref, agen18, B, Tq, wcfg.num_heads,
                                                         wcfg.resolved_head_dim, F,
                                                         f"whisper Tq={Tq} (phase 18)")
    # the int8 KV cache (phase 19), from generators of their own: the causal
    # form at vicuna's verify pass and draft feed (phase 4's shape), the ring
    # form at recurrentgemma's local layers (MQA hd 256, G 16, C 2176, lanes
    # short of the ring and wrapped past it, stale writes), the paged form at
    # phase 8's pool (pages of 16) with and without page counts; slot 0 of
    # lane (or page) 0 all zeros
    igen = torch.Generator(device=DEV).manual_seed(SEED + 19)
    irng = np.random.RandomState(SEED + 19)
    int8_cases = {}
    for Tq, lens_q in ((K + 1, main_lens), (1, feed_lens)):
        int8_cases[f"at_int8_tq{Tq}"] = int8_causal_case(ops, ref, igen, B, Tq, H, KV, hd, cap,
                                                         lens_q, f"causal Tq={Tq} (vicuna)")
    rcfg = hybrids[0][1]
    W_r, C_r = rcfg.local_window, rcfg.local_window + 128
    r_lens = list(irng.randint(64 + K + 1, 128 + MAX_NEW + K + 1, size=B - 3)) + list(
        irng.randint(C_r + 1, C_r + 300, size=2)) + [C_r - 2]
    for Tq in (K + 1, 1):
        q_i = torch.randn((B, Tq, rcfg.num_heads, rcfg.resolved_head_dim), generator=igen,
                          device=DEV).to(torch.bfloat16)
        q_i = q_i[:, 0].contiguous() if Tq == 1 else q_i
        shape = (B, C_r, rcfg.num_kv_heads, rcfg.resolved_head_dim)
        (k_i, ks_i), (v_i, vs_i) = int8_kv(igen, shape), int8_kv(igen, shape)
        lens_t = torch.as_tensor(np.asarray(r_lens), dtype=torch.int32, device=DEV)
        pos_i = torch.as_tensor(np.stack([ring_pos(int(n), C_r, 3) for n in r_lens]), device=DEV)
        visible = ring_visible(pos_i, lens_t, Tq, W_r).any(dim=2).cpu().numpy()
        err = check_int8(ops, ref, "decode_attention", f"ring Tq={Tq} (recurrentgemma, "
                         f"{sum(int(n) > C_r for n in r_lens)} lanes wrapped)", q_i, k_i, v_i,
                         ks_i, vs_i, (lens_t,), dict(pos=pos_i, window=W_r), visible)
        int8_cases[f"at_int8_ring_rg_tq{Tq}"] = ("ring", (q_i, k_i, v_i, lens_t, pos_i, W_r), ks_i,
                                                 vs_i, r_lens, err)
    int8_paged = {}
    for Tq, lens_q in ((K + 1, paged_lens), (1, paged_feed_lens)):
        case = int8_paged_case(ops, ref, igen, irng, B, Tq, H, KV, hd, mps, lens_q,
                               f"Tq={Tq} (phase 8's pool)", holes=((1, 2),))
        q_i, k_i, v_i, lens_t, tbl_t, _ = case[1]
        need = [-(-int(n) // C_PAGE) for n in lens_q]
        pc = torch.as_tensor(np.asarray([(max(1, need[b] // 2), 0, mps + 3, need[b])[b % 4]
                                         for b in range(B)], np.int32), device=DEV)
        check_int8(ops, ref, "paged_decode_attention", f"Tq={Tq} with page_counts", q_i, k_i, v_i,
                   case[2], case[3], (lens_t, tbl_t), dict(page_counts=pc),
                   np.ones((B, Tq), bool))
        int8_paged[f"at_int8_tq{Tq}"] = case
    # chunked prefill's and the prefix cache's chunk steps over int8 (19a)
    int8_chunk, int8_chunk_paged = int8_chunk_cases(ops, ref, B, H, KV, hd, cap, mps)
    # the mamba2 paths: the tied vocab (not a multiple of 64 columns) and the
    # scan at the prefill shapes of both schedulers
    md, mV, mK = mcfg.d_model, mcfg.vocab_size, mcfg.dvi.k_spec
    mh, mw, _ = check_verify(ops, ref, gen, B * (mK + 1), md, mV, f"{M_NAME} (V={mV})")
    m_lora, _ = check_lora(ops, ref, gen, B, md, mV, mcfg.dvi.lora_rank, f"{M_NAME} (V={mV})")
    mH, mhd, mds = (mcfg.ssm.expand * md) // mcfg.ssm.head_dim, mcfg.ssm.head_dim, mcfg.ssm.d_state
    ssd_args, err_s = check_ssd(ops, ref, gen, B, 127, 127, mH, mhd, mds,
                                "sync prefill (bucket 128)")
    ssd_one, _ = check_ssd(ops, ref, gen, 1, 95, 95, mH, mhd, mds,
                           "continuous admission (96 tokens)")
    check_ssd(ops, ref, gen, 2, 256, 128, mH, mhd, mds, "padded long prompt", pad_rows=56)
    check_ssd(ops, ref, gen, 2, 64, 64, mH, mhd, mds, "carried h0", with_h0=True)
    check_ssd(ops, ref, gen, 1, 63, 63, mH, mhd, mds, "continuous admission (64 tokens)")
    # chunked prefill's first-chunk admission (phase 13c): B 1 x P_CHUNK
    ssd_chunk, _ = check_ssd(ops, ref, gen, 1, P_CHUNK, P_CHUNK, mH, mhd, mds,
                             f"chunked admission ({P_CHUNK} tokens)")
    # the training path (phase 11), each from a generator of its own: the
    # scan with its gradient at mamba2 pretraining's shape, and lora_logits
    # at the vicuna DVI step's 8184 rows (128 row passes)
    ssd_train, _, ssd_grad_err, ssd_backward = check_ssd_grad(
        ops, ref, torch.Generator(device=DEV).manual_seed(SEED + 7), P_B, P_T,
        mcfg.ssm.chunk_size, mH, mhd, mds)
    dvi_args, dvi_err, dvi_grad_err = check_lora_update(
        ops, ref, torch.Generator(device=DEV).manual_seed(SEED + 8), D_ROWS, d, V,
        cfg.dvi.lora_rank, cfg.dvi.lora_alpha / cfg.dvi.lora_rank, label="the DVI step")

    def verify_bound(T, d, V):
        return bound(T * d * e + d * V * e + T * 8, 2 * T * d * V / BF16_FLOP_PER_S)

    def lora_bound(T, d, V, r):
        return bound(T * d * e + d * V * e + d * r * 4 + r * V * 4 + T * V * 4,
                     2 * T * d * V / BF16_FLOP_PER_S
                     + (2 * T * d * r + 2 * T * r * V) / F32_FLOP_PER_S)

    def gemm(h, w) -> dict:
        """cuBLAS's bf16 product h @ w alone, a yardstick for the vocab
        kernels: it computes the logits without the argmax or the LoRA
        term, and writes them; the port never calls it."""
        ms, call_ms = time_ms(lambda: torch.matmul(h, w))
        return dict(gemm_ms=ms, gemm_call_ms=call_ms)

    sdpa = torch.nn.functional.scaled_dot_product_attention

    def attn_timing(args, lengths, kv=KV, cap=cap, hd=hd):
        q, k, v, lens = args
        sq, sk, sv, smask = sdpa_inputs(q if q.ndim == 4 else q[:, None], k, v, lens)
        return timing(lambda: ops.decode_attention(q, k, v, lens),
                      lambda: ref.decode_attention(q, k, v, lens),
                      attn_bound(q, lengths, cap, kv, hd),
                      library=lambda: sdpa(sq, sk, sv, attn_mask=smask))

    def cross_timing(args):
        q, k, v, lens = args
        sq, sk, sv = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        return timing(lambda: ops.decode_attention(q, k, v, lens, causal=False),
                      lambda: ref.decode_attention(q, k, v, lens, causal=False),
                      cross_bound(args), library=lambda: sdpa(sq, sk, sv))

    def ring_timing(args):
        q, k, v, lens, pos, W = args
        sq, sk, sv, smask = ring_sdpa_inputs(args)
        return timing(lambda: ops.decode_attention(q, k, v, lens, pos=pos, window=W),
                      lambda: ref.decode_attention(q, k, v, lens, pos=pos, window=W),
                      ring_bound(args), library=lambda: sdpa(sq, sk, sv, attn_mask=smask))

    def paged_timing(args, lengths, kv=KV):
        q, kp, vp, lens, tbl_t, tbl = args
        sq, sk, sv, smask = paged_sdpa_inputs(q, kp, vp, lens, tbl_t)
        return timing(lambda: ops.paged_decode_attention(q, kp, vp, lens, tbl_t),
                      lambda: ref.paged_decode_attention(q, kp, vp, lens, tbl_t),
                      paged_bound(q, tbl, lengths, C_PAGE, kv, hd),
                      library=lambda: sdpa(sq, sk, sv, attn_mask=smask))

    # the int8 forms: bound at hd + 4 bytes a slot and kv head for K (and V);
    # SDPA over the dequantised bf16 view (the dequantise not timed)
    def int8_timing(case):
        form, args, ks, vs, lengths, err = case
        q, k, v, lens = args[:4]
        kd, vd = int8_dequantized(k, ks, v, vs)
        hd_i, kv_i = k.shape[3], k.shape[2]
        if form == "paged":
            tbl_t, tbl = args[4], args[5]
            sq, sk, sv, smask = paged_sdpa_inputs(q, kd, vd, lens, tbl_t)
            return dict(timing(lambda: ops.paged_decode_attention(q, k, v, lens, tbl_t,
                                                                  k_scale=ks, v_scale=vs),
                               lambda: ref.paged_decode_attention(q, k, v, lens, tbl_t,
                                                                  k_scale=ks, v_scale=vs),
                               paged_bound(q, tbl, lengths, C_PAGE, kv_i, hd_i, hd_i + 4),
                               library=lambda: sdpa(sq, sk, sv, attn_mask=smask)),
                        max_abs_err=err)
        if form == "ring":
            pos, W = args[4], args[5]
            sq, sk, sv, smask = ring_sdpa_inputs((q, kd, vd, lens, pos, W))
            return dict(timing(lambda: ops.decode_attention(q, k, v, lens, pos=pos, window=W,
                                                            k_scale=ks, v_scale=vs),
                               lambda: ref.decode_attention(q, k, v, lens, pos=pos, window=W,
                                                            k_scale=ks, v_scale=vs),
                               ring_bound(args, hd_i + 4),
                               library=lambda: sdpa(sq, sk, sv, attn_mask=smask)),
                        max_abs_err=err)
        sq, sk, sv, smask = sdpa_inputs(q if q.ndim == 4 else q[:, None], kd, vd, lens)
        return dict(timing(lambda: ops.decode_attention(q, k, v, lens, k_scale=ks, v_scale=vs),
                           lambda: ref.decode_attention(q, k, v, lens, k_scale=ks, v_scale=vs),
                           attn_bound(q, lengths, k.shape[1], kv_i, hd_i, hd_i + 4),
                           library=lambda: sdpa(sq, sk, sv, attn_mask=smask)),
                    max_abs_err=err)

    def ssd_timing(args):
        xh, Bc, Cc, dt, A, Q, h0 = args
        b = ssd_bound(xh, Bc, dt, Q, h0)
        return dict(timing(lambda: ops.ssd_scan(xh, Bc, Cc, dt, A, Q, h0=h0),
                           lambda: ref.ssd_scan(xh, Bc, Cc, dt, A, Q, h0=h0), b["bound"]),
                    f32_core_bound_ms=b["f32_core_bound_ms"])

    def backward_timing(backward) -> dict:
        """The scan's backward alone (plain PyTorch: no kernel of the port)."""
        ms, call_ms = time_ms(backward, iters=10)
        return dict(backward_ms=ms, backward_call_ms=call_ms,
                    backward_note="ops.SsdScan.backward: the plain version's recompute in "
                                  "float32 differentiated by autograd; no backward kernel")

    # what the timer shows for a kernel that does nothing: the launch and
    # the two events around it
    floor_ms, _ = time_ms(lambda: torch.cuda._sleep(1))
    phase(3, f"timer floor: an empty kernel between the events takes {floor_ms:.4f} ms")
    hl, wl, a, b, gamma = lora_args
    rows = [
        dict(name="verify_argmax", route="cuda", source="src/repro_torch/csrc/verify_argmax.cu",
             replaces="src/repro/kernels/verify_argmax.py:62", max_abs_err=err_v,
             **timing(lambda: ops.verify_argmax(h, w), lambda: ref.verify_argmax(h, w),
                      verify_bound(T_verify, d, V)), **gemm(h, w),
             at_mamba2=dict(timing(lambda: ops.verify_argmax(mh, mw),
                                   lambda: ref.verify_argmax(mh, mw),
                                   verify_bound(mh.shape[0], md, mV)), **gemm(mh, mw)),
             # the baselines' and qwen2.5-14b's verify heads (phase 15)
             **{key: dict(timing(lambda h=h, w=w: ops.verify_argmax(h, w),
                                 lambda h=h, w=w: ref.verify_argmax(h, w),
                                 verify_bound(T_q, d_q, V_q)), **gemm(h, w))
                for key, (h, w, T_q, d_q, V_q) in qwen_vocab.items()},
             # recurrentgemma-9b's and llama4-scout's verify heads (phase 16)
             # and deepseek-v3's (phase 17)
             **{key: dict(timing(lambda h=h, w=w: ops.verify_argmax(h, w),
                                 lambda h=h, w=w: ref.verify_argmax(h, w),
                                 verify_bound(T_q, d_q, V_q)), **gemm(h, w))
                for key, (h, w, T_q, d_q, V_q) in hybrid_vocab.items() if key.startswith("at_")},
             # whisper-large-v3's and paligemma-3b's verify heads (phase 18),
             # with the loader each takes
             **{key: dict(timing(lambda h=c[0], w=c[1]: ops.verify_argmax(h, w),
                                 lambda h=c[0], w=c[1]: ref.verify_argmax(h, w),
                                 verify_bound(*c[2:5])), **gemm(c[0], c[1]), loader=c[5])
                for key, c in aux_vocab.items() if key.startswith("at_")},
             gemm_note=GEMM_NOTE),
        dict(name="lora_logits", route="cuda", source="src/repro_torch/csrc/lora_logits.cu",
             replaces="src/repro/kernels/lora_logits.py:53", max_abs_err=err_l,
             **timing(lambda: ops.lora_logits(hl, wl, a, b, gamma),
                      lambda: ref.lora_logits(hl, wl, a, b, gamma),
                      lora_bound(B, d, V, a.shape[1])), **gemm(hl, wl),
             at_mamba2=dict(timing(lambda: ops.lora_logits(*m_lora),
                                   lambda: ref.lora_logits(*m_lora),
                                   lora_bound(B, md, mV, m_lora[2].shape[1])),
                            **gemm(m_lora[0], m_lora[1])),
             # the online update's forward (twice an update): T = 256 rows
             at_update=dict(timing(lambda: ops.lora_logits(*upd_args),
                                   lambda: ref.lora_logits(*upd_args),
                                   lora_bound(cfg.dvi.batch_size, d, V, cfg.dvi.lora_rank)),
                            **gemm(upd_args[0], upd_args[1]), max_abs_err=upd_err,
                            grad_max_abs_err=upd_grad_err,
                            row_passes=-(-cfg.dvi.batch_size // VOCAB_PASS_ROWS)),
             # the teacher-forced DVI step's draft head (phase 11b): 8184 rows
             at_dvi_step=dict(timing(lambda: ops.lora_logits(*dvi_args),
                                     lambda: ref.lora_logits(*dvi_args),
                                     lora_bound(D_ROWS, d, V, cfg.dvi.lora_rank)),
                              **gemm(dvi_args[0], dvi_args[1]), max_abs_err=dvi_err,
                              grad_max_abs_err=dvi_grad_err,
                              row_passes=-(-D_ROWS // VOCAB_PASS_ROWS)),
             # qwen2.5-14b's draft head (phase 15d)
             at_qwen25_14b=dict(timing(lambda: ops.lora_logits(*q_lora),
                                       lambda: ref.lora_logits(*q_lora),
                                       lora_bound(B, Q_HEADS[-1][1], Q_HEADS[-1][2],
                                                  cfg.dvi.lora_rank)),
                                **gemm(q_lora[0], q_lora[1])),
             # recurrentgemma-9b's and llama4-scout's draft heads (phase 16)
             # and deepseek-v3's (phase 17)
             **{f"at_{tag}": dict(timing(lambda a=hybrid_vocab[f"lora_{tag}"]:
                                         ops.lora_logits(*a),
                                         lambda a=hybrid_vocab[f"lora_{tag}"]:
                                         ref.lora_logits(*a),
                                         lora_bound(B, hc.d_model, hc.vocab_size,
                                                    hc.dvi.lora_rank)),
                                  **gemm(*hybrid_vocab[f"lora_{tag}"][:2]))
                for tag, hc in hybrids + (("ds", ds),)},
             # whisper-large-v3's and paligemma-3b's draft heads (phase 18)
             **{f"at_{tag}": dict(timing(lambda a=aux_vocab[f"lora_{tag}"][0]:
                                         ops.lora_logits(*a),
                                         lambda a=aux_vocab[f"lora_{tag}"][0]:
                                         ref.lora_logits(*a),
                                         lora_bound(B, ac.d_model, ac.vocab_size,
                                                    ac.dvi.lora_rank)),
                                  **gemm(*aux_vocab[f"lora_{tag}"][0][:2]),
                                  loader=aux_vocab[f"lora_{tag}"][2])
                for tag, ac in (("whisper", wcfg), ("pg", pcfg))},
             gemm_note=GEMM_NOTE),
        # attention at the verify pass (Tq = K+1), with the draft feed
        # (Tq = 1) beside it: 30 and 10 of the 40 launches of a block
        dict(name="decode_attention", route="cuda",
             source="src/repro_torch/csrc/decode_attention.cu",
             replaces="src/repro/kernels/decode_attention.py:83", max_abs_err=err_a,
             **attn_timing(att_args, main_lens),
             at_draft_feed=attn_timing(feed_args, feed_lens),
             # adaptive depth's verify pass (phase 12b) at K_blk = 1 and 2
             at_verify_tq2=attn_timing(adapt[2][0], adapt[2][1]),
             at_verify_tq3=attn_timing(adapt[3][0], adapt[3][1]),
             # chunked prefill's chunk step (phase 13), one launch a layer
             **{key: attn_timing(c[0], c[1], kv=c[4]) for key, c in chunk_cases.items()},
             # the qwen GQA groups of phase 15
             **{key: attn_timing(c[0], c[1], kv=Q_KV) for key, c in qwen_attn.items()},
             # the ring form at the local layers of phase 16
             **{key: ring_timing(args) for key, args in ring_cases.items()},
             # whisper's and paligemma's self-attention and whisper's
             # cross-attention, the non-causal form (phase 18)
             **{key: attn_timing(c[0], c[1], kv=c[3], cap=c[2], hd=c[4])
                for key, c in aux_attn.items()},
             **{key: cross_timing(args) for key, args in cross_cases.items()},
             # the int8 KV cache (phase 19): the causal form at vicuna's
             # widths and the ring form at recurrentgemma's
             **{key: int8_timing(case) for key, case in int8_cases.items()},
             # and at the chunk step over int8 (phase 19a)
             **{key: int8_timing(case) for key, case in int8_chunk.items()},
             library_note="SDPA with a bool mask; over the int8 cache's dequantised bf16 "
                          "view, the dequantise not timed"),
        dict(name="paged_decode_attention", route="cuda",
             source="src/repro_torch/csrc/paged_decode_attention.cu",
             replaces="src/repro/kernels/paged_decode_attention.py:127", max_abs_err=err_p,
             **paged_timing(paged_args, paged_lens),
             at_draft_feed=paged_timing(paged_feed_args, paged_feed_lens),
             at_verify_tq2=paged_timing(adapt[2][2], adapt[2][3]),
             at_verify_tq3=paged_timing(adapt[3][2], adapt[3][3]),
             **{key: paged_timing(c[2], c[3], kv=c[4]) for key, c in chunk_cases.items()},
             # the int8 KV cache's pool (phase 19)
             **{key: int8_timing(case) for key, case in int8_paged.items()},
             **{key: int8_timing(case) for key, case in int8_chunk_paged.items()},
             library_note="SDPA over the pre-gathered contiguous view; gather not timed (for "
                          "int8 pages: over their dequantised bf16 view, not timed either)"),
        # the scan at the sync path's prefill, with a B = 1 admission of the
        # continuous path and a first-chunk admission of the chunked one
        # beside it; no single PyTorch call scans
        dict(name="ssd_scan", route="cuda", source="src/repro_torch/csrc/ssd_scan.cu",
             replaces="src/repro/kernels/ssd_scan.py:80", max_abs_err=err_s,
             **ssd_timing(ssd_args), at_admission=ssd_timing(ssd_one),
             at_chunk_admission=ssd_timing(ssd_chunk),
             # mamba2 pretraining (phase 11a): the forward is the kernel, the
             # backward the plain version's recompute differentiated by
             # autograd (ops.SsdScan; the reference has no backward kernel)
             at_training=dict(ssd_timing(ssd_train), grad_max_abs_err=ssd_grad_err,
                              **backward_timing(ssd_backward))),
    ]
    for row in rows:
        for label, t in [("main", row)] + [(k, v) for k, v in row.items()
                                          if k.startswith("at_")]:
            lib = ("-" if t["library_ms"] is None else
                   f"{t['library_ms']:.4f} (call {t['library_call_ms']:.4f})")
            gm = ("" if "gemm_ms" not in t else
                  f", cuBLAS h@w alone {t['gemm_ms']:.4f} (call {t['gemm_call_ms']:.4f})")
            if "f32_core_bound_ms" in t:
                gm += (f", f32_core_bound {t['f32_core_bound_ms']:.4f} (computed: every "
                       f"product on the float32 CUDA cores)")
            if "backward_ms" in t:
                gm += (f", backward (plain PyTorch, no kernel) {t['backward_ms']:.4f} (call "
                       f"{t['backward_call_ms']:.4f})")
            phase(3, f"{row['name']} {label}: kernel {t['ms']:.4f} ms (call "
                     f"{t['call_ms']:.4f}), plain {t['plain_ms']:.4f} (call "
                     f"{t['plain_call_ms']:.4f}), library {lib}{gm}, bound "
                     f"{t['bound_ms']:.4f} ({t['bound_by']}), bound/kernel "
                     f"{t['bound_share']:.3f}")
    return rows


# ---------------------------------------------------------------------------
# phases 4-6: the main path
# ---------------------------------------------------------------------------

def make_requests(cfg):
    from repro_torch.serving.engine import Request
    rng = np.random.RandomState(SEED + 1)
    return [Request(uid=i, prompt=rng.randint(2, cfg.vocab_size,
                                              size=int(rng.randint(64, 129))).astype(np.int32),
                    max_new=MAX_NEW) for i in range(N_REQUESTS)]


# the port's kernels in a profile, by the names of their __global__ functions
PORT_KERNELS = ("verify_partial", "verify_reduce", "lora_down", "lora_main", "decode_attn",
                "ssd_chunks")
# each kernel's __global__ functions in a profile, and the one of them that
# runs once a call (the vocab kernels launch two: a pre-pass or a reduction)
KERNEL_NAMES = {
    "decode_attention": (re.compile(r"(?<![A-Za-z_])decode_attn\b"),) * 2,
    "paged_decode_attention": (re.compile(r"(?<![A-Za-z_])paged_decode_attn\b"),) * 2,
    "verify_argmax": (re.compile(r"\bverify_(partial|reduce)\b"),
                      re.compile(r"\bverify_partial\b")),
    "lora_logits": (re.compile(r"\blora_(down|main)\b"), re.compile(r"\blora_main\b")),
    "ssd_scan": (re.compile(r"\bssd_chunks\b"),) * 2,
}


# the __global__ function each kernel launches once a call, as its mangled
# name spells it (length, then the name)
ONCE = {"decode_attention": "decode_attn", "paged_decode_attention": "paged_decode_attn",
        "verify_argmax": "verify_partial", "lora_logits": "lora_main", "ssd_scan": "ssd_chunks"}


def check_census(n: int, label: str, g: dict) -> None:
    """Each captured graph holds, by libcuda's count of its kernel
    nodes, as many launches of each port kernel as its capture recorded:
    the launches each of its replays adds to ``ops.launches``."""
    for recorded, kernel_nodes in g["per_graph"]:
        nodes = {kernel: sum(c for name, c in kernel_nodes.items() if f"{len(fn)}{fn}" in name)
                 for kernel, fn in ONCE.items()}
        phase(n, f"{label}: a graph of {sum(kernel_nodes.values())} kernel nodes holds "
                 f"{nodes} of the port's kernels; its capture recorded {recorded}")
        check(nodes == recorded, f"{label}: a graph's kernel nodes {nodes} disagree with the "
                                 f"launches its capture recorded {recorded}")


def covered_ms(spans) -> float:
    """The time (ms) that a set of (start, end) spans in us covers, each
    instant once: kernels that overlap on the card (a programmatic
    dependent launch beside its primary) are not counted twice."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def device_events(prof) -> list:
    """(name, start us, end us) of each device activity of a finished
    torch.profiler run, read from its Kineto records: the profiler's own
    FunctionEvents (``prof.events()``) take tens of microseconds an event
    to build on the host, minutes for a mamba2 path's million launches."""
    evs = [(e.name(), e.start_ns(), e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == torch.autograd.DeviceType.CUDA]
    base = min((t for _, t, _ in evs), default=0)
    return [(name, (t - base) / 1e3, (t - base + d) / 1e3) for name, t, d in evs]


def profile_batch(eng, reqs, wall_ms: float, n: int = 4, expect: dict = None,
                  per_call: dict = None) -> dict:
    """The same requests once more under torch.profiler (device activity
    only), the window opened and closed by one primed replay of each of the
    engine's graphs (``runner.prime``: the profiler loses records of a
    graph's first replays in a window and of its last one's tail): device
    time by kernel and in all, the latter as the time some kernel ran
    (``covered_ms``).  The run repeats the timed run's work, so the
    device's busy share is its device time over the timed run's
    (unprofiled) wall time `wall_ms`; the window's device time is taken
    over its block-steps and primed replays alike.  `expect` maps a
    kernel's name to the per-launch device ms that phase 3 predicts for
    this path; the profile's per-launch and per-block-step times are
    printed beside it, with each of its __global__ functions' share, and
    its launches must equal what ``ops.launches`` counted over the window
    (under graph replay: the launches each capture recorded, once a replay
    or a primed replay), less at most 10 % of the run's own launches lost
    to dropped records; `per_call` maps a kernel to its launches in one
    call of the path (``ssd_scan``: one per layer in a prefill call), whose
    time is printed too.  Returns the busy share, device ms and device
    launches per block-step."""
    runner = eng._ensure_runner()
    for r in reqs:
        eng.submit_request(r)
    torch.cuda.synchronize()

    def run() -> int:
        steps0 = eng.stats["steps"]
        eng.run()
        return eng.stats["steps"] - steps0
    return profile_run(run, runner.prime, wall_ms, n, expect, per_call)


def profile_run(run, prime, wall_ms: float, n: int, expect: dict = None,
                per_call: dict = None) -> dict:
    """``profile_batch``'s window and gates around `run()` (the work again,
    returning its block-steps), opened and closed by `prime()` (one primed
    replay of each graph, returning the replays)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    ops.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        primes = prime()
        primed = dict(ops.launches)
        ran_steps = run()
        ran = {name: k - primed[name] for name, k in ops.launches.items()}
        primes += prime()
        torch.cuda.synchronize()
    counted = dict(ops.launches)
    events = device_events(prof)
    by_name: dict = {}
    spans: dict = {}                   # name -> [(start us, end us)]
    for name, t0, t1 in events:
        ms, k = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (t1 - t0) / 1e3, k + 1)
        spans.setdefault(name, []).append((t0, t1))
    busy = covered_ms([s for v in spans.values() for s in v])
    check(busy > 0.0, "profile: the profiler saw no device time")
    ours = covered_ms([s for name, v in spans.items() if any(k in name for k in PORT_KERNELS)
                       for s in v])
    gemm = covered_ms([s for name, v in spans.items()
                       if any(k in name.lower() for k in ("gemm", "nvjet", "xmma", "cutlass"))
                       for s in v])
    steps = ran_steps + primes         # each primed replay does a block-step's work
    launches = sum(k for _, k in by_name.values())
    phase(n, f"profile of the same requests again ({ran_steps} block-steps, {primes} primed "
             f"replays): device busy {busy:.1f} ms, {busy / steps:.3f} ms a block-step = "
             f"{100 * busy * ran_steps / steps / wall_ms:.1f}% of the timed run's wall "
             f"{wall_ms:.1f} ms; port kernels {ours:.1f} ms, GEMMs {gemm:.1f} ms, other "
             f"{busy - ours - gemm:.1f} ms; {launches} device launches "
             f"({launches / max(steps, 1):.0f} per block-step)")
    for name, (ms, k) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        phase(n, f"  {ms:9.3f} ms {k:6d}x  {name[:90]}")
    seen = {}
    for kernel, want in (expect or {}).items():
        every, once = KERNEL_NAMES[kernel]
        hits = {name: v for name, v in by_name.items() if every.search(name)}
        ms = covered_ms([s for name in hits for s in spans[name]])
        k = sum(v[1] for name, v in hits.items() if once.search(name))
        per = ms / k if k else float("nan")
        parts = "; ".join(f"{every.search(name).group(0)} {v[0] / max(v[1], 1) * 1e3:.2f} us "
                          f"a launch" for name, v in sorted(hits.items()))
        phase(n, f"  {kernel}: {k} launches, {ms:.3f} ms, {per * 1e3:.2f} us a launch on the "
                 f"path ({parts}); phase 3 device time at this path's mix {want * 1e3:.2f} us "
                 f"(profile / phase 3 = {per / want:.2f}), "
                 f"{ms / max(steps, 1):.3f} ms per block-step"
                 + (f", {per * per_call[kernel]:.3f} ms per call of {per_call[kernel]} "
                    f"launches" if kernel in (per_call or {}) else ""))
        seen[kernel] = k
    # the profiler once lost 13 % of a run's records (337 of 2560
    # paged_decode_attention launches), a graph's first replays in the
    # window and the tail of its last one (scripts/torch_profile_records.py);
    # it must see the window's launches less at most 10 % of the run's own,
    # and never more than were launched
    missed = {name: counted[name] - k for name, k in seen.items()}
    phase(n, f"  launches the profiler saw {seen}, ops.launches counted "
             f"{ {name: counted[name] for name in seen} } (the run's {ran} and the primed "
             f"replays'): records missed {missed}")
    check(all(0 <= m <= ran[name] // 10 for name, m in missed.items()),
          f"the profiler's launch counts {seen} disagree with ops.launches {counted}")
    return dict(busy=busy * ran_steps / steps / wall_ms, device_ms=busy / steps,
                launches=launches / steps)


def check_fast_loader(ops, n: int, label: str) -> None:
    """Every vocab launch since the last reset took the fast loader."""
    paths = {name: dict(v) for name, v in ops.vocab_paths.items()}
    phase(n, f"{label}: vocab kernel launches by loader {paths}")
    check(all(v["element"] == 0 and v["fast"] == ops.launches[name]
              for name, v in paths.items()),
          f"{label}: a vocab kernel on the path left the fast loader")


def path_attention_ms(row, K: int, k: int, L: int) -> float:
    """Phase 3's device ms of one attention launch at a vicuna path's mix:
    per block (K+1) * k draft-feed launches (Tq = 1) and L - k verify
    launches (Tq = K+1)."""
    n_feed, n_verify = (K + 1) * k, L - k
    return (n_feed * row["at_draft_feed"]["ms"] + n_verify * row["ms"]) / (n_feed + n_verify)


def top2_gap(model, params, prefix: torch.Tensor, n_prompt: int = 0, max_new: int = 0,
             aux_inputs=None) -> tuple:
    """The AR verifier's top-2 logits for the token after `prefix` (1, p),
    with the lane's modality stubs `aux_inputs` (batch 1) if any.
    With `n_prompt`, as ar_generate of `max_new` tokens computed them: the
    prompt (the first n_prompt tokens) prefilled alone into a cache of
    ar_generate's capacity, then one-token steps over its last token and
    the generated ones.  An MoE stack needs this: a one-shot prefill of
    the whole prefix is another function there, since the full path's
    capacity drops depend on the token count."""
    if not n_prompt:
        h, _ = model.prefill(params, prefix, aux_inputs)
    else:
        from repro_torch.models import transformer as tfm
        _, cache = model.prefill(params, prefix[:, :n_prompt - 1],
                                 max_len=n_prompt + max_new + 2 + tfm.RING_SLACK)
        one = torch.ones((1,), dtype=torch.int32, device=prefix.device)
        for j in range(n_prompt - 1, prefix.shape[1]):
            h, cache, cands = model.step(params, model.embed_block(params, prefix[:, j:j + 1]),
                                         cache)
            cache = model.commit(cache, cands, one)
    top = model.logits(params, h[:, -1]).float().topk(2, dim=-1).values[0]
    return float(top[0]), float(top[1])


# ---------------------------------------------------------------------------
# phase 8: the continuous path over a paged pool
# ---------------------------------------------------------------------------

def continuous_requests(cfg):
    from repro_torch.serving.engine import Request
    rng = np.random.RandomState(SEED + 2)
    return [Request(uid=i, prompt=rng.randint(2, cfg.vocab_size,
                                              size=int(rng.choice(C_PROMPTS))).astype(np.int32),
                    max_new=int(rng.choice(C_NEW))) for i in range(C_REQUESTS)]


def serve_checked(eng, reqs, log=None):
    """Serve `reqs` submitted at once.  Every superstep dispatch, every
    drafter update a learning engine dispatches and, with chunked prefill,
    every chunk step (``_advance_prefill``) runs under sync debug mode
    "error" (a synchronising operation inside it raises); the rest of each
    tick runs under "warn", and its synchronising operations are counted
    per tick.  With `log` (a list), each tick appends the block-steps,
    accepted and drafted tokens its harvest counted and the host seconds of
    the updates it dispatched.  Returns (completions, wall s, blocks the
    supersteps ran, syncs per tick)."""
    import warnings
    inner, inner_update = eng._dispatch_superstep, eng._dispatch_update
    iters, update_s = [], []

    def dispatch():
        torch.cuda.set_sync_debug_mode("error")
        try:
            inner()
        finally:
            torch.cuda.set_sync_debug_mode("warn")
        iters.append(eng._inflight[0].iters)

    def dispatch_update(*a):
        torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            inner_update(*a)
        finally:
            torch.cuda.set_sync_debug_mode("warn")
        update_s.append(time.perf_counter() - t0)

    eng._dispatch_superstep, eng._dispatch_update = dispatch, dispatch_update
    inner_chunk = eng._advance_prefill

    def advance_prefill():
        torch.cuda.set_sync_debug_mode("error")
        try:
            inner_chunk()
        finally:
            torch.cuda.set_sync_debug_mode("warn")

    if eng._chunk:
        eng._advance_prefill = advance_prefill
    for r in reqs:
        eng.submit_request(r)
    torch.cuda.synchronize()
    comps, per_tick = [], []
    keys = ("steps", "accepted", "drafted")
    t0 = time.perf_counter()
    try:
        torch.cuda.set_sync_debug_mode("warn")
        while eng.busy:
            before, n_upd = [eng.stats[k] for k in keys], len(update_s)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                comps.extend(eng.step())
            per_tick.append(sum("synchroniz" in str(w.message) for w in caught))
            if log is not None:
                log.append(dict(zip(keys, (eng.stats[k] - b for k, b in zip(keys, before))),
                                update_s=update_s[n_upd:]))
    finally:
        torch.cuda.set_sync_debug_mode("default")
        del eng._dispatch_superstep, eng._dispatch_update   # the class's methods; no cycle
        if eng._chunk:
            del eng._advance_prefill
    torch.cuda.synchronize()
    return comps, time.perf_counter() - t0, sum(iters), per_tick


def capped(stream: list, max_new: int) -> list:
    """A generated stream cut at the budget and just after the first EOS (1)."""
    stream = stream[:max_new]
    return stream[:stream.index(1) + 1] if 1 in stream else stream


def ar_alone(model, params, spec, req, memo: dict) -> list:
    """``ar_generate`` of `req`'s prompt alone (B = 1), its generated tokens
    before the budget and EOS cut, kept in `memo` by prompt and budget
    (greedy AR is deterministic): one model's phases share its streams."""
    key = (req.prompt.tobytes(), req.max_new)
    if key not in memo:
        n = len(req.prompt)
        ar = spec.ar_generate(model, params, torch.as_tensor(req.prompt[None], device=DEV),
                              req.max_new)
        memo[key] = ar.tokens[0, n:int(ar.lengths[0])].tolist()
    return memo[key]


def check_against_ar(model, params, spec, reqs, comps, label, n_phase=8, alone=False,
                     same_shape=None, ar_memo=None, witness=None, rtol=GAP_RTOL):
    """Each completion against ar_generate on its exact prompt (one AR run
    per prompt length, or per request when `alone`, which prefills each
    prompt by itself as the continuous engine does, its streams kept in
    `ar_memo` when given), EOS 1 and its budget applied; a first
    difference passes at a near-tie of the AR top-2 logits (within `rtol`
    of the top one; by default GAP_RTOL, bf16's), or, where
    `same_shape(request)` is given, when greedy AR decoded at the engine's
    own row counts gives the completion bit for bit, or, where
    `witness(request, completion)` is given, when it holds."""
    by_uid = {c.uid: c for c in comps}
    check(sorted(by_uid) == sorted(r.uid for r in reqs), f"{label}: missing completions")
    equal, tied, shaped = 0, 0, 0
    groups = ([[r] for r in reqs] if alone else
              [[r for r in reqs if len(r.prompt) == n]
               for n in sorted({len(r.prompt) for r in reqs})])
    for group in groups:
        n = len(group[0].prompt)
        if alone:
            streams_ = [ar_alone(model, params, spec, group[0],
                                 {} if ar_memo is None else ar_memo)]
        else:
            prompts = torch.as_tensor(np.stack([r.prompt for r in group]), device=DEV)
            ar = spec.ar_generate(model, params, prompts, max(r.max_new for r in group))
            streams_ = [ar.tokens[i, n:int(ar.lengths[i])].tolist() for i in range(len(group))]
        for i, r in enumerate(group):
            stream = capped(streams_[i], r.max_new)
            got = by_uid[r.uid].gen_tokens.tolist()
            if got == stream:
                equal += 1
                continue
            p = next((j for j, (a, b) in enumerate(zip(got, stream)) if a != b),
                     min(len(got), len(stream)))
            check(p < min(len(got), len(stream)),
                  f"{label}: request {r.uid} stops at {len(got)}, AR at {len(stream)}")
            prefix = torch.as_tensor(np.concatenate([r.prompt, stream[:p]]).astype(np.int64),
                                     device=DEV)[None]
            # an MoE stack's AR logits come from its dropless decode steps,
            # an int8 cache's from its one-token steps (they read the
            # dequantised cache; a one-shot prefill attends in full precision)
            t1, t2 = (top2_gap(model, params, prefix, len(r.prompt), r.max_new)
                      if (model.cfg.moe is not None and alone) or model.cfg.kv_quant else
                      top2_gap(model, params, prefix))
            phase(n_phase, f"{label}: request {r.uid} first differs from AR at generated token "
                     f"{p}, AR top-2 logits {t1:.4f} / {t2:.4f}, gap {t1 - t2:.4e}")
            if t1 - t2 <= rtol * max(abs(t1), 1.0):
                tied += 1
                continue
            if witness is not None:
                check(witness(r, got), f"{label}: request {r.uid} differs from AR outside a "
                                       f"near-tie and its witness does not hold")
                shaped += 1
                continue
            check(same_shape is not None,
                  f"{label}: request {r.uid} differs from AR outside a near-tie")
            exact = same_shape(r) == got
            phase(n_phase, f"{label}: request {r.uid}: greedy AR decoded at the engine's row "
                           f"counts gives the completion bit for bit: {exact}")
            check(exact, f"{label}: request {r.uid} differs from AR outside a near-tie "
                         f"and from AR at the engine's row counts")
            shaped += 1
    phase(n_phase, f"{label}: {equal} of {len(reqs)} completions equal their AR stream; {tied} "
             f"differ only at a near-tie (rtol {rtol})"
             + (f"; {shaped} differ beyond one and equal AR at the engine's row counts"
                if same_shape is not None else "")
             + (f"; {shaped} differ beyond one and go to their witness"
                if witness is not None else ""))


# ---------------------------------------------------------------------------
# eager and graphed runs of a path (phases 4, 8 and 9)
# ---------------------------------------------------------------------------

# every path runs twice: replaying its block-step from CUDA graphs (the
# engine's default, the main path) and eagerly (graphs=False), which the
# graphed streams must equal bit for bit
MODES = (("eager", False), ("graphed", True))


def streams(comps) -> dict:
    return {c.uid: c.gen_tokens.tolist() for c in comps}


def release(run: dict) -> None:
    """Drop a run's engine (its static caches and graphs) and give its
    memory back, so the next run's peak is its own."""
    run.pop("eng", None)
    gc.collect()                       # an engine may sit in a reference cycle
    torch.cuda.empty_cache()


def finish_run(eng, n, label, comps, wall, g0, prefills=None) -> dict:
    """A timed run's figures: completions, wall s, launch counts, block-steps
    and counts, peak memory since the last reset, graph replays in the run
    and the engine's graph figures."""
    from repro_torch.kernels import ops
    check_fast_loader(ops, n, label)
    g, st = eng.graph_stats(), eng.stats
    return dict(eng=eng, comps=comps, wall=wall, launches=dict(ops.launches),
                attn_kv=dict(ops.attn_kv), steps=st["steps"], blocks=st["blocks"],
                committed=st["committed"],
                drafted=st["drafted"], dispatches=st["dispatches"], host_syncs=st["host_syncs"],
                peak=torch.cuda.max_memory_allocated(),
                peak_reserved=torch.cuda.max_memory_reserved(),
                replays=g["replays"] - g0["replays"], graph=g,
                prefills=None if prefills is None else prefills[0])


def reset_counts(prefills=None) -> None:
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    if prefills is not None:
        prefills[0] = 0


def frozen(model, dvi):
    """A trainer state around the fixed drafter `dvi`: phases 4, 8 and 9
    serve with learn=False."""
    from repro_torch.core import online
    return online.init_trainer(model, dvi_params=dvi)


def sync_run(model, params, dvi, reqs, graphs_on: bool, n: int, label: str,
             prefills=None, state=None, guard: bool = False, **kw) -> dict:
    """A sync engine with graphs on or off: its graphs captured for the
    requests' buckets (``warmup``) and one warm-up batch, then `reqs` timed,
    with `guard` every replay of a block-step graph under sync debug mode
    "error" (``guard_syncs``).  The drafter `dvi` is frozen, unless a
    learning trainer `state` is given (with ``learn=True`` in `kw`)."""
    from repro_torch.serving.engine import ServingEngine
    kw = dict(dict(learn=False, batch_size=N_REQUESTS), **kw)
    eng = ServingEngine(model, params, state or frozen(model, dvi), max_new=MAX_NEW,
                        graphs=graphs_on, **kw)
    eng.warmup(buckets=sorted({eng._bucket(len(r.prompt)) for r in reqs}))
    eng.submit_request(reqs[0])                  # warm-up batch, not counted
    eng.run()
    eng.reset_stats()
    if guard and graphs_on:
        for step in eng._runner.all_steps():
            guard_syncs(step)
    for r in reqs:
        eng.submit_request(r)
    reset_counts(prefills)
    g0 = eng.graph_stats()
    t0 = time.perf_counter()
    comps = eng.run()
    torch.cuda.synchronize()
    return finish_run(eng, n, label, comps, time.perf_counter() - t0, g0, prefills)


def continuous_engine(model, params, dvi, pages: int, graphs_on: bool, state=None, **kw):
    """A continuous engine (8 lanes, supersteps of 4 blocks; paged over
    `pages` pages, or contiguous with 0), its graph captured.  The drafter
    `dvi` is frozen, unless a learning trainer `state` is given (with
    ``learn=True`` in `kw`)."""
    from repro_torch.serving.engine import ServingEngine
    kw = dict(dict(learn=False), **kw)
    eng = ServingEngine(model, params, state or frozen(model, dvi), scheduler="continuous",
                        num_slots=C_SLOTS, max_new=MAX_NEW, kv_pages=pages,
                        kv_page_size=C_PAGE, sync_every=C_SYNC, graphs=graphs_on, **kw)
    eng.warmup()
    return eng


TICK_PHASES = ("pre_admit", "harvest", "sync_wait", "sweep_cancels", "grow_pages", "admit",
               "prefill_chunk", "dispatch")


def tick_phases(model, params, dvi, reqs, pages: int, n: int, label: str, **kw) -> dict:
    """The graphed continuous path once more with the engine's lifecycle
    tracer on (``telemetry=True``; `kw` to the engine): host ms per
    block-step in each phase of a tick, from the tracer's spans on the
    engine's track.  ``sync_wait`` is the harvest's wait for the device,
    inside ``harvest``; ``admit`` and ``pre_admit`` hold the admissions'
    eager prefills (with chunked prefill: of the first chunk),
    ``prefill_chunk`` the chunk steps' uploads and replays, ``dispatch`` the
    superstep's.  Also the host ms of one admission, from the lanes'
    ``admit`` spans.  Returns {phase: ms per block-step, "admission": ms,
    "admissions": count}."""
    eng = continuous_engine(model, params, dvi, pages, True, telemetry=True, **kw)
    for r in reqs:
        eng.submit_request(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = max(eng.stats["steps"], 1)
    ms, admits = traced_ticks(eng)
    admits = [dur for _, dur in admits]
    phase(n, f"{label}, graphed, traced again: wall {1e3 * wall / steps:.2f} ms a block-step "
             f"({steps} block-steps); host ms a block-step by tick phase: "
             + ", ".join(f"{name} {v:.2f}" for name, v in ms.items())
             + f"; outside ticks {1e3 * wall / steps - ms['tick']:.2f}; {len(admits)} "
             f"admissions, {np.mean(admits) if admits else 0.0:.2f} host ms each")
    ms.update(admission=float(np.mean(admits)) if admits else 0.0, admissions=len(admits))
    del eng
    release({})
    return ms


def traced_ticks(eng, since: float = None) -> tuple:
    """From a traced engine's Chrome trace (the spans that start at engine
    clock `since` or later, when given): host ms a block-step in each tick
    phase (spans on the engine's track), and (uid, host ms) of each
    admission (the lanes' ``admit u<uid>`` spans)."""
    steps = max(eng.stats["steps"], 1)
    tid = eng.telem.tid_engine
    ms = {name: 0.0 for name in ("tick",) + TICK_PHASES}
    admits = []
    t0 = float("-inf") if since is None else eng.telem.tracer._ts(since)
    for ev in eng.trace_dict()["traceEvents"]:
        if ev.get("ts", t0) < t0:
            continue
        if ev.get("ph") == "X" and ev.get("tid") == tid and ev["name"] in ms:
            ms[ev["name"]] += ev["dur"] / 1e3 / steps
        elif ev.get("ph") == "X" and str(ev.get("name", "")).startswith("admit u"):
            admits.append((int(ev["name"][len("admit u"):]), ev["dur"] / 1e3))
    return ms, admits


def continuous_run(model, params, dvi, reqs, graphs_on: bool, pages: int, n: int,
                   label: str, prefills=None, **kw) -> dict:
    """A continuous engine (`kw` to it) with graphs on or off and one
    warm-up request, then `reqs` served at once under ``serve_checked``'s
    zero-sync gate.  With ``prefill_chunk`` it adds the chunk figures, the
    chunk step's replays in the run and the preemptions of mid-prefill
    lanes."""
    eng = continuous_engine(model, params, dvi, pages, graphs_on, **kw)
    eng.submit_request(reqs[0])                  # warm-up, not counted
    eng.run()
    eng.reset_stats()
    reset_counts(prefills)
    g0 = eng.graph_stats()
    step = eng._runner.chunk_step
    c0 = step.replays if step is not None else 0
    mid = mid_prefill_preemptions(eng)
    try:
        comps, wall, blocks_run, per_tick = serve_checked(eng, reqs)
    finally:
        del eng._preempt                         # the class's method; no cycle
    run = finish_run(eng, n, label, comps, wall, g0, prefills)
    run.update(blocks_run=blocks_run, per_tick=per_tick, ticks=eng.tick_percentiles())
    if eng._chunk:
        run.update(chunk_figures(eng), chunk_replays=step.replays - c0, mid=sum(mid),
                   kv=eng.kv_stats() if eng.paged else {})
    return run


def report_modes(n: int, label: str, runs: dict) -> None:
    """The eager and graphed runs of a path side by side, and the gate that
    the graphed streams equal the eager ones bit for bit.  Host launches per
    block-step: the device launches the profile saw (eager: each one a
    kernel launch from the host), or the graph replays (graphed)."""
    for mode, r in runs.items():
        steps, g, p = max(r["steps"], 1), r["graph"], r["profile"]
        if p is None:
            dev = "device busy not profiled"
            host = ("every kernel launched from the host" if mode == "eager" else
                    f"{r['replays'] / steps:.3f} graph replays ({r['replays']} in the run)")
        else:
            dev = (f"device busy {100 * p['busy']:.1f}% ({p['device_ms']:.2f} ms and "
                   f"{p['launches']:.0f} device launches a block-step)")
            host = (f"{p['launches']:.0f} kernel launches" if mode == "eager" else
                    f"{r['replays'] / steps:.3f} graph replays ({r['replays']} in the run)")
        phase(n, f"{label}, {mode}: wall per block-step {1e3 * r['wall'] / steps:.2f} ms "
                 f"({r['steps']} block-steps in {r['wall']:.3f} s), "
                 f"{r['committed'] / r['wall']:.1f} committed tokens/s, {dev}, host launches "
                 f"per block-step: {host}; "
                 f"{g['captures']} captures in {g['capture_s']:.2f} s (instantiate "
                 f"{g['instantiate_s']:.3f} s), graph nodes {g['nodes']}, graph pool "
                 f"{g['pool_bytes'] / 2**30:.3f} GiB, replay() "
                 f"{1e6 * g['replay_host_s'] / max(g['replays'], 1):.1f} us on the host; peak "
                 f"memory {r['peak'] / 2**30:.2f} GiB allocated, "
                 f"{r['peak_reserved'] / 2**30:.2f} GiB reserved")
    check_census(n, f"{label}, graphed", runs["graphed"]["graph"])
    if "eager" not in runs:            # a path run graphed only
        return
    eager, graphed = streams(runs["eager"]["comps"]), streams(runs["graphed"]["comps"])
    phase(n, f"{label}: graphed streams bit-identical to eager ones: {eager == graphed} "
             f"({len(graphed)} completions)")
    check(eager == graphed and len(graphed) > 0,
          f"{label}: graphed streams differ from eager ones")


def check_comps(comps, reqs, vocab: int, label: str) -> None:
    """One well-formed completion for each request: 1 to MAX_NEW tokens,
    each in the vocabulary."""
    check(len(comps) == len(reqs), f"{label}: {len(comps)} completions for {len(reqs)} "
                                   f"requests")
    for c in comps:
        check(1 <= len(c.gen_tokens) <= MAX_NEW and bool((c.gen_tokens >= 0).all())
              and bool((c.gen_tokens < vocab).all()),
              f"{label}: request {c.uid}: bad generation {c.gen_tokens}")


def launch_gate(n: int, label: str, r: dict, want: dict) -> None:
    phase(n, f"{label}: launches {r['launches']}; expected {want}")
    check(r["launches"] == want, f"{label}: the kernels did not run as the formula says")


def sync_modes(model, params, dvi, reqs, n: int, label: str, want, prefills=None,
               profile=None, ar_kw=None, modes=MODES, **kw) -> dict:
    """A path on the sync engine (`kw` to ``sync_run``), eagerly and
    graphed: well-formed completions, the launches ``want(run)`` exact on
    both, graphed == eager bit for bit and the census (``report_modes``),
    then each graphed completion against AR on its bucket-padded prompt
    (the near-tie rule; `ar_kw` to ``check_against_ar``).
    ``profile(run)``, given, profiles the graphed run (the eager one is not
    profiled: the script's time limit).  `modes` (default both) may name the
    graphed one alone.  Returns the runs by mode."""
    from repro_torch.core import spec
    from repro_torch.serving.engine import Request
    runs = {}
    for mode, on in modes:
        r = runs[mode] = sync_run(model, params, dvi, reqs, on, n, f"{label} {mode}",
                                  prefills=prefills, **kw)
        check(r["steps"] > 0, f"{label} {mode}: no block-step ran")
        check_comps(r["comps"], reqs, model.cfg.vocab_size, f"{label} {mode}")
        pre = "" if prefills is None else f" and {r['prefills']} prefill calls"
        phase(n, f"{label} {mode}: served {len(r['comps'])} requests in {r['steps']} "
                 f"block-steps{pre}, wall {r['wall']:.3f} s: MAT "
                 f"{r['committed'] / max(r['blocks'], 1):.4f}, "
                 f"{r['committed'] / r['wall']:.1f} committed tokens/s, peak memory "
                 f"{r['peak'] / 2**30:.2f} GiB")
        launch_gate(n, f"{label} {mode}", r, want(r))
        r["profile"] = profile(r) if on and profile is not None else None
        eng = r["eng"]
        padded = [Request(uid=q.uid, prompt=eng._pad(q, eng._bucket(len(q.prompt))),
                          max_new=q.max_new) for q in reqs]
        del eng
        release(r)
    report_modes(n, label, runs)
    check_against_ar(model, params, spec, padded, runs["graphed"]["comps"], label, n_phase=n,
                     **(ar_kw or {}))
    return runs


def continuous_modes(model, params, dvi, reqs, pages: int, n: int, label: str, want,
                     prefills=None, profile=None, engine_kw=None, modes=MODES,
                     **ar_kw) -> dict:
    """A path on the continuous engine (contiguous with `pages` 0, else
    paged; `engine_kw` to it), eagerly and graphed, under
    ``serve_checked``'s zero-sync gate: well-formed completions, lanes
    empty at the end, host syncs == dispatches, the launches ``want(run)``
    exact on both, graphed == eager bit for bit and the census, then each
    graphed completion against AR on its exact prompt alone (B = 1, as the
    admission prefills it; `ar_kw` to ``check_against_ar``).
    ``profile(run)``, given, profiles the graphed run.  `modes` as in
    ``sync_modes``.  Returns the runs by mode."""
    from repro_torch.core import spec
    runs = {}
    for mode, on in modes:
        r = runs[mode] = continuous_run(model, params, dvi, reqs, on, pages, n,
                                        f"{label} {mode}", prefills=prefills,
                                        **(engine_kw or {}))
        eng = r["eng"]
        check(r["blocks_run"] > 0, f"{label} {mode}: no block ran")
        check_comps(r["comps"], reqs, model.cfg.vocab_size, f"{label} {mode}")
        pre = "" if prefills is None else f", {r['prefills']} prefill calls"
        phase(n, f"{label} {mode} ({f'paged, {pages} pages' if pages else 'contiguous'}, "
                 f"{C_SLOTS} lanes, sync_every {C_SYNC}): {len(r['comps'])} requests in "
                 f"{r['wall']:.3f} s, {r['committed'] / r['wall']:.1f} committed tokens/s, MAT "
                 f"{r['committed'] / max(r['blocks'], 1):.4f}, {r['dispatches']} dispatches, "
                 f"{r['host_syncs']} host syncs, {r['blocks_run']} blocks run ({r['steps']} "
                 f"with a live lane){pre}, peak memory {r['peak'] / 2**30:.2f} GiB")
        phase(n, f"{label} {mode}: synchronising operations per tick: {r['per_tick']} (0 "
                 f"inside every dispatch: sync debug mode 'error')")
        check(eng.active_slots == 0 and not eng.busy, f"{label}: lanes left occupied at the end")
        check(r["host_syncs"] == r["dispatches"], f"{label}: host syncs != dispatches")
        launch_gate(n, f"{label} {mode}", r, want(r))
        r["profile"] = profile(r) if on and profile is not None else None
        del eng
        release(r)
    report_modes(n, label, runs)
    check_against_ar(model, params, spec, reqs, runs["graphed"]["comps"], label, n_phase=n,
                     alone=True, **ar_kw)
    return runs


def continuous_phase(cfg, model, params, dvi, paged_row, vocab_rows):
    """Phase 8.  Returns the graphed and the eager ample-pool runs' launch
    counts and the graphed run's busy share."""
    from repro_torch.core import spec
    K, k, L = cfg.dvi.k_spec, cfg.dvi.split_layer, cfg.num_layers
    reqs = continuous_requests(cfg)
    expect = {"paged_decode_attention": path_attention_ms(paged_row, K, k, L),
              "verify_argmax": vocab_rows["verify_argmax"]["ms"],
              "lora_logits": vocab_rows["lora_logits"]["ms"]}
    runs = {}
    for mode, on in MODES:
        r = runs[mode] = continuous_run(model, params, dvi, reqs, on, C_PAGES_AMPLE, 8,
                                        f"continuous {mode}")
        eng, blocks_run = r["eng"], r["blocks_run"]
        kv = eng.kv_stats()
        phase(8, f"{mode}, ample pool ({C_PAGES_AMPLE} pages of {C_PAGE}, MPS {eng._mps}): "
                 f"{len(r['comps'])} requests in {r['wall']:.3f} s, "
                 f"{r['committed'] / r['wall']:.1f} committed tokens/s, MAT "
                 f"{r['committed'] / max(r['blocks'], 1):.4f}, {r['dispatches']} dispatches, "
                 f"{r['host_syncs']} host syncs, {blocks_run} blocks run ({r['steps']} with a "
                 f"live lane), peak {kv['peak_used_pages']} pages, {kv['preemptions']} "
                 f"preemptions, used pages at the end {kv['used_pages']}, peak memory "
                 f"{r['peak'] / 2**30:.2f} GiB")
        phase(8, f"{mode}: synchronising operations per tick: {r['per_tick']} (0 inside every "
                 f"dispatch: sync debug mode 'error')")
        check(kv["used_pages"] == 0, "pages left in use after the ample run")
        check(r["host_syncs"] == r["dispatches"], "host syncs != dispatches")
        want = {"paged_decode_attention": ((K + 1) * k + (L - k)) * blocks_run,
                "lora_logits": (K + 1) * blocks_run, "verify_argmax": blocks_run,
                "decode_attention": 0, "ssd_scan": 0}
        phase(8, f"{mode}: launches over {blocks_run} blocks: {r['launches']}; expected {want}")
        check(r["launches"] == want,
              "the continuous path did not run the kernels as the formula says")
        # the eager rerun is not profiled (the script's time limit)
        r["profile"] = profile_batch(eng, reqs, r["wall"] * 1e3, n=8,
                                     expect=expect) if on else None
        release(r)
    report_modes(8, "vicuna-7b continuous, ample pool", runs)
    runs["graphed"]["ticks_host"] = tick_phases(model, params, dvi, reqs, C_PAGES_AMPLE, 8,
                                                "vicuna-7b continuous, ample pool")
    check_against_ar(model, params, spec, reqs, runs["graphed"]["comps"], "ample pool")

    # the tight pool: searched with graphed engines, then served eagerly at
    # the size found
    pages = C_PAGES_TIGHT
    while True:
        eng = continuous_engine(model, params, dvi, pages, True)
        comps_t, wall_t, _, per_tick_t = serve_checked(eng, reqs)
        kv_t = eng.kv_stats()
        phase(8, f"graphed, tight pool of {pages} pages: {len(comps_t)} requests in "
                 f"{wall_t:.3f} s, {kv_t['preemptions']} preemptions, peak "
                 f"{kv_t['peak_used_pages']} pages, used pages at the end "
                 f"{kv_t['used_pages']}, syncs per tick max {max(per_tick_t)}")
        check(kv_t["used_pages"] == 0, "pages left in use after the tight run")
        if kv_t["preemptions"] >= 1 or pages <= eng._mps:
            break
        # halve while that stays at 24 or more, then one page at a time: the
        # pre-admission reserve makes preemption need a pool that holds two
        # lanes only just (about 20-24 pages of 16 here at MAT 1)
        pages = pages // 2 if pages // 2 >= 24 else pages - 1
        del eng
        release({})
    check(kv_t["preemptions"] >= 1, "the tight pool never preempted")
    del eng
    release({})
    eng = continuous_engine(model, params, dvi, pages, False)
    comps_e, wall_e, _, per_tick_e = serve_checked(eng, reqs)
    kv_e = eng.kv_stats()
    phase(8, f"eager, tight pool of {pages} pages: {len(comps_e)} requests in {wall_e:.3f} s, "
             f"{kv_e['preemptions']} preemptions, used pages at the end {kv_e['used_pages']}, "
             f"syncs per tick max {max(per_tick_e)}")
    check(kv_e["used_pages"] == 0 and kv_e["preemptions"] >= 1,
          "the eager tight run left pages in use or never preempted")
    same = streams(comps_t) == streams(comps_e)
    phase(8, f"tight pool used: kv_pages={pages}; graphed streams bit-identical to eager "
             f"ones: {same}")
    check(same, "tight pool: graphed streams differ from eager ones")
    del eng
    release({})
    check_against_ar(model, params, spec, reqs, comps_t, f"tight pool ({pages} pages)")
    runs["graphed"]["tight_pages"] = pages
    return runs["graphed"]["launches"], runs["eager"]["launches"], runs["graphed"]


# ---------------------------------------------------------------------------
# phase 10: the Improve loop on vicuna-7b
# ---------------------------------------------------------------------------

def learn_state(model):
    """The drafter's trainer state drawn from the seed (B = 0: the drafter
    starts as the verifier head read at layer k), an empty 4096-slot ring."""
    from repro_torch.core import online
    return online.init_trainer(model, torch.Generator(device=DEV).manual_seed(SEED))


def drafter_tensors(state) -> dict:
    """A copy of every tensor of the drafter's state that an update writes."""
    return {k: t.clone() for k, t in (
        ("A", state.dvi_params["A"]), ("B", state.dvi_params["B"]),
        *((f"{m}/{k}", t) for m in ("m", "v") for k, t in state.opt_state[m].items()),
        ("opt_step", state.opt_state["step"]), ("baseline", state.baseline),
        ("step", state.step))}


def record_updates(eng) -> list:
    """Keep every update's metrics (device scalars) as the engine runs it."""
    seen, inner = [], eng._update_fn

    def update(*a, **kw):
        seen.append(inner(*a, **kw))
        return seen[-1]

    eng._update_fn = update
    return seen


def update_report(metrics: list) -> str:
    keys = (("loss", "loss"), ("kl", "KL"), ("l_ce", "CE"), ("entropy", "entropy"),
            ("gnorm", "gnorm"), ("acc_rate", "batch acceptance"))
    return "; ".join(f"{label} first {float(metrics[0][k]):.4f} last {float(metrics[-1][k]):.4f}"
                     for k, label in keys)


def quarter_acceptance(log: list) -> tuple:
    """Acceptance (accepted / drafted) over the first and the last quarter
    of the block-steps, from serve_checked's per-tick log."""
    total = sum(t["steps"] for t in log)
    first, last, seen = [0, 0], [0, 0], 0
    for t in log:
        for q, inside in ((first, seen < total / 4), (last, seen >= 3 * total / 4)):
            if inside:
                q[0] += t["accepted"]
                q[1] += t["drafted"]
        seen += t["steps"]
    return first[0] / max(first[1], 1), last[0] / max(last[1], 1)


def cadence(log: list, since: int, update_every: int) -> int:
    """The reference engine's update count, counted on the host from the
    block-steps each harvest saw: an update once `update_every` of them ran
    since the last and the buffer holds tuples (after any live block)."""
    updates, seen = 0, 0
    for t in log:
        since += t["steps"]
        seen += t["steps"]
        if since >= update_every and seen > 0:
            since, updates = 0, updates + 1
    return updates


def update_device_ms(eng) -> float:
    """The device time of one update (``time_ms``: L2 flushed, enqueue
    hidden behind a spin) on a copy of the engine's trainer state after its
    run (a full ring), writing into staging tensors as the engine does."""
    from repro_torch.core import online
    st = eng.state
    copy = online.OnlineTrainerState(
        {k: v.clone() for k, v in st.dvi_params.items()},
        {"m": {k: v.clone() for k, v in st.opt_state["m"].items()},
         "v": {k: v.clone() for k, v in st.opt_state["v"].items()},
         "step": st.opt_state["step"].clone()},
        {k: v.clone() for k, v in st.buf.items()}, st.baseline.clone(), st.step.clone())
    staging = {k: torch.empty_like(v) for k, v in copy.dvi_params.items()}
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    ms, _ = time_ms(lambda: eng._update_fn(eng.params, copy, gen, out=staging), iters=10)
    return ms


def learn_continuous(cfg, model, params, reqs, base: dict) -> dict:
    """Phase 10, continuous: phase 8's ample pool and requests with
    learn=True, eagerly and graphed, each from the same seeded trainer state
    and after one warm-up request (which learns too).  Returns the launches
    by mode."""
    from repro_torch.core import graphs
    from repro_torch.kernels import ops
    K, k, L = cfg.dvi.k_spec, cfg.dvi.split_layer, cfg.num_layers
    runs = {}
    for mode, on in MODES:
        state = learn_state(model)
        ptrs = graphs.drafter_ptrs(state.dvi_params)
        eng = continuous_engine(model, params, None, C_PAGES_AMPLE, on, state=state, learn=True,
                                update_every=L_UPDATE_EVERY, lr=L_LR, mode=L_MODE)
        eng.submit_request(reqs[0])                  # warm-up, not counted
        eng.run()
        eng.reset_stats()
        reset_counts()
        since, step0 = eng._blocks_since_update, int(state.step)
        metrics, log = record_updates(eng), []
        g0 = eng.graph_stats()
        comps, wall, blocks_run, per_tick = serve_checked(eng, reqs, log=log)
        r = runs[mode] = finish_run(eng, 10, f"learning continuous {mode}", comps, wall, g0)
        st = eng.stats
        n_upd = st["updates"]
        want = {"paged_decode_attention": ((K + 1) * k + (L - k)) * blocks_run,
                "lora_logits": (K + 1) * blocks_run + 2 * n_upd, "verify_argmax": blocks_run,
                "decode_attention": 0, "ssd_scan": 0}
        host_s = [s for t in log for s in t["update_s"]]
        q1, q4 = quarter_acceptance(log)
        tt = eng.train_telemetry()
        gauges = {name: v["value"] for name, v in eng.metrics_snapshot().items()
                  if name.startswith("dvi_train_") and v.get("type") == "gauge"}
        phase(10, f"continuous {mode}: {len(comps)} requests in {wall:.3f} s, {st['steps']} "
                  f"block-steps, {blocks_run} blocks run, {n_upd} updates (the reference's "
                  f"cadence counted on the host: {cadence(log, since, L_UPDATE_EVERY)}), "
                  f"{st['dispatches']} dispatches, {st['host_syncs']} host syncs, MAT "
                  f"{st['committed'] / max(st['blocks'], 1):.4f}, acceptance first quarter "
                  f"{q1:.4f} last quarter {q4:.4f}; update host ms "
                  f"{1e3 * np.mean(host_s):.2f} (max {1e3 * max(host_s):.2f}); "
                  f"peak memory {r['peak'] / 2**30:.2f} GiB")
        phase(10, f"continuous {mode}: {update_report(metrics)}")
        phase(10, f"continuous {mode}: launches {r['launches']}; expected {want}; syncs per "
                  f"tick {per_tick} (0 inside every superstep and update dispatch)")
        check(r["launches"] == want, "the learning continuous path did not run the kernels "
                                     "as the formula says")
        check(n_upd == cadence(log, since, L_UPDATE_EVERY) > 0,
              "the updates do not follow the reference's cadence")
        check(st["host_syncs"] == st["dispatches"], "host syncs != dispatches")
        check(eng.kv_stats()["used_pages"] == 0, "pages left in use after the learning run")
        check(graphs.drafter_ptrs(state.dvi_params) == ptrs, "A or B moved")
        check(tt["step"] == int(state.step) == step0 + n_upd and tt["updates"] == n_upd,
              "the train telemetry's step disagrees with the updates")
        check(len(gauges) >= 12 and all(np.isfinite(v) for v in gauges.values()),
              f"a dvi_train_* gauge is not finite: {gauges}")
        r.update(blocks_run=blocks_run, metrics=metrics, state=drafter_tensors(state),
                 update_host_ms=1e3 * float(np.mean(host_s)), q=(q1, q4))
        if mode == "graphed":
            check_census(10, "learning continuous, graphed", r["graph"])
            r["update_ms"] = update_device_ms(eng)
            r["profile"] = profile_batch(eng, reqs, wall * 1e3, n=10)
        release(r)
    eager, graphed = runs["eager"], runs["graphed"]
    same = streams(eager["comps"]) == streams(graphed["comps"])
    same_state = all(torch.equal(graphed["state"][k], v) for k, v in eager["state"].items())
    phase(10, f"continuous: graphed streams bit-identical to eager ones: {same}; final drafter "
              f"state (A, B, m, v, baseline, steps) bit-identical: {same_state}")
    check(same and same_state, "learning continuous: graphed differs from eager")
    g, steps = graphed, max(graphed["steps"], 1)
    phase(10, f"continuous graphed, learning against phase 8's frozen drafter: wall per "
              f"block-step {1e3 * g['wall'] / steps:.2f} ms against "
              f"{1e3 * base['wall'] / max(base['steps'], 1):.2f}, device ms a block-step "
              f"{g['profile']['device_ms']:.2f} against {base['profile']['device_ms']:.2f}, "
              f"busy {100 * g['profile']['busy']:.1f}% against "
              f"{100 * base['profile']['busy']:.1f}%, {g['committed'] / g['wall']:.1f} "
              f"committed tokens/s against {base['committed'] / base['wall']:.1f}; an update: "
              f"{g['update_ms']:.3f} device ms (time_ms), {g['update_host_ms']:.2f} host ms")
    return runs


def learn_sync(cfg, model, params, reqs, base: dict) -> dict:
    """Phase 10, sync: phase 4's requests with learn=True and one update a
    batch, eagerly and graphed, each from the same seeded trainer state; the
    updates run under sync debug mode "error".  Returns the runs."""
    from repro_torch.core import graphs
    K, k, L = cfg.dvi.k_spec, cfg.dvi.split_layer, cfg.num_layers
    runs = {}
    for mode, on in MODES:
        state = learn_state(model)
        ptrs = graphs.drafter_ptrs(state.dvi_params)
        r = runs[mode] = sync_run(model, params, None, reqs, on, 10, f"learning sync {mode}",
                                  state=state, learn=True, updates_per_batch=1, lr=L_LR,
                                  mode=L_MODE)
        eng, n, n_upd = r["eng"], r["steps"], r["eng"].stats["updates"]
        want = {"decode_attention": ((K + 1) * k + (L - k)) * n,
                "lora_logits": (K + 1) * n + 2 * n_upd, "verify_argmax": n,
                "paged_decode_attention": 0, "ssd_scan": 0}
        phase(10, f"sync {mode}: {len(r['comps'])} requests in {n} block-steps, {n_upd} "
                  f"updates, wall {r['wall']:.3f} s, {r['committed'] / r['wall']:.1f} committed "
                  f"tokens/s, acceptance {eng.acceptance:.4f}; launches {r['launches']}; "
                  f"expected {want}")
        check(r["launches"] == want and n_upd == 1, "the learning sync path did not run the "
                                                    "kernels as the formula says")
        check(graphs.drafter_ptrs(state.dvi_params) == ptrs, "A or B moved")
        # one more update on the same engine, under sync debug mode "error"
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng._drafter_update(1)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        r["state"] = drafter_tensors(state)
        release(r)
    eager, graphed = runs["eager"], runs["graphed"]
    same = streams(eager["comps"]) == streams(graphed["comps"])
    same_state = all(torch.equal(graphed["state"][k], v) for k, v in eager["state"].items())
    phase(10, f"sync: graphed streams bit-identical to eager ones: {same}; final drafter state "
              f"bit-identical: {same_state}; an extra update ran with 0 syncs (mode 'error'); "
              f"wall per block-step {1e3 * graphed['wall'] / max(graphed['steps'], 1):.2f} ms "
              f"against phase 4's {1e3 * base['wall'] / max(base['steps'], 1):.2f}")
    check(same and same_state, "learning sync: graphed differs from eager")
    return runs


def against_frozen(model, params, spec, reqs, comps, frozen_comps, label, padded=None,
                   n_phase=10, what="the frozen drafter's", **ar_kw) -> int:
    """Each learning completion equals the frozen drafter's (greedy
    decoding is lossless whatever the drafter); where one does not, it must
    pass ``check_against_ar`` (AR on the prompt the engine decoded, the
    near-tie rule; `ar_kw` to it).  `frozen_comps` may be any run already
    held against AR (`what` names it).  Returns how many were equal."""
    want = streams(frozen_comps)
    differ = [r for r in reqs if streams([c for c in comps if c.uid == r.uid])[r.uid]
              != want[r.uid]]
    phase(n_phase, f"{label}: {len(reqs) - len(differ)} of {len(reqs)} completions equal "
                   f"{what}; {len(differ)} go to the AR check")
    if differ:
        uids = {r.uid for r in differ}
        check_against_ar(model, params, spec, [(padded or {}).get(r.uid, r) for r in differ],
                         [c for c in comps if c.uid in uids], label, n_phase=n_phase, **ar_kw)
    return len(reqs) - len(differ)


# ---------------------------------------------------------------------------
# phase 12: speculative sampling and adaptive depth on vicuna-7b
# ---------------------------------------------------------------------------

def pad_prompt(req, bucket: int) -> np.ndarray:
    """The sync engine's padding: the prompt's last `bucket` tokens, left
    padded by repeating its first."""
    p = req.prompt[-bucket:]
    return np.concatenate([np.full(bucket - len(p), p[0], p.dtype), p]) if len(p) < bucket else p


def sampled_phase(cfg, model, params, dvi, reqs) -> dict:
    """Phase 12a: ``speculative_generate`` at temperature S_TEMP on phase 4's
    8 requests (padded to 128), from a generator seeded from SEED; one
    sampled block under sync debug mode "error"; a sampled and a greedy
    block's device time on the same cache; ``rejection_commit`` alone over
    S_TV_LANES lanes at V = S_TV_V.  Returns the launches and figures."""
    from repro_torch.core import spec
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tfm
    K, k, L, V = cfg.dvi.k_spec, cfg.dvi.split_layer, cfg.num_layers, cfg.vocab_size
    Tp = 128
    prompts = torch.as_tensor(np.stack([pad_prompt(r, Tp) for r in reqs]), device=DEV)

    def run(seed, collect=False):
        gen = torch.Generator(device=DEV).manual_seed(seed)
        return spec.speculative_generate(model, params, dvi, prompts, MAX_NEW,
                                         temperature=S_TEMP, generator=gen, collect=collect)

    reset_counts()
    t0 = time.perf_counter()
    res = run(SEED, collect=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, n = dict(ops.launches), res.steps
    want = {"decode_attention": ((K + 1) * k + (L - k)) * n, "lora_logits": (K + 1) * n,
            "verify_argmax": 0, "paged_decode_attention": 0, "ssd_scan": 0}
    phase(12, f"sampled speculative_generate (T {S_TEMP}, {N_REQUESTS} lanes, prompts of {Tp}, "
              f"{MAX_NEW} new tokens): {n} blocks in {wall:.3f} s, MAT "
              f"{int(res.committed) / max(int(res.blocks), 1):.4f}, acceptance "
              f"{int(res.accepted_drafts) / max(int(res.drafted), 1):.4f}, "
              f"{int(res.committed) / wall:.1f} committed tokens/s (eager), tuples logged "
              f"{int(res.buffer['count'])}; launches {launches}; expected {want}")
    check(launches == want, "the sampled path did not run the kernels as the formula says")
    toks, lens = res.tokens.cpu(), res.lengths.cpu()
    for b in range(N_REQUESTS):
        gen_b = toks[b, Tp:int(lens[b])]
        check(bool((gen_b >= 0).all()) and bool((gen_b < V).all()),
              f"sampled lane {b}: a token outside the vocabulary")
        check(Tp + MAX_NEW <= int(lens[b]) <= Tp + MAX_NEW + K or 1 in gen_b.tolist(),
              f"sampled lane {b}: length {int(lens[b])} for {MAX_NEW} new tokens")
    check(int(res.buffer["count"]) > 0, "the sampled path logged no tuples")
    again, other = run(SEED), run(SEED + 1)
    same = torch.equal(again.tokens, res.tokens) and torch.equal(again.lengths, res.lengths)
    differ = not torch.equal(other.tokens, res.tokens)
    phase(12, f"the same seed gives the same streams bit for bit: {same}; another seed changes "
              f"them: {differ}")
    check(same and differ, "sampling is not reproducible from its seed, or ignores it")

    # one sampled block with no synchronising operation
    _, cache = model.prefill(params, prompts[:, :-1],
                             max_len=Tp + MAX_NEW + K + 2 + tfm.RING_SLACK)
    pend = prompts[:, -1].to(torch.int32)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 2)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        spec.spec_block_step(model, params, dvi, pend, cache, temperature=S_TEMP, generator=gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    phase(12, "one sampled spec_block_step under sync debug mode 'error': 0 synchronising "
              "operations")
    # an eager block's 4.4 k launches overflow the launch queue behind
    # time_ms's spin, so the profiler gives its device time
    samp_ms = block_device_ms(lambda: spec.spec_block_step(
        model, params, dvi, pend, cache, temperature=S_TEMP, generator=gen))
    greedy_ms = block_device_ms(lambda: spec.spec_block_step(model, params, dvi, pend, cache))
    phase(12, f"an eager block on the 8 lanes at length {Tp - 1}, device ms (the time some "
              f"kernel ran, torch.profiler, mean of {BLOCK_REPS}): sampled {samp_ms:.3f}, greedy "
              f"{greedy_ms:.3f}; sampled - greedy {samp_ms - greedy_ms:.3f} ms")

    # rejection_commit alone: the emitted token against p
    rng = np.random.RandomState(SEED + 10)
    p = torch.as_tensor(rng.dirichlet(np.full(S_TV_V, 0.5)).astype(np.float32), device=DEV)
    q = torch.as_tensor(rng.dirichlet(np.full(S_TV_V, 0.5)).astype(np.float32), device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 11)
    counts = torch.zeros(S_TV_V, dtype=torch.float64, device=DEV)
    C = S_TV_CHUNK

    def chunk():
        d = torch.argmax(torch.log(q)[None] + spec.gumbel((C, S_TV_V), gen, DEV), dim=-1)
        d_blk = torch.stack([d, d], dim=1).to(torch.int32)
        m, corr = spec.rejection_commit(d_blk, q.expand(C, 2, S_TV_V), p.expand(C, 2, S_TV_V),
                                        generator=gen)
        return torch.where(m >= 1, d_blk[:, 0], corr)

    for _ in range(S_TV_LANES // C):
        counts += torch.bincount(chunk(), minlength=S_TV_V)
    tv = 0.5 * float((counts / S_TV_LANES - p.double()).abs().sum())
    chunk_ms, _ = time_ms(chunk, iters=5)
    phase(12, f"rejection_commit alone at V={S_TV_V} over {S_TV_LANES} lanes (K = 1, q != p): "
              f"total variation of the emitted token from p {tv:.5f} (limit 0.01); "
              f"{chunk_ms:.3f} device ms a chunk of {C} lanes (draft draw included)")
    check(tv < 0.01, f"rejection_commit: total variation {tv:.5f} from the target")
    return dict(launches=launches, blocks=n, wall=wall, sampled_ms=samp_ms,
                greedy_ms=greedy_ms, tv=tv)


BLOCK_REPS = 5


def block_device_ms(fn) -> float:
    """Device ms of one call of `fn` (an eager block): the time some kernel
    ran (``covered_ms``) over BLOCK_REPS calls under torch.profiler, after
    one call outside it."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(BLOCK_REPS):
            fn()
        torch.cuda.synchronize()
    busy = covered_ms([(t0, t1) for _, t0, t1 in device_events(prof)])
    check(busy > 0.0, "profile: the profiler saw no device time")
    return busy / BLOCK_REPS


def record_depths(eng, k_min: int) -> dict:
    """Wrap the runner's dispatch and the engine's harvest: each dispatch's
    draft width and blocks, and after each harvest every lane of that
    dispatch's depth against [k_min, its ceiling k_cap].  ``close()`` puts
    the methods back."""
    runner = eng._runner
    rec = dict(dispatches=[], bad=[], last=None)
    inner_d, inner_h = runner.dispatch, eng._harvest

    def dispatch(done, budget, steps, k_blk=None, depth_state=None):
        rec["dispatches"].append((k_blk, steps))
        rec["last"] = (np.array(depth_state[3]), [s for s, st in enumerate(eng._slots)
                                                  if st is not None])
        return inner_d(done, budget, steps, k_blk=k_blk, depth_state=depth_state)

    def harvest():
        last, rec["last"] = rec["last"], None
        outs = inner_h()
        if last is not None:
            kcap, lanes = last
            rec["bad"] += [(s, int(eng._k_host[s]), int(kcap[s])) for s in lanes
                           if not k_min <= int(eng._k_host[s]) <= int(kcap[s])]
        return outs

    def close():
        del runner.dispatch, eng._harvest            # the class's methods; no cycle

    runner.dispatch, eng._harvest = dispatch, harvest
    rec["close"] = close
    return rec


def adaptive_run(model, params, dvi, reqs, pages: int, label: str, floor: int, n: int = 12,
                 **kw) -> dict:
    """A graphed continuous engine with ``adaptive_k`` (its graphs of every
    draft width captured ahead) and one warm-up request, then `reqs` served
    at once under ``serve_checked``'s zero-sync gate, the depths recorded."""
    eng = continuous_engine(model, params, dvi, pages, True, adaptive_k=True, **kw)
    eng.submit_request(reqs[0])                  # warm-up, not counted
    eng.run()
    eng.reset_stats()
    reset_counts()
    g0 = eng.graph_stats()
    chunk = eng._runner.chunk_step
    c0 = chunk.replays if chunk is not None else 0
    rec = record_depths(eng, floor)
    try:
        comps, wall, blocks_run, per_tick = serve_checked(eng, reqs)
    finally:
        rec["close"]()
    run = finish_run(eng, n, label, comps, wall, g0)
    run.update(blocks_run=blocks_run, per_tick=per_tick, dispatch_log=rec["dispatches"],
               bad=rec["bad"], adaptive=eng.adaptive_stats(), kv=eng.kv_stats(),
               chunk_replays=chunk.replays - c0 if chunk is not None else 0)
    return run


def adaptive_phase(cfg, model, params, dvi, base: dict) -> dict:
    """Phase 12b: phase 8's graphed continuous path (ample pool, its 16
    requests) with adaptive depth: pinned at K (== phase 8 bit for bit), the
    default controller (k_min A_KMIN, k_max A_KMAX), and an adversarial
    swing over phase 8's tight pool.  Returns the runs."""
    from repro_torch.core import spec
    from repro_torch.core.schedule import DepthConfig
    K, k, L = cfg.dvi.k_spec, cfg.dvi.split_layer, cfg.num_layers
    reqs = continuous_requests(cfg)
    runs = {}
    for mode, floor, kw in (("pinned", K, dict(depth_cfg=DepthConfig(k_min=K, k_max=K,
                                                                     k_init=K))),
                            ("controller", A_KMIN, dict(k_min=A_KMIN, k_max=A_KMAX))):
        label = f"adaptive {mode}"
        r = runs[mode] = adaptive_run(model, params, dvi, reqs, C_PAGES_AMPLE, label, floor, **kw)
        widths = sorted({kb for kb, _ in r["dispatch_log"]})
        want = {"paged_decode_attention": sum(n * ((kb + 1) * k + (L - k))
                                              for kb, n in r["dispatch_log"]),
                "lora_logits": sum(n * (kb + 1) for kb, n in r["dispatch_log"]),
                "verify_argmax": r["blocks_run"], "decode_attention": 0, "ssd_scan": 0}
        g, a, kv = r["graph"], r["adaptive"], r["kv"]
        phase(12, f"{label}: {len(r['comps'])} requests in {r['wall']:.3f} s, {r['steps']} "
                  f"block-steps, {r['dispatches']} dispatches, {r['host_syncs']} host syncs, "
                  f"draft widths dispatched {widths}, mean depth {a['mean_depth']:.3f}, draft "
                  f"efficiency {a['draft_efficiency']:.4f}, drafted {r['drafted']}, lanes out of "
                  f"[k_min, k_cap] {r['bad']}, used pages at the end {kv['used_pages']}, "
                  f"captures {g['captures']}, syncs per tick {r['per_tick']} (0 inside every "
                  f"dispatch)")
        phase(12, f"{label}: launches {r['launches']}; expected {want} (per block {k} K_blk + "
                  f"{L} paged_decode_attention, K_blk + 1 lora_logits, 1 verify_argmax)")
        check(r["launches"] == want, f"{label}: the launches disagree with the formula")
        check(not r["bad"], f"{label}: a lane's depth left [k_min, k_cap]")
        check(r["host_syncs"] == r["dispatches"], f"{label}: host syncs != dispatches")
        check(kv["used_pages"] == 0, f"{label}: pages left in use")
        check(g["captures"] <= A_KMAX - A_KMIN + 1, f"{label}: {g['captures']} captures")
        check_census(12, label, g)
        r["profile"] = profile_batch(r["eng"], reqs, r["wall"] * 1e3, n=12)
        release(r)
    pin = runs["pinned"]
    same = (streams(pin["comps"]) == streams(base["comps"]) and pin["drafted"] == base["drafted"]
            and pin["blocks"] == base["blocks"])
    phase(12, f"pinned (k_min = k_max = k_init = {K}) == phase 8's graphed run bit for bit "
              f"(streams, drafted {pin['drafted']} / {base['drafted']}, blocks {pin['blocks']} / "
              f"{base['blocks']}): {same}")
    check(same, "pinned adaptive depth differs from fixed K")
    check(len({kb for kb, _ in runs["controller"]["dispatch_log"]}) >= 1
          and runs["controller"]["adaptive"]["mean_depth"] < K,
          "the default controller never lowered the depth")
    against_frozen(model, params, spec, reqs, runs["controller"]["comps"], base["comps"],
                   "adaptive controller", n_phase=12)

    # the adversarial swing: lanes admitted at depth 1 climb every block
    dc = DepthConfig(k_min=1, k_max=K, k_init=1, cooldown=1, hi=0.1, lo=0.05, ema_init=0.9)
    pages = base["tight_pages"]
    while True:
        eng = continuous_engine(model, params, dvi, pages, True, adaptive_k=True, depth_cfg=dc)
        comps, wall, _, per_tick = serve_checked(eng, reqs)
        kv, a = eng.kv_stats(), eng.adaptive_stats()
        phase(12, f"adaptive swing over a tight pool of {pages} pages: {len(comps)} requests in "
                  f"{wall:.3f} s, {kv['preemptions']} preemptions, mean depth "
                  f"{a['mean_depth']:.3f}, used pages at the end {kv['used_pages']}, syncs per "
                  f"tick max {max(per_tick)}")
        check(kv["used_pages"] == 0, "the swing left pages in use")
        check(a["mean_depth"] > 1.0, "the swing never rose above depth 1")
        if kv["preemptions"] >= 1 or pages <= eng._mps:
            break
        pages -= 1
        del eng
        release({})
    check(kv["preemptions"] >= 1, "the swing never preempted")
    del eng
    release({})
    against_frozen(model, params, spec, reqs, comps, base["comps"],
                   f"adaptive swing ({pages} pages)", n_phase=12)
    for mode, r in list(runs.items()) + [("phase 8 fixed K", base)]:
        steps, g, p = max(r["steps"], 1), r["graph"], r["profile"]
        depth = (f"mean depth {r['adaptive']['mean_depth']:.3f}, draft efficiency "
                 f"{r['adaptive']['draft_efficiency']:.4f}" if "adaptive" in r else
                 f"mean depth {r['drafted'] / max(r['blocks'], 1):.3f}, draft efficiency "
                 f"{r['committed'] / max(r['drafted'], 1):.4f}")
        phase(12, f"{mode}: wall per block-step {1e3 * r['wall'] / steps:.2f} ms, device "
                  f"{p['device_ms']:.2f} ms a block-step, busy {100 * p['busy']:.1f}%, "
                  f"{r['committed'] / r['wall']:.1f} committed tokens/s, {depth}, "
                  f"{g['captures']} captures, graph pool {g['pool_bytes'] / 2**30:.3f} GiB, peak "
                  f"memory {r['peak'] / 2**30:.2f} GiB")
    runs["swing_pages"] = pages
    return runs


# ---------------------------------------------------------------------------
# phase 13: chunked prefill in the continuous engine
# ---------------------------------------------------------------------------

def chunked_want(cfg, blocks: int, chunks: int, dispatch_log=None, updates: int = 0) -> dict:
    """The launch formula of a chunked vicuna path: phase 8's per block (or
    12b's at each dispatched draft width), 2 ``lora_logits`` an update, and
    one ``paged_decode_attention`` a layer per chunk step (the first
    chunk's prefill at admission runs no kernel of the port)."""
    K, k, L = cfg.dvi.k_spec, cfg.dvi.split_layer, cfg.num_layers
    log = dispatch_log or [(K, blocks)]
    return {"paged_decode_attention": sum(n * ((kb + 1) * k + (L - k)) for kb, n in log)
            + L * chunks,
            "lora_logits": sum(n * (kb + 1) for kb, n in log) + 2 * updates,
            "verify_argmax": blocks, "decode_attention": 0, "ssd_scan": 0}


def mid_prefill_preemptions(eng) -> list:
    """Record, per preemption, whether the victim lane was mid-prefill."""
    seen, inner = [], eng._preempt

    def preempt(slot):
        seen.append(eng._slots[slot].pf_pos is not None)
        inner(slot)

    eng._preempt = preempt
    return seen


def chunk_figures(eng) -> dict:
    """A drained chunked engine's chunk counters, its chunk graph's figures,
    its tick percentiles and the lanes it left occupied."""
    step = eng._runner.chunk_step
    return dict(chunks=eng.stats["prefill_chunks"], chunk_tokens=eng.stats["prefill_tokens"],
                max_tick=eng.stats["max_tick_prefill_tokens"], ticks=eng.tick_percentiles(),
                lanes_left=eng.active_slots,
                chunk_graph=dict(nodes=step.nodes, capture_s=step.capture_s,
                                 instantiate_s=step.instantiate_s,
                                 replay_us=1e6 * step.replay_host_s / max(step.replays, 1)))


def chunk_gates(n: int, label: str, r: dict, want: dict, graphed: bool) -> None:
    """The gates every chunked run holds: the launch formula, the chunk
    budget, host syncs == dispatches, the pool or the lanes empty, and
    (graphed) one chunk graph replay a chunk step."""
    phase(n, f"{label}: {len(r['comps'])} requests in {r['wall']:.3f} s, {r['steps']} "
             f"block-steps ({r['blocks_run']} blocks run), {r['dispatches']} dispatches, "
             f"{r['host_syncs']} host syncs, {r['chunks']} chunk steps ({r['chunk_replays']} "
             f"graph replays) of {r['chunk_tokens']} prompt tokens, largest tick "
             f"{r['max_tick']} tokens (budget {C_SLOTS * P_CHUNK}), "
             f"{r['kv'].get('preemptions', 0)} preemptions ({r['mid']} mid-prefill), used "
             f"pages at the end {r['kv'].get('used_pages', 0)}, lanes left {r['lanes_left']}, "
             f"syncs per tick {r['per_tick']} (0 inside every dispatch and chunk step)")
    phase(n, f"{label}: launches {r['launches']}; expected {want}")
    check(r["launches"] == want, f"{label}: the launches disagree with the formula")
    check(r["chunks"] > 0 and 0 < r["max_tick"] <= C_SLOTS * P_CHUNK,
          f"{label}: the chunk budget was not held")
    check(r["host_syncs"] == r["dispatches"], f"{label}: host syncs != dispatches")
    check(r["kv"].get("used_pages", 0) == 0 and r["lanes_left"] == 0,
          f"{label}: pages or lanes left in use")
    check(not graphed or r["chunk_replays"] == r["chunks"],
          f"{label}: chunk steps were not one graph replay each")


def schema_gate(eng, n: int, label: str) -> None:
    """The port's copy of the metrics schema gate
    (``scripts/torch_check_metrics_schema.py``) on the drained engine's
    snapshot and on its Prometheus text."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_check_metrics_schema", os.path.join(ROOT, "scripts",
                                                   "torch_check_metrics_schema.py"))
    chk = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chk)
    errs = (chk.check_snapshot(eng.metrics_snapshot(), "snapshot")
            + chk.check_snapshot(chk.parse_prometheus_text(eng.render_prometheus()),
                                 "prometheus"))
    phase(n, f"{label}: scripts/torch_check_metrics_schema.py on the snapshot and the "
             f"Prometheus text: {len(chk.REQUIRED)} required metrics, errors {errs}")
    check(errs == [], f"{label}: the metrics schema gate failed")


def chunked_phase(cfg, model, params, dvi, base: dict, paged_row, vocab_rows) -> dict:
    """Phase 13 (a, b, d) on vicuna-7b: phase 8's continuous path with
    prompts prefilled in chunks of P_CHUNK over the ample pool (graphed and
    eager), a tight pool swung down until a lane is preempted, and the
    ample pool with learning and adaptive depth.  `base` is phase 8's
    graphed ample run.  Returns the runs."""
    from repro_torch.core import graphs, spec
    K, k, L = cfg.dvi.k_spec, cfg.dvi.split_layer, cfg.num_layers
    reqs = continuous_requests(cfg)
    expect = {"paged_decode_attention": path_attention_ms(paged_row, K, k, L),
              "verify_argmax": vocab_rows["verify_argmax"]["ms"],
              "lora_logits": vocab_rows["lora_logits"]["ms"]}
    runs = {}
    # (a): the ample pool, eager and graphed
    for mode, on in MODES:
        label = f"chunked {mode}, ample pool"
        r = runs[mode] = continuous_run(model, params, dvi, reqs, on, C_PAGES_AMPLE, 13, label,
                                        prefill_chunk=P_CHUNK)
        chunk_gates(13, label, r, chunked_want(cfg, r["blocks_run"], r["chunks"]), on)
        if on:
            schema_gate(r["eng"], 13, label)
            r["profile"] = profile_batch(r["eng"], reqs, r["wall"] * 1e3, n=13, expect=expect)
        release(r)
    g, e = runs["graphed"], runs["eager"]
    same = streams(g["comps"]) == streams(e["comps"])
    phase(13, f"chunked, ample pool: graphed streams bit-identical to eager ones: {same} "
              f"({len(g['comps'])} completions)")
    check(same, "chunked: graphed streams differ from eager ones")
    check_census(13, "chunked graphed", g["graph"])
    g["ticks_host"] = tick_phases(model, params, dvi, reqs, C_PAGES_AMPLE, 13,
                                  "vicuna-7b chunked, ample pool", prefill_chunk=P_CHUNK)
    check_against_ar(model, params, spec, reqs, g["comps"], "chunked ample pool", n_phase=13)
    g["equal_one_shot"] = sum(streams(g["comps"])[u] == v for u, v in
                              streams(base["comps"]).items())
    phase(13, f"chunked ample pool: {g['equal_one_shot']} of {len(reqs)} completions equal "
              f"phase 8's one-shot streams")

    # (b): the tight pool, swung down from phase 8's until a lane is preempted
    pages = base["tight_pages"]
    while True:
        eng = continuous_engine(model, params, dvi, pages, True, prefill_chunk=P_CHUNK)
        mid = mid_prefill_preemptions(eng)
        comps_t, wall_t, _, per_tick_t = serve_checked(eng, reqs)
        del eng._preempt
        kv_t = eng.kv_stats()
        phase(13, f"chunked graphed, tight pool of {pages} pages: {len(comps_t)} requests in "
                  f"{wall_t:.3f} s, {kv_t['preemptions']} preemptions ({sum(mid)} mid-prefill), "
                  f"{eng.stats['prefill_chunks']} chunk steps, peak {kv_t['peak_used_pages']} "
                  f"pages, used pages at the end {kv_t['used_pages']}, syncs per tick max "
                  f"{max(per_tick_t)}")
        check(kv_t["used_pages"] == 0 and eng.active_slots == 0,
              "chunked tight pool: pages or lanes left in use")
        check(eng.stats["host_syncs"] == eng.stats["dispatches"],
              "chunked tight pool: host syncs != dispatches")
        check(0 < eng.stats["max_tick_prefill_tokens"] <= C_SLOTS * P_CHUNK,
              "chunked tight pool: the chunk budget was not held")
        if kv_t["preemptions"] >= 1 or pages <= eng._mps:
            break
        pages -= 1
        del eng
        release({})
    check(kv_t["preemptions"] >= 1, "chunked: the tight pool never preempted")
    del eng
    release({})
    runs["tight"] = dict(pages=pages, preemptions=kv_t["preemptions"], mid=sum(mid))
    against_frozen(model, params, spec, reqs, comps_t, g["comps"],
                   f"chunked tight pool ({pages} pages)", n_phase=13,
                   what="the chunked ample pool's")

    # (d): the ample pool with learning and adaptive depth (ROADMAP 12.6)
    label = "chunked, learning, adaptive"
    r = runs["learn_adaptive"] = adaptive_run(
        model, params, dvi, reqs, C_PAGES_AMPLE, label, A_KMIN, n=13, state=learn_state(model),
        learn=True, update_every=L_UPDATE_EVERY, lr=L_LR, mode=L_MODE, k_min=A_KMIN,
        k_max=A_KMAX, prefill_chunk=P_CHUNK)
    eng = r["eng"]
    r.update(chunk_figures(eng), mid=0, updates=eng.stats["updates"])
    want = chunked_want(cfg, r["blocks_run"], r["chunks"], r["dispatch_log"], r["updates"])
    chunk_gates(13, label, r, want, True)
    at_home = graphs.drafter_ptrs(eng.state.dvi_params) == eng._runner.drafter
    phase(13, f"{label}: {r['updates']} updates, draft widths dispatched "
              f"{sorted({kb for kb, _ in r['dispatch_log']})}, mean depth "
              f"{r['adaptive']['mean_depth']:.3f}, lanes out of [k_min, k_cap] {r['bad']}, "
              f"A and B at their addresses: {at_home}, captures {r['graph']['captures']}")
    check(r["updates"] > 0 and at_home and not r["bad"],
          f"{label}: no update, a rebound drafter or a depth out of its range")
    check_census(13, label, r["graph"])
    schema_gate(eng, 13, label)
    r["profile"] = profile_batch(eng, reqs, r["wall"] * 1e3, n=13)
    release(r)
    against_frozen(model, params, spec, reqs, r["comps"], base["comps"], label, n_phase=13,
                   what="phase 8's one-shot fixed-K streams")
    return runs


def report_chunked(label: str, r: dict, base: dict) -> None:
    """One line of a chunked run's figures, beside the one-shot run `base`."""
    steps, p, cg, t = max(r["steps"], 1), r["profile"], r["chunk_graph"], r["ticks"]
    dev = ("device not profiled" if p is None else
           f"device {p['device_ms']:.2f} ms a block-step, busy {100 * p['busy']:.1f}%")
    phase(13, f"{label}: wall per block-step {1e3 * r['wall'] / steps:.2f} ms, {dev}, "
              f"{r['committed'] / r['wall']:.1f} committed tokens/s, tick p50 "
              f"{1e3 * t['p50_s']:.2f} / p95 {1e3 * t['p95_s']:.2f} / max "
              f"{1e3 * t['max_s']:.2f} ms over {t['count']} ticks, chunk graph "
              f"{cg['nodes']} nodes (capture {cg['capture_s']:.2f} s, instantiate "
              f"{cg['instantiate_s']:.3f} s, replay() {cg['replay_us']:.1f} us on the host), "
              f"graph pool {r['graph']['pool_bytes'] / 2**30:.3f} GiB, peak memory "
              f"{r['peak'] / 2**30:.2f} GiB allocated; one-shot: wall "
              f"{1e3 * base['wall'] / max(base['steps'], 1):.2f} ms, device "
              f"{base['profile']['device_ms']:.2f} ms a block-step, "
              f"{base['committed'] / base['wall']:.1f} tokens/s, tick p50 "
              f"{1e3 * base['ticks']['p50_s']:.2f} / p95 {1e3 * base['ticks']['p95_s']:.2f} / max "
              f"{1e3 * base['ticks']['max_s']:.2f} ms over {base['ticks']['count']} ticks")


# ---------------------------------------------------------------------------
# phase 14: the prefix cache behind the HTTP front end, and the launchers
# ---------------------------------------------------------------------------

def http_requests(cfg) -> list:
    """Phase 14a's requests as ``load_gen.run_request`` records (see
    H_TENANTS): 32 new tokens each, streamed."""
    rng = np.random.RandomState(SEED + 14)
    systems = [rng.randint(2, cfg.vocab_size, size=H_SYS) for _ in range(H_TENANTS)]
    recs = []
    for i in range(H_WAVES * H_WAVE):
        if i in H_REPEATS:
            prompt = list(recs[H_REPEATS[i]]["prompt"])
        else:
            n = 8 + i if i < H_TENANTS else int(rng.randint(8, 41))
            prompt = [int(t) for t in np.concatenate(
                [systems[i % H_TENANTS], rng.randint(2, cfg.vocab_size, size=n)])]
        recs.append(dict(idx=i, prompt=prompt, max_new=MAX_NEW, tenant=f"tenant{i % H_TENANTS}",
                         cancel_after=H_CANCEL_AFTER if i == H_CANCEL else None))
    return recs


def indexed_pages(pool, tokens) -> int:
    """How many full pages of `tokens` the pool's prefix index still holds,
    read without a lookup (which would count and retain)."""
    ps, parent, n = pool.page_size, 0, 0
    while (n + 1) * ps <= len(tokens):
        page = pool._index.get((parent, tuple(int(t) for t in tokens[n * ps:(n + 1) * ps])))
        if page is None:
            break
        parent, n = page, n + 1
    return n


def instrument_server(eng, model) -> dict:
    """Gates the server's engine holds on its driver thread: every superstep
    dispatch, chunk step, drafter update and warm admission runs under sync
    debug mode "error" (the handler threads run no CUDA); each dispatch's
    blocks are logged, each warm admission's uid, whether it was wholly
    cached, and the prefill calls and port kernel launches it made, and the
    host seconds the profiler window's close took."""
    from repro_torch.kernels import ops
    log = dict(iters=[], warm=[], prefills=count_prefills(model))

    def strict(fn):
        def run(*a, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return run

    inner_dispatch, inner_warm = strict(eng._dispatch_superstep), strict(eng._admit_warm)
    inner_finish = eng._profile_finish
    log["window_close_s"] = []

    def profile_finish():
        closing = eng._profile is not None and eng._profile_left <= 0
        t0 = time.perf_counter()
        inner_finish()
        if closing:
            log["window_close_s"].append(time.perf_counter() - t0)

    def dispatch():
        inner_dispatch()
        log["iters"].append(eng._inflight[0].iters)

    def admit_warm(slot, uid, prompt, hit, need, live):
        n0, l0 = log["prefills"][0], sum(ops.launches.values())
        inner_warm(slot, uid, prompt, hit, need, live)
        log["warm"].append(dict(uid=uid, live=live, cow=hit.cow_tokens > 0, tokens=hit.hit_tokens,
                                prefills=log["prefills"][0] - n0,
                                launches=sum(ops.launches.values()) - l0))

    eng._dispatch_superstep, eng._admit_warm = dispatch, admit_warm
    eng._profile_finish = profile_finish
    eng._advance_prefill = strict(eng._advance_prefill)
    eng._dispatch_update = strict(eng._dispatch_update)
    return log


def profile_window(prof_dir: str, blocks: int) -> dict:
    """The engine's profiler window, read from the Chrome trace it wrote
    (which must hold its superstep ranges): the device time some kernel ran
    in it (``covered_ms``; the window's chunk steps and admissions
    included), over the window's wall (its first superstep range to its
    last event) and over the blocks its dispatches ran; None where the
    trace holds no kernel."""
    path = os.path.join(prof_dir, "superstep_trace.json")
    check(os.path.exists(path), f"phase 14: the profiler window wrote no trace ({path})")
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    ranges = [e for e in evs if e.get("name") == "superstep" and e.get("ph") == "X"
              and e.get("cat") != "gpu_user_annotation"]
    kernels = [(e["ts"], e["ts"] + e["dur"]) for e in evs
               if e.get("cat") == "kernel" and e.get("ph") == "X"]
    check(len(ranges) == H_PROFILE_STEPS,
          f"phase 14: the profiler window holds {len(ranges)} superstep ranges (want "
          f"{H_PROFILE_STEPS})")
    start = min(e["ts"] for e in ranges)
    end = max(e["ts"] + e.get("dur", 0) for e in evs if "ts" in e)
    busy = covered_ms(kernels) if kernels else None
    return dict(ranges=len(ranges), kernels=len(kernels), wall_ms=(end - start) / 1e3,
                device_ms=None if busy is None else busy / max(blocks, 1),
                busy=None if busy is None else busy / max((end - start) / 1e3, 1e-9))


def profiler_warmup() -> None:
    """Start and stop a profiler of the card once on the calling thread."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros((1,), device=DEV).add_(1)
        torch.cuda.synchronize()


def send_waves(port: int, recs: list) -> float:
    """Send the records wave by wave, the 8 of a wave at once, each streamed
    over SSE by ``load_gen.run_request``; a wave starts when the last has
    ended.  Returns the wall seconds."""
    import threading

    from repro_torch.launch import load_gen
    t0 = time.perf_counter()
    for w in range(H_WAVES):
        threads = [threading.Thread(target=load_gen.run_request,
                                    args=("127.0.0.1", port, r, H_TIMEOUT))
                   for r in recs[w * H_WAVE:(w + 1) * H_WAVE]]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    return time.perf_counter() - t0


def http_prefix_phase(cfg, model, params, dvi, t13: dict) -> dict:
    """Phase 14a: vicuna-7b served through ``serving.http.make_server`` with
    the prefix cache (8 lanes, 152 pages of 16, chunks of 32, supersteps of
    4, learning on), its graphs captured on the driver's thread before any
    traffic; a first request, whose first dispatches the profiler window
    spans, then phase 14a's requests over SSE.  `t13` is phase 13a's
    traced host ms by tick phase.  Returns the run's figures."""
    import argparse
    import shutil
    import threading
    import types

    from repro_torch.core import spec
    from repro_torch.kernels import ops
    from repro_torch.launch import load_gen
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.http import make_server
    label = "HTTP, prefix cache"
    recs = http_requests(cfg)
    prof_dir = os.path.join(ROOT, "build", "phase14_profile")
    shutil.rmtree(prof_dir, ignore_errors=True)
    eng = ServingEngine(model, params, learn_state(model), scheduler="continuous",
                        num_slots=C_SLOTS, max_new=MAX_NEW, kv_pages=C_PAGES_AMPLE,
                        kv_page_size=C_PAGE, sync_every=C_SYNC, prefill_chunk=P_CHUNK,
                        prefix_cache=True, learn=True, update_every=L_UPDATE_EVERY, lr=L_LR,
                        mode=L_MODE, telemetry=True, profile_dir=prof_dir,
                        profile_steps=H_PROFILE_STEPS)
    srv = make_server("127.0.0.1", 0, eng, model_id="vicuna-7b", default_max_new=MAX_NEW,
                      request_timeout_s=H_TIMEOUT)
    t0 = time.perf_counter()
    srv.driver.call(eng.warmup, timeout=H_TIMEOUT)
    capture_s = time.perf_counter() - t0
    # the profiler's first start on a thread initialises CUPTI there, seconds
    # once (PR 22's first run: most of a 13 s run); pay it before the traffic
    # so that the window's latencies are its steady cost
    t0 = time.perf_counter()
    srv.driver.call(profiler_warmup, timeout=H_TIMEOUT)
    prof_init_s = time.perf_counter() - t0
    log = instrument_server(eng, model)
    th = threading.Thread(target=srv.serve_forever, kwargs={"poll_interval": 0.05}, daemon=True)
    th.start()
    try:
        # one request of a tenant of its own first: the profiler window
        # spans its first dispatches, so that the window's close (the
        # profiler's stop and its trace export, in a harvest) does not
        # stall the timed waves; then the counters start afresh
        rng = np.random.RandomState(SEED + 15)
        first = dict(idx=-1, prompt=[int(t) for t in rng.randint(2, cfg.vocab_size, size=64)],
                     max_new=MAX_NEW, tenant="warmup", cancel_after=None)
        load_gen.run_request("127.0.0.1", srv.server_address[1], first, H_TIMEOUT)
        while srv.driver.call(lambda: eng.busy):
            time.sleep(0.05)
        check(first["outcome"] == "completed" and log["window_close_s"],
              f"{label}: the first request did not complete ({first.get('error')}) or the "
              f"profiler window did not close")
        win = profile_window(prof_dir, sum(log["iters"][:H_PROFILE_STEPS]))
        srv.driver.call(eng.reset_stats)
        since = srv.driver.call(eng.clock)
        log.update(iters=[], warm=[])
        log["prefills"][0] = 0
        reset_counts()
        g0 = eng.graph_stats()
        wall = send_waves(srv.server_address[1], recs)
        deadline = time.monotonic() + H_TIMEOUT
        while srv.driver.call(lambda: eng.busy) and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        srv.shutdown()
        srv.server_close()
        srv.driver.stop(drain=True)
        th.join(timeout=30.0)
        del model.prefill                # the class's method again
    check(srv.driver.crashed is None, f"{label}: the engine's thread crashed: "
                                      f"{srv.driver.crashed!r}")
    torch.cuda.synchronize()
    st, kv, g = eng.stats, eng.kv_stats(), eng.graph_stats()
    launches = dict(ops.launches)
    check_fast_loader(ops, 14, label)
    by_out = {o: [r for r in recs if r["outcome"] == o] for o in
              ("completed", "cancelled", "rejected", "error")}
    phase(14, f"{label}: {len(recs)} requests in {H_WAVES} waves of {H_WAVE} over SSE in "
              f"{wall:.3f} s (graphs captured on the driver's thread in {capture_s:.2f} s and the "
              f"profiler started there once in {prof_init_s:.2f} s, before the server took "
              f"traffic): "
              + ", ".join(f"{len(v)} {o}" for o, v in by_out.items())
              + f"; errors {[r.get('error') for r in by_out['error']][:3]}")
    check(len(by_out["completed"]) == len(recs) - 1 and len(by_out["cancelled"]) == 1
          and recs[H_CANCEL]["outcome"] == "cancelled",
          f"{label}: every request but the one whose client left must complete")

    # the prefix cache's counters, and the warm admissions themselves
    prefix = {k: st[k] for k in ("prefix_lookups", "prefix_hits", "prefix_misses",
                                 "prefix_hit_tokens", "prefix_cow_copies", "prefix_evictions")}
    warm = log["warm"]
    full = [w for w in warm if w["live"]]
    phase(14, f"{label}: prefix stats {prefix}; {len(warm)} warm admissions ({len(full)} wholly "
              f"cached, {sum(w['cow'] for w in warm)} copied a page on write), each spliced "
              f"{sorted({w['tokens'] for w in warm})} cached tokens; prefill calls and port "
              f"kernel launches inside them {sorted({(w['prefills'], w['launches']) for w in warm})}; "
              f"{log['prefills'][0]} prefill calls in the run")
    check(prefix["prefix_hits"] > 0 and prefix["prefix_cow_copies"] > 0 and full
          and prefix["prefix_hits"] + prefix["prefix_misses"] == prefix["prefix_lookups"],
          f"{label}: no hit, no copy on write, no wholly cached admission, or counters that "
          f"do not reconcile")
    check(all(w["prefills"] == 0 and w["launches"] == 0 for w in warm),
          f"{label}: a warm admission ran a prefill or launched a kernel")
    check(len(warm) == prefix["prefix_hits"] and log["prefills"][0] == prefix["prefix_misses"],
          f"{label}: admissions and lookups disagree (no admission waited at the watermark "
          f"on this ample pool)")
    schema_gate(eng, 14, label)

    # the launch formula, the graphs, syncs, the pool at the end
    blocks = sum(log["iters"])
    want = chunked_want(cfg, blocks, st["prefill_chunks"], updates=st["updates"])
    phase(14, f"{label}: {st['dispatches']} dispatches ({blocks} blocks run), {st['host_syncs']} "
              f"host syncs, {st['prefill_chunks']} chunk steps of {st['prefill_tokens']} prompt "
              f"tokens, {st['updates']} updates, {st['cancelled']} cancelled; launches "
              f"{launches}; expected {want}")
    check(launches == want, f"{label}: the launches disagree with the formula")
    check(st["host_syncs"] == st["dispatches"] and st["cancelled"] == 1,
          f"{label}: host syncs != dispatches, or the cancel was not honoured")
    check_census(14, label, g)
    phase(14, f"{label}: at the end {kv['used_pages']} pages used, {kv['cached_pages']} cached "
              f"(evictable), {kv['free_pages']} free of {kv['num_pages']}, lanes left "
              f"{eng.active_slots}, indexed pages {kv['indexed_pages']}")
    check(kv["used_pages"] == 0 and eng.active_slots == 0
          and kv["free_pages"] + kv["cached_pages"] == kv["num_pages"],
          f"{label}: pages beyond the evictable cached ones, or lanes, left in use")
    cut = recs[H_CANCEL]
    kept = indexed_pages(eng._pool, cut["prompt"][:H_SYS])
    phase(14, f"{label}: the client of request {H_CANCEL} left after {len(cut['tokens'])} "
              f"tokens; its tenant's system prompt still holds {kept} indexed pages")
    check(kept == H_SYS // C_PAGE, f"{label}: the cancelled lane's shared pages left the cache")

    # the streams: each == the engine called directly without the cache, or AR
    direct = continuous_engine(model, params, dvi, C_PAGES_AMPLE, True, prefill_chunk=P_CHUNK)
    for r in recs:
        direct.submit_request(Request(uid=r["idx"], prompt=np.asarray(r["prompt"], np.int32),
                                      max_new=r["max_new"]))
    d_streams = streams(direct.run())
    del direct
    release({})
    equal = [r["idx"] for r in by_out["completed"] if r["tokens"] == d_streams[r["idx"]]]
    others = [r for r in by_out["completed"] if r["idx"] not in equal]
    ar_memo = {}
    as_req = {r["idx"]: Request(uid=r["idx"], prompt=np.asarray(r["prompt"], np.int32),
                                max_new=r["max_new"]) for r in recs}
    prefix_ok = (cut["tokens"] == d_streams[H_CANCEL][:len(cut["tokens"])]
                 or cut["tokens"] == capped(ar_alone(model, params, spec, as_req[H_CANCEL],
                                                    ar_memo), MAX_NEW)[:len(cut["tokens"])])
    phase(14, f"{label}: {len(equal)} of {len(by_out['completed'])} SSE streams equal the "
              f"engine called directly without the prefix cache; the cancelled stream is an "
              f"exact prefix of it (or of AR alone): {prefix_ok}")
    check(prefix_ok, f"{label}: the cancelled request's tokens are no prefix of its stream")
    if others:
        check_against_ar(model, params, spec, [as_req[r["idx"]] for r in others],
                         [types.SimpleNamespace(uid=r["idx"], gen_tokens=np.asarray(r["tokens"]))
                          for r in others], f"{label}, SSE streams unlike the direct ones",
                         n_phase=14, alone=True, ar_memo=ar_memo)

    # reported: latency, host and device figures
    ns = argparse.Namespace(requests=len(recs), rate=0.0, arrivals="waves",
                            tenants=",".join(f"tenant{i}:1" for i in range(H_TENANTS)),
                            cancel_fraction=1 / len(recs), slo_ttft=2.0, slo_e2e=30.0,
                            workload_seed=SEED + 14, smoke=False)
    rep = load_gen.build_report(ns, recs, wall)
    ticks, admits = traced_ticks(eng, since)
    warm_uids = {w["uid"] for w in warm}
    warm_ms = [ms for uid, ms in admits if uid in warm_uids]
    cold_ms = [ms for uid, ms in admits if uid not in warm_uids]
    steps = max(st["steps"], 1)
    replays = g["replays"] - g0["replays"]
    step = eng._runner.chunk_step
    phase(14, f"{label}: TTFT p50 {1e3 * rep['ttft']['p50_s']:.1f} / p95 "
              f"{1e3 * rep['ttft']['p95_s']:.1f} ms, e2e p50 {1e3 * rep['e2e']['p50_s']:.1f} / p95 "
              f"{1e3 * rep['e2e']['p95_s']:.1f} ms (load_gen.build_report over "
              f"{rep['ttft']['count']} completed); wall {1e3 * wall / steps:.2f} ms a block-step "
              f"({st['steps']} block-steps), {st['committed'] / wall:.1f} committed tokens/s; "
              f"profiler window of {win['ranges']} dispatches (the first request alone, one "
              f"lane; its close held the engine {log['window_close_s'][0]:.2f} s in a harvest): "
              f"{win['kernels']} kernels, "
              + ("device not measured (no kernel in the trace)" if win["busy"] is None else
                 f"device {win['device_ms']:.2f} ms a block-step (its chunk steps and admissions "
                 f"included), busy {100 * win['busy']:.1f}% of its {win['wall_ms']:.1f} ms"))
    phase(14, f"{label}: host ms an admission: warm {np.mean(warm_ms) if warm_ms else 0.0:.2f} "
              f"({len(warm_ms)}), cold {np.mean(cold_ms) if cold_ms else 0.0:.2f} "
              f"({len(cold_ms)}); replay() "
              f"{1e3 * (g['replay_host_s'] - g0['replay_host_s']) / max(replays, 1):.2f} host ms "
              f"a replay ({replays} replays, the chunk step's "
              f"{1e3 * step.replay_host_s / max(step.replays, 1):.2f}); host ms a block-step by "
              f"tick phase under the server: "
              + ", ".join(f"{k} {v:.2f}" for k, v in ticks.items())
              + "; phase 13a's: " + ", ".join(f"{k} {t13[k]:.2f}" for k in ticks))
    return dict(launches=launches, prefix=prefix, report=rep, equal=len(equal),
                completed=len(by_out["completed"]), warm_ms=warm_ms, cold_ms=cold_ms,
                ticks=ticks, window=win, wall=wall, steps=st["steps"])


def free_port() -> int:
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def launchers_phase() -> dict:
    """Phase 14b: the launchers on the card, each in a process of its own on
    the tiny vicuna-7b (float32): ``launch.serve`` with the prefix cache;
    ``launch.api_server`` driven by ``launch.load_gen --verify-direct``
    (PYTHONHASHSEED pinned on both sides), then SIGTERM.  Each must exit 0,
    the streams equal the direct engine's, and the server print its drain
    line.  Returns the wall seconds of each."""
    import signal
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), PYTHONHASHSEED="0")
    # the launchers' own default is the card; a rehearsal on the CPU names it
    spec_args = ["--tiny", "--pretrain-steps", "20"] + ([] if DEV == "cuda" else ["--device", DEV])
    out = {}
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *spec_args,
                          "--scheduler", "continuous", "--kv-pages", "64", "--prefill-chunk",
                          "16", "--prefix-cache", "--requests", "16"],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=LAUNCH_TIMEOUT)
    out["serve"] = time.perf_counter() - t0
    for line in run.stdout.splitlines():
        phase(14, f"serve: {line}")
    check(run.returncode == 0 and "[serve] prefix cache: hits=" in run.stdout,
          f"launch.serve exited {run.returncode}: {run.stderr[-2000:]}")

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    log_path = os.path.join(ROOT, "build", "api_server.log")
    report = os.path.join(ROOT, "build", "load_gen.json")
    port = free_port()
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        srv = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.api_server", *spec_args,
                                "--port", str(port)], env=env, cwd=ROOT, stdout=log,
                               stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + LAUNCH_TIMEOUT
        while time.monotonic() < deadline and srv.poll() is None:
            with open(log_path) as f:
                if "[api] serving on" in f.read():
                    break
            time.sleep(0.2)
        check(srv.poll() is None, f"api_server exited early: {open(log_path).read()[-2000:]}")
        gen = subprocess.run([sys.executable, "-m", "repro_torch.launch.load_gen", *spec_args,
                              "--port", str(port), "--requests", "8", "--verify-direct",
                              "--json", report], env=env, cwd=ROOT, capture_output=True,
                             text=True, timeout=LAUNCH_TIMEOUT)
        for line in gen.stdout.splitlines():
            phase(14, f"load_gen: {line}")
        check(gen.returncode == 0, f"load_gen exited {gen.returncode}: {gen.stderr[-2000:]}")
        with open(report) as f:
            verify = json.load(f)["verify"]
        check(verify["checked"] == 8 and verify["mismatches"] == 0,
              f"load_gen --verify-direct: {verify}")
        srv.send_signal(signal.SIGTERM)
        rc = srv.wait(timeout=LAUNCH_TIMEOUT)
    finally:
        if srv.poll() is None:
            srv.kill()
            srv.wait()
    out["api_server"] = time.perf_counter() - t0
    with open(log_path) as f:
        text = f.read()
    for line in text.splitlines():
        phase(14, f"api_server: {line}")
    check(rc == 0 and "[api] drained; exit 0" in text, f"api_server exited {rc} after SIGTERM")
    phase(14, f"launchers: serve {out['serve']:.1f} s, api_server with load_gen "
              f"{out['api_server']:.1f} s, each exited 0; verify-direct {verify['checked']} "
              f"streams, {verify['mismatches']} mismatches")
    return out


# ---------------------------------------------------------------------------
# phase 9: mamba2-370m through both schedulers
# ---------------------------------------------------------------------------

def count_prefills(model) -> list:
    """Count the model's prefill calls (each runs one ssd_scan per SSM layer)
    in a one-element list, by wrapping ``model.prefill``."""
    calls = [0]
    inner = model.prefill

    def prefill(*a, **kw):
        calls[0] += 1
        return inner(*a, **kw)

    model.prefill = prefill
    return calls


def mamba_want(cfg, blocks: int, prefills: int) -> dict:
    """The launch formula of the mamba2 paths: per block 5 lora_logits, 1
    verify_argmax and no attention or scan; one ssd_scan per layer per
    prefill call."""
    return {"decode_attention": 0, "paged_decode_attention": 0,
            "lora_logits": (cfg.dvi.k_spec + 1) * blocks, "verify_argmax": blocks,
            "ssd_scan": cfg.num_layers * prefills}


def engine_rows_cache(model, params, req, chunk: int = 0) -> dict:
    """`req`'s prompt but its last token prefilled as the continuous engine
    prefills it, in lane 0 of a C_SLOTS-lane contiguous cache: alone (B = 1)
    and spliced in, or with `chunk` as the chunked engine does, its first
    `chunk` tokens alone and the rest in chunk steps of (C_SLOTS, chunk)
    tokens that advance lane 0 alone."""
    from repro_torch.models import transformer as tfm
    prompt = torch.as_tensor(req.prompt, device=DEV)
    n = len(req.prompt) - 1
    c1 = min(chunk, n) if chunk else n
    _, pc = model.prefill(params, prompt[None, :c1], max_len=c1)   # the engine's scratch
    cache = tfm.insert_slot(model.cfg, model.init_cache(C_SLOTS, len(req.prompt) + req.max_new
                                                        + tfm.RING_SLACK), pc, 0)
    pos = c1
    while pos < n:
        take = min(chunk, n - pos)
        blk = torch.zeros((C_SLOTS, chunk), dtype=torch.int32, device=DEV)
        blk[0, :take] = prompt[pos:pos + take]
        lanes = torch.zeros((C_SLOTS,), dtype=torch.int32, device=DEV)
        lanes[0] = take
        model.prefill_chunk(params, blk, cache, lanes)
        pos += take
    return cache


def ar_at_engine_rows(model, params, req, chunk: int = 0, cache=None, top2_at: int = None):
    """Greedy AR of `req` decoded as the continuous engine decodes it: from
    the cache of ``engine_rows_cache`` (or `cache`, one it built, which the
    decode advances in place), one-token blocks of ``spec_block_step`` at
    K = 0 with ar_generate's zero draft adapter, the other lanes masked
    done.  Every matrix product then runs at the engine's row counts, so in
    bf16 it rounds as the engine's does; ar_generate on the prompt alone
    runs its decode products at one row.  Returns the generated tokens, or
    with `top2_at` = p the top-2 logits of its pick of token p (the greedy
    stream's first p tokens decoded first)."""
    from repro_torch.core import spec
    cfg = model.cfg
    dvi0 = {"A": torch.zeros((cfg.d_model, 1), device=DEV),
            "B": torch.zeros((1, cfg.vocab_size), device=DEV)}
    if cache is None:
        cache = engine_rows_cache(model, params, req, chunk)
    pending = torch.zeros((C_SLOTS,), dtype=torch.int32, device=DEV)
    pending[0] = int(req.prompt[-1])
    done = torch.arange(C_SLOTS, device=DEV) > 0
    out = []
    while len(out) < (req.max_new if top2_at is None else top2_at) and 1 not in out:
        blk = spec.spec_block_step(model, params, dvi0, pending, cache, k_spec=0, done=done)
        pending, cache = blk.pending, blk.cache
        out.append(int(blk.commit_vec[0, 0]))
    if top2_at is None:
        return out
    h, _, _ = model.step(params, model.embed_block(params, pending[:, None], cache["lengths"]),
                         cache)
    top = model.logits(params, h[0:1, -1]).float().topk(2, dim=-1).values[0]
    return float(top[0]), float(top[1])


def float32_model(model, params):
    """The model and its weights cast up to float32 (every floating leaf)."""
    from repro_torch.models.model import build_model

    def up(t):
        if isinstance(t, dict):
            return {k: up(v) for k, v in t.items()}
        return t.float() if torch.is_tensor(t) and t.is_floating_point() else t
    return build_model(model.cfg.replace(dtype="float32"), device=DEV), up(params)


def ssm_state_errors(cfg, cache, ref_cache) -> dict:
    """Lane 0's SSM conv windows and states in `cache` against `ref_cache`'s
    lane 0: the largest relative Frobenius error over the layers of each."""
    from repro_torch.models import transformer as tfm
    out = {"conv": 0.0, "state": 0.0}
    for seg in tfm.model_segments(cfg):
        if seg.kind != "ssm":
            continue
        for key in out:
            a = cache["segs"][seg.name][key][:, 0].float()
            b = ref_cache["segs"][seg.name][key][:, 0].float()
            err = ((a - b).flatten(1).norm(dim=1) / b.flatten(1).norm(dim=1).clamp_min(1e-30))
            out[key] = max(out[key], float(err.max()))
    return out


def chunk_witness(model, params, spec, f32: dict, n_phase: int, label: str):
    """The witness for a chunked completion that differs from AR beyond a
    bf16 near-tie, which uses no chunk step on one side of any comparison:
    (1) in float32 (the weights cast up, in `f32`, made at first use), where
    rounding no longer flips a greedy pick, the chunked path's stream at the
    engine's row counts equals ``ar_generate`` of the prompt alone (one-shot
    prefill), or first differs at a float32 near-tie (F32_GAP_RTOL); (2) the
    float32 chunk-built SSM states and conv windows equal one-shot
    ``prefill``'s within F32_STATE_RTOL a layer; (3) the bf16 chunk-built
    ones are no further from the float32 one-shot ones than BF16_STATE_RATIO
    times bf16 one-shot ``prefill``'s.  Returns witness(request, got) ->
    bool, for ``check_against_ar``."""
    def one_shot(m, p, req):
        return m.prefill(p, torch.as_tensor(req.prompt[None, :-1], device=DEV))[1]

    def witness(req, got) -> bool:
        if not f32:
            f32["model"], f32["params"] = float32_model(model, params)
            f32["memo"] = {}
        m32, p32 = f32["model"], f32["params"]
        o32 = one_shot(m32, p32, req)
        c32 = engine_rows_cache(m32, p32, req, P_CHUNK)
        e32 = ssm_state_errors(m32.cfg, c32, o32)          # before the decode moves c32
        e16 = ssm_state_errors(model.cfg, engine_rows_cache(model, params, req, P_CHUNK), o32)
        e16_one = ssm_state_errors(model.cfg, one_shot(model, params, req), o32)
        states_ok = (max(e32.values()) <= F32_STATE_RTOL
                     and all(e16[k] <= BF16_STATE_RATIO * e16_one[k] for k in e16))
        chunked = ar_at_engine_rows(m32, p32, req, cache=c32)
        alone = capped(ar_alone(m32, p32, spec, req, f32["memo"]), req.max_new)
        p = next((j for j, (a, b) in enumerate(zip(chunked, alone)) if a != b), None)
        if p is None:
            streams_ok, why = chunked == alone, f"equal: {chunked == alone}"
        else:
            prefix = torch.as_tensor(np.concatenate([req.prompt, alone[:p]]).astype(np.int64),
                                     device=DEV)[None]
            t1, t2 = top2_gap(m32, p32, prefix)
            streams_ok = t1 - t2 <= F32_GAP_RTOL * max(abs(t1), 1.0)
            why = f"first differ at token {p}, float32 top-2 gap {t1 - t2:.4e}"
        phase(n_phase, f"{label}: request {req.uid}, float32 witness: the chunked path at the "
                       f"engine's row counts vs AR of the prompt alone: {why}; largest "
                       f"relative error a layer, chunk-built vs one-shot float32: state "
                       f"{e32['state']:.3e}, conv {e32['conv']:.3e}; against the float32 "
                       f"one-shot, bf16 chunk-built: state {e16['state']:.3e}, conv "
                       f"{e16['conv']:.3e}, bf16 one-shot: state {e16_one['state']:.3e}, conv "
                       f"{e16_one['conv']:.3e}; holds: {streams_ok and states_ok}")
        return streams_ok and states_ok
    return witness


def mamba_phase(by_row):
    """Phase 9.  Returns the graphed sync and continuous runs' launch counts,
    the eager ones', and the graphed runs' busy shares."""
    from repro_torch.configs import get_config
    from repro_torch.core import lora, spec
    from repro_torch.models.model import build_model
    cfg = get_config(M_NAME).replace(num_layers=M_LAYERS)
    model = build_model(cfg, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    t0 = time.perf_counter()
    params = model.init(gen)
    dvi = lora.init_draft_params(gen, cfg)
    dvi["B"] = torch.randn(dvi["B"].shape, generator=gen, device=DEV) * 0.05
    torch.cuda.synchronize()
    n_par = sum(p.numel() for s in params["segments"].values() for p in s.values())
    phase(9, f"{M_NAME} bf16 params drawn on the card in {time.perf_counter() - t0:.1f} s "
             f"({cfg.num_layers} of its 48 layers, {n_par / 1e6:.1f}M in segments, tied head "
             f"{tuple(params['lm_head'].shape)})")
    prefills = count_prefills(model)
    expect = {name: by_row[name]["at_mamba2"]["ms"]
              for name in ("verify_argmax", "lora_logits")}
    per_prefill = {"ssd_scan": cfg.num_layers}

    # ---- sync scheduler: bucket-padded prompts ----
    reqs = make_requests(cfg)
    sync = sync_modes(
        model, params, dvi, reqs, 9, f"{M_NAME} sync", prefills=prefills,
        want=lambda r: mamba_want(cfg, r["steps"], r["prefills"]),
        profile=lambda r: profile_batch(
            r["eng"], reqs, r["wall"] * 1e3, n=9, per_call=per_prefill,
            expect=dict(expect, ssd_scan=by_row["ssd_scan"]["ms"])))

    # ---- continuous scheduler, contiguous layout: exact prompts ----
    creqs = continuous_requests(cfg)
    ar_memo: dict = {}                 # phase 13c reuses these AR streams
    cont = continuous_modes(
        model, params, dvi, creqs, 0, 9, f"{M_NAME} continuous", prefills=prefills,
        want=lambda r: mamba_want(cfg, r["blocks_run"], r["prefills"]),
        profile=lambda r: profile_batch(
            r["eng"], creqs, r["wall"] * 1e3, n=9, per_call=per_prefill,
            expect=dict(expect, ssd_scan=by_row["ssd_scan"]["at_admission"]["ms"])),
        same_shape=lambda q: ar_at_engine_rows(model, params, q), ar_memo=ar_memo)
    tick_phases(model, params, dvi, creqs, 0, 9, f"{M_NAME} continuous")

    # ---- phase 13c: chunked prefill on the contiguous continuous engine ----
    t13 = time.perf_counter()
    label = f"{M_NAME} chunked graphed (contiguous)"
    r = continuous_run(model, params, dvi, creqs, True, 0, 13, label, prefills=prefills,
                       prefill_chunk=P_CHUNK)
    chunk_gates(13, label, r, mamba_want(cfg, r["blocks_run"], r["prefills"]), True)
    phase(13, f"{label}: {r['prefills']} first-chunk admissions, {cfg.num_layers} ssd_scan "
              f"each; 0 attention launches in {r['chunks']} chunk steps")
    check(r["prefills"] == C_REQUESTS, f"{label}: {r['prefills']} admissions")
    check_census(13, label, r["graph"])
    r["profile"] = profile_batch(r["eng"], creqs, r["wall"] * 1e3, n=13, per_call=per_prefill,
                                 expect=dict(expect, ssd_scan=by_row["ssd_scan"]
                                             ["at_chunk_admission"]["ms"]))
    release(r)
    report_chunked(label, r, base=cont["graphed"])
    r["equal_one_shot"] = against_frozen(
        model, params, spec, creqs, r["comps"], cont["graphed"]["comps"], label, n_phase=13,
        what="phase 9's one-shot streams", alone=True, ar_memo=ar_memo,
        witness=chunk_witness(model, params, spec, {}, 13, label))
    phase(13, f"{label}: phase 13c took {time.perf_counter() - t13:.1f} s")
    return (sync["graphed"]["launches"], cont["graphed"]["launches"],
            sync["eager"]["launches"], cont["eager"]["launches"], r)


# ---------------------------------------------------------------------------
# phase 16: the hybrid and MoE decoders
# ---------------------------------------------------------------------------

def ring_launches(cfg, paged: bool) -> tuple:
    """(decode_attention, paged_decode_attention) launches of one block: a
    layer of the draft path [0, k) runs once a feed (K + 1 feeds), a layer
    of the target path once in the verify pass; local layers read their
    rings through decode_attention's ring form, global layers go through
    paged_decode_attention on a paged engine; RG-LRU layers launch no
    attention, nor do MLA layers (the absorbed form is plain PyTorch, as the
    reference's is jnp)."""
    from repro_torch.models import transformer as tfm
    K, k = cfg.dvi.k_spec, cfg.dvi.split_layer
    dec = pag = 0
    if cfg.mla is not None:
        return dec, pag
    for seg in tfm.model_segments(cfg):
        times = seg.n * (K + 1 if seg.start < k else 1)
        if seg.kind == "local" or (seg.kind == "attn" and not paged):
            dec += times
        elif seg.kind == "attn":
            pag += times
    return dec, pag


def hybrid_want(cfg, blocks: int, paged: bool) -> dict:
    """The launch formula of the phase-16 paths: per block the ring and
    global attention launches of ``ring_launches``, K + 1 lora_logits and
    one verify_argmax; prefill runs no kernel of the port (its attention
    and scans are plain PyTorch, as the reference's are jnp)."""
    dec, pag = ring_launches(cfg, paged)
    return {"decode_attention": dec * blocks, "paged_decode_attention": pag * blocks,
            "lora_logits": (cfg.dvi.k_spec + 1) * blocks, "verify_argmax": blocks,
            "ssd_scan": 0}


def n_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(n_params(v) for v in tree.values())
    return tree.numel()


def n_bytes(tree, leaves=None) -> int:
    """Bytes of a tensor or a tree's tensors: every one, or the leaves
    named in `leaves`."""
    if not isinstance(tree, dict):
        return tree.numel() * tree.element_size()
    return sum(n_bytes(v, leaves) for k, v in tree.items()
               if isinstance(v, dict) or leaves is None or k in leaves)


def block_weight_bytes(cfg, params, lanes: int = N_REQUESTS) -> int:
    """Bytes of weights (and cross K/V) one block-step reads: each layer of
    the draft path [0, k) once a feed (K + 1 feeds), each later layer once
    (the verify pass; the MoE FFN computes every expert, an RG-LRU block
    reads its weights once a pass), and the vocab head once a draft feed and
    once in the verify pass.  A cross layer's ``wk_x`` / ``wv_x`` are read
    at prefill only; each read of the layer reads instead its cross K/V of
    `lanes` lanes of F frames (the encoder's output, ``xk`` / ``xv``)."""
    from repro_torch.models import transformer as tfm
    K, k = cfg.dvi.k_spec, cfg.dvi.split_layer
    total = n_bytes(params["lm_head"]) * (K + 2)
    for seg in tfm.model_segments(cfg):
        sp = params["segments"][seg.name]
        per = n_bytes(sp)
        if seg.cross:
            per += (2 * seg.n * lanes * cfg.encoder.num_frames * cfg.num_heads
                    * cfg.resolved_head_dim * sp["wk_x"].element_size()
                    - n_bytes(sp["wk_x"]) - n_bytes(sp["wv_x"]))
        total += per * (K + 1 if seg.start < k else 1)
    return total


def draw(cfg, n: int):
    """The model of `cfg` on the card with random weights (in its dtype)
    and a LoRA drafter drawn from SEED, as phase 4 draws vicuna's."""
    from repro_torch.core import lora
    from repro_torch.models.model import build_model
    model = build_model(cfg, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    t0 = time.perf_counter()
    params = model.init(gen)
    dvi = lora.init_draft_params(gen, cfg)
    dvi["B"] = torch.randn(dvi["B"].shape, generator=gen, device=DEV) * 0.05
    torch.cuda.synchronize()
    wb = block_weight_bytes(cfg, params)
    phase(n, f"{cfg.name} {cfg.dtype} params drawn on the card in {time.perf_counter() - t0:.1f} s "
             f"({cfg.num_layers} layers, {n_params(params) / 1e9:.2f}B parameters, "
             f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated; layer kinds "
             f"{cfg.layer_pattern}); a block-step reads {wb / 1e9:.2f} GB of weights, "
             f"{1e3 * wb / HBM_BYTES_PER_S:.2f} ms at {HBM_BYTES_PER_S / 1e12:.2f} TB/s")
    return model, params, dvi


def hybrid_phase(by_row) -> tuple:
    """Phase 16: (a) recurrentgemma-9b at full width, R_LAYERS layers, through the
    sync engine (phase 4's requests, the graphed run profiled; then R_LONG
    lanes of prompts longer than its rings, so the prefill takes the
    wrapped ring write and decoding wraps) and the contiguous continuous
    engine (phase 8's requests and one prompt past the ring), then phase
    19b on the same weights (``int8_hybrid_phase``) and its float32
    witness (``rg_int8_witness``); (b) ``llama4_phase``.
    Returns each path's eager and graphed runs (their launch counts), and
    19b's graphed runs."""
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import Request
    out = {}
    t0 = time.perf_counter()
    cfg = get_config(R_NAME).replace(num_layers=R_LAYERS)
    check(ring_launches(cfg, False) == (R_LAYERS // 3, 0),
          f"{R_NAME} at {R_LAYERS} layers: {ring_launches(cfg, False)} attention launches a "
          f"block, expected {R_LAYERS // 3} ring launches (the draft layers [0, 2) are RG-LRU)")
    model, params, dvi = draw(cfg, 16)
    reqs = make_requests(cfg)
    # all 12 ring launches a block are the verify pass's (Tq = K + 1)
    expect = {"decode_attention": by_row["decode_attention"][f"at_ring_rg_tq{cfg.dvi.k_spec + 1}"]
              ["ms"], "verify_argmax": by_row["verify_argmax"]["at_rg_t40"]["ms"],
              "lora_logits": by_row["lora_logits"]["at_rg"]["ms"]}
    sync = sync_modes(model, params, dvi, reqs, 16, f"{R_NAME} sync",
                      want=lambda r: hybrid_want(cfg, r["steps"], paged=False),
                      profile=lambda r: profile_batch(r["eng"], reqs, r["wall"] * 1e3, n=16,
                                                      expect=expect))
    rng = np.random.RandomState(SEED + 16)
    C = cfg.local_window + 128
    long_reqs = [Request(uid=100 + i, prompt=rng.randint(
        2, cfg.vocab_size, size=int(rng.randint(*R_LONG_PROMPTS))).astype(np.int32),
        max_new=MAX_NEW) for i in range(R_LONG + 1)]
    phase(16, f"{R_NAME} long prompts of {[len(r.prompt) for r in long_reqs]} tokens against "
              f"rings of {C} slots: the prefill keeps the last {C} positions, the decode wraps")
    check(all(len(r.prompt) > C for r in long_reqs), "the long prompts do not pass the ring")
    long_ = sync_modes(model, params, dvi, long_reqs[:R_LONG], 16, f"{R_NAME} sync long",
                       want=lambda r: hybrid_want(cfg, r["steps"], paged=False),
                       buckets=(R_BUCKET,), batch_size=R_LONG)
    creqs = continuous_requests(cfg) + long_reqs[R_LONG:]
    cont = continuous_modes(model, params, dvi, creqs, 0, 16, f"{R_NAME} continuous",
                            want=lambda r: hybrid_want(cfg, r["blocks_run"], paged=False),
                            engine_kw=dict(cache_len=R_BUCKET + MAX_NEW + 256),
                            same_shape=lambda q: ar_at_engine_rows(model, params, q))
    out.update(recurrentgemma_sync=sync, recurrentgemma_long=long_,
               recurrentgemma_continuous=cont)
    phase(16, f"16a ({R_NAME}) took {time.perf_counter() - t0:.1f} s")
    q19b = int8_hybrid_phase(cfg, model, params, dvi, reqs, long_reqs[:R_LONG])
    del model, params, dvi
    release({})
    WITNESSES.append(("19b", lambda: rg_int8_witness(cfg, reqs, long_reqs[:R_LONG])))
    out.update(llama4_phase())
    return out, q19b


def llama4_phase() -> dict:
    """Phase 16b: llama4-scout-17b-a16e at full width, L4_LAYERS layers,
    through the paged continuous engine, then ``llama4_witness``.  A bf16
    completion that differs from AR beyond a near-tie is held by that
    witness: top-1 routing turns rounding into a discrete choice (where the
    engine's rows and AR's one-token steps differ in their last bits, a
    token's router can pick another expert, and every later token reads
    that token's K/V), so bf16 streams part at positions whose own top-2
    gap is wide."""
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    cfg = get_config(L4_NAME).replace(num_layers=L4_LAYERS)
    periods = L4_LAYERS // 4            # (local x 3, attn); the draft path is 2 local layers
    check(ring_launches(cfg, True) == (2 * (cfg.dvi.k_spec + 1) + 3 * periods - 2, periods),
          f"{cfg.name} at {L4_LAYERS} layers: {ring_launches(cfg, True)} launches a block, "
          f"expected 2(K+1) + {3 * periods - 2} ring and {periods} paged")
    model, params, dvi = draw(cfg, 16)
    label = f"{L4_NAME} ({L4_LAYERS} layers) continuous"
    deferred = []

    def defer(req, got) -> bool:
        deferred.append(req.uid)
        phase(16, f"{label}: request {req.uid} differs beyond a bf16 near-tie: held by the "
                  f"float32 witness of the same engine below")
        return True
    creqs = continuous_requests(cfg)
    runs = continuous_modes(model, params, dvi, creqs, C_PAGES_AMPLE, 16, label,
                            want=lambda r: hybrid_want(cfg, r["blocks_run"], paged=True),
                            witness=defer)
    del model, params, dvi
    release({})
    WITNESSES.append(("16b", lambda: llama4_witness(creqs, deferred)))
    phase(16, f"16b ({L4_NAME}, {L4_LAYERS} of 48 layers) took {time.perf_counter() - t0:.1f} s "
              f"(its witness runs with 19c)")
    return {"llama4_continuous": runs}


def llama4_witness(reqs, deferred: list) -> None:
    """The float32 witness of phase 16b: llama4-scout at L4_WIT_LAYERS
    layers (one (local x 3, attn) period; 8 layers of float32 weights,
    73.4 GiB, leave no room for the engine's rings) drawn in float32 from
    SEED, through the same engine as the bf16 path (C_SLOTS lanes, the
    paged pool of C_PAGES_AMPLE pages, graphed), all of `reqs`: the launch
    formula, the census, lanes empty, host syncs == dispatches, and every
    completion equal to float32 ``ar_generate`` on its exact prompt alone
    or first different at a float32 near-tie (F32_GAP_RTOL), where rounding
    no longer moves a routing or a greedy pick."""
    from repro_torch.configs import get_config
    from repro_torch.core import spec
    t0 = time.perf_counter()
    cfg = get_config(L4_NAME).replace(num_layers=L4_WIT_LAYERS, dtype="float32")
    model, params, dvi = draw(cfg, 16)
    label = f"{L4_NAME} ({L4_WIT_LAYERS} layers, float32 witness) continuous graphed"
    phase(16, f"{label}: bf16 requests it holds: {deferred}")
    comps = witness_continuous(model, params, dvi, reqs, C_PAGES_AMPLE, 16, label)
    check_against_ar(model, params, spec, reqs, comps, label, n_phase=16, alone=True,
                     rtol=F32_GAP_RTOL)
    phase(16, f"{label}: took {time.perf_counter() - t0:.1f} s")
    del model, params, dvi
    release({})


def witness_continuous(model, params, dvi, reqs, pages: int, n: int, label: str) -> list:
    """A float32 witness's graphed continuous engine (C_SLOTS lanes; paged
    over `pages` pages, or contiguous with 0) on all of `reqs`, under
    ``serve_checked``'s zero-sync gate: well-formed completions, lanes
    empty, host syncs == dispatches, the launch formula of ``hybrid_want``
    and the census.  Returns the completions."""
    r = continuous_run(model, params, dvi, reqs, True, pages, n, label)
    eng = r["eng"]
    check_comps(r["comps"], reqs, model.cfg.vocab_size, label)
    phase(n, f"{label} ({f'paged, {pages} pages' if pages else 'contiguous'}, {C_SLOTS} lanes, "
             f"sync_every {C_SYNC}): {len(r['comps'])} requests in {r['wall']:.3f} s, "
             f"{r['dispatches']} dispatches, {r['host_syncs']} host syncs, {r['blocks_run']} "
             f"blocks run, peak memory {r['peak'] / 2**30:.2f} GiB; synchronising operations "
             f"per tick {r['per_tick']}")
    check(eng.active_slots == 0 and not eng.busy, f"{label}: lanes left occupied at the end")
    check(r["host_syncs"] == r["dispatches"], f"{label}: host syncs != dispatches")
    launch_gate(n, label, r, hybrid_want(model.cfg, r["blocks_run"], paged=pages > 0))
    check_census(n, label, r["graph"])
    del eng
    release(r)
    return r["comps"]


# ---------------------------------------------------------------------------
# phase 17: DeepSeek-V3's multi-head latent attention and MTP head
# ---------------------------------------------------------------------------

def mtp_check(model, params, reqs) -> None:
    """``mtp_logits`` once on the sync path's prefill: phase 4's prompts
    padded to 128, prefilled as the sync engine prefills them (the first
    127 tokens), the hidden states with the tokens that follow them through
    the MTP head: logits (B, 127, V), finite.  Its device ms (CUDA events,
    after one warm call) is printed."""
    prompts = torch.as_tensor(np.stack([pad_prompt(r, 128) for r in reqs]), device=DEV)
    h, _ = model.prefill(params, prompts[:, :-1])
    nxt = prompts[:, 1:]
    model.mtp_logits(params, h, nxt)                       # warm
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    logits = model.mtp_logits(params, h, nxt)
    b.record()
    b.synchronize()
    ms = a.elapsed_time(b)
    want = (len(reqs), 127, model.cfg.vocab_size)
    finite = bool(torch.isfinite(logits).all())
    phase(17, f"mtp_logits on the sync prefill's hidden states: shape {tuple(logits.shape)} "
              f"(expected {want}), {logits.dtype}, finite {finite}, {ms:.3f} device ms")
    check(tuple(logits.shape) == want and finite, "mtp_logits: wrong shape or not finite")
    del h, logits
    release({})


def deepseek_phase(by_row) -> dict:
    """Phase 17a: deepseek-v3-671b at full width, DS_LAYERS layers (3 dense,
    then MoE), bf16, with its MTP head: the sync engine (phase 4's requests,
    the graphed run profiled) and the contiguous continuous engine (phase
    8's requests), eagerly and graphed, then ``mtp_check``; then
    ``deepseek_witness``.  A bf16 completion that differs from AR beyond a
    near-tie is held by that witness: top-8 of 256 routing turns a bf16
    rounding (the engine's rows against AR's one-token steps, or a batched
    prefill's capacity drops against a prompt prefilled alone) into a
    choice of expert.  Returns each path's eager and graphed runs."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    t0 = time.perf_counter()
    cfg = get_config(DS_NAME).replace(num_layers=DS_LAYERS)
    kinds = [ffn for _, ffn in tfm.layer_kinds(cfg)]
    check(kinds == ["dense"] * 3 + ["moe"] * (DS_LAYERS - 3) and cfg.mtp_depth == 1
          and ring_launches(cfg, False) == (0, 0),
          f"{cfg.name} at {DS_LAYERS} layers: FFN kinds {kinds}, mtp_depth {cfg.mtp_depth}")
    model, params, dvi = draw(cfg, 17)
    segs = [(s.name, s.kind, s.ffn, s.n) for s in tfm.model_segments(cfg)]
    phase(17, f"{DS_NAME}: segments {segs}, MTP head {n_params(params['mtp']) / 1e9:.2f}B "
              f"parameters")
    deferred = []

    def defer(label):
        def hold(req, got) -> bool:
            deferred.append((label, req.uid))
            phase(17, f"{label}: request {req.uid} differs beyond a bf16 near-tie: held by the "
                      f"float32 witness of the same engines below")
            return True
        return hold
    reqs = make_requests(cfg)
    expect = {"verify_argmax": by_row["verify_argmax"]["at_ds_t40"]["ms"],
              "lora_logits": by_row["lora_logits"]["at_ds"]["ms"]}
    label = f"{DS_NAME} ({DS_LAYERS} layers) sync"
    sync = sync_modes(model, params, dvi, reqs, 17, label,
                      want=lambda r: hybrid_want(cfg, r["steps"], paged=False),
                      profile=lambda r: profile_batch(r["eng"], reqs, r["wall"] * 1e3, n=17,
                                                      expect=expect),
                      ar_kw=dict(alone=True, witness=defer("sync")))
    creqs = continuous_requests(cfg)
    cont = continuous_modes(model, params, dvi, creqs, 0, 17,
                            f"{DS_NAME} ({DS_LAYERS} layers) continuous",
                            want=lambda r: hybrid_want(cfg, r["blocks_run"], paged=False),
                            witness=defer("continuous"))
    mtp_check(model, params, reqs)
    del model, params, dvi
    release({})
    phase(17, f"17a ({DS_NAME}, {DS_LAYERS} of 61 layers) took {time.perf_counter() - t0:.1f} s "
              f"(its witness runs with 19c)")
    WITNESSES.append(("17", lambda: deepseek_witness(reqs, creqs, deferred)))
    return {"deepseek_sync": sync, "deepseek_continuous": cont}


def deepseek_witness(reqs, creqs, deferred: list) -> None:
    """Phase 17b, the float32 witness of 17a: deepseek-v3-671b at
    DS_WIT_LAYERS layers (3 dense + 1 MoE, no MTP head) drawn in float32
    from SEED, through the same engines graphed: the sync engine on all of
    `reqs` and the contiguous continuous engine (C_SLOTS lanes) on all of
    `creqs`.  Gates: the launch formula, the census, host syncs ==
    dispatches and lanes empty (continuous), and every completion equal to
    float32 ``ar_generate`` on its exact (sync: bucket-padded) prompt alone
    or first different at a float32 near-tie (F32_GAP_RTOL).  Its one MoE
    layer is the last, so a batched prefill's capacity drops reach no
    cache and AR alone computes the engine's function."""
    from repro_torch.configs import get_config
    from repro_torch.core import spec
    from repro_torch.serving.engine import Request
    t0 = time.perf_counter()
    cfg = get_config(DS_NAME).replace(num_layers=DS_WIT_LAYERS, dtype="float32", mtp_depth=0)
    model, params, dvi = draw(cfg, 17)
    label = f"{DS_NAME} ({DS_WIT_LAYERS} layers, float32 witness)"
    phase(17, f"{label}: bf16 requests it holds: {deferred}")
    r = sync_run(model, params, dvi, reqs, True, 17, f"{label} sync graphed")
    eng = r["eng"]
    padded = [Request(uid=q.uid, prompt=eng._pad(q, eng._bucket(len(q.prompt))),
                      max_new=q.max_new) for q in reqs]
    check_comps(r["comps"], reqs, cfg.vocab_size, f"{label} sync")
    phase(17, f"{label} sync graphed: {len(r['comps'])} requests in {r['steps']} block-steps, "
              f"wall {r['wall']:.3f} s, peak memory {r['peak'] / 2**30:.2f} GiB")
    launch_gate(17, f"{label} sync", r, hybrid_want(cfg, r["steps"], paged=False))
    check_census(17, f"{label} sync", r["graph"])
    sync_comps = r["comps"]
    del eng
    release(r)
    cont_comps = witness_continuous(model, params, dvi, creqs, 0, 17,
                                    f"{label} continuous graphed")
    check_against_ar(model, params, spec, padded, sync_comps, f"{label} sync", n_phase=17,
                     alone=True, rtol=F32_GAP_RTOL)
    check_against_ar(model, params, spec, creqs, cont_comps, f"{label} continuous",
                     n_phase=17, alone=True, rtol=F32_GAP_RTOL)
    phase(17, f"{label}: took {time.perf_counter() - t0:.1f} s")
    del model, params, dvi
    release({})


# ---------------------------------------------------------------------------
# phase 18: whisper-large-v3's encoder with cross-attention, paligemma-3b's
# patch prefix
# ---------------------------------------------------------------------------

def stub_inputs(cfg, B: int, seed: int) -> dict:
    """The modality stubs of `cfg` for B lanes, float32, drawn on the card
    from `seed`: an encoder's frame embeddings (B, F, d_enc), a vision
    prefix's patch embeddings (B, P, d_embed)."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    aux = {}
    if cfg.encoder is not None:
        e = cfg.encoder
        aux["frame_embeds"] = torch.randn((B, e.num_frames, e.d_model or cfg.d_model),
                                          generator=gen, device=DEV)
    if cfg.vision is not None:
        aux["patch_embeds"] = torch.randn((B, cfg.vision.num_patches, cfg.vision.d_embed),
                                          generator=gen, device=DEV)
    return aux


def aux_want(cfg, blocks: int) -> tuple:
    """(launches, decode_attention launches by form) of `blocks` blocks:
    ``ring_launches``' causal ones, as many non-causal ones (one cross-
    attention a decoder layer read) for an encoder config, K + 1
    lora_logits and one verify_argmax a block; prefill and the encoder
    launch no kernel of the port (plain PyTorch, as the reference's jnp)."""
    dec, _ = ring_launches(cfg, False)
    cross = dec if cfg.encoder is not None else 0
    return ({"decode_attention": (dec + cross) * blocks, "paged_decode_attention": 0,
             "lora_logits": (cfg.dvi.k_spec + 1) * blocks, "verify_argmax": blocks,
             "ssd_scan": 0},
            {"causal": dec * blocks, "ring": 0, "cross": cross * blocks})


def event_ms(fn) -> float:
    """Device ms of one call of `fn` between two CUDA events, after one
    warm call."""
    fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def aux_gates(n: int, label: str, r: dict, cfg, loader: str) -> None:
    """The launch formula and the forms of decode_attention over the run's
    block-steps, exact, and every vocab launch on `loader`."""
    want, forms = aux_want(cfg, r["steps"])
    phase(n, f"{label}: launches {r['launches']}, decode_attention by form {r['forms']}; "
             f"expected {want}, {forms}; vocab launches by loader {r['paths']} (expected "
             f"all {loader})")
    check(r["launches"] == want and r["forms"] == forms,
          f"{label}: the kernels did not run as the formula says")
    check(all(v[loader] == r["launches"][name] for name, v in r["paths"].items()),
          f"{label}: a vocab launch left the {loader} loader")


def aux_counts(res, wall: float) -> dict:
    from repro_torch.core.spec import GEN_COUNTERS
    from repro_torch.kernels import ops
    return dict(tokens=res.tokens.clone(), lengths=res.lengths.clone(), steps=res.steps,
                wall=wall, launches=dict(ops.launches), forms=dict(ops.attn_forms),
                paths={name: dict(v) for name, v in ops.vocab_paths.items()},
                peak=torch.cuda.max_memory_allocated(),
                **{name: int(getattr(res, name)) for name in GEN_COUNTERS})


def aux_model_phase(name: str, by_row: dict) -> dict:
    """Phase 18a / 18b: `name` at full width and depth in bf16 (weights, the
    drafter and the stubs drawn from SEED) on phase 4's 8 requests padded
    to B_TP, MAX_NEW new tokens, the stubs as aux_inputs:
    ``speculative_generate`` eagerly, then ``graphs.GenerateRunner``
    graphed (its block-step under sync debug mode "error"), timed, then
    profiled once more with the records gate (``profile_run``).  Gates:
    the launch formula and decode_attention's forms (``aux_gates``) on
    both, every vocab launch on the head's loader, graphed == eager bit for
    bit (streams, lengths, counters), each graph's kernel nodes == its
    capture's launches, each lane == ``ar_generate`` or a bf16 near-tie.
    Returns the runs by mode."""
    from repro_torch.configs import get_config
    from repro_torch.core import buffer as buffer_mod
    from repro_torch.core import graphs, spec
    t0 = time.perf_counter()
    cfg = get_config(name)
    model, params, dvi = draw(cfg, 18)
    K, k, L = cfg.dvi.k_spec, cfg.dvi.split_layer, cfg.num_layers
    reqs = make_requests(cfg)
    prompts = padded_prompts(reqs)
    aux = stub_inputs(cfg, N_REQUESTS, SEED + 18)
    cap = AUX_CAP + model.prefix_len()
    loader = "fast" if cfg.vocab_size * 2 % 16 == 0 else "element"
    tag = "whisper" if cfg.encoder is not None else "pg"
    label = f"18 {name}"
    # the prefill's device ms (and the encoder's alone), CUDA events
    pre_ms = event_ms(lambda: model.prefill(params, prompts[:, :-1], aux, max_len=cap))
    enc_ms = event_ms(lambda: model.encode(params, aux)) if cfg.encoder is not None else None
    phase(18, f"{label}: prefill of {N_REQUESTS} x {B_TP - 1} tokens "
              + (f"behind {model.prefix_len()} patches " if cfg.vision is not None else "")
              + f"{pre_ms:.2f} device ms"
              + (f", the encoder over {N_REQUESTS} x {cfg.encoder.num_frames} frames alone "
                 f"{enc_ms:.2f}" if enc_ms is not None else "") + f"; cache of {cap} slots")
    runs = {}
    reset_counts()
    t1 = time.perf_counter()
    res = spec.speculative_generate(model, params, dvi, prompts, MAX_NEW, cache_len=cap,
                                    aux_inputs=aux)
    torch.cuda.synchronize()
    runs["eager"] = aux_counts(res, time.perf_counter() - t1)
    del res
    aux_gates(18, f"{label} eager", runs["eager"], cfg, loader)
    runner = graphs.GenerateRunner(model, params, dvi,
                                   buffer_mod.init_buffer(cfg, device=DEV), max_new=MAX_NEW,
                                   graphs=True)
    st, step = runner.prepare(*prompts.shape)
    check(st["cache"]["segs"]["s0"]["k"].shape[2] == cap,
          f"{label}: the runner's static cache holds {st['cache']['segs']['s0']['k'].shape[2]} "
          f"slots, not {cap}")
    guard_syncs(step)
    ptrs = graphs.tensor_ptrs(st["cache"])
    reset_counts()
    g0 = runner.graph_stats()
    t1 = time.perf_counter()
    res = runner.generate(prompts, None, aux)
    torch.cuda.synchronize()
    r = runs["graphed"] = aux_counts(res, time.perf_counter() - t1)
    # the eager prefill wrote the static cache (the cross K/V too) in place
    graphs.check_ptrs(st["cache"], ptrs)
    g = runner.graph_stats()
    r.update(graph=g, replays=g["replays"] - g0["replays"],
             replay_ms=1e3 * (g["replay_host_s"] - g0["replay_host_s"])
             / max(g["replays"] - g0["replays"], 1))
    aux_gates(18, f"{label} graphed", r, cfg, loader)
    check_census(18, f"{label} graphed", g)
    att = by_row["decode_attention"]
    n_feed, n_verify = (K + 1) * k, L - k
    mix = [(n_feed, att[f"at_{tag}_tq1"]["ms"]), (n_verify, att[f"at_{tag}_tq{K + 1}"]["ms"])]
    if cfg.encoder is not None:
        mix += [(n_feed, att["at_cross_tq1"]["ms"]), (n_verify, att[f"at_cross_tq{K + 1}"]["ms"])]
    expect = {"decode_attention": sum(c * ms for c, ms in mix) / sum(c for c, _ in mix),
              "verify_argmax": by_row["verify_argmax"][f"at_{tag}_t{N_REQUESTS * (K + 1)}"]["ms"],
              "lora_logits": by_row["lora_logits"][f"at_{tag}"]["ms"]}
    r["profile"] = profile_run(lambda: runner.generate(prompts, None, aux).steps, runner.prime,
                               r["wall"] * 1e3, 18, expect=expect)
    # the block-step's own device ms: primed replays (every lane done, the
    # same kernels on the same shapes) back to back between two events
    blk_dev = event_ms(lambda: [step.prime() for _ in range(BLOCK_REPS)]) / BLOCK_REPS
    del st, step, runner, res
    release({})
    phase(18, f"{label}: the runner's static cache at its addresses after the eager prefill "
              f"wrote it: True")
    e = runs["eager"]
    same = (torch.equal(e["tokens"], r["tokens"]) and torch.equal(e["lengths"], r["lengths"])
            and all(e[key] == r[key] for key in ("steps", "blocks", "committed",
                                                 "accepted_drafts", "drafted")))
    phase(18, f"{label}: graphed GenerateRunner == eager speculative_generate bit for bit "
              f"(streams, lengths, counters): {same}")
    check(same, f"{label}: the graphed run differs from the eager one")
    r_ar = spec.ar_generate(model, params, prompts, MAX_NEW, cache_len=cap, aux_inputs=aux)
    r["equal_ar"] = lossless_lanes(model, params, r["tokens"], r["lengths"], r_ar, 18, label,
                                   aux)
    del r_ar
    steps, p = max(r["steps"], 1), r["profile"]
    wb = block_weight_bytes(cfg, params)
    for mode, x in runs.items():
        phase(18, f"{label}, {mode}: {x['steps']} block-steps in {x['wall']:.3f} s, wall "
                  f"{1e3 * x['wall'] / max(x['steps'], 1):.2f} ms a block-step (the prefill "
                  f"included), {x['committed'] / x['wall']:.1f} committed tokens/s, MAT "
                  f"{x['committed'] / max(x['blocks'], 1):.4f}, acceptance "
                  f"{x['accepted_drafts'] / max(x['drafted'], 1):.4f}; peak "
                  f"{x['peak'] / 2**30:.2f} GiB")
    phase(18, f"{label}, graphed: device busy {p['device_ms']:.3f} ms a block-step with the "
              f"window's eager prefill ({100 * p['busy']:.1f}% of the wall); a replay alone "
              f"{blk_dev:.3f} device ms (mean of {BLOCK_REPS} back to back); wall "
              f"{(1e3 * r['wall'] - pre_ms) / steps:.2f} ms a block-step less one prefill's "
              f"{pre_ms:.2f} device ms; graph "
              f"nodes {g['nodes']}, {g['captures']} captures in {g['capture_s']:.2f} s, "
              f"replay() {r['replay_ms']:.3f} host ms over {r['replays']} replays; a block-step "
              f"reads {wb / 1e9:.3f} GB of weights and cross K/V: bound "
              f"{1e3 * wb / HBM_BYTES_PER_S:.3f} ms at {HBM_BYTES_PER_S / 1e12:.2f} TB/s, "
              f"{1e3 * wb / HBM_BYTES_PER_S / blk_dev:.3f} of the device ms; "
              f"{r['equal_ar']} of {N_REQUESTS} lanes equal AR")
    r.update(prefill_ms=pre_ms, encoder_ms=enc_ms, block_device_ms=blk_dev, bytes=wb)
    train = aux_train_step(model, params, cfg)
    del model, params, dvi
    release({})
    phase(18, f"{label} took {time.perf_counter() - t0:.1f} s")
    return dict(runs, train=train)


def aux_train_step(model, params, cfg) -> dict:
    """Phase 18c: one training step of ``lm_loss`` with its aux_inputs at
    AUX_TRAIN_B x AUX_TRAIN_T tokens (each layer rematerialised), forward
    and backward, eager.  Gates: the loss finite, every gradient finite,
    the encoder's (whisper) or ``vision_proj``'s (paligemma) non-zero."""
    from repro_torch.kernels import ops
    from repro_torch.training import loss_and_grads
    gen = torch.Generator(device=DEV).manual_seed(SEED + 19)
    tokens = torch.randint(2, cfg.vocab_size, (AUX_TRAIN_B, AUX_TRAIN_T), generator=gen,
                           device=DEV, dtype=torch.int32)
    aux = stub_inputs(cfg, AUX_TRAIN_B, SEED + 20)
    reset_counts()
    t0 = time.perf_counter()
    loss, metrics, grads = loss_and_grads(model, params, tokens, remat=True, aux_inputs=aux)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    which = "encoder/" if cfg.encoder is not None else "vision_proj"
    mine = {key: g for key, g in grads.items() if key.startswith(which)}
    finite = bool(torch.isfinite(loss)) and all(bool(torch.isfinite(g).all())
                                                for g in grads.values())
    nonzero = bool(mine) and all(float(g.float().abs().sum()) > 0 for g in mine.values())
    phase(18, f"18c {cfg.name}: lm_loss at {AUX_TRAIN_B} x {AUX_TRAIN_T} tokens with its "
              f"aux_inputs, forward and backward (remat) in {ms:.1f} ms wall: loss "
              f"{float(loss):.4f}, {len(grads)} gradient leaves all finite {finite}, the "
              f"{len(mine)} {which.rstrip('/')} leaves non-zero {nonzero}; launches "
              f"{dict(ops.launches)}; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(finite and nonzero, f"18c {cfg.name}: a loss or gradient is not finite, or the "
                              f"{which} gradient is zero")
    out = dict(ms=ms, loss=float(loss), launches=dict(ops.launches))
    del loss, metrics, grads, mine
    return out


def aux_phase(by_row: dict) -> dict:
    """Phase 18: ``aux_model_phase`` on whisper-large-v3 (18a), then on
    paligemma-3b (18b), each with its training step (18c)."""
    t0 = time.perf_counter()
    out = {"whisper": aux_model_phase(W_NAME, by_row)}
    out["paligemma"] = aux_model_phase(PG_NAME, by_row)
    phase(18, f"18 took {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 11: the training path
# ---------------------------------------------------------------------------

def bits_checksum(tree) -> torch.Tensor:
    """Two sums over the raw bits of every leaf of `tree`, on the device, in
    chunks of 16 M elements: the sum of the bits read as integers and the
    sum of their squares (both wrap in int64).  Any changed bit changes
    them, barring a collision in both."""
    from repro_torch.tree import flatten
    out = []
    for p in flatten(tree).values():
        flat = p.reshape(-1).view(torch.int16 if p.element_size() == 2 else torch.int32)
        for c in flat.split(1 << 24):
            b = c.long()
            out.append(torch.stack([b.sum(), (b * b).sum()]))
    return torch.stack(out)


def pretrain_phase(ssd_backward_ms: float) -> dict:
    """Phase 11a: mamba2-370m at full width and depth (48 layers, bf16,
    weights from the seed) pretrained through the launcher (``--mode
    pretrain``) for P_STEPS steps of P_B x P_T synthetic batches.  Gates:
    step 1's gradient (its batch and weights, before the run) non-zero and
    finite in A_log, dt_bias, in_proj and conv_w of every layer; finite
    losses and gnorms; 48 ``ssd_scan`` launches a step; ``lm_head`` ==
    ``embed.T`` bit for bit at its address after every step; the
    checkpoint it writes loads back bit for bit through ``load_checkpoint``
    and ``weights.load_npz`` and holds exactly the trained tree's keys;
    then P_DESCENT steps on the first batch alone (fresh optimizer state,
    the last one under torch.profiler for its device time) cut its loss by
    at least P_DROP nats.  The streaming loss's first and last 5 steps are
    reported.  Returns the launches of the launcher's run."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import weights
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.data import TASK_CATEGORIES, SyntheticTasks
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models.model import build_model, trained_tree
    from repro_torch.training import (init_pretrain_state, lm_loss, loss_and_grads,
                                      make_pretrain_step)
    from repro_torch.tree import flatten
    cfg = get_config(M_NAME)
    L = cfg.num_layers
    model = build_model(cfg, device=DEV)
    params = model.init(torch.Generator(device=DEV).manual_seed(SEED))
    path = os.path.join(ROOT, "build", "phase11_mamba2_pretrain.npz")
    args = train.parse_args(["--arch", M_NAME, "--mode", "pretrain", "--steps", str(P_STEPS),
                             "--batch", str(P_B), "--seq", str(P_T), "--dtype", "bfloat16",
                             "--seed", str(SEED), "--ckpt", path])
    # step 1's gradient: the launcher's first batch (its stream at seed + 1)
    first = next(SyntheticTasks(cfg.vocab_size, seed=SEED).stream(
        TASK_CATEGORIES, 1, P_B, P_T, seed=SEED + 1))
    _, _, grads = loss_and_grads(model, params, torch.as_tensor(first, device=DEV))
    layers = {}
    for name in ("A_log", "dt_bias", "in_proj", "conv_w"):
        per = torch.cat([g.reshape(g.shape[0], -1).float().abs().amax(1)
                         for k, g in sorted(grads.items()) if k.endswith("/" + name)])
        fin = all(bool(torch.isfinite(g).all()) for k, g in grads.items()
                  if k.endswith("/" + name))
        layers[name] = (int((per > 0).sum()), len(per), fin)
    del grads
    phase(11, f"{M_NAME} pretraining, step 1's gradient: layers with a non-zero, finite "
              f"gradient: " + ", ".join(f"{k} {n}/{m}" + ("" if f else " (NOT FINITE)")
                                        for k, (n, m, f) in layers.items()))
    check(all(n == m == L and f for n, m, f in layers.values()),
          "a Mamba-2 layer got no gradient through the scan")
    head, ptr = params["lm_head"], params["lm_head"].data_ptr()
    rec = []

    def on_step(i, m):
        rec.append(dict(t=time.perf_counter(), loss=float(m["loss"]), gnorm=float(m["gnorm"]),
                        ssd=ops.launches["ssd_scan"],
                        head=bool(params["lm_head"] is head and head.data_ptr() == ptr
                                  and torch.equal(head, params["embed"].T))))

    reset_counts()
    t0 = time.perf_counter()
    train.run(args, model, params, on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated()
    losses, gnorms = [r["loss"] for r in rec], [r["gnorm"] for r in rec]
    per_step = [b["ssd"] - a for a, b in zip([0] + [r["ssd"] for r in rec], rec)]
    walls = [b["t"] - a["t"] for a, b in zip(rec, rec[1:])]
    first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    step_s = float(np.median(walls))
    phase(11, f"{M_NAME} pretraining through the launcher: {len(rec)} steps of {P_B} x {P_T} in "
              f"{wall:.1f} s (checkpoint included); loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
              f"mean of the first 5 {first5:.4f}, of the last 5 {last5:.4f} (drop "
              f"{first5 - last5:.4f}, reported); gnorm {gnorms[0]:.3f} -> "
              f"{gnorms[-1]:.3f}; ssd_scan launches a step {sorted(set(per_step))}; lm_head == "
              f"embed.T at its address after every step: {all(r['head'] for r in rec)}; a "
              f"step's wall (median of steps 2-{len(rec)}) {1e3 * step_s:.1f} ms, "
              f"{P_B * P_T / step_s:.0f} tokens/s; peak {peak / 2**30:.2f} GiB")
    check(len(rec) == P_STEPS and np.isfinite(losses).all() and np.isfinite(gnorms).all(),
          "pretraining gave a non-finite loss or gnorm")
    check(per_step == [L] * P_STEPS, "pretraining did not launch ssd_scan once a layer a step")
    check(all(r["head"] for r in rec), "lm_head is not embed.T at its address after a step")
    # the checkpoint: the trained tree's keys, bit for bit through both readers
    with np.load(path) as data:
        keys = set(data.files)
    want = flatten(trained_tree(cfg, params))
    back = flatten(load_checkpoint(path, trained_tree(cfg, params)))
    same = keys == set(want) and "lm_head" not in keys and all(
        torch.equal(back[k].view(-1).view(torch.uint8), v.reshape(-1).view(torch.uint8))
        for k, v in want.items())
    del back
    bridged = flatten(weights.load_npz(cfg, path, DEV))
    same_bridge = set(bridged) == set(flatten(params)) and all(
        torch.equal(bridged[k], v) for k, v in flatten(params).items())
    del bridged
    os.remove(path)
    phase(11, f"checkpoint: {len(keys)} keys == the trained tree's (no lm_head): "
              f"{keys == set(want)}; load_checkpoint bit for bit: {same}; weights.load_npz "
              f"(lm_head tied again) equal: {same_bridge}")
    check(same and same_bridge, "the pretraining checkpoint does not load back bit for bit")
    # descent: P_DESCENT steps on the first batch alone, the last profiled
    step = make_pretrain_step(model, 2e-3)
    st = init_pretrain_state(model, params)
    tokens = torch.as_tensor(first, device=DEV)
    with torch.no_grad():
        before = float(lm_loss(model, params, tokens)[0])
    seen = []
    for _ in range(P_DESCENT - 1):
        seen.append(float(step(params, st, tokens)[2]["loss"]))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, st, tokens)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    with torch.no_grad():
        after = float(lm_loss(model, params, tokens)[0])
    phase(11, f"{P_DESCENT} more steps on the first batch alone (lr 2e-3, fresh moments): its "
              f"loss {before:.4f} -> " + " ".join(f"{x:.4f}" for x in seen[1:])
              + f" -> {after:.4f} (drop {before - after:.4f}, gate >= {P_DROP})")
    check(np.isfinite(after) and before - after >= P_DROP,
          f"{P_DESCENT} steps on one batch cut its loss by {before - after:.4f} nats, "
          f"less than {P_DROP}")
    spans = [(t0, t1) for _, t0, t1 in device_events(prof)]
    dev_ms = covered_ms(spans)
    share = L * ssd_backward_ms / dev_ms
    phase(11, f"{M_NAME} pretraining step, profiled: device busy {dev_ms:.1f} ms of "
              f"{1e3 * prof_wall:.1f} ms wall ({len(spans)} device records); the scan's "
              f"backward, {L} x {ssd_backward_ms:.3f} ms (phase 3, alone) = "
              f"{L * ssd_backward_ms:.1f} ms, {100 * share:.1f}% of the step's device time")
    del st, step
    return dict(launches=counts, step_ms=1e3 * step_s, device_ms=dev_ms, peak=peak,
                drop=first5 - last5, descent=before - after, backward_share=share)


def dvi_batch_phase(model, params) -> dict:
    """Phase 11b: vicuna-7b (phases 4-10's weights) through the launcher's
    ``--mode dvi-batch --pretrain-steps 0``: D_STEPS teacher-forced drafter
    steps over D_B x D_T synthetic batches (8184 positions each).  Each step
    runs under sync debug mode "warn", its synchronising operations
    counted, between CUDA events (its device span) and host clocks.  Gates:
    the backbone's bits unchanged (``bits_checksum``); A and B changed;
    finite loss, gnorm and acc_rate every step; one ``lora_logits`` launch
    a step; 0 synchronising operations in every step after the first.
    Returns the launches."""
    import warnings

    from repro_torch.kernels import ops
    from repro_torch.launch import train
    before = bits_checksum(params)
    real = train.make_dvi_train_step
    steps, first = [], {}

    def make(*a, **kw):
        inner = real(*a, **kw)

        def step(*args):
            if not first:
                first.update({k: v.clone() for k, v in args[1].items()})
            n0 = ops.launches["lora_logits"]
            ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    ev[0].record()
                    t0 = time.perf_counter()
                    out = inner(*args)
                    host = time.perf_counter() - t0
                    ev[1].record()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            steps.append(dict(ev=ev, host=host, launches=ops.launches["lora_logits"] - n0,
                              syncs=sum("synchroniz" in str(w.message) for w in caught),
                              metrics=out[3]))
            return out
        return step

    args = train.parse_args(["--arch", "vicuna-7b", "--mode", "dvi-batch", "--pretrain-steps",
                             "0", "--steps", str(D_STEPS), "--batch", str(D_B), "--seq",
                             str(D_T), "--dtype", "bfloat16", "--seed", str(SEED)])
    reset_counts()
    train.make_dvi_train_step = make
    t0 = time.perf_counter()
    try:
        out = train.run(args, model, params)
    finally:
        train.make_dvi_train_step = real
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated()
    same_backbone = torch.equal(before, bits_checksum(params))
    dvi = out["state"].dvi_params
    moved = {k: not torch.equal(first[k], dvi[k]) for k in ("A", "B")}
    keys = ("loss", "gnorm", "acc_rate")
    vals = [{k: float(s["metrics"][k]) for k in keys} for s in steps]
    finite = all(np.isfinite(v[k]) for v in vals for k in keys)
    dev = [s["ev"][0].elapsed_time(s["ev"][1]) for s in steps]
    host = [1e3 * s["host"] for s in steps]
    syncs = [s["syncs"] for s in steps]
    phase(11, f"vicuna-7b dvi-batch through the launcher: {len(steps)} steps of {D_B} x {D_T} "
              f"({D_ROWS} positions) in {wall:.1f} s; loss {vals[0]['loss']:.4f} -> "
              f"{vals[-1]['loss']:.4f}, gnorm {vals[0]['gnorm']:.3f} -> {vals[-1]['gnorm']:.3f}, "
              f"acc_rate {vals[0]['acc_rate']:.4f} -> {vals[-1]['acc_rate']:.4f}, baseline "
              f"{float(out['baseline']):.4f}; a step (median of steps 2-{len(steps)}): host "
              f"{np.median(host[1:]):.1f} ms, device span {np.median(dev[1:]):.1f} ms (CUDA "
              f"events around the call); first step host {host[0]:.1f}, device {dev[0]:.1f}; "
              f"lora_logits launches a step {[s['launches'] for s in steps]}; synchronising "
              f"operations a step {syncs}; peak {peak / 2**30:.2f} GiB")
    phase(11, f"backbone bit-identical before and after (checksums of {before.shape[0]} "
              f"chunks): {same_backbone}; A changed {moved['A']}, B changed {moved['B']}")
    check(len(steps) == D_STEPS and finite, "dvi-batch gave a non-finite loss, gnorm or acc_rate")
    check(same_backbone, "the DVI step changed the backbone")
    check(all(moved.values()), "the DVI step left A or B unchanged")
    check(all(s["launches"] == 1 for s in steps), "dvi-batch did not launch lora_logits once a step")
    check(all(n == 0 for n in syncs[1:]), "a dvi-batch step after the first synchronised")
    del out, first
    return dict(launches=counts, host_ms=float(np.median(host[1:])),
                device_ms=float(np.median(dev[1:])), peak=peak)


def quickstart_phase() -> dict:
    """Phase 11c: ``examples/torch_quickstart.py`` on the card at its own
    (tiny, float32) size: pretraining, AR, DVI with an untrained drafter,
    the online KL->RL loop, the trained drafter against AR.  Gate: lossless
    against AR.  Returns the launches."""
    import importlib.util

    from repro_torch.kernels import ops
    spec = importlib.util.spec_from_file_location(
        "torch_quickstart", os.path.join(ROOT, "examples", "torch_quickstart.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    reset_counts()
    t0 = time.perf_counter()
    out = mod.main([])
    torch.cuda.synchronize()
    counts = dict(ops.launches)
    phase(11, f"quickstart on the card in {time.perf_counter() - t0:.1f} s: pretraining loss "
              f"{out['losses'][0]:.4f} -> {out['losses'][-1]:.4f}; lossless vs AR "
              f"{out['lossless']}; block acceptance over the first / last 8 batches "
              f"{out['block_acc'][0]:.4f} / {out['block_acc'][1]:.4f}, MAT "
              f"{out['mat'][0]:.4f} / {out['mat'][1]:.4f}; trained drafter: AR "
              f"{out['ar_s']:.3f} s against DVI {out['dvi_s']:.3f} s (AR / DVI "
              f"{out['speedup']:.3f}), MAT {out['mat_trained']:.4f}; launches {counts}")
    check(out["lossless"] is True, "the quickstart's DVI stream differs from AR")
    return dict(launches=counts, **{k: out[k] for k in ("block_acc", "mat", "speedup")})


# ---------------------------------------------------------------------------
# phase 15: the paper's baselines, and qwen2.5-14b
# ---------------------------------------------------------------------------

def guard_syncs(step) -> None:
    """Run every later call of a baseline runner's block-step (its eager
    body, or its graph's replay) under sync debug mode "error": a
    synchronising operation inside raises."""
    owner, attr = (step, "body") if step.graph is None else (step.graph, "replay")
    inner = getattr(owner, attr)

    def guarded():
        torch.cuda.set_sync_debug_mode("error")
        try:
            inner()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    setattr(owner, attr, guarded)


def baseline_run(runner, prompts, profiled: bool) -> dict:
    """One mode of a baseline runner: its block-step made (captured, when
    graphed) and every call of it under sync debug mode "error"; when
    `profiled`, one generate under torch.profiler, outside the counts, for
    the device's busy ms (the eager prefills included, as in phase 4's
    profile); then the timed generate.  Returns its figures and a copy of
    its result."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.spec import GEN_COUNTERS
    from repro_torch.kernels import ops
    _, step = runner.prepare(*prompts.shape)
    guard_syncs(step)
    device_ms = None
    if profiled:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            res = runner.generate(prompts)
            torch.cuda.synchronize()
        busy = covered_ms([(a, b) for _, a, b in device_events(prof)])
        check(busy > 0.0, "profile: the profiler saw no device time")
        device_ms = busy / max(res.steps, 1)
        del prof
    reset_counts()
    g0 = runner.graph_stats()
    t0 = time.perf_counter()
    res = runner.generate(prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    g = runner.graph_stats()
    out = dict(tokens=res.tokens.clone(), lengths=res.lengths.clone(), steps=res.steps,
               wall=wall, launches=dict(ops.launches), peak=torch.cuda.max_memory_allocated(),
               graph=g, replays=g["replays"] - g0["replays"],
               replay_ms=1e3 * (g["replay_host_s"] - g0["replay_host_s"])
               / max(g["replays"] - g0["replays"], 1),
               **{name: int(getattr(res, name)) for name in GEN_COUNTERS})
    out.update(device_ms=device_ms,
               busy=None if device_ms is None else device_ms * res.steps / (1e3 * wall))
    return out


def lossless_lanes(model, params, tokens, lengths, r_ar, n_phase: int, label: str,
                   aux_inputs=None) -> int:
    """Each lane of a greedy run (`tokens`, `lengths`) against
    ``ar_generate``'s stream `r_ar` on the same prompts (B_TP tokens, and
    the modality stubs `aux_inputs`) up to Tp + MAX_NEW; a first difference
    passes only at a bf16 near-tie of the AR top-2 logits.  Returns the
    lanes equal."""
    Tp, n, equal = B_TP, tokens.shape[0], 0
    for b in range(n):
        nb = min(int(lengths[b]), int(r_ar.lengths[b]), Tp + MAX_NEW)
        diff = (tokens[b, :nb] != r_ar.tokens[b, :nb]).nonzero()
        if len(diff) == 0:
            equal += 1
            continue
        p = int(diff[0])
        lane_aux = (None if aux_inputs is None else
                    {key: v[b:b + 1] for key, v in aux_inputs.items()})
        steps = dict(n_prompt=Tp, max_new=MAX_NEW) if model.cfg.kv_quant else {}
        t1, t2 = top2_gap(model, params, r_ar.tokens[b:b + 1, :p], aux_inputs=lane_aux, **steps)
        phase(n_phase, f"{label}: lane {b} first differs from AR at position {p}, AR top-2 "
                       f"logits {t1:.4f} / {t2:.4f}, gap {t1 - t2:.4e}")
        check(t1 - t2 <= GAP_RTOL * max(abs(t1), 1.0),
              f"{label}: lane {b} differs from AR outside a bf16 near-tie")
    phase(n_phase, f"{label}: {equal} of {n} lanes equal AR up to Tp+max_new; {n - equal} "
                   f"differ only at a bf16 near-tie (rtol {GAP_RTOL})")
    return equal


def baseline_modes(make_runner, prompts, label: str, per_block: dict, model, params,
                   r_ar) -> dict:
    """A baseline eagerly and graphed (``make_runner(graphs)``), with gates:
    the launches `per_block` times the block-steps, exact; each graph's
    kernel nodes == its capture's launches; 0 synchronising operations in a
    block-step (``guard_syncs``); graphed == eager bit for bit (streams,
    lengths, counters); every lane lossless against `r_ar`, the AR run of
    `model`.  Returns the runs by mode."""
    runs = {}
    for mode, on in MODES:
        runner = make_runner(on)
        # the eager run is not profiled (the script's time limit): it runs once, cold
        r = runs[mode] = baseline_run(runner, prompts, profiled=on)
        steps, g = max(r["steps"], 1), r["graph"]
        dev = ("device busy not profiled" if r["device_ms"] is None else
               f"device busy {r['device_ms']:.2f} ms a block-step ({100 * r['busy']:.1f}% of the "
               f"wall, the eager prefills included)")
        phase(15, f"{label}, {mode}: {r['steps']} block-steps in {r['wall']:.3f} s, wall "
                  f"{1e3 * r['wall'] / steps:.2f} ms a block-step, {dev}, "
                  f"{r['committed'] / r['wall']:.1f} committed tokens/s, MAT "
                  f"{r['committed'] / max(r['blocks'], 1):.4f}, acceptance "
                  f"{r['accepted_drafts'] / max(r['drafted'], 1):.4f}; {g['captures']} captures "
                  f"in {g['capture_s']:.2f} s, graph nodes {g['nodes']}, pool "
                  f"{g['pool_bytes'] / 2**30:.3f} GiB, replay() {r['replay_ms']:.3f} host ms "
                  f"over the timed run's {r['replays']} replays; peak {r['peak'] / 2**30:.2f} GiB; "
                  f"every block-step under sync debug mode 'error': 0 synchronising operations")
        want = {name: n * r["steps"] for name, n in per_block.items()}
        phase(15, f"{label}, {mode}: launches {r['launches']}; expected {want}")
        check(r["launches"] == want, f"{label}, {mode}: the launches disagree with the formula")
        if on:
            check_census(15, f"{label}, graphed", g)
        del runner
        release({})
    e, gr = runs["eager"], runs["graphed"]
    same = (torch.equal(e["tokens"], gr["tokens"]) and torch.equal(e["lengths"], gr["lengths"])
            and all(e[k] == gr[k] for k in ("steps", "blocks", "committed", "accepted_drafts",
                                            "drafted")))
    phase(15, f"{label}: graphed == eager bit for bit (streams, lengths, counters): {same}")
    check(same, f"{label}: the graphed run differs from the eager one")
    lossless_lanes(model, params, gr["tokens"], gr["lengths"], r_ar, 15, label)
    return runs


def per_block_launches(decode: int, verify: int, lora: int = 0) -> dict:
    return {"decode_attention": decode, "paged_decode_attention": 0, "lora_logits": lora,
            "verify_argmax": verify, "ssd_scan": 0}


def padded_prompts(reqs) -> torch.Tensor:
    return torch.as_tensor(np.stack([pad_prompt(r, B_TP) for r in reqs]), device=DEV)


def medusa_phase(model, params, reqs) -> dict:
    """Phase 15c on phase 4's vicuna-7b weights: M_HEADS Medusa-lite heads
    trained for M_STEPS steps of M_B x M_T synthetic tokens (drawn in a
    process of their own under PYTHONHASHSEED 0, so they repeat between
    runs), with gates: finite losses, the heads changed, the backbone's
    bits unchanged; then ``medusa_generate`` on phase 12a's 8 prompts
    (padded to B_TP) through ``graphs.MedusaRunner``, eagerly and graphed,
    with ``baseline_modes``' gates (2 L ``decode_attention`` and 2
    ``verify_argmax`` a block) and MAT >= M_MAT.  Returns the runs."""
    from repro_torch.core import baselines, graphs, spec
    V, L = model.cfg.vocab_size, model.cfg.num_layers
    path = os.path.join(ROOT, "build", "medusa_batches.npy")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    code = ("import sys, numpy as np; sys.path.insert(0, sys.argv[1]); "
            "from repro_torch.data.synthetic import SyntheticTasks, TASK_CATEGORIES; "
            "a = [int(x) for x in sys.argv[3:]]; "
            "np.save(sys.argv[2], np.stack(list(SyntheticTasks(a[0], seed=a[1]).stream("
            "TASK_CATEGORIES, a[2], a[3], a[4]))))")
    subprocess.run([sys.executable, "-c", code, os.path.join(ROOT, "src"), path,
                    *map(str, (V, SEED, M_STEPS, M_B, M_T))],
                   env=dict(os.environ, PYTHONHASHSEED="0"), check=True, timeout=300)
    batches = np.load(path)
    os.remove(path)
    before = bits_checksum(params)
    heads = baselines.init_medusa_heads(torch.Generator(device=DEV).manual_seed(SEED + 12),
                                        model, M_HEADS)
    w0 = heads["w1"].clone()
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    baselines.train_medusa_heads(model, params, heads, list(batches), lr=M_LR,
                                 on_step=lambda i, loss: losses.append(loss))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [float(x) for x in losses]
    changed = not torch.equal(w0, heads["w1"])
    same_backbone = torch.equal(before, bits_checksum(params))
    phase(15, f"15c Medusa-lite: {M_HEADS} heads trained {len(losses)} steps of {M_B} x {M_T} "
              f"synthetic tokens (PYTHONHASHSEED 0, batches checksum {int(batches.sum())}) in "
              f"{wall:.1f} s: loss " + " ".join(f"{x:.4f}" for x in losses)
              + f"; heads changed {changed}; backbone bit-identical {same_backbone}")
    check(len(losses) == M_STEPS and all(np.isfinite(losses)), "Medusa training: a loss is not "
                                                                "finite")
    check(changed, "Medusa training left the heads unchanged")
    check(same_backbone, "Medusa training changed the backbone")
    del w0, before
    prompts = padded_prompts(reqs)
    r_ar = spec.ar_generate(model, params, prompts, MAX_NEW)
    runs = baseline_modes(
        lambda on: graphs.MedusaRunner(model, params, heads, max_new=MAX_NEW, graphs=on),
        prompts, "15c Medusa-lite vicuna-7b", per_block_launches(2 * L, 2), model, params, r_ar)
    g = runs["graphed"]
    mat = g["committed"] / max(g["blocks"], 1)
    # the lm token is always accepted, so MAT >= 2 holds by construction;
    # the heads' own acceptance is what their training shows
    phase(15, f"15c Medusa-lite: MAT {mat:.4f} (gate >= {M_MAT}, >= 2 by construction); the "
              f"heads' own acceptance {g['accepted_drafts'] / max(g['drafted'], 1):.4f} "
              f"({g['accepted_drafts']} of {g['drafted']} head proposals); losses "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    check(mat >= M_MAT, f"Medusa-lite's MAT {mat:.4f} is below {M_MAT}")
    runs["losses"] = losses
    return runs


def sps_phase(reqs) -> dict:
    """Phases 15a and 15b: qwen3-0.6b (d 1024) drafting for qwen3-1.7b (d
    2048), both cut to Q_LAYERS of their 28 layers, bf16, random weights from SEED, K =
    SPS_K, then qwen3-0.6b drafting for itself (the same weights, two
    caches: every draft agrees until the drafter's missing d_K shifts it),
    each on phase 12a's 8 prompts padded to B_TP through
    ``graphs.TwoModelRunner`` eagerly and graphed, with ``baseline_modes``'
    gates (L_d K + L_t ``decode_attention`` and K + 1 ``verify_argmax`` a
    block).  Returns the runs by pair."""
    from repro_torch.configs import get_config
    from repro_torch.core import graphs, spec
    from repro_torch.models.model import build_model
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    t0 = time.perf_counter()
    draft = build_model(get_config("qwen3-0.6b").replace(num_layers=Q_LAYERS), device=DEV)
    d_params = draft.init(gen)
    target = build_model(get_config("qwen3-1.7b").replace(num_layers=Q_LAYERS), device=DEV)
    t_params = target.init(gen)
    torch.cuda.synchronize()
    phase(15, f"qwen3-0.6b and qwen3-1.7b at {Q_LAYERS} layers, bf16 params drawn on the card in "
              f"{time.perf_counter() - t0:.1f} s")
    prompts = padded_prompts(reqs)
    Ld, Lt = draft.cfg.num_layers, target.cfg.num_layers
    out = {}
    for key, (tm, tp), label in (
            ("sps", (target, t_params), "15a SpS qwen3-0.6b -> qwen3-1.7b"),
            ("sps_self", (draft, d_params), "15b SpS qwen3-0.6b -> itself")):
        r_ar = spec.ar_generate(tm, tp, prompts, MAX_NEW)
        out[key] = baseline_modes(
            lambda on: graphs.TwoModelRunner(tm, tp, draft, d_params, max_new=MAX_NEW,
                                             graphs=on, k_spec=SPS_K),
            prompts, label, per_block_launches(Ld * SPS_K + tm.cfg.num_layers, SPS_K + 1),
            tm, tp, r_ar)
        del r_ar
    return out


def qwen14_phase(reqs, by_row: dict) -> dict:
    """Phase 15d: qwen2.5-14b at full width and depth (48 layers, d 5120,
    ``qkv_bias``, 29.5 GB of bf16 weights from SEED) serving phase 12a's 8
    prompts padded to B_TP through the sync engine, graphed (DVI, split 2,
    a drafter drawn from the seed), then profiled once more.  Gates:
    lossless against AR by the near-tie rule; launches per block (K+1) k +
    L - k ``decode_attention``, K+1 ``lora_logits``, 1 ``verify_argmax``,
    exact; each graph's kernel nodes == its capture's launches.  Returns the
    run."""
    from repro_torch.configs import get_config
    from repro_torch.core import lora, spec
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Request
    cfg = get_config("qwen2.5-14b")
    model = build_model(cfg, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    t0 = time.perf_counter()
    params = model.init(gen)
    dvi = lora.init_draft_params(gen, cfg)
    dvi["B"] = torch.randn(dvi["B"].shape, generator=gen, device=DEV) * 0.05
    torch.cuda.synchronize()
    phase(15, f"qwen2.5-14b bf16 params drawn on the card in {time.perf_counter() - t0:.1f} s "
              f"({sum(p.numel() for p in params['segments']['s1'].values()) / 1e9:.2f}B in the "
              f"deep segment)")
    padded = [Request(uid=r.uid, prompt=pad_prompt(r, B_TP), max_new=MAX_NEW) for r in reqs]
    label = "15d qwen2.5-14b sync DVI graphed"
    r = sync_run(model, params, dvi, padded, True, 15, label)
    K, k, L, n = cfg.dvi.k_spec, cfg.dvi.split_layer, cfg.num_layers, r["steps"]
    want = {name: c * n for name, c in
            per_block_launches((K + 1) * k + (L - k), 1, K + 1).items()}
    phase(15, f"{label}: launches over {n} block-steps {r['launches']}; expected {want}")
    check(r["launches"] == want, f"{label}: the launches disagree with the formula")
    check_census(15, label, r["graph"])
    check_against_ar(model, params, spec, padded, r["comps"], label, n_phase=15)
    att = by_row["decode_attention"]
    n_feed, n_verify = (K + 1) * k, L - k
    expect = {"decode_attention": (n_feed * att["at_g5_tq1"]["ms"] + n_verify
                                   * att["at_g5_tq5"]["ms"]) / (n_feed + n_verify),
              "verify_argmax": by_row["verify_argmax"]["at_qwen25_14b_t8"]["ms"],
              "lora_logits": by_row["lora_logits"]["at_qwen25_14b"]["ms"]}
    r["profile"] = profile_batch(r["eng"], padded, r["wall"] * 1e3, n=15, expect=expect)
    steps, g, p = max(r["steps"], 1), r["graph"], r["profile"]
    phase(15, f"{label}: wall {1e3 * r['wall'] / steps:.2f} ms and device busy "
              f"{p['device_ms']:.2f} ms a block-step ({100 * p['busy']:.1f}%), "
              f"{r['committed'] / r['wall']:.1f} committed tokens/s, MAT "
              f"{r['committed'] / max(r['blocks'], 1):.4f}, acceptance "
              f"{r['eng'].acceptance:.4f}; {g['captures']} captures, graph nodes {g['nodes']}, "
              f"replay() {1e3 * g['replay_host_s'] / max(g['replays'], 1):.3f} host ms; peak "
              f"{r['peak'] / 2**30:.2f} GiB")
    release(r)
    del model, params, dvi
    return r


# ---------------------------------------------------------------------------
# phase 19: the int8 KV cache (kv_quant)
# ---------------------------------------------------------------------------

# the K/V leaves of a cache: values (model dtype or int8) and int8 scales
KV_LEAVES = ("k", "v", "ks", "vs", "kp", "vp", "ksp", "vsp")


def bytes_gate(label: str, got: int, base: int, hd: int, elt: int = 2) -> float:
    """The int8 cache's bytes against the model dtype's (`elt` bytes an
    element) at the same shapes: within 1 % of (hd + 4) / (elt hd), values
    and one float32 scale a slot and kv head against the model dtype's
    values (bf16: (hd + 4) / (2 hd))."""
    want, ratio = (hd + 4) / (elt * hd), got / base
    phase(19, f"{label}: {got / 1e9:.4f} GB int8 with scales against {base / 1e9:.4f} GB in "
              f"the model dtype at the same shapes: ratio {ratio:.5f}, (hd + 4) / ({elt} hd) = "
              f"{want:.5f}")
    check(abs(ratio / want - 1) <= 0.01, f"{label}: bytes ratio {ratio:.5f}, expected {want:.5f}")
    return ratio


def int8_gate(label: str, r: dict) -> None:
    """Every attention launch of the run read the int8 cache."""
    attn = r["launches"]["decode_attention"] + r["launches"]["paged_decode_attention"]
    phase(19, f"{label}: attention launches by K/V storage {r['attn_kv']}")
    check(attn > 0 and r["attn_kv"] == {"model": 0, "int8": attn},
          f"{label}: an attention launch did not read the int8 cache: {r['attn_kv']}")


def sync_cache_bytes(eng, cfg, leaves=None) -> tuple:
    """(int8 bytes, bf16 bytes at the same shapes) of a sync engine's static
    caches, one a batch shape: the model dtype's from ``init_cache`` on the
    meta device (what phase 4's and 16's bf16 engines allocate)."""
    from repro_torch.models import transformer as tfm
    got = base = 0
    for st, _ in eng._runner._shapes.values():
        cache = st["cache"]
        B = cache["lengths"].shape[0]
        # the capacity of full attention (a ring's is its own, fixed)
        C = next((c["k"].shape[2] for c in cache["segs"].values()
                  if "k" in c and "pos" not in c), 1)
        got += n_bytes(cache, leaves)
        base += n_bytes(tfm.init_cache(cfg, B, C, device="meta"), leaves)
    return got, base


def int8_hidden_drift(model, qmodel, params, prompts) -> float:
    """The reference test's measure: prefill all but the last K + 1 tokens,
    one block of K + 1; max |h_int8 - h_bf16| / max |h_bf16| of the
    block's hidden states."""
    K = model.cfg.dvi.k_spec
    T = prompts.shape[1] - (K + 1)
    hs = []
    for m in (model, qmodel):
        _, cache = m.prefill(params, prompts[:, :T], max_len=prompts.shape[1] + 16)
        hs.append(m.step(params, m.embed_block(params, prompts[:, T:], cache["lengths"]),
                         cache)[0].float())
    return float((hs[1] - hs[0]).abs().max() / (hs[0].abs().max() + 1e-9))


def int8_waves_run(model, params, dvi, waves, label: str, **kw) -> dict:
    """`waves` (lists of requests), each drained before the next, through one
    graphed int8 continuous engine over the ample pool (`kw` to it), each
    wave under ``serve_checked``'s zero-sync gate: host syncs == dispatches,
    no page left in use but cached ones, well-formed completions and, when
    the engine prefills in chunks, the chunked launch formula, every
    attention launch int8 and nodes == launches.  Returns the run's
    figures, its engine released."""
    eng = continuous_engine(model, params, dvi, C_PAGES_AMPLE, True, **kw)
    reset_counts()
    g0 = eng.graph_stats()
    comps, wall, blocks, per_tick = [], 0.0, 0, []
    for wave in waves:
        c, w, b, t = serve_checked(eng, wave)
        comps += c
        wall += w
        blocks += b
        per_tick += t
    r = finish_run(eng, 19, label, comps, wall, g0)
    r.update(blocks_run=blocks, per_tick=per_tick, stats=dict(eng.stats), kv=eng.kv_stats())
    check(r["host_syncs"] == r["dispatches"] and r["kv"]["used_pages"] == 0,
          f"{label}: host syncs != dispatches, or pages left in use")
    check_comps(comps, [q for wave in waves for q in wave], model.cfg.vocab_size, label)
    if kw.get("prefill_chunk"):
        launch_gate(19, label, r, chunked_want(model.cfg, blocks, eng.stats["prefill_chunks"]))
        int8_gate(label, r)
        check_census(19, label, r["graph"])
    del eng
    release(r)
    return r


def first_difference(label: str, uid, got: list, want: list) -> int:
    """Where two streams of one request first differ (both must run past it)."""
    p = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), min(len(got), len(want)))
    check(p < min(len(got), len(want)), f"{label}: request {uid} stops at {len(got)}, the "
                                        f"stream it is held to at {len(want)}")
    return p


def int8_prefix_waves(model, params, dvi, cfg) -> dict:
    """Phase 19a's chunked path with the prefix cache: the first 2 of phase
    14a's 3 waves of 8 requests of 4 tenants (system prompts of H_SYS
    tokens; wave 2 hits and copies the tenants' partial pages on write),
    Q_NEW new tokens each, through ``int8_waves_run``: the int8 engine with
    chunks of P_CHUNK and the prefix cache (warm), the same engine without
    the cache (cold) and with one-shot admission.  Gates: hits and a copy
    on write; each warm completion == the cold one or the near-tie rule
    under int8 AR; each cold completion == the one-shot one or first
    different at a near-tie of int8 AR (chunked prefill attends the
    dequantised cache, one-shot prefill in full precision: in the reference
    too they are different functions), the others held by
    ``int8_chunk_witness``, which runs every time: the chunked path against
    a reference outside the engine.  Returns the warm run's figures."""
    from repro_torch.serving.engine import Request
    recs = http_requests(cfg)
    waves = [[Request(uid=r["idx"], prompt=np.asarray(r["prompt"], np.int32), max_new=Q_NEW)
              for r in recs[w * H_WAVE:(w + 1) * H_WAVE]] for w in range(Q_WAVES)]
    reqs = [r for wave in waves for r in wave]
    out = {name: int8_waves_run(model, params, dvi, waves, f"int8 {name}", **kw)
           for name, kw in (("chunked warm", dict(prefill_chunk=P_CHUNK, prefix_cache=True)),
                            ("chunked cold", dict(prefill_chunk=P_CHUNK)), ("one-shot", {}))}
    st = out["chunked warm"]["stats"]
    phase(19, f"int8 prefix cache: lookups {st['prefix_lookups']}, hits {st['prefix_hits']}, "
              f"hit tokens {st['prefix_hit_tokens']}, copies on write "
              f"{st['prefix_cow_copies']}, evictions {st['prefix_evictions']}; pages used at the "
              f"end {out['chunked warm']['kv']['used_pages']}")
    check(st["prefix_hits"] > 0 and st["prefix_cow_copies"] >= 1,
          "int8 prefix cache: no hit or no copy on write")
    warm, cold, one = (streams(out[n]["comps"])
                       for n in ("chunked warm", "chunked cold", "one-shot"))
    by_uid = {r.uid: r for r in reqs}

    def near_tie(label, uid, got: list, against: list) -> bool:
        """`got` first differs from `against` at a near-tie of int8 AR (its
        one-token steps over the prompt and `against` before that token)."""
        r = by_uid[uid]
        p = first_difference(label, uid, got, against)
        prefix = torch.as_tensor(np.concatenate([r.prompt, against[:p]]).astype(np.int64),
                                 device=DEV)[None]
        t1, t2 = top2_gap(model, params, prefix, len(r.prompt), r.max_new)
        phase(19, f"{label}: request {uid} first differs at generated token {p}, int8 AR top-2 "
                  f"logits {t1:.4f} / {t2:.4f}, gap {t1 - t2:.4e}")
        return t1 - t2 <= GAP_RTOL * max(abs(t1), 1.0)

    tied = 0
    for uid, got in warm.items():
        if got != cold[uid]:
            check(near_tie("int8 prefix, warm against cold", uid, got, cold[uid]),
                  f"int8 prefix: request {uid} differs from the cold engine outside a near-tie")
            tied += 1
    same_one, tied_one, deferred = 0, 0, []
    for uid, got in cold.items():
        if got == one[uid]:
            same_one += 1
        elif near_tie("int8 chunked cold, against one-shot", uid, got, one[uid]):
            tied_one += 1
        else:
            deferred.append(uid)
            phase(19, f"int8 chunked cold: request {uid} differs from the one-shot engine beyond "
                      f"a near-tie: held by the float32 witness below")
    phase(19, f"int8 prefix: {len(warm) - tied} of {len(warm)} warm completions equal the cold "
              f"chunked engine's, {tied} differ only at a near-tie (rtol {GAP_RTOL}); "
              f"{same_one} of {len(cold)} cold chunked completions equal the one-shot int8 "
              f"engine's, {tied_one} differ first at a near-tie, {len(deferred)} beyond one "
              f"(chunked prefill attends the dequantised cache, one-shot prefill in full "
              f"precision)")
    WITNESSES.append(("19a", lambda: int8_chunk_witness(cfg, waves, deferred)))
    out["chunked warm"].update(equal_cold=len(warm) - tied, equal_one_shot=same_one,
                               tied_one_shot=tied_one, deferred=deferred)
    return out["chunked warm"]


def int8_chunk_witness(cfg, waves, deferred: list) -> None:
    """The float32 witness of phase 19a's cold chunked completions, which
    holds the `deferred` ones (those that differ from the one-shot int8
    engine's beyond a near-tie of int8 AR) and runs whether or not there
    are any: vicuna-7b with kv_quant at V_WIT_LAYERS layers drawn in float32 from
    SEED, through ``int8_waves_run``'s cold chunked engine (the ample pool,
    chunks of P_CHUNK, graphed) on the same waves, each completion equal
    to the chunked function computed outside the engine
    (``ar_at_engine_rows`` over ``engine_rows_cache`` in chunks of
    P_CHUNK: a contiguous cache, the int8 causal form, one-token blocks) or
    first different at a float32 near-tie of its logits (F32_GAP_RTOL),
    where rounding no longer moves a greedy pick."""
    t0 = time.perf_counter()
    wcfg = cfg.replace(num_layers=V_WIT_LAYERS, dtype="float32")
    model, params, dvi = draw(wcfg, 19)
    label = f"vicuna-7b int8 ({V_WIT_LAYERS} layers, float32 witness) chunked cold"
    phase(19, f"{label}: the bf16 requests it holds (beyond a near-tie): {deferred}")
    r = int8_waves_run(model, params, dvi, waves, label, prefill_chunk=P_CHUNK)
    got = streams(r["comps"])
    equal = tied = 0
    for q in (q for wave in waves for q in wave):
        want = capped(ar_at_engine_rows(model, params, q, P_CHUNK), q.max_new)
        if got[q.uid] == want:
            equal += 1
            continue
        p = first_difference(label, q.uid, got[q.uid], want)
        t1, t2 = ar_at_engine_rows(model, params, q, P_CHUNK, top2_at=p)
        phase(19, f"{label}: request {q.uid} first differs from the chunked function at "
                  f"generated token {p}, float32 top-2 logits {t1:.6f} / {t2:.6f}, gap "
                  f"{t1 - t2:.4e}")
        check(t1 - t2 <= F32_GAP_RTOL * max(abs(t1), 1.0),
              f"{label}: request {q.uid} differs from the chunked function outside a float32 "
              f"near-tie")
        tied += 1
    phase(19, f"{label}: {equal} of {len(got)} completions equal the chunked function outside "
              f"the engine, {tied} differ first at a float32 near-tie (rtol {F32_GAP_RTOL}); "
              f"took {time.perf_counter() - t0:.1f} s")
    del model, params, dvi
    release({})


def int8_phase(cfg, params, dvi, reqs, base4: dict, base8: dict) -> dict:
    """Phase 19a: vicuna-7b with ``kv_quant`` on phase 4's weights (the flag
    changes no parameter): the sync engine on phase 4's requests eagerly
    and graphed (every replay under sync debug mode "error", the graphed
    run profiled with the records gate), the continuous engine over phase
    8's ample pool (graphed, one-shot admission) on its 16 requests, then
    ``int8_prefix_waves``; the caches' bytes against the bf16 ones, and
    the hidden-state drift of the reference test.  `base4` / `base8` are
    phases 4's and 8's graphed bf16 runs.  Returns the runs (launches)."""
    from repro_torch.models import transformer as tfm
    from repro_torch.models.model import build_model
    t0 = time.perf_counter()
    qcfg = cfg.replace(kv_quant=True)
    model = build_model(qcfg, device=DEV)
    K = cfg.dvi.k_spec
    hd = cfg.resolved_head_dim
    sizes = {}

    def sync_profile(r):
        sizes["sync"] = sync_cache_bytes(r["eng"], cfg)
        return profile_batch(r["eng"], reqs, r["wall"] * 1e3, n=19)

    sync = sync_modes(model, params, dvi, reqs, 19, "vicuna-7b int8 sync",
                      want=lambda r: hybrid_want(cfg, r["steps"], paged=False),
                      profile=sync_profile, guard=True)
    for mode, r in sync.items():
        int8_gate(f"vicuna-7b int8 sync {mode}", r)
    phase(19, "vicuna-7b int8 sync graphed: every block-step replay ran under sync debug mode "
              "'error': 0 synchronising operations")
    prompts = padded_prompts(reqs)
    drift = int8_hidden_drift(build_model(cfg, device=DEV), model, params, prompts)
    phase(19, f"int8 against bf16 after a prefill of {B_TP - K - 1} tokens and one block of "
              f"{K + 1}: max |h_int8 - h_bf16| / max |h_bf16| = {drift:.4e} (bound "
              f"{INT8_DRIFT}, the reference test's)")
    check(np.isfinite(drift) and 0 < drift < INT8_DRIFT,
          f"int8 hidden drift {drift}, bound {INT8_DRIFT}")
    release({})

    def cont_profile(r):
        cache = r["eng"]._cache
        P, ps = cache["segs"]["s0"]["kp"].shape[1:3]
        sizes["pool"] = (n_bytes(cache), n_bytes(tfm.init_paged_cache(
            cfg, cache["lengths"].shape[0], P - 1, ps, cache["tbl"].shape[1], device="meta")))
        return profile_batch(r["eng"], creqs, r["wall"] * 1e3, n=19)

    creqs = continuous_requests(cfg)
    cont = continuous_modes(model, params, dvi, creqs, C_PAGES_AMPLE, 19,
                            "vicuna-7b int8 continuous",
                            want=lambda r: hybrid_want(cfg, r["blocks_run"], paged=True),
                            profile=cont_profile, modes=(("graphed", True),))
    int8_gate("vicuna-7b int8 continuous graphed", cont["graphed"])
    prefix = int8_prefix_waves(model, params, dvi, qcfg)
    elt = torch.empty((), dtype=cfg.torch_dtype).element_size()
    for name, (got, base) in sizes.items():
        bytes_gate(f"vicuna-7b int8 {name} cache", got, base, hd, elt)
    rows = [("sync", sync["graphed"], base4), ("continuous", cont["graphed"], base8)]
    for name, r, b in rows:
        steps, p, g = max(r["steps"], 1), r["profile"] or {}, r["graph"]
        bp = b.get("profile") or {}
        phase(19, f"int8 {name} graphed beside bf16 (phase {4 if name == 'sync' else 8}): wall "
                  f"{1e3 * r['wall'] / steps:.2f} / {1e3 * b['wall'] / max(b['steps'], 1):.2f} ms "
                  f"a block-step, device {p.get('device_ms', float('nan')):.2f} / "
                  f"{bp.get('device_ms', float('nan')):.2f} ms, busy "
                  f"{100 * p.get('busy', float('nan')):.1f} / "
                  f"{100 * bp.get('busy', float('nan')):.1f} %, graph nodes {g['nodes']} / "
                  f"{b['graph']['nodes']}, peak {r['peak'] / 2**30:.2f} / "
                  f"{b['peak'] / 2**30:.2f} GiB; completions equal to bf16's "
                  f"{sum(v == streams(b['comps']).get(u) for u, v in streams(r['comps']).items())}"
                  f" of {len(r['comps'])}")
    phase(19, f"19a took {time.perf_counter() - t0:.1f} s")
    del model
    release({})
    return {"int8_sync": sync, "int8_continuous": cont, "int8_prefix": prefix}


def int8_hybrid_phase(cfg, model, params, dvi, reqs, long_reqs) -> dict:
    """Phase 19b: recurrentgemma-9b with ``kv_quant`` on phase 16's weights,
    graphed, through the sync engine on phase 4's requests and on the
    R_LONG lanes past the ring: lossless against int8 AR or the near-tie
    rule, launches 12 / 0 / 5 / 1 / 0 a block with every ring launch int8,
    nodes == launches (the census), and the rings' bytes ratio."""
    from repro_torch.models.model import build_model
    t0 = time.perf_counter()
    qmodel = build_model(cfg.replace(kv_quant=True), device=DEV)
    sizes = {}

    def ring_bytes(r):
        sizes["ring"] = sync_cache_bytes(r["eng"], cfg, KV_LEAVES)
        return None

    want = lambda r: hybrid_want(cfg, r["steps"], paged=False)  # noqa: E731
    graphed = (("graphed", True),)
    sync = sync_modes(qmodel, params, dvi, reqs, 19, f"{R_NAME} int8 sync", want=want,
                      profile=ring_bytes, modes=graphed)
    long_ = sync_modes(qmodel, params, dvi, long_reqs, 19, f"{R_NAME} int8 sync long", want=want,
                       buckets=(R_BUCKET,), batch_size=R_LONG, modes=graphed)
    for label, r in ((f"{R_NAME} int8 sync", sync), (f"{R_NAME} int8 sync long", long_)):
        int8_gate(label, r["graphed"])
    bytes_gate(f"{R_NAME} int8 rings (K/V values and scales)", *sizes["ring"],
               cfg.resolved_head_dim, torch.empty((), dtype=cfg.torch_dtype).element_size())
    phase(19, f"19b took {time.perf_counter() - t0:.1f} s")
    del qmodel
    return {"int8_rg_sync": sync, "int8_rg_long": long_}


def rg_int8_witness(cfg, reqs, long_reqs) -> None:
    """The float32 witness of phase 19b: recurrentgemma-9b with kv_quant at
    R_WIT_LAYERS layers drawn in float32 from SEED, through 19b's graphed
    sync engine on the same requests and long lanes past the ring: the
    launch formula, every ring launch int8, the census, and every lane
    equal to float32 int8 AR or first different at a float32 near-tie
    (F32_GAP_RTOL), where rounding no longer moves a greedy pick.  19b's
    bf16 lanes are held to int8 AR only up to their first difference."""
    t0 = time.perf_counter()
    wcfg = cfg.replace(num_layers=R_WIT_LAYERS, dtype="float32", kv_quant=True)
    model, params, dvi = draw(wcfg, 19)
    label = f"{R_NAME} int8 ({R_WIT_LAYERS} layers, float32 witness) sync"
    want = lambda r: hybrid_want(wcfg, r["steps"], paged=False)  # noqa: E731
    kw = dict(want=want, modes=(("graphed", True),), ar_kw=dict(rtol=F32_GAP_RTOL))
    runs = {label: sync_modes(model, params, dvi, reqs, 19, label, **kw),
            f"{label} long": sync_modes(model, params, dvi, long_reqs, 19, f"{label} long",
                                        buckets=(R_BUCKET,), batch_size=R_LONG, **kw)}
    for name, r in runs.items():
        int8_gate(name, r["graphed"])
    phase(19, f"{label}: took {time.perf_counter() - t0:.1f} s")
    del model, params, dvi
    release({})


# The float32 witnesses of phases 16b, 17, 19a and 19b (closures over
# their phases' requests and deferred completions), run by
# ``run_witnesses`` at the end, beside 19c's examples and 20's processes,
# where no timed window is left.
WITNESSES: list = []


def run_witnesses() -> None:
    for name, witness in WITNESSES:
        t0 = time.perf_counter()
        release({})
        witness()
        phase(int(name[:2]), f"{name}'s float32 witness took {time.perf_counter() - t0:.1f} s "
                             f"(beside 19c's and 20's processes)")
    WITNESSES.clear()
    release({})


def examples_phase() -> dict:
    """Phase 19c: ``examples/torch_multi_arch.py`` and
    ``examples/torch_train_100m.py --steps 60 --dvi-prompts 80``, each in a
    process of its own, both at once (their tiny models share the card;
    PYTHONHASHSEED pinned), on the card unless the rehearsal names another
    device: exit 0 and every ``lossless=True``.  The deferred float32
    witnesses (``run_witnesses``) run here while they do.  Returns the
    seconds from the start to each one's end."""
    # half the host's cores each, so the two do not contend for them
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), PYTHONHASHSEED="0",
               OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 2) // 2)))
    dev = [] if DEV == "cuda" else ["--device", DEV]
    out, procs = {}, {}
    t0 = time.perf_counter()
    try:
        for name, args, lines in (("torch_multi_arch", [], 3),
                                  ("torch_train_100m", ["--steps", "60", "--dvi-prompts", "80"],
                                   1)):
            procs[name] = (lines, subprocess.Popen(
                [sys.executable, os.path.join(ROOT, "examples", f"{name}.py"), *args, *dev],
                env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        run_witnesses()
        for name, (lines, proc) in procs.items():
            stdout, stderr = proc.communicate(timeout=LAUNCH_TIMEOUT)
            out[name] = time.perf_counter() - t0
            for line in stdout.splitlines():
                if any(key in line for key in ("lossless=", "pretrain:", "DVI online",
                                               "backbone:")):
                    phase(19, f"{name}: {line}")
            verdicts = re.findall(r"lossless=(\w+)", stdout)
            check(proc.returncode == 0 and len(verdicts) == lines
                  and all(v == "True" for v in verdicts),
                  f"examples/{name}.py exited {proc.returncode}, lossless {verdicts}: "
                  f"{stderr[-2000:]}")
            phase(19, f"examples/{name}.py: exit 0, {len(verdicts)} lossless=True, done "
                      f"{out[name]:.1f} s after both started")
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


# ---------------------------------------------------------------------------
# phase 20: the multi-device layer
# ---------------------------------------------------------------------------

def runtime_phase():
    """Phase 20a: the NCCL runtime at world size 1 from torchrun's
    variables, a 1 x 1 mesh on the card, an all-reduce, the production
    mesh refused.  Returns the mesh (the group stays up for 20b)."""
    import torch.distributed as dist
    from repro_torch.launch import distributed, mesh as mesh_mod
    t0 = time.perf_counter()
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(free_port()))
    devices = distributed.init_runtime(require_cuda=True)
    check(dist.is_initialized() and dist.get_backend() == "nccl" and dist.get_world_size() == 1
          and devices == [torch.device("cuda", 0)],
          f"init_runtime: backend {dist.get_backend() if dist.is_initialized() else None}, "
          f"devices {devices}")
    mesh = mesh_mod.make_debug_mesh(1, 1)
    x = torch.arange(4096, dtype=torch.float32, device=DEV) / 7
    y = x.clone()
    dist.all_reduce(y)
    torch.cuda.synchronize()
    check(torch.equal(x, y), "all_reduce at world size 1 changed its tensor")
    try:
        distributed.production_mesh_or_dryrun()
        refused = ""
    except RuntimeError as e:
        refused = str(e)
    check("repro_torch.launch.dryrun" in refused,
          f"production_mesh_or_dryrun at 1 card did not name the dry run: {refused!r}")
    phase(20, f"init_runtime(require_cuda=True): NCCL at world size 1 on {devices}, mesh "
              f"{mesh.mesh_dim_names} {tuple(mesh.shape)} on {mesh.device_type}; all_reduce "
              f"returned its tensor unchanged; production_mesh_or_dryrun refused "
              f"({refused[:60]}...) in {time.perf_counter() - t0:.1f} s")
    return mesh


def hinted_phase(model, params, dvi, reqs, mesh, base: dict) -> dict:
    """Phase 20b: phase 4's graphed sync path under ``hint_mesh(mesh)``:
    streams, graph nodes and capture launches equal to phase 4's graphed
    run (`base`), the per-block launch formula; then the group destroyed."""
    import torch.distributed as dist
    from repro_torch.launch import hints
    cfg = model.cfg
    K, k, L = cfg.dvi.k_spec, cfg.dvi.split_layer, cfg.num_layers
    with hints.hint_mesh(mesh):
        r = sync_run(model, params, dvi, reqs, True, 20, "sync graphed under hint_mesh")
    n = r["steps"]
    want = {"decode_attention": ((K + 1) * k + (L - k)) * n, "lora_logits": (K + 1) * n,
            "verify_argmax": n, "paged_decode_attention": 0, "ssd_scan": 0}
    same = streams(r["comps"]) == streams(base["comps"])
    g, g0 = r["graph"], base["graph"]
    phase(20, f"phase 4's graphed sync path under hint_mesh of the 1 x 1 mesh: {len(r['comps'])} "
              f"requests in {n} block-steps, wall {1e3 * r['wall'] / max(n, 1):.2f} ms a "
              f"block-step (phase 4: {1e3 * base['wall'] / max(base['steps'], 1):.2f}); streams "
              f"bit for bit phase 4's: {same}; graph nodes {g['nodes']} (phase 4: {g0['nodes']}); "
              f"capture launches {[c for c, _ in g['per_graph']]}; launches {r['launches']}")
    check(same and r["steps"] == base["steps"], "hinted streams differ from phase 4's")
    check(g["nodes"] == g0["nodes"] and g["per_graph"] == g0["per_graph"],
          "the hinted graph differs from phase 4's")
    check(r["launches"] == want, f"hinted launches {r['launches']}, expected {want}")
    release(r)
    # the same run without the hint mesh, the group still up: which of the
    # two (the hints, the NCCL group's threads) the hinted wall pays for
    u = sync_run(model, params, dvi, reqs, True, 20, "sync graphed, group up, no hint mesh")
    phase(20, f"phase 4's graphed sync path with the group up and no hint mesh: wall "
              f"{1e3 * u['wall'] / max(u['steps'], 1):.2f} ms a block-step (hinted "
              f"{1e3 * r['wall'] / max(n, 1):.2f}, phase 4 "
              f"{1e3 * base['wall'] / max(base['steps'], 1):.2f})")
    release(u)
    dist.destroy_process_group()
    from repro_torch.launch.distributed import ENV
    for key in ENV:
        os.environ.pop(key, None)
    check(not dist.is_initialized(), "the process group outlived phase 20b")
    return r


def card_step_peak(model, params, dvi) -> dict:
    """Phase 20c's card side: one eager block-step (``serve_step``) of
    phase 4's shape on a fresh cache; the bytes of its arguments (params,
    drafter, cache, pending tokens) and the peak allocated over the step,
    less what else the process holds."""
    from repro_torch.core import spec
    release({})
    torch.cuda.synchronize()
    held = n_bytes(params) + n_bytes(dvi)
    other = torch.cuda.memory_allocated() - held
    cache = model.init_cache(D20_B, D20_CAP)
    cache["lengths"].fill_(D20_S)
    pending = torch.zeros((D20_B,), dtype=torch.int32, device=DEV)
    args = held + n_bytes(cache) + n_bytes(pending)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    spec.serve_step(model, params, dvi, pending, cache)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - other
    del cache, pending
    release({})
    phase(20, f"one eager block-step on the card (B {D20_B}, cache {D20_CAP}, K "
              f"{model.cfg.dvi.k_spec}): arguments {args} bytes, peak {peak} bytes "
              f"({peak / 2**30:.3f} GiB) above the {other / 2**30:.3f} GiB the process holds "
              f"besides")
    return {"args": args, "peak": peak}


def dry_case(name: str, cfg, mesh: dict, shape, cache_len=None) -> dict:
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshShape
    rec = dryrun.run_case(name, None, mesh_shape=MeshShape(mesh), shape=shape, cfg=cfg,
                          cache_len=cache_len)
    check(rec["status"] == "ok", f"dry run of {name}: {rec}")
    return rec


def dry_cases(out: str, hbm: int) -> None:
    """Phase 20c's dry runs, on the host's CPU (``--dry-cases OUT HBM``: a
    process of its own, started with phase 19c, after the timed windows of
    the card's phases): vicuna-7b at a 1 x 1 mesh and phase 4's decode shape,
    deepseek-v3 at DS_LAYERS and DS_LAYERS + 1 layers at phase 17's sync
    shape, and all 61 layers' decode_32k case on ("data", 8) meshes from
    the weights' bound up until one fits `hbm` bytes.  Writes their
    records to OUT/phase20c.json."""
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.configs.base import InputShape
    shape = InputShape("phase4_decode", D20_S, D20_B, "decode")
    one = {"data": 1, "model": 1}
    recs = {"vicuna": dry_case("vicuna-7b", get_config("vicuna-7b"), one, shape, D20_CAP),
            "ds": dry_case(DS_NAME, get_config(DS_NAME).replace(num_layers=DS_LAYERS), one,
                           shape, D20_CAP),
            "ds1": dry_case(DS_NAME, get_config(DS_NAME).replace(num_layers=DS_LAYERS + 1), one,
                            shape, D20_CAP),
            "mesh": []}
    full = get_config(DS_NAME)
    data = 1
    while data * 8 * hbm < full.param_count() * 2 and data < 32:
        data *= 2
    while True:
        rec = dry_case(DS_NAME, full, {"data": data, "model": 8}, INPUT_SHAPES["decode_32k"])
        recs["mesh"].append(rec)
        if rec["memory"]["peak_bytes"] < hbm or data >= 32:
            break
        data *= 2
    with open(os.path.join(out, "phase20c.json"), "w") as f:
        json.dump(recs, f)


def start_dry_runs() -> dict:
    """Phases 20c's dry runs (``dry_cases``) and 20d (``python -m
    repro_torch.launch.dryrun --arch llama3-405b --shape decode_32k`` at
    32 x 8), each in a process of its own on the host's CPU, one thread
    each, started with phase 19c (no timed window runs beside them) and
    read by ``dryrun_phase``."""
    out = os.path.join(ROOT, "build", "dryrun")
    os.makedirs(out, exist_ok=True)
    for name in os.listdir(out):
        os.remove(os.path.join(out, name))
    hbm = torch.cuda.get_device_properties(0).total_memory if DEV == "cuda" else 85017493504
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    arch, shape = D20_CASE
    cmds = {"20c": [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--dry-cases", out,
                    str(hbm)],
            "20d": [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                    "--shape", shape, "--out", out]}
    procs = {k: subprocess.Popen(c, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True) for k, c in cmds.items()}
    atexit.register(stop, list(procs.values()))      # a failed phase leaves none running
    return {"out": out, "hbm": hbm, "t0": time.perf_counter(), "procs": procs}


def launch_drift():
    """Phase 20e: ``examples/torch_serve_drift.py`` at its defaults, in a
    process of its own (PYTHONHASHSEED pinned) beside phase 19c's examples,
    on the card unless the rehearsal names another device."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), PYTHONHASHSEED="0")
    dev = [] if DEV == "cuda" else ["--device", DEV, "--pretrain-steps", "20",
                                    "--warm-batches", "8", "--batches", "12", "--shift-at", "4"]
    proc = subprocess.Popen([sys.executable, os.path.join(ROOT, "examples",
                                                          "torch_serve_drift.py"), *dev],
                            env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    atexit.register(stop, [proc])
    return proc, time.perf_counter()


def stop(procs) -> None:
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def drift_phase(drift) -> None:
    """Phase 20e's gates: the drift example exited 0 with its curves."""
    proc, t0 = drift
    try:
        stdout, stderr = proc.communicate(timeout=LAUNCH_TIMEOUT)
    finally:
        stop([proc])
    for line in stdout.splitlines():
        if line.strip() and any(key in line for key in (
                "batch", "acc:", "K:", "post-shift", "dvi_train", "last update")):
            phase(20, f"torch_serve_drift: {line.strip()}")
    post = re.search(r"post-shift acceptance: frozen=([\d.]+) online=([\d.]+)", stdout)
    check(proc.returncode == 0 and post is not None,
          f"examples/torch_serve_drift.py exited {proc.returncode}: {stderr[-2000:]}")
    phase(20, f"examples/torch_serve_drift.py: exit 0, done {time.perf_counter() - t0:.1f} s "
              f"after it started (beside phase 19c's examples); post-shift acceptance frozen "
              f"{post.group(1)} against online {post.group(2)}")


def dryrun_phase(card: dict, ds_peak: int, dry: dict) -> None:
    """Phase 20c-d, after 19c: the records of ``start_dry_runs``' processes
    held against the card: vicuna-7b's argument bytes exactly and its peak
    within D20_PEAK_RTOL of ``card``'s, deepseek-v3's at DS_LAYERS within
    D20_PEAK_RTOL of phase 17's eager sync peak `ds_peak`; the layers of
    deepseek that fit one card, the smallest production-layout mesh for all
    61; 20d's record with its roofline."""
    from repro_torch import roofline
    from repro_torch.configs import INPUT_SHAPES, get_config
    t_wait = time.perf_counter()
    out, hbm, procs = dry["out"], dry["hbm"], dry["procs"]
    try:
        done = {k: p.communicate(timeout=D20_TIMEOUT) for k, p in procs.items()}
    finally:
        stop(procs.values())
    waited = time.perf_counter() - t_wait
    for k, p in procs.items():
        check(p.returncode == 0, f"phase {k}'s process exited {p.returncode}: "
              f"{done[k][1][-2000:]}")
    with open(os.path.join(out, "phase20c.json")) as f:
        recs = json.load(f)
    vic = recs["vicuna"]
    m = vic["memory"]
    err = abs(m["peak_bytes"] - card["peak"]) / card["peak"]
    phase(20, f"dry run vicuna-7b at 1 x 1, B {D20_B} cache {D20_CAP} ({vic['seconds']} s): "
              f"argument bytes {m['argument_bytes']} (the card's {card['args']}: equal "
              f"{m['argument_bytes'] == card['args']}), peak {m['peak_bytes']} bytes "
              f"({m['peak_bytes'] / 2**30:.3f} GiB) against the card's {card['peak']} "
              f"({card['peak'] / 2**30:.3f} GiB): {100 * err:.2f} % apart; temp "
              f"{m['temp_bytes'] / 2**30:.3f} GiB, {vic['cost']['dot_flops_per_device']:.4g} "
              f"FLOPs, fallbacks {vic['fallbacks']}")
    check(m["argument_bytes"] == card["args"], "the dry run's argument bytes differ from the "
          "bytes the card holds")
    check(err <= D20_PEAK_RTOL, f"the dry run's peak is {100 * err:.1f} % from the card's")
    p0, p1 = recs["ds"]["memory"]["peak_bytes"], recs["ds1"]["memory"]["peak_bytes"]
    err = abs(p0 - ds_peak) / ds_peak
    fit = DS_LAYERS + int((hbm - p0) // max(p1 - p0, 1))
    phase(20, f"dry run {DS_NAME} at {DS_LAYERS} layers, 1 x 1, phase 17's sync shape "
              f"({recs['ds']['seconds']} s): peak {p0 / 2**30:.3f} GiB against phase 17's eager "
              f"sync peak {ds_peak / 2**30:.3f} GiB: {100 * err:.2f} % apart; at {DS_LAYERS + 1} "
              f"layers {p1 / 2**30:.3f} GiB ({(p1 - p0) / 2**30:.3f} GiB a MoE layer): "
              f"{min(fit, 61)} of 61 layers fit one card of {hbm / 2**30:.2f} GiB "
              f"(total_memory {hbm} bytes)")
    check(err <= D20_PEAK_RTOL, f"{DS_NAME}'s dry-run peak is {100 * err:.1f} % from phase 17's")
    last = recs["mesh"][-1]
    tried = [f"{r['mesh']}: {r['memory']['peak_bytes'] / 2**30:.2f} GiB ({r['seconds']} s)"
             for r in recs["mesh"]]
    fits = last["memory"]["peak_bytes"] < hbm
    phase(20, f"{DS_NAME}, all 61 layers, decode_32k: peak a card by mesh {tried}; the smallest "
              f"production-layout mesh that holds it: "
              f"{last['mesh'] + ' (' + str(last['n_devices']) + ' cards)' if fits else 'none'}")

    arch, sname = D20_CASE
    with open(os.path.join(out, f"{arch}_{sname}_32x8.json")) as f:
        rec = json.load(f)
    rl = roofline.roofline_from_record(rec, get_config(arch), INPUT_SHAPES[sname])
    coll = {k: f"{v['count']:.0f}x {v['wire_bytes'] / 2**30:.2f} GiB"
            for k, v in rec["collectives"]["per_kind"].items()}
    axes = {k: f"{v['wire_bytes'] / 2**30:.2f} GiB" for k, v in
            rec["collectives"].get("per_axis", {}).items()}
    phase(20, f"python -m repro_torch.launch.dryrun --arch {arch} --shape {sname}: "
              f"{rec['status']} at {rec['mesh']} in {rec['seconds']} s of case; peak "
              f"{rl['peak_mem_gib']:.2f} GiB a card, fits {hbm / 2**30:.2f} GiB: {rl['fits_hbm']}; "
              f"{rec['cost']['dot_flops_per_device']:.4g} FLOPs a card; collectives {coll}, "
              f"wire by axis {axes}; roofline compute {1e3 * rl['compute_s']:.3f} ms, memory "
              f"{1e3 * rl['memory_s']:.3f} ms, collective {1e3 * rl['collective_s']:.3f} ms "
              f"({rl['dominant']}); useful FLOPs {rl['useful_flops_ratio']:.3f}; fallbacks "
              f"{rec.get('fallbacks')}")
    check(rec["status"] == "ok", f"dryrun {arch} {sname}: {rec.get('status')}")
    since = time.perf_counter() - dry["t0"]
    phase(20, f"20c and 20d ran beside 19c and 20e on the host ({since:.1f} s after they "
              f"started; {waited:.1f} s waited for them here)")


def main() -> int:
    if sys.argv[1:2] == ["--dry-cases"]:      # phase 20c's process (``start_dry_runs``)
        dry_cases(sys.argv[2], int(sys.argv[3]))
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.core import lora, spec
    from repro_torch.kernels import build, ops
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Request, ServingEngine

    t_start = time.perf_counter()
    card = card_line()
    phase(1, f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(card, flush=True)

    t0 = time.perf_counter()
    info = build.build_all()
    phase(2, f"kernels built in {time.perf_counter() - t0:.1f} s: "
             + ", ".join(f"{n} ({i['seconds']:.1f} s)" for n, i in info.items()))
    for name, i in info.items():
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", i["log"])]
        spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill stores", i["log"]))
        phase(2, f"  {name}: {len(regs)} kernels, at most {max(regs, default=0)} "
                 f"registers a thread, {spills} bytes of spill stores")

    cfg = get_config("vicuna-7b")
    marks = {"1-2": time.perf_counter() - t_start}
    rows = kernels_phase(cfg, get_config(M_NAME))
    marks["3"] = time.perf_counter() - t_start

    # ---- phase 4: the main path ----
    model = build_model(cfg, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    t0 = time.perf_counter()
    params = model.init(gen)
    dvi = lora.init_draft_params(gen, cfg)
    dvi["B"] = torch.randn(dvi["B"].shape, generator=gen, device=DEV) * 0.05
    torch.cuda.synchronize()
    phase(4, f"vicuna-7b bf16 params drawn on the card in {time.perf_counter() - t0:.1f} s "
             f"({sum(p.numel() for s in params['segments'].values() for p in s.values()) / 1e9:.2f}"
             f"B in segments)")
    reqs = make_requests(cfg)
    K, k, L = cfg.dvi.k_spec, cfg.dvi.split_layer, cfg.num_layers
    by_row = {row["name"]: row for row in rows}
    expect = {"decode_attention": path_attention_ms(by_row["decode_attention"], K, k, L),
              "verify_argmax": by_row["verify_argmax"]["ms"],
              "lora_logits": by_row["lora_logits"]["ms"]}
    runs = {}
    for mode, on in MODES:
        r = runs[mode] = sync_run(model, params, dvi, reqs, on, 4, f"sync {mode}")
        comps, n = r["comps"], r["steps"]  # spec_block_step calls of this run
        check(len(comps) == N_REQUESTS, f"{len(comps)} completions for {N_REQUESTS} requests")
        for c in comps:
            check(1 <= len(c.gen_tokens) <= MAX_NEW and bool((c.gen_tokens >= 0).all())
                  and bool((c.gen_tokens < cfg.vocab_size).all()),
                  f"request {c.uid}: bad generation {c.gen_tokens}")
        phase(4, f"{mode}: served {len(comps)} requests in {n} block-steps, wall "
                 f"{r['wall']:.3f} s: MAT {r['committed'] / max(r['blocks'], 1):.4f}, "
                 f"acceptance {r['eng'].acceptance:.4f}, "
                 f"{r['committed'] / r['wall']:.1f} committed tokens/s, "
                 f"peak memory {r['peak'] / 2**30:.2f} GiB")
        # the eager rerun is not profiled (the script's time limit)
        r["profile"] = profile_batch(r["eng"], reqs, r["wall"] * 1e3,
                                     expect=expect) if on else None

        # ---- phase 5: launch counts ----
        want = {"decode_attention": ((K + 1) * k + (L - k)) * n, "lora_logits": (K + 1) * n,
                "verify_argmax": n, "paged_decode_attention": 0, "ssd_scan": 0}
        phase(5, f"{mode}: launches over {n} block-steps: {r['launches']}; expected {want}")
        check(r["launches"] == want, "the sync path did not run the kernels as the formula says")
        if mode == "eager":
            release(r)
    report_modes(4, "vicuna-7b sync", runs)
    launches = runs["graphed"]["launches"]

    # ---- phase 6: greedy losslessness on the card ----
    eng = runs["graphed"].pop("eng")
    prompts = torch.as_tensor(np.stack([eng._pad(r, 128) for r in reqs]), device=DEV)
    r_sd = spec.speculative_generate(model, params, dvi, prompts, MAX_NEW)
    r_ar = spec.ar_generate(model, params, prompts, MAX_NEW)
    # the engine's graphed block-step on the same batch: its replays must
    # give the functional loop's streams bit for bit
    r_gr = eng._runner.generate(prompts, torch.ones((N_REQUESTS,), dtype=torch.bool,
                                                    device=DEV))
    same = torch.equal(r_gr.tokens, r_sd.tokens) and torch.equal(r_gr.lengths, r_sd.lengths)
    phase(6, f"graphed block-step == speculative_generate bit for bit on the 8 lanes padded "
             f"to 128: {same} ({r_gr.steps} replays, {r_sd.steps} blocks)")
    check(same and r_gr.steps == r_sd.steps,
          "the graphed block-step differs from speculative_generate")
    lossless_lanes(model, params, r_sd.tokens, r_sd.lengths, r_ar, 6, "speculative")

    # ---- phase 8: the continuous path over a paged pool ----
    del eng, r_sd, r_ar, r_gr
    release({})
    marks["4-6"] = time.perf_counter() - t_start
    c_launches, c_eager, c_frozen = continuous_phase(cfg, model, params, dvi,
                                                     by_row["paged_decode_attention"], by_row)
    marks["8"] = time.perf_counter() - t_start

    # ---- phase 10: the Improve loop, on the same weights ----
    c_reqs = continuous_requests(cfg)
    learn_c = learn_continuous(cfg, model, params, c_reqs, c_frozen)
    against_frozen(model, params, spec, c_reqs, learn_c["graphed"]["comps"], c_frozen["comps"],
                   "learning continuous")
    learn_s = learn_sync(cfg, model, params, reqs, runs["graphed"])
    pad = ServingEngine(model, params, frozen(model, dvi), learn=False)
    padded = {q.uid: Request(uid=q.uid, prompt=pad._pad(q, pad._bucket(len(q.prompt))),
                             max_new=q.max_new) for q in reqs}
    against_frozen(model, params, spec, reqs, learn_s["graphed"]["comps"],
                   runs["graphed"]["comps"], "learning sync", padded=padded)
    del pad
    marks["10"] = time.perf_counter() - t_start

    # ---- phase 11b: the teacher-forced DVI step, on the same weights ----
    release({})
    t_dvi = dvi_batch_phase(model, params)
    marks["11b"] = time.perf_counter() - t_start

    # ---- phase 12: speculative sampling and adaptive depth, on the same weights ----
    release({})
    t_samp = sampled_phase(cfg, model, params, dvi, reqs)
    release({})
    a_runs = adaptive_phase(cfg, model, params, dvi, c_frozen)
    marks["12"] = time.perf_counter() - t_start

    # ---- phase 13 (a, b, d): chunked prefill, on the same weights ----
    release({})
    ch = chunked_phase(cfg, model, params, dvi, c_frozen, by_row["paged_decode_attention"],
                       by_row)
    report_chunked("chunked graphed, ample pool", ch["graphed"], base=c_frozen)
    t_ch, t_one = ch["graphed"]["ticks_host"], c_frozen["ticks_host"]
    phase(13, f"host ms a block-step in admit + pre_admit: chunked {t_ch['admit']:.2f} + "
              f"{t_ch['pre_admit']:.2f}, prefill_chunk {t_ch['prefill_chunk']:.2f}; phase 8 "
              f"one-shot {t_one['admit']:.2f} + {t_one['pre_admit']:.2f}; one admission "
              f"{t_ch['admission']:.2f} host ms chunked (eager, the first chunk) against "
              f"{t_one['admission']:.2f} one-shot")
    report_chunked("chunked graphed, learning, adaptive", ch["learn_adaptive"], base=c_frozen)
    marks["13abd"] = time.perf_counter() - t_start

    # ---- phase 14: the prefix cache behind the HTTP front end, on the same weights ----
    release({})
    h14 = http_prefix_phase(cfg, model, params, dvi, ch["graphed"]["ticks_host"])
    release({})
    launchers_phase()
    marks["14"] = time.perf_counter() - t_start

    # ---- phase 15c: Medusa-lite, on the same vicuna weights ----
    release({})
    b_medusa = medusa_phase(model, params, reqs)
    marks["15c"] = time.perf_counter() - t_start

    # ---- phase 19a: the int8 KV cache, on the same vicuna weights ----
    release({})
    q19 = int8_phase(cfg, params, dvi, reqs, runs["graphed"], c_frozen)
    marks["19a"] = time.perf_counter() - t_start

    # ---- phase 20ab: the NCCL runtime, phase 4's path under a hint mesh ----
    release({})
    mesh = runtime_phase()
    hinted_phase(model, params, dvi, reqs, mesh, runs["graphed"])
    del mesh
    card20 = card_step_peak(model, params, dvi)
    marks["20ab"] = time.perf_counter() - t_start

    # ---- phase 15a, 15b: two-model SpS on the qwen3 pair; 15d: qwen2.5-14b ----
    del model, params, dvi
    release({})                        # engines in reference cycles hold the weights
    b_sps = sps_phase(reqs)
    release({})
    marks["15ab"] = time.perf_counter() - t_start
    q14 = qwen14_phase(reqs, by_row)
    release({})
    marks["15d"] = time.perf_counter() - t_start

    # ---- phase 9: mamba2-370m through both schedulers ----
    m_sync, m_cont, m_sync_e, m_cont_e, m_chunk = mamba_phase(by_row)
    marks["9,13c"] = time.perf_counter() - t_start

    # ---- phase 11a and 11c: mamba2 pretraining, the quickstart ----
    release({})
    t_pre = pretrain_phase(by_row["ssd_scan"]["at_training"]["backward_ms"])
    release({})
    t_qs = quickstart_phase()
    marks["11a,c"] = time.perf_counter() - t_start

    # ---- phase 16: the hybrid and MoE decoders; 19b: recurrentgemma's int8 rings ----
    release({})
    h16, q19b = hybrid_phase(by_row)
    q19.update(q19b)
    marks["16,19b"] = time.perf_counter() - t_start

    # ---- phase 17: DeepSeek-V3's MLA and MTP head ----
    release({})
    h16.update(deepseek_phase(by_row))
    marks["17"] = time.perf_counter() - t_start

    # ---- phase 18: whisper's encoder and cross-attention, paligemma's patches ----
    release({})
    a18 = aux_phase(by_row)
    marks["18"] = time.perf_counter() - t_start

    # ---- phase 19c: the port's last two examples; 20c-e and the float32 witnesses of
    # 16b, 17, 19a and 19b beside them (no timed window is left) ----
    release({})
    dry = start_dry_runs()          # phases 20c and 20d, on the host beside 19c and 20e
    drift = launch_drift()
    examples_phase()
    marks["19c, witnesses"] = time.perf_counter() - t_start
    drift_phase(drift)
    marks["20e"] = time.perf_counter() - t_start

    # ---- phase 20c, 20d: the dry runs against the card, a production case ----
    dryrun_phase(card20, h16["deepseek_sync"]["eager"]["peak"], dry)
    marks["20cd"] = time.perf_counter() - t_start

    # ---- phase 7: result lines ----
    for row in rows:
        name = row["name"]
        by_path = {"sync": launches.get(name, 0), "continuous": c_launches.get(name, 0),
                   "learn_sync": learn_s["graphed"]["launches"].get(name, 0),
                   "learn_continuous": learn_c["graphed"]["launches"].get(name, 0),
                   "mamba2_sync": m_sync.get(name, 0), "mamba2_continuous": m_cont.get(name, 0),
                   # the training paths (phase 11), eager
                   "mamba2_pretrain": t_pre["launches"].get(name, 0),
                   "dvi_batch": t_dvi["launches"].get(name, 0),
                   "quickstart": t_qs["launches"].get(name, 0),
                   # phase 12: the sampled path (eager) and adaptive depth (graphed)
                   "sampled": t_samp["launches"].get(name, 0),
                   "adaptive_pinned": a_runs["pinned"]["launches"].get(name, 0),
                   "adaptive": a_runs["controller"]["launches"].get(name, 0),
                   # phase 13: chunked prefill (graphed)
                   "chunked": ch["graphed"]["launches"].get(name, 0),
                   "chunked_learn_adaptive": ch["learn_adaptive"]["launches"].get(name, 0),
                   "mamba2_chunked": m_chunk["launches"].get(name, 0),
                   # phase 14a: the prefix cache behind the HTTP front end (graphed)
                   "http_prefix": h14["launches"].get(name, 0),
                   # phase 15: the baselines and qwen2.5-14b (graphed)
                   "sps": b_sps["sps"]["graphed"]["launches"].get(name, 0),
                   "sps_self": b_sps["sps_self"]["graphed"]["launches"].get(name, 0),
                   "medusa": b_medusa["graphed"]["launches"].get(name, 0),
                   "qwen25_14b": q14["launches"].get(name, 0),
                   # phases 16 and 17: the hybrid, MoE and MLA decoders (graphed)
                   **{path: r["graphed"]["launches"].get(name, 0) for path, r in h16.items()},
                   # phase 18: whisper and paligemma (graphed GenerateRunner),
                   # and their training steps (eager)
                   **{path: r["graphed"]["launches"].get(name, 0) for path, r in a18.items()},
                   **{f"{path}_train": r["train"]["launches"].get(name, 0)
                      for path, r in a18.items()},
                   # phase 19: the int8 KV cache (graphed)
                   **{path: (r["graphed"] if "graphed" in r else r)["launches"].get(name, 0)
                      for path, r in q19.items()}}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
        row["launches_eager_by_path"] = {
            "sync": runs["eager"]["launches"].get(name, 0), "continuous": c_eager.get(name, 0),
            "learn_sync": learn_s["eager"]["launches"].get(name, 0),
            "learn_continuous": learn_c["eager"]["launches"].get(name, 0),
            "mamba2_sync": m_sync_e.get(name, 0), "mamba2_continuous": m_cont_e.get(name, 0),
            "chunked": ch["eager"]["launches"].get(name, 0),
            "sps": b_sps["sps"]["eager"]["launches"].get(name, 0),
            "sps_self": b_sps["sps_self"]["eager"]["launches"].get(name, 0),
            "medusa": b_medusa["eager"]["launches"].get(name, 0),
            **{path: r["eager"]["launches"].get(name, 0) for path, r in h16.items()},
            **{path: r["eager"]["launches"].get(name, 0) for path, r in a18.items()},
            "int8_sync": q19["int8_sync"]["eager"]["launches"].get(name, 0)}
    ends = list(marks.values())
    phase(7, f"all phases passed in {time.perf_counter() - t_start:.1f} s; seconds by phase: "
             + ", ".join(f"{name} {end - start:.1f}" for name, start, end
                         in zip(marks, [0.0] + ends[:-1], ends)))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
