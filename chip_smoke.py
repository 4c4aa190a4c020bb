#!/usr/bin/env python3
"""Quickest proof that the PyTorch port serves and trains on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. build     — nvcc builds every kernel of ``relora_tpu_torch/csrc`` for
               sm_90a, one process per source, all started together; the
               HMMA count of every bf16 tensor-core kernel (kernel 3 with
               its wide dK/dV, kernel 5, the fused forward's z and y
               kernels, the fused dx's u and dx kernels, kernel 7's
               partials, kernel 8's tensor-core kernel, kernel 2's tile
               kernel); ``-Xptxas -v`` registers of the paged kernels
               (kernel 1's split walk and combine, kernel 2's tiles) and of
               every flash instantiation (up to H = 256) and, printed later,
               of kernels 4, 5, 6, 7 and 8; any spill fails.
2. kernels   — the paged kernels (1-2) against their plain PyTorch twins on
               the card, at llama_250m (N=16, H=48), llama_1b (N=32, H=64)
               and pythia_1b (N=8, H=256) widths, page 16, table width 64, B=8 with S in {1, 5} and a
               packed T=72, for f32, bf16 and int8 pools; kernel 1's edge
               cases (a row whose every position is -1, which must give 0; a
               row with one visible key; 16 heads on 4 kv heads at S=5;
               S=16; H=50 on scalar loads; a verify window, S = 5 over
               (8, W+1) tables, one row's window across a page boundary and a
               pad row on the null column) and its batch invariance (each row
               decoded alone gives the bits it gives in the batch of 8);
               kernel 2's (the prefill across a 64-token tile edge, grouped
               heads with a run over four tiles, H = 256 with and without
               grouping, H = 50, each with pads, each pool; verify runs of
               5 beside decode tokens, a prefill run and pads) and its batch
               invariance (the prefill run, each decode token, each verify
               run and the pads alone give the bits they give in the
               window); then each is timed at the main path's shape beside
               its plain twin, a gather + scaled_dot_product_attention
               yardstick, and its bound, again at the verify shapes
               (kernel 1 at S = 5 over (8, W+1) tables; kernel 2 on 8 verify
               runs of 5 plus a 64-token prefill run), and at pythia_1b's
               width (rows ``...@pythia_1b``).
3. kernels-3 — the HMMA count of each bf16 flash kernel's SASS
               (``cuobjdump -sass``: the tensor cores are used); the flash
               forward, dK/dV and dQ kernels against their twins: the train
               phase's shape (B=8, S=512, N=16, H=48), grouped heads (N=16,
               n_kv=4, H=64), an unaligned S=200, llama_40m's H=52,
               llama_7b's H=128, H=50 with grouped heads at S=200, and the
               wide kernels (pythia_1b's H=256; H=250 and 138 with grouped
               heads at S=200), and the pythia train phase's shape (B=2,
               S=2048, 8 heads of 256), at bf16 (tensor-core kernels) and
               f32 (FMA kernels); then each, forward+backward together and
               the backward alone, timed beside its twin, a
               scaled_dot_product_attention(is_causal=True) yardstick
               (forward, its backward alone from a saved output, both) and
               its bound, at the train phase's shape and at the pythia train
               phase's (rows ``...@pythia_1b``); and each at H=256 (B=8,
               S=512, 8 heads) on a line of its own.
4. drains    — ``relora_tpu_torch.serve_cli`` drains 16 requests (prompts of
               32-512 tokens, 64 new tokens each) for llama_250m at full width,
               ``--random-init --dtype bf16 --max-batch 8 --paged``: at
               ``--kv-dtype bf16``, with ``--packed``, and at ``--kv-dtype int8``,
               the first 4 with ``--packed --kv-dtype int8`` (fleet_disagg's
               packed leg's yardstick), then at bf16 over the repeat traffic (16 prompts, each a
               seeded 8-32-token phrase repeated to 32-512 tokens).
               The launch counters are zeroed before each drain and read after;
               the drain fails if its kernel never launched.
   spec      — the same through ``--spec-k 4``: ``--spec ngram`` with a bf16
               pool, ``--packed``, ``--kv-dtype int8`` (the first 8 prompts)
               and over the repeat traffic, and ``--spec model`` with a base
               and a draft (the base plus seeded noise) written by
               ``train/checkpoint.py`` (the first 8 prompts).
               Each prints tokens/s beside its plain drain's, drafted and
               accepted tokens, verify rounds and launches, and fails unless
               a verify round ran, kernel 1 (kernel 2 when packed) launched
               24 times a verify round at the window shape, every id is in
               the vocabulary, and the draft's acceptance lies strictly
               between 0 and 1.
   server    — ``serve_cli``'s HTTP server (``--port``) at the drains'
               flags: the 16 prompts from 16 concurrent raw-socket SSE clients,
               sequential (``/healthz`` ``warming`` while the warmup is held,
               then ``ok``; tokens identical to the in-process drain; kernel 1
               launched; ``/metrics`` parsed for the scheduler's gauges; its
               first 8 clients again, traced, for the idle share) and ``--packed``
               (kernel 2; divergence from the in-process drain reported);
               ``--max-queue 8`` under 40 requests at once (429s with a
               Retry-After, every admitted request done, a ``deadline_s``
               request ending ``timeout`` with partial output, a hung-up
               client's slot freed); the real ``python -m
               relora_tpu_torch.serve_cli --port 0 --port-file F`` process
               (``/healthz`` ok, 10 streams, SIGTERM mid-stream: a new
               request 503, every stream done, exit 0; it starts after the
               traced sequential drain and warms up while the packed and
               overload drains run and the fleet phases' replicas start, so
               its ready seconds carry theirs); f32 sequential and
               packed server drains against the in-process f32 drains
               (divergence only at top-2 gaps <= 1e-3).  One line per drain:
               TTFT p50/p99, TPOT p50, tokens/s beside the in-process
               drain's, the 429 share, warmup seconds.  Tenant traffic
               through the server (kernel 5) runs after phase 16.
   fleet_disagg — six ``serve_cli --port 0`` replica processes on the
               card at llama_250m's full width, int8 pool: ``--role
               decode``, ``--role prefill`` (``serve_migrate`` armed once)
               and ``--role prefill --packed`` naming it in a ``peers.json``,
               a watcher, and a tenant pair (``--no-merge --adapter-dir``,
               ``--role prefill`` into ``--role decode``).  Prompt 0 through
               the prefill replica fails open (decoded at home,
               token-identical); then the packed replica's drain of 4
               prompts (kernel 2), held to finishing, its streams counted
               against the in-process ``--packed --kv-dtype int8`` drain and
               that drain's against the sequential one; then one tenant
               request through the tenant pair twice, at home
               (``serve_migrate``) and migrated (kernel 5 on the receiver),
               token-identical; last the 16 prompts, each prefilled on the
               prefill replica (kernel 1's pool writes) and decoded on the
               decode replica (kernel 1) from its migrated page run, inside
               both replicas' ``/admin/profile`` windows.  The windows'
               close is sent without waiting: while the two replicas read
               their traces, the phases that time nothing run (fleet_tools,
               f32, f32-spec, f32-train, f32-fused, f32-adapters,
               f32_contiguous, f32-pythia, f32-int8, f32-nf4; each described
               in its place below; fleet_tools runs ``python -m
               relora_tpu_torch.tools.fleet_report`` over fleet_front's
               persisted ``fleet_series.jsonl`` and ``trace_report`` over its
               router's span stream merged with its replicas', and fails on
               an empty or malformed report).  Then the drain's checks: token-identical to
               the in-process int8 drain, the donor's pages and frame bytes
               equal to the reckoning, 16 inserts, each replica's device
               idle share over the drain.
   fleet_front — one ``python -m relora_tpu_torch.serve.supervisor``
               process (started beside the six): three ``serve_cli``
               replicas at the fleet's flags (``r0`` prefill with
               ``serve_migrate`` armed once, ``r1`` decode, ``r2`` mixed),
               its router (classifying at 128 prompt tokens) and its
               collector every 0.5 s.  Before fleet_disagg: a drill request
               (decoded at home on ``r0``), then the 16 prompts through the
               router, timed, each identical to the in-process int8 drain
               and routed by its length (long ones migrate ``r0`` -> ``r1``);
               a seeded 512-token P through the router (cached on ``r0``),
               then Q (P's first 256 tokens and 32 fresh ones) straight to
               ``r2``, which fetches the 16 pages from the holder the
               directory names (``/fleet/prefix``): one fetch, its bytes as
               reckoned, only the tail prefilled, Q identical to its
               in-process drain.
               After fleet_disagg: ``kill -9`` of ``r1`` under 8 short
               streams; its restart runs beside the f32 slot.  Then: no
               client hung, each stream done identical (retried on ``r2``) or
               ended by a typed ``stream_interrupted``, ``r1`` routable
               again; ``/fleet/series`` holds each replica's series, the
               router's, the restart and the SLO status; ``r1`` reloaded to
               another weights version refuses the holder's run; SIGTERM to
               the supervisor with 4 requests in flight loses none.  The
               replicas' kernel launches join rows 1-2.
   fleet_reload — a ``RollingUpdater`` onto a seeded llama_250m checkpoint
               over {decode, prefill} (then token-identical to an in-process
               drain of it); an update of {prefill, packed} with
               ``deploy_reload`` armed on the packed replica rolls both back
               while requests in flight finish; ``python -m
               relora_tpu_torch.serve.deploy publish`` swaps the
               ``--watch-checkpoints`` replica, and a publish with
               ``deploy_corrupt_manifest`` armed does not.  The replicas'
               kernel 1 and 2 launches after their warmups (their
               ``metrics.jsonl``) join the rows.
5. f32       — one ``decode_paged``, one ``step_paged`` and one
               ``verify_paged`` step (S = 5 over W+1 tables, a pad row) at
               f32, the kernel arm against the plain arm, compared on
               logits; then each verify slot against a one-token decode at
               its position.
   f32-spec  — 8 repeat prompts, 32 new tokens, at f32: ``--spec ngram``
               token-identical to the plain drain, except where the plain
               run's top two logits lie within 1e-3 (each such divergence
               printed with its gap).
6. train     — ``relora_tpu_torch.main`` trains llama_250m (full width and
               depth, bf16, LoRA r=128 with dropout 0.1) for 9 updates of two
               8 x 512 microbatches on a seeded Zipf corpus written under
               ``build/chip_smoke/``, merging and resetting every 3 updates.
               Fails unless every loss is finite and the last is below the
               first, the run merged and reset at updates 4 and 7, and the
               flash launch counters (zeroed before, read after) equal
               layers x microbatches x updates (+ layers x eval batches for
               the forward).
               Telemetry, in every train phase (train, fused_train,
               int8_train, int8_fused_train, the pythia ones, both
               auto_train phases, resume): each run writes
               ``metrics.jsonl`` into its ``--save_dir`` (its own under
               ``build/chip_smoke/telemetry/<phase>`` where the phase sets
               none; its checkpoints are deleted after the checks).  The
               phase's line adds the median ``mfu`` of updates 2-9 with the
               peak it used, the update's counted ``step_flops``, the mean
               ``mfu_gap`` shares, the trainer's last
               ``hbm/peak_bytes_in_use`` beside the phase's own
               ``torch.cuda.max_memory_allocated()``; it fails unless every
               step record's mfu lies in (0, 1], every waterfall's five
               shares sum to 1 within 1e-3, there is one waterfall record
               per ``--log_every`` updates (pythia_train runs
               ``--log_every 4``: 3 for its 9 updates), the trainer's HBM peak
               is at least the ``memory_plan``'s ``total_bytes`` (parameters
               and AdamW state, counted from the tensors' sizes) and at most
               the phase's own (the same allocator counter read later, so
               this bound holds unless the trainer read a stale counter), and
               ``tools/perf_report.py`` renders the directory (exit 0,
               "MFU-gap waterfall", "per-pytree").
   glue      — the quick start's last step (``relora_tpu_torch.run_glue``'s
               engine): a seeded llama_250m checkpoint (full width and depth)
               with unmerged LoRA factors, read and merged by
               ``run_glue.load_backbone``, fine-tuned by ``eval/glue.finetune``
               at f32 on a seeded two-class task (class by token range), batch
               32 trimmed by ``run_glue.pad_bucket`` to widths 32-128: 8
               updates with ``use_lora`` false, then 8 with it true, each arm
               evaluating 64 rows and predicting 32.  Fails unless every loss
               is finite, kernel 3's f32 forward, dK/dV and dQ launched, and
               the classifier's flash-arm logits lie within 2e-3 of the naive
               arm's at every width; then the three f32 kernels are checked
               and timed at B=32, S=128 (rows ``...@glue``).  The card has no
               ``transformers`` or ``datasets``, so the tokenizer and the
               pretokenize / ``--dataset_path`` steps run on the CPU only
               (``tests/test_torch_hf_pipeline.py``, ``tests/test_torch_glue.py``).
7. f32-train — one update of a 2-layer llama_250m at f32 (LoRA B drawn
               nonzero), the flash arm against the naive arm on loss,
               gradient norm and each of layer 0's trainable leaves'
               gradients, then one merge against an f64 oracle.
8. kernels-4 — the fused LoRA forward, dx and dA/dB kernels (4, 6, 7)
               against their twins: the three llama_250m projection shapes
               (M=4096, r=128; (K, N) = (768, 768), (768, 2560), (2560, 768))
               at bf16 and f32 with W the transposed view the model passes, a
               contiguous W, a ragged M=200, K=72, N=100, r=8, a rank past
               256 (M=1024, K=N=768, r=320), a ragged bf16 case on the
               tensor cores (M=200, K=72, N=104, r=8), kernel 7's M-chunk
               schedule at M=300 (one chunk) and M=4100 (a ragged last
               chunk), and a tensor scale through the autograd Function (ds
               too); each forward, dx and dA/dB prints the path it took
               (``tc`` or ``fma``), held to ``forward_path``'s (dA/dB:
               ``dab_path``'s) rule, and dA/dB must give the same bits
               twice; pythia_1b's four projection shapes (M=4096, r=128,
               bf16: (K, N) = (2048, 6144), (2048, 2048), (2048, 8192),
               (8192, 2048)) likewise; then each timed per shape beside its
               twin, the ordered cuBLAS chain of the default path and its
               bound, summed per decoder layer (rows ``...@pythia_1b`` for
               pythia_1b's four).
9. fused-train — the train phase again with ``--lora_fused true
               --lora_dropout 0``: the same checks, and the fused launch
               counters equal 7 x layers x (microbatches x updates + eval
               batches) for the forward and 7 x layers x microbatches x
               updates for dx and dA/dB; every forward, dx and dA/dB on the
               tensor cores.
   profile_train — the fused-train run with ``--profile true``: the train
               checks, then the two ``torch.profiler`` windows it writes
               (``profiler_logs/profile_train/trace_{0,1}.json``, the second
               ended by ``close()`` at the run's end) must load and name
               ``flash_fwd_tc_kernel`` and one of the port's LoRA or int8
               kernels among their device kernels.
10. f32-fused — one update of a 2-layer llama_250m at f32 (TF32 off),
               ``lora_fused`` true against false from the same weights
               (nonzero B) and batch, on loss, gradient norm and each of layer
               0's trainable leaves' gradients.
11. kernels-8 — kernel 8 (the int8 dequant matmul) and the int8 fused
               forward and dx (4-int8, 6-int8) against their twins: the three
               projection shapes at bf16 and f32 with q the transposed view of
               the (N, K) codes the model passes, the three at a ragged M=200
               (bf16), a contiguous (K, N) q, a
               ragged M=200, K=72, N=100, r=8, r=320 at M=1024, K=N=768,
               the ragged tensor-core case of kernels-4 (each call's path,
               kernel 8's too, printed and checked as there; kernel 7 on the
               int8 forward's z and the int8 dx's u), and a tensor scale
               through
               FusedLoRAMatmulInt8 (ds and dqscale too) and DequantMatmul,
               and pythia_1b's four projection shapes (bf16); then each
               timed per shape beside its twin, the dequantize + cuBLAS
               chain of the JAX default path and its bound, and kernel 8
               beside ``torch._weight_int8pack_mm`` (pythia_1b's shapes on
               a timing line of their own).
12. int8_train — a seeded full-rank llama_250m ``pytorch_model.bin`` (f32)
               written under ``build/chip_smoke/``, then the train phase with
               ``--quantize int8 --warmed_up_model DIR --save_dir`` (its final
               checkpoint is phase nomerge's int8 base): the train checks,
               codes nonzero after the warm start and int8 after the merges
               at updates 4 and 7, each of which moves every projection's
               codes or scales off its unmerged base, kernel 8 launched 7 x
               layers x (microbatches x updates + eval batches) times, every
               launch on the tensor cores, and no fused kernel.
13. int8_fused_train — the same with ``--lora_fused true --lora_dropout 0``:
               4-int8 launched 7 x layers x (microbatches x updates + eval
               batches) times, 6-int8 and kernel 7 7 x layers x
               microbatches x updates, every 4-int8, 6-int8 and kernel 7 on
               the tensor cores, kernel 8 never.
14. f32-int8 — one update of a 2-layer int8 llama_250m at f32 (TF32 off),
               the fused-int8 arm against the unfused kernel-8 arm from the
               same warm-started weights (nonzero B) and batch, on loss and
               gradient norm; then one int8 merge on the card against an f64
               oracle, to the requant rule.

15. kernels-5 — ``nvcc -Xptxas -v`` registers and spills of kernel 5's four
               kernels and of the tensor-core forward's and dx's three each
               (printed before the phase starts); kernel 5 (the
               grouped multi-tenant LoRA forward) against its twin at bf16
               and f32: M in {8, 40, 64, 72} (decode rows, a verify window,
               a prefill chunk, a packed step) x the three projection
               shapes, r=128, S=4 slots,
               a mixed idx that includes slot 0, W the transposed view; a
               ragged M=5, K=72, N=100, r=8, S=3 (the FMA path at bf16); r=320
               (three rank passes of the reduce kernel) at M=72, K=N=768,
               S=4; rows with idx -1 and S (held to x @ W), M=1, every row on
               one slot, a slot no row uses, a contiguous (K, N) W, a ragged
               shape on the tensor cores (M=5, K=72, N=104, r=8); and batch
               invariance: the rows of an M=8 call bit-equal to the same rows
               of an M=72 call whose other rows sit on other slots, at each
               projection shape.  Then each M and shape timed beside its twin,
               the gathered chain (cuBLAS x @ W plus the gathered bmm
               composite) and its bound; and two rows of their own, each
               checked against its twin at bf16 and f32 and timed so:
               ``@prefill`` (M = 512, the largest bucket the drain's prompts
               reach, every row on one slot: a batch-1 prefill) and
               ``@pythia_1b`` (M = 8 over pythia_1b's four projections).
16. adapters  — a seeded llama_250m base (LoRA r=128) and three seeded tenant
               adapters (tA, tB, tC; alpha 32, 64, 16) written under
               ``build/chip_smoke/`` by ``train/checkpoint.save_checkpoint``
               (while the fleet's replicas start); then the first 8 prompts
               (32 new tokens) drained by ``serve_cli --checkpoint BASE
               --no-merge --adapter-dir D --adapters tA,tB`` (base rows
               through kernel 5), the 16 round-robin over [base, tA, tB, tC]
               through the scheduler API with 4 slots, sequential and packed
               (32 new tokens), and the first 8 with 3 slots (16 new
               tokens), so adapters load from disk and evict mid-traffic
               (the registry's loads and evictions printed), and a mixed-tenant
               ``spec="ngram"`` drain (32) over the first 8 repeat prompts
               (kernel 5 at M = 40 in every verify forward, checked as the
               spec drains are).
               Each drain fails unless kernel 5 launched 7 x 24 times per
               forward; then tenant rows must differ from the base row on a
               shared prompt, and tB after tA on one prompt must equal tB
               alone (the prefix cache is keyed per adapter).
               Then server-tenants: the first 8 prompts through ``serve_cli
               --port`` over that base and ``--adapter-dir`` (tA, tB
               preloaded after the warmup), requests naming [base, tA, tB,
               tC] round-robin, kernel 5 launched 7 x 24 per forward, an
               unknown adapter answering 400.
17. f32-adapters — one ``decode_paged`` and one ``step_paged`` step of a
               slotted llama_250m at f32 with a mixed ``adapter_idx``, the
               kernel arm (kernel 5, the paged kernels) against the plain arm
               (the gathered composite, naive attention), compared on logits.
   contiguous — the reference's default serving mode, ``serve_cli``
               without ``--paged`` (the contiguous cache: each admitted
               request prefills alone at its bucket and is inserted into
               the (8, 1024) decode cache; one decode over 8 rows a round;
               attention the plain ``cached_attention``, as the reference's
               is ``jnp``): the 16 prompts, tokens/s, a profiled second
               drain of the first 8 for the device idle share, and the
               streams identical to the paged sequential drain (reported).
               contiguous_tenants: phase 16's base and tenants through
               ``ContinuousBatchingScheduler(adapter_registry=)`` with 4
               slots, 32 new tokens; fails unless kernel 5 launched 7 x 24 in every decode
               round and in every prefill whose bucket ``choose_grouped_arm``
               gives it (the pick printed per bucket 16-512); the decode
               launches join row 5, the prefill ones row 5 @ prefill.
               generate: ``serve_cli --prompt`` x 8 (``engine.generate``),
               tokens/s.  contiguous_server: ``serve_cli --port 0`` without
               ``--paged``, 16 clients; TTFT, TPOT, warmup over every
               bucket; tokens identical to the in-process contiguous drain.
               f32_contiguous: a 2-layer llama_250m at f32, contiguous
               against paged on one engine: prefill and decode logits within
               2e-3, the drain, ``generate`` and a tenant drain
               token-identical.  Each line carries its wall seconds.
   auto-arms — at llama_250m's and pythia_1b's projection shapes (r=128,
               bf16; a bf16 base as the model passes it and an int8 one),
               each arm of ``lora_matmul`` timed back to back (CUDA events
               around the run, so the host's time counts where it sets the
               pace; the median of three runs in turns): forward and
               forward+backward at M = 4096, forward at M = 8 and 72 with
               ``weights_static``; one line per case with the three times,
               ``choose_arm``'s pick under the H100 model, and whether it was
               the fastest arm it may pick (merged only with
               ``weights_static``); first the host cost of one eager op back to back
               (an in-place add, an 8 x 8 matmul: the model's launch term).
   auto_train — the train phase with ``--lora_fused auto --lora_dropout 0``:
               the train checks, every projection through the cost model,
               the arm each took printed, and kernels 4, 6, 7 launched
               exactly where it picked fused.
   resume    — that run again with ``--save_dir W --save_every 3
               --keep_checkpoints 2``, SIGTERM while update 5 runs (an
               emergency ``model_5``), then ``--autoresume`` to update 9
               across the merge and reset at 7: per-update losses equal to
               auto_train's (every kernel on the path is deterministic),
               saves at 3, 5, 9, ``model_5`` and ``model_9`` kept, the save
               and restore seconds and the checkpoint's bytes printed.
   nomerge   — kernel 4-int8 at M = 8 (a decode step) against its twin,
               timed per layer beside it, the dequantize + cuBLAS chain and
               the bound (the row ``fused_lora_int8_forward@decode``, whose
               launches are the unmerged int8 drains'); then resume's
               ``model_9`` (a bf16 base) and int8_train's final
               checkpoint (an int8 base) each drained by ``serve_cli
               --checkpoint C`` merged, then ``--no-merge`` sequential and
               ``--packed`` (every projection through the cost model): the
               first forward's logits within 5e-2 of the merged engine's
               (relative to max(1, max|logit|)), greedy agreement and tokens/s
               beside the merged drain's, the fused kernels launched exactly
               where the model picked fused, the paged kernel launched.
18. pythia-drains — the GPT-NeoX family: ``serve_cli --model_config
               pythia_1b --random-init --dtype bf16 --max-batch 8 --paged``
               (full width, cut to PYTHIA_TRAIN_LAYERS of its 16 layers as the
               pythia train phases are) on phase 4's first 8 prompts, 64 new
               tokens, at ``--kv-dtype bf16``, ``--packed`` and ``--kv-dtype
               int8``.  Each prints tokens/s, launches and the forwards
               counted at the engine, and fails unless kernel 1 (kernel 2
               when packed) launched once a layer in every forward that
               attends through it and every id is in the vocabulary.
   pythia_serving — the same cut pythia_1b (bf16) through every serving
               path; its checkpoints (a seeded base with LoRA r=128 on all
               four projections, biases nonzero, B = 0; tenants tA, tB, tC)
               are written while the fleet's replicas start, and its draft
               (``python -m relora_tpu_torch.compress.draft BASE OUT
               --sparsity 0.2``: the base merged and pruned by one global
               magnitude threshold, ``pythia_draft``) while the supervised
               replicas finish starting; each engine's restore reads and
               verifies a checkpoint once.  Tenants: ``serve_cli
               --checkpoint BASE --no-merge --adapter-dir D --packed`` builds
               the engine and registry (4 slots), and 8 prompts at 32 new
               tokens drain round-robin over [base, tA, tB, tC], sequential
               and packed, kernel 5 launched 4 x layers in every forward;
               then the tenant probes (each tenant steers, tB after tA
               equals tB alone).  Contiguous: ``serve_cli`` without
               ``--paged`` over the 8 prompts, its streams counted against
               the paged bf16 pythia drain's; then contiguous_tenants at
               pythia_1b's projections (kernel 5 in every decode round and
               every prefill; the prefill launches go to row 5 @
               prefill_pythia_1b).  Spec: ``--spec ngram`` sequential and
               ``--packed`` and ``--spec model`` with the NeoX draft over 8
               repeat prompts at 32 new tokens, as the spec phase checks
               them (kernel 1 or 2 once a layer in every verify forward;
               the model drafter's acceptance strictly in (0, 1)); the
               window launches go to rows ``..._verify@pythia_1b``.  Server:
               ``serve_cli --port`` over the base with ``--no-merge
               --adapter-dir --spec ngram``, 8 SSE clients round-robin over
               the tenants, every other one ``"spec": false``: TTFT and TPOT
               p50, tokens identical to the in-process drain of the same
               requests, kernels 5 and 1 launched.
19. pythia_train — ``relora_tpu_torch.main --model_config`` pythia_1b at
               full width cut to PYTHIA_TRAIN_LAYERS (4 of its 16) layers, as
               every pythia train phase below: bf16,
               LoRA r=128 (dropout 0.1), ``--max_length 2048``, two 2 x 2048
               microbatches an update (8192 tokens), 9 updates, merging and
               resetting every 3, on the corpus at 2048 tokens a sample; the
               train phase's checks, with kernel 3's launch counters equal to
               layers x microbatches x updates (+ layers x eval batches for the
               forward) and every launch on the wide kernels (the wrappers'
               ``wide_launches``, which count what the launcher reports it
               launched).
20. pythia_fused_train — a seeded full-rank pythia_1b ``pytorch_model.bin``
               (bf16, HF GPT-NeoX names: ``gpt_neox.`` prefix, biases drawn
               nonzero) written under ``build/chip_smoke/``, then the same run
               with ``--lora_fused true --lora_dropout 0 --warmed_up_model
               DIR``: every base parameter equal to the file's right after
               the graft, kernels 4, 6 and 7 launched 4 x layers x the train
               phase's multipliers, every launch on the tensor cores.
   int8_train@pythia_1b — the pythia train phase over an int8 base:
               ``--quantize int8 --warmed_up_model`` that seeded pythia_1b
               file: the train checks, two int8 merges moving the codes or
               scales of all 4 x layers projections, kernel 8 launched in every
               projection and never a fused kernel; its launches go to the
               ``8@pythia_1b`` row.
   int8_fused_train@pythia_1b — the same with ``--lora_fused true
               --lora_dropout 0``: 4-int8, 6-int8 and kernel 7 in every
               projection, on the tensor cores; launches to the
               ``@pythia_1b`` rows of 4-int8, 6-int8 and 7.
21. f32-pythia — on a 2-layer pythia_1b at f32 (TF32 off where the phase
               sets it; biases drawn nonzero): f32-train (kernel 3's wide FMA
               kernels against the naive arm, and a merge against f64),
               f32-fused (fused against unfused, nonzero B), f32-compare
               (``decode_paged``, ``step_paged`` and ``verify_paged``, kernel
               arm against plain arm) and f32-adapters (a slotted step with a
               mixed ``adapter_idx`` through kernel 5, seeded factors in each
               slot), each printed with ``@pythia_1b``.
22. auto_train@pythia_1b — the pythia train phase with ``--lora_fused auto
               --lora_dropout 0``, checked as auto_train.
23. prune    — prune-retrain at the pythia train phase's cut pythia_1b:
               pythia_train's run with ``--prune_sparsity 0.5 --prune_scope
               global --reset_init magnitude`` (the mask computed at the
               merge at 4 from the merged base, the merge at 7 masked) and
               int8_train@pythia_1b's with ``--prune_nm 2:4`` (kernel 8),
               each with the train phase's checks, every pruned position of
               every masked base read as exactly 0 on the card after the
               prune event and after the later merge, 2 of every 4 int8
               codes along ``in`` kept, the ``prune_mask_computed`` crc equal
               to the last checkpoint's sidecar (the dense one verified); then
               ``compress.draft`` and ``tools.export_hf --pruned`` of the
               dense run: its ``pytorch_model.bin`` grafted into a fresh
               model (``graft_base_weights``) and the draft both equal the
               checkpoint's merged weights with its mask applied.

``python3 chip_smoke.py --ab DIR [--train [FLAGS...] | --grouped | --lora |
--tenants | --paged | --drains | --server | --sass]`` times another checkout's package instead
(see :func:`ab`; ``--drains`` runs the spec drains beside the plain ones, in
turns); it checks nothing.

Output: a forward+backward timing line, one line per drain (plain and
spec), one per server drain, the server process line, the f32 server and
f32 spec lines, the fleet_front, fleet_tools, fleet_disagg, fleet_reload and fleet_launches
lines, a
train line, the glue line, a LoRA timing line per model, a fused-train
line, the profile line, an int8 timing line per model, the int8 train lines,
a grouped timing line, one line per adapter drain and the tenant server
drain, the contiguous, contiguous_tenants, generate, contiguous server and
f32_contiguous lines, the auto-arms lines, the auto_train and resume lines,
one line per unmerged drain, one line per pythia drain, the pythia_draft
line, the pythia_serving
lines (tenant drains and probe, contiguous, contiguous tenants, three spec
drains, the server), the five pythia
train lines (every train line carries its telemetry), the prune group's
two train lines, two prune lines and its export line, the wall seconds of
each group of phases (``{"phase_seconds": ...}``), a
``{"kernels": [...]}`` line, the card's ``nvidia-smi
--query-gpu=name,power.limit`` line, and last ``{"ok": true, "device":
{...}}``.  Without CUDA, or without the package beside it, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import gc
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
REPO = os.path.dirname(os.path.abspath(__file__))
WIDTHS = {"llama_250m": (16, 48), "llama_1b": (32, 64), "pythia_1b": (8, 256)}  # (heads, head_dim)
PYTHIA = "pythia_1b"  # the NeoX model of the pythia phases; its rows carry "@pythia_1b"
PAGE, TABLE_W, BATCH, PACKED_T = 16, 64, 8, 72
SPEC_K = 4  # the spec drains' --spec-k: verify windows of SPEC_K + 1 tokens
SPEC_HEAD_PROMPTS = 8  # spec_ngram_int8 and spec_model drain the first 8 prompts (one batch)
# kernel vs plain twin on one card: f32 sums in another order (1e-6 scale);
# bf16 outputs round once to bf16 (2^-7 relative at |out| < 4 gives 2e-2)
KERNEL_TOL = {"f32": 1e-4, "bf16": 2e-2, "int8": 2e-2}
LOGIT_TOL = 2e-3  # f32 logits after 24 layers, kernel arm vs plain arm


def _dtypes(torch, pool):
    q = torch.float32 if pool == "f32" else torch.bfloat16
    return q, {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}[pool]


def make_pool_case(torch, device, *, heads, head_dim, pool, S, seed, packed=False, kv_heads=None,
                   prefill_at=0):
    """Inputs of one kernel call: every row owns TABLE_W pages of one shared
    pool and sits at a random position of a 1024-token cache.  Packed: the
    B rows' decode tokens, a 56-token prefill of row B at positions
    ``prefill_at``.., then pad tokens on the all-null last row at the null
    position (the scheduler's layout).  ``kv_heads`` (default ``heads``)
    groups the query heads."""
    g = torch.Generator(device=device).manual_seed(seed)
    q_dtype, kv_dtype = _dtypes(torch, pool)
    n_kv = kv_heads or heads
    num_pages = (BATCH + 1) * TABLE_W + 1
    shape = (num_pages, PAGE, n_kv, head_dim)
    k = torch.randn(shape, generator=g, device=device)
    v = torch.randn(shape, generator=g, device=device)
    scales = {}
    if pool == "int8":
        ks = torch.rand((num_pages, n_kv), generator=g, device=device) * 0.02 + 0.01
        vs = torch.rand((num_pages, n_kv), generator=g, device=device) * 0.02 + 0.01
        k = torch.randint(-127, 128, shape, generator=g, device=device)
        v = torch.randint(-127, 128, shape, generator=g, device=device)
        scales = {"k_scale": ks, "v_scale": vs}
    k, v = k.to(kv_dtype), v.to(kv_dtype)
    perm = torch.randperm((BATCH + 1) * TABLE_W, generator=g, device=device) + 1
    tables = perm.reshape(BATCH + 1, TABLE_W).to(torch.int32)
    cache = TABLE_W * PAGE
    base = torch.randint(32, cache - S, (BATCH,), generator=g, device=device)
    if not packed:
        pos = (base[:, None] + torch.arange(S, device=device)[None, :]).to(torch.int32)
        q = torch.randn((BATCH, S, heads, head_dim), generator=g, device=device)
        return dict(q=q.to(q_dtype), pool_k=k, pool_v=v, block_tables=tables[:BATCH].contiguous(),
                    positions=pos, **scales)
    n_prefill = PACKED_T - BATCH - 8
    ptables = torch.zeros((BATCH + 2, TABLE_W + 1), dtype=torch.int32, device=device)
    ptables[: BATCH + 1, :TABLE_W] = tables
    row_map = torch.tensor(
        list(range(BATCH)) + [BATCH] * n_prefill + [BATCH + 1] * 8,
        dtype=torch.int32, device=device,
    )
    pos = torch.cat([
        base,
        torch.arange(prefill_at, prefill_at + n_prefill, device=device),
        torch.full((8,), cache, device=device),
    ]).to(torch.int32)
    q = torch.randn((1, PACKED_T, heads, head_dim), generator=g, device=device)
    return dict(q=q.to(q_dtype), pool_k=k, pool_v=v, block_tables=ptables,
                row_map=row_map, positions=pos, **scales)


def with_null_column(torch, tables):
    """A verify window's ``(B, W+1)`` tables: each row plus a trailing null column."""
    return torch.cat([tables, torch.zeros_like(tables[:, :1])], dim=1).contiguous()


def make_window_case(torch, device, *, heads, head_dim, pool, seed, n_verify, n_decode,
                     n_prefill, n_pad):
    """A packed window as the ``--packed --spec`` scheduler lays it out:
    ``n_verify`` verify runs of SPEC_K + 1 tokens (rows 0..; run 0 across a
    page boundary), ``n_decode`` one-token decode rows, a prefill run of
    ``n_prefill`` tokens of row BATCH at positions 40.., then ``n_pad`` pad
    tokens on the all-null last row at the null position.  The pool and
    tables are :func:`make_pool_case`'s.  Returns the case and its spans
    ``[(first token, count)]``, one a run, decode token, prefill run or the pads."""
    S = SPEC_K + 1
    case = make_pool_case(torch, device, heads=heads, head_dim=head_dim, pool=pool, S=1, seed=seed,
                          packed=True)
    g = torch.Generator(device="cpu").manual_seed(seed)
    cache = TABLE_W * PAGE
    rows, pos, spans = [], [], []
    for r in range(n_verify + n_decode):
        n = S if r < n_verify else 1
        start = 5 * PAGE - 2 if r == 0 else int(torch.randint(32, cache - S, (1,), generator=g))
        spans.append((len(rows), n))
        rows += [r] * n
        pos += list(range(start, start + n))
    for n, row, at in ((n_prefill, BATCH, 40), (n_pad, BATCH + 1, None)):
        if n:
            spans.append((len(rows), n))
            rows += [row] * n
            pos += list(range(at, at + n)) if at is not None else [cache] * n
    T = len(rows)
    q = torch.randn((1, T, heads, head_dim), generator=g).to(device=device, dtype=case["q"].dtype)
    case.update(q=q, row_map=torch.tensor(rows, dtype=torch.int32, device=device),
                positions=torch.tensor(pos, dtype=torch.int32, device=device))
    return case, spans


def bound(torch, case, packed=False):
    """Least time for the call on an H100 SXM: the bytes it must move (the
    K/V pages its queries can see, each once, plus q, out, tables, positions
    and scales) over 3.35 TB/s, against the f32 operations on visible keys
    (QK and PV, 4*H each) over 67 TFLOP/s."""
    q, pk = case["q"], case["pool_k"]
    tables, pos = case["block_tables"], case["positions"]
    if packed:
        tables = tables[case["row_map"].long()]
        pos = pos.reshape(-1, 1)
    n_kv, H = pk.shape[2], pk.shape[3]
    last = torch.clamp(pos.max(dim=1).values, max=tables.shape[1] * PAGE - 1)
    pages = set()
    for row, p in zip(tables.tolist(), last.tolist()):
        pages.update(row[: p // PAGE + 1])
    kv_bytes = 2 * len(pages) * PAGE * n_kv * H * pk.element_size()
    other = 2 * q.numel() * q.element_size() + tables.numel() * 4 + pos.numel() * 4
    if "k_scale" in case:
        other += 2 * len(pages) * n_kv * 4
    visible = (torch.clamp(pos, max=tables.shape[1] * PAGE - 1) + 1).sum().item()
    flops = 4.0 * H * visible * q.shape[2]  # per visible key, per head
    t_bytes = (kv_bytes + other) / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def library_call(torch, case, packed=False):
    """One PyTorch yardstick for the same function: gather the pages (and
    dequantize), then scaled_dot_product_attention with the visibility mask.
    Timed only; the port never calls it."""
    import torch.nn.functional as F

    from relora_tpu_torch.ops.attention import dequantize_gathered_pages, gather_kv_pages

    q, tables, pos = case["q"], case["block_tables"], case["positions"]
    if packed:
        tables = tables[case["row_map"].long()]
        q = q.reshape(-1, 1, q.shape[2], q.shape[3])
        pos = pos.reshape(-1, 1)

    def call():
        k = gather_kv_pages(case["pool_k"], tables)
        v = gather_kv_pages(case["pool_v"], tables)
        if "k_scale" in case:
            k = dequantize_gathered_pages(k, case["k_scale"], tables)
            v = dequantize_gathered_pages(v, case["v_scale"], tables)
        k, v = k.to(q.dtype).transpose(1, 2), v.to(q.dtype).transpose(1, 2)
        mask = torch.arange(k.shape[2], device=q.device)[None, None, :] <= pos[..., None]
        out = F.scaled_dot_product_attention(
            q.transpose(1, 2), k, v, attn_mask=mask[:, None]
        )
        return out.transpose(1, 2).reshape(case["q"].shape)

    return call


SLEEP_CYCLES = 10_000_000  # ~5 ms of the H100's clock: longer than any call's enqueue


def time_ms(torch, fn, iters=30):
    """Median device time of ``fn`` over ``iters`` launches, CUDA events
    around each, with a 128 MiB write between launches so the K/V pages come
    from device memory as in a forward (each layer has its own pool).  The
    device sleeps before each start event, so the host has enqueued the
    whole call by the time the window opens: the window holds the device's
    time alone, not the wrapper's Python and launch cost (which a short
    kernel would otherwise wait behind)."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def check_decode_edges(torch, device):
    """Kernel 1's edge cases against its twin, each pool: a row whose every
    position is -1 (output exactly 0) and a row with exactly one visible key
    (the key's V row), in a batch of 8 at S = 1 and 5; grouped heads (16
    heads on 4 kv heads, S = 5: 20 queries a group, three chunks); S = 16;
    H = 50 (rows that are no whole number of 16-byte vectors: scalar loads);
    and batch invariance: every row decoded alone gives the bits it gives
    inside the batch of 8.  Returns the worst error at llama_250m widths."""
    from relora_tpu_torch.ops import attention as A

    heads, head_dim = WIDTHS["llama_250m"]
    worst = 0.0
    cases = [(pool, dict(S=S), "pad+one") for pool in ("f32", "bf16", "int8") for S in (1, 5)]
    cases += [(pool, dict(S=5, kv_heads=4), "gqa") for pool in ("f32", "bf16", "int8")]
    cases += [("bf16", dict(S=16), "S=16"), ("bf16", dict(S=5, head_dim=50), "H=50"),
              ("f32", dict(S=1, head_dim=50), "H=50")]
    cases += [(pool, dict(S=SPEC_K + 1), "verify") for pool in ("f32", "bf16", "int8")]
    for i, (pool, extra, label) in enumerate(cases):
        kw = dict(heads=heads, head_dim=head_dim, pool=pool, S=1, seed=301 + i)
        kw.update(extra)
        case = make_pool_case(torch, device, **kw)
        scales = {k: case[k] for k in ("k_scale", "v_scale") if k in case}
        pos = case["positions"].clone()
        tables = case["block_tables"]
        if label == "pad+one":
            pos[0] = -1  # a pad row: no visible key
            pos[1] = torch.arange(pos.shape[1], device=device) - (pos.shape[1] - 1)  # key 0 alone at the last token
        if label == "verify":
            # the verify round's layout: (B, W+1) tables, row 0 a pad row
            # (all-null table at the null position), row 1's window across
            # a page boundary
            tables = with_null_column(torch, tables)
            tables[0] = 0
            pos[0] = TABLE_W * PAGE
            pos[1] = 5 * PAGE - 2 + torch.arange(pos.shape[1], device=device)
        args = (case["q"], case["pool_k"], case["pool_v"], tables, pos)
        got = A.paged_decode_attention(*args, **scales)
        want = A.paged_decode_attention_plain(*args, **scales)
        alone = [A.paged_decode_attention(case["q"][b:b + 1], case["pool_k"], case["pool_v"],
                                          tables[b:b + 1], pos[b:b + 1], **scales)
                 for b in range(BATCH)]
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok = bool(torch.isfinite(got.float()).all()) and err <= KERNEL_TOL[pool]
        invariant = all(torch.equal(got[b:b + 1], alone[b]) for b in range(BATCH))
        pad_zero = label != "pad+one" or bool((got[0] == 0).all())
        print(f"kernel-check paged_decode_attention {label} pool={pool} S={pos.shape[1]} "
              f"heads={heads}/{extra.get('kv_heads', heads)} H={kw['head_dim']} "
              f"max_abs_err={err:.3e} tol={KERNEL_TOL[pool]:g} batch_invariant={invariant} "
              f"pad_row_zero={pad_zero} {'ok' if ok and invariant and pad_zero else 'FAIL'}")
        if not (ok and invariant and pad_zero):
            raise AssertionError(f"paged_decode_attention edge case {label} ({pool}) failed")
        if kw["head_dim"] == head_dim:
            worst = max(worst, err)
    return worst


def check_packed_edges(torch, device):
    """Kernel 2's cases against its twin, each pool: llama_250m widths with
    the prefill across the 64-token tile edge (positions 40..95), grouped
    heads (16 on 4 kv heads: 16-token tiles, so the 56-token run spans four),
    H = 256 with and without grouping, and H = 50 (no tensor-core tile: every
    token on kernel 1's pair); every window has 8 pad tokens.  And batch
    invariance: the prefill run alone, each decode token alone and the pads
    alone give the bits they give inside the window.  Returns the worst
    error at llama_250m widths."""
    from relora_tpu_torch.ops import attention as A

    heads, head_dim = WIDTHS["llama_250m"]
    worst = 0.0
    cases = [(pool, dict(prefill_at=40), "tile-edge") for pool in ("f32", "bf16", "int8")]
    cases += [(pool, dict(kv_heads=4, head_dim=64), "gqa") for pool in ("f32", "bf16", "int8")]
    cases += [(pool, dict(heads=8, head_dim=256), "H=256") for pool in ("f32", "bf16", "int8")]
    cases += [("bf16", dict(heads=8, kv_heads=2, head_dim=256), "H=256 gqa"),
              ("bf16", dict(head_dim=50), "H=50")]
    lo, hi = BATCH, PACKED_T - 8  # the prefill run; decode tokens before it, pads after
    for i, (pool, extra, label) in enumerate(cases):
        kw = dict(heads=heads, head_dim=head_dim, pool=pool, S=1, seed=401 + i, packed=True)
        kw.update(extra)
        case = make_pool_case(torch, device, **kw)
        scales = {k: case[k] for k in ("k_scale", "v_scale") if k in case}
        q, rm, pos = case["q"], case["row_map"], case["positions"]

        def call(a, b):
            return A.packed_paged_attention(q[:, a:b], case["pool_k"], case["pool_v"],
                                            case["block_tables"], rm[a:b], pos[a:b], **scales)

        tc0 = A.packed_paged_attention.tc_launches
        got = call(0, PACKED_T)
        tiles = A.packed_paged_attention.tc_launches > tc0
        want = A.packed_paged_attention_plain(q, case["pool_k"], case["pool_v"],
                                              case["block_tables"], rm, pos, **scales)
        alone = [(lo, hi, call(lo, hi)), (hi, PACKED_T, call(hi, PACKED_T))]
        alone += [(t, t + 1, call(t, t + 1)) for t in range(lo)]
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok = bool(torch.isfinite(got.float()).all()) and err <= KERNEL_TOL[pool]
        invariant = all(torch.equal(got[:, a:b], o) for a, b, o in alone)
        n_kv = extra.get("kv_heads", kw["heads"])
        print(f"kernel-check packed_paged_attention {label} pool={pool} T={PACKED_T} "
              f"heads={kw['heads']}/{n_kv} H={kw['head_dim']} "
              f"tile_kernel={tiles} max_abs_err={err:.3e} tol={KERNEL_TOL[pool]:g} "
              f"batch_invariant={invariant} {'ok' if ok and invariant else 'FAIL'}")
        if not (ok and invariant):
            raise AssertionError(f"packed_paged_attention edge case {label} ({pool}) failed")
        if kw["head_dim"] == head_dim and kw["heads"] == heads:
            worst = max(worst, err)
    return max(worst, check_verify_windows(torch, device))


def check_verify_windows(torch, device, model="llama_250m"):
    """Kernel 2 on the ``--packed --spec`` layout, each pool, against its
    twin: four verify runs of SPEC_K + 1 tokens (one across a page edge,
    each shorter than a 64/g-token tile) beside four decode tokens, a
    40-token prefill run and 8 pads; and batch invariance: each run, decode
    token, the prefill run and the pads alone give the bits they give inside
    the window.  Returns the worst error at ``model``'s widths."""
    from relora_tpu_torch.ops import attention as A

    heads, head_dim = WIDTHS[model]
    worst = 0.0
    for i, pool in enumerate(("f32", "bf16", "int8")):
        case, spans = make_window_case(torch, device, heads=heads, head_dim=head_dim, pool=pool,
                                       seed=451 + i, n_verify=4, n_decode=4, n_prefill=40, n_pad=8)
        scales = {k: case[k] for k in ("k_scale", "v_scale") if k in case}
        q, rm, pos = case["q"], case["row_map"], case["positions"]
        T = q.shape[1]

        def call(a, b):
            return A.packed_paged_attention(q[:, a:b], case["pool_k"], case["pool_v"],
                                            case["block_tables"], rm[a:b], pos[a:b], **scales)

        got = call(0, T)
        want = A.packed_paged_attention_plain(q, case["pool_k"], case["pool_v"],
                                              case["block_tables"], rm, pos, **scales)
        alone = [(a, a + n, call(a, a + n)) for a, n in spans]
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok = bool(torch.isfinite(got.float()).all()) and err <= KERNEL_TOL[pool]
        invariant = all(torch.equal(got[:, a:b], o) for a, b, o in alone)
        print(f"kernel-check packed_paged_attention verify-windows {model} pool={pool} T={T} "
              f"runs=4x{SPEC_K + 1}+4 decode+40 prefill+8 pads max_abs_err={err:.3e} "
              f"tol={KERNEL_TOL[pool]:g} batch_invariant={invariant} "
              f"{'ok' if ok and invariant else 'FAIL'}")
        if not (ok and invariant):
            raise AssertionError(f"packed_paged_attention verify windows ({model}, {pool}) failed")
        worst = max(worst, err)
    return worst


def check_kernels(torch, device):
    """Phase 2: every kernel against its plain twin, then timings."""
    from relora_tpu_torch.ops import attention as A

    worst = {"paged_decode_attention": 0.0, "packed_paged_attention": 0.0,
             f"paged_decode_attention@{PYTHIA}": 0.0, f"packed_paged_attention@{PYTHIA}": 0.0,
             f"paged_decode_attention_verify@{PYTHIA}": 0.0}
    for model, (heads, head_dim) in WIDTHS.items():
        for pool in ("f32", "bf16", "int8"):
            cases = [(S, False) for S in (1, 5)] + [(1, True)]
            for S, packed in cases:
                case = make_pool_case(torch, device, heads=heads, head_dim=head_dim,
                                      pool=pool, S=S, seed=S + 7 * packed, packed=packed)
                scales = {k: case[k] for k in ("k_scale", "v_scale") if k in case}
                if packed:
                    args = (case["q"], case["pool_k"], case["pool_v"], case["block_tables"],
                            case["row_map"], case["positions"])
                    got = A.packed_paged_attention(*args, **scales)
                    want = A.packed_paged_attention_plain(*args, **scales)
                    name = "packed_paged_attention"
                else:
                    args = (case["q"], case["pool_k"], case["pool_v"], case["block_tables"],
                            case["positions"])
                    got = A.paged_decode_attention(*args, **scales)
                    want = A.paged_decode_attention_plain(*args, **scales)
                    name = "paged_decode_attention"
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                ok = bool(torch.isfinite(got.float()).all()) and err <= KERNEL_TOL[pool]
                print(f"kernel-check {name} {model} pool={pool} S={S} "
                      f"max_abs_err={err:.3e} tol={KERNEL_TOL[pool]:g} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{name} disagrees with its plain twin ({model}, {pool}, S={S})")
                if model == "llama_250m":
                    worst[name] = max(worst[name], err)
                elif model == PYTHIA:
                    worst[f"{name}@{PYTHIA}"] = max(worst[f"{name}@{PYTHIA}"], err)
                    if S == SPEC_K + 1:  # the pythia spec drains' verify shape
                        worst[f"{name}_verify@{PYTHIA}"] = max(
                            worst[f"{name}_verify@{PYTHIA}"], err)
    worst["paged_decode_attention"] = max(worst["paged_decode_attention"],
                                          check_decode_edges(torch, device))
    worst["packed_paged_attention"] = max(worst["packed_paged_attention"],
                                          check_packed_edges(torch, device))
    worst[f"packed_paged_attention_verify@{PYTHIA}"] = check_verify_windows(torch, device, PYTHIA)

    rows = []
    for name, kernel, packed, line in (
        ("paged_decode_attention", "paged_decode_attention", False, 331),
        ("packed_paged_attention", "packed_paged_attention", True, 532),
        # the verify shapes: S = K+1 over (B, W+1) tables; a packed window
        # of B verify runs of K+1 plus a 64-token prefill run
        ("paged_decode_attention_verify", "paged_decode_attention", False, 331),
        ("packed_paged_attention_verify", "packed_paged_attention", True, 532),
        # the pythia drains' shapes: 8 heads of 256, and its spec drains' verify
        (f"paged_decode_attention@{PYTHIA}", "paged_decode_attention", False, 331),
        (f"packed_paged_attention@{PYTHIA}", "packed_paged_attention", True, 532),
        (f"paged_decode_attention_verify@{PYTHIA}", "paged_decode_attention", False, 331),
        (f"packed_paged_attention_verify@{PYTHIA}", "packed_paged_attention", True, 532),
    ):
        heads, head_dim = WIDTHS[PYTHIA if name.endswith(PYTHIA) else "llama_250m"]
        verify = "_verify" in name
        if verify and packed:
            case, _ = make_window_case(torch, device, heads=heads, head_dim=head_dim, pool="bf16",
                                       seed=99, n_verify=BATCH, n_decode=0, n_prefill=64, n_pad=0)
        else:
            case = make_pool_case(torch, device, heads=heads, head_dim=head_dim, pool="bf16",
                                  S=SPEC_K + 1 if verify else 1, seed=99, packed=packed)
        if verify and not packed:
            case["block_tables"] = with_null_column(torch, case["block_tables"])
        fn = getattr(A, kernel)
        plain = getattr(A, kernel + "_plain")
        keys = ("q", "pool_k", "pool_v", "block_tables") + (("row_map",) if packed else ()) + ("positions",)
        args = [case[k] for k in keys]
        bound_ms, bound_by = bound(torch, case, packed)
        rows.append({
            "name": name,
            "route": "cuda",
            "source": "relora_tpu_torch/csrc/paged_attention.cu",
            "replaces": f"relora_tpu/ops/attention.py:{line}",
            "launches": 0,
            "max_abs_err": worst[name if name.endswith(PYTHIA) else kernel],
            "ms": time_ms(torch, lambda: fn(*args)),
            "plain_ms": time_ms(torch, lambda: plain(*args)),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": time_ms(torch, library_call(torch, case, packed)),
        })
    return rows


# kernel 3 cases: (B, S, N, n_kv, H, dtype); the first is the train phase's
# shape (llama_250m, --batch_size 8 --max_length 512), then grouped-query
# heads at llama_1b's head_dim, an S that is no multiple of the 64-row tile,
# llama_40m's H = 52 (padded to 64 on the card, 8-byte copies), llama_7b's
# H = 128 (the 32-row backward tiles), H = 50 with grouped heads and a
# ragged S (4-byte copies), then the wide kernels: pythia_1b's H = 256, and
# H = 250 (bf16, padded to 256) and 138 (f32) with grouped heads at a ragged S
FLASH_CASES = [
    (8, 512, 16, 16, 48, "bf16"), (8, 512, 16, 16, 48, "f32"),
    (2, 512, 16, 4, 64, "bf16"), (2, 512, 16, 4, 64, "f32"),
    (2, 200, 16, 16, 48, "bf16"), (2, 200, 16, 16, 48, "f32"),
    (4, 512, 8, 8, 52, "bf16"), (4, 512, 8, 8, 52, "f32"),
    (1, 512, 32, 32, 128, "bf16"), (1, 512, 32, 32, 128, "f32"),
    (2, 200, 4, 2, 50, "bf16"), (2, 200, 4, 2, 50, "f32"),
    (1, 512, 8, 8, 256, "bf16"), (1, 512, 8, 8, 256, "f32"),
    (2, 200, 4, 2, 250, "bf16"), (2, 200, 4, 2, 138, "f32"),
]
# pythia_1b's attention (hidden 2048, 8 heads: head_dim 256) at the train
# phase's batch: kernel 3's wide kernels, timed beside the main rows
FLASH_WIDE = (8, 512, 8, 8, 256, "bf16")
# the pythia train phase's attention: 2 x 2048 tokens, 8 heads of 256 (the
# wide kernels), checked against the twins and timed as rows of their own
FLASH_PYTHIA = (2, 2048, 8, 8, 256, "bf16")
# error relative to max(1, max|twin|): f32 sums the same terms in another
# order (1e-6 scale at S=512); bf16 outputs round once to bf16 (2^-8 relative)
FLASH_TOL = {"f32": 1e-4, "bf16": 1e-2}
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores (kernel 3's f32 FMA kernels)
FLASH_NAMES = ("flash_attention_forward", "flash_attention_bwd_dkdv", "flash_attention_bwd_dq")


def make_flash_case(torch, device, B, S, N, n_kv, H, dtype, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    q = torch.randn((B, S, N, H), generator=g, device=device).to(dt)
    k = torch.randn((B, S, n_kv, H), generator=g, device=device).to(dt)
    v = torch.randn((B, S, n_kv, H), generator=g, device=device).to(dt)
    dout = torch.randn((B, S, N, H), generator=g, device=device).to(dt)
    return q, k, v, dout


def flash_bound(q, k, kernel):
    """Least time on an H100 SXM: each input read once and each output
    written once over 3.35 TB/s, against the causal matmul work (in units of
    B*N*S^2*H: forward 2, dK/dV 4 with the recomputed QK^T, dQ 3, forward
    plus backward 2 + 5) over the peak of the inputs' type: the bf16
    tensor-core peak, or for f32 inputs (the FMA kernels) the float32 one."""
    B, S, N, H = q.shape
    qb = q.numel() * q.element_size()
    kb = k.numel() * k.element_size()
    rows = B * N * S * 4  # one f32 per (b, head, row): lse or delta
    bytes_, units = {
        "forward": (2 * qb + 2 * kb + rows, 2),
        "dkdv": (2 * qb + 4 * kb + 2 * rows, 4),
        "dq": (3 * qb + 2 * kb + 2 * rows, 3),
        "fwd_bwd": (4 * qb + 4 * kb, 7),
    }[kernel]
    t_bytes = bytes_ / HBM_BYTES_PER_S
    peak = F32_FLOPS_PER_S if q.element_size() == 4 else BF16_FLOPS_PER_S
    t_ops = units * B * N * S * S * H / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


FLASH_TC_KERNELS = ("flash_fwd_tc_kernel", "flash_bwd_dkdv_tc_kernel", "flash_bwd_dkdv_tc_wide_kernel",
                    "flash_bwd_dq_tc_kernel")
# every kernel of flash_attention.cu, for the ptxas report: the tensor-core
# kernels and the f32 ones (64-row tiles, and 32-row past H = 128)
FLASH_KERNELS = FLASH_TC_KERNELS + ("flash_fwd_kernel", "flash_bwd_dkdv_kernel",
                                    "flash_bwd_dq_kernel", "flash_fwd_wide_kernel",
                                    "flash_bwd_dkdv_wide_kernel", "flash_bwd_dq_wide_kernel")


def count_hmma(lib_path, kernels):
    """Start ``cuobjdump -sass`` on the built library; the returned function
    waits for it and returns ``{kernel: HMMA instructions in its SASS}`` of
    the named tensor-core kernels (all instantiations summed), printed:
    nonzero shows the tensor cores are used, and a zero fails."""
    from relora_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    proc = subprocess.Popen([cuobjdump, "-sass", str(lib_path)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)

    def report():
        sass, err = proc.communicate()
        if proc.returncode != 0:
            raise AssertionError(f"cuobjdump -sass {lib_path} failed: {err[-2000:]}")
        return _hmma_counts(sass, lib_path, kernels)

    return report


def _hmma_counts(sass, lib_path, kernels):
    counts = dict.fromkeys(kernels, 0)
    current = None
    for line in sass.splitlines():
        if "Function :" in line:
            current = next((k for k in kernels if k in line), None)
        elif current and "HMMA" in line:
            counts[current] += 1
    print(json.dumps({"sass_hmma": counts, "library": os.path.relpath(str(lib_path), REPO)}))
    if not all(counts.values()):
        raise AssertionError(f"a tensor-core kernel has no HMMA instruction: {counts}")
    return counts


def sass_digests(lib_path):
    """``{function: sha1 of its SASS}`` of a built library, read with
    ``cuobjdump -sass``: instructions only (addresses, encodings and the
    anonymous namespace's per-file hash dropped), so the same kernel built
    from two trees compares equal when it compiled to the same code."""
    import hashlib
    import re

    from relora_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    funcs, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            current = re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}", "ANON",
                             line.split("Function :")[1].strip())
            funcs[current] = hashlib.sha1()
        elif current:
            m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
            if m:
                funcs[current].update(m.group(1).encode())
    return {name: h.hexdigest() for name, h in funcs.items()}


def ptxas_report(source, kernels):
    """Start ``nvcc -Xptxas -v`` on ``source`` (the build's flags, into a
    throwaway object under ``build/``); the returned function waits for it,
    prints ``{kernel: registers, spills, smem}`` of the named kernels (over
    a template's instantiations: the most registers and shared memory, the
    spills summed, and their count) and fails if any of them spills."""
    from relora_tpu_torch.ops import _build

    out = os.path.join(REPO, "build", "ptxas", os.path.basename(str(source)) + ".o")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared",)]
    proc = subprocess.Popen(
        [_build.find_nvcc(), *flags, "-Xptxas", "-v", "-c", "-I", str(_build.CSRC), "-o", out,
         str(source)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def report():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise AssertionError(f"nvcc -Xptxas -v {source} failed:\n{log}")
        rows, current = {}, None
        for line in log.splitlines():
            if "Compiling entry function" in line or "Function properties for" in line:
                current = next((k for k in kernels if k in line), None)
                if current and "Compiling entry function" in line:
                    row = rows.setdefault(current, dict(instantiations=0, stack=0, spill_stores=0,
                                                        spill_loads=0, registers=0))
                    row["instantiations"] += 1
            elif current and "spill stores" in line:
                nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
                row = rows.setdefault(current, dict(instantiations=0, stack=0, spill_stores=0,
                                                    spill_loads=0, registers=0))
                row["stack"] = max(row["stack"], nums[0])
                row["spill_stores"] += nums[1]
                row["spill_loads"] += nums[2]
            elif current and "Used" in line and "registers" in line:
                words = line.replace(",", " ").split()
                row = rows[current]
                row["registers"] = max(row["registers"], int(words[words.index("registers") - 1]))
                if "smem" in words:
                    row["smem_bytes"] = max(row.get("smem_bytes", 0),
                                            int(words[words.index("smem") - 2]))
        print(json.dumps({"ptxas": rows, "source": os.path.relpath(str(source), REPO)}))
        if set(rows) != set(kernels):
            raise AssertionError(f"ptxas -v reported {sorted(rows)}, expected {sorted(kernels)}")
        spilled = sorted(k for k, v in rows.items() if v["spill_stores"] or v["spill_loads"])
        if spilled:
            raise AssertionError(f"ptxas -v: {spilled} spill registers to local memory")
        return rows

    return report


def flash_rows(torch, device, shape, worst, suffix):
    """The three flash kernels' rows at ``shape`` (B, S, N, n_kv, H, dtype):
    each timed beside its twin, SDPA (the backward rows both carry SDPA's
    backward alone, which computes dQ, dK and dV in one call) and its bound;
    ``worst`` the checks' error at that shape, ``suffix`` the names' tail."""
    import torch.nn.functional as F

    from relora_tpu_torch.ops import flash_attention as FA

    B, S, N, n_kv, H, dtype = shape
    q, k, v, dout = make_flash_case(torch, device, B, S, N, n_kv, H, dtype, seed=99)
    scale = H**-0.5
    out, lse = FA.flash_attention_forward(q, k, v, scale)
    bwd = (q, k, v, dout, lse, FA.flash_attention_delta(out, dout), scale)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa_in = [x.detach().requires_grad_() for x in (qt, kt, vt)]
    sdpa_out = F.scaled_dot_product_attention(*sdpa_in, is_causal=True)
    dout_t = dout.transpose(1, 2)
    sdpa_bwd_ms = time_ms(torch, lambda: torch.autograd.grad(sdpa_out, sdpa_in, dout_t,
                                                             retain_graph=True))
    rows = []
    for name, kernel, fn, plain, library_ms in (
        ("flash_attention_forward", "forward", lambda: FA.flash_attention_forward(q, k, v, scale),
         lambda: FA.flash_attention_forward_plain(q, k, v, scale),
         time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))),
        ("flash_attention_bwd_dkdv", "dkdv", lambda: FA.flash_attention_bwd_dkdv(*bwd),
         lambda: FA.flash_attention_bwd_dkdv_plain(*bwd), sdpa_bwd_ms),
        ("flash_attention_bwd_dq", "dq", lambda: FA.flash_attention_bwd_dq(*bwd),
         lambda: FA.flash_attention_bwd_dq_plain(*bwd), sdpa_bwd_ms),
    ):
        bound_ms, bound_by = flash_bound(q, k, kernel)
        rows.append({
            "name": name + suffix,
            "route": "cuda",
            "source": "relora_tpu_torch/csrc/flash_attention.cu",
            "replaces": "relora_tpu/ops/attention.py:84",
            "launches": 0,
            "max_abs_err": worst[name],
            "ms": time_ms(torch, fn),
            "plain_ms": time_ms(torch, plain),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": library_ms,
        })
    return rows


def check_flash_case(torch, device, case, seed):
    """The three flash kernels against their twins at ``case`` (B, S, N,
    n_kv, H, dtype), each printed; raises on a disagreement.  Returns each
    kernel's max abs error."""
    from relora_tpu_torch.ops import flash_attention as FA

    B, S, N, n_kv, H, dtype = case
    q, k, v, dout = make_flash_case(torch, device, B, S, N, n_kv, H, dtype, seed=seed)
    scale = H**-0.5
    want_out, want_lse = FA.flash_attention_forward_plain(q, k, v, scale)
    delta = FA.flash_attention_delta(want_out, dout)
    got_out, got_lse = FA.flash_attention_forward(q, k, v, scale)
    pairs = {
        "flash_attention_forward": [(got_out, want_out), (got_lse, want_lse)],
        "flash_attention_bwd_dkdv": list(zip(
            FA.flash_attention_bwd_dkdv(q, k, v, dout, want_lse, delta, scale),
            FA.flash_attention_bwd_dkdv_plain(q, k, v, dout, want_lse, delta, scale))),
        "flash_attention_bwd_dq": [(
            FA.flash_attention_bwd_dq(q, k, v, dout, want_lse, delta, scale),
            FA.flash_attention_bwd_dq_plain(q, k, v, dout, want_lse, delta, scale))],
    }
    torch.cuda.synchronize()
    errs = {}
    for name, outs in pairs.items():
        err = rel = peak = 0.0
        finite = True
        for got, want in outs:
            got, want = got.float(), want.float()
            finite = finite and bool(torch.isfinite(got).all() and torch.isfinite(want).all())
            diff = (got - want).abs().max().item()
            err = max(err, diff)
            peak = max(peak, want.abs().max().item())
            rel = max(rel, diff / max(1.0, want.abs().max().item()))
        ok = finite and peak > 0 and rel <= FLASH_TOL[dtype]
        print(f"kernel-check {name} B={B} S={S} N={N} n_kv={n_kv} H={H} {dtype} "
              f"max_abs_err={err:.3e} rel_err={rel:.3e} max_abs={peak:.3e} "
              f"tol={FLASH_TOL[dtype]:g} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain twin ({B, S, N, n_kv, H, dtype})")
        errs[name] = err
    return errs


def check_flash_kernels(torch, device):
    """Phase kernels-3: the three flash kernels against their twins on the
    card, then timings at the train phase's shape and at the pythia train
    phase's (FLASH_PYTHIA, rows ``...@pythia_1b``), and at FLASH_WIDE
    (printed as their own line)."""
    import torch.nn.functional as F

    from relora_tpu_torch.ops import flash_attention as FA

    for i, case in enumerate(FLASH_CASES + [FLASH_PYTHIA]):
        errs = check_flash_case(torch, device, case, seed=11 + i)
        if i == 0:
            worst = errs
        elif i == len(FLASH_CASES):
            worst_pythia = errs

    rows = (flash_rows(torch, device, FLASH_CASES[0], worst, "")
            + flash_rows(torch, device, FLASH_PYTHIA, worst_pythia, f"@{PYTHIA}"))
    B, S, N, n_kv, H, dtype = FLASH_CASES[0]
    q, k, v, dout = make_flash_case(torch, device, B, S, N, n_kv, H, dtype, seed=99)
    scale = H**-0.5
    out, lse = FA.flash_attention_forward(q, k, v, scale)
    bwd = (q, k, v, dout, lse, FA.flash_attention_delta(out, dout), scale)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    # SDPA's backward alone, from one saved forward: dQ, dK and dV together
    sdpa_in = [x.detach().requires_grad_() for x in (qt, kt, vt)]
    sdpa_out = F.scaled_dot_product_attention(*sdpa_in, is_causal=True)
    dout_t = dout.transpose(1, 2)
    sdpa_bwd_ms = time_ms(torch, lambda: torch.autograd.grad(sdpa_out, sdpa_in, dout_t,
                                                             retain_graph=True))

    def fwd_bwd(attend, inputs, cotangent):
        leaves = [x.detach().requires_grad_() for x in inputs]
        return torch.autograd.grad(attend(*leaves), leaves, cotangent)

    def plain_fwd_bwd():
        o, l = FA.flash_attention_forward_plain(q, k, v, scale)
        d = FA.flash_attention_delta(o, dout)
        FA.flash_attention_bwd_dkdv_plain(q, k, v, dout, l, d, scale)
        FA.flash_attention_bwd_dq_plain(q, k, v, dout, l, d, scale)

    bound_ms, bound_by = flash_bound(q, k, "fwd_bwd")
    pair = {
        "flash_fwd_bwd": "forward+backward",
        "shape": [B, S, N, n_kv, H, dtype],
        "ms": time_ms(torch, lambda: fwd_bwd(FA.flash_attention, (q, k, v), dout)),
        "plain_ms": time_ms(torch, plain_fwd_bwd),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": time_ms(torch, lambda: fwd_bwd(
            lambda a, b, c: F.scaled_dot_product_attention(a, b, c, is_causal=True),
            (qt, kt, vt), dout_t)),
        "backward_ms": time_ms(torch, lambda: (FA.flash_attention_bwd_dkdv(*bwd),
                                               FA.flash_attention_bwd_dq(*bwd))),
        "library_backward_ms": sdpa_bwd_ms,
    }
    print(json.dumps(pair))

    # the wide kernels at pythia_1b's head_dim: each kernel beside its twin,
    # SDPA (forward; backward alone, dQ, dK and dV together) and its bound
    B, S, N, n_kv, H, dtype = FLASH_WIDE
    q, k, v, dout = make_flash_case(torch, device, B, S, N, n_kv, H, dtype, seed=98)
    scale = H**-0.5
    out, lse = FA.flash_attention_forward(q, k, v, scale)
    bwd = (q, k, v, dout, lse, FA.flash_attention_delta(out, dout), scale)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa_in = [x.detach().requires_grad_() for x in (qt, kt, vt)]
    sdpa_out = F.scaled_dot_product_attention(*sdpa_in, is_causal=True)
    dout_t = dout.transpose(1, 2)
    wide = {"flash_wide": "H=256, ms per call", "shape": list(FLASH_WIDE),
            "library_forward_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True)),
            "library_backward_ms": time_ms(torch, lambda: torch.autograd.grad(
                sdpa_out, sdpa_in, dout_t, retain_graph=True))}
    for name, kernel, fn, plain in (
        ("flash_attention_forward", "forward", lambda: FA.flash_attention_forward(q, k, v, scale),
         lambda: FA.flash_attention_forward_plain(q, k, v, scale)),
        ("flash_attention_bwd_dkdv", "dkdv", lambda: FA.flash_attention_bwd_dkdv(*bwd),
         lambda: FA.flash_attention_bwd_dkdv_plain(*bwd)),
        ("flash_attention_bwd_dq", "dq", lambda: FA.flash_attention_bwd_dq(*bwd),
         lambda: FA.flash_attention_bwd_dq_plain(*bwd)),
    ):
        bound_ms, bound_by = flash_bound(q, k, kernel)
        wide[name] = {"ms": time_ms(torch, fn), "plain_ms": time_ms(torch, plain),
                      "bound_ms": bound_ms, "bound_by": bound_by}
    print(json.dumps(wide))
    return rows


def write_prompts(path, vocab, seed=0):
    import numpy as np

    rng = np.random.default_rng(seed)
    lengths = rng.integers(32, 513, 16)
    with open(path, "w") as f:
        for L in lengths:
            f.write(" ".join(str(t) for t in rng.integers(2, vocab, L)) + "\n")
    return int(lengths.sum())


def drains(torch, prompts, repeat):
    """Phase 3: the main path through the CLI's entry point, three ways, and
    the bf16 drain again over the repeat traffic (the spec drains' yardstick).
    Returns (launches, the lines, label -> {"tokens": uid -> tokens,
    "tokens_per_s"}: the server phase's yardstick)."""
    from relora_tpu_torch import serve_cli
    from relora_tpu_torch.ops import attention as A

    base = ["--model_config", "llama_250m", "--random-init", "--dtype", "bf16",
            "--max-batch", "8", "--paged", "--max-new-tokens", "64",
            "--input-file", prompts]
    launches = {"paged_decode_attention": 0, "packed_paged_attention": 0}
    results, outputs = [], {}
    # the fleet's packed leg's yardstick: its FLEET_PACKED prompts packed
    # over the int8 pool
    first = head_prompts(prompts, FLEET_PACKED, "prompts_packed_leg.txt")
    for label, extra, kernel in (
        ("bf16", ["--kv-dtype", "bf16"], "paged_decode_attention"),
        ("packed", ["--kv-dtype", "bf16", "--packed"], "packed_paged_attention"),
        ("int8", ["--kv-dtype", "int8"], "paged_decode_attention"),
        ("packed_int8", ["--kv-dtype", "int8", "--packed", "--input-file", first],
         "packed_paged_attention"),
        ("bf16_repeat", ["--kv-dtype", "bf16", "--input-file", repeat], "paged_decode_attention"),
    ):
        A.paged_decode_attention.launches = 0
        A.packed_paged_attention.launches = 0
        completions, seconds = serve_cli.run(base + extra)
        counts = {
            "paged_decode_attention": A.paged_decode_attention.launches,
            "packed_paged_attention": A.packed_paged_attention.launches,
        }
        tokens = [c.tokens for c in completions.values()]
        want = FLEET_PACKED if label == "packed_int8" else 16
        if len(tokens) != want or not all(1 <= len(t) <= 64 for t in tokens):
            raise AssertionError(f"drain {label}: malformed completions")
        if not all(0 <= tok < 32100 for t in tokens for tok in t):
            raise AssertionError(f"drain {label}: token id out of the vocabulary")
        if counts[kernel] == 0:
            raise AssertionError(f"drain {label}: {kernel} never launched")
        for k in launches:
            launches[k] += counts[k]
        n = sum(len(t) for t in tokens)
        line = {"drain": label, "requests": len(tokens), "tokens": n, "seconds": seconds,
                "tokens_per_s": n / seconds, "launches": counts}
        print(json.dumps(line))
        results.append(line)
        outputs[label] = {"tokens": {uid: c.tokens for uid, c in completions.items()},
                          "tokens_per_s": n / seconds}
    return launches, results, outputs


PYTHIA_PROMPTS = 8  # the pythia drains' prompts: the first 8 (one batch)


def pythia_drains(torch, prompts, model_config):
    """Phase pythia-drains: the serving path of the NeoX family through the
    CLI's entry point at pythia_1b's full width, cut to ``model_config``'s
    PYTHIA_TRAIN_LAYERS layers, three ways, on the first PYTHIA_PROMPTS of
    phase 4's prompts.  Each drain fails unless every launch of its kernel
    came from its decode method (``decode_paged`` for kernel 1,
    ``step_paged`` for kernel 2), once a layer in every call, and every id
    is in the vocabulary.  Returns the launches per kernel and the bf16
    drain's uid -> tokens (the contiguous pythia drain's yardstick)."""
    from relora_tpu_torch import serve_cli
    from relora_tpu_torch.config.model import load_model_config
    from relora_tpu_torch.ops import attention as A

    cfg = load_model_config(model_config)
    head = head_prompts(prompts, PYTHIA_PROMPTS, "pythia_prompts.txt")
    base = ["--model_config", model_config, "--random-init", "--dtype", "bf16",
            "--max-batch", "8", "--paged", "--max-new-tokens", "64", "--input-file", head]
    kernels = ("paged_decode_attention", "packed_paged_attention")
    launches = dict.fromkeys(kernels, 0)
    outputs = {}
    for label, extra, kernel, method in (
        ("bf16", ["--kv-dtype", "bf16"], "paged_decode_attention", "decode_paged"),
        ("packed", ["--kv-dtype", "bf16", "--packed"], "packed_paged_attention", "step_paged"),
        ("int8", ["--kv-dtype", "int8"], "paged_decode_attention", "decode_paged"),
    ):
        for k in kernels:
            getattr(A, k).launches = 0
        with EngineCalls(method) as calls:
            completions, seconds = serve_cli.run(base + extra)
        counts = {k: getattr(A, k).launches for k in kernels}
        tokens = [c.tokens for c in completions.values()]
        n = sum(len(t) for t in tokens)
        print(json.dumps({"pythia_drain": label, "model": PYTHIA, "requests": len(tokens),
                          "tokens": n, "seconds": seconds, "tokens_per_s": n / seconds,
                          "launches": counts, method: calls.calls}))
        torch.cuda.empty_cache()
        outputs[label] = {uid: c.tokens for uid, c in completions.items()}
        if len(tokens) != PYTHIA_PROMPTS or not all(1 <= len(t) <= 64 for t in tokens):
            raise AssertionError(f"pythia drain {label}: malformed completions")
        if not all(0 <= tok < cfg.vocab_size for t in tokens for tok in t):
            raise AssertionError(f"pythia drain {label}: token id out of the vocabulary")
        want = {k: cfg.num_hidden_layers * calls.calls if k == kernel else 0 for k in kernels}
        if calls.calls == 0 or counts != want or calls.launches != want:
            raise AssertionError(f"pythia drain {label}: launches {counts} ({calls.launches} in "
                                 f"{calls.calls} {method} calls), expected "
                                 f"{cfg.num_hidden_layers} a call: {want}")
        for k in kernels:
            launches[k] += counts[k]
    return launches, outputs["bf16"]


def write_repeat_prompts(path, vocab, seed=1, count=16):
    """The prompt-lookup regime (code edits, retrieval answers that copy
    their input): ``count`` prompts, each a seeded phrase of 8-32 tokens
    repeated to a seeded length of 32-512 tokens."""
    import numpy as np

    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(count):
            phrase = rng.integers(2, vocab, int(rng.integers(8, 33))).tolist()
            length = int(rng.integers(32, 513))
            f.write(" ".join(str(t) for t in (phrase * (length // len(phrase) + 1))[:length]) + "\n")
    return path


DRAFT_NOISE = 0.02  # the draft's noise, per tensor, in units of that tensor's std


def write_spec_checkpoints(torch, work, device):
    """Two ``train/checkpoint.py`` directories of llama_250m at bf16: the
    base, drawn exactly as ``serve_cli --random-init --seed 0 --dtype bf16``
    draws it, and the draft, the base with seeded Gaussian noise of
    DRAFT_NOISE times each weight matrix's std (norms kept), so that the
    draft proposes the base's argmax some of the time.  Returns (base, draft)."""
    import shutil

    from relora_tpu_torch.config.model import load_model_config
    from relora_tpu_torch.models.params_util import init_params
    from relora_tpu_torch.serve.engine import build_decode_model
    from relora_tpu_torch.train.checkpoint import save_checkpoint

    root = os.path.join(work, "spec_llama_250m")
    shutil.rmtree(root, ignore_errors=True)
    model = build_decode_model(load_model_config("llama_250m"), dtype=torch.bfloat16, device=device)
    init_params(model, torch.Generator(device=device).manual_seed(0))
    state = model.state_dict()
    base = save_checkpoint(os.path.join(root, "base"), 0, state, {"update_step": 0})
    draft = save_checkpoint(os.path.join(root, "draft"), 0, noisy_draft(torch, state, device),
                            {"update_step": 0})
    del model, state
    return base, draft


def noisy_draft(torch, state, device):
    """``state`` with seeded Gaussian noise (seed 31) of DRAFT_NOISE times
    each weight matrix's std added to every tensor of two or more dimensions
    (norms and biases kept)."""
    gen = torch.Generator(device=device).manual_seed(31)
    noisy = {}
    for name, t in state.items():
        if t.ndim >= 2:
            noise = torch.randn(t.shape, generator=gen, device=device)
            t = (t.float() + DRAFT_NOISE * t.float().std() * noise).to(t.dtype)
        noisy[name] = t
    return noisy


class EngineCalls:
    """Counts the calls of one ``InferenceEngine`` method while entered
    (``_forward``: every model forward), and the launches of kernels 1 and 2
    (or of the wrappers ``kernels`` maps by name) made inside them: the
    launches at the shape that method gives the kernels (``verify_paged``:
    kernel 1 at S = K+1 over W+1 tables; ``step_paged``: kernel 2 on packed
    windows; ``decode``: kernel 5 at M = max_batch)."""

    def __init__(self, method, kernels=None):
        self.method = method
        self.kernels = kernels

    def __enter__(self):
        from relora_tpu_torch.ops import attention as A
        from relora_tpu_torch.serve.engine import InferenceEngine

        self.cls, self.real = InferenceEngine, getattr(InferenceEngine, self.method)
        self.calls = 0
        kernels = self.kernels or {k: getattr(A, k) for k in ("paged_decode_attention",
                                                              "packed_paged_attention")}
        self.launches = dict.fromkeys(kernels, 0)

        def counted(engine, *args, **kwargs):
            before = {k: w.launches for k, w in kernels.items()}
            out = self.real(engine, *args, **kwargs)
            self.calls += 1
            for k, w in kernels.items():
                self.launches[k] += w.launches - before[k]
            return out

        setattr(InferenceEngine, self.method, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.cls, self.method, self.real)


def spec_line(label, completions, seconds, sched, window_launches, launches, plain_tps, n_requests):
    """The drain line of a spec drain, after its checks: completions well
    formed, every id in the vocabulary, verify rounds > 0, and the window
    kernel launched at least 24 times a verify round."""
    stats = sched.spec_stats()
    tokens = [c.tokens for c in completions.values()]
    n = sum(len(t) for t in tokens)
    line = {"drain": label, "requests": len(tokens), "tokens": n, "seconds": seconds,
            "tokens_per_s": n / seconds, "plain_tokens_per_s": plain_tps,
            "drafted": stats["drafted"], "accepted": stats["accepted"],
            "accept_rate": stats["accept_rate"], "verify_rounds": stats["verify_rounds"],
            "window_launches": window_launches, "launches": launches}
    print(json.dumps(line))
    layers = sched.engine.config.num_hidden_layers
    if len(tokens) != n_requests or not all(1 <= len(t) <= 64 for t in tokens):
        raise AssertionError(f"drain {label}: malformed completions")
    if not all(0 <= tok < sched.engine.config.vocab_size for t in tokens for tok in t):
        raise AssertionError(f"drain {label}: token id out of the vocabulary")
    if stats["verify_rounds"] == 0:
        raise AssertionError(f"drain {label}: no verify round ran")
    if window_launches < stats["verify_rounds"] * layers:
        raise AssertionError(f"drain {label}: {window_launches} window launches for "
                             f"{stats['verify_rounds']} verify rounds x {layers} layers")
    return line


def spec_drains(torch, prompts, repeat, base, draft, plain):
    """Phase spec: ``serve_cli`` drains with ``--spec-k 4`` beside the
    plain drains (``plain``: label -> tokens/s), each checked by
    :func:`spec_line`.  The sequential drains' window launches are kernel
    1's inside ``verify_paged`` (24 a call); the packed drain's are kernel
    2's over its forwards (every forward launches it 24 times, one forward
    a round).  Returns (kernel 1 and 2 launches over these drains, kernel 1
    at the window shape, kernel 2 on windows, the lines)."""
    from relora_tpu_torch import serve_cli
    from relora_tpu_torch.ops import attention as A

    common = ["--dtype", "bf16", "--max-batch", "8", "--paged", "--max-new-tokens", "64",
              "--spec-k", str(SPEC_K)]
    rnd = ["--model_config", "llama_250m", "--random-init"] + common
    head = head_prompts(prompts, SPEC_HEAD_PROMPTS, "spec_prompts.txt")
    launches = {"paged_decode_attention": 0, "packed_paged_attention": 0}
    window = {"paged_decode_attention": 0, "packed_paged_attention": 0}
    lines = []
    for label, argv, plain_label, method in (
        ("spec_ngram", rnd + ["--spec", "ngram", "--input-file", prompts], "bf16", "verify_paged"),
        ("spec_ngram_packed", rnd + ["--spec", "ngram", "--packed", "--input-file", prompts],
         "packed", "step_paged"),
        ("spec_ngram_int8", rnd + ["--spec", "ngram", "--kv-dtype", "int8", "--input-file", head],
         "int8", "verify_paged"),
        ("spec_model", ["--model_config", "llama_250m", "--checkpoint", base] + common
         + ["--spec", "model", "--draft-checkpoint", draft, "--input-file", head], "bf16",
         "verify_paged"),
        ("spec_ngram_repeat", rnd + ["--spec", "ngram", "--input-file", repeat], "bf16_repeat",
         "verify_paged"),
    ):
        A.paged_decode_attention.launches = 0
        A.packed_paged_attention.launches = 0
        with EngineCalls(method) as calls:
            completions, seconds, sched = serve_cli.drain(argv)
        counts = {k: getattr(A, k).launches for k in launches}
        kernel = "packed_paged_attention" if method == "step_paged" else "paged_decode_attention"
        layers = sched.engine.config.num_hidden_layers
        if calls.launches[kernel] != layers * calls.calls:
            raise AssertionError(f"drain {label}: {calls.launches[kernel]} {kernel} launches in "
                                 f"{calls.calls} {method} calls, expected {layers} a call")
        if method == "step_paged":
            win = layers * sched.spec_stats()["verify_rounds"]  # one forward a round
        else:
            win = calls.launches[kernel]
        lines.append(spec_line(label, completions, seconds, sched, win, counts,
                               plain.get(plain_label),
                               len(read_prompts(argv[argv.index("--input-file") + 1]))))
        stats = sched.spec_stats()
        if label == "spec_model" and not 0 < stats["accepted"] < stats["drafted"]:
            raise AssertionError(f"drain spec_model: the draft's acceptance must lie strictly "
                                 f"between 0 and 1, got {stats}")
        for k in launches:
            launches[k] += counts[k]
        window[kernel] += win
        del sched
        torch.cuda.empty_cache()
    return launches, window, lines


def f32_spec_drains(torch, repeat, work):
    """Phase f32-spec: 8 requests of the repeat traffic, 32 new tokens, at
    f32 through ``serve_cli``, plain and ``--spec ngram``: greedy tokens must
    agree, except where the plain run's top two logits lie within 1e-3 (a
    tie, which another summation order may break the other way).  Each
    divergence is printed with its gap."""
    from relora_tpu_torch import serve_cli

    path = os.path.join(work, "repeat8.txt")
    with open(repeat) as f, open(path, "w") as out:
        out.writelines(f.readlines()[:8])
    argv = ["--model_config", "llama_250m", "--random-init", "--dtype", "f32", "--max-batch", "8",
            "--paged", "--max-new-tokens", "32", "--input-file", path]
    plain, _, sched = serve_cli.drain(argv)
    spec, _, spec_sched = serve_cli.drain(argv + ["--spec", "ngram", "--spec-k", str(SPEC_K)])
    stats = spec_sched.spec_stats()
    prompts = read_prompts(path)
    divergences = []
    for uid, c in plain.items():
        got = spec[uid].tokens
        i = next((j for j, (a, b) in enumerate(zip(c.tokens, got)) if a != b), None)
        if i is None and len(got) == len(c.tokens):
            continue
        i = min(len(got), len(c.tokens)) if i is None else i
        ids = torch.tensor([prompts[uid] + c.tokens[:i]], device=sched.engine.device)
        with torch.inference_mode():
            logits = sched.engine.model(ids)[0, -1].float()
        top = torch.topk(logits, 2).values
        divergences.append({"uid": uid, "index": i, "top2_gap": (top[0] - top[1]).item()})
    ok = stats["verify_rounds"] > 0 and all(d["top2_gap"] <= 1e-3 for d in divergences)
    print(json.dumps({"f32_spec": "8 requests x 32 tokens, --spec ngram vs plain, f32",
                      "verify_rounds": stats["verify_rounds"], "drafted": stats["drafted"],
                      "accepted": stats["accepted"], "divergences": divergences,
                      "ok": ok}))
    if not ok:
        raise AssertionError(f"f32 spec drain diverges from the plain drain: {divergences}")
    del sched, spec_sched
    torch.cuda.empty_cache()


def f32_comparison(torch, device, model_name="llama_250m"):
    """Phase 4: the same decode_paged and step_paged at f32 through the
    kernel arm and the plain arm, from identical pools; logits compared.
    llama_250m runs at full depth, any other model at 2 layers."""
    import numpy as np

    from relora_tpu_torch.config.model import load_model_config
    from relora_tpu_torch.ops import attention as A
    from relora_tpu_torch.serve.engine import InferenceEngine, build_decode_model

    cfg, tag = (load_model_config(model_name), "") if model_name == "llama_250m" else two_layer(model_name)
    model = seeded_init(torch, build_decode_model(cfg, device=device),
                        torch.Generator(device=device).manual_seed(1))
    W = cfg.max_sequence_length // PAGE
    engine = InferenceEngine(cfg, model, cache_size=cfg.max_sequence_length, page_size=PAGE,
                             num_pages=(BATCH + 1) * W + 1, chunk_size=64,
                             token_budget=BATCH + 64, device=device)
    rng = np.random.default_rng(3)
    lengths = rng.integers(32, 513, BATCH)
    tables = (np.arange(BATCH * W).reshape(BATCH, W) + 1).astype(np.int32)
    pool = engine.init_pool()
    for row, L in enumerate(lengths):
        prompt = rng.integers(2, cfg.vocab_size, L)
        for start in range(0, L, 64):
            ids = np.zeros((1, 64), np.int32)
            part = prompt[start : start + 64]
            ids[0, : len(part)] = part
            _, pool = engine.prefill_chunk(ids, start, pool, tables[row : row + 1])

    def both(step):
        out = {}
        for arm in ("auto", "naive"):
            engine.model.attention_arm = arm
            pool_copy = [{k: t.clone() for k, t in layer.items()} for layer in pool]
            out[arm] = step(pool_copy).float()
        engine.model.attention_arm = "auto"
        torch.cuda.synchronize()
        return (out["auto"] - out["naive"]).abs().max().item(), out["auto"]

    token = rng.integers(2, cfg.vocab_size, (BATCH, 1)).astype(np.int32)
    n0 = A.paged_decode_attention.launches
    err_d, logits = both(lambda p: engine.decode_paged(p, token, lengths[:, None], tables)[0])
    if A.paged_decode_attention.launches == n0:
        raise AssertionError("f32 decode_paged did not reach the kernel")
    ptables = np.zeros((BATCH + 2, W + 1), np.int32)
    ptables[:BATCH, :W] = tables
    ptables[BATCH, :W] = np.arange(W) + 1 + BATCH * W
    n_new = 64 - 8
    ids = np.concatenate([token[:, 0], rng.integers(2, cfg.vocab_size, n_new), np.zeros(8, int)])
    positions = np.concatenate([lengths, np.arange(n_new), np.full(8, cfg.max_sequence_length)])
    row_map = np.array(list(range(BATCH)) + [BATCH] * n_new + [BATCH + 1] * 8, np.int32)
    n1 = A.packed_paged_attention.launches
    err_p, plogits = both(lambda p: engine.step_paged(
        p, ids[None].astype(np.int32), positions[None].astype(np.int32), ptables, row_map)[0])
    if A.packed_paged_attention.launches == n1:
        raise AssertionError("f32 step_paged did not reach the kernel")
    # verify: (8, K+1) windows over (8, W+1) tables, row 7 a pad row (all
    # null, at the null position), row 0's window across a page boundary
    S = SPEC_K + 1
    start = lengths.copy()
    start[0] = PAGE * (lengths[0] // PAGE) - 2
    vtokens = rng.integers(2, cfg.vocab_size, (BATCH, S)).astype(np.int32)
    vpos = (start[:, None] + np.arange(S)).astype(np.int32)
    # the scheduler's pad row: token 0 at the null position in every slot,
    # so its writes to the one null slot carry the same K/V
    vtokens[BATCH - 1] = 0
    vpos[BATCH - 1] = cfg.max_sequence_length
    vtables = np.zeros((BATCH, W + 1), np.int32)
    vtables[: BATCH - 1, :W] = tables[: BATCH - 1]
    n2 = A.paged_decode_attention.launches
    err_v, vlogits = both(lambda p: engine.verify_paged(p, vtokens, vpos, vtables)[0])
    if A.paged_decode_attention.launches == n2:
        raise AssertionError("f32 verify_paged did not reach the kernel")
    # each window slot against a one-token decode at its position, on the
    # pool the verify wrote (kernel arm both)
    after = [{k: t.clone() for k, t in layer.items()} for layer in pool]
    engine.verify_paged(after, vtokens, vpos, vtables)
    dtables = vtables[:, :W]
    err_w = 0.0
    for j in range(S):
        dlogits = engine.decode_paged(after, vtokens[:, j : j + 1], vpos[:, j : j + 1], dtables)[0]
        err_w = max(err_w, (dlogits[: BATCH - 1].float() - vlogits[: BATCH - 1, j]).abs().max().item())
    torch.cuda.synchronize()
    for name, err, out in (("decode_paged", err_d, logits), ("step_paged", err_p, plogits),
                           ("verify_paged", err_v, vlogits),
                           ("verify_vs_decode", err_w, vlogits[: BATCH - 1])):
        ok = bool(torch.isfinite(out).all()) and err <= LOGIT_TOL
        print(f"f32-compare{tag} {name} shape={tuple(out.shape)} max_abs_err={err:.3e} "
              f"tol={LOGIT_TOL:g} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"f32{tag} {name}: kernel arm and plain arm disagree")


TRAIN_UPDATES = 9
TRAIN_MICRO = 2
TRAIN_ARGS = [
    "--model_config", "llama_250m", "--dtype", "bfloat16",
    "--batch_size", "8", "--total_batch_size", "16", "--max_length", "512",
    "--use_peft", "true", "--lora_r", "128", "--lr", "1e-3", "--relora", "3",
    "--cycle_length", "3", "--scheduler", "cosine_restarts", "--warmup_steps", "2",
    "--restart_warmup_steps", "1", "--num_training_steps", str(TRAIN_UPDATES),
    "--eval_every", "1000",
]
# pythia_1b's train arguments at full width and depth (the --ab and profile
# tools); the run's pythia train phases take them at PYTHIA_TRAIN_LAYERS
# (:func:`pythia_train_args`): two 2 x 2048
# microbatches an update (8192 tokens, as the llama phase's 16 x 512)
PYTHIA_TRAIN_ARGS = [
    "--model_config", PYTHIA, "--dtype", "bfloat16",
    "--batch_size", "2", "--total_batch_size", "4", "--max_length", "2048",
    "--use_peft", "true", "--lora_r", "128", "--lr", "1e-3", "--relora", "3",
    "--cycle_length", "3", "--scheduler", "cosine_restarts", "--warmup_steps", "2",
    "--restart_warmup_steps", "1", "--num_training_steps", str(TRAIN_UPDATES),
    "--eval_every", "1000",
]
# the depth of the run's pythia drains and train phases (pythia_1b has 16):
# full width, a quarter of the layers, so the phases fit the run's time limit
PYTHIA_TRAIN_LAYERS = 4


def pythia_train_args(work):
    """PYTHIA_TRAIN_ARGS over pythia_1b cut to PYTHIA_TRAIN_LAYERS layers:
    its HF-style ``config.json`` written under ``work`` (every other field
    pythia_1b's, checked by reading it back)."""
    import dataclasses

    from relora_tpu_torch.config.model import load_model_config

    cfg = load_model_config(PYTHIA)
    path = os.path.join(work, f"{PYTHIA}_{PYTHIA_TRAIN_LAYERS}_layers")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({
            "model_type": "gpt_neox", "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.intermediate_size, "num_hidden_layers": PYTHIA_TRAIN_LAYERS,
            "num_attention_heads": cfg.num_attention_heads,
            "max_position_embeddings": cfg.max_sequence_length, "layer_norm_eps": cfg.layer_norm_eps,
            "initializer_range": cfg.initializer_range, "rotary_pct": cfg.rotary_pct,
            "rotary_emb_base": cfg.rotary_emb_base,
            "use_parallel_residual": cfg.use_parallel_residual,
            "tie_word_embeddings": cfg.tie_word_embeddings, "bos_token_id": cfg.bos_token_id,
            "eos_token_id": cfg.eos_token_id,
        }, f)
    cut = dataclasses.replace(cfg, num_hidden_layers=PYTHIA_TRAIN_LAYERS)
    if load_model_config(path) != cut:
        raise AssertionError(f"{path}: reads back as {load_model_config(path)}, not {cut}")
    args = list(PYTHIA_TRAIN_ARGS)
    args[args.index("--model_config") + 1] = path
    return args


# f32-train: flash arm vs naive arm after 2 layers (f32 sums in another
# order, 1e-6 scale per op); "grads" is the worst of layer 0's trainable
# leaves, each relative to its largest entry; the merge vs an f64 oracle at
# f32 rounding
F32_TRAIN_TOL = {"loss": 1e-5, "grad_norm": 1e-4, "grads": 1e-4, "merge": 1e-6}
# the widest head the narrow flash kernels take: past it the launcher
# reports every launch on a wide kernel
NARROW_HEAD_DIM = 128


def write_corpus(work, vocab=32100, seed=0, seq_length=512):
    """A seeded Megatron memmap corpus of Zipf-distributed token ids (so the
    loss has something to learn) and its JSON-form data config at
    ``seq_length`` tokens a sample."""
    import numpy as np

    from relora_tpu_torch.data.memmap import MemmapTokenWriter

    rng = np.random.default_rng(seed)
    prefix = os.path.join(work, "zipf_corpus")
    with MemmapTokenWriter(prefix, dtype=np.uint16) as w:
        for _ in range(600):
            w.add_document((rng.zipf(1.2, int(rng.integers(200, 1500))) - 1) % vocab)
    path = os.path.join(work, f"zipf_data_{seq_length}.json")
    with open(path, "w") as f:
        json.dump({"data_path": prefix, "split": "95,5,0", "seq_length": seq_length, "seed": 1234}, f)
    return path


LORA_NAMES = ("fused_lora_forward", "fused_lora_bwd_dx", "fused_lora_bwd_dab")
INT8_NAMES = ("dequant_matmul", "fused_lora_int8_forward", "fused_lora_int8_bwd_dx")
TC_NAMES = ("fused_lora_forward", "fused_lora_int8_forward",  # wrappers with .tc_launches
            "fused_lora_bwd_dx", "fused_lora_int8_bwd_dx", "fused_lora_bwd_dab", "dequant_matmul")


def _counters():
    """``{name: wrapper}`` of every kernel wrapper a training run launches."""
    from relora_tpu_torch.ops import flash_attention as FA
    from relora_tpu_torch.ops import lora_matmul as LM
    from relora_tpu_torch.ops import quant_matmul as QM

    return {**{n: getattr(FA, n) for n in FLASH_NAMES}, **{n: getattr(LM, n) for n in LORA_NAMES},
            "dequant_matmul": QM.dequant_matmul,
            **{n: getattr(LM, n) for n in INT8_NAMES[1:]}}


class MergeWatch:
    """Wraps the trainer's ``merge_and_reinit`` to read every int8 base
    around each merge: the codes' dtype, how many are nonzero before, how
    many projections' codes it moved (``codes_moved``), how many it wrote
    otherwise than a merge that dropped its delta would (``moved``: codes or
    scales unequal to the requantized base alone), and ``reach``: the
    largest ``|ΔW|`` over half its row's quantization step.  A code moves
    only where the delta reaches half a step, but a row's f32 scale, its
    absmax over 127, moves with any delta at the row's largest weight, so
    ``moved`` sees a merge at any reach.  Every nf4 base likewise
    (``nf4_merges``): how many projections' codes moved, how many moved
    their block scales (``bscale_q``, ``bscale_scale``, ``bscale_offset``:
    double quant re-encodes them every merge), and ``moved``, codes or
    scales."""

    def __init__(self, torch):
        from relora_tpu_torch.train import trainer

        self.torch, self.trainer, self.real = torch, trainer, trainer.merge_and_reinit
        self.merges, self.nf4_merges = [], []

    def __enter__(self):
        self.trainer.merge_and_reinit = self._merge
        return self

    def __exit__(self, *exc):
        self.trainer.merge_and_reinit = self.real

    def _merge(self, model, generator, spec, **kwargs):
        from relora_tpu_torch.core.relora import lora_delta, lora_modules

        from relora_tpu_torch.ops.quant import dequantize_int8, quantize_int8

        modules = [m for _, m in lora_modules(model) if getattr(m, "weight_q", None) is not None]
        nf4 = [m for _, m in lora_modules(model) if getattr(m, "weight_codes", None) is not None]
        nf4_leaves = ("weight_codes", "weight_bscale_q", "weight_bscale_scale", "weight_bscale_offset")
        nf4_before = [[getattr(m, leaf).clone() for leaf in nf4_leaves] for m in nf4]
        before = [m.weight_q.clone() for m in modules]
        # what each projection would hold after a merge that dropped its delta
        idle = [quantize_int8(dequantize_int8(m.weight_q, m.weight_scale)) for m in modules]
        reach = max((float((lora_delta(m, spec).abs() / (m.weight_scale.t() / 2)).max())
                     for m in modules), default=0.0)
        out = self.real(model, generator, spec, **kwargs)
        eq = self.torch.equal
        self.merges.append({
            "modules": len(modules),
            "nonzero_before": sum(int(q.count_nonzero()) for q in before),
            "int8_after": all(m.weight_q.dtype == self.torch.int8 for m in modules),
            "codes_moved": sum(int(not eq(m.weight_q, b)) for m, b in zip(modules, before)),
            "moved": sum(int(not (eq(m.weight_q, q) and eq(m.weight_scale, s)))
                         for m, (q, s) in zip(modules, idle)),
            "reach": reach,
        })
        if nf4:
            eq = self.torch.equal
            after = [[getattr(m, leaf) for leaf in nf4_leaves] for m in nf4]
            codes = [not eq(a[0], b[0]) for a, b in zip(after, nf4_before)]
            scales = [not all(eq(x, y) for x, y in zip(a[1:], b[1:])) for a, b in zip(after, nf4_before)]
            self.nf4_merges.append({
                "modules": len(nf4), "codes_moved": sum(codes), "scales_moved": sum(scales),
                "moved": sum(c or s for c, s in zip(codes, scales)),
                "uint8_after": all(m.weight_codes.dtype == self.torch.uint8 for m in nf4),
            })
        return out


class GraftWatch:
    """Wraps the trainer's ``load_warm_start`` to hold every base parameter
    of the model, right after the graft, to its source tensor in the file
    (the HF name's prefix stripped, cast to the parameter's dtype), an nf4
    base dequantized within nf4's error bound of the file's weight (half the
    widest codebook gap times its block's absmax, plus the double quant's
    step of that absmax; ``nf4_worst`` is the largest error in units of the
    bound).  A model with an int8 base is left alone: its codes are checked
    around the merges (:class:`MergeWatch`)."""

    def __init__(self, torch):
        from relora_tpu_torch.train import trainer

        self.torch, self.trainer, self.real = torch, trainer, trainer.load_warm_start
        self.checked, self.nf4_worst = 0, 0.0

    def __enter__(self):
        self.trainer.load_warm_start = self._load
        return self

    def __exit__(self, *exc):
        self.trainer.load_warm_start = self.real

    def _load(self, model, path):
        from relora_tpu_torch.core.relora import is_lora_name
        from relora_tpu_torch.models.warm_start import WEIGHTS_FILE, strip_hf_prefix

        out = self.real(model, path)
        if any(name.endswith(".weight_q") for name, _ in model.named_parameters()):
            return out
        src = {strip_hf_prefix(k): v for k, v in self.torch.load(
            os.path.join(path, WEIGHTS_FILE), map_location="cpu", weights_only=True).items()}
        modules = dict(model.named_modules())
        for name, p in model.named_parameters():
            if is_lora_name(name) or name.rsplit(".", 1)[-1].startswith("weight_bscale"):
                continue  # an nf4 base's scales are checked with its codes
            if name.endswith(".weight_codes"):
                module = name[: -len(".weight_codes")]
                self.nf4_worst = max(self.nf4_worst,
                                     nf4_error(self.torch, modules[module], src[f"{module}.weight"]))
                if not self.nf4_worst <= 1.0:
                    raise AssertionError(f"warm start: {module}'s nf4 base is {self.nf4_worst:.3f}x "
                                         "nf4's error bound off the file's weight")
                self.checked += 1
                continue
            if not self.torch.equal(p.detach().cpu(), src[name].to(p.dtype)):
                raise AssertionError(f"warm start: {name} differs from the file's after the graft")
            self.checked += 1
        return out


def nf4_error(torch, module, weight):
    """The largest error of ``module``'s dequantized nf4 base against the
    ``(out, in)`` source ``weight``, in units of nf4's bound: half the widest
    code gap times the block's absmax, plus one double-quant step (the
    block scale stored as int8 over its column's spread)."""
    import numpy as np

    from relora_tpu_torch.ops.quant import NF4_CODEBOOK, NF4_LEAVES, dequantize_nf4, nf4_block_for

    gap = float(np.diff(NF4_CODEBOOK).max())  # a value lies within half of it of its code
    leaves = {leaf: getattr(module, param) for param, leaf in NF4_LEAVES.items()}
    deq = dequantize_nf4(leaves)  # (in, out)
    w = weight.to(device=deq.device, dtype=torch.float32).t()
    block = nf4_block_for(w.shape[0])
    absmax = w.abs().reshape(-1, block, w.shape[1]).amax(dim=1)
    scale_step = leaves["bscale_scale"] if leaves["bscale_q"].dtype == torch.int8 else 0.0
    bound = absmax * gap / 2 + scale_step + 1e-6
    err = (deq - w).abs().reshape(-1, block, w.shape[1]).amax(dim=1)
    return float((err / bound).max())


class ArmWatch:
    """Wraps ``lora_dispatch.choose_arm`` to count the arm ``lora_matmul(arm=
    "auto")`` takes per call: ``{(K, N, backward, arm): calls}``."""

    def __init__(self):
        from relora_tpu_torch.ops import lora_dispatch

        self.module, self.real = lora_dispatch, lora_dispatch.choose_arm
        self.calls = {}

    def __enter__(self):
        self.module.choose_arm = self._choose
        return self

    def __exit__(self, *exc):
        self.module.choose_arm = self.real

    def _choose(self, M, K, N, r, *args, **kwargs):
        arm = self.real(M, K, N, r, *args, **kwargs)
        key = (K, N, bool(kwargs.get("backward")), arm)
        self.calls[key] = self.calls.get(key, 0) + 1
        return arm

    def count(self, arm, backward=None):
        return sum(n for (_, _, bwd, a), n in self.calls.items()
                   if a == arm and backward in (None, bwd))

    def summary(self):
        """``{"KxN fwd|fwd_bwd": {arm: calls}}``, printable."""
        out = {}
        for (K, N, bwd, arm), n in sorted(self.calls.items()):
            out.setdefault(f"{K}x{N} {'fwd_bwd' if bwd else 'fwd'}", {})[arm] = n
        return out


TELEMETRY_DIR = os.path.join(REPO, "build", "chip_smoke", "telemetry")
GAP_SHARES = ("data_fetch", "dispatch", "compute", "comms", "host")
SHARE_SUM_TOL = 1e-3  # the waterfall's shares, each rounded to 1e-4, sum to 1


def telemetry(torch, save_dir, result, windows):
    """The run's ``save_dir/metrics.jsonl`` read back: the median mfu of
    updates 2-9 and the peak it used, the counted step FLOPs, the mean
    waterfall shares, the trainer's last HBM peak beside the phase's own;
    ``problems`` lists every check that failed (``windows``: the mfu_gap
    records expected)."""
    import statistics

    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    steps = [r for r in records if "loss" in r and "_event" not in r]
    gaps = [r for r in records if "mfu_gap/wall_s" in r]
    plans = [r for r in records if r.get("_event") == "memory_plan"]
    mfus = [r["mfu"] for r in steps]
    hbm = gaps[-1].get("hbm/peak_bytes_in_use") if gaps else None
    phase_peak = torch.cuda.max_memory_allocated()
    # the independent figure: parameters and AdamW state by their sizes
    plan_bytes = plans[-1]["total_bytes"] if plans else None
    report = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "perf_report.py"), save_dir, "--bench-dir", ""],
        capture_output=True, text=True, timeout=120,
    )
    problems = []
    if len(steps) != TRAIN_UPDATES or not all(m is not None and 0 < m <= 1 for m in mfus):
        problems.append(f"{len(steps)} step records with mfu {mfus}: expected {TRAIN_UPDATES} in (0, 1]")
    sums = [sum(g[f"mfu_gap/{k}"] for k in GAP_SHARES) for g in gaps]
    if len(gaps) != windows or not all(abs(x - 1) <= SHARE_SUM_TOL for x in sums):
        problems.append(f"{len(gaps)} mfu_gap records (expected {windows}) with shares summing to {sums}")
    if hbm is None or plan_bytes is None or not plan_bytes <= hbm <= phase_peak:
        problems.append(f"trainer HBM peak {hbm} outside [the memory plan's total_bytes {plan_bytes}, "
                        f"the phase's peak {phase_peak}]")
    if report.returncode != 0 or "MFU-gap waterfall" not in report.stdout or (
            "per-pytree" not in report.stdout):
        problems.append(f"perf_report.py exit {report.returncode}: {report.stdout[-500:]}"
                        f"{report.stderr[-500:]}")
    return {
        "mfu": statistics.median(mfus[1:]) if len(mfus) > 1 and None not in mfus else None,
        "peak_flops": result["peak_flops"], "step_flops": result["step_flops"],
        "mfu_gap": {k: statistics.fmean(g[f"mfu_gap/{k}"] for g in gaps) for k in GAP_SHARES}
        if gaps else None,
        "mfu_gap_windows": len(gaps), "hbm_peak_bytes": hbm, "max_memory_allocated": phase_peak,
        "plan_total_bytes": plan_bytes, "plan_params_bytes": plans[-1]["params_bytes"] if plans else None,
        "problems": problems,
    }


def train(torch, data_config, label="train", extra=(), base_args=TRAIN_ARGS):
    """Phases train, fused-train, int8_train, int8_fused_train, the pythia
    train phases and profile_train: ``relora_tpu_torch.main`` on the card
    over ``base_args`` plus ``extra`` (plus ``--save_dir`` under
    TELEMETRY_DIR where they set none), counters read around the run, for
    an int8 base each merge's codes read around it, for a dense warm start
    the grafted base held to the file, and the run's telemetry read back."""
    from relora_tpu_torch import main as train_main
    from relora_tpu_torch.config.model import load_model_config

    counters = _counters()
    for c in counters.values():
        c.launches = 0
    for n in TC_NAMES:
        counters[n].tc_launches = 0
    for n in FLASH_NAMES:
        counters[n].wide_launches = 0
    argv = list(base_args) + list(extra)
    own_dir = None
    if "--save_dir" not in argv:
        own_dir = os.path.join(TELEMETRY_DIR, label)
        shutil.rmtree(own_dir, ignore_errors=True)
        argv += ["--save_dir", own_dir]
    model_name = argv[argv.index("--model_config") + 1]
    cfg = load_model_config(model_name)
    flag = dict(zip(argv, argv[1:]))
    fused = flag.get("--lora_fused", "false") == "true"
    auto = flag.get("--lora_fused") == "auto"
    int8 = flag.get("--quantize") == "int8"
    nf4 = flag.get("--quantize") == "nf4"  # every projection even: no int8 fallback here
    remat = flag.get("--remat") == "true"  # kernel 3's forward runs again in every backward
    gc.collect()  # what earlier phases left unreachable is not this phase's peak
    torch.cuda.reset_peak_memory_stats()
    with MergeWatch(torch) as watch, GraftWatch(torch) as graft, ArmWatch() as arms:
        result = train_main.main(argv + ["--megatron_dataset_config", data_config])
    launches = {n: c.launches for n, c in counters.items()}
    tc = {n: counters[n].tc_launches for n in TC_NAMES}
    wide = {n: counters[n].wide_launches for n in FLASH_NAMES}

    records = result["records"]
    losses = [r["loss"] for r in records]
    layers = cfg.num_hidden_layers
    projections = 7 if cfg.family == "llama" else 4  # LoRA projections a layer
    backward = layers * TRAIN_MICRO * TRAIN_UPDATES
    forward = backward + layers * result["eval_batches"]
    # fused launches: every projection under --lora_fused true, the calls the
    # cost model sent to the fused arm under auto (which never runs kernel 8)
    fwd_fused = arms.count("fused") if auto else projections * forward if fused else 0
    bwd_fused = arms.count("fused", backward=True) if auto else projections * backward if fused else 0
    want = {
        "flash_attention_forward": forward + (backward if remat else 0),
        "flash_attention_bwd_dkdv": backward,
        "flash_attention_bwd_dq": backward,
        "fused_lora_forward": 0 if int8 else fwd_fused,
        "fused_lora_bwd_dx": 0 if int8 else bwd_fused,
        "fused_lora_bwd_dab": bwd_fused,
        "dequant_matmul": projections * forward if int8 and not (fused or auto) else 0,
        "fused_lora_int8_forward": fwd_fused if int8 else 0,
        "fused_lora_int8_bwd_dx": bwd_fused if int8 else 0,
    }
    if auto and sum(arms.calls.values()) != projections * forward:
        raise AssertionError(f"{label}: {sum(arms.calls.values())} projections took the cost "
                             f"model, expected {projections * forward}")
    merges_at = [r["update_step"] for a, r in zip([None] + records, records)
                 if a is not None and r["n_lora_restarts"] > a["n_lora_restarts"]]
    resets_at = [r["update_step"] for a, r in zip([None] + records, records)
                 if a is not None and r["n_optimizer_resets"] > a["n_optimizer_resets"]]
    steady = sorted(r["update_seconds"] for r in records[1:])
    ms = steady[len(steady) // 2] * 1e3
    tokens = int(argv[argv.index("--total_batch_size") + 1]) * int(argv[argv.index("--max_length") + 1])
    line = {
        label: model_name, "updates": len(records), "ms_per_update": ms,
        "tokens_per_s": tokens / (ms / 1e3), "first_loss": losses[0], "last_loss": losses[-1],
        "final_eval_loss": result.get("final_eval_loss"), "merges_at": merges_at,
        "resets_at": resets_at, "eval_batches": result["eval_batches"], "launches": launches,
        "tc_launches": tc, "wide_launches": wide, "fit_seconds": result["fit_seconds"],
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "losses": losses,
    }
    if auto:
        line["arms"] = arms.summary()
    if int8:
        line["int8_merges"] = watch.merges
    if nf4:
        line["nf4_merges"] = watch.nf4_merges
        line["nf4_graft_worst_in_bounds"] = graft.nf4_worst
    if graft.checked:
        line["grafted_params_checked"] = graft.checked
    line["telemetry"] = telemetry(torch, flag["--save_dir"], result,
                                  -(-TRAIN_UPDATES // int(flag.get("--log_every", 1))))
    if own_dir:  # the phase keeps its metrics, not its checkpoints
        for name in os.listdir(own_dir):
            if name.startswith("model_"):
                shutil.rmtree(os.path.join(own_dir, name))
    print(json.dumps(line))
    if line["telemetry"]["problems"]:
        raise AssertionError(f"{label}: telemetry {line['telemetry']['problems']}")
    if len(records) != TRAIN_UPDATES or not all(torch.isfinite(torch.tensor(losses))):
        raise AssertionError(f"{label}: expected {TRAIN_UPDATES} finite losses, got {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: loss did not fall ({losses[0]} -> {losses[-1]})")
    if merges_at != [4, 7] or resets_at != [4, 7] or result["n_lora_restarts"] != 2:
        raise AssertionError(f"{label}: merges at {merges_at}, resets at {resets_at}, expected [4, 7]")
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, expected {want}")
    if tc != {n: launches[n] for n in TC_NAMES}:
        raise AssertionError(f"{label}: forwards, dx and dA/dB on the tensor cores {tc} of "
                             f"{launches}: the model's bf16 layout must take the tensor-core path "
                             "every time")
    if wide != {n: launches[n] if cfg.head_dim > NARROW_HEAD_DIM else 0 for n in FLASH_NAMES}:
        raise AssertionError(f"{label}: the launcher reported {wide} wide flash launches of "
                             f"{launches} at head_dim {cfg.head_dim}: every attention must take "
                             "the kernels of its width")
    # every merge writes its delta into every projection's codes or scales
    if int8 and not (len(watch.merges) == 2 and all(
            m["modules"] == m["moved"] == projections * layers and m["nonzero_before"] > 0
            and m["int8_after"] for m in watch.merges)):
        raise AssertionError(f"{label}: int8 merges {watch.merges}: expected 2 merges over the "
                             f"nonzero int8 codes of {projections * layers} projections, each "
                             "moving every projection's codes or scales off its unmerged base")
    if nf4 and not (len(watch.nf4_merges) == 2 and all(
            m["modules"] == m["moved"] == projections * layers and m["uint8_after"]
            for m in watch.nf4_merges)):
        raise AssertionError(f"{label}: nf4 merges {watch.nf4_merges}: expected 2 merges, each "
                             f"moving the codes or block scales of all {projections * layers} "
                             "projections")
    if "--warmed_up_model" in extra and not int8 and graft.checked == 0:
        raise AssertionError(f"{label}: the warm start grafted no base parameter")
    return launches, line


def profile_train(torch, data_config, label="profile_train"):
    """Phase profile_train: the fused-train run with ``--profile true``,
    checked as train(), then its ``torch.profiler`` windows: two Chrome
    traces under ``profiler_logs/<label>`` (the trainer's run name is its
    save_dir's), each loading, that name ``flash_fwd_tc_kernel`` and one of
    the port's LoRA or int8 kernels among their device kernels."""
    import glob

    trace_dir = os.path.join(os.getcwd(), "profiler_logs", label)
    shutil.rmtree(trace_dir, ignore_errors=True)
    train(torch, data_config, label, ["--lora_fused", "true", "--lora_dropout", "0",
                                      "--profile", "true"])
    traces = sorted(glob.glob(os.path.join(trace_dir, "trace_*.json")))
    kernels, runtime = set(), {}
    for path in traces:
        with open(path) as f:
            for e in json.load(f)["traceEvents"]:
                if e.get("cat") == "kernel":
                    kernels.add(e.get("name", ""))
                elif e.get("cat") == "cuda_runtime":  # the host's CUDA calls: where it waits
                    runtime[e["name"]] = runtime.get(e["name"], 0.0) + e.get("dur", 0.0) / 1e3
    port = ("flash_fwd_tc_kernel",) + FWD_TC_KERNELS + DX_TC_KERNELS + DAB_KERNELS + DEQUANT_TC_KERNELS
    found = sorted(k for k in port if any(k in name for name in kernels))
    print(json.dumps({label: "llama_250m", "traces": [os.path.basename(t) for t in traces],
                      "bytes": [os.path.getsize(t) for t in traces], "device_kernels": len(kernels),
                      "port_kernels_named": found,
                      "host_cuda_calls_ms": dict(sorted(runtime.items(), key=lambda kv: -kv[1])[:8])}))
    if len(traces) != 2 or "flash_fwd_tc_kernel" not in found or len(found) < 2:
        raise AssertionError(f"{label}: traces {traces} name {found} of the port's kernels; "
                             "expected two windows naming flash_fwd_tc_kernel and a LoRA kernel")


GLUE_MODEL = "llama_250m"
GLUE_BATCH = 32
GLUE_WIDTHS = (32, 64, 96, 128)  # run_glue's pad buckets up to --max_seq_length 128
GLUE_EPOCHS = 2  # each arm: 2 epochs of one batch a bucket, 8 updates
GLUE_EVAL, GLUE_PREDICT = 64, 32
GLUE_FLASH = (GLUE_BATCH, 128, 16, 16, 48, "f32")  # kernel 3's f32 arm at the widest bucket
GLUE_LORA = dict(r=8, alpha=16.0)  # the written checkpoint's unmerged factors


def write_glue_checkpoint(torch, work, device):
    """A seeded llama_250m ``train/checkpoint.py`` directory with unmerged
    LoRA factors (B drawn nonzero) and their ``relora_config.json``."""
    from relora_tpu_torch.config.model import load_model_config
    from relora_tpu_torch.core.relora import LoraSpec
    from relora_tpu_torch.models.llama import LlamaForCausalLM
    from relora_tpu_torch.train.checkpoint import save_checkpoint

    root = os.path.join(work, "glue_llama_250m")
    shutil.rmtree(root, ignore_errors=True)
    spec = LoraSpec(**GLUE_LORA)
    with torch.device(device):
        model = LlamaForCausalLM(load_model_config(GLUE_MODEL), lora=spec)
    seeded_init(torch, model, torch.Generator(device=device).manual_seed(41), lora_b=True)
    path = save_checkpoint(root, 0, model.state_dict(), {"update_step": 0}, lora_spec=spec)
    del model
    return path


GLUE_RANGES = ((1000, 1064), (2000, 2064))  # label l draws its ids from GLUE_RANGES[l]


def glue_rows(n, seed):
    """``n`` rows of a seeded two-class task, class by token range (label
    ``l`` draws its ids from ``GLUE_RANGES[l]``, narrow enough that training
    sees every id), right-padded with the pad id 0 to 128.  Batch ``i`` of
    GLUE_BATCH rows takes lengths in ``[max(20, w - 31), w]`` for ``w =
    GLUE_WIDTHS[i % 4]``, so ``run_glue.pad_bucket`` gives every width."""
    import numpy as np

    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, n)
    ids = np.zeros((n, GLUE_WIDTHS[-1]), np.int32)
    for r in range(n):
        w = GLUE_WIDTHS[(r // GLUE_BATCH) % len(GLUE_WIDTHS)]
        length = rng.integers(max(20, w - 31), w + 1)
        ids[r, :length] = rng.integers(*GLUE_RANGES[labels[r]], length)
    return ids, labels


def glue(torch, device, work):
    """Phase glue: the quick start's last step on the card.  A seeded
    llama_250m port checkpoint with unmerged LoRA factors, read by
    ``run_glue.load_backbone`` (merged), is fine-tuned through
    ``eval/glue.finetune`` at f32 on a two-class task (batch 32, each batch
    trimmed by ``run_glue.pad_bucket``: widths 32-128), 8 updates with
    ``use_lora`` false, then 8 with it true; each arm evaluates 64 rows and
    predicts 32.  Fails unless every loss is finite, every metric lies in
    [0, 1], kernel 3's f32 forward, dK/dV and dQ each launched (counters
    zeroed before the two arms, read after), and the classifier's logits on
    the flash arm lie within LOGIT_TOL of the naive arm's on every width.
    Then the three kernels are checked against their twins and timed at
    GLUE_FLASH.  Returns the kernel rows ``...@glue``."""
    import statistics

    import numpy as np

    from relora_tpu_torch.config.model import load_model_config
    from relora_tpu_torch.eval import glue as G
    from relora_tpu_torch.ops import flash_attention as FA
    from relora_tpu_torch.run_glue import load_backbone, pad_bucket

    cfg = load_model_config(GLUE_MODEL)
    backbone = load_backbone(write_glue_checkpoint(torch, work, device))
    steps = len(GLUE_WIDTHS)
    train = glue_rows(GLUE_BATCH * steps, seed=1)
    evals = glue_rows(GLUE_EVAL, seed=2)
    test = glue_rows(GLUE_PREDICT, seed=3)[0]
    max_len = GLUE_WIDTHS[-1]

    def batches(ids, labels):
        return lambda: ((pad_bucket(ids[i:i + GLUE_BATCH], 0, max_len), labels[i:i + GLUE_BATCH])
                        for i in range(0, len(ids), GLUE_BATCH))

    counters = {n: getattr(FA, n) for n in FLASH_NAMES}
    for c in counters.values():
        c.launches = 0
    arms = {}
    for use_lora in (False, True):
        gc.collect()
        torch.cuda.empty_cache()
        stamps, losses, evaluated = [], [], {}

        def on_step(step, loss):
            losses.append(loss.item())  # waits for the update
            stamps.append(time.perf_counter())

        def timed_eval():
            t0 = time.perf_counter()
            yield from batches(*evals)()
            evaluated["s"] = time.perf_counter() - t0  # after the last batch's predictions

        gcfg = G.GlueConfig(task="sst2", batch_size=GLUE_BATCH, num_epochs=GLUE_EPOCHS,
                            max_length=max_len, use_lora=use_lora, seed=0)
        metrics, preds = G.finetune(
            cfg, gcfg, batches(*train), timed_eval, steps, pad_token_id=0, pretrained_backbone=backbone,
            predict_batches=lambda: (pad_bucket(test[i:i + GLUE_BATCH], 0, max_len)
                                     for i in range(0, len(test), GLUE_BATCH)),
            device=device, on_step=on_step)
        label = "lora" if use_lora else "full"
        arms[label] = {"ms_per_step": statistics.median(np.diff(stamps)) * 1e3,
                       "losses": losses, "eval_rows_per_s": GLUE_EVAL / evaluated["s"],
                       "metrics": metrics}
        if (len(losses) != steps * GLUE_EPOCHS or not np.isfinite(losses).all()
                or preds.shape != (GLUE_PREDICT,) or not all(0.0 <= v <= 1.0 for v in metrics.values())):
            raise AssertionError(f"glue: the {label} arm failed: {arms[label]} {preds}")
    launches = {n: c.launches for n, c in counters.items()}

    gc.collect()
    torch.cuda.empty_cache()
    model = G.build_classifier(cfg, 2, 0, None, device, pretrained_backbone=backbone)
    logit_err, finite = 0.0, True
    with torch.no_grad():
        for i in range(0, len(train[0]), GLUE_BATCH):  # half a training batch at each width
            ids = torch.as_tensor(pad_bucket(train[0][i:i + GLUE_BATCH // 2], 0, max_len), device=device)
            out = {}
            for arm in ("auto", "naive"):
                model.model.attention_arm = arm
                out[arm] = model(ids.long())
            finite = finite and bool(torch.isfinite(out["auto"]).all())
            logit_err = max(logit_err, (out["auto"] - out["naive"]).abs().max().item())
    del model
    line = {"glue": GLUE_MODEL, "batch": GLUE_BATCH, "widths": list(GLUE_WIDTHS), "arms": arms,
            "launches": launches, "logits_max_abs_err": logit_err, "logit_tol": LOGIT_TOL}
    print(json.dumps(line))
    if not all(launches.values()):
        raise AssertionError(f"glue: a kernel 3 f32 kernel never launched: {launches}")
    if not finite or logit_err > LOGIT_TOL:
        raise AssertionError(f"glue: flash-arm logits off the naive arm's by {logit_err:.3e}")
    torch.cuda.empty_cache()
    rows = flash_rows(torch, device, GLUE_FLASH, check_flash_case(torch, device, GLUE_FLASH, seed=43),
                      "@glue")
    take_launches(rows, launches, "glue")
    return rows


def two_layer(model_name):
    """``model_name``'s config cut to 2 layers (the f32 phases' depth), and
    the label its f32 phases print."""
    import dataclasses

    from relora_tpu_torch.config.model import load_model_config

    cfg = dataclasses.replace(load_model_config(model_name), num_hidden_layers=2)
    return cfg, "" if model_name == "llama_250m" else f"@{model_name}"


def seeded_init(torch, model, gen, lora_b=False):
    """``init_params`` from ``gen``, then every bias drawn nonzero (a NeoX
    model's; a Llama has none), so the f32 phases see the biases work, and
    with ``lora_b`` every LoRA B too."""
    from relora_tpu_torch.models.params_util import init_params

    init_params(model, gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".bias") or (lora_b and name.endswith("lora_b")):
                p.copy_(torch.randn(p.shape, generator=gen, device=p.device) * 0.02)
    return model


def layer0_grads(torch, model, batch):
    """Gradients of layer 0's trainable leaves under the train step's loss
    (the mean over ``batch``'s microbatches), taken before the update: each
    flows back through both layers' attention and LoRA projections."""
    from relora_tpu_torch.train.losses import causal_lm_loss

    model.zero_grad(set_to_none=True)
    for micro in batch:
        loss, _ = causal_lm_loss(model(micro), micro)
        (loss / batch.shape[0]).backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if n.startswith("layers.0.") and p.requires_grad}
    model.zero_grad(set_to_none=True)
    return grads


def check_grads(phase, grads, ref):
    """Each leaf of ``grads`` against ``ref``'s, relative to the leaf's
    largest reference entry; prints every leaf's error and fails past
    ``F32_TRAIN_TOL["grads"]`` (or on a reference leaf that is all zero)."""
    errs = {n: ((g - ref[n]).abs().max() / ref[n].abs().max()).item() for n, g in grads.items()}
    worst = max(errs, key=lambda n: errs[n] if errs[n] == errs[n] else float("inf"))
    ok = all(e <= F32_TRAIN_TOL["grads"] for e in errs.values())
    print(json.dumps({f"{phase} grads": errs}))
    print(f"{phase} grads worst={worst} rel_err={errs[worst]:.3e} "
          f"tol={F32_TRAIN_TOL['grads']:g} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{phase}: the gradient of {worst} off by {errs[worst]:.3e}")


def f32_train(torch, device, model_name="llama_250m"):
    """Phase f32-train: one update of a 2-layer ``model_name`` through the
    flash arm and the naive arm from the same weights and batch, then a
    merge against an f64 oracle."""
    import numpy as np

    from relora_tpu_torch.core import optim, relora
    from relora_tpu_torch.models.family import causal_lm_class
    from relora_tpu_torch.ops import flash_attention as FA
    from relora_tpu_torch.train.step import TrainState, make_train_step

    cfg, tag = two_layer(model_name)
    spec = relora.LoraSpec(r=128, alpha=32.0, dropout=0.0)
    rng = np.random.default_rng(5)
    batch = torch.as_tensor((rng.zipf(1.2, (2, 4, 512)) - 1) % cfg.vocab_size, device=device)
    state_dict, out, grads = None, {}, {}
    n0 = FA.flash_attention_bwd_dq.launches
    wide0 = FA.flash_attention_bwd_dq.wide_launches
    for arm in ("flash", "naive"):
        with torch.device(device):
            model = causal_lm_class(cfg)(cfg, dtype=torch.float32, attention_arm=arm, lora=spec)
        if state_dict is None:
            seeded_init(torch, model, torch.Generator(device=device).manual_seed(3), lora_b=True)
            state_dict = {k: v.clone() for k, v in model.state_dict().items()}
        model.load_state_dict(state_dict)
        relora.set_trainable(model)
        grads[arm] = layer0_grads(torch, model, batch)
        opt = optim.build_optimizer(p for p in model.parameters() if p.requires_grad)
        step = make_train_step(model, opt, clip_grad_norm=1.0, schedule=lambda s: 1e-3)
        out[arm] = (step(TrainState(), batch), model)
    launched = FA.flash_attention_bwd_dq.launches - n0
    if launched == 0:
        raise AssertionError("f32-train: the flash arm did not reach the kernels")
    wide = FA.flash_attention_bwd_dq.wide_launches - wide0
    if wide != (launched if cfg.head_dim > NARROW_HEAD_DIM else 0):
        raise AssertionError(f"f32-train{tag}: the launcher reported {wide} of {launched} dQ "
                             f"launches on the wide kernels at head_dim {cfg.head_dim}")
    check_grads(f"f32-train{tag}", grads["flash"], grads["naive"])
    (mf, model), (mn, _) = out["flash"], out["naive"]
    errs = {k: abs(mf[k] - mn[k]) / abs(mn[k]) for k in ("loss", "grad_norm")}

    module = next(relora.lora_modules(model))[1]
    oracle = module.weight.double() + (
        module.lora_a.double() @ module.lora_b.double() * spec.scale).t()
    relora.merge_and_reinit(model, torch.Generator(device=device).manual_seed(4), spec)
    errs["merge"] = ((module.weight.double() - oracle).abs().max() / oracle.abs().max()).item()
    for key, err in errs.items():
        ok = err <= F32_TRAIN_TOL[key]
        print(f"f32-train{tag} {key} flash={mf.get(key)} naive={mn.get(key)} rel_err={err:.3e} "
              f"tol={F32_TRAIN_TOL[key]:g} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"f32-train{tag}: {key} off by {err:.3e}")


# kernels 4, 6, 7: llama_250m's projections at the train phase's M = 8 x 512
# and r = 128, (K, N) per shape and how many of each one decoder layer runs
LORA_M, LORA_R = 8 * 512, 128
LORA_SHAPES = ((768, 768, 4), (768, 2560, 2), (2560, 768, 1))  # q/k/v/o, gate/up, down
# pythia_1b's projections, one each a layer: fused QKV, dense, h->4h, 4h->h
# (the pythia train phase's M is 2 x 2048 = LORA_M as well)
PYTHIA_LORA_SHAPES = ((2048, 6144, 1), (2048, 2048, 1), (2048, 8192, 1), (8192, 2048, 1))
# error relative to max(1, max|twin|): f32 sums K = 2560 terms in another
# order; bf16 outputs round once to bf16 (2^-8 relative)
LORA_TOL = {"f32": 1e-4, "bf16": 1e-2}
LORA_LINES = {"fused_lora_forward": 102, "fused_lora_bwd_dx": 317, "fused_lora_bwd_dab": 343}


def make_lora_case(torch, device, M, K, N, r, dtype, seed, transposed=True):
    """x, W (K, N), A, B and a cotangent g, drawn like a layer's: W as the
    (N, K) weight's transposed view (or a contiguous (K, N) copy), A
    kaiming-uniform, B small."""
    g = torch.Generator(device=device).manual_seed(seed)
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    x = torch.randn((M, K), generator=g, device=device).to(dt)
    w_nk = (torch.randn((N, K), generator=g, device=device) * 0.02).to(dt)
    a = ((torch.rand((K, r), generator=g, device=device) * 2 - 1) / K**0.5).to(dt)
    b = (torch.randn((r, N), generator=g, device=device) * 0.02).to(dt)
    gy = torch.randn((M, N), generator=g, device=device).to(dt)
    return x, (w_nk.t() if transposed else w_nk.t().contiguous()), a, b, gy


def _rel_err(pairs):
    """(max abs error, error relative to max(1, max|twin|), all finite)."""
    err = rel = 0.0
    finite = True
    for got, want in pairs:
        got, want = got.float(), want.float()
        finite = finite and bool(got.isfinite().all() and want.isfinite().all())
        diff = (got - want).abs().max().item()
        err = max(err, diff)
        rel = max(rel, diff / max(1.0, want.abs().max().item()))
    return err, rel, finite


# the ragged case the tensor-core forward takes: partial k-steps (K = 72),
# a partial N tile (N = 104) and a rank below one m16n8k16 depth (r = 8)
RAGGED_TC = (200, 72, 104, 8, "bf16", True)
# the forward's two kernels on the tensor cores, and kernel 4-int8's; the
# dx's (u, then dx over a bf16 or an int8 base)
FWD_TC_KERNELS = ("fused_fwd_z_tc_kernel", "fused_fwd_y_tc_bf16_kernel",
                  "fused_fwd_y_tc_int8_kernel")
DX_TC_KERNELS = ("fused_dx_u_tc_kernel", "fused_dx_tc_bf16_kernel", "fused_dx_tc_int8_kernel")
DEQUANT_TC_KERNELS = ("dequant_matmul_tc_kernel",)  # kernel 8 on the tensor cores
DAB_TC_KERNELS = ("dab_tc_kernel",)  # kernel 7's partials on the tensor cores
DAB_KERNELS = DAB_TC_KERNELS + ("dab_split_kernel",)  # and its split pass
# kernel 1's split walk and its combine, and kernel 2's tensor-core tiles
# (its other tokens take kernel 1's pair)
PAGED_TC_KERNELS = ("packed_tile_kernel",)
PAGED_KERNELS = ("paged_decode_kernel", "paged_combine_kernel") + PAGED_TC_KERNELS


def check_path(wrapper, tc_before, x, K, N, r, transposed):
    """The path a forward, dx or kernel-8 call (``r=None``) took (``"tc"``
    if it counted a tensor-core launch), held to :func:`forward_path`'s rule
    for its inputs: bf16 with the transposed base and widths that are
    multiples of 8 take the tensor cores, everything else the FMA kernel."""
    from relora_tpu_torch.ops import lora_matmul as LM

    path = "tc" if wrapper.tc_launches > tc_before else "fma"
    strides = (1, K) if transposed else (N, 1)
    if path != LM.forward_path(x.dtype, strides, K, N, r):
        raise AssertionError(f"{wrapper.__name__} took the {path} path at {x.dtype} "
                             f"M={x.shape[0]} K={K} N={N} r={r} transposed={transposed}")
    return path


def check_dab_path(tc_before, x, K, N, r):
    """The path a dA/dB call took, held to :func:`dab_path`'s rule."""
    from relora_tpu_torch.ops import lora_matmul as LM

    path = "tc" if LM.fused_lora_bwd_dab.tc_launches > tc_before else "fma"
    if path != LM.dab_path(x.dtype, K, N, r):
        raise AssertionError(f"fused_lora_bwd_dab took the {path} path at {x.dtype} "
                             f"M={x.shape[0]} K={K} N={N} r={r}")
    return path


def lora_bound(M, K, N, r, e, kernel):
    """The two terms of the least time on an H100 SXM, in ms: each input
    read once and each output written once (e bytes per element, f32 for z,
    u, dA, dB) over 3.35 TB/s, and the matmul work over the bf16
    tensor-core peak.  dA/dB as the main path calls it, with u from dx."""
    bytes_, flops = {
        "fused_lora_forward": (e * (M * K + K * N + K * r + r * N + M * N) + 4 * M * r,
                               2 * M * (K * N + K * r + r * N)),
        "fused_lora_bwd_dx": (e * (M * N + K * N + K * r + r * N + M * K) + 4 * M * r,
                              2 * M * (N * K + N * r + r * K)),
        "fused_lora_bwd_dab": (e * (M * N + M * K) + 4 * (2 * M * r + K * r + r * N),
                               2 * M * r * (K + N)),
    }[kernel]
    return bytes_ / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3


def check_lora_kernels(torch, device):
    """Phase kernels-4: kernels 4, 6, 7 against their twins on the card,
    then timings per llama_250m and pythia_1b shape beside the twin, the
    ordered cuBLAS chain of the default path and the bound."""
    from relora_tpu_torch.core.relora import full_f32_matmul
    from relora_tpu_torch.ops import lora_matmul as LM

    worst = dict.fromkeys(LORA_NAMES, 0.0)
    worst_pythia = dict.fromkeys(LORA_NAMES, 0.0)
    pythia_shapes = {(K, N) for K, N, _ in PYTHIA_LORA_SHAPES}
    cases = [(LORA_M, K, N, LORA_R, dt, True) for K, N, _ in LORA_SHAPES
             for dt in ("bf16", "f32")]
    cases += [(LORA_M, 768, 768, LORA_R, dt, False) for dt in ("bf16", "f32")]
    cases += [(200, 72, 100, 8, dt, True) for dt in ("bf16", "f32")]
    cases += [(1024, 768, 768, 320, dt, True) for dt in ("bf16", "f32")]  # a rank past 256
    cases += [RAGGED_TC]
    # kernel 7's M-chunk schedule: M below one chunk, and a ragged last chunk
    cases += [(300, 768, 768, LORA_R, "bf16", True), (LORA_M + 4, 2560, 768, LORA_R, "bf16", True)]
    # pythia_1b's four projections (kernel 7 at K = 8192 among them)
    cases += [(LORA_M, K, N, LORA_R, "bf16", True) for K, N, _ in PYTHIA_LORA_SHAPES]
    with full_f32_matmul():
        for i, (M, K, N, r, dtype, transposed) in enumerate(cases):
            x, w, a, b, gy = make_lora_case(torch, device, M, K, N, r, dtype, seed=21 + i,
                                            transposed=transposed)
            s = 0.25
            y0, z0 = LM.fused_lora_forward_plain(x, w, a, b, s)
            dx0, u0 = LM.fused_lora_bwd_dx_plain(gy, w, a, b, s)
            dab0 = LM.fused_lora_bwd_dab_plain(gy, x, z0, b, s, u0)
            tc0 = LM.fused_lora_forward.tc_launches
            fwd = LM.fused_lora_forward(x, w, a, b, s)
            paths = {"fused_lora_forward": check_path(LM.fused_lora_forward, tc0, x, K, N, r,
                                                      transposed)}
            tc0 = LM.fused_lora_bwd_dx.tc_launches
            dx = LM.fused_lora_bwd_dx(gy, w, a, b, s)
            paths["fused_lora_bwd_dx"] = check_path(LM.fused_lora_bwd_dx, tc0, gy, K, N, r,
                                                    transposed)
            tc0 = LM.fused_lora_bwd_dab.tc_launches
            dab = LM.fused_lora_bwd_dab(gy, x, z0, b, s, u0)
            paths["fused_lora_bwd_dab"] = check_dab_path(tc0, x, K, N, r)
            again = LM.fused_lora_bwd_dab(gy, x, z0, b, s, u0)
            pairs = {
                "fused_lora_forward": list(zip(fwd, (y0, z0))),
                "fused_lora_bwd_dx": list(zip(dx, (dx0, u0))),
                "fused_lora_bwd_dab": list(zip(dab, dab0))
                + list(zip(LM.fused_lora_bwd_dab(gy, x, z0, b, s), dab0)),
            }
            torch.cuda.synchronize()
            if not all(torch.equal(p, q) for p, q in zip(dab, again)):
                raise AssertionError(f"fused_lora_bwd_dab is not deterministic ({M, K, N, r, dtype})")
            for name, outs in pairs.items():
                err, rel, finite = _rel_err(outs)
                ok = finite and rel <= LORA_TOL[dtype]
                print(f"kernel-check {name} M={M} K={K} N={N} r={r} {dtype} "
                      f"W={'(N,K).t()' if transposed else '(K,N)'}"
                      f"{' path=' + paths[name] if name in paths else ''} "
                      f"max_abs_err={err:.3e} rel_err={rel:.3e} tol={LORA_TOL[dtype]:g} "
                      f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{name} disagrees with its plain twin ({M, K, N, r, dtype})")
                if dtype == "bf16" and M == LORA_M and transposed:
                    into = worst_pythia if (K, N) in pythia_shapes else worst
                    into[name] = max(into[name], err)

        # a tensor scale through the autograd Function against autograd of
        # the plain composite, ds included
        x, w, a, b, gy = make_lora_case(torch, device, LORA_M, 768, 768, LORA_R, "f32", seed=40)
        s = torch.tensor([0.7], device=device)
        got_in = [t.clone().requires_grad_() for t in (x, a, b, s)]
        want_in = [t.clone().requires_grad_() for t in (x, a, b, s)]
        got = LM.fused_lora_matmul(got_in[0], w, *got_in[1:])
        xw, aw, bw, sw = want_in
        want = xw @ w + ((xw @ aw) @ bw) * sw
        got.backward(gy)
        want.backward(gy)
        torch.cuda.synchronize()
        grads = [(p.grad, q.grad) for p, q in zip(got_in, want_in)]
        for name, pair in zip(("y", "dx", "dA", "dB", "ds"), [(got, want)] + grads):
            err, rel, finite = _rel_err([pair])
            ok = finite and rel <= LORA_TOL["f32"]
            print(f"kernel-check FusedLoRAMatmul tensor-s {name} M={LORA_M} K=768 N=768 "
                  f"r={LORA_R} f32 max_abs_err={err:.3e} rel_err={rel:.3e} "
                  f"tol={LORA_TOL['f32']:g} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"FusedLoRAMatmul with a tensor scale: {name} disagrees")

    # one decoder layer's seven projections (4 x 768->768, 2 x 768->2560,
    # 1 x 2560->768) summed, then pythia_1b's four (QKV 2048->6144, dense
    # 2048->2048, 2048->8192, 8192->2048)
    return (lora_timed_rows(torch, device, LORA_SHAPES, worst, "")
            + lora_timed_rows(torch, device, PYTHIA_LORA_SHAPES, worst_pythia, f"@{PYTHIA}"))


def lora_timed_rows(torch, device, shapes, worst, suffix):
    """Kernels 4, 6, 7 timed per ``(K, N, per layer)`` shape at M = LORA_M,
    r = LORA_R, bf16, beside the twin, the ordered cuBLAS chain of the
    default path and the bound (printed per shape), and summed per layer
    into rows named ``kernel + suffix``.  No single PyTorch call computes
    any of the three functions, so library_ms is the ordered chain."""
    import torch.nn.functional as F

    from relora_tpu_torch.ops import lora_matmul as LM

    # per layer: ms, plain_ms, library_ms (the chain), bound_ms and its two terms
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "t_bytes", "t_ops")
    rows = {name: dict.fromkeys(keys, 0.0) for name in LORA_NAMES}
    per_shape = []
    for K, N, count in shapes:
        x, w, a, b, gy = make_lora_case(torch, device, LORA_M, K, N, LORA_R, "bf16", seed=99)
        w_nk, s = w.t(), 0.25
        y, z = LM.fused_lora_forward(x, w, a, b, s)
        _, u = LM.fused_lora_bwd_dx(gy, w, a, b, s)
        gs = gy * s
        dz = gs @ b.t()
        zb = z.to(x.dtype)
        calls = {
            "fused_lora_forward": (lambda: LM.fused_lora_forward(x, w, a, b, s),
                                   lambda: LM.fused_lora_forward_plain(x, w, a, b, s),
                                   lambda: F.linear(x, w_nk) + ((x @ a) @ b) * s),
            "fused_lora_bwd_dx": (lambda: LM.fused_lora_bwd_dx(gy, w, a, b, s),
                                  lambda: LM.fused_lora_bwd_dx_plain(gy, w, a, b, s),
                                  lambda: gy @ w_nk + ((gy * s) @ b.t()) @ a.t()),
            "fused_lora_bwd_dab": (lambda: LM.fused_lora_bwd_dab(gy, x, z, b, s, u),
                                   lambda: LM.fused_lora_bwd_dab_plain(gy, x, z, b, s, u),
                                   lambda: (x.t() @ dz, zb.t() @ gs)),
        }
        shape = {"K": K, "N": N, "M": LORA_M, "r": LORA_R, "per_layer": count}
        for name, (fn, plain, chain) in calls.items():
            t_bytes, t_ops = lora_bound(LORA_M, K, N, LORA_R, 2, name)
            ms, plain_ms, chain_ms = time_ms(torch, fn), time_ms(torch, plain), time_ms(torch, chain)
            shape[name] = {"ms": ms, "plain_ms": plain_ms, "chain_ms": chain_ms,
                           "bound_ms": max(t_bytes, t_ops),
                           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
            for key, v in zip(keys, (ms, plain_ms, chain_ms, max(t_bytes, t_ops), t_bytes, t_ops)):
                rows[name][key] += count * v
        per_shape.append(shape)
    print(json.dumps({"lora_timings": "bf16, ms per call; chain = the default path's ordered "
                      "cuBLAS matmuls, timed only", "rows": suffix or "@llama_250m",
                      "shapes": per_shape}))
    return [{
        "name": name + suffix,
        "route": "cuda",
        "source": "relora_tpu_torch/csrc/lora_matmul.cu",
        "replaces": f"relora_tpu/ops/pallas_lora_matmul.py:{LORA_LINES[name]}",
        "launches": 0,
        "max_abs_err": worst[name],
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": "bytes" if row["t_bytes"] >= row["t_ops"] else "operations",
        "library_ms": row["library_ms"],
    } for name, row in rows.items()]


def f32_fused(torch, device, model_name="llama_250m"):
    """Phase f32-fused: one update of a 2-layer ``model_name`` with
    lora_fused true and false from the same weights (B, and a NeoX model's
    biases, drawn nonzero) and batch, at f32 with TF32 off."""
    import numpy as np

    from relora_tpu_torch.core import optim, relora
    from relora_tpu_torch.models.family import causal_lm_class
    from relora_tpu_torch.ops import lora_matmul as LM
    from relora_tpu_torch.train.step import TrainState, make_train_step

    cfg, tag = two_layer(model_name)
    rng = np.random.default_rng(6)
    batch = torch.as_tensor((rng.zipf(1.2, (2, 4, 512)) - 1) % cfg.vocab_size, device=device)
    state_dict, out, grads = None, {}, {}
    n0 = LM.fused_lora_bwd_dab.launches
    with relora.full_f32_matmul():
        for fused in (True, False):
            spec = relora.LoraSpec(r=128, alpha=32.0, dropout=0.0, fused=fused)
            with torch.device(device):
                model = causal_lm_class(cfg)(cfg, dtype=torch.float32, attention_arm="flash",
                                             lora=spec)
            if state_dict is None:
                seeded_init(torch, model, torch.Generator(device=device).manual_seed(3),
                            lora_b=True)
                state_dict = {k: v.clone() for k, v in model.state_dict().items()}
            model.load_state_dict(state_dict)
            relora.set_trainable(model)
            grads[fused] = layer0_grads(torch, model, batch)
            opt = optim.build_optimizer(p for p in model.parameters() if p.requires_grad)
            step = make_train_step(model, opt, clip_grad_norm=1.0, schedule=lambda s: 1e-3)
            out[fused] = step(TrainState(), batch)
    if LM.fused_lora_bwd_dab.launches == n0:
        raise AssertionError("f32-fused: the fused arm did not reach the kernels")
    check_grads(f"f32-fused{tag}", grads[True], grads[False])
    for key in ("loss", "grad_norm"):
        err = abs(out[True][key] - out[False][key]) / abs(out[False][key])
        ok = err <= F32_TRAIN_TOL[key]
        print(f"f32-fused{tag} {key} fused={out[True][key]} unfused={out[False][key]} "
              f"rel_err={err:.3e} tol={F32_TRAIN_TOL[key]:g} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"f32-fused{tag}: {key} off by {err:.3e}")


# kernel 8 and the int8 variants of 4 and 6, at kernels-4's shapes
INT8_LINES = {"dequant_matmul": "pallas_quant_matmul.py:46",
              "fused_lora_int8_forward": "pallas_lora_matmul.py:88",
              "fused_lora_int8_bwd_dx": "pallas_lora_matmul.py:279"}


def make_int8_case(torch, device, M, K, N, r, dtype, seed, transposed=True):
    """x, the int8 base (q (K, N), qscale (1, N)) quantized from a layer-like
    (N, K) weight, A, B and a cotangent g.  q is the (N, K) codes'
    transposed view, as the model passes it, or a contiguous (K, N) copy."""
    from relora_tpu_torch.ops.quant import quantize_int8

    x, w, a, b, gy = make_lora_case(torch, device, M, K, N, r, dtype, seed)
    q_nk, qscale = quantize_int8(w.t())
    return x, (q_nk.t() if transposed else q_nk.t().contiguous()), qscale, a, b, gy


def int8_bound(M, K, N, r, e, kernel):
    """The two terms of the least time on an H100 SXM, in ms: each input
    read once and each output written once (e bytes per activation element,
    1 per code, f32 scales, z and u) over 3.35 TB/s, and the matmul work over
    the bf16 tensor-core peak."""
    base = K * N + 4 * N
    bytes_, flops = {
        "dequant_matmul": (e * (M * K + M * N) + base, 2 * M * K * N),
        "fused_lora_int8_forward": (e * (M * K + K * r + r * N + M * N) + base + 4 * M * r,
                                    2 * M * (K * N + K * r + r * N)),
        "fused_lora_int8_bwd_dx": (e * (M * N + K * r + r * N + M * K) + base + 4 * M * r,
                                   2 * M * (N * K + N * r + r * K)),
    }[kernel]
    return bytes_ / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3


def int8pack_call(torch, x, q_nk, qscale):
    """``(call, scales' dtype)`` of ``torch._weight_int8pack_mm(x, q_nk,
    scales)``, the one PyTorch call that computes kernel 8's ``x @ (q *
    qscale)`` over the ``(N, K)`` codes the model stores: f32 scales where
    the card's implementation takes them, else the scales converted to x's
    dtype (rounding them); ``(None, error)`` if it takes neither.  Timed
    only; the port never calls it."""
    scales, err = qscale.reshape(-1), None
    for sc in (scales, scales.to(x.dtype)):
        try:
            torch._weight_int8pack_mm(x, q_nk, sc)
            torch.cuda.synchronize()
        except RuntimeError as e:
            err = f"{type(e).__name__}: {str(e).splitlines()[0]}"
            continue
        return (lambda: torch._weight_int8pack_mm(x, q_nk, sc)), str(sc.dtype)
    return None, err


def check_int8_kernels(torch, device):
    """Phase kernels-8: kernel 8 and the int8 fused forward and dx against
    their twins on the card, then timings per llama_250m and pythia_1b
    shape beside the twin, the JAX default path's dequantize + cuBLAS chain
    and the bound."""
    from relora_tpu_torch.core.relora import full_f32_matmul
    from relora_tpu_torch.ops import lora_matmul as LM
    from relora_tpu_torch.ops import quant_matmul as QM

    worst = dict.fromkeys(INT8_NAMES, 0.0)
    worst_pythia = dict.fromkeys(INT8_NAMES, 0.0)
    cases = [(LORA_M, K, N, LORA_R, dt, True) for K, N, _ in LORA_SHAPES
             for dt in ("bf16", "f32")]
    cases += [(200, K, N, LORA_R, "bf16", True) for K, N, _ in LORA_SHAPES]  # a ragged M
    cases += [(LORA_M, 768, 768, LORA_R, dt, False) for dt in ("bf16", "f32")]
    cases += [(200, 72, 100, 8, dt, True) for dt in ("bf16", "f32")]
    cases += [(1024, 768, 768, 320, dt, True) for dt in ("bf16", "f32")]  # a rank past 256
    cases += [RAGGED_TC]
    # pythia_1b's four projections (its rows: int8_train@pythia_1b's launches)
    n_llama = len(cases)
    cases += [(LORA_M, K, N, LORA_R, "bf16", True) for K, N, _ in PYTHIA_LORA_SHAPES]
    with full_f32_matmul(), torch.no_grad():
        for i, (M, K, N, r, dtype, transposed) in enumerate(cases):
            x, q, qs, a, b, gy = make_int8_case(torch, device, M, K, N, r, dtype, seed=51 + i,
                                                transposed=transposed)
            s = 0.25
            tc0 = QM.dequant_matmul.tc_launches
            y8 = QM.dequant_matmul(x, q, qs)
            paths = {"dequant_matmul": check_path(QM.dequant_matmul, tc0, x, K, N, None, transposed)}
            tc0 = LM.fused_lora_int8_forward.tc_launches
            fwd = LM.fused_lora_int8_forward(x, q, qs, a, b, s)
            paths["fused_lora_int8_forward"] = check_path(LM.fused_lora_int8_forward, tc0, x, K, N,
                                                          r, transposed)
            tc0 = LM.fused_lora_int8_bwd_dx.tc_launches
            dx = LM.fused_lora_int8_bwd_dx(gy, q, qs, a, b, s)
            paths["fused_lora_int8_bwd_dx"] = check_path(LM.fused_lora_int8_bwd_dx, tc0, gy, K, N,
                                                         r, transposed)
            # kernel 7 on the int8 base's residuals: z from 4-int8, u from 6-int8
            tc0 = LM.fused_lora_bwd_dab.tc_launches
            dab = LM.fused_lora_bwd_dab(gy, x, fwd[1], b, s, dx[1])
            paths["fused_lora_bwd_dab"] = check_dab_path(tc0, x, K, N, r)
            pairs = {
                "dequant_matmul": [(y8, QM.dequant_matmul_plain(x, q, qs))],
                "fused_lora_int8_forward": list(zip(fwd, LM.fused_lora_int8_forward_plain(x, q, qs, a, b, s))),
                "fused_lora_int8_bwd_dx": list(zip(dx, LM.fused_lora_int8_bwd_dx_plain(gy, q, qs, a, b, s))),
                "fused_lora_bwd_dab": list(zip(dab, LM.fused_lora_bwd_dab_plain(gy, x, fwd[1], b, s,
                                                                                dx[1]))),
            }
            torch.cuda.synchronize()
            for name, outs in pairs.items():
                err, rel, finite = _rel_err(outs)
                ok = finite and rel <= LORA_TOL[dtype]
                print(f"kernel-check {name} M={M} K={K} N={N} r={r} {dtype} "
                      f"q={'(N,K).t()' if transposed else '(K,N)'}"
                      f"{' path=' + paths[name] if name in paths else ''} "
                      f"max_abs_err={err:.3e} rel_err={rel:.3e} tol={LORA_TOL[dtype]:g} "
                      f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{name} disagrees with its plain twin ({M, K, N, r, dtype})")
                if dtype == "bf16" and M == LORA_M and transposed and name in worst:
                    rows_of = worst if i < n_llama else worst_pythia
                    rows_of[name] = max(rows_of[name], err)

    # a tensor scale (and a qscale that asks for its gradient) through both
    # Functions against autograd of the plain composite
    with full_f32_matmul():
        x, q, qs, a, b, gy = make_int8_case(torch, device, LORA_M, 768, 768, LORA_R, "f32", seed=60)
        s = torch.tensor([0.7], device=device)
        checks = []
        got_in = [t.clone().requires_grad_() for t in (x, qs, a, b, s)]
        want_in = [t.clone().requires_grad_() for t in (x, qs, a, b, s)]
        got = LM.fused_lora_matmul_int8(got_in[0], q, *got_in[1:])
        xw, qw, aw, bw, sw = want_in
        want = xw @ LM.dequantize_kn(q, qw) + ((xw @ aw) @ bw) * sw
        got.backward(gy)
        want.backward(gy)
        checks += [("FusedLoRAMatmulInt8", n, pair) for n, pair in zip(
            ("y", "dx", "dqscale", "dA", "dB", "ds"),
            [(got, want)] + [(p.grad, r.grad) for p, r in zip(got_in, want_in)])]
        got_in = [t.clone().requires_grad_() for t in (x, qs)]
        want_in = [t.clone().requires_grad_() for t in (x, qs)]
        got = QM.dequant_matmul(got_in[0], q, got_in[1])
        want = want_in[0] @ LM.dequantize_kn(q, want_in[1])
        got.backward(gy)
        want.backward(gy)
        checks += [("DequantMatmul", n, pair) for n, pair in zip(
            ("y", "dx", "dscale"), [(got, want)] + [(p.grad, r.grad) for p, r in zip(got_in, want_in)])]
        torch.cuda.synchronize()
        for fn_name, name, pair in checks:
            err, rel, finite = _rel_err([pair])
            ok = finite and rel <= LORA_TOL["f32"]
            print(f"kernel-check {fn_name} tensor-s {name} M={LORA_M} K=768 N=768 r={LORA_R} f32 "
                  f"max_abs_err={err:.3e} rel_err={rel:.3e} tol={LORA_TOL['f32']:g} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{fn_name} with a tensor scale: {name} disagrees")

    # rows per decoder layer: llama_250m's, then pythia_1b's (``...@pythia_1b``)
    return (int8_timed_rows(torch, device, LORA_SHAPES, worst, "")
            + int8_timed_rows(torch, device, PYTHIA_LORA_SHAPES, worst_pythia, f"@{PYTHIA}"))


def int8_timed_rows(torch, device, shapes, worst, suffix):
    """Kernel 8, 4-int8 and 6-int8 timed per ``(K, N, per layer)`` shape at
    M = LORA_M, r = LORA_R, bf16 activations, beside the twin, the JAX
    default path's dequantize + cuBLAS chain, ``torch._weight_int8pack_mm``
    (kernel 8) and the bound (printed per shape), and summed per layer into
    rows named ``kernel + suffix``."""
    import torch.nn.functional as F

    from relora_tpu_torch.ops import lora_matmul as LM
    from relora_tpu_torch.ops import quant_matmul as QM
    from relora_tpu_torch.ops.quant import dequantize_int8

    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "t_bytes", "t_ops")
    rows = {name: dict.fromkeys(keys, 0.0) for name in INT8_NAMES}
    per_shape = []
    int8pack_ms = 0.0  # kernel 8's one-call yardstick per layer; None once a shape raised
    with torch.no_grad():
        for K, N, count in shapes:
            x, q, qs, a, b, gy = make_int8_case(torch, device, LORA_M, K, N, LORA_R, "bf16", seed=99)
            q_nk, s = q.t(), 0.25

            def deq():
                return dequantize_int8(q_nk, qs, x.dtype)

            calls = {
                "dequant_matmul": (lambda: QM.dequant_matmul(x, q, qs),
                                   lambda: QM.dequant_matmul_plain(x, q, qs),
                                   lambda: F.linear(x, deq())),
                "fused_lora_int8_forward": (lambda: LM.fused_lora_int8_forward(x, q, qs, a, b, s),
                                            lambda: LM.fused_lora_int8_forward_plain(x, q, qs, a, b, s),
                                            lambda: F.linear(x, deq()) + ((x @ a) @ b) * s),
                "fused_lora_int8_bwd_dx": (lambda: LM.fused_lora_int8_bwd_dx(gy, q, qs, a, b, s),
                                           lambda: LM.fused_lora_int8_bwd_dx_plain(gy, q, qs, a, b, s),
                                           lambda: gy @ deq() + ((gy * s) @ b.t()) @ a.t()),
            }
            shape = {"K": K, "N": N, "M": LORA_M, "r": LORA_R, "per_layer": count}
            for name, (fn, plain, chain) in calls.items():
                t_bytes, t_ops = int8_bound(LORA_M, K, N, LORA_R, 2, name)
                ms, plain_ms, chain_ms = time_ms(torch, fn), time_ms(torch, plain), time_ms(torch, chain)
                shape[name] = {"ms": ms, "plain_ms": plain_ms, "chain_ms": chain_ms,
                               "bound_ms": max(t_bytes, t_ops),
                               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
                for key, v in zip(keys, (ms, plain_ms, chain_ms, max(t_bytes, t_ops), t_bytes, t_ops)):
                    rows[name][key] += count * v
            call, how = int8pack_call(torch, x, q_nk, qs)
            row8 = shape["dequant_matmul"]
            if call is None:
                row8["int8pack_error"], int8pack_ms = how, None
            else:
                want = QM.dequant_matmul_plain(x, q, qs).float()
                row8.update(int8pack_ms=time_ms(torch, call), int8pack_scales=how,
                            int8pack_max_abs_err=(call().float() - want).abs().max().item())
                if int8pack_ms is not None:
                    int8pack_ms += count * row8["int8pack_ms"]
            per_shape.append(shape)
    print(json.dumps({"int8_timings": "bf16 activations, int8 base, ms per call; chain = the JAX "
                      "default path's dequantize + cuBLAS matmuls, int8pack = "
                      "torch._weight_int8pack_mm (kernel 8's one-call yardstick), timed only",
                      "rows": suffix or "@llama_250m", "shapes": per_shape,
                      "int8pack_ms_per_layer": int8pack_ms}))
    # one decoder layer's seven projections summed, as kernels-4.  Kernel 8's
    # library_ms is torch._weight_int8pack_mm (the chain if that call raised);
    # no single PyTorch call computes 4-int8 or 6-int8, so theirs is the chain
    if int8pack_ms is not None:
        rows["dequant_matmul"]["library_ms"] = int8pack_ms
    return [{
        "name": name + suffix,
        "route": "cuda",
        "source": "relora_tpu_torch/csrc/lora_matmul.cu",
        "replaces": f"relora_tpu/ops/{INT8_LINES[name]}",
        "launches": 0,
        "max_abs_err": worst[name],
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": "bytes" if row["t_bytes"] >= row["t_ops"] else "operations",
        "library_ms": row["library_ms"],
    } for name, row in rows.items()]


def write_warm_start(torch, path, device, seed=11, model_config="llama_250m", dtype=None):
    """A full-rank ``model_config`` with seeded random weights, saved as an
    HF-named ``path/pytorch_model.bin`` in ``dtype`` (default f32) for
    ``--warmed_up_model path``: a Llama's keys under ``model.`` with
    ``lm_head`` at the root, a GPT-NeoX's under ``gpt_neox.`` with
    ``embed_out`` at the root, its biases drawn nonzero; returns ``path``."""
    from relora_tpu_torch.config.model import load_model_config
    from relora_tpu_torch.models.family import causal_lm_class
    from relora_tpu_torch.models.params_util import init_params

    os.makedirs(path, exist_ok=True)
    cfg = load_model_config(model_config)
    with torch.device(device):
        model = causal_lm_class(cfg)(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    init_params(model, gen)
    prefix, head = ("model.", "lm_head.weight") if cfg.family == "llama" else ("gpt_neox.", "embed_out.weight")
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".bias"):
                p.copy_(torch.randn(p.shape, generator=gen, device=device) * 0.02)
    torch.save({(k if k == head else prefix + k): v.to(dtype or v.dtype).cpu()
                for k, v in model.state_dict().items()}, os.path.join(path, "pytorch_model.bin"))
    del model
    return path


# f32-int8: the merge against an f64 oracle, to the requant rule
INT8_MERGE_MIN_EQUAL = 0.999


def f32_int8(torch, device, warm):
    """Phase f32-int8: one update with the fused-int8 and the unfused
    kernel-8 arms from the same warm-started weights (B drawn nonzero) and
    batch at f32 with TF32 off, then one int8 merge against an f64 oracle."""
    import dataclasses

    import numpy as np

    from relora_tpu_torch.config.model import load_model_config
    from relora_tpu_torch.core import optim, relora
    from relora_tpu_torch.models.llama import LlamaForCausalLM
    from relora_tpu_torch.models.params_util import init_params
    from relora_tpu_torch.models.warm_start import graft_base_weights
    from relora_tpu_torch.ops import lora_matmul as LM
    from relora_tpu_torch.ops import quant_matmul as QM
    from relora_tpu_torch.train.step import TrainState, make_train_step

    cfg = dataclasses.replace(load_model_config("llama_250m"), num_hidden_layers=2)
    source = torch.load(os.path.join(warm, "pytorch_model.bin"), map_location="cpu", weights_only=True)
    source = {k: v for k, v in source.items() if not k.startswith("model.layers.")
              or int(k.split(".")[2]) < 2}
    rng = np.random.default_rng(7)
    batch = torch.as_tensor((rng.zipf(1.2, (2, 4, 512)) - 1) % cfg.vocab_size, device=device)
    state_dict, out = None, {}
    n_deq, n_dx = QM.dequant_matmul.launches, LM.fused_lora_int8_bwd_dx.launches
    with relora.full_f32_matmul():
        for fused in (True, False):
            spec = relora.LoraSpec(r=128, alpha=32.0, dropout=0.0, quantize="int8", fused=fused)
            with torch.device(device):
                model = LlamaForCausalLM(cfg, dtype=torch.float32, attention_arm="flash", lora=spec)
            if state_dict is None:
                gen = torch.Generator(device=device).manual_seed(3)
                init_params(model, gen)
                graft_base_weights(model, source)
                with torch.no_grad():
                    for name, p in model.named_parameters():
                        if name.endswith("lora_b"):
                            p.copy_(torch.randn(p.shape, generator=gen, device=device) * 0.02)
                state_dict = {k: v.clone() for k, v in model.state_dict().items()}
            model.load_state_dict(state_dict)
            relora.set_trainable(model)
            opt = optim.build_optimizer(p for p in model.parameters() if p.requires_grad)
            step = make_train_step(model, opt, clip_grad_norm=1.0, schedule=lambda s: 1e-3)
            out[fused] = step(TrainState(), batch)
        if QM.dequant_matmul.launches == n_deq or LM.fused_lora_int8_bwd_dx.launches == n_dx:
            raise AssertionError("f32-int8: an arm did not reach its kernels")
        errs = {k: abs(out[True][k] - out[False][k]) / abs(out[False][k]) for k in ("loss", "grad_norm")}
        for key, err in errs.items():
            ok = err <= F32_TRAIN_TOL[key]
            print(f"f32-int8 {key} fused={out[True][key]} unfused={out[False][key]} rel_err={err:.3e} "
                  f"tol={F32_TRAIN_TOL[key]:g} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"f32-int8: {key} off by {err:.3e}")

        # the merge on the card against dequantize + delta + requantize in
        # f64; every fifth output column's delta is zero (B's column zeroed)
        module = model.layers[0].self_attn.q_proj
        with torch.no_grad():
            module.lora_b[:, ::5] = 0.0
        q0, s0 = module.weight_q.clone(), module.weight_scale.clone()
        w64 = q0.double() * s0.double().t() + (
            module.lora_a.double() @ module.lora_b.double() * spec.scale).t()
        scale64 = torch.clamp(w64.abs().amax(dim=1, keepdim=True) / 127.0, min=1e-12)
        q64 = torch.clamp(torch.round(w64 / scale64), -127, 127)
        relora.merge_and_reinit(model, torch.Generator(device=device).manual_seed(4), spec)
        q, s = module.weight_q, module.weight_scale
        step_err = ((q.double() * s.double().t() - q64 * scale64).abs()
                    / torch.maximum(s.double().t(), scale64)).max().item()
        equal = (q.double() == q64).double().mean().item()
        fixed = bool(torch.equal(q[::5], q0[::5]) and torch.equal(s[:, ::5], s0[:, ::5]))
    ok = q.dtype == torch.int8 and step_err <= 1.0 + 1e-6 and equal >= INT8_MERGE_MIN_EQUAL and fixed
    print(f"f32-int8 merge max_err_in_steps={step_err:.3e} (tol 1) codes_equal={equal:.6f} "
          f"(min {INT8_MERGE_MIN_EQUAL}) zero_delta_fixed={fixed} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("f32-int8: the int8 merge breaks the requant rule against f64")


# kernel 5 at the adapter drains' shapes: M rows per call (decode rows, a
# verify window of BATCH x (SPEC_K + 1) rows, a prefill chunk, a packed
# step), llama_250m's projections, r and slots as served
GROUPED_MS = (BATCH, BATCH * (SPEC_K + 1), 64, BATCH + 64)
ADAPTER_R, ADAPTER_SLOTS = 128, 4
TENANT_ALPHAS = {"tA": 32.0, "tB": 64.0, "tC": 16.0}


def make_grouped_case(torch, device, M, K, N, r, S, dtype, seed):
    """x, W (the (N, K) weight's transposed view), stacked A and B with slot
    0 the zero identity adapter, per-slot scales and a mixed idx."""
    g = torch.Generator(device=device).manual_seed(seed)
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    x = torch.randn((M, K), generator=g, device=device).to(dt)
    w_nk = (torch.randn((N, K), generator=g, device=device) * 0.02).to(dt)
    a = ((torch.rand((S, K, r), generator=g, device=device) * 2 - 1) / K**0.5).to(dt)
    b = (torch.randn((S, r, N), generator=g, device=device) * 0.05).to(dt)
    a[0], b[0] = 0, 0
    s = torch.tensor([0.25 * (i + 1) for i in range(S)], device=device)
    idx = (torch.arange(M, device=device) * 5 % S).to(torch.int32)
    return x, w_nk.t(), a, b, s, idx


def grouped_bound(M, K, N, r, used, e):
    """The two terms of the least time on an H100 SXM, in ms: x, W, the
    A and B of each slot the rows use, idx and y, each once, over 3.35 TB/s,
    and 2M(KN + Kr + rN) over the bf16 tensor-core peak."""
    bytes_ = e * (M * K + K * N + used * (K * r + r * N) + M * N) + 4 * M + 4 * used
    return bytes_ / HBM_BYTES_PER_S * 1e3, 2 * M * (K * N + K * r + r * N) / BF16_FLOPS_PER_S * 1e3


GROUPED_TC_KERNELS = ("grouped_tc_base_shrink_kernel", "grouped_tc_reduce_kernel")
GROUPED_KERNELS = GROUPED_TC_KERNELS + ("grouped_fma_base_shrink_kernel",
                                        "grouped_fma_reduce_kernel")


def grouped_edge_cases(torch, device, dtype, seed):
    """Kernel 5's edge cases at llama_250m's shapes, each against its twin
    (or, for rows without a slot, against x @ W), failing on error: out-of-
    range idx (-1 and S), M = 1, every row on one slot, a slot no row uses
    (with nonzero factors), a contiguous (K, N) W, and a ragged shape that
    still takes the tensor cores at bf16; then the batch-invariance check:
    the 8 rows of an M = 8 call equal, bit for bit, the same rows inside an
    M = 72 call whose other rows sit on other slots, at each projection shape."""
    from relora_tpu_torch.ops import lora_matmul as LM

    S = ADAPTER_SLOTS
    worst = 0.0
    for label, M, K, N, r, slots, idx_of, contiguous in (
        ("idx_out_of_range", BATCH + 64, 768, 768, ADAPTER_R, S,
         lambda M: torch.tensor([-1, S] * 4 + [i % S for i in range(M - 8)]), False),
        ("m1", 1, 768, 2560, ADAPTER_R, S, lambda M: torch.tensor([3]), False),
        ("one_slot", BATCH + 64, 2560, 768, ADAPTER_R, S, lambda M: torch.full((M,), 2), False),
        ("unused_slot", BATCH + 64, 768, 768, ADAPTER_R, S,
         lambda M: torch.tensor([(0, 1, 3)[i % 3] for i in range(M)]), False),
        ("contiguous_w", BATCH + 64, 768, 2560, ADAPTER_R, S, None, True),
        ("ragged_tc", 5, 72, 104, 8, 3, None, False),
    ):
        x, w, a, b, s, idx = make_grouped_case(torch, device, M, K, N, r, slots, dtype, seed)
        if idx_of is not None:
            idx = idx_of(M).to(device=device, dtype=torch.int32)
        a[2], b[2] = a[1], b[1]  # slot 2 is live: an unused slot must still be skipped
        if contiguous:
            w = w.contiguous()
        got = LM.grouped_lora_matmul(x, w, a, b, s, idx)
        live = (idx >= 0) & (idx < slots)
        want = LM.grouped_lora_matmul_plain(x, w, a, b, s, idx.clamp(0, slots - 1))
        want[~live] = (x[~live].float() @ w.float()).to(want.dtype)
        torch.cuda.synchronize()
        err, rel, finite = _rel_err([(got, want)])
        ok = finite and rel <= LORA_TOL[dtype]
        print(f"kernel-check grouped_lora_matmul {label} M={M} K={K} N={N} r={r} S={slots} "
              f"{dtype} max_abs_err={err:.3e} rel_err={rel:.3e} tol={LORA_TOL[dtype]:g} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"grouped_lora_matmul disagrees with its twin ({label}, {dtype})")
        worst = max(worst, err)
    for K, N, _ in LORA_SHAPES:
        x, w, a, b, s, idx = make_grouped_case(torch, device, BATCH + 64, K, N, ADAPTER_R, S, dtype,
                                               seed)
        idx = torch.tensor([1, 2] * 4 + [(0, 3)[i % 2] for i in range(64)], device=device,
                           dtype=torch.int32)
        alone = LM.grouped_lora_matmul(x[:BATCH], w, a, b, s, idx[:BATCH])
        inside = LM.grouped_lora_matmul(x, w, a, b, s, idx)[:BATCH]
        torch.cuda.synchronize()
        same = torch.equal(alone, inside)
        print(f"kernel-check grouped_lora_matmul batch_invariance K={K} N={N} {dtype} "
              f"M=8 rows inside M=72 bit-equal={same} {'ok' if same else 'FAIL'}")
        if not same:
            diff = (alone.float() - inside.float()).abs().max().item()
            raise AssertionError(f"grouped_lora_matmul: an M = 8 call differs from the same rows "
                                 f"of an M = 72 call by {diff:.3e} ({K}, {N}, {dtype})")
    return worst


def check_grouped_kernels(torch, device):
    """Phase kernels-5: kernel 5 against its twin on the card (the cases of
    :func:`grouped_edge_cases` too), then timings per M and llama_250m shape
    beside the twin, the gathered chain and the bound."""
    from relora_tpu_torch.core.relora import full_f32_matmul
    from relora_tpu_torch.ops import lora_matmul as LM
    from relora_tpu_torch.ops.lora_dispatch import lora_matmul_grouped

    worst = 0.0
    cases = [(M, K, N, ADAPTER_R, ADAPTER_SLOTS, dt) for M in GROUPED_MS for K, N, _ in LORA_SHAPES
             for dt in ("bf16", "f32")]
    cases += [(5, 72, 100, 8, 3, dt) for dt in ("bf16", "f32")]
    cases += [(BATCH + 64, 768, 768, 320, ADAPTER_SLOTS, dt) for dt in ("bf16", "f32")]  # r > 256
    with full_f32_matmul(), torch.no_grad():
        for i, (M, K, N, r, S, dtype) in enumerate(cases):
            x, w, a, b, s, idx = make_grouped_case(torch, device, M, K, N, r, S, dtype, seed=71 + i)
            got = LM.grouped_lora_matmul(x, w, a, b, s, idx)
            want = LM.grouped_lora_matmul_plain(x, w, a, b, s, idx)
            torch.cuda.synchronize()
            err, rel, finite = _rel_err([(got, want)])
            ok = finite and rel <= LORA_TOL[dtype]
            print(f"kernel-check grouped_lora_matmul M={M} K={K} N={N} r={r} S={S} {dtype} "
                  f"max_abs_err={err:.3e} rel_err={rel:.3e} tol={LORA_TOL[dtype]:g} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"grouped_lora_matmul disagrees with its twin ({M, K, N, r, S, dtype})")
            if dtype == "bf16" and r == ADAPTER_R:
                worst = max(worst, err)
        for i, dtype in enumerate(("bf16", "f32")):
            edge = grouped_edge_cases(torch, device, dtype, seed=171 + i)
            if dtype == "bf16":
                worst = max(worst, edge)

    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "t_bytes", "t_ops")
    per_layer = {M: dict.fromkeys(keys, 0.0) for M in GROUPED_MS}
    per_shape = []
    with torch.no_grad():
        for M in GROUPED_MS:
            for K, N, count in LORA_SHAPES:
                args = make_grouped_case(torch, device, M, K, N, ADAPTER_R, ADAPTER_SLOTS, "bf16", seed=99)
                used = len(set(args[-1].tolist()))
                t_bytes, t_ops = grouped_bound(M, K, N, ADAPTER_R, used, 2)
                times = (time_ms(torch, lambda: LM.grouped_lora_matmul(*args)),
                         time_ms(torch, lambda: LM.grouped_lora_matmul_plain(*args)),
                         time_ms(torch, lambda: lora_matmul_grouped(*args, arm="gathered")))
                per_shape.append({"M": M, "K": K, "N": N, "r": ADAPTER_R, "slots_used": used,
                                  "per_layer": count, "ms": times[0], "plain_ms": times[1],
                                  "chain_ms": times[2], "bound_ms": max(t_bytes, t_ops),
                                  "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
                for key, v in zip(keys, times + (max(t_bytes, t_ops), t_bytes, t_ops)):
                    per_layer[M][key] += count * v
    print(json.dumps({"grouped_timings": "bf16, ms per call; chain = cuBLAS x @ W plus the "
                      "gathered bmm composite (the gathered arm), timed only",
                      "shapes": per_shape,
                      "per_layer": {str(M): row for M, row in per_layer.items()}}))
    # the row: one decoder layer's seven projections at the decode shape
    # (M = 8 rows, most of the drains' calls); no single PyTorch call computes
    # the function, so library_ms is the gathered chain
    row = per_layer[BATCH]
    return [grouped_row("grouped_lora_matmul", worst, row),
            grouped_shape_row(torch, device, "prefill", GROUPED_PREFILL_M, LORA_SHAPES, 1),
            grouped_shape_row(torch, device, PYTHIA, BATCH, PYTHIA_LORA_SHAPES, ADAPTER_SLOTS),
            grouped_shape_row(torch, device, f"prefill_{PYTHIA}", GROUPED_PREFILL_M,
                              PYTHIA_LORA_SHAPES, 1)]


def grouped_row(name, worst, layer):
    """A kernels-line row of kernel 5 from one decoder layer's sums."""
    return {
        "name": name,
        "route": "cuda",
        "source": "relora_tpu_torch/csrc/lora_matmul.cu",
        "replaces": "relora_tpu/ops/pallas_lora_matmul.py:161",
        "launches": 0,
        "max_abs_err": worst,
        "ms": layer["ms"],
        "plain_ms": layer["plain_ms"],
        "bound_ms": layer["bound_ms"],
        "bound_by": "bytes" if layer["t_bytes"] >= layer["t_ops"] else "operations",
        "library_ms": layer["library_ms"],
    }


GROUPED_PREFILL_M = 512  # the largest prompt bucket the drain's prompts (32-512 tokens) reach


def grouped_shape_row(torch, device, tag, M, shapes, slots_used):
    """Kernel 5 at ``M`` rows over ``shapes`` (one decoder layer's
    projections), r = 128, 4 slots, the rows on ``slots_used`` of them
    (1: a batch-1 prefill, every row one request's slot): held to its twin
    at bf16 and f32, then timed at bf16 beside the twin, the gathered chain
    and the bound, summed per layer; the row ``grouped_lora_matmul@tag``.
    Its library_ms is the gathered chain, or at one slot the single-adapter
    cuBLAS chain ``x @ W + s * (x @ A_i) @ B_i`` (row 4's chain), which a
    caller with one slot would run instead (the gathered chain is printed
    beside it)."""
    from relora_tpu_torch.core.relora import full_f32_matmul
    from relora_tpu_torch.ops import lora_matmul as LM
    from relora_tpu_torch.ops.lora_dispatch import lora_matmul_grouped

    def case(K, N, dtype, seed):
        x, w, a, b, s, idx = make_grouped_case(torch, device, M, K, N, ADAPTER_R, ADAPTER_SLOTS,
                                               dtype, seed)
        if slots_used == 1:
            idx = torch.full_like(idx, 1)
        return x, w, a, b, s, idx

    worst = 0.0
    with full_f32_matmul(), torch.no_grad():
        for i, (K, N, _) in enumerate(shapes):
            for dtype in ("bf16", "f32"):
                args = case(K, N, dtype, 301 + i)
                got = LM.grouped_lora_matmul(*args)
                want = LM.grouped_lora_matmul_plain(*args)
                torch.cuda.synchronize()
                err, rel, finite = _rel_err([(got, want)])
                ok = finite and rel <= LORA_TOL[dtype]
                print(f"kernel-check grouped_lora_matmul@{tag} M={M} K={K} N={N} r={ADAPTER_R} "
                      f"slots_used={slots_used} {dtype} max_abs_err={err:.3e} rel_err={rel:.3e} "
                      f"tol={LORA_TOL[dtype]:g} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"grouped_lora_matmul@{tag} disagrees with its twin "
                                         f"({M, K, N, dtype})")
                if dtype == "bf16":
                    worst = max(worst, err)
    layer = dict.fromkeys(("ms", "plain_ms", "library_ms", "gathered_ms", "bound_ms", "t_bytes",
                           "t_ops"), 0.0)
    per_shape = []
    with torch.no_grad():
        for K, N, count in shapes:
            args = case(K, N, "bf16", 99)
            x, w, a, b, sc, _ = args
            a1, b1, s1 = a[1], b[1], float(sc[1])
            t_bytes, t_ops = grouped_bound(M, K, N, ADAPTER_R, slots_used, 2)
            gathered = time_ms(torch, lambda: lora_matmul_grouped(*args, arm="gathered"))
            times = (time_ms(torch, lambda: LM.grouped_lora_matmul(*args)),
                     time_ms(torch, lambda: LM.grouped_lora_matmul_plain(*args)),
                     time_ms(torch, lambda: x @ w + ((x @ a1) @ b1) * s1)
                     if slots_used == 1 else gathered,
                     gathered)
            per_shape.append({"K": K, "N": N, "ms": times[0], "plain_ms": times[1],
                              "library_ms": times[2], "gathered_ms": times[3],
                              "bound_ms": max(t_bytes, t_ops)})
            for key, v in zip(layer, times + (max(t_bytes, t_ops), t_bytes, t_ops)):
                layer[key] += count * v
    print(json.dumps({"grouped_timings": f"@{tag}", "M": M, "r": ADAPTER_R,
                      "slots_used": slots_used,
                      "library": "single-slot cuBLAS chain" if slots_used == 1 else "gathered chain",
                      "shapes": per_shape, "per_layer": layer}))
    return grouped_row(f"grouped_lora_matmul@{tag}", worst, layer)


def write_adapter_checkpoints(torch, work, device, model_config="llama_250m"):
    """A seeded ``model_config`` base with LoRA r=128 on every projection
    (f32, B = 0, as a ReLoRA checkpoint right after a merge; a NeoX base's
    biases drawn nonzero) and three seeded tenant adapters (their factors
    only, alpha per TENANT_ALPHAS), each written by
    ``train/checkpoint.save_checkpoint``.  Returns (base dir, adapter
    dir)."""
    import shutil

    from relora_tpu_torch.config.model import load_model_config
    from relora_tpu_torch.core.relora import LoraSpec, kaiming_uniform
    from relora_tpu_torch.models.family import causal_lm_class
    from relora_tpu_torch.serve.adapters import extract_lora_factors
    from relora_tpu_torch.train.checkpoint import save_checkpoint

    root = os.path.join(work, f"adapters_{os.path.basename(model_config)}")
    shutil.rmtree(root, ignore_errors=True)
    spec = LoraSpec(r=ADAPTER_R, alpha=32.0)
    cfg = load_model_config(model_config)
    with torch.device(device):
        model = causal_lm_class(cfg)(cfg, lora=spec)
    gen = torch.Generator(device=device).manual_seed(21)
    seeded_init(torch, model, gen)
    base = save_checkpoint(os.path.join(root, "base"), 0, model.state_dict(), {"update_step": 0},
                           lora_spec=spec)
    tenants = os.path.join(root, "tenants")
    for i, (name, alpha) in enumerate(TENANT_ALPHAS.items()):
        factors = {}
        for key, p in extract_lora_factors(model.state_dict()).items():
            if key.endswith("lora_a"):
                factors[key] = kaiming_uniform(p.shape, gen, device)
            else:
                factors[key] = torch.randn(p.shape, generator=gen, device=device) * 0.05
        path = save_checkpoint(tenants, i, factors, {"update_step": 0},
                               lora_spec=LoraSpec(r=ADAPTER_R, alpha=alpha))
        os.rename(path, os.path.join(tenants, name))
    del model
    return base, tenants


def head_prompts(path, n, name):
    """The first ``n`` prompts of the prompt file ``path``, written beside it
    as ``name``; returns that file's path."""
    out = os.path.join(os.path.dirname(path), name)
    with open(out, "w") as f:
        f.writelines(" ".join(map(str, p)) + "\n" for p in read_prompts(path)[:n])
    return out


def read_prompts(path):
    with open(path) as f:
        return [[int(t) for t in line.split()] for line in f if line.strip()]


def tenant_engine(torch, base, slots, device, dtype="bf16", spec_k=0, paged=True,
                  model_config="llama_250m"):
    """The serving engine of the adapter drains: ``model_config`` from the
    base checkpoint, unmerged, with ``slots`` adapter slots, the CLI's pool
    (``spec_k``: a verify window of spec_k + 1), or with ``paged=False``
    the contiguous cache alone."""
    from relora_tpu_torch.config.model import load_model_config
    from relora_tpu_torch.serve.engine import InferenceEngine, compute_dtype
    from relora_tpu_torch.train.checkpoint import load_lora_spec, restore_params_host

    cfg = load_model_config(model_config)
    cache = cfg.max_sequence_length
    pool = dict(page_size=PAGE, num_pages=BATCH * (cache // PAGE) + 1, chunk_size=64,
                token_budget=BATCH + 64, spec_k=spec_k) if paged else {}
    return InferenceEngine(cfg, restore_params_host(base), cache_size=cache, dtype=compute_dtype(dtype),
                           device=device, lora=load_lora_spec(base), adapter_slots=slots, **pool)


def tenant_drain(torch, engine, registry, requests, packed=False, max_batch=BATCH, spec="off"):
    """Drain ``requests`` through the scheduler API; returns (completions,
    seconds ending in a device synchronize, the scheduler)."""
    from relora_tpu_torch.serve.scheduler import PagedContinuousBatchingScheduler

    sched = PagedContinuousBatchingScheduler(
        engine, max_batch=max_batch, eos_id=engine.config.eos_token_id, seed=0, packed=packed,
        adapter_registry=registry, spec=spec,
    )
    t0 = time.perf_counter()
    completions = sched.run(requests)
    torch.cuda.synchronize()
    return completions, time.perf_counter() - t0, sched


TENANT_NEW = 32  # the tenant drains' new tokens a request (sequential, packed, spec)
TENANT_HEAD = 8  # adapters_cli, tenants_spec and server-tenants drain the first 8 prompts (one batch)
CONTENTION_NEW = 16  # the contention drain's new tokens a request
CONTENTION_PROMPTS = 8  # the contention drain's prompts: the first 8


def tenant_requests(prompts, names, max_new=64):
    from relora_tpu_torch.serve.scheduler import Request

    return [Request(uid=i, prompt=p, max_new_tokens=max_new, adapter=names[i % len(names)])
            for i, p in enumerate(prompts)]


def tenant_probes(torch, engine, registry, prompts, label):
    """The tenant checks on ``engine``'s slots: every tenant steers (its row
    differs from the base row on one prompt), and tB after tA on one prompt
    equals tB alone (tA's prefix pages are not tB's; a tenant's own repeat
    does hit them).  Prints the probe line; fails unless both hold."""
    mix = [None] + list(TENANT_ALPHAS)
    probe = tenant_requests([prompts[0]] * len(mix), mix, max_new=16)
    done = tenant_drain(torch, engine, registry, probe)[0]
    steered = {name: done[i].tokens != done[0].tokens for i, name in enumerate(mix) if name}

    def alone(names):
        got = tenant_drain(torch, engine, registry, tenant_requests([prompts[1]] * len(names), names,
                                                                    max_new=16), max_batch=1)
        return [got[0][i].tokens for i in range(len(names))], got[2].prefix_cache.hits

    (_, b_after), hits_ab = alone(["tA", "tB"])
    (b_alone,), _ = alone(["tB"])
    _, hits_aa = alone(["tA", "tA"])
    probe_line = {"tenant_probe": steered, "phase": label, "prompt_tokens": len(prompts[1]),
                  "tB_after_tA_equals_tB_alone": b_after == b_alone, "prefix_hits_tA_tB": hits_ab,
                  "prefix_hits_tA_tA": hits_aa}
    print(json.dumps(probe_line))
    if not all(steered.values()):
        raise AssertionError(f"{label}: a tenant decoded the base's tokens: {steered}")
    if b_after != b_alone or hits_ab != 0 or hits_aa != 1:
        raise AssertionError(f"{label}: prefix isolation failed: {probe_line}")


def adapter_drains(torch, device, prompts_path, base, tenants, repeat_path):
    """Phase adapters: the CLI drain, the mixed-tenant drains (sequential,
    packed, under slot contention), the tenant and prefix-isolation probes,
    and a mixed-tenant ``spec="ngram"`` drain over the repeat traffic (kernel
    5 at M = B(K+1) in every verify forward); returns kernel 5's launches
    over the drains and the spec drain's (kernel 1 launches, at the window
    shape)."""
    from relora_tpu_torch import serve_cli
    from relora_tpu_torch.config.model import load_model_config
    from relora_tpu_torch.ops import lora_matmul as LM
    from relora_tpu_torch.serve.adapters import AdapterRegistry

    layers = load_model_config("llama_250m").num_hidden_layers
    prompts = read_prompts(prompts_path)
    mix = [None] + list(TENANT_ALPHAS)
    total = 0

    def drained(label, run, n_requests=len(prompts), **extra):
        nonlocal total
        LM.grouped_lora_matmul.launches = 0
        with EngineCalls("_forward") as forwards:
            completions, seconds = run()[:2]
        launches = LM.grouped_lora_matmul.launches
        tokens = [c.tokens for c in completions.values()]
        n = sum(len(t) for t in tokens)
        line = {"drain": label, "requests": len(tokens), "tokens": n, "seconds": seconds,
                "tokens_per_s": n / seconds, "forwards": forwards.calls,
                "launches": {"grouped_lora_matmul": launches}, **extra}
        print(json.dumps(line))
        if len(tokens) != n_requests or not all(1 <= len(t) <= 64 for t in tokens):
            raise AssertionError(f"drain {label}: malformed completions")
        if not all(0 <= tok < 32100 for t in tokens for tok in t):
            raise AssertionError(f"drain {label}: token id out of the vocabulary")
        if forwards.calls == 0 or launches != 7 * layers * forwards.calls:
            raise AssertionError(f"drain {label}: kernel 5 launched {launches} times over "
                                 f"{forwards.calls} forwards, expected 7 x {layers} per forward")
        total += launches

    drained("adapters_cli", lambda: serve_cli.run([
        "--model_config", "llama_250m", "--checkpoint", base, "--no-merge", "--adapter-dir",
        tenants, "--adapters", "tA,tB", "--paged", "--dtype", "bf16", "--max-batch", str(BATCH),
        "--max-new-tokens", "32", "--input-file",
        head_prompts(prompts_path, TENANT_HEAD, "adapters_cli_prompts.txt")]), TENANT_HEAD)

    engine = tenant_engine(torch, base, ADAPTER_SLOTS, device)
    registry = AdapterRegistry(tenants, ADAPTER_SLOTS, expected_r=ADAPTER_R, writer=engine.adapter_writer())
    requests = tenant_requests(prompts, mix, max_new=TENANT_NEW)
    for packed in (False, True):
        drained("tenants_packed" if packed else "tenants",
                lambda: tenant_drain(torch, engine, registry, requests, packed), adapters=mix)

    tenant_probes(torch, engine, registry, prompts, "adapters")
    del engine, registry
    torch.cuda.empty_cache()

    engine = tenant_engine(torch, base, 3, device)
    registry = AdapterRegistry(tenants, 3, expected_r=ADAPTER_R, writer=engine.adapter_writer())
    # contention over CONTENTION_PROMPTS prompts at CONTENTION_NEW new tokens:
    # the slots churn all the same (the registry line counts it)
    drained("tenants_contention", lambda: tenant_drain(
        torch, engine, registry,
        tenant_requests(prompts[:CONTENTION_PROMPTS], mix, max_new=CONTENTION_NEW)),
        CONTENTION_PROMPTS, adapters=mix, slots=3)
    stats = registry.stats()
    print(json.dumps({"contention_registry": stats}))
    if stats["evictions_total"] < 1 or stats["loads_total"] <= len(TENANT_ALPHAS):
        raise AssertionError(f"contention drain: expected loads and evictions mid-traffic, got {stats}")
    del engine, registry
    torch.cuda.empty_cache()

    from relora_tpu_torch.ops import attention as A

    engine = tenant_engine(torch, base, ADAPTER_SLOTS, device, spec_k=SPEC_K)
    registry = AdapterRegistry(tenants, ADAPTER_SLOTS, expected_r=ADAPTER_R,
                               writer=engine.adapter_writer())
    repeat = tenant_requests(read_prompts(repeat_path)[:TENANT_HEAD], mix, max_new=TENANT_NEW)
    plain_tps = tenant_drain(torch, engine, registry, repeat)
    plain_tps = sum(len(c.tokens) for c in plain_tps[0].values()) / plain_tps[1]
    A.paged_decode_attention.launches = 0
    LM.grouped_lora_matmul.launches = 0
    with EngineCalls("_forward") as forwards, EngineCalls("verify_paged") as calls:
        completions, seconds, sched = tenant_drain(torch, engine, registry, repeat, spec="ngram")
    grouped = LM.grouped_lora_matmul.launches
    k1 = A.paged_decode_attention.launches
    if calls.launches["paged_decode_attention"] != layers * calls.calls:
        raise AssertionError("drain tenants_spec: kernel 1 did not launch 24 times a verify call")
    if forwards.calls == 0 or grouped != 7 * layers * forwards.calls:
        raise AssertionError(f"drain tenants_spec: kernel 5 launched {grouped} times over "
                             f"{forwards.calls} forwards, expected 7 x {layers} per forward")
    spec_line("tenants_spec", completions, seconds, sched, calls.launches["paged_decode_attention"],
              {"paged_decode_attention": k1, "grouped_lora_matmul": grouped}, plain_tps,
              len(repeat))
    return total + grouped, k1, calls.launches["paged_decode_attention"]


def f32_adapters(torch, device, tenants, model_name="llama_250m"):
    """Phase f32-adapters: decode_paged and step_paged of a slotted
    ``model_name`` at f32, the kernel arm against the plain arm from
    identical pools, rows on mixed adapter slots; logits compared.
    llama_250m runs at full depth with the tenants of ``tenants``; any other
    model at 2 layers with seeded factors in each slot (``tenants`` None)."""
    import numpy as np

    from relora_tpu_torch.config.model import load_model_config
    from relora_tpu_torch.core.relora import LoraSpec, kaiming_uniform
    from relora_tpu_torch.models.family import causal_lm_class
    from relora_tpu_torch.models.lora import LoRALinear
    from relora_tpu_torch.ops import lora_matmul as LM
    from relora_tpu_torch.serve.adapters import default_loader, extract_lora_factors
    from relora_tpu_torch.serve.engine import InferenceEngine

    cfg, tag = (load_model_config(model_name), "") if model_name == "llama_250m" else two_layer(model_name)
    spec = LoraSpec(r=ADAPTER_R, alpha=32.0)
    with torch.device(device):
        model = causal_lm_class(cfg)(cfg, lora=spec)
    gen = torch.Generator(device=device).manual_seed(1)
    seeded_init(torch, model, gen)
    W = cfg.max_sequence_length // PAGE
    engine = InferenceEngine(cfg, model.state_dict(), cache_size=cfg.max_sequence_length,
                             page_size=PAGE, num_pages=(BATCH + 1) * W + 1, chunk_size=64,
                             token_budget=BATCH + 64, device=device, lora=spec,
                             adapter_slots=ADAPTER_SLOTS)
    for slot, (name, alpha) in enumerate(TENANT_ALPHAS.items(), 1):
        if tenants is not None:
            engine.write_adapter_slot(slot, *default_loader(os.path.join(tenants, name), ADAPTER_R))
            continue
        factors = {key: kaiming_uniform(p.shape, gen, device) if key.endswith("lora_a")
                   else torch.randn(p.shape, generator=gen, device=device) * 0.05
                   for key, p in extract_lora_factors(model.state_dict()).items()}
        engine.write_adapter_slot(slot, factors, alpha / ADAPTER_R)
    del model
    modules = [m for m in engine.model.modules() if isinstance(m, LoRALinear) and m.lora is not None]
    rng = np.random.default_rng(4)
    lengths = rng.integers(32, 513, BATCH)
    slots = (np.arange(BATCH) % ADAPTER_SLOTS).astype(np.int32)
    tables = (np.arange(BATCH * W).reshape(BATCH, W) + 1).astype(np.int32)
    pool = engine.init_pool()
    for row, L in enumerate(lengths):
        prompt = rng.integers(2, cfg.vocab_size, L)
        for start in range(0, L, 64):
            ids = np.zeros((1, 64), np.int32)
            part = prompt[start : start + 64]
            ids[0, : len(part)] = part
            _, pool = engine.prefill_chunk(ids, start, pool, tables[row : row + 1],
                                           adapter_idx=[slots[row]])

    def both(step):
        out = {}
        for arm, attention, grouped in (("kernel", "auto", "auto"), ("plain", "naive", "gathered")):
            engine.model.attention_arm = attention
            for m in modules:
                m.grouped_arm = grouped
            pool_copy = [{k: t.clone() for k, t in layer.items()} for layer in pool]
            n0 = LM.grouped_lora_matmul.launches
            out[arm] = step(pool_copy).float()
            if (LM.grouped_lora_matmul.launches > n0) != (arm == "kernel"):
                raise AssertionError(f"f32-adapters: the {arm} arm took the wrong grouped path")
        engine.model.attention_arm = "auto"
        for m in modules:
            m.grouped_arm = "auto"
        torch.cuda.synchronize()
        return (out["kernel"] - out["plain"]).abs().max().item(), out["kernel"]

    token = rng.integers(2, cfg.vocab_size, (BATCH, 1)).astype(np.int32)
    err_d, logits = both(lambda p: engine.decode_paged(p, token, lengths[:, None], tables, adapter_idx=slots)[0])
    ptables = np.zeros((BATCH + 2, W + 1), np.int32)
    ptables[:BATCH, :W] = tables
    ptables[BATCH, :W] = np.arange(W) + 1 + BATCH * W
    n_new = 64 - 8
    ids = np.concatenate([token[:, 0], rng.integers(2, cfg.vocab_size, n_new), np.zeros(8, int)])
    positions = np.concatenate([lengths, np.arange(n_new), np.full(8, cfg.max_sequence_length)])
    row_map = np.array(list(range(BATCH)) + [BATCH] * n_new + [BATCH + 1] * 8, np.int32)
    adapter_idx = np.concatenate([slots, np.full(n_new, 2), np.zeros(8)]).astype(np.int32)
    err_p, plogits = both(lambda p: engine.step_paged(
        p, ids[None].astype(np.int32), positions[None].astype(np.int32), ptables, row_map,
        adapter_idx=adapter_idx)[0])
    for name, err, out in (("decode_paged", err_d, logits), ("step_paged", err_p, plogits)):
        ok = bool(torch.isfinite(out).all()) and err <= LOGIT_TOL
        print(f"f32-adapters{tag} {name} shape={tuple(out.shape)} slots={slots.tolist()} "
              f"max_abs_err={err:.3e} tol={LOGIT_TOL:g} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"f32-adapters{tag} {name}: kernel arm and plain arm disagree")


# auto-arms: the projections of each model, (K, N) -> names
ARM_SHAPES = {
    "llama_250m": (((768, 768), ("q_proj", "k_proj", "v_proj", "o_proj")),
                   ((768, 2560), ("gate_proj", "up_proj")), ((2560, 768), ("down_proj",))),
    PYTHIA: (((2048, 6144), ("query_key_value",)), ((2048, 2048), ("dense",)),
             ((2048, 8192), ("dense_h_to_4h",)), ((8192, 2048), ("dense_4h_to_h",))),
}
# (mode, M, backward, weights_static, calls timed): a training forward (eval),
# a training forward+backward, and serving's decode and packed-step forwards
ARM_MODES = (("fwd", LORA_M, False, False, 20), ("fwd_bwd", LORA_M, True, False, 10),
             ("decode", 8, False, True, 100), ("decode", 72, False, True, 100))


def stream_ms(torch, fn, iters):
    """ms per call of ``fn`` run ``iters`` times back to back, CUDA events
    around the run: the device's time where it is the bottleneck, the host's
    (Python, dispatch, launches) where that is, as a model's step meets it."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def launch_cost_us(torch, device):
    """µs per call of a one-element in-place add and of an 8 x 8 bf16 matmul,
    each run 2000 times back to back: what one more eager op costs a path
    the host sets the pace of (the cost model's launch term)."""
    t = torch.zeros(1, device=device)
    m = torch.zeros(8, 8, device=device, dtype=torch.bfloat16)
    return {"add": stream_ms(torch, lambda: t.add_(1.0), 2000) * 1e3,
            "matmul": stream_ms(torch, lambda: torch.matmul(m, m), 2000) * 1e3}


def auto_arms(torch, device, model_name):
    """Phase auto-arms: at each of ``model_name``'s projection shapes, r = 128,
    bf16, over a bf16 base (the transposed view the model passes) and an
    int8 one (the codes' view and scales), each arm of ``lora_matmul`` timed
    by :func:`stream_ms` in every mode of :data:`ARM_MODES`, beside
    ``choose_arm``'s pick under the H100 model and the fastest arm it may
    pick (merged only for static weights).  Prints one line per (shape, base,
    mode); returns the entries."""
    from relora_tpu_torch.ops.lora_dispatch import ARMS, candidate_arms, choose_arm, lora_matmul
    from relora_tpu_torch.ops.quant import quantize_int8

    entries = []
    for (K, N), names in ARM_SHAPES[model_name]:
        for mode, M, backward, static, iters in ARM_MODES:
            x, w, a, b, gy = make_lora_case(torch, device, M, K, N, LORA_R, "bf16", seed=7)
            q_nk, qs = quantize_int8(w.t())
            for base_kind, base in (("bf16", w), ("int8", (q_nk.t(), qs))):
                leaves = [t.detach().requires_grad_(backward) for t in (x, a, b)]

                def call(arm):
                    if not backward:
                        with torch.no_grad():
                            return lora_matmul(*leaves[:1], base, *leaves[1:], 0.25, arm=arm,
                                               weights_static=static)
                    y = lora_matmul(leaves[0], base, leaves[1], leaves[2], 0.25, arm=arm)
                    return torch.autograd.grad(y, leaves, gy)

                runs = {arm: [] for arm in ARMS}
                for _ in range(3):  # in turns, the median of three runs each
                    for arm in ARMS:
                        runs[arm].append(stream_ms(torch, lambda: call(arm), iters))
                ms = {arm: sorted(t)[1] for arm, t in runs.items()}
                pick = choose_arm(M, K, N, LORA_R, 2, 1 if base_kind == "int8" else 2,
                                  weights_static=static, backward=backward)
                fastest = min(candidate_arms(weights_static=static), key=ms.get)
                entry = {"auto_arms": model_name, "K": K, "N": N, "projections": list(names),
                         "base": base_kind, "mode": mode, "M": M, "ms": ms, "pick": pick,
                         "fastest": fastest, "pick_is_fastest": pick == fastest,
                         "pick_over_fastest": ms[pick] / ms[fastest]}
                print(json.dumps(entry))
                entries.append(entry)
            torch.cuda.empty_cache()
    return entries


# the first forward of an unmerged drain against the merged drain's of the
# same checkpoint: bf16 logits after 24 layers, where the merged weight
# W + s·A@B is rounded to bf16 once and the unmerged arms round x@W and the
# branch apart (each a few bf16 ulps a layer), relative to max(1, max|logit|)
NOMERGE_LOGIT_TOL = 5e-2


def first_forward_logits(torch, engine, prompt):
    """The logits of ``prompt``'s first prefill chunk through ``engine`` on a
    fresh pool, as a drain's first forward computes them."""
    import numpy as np

    ids = np.zeros((1, engine.chunk_size), np.int32)
    part = prompt[: engine.chunk_size]
    ids[0, : len(part)] = part
    table = np.arange(1, engine.block_table_width + 1, dtype=np.int32)[None]
    with torch.inference_mode():
        logits, _ = engine.prefill_chunk(ids, 0, engine.init_pool(), table)
    return logits[0, : len(part)].float()


NOMERGE_PROMPTS = 8  # nomerge drains the first 8 prompts (one full batch)
NOMERGE_NEW = 16  # nomerge's new tokens a request


def nomerge_drains(torch, prompts, checkpoints):
    """Phase nomerge: each checkpoint of ``checkpoints`` (``{base: dir}``, a
    bf16 and an int8 base) drained over the first NOMERGE_PROMPTS prompts
    by ``serve_cli --checkpoint C`` merged,
    then ``--no-merge`` sequential and ``--packed`` (every projection through
    ``lora_matmul(arm="auto")``): the picks printed, the fused kernels'
    launches equal to the fused picks, the paged kernel launched, the first
    forward's logits held to the merged engine's within NOMERGE_LOGIT_TOL,
    greedy tokens' agreement and tokens/s printed beside the merged drain's.
    Returns the fused kernels' launches."""
    from relora_tpu_torch import serve_cli
    from relora_tpu_torch.ops import attention as A
    from relora_tpu_torch.ops import lora_matmul as LM

    head = head_prompts(prompts, NOMERGE_PROMPTS, "nomerge_prompts.txt")
    common = ["--model_config", "llama_250m", "--dtype", "bf16", "--max-batch", "8", "--paged",
              "--max-new-tokens", str(NOMERGE_NEW), "--input-file", head]
    first = read_prompts(prompts)[0]
    wrappers = {"fused_lora_forward": LM.fused_lora_forward,
                "fused_lora_int8_forward": LM.fused_lora_int8_forward,
                "paged_decode_attention": A.paged_decode_attention,
                "packed_paged_attention": A.packed_paged_attention}
    fused_launches = {"fused_lora_forward": 0, "fused_lora_int8_forward": 0}
    for base, ckpt in checkpoints.items():
        merged, merged_s, sched = serve_cli.drain(common + ["--checkpoint", ckpt])
        merged_n = sum(len(c.tokens) for c in merged.values())
        want = first_forward_logits(torch, sched.engine, first)
        del sched
        torch.cuda.empty_cache()
        for label, extra, kernel in (("nomerge", [], "paged_decode_attention"),
                                     ("nomerge_packed", ["--packed"], "packed_paged_attention")):
            for w in wrappers.values():
                w.launches = 0
            with ArmWatch() as arms:
                completions, seconds, sched = serve_cli.drain(
                    common + ["--checkpoint", ckpt, "--no-merge"] + extra)
            launches = {n: w.launches for n, w in wrappers.items()}
            got = first_forward_logits(torch, sched.engine, first)
            del sched
            torch.cuda.empty_cache()
            err = (got - want).abs().max().item() / max(1.0, want.abs().max().item())
            tokens = [completions[u].tokens for u in sorted(completions)]
            n = sum(len(t) for t in tokens)
            same = sum(a == b for u, t in zip(sorted(merged), tokens)
                       for a, b in zip(t, merged[u].tokens))
            fused_kernel = "fused_lora_int8_forward" if base == "int8" else "fused_lora_forward"
            line = {"drain": f"{label}_{base}", "checkpoint": os.path.basename(ckpt), "tokens": n,
                    "seconds": seconds, "tokens_per_s": n / seconds,
                    "merged_tokens_per_s": merged_n / merged_s,
                    "greedy_agreement": same / max(1, merged_n), "first_logits_rel_err": err,
                    "tol": NOMERGE_LOGIT_TOL, "arms": arms.summary(), "launches": launches}
            print(json.dumps(line))
            if len(tokens) != NOMERGE_PROMPTS or not all(0 <= tok < 32100 for t in tokens for tok in t):
                raise AssertionError(f"{line['drain']}: malformed completions")
            if not err <= NOMERGE_LOGIT_TOL:
                raise AssertionError(f"{line['drain']}: first forward {err:.3e} from the merged "
                                     f"engine's, beyond {NOMERGE_LOGIT_TOL}")
            if launches[kernel] == 0 or not arms.calls:
                raise AssertionError(f"{line['drain']}: {kernel} or the cost model never ran")
            other = "fused_lora_forward" if base == "int8" else "fused_lora_int8_forward"
            if launches[fused_kernel] != arms.count("fused") or launches[other]:
                raise AssertionError(f"{line['drain']}: fused launches {launches}, "
                                     f"{arms.count('fused')} fused picks")
            fused_launches[fused_kernel] += launches[fused_kernel]
    return fused_launches


DECODE_M = 8  # a sequential decode step's rows (--max-batch 8)


def int8_decode_row(torch, device):
    """Kernel 4-int8 where the unmerged int8 drains run it most: M = DECODE_M
    rows at llama_250m's three projection shapes, r = 128, bf16, held to its
    twin (relative to max(1, max|twin|), LORA_TOL["bf16"]) and timed beside
    it, the dequantize + cuBLAS chain and the bound, summed per decoder layer
    into the row ``fused_lora_int8_forward@decode``."""
    import torch.nn.functional as F

    from relora_tpu_torch.ops import lora_matmul as LM
    from relora_tpu_torch.ops.quant import dequantize_int8

    name = "fused_lora_int8_forward"
    row = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "t_bytes": 0.0, "t_ops": 0.0}
    worst = 0.0
    with torch.no_grad():
        for K, N, count in LORA_SHAPES:
            x, q, qs, a, b, _ = make_int8_case(torch, device, DECODE_M, K, N, LORA_R, "bf16", seed=98)
            q_nk, s = q.t(), 0.25
            got, want = LM.fused_lora_int8_forward(x, q, qs, a, b, s)[0], LM.fused_lora_int8_forward_plain(
                x, q, qs, a, b, s)[0]
            err, rel, finite = _rel_err([(got, want)])
            if not (finite and rel <= LORA_TOL["bf16"]):
                raise AssertionError(f"{name} at M={DECODE_M}, K={K}, N={N}: {rel:.3e} from its twin")
            worst = max(worst, err)
            t_bytes, t_ops = int8_bound(DECODE_M, K, N, LORA_R, 2, name)
            for key, v in (("ms", time_ms(torch, lambda: LM.fused_lora_int8_forward(x, q, qs, a, b, s))),
                           ("plain_ms", time_ms(torch, lambda: LM.fused_lora_int8_forward_plain(
                               x, q, qs, a, b, s))),
                           ("library_ms", time_ms(torch, lambda: F.linear(
                               x, dequantize_int8(q_nk, qs, x.dtype)) + ((x @ a) @ b) * s)),
                           ("t_bytes", t_bytes), ("t_ops", t_ops)):
                row[key] += count * v
    line = {"name": f"{name}@decode", "route": "cuda", "source": "relora_tpu_torch/csrc/lora_matmul.cu",
            "replaces": f"relora_tpu/ops/{INT8_LINES[name]}", "launches": 0, "max_abs_err": worst,
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": max(row["t_bytes"], row["t_ops"]),
            "bound_by": "bytes" if row["t_bytes"] >= row["t_ops"] else "operations",
            "library_ms": row["library_ms"]}
    print(json.dumps({"int8_decode_timing": f"M={DECODE_M}, ms per decoder layer", **line}))
    return line


RESUME_ARGS = ["--lora_fused", "auto", "--lora_dropout", "0"]
RESUME_CUT = 5  # the update SIGTERM arrives in
# resumed against straight per-update losses: every kernel on the path is
# deterministic (kernel 3 and kernels 4, 6, 7 write each output from one
# block, no atomics; cuBLAS on one stream), so the runs must agree bit for bit
RESUME_TOL = 0.0


def resume(torch, data_config, straight, work):
    """Phase resume: the auto_train phase's run (``straight``: its line)
    again with ``--save_dir W --save_every 3 --keep_checkpoints 2``, SIGTERM
    while update RESUME_CUT runs (an emergency ``model_5``), then
    ``--autoresume`` on to update 9 across the merge and reset at 7; the
    per-update losses held to the straight run's within RESUME_TOL, the
    checkpoints kept, the save and restore seconds and the checkpoint's
    bytes printed.  Returns the final checkpoint's directory."""
    import signal

    from relora_tpu_torch import main as train_main
    from relora_tpu_torch.train import trainer as trainer_mod

    save_dir = os.path.join(work, "resume_llama_250m")
    shutil.rmtree(save_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    argv = TRAIN_ARGS + RESUME_ARGS + ["--save_dir", save_dir, "--save_every", "3",
                                       "--keep_checkpoints", "2",
                                       "--megatron_dataset_config", data_config]
    real = {"seeds": trainer_mod.dropout_seeds, "save": trainer_mod.save_checkpoint,
            "restore": trainer_mod.Trainer._restore}
    saves, restores = [], []

    def seeds(seed, update_step, n):
        if update_step == RESUME_CUT - 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return real["seeds"](seed, update_step, n)

    def save(save_dir, step, *args, **kwargs):
        t0 = time.perf_counter()
        path = real["save"](save_dir, step, *args, **kwargs)
        size = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        saves.append({"step": step, "seconds": time.perf_counter() - t0, "bytes": size})
        return path

    def restore(self, path, optimizer=True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real["restore"](self, path, optimizer)
        torch.cuda.synchronize()
        restores.append({"path": os.path.basename(path), "seconds": time.perf_counter() - t0})

    trainer_mod.save_checkpoint, trainer_mod.Trainer._restore = save, restore
    try:
        trainer_mod.dropout_seeds = seeds
        cut = train_main.main(argv)
        trainer_mod.dropout_seeds = real["seeds"]
        resumed = train_main.main(argv + ["--autoresume", "true"])
    finally:
        trainer_mod.dropout_seeds = real["seeds"]
        trainer_mod.save_checkpoint, trainer_mod.Trainer._restore = real["save"], real["restore"]
    losses = [r["loss"] for r in cut["records"] + resumed["records"]]
    diff = max(abs(a - b) for a, b in zip(losses, straight["losses"]))
    kept = sorted(d for d in os.listdir(save_dir) if d.startswith("model_"))
    line = {"resume": "llama_250m", "cut_at": cut["update_step"], "preempted": cut["preempted"],
            "resumed_to": resumed["update_step"], "n_lora_restarts": resumed["n_lora_restarts"],
            "n_optimizer_resets": resumed["n_optimizer_resets"], "kept": kept, "saves": saves,
            "restores": restores, "max_loss_diff": diff, "tol": RESUME_TOL, "losses": losses,
            "telemetry": telemetry(torch, save_dir, resumed, TRAIN_UPDATES)}
    print(json.dumps(line))
    if line["telemetry"]["problems"]:
        raise AssertionError(f"resume: telemetry {line['telemetry']['problems']}")
    if not (cut["preempted"] and cut["update_step"] == RESUME_CUT):
        raise AssertionError(f"resume: the cut run stopped at {cut['update_step']}, "
                             f"preempted={cut['preempted']}")
    if [s["step"] for s in saves] != [3, RESUME_CUT, TRAIN_UPDATES] or kept != [
            f"model_{RESUME_CUT}", f"model_{TRAIN_UPDATES}"]:
        raise AssertionError(f"resume: saves {saves}, kept {kept}")
    if [r["path"] for r in restores] != [f"model_{RESUME_CUT}"]:
        raise AssertionError(f"resume: restored {restores}")
    if (resumed["update_step"], resumed["n_lora_restarts"], resumed["n_optimizer_resets"]) != (
            TRAIN_UPDATES, 2, 2):
        raise AssertionError(f"resume: the resumed run ended at {resumed['update_step']} with "
                             f"{resumed['n_lora_restarts']} merges")
    if len(losses) != TRAIN_UPDATES or not diff <= RESUME_TOL:
        raise AssertionError(f"resume: losses {losses} against the straight run's "
                             f"{straight['losses']}: {diff} beyond {RESUME_TOL}")
    return os.path.join(save_dir, f"model_{TRAIN_UPDATES}")


SERVER_ARGS = ["--model_config", "llama_250m", "--random-init", "--dtype", "bf16", "--max-batch", "8",
               "--paged", "--max-new-tokens", "64"]
SERVER_WAIT = 180.0  # every wait of the server phase: an event or a state, never a fixed sleep
PROFILED_CLIENTS = 8  # the server's traced drain: the first 8 clients (one batch)
SERVER_GAUGES = ("batch_fill", "kv_pages_used", "kv_pages_free", "dispatches_per_round",
                 "tokens_per_dispatch", "prefill_pad_share", "active_slots", "queue_depth")


def http_call(port, method, path, payload=None):
    """One HTTP/1.1 request read to EOF: ``(status, headers, body)``."""
    import socket

    body = b"" if payload is None else json.dumps(payload).encode()
    with socket.create_connection(("127.0.0.1", port), timeout=SERVER_WAIT) as sock:
        sock.sendall(f"{method} {path} HTTP/1.1\r\nHost: smoke\r\nContent-Length: {len(body)}\r\n\r\n"
                     .encode() + body)
        data = b""
        while chunk := sock.recv(65536):
            data += chunk
    head, _, rest = data.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    headers = {k.strip().lower(): v.strip() for k, _, v in (ln.partition(":") for ln in lines[1:])}
    return int(lines[0].split()[1]), headers, rest


def wait_state(cond, what, timeout=SERVER_WAIT):
    """Poll ``cond`` (a server's own state) until true, or fail."""
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end:
        value = cond()
        if value:
            return value
        time.sleep(0.02)
    raise AssertionError(f"server: timed out waiting for {what}")


class Client(threading.Thread):
    """One raw-socket ``POST /v1/generate``; SSE events are timed as they
    arrive (``close_after``: hang up after that many tokens)."""

    def __init__(self, port, payload, close_after=None):
        super().__init__(daemon=True)
        self.port, self.payload, self.close_after = port, payload, close_after
        self.status, self.headers, self.body, self.final = None, {}, b"", None
        self.tokens, self.times, self.error, self.done = [], [], None, False
        self.headed = threading.Event()

    def run(self):
        try:
            self._exchange()
        except Exception as e:  # reported by the phase's checks
            self.error = repr(e)
        finally:
            self.headed.set()

    def _exchange(self):
        import socket

        body = json.dumps(self.payload).encode()
        self.t_send = time.perf_counter()
        with socket.create_connection(("127.0.0.1", self.port), timeout=SERVER_WAIT) as sock:
            sock.sendall(f"POST /v1/generate HTTP/1.1\r\nHost: smoke\r\nContent-Length: {len(body)}"
                         f"\r\n\r\n".encode() + body)
            buf = b""
            while b"\r\n\r\n" not in buf:
                chunk = sock.recv(65536)
                if not chunk:
                    raise ConnectionError("closed before the response head")
                buf += chunk
            head, buf = buf.split(b"\r\n\r\n", 1)
            lines = head.decode("latin-1").split("\r\n")
            self.status = int(lines[0].split()[1])
            self.headers = {k.strip().lower(): v.strip()
                            for k, _, v in (ln.partition(":") for ln in lines[1:])}
            self.headed.set()
            if self.status != 200 or not self.payload.get("stream", True):
                while chunk := sock.recv(65536):
                    buf += chunk
                self.body = buf
                return
            while True:
                while b"\n\n" not in buf:
                    chunk = sock.recv(65536)
                    if not chunk:
                        return
                    buf += chunk
                block, buf = buf.split(b"\n\n", 1)
                data = block.strip()[len(b"data: "):]
                if data == b"[DONE]":
                    self.done = True
                    return
                event = json.loads(data)
                if "token" in event:
                    self.tokens.append(event["token"])
                    self.times.append(time.perf_counter())
                    if self.close_after is not None and len(self.tokens) >= self.close_after:
                        return
                else:
                    self.final = event


    def result(self):
        return {k: getattr(self, k) for k in ("status", "headers", "body", "final", "tokens",
                                              "times", "error", "t_send", "done")}


def client_batch(port, payloads):
    """Every payload from a client thread of its own, all started together;
    each client's result once all have finished."""
    clients = [Client(port, p) for p in payloads]
    for c in clients:
        c.start()
    for c in clients:
        c.join(SERVER_WAIT)
        if c.is_alive():
            raise AssertionError("server: a client did not finish")
    return [c.result() for c in clients]


def client_pool():
    """One worker process for :func:`run_clients`: the clients then take no
    interpreter time from the server's model thread, as real clients in
    other processes take none.  ``time.perf_counter`` is the system's
    monotonic clock, so its stamps compare across the two processes."""
    import multiprocessing

    return multiprocessing.get_context("spawn").Pool(1)


def run_clients(pool, port, payloads):
    """:func:`client_batch` in ``pool``'s worker."""
    import types

    return [types.SimpleNamespace(**r) for r in pool.apply(client_batch, (port, payloads))]


def latency_stats(clients):
    """TTFT (send to first token event) p50 / p99 over the requests, TPOT
    (the gaps between a stream's token events, pooled) p50, and tokens/s
    over the wall from the first send to the last token."""
    import numpy as np

    served = [c for c in clients if c.tokens]
    ttft = [c.times[0] - c.t_send for c in served]
    gaps = [b - a for c in served for a, b in zip(c.times, c.times[1:])]
    n = sum(len(c.tokens) for c in served)
    wall = max(c.times[-1] for c in served) - min(c.t_send for c in clients)
    return {"ttft_p50_s": float(np.percentile(ttft, 50)), "ttft_p99_s": float(np.percentile(ttft, 99)),
            "tpot_p50_s": float(np.percentile(gaps, 50)) if gaps else None,
            "tokens": n, "seconds": wall, "tokens_per_s": n / wall}


def check_stream(label, c, vocab):
    """A served stream: status 200, a finish record equal to the stream,
    every id in the vocabulary."""
    if c.error or c.status != 200 or c.final is None:
        raise AssertionError(f"server {label}: request failed: {c.status} {c.error} {c.body[:200]}")
    if c.final["tokens"] != c.tokens:
        raise AssertionError(f"server {label}: the stream differs from its finish record")
    if not all(0 <= t < vocab for t in c.tokens):
        raise AssertionError(f"server {label}: token id out of the vocabulary")


def check_metrics_text(label, text):
    """``/metrics`` parses as Prometheus text (a ``# TYPE`` line or ``name
    value`` per line) and carries the scheduler's gauges."""
    names = set()
    for line in text.strip().splitlines():
        if line.startswith("# TYPE "):
            if line.split()[3] not in ("counter", "gauge", "histogram"):
                raise AssertionError(f"server {label}: bad /metrics line {line!r}")
            continue
        name, value = line.rsplit(" ", 1)
        float(value)
        names.add(name.split("{")[0])
    missing = [g for g in SERVER_GAUGES if f"relora_serve_{g}" not in names]
    if missing:
        raise AssertionError(f"server {label}: /metrics lacks {missing}")


class InProcessServer:
    """``serve_cli``'s server mode in this process: the flags' scheduler and
    ``GenerateServer`` on a thread of its own (signal handlers off).
    ``gated`` holds the warmup until :meth:`release`, so ``/healthz`` can be
    seen warming; ``held`` holds the model thread after its warmup until
    ``hold`` is set (``warm`` is set when the warmup is done), so requests
    queue and the first round admits them all; the warmup's seconds are
    kept.  Leaving drains and joins."""

    def __init__(self, argv, gated=False, held=False):
        from relora_tpu_torch import serve_cli
        from relora_tpu_torch.serve.server import GenerateServer

        sched, kw = serve_cli.build_server(serve_cli.parse_args(argv + ["--port", "0"]))
        self.gate, self.warm, self.hold = threading.Event(), threading.Event(), threading.Event()
        if not gated:
            self.gate.set()
        if not held:
            self.hold.set()
        warmup, self.warmup_s = kw["warmup_fn"], None

        def gated_warmup():
            self.gate.wait(SERVER_WAIT)
            t0 = time.perf_counter()
            report = warmup()
            self.warmup_s = time.perf_counter() - t0
            self.warm.set()
            self.hold.wait(SERVER_WAIT)
            return report

        kw["warmup_fn"] = gated_warmup
        self.scheduler, self.server = sched, GenerateServer(sched, **kw)
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.raised = None

    def _serve(self):
        import asyncio

        try:
            asyncio.run(self.server.serve_forever(install_signal_handlers=False))
        except RuntimeError as e:
            self.raised = e

    def __enter__(self):
        self.thread.start()
        if not self.server.started.wait(SERVER_WAIT):
            raise AssertionError("server: the listener did not start")
        return self

    def release(self):
        self.gate.set()
        wait_state(lambda: self.health()[1]["status"] == "ok", "/healthz ok")

    def health(self):
        status, _, body = http_call(self.server.port, "GET", "/healthz")
        return status, json.loads(body)

    def __exit__(self, *exc):
        self.gate.set()
        self.hold.set()
        self.server.begin_drain()
        self.thread.join(SERVER_WAIT)
        if self.thread.is_alive() or self.raised or self.server._worker_error:
            raise AssertionError(f"server: did not drain cleanly ({self.raised!r})")


def server_drains(torch, prompts_path, inproc, midway=None):
    """Phase server (a, b, e): the 16 prompts through ``serve_cli``'s HTTP
    server, sequential then ``--packed``, from 16 concurrent SSE clients.
    ``/healthz`` must answer ``warming`` while the warmup is held and run,
    then ``ok``; every stream equals its finish record and ends ``length``
    (``eos`` where the in-process drain did); ``/metrics`` parses with the
    scheduler's gauges; the kernel launched; the sequential tokens are
    identical to the in-process drain's (``inproc``: label -> uid ->
    tokens), the packed ones reported beside it.  The first PROFILED_CLIENTS
    of the sequential drain's clients (one batch) then run once more, on a
    server of its own (a cold prefix cache, as the timed drain had) and
    under the profiler: the device's idle share over that traffic, whose
    tokens must equal the timed drain's.  ``midway`` (if given) is called
    after that profiled drain, before the packed one.  Returns (kernel
    launches, the lines)."""
    from relora_tpu_torch.ops import attention as A

    payloads = [{"prompt": p} for p in read_prompts(prompts_path)]
    launches = {"paged_decode_attention": 0, "packed_paged_attention": 0}
    lines = []
    with client_pool() as pool:
        for label, extra, kernel in (("bf16", [], "paged_decode_attention"),
                                     ("packed", ["--packed"], "packed_paged_attention")):
            A.paged_decode_attention.launches = 0
            A.packed_paged_attention.launches = 0
            with InProcessServer(SERVER_ARGS + extra, gated=True) as srv:
                status, body = srv.health()
                if status != 503 or body["status"] != "warming":
                    raise AssertionError(f"server {label}: /healthz {status} {body} while warming")
                srv.release()
                clients = run_clients(pool, srv.server.port, payloads)
                stats = latency_stats(clients)
                _, _, text = http_call(srv.server.port, "GET", "/metrics")
                check_metrics_text(label, text.decode())
            counts = {k: getattr(A, k).launches for k in launches}
            warmup_s, vocab = srv.warmup_s, srv.scheduler.engine.config.vocab_size
            del srv
            torch.cuda.empty_cache()
            idle = None
            if label == "bf16":
                with InProcessServer(SERVER_ARGS) as traced:
                    wait_state(lambda: traced.health()[1]["status"] == "ok", "/healthz ok")
                    again, wall, busy, _ = device_profile(torch, lambda: run_clients(
                        pool, traced.server.port, payloads[:PROFILED_CLIENTS]))
                idle = {"device_idle_share": 1.0 - busy / wall, "profiled_wall_s": wall,
                        "device_busy_s": busy, "clients": PROFILED_CLIENTS}
                del traced
                torch.cuda.empty_cache()
                if [c.tokens for c in again] != [c.tokens for c in clients[:PROFILED_CLIENTS]]:
                    raise AssertionError("server bf16: the traced drain's tokens differ")
                if midway is not None:
                    midway()
            diverged = []
            for uid, c in enumerate(clients):
                check_stream(label, c, vocab)
                want = "length" if len(c.tokens) == 64 else "eos"
                if c.final["finish_reason"] != want:
                    raise AssertionError(
                        f"server {label}: request {uid} ended {c.final['finish_reason']}")
                ref = inproc[label]["tokens"][uid]
                if c.tokens != ref:
                    i = next((j for j, (a, b) in enumerate(zip(c.tokens, ref)) if a != b),
                             min(len(c.tokens), len(ref)))
                    diverged.append({"request": uid, "index": i})
            line = {"server_drain": label, "requests": len(clients), **stats,
                    "inproc_tokens_per_s": inproc[label]["tokens_per_s"],
                    "rejected_429_share": 0.0, "warmup_s": warmup_s,
                    "profiled": idle, "identical_to_inproc": not diverged,
                    "divergences": diverged, "launches": counts}
            print(json.dumps(line))
            lines.append(line)
            if counts[kernel] == 0:
                raise AssertionError(f"server {label}: {kernel} never launched")
            if label == "bf16" and diverged:
                raise AssertionError(
                    f"server bf16: tokens differ from the in-process drain: {diverged}")
            for k in launches:
                launches[k] += counts[k]
    return launches, lines


def server_overload(torch, prompts_path):
    """Phase server (d): ``--max-queue 8`` under 40 concurrent requests
    (16 new tokens each): some answer 429 with a Retry-After, every admitted
    one completes; then a ``deadline_s`` request ends ``timeout`` with
    partial output, and a client that hangs up mid-stream frees its slot.
    Returns (kernel 1 launches, the line)."""
    from relora_tpu_torch.ops import attention as A

    prompts = read_prompts(prompts_path)
    A.paged_decode_attention.launches = 0
    with InProcessServer(SERVER_ARGS + ["--max-queue", "8"]) as srv:
        port = srv.server.port
        wait_state(lambda: srv.health()[1]["status"] == "ok", "/healthz ok")
        with client_pool() as pool:
            clients = run_clients(pool, port, [{"prompt": prompts[i % len(prompts)],
                                                "max_new_tokens": 16} for i in range(40)])
        served = [c for c in clients if c.status == 200]
        shed = [c for c in clients if c.status == 429]
        stats = latency_stats(served)
        late = Client(port, {"prompt": prompts[0][:32], "max_new_tokens": 512,
                             "deadline_s": 0.5})
        late.start()
        late.join(SERVER_WAIT)
        gone = Client(port, {"prompt": prompts[1][:32], "max_new_tokens": 512},
                      close_after=2)
        gone.start()
        gone.join(SERVER_WAIT)

        def freed():
            text = http_call(port, "GET", "/metrics")[2].decode()
            return ('relora_serve_requests_finished_total{reason="cancelled"} 1' in text
                    and "relora_serve_active_slots 0" in text)

        wait_state(freed, "the hung-up request's slot to free")
        metrics = http_call(port, "GET", "/metrics")[2].decode()
    vocab = srv.scheduler.engine.config.vocab_size
    for c in served:
        check_stream("overload", c, vocab)
        if c.final["finish_reason"] not in ("length", "eos"):
            raise AssertionError(f"server overload: an admitted request ended {c.final}")
    line = {"server_drain": "overload", "requests": len(clients), "served": len(served),
            "rejected_429": len(shed), "rejected_429_share": len(shed) / len(clients), **stats,
            "retry_after": sorted({c.headers.get("retry-after") for c in shed}),
            "deadline_tokens": len(late.tokens),
            "deadline_finish": late.final and late.final["finish_reason"],
            "hung_up_after": len(gone.tokens), "launches": A.paged_decode_attention.launches}
    print(json.dumps(line))
    if not shed or any(not c.headers.get("retry-after") for c in shed):
        raise AssertionError(f"server overload: no 429 with Retry-After under 40 requests: {line}")
    if len(served) + len(shed) != len(clients):
        raise AssertionError(f"server overload: a request neither served nor shed: "
                             f"{[(c.status, c.error) for c in clients]}")
    if (late.final is None or late.final["finish_reason"] != "timeout"
            or not 0 < len(late.tokens) < 512):
        raise AssertionError(f"server overload: the deadline request did not end in a partial "
                             f"timeout: {line}")
    if "relora_serve_disconnects_total 1" not in metrics:
        raise AssertionError("server overload: the hang-up was not counted")
    if A.paged_decode_attention.launches == 0:
        raise AssertionError("server overload: paged_decode_attention never launched")
    torch.cuda.empty_cache()
    return A.paged_decode_attention.launches, line


def server_process(work):
    """Start server (f)'s process, the real entry point ``python -m
    relora_tpu_torch.serve_cli ... --port 0 --port-file F --run-dir R``,
    without waiting: it starts up and warms while the phases before
    :func:`server_subprocess` run.  Returns (process, its stderr log, port
    file, run dir, the start's clock)."""
    port_file = os.path.join(work, "server.port")
    run_dir = os.path.join(work, "server_run")
    for path in (port_file, os.path.join(run_dir, "metrics.jsonl")):
        if os.path.exists(path):
            os.remove(path)
    env = {k: v for k, v in os.environ.items() if k not in ("RELORA_TPU_FAULTS", "RELORA_TPU_REPLICA_ID")}
    log = open(os.path.join(work, "server_stderr.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "relora_tpu_torch.serve_cli", *SERVER_ARGS, "--port", "0",
         "--port-file", port_file, "--run-dir", run_dir],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=log)
    return proc, log, port_file, run_dir, time.perf_counter()


def server_subprocess(started, prompts_path, inproc):
    """Phase server (f) over :func:`server_process`'s process (``started``):
    ``/healthz`` goes ok, 10 requests stream (8 decoding, 2 queued), SIGTERM
    lands while they do; then a new request gets 503, every accepted one
    finishes, and the process exits 0.  Its warmup seconds come from its
    ``metrics.jsonl`` (``serve_warm``); ``ready_s`` counts from its start."""
    prompts = read_prompts(prompts_path)
    proc, log, port_file, run_dir, t_start = started
    with log:
        try:
            wait_state(lambda: os.path.exists(port_file) and open(port_file).read().strip(),
                       "the port file")
            port = int(open(port_file).read())
            seen = set()

            def healthy():
                status, _, body = http_call(port, "GET", "/healthz")
                seen.add(json.loads(body)["status"])
                return status == 200

            wait_state(healthy, "/healthz ok")
            ready_s = time.perf_counter() - t_start
            clients = [Client(port, {"prompt": p}) for p in prompts[:10]]
            for c in clients:
                c.start()
            for c in clients:
                c.headed.wait(SERVER_WAIT)
            wait_state(lambda: any(c.tokens for c in clients), "a first token")
            proc.send_signal(signal.SIGTERM)
            wait_state(lambda: http_call(port, "GET", "/healthz")[0] == 503, "draining")
            late = http_call(port, "POST", "/v1/generate", {"prompt": prompts[11]})
            for c in clients:
                c.join(SERVER_WAIT)
            code = proc.wait(SERVER_WAIT)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(SERVER_WAIT)
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    warm = [r for r in records if r.get("_event") == "serve_warm"]
    same = sum(c.tokens == inproc["bf16"]["tokens"][i] for i, c in enumerate(clients))
    line = {"server_process": "serve_cli --port 0, SIGTERM mid-stream", "requests": len(clients),
            "healthz_seen": sorted(seen), "ready_s": ready_s,
            "warmup_s": warm[0]["duration_s"] if warm else None, "late_status": late[0],
            "finished": sum(c.final is not None and c.final["finish_reason"] in ("length", "eos")
                            for c in clients),
            "identical_to_inproc": same, "exit_code": code}
    print(json.dumps(line))
    if (code != 0 or late[0] != 503 or line["finished"] != len(clients) or not warm
            or same != len(clients)):
        raise AssertionError(f"server process: {line}")
    for c in clients:
        check_stream("process", c, 32100)


def server_f32(torch, work, prompts_path):
    """Phase server (g): the first 8 prompts, 32 new tokens, at f32, through
    the server and through the in-process drain, sequential and packed:
    greedy tokens identical, except where the in-process run's top two
    logits lie within 1e-3 (each divergence printed with its gap)."""
    from relora_tpu_torch import serve_cli

    prompts = read_prompts(prompts_path)[:8]
    path = os.path.join(work, "prompts8.txt")
    with open(path, "w") as f:
        f.writelines(" ".join(map(str, p)) + "\n" for p in prompts)
    f32 = [a if a != "bf16" else "f32" for a in SERVER_ARGS] + ["--max-new-tokens", "32"]
    for label, extra in (("f32", []), ("f32_packed", ["--packed"])):
        ref, _, sched = serve_cli.drain(f32 + extra + ["--input-file", path])
        with InProcessServer(f32 + extra) as srv:
            wait_state(lambda: srv.health()[1]["status"] == "ok", "/healthz ok")
            with client_pool() as pool:
                clients = run_clients(pool, srv.server.port, [{"prompt": p} for p in prompts])
        divergences = []
        for uid, c in enumerate(clients):
            check_stream(label, c, sched.engine.config.vocab_size)
            want = ref[uid].tokens
            i = next((j for j, (a, b) in enumerate(zip(c.tokens, want)) if a != b), None)
            if i is None and len(c.tokens) == len(want):
                continue
            i = min(len(c.tokens), len(want)) if i is None else i
            ids = torch.tensor([prompts[uid] + want[:i]], device=sched.engine.device)
            with torch.inference_mode():
                logits = sched.engine.model(ids)[0, -1].float()
            top = torch.topk(logits, 2).values
            divergences.append({"request": uid, "index": i, "top2_gap": (top[0] - top[1]).item()})
        ok = all(d["top2_gap"] <= 1e-3 for d in divergences)
        print(json.dumps({"server_f32": label, "requests": len(clients), "divergences": divergences,
                          "ok": ok}))
        if not ok:
            raise AssertionError(f"server {label}: diverges from the in-process drain: {divergences}")
        del sched, srv, clients
        torch.cuda.empty_cache()


# -- the fleet tier's replica half: disaggregated serving and the weight hot swap --------

# every replica of the fleet phases: the server drains' flags over an int8 pool
FLEET_ARGS = SERVER_ARGS + ["--kv-dtype", "int8"]
FLEET_POLL_S = 0.5  # the watching replica's --watch-interval-s
FLEET_RELOAD_S = 10.0  # bound on one reload's restore and copy, beside two polls
FLEET_NEW = 16  # new tokens of the reload phase's identity and in-flight requests
FLEET_PACKED = 4  # requests of the packed prefill replica's drain


def fleet_config():
    """The fleet replicas' model config (FLEET_ARGS' ``--model_config``)."""
    from relora_tpu_torch.config.model import load_model_config

    return load_model_config(FLEET_ARGS[FLEET_ARGS.index("--model_config") + 1])


class Replica:
    """One ``python -m relora_tpu_torch.serve_cli ... --port 0 --port-file F
    --run-dir R`` process of the fleet phases, under ``work/name``: its own
    ``RELORA_TPU_REPLICA_ID`` (a uid space of its own) and ``faults``
    (``RELORA_TPU_FAULTS``), its stderr in ``stderr.log``."""

    def __init__(self, work, name, argv, faults=""):
        self.name, self.dir, self.port = name, os.path.join(work, name), None
        shutil.rmtree(self.dir, ignore_errors=True)
        os.makedirs(self.dir)
        env = {k: v for k, v in os.environ.items() if k != "RELORA_TPU_FAULTS"}
        env["RELORA_TPU_REPLICA_ID"] = name
        if faults:
            env["RELORA_TPU_FAULTS"] = faults
        self.log_path = os.path.join(self.dir, "stderr.log")
        self.log = open(self.log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "relora_tpu_torch.serve_cli", *argv, "--port", "0",
             "--port-file", os.path.join(self.dir, "port"), "--run-dir", self.dir],
            cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=self.log)

    def _alive(self):
        if self.proc.poll() is not None:
            with open(self.log_path) as f:
                tail = f.read()[-3000:]
            raise AssertionError(f"replica {self.name} exited {self.proc.returncode}:\n{tail}")

    def ready(self):
        """Wait for the bound port, then ``/healthz`` ok (the warmup done)."""
        path = os.path.join(self.dir, "port")

        def bound():
            self._alive()
            return os.path.exists(path) and open(path).read().strip()

        self.port = int(wait_state(bound, f"{self.name}'s port file"))

        def ok():
            self._alive()
            return self.health()["status"] == "ok"

        wait_state(ok, f"{self.name} /healthz ok")
        return self

    def health(self):
        return json.loads(http_call(self.port, "GET", "/healthz")[2])

    def disagg(self):
        return self.health()["paging"]["disagg"]

    def post(self, path, payload):
        status, _, body = http_call(self.port, "POST", path, payload)
        return status, json.loads(body or b"{}")

    def endpoint(self):
        return ("127.0.0.1", self.port)

    def stop(self):
        """SIGTERM (the drain); the exit code and each serving kernel's
        launches after the warmup (the ``kernel_launches`` event the
        replica logs at its exit)."""
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            code = self.proc.wait(SERVER_WAIT)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait(SERVER_WAIT)
            self.log.close()
        with open(os.path.join(self.dir, "metrics.jsonl")) as f:
            counts = next(r for r in map(json.loads, f) if r.get("_event") == "kernel_launches")
        self.launches = {k: v for k, v in counts.items() if not k.startswith(("_", "warmup/"))}
        return code, self.launches


def fleet_checkpoints(torch, work, device):
    """``train/checkpoint.py`` directories ``model_{step}`` of the fleet's
    model (llama_250m) at bf16 under one save directory, each drawn from
    ``init_params`` with its step as the seed (other weights than the
    ``--random-init`` replicas', whose seed is 0); no ``latest`` pointer
    yet.  Returns (save dir, {step: path})."""
    from relora_tpu_torch.models.params_util import init_params
    from relora_tpu_torch.serve.engine import build_decode_model
    from relora_tpu_torch.train.checkpoint import save_checkpoint

    root = os.path.join(work, "fleet_checkpoints")
    shutil.rmtree(root, ignore_errors=True)
    model = build_decode_model(fleet_config(), dtype=torch.bfloat16, device=device)
    paths = {}
    for step in (1, 2, 3, 4):
        init_params(model, torch.Generator(device=device).manual_seed(step))
        paths[step] = save_checkpoint(root, step, model.state_dict(), {"update_step": step})
    del model
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return root, paths


def fleet_launch(torch, work, device):
    """Start the fleet phases' six replicas, without waiting for them (the
    kernels are built already, so none races another's build): ``decode``
    (``--role decode``) first, then ``prefill`` (``--role prefill`` with
    ``serve_migrate`` armed once) and ``packed`` (``--role prefill
    --packed`` with ``deploy_reload`` armed once), both naming ``decode`` in
    ``peers.json`` (written by :func:`fleet_ready`); while those start,
    :func:`fleet_checkpoints` and ``write_adapter_checkpoints`` write the
    checkpoints, then ``watch`` starts, mixed, on ``--checkpoint model_1
    --watch-checkpoints`` over their save directory, and the tenant pair
    over the adapters' base with ``--no-merge --adapter-dir --adapters
    tA``: ``tdecode`` (``--role decode``), then ``tprefill`` (``--role
    prefill``, ``serve_migrate`` armed once) naming it in
    ``peers_tenant.json``; last, the pythia_serving group's checkpoints
    (``write_adapter_checkpoints`` at pythia_1b's widths and
    PYTHIA_TRAIN_LAYERS layers; its draft is :func:`pythia_draft`'s).
    Returns (fleet, save dir, {step: path}, (base dir, adapter dir),
    (pythia base, adapter dir))."""
    root = os.path.join(work, "fleet")
    os.makedirs(root, exist_ok=True)
    for name in ("peers.json", "peers_tenant.json"):
        if os.path.exists(os.path.join(root, name)):
            os.remove(os.path.join(root, name))
    fleet = {"decode": Replica(root, "decode", FLEET_ARGS + ["--role", "decode"])}
    migrate_once = "serve_migrate:times=1,exc=runtimeerror"
    for name, extra, armed in (
        ("prefill", [], migrate_once),
        ("packed", ["--packed"], "deploy_reload:times=1,exc=runtimeerror"),
    ):
        fleet[name] = Replica(root, name, FLEET_ARGS + ["--role", "prefill", "--peer-file",
                                                        os.path.join(root, "peers.json")]
                              + extra, armed)
    try:
        save_dir, paths = fleet_checkpoints(torch, work, device)
        unmerged = [a for a in FLEET_ARGS if a != "--random-init"]
        fleet["watch"] = Replica(
            root, "watch", unmerged + ["--checkpoint", paths[1], "--watch-checkpoints", save_dir,
                                       "--watch-interval-s", str(FLEET_POLL_S)])
        model = FLEET_ARGS[FLEET_ARGS.index("--model_config") + 1]
        adapters = write_adapter_checkpoints(torch, work, device, model)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        tenant = unmerged + ["--checkpoint", adapters[0], "--no-merge", "--adapter-dir",
                             adapters[1], "--adapters", "tA"]
        fleet["tdecode"] = Replica(root, "tdecode", tenant + ["--role", "decode"])
        fleet["tprefill"] = Replica(root, "tprefill", tenant + [
            "--role", "prefill", "--peer-file", os.path.join(root, "peers_tenant.json")],
            migrate_once)
        pythia_args = pythia_train_args(work)
        pythia = write_adapter_checkpoints(torch, work, device,
                                           pythia_args[pythia_args.index("--model_config") + 1])
        if device.type == "cuda":
            torch.cuda.empty_cache()
    except BaseException:
        fleet_stop(fleet, check=False)
        raise
    return fleet, save_dir, paths, adapters, pythia


def fleet_ready(fleet):
    """Wait for each decode replica's port, write the ``peers.json`` naming
    it (``decode`` for the prefill replicas, ``tdecode`` for the tenant
    pair's), then wait for every replica's ``/healthz`` ok."""
    try:
        for name, roster in (("decode", "peers.json"), ("tdecode", "peers_tenant.json")):
            decode = fleet[name].ready()
            peers = os.path.join(os.path.dirname(decode.dir), roster)
            with open(peers + ".tmp", "w") as f:
                json.dump({"replicas": [{"rid": name, "host": "127.0.0.1", "port": decode.port,
                                         "role": "decode"}]}, f)
            os.replace(peers + ".tmp", peers)
        for r in fleet.values():
            r.ready()
    except BaseException:
        fleet_stop(fleet, check=False)
        raise
    return fleet


def fleet_stop(fleet, check=True):
    """SIGTERM every replica; with ``check``, each must exit 0, else (a
    phase failed) the tail of each one's stderr goes to this stderr.
    Returns the replicas' kernel launches after their warmups, summed."""
    total, codes = {}, {}
    for name, r in fleet.items():
        if not check:
            with open(r.log_path) as f:
                print(f"--- replica {name} stderr (tail):\n" + "".join(f.readlines()[-40:]),
                      file=sys.stderr)
        try:
            codes[name], launches = r.stop()
        except Exception as e:
            codes[name], launches = repr(e), {}
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    if check and any(c != 0 for c in codes.values()):
        raise AssertionError(f"fleet: replicas did not drain cleanly: {codes}")
    return total


def frame_bytes(c, prompt, page_size):
    """The length of the page-run frame the prefill replica sent for the
    stream ``c`` (``wire.encode_page_run`` of its migration record, the
    request id the response named as ``trace_id``, and the int8 pool
    leaves for the prompt's pages), reckoned without the replica."""
    from relora_tpu_torch.serve import wire
    from relora_tpu_torch.serve.paging import pages_needed

    cfg = fleet_config()
    n = pages_needed(len(prompt), page_size)
    record = wire.build_migration_record(
        uid=c.final["uid"], prompt=prompt, max_new_tokens=64, temperature=0.0, top_p=1.0,
        spec=True, adapter=None, first_token=c.tokens[0], position=len(prompt), token_index=1,
        n_pages=n)
    record["weights_version"] = 0  # the --random-init replicas'
    record["trace_id"] = c.headers["x-request-id"]
    return len(wire.encode_page_run(record, run_entries(cfg, n, page_size)))


def run_entries(cfg, n, page_size):
    """Zero-filled pool leaves of an ``n``-page run of the int8 pool, as
    ``export_page_run`` names and shapes them: codes per layer for k and v,
    and their per-page scales."""
    entries = []
    for i in range(cfg.num_hidden_layers):
        for leaf in ("k", "v"):
            shape = (n, page_size, cfg.kv_heads, cfg.head_dim)
            entries.append((f"layers.{i}.{leaf}", "int8", shape, bytes(math.prod(shape))))
        for leaf in ("k_scale", "v_scale"):
            entries.append((f"layers.{i}.{leaf}", "float32", (n, cfg.kv_heads),
                            bytes(4 * n * cfg.kv_heads)))
    return entries


def profile(replicas, action):
    """``POST /admin/profile`` with ``action`` to every replica at once (each
    window opens or closes at the same moment, and the processes read their
    traces in parallel; a window closes itself after the server's
    PROFILE_MAX_S), without waiting: the returned function waits for the
    replies and returns them by replica name."""
    out = {}

    def call(r):
        out[r.name] = r.post("/admin/profile", {"action": action})

    threads = [threading.Thread(target=call, args=(r,), daemon=True) for r in replicas]
    for t in threads:
        t.start()

    def join():
        for t in threads:
            t.join(SERVER_WAIT)
        bad = {k: v for k, v in out.items() if v[0] != 200}
        if bad or len(out) != len(replicas):
            raise AssertionError(f"fleet: /admin/profile {action}: {out}")
        return {k: v[1] for k, v in out.items()}

    return join


def first_divergence(got, want):
    return next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), min(len(got), len(want)))


def fleet_disagg(fleet, prompts_path, inproc):
    """Phase fleet_disagg: the 16 prompts (64 new tokens) through the
    ``--role prefill`` replica, which prefills each (kernel 1's pool writes
    through the chunk path) and hands its int8 page run to the ``--role
    decode`` replica (kernel 1), whose continuation it relays.  First a
    drill: with ``serve_migrate`` armed once, prompt 0 decodes at home,
    token-identical, one failure counted.  Then the first FLEET_PACKED
    prompts through the ``--packed`` prefill replica (kernel 2 in its
    prefills): every request finishes; its streams are counted against the
    in-process ``--packed --kv-dtype int8`` drain (packing without
    migration), and that drain's against the sequential one (what packing
    alone changes).  Then prompt 0 as tenant tA through the tenant pair
    twice: at home (``serve_migrate`` armed once on ``tprefill``) and
    migrated to ``tdecode`` (kernel 5 in its adapter slot), token-identical,
    one failure and one insert counted.  Last the timed drain, inside both
    replicas' ``/admin/profile`` windows (each one's device idle share over
    this drain; the profiler records while it runs), whose close is sent
    without waiting: the two replicas read their traces (~0.1 ms a kernel)
    while the caller runs phases that time nothing.  Returns the function
    that waits for those reads and checks the drain: all 16 streams
    token-identical to the in-process sequential int8 drain; the donor's
    ``pages_migrated`` equal to the prompts' pages and ``migration_bytes``
    to the frames' reckoned bytes; the receiver's ``migrated_inserts`` 16
    more.  It prints the line: tokens/s, TTFT p50, TPOT p50, migration
    bytes per prompt token, the idle shares, each step's seconds."""
    import types

    from relora_tpu_torch.serve.paging import pages_needed

    prompts = read_prompts(prompts_path)
    ref = inproc["int8"]["tokens"]
    vocab = fleet_config().vocab_size
    P, D, Q = fleet["prefill"], fleet["decode"], fleet["packed"]
    TP, TD = fleet["tprefill"], fleet["tdecode"]
    laps, t0 = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        laps[name], t0[0] = now - t0[0], now

    def diverged_from(streams, want):
        return [{"request": i, "index": first_divergence(got, want[i])}
                for i, got in enumerate(streams) if got != want[i]]

    drill = types.SimpleNamespace(**client_batch(P.port, [{"prompt": prompts[0]}])[0])
    check_stream("fleet drill", drill, vocab)
    drill_failures = P.disagg()["migration_failures"]
    lap("drill")
    packed = [types.SimpleNamespace(**c)
              for c in client_batch(Q.port, [{"prompt": p} for p in prompts[:FLEET_PACKED]])]
    packed_inserts = wait_state(
        lambda: (n := D.disagg()["migrated_inserts"]) == FLEET_PACKED and n, "the packed leg's inserts")
    lap("packed")
    tenant = [types.SimpleNamespace(**client_batch(
        TP.port, [{"prompt": prompts[0], "adapter": "tA", "max_new_tokens": FLEET_NEW}])[0])
        for _ in ("home", "migrated")]
    for c in tenant:
        check_stream("fleet tenant", c, vocab)
    tenant_failures = TP.disagg()["migration_failures"]
    tenant_inserts = TD.disagg()["migrated_inserts"]
    lap("tenant")
    profile((P, D), "start")()
    t_drain = time.perf_counter()
    clients = [types.SimpleNamespace(**c)
               for c in client_batch(P.port, [{"prompt": p} for p in prompts])]
    drain_s = time.perf_counter() - t_drain
    read = profile((P, D), "stop")
    lap("profiled_drain")

    def finish():
        idle = read()
        lap("profile_reads_waited")
        stats = latency_stats(clients)
        for c in clients:
            check_stream("fleet", c, vocab)
        diverged = diverged_from([c.tokens for c in clients], ref)
        pages = sum(pages_needed(len(p), PAGE) for p in prompts)
        frames = sum(frame_bytes(c, p, PAGE) for c, p in zip(clients, prompts))
        # the donor counts a run at its commit, once the relay has finished
        donor = wait_state(lambda: (d := P.disagg())["pages_migrated"] >= pages and d,
                           "the donor's commits")
        inserts = D.disagg()["migrated_inserts"] - packed_inserts
        lap("checks")
        packed_tokens = [c.tokens for c in packed]
        inproc_packed = inproc["packed_int8"]["tokens"]
        line = {"fleet_disagg": "--role prefill -> --role decode, int8 pool",
                "requests": len(clients), **stats, "drain_s": drain_s,
                "inproc_tokens_per_s": inproc["int8"]["tokens_per_s"],
                "identical_to_inproc": len(clients) - len(diverged), "divergences": diverged,
                "drill_identical": drill.tokens == ref[0], "drill_failures": drill_failures,
                "pages_migrated": donor["pages_migrated"], "pages_reckoned": pages,
                "migration_bytes": donor["migration_bytes"], "frame_bytes_reckoned": frames,
                "migration_bytes_per_prompt_token": donor["migration_bytes"]
                / sum(map(len, prompts)),
                "migration_failures": donor["migration_failures"], "migrated_inserts": inserts,
                "device_idle_share": {k: v["device_idle_share"] for k, v in idle.items()},
                "profiled_drain": idle, "step_seconds": laps,
                "packed": {"requests": len(packed), **latency_stats(packed),
                           "finished": sum(c.final is not None and c.final["finish_reason"]
                                           in ("length", "eos") for c in packed),
                           "identical_to_inproc": len(packed) - len(diverged_from(packed_tokens,
                                                                                  ref)),
                           "divergences_from_inproc_packed": diverged_from(packed_tokens,
                                                                           inproc_packed),
                           "inproc_packed_divergences_from_sequential": diverged_from(
                               [inproc_packed[i] for i in range(FLEET_PACKED)], ref)},
                "tenant": {"adapter": "tA", "identical": tenant[0].tokens == tenant[1].tokens,
                           "migration_failures": tenant_failures,
                           "migrated_inserts": tenant_inserts}}
        print(json.dumps(line))
        if not line["drill_identical"] or drill_failures != 1:
            raise AssertionError(f"fleet_disagg: the serve_migrate drill did not fail open "
                                 f"token-identical: {line}")
        if diverged:
            raise AssertionError(f"fleet_disagg: migrated streams differ from the in-process "
                                 f"drain: {diverged}")
        if (donor["pages_migrated"] != pages or donor["migration_bytes"] != frames
                or donor["migration_failures"] != 1 or inserts != len(prompts)):
            raise AssertionError(f"fleet_disagg: counters off the reckoning: {line}")
        # (a CPU rehearsal's windows see no kernel)
        if any((v["kernels"] == 0 and "--device" not in FLEET_ARGS) or v.get("expired")
               for v in idle.values()):
            raise AssertionError(f"fleet_disagg: a profile window saw no kernel or expired: "
                                 f"{idle}")
        if line["packed"]["finished"] != len(packed):
            raise AssertionError(f"fleet_disagg: a packed-leg request did not finish: {line}")
        if not line["tenant"]["identical"] or tenant_failures != 1 or tenant_inserts != 1:
            raise AssertionError(f"fleet_disagg: the tenant request did not migrate "
                                 f"token-identical to its local decode: {line}")
        return line

    return finish


def fleet_reload(torch, fleet, prompts_path, save_dir, paths):
    """Phase fleet_reload, over the fleet phases' replicas.  (a) A
    ``RollingUpdater`` over the fixed map {0: decode, 1: prefill} to
    ``model_1``: both report weights_version 1, the canary recorded on the
    first and matched on the second; 4 prompts (16 new tokens) through the
    prefill replica then equal an in-process drain of that checkpoint.  (b)
    An update of {prefill, packed} to ``model_2`` with
    ``deploy_reload`` armed once on ``packed``: it fails, both roll back to
    version 1 (decode stays on it), and every request in flight on the prefill and
    packed replicas during it finishes.  (c) ``python -m
    relora_tpu_torch.serve.deploy publish model_3``, run beside (a) and (b):
    the watching replica swaps to version 3 within two polls and the
    reload's FLEET_RELOAD_S (``watch_swap_s``: from the pointer's
    ``published_unix`` to the replica's ``serve_reload`` event); then
    ``deploy_corrupt_manifest`` armed on the publish of ``model_4``
    (``deploy.main`` in this process): the watcher rejects it and stays on
    version 3."""
    from relora_tpu_torch import serve_cli
    from relora_tpu_torch.serve import deploy
    from relora_tpu_torch.serve.deploy import RollingUpdater
    from relora_tpu_torch.utils import faults

    prompts = read_prompts(prompts_path)[:4]
    D, P, Q, W = fleet["decode"], fleet["prefill"], fleet["packed"], fleet["watch"]
    events = []
    # the command publishes model_3 while the updates run (the watcher's
    # replica is in neither update); its swap is timed from the pointer's
    # published_unix to the replica's serve_reload event
    env = {k: v for k, v in os.environ.items() if k != "RELORA_TPU_FAULTS"}
    pub = subprocess.Popen([sys.executable, "-m", "relora_tpu_torch.serve.deploy", "publish",
                            paths[3]], cwd=REPO, env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)

    def updater(replicas):
        eps = {i: r.endpoint() for i, r in enumerate(replicas)}
        return RollingUpdater(lambda: eps, probe_interval_s=0.05, probe_timeout_s=SERVER_WAIT,
                              emit=lambda event, idx, detail: events.append((event, idx, detail)))

    t0 = time.perf_counter()
    rolled = updater([D, P]).run(paths[1])
    roll_s = time.perf_counter() - t0
    versions = {r.name: (r.health()["weights_version"], r.health()["weights_checkpoint"])
                for r in (D, P)}
    got = client_batch(P.port, [{"prompt": p, "max_new_tokens": FLEET_NEW} for p in prompts])
    small = os.path.join(os.path.dirname(prompts_path), "fleet_prompts.txt")
    with open(small, "w") as f:
        f.writelines(" ".join(map(str, p)) + "\n" for p in prompts)
    argv = [a for a in FLEET_ARGS if a != "--random-init"]
    argv[argv.index("--max-new-tokens") + 1] = str(FLEET_NEW)
    want, _ = serve_cli.run(argv + ["--checkpoint", paths[1], "--input-file", small])
    same = sum(c["tokens"] == want[i].tokens for i, c in enumerate(got))

    inflight, done = [], threading.Event()

    def traffic(r):
        try:
            inflight.extend(client_batch(r.port, [{"prompt": p, "max_new_tokens": FLEET_NEW}
                                                  for p in prompts]))
        finally:
            done.set()

    threads = [threading.Thread(target=traffic, args=(r,), daemon=True) for r in (P, Q)]
    for t in threads:
        t.start()
    wait_state(lambda: P.health()["active_slots"] > 0 or done.is_set(), "requests in flight")
    n_events = len(events)
    t0 = time.perf_counter()
    refused = updater([P, Q]).run(paths[2])
    rollback_s = time.perf_counter() - t0
    for t in threads:
        t.join(SERVER_WAIT)
    drill = [e[0] for e in events[n_events:]]
    after = {r.name: (r.health()["weights_version"], r.health()["weights_checkpoint"])
             for r in (D, P, Q)}

    pub_out, pub_err = pub.communicate(timeout=SERVER_WAIT)
    with open(os.path.join(save_dir, "latest")) as f:
        published = json.load(f)["published_unix"]
    wait_state(lambda: W.health()["weights_version"] == 3, "the watcher's swap to model_3")
    with open(os.path.join(W.dir, "metrics.jsonl")) as f:
        swapped = next(r["_time"] for r in map(json.loads, f)
                       if r.get("_event") == "serve_reload" and r.get("weights_version") == 3)
    swap_s = swapped - published
    # the drill's publish in this process: deploy.main, as the command runs it
    faults.configure("deploy_corrupt_manifest")
    try:
        bad = deploy.main(["publish", paths[4]])
        corrupted = faults.fire_count("deploy_corrupt_manifest")
    finally:
        faults.reset()

    def rejected():
        with open(W.log_path) as f:
            return f"rejecting {paths[4]}" in f.read()

    wait_state(rejected, "the watcher's reject of the corrupt model_4")
    watched = W.health()
    line = {"fleet_reload": "4 replicas", "rolled": rolled, "roll_s": roll_s,
            "versions_after_roll": versions, "identical_to_inproc_checkpoint": same,
            "requests": len(prompts), "drill_rolled_back": refused is False,
            "drill_events": drill, "rollback_s": rollback_s, "versions_after_drill": after,
            "inflight": len(inflight),
            "inflight_finished": sum(c["final"] is not None and c["final"]["finish_reason"]
                                     in ("length", "eos") for c in inflight),
            "publish_rc": pub.returncode, "watch_swap_s": swap_s,
            "watch_poll_s": FLEET_POLL_S, "corrupt_publish_rc": bad,
            "manifest_corrupted": corrupted,
            "watch_version_after_corrupt": watched["weights_version"],
            "watch_checkpoint": watched["weights_checkpoint"]}
    print(json.dumps(line))
    if not rolled or any(v != (1, paths[1]) for v in versions.values()):
        raise AssertionError(f"fleet_reload: the rolling update did not land: {line} {events}")
    if same != len(prompts):
        raise AssertionError(f"fleet_reload: after the swap, {len(prompts) - same} streams differ "
                             "from an in-process engine on the checkpoint")
    if (refused is not False or "deploy_reload_failed" not in drill or "deploy_rollback" not in drill
            or any(v != (1, paths[1]) for v in after.values())):
        raise AssertionError(f"fleet_reload: the deploy_reload drill did not roll the fleet back: "
                             f"{line} {events[n_events:]}")
    if line["inflight_finished"] != 2 * len(prompts):
        raise AssertionError(f"fleet_reload: requests in flight during the update did not all "
                             f"finish: {line}")
    if pub.returncode != 0 or bad != 0 or corrupted != 1:
        raise AssertionError(f"fleet_reload: publish failed: {pub_out} {pub_err[-2000:]} {line}")
    if not swap_s <= 2 * FLEET_POLL_S + FLEET_RELOAD_S:
        raise AssertionError(f"fleet_reload: the watcher took {swap_s:.2f} s to swap: {line}")
    if watched["weights_version"] != 3 or watched["weights_checkpoint"] != paths[3]:
        raise AssertionError(f"fleet_reload: the watcher acted on a corrupt publish: {line}")
    return line


FRONT_CADENCE_S = 0.5  # the fleet_front collector's --fleet-cadence-s
FRONT_PROBE_S = 0.25  # its router's --probe-interval-s
FRONT_THRESHOLD = 128  # the router's classify threshold: the reference's default
FRONT_PREFIX = 256  # tokens of P's prefix that the prefix fetch moves (16 pages)
FRONT_FRESH = 32  # fresh tokens after that prefix
FRONT_NEW = 16  # new tokens of the phase's single requests (drill, Q, after the restart, drain)


class Front:
    """The fleet_front phase's one ``python -m relora_tpu_torch.serve.supervisor``
    process under ``work/front``: three replicas of ``FLEET_ARGS`` (``r0``
    prefill, ``r1`` decode, ``r2`` mixed; ``serve_migrate`` armed once on
    ``r0``'s first incarnation), its router on an ephemeral port (the port
    file ``router.port`` beside the replicas' port and pid files), and the
    collector every FRONT_CADENCE_S.  The replicas share one ``--run-dir``;
    each record carries its replica's ``_source``.  The router and the
    replicas write their spans under ``traces/`` (``RELORA_TPU_TRACE_DIR``),
    the collector its series to ``fleet_series.jsonl``: fleet_tools' input."""

    def __init__(self, work):
        self.dir = os.path.join(work, "front")
        shutil.rmtree(self.dir, ignore_errors=True)
        os.makedirs(self.dir)
        self.run_dir = os.path.join(self.dir, "run")
        self.port_file = os.path.join(self.dir, "router.port")
        self.trace_dir = os.path.join(self.dir, "traces")
        env = {k: v for k, v in os.environ.items() if k != "RELORA_TPU_FAULTS"}
        env["RELORA_TPU_TRACE_DIR"] = self.trace_dir
        self.log_path = os.path.join(self.dir, "supervisor.log")
        self.log = open(self.log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "relora_tpu_torch.serve.supervisor", "--replicas", "3",
             "--prefill-replicas", "1", "--decode-replicas", "1", "--workdir", self.dir,
             "--router-port", "0", "--probe-interval-s", str(FRONT_PROBE_S),
             "--fleet-cadence-s", str(FRONT_CADENCE_S), "--backoff-base-s", "0.5",
             "--drain-timeout-s", str(SERVER_WAIT),
             "--replica-env", "0:RELORA_TPU_FAULTS=serve_migrate:times=1,exc=runtimeerror",
             "--", sys.executable, "-m", "relora_tpu_torch.serve_cli", *FLEET_ARGS,
             "--run-dir", self.run_dir],
            cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=self.log)
        self.port = None
        self.launches = {}

    def _alive(self):
        if self.proc.poll() is not None:
            with open(self.log_path) as f:
                raise AssertionError(f"fleet_front: the supervisor exited {self.proc.returncode}:"
                                     f"\n{f.read()[-3000:]}")

    def ready(self):
        """The router's port, then its ``/healthz`` with three healthy
        replicas whose roles it has read."""
        def bound():
            self._alive()
            return os.path.exists(self.port_file) and open(self.port_file).read().strip()

        self.port = int(wait_state(bound, "the front router's port file"))

        def routable():
            self._alive()
            h = self.router_health()
            return h["healthy_replicas"] == 3 and h

        wait_state(routable, "three routable supervised replicas")
        return self

    def router_health(self):
        return json.loads(http_call(self.port, "GET", "/healthz")[2])

    def replica_port(self, i):
        with open(os.path.join(self.dir, f"replica_{i}.port")) as f:
            return int(f.read())

    def pid(self, i):
        with open(os.path.join(self.dir, f"replica_{i}.pid")) as f:
            return int(f.read())

    def health(self, i):
        return json.loads(http_call(self.replica_port(i), "GET", "/healthz")[2])

    def metrics(self, port):
        from relora_tpu_torch.obs.fleet import parse_prometheus

        return parse_prometheus(http_call(port, "GET", "/metrics")[2].decode())

    def get(self, path):
        status, _, body = http_call(self.port, "GET", path)
        return status, json.loads(body) if body.startswith(b"{") else body.decode()

    def stop(self, check=True):
        """SIGTERM the supervisor (its rolling drain, one replica at a time)
        and wait, then kill anything left; without ``check`` (a phase
        failed) the supervisor's log tail goes to stderr.  Returns
        its exit code and each replica's kernel launches after its warmup,
        summed over its incarnations (``_source`` of the ``kernel_launches``
        events in the shared run directory).  Without ``check`` it kills
        the supervisor and the replicas at once."""
        code = None
        if check and self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                code = self.proc.wait(SERVER_WAIT)
            except subprocess.TimeoutExpired:
                pass
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(SERVER_WAIT)
        for i in range(3):
            try:
                os.kill(self.pid(i), signal.SIGKILL)  # a replica left behind
            except (OSError, ValueError):
                pass
        self.log.close()
        if not check:
            with open(self.log_path) as f:
                print("--- fleet_front supervisor log (tail):\n" + "".join(f.readlines()[-60:]),
                      file=sys.stderr)
        by_source = {}
        path = os.path.join(self.run_dir, "metrics.jsonl")
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    try:
                        r = json.loads(line)
                    except json.JSONDecodeError:
                        continue  # a line torn by the drill's kill -9
                    if r.get("_event") != "kernel_launches":
                        continue
                    counts = by_source.setdefault(r["_source"], {})
                    for k, v in r.items():
                        if not k.startswith(("_", "warmup/")):
                            counts[k] = counts.get(k, 0) + v
        self.launches = by_source
        return code, by_source


def front_prompts(prompts):
    """P (a seeded 512-token prompt, in none of the drains) and the two
    prefix-fetch requests: FRONT_PREFIX tokens of P then FRONT_FRESH tokens
    of their own."""
    import numpy as np

    vocab = fleet_config().vocab_size
    rng = np.random.default_rng(20)
    p = rng.integers(2, vocab, 512).tolist()
    q = [p[:FRONT_PREFIX] + rng.integers(2, vocab, FRONT_FRESH).tolist() for _ in range(2)]
    return p, q


def fleet_front(front, prompts_path, inproc):
    """Phase fleet_front, part one, over the supervised fleet and before
    fleet_disagg times its drain.  (1) The drill: prompt 0 (FRONT_NEW new
    tokens) through the router goes to ``r0`` (prefill), whose armed
    ``serve_migrate`` fails the handoff once: decoded at home,
    token-identical.  Then the routed drain:
    the 16 prompts (64 new tokens) through the router, timed; each stream
    must equal the in-process int8 drain, land on ``r0`` (prompts of
    FRONT_THRESHOLD tokens and more, then migrated to ``r1``) or ``r1``, as
    the router's ``routed_*`` counters and the receivers' inserts say (a
    run goes to ``r2``, mixed, when ``r1``'s slots are full).  (2)
    The prefix fetch: P through the router to ``r0`` with one new token
    (it finishes there, cached); once the directory (``/fleet/prefix``)
    names a holder, Q (P's first FRONT_PREFIX tokens, then FRONT_FRESH
    fresh ones; FRONT_NEW new tokens) straight to ``r2``, which never saw
    P: it fetches the 16 pages from the holder and prefills the tail.
    Returns the phase's state for :func:`fleet_front_finish`."""
    import types

    from relora_tpu_torch.serve.paging import PrefixCache

    prompts = read_prompts(prompts_path)
    ref = inproc["int8"]["tokens"]
    vocab = fleet_config().vocab_size
    steps, t0 = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        steps[name], t0[0] = now - t0[0], now

    drill = types.SimpleNamespace(**client_batch(front.port, [{"prompt": prompts[0],
                                                               "max_new_tokens": FRONT_NEW}])[0])
    check_stream("fleet_front drill", drill, vocab)
    drill_failures = front.health(0)["paging"]["disagg"]["migration_failures"]
    def inserted():  # the runs each receiver adopted: the decode replica, else mixed
        return {f"r{i}": front.health(i)["paging"]["disagg"]["migrated_inserts"] for i in (1, 2)}

    inserts0 = inserted()
    lap("drill")
    t_drain = time.perf_counter()
    clients = [types.SimpleNamespace(**c)
               for c in client_batch(front.port, [{"prompt": p} for p in prompts])]
    drain_s = time.perf_counter() - t_drain
    lap("routed_drain")
    for c in clients:
        check_stream("fleet_front", c, vocab)
    flat, _ = front.metrics(front.port)
    long = [len(p) >= FRONT_THRESHOLD for p in prompts]
    routed = [c.headers.get("x-relora-replica") for c in clients]
    inserts = wait_state(lambda: sum((n := {k: v - inserts0[k] for k, v in inserted().items()})
                                     .values()) >= sum(long) and n, "the routed drain's inserts")
    state = {
        "steps": steps, "prompts": prompts, "ref": ref, "drain_s": drain_s,
        "inproc_tokens_per_s": inproc["int8"]["tokens_per_s"],
        "stats": latency_stats(clients),
        "diverged": [{"request": i, "index": first_divergence(c.tokens, ref[i])}
                     for i, c in enumerate(clients) if c.tokens != ref[i]],
        "drill_identical": drill.tokens == ref[0][:FRONT_NEW], "drill_replica":
            drill.headers.get("x-relora-replica"), "drill_failures": drill_failures,
        "routed": routed, "routed_wrong": [i for i, (r, lg) in enumerate(zip(routed, long))
                                           if r != ("r0" if lg else "r1")],
        "routed_prefill_total": flat["relora_router_routed_prefill_total"],
        "routed_decode_total": flat["relora_router_routed_decode_total"],
        "long": sum(long), "migrated_inserts": inserts,
        "migration_failures_after": front.health(0)["paging"]["disagg"]["migration_failures"],
    }

    # the prefix fetch: P cached on r0 (one new token: it finishes there), Q
    # to r2
    p, (q, q2) = front_prompts(prompts)
    state["p"], state["q"], state["q2"] = p, q, q2
    check_stream("fleet_front P", types.SimpleNamespace(
        **client_batch(front.port, [{"prompt": p, "max_new_tokens": 1}])[0]), vocab)
    digest = PrefixCache._digest(p[:FRONT_PREFIX]).hex()
    state["digest"] = digest
    status, holder = wait_state(
        lambda: (a := front.get(f"/fleet/prefix?d={digest}&exclude=r2"))[0] == 200 and a,
        "the directory's holder of P's prefix")
    port2 = front.replica_port(2)
    before = front.health(2)
    before_flat, before_h = front.metrics(port2)
    lap("prefix_donor")
    t_q = time.perf_counter()
    fetched = types.SimpleNamespace(**client_batch(port2, [{"prompt": q,
                                                            "max_new_tokens": FRONT_NEW}])[0])
    q_s = time.perf_counter() - t_q
    lap("prefix_fetch")
    check_stream("fleet_front Q", fetched, vocab)
    after = front.health(2)
    after_flat, after_h = front.metrics(port2)
    exports = {i: front.metrics(front.replica_port(i))[0].get(
        "relora_serve_http_requests_total.prefix", 0.0) for i in (0, 1)}
    seconds = (after_h["relora_serve_prefix_fetch_seconds"]["sum"]
               - before_h.get("relora_serve_prefix_fetch_seconds", {"sum": 0.0})["sum"])
    cfg = fleet_config()
    from relora_tpu_torch.serve import wire

    n_pages = FRONT_PREFIX // PAGE
    reckoned = len(wire.encode_page_run(
        {"digest": digest, "n_tokens": FRONT_PREFIX, "n_pages": n_pages, "weights_version": 0},
        run_entries(cfg, n_pages, PAGE)))
    state["prefix"] = {
        "holder": holder, "receiver": "r2", "tokens": fetched.tokens, "request_s": q_s,
        "fetch_seconds": seconds,
        "fetches": after["paging"]["disagg"]["prefix_fetches"]
        - before["paging"]["disagg"]["prefix_fetches"],
        "failures": after["paging"]["disagg"]["prefix_fetch_failures"]
        - before["paging"]["disagg"]["prefix_fetch_failures"],
        "pages": n_pages, "bytes": after["paging"]["disagg"]["migration_bytes"]
        - before["paging"]["disagg"]["migration_bytes"], "bytes_reckoned": reckoned,
        "prefix_hits": after["paging"]["prefix_cache"]["hits"]
        - before["paging"]["prefix_cache"]["hits"],
        "exports": {f"r{i}": v for i, v in exports.items()},
        "prefix_fetch_total": after_flat["relora_serve_prefix_fetch_total"]
        - before_flat["relora_serve_prefix_fetch_total"],
    }
    return state


def fleet_front_crash(front, state):
    """Phase fleet_front, part two, just before the f32 slot: the crash
    drill.  Four short-prompt streams go through the router to the decode
    pool (``r1``) and run; four more are sent, and once ``r1`` holds all
    eight, ``kill -9`` of its pid file's process.  The restart and its
    warmup then run beside the phases that time nothing; every client must
    have ended by then (checked in :func:`fleet_front_finish`)."""
    short = [i for i, p in enumerate(state["prompts"]) if len(p) < FRONT_THRESHOLD]
    order = (short * 2)[:8]
    first = [Client(front.port, {"prompt": state["prompts"][i]}) for i in order[:4]]
    for c in first:
        c.start()
    wait_state(lambda: all(c.tokens or not c.is_alive() for c in first), "the first streams")
    second = [Client(front.port, {"prompt": state["prompts"][i]}) for i in order[4:]]
    for c in second:
        c.start()
    wait_state(lambda: (h := front.health(1))["active_slots"] + h["queue_depth"] >= 8
               or not any(c.is_alive() for c in second), "eight streams on r1", timeout=30.0)
    pid = front.pid(1)
    os.kill(pid, signal.SIGKILL)
    state["crash"] = {"t_kill": time.time(), "pid": pid, "clients": first + second,
                      "order": order}


def fleet_front_reference(prompts_path, state):
    """The in-process int8 drain of the prefix fetch's Q (timing-free: it
    runs in the f32 slot)."""
    from relora_tpu_torch import serve_cli

    path = os.path.join(os.path.dirname(prompts_path), "front_q.txt")
    with open(path, "w") as f:
        f.write(" ".join(map(str, state["q"])) + "\n")
    completions, _ = serve_cli.run(FLEET_ARGS + ["--input-file", path, "--max-new-tokens",
                                                 str(FRONT_NEW)])
    state["q_ref"] = completions[0].tokens


def fleet_front_finish(front, state, paths, disagg_line):
    """Phase fleet_front, the rest: (3) the crash drill's verdict: no
    client hung; each stream ended with ``[DONE]`` token-identical to the
    in-process drain (retried on ``r2`` when it had no byte yet) or with a
    typed ``stream_interrupted`` event and no ``[DONE]`` after a prefix of
    its tokens; none lost; ``r1`` restarted and routable again (seconds
    from the kill to the collector's first ``/healthz`` ok of it), and a
    request routed to it again.  (4) The collector: ``/fleet/series``
    holds each replica's TTFT p95, queue depth and slot gauges, the
    router's own series, the restart and ``r1``'s health flips as events,
    the SLO status; ``/fleet/prefix`` answers the fetch's digest.  The
    weights-version guard: the restarted ``r1`` reloads ``model_1``
    (``/admin/reload``), then a second Q straight to it must refuse the
    holder's version-0 run (one fetch failure) and still finish.  (5) The
    rolling drain: four requests in flight, SIGTERM to the supervisor: each
    finishes, the supervisor exits 0, and the replicas' ``kernel_launches``
    events are read.  Prints the ``fleet_front`` line and returns the
    launches summed over the replicas."""
    import types

    from relora_tpu_torch.obs.fleet import parse_prometheus

    ref, prompts = state["ref"], state["prompts"]
    vocab = fleet_config().vocab_size
    steps, t0 = state["steps"], [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        steps[name], t0[0] = now - t0[0], now

    crash = state["crash"]
    for c in crash["clients"]:
        c.join(SERVER_WAIT)
    hung = sum(c.is_alive() for c in crash["clients"])
    done, interrupted, lost, off = 0, 0, 0, []
    for c, i in zip(crash["clients"], crash["order"]):
        err = (c.final or {}).get("error") if isinstance((c.final or {}).get("error"), dict) else None
        if c.done and c.tokens == ref[i]:
            done += 1
        elif not c.done and err is not None and err.get("type") == "stream_interrupted" \
                and c.tokens == ref[i][:len(c.tokens)]:
            interrupted += 1
        else:
            lost += 1
            off.append({"request": i, "done": c.done, "final": c.final, "error": c.error,
                        "tokens": len(c.tokens)})
    wait_state(lambda: front.router_health()["replicas"]["r1"]["healthy"], "r1 routable again")
    again = types.SimpleNamespace(**client_batch(front.port, [{"prompt": prompts[crash["order"][0]],
                                                               "max_new_tokens": FRONT_NEW}])[0])
    flat, _ = front.metrics(front.port)
    router = front.router_health()
    lap("crash_verdict")

    # the collector and the SLO engine
    _, series = front.get("/fleet/series?last=4")
    names = {src: sorted(v) for src, v in series["sources"].items()}
    events = [(e["_event"], e["_source"]) for e in series["events"]]
    # the restart's seconds: the kill to the collector's first scrape of r1's
    # /healthz ok after it (a scrape every FRONT_CADENCE_S)
    back = [e["_time"] for e in series["events"] if e["_event"] == "health_flip"
            and e["_source"] == "r1" and e.get("to") == "ok" and e["_time"] > crash["t_kill"]]
    kill_to_routable = back[0] - crash["t_kill"] if back else None
    _, fleet_metrics = front.get("/fleet/metrics")
    fleet_flat, _ = parse_prometheus(fleet_metrics)
    prefix_status, prefix_answer = front.get(f"/fleet/prefix?d={state['digest']}")
    lap("collector")

    # the weights-version guard on the card: the restarted r1 (no prefix of
    # P) on model_1, the directory's holder of P's prefix on version 0
    port1 = front.replica_port(1)
    status, _, body = http_call(port1, "POST", "/admin/reload", {"checkpoint": paths[1]})
    before = front.health(1)["paging"]["disagg"]
    guarded = types.SimpleNamespace(**client_batch(port1, [{"prompt": state["q2"],
                                                            "max_new_tokens": 1}])[0])
    check_stream("fleet_front version guard", guarded, vocab)
    after = front.health(1)
    version = {"reload_status": status, "weights_version": after["weights_version"],
               "fetch_failures": after["paging"]["disagg"]["prefix_fetch_failures"]
               - before["prefix_fetch_failures"],
               "fetches": after["paging"]["disagg"]["prefix_fetches"] - before["prefix_fetches"]}
    lap("version_guard")

    # the rolling drain under SIGTERM
    inflight = [Client(front.port, {"prompt": prompts[i], "max_new_tokens": FRONT_NEW})
                for i in (crash["order"][0], 1, 2, crash["order"][1])]
    for c in inflight:
        c.start()
    wait_state(lambda: any(c.tokens for c in inflight) or not any(c.is_alive() for c in inflight),
               "requests in flight")
    code, launches = front.stop()
    for c in inflight:
        c.join(SERVER_WAIT)
    drain_lost = sum(not (c.done and c.final and c.final.get("finish_reason") in ("length", "eos"))
                     for c in inflight)
    lap("rolling_drain")

    pre = state["prefix"]
    line = {
        "fleet_front": "supervisor: r0 prefill, r1 decode, r2 mixed; router, collector",
        "requests": len(prompts), **state["stats"], "drain_s": state["drain_s"],
        "fleet_disagg_tokens_per_s": disagg_line["tokens_per_s"],
        "fleet_disagg_ttft_p50_s": disagg_line["ttft_p50_s"],
        "fleet_disagg_tpot_p50_s": disagg_line["tpot_p50_s"],
        "inproc_tokens_per_s": state["inproc_tokens_per_s"],
        "identical_to_inproc": len(prompts) - len(state["diverged"]),
        "divergences": state["diverged"], "drill_identical": state["drill_identical"],
        "drill_replica": state["drill_replica"], "drill_failures": state["drill_failures"],
        "routed_prefill_total": state["routed_prefill_total"],
        "routed_decode_total": state["routed_decode_total"], "long_prompts": state["long"],
        "routed_wrong": state["routed_wrong"], "migrated_inserts": state["migrated_inserts"],
        "migration_failures_after_drain": state["migration_failures_after"],
        "prefix_fetch": {**{k: v for k, v in pre.items() if k != "tokens"},
                         "identical": pre["tokens"] == state["q_ref"],
                         "directory_answer": prefix_answer if prefix_status == 200 else None},
        "crash": {"streams": len(crash["clients"]), "hung": hung, "done_identical": done,
                  "interrupted": interrupted, "lost": lost, "off": off,
                  "kill_to_routable_s": kill_to_routable,
                  "again_replica": again.headers.get("x-relora-replica"),
                  "again_identical": again.tokens == ref[crash["order"][0]][:FRONT_NEW],
                  "failovers": {k: v for k, v in flat.items() if "failovers_total" in k},
                  "midstream_errors": {k: v for k, v in flat.items() if "midstream" in k},
                  "retries_total": flat.get("relora_router_retries_total", 0.0),
                  "breaker_r1": router["replicas"]["r1"]["circuit"]},
        "series": names,
        "events": sorted(set(events)),
        "slo": {"objectives": len(series["slo"]["objectives"]),
                "active": [a["slo"] + "/" + a["source"] for a in series["slo"]["active"]],
                "history": len(series["slo"]["history"]),
                "scrape_rounds": fleet_flat.get("relora_fleet_scrape_rounds_total"),
                "alerts_firing": fleet_flat.get("relora_fleet_alerts_firing")},
        "version_guard": version,
        "drain": {"requests": len(inflight), "lost": drain_lost, "supervisor_exit": code},
        "launches": launches, "step_seconds": steps,
    }
    print(json.dumps(line))
    if line["identical_to_inproc"] != len(prompts) or not line["drill_identical"]:
        raise AssertionError(f"fleet_front: routed streams differ from the in-process drain: "
                             f"{line}")
    if (line["routed_wrong"] or line["drill_replica"] != "r0" or line["drill_failures"] != 1
            or line["migration_failures_after_drain"] != 1
            or line["routed_prefill_total"] != state["long"] + 1  # the drill's too
            or line["routed_decode_total"] != len(prompts) - state["long"]
            or sum(line["migrated_inserts"].values()) != state["long"]):
        raise AssertionError(f"fleet_front: routing off the classification: {line}")
    if (pre["fetches"] != 1 or pre["failures"] != 0 or pre["prefix_fetch_total"] != 1
            or pre["bytes"] != pre["bytes_reckoned"] or pre["prefix_hits"] != 1
            or not line["prefix_fetch"]["identical"] or sum(pre["exports"].values()) != 1):
        raise AssertionError(f"fleet_front: the prefix fetch is off: {line}")
    crash_line = line["crash"]
    if (hung or lost or done + interrupted != len(crash["clients"])
            or crash_line["again_replica"] != "r1" or not crash_line["again_identical"]
            or (interrupted and not any(k.endswith(".r1") for k in crash_line["midstream_errors"]))):
        raise AssertionError(f"fleet_front: the crash drill lost or hung a request: {line}")
    if ("supervisor_respawn", "r1") not in events or kill_to_routable is None:
        raise AssertionError(f"fleet_front: the collector missed the restart: {line}")
    for src in ("r0", "r1", "r2"):
        want = {"healthz_queue_depth", "healthz_active_slots", "healthz_max_batch", "up"}
        if not want <= set(names.get(src, ())):
            raise AssertionError(f"fleet_front: {src}'s series are missing: {names}")
    if not any("relora_serve_ttft_seconds_p95" in names.get(s, ()) for s in ("r0", "r1", "r2")) \
            or not any(n.startswith("relora_router_") for n in names.get("router", ())):
        raise AssertionError(f"fleet_front: the TTFT or router series are missing: {names}")
    if not line["slo"]["objectives"] or line["slo"]["scrape_rounds"] is None \
            or line["slo"]["alerts_firing"] is None or prefix_status != 200:
        raise AssertionError(f"fleet_front: the SLO engine or /fleet/prefix did not answer: {line}")
    if (version["reload_status"] != 200 or version["weights_version"] != 1
            or version["fetch_failures"] != 1 or version["fetches"] != 0):
        raise AssertionError(f"fleet_front: a run of another weights version was not refused: "
                             f"{line}")
    if code != 0 or drain_lost:
        raise AssertionError(f"fleet_front: the rolling drain lost a request or failed: {line}")
    total = {}
    for counts in launches.values():
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    if not total.get("paged_decode_attention") and "--device" not in FLEET_ARGS:
        # (a CPU rehearsal's replicas run the plain twins)
        raise AssertionError(f"fleet_front: no supervised replica launched kernel 1: {launches}")
    return total



def server_tenants(torch, base_ckpt, tenants, prompts_path):
    """Phase server (c): tenant traffic through the server over ``--no-merge
    --adapter-dir`` (``--adapters tA,tB`` preloaded after the warmup; tC
    loaded on demand): the first TENANT_HEAD prompts, 32 new tokens, naming
    [base, tA, tB, tC] round-robin; kernel 5 launched 7 x layers in every forward; an
    unknown adapter answers 400.  Returns kernel 5's launches."""
    from relora_tpu_torch.ops import lora_matmul as LM

    prompts = read_prompts(prompts_path)[:TENANT_HEAD]
    mix = [None] + list(TENANT_ALPHAS)
    argv = ["--model_config", "llama_250m", "--checkpoint", base_ckpt, "--no-merge", "--adapter-dir",
            tenants, "--adapters", "tA,tB", "--paged", "--dtype", "bf16", "--max-batch", "8",
            "--max-new-tokens", "32"]
    LM.grouped_lora_matmul.launches = 0
    with EngineCalls("_forward") as forwards, InProcessServer(argv) as srv:
        wait_state(lambda: srv.health()[1]["status"] == "ok", "/healthz ok")
        with client_pool() as pool:
            clients = run_clients(pool, srv.server.port, [
                {"prompt": p, "adapter": mix[i % len(mix)]} for i, p in enumerate(prompts)])
        stats = latency_stats(clients)
        unknown = http_call(srv.server.port, "POST", "/v1/generate",
                            {"prompt": prompts[0][:8], "adapter": "nope"})
        registry = srv.scheduler.adapter_stats()
    launches = LM.grouped_lora_matmul.launches
    layers = srv.scheduler.engine.config.num_hidden_layers
    line = {"server_drain": "tenants", "requests": len(clients), "adapters": mix, **stats,
            "warmup_s": srv.warmup_s, "unknown_adapter_status": unknown[0],
            "loads": registry["loads_total"], "forwards": forwards.calls,
            "launches": {"grouped_lora_matmul": launches}}
    print(json.dumps(line))
    for c in clients:
        check_stream("tenants", c, srv.scheduler.engine.config.vocab_size)
    if unknown[0] != 400 or b"unknown adapter" not in unknown[2]:
        raise AssertionError(f"server tenants: an unknown adapter answered {unknown[0]}")
    if forwards.calls == 0 or launches != 7 * layers * forwards.calls:
        raise AssertionError(f"server tenants: kernel 5 launched {launches} times over "
                             f"{forwards.calls} forwards, expected 7 x {layers} per forward")
    del srv
    torch.cuda.empty_cache()
    return launches


# the reference's default serving mode: the server phase's flags without --paged
CONTIGUOUS_ARGS = [a for a in SERVER_ARGS if a != "--paged"]


def contiguous_drain(torch, prompts_path, paged):
    """Phase contiguous: ``serve_cli`` without ``--paged`` (the contiguous
    cache, prefill-on-admission; merged bf16 llama_250m, ``cache_size``
    1024, 8 slots) drains the 16 prompts, then the first PROFILED_CLIENTS
    (one batch) again under the profiler for the device idle share and the
    prefill stall share (the prefill and insert seconds over those plus the
    decode rounds').  Prints tokens/s beside the paged
    sequential drain's and the count of streams identical to it (``paged``:
    its label -> tokens and tokens/s; reported, not gated: kernel 1 and the
    f32 plain attention round differently in bf16).  Fails unless every
    completion is well formed and in the vocabulary, every request
    prefilled once, the profiled drain's tokens equal the timed drain's
    (for its requests), and
    kernels 1 and 2 never launched (the contiguous cache attends in plain
    PyTorch, as the reference's does in ``jnp``).  Returns uid -> tokens and
    tokens/s, the yardstick of the generate and server phases."""
    from relora_tpu_torch import serve_cli
    from relora_tpu_torch.ops import attention as A
    from relora_tpu_torch.serve.admission import ServeMetrics

    t0 = time.perf_counter()
    argv = CONTIGUOUS_ARGS + ["--input-file", prompts_path]
    A.paged_decode_attention.launches = A.packed_paged_attention.launches = 0
    with EngineCalls("prefill") as prefills, EngineCalls("decode") as decodes:
        completions, seconds, sched = serve_cli.drain(argv)
    tokens = {uid: c.tokens for uid, c in completions.items()}
    vocab = sched.engine.config.vocab_size
    del sched
    torch.cuda.empty_cache()
    args = serve_cli.parse_args(argv)
    sched = serve_cli.build(args)
    sched.obs_registry = ServeMetrics()  # the prefill, insert and decode_step histograms
    again, wall, busy, _ = device_profile(
        torch, lambda: sched.run(serve_cli.read_requests(args)[:PROFILED_CLIENTS]))
    phases = sched.obs_registry.snapshot()
    admit_s = phases["prefill_seconds_sum"] + phases["insert_seconds_sum"]
    del sched
    torch.cuda.empty_cache()
    n = sum(len(t) for t in tokens.values())
    ref = paged["bf16"]
    line = {"drain": "contiguous", "requests": len(tokens), "tokens": n, "seconds": seconds,
            "tokens_per_s": n / seconds, "paged_tokens_per_s": ref["tokens_per_s"],
            "identical_to_paged": sum(tokens[u] == ref["tokens"][u] for u in ref["tokens"]),
            "prefills": prefills.calls, "decode_rounds": decodes.calls,
            "profiled": {"device_idle_share": 1.0 - busy / wall, "profiled_wall_s": wall,
                         "device_busy_s": busy, "prefill_insert_s": admit_s,
                         "prefill_stall_share": admit_s / (admit_s + phases[
                             "decode_step_seconds_sum"])},
            "paged_kernel_launches": A.paged_decode_attention.launches
            + A.packed_paged_attention.launches,
            "wall_s": time.perf_counter() - t0}
    print(json.dumps(line))
    if len(tokens) != 16 or not all(1 <= len(t) <= 64 for t in tokens.values()):
        raise AssertionError("drain contiguous: malformed completions")
    if not all(0 <= tok < vocab for t in tokens.values() for tok in t):
        raise AssertionError("drain contiguous: token id out of the vocabulary")
    if prefills.calls != 16 or decodes.calls == 0 or line["paged_kernel_launches"]:
        raise AssertionError(f"drain contiguous: {prefills.calls} prefills, {decodes.calls} "
                             f"decode rounds, {line['paged_kernel_launches']} paged launches")
    if {u: c.tokens for u, c in again.items()} != {u: tokens[u] for u in again}:
        raise AssertionError("drain contiguous: the profiled drain's tokens differ")
    return {"tokens": tokens, "tokens_per_s": n / seconds}


def prefill_arms(buckets, shapes=LORA_SHAPES):
    """``choose_grouped_arm``'s pick at each projection of ``shapes`` (one
    layer's, default llama_250m's) in a batch-1 prefill of each bucket (r =
    128, 4 slots, bf16: the call ``lora_matmul_grouped`` makes on the card,
    which counts min(slots, M) adapters although a batch-1 prefill's rows
    all use one)."""
    from relora_tpu_torch.ops.lora_dispatch import choose_grouped_arm

    return {T: [choose_grouped_arm(T, K, N, ADAPTER_R, min(ADAPTER_SLOTS, T), 2, 2,
                                   grouped_available=True) for K, N, _ in shapes]
            for T in buckets}


CONTIGUOUS_TENANT_NEW = 32  # contiguous_tenants' new tokens a request


def contiguous_tenants(torch, device, prompts_path, base, tenants, model_config="llama_250m",
                       shapes=LORA_SHAPES, label="contiguous_tenants"):
    """Phase contiguous_tenants: the adapter phase's base and tenants through
    ``ContinuousBatchingScheduler(adapter_registry=)`` on the contiguous
    engine of ``model_config`` (4 slots, requests naming [base, tA, tB, tC]
    round-robin, CONTIGUOUS_TENANT_NEW new tokens).  Prints tokens/s,
    kernel 5's launches in decode rounds and in prefills, and the arm
    ``choose_grouped_arm`` takes at each prompt bucket 16-512 over
    ``shapes`` (one layer's projections, as counted per layer).  Fails
    unless kernel 5 launched in every projection of every layer of every
    decode round, each prefill launched it where its bucket's pick is the
    kernel and nowhere else, and nothing else launched it.  Returns (decode
    launches, prefill launches)."""
    from relora_tpu_torch.config.model import load_model_config
    from relora_tpu_torch.ops import lora_matmul as LM
    from relora_tpu_torch.serve.adapters import AdapterRegistry
    from relora_tpu_torch.serve.engine import bucket_length
    from relora_tpu_torch.serve.scheduler import ContinuousBatchingScheduler

    t0 = time.perf_counter()
    cfg = load_model_config(model_config)
    layers, per_layer = cfg.num_hidden_layers, sum(count for _, _, count in shapes)
    prompts = read_prompts(prompts_path)
    mix = [None] + list(TENANT_ALPHAS)
    engine = tenant_engine(torch, base, ADAPTER_SLOTS, device, paged=False, model_config=model_config)
    registry = AdapterRegistry(tenants, ADAPTER_SLOTS, expected_r=ADAPTER_R,
                               writer=engine.adapter_writer())
    sched = ContinuousBatchingScheduler(engine, max_batch=BATCH, eos_id=engine.config.eos_token_id,
                                        seed=0, adapter_registry=registry)
    grouped = {"grouped_lora_matmul": LM.grouped_lora_matmul}
    LM.grouped_lora_matmul.launches = 0
    with EngineCalls("decode", grouped) as decodes, EngineCalls("prefill", grouped) as prefills:
        t1 = time.perf_counter()
        completions = sched.run(tenant_requests(prompts, mix, max_new=CONTIGUOUS_TENANT_NEW))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t1
    total = LM.grouped_lora_matmul.launches
    arms = prefill_arms((16, 32, 64, 128, 256, 512), shapes)
    per_prompt = [layers * sum(count for (_, _, count), arm in zip(shapes, arms[bucket_length(len(p))])
                               if arm == "grouped") for p in prompts]
    decode_launches = decodes.launches["grouped_lora_matmul"]
    prefill_launches = prefills.launches["grouped_lora_matmul"]
    tokens = [c.tokens for c in completions.values()]
    n = sum(len(t) for t in tokens)
    print(json.dumps({"drain": label, "requests": len(tokens), "adapters": mix,
                      "tokens": n, "seconds": seconds, "tokens_per_s": n / seconds,
                      "decode_rounds": decodes.calls, "prefills": prefills.calls,
                      "launches": {"decode": decode_launches, "prefill": prefill_launches},
                      "prefill_arms": {str(T): a for T, a in arms.items()},
                      "prefill_buckets": sorted({bucket_length(len(p)) for p in prompts}),
                      "loads": registry.stats()["loads_total"], "wall_s": time.perf_counter() - t0}))
    del sched, engine, registry
    torch.cuda.empty_cache()
    if len(tokens) != len(prompts) or not all(1 <= len(t) <= CONTIGUOUS_TENANT_NEW for t in tokens):
        raise AssertionError(f"drain {label}: malformed completions")
    if not all(0 <= tok < cfg.vocab_size for t in tokens for tok in t):
        raise AssertionError(f"drain {label}: token id out of the vocabulary")
    if decodes.calls == 0 or decode_launches != per_layer * layers * decodes.calls:
        raise AssertionError(f"{label}: kernel 5 launched {decode_launches} times in "
                             f"{decodes.calls} decode rounds, expected {per_layer} x {layers} a round")
    if prefills.calls != len(prompts) or prefill_launches != sum(per_prompt):
        raise AssertionError(f"{label}: kernel 5 launched {prefill_launches} times in "
                             f"{prefills.calls} prefills, expected {sum(per_prompt)}")
    if total != decode_launches + prefill_launches:
        raise AssertionError(f"{label}: {total} kernel 5 launches, "
                             f"{decode_launches + prefill_launches} in decode and prefill")
    return decode_launches, prefill_launches


def generate_phase(torch, prompts_path, contiguous):
    """Phase generate: ``serve_cli --prompt`` x 8 (the first 8 drain prompts,
    64 new tokens) without ``--paged``, the one-shot mode through
    ``InferenceEngine.generate`` (every prompt padded to one bucket, one
    batch-8 prefill, then decode steps).  Prints tokens/s and the count of
    outputs identical to the contiguous drain's (reported: the batch-8
    prefill rounds otherwise in bf16).  Fails unless 8 well-formed outputs
    of in-vocabulary ids came back."""
    from relora_tpu_torch import serve_cli

    t0 = time.perf_counter()
    prompts = read_prompts(prompts_path)[:8]
    argv = CONTIGUOUS_ARGS + [a for p in prompts for a in ("--prompt", " ".join(map(str, p)))]
    outs, seconds, engine = serve_cli.one_shot(argv)
    vocab = engine.config.vocab_size
    del engine
    torch.cuda.empty_cache()
    n = sum(len(t) for t in outs)
    print(json.dumps({"drain": "generate", "prompts": len(outs), "tokens": n, "seconds": seconds,
                      "tokens_per_s": n / seconds,
                      "identical_to_contiguous": sum(o == contiguous["tokens"][i]
                                                     for i, o in enumerate(outs)),
                      "wall_s": time.perf_counter() - t0}))
    if len(outs) != 8 or not all(1 <= len(t) <= 64 for t in outs):
        raise AssertionError("generate: malformed outputs")
    if not all(0 <= tok < vocab for t in outs for tok in t):
        raise AssertionError("generate: token id out of the vocabulary")


def contiguous_server(torch, prompts_path, contiguous):
    """Phase contiguous_server: ``serve_cli --port 0`` without ``--paged``,
    the 16 prompts from 16 concurrent SSE clients after the warmup.  Prints
    TTFT p50/p99, TPOT p50, tokens/s beside the in-process contiguous
    drain's and the warmup's seconds.  Fails unless the warmup ran every
    prompt bucket (16-1024), the insert and the decode, ``/healthz`` carries
    no ``paging`` block and ``/metrics`` the round's gauges but no page
    series, and every stream is token-identical to the in-process drain's
    (decode always runs 8 rows, prefill 1: a request's tokens do not depend
    on its neighbours)."""
    t0 = time.perf_counter()
    payloads = [{"prompt": p} for p in read_prompts(prompts_path)]
    with client_pool() as pool, InProcessServer(CONTIGUOUS_ARGS) as srv:
        wait_state(lambda: srv.health()[1]["status"] == "ok", "/healthz ok")
        clients = run_clients(pool, srv.server.port, payloads)
        stats = latency_stats(clients)
        _, body = srv.health()
        text = http_call(srv.server.port, "GET", "/metrics")[2].decode()
        buckets = list(srv.scheduler.engine.default_prompt_buckets())
        vocab = srv.scheduler.engine.config.vocab_size
    report, warmup_s = srv.server.warmup_report, srv.warmup_s
    del srv
    torch.cuda.empty_cache()
    diverged = [uid for uid, c in enumerate(clients) if c.tokens != contiguous["tokens"][uid]]
    print(json.dumps({"server_drain": "contiguous", "requests": len(clients), **stats,
                      "inproc_tokens_per_s": contiguous["tokens_per_s"], "warmup_s": warmup_s,
                      "warmup": report, "prompt_buckets": buckets,
                      "identical_to_inproc": not diverged, "divergences": diverged,
                      "wall_s": time.perf_counter() - t0}))
    for c in clients:
        check_stream("contiguous", c, vocab)
    if report != {"batch": BATCH, "n_compiles": len(buckets) + 2}:
        raise AssertionError(f"server contiguous: the warmup ran {report}, expected "
                             f"{len(buckets)} prefill buckets, the insert and the decode")
    if "paging" in body or "relora_serve_kv_pages_used" in text:
        raise AssertionError("server contiguous: page-pool series on a contiguous server")
    for gauge in ("batch_fill", "prefill_stall_share", "active_slots", "queue_depth"):
        if f"relora_serve_{gauge} " not in text:
            raise AssertionError(f"server contiguous: /metrics lacks {gauge}")
    if diverged:
        raise AssertionError(f"server contiguous: requests {diverged} differ from the in-process drain")


def f32_contiguous(torch, device):
    """Phase f32_contiguous: a 2-layer llama_250m at f32 (TF32 off) on one
    engine with a page pool, the contiguous path against the paged one:
    the prefill logits of 8 prompts (32-512 tokens; batch-1 ``prefill``
    against 64-token ``prefill_chunk`` calls) and one decode step over the 8
    rows (``decode`` on the inserted cache against ``decode_paged``, kernel
    1) within 2e-3; then the 16 prompts (32 new tokens) drained by
    ``ContinuousBatchingScheduler`` and ``PagedContinuousBatchingScheduler``,
    ``generate`` over the first 8 against the paged drain's tokens, and a
    tenant drain (a slotted model, seeded factors in three slots, requests
    naming [base, tA, tB, tC] round-robin) through both schedulers, each
    token-identical."""
    import numpy as np

    from relora_tpu_torch.core.relora import LoraSpec, full_f32_matmul, kaiming_uniform
    from relora_tpu_torch.models.family import causal_lm_class
    from relora_tpu_torch.serve.adapters import AdapterRegistry, extract_lora_factors
    from relora_tpu_torch.serve.engine import InferenceEngine, bucket_length, build_decode_model
    from relora_tpu_torch.serve.scheduler import (
        ContinuousBatchingScheduler,
        PagedContinuousBatchingScheduler,
        Request,
    )

    t0 = time.perf_counter()
    cfg, _ = two_layer("llama_250m")
    C = cfg.max_sequence_length
    W = C // PAGE
    gen = torch.Generator(device=device).manual_seed(5)
    model = seeded_init(torch, build_decode_model(cfg, device=device), gen)
    engine = InferenceEngine(cfg, model, cache_size=C, page_size=PAGE, num_pages=BATCH * W + 1,
                             chunk_size=64, device=device)
    rng = np.random.default_rng(6)
    lengths = rng.integers(32, 513, BATCH)
    prompts = [rng.integers(2, cfg.vocab_size, L).tolist() for L in lengths]
    tables = (np.arange(BATCH * W).reshape(BATCH, W) + 1).astype(np.int32)
    lines = {}
    with full_f32_matmul():
        pool, cache = engine.init_pool(), engine.init_cache(BATCH)
        err_prefill = 0.0
        for row, prompt in enumerate(prompts):
            L = len(prompt)
            chunks = []
            for start in range(0, L, 64):
                ids = np.zeros((1, 64), np.int32)
                part = prompt[start : start + 64]
                ids[0, : len(part)] = part
                logits, pool = engine.prefill_chunk(ids, start, pool, tables[row : row + 1])
                chunks.append(logits[0, : len(part)])
            ids = np.zeros((1, bucket_length(L)), np.int32)
            ids[0, :L] = prompt
            logits, pcache = engine.prefill(ids)
            engine.insert(cache, pcache, row)
            err_prefill = max(err_prefill, (logits[0, :L] - torch.cat(chunks)).abs().max().item())
        token = rng.integers(2, cfg.vocab_size, (BATCH, 1)).astype(np.int32)
        contig, _ = engine.decode(cache, token, lengths[:, None])
        paged, _ = engine.decode_paged(pool, token, lengths[:, None], tables)
        err_decode = (contig - paged).abs().max().item()
        del pool, cache, pcache
        torch.cuda.synchronize()
        for name, err in (("prefill", err_prefill), ("decode", err_decode)):
            ok = math.isfinite(err) and err <= LOGIT_TOL
            print(f"f32-contiguous {name} max_abs_err={err:.3e} tol={LOGIT_TOL:g} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"f32-contiguous {name}: contiguous and paged logits disagree")

        drain_prompts = read_prompts(os.path.join(REPO, "build", "chip_smoke", "prompts.txt"))

        def both_drains(engine, registry=None, names=(None,)):
            out = []
            for cls in (ContinuousBatchingScheduler, PagedContinuousBatchingScheduler):
                sched = cls(engine, max_batch=BATCH, eos_id=cfg.eos_token_id, seed=0,
                            adapter_registry=registry)
                done = sched.run([Request(uid=i, prompt=p, max_new_tokens=32,
                                          adapter=names[i % len(names)])
                                  for i, p in enumerate(drain_prompts)])
                out.append({u: c.tokens for u, c in done.items()})
            return out

        contiguous_tokens, paged_tokens = both_drains(engine)
        generated = engine.generate(drain_prompts[:8], max_new_tokens=32, eos_id=cfg.eos_token_id)
        lines["drain"] = [u for u in paged_tokens if contiguous_tokens[u] != paged_tokens[u]]
        lines["generate"] = [i for i, g in enumerate(generated) if g != paged_tokens[i]]
        del engine, model
        torch.cuda.empty_cache()

        spec = LoraSpec(r=ADAPTER_R, alpha=32.0)
        with torch.device(device):
            lora_model = causal_lm_class(cfg)(cfg, lora=spec)
        seeded_init(torch, lora_model, gen)
        engine = InferenceEngine(cfg, lora_model.state_dict(), cache_size=C, page_size=PAGE,
                                 num_pages=BATCH * W + 1, chunk_size=64, device=device, lora=spec,
                                 adapter_slots=ADAPTER_SLOTS)
        registry = AdapterRegistry(None, ADAPTER_SLOTS, writer=engine.adapter_writer())
        for name, alpha in TENANT_ALPHAS.items():
            factors = {key: kaiming_uniform(p.shape, gen, device) if key.endswith("lora_a")
                       else torch.randn(p.shape, generator=gen, device=device) * 0.05
                       for key, p in extract_lora_factors(lora_model.state_dict()).items()}
            registry.preload(name, factors, alpha / ADAPTER_R)
        del lora_model
        contiguous_tenants_tokens, paged_tenants_tokens = both_drains(
            engine, registry, [None] + list(TENANT_ALPHAS))
        lines["tenants"] = [u for u in paged_tenants_tokens
                            if contiguous_tenants_tokens[u] != paged_tenants_tokens[u]]
        del engine, registry
        torch.cuda.empty_cache()
    print(json.dumps({"f32_contiguous": "token-identical to the paged path",
                      "divergences": lines, "wall_s": time.perf_counter() - t0}))
    for name, diverged in lines.items():
        if diverged:
            raise AssertionError(f"f32-contiguous {name}: requests {diverged} differ from the paged path")


# the memory levers (an nf4 base, the chunked loss, the remat policies)
CHUNKED_LOSS_TOL = 2e-3  # chunked@pythia_1b's losses against pythia_train's, bf16
REMAT_LOSS_TOL = 1e-5  # remat@pythia_1b's losses against pythia_train's
# dots_all and dots_narrow are left to the CPU tests (tests/test_torch_memory_levers.py:
# gradients bit-equal to no remat, recomputed matmuls counted): on the flash
# path dots_all saves what dots saves, and dots_narrow sits between full and dots
REMAT_POLICIES = ("full", "dots")
NF4_ARGS = ["--quantize", "nf4"]
NF4_SERVE_NEW = 16  # nf4_serve's new tokens a request
NF4_SERVE_PROMPTS = 8  # nf4_serve drains the first 8 prompts (one batch)


def nf4_param_bytes(model_name, r):
    """The parameter bytes of ``model_name`` with LoRA of rank ``r`` on every
    projection over an nf4 base with double quant, reckoned from the config
    alone: per projection ``(K, N)`` the codes ``K/2 x N``, int8 block scales
    ``K/block x N`` and two f32 scales ``(1, N)``, the factors, a NeoX bias
    in f32; the embeddings, head and norms in f32."""
    from relora_tpu_torch.config.model import load_model_config
    from relora_tpu_torch.ops.quant import nf4_block_for

    cfg = load_model_config(model_name)
    h, i, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    neox = cfg.family == "neox"
    if neox:
        shapes = [(h, 3 * h), (h, h), (h, i), (i, h)]
    else:
        q, kv = cfg.num_attention_heads * cfg.head_dim, cfg.kv_heads * cfg.head_dim
        shapes = [(h, q), (h, kv), (h, kv), (q, h), (h, i), (h, i), (i, h)]
    layer = sum(K // 2 * N + K // nf4_block_for(K) * N + 8 * N + 4 * r * (K + N) + (4 * N if neox else 0)
                for K, N in shapes)
    norms = 2 * h * 4 * (2 if neox else 1)  # two norms a layer, NeoX's with biases
    return cfg.num_hidden_layers * (layer + norms) + 2 * v * h * 4 + h * 4 * (2 if neox else 1)


def memory_line(label, line, beside):
    """Prints ``label``'s HBM peaks and memory plan beside the lines of
    ``beside`` (``{label: train line}``)."""
    def gib(x):
        return None if x is None else x / 2**30

    out = {"memory": label}
    for name, ln in {label: line, **beside}.items():
        t = ln["telemetry"]
        out[name] = {"peak_gib": ln["peak_gib"], "trainer_hbm_peak_gib": gib(t["hbm_peak_bytes"]),
                     "plan_gib": gib(t["plan_total_bytes"]), "ms_per_update": ln["ms_per_update"],
                     "mfu": t["mfu"]}
    print(json.dumps(out))


def nf4_serve(torch, prompts, checkpoint):
    """Phase nf4_serve: nf4_train's checkpoint drained by ``serve_cli
    --paged`` over the first NF4_SERVE_PROMPTS prompts merged (``merged_params`` dequantizes the
    base and adds the delta), then ``--no-merge`` (the nf4 LoRALinear on the
    plain path: no projection asks the cost model); kernel 1 in both.  The
    first forward's logits of the two within NOMERGE_LOGIT_TOL; tokens/s of
    both and the count of identical streams printed.  Returns kernel 1's
    launches."""
    from relora_tpu_torch import serve_cli
    from relora_tpu_torch.ops import attention as A

    common = ["--model_config", "llama_250m", "--dtype", "bf16", "--max-batch", "8", "--paged",
              "--max-new-tokens", str(NF4_SERVE_NEW), "--input-file",
              head_prompts(prompts, NF4_SERVE_PROMPTS, "nf4_prompts.txt"), "--checkpoint", checkpoint]
    first = read_prompts(prompts)[0]
    out, launches = {}, 0
    for label, extra in (("merged", []), ("nomerge", ["--no-merge"])):
        A.paged_decode_attention.launches = 0
        with ArmWatch() as arms:
            completions, seconds, sched = serve_cli.drain(common + extra)
        projections = [m for m in sched.engine.model.modules() if getattr(m, "lora", None) is not None]
        logits = first_forward_logits(torch, sched.engine, first)
        del sched
        torch.cuda.empty_cache()
        tokens = [completions[u].tokens for u in sorted(completions)]
        n = sum(len(t) for t in tokens)
        out[label] = {"tokens": tokens, "logits": logits, "tokens_per_s": n / seconds,
                      "launches": A.paged_decode_attention.launches,
                      "nf4_projections": sum(getattr(m, "quantize", None) == "nf4" for m in projections),
                      "cost_model_calls": sum(arms.calls.values())}
        launches += A.paged_decode_attention.launches
        if len(tokens) != NF4_SERVE_PROMPTS or not all(0 <= tok < 32100 for t in tokens for tok in t):
            raise AssertionError(f"nf4_serve {label}: malformed completions")
    want = out["merged"]["logits"]
    err = (out["nomerge"]["logits"] - want).abs().max().item() / max(1.0, want.abs().max().item())
    same = sum(a == b for a, b in zip(out["merged"]["tokens"], out["nomerge"]["tokens"]))
    line = {"nf4_serve": "llama_250m", "checkpoint": os.path.basename(checkpoint),
            "merged_tokens_per_s": out["merged"]["tokens_per_s"],
            "nomerge_tokens_per_s": out["nomerge"]["tokens_per_s"],
            "identical_streams": same, "first_logits_rel_err": err, "tol": NOMERGE_LOGIT_TOL,
            **{f"{k}_{lbl}": out[lbl][k] for lbl in out
               for k in ("launches", "nf4_projections", "cost_model_calls")}}
    print(json.dumps(line))
    if not err <= NOMERGE_LOGIT_TOL:
        raise AssertionError(f"nf4_serve: unmerged first forward {err:.3e} off the merged one")
    if out["nomerge"]["nf4_projections"] != 7 * 24 or out["nomerge"]["cost_model_calls"]:
        raise AssertionError(f"nf4_serve: {line}: every unmerged projection must be nf4 and none "
                             "may reach the cost model")
    if not (out["merged"]["launches"] and out["nomerge"]["launches"]):
        raise AssertionError("nf4_serve: a drain never launched kernel 1")
    return launches


def nf4_pythia(torch, corpus, warm, beside, pythia_args):
    """Phase nf4_train@pythia_1b: the pythia train phase (``pythia_args``)
    over an nf4 base warm-started from ``warm``; its memory plan's
    parameter bytes must equal :func:`nf4_param_bytes`, its peaks printed
    beside ``beside``'s."""
    launches, line = train(torch, corpus, f"nf4_train@{PYTHIA}", NF4_ARGS + ["--warmed_up_model", warm],
                           base_args=pythia_args)
    want = nf4_param_bytes(pythia_args[pythia_args.index("--model_config") + 1], LORA_R)
    got = line["telemetry"]["plan_params_bytes"]
    memory_line(f"nf4_train@{PYTHIA}", line, beside)
    print(json.dumps({"nf4_plan": PYTHIA, "params_bytes": got, "reckoned": want,
                      "plan_total_gib": line["telemetry"]["plan_total_bytes"] / 2**30}))
    if got != want:
        raise AssertionError(f"nf4_train@{PYTHIA}: memory_plan holds {got} parameter bytes, the "
                             f"nf4 reckoning {want}")
    return launches


def check_losses(label, line, ref, tol):
    """Every update's loss of ``line`` within ``tol`` of ``ref``'s; prints
    the worst difference and whether they are bit-equal."""
    diffs = [abs(a - b) for a, b in zip(line["losses"], ref["losses"])]
    worst = max(diffs)
    print(json.dumps({"losses": label, "worst_abs_diff": worst, "tol": tol,
                      "bit_equal": line["losses"] == ref["losses"],
                      "ms_per_update": line["ms_per_update"], "ref_ms_per_update": ref["ms_per_update"],
                      "peak_gib": line["peak_gib"], "ref_peak_gib": ref["peak_gib"]}))
    if len(diffs) != TRAIN_UPDATES or not worst <= tol:
        raise AssertionError(f"{label}: losses {worst:.3e} off pythia_train's, beyond {tol}")


def memory_levers(torch, work, pythia_train_line, pythia_args):
    """Phases chunked@pythia_1b and remat@pythia_1b: pythia_train's run with
    ``--loss_impl chunked`` (8192-row chunks: 7 of the 50304 rows), then
    with ``--remat true`` under each of REMAT_POLICIES.  Each update's loss
    against pythia_train's (chunked within CHUNKED_LOSS_TOL, remat within
    REMAT_LOSS_TOL); the chunked peak below pythia_train's, the remat peaks
    ordered full < dots (each policy saves more).  Returns
    the runs' kernel launches."""
    corpus = write_corpus(work, seq_length=2048)
    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    launches, line = train(torch, corpus, f"chunked@{PYTHIA}",
                           ["--loss_impl", "chunked", "--vocab_chunk", "8192"],
                           base_args=pythia_args)
    add(launches)
    check_losses(f"chunked@{PYTHIA}", line, pythia_train_line, CHUNKED_LOSS_TOL)
    if not line["peak_gib"] < pythia_train_line["peak_gib"]:
        raise AssertionError(f"chunked@{PYTHIA}: peak {line['peak_gib']:.3f} GiB, not below "
                             f"pythia_train's {pythia_train_line['peak_gib']:.3f}")
    torch.cuda.empty_cache()
    peaks = {}
    for policy in REMAT_POLICIES:
        launches, line = train(torch, corpus, f"remat_{policy}@{PYTHIA}",
                               ["--remat", "true", "--remat_policy", policy],
                               base_args=pythia_args)
        add(launches)
        check_losses(f"remat_{policy}@{PYTHIA}", line, pythia_train_line, REMAT_LOSS_TOL)
        peaks[policy] = line["peak_gib"]
        torch.cuda.empty_cache()
    print(json.dumps({"remat_peaks_gib": peaks, "no_remat_peak_gib": pythia_train_line["peak_gib"]}))
    if not peaks["full"] < peaks["dots"]:
        raise AssertionError(f"remat@{PYTHIA}: peaks {peaks} not ordered full < dots: "
                             "a policy whose peak does not rise saved nothing")
    return total


# f32-nf4: llama_1b cut to 2 layers, an update on the card against the CPU
F32_NF4_BATCH = (2, 2, 256)  # (grad_accum, microbatch, seq): the CPU reference's size


def f32_nf4(torch, device, pythia_warm):
    """Phase f32-nf4: llama_1b cut to 2 layers over an nf4 base (its 5461-wide
    down_proj stores int8: the fallback) at f32 with TF32 off, warm-started
    from seeded weights with B drawn nonzero: one update on the card with
    ``--lora_fused true`` (down_proj through kernels 4-int8, 6-int8, 7, the
    nf4 projections plain) and unfused (down_proj through kernel 8), each
    against the same update on the CPU (loss and layer-0 gradients, as
    f32-train).  Then quantize_nf4 of pythia_1b's warm-start weights (its
    first and last layers) on the card against the CPU: codes equal apart from ties (a
    value at a midpoint within an ulp), bscale_q within one step.  Returns
    the kernels' launches on the card."""
    import numpy as np

    from relora_tpu_torch.core import optim, relora
    from relora_tpu_torch.models.llama import LlamaForCausalLM
    from relora_tpu_torch.models.params_util import init_params
    from relora_tpu_torch.models.warm_start import graft_base_weights
    from relora_tpu_torch.train.step import TrainState, make_train_step

    cfg, _ = two_layer("llama_1b")
    rng = np.random.default_rng(13)
    batch = (rng.zipf(1.2, F32_NF4_BATCH) - 1) % cfg.vocab_size
    dense = LlamaForCausalLM(cfg)
    init_params(dense, torch.Generator().manual_seed(17))
    source = {f"model.{k}": v for k, v in dense.state_dict().items()}
    del dense
    state_dict = None
    counters = _counters()
    out, grads, launches = {}, {}, {}
    with relora.full_f32_matmul():
        for arm, dev in (("cpu", torch.device("cpu")), ("fused", device), ("unfused", device)):
            spec = relora.LoraSpec(r=128, alpha=32.0, dropout=0.0, quantize="nf4",
                                   fused=arm == "fused")
            model = LlamaForCausalLM(cfg, dtype=torch.float32, attention_arm="auto", lora=spec)
            if state_dict is None:
                gen = torch.Generator().manual_seed(3)
                init_params(model, gen)
                graft_base_weights(model, source)
                with torch.no_grad():
                    for name, p in model.named_parameters():
                        if name.endswith("lora_b"):
                            p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
                state_dict = {k: v.clone() for k, v in model.state_dict().items()}
            model.load_state_dict(state_dict)
            model.to(dev)
            relora.set_trainable(model)
            down = model.layers[0].mlp.down_proj
            if not (down.quantize == "int8" and model.layers[0].mlp.up_proj.quantize == "nf4"):
                raise AssertionError("f32-nf4: the 5461-wide down_proj must store int8, the rest nf4")
            tokens = torch.as_tensor(batch, device=dev)
            before = {n: c.launches for n, c in counters.items()}
            grads[arm] = layer0_grads(torch, model, tokens)
            opt = optim.build_optimizer(p for p in model.parameters() if p.requires_grad)
            step = make_train_step(model, opt, clip_grad_norm=1.0, schedule=lambda s: 1e-3)
            out[arm] = step(TrainState(), tokens)
            launches[arm] = {n: c.launches - before[n] for n, c in counters.items()}
            del model, opt
            torch.cuda.empty_cache()
    layers = cfg.num_hidden_layers
    want = {"fused": {"fused_lora_int8_forward": 2 * 2 * layers, "fused_lora_int8_bwd_dx": 2 * 2 * layers,
                      "fused_lora_bwd_dab": 2 * 2 * layers},
            "unfused": {"dequant_matmul": 2 * 2 * layers}}  # two passes (grads, step) x 2 micro
    for arm in ("fused", "unfused"):
        check_grads(f"f32-nf4 {arm}", grads[arm], {n: g.to(device) for n, g in grads["cpu"].items()})
        for key in ("loss", "grad_norm"):
            err = abs(out[arm][key] - out["cpu"][key]) / abs(out["cpu"][key])
            ok = err <= F32_TRAIN_TOL[key]
            print(f"f32-nf4 {arm} {key} card={out[arm][key]} cpu={out['cpu'][key]} rel_err={err:.3e} "
                  f"tol={F32_TRAIN_TOL[key]:g} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"f32-nf4 {arm}: {key} off the CPU's by {err:.3e}")
        ran = {n: v for n, v in launches[arm].items() if v and not n.startswith("flash")}
        print(json.dumps({"f32-nf4 launches": arm, **ran}))
        if ran != want[arm] or launches[arm]["flash_attention_bwd_dq"] == 0:
            raise AssertionError(f"f32-nf4 {arm}: launches {ran}, expected {want[arm]} and flash")
    check_nf4_quantize(torch, device, pythia_warm)
    return {n: launches["fused"][n] + launches["unfused"][n] for n in counters if not n.startswith("flash")}


def check_nf4_quantize(torch, device, pythia_warm):
    """``quantize_nf4`` of pythia_1b's warm-start weights (its first and last
    layers) on the card against the CPU: codes equal apart from ties (a value at a
    midpoint within an ulp, counted), ``bscale_q`` within one step (the
    per-column mean reduces in another order)."""
    from relora_tpu_torch.ops.quant import NF4_MIDPOINTS, quantize_nf4

    src = torch.load(os.path.join(pythia_warm, "pytorch_model.bin"), map_location="cpu", weights_only=True)
    mids = torch.as_tensor(NF4_MIDPOINTS)
    stats = {"weights": 0, "codes": 0, "code_mismatches": 0, "ties": 0, "bscale_q_off": 0,
             "bscale_q_max_step": 0}
    last = max(int(k.split(".")[2]) for k in src if k.startswith("gpt_neox.layers."))
    for key, w in src.items():
        if not key.startswith(("gpt_neox.layers.0.", f"gpt_neox.layers.{last}.")) or not key.endswith(
                "weight") or w.ndim != 2:
            continue
        wt = w.float().t()
        cpu = quantize_nf4(wt)
        card = {k: v.cpu() for k, v in quantize_nf4(wt.to(device)).items()}
        K = wt.shape[0]
        idx_cpu = torch.stack([cpu["codes"] & 15, cpu["codes"] >> 4], 1).reshape(K, -1)
        idx_card = torch.stack([card["codes"] & 15, card["codes"] >> 4], 1).reshape(K, -1)
        off = idx_cpu != idx_card
        if off.any():
            block = K // cpu["bscale_q"].shape[0]
            absmax = wt.abs().reshape(-1, block, wt.shape[1]).amax(1).repeat_interleave(block, 0)
            x = (wt / absmax)[off]
            ulp = torch.finfo(torch.float32).eps * x.abs().clamp(min=1e-30)
            stats["ties"] += int(((x[:, None] - mids).abs().min(dim=1).values <= ulp).sum())
        step = (cpu["bscale_q"].int() - card["bscale_q"].int()).abs()
        stats["weights"] += 1
        stats["codes"] += idx_cpu.numel()
        stats["code_mismatches"] += int(off.sum())
        stats["bscale_q_off"] += int((step != 0).sum())
        stats["bscale_q_max_step"] = max(stats["bscale_q_max_step"], int(step.max()))
    print(json.dumps({"f32-nf4 quantize card vs cpu": PYTHIA, **stats}))
    if (stats["weights"] != 8 or stats["code_mismatches"] != stats["ties"]
            or stats["bscale_q_max_step"] > 1):
        raise AssertionError(f"f32-nf4: quantize_nf4 on the card against the CPU: {stats}")


# -- pythia_1b through every serving path: the pythia_serving group -----------------

PYTHIA_SPEC_NEW = 32  # the pythia spec drains' and server's new tokens a request


def pythia_tenants(torch, prompts_path, ckpts, model_config):
    """Group pythia_serving, part 1: ``serve_cli --checkpoint BASE --no-merge
    --adapter-dir D --packed`` (4 slots; ``ckpts``: base, adapter dir,
    draft) builds the pythia engine and its registry; a sequential and a
    packed scheduler over them drain the first TENANT_HEAD prompts at
    TENANT_NEW new tokens, round-robin over [base, tA, tB, tC].  Each drain
    fails unless kernel 5 launched once a projection and layer (4 x layers)
    in every forward, kernel 1 (kernel 2 when packed) launched, and every
    id is in the vocabulary; then :func:`tenant_probes`.  Returns the
    kernels' launches over the two drains."""
    from relora_tpu_torch import serve_cli
    from relora_tpu_torch.ops import attention as A
    from relora_tpu_torch.ops import lora_matmul as LM

    base, tenants, _ = ckpts
    sched = serve_cli.build(serve_cli.parse_args([
        "--model_config", model_config, "--checkpoint", base, "--no-merge", "--adapter-dir", tenants,
        "--paged", "--packed", "--dtype", "bf16", "--max-batch", str(BATCH)]))
    engine, registry = sched.engine, sched.adapter_registry
    del sched
    cfg = engine.config
    per_forward = sum(count for _, _, count in PYTHIA_LORA_SHAPES) * cfg.num_hidden_layers
    prompts = read_prompts(prompts_path)
    mix = [None] + list(TENANT_ALPHAS)
    requests = tenant_requests(prompts[:TENANT_HEAD], mix, max_new=TENANT_NEW)
    wrappers = {"paged_decode_attention": A.paged_decode_attention,
                "packed_paged_attention": A.packed_paged_attention,
                "grouped_lora_matmul": LM.grouped_lora_matmul}
    total = dict.fromkeys(wrappers, 0)
    for packed, kernel in ((False, "paged_decode_attention"), (True, "packed_paged_attention")):
        label = "pythia_tenants_packed" if packed else "pythia_tenants"
        for w in wrappers.values():
            w.launches = 0
        with EngineCalls("_forward") as forwards:
            completions, seconds, _ = tenant_drain(torch, engine, registry, requests, packed)
        launches = {k: w.launches for k, w in wrappers.items()}
        tokens = [c.tokens for c in completions.values()]
        n = sum(len(t) for t in tokens)
        print(json.dumps({"drain": label, "model": PYTHIA, "requests": len(tokens), "tokens": n,
                          "seconds": seconds, "tokens_per_s": n / seconds, "adapters": mix,
                          "forwards": forwards.calls, "launches": launches}))
        if len(tokens) != TENANT_HEAD or not all(1 <= len(t) <= TENANT_NEW for t in tokens):
            raise AssertionError(f"drain {label}: malformed completions")
        if not all(0 <= tok < cfg.vocab_size for t in tokens for tok in t):
            raise AssertionError(f"drain {label}: token id out of the vocabulary")
        if forwards.calls == 0 or launches["grouped_lora_matmul"] != per_forward * forwards.calls:
            raise AssertionError(f"drain {label}: kernel 5 launched {launches['grouped_lora_matmul']}"
                                 f" times over {forwards.calls} forwards, expected {per_forward} "
                                 f"per forward")
        if launches[kernel] == 0:
            raise AssertionError(f"drain {label}: {kernel} never launched")
        for k in total:
            total[k] += launches[k]
    tenant_probes(torch, engine, registry, prompts, "pythia_tenants")
    del engine, registry
    torch.cuda.empty_cache()
    return total


def pythia_contiguous(torch, device, prompts_path, ckpts, model_config, paged):
    """Group pythia_serving, part 2: ``serve_cli`` without ``--paged`` (the
    contiguous cache, prefill-on-admission; ``--random-init`` as the pythia
    drains) over the same PYTHIA_PROMPTS prompts, 64 new tokens, its streams
    counted against the paged bf16 pythia drain's (``paged``: uid ->
    tokens; reported, not gated: kernel 1 and the plain f32 attention round
    differently in bf16); fails unless every completion is well formed and
    in the vocabulary, every request prefilled once and kernels 1 and 2
    never launched.  Then :func:`contiguous_tenants` over part 1's base and
    tenants at pythia_1b's projections.  Returns (kernel 5's decode
    launches, its prefill launches)."""
    from relora_tpu_torch import serve_cli
    from relora_tpu_torch.ops import attention as A

    A.paged_decode_attention.launches = A.packed_paged_attention.launches = 0
    with EngineCalls("prefill") as prefills, EngineCalls("decode") as decodes:
        completions, seconds, sched = serve_cli.drain([
            "--model_config", model_config, "--random-init", "--dtype", "bf16", "--max-batch",
            str(BATCH), "--max-new-tokens", "64", "--input-file", prompts_path])
    vocab = sched.engine.config.vocab_size
    del sched
    torch.cuda.empty_cache()
    tokens = {uid: c.tokens for uid, c in completions.items()}
    n = sum(len(t) for t in tokens.values())
    paged_launches = A.paged_decode_attention.launches + A.packed_paged_attention.launches
    print(json.dumps({"drain": "pythia_contiguous", "model": PYTHIA, "requests": len(tokens),
                      "tokens": n, "seconds": seconds, "tokens_per_s": n / seconds,
                      "identical_to_paged": sum(tokens[u] == paged[u] for u in paged),
                      "prefills": prefills.calls, "decode_rounds": decodes.calls,
                      "paged_kernel_launches": paged_launches}))
    if len(tokens) != PYTHIA_PROMPTS or not all(1 <= len(t) <= 64 for t in tokens.values()):
        raise AssertionError("drain pythia_contiguous: malformed completions")
    if not all(0 <= tok < vocab for t in tokens.values() for tok in t):
        raise AssertionError("drain pythia_contiguous: token id out of the vocabulary")
    if prefills.calls != PYTHIA_PROMPTS or decodes.calls == 0 or paged_launches:
        raise AssertionError(f"drain pythia_contiguous: {prefills.calls} prefills, {decodes.calls} "
                             f"decode rounds, {paged_launches} paged launches")
    return contiguous_tenants(torch, device, prompts_path, ckpts[0], ckpts[1], model_config,
                              PYTHIA_LORA_SHAPES, label="pythia_contiguous_tenants")


def pythia_spec(torch, repeat_path, ckpts, model_config):
    """Group pythia_serving, part 3: ``serve_cli --spec-k 4`` drains of the
    first SPEC_HEAD_PROMPTS repeat prompts at PYTHIA_SPEC_NEW new tokens:
    ``--spec ngram`` sequential and ``--packed`` (``--random-init``), and
    ``--spec model`` over part 1's base served merged with its NeoX draft
    (:func:`pythia_draft`'s: the base pruned by magnitude at
    DRAFT_SPARSITY).  Each is checked by
    :func:`spec_line`, and fails unless kernel 1 (``verify_paged``) or
    kernel 2 (``step_paged``, packed) launched once a layer in every call;
    the model drafter's acceptance must lie strictly between 0 and 1.
    Returns (kernels 1 and 2's launches, their launches at the window
    shape)."""
    from relora_tpu_torch import serve_cli
    from relora_tpu_torch.ops import attention as A

    head = head_prompts(repeat_path, SPEC_HEAD_PROMPTS, "pythia_repeat_prompts.txt")
    common = ["--dtype", "bf16", "--max-batch", str(BATCH), "--paged", "--max-new-tokens",
              str(PYTHIA_SPEC_NEW), "--spec-k", str(SPEC_K), "--input-file", head]
    rnd = ["--model_config", model_config, "--random-init"] + common
    launches = {"paged_decode_attention": 0, "packed_paged_attention": 0}
    window = dict(launches)
    for label, argv, method in (
        ("pythia_spec_ngram", rnd + ["--spec", "ngram"], "verify_paged"),
        ("pythia_spec_ngram_packed", rnd + ["--spec", "ngram", "--packed"], "step_paged"),
        ("pythia_spec_model", ["--model_config", model_config, "--checkpoint", ckpts[0]] + common
         + ["--spec", "model", "--draft-checkpoint", ckpts[2]], "verify_paged"),
    ):
        A.paged_decode_attention.launches = A.packed_paged_attention.launches = 0
        with EngineCalls(method) as calls:
            completions, seconds, sched = serve_cli.drain(argv)
        counts = {k: getattr(A, k).launches for k in launches}
        kernel = "packed_paged_attention" if method == "step_paged" else "paged_decode_attention"
        layers = sched.engine.config.num_hidden_layers
        if calls.calls == 0 or calls.launches[kernel] != layers * calls.calls:
            raise AssertionError(f"drain {label}: {calls.launches[kernel]} {kernel} launches in "
                                 f"{calls.calls} {method} calls, expected {layers} a call")
        stats = sched.spec_stats()
        win = layers * stats["verify_rounds"] if method == "step_paged" else calls.launches[kernel]
        spec_line(label, completions, seconds, sched, win, counts, None, SPEC_HEAD_PROMPTS)
        if label == "pythia_spec_model" and not 0 < stats["accepted"] < stats["drafted"]:
            raise AssertionError(f"drain {label}: the draft's acceptance must lie strictly "
                                 f"between 0 and 1, got {stats}")
        for k in launches:
            launches[k] += counts[k]
        window[kernel] += win
        del sched
        torch.cuda.empty_cache()
    return launches, window


def pythia_server(torch, repeat_path, ckpts, model_config):
    """Group pythia_serving, part 4: one in-process ``serve_cli --port``
    server over part 1's base with ``--no-merge --adapter-dir --adapters
    tA,tB --spec ngram``: 8 concurrent SSE clients (the first 8 repeat
    prompts, PYTHIA_SPEC_NEW new tokens) round-robin over [base, tA, tB,
    tC], every other one with ``"spec": false``, all queued while the model
    thread is held after its warmup and released together, so the first
    round admits all eight in the server's uid order.  Prints TTFT p50
    (from the release) and TPOT p50; fails unless every stream is well
    formed and token-identical to the in-process drain of the same requests
    in that order (a scheduler built from the same flags: the same rounds,
    so the same GEMM shapes), a verify round ran, and kernels 5 and 1
    launched.  Returns the kernels' launches (server and in-process drain)
    and kernel 1's at the window shape."""
    from relora_tpu_torch import serve_cli
    from relora_tpu_torch.ops import attention as A
    from relora_tpu_torch.ops import lora_matmul as LM
    from relora_tpu_torch.serve.scheduler import Request

    base, tenants, _ = ckpts
    argv = ["--model_config", model_config, "--checkpoint", base, "--no-merge", "--adapter-dir",
            tenants, "--adapters", "tA,tB", "--paged", "--dtype", "bf16", "--max-batch", str(BATCH),
            "--max-new-tokens", str(PYTHIA_SPEC_NEW), "--spec", "ngram", "--spec-k", str(SPEC_K)]
    mix = [None] + list(TENANT_ALPHAS)
    payloads = [{"prompt": p, "adapter": mix[i % len(mix)], "spec": i % 2 == 0}
                for i, p in enumerate(read_prompts(repeat_path)[:TENANT_HEAD])]
    wrappers = {"paged_decode_attention": A.paged_decode_attention,
                "grouped_lora_matmul": LM.grouped_lora_matmul}
    for w in wrappers.values():
        w.launches = 0
    import types

    with EngineCalls("verify_paged") as verifies, InProcessServer(argv, held=True) as srv:
        if not srv.warm.wait(SERVER_WAIT):
            raise AssertionError("server pythia: the warmup did not finish")
        with client_pool() as pool:
            pending = pool.apply_async(client_batch, (srv.server.port, payloads))
            wait_state(lambda: srv.server.admission.depth() == len(payloads), "8 queued requests")
            released = time.perf_counter()
            srv.hold.set()
            clients = [types.SimpleNamespace(**r) for r in pending.get(SERVER_WAIT)]
        for c in clients:  # TTFT from the release: the queue's wait is the hold's
            c.t_send = max(c.t_send, released)
        stats = latency_stats(clients)
        spec = srv.scheduler.spec_stats()
        vocab = srv.scheduler.engine.config.vocab_size
    served = {k: w.launches for k, w in wrappers.items()}
    warmup_s = srv.warmup_s
    del srv
    torch.cuda.empty_cache()
    for c in clients:
        check_stream("pythia", c, vocab)
    order = sorted(range(len(clients)), key=lambda i: clients[i].final["uid"])
    for w in wrappers.values():
        w.launches = 0
    with EngineCalls("verify_paged") as inproc_verifies:
        sched = serve_cli.build(serve_cli.parse_args(argv))
        done = sched.run([Request(uid=clients[i].final["uid"], prompt=payloads[i]["prompt"],
                                  max_new_tokens=PYTHIA_SPEC_NEW, adapter=payloads[i]["adapter"],
                                  spec=payloads[i]["spec"]) for i in order])
    del sched
    torch.cuda.empty_cache()
    diverged = [i for i, c in enumerate(clients) if c.tokens != done[c.final["uid"]].tokens]
    print(json.dumps({"server_drain": "pythia_tenants_spec", "model": PYTHIA,
                      "requests": len(clients), "adapters": mix, **stats, "warmup_s": warmup_s,
                      "verify_rounds": spec["verify_rounds"], "accepted": spec["accepted"],
                      "identical_to_inproc": not diverged, "divergences": diverged,
                      "launches": served}))
    if diverged:
        raise AssertionError(f"server pythia: requests {diverged} differ from the in-process drain")
    if spec["verify_rounds"] == 0 or not all(served.values()):
        raise AssertionError(f"server pythia: {spec['verify_rounds']} verify rounds, launches {served}")
    launches = {k: served[k] + w.launches for k, w in wrappers.items()}
    return launches, (verifies.launches["paged_decode_attention"]
                      + inproc_verifies.launches["paged_decode_attention"])


class RestoreOnce:
    """While entered, ``train/checkpoint.py``'s ``verify_checkpoint`` and
    ``restore_params_host`` (and ``serve_cli``'s names for them) answer each
    directory with the first call's result, the params as a new dict of the
    same CPU tensors (every caller copies them to the card): pythia_serving's
    five engines over one 1.7 GB f32 base, and the prune group's tools and
    checks over one checkpoint, each go through the serving path's restore,
    and each directory is read and verified from disk once."""

    NAMES = ("verify_checkpoint", "restore_params_host")

    def __enter__(self):
        from relora_tpu_torch import serve_cli
        from relora_tpu_torch.train import checkpoint as ckpt

        self.saved = []
        for name in self.NAMES:
            real, memo = getattr(ckpt, name), {}

            def once(path, _real=real, _memo=memo):
                if path not in _memo:
                    _memo[path] = _real(path)
                value = _memo[path]
                return dict(value) if isinstance(value, dict) else value

            for module in (ckpt, serve_cli):
                self.saved.append((module, name, getattr(module, name)))
                setattr(module, name, once)
        return self

    def __exit__(self, *exc):
        for module, name, fn in reversed(self.saved):
            setattr(module, name, fn)


def pythia_serving(torch, device, prompts_path, repeat_path, ckpts, model_config, paged):
    """Group pythia_serving: pythia_1b at full width, PYTHIA_TRAIN_LAYERS
    layers, bf16, through every serving path (:func:`pythia_tenants`,
    :func:`pythia_contiguous`, :func:`pythia_spec`, :func:`pythia_server`),
    each checkpoint read and verified once (:class:`RestoreOnce`).
    ``prompts_path`` holds the pythia drains' prompts.  Returns {kernels-line
    row name: launches}."""
    rows = dict.fromkeys((f"paged_decode_attention@{PYTHIA}", f"packed_paged_attention@{PYTHIA}",
                          f"paged_decode_attention_verify@{PYTHIA}",
                          f"packed_paged_attention_verify@{PYTHIA}",
                          f"grouped_lora_matmul@{PYTHIA}", f"grouped_lora_matmul@prefill_{PYTHIA}"),
                         0)

    def add(launches, suffix=f"@{PYTHIA}"):
        for kernel, n in launches.items():
            rows[kernel + suffix] += n

    with RestoreOnce():
        add(pythia_tenants(torch, prompts_path, ckpts, model_config))
        decode, prefill = pythia_contiguous(torch, device, prompts_path, ckpts, model_config, paged)
        add({"grouped_lora_matmul": decode})
        add({"grouped_lora_matmul": prefill}, f"@prefill_{PYTHIA}")
        launches, window = pythia_spec(torch, repeat_path, ckpts, model_config)
        add(launches)
        add(window, f"_verify@{PYTHIA}")
        launches, verify = pythia_server(torch, repeat_path, ckpts, model_config)
        add(launches)
        add({"paged_decode_attention": verify}, f"_verify@{PYTHIA}")
    return rows


# -- prune-retrain at pythia_1b ----------------------------------------------------

DRAFT_SPARSITY = 0.2  # pythia_spec's draft: its base pruned by magnitude, globally
PRUNE_SPARSITY = "0.5"  # the dense prune run's --prune_sparsity (global)
PRUNE_NM = "2:4"  # the int8 prune run's --prune_nm


def pythia_draft(torch, work, base):
    """pythia_spec's ``--spec model`` draft: ``python -m
    relora_tpu_torch.compress.draft BASE OUT --sparsity DRAFT_SPARSITY`` over
    pythia_serving's base (merged on the card, pruned by one global
    magnitude threshold over its LoRA projections).  Fails unless the
    manifest lists the sidecar and its ``pruned`` block records the
    sidecar's mask at that sparsity (pythia_spec's restore verifies the
    files).  Returns the draft directory."""
    from relora_tpu_torch.compress import draft as compress_draft
    from relora_tpu_torch.compress import prune
    from relora_tpu_torch.train import checkpoint as ckpt

    out = os.path.join(work, "pythia_draft")
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    path = compress_draft.main([base, out, "--sparsity", str(DRAFT_SPARSITY)])
    seconds = time.perf_counter() - t0
    with open(os.path.join(path, ckpt.MANIFEST_FILE)) as f:
        manifest = json.load(f)
    with open(os.path.join(path, prune.PRUNE_META_FILE)) as f:
        meta = json.load(f)
    pruned = manifest["metadata"]["pruned"]
    print(json.dumps({"pythia_draft": path, "seconds": seconds, **pruned}))
    # pythia_spec's restore verifies the files against the manifest
    if prune.PRUNE_MASK_FILE not in manifest["files"] or pruned["mask_crc32"] != meta[
            "mask_crc32"] or abs(pruned["sparsity"] - DRAFT_SPARSITY) > 1e-3:
        raise AssertionError(f"pythia_draft: manifest {manifest['files'].keys()}, pruned "
                             f"{pruned}, sidecar crc {meta['mask_crc32']}")
    return path


class PruneWatch:
    """Wraps the trainer's ``merge_and_reinit`` and
    ``Trainer._maybe_compute_prune_mask`` for one prune run: right after the
    prune event, and after every merge that carries the mask, it reads every
    masked base on the card and counts the pruned positions that are not
    exactly 0 (``nonzero``: one entry a check, ``at``: the update); it
    times the event (the mask's computation and application, the device
    synchronized on both sides) and keeps the trainer's mask."""

    def __init__(self, torch):
        from relora_tpu_torch.train import trainer

        self.torch, self.trainer = torch, trainer
        self.real_merge = trainer.merge_and_reinit
        self.real_compute = trainer.Trainer._maybe_compute_prune_mask
        self.nonzero, self.at, self.seconds, self.mask = [], [], [], None

    def __enter__(self):
        watch = self

        def compute(trainer_self):
            before = trainer_self._prune_mask
            watch.torch.cuda.synchronize()
            t0 = time.perf_counter()
            watch.real_compute(trainer_self)
            watch.torch.cuda.synchronize()
            if before is None and trainer_self._prune_mask is not None:
                watch.seconds.append(time.perf_counter() - t0)
                watch.mask = trainer_self._prune_mask
                watch._check(trainer_self.model, watch.mask, trainer_self.update_step)

        self.trainer.merge_and_reinit = self._merge
        self.trainer.Trainer._maybe_compute_prune_mask = compute
        return self

    def __exit__(self, *exc):
        self.trainer.merge_and_reinit = self.real_merge
        self.trainer.Trainer._maybe_compute_prune_mask = self.real_compute

    def _merge(self, model, generator, spec, **kwargs):
        out = self.real_merge(model, generator, spec, **kwargs)
        if kwargs.get("mask"):
            self._check(model, kwargs["mask"], None)
        return out

    def _check(self, model, mask, step):
        nonzero = 0
        for name, keep in mask.items():
            module = model.get_submodule(name)
            base = module.weight_q if getattr(module, "weight_q", None) is not None else module.weight
            nonzero += int((base.t()[~keep] != 0).sum())
        self.nonzero.append(nonzero)
        self.at.append(step)


def prune_group(torch, device, corpus, pythia_args, pythia_warm, work, beside):
    """Group prune, at pythia_1b's full width and PYTHIA_TRAIN_LAYERS layers:

    (a) ``relora_tpu_torch.main`` with pythia_train's arguments plus
        ``--prune_sparsity 0.5 --prune_scope global --reset_init magnitude``
        (merges at 4 and 7: the mask computed at 4 from the merged base, the
        merge at 7 masked), bf16 over an f32 dense base, every attention on
        kernel 3's wide kernels (the train phase's checks);
    (b) int8_train@pythia_1b's run plus ``--prune_nm 2:4``: kernel 8 in
        every projection, every group of 4 codes along ``in`` holding
        exactly 2 kept, pruned share exactly 0.5;
    (c) ``python -m relora_tpu_torch.compress.draft`` and
        ``relora_tpu_torch.tools.export_hf --pruned`` over (a)'s last
        checkpoint; the ``pytorch_model.bin`` grafted into a fresh model by
        ``models/warm_start.graft_base_weights`` equals the checkpoint's
        merged weights with the mask applied, zeros included, and so does
        the draft.

    Fails unless every pruned position of every masked base is exactly 0
    right after the prune event and after the later merge, and the
    ``prune_mask_computed`` event's crc equals the last checkpoint's sidecar
    (whose files (a)'s ``verify_checkpoint`` checks).  Prints one line a run (ms per update
    beside the plain run at the same depth in ``beside``, the event's
    seconds, sparsity and crc) and one for (c).  Returns the two runs'
    launches."""
    from relora_tpu_torch.compress import draft as compress_draft
    from relora_tpu_torch.compress import prune
    from relora_tpu_torch.config.model import load_model_config
    from relora_tpu_torch.models.family import causal_lm_class
    from relora_tpu_torch.models.warm_start import graft_base_weights
    from relora_tpu_torch.tools import export_hf
    from relora_tpu_torch.train import checkpoint as ckpt

    model_config = pythia_args[pythia_args.index("--model_config") + 1]
    runs = (
        ("dense", f"prune_train@{PYTHIA}", "pythia_train",
         ["--prune_sparsity", PRUNE_SPARSITY, "--prune_scope", "global", "--reset_init", "magnitude",
          "--log_every", "4"]),
        ("int8", f"prune_int8_train@{PYTHIA}", f"int8_train@{PYTHIA}",
         ["--quantize", "int8", "--warmed_up_model", pythia_warm, "--prune_nm", PRUNE_NM]),
    )
    launches, dirs = [], {}
    for kind, label, plain, extra in runs:
        save_dir = dirs[kind] = os.path.join(work, f"prune_{kind}_{PYTHIA}")
        shutil.rmtree(save_dir, ignore_errors=True)
        with PruneWatch(torch) as watch:
            counts, line = train(torch, corpus, label, extra + ["--save_dir", save_dir],
                                 base_args=pythia_args)
        launches.append(counts)
        last = os.path.join(save_dir, f"model_{TRAIN_UPDATES}")
        ok, reason = ckpt.verify_checkpoint(last) if kind == "dense" else (True, "not read")
        with open(os.path.join(last, prune.PRUNE_META_FILE)) as f:
            meta = json.load(f)
        with open(os.path.join(save_dir, "metrics.jsonl")) as f:
            events = [r for r in map(json.loads, f) if r.get("_event") == "prune_mask_computed"]
        mask = watch.mask
        stats = prune.sparsity_stats(mask) if mask is not None else {}
        out = {"prune": kind, "model": PYTHIA, "ms_per_update": line["ms_per_update"],
               f"{plain}_ms_per_update": beside[plain]["ms_per_update"],
               "mask_seconds": watch.seconds, "sparsity": stats.get("sparsity"),
               "masked_modules": len(mask or ()), "masked_weights": stats.get("total"),
               "mask_crc32": [e["mask_crc32"] for e in events], "sidecar_crc32": meta["mask_crc32"],
               "checks_at": watch.at, "nonzero_pruned": watch.nonzero, "verify": reason}
        if kind == "int8":
            groups = [keep.reshape(keep.shape[0] // 4, 4, keep.shape[1]).sum(1) for keep in mask.values()]
            out["groups_of_4_with_2_kept"] = all(bool((g == 2).all()) for g in groups)
        print(json.dumps(out))
        layers = load_model_config(model_config).num_hidden_layers
        if not (ok and len(events) == 1 and events[0]["_step"] == 4 and mask is not None
                and len(mask) == 4 * layers and events[0]["mask_crc32"] == meta["mask_crc32"]
                == prune.mask_checksum(mask)):
            raise AssertionError(f"prune {kind}: {out}")
        if watch.at != [4, None] or any(watch.nonzero):
            raise AssertionError(f"prune {kind}: pruned positions not exactly 0 after the prune "
                                 f"event and the merge at 7: {out}")
        if kind == "int8" and not (out["groups_of_4_with_2_kept"] and stats["sparsity"] == 0.5):
            raise AssertionError(f"prune int8: not 2 of every 4 kept: {out}")
        del watch, mask
        torch.cuda.empty_cache()

    # (c) the draft and the HF export of the dense run's last checkpoint,
    # read and verified from disk once for the tools and the checks
    last = os.path.join(dirs["dense"], f"model_{TRAIN_UPDATES}")
    with RestoreOnce():
        mask, meta = prune.load_mask(last, device=device)
        t0 = time.perf_counter()
        drafted = compress_draft.main([last, os.path.join(work, "prune_draft")])
        draft_s = time.perf_counter() - t0
        hf_dir = os.path.join(work, "prune_hf")
        t0 = time.perf_counter()
        export_hf.main(["--checkpoint", last, "--model_config", model_config, "--out", hf_dir,
                        "--pruned"])
        export_s = time.perf_counter() - t0
        want = prune.apply_mask(ckpt.restore_serving_params(last, device=device), mask)
        draft_params = ckpt.restore_serving_params(drafted, device=device)
    cfg = load_model_config(model_config)
    with torch.device(device):
        fresh = causal_lm_class(cfg)(cfg)
    graft_base_weights(fresh, torch.load(os.path.join(hf_dir, "pytorch_model.bin"), weights_only=True))
    differ = [n for n, p in fresh.named_parameters() if not torch.equal(p, want[n])]
    zeros = sum(int((fresh.get_submodule(n).weight.t()[~keep] != 0).sum()) for n, keep in mask.items())
    draft_differ = [n for n, t in want.items() if not torch.equal(draft_params[n], t)]
    with open(os.path.join(hf_dir, "config.json")) as f:
        hf_pruning = json.load(f).get("relora_tpu_pruning")
    with open(os.path.join(drafted, ckpt.MANIFEST_FILE)) as f:
        draft_pruned = json.load(f)["metadata"]["pruned"]
    print(json.dumps({"prune_export": PYTHIA, "draft_seconds": draft_s, "export_seconds": export_s,
                      "grafted_params": sum(1 for _ in fresh.parameters()), "grafted_differ": differ,
                      "pruned_nonzero": zeros, "draft_differ": draft_differ,
                      "hf_pruning": hf_pruning, "draft_pruned": draft_pruned}))
    crc = meta["mask_crc32"]
    if differ or zeros or draft_differ or hf_pruning["mask_crc32"] != crc or (
            draft_pruned["mask_crc32"] != crc) or sorted(draft_params) != sorted(want):
        raise AssertionError("prune export: the grafted export or the draft is not the merged, "
                             "masked checkpoint")
    del fresh, want, draft_params, mask
    for path in list(dirs.values()) + [os.path.join(work, "prune_draft"), hf_dir]:
        shutil.rmtree(path, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


# -- the fleet tools over fleet_front's files ----------------------------------------


def fleet_tools(front):
    """Phase fleet_tools (in the f32 slot; no kernel): ``python -m
    relora_tpu_torch.tools.fleet_report`` over the supervisor's persisted
    ``fleet_series.jsonl`` (text and ``--json``), and ``python -m
    relora_tpu_torch.tools.trace_report`` over the router's
    ``router_spans_<pid>.jsonl`` merged with the replicas'
    ``serve_spans_<pid>.jsonl`` (``RELORA_TPU_TRACE_DIR`` of fleet_front's
    supervisor), with a Chrome export.  Fails unless each exits 0 with every
    section of its report: the three replicas in the fleet health table,
    the SLO table, the merged streams' span trees with the router's and a
    replica's spans, a non-empty Chrome trace."""
    import glob

    series = os.path.join(front.dir, "fleet_series.jsonl")
    routers = sorted(glob.glob(os.path.join(front.trace_dir, "router_spans_*.jsonl")))
    replicas = sorted(glob.glob(os.path.join(front.trace_dir, "serve_spans_*.jsonl")))
    if not os.path.exists(series) or not routers or not replicas:
        raise AssertionError(f"fleet_tools: missing inputs: series {os.path.exists(series)}, "
                             f"router spans {routers}, replica spans {replicas}")
    chrome = os.path.join(front.dir, "trace_chrome.json")

    def tool(name, *args):
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", f"relora_tpu_torch.tools.{name}", *args],
                             cwd=REPO, capture_output=True, text=True, timeout=SERVER_WAIT)
        if out.returncode != 0:
            raise AssertionError(f"fleet_tools: {name} exited {out.returncode}:\n{out.stderr[-2000:]}")
        return out.stdout, time.perf_counter() - t0

    report, report_s = tool("fleet_report", series)
    payload = json.loads(tool("fleet_report", series, "--json")[0])
    trace, trace_s = tool("trace_report", *routers, *replicas, "--chrome", chrome)
    with open(chrome) as f:
        events = json.load(f)["traceEvents"]
    health = report.split("== fleet health ==", 1)[-1].split("==", 1)[0]
    rows = {line.split()[0] for line in health.strip().splitlines()[1:] if line.strip()}
    line = {"fleet_tools": "fleet_report, trace_report", "series_records": payload["loaded_records"],
            "sources": payload["sources"], "slo_objectives": len(payload["slo"]["objectives"]),
            "router_streams": len(routers), "replica_streams": len(replicas),
            "trace_lines": len(trace.splitlines()), "chrome_events": len(events),
            "report_s": report_s, "trace_report_s": trace_s}
    print(json.dumps(line))
    if (not {"r0", "r1", "r2"} <= rows or "== SLO / error budget ==" not in report
            or "== timeline" not in report or not payload["loaded_records"]):
        raise AssertionError(f"fleet_tools: malformed fleet report:\n{report[:3000]}")
    phases = {ln.split()[0] for ln in trace.split("\nphase ", 1)[-1].splitlines()[1:] if ln.strip()}
    if not trace.startswith("merged ") or not {"route", "request"} <= phases or not events:
        raise AssertionError(f"fleet_tools: malformed trace report:\n{trace[:3000]}")


def take_launches(rows, launches, model=""):
    """Each row of ``rows`` named ``kernel`` (``model`` empty) or
    ``kernel@model`` adds ``launches[kernel]``; other rows are left alone."""
    for row in rows:
        kernel, _, of = row["name"].partition("@")
        if of == model and kernel in launches:
            row["launches"] += launches[kernel]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to prove",
              file=sys.stderr)
        return 2
    try:
        import relora_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 2
    from relora_tpu_torch.ops import _build

    device = torch.device("cuda")
    t0 = time.perf_counter()
    laps, last = {}, [t0]

    def lap(name):
        """The wall seconds since the previous lap, under ``name``."""
        now = time.perf_counter()
        laps[name] = round(now - last[0], 1)
        last[0] = now

    # the -Xptxas -v compiles start with the build's, every nvcc at once
    ptxas = ptxas_report(_build.CSRC / "lora_matmul.cu", GROUPED_KERNELS + FWD_TC_KERNELS
                         + DX_TC_KERNELS + DEQUANT_TC_KERNELS + DAB_KERNELS)
    paged_ptxas = ptxas_report(_build.CSRC / "paged_attention.cu", PAGED_KERNELS)
    flash_ptxas = ptxas_report(_build.CSRC / "flash_attention.cu", FLASH_KERNELS)
    libs = _build.build_all()
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f}s")
    # the three cuobjdump reads run together too
    for report in [count_hmma(libs["flash_attention"], FLASH_TC_KERNELS),
                   count_hmma(libs["lora_matmul"], GROUPED_TC_KERNELS + FWD_TC_KERNELS
                              + DX_TC_KERNELS + DEQUANT_TC_KERNELS + DAB_TC_KERNELS),
                   count_hmma(libs["paged_attention"], PAGED_TC_KERNELS)]:
        report()
    paged_ptxas()
    flash_ptxas()
    lap("build")

    rows = check_kernels(torch, device)
    flash_rows = check_flash_kernels(torch, device)
    lap("kernels, kernels-3")
    work = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    prompts = os.path.join(work, "prompts.txt")
    write_prompts(prompts, 32100)
    repeat = write_repeat_prompts(os.path.join(work, "repeat.txt"), 32100)
    check_profile_readers(torch, device)
    launches, plain_lines, inproc = drains(torch, prompts, repeat)
    torch.cuda.empty_cache()
    lap("drains")
    spec_base, spec_draft = write_spec_checkpoints(torch, work, device)
    spec_launches, window, _ = spec_drains(
        torch, prompts, repeat, spec_base, spec_draft,
        {line["drain"]: line["tokens_per_s"] for line in plain_lines})
    lap("spec")
    # the online front end: serve_cli --port over kernels 1 and 2
    # server (f)'s process starts after the profiled bf16 server drain and
    # warms up while the packed server drain and server_overload run (their
    # timings are reported, not gated)
    started = []
    try:
        server_launches, _ = server_drains(torch, prompts, inproc,
                                           midway=lambda: started.append(server_process(work)))
        server_launches["paged_decode_attention"] += server_overload(torch, prompts)[0]
        # the fleet tier: six serve_cli replicas and the supervised fleet (its
        # router, collector and three replicas) share the card; they start while
        # server_subprocess and server_f32 run (neither times the device)
        fleet, fleet_dir, fleet_paths, (base, tenants), pythia_ckpts = fleet_launch(
            torch, work, device)
    except BaseException:
        for proc, *_ in started:
            proc.kill()
        raise
    front = Front(work)
    try:
        server_subprocess(started[0], prompts, inproc)
        server_f32(torch, work, prompts)
        lap("server")
        # pythia_serving's pruned draft, exported while the fleet's and the
        # supervisor's replicas finish starting
        pythia_ckpts = (*pythia_ckpts, pythia_draft(torch, work, pythia_ckpts[0]))
        torch.cuda.empty_cache()
        lap("pythia_draft")
    except BaseException:
        fleet_stop(fleet, check=False)
        front.stop(check=False)
        raise
    try:
        fleet_ready(fleet)
    except BaseException:
        front.stop(check=False)
        raise
    try:
        front_state = fleet_front(front.ready(), prompts, inproc)
        lap("fleet_front")
        fleet_disagg_checks = fleet_disagg(fleet, prompts, inproc)
        lap("fleet_disagg")
        # the crash drill's kill, then the f32 phases, which time nothing:
        # they run while two replicas read the fleet drain's device traces
        # and the killed replica restarts and warms up
        fleet_front_crash(front, front_state)
        fleet_front_reference(prompts, front_state)
        fleet_tools(front)
        f32_comparison(torch, device)
        torch.cuda.empty_cache()
        f32_spec_drains(torch, repeat, work)
        torch.cuda.empty_cache()
        f32_train(torch, device)
        torch.cuda.empty_cache()
        f32_fused(torch, device)
        torch.cuda.empty_cache()
        f32_adapters(torch, device, tenants)
        torch.cuda.empty_cache()
        f32_contiguous(torch, device)
        for phase in (f32_train, f32_fused, f32_comparison):
            torch.cuda.empty_cache()
            phase(torch, device, PYTHIA)
        torch.cuda.empty_cache()
        f32_adapters(torch, device, None, PYTHIA)
        torch.cuda.empty_cache()
        warm = write_warm_start(torch, os.path.join(work, "warm_llama_250m"), device)
        f32_int8(torch, device, warm)
        torch.cuda.empty_cache()
        pythia_args = pythia_train_args(work)
        pythia_warm = write_warm_start(torch, os.path.join(work, f"warm_{PYTHIA}"), device,
                                       model_config=pythia_args[pythia_args.index("--model_config") + 1],
                                       dtype=torch.bfloat16)
        torch.cuda.empty_cache()
        f32_nf4_launches = f32_nf4(torch, device, pythia_warm)
        torch.cuda.empty_cache()
        lap("fleet_tools, f32, f32-spec, f32-train, f32-fused, f32-adapters, f32_contiguous, "
            "f32-pythia, f32-int8, f32-nf4")
        disagg_line = fleet_disagg_checks()
        front_launches = fleet_front_finish(front, front_state, fleet_paths, disagg_line)
        lap("fleet_front_finish")
        fleet_reload(torch, fleet, prompts, fleet_dir, fleet_paths)
    except BaseException:
        fleet_stop(fleet, check=False)
        front.stop(check=False)
        raise
    fleet_launches = fleet_stop(fleet)
    print(json.dumps({"fleet_launches": fleet_launches,
                      "tdecode_launches": fleet["tdecode"].launches,
                      "front_launches": front.launches}))
    for kernel in server_launches:
        if not fleet_launches.get(kernel):
            raise AssertionError(f"fleet: no replica launched {kernel}: {fleet_launches}")
        server_launches[kernel] += fleet_launches[kernel] + front_launches.get(kernel, 0)
    if not fleet["tdecode"].launches.get("grouped_lora_matmul"):
        raise AssertionError(f"fleet: the tenant receiver never launched kernel 5: "
                             f"{fleet['tdecode'].launches}")
    shutil.rmtree(fleet_dir, ignore_errors=True)
    shutil.rmtree(front.dir, ignore_errors=True)
    lap("fleet_reload")
    paged_rows = {row["name"]: row for row in rows}
    for name, row in paged_rows.items():
        if name.endswith(PYTHIA):
            continue  # the pythia drains' launches, below
        kernel = name.removesuffix("_verify")
        row["launches"] = window[kernel] if name != kernel else (
            launches[kernel] + spec_launches[kernel] + server_launches[kernel])
    launches, _ = train(torch, write_corpus(work))
    take_launches(flash_rows, launches)
    rows += flash_rows
    torch.cuda.empty_cache()
    lap("train")
    rows += glue(torch, device, work)
    torch.cuda.empty_cache()
    lap("glue")
    lora_rows = check_lora_kernels(torch, device)
    torch.cuda.empty_cache()
    launches, _ = train(torch, write_corpus(work), "fused_train",
                        ["--lora_fused", "true", "--lora_dropout", "0"])
    take_launches(lora_rows, launches)
    rows += lora_rows
    torch.cuda.empty_cache()
    profile_train(torch, write_corpus(work))
    torch.cuda.empty_cache()
    lap("kernels-4, fused_train, profile_train")
    int8_rows = check_int8_kernels(torch, device)
    torch.cuda.empty_cache()
    int8 = ["--quantize", "int8", "--warmed_up_model", warm]
    int8_dir = os.path.join(work, "int8_llama_250m")
    shutil.rmtree(int8_dir, ignore_errors=True)
    launches, int8_line = train(torch, write_corpus(work), "int8_train", int8 + ["--save_dir", int8_dir])
    take_launches(int8_rows, launches)
    torch.cuda.empty_cache()
    launches, _ = train(torch, write_corpus(work), "int8_fused_train",
                        int8 + ["--lora_fused", "true", "--lora_dropout", "0"])
    take_launches(int8_rows, launches)
    rows += int8_rows
    torch.cuda.empty_cache()
    lap("kernels-8, int8_train, int8_fused_train")
    ptxas()
    grouped_rows = check_grouped_kernels(torch, device)
    torch.cuda.empty_cache()
    grouped_rows[0]["launches"], k1, k1_window = adapter_drains(torch, device, prompts, base,
                                                                 tenants, repeat)
    grouped_rows[0]["launches"] += fleet_launches["grouped_lora_matmul"]
    paged_rows["paged_decode_attention"]["launches"] += k1
    paged_rows["paged_decode_attention_verify"]["launches"] += k1_window
    grouped_rows[0]["launches"] += server_tenants(torch, base, tenants, prompts)
    rows += grouped_rows
    torch.cuda.empty_cache()
    lap("kernels-5, adapters")

    # the reference's default serving mode: the contiguous engine, its
    # scheduler (kernel 5 for tenants), generate, the server over it
    contiguous = contiguous_drain(torch, prompts, inproc)
    decode_launches, prefill_launches = contiguous_tenants(torch, device, prompts, base, tenants)
    grouped_rows[0]["launches"] += decode_launches
    grouped_rows[1]["launches"] += prefill_launches
    generate_phase(torch, prompts, contiguous)
    contiguous_server(torch, prompts, contiguous)
    torch.cuda.empty_cache()
    lap("contiguous phases")

    # the cost model: its picks against each arm's time, --lora_fused auto
    # training, a run cut by SIGTERM and resumed, and unmerged serving of a
    # bf16 and an int8 base through its picks
    print(json.dumps({"launch_us": launch_cost_us(torch, device)}))
    for model_name in ("llama_250m", PYTHIA):
        auto_arms(torch, device, model_name)
        torch.cuda.empty_cache()
    corpus = write_corpus(work)
    launches, auto_line = train(torch, corpus, "auto_train", RESUME_ARGS)
    take_launches(lora_rows, launches)
    torch.cuda.empty_cache()
    trained = resume(torch, corpus, auto_line, work)
    torch.cuda.empty_cache()
    decode_row = int8_decode_row(torch, device)
    launches = nomerge_drains(torch, prompts, {
        "bf16": trained, "int8": os.path.join(int8_dir, f"model_{TRAIN_UPDATES}")})
    decode_row["launches"] = launches.pop("fused_lora_int8_forward")
    take_launches(rows, launches)
    rows.append(decode_row)
    torch.cuda.empty_cache()
    lap("auto-arms, auto_train, resume, nomerge")

    # the NeoX family at pythia_1b: its drains, every serving path, train phases
    pythia_config = pythia_args[pythia_args.index("--model_config") + 1]
    launches, pythia_paged = pythia_drains(torch, prompts, pythia_config)
    take_launches(paged_rows.values(), launches, PYTHIA)
    lap("pythia-drains")
    by_name = {row["name"]: row for row in rows + grouped_rows}
    for name, n in pythia_serving(torch, device, head_prompts(prompts, PYTHIA_PROMPTS,
                                                              "pythia_prompts.txt"),
                                  repeat, pythia_ckpts, pythia_config, pythia_paged).items():
        by_name[name]["launches"] += n
    torch.cuda.empty_cache()
    lap("pythia_serving")
    corpus = write_corpus(work, seq_length=2048)
    launches, pythia_line = train(torch, corpus, "pythia_train", ["--log_every", "4"],
                                  base_args=pythia_args)
    take_launches(flash_rows, launches, PYTHIA)
    torch.cuda.empty_cache()
    take_launches(lora_rows, train(
        torch, corpus, "pythia_fused_train",
        ["--lora_fused", "true", "--lora_dropout", "0", "--warmed_up_model", pythia_warm],
        base_args=pythia_args)[0], PYTHIA)
    torch.cuda.empty_cache()
    # pythia_1b over an int8 base: kernel 8, then 4-int8, 6-int8 and 7
    int8 = ["--quantize", "int8", "--warmed_up_model", pythia_warm]
    launches, int8_pythia_line = train(torch, corpus, f"int8_train@{PYTHIA}", int8,
                                       base_args=pythia_args)
    take_launches(int8_rows, launches, PYTHIA)
    torch.cuda.empty_cache()
    launches, _ = train(torch, corpus, f"int8_fused_train@{PYTHIA}",
                        int8 + ["--lora_fused", "true", "--lora_dropout", "0"],
                        base_args=pythia_args)
    take_launches(int8_rows + lora_rows, launches, PYTHIA)
    torch.cuda.empty_cache()
    take_launches(lora_rows, train(torch, corpus, f"auto_train@{PYTHIA}", RESUME_ARGS,
                                   base_args=pythia_args)[0], PYTHIA)
    lap("pythia train phases")

    # prune-retrain: a dense run with the magnitude re-init, an int8 run at
    # 2:4, the draft and the HF export of the dense run
    torch.cuda.empty_cache()
    dense, int8_pruned = prune_group(torch, device, corpus, pythia_args, pythia_warm, work, {
        "pythia_train": pythia_line, f"int8_train@{PYTHIA}": int8_pythia_line})
    take_launches(flash_rows, dense, PYTHIA)
    take_launches(flash_rows + int8_rows, int8_pruned, PYTHIA)
    torch.cuda.empty_cache()
    lap("prune")

    # the memory levers: an nf4 base trained, served merged and unmerged,
    # its odd-width int8 fallback; the chunked loss; the remat policies
    torch.cuda.empty_cache()
    nf4_dir = os.path.join(work, "nf4_llama_250m")
    shutil.rmtree(nf4_dir, ignore_errors=True)
    launches, nf4_line = train(torch, write_corpus(work), "nf4_train", NF4_ARGS + [
        "--warmed_up_model", os.path.join(work, "warm_llama_250m"), "--save_dir", nf4_dir])
    take_launches(flash_rows, launches)
    memory_line("nf4_train", nf4_line, {"int8_train": int8_line})
    torch.cuda.empty_cache()
    paged_rows["paged_decode_attention"]["launches"] += nf4_serve(
        torch, prompts, os.path.join(nf4_dir, f"model_{TRAIN_UPDATES}"))
    torch.cuda.empty_cache()
    take_launches(flash_rows, nf4_pythia(torch, corpus, pythia_warm, {
        f"int8_train@{PYTHIA}": int8_pythia_line, "pythia_train": pythia_line}, pythia_args), PYTHIA)
    torch.cuda.empty_cache()
    take_launches(flash_rows, memory_levers(torch, work, pythia_line, pythia_args), PYTHIA)
    torch.cuda.empty_cache()
    take_launches(rows, f32_nf4_launches)
    lap("nf4_train, nf4_serve, nf4@pythia_1b, chunked, remat")

    print(json.dumps({"phase_seconds": laps, "total_s": time.perf_counter() - t0}))
    print(json.dumps({"kernels": rows}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def device_profile(torch, fn):
    """Run ``fn`` under ``torch.profiler`` tracing the device; returns
    ``(fn's result, wall seconds, device busy seconds, {kernel name cut to
    80 characters: device µs})``.  Busy time is the union of kernel
    intervals, so overlapping streams are not counted twice."""
    from torch.profiler import ProfilerActivity, profile

    from relora_tpu_torch.utils.profiling import busy_ns, kineto_intervals

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    intervals, by_name = kineto_intervals(prof)
    if not intervals:
        raise AssertionError("the profiler traced no device time")
    return result, wall, busy_ns(intervals) / 1e9, by_name


def check_profile_readers(torch, device):
    """The port's one reader of the profiler's raw records
    (``utils/profiling.kineto_intervals`` and ``busy_ns``, which
    :func:`device_profile` and every replica's ``/admin/profile`` window
    use) against ``prof.events()`` (the profiler's public reader) on one
    small profiled region: matmuls, softmaxes, host-to-device copies and
    memsets on two streams, 200 rounds.  Fails unless both see the same
    number of device intervals, the same busy time and the same time per
    kernel name within 1e-6 relative."""
    from torch.profiler import ProfilerActivity, profile

    from relora_tpu_torch.utils.profiling import busy_ns, kineto_intervals

    host = torch.randn((256, 256)).pin_memory()
    x = torch.randn((256, 256), device=device)
    y = torch.empty_like(x)
    side = torch.cuda.Stream(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(200):
            z = torch.softmax(x @ x, dim=-1)
            with torch.cuda.stream(side):
                y.copy_(host, non_blocking=True)
                y.zero_()
            x = z + 1e-3 * y
        torch.cuda.synchronize()
    raw, raw_names = kineto_intervals(prof)
    tree, tree_names = [], {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.time_range.elapsed_us() > 0:
            tree.append((ev.time_range.start * 1e3, ev.time_range.end * 1e3))
            name = ev.name[:80]
            tree_names[name] = tree_names.get(name, 0.0) + ev.time_range.elapsed_us()
    busy_raw, busy_tree = busy_ns(raw), busy_ns(tree)
    print(json.dumps({"profile_readers": {"intervals": [len(raw), len(tree)],
                                          "busy_us": [busy_raw / 1e3, busy_tree / 1e3],
                                          "names": len(raw_names)}}))
    if not raw or len(raw) != len(tree) or abs(busy_raw - busy_tree) > 1e-6 * busy_tree + 1:
        raise AssertionError("profile readers: raw records and prof.events() disagree on busy time")
    if set(raw_names) != set(tree_names) or any(
            abs(raw_names[k] - tree_names[k]) > 1e-6 * tree_names[k] + 1e-3 for k in raw_names):
        raise AssertionError("profile readers: raw records and prof.events() disagree per kernel")


def grouped_share(by_name, busy_s):
    """Kernel 5's share of the device's busy time (its kernels are named grouped_*)."""
    return sum(us for name, us in by_name.items() if "grouped_" in name) / 1e6 / busy_s


def ab_grouped(torch):
    """Kernel 5 at M = 8, 64, 72 x llama_250m's projection shapes, r = 128,
    4 slots, bf16, 100 launches each: ms per call and per decoder layer."""
    from relora_tpu_torch.ops import lora_matmul as LM

    calls, layers = {}, {}
    with torch.no_grad():
        for M in GROUPED_MS:
            layers[str(M)] = 0.0
            for K, N, count in LORA_SHAPES:
                args = make_grouped_case(torch, torch.device("cuda"), M, K, N, ADAPTER_R,
                                         ADAPTER_SLOTS, "bf16", seed=99)
                ms = time_ms(torch, lambda: LM.grouped_lora_matmul(*args), iters=100)
                calls[f"M={M} K={K} N={N}"] = ms
                layers[str(M)] += count * ms
    return {"grouped_ms_per_layer": layers, "grouped_ms_per_call": calls}


def ab_lora(torch):
    """Kernels 6 and 6-int8 (the fused dx over a bf16 and an int8 base) and,
    as controls, kernels 4 and 4-int8 (the fused forward), 7 (dA/dB, with u
    from dx) and 8 (the int8 dequant matmul) at kernels-4's three llama_250m
    shapes, M = 4096, r = 128, bf16, the base as the model passes it, 100
    launches each: ms per call and per decoder layer (7 projections)."""
    from relora_tpu_torch.ops import lora_matmul as LM
    from relora_tpu_torch.ops import quant_matmul as QM
    from relora_tpu_torch.ops.quant import quantize_int8

    calls, layers = {}, {}
    with torch.no_grad():
        for K, N, count in LORA_SHAPES:
            x, w, a, b, gy = make_lora_case(torch, torch.device("cuda"), LORA_M, K, N, LORA_R,
                                            "bf16", seed=99)
            q_nk, qs = quantize_int8(w.t())
            q = q_nk.t()
            _, z = LM.fused_lora_forward(x, w, a, b, 0.25)
            _, u = LM.fused_lora_bwd_dx(gy, w, a, b, 0.25)
            for name, fn in (
                ("fused_lora_bwd_dx", lambda: LM.fused_lora_bwd_dx(gy, w, a, b, 0.25)),
                ("fused_lora_int8_bwd_dx", lambda: LM.fused_lora_int8_bwd_dx(gy, q, qs, a, b, 0.25)),
                ("fused_lora_forward", lambda: LM.fused_lora_forward(x, w, a, b, 0.25)),
                ("fused_lora_int8_forward", lambda: LM.fused_lora_int8_forward(x, q, qs, a, b, 0.25)),
                ("fused_lora_bwd_dab", lambda: LM.fused_lora_bwd_dab(gy, x, z, b, 0.25, u)),
                ("dequant_matmul", lambda: QM.dequant_matmul(x, q, qs)),
            ):
                ms = time_ms(torch, fn, iters=100)
                calls[f"{name} K={K} N={N}"] = ms
                layers[name] = layers.get(name, 0.0) + count * ms
    return {"lora_ms_per_layer": layers, "lora_ms_per_call": calls}


def ab_tenants(torch):
    """The adapter phase's mixed-tenant drains (sequential, packed, and
    sequential with 3 slots), each on a fresh engine and registry: one timed
    drain, then one traced for the device idle share and kernel 5's share of
    busy time.  A short drain first takes the process's first-use costs."""
    from relora_tpu_torch.serve.adapters import AdapterRegistry

    device = torch.device("cuda")
    work = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    prompts_path = os.path.join(work, "prompts.txt")
    write_prompts(prompts_path, 32100)
    base, tenants = write_adapter_checkpoints(torch, work, device)
    prompts = read_prompts(prompts_path)
    mix = [None] + list(TENANT_ALPHAS)
    requests = tenant_requests(prompts, mix)
    out = {}
    for label, slots, packed in (("tenants", ADAPTER_SLOTS, False),
                                 ("tenants_packed", ADAPTER_SLOTS, True),
                                 ("tenants_3_slots", 3, False)):
        engine = tenant_engine(torch, base, slots, device)
        registry = AdapterRegistry(tenants, slots, expected_r=ADAPTER_R,
                                   writer=engine.adapter_writer())
        if not out:
            tenant_drain(torch, engine, registry, tenant_requests(prompts[:4], mix, max_new=8))
        completions, seconds = tenant_drain(torch, engine, registry, requests, packed)[:2]
        tokens = sum(len(c.tokens) for c in completions.values())
        _, wall, busy, by_name = device_profile(
            torch, lambda: tenant_drain(torch, engine, registry, requests, packed))
        out[label] = {"tokens_per_s": tokens / seconds, "seconds": seconds, "profiled_wall_s": wall,
                      "device_busy_s": busy, "device_idle_share": 1.0 - busy / wall,
                      "grouped_lora_share": grouped_share(by_name, busy)}
        del engine, registry
        torch.cuda.empty_cache()
    return out


def ab_paged(torch):
    """Kernels 1 and 2 at the kernels phase's timed case (llama_250m widths,
    B = 8, a 64-page table, bf16 q) with bf16 and int8 pools, kernel 1 at
    S = 1 and 5, 100 launches each: ms per call."""
    from relora_tpu_torch.ops import attention as A

    heads, head_dim = WIDTHS["llama_250m"]
    calls = {}
    for pool in ("bf16", "int8"):
        for name, S, packed in (("paged_decode_attention", 1, False),
                                ("paged_decode_attention", 5, False),
                                ("packed_paged_attention", 1, True)):
            case = make_pool_case(torch, torch.device("cuda"), heads=heads, head_dim=head_dim,
                                  pool=pool, S=S, seed=99, packed=packed)
            keys = ("q", "pool_k", "pool_v", "block_tables") + (("row_map",) if packed else ()) + (
                "positions",)
            args = [case[k] for k in keys]
            scales = {k: case[k] for k in ("k_scale", "v_scale") if k in case}
            fn = getattr(A, name)
            label = f"{name} pool={pool}" + ("" if packed else f" S={S}")
            calls[label] = time_ms(torch, lambda: fn(*args, **scales), iters=100)
    return {"paged_ms_per_call": calls}


def paged_shares(by_name, busy_s, packed):
    """Kernel 1's and kernel 2's shares of the device's busy time and kernel
    1's ms.  Kernel 1 is paged_decode_kernel and, from its split design on,
    paged_combine_kernel; kernel 2 was packed_paged_kernel, and from its
    redesign is packed_tile_kernel plus kernel 1's pair for its other tokens,
    so in a packed drain (which runs no kernel 1 call) those count as kernel 2."""
    split = sum(us for n, us in by_name.items()
                if "paged_decode_kernel" in n or "paged_combine_kernel" in n)
    k2 = sum(us for n, us in by_name.items() if "packed_paged_kernel" in n or "packed_tile_kernel" in n)
    k1 = 0.0 if packed else split
    k2 += split if packed else 0.0
    return k1 / 1e6 / busy_s, k2 / 1e6 / busy_s, k1 / 1e3


def ab_drains(torch, spec=True):
    """The drains phase's base drains (bf16 pool, packed, int8 pool, the bf16
    pool over the repeat traffic) and, in a tree that has them and with
    ``spec``, the spec drains beside them (``--spec ngram`` on each,
    ``--spec model`` against the bf16 drain), through ``serve_cli``: each
    pair timed in turns (plain, spec, spec, plain; ``serve_cli.run``), then
    one traced drain of each, of a scheduler built outside the trace, for
    the device busy time, idle share and kernels 1 and 2's shares of busy
    time.  A short drain first takes the process's first-use costs."""
    from relora_tpu_torch import serve_cli

    device = torch.device("cuda")
    work = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    prompts = os.path.join(work, "prompts.txt")
    write_prompts(prompts, 32100)
    repeat = write_repeat_prompts(os.path.join(work, "repeat.txt"), 32100)
    common = ["--model_config", "llama_250m", "--dtype", "bf16", "--max-batch", "8", "--paged",
              "--max-new-tokens", "64"]
    base = common + ["--random-init", "--input-file", prompts]
    has_spec = spec and hasattr(serve_cli, "drain")  # trees before speculative decoding lack it
    pairs = [("bf16", base, "spec_ngram", ["--spec", "ngram"]),
             ("packed", base + ["--packed"], "spec_ngram_packed", ["--spec", "ngram"]),
             ("int8", base + ["--kv-dtype", "int8"], "spec_ngram_int8", ["--spec", "ngram"]),
             ("bf16_repeat", common + ["--random-init", "--input-file", repeat],
              "spec_ngram_repeat", ["--spec", "ngram"])]
    if has_spec:
        spec_base, spec_draft = write_spec_checkpoints(torch, work, device)
        pairs.append(("bf16_ckpt", common + ["--checkpoint", spec_base, "--input-file", prompts],
                      "spec_model", ["--spec", "model", "--draft-checkpoint", spec_draft]))
    serve_cli.run(base + ["--max-new-tokens", "4"])
    out = {}

    def timed(label, argv):
        completions, seconds = serve_cli.run(argv)
        tokens = sum(len(c.tokens) for c in completions.values())
        out.setdefault(label, {"tokens_per_s": [], "seconds": []})
        out[label]["tokens_per_s"].append(tokens / seconds)
        out[label]["seconds"].append(seconds)

    def traced(label, argv):
        args = serve_cli.parse_args(argv)
        scheduler, requests = serve_cli.build(args), serve_cli.read_requests(args)
        _, wall, busy, by_name = device_profile(torch, lambda: scheduler.run(requests))
        k1, k2, k1_ms = paged_shares(by_name, busy, "--packed" in argv)
        out[label].update({"profiled_wall_s": wall, "device_busy_s": busy,
                           "device_idle_share": 1.0 - busy / wall, "kernel1_share": k1,
                           "kernel1_ms": k1_ms, "kernel2_share": k2})
        if getattr(scheduler, "_spec", "off") != "off":
            out[label].update(scheduler.spec_stats())
        del scheduler
        torch.cuda.empty_cache()

    for plain_label, plain_argv, spec_label, spec_flags in pairs:
        spec_argv = plain_argv + ["--spec-k", str(SPEC_K)] + spec_flags
        if spec_label == "spec_model":
            spec_argv = [a for a in spec_argv if a != "--packed"]
        turns = [(plain_label, plain_argv), (spec_label, spec_argv)] if has_spec else [
            (plain_label, plain_argv)]
        for label, argv in turns + turns[::-1]:
            timed(label, argv)
        for label, argv in turns:
            traced(label, argv)
    return {"drains": out}


def ab(argv) -> int:
    """``python3 chip_smoke.py --ab DIR [--train [FLAGS...] | --grouped |
    --lora | --tenants | --paged | --drains [--no-spec] | --sass]``: one JSON line of the times of the package in the
    checkout at DIR (another tree, such as the parent unpacked with ``git
    archive``) by this script's timer and shapes, so two trees compare on
    one card when run in turns in one call (parent, change, change, parent).
    With no option: kernel 3 at the train phase's shape, bf16 (forward,
    dK/dV, dQ, the backward pair, and forward+backward through autograd),
    100 launches each.  ``--train``: the train phase (plus FLAGS) run twice,
    each run's median ms per update of updates 2-9 and its per-update
    losses; with ``--model_config pythia_1b`` among FLAGS, the pythia train
    phase's run.  ``--grouped``: kernel 5 per call and per layer
    (:func:`ab_grouped`).  ``--lora``: kernels 6, 6-int8 and the controls 4,
    4-int8, 7 and 8 per call and per layer (:func:`ab_lora`).  ``--tenants``: the
    tenant drains' tokens/s, idle share and kernel 5's share
    (:func:`ab_tenants`).  ``--paged``: kernels 1 and 2 per call
    (:func:`ab_paged`).  ``--drains``: the base drains' and the spec drains'
    tokens/s, idle share and kernels 1 and 2's shares (:func:`ab_drains`;
    ``--no-spec``: the base drains alone).  ``--sass``: the tree's
    kernels built, and each function's SASS digest (:func:`sass_digests`),
    so two trees' lines show which kernels compiled to the same code."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to time", file=sys.stderr)
        return 2
    tree = os.path.abspath(argv[1])
    sys.path.insert(0, tree)
    import relora_tpu_torch

    if not os.path.abspath(relora_tpu_torch.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"imported {relora_tpu_torch.__file__}, not the package in {tree}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    out = {"tree": argv[1], "card": smi.stdout.strip().splitlines()[0]}
    if argv[2:3] == ["--train"]:
        from relora_tpu_torch import main as train_main

        work = os.path.join(REPO, "build", "chip_smoke")
        os.makedirs(work, exist_ok=True)
        pythia = PYTHIA in argv[3:]  # --model_config pythia_1b: the pythia train phase's run
        base = PYTHIA_TRAIN_ARGS if pythia else TRAIN_ARGS
        corpus = write_corpus(work, seq_length=2048 if pythia else 512)
        args = base + argv[3:] + ["--megatron_dataset_config", corpus]
        out["flags"] = argv[3:]
        for run in ("warm_", ""):
            records = train_main.main(args)["records"]
            steady = sorted(r["update_seconds"] for r in records[1:])
            out[f"{run}ms_per_update"] = steady[len(steady) // 2] * 1e3
            out[f"{run}losses"] = [r["loss"] for r in records]
    elif argv[2:3] == ["--grouped"]:
        out.update(ab_grouped(torch))
    elif argv[2:3] == ["--lora"]:
        out.update(ab_lora(torch))
    elif argv[2:3] == ["--tenants"]:
        out.update(ab_tenants(torch))
    elif argv[2:3] == ["--paged"]:
        out.update(ab_paged(torch))
    elif argv[2:3] == ["--drains"]:
        out["flags"] = argv[3:]
        out.update(ab_drains(torch, spec="--no-spec" not in argv[3:]))
    elif argv[2:3] == ["--sass"]:
        from relora_tpu_torch.ops import _build

        out["sass"] = {name: sass_digests(path) for name, path in _build.build_all().items()}
    else:
        from relora_tpu_torch.ops import flash_attention as FA

        B, S, N, n_kv, H, dtype = FLASH_CASES[0]
        q, k, v, dout = make_flash_case(torch, torch.device("cuda"), B, S, N, n_kv, H, dtype, seed=99)
        scale = H**-0.5
        o, lse = FA.flash_attention_forward(q, k, v, scale)
        bwd = (q, k, v, dout, lse, FA.flash_attention_delta(o, dout), scale)

        def fwd_bwd():
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            return torch.autograd.grad(FA.flash_attention(*leaves), leaves, dout)

        for key, fn in (
            ("forward_ms", lambda: FA.flash_attention_forward(q, k, v, scale)),
            ("dkdv_ms", lambda: FA.flash_attention_bwd_dkdv(*bwd)),
            ("dq_ms", lambda: FA.flash_attention_bwd_dq(*bwd)),
            ("backward_ms", lambda: (FA.flash_attention_bwd_dkdv(*bwd), FA.flash_attention_bwd_dq(*bwd))),
            ("fwd_bwd_ms", fwd_bwd),
        ):
            out[key] = time_ms(torch, fn, iters=100)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(ab(sys.argv[1:]) if sys.argv[1:2] == ["--ab"] else main())
