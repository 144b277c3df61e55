"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, all run every time, each printing labelled lines; any failure
raises and the script exits non-zero:

1. device    the card's name and power limit (nvidia-smi); every number
             below belongs to this card.
2. build     compiles every CUDA kernel from the sources in this checkout,
             one nvcc per source, all started together; prints ptxas'
             registers, spills and static shared memory for every kernel
             instantiation, by name; then the native page allocator
             (native/allocator.cc, g++), which must load.
3. kernel    the paged-attention kernel (split-KV + merge) against its
             plain PyTorch version and the plain version of its split
             decomposition at Llama-3-8B main-path shapes (S=8, Nq=32, Kv=8,
             H=128, page=16, max_pages=128, ragged lengths incl.
             0/1/17/2048): bf16 pool without and with the window (W=2,
             W=64), all 8 slots at 2048 tokens, int8 pool with the window,
             f32 pool. Tolerances: max abs error bf16 2e-2, f32 1e-4 (TF32
             off); per slot, max abs error over the slot's max |output|
             bf16 1e-2, f32 1e-4, so a long slot's small outputs are held
             too; a slot with nothing to attend must give exactly 0; a
             second launch must give the same bits (no atomics).
             Times: kernel (CUDA events, median, L2 flushed before each
             launch as a decode step finds it, the device kept busy while
             the host enqueues, see _time_ms), plain version, the bound
             (bytes moved / the card's memory bandwidth, or operations /
             peak, whichever is larger), and scaled_dot_product_attention
             over the pre-gathered dense K/V as a yardstick that excludes
             the page walk.
4. flash     the two flash kernels against their plain version at
             Llama-3-8B shapes (Nq=32, Kv=8, H=128): fresh B=4, T=1024 bf16
             causal, ragged T=1000, non-causal, GPT-2 heads (Nq=Kv=12,
             H=64), f32 T=256; warm B=4, T=512
             over a 2048-row prefix with prefix_len 0/17/512/1536 (rows
             past it hold large garbage), bf16 float prefix and int8
             prefix, f32 float prefix at T=256. bf16 runs the tensor-core
             kernel, f32 the CUDA-core one. Tolerances: bf16 2e-2
             absolute; per (batch row, 64-row query tile, head), max
             error over max |ref| 1e-2; and every element within
             2**-7 * (|ref| + sum_j p_j |v_j| / l), the output's rounding
             on both sides plus that of probabilities rounded to bf16.
             f32 1e-4 absolute and per tile. bf16 at H = 64 and 128 runs
             the wgmma kernels, fresh and warm. A second launch must give
             the same bits.
             Times as above; the yardstick is scaled_dot_product_attention
             (is_causal, enable_gqa) for the fresh kernel and, for the warm
             one, the same call over [live prefix ‖ chunk] with an explicit
             mask and K/V concatenated beforehand.
5. ring      the ring-attention kernels' partial stats (m, l, acc) against
             their plain version at Llama-3-8B shapes (Nq=32, Kv=8,
             H=128), bf16 on the tensor cores (T > 1 on the wgmma kernel):
             the diagonal ring block of a 4096-token prompt on 2 shards
             (T=S=2048), an earlier block (every key live), a later block
             (every key masked: exactly m=-1e30, l=0, acc=0), a ragged
             block with INVALID_POS keys over large garbage, int8 codes +
             scales; one decode token against 2048 keys (the T = 1 split
             kernel): bf16, int8, f32, and 4 batch rows at different
             positions (the split plain version too); f32 on the CUDA
             cores at T=256; the tiny preset's heads (Nq=4, Kv=2, H=16)
             on the CUDA-core routes in bf16 and f32, T=1024 and T = 1;
             f16 on the tensor-core routes (the diagonal block and a
             decode token). Tolerances (f16 as bf16): m 1e-3 absolute, l 2**-7
             relative, the finalised acc/l per element within the flash
             phase's bound and per 64-row tile 1e-2; f32 1e-4. A second
             launch must give the same bits. Times as above; the
             yardstick is scaled_dot_product_attention with the boolean
             position mask (enable_gqa), which returns the normalised
             output, not the stats.
6. serve     `butterfly serve` machinery (serve/server.build_serving) on
             full-width, full-depth Llama-3-8B with random bf16 weights
             and the CLI's serve defaults (mixed dispatch), in a thread on
             127.0.0.1; 8 concurrent greedy /generate requests (prompts of
             16-1200 bytes, 32-64 new tokens) so prefill lanes and decode
             steps share ticks. Kernel launch counts are zeroed just before
             and read just after; the paged kernel must have launched, a
             multiple of 32 times (one launch per layer per decode step).
             The scheduler must run on the native page allocator.
             These weights are built once; every later engine shares them.
7. parity    on the same engine, one decode step through all layers with
             equal carries, bf16: each layer's kernel output against the
             plain version on the same inputs (2e-2 absolute), and the
             step's logits with the kernel against the same step with the
             plain version (0.5 absolute).
8. profile   where one decode step's time goes: host wall vs device busy
             time (torch.profiler), the paged kernels' share (split +
             merge) and the top kernels by device time.
9. generate  InferenceEngine.generate on the same model: four greedy
             prompts of 16-1000 bytes, 32 new tokens, fused, then the same
             stepped (tokens must be equal), then int8 KV (the
             write-combined window loop), then one call of the CLI's
             `generate`. The fresh flash kernel must launch 32 times per
             prefill call, the warm one never. Tokens/s and prefill time.
10. alternate the alternating serving path: ServingEngine(mixed_dispatch=
             False) + Scheduler, 8 concurrent greedy requests with prompts
             up to 1200 bytes, so 512-token chunks continue warm. The
             fresh, warm and paged kernels must each launch, a multiple
             of 32 times. Tokens/s and TTFT (a smoke run, not a benchmark).
11. flashpar on that engine, one fresh 512-token prefill and one warm
             chunk after it through all 32 layers: every layer's flash
             output against the plain version on the same inputs, each
             element within the flash phase's bound (one bf16 ulp scaled
             to the output), and each pass's last-token logits against
             the all-plain pass (0.5 absolute).
12. longgen  InferenceEngine.generate_long over a seq = 2 mesh (one shard
             per card with two cards, else both on cuda:0; printed) on the
             shared weights: a 4096-token prompt, 32 greedy new tokens,
             ring with bf16 KV, ring with int8 KV, Ulysses. The ring
             kernel's launches must be exact per route (N*N per layer for
             the prefill, on the wgmma kernel; N + 1 per layer per decode
             step, on the T = 1 split kernel); the prefill's last-position
             logits within 0.5 of the dense flash prefill (int8: of the
             same prefill with the plain ring version). Tokens/s and the
             prefill time; under the profiler, the long prefill's ring
             share and the decode steps' ring time per token.
13. ringpar  one sp_forward of that prompt: every ring block's kernel stats,
             finalised, against the plain version on the same inputs
             within the ring phase's element bound; the logits against the
             all-plain pass within 0.5.
14. longserve ServingEngine(seq = 2, seq_parallel_threshold=1024,
             max_seq_len=4096) + Scheduler, mixed dispatch: 2 long prompts
             (3000 and 4000 bytes) and 4 short ones, greedy. The lane must
             prefill tokens; ring (all T > 1: the wgmma kernel) and paged
             launches multiples of 32; every request finishes. Tokens/s
             and TTFT.
15. quant    int8 weights (quant/int8.py) on the shared weights:
             quantize_int8 and the int8 tree's bytes (codes held as
             int8); one prefill + decode step's logits against the same
             step on the maybe_dequant bf16 tree (0.5 absolute, the
             parity phase's bar); generate (4 greedy prompts of 16-1000
             bytes, 32 new tokens, fused then stepped: equal tokens, the
             fresh flash kernel 32 times per prefill); 8 concurrent
             greedy requests through serve/server.build_serving with
             --quant int8 (paged launches a multiple of 32); one decode
             step's host wall and device busy time and decode tok/s,
             int8 and bf16 weights.
16. spec     speculation (ServingEngine + Scheduler) on the shared bf16
             weights, 8 greedy requests on draft-friendly prompts (32
             tokens: 8 random + the model's own greedy continuation, as
             run_spec_benchmark builds them), 32 new tokens: (a) ngram,
             gamma 4, the serve defaults (mixed dispatch, window on),
             and the same block with an oracle draft function
             registered through register_draft_source, which proposes
             the spec-off run's tokens: random weights never repeat
             themselves, so prompt lookup finds nothing to accept and
             the oracle drives the accept path;
             (b) the 8-layer draft model (the alternating fallback:
             fresh / warm flash launches multiples of 32); (c) a width-2,
             5-node token tree with that draft; (d) generate_speculative
             on one prompt; (e) (a) at temperature 0.8, which must
             finish. For (a)-(d) every request finishes, verify forwards
             happen, the oracle run accepts drafts, and a teacher-forced
             check: in
             one plain forward of prompt + output, every emitted token's
             logit is within 0.5 of that position's maximum. Prints
             tokens per forward, acceptance rate, tok/s and, against the
             spec-off run, the requests with equal tokens and the first
             divergence of the others (bf16 verify and decode take
             different attention paths, so near-ties may flip).
17. fleet    `butterfly fleet` on the shared tree cut to 8 layers at full
             width (FLEET_LAYERS; views of the one tree): the native
             allocator is built in phase 2 (the serve phase runs on it;
             fleet replicas run the prefix-caching allocator, whose
             registry KV transfer addresses); fleet/harness.start_fleet(
             "2p2d") on the shared bf16 weights (one tree: the memory
             rise at start must stay under 8 GiB; the teacher-forced
             check runs on the same cut tree), page 16, 4 slots of
             1024 tokens, threshold 64, behind the control plane. 8
             greedy requests of 384 tokens (half share a 256-token head),
             32 new, from 4 client threads: a direct run (threshold
             10**9), then the disaggregated run (prefill leg, GET
             /kv/pages, POST /kv/import, decode leg), where every request
             must be disaggregated and pages transferred; per request the
             first divergence from the direct run (bf16 near-ties may
             flip) and a teacher-forced check (every emitted token's
             logit within 0.5 of its position's maximum in one plain
             forward). Then an export -> import -> export of a fresh
             prompt's pages (identical page bytes), a drained restart of
             one decode replica under load (nothing dropped), spawn and
             retire of a decode replica (memory back within one pool).
             Prints the legs' median seconds (control-plane tracer),
             TTFT p50/p95 of both runs, transfer bytes, the payload's
             raw and JSON bytes and each replica's tick host share; the
             paged kernel must launch.
18. bench    the benchmark legs (obs/benchmark.py) on the same weights,
             sized by request counts: decode (batch 8, prompt 128, 64
             new: tokens/s per card, hbm_util, mfu against the card's
             datasheet row), serving (8 requests, 128 + 32 tokens, 8
             slots, int8 pool; TTFT/ITL; its _alt leg on the flash
             kernels; on the tree cut to 8 layers), warm prefill (6 x
             640-token prompts in 256-token chunks, warm flash kernel vs
             the dense gather, one repeat; on the tree cut to 8 layers),
             long context
             (the ring microbench pair; the serving lane needs 4 cards),
             mixed (12 mixed_chat requests in one burst on a starved pool
             of 8-token pages with prefix caching and a 512 MiB host KV
             tier, 2 of the 4 operating points of the 2x2 sweep, (1, 1)
             and (4, 1), the _alt leg; on the tree cut to 8 layers),
             decode once more on the int8 tree, speculation (spec on vs
             off on draft-friendly prompts, then the ngram, 1-layer model
             and width-2 tree rows on mixed_chat prompts; verify forwards
             must happen; on the tree cut to 8 layers), the fleet (nothing dropped through the
             rolling restart, pages transferred), chaos (every request
             terminal, faults injected) and autoscale (a scale-up in the
             flight recorder; 12 requests of 64 new tokens a client, so
             one replica cannot keep up) legs at their JAX defaults on tiny-model
             fleets; then `butterfly bench --model tiny
             --device cuda --serving`. Each leg's JSON on a labelled line
             with its wall seconds (`layers=8` on the cut legs' lines).
             Prefix hits, preemptions and tier revivals must be > 0, the
             ring microbench kernelized, and each of the four kernels
             must launch.
18b. tools   the port's tools (butterfly_tpu_torch/tools/) on the bench
             phase's tree cut to 8 layers at full width, int8 KV pools:
             profile_decode's default, serving, pipeline, spec and
             prefill modes through their functions (batch 8, prompt 128,
             16 new, 4 steps a block), long context on a seq = 4 mesh of
             four shards on cuda:0; each prints its trace window's wall,
             device busy, idle share and top kernel ([tools] mode=...),
             and its kernel must have run: paged inside the window of
             the serving and pipeline blocks, ring and paged inside the
             long-context one, fresh flash (default, prefill) and paged
             (spec, whose verify attends through the dense gather) by
             their launch counters over the mode; then tp_scaling's
             collectives of one decode step at tensor = 2 and 8 (every
             shard on cuda:0, so copies, not NVLink): 2 reductions of
             [8, 1, 4096] a layer.
19. ckpt     checkpoints, snapshots and profiles on the serve phase's
             Llama-3-8B tree cut to 8 layers at full width (5.6 GB; the
             time limit): written as an HF directory under the
             git-ignored build/ (config.json and 4 model-*.safetensors by
             this script's own writer and inverse map; GB, seconds,
             GB/s), config_from_hf_dir giving back llama3_8b()'s fields
             at that depth; `serve --model llama3-8b --ckpt DIR` through
             build_serving with the preset resolved at that depth (the
             only step the CLI does not run), its load_checkpoint on cuda:0 timed
             and watched (seconds, GB/s, host RSS peak growth, the card's
             allocation peak over the tree, which must stay under 1.25x:
             no float32 copy) and every leaf torch.equal to the source;
             8 greedy requests over HTTP (HTTP 200, token counts, paged
             launches a multiple of 8) with a 500 ms POST /debug/profile
             among them, sent once all 8 are in and every live one
             decodes (blocks with prefill lanes attend through the dense
             gather; HTTP 200; its Chrome trace must name a
             paged_*_kernel; MB and events); 4 prompts submitted before
             the first tick of a scheduler on the loaded tree and of one
             on the in-memory tree: identical greedy tokens (48 new); a
             serving snapshot on the loaded tree, taken once each of the
             4 requests has 4+ tokens and restored into a fresh
             scheduler: the continuations equal to the uninterrupted run
             and the first divergence of the others reported (the
             restore recomputes the partial outputs through the bf16
             prefill path, which may flip near-tied tokens of random
             weights), their teacher-forced gap held to LOGITS_TOL; the
             CLI's `generate --ckpt` (8 fresh flash launches, counts
             zeroed just before; the text of the same generate on the
             in-memory tree); the snapshot again in float32 at 4 layers,
             loaded from the same directory: every continuation equal to
             the uninterrupted run; save_checkpoint then
             load_sharded onto the one-card tensor = 2 mesh at 4 layers:
             every shard equal to shard_params's (seconds, GB/s, bytes
             allocated). The directories are removed at the end.
20. tp       tensor and data parallelism on one card (every shard on
             cuda:0, make_mesh(MeshConfig(...), ["cuda:0"] * n)) on the
             shared Llama-3-8B trees: shard_params at tensor = 2 (the
             parts must be views: nothing allocated); tensor = 2 serving
             at full width and depth, the serve defaults, 4 greedy
             requests of 16-1000 bytes (every other serve-phase size)
             with 32 new tokens (tok/s, TTFT
             p50, requests equal to the serve phase's and the
             teacher-forced gap of the others, pool bytes per shard);
             one windowed decode step on a pool of random K/V, tensor = 2
             against unsharded: each shard's paged kernel against its
             plain version (2e-2) and the step's logits within max(0.5,
             the same run's unsharded kernel-vs-plain gap); a decode
             step's profile against the unsharded one (host wall, device
             busy, idle share, top kernels, and copies whose input is a
             weight: none expected); the alternating path at tensor = 2
             (fresh and warm flash per shard); tensor = 8 generate on
             the tree cut to 8 layers at full width (4 prompts of
             17-1001 tokens, 32 new, fused: fresh flash at Nq 4, Kv 1 per
             shard) against unsharded at that depth, and the decode-step
             check at tensor = 8 at that depth (the paged kernel at
             Kv = 1); tensor = 4
             x data = 2 serving at full width and 4 layers with prefix
             caching (3 requests sharing a prompt: hit tokens >= 16,
             tokens against the unsharded engine at that depth); the int8
             tree at tensor = 2 (the decode-step check); the bench decode
             leg at tensor = 2 beside the unsharded one. One card moves
             no byte between shards: reductions over NVLink are not
             measured.
21. moe      Mixtral-8x7B at full width and depth on int8 weights, once
             the Llama-3-8B trees are freed (memory_allocated logged at
             each step): the tree drawn by the CLI's loader
             (init_params_quantized on a seed-0 cuda generator; its GB,
             the codes' GB, the scales' MB, 8 quantized leaves); 8
             greedy requests of 16 new tokens through
             serve/server.build_serving at the serve defaults (paged
             launches a multiple of 32; TTFT p50, tok/s, tick host
             share); the parity phase's check on that pool (each layer's
             paged kernel against its plain version, 2e-2, and the
             step's logits, 0.5); one decode step's host wall, device
             busy time and the MoE blocks' share of it; generate (4
             prompts of 17-1001 tokens, 16 new, fused then stepped: equal
             tokens, fresh flash launches a multiple of 32), then the
             CLI's `generate` and the bench decode leg through `butterfly
             bench` (batch 8, 128 + 16: tok/s per card, hbm_util, mfu),
             both `--model mixtral-8x7b --quant int8` handed that tree. Then the expert axis on one card, expert = 2 with both
             shards on cuda:0: the expert slices must be views of one
             tree (nothing allocated by the sharding); (a) f32, full
             width, 2 layers, no-drop capacity: a 256-token prefill (the
             a2a path) and 8 decode steps (the einsum path), logits
             within 1e-4 x max |dense| of the dense forward and equal
             greedy tokens; (c) capacity factor 1.0: finite logits and
             each layer's dropped assignments; (b) bf16, full width, 4
             layers: 8 greedy requests through ServingEngine on the
             expert mesh against a dense engine (equal requests, first
             divergences and the teacher-forced gap reported: bf16
             near-ties may flip).
22. combined meshes that combine axes, every shard on cuda:0 (no byte
             crosses NVLink), in two parts. After the tp phase, on the
             Llama-3-8B tree at full width and depth: all_hosts_probe
             over the visible cards; seq = 2 x tensor = 2 (the placement
             must allocate nothing): one sp_forward of the longgen
             phase's 4096-token prompt with every ring block's kernel
             stats, per tensor shard at Nq 16 / Kv 4, finalised, against
             the plain version (2e-2 absolute and the ring phase's
             element bound), its last-position logits within 0.5 of the
             longgen phase's seq-only ring run, then generate_long with
             16 greedy new tokens (ring launches exact per tensor shard)
             and the long prefill's host wall, device busy and ring time;
             seq = 2 x data = 2 serving at the serve defaults with
             seq_parallel_threshold 1024 and one pool copy per data
             group: the 16-, 200-, 4000- and 600-byte requests of the
             longserve phase (the 4000-byte one through the lane), the
             lane's tokens > 0, both pool replicas equal byte for byte,
             greedy tokens against the longserve run (equal count, first
             divergences, the teacher-forced gap of the others within
             0.5). After the moe phase, on its bf16 4-layer Mixtral tree:
             expert = 2 x tensor = 2 and expert = 2 x data = 2, each:
             the placement allocates nothing; 8 greedy requests through
             ServingEngine (against the moe phase's dense run: equal
             count and first divergences); InferenceEngine.generate of 4
             prompts (fresh flash 8 launches: 4 layers x 2 tensor shards
             or data groups); one decode step against the unsharded
             step, routing replayed, within max(0.5, the two plain
             versions' gap); a 2 x 256-token prefill at capacity factor
             1.0: the a2a's dropped assignments equal the count of the
             dense routing over the whole batch, layer by layer. Then the
             meshes that combine seq with expert and stage with expert
             on that tree: seq = 2 x expert = 2 (the engine's placement
             allocates nothing): one sp_forward of a 2048-token prompt
             with every ring block's kernel stats of each seq shard
             against the plain version (2e-2 and the ring phase's element
             bound), the same prefill at capacity factor 1.0 (each seq
             shard's a2a drops, counted, equal to the dense routing's
             count over its chunk), then generate_long with 16 greedy new
             tokens (ring launches exact) against the unmeshed generate;
             stage = 2 x expert = 2 (the placement allocates nothing):
             GPipe generate of the 4 prompts (16 new; fresh flash 16
             launches: 4 layers x 4 microbatches), serving of 4 requests
             of 16-400 bytes with 8 new tokens on 8 slots (paged launches
             a multiple of 4), one decode step with each stage's in-model
             paged kernel against its plain version (2e-2), a 2 x
             256-token pipelined prefill at capacity factor 1.0 (the
             a2a's drops equal the dense routing's count); tokens equal
             to the unmeshed runs or their teacher-forced gap within 0.5.
             The part's seconds go on the [clock] line after it.
23. pipe     pipeline stages on one card, after the combined phase's
             Llama half (every stage's shards on cuda:0,
             make_mesh(MeshConfig(stage=2), ["cuda:0"] * 2); [pipe]
             step=... lines with their seconds): shard_params at stage = 2
             (each stage's layers views of the one tree: nothing
             allocated); stage = 2 serving at the serve defaults, M = 4
             microbatches of 2 slots, the serve phase's 8 greedy requests
             with 16 new tokens through the GPipe schedule, on the tree
             cut to 8 layers at full width (4 layers a stage; at full
             depth this step alone took 45.2 s, over the phase's 60 s
             with the rest) against the unsharded engine at that depth
             (tok/s, TTFT p50, pool bytes per stage, paged launches a
             multiple of 32; equal count, first divergences, the
             teacher-forced gap of the others within 0.5); one decode
             step at full width and depth with the window off, stage = 2
             against unsharded: each stage's in-model paged kernel
             against its plain version (2e-2) and the step's logits
             within max(0.5, the same run's unsharded kernel-vs-plain
             gap); then on the tree cut to 8 layers, each against the
             unsharded engine at that depth: GPipe generate (4 prompts of
             17-1001 tokens, 16 new; fresh flash 32 launches: 8 layers x
             4 microbatches, counts zeroed just before), the interleaved
             schedule (virtual_stages 2, its placement's allocated bytes:
             0), serving (4 requests of 16-400 bytes, 8 new, 8 slots)
             with the int8 pool at stage = 2, at stage 2 x tensor 2 and at
             stage 2 x data 2; then speculative serving with a 6-layer
             draft model at stage = 2 (4 layers a stage: the draft's
             layers are views of both stages' slices), 4 requests x 8
             new, against the unsharded speculative run at 8 layers
             (equal tokens or the teacher-forced gap within 0.5); then
             stage = 2 x seq = 2 generate at 8 layers (seq a replica:
             fresh flash 32 launches, the placement allocates nothing)
             against the unsharded run, and generate_long there refused
             with the JAX engine's NotImplementedError.
24. multihost a mesh over two processes on one card, after pipe: the
             script starts itself twice as workers (`--multihost-worker
             PID PORT DIR`, each on cuda:0; a gloo rendezvous at
             127.0.0.1 on a free port, a 60 s collective timeout each;
             the parent waits at most 300 s and kills what is left).
             Each worker: (a) the JAX worker's sum (pid + 1, all-reduced
             on the card: 3), all_hosts_probe() across both, the ms of a
             16 KB and an 8 MB all-reduce, an 8 MB send/receive each way
             at once (the pipeline's hand-off, staged through the host)
             and an 8 MB all-to-all; then five meshes across the two
             processes, in turn: tensor = 2, data = 2 inside each
             process beside tensor = 2 across (data2_tensor2: two
             shards a worker on its card, each worker its own slice of
             make_hybrid_mesh with dcn_axes=("tensor",)), stage = 2
             and seq = 2 on Llama-3-8B at full width, 4 layers, and
             expert = 2 on Mixtral-8x7B at full width, 2 layers (the
             expert dispatch), each bf16 from seed 0, drawn on the card
             and kept on the host. On each:
             (b) placed across the two processes (global devices,
             make_hybrid_mesh): the bytes the placement asked the
             allocator for must equal its share (half of every leaf
             split over the axis, the whole of the rest), nothing for
             the other process's part; (c) greedy generate of 4 prompts
             of 16-1000 bytes (16 new, 8 on data2_tensor2; under
             expert the longest cut by a
             token so the padded length is even and the prefill takes
             the a2a path) and the same 4 requests through a Scheduler
             over a ServingEngine at the serve defaults, collectives
             counted (calls by kind, MB, host s), then one decode step
             with each local shard's or stage's in-model paged kernel
             against the plain version (2e-2; under stage the window
             off, through the GPipe schedule) and the step's logits
             checksum; on tensor = 2 a data = 2 mesh across the two
             processes must be refused at engine construction. On seq
             = 2 (c) is generate_long of the 4096-token prompt (16
             new): ring, Ulysses and ring over the int8 KV, the ring
             launches exact (a worker its own shard's blocks), then the
             4 prompts through the Scheduler with the long-prompt lane
             at threshold 512 (its token count > 0 and equal in all
             three runs), then every ring block of a short
             generate_long (bt_ring_stats at the prefill, bt_ring_decode
             at the decode step) against the plain version within the
             ringpar element bound, and the step check. The
             parent then runs the same trees, paths and steps in one
             process on cuda:0. Both workers' tokens and checksums must
             be equal, byte for byte, and equal to the one-process run's
             (tensor across: or, for a token row that differs, the
             teacher-forced gap within 0.5). The one-process runs'
             launches are this phase's main-path counts; the workers'
             are logged.

Runs cut, with their depth (PERF.md section 4): the tp phase's tensor =
8 generate and its step check at 8 layers; the bench phase's mixed leg
sweeps 2 of its 4 operating points; the bench phase's serving,
warm-prefill, mixed and spec legs on the tree cut to 8 layers (their
[bench] lines say layers=8); the fleet phase on the tree cut to 8
layers; the pipe phase's stage = 2 serving and its generate and mesh
runs at 8 layers; the ckpt phase's tree at 8 layers; the pipe phase's
stage = 2 serving and generate and the moe phase's int8 serving,
generate, CLI generate and bench decode leg at 16 new tokens (32, and
64 for the bench leg, until the multihost phase took stage = 2 and
expert = 2); the tp phase's tensor = 2 serving on 4 of the serve
phase's 8 requests (every other size; 8 until the multihost phase took
seq = 2 and data2_tensor2); the multihost phase's data2_tensor2
generate and serving at 8 new tokens (the other meshes 16). Every other
phase
keeps its size. The CUPTI subscription of torch's profiler is torn down
after each capture (TEARDOWN_CUPTI=1, set before torch loads).

The second-to-last line is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Without CUDA the script exits non-zero
and prints no result.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))



def log(label: str, **kv) -> None:
    print(f"[{label}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def figures(name: str):
    """(memory bandwidth bytes/s, dense peak op/s by type) of the card
    called `name`, from the port's datasheet table
    (butterfly_tpu_torch/obs/benchmark.py: CARDS); every bound below is
    taken against it. A card not in the table has no bound: raise."""
    from butterfly_tpu_torch.obs.benchmark import card_figures
    fig = card_figures(name)
    if fig is None:
        raise RuntimeError(f"no datasheet figures for {name!r} "
                           f"(obs/benchmark.py CARDS)")
    return fig


# -- phase 3: the kernel against its plain version ---------------------------

def _kernel_case(torch, pa, S, Nq, Kv, H, page, mp, lengths, dtype, quant,
                 W, gen):
    dev = "cuda"
    P = S * mp + 1
    q = torch.randn((S, Nq, H), generator=gen, device=dev).to(dtype)
    if quant:
        kp = torch.randint(-127, 128, (P, Kv, page, H), generator=gen,
                           device=dev, dtype=torch.int8)
        vp = torch.randint(-127, 128, (P, Kv, page, H), generator=gen,
                           device=dev, dtype=torch.int8)
        ks = torch.rand((P, Kv * page), generator=gen, device=dev) * 0.02
        vs = torch.rand((P, Kv * page), generator=gen, device=dev) * 0.02
    else:
        kp = torch.randn((P, Kv, page, H), generator=gen, device=dev) \
            .to(dtype)
        vp = torch.randn((P, Kv, page, H), generator=gen, device=dev) \
            .to(dtype)
        ks = vs = None
    # each slot owns a random set of distinct pages; the rest of its row
    # points at the null page (P - 1)
    perm = torch.randperm(P - 1, generator=gen, device=dev).to(torch.int32)
    table = torch.full((S, mp), P - 1, dtype=torch.int32, device=dev)
    for s in range(S):
        n = -(-lengths[s] // page)
        table[s, :n] = perm[s * mp:s * mp + n]
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    win = {}
    wc_host = [0] * S
    if W:
        pool_dt = torch.int8 if quant else dtype
        shape = (S, Kv, W, H)
        if quant:
            win["win_k"] = torch.randint(-127, 128, shape, generator=gen,
                                         device=dev, dtype=pool_dt)
            win["win_v"] = torch.randint(-127, 128, shape, generator=gen,
                                         device=dev, dtype=pool_dt)
            win["win_k_scale"] = torch.rand(shape[:-1], generator=gen,
                                            device=dev) * 0.02
            win["win_v_scale"] = torch.rand(shape[:-1], generator=gen,
                                            device=dev) * 0.02
        else:
            win["win_k"] = torch.randn(shape, generator=gen,
                                       device=dev).to(pool_dt)
            win["win_v"] = torch.randn(shape, generator=gen,
                                       device=dev).to(pool_dt)
        # slot 0 is empty (lengths 0, win_count 0); the others stage a
        # ragged run up to the full width
        wc_host = [0] + [1 + (7 * s) % W for s in range(1, S)]
        win["win_count"] = torch.tensor(wc_host, dtype=torch.int32,
                                        device=dev)
    args = (q, kp, vp, table, lens, ks, vs)
    return args, win, wc_host


def _bytes_ops(args, win, lengths, wc, Nq, Kv, H, page, quant):
    """Bytes the function must move (each input byte it needs read once,
    the output written once) and the operations it does, for THIS data:
    the live tokens' K/V (+ scales), the table entries it walks, q, out."""
    q = args[0]
    el = 1 if quant else q.element_size()
    tok = sum(lengths) + sum(wc)
    kv_bytes = tok * Kv * H * el * 2
    scale_bytes = tok * Kv * 4 * 2 if quant else 0
    table_bytes = sum(-(-n // page) for n in lengths) * 4
    qo = q.numel() * q.element_size() * 2
    small = len(lengths) * 4 * (2 if win else 1)
    ops = tok * Nq * H * 4  # q.k and p.v, multiply-add each
    return kv_bytes + scale_bytes + table_bytes + qo + small, ops


def _time_ms(torch, fn, flush, reps=25):
    """Median device time of one call of `fn`, in ms: CUDA events around
    each call, the L2 flushed before it (a decode step or a prefill finds
    its operands cold), and the device kept busy by a spin while the host
    enqueues the call, so the wrapper's host time is not counted (for a
    kernel of tens of microseconds it can exceed the flush)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()  # evict L2: a decode step finds this layer's pages cold
        torch.cuda._sleep(1_000_000)  # ~0.5 ms: the host enqueues meanwhile
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _sdpa_yardstick(torch, args, win):
    """scaled_dot_product_attention over the pre-gathered dense K/V (the
    page walk excluded): one call computing the same attention."""
    F = torch.nn.functional
    q, kp, vp, table, lens, ks, vs = args
    S, _, H = q.shape
    _, Kv, page, _ = kp.shape
    mp = table.shape[1]

    def dense(pages, sc):
        x = pages[table.long()]
        if sc is not None:
            x = x.float() * sc[table.long()].reshape(S, mp, Kv, page)[..., None]
        return x.permute(0, 2, 1, 3, 4).reshape(S, Kv, mp * page, H)

    k, v = dense(kp, ks), dense(vp, vs)
    valid = torch.arange(mp * page, device=q.device)[None] < lens[:, None]
    if win:
        wk, wv = win["win_k"], win["win_v"]
        if "win_k_scale" in win:
            wk = wk.float() * win["win_k_scale"][..., None]
            wv = wv.float() * win["win_v_scale"][..., None]
        k = torch.cat([k, wk.to(k.dtype)], 2)
        v = torch.cat([v, wv.to(v.dtype)], 2)
        W = wk.shape[2]
        valid = torch.cat([valid, torch.arange(W, device=q.device)[None]
                           < win["win_count"][:, None]], 1)
    dt = q.dtype
    k, v = k.to(dt).contiguous(), v.to(dt).contiguous()
    qq = q[:, :, None, :]
    mask = valid[:, None, None, :]

    return lambda: F.scaled_dot_product_attention(
        qq, k, v, attn_mask=mask, enable_gqa=True)


def phase_kernel(torch, card):
    from butterfly_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_ref, paged_attention_split_ref)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    S, Nq, Kv, H, page, mp = 8, 32, 8, 128, 16, 128
    lengths = [0, 1, 17, 2048, 300, 1000, 1500, 64]
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    bw, peak = figures(card)
    # (name, q dtype, int8 pool, window width, abs tol, per-slot rel tol):
    # a bf16 output rounds to within one ulp, at most 2**-7 of its
    # magnitude, so per slot 1e-2 of the slot's max |output|
    # (name, q dtype, int8 pool, window width, abs tol, per-slot rel tol,
    # slot lengths)
    cases = [("bf16", torch.bfloat16, False, 0, 2e-2, 1e-2, lengths),
             ("bf16_w2", torch.bfloat16, False, 2, 2e-2, 1e-2, lengths),
             ("bf16_w64", torch.bfloat16, False, 64, 2e-2, 1e-2, lengths),
             ("bf16_all_long", torch.bfloat16, False, 0, 2e-2, 1e-2,
              [2048] * S),
             ("int8_w64", torch.bfloat16, True, 64, 2e-2, 1e-2, lengths),
             ("f32", torch.float32, False, 0, 1e-4, 1e-4, lengths),
             ("f32_w2", torch.float32, False, 2, 1e-4, 1e-4, lengths)]
    results = {}
    for name, dt, quant, W, tol, rel_tol, lens in cases:
        args, win, wc = _kernel_case(torch, paged_attention, S, Nq, Kv, H,
                                     page, mp, lens, dt, quant, W, gen)
        out = paged_attention(*args, **win)
        again = paged_attention(*args, **win)
        torch.cuda.synchronize()
        assert torch.equal(out, again), f"{name}: two launches differ"
        ref = paged_attention_ref(*args, **win)
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        split_err = (out.float() - paged_attention_split_ref(*args, **win)
                     .float()).abs().max().item()
        assert torch.isfinite(out.float()).all(), f"{name}: non-finite"
        assert err <= tol, f"{name}: max abs err {err} > {tol}"
        assert split_err <= tol, f"{name}: vs split plain {split_err}"
        # every slot but the empty slot 0, against its own output scale:
        # a page dropped or repeated in a long slot moves its small
        # outputs by far less than the short slots' absolute error
        slot_rel = (diff.amax(dim=(1, 2))[1:]
                    / ref.float().abs().amax(dim=(1, 2))[1:])
        rel = slot_rel.max().item()
        assert rel <= rel_tol, \
            f"{name}: per-slot rel err {slot_rel.tolist()} > {rel_tol}"
        # slot 0 attends nothing (lengths 0, win_count 0): exactly zero
        if lens[0] == 0:
            assert (out[0] == 0).all().item(), f"{name}: empty slot not zero"
        n0 = paged_attention.launches
        k_ms = _time_ms(torch, lambda: paged_attention(*args, **win), flush)
        assert paged_attention.launches > n0
        p_ms = _time_ms(torch, lambda: paged_attention_ref(*args, **win),
                        flush, reps=5)
        lib = _sdpa_yardstick(torch, args, win)
        l_ms = _time_ms(torch, lib, flush)
        nbytes, ops = _bytes_ops(args, win, lens, wc, Nq, Kv, H, page,
                                 quant)
        t_bytes = nbytes / bw * 1e3
        t_ops = ops / peak[str(dt).replace("torch.", "")] * 1e3
        bound = max(t_bytes, t_ops)
        results[name] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                             bound_ms=bound,
                             bound_by="bytes" if t_bytes >= t_ops
                             else "operations",
                             library_ms=l_ms, bytes=nbytes, tol=tol)
        log("kernel", case=name, max_abs_err=f"{err:.3g}", tol=tol,
            vs_split_plain=f"{split_err:.3g}",
            max_slot_rel_err=f"{rel:.3g}", rel_tol=rel_tol,
            kernel_ms=f"{k_ms:.4f}", plain_ms=f"{p_ms:.4f}",
            bytes=nbytes, bound_ms=f"{bound:.4f}",
            library_ms=f"{l_ms:.4f}(sdpa,excludes the page walk)",
            empty_slot="exact 0" if lens[0] == 0 else "none",
            relaunch="same bits")
    return results


# -- phase 4: the flash kernels against their plain version -----------------

_SP = 2048                       # prefix rows of the warm cases
_PLEN = [0, 17, 512, 1536]       # live prefix rows per batch row
_BQ = 64                         # query rows per kernel block
# (name, B, T, causal, dtype name, prefix: None | "float" | "int8",
#  abs tol, per-(row, query tile, head) rel tol): a bf16 output rounds to
# within one ulp, at most 2**-7 of its magnitude, hence 1e-2 of a block's
# max. bf16 takes the tensor-core kernel (flash_mma_kernel), f32 the
# CUDA-core one (flash_kernel).
FLASH_CASES = [
    ("fresh_bf16", 4, 1024, True, "bfloat16", None, 2e-2, 1e-2),
    ("fresh_bf16_T1000", 4, 1000, True, "bfloat16", None, 2e-2, 1e-2),
    ("fresh_bf16_noncausal", 4, 1024, False, "bfloat16", None, 2e-2, 1e-2),
    ("fresh_bf16_h64", 4, 1024, True, "bfloat16", None, 2e-2, 1e-2),
    ("fresh_f32", 4, 256, True, "float32", None, 1e-4, 1e-4),
    ("warm_bf16", 4, 512, True, "bfloat16", "float", 2e-2, 1e-2),
    ("warm_int8", 4, 512, True, "bfloat16", "int8", 2e-2, 1e-2),
    ("warm_f32", 4, 256, True, "float32", "float", 1e-4, 1e-4),
]


def _tile_rel_err(torch, diff, ref):
    """Max error over max |ref| per (batch row, tile of _BQ query rows,
    head): the block one kernel block computes, so a fault confined to
    late query tiles (whose outputs are small) is held to their scale."""
    F = torch.nn.functional
    B, T, Nq, H = ref.shape
    pad = -T % _BQ
    d = F.pad(diff, (0, 0, 0, 0, 0, pad)).reshape(B, -1, _BQ, Nq, H)
    r = F.pad(ref.float().abs(), (0, 0, 0, 0, 0, pad)) \
        .reshape(B, -1, _BQ, Nq, H)
    return (d.amax(dim=(2, 4)) / r.amax(dim=(2, 4)).clamp_min(1e-30)) \
        .max().item()


def _abs_v(args, kw):
    """The same flash call with |v| (and |prefix_v|): its plain output is
    sum_j p_j |v_j| / l for every output element."""
    args = list(args)
    args[2] = args[2].abs()
    kw = dict(kw)
    if kw.get("prefix_v") is not None:
        kw["prefix_v"] = kw["prefix_v"].abs()
    return args, kw


def _flash_bound_ratio(torch, flash_attention_ref, args, kw, diff, ref):
    """Max over elements of |kernel - plain| / bound, for a bf16 output;
    the kernel is right where this is <= 1. The bound is
    2**-7 * (|ref| + sum_j p_j |v_j| / l): both sides round the output to
    bf16 once (2**-8 of |x| each), and a kernel that rounds the
    probabilities to bf16 before P.V moves the output by at most 2**-8 of
    sum_j p_j |v_j| / l (taken twice, for slack). f32 summation order adds
    ~2**-20 of the same. It scales with each element, so it holds an
    output of magnitude 5 (ulp 0.03) and one of 0.01 alike."""
    a, k = _abs_v(args, kw)
    absv = flash_attention_ref(*a, **k).float()
    bound = 2.0 ** -7 * (ref.float().abs() + absv)
    return (diff / bound.clamp_min(1e-30)).max().item()


# (Nq, Kv, H) by case: Llama-3-8B's heads unless named here (GPT-2's)
_FLASH_HEADS = {"fresh_bf16_h64": (12, 12, 64)}


def _flash_inputs(torch, name, B, T, dt, prefix, gen):
    """q/k/v (+ the warm prefix, with large garbage past each row's
    prefix_len) on the card, and the args/kwargs of flash_attention."""
    Nq, Kv, H = _FLASH_HEADS.get(name, (32, 8, 128))
    dev = "cuda"

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dt)
    q, k, v = randn(B, T, Nq, H), randn(B, T, Kv, H), randn(B, T, Kv, H)
    kw = {}
    if prefix == "float":
        pk, pv = randn(B, _SP, Kv, H), randn(B, _SP, Kv, H)
        for b, n in enumerate(_PLEN):
            pk[b, n:] = 30.0
            pv[b, n:] = -30.0
        kw = dict(prefix_k=pk, prefix_v=pv)
    elif prefix == "int8":
        shape = (B, Kv, _SP, H)
        pk = torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8)
        pv = torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8)
        ks = torch.rand(shape[:-1], generator=gen, device=dev) * 0.02
        vs = torch.rand(shape[:-1], generator=gen, device=dev) * 0.02
        for b, n in enumerate(_PLEN):
            ks[b, :, n:] = 1.0
            vs[b, :, n:] = 1.0
        kw = dict(prefix_k=pk, prefix_v=pv, prefix_k_scale=ks,
                  prefix_v_scale=vs)
    if prefix is not None:
        kw["prefix_len"] = torch.tensor(_PLEN, dtype=torch.int32, device=dev)
    return q, k, v, kw


def _flash_bytes_ops(q, k, causal, kw):
    """Bytes the function must move (q, k, v and the output once, plus the
    LIVE prefix rows and their scales) and the operations it does (q.k and
    p.v over the live (query, key) pairs, a multiply-add each)."""
    B, T, Nq, H = q.shape
    Kv = k.shape[2]
    el = q.element_size()
    nbytes = 2 * q.numel() * el + 2 * k.numel() * el
    pairs = T * (T + 1) // 2 if causal else T * T
    ops = 4 * B * Nq * H * pairs
    if kw:
        live = int(kw["prefix_len"].sum().item())
        quant = "prefix_k_scale" in kw
        nbytes += 2 * live * Kv * H * (1 if quant else el) + 4 * B
        if quant:
            nbytes += 2 * live * Kv * 4
        ops += 4 * Nq * H * T * live
    return nbytes, ops


def _flash_yardstick(torch, q, k, v, causal, kw):
    """One scaled_dot_product_attention call computing the same function:
    over the chunk alone, or over [live prefix ‖ chunk] with an explicit
    mask (K/V concatenated, the int8 prefix dequantized, beforehand)."""
    F = torch.nn.functional
    qt = q.transpose(1, 2).contiguous()
    kt = k.transpose(1, 2).contiguous()
    vt = v.transpose(1, 2).contiguous()
    if not kw:
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True)
    pk, pv = kw["prefix_k"], kw["prefix_v"]
    if "prefix_k_scale" in kw:
        pk = (pk.float() * kw["prefix_k_scale"][..., None]).to(q.dtype)
        pv = (pv.float() * kw["prefix_v_scale"][..., None]).to(q.dtype)
    else:
        pk, pv = pk.transpose(1, 2), pv.transpose(1, 2)
    B, T = q.shape[:2]
    Sp = pk.shape[2]
    kc = torch.cat([pk, kt], dim=2).contiguous()
    vc = torch.cat([pv, vt], dim=2).contiguous()
    live_p = torch.arange(Sp, device=q.device)[None] < kw["prefix_len"][:, None]
    tri = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    mask = torch.cat([live_p[:, None, :].expand(B, T, Sp),
                      tri[None].expand(B, T, T)], dim=2)[:, None]
    return lambda: F.scaled_dot_product_attention(
        qt, kc, vc, attn_mask=mask, enable_gqa=True)


def phase_flash_kernel(torch, card):
    from butterfly_tpu_torch.ops.flash_attention import (flash_attention,
                                                         flash_attention_ref)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    bw, peak = figures(card)
    results = {}
    for name, B, T, causal, dts, prefix, tol, rel_tol in FLASH_CASES:
        dt = getattr(torch, dts)
        q, k, v, kw = _flash_inputs(torch, name, B, T, dt, prefix, gen)
        out = flash_attention(q, k, v, causal, **kw)
        again = flash_attention(q, k, v, causal, **kw)
        torch.cuda.synchronize()
        assert torch.equal(out, again), f"{name}: two launches differ"
        ref = flash_attention_ref(q, k, v, causal, **kw)
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        assert torch.isfinite(out.float()).all(), f"{name}: non-finite"
        assert err <= tol, f"{name}: max abs err {err} > {tol}"
        # per (batch row, query tile, head) against its own scale: a
        # dropped or repeated key tile near prefix_len or the diagonal
        # moves a few blocks only
        rel = _tile_rel_err(torch, diff, ref)
        assert rel <= rel_tol, f"{name}: per-tile rel err {rel} > {rel_tol}"
        checks = dict(max_tile_rel_err=f"{rel:.3g}", rel_tol=rel_tol)
        if dt == torch.bfloat16:
            ratio = _flash_bound_ratio(torch, flash_attention_ref,
                                       (q, k, v, causal), kw, diff, ref)
            assert ratio <= 1.0, f"{name}: element error {ratio} x bound"
            checks["max_err_over_elem_bound"] = f"{ratio:.3g}"
        entry = "launches_warm" if kw else "launches_fresh"
        n0 = getattr(flash_attention, entry)
        k_ms = _time_ms(torch, lambda: flash_attention(q, k, v, causal, **kw),
                        flush)
        assert getattr(flash_attention, entry) > n0
        p_ms = _time_ms(torch, lambda: flash_attention_ref(q, k, v, causal,
                                                           **kw),
                        flush, reps=3)
        l_ms = _time_ms(torch, _flash_yardstick(torch, q, k, v, causal, kw),
                        flush)
        nbytes, ops = _flash_bytes_ops(q, k, causal, kw)
        t_bytes = nbytes / bw * 1e3
        t_ops = ops / peak[dts] * 1e3
        bound = max(t_bytes, t_ops)
        results[name] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                             bound_ms=bound,
                             bound_by="bytes" if t_bytes >= t_ops
                             else "operations",
                             library_ms=l_ms)
        log("flash", case=name, card=card.replace(" ", "_"),
            heads="x".join(map(str, (q.shape[2], k.shape[2], q.shape[3]))),
            max_abs_err=f"{err:.3g}", tol=tol, **checks,
            kernel_ms=f"{k_ms:.4f}", plain_ms=f"{p_ms:.4f}",
            bytes=nbytes, ops=ops, bound_ms=f"{bound:.4f}",
            bound_by=results[name]["bound_by"],
            library_ms=f"{l_ms:.4f}(sdpa)")
        del q, k, v, kw, out, ref, diff
    return results


# -- phase 5: the ring kernel against its plain version ---------------------

_INVALID = 2**31 - 1
# (name, B, T, S, query start (one per batch row, or one for all), k
#  positions start, dtype name, int8 K/V, ragged): Llama-3-8B heads
# (Nq=32, Kv=8, H=128). diag is the diagonal ring block of a 4096-token
# prompt over 2 shards (each shard's own chunk), earlier a block every
# query sees whole, later a block every query must ignore, decode one
# token against a shard (the T = 1 split kernel; B4: four rows at four
# positions, one of which sees only the first split).
RING_CASES = [
    ("diag_bf16", 1, 2048, 2048, 0, 0, "bfloat16", False, False),
    ("earlier_bf16", 1, 2048, 2048, 2048, 0, "bfloat16", False, False),
    ("later_bf16", 1, 2048, 2048, 0, 2048, "bfloat16", False, False),
    ("ragged_bf16", 1, 1000, 2000, 1000, 0, "bfloat16", False, True),
    ("int8", 1, 2048, 2048, 0, 0, "bfloat16", True, False),
    ("decode_T1", 1, 1, 2048, 3000, 0, "bfloat16", False, False),
    ("decode_T1_int8", 1, 1, 2048, 3000, 0, "bfloat16", True, False),
    ("decode_T1_f32", 1, 1, 2048, 3000, 0, "float32", False, False),
    ("decode_T1_B4", 4, 1, 2048, [3000, 1000, 100, 2047], 0, "bfloat16",
     False, False),
    ("f32_T256", 1, 256, 256, 0, 0, "float32", False, False),
    # the CUDA-core routes at the tiny preset's heads (H = 16), and f16
    # on the tensor-core routes at Llama-3-8B's heads
    ("h16_bf16", 1, 1024, 1024, 0, 0, "bfloat16", False, False),
    ("h16_T1_bf16", 1, 1, 2048, 3000, 0, "bfloat16", False, False),
    ("h16_f32", 1, 1024, 1024, 0, 0, "float32", False, False),
    ("h16_T1_f32", 1, 1, 2048, 3000, 0, "float32", False, False),
    ("f16", 1, 2048, 2048, 0, 0, "float16", False, False),
    ("decode_T1_f16", 1, 1, 2048, 3000, 0, "float16", False, False),
]
#: (Nq, Kv, H) of the cases not at Llama-3-8B's heads: the tiny preset's
_RING_HEADS = {name: (4, 2, 16) for name in
               ("h16_bf16", "h16_T1_bf16", "h16_f32", "h16_T1_f32")}


def _ring_inputs(torch, B, T, S, q0, k0, dt, quant, ragged, gen,
                 heads=(32, 8, 128)):
    Nq, Kv, H = heads
    dev = "cuda"
    q = torch.randn((B, T, Nq, H), generator=gen, device=dev).to(dt)
    if quant:
        k = torch.randint(-127, 128, (B, Kv, S, H), generator=gen,
                          device=dev, dtype=torch.int8)
        v = torch.randint(-127, 128, (B, Kv, S, H), generator=gen,
                          device=dev, dtype=torch.int8)
        ks = torch.rand((B, Kv, S), generator=gen, device=dev) * 0.02
        vs = torch.rand((B, Kv, S), generator=gen, device=dev) * 0.02
    else:
        k = torch.randn((B, S, Kv, H), generator=gen, device=dev).to(dt)
        v = torch.randn((B, S, Kv, H), generator=gen, device=dev).to(dt)
        ks = vs = None
    starts = q0 if isinstance(q0, list) else [q0] * B
    qp = torch.stack([torch.arange(a, a + T, device=dev, dtype=torch.int32)
                      for a in starts])
    kp = torch.arange(k0, k0 + S, device=dev,
                      dtype=torch.int32)[None].repeat(B, 1)
    if ragged:
        # the unwritten tail and scattered holes carry INVALID_POS, and
        # their K/V rows hold large garbage that must never be attended
        bad = torch.rand((B, S), generator=gen, device=dev) < 0.1
        bad[:, 1900:] = True
        kp = torch.where(bad, torch.full_like(kp, _INVALID), kp)
        k[bad] = 30.0
        v[bad] = -30.0
    return (q, k, v, qp, kp, ks, vs)


def _ring_bytes_ops(args):
    """Bytes the block must move for THIS data (q once if any pair is
    live, the K/V rows (+ scales) some query attends, positions, the
    outputs once) and its operations (q.k and p.v on the live pairs)."""
    q, k, v, qp, kp, ks, vs = args
    B, T, Nq, H = q.shape
    quant = ks is not None
    Kv = k.shape[1] if quant else k.shape[2]
    live = kp[:, None, :] <= qp[:, :, None]               # [B, T, S]
    pairs = int(live.sum().item())
    keys = int(live.any(dim=1).sum().item())
    el = 1 if quant else k.element_size()
    nbytes = (qp.numel() + kp.numel()) * 4 + B * Nq * T * (H + 2) * 4
    if pairs:
        nbytes += q.numel() * q.element_size() \
            + 2 * keys * Kv * (H * el + (4 if quant else 0))
    return nbytes, 4 * Nq * H * pairs


def _ring_sdpa(torch, args):
    """One scaled_dot_product_attention call with the same boolean
    position mask (enable_gqa): the normalised output, not the stats."""
    F = torch.nn.functional
    q, k, v, qp, kp, ks, vs = args
    if ks is not None:      # int8 codes are already [B, Kv, S, H]
        k = (k.float() * ks[..., None]).to(q.dtype)
        v = (v.float() * vs[..., None]).to(q.dtype)
    else:
        k, v = k.transpose(1, 2), v.transpose(1, 2)
    qt = q.transpose(1, 2).contiguous()
    kt, vt = k.contiguous(), v.contiguous()
    mask = (kp[:, None, :] <= qp[:, :, None])[:, None]
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)


def _ring_check(torch, ra, args, stats, ref, bf16):
    """Hold the kernel's stats to the plain version's: (m err, l rel err,
    finalised output abs err, its element-bound ratio (bf16) or abs err
    (f32), tile rel err)."""
    m, l, acc = stats
    m_r, l_r, acc_r = ref
    masked = l_r == 0
    # a row with nothing live: exactly m = -1e30, l = 0, acc = 0
    assert (m[masked] == ra.NEG_INF).all() and (l[masked] == 0).all() \
        and (acc[masked] == 0).all(), "masked rows not exact"
    assert torch.isfinite(m).all() and torch.isfinite(l).all() \
        and torch.isfinite(acc).all(), "non-finite stats"
    m_err = (m - m_r).abs().max().item()
    l_rel = ((l - l_r).abs() / l_r.clamp_min(1e-30)).max().item()
    out = ra.finalize_stats(stats, torch.float32)
    out_r = ra.finalize_stats(ref, torch.float32)
    diff = (out - out_r).abs()
    if bf16:
        q, k, v, qp, kp, ks, vs = args
        absv = ra.finalize_stats(ra.ring_block_stats_ref(
            q, k, v.abs(), qp, kp, ks, vs), torch.float32)
        bound = 2.0 ** -7 * (out_r.abs() + absv)
        elem = (diff / bound.clamp_min(1e-30)).max().item()
    else:
        elem = diff.max().item()
    tile = _tile_rel_err(torch, diff, out_r) if out_r.abs().max() > 0 \
        else 0.0
    return m_err, l_rel, diff.max().item(), elem, tile


def phase_ring(torch, card):
    from butterfly_tpu_torch.ops import ring_attention as ra
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    bw, peak = figures(card)
    results = {}
    for name, B, T, S, q0, k0, dts, quant, ragged in RING_CASES:
        dt = getattr(torch, dts)
        bf16 = dt != torch.float32   # 16-bit: bf16 or f16
        heads = _RING_HEADS.get(name, (32, 8, 128))
        args = _ring_inputs(torch, B, T, S, q0, k0, dt, quant, ragged, gen,
                            heads)
        stats = ra.ring_block_stats(*args)
        again = ra.ring_block_stats(*args)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(stats, again)), \
            f"{name}: two launches differ"
        tol = dict(m=1e-3, l=2.0 ** -7, elem=1.0, tile=1e-2) if bf16 else \
            dict(m=1e-4, l=1e-4, elem=1e-4, tile=1e-4)
        refs = [ra.ring_block_stats_ref(*args)]
        if T == 1:   # the split kernel's own decomposition, in plain form
            refs.append(ra.ring_block_stats_split_ref(*args))
        # the worst of each error against either plain version
        m_err, l_rel, out_err, elem, tile = map(max, zip(*(
            _ring_check(torch, ra, args, stats, ref, bf16) for ref in refs)))
        assert m_err <= tol["m"], f"{name}: m err {m_err}"
        assert l_rel <= tol["l"], f"{name}: l rel err {l_rel}"
        assert elem <= tol["elem"], f"{name}: output err {elem}"
        assert tile <= tol["tile"], f"{name}: tile rel err {tile}"
        ref = refs[0]
        n0 = ra.launches
        k_ms = _time_ms(torch, lambda: ra.ring_block_stats(*args), flush)
        assert ra.launches > n0
        p_ms = _time_ms(torch, lambda: ra.ring_block_stats_ref(*args), flush,
                        reps=3)
        l_ms = None
        if name != "later_bf16":  # SDPA has no answer for an all-masked row
            l_ms = _time_ms(torch, _ring_sdpa(torch, args), flush)
        nbytes, ops = _ring_bytes_ops(args)
        t_bytes = nbytes / bw * 1e3
        t_ops = ops / peak[dts] * 1e3
        bound = max(t_bytes, t_ops)
        results[name] = dict(max_abs_err=out_err, ms=k_ms, plain_ms=p_ms,
                             bound_ms=bound,
                             bound_by="bytes" if t_bytes >= t_ops
                             else "operations", library_ms=l_ms)
        log("ring", case=name, card=card.replace(" ", "_"), B=B, T=T, S=S,
            heads="x".join(map(str, heads)),
            route=ra.ring_route(T, heads[2], dt),
            m_abs_err=f"{m_err:.3g}", l_rel_err=f"{l_rel:.3g}",
            out_abs_err=f"{out_err:.3g}",
            **({"max_err_over_elem_bound": f"{elem:.3g}"} if bf16 else {}),
            max_tile_rel_err=f"{tile:.3g}", kernel_ms=f"{k_ms:.4f}",
            plain_ms=f"{p_ms:.4f}", bytes=nbytes, ops=ops,
            bound_ms=f"{bound:.4f}", bound_by=results[name]["bound_by"],
            library_ms="none" if l_ms is None
            else f"{l_ms:.4f}(sdpa,normalised output)",
            relaunch="same bits")
        del args, stats, again, refs, ref
    return results


# -- phase 6: the serving path ------------------------------------------------

def _post(url, obj, timeout=600):
    req = urllib.request.Request(
        url + "/generate", data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def phase_serve(torch):
    from http.server import ThreadingHTTPServer

    from butterfly_tpu_torch.ops.paged_attention import paged_attention
    from butterfly_tpu_torch.serve.cli import build_parser
    from butterfly_tpu_torch.serve.server import (ServerState, build_serving,
                                                  make_handler)
    args = build_parser().parse_args(
        ["serve", "--model", "llama3-8b", "--device", "cuda",
         "--host", "127.0.0.1", "--port", "0"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    sched, tok, rt = build_serving(args)
    engine = sched.engine
    cfg = engine.cfg
    # the native free list, built in the build phase (no prefix caching)
    assert type(sched.alloc).__name__ == "NativePageAllocator", \
        type(sched.alloc).__name__
    log("serve", model=args.model, layers=cfg.num_layers,
        hidden=cfg.hidden_size, dtype=cfg.dtype, slots=rt.max_batch_size,
        max_seq=rt.max_seq_len, page=rt.page_size,
        mixed_dispatch=rt.mixed_dispatch,
        kv_write_combine=rt.kv_write_combine,
        allocator=type(sched.alloc).__name__,
        setup_s=f"{time.monotonic() - t0:.1f}")
    class Server(ThreadingHTTPServer):
        # the serve entrypoint's backlog (serve/server.py:serve_forever):
        # the default of 5 can reset some of 8 simultaneous connections
        request_queue_size = 128

    state = ServerState(sched, tok)
    state.thread.start()
    httpd = Server(("127.0.0.1", 0), make_handler(state))
    srv = threading.Thread(target=httpd.serve_forever, daemon=True)
    srv.start()
    url = f"http://127.0.0.1:{httpd.server_port}"
    sizes = [16, 64, 200, 400, 600, 800, 1000, 1200]
    news = [32, 40, 48, 56, 64, 32, 40, 64]
    prompts = [("The quick brown fox jumps over the lazy dog. " * 30)[:n]
               for n in sizes]
    results = [None] * len(sizes)

    def one(i):
        results[i] = _post(url, {"prompt": prompts[i],
                                 "max_tokens": news[i],
                                 "temperature": 0.0, "stop_token": -1})

    try:
        paged_attention.launches = 0
        t0 = time.monotonic()
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(sizes))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.monotonic() - t0
        launches = paged_attention.launches
    finally:
        state.stop.set()
        httpd.shutdown()
        httpd.server_close()
        if state.heartbeat is not None:
            state.heartbeat.stop()
        state.thread.join(timeout=30)
    for i, r in enumerate(results):
        assert r is not None, f"request {i} got no answer"
        code, body = r
        assert code == 200, f"request {i}: HTTP {code}"
        assert len(body["tokens"]) == news[i], \
            f"request {i}: {len(body['tokens'])} tokens, want {news[i]}"
        assert all(0 <= t < cfg.vocab_size for t in body["tokens"])
    gen_tokens = sum(len(b["tokens"]) for _, b in results)
    ttfts = sorted(b["ttft_s"] for _, b in results)
    assert launches > 0, "the paged kernel never launched on the main path"
    assert launches % cfg.num_layers == 0, \
        f"{launches} launches: not one per layer per decode step"
    log("serve", requests_answered=len(results), generated_tokens=gen_tokens,
        wall_s=f"{wall:.3f}", tokens_per_s=f"{gen_tokens / wall:.2f}",
        ttft_p50_s=f"{statistics.median(ttfts):.4f}",
        paged_attention_launches_before=0,
        paged_attention_launches_after=launches,
        decode_steps=launches // cfg.num_layers,
        max_memory_allocated_GiB=
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
        note="smoke run, not a benchmark")
    return engine, launches, tok, [b["tokens"] for _, b in results]


# -- phase 6: the kernel inside the model, against the plain version --------

LAYER_TOL = 2e-2   # bf16 tolerance of the kernel phase, absolute
LOGITS_TOL = 0.5   # ~2x the largest kernel-vs-plain gap seen on an H100


def phase_parity(torch, engine, label="parity"):
    """One windowed decode step through all 32 layers on the serve
    phase's pool (real K/V written by the requests), equal carries, bf16:
    every layer's kernel output against the plain version on the same
    inputs (bf16 tolerance 2e-2), and the step's logits with the kernel
    against the same step with the plain version at every layer. The
    dense gather + attend path's logits are reported beside them: it
    rounds the probabilities to bf16 before the P.V product, the kernel
    and the plain version do not.

    Tolerances: a layer's kernel output must match the plain version to
    LAYER_TOL absolute, the bf16 tolerance of the kernel phase; on an
    H100 the two differ by one bf16 ulp at most (7.8e-3 on outputs of
    magnitude 1-2). 32 layers of random weights amplify such ulps to
    0.21-0.23 on logits of magnitude ~6, so the step's logits must agree
    to LOGITS_TOL.

    An MoE model routes each token to its top-k experts, a discontinuous
    choice: one ulp of attention output can swap a token's k-th expert
    for a near-tied one, and that token's hidden state then moves by a
    whole expert's output. So for MoE the passes after the kernel's
    replay the kernel pass's expert choices (the gates still computed
    from each pass's own router logits), so a routing flip the kernel
    sets off is not counted as its error; the unpinned gap and the
    number of flips are printed beside it. LOGITS_TOL was measured on
    Llama-3-8B; on an MoE model the bound is the larger of it and the
    gap between the two plain versions (the plain kernel twin and the
    dense gather + attend path, routing replayed in both): the kernel
    may differ from the plain version by no more than the two plain
    versions differ from each other."""
    import butterfly_tpu_torch.models.common as common_mod
    import butterfly_tpu_torch.ops.paged_attention as pa_mod
    from butterfly_tpu_torch.cache.paged import (init_kv_window,
                                                 paged_forward_window)
    from butterfly_tpu_torch.ops.paged_attention import (paged_attention,
                                                         paged_attention_ref)
    cache = engine.cache
    S = engine.num_slots
    mp = cache.page_table.shape[1]
    page = cache.page_size
    lengths = [5, 100, 700, 1300, 0, 33, 64, 1000][:S]
    table = torch.full((S, mp), cache.null_page, dtype=torch.int32,
                       device="cuda")
    for s in range(S):
        n = -(-lengths[s] // page)
        table[s, :n] = torch.arange(s * mp, s * mp + n, dtype=torch.int32)
    c = cache._replace(page_table=table, lengths=torch.tensor(
        lengths, dtype=torch.int32, device="cuda"))
    win = init_kv_window(c, 64)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    for t in (win.k, win.v):
        t.copy_(torch.randn(t.shape, generator=gen, device="cuda") * 0.5)
    wlen = torch.tensor([3, 0, 10, 63, 0, 1, 7, 20][:S], dtype=torch.int32,
                        device="cuda")
    active = torch.tensor([n > 0 for n in lengths], device="cuda")
    toks = torch.randint(0, engine.cfg.vocab_size, (S, 1), generator=gen,
                         device="cuda", dtype=torch.int32)
    errs = []

    def checked(*args, **kw):
        out = paged_attention(*args, **kw)
        ref = paged_attention_ref(*args, **kw)
        errs.append((out.float() - ref.float()).abs().max().item())
        return out

    route_plain = common_mod.route_tokens
    chosen, flips = [], []

    def recorded(x, w, k):
        gates, idx = route_plain(x, w, k)
        chosen.append(idx)
        return gates, idx

    def replayed(x, w, k):
        # route_tokens' logits, with the kernel pass's choice of experts
        _, own = route_plain(x, w, k)
        idx = chosen[len(flips)]
        flips.append((own.sort(-1).values != idx.sort(-1).values)
                     .any(-1).sum())
        dt = torch.promote_types(x.dtype, w.dtype)
        logits = torch.einsum("btd,de->bte", x.to(dt), w.to(dt)).float()
        return torch.softmax(logits.gather(-1, idx), dim=-1), idx

    def step(attn, use_kernel=True, route=route_plain):
        flips.clear()
        # the sharded wrapper the layers call reads the module attribute
        pa_mod.paged_attention = attn
        common_mod.route_tokens = route
        try:
            logits, _ = paged_forward_window(
                engine.params, engine.cfg, toks, c, win, wlen,
                active=active, use_kernel=use_kernel)
        finally:
            pa_mod.paged_attention = paged_attention
            common_mod.route_tokens = route_plain
        torch.cuda.synchronize()
        return logits[:, 0][active].float()

    moe = engine.cfg.is_moe
    kern = step(checked, route=recorded if moe else route_plain)
    plain = step(paged_attention_ref, route=replayed if moe else route_plain)
    n_flips = int(sum(flips))
    dense = step(paged_attention, use_kernel=False,
                 route=replayed if moe else route_plain)
    assert len(errs) == engine.cfg.num_layers, errs
    layer_err = max(errs)
    for x in (kern, plain, dense):
        assert torch.isfinite(x).all()
    d_plain = (kern - plain).abs().max().item()
    d_dense = (kern - dense).abs().max().item()
    agree = (kern.argmax(-1) == plain.argmax(-1)).float().mean().item()
    extra, bound = {}, LOGITS_TOL
    if moe:
        free = step(paged_attention_ref)
        spread = (plain - dense).abs().max().item()
        bound = max(LOGITS_TOL, spread)
        extra = dict(
            routing="replayed_from_kernel_pass", routing_flips=n_flips,
            routed_tokens=sum(i.shape[0] * i.shape[1] for i in chosen),
            logits_plain_vs_dense=f"{spread:.4g}",
            logits_bound=f"{bound:.4g}",
            logits_kernel_vs_plain_unpinned=
            f"{(kern - free).abs().max().item():.4g}")
    log(label, layers=len(errs), max_layer_abs_err=f"{layer_err:.3g}",
        layer_tol=LAYER_TOL, max_abs_logit=f"{plain.abs().max().item():.4g}",
        logits_kernel_vs_plain=f"{d_plain:.4g}",
        logits_tol=LOGITS_TOL, argmax_agree_vs_plain=f"{agree:.3f}",
        logits_kernel_vs_dense=f"{d_dense:.4g}", **extra)
    assert layer_err <= LAYER_TOL, f"kernel vs plain in-model: {layer_err}"
    assert d_plain <= bound, \
        f"kernel vs plain logits differ by {d_plain} > {bound}"


# -- phase 7: where a decode step's time goes --------------------------------

def _decode_step_profile(torch, engine, steps=5, record_shapes=False):
    """Decode steps of the real engine path (mixed_block_async, k=1,
    C=1, every slot decoding at the lengths below) timed on the host
    clock with a device sync, then traced with torch.profiler (operator
    input shapes too with `record_shapes`). Returns (host ms per step,
    traced ms per step, device busy ms per step or 0.0 when the trace
    shows none, the profiler, the lengths)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from butterfly_tpu_torch.obs.profile import device_kernels
    S = engine.num_slots
    mp = engine.cache.page_table.shape[1]
    page = engine.cache.page_size
    lengths = [64, 200, 400, 600, 800, 1000, 1200, 1260][:S]
    for s in range(S):
        engine.set_table_row(s, list(range(s * mp, s * mp + mp)))
    engine.flush_kv_window()
    engine.cache = engine.cache._replace(lengths=torch.tensor(
        lengths, dtype=torch.int32, device="cuda"))
    cur = torch.zeros(S, dtype=torch.int32, device="cuda")
    cursor = torch.zeros(S, dtype=torch.int32, device="cuda")
    pbuf = torch.zeros((S, mp * page), dtype=torch.int32, device="cuda")
    zeros = np.zeros(S, np.int32)
    args = dict(active=np.ones(S, bool), temps=np.zeros(S, np.float32),
                stops=np.full(S, -1, np.int32),
                budgets=np.full(S, 10 ** 6, np.int32))

    def run(n):
        nonlocal cur, cursor
        for i in range(n):
            _, _, cur, cursor = engine.mixed_block_async(
                cur, cursor, pbuf, zeros, seed=i, k=1, C=1, **args)
            engine.flush_kv_window()
        torch.cuda.synchronize()

    run(2)
    t0 = time.perf_counter()
    run(steps)
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=record_shapes) as prof:
        t0 = time.perf_counter()
        run(steps)
        wall = (time.perf_counter() - t0) / steps * 1e3
    busy = sum(_dev_us(e) for e in device_kernels(prof)) / steps / 1e3
    return step_ms, wall, busy, prof, lengths


def _dev_us(e):
    return e.self_device_time_total


def phase_profile(torch, engine, steps=5):
    """Where one decode step's time goes (_decode_step_profile): device
    busy time per step, the idle share, the paged kernels' share and the
    top kernels."""
    from butterfly_tpu_torch.obs.profile import device_kernels
    step_ms, wall, busy, prof, lengths = _decode_step_profile(
        torch, engine, steps)
    ka = device_kernels(prof)
    top = sorted(ka, key=_dev_us, reverse=True)[:8]
    paged = [e for e in ka if "paged_" in e.key and "kernel" in e.key]
    paged_ms = sum(_dev_us(e) for e in paged) / steps / 1e3
    log("profile", decode_step_ms=f"{step_ms:.3f}",
        traced_step_ms=f"{wall:.3f}", device_busy_ms=f"{busy:.3f}",
        idle_share=f"{1 - busy / wall:.3f}" if busy else "not measured",
        paged_ms_per_step=f"{paged_ms:.4f}",
        paged_share_of_busy=f"{paged_ms / busy:.3f}" if busy
        else "not measured",
        paged_calls_per_step="+".join(str(e.count // steps) for e in paged),
        lengths=",".join(map(str, lengths)))
    for e in top:
        log("profile", kernel=e.key[:60].replace(" ", "_"),
            ms_per_step=f"{_dev_us(e) / steps / 1e3:.4f}",
            calls_per_step=e.count // steps)


# -- phase 8: butterfly generate ---------------------------------------------

_TEXT = "The quick brown fox jumps over the lazy dog. " * 30


def _check_tokens(res, B, n, vocab, what):
    assert res.tokens.shape == (B, n), f"{what}: shape {res.tokens.shape}"
    assert ((res.tokens >= 0) & (res.tokens < vocab)).all(), what
    assert (res.lengths == n).all(), f"{what}: lengths {res.lengths}"


def _cli_params(cli, params):
    """A context in which the CLI's load_params hands back `params` (the
    weights built once) instead of drawing them again."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        saved = cli.load_params
        cli.load_params = lambda model, args, mesh=None: params
        try:
            yield
        finally:
            cli.load_params = saved
    return ctx()


def phase_generate(torch, model, params, tok):
    """InferenceEngine.generate on the serve phase's weights, then the
    CLI's generate on them. Returns the fresh kernel's launches."""
    import contextlib
    import io

    from butterfly_tpu_torch.core.config import RuntimeConfig
    from butterfly_tpu_torch.engine.engine import InferenceEngine, pad_prompts
    from butterfly_tpu_torch.engine.sampling import SamplingParams
    from butterfly_tpu_torch.ops.flash_attention import flash_attention
    from butterfly_tpu_torch.serve import cli
    cfg = model.cfg
    L = cfg.num_layers
    card = torch.cuda.get_device_name(0).replace(" ", "_")
    prompts = [tok.encode(_TEXT[:n]) for n in (16, 200, 600, 1000)]
    B, new = len(prompts), 32
    sp = SamplingParams(max_new_tokens=new)
    total, outs = 0, {}
    for name, kvq, fused in (("bf16_fused", "none", True),
                             ("bf16_stepped", "none", False),
                             ("int8_window", "int8", True)):
        eng = InferenceEngine(model, params, RuntimeConfig(kv_quant=kvq))
        flash_attention.launches_fresh = flash_attention.launches_warm = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.generate(prompts, sp, fused=fused)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_fresh = flash_attention.launches_fresh
        assert n_fresh == L, f"{name}: {n_fresh} fresh launches for 1 prefill"
        assert flash_attention.launches_warm == 0, name
        _check_tokens(res, B, new, cfg.vocab_size, name)
        outs[name] = res.tokens
        # the prefill alone, timed on its own cache
        toks, lens = pad_prompts(prompts)
        cache = eng.new_cache(B, 2048)
        tt = torch.as_tensor(toks, device="cuda")
        tl = torch.as_tensor(lens, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = eng.prefill(tt, tl, cache)
        torch.cuda.synchronize()
        pf_ms = (time.perf_counter() - t0) * 1e3
        assert torch.isfinite(logits).all(), f"{name}: prefill logits"
        assert flash_attention.launches_fresh == 2 * L, name
        total += n_fresh  # the timing prefill above is not the main path
        log("generate", run=name, card=card, batch=B,
            prompt_tokens=",".join(str(len(p)) for p in prompts),
            new_tokens=new,
            decode_window=eng._decode_window, wall_s=f"{wall:.3f}",
            tokens_per_s=f"{B * new / wall:.2f}", prefill_ms=f"{pf_ms:.1f}",
            fresh_launches=n_fresh, note="smoke run, not a benchmark")
        del eng, cache, logits
    assert (outs["bf16_fused"] == outs["bf16_stepped"]).all(), \
        "fused and stepped greedy tokens differ"
    # the CLI's generate, handed the weights built once
    out, err = io.StringIO(), io.StringIO()
    flash_attention.launches_fresh = 0
    with _cli_params(cli, params), contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err):
        rc = cli.main(["generate", "--model", "llama3-8b", "--device",
                       "cuda", "--prompt", _TEXT[:300], "--max-new",
                       str(new)])
    assert rc == 0, f"cli generate rc {rc}: {err.getvalue()}"
    assert flash_attention.launches_fresh == L
    total += flash_attention.launches_fresh
    assert err.getvalue().startswith("[butterfly] ")
    log("generate", run="cli", rc=rc, text_chars=len(out.getvalue()),
        stderr=err.getvalue().strip().replace(" ", "_"))
    torch.cuda.empty_cache()
    return total


# -- phase 9: the alternating serving path ----------------------------------

def phase_alternating(torch, model, params, tok):
    """ServingEngine(mixed_dispatch=False) + Scheduler, 8 concurrent
    greedy requests. Returns (engine, {kernel: launches})."""
    from butterfly_tpu_torch.core.config import RuntimeConfig
    from butterfly_tpu_torch.engine.serving import ServingEngine
    from butterfly_tpu_torch.ops.flash_attention import flash_attention
    from butterfly_tpu_torch.ops.paged_attention import paged_attention
    from butterfly_tpu_torch.sched.scheduler import Scheduler
    cfg = model.cfg
    L = cfg.num_layers
    rt = RuntimeConfig(max_batch_size=8, max_seq_len=2048, page_size=16,
                       mixed_dispatch=False)
    engine = ServingEngine(model, params, rt)
    sched = Scheduler(engine)
    sizes = [16, 64, 200, 400, 600, 800, 1000, 1200]
    news = [32, 40, 48, 56, 64, 32, 40, 64]
    flash_attention.launches_fresh = flash_attention.launches_warm = 0
    paged_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    reqs = [sched.submit(tok.encode(_TEXT[:n]), max_new_tokens=m)
            for n, m in zip(sizes, news)]
    sched.run_until_done()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = {"fresh": flash_attention.launches_fresh,
              "warm": flash_attention.launches_warm,
              "paged": paged_attention.launches}
    for r, m in zip(reqs, news):
        assert r.state == "finished" and len(r.output) == m, \
            f"request {r.id}: {r.state}, {len(r.output)} tokens"
        assert all(0 <= t < cfg.vocab_size for t in r.output)
    for kname, n in counts.items():
        assert n > 0, f"the {kname} kernel never launched on this path"
        assert n % L == 0, f"{kname}: {n} launches, not a multiple of {L}"
    ttfts = sorted(r.ttft for r in reqs)
    gen_tokens = sum(len(r.output) for r in reqs)
    log("alternate", card=torch.cuda.get_device_name(0).replace(" ", "_"),
        mixed_dispatch=rt.mixed_dispatch,
        prefill_chunk=rt.prefill_chunk, requests=len(reqs),
        generated_tokens=gen_tokens, wall_s=f"{wall:.3f}",
        tokens_per_s=f"{gen_tokens / wall:.2f}",
        ttft_p50_s=f"{statistics.median(ttfts):.4f}",
        ttft_max_s=f"{ttfts[-1]:.4f}",
        fresh_launches=counts["fresh"], warm_launches=counts["warm"],
        paged_launches=counts["paged"],
        barriers=json.dumps(sched.barrier_causes()).replace(" ", ""),
        note="smoke run, not a benchmark")
    return engine, counts


# -- phase 10: the flash kernels inside the model ------------------------------

def phase_flash_parity(torch, engine):
    """One fresh 512-token prefill and one 388-token warm chunk after it
    on slot 0 of the alternating engine, bf16, through all layers: each
    layer's flash output against the plain version on the same inputs,
    element by element within the bound of `_flash_bound_ratio` (one bf16
    ulp scaled to the output: an absolute LAYER_TOL would fail a right
    kernel on any output of magnitude >= 4, whose ulp is 0.031), and each
    pass's last-token logits against the same pass with the plain version
    at every layer (LOGITS_TOL)."""
    import butterfly_tpu_torch.ops.flash_attention as fa_mod
    from butterfly_tpu_torch.ops.flash_attention import (flash_attention,
                                                         flash_attention_ref)
    L = engine.cfg.num_layers
    gen = torch.Generator(device="cpu")
    gen.manual_seed(3)
    toks = torch.randint(0, engine.cfg.vocab_size, (900,),
                         generator=gen).tolist()
    engine.set_table_row(0, list(range(64)))
    errs, mags, ratios = [], [], []

    def checked(*args, **kw):
        out = flash_attention(*args, **kw)
        ref = flash_attention_ref(*args, **kw)
        diff = (out.float() - ref.float()).abs()
        errs.append(diff.max().item())
        mags.append(ref.float().abs().max().item())
        ratios.append(_flash_bound_ratio(torch, flash_attention_ref, args,
                                         kw, diff, ref))
        return out

    def run(attn):
        # the sharded wrapper the layers call reads the module attribute
        fa_mod.flash_attention = attn
        try:
            fresh = engine.prefill_batch([0], [toks[:512]], [0])
            warm = engine.prefill_batch([0], [toks[512:]], [512])
        finally:
            fa_mod.flash_attention = flash_attention
        torch.cuda.synchronize()
        return fresh.float(), warm.float()

    kern = run(checked)
    plain = run(flash_attention_ref)
    assert len(errs) == 2 * L, errs
    gaps = []
    for a, b in zip(kern, plain):
        assert torch.isfinite(a).all() and torch.isfinite(b).all()
        gaps.append((a - b).abs().max().item())
    log("flashpar", layers=L, fresh_max_layer_abs_err=f"{max(errs[:L]):.3g}",
        warm_max_layer_abs_err=f"{max(errs[L:]):.3g}",
        fresh_max_err_over_elem_bound=f"{max(ratios[:L]):.3g}",
        warm_max_err_over_elem_bound=f"{max(ratios[L:]):.3g}",
        max_abs_attn_out=f"{max(mags):.4g}",
        max_abs_logit=f"{plain[1].abs().max().item():.4g}",
        logits_fresh_kernel_vs_plain=f"{gaps[0]:.4g}",
        logits_warm_kernel_vs_plain=f"{gaps[1]:.4g}", logits_tol=LOGITS_TOL)
    assert max(ratios) <= 1.0, \
        f"flash vs plain in-model: {max(ratios)} x the element bound"
    assert max(gaps) <= LOGITS_TOL, \
        f"flash vs plain logits differ by {max(gaps)} > {LOGITS_TOL}"


# -- phases 12-14: the seq-parallel long-context path -------------------------

_LONG = (_TEXT * 4)[:4095]   # 4096 tokens with BOS: 2 x 2048 on seq = 2


def _seq_mesh(torch):
    """seq = 2: one shard per card where there are two, else both shards
    on cuda:0. Returns (mesh, placement)."""
    from butterfly_tpu_torch.core.config import MeshConfig
    from butterfly_tpu_torch.core.mesh import make_mesh
    devs = ["cuda:0", "cuda:1"] if torch.cuda.device_count() >= 2 \
        else ["cuda:0", "cuda:0"]
    return make_mesh(MeshConfig(seq=2), devs), "+".join(devs)


def _profile(torch, run, warm_up=True):
    """Run `run` once to warm up (unless it ran already), then once under
    torch.profiler: (host wall ms, device kernel averages, device ms of
    one average)."""
    from torch.profiler import ProfilerActivity, profile

    from butterfly_tpu_torch.obs.profile import device_kernels
    if warm_up:
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ka = device_kernels(prof)

    def dev_ms(e):
        return e.self_device_time_total / 1e3
    return wall, ka, dev_ms


def _profile_prefill(torch, run):
    """Where one long prefill's time goes: host wall against device busy
    time (torch.profiler), split into the ring kernel, the GEMMs and the
    rest, and the top kernels."""
    wall, ka, dev_ms = _profile(torch, run)
    busy = sum(dev_ms(e) for e in ka)
    ring = sum(dev_ms(e) for e in ka if "ring" in e.key)
    gemm = sum(dev_ms(e) for e in ka if "nvjet" in e.key or "gemm" in e.key
               or "cutlass" in e.key)
    log("longgen", profile="prefill", wall_ms=f"{wall:.1f}",
        device_busy_ms=f"{busy:.1f}",
        idle_share=f"{1 - busy / wall:.3f}" if busy else "not measured",
        ring_ms=f"{ring:.1f}",
        ring_share=f"{ring / busy:.3f}" if busy else "not measured",
        gemm_ms=f"{gemm:.1f}", other_ms=f"{busy - ring - gemm:.1f}")
    for e in sorted(ka, key=dev_ms, reverse=True)[:6]:
        log("longgen", kernel=e.key[:60].replace(" ", "_"),
            ms=f"{dev_ms(e):.2f}", calls=e.count)


def _decode_wrapper_host_ms(torch, run):
    """Host time of each T = 1 ring wrapper call (checks, the workspace
    allocation, the split and merge launches) over one `run`, unprofiled:
    the decode loop is host-bound, so this is what a call costs it.
    Returns (median ms, calls)."""
    from butterfly_tpu_torch.ops import ring_attention as ra
    orig, host = ra.ring_block_stats, []

    def timed(q, *args, **kw):
        t0 = time.perf_counter()
        out = orig(q, *args, **kw)
        if q.shape[1] == 1:
            host.append((time.perf_counter() - t0) * 1e3)
        return out
    ra.ring_block_stats = timed
    try:
        run()
        torch.cuda.synchronize()
    finally:
        ra.ring_block_stats = orig
    return statistics.median(host), len(host)


def _profile_decode(torch, run, steps):
    """One whole generate_long under the profiler: the decode steps' ring
    time (the T = 1 split and merge kernels) per generated token beside
    the device's busy time, and the T = 1 wrapper's host time per call
    from a run without the profiler."""
    host_ms, host_calls = _decode_wrapper_host_ms(torch, run)
    wall, ka, dev_ms = _profile(torch, run, warm_up=False)
    busy = sum(dev_ms(e) for e in ka)
    dec = [e for e in ka if "ring_decode" in e.key or "ring_merge" in e.key]
    ring_dec = sum(dev_ms(e) for e in dec)
    log("longgen", profile="generate_long", wall_ms=f"{wall:.1f}",
        device_busy_ms=f"{busy:.1f}",
        idle_share=f"{1 - busy / wall:.3f}" if busy else "not measured",
        decode_steps=steps, decode_ring_ms=f"{ring_dec:.2f}",
        decode_ring_ms_per_token=f"{ring_dec / steps:.3f}",
        decode_ring_calls=sum(e.count for e in dec),
        decode_ring_host_ms_per_call=f"{host_ms:.4f}",
        decode_ring_host_calls=host_calls)


def phase_longgen(torch, model, params, tok):
    """InferenceEngine.generate_long over seq = 2, 32 greedy new tokens:
    ring with bf16 KV, ring with int8 KV, Ulysses. The ring kernel's
    launches must be exact: the prefill runs N*N = 4 blocks per layer,
    each decode step N = 2 prefix blocks (one per shard) plus ONE suffix
    block per layer (the replicated suffix runs once, on the first
    device). The prefill's last-position logits are held to the dense
    prefill (the flash kernel) within LOGITS_TOL; the int8 run, whose
    attention reads quantized K/V, to the same prefill with the plain ring
    version. Returns the ring kernel's launches and the ring bf16
    prefill's last-position logits."""
    from butterfly_tpu_torch.core.config import RuntimeConfig
    from butterfly_tpu_torch.engine.engine import InferenceEngine
    from butterfly_tpu_torch.engine.sampling import SamplingParams
    from butterfly_tpu_torch.ops import ring_attention as ra
    from butterfly_tpu_torch.parallel.sequence import sp_forward
    cfg = model.cfg
    L, N, new = cfg.num_layers, 2, 32
    mesh, where = _seq_mesh(torch)
    ids = tok.encode(_LONG)
    tokens = torch.tensor([ids], dtype=torch.int32, device="cuda")
    # the dense reference: one fresh prefill through the flash kernel
    dense = InferenceEngine(model, params)
    lens = torch.tensor([len(ids)], dtype=torch.int32, device="cuda")
    ref, _ = dense.prefill(tokens, lens, dense.new_cache(1, len(ids)))
    ref = ref[0].float()
    del dense
    torch.cuda.empty_cache()
    total = 0
    for name, kvq, impl in (("ring_bf16", "none", "ring"),
                            ("ring_int8", "int8", "ring"),
                            ("ulysses_bf16", "none", "ulysses")):
        eng = InferenceEngine(model, params,
                              RuntimeConfig(kv_quant=kvq, max_seq_len=4096),
                              mesh=mesh)
        sp = SamplingParams(max_new_tokens=new)
        ra.launches = ra.launches_decode = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.generate_long(ids, sp, impl=impl)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n, n_dec = ra.launches, ra.launches_decode
        # decode steps on the T = 1 split kernel, the ring prefill on the
        # wgmma kernel (bf16 and int8 K/V alike)
        want_dec = (new - 1) * L * (N + 1)
        want = (L * N * N if impl == "ring" else 0) + want_dec
        assert n == want, f"{name}: {n} ring launches, want {want}"
        assert n_dec == want_dec, \
            f"{name}: {n_dec} T = 1 ring launches, want {want_dec}"
        _check_tokens(res, 1, new, cfg.vocab_size, name)
        total += n
        # the prefill alone, timed, and its last-position logits
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, prefix = sp_forward(eng._replicas, cfg, tokens, mesh,
                                    impl=impl, kv_quant=kvq)
        torch.cuda.synchronize()
        pf_ms = (time.perf_counter() - t0) * 1e3
        last = logits[-1][0, -1].float().to("cuda:0")
        del logits, prefix
        if name == "ring_bf16":
            seq_last = last
            _profile_prefill(torch, lambda: sp_forward(
                eng._replicas, cfg, tokens, mesh, impl=impl, kv_quant=kvq))
            _profile_decode(torch, lambda: eng.generate_long(ids, sp,
                                                             impl=impl),
                            new - 1)
        if kvq == "int8":
            plain, _ = sp_forward(eng._replicas, cfg, tokens, mesh,
                                  impl=impl, kv_quant=kvq, kernel=False)
            against, gap = "plain_ring", (last - plain[-1][0, -1].float()
                                          .to("cuda:0")).abs().max().item()
            del plain
        else:
            against, gap = "dense_flash", (last - ref).abs().max().item()
        assert torch.isfinite(last).all(), f"{name}: prefill logits"
        assert gap <= LOGITS_TOL, f"{name}: prefill logits differ by {gap}"
        log("longgen", run=name, card=torch.cuda.get_device_name(0)
            .replace(" ", "_"), shards=where, prompt_tokens=len(ids),
            new_tokens=new, wall_s=f"{wall:.3f}",
            tokens_per_s=f"{new / wall:.2f}", prefill_ms=f"{pf_ms:.1f}",
            ring_launches=n, ring_wgmma_launches=n - n_dec,
            ring_split_launches=n_dec, logits_vs=against,
            logits_gap=f"{gap:.4g}",
            logits_tol=LOGITS_TOL, note="smoke run, not a benchmark")
        del eng
        torch.cuda.empty_cache()
    return total, seq_last


def phase_ring_parity(torch, model, params, tok):
    """One sp_forward of the long prompt (ring, bf16 KV) through all 32
    layers: every ring block's kernel stats, finalised, against the plain
    version on the same inputs within the ring phase's element bound
    (masked rows exact), and the logits against the all-plain pass."""
    import butterfly_tpu_torch.parallel.sequence as seq_mod
    from butterfly_tpu_torch.ops import ring_attention as ra
    from butterfly_tpu_torch.parallel.sequence import (replicate_params,
                                                       sp_forward)
    cfg = model.cfg
    mesh, where = _seq_mesh(torch)
    reps = replicate_params(params, mesh)
    ids = tok.encode(_LONG)
    tokens = torch.tensor([ids], dtype=torch.int32, device="cuda")
    ratios, errs = [], []

    def checked(*args, kernel=None):
        stats = ra.ring_block_stats(*args)
        ref = ra.ring_block_stats_ref(*args)
        _, _, out_err, elem, _ = _ring_check(torch, ra, args, stats, ref,
                                             True)
        errs.append(out_err)
        ratios.append(elem)
        return stats

    seq_mod.block_stats = checked
    try:
        kern, _ = sp_forward(reps, cfg, tokens, mesh)
    finally:
        seq_mod.block_stats = ra.block_stats
    plain, _ = sp_forward(reps, cfg, tokens, mesh, kernel=False)
    torch.cuda.synchronize()
    assert len(ratios) == cfg.num_layers * 4, len(ratios)
    gaps = [(a.float().to("cuda:0") - b.float().to("cuda:0")).abs().max()
            .item() for a, b in zip(kern, plain)]
    log("ringpar", shards=where, layers=cfg.num_layers, blocks=len(ratios),
        max_block_abs_err=f"{max(errs):.3g}",
        max_err_over_elem_bound=f"{max(ratios):.3g}",
        logits_kernel_vs_plain=f"{max(gaps):.4g}", logits_tol=LOGITS_TOL)
    assert max(ratios) <= 1.0, f"ring vs plain in-model: {max(ratios)} x bound"
    assert max(gaps) <= LOGITS_TOL, f"ring logits differ by {max(gaps)}"
    del kern, plain, reps
    torch.cuda.empty_cache()


def phase_longserve(torch, model, params, tok):
    """ServingEngine over seq = 2 with the long-prompt lane
    (seq_parallel_threshold 1024, max_seq_len 4096) + Scheduler, mixed
    dispatch: 2 long prompts (3000 and 4000 bytes) and 4 short ones, all
    greedy. Every lane chunk launches the ring kernel N = 2 times per layer
    over the slot's pool prefix plus N*N = 4 for the ring over the chunk,
    so ring and paged launches are multiples of 32. Returns the ring and
    paged kernels' launches and the runs as (prompt, max_new, output)."""
    from butterfly_tpu_torch.core.config import RuntimeConfig
    from butterfly_tpu_torch.engine.serving import ServingEngine
    from butterfly_tpu_torch.ops import ring_attention as ra
    from butterfly_tpu_torch.ops.paged_attention import paged_attention
    from butterfly_tpu_torch.sched.scheduler import Scheduler
    cfg = model.cfg
    L = cfg.num_layers
    mesh, where = _seq_mesh(torch)
    rt = RuntimeConfig(max_batch_size=8, max_seq_len=4096, page_size=16,
                       seq_parallel_threshold=1024)
    engine = ServingEngine(model, params, rt, mesh=mesh)
    sched = Scheduler(engine)
    sizes = [3000, 16, 200, 4000, 600, 1000]
    news = [32, 40, 48, 32, 56, 64]
    ra.launches = ra.launches_decode = paged_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    reqs = [sched.submit(tok.encode(_LONG[:n]), max_new_tokens=m)
            for n, m in zip(sizes, news)]
    sched.run_until_done()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    n_ring, n_paged = ra.launches, paged_attention.launches
    n_wg = n_ring - ra.launches_decode   # chunks: T > 1, the wgmma kernel
    assert n_wg > 0, "the lane never launched the wgmma ring kernel"
    for r, m in zip(reqs, news):
        assert r.state == "finished" and len(r.output) == m, \
            f"request {r.id}: {r.state}, {len(r.output)} tokens"
        assert all(0 <= t < cfg.vocab_size for t in r.output)
    sp_tokens = sched.metrics()["seq_parallel_prefill_tokens_total"]
    assert sp_tokens > 0, "no prompt went through the seq-parallel lane"
    for kname, n in (("ring", n_ring), ("paged", n_paged)):
        assert n > 0, f"the {kname} kernel never launched on this path"
        assert n % L == 0, f"{kname}: {n} launches, not a multiple of {L}"
    ttfts = sorted(r.ttft for r in reqs)
    gen_tokens = sum(len(r.output) for r in reqs)
    log("longserve", card=torch.cuda.get_device_name(0).replace(" ", "_"),
        shards=where, threshold=rt.seq_parallel_threshold,
        prompt_bytes=",".join(map(str, sizes)), requests=len(reqs),
        generated_tokens=gen_tokens, wall_s=f"{wall:.3f}",
        tokens_per_s=f"{gen_tokens / wall:.2f}",
        ttft_p50_s=f"{statistics.median(ttfts):.4f}",
        ttft_max_s=f"{ttfts[-1]:.4f}", sp_prefill_tokens=int(sp_tokens),
        ring_launches=n_ring, ring_wgmma_launches=n_wg,
        paged_launches=n_paged, note="smoke run, not a benchmark")
    engine.cache = engine._kv_window = None
    del engine, sched
    torch.cuda.empty_cache()
    runs = [(tok.encode(_LONG[:n]), m, list(r.output))
            for n, m, r in zip(sizes, news, reqs)]
    return n_ring, n_paged, runs


# -- phase 15: int8 weights ------------------------------------------------------

def _tree_bytes(tree):
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    return tree.nbytes


def _int8_leaves(tree):
    """Every {"q8", "s"} leaf of the tree."""
    if isinstance(tree, dict):
        if "q8" in tree and "s" in tree:
            return [tree]
        return [x for v in tree.values() for x in _int8_leaves(v)]
    return []


def phase_quant(torch, model, params, tok):
    """int8 weights (quant/int8.py) on the shared Llama-3-8B tree:
    quantize_int8, the int8 tree's bytes (codes held as int8), one prefill
    + decode step's logits against the same step on the maybe_dequant
    bf16 tree (0.5 absolute), generate (4 greedy prompts, 32 new,
    fused then stepped: equal tokens; the fresh flash kernel 32 times per
    prefill), 8 concurrent greedy requests through
    serve/server.build_serving with --quant int8 (paged launches a
    multiple of 32), and one decode step's host wall and device busy time
    with int8 and with bf16 weights (_decode_step_profile). Returns
    (int8 tree, {kernel: launches})."""
    from butterfly_tpu_torch.core.config import RuntimeConfig
    from butterfly_tpu_torch.engine.engine import InferenceEngine
    from butterfly_tpu_torch.engine.sampling import SamplingParams
    from butterfly_tpu_torch.engine.serving import ServingEngine
    from butterfly_tpu_torch.models.common import forward, init_cache
    from butterfly_tpu_torch.ops.flash_attention import flash_attention
    from butterfly_tpu_torch.ops.paged_attention import paged_attention
    from butterfly_tpu_torch.quant.int8 import dequant_tree, quantize_int8
    from butterfly_tpu_torch.serve import cli
    from butterfly_tpu_torch.serve.server import build_serving
    cfg = model.cfg
    L = cfg.num_layers
    card = torch.cuda.get_device_name(0).replace(" ", "_")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qparams = quantize_int8(params, cfg)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    leaves = _int8_leaves(qparams)
    assert len(leaves) == 7 + 1, f"{len(leaves)} quantized leaves"
    for leaf in leaves:
        assert leaf["q8"].dtype == torch.int8 and leaf["q8"].is_cuda
    q_bytes = sum(leaf["q8"].nbytes for leaf in leaves)
    s_bytes = sum(leaf["s"].nbytes for leaf in leaves)
    log("quant", card=card, quantize_s=f"{quant_s:.2f}",
        bf16_tree_GB=f"{_tree_bytes(params) / 1e9:.3f}",
        int8_tree_GB=f"{_tree_bytes(qparams) / 1e9:.3f}",
        int8_codes_GB=f"{q_bytes / 1e9:.3f}",
        scales_MB=f"{s_bytes / 1e6:.2f}", quantized_leaves=len(leaves))

    # one prefill + decode step: int8 tree against its dequantized twin
    deq = dequant_tree(qparams, torch.bfloat16)
    ids = tok.encode(_TEXT[:200])
    outs = {}
    for name, tree in (("int8", qparams), ("dequant", deq)):
        cache = init_cache(cfg, 1, 256, device="cuda")
        pf, cache = forward(tree, cfg, torch.tensor([ids], device="cuda"),
                            cache, fresh=True)
        nxt = pf[:, -1].argmax(-1).to(torch.int32)
        step, _ = forward(tree, cfg, nxt[:, None], cache)
        outs[name] = (pf[0, -1].float(), step[0, -1].float(), nxt)
    del deq, cache
    torch.cuda.empty_cache()
    (pf_i, st_i, n_i), (pf_d, st_d, n_d) = outs["int8"], outs["dequant"]
    assert torch.equal(n_i, n_d), "the prefill's greedy tokens differ"
    d_pf = (pf_i - pf_d).abs().max().item()
    d_st = (st_i - st_d).abs().max().item()
    for x in (pf_i, st_i):
        assert torch.isfinite(x).all()
    log("quant", check="int8_vs_dequant_bf16", prompt_tokens=len(ids),
        prefill_logits_max_abs_diff=f"{d_pf:.4g}",
        decode_logits_max_abs_diff=f"{d_st:.4g}", tol=LOGITS_TOL,
        max_abs_logit=f"{st_d.abs().max().item():.4g}",
        argmax_equal=bool(st_i.argmax() == st_d.argmax()))
    assert d_pf <= LOGITS_TOL and d_st <= LOGITS_TOL, (d_pf, d_st)

    # generate on the int8 tree, fused then stepped
    prompts = [tok.encode(_TEXT[:n]) for n in (16, 200, 600, 1000)]
    B, new = len(prompts), 32
    eng = InferenceEngine(model, qparams, RuntimeConfig())
    assert all(leaf["q8"].dtype == torch.int8
               for leaf in _int8_leaves(eng.params))
    counts = {"fresh": 0, "paged": 0}
    toks = {}
    for fused in (True, False):
        flash_attention.launches_fresh = flash_attention.launches_warm = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.generate(prompts, SamplingParams(max_new_tokens=new),
                           fused=fused)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_fresh = flash_attention.launches_fresh
        assert n_fresh == L and flash_attention.launches_warm == 0, n_fresh
        counts["fresh"] += n_fresh
        _check_tokens(res, B, new, cfg.vocab_size, f"int8 fused={fused}")
        toks[fused] = res.tokens
        log("quant", run="generate_fused" if fused else "generate_stepped",
            batch=B, new_tokens=new, wall_s=f"{wall:.3f}",
            tokens_per_s=f"{B * new / wall:.2f}", fresh_launches=n_fresh,
            note="smoke run, not a benchmark")
    assert (toks[True] == toks[False]).all(), "fused and stepped differ"
    del eng
    torch.cuda.empty_cache()

    # serve --quant int8: 8 concurrent greedy requests
    args = cli.build_parser().parse_args(
        ["serve", "--model", "llama3-8b", "--device", "cuda", "--quant",
         "int8", "--port", "0", "--timeseries-interval", "0"])
    with _cli_params(cli, qparams):
        sched, _, rt = build_serving(args)
    engine = sched.engine
    assert all(leaf["q8"].dtype == torch.int8
               for leaf in _int8_leaves(engine.params))
    sizes = [16, 64, 200, 400, 600, 800, 1000, 1200]
    news = [32, 40, 48, 56, 64, 32, 40, 64]
    paged_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    reqs = [sched.submit(tok.encode(_TEXT[:n]), max_new_tokens=m)
            for n, m in zip(sizes, news)]
    sched.run_until_done()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    n_paged = paged_attention.launches
    for r, m in zip(reqs, news):
        assert r.state == "finished" and len(r.output) == m, r.id
        assert all(0 <= t < cfg.vocab_size for t in r.output)
    assert n_paged > 0 and n_paged % L == 0, n_paged
    counts["paged"] += n_paged
    gen_tokens = sum(len(r.output) for r in reqs)
    log("quant", run="serve_int8", requests=len(reqs),
        generated_tokens=gen_tokens, wall_s=f"{wall:.3f}",
        tokens_per_s=f"{gen_tokens / wall:.2f}", paged_launches=n_paged,
        note="smoke run, not a benchmark")
    del sched

    # one decode step, int8 against bf16 weights (same engine shape)
    prof = {}
    for name, eng in (("int8", engine),
                      ("bf16", None)):
        if eng is None:
            eng = ServingEngine(model, params, rt)
        step_ms, wall_ms, busy, _, _ = _decode_step_profile(torch, eng)
        prof[name] = (step_ms, wall_ms, busy)
        log("quant", decode_step=name, card=card, slots=eng.num_slots,
            host_wall_ms=f"{step_ms:.3f}", traced_wall_ms=f"{wall_ms:.3f}",
            device_busy_ms=f"{busy:.3f}" if busy else "not measured",
            idle_share=f"{1 - busy / wall_ms:.3f}" if busy
            else "not measured",
            decode_tok_s=f"{eng.num_slots / step_ms * 1e3:.2f}")
        eng.cache = eng._kv_window = None
        del eng
        torch.cuda.empty_cache()
    engine = None
    return qparams, counts


# -- phase 16: speculative decoding ------------------------------------------------

SPEC_PROMPT_LEN = 32   # run_spec_benchmark's prompt shape
SPEC_NEW = 32


def _teacher_forced_gap(torch, params, cfg, prompt, out):
    """Prompt + output through one plain forward (fresh, dense): the
    largest gap, over the emitted positions, between that position's
    maximum logit and the emitted token's logit."""
    from butterfly_tpu_torch.models.common import forward, init_cache
    seq = list(prompt) + list(out)
    cache = init_cache(cfg, 1, len(seq), device="cuda")
    logits, _ = forward(params, cfg, torch.tensor([seq], device="cuda"),
                        cache, fresh=True)
    lg = logits[0, len(prompt) - 1:len(seq) - 1].float()
    emitted = torch.tensor(out, device="cuda", dtype=torch.long)
    gap = lg.max(-1).values - lg.gather(1, emitted[:, None])[:, 0]
    return gap.max().item()


def _divergence(a, b):
    """First position where two token lists differ (None when equal)."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def _oracle_drafts(torch, refs):
    """A draft function (the DRAFT_SOURCES contract: hist [S, H],
    hist_len [S], gamma, ngram -> drafts [S, gamma], on the device) that
    proposes the next gamma tokens of the reference sequence whose first
    8 tokens are the slot's, zero where there is none."""
    width = max(len(r) for r in refs)
    R = torch.zeros((len(refs), width), dtype=torch.int32, device="cuda")
    for i, r in enumerate(refs):
        R[i, :len(r)] = torch.tensor(r, dtype=torch.int32)
    K = 8

    def fn(hist, hist_len, gamma, ngram):
        match = (hist[:, None, :K] == R[None, :, :K]).all(-1)   # [S, n]
        rows = R[match.to(torch.int32).argmax(1)]               # [S, W]
        pos = hist_len.long()[:, None] \
            + torch.arange(gamma, device=hist.device)[None, :]
        ok = match.any(1)[:, None] & (pos < width)
        d = torch.gather(rows, 1, pos.clamp(0, width - 1))
        return torch.where(ok, d, torch.zeros_like(d))
    return fn


def _spec_run(torch, label, rt, drive, params, cfg, prompts, off, card):
    """One spec configuration of phase_spec, with its checks and line."""
    out, m, wall, gen, n = drive(label, rt)
    assert m["spec_forwards_total"] > 0, label
    if label == "a_oracle":
        assert m["spec_drafts_accepted_total"] > 0, "no draft accepted"
    if label.startswith(("b_", "c_")):
        assert n["fresh"] > 0, f"{label}: no fresh flash launch"
    gap = max(_teacher_forced_gap(torch, params, cfg, p, o)
              for p, o in zip(prompts, out))
    div = [_divergence(o, r) for o, r in zip(out, off)]
    log("spec", run=label, card=card,
        mixed_dispatch=m.get("spec_mixed_fallback_reason") is None,
        tokens_per_forward=f"{m.get('spec_tokens_per_forward', 0):.3f}",
        accept_rate=f"{m.get('spec_accept_rate', 0):.3f}",
        spec_forwards=int(m["spec_forwards_total"]),
        drafts_accepted=int(m["spec_drafts_accepted_total"]),
        tokens_per_s=f"{gen / wall:.2f}", wall_s=f"{wall:.3f}",
        teacher_forced_max_gap=f"{gap:.4g}", tol=LOGITS_TOL,
        equal_to_spec_off=sum(d is None for d in div),
        first_divergence=",".join("-" if d is None else str(d)
                                  for d in div),
        fresh_launches=n["fresh"], warm_launches=n["warm"],
        paged_launches=n["paged"], note="smoke run, not a benchmark")
    assert gap <= LOGITS_TOL, f"{label}: teacher-forced gap {gap}"


def phase_spec(torch, model, params, tok):
    """ServingEngine + Scheduler with speculation on the shared weights:
    8 greedy requests on draft-friendly prompts (obs/benchmark.py
    draft_friendly_prompts), 32 new tokens each: (a) ngram, gamma 4,
    the serve CLI's defaults (mixed dispatch, window on), and the same
    with the oracle draft function (_oracle_drafts: the spec-off run's
    tokens), which must have drafts accepted; (b) the draft model of 8
    layers (the alternating fallback: fresh / warm flash launches
    multiples of 32); (c) a width-2, 5-node token tree with that draft;
    (d) generate_speculative on one prompt; (e) (a) at temperature 0.8
    (must finish). For (a)-(d): every request finishes, verify forwards
    happen, and every emitted token's logit in one plain forward of
    prompt + output is within LOGITS_TOL of that position's maximum.
    Returns {kernel: launches}."""
    from butterfly_tpu_torch.core.config import RuntimeConfig
    from butterfly_tpu_torch.engine.engine import InferenceEngine
    from butterfly_tpu_torch.engine.sampling import SamplingParams
    from butterfly_tpu_torch.engine.serving import (
        DRAFT_SOURCES, ServingEngine, register_draft_source)
    from butterfly_tpu_torch.obs.benchmark import draft_friendly_prompts
    from butterfly_tpu_torch.ops.flash_attention import flash_attention
    from butterfly_tpu_torch.ops.paged_attention import paged_attention
    from butterfly_tpu_torch.sched.scheduler import Scheduler
    cfg = model.cfg
    L = cfg.num_layers
    card = torch.cuda.get_device_name(0).replace(" ", "_")
    base = RuntimeConfig(max_batch_size=8, max_seq_len=2048, page_size=16)
    t0 = time.monotonic()
    prompts = draft_friendly_prompts(
        Scheduler(ServingEngine(model, params, base)), 8, SPEC_PROMPT_LEN)
    log("spec", prompts=len(prompts), prompt_tokens=len(prompts[0]),
        new_tokens=SPEC_NEW, harvest_s=f"{time.monotonic() - t0:.1f}")
    counts = {"fresh": 0, "warm": 0, "paged": 0}

    def drive(label, rt, temperature=0.0):
        engine = ServingEngine(model, params, rt)
        sched = Scheduler(engine)
        flash_attention.launches_fresh = flash_attention.launches_warm = 0
        paged_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.monotonic()
        reqs = [sched.submit(p, max_new_tokens=SPEC_NEW,
                             temperature=temperature) for p in prompts]
        sched.run_until_done()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        n = {"fresh": flash_attention.launches_fresh,
             "warm": flash_attention.launches_warm,
             "paged": paged_attention.launches}
        for r in reqs:
            assert r.state == "finished" and len(r.output) == SPEC_NEW, \
                f"{label}: request {r.id} {r.state} {len(r.output)}"
            assert all(0 <= t < cfg.vocab_size for t in r.output), label
        for k, v in n.items():
            assert v % L == 0, f"{label}: {k} {v} launches"
            counts[k] += v
        m = sched.metrics()
        gen = sum(len(r.output) for r in reqs)
        out = [r.output for r in reqs]
        engine.cache = engine._kv_window = None
        del engine, sched
        torch.cuda.empty_cache()
        return out, m, wall, gen, n

    off, _, wall_off, gen_off, _ = drive("off", base)
    log("spec", run="off", tokens_per_s=f"{gen_off / wall_off:.2f}",
        wall_s=f"{wall_off:.3f}")
    # Random Llama-3-8B weights never repeat themselves (a probe of 300
    # greedy tokens gave 299 distinct), so prompt lookup finds no draft
    # the verify accepts. The accept path is driven by (a_oracle): the
    # same mixed spec block with a draft function, registered through
    # register_draft_source, that proposes the spec-off run's tokens.
    register_draft_source("oracle", _oracle_drafts(
        torch, [p + o for p, o in zip(prompts, off)]))
    runs = [
        ("a_ngram", base.replace(speculative_gamma=4)),
        ("a_oracle", base.replace(speculative_gamma=4,
                                  draft_model="oracle")),
        ("b_model8", base.replace(speculative_gamma=4, draft_model="model",
                                  draft_layers=8)),
        ("c_tree_w2_n5", base.replace(speculative_gamma=4,
                                      draft_model="model", draft_layers=8,
                                      spec_tree_width=2, spec_tree_nodes=5)),
    ]
    try:
        for label, rt in runs:
            _spec_run(torch, label, rt, drive, params, cfg, prompts, off,
                      card)
    finally:
        DRAFT_SOURCES.pop("oracle", None)

    # (d) generate_speculative on one prompt
    eng = InferenceEngine(model, params, RuntimeConfig())
    sp = SamplingParams(max_new_tokens=SPEC_NEW)
    flash_attention.launches_fresh = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.generate_speculative(prompts[0], sp, gamma=4)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert flash_attention.launches_fresh == L
    counts["fresh"] += L
    out = res.tokens.tolist()
    assert len(out) == SPEC_NEW and res.forwards > 1
    gap = _teacher_forced_gap(torch, params, cfg, prompts[0], out)
    log("spec", run="d_generate_speculative",
        tokens_per_forward=f"{res.tokens_per_forward:.3f}",
        forwards=res.forwards, drafts_accepted=res.accepted_drafts,
        tokens_per_s=f"{len(out) / wall:.2f}",
        teacher_forced_max_gap=f"{gap:.4g}",
        first_divergence_vs_serving_off=_divergence(out, off[0]))
    assert gap <= LOGITS_TOL, f"generate_speculative: gap {gap}"
    del eng
    torch.cuda.empty_cache()

    # (e) (a) at temperature 0.8
    _, m, wall, gen, _ = drive("e_ngram_t0.8",
                               base.replace(speculative_gamma=4), 0.8)
    log("spec", run="e_ngram_t0.8",
        tokens_per_forward=f"{m.get('spec_tokens_per_forward', 0):.3f}",
        accept_rate=f"{m.get('spec_accept_rate', 0):.3f}",
        tokens_per_s=f"{gen / wall:.2f}")
    return counts


# -- phase 17: the disaggregated fleet ----------------------------------------

#: the fleet phase's shape: 2 prefill + 2 decode replicas of the shared
#: Llama-3-8B tree, 4 slots of 1024 tokens each in 16-token pages
FLEET = dict(page_size=16, max_batch=4, max_seq=1024, disagg_threshold=64)
FLEET_PROMPT, FLEET_SHARED, FLEET_NEW, FLEET_REQUESTS = 384, 256, 32, 8
FLEET_LAYERS = 8   # the replicas' tree: 8 layers at full width (time)


def _cut(torch, model, params, layers):
    """(model, params) of the shared tree cut to its first `layers`
    layers at full width: views, nothing copied."""
    from butterfly_tpu_torch.models.common import Model
    from butterfly_tpu_torch.models.draft import _slice_layers
    return (Model(model.cfg.replace(num_layers=layers), device="cuda"),
            dict(params, layers=_slice_layers(params["layers"], layers)))


def _fleet_prompts(vocab):
    """8 token prompts of 384 tokens from a seed; the even ones share a
    256-token head, the odd ones are private."""
    import numpy as np
    rng = np.random.default_rng(0)
    shared = rng.integers(1, vocab, FLEET_SHARED).tolist()
    return [shared + rng.integers(1, vocab,
                                  FLEET_PROMPT - FLEET_SHARED).tolist()
            if i % 2 == 0 else rng.integers(1, vocab, FLEET_PROMPT).tolist()
            for i in range(FLEET_REQUESTS)]


def _fleet_run(url, prompts, tag):
    """The prompts through the control plane's /generate from 4 client
    threads (2 requests each), greedy, FLEET_NEW tokens. Returns
    ([(status, body)] in prompt order, wall seconds)."""
    results = [None] * len(prompts)

    def client(c):
        for i in range(c, len(prompts), 4):
            results[i] = _post(url, {"tokens": prompts[i],
                                     "max_tokens": FLEET_NEW,
                                     "temperature": 0.0, "stop_token": -1,
                                     "request_id": f"{tag}-{i}"})
    t0 = time.monotonic()
    threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t0
    for i, r in enumerate(results):
        assert r is not None, f"{tag} request {i} got no answer"
        code, body = r
        assert code == 200, f"{tag} request {i}: HTTP {code}"
        assert len(body["tokens"]) == FLEET_NEW, \
            f"{tag} request {i}: {len(body['tokens'])} tokens"
    return [b for _, b in results], wall


def _legs(tracer, tag):
    """Median seconds of each control-plane leg span of the requests
    whose id starts with `tag`, and each leg's count by status ("ok",
    or the HTTP code of a failed leg, "None" for a transport failure)."""
    legs, status = {}, {}
    for tl in tracer.timelines():
        if not (tl["request_id"] or "").startswith(tag):
            continue
        for ev in tl["events"]:
            if "dur_s" in ev:
                legs.setdefault(ev["name"], []).append(ev["dur_s"])
                by = status.setdefault(ev["name"], {})
                st = str(ev.get("status", "ok"))
                by[st] = by.get(st, 0) + 1
    return ({k: statistics.median(v) for k, v in sorted(legs.items())},
            {k: "+".join(f"{n}x{st}" for st, n in sorted(v.items()))
             for k, v in sorted(status.items())})


def _pool_bytes(engine):
    c = engine.cache
    return sum(t.numel() * t.element_size()
               for t in (c.k_pages, c.v_pages, c.k_scale_pages,
                         c.v_scale_pages) if t is not None)


def phase_fleet(torch, model, params):
    """`butterfly fleet` on the card: fleet/harness.start_fleet("2p2d")
    over the shared Llama-3-8B weights cut to FLEET_LAYERS layers at full
    width (views; one tree for all four replicas, and the teacher-forced
    check's), the control plane in front, on cuda. A direct run
    (disaggregation off) and a disaggregated run of the same 8 requests;
    the page bytes of an export -> import -> export; a drained restart of
    one decode replica under load with nothing dropped; spawn and retire
    of a decode replica, its pool's memory given back. Returns {kernel:
    launches} (the paged kernel's count over the phase)."""
    import gc

    import numpy as np

    from butterfly_tpu_torch.cache.prefix import (PrefixCachingAllocator,
                                                  chain_block_hashes)
    from butterfly_tpu_torch.fleet.harness import start_fleet
    from butterfly_tpu_torch.ops.paged_attention import paged_attention
    from butterfly_tpu_torch.workload import loadgen as lg
    card = torch.cuda.get_device_name(0).replace(" ", "_")
    model, params = _cut(torch, model, params, FLEET_LAYERS)
    cfg = model.cfg
    paged_attention.launches = 0
    gc.collect()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    fleet = start_fleet("2p2d", model=model, params=params, device="cuda",
                        **FLEET)
    try:
        torch.cuda.synchronize()
        mem1 = torch.cuda.memory_allocated()
        pool = _pool_bytes(fleet.replicas[0].sched.engine)
        log("fleet", card=card, topology="2p2d", layers=cfg.num_layers,
            hidden=cfg.hidden_size, dtype=cfg.dtype,
            start_s=f"{time.monotonic() - t0:.1f}",
            memory_allocated_GiB_before=f"{mem0 / 2**30:.3f}",
            memory_allocated_GiB_after=f"{mem1 / 2**30:.3f}",
            pool_GiB=f"{pool / 2**30:.3f}",
            allocators=",".join(type(r.sched.alloc).__name__
                                for r in fleet.replicas))
        assert mem1 - mem0 < 8 * 2**30, "the weights were copied"
        # KV transfer addresses pages through the prefix registry, so a
        # fleet replica always runs the prefix-caching allocator
        assert all(isinstance(r.sched.alloc, PrefixCachingAllocator)
                   for r in fleet.replicas)

        prompts = _fleet_prompts(cfg.vocab_size)
        c0 = fleet.state.fleet_counters()
        fleet.state.disagg_threshold = 10 ** 9
        direct, wall_direct = _fleet_run(fleet.url, prompts, "direct")
        c1 = fleet.state.fleet_counters()
        fleet.state.disagg_threshold = FLEET["disagg_threshold"]
        disagg, wall_disagg = _fleet_run(fleet.url, prompts, "disagg")
        c2 = fleet.state.fleet_counters()
        n_disagg = c2["disagg_requests"] - c1["disagg_requests"]
        pages = c2["kv_transfer_pages"] - c1["kv_transfer_pages"]
        xbytes = c2["kv_transfer_bytes"] - c1["kv_transfer_bytes"]
        assert c1["disagg_requests"] == c0["disagg_requests"]
        assert n_disagg == FLEET_REQUESTS, f"{n_disagg} disaggregated"
        assert all(b.get("disaggregated") for b in disagg)
        assert pages > 0, "no KV page transferred"
        div = [_divergence(d["tokens"], r["tokens"])
               for d, r in zip(disagg, direct)]
        gap = max(_teacher_forced_gap(torch, params, cfg, p, b["tokens"])
                  for p, b in zip(prompts, disagg))
        legs, legs_status = _legs(fleet.state.tracer, "disagg")
        legs_direct, _ = _legs(fleet.state.tracer, "direct")
        n_tokens = FLEET_REQUESTS * FLEET_NEW
        ttft_d = sorted(b["ttft_s"] for b in direct)
        ttft_x = sorted(b["ttft_s"] for b in disagg)

        def p95(xs):
            return xs[min(len(xs) - 1, int(round(0.95 * (len(xs) - 1))))]
        log("fleet", run="direct_vs_disagg", card=card,
            equal_to_direct=sum(d is None for d in div),
            first_divergence=",".join("-" if d is None else str(d)
                                      for d in div),
            teacher_forced_max_gap=f"{gap:.4g}", tol=LOGITS_TOL,
            fleet_disaggregated=int(n_disagg), kv_transfer_pages=int(pages),
            kv_transfer_bytes=int(xbytes),
            ttft_direct_p50_s=f"{statistics.median(ttft_d):.4f}",
            ttft_direct_p95_s=f"{p95(ttft_d):.4f}",
            ttft_disagg_p50_s=f"{statistics.median(ttft_x):.4f}",
            ttft_disagg_p95_s=f"{p95(ttft_x):.4f}",
            wall_direct_s=f"{wall_direct:.3f}",
            wall_disagg_s=f"{wall_disagg:.3f}",
            tokens_per_s_direct=f"{n_tokens / wall_direct:.2f}",
            tokens_per_s_disagg=f"{n_tokens / wall_disagg:.2f}",
            note="smoke run, not a benchmark")
        log("fleet", run="leg_medians_s", card=card,
            **{f"disagg_{k}": f"{v:.4f}" for k, v in legs.items()},
            **{f"direct_{k}": f"{v:.4f}" for k, v in legs_direct.items()})
        # the /kv legs take the replica's serving lock with a 2 s bound:
        # a longer tick answers 503 and the decode replica prefills the
        # prompt itself
        log("fleet", run="leg_status", card=card,
            **{f"disagg_{k}": v for k, v in legs_status.items()})
        log("fleet", run="tick_host_frac", card=card,
            **{f"{r.role}_{r.port}":
               "{:.4f}".format(r.sched.metrics().get("tick_host_frac", -1))
               for r in fleet.replicas})
        assert gap <= LOGITS_TOL, f"teacher-forced gap {gap}"

        # payload bytes: export -> import -> export
        pre, dec = fleet.replicas[0], fleet.replicas[2]
        probe = np.random.default_rng(1).integers(
            1, cfg.vocab_size, FLEET_PROMPT).tolist()
        lg._post_json(pre.url, "/generate", {"tokens": probe,
                                             "max_tokens": 1,
                                             "stop_token": -1}, timeout=600)
        path = "/kv/pages?hashes=" + ",".join(
            h.hex() for h in chain_block_hashes(probe, FLEET["page_size"]))
        t0 = time.monotonic()
        a = lg._get_json(pre.url, path, timeout=600)
        t_export = time.monotonic() - t0
        t0 = time.monotonic()
        res = lg._post_json(dec.url, "/kv/import", a, timeout=600)
        t_import = time.monotonic() - t0
        b = lg._get_json(dec.url, path, timeout=600)
        assert len(a["pages"]) == FLEET_PROMPT // FLEET["page_size"]
        assert res["imported"] + res["skipped"] == len(a["pages"])
        assert b["pages"] == a["pages"], "page bytes changed in transit"
        log("fleet", run="payload", card=card, pages=len(a["pages"]),
            raw_bytes=a["bytes"],
            json_bytes=len(json.dumps(a).encode()),
            export_s=f"{t_export:.3f}", import_s=f"{t_import:.3f}",
            identical_after_roundtrip=True)

        # a drained restart of one decode replica under load
        soak = lg.run_fleet_soak(
            fleet.url, clients=4, requests_per_client=2, prefix_share=0.5,
            shared_len=FLEET_SHARED, tail_len=FLEET_PROMPT - FLEET_SHARED,
            max_tokens=FLEET_NEW, seed=1, vocab=cfg.vocab_size,
            timeout=600.0, replicas=[dec.rid],
            restart_hook=lambda rid: fleet.by_rid[rid].restart())
        log("fleet", run="restart", card=card, replica=dec.rid,
            sent=soak["sent"], failed=soak["failed"],
            cycles=len(soak["rolling_cycles"]),
            drained=soak["rolling_cycles"][0].get("drained"))
        assert soak["sent"] == 8 and soak["failed"] == 0, soak
        assert soak["rolling_cycles"][0].get("restarted")

        # spawn and retire a decode replica: its pool must go away
        gc.collect()
        torch.cuda.synchronize()
        m_before = torch.cuda.memory_allocated()
        t0 = time.monotonic()
        handle = fleet.spawn("decode")
        t_spawn = time.monotonic() - t0
        r = lg._post_json(handle.url, "/generate",
                          {"tokens": prompts[0][:64], "max_tokens": 4,
                           "stop_token": -1}, timeout=600)
        assert len(r["tokens"]) == 4
        torch.cuda.synchronize()
        m_spawned = torch.cuda.memory_allocated()
        rid = handle.rid
        del handle, r
        t0 = time.monotonic()
        assert fleet.retire(rid)
        t_retire = time.monotonic() - t0
        torch.cuda.synchronize()
        m_after = torch.cuda.memory_allocated()
        log("fleet", run="spawn_retire", card=card,
            spawn_s=f"{t_spawn:.2f}", retire_s=f"{t_retire:.2f}",
            memory_allocated_GiB_before=f"{m_before / 2**30:.3f}",
            memory_allocated_GiB_spawned=f"{m_spawned / 2**30:.3f}",
            memory_allocated_GiB_after=f"{m_after / 2**30:.3f}",
            pool_GiB=f"{pool / 2**30:.3f}")
        assert abs(m_after - m_before) < pool, \
            "the retired replica's pool is still allocated"
    finally:
        fleet.stop()
    launches = paged_attention.launches
    assert launches > 0, "the paged kernel never launched in the fleet"
    log("fleet", card=card, paged_attention_launches=launches)
    del fleet
    gc.collect()
    torch.cuda.empty_cache()
    return {"paged": launches}


# -- phase 18: the benchmark legs ---------------------------------------------

#: the mixed leg's shape: the JAX package's CPU bench round (12
#: mixed_chat requests, 8-48 prompt and 16-48 new tokens, 8-token pages,
#: 4 slots, the pool at 0.35 of worst-case demand, one burst), with TTFT
#: shedding off (the card's TTFT exceeds the leg's 1 s default SLO, so it
#: would shed instead of contend) and a host tier of 512 MiB (a
#: Llama-3-8B page of 8 tokens holds 1 MiB of K/V: 512 pages); its
#: operating-point sweep runs 2 of the default 4 grid points, (1, 1) and
#: (4, 1) (time)
BENCH_MIXED = dict(n_requests=12, max_batch=4, prompt_lo=8, prompt_hi=48,
                   max_new_lo=16, max_new_hi=48, page_size=8,
                   pool_fraction=0.35, arrival="burst:2000:0.5:0.1",
                   slo_ttft_ms=None, host_kv_tier_mb=512.0,
                   max_seconds=180.0, grid=[(1, 1), (4, 1)])
#: the depth of the serving, warm_prefill, mixed and spec legs' tree,
#: full width (time); the decode legs keep full depth (the tp phase holds
#: its tensor = 2 decode leg against the decode leg)
BENCH_CUT_LAYERS = 8


def phase_bench(torch, model, params, qparams):
    """The benchmark legs of obs/benchmark.py called directly on the
    shared Llama-3-8B weights (not built a second time), sized by request
    counts and max_seconds, never by width; each leg's JSON on a
    labelled line with its wall seconds. The serving, warm-prefill, mixed
    (its sweep at 2 grid points) and speculation (spec on vs off, the
    ngram / model / tree rows) legs run on the tree cut to
    BENCH_CUT_LAYERS layers at full width, their lines marked `layers=`;
    the decode leg runs once
    more on the int8 tree `qparams`; then the fleet, chaos and autoscale
    legs at their defaults (in-process tiny-model fleets on the card; the
    autoscale leg with 12 requests of 64 tokens a client). Then one
    `butterfly bench --model tiny --device cuda --serving` (head_dim 16
    in f32: the ring kernel's CUDA-core route at the tiny heads). The
    four kernels' counts are zeroed just before and read just after;
    each must have launched. Returns ({kernel: launches}, the decode
    leg's result, the cut (model, params))."""
    import contextlib
    import io

    from butterfly_tpu_torch.obs import benchmark as bm
    from butterfly_tpu_torch.ops import ring_attention as ra
    from butterfly_tpu_torch.ops.flash_attention import flash_attention
    from butterfly_tpu_torch.ops.paged_attention import paged_attention
    from butterfly_tpu_torch.serve.cli import main as cli_main
    card = torch.cuda.get_device_name(0).replace(" ", "_")
    # the serving, warm-prefill, mixed and spec legs run on the tree cut
    # to BENCH_CUT_LAYERS layers at full width (views of the shared tree;
    # time)
    model_c, params_c = _cut(torch, model, params, BENCH_CUT_LAYERS)
    cut = {"serving", "warm_prefill", "mixed", "spec"}
    legs = [
        ("decode", lambda: bm.run_decode_benchmark(
            model, params, batch=8, prompt_len=128, max_new=64)),
        # 8 requests keep the whole smoke inside its time limit
        ("serving", lambda: bm.run_serving_benchmark(
            model_c, params_c, n_requests=8, prompt_len=128, max_new=32,
            max_batch=8)),
        ("warm_prefill", lambda: bm.run_warm_prefill_benchmark(
            model_c, params_c, repeats=1)),
        ("longctx", lambda: bm.run_longctx_benchmark(model, params)),
        ("mixed", lambda: bm.run_mixed_benchmark(model_c, params_c,
                                                 **BENCH_MIXED)),
        ("decode_int8", lambda: bm.run_decode_benchmark(
            model, qparams, batch=8, prompt_len=128, max_new=64)),
        ("spec", lambda: bm.run_spec_benchmark(
            model_c, params_c, n_requests=8, prompt_len=SPEC_PROMPT_LEN,
            max_new=SPEC_NEW, max_batch=8, gamma=4, draft_layers=1)),
        # the fleet legs at the JAX defaults: tiny-model replicas, since
        # they measure the control plane, not the model
        ("fleet", lambda: bm.run_fleet_benchmark("2p2d", device="cuda")),
        ("chaos", lambda: bm.run_chaos_benchmark("2p2d", device="cuda")),
        # 12 requests of 64 tokens a client, not the default 6 of 8: with
        # those a fast host's one decode replica drained the ramp before
        # the autoscaler's window saw a queue and nothing scaled (seen on
        # an H100 host); now the ramp holds its peak past one replica's
        # two slots
        ("autoscale", lambda: bm.run_autoscale_benchmark(
            "1p1d", device="cuda", requests_per_client=12,
            max_tokens=64)),
    ]
    ra.launches = ra.launches_decode = paged_attention.launches = 0
    flash_attention.launches_fresh = flash_attention.launches_warm = 0
    torch.cuda.synchronize()
    res = {}
    for name, run in legs:
        t0 = time.monotonic()
        res[name] = run()
        torch.cuda.synchronize()
        depth = f"layers={BENCH_CUT_LAYERS} " if name in cut else ""
        print(f"[bench] leg={name} card={card} {depth}"
              f"wall_s={time.monotonic() - t0:.1f} "
              + json.dumps(res[name], sort_keys=True), flush=True)
        torch.cuda.empty_cache()
    t0 = time.monotonic()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["bench", "--model", "tiny", "--device", "cuda",
                       "--serving", "--batch", "8", "--prompt-len", "64",
                       "--max-new", "32"])
    torch.cuda.synchronize()
    lines = buf.getvalue().strip().splitlines()
    print(f"[bench] leg=cli_tiny card={card} "
          f"wall_s={time.monotonic() - t0:.1f} rc={rc} "
          + (lines[-1] if lines else "no output"), flush=True)
    counts = {"paged": paged_attention.launches,
              "fresh": flash_attention.launches_fresh,
              "warm": flash_attention.launches_warm,
              "ring": ra.launches}

    assert rc == 0 and len(lines) == 1, "bench CLI: not one JSON line"
    cli = json.loads(lines[0])
    assert cli["metric"] == "decode_tokens_per_sec_per_chip" \
        and cli["value"] > 0
    assert cli["longctx_ring_kernelized"] is True
    dec, mixed = res["decode"], res["mixed"]
    for k in ("decode_tokens_per_sec_per_chip", "hbm_util", "mfu"):
        assert dec[k] is not None and 0 < dec[k] < float("inf"), (k, dec[k])
    assert dec["hbm_util"] < 1 and dec["mfu"] < 1
    assert res["serving"]["serving_tokens_per_sec_per_chip"] > 0
    assert res["warm_prefill"]["warm_prefill_kernelized"] is True
    assert res["longctx"]["longctx_ring_kernelized"] is True
    assert mixed["mixed_prefix_cache_hit_tokens"] > 0, "no prefix hit"
    assert mixed["mixed_serving_preemptions"] > 0, "pool never contested"
    assert mixed["kv_tier_pages_restored_total"] > 0, "no tier revival"
    dq, spec = res["decode_int8"], res["spec"]
    assert 0 < dq["hbm_util"] < 1 and dq["decode_tokens_per_sec_per_chip"] > 0
    assert spec["spec_forwards_total"] > 0
    fl, ch, au = res["fleet"], res["chaos"], res["autoscale"]
    assert fl["fleet_dropped"] == 0 and fl["kv_transfer_pages"] > 0, fl
    assert ch["chaos_unterminal"] == 0 and ch["chaos_injected"] > 0, ch
    assert au["autoscale_scale_ups"] >= 1 \
        and au["autoscale_flightrec_scale_events"] >= 1, au
    for kname, n in counts.items():
        assert n > 0, f"the {kname} kernel never launched in the bench legs"
    log("bench", card=card, **{f"{k}_launches": n for k, n in counts.items()},
        decode_tok_s_per_card=f"{dec['decode_tokens_per_sec_per_chip']:.2f}",
        hbm_util=f"{dec['hbm_util']:.4f}", mfu=f"{dec['mfu']:.4f}",
        serving_tok_s="{:.2f}".format(
            res["serving"]["serving_tokens_per_sec_per_chip"]),
        mixed_tok_s=mixed["mixed_serving_tokens_per_sec"],
        mixed_preemptions=mixed["mixed_serving_preemptions"],
        mixed_prefix_hit_tokens=mixed["mixed_prefix_cache_hit_tokens"],
        tier_saved=mixed["kv_tier_pages_saved_total"],
        tier_restored=mixed["kv_tier_pages_restored_total"])
    log("bench", decode_int8_tok_s_per_card="{:.2f}".format(
            dq["decode_tokens_per_sec_per_chip"]),
        decode_int8_hbm_util=f"{dq['hbm_util']:.4f}",
        spec_tok_s=f"{spec['serving_spec_tokens_per_sec']:.2f}",
        spec_off_tok_s=f"{spec['serving_spec_off_tokens_per_sec']:.2f}",
        spec_tokens_per_forward=f"{spec['spec_tokens_per_forward']:.3f}",
        spec_accept_rate=f"{spec['spec_accept_rate']:.3f}",
        **{f"spec_accept_rate_{k}": f"{spec['spec_accept_rate_' + k]:.3f}"
           for k in ("ngram", "model", "tree")})
    return counts, dec, (model_c, params_c)


# -- the tools step: the port's profiler and tp_scaling -----------------------

#: the profiler's sizes in the smoke (the CLI's card defaults are batch
#: 128, prompt 128, 128 new, 16 steps a block): the serve phase's 8 slots,
#: 16 new tokens and 4 steps a block (with 32 and 8 the step took 39.9 s)
TOOLS = dict(batch=8, prompt_len=128, max_new=16, steps_per_tick=4, top=3)
TOOLS_TP = (2, 8)   # tp_scaling's tensor sizes, every shard on cuda:0


def phase_tools(torch, model, params):
    """tools/profile_decode.py and tools/tp_scaling.py as a caller runs them
    (butterfly_tpu_torch/tools/), on the bench phase's tree cut to
    BENCH_CUT_LAYERS layers at full width, int8 KV pools as the
    profiler's card branch: each profiler mode through its function
    (decode, serving, pipeline, spec, prefill; long context on a seq =
    4 mesh of four shards on cuda:0), its trace window's wall, device
    busy, idle share and top kernel printed, the kernel its path runs
    checked inside the window (paged for serving and pipeline; ring
    and paged for long context) or, where the window holds none of the
    four, by the mode's launch counter: fresh flash for the default
    mode (its prefill lies outside the window) and prefill, paged for
    spec (a verify block attends its gamma + 1 queries through the
    dense gather, as the reference's paged_layer_body does; its
    warm-up decodes one token a step through the kernel); then
    tp_scaling's collectives of one decode step at tensor = 2 and 8,
    which must be 2 reductions of [B, 1, D] a layer. The traces go
    under the git-ignored build/ and are removed at the end. Returns
    {kernel: launches}."""
    import shutil

    from butterfly_tpu_torch.ops import ring_attention as ra
    from butterfly_tpu_torch.tools import profile_decode as pd
    from butterfly_tpu_torch.tools import tp_scaling as ts
    card = torch.cuda.get_device_name(0).replace(" ", "_")
    cfg = model.cfg
    out = os.path.join(ROOT, "build", "smoke_tools")
    opts = pd.options(out=out, **TOOLS)
    counts = {"paged": 0, "fresh": 0, "warm": 0, "ring": 0}
    # (mode, its function, the kernels its trace window must hold, the
    # launch counter that must move over the whole mode)
    modes = (("decode", pd.profile_decode_loop, (), "fresh"),
             ("serving", pd.profile_serving_block, ("paged_",), "paged"),
             ("pipeline", pd.profile_pipeline, ("paged_",), "paged"),
             ("spec", pd.profile_spec_block, (), "paged"),
             ("prefill", pd.profile_prefill_batch, (), "fresh"),
             ("long_context", pd.profile_longctx, ("ring_", "paged_"),
              "ring"))
    try:
        for name, fn, in_window, counter in modes:
            _zero_counts()
            ra.launches = 0
            t0 = time.monotonic()
            r = fn(model, params, "int8", opts)
            torch.cuda.synchronize()
            n = {**_launch_counts(), "ring": ra.launches}
            for k in counts:
                counts[k] += n[k]
            top = r["top"][0]
            log("tools", mode=name, card=card, layers=cfg.num_layers,
                seconds=f"{time.monotonic() - t0:.1f}",
                wall_ms=f"{r['wall_ms']:.3f}",
                device_busy_ms=f"{r['device_busy_ms']:.3f}",
                idle_share=f"{r['idle_share']:.3f}",
                top_kernel=top["name"][:60].replace(" ", "_"),
                top_kernel_ms=f"{top['ms']:.4f}",
                trace_MB=f"{os.path.getsize(r['trace']) / 1e6:.1f}",
                **{f"{k}_launches": v for k, v in n.items()})
            assert n[counter] > 0, f"{name}: the {counter} kernel never " \
                "launched"
            for kernel in in_window:
                assert any(kernel in k for k in r["kernels"]), \
                    f"{name}: no {kernel}* kernel in the trace window"
    finally:
        shutil.rmtree(out, ignore_errors=True)
    for tp in TOOLS_TP:
        t0 = time.monotonic()
        pl = ts.per_layer(ts.measure(model, params, tp, batch=TOOLS["batch"],
                                     seq=TOOLS["prompt_len"],
                                     devices=["cuda:0"] * tp))
        ar = [r for r in pl["layer"] if r["kind"] == "all_reduce"]
        log("tools", step="tp_scaling", card=card, tensor=tp,
            layers=pl["layers"], seconds=f"{time.monotonic() - t0:.1f}",
            reductions_per_layer=len(ar),
            shapes="/".join("x".join(map(str, r["shape"])) for r in ar),
            dtype=ar[0]["dtype"] if ar else "-",
            bytes_per_layer=sum(r["bytes"] for r in ar),
            outside=",".join(f"{r['kind']}:{'x'.join(map(str, r['shape']))}"
                             for r in pl["outside"]),
            note="one card: copies and adds on cuda:0, not NVLink")
        assert pl["layers"] == cfg.num_layers
        assert [r["shape"] for r in ar] == \
            [(TOOLS["batch"], 1, cfg.hidden_size)] * 2, ar
    return counts


# -- phase 19: checkpoints, serving snapshots and profiles -------------------

CKPT_LAYERS = 8       # the checkpoint's depth at full width (time)
CKPT_FILES = 4        # model-0000k-of-00004.safetensors, 2 layers a file
SNAP_LAYERS = 4       # the f32 snapshot engine and the sharded load: 4 layers
SNAP_NEW = 48         # new tokens a snapshot request asks for: the short
                      # prompts decode while the 1000-token one prefills
_ST_CODE = {"torch.bfloat16": "BF16", "torch.float32": "F32",
            "torch.float16": "F16"}


def _hf_llama_tensors(params, cfg):
    """[(HF name, thunk)] of a Llama tree in LlamaForCausalLM's names and
    [out, in] layouts: the inverse of models/llama.py's converter, written
    here so the loader is held against an independent map. Each thunk
    gives a view on the card; file k holds an equal run of layers."""
    D, Nq, Kv, H = cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    lay = params["layers"]
    files = [[] for _ in range(CKPT_FILES)]
    per = -(-cfg.num_layers // CKPT_FILES)
    files[0].append(("model.embed_tokens.weight",
                     lambda: params["embed"]["tok"]))
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        a, m = lay["attn"], lay["mlp"]
        files[i // per] += [
            (p + "input_layernorm.weight", lambda i=i: lay["ln1"]["scale"][i]),
            (p + "post_attention_layernorm.weight",
             lambda i=i: lay["ln2"]["scale"][i]),
            (p + "self_attn.q_proj.weight",
             lambda i=i: a["wq"][i].reshape(D, Nq * H).T),
            (p + "self_attn.k_proj.weight",
             lambda i=i: a["wk"][i].reshape(D, Kv * H).T),
            (p + "self_attn.v_proj.weight",
             lambda i=i: a["wv"][i].reshape(D, Kv * H).T),
            (p + "self_attn.o_proj.weight",
             lambda i=i: a["wo"][i].reshape(Nq * H, D).T),
            (p + "mlp.gate_proj.weight", lambda i=i: m["w_gate"][i].T),
            (p + "mlp.up_proj.weight", lambda i=i: m["w_up"][i].T),
            (p + "mlp.down_proj.weight", lambda i=i: m["w_down"][i].T)]
    files[-1] += [("model.norm.weight", lambda: params["final_norm"]["scale"]),
                  ("lm_head.weight", lambda: params["lm_head"].T)]
    return files


def _write_safetensors(torch, path, named, staging):
    """A safetensors file of [(name, thunk)] (8-byte header length, JSON
    header, raw little-endian bytes), each tensor copied through the
    pinned host buffer `staging` (uint8, as large as the largest one)."""
    import struct
    header, off = {}, 0
    for name, thunk in named:
        t = thunk()
        code = _ST_CODE[str(t.dtype)]
        n = t.numel() * t.element_size()
        header[name] = {"dtype": code, "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name, thunk in named:
            raw = thunk().contiguous().reshape(-1).view(torch.uint8)
            host = staging[:raw.numel()]
            host.copy_(raw)
            f.write(host.numpy())
    return off + 8 + len(blob)


def _hf_llama_config(cfg):
    return {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads,
            "head_dim": cfg.head_dim,
            "intermediate_size": cfg.intermediate_size,
            "max_position_embeddings": cfg.max_seq_len,
            "rms_norm_eps": cfg.norm_eps, "rope_theta": cfg.rope_theta,
            "tie_word_embeddings": cfg.tie_embeddings,
            "torch_dtype": cfg.dtype}


class _RssPeak:
    """The process's resident set sampled every 2 ms on a thread (the
    loader's copies release the interpreter lock): the growth of its
    peak over the value at entry, in bytes."""

    def __enter__(self):
        self._page = os.sysconf("SC_PAGE_SIZE")
        self.start = self.peak = self._rss()
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()
        return self

    def _rss(self):
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self._page

    def _run(self):
        while not self._stop.wait(0.002):
            self.peak = max(self.peak, self._rss())

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join(timeout=10)
        self.peak = max(self.peak, self._rss())
        self.growth = self.peak - self.start


def _measured_loader(torch, stats):
    """A context in which ckpt.load_checkpoint, as the CLI calls it, is
    timed and watched: its seconds, the host RSS peak's growth and the
    card's allocation peak over what was allocated before, in `stats`."""
    import contextlib

    import butterfly_tpu_torch.ckpt as ckpt

    @contextlib.contextmanager
    def ctx():
        real = ckpt.load_checkpoint

        def load(*a, **kw):
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            with _RssPeak() as rss:
                t0 = time.monotonic()
                tree = real(*a, **kw)
                torch.cuda.synchronize()
                stats["load_s"] = time.monotonic() - t0
            stats["card_peak"] = torch.cuda.max_memory_allocated() - before
            stats["rss_growth"] = rss.growth
            return tree
        ckpt.load_checkpoint = load
        try:
            yield
        finally:
            ckpt.load_checkpoint = real
    return ctx()


def _trees_equal(torch, got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _trees_equal(torch, got[k], want[k], f"{path}.{k}")
        return
    assert got.dtype == want.dtype and got.shape == want.shape, path
    assert torch.equal(got, want), f"{path}: the loaded leaf differs"


def _shards_equal(torch, got, want, path=""):
    """Same Shards structure (axis, split, parts), devices and values."""
    from butterfly_tpu_torch.parallel.partition import Shards
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _shards_equal(torch, got[k], want[k], f"{path}.{k}")
    elif isinstance(want, Shards):
        assert isinstance(got, Shards) and (got.axis, got.split) == \
            (want.axis, want.split) and len(got.parts) == len(want.parts), \
            path
        for a, b in zip(got.parts, want.parts):
            _shards_equal(torch, a, b, path)
    else:
        assert got.device == want.device and got.dtype == want.dtype, path
        assert torch.equal(got, want), f"{path}: a shard differs"


def _greedy_run(engine_args, prompts, new):
    """Every prompt submitted to a fresh scheduler before its first tick,
    run to the end: [tokens]."""
    from butterfly_tpu_torch.engine.serving import ServingEngine
    from butterfly_tpu_torch.sched.scheduler import Scheduler
    sched = Scheduler(ServingEngine(*engine_args))
    reqs = [sched.submit(p, max_new_tokens=new) for p in prompts]
    sched.run_until_done()
    assert all(r.state == "finished" for r in reqs)
    return [list(r.output) for r in reqs], sched


def _snapshot_restore(engine_args, prompts, new, path):
    """Every prompt submitted to a fresh scheduler, a serving snapshot
    saved to `path` once each request has 4+ tokens, restored into
    another fresh scheduler and run to the end: (the tokens each request
    had at the snapshot, each request's whole output, ticks before the
    snapshot, requests restored)."""
    from butterfly_tpu_torch.ckpt import sharded
    from butterfly_tpu_torch.engine.serving import ServingEngine
    from butterfly_tpu_torch.sched.scheduler import Scheduler
    live = Scheduler(ServingEngine(*engine_args))
    reqs = [live.submit(p, max_new_tokens=new) for p in prompts]
    ticks = 0
    while not all(len(r.output) >= 4 for r in reqs):   # every one mid-flight
        live.tick()
        ticks += 1
    assert live.has_work and not any(r.done for r in reqs)
    sharded.save_serving_snapshot(path, live)
    partial = [list(r.output) for r in reqs]
    del live, reqs
    sched = Scheduler(ServingEngine(*engine_args))
    n_restored = sharded.restore_serving_snapshot(path, sched)
    restored = {tuple(r.prompt): r for r in sched.waiting}
    sched.run_until_done()
    conts = []
    for p, pre in zip(prompts, partial):
        rec = restored[tuple(p) + tuple(pre)]
        assert rec.state == "finished"
        conts.append(pre + list(rec.output))
    return partial, conts, ticks, n_restored


def _cli_model(cli, model):
    """A context in which the CLI's resolve_model hands back `model` (the
    preset cut to the checkpoint's depth)."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        saved = cli.resolve_model
        cli.resolve_model = lambda args: model
        try:
            yield
        finally:
            cli.resolve_model = saved
    return ctx()


def phase_ckpt(torch, model, params, tok):
    """Checkpoints on the serve phase's Llama-3-8B tree cut to CKPT_LAYERS
    layers at full width: written as an HF directory (4 safetensors
    files, this script's own writer and inverse map), then `serve --model
    llama3-8b --ckpt` through build_serving with the preset resolved at
    that depth (its load timed and watched: host RSS, card peak; every
    leaf equal to the source), 8 requests over HTTP with a 500 ms POST
    /debug/profile among them (the trace must name the paged kernel),
    greedy tokens of the loaded and the in-memory trees on 4 prompts, a
    serving snapshot taken mid-flight and restored on the loaded bf16
    tree (equal continuations, first divergences, the teacher-forced
    gap), `generate --ckpt` through the CLI, the snapshot again in f32
    at 4 layers (exact), and save_checkpoint -> load_sharded onto the one-card tensor = 2 mesh (4 layers) against
    shard_params. Returns {kernel: launches}."""
    import contextlib
    import dataclasses
    import io
    import shutil
    from http.server import ThreadingHTTPServer

    from butterfly_tpu_torch.ckpt import config_from_hf_dir, load_checkpoint
    from butterfly_tpu_torch.ckpt import sharded
    from butterfly_tpu_torch.core.config import llama3_8b
    from butterfly_tpu_torch.engine.engine import InferenceEngine
    from butterfly_tpu_torch.engine.sampling import SamplingParams
    from butterfly_tpu_torch.models.common import Model
    from butterfly_tpu_torch.models.draft import _slice_layers
    from butterfly_tpu_torch.parallel.partition import shard_params
    from butterfly_tpu_torch.serve import cli
    from butterfly_tpu_torch.serve.server import (ServerState, build_serving,
                                                  make_handler)
    t_phase = time.monotonic()
    L = CKPT_LAYERS
    model = Model(model.cfg.replace(num_layers=L), device="cuda")
    params = dict(params, layers=_slice_layers(params["layers"], L))
    cfg = model.cfg
    root = os.path.join(ROOT, "build", "smoke_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    hf_dir = os.path.join(root, "hf")
    os.makedirs(hf_dir)
    free_gb = shutil.disk_usage(root).free / 1e9
    tree_bytes = _tree_bytes(params)
    assert free_gb * 1e9 > 1.5 * tree_bytes, \
        f"{free_gb:.1f} GB free under build/: the checkpoint needs more"

    # 1. the HF directory, written by this script
    torch.cuda.synchronize()
    t0 = time.monotonic()
    staging = torch.empty(max(params["embed"]["tok"].nbytes,
                              params["lm_head"].nbytes), dtype=torch.uint8,
                          pin_memory=True)
    written = 0
    for k, named in enumerate(_hf_llama_tensors(params, cfg)):
        written += _write_safetensors(torch, os.path.join(
            hf_dir, f"model-{k + 1:05d}-of-{CKPT_FILES:05d}.safetensors"),
            named, staging)
    del staging
    with open(os.path.join(hf_dir, "config.json"), "w") as f:
        json.dump(_hf_llama_config(cfg), f)
    write_s = time.monotonic() - t0
    log("ckpt", step="write", files=CKPT_FILES, GB=f"{written / 1e9:.3f}",
        write_s=f"{write_s:.2f}", GB_per_s=f"{written / 1e9 / write_s:.3f}",
        disk_free_GB=f"{free_gb:.1f}")
    hcfg = config_from_hf_dir(hf_dir)
    assert dataclasses.asdict(hcfg) == dataclasses.asdict(
        llama3_8b().replace(num_layers=L)), hcfg

    # 2. serve --ckpt: the CLI's loader on cuda:0, timed and watched
    args = cli.build_parser().parse_args(
        ["serve", "--model", "llama3-8b", "--ckpt", hf_dir, "--device",
         "cuda", "--host", "127.0.0.1", "--port", "0"])
    stats = {}
    t0 = time.monotonic()
    with _measured_loader(torch, stats), _cli_model(cli, model):
        sched, stok, rt = build_serving(args)
    setup_s = time.monotonic() - t0
    engine = sched.engine
    loaded = engine.params
    _trees_equal(torch, loaded, params)
    assert stats["card_peak"] < 1.25 * tree_bytes, \
        f"the load peaked at {stats['card_peak']} bytes on the card"
    log("ckpt", step="load", device="cuda:0", GB=f"{tree_bytes / 1e9:.3f}",
        load_s=f"{stats['load_s']:.2f}",
        GB_per_s=f"{tree_bytes / 1e9 / stats['load_s']:.3f}",
        host_rss_peak_growth_GB=f"{stats['rss_growth'] / 1e9:.3f}",
        card_peak_growth_GB=f"{stats['card_peak'] / 1e9:.3f}",
        card_peak_over_tree=f"{stats['card_peak'] / tree_bytes:.4f}",
        leaves_equal=True, serve_setup_s=f"{setup_s:.1f}",
        note="files in the page cache after the write")

    # 3. 8 requests over HTTP, a profile capture among them
    class Server(ThreadingHTTPServer):
        request_queue_size = 128

    state = ServerState(sched, stok)
    state.thread.start()
    httpd = Server(("127.0.0.1", 0), make_handler(state))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_port}"
    sizes = [16, 64, 200, 400, 600, 800, 1000, 1200]
    news = [32, 40, 48, 56, 64, 32, 40, 64]
    results = [None] * len(sizes)
    prof = {}
    logdir = os.path.join(root, "profile")

    def one(i):
        results[i] = _post(url, {"prompt": _TEXT[:sizes[i]],
                                 "max_tokens": news[i], "temperature": 0.0,
                                 "stop_token": -1})

    def decoding_only():
        # mixed blocks with prefill lanes attend through the dense gather;
        # the paged kernel runs once all 8 requests are in and every live
        # one decodes
        with state.lock:
            live = sched.unfinished_requests()
            return (sched._c_requests.value >= submitted + len(sizes)
                    and bool(live) and all(r.state == "running"
                                           for r in live))

    def capture():
        deadline = time.monotonic() + 120
        while not decoding_only() and time.monotonic() < deadline:
            time.sleep(0.02)
        req = urllib.request.Request(
            url + "/debug/profile", data=json.dumps(
                {"duration_ms": 500, "logdir": logdir}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            prof["status"], prof["body"] = resp.status, json.loads(resp.read())

    submitted = sched._c_requests.value   # the warm-up's
    try:
        _zero_counts()
        t0 = time.monotonic()
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(sizes))]
        threads.append(threading.Thread(target=capture))
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.monotonic() - t0
        n = _launch_counts()
    finally:
        state.stop.set()
        httpd.shutdown()
        httpd.server_close()
        if state.heartbeat is not None:
            state.heartbeat.stop()
        state.thread.join(timeout=30)
    for i, r in enumerate(results):
        assert r is not None, f"request {i} got no answer"
        code, body = r
        assert code == 200, f"request {i}: HTTP {code}"
        assert len(body["tokens"]) == news[i], f"request {i}"
    assert n["paged"] > 0 and n["paged"] % L == 0, n
    assert prof.get("status") == 200, prof
    trace_path = prof["body"]["trace"]
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    paged_events = [e for e in events
                    if re.search(r"paged_\w*kernel", str(e.get("name")))]
    kernels = collections.Counter(
        str(e.get("name"))[:50] for e in events if e.get("cat") == "kernel")
    assert paged_events, (
        f"the profile names no paged_*_kernel: {len(events)} events, "
        f"{sum(kernels.values())} kernels {kernels.most_common(4)}, "
        f"categories {collections.Counter(e.get('cat') for e in events)}, "
        f"{prof['body']}")
    gen_tokens = sum(len(b["tokens"]) for _, b in results)
    log("ckpt", step="serve", requests_answered=len(results),
        generated_tokens=gen_tokens, wall_s=f"{wall:.3f}",
        tokens_per_s=f"{gen_tokens / wall:.2f}",
        paged_attention_launches=n["paged"],
        decode_steps=n["paged"] // L, note="smoke run, not a benchmark")
    log("ckpt", step="profile", http=prof["status"],
        duration_ms=prof["body"]["duration_ms"],
        trace_MB=f"{os.path.getsize(trace_path) / 1e6:.2f}",
        events=len(events), paged_kernel_events=len(paged_events),
        kernels=",".join(sorted({re.search(r"paged_\w*kernel", str(
            e["name"])).group(0) for e in paged_events})))
    counts = dict(n)
    engine.cache = engine._kv_window = None
    del sched, state, engine
    gc.collect()
    torch.cuda.empty_cache()

    # 4. the loaded and the in-memory tree: identical greedy tokens
    t0 = time.monotonic()
    # short prompts: a mixed block inlines 32 prompt tokens, so a long one
    # would prefill for dozens of ticks while the others decode
    prompts = [tok.encode(_TEXT[:k]) for k in (16, 64, 128, 256)]
    got, _ = _greedy_run((model, loaded, rt), prompts, SNAP_NEW)
    want, _ = _greedy_run((model, params, rt), prompts, SNAP_NEW)
    assert got == want, "the loaded tree's greedy tokens differ"
    log("ckpt", step="parity", prompts=len(prompts), new_tokens=SNAP_NEW,
        identical_requests=sum(a == b for a, b in zip(got, want)),
        s=f"{time.monotonic() - t0:.1f}")

    # 5. a serving snapshot mid-flight on the loaded bf16 tree, restored
    # into a fresh scheduler: the restore recomputes each partial output
    # through the prefill path, whose bf16 rounding may flip near-tied
    # tokens of random weights, so equal continuations and first
    # divergences are reported and the teacher-forced gap is held to
    # LOGITS_TOL (as the tp phase does)
    t0 = time.monotonic()
    snap = os.path.join(root, "snapshot_bf16.json")
    partial, conts, ticks, n_restored = _snapshot_restore(
        (model, loaded, rt), prompts, SNAP_NEW, snap)
    equal, first, gaps = 0, [], []
    for p, c, ref in zip(prompts, conts, got):
        if c == ref:
            equal += 1
        else:
            first.append(_divergence(c, ref))
            gaps.append(_teacher_forced_gap(torch, loaded, cfg, p, c))
    log("ckpt", step="snapshot", layers=L, dtype=cfg.dtype,
        ticks_before=ticks, restored=n_restored,
        partial_tokens=",".join(str(len(p)) for p in partial),
        continuations_equal=f"{equal}/{len(prompts)}",
        first_divergence=",".join(map(str, first)) or "none",
        teacher_forced_gap=f"{max(gaps):.4g}" if gaps else "none",
        gap_bound=LOGITS_TOL, s=f"{time.monotonic() - t0:.1f}")
    if gaps:
        assert max(gaps) <= LOGITS_TOL, f"teacher-forced gap {max(gaps)}"
    del loaded
    gc.collect()
    torch.cuda.empty_cache()

    # 6. generate --ckpt through the CLI
    t0 = time.monotonic()
    out, err = io.StringIO(), io.StringIO()
    _zero_counts()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err), \
            _cli_model(cli, model):
        rc = cli.main(["generate", "--model", "llama3-8b", "--device", "cuda",
                       "--ckpt", hf_dir, "--prompt", _TEXT[:300],
                       "--max-new", "16"])
    n = _launch_counts()
    assert rc == 0, f"generate --ckpt rc {rc}: {err.getvalue()}"
    assert n["fresh"] == L, f"{n['fresh']} fresh flash launches for one prefill"
    for k in counts:
        counts[k] += n[k]
    ref = InferenceEngine(model, params).generate(
        [tok.encode(_TEXT[:300])],
        SamplingParams(max_new_tokens=16, stop_token=tok.eos_id))
    m = int(ref.lengths[0])
    assert out.getvalue().rstrip("\n") == tok.decode(
        ref.tokens[0, :m].tolist()), "generate --ckpt text differs"
    log("ckpt", step="generate", rc=rc, fresh_launches=n["fresh"],
        text_equal=True, stderr=err.getvalue().strip().replace(" ", "_"),
        s=f"{time.monotonic() - t0:.1f}")
    gc.collect()
    torch.cuda.empty_cache()

    # 7. the snapshot again in float32 at SNAP_LAYERS layers, loaded from
    # the same directory: rounding cannot decide a token there, so the
    # continuation must equal the uninterrupted run exactly
    t0 = time.monotonic()
    cfg_s = cfg.replace(num_layers=SNAP_LAYERS, dtype="float32")
    model_s = Model(cfg_s, device="cuda")
    p_s = load_checkpoint(hf_dir, cfg_s, "cuda:0")
    full, _ = _greedy_run((model_s, p_s, rt), prompts, SNAP_NEW)
    partial, conts, ticks, n_restored = _snapshot_restore(
        (model_s, p_s, rt), prompts, SNAP_NEW,
        os.path.join(root, "snapshot_f32.json"))
    assert conts == full, "the restored run diverges"
    log("ckpt", step="snapshot", layers=SNAP_LAYERS, dtype="float32",
        ticks_before=ticks, restored=n_restored,
        partial_tokens=",".join(str(len(p)) for p in partial),
        continuation_equal=True, s=f"{time.monotonic() - t0:.1f}")
    del p_s
    gc.collect()
    torch.cuda.empty_cache()

    # 8. save_checkpoint -> load_sharded onto tensor = 2 on one card
    cfg4 = cfg.replace(num_layers=SNAP_LAYERS)
    p4 = dict(params, layers=_slice_layers(params["layers"], SNAP_LAYERS))
    own = os.path.join(root, "own")
    torch.cuda.synchronize()
    t0 = time.monotonic()
    sharded.save_checkpoint(own, p4, cfg4, step=3)
    save_s = time.monotonic() - t0
    assert sharded.load_config(own) == (cfg4, 3)
    mesh = _one_card_mesh(tensor=2)
    want4 = shard_params(p4, cfg4, mesh)
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    got4 = sharded.load_sharded(own, cfg4, mesh)
    torch.cuda.synchronize()
    load4_s = time.monotonic() - t0
    grown = torch.cuda.memory_allocated() - before
    _shards_equal(torch, got4, want4)
    b4 = _tree_bytes(p4)
    log("ckpt", step="sharded", mesh="tensor2_one_card", layers=SNAP_LAYERS,
        GB=f"{b4 / 1e9:.3f}", save_s=f"{save_s:.2f}",
        save_GB_per_s=f"{b4 / 1e9 / save_s:.3f}", load_s=f"{load4_s:.2f}",
        load_GB_per_s=f"{b4 / 1e9 / load4_s:.3f}",
        allocated_GB=f"{grown / 1e9:.3f}", shards_equal=True)
    del got4, want4
    shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log("ckpt", phase_s=f"{time.monotonic() - t_phase:.1f}")
    return counts


# -- phase 20: tensor and data parallelism on one card ---------------------------

TP_DP_LAYERS = 4     # the tensor = 4 x data = 2 serving run: 4 layers
TP_GEN_LAYERS = 8    # tensor = 8 generate and its step check: 8 layers (time)
TP_NEW = 32          # new tokens of the tensor-parallel requests
# the tensor = 2 serving run's requests: every other serve-phase size
# (cut: PERF.md section 4; its prefill, not its decode, takes the time)
TP_SERVE = slice(0, None, 2)


def _one_card_mesh(**axes):
    """A mesh of every shard on cuda:0 (build_mesh refuses more shards
    than cards)."""
    from butterfly_tpu_torch.core.config import MeshConfig
    from butterfly_tpu_torch.core.mesh import make_mesh
    mc = MeshConfig(**axes)
    return make_mesh(mc, ["cuda:0"] * mc.num_devices)


def _launch_counts():
    from butterfly_tpu_torch.ops.flash_attention import flash_attention
    from butterfly_tpu_torch.ops.paged_attention import paged_attention
    return {"paged": paged_attention.launches,
            "fresh": flash_attention.launches_fresh,
            "warm": flash_attention.launches_warm}


def _zero_counts():
    from butterfly_tpu_torch.ops.flash_attention import flash_attention
    from butterfly_tpu_torch.ops.paged_attention import paged_attention
    paged_attention.launches = 0
    flash_attention.launches_fresh = flash_attention.launches_warm = 0


def _shard_on_card(torch, tree, cfg, mesh, place=None):
    """The tree placed over `mesh` by `place` (default shard_params; an
    int8 tree through shard_quantized_params): returns (sharded tree,
    bytes the placement allocated, split leaves), every part checked to
    be a view of its leaf's storage."""
    from butterfly_tpu_torch.parallel.partition import Shards, shard_params
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    sharded = (place or shard_params)(tree, cfg, mesh)
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - before
    split = 0

    def walk(s, t):
        nonlocal split
        if isinstance(s, dict):
            for k in s:
                walk(s[k], t[k])
        elif isinstance(s, Shards):
            split += 1
            for part in s.parts:
                if isinstance(part, Shards):   # an expert part over tensor
                    walk(part, t)
                    continue
                assert part.untyped_storage().data_ptr() == \
                    t.untyped_storage().data_ptr(), "a part is not a view"
    walk(sharded, tree)
    return sharded, grown, split


def _weight_shapes(tree):
    """The shapes a copy of a split weight part would have: one layer's
    slice of each part (whole parts for the embedding and the head), as
    it is, with a leading batch dim of 1, and merged into 2-D (the
    operand forms of an einsum's batched matmul)."""
    from butterfly_tpu_torch.parallel.partition import Shards
    out = set()

    def forms(shape):
        yield shape
        yield (1,) + shape
        for i in range(1, len(shape)):
            a = b = 1
            for d in shape[:i]:
                a *= d
            for d in shape[i:]:
                b *= d
            yield (a, b)
            yield (1, a, b)

    def walk(node, stacked):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, stacked or k == "layers")
        elif isinstance(node, Shards):
            for p in node.parts:
                out.update(forms(tuple(p.shape[1:] if stacked
                                       else p.shape)))
    walk(tree, False)
    return out


def _weight_copies(prof, shapes_of_weights, steps):
    """(count, device ms, source shapes) per step of aten::copy_ calls
    whose source has the shape of a weight part (`_weight_shapes`): the
    input shapes and the device time of the kernels each copy launched,
    read from the raw kineto events (obs/profile.py:op_kernels)."""
    from butterfly_tpu_torch.obs.profile import op_kernels
    n, us, shapes = 0, 0.0, {}
    for in_shapes, dev_us in op_kernels(prof, "aten::copy_"):
        if len(in_shapes) < 2:
            continue
        src = tuple(in_shapes[1])
        if src in shapes_of_weights:
            n += 1
            us += dev_us
            key = "x".join(map(str, src))
            shapes[key] = shapes.get(key, 0) + 1
    return n / steps, us / steps / 1e3, ",".join(
        f"{k}:{v // steps}" for k, v in sorted(shapes.items())) or "none"


def _step_inputs(torch, cfg):
    """A decode step's inputs on cuda:0, drawn from seed 5: a pool of
    random K/V for 8 slots at ragged lengths to 1300 tokens, a 64-wide
    window with entries staged, the active mask and one token a slot.
    Returns (cache, window, window lengths, active, tokens)."""
    from butterfly_tpu_torch.cache.paged import (init_kv_window,
                                                 init_paged_cache)
    from butterfly_tpu_torch.core.config import RuntimeConfig
    S, page = 8, 16
    rt = RuntimeConfig(max_batch_size=S, max_seq_len=2048, page_size=page)
    cache = init_paged_cache(cfg, rt, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    for t in (cache.k_pages, cache.v_pages):
        t.normal_(0.0, 0.5, generator=gen)
    mp = cache.page_table.shape[1]
    lengths = [5, 100, 700, 1300, 0, 33, 64, 1000]
    table = torch.full((S, mp), cache.null_page, dtype=torch.int32,
                       device="cuda")
    for s in range(S):
        n = -(-lengths[s] // page)
        table[s, :n] = torch.arange(s * mp, s * mp + n, dtype=torch.int32)
    cache = cache._replace(page_table=table, lengths=torch.tensor(
        lengths, dtype=torch.int32, device="cuda"))
    win = init_kv_window(cache, 64)
    for t in (win.k, win.v):
        t.normal_(0.0, 0.5, generator=gen)
    wlen = torch.tensor([3, 0, 10, 63, 0, 1, 7, 20], dtype=torch.int32,
                        device="cuda")
    active = torch.tensor([n > 0 for n in lengths], device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (S, 1), generator=gen,
                         device="cuda", dtype=torch.int32)
    return cache, win, wlen, active, toks


def _tp_step_check(torch, tree, sharded, cfg, mesh, label):
    """One windowed decode step (8 slots at ragged lengths to 1300
    tokens, window entries staged) on a pool of random K/V, unsharded
    and over `mesh`: the unsharded step with the kernel and with the
    plain version at every layer, and the sharded step with each shard's
    kernel checked against its plain version (LAYER_TOL). The sharded
    logits must agree with the unsharded kernel step within max(
    LOGITS_TOL, the unsharded kernel-vs-plain gap of this run). Its
    launches are checks, not a main path: the caller counts none."""
    import butterfly_tpu_torch.ops.paged_attention as pa_mod
    from butterfly_tpu_torch.cache.paged import paged_forward_window
    from butterfly_tpu_torch.core.mesh import mesh_ctx
    from butterfly_tpu_torch.ops.paged_attention import (paged_attention,
                                                         paged_attention_ref)
    from butterfly_tpu_torch.parallel.partition import (shard_kv_window,
                                                        shard_paged_cache)
    cache, win, wlen, active, toks = _step_inputs(torch, cfg)
    scache = shard_paged_cache(cache, cfg, mesh)
    swin = shard_kv_window(win, cfg, mesh)
    errs, kv_heads = [], set()

    def checked(q, kp, *args, **kw):
        out = paged_attention(q, kp, *args, **kw)
        ref = paged_attention_ref(q, kp, *args, **kw)
        errs.append((out.float() - ref.float()).abs().max().item())
        kv_heads.add((q.shape[1], kp.shape[1]))
        return out

    def step(params, c, w, attn, m=None):
        pa_mod.paged_attention = attn
        try:
            with mesh_ctx(m):
                logits, _ = paged_forward_window(params, cfg, toks, c, w,
                                                 wlen, active=active,
                                                 use_kernel=True)
        finally:
            pa_mod.paged_attention = paged_attention
        torch.cuda.synchronize()
        return logits[:, 0][active].float()

    kern = step(tree, cache, win, paged_attention)
    plain = step(tree, cache, win, paged_attention_ref)
    shard = step(sharded, scache, swin, checked, mesh)
    T = mesh.shape["tensor"]
    assert len(errs) == cfg.num_layers * T, (len(errs), T)
    for x in (kern, plain, shard):
        assert torch.isfinite(x).all()
    layer_err = max(errs)
    spread = (kern - plain).abs().max().item()
    gap = (shard - kern).abs().max().item()
    bound = max(LOGITS_TOL, spread)
    agree = (shard.argmax(-1) == kern.argmax(-1)).float().mean().item()
    log("tp", step=label, shards=T,
        shard_heads="/".join(f"Nq{a}_Kv{b}" for a, b in sorted(kv_heads)),
        kernel_calls=len(errs), max_layer_abs_err=f"{layer_err:.3g}",
        layer_tol=LAYER_TOL, logits_sharded_vs_unsharded=f"{gap:.4g}",
        logits_unsharded_kernel_vs_plain=f"{spread:.4g}",
        logits_bound=f"{bound:.4g}", argmax_agree=f"{agree:.3f}",
        max_abs_logit=f"{kern.abs().max().item():.4g}")
    assert layer_err <= LAYER_TOL, f"{label}: shard kernel vs plain " \
        f"{layer_err}"
    assert gap <= bound, f"{label}: sharded logits differ by {gap} > {bound}"
    del cache, scache, win, swin
    torch.cuda.empty_cache()


def _pool_bytes_per_shard(engine):
    from butterfly_tpu_torch.parallel.partition import axis_parts
    c = engine.cache
    per = None
    for t in (c.k_pages, c.v_pages, c.k_scale_pages, c.v_scale_pages):
        if t is None:
            continue
        parts = axis_parts(t, "tensor") or [t]
        sizes = [p.numel() * p.element_size() for p in parts]
        per = sizes if per is None else [a + b for a, b in zip(per, sizes)]
    return per


def phase_tp(torch, model, params, qparams, tok, serve_tokens, decode_ref):
    """Tensor and data parallelism on one card (module docstring, phase
    19). Returns {kernel: launches} of the phase's main paths."""
    from butterfly_tpu_torch.core.config import RuntimeConfig
    from butterfly_tpu_torch.engine.engine import InferenceEngine
    from butterfly_tpu_torch.engine.sampling import SamplingParams
    from butterfly_tpu_torch.engine.serving import ServingEngine
    from butterfly_tpu_torch.models.common import Model
    from butterfly_tpu_torch.obs.profile import device_kernels
    from butterfly_tpu_torch.obs import benchmark as bm
    from butterfly_tpu_torch.quant.int8 import shard_quantized_params
    from butterfly_tpu_torch.sched.scheduler import Scheduler
    from butterfly_tpu_torch.serve.cli import build_parser
    cfg = model.cfg
    L = cfg.num_layers
    card = torch.cuda.get_device_name(0).replace(" ", "_")
    counts = {"paged": 0, "fresh": 0, "warm": 0}

    def main_path(fn):
        _zero_counts()
        out = fn()
        torch.cuda.synchronize()
        for k, v in _launch_counts().items():
            counts[k] += v
        return out, _launch_counts()

    t_phase = time.monotonic()
    # (a) the placement: views of the one tree
    mesh2 = _one_card_mesh(tensor=2)
    sp2, grown, split = _shard_on_card(torch, params, cfg, mesh2)
    log("tp", step="shard_params", mesh="tensor2_on_cuda:0",
        split_leaves=split, weight_bytes_allocated=grown,
        tree_GB=f"{_tree_bytes(params) / 1e9:.3f}")
    assert grown == 0, f"the tensor = 2 placement allocated {grown} bytes"

    # (b) tensor = 2 serving at the serve defaults
    args = build_parser().parse_args(["serve", "--model", "llama3-8b"])
    rt = RuntimeConfig(max_batch_size=args.max_batch,
                       max_seq_len=args.max_seq, page_size=args.page_size)
    t0 = time.monotonic()
    engine = ServingEngine(model, sp2, rt, mesh=mesh2)
    sched = Scheduler(engine)
    setup = time.monotonic() - t0
    per_shard = _pool_bytes_per_shard(engine)
    pk = engine.cache.k_pages
    unsharded_pool = 2 * pk.numel() * pk.dtype.itemsize   # k and v
    (prompts, reqs, wall), n = main_path(
        lambda: _moe_serve(torch, sched, tok, cfg.vocab_size, TP_NEW,
                           _SERVE_BYTES[TP_SERVE]))
    assert n["paged"] > 0 and n["paged"] % (L * 2) == 0, n
    equal, gaps, first = 0, [], []
    for p, r, ref in zip(prompts, reqs, serve_tokens[TP_SERVE]):
        if r.output == ref[:TP_NEW]:
            equal += 1
        else:
            first.append(_divergence(r.output, ref[:TP_NEW]))
            gaps.append(_teacher_forced_gap(torch, params, cfg, p,
                                            r.output))
    ttfts = sorted(r.ttft for r in reqs)
    log("tp", step="serve", mesh="tensor2_on_cuda:0", layers=L,
        slots=rt.max_batch_size, setup_s=f"{setup:.1f}",
        wall_s=f"{wall:.3f}",
        tokens_per_s=f"{len(reqs) * TP_NEW / wall:.2f}",
        ttft_p50_s=f"{statistics.median(ttfts):.4f}",
        equal_to_serve_phase=f"{equal}/{len(reqs)}",
        first_divergence=",".join(map(str, first)) or "none",
        teacher_forced_gap=f"{max(gaps):.4g}" if gaps else "none",
        paged_launches=n["paged"],
        pool_bytes_per_shard="/".join(map(str, per_shard)),
        unsharded_pool_bytes=unsharded_pool,
        note="smoke run, not a benchmark")
    assert all(b * 2 == unsharded_pool for b in per_shard), per_shard
    if gaps:
        assert max(gaps) <= LOGITS_TOL, f"teacher-forced gap {max(gaps)}"

    # (c) the decode-step check at tensor = 2
    _tp_step_check(torch, params, sp2, cfg, mesh2, "parity_tensor2")

    # (d) a decode step's profile, sharded against unsharded
    wshapes = _weight_shapes(sp2)
    for name, eng in (("tensor2", engine),
                      ("unsharded", ServingEngine(model, params, rt))):
        step_ms, wall_ms, busy, prof, _ = _decode_step_profile(
            torch, eng, steps=5, record_shapes=True)
        top = sorted(device_kernels(prof), key=_dev_us, reverse=True)[:6]
        n_copy, copy_ms, copy_shapes = _weight_copies(prof, wshapes, 5)
        log("tp", step="profile", engine=name, host_step_ms=f"{step_ms:.3f}",
            traced_step_ms=f"{wall_ms:.3f}", device_busy_ms=f"{busy:.3f}",
            idle_share=f"{1 - busy / wall_ms:.3f}" if busy
            else "not measured",
            idle_share_untraced=f"{1 - busy / step_ms:.3f}" if busy
            else "not measured",
            weight_copies_per_step=f"{n_copy:g}",
            weight_copy_ms_per_step=f"{copy_ms:.4f}",
            weight_copy_shapes=copy_shapes)
        for e in top:
            log("tp", step="profile", engine=name,
                kernel=e.key[:60].replace(" ", "_"),
                ms_per_step=f"{_dev_us(e) / 5 / 1e3:.4f}",
                calls_per_step=e.count // 5)
        if name == "tensor2":
            assert n_copy == 0, f"{n_copy} weight copies per sharded step"
        else:
            eng.cache = eng._kv_window = None
        del eng
    engine.cache = engine._kv_window = None
    del engine, sched
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the alternating path at tensor = 2: fresh and warm flash per shard
    alt_rt = RuntimeConfig(max_batch_size=8, max_seq_len=2048,
                           page_size=16, mixed_dispatch=False)
    alt = Scheduler(ServingEngine(model, sp2, alt_rt, mesh=mesh2))
    sizes = [600, 1200]

    def run_alt():
        reqs = [alt.submit(tok.encode(_TEXT[:s]), max_new_tokens=8)
                for s in sizes]
        alt.run_until_done()
        return reqs
    areqs, n = main_path(run_alt)
    for r in areqs:
        assert r.state == "finished" and len(r.output) == 8, r.id
    assert n["fresh"] > 0 and n["warm"] > 0 and n["paged"] > 0, n
    assert n["fresh"] % (L * 2) == 0 and n["warm"] % (L * 2) == 0, n
    log("tp", step="alternate", mesh="tensor2_on_cuda:0",
        prompt_bytes=",".join(map(str, sizes)), fresh_launches=n["fresh"],
        warm_launches=n["warm"], paged_launches=n["paged"])
    alt.engine.cache = alt.engine._kv_window = None
    del alt
    gc.collect()

    # (f) tensor = 8 generate (BASELINE configs[1]) and its decode step, at
    #     TP_GEN_LAYERS layers, full width: depth only repeats the per-layer
    #     check (the Kv = 1 shard kernel runs in every layer)
    from butterfly_tpu_torch.models.draft import _slice_layers
    Lg = TP_GEN_LAYERS
    cfg_g = cfg.replace(num_layers=Lg)
    model_g = Model(cfg_g, device="cuda")
    p_g = dict(params, layers=_slice_layers(params["layers"], Lg))
    mesh8 = _one_card_mesh(tensor=8)
    sp8, grown8, _ = _shard_on_card(torch, p_g, cfg_g, mesh8)
    assert grown8 == 0, grown8
    gprompts = [tok.encode(_TEXT[:n]) for n in (16, 200, 600, 1000)]
    sp = SamplingParams(max_new_tokens=TP_NEW)
    want = InferenceEngine(model_g, p_g).generate(gprompts, sp).tokens
    eng8 = InferenceEngine(model_g, sp8, mesh=mesh8)
    eng8.generate(gprompts[:1], SamplingParams(max_new_tokens=2))
    torch.cuda.synchronize()
    t0 = time.monotonic()
    res, n = main_path(lambda: eng8.generate(gprompts, sp))
    gwall = time.monotonic() - t0
    _check_tokens(res, len(gprompts), TP_NEW, cfg.vocab_size,
                  "tensor = 8 generate")
    assert n["fresh"] == Lg * 8, n
    equal8 = sum(int((a == b).all()) for a, b in zip(res.tokens, want))
    gaps8 = [_teacher_forced_gap(torch, p_g, cfg_g, p, list(o))
             for p, o, w in zip(gprompts, res.tokens, want)
             if not (o == w).all()]
    log("tp", step="generate", mesh="tensor8_on_cuda:0", layers=Lg,
        prompt_tokens=",".join(str(len(p)) for p in gprompts),
        new_tokens=TP_NEW, wall_s=f"{gwall:.3f}",
        tokens_per_s=f"{len(gprompts) * TP_NEW / gwall:.2f}",
        fresh_launches=n["fresh"], shard_heads="Nq4_Kv1",
        equal_to_unsharded=f"{equal8}/{len(gprompts)}",
        teacher_forced_gap=f"{max(gaps8):.4g}" if gaps8 else "none")
    if gaps8:
        assert max(gaps8) <= LOGITS_TOL, f"teacher-forced gap {max(gaps8)}"
    del eng8
    _tp_step_check(torch, p_g, sp8, cfg_g, mesh8, "parity_tensor8")
    del sp8, p_g
    gc.collect()
    torch.cuda.empty_cache()

    # (g) tensor = 4 x data = 2 serving, 4 layers, prefix caching
    cfg4 = cfg.replace(num_layers=TP_DP_LAYERS)
    p4 = dict(params, layers=_slice_layers(params["layers"], TP_DP_LAYERS))
    model4 = Model(cfg4, device="cuda")
    mesh42 = _one_card_mesh(data=2, tensor=4)
    prompt = tok.encode(_TEXT[:600])
    seqs = (prompt, prompt, prompt[:300])
    rt4 = RuntimeConfig(max_batch_size=8, max_seq_len=2048, page_size=16,
                        prefix_caching=True)

    def run_one(s, p):
        r = s.submit(p, max_new_tokens=TP_NEW)
        s.run_until_done()
        assert r.state == "finished" and len(r.output) == TP_NEW, r.id
        return r.output
    plain = Scheduler(ServingEngine(model4, p4, rt4))
    want4 = [run_one(plain, p) for p in seqs]
    plain.engine.cache = plain.engine._kv_window = None
    dp = Scheduler(ServingEngine(model4, p4, rt4, mesh=mesh42))
    got4, n = main_path(lambda: [run_one(dp, p) for p in seqs])
    hits = dp.alloc.hit_tokens
    eq4 = sum(a == b for a, b in zip(got4, want4))
    gaps4 = [_teacher_forced_gap(torch, p4, cfg4, p, a)
             for p, a, b in zip(seqs, got4, want4) if a != b]
    log("tp", step="serve_data2_tensor4", mesh="data2_x_tensor4_on_cuda:0",
        layers=TP_DP_LAYERS, prefix_hit_tokens=hits,
        unsharded_prefix_hit_tokens=plain.alloc.hit_tokens,
        equal_to_unsharded=f"{eq4}/3",
        first_divergence=",".join(str(_divergence(a, b))
                                  for a, b in zip(got4, want4)),
        teacher_forced_gap=f"{max(gaps4):.4g}" if gaps4 else "none",
        paged_launches=n["paged"])
    assert hits >= 16, f"{hits} prefix hit tokens"
    if gaps4:
        assert max(gaps4) <= LOGITS_TOL, f"teacher-forced gap {max(gaps4)}"
    assert n["paged"] > 0 and n["paged"] % (TP_DP_LAYERS * 8) == 0, n
    dp.engine.cache = dp.engine._kv_window = None
    del dp, plain
    gc.collect()

    # (h) int8 weights at tensor = 2
    qsp2, qgrown, qsplit = _shard_on_card(torch, qparams, cfg, mesh2,
                                          shard_quantized_params)
    log("tp", step="shard_quantized_params", mesh="tensor2_on_cuda:0",
        split_leaves=qsplit, weight_bytes_allocated=qgrown)
    assert qgrown == 0, f"the int8 placement allocated {qgrown} bytes"
    _tp_step_check(torch, qparams, qsp2, cfg, mesh2, "parity_int8_tensor2")
    del qsp2

    # (i) the bench decode leg at tensor = 2
    dec, n = main_path(lambda: bm.run_decode_benchmark(
        model, sp2, batch=8, prompt_len=128, max_new=64, mesh=mesh2))
    print(f"[bench] leg=decode_tensor2 card={card} "
          + json.dumps(dec, sort_keys=True), flush=True)
    log("tp", step="bench_decode", mesh="tensor2_on_cuda:0",
        tok_s_per_card=f"{dec['decode_tokens_per_sec_per_chip']:.2f}",
        hbm_util=f"{dec['hbm_util']:.4f}", mfu=f"{dec['mfu']:.4f}",
        unsharded_tok_s_per_card="{:.2f}".format(
            decode_ref["decode_tokens_per_sec_per_chip"]),
        unsharded_hbm_util=f"{decode_ref['hbm_util']:.4f}",
        unsharded_mfu=f"{decode_ref['mfu']:.4f}", fresh_launches=n["fresh"])
    assert 0 < dec["hbm_util"] < 1 and dec["n_chips"] == 1, dec
    del sp2
    gc.collect()
    torch.cuda.empty_cache()
    for k, v in counts.items():
        assert v > 0, f"the {k} kernel never launched in the tp phase"
    log("tp", step="done", seconds=f"{time.monotonic() - t_phase:.1f}",
        **{f"{k}_launches": v for k, v in counts.items()})
    return counts


# -- phase 21: Mixtral-8x7B and expert parallelism ------------------------------

MOE_NEW = 16         # new tokens of the int8 runs: serve, generate, CLI,
                     # bench decode (cut for time: PERF.md section 4)
EP_LAYERS_F32 = 2    # the f32 expert-parallel check: full width, 2 layers
EP_LAYERS_BF16 = 4   # the bf16 expert-mesh serving run: full width, 4 layers
EP_REL_TOL = 1e-4    # f32 EP vs dense logits, relative to max |dense|


def _mem(torch, label, step):
    log(label, step=step, memory_allocated_GiB=
        f"{torch.cuda.memory_allocated() / 2**30:.3f}")


_SERVE_BYTES = (16, 64, 200, 400, 600, 800, 1000, 1200)


def _moe_serve(torch, sched, tok, vocab, news, sizes=_SERVE_BYTES):
    """Greedy requests (default 8, prompts of 16-1200 bytes) submitted
    together; returns (prompts, requests, wall seconds)."""
    prompts = [tok.encode(_TEXT[:n]) for n in sizes]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    reqs = [sched.submit(p, max_new_tokens=news) for p in prompts]
    sched.run_until_done()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    for r in reqs:
        assert r.state == "finished" and len(r.output) == news, r.id
        assert all(0 <= t < vocab for t in r.output), r.id
    return prompts, reqs, wall


def phase_moe(torch, tok):
    """Mixtral-8x7B at full width and depth on int8 weights, then the
    expert axis on one card (module docstring, phase 20). Returns
    ({kernel: launches} of the phase's main paths, the bf16 4-layer tree
    with its dense serve run for the combined phase)."""
    import contextlib
    import io

    from butterfly_tpu_torch.core.config import MeshConfig, RuntimeConfig
    from butterfly_tpu_torch.core.mesh import make_mesh, mesh_ctx
    from butterfly_tpu_torch.engine.engine import InferenceEngine
    from butterfly_tpu_torch.engine.sampling import SamplingParams
    from butterfly_tpu_torch.engine.serving import ServingEngine
    from butterfly_tpu_torch.models import common
    from butterfly_tpu_torch.models.common import (Model, forward, init_cache,
                                                   init_params)
    from butterfly_tpu_torch.ops.flash_attention import flash_attention
    from butterfly_tpu_torch.ops.paged_attention import paged_attention
    from butterfly_tpu_torch.parallel import expert as expert_mod
    from butterfly_tpu_torch.parallel.expert import dropped_assignments
    from butterfly_tpu_torch.parallel.partition import (Shards,
                                                        shard_params)
    from butterfly_tpu_torch.sched.scheduler import Scheduler
    from butterfly_tpu_torch.serve import cli
    from butterfly_tpu_torch.serve.server import build_serving
    card = torch.cuda.get_device_name(0).replace(" ", "_")
    counts = {"paged": 0, "fresh": 0}
    t_phase = time.monotonic()
    _mem(torch, "moe", "start")

    # 1. the int8 tree, drawn by the CLI's own loader (init_params_quantized
    #    on a seed-0 cuda generator: the bf16 tree, 92.9 GB, never exists)
    argv = ["serve", "--model", "mixtral-8x7b", "--device", "cuda",
            "--quant", "int8", "--port", "0", "--timeseries-interval", "0"]
    args = cli.build_parser().parse_args(argv)
    model = cli.resolve_model(args)
    cfg = model.cfg
    L = cfg.num_layers
    assert cfg.is_moe and cfg.moe_impl == "dense" and L == 32
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qparams = cli.load_params(model, args)
    torch.cuda.synchronize()
    leaves = _int8_leaves(qparams)
    n_leaves = len(leaves)
    assert n_leaves == 7 + 1, f"{n_leaves} quantized leaves"
    q_bytes = sum(leaf["q8"].nbytes for leaf in leaves)
    s_bytes = sum(leaf["s"].nbytes for leaf in leaves)
    del leaves   # the tree's memory must go with qparams later
    log("moe", step="tree", card=card, model=args.model, layers=L,
        experts=cfg.num_experts, top_k=cfg.num_experts_per_tok,
        hidden=cfg.hidden_size, ffn=cfg.intermediate_size,
        draw_s=f"{time.perf_counter() - t0:.2f}",
        int8_tree_GB=f"{_tree_bytes(qparams) / 1e9:.3f}",
        int8_codes_GB=f"{q_bytes / 1e9:.3f}",
        scales_MB=f"{s_bytes / 1e6:.2f}", quantized_leaves=n_leaves)
    _mem(torch, "moe", "tree")

    # 2. serve: build_serving's path at the serve defaults, 8 requests
    t0 = time.monotonic()
    with _cli_params(cli, qparams):
        sched, _, rt = build_serving(args)
    engine = sched.engine
    setup_s = time.monotonic() - t0
    assert rt.mixed_dispatch and rt.kv_write_combine \
        and rt.max_batch_size == 8 and rt.page_size == 16
    assert all(leaf["q8"].dtype == torch.int8
               for leaf in _int8_leaves(engine.params))
    paged_attention.launches = 0
    _, reqs, wall = _moe_serve(torch, sched, tok, cfg.vocab_size, MOE_NEW)
    n_paged = paged_attention.launches
    assert n_paged > 0 and n_paged % L == 0, n_paged
    counts["paged"] += n_paged
    gen = sum(len(r.output) for r in reqs)
    m = sched.metrics()
    log("moe", step="serve", card=card, slots=rt.max_batch_size,
        max_seq=rt.max_seq_len, page=rt.page_size, setup_s=f"{setup_s:.1f}",
        requests=len(reqs), generated_tokens=gen, wall_s=f"{wall:.3f}",
        tokens_per_s=f"{gen / wall:.2f}",
        ttft_p50_s=f"{statistics.median(r.ttft for r in reqs):.4f}",
        tick_host_frac="{:.4f}".format(m.get("tick_host_frac", -1)),
        paged_launches=n_paged, note="smoke run, not a benchmark")
    _mem(torch, "moe", "serve")

    # 3. the paged kernel against its plain version, in the model
    phase_parity(torch, engine, label="moe")

    # 4. where one decode step's time goes; the MoE blocks' device time
    #    reads from a profiler range around each moe_block call
    plain_moe = common.moe_block

    def ranged_moe(*a, **kw):
        with torch.profiler.record_function("moe_block"):
            return plain_moe(*a, **kw)
    common.moe_block = ranged_moe
    try:
        step_ms, wall_ms, _, prof, lengths = _decode_step_profile(
            torch, engine)
    finally:
        common.moe_block = plain_moe
    # the kernels' time only (the range's device-side annotation, which
    # spans the gaps between its kernels, is no kernel): the MoE blocks'
    # share is the kernels launched inside a moe_block range
    from butterfly_tpu_torch.obs.profile import (device_kernels,
                                                 range_device_us)
    ka = [e for e in device_kernels(prof) if e.key != "moe_block"]
    busy = sum(_dev_us(e) for e in ka) / 5 / 1e3
    moe_ms = range_device_us(prof, "moe_block") / 5 / 1e3
    top = sorted(ka, key=_dev_us, reverse=True)[:6]
    log("moe", step="profile", card=card, host_wall_ms=f"{step_ms:.3f}",
        traced_wall_ms=f"{wall_ms:.3f}",
        device_busy_ms=f"{busy:.3f}" if busy else "not measured",
        idle_share=f"{1 - busy / wall_ms:.3f}" if busy else "not measured",
        busy_over_untraced_wall=f"{busy / step_ms:.3f}",
        moe_block_device_ms=f"{moe_ms:.3f}",
        moe_share_of_busy=f"{moe_ms / busy:.3f}" if busy
        else "not measured", floor_ms_from_bytes=69,
        lengths=",".join(map(str, lengths)))
    for e in top:
        log("moe", kernel=e.key[:60].replace(" ", "_"),
            ms_per_step=f"{_dev_us(e) / 5 / 1e3:.4f}",
            calls_per_step=e.count // 5)
    engine.cache = engine._kv_window = None
    del sched, engine
    gc.collect()   # the scheduler and its engine sit in reference cycles
    torch.cuda.empty_cache()

    # 5. generate: 4 prompts of 17-1001 tokens, fused then stepped
    prompts = [tok.encode(_TEXT[:n]) for n in (16, 200, 600, 1000)]
    eng = InferenceEngine(model, qparams, RuntimeConfig())
    toks = {}
    for fused in (True, False):
        flash_attention.launches_fresh = flash_attention.launches_warm = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.generate(prompts, SamplingParams(max_new_tokens=MOE_NEW),
                           fused=fused)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_fresh = flash_attention.launches_fresh
        assert n_fresh > 0 and n_fresh % L == 0 \
            and flash_attention.launches_warm == 0, n_fresh
        counts["fresh"] += n_fresh
        _check_tokens(res, len(prompts), MOE_NEW, cfg.vocab_size,
                      "moe generate")
        toks[fused] = res.tokens
        log("moe", step="generate_fused" if fused else "generate_stepped",
            card=card, prompt_tokens=",".join(str(len(p)) for p in prompts),
            new_tokens=MOE_NEW, wall_s=f"{wall:.3f}",
            tokens_per_s=f"{len(prompts) * MOE_NEW / wall:.2f}",
            fresh_launches=n_fresh, note="smoke run, not a benchmark")
    assert (toks[True] == toks[False]).all(), "fused and stepped differ"
    del eng
    torch.cuda.empty_cache()

    # the CLI's generate and bench on that tree (its loader handed the
    # tree drawn above): `--model mixtral-8x7b --quant int8` on one card
    out, err = io.StringIO(), io.StringIO()
    flash_attention.launches_fresh = 0
    with _cli_params(cli, qparams), contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err):
        rc = cli.main(["generate", "--model", "mixtral-8x7b", "--quant",
                       "int8", "--device", "cuda", "--prompt", _TEXT[:300],
                       "--max-new", str(MOE_NEW)])
    assert rc == 0 and flash_attention.launches_fresh == L, \
        (rc, flash_attention.launches_fresh, err.getvalue())
    counts["fresh"] += flash_attention.launches_fresh
    log("moe", step="cli_generate", rc=rc, text_chars=len(out.getvalue()),
        stderr=err.getvalue().strip().replace(" ", "_"))

    # 6. the bench decode leg, through `butterfly bench`
    flash_attention.launches_fresh = paged_attention.launches = 0
    out = io.StringIO()
    t0 = time.monotonic()
    with _cli_params(cli, qparams), contextlib.redirect_stdout(out):
        rc = cli.main(["bench", "--model", "mixtral-8x7b", "--quant",
                       "int8", "--device", "cuda", "--batch", "8",
                       "--prompt-len", "128", "--max-new", str(MOE_NEW)])
    torch.cuda.synchronize()
    lines = out.getvalue().strip().splitlines()
    assert rc == 0 and len(lines) == 1, "bench CLI: not one JSON line"
    dec = json.loads(lines[0])
    counts["fresh"] += flash_attention.launches_fresh
    counts["paged"] += paged_attention.launches
    for k in ("decode_tokens_per_sec_per_chip", "hbm_util", "mfu"):
        assert dec[k] is not None and 0 < dec[k] < 1e9, (k, dec[k])
    assert dec["hbm_util"] < 1 and dec["mfu"] < 1
    print(f"[moe] step=bench_decode card={card} "
          f"wall_s={time.monotonic() - t0:.1f} "
          + json.dumps(dec, sort_keys=True), flush=True)
    del qparams
    gc.collect()
    torch.cuda.empty_cache()
    _mem(torch, "moe", "int8_tree_freed")

    # 7. the expert axis on one card: expert = 2, both shards on cuda:0
    mesh = make_mesh(MeshConfig(expert=2), ["cuda:0", "cuda:0"])
    E = cfg.num_experts
    gen_ = torch.Generator(device="cuda")
    gen_.manual_seed(0)
    # (a) f32, full width, 2 layers, no-drop capacity (cf = E)
    f32 = cfg.replace(num_layers=EP_LAYERS_F32, dtype="float32",
                      param_dtype="float32", moe_capacity_factor=float(E))
    params = init_params(f32, gen_, "cuda")
    before = torch.cuda.memory_allocated()
    sharded = shard_params(params, f32, mesh)
    grown = torch.cuda.memory_allocated() - before
    for name in ("w_gate", "w_up", "w_down"):
        leaf, full = sharded["layers"]["moe"][name], \
            params["layers"]["moe"][name]
        assert isinstance(leaf, Shards) and leaf.axis == "expert" \
            and len(leaf.parts) == 2
        for i, part in enumerate(leaf.parts):
            assert part.untyped_storage().data_ptr() == \
                full.untyped_storage().data_ptr(), (name, i)
    assert grown == 0, f"sharding allocated {grown} bytes"
    log("moe", step="ep_placement", mesh="expert2_on_cuda:0",
        f32_tree_GB=f"{_tree_bytes(params) / 1e9:.3f}",
        bytes_allocated_by_sharding=grown, views="all expert slices")
    ep = f32.replace(moe_impl="ep")
    ids = torch.tensor([tok.encode(_TEXT[:255])], device="cuda")
    assert ids.shape[1] == 256
    caches = {k: init_cache(f32, 1, 512, device="cuda")
              for k in ("dense", "ep")}
    with mesh_ctx(mesh):
        lg_ep, caches["ep"] = forward(sharded, ep, ids, caches["ep"],
                                      fresh=True)
    lg_d, caches["dense"] = forward(params, f32, ids, caches["dense"],
                                    fresh=True)
    ref_max = lg_d.abs().max().item()
    worst = (lg_ep - lg_d).abs().max().item() / ref_max
    cur = lg_d[:, -1:].argmax(-1).to(torch.int32)
    agree = bool((lg_ep[0].argmax(-1) == lg_d[0].argmax(-1)).all())
    for _ in range(8):
        with mesh_ctx(mesh):
            s_ep, caches["ep"] = forward(sharded, ep, cur, caches["ep"])
        s_d, caches["dense"] = forward(params, f32, cur, caches["dense"])
        worst = max(worst, (s_ep - s_d).abs().max().item()
                    / s_d.abs().max().item())
        agree = agree and bool(s_ep.argmax(-1).eq(s_d.argmax(-1)).all())
        cur = s_d[:, -1:].argmax(-1).to(torch.int32)
    log("moe", step="ep_f32", layers=EP_LAYERS_F32, prefill_tokens=256,
        decode_steps=8, max_rel_logit_err=f"{worst:.3g}",
        tol=EP_REL_TOL, greedy_equal=agree, max_abs_logit=f"{ref_max:.4g}")
    assert worst <= EP_REL_TOL, f"EP vs dense logits: {worst}"
    assert agree, "EP and dense greedy tokens differ"

    # (c) a dropping capacity (cf 1.0): finite logits; each layer's
    #     dropped assignments counted on the inputs its a2a dispatch gets
    drop = ep.replace(moe_capacity_factor=1.0)
    plain_ep = expert_mod.moe_block_ep
    dropped = []

    def counted_ep(x, p, c, capacity=None):
        dropped.append(dropped_assignments(x, p["router"], c, 2, capacity))
        return plain_ep(x, p, c, capacity)
    expert_mod.moe_block_ep = counted_ep
    try:
        with mesh_ctx(mesh):
            lg, _ = forward(sharded, drop, ids,
                            init_cache(drop, 1, 256, device="cuda"),
                            fresh=True)
    finally:
        expert_mod.moe_block_ep = plain_ep
    assert torch.isfinite(lg).all(), "dropping capacity: non-finite logits"
    assert len(dropped) == EP_LAYERS_F32
    log("moe", step="ep_drop", capacity_factor=1.0,
        dropped_assignments_per_layer=",".join(str(int(d)) for d in dropped),
        assignments_per_layer=256 * cfg.num_experts_per_tok,
        max_rel_diff_vs_no_drop=
        f"{(lg - lg_d).abs().max().item() / ref_max:.4g}")
    del params, sharded, caches, lg, lg_d, lg_ep
    gc.collect()
    torch.cuda.empty_cache()

    # (b) bf16, full width, 4 layers: 8 greedy requests on the expert mesh
    #     against the same requests on a dense engine
    b16 = cfg.replace(num_layers=EP_LAYERS_BF16, param_dtype="bfloat16",
                      moe_capacity_factor=float(E))
    params = init_params(b16, gen_, "cuda")
    outs = {}
    for name, mcfg, m in (("dense", b16, None),
                          ("ep", b16.replace(moe_impl="ep"), mesh)):
        eng = ServingEngine(Model(mcfg, device="cuda"), params,
                            RuntimeConfig(), mesh=m)
        paged_attention.launches = 0
        prompts, reqs, wall = _moe_serve(torch, Scheduler(eng), tok,
                                         cfg.vocab_size, 32)
        assert paged_attention.launches % EP_LAYERS_BF16 == 0
        counts["paged"] += paged_attention.launches
        outs[name] = (reqs, wall)
        eng.cache = eng._kv_window = None
        del eng
    equal, divs = 0, []
    gaps = {"dense": [], "ep": []}
    for p, rd, re_ in zip(prompts, outs["dense"][0], outs["ep"][0]):
        equal += rd.output == re_.output
        d = _divergence(rd.output, re_.output)
        if d is not None:
            divs.append(d)
        for name, r in (("dense", rd), ("ep", re_)):
            gaps[name].append(_teacher_forced_gap(torch, params, b16, p,
                                                  r.output))
    log("moe", step="ep_bf16_serve", layers=EP_LAYERS_BF16,
        requests=len(outs["ep"][0]), equal_to_dense=equal,
        first_divergences=",".join(map(str, divs)) or "none",
        teacher_forced_gap_max_ep=f"{max(gaps['ep']):.4f}",
        teacher_forced_gap_max_dense=f"{max(gaps['dense']):.4f}",
        dense_wall_s=f"{outs['dense'][1]:.2f}",
        ep_wall_s=f"{outs['ep'][1]:.2f}",
        note="bf16 near-ties may flip: reported, not asserted")
    _mem(torch, "moe", "end")
    log("moe", phase_s=f"{time.monotonic() - t_phase:.1f}",
        paged_launches=counts["paged"], fresh_launches=counts["fresh"])
    # the bf16 4-layer tree and the dense run go on to the combined phase
    return counts, dict(cfg=b16, params=params, prompts=prompts,
                        dense=[list(r.output) for r in outs["dense"][0]])



# -- phase 22: meshes that combine axes -------------------------------------

COMBINED_NEW = 16          # new tokens of the seq x tensor generate_long
COMBINED_SERVE = (1, 2, 3, 4)   # longserve's runs redone at seq x data:
#                                 16, 200, 4000 (the lane) and 600 bytes


def _pool_tensors(cache):
    return [getattr(cache, n) for n in ("k_pages", "v_pages",
                                        "k_scale_pages", "v_scale_pages")
            if getattr(cache, n) is not None]


def phase_combined(torch, model, params, tok, seq_last, longserve_runs):
    """Meshes that combine axes on Llama-3-8B at full width and depth,
    every shard on cuda:0 (module docstring, phase 21): seq = 2 x tensor
    = 2 generate_long and seq = 2 x data = 2 serving with the long-prompt
    lane. Returns {kernel: launches} of the phase's main paths."""
    import butterfly_tpu_torch.parallel.sequence as seq_mod
    from butterfly_tpu_torch.cache.paged import (init_paged_cache,
                                                 pool_replicas)
    from butterfly_tpu_torch.core.config import RuntimeConfig
    from butterfly_tpu_torch.engine.engine import InferenceEngine
    from butterfly_tpu_torch.engine.sampling import SamplingParams
    from butterfly_tpu_torch.engine.serving import ServingEngine
    from butterfly_tpu_torch.obs.health import all_hosts_probe
    from butterfly_tpu_torch.ops import ring_attention as ra
    from butterfly_tpu_torch.ops.paged_attention import paged_attention
    from butterfly_tpu_torch.parallel.partition import shard_paged_cache
    from butterfly_tpu_torch.parallel.sequence import sp_forward
    from butterfly_tpu_torch.sched.scheduler import Scheduler
    cfg = model.cfg
    L, N, T = cfg.num_layers, 2, 2
    card = torch.cuda.get_device_name(0).replace(" ", "_")
    counts = {"paged": 0, "ring": 0}
    t_phase = time.monotonic()
    assert all_hosts_probe(), "all_hosts_probe on the visible cards"
    log("combined", step="all_hosts_probe", card=card,
        devices=torch.cuda.device_count(), ok=True)

    # (a) seq = 2 x tensor = 2: generate_long on the 4096-token prompt
    mesh = _one_card_mesh(seq=N, tensor=T)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    eng = InferenceEngine(model, params, RuntimeConfig(max_seq_len=4096),
                          mesh=mesh)
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - before
    assert grown == 0, f"the seq x tensor placement allocated {grown} B"
    ids = tok.encode(_LONG)
    tokens = torch.tensor([ids], dtype=torch.int32, device="cuda")
    heads, errs, ratios = set(), [], []

    def checked(*args, kernel=None):
        stats = ra.ring_block_stats(*args)
        ref = ra.ring_block_stats_ref(*args)
        _, _, err, elem, _ = _ring_check(torch, ra, args, stats, ref, True)
        heads.add((args[0].shape[2], args[1].shape[2]))
        errs.append(err)
        ratios.append(elem)
        return stats
    seq_mod.block_stats = checked
    try:
        kern, _ = sp_forward(eng._replicas, cfg, tokens, mesh)
    finally:
        seq_mod.block_stats = ra.block_stats
    torch.cuda.synchronize()
    assert len(errs) == L * N * N * T, len(errs)
    assert heads == {(cfg.num_heads // T, cfg.num_kv_heads // T)}, heads
    last = kern[-1][0, -1].float().to("cuda:0")
    del kern
    gap = (last - seq_last).abs().max().item()
    log("combined", step="seq2_tensor2_ring", card=card,
        mesh="seq2_x_tensor2_on_cuda:0",
        placement_bytes_allocated=grown,
        per_shard_heads="Nq{}_Kv{}_H{}".format(
            cfg.num_heads // T, cfg.num_kv_heads // T, cfg.head_dim),
        blocks=len(errs), max_block_abs_err=f"{max(errs):.3g}",
        tol=LAYER_TOL, max_err_over_elem_bound=f"{max(ratios):.3g}",
        logits_vs_seq_only=f"{gap:.4g}", logits_tol=LOGITS_TOL)
    assert max(errs) <= LAYER_TOL and max(ratios) <= 1.0, \
        f"ring per tensor shard vs plain: {max(errs)}, {max(ratios)} x bound"
    assert torch.isfinite(last).all() and gap <= LOGITS_TOL, \
        f"seq x tensor logits differ from seq-only by {gap}"
    sp = SamplingParams(max_new_tokens=COMBINED_NEW)
    ra.launches = ra.launches_decode = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.generate_long(ids, sp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n, n_dec = ra.launches, ra.launches_decode
    want_dec = (COMBINED_NEW - 1) * L * (N + 1) * T
    assert n == L * N * N * T + want_dec and n_dec == want_dec, (n, n_dec)
    _check_tokens(res, 1, COMBINED_NEW, cfg.vocab_size, "seq2_tensor2")
    counts["ring"] += n
    pf_wall, ka, dev_ms = _profile(torch, lambda: sp_forward(
        eng._replicas, cfg, tokens, mesh))
    busy = sum(dev_ms(e) for e in ka)
    ring = sum(dev_ms(e) for e in ka if "ring" in e.key)
    log("combined", step="seq2_tensor2_generate_long", card=card,
        prompt_tokens=len(ids), new_tokens=COMBINED_NEW,
        wall_s=f"{wall:.3f}", tokens_per_s=f"{COMBINED_NEW / wall:.2f}",
        prefill_wall_ms=f"{pf_wall:.1f}",
        prefill_device_busy_ms=f"{busy:.1f}",
        prefill_ring_ms=f"{ring:.1f}",
        ring_launches=n, ring_launches_per_tensor_shard=n // T,
        ring_split_launches=n_dec, note="smoke run, not a benchmark")
    del eng
    torch.cuda.empty_cache()

    # (b) seq = 2 x data = 2: serving with the long-prompt lane, one pool
    #     copy per data group (what groups on their own cards hold)
    mesh = _one_card_mesh(seq=N, data=2)
    rt = RuntimeConfig(max_seq_len=4096, seq_parallel_threshold=1024)
    engine = ServingEngine(model, params, rt, mesh=mesh)
    engine.cache = None
    torch.cuda.empty_cache()
    engine.cache = shard_paged_cache(init_paged_cache(cfg, rt, device="cuda"),
                                     cfg, mesh, copy=True)
    reps = pool_replicas(engine.cache)
    assert len(reps) == 2
    sched = Scheduler(engine)
    runs = [longserve_runs[i] for i in COMBINED_SERVE]
    ra.launches = ra.launches_decode = paged_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    reqs = [sched.submit(list(p), max_new_tokens=m) for p, m, _ in runs]
    sched.run_until_done()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    n_ring, n_paged = ra.launches, paged_attention.launches
    sp_tokens = sched.metrics()["seq_parallel_prefill_tokens_total"]
    assert sp_tokens > 0, "no prompt went through the seq-parallel lane"
    for r, (_, m, _) in zip(reqs, runs):
        assert r.state == "finished" and len(r.output) == m, r.id
    for kname, k in (("ring", n_ring), ("paged", n_paged)):
        assert k > 0 and k % L == 0, f"{kname}: {k} launches"
    counts["ring"] += n_ring
    counts["paged"] += n_paged
    if engine._win_dirty:
        engine.flush_kv_window()
    torch.cuda.synchronize()
    # every replica holds every page the groups wrote (the null page,
    # where each group routes its idle rows, aside)
    same = all(torch.equal(a[:, :-1], b[:, :-1]) for a, b in
               zip(_pool_tensors(reps[0]), _pool_tensors(reps[1])))
    assert same, "the pool replicas differ"
    equal, divs, gaps = 0, [], []
    for (p, _, want), r in zip(runs, reqs):
        equal += r.output == want
        d = _divergence(r.output, want)
        if d is not None:
            divs.append(d)
            gaps.append(_teacher_forced_gap(torch, params, cfg, p, r.output))
    gen = sum(len(r.output) for r in reqs)
    log("combined", step="seq2_data2_serve", card=card,
        mesh="seq2_x_data2_on_cuda:0", pool_replicas=len(reps),
        replicas_equal=same, prompt_bytes=",".join(
            str(len(p) - 1) for p, _, _ in runs), requests=len(reqs),
        generated_tokens=gen, wall_s=f"{wall:.3f}",
        tokens_per_s=f"{gen / wall:.2f}", sp_prefill_tokens=int(sp_tokens),
        equal_to_longserve=f"{equal}/{len(reqs)}",
        first_divergence=",".join(map(str, divs)) or "none",
        teacher_forced_gap=f"{max(gaps):.4f}" if gaps else "none",
        gap_tol=LOGITS_TOL, ring_launches=n_ring, paged_launches=n_paged,
        note="smoke run, not a benchmark")
    assert not gaps or max(gaps) <= LOGITS_TOL, \
        f"teacher-forced gap {max(gaps)}"
    engine.cache = engine._kv_window = None
    del engine, sched, reps
    torch.cuda.empty_cache()
    log("combined", part="llama", phase_s=f"{time.monotonic() - t_phase:.1f}",
        ring_launches=counts["ring"], paged_launches=counts["paged"])
    return counts


def _moe_step_vs_dense(torch, params, cfg, mesh, data):
    """One decode step (window off, kernels on, 8 slots over a pool of
    random K/V at lengths up to 1300) on the expert mesh against the same
    step unsharded, the mesh pass replaying the unsharded kernel pass's
    expert choices (routing flips on bf16 ulps are not the mesh's error;
    phase_parity): returns (gap, bound = max(LOGITS_TOL, the gap between
    the two plain versions unsharded), flips, max |logit|)."""
    import butterfly_tpu_torch.models.common as common_mod
    import butterfly_tpu_torch.ops.paged_attention as pa_mod
    from butterfly_tpu_torch.cache.paged import init_paged_cache, paged_forward
    from butterfly_tpu_torch.core.config import RuntimeConfig
    from butterfly_tpu_torch.core.mesh import mesh_ctx
    from butterfly_tpu_torch.parallel import expert as expert_mod
    from butterfly_tpu_torch.parallel.partition import (shard_paged_cache,
                                                        shard_params)
    from butterfly_tpu_torch.ops.paged_attention import (paged_attention,
                                                         paged_attention_ref)
    rt = RuntimeConfig()
    S, L = rt.max_batch_size, cfg.num_layers
    pool = init_paged_cache(cfg, rt, device="cuda")
    mp, page = pool.page_table.shape[1], pool.page_size
    lengths = [5, 100, 700, 1300, 0, 33, 64, 1000][:S]
    table = torch.full((S, mp), pool.null_page, dtype=torch.int32,
                       device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    for s, n in enumerate(lengths):
        k = n // page + 1   # the step writes position n: its page too
        table[s, :k] = torch.arange(s * mp, s * mp + k, dtype=torch.int32)
    for t in (pool.k_pages, pool.v_pages):
        t.copy_(torch.randn(t.shape, generator=gen, device="cuda") * 0.5)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    dense_c = pool._replace(page_table=table, lengths=lens)
    mesh_c = shard_paged_cache(pool, cfg, mesh)._replace(page_table=table,
                                                         lengths=lens)
    ep = cfg.replace(moe_impl="ep")
    sharded = shard_params(params, ep, mesh)
    active = torch.tensor([n > 0 for n in lengths], device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (S, 1), generator=gen,
                         device="cuda", dtype=torch.int32)
    plain_route = common_mod.route_tokens
    chosen, flips = [], []

    def record(x, w, k):
        gates, idx = plain_route(x, w, k)
        chosen.append(idx)
        return gates, idx

    def replay(rows_of):
        calls = []

        def route(x, w, k):
            layer, rows = rows_of(len(calls))
            calls.append(1)
            _, own = plain_route(x, w, k)
            idx = chosen[layer][rows]
            flips.append(int((own.sort(-1).values != idx.sort(-1).values)
                             .any(-1).sum()))
            dt = torch.promote_types(x.dtype, w.dtype)
            lg = torch.einsum("btd,de->bte", x.to(dt), w.to(dt)).float()
            return torch.softmax(lg.gather(-1, idx), dim=-1), idx
        return route

    def step(tree, c, mcfg, m, attn, route, use_kernel=True):
        pa_mod.paged_attention = attn
        common_mod.route_tokens = expert_mod.route_tokens = route
        try:
            with mesh_ctx(m):
                logits, _ = paged_forward(tree, mcfg, toks, c, active=active,
                                          use_kernel=use_kernel)
        finally:
            pa_mod.paged_attention = paged_attention
            common_mod.route_tokens = expert_mod.route_tokens = plain_route
        torch.cuda.synchronize()
        return logits[:, 0][active].float()

    def whole(i):
        return i, slice(None)
    half = S // 2

    def per_group(i):   # each data group runs every layer on its rows
        g, layer = divmod(i, L)
        return layer, slice(g * half, (g + 1) * half)
    kern = step(params, dense_c, cfg, None, paged_attention, record)
    plain = step(params, dense_c, cfg, None, paged_attention_ref,
                 replay(whole))
    gather = step(params, dense_c, cfg, None, paged_attention,
                  replay(whole), use_kernel=False)
    flips.clear()
    got = step(sharded, mesh_c, ep, mesh, paged_attention,
               replay(per_group if data else whole))
    for x in (kern, plain, gather, got):
        assert torch.isfinite(x).all()
    bound = max(LOGITS_TOL, (plain - gather).abs().max().item())
    return ((got - kern).abs().max().item(), bound, sum(flips),
            kern.abs().max().item())


def phase_combined_moe(torch, tok, state):
    """Meshes that combine axes on Mixtral-8x7B at full width, bf16, cut
    to 4 layers (the moe phase's expert-run tree), every shard on cuda:0
    (module docstring, phase 21): expert = 2 x tensor = 2 and expert = 2
    x data = 2. Returns {kernel: launches} of the phase's main paths."""
    from butterfly_tpu_torch.core.config import RuntimeConfig
    from butterfly_tpu_torch.core.mesh import mesh_ctx
    from butterfly_tpu_torch.engine.engine import InferenceEngine
    from butterfly_tpu_torch.engine.sampling import SamplingParams
    from butterfly_tpu_torch.engine.serving import ServingEngine
    from butterfly_tpu_torch.models.common import Model, forward, init_cache
    from butterfly_tpu_torch.ops.flash_attention import flash_attention
    from butterfly_tpu_torch.ops.paged_attention import paged_attention
    from butterfly_tpu_torch.parallel import expert as expert_mod
    from butterfly_tpu_torch.parallel.partition import shard_params
    from butterfly_tpu_torch.sched.scheduler import Scheduler
    cfg, params = state["cfg"], state["params"]
    L, vocab = cfg.num_layers, cfg.vocab_size
    card = torch.cuda.get_device_name(0).replace(" ", "_")
    counts = {"paged": 0, "fresh": 0}
    t_phase = time.monotonic()
    ep = cfg.replace(moe_impl="ep")
    prompts = [tok.encode(_TEXT[:n]) for n in (17, 200, 500, 1001)]
    sp = SamplingParams(max_new_tokens=16)
    dense_gen = InferenceEngine(Model(cfg, device="cuda"), params).generate(
        prompts, sp)
    for axes in (dict(expert=2, tensor=2), dict(expert=2, data=2)):
        name = "_x_".join(f"{a}{n}" for a, n in axes.items())
        data = "data" in axes
        mesh = _one_card_mesh(**axes)
        # the placement: views of the tree, nothing allocated
        sharded, grown, split = _shard_on_card(torch, params, ep, mesh)
        assert grown == 0, f"{name}: the placement allocated {grown} B"
        del sharded
        # 8 greedy requests through the serving engine on the mesh
        eng = ServingEngine(Model(ep, device="cuda"), params,
                            RuntimeConfig(), mesh=mesh)
        _zero_counts()
        _, reqs, wall = _moe_serve(torch, Scheduler(eng), tok, vocab, 32)
        n_paged = paged_attention.launches
        assert n_paged > 0 and n_paged % L == 0, n_paged
        counts["paged"] += n_paged
        equal = sum(r.output == d for r, d in zip(reqs, state["dense"]))
        divs = [d for d in (_divergence(r.output, w) for r, w in
                            zip(reqs, state["dense"])) if d is not None]
        eng.cache = eng._kv_window = None
        del eng
        torch.cuda.empty_cache()
        # generate: the fresh flash kernel per tensor shard / data group
        geng = InferenceEngine(Model(ep, device="cuda"), params, mesh=mesh)
        _zero_counts()
        res = geng.generate(prompts, sp)
        n_fresh = flash_attention.launches_fresh
        assert n_fresh == L * 2, f"{name}: {n_fresh} fresh flash launches"
        counts["fresh"] += n_fresh
        gen_equal = int(sum((res.tokens[i] == dense_gen.tokens[i]).all()
                            for i in range(len(prompts))))
        del geng
        # the decode step against the dense run
        gap, bound, flips, top = _moe_step_vs_dense(torch, params, cfg,
                                                    mesh, data)
        # a dropping capacity: the a2a's drops against the dense-routing
        # count over the whole batch, layer by layer
        drop = ep.replace(moe_capacity_factor=1.0)
        made, seen = [], []
        plain_slots, plain_ep = expert_mod.a2a_slots, expert_mod.moe_block_ep

        def counted_slots(idx, E, C, base=None):
            dest, keep = plain_slots(idx, E, C, base)
            made.append((~keep).sum())
            return dest, keep

        def recorded_ep(x, p, c, capacity=None):
            seen.append((x, p["router"]))
            return plain_ep(x, p, c, capacity)
        ids = torch.tensor([tok.encode(_TEXT[:255]),
                            tok.encode(_TEXT[300:555])], device="cuda")
        dtree = shard_params(params, drop, mesh)
        expert_mod.a2a_slots = counted_slots
        expert_mod.moe_block_ep = recorded_ep
        try:
            with mesh_ctx(mesh):
                lg, _ = forward(dtree, drop, ids, init_cache(
                    drop, 2, 256, device="cuda", mesh=mesh), fresh=True)
        finally:
            expert_mod.a2a_slots = plain_slots
            expert_mod.moe_block_ep = plain_ep
        del dtree
        groups = 2 if data else 1
        assert len(seen) == L * groups, len(seen)
        want = 0
        for layer in range(L):
            xs = [seen[g * L + layer][0] for g in range(groups)]
            want += int(expert_mod.dropped_assignments(
                torch.cat(xs), seen[layer][1], drop, 2))
        got = int(sum(int(m) for m in made))
        assert torch.isfinite(lg).all()
        log("combined", step=f"{name}_moe", card=card, layers=L,
            mesh=f"{name}_on_cuda:0", placement_bytes_allocated=grown,
            split_leaves=split, requests=len(reqs),
            serve_equal_to_dense=f"{equal}/{len(reqs)}",
            serve_first_divergences=",".join(map(str, divs)) or "none",
            serve_wall_s=f"{wall:.2f}", paged_launches=n_paged,
            generate_equal_to_dense=f"{gen_equal}/{len(prompts)}",
            fresh_launches=n_fresh, step_logits_vs_dense=f"{gap:.4g}",
            step_bound=f"{bound:.4g}", step_max_abs_logit=f"{top:.4g}",
            routing_flips=flips,
            dropped_a2a=got, dropped_dense_routing=want,
            note="smoke run, not a benchmark")
        assert gap <= bound, f"{name}: step logits vs dense {gap} > {bound}"
        assert got == want > 0, f"{name}: {got} dropped, dense routing {want}"
    t_step = time.monotonic()
    more = _moe_mesh_combos(torch, tok, state, prompts, dense_gen, sp)
    step_s = time.monotonic() - t_step
    for k, v in more.items():
        counts[k] = counts.get(k, 0) + v
    log("combined", part="mixtral",
        phase_s=f"{time.monotonic() - t_phase:.1f}",
        mesh_combos_s=f"{step_s:.1f}", paged_launches=counts["paged"],
        fresh_launches=counts["fresh"], ring_launches=counts["ring"])
    return counts, step_s


COMBOS_LONG = 2048    # the seq = 2 x expert = 2 generate_long prompt
COMBOS_SERVE_NEW = 8  # stage = 2 x expert = 2 serving: 4 requests x 8 new


def _counted_drops(torch, run, drop):
    """run() with every a2a dispatch's dropped assignments counted as it
    sorts them and its input recorded: (run's result, dropped, the count
    of the dense routing over each dispatch's input at its capacity)."""
    from butterfly_tpu_torch.parallel import expert as expert_mod
    made, seen = [], []
    plain_slots, plain_ep = expert_mod.a2a_slots, expert_mod.moe_block_ep

    def counted_slots(idx, E, C, base=None):
        dest, keep = plain_slots(idx, E, C, base)
        made.append((~keep).sum())
        return dest, keep

    def recorded_ep(x, p, c, capacity=None):
        if expert_mod.takes_a2a(x, c):
            seen.append((x, p["router"]))
        return plain_ep(x, p, c, capacity)
    expert_mod.a2a_slots = counted_slots
    expert_mod.moe_block_ep = recorded_ep
    try:
        out = run()
    finally:
        expert_mod.a2a_slots = plain_slots
        expert_mod.moe_block_ep = plain_ep
    want = sum(int(expert_mod.dropped_assignments(x, r, drop, 2))
               for x, r in seen)
    return out, int(sum(int(m) for m in made)), want, len(seen)


def _tf_routing(torch, params, cfg, rows):
    """One plain dense forward (fresh) over each row's tokens, right-
    padded: (its logits [B, T, V] f32, per layer its expert choices
    [B, T, k]): the routing a replayed run takes (_replayed_routing)."""
    import butterfly_tpu_torch.models.common as common_mod
    from butterfly_tpu_torch.models.common import forward, init_cache
    T = max(len(r) for r in rows)
    seq = torch.zeros((len(rows), T), dtype=torch.long, device="cuda")
    for b, r in enumerate(rows):
        seq[b, :len(r)] = torch.tensor(r, device="cuda")
    table, plain = [], common_mod.route_tokens

    def record(x, w, k):
        gates, idx = plain(x, w, k)
        table.append(idx)
        return gates, idx
    common_mod.route_tokens = record
    try:
        logits, _ = forward(params, cfg, seq, init_cache(
            cfg, len(rows), T, device="cuda"), fresh=True)
    finally:
        common_mod.route_tokens = plain
    assert len(table) == cfg.num_layers, len(table)
    return logits.float(), table


@contextlib.contextmanager
def _replayed_routing(torch, table, where):
    """Every expert-parallel routing call inside the block takes its
    expert choices from `table` (per layer [B, T, k]): call c routes the
    rows and positions `where(c)` = (layer, rows [b], positions [b, t]) of
    it, its gates from this run's own router logits at those choices (as
    _moe_step_vs_dense replays). Yields (flips, calls): how many choices
    this run's own routing would have made otherwise, and the calls."""
    from butterfly_tpu_torch.parallel import expert as expert_mod
    plain = expert_mod.route_tokens
    flips, calls = [], []

    def route(x, w, k):
        layer, rows, pos = where(len(calls))
        calls.append(1)
        idx = table[layer][rows[:, None], pos]
        assert idx.shape[:2] == x.shape[:2], (idx.shape, x.shape)
        _, own = plain(x, w, k)
        flips.append((own.sort(-1).values != idx.sort(-1).values)
                     .any(-1).sum())
        dt = torch.promote_types(x.dtype, w.dtype)
        lg = torch.einsum("btd,de->bte", x.to(dt), w.to(dt)).float()
        return torch.softmax(lg.gather(-1, idx), dim=-1), idx
    expert_mod.route_tokens = route
    try:
        yield flips, calls
    finally:
        expert_mod.route_tokens = plain


def _replayed_gaps(torch, tf_logits, starts, got, want):
    """Each row's teacher-forced gap (the largest, over its emitted
    positions up to and including the first where `got` parts from
    `want`, of the gap between the position's maximum logit and the
    emitted token's) under `tf_logits`, the forward whose routing `got`
    replayed; beyond the first divergence the histories differ."""
    gaps = []
    for b, (g, w) in enumerate(zip(got, want)):
        d = _divergence(list(g), list(w))
        n = len(g) if d is None else d + 1
        lg = tf_logits[b, starts[b] - 1:starts[b] - 1 + n]
        emitted = torch.tensor(list(g)[:n], device="cuda", dtype=torch.long)
        gaps.append((lg.max(-1).values
                     - lg.gather(1, emitted[:, None])[:, 0]).max().item())
    return gaps


def _moe_mesh_combos(torch, tok, state, prompts, dense_gen, sp):
    """seq = 2 x expert = 2 and stage = 2 x expert = 2 on the moe phase's
    bf16 4-layer Mixtral tree, every shard on cuda:0 (module docstring,
    phase 22). Greedy tokens are held against the unmeshed run with the
    routing replayed from one dense forward over its tokens: on random
    bf16 weights a near-tied top-2 choice flips between any two
    arithmetics, the unmeshed engine's own included (the moe phase's
    ep_bf16_serve line), and one flip moves the logits by units. Returns
    {kernel: launches} of the main paths."""
    import butterfly_tpu_torch.parallel.sequence as seq_mod
    from butterfly_tpu_torch.core.config import RuntimeConfig
    from butterfly_tpu_torch.core.mesh import mesh_ctx
    from butterfly_tpu_torch.engine.engine import InferenceEngine
    from butterfly_tpu_torch.engine.serving import ServingEngine
    from butterfly_tpu_torch.models.common import Model, init_cache
    from butterfly_tpu_torch.ops import ring_attention as ra
    from butterfly_tpu_torch.parallel.partition import shard_params
    from butterfly_tpu_torch.parallel.pipeline import pipeline_forward
    from butterfly_tpu_torch.parallel.sequence import sp_forward
    from butterfly_tpu_torch.sched.scheduler import Scheduler
    cfg, params = state["cfg"], state["params"]
    L, N, Ne = cfg.num_layers, 2, 2
    card = torch.cuda.get_device_name(0).replace(" ", "_")
    ep = cfg.replace(moe_impl="ep")
    drop = ep.replace(moe_capacity_factor=1.0)
    counts = {"paged": 0, "fresh": 0, "ring": 0}
    new = sp.max_new_tokens

    def one(*xs):
        return torch.tensor([xs], device="cuda")

    # (a) seq = 2 x expert = 2: generate_long of a 2048-token prompt
    t0 = time.monotonic()
    mesh = _one_card_mesh(seq=N, expert=Ne)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    eng = InferenceEngine(Model(ep, device="cuda"), params,
                          RuntimeConfig(max_seq_len=4096), mesh=mesh)
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - before
    assert grown == 0, f"the seq x expert placement allocated {grown} B"
    ids = tok.encode(_LONG[:COMBOS_LONG - 1])
    T = len(ids)
    assert T == COMBOS_LONG, T
    tokens = torch.tensor([ids], dtype=torch.int32, device="cuda")
    errs, ratios = [], []

    def checked(*args, kernel=None):
        stats = ra.ring_block_stats(*args)
        ref = ra.ring_block_stats_ref(*args)
        _, _, err, elem, _ = _ring_check(torch, ra, args, stats, ref, True)
        errs.append(err)
        ratios.append(elem)
        return stats
    seq_mod.block_stats = checked
    try:
        kern, _ = sp_forward(eng._replicas, ep, tokens, mesh)
    finally:
        seq_mod.block_stats = ra.block_stats
    torch.cuda.synchronize()
    assert len(errs) == L * N * N, len(errs)
    assert all(torch.isfinite(x).all() for x in kern)
    del kern
    # a dropping capacity: each seq shard's a2a over its 1024-token chunk
    _, dropped, dense_drops, calls = _counted_drops(
        torch, lambda: sp_forward(eng._replicas, drop, tokens, mesh), drop)
    assert calls == L * N, calls
    # the unmeshed run, then generate_long with its routing replayed:
    # prefill call (layer, seq shard i, source j) routes positions
    # [i*Tl + j*Tl/Ne, ...), decode step k's layer call position T + k
    want = InferenceEngine(Model(cfg, device="cuda"), params,
                           RuntimeConfig(max_seq_len=4096)).generate(
        [ids], sp).tokens[0]
    tf_logits, table = _tf_routing(torch, params, cfg,
                                   [ids + list(want[:-1])])
    Ts = T // (N * Ne)

    def where(c):
        if c < L * N * Ne:
            layer, r = divmod(c, N * Ne)
            return layer, one(0)[0], torch.arange(
                r * Ts, (r + 1) * Ts, device="cuda")[None]
        k, layer = divmod(c - L * N * Ne, L)
        return layer, one(0)[0], one(T + k)
    ra.launches = ra.launches_decode = 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with _replayed_routing(torch, table, where) as (flips, routed):
        res = eng.generate_long(ids, sp)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    n, n_dec = ra.launches, ra.launches_decode
    want_dec = (new - 1) * L * (N + 1)
    assert n == L * N * N + want_dec and n_dec == want_dec, (n, n_dec)
    assert len(routed) == L * N * Ne + (new - 1) * L, len(routed)
    counts["ring"] += n
    _check_tokens(res, 1, new, cfg.vocab_size, "seq2_expert2")
    del eng
    gap = _replayed_gaps(torch, tf_logits, [T], res.tokens, [want])[0]
    div = _divergence(list(res.tokens[0]), list(want))
    del tf_logits, table
    log("combined", step="seq2_expert2_generate_long", card=card,
        mesh="seq2_x_expert2_on_cuda:0", layers=L,
        placement_bytes_allocated=grown, prompt_tokens=T, new_tokens=new,
        ring_blocks_checked=len(errs), max_block_abs_err=f"{max(errs):.3g}",
        tol=LAYER_TOL, max_err_over_elem_bound=f"{max(ratios):.3g}",
        a2a_calls=calls, dropped_a2a=dropped,
        dropped_dense_routing=dense_drops, ring_launches=n,
        ring_split_launches=n_dec, wall_s=f"{wall:.3f}",
        routing_replayed_calls=len(routed),
        routing_flips_replayed=int(sum(int(f) for f in flips)),
        equal_to_unmeshed=div is None,
        first_divergence="none" if div is None else div,
        teacher_forced_gap=f"{gap:.4g}", gap_tol=LOGITS_TOL,
        seconds=f"{time.monotonic() - t0:.1f}")
    assert max(errs) <= LAYER_TOL and max(ratios) <= 1.0, \
        f"ring per seq shard vs plain: {max(errs)}, {max(ratios)} x bound"
    assert dropped == dense_drops > 0, \
        f"seq x expert: {dropped} dropped, dense routing {dense_drops}"
    assert gap <= LOGITS_TOL, f"seq x expert: teacher-forced gap {gap}"
    torch.cuda.empty_cache()

    # (b) stage = 2 x expert = 2: GPipe generate (M = 4 microbatches of one
    #     row) with the routing replayed, serving, the step check
    t0 = time.monotonic()
    S, M = 2, len(prompts)
    Ls = L // S
    mesh = _one_card_mesh(stage=S, expert=Ne)
    sharded, grown, split = _shard_on_card(torch, params, ep, mesh)
    assert grown == 0, f"the stage x expert placement allocated {grown} B"
    geng = InferenceEngine(Model(ep, device="cuda"), sharded, mesh=mesh)
    lens = [len(p) for p in prompts]
    Tp = max(lens)
    tf_logits, table = _tf_routing(torch, params, cfg, [
        list(p) + list(w[:-1]) for p, w in zip(prompts, dense_gen.tokens)])
    plan = []      # the GPipe ticks: stage s on microbatch m = t - s
    for step in range(new):
        for t in range(M + S - 1):
            for s_ in range(S):
                m = t - s_
                if not 0 <= m < M:
                    continue
                for layer in range(s_ * Ls, (s_ + 1) * Ls):
                    if step == 0 and Tp % Ne == 0:     # a2a: Ne sources
                        plan += [(layer, m, torch.arange(
                            j * Tp // Ne, (j + 1) * Tp // Ne,
                            device="cuda")[None]) for j in range(Ne)]
                    elif step == 0:
                        plan.append((layer, m, torch.arange(
                            Tp, device="cuda")[None]))
                    else:
                        plan.append((layer, m, one(lens[m] + step - 1)))
    _zero_counts()
    with _replayed_routing(torch, table, lambda c: (
            plan[c][0], one(plan[c][1])[0], plan[c][2])) as (flips, routed):
        res = geng.generate(prompts, sp)
        torch.cuda.synchronize()
    n_fresh = _launch_counts()["fresh"]
    assert n_fresh == L * M, f"{n_fresh} fresh flash launches"
    assert len(routed) == len(plan), (len(routed), len(plan))
    counts["fresh"] += n_fresh
    _check_tokens(res, M, new, cfg.vocab_size, "stage2_expert2 generate")
    gaps = _replayed_gaps(torch, tf_logits, lens, res.tokens,
                          dense_gen.tokens)
    gdivs = [_divergence(list(a), list(b))
             for a, b in zip(res.tokens, dense_gen.tokens)]
    del geng, tf_logits, table
    # serving: 4 requests against the moe phase's dense run (reported: the
    # scheduler's programs cannot be replayed call by call)
    rt8 = RuntimeConfig(max_batch_size=8, max_seq_len=2048, page_size=16)
    sched = Scheduler(ServingEngine(Model(ep, device="cuda"), sharded, rt8,
                                    mesh=mesh))
    _zero_counts()
    _, reqs, swall = _moe_serve(torch, sched, tok, cfg.vocab_size,
                                COMBOS_SERVE_NEW, _SERVE_BYTES[:4])
    torch.cuda.synchronize()
    n_paged = _launch_counts()["paged"]
    assert n_paged > 0 and n_paged % L == 0, n_paged
    counts["paged"] += n_paged
    sdivs = [_divergence(r.output, d[:COMBOS_SERVE_NEW])
             for r, d in zip(reqs, state["dense"])]
    sched.engine.cache = sched.engine._kv_window = None
    del sched
    gc.collect()
    torch.cuda.empty_cache()
    _stage_step_check(torch, params, sharded, ep, mesh,
                      "stage2_expert2_parity", phase="combined")
    # a dropping capacity: each stage's a2a on its prefill microbatch
    dtree = shard_params(params, drop, mesh)
    two = torch.tensor([tok.encode(_TEXT[:255]), tok.encode(_TEXT[300:555])],
                       device="cuda")

    def prefill():
        with mesh_ctx(mesh):
            return pipeline_forward(dtree, drop, two, init_cache(
                drop, 2, 256, device="cuda", mesh=mesh), mesh,
                num_microbatches=2, fresh=True)[0]
    lg, dropped, dense_drops, calls = _counted_drops(torch, prefill, drop)
    assert calls == L * 2, calls
    assert torch.isfinite(lg).all()
    del dtree, lg, sharded
    log("combined", step="stage2_expert2", card=card,
        mesh="stage2_x_expert2_on_cuda:0", layers=L, microbatches=M,
        placement_bytes_allocated=grown, split_leaves=split,
        fresh_launches=n_fresh, routing_replayed_calls=len(routed),
        routing_flips_replayed=int(sum(int(f) for f in flips)),
        generate_equal_to_unmeshed=f"{gdivs.count(None)}/{M}",
        generate_first_divergences=",".join(
            str(d) for d in gdivs if d is not None) or "none",
        generate_teacher_forced_gap=f"{max(gaps):.4g}", gap_tol=LOGITS_TOL,
        serve_requests=len(reqs), serve_new_tokens=COMBOS_SERVE_NEW,
        serve_wall_s=f"{swall:.3f}",
        serve_equal_to_dense=f"{sdivs.count(None)}/{len(reqs)}",
        serve_first_divergences=",".join(
            str(d) for d in sdivs if d is not None) or "none",
        paged_launches=n_paged, a2a_calls=calls, dropped_a2a=dropped,
        dropped_dense_routing=dense_drops,
        seconds=f"{time.monotonic() - t0:.1f}",
        note="smoke run, not a benchmark")
    assert max(gaps) <= LOGITS_TOL, f"stage x expert: gaps {gaps}"
    assert dropped == dense_drops > 0, \
        f"stage x expert: {dropped} dropped, dense routing {dense_drops}"
    torch.cuda.empty_cache()
    return counts


# -- phase 23: pipeline stages ----------------------------------------------------

PIPE_SERVE_LAYERS = 8   # (b) stage = 2 serving: 8 layers (at full depth
                        # it took 45.2 s of a 116.4 s phase run alone)
PIPE_LAYERS = 8         # (d) generate and the combined meshes: 8 layers
PIPE_NEW = 16           # new tokens of the stage = 2 requests (cut for
                        # time: PERF.md section 4)
PIPE_MESH_BYTES = (16, 64, 200, 400)   # (d) serving: 4 requests, 8 new
PIPE_MESH_NEW = 8
PIPE_DRAFT_LAYERS = 6   # (d) the draft deeper than a stage's 4 layers
PIPE_DRAFT_GAMMA = 4


def _stage_pool_bytes(engine):
    """Bytes of every pool tensor, per stage (data replicas once)."""
    from butterfly_tpu_torch.parallel.partition import axis_parts
    from butterfly_tpu_torch.parallel.tensor import group_part
    c = engine.cache
    per = None
    for t in (c.k_pages, c.v_pages, c.k_scale_pages, c.v_scale_pages):
        if t is None:
            continue
        sizes = [_tree_bytes({"p": group_part(p, 0)})
                 for p in axis_parts(t, "stage")]
        per = sizes if per is None else [a + b for a, b in zip(per, sizes)]
    return per


def _stage_step_check(torch, tree, staged, cfg, mesh, label, phase="pipe"):
    """One decode step with the window off (8 slots at ragged lengths to
    1300 tokens) on a pool of random K/V, unsharded with the paged kernel
    and with its plain version at every layer, then through the GPipe
    schedule over `mesh` with every in-model kernel call of each stage
    checked against its plain version (LAYER_TOL). Each run writes its
    token into its own copy of the pool. The pipelined logits must agree
    with the unsharded kernel step within max(LOGITS_TOL, the unsharded
    kernel-vs-plain gap of this run). Its launches are checks, not a
    main path: the caller counts none."""
    import butterfly_tpu_torch.ops.paged_attention as pa_mod
    from butterfly_tpu_torch.cache.paged import (init_paged_cache,
                                                 paged_forward)
    from butterfly_tpu_torch.core.config import RuntimeConfig
    from butterfly_tpu_torch.core.mesh import mesh_ctx
    from butterfly_tpu_torch.ops.paged_attention import (paged_attention,
                                                         paged_attention_ref)
    from butterfly_tpu_torch.parallel.partition import shard_paged_cache
    S, page = 8, 16
    rt = RuntimeConfig(max_batch_size=S, max_seq_len=2048, page_size=page)
    cache = init_paged_cache(cfg, rt, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    for t in (cache.k_pages, cache.v_pages):
        t.normal_(0.0, 0.5, generator=gen)
    mp = cache.page_table.shape[1]
    lengths = [5, 100, 700, 1300, 0, 33, 64, 1000]
    table = torch.full((S, mp), cache.null_page, dtype=torch.int32,
                       device="cuda")
    for s in range(S):
        n = lengths[s] // page + 1     # a page for the token written too
        table[s, :n] = torch.arange(s * mp, s * mp + n, dtype=torch.int32)
    cache = cache._replace(page_table=table, lengths=torch.tensor(
        lengths, dtype=torch.int32, device="cuda"))
    active = torch.tensor([n > 0 for n in lengths], device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (S, 1), generator=gen,
                         device="cuda", dtype=torch.int32)
    errs = []

    def checked(q, kp, *args, **kw):
        out = paged_attention(q, kp, *args, **kw)
        ref = paged_attention_ref(q, kp, *args, **kw)
        errs.append((out.float() - ref.float()).abs().max().item())
        return out

    def step(params, c, attn, m=None):
        c = c._replace(k_pages=c.k_pages.clone(), v_pages=c.v_pages.clone())
        if m is not None:
            c = shard_paged_cache(c, cfg, m)
        pa_mod.paged_attention = attn
        try:
            with mesh_ctx(m):
                logits, _ = paged_forward(params, cfg, toks, c,
                                          active=active, use_kernel=True)
        finally:
            pa_mod.paged_attention = paged_attention
        torch.cuda.synchronize()
        return logits[:, 0][active].float()

    kern = step(tree, cache, paged_attention)
    plain = step(tree, cache, paged_attention_ref)
    shard = step(staged, cache, checked, mesh)
    M = 4   # the default microbatches of 8 slots over 2 stages
    assert len(errs) == cfg.num_layers * M, (len(errs), M)
    for x in (kern, plain, shard):
        assert torch.isfinite(x).all()
    layer_err = max(errs)
    spread = (kern - plain).abs().max().item()
    gap = (shard - kern).abs().max().item()
    bound = max(LOGITS_TOL, spread)
    agree = (shard.argmax(-1) == kern.argmax(-1)).float().mean().item()
    log(phase, step=label, stages=mesh.shape["stage"], microbatches=M,
        kernel_calls=len(errs), max_layer_abs_err=f"{layer_err:.3g}",
        layer_tol=LAYER_TOL, logits_staged_vs_unsharded=f"{gap:.4g}",
        logits_unsharded_kernel_vs_plain=f"{spread:.4g}",
        logits_bound=f"{bound:.4g}", argmax_agree=f"{agree:.3f}")
    assert layer_err <= LAYER_TOL, f"{label}: stage kernel vs plain " \
        f"{layer_err}"
    assert gap <= bound, f"{label}: staged logits differ by {gap} > {bound}"
    del cache
    torch.cuda.empty_cache()


def _serve_against(torch, tag, sched, ref, params, cfg, tok, news,
                   sizes=_SERVE_BYTES):
    """Greedy requests through `sched` (`_moe_serve`), held against `ref`
    (the same requests' tokens on an unsharded engine): equal count,
    first divergences, the teacher-forced gap of the others within
    LOGITS_TOL. Returns the log fields."""
    prompts, reqs, wall = _moe_serve(torch, sched, tok, cfg.vocab_size,
                                     news, sizes)
    equal, gaps, first = 0, [], []
    for p, r, want in zip(prompts, reqs, ref):
        if r.output == want[:news]:
            equal += 1
        else:
            first.append(_divergence(r.output, want[:news]))
            gaps.append(_teacher_forced_gap(torch, params, cfg, p,
                                            r.output))
    if gaps:
        assert max(gaps) <= LOGITS_TOL, f"{tag}: teacher-forced gap " \
            f"{max(gaps)}"
    ttfts = sorted(r.ttft for r in reqs)
    return dict(
        requests=len(reqs), new_tokens=news, wall_s=f"{wall:.3f}",
        tokens_per_s=f"{len(reqs) * news / wall:.2f}",
        ttft_p50_s=f"{statistics.median(ttfts):.4f}",
        equal_to_unsharded=f"{equal}/{len(reqs)}",
        first_divergence=",".join(map(str, first)) or "none",
        teacher_forced_gap=f"{max(gaps):.4g}" if gaps else "none")


def _stage_seq_generate(torch, model8, p8, gprompts, sp, want):
    """stage = 2 x seq = 2 on the tree cut to 8 layers: the seq axis a
    replica (no ring inside a stage), GPipe generate against the
    unsharded run's tokens `want`; generate_long refused there as the JAX
    engine refuses it. Returns (fresh flash launches of the generate,
    seconds)."""
    from butterfly_tpu_torch.engine.engine import InferenceEngine
    cfg8 = model8.cfg
    L8 = cfg8.num_layers
    t0 = time.monotonic()
    m = _one_card_mesh(stage=2, seq=2)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    eng = InferenceEngine(model8, p8, mesh=m)
    torch.cuda.synchronize()
    placed = torch.cuda.memory_allocated() - before
    _zero_counts()
    res = eng.generate(gprompts, sp)
    torch.cuda.synchronize()
    n_fresh = _launch_counts()["fresh"]
    _check_tokens(res, len(gprompts), sp.max_new_tokens, cfg8.vocab_size,
                  "stage = 2 x seq = 2 generate")
    assert n_fresh == L8 * 4, n_fresh   # 4 microbatches through 8 layers
    equal = sum(int((a == b).all()) for a, b in zip(res.tokens, want))
    gaps = [_teacher_forced_gap(torch, p8, cfg8, p, list(o))
            for p, o, w in zip(gprompts, res.tokens, want)
            if not (o == w).all()]
    try:
        eng.generate_long(gprompts[0])
        refused = None
    except NotImplementedError as e:
        refused = str(e)
    del eng
    seconds = time.monotonic() - t0
    log("pipe", step="generate_stage2_seq2", seconds=f"{seconds:.1f}",
        mesh="stage2_x_seq2_on_cuda:0", layers=L8,
        placement_bytes_allocated=placed, fresh_launches=n_fresh,
        equal_to_unsharded=f"{equal}/{len(gprompts)}",
        teacher_forced_gap=f"{max(gaps):.4g}" if gaps else "none",
        generate_long_refused=refused is not None)
    assert placed == 0, f"the stage x seq placement allocated {placed} B"
    assert not gaps or max(gaps) <= LOGITS_TOL, f"teacher-forced gap {gaps}"
    assert refused and "does not compose with pipeline stages" in refused, \
        refused
    torch.cuda.empty_cache()
    return n_fresh, seconds


def phase_pipe(torch, model, params, tok):
    """Pipeline stages on one card (module docstring, phase 23), every
    stage's shards on cuda:0. Returns {kernel: launches} of the phase's
    main paths."""
    from butterfly_tpu_torch.core.config import RuntimeConfig
    from butterfly_tpu_torch.engine.engine import InferenceEngine
    from butterfly_tpu_torch.engine.sampling import SamplingParams
    from butterfly_tpu_torch.engine.serving import ServingEngine
    from butterfly_tpu_torch.models.common import Model
    from butterfly_tpu_torch.models.draft import _slice_layers
    from butterfly_tpu_torch.sched.scheduler import Scheduler
    from butterfly_tpu_torch.serve.cli import build_parser
    cfg = model.cfg
    counts = {"paged": 0, "fresh": 0}
    t_phase = time.monotonic()

    def main_path(fn):
        _zero_counts()
        out = fn()
        torch.cuda.synchronize()
        for k in counts:
            counts[k] += _launch_counts()[k]
        return out, _launch_counts()

    def timed(step, t0):
        return dict(step=step, seconds=f"{time.monotonic() - t0:.1f}")

    # (a) the placement: each stage's layers are views of the one tree
    t0 = time.monotonic()
    mesh = _one_card_mesh(stage=2)
    sp2, grown, split = _shard_on_card(torch, params, cfg, mesh)
    log("pipe", **timed("shard_params", t0), mesh="stage2_on_cuda:0",
        split_leaves=split, weight_bytes_allocated=grown,
        tree_GB=f"{_tree_bytes(params) / 1e9:.3f}")
    assert grown == 0, f"the stage = 2 placement allocated {grown} bytes"

    # (b) stage = 2 serving at the serve defaults (M = 4 microbatches of 2
    #     slots): every program through the GPipe schedule, on the tree
    #     cut to PIPE_SERVE_LAYERS layers at full width, against the
    #     unsharded engine at that depth
    t0 = time.monotonic()
    Lb = PIPE_SERVE_LAYERS
    cfg_b = cfg.replace(num_layers=Lb)
    model_b = Model(cfg_b, device="cuda")
    tree_b = dict(params, layers=_slice_layers(params["layers"], Lb))
    args = build_parser().parse_args(["serve", "--model", "llama3-8b"])
    rt = RuntimeConfig(max_batch_size=args.max_batch,
                       max_seq_len=args.max_seq, page_size=args.page_size)
    plain = Scheduler(ServingEngine(model_b, tree_b, rt))
    ref = [r.output for r in _moe_serve(torch, plain, tok, cfg.vocab_size,
                                        PIPE_NEW)[1]]
    plain.engine.cache = plain.engine._kv_window = None
    del plain
    t1 = time.monotonic()
    engine = ServingEngine(model_b, tree_b, rt, mesh=mesh)
    assert not engine._window_mode
    pool = _stage_pool_bytes(engine)
    sched = Scheduler(engine)
    fields, n = main_path(lambda: _serve_against(
        torch, "stage2 serve", sched, ref, tree_b, cfg_b, tok, PIPE_NEW))
    # a decode step launches the kernel once per layer per microbatch
    assert n["paged"] > 0 and n["paged"] % (Lb * 4) == 0, n
    log("pipe", **timed("serve", t0), mesh="stage2_on_cuda:0", layers=Lb,
        reference_s=f"{t1 - t0:.1f}", slots=rt.max_batch_size,
        microbatches=4, **fields, paged_launches=n["paged"],
        fresh_launches=n["fresh"],
        pool_bytes_per_stage="/".join(map(str, pool)),
        note="smoke run, not a benchmark")
    engine.cache = None
    del engine, sched
    gc.collect()
    torch.cuda.empty_cache()

    # (c) one decode step, stage = 2 against unsharded: each stage's
    #     in-model paged kernel against its plain version
    t0 = time.monotonic()
    _stage_step_check(torch, params, sp2, cfg, mesh, "parity_stage2")
    log("pipe", **timed("parity_stage2_done", t0))
    del sp2

    # (d) 8 layers, full width: GPipe and interleaved generate, the int8
    #     pool, stage x tensor and stage x data serving, each against the
    #     unsharded engine at that depth
    t0 = time.monotonic()
    L8 = PIPE_LAYERS
    cfg8 = cfg.replace(num_layers=L8)
    model8 = Model(cfg8, device="cuda")
    p8 = dict(params, layers=_slice_layers(params["layers"], L8))
    gprompts = [tok.encode(_TEXT[:n]) for n in (16, 200, 600, 1000)]
    sp = SamplingParams(max_new_tokens=PIPE_NEW)
    want = InferenceEngine(model8, p8).generate(gprompts, sp).tokens
    for V in (1, 2):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        eng = InferenceEngine(model8, p8, mesh=mesh, virtual_stages=V)
        torch.cuda.synchronize()
        placed = torch.cuda.memory_allocated() - before
        res, n = main_path(lambda: eng.generate(gprompts, sp))
        _check_tokens(res, len(gprompts), PIPE_NEW, cfg.vocab_size,
                      f"stage = 2 generate V={V}")
        # M = 4 microbatches, each through all L8 layers once
        assert n["fresh"] == L8 * 4, n
        equal = sum(int((a == b).all()) for a, b in zip(res.tokens, want))
        gaps = [_teacher_forced_gap(torch, p8, cfg8, p, list(o))
                for p, o, w in zip(gprompts, res.tokens, want)
                if not (o == w).all()]
        log("pipe", step="generate", schedule="gpipe" if V == 1
            else "interleaved", mesh="stage2_on_cuda:0", layers=L8,
            virtual_stages=V, placement_bytes_allocated=placed,
            fresh_launches=n["fresh"],
            equal_to_unsharded=f"{equal}/{len(gprompts)}",
            teacher_forced_gap=f"{max(gaps):.4g}" if gaps else "none")
        assert placed == 0, f"the V={V} placement allocated {placed} bytes"
        if gaps:
            assert max(gaps) <= LOGITS_TOL, f"teacher-forced gap {max(gaps)}"
        del eng
    log("pipe", **timed("generate_done", t0))

    t0 = time.monotonic()
    news, sizes = PIPE_MESH_NEW, PIPE_MESH_BYTES
    rt8 = RuntimeConfig(max_batch_size=8, max_seq_len=2048, page_size=16)
    refs = {}
    for kvq in ("none", "int8"):
        plain = Scheduler(ServingEngine(model8, p8, rt8.replace(
            kv_quant=kvq)))
        refs[kvq] = [r.output for r in _moe_serve(
            torch, plain, tok, cfg.vocab_size, news, sizes)[1]]
        plain.engine.cache = plain.engine._kv_window = None
        del plain
    log("pipe", **timed("serve_references", t0))
    for name, axes, kvq in (("serve_int8", dict(stage=2), "int8"),
                            ("serve_stage2_tensor2",
                             dict(stage=2, tensor=2), "none"),
                            ("serve_stage2_data2",
                             dict(stage=2, data=2), "none")):
        t0 = time.monotonic()
        m = _one_card_mesh(**axes)
        sched = Scheduler(ServingEngine(model8, p8, rt8.replace(
            kv_quant=kvq), mesh=m))
        fields, n = main_path(lambda: _serve_against(
            torch, name, sched, refs[kvq], p8, cfg8, tok, news, sizes))
        assert n["paged"] > 0 and n["paged"] % L8 == 0, n
        log("pipe", **timed(name, t0),
            mesh="_x_".join(f"{a}{k}" for a, k in axes.items())
            + "_on_cuda:0", layers=L8, kv_quant=kvq, **fields,
            paged_launches=n["paged"])
        sched.engine.cache = None
        del sched
        gc.collect()

    # a draft model deeper than one stage: 6 layers over stages of 4, its
    # layers views of the first two stages' slices
    t0 = time.monotonic()
    rt_spec = rt8.replace(speculative_gamma=PIPE_DRAFT_GAMMA,
                          draft_model="model",
                          draft_layers=PIPE_DRAFT_LAYERS)
    plain = Scheduler(ServingEngine(model8, p8, rt_spec))
    ref = [r.output for r in _moe_serve(torch, plain, tok, cfg.vocab_size,
                                        news, sizes)[1]]
    plain.engine.cache = None
    del plain
    m = _one_card_mesh(stage=2)
    sched = Scheduler(ServingEngine(model8, p8, rt_spec, mesh=m))
    fields, n = main_path(lambda: _serve_against(
        torch, "spec_draft_deeper_than_stage", sched, ref, p8, cfg8, tok,
        news, sizes))
    stats = sched.metrics()
    log("pipe", **timed("spec_draft_deeper_than_stage", t0),
        mesh="stage2_on_cuda:0", layers=L8, draft_layers=PIPE_DRAFT_LAYERS,
        layers_per_stage=L8 // 2, gamma=PIPE_DRAFT_GAMMA, **fields,
        spec_forwards=int(stats.get("spec_forwards_total", 0)),
        paged_launches=n["paged"])
    sched.engine.cache = None
    del sched
    gc.collect()
    torch.cuda.empty_cache()

    n_fresh, stage_seq_s = _stage_seq_generate(torch, model8, p8, gprompts,
                                                sp, want)
    counts["fresh"] += n_fresh
    for k, v in counts.items():
        assert v > 0, f"the {k} kernel never launched in the pipe phase"
    log("pipe", step="done", seconds=f"{time.monotonic() - t_phase:.1f}",
        **{f"{k}_launches": v for k, v in counts.items()})
    return counts, stage_seq_s


def _demangle(names):
    """Kernel names as C++ would print them (c++filt, when the toolkit's
    machine has it), with the namespaces and type spellings shortened."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True,
                             timeout=60).stdout.splitlines()
    except OSError:
        out = []
    if len(out) != len(names):
        return names
    short = {"(anonymous namespace)::": "", "bt::wg::": "", "bt::": "",
             "__nv_bfloat16": "bf16", "__half": "f16", "signed char": "i8",
             "(bool)1": "1", "(bool)0": "0", " ": ""}
    res = []
    for n in out:
        n = n.removeprefix("void ")
        for a, b in short.items():
            n = n.replace(a, b)
        res.append(n.split("(")[0] if "(" in n else n)
    return res


def _ptxas_kernels(err):
    """(kernel, registers, spill bytes, static smem bytes) for every entry
    function in ptxas' -v report."""
    rows, name, spill = [], None, "0"
    for line in err.splitlines():
        if "Compiling entry function" in line:
            name, spill = line.split("'")[1], "0"
        elif "spill stores" in line and name:
            spill = line.split("bytes spill stores")[0].split(",")[-1] \
                .strip()
        elif "Used" in line and "registers" in line and name:
            regs = line.split("Used")[1].split("registers")[0].strip()
            smem = "0"
            for part in line.split(","):
                if "smem" in part:
                    smem = part.strip().split()[0]
            rows.append([name, regs, spill, smem])
            name = None
    for row, dem in zip(rows, _demangle([r[0] for r in rows])):
        row[0] = dem
    return rows


# -- phase 24: a mesh over two processes -------------------------------------

MH_LAYERS = 4          # the tree of the tp phase's tensor = 4 x data = 2 run
MH_MOE_LAYERS = 2      # the Mixtral tree of the expert = 2 run
MH_NEW = 16            # new tokens of each generate row and request
MH_DATA_NEW = 8        # data2_tensor2's (cut: PERF.md section 4)
MH_BYTES = (16, 200, 600, 1000)   # prompt bytes, 4 requests
MH_STEP_S = 100        # the step's budget (PERF.md section 4)
MH_WAIT_S = 300        # the parent's bound on its workers: a desync fails
MH_PG_TIMEOUT_S = 60   # each worker's collective timeout
MH_SEQ_THRESHOLD = 512  # seq2 serving: the longest prompt takes the lane
# the meshes across the two processes, in the order the workers run them
# (the Llama-3-8B tree drawn once for the first four); data2_tensor2
# holds a data axis of 2 inside each process beside tensor across them
MH_MESHES = (("tensor2", dict(tensor=2)),
             ("data2_tensor2", dict(data=2, tensor=2)),
             ("stage2", dict(stage=2)), ("seq2", dict(seq=2)),
             ("expert2", dict(expert=2)))


def _mh_tree(torch):
    """(model, tree) of Llama-3-8B at full width, MH_LAYERS layers, bf16,
    drawn on cuda:0 from seed 0 (the CLI's draw, core/config presets)."""
    from butterfly_tpu_torch.core.config import llama3_8b
    from butterfly_tpu_torch.models.common import Model, init_params
    cfg = llama3_8b().replace(num_layers=MH_LAYERS)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return (Model(cfg, device="cuda"),
            init_params(cfg.replace(param_dtype=cfg.dtype), gen, "cuda"))


def _mh_moe_tree(torch):
    """(model, tree) of Mixtral-8x7B at full width, MH_MOE_LAYERS layers,
    bf16, the expert-parallel dispatch, drawn on cuda:0 from seed 0."""
    from butterfly_tpu_torch.core.config import mixtral_8x7b
    from butterfly_tpu_torch.models.common import Model, init_params
    cfg = mixtral_8x7b().replace(num_layers=MH_MOE_LAYERS, moe_impl="ep")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return (Model(cfg, device="cuda"),
            init_params(cfg.replace(param_dtype=cfg.dtype), gen, "cuda"))


def _mh_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _mh_leaves(v)
    else:
        yield tree


def _mh_axis(mesh) -> str:
    """The axis of a multihost mesh that crosses the processes (beside
    it at most a data axis inside them)."""
    return next(a for a in ("tensor", "stage", "expert", "seq")
                if mesh.shape[a] > 1)


def _mh_mesh(devs, axes):
    """The mesh of `axes` over the two workers' global devices `devs`
    (one card a worker): one axis across them; with a data axis, two
    shards a worker on its card, each worker its own slice, so that
    make_hybrid_mesh lays the other axis across the workers and data
    inside each (the JAX runs' arrangement)."""
    import dataclasses

    from butterfly_tpu_torch.core.config import MeshConfig
    from butterfly_tpu_torch.core.mesh import make_hybrid_mesh
    cfg = MeshConfig(**axes)
    if cfg.data == 1:
        return make_hybrid_mesh(cfg, devs)
    inside = [dataclasses.replace(d, id=cfg.data * i + j,
                                  slice_index=d.process_index)
              for i, d in enumerate(devs) for j in range(cfg.data)]
    cross = next(a for a, n in axes.items() if a != "data" and n > 1)
    return make_hybrid_mesh(cfg, inside, dcn_axes=(cross,))


def _mh_held_bytes(tree, cfg, mesh):
    """The bytes one process of a two-process mesh must hold: half of
    each leaf split over the axis that crosses (tensor and expert: as
    the specs split them; stage: every layer-stacked leaf), the whole of
    every other (the embedding, the final norm and the head are every
    process's under stage; attention, norms and router under expert;
    the whole tree under seq, which splits no weight; data groups on
    one card share their replica)."""
    from butterfly_tpu_torch.parallel.partition import param_specs
    axis = _mh_axis(mesh)
    specs = param_specs(cfg, mesh)

    def walk(t, sp, stacked):
        if isinstance(t, dict):
            return sum(walk(t[k], sp[k], stacked or k == "layers")
                       for k in t)
        split = stacked if axis == "stage" else axis in sp
        return t.nbytes // (2 if split else 1)
    return walk(tree, specs, False)


def _requested_bytes(torch) -> int:
    """The bytes the caching allocator's live blocks were asked for
    (memory_allocated rounds each block up)."""
    return torch.cuda.memory_stats()["requested_bytes.all.current"]


@contextlib.contextmanager
def _collective_tally(torch, tally):
    """Count the torch.distributed collectives issued in the block
    (parallel/tensor.py reads the module attributes at each call):
    tally["n"] and per kind tally["kinds"], the bytes each process
    contributes (a batch of sends and receives: its sends), and the host
    seconds spent inside them."""
    dist = torch.distributed
    sizes = {
        "all_reduce": lambda a: a[0].nbytes,
        "all_gather": lambda a: a[1].nbytes,
        "broadcast": lambda a: a[0].nbytes,
        "all_to_all_single": lambda a: a[1].nbytes,
        "batch_isend_irecv": lambda a: sum(
            op.tensor.nbytes for op in a[0] if op.op is dist.isend),
    }
    saved = {k: getattr(dist, k) for k in sizes}
    tally.setdefault("kinds", {})

    def timed(name):
        fn = saved[name]

        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            tally["s"] += time.perf_counter() - t0
            tally["n"] += 1
            tally["kinds"][name] = tally["kinds"].get(name, 0) + 1
            tally["bytes"] += sizes[name](a)
            return out
        return wrapped
    for k in sizes:
        setattr(dist, k, timed(k))
    try:
        yield tally
    finally:
        for k, fn in saved.items():
            setattr(dist, k, fn)


def _mh_run(torch, model, placed, mesh, prompts, new=MH_NEW):
    """The step's main path on `mesh`: greedy generate of `prompts`
    (`new` new tokens, fused), then the same prompts as requests through a
    Scheduler over a ServingEngine at the serve defaults; then the step
    check (_mh_step). Returns a dict."""
    from butterfly_tpu_torch.core.config import RuntimeConfig
    from butterfly_tpu_torch.engine.engine import InferenceEngine
    from butterfly_tpu_torch.engine.sampling import SamplingParams
    from butterfly_tpu_torch.engine.serving import ServingEngine
    from butterfly_tpu_torch.sched.scheduler import Scheduler
    from butterfly_tpu_torch.serve.cli import build_parser
    cfg = model.cfg
    out = {}
    _zero_counts()
    t0 = time.monotonic()
    with _collective_tally(torch, {"n": 0, "bytes": 0, "s": 0.0}) as tally:
        gen = InferenceEngine(model, placed, mesh=mesh).generate(
            prompts, SamplingParams(max_new_tokens=new))
        torch.cuda.synchronize()
    out["generate_s"] = time.monotonic() - t0
    out["generate_collectives"] = tally
    out["generate"] = gen.tokens.tolist()
    out["generate_launches"] = _launch_counts()
    args = build_parser().parse_args(["serve", "--model", "llama3-8b"])
    rt = RuntimeConfig(max_batch_size=args.max_batch,
                       max_seq_len=args.max_seq, page_size=args.page_size)
    sched = Scheduler(ServingEngine(model, placed, rt, mesh=mesh))
    _zero_counts()
    t0 = time.monotonic()
    with _collective_tally(torch, {"n": 0, "bytes": 0, "s": 0.0}) as tally:
        reqs = [sched.submit(p, max_new_tokens=new) for p in prompts]
        sched.run_until_done()
        torch.cuda.synchronize()
    out["serve_s"] = time.monotonic() - t0
    out["serve_collectives"] = tally
    out["serve_launches"] = _launch_counts()
    for r in reqs:
        assert r.state == "finished" and len(r.output) == new, r.id
    out["serve"] = [r.output for r in reqs]
    sched.engine.cache = sched.engine._kv_window = None
    del sched
    out.update(_mh_step(torch, cfg, placed, mesh))
    return out


def _mh_step(torch, cfg, placed, mesh):
    """One decode step (_step_inputs) on `mesh` with each local shard's
    or stage's in-model paged kernel checked against its plain version:
    windowed, or under stage with the window off through the GPipe
    schedule (a page for the token written). Returns a dict."""
    import butterfly_tpu_torch.ops.paged_attention as pa_mod
    from butterfly_tpu_torch.cache.paged import (paged_forward,
                                                 paged_forward_window)
    from butterfly_tpu_torch.core.mesh import mesh_ctx
    from butterfly_tpu_torch.ops.paged_attention import (paged_attention,
                                                         paged_attention_ref)
    from butterfly_tpu_torch.parallel.partition import (shard_kv_window,
                                                        shard_paged_cache)
    out = {}
    stage = _mh_axis(mesh) == "stage"
    cache, win, wlen, active, toks = _step_inputs(torch, cfg)
    if stage:
        table = cache.page_table.clone()
        mp, page = table.shape[1], cache.page_size
        for s, n in enumerate(cache.lengths.tolist()):
            table[s, :n // page + 1] = torch.arange(
                s * mp, s * mp + n // page + 1, dtype=torch.int32)
        cache = cache._replace(page_table=table)
    scache = shard_paged_cache(cache, cfg, mesh)
    swin = None if stage else shard_kv_window(win, cfg, mesh)
    del cache, win
    errs = []

    def checked(q, kp, *a, **kw):
        o = paged_attention(q, kp, *a, **kw)
        ref = paged_attention_ref(q, kp, *a, **kw)
        errs.append((o.float() - ref.float()).abs().max().item())
        return o
    pa_mod.paged_attention = checked
    try:
        with mesh_ctx(mesh):
            if stage:
                logits, _ = paged_forward(placed, cfg, toks, scache,
                                          active=active, use_kernel=True)
            else:
                logits, _ = paged_forward_window(
                    placed, cfg, toks, scache, swin, wlen, active=active,
                    use_kernel=True)
    finally:
        pa_mod.paged_attention = paged_attention
    logits = logits[:, 0][active].float()
    assert torch.isfinite(logits).all()
    out["step_logits"] = logits.cpu()
    out["step_checksum"] = float(logits.double().sum().item())
    out["step_err"] = max(errs)
    out["step_calls"] = len(errs)
    del scache, swin
    torch.cuda.empty_cache()
    return out


def _mh_step_calls(name: str, one: bool) -> int:
    """The in-model paged kernel calls of the step on mesh `name`, in a
    worker or (`one`) in the one-process run: a call per local shard and
    layer (and data group); under stage per local layer and microbatch
    (M = 4 for 8 slots over 2 stages), the window off; under expert and
    seq one a layer (the decode step does not split)."""
    per = {"tensor2": MH_LAYERS, "data2_tensor2": 2 * MH_LAYERS,
           "stage2": MH_LAYERS // 2 * 4, "seq2": MH_LAYERS,
           "expert2": MH_MOE_LAYERS}[name]
    return per * 2 if one and name not in ("expert2", "seq2") else per


def _mh_ring_launches(one: bool) -> tuple:
    """(ring launches, of them T = 1) of the seq2 run's three
    generate_long calls (ring, Ulysses, ring over int8 KV; MH_NEW new):
    a worker runs its own shard, one of N = 2: at the ring prefill its N
    blocks a layer, at each decode step its prefix block and the
    replicated suffix block a layer; one process N * N and N + 1."""
    L, N, steps = MH_LAYERS, 2, MH_NEW - 1
    dec = 3 * steps * L * ((N + 1) if one else 2)
    return 2 * L * (N * N if one else N) + dec, dec


def _mh_seq_run(torch, model, placed, mesh, prompts, long_ids):
    """The seq = 2 step's main path on `mesh`: generate_long of the
    4096-token prompt (MH_NEW new; ring, Ulysses, ring over the int8
    KV), then the step's prompts through a Scheduler over a
    ServingEngine at the serve defaults whose long-prompt lane
    (threshold MH_SEQ_THRESHOLD) takes the longest, collectives
    counted; then one generate_long of 2 new tokens with every ring
    block this process runs (bt_ring_stats at the prefill, its shard's
    T = 1 prefix block and the suffix block, bt_ring_decode, at the
    decode step) held to the plain version by the ringpar phase's
    element bound, and the paged step check. Returns a dict."""
    import butterfly_tpu_torch.parallel.sequence as seq_mod
    from butterfly_tpu_torch.core.config import RuntimeConfig
    from butterfly_tpu_torch.engine.engine import InferenceEngine
    from butterfly_tpu_torch.engine.sampling import SamplingParams
    from butterfly_tpu_torch.engine.serving import ServingEngine
    from butterfly_tpu_torch.ops import ring_attention as ra
    from butterfly_tpu_torch.sched.scheduler import Scheduler
    from butterfly_tpu_torch.serve.cli import build_parser
    cfg = model.cfg
    sp = SamplingParams(max_new_tokens=MH_NEW)
    out = {"generate": []}
    _zero_counts()
    ra.launches = ra.launches_decode = 0
    t0 = time.monotonic()
    with _collective_tally(torch, {"n": 0, "bytes": 0, "s": 0.0}) as tally:
        for kvq, impl in (("none", "ring"), ("none", "ulysses"),
                          ("int8", "ring")):
            eng = InferenceEngine(model, placed, RuntimeConfig(
                kv_quant=kvq, max_seq_len=4096), mesh=mesh)
            res = eng.generate_long(long_ids, sp, impl=impl)
            _check_tokens(res, 1, MH_NEW, cfg.vocab_size, f"seq2 {impl}")
            out["generate"].append(res.tokens[0].tolist())
        torch.cuda.synchronize()
    out["generate_s"] = time.monotonic() - t0
    out["generate_collectives"] = tally
    out["generate_launches"] = {**_launch_counts(), "ring": ra.launches,
                                "ring_t1": ra.launches_decode}
    args = build_parser().parse_args(["serve", "--model", "llama3-8b"])
    rt = RuntimeConfig(max_batch_size=args.max_batch,
                       max_seq_len=args.max_seq, page_size=args.page_size,
                       seq_parallel_threshold=MH_SEQ_THRESHOLD)
    sched = Scheduler(ServingEngine(model, placed, rt, mesh=mesh))
    _zero_counts()
    ra.launches = ra.launches_decode = 0
    t0 = time.monotonic()
    with _collective_tally(torch, {"n": 0, "bytes": 0, "s": 0.0}) as tally:
        reqs = [sched.submit(p, max_new_tokens=MH_NEW) for p in prompts]
        sched.run_until_done()
        torch.cuda.synchronize()
    out["serve_s"] = time.monotonic() - t0
    out["serve_collectives"] = tally
    out["serve_launches"] = {**_launch_counts(), "ring": ra.launches,
                             "ring_t1": ra.launches_decode}
    for r in reqs:
        assert r.state == "finished" and len(r.output) == MH_NEW, r.id
    out["serve"] = [r.output for r in reqs]
    out["lane_tokens"] = int(
        sched.metrics()["seq_parallel_prefill_tokens_total"])
    sched.engine.cache = sched.engine._kv_window = None
    del sched
    # every ring block of one short run, kernel against plain
    checks = {True: [], False: []}          # T = 1 or not: ratio, abs err

    def checked(*a, kernel=None):
        stats = ra.ring_block_stats(*a)
        ref = ra.ring_block_stats_ref(*a)
        _, _, err, elem, _ = _ring_check(torch, ra, a, stats, ref, True)
        checks[a[0].shape[1] == 1].append((elem, err))
        return stats
    seq_mod.block_stats = checked
    try:
        InferenceEngine(model, placed, RuntimeConfig(max_seq_len=4096),
                        mesh=mesh).generate_long(
            long_ids, SamplingParams(max_new_tokens=2))
    finally:
        seq_mod.block_stats = ra.block_stats
    torch.cuda.synchronize()
    for t1, name in ((False, "ring_stats"), (True, "ring_decode")):
        out[f"{name}_checks"] = len(checks[t1])
        out[f"{name}_ratio"] = max(c[0] for c in checks[t1])
        out[f"{name}_err"] = max(c[1] for c in checks[t1])
    torch.cuda.empty_cache()
    out.update(_mh_step(torch, cfg, placed, mesh))
    return out


def _mh_new(name: str) -> int:
    """New tokens of mesh `name`'s generate rows and requests."""
    return MH_DATA_NEW if name == "data2_tensor2" else MH_NEW


def _mh_prompts(prompts, name):
    """The prompts of mesh `name`: under expert the longest is cut by one
    token where the padded length is odd, so the prefill takes the a2a
    path (parallel/expert.py:takes_a2a: T divides by the expert axis)."""
    if name != "expert2" or max(map(len, prompts)) % 2 == 0:
        return prompts
    n = max(map(len, prompts))
    return [p[:-1] if len(p) == n else p for p in prompts]


def _multihost_worker(pid: int, port: int, outdir: str) -> int:
    """One process of the multihost step (run by phase_multihost as
    `chip_smoke.py --multihost-worker PID PORT DIR`): writes
    DIR/worker<PID>.json and DIR/worker<PID>_<mesh>_logits.pt."""
    t_start = time.monotonic()
    import torch
    if not torch.cuda.is_available():
        print("multihost worker: no card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from butterfly_tpu_torch.core.config import MeshConfig
    from butterfly_tpu_torch.core.mesh import (global_devices,
                                               init_distributed,
                                               make_hybrid_mesh)
    from butterfly_tpu_torch.engine.engine import InferenceEngine
    from butterfly_tpu_torch.obs.health import all_hosts_probe
    from butterfly_tpu_torch.parallel.partition import shard_params
    from butterfly_tpu_torch.parallel.tensor import (all_to_all_blocks,
                                                     exchange)
    with open(os.path.join(outdir, "prompts.json")) as f:
        both = json.load(f)
    prompts, long_ids = both["prompts"], both["long"]
    init_distributed(coordinator=f"127.0.0.1:{port}", num_processes=2,
                     process_id=pid, timeout_s=MH_PG_TIMEOUT_S)
    dist = torch.distributed
    res = {"pid": pid}
    # (a) the JAX worker's sum, on the card, and the probe; then the
    #     collectives' times: all-reduce, the hand-off (each process
    #     sends the other 8 MB at once, as the interleaved wrap does,
    #     staged through the host) and the all-to-all
    x = torch.full((1,), float(pid + 1), device="cuda:0")
    dist.all_reduce(x)
    res["sum"] = x.item()
    res["probe"] = all_hosts_probe()

    def timed_ms(fn, n):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3
    y = torch.ones(4096, device="cuda:0")
    res["allreduce_16KB_ms"] = timed_ms(lambda: dist.all_reduce(y), 20)
    y = torch.ones(2 << 20, device="cuda:0")     # 8 MB, a prefill's rows
    res["allreduce_8MB_ms"] = timed_ms(lambda: dist.all_reduce(y), 5)
    blk = torch.ones(4 << 20, dtype=torch.bfloat16, device="cuda:0")
    peer = 1 - pid
    res["sendrecv_8MB_ms"] = timed_ms(lambda: exchange(
        [(blk, peer, 0)], [(blk.shape, blk.dtype, blk.device, peer, 0)]), 5)
    res["all_to_all_8MB_ms"] = timed_ms(
        lambda: all_to_all_blocks(blk.view(2, -1)), 5)
    del x, y, blk
    devs = global_devices("cuda")
    res["devices"] = [f"{d.id}:{d.device}@process{d.process_index}"
                      f"/slice{d.slice_index}" for d in devs]
    res["runs"] = {}
    host = None
    for name, axes in MH_MESHES:
        t_mesh = time.monotonic()
        # (b) the tree, drawn on the card, kept on the host; each
        #     process places its own part
        if host is None or name == "expert2":
            model, tree = (_mh_moe_tree if name == "expert2"
                           else _mh_tree)(torch)
            checksum = float(tree["embed"]["tok"].float().sum().item())
            host = {}

            def to_host(t, d):
                for k, v in t.items():
                    if isinstance(v, dict):
                        d[k] = {}
                        to_host(v, d[k])
                    else:
                        d[k] = v.cpu()
            to_host(tree, host)
            del tree
            torch.cuda.empty_cache()
        mesh = _mh_mesh(devs, axes)
        run = {"tree_checksum": checksum, "mesh": repr(mesh)}
        torch.cuda.synchronize()
        before = _requested_bytes(torch)
        placed = shard_params(host, model.cfg, mesh)
        torch.cuda.synchronize()
        run["placement_bytes"] = _requested_bytes(torch) - before
        run["held_bytes"] = _mh_held_bytes(host, model.cfg, mesh)
        run["tree_bytes"] = sum(t.nbytes for t in _mh_leaves(host))
        # (c) generate and serving, then the step check
        out = (_mh_seq_run(torch, model, placed, mesh, prompts, long_ids)
               if name == "seq2" else _mh_run(torch, model, placed, mesh,
                                              _mh_prompts(prompts, name),
                                              _mh_new(name)))
        torch.save(out.pop("step_logits"),
                   os.path.join(outdir, f"worker{pid}_{name}_logits.pt"))
        run.update(out)
        if name == "tensor2":
            # a data axis across the two processes: refused at
            # construction
            dmesh = make_hybrid_mesh(MeshConfig(data=2), devs)
            try:
                InferenceEngine(model, placed, mesh=dmesh)
                run["data_refusal"] = None
            except RuntimeError as e:
                run["data_refusal"] = str(e)
        run["seconds"] = time.monotonic() - t_mesh
        res["runs"][name] = run
        del placed
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    res["seconds"] = time.monotonic() - t_start
    with open(os.path.join(outdir, f"worker{pid}.json"), "w") as f:
        json.dump(res, f)
    return 0


def _rows_text(rows) -> str:
    """Token rows as one word: ids joined by commas, rows by '|'."""
    return "|".join(",".join(map(str, r)) for r in rows)


def _tally_text(t) -> str:
    kinds = "+".join(f"{k}:{n}" for k, n in sorted(t["kinds"].items()))
    return (f"{t['n']}_calls/{t['bytes'] / 1e6:.1f}MB/{t['s']:.3f}s"
            f"/{kinds or 'none'}")


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_multihost(torch, tok):
    """A mesh over two processes on one card (module docstring, phase
    24). Returns ({kernel: launches} of the one-process runs' main
    paths, the step's seconds)."""
    import shutil

    from butterfly_tpu_torch.parallel.partition import shard_params
    t_phase = time.monotonic()
    outdir = os.path.join(ROOT, "build", "multihost")
    shutil.rmtree(outdir, ignore_errors=True)
    os.makedirs(outdir)
    prompts = [tok.encode(_TEXT[:n]) for n in MH_BYTES]
    long_ids = tok.encode(_LONG)
    with open(os.path.join(outdir, "prompts.json"), "w") as f:
        json.dump({"prompts": prompts, "long": long_ids}, f)
    port = _free_port()
    logs = [open(os.path.join(outdir, f"worker{p}.log"), "w")
            for p in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--multihost-worker",
         str(p), str(port), outdir], stdout=logs[p],
        stderr=subprocess.STDOUT, cwd=ROOT) for p in range(2)]
    try:
        for p in procs:
            p.wait(timeout=max(1.0, MH_WAIT_S
                               - (time.monotonic() - t_phase)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    workers_s = time.monotonic() - t_phase
    rcs = [p.returncode for p in procs]
    if rcs != [0, 0]:
        for p in range(2):
            with open(os.path.join(outdir, f"worker{p}.log")) as f:
                print(f"[multihost] worker{p} log tail:\n"
                      + f.read()[-4000:], flush=True)
        raise AssertionError(f"multihost workers exited {rcs}")
    res = []
    for p in range(2):
        with open(os.path.join(outdir, f"worker{p}.json")) as f:
            res.append(json.load(f))
    for r in res:
        log("multihost", step="worker", pid=r["pid"], sum=r["sum"],
            probe=r["probe"], devices=",".join(r["devices"]),
            allreduce_16KB_ms=f"{r['allreduce_16KB_ms']:.3f}",
            allreduce_8MB_ms=f"{r['allreduce_8MB_ms']:.3f}",
            sendrecv_8MB_ms=f"{r['sendrecv_8MB_ms']:.3f}",
            all_to_all_8MB_ms=f"{r['all_to_all_8MB_ms']:.3f}",
            seconds=f"{r['seconds']:.1f}")
        assert r["sum"] == 3.0 and r["probe"] is True, r
        for name, _ in MH_MESHES:
            w = r["runs"][name]
            log("multihost", step=f"worker_{name}", pid=r["pid"],
                seconds=f"{w['seconds']:.1f}",
                placement_bytes=w["placement_bytes"],
                held_bytes=w["held_bytes"], tree_bytes=w["tree_bytes"],
                generate_s=f"{w['generate_s']:.3f}",
                serve_s=f"{w['serve_s']:.3f}",
                generate_collectives=_tally_text(w["generate_collectives"]),
                serve_collectives=_tally_text(w["serve_collectives"]),
                generate_launches=_counts_text(w["generate_launches"]),
                serve_launches=_counts_text(w["serve_launches"]),
                **_mh_seq_fields(w),
                step_kernel_calls=w["step_calls"],
                step_max_layer_abs_err=f"{w['step_err']:.3g}",
                step_logits_checksum=repr(w["step_checksum"]),
                generate_tokens=_rows_text(w["generate"]),
                serve_tokens=_rows_text(w["serve"]))
            assert w["placement_bytes"] == w["held_bytes"], \
                (name, w["placement_bytes"], w["held_bytes"])
            assert w["step_err"] <= LAYER_TOL, (name, w["step_err"])
            assert w["step_calls"] == _mh_step_calls(name, False), \
                (name, w["step_calls"])
            if name == "seq2":
                _mh_check_seq(w, False)
                continue
            # a launch per local layer (per microbatch under stage) for
            # each prefill call (fresh) or decode step (paged)
            local = {"tensor2": MH_LAYERS, "data2_tensor2": MH_LAYERS,
                     "stage2": MH_LAYERS // 2,
                     "expert2": MH_MOE_LAYERS}[name]
            for run, k in (("generate_launches", "fresh"),
                           ("serve_launches", "paged")):
                assert w[run][k] > 0 and w[run][k] % local == 0, \
                    (name, w[run])
        assert r["runs"]["tensor2"]["data_refusal"] and "first read-back" \
            in r["runs"]["tensor2"]["data_refusal"]
    a, b = res
    for name, _ in MH_MESHES:
        wa, wb = a["runs"][name], b["runs"][name]
        assert wa["tree_checksum"] == wb["tree_checksum"], name
        assert wa["generate"] == wb["generate"], \
            f"{name}: the processes' tokens differ"
        assert wa["serve"] == wb["serve"], \
            f"{name}: the processes' tokens differ"
        assert wa["step_checksum"] == wb["step_checksum"], name
        assert wa.get("lane_tokens") == wb.get("lane_tokens"), name

    # the same trees and paths in one process, every shard on cuda:0
    counts = {"paged": 0, "fresh": 0, "ring": 0}
    model = tree = None
    for name, axes in MH_MESHES:
        t_mesh = time.monotonic()
        if tree is None or name == "expert2":
            model = tree = None      # the yardstick's tree goes first
            gc.collect()
            torch.cuda.empty_cache()
            model, tree = (_mh_moe_tree if name == "expert2"
                           else _mh_tree)(torch)
        w = a["runs"][name]
        assert float(tree["embed"]["tok"].float().sum().item()) \
            == w["tree_checksum"], name
        mesh = _one_card_mesh(**axes)
        placed = shard_params(tree, model.cfg, mesh)
        if name == "seq2":
            # the three generate_long rows are the long prompt's
            one = _mh_seq_run(torch, model, placed, mesh, prompts, long_ids)
            asked = {"generate": [long_ids] * 3, "serve": prompts}
        else:
            mprompts = _mh_prompts(prompts, name)
            one = _mh_run(torch, model, placed, mesh, mprompts,
                          _mh_new(name))
            asked = {"generate": mprompts, "serve": mprompts}
        del placed
        step_gap = max((torch.load(os.path.join(
            outdir, f"worker{p}_{name}_logits.pt")) - one["step_logits"]
        ).abs().max().item() for p in range(2))
        gaps, first = [], []
        for kind, ps in asked.items():
            for i, prompt in enumerate(ps):
                got, want = w[kind][i], one[kind][i]
                if got != want:
                    first.append(f"{kind}{i}@{_divergence(got, want)}")
                    gaps.append(_teacher_forced_gap(torch, tree, model.cfg,
                                                    prompt, got))
        rows = sum(map(len, asked.values()))
        log("multihost", step="one_process", mesh=f"{name}_on_cuda:0",
            seconds=f"{time.monotonic() - t_mesh:.1f}",
            equal_to_workers=f"{rows - len(first)}/{rows}",
            first_divergence=",".join(first) or "none",
            teacher_forced_gap=f"{max(gaps):.4g}" if gaps else "none",
            step_logits_vs_workers=f"{step_gap:.4g}",
            step_logits_checksum=repr(one["step_checksum"]),
            generate_s=f"{one['generate_s']:.3f}",
            serve_s=f"{one['serve_s']:.3f}",
            generate_launches=_counts_text(one["generate_launches"]),
            serve_launches=_counts_text(one["serve_launches"]),
            **_mh_seq_fields(one),
            step_kernel_calls=one["step_calls"],
            step_max_layer_abs_err=f"{one['step_err']:.3g}")
        assert one["step_err"] <= LAYER_TOL, (name, one["step_err"])
        assert one["step_calls"] == _mh_step_calls(name, True), \
            (name, one["step_calls"])
        if name == "seq2":
            _mh_check_seq(one, True)
            assert one["lane_tokens"] == w["lane_tokens"], \
                (one["lane_tokens"], w["lane_tokens"])
        if _mh_axis(mesh) == "tensor":
            # two f32 partials sum alike on host and card; a differing
            # row is held by its teacher-forced gap
            if gaps:
                assert max(gaps) <= LOGITS_TOL, \
                    f"teacher-forced gap {max(gaps)}"
        else:
            # the hand-offs, the expert exchanges and the ring's blocks
            # move exact bytes, the decode merges gather every shard's
            # partials: every process computes what the one process does
            assert not first, f"{name}: {first}"
            assert w["step_checksum"] == one["step_checksum"], name
        for k in counts:
            counts[k] += one["generate_launches"].get(k, 0) \
                + one["serve_launches"].get(k, 0)
        del one
    seconds = time.monotonic() - t_phase
    log("multihost", step="done", workers_s=f"{workers_s:.1f}",
        seconds=f"{seconds:.1f}", budget_s=MH_STEP_S,
        meshes=",".join(n for n, _ in MH_MESHES), card_processes=2,
        backend="gloo")
    del tree, model
    gc.collect()
    torch.cuda.empty_cache()
    return counts, seconds


def _counts_text(c) -> str:
    """Kernel launches as one word: kind:count joined by '+'."""
    return "+".join(f"{k}:{n}" for k, n in sorted(c.items()))


def _mh_seq_fields(w) -> dict:
    """The seq2 run's extra log fields (none on the other meshes)."""
    if "lane_tokens" not in w:
        return {}
    return {"lane_tokens": w["lane_tokens"],
            **{f"{k}_{f}": (w[f"{k}_{f}"] if f == "checks"
                            else f"{w[f'{k}_{f}']:.3g}")
               for k in ("ring_stats", "ring_decode")
               for f in ("checks", "ratio", "err")}}


def _mh_check_seq(w, one: bool) -> None:
    """The seq2 run's checks in a worker or (`one`) in one process: the
    ring launches of its generate_long calls exact, the lane taken,
    every ring block within the element bound (a worker checks its own
    shard's blocks: N a layer at the prefill, its prefix block and the
    suffix block at the decode step; one process N * N and N + 1)."""
    want, want_t1 = _mh_ring_launches(one)
    g = w["generate_launches"]
    assert (g["ring"], g["ring_t1"]) == (want, want_t1), (g, want, want_t1)
    assert w["serve_launches"]["ring"] > 0, w["serve_launches"]
    assert w["lane_tokens"] > 0, w["lane_tokens"]
    L, N = MH_LAYERS, 2
    assert w["ring_stats_checks"] == L * (N * N if one else N), w
    assert w["ring_decode_checks"] == L * ((N + 1) if one else 2), w
    for k in ("ring_stats", "ring_decode"):
        assert w[f"{k}_ratio"] <= 1.0, (k, w[f"{k}_ratio"])


def main() -> int:
    # kineto tears CUPTI down when a capture stops: left subscribed, it
    # made every later host launch slower (PERF.md section 5); set before
    # torch loads kineto
    os.environ["TEARDOWN_CUPTI"] = "1"
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this smoke "
              "run needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from butterfly_tpu_torch import native
    from butterfly_tpu_torch.native import build as native_build
    from butterfly_tpu_torch.ops import build
    from butterfly_tpu_torch.ops.paged_attention import paged_attention

    t_start = time.monotonic()

    def clock(after, **kv):
        # seconds since the start after each group of phases (where the
        # time limit goes) and the threads still alive (a phase that
        # leaves one running slows every host-bound phase after it)
        log("clock", after=after, t_s=f"{time.monotonic() - t_start:.1f}",
            threads=threading.active_count(), **kv)

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi gave no answer"
    log("device", name=name, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda,
        bandwidth_TBps=figures(name)[0] / 1e12)
    print(smi_line, flush=True)

    t0 = time.monotonic()
    built = build.build_all()
    log("build", seconds=f"{time.monotonic() - t0:.1f}",
        built=",".join(built) or "cached")
    t0 = time.monotonic()
    lib = native_build.build(verbose=False)
    assert native.native_available(), "the native allocator did not load"
    log("build", source="native/allocator.cc", lib=os.path.relpath(lib, ROOT),
        gxx_s=f"{time.monotonic() - t0:.1f}")
    for k, (secs, err) in build.build_log.items():
        log("build", source=k, nvcc_s=f"{secs:.1f}")
        for kern, regs, spill, smem in _ptxas_kernels(err):
            print(f"[build] {k}: {kern}: {regs} registers, spill {spill}, "
                  f"static smem {smem} bytes", flush=True)

    clock("build")
    kres = phase_kernel(torch, name)
    fres = phase_flash_kernel(torch, name)
    rres = phase_ring(torch, name)
    clock("kernels")
    engine, serve_launches, tok, serve_tokens = phase_serve(torch)
    phase_parity(torch, engine)
    phase_profile(torch, engine)
    clock("serve,parity,profile")
    model, params = engine.model, engine.params
    # the serve engine's pool and window go; its weights stay shared
    engine.cache = engine._kv_window = None
    del engine
    torch.cuda.empty_cache()
    gen_fresh = phase_generate(torch, model, params, tok)
    alt_engine, alt = phase_alternating(torch, model, params, tok)
    phase_flash_parity(torch, alt_engine)
    alt_engine.cache = alt_engine._kv_window = None
    del alt_engine
    torch.cuda.empty_cache()
    clock("generate,alternate,flashpar")
    long_ring, seq_last = phase_longgen(torch, model, params, tok)
    phase_ring_parity(torch, model, params, tok)
    serve_ring, long_paged, long_runs = phase_longserve(torch, model,
                                                        params, tok)
    long_ring += serve_ring
    clock("longgen,ringpar,longserve")
    qparams, quant = phase_quant(torch, model, params, tok)
    clock("quant")
    spec = phase_spec(torch, model, params, tok)
    clock("spec")
    fleet = phase_fleet(torch, model, params)
    clock("fleet")
    bench, decode_leg, (model_c, params_c) = phase_bench(torch, model,
                                                         params, qparams)
    clock("bench")
    tools = phase_tools(torch, model_c, params_c)
    del model_c, params_c
    clock("tools")
    ck = phase_ckpt(torch, model, params, tok)
    clock("ckpt")
    tp = phase_tp(torch, model, params, qparams, tok, serve_tokens,
                  decode_leg)
    clock("tp")
    comb = phase_combined(torch, model, params, tok, seq_last, long_runs)
    clock("combined")
    pipe, stage_seq_s = phase_pipe(torch, model, params, tok)
    clock("pipe")
    mh, mh_s = phase_multihost(torch, tok)
    clock("multihost", multihost_step_s=f"{mh_s:.1f}")
    # the Llama-3-8B trees go before Mixtral's int8 tree is drawn
    del qparams, params, model
    gc.collect()
    torch.cuda.empty_cache()
    moe, moe_state = phase_moe(torch, tok)
    clock("moe")
    comb_moe, combos_s = phase_combined_moe(torch, tok, moe_state)
    # the step of the meshes that combine seq with expert and stage with
    # seq or expert: its Mixtral part here, its Llama part in pipe
    clock("combined_moe", mesh_combos_step_s=f"{combos_s + stage_seq_s:.1f}")
    del moe_state
    # a torch profiler sits in a reference cycle (its action map holds
    # its own bound methods): one left for the interpreter's exit is
    # destroyed after CUPTI's teardown, and the exit hangs; collect them
    # all here, before the result lines
    gc.collect()
    torch.cuda.empty_cache()

    def entry(kname, source, replaces, launches, cases, main_case):
        e = {"name": kname, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches,
             "max_abs_err": max(r["max_abs_err"] for k, r in cases.items()
                                if not k.startswith("f32")
                                and not k.endswith("f32"))}
        for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms"):
            e[key] = cases[main_case][key]
        return e

    flash_src = "butterfly_tpu_torch/ops/csrc/flash_attention.cu"
    fresh_cases = {k: r for k, r in fres.items() if k.startswith("fresh")}
    warm_cases = {k: r for k, r in fres.items() if k.startswith("warm")}
    kernels = [
        entry("paged_attention",
              "butterfly_tpu_torch/ops/csrc/paged_attention.cu",
              "butterfly_tpu/ops/paged_attention.py:65",
              serve_launches + alt["paged"] + long_paged + quant["paged"]
              + spec["paged"] + fleet["paged"] + bench["paged"]
              + tools["paged"] + ck["paged"] + tp["paged"] + moe["paged"] + comb["paged"]
              + comb_moe["paged"] + pipe["paged"] + mh["paged"], kres,
              "bf16_w64"),
        entry("flash_attention_fresh", flash_src,
              "butterfly_tpu/ops/flash_attention.py:66",
              gen_fresh + alt["fresh"] + quant["fresh"] + spec["fresh"]
              + bench["fresh"] + tools["fresh"] + ck["fresh"] + tp["fresh"] + moe["fresh"]
              + comb_moe["fresh"] + pipe["fresh"] + mh["fresh"], fresh_cases,
              "fresh_bf16"),
        entry("flash_attention_warm", flash_src,
              "butterfly_tpu/ops/flash_attention.py:97",
              alt["warm"] + spec["warm"] + bench["warm"] + tools["warm"]
              + ck["warm"] + tp["warm"],
              warm_cases,
              "warm_bf16"),
        entry("ring_attention",
              "butterfly_tpu_torch/ops/csrc/ring_attention.cu",
              "butterfly_tpu/ops/ring_attention.py:158",
              long_ring + bench["ring"] + tools["ring"] + comb["ring"]
              + comb_moe["ring"] + mh["ring"], rres,
              "diag_bf16"),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    assert paged_attention.launches > 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multihost-worker"]:
        sys.exit(_multihost_worker(int(sys.argv[2]), int(sys.argv[3]),
                                   sys.argv[4]))
    sys.exit(main())
