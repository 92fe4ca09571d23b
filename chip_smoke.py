#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero and no result line is printed:

1. device   — a CUDA card is required; prints the card's name and power
              limit (nvidia-smi) and turns TF32 off for matmuls and cuDNN.
2. build    — builds every kernel (serving and training paths) from the
              sources in this checkout with nvcc for sm_90a (one nvcc per
              translation unit, all started together) and prints the build seconds,
              registers and spills; the three decode kernels
              (decode_sm90.cuh's decode_kernel in each library) and the
              tensor-core kernels (the grouped FFN's, flash attention's) must
              not spill, the latter must hold HGMMA
              instructions in their SASS (cuobjdump; logged as not checked
              where the toolkit lacks it).
3. check    — holds each kernel against its plain PyTorch version at its
              path's shapes and edge cases, atol = rtol = 2e-2 (the
              reference's own bf16 kernel tolerance); length-0 rows of the
              decode kernels must be exactly 0, and the int8/fp8 codes and
              scales that quant_write_kv writes on the card must equal those
              it writes on the CPU from the same inputs.  The grouped FFN
              (moe_ffn, ragged_ffn) and flash attention must take the route
              their shape and type select (tc_launches): the m6 shapes the
              tensor cores, where each is also held within one bf16 ulp of
              the plain version of that route's numerics (split-h: h as bf16
              hi + lo; split-P: P as bf16 hi + lo); ragged_ffn at the decode
              and mixed steps' rows and at phase 9's model drafter's forward
              (2 routing groups of 1024 rows in one launch), at every ragged
              shape below both without the liveness and with it as the
              dispatchers pass it (the view's token, or a received buffer's
              ids with -1 on its padding, and the tile from static sizes):
              the call under torch.cuda.set_sync_debug_mode("error"), a
              dead block's rows exactly 0, also with every block dead,
              every block live, and a received buffer's dead rows NaN;
              the mesh packing's liveness on the card, under "error" too;
              one dropless dispatch under "warn": a line that syncs fails
              the run.  The dropless combine (ragged_combine.cu) at phase
              5's decode and mixed steps (8 and 40 tokens, R 232 and 264),
              granite's decode (top-8 of 40, M 1536), expert choice at
              phase 11 (f)'s router-training shape (1152 tokens, K = 32)
              and a mesh rank's groups of phase 16 (b) (out a row slice of
              the unpacked buffer), bf16 and f32, under "error": forward
              bit-equal to its plain version, and to the index_put_
              scatter-add it replaced at top-1 (at K > 1 within one bf16
              ulp plus f32 summation slack, COMBINE_ATOL / COMBINE_RTOL,
              of that scatter-add summed in f32; against it in bf16
              reported), NaN in the unrouted rows kept out; backward
              against autograd through the scatter-add.  The paged kernels also
              at every cluster split (1, 2, 4, 8) forced, with a ring of
              stages that wraps (a 1000-token row), f32 at G = 2, 4, 8 and
              D = 32, 128, and a garbage block of 1e4 past every length;
              the dense kernel likewise (every split forced, a wrapping
              ring, f32 at G = 2-8 and D = 32, 128, bf16 at D = 16, and
              cache rows of 1e4 past every length).  Phase 11's shapes:
              moe_ffn at X = 1 and 15 (a static decode step and prefill
              at capacity 1.25), ragged_ffn at the static prefill's 384
              rows and at expert choice's slot-major layout, and the dense
              kernel at the static engine's caches (every row at one
              length), also against its split-and-merge plain version.
              Phase 14's shape: the dense kernel at zamba2-7b's shared
              attention (bf16, B 8, Hkv 32, G 1, D 224) at the plan and
              every split forced, a wrapping ring, 1e4 past every length,
              f32, and the engine's equal-length steps.  Phase 15's:
              the dense kernel at encdec's cross-attention (bf16 and f32,
              B 8, Hkv 16, D 64, G 1, every row at T = S_src = 256 and at
              T = 250, whose last TMA box runs past T; the plan and every
              split forced), and with a logit softcap of 5 on q scaled so
              that the scores reach about +-20, at m6's static trace shape
              and zamba's D = 224, against the capped plain versions.
              Phase 19's: the dense kernel at a rank's heads of (1, 4)
              (bf16, B 8): zamba's 8 of 32 heads of 224 over the engine's
              33-position cache, seamless's self-attention 4 of 16 heads of
              64 over 64 positions and its cross-attention over the
              256-frame memory, the plan and every split forced, every row
              at the run's longest length and at mixed ones.
4. timing   — per kernel: its time by CUDA events over back-to-back calls
              (for a kernel of a few microseconds, the host's launch rate)
              and its device time (torch.profiler: every kernel one call
              launches), the plain version's time, a PyTorch library call's
              as a yardstick (events and device time), and the bound (the
              larger of bytes over 3.35 TB/s and flops over 989 TFLOP/s
              bf16); for the grouped FFN and flash also their CUDA-core
              route's time, for the FFN each pass's device time (and the
              ragged FFN's work list); the ragged FFN with the liveness (the
              dispatcher's call) beside the same call without it; flash at
              both m6 training lengths, S = 144 and 256; the paged kernels
              (bf16 and int8) and the dense kernel at 8 rows x 256
              positions and at the decode step for their chosen split and
              each split forced, with the splits and stages beside each
              time and SDPA's device time beside the dense kernel's; then
              the FFN, flash and dense kernels measured again on the same
              inputs; and phase 11's shapes (above), the dense kernel at
              the static trace's cache and median decode length beside
              SDPA's time and its bound; the dense kernel at zamba's
              trace cache, at its median and its longest attended length;
              the dense kernel at encdec's cross-attention (T = 256, 250)
              and at the static trace shape under the softcap; the dense
              kernel at phase 19's rank shapes; the dropless combine at
              phase 3's shapes beside its bound (routed rows, gates and
              row map read, y written), its plain version, the index_put_
              scatter-add it replaced (library_ms) and index_add_.
5. serve    — m6-base at full width (5 layers, random weights from a seeded
              torch.Generator) serves synthetic_trace(16, 21128, seed=0)
              through the continuous engine with dropless MoE, its decode
              and mixed steps captured as CUDA graphs when the engine is
              built and replayed; every request
              must finish with its budget, the dropped fraction must be
              exactly 0.0, and each serving kernel's launch count must equal
              layers x engine steps (the ragged FFN's and the dropless
              combine's too; a replay adds its graph's launches to the
              wrappers' counters).  The census: engine_compiled_variants
              equal to the engine's expected variants (2; 3 when
              speculating, 1 recurrent) and engine_recompiles_total 0,
              gated after every continuous-engine run of every serving
              phase (on the card; off it at most the expected); the graphs'
              pool bytes are reported.  The same trace through the eager
              forms (graphs=False): tokens/s, mean step, p50/p95 beside the
              graphed run's; then both in lockstep at the graphed run's step
              clocks through logit_tap: greedy tokens identical (and to
              the graphed run's), the largest logit difference over live
              rows reported.  Then one mixed step's forward runs
              twice, through the kernels and through the plain versions, and
              the logits and greedy tokens are compared.  The device busy
              share of 24 steps is taken twice, recording the CPU's activity
              beside the card's (the share phases 5 and 7 have always
              reported) and the card's alone (as phase 12 takes it), with
              the combine's device time and calls (graphed forms; the
              paged kernels the profiler recorded against those launched
              says whether it saw the replays' kernels); the card's alone
              over the eager forms; then over the eager forms once more with
              the index_put_ scatter-add in place of the combine kernel (the
              busy device ms a step of both).  Every gate that counts the
              ragged FFN's launches (expect_launches and phases 5-10) wants
              the combine's as often: one of each a dropless dispatch.
6. train    — first, AdamW's update of m6-shaped leaves at steps 1-4 and the
              trainer's 3-way microbatch average must be bit-equal on the
              card to the CPU's (true divisions; the share a Python-number
              divisor would move is reported).  Then m6-base at full width
              trains through the train CLI's own
              setup (``repro_torch.launch.train``): 8 steps of top-1 routing
              with capacity 1.25 through the grouped-FFN kernel (``pallas``),
              then 4 steps of 4 top-1 expert prototyping.  Every loss and grad
              norm must be finite, the dropped fraction in [0, 1), and the
              grouped-FFN kernel launched layers x steps x 2 times (forward
              and the remat recompute in the backward), all on the tensor
              cores, the other kernels not at all; then the same runs with
              the grouped FFN on its CUDA-core route, for their step times.
              Then a profiled pair of steps (device busy share),
              one step's loss and gradients through the kernels against the
              plain versions (routing near-ties reported), a dropless step
              whose expert weights must get the plain path's gradient, and
              ``lm_apply(use_flash=True)`` against ``use_flash=False`` on the
              train batch (the flash kernel launched once per layer, every
              launch on its tensor-core route).
7. kv      — m6-base served over the quantized and prefix-cached paged KV
              cache, same weights and ServeConfig defaults as phase 5:
              (a) the 16-request trace under kv_quant int8 and fp8 (every
              request finishes its budget, the quantized attention kernel
              launched layers x steps times and the bf16 one never, dropped
              fraction 0.0, conservation holds; token match against phase 5,
              logit divergence of one replayed request through logit_tap, one
              mixed step kernels-vs-plain); (b) equal-byte capacity, bf16
              pools of 8 blocks against int8 pools of 15 (block bytes 327,680
              and 164,480, peak running int8 / bf16 >= 1.3); (c) prefix
              caching on a multi-tenant trace, off and on, under none and
              int8 (cached-token ratio > 0 when on); (d) the dense-cache
              decode kernel on the engine's pools against the paged kernel.
8. ckpt     — checkpoints and restarts at m6-base's widths cut to 2 layers
              (567.4 M parameters, 6.81 GB a training checkpoint) through
              the train CLI's loop, in a temporary directory under build/
              removed at the end (the free space is checked first): two
              straight 4-step runs; a run with --ckpt-every 2 and a failure
              injected before step 3, which run_with_restarts resumes from
              step 2 (the step-2 checkpoint must restore bit-equal to the
              state it was taken from, and the final params differ from a
              straight run's by no more than the two straight runs
              differ); the 16-request trace served from
              restore_params_latest must give the greedy tokens of an engine
              built from the trained params; the serving tree's bf16
              checkpoint must round-trip bit-equal; save seconds, GB/s and
              save_async's snapshot seconds are printed.
9. spec     — m6-base speculative and sampled serving, phase 5's weights
              and trace, gamma 4: (a) greedy speculative decoding over bf16
              pools with the ngram drafter, the model drafter (the target's
              own weights) and a seeded random drafter registered here
              (rejection and rollback at nearly every verify step); each
              run must finish every budget, drop nothing, keep the cache's
              conservation after every step, launch the paged kernel layers
              x steps times and every ragged FFN on the tensor cores, run
              verify steps (the model drafter one that accepts 2 or more
              drafts), and give phase 5's tokens, a request differing first
              only where a non-speculative run's top two logits are a
              near-tie (logit_tap; reported with the gap); (b) ngram over
              int8 pools, held to phase 7a's int8 tokens the same way;
              (c) the sampler: its uniforms on the card equal to the CPU's,
              its tokens over 4096 keys equal but at near-ties, a 20 000-key
              frequency test within 0.015 of softmax(logits / T), and the
              trace with every request at t = 0, greedy (the step-time
              baseline), at T = 0.8 without speculation, with ngram and
              with the model drafter, and at T = 0.05 with the model
              drafter (drafts must be accepted, some verify step must emit
              2 or more tokens), each run twice with one seed and identical;
              (d) every run's tokens/s, mean step, p50/p95, verify steps,
              acceptance and tokens a verify step beside phase 5's, and the
              paged, int8 and ragged FFN kernels' times at the verify
              step's shape (the FFN also at the model drafter's, which
              phase 3 holds against its plain versions).  A profiler
              session counts only when it recorded every launch and a time
              no shorter than the bound (phase 4 and 9 alike).
10. slo     — m6-base SLO scheduling at 2 of its 5 layers (the script's
              time), random weights from seed 0, dropless MoE, the
              reference benchmark's slo_sweep cell (4 slots, 16-token blocks
              and chunks, 28 blocks, prefix cache on, synthetic_priority with
              short HIGH requests against long NORMAL/LOW ones): (a) a
              saturated fcfs run measures capacity, then 48 requests at 2x
              overload under fcfs and priority_strict, edf and cache_aware
              with preemption to a 56-block host pool, each with
              conservation checked after every step: every budget finished,
              dropped fraction 0.0, the paged kernel and the ragged FFN
              launched layers x steps times (every FFN launch on the tensor
              cores), every swap record released, priority_strict preempting
              and restoring, and every policy's tokens equal to fcfs's, a
              request differing first only at a near-tie of fcfs's top two
              logits (every run taps its logits); (b) fcfs and
              priority_strict over int8 pools, held the same way; (c)
              swap_out, clobber, restore_slot of 7 blocks on the card over
              bf16, int8 and fp8 pools, bit-equal, with the host time of a
              swap-out and a restore per block; (d) priority_strict with
              shedding on a trace of tight HIGH deadlines (in arrival gaps
              of (a)'s qps, calibrated from the graphed engine's capacity):
              some request shed, none holding a slot, a block or a token;
              every run on the graphed step.  Per-class p50/p95
              and goodput, tokens/s against fcfs, the HIGH p95 ratio fcfs /
              priority_strict, preemptions, swapped and restored blocks.
11. static  — m6-base through the static lockstep engine
              (repro_torch.serving.engine), phase 5's weights: (a) greedy
              generate of an 8 x 48 batch, 16 tokens, against the
              continuous engine's tokens (a row may differ only from a
              near-tie of the continuous run's top two logits on), with
              its decode tokens/s; (b) run_trace_static at batch 8 over
              phase 5's trace, every budget met, tokens/s and p50/p95
              beside phase 5's continuous run and the ratio continuous /
              static; (c) on every static run, the dense decode kernel
              launched layers x decode steps times and every FFN launch on
              the tensor cores, nothing else, counted through the replays
              of the engine's CUDA graphs (a decode form a batch size, a
              prefill form a prompt shape, reused across generates); the
              graphed forms against graphs=False on the batch in one call:
              greedy tokens identical, the largest logit difference 0, the
              same launches, each mean step; profiled generates (device
              busy share, the kernels by device time), graphed and eager,
              the graphed one's counters equal to the kernels CUPTI
              records; (b) again with the eager forms beside; (d) the batch at
              --moe-impl pallas, capacity 1.25, through moe_ffn; (e) hash
              routing, static against continuous as in (a); (f) at 2
              layers, 2 training steps each of hash (pallas) and
              expert_choice (pallas, dropless) through the train CLI,
              then one step's loss and gradients kernels against plain.
12. families — the decoder-LM configs at full width, random weights from
              seed 0, each over its own 16-request synthetic trace through
              the continuous engine with dropless MoE: (a) granite-moe-3b-
              a800m at 8 of its 32 layers (top-8 of 40 swiglu experts, 24 heads
              over 8 kv heads of 64: the paged kernel at G = 3), (b) granite
              under prototyped(8) (8 prototypes x 5 experts, 8 top-1), (c)
              qwen2.5-32b at 2 layers over int8 pools (the quantized kernel
              at G = 5, D 128, QKV bias) and olmoe-1b-7b at 2 layers
              (qk-norm, G = 1, D 128, top-8 of 64); every run meets every
              budget with dropped fraction 0.0 and launches its attention
              kernel and ragged FFN layers x steps times (every FFN launch
              on the tensor cores, nothing else), and its greedy tokens
              equal those of the same engine on the plain versions but at
              near-ties of the latter's top two logits; tokens/s, step ms,
              p50/p95 and (granite) the device busy share, recorded from
              the CUDA activity alone.  (d) granite at
              2 layers through the train CLI: 4 steps of Adafactor with 8
              top-1 prototyping, batch 4 x 2048 (losses finite and within 1
              of ln 49155, the chunked attention path in every layer,
              moe_ffn layers x steps x 2 on the tensor cores); Adafactor's
              update of every leaf on the card against the CPU's on the
              same gradients (rtol 2e-5); 2 steps at --grad-compression
              int8 whose codes and scales equal the CPU's; a --profile-dir
              step whose trace names moe_ffn's kernel.  Phase 3 holds the
              decode kernels at G = 3 and 5 and at olmoe's G = 1, D 128,
              moe_ffn at granite's training shape and the ragged FFN at
              granite's decode and mixed steps and olmoe's decode step;
              phase 4 times them.
13. more    — more families (``chip_smoke.phase_more_families(torch)``
              alone after ``build.build()``), random weights from seed 0:
              (a) Fig. 4's MoE attention runs at m6-base's full width
              (about 2.04 B parameters): top-1 and 2 top-1 prototyping
              (``configs.m6.variant``), pallas, capacity 1.25, AdamW, 8 x
              144, 4 steps each through the train CLI (losses finite and
              within 1 of ln 21128, dropped fraction in [0, 1), moe_ffn
              layers x steps x 2 on the tensor cores and nothing else, peak
              memory), and one step's loss and gradients kernels vs plain
              (the attention's routing flips reported beside the FFN's);
              (b) m6-base at moe_layer_period 2 (MoE in layers 0, 2, 4),
              dropless: phase 5's trace through the continuous engine
              (conservation after every step, paged kernel 5 x steps,
              ragged FFN 3 x steps, tokens equal to the plain versions' but
              at near-ties), the static engine on the 8 x 48 batch (tokens
              equal to the continuous engine's but at near-ties, dense
              kernel 5 x decode steps), 2 pallas training steps (moe_ffn 3
              x steps x 2); (c) xlstm-125m at full width: its 16-request
              trace in recurrent slots (every budget met, no kernel
              launched; tokens/s, mean step, p50/p95; the recurrent step
              and slot reset CUDA graphs, census 1; beside the eager forms,
              greedy tokens identical), the static engine's graphed
              token-by-token generate on the 8 x 48 batch equal to the
              continuous engine's but at near-ties, against graphs=False
              as in phase 11 (c), both profiled, the trace's first 4
              requests again on the CPU (the card's tokens equal to the
              CPU's but at near-ties), and 2 steps of the train CLI at 4 of
              its 12 layers (the script's time; so does phase 19), 4 x
              1024 (the chunked mLSTM form and the sLSTM loop; losses
              finite and within 1 of ln 50304).
14. zamba   — zamba2-7b (``chip_smoke.phase_zamba(torch)`` alone after
              ``build.build()``), random weights from seed 0: (b) at full
              width and depth (81 Mamba2 layers, 14 applications of the
              shared attention, 6.868 B parameters) the static engine's
              greedy generate of an 8 x 48 batch, 16 tokens (the dense
              kernel launched 14 x steps, every prompt token a step, and
              nothing else; the tokens equal to the same engine's on the
              plain versions but at near-ties of its top two logits;
              decode tokens/s, mean step, peak memory), its decode form a
              CUDA graph, against one eager generate as in phase 11 (c),
              and the busy share of a profiled generate, graphed and
              eager; phases 3 and 4 hold and time the dense kernel at the
              static plan (from T) and at the per-length plan;
              (e) the serve CLI with --engine
              static --requests 8 --batch 8: run_trace_static over
              synthetic_trace(8, 32000, seed=0), one FCFS group of 8
              (every budget met, launches and tokens gated as in (b);
              tokens/s, mean step, p50/p95), and --engine continuous
              refused with the reference's reason;
              (c) at 7 layers (1.097 B parameters, segments (0, 6) and (6,
              7)) the card's tokens on 4 rows equal to the CPU's but at
              near-ties; (d) 2 AdamW steps of the train CLI at 7 layers, 4
              x 1024 (losses finite and within 1 of ln 32000, no kernel
              launched, the shared attention's materialised scores, step
              ms and peak memory).
15. encdec  — seamless-m4t-large-v2 (``chip_smoke.phase_encdec(torch)``
              alone after ``build.build()``), random weights from seed 0:
              (a) at full width and depth (24 + 24 layers, 1.370 B
              parameters) encode SyntheticSeq2Seq(256206, 1024, 8,
              src_len=256, tgt_len=48, seed=0).batch_at(0)'s 8 x 256
              frames, init_state(max_len=64), feed 8 target tokens one
              decode_step at a time, then greedy steps to 48 tokens (the
              dense kernel launched 2 x 24 x 47 times, self- and
              cross-attention, and nothing else; every greedy token in the
              vocabulary; the tokens equal to the same loop's on the plain
              versions but at near-ties; encode ms, mean step, tokens/s,
              peak memory, the busy share of a profiled loop); (b) at 2 +
              2 layers the card's tokens on 4 rows equal to the CPU's but
              at near-ties; (c) 2 AdamW steps of the train CLI at full
              depth, 4 x 256 (losses finite and within 1 of ln 256206, no
              kernel launched; step ms, peak memory); (d) the serve CLI
              refused by both engines with the reference's reasons; (e)
              m6-base's static 8 x 48 generate under a softcap of 0.5
              (dense kernel 5 x decode steps, ragged FFN 5 x (prefill +
              decode steps); tokens equal to the plain versions' but at
              near-ties).
16. mesh    — m6-base served on a (data, expert) mesh
              (``chip_smoke.phase_mesh(torch, base, int8)`` after phases 5
              and 7 (a), whose step clocks ``STEP_CLOCKS`` records), phase
              5's weights, trace and ServeConfig defaults, dropless: (a)
              the (1, 1) mesh in this process on a world-1 NCCL group,
              phase 5's and 7 (a)'s runs replayed at their step clocks
              (the same admissions, so the same rows) over bf16 and int8
              pools: tokens identical to theirs, the paged (int8: the
              quantized) kernel and the ragged FFN launched layers x steps,
              every FFN launch on the tensor cores, no all_to_all,
              conservation after every step; the bf16 replay in two
              rounds with and without the per-step checks on the mesh
              and without them on a single-device engine (mean step of
              each); then an
              unreplayed run (tokens/s, mean step, p50/p95); (b) (data 2, expert 2) as
              four spawned processes that share the card over gloo
              (``launch.mesh.spawn``), m6-base with group_size 1 (G = N: 8
              at decode, 72 at a mixed step, split over the 4 ranks), each
              rank drawing only its slices of the weights: every rank 16
              of the 32 experts and a pool slice of shard_blocks + 1 rows,
              3 all_to_alls in every MoE layer of every step, the paged
              kernel and the ragged FFN launched layers x steps on each
              rank (the FFN on the tensor cores), every rank's tokens
              equal (also asserted each step by check_invariants), and
              equal to a single-device run of the same config in this
              process but at reported near-ties of its top two logits;
              reported: equality with phase 5's tokens, per-rank tokens/s,
              mean step and the seconds in collectives; then the trace
              served once more by each rank's ContinuousEngine.run,
              unreplayed, the ranks agreeing on each step's clock: its
              tokens equal on every rank and every budget met (tokens/s,
              p50/p95, the token match against the replay).  Phase 3 holds the
              paged and int8 kernels at a shard's 4 and 36 rows over a
              65-row pool slice and the ragged FFN at (b)'s received
              buffers (928 and 8352 rows, 16 local experts); phase 4 times
              them.
17. mesh training — m6-base trained on a (data, model) mesh: (a) phase
              6's 8 top-1 pallas steps again through the train CLI on the
              (1, 1) mesh (a world-1 NCCL group in this process): losses
              and final params bit-equal to phase 6's, no collective,
              moe_ffn launched as there; (b) (data 2, model 2) as four
              spawned processes that share the card over gloo, a batch of
              16 x 256 (G = 4 groups of 1024, one a rank), at 2 layers:
              alltoall top-1 for 3 steps, and 4 top-1 prototyping,
              dropless and pallas for 2 steps, AdamW with ZeRO-1; each
              run first single-device on the card (step 0's loss, routes
              and gradients), then on the ranks: every rank's loss equal
              at every step, step 0 within compare_train_step's gates of
              the single device (loss, gradient norm, every leaf's cosine;
              flips reported with margins), all_to_all a step = MoE layers
              x 6 (capacity) / 8 (dropless) / 0 (pallas), moe_ffn and the
              ragged FFN 2 x layers x steps a rank on the tensor cores and
              no other kernel, half the AdamW state a rank on every leaf
              with a free divisible dim, every grouped-FFN shape launched
              one that phase 3 holds against its plain version (moe_ffn at
              X = 80 a rank and 160 on one device, 90 for the straddling
              run below; the ragged FFN over a rank's received 4032 rows
              and one device's 8064; phase 4 times them), every rank's
              parameter bytes its placement's; reported per rank: step
              ms, tokens/s, collective seconds by kind and share, peak
              GB, and every step's collectives by kind, axis and byte;
              then, in the same world, Fig. 4's MoE attention (phase 13's
              config edits) with pallas at 2 layers for 2 steps: top-1 at
              16 x 256 (two groups a data rank) and 2 top-1 at phase 6's
              8 x 144 (one global group, straddling the data ranks), each
              under the gates above (flips over both routing calls a
              layer), 16 of 32 attention experts a rank, and the
              MoE-attention layers' collectives a step (counted under
              their own scope) as the form predicts: 7 all-reduces over
              "model" a layer, and 2 over "data" (top-1) or 6 all-gathers
              and 2 reduce-scatters over "data" (straddling); then the
              pallas run again with cfg.fsdp (phase 18 (c)).
18. tooling — (a) flops_for, bytes_for and the one-card roofline bound
              (distributed/costs.py and roofline.py, the H100 SXM's
              datasheet peaks) of phase 6's top-1 cell and phase 5's
              decode step beside their measured steps, and the achieved
              model-FLOPs share; (b) the dry run (launch/dryrun.py on meta
              tensors, as rank 0 of a fake process group, in a CPU process
              started after phase 2) of phase 6's cell on one device and
              of phase 17 (b)'s first run as rank 0 of (2, 2): its
              parameter and optimizer-state bytes and every step's
              collective launches and bytes by kind and axis equal rank
              0's on the card exactly; its predicted peak beside
              max_memory_allocated; (c) FSDP's run: losses and every final
              param block bit-equal to the run without FSDP, the same
              kernel launches; its peak a rank.
19. mesh families — xlstm-125m, zamba2-7b and seamless-m4t-large-v2 on
              a model axis, four spawned processes that share the card
              over gloo, each drawing only its blocks of the seed's
              weights: (a) served on (data 1, model 4) under
              ``make_rules(cfg, mesh)``, greedy, at full width and depth
              but zamba2-7b's, cut to 27 of 81 layers (the script's time):
              zamba2-7b and xlstm-125m through ``ServingEngine(...,
              rules=)`` (8 rows, 8 prompt tokens a token a step, 8
              generated: the script's time), seamless through
              ``encdec_greedy`` under the rules (8 x 256 frames encoded, 8
              tokens fed, greedy to 16);
              every rank's tokens equal, and equal to the same run's on one
              device on the card but at reported near-ties of its top two
              logits; the dense kernel launched zamba 5 x 15 and seamless
              2 x 24 x 15 times a rank, at the rank's head count and at
              shapes phase 3 holds, and nothing else (xlstm: no kernel);
              every rank's parameter bytes its placement's; per rank the
              mean decode step, tokens/s, collective seconds and launches
              a step, peak GB; (b) trained on (data 2, model 2), AdamW with
              ZeRO-1, 2 steps through the train CLI's parts: xlstm-125m at
              4 of its 12 layers (the script's time; 4 x 128: the sLSTM
              loop is eager), zamba2-7b at 7 layers (4 x 512),
              seamless at 4 + 4 layers (4 x 256); every rank's loss equal
              at every step, step 0 within compare_train_step's gates of
              one device on the card (loss 1e-3, gradient norm 2e-2, every
              leaf's cosine >= 0.99), no kernel launched, half the AdamW
              state a rank on every leaf with a free divisible dim; per
              rank step ms, collective seconds, peak GB; then each family
              again with cfg.fsdp in the same world: losses and every
              final parameter block bit-equal to the run without FSDP,
              the same launches (none), some leaves FSDP blocks, the peak
              GB a rank beside the run without FSDP.
20. report  — a {"kernels": [...]} line (ragged_combine: no TPU kernel,
              "replaces" the reference's scatter-add, its phase 3-4 shapes
              and phase 5's profiled device ms; decode_attention's launches and
              times from the static engine's path; static_launches and
              router_train_launches of phase 11; family_launches and
              family_shapes of phase 12; more_families_launches of phase
              13; zamba_launches of phase 14, and the dense kernel's
              zamba_shapes; encdec_launches of phase 15, and the dense
              kernel's encdec_shapes and softcap_shapes; mesh_launches,
              mesh_max_abs_err and mesh_shapes of phase 16 for the paged,
              int8 and ragged FFN kernels; mesh_train_launches,
              mesh_train_max_abs_err and mesh_train_shapes of phase 17 (b)
              for moe_ffn and the ragged FFN; mesh_families_launches of
              phase 19 (a) a rank, and the dense kernel's
              mesh_families_max_abs_err and mesh_families_shapes), the
              seconds since the script started, the card line,
              and as the last line {"ok":
              true, "device": {"platform": "gpu", "kind": ..., "count":
              1}}.
"""
from __future__ import annotations

import functools
import json
import math
import os
import re
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 2e-2                      # bf16 kernel tolerance (atol = rtol)
# the tensor-core grouped FFN against its split-h plain version: the two
# differ only in how their f32 sums are taken (order, and the tensor cores'
# accumulation) before y is rounded to bf16 once, so an element may differ
# by one bf16 ulp (at most 2^-7 of its value) where the sums straddle a
# rounding boundary, plus an f32 summation slack
SPLIT_ATOL, SPLIT_RTOL = 1e-5, 2.0 ** -7
FLIP_MARGIN = 2e-2              # router-logit gap a bf16 rounding can close
GROUPED_FFN_SM90 = "src/repro_torch/kernels/csrc/grouped_ffn_sm90.cuh"
FLASH_SM90 = "src/repro_torch/kernels/csrc/flash_attention_sm90.cuh"
DECODE_SM90 = "src/repro_torch/kernels/csrc/decode_sm90.cuh"
# the decode kernels' device code (decode_sm90.cuh): a pattern of its mangled
# names, in each of the three decode libraries
DECODE_KERNEL = "decode_sm9013decode_kernel"
DECODE_LIBS = ("paged_decode_attention", "quantized_paged_decode_attention", "decode_attention")


START = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# launches of a spin kernel that open each profiler session: a session can
# miss its first launches (seen on the card after serving runs: the first
# 11 of a session's), and these absorb that loss
PRELUDE_LAUNCHES = 40


def open_session(torch) -> None:
    """Launch the prelude of a profiler session and wait for it."""
    for _ in range(PRELUDE_LAUNCHES):
        torch.cuda._sleep(100)
    torch.cuda.synchronize()


def device_events(prof) -> list:
    """A session's CUDA events (kernels, copies, memsets), but the prelude's."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.key]


def profiled_kernels(fn, reps: int):
    """torch.profiler over ``reps`` calls of ``fn`` after one warm call:
    the CUDA events (kernels, copies, memsets) of ``key_averages()``, but
    the session's opening spin kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        open_session(torch)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return device_events(prof)


def complete_sessions(fn, reps: int, sessions: int = 3, bound_ms=None):
    """The CUDA events of up to ``sessions`` complete torch.profiler sessions
    of ``reps`` calls of ``fn``, from at most 3 x ``sessions`` tries.  A
    session now and then records only part of the calls' kernels, or none,
    past what its opening launches absorb.  A session is complete when every kernel it recorded ran a multiple of
    ``reps`` times, it recorded as many launches as the most any session
    did, and its time a call is no less than ``bound_ms`` (the least the
    card could take: a shorter reading is a partial record, not a fast
    kernel).  What was discarded is logged."""
    runs = []
    for _ in range(3 * sessions):
        ev = profiled_kernels(fn, reps)
        runs.append((ev, sum(e.count for e in ev), all(e.count % reps == 0 for e in ev),
                     sum(e.self_device_time_total for e in ev) / 1e3 / reps))
        most = max(r[1] for r in runs)
        good = [r for r in runs if r[1] == most and r[2] and r[3] > 0
                and (bound_ms is None or r[3] >= bound_ms)]
        if len(good) >= sessions:
            break
    if len(good) < len(runs):
        log(f"    profiler: kept {len(good)} of {len(runs)} sessions; launches recorded "
            f"{[r[1] for r in runs]} over {reps} calls, device ms a call "
            f"{['%.5f' % r[3] for r in runs]}"
            + ("" if bound_ms is None else f", bound {bound_ms:.5f}"))
    return [r[0] for r in good]


def device_ms(fn, reps: int = 20, sessions: int = 3, bound_ms=None):
    """Device time of one call of ``fn``: the summed CUDA time of everything
    it launches, from torch.profiler, over ``reps`` calls, the median of
    the complete sessions (``complete_sessions``); None (not measured) if
    no session was complete."""
    totals = sorted(sum(e.self_device_time_total for e in ev)
                    for ev in complete_sessions(fn, reps, sessions, bound_ms))
    return totals[len(totals) // 2] / 1e3 / reps if totals else None


def check_close(name: str, got, want, atol: float = TOL, rtol: float = TOL) -> float:
    import torch

    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output has non-finite values")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} elements off, max abs err "
                             f"{float(err.max()):.4g}")
    tol = f"atol=rtol={atol}" if atol == rtol else f"atol={atol:g}, rtol={rtol:g}"
    log(f"  {name}: max abs err {float(err.max()):.3g} ({tol})")
    return float(err.max())


def on_cuda_cores(ops, fn, route="tensor_core_route"):
    """``fn`` with the kernel wrapper module ``ops`` held to its CUDA-core
    route (the device code before the tensor-core one; ``route`` is the
    module's route function), to time or compare that route at shapes that
    would take the tensor cores."""
    from unittest import mock

    def run(*args):
        with mock.patch.object(ops, route, lambda *a: False):
            return fn(*args)

    return run


def check_routed(name, wrapper, call, args, ref, split_ref, tensor_cores,
                 cuda_core_call=None, split="split-h"):
    """One call ``call(*args)`` of a wrapper with a tensor-core route (the
    grouped FFN, flash attention): the route it took (the ``wrapper``'s
    ``tc_launches`` counter), its output against the plain version at TOL
    and, on the tensor-core route, against the plain version of that
    route's numerics (``split_ref``) at SPLIT_ATOL / SPLIT_RTOL; with
    ``cuda_core_call``, the share of outputs that differ from the plain
    version on each route, on the same inputs.  Returns (max abs err
    against the plain version, against the split one or None)."""
    import torch

    before = wrapper.tc_launches
    out = call(*args)
    torch.cuda.synchronize()
    took = wrapper.tc_launches - before
    if took != int(tensor_cores):
        raise AssertionError(f"{name}: took the {'tensor-core' if took else 'CUDA-core'} route, "
                             f"expected the other")
    route = "tensor cores" if took else "CUDA cores"
    want = ref(*args)
    err = check_close(f"{name} [{route}] vs plain", out, want)
    if cuda_core_call is not None:
        cc = cuda_core_call(*args)
        log(f"    outputs differing from the plain version: "
            f"{float((out != want).float().mean()):.5f} on this route, "
            f"{float((cc != want).float().mean()):.5f} on the CUDA-core route (max abs err "
            f"{float((cc.float() - want.float()).abs().max()):.3g})")
    if not tensor_cores:
        return err, None
    want = split_ref(*args)
    err_split = check_close(f"{name} [{route}] vs {split} plain", out, want,
                            atol=SPLIT_ATOL, rtol=SPLIT_RTOL)
    log(f"    {float((out == want).float().mean()):.4f} of the elements bit-equal to the "
        f"{split} plain version")
    return err, err_split


@contextmanager
def no_sync(torch):
    """The block under ``torch.cuda.set_sync_debug_mode("error")``: an op
    that reads the device back to the host raises."""
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


def case_tile(n, E, bx, gated=False, capacity=None, top_k=1, groups=1):
    """The tile width the dispatcher picks (``dropless.choice_tile_rows``)
    for ``ffn_case``'s layout of ``groups`` groups in one launch."""
    from repro_torch.core.dispatch.dropless import choice_tile_rows

    return choice_tile_rows(n * top_k, E, bx, gated, groups,
                            min(capacity, n) if capacity is not None else None)


def check_ragged(torch, name, xs, be, weights, act, bx, live=None, tile=0, tensor_cores=True,
                 both=False):
    """``check_routed`` for the ragged FFN, with the liveness ``live`` (a
    tag a row, >= 0 on a routed row) and ``tile`` as the dispatcher passes
    them: the call runs under the sync-debug mode "error" (the work list is
    built on the device), the plain versions take the same liveness, and a
    dead block's rows must be exactly 0.  Returns (max abs err against the
    plain version, against the split one or None)."""
    from repro_torch.kernels.moe_dropless import ops as rffn
    from repro_torch.kernels.moe_dropless.ref import (
        live_blocks,
        ragged_ffn_ref,
        ragged_ffn_split_ref,
    )

    def call(*a):
        with no_sync(torch):
            return rffn.ragged_ffn(*a, act, block_x=bx, live=live, tile=tile)

    label = f"ragged_ffn {name}" + ("" if live is None else f" with liveness, tile {tile}")
    out = check_routed(label, rffn.ragged_ffn, call, (xs, be, *weights),
                       lambda *a: ragged_ffn_ref(*a, act, live),
                       lambda *a: ragged_ffn_split_ref(*a, act, live), tensor_cores,
                       on_cuda_cores(rffn, call) if both else None)
    if live is not None:
        y = call(xs, be, *weights)
        keep = live_blocks(live, be.numel())
        dead = ~keep.repeat_interleave(bx)
        if not (y[dead] == 0).all():
            raise AssertionError(f"{label}: a dead block's row is not exactly 0")
        log(f"    {int(keep.sum())} live blocks of {keep.numel()}; the {int(dead.sum())} rows "
            f"of the dead ones exactly 0; no sync")
    return out


# the lines of the port that read the device back to the host in one dropless
# dispatch (phase 3's ``dispatch_syncs``), for the summary line
DISPATCH_SYNCS = []


def dispatch_syncs(torch, weights):
    """m6-base's decode-step routing and dropless dispatch (the ragged view,
    the gather, the kernel with the liveness, the combine) once under the
    sync-debug mode "warn": the lines that read the device back to the host
    ("file:line"), reported, not gated (every kernel call above runs under
    "error")."""
    import warnings

    from repro_torch.configs.base import MoEConfig
    from repro_torch.configs.m6 import M6_BASE
    from repro_torch.core.dispatch.dropless import dropless_dispatch
    from repro_torch.core.routers.topk import topk_plan

    g = torch.Generator(device="cuda").manual_seed(170)
    E = weights[0].shape[0]
    xg = torch.randn((1, 8, weights[0].shape[1]), generator=g, device="cuda").to(torch.bfloat16)
    logits = torch.randn((1, 8, E), generator=g, device="cuda")
    params = {"up": weights[0], "down": weights[2]}
    before = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            plan = topk_plan(logits, MoEConfig(num_experts=E, top_k=1, aux_loss_coef=0.0), 8)
            dropless_dispatch(params, xg, plan, M6_BASE)
        finally:
            torch.cuda.set_sync_debug_mode(before)
    torch.cuda.synchronize()
    where = []
    for w in caught:
        if "synchroniz" in str(w.message):
            path = Path(w.filename)
            where.append(f"{path.relative_to(ROOT) if path.is_relative_to(ROOT) else path.name}:"
                         f"{w.lineno}")
    where = sorted(set(where))
    log(f"  dropless dispatch at the decode step under sync-debug \"warn\": "
        f"{', '.join(where) if where else 'no op synced'}")
    if where:
        raise AssertionError(f"the dropless dispatch reads the device back at {where}")
    return where


# ---------------------------------------------------------------------------
# The dropless combine (kernels/moe_dropless/csrc/ragged_combine.cu)
# ---------------------------------------------------------------------------

# the combine's shapes: label -> (groups, tokens a group, experts, width, top-k, expert-choice
# capacity or None, a mesh rank's slice of the groups or None)
COMBINE_SHAPES = {
    "decode": (1, 8, 32, 1024, 1, None, None),           # phase 5's decode step: R 232
    "mixed": (1, 40, 32, 1024, 1, None, None),           # phase 5's mixed step: R 264
    "granite decode": (1, 8, 40, 1536, 8, None, None),   # phase 12 (a): top-8 of 40, R 344
    "expert choice": (1, 1152, 32, 1024, 1, 45, None),   # phase 11 (f)'s router training
    "mesh decode": (8, 1, 32, 1024, 1, None, (2, 4)),    # phase 16 (b): a rank's 2 of 8 groups
    "mesh mixed": (72, 1, 32, 1024, 1, None, (18, 36)),  # and its 18 of 72
}
# the combine against the scatter-add it replaced with its terms summed in f32 and rounded
# once (index_put_(accumulate=True) over the f32 terms, in row order): with K > 1 the two
# orders of the f32 sum may round to neighbouring values, one bf16 ulp (at most 2^-7 of the
# value) apart, plus an f32 summation slack; at top-1 a token has one term, and the combine
# is bit-equal to the scatter-add in the activation dtype itself
COMBINE_ATOL, COMBINE_RTOL = 1e-5, 2.0 ** -7


def combine_case(shape, seed, dtype=None):
    """The combine's inputs at ``shape`` (a ``COMBINE_SHAPES`` value), as
    ``dropless.dropless_dispatch`` (or, with a rank's groups,
    ``ragged_ep_dispatch``: out a row slice of an (R + 1)-row buffer)
    passes them: the ragged view's gate and row map of a plan over random
    router logits, random rows in ``dtype``.  Returns (out, gate, rows,
    token: the view's, -1 on the rows no choice is routed to)."""
    import torch

    from repro_torch.configs.base import MoEConfig
    from repro_torch.core.dispatch.dropless import combine_rows, plan_block_rows
    from repro_torch.core.routers.expert_choice import expert_choice_plan
    from repro_torch.core.routers.topk import topk_plan

    G, T, E, M, k, capacity, groups = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    logits = torch.randn((G, T, E), generator=g, device="cuda")
    if capacity is None:
        plan = topk_plan(logits, MoEConfig(num_experts=E, top_k=k, aux_loss_coef=0.0), T * k)
    else:
        plan = expert_choice_plan(logits, MoEConfig(num_experts=E, routing="expert_choice"),
                                  capacity)
    rag = plan.ragged(plan_block_rows(plan))
    part = slice(*groups) if groups else slice(None)
    token, gate = rag.token[part], rag.gate[part]
    Gl, R = token.shape
    buf = torch.randn((Gl, R + 1, M), generator=g, device="cuda").to(dtype or torch.bfloat16)
    return buf[:, :R], gate, combine_rows(plan, rag.sort_order[part], part), token


def scatter_add_combine(out, gate, token, T, f32=False):
    """The combine as the dispatcher ran it before the kernel: the
    gate-weighted rows (out's dtype) scatter-added with
    index_put_(accumulate=True), the padding rows into token 0 (gate 0);
    with ``f32`` the terms are added in f32 and the sum rounded once."""
    import torch

    G, R, M = out.shape
    vals = out * gate[..., None].to(out.dtype)
    gi = torch.arange(G, device=out.device)[:, None].expand(G, R)
    tok = torch.clamp(token, min=0).long()
    acc = torch.float32 if f32 else out.dtype
    return torch.zeros((G, T, M), dtype=acc, device=out.device).index_put_(
        (gi, tok), vals.to(acc), accumulate=True).to(out.dtype)


def index_add_combine(out, gate, token, T):
    """The same sum by index_add_ over the flattened (group, token) rows."""
    import torch

    G, R, M = out.shape
    vals = (out * gate[..., None].to(out.dtype)).reshape(G * R, M)
    tok = torch.clamp(token, min=0).long() + T * torch.arange(G, device=out.device)[:, None]
    y = torch.zeros((G * T, M), dtype=out.dtype, device=out.device)
    return y.index_add_(0, tok.reshape(-1), vals).reshape(G, T, M)


def combine_bound(out, rows):
    """The routed rows read once, their gates and the row map read, y
    written once; two flops an element of a routed row."""
    G, _, M = out.shape
    routed = int((rows >= 0).sum())
    nbytes = (routed * M * out.element_size() + routed * 4 + rows.numel() * 4
              + G * rows.shape[1] * M * out.element_size())
    return roofline(nbytes, 2.0 * routed * M)


def check_combine(torch):
    """Phase 3: the combine kernel at ``COMBINE_SHAPES`` in bf16 and f32,
    each call under the sync-debug mode "error": forward bit-equal to its
    plain version; bit-equal to the scatter-add it replaced at top-1, at K
    > 1 within COMBINE_ATOL / COMBINE_RTOL of it summed in f32 (against the
    scatter-add in the activation dtype reported); unchanged with NaN in every
    row the map does not name; backward (the wrapper's torch ops) against
    autograd through the scatter-add on the routed rows within the same
    tolerance, 0 on the others.  Returns {"ragged_combine": the largest
    error against the plain version, "mesh ragged_combine": the mesh
    shapes'}."""
    from repro_torch.kernels.moe_dropless import combine
    from repro_torch.kernels.moe_dropless.ref import ragged_combine_ref

    errs = {"ragged_combine": 0.0, "mesh ragged_combine": 0.0}
    for i, (label, shape) in enumerate(COMBINE_SHAPES.items()):
        for dtype in (torch.bfloat16, torch.float32):
            out, gate, rows, token = combine_case(shape, 1700 + i, dtype)
            T, K = rows.shape[1:]
            name = (f"ragged_combine {label} {str(dtype)[6:]} (G={out.shape[0]}, "
                    f"R={out.shape[1]}, T={T}, K={K})")
            with no_sync(torch):
                y = combine.ragged_combine(out, gate, rows)
            torch.cuda.synchronize()
            plain = ragged_combine_ref(out, gate, rows)
            if not torch.equal(y, plain):
                check_close(f"{name} vs plain", y, plain)
                raise AssertionError(f"{name}: not bit-equal to its plain version")
            err = float((y.float() - plain.float()).abs().max())
            key = "mesh ragged_combine" if label.startswith("mesh") else "ragged_combine"
            errs[key] = max(errs[key], err)
            parent = scatter_add_combine(out, gate, token, T)
            if K == 1 and not torch.equal(y, parent):
                raise AssertionError(f"{name}: not bit-equal to the index_put_ scatter-add")
            check_close(f"{name} vs the index_put_ scatter-add summed in f32", y,
                        scatter_add_combine(out, gate, token, T, f32=True),
                        atol=COMBINE_ATOL, rtol=COMBINE_RTOL)
            log(f"    bit-equal to its plain version; "
                f"{float((y == parent).float().mean()):.4f} of the elements bit-equal to "
                f"the scatter-add's in {str(dtype)[6:]} (max abs err "
                f"{float((y.float() - parent.float()).abs().max()):.3g})")
            pad = (token < 0)[..., None]
            with no_sync(torch):
                y_nan = combine.ragged_combine(out.masked_fill(pad, float("nan")), gate, rows)
            if not torch.equal(y_nan, y):
                raise AssertionError(f"{name}: a NaN in an unrouted row reached y")
            grad = torch.randn_like(y)

            def grads(fn):
                o, g = out.detach().requires_grad_(True), gate.detach().requires_grad_(True)
                return torch.autograd.grad(fn(o, g), (o, g), grad)

            with no_sync(torch):
                d = [grads(lambda o, g: combine.ragged_combine(o, g, rows))]
            d.append(grads(lambda o, g: scatter_add_combine(o, g, token, T)))
            routed = token >= 0
            for what, a, b in (("d out", d[0][0], d[1][0]), ("d gate", d[0][1], d[1][1])):
                check_close(f"{name} backward {what} (routed rows) vs the scatter-add's",
                            a[routed], b[routed], atol=COMBINE_ATOL, rtol=COMBINE_RTOL)
                if not (a[~routed] == 0).all():
                    raise AssertionError(f"{name}: {what} not 0 on an unrouted row")
    return errs


def time_combine(torch, label, seed):
    """The combine kernel at ``COMBINE_SHAPES[label]`` (bf16): its time by
    CUDA events and by the profiler, its plain version's, the scatter-add it
    replaced (index_put_) and index_add_ as library yardsticks (events and
    device time), and its bound."""
    from repro_torch.kernels.moe_dropless import combine
    from repro_torch.kernels.moe_dropless.ref import ragged_combine_ref

    out, gate, rows, token = combine_case(COMBINE_SHAPES[label], seed)
    T = rows.shape[1]
    bound, by = combine_bound(out, rows)

    def kern():
        return combine.ragged_combine(out, gate, rows)

    def put():
        return scatter_add_combine(out, gate, token, T)

    def add():
        return index_add_combine(out, gate, token, T)

    check_close(f"index_add_ yardstick {label} (bf16 atomics) vs the kernel", add(), kern())
    return dict(ms=cuda_ms(kern), device_ms=device_ms(kern, bound_ms=bound),
                plain_ms=cuda_ms(lambda: ragged_combine_ref(out, gate, rows), reps=10),
                library_ms=cuda_ms(put), library_device_ms=device_ms(put, bound_ms=bound),
                index_add_ms=cuda_ms(add), index_add_device_ms=device_ms(add, bound_ms=bound),
                bound_ms=bound, bound_by=by, routed_rows=int((rows >= 0).sum()),
                shape=dict(zip(("G", "R", "T", "K", "M"), (*out.shape[:2], *rows.shape[1:],
                                                           out.shape[2]))))


def phase_timing_combine(torch):
    """Phase 4: the combine at every ``COMBINE_SHAPES`` shape;
    ``timing["ragged_combine"]`` is the decode step's (the JSON line)."""
    out = {f"ragged_combine {label}": time_combine(torch, label, 1750 + i)
           for i, label in enumerate(COMBINE_SHAPES)}
    for name, r in out.items():
        log(f"  {name} {r['shape']}: {timing_line(r)} (the index_put_ scatter-add it "
            f"replaced); index_add_ {r['index_add_ms']:.4f} ms (device "
            f"{fmt_ms(r['index_add_device_ms'])})")
    out["ragged_combine"] = out["ragged_combine decode"]
    return out


def ptxas_functions(report: str, pattern: str) -> dict:
    """{mangled kernel name: (registers, spill-store bytes)} from a ptxas -v
    report, for the kernels whose name holds ``pattern``."""
    out = {}
    for block in report.split("Compiling entry function '")[1:]:
        name = block.split("'", 1)[0]
        if pattern not in name:
            continue
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores", block)
        out[name] = (int(regs.group(1)) if regs else -1, int(spill.group(1)) if spill else 0)
    return out


# the tensor-core kernels of each library (a pattern of their mangled names)
TC_KERNELS = {"moe_ffn": "tc_pass_kernel", "ragged_ffn": "tc_ragged_pass_kernel",
              "flash_attention": "flash_tc_kernel"}


def check_sass(build) -> None:
    """Every tensor-core kernel (TC_KERNELS: the grouped FFN's
    ``tc_pass_kernel`` / ``tc_ragged_pass_kernel``, ``flash_tc_kernel``) must
    hold HGMMA (wgmma) instructions in its SASS; without cuobjdump on the
    machine this is logged as not checked."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        log("  SASS HGMMA check: not checked (no cuobjdump)")
        return
    for name, pattern in TC_KERNELS.items():
        sass = subprocess.run([tool, "-sass", str(build.library_path(name))],
                              capture_output=True, text=True, timeout=300, check=True).stdout
        counts = {}
        for block in sass.split("Function : ")[1:]:
            fn = block.split(None, 1)[0]
            if pattern in fn:
                counts[fn] = block.count("HGMMA")
        if not counts or min(counts.values()) == 0:
            raise AssertionError(f"{name}: tensor-core kernels without HGMMA in their SASS: "
                                 f"{[f for f, n in counts.items() if n == 0] or 'none found'}")
        log(f"  SASS HGMMA check, {name}: {len(counts)} tensor-core kernels, "
            f"{min(counts.values())}-{max(counts.values())} HGMMA instructions each")


# ---------------------------------------------------------------------------
# Inputs at the serving path's shapes
# ---------------------------------------------------------------------------

def attention_case(N, Hq, Hkv, D, bs, MB, lengths, seed, dtype=None):
    """Pools with a garbage block (last) and per-row block tables laid out
    like the engine's: each row's blocks distinct, the rest garbage."""
    import torch

    dtype = dtype or torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(seed)
    P = N * MB + 1
    kp = torch.randn((P, Hkv, bs, D), generator=g, device="cuda").to(dtype)
    vp = torch.randn((P, Hkv, bs, D), generator=g, device="cuda").to(dtype)
    q = torch.randn((N, Hq, D), generator=g, device="cuda").to(dtype)
    perm = torch.randperm(N * MB, generator=g, device="cuda").reshape(N, MB).int()
    lengths = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    used = torch.arange(MB, device="cuda")[None, :] * bs < lengths[:, None]
    tables = torch.where(used, perm, torch.full_like(perm, P - 1)).contiguous()
    return q, kp, vp, tables, lengths


def quantize_pools(kp, vp, name):
    """Per-(block, head) absmax int8/fp8 codes and f32 scales of two pools."""
    from repro_torch.quant import get_kv_quant

    pol = get_kv_quant(name)
    out = []
    for x in (kp, vp):
        x = x.float()
        s = x.abs().amax(dim=(2, 3)) / pol.qmax
        out += [pol.encode(x / s.clamp_min(1e-30)[:, :, None, None]).contiguous(),
                s.contiguous()]
    return out                                  # k_codes, k_scales, v_codes, v_scales


def quant_attention_case(N, Hq, Hkv, D, bs, MB, lengths, seed, name, dtype=None):
    """``attention_case`` with its pools quantized: (q, k_codes, v_codes,
    k_scales, v_scales, tables, lengths) in the wrapper's argument order."""
    q, kp, vp, tables, lengths = attention_case(N, Hq, Hkv, D, bs, MB, lengths, seed, dtype)
    kc, ks, vc, vs = quantize_pools(kp, vp, name)
    return q, kc, vc, ks, vs, tables, lengths


def dense_case(B, T, Hq, Hkv, D, lengths, seed, dtype=None, pad_t=0):
    """q (B, Hq, D) and a dense (B, T, Hkv, D) cache; with ``pad_t`` the
    cache is a T-long view of a longer buffer (strided along b)."""
    import torch

    dtype = dtype or torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, Hq, D), generator=g, device="cuda").to(dtype)
    k, v = (torch.randn((B, T + pad_t, Hkv, D), generator=g, device="cuda").to(dtype)[:, :T]
            for _ in range(2))
    return q, k, v, torch.tensor(lengths, dtype=torch.int32, device="cuda")


def ffn_case(n_choices, E, M, I, seed, act="gelu", bx=None, weights=None, groups=1,
             capacity=None, top_k=1):
    """Expert-sorted rows exactly as the dropless dispatcher builds them
    from a top-1 plan over random router logits, for ``groups`` routing
    groups of ``n_choices`` each (one launch over all groups' rows); with
    ``top_k``, a top-k plan over ``n_choices`` tokens (top_k choices each);
    with ``capacity``, from an expert-choice plan over ``n_choices`` tokens
    (its slot-major view: E segments of min(capacity, n_choices) rows)."""
    import torch

    from repro_torch.configs.base import MoEConfig
    from repro_torch.core.dispatch.dropless import plan_block_rows
    from repro_torch.core.routers.expert_choice import expert_choice_plan
    from repro_torch.core.routers.topk import topk_plan

    g = torch.Generator(device="cuda").manual_seed(seed)
    logits = torch.randn((groups, n_choices, E), generator=g, device="cuda")
    if capacity is None:
        plan = topk_plan(logits, MoEConfig(num_experts=E, top_k=top_k, aux_loss_coef=0.0),
                         n_choices)
    else:
        plan = expert_choice_plan(logits, MoEConfig(num_experts=E, routing="expert_choice"),
                                  capacity)
    bx = bx or plan_block_rows(plan)
    rag = plan.ragged(bx)
    x = torch.randn((groups, n_choices, M), generator=g, device="cuda").to(torch.bfloat16)
    tok = torch.clamp(rag.token, min=0).long()
    xs = torch.cat([x[i][tok[i]] for i in range(groups)]).contiguous()
    if weights is None:
        def w(*shape):
            return (torch.randn(shape, generator=g, device="cuda") * 0.02).to(torch.bfloat16)

        gated = act in ("swiglu", "geglu")
        weights = (w(E, M, I), w(E, M, I) if gated else None, w(E, I, M))
    be = rag.block_expert.reshape(-1).contiguous()
    return xs, be, weights, rag, bx


# ---------------------------------------------------------------------------
# Bounds (least time the card could take for the same work)
# ---------------------------------------------------------------------------

def roofline(nbytes: float, flops: float):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the flops over the bf16 tensor-core rate, the H100
    SXM's datasheet peaks (``repro_torch.distributed.roofline``)."""
    from repro_torch.distributed.roofline import kernel_bound

    return kernel_bound(nbytes, flops)


def attention_bound(q, kp, tables, lengths):
    N, Hq, D = q.shape
    Hkv = kp.shape[1]
    live = float(lengths.sum())
    nbytes = (2 * q.numel() * q.element_size()              # q read, out written
              + 2 * live * Hkv * D * kp.element_size()      # K and V of live positions
              + tables.numel() * 4 + lengths.numel() * 4)
    flops = 4.0 * Hq * D * live
    return roofline(nbytes, flops)


def quant_attention_bound(q, kc, tables, lengths):
    """q read and out written once; the codes of the live positions and one
    K and one V scale per live (block, head); the tables and lengths."""
    N, Hq, D = q.shape
    Hkv, bs = kc.shape[1], kc.shape[2]
    live = float(lengths.sum())
    blocks = float(((lengths + bs - 1) // bs).sum())
    nbytes = (2 * q.numel() * q.element_size() + 2 * live * Hkv * D
              + 2 * blocks * Hkv * 4 + tables.numel() * 4 + lengths.numel() * 4)
    return roofline(nbytes, 4.0 * Hq * D * live)


def dense_bound(q, k, lengths):
    """q read and out written once, the valid K/V rows once, the lengths."""
    B, Hq, D = q.shape
    Hkv = k.shape[2]
    live = float(lengths.clamp(max=k.shape[1]).sum())
    nbytes = (2 * q.numel() * q.element_size() + 2 * live * Hkv * D * k.element_size()
              + lengths.numel() * 4)
    return roofline(nbytes, 4.0 * Hq * D * live)


def ffn_bound(xs, be, weights, rag, bx):
    """Only what this layout's data needs: the live rows of x read and of
    the output written, and the weights of the routed experts.  Blocks
    past ``expert_offsets[E]`` hold no routed row: with the liveness the
    kernel skips them (writing their rows as 0), without it it computes
    them on expert E-1; either way they add neither rows nor an expert
    here."""
    import torch

    M = xs.shape[1]
    w_up, w_gate, w_down = weights
    I = w_up.shape[2]
    G, nb = rag.block_expert.shape                          # groups, row blocks a group
    blocks = torch.cat([g * nb + torch.arange(int(rag.expert_offsets[g, -1]) // bx,
                                              device=be.device) for g in range(G)])
    used = int(blocks.numel())                              # routed row blocks
    experts = int(be[blocks].unique().numel())              # distinct routed experts
    live = int((rag.token >= 0).sum())                      # real (token, choice) rows
    mats = 3 if w_gate is not None else 2
    nbytes = (2 * live * M * xs.element_size() + used * 4
              + experts * mats * M * I * w_up.element_size())
    flops = 2.0 * live * M * I * mats
    return roofline(nbytes, flops)


def moe_ffn_bound(x, w_up, w_gate):
    """Every expert's buffer is computed, so every expert's weights are
    read: x read and y written once, the weights once, 2 flops per
    multiply-add of the two (three if gated) matmuls."""
    E, X, M = x.shape
    I = w_up.shape[2]
    mats = 3 if w_gate is not None else 2
    nbytes = 2 * x.numel() * x.element_size() + mats * w_up.numel() * w_up.element_size()
    flops = 2.0 * E * X * M * I * mats
    return roofline(nbytes, flops)


def flash_bound(q, k, causal):
    """q, k, v read and o written once; QK^T and PV over the (causal: lower
    triangle including the diagonal) score entries."""
    B, S, Hq, D = q.shape
    nbytes = 2 * q.numel() * q.element_size() + 2 * k.numel() * k.element_size()
    pairs = S * (S + 1) / 2 if causal else S * S
    flops = 4.0 * B * Hq * D * pairs
    return roofline(nbytes, flops)


def moe_case(E, X, M, I, seed, act="gelu", dtype=None):
    """(E, X, M) capacity buffers and expert weights at 0.02 init scale."""
    import torch

    dtype = dtype or torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(seed)

    def w(*shape):
        return (torch.randn(shape, generator=g, device="cuda") * 0.02).to(dtype)

    x = torch.randn((E, X, M), generator=g, device="cuda").to(dtype)
    gated = act in ("swiglu", "geglu")
    return x, w(E, M, I), w(E, M, I) if gated else None, w(E, I, M)


def flash_case(B, S, Hq, Hkv, D, seed, dtype=None):
    import torch

    dtype = dtype or torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn((B, S, h, D), generator=g, device="cuda").to(dtype)
                 for h in (Hq, Hkv, Hkv))


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_check(torch):
    from repro_torch.kernels.decode_attention import ops as pda
    from repro_torch.kernels.decode_attention.ref import paged_decode_attention_ref
    from repro_torch.kernels.moe_dropless import ops as rffn
    from repro_torch.kernels.moe_dropless.ref import ragged_ffn_ref, ragged_ffn_split_ref

    log("phase 3: kernels against their plain versions")
    errs = {"paged_decode_attention": 0.0, "ragged_ffn": 0.0, "ragged_ffn split": 0.0}
    rng_lengths = [[40, 0, 17, 256, 1, 100, 16, 63],                       # N = 8
                   [37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52,
                    53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 66, 67, 68,
                    69, 70, 71, 72, 0, 0, 0, 0]]                           # N = 40
    for i, lens in enumerate(rng_lengths):
        case = attention_case(len(lens), 16, 16, 64, 16, 16, lens, seed=10 + i)
        out = pda.paged_decode_attention(*case)
        torch.cuda.synchronize()
        errs["paged_decode_attention"] = max(errs["paged_decode_attention"], check_close(
            f"paged_decode_attention N={len(lens)}", out, paged_decode_attention_ref(*case)))
        zero_rows = case[4] == 0
        if not (out[zero_rows] == 0).all():
            raise AssertionError("paged_decode_attention: a length-0 row is not exactly 0")
    # G > 1 (Hq=16 over Hkv=4), lengths ending mid-block, and an f32 run
    for dtype, name in ((torch.bfloat16, "G=4 bf16"), (torch.float32, "G=4 f32")):
        case = attention_case(6, 16, 4, 64, 16, 16, [5, 0, 31, 33, 200, 256],
                              seed=20, dtype=dtype)
        out = pda.paged_decode_attention(*case)
        check_close(f"paged_decode_attention {name}", out,
                    paged_decode_attention_ref(*case))

    def ragged(name, xs, be, weights, act, bx, tensor_cores=True, both=False, live=None,
               tile=0):
        """Without the liveness (and, with ``both``, on the CUDA-core route
        too), then (``live``: the layout's tags) with it at the
        dispatcher's tile; both into errs."""
        for tags in (None, live) if live is not None else (None,):
            err, split = check_ragged(torch, name, xs, be, weights, act, bx, tags,
                                      tile if tags is not None else 0, tensor_cores,
                                      both and tags is None)
            errs["ragged_ffn"] = max(errs["ragged_ffn"], err)
            if split is not None:
                errs["ragged_ffn split"] = max(errs["ragged_ffn split"], split)

    weights = None
    # phase 5's decode and mixed steps (8, 40 rows) and phase 10's (4, 20), bx = 8
    for n in (8, 40, 4, 20):
        xs, be, weights, rag, bx = ffn_case(n, 32, 1024, 4096, seed=30 + n, weights=weights)
        used = int(rag.expert_offsets[0, -1]) // bx
        log(f"  ragged_ffn n={n}: R={xs.shape[0]} rows, bx={bx}, "
            f"{used} expert blocks + {be.numel() - used} trailing padding blocks")
        ragged(f"n={n}", xs, be, weights, "gelu", bx, both=True, live=rag.token,
               tile=case_tile(n, 32, bx))
        if n == 8:
            # every block dead (a step with no routed row), every block live
            ragged("n=8, every block dead", xs, be, weights, "gelu", bx,
                   live=torch.full_like(rag.token, -1), tile=case_tile(n, 32, bx))
            ragged("n=8, every block live", xs, be, weights, "gelu", bx,
                   live=torch.zeros_like(rag.token), tile=case_tile(n, 32, bx))
    # the model drafter's full forward: 2 routing groups of 8 x 128 tokens
    # in one launch, the tile width the dispatcher picks for them
    xs, be, _, rag, bx = ffn_case(1024, 32, 1024, 4096, seed=150, weights=weights, groups=2)
    log(f"  ragged_ffn model drafter: R={xs.shape[0]} rows in 2 groups, bx={bx}")
    ragged("model drafter", xs, be, weights, "gelu", bx, live=rag.token,
           tile=case_tile(1024, 32, bx, groups=2))
    del xs, be, rag
    xs, be, w128, rag, bx = ffn_case(300, 8, 512, 1024, seed=50, bx=128)   # bx = 128
    ragged("bx=128", xs, be, w128, "gelu", bx, live=rag.token, tile=case_tile(300, 8, bx))
    xs, be, wsw, rag, bx = ffn_case(40, 8, 256, 512, seed=60, act="swiglu")
    tile = case_tile(40, 8, bx, gated=True)
    ragged("swiglu", xs, be, wsw, "swiglu", bx, live=rag.token, tile=tile)
    ragged("swiglu f32", xs.float(), be, [w.float() for w in wsw], "swiglu", bx,
           tensor_cores=False, live=rag.token, tile=tile)
    DISPATCH_SYNCS[:] = dispatch_syncs(torch, weights)
    errs.update(check_combine(torch))
    errs.update(check_training_kernels(torch))
    errs.update(check_decode_kernels(torch))
    for name, err in check_slo_step_kernels(torch).items():
        errs[name] = max(errs[name], err)
    check_paged_design(torch)
    check_dense_design(torch)
    for name, err in check_static_kernels(torch, weights).items():
        errs[name] = max(errs[name], err)
    for name, err in check_family_kernels(torch).items():
        errs[name] = max(errs[name], err)
        errs[f"family {name}"] = err
    for name, err in check_zamba_kernel(torch).items():
        errs[name] = max(errs[name], err)
        errs[f"zamba {name}"] = err
    for key, err in check_encdec_kernel(torch).items():
        errs[key] = err
        errs["decode_attention"] = max(errs["decode_attention"], err)
    for name, err in check_mesh_kernels(torch).items():
        errs[name] = max(errs.get(name, 0.0), err)
        errs[f"mesh {name}"] = err
    for name, err in check_mesh_train_kernels(torch).items():
        errs[name] = max(errs.get(name, 0.0), err)
        errs[f"mesh_train {name}"] = err
    for name, err in check_mesh_family_kernel(torch).items():
        errs[name] = max(errs.get(name, 0.0), err)
        errs[f"mesh_families {name}"] = err
    return errs, weights


def check_paged_design(torch):
    """The paged kernels' cases of their Hopper design (bulk copies into a
    ring of stages, a split over a thread-block cluster), for the bf16/f32
    kernel and the int8/fp8 one, each against its plain version at TOL with
    length-0 rows exactly 0: every splits in (1, 2, 4, 8) forced at the m6
    serving shape; a ring that wraps (bs 16, MB 64, a 1000-token row) at
    splits 1 and 2; f32 at G in (2, 4, 8) and D in
    (32, 128); and a garbage block (the table's entry past each length)
    filled with 1e4 / -1e4, which must not reach the output; one-position
    blocks, whose passes span more blocks than the ring holds."""
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.decode_attention.ref import (
        paged_decode_attention_ref,
        quantized_paged_decode_attention_ref,
    )
    from repro_torch.quant import get_kv_quant

    def run(label, case, fmt=None, splits=None):
        if fmt is None:
            out = da.paged_decode_attention(*case, splits=splits)
            want = paged_decode_attention_ref(*case)
            plan = da.launch_plan(case[0], case[1], case[3], splits)
        else:
            pol = get_kv_quant(fmt)
            out = da.quantized_paged_decode_attention(*case, policy=pol, splits=splits)
            want = quantized_paged_decode_attention_ref(*case, policy=pol)
            plan = da.launch_plan(case[0], case[1], case[5], splits)
        torch.cuda.synchronize()
        N, Hq, D = case[0].shape
        Hkv, bs = case[1].shape[1], case[1].shape[2]
        name = (f"{'paged' if fmt is None else fmt} {label} N={N} G={Hq // Hkv} D={D} bs={bs} "
                f"MB={case[-2].shape[1]} {str(case[0].dtype)[6:]} splits={plan[0]} "
                f"stages={plan[1]}")
        check_close(name, out, want)
        if not (out[case[-1] == 0] == 0).all():
            raise AssertionError(f"{name}: a length-0 row is not exactly 0")

    m6_lens = [40, 0, 17, 256, 1, 100, 16, 63]
    for splits in (1, 2, 4, 8):
        run("forced", attention_case(8, 16, 16, 64, 16, 16, m6_lens, seed=500), splits=splits)
        for fmt in ("int8", "fp8"):
            run("forced", quant_attention_case(8, 16, 16, 64, 16, 16, m6_lens, seed=501,
                                               name=fmt), fmt, splits=splits)
    wrap_lens = [1000, 0, 37]
    for splits in (1, 2):
        run("ring wraps", attention_case(3, 16, 16, 64, 16, 64, wrap_lens, seed=510),
            splits=splits)
        run("ring wraps", quant_attention_case(3, 16, 16, 64, 16, 64, wrap_lens, seed=511,
                                               name="int8"), "int8", splits=splits)
    # one-position blocks: a pass spans more blocks than the ring holds
    run("bs=1 ring wraps", attention_case(2, 4, 4, 32, 1, 64, [64, 37], seed=512))
    run("bs=1 ring wraps", quant_attention_case(2, 4, 4, 32, 1, 64, [64, 37], seed=513,
                                                name="int8"), "int8")
    lens = [5, 0, 31, 33, 200]
    for i, (Hq, Hkv, D) in enumerate(((16, 8, 32), (16, 4, 128), (16, 2, 128), (8, 1, 32))):
        run("f32", attention_case(5, Hq, Hkv, D, 16, 16, lens, seed=520 + i,
                                  dtype=torch.float32))
        run("f32", quant_attention_case(5, Hq, Hkv, D, 16, 16, lens, seed=530 + i,
                                        name=("int8", "fp8")[i % 2], dtype=torch.float32),
            ("int8", "fp8")[i % 2])
    q, kp, vp, tables, lengths = attention_case(8, 16, 16, 64, 16, 16, m6_lens, seed=540)
    kp[-1], vp[-1] = 1e4, -1e4                    # the garbage block: every table's tail
    run("garbage block", (q, kp, vp, tables, lengths))
    q, kc, vc, ks, vs, tables, lengths = quant_attention_case(8, 16, 16, 64, 16, 16, m6_lens,
                                                              seed=541, name="int8")
    kc[-1], vc[-1], ks[-1], vs[-1] = 127, -127, 1e4, 1e4
    run("garbage block", (q, kc, vc, ks, vs, tables, lengths), "int8")


def check_dense_design(torch):
    """The dense kernel's cases of its Hopper design (TMA boxes of a tensor
    map into a ring of stages, the first pass's issued before the length
    is read; a split over a thread-block cluster), against its plain version at TOL with
    length-0 rows exactly 0: every splits in (1, 2, 4, 8) forced at the m6
    shape (plan from T and from the longest length); a ring that wraps (a
    1000-position row of a 1024-position cache) at splits 1 and 2; f32 at
    G in (2, 4, 8) and D in (32, 128), and bf16 at D = 16; cache rows past
    every length filled with 1e4 / -1e4, which must not reach the output
    (the kernel fetches its first pass's tiles whatever the length)."""
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    def run(label, case, splits=None, max_length=None):
        q, k = case[0], case[1]
        out = da.decode_attention(*case, splits=splits, max_length=max_length)
        torch.cuda.synchronize()
        B, Hq, D = q.shape
        T, Hkv = k.shape[1], k.shape[2]
        plan = da.dense_plan(B, Hkv, Hq // Hkv, D, T, q.element_size(),
                             da._sm_count(q.device.index), splits, max_length)
        name = (f"dense {label} B={B} T={T} G={Hq // Hkv} D={D} {str(q.dtype)[6:]} "
                f"splits={plan[0]} stages={plan[1]}")
        check_close(name, out, decode_attention_ref(*case))
        if not (out[case[3] == 0] == 0).all():
            raise AssertionError(f"{name}: a length-0 row is not exactly 0")

    m6_lens = [40, 0, 17, 256, 1, 100, 16, 63]
    for splits in (1, 2, 4, 8):
        run("forced", dense_case(8, 256, 16, 16, 64, m6_lens, seed=600), splits=splits)
        run("forced, longest known", dense_case(8, 256, 16, 16, 64, m6_lens, seed=601),
            splits=splits, max_length=max(m6_lens))
    for splits in (1, 2):
        run("ring wraps", dense_case(3, 1024, 16, 16, 64, [1000, 0, 37], seed=610),
            splits=splits)
    lens = [5, 0, 31, 33, 200]
    for i, (Hq, Hkv, D) in enumerate(((16, 8, 32), (16, 4, 128), (16, 2, 128), (8, 1, 32))):
        run("f32", dense_case(5, 208, Hq, Hkv, D, lens, seed=620 + i, dtype=torch.float32))
    run("D=16", dense_case(5, 208, 16, 4, 16, lens, seed=630))
    q, k, v, lengths = dense_case(8, 256, 16, 16, 64, m6_lens, seed=640)
    past = torch.arange(256, device="cuda")[None, :] >= lengths[:, None]   # (B, T)
    k[past], v[past] = 1e4, -1e4
    for splits in (None, 1, 4):
        run("1e4 past the lengths", (q, k, v, lengths), splits=splits)


def check_training_kernels(torch):
    """The grouped-FFN kernel at the training path's capacity buffers (top-1:
    X = 45, 4 top-1: X = 180) and the reference's edge cases; the flash
    kernel at the m6 training shapes (S = 144, 256) and at non-power-of-two
    and ragged S, S = 1, Hkv < Hq, non-causal and f32, each on the route
    its type and width select, the tensor-core route also within one bf16
    ulp of its plain version (P as bf16 hi + lo)."""
    from repro_torch.kernels.common import flash_tensor_core_route
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref, attention_split_ref
    from repro_torch.kernels.moe_ffn import ops as mf
    from repro_torch.kernels.moe_ffn.ref import moe_ffn_ref, moe_ffn_split_ref

    def moe(name, case, act, tensor_cores=True, both=False):
        return check_routed(
            f"moe_ffn {name}", mf.moe_ffn, lambda *a: mf.moe_ffn(*a, act), case,
            lambda *a: moe_ffn_ref(*a, act), lambda *a: moe_ffn_split_ref(*a, act), tensor_cores,
            on_cuda_cores(mf, lambda *a: mf.moe_ffn(*a, act)) if both else None)

    errs = {"moe_ffn": 0.0, "moe_ffn split": 0.0}
    for X in (45, 180):
        case = moe_case(32, X, 1024, 4096, seed=90 + X)
        err, split = moe(f"E=32 X={X}", case, "gelu", both=True)
        errs["moe_ffn"] = max(errs["moe_ffn"], err)
        errs["moe_ffn split"] = max(errs["moe_ffn split"], split)
        del case
    # the CUDA-core route (f32; I % 8 != 0 in bf16 and f32) and the
    # tensor-core route's tiles (one N = 128 tile of X = 100; two of 192;
    # three gated tiles of 128; one gated tile of 128 under geglu)
    for E, X, M, I, act, dt, tc in ((1, 100, 64, 40, "swiglu", torch.float32, False),
                                    (2, 100, 64, 96, "gelu", torch.bfloat16, True),
                                    (3, 13, 128, 44, "relu", torch.float32, False),
                                    (3, 13, 128, 44, "relu", torch.bfloat16, False),
                                    (2, 300, 64, 128, "gelu", torch.bfloat16, True),
                                    (4, 300, 256, 512, "swiglu", torch.bfloat16, True),
                                    (3, 128, 128, 256, "geglu", torch.bfloat16, True)):
        case = moe_case(E, X, M, I, seed=E + X + I, act=act, dtype=dt)
        moe(f"E={E} X={X} M={M} I={I} {act} {str(dt)[6:]}", case, act, tc)
    # flash: the m6 training shape (both routes compared), the CUDA-core
    # route (f32; D = 16, 32), and the tensor-core route's edges: D = 128
    # with Hkv < Hq, S = 1, a ragged S = 17, the longest m6 S = 256
    for B, S, Hq, Hkv, D, causal, dt in ((8, 144, 16, 16, 64, True, torch.bfloat16),
                                         (2, 80, 4, 1, 128, False, torch.float32),
                                         (1, 96, 8, 1, 16, True, torch.float32),
                                         (2, 96, 4, 2, 32, False, torch.bfloat16),
                                         (2, 80, 8, 2, 128, False, torch.bfloat16),
                                         (2, 1, 4, 2, 64, True, torch.bfloat16),
                                         (2, 17, 4, 4, 64, False, torch.bfloat16),
                                         (8, 256, 16, 16, 64, True, torch.bfloat16)):
        q, k, v = flash_case(B, S, Hq, Hkv, D, seed=S + D)
        q, k, v = q.to(dt), k.to(dt), v.to(dt)
        tc = flash_tensor_core_route(dt, D)

        def flash(q, k, v, causal=causal):
            return fa.flash_attention(q, k, v, causal=causal)

        err, split = check_routed(
            f"flash_attention B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} "
            f"{'causal' if causal else 'full'} {str(dt)[6:]}", fa.flash_attention, flash,
            (q, k, v), lambda *a: attention_ref(*a, causal),
            lambda *a: attention_split_ref(*a, causal), tc,
            on_cuda_cores(fa, flash, "flash_tensor_core_route") if S == 144 else None,
            split="split-P")
        if S == 144:
            errs["flash_attention"], errs["flash_attention split"] = err, split
    return errs


def check_decode_kernels(torch):
    """The quantized paged kernel (int8 and fp8 codes) at the m6 serving
    shape with bf16 q, and with f32 q at G = 2, 4 and 8 and D = 32 and 128;
    the dense kernel at tests/test_kernels.py's DECODE_CASES shapes and the
    m6 shape (read as a strided view); length-0 rows exactly 0 in both; and
    quant_write_kv's codes and scales on the card against the CPU's."""
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_ref,
        quantized_paged_decode_attention_ref,
    )
    from repro_torch.quant import get_kv_quant, quant_write_kv

    errs = {"quantized_paged_decode_attention": 0.0, "decode_attention": 0.0}
    m6_lens = [40, 0, 17, 256, 1, 100, 16, 63]
    cases = [("int8", (8, 16, 16, 64, 16, 16, m6_lens), None),
             ("fp8", (8, 16, 16, 64, 16, 16, m6_lens), None),
             ("int8", (40, 16, 16, 64, 16, 16, list(range(17, 49)) + [0] * 8), None),
             ("int8", (6, 16, 8, 64, 16, 16, [5, 0, 31, 33, 200, 256]), torch.float32),
             ("fp8", (6, 16, 4, 64, 16, 16, [5, 0, 31, 33, 200, 256]), torch.float32),
             ("fp8", (3, 16, 2, 128, 16, 8, [0, 77, 128]), torch.float32),
             ("int8", (4, 4, 4, 32, 8, 8, [0, 9, 64, 3]), torch.float32)]
    for i, (name, shape, dt) in enumerate(cases):
        case = quant_attention_case(*shape, seed=200 + i, name=name, dtype=dt)
        pol = get_kv_quant(name)
        out = da.quantized_paged_decode_attention(*case, policy=pol)
        torch.cuda.synchronize()
        N, Hq, Hkv, D = shape[:4]
        label = (f"quantized_paged_decode_attention {name} N={N} G={Hq // Hkv} D={D} "
                 f"bs={shape[4]} {str(case[0].dtype)[6:]}")
        err = check_close(label, out, quantized_paged_decode_attention_ref(*case, policy=pol))
        if case[0].dtype == torch.bfloat16:
            errs["quantized_paged_decode_attention"] = max(
                errs["quantized_paged_decode_attention"], err)
        if not (out[case[6] == 0] == 0).all():
            raise AssertionError(f"{label}: a length-0 row is not exactly 0")

    dense = [(2, 128, 8, 2, 32, torch.float32), (1, 96, 4, 4, 16, torch.float32),
             (3, 256, 8, 1, 64, torch.bfloat16), (2, 80, 2, 2, 128, torch.float32),
             (8, 256, 16, 16, 64, torch.bfloat16)]
    for i, (B, T, Hq, Hkv, D, dt) in enumerate(dense):
        g = torch.Generator().manual_seed(300 + i)
        lens = torch.randint(1, T + 1, (B,), generator=g).tolist()
        if B > 1:
            lens[0], lens[-1] = 0, T
        case = dense_case(B, T, Hq, Hkv, D, lens, seed=300 + i, dtype=dt,
                          pad_t=44 if B == 8 else 0)
        out = da.decode_attention(*case)
        torch.cuda.synchronize()
        label = f"decode_attention B={B} T={T} Hq={Hq} Hkv={Hkv} D={D} {str(dt)[6:]}"
        err = check_close(label, out, decode_attention_ref(*case))
        if B == 8:
            errs["decode_attention"] = err
        if B > 1 and not (out[0] == 0).all():
            raise AssertionError(f"{label}: the length-0 row is not exactly 0")

    # quant_write_kv: engine-like writes (a 32-row chunk over three blocks,
    # decode rows, masked rows into the garbage block) at m6 widths
    g = torch.Generator().manual_seed(400)
    P, Hkv, bs, D = 12, 16, 16, 64
    for name in ("int8", "fp8"):
        pol = get_kv_quant(name)
        dev = [torch.zeros((P, Hkv, bs, D), dtype=torch.int8, device="cuda"),
               torch.zeros((P, Hkv), device="cuda")]
        cpu = [t.cpu() for t in dev]
        for step in range(6):
            wb = torch.tensor([step % 3] * 2 + [3 + step // 2, 4 + (step + 1) // 2, 11, 11],
                              dtype=torch.int32)
            wo = torch.tensor([(2 * step) % bs, (2 * step + 1) % bs, (5 * step) % bs,
                               (3 * step + 1) % bs, 0, 0], dtype=torch.int32)
            x = torch.randn((6, Hkv, D), generator=g) * (1 + 10 * step)
            x[5] = x[4]                                  # masked rows carry one value
            quant_write_kv(*dev, x.cuda(), wb.cuda(), wo.cuda(), policy=pol)
            quant_write_kv(*cpu, x, wb, wo, policy=pol)
        torch.cuda.synchronize()
        if not (torch.equal(dev[0].cpu(), cpu[0])
                and torch.equal(dev[1].cpu().view(torch.int32), cpu[1].view(torch.int32))):
            raise AssertionError(f"quant_write_kv {name}: codes or scales on the card "
                                 f"differ from the CPU's")
        log(f"  quant_write_kv {name}: codes and scale bits on the card equal the CPU's "
            f"after 6 steps")
    return errs


def slo_step_case(slot_lens, chunk, seed, name=None):
    """Attention inputs of one phase 10 engine step at m6 widths (Hq = Hkv =
    16, D = 64, 16-token blocks): a row per slot over a pool of the cell's
    28 blocks and the garbage block (last), each slot's table 7 blocks wide
    (the trace's longest request, 104 tokens), its entries past the slot's
    context the garbage block; with ``chunk`` = (slot, start, n), the
    step's 16 chunk rows after them, of lengths start + 1 .. start + n and
    0 for the rest, sharing that slot's table.  bf16 pools, or their
    int8/fp8 codes and scales (``name``); (q, pools..., tables, lengths)
    in the wrapper's order."""
    import torch

    S, bs = SLO_SERVE["max_slots"], SLO_SERVE["kv_block_size"]
    P, MB, Hkv, D = SLO_SERVE["num_blocks"] + 1, 7, 16, 64
    g = torch.Generator(device="cuda").manual_seed(seed)
    kp, vp = (torch.randn((P, Hkv, bs, D), generator=g, device="cuda").to(torch.bfloat16)
              for _ in range(2))
    held, lens = list(slot_lens), list(slot_lens)
    if chunk is not None:
        s, start, n = chunk
        held[s] = max(held[s], start + n)
        lens += [start + j + 1 if j < n else 0 for j in range(SLO_SERVE["prefill_chunk"])]
    perm = torch.randperm(P - 1, generator=g, device="cuda").reshape(S, MB).int()
    used = (torch.arange(MB, device="cuda")[None, :] * bs
            < torch.tensor(held, device="cuda")[:, None])
    tables = torch.where(used, perm, torch.full_like(perm, P - 1))
    if chunk is not None:
        tables = torch.cat([tables, tables[s].expand(len(lens) - S, MB)])
    q = torch.randn((len(lens), Hkv, D), generator=g, device="cuda").to(torch.bfloat16)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    if name is None:
        return q, kp, vp, tables.contiguous(), lengths
    kc, ks, vc, vs = quantize_pools(kp, vp, name)
    return q, kc, vc, ks, vs, tables.contiguous(), lengths


def check_slo_step_kernels(torch):
    """The paged kernel over bf16 pools and the quantized one over int8 and
    fp8 pools at phase 10's step shapes (``slo_step_case``): 4-row decode
    steps, one with an empty slot, and 20-row mixed steps (4 slot rows and
    a 16-token chunk, one of them a partial first chunk), each with the
    plan the engine's launch gets (from static shapes: the table's width),
    against the plain version at TOL; length-0 rows exactly 0.  Returns
    each kernel's max abs err."""
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.decode_attention.ref import (
        paged_decode_attention_ref,
        quantized_paged_decode_attention_ref,
    )
    from repro_torch.quant import get_kv_quant

    steps = [([104, 1, 37, 80], None), ([0, 64, 16, 99], None),
             ([73, 0, 104, 20], (1, 32, 16)), ([50, 90, 0, 3], (2, 0, 9))]
    errs = {"paged_decode_attention": 0.0, "quantized_paged_decode_attention": 0.0}
    for i, (slot_lens, chunk) in enumerate(steps):
        for name in (None, "int8", "fp8"):
            case = slo_step_case(slot_lens, chunk, seed=500 + i, name=name)
            q, pool, tables, lengths = case[0], case[1], case[-2], case[-1]
            longest = int(lengths.max())
            plan = da.launch_plan(q, pool, tables)
            if name is None:
                kernel = "paged_decode_attention"
                out = da.paged_decode_attention(*case)
                want = paged_decode_attention_ref(*case)
            else:
                kernel, pol = "quantized_paged_decode_attention", get_kv_quant(name)
                out = da.quantized_paged_decode_attention(*case, policy=pol)
                want = quantized_paged_decode_attention_ref(*case, policy=pol)
            torch.cuda.synchronize()
            label = (f"{kernel} {name or 'bf16'} phase 10 {'mixed' if chunk else 'decode'} "
                     f"step N={q.shape[0]} longest {longest} (splits, stages) {plan}")
            errs[kernel] = max(errs[kernel], check_close(label, out, want))
            if not (out[lengths == 0] == 0).all():
                raise AssertionError(f"{label}: a length-0 row is not exactly 0")
    return errs


def step_plan_splits(q, pool, tables, longest: int) -> int:
    """The cluster split ``split_plan`` picks for a paged call when the
    step's longest row is known on the host (the plan before the static
    one): timed beside the static plan, launched with that split forced
    (its stages then the static plan's for that split)."""
    from repro_torch.kernels.decode_attention import ops as da

    N, Hq, D = q.shape
    _, Hkv, bs, _ = pool.shape
    return da.split_plan(N, Hkv, Hq // Hkv, D, bs, tables.shape[1], pool.element_size(),
                         da._sm_count(q.device.index), max_length=longest)[0]


def time_quantized(torch, lens, seed, name="int8", heads=(16, 16, 64)):
    """Kernel, plain and dequantize-then-SDPA times for one quantized paged
    attention call at the m6 decode shape (``heads`` = (Hq, Hkv, D); 16
    rotating copies)."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.decode_attention.ref import quantized_paged_decode_attention_ref
    from repro_torch.quant import get_kv_quant

    pol = get_kv_quant(name)
    copies = [quant_attention_case(len(lens), *heads, 16, 16, lens, seed=seed + c,
                                   name=name) for c in range(16)]
    it = iter(range(1 << 30))

    def nxt():
        return copies[next(it) % len(copies)]

    def kern():                                   # the engine's plan: static shapes
        return da.quantized_paged_decode_attention(*nxt(), policy=pol)

    q, kc, vc, ks, vs, tables, lengths = copies[0]
    step_splits = step_plan_splits(q, kc, tables, max(lens))

    def kern_step():                              # the split of the step's longest row
        return da.quantized_paged_decode_attention(*nxt(), policy=pol, splits=step_splits)

    bound, by = quant_attention_bound(q, kc, tables, lengths)
    k_ms, k_dev = cuda_ms(kern), device_ms(kern, bound_ms=bound)
    step_dev = device_ms(kern_step, bound_ms=bound)
    p_ms = cuda_ms(lambda: quantized_paged_decode_attention_ref(*nxt(), policy=pol))
    N, Hq, D = q.shape
    Hkv, bs, MB = kc.shape[1], kc.shape[2], tables.shape[1]
    tbl = tables.long()
    mask = (torch.arange(MB * bs, device="cuda")[None, :] < lengths[:, None])[:, None, None, :]

    def dequant_sdpa():
        k = (pol.decode(kc[tbl]) * ks[tbl][..., None, None]).to(q.dtype)
        v = (pol.decode(vc[tbl]) * vs[tbl][..., None, None]).to(q.dtype)
        k = k.permute(0, 2, 1, 3, 4).reshape(N, Hkv, MB * bs, D)
        v = v.permute(0, 2, 1, 3, 4).reshape(N, Hkv, MB * bs, D)
        return F.scaled_dot_product_attention(q[:, :, None, :], k, v, attn_mask=mask,
                                              enable_gqa=Hq != Hkv)

    lib_ms, lib_dev = cuda_ms(dequant_sdpa), device_ms(dequant_sdpa, bound_ms=bound)
    return dict(ms=k_ms, device_ms=k_dev, plain_ms=p_ms, library_ms=lib_ms,
                library_device_ms=lib_dev, bound_ms=bound, bound_by=by,
                plan=da.launch_plan(q, kc, tables), step_plan_device_ms=step_dev,
                step_plan=da.launch_plan(q, kc, tables, step_splits))


def dense_sdpa(q, k, v, lengths):
    """SDPA with a length mask over the dense cache read in place (its
    (B, Hkv, T, D) view): the library call for dense decode."""
    import torch
    import torch.nn.functional as F

    T = k.shape[1]
    mask = (torch.arange(T, device=k.device)[None, :] < lengths[:, None])[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(q[:, :, None, :], k.transpose(1, 2),
                                                  v.transpose(1, 2), attn_mask=mask,
                                                  enable_gqa=q.shape[1] != k.shape[2])


def time_dense(torch, lens, seed, T=256, heads=(16, 16, 64), softcap=0.0):
    """Kernel, plain and SDPA (length mask) times for one dense decode call
    at the m6 shape (``heads`` = (Hq, Hkv, D)), B = len(lens), 16 rotating
    copies.  The kernel is timed as every path calls it since PR 33, at the
    static plan (from T: the lengths stay on the card), and beside it at the
    plan of the longest length the host knew before (``per_length_*``; the
    same launch where the two plans agree).  ``softcap`` caps the kernel's
    and the plain version's scores (SDPA has no cap: its time is the
    uncapped call's)."""
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    Hq, Hkv, D = heads
    copies = [dense_case(len(lens), T, Hq, Hkv, D, lens, seed=seed + c) for c in range(16)]
    it = iter(range(1 << 30))

    def nxt():
        return copies[next(it) % len(copies)]

    def kern(max_length=None):
        return da.decode_attention(*nxt(), max_length=max_length, softcap=softcap)

    q, k, v, lengths = copies[0]
    bound, by = dense_bound(q, k, lengths)
    k_ms, k_dev = cuda_ms(kern), device_ms(kern, bound_ms=bound)
    p_ms = cuda_ms(lambda: decode_attention_ref(*nxt(), softcap=softcap))
    sdpa = dense_sdpa(q, k, v, lengths)
    plan, per_length = (da.dense_plan(len(lens), Hkv, Hq // Hkv, D, T, 2, da._sm_count(0),
                                      max_length=m) for m in (None, max(lens)))
    out = dict(ms=k_ms, device_ms=k_dev, plain_ms=p_ms, library_ms=cuda_ms(sdpa),
               library_device_ms=device_ms(sdpa, bound_ms=bound), bound_ms=bound, bound_by=by,
               plan=plan, per_length_plan=per_length, per_length_ms=k_ms,
               per_length_device_ms=k_dev)
    if per_length != plan:
        longest = functools.partial(kern, max(lens))
        out.update(per_length_ms=cuda_ms(longest),
                   per_length_device_ms=device_ms(longest, bound_ms=bound))
    return out


def time_attention(torch, lens, seed, heads=(16, 16, 64)):
    """Kernel, plain and SDPA times for one attention call (``heads`` =
    (Hq, Hkv, D)); 16 rotating copies of the pools (> 50 MB L2 at 40 rows)
    so launches read cold."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import ops as pda
    from repro_torch.kernels.decode_attention.ref import paged_decode_attention_ref

    copies = [attention_case(len(lens), *heads, 16, 16, lens, seed=seed + c)
              for c in range(16)]
    it = iter(range(1 << 30))

    def nxt():
        return copies[next(it) % len(copies)]

    def kern():                                   # the engine's plan: static shapes
        return pda.paged_decode_attention(*nxt())

    q, kp, vp, tables, lengths = copies[0]
    step_splits = step_plan_splits(q, kp, tables, max(lens))

    def kern_step():                              # the split of the step's longest row
        return pda.paged_decode_attention(*nxt(), splits=step_splits)

    bound, by = attention_bound(q, kp, tables, lengths)
    k_ms, k_dev = cuda_ms(kern), device_ms(kern, bound_ms=bound)
    step_dev = device_ms(kern_step, bound_ms=bound)
    p_ms = cuda_ms(lambda: paged_decode_attention_ref(*nxt()))
    N, Hq, D = q.shape
    Hkv, bs, MB = kp.shape[1], kp.shape[2], tables.shape[1]
    kk = kp[tables.long()].permute(0, 2, 1, 3, 4).reshape(N, Hkv, MB * bs, D)
    vv = vp[tables.long()].permute(0, 2, 1, 3, 4).reshape(N, Hkv, MB * bs, D)
    mask = (torch.arange(MB * bs, device="cuda")[None, :] < lengths[:, None])[:, None, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(q[:, :, None, :], kk, vv, attn_mask=mask,
                                              enable_gqa=Hq != Hkv)

    kernels = sorted(profiled_kernels(sdpa, 4), key=lambda e: -e.self_device_time_total)
    log(f"  SDPA at N={N} launches: " + "; ".join(
        f"{e.key[:90]} ({e.self_device_time_total / 4e3:.5f} ms)" for e in kernels))
    return dict(ms=k_ms, device_ms=k_dev, plain_ms=p_ms, library_ms=cuda_ms(sdpa),
                library_device_ms=device_ms(sdpa, bound_ms=bound), bound_ms=bound, bound_by=by,
                plan=pda.launch_plan(q, kp, tables), step_plan_device_ms=step_dev,
                step_plan=pda.launch_plan(q, kp, tables, step_splits))


def time_splits(torch, decode_lens, seed=120):
    """Device time of the paged (bf16), int8 and dense kernels at 8 rows of
    256 positions and at the decode step's lengths, for the wrapper's own
    splits (the paged kernels' from static shapes, as the continuous engine
    launches them; the dense kernel's given the longest length, as the
    static engine gives it) and for each
    of (1, 2, 4, 8) forced, over 16 rotating copies, with the splits and
    stages of each launch, and SDPA's device time on the dense cache beside
    the dense kernel's: {label: {kernel: [(splits, stages, chosen, device
    ms), ...], "decode_attention sdpa": ms, "decode_attention bound": ms}}."""
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.quant import get_kv_quant

    pol = get_kv_quant("int8")
    sms = da._sm_count(0)
    out = {}
    for label, lens in (("8 rows x 256 positions", [256] * 8), ("decode (N=8)", decode_lens)):
        bf = [attention_case(8, 16, 16, 64, 16, 16, lens, seed=seed + c) for c in range(16)]
        i8 = [quant_attention_case(8, 16, 16, 64, 16, 16, lens, seed=seed + c, name="int8")
              for c in range(16)]
        dn = [dense_case(8, 256, 16, 16, 64, lens, seed=seed + c) for c in range(16)]
        longest = max(lens)                       # as the static engine passes it
        kernels = {"paged_decode_attention": (
                       bf, lambda c, s: da.paged_decode_attention(*c, splits=s),
                       lambda c, s: da.launch_plan(c[0], c[1], c[3], s),
                       attention_bound(bf[0][0], bf[0][1], bf[0][3], bf[0][4])[0]),
                   "quantized_paged_decode_attention int8": (
                       i8, lambda c, s: da.quantized_paged_decode_attention(
                           *c, policy=pol, splits=s),
                       lambda c, s: da.launch_plan(c[0], c[1], c[5], s),
                       quant_attention_bound(i8[0][0], i8[0][1], i8[0][5], i8[0][6])[0]),
                   "decode_attention": (
                       dn, lambda c, s: da.decode_attention(*c, splits=s, max_length=longest),
                       lambda c, s: da.dense_plan(8, 16, 1, 64, 256, 2, sms, s, longest),
                       dense_bound(dn[0][0], dn[0][1], dn[0][3])[0])}
        out[label] = {}
        for name, (copies, call, plan, bound) in kernels.items():
            rows = []
            for forced in (None, 1, 2, 4, 8):
                it = iter(range(1 << 30))

                def fn():
                    return call(copies[next(it) % 16], forced)

                cuda_ms(fn, reps=100)                 # warm, as phase 4's other timings
                ms = device_ms(fn, bound_ms=bound)
                splits, stages = plan(copies[0], forced)
                rows.append((splits, stages, forced is None, ms))
                log(f"  {label} {name}: splits {splits}{' (chosen)' if forced is None else ''}"
                    f", stages {stages}: device {fmt_ms(ms)} ms")
            out[label][name] = rows
        sdpa = dense_sdpa(*dn[0])
        cuda_ms(sdpa, reps=100)
        out[label]["decode_attention bound"] = kernels["decode_attention"][3]
        out[label]["decode_attention sdpa"] = device_ms(
            sdpa, bound_ms=out[label]["decode_attention bound"])
        log(f"  {label} decode_attention: SDPA (length mask) device "
            f"{fmt_ms(out[label]['decode_attention sdpa'])} ms, bound "
            f"{out[label]['decode_attention bound']:.5f} ms")
        del bf, i8, dn
    return out


def pass_ms(torch, fn, reps: int = 10, bound_ms=None) -> dict:
    """Device time of each pass of the tensor-core grouped FFN in one call
    of ``fn`` (torch.profiler, the median of the complete sessions):
    {"list": ms, "up": ms, "down": ms}, from the kernels
    ``tc_pass_kernel<N, KIND>`` / ``tc_ragged_pass_kernel<N, KIND>`` (KIND
    0, 1: the up pass; 2: the down pass) and the ragged FFN's prologue
    ``work_list_kernel``; None where no session was complete."""
    per = []
    for ev in complete_sessions(fn, reps, bound_ms=bound_ms):
        out = {"list": 0.0, "up": 0.0, "down": 0.0}
        for e in ev:
            m = re.search(r"tc_(?:ragged_)?pass_kernel<\d+, (\d)>", e.key)
            if m:
                out["down" if m.group(1) == "2" else "up"] += e.self_device_time_total / 1e3 / reps
            elif "work_list_kernel" in e.key:
                out["list"] += e.self_device_time_total / 1e3 / reps
        per.append(out)
    return {k: sorted(p[k] for p in per)[len(per) // 2] if per else None
            for k in ("list", "up", "down")}


def time_ffn(torch, n, seed, weights, groups=1, capacity=None,
             shape=(32, 1024, 4096, "gelu", 1)):
    """Kernel, plain and grouped_mm times for one ragged FFN call at the
    dispatcher's layout for ``n`` routed choices over 32 experts (in each
    of ``groups`` routing groups; with ``capacity``, expert choice's
    slot-major layout over ``n`` tokens); ``shape`` = (E, M, I, activation,
    top_k), top_k > 1 routing ``n`` tokens top_k ways.  The kernel as the
    dispatcher calls it (the liveness, its tile) and without the liveness
    (every block computed, one block a tile)."""
    import torch.nn.functional as F

    from repro_torch.kernels.moe_dropless import ops as rffn
    from repro_torch.kernels.moe_dropless.ref import ragged_ffn_ref

    E, M, I, act, top_k = shape
    xs, be, weights, rag, bx = ffn_case(n, E, M, I, seed=seed, act=act, weights=weights,
                                        groups=groups, capacity=capacity, top_k=top_k)
    tile = case_tile(n, E, bx, act == "swiglu", capacity=capacity, top_k=top_k, groups=groups)

    def kern():                       # as the dispatcher calls it
        return rffn.ragged_ffn(xs, be, *weights, act, block_x=bx, live=rag.token, tile=tile)

    def kern_all():                   # without the liveness: every block computed
        return rffn.ragged_ffn(xs, be, *weights, act, block_x=bx)

    bound, by = ffn_bound(xs, be, weights, rag, bx)
    k_ms, k_dev = cuda_ms(kern), device_ms(kern, bound_ms=bound)
    all_ms, all_dev = cuda_ms(kern_all), device_ms(kern_all, bound_ms=bound)
    cc_ms = cuda_ms(on_cuda_cores(rffn, kern))
    p_ms = cuda_ms(lambda: ragged_ffn_ref(xs, be, *weights, act, rag.token), reps=5)
    lib_ms = lib_dev = None
    offs = rag.expert_offsets[0, 1:].contiguous()
    w_up, w_gate, w_down = weights
    try:
        if groups > 1:
            raise ValueError(f"one set of expert offsets, the launch holds {groups} groups")

        def grouped():
            h = F.grouped_mm(xs, w_up, offs=offs)
            if act == "swiglu":
                h = F.silu(F.grouped_mm(xs, w_gate, offs=offs)) * h
            else:
                h = F.gelu(h, approximate="tanh")
            return F.grouped_mm(h, w_down, offs=offs)

        live = int(offs[-1])
        ref = ragged_ffn_ref(xs, be, *weights, act)
        if (grouped()[:live].float() - ref[:live].float()).abs().max() <= TOL * 4:
            lib_ms, lib_dev = cuda_ms(grouped), device_ms(grouped, bound_ms=bound)
        else:
            log("  grouped_mm yardstick disagrees with the plain version: not timed")
    except (RuntimeError, TypeError, ValueError) as exc:
        log(f"  grouped_mm does not take these shapes ({type(exc).__name__}: "
            f"{str(exc).splitlines()[0][:160]}): library_ms null")
    return dict(ms=k_ms, device_ms=k_dev, plain_ms=p_ms, library_ms=lib_ms,
                library_device_ms=lib_dev, bound_ms=bound, bound_by=by, cuda_core_ms=cc_ms,
                pass_ms=pass_ms(torch, kern, bound_ms=bound), tile=tile,
                without_liveness_ms=all_ms, without_liveness_device_ms=all_dev)


def time_moe_ffn(torch, X, seed, shape=(32, 1024, 4096, "gelu")):
    """Kernel, plain and bf16 torch.bmm times for one grouped FFN call on
    the capacity buffers of one layer, ``shape`` = (E, M, I, activation):
    m6-base's by default (E = 32, M = 1024, I = 4096, gelu: the weights are
    537 MB, far above the 50 MB L2, so every launch reads them cold)."""
    import torch.nn.functional as F

    from repro_torch.kernels.moe_ffn import ops as mf
    from repro_torch.kernels.moe_ffn.ref import moe_ffn_ref

    E, M, I, act = shape
    x, w_up, w_gate, w_down = moe_case(E, X, M, I, seed=seed, act=act)

    def kern():
        return mf.moe_ffn(x, w_up, w_gate, w_down, act)

    def bmm():
        h = torch.bmm(x, w_up)
        if act == "swiglu":
            h = F.silu(torch.bmm(x, w_gate)) * h
        else:
            h = F.gelu(h, approximate="tanh")
        return torch.bmm(h, w_down)

    k_ms = cuda_ms(kern, reps=10)
    cc_ms = cuda_ms(on_cuda_cores(mf, kern), reps=5)
    p_ms = cuda_ms(lambda: moe_ffn_ref(x, w_up, w_gate, w_down, act), reps=5)
    lib_ms = cuda_ms(bmm, reps=10)
    bound, by = moe_ffn_bound(x, w_up, w_gate)
    return dict(ms=k_ms, device_ms=device_ms(kern, reps=10, bound_ms=bound), plain_ms=p_ms,
                library_ms=lib_ms, library_device_ms=device_ms(bmm, reps=10, bound_ms=bound),
                bound_ms=bound, bound_by=by, cuda_core_ms=cc_ms,
                pass_ms=pass_ms(torch, kern, bound_ms=bound))


def time_flash(torch, B, S, H, D, seed, copies=16):
    """One causal attention call at an m6 training shape, all in this call:
    the tensor-core kernel (the wrapper's route), the CUDA-core kernel, the
    plain version and SDPA, each by CUDA events over back-to-back calls and
    (but the plain version) by the profiler's device time.  The calls
    rotate over ``copies`` sets of inputs (16 x 7.1 MB at S = 144, more
    than the 50 MB L2), so each reads its inputs from device memory, as
    the bound counts them; the kernel's and SDPA's device times on one set
    read again and again (from L2) are kept beside them as ``warm``."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref

    sets = [flash_case(B, S, H, H, D, seed=seed + c) for c in range(copies)]
    it = iter(range(1 << 30))

    def nxt():
        return sets[next(it) % copies]

    def kern(qkv=None):
        q, k, v = qkv or nxt()
        return fa.flash_attention(q, k, v, causal=True)

    def sdpa(qkv=None):
        q, k, v = qkv or nxt()
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2), is_causal=True)

    cc = on_cuda_cores(fa, kern, "flash_tensor_core_route")
    bound, by = flash_bound(*sets[0][:2], True)
    out = dict(ms=cuda_ms(kern), device_ms=device_ms(kern, bound_ms=bound),
               cuda_core_ms=cuda_ms(cc), cuda_core_device_ms=device_ms(cc, bound_ms=bound),
               plain_ms=cuda_ms(lambda: attention_ref(*nxt(), True)),
               library_ms=cuda_ms(sdpa), library_device_ms=device_ms(sdpa, bound_ms=bound),
               warm_device_ms=device_ms(lambda: kern(sets[0])),
               library_warm_device_ms=device_ms(lambda: sdpa(sets[0])))
    kernels = sorted(profiled_kernels(sdpa, 4), key=lambda e: -e.self_device_time_total)
    log(f"  SDPA at S={S} launches: " + "; ".join(
        f"{e.key[:90]} ({e.self_device_time_total / 4e3:.5f} ms)" for e in kernels))
    out["bound_ms"], out["bound_by"] = bound, by
    return out


def phase_timing_training(torch):
    """The training kernels at the training path's shapes: the grouped FFN
    at X = 45 (top-1, the JSON line) and X = 180 (4 top-1), flash at B = 8,
    H = 16, D = 64, S = 144 (the JSON line) and S = 256 (the learned
    positions' limit)."""
    out = {"moe_ffn": time_moe_ffn(torch, 45, seed=100),
           "moe_ffn X=180": time_moe_ffn(torch, 180, seed=101),
           "flash_attention": time_flash(torch, 8, 144, 16, 64, seed=102),
           "flash_attention S=256": time_flash(torch, 8, 256, 16, 64, seed=103)}
    for name, r in out.items():
        log(f"  train {name}: {timing_line(r)}")
        if "warm_device_ms" in r:
            log(f"    inputs read again from L2 (warm): kernel {fmt_ms(r['warm_device_ms'])} ms, "
                f"library {fmt_ms(r['library_warm_device_ms'])} ms (device)")
    return out


def fmt_ms(x) -> str:
    return "not measured" if x is None else f"{x:.5f}"


def plan_line(r) -> str:
    """A dense decode timing's two plans (``time_dense``)."""
    return (f"static plan (splits, stages) {r['plan']} dev {fmt_ms(r['device_ms'])} ms against "
            f"the per-length plan {r['per_length_plan']} dev {fmt_ms(r['per_length_device_ms'])} "
            f"ms")


def timing_line(r) -> str:
    """A kernel's times: CUDA events over back-to-back calls (which at a
    few microseconds a call read the host's launch rate) and the
    profiler's device time, for the kernel, its CUDA-core route where it
    has one, the plain version and the library call, and the bound."""
    cc = ""
    if "cuda_core_ms" in r:
        cc = f", CUDA-core route {r['cuda_core_ms']:.4f} ms"
        if "cuda_core_device_ms" in r:
            cc += f" (device {fmt_ms(r['cuda_core_device_ms'])})"
    if "pass_ms" in r:
        cc += (f", passes {fmt_ms(r['pass_ms']['up'])} + {fmt_ms(r['pass_ms']['down'])} ms "
               f"(device)")
        if r["pass_ms"].get("list"):
            cc += f" after the work list's {fmt_ms(r['pass_ms']['list'])}"
    if "without_liveness_ms" in r:
        cc += (f", tile {r['tile']}; without the liveness {r['without_liveness_ms']:.4f} ms "
               f"(device {fmt_ms(r['without_liveness_device_ms'])})")
    if "plan" in r:
        cc += f", splits {r['plan'][0]}, stages {r['plan'][1]}"
    if "step_plan" in r:
        cc += (f" (the step's longest row's split, splits {r['step_plan'][0]}, stages "
               f"{r['step_plan'][1]}: device {fmt_ms(r['step_plan_device_ms'])} ms)")
    lib = "null" if r["library_ms"] is None else (f"{r['library_ms']:.4f} ms (device "
                                                  f"{fmt_ms(r['library_device_ms'])})")
    return (f"kernel {r['ms']:.4f} ms (device {fmt_ms(r['device_ms'])}){cc}, plain "
            f"{r['plain_ms']:.4f} ms, library {lib}, bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']})")


def phase_timing(torch, ffn_weights):
    """The serving kernels at the decode step's shapes (8 rows: the JSON
    line) and at the mixed step's (8 decode rows + a 32-row prefill chunk);
    at the decode shape also the quantized kernel over fp8 codes and the
    dense-cache kernel (8 sequences of a 256-position cache)."""
    log("phase 4: timing")
    decode_lens = [21, 56, 112, 9, 74, 33, 98, 47]
    mixed_lens = decode_lens + list(range(17, 49))        # chunk rows of one prompt
    shapes = {"decode (N=8)": (decode_lens, 8), "mixed (N=40)": (mixed_lens, 40)}
    out = {}
    for label, (lens, n) in shapes.items():
        out[label] = {"paged_decode_attention": time_attention(torch, lens, seed=70),
                      "ragged_ffn": time_ffn(torch, n, seed=80, weights=ffn_weights),
                      "quantized_paged_decode_attention": time_quantized(torch, lens, seed=90)}
    out["decode (N=8)"]["quantized_paged_decode_attention fp8"] = time_quantized(
        torch, decode_lens, seed=90, name="fp8")
    out["decode (N=8)"]["decode_attention"] = time_dense(torch, decode_lens, seed=110)
    for label, res in out.items():
        for name, r in res.items():
            log(f"  {label} {name}: {timing_line(r)}")
    out["decode (N=8)"]["splits"] = time_splits(torch, decode_lens)
    return out["decode (N=8)"], out["mixed (N=40)"]


def static_shapes():
    """Phase 11's new kernel shapes: the dense cache of the static trace
    run (T, and its median decode length, every row at it) and of the
    equal-length batch."""
    from repro_torch.serving.trace import synthetic_trace

    T, lens = static_decode_shapes(synthetic_trace(16, 21128, seed=0))
    return {"trace": (T, sorted(lens)[len(lens) // 2]),
            "batch": (STATIC_PROMPT + STATIC_GEN + 1, STATIC_PROMPT + STATIC_GEN // 2)}


def check_static_kernels(torch, weights):
    """Phase 11's new shapes against the plain versions at TOL (and the
    split ones): the grouped FFN at X = 1 (a static decode step of 8 rows
    at capacity 1.25) and X = 15 (its 8 x 48 prefill), the ragged FFN at
    the static prefill's 384 rows and at expert choice's slot-major layout
    (1152 tokens at capacity 45: 32 full segments of 45 rows), and the
    dense decode kernel at the static engine's caches with every row at one
    length, against its plain and split-and-merge versions."""
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_ref,
        decode_attention_split_ref,
    )
    from repro_torch.kernels.moe_dropless import ops as rffn
    from repro_torch.kernels.moe_dropless.ref import ragged_ffn_ref, ragged_ffn_split_ref
    from repro_torch.kernels.moe_ffn import ops as mf
    from repro_torch.kernels.moe_ffn.ref import moe_ffn_ref, moe_ffn_split_ref

    errs = {}

    def keep(name, err, split):
        errs[name] = max(errs.get(name, 0.0), err)
        errs[f"{name} split"] = max(errs.get(f"{name} split", 0.0), split)

    for X in (1, 15):
        case = moe_case(32, X, 1024, 4096, seed=140 + X)
        keep("moe_ffn", *check_routed(
            f"moe_ffn static E=32 X={X}", mf.moe_ffn, lambda *a: mf.moe_ffn(*a, "gelu"), case,
            lambda *a: moe_ffn_ref(*a, "gelu"), lambda *a: moe_ffn_split_ref(*a, "gelu"), True))
    for label, n, capacity in (("static prefill", 384, None), ("expert choice", 1152, 45)):
        xs, be, _, rag, bx = ffn_case(n, 32, 1024, 4096, seed=145, weights=weights,
                                      capacity=capacity)
        log(f"  ragged_ffn {label}: R={xs.shape[0]} rows, bx={bx}, "
            f"{int((rag.token >= 0).sum())} routed")
        for live in (None, rag.token):       # without the liveness, then as the dispatcher
            keep("ragged_ffn", *check_ragged(torch, label, xs, be, weights, "gelu", bx, live,
                                             case_tile(n, 32, bx, capacity=capacity)
                                             if live is not None else 0))
    for label, (T, length) in static_shapes().items():
        case = dense_case(8, T, 16, 16, 64, [length] * 8, seed=150 + T)
        for max_length in (None, length):       # the engine's static plan, the per-length one
            out = da.decode_attention(*case, max_length=max_length)
            torch.cuda.synchronize()
            splits, stages = da.dense_plan(8, 16, 1, 64, T, 2, da._sm_count(0),
                                           max_length=max_length)
            name = (f"decode_attention static {label} B=8 T={T} length {length} "
                    f"{'static' if max_length is None else 'per-length'} plan splits={splits}")
            err = check_close(name, out, decode_attention_ref(*case))
            check_close(f"{name} vs split plain", out, decode_attention_split_ref(*case, splits))
            errs["decode_attention"] = max(errs.get("decode_attention", 0.0), err)
    return errs


def phase_timing_static(torch, ffn_weights):
    """Phase 11's kernel shapes: the grouped FFN at X = 1 and 15, the ragged
    FFN at the static prefill and the expert-choice layout, the dense
    kernel at the static trace's cache (its median decode length)."""
    T, length = static_shapes()["trace"]
    out = {"moe_ffn X=1": time_moe_ffn(torch, 1, seed=160),
           "moe_ffn X=15": time_moe_ffn(torch, 15, seed=161),
           "ragged_ffn static prefill": time_ffn(torch, 384, seed=162, weights=ffn_weights),
           "ragged_ffn expert choice": time_ffn(torch, 1152, seed=163, weights=ffn_weights,
                                                capacity=45),
           "decode_attention static": time_dense(torch, [length] * 8, seed=164, T=T)}
    for name, r in out.items():
        log(f"  static {name}: {timing_line(r)}")
    log(f"  static decode_attention static: {plan_line(out['decode_attention static'])}")
    return out


def remeasure(torch, timing, ffn_weights):
    """The device times of the kernels this PR's shared-header change could
    move (the ragged and grouped FFN and flash include sm90.cuh) and of
    the dense decode kernel, measured again on the same inputs as phase 4's
    first measurement: {name: (first, again, again / first)}."""
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.moe_dropless import ops as rffn
    from repro_torch.kernels.moe_ffn import ops as mf

    xs, be, weights, rag, bx = ffn_case(8, 32, 1024, 4096, seed=80, weights=ffn_weights)
    x, w_up, _, w_down = moe_case(32, 45, 1024, 4096, seed=100)
    sets = [flash_case(8, 144, 16, 16, 64, seed=102 + c) for c in range(16)]
    dense = [dense_case(8, 256, 16, 16, 64, [21, 56, 112, 9, 74, 33, 98, 47], seed=110 + c)
             for c in range(16)]
    it = iter(range(1 << 30))
    calls = {
        "ragged_ffn": (lambda: rffn.ragged_ffn(xs, be, *weights, "gelu", block_x=bx,
                                               live=rag.token, tile=case_tile(8, 32, bx)), 20),
        "moe_ffn": (lambda: mf.moe_ffn(x, w_up, None, w_down, "gelu"), 10),
        "flash_attention": (lambda: fa.flash_attention(*sets[next(it) % 16], causal=True), 20),
        "decode_attention": (lambda: da.decode_attention(*dense[next(it) % 16],
                                                         max_length=112), 20),
    }
    out = {}
    for name, (fn, reps) in calls.items():
        cuda_ms(fn, reps=reps)                        # warm, as in phase 4
        ms = device_ms(fn, reps=reps, bound_ms=timing[name]["bound_ms"])
        first = timing[name]["device_ms"]
        ratio = ms / first if ms and first else None
        out[name] = (first, ms, ratio)
        log(f"  re-measure {name}: device {fmt_ms(first)} ms in phase 4, {fmt_ms(ms)} ms again"
            f" ({'not measured' if ratio is None else f'{ratio:.4f}x'})")
    return out


@contextmanager
def plain_versions():
    """Route the forward through the kernels' plain PyTorch versions."""
    from unittest import mock

    from repro_torch.core.dispatch import dropless
    from repro_torch.kernels.decode_attention import ops as pda
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_ref,
        paged_decode_attention_ref,
        quantized_paged_decode_attention_ref,
    )
    from repro_torch.kernels.moe_dropless import ops as rffn
    from repro_torch.kernels.moe_dropless.ref import ragged_combine_ref, ragged_ffn_ref

    import repro_torch.kernels.decode_attention as da_pkg
    import repro_torch.kernels.flash_attention as fa_pkg
    import repro_torch.kernels.moe_ffn as mf_pkg
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.moe_ffn.ref import moe_ffn_ref

    def plain_ffn(x, be, up, gate, down, activation="swiglu", block_x=128, live=None, tile=0):
        return ragged_ffn_ref(x, be, up, gate, down, activation, live)

    def plain_paged(*args):
        return paged_decode_attention_ref(*args)

    def plain_quantized(*args, policy):
        return quantized_paged_decode_attention_ref(*args, policy=policy)

    def plain_dense(*args, splits=None, max_length=None, softcap=0.0):
        return decode_attention_ref(*args, softcap=softcap)

    with mock.patch.object(pda, "paged_decode_attention", plain_paged), \
            mock.patch.object(pda, "quantized_paged_decode_attention", plain_quantized), \
            mock.patch.object(da_pkg, "decode_attention", plain_dense), \
            mock.patch.object(rffn, "ragged_ffn", plain_ffn), \
            mock.patch.object(dropless, "ragged_combine", ragged_combine_ref), \
            mock.patch.object(mf_pkg, "moe_ffn", moe_ffn_ref), \
            mock.patch.object(fa_pkg, "flash_attention", attention_ref):
        yield


@contextmanager
def parent_combine():
    """The dispatchers' combine as it ran before the kernel: the index_put_
    scatter-add (``scatter_add_combine``; a row the map does not name adds
    its gate-0 product into token 0), to profile beside the kernel in one
    run."""
    from unittest import mock

    from repro_torch.core.dispatch import dropless
    from repro_torch.kernels.moe_dropless.ref import row_tokens

    def scatter(out, gate, rows):
        return scatter_add_combine(out, gate, row_tokens(rows, out.shape[1]), rows.shape[1])

    with mock.patch.object(dropless, "ragged_combine", scatter):
        yield


def phase_serve(torch):
    from repro_torch.configs.base import ServeConfig
    from repro_torch.configs.m6 import M6_BASE
    from repro_torch.kernels.decode_attention import ops as pda
    from repro_torch.kernels.moe_dropless import combine
    from repro_torch.kernels.moe_dropless import ops as rffn
    from repro_torch.nn import count_params, init_params
    from repro_torch.serving.continuous import ContinuousEngine
    from repro_torch.serving.request import Request
    from repro_torch.serving.trace import latency_line, synthetic_trace

    log("phase 5: m6-base continuous serving, 16 requests")
    cfg = M6_BASE.replace_moe(impl="dropless", capacity_factor=None)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"  {count_params(cfg) / 1e9:.3f} B params, random init in "
        f"{time.perf_counter() - t0:.1f} s")
    requests = synthetic_trace(16, cfg.vocab_size, seed=0)
    serve = ServeConfig(max_len=max(256, max(r.total_len for r in requests)))

    # warm-up on throwaway engines, graphed and eager (first cuBLAS/allocator calls)
    for graphs in (True, False):
        warm = ContinuousEngine(cfg, params, serve, device="cuda", graphs=graphs)
        warm.run([Request(uid=0, prompt=requests[0].prompt, max_new_tokens=3)])

    engine = ContinuousEngine(cfg, params, serve, device="cuda")
    pda.paged_decode_attention.launches = 0
    rffn.ragged_ffn.launches = rffn.ragged_ffn.tc_launches = 0
    combine.ragged_combine.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    STEP_CLOCKS["bf16"] = []                                    # phase 16 replays them
    with recorded_clocks(STEP_CLOCKS["bf16"]):
        out, stats = engine.run(requests)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = {"paged_decode_attention": pda.paged_decode_attention.launches,
                "ragged_ffn": rffn.ragged_ffn.launches,
                "ragged_combine": combine.ragged_combine.launches}
    if rffn.ragged_ffn.tc_launches != launches["ragged_ffn"]:
        raise AssertionError(f"ragged_ffn: {rffn.ragged_ffn.tc_launches} of "
                             f"{launches['ragged_ffn']} launches on the tensor-core route")

    steps = engine.steps
    for r in requests:
        if len(out[r.uid]) != r.max_new_tokens:
            raise AssertionError(f"request {r.uid}: {len(out[r.uid])} tokens, "
                                 f"budget {r.max_new_tokens}")
    if stats["moe_dropped_fraction"] != 0.0:
        raise AssertionError(f"moe_dropped_fraction {stats['moe_dropped_fraction']} != 0.0")
    want = cfg.num_layers * steps
    for name, n in launches.items():
        if n != want:
            raise AssertionError(f"{name}: {n} launches, expected layers x steps = {want}")
    log(f"  {latency_line(stats)}")
    log(f"  {steps} steps, mean step {wall_ms / steps:.3f} ms (host clock, run wall "
        f"{wall_ms:.1f} ms); launches {launches} = {cfg.num_layers} layers x {steps} steps; "
        f"dropped fraction {stats['moe_dropped_fraction']}")
    e2e = dict(tokens_per_s=stats["generated_tokens_per_s"], p50_ms=stats["p50_ms"],
               p95_ms=stats["p95_ms"], mean_step_ms=wall_ms / steps, steps=steps,
               census=check_census(engine, "phase 5"), graph_pool_bytes=engine.graph_pool_bytes,
               graph_bytes={k: f.graph_bytes for k, f in engine._forms.items()})
    log(f"  compiled step: {e2e['census']}; forms {sorted(engine._forms)} captured as CUDA "
        f"graphs, their pool {engine.graph_pool_bytes / 2**20:.2f} MiB "
        f"({', '.join(f'{k} {v / 2**20:.2f}' for k, v in e2e['graph_bytes'].items())} MiB)")

    # the same trace through the eager forms, timed alike
    eager = ContinuousEngine(cfg, params, serve, device="cuda", graphs=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, estats = eager.run(requests)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3
    e2e["eager"] = dict(tokens_per_s=estats["generated_tokens_per_s"], p50_ms=estats["p50_ms"],
                        p95_ms=estats["p95_ms"], mean_step_ms=eager_ms / eager.steps,
                        steps=eager.steps, census=check_census(eager, "phase 5 eager"))
    log(f"  eager forms (graphs=False): {latency_line(estats)}; {eager.steps} steps, mean step "
        f"{eager_ms / eager.steps:.3f} ms (host clock); graphed {wall_ms / steps:.3f} ms")
    e2e["graphed_vs_eager"] = graphed_vs_eager(torch, cfg, params, serve, requests,
                                               STEP_CLOCKS["bf16"], out)

    e2e.update(profile_steps(torch, cfg, params, serve, requests))
    e2e["device_busy_share_cuda_only"] = profile_steps(
        torch, cfg, params, serve, requests, cpu=False)["device_busy_share"]
    log("  the same profile over the eager forms:")
    e2e["eager_profile"] = profile_steps(torch, cfg, params, serve, requests, cpu=False,
                                         graphs=False)
    log("  the eager profile with the index_put_ scatter-add in place of the combine kernel:")
    with parent_combine():
        parent = profile_steps(torch, cfg, params, serve, requests, cpu=False, graphs=False)
    e2e["scatter_add_profile"] = parent
    if e2e["eager_profile"].get("profiled_device_ms") and parent.get("profiled_device_ms"):
        per = [r["profiled_device_ms"] / r["profiled_steps"] for r in (e2e["eager_profile"],
                                                                          parent)]
        log(f"  busy device ms a step (eager forms): {per[0]:.4f} with the combine kernel, "
            f"{per[1]:.4f} with the scatter-add")
    compare_mixed_step(torch, cfg, params, serve, requests)
    return launches, e2e, out


# the serving kernels as CUPTI names them: (part of the kernel's name, its
# launches a wrapper launch, the (wrapper, counter) pairs that count them)
CUPTI_KERNELS = (
    ("decode_kernel", 1, (("decode_attention", "launches"), ("paged_decode_attention", "launches"),
                          ("quantized_paged_decode_attention", "launches"))),
    ("work_list_kernel", 1, (("ragged_ffn", "tc_launches"),)),
    ("tc_ragged_pass_kernel", 2, (("ragged_ffn", "tc_launches"),)),
    ("combine_kernel", 1, (("ragged_combine", "launches"),)),
)


def recorded_vs_counted(kernels) -> dict:
    """{kernel name part: (launches CUPTI recorded, launches the wrappers'
    counters say)} over one profiled session, the counters set to 0 at its
    start."""
    wrappers = kernel_wrappers()
    return {part: (sum(e.count for e in kernels if part in e.key),
                   per * sum(getattr(wrappers[w], attr) for w, attr in counted))
            for part, per, counted in CUPTI_KERNELS}


def profile_steps(torch, cfg, params, serve, requests, n_steps=24, cpu=True, graphs=True):
    """torch.profiler over engine steps of the trace's first 8 requests,
    all admitted at once (the step forms captured as CUDA graphs unless
    ``graphs`` is false, the graphs' kernels recorded from their replays):
    device busy share (kernel time over wall time)
    and the kernels that take the device time.  Every launch counter is set
    to 0 just before the profiled steps; over the graphed forms (whose
    counters add a capture's launches at each replay) the paged decode,
    work-list, ragged-pass and combine kernels CUPTI recorded must equal
    what the counters say, so that a replay's count is measured; over the
    eager forms (counted where each wrapper launches) a difference is
    logged as records CUPTI lost.  It records the CPU's
    activity beside the card's, as phases 5 and 7 always have (the
    recording lengthens the wall time the share divides by); with ``cpu``
    false the CUDA activity alone, all that the share reads, as phase 12
    takes it (recording the CPU's made the profiler's processing of
    granite's 32-layer steps the largest cost of that phase).  Phase 5
    takes both, so that the two series can be set side by side."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import counters
    from repro_torch.serving.continuous import ContinuousEngine
    from repro_torch.serving.request import Request

    eng = ContinuousEngine(cfg, params, serve, device="cuda", graphs=graphs)
    for r in requests[:8]:
        eng.scheduler.add(Request(uid=r.uid, prompt=r.prompt,
                                  max_new_tokens=r.max_new_tokens))
    for _ in range(2):
        eng.step()
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]
    counters.write((0,) * len(counters.COUNTED))
    with profile(activities=activities) as prof:
        open_session(torch)
        t0 = time.perf_counter()
        n = 0
        while n < n_steps and eng.scheduler.has_work():
            eng.step()
            n += 1
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # Device kernels (and copies) only: an aten op's own device time is that
    # of the kernels it launched, which are listed again as their own events.
    kernels = device_events(prof)

    def dev_us(e):
        return float(e.self_device_time_total)

    check_census(eng, "profiled steps")
    busy_us = sum(dev_us(e) for e in kernels)
    if busy_us <= 0.0:
        log("  profiler: no device time recorded; device busy share not measured")
        return {"device_busy_share": None}
    want = cfg.num_layers * n          # a step's paged launches: one an attention layer
    seen = recorded_vs_counted(kernels)
    decode = seen["decode_kernel"][0]
    off = {k: v for k, v in seen.items() if v[0] != v[1]}
    if graphs and (off or not decode):
        raise AssertionError(f"profiled graphed steps: kernels CUPTI recorded against those the "
                             f"replays counted: {seen}")
    if off:
        log(f"  profiler: CUPTI lost records (recorded, counted): {off}; the busy share below "
            f"misses their device time")
    log(f"  profiler: kernels recorded = counted over the profiled steps (from 0): "
        f"{ {k: v[0] for k, v in seen.items() if k not in off} }")
    log(f"  profiler ({'CPU and ' * cpu}CUDA activity, {'graphed' if graphs else 'eager'} "
        f"forms; {decode} of {want} paged kernels recorded) over {n} steps: device busy "
        f"{busy_us / 1e3:.2f} ms of {wall_us / 1e3:.2f} ms wall ({busy_us / wall_us:.1%} busy; "
        f"kernels and copies)")
    for e in sorted(kernels, key=dev_us, reverse=True)[:10]:
        log(f"    {dev_us(e) / 1e3:8.3f} ms  {e.count:6d} x  {e.key[:110]}")
    combine = [e for e in kernels if "combine_kernel" in e.key]
    combine_ms = sum(dev_us(e) for e in combine) / 1e3
    if combine:
        log(f"    the dropless combine (ragged_combine.cu): {combine_ms:.3f} ms of device time "
            f"in {sum(e.count for e in combine)} calls (phase 5's 120 calls took 16.82 ms as "
            f"the index_put_ scatter-add, H100 80GB HBM3 at 700 W)")
    return {"device_busy_share": busy_us / wall_us, "profiled_steps": n,
            "profiled_wall_ms": wall_us / 1e3, "profiled_device_ms": busy_us / 1e3,
            "combine_device_ms": combine_ms, "combine_calls": sum(e.count for e in combine),
            "graphs": graphs, "paged_kernels_recorded": decode, "paged_kernels_launched": want,
            "recorded_vs_counted": seen}


def graphed_vs_eager(torch, cfg, params, serve, requests, clocks, run_tokens, device="cuda"):
    """Phase 5: the graphed step forms and the eager ones (``graphs=False``)
    in lockstep over the graphed run's step clocks (the same admissions, so
    the same rows at every step), each through ``logit_tap``.  The greedy
    tokens must be identical, to each other and to the graphed run's; the
    largest logit difference over the live rows is reported (0 expected:
    the same kernels on the same inputs)."""
    import numpy as np

    from repro_torch.serving.continuous import ContinuousEngine

    V = cfg.vocab_size
    last = {}

    def tap_of(graphs):
        def tap(lg, slots, pos, lens):
            last[graphs] = (lg, lens)
        return tap

    engines = {g: ContinuousEngine(cfg, params, serve, device=device, graphs=g,
                                   logit_tap=tap_of(g)) for g in (True, False)}
    out = {g: {} for g in engines}
    for eng in engines.values():
        for r in requests:
            eng.scheduler.add(r)
    diff, rows, steps = 0.0, 0, 0
    for clock in clocks:
        last.clear()
        for g, eng in engines.items():
            for st in eng.step(clock):
                out[g][st.request.uid] = list(st.generated)
        (a, lens), (b, _) = last[True], last[False]
        live = lens > 0
        diff = max(diff, float(np.abs(a[live, :V] - b[live, :V]).max(initial=0.0)))
        rows += int(live.sum())
        steps += 1
    for g, eng in engines.items():
        label = f"phase 5 lockstep, {'graphed' if g else 'eager'}"
        if eng.scheduler.has_work() or len(out[g]) != len(requests):
            raise AssertionError(f"{label}: {len(out[g])} of {len(requests)} requests done")
        check_census(eng, label)
    if device == "cuda" and not all(f.graph is not None for f in engines[True]._forms.values()):
        raise AssertionError("phase 5 lockstep: a graphed engine's form was not captured")
    bad = sorted(u for u in out[True] if out[True][u] != out[False][u])
    if bad:
        raise AssertionError(f"graphed and eager greedy tokens differ for requests {bad}")
    if out[True] != run_tokens:
        raise AssertionError("the lockstep graphed tokens differ from the graphed run's at the "
                             "same clocks")
    log(f"  graphed vs eager forms in lockstep over {steps} steps ({rows} live rows): greedy "
        f"tokens identical (and to the graphed run's); max abs logit diff {diff:.6g}")
    return dict(steps=steps, live_rows=rows, max_abs_logit_diff=diff, tokens_identical=True)


def profile_static(torch, cfg, params, prompts, gen, cpu=True, graphs=True):
    """torch.profiler over one static ``generate`` (a prefill, or the
    prompt token by token, and gen - 1 decode steps) of an engine whose
    forms a first ``generate`` of the same shape built (on the card,
    captured unless ``graphs`` is false): ``busy_share``, the launch
    counters set to 0 just before; over the graphed forms the kernels
    CUPTI recorded must equal the counters'."""
    from repro_torch.serving.engine import ServingEngine

    eng = ServingEngine(cfg, params, max_len=prompts.shape[1] + gen + 1, graphs=graphs)
    eng.generate(prompts, gen)
    steps = (prompts.shape[1] if eng.fam.prefill is None else 1) + gen - 1
    out = busy_share(torch, lambda: eng.generate(prompts, gen),
                     f"one static generate of {prompts.shape[0]} x {prompts.shape[1]}, {gen} "
                     f"tokens ({'graphed' if graphs else 'eager'} forms)", cpu,
                     counted=True, graphs=graphs)
    out.update(graphs=graphs, steps=steps)
    if out["device_busy_share"] is not None:
        out["device_ms_a_step"] = out["profiled_device_ms"] / steps
        out["wall_ms_a_step"] = out["profiled_wall_ms"] / steps
    return out


def busy_share(torch, run, what, cpu=True, counted=False, graphs=False):
    """torch.profiler over ``run()``: device busy share and the kernels that
    take the device time, as ``profile_steps`` reads them for the
    continuous engine (with ``cpu`` false from the CUDA activity alone).
    With ``counted`` the launch counters are set to 0 just before ``run``,
    and the decode, work-list, ragged-pass and combine kernels CUPTI
    recorded are set beside the counters' (``recorded_vs_counted``): equal
    or the run fails over ``graphs`` (replays, whose counts add the
    capture's launches), a difference logged as records CUPTI lost over
    eager launches."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import counters

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]
    if counted:
        counters.write((0,) * len(counters.COUNTED))
    with profile(activities=activities) as prof:
        open_session(torch)
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = device_events(prof)

    def dev_us(e):
        return float(e.self_device_time_total)

    busy_us = sum(dev_us(e) for e in kernels)
    if busy_us <= 0.0:
        log("  profiler: no device time recorded; device busy share not measured")
        return {"device_busy_share": None}
    out = {"device_busy_share": busy_us / wall_us, "profiled_wall_ms": wall_us / 1e3,
           "profiled_device_ms": busy_us / 1e3}
    if counted:
        seen = recorded_vs_counted(kernels)
        off = {k: v for k, v in seen.items() if v[0] != v[1]}
        if graphs and off:
            raise AssertionError(f"profiled graphed {what}: kernels CUPTI recorded against "
                                 f"those the replays counted: {seen}")
        if off:
            log(f"  profiler: CUPTI lost records (recorded, counted): {off}")
        log(f"  profiler: kernels recorded = counted (from 0): "
            f"{ {k: v[0] for k, v in seen.items() if k not in off} }")
        out["recorded_vs_counted"] = seen
    log(f"  profiler ({'CPU and ' * cpu}CUDA activity) over {what}: device busy "
        f"{busy_us / 1e3:.2f} ms of {wall_us / 1e3:.2f} ms wall ({busy_us / wall_us:.1%} busy)")
    for e in sorted(kernels, key=dev_us, reverse=True)[:8]:
        log(f"    {dev_us(e) / 1e3:8.3f} ms  {e.count:6d} x  {e.key[:110]}")
    return out


def expert_choice_routes(x, router_w, plan):
    """An expert-choice plan's routes, per token: the set of experts that
    picked it (a bit mask over E <= 62 experts) and its log-score gap to the
    far side of the nearest expert's selection boundary (the c-th and
    (c+1)-th scores of that expert), which a perturbation must close to
    move the token in or out."""
    import torch

    logs = torch.log_softmax(x.float() @ router_w.float(), dim=-1)     # (G, T, E)
    G, T, E = logs.shape
    c = plan.token_at_slot.shape[-1]
    ranked = logs.transpose(1, 2).sort(dim=-1, descending=True).values  # (G, E, T)
    last_in = ranked[..., c - 1][:, None, :]
    first_out = (ranked[..., c] if c < T
                 else torch.full_like(ranked[..., 0], -math.inf))[:, None, :]
    picked = plan.valid
    gap = torch.where(picked, logs - first_out, last_in - logs)
    mask = (picked.long() << torch.arange(E, device=logs.device)).sum(dim=-1)
    return mask.reshape(-1).clone(), gap.amin(dim=-1).reshape(-1).clone()


@contextmanager
def recorded_routing(store: list):
    """Record, per routing call (an MoE layer's FFN, and before it its MoE
    attention's), each row's route (its top-1 expert; under prototyping
    its pick in every prototype, as one code; under
    expert choice the set of experts that picked it), the margin a bf16
    perturbation must overcome to change it (the router-logit gap to the
    runner-up; under expert choice ``expert_choice_routes``' gap; none
    under hash routing) and which of its choices fit their expert's
    capacity (``valid``, (rows, k))."""
    from unittest import mock

    from repro_torch.core import moe

    real = moe.route
    import torch

    def route(x, router_w, cfg, capacity, ctx=None):
        plan = real(x, router_w, cfg, capacity, ctx=ctx)
        with torch.no_grad():
            valid = plan.valid.reshape(-1, plan.valid.shape[-1]).clone()
            if plan.token_at_slot is not None:
                store.append((*expert_choice_routes(x, router_w, plan), valid))
            elif router_w is None:              # hash: no logits, nothing can flip
                first = plan.expert_index[..., 0].reshape(-1).clone()
                store.append((first, torch.full(first.shape, math.inf), valid))
            elif router_w.dim() == 3:           # prototyping: a top-1 in each prototype
                logits = torch.einsum("gtm,mzf->gtzf", x.float(), router_w.float())
                top2 = logits.topk(2, dim=-1).values
                E = router_w.shape[1] * router_w.shape[2]
                powers = E ** torch.arange(plan.expert_index.shape[-1], device=x.device)
                code = (plan.expert_index.long() * powers).sum(dim=-1)   # every prototype's pick
                store.append((code.reshape(-1).clone(),
                              (top2[..., 0] - top2[..., 1]).amin(dim=-1).reshape(-1).clone(),
                              valid))
            else:
                top2 = (x.float() @ router_w.float()).topk(2, dim=-1).values
                store.append((plan.expert_index[..., 0].reshape(-1).clone(),
                              (top2[..., 0] - top2[..., 1]).reshape(-1).clone(), valid))
        return plan

    from repro_torch.core import moe_attention

    # an MoE attention layer routes before its FFN: one store, in call order
    with mock.patch.object(moe, "route", route), \
            mock.patch.object(moe_attention, "route", route):
        yield


def compare_mixed_step(torch, cfg, params, serve, requests, device="cuda"):
    """One mixed step's forward over its step form's device rows through
    the kernels, then (same pools, same rows) through the plain versions.  The two differ only in f32
    summation order before each bf16 rounding, but a bf16 difference can
    flip a top-1 routing decision whose router logits are nearly tied,
    and a flipped row (and the later rows of its slot, which attend to
    its K/V) then legitimately differs; over quantized pools so does every
    row of its slot from the start of its KV block on, since writing the
    row's K/V sets the whole block's scale and re-encodes the block's
    codes (``quant_write_kv``).  So: every routing flip is
    reported with its margin and must be a near-tie (margin < FLIP_MARGIN
    on the row's first flip); rows untouched by a flip must agree within
    TOL + TOL * |logit|; greedy argmax must agree on them, and any row
    whose argmax differs is reported with its logit margin."""
    from repro_torch.serving.continuous import ContinuousEngine
    from repro_torch.serving.request import Request

    eng = ContinuousEngine(cfg, params, serve, device=device)
    for i, (plen, gen) in enumerate(((40, 8), (45, 8), (20, 8))):
        eng.scheduler.add(Request(uid=i, prompt=requests[i].prompt.repeat(3)[:plen],
                                  max_new_tokens=gen))
    while True:
        eng.step()
        if eng.scheduler.prefilling is not None and any(
                st.status.name == "DECODE" for st in eng.scheduler.running.values()):
            break
    check_census(eng, "mixed step")
    sr = eng.build_rows()
    form = eng._form(sr.kind)                   # the step's rows, in its form's buffers
    form.stage()
    c = eng.cache
    pools = [t for t in (c.k_pool, c.v_pool, c.k_scales, c.v_scales) if t is not None]
    saved = [t.clone() for t in pools]
    route_k, route_p = [], []
    with recorded_routing(route_k):
        lk, _ = eng._forward(form.rows)
    for t, t0 in zip(pools, saved):
        t.copy_(t0)
    with plain_versions(), recorded_routing(route_p):
        lp, _ = eng._forward(form.rows)
    if device != "cpu":
        torch.cuda.synchronize()
    if not torch.isfinite(lk).all():
        raise AssertionError("kernel-path logits are not finite")

    b = sr.buffers
    live_rows = [r for r in range(sr.num_rows) if b["lengths"][r] > 0]
    block = c.block_size if c.k_scales is not None else 1   # the span a K/V write rescales
    affected = set()
    for layer, ((ek, mk, _), (ep, _, _)) in enumerate(zip(route_k, route_p)):
        for r in torch.nonzero(ek != ep).flatten().tolist():
            if b["lengths"][r] == 0:
                continue                        # masked row: output discarded
            margin = float(mk[r])
            first = r not in affected
            log(f"  routing near-tie: layer {layer}, row {r} (slot {b['slots'][r]}, "
                f"position {b['positions'][r]}): expert {int(ek[r])} (kernels) vs "
                f"{int(ep[r])} (plain), router-logit margin {margin:.3g}")
            if first and margin > FLIP_MARGIN:
                raise AssertionError(f"routing flipped at margin {margin} > {FLIP_MARGIN}")
            start = b["positions"][r] - b["positions"][r] % block
            affected.update(q for q in live_rows if b["slots"][q] == b["slots"][r]
                            and b["positions"][q] >= start)
    clean = [r for r in live_rows if r not in affected]
    V = cfg.vocab_size
    lk_c, lp_c = lk[clean, :V], lp[clean, :V]
    diff = float((lk_c - lp_c).abs().max()) if clean else 0.0
    log(f"  mixed step ({sr.num_rows} rows, {len(live_rows)} live, {len(affected)} "
        f"downstream of a routing near-tie): max abs logit diff on the other "
        f"{len(clean)} rows {diff:.4g} (tolerance {TOL} + {TOL} x |logit|, logit "
        f"scale {float(lp[live_rows, :V].abs().max()):.3g}); on all live rows "
        f"{float((lk[live_rows, :V] - lp[live_rows, :V]).abs().max()):.4g}")
    if ((lk_c - lp_c).abs() > TOL + TOL * lp_c.abs()).any():
        raise AssertionError(f"mixed-step logits differ beyond tolerance: {diff}")
    ak, ap = lk[:, :V].argmax(-1), lp[:, :V].argmax(-1)
    for r in live_rows:
        if ak[r] != ap[r]:
            margin = float(lp[r, ap[r]] - lp[r, ak[r]])
            log(f"  argmax differs: row {r} {int(ak[r])} (kernels) vs {int(ap[r])} "
                f"(plain), plain-logit margin {margin:.4g}"
                f"{' (downstream of a routing near-tie)' if r in affected else ''}")
            if r not in affected:
                raise AssertionError(f"greedy argmax differs on row {r} (margin {margin})")
    agree = sum(int(ak[r] == ap[r]) for r in live_rows)
    log(f"  greedy argmax agrees on {agree}/{len(live_rows)} live rows")
    return dict(rows=len(live_rows), argmax_agree=agree, max_abs_logit_diff=diff,
                rows_after_routing_flip=len(affected))


TRAIN_ARGS = ["--arch", "m6-base", "--moe-impl", "pallas", "--batch", "8", "--seq", "144",
              "--log-every", "1"]
PHASE6_TOP1 = {}                # phase 6's 8 top-1 steps: final params (host) and losses, for 17 (a)


def train_run(torch, extra, steps, keep=None):
    """``repro_torch.launch.train.main``'s loop (``run``) itself for
    ``steps`` steps, logging every step (each log syncs, so each
    step_time_s is a whole step); ``keep`` (a dict) gets the final params'
    host copy by flat path."""
    from repro_torch.launch.train import build_parser, run
    from repro_torch.nn import flat_params

    logs, state = run(build_parser().parse_args(TRAIN_ARGS + ["--steps", str(steps)] + extra))
    if keep is not None:
        keep.update({k: p.detach().cpu() for k, p in flat_params(state.params).items()})
    del state
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    for m in logs:
        if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
            raise AssertionError(f"step {m['step']}: loss {m['loss']}, grad norm {m['grad_norm']}")
        if not 0.0 <= m["moe_dropped_fraction"] < 1.0:
            raise AssertionError(f"step {m['step']}: dropped fraction {m['moe_dropped_fraction']}")
    return logs


def train_setup(argv):
    """(cfg, state, step_fn, pipeline) exactly as the train CLI builds them."""
    from repro_torch.launch.train import build_parser, setup

    cfg, _, step_fn, state, pipeline = setup(build_parser().parse_args(argv))
    return cfg, state, step_fn, pipeline


def phase_train(torch):
    """m6-base training through the train CLI; returns (launches, e2e)."""
    from repro_torch.kernels.decode_attention import ops as pda
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.moe_dropless import ops as rffn
    from repro_torch.kernels.moe_ffn import ops as mf

    log("phase 6: m6-base training, 8 top-1 steps then 4 steps of 4 top-1 prototyping, each "
        "with the step captured as a CUDA graph (the default) and with --no-graphs")
    adamw_report = check_adamw(torch)
    counters = {"moe_ffn": mf.moe_ffn, "flash_attention": fa.flash_attention,
                "ragged_ffn": rffn.ragged_ffn, "paged_decode_attention": pda.paged_decode_attention}
    e2e, launches = {}, {}
    runs = (("top-1", [], 8), ("4 top-1", ["--routing", "prototype", "--k", "4"], 4))
    for label, extra, steps in runs:
        final = {}
        for graphs in (True, False):
            form = "graphed" if graphs else "eager"
            for fn in counters.values():
                fn.launches = 0
            mf.moe_ffn.tc_launches = 0
            torch.cuda.reset_peak_memory_stats()
            keep = {}
            t0 = time.perf_counter()
            logs = train_run(torch, extra + ([] if graphs else ["--no-graphs"]), steps, keep)
            run_s = time.perf_counter() - t0
            final[graphs] = (logs, keep)
            got = {name: fn.launches for name, fn in counters.items()}
            want = 5 * steps * 2        # layers x steps x (forward + remat recompute)
            if got["moe_ffn"] != want or any(got[n] for n in got if n != "moe_ffn"):
                raise AssertionError(f"{label} {form}: launches {got}, expected moe_ffn = 5 "
                                     f"layers x {steps} steps x 2 = {want} and no other kernel")
            if mf.moe_ffn.tc_launches != want:
                raise AssertionError(f"{label} {form}: {mf.moe_ffn.tc_launches} of {want} "
                                     f"moe_ffn launches on the tensor-core route")
            if graphs:                  # the path's launches: the graphed run's
                for name, n in got.items():
                    launches[name] = launches.get(name, 0) + n
            steady = logs[1:]                       # step 0 carries first-call set-up
            step_ms = sum(m["step_time_s"] for m in steady) / len(steady) * 1e3
            rep = dict(
                mean_step_ms=step_ms, tokens_per_s=8 * 144 / (step_ms / 1e3),
                first_step_ms=logs[0]["step_time_s"] * 1e3,
                losses=[m["loss"] for m in logs], grad_norms=[m["grad_norm"] for m in logs],
                dropped_fraction=[m["moe_dropped_fraction"] for m in logs],
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, run_s=run_s)
            if graphs:
                e2e[label] = rep
            else:
                e2e[label]["eager"] = rep
            counted = ", counted through the replays" if graphs else ""
            first = " (the capture's warm-up, then the capture)" if graphs else ""
            log(f"  {label} {form}: {steps} steps, moe_ffn launches {got['moe_ffn']} = 5 layers "
                f"x {steps} steps x 2 (forward + remat recompute{counted}), all on the "
                f"tensor-core route; mean step {step_ms:.1f} ms over steps 1-{steps - 1} (host "
                f"clock, synced), {rep['tokens_per_s']:.0f} tokens/s, first step "
                f"{rep['first_step_ms']:.0f} ms{first}, peak memory "
                f"{rep['peak_memory_gb']:.1f} GB; the run {run_s:.1f} s")
            log(f"    losses {[round(x, 4) for x in rep['losses']]}, dropped fraction "
                f"{[round(x, 4) for x in rep['dropped_fraction']]}")
        (glogs, gkeep), (elogs, ekeep) = final[True], final[False]
        if [m["loss"] for m in glogs] != [m["loss"] for m in elogs]:
            raise AssertionError(f"{label}: graphed losses {[m['loss'] for m in glogs]} differ "
                                 f"from the eager run's {[m['loss'] for m in elogs]}")
        differ = [k for k in gkeep if not torch.equal(gkeep[k].view(torch.int32),
                                                      ekeep[k].view(torch.int32))]
        if differ:
            raise AssertionError(f"{label}: graphed final params differ from the eager run's: "
                                 f"{differ[:5]}")
        log(f"  {label}: graphed and eager losses and all {len(gkeep)} final param leaves "
            f"bit-equal")
        e2e[label]["graphed_vs_eager_bit_equal"] = True
        if label == "top-1":
            PHASE6_TOP1.update(gkeep)
            PHASE6_TOP1["losses"] = [m["loss"] for m in glogs]
        del final, gkeep, ekeep

    e2e["cuda_core_route"] = train_on_cuda_cores(torch, mf, runs)

    from repro_torch.launch.train import device_batch

    for graphs in (True, False):
        e2e["top-1"]["profile" if graphs else "eager_profile"] = profile_train_form(
            torch, TRAIN_ARGS + ["--steps", "8"], graphs)
    cfg, state, step_fn, pipeline = train_setup(TRAIN_ARGS + ["--steps", "8"])
    batch = device_batch(pipeline.batch_at(0), "cuda")
    e2e["kernels_vs_plain"] = compare_train_step(torch, cfg, state.params, batch)
    e2e["flash"] = compare_flash_forward(torch, cfg, state.params, batch, fa)
    del state, step_fn
    torch.cuda.empty_cache()
    e2e["dropless"] = dropless_gradient_step(torch, rffn, TRAIN_ARGS + DROPLESS_ARGS)
    e2e["dropless_graphed_vs_eager"] = train_pair(
        torch, TRAIN_ARGS + DROPLESS_ARGS[2:] + ["--steps", "2"], "dropless",
        {"ragged_ffn": 5 * 2 * 2})
    # the one-device --moe-impls without a kernel (alltoall trains as gather)
    for impl in ("einsum", "gather", "alltoall"):
        e2e[f"{impl}_graphed_vs_eager"] = train_pair(
            torch, TRAIN_ARGS + ["--moe-impl", impl, "--batch", "2", "--steps", "2"], impl, {})
    e2e["adamw_on_card"] = adamw_report
    return launches, e2e


def check_adamw(torch):
    """The AdamW update of m6-shaped leaves (four f32 training leaves and a
    bf16 expert matrix) on the card at steps 1-4, and the trainer's 3-way
    microbatch average, bit-equal (int32 / int16 views) to the same on the
    CPU from the same inputs.  Beside them, the share of elements that a
    Python-number divisor moves on the card (PyTorch multiplies by its
    reciprocal there; the CPU divides): the fault the 0-dim device
    divisors of ``optim/adamw.py`` and ``train/trainer.py`` repair."""
    import numpy as np

    from repro_torch.optim.adamw import adamw
    from repro_torch.optim.schedules import warmup_constant
    from repro_torch.train.trainer import microbatch_mean

    def bits(t):
        return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)

    def same(a, b):
        return torch.equal(bits(a.cpu()), bits(b))

    leaves = {"blocks/attn/wq/kernel": ((5, 1024, 1024), torch.float32),
              "blocks/ffn/router": ((5, 1024, 32), torch.float32),
              "blocks/ln_attn/scale": ((5, 1024), torch.float32),
              "pos_embed": ((256, 1024), torch.float32),
              "blocks/ffn/up, one expert": ((1024, 4096), torch.bfloat16)}
    g = torch.Generator().manual_seed(600)
    opt = adamw(warmup_constant(1e-3, 2))
    cpu_p = {k: (torch.randn(s, generator=g) * 0.02).to(dt) for k, (s, dt) in leaves.items()}
    dev_p = {k: v.cuda() for k, v in cpu_p.items()}
    cpu_s, dev_s = opt.init(cpu_p), opt.init(dev_p)
    by_number = []
    for step in range(4):
        grads = {k: torch.randn(s, generator=g) * 1e-2 for k, (s, _) in leaves.items()}
        cpu_u, cpu_s = opt.update(grads, cpu_s, cpu_p, step)
        dev_u, dev_s = opt.update({k: v.cuda() for k, v in grads.items()}, dev_s, dev_p, step)
        torch.cuda.synchronize()
        for k in leaves:
            for what, a, b in (("update", dev_u[k], cpu_u[k]), ("mu", dev_s["mu"][k],
                               cpu_s["mu"][k]), ("nu", dev_s["nu"][k], cpu_s["nu"][k])):
                if not same(a, b):
                    raise AssertionError(f"AdamW step {step + 1} {k}: {what} on the card "
                                         f"differs from the CPU's")
        c1 = float(np.float32(1) - np.float32(0.9) ** np.float32(step + 1))
        mu = cpu_s["mu"]["blocks/attn/wq/kernel"]
        moved = bits((mu.cuda() / c1).cpu()) != bits(mu / torch.full((), c1))
        by_number.append(float(moved.float().mean()))
        for k in leaves:
            for p, u in ((cpu_p[k], cpu_u[k]), (dev_p[k], dev_u[k])):
                p.copy_(p.float() + u.float())
    sums = {k: torch.randn(s, generator=g) * 3.0 for k, (s, _) in leaves.items()}
    cpu_mean = microbatch_mean(sums, 3)
    dev_mean = microbatch_mean({k: v.cuda() for k, v in sums.items()}, 3)
    torch.cuda.synchronize()
    if not all(same(dev_mean[k], cpu_mean[k]) for k in leaves):
        raise AssertionError("the 3-way microbatch average on the card differs from the CPU's")
    s = sums["blocks/attn/wq/kernel"]
    mean_moved = float((bits((s.cuda() / 3).cpu()) != bits(cpu_mean["blocks/attn/wq/kernel"])
                        ).float().mean())
    log(f"  AdamW on the card: updates, mu and nu of {len(leaves)} m6-shaped leaves bit-equal "
        f"to the CPU's at steps 1-4, and the 3-way microbatch average; with a Python-number "
        f"divisor (the repaired form) mu / c1 would differ in "
        f"{', '.join(f'{x:.4f}' for x in by_number)} of the elements at steps 1-4, and the "
        f"average in {mean_moved:.4f}")
    return dict(bit_equal_steps=4, python_number_divisor_moved=by_number,
                microbatch_mean_python_number_moved=mean_moved)


def train_on_cuda_cores(torch, mf, runs) -> dict:
    """The same training runs with the grouped FFN on its CUDA-core route
    (the device code before the tensor-core one), in the same call as the
    runs on the tensor cores: {label: mean step ms over steps 1 on}."""
    out = {}
    for label, extra, steps in runs:
        before = mf.moe_ffn.tc_launches
        logs = on_cuda_cores(mf, train_run)(torch, extra, steps)
        if mf.moe_ffn.tc_launches != before:
            raise AssertionError(f"{label}: the CUDA-core run launched the tensor cores")
        steady = logs[1:]
        out[label] = sum(m["step_time_s"] for m in steady) / len(steady) * 1e3
        log(f"  {label} with the grouped FFN on its CUDA-core route: mean step "
            f"{out[label]:.1f} ms over steps 1-{steps - 1} (host clock, synced)")
    return out


def profile_train_form(torch, argv, graphs, n_steps=2):
    """The train CLI's one-device step (``train.trainer.TrainForm`` over its
    state and batches) with its step captured (``graphs``) or eager: step
    0 (with graphs, the capture's warm-up, then the capture), then
    torch.profiler over ``n_steps`` steps: the device busy share, the
    kernels that take the device time and the graph's pool bytes."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.train import build_parser, fresh_state, parts
    from repro_torch.train.trainer import TrainForm

    args = build_parser().parse_args(argv)
    cfg, tc, opt, _, pipeline = parts(args)
    state = fresh_state(cfg, tc, opt, args)
    form = TrainForm(cfg, tc, opt, state, graphs=graphs)
    t0 = time.perf_counter()
    state, _ = form(state, pipeline.batch_at(0))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    batches = [pipeline.batch_at(1 + i) for i in range(n_steps)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        open_session(torch)
        t0 = time.perf_counter()
        for b in batches:
            state, _ = form(state, b)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    pool = form.graph_bytes
    del form, state
    torch.cuda.empty_cache()
    what = "graphed" if graphs else "eager"
    kernels = device_events(prof)
    busy_us = sum(float(e.self_device_time_total) for e in kernels)
    out = {"graph_pool_bytes": pool, "first_step_s": first_s, "profiled_steps": n_steps,
           "profiled_wall_ms": wall_us / 1e3}
    if busy_us <= 0.0:
        log(f"  profiler ({what}): no device time recorded; device busy share not measured")
        return dict(out, device_busy_share=None)
    log(f"  profiler over {n_steps} {what} train steps: device busy {busy_us / 1e3:.2f} ms of "
        f"{wall_us / 1e3:.2f} ms wall ({busy_us / wall_us:.1%} busy; kernels and copies); step 0 "
        f"{first_s:.2f} s; the graph's pool {pool / 2**20:.2f} MiB")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:12]:
        log(f"    {e.self_device_time_total / 1e3:8.3f} ms  {e.count:6d} x  {e.key[:110]}")
    return dict(out, device_busy_share=busy_us / wall_us, profiled_device_ms=busy_us / 1e3)


def eager_against(torch, args, label, graphed_logs, graphed_launches, edit=lambda cfg: cfg):
    """The train CLI's run of ``args`` under ``edit`` of its config again
    with --no-graphs: every step's loss bit-equal (as Python floats of the
    same f32) to the graphed run's ``graphed_logs`` and the same kernel
    launches as its ``graphed_launches`` (counted through the replays).
    Returns both runs' mean step ms over steps 1 on and the eager losses."""
    from repro_torch.launch import train as train_mod

    got = {}
    t0 = time.perf_counter()
    with built_config(edit), counted_launches(got):
        logs = train_mod.main(args + ["--no-graphs"])
    wall_s = time.perf_counter() - t0
    losses, want = [m["loss"] for m in logs], [m["loss"] for m in graphed_logs]
    if losses != want:
        raise AssertionError(f"{label}: eager losses {losses} differ from the graphed run's {want}")
    if {k: v for k, v in got.items() if v} != {k: v for k, v in graphed_launches.items() if v}:
        raise AssertionError(f"{label}: eager launches {got} differ from the graphed run's "
                             f"{graphed_launches}")

    def mean_ms(ls):
        steady = ls[1:] or ls
        return sum(m["step_time_s"] for m in steady) / len(steady) * 1e3

    out = dict(graphed_mean_step_ms=mean_ms(graphed_logs), eager_mean_step_ms=mean_ms(logs),
               graphed_first_step_ms=graphed_logs[0]["step_time_s"] * 1e3,
               eager_losses=losses, losses_bit_equal=True, eager_run_s=wall_s)
    log(f"  {label}: graphed against --no-graphs, losses bit-equal over {len(logs)} steps, the "
        f"same launches; step 1 on {out['graphed_mean_step_ms']:.1f} ms graphed against "
        f"{out['eager_mean_step_ms']:.1f} ms eager (host clock, synced; graphed step 0, the "
        f"capture's warm-up and the capture, {out['graphed_first_step_ms']:.0f} ms); the eager "
        f"run {wall_s:.1f} s")
    return out


def train_pair(torch, args, label, want):
    """The train CLI's run of ``args`` graphed (on the card its kernels
    launched as ``want`` says, counted through the replays) and then with
    --no-graphs (``eager_against``)."""
    from repro_torch.launch import train as train_mod

    got = {}
    with counted_launches(got):
        logs = train_mod.main(args)
    expect_launches(label, got, want)
    return eager_against(torch, args, label, logs, got)


def _flip_report(routes_k, routes_p, layers, seq_len, label):
    """Routing flips between two forwards over (batch x seq_len) tokens, per
    routing call (``layers`` of them: the forward's route calls only, the
    remat recompute appends more; an MoE attention layer routes twice), each
    reported with its router-logit margin.  A flip must be a
    near-tie (margin < FLIP_MARGIN) unless an earlier layer's flip
    reached the token through causal attention (a flipped token moves the
    later tokens of its sequence).  Under an expert capacity a flip also
    moves the later tokens of the two experts' queues, so a token whose
    choice fits its expert's capacity in one forward and not in the other
    is reported too, and is affected like a flipped token; such a shift
    without any flip in its layer fails.  Returns (flips, affected token
    ids)."""
    flips, affected = [], set()
    for layer, ((ek, mk, vk), (ep, _, vp)) in enumerate(zip(routes_k[:layers],
                                                          routes_p[:layers])):
        reached = set(affected)
        flipped = torch_nonzero(ek != ep)
        for r in flipped:
            margin = float(mk[r])
            flips.append((layer, r, margin))
            log(f"  routing near-tie ({label}): layer {layer}, token {r}: route {int(ek[r])} "
                f"(kernels) vs {int(ep[r])} (plain), router margin {margin:.3g}")
            if r not in reached and margin > FLIP_MARGIN:
                raise AssertionError(f"{label}: routing flipped at margin {margin} > {FLIP_MARGIN}")
            affected.update(range(r, (r // seq_len + 1) * seq_len))
        shifted = [r for r in torch_nonzero((vk != vp).any(-1)) if r not in set(flipped)]
        if shifted and not flipped:
            raise AssertionError(f"{label}: layer {layer}: {len(shifted)} tokens kept or dropped "
                                 f"at capacity differently with no routing flip")
        for r in shifted:
            log(f"  capacity shift ({label}): layer {layer}, token {r}: expert {int(ek[r])} "
                f"{'keeps' if bool(vk[r].all()) else 'drops'} it (kernels), "
                f"{'keeps' if bool(vp[r].all()) else 'drops'} it (plain)")
            affected.update(range(r, (r // seq_len + 1) * seq_len))
    return flips, affected


def torch_nonzero(mask):
    return mask.nonzero().flatten().tolist()


def sync(torch, t) -> bool:
    """Wait for the card if ``t`` lives on it; True there.  (The compare
    phases below also run on the CPU at smoke size, as a rehearsal.)"""
    if t.is_cuda:
        torch.cuda.synchronize()
    return t.is_cuda


def compare_train_step(torch, cfg, params, batch):
    """One step's loss and gradients through the kernels, then through the
    plain versions, from the same params and batch.  The two differ in f32
    summation order before bf16 roundings, which can flip a top-1 routing
    near-tie; each flip is reported with its margin and must be a near-tie.
    Loss within 1e-3 + 10 / tokens per flipped token (a token's CE moves by
    about log V at most when its expert changes); the global gradient norm
    within 2e-2 relative; every leaf's gradient cosine to the plain one
    >= 0.99 (>= 0.9 with flips)."""
    from repro_torch.nn import flat_params
    from repro_torch.train.trainer import make_loss_fn

    loss_fn = make_loss_fn(cfg)
    flat = flat_params(params)

    def loss_and_grads(routes):
        with recorded_routing(routes):
            loss, _ = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, list(flat.values()))
        return float(loss.detach()), grads

    rk, rp = [], []
    lk, gk = loss_and_grads(rk)
    with plain_versions():
        lp, gp = loss_and_grads(rp)
    sync(torch, batch["tokens"])
    seq = batch["tokens"].shape[1] + batch["patch_embeds"].shape[1]
    routes = moe_layers(cfg) * (2 if cfg.moe.moe_attention else 1)   # a forward's route calls
    flips, _ = _flip_report(rk, rp, routes, seq, "train step")
    tokens = batch["labels"].numel()
    loss_tol = 1e-3 + 10.0 * len({r for _, r, _ in flips}) / tokens
    nk = math.sqrt(sum(float(g.float().square().sum()) for g in gk))
    np_ = math.sqrt(sum(float(g.float().square().sum()) for g in gp))
    cos = {name: float(torch.nn.functional.cosine_similarity(
        a.float().flatten(), b.float().flatten(), dim=0))
        for name, a, b in zip(flat, gk, gp) if float(b.float().abs().max()) > 0}
    worst = min(cos, key=cos.get)
    log(f"  train step kernels vs plain: loss {lk:.6f} vs {lp:.6f} (|diff| {abs(lk - lp):.3g}, "
        f"tolerance {loss_tol:.3g}); grad norm {nk:.5f} vs {np_:.5f}; lowest leaf gradient "
        f"cosine {cos[worst]:.6f} ({worst}); {len(flips)} routing flips")
    if not all(math.isfinite(v) for v in (lk, lp, nk, np_)):
        raise AssertionError("train step: non-finite loss or gradient norm")
    if abs(lk - lp) > loss_tol:
        raise AssertionError(f"train step loss differs: {lk} vs {lp}")
    if abs(nk - np_) > 2e-2 * np_:
        raise AssertionError(f"train step grad norm differs: {nk} vs {np_}")
    if cos[worst] < (0.9 if flips else 0.99):
        raise AssertionError(f"train step gradient of {worst}: cosine {cos[worst]}")
    return dict(loss=lk, plain_loss=lp, grad_norm=nk, plain_grad_norm=np_,
                min_grad_cosine=cos[worst], routing_flips=len(flips))


def compare_flash_forward(torch, cfg, params, batch, fa):
    """``lm_apply(use_flash=True)`` against ``use_flash=False`` on the train
    batch: logits within 2e-2 + 2e-2 |logit| on tokens untouched by a
    routing near-tie; the flash kernel launched once per layer, on the
    card every launch on its tensor-core route."""
    from repro_torch.models.transformer import lm_apply

    def run(use_flash, routes):
        with torch.no_grad(), recorded_routing(routes):
            return lm_apply(params, batch["tokens"], cfg, use_flash=use_flash,
                            extra_embeds=batch["patch_embeds"])[0]

    rf, rr = [], []
    fa.flash_attention.launches = fa.flash_attention.tc_launches = 0
    lf = run(True, rf)
    n, n_tc = fa.flash_attention.launches, fa.flash_attention.tc_launches
    lr = run(False, rr)
    if sync(torch, lf) and not n == n_tc == cfg.num_layers:
        raise AssertionError(f"flash_attention: {n} launches in one forward ({n_tc} on the "
                             f"tensor-core route), expected {cfg.num_layers} (one per layer, "
                             f"all on the tensor cores)")
    B, S = lf.shape[:2]
    flips, affected = _flip_report(rf, rr, cfg.num_layers, S, "flash forward")
    hit = torch.zeros(B * S, dtype=torch.bool, device=lf.device)
    hit[sorted(affected)] = True
    V = cfg.vocab_size
    a, b = lf.reshape(B * S, -1)[~hit, :V].float(), lr.reshape(B * S, -1)[~hit, :V].float()
    diff = float((a - b).abs().max())
    log(f"  lm_apply use_flash=True vs False: {n} flash launches (one per layer, {n_tc} on the "
        f"tensor cores); max abs "
        f"logit diff {diff:.4g} on {int((~hit).sum())} of {B * S} tokens (tolerance "
        f"{TOL} + {TOL} x |logit|, logit scale {float(b.abs().max()):.3g}); "
        f"{len(flips)} routing flips")
    if ((a - b).abs() > TOL + TOL * b.abs()).any():
        raise AssertionError(f"flash forward logits differ beyond tolerance: {diff}")
    return dict(max_abs_logit_diff=diff, launches=n, tc_launches=n_tc, routing_flips=len(flips))


DROPLESS_ARGS = ["--steps", "1", "--batch", "2", "--moe-impl", "dropless",
                 "--capacity-factor", "none"]


def dropless_gradient_step(torch, rffn, argv):
    """One dropless (--moe-impl dropless --capacity-factor none) loss and
    gradient through the ragged-FFN kernel and through its plain version:
    the expert weights' gradients must be nonzero and agree (cosine >=
    0.99, norm within 2e-2)."""
    from repro_torch.launch.train import device_batch
    from repro_torch.nn import flat_params
    from repro_torch.train.trainer import make_loss_fn

    cfg, state, _, pipeline = train_setup(argv)
    device = state.params["embed"]["table"].device
    batch = device_batch(pipeline.batch_at(0), device)
    loss_fn = make_loss_fn(cfg)
    flat = flat_params(state.params)
    names = ["blocks/ffn/up", "blocks/ffn/down", "blocks/ffn/router"]

    def grads():
        loss, _ = loss_fn(state.params, batch)
        return torch.autograd.grad(loss, [flat[n] for n in names])

    from repro_torch.kernels.moe_dropless import combine

    rffn.ragged_ffn.launches = rffn.ragged_ffn.tc_launches = combine.ragged_combine.launches = 0
    gk = grads()
    n, n_tc = rffn.ragged_ffn.launches, rffn.ragged_ffn.tc_launches
    n_combine = combine.ragged_combine.launches
    with plain_versions():
        gp = grads()
    on_card = sync(torch, gp[0])
    out = {"ragged_ffn_launches": n, "ragged_combine_launches": n_combine}
    for name, a, b in zip(names, gk, gp):
        na, nb = float(a.float().norm()), float(b.float().norm())
        cos = float(torch.nn.functional.cosine_similarity(a.float().flatten(),
                                                          b.float().flatten(), dim=0))
        out[name] = dict(norm=na, plain_norm=nb, cosine=cos)
        log(f"  dropless step {name} gradient: norm {na:.5g} (kernel) vs {nb:.5g} (plain), "
            f"cosine {cos:.6f}")
        if na == 0.0 or abs(na - nb) > 2e-2 * nb or cos < 0.99:
            raise AssertionError(f"dropless step: {name} gradient {na} vs {nb}, cosine {cos}")
    if on_card and (n != 2 * cfg.num_layers or n_combine != n):
        raise AssertionError(f"dropless step: ragged_ffn launched {n} times, ragged_combine "
                             f"{n_combine}, expected 2 x {cfg.num_layers} each (forward + "
                             f"remat recompute)")
    log(f"  dropless step: ragged_ffn launched {n} times (forward + remat recompute), "
        f"{n_tc} on the tensor-core route; ragged_combine {n_combine} times")
    return out


def token_match(base, other) -> float:
    """Position-wise greedy token agreement over the requests both served."""
    hit = tot = 0
    for uid in base.keys() & other.keys():
        a, b = base[uid], other[uid]
        tot += max(len(a), len(b))
        hit += sum(1 for x, y in zip(a, b) if x == y)
    return hit / max(tot, 1)


def serve_once(torch, cfg, params, serve, requests, device="cuda", **kw):
    """One engine's run of ``requests``: (tokens, stats, engine, wall ms)."""
    from repro_torch.serving.continuous import ContinuousEngine

    eng = ContinuousEngine(cfg, params, serve, device=device, **kw)
    table = params["embed"]["table"]
    sync(torch, table)
    t0 = time.perf_counter()
    out, stats = eng.run(requests)
    sync(torch, table)
    wall_ms = (time.perf_counter() - t0) * 1e3
    for r in requests:
        if len(out[r.uid]) != r.max_new_tokens:
            raise AssertionError(f"request {r.uid}: {len(out[r.uid])} tokens, budget "
                                 f"{r.max_new_tokens}")
    eng.scheduler.check_conservation()       # slots, and the KV cache where there is one
    check_census(eng, f"{cfg.name} run")
    return out, stats, eng, wall_ms


def check_census(eng, label: str) -> dict:
    """The engine's compiled-variant census after it stepped: for an
    engine that captures (on the card, without a mesh, with graphs) the
    ``engine_compiled_variants`` gauge at its ``_expected_variants`` (else,
    where a form is built at its kind's first step as the reference's jit
    compiles, at most that) and no recompile (``engine_recompiles_total``
    0); an engine that captures holds every step form as a CUDA graph (the
    recurrent step's and its slot reset's too)."""
    m = eng.obs.metrics
    n, again = m.get("engine_compiled_variants"), m.get("engine_recompiles_total")
    want = eng._expected_variants
    captures = getattr(eng, "_graph_pool", None) is not None
    if again != 0 or (n != want if captures else not 0 < n <= want):
        raise AssertionError(f"{label}: engine_compiled_variants {n}, engine_recompiles_total "
                             f"{again}; expected {want} and 0")
    forms = {**getattr(eng, "_forms", {}), **getattr(eng, "_rec_forms", {})}
    graphs = sum(f.graph is not None for f in forms.values())
    if captures and graphs != len(forms):
        raise AssertionError(f"{label}: {graphs} of {len(forms)} step forms captured")
    # the model drafter's forwards: a graph on the engine's pool, not in the census
    drafter = getattr(getattr(eng, "drafter", None), "form", None)
    if drafter is not None and captures and drafter.graph is None:
        raise AssertionError(f"{label}: the model drafter's forwards not captured")
    return dict(compiled_variants=n, recompiles=again, graphs=graphs,
                drafter_graph=drafter is not None and drafter.graph is not None)


def quant_serving_runs(torch, cfg, params, requests, base_tokens, device="cuda",
                       max_len=256, probe_lens=(24, 64)):
    """Phase 7 (a): the trace under kv_quant int8 then fp8.  Launch counts
    are reset once before the int8 run and read after the fp8 run; each run
    must launch the quantized attention kernel layers x steps times and the
    bf16 paged kernel never.  Returns (launches, report, {kv_quant: tokens})."""
    import dataclasses

    from repro_torch.configs.base import ServeConfig
    from repro_torch.kernels.decode_attention import ops as pda
    from repro_torch.kernels.moe_dropless import combine
    from repro_torch.kernels.moe_dropless import ops as rffn
    from repro_torch.serving.trace import latency_line

    serve = ServeConfig(max_len=max(max_len, max(r.total_len for r in requests)))
    on_card = torch.device(device).type == "cuda"
    counters = {"quantized_paged_decode_attention": pda.quantized_paged_decode_attention,
                "paged_decode_attention": pda.paged_decode_attention,
                "ragged_ffn": rffn.ragged_ffn, "ragged_combine": combine.ragged_combine}
    for fn in counters.values():
        fn.launches = 0
    rffn.ragged_ffn.tc_launches = 0
    report, before, outs = {}, {n: 0 for n in counters}, {}
    for name in ("int8", "fp8"):
        STEP_CLOCKS[name] = []                                  # phase 16 replays int8's
        with recorded_clocks(STEP_CLOCKS[name]):
            out, stats, eng, wall_ms = serve_once(
                torch, cfg, params, dataclasses.replace(serve, kv_quant=name), requests, device)
        got = {n: fn.launches - before[n] for n, fn in counters.items()}
        before = {n: fn.launches for n, fn in counters.items()}
        steps = eng.steps
        want = cfg.num_layers * steps
        if on_card and (got["quantized_paged_decode_attention"] != want
                        or got["ragged_ffn"] != want or got["ragged_combine"] != want
                        or got["paged_decode_attention"]):
            raise AssertionError(f"kv_quant {name}: launches {got}, expected the quantized "
                                 f"kernel, ragged_ffn and ragged_combine {want} = layers x "
                                 f"steps, the bf16 paged kernel 0")
        if stats["moe_dropped_fraction"] != 0.0:
            raise AssertionError(f"kv_quant {name}: dropped fraction "
                                 f"{stats['moe_dropped_fraction']}")
        match = token_match(base_tokens, out)
        outs[name] = out
        log(f"  kv_quant {name}: {latency_line(stats)}; {steps} steps, mean step "
            f"{wall_ms / steps:.3f} ms (host clock); launches {got}; token match against "
            f"phase 5 (bf16 pools) {match:.4f}; block bytes {eng.cache.block_bytes}")
        report[name] = dict(tokens_per_s=stats["generated_tokens_per_s"],
                            p50_ms=stats["p50_ms"], p95_ms=stats["p95_ms"],
                            mean_step_ms=wall_ms / steps, steps=steps,
                            token_match_vs_bf16=match, block_bytes=eng.cache.block_bytes)
    launches = {n: fn.launches for n, fn in counters.items()}
    if on_card and rffn.ragged_ffn.tc_launches != launches["ragged_ffn"]:
        raise AssertionError(f"kv_quant: {rffn.ragged_ffn.tc_launches} of "
                             f"{launches['ragged_ffn']} ragged_ffn launches on the tensor-core "
                             f"route")
    if on_card:
        log("  profile of int8 steps:")
        report["profile_int8"] = profile_steps(torch, cfg, params,
                                               dataclasses.replace(serve, kv_quant="int8"),
                                               requests)
    report["logit_divergence"] = logit_divergence(torch, cfg, params, serve, device,
                                                  probe_lens)
    report["kernels_vs_plain_int8"] = compare_mixed_step(
        torch, cfg, params, dataclasses.replace(serve, kv_quant="int8"), requests, device)
    return launches, report, outs


def logit_divergence(torch, cfg, params, serve, device="cuda", probe_lens=(24, 64)):
    """One request (24-token prompt, 64 generated on the card) replayed alone under
    none, int8 and fp8 through ``logit_tap``: the largest logit difference
    against ``none`` over the rows both runs computed (matched by slot and
    position), as benchmarks/serve_throughput.py measures it."""
    import dataclasses

    from repro_torch.serving.trace import synthetic_trace

    plen, glen = probe_lens
    probe = synthetic_trace(1, cfg.vocab_size, seed=3, qps=1e6, prompt_lens=(plen, plen),
                            gen_lens=(glen,))
    V = cfg.vocab_size
    rows, outs = {}, {}
    for name in ("none", "int8", "fp8"):
        got = rows[name] = {}

        def tap(lg, slots, pos, lens, got=got):
            for i, n in enumerate(lens):
                if n > 0:                       # length 0 = padding row
                    got[int(slots[i]), int(pos[i])] = lg[i, :V].copy()

        sv = dataclasses.replace(serve, max_slots=1, kv_quant=name,
                                 max_len=probe[0].total_len)
        outs[name] = serve_once(torch, cfg, params, sv, probe, device, logit_tap=tap)[0]
    res = {}
    for name in ("int8", "fp8"):
        common = rows["none"].keys() & rows[name].keys()
        div = max(float(abs(rows[name][k] - rows["none"][k]).max()) for k in common)
        res[name] = dict(max_logit_divergence=div, rows=len(common),
                         token_match=token_match(outs["none"], outs[name]))
        log(f"  logit divergence {name} vs none over {len(common)} rows of one replayed "
            f"request: {div:.4g} (token match {res[name]['token_match']:.4f})")
    return res


def capacity_runs(torch, cfg, params, device="cuda", blocks=(8, 15)):
    """Phase 7 (b): one device byte budget, 8 bf16 blocks, spent on bf16
    pools and on int8 pools (floor(8 * 327680 / 164480) = 15 blocks at
    m6-base), over a block-starved trace; peak running int8 / bf16 must
    reach 1.3, the reference benchmark's own assertion."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.serving.trace import synthetic_trace

    reqs = synthetic_trace(24, cfg.vocab_size, seed=0, qps=1e6, prompt_lens=(8, 16),
                           gen_lens=(16, 24))
    res, outs = {}, {}
    for name, n in zip(("none", "int8"), blocks):
        sv = ServeConfig(max_slots=8, kv_block_size=16, prefill_chunk=16, num_blocks=n,
                         kv_quant=name, max_len=max(r.total_len for r in reqs))
        outs[name], stats, eng, wall_ms = serve_once(torch, cfg, params, sv, reqs, device,
                                                     check_invariants=True)
        res[name] = dict(num_blocks=n, block_bytes=eng.cache.block_bytes,
                         pool_bytes=n * eng.cache.block_bytes,
                         peak_running=stats["peak_running"],
                         tokens_per_s=stats["generated_tokens_per_s"])
    res["peak_running_ratio"] = res["int8"]["peak_running"] / max(res["none"]["peak_running"], 1)
    res["token_match"] = token_match(outs["none"], outs["int8"])
    log(f"  capacity: bf16 {res['none']['num_blocks']} blocks x {res['none']['block_bytes']} B"
        f" = {res['none']['pool_bytes']} B, peak running {res['none']['peak_running']:.0f}; "
        f"int8 {res['int8']['num_blocks']} x {res['int8']['block_bytes']} B = "
        f"{res['int8']['pool_bytes']} B, peak running {res['int8']['peak_running']:.0f}; "
        f"ratio {res['peak_running_ratio']:.2f}; token match {res['token_match']:.4f}")
    if res["peak_running_ratio"] < 1.3:
        raise AssertionError(f"equal-byte int8 pools lift peak running only "
                             f"{res['peak_running_ratio']:.2f}x (< 1.3)")
    return res


def prefix_runs(torch, cfg, params, device="cuda", system_prompt_len=48, max_len=256):
    """Phase 7 (c): synthetic_multitenant(16, ...) (4 tenants, 48-token
    system prompts), prefix cache off and on, under none and int8."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.serving.trace import synthetic_multitenant

    reqs = synthetic_multitenant(16, cfg.vocab_size, seed=0, num_tenants=4,
                                 system_prompt_len=system_prompt_len)
    res = {}
    for name in ("none", "int8"):
        outs = {}
        for prefix in (False, True):
            sv = ServeConfig(max_len=max(max_len, max(r.total_len for r in reqs)),
                             kv_quant=name, prefix_cache=prefix)
            outs[prefix], stats, eng, wall_ms = serve_once(torch, cfg, params, sv, reqs,
                                                           device)
            key = f"{name} prefix {'on' if prefix else 'off'}"
            res[key] = dict(tokens_per_s=stats["generated_tokens_per_s"],
                            p50_ms=stats["p50_ms"], p95_ms=stats["p95_ms"],
                            steps=stats["steps"], mean_step_ms=wall_ms / eng.steps)
            if prefix:
                ratio = stats["cached_token_ratio"]
                res[key].update(cached_token_ratio=ratio, cached_tokens=stats["cached_tokens"],
                                **{k: eng.cache.stats[k] for k in
                                   ("bound_blocks", "published_blocks", "evicted_blocks")})
                if not ratio > 0:
                    raise AssertionError(f"{key}: cached-token ratio {ratio}")
            log(f"  multitenant {key}: {stats['generated_tokens_per_s']:.1f} tokens/s, "
                f"{stats['steps']:.0f} steps, mean step {wall_ms / eng.steps:.3f} ms, p50 "
                f"{stats['p50_ms']:.0f} ms, p95 {stats['p95_ms']:.0f} ms"
                + (f", cached-token ratio {stats['cached_token_ratio']:.3f}" if prefix else ""))
        res[f"{name} token_match_on_vs_off"] = token_match(outs[False], outs[True])
        log(f"  multitenant {name}: token match prefix on vs off "
            f"{res[f'{name} token_match_on_vs_off']:.4f}")
    return res


def dense_on_engine_pools(torch, cfg, params, requests, device="cuda", max_len=256,
                          gen=64):
    """Phase 7 (d): the dense-cache decode kernel (on no serving path of the
    reference) over the engine's own K/V.  Eight requests are served until
    they decode; the next step's decode rows are gathered from the bf16
    pools into dense (B, T, Hkv, D) caches, and in every layer
    ``decode_attention`` on them must agree with ``paged_decode_attention``
    on the pools for the same q.  Returns the dense kernel's launches."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.serving.continuous import ContinuousEngine
    from repro_torch.serving.request import Request, Status

    serve = ServeConfig(max_len=max_len)
    eng = ContinuousEngine(cfg, params, serve, device=device)
    for r in requests[:8]:
        eng.scheduler.add(Request(uid=r.uid, prompt=r.prompt, max_new_tokens=gen))
    while any(st.status is not Status.DECODE for st in eng.scheduler.running.values()) \
            or len(eng.scheduler.running) < 8:
        eng.step()
    check_census(eng, "phase 7 (d)")
    b = eng.build_rows().buffers
    rows = [i for i in range(len(b["lengths"])) if b["lengths"][i] > 0]
    tbl = torch.from_numpy(b["row_tables"][rows]).to(device)
    lens = torch.from_numpy(b["lengths"][rows]).to(device)
    B, MB, bs = len(rows), tbl.shape[1], eng.cache.block_size
    g = torch.Generator(device=device).manual_seed(500)
    da.decode_attention.launches = 0
    err = 0.0
    for layer in range(cfg.num_layers):
        kp, vp = eng.cache.k_pool[layer], eng.cache.v_pool[layer]
        Hkv, D = kp.shape[1], kp.shape[3]
        q = torch.randn((B, cfg.num_heads, D), generator=g, device=device).to(kp.dtype)
        dense = [p[tbl.long()].permute(0, 1, 3, 2, 4).reshape(B, MB * bs, Hkv, D)
                 for p in (kp, vp)]
        got = da.decode_attention(q, *dense, lens)
        want = da.paged_decode_attention(q, kp, vp, tbl, lens)
        sync(torch, got)
        err = max(err, check_close(f"decode_attention vs paged, layer {layer} ({B} rows, "
                                   f"lengths {lens.min().item()}-{lens.max().item()})",
                                   got, want))
    return dict(launches=da.decode_attention.launches, max_abs_err_vs_paged=err)


def phase_kv(torch, base_tokens):
    """Phase 7: m6-base over the quantized and prefix-cached KV cache."""
    from repro_torch.configs.m6 import M6_BASE
    from repro_torch.nn import init_params
    from repro_torch.serving.trace import synthetic_trace

    log("phase 7: m6-base over int8/fp8 and prefix-cached paged KV pools")
    cfg = M6_BASE.replace_moe(impl="dropless", capacity_factor=None)
    params = init_params(cfg, seed=0, device="cuda")            # phase 5's weights
    requests = synthetic_trace(16, cfg.vocab_size, seed=0)
    launches, report, tokens = quant_serving_runs(torch, cfg, params, requests, base_tokens)
    report["capacity"] = capacity_runs(torch, cfg, params)
    report["prefix"] = prefix_runs(torch, cfg, params)
    report["dense_on_engine_pools"] = dense_on_engine_pools(torch, cfg, params, requests)
    launches["decode_attention"] = report["dense_on_engine_pools"]["launches"]
    return launches, report, tokens


# ---------------------------------------------------------------------------
# Phase 8: checkpoints and restarts
# ---------------------------------------------------------------------------

CKPT_LAYERS = 2                 # m6-base's widths at 2 layers: 567.4 M parameters


def bits(torch, t):
    """A tensor's bit patterns (an integer view), for bit-equality."""
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[
        t.element_size()])


def map_tensors(torch, tree, fn):
    """``tree`` (NamedTuples, dicts) with each tensor replaced by ``fn(t)``
    and every other leaf kept: ``torch.zeros_like`` makes a restore
    template no saved value can hide in, a clone a snapshot."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tensors(torch, v, fn) for v in tree))
    if isinstance(tree, dict):
        return {k: map_tensors(torch, v, fn) for k, v in tree.items()}
    return fn(tree.detach()) if isinstance(tree, torch.Tensor) else tree


def unequal_leaves(torch, a, b) -> list:
    """Keys of the leaves where two trees of one structure differ in any
    bit (tensors) or value (ints)."""
    from repro_torch.checkpoint import leaves

    return [k for (k, x), (_, y) in zip(leaves(a), leaves(b))
            if not (torch.equal(bits(torch, x), bits(torch, y))
                    if isinstance(x, torch.Tensor) else x == y)]


def max_param_diff(torch, a, b) -> float:
    """The largest |a - b| over two param trees' leaves (0.0: equal)."""
    from repro_torch.nn import flat_params

    fb = flat_params(b)
    with torch.no_grad():
        return max(float((t.float() - fb[k].float()).abs().max())
                   for k, t in flat_params(a).items())


def serving_tree(torch, cfg, trained):
    """The serving tree (``lm_shapes(cfg)``'s storage dtypes) of trained
    params, built in-process: each leaf cast as ``from_jax_params`` casts."""
    from repro_torch.configs.base import torch_dtype
    from repro_torch.nn import lm_shapes

    def cast(shapes, tree):
        if isinstance(shapes, dict):
            return {k: cast(v, tree[k]) for k, v in shapes.items()}
        return tree.detach().to(torch_dtype(shapes.dtype))

    return cast(lm_shapes(cfg), trained)


def tree_bytes(torch, tree) -> int:
    from repro_torch.checkpoint import leaves

    return sum(t.numel() * t.element_size() for _, t in leaves(tree)
               if isinstance(t, torch.Tensor))


def checkpoint_phase(torch, argv, device="cuda", layers=CKPT_LAYERS, requests=None,
                     max_len=256, root=None):
    """Phase 8, on a temporary directory under ``root`` (default the
    checkout's gitignored ``build/``) that is removed at its end.  The train
    CLI's loop (``repro_torch.launch.train.run``, the config cut to
    ``layers`` layers): 4 steps straight, twice (is the card's step
    bit-reproducible?); then 4 steps with ``--ckpt-every 2`` and a failure
    injected before step 3, so that ``run_with_restarts`` resumes from the
    checkpoint of step 2.  On the card every attempt's step is a CUDA graph
    from its second step on (its first the capture's warm-up): a straight
    run replays steps 1-3, the resumed attempt captures again over the
    restored leaves and replays step 3, so the resume is held under graphs.
    Gates: the step-2 checkpoint restores bit-equal
    to the state the loop held when it was taken; the resumed final params
    differ from a straight run's by no more than the two straight runs
    differ from each other; ``requests`` (default the 16-request trace)
    served from ``restore_params_latest`` give the greedy tokens of an
    engine built in-process from the trained params; the serving tree's
    bf16 params-only checkpoint round-trips bit-equal.  Measures a
    synchronous ``save`` of the final training state (seconds, GB/s) and
    ``save_async``'s snapshot.  Fails before writing if the disk lacks the
    bytes."""
    import shutil
    import tempfile
    from unittest import mock

    from repro_torch.checkpoint import Checkpointer, leaves
    from repro_torch.configs.base import ServeConfig
    from repro_torch.launch import train as train_mod
    from repro_torch.nn import count_params, init_params
    from repro_torch.serving.trace import synthetic_trace

    build_full = train_mod.build

    def build_cut(args):
        return build_full(args).replace(num_layers=layers)

    parse = train_mod.build_parser().parse_args
    base = argv + ["--steps", "4", "--device", device]
    cfg = build_cut(parse(base))
    n_params = count_params(cfg)
    ckpt_bytes = 12 * n_params + 4                 # f32 masters, mu and nu; the step
    root = Path(root or ROOT / "build")
    root.mkdir(parents=True, exist_ok=True)
    need = 2 * ckpt_bytes + 4 * n_params + (1 << 30)   # two kept, the serving tree, slack
    free = shutil.disk_usage(root).free
    if free < need:
        raise AssertionError(f"phase 8 needs {need} bytes free under {root}; {free} are")
    log(f"  m6-base widths at {layers} layers: {n_params} parameters, a training checkpoint "
        f"{ckpt_bytes / 1e9:.2f} GB; {free / 1e9:.1f} GB free under {root}")
    tmp = Path(tempfile.mkdtemp(prefix="ckpt-", dir=root))
    out = {"layers": layers, "parameters": n_params, "checkpoint_bytes": ckpt_bytes}
    try:
        with mock.patch.object(train_mod, "build", build_cut):
            straight = []
            for i in range(2):
                t0 = time.perf_counter()
                _, st = train_mod.run(parse(base))
                sync(torch, st.params["embed"]["table"])
                straight.append(st.params)
                log(f"  straight run {i + 1}: 4 steps (on the card steps 1-3 replay the step's "
                    f"CUDA graph), {time.perf_counter() - t0:.1f} s")
                del st
            d_straight = max_param_diff(torch, straight[0], straight[1])
            del straight[1]
            log(f"  two straight runs: largest parameter difference {d_straight:g} "
                f"({'bit-reproducible' if d_straight == 0 else 'not bit-reproducible'})")

            snapshot, failed = {}, []

            def probe(step, state):
                if step == 2 and not snapshot:      # what the step-2 checkpoint holds
                    snapshot["state"] = map_tensors(torch, state, torch.clone)
                if step == 3 and not failed:
                    failed.append(step)
                    raise RuntimeError("injected failure before step 3")

            ckpt_dir = tmp / "train"
            t0 = time.perf_counter()
            logs, resumed = train_mod.run(
                parse(base + ["--ckpt-dir", str(ckpt_dir), "--ckpt-every", "2",
                              "--max-restarts", "1"]), on_step=probe)
            sync(torch, resumed.params["embed"]["table"])
            run_s = time.perf_counter() - t0
        steps = [m["step"] for m in logs]
        if failed != [3] or steps != [0, 1, 2, 2, 3] or resumed.step != 4:
            raise AssertionError(f"restart: failures {failed}, logged steps {steps}, final "
                                 f"step {resumed.step}; want [3], [0, 1, 2, 2, 3], 4")
        ck = Checkpointer(str(ckpt_dir))
        if ck.all_steps() != [2, 4]:
            raise AssertionError(f"checkpoints {ck.all_steps()}, want [2, 4]")
        back = ck.restore(2, map_tensors(torch, resumed, torch.zeros_like))
        diff = unequal_leaves(torch, snapshot["state"], back)
        if diff:
            raise AssertionError(f"step-2 checkpoint: leaves not bit-equal to the state it "
                                 f"was taken from: {diff[:5]}")
        del back, snapshot
        d_resume = max_param_diff(torch, straight[0], resumed.params)
        log(f"  resumed run ({run_s:.1f} s; a failure before step 3, restarted from the "
            f"step-2 checkpoint, which restores bit-equal; the new attempt captured over the "
            f"restored leaves, step 2 its warm-up, step 3 a replay): largest parameter difference "
            f"from a straight run {d_resume:g} (two straight runs: {d_straight:g})")
        if d_resume > d_straight:
            raise AssertionError(f"resumed params differ by {d_resume:g} from a straight run's, "
                                 f"more than two straight runs differ ({d_straight:g})")
        out.update(straight_runs_max_diff=d_straight, resumed_max_diff=d_resume)

        # a training checkpoint's save times (the final state: masters, mu, nu, step)
        nbytes = tree_bytes(torch, resumed) + 4
        ck_t = Checkpointer(str(tmp / "timing"), keep=1)
        t0 = time.perf_counter()
        ck_t.save_async(1, resumed)
        snapshot_s = time.perf_counter() - t0
        ck_t.wait()
        async_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ck_t.save(2, resumed)
        save_s = time.perf_counter() - t0
        shutil.rmtree(tmp / "timing")
        log(f"  save of a training checkpoint ({nbytes / 1e9:.2f} GB): {save_s:.2f} s, "
            f"{nbytes / save_s / 1e9:.2f} GB/s; save_async's snapshot (device to host) "
            f"{snapshot_s:.2f} s, its files written {async_s:.2f} s after the call")
        out.update(save_s=save_s, save_gb_per_s=nbytes / save_s / 1e9,
                   save_async_snapshot_s=snapshot_s, save_async_written_s=async_s)

        # serving: from the checkpoint, and from the trained params in-process
        scfg = cfg.replace_moe(impl="dropless", capacity_factor=None)
        requests = requests or synthetic_trace(16, scfg.vocab_size, seed=0)
        serve = ServeConfig(max_len=max(max_len, max(r.total_len for r in requests)))
        params, step = ck.restore_params_latest(init_params(scfg, seed=1, device=device))
        got, _, _, _ = serve_once(torch, scfg, params, serve, requests, device=device)
        want, _, _, _ = serve_once(torch, scfg, serving_tree(torch, scfg, resumed.params),
                                   serve, requests, device=device)
        del resumed, straight
        same = sum(got[r.uid] == want[r.uid] for r in requests)
        if step != 4 or same != len(requests):
            raise AssertionError(f"served from checkpoint step {step}: {same} of "
                                 f"{len(requests)} requests' greedy tokens equal the "
                                 f"in-process engine's")
        log(f"  restored params-only from checkpoint step {step}: the {len(requests)} requests' "
            f"greedy tokens equal those of an engine built from the trained params")
        shutil.rmtree(ckpt_dir)

        # the serving tree (bf16 matmul weights) as a params-only checkpoint
        ck_s = Checkpointer(str(tmp / "serve"))
        ck_s.save(1, params)
        back = ck_s.restore(1, map_tensors(torch, params, torch.zeros_like))
        n_bf16 = sum(t.dtype == torch.bfloat16 for _, t in leaves(params))
        diff = unequal_leaves(torch, params, back)
        if diff or (scfg.dtype == "bfloat16" and n_bf16 == 0):
            raise AssertionError(f"serving tree round trip: {n_bf16} bf16 leaves; not "
                                 f"bit-equal: {diff[:5]}")
        log(f"  the serving tree ({n_bf16} bf16 of {len(leaves(params))} leaves, "
            f"{tree_bytes(torch, params) / 1e9:.2f} GB) round-trips bit-equal")
        out.update(served_requests=len(requests), serving_tree_bf16_leaves=n_bf16)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# Phase 9: speculative and sampled serving
# ---------------------------------------------------------------------------

SPEC_GAMMA = 4
SAMPLE_T = 0.8
SAMPLE_T_LOW = 0.05             # peaked enough that the model drafter's drafts are accepted
RANDOM_DRAFTER = "chip-smoke-random"


class RandomDrafter:
    """Proposes ``max_tokens`` seeded random ids every round, so nearly every
    draft is rejected and rolled back."""

    name = RANDOM_DRAFTER

    def __init__(self, spec, target_cfg, serve, *, seed=0, draft_model=None, device="cuda"):
        import numpy as np

        self.rng = np.random.default_rng(seed + 0xD4AF7)
        self.vocab = target_cfg.vocab_size

    def propose(self, items):
        return [self.rng.integers(0, self.vocab, it.max_tokens).astype("int32") for it in items]


def logit_tie(margin: float, top: float) -> bool:
    """A top-two gap that two logits, each moved by the kernels-vs-plain
    tolerance (TOL + TOL x |logit|), can close."""
    return margin <= 2 * (TOL + TOL * abs(top))


def tapped_margins(torch, cfg, params, serve, requests, device="cuda", **kw):
    """A non-speculative run with ``logit_tap``: ({uid: tokens}, {(uid,
    position): (top-two logit gap, top logit)}) over every live row;
    ``kw`` goes to the engine."""
    import numpy as np

    V = cfg.vocab_size
    margins, holder = {}, []

    def tap(lg, slots, pos, lens):
        running = holder[0].scheduler.running
        for i in np.flatnonzero(lens > 0):
            top2 = np.partition(lg[i, :V], V - 2)[V - 2:]
            margins[running[int(slots[i])].request.uid, int(pos[i])] = (
                float(top2[1] - top2[0]), float(top2[1]))

    from repro_torch.serving.continuous import ContinuousEngine

    eng = ContinuousEngine(cfg, params, serve, device=device, logit_tap=tap, **kw)
    holder.append(eng)
    out, _ = eng.run(requests)
    check_census(eng, "tapped run")
    return out, margins


def divergences(base, other, margin, label):
    """Keys (requests, rows) whose tokens in ``other`` differ from
    ``base``: each must first differ where the base run's top two logits
    are a near-tie (``logit_tie``), ``margin(key, token index)`` giving
    (their gap, the top logit); reported with the gap.  Returns [(key,
    index, gap)]."""
    out = []
    for key in sorted(base):
        a, b = list(base[key]), list(other[key])
        if a == b:
            continue
        p = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        gap, top = margin(key, p)
        out.append((key, p, gap))
        log(f"  {label}: #{key} first differs at generated token {p} ({a[p]} in the base run, "
            f"{b[p]} here): the base run's top-two logit gap {gap:.4g} (top logit {top:.4g})")
        if not logit_tie(gap, top):
            raise AssertionError(f"{label}: #{key} differs at token {p} where the top two "
                                 f"logits are {gap} apart, not a near-tie")
    return out


def first_divergences(base, other, margins, requests, label):
    """``divergences`` of requests, ``margins`` keyed by (uid, position)
    from the base run's ``logit_tap``."""
    plen = {r.uid: r.prompt_len for r in requests}
    return divergences(base, other, lambda uid, p: margins[uid, plen[uid] - 1 + p], label)


@contextmanager
def recorded_acceptance(store: list):
    """Record every slot's (drafts, accepted drafts, emitted) of every
    verify step."""
    from unittest import mock

    from repro_torch.serving import continuous

    real_g, real_r = continuous.accept_greedy_ids, continuous.accept_rejection

    def greedy(d, rows):
        emitted, n = real_g(d, rows)
        store.append((len(d), n, len(emitted)))
        return emitted, n

    def rejection(d, rows, t, rng):
        emitted, n = real_r(d, rows, t, rng)
        store.append((len(d), n, len(emitted)))
        return emitted, n

    with mock.patch.object(continuous, "accept_greedy_ids", greedy), \
            mock.patch.object(continuous, "accept_rejection", rejection):
        yield


@contextmanager
def recorded_ffn_shapes(store: dict):
    """Count the grouped-FFN calls of the MoE layers by shape: ("ragged_ffn",
    rows, block rows) of the dropless dispatcher's kernel and ("moe_ffn",
    E, X, M) of the capacity dispatchers'.  The callers' handles are
    swapped, not the kernel modules' wrappers, whose launch counters stay
    in place.  These are Python calls: an engine that captures its step
    forms makes a form's once a layer at its warm-up and once at its
    capture, and none at a replay (the launch counters count replays)."""
    from types import SimpleNamespace
    from unittest import mock

    import repro_torch.kernels.moe_ffn as moe_pkg
    from repro_torch.core.dispatch import dropless

    real_ragged = dropless.dropless_ops.ragged_ffn
    real_moe = moe_pkg.moe_ffn

    def count(key):
        store[key] = store.get(key, 0) + 1

    def ragged(x, be, *args, block_x=128, **kw):
        count(("ragged_ffn", int(x.shape[0]), int(block_x)))
        return real_ragged(x, be, *args, block_x=block_x, **kw)

    def moe(x, *args, **kw):
        count(("moe_ffn", *map(int, x.shape)))
        return real_moe(x, *args, **kw)

    with mock.patch.object(dropless, "dropless_ops", SimpleNamespace(ragged_ffn=ragged)), \
            mock.patch.object(moe_pkg, "moe_ffn", moe):
        yield


def spec_run(torch, cfg, params, serve, requests, device, **kw):
    """One speculative run with the kernels' launch counters reset just
    before it and read just after: (tokens, stats, engine, wall ms,
    launches, per-slot acceptances, ragged FFN shapes)."""
    from repro_torch.kernels.decode_attention import ops as pda
    from repro_torch.kernels.moe_dropless import combine
    from repro_torch.kernels.moe_dropless import ops as rffn

    counters = {"paged_decode_attention": pda.paged_decode_attention,
                "quantized_paged_decode_attention": pda.quantized_paged_decode_attention,
                "ragged_ffn": rffn.ragged_ffn, "ragged_combine": combine.ragged_combine}
    for fn in counters.values():
        fn.launches = 0
    rffn.ragged_ffn.tc_launches = 0
    accepts, shapes = [], {}
    with recorded_acceptance(accepts), recorded_ffn_shapes(shapes):
        out, stats, eng, wall_ms = serve_once(torch, cfg, params, serve, requests, device,
                                              check_invariants=True, **kw)
    launches = {n: fn.launches for n, fn in counters.items()}
    launches["ragged_ffn tensor cores"] = rffn.ragged_ffn.tc_launches
    return out, stats, eng, wall_ms, launches, accepts, shapes


def spec_report(stats, eng, wall_ms, accepts) -> dict:
    return dict(tokens_per_s=stats["generated_tokens_per_s"], p50_ms=stats["p50_ms"],
                p95_ms=stats["p95_ms"], steps=eng.steps, mean_step_ms=wall_ms / eng.steps,
                verify_steps=eng.spec_stats["verify_steps"],
                spec_acceptance_rate=stats.get("acceptance_rate"),
                spec_tokens_per_step=stats.get("spec_tokens_per_step"),
                max_accepted_in_a_step=max((n for _, n, _ in accepts), default=0),
                partial_acceptances=sum(0 < n < d for d, n, _ in accepts))


def spec_serving_runs(torch, cfg, params, requests, base_tokens, int8_tokens, device="cuda",
                      max_len=256, gamma=SPEC_GAMMA):
    """Phase 9 (a) and (b): greedy speculative decoding with the ngram, model
    (the target's own weights) and random drafters over bf16 pools, then
    ngram over int8 pools; each held to the non-speculative tokens."""
    import dataclasses

    from repro_torch.configs.base import ServeConfig, SpecConfig
    from repro_torch.serving.speculative import available_drafters, register_drafter
    from repro_torch.serving.trace import latency_line

    if RANDOM_DRAFTER not in available_drafters():
        register_drafter(RandomDrafter)
    on_card = torch.device(device).type == "cuda"
    serve = ServeConfig(max_len=max(max_len, max(r.total_len for r in requests)))
    ref, margins = {}, {}
    for kv, base in (("none", base_tokens), ("int8", int8_tokens)):
        ref[kv], margins[kv] = tapped_margins(torch, cfg, params,
                                              dataclasses.replace(serve, kv_quant=kv),
                                              requests, device)
        if ref[kv] != base:
            raise AssertionError(f"kv_quant {kv}: a second non-speculative run gave other "
                                 f"tokens than the first")
    report = {}
    for drafter, kv in (("ngram", "none"), ("model", "none"), (RANDOM_DRAFTER, "none"),
                        ("ngram", "int8")):
        label = f"{drafter} over {'bf16' if kv == 'none' else kv} pools"
        sv = dataclasses.replace(serve, kv_quant=kv,
                                 spec=SpecConfig(drafter=drafter, gamma=gamma))
        dm = (cfg, params) if drafter == "model" else None
        clocks = []
        with recorded_clocks(clocks):
            out, stats, eng, wall_ms, launches, accepts, shapes = spec_run(
                torch, cfg, params, sv, requests, device, draft_model=dm)
        want = cfg.num_layers * eng.steps
        attn = "paged_decode_attention" if kv == "none" else "quantized_paged_decode_attention"
        other = "quantized_paged_decode_attention" if kv == "none" else "paged_decode_attention"
        if on_card and (launches[attn] != want or launches[other]):
            raise AssertionError(f"{label}: launches {launches}, expected {attn} {want} = "
                                 f"layers x steps and {other} 0")
        if on_card and launches["ragged_ffn tensor cores"] != launches["ragged_ffn"]:
            raise AssertionError(f"{label}: {launches['ragged_ffn tensor cores']} of "
                                 f"{launches['ragged_ffn']} ragged_ffn launches on the "
                                 f"tensor-core route")
        if on_card and launches["ragged_combine"] != launches["ragged_ffn"]:
            raise AssertionError(f"{label}: ragged_combine launched {launches['ragged_combine']} "
                                 f"times, ragged_ffn {launches['ragged_ffn']}")
        if stats["moe_dropped_fraction"] != 0.0:
            raise AssertionError(f"{label}: dropped fraction {stats['moe_dropped_fraction']}")
        rep = spec_report(stats, eng, wall_ms, accepts)
        if rep["verify_steps"] <= 0:
            raise AssertionError(f"{label}: no verify step ran")
        if drafter == "model" and rep["max_accepted_in_a_step"] < 2:
            raise AssertionError(f"{label}: no verify step accepted 2 or more drafts")
        rep["divergences"] = first_divergences(ref[kv], out, margins[kv], requests, label)
        rep["token_match"] = token_match(ref[kv], out)
        rep["launches"] = launches
        rep["graph_pool_bytes"] = eng.graph_pool_bytes
        if drafter == "model":
            rep["eager"] = model_drafter_eager(torch, cfg, params, sv, requests, device, out,
                                               launches, clocks, rep, label)
        rep["ragged_ffn_shapes"] = {f"{n} rows, bx {bx}": c for (kind, n, bx), c in shapes.items()
                                    if kind == "ragged_ffn"}
        log(f"  {label}: {latency_line(stats)}; {eng.steps} steps ({rep['verify_steps']} "
            f"verify), mean step {rep['mean_step_ms']:.3f} ms (host clock); acceptance "
            f"{rep['spec_acceptance_rate']:.3f}, {rep['spec_tokens_per_step']:.3f} tokens a "
            f"verify step, at most {rep['max_accepted_in_a_step']} drafts accepted in one "
            f"step; token match {rep['token_match']:.4f}; launches {launches}; ragged FFN "
            f"Python calls by shape (the graphed forms' warm-ups and captures, the model "
            f"drafter's among them) {rep['ragged_ffn_shapes']}; graphs' pool "
            f"{rep['graph_pool_bytes'] / 2**20:.2f} MiB")
        report[label] = rep
    return report


def model_drafter_eager(torch, cfg, params, serve, requests, device, tokens, launches, clocks,
                        rep, label):
    """The model-drafter run again with ``graphs=False`` (the engine's steps
    and the drafter's forwards eager), stepped at the graphed run's
    ``clocks`` (``replay``: the same admissions, so the same rows and
    drafts at every step): greedy tokens identical to the graphed run's
    ``tokens`` and the same ``launches``; returns its step ms and tokens/s
    beside the graphed run's ``rep``."""
    from repro_torch.serving.continuous import ContinuousEngine

    eng = ContinuousEngine(cfg, params, serve, device=device, draft_model=(cfg, params),
                           graphs=False, check_invariants=True)
    got = {}
    with counted_launches(got):
        out, wall_ms = replay(torch, eng, requests, clocks)
    got = {k: got[k] for k in ("paged_decode_attention", "quantized_paged_decode_attention",
                               "ragged_ffn", "ragged_combine")} | {
        "ragged_ffn tensor cores": got["ragged_ffn tc"]}
    if out != tokens:
        bad = [u for u in tokens if out[u] != tokens[u]]
        raise AssertionError(f"{label}: graphs=False gave other greedy tokens for requests {bad}")
    if got != launches:
        raise AssertionError(f"{label}: graphs=False launched {got}, graphed {launches}")
    if eng.drafter.form.graph is not None:
        raise AssertionError(f"{label}: graphs=False captured the drafter")
    n = sum(len(t) for t in out.values())
    eager = dict(steps=len(clocks), mean_step_ms=wall_ms / len(clocks),
                 tokens_per_s=n / (wall_ms / 1e3), run_s=wall_ms / 1e3,
                 verify_steps=eng.spec_stats["verify_steps"])
    log(f"  {label}, graphs=False at the graphed run's {len(clocks)} step clocks "
        f"({wall_ms / 1e3:.1f} s): mean step {eager['mean_step_ms']:.3f} ms against "
        f"{rep['mean_step_ms']:.3f} graphed, {eager['tokens_per_s']:.1f} tokens/s against "
        f"{n / (rep['mean_step_ms'] * rep['steps'] / 1e3):.1f} over the same steps "
        f"({eager['verify_steps']} verify); greedy tokens and launches identical")
    return eager


DRAFT_CONTEXTS = ((10, 4), (300, 4), (57, 2), (1, 1), (200, 3))   # (length, budget)


def drafter_proposals(torch, cfg, params, serve, device, gamma, seed=160):
    """The model drafter captured on a pool of its own against one that
    runs its forwards eagerly, on one fixed set of contexts (mixed lengths,
    one past ``max_len``, budgets under ``gamma``, idle rows): proposals
    identical and the same launches, counted through the replay; then a
    proposal's host ms each way."""
    import numpy as np

    from repro_torch.configs.base import SpecConfig
    from repro_torch.kernels import counters
    from repro_torch.serving.speculative.base import DraftItem
    from repro_torch.serving.speculative.model import ModelDrafter

    t_start = time.perf_counter()
    spec = SpecConfig(drafter="model", gamma=gamma)
    rng = np.random.default_rng(seed)
    items = [DraftItem(slot=i, context=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                       max_tokens=m) for i, (n, m) in enumerate(DRAFT_CONTEXTS)]
    out = {}
    for graphs in (True, False):
        d = ModelDrafter(spec, cfg, serve, draft_model=(cfg, params), device=device)
        if graphs and torch.device(device).type == "cuda":
            d.capture(torch.cuda.graph_pool_handle())
        before = counters.read()
        got = d.propose(items)
        n = counters.since(before)
        sync(torch, params["embed"]["table"])
        t0 = time.perf_counter()
        for _ in range(5):
            d.propose(items)
        ms = (time.perf_counter() - t0) / 5 * 1e3
        out[graphs] = ([g.tolist() for g in got], n, ms, d.graph_bytes)
        del d
    (g, gn, gms, pool), (e, en, ems, _) = out[True], out[False]
    if g != e or gn != en:
        raise AssertionError(f"model drafter proposals: graphed {g} (launches {gn}), eager {e} "
                             f"(launches {en})")
    if [len(p) for p in g] != [m for _, m in DRAFT_CONTEXTS]:
        raise AssertionError(f"model drafter proposals of lengths {[len(p) for p in g]}")
    log(f"  model drafter on {len(DRAFT_CONTEXTS)} fixed contexts of {serve.max_slots} rows: "
        f"proposals and launches identical graphed and eager; a proposal {gms:.2f} ms graphed "
        f"against {ems:.2f} ms eager (host clock, with the read); its graph's pool "
        f"{pool / 2**20:.2f} MiB; {time.perf_counter() - t_start:.1f} s")
    return dict(contexts=len(DRAFT_CONTEXTS), identical=True, graphed_ms=gms, eager_ms=ems,
                graph_pool_bytes=pool)


def sampler_checks(torch, device="cuda", T=SAMPLE_T, seed=5):
    """Phase 9 (c), the sampler alone: over fixed f32 logits, the tokens
    ``_sample_rows`` draws on ``device`` for 4096 (slot, position) keys
    against the CPU's (the integer uniforms must be equal; a token may
    differ only at a near-tie of the perturbed scores), and a 20 000-key
    frequency test against softmax(logits / T) at atol 0.015, the
    reference's own bound."""
    import numpy as np

    from repro_torch.serving.continuous import _row_uniforms, _sample_rows

    rng = np.random.default_rng(21)
    logits = (rng.standard_normal((4096, 1024)) * 2.0).astype(np.float32)
    slots = rng.integers(0, 8, 4096)
    pos = rng.permutation(4096)
    lg_dev = torch.from_numpy(logits).to(device)
    u_dev = _row_uniforms(seed, slots, pos, 1024, torch.device(device)).cpu()
    u_cpu = _row_uniforms(seed, slots, pos, 1024, torch.device("cpu"))
    if not torch.equal(u_dev, u_cpu):
        raise AssertionError("the sampler's uniforms differ between the card and the CPU")
    got = _sample_rows(lg_dev, slots, pos, T, seed).cpu()
    want = _sample_rows(torch.from_numpy(logits), slots, pos, T, seed)
    t = torch.tensor(T, dtype=torch.float32)
    scores = (torch.from_numpy(logits) / t).double() - torch.log(-torch.log(u_cpu))
    ties = 0
    for r in torch.nonzero(got != want).flatten().tolist():
        a, b = float(scores[r, got[r]]), float(scores[r, want[r]])
        if abs(a - b) > 1e-9 * max(1.0, abs(b)):
            raise AssertionError(f"sampled token differs from the CPU's at key {r}: scores "
                                 f"{a} and {b} are no near-tie")
        ties += 1
    V = 6
    probe = (rng.standard_normal((1, V)) * 2.0).astype(np.float32)
    n = 20_000
    keys = np.arange(n)
    draws = _sample_rows(torch.from_numpy(np.repeat(probe, n, 0)).to(device), keys % 8,
                         keys // 8, T, seed).cpu().numpy()
    z = probe[0].astype(np.float64) / T
    p = np.exp(z - z.max())
    p /= p.sum()
    freq = np.bincount(draws, minlength=V) / n
    err = float(np.abs(freq - p).max())
    log(f"  sampler: 4096 keys over 1024 logits, the card's tokens equal the CPU's on "
        f"{4096 - ties} ({ties} near-tie differences); frequencies of {n} draws within "
        f"{err:.4f} of softmax(logits / {T}) (bound 0.015)")
    if err > 0.015:
        raise AssertionError(f"sampled frequencies {err} off softmax(logits / T) (> 0.015)")
    return dict(keys=4096, near_tie_differences=ties, frequency_max_err=err)


def sampled_serving_runs(torch, cfg, params, requests, device="cuda", max_len=256,
                         T=SAMPLE_T, T_low=SAMPLE_T_LOW, seed=7, gamma=SPEC_GAMMA):
    """Phase 9 (c), served: the trace greedy (the step-time baseline), at
    temperature T without speculation, with ngram and with the model
    drafter (which always drafts, so its verify steps run the host's
    rejection sampling), and at the low temperature ``T_low`` with the
    model drafter, where drafts must be accepted (multi-token emissions of
    ``accept_rejection``, rollback after a partial acceptance); each run
    twice with one seed, the two runs must give the same tokens, every id
    in the vocab.  Every request arrives at t = 0: admission then does not
    hang on the host's clock, so each request gets the same slot in both
    runs, and with it the same sampling keys (seed, slot, position)."""
    import dataclasses

    from repro_torch.configs.base import ServeConfig, SpecConfig
    from repro_torch.serving.trace import latency_line

    requests = [dataclasses.replace(r, arrival_ms=0.0) for r in requests]
    serve = ServeConfig(max_len=max(max_len, max(r.total_len for r in requests)))
    report = {}
    for t, drafter in ((0.0, None), (T, None), (T, "ngram"), (T, "model"), (T_low, "model")):
        label = (f"T = {t}, " if t else "greedy, ") + (drafter or "no speculation")
        sv = serve if drafter is None else dataclasses.replace(
            serve, spec=SpecConfig(drafter=drafter, gamma=gamma))
        dm = (cfg, params) if drafter == "model" else None
        runs = [spec_run(torch, cfg, params, sv, requests, device, temperature=t, seed=seed,
                         draft_model=dm) for _ in range(2)]
        (out, stats, eng, wall_ms, _, accepts, _), (again, *_) = runs
        if out != again:
            raise AssertionError(f"{label}: two runs with one seed gave other tokens")
        bad = [tok for v in out.values() for tok in v if not 0 <= tok < cfg.vocab_size]
        if bad:
            raise AssertionError(f"{label}: sampled ids outside the vocab: {bad[:8]}")
        if drafter == "model" and eng.spec_stats["verify_steps"] <= 0:
            raise AssertionError(f"{label}: no verify step ran")
        rep = spec_report(stats, eng, wall_ms, accepts) if drafter else dict(
            tokens_per_s=stats["generated_tokens_per_s"], p50_ms=stats["p50_ms"],
            p95_ms=stats["p95_ms"], steps=eng.steps, mean_step_ms=wall_ms / eng.steps)
        if t == T_low and (eng.spec_stats["accepted"] <= 0
                           or not any(e >= 2 for _, _, e in accepts)):
            raise AssertionError(f"{label}: no draft accepted, or no verify step emitted 2 or "
                                 f"more tokens ({eng.spec_stats})")
        log(f"  {label}: {latency_line(stats)}; {eng.steps} steps, mean step "
            f"{rep['mean_step_ms']:.3f} ms (host clock)"
            + (f"; {rep['verify_steps']} verify steps, acceptance "
               f"{rep['spec_acceptance_rate']:.3f}, {rep['spec_tokens_per_step']:.3f} tokens "
               f"a verify step, {rep['partial_acceptances']} partial acceptances"
               if drafter else "")
            + "; the second run's tokens equal the first's")
        report[label] = rep
    return report


def verify_attention_case(slot_lens, drafts, seed, name=None):
    """The verify step's attention at m6 widths: 8 slots of context c, each
    with its g + 1 rows of lengths c + 1 .. c + g + 1 sharing the slot's
    block table, the other rows of its gamma + 1 length 0; bf16 pools, or
    their int8 codes and scales (``name``).  (q, pools..., tables, lengths)
    in the wrapper's order."""
    import torch

    W = SPEC_GAMMA + 1
    q8, kp, vp, tables, _ = attention_case(len(slot_lens), 16, 16, 64, 16, 16,
                                           [c + g + 1 for c, g in zip(slot_lens, drafts)],
                                           seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    q = torch.randn((len(slot_lens) * W, 16, 64), generator=g, device="cuda").to(q8.dtype)
    lens = [c + j + 1 if j <= d else 0 for c, d in zip(slot_lens, drafts) for j in range(W)]
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    tables = tables.repeat_interleave(W, 0).contiguous()
    if name is None:
        return q, kp, vp, tables, lengths
    kc, ks, vc, vs = quantize_pools(kp, vp, name)
    return q, kc, vc, ks, vs, tables, lengths


def verify_attention_bound(q, pool, lengths, quantized):
    """q read and out written once; each slot's K/V positions once (its
    rows share them), with one K and one V scale per (block, head) when
    quantized; the tables and lengths.  Flops over every row's length."""
    N, Hq, D = q.shape
    Hkv, bs = pool.shape[1], pool.shape[2]
    W = SPEC_GAMMA + 1
    per_slot = lengths.reshape(-1, W).amax(dim=1).float()
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * float(per_slot.sum()) * Hkv * D * pool.element_size()
              + N * 16 * 4 + N * 4)
    if quantized:
        nbytes += 2 * float(((per_slot + bs - 1) // bs).sum()) * Hkv * 4
    return roofline(nbytes, 4.0 * Hq * D * float(lengths.sum()))


def time_verify_attention(torch, name=None, seed=130):
    """Kernel, plain and library times of the paged (bf16) or quantized
    (int8) kernel at the verify step's shape, 40 rows over 16 rotating
    copies, after holding the kernel against its plain version (length-0
    rows exactly 0)."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.decode_attention.ref import (
        paged_decode_attention_ref,
        quantized_paged_decode_attention_ref,
    )
    from repro_torch.quant import get_kv_quant

    slot_lens, drafts = [21, 56, 112, 9, 74, 33, 98, 47], [4, 4, 2, 0, 4, 1, 4, 3]
    copies = [verify_attention_case(slot_lens, drafts, seed + c, name) for c in range(16)]
    if name is None:
        def call(c):                    # the engine's plan: static shapes
            return da.paged_decode_attention(*c)

        def plain(c):
            return paged_decode_attention_ref(*c)
    else:
        pol = get_kv_quant(name)

        def call(c):
            return da.quantized_paged_decode_attention(*c, policy=pol)

        def plain(c):
            return quantized_paged_decode_attention_ref(*c, policy=pol)

    c0 = copies[0]
    q, pool, tables, lengths = c0[0], c0[1], c0[-2], c0[-1]
    got = call(c0)
    err = check_close(f"verify shape, {'bf16' if name is None else name} pools", got, plain(c0))
    if (got[lengths == 0] != 0).any():
        raise AssertionError("verify shape: a length-0 row's output is not exactly 0")
    bound, by = verify_attention_bound(q, pool, lengths, name is not None)
    it = iter(range(1 << 30))
    k_ms = cuda_ms(lambda: call(copies[next(it) % 16]))
    k_dev = device_ms(lambda: call(copies[next(it) % 16]), bound_ms=bound)
    p_ms = cuda_ms(lambda: plain(copies[next(it) % 16]))
    N, Hq, D = q.shape
    Hkv, bs, MB = pool.shape[1], pool.shape[2], tables.shape[1]
    tbl = tables.long()
    if name is None:
        kk, vv = c0[1][tbl], c0[2][tbl]
    else:
        kk = (pol.decode(c0[1][tbl]) * c0[3][tbl][..., None, None]).to(q.dtype)
        vv = (pol.decode(c0[2][tbl]) * c0[4][tbl][..., None, None]).to(q.dtype)
    kk = kk.permute(0, 2, 1, 3, 4).reshape(N, Hkv, MB * bs, D)
    vv = vv.permute(0, 2, 1, 3, 4).reshape(N, Hkv, MB * bs, D)
    mask = (torch.arange(MB * bs, device="cuda")[None, :] < lengths[:, None])[:, None, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(q[:, :, None, :], kk, vv, attn_mask=mask)

    return dict(ms=k_ms, device_ms=k_dev, plain_ms=p_ms, library_ms=cuda_ms(sdpa),
                library_device_ms=device_ms(sdpa, bound_ms=bound), bound_ms=bound, bound_by=by,
                max_abs_err=err, plan=da.launch_plan(q, pool, tables))


def phase_spec(torch, base_tokens, int8_tokens, e2e, kv):
    """Phase 9: m6-base speculative and sampled serving, phase 5's weights
    and trace."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.configs.m6 import M6_BASE
    from repro_torch.nn import init_params
    from repro_torch.serving.trace import synthetic_trace

    log("phase 9: m6-base speculative and sampled serving")
    cfg = M6_BASE.replace_moe(impl="dropless", capacity_factor=None)
    params = init_params(cfg, seed=0, device="cuda")            # phase 5's weights
    requests = synthetic_trace(16, cfg.vocab_size, seed=0)
    report = {"greedy": spec_serving_runs(torch, cfg, params, requests, base_tokens,
                                          int8_tokens)}
    report["drafter_proposals"] = drafter_proposals(torch, cfg, params,
                                                    ServeConfig(max_len=256), "cuda", SPEC_GAMMA)
    report["sampler"] = sampler_checks(torch)
    report["sampled"] = sampled_serving_runs(torch, cfg, params, requests)
    log(f"  phase 5 (no speculation, bf16 pools): {e2e['tokens_per_s']:.1f} tokens/s, mean "
        f"step {e2e['mean_step_ms']:.3f} ms, p50 {e2e['p50_ms']:.0f} ms, p95 "
        f"{e2e['p95_ms']:.0f} ms, {e2e['steps']} steps; phase 7 int8 "
        f"{kv['int8']['tokens_per_s']:.1f} tokens/s, mean step "
        f"{kv['int8']['mean_step_ms']:.3f} ms")
    timing = {"paged_decode_attention": time_verify_attention(torch),
              "quantized_paged_decode_attention": time_verify_attention(torch, "int8"),
              "ragged_ffn": time_ffn(torch, 8 * (SPEC_GAMMA + 1), seed=140, weights=None)}
    timing["ragged_ffn model drafter"] = time_ffn(torch, 1024, seed=150, weights=None,
                                                  groups=2)
    for name, r in timing.items():
        log(f"  verify shape {name}: {timing_line(r)}")
    report["timing"] = timing
    return report


# ---------------------------------------------------------------------------
# Phase 10: SLO scheduling (priority, EDF and cache-aware admission,
# preemption with KV swap-to-host, deadline shedding)
# ---------------------------------------------------------------------------

# the reference benchmark's slo_sweep cell (benchmarks/serve_throughput.py:
# 226-257): short HIGH requests against long NORMAL/LOW ones, two tenants'
# 16-token system prompts, 4 slots over 28 blocks (slots, not blocks, bind)
SLO_TRACE = dict(prompt_lens=(8, 24), gen_lens=(16, 32, 64),
                 class_weights=(0.125, 0.5, 0.375), burst_len=8, system_prompt_len=16,
                 num_tenants=2)
SLO_SERVE = dict(max_slots=4, kv_block_size=16, prefill_chunk=16, num_blocks=28,
                 prefix_cache=True)
SLO_HOST_BLOCKS = 56              # 2 x 28: several victims' working sets at once
SLO_REQUESTS = 48                 # the reference's 128, cut to the phase's time
# the reference's seed 0 puts 2 HIGH requests in its first 48 (0.125 x 48 =
# 6 expected); seed 9 is the first whose 48 hold the class weights' expected
# counts, 6 / 24 / 18
SLO_SEED = 9
SLO_LAYERS = 2                    # m6-base's widths at 2 of its 5 layers (the script's time)
SLO_POLICIES = ("fcfs", "priority_strict", "edf", "cache_aware")


def slo_trace(n, vocab, seed, qps, burst_qps=None, **kw):
    """``synthetic_priority`` with the slo_sweep cell's shapes."""
    from repro_torch.serving.request import Priority
    from repro_torch.serving.trace import synthetic_priority

    args = dict(SLO_TRACE, gen_lens_by_class={Priority.HIGH: (4, 8)})
    args.update(kw)
    return synthetic_priority(n, vocab, seed=seed, qps=qps, burst_qps=burst_qps, **args)


def slo_run(torch, cfg, params, serve, requests, device, label, on_finish=None, **engine_kw):
    """One run through ``ContinuousEngine.run`` with the serving kernels'
    launch counters set to 0 just before it and read just after, conservation
    checked after every step, and every live row's top-two logit gap recorded
    through ``logit_tap`` (every run carries the same tap).  Gates: every
    request that was not shed finishes its budget, dropped fraction 0.0, the
    attention kernel of the pools launched layers x steps times (the other
    never) and every ragged FFN launch on the tensor cores.  Returns (tokens,
    stats, engine, wall ms, launches, margins, finished states); ``on_finish``
    sees each finished or shed state as the engine hands it back."""
    import numpy as np

    from repro_torch.kernels.decode_attention import ops as pda
    from repro_torch.kernels.moe_dropless import combine
    from repro_torch.kernels.moe_dropless import ops as rffn
    from repro_torch.serving.continuous import ContinuousEngine
    from repro_torch.serving.request import Status

    V = cfg.vocab_size
    margins, holder, done = {}, [], []

    def tap(lg, slots, pos, lens):
        running = holder[0].scheduler.running
        rows = np.flatnonzero(lens > 0)
        top2 = np.partition(lg[rows, :V], V - 2, axis=1)[:, V - 2:]
        for i, (a, b) in zip(rows, top2):
            margins[running[int(slots[i])].request.uid, int(pos[i])] = (float(b - a), float(b))

    counters = {"paged_decode_attention": pda.paged_decode_attention,
                "quantized_paged_decode_attention": pda.quantized_paged_decode_attention,
                "ragged_ffn": rffn.ragged_ffn, "ragged_combine": combine.ragged_combine}
    eng = ContinuousEngine(cfg, params, serve, device=device, logit_tap=tap,
                           check_invariants=True, **engine_kw)
    holder.append(eng)

    def finished(st):
        done.append(st)
        if on_finish is not None:
            on_finish(eng, st)

    for fn in counters.values():
        fn.launches = 0
    rffn.ragged_ffn.tc_launches = 0
    table = params["embed"]["table"]
    sync(torch, table)
    t0 = time.perf_counter()
    out, stats = eng.run(requests, on_finish=finished)
    on_card = sync(torch, table)
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = {n: fn.launches for n, fn in counters.items()}
    launches["ragged_ffn tensor cores"] = rffn.ragged_ffn.tc_launches
    shed = {st.request.uid for st in done if st.status is Status.SHED}
    for r in requests:
        want = 0 if r.uid in shed else r.max_new_tokens
        if len(out[r.uid]) != want:
            raise AssertionError(f"{label}: request {r.uid}: {len(out[r.uid])} tokens, "
                                 f"expected {want}")
    if stats["moe_dropped_fraction"] != 0.0:
        raise AssertionError(f"{label}: dropped fraction {stats['moe_dropped_fraction']}")
    want = cfg.num_layers * eng.steps
    attn, other = (("paged_decode_attention", "quantized_paged_decode_attention")
                   if serve.kv_quant == "none" else
                   ("quantized_paged_decode_attention", "paged_decode_attention"))
    if on_card and (launches[attn] != want or launches["ragged_ffn"] != want
                    or launches["ragged_combine"] != want or launches[other]):
        raise AssertionError(f"{label}: launches {launches}, expected {attn}, ragged_ffn and "
                             f"ragged_combine {want} = layers x steps, {other} 0")
    if on_card and launches["ragged_ffn tensor cores"] != launches["ragged_ffn"]:
        raise AssertionError(f"{label}: {launches['ragged_ffn tensor cores']} of "
                             f"{launches['ragged_ffn']} ragged_ffn launches on the tensor-core "
                             f"route")
    swap = eng.scheduler.swap
    if swap is not None and (swap.records or swap.used_host_blocks):
        raise AssertionError(f"{label}: swap records left: {sorted(swap.records)}")
    check_census(eng, label)
    return out, stats, eng, wall_ms, launches, margins, done


def slo_report(stats, eng, wall_ms) -> dict:
    keys = ("generated_tokens_per_s", "p50_ms", "p95_ms", "goodput", "preemptions",
            "restore_tokens", "recompute_tokens", "swapped_blocks", "restored_blocks",
            "requests_shed", "peak_running")
    rep = {k: stats[k] for k in keys if k in stats}
    rep.update({k: v for k, v in stats.items() if k.split("_")[0] in ("high", "normal", "low")})
    rep.update(steps=eng.steps, mean_step_ms=wall_ms / eng.steps)
    return rep


def slo_policy_runs(torch, cfg, params, device="cuda", n_requests=SLO_REQUESTS,
                    n_calib=24, trace_kw=None):
    """Phase 10 (a) and (b): capacity from a saturated fcfs run, then the
    2x-overload trace under fcfs and the three SLO policies (with preemption
    to a 56-block host pool) over bf16 pools, then fcfs and priority_strict
    over int8 pools.  Each policy's tokens must equal its pools' fcfs run's,
    a request differing first only at a near-tie of fcfs's top two logits;
    priority_strict must preempt and restore."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.base import ServeConfig, SLOConfig
    from repro_torch.serving.trace import latency_line, slo_class_line

    trace_kw = trace_kw or {}
    calib = slo_trace(n_calib, cfg.vocab_size, seed=1, qps=1e6, **trace_kw)
    serve = ServeConfig(**SLO_SERVE, max_len=max(r.total_len for r in calib))
    _, cstats, _, _, _, _, _ = slo_run(torch, cfg, params, serve, calib, device, "calibration")
    cap = cstats["generated_tokens_per_s"]
    mean_gen = float(np.mean([r.max_new_tokens for r in calib]))
    # bursts alternate q and 3q every burst_len requests: the mean offered
    # rate is 1.5q, so q = (4/3) x capacity gives 2x overload
    qps = (4.0 / 3.0) * cap / mean_gen
    requests = slo_trace(n_requests, cfg.vocab_size, seed=SLO_SEED, qps=qps,
                         burst_qps=3 * qps, **trace_kw)
    classes = {p: sum(int(r.priority) == i for r in requests)
               for i, p in enumerate(("high", "normal", "low"))}
    log(f"  capacity {cap:.1f} tokens/s (saturated fcfs, {n_calib} requests); trace: "
        f"{n_requests} requests at {qps:.3f} / {3 * qps:.3f} qps (2x overload), {classes}")
    serve = ServeConfig(**SLO_SERVE, max_len=max(r.total_len for r in requests))
    report = {"trace": dict(requests=n_requests, qps=qps, burst_qps=3 * qps,
                            capacity_tokens_per_s=cap, classes=classes)}
    launches = {}
    for kv in ("none", "int8"):
        pools = "bf16" if kv == "none" else kv
        base = margins = None
        for name in SLO_POLICIES if kv == "none" else ("fcfs", "priority_strict"):
            label = f"{name} over {pools} pools"
            slo = None if name == "fcfs" else SLOConfig(preemption=True,
                                                        host_blocks=SLO_HOST_BLOCKS)
            sv = dataclasses.replace(serve, sched_policy=name, slo=slo, kv_quant=kv)
            out, stats, eng, wall_ms, got, m, _ = slo_run(torch, cfg, params, sv, requests,
                                                          device, label)
            for k, v in got.items():
                launches[k] = launches.get(k, 0) + v
            rep = slo_report(stats, eng, wall_ms)
            if name == "fcfs":
                base, margins = out, m
            else:
                rep["divergences"] = first_divergences(base, out, margins, requests, label)
                rep["token_match"] = token_match(base, out)
                rep["tokens_per_s_vs_fcfs"] = (stats["generated_tokens_per_s"]
                                               / report[f"fcfs over {pools} pools"]
                                               ["generated_tokens_per_s"])
            if name == "priority_strict" and (stats["preemptions"] <= 0
                                              or stats["restore_tokens"] <= 0):
                raise AssertionError(f"{label}: {stats['preemptions']} preemptions, "
                                     f"{stats['restore_tokens']} tokens restored")
            log(f"  {label}: {latency_line(stats)}; {eng.steps} steps, mean step "
                f"{rep['mean_step_ms']:.3f} ms (host clock); launches {got}")
            line = slo_class_line(stats)
            if line:
                log(f"    {line}")
            report[label] = rep
        strict = report[f"priority_strict over {pools} pools"]
        fcfs = report[f"fcfs over {pools} pools"]
        strict["high_p95_ratio_fcfs_over_strict"] = (fcfs["high_p95_ms"]
                                                     / max(strict["high_p95_ms"], 1e-9))
        log(f"  {pools} pools: HIGH p95 fcfs / priority_strict "
            f"{strict['high_p95_ratio_fcfs_over_strict']:.3f}; tokens/s against fcfs: " + ", ".join(
                f"{n} {report[f'{n} over {pools} pools']['tokens_per_s_vs_fcfs']:.3f}"
                for n in SLO_POLICIES[1:] if f"{n} over {pools} pools" in report))
    return report, launches


def swap_roundtrips(torch, cfg, device="cuda", blocks=7, reps=5):
    """Phase 10 (c): ``swap_out`` -> clobber -> ``restore_slot`` of one slot's
    ``blocks`` KV blocks on the card for bf16, int8 and fp8 caches at the
    model's widths: the restored codes or bf16 bits and the scale bits must
    equal those swapped out.  Host time of a swap-out and of a restore per
    block (synchronous copies; the median of ``reps``)."""
    import statistics

    from repro_torch.configs.base import ServeConfig
    from repro_torch.serving.kv_cache import make_kv_cache
    from repro_torch.serving.slo.swap import SwapManager

    bs = SLO_SERVE["kv_block_size"]
    out = {}
    gen = torch.Generator(device="cpu").manual_seed(11)
    for kv in ("none", "int8", "fp8"):
        serve = ServeConfig(max_slots=2, kv_block_size=bs, max_len=blocks * bs,
                            num_blocks=2 * blocks, kv_quant=kv)
        cache = make_kv_cache(cfg, serve, device=device)
        pools = [cache.k_pool, cache.v_pool]
        if kv == "none":
            for p in pools:
                p.copy_(torch.randn(p.shape, generator=gen).to(p.dtype))
        else:
            for p in pools:
                p.copy_(torch.randint(-127, 128, p.shape, generator=gen, dtype=torch.int8))
            pools += [cache.k_scales, cache.v_scales]
            for p in pools[2:]:
                p.copy_(torch.rand(p.shape, generator=gen) + 0.5)
        swap = SwapManager(cache, host_blocks=blocks)
        t_out, t_in = [], []
        for rep in range(reps):
            src, dst = rep % 2, 1 - rep % 2
            cache.allocate_slot(src, blocks * bs)
            cache.ensure_capacity(src, blocks * bs - bs // 2)       # the last block partial
            held = list(cache._slot_blocks[src])
            want = [p[:, held].clone() for p in pools]
            sync(torch, cache.k_pool)
            t0 = time.perf_counter()
            rec = cache.swap_out(src, swap, uid=rep, total_len=blocks * bs,
                                 context_len=blocks * bs - bs // 2)
            sync(torch, cache.k_pool)
            t_out.append((time.perf_counter() - t0) * 1e3)
            for p in pools:
                p.fill_(-1)
            t0 = time.perf_counter()
            resume = cache.restore_slot(dst, rec, swap)
            sync(torch, cache.k_pool)
            t_in.append((time.perf_counter() - t0) * 1e3)
            swap.release(rec)
            new = list(cache._slot_blocks[dst])
            for p, w in zip(pools, want):
                got = p[:, new]
                if w.dtype == torch.bfloat16:
                    got, w = got.view(torch.int16), w.view(torch.int16)
                elif w.dtype == torch.float32:
                    got, w = got.view(torch.int32), w.view(torch.int32)
                if resume != rec.context_len or not torch.equal(got, w):
                    raise AssertionError(f"swap round trip over {kv} pools: the restored "
                                         f"blocks differ from those swapped out")
            cache.free_slot(dst)
            cache.check_conservation()
            swap.check_conservation()
        pools_name = "bf16" if kv == "none" else kv
        out[pools_name] = dict(block_bytes=cache.block_bytes, blocks=blocks,
                               swap_out_ms_per_block=statistics.median(t_out) / blocks,
                               restore_ms_per_block=statistics.median(t_in) / blocks)
        log(f"  swap round trip, {pools_name} pools ({blocks} blocks of {cache.block_bytes} "
            f"bytes): bit-equal; host time a block: swap-out "
            f"{out[pools_name]['swap_out_ms_per_block']:.4f} ms, restore "
            f"{out[pools_name]['restore_ms_per_block']:.4f} ms (median of {reps})")
    return out


# phase 10 (d)'s deadline budgets (base, a token) in units of the trace's
# mean arrival gap, 1000 / qps ms, where qps is (a)'s, calibrated from the
# measured capacity of the engine that serves the trace: they follow the
# step's speed.  At the eager step's 9.088 qps they are the 20 ms + 5 ms a
# token (HIGH) and 2000 + 120 ms (NORMAL) that the phase used before
SHED_BUDGET_GAPS = {"HIGH": (0.18, 0.045), "NORMAL": (18.0, 1.1)}


def shed_run(torch, cfg, params, qps, device="cuda", n_requests=24, trace_kw=None):
    """Phase 10 (d): priority_strict with preemption and shedding, over the
    engine's default (graphed) step forms, on a trace whose HIGH requests
    (half of them) have tight deadlines, ``SHED_BUDGET_GAPS`` arrival gaps
    at ``qps``: at least one request must be shed, a shed request must
    hold no slot and no block and get no token, conservation must hold after
    every step, and every other request must finish its budget."""
    from repro_torch.configs.base import ServeConfig, SLOConfig
    from repro_torch.serving.request import Priority, Status
    from repro_torch.serving.trace import latency_line, slo_class_line

    gap_ms = 1000.0 / qps
    budgets = {Priority[k]: (base * gap_ms, per * gap_ms)
               for k, (base, per) in SHED_BUDGET_GAPS.items()}
    requests = slo_trace(n_requests, cfg.vocab_size, seed=3, qps=qps, burst_qps=3 * qps,
                         class_weights=(0.5, 0.25, 0.25), deadline_budgets=budgets,
                         **(trace_kw or {}))
    serve = ServeConfig(**SLO_SERVE, max_len=max(r.total_len for r in requests),
                        sched_policy="priority_strict",
                        slo=SLOConfig(preemption=True, host_blocks=SLO_HOST_BLOCKS, shed=True))

    def held(eng, st):
        """A shed request, as the step hands it back: no slot, no token,
        in neither queue (its blocks: the conservation check of the step)."""
        sched = eng.scheduler
        if st.status is Status.SHED and (
                st.slot != -1 or st.generated or st.swap_record is not None
                or any(w is st for w in sched.waiting)
                or any(r is st for r in sched.running.values())):
            raise AssertionError(f"shedding: shed request {st.request.uid} holds a slot, a "
                                 f"record or tokens")

    out, stats, eng, wall_ms, launches, _, done = slo_run(
        torch, cfg, params, serve, requests, device, "shedding", on_finish=held)
    shed = [st for st in done if st.status is Status.SHED]
    cache = eng.cache
    if not shed or stats["requests_shed"] != len(shed):
        raise AssertionError(f"shedding: {len(shed)} shed, requests_shed "
                             f"{stats['requests_shed']}")
    if cache.allocator.live_count or cache.reserved_total:
        raise AssertionError(f"shedding: {cache.allocator.live_count} blocks live, "
                             f"{cache.reserved_total} reserved after the run")
    shown = ", ".join(f"{p.name} {b:.3f} + {t:.4f} ms a token" for p, (b, t) in budgets.items())
    log(f"  shedding: deadlines {shown} (arrival gap {gap_ms:.3f} ms)")
    log(f"  shedding: {len(shed)} of {n_requests} shed (uids "
        f"{sorted(st.request.uid for st in shed)}); {latency_line(stats)}; "
        f"{eng.steps} steps; launches {launches}")
    log(f"    {slo_class_line(stats)}")
    rep = slo_report(stats, eng, wall_ms)
    rep["shed_uids"] = sorted(st.request.uid for st in shed)
    rep["deadline_budgets_ms"] = {p.name: v for p, v in budgets.items()}
    return rep, launches


def phase_slo(torch):
    """Phase 10: m6-base SLO scheduling at ``SLO_LAYERS`` layers, dropless
    MoE."""
    from repro_torch.configs.m6 import M6_BASE
    from repro_torch.nn import init_params

    log(f"phase 10: m6-base SLO scheduling at {SLO_LAYERS} of its 5 layers ({card_line()})")
    cfg = M6_BASE.replace(num_layers=SLO_LAYERS).replace_moe(impl="dropless",
                                                            capacity_factor=None)
    params = init_params(cfg, seed=0, device="cuda")
    report, launches = slo_policy_runs(torch, cfg, params)
    report["swap"] = swap_roundtrips(torch, cfg)
    report["shedding"], shed_launches = shed_run(torch, cfg, params, report["trace"]["qps"])
    for k, v in shed_launches.items():
        launches[k] = launches.get(k, 0) + v
    return report, launches


# ---------------------------------------------------------------------------
# Phase 11: the static lockstep engine, the hash and expert-choice routers
# ---------------------------------------------------------------------------

STATIC_BATCH, STATIC_PROMPT, STATIC_GEN = 8, 48, 16   # the equal-length batch of (a)-(e)
STATIC_SEED = 11
STATIC_TRAIN_LAYERS = 2
# (label, train CLI flags, the FFN kernel the run launches)
STATIC_TRAIN_RUNS = (
    ("hash, pallas", ["--routing", "hash", "--k", "1", "--moe-impl", "pallas"], "moe_ffn"),
    ("expert_choice, pallas", ["--routing", "expert_choice", "--k", "1", "--moe-impl", "pallas"],
     "moe_ffn"),
    ("expert_choice, dropless",
     ["--routing", "expert_choice", "--k", "1", "--moe-impl", "dropless"], "ragged_ffn"),
)
KERNEL_NAMES = ("decode_attention", "paged_decode_attention", "quantized_paged_decode_attention",
                "ragged_ffn", "ragged_combine", "moe_ffn", "flash_attention")


def kernel_wrappers() -> dict:
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.moe_dropless import combine
    from repro_torch.kernels.moe_dropless import ops as rffn
    from repro_torch.kernels.moe_ffn import ops as mf

    return {"decode_attention": da.decode_attention,
            "paged_decode_attention": da.paged_decode_attention,
            "quantized_paged_decode_attention": da.quantized_paged_decode_attention,
            "ragged_ffn": rffn.ragged_ffn, "ragged_combine": combine.ragged_combine,
            "moe_ffn": mf.moe_ffn, "flash_attention": fa.flash_attention}


@contextmanager
def counted_launches(out: dict):
    """Every kernel's launch counter (and tensor-core counter) set to 0 on
    entry; on exit ``out`` holds each kernel's launches in between, and
    ``"<name> tc"`` those on the tensor-core route."""
    fns = kernel_wrappers()
    for fn in fns.values():
        fn.launches = 0
        if hasattr(fn, "tc_launches"):
            fn.tc_launches = 0
    yield
    for name, fn in fns.items():
        out[name] = fn.launches
        if hasattr(fn, "tc_launches"):
            out[f"{name} tc"] = fn.tc_launches


def expect_launches(label: str, got: dict, want: dict) -> None:
    """Each kernel launched exactly ``want[name]`` times (0 if absent), and
    every grouped-FFN launch on the tensor cores.  The dropless combine is
    expected as often as the ragged FFN (one of each a dropless dispatch)
    unless ``want`` names it."""
    want = {"ragged_combine": want.get("ragged_ffn", 0), **want}
    launched = {n: got[n] for n in KERNEL_NAMES if got[n]}
    if any(got[n] != want.get(n, 0) for n in KERNEL_NAMES):
        raise AssertionError(f"{label}: launches {launched}, expected {want} and no other kernel")
    for name in ("moe_ffn", "ragged_ffn"):
        if got[f"{name} tc"] != got[name]:
            raise AssertionError(f"{label}: {got[f'{name} tc']} of {got[name]} {name} launches "
                                 f"on the tensor-core route")


def static_groups(requests, batch=STATIC_BATCH):
    """``run_trace_static``'s FCFS groups: [(requests, prompts (B, S) right-
    padded with 0, the group's longest gen)]."""
    import numpy as np

    order = sorted(requests, key=lambda r: (r.arrival_ms, r.uid))
    out = []
    for i in range(0, len(order), batch):
        group = order[i:i + batch]
        prompts = np.zeros((len(group), max(r.prompt_len for r in group)), np.int32)
        for j, r in enumerate(group):
            prompts[j, :r.prompt_len] = r.prompt
        out.append((group, prompts, max(r.max_new_tokens for r in group)))
    return out


def static_decode_shapes(requests, batch=STATIC_BATCH):
    """(cache length T, the attended length of every decode step) of
    ``run_trace_static(requests, batch)``: FCFS groups, each decoding its
    longest gen - 1 steps from its longest prompt."""
    from repro_torch.serving.trace import static_max_len

    lens = [prompts.shape[1] + j + 1 for _, prompts, gen in static_groups(requests, batch)
            for j in range(gen - 1)]
    return static_max_len(requests), lens


def without_router(params):
    """A hash-routed model's param tree from a token-choice one: the same
    leaves (views) without the router weight."""
    blocks = dict(params["blocks"])
    blocks["ffn"] = {k: v for k, v in blocks["ffn"].items() if k != "router"}
    return {**params, "blocks": blocks}


def static_generate(torch, cfg, params, prompts, gen, graphs=True):
    """``ServingEngine.generate`` of an engine whose forms a first,
    shorter ``generate`` of the batch built (on the card, captured unless
    ``graphs`` is false), with the kernel counters at 0 before it:
    (tokens, stats, launches, wall ms)."""
    from repro_torch.serving.engine import ServingEngine

    eng = ServingEngine(cfg, params, max_len=prompts.shape[1] + gen + 1, graphs=graphs)
    eng.generate(prompts, min(gen, 2))
    table = params["embed"]["table"]
    launches = {}
    sync(torch, table)
    with counted_launches(launches):
        t0 = time.perf_counter()
        toks, stats = eng.generate(prompts, gen)
        sync(torch, table)
        wall_ms = (time.perf_counter() - t0) * 1e3
    return toks, stats, launches, wall_ms


@contextmanager
def sampled_logits(store: list, V: int):
    """Every ``ServingEngine._sample`` call's last-position logits (the
    first V columns, f32, copied to the host) appended to ``store``."""
    from unittest import mock

    from repro_torch.serving.engine import ServingEngine

    real = ServingEngine._sample

    def tap(self, logits, position, temperature, seed):
        store.append(logits[:, -1, :V].float().cpu())
        return real(self, logits, position, temperature, seed)

    with mock.patch.object(ServingEngine, "_sample", tap):
        yield


def graphed_vs_eager_generate(torch, cfg, params, prompts, gen, label, want, forms):
    """The static engine's graphed step forms against ``graphs=False`` on
    one batch, in one call: each engine's forms built by a first
    ``generate`` (the graphed one's captured: ``forms`` of them, each a
    CUDA graph), then one tapped ``generate`` each with the counters at 0.
    The greedy tokens must be identical and the largest logit difference
    over every sampled position 0 (the same kernels on the same inputs);
    on the card each kernel launched ``want`` times (replays count their
    capture's launches), eager and graphed alike.  Returns each engine's
    mean step (host clock, synced, the tap's copy of the logits a step in
    both) and the graphs' pool bytes."""
    import numpy as np

    from repro_torch.serving.engine import ServingEngine

    B, S = prompts.shape
    table = params["embed"]["table"]
    runs = {}
    for graphs in (True, False):
        eng = ServingEngine(cfg, params, max_len=S + gen + 1, graphs=graphs)
        steps = (S if eng.fam.prefill is None else 1) + gen - 1
        eng.generate(prompts if graphs else prompts[:, :4], 2)
        logits, launches = [], {}
        sync(torch, table)
        with counted_launches(launches), sampled_logits(logits, cfg.vocab_size):
            t0 = time.perf_counter()
            toks, _ = eng.generate(prompts, gen)
            sync(torch, table)
            wall_ms = (time.perf_counter() - t0) * 1e3
        kind = "graphed" if graphs else "eager"
        if table.is_cuda:
            expect_launches(f"{label} {kind}", launches, want)
        runs[kind] = (toks, torch.stack(logits), wall_ms / steps, eng)
    eng = runs["graphed"][3]
    built = list(eng._decode_forms.values()) + list(eng._prefill_forms.values())
    captured = sum(f.graph is not None for f in built)
    if eng.compiled_variants() != forms or (table.is_cuda and captured != forms):
        raise AssertionError(f"{label}: {eng.compiled_variants()} forms, {captured} captured; "
                             f"expected {forms}, each a CUDA graph on the card")
    if not np.array_equal(runs["graphed"][0], runs["eager"][0]):
        raise AssertionError(f"{label}: graphed and eager greedy tokens differ")
    diff = float((runs["graphed"][1] - runs["eager"][1]).abs().max())
    if diff != 0.0:
        raise AssertionError(f"{label}: graphed and eager logits differ by up to {diff}")
    pool = sum(f.graph_bytes for f in built)
    log(f"  {label}: graphed forms ({forms}, {pool / 2**20:.2f} MiB of graph pool) against "
        f"eager on {B} x {S}, {gen} tokens, {steps} steps: greedy tokens identical, max abs "
        f"logit diff {diff:.6g}; mean step {runs['graphed'][2]:.3f} ms graphed, "
        f"{runs['eager'][2]:.3f} ms eager (host clock, synced, the tap's copy included)")
    return dict(steps=steps, graphed_step_ms=runs["graphed"][2],
                eager_step_ms=runs["eager"][2], tokens_identical=True,
                max_abs_logit_diff=diff, forms=forms, graph_pool_bytes=pool)


def static_parity(torch, cfg, params, prompts, gen, device, label):
    """(a) and (e): the static engine's greedy tokens against the
    continuous engine's on one equal-length batch; a row may differ only
    from a near-tie of the continuous run's top two logits on.  On the
    card the dense decode kernel must run layers x decode steps times and
    the ragged FFN MoE layers x (prefill + decode steps), all on the tensor
    cores, and nothing else."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.serving.request import Request

    B, S = prompts.shape
    L = cfg.num_layers
    toks, stats, launches, wall_ms = static_generate(torch, cfg, params, prompts, gen)
    if not ((toks >= 0) & (toks < cfg.vocab_size)).all() or toks.shape != (B, gen):
        raise AssertionError(f"{label}: tokens of shape {toks.shape} outside the vocabulary")
    if params["embed"]["table"].is_cuda:
        expect_launches(label, launches, {"decode_attention": L * (gen - 1),
                                          "ragged_ffn": moe_layers(cfg) * gen})
    requests = [Request(uid=i, prompt=prompts[i], max_new_tokens=gen) for i in range(B)]
    serve = ServeConfig(max_slots=B, max_len=S + gen + 1)
    base, margins = tapped_margins(torch, cfg, params, serve, requests, device)
    static = {i: toks[i].tolist() for i in range(B)}
    div = first_divergences(base, static, margins, requests, f"{label} static vs continuous")
    shown = {n: launches[n] for n in KERNEL_NAMES if launches[n]}
    log(f"  {label}: static generate of {B} x {S} prompts, {gen} tokens: {B - len(div)} of {B} "
        f"rows equal to the continuous engine's; prefill {stats['prefill_s'] * 1e3:.2f} ms, "
        f"decode {stats['decode_s'] * 1e3:.2f} ms ({stats['decode_tokens_per_s']:.1f} "
        f"tokens/s), wall {wall_ms:.1f} ms; launches {shown}")
    return dict(rows_equal=B - len(div), rows=B,
                divergences=[dict(request=u, token=p, gap=g) for u, p, g in div],
                prefill_ms=stats["prefill_s"] * 1e3, decode_ms=stats["decode_s"] * 1e3,
                decode_tokens_per_s=stats["decode_tokens_per_s"], launches=shown), launches


def static_trace(torch, cfg, params, requests, device, continuous, batch=STATIC_BATCH,
                 graphs=True):
    """(b): ``run_trace_static`` over the trace at ``batch`` by an engine
    whose forms a first run of the trace built (on the card, captured
    unless ``graphs`` is false: a form per group shape, reused); every
    budget met, and on the card the dense kernel launched layers x decode
    steps times; its tokens/s and p50/p95 beside the continuous run's
    (``continuous``: tokens_per_s, p50_ms, p95_ms) and the ratio
    continuous / static (the reference benchmark's speedup_tokens_per_s)."""
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.trace import latency_line, run_trace_static

    T, lens = static_decode_shapes(requests, batch)
    groups = -(-len(requests) // batch)
    eng = ServingEngine(cfg, params, max_len=T, graphs=graphs)
    run_trace_static(eng, requests, batch)
    table = params["embed"]["table"]
    launches = {}
    sync(torch, table)
    with counted_launches(launches):
        out, stats = run_trace_static(eng, requests, batch)
        sync(torch, table)
    for r in requests:
        if len(out[r.uid]) != r.max_new_tokens:
            raise AssertionError(f"static trace: request {r.uid}: {len(out[r.uid])} tokens, "
                                 f"budget {r.max_new_tokens}")
    L = cfg.num_layers
    if table.is_cuda:
        expect_launches("static trace", launches, {"decode_attention": L * len(lens),
                                                   "ragged_ffn": L * (len(lens) + groups)})
    ratio = continuous["tokens_per_s"] / stats["generated_tokens_per_s"]
    log(f"  static trace, batch {batch}, {'graphed' if graphs else 'eager'} forms "
        f"({eng.compiled_variants()}): {latency_line(stats)}; cache T = {T}, {groups} groups, "
        f"{len(lens)} decode steps; continuous {continuous['tokens_per_s']:.1f} tokens/s, p50 "
        f"{continuous['p50_ms']:.0f} ms p95 {continuous['p95_ms']:.0f} ms: continuous / static "
        f"{ratio:.3f}x tokens/s")
    shown = {n: launches[n] for n in KERNEL_NAMES if launches[n]}
    return dict(tokens_per_s=stats["generated_tokens_per_s"], p50_ms=stats["p50_ms"],
                p95_ms=stats["p95_ms"], total_ms=stats["total_ms"], batch=batch, max_len=T,
                decode_steps=len(lens), continuous_tokens_per_s=continuous["tokens_per_s"],
                continuous_p50_ms=continuous["p50_ms"], continuous_p95_ms=continuous["p95_ms"],
                speedup_tokens_per_s=ratio, launches=shown, graphs=graphs,
                compiled_variants=eng.compiled_variants()), launches


def static_serving_runs(torch, cfg, params, requests, device, continuous,
                        shape=(STATIC_BATCH, STATIC_PROMPT, STATIC_GEN)):
    """(a)-(e) of phase 11 over ``cfg`` (dropless top-1) and its params:
    returns (report, launches summed over the runs)."""
    import numpy as np

    B, S, gen = shape
    L = cfg.num_layers
    prompts = np.random.default_rng(STATIC_SEED).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    total, report = {}, {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    report["greedy"], got = static_parity(torch, cfg, params, prompts, gen, device, "dropless")
    add(got)
    report["graphed_vs_eager"] = graphed_vs_eager_generate(
        torch, cfg, params, prompts, gen, "(c) dropless",
        {"decode_attention": L * (gen - 1), "ragged_ffn": moe_layers(cfg) * gen}, forms=2)
    if params["embed"]["table"].is_cuda:
        report["greedy"].update(profile_static(torch, cfg, params, prompts, gen))
        report["greedy"]["profile_cuda_only"] = {
            "graphed" if g else "eager": profile_static(torch, cfg, params, prompts, gen,
                                                        cpu=False, graphs=g)
            for g in (True, False)}
    report["trace"], got = static_trace(torch, cfg, params, requests, device, continuous)
    add(got)
    report["eager_trace"], got = static_trace(torch, cfg, params, requests, device, continuous,
                                              graphs=False)
    add(got)
    cap = cfg.replace_moe(impl="pallas", capacity_factor=1.25)
    toks, stats, got, _ = static_generate(torch, cap, params, prompts, gen)
    if not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError("capacity 1.25: tokens outside the vocabulary")
    if params["embed"]["table"].is_cuda:
        expect_launches("capacity 1.25", got, {"decode_attention": L * (gen - 1),
                                               "moe_ffn": L * gen})
    log(f"  capacity 1.25 (pallas): {B} x {S} prompts, {gen} tokens, moe_ffn launches "
        f"{got['moe_ffn']} ({got['moe_ffn tc']} on the tensor cores), decode "
        f"{stats['decode_tokens_per_s']:.1f} tokens/s")
    report["capacity"] = dict(moe_ffn_launches=got["moe_ffn"],
                              decode_tokens_per_s=stats["decode_tokens_per_s"])
    add(got)
    report["hash"], got = static_parity(torch, cfg.replace_moe(routing="hash"),
                                        without_router(params), prompts, gen, device, "hash")
    add(got)
    return report, total


def router_train_runs(torch, argv, device, layers=STATIC_TRAIN_LAYERS):
    """(f): for each of STATIC_TRAIN_RUNS, 2 steps through the train CLI at
    ``layers`` layers (finite losses, dropped fraction in [0, 1); on the
    card the run's FFN kernel launched layers x steps x 2, all on the
    tensor cores, and nothing else), then one step's loss and gradients
    through the kernels against the plain versions (``compare_train_step``,
    routing near-ties reported).  Returns (report, launches)."""
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.train import device_batch

    report, total = {}, {}
    with cut_depth(layers):
        for label, extra, ffn in STATIC_TRAIN_RUNS:
            args = argv + extra + ["--steps", "2", "--device", device]
            launches = {}
            with counted_launches(launches):
                logs = train_mod.main(args)
            for m in logs:
                if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
                        and 0.0 <= m["moe_dropped_fraction"] < 1.0):
                    raise AssertionError(f"{label}: step {m['step']}: loss {m['loss']}, grad "
                                         f"norm {m['grad_norm']}, dropped fraction "
                                         f"{m['moe_dropped_fraction']}")
            if device == "cuda":
                expect_launches(label, launches, {ffn: layers * 2 * 2})
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            log(f"  train {label}, {layers} layers: losses "
                f"{[round(m['loss'], 4) for m in logs]}, dropped fraction "
                f"{[round(m['moe_dropped_fraction'], 4) for m in logs]}, {ffn} launches "
                f"{launches[ffn]} (forward + remat recompute)")
            cfg, state, _, pipeline = train_setup(args)
            batch = device_batch(pipeline.batch_at(0), device)
            cmp = compare_train_step(torch, cfg, state.params, batch)
            del state
            if device == "cuda":
                torch.cuda.empty_cache()
            report[label] = dict(losses=[m["loss"] for m in logs],
                                 dropped_fraction=[m["moe_dropped_fraction"] for m in logs],
                                 launches=launches[ffn], kernels_vs_plain=cmp)
    return report, total


def phase_static(torch, continuous):
    """Phase 11: m6-base through the static engine (phase 5's weights,
    trace and continuous numbers), then the two routers' training."""
    from repro_torch.configs.m6 import M6_BASE
    from repro_torch.nn import init_params
    from repro_torch.serving.trace import synthetic_trace

    log(f"phase 11: the static engine and the hash and expert-choice routers ({card_line()})")
    cfg = M6_BASE.replace_moe(impl="dropless", capacity_factor=None)
    params = init_params(cfg, seed=0, device="cuda")            # phase 5's weights
    requests = synthetic_trace(16, cfg.vocab_size, seed=0)      # phase 5's trace
    report, launches = static_serving_runs(torch, cfg, params, requests, "cuda", continuous)
    del params
    torch.cuda.empty_cache()
    report["train"], train_launches = router_train_runs(torch, TRAIN_ARGS, "cuda")
    return report, launches, train_launches


# ---------------------------------------------------------------------------
# Phase 12: the decoder-LM families (granite, qwen2.5-32b, olmoe) and the
# rest of training (Adafactor, int8 compression, chunked attention, profiler)
# ---------------------------------------------------------------------------

FAMILY_LENS = [21, 56, 112, 9, 74, 33, 98, 47]     # phase 4's decode step lengths
# the decode kernels' new GQA groups: label -> (Hq, Hkv, D)
FAMILY_HEADS = {"G=3 D=64": (24, 8, 64),          # granite-moe-3b-a800m
                "G=5 D=128": (40, 8, 128),        # qwen2.5-32b, qwen3-14b
                "G=1 D=128": (16, 16, 128)}       # olmoe-1b-7b
# the ragged FFN at the families' engine steps, 8 rows a decode step and
# 8 + 32 a mixed step (a decode row a slot and a 32-token prefill chunk):
# label -> (tokens, (E, M, I, act, top_k))
FAMILY_FFN = {"granite decode": (8, (40, 1536, 512, "swiglu", 8)),
              "granite mixed step": (40, (40, 1536, 512, "swiglu", 8)),
              "olmoe decode": (8, (64, 2048, 1024, "swiglu", 8))}
# moe_ffn at granite's training shape under 8 top-1 prototyping: B 4 x S 2048
# tokens in 16 groups of 512, C = int(8 x 512 / 40 x 1.25) = 128, X = 16 x 128
GRANITE_TRAIN_FFN = (40, 2048, 1536, 512, "swiglu")   # E, X, M, I, act
FAMILY_TRAIN_ARGS = ["--arch", "granite-moe-3b-a800m", "--moe-impl", "pallas", "--optimizer",
                     "adafactor", "--routing", "prototype", "--k", "8", "--batch", "4",
                     "--seq", "2048", "--log-every", "1"]
FAMILY_TRAIN_LAYERS = 2
FAMILY_TRAIN_STEPS = 4
FAMILY_SMALL_LAYERS = 2          # qwen2.5-32b and olmoe-1b-7b at full width
FAMILY_GRANITE_LAYERS = 8        # granite served at 8 of its 32 layers (the script's time)
# Adafactor on the card against the CPU: the same arithmetic with every mean
# a sum in another order (over up to 75 M elements); each factor of an
# update element (its gradient, the row and column means, the two RMS) is
# within a few f32 ulps, so an element within rtol 2e-5, as is the state
ADAFACTOR_RTOL = 2e-5
LOSS_SLACK = 1.0                 # a random init's CE within this of ln(vocab)


def check_family_kernels(torch):
    """Phase 12's kernel shapes against their plain versions at TOL: the
    paged kernel (bf16, f32, and int8 / fp8 codes) and the dense kernel at
    GQA groups of 3 (D 64), 5 (D 128) and olmoe's 1 (D 128), each also
    against its split-and-merge plain version at the plan's split and (bf16
    and f32 paged, dense) at every split forced; moe_ffn at granite's
    training shape (E 40, X 2048, M 1536, I 512, swiglu) and the ragged FFN
    at granite's decode and mixed steps (8 and 40 tokens, top-8 of 40) and
    olmoe's decode step (8 tokens, top-8 of 64), on the tensor cores, also
    within one bf16 ulp of the split-h plain versions.  Length-0 rows
    exactly 0.  Returns each kernel's max abs err."""
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.decode_attention import ref as dref
    from repro_torch.kernels.moe_dropless import ops as rffn
    from repro_torch.kernels.moe_dropless.ref import ragged_ffn_ref, ragged_ffn_split_ref
    from repro_torch.kernels.moe_ffn import ops as mf
    from repro_torch.kernels.moe_ffn.ref import moe_ffn_ref, moe_ffn_split_ref
    from repro_torch.quant import get_kv_quant

    errs = {}

    def keep(name, err):
        errs[name] = max(errs.get(name, 0.0), err)

    lens = [40, 0, 17, 256, 1, 100, 16, 63]
    for i, (label, (Hq, Hkv, D)) in enumerate(FAMILY_HEADS.items()):
        for dt in (torch.bfloat16, torch.float32):
            case = attention_case(8, Hq, Hkv, D, 16, 16, lens, seed=700 + i, dtype=dt)
            want = dref.paged_decode_attention_ref(*case)
            for forced in (None, *da.SPLITS):
                out = da.paged_decode_attention(*case, splits=forced)
                torch.cuda.synchronize()
                splits, stages = da.launch_plan(case[0], case[1], case[3], forced)
                name = (f"paged_decode_attention {label} {str(dt)[6:]} splits={splits}"
                        f"{'' if forced else ' (plan)'} stages={stages}")
                keep("paged_decode_attention", check_close(name, out, want))
                check_close(f"{name} vs split plain", out,
                            dref.paged_decode_attention_split_ref(*case, splits))
                if not (out[1] == 0).all():
                    raise AssertionError(f"{name}: the length-0 row is not exactly 0")
        for name in ("int8", "fp8"):
            pol = get_kv_quant(name)
            case = quant_attention_case(8, Hq, Hkv, D, 16, 16, lens, seed=710 + i, name=name)
            out = da.quantized_paged_decode_attention(*case, policy=pol)
            torch.cuda.synchronize()
            splits, _ = da.launch_plan(case[0], case[1], case[5])
            label_q = f"quantized_paged_decode_attention {name} {label} splits={splits}"
            keep("quantized_paged_decode_attention", check_close(
                label_q, out, dref.quantized_paged_decode_attention_ref(*case, policy=pol)))
            check_close(f"{label_q} vs split plain", out,
                        dref.quantized_paged_decode_attention_split_ref(*case, splits,
                                                                        policy=pol))
            if not (out[1] == 0).all():
                raise AssertionError(f"{label_q}: the length-0 row is not exactly 0")
        dlens = [0, 1, 256, 77, 130, 16, 255, 9]
        case = dense_case(8, 256, Hq, Hkv, D, dlens, seed=720 + i)
        want = dref.decode_attention_ref(*case)
        for forced in (None, *da.SPLITS):
            out = da.decode_attention(*case, splits=forced, max_length=256)
            torch.cuda.synchronize()
            splits, stages = da.dense_plan(8, Hkv, Hq // Hkv, D, 256, 2, da._sm_count(0),
                                           forced, 256)
            name = f"decode_attention {label} splits={splits}{'' if forced else ' (plan)'}"
            keep("decode_attention", check_close(name, out, want))
            check_close(f"{name} vs split plain", out,
                        dref.decode_attention_split_ref(*case, splits))
            if not (out[0] == 0).all():
                raise AssertionError(f"{name}: the length-0 row is not exactly 0")
    E, X, M, I, act = GRANITE_TRAIN_FFN
    case = moe_case(E, X, M, I, seed=730, act=act)
    err, split = check_routed(
        f"moe_ffn granite train E={E} X={X} M={M} I={I} {act}", mf.moe_ffn,
        lambda *a: mf.moe_ffn(*a, act), case, lambda *a: moe_ffn_ref(*a, act),
        lambda *a: moe_ffn_split_ref(*a, act), True)
    keep("moe_ffn", err)
    keep("moe_ffn split", split)
    del case
    for j, (label, (n, (E, M, I, act, top_k))) in enumerate(FAMILY_FFN.items()):
        xs, be, weights, rag, bx = ffn_case(n, E, M, I, seed=740 + j, act=act, top_k=top_k)
        log(f"  ragged_ffn {label}: {n} tokens x top-{top_k} of {E}: R={xs.shape[0]} rows, "
            f"bx={bx}, {int((rag.token >= 0).sum())} routed")
        for live in (None, rag.token):       # without the liveness, then as the dispatcher
            err, split = check_ragged(torch, label, xs, be, weights, act, bx, live,
                                      case_tile(n, E, bx, act == "swiglu", top_k=top_k)
                                      if live is not None else 0)
            keep("ragged_ffn", err)
            keep("ragged_ffn split", split)
    return errs


def phase_timing_families(torch):
    """Phase 12's kernel shapes timed as phase 4 times its own: the paged,
    int8, fp8 and dense kernels at the decode step's lengths for G = 3 (D 64)
    and 5 (D 128) and olmoe's G = 1 (D 128) beside SDPA (GQA), moe_ffn at
    granite's training shape beside torch.bmm, the ragged FFN at granite's
    decode and mixed steps and olmoe's decode step beside F.grouped_mm."""
    out = {}
    for i, (label, heads) in enumerate(FAMILY_HEADS.items()):
        out[f"paged_decode_attention {label}"] = time_attention(torch, FAMILY_LENS, 750 + i,
                                                                heads=heads)
        for name in ("int8", "fp8"):
            out[f"quantized_paged_decode_attention {name} {label}"] = time_quantized(
                torch, FAMILY_LENS, 760 + i, name=name, heads=heads)
        out[f"decode_attention {label}"] = time_dense(torch, FAMILY_LENS, 770 + i, heads=heads)
    E, X, M, I, act = GRANITE_TRAIN_FFN
    out["moe_ffn granite train"] = time_moe_ffn(torch, X, seed=780, shape=(E, M, I, act))
    for j, (label, (n, shape)) in enumerate(FAMILY_FFN.items()):
        out[f"ragged_ffn {label}"] = time_ffn(torch, n, seed=790 + j, weights=None, shape=shape)
    for name, r in out.items():
        log(f"  families {name}: {timing_line(r)}")
    return out


def family_serve(torch, cfg, params, requests, device, label, kv_quant="none",
                 profile=False, max_len=None, **engine_kw):
    """(a)-(c): ``requests`` through the continuous engine (dropless MoE) with
    the kernel counters at 0 before it: every budget met, the cache's
    conservation, the dropped fraction 0.0; on the card the paged kernel
    (the quantized one under int8 / fp8) and, for a MoE model, the ragged
    FFN launched layers x steps times, every FFN launch on the tensor
    cores, nothing else (the ragged FFN MoE layers x steps in a mixed
    stack).  Then the same engine on the kernels' plain versions, its
    logits tapped: a request may differ from it only first at a near-tie of
    the plain run's top two logits (reported with the gap).  ``engine_kw``
    goes to the engine (``check_invariants``).  Returns (report, launches)."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.serving.request import Request
    from repro_torch.serving.trace import latency_line

    serve = ServeConfig(max_len=max_len or max(256, max(r.total_len for r in requests)),
                        kv_quant=kv_quant)
    serve_once(torch, cfg, params, serve, [Request(uid=0, prompt=requests[0].prompt,
                                                   max_new_tokens=3)], device)   # warm-up
    launches = {}
    with counted_launches(launches):
        out, stats, eng, wall_ms = serve_once(torch, cfg, params, serve, requests, device,
                                              **engine_kw)
    steps, L = eng.steps, cfg.num_layers
    if stats.get("moe_dropped_fraction", 0.0) != 0.0:
        raise AssertionError(f"{label}: dropped fraction {stats['moe_dropped_fraction']}")
    attn = "paged_decode_attention" if kv_quant == "none" else "quantized_paged_decode_attention"
    if device == "cuda":
        want = {attn: L * steps}
        if cfg.moe.num_experts:
            want["ragged_ffn"] = moe_layers(cfg) * steps
        expect_launches(label, launches, want)
    t0 = time.perf_counter()
    with plain_versions():          # eager forms: the plain versions are not for capture
        base, margins = tapped_margins(torch, cfg, params, serve, requests, device,
                                       graphs=False)
    plain_s = time.perf_counter() - t0
    div = first_divergences(base, out, margins, requests, f"{label} kernels vs plain")
    shown = {n: launches[n] for n in KERNEL_NAMES if launches[n]}
    log(f"  {label}: {latency_line(stats)}; {steps} steps, mean step {wall_ms / steps:.2f} ms "
        f"(host clock); {len(requests) - len(div)} of {len(requests)} requests' tokens equal "
        f"to the plain versions' (their run {plain_s:.1f} s); launches {shown} = {L} layers x "
        f"{steps} steps")
    report = dict(tokens_per_s=stats["generated_tokens_per_s"], p50_ms=stats["p50_ms"],
                  p95_ms=stats["p95_ms"], mean_step_ms=wall_ms / steps, steps=steps,
                  layers=L, requests_equal_to_plain=len(requests) - len(div),
                  divergences=[dict(request=u, token=p, gap=g) for u, p, g in div],
                  launches=shown, plain_run_s=plain_s)
    if profile and device == "cuda":
        t0 = time.perf_counter()
        report.update(profile_steps(torch, cfg, params, serve, requests, n_steps=8, cpu=False))
        report["profile_s"] = time.perf_counter() - t0
    return report, launches


def family_configs():
    """(label, config, kv_quant) of (a)-(c), at full width: granite at
    ``FAMILY_GRANITE_LAYERS``, top-8 of 40, then its 8 top-1 prototyping;
    qwen2.5-32b (int8 pools, G = 5, QKV bias) and olmoe-1b-7b (qk-norm,
    G = 1, D 128, top-8 of 64) at 2 layers."""
    from repro_torch.configs import granite_moe_3b_a800m as granite
    from repro_torch.configs import olmoe_1b_7b, qwen2_5_32b

    def dropless(cfg):
        return cfg.replace_moe(impl="dropless", capacity_factor=None)

    cut, deep = FAMILY_SMALL_LAYERS, FAMILY_GRANITE_LAYERS
    return [("(a) granite-moe-3b-a800m", dropless(granite.CONFIG.replace(num_layers=deep)),
             "none"),
            ("(b) granite prototyped(8)",
             dropless(granite.prototyped(8).replace(num_layers=deep)), "none"),
            ("(c) qwen2.5-32b, int8 pools", qwen2_5_32b.CONFIG.replace(num_layers=cut), "int8"),
            ("(c) olmoe-1b-7b", dropless(olmoe_1b_7b.CONFIG.replace(num_layers=cut)), "none")]


def family_serving_runs(torch, configs, device, n_requests=16):
    """(a)-(c) over ``configs`` (``family_configs``): each model's random
    params from seed 0 and its own 16-request synthetic trace (seed 0);
    the device busy share profiled for granite, (a) and (b).  Returns (report, launches
    summed over the runs)."""
    from repro_torch.nn import count_params, init_params
    from repro_torch.serving.trace import synthetic_trace

    report, total = {}, {}
    for label, cfg, kv_quant in configs:
        t0 = time.perf_counter()
        params = init_params(cfg, seed=0, device=device)
        requests = synthetic_trace(n_requests, cfg.vocab_size, seed=0)
        log(f"  {label}: {cfg.num_layers} layers, d {cfg.d_model}, {cfg.num_heads} heads over "
            f"{cfg.num_kv_heads} kv heads of {cfg.resolved_head_dim}, "
            f"{count_params(cfg) / 1e9:.3f} B params, random init in "
            f"{time.perf_counter() - t0:.1f} s; kv_quant {kv_quant}")
        report[label], got = family_serve(torch, cfg, params, requests, device, label,
                                          kv_quant=kv_quant,
                                          profile=label.startswith(("(a)", "(b)")))
        report[label].update(params_b=count_params(cfg) / 1e9)
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        del params
        if device == "cuda":
            torch.cuda.empty_cache()
    return report, total


@contextmanager
def counted_chunked(calls: list):
    """Every call of the chunked attention path (``models.chunked_attention``)
    appended to ``calls`` as its (S, T)."""
    from unittest import mock

    from repro_torch.models import chunked_attention as ca

    real = ca.chunked_attention

    def spy(qg, k, *a, **kw):
        calls.append((qg.shape[1], k.shape[1]))
        return real(qg, k, *a, **kw)

    with mock.patch.object(ca, "chunked_attention", spy):
        yield


def cut_depth(layers):
    """The train CLI's config at ``layers`` layers (no CLI flag for depth)."""
    return built_config(lambda cfg: cfg.replace(num_layers=layers))


@contextmanager
def built_config(edit):
    """The train CLI's config through ``edit`` (it has no flag for depth,
    MoE attention or the MoE layer period)."""
    from unittest import mock

    from repro_torch.launch import train as train_mod

    build_full = train_mod.build
    with mock.patch.object(train_mod, "build", lambda args: edit(build_full(args))):
        yield


@contextmanager
def recorded_compression(store: list):
    """Every ``compress_grads`` call of the trainer: (grads, error feedback
    in, mode, outputs), the tensors copied to the host before and after
    (copies on the CPU too: the train form writes the residual in place)."""
    from unittest import mock

    from repro_torch.train import trainer

    real = trainer.compress_grads

    def host(tensors):
        return None if tensors is None else {k: t.detach().to("cpu", copy=True)
                                             for k, t in tensors.items()}

    def spy(grads, mode, ef=None, global_max=None):
        before = (host(grads), host(ef))
        out, new_ef = real(grads, mode, ef, global_max)
        store.append((*before, mode, host(out), host(new_ef)))
        return out, new_ef

    with mock.patch.object(trainer, "compress_grads", spy):
        yield


def check_int8_codes(torch, store, device):
    """Each recorded int8 compression (``recorded_compression``) done again
    on the CPU from the same gradients and residual: every leaf's codes and
    scale (``quantize_int8`` of gradient + residual) bit-equal to the
    device's, and so the compressed gradients and the new residuals."""
    from repro_torch.optim.compression import compress_grads, quantize_int8

    for step, (grads, ef, mode, out, new_ef) in enumerate(store):
        if mode != "int8":
            raise AssertionError(f"compression mode {mode}, expected int8")
        cpu_out, cpu_ef = compress_grads(grads, mode, ef)
        for k, g in grads.items():
            target = g.float() + (ef[k] if ef is not None else 0.0)
            dq, ds = quantize_int8(target.to(device))
            cq, cs = quantize_int8(target)
            if not (torch.equal(dq.cpu(), cq)
                    and torch.equal(ds.cpu().view(torch.int32), cs.view(torch.int32))):
                raise AssertionError(f"int8 step {step}, {k}: codes or scale on the device "
                                     f"differ from the CPU's")
            if not (torch.equal(out[k].view(torch.int32), cpu_out[k].view(torch.int32))
                    and torch.equal(new_ef[k].view(torch.int32), cpu_ef[k].view(torch.int32))):
                raise AssertionError(f"int8 step {step}, {k}: compressed gradient or residual "
                                     f"differs from the CPU's")
    log(f"  int8 compression: codes, scales, compressed gradients and residuals of "
        f"{len(store)} steps x {len(store[0][0])} leaves bit-equal to the CPU's")
    return len(store)


def adafactor_vs_cpu(torch, cfg, params, batches, device, steps=2):
    """Adafactor's update on ``device`` against the port's CPU update on the
    same gradients (clipped, as the trainer clips them, at the initial
    params, of ``batches``) and the same state, for every leaf at each of
    ``steps`` steps: updates and state within ADAFACTOR_RTOL.  Returns the
    largest relative difference of each kind."""
    from repro_torch.nn import flat_params
    from repro_torch.optim.adafactor import adafactor
    from repro_torch.optim.clip import clip_by_global_norm
    from repro_torch.optim.schedules import warmup_constant
    from repro_torch.train.trainer import _grads, make_loss_fn

    flat = flat_params(params)
    loss_fn = make_loss_fn(cfg)
    grads = []
    for b in batches[:steps]:
        loss, _ = loss_fn(params, b)
        grads.append(clip_by_global_norm(_grads(loss, flat), 1.0)[0])
    opt = adafactor(warmup_constant(5e-3, 2))
    dev_p = {k: p.detach().clone() for k, p in flat.items()}
    cpu_p = {k: p.cpu() for k, p in dev_p.items()}
    dev_s, cpu_s = opt.init(dev_p), opt.init(cpu_p)
    worst = {"update": 0.0, "state": 0.0}

    def rel(a, b):                    # compared where ``a`` lives: the card's rate
        b = b.to(a.device).float()
        d = (a.float() - b).abs()
        bad = d > ADAFACTOR_RTOL * b.abs()
        return float((d / b.abs().clamp_min(1e-30)).max()), int(bad.sum())

    for step, g in enumerate(grads):
        du, dev_s = opt.update(g, dev_s, dev_p, step)
        cu, cpu_s = opt.update({k: v.cpu() for k, v in g.items()}, cpu_s, cpu_p, step)
        sync(torch, next(iter(du.values())))
        for k in flat:
            for what, a, b in [("update", du[k], cu[k])] + [
                    ("state", dev_s["v"][k][n], cpu_s["v"][k][n]) for n in cpu_s["v"][k]]:
                r, bad = rel(a, b)
                worst[what] = max(worst[what], r)
                if bad:
                    raise AssertionError(f"Adafactor step {step + 1} {k}: {bad} {what} elements "
                                         f"beyond rtol {ADAFACTOR_RTOL} of the CPU's (worst {r:.3g})")
            dev_p[k].add_(du[k].float())
            cpu_p[k].add_(cu[k].float())
    log(f"  Adafactor on the device against the CPU, {len(flat)} leaves ("
        f"{sum(p.numel() for p in flat.values()) / 1e6:.1f} M parameters) x {len(grads)} steps "
        f"on the same gradients: largest relative difference, updates {worst['update']:.3g}, "
        f"state {worst['state']:.3g} (rtol {ADAFACTOR_RTOL})")
    return worst


def family_train(torch, argv, device, layers=FAMILY_TRAIN_LAYERS, steps=FAMILY_TRAIN_STEPS,
                 profile_dir=None):
    """(d): granite training through the train CLI at ``layers`` layers:
    ``steps`` steps of Adafactor with 8 top-1 prototyping through moe_ffn,
    every loss finite and within LOSS_SLACK of ln(vocab), the attention on
    the chunked path (S*T > 2^21) in every layer's forward and remat
    recompute, moe_ffn launched layers x steps x 2 times on the tensor
    cores and nothing else (the step a CUDA graph from step 1 on; the same
    run with --no-graphs gives bit-equal losses, ``eager_against``);
    Adafactor on the device against the CPU (``adafactor_vs_cpu``); the
    same run under AdamW for its step time; two eager steps at
    --grad-compression int8 whose codes
    and scales equal the CPU's (``check_int8_codes``); and, with
    ``profile_dir``, a --profile-dir step whose trace names moe_ffn's
    tensor-core kernel.  Returns (report, launches)."""
    import os
    import shutil

    from repro_torch.launch import train as train_mod
    from repro_torch.launch.train import device_batch

    report, calls, launches, seconds = {}, [], {}, {}
    clock = [time.perf_counter()]

    def lap(name):                     # seconds each part of (d) takes
        now = time.perf_counter()
        seconds[name] = now - clock[0]
        clock[0] = now

    with cut_depth(layers):
        args = argv + ["--steps", str(steps), "--device", device]
        with counted_launches(launches), counted_chunked(calls):
            t0 = time.perf_counter()
            logs = train_mod.main(args)
            wall_s = time.perf_counter() - t0
        report["graphed_vs_eager"] = eager_against(torch, args, "(d) granite train", logs,
                                                   launches)
        cfg, state, _, pipeline = train_setup(args)
    ln_v = math.log(cfg.vocab_size)
    for m in logs:
        if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
                and abs(m["loss"] - ln_v) <= LOSS_SLACK):
            raise AssertionError(f"granite train step {m['step']}: loss {m['loss']}, grad norm "
                                 f"{m['grad_norm']} (ln vocab {ln_v:.3f})")
    S = pipeline.batch_at(0)["tokens"].shape[1]
    # a Python spy sees a captured step's body at its warm-up and capture only
    bodies = 2 if device == "cuda" else steps
    if len(calls) != layers * bodies * 2 or any(c != (S, S) for c in calls):
        raise AssertionError(f"chunked attention calls {len(calls)} (shapes "
                             f"{sorted(set(calls))}), expected {layers} layers x {bodies} step "
                             f"bodies x 2 (forward + remat recompute) at S = T = {S}")
    if device == "cuda":
        expect_launches("granite train", launches, {"moe_ffn": layers * steps * 2})
    steady = logs[1:]
    step_ms = sum(m["step_time_s"] for m in steady) / len(steady) * 1e3
    tokens = pipeline.batch_at(0)["labels"].size
    log(f"  (d) granite train, {layers} layers, {steps} steps: losses "
        f"{[round(m['loss'], 4) for m in logs]} (ln {cfg.vocab_size} = {ln_v:.3f}), grad norms "
        f"{[round(m['grad_norm'], 4) for m in logs]}, dropped fraction "
        f"{[round(m['moe_dropped_fraction'], 4) for m in logs]}; chunked attention {len(calls)} "
        f"calls at S = T = {S}; moe_ffn launches {launches['moe_ffn']}; mean step "
        f"{step_ms:.1f} ms over steps 1-{steps - 1} ({tokens / (step_ms / 1e3):.0f} tokens/s), "
        f"run {wall_s:.1f} s")
    report["adafactor"] = dict(losses=[m["loss"] for m in logs],
                               grad_norms=[m["grad_norm"] for m in logs],
                               dropped_fraction=[m["moe_dropped_fraction"] for m in logs],
                               mean_step_ms=step_ms, tokens_per_s=tokens / (step_ms / 1e3),
                               first_step_ms=logs[0]["step_time_s"] * 1e3,
                               chunked_calls=len(calls), moe_ffn_launches=launches["moe_ffn"])
    lap("adafactor runs, graphed and with --no-graphs")
    batches = [device_batch(pipeline.batch_at(i), device) for i in range(2)]
    report["adafactor_vs_cpu"] = adafactor_vs_cpu(torch, cfg, state.params, batches, device)
    lap("adafactor against the CPU")
    del state, batches
    if device == "cuda":
        torch.cuda.empty_cache()
    # the same run under AdamW, for the step time beside Adafactor's
    adamw = [a if a != "adafactor" else "adamw" for a in argv]
    got = {}
    with cut_depth(layers), counted_launches(got):
        logs = train_mod.main(adamw + ["--steps", str(steps), "--device", device])
    if not all(math.isfinite(m["loss"]) for m in logs):
        raise AssertionError(f"AdamW run: losses {[m['loss'] for m in logs]}")
    if device == "cuda":
        expect_launches("granite train, AdamW", got, {"moe_ffn": layers * steps * 2})
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    adamw_ms = sum(m["step_time_s"] for m in logs[1:]) / len(logs[1:]) * 1e3
    log(f"  AdamW on the same run: mean step {adamw_ms:.1f} ms over steps 1-{steps - 1} against "
        f"Adafactor's {step_ms:.1f} ms")
    report["adamw"] = dict(losses=[m["loss"] for m in logs], mean_step_ms=adamw_ms)
    lap("adamw run")
    store = []
    # eager: the spy reads every step's compression, which a replay skips
    with cut_depth(layers), recorded_compression(store), counted_launches(got):
        logs = train_mod.main(argv + ["--steps", "2", "--device", device, "--grad-compression",
                                      "int8", "--no-graphs"])
    if not all(math.isfinite(m["loss"]) for m in logs) or len(store) != 2:
        raise AssertionError(f"int8 run: losses {[m['loss'] for m in logs]}, {len(store)} "
                             f"compressions")
    if device == "cuda":
        expect_launches("granite train, int8", got, {"moe_ffn": layers * 2 * 2})
    report["int8"] = dict(losses=[m["loss"] for m in logs],
                          steps_checked=check_int8_codes(torch, store, device))
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    del store
    lap("int8 run and codes")
    if profile_dir is not None:
        shutil.rmtree(profile_dir, ignore_errors=True)
        with cut_depth(layers), counted_launches(got):
            train_mod.main(argv + ["--steps", "1", "--device", device, "--profile-dir",
                                   str(profile_dir)])
        if device == "cuda":
            expect_launches("granite train, --profile-dir", got, {"moe_ffn": layers * 2})
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        path = os.path.join(profile_dir, "trace.json")
        with open(path) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
        size_mb = os.path.getsize(path) / 1e6
        shutil.rmtree(profile_dir, ignore_errors=True)
        named = sorted(n for n in names if "tc_pass_kernel" in n)
        if device == "cuda" and not named:
            raise AssertionError("the --profile-dir trace names no moe_ffn tensor-core kernel")
        log(f"  --profile-dir: trace.json of {size_mb:.1f} MB, {len(names)} event names, "
            f"moe_ffn's kernels {named[:2]}")
        report["profile"] = dict(trace_mb=size_mb, moe_ffn_kernels=named)
        lap("profile run")
    log(f"  (d)'s parts, seconds: {', '.join(f'{k} {v:.1f}' for k, v in seconds.items())}")
    report["seconds"] = seconds
    return report, launches


def phase_families(torch):
    """Phase 12: the decoder-LM families served at full width on the
    card and granite's training; returns (report, launches of the phase)."""
    log(f"phase 12: families: granite served at full width and 8 top-1 prototyping, "
        f"qwen2.5-32b over int8 pools, olmoe-1b-7b, granite training ({card_line()})")
    launches = {}
    report, got = family_serving_runs(torch, family_configs(), "cuda")
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    report["(d) granite training"], got = family_train(
        torch, FAMILY_TRAIN_ARGS, "cuda", profile_dir=ROOT / "build" / "chip_smoke_profile")
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    return report, launches


# ---------------------------------------------------------------------------
# Phase 13: more families: the paper's MoE attention (Fig. 4), a mixed
# dense/MoE stack, and xlstm-125m
# ---------------------------------------------------------------------------

MORE_TRAIN_STEPS = 4             # Fig. 4's runs, a step each more than phase 6's prototyping
MIXED_PERIOD = 2                 # MoE in layers 0, 2 and 4 of m6-base's five
MIXED_TRAIN_STEPS = 2
XLSTM_TRAIN_ARGS = ["--arch", "xlstm-125m", "--batch", "4", "--seq", "1024", "--log-every", "1"]
XLSTM_TRAIN_STEPS = 2
XLSTM_TRAIN_LAYERS = 4           # one sLSTM block and three mLSTM (phase 19 (b) too)
XLSTM_CPU_REQUESTS = 4           # the trace's first requests, served again on the CPU
MORE_FAMILIES_KERNELS = ("moe_ffn", "paged_decode_attention", "ragged_ffn", "ragged_combine",
                         "decode_attention")


def moe_layers(cfg) -> int:
    """The MoE layers of a decoder stack (every layer of a uniform one)."""
    from repro_torch.nn.spec import is_moe_layer

    return sum(is_moe_layer(cfg, i) for i in range(cfg.num_layers))


def fig4_edits():
    """(label, config edit) of (a): MoE attention under top-1 and under
    the paper's 2 top-1 prototyping (``configs.m6.variant``)."""
    from repro_torch.configs.m6 import variant

    return (("top-1", lambda cfg: cfg.replace_moe(moe_attention=True)),
            ("2 top-1", lambda cfg: variant(cfg, "prototype", 2).replace_moe(moe_attention=True)))


def check_losses(label, logs, vocab) -> None:
    for m in logs:
        ok = (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
              and abs(m["loss"] - math.log(vocab)) <= LOSS_SLACK
              and 0.0 <= m.get("moe_dropped_fraction", 0.0) < 1.0)
        if not ok:
            raise AssertionError(f"{label}: step {m['step']}: loss {m['loss']} (ln V = "
                                 f"{math.log(vocab):.4f}), grad norm {m['grad_norm']}, dropped "
                                 f"fraction {m.get('moe_dropped_fraction')}")


def edited_train(torch, argv, edit, steps, device, label, compare=True, against_eager=False):
    """``steps`` steps through the train CLI on ``edit`` of its config
    (losses finite and within LOSS_SLACK of ln V, dropped fraction in [0,
    1); on the card moe_ffn launched MoE layers x steps x 2 (forward and
    remat recompute), all on the tensor cores, and nothing else), then,
    with ``against_eager``, the run again with --no-graphs
    (``eager_against``: losses bit-equal, the same launches), then, with
    ``compare``, one step's loss and gradients through the kernels
    against the plain versions (``compare_train_step``: the MoE attention's
    routing flips reported beside the FFN's).  Returns (report, launches)."""
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.train import device_batch
    from repro_torch.nn import count_params

    args = argv + ["--steps", str(steps), "--device", device]
    launches = {}
    with built_config(edit):
        cfg = train_mod.build(train_mod.build_parser().parse_args(args))
        if device == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        with counted_launches(launches):
            t0 = time.perf_counter()
            logs = train_mod.main(args)
            wall_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9 if device == "cuda" else None
        check_losses(label, logs, cfg.vocab_size)
        want = {"moe_ffn": moe_layers(cfg) * steps * 2} if cfg.moe.num_experts else {}
        if device == "cuda":
            expect_launches(label, launches, want)
        steady = logs[1:] or logs
        step_ms = sum(m["step_time_s"] for m in steady) / len(steady) * 1e3
        report = dict(params_b=count_params(cfg) / 1e9, losses=[m["loss"] for m in logs],
                      grad_norms=[m["grad_norm"] for m in logs],
                      dropped_fraction=[m.get("moe_dropped_fraction", 0.0) for m in logs],
                      mean_step_ms=step_ms, first_step_ms=logs[0]["step_time_s"] * 1e3,
                      peak_memory_gb=peak, wall_s=wall_s,
                      launches={n: launches[n] for n in KERNEL_NAMES if launches[n]})
        peak_text = f", peak memory {peak:.1f} GB" if peak is not None else ""
        log(f"  {label}: {cfg.num_layers} layers ({moe_layers(cfg)} MoE), "
            f"{report['params_b']:.3f} B params, {steps} steps: losses "
            f"{[round(x, 4) for x in report['losses']]}, dropped fraction "
            f"{[round(x, 4) for x in report['dropped_fraction']]}; mean step {step_ms:.1f} ms "
            f"(host clock, synced; first {report['first_step_ms']:.0f} ms){peak_text}; "
            f"launches {report['launches']}")
        if against_eager:
            if device == "cuda":
                torch.cuda.empty_cache()
            report["graphed_vs_eager"] = eager_against(torch, args, label, logs, launches)
        if compare:
            cfg, state, _, pipeline = train_setup(args)
            batch = device_batch(pipeline.batch_at(0), device)
            report["kernels_vs_plain"] = compare_train_step(torch, cfg, state.params, batch)
            del state
    if device == "cuda":
        torch.cuda.empty_cache()
    return report, launches


def mixed_stack_runs(torch, cfg, device, train_argv, requests=None, max_len=None,
                     train_edit=None, shape=(STATIC_BATCH, STATIC_PROMPT, STATIC_GEN)):
    """(b): ``cfg`` (dropless m6 at moe_layer_period 2) over phase 5's trace
    through the continuous engine (conservation after every step;
    ``family_serve``'s gates: paged kernel layers x steps, ragged FFN MoE
    layers x steps, tokens equal to the plain versions' but at near-ties),
    the static engine on an equal-length batch (``static_parity``: tokens
    equal to the continuous engine's, dense kernel layers x decode steps),
    and ``MIXED_TRAIN_STEPS`` steps through the train CLI at the same
    period (moe_ffn MoE layers x steps x 2).  ``requests`` defaults to phase
    5's trace.  Returns (report, launches)."""
    import numpy as np

    from repro_torch.nn import init_params
    from repro_torch.serving.trace import synthetic_trace

    total, report = {}, {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    params = init_params(cfg, seed=0, device=device)
    requests = requests or synthetic_trace(16, cfg.vocab_size, seed=0)
    report["continuous"], got = family_serve(torch, cfg, params, requests, device,
                                             "(b) continuous", max_len=max_len,
                                             check_invariants=True)
    add(got)
    B, S, gen = shape
    prompts = np.random.default_rng(STATIC_SEED).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    report["static"], got = static_parity(torch, cfg, params, prompts, gen, device, "(b) static")
    add(got)
    del params
    if device == "cuda":
        torch.cuda.empty_cache()
    edit = train_edit or (lambda c: c.replace(moe_layer_period=cfg.moe_layer_period))
    report["train"], got = edited_train(torch, train_argv, edit, MIXED_TRAIN_STEPS, device,
                                        "(b) train", compare=False)
    add(got)
    return report, total


def xlstm_runs(torch, cfg, device, train_argv, n_requests=16, cpu_requests=XLSTM_CPU_REQUESTS,
               shape=(STATIC_BATCH, STATIC_PROMPT, STATIC_GEN), train_steps=XLSTM_TRAIN_STEPS):
    """(c): ``cfg`` (xlstm) over its own synthetic trace through the
    continuous engine in recurrent slots (every budget met, conservation
    after every step, no kernel launched); the static engine's token-by-token
    ``generate`` on an equal-length batch, equal to the continuous engine's
    on it; the trace's first ``cpu_requests`` requests again on the CPU
    (the same params there), the card's tokens equal to the CPU's but at
    near-ties of the CPU run's top two logits; then ``train_steps`` steps
    through the train CLI (losses finite and within LOSS_SLACK of ln V).
    Returns the report."""
    import numpy as np

    from repro_torch.configs.base import ServeConfig
    from repro_torch.nn import count_params, init_params
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request
    from repro_torch.serving.trace import latency_line, synthetic_trace

    report = {}
    params = init_params(cfg, seed=0, device=device)
    requests = synthetic_trace(n_requests, cfg.vocab_size, seed=0)
    serve = ServeConfig(max_len=max(256, max(r.total_len for r in requests)))
    serve_once(torch, cfg, params, serve, [Request(uid=0, prompt=requests[0].prompt,
                                                   max_new_tokens=3)], device)   # warm-up
    launches = {}
    with counted_launches(launches):
        out, stats, eng, wall_ms = serve_once(torch, cfg, params, serve, requests, device,
                                              check_invariants=True)
    if device == "cuda":
        expect_launches("(c) continuous", launches, {})
    eager, estats, eeng, e_wall = serve_once(torch, cfg, params, serve, requests, device,
                                             check_invariants=True, graphs=False)
    if eager != out:
        raise AssertionError("(c) continuous: the graphed recurrent step's greedy tokens differ "
                             "from the eager one's")
    report["continuous"] = dict(
        params_b=count_params(cfg) / 1e9, tokens_per_s=stats["generated_tokens_per_s"],
        p50_ms=stats["p50_ms"], p95_ms=stats["p95_ms"], steps=eng.steps,
        mean_step_ms=wall_ms / eng.steps, max_slots=serve.max_slots,
        graphs=sum(f.graph is not None for f in eng._rec_forms.values()),
        eager_tokens_per_s=estats["generated_tokens_per_s"], eager_p50_ms=estats["p50_ms"],
        eager_p95_ms=estats["p95_ms"], eager_mean_step_ms=e_wall / eeng.steps,
        tokens_identical_to_eager=True)
    log(f"  (c) xlstm continuous, recurrent slots, the step and slot reset "
        f"{'graphed' if report['continuous']['graphs'] else 'eager'}: {latency_line(stats)}; "
        f"{eng.steps} steps of ({serve.max_slots}, 1), mean step {wall_ms / eng.steps:.2f} ms "
        f"(host clock); eager forms {e_wall / eeng.steps:.2f} ms a step, "
        f"{estats['generated_tokens_per_s']:.1f} tokens/s, greedy tokens identical; no kernel "
        f"launched")
    del eeng

    B, S, gen = shape
    prompts = np.random.default_rng(STATIC_SEED).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    static = ServingEngine(cfg, params, max_len=S + gen + 1)
    static.generate(prompts[:, :4], 2)                                  # builds the form
    toks, sstats = static.generate(prompts, gen)
    batch = [Request(uid=i, prompt=prompts[i], max_new_tokens=gen) for i in range(B)]
    base, margins = tapped_margins(torch, cfg, params,
                                   ServeConfig(max_slots=B, max_len=S + gen + 1), batch, device)
    div = first_divergences(base, {i: toks[i].tolist() for i in range(B)}, margins, batch,
                            "(c) static vs continuous")
    log(f"  (c) static token-by-token generate of {B} x {S}, {gen} tokens: {B - len(div)} of "
        f"{B} rows equal to the continuous engine's; prompt {sstats['prefill_s'] * 1e3:.1f} ms, "
        f"decode {sstats['decode_tokens_per_s']:.1f} tokens/s")
    report["static"] = dict(rows_equal=B - len(div), rows=B,
                            divergences=[dict(request=u, token=p, gap=g) for u, p, g in div],
                            prompt_ms=sstats["prefill_s"] * 1e3,
                            decode_tokens_per_s=sstats["decode_tokens_per_s"])
    report["static graphed vs eager"] = graphed_vs_eager_generate(
        torch, cfg, params, prompts, gen, "(c) static graphed vs eager", {}, forms=1)
    if device == "cuda":
        for g, key in ((True, "static profile"), (False, "static eager profile")):
            report[key] = profile_static(torch, cfg, params, prompts, gen, cpu=False, graphs=g)

    if device == "cuda":
        t0 = time.perf_counter()
        cpu_params = _to_cpu(params)
        few = requests[:cpu_requests]
        base, margins = tapped_margins(torch, cfg, cpu_params, ServeConfig(
            max_slots=len(few), max_len=serve.max_len), few, "cpu")
        div = first_divergences(base, {r.uid: out[r.uid] for r in few}, margins, few,
                                "(c) card vs CPU")
        cpu_s = time.perf_counter() - t0
        log(f"  (c) the trace's first {len(few)} requests on the CPU ({cpu_s:.1f} s): "
            f"{len(few) - len(div)} of {len(few)} equal to the card's")
        report["card_vs_cpu"] = dict(requests=len(few), equal=len(few) - len(div),
                                     divergences=[dict(request=u, token=p, gap=g)
                                                  for u, p, g in div], cpu_s=cpu_s)
        del cpu_params
    del params, eng, static
    if device == "cuda":
        torch.cuda.empty_cache()
    report["train"], _ = edited_train(torch, train_argv,
                                      lambda c: c.replace(num_layers=XLSTM_TRAIN_LAYERS),
                                      train_steps, device, "(c) xlstm train", compare=False,
                                      against_eager=True)
    return report


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.to("cpu")


def phase_more_families(torch):
    """Phase 13: Fig. 4's MoE attention runs and a mixed stack at m6-base's
    full width, and xlstm-125m at its own; returns (report, launches)."""
    from repro_torch.configs import registry
    from repro_torch.configs.m6 import M6_BASE

    log(f"phase 13: more families: MoE attention (Fig. 4) and a mixed dense/MoE stack at "
        f"m6-base width, xlstm-125m served and trained ({card_line()})")
    launches, report = {}, {}

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    t0 = time.perf_counter()
    for label, edit in fig4_edits():
        report[f"(a) moe attention, {label}"], got = edited_train(
            torch, TRAIN_ARGS, edit, MORE_TRAIN_STEPS, "cuda", f"(a) moe attention, {label}")
        add(got)
    report["(a) seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mixed = M6_BASE.replace(moe_layer_period=MIXED_PERIOD).replace_moe(
        impl="dropless", capacity_factor=None)
    report["(b) mixed stack"], got = mixed_stack_runs(torch, mixed, "cuda", TRAIN_ARGS)
    add(got)
    report["(b) seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    report["(c) xlstm-125m"] = xlstm_runs(torch, registry.get_config("xlstm-125m"), "cuda",
                                          XLSTM_TRAIN_ARGS)
    report["(c) seconds"] = time.perf_counter() - t0
    return report, launches


# ---------------------------------------------------------------------------
# Phase 14: zamba2-7b: Mamba2 / SSD blocks and the shared attention at full
# width and depth through the static engine, trained at 7 layers
# ---------------------------------------------------------------------------

ZAMBA_HEADS = (32, 32, 224)      # the shared attention's Hq, Hkv, D: 2 x 3584 over 32 heads
ZAMBA_CUT_LAYERS = 7             # (c), (d): segments (0, 6) and (6, 7), two applications
ZAMBA_CPU_SHAPE = (4, 16, 8)     # (c): rows, prompt tokens, generated tokens
ZAMBA_PROFILE_SHAPE = (8, 4)     # a profiled generate: the batch's first 8 prompt tokens, 4 more
ZAMBA_TRAIN_ARGS = ["--arch", "zamba2-7b", "--batch", "4", "--seq", "1024", "--log-every", "1"]
ZAMBA_TRAIN_STEPS = 2
ZAMBA_CLI_REQUESTS = 8           # (e): one FCFS group of 8 (the script's time)


def zamba_decode_lengths(requests, batch=STATIC_BATCH):
    """The attended length of every decode step of ``run_trace_static`` on
    zamba: a group feeds its prompt token by token, then decodes gen - 1
    tokens, at lengths 1 .. S + gen - 1."""
    return [n for _, prompts, gen in static_groups(requests, batch)
            for n in range(1, prompts.shape[1] + gen)]


def tapped_generate(torch, cfg, params, prompts, gen, max_len=None, eng=None, graphs=True):
    """``ServingEngine.generate`` (of ``eng``, or of a new engine, its
    forms captured on the card unless ``graphs`` is false: under
    ``plain_versions()`` they must not be) with its sampler tapped:
    (tokens (B, gen), {(row, token index): (top-two logit gap, top
    logit)}, the generate's stats)."""
    from unittest import mock

    from repro_torch.serving.engine import ServingEngine

    V, S = cfg.vocab_size, prompts.shape[1]
    margins = {}
    real = ServingEngine._sample

    def tap(self, logits, position, temperature, seed):
        top2 = torch.topk(logits[:, -1, :V].float(), 2, dim=-1).values.cpu()
        for i in range(top2.shape[0]):
            margins[i, position - S + 1] = (float(top2[i, 0] - top2[i, 1]), float(top2[i, 0]))
        return real(self, logits, position, temperature, seed)

    eng = eng or ServingEngine(cfg, params, max_len=max_len or S + gen + 1, graphs=graphs)
    with mock.patch.object(ServingEngine, "_sample", tap):
        toks, stats = eng.generate(prompts, gen)
    return toks, margins, stats


def generate_vs_plain(torch, cfg, params, prompts, gen, device, label, want, steps):
    """The static engine's greedy ``generate`` of ``steps`` decode steps:
    tokens in the vocabulary; on the card each kernel launched ``want``
    times (and every FFN launch on the tensor cores), nothing else; the
    tokens equal to the same engine's on the plain versions but at
    near-ties.  Returns (report, launches)."""
    B, S = prompts.shape
    toks, stats, launches, wall_ms = static_generate(torch, cfg, params, prompts, gen)
    if not ((toks >= 0) & (toks < cfg.vocab_size)).all() or toks.shape != (B, gen):
        raise AssertionError(f"{label}: tokens of shape {toks.shape} outside the vocabulary")
    if device == "cuda":
        expect_launches(label, launches, want)
    t0 = time.perf_counter()
    with plain_versions():
        base, margins, _ = tapped_generate(torch, cfg, params, prompts, gen, graphs=False)
    plain_s = time.perf_counter() - t0
    div = divergences({i: base[i] for i in range(B)}, {i: toks[i] for i in range(B)},
                      lambda k, p: margins[k, p], f"{label} kernels vs plain")
    shown = {n: launches[n] for n in KERNEL_NAMES if launches[n]}
    log(f"  {label}: generate of {B} x {S} prompts, {gen} tokens, {steps} steps: {B - len(div)} "
        f"of {B} rows equal to the plain versions' (their run {plain_s:.1f} s); prompt "
        f"{stats['prefill_s'] * 1e3:.1f} ms, decode {stats['decode_tokens_per_s']:.1f} tokens/s, "
        f"mean step {wall_ms / steps:.2f} ms (host clock, synced), wall {wall_ms:.0f} ms; "
        f"launches {shown}")
    return dict(rows=B, rows_equal_to_plain=B - len(div),
                divergences=[dict(row=k, token=p, gap=g) for k, p, g in div],
                steps=steps, mean_step_ms=wall_ms / steps, wall_ms=wall_ms,
                prompt_ms=stats["prefill_s"] * 1e3,
                decode_tokens_per_s=stats["decode_tokens_per_s"],
                tokens_per_s=B * gen / (wall_ms / 1e3), plain_run_s=plain_s,
                launches=shown), launches


def zamba_card_vs_cpu(torch, cfg, prompts, gen, cut_layers):
    """(c): ``cfg`` cut to ``cut_layers`` layers, random params from seed 0
    on the card and a copy on the CPU: the card's greedy tokens equal to
    the CPU's but at near-ties of the CPU run's top two logits."""
    from repro_torch.models.zamba import _n_shared, _segments
    from repro_torch.nn import count_params, init_params

    cut = cfg.replace(num_layers=cut_layers)
    params = init_params(cut, seed=0, device="cuda")
    B, S = prompts.shape
    toks, _, launches, wall_ms = static_generate(torch, cut, params, prompts, gen)
    expect_launches("(c) card", launches, {"decode_attention": _n_shared(cut) * (S + gen - 1)})
    t0 = time.perf_counter()
    base, margins, _ = tapped_generate(torch, cut, _to_cpu(params), prompts, gen)
    cpu_s = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()
    div = divergences({i: base[i] for i in range(B)}, {i: toks[i] for i in range(B)},
                      lambda k, p: margins[k, p], "(c) card vs CPU")
    log(f"  (c) {cut_layers} layers (segments {_segments(cut)}, {count_params(cut) / 1e9:.3f} B "
        f"params), {B} x {S} prompts, {gen} tokens: {B - len(div)} of {B} rows on the card "
        f"equal to the CPU's (card {wall_ms:.0f} ms, CPU {cpu_s:.1f} s)")
    return dict(layers=cut_layers, params_b=count_params(cut) / 1e9, rows=B,
                rows_equal=B - len(div), card_ms=wall_ms, cpu_s=cpu_s,
                divergences=[dict(row=k, token=p, gap=g) for k, p, g in div])


def zamba_cli(torch, cfg, params, cli_argv, device, n_requests=16, batch=STATIC_BATCH):
    """(b) and (e): the serve CLI with ``--engine static --requests N
    --batch 8``, which serves ``synthetic_trace(N, vocab, seed=0)`` by
    ``run_trace_static`` in FCFS groups from its own random params (seed
    0: ``params``'s values): every budget met; on the card the dense
    kernel launched n_shared x decode steps times (every prompt token a
    step) and nothing else; each group's tokens equal to the same engine's
    on the plain versions (over ``params``) but at near-ties of its top
    two logits.  Then ``--engine continuous``, which must refuse zamba
    with the reference's reason.  Returns (report, launches)."""
    from unittest import mock

    from repro_torch.launch import serve as serve_cli
    from repro_torch.models.zamba import _n_shared

    argv = list(cli_argv) + ["--requests", str(n_requests), "--batch", str(batch),
                             "--device", device]
    got = {}
    real = serve_cli.run_trace_static

    def spy(engine, requests, batch, **kw):
        sync(torch, params["embed"]["table"])
        t0 = time.perf_counter()
        out = real(engine, requests, batch, **kw)
        sync(torch, params["embed"]["table"])
        got.update(out=out[0], requests=requests, T=engine.max_len,
                   wall_ms=(time.perf_counter() - t0) * 1e3)
        return out

    launches = {}
    with counted_launches(launches), mock.patch.object(serve_cli, "run_trace_static", spy):
        t0 = time.perf_counter()
        stats = serve_cli.main(argv + ["--engine", "static"])
        cli_s = time.perf_counter() - t0
    out, requests, T = got["out"], got["requests"], got["T"]
    for r in requests:
        if len(out[r.uid]) != r.max_new_tokens:
            raise AssertionError(f"(e) serve CLI: request {r.uid}: {len(out[r.uid])} tokens, "
                                 f"budget {r.max_new_tokens}")
    steps = len(zamba_decode_lengths(requests, batch))
    if device == "cuda":
        expect_launches("(e) serve CLI", launches, {"decode_attention": _n_shared(cfg) * steps})
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    base, margins = {}, {}
    with plain_versions():
        for group, prompts, gen in static_groups(requests, batch):
            toks, marg, _ = tapped_generate(torch, cfg, params, prompts, gen, max_len=T,
                                            graphs=False)
            for j, r in enumerate(group):
                base[r.uid] = toks[j, :r.max_new_tokens].tolist()
                margins.update({(r.uid, p): m for (row, p), m in marg.items() if row == j})
    plain_s = time.perf_counter() - t0
    div = divergences(base, out, lambda k, p: margins[k, p], "(e) trace kernels vs plain")
    try:
        serve_cli.main(argv + ["--engine", "continuous"])
    except NotImplementedError as e:
        refusal = str(e)
    else:
        raise AssertionError("(e): the continuous engine served zamba")
    if "zamba" not in refusal:
        raise AssertionError(f"(e): the continuous engine's refusal does not name zamba: {refusal}")
    shown = {n: launches[n] for n in KERNEL_NAMES if launches[n]}
    log(f"  (e) serve CLI --engine static, {n_requests} requests in groups of {batch}: "
        f"{stats['generated_tokens_per_s']:.1f} tokens/s, p50 {stats['p50_ms']:.0f} ms p95 "
        f"{stats['p95_ms']:.0f} ms; cache T = {T}, {steps} steps, mean step "
        f"{got['wall_ms'] / steps:.2f} ms (host clock, synced; {cli_s:.1f} s with its random "
        f"init); {len(requests) - len(div)} of {len(requests)} requests' tokens equal to the "
        f"plain versions' (their run {plain_s:.1f} s); launches {shown}; --engine continuous "
        f"refused: {refusal}")
    return dict(tokens_per_s=stats["generated_tokens_per_s"], p50_ms=stats["p50_ms"],
                p95_ms=stats["p95_ms"], total_ms=stats["total_ms"], batch=batch, max_len=T,
                steps=steps, mean_step_ms=got["wall_ms"] / steps, cli_s=cli_s,
                requests_equal_to_plain=len(requests) - len(div),
                divergences=[dict(request=k, token=p, gap=g) for k, p, g in div],
                plain_run_s=plain_s, launches=shown, continuous_refusal=refusal), launches


def zamba_runs(torch, cfg, device, train_argv, cli_argv=("--arch", "zamba2-7b"),
               shape=(STATIC_BATCH, STATIC_PROMPT, STATIC_GEN), cut_layers=ZAMBA_CUT_LAYERS,
               cpu_shape=ZAMBA_CPU_SHAPE, train_steps=ZAMBA_TRAIN_STEPS,
               cli_requests=ZAMBA_CLI_REQUESTS):
    """(b)-(e) over ``cfg`` (zamba2-7b, or its smoke config with ``--smoke``
    in ``cli_argv`` for a CPU rehearsal), random params from seed 0; the
    serve CLI's trace of ``cli_requests``.  Returns (report, launches)."""
    import numpy as np

    from repro_torch.models.zamba import _n_shared
    from repro_torch.nn import count_params, init_params

    total, report = {}, {}

    def add(got):
        for k, v in got.items():
            total[k] = total.get(k, 0) + v

    cuda = device == "cuda"
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=device)
    sync(torch, params["embed"]["table"])
    log(f"  (b) {cfg.name}: {cfg.num_layers} Mamba2 layers, d {cfg.d_model}, "
        f"{_n_shared(cfg)} applications of the shared block ({cfg.num_heads} heads of "
        f"{2 * cfg.d_model // cfg.num_heads}), {count_params(cfg):,} params, random init in "
        f"{time.perf_counter() - t0:.1f} s")
    B, S, gen = shape
    prompts = np.random.default_rng(STATIC_SEED).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    report["(b) generate"], got = generate_vs_plain(
        torch, cfg, params, prompts, gen, device, "(b) generate",
        {"decode_attention": _n_shared(cfg) * (S + gen - 1)}, S + gen - 1)
    add(got)
    if cuda:
        peak = torch.cuda.max_memory_allocated() / 1e9
        report["(b) peak_memory_gb"] = peak
        log(f"  (b) peak memory of the generate {peak:.1f} GB (weights "
            f"{count_params(cfg) * 2 / 1e9:.1f} GB in bf16)")
    report["(b) graphed vs eager"] = graphed_vs_eager_generate(
        torch, cfg, params, prompts, gen, "(b) graphed vs eager",
        {"decode_attention": _n_shared(cfg) * (S + gen - 1)}, forms=1)
    if cuda:
        p_len, p_gen = ZAMBA_PROFILE_SHAPE
        for g, key in ((True, "(b) profile"), (False, "(b) eager profile")):
            report[key] = profile_static(torch, cfg, params, prompts[:, :p_len], p_gen,
                                         cpu=False, graphs=g)
    report["params"] = count_params(cfg)
    report["(e) serve CLI trace"], got = zamba_cli(torch, cfg, params, cli_argv, device,
                                                   cli_requests)
    add(got)
    del params
    if cuda:
        torch.cuda.empty_cache()
        rows, c_len, c_gen = cpu_shape
        report["(c) card vs CPU"] = zamba_card_vs_cpu(torch, cfg, prompts[:rows, :c_len], c_gen,
                                                      cut_layers)
    calls = []
    with counted_chunked(calls):
        report["(d) train"], got = edited_train(
            torch, train_argv, lambda c: c.replace(num_layers=cut_layers), train_steps, device,
            "(d) zamba train", compare=False, against_eager=True)
    if calls:
        raise AssertionError(f"(d): the chunked attention path ran {calls}; S x T = 2^20 takes "
                             f"the materialised scores")
    add(got)
    return report, total


def phase_zamba(torch):
    """Phase 14: zamba2-7b served at full width and depth by the static
    engine and its serve CLI, the card against the CPU at 7 layers, and
    trained at 7 layers; returns (report, launches)."""
    from repro_torch.configs import registry

    log(f"phase 14: zamba2-7b: the static engine at full width and depth, the serve CLI, "
        f"the card against the CPU and training at {ZAMBA_CUT_LAYERS} layers ({card_line()})")
    return zamba_runs(torch, registry.get_config("zamba2-7b"), "cuda", ZAMBA_TRAIN_ARGS)


def zamba_shapes():
    """The dense kernel's shapes on zamba's path: (cache T, the median
    attended length) of the trace run and of the 8 x 48 batch, every step
    of a group at one length."""
    from repro_torch.serving.trace import static_max_len, synthetic_trace

    requests = synthetic_trace(16, 32000, seed=0)
    lens = sorted(zamba_decode_lengths(requests))
    return {"trace": (static_max_len(requests), lens[len(lens) // 2]),
            "batch": (STATIC_PROMPT + STATIC_GEN + 1, (STATIC_PROMPT + STATIC_GEN) // 2)}


def check_zamba_kernel(torch):
    """The dense kernel at zamba's shared attention (bf16, B 8, Hkv 32, G 1,
    D 224, the trace's cache) against its plain version at TOL and its
    split-and-merge plain version, length-0 rows exactly 0: the plan and
    every split forced; a ring that wraps (a 1000-position row of a
    1024-position cache) at splits 1 and 2; cache rows of 1e4 / -1e4 past
    every length; f32 (two 16-byte loads a lane); the engine's shapes,
    every row at one length.  Returns {"decode_attention": max abs err}."""
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.decode_attention import ref as dref

    Hq, Hkv, D = ZAMBA_HEADS
    err = 0.0

    def run(label, case, splits=None, max_length=None):
        nonlocal err
        q, k = case[0], case[1]
        out = da.decode_attention(*case, splits=splits, max_length=max_length)
        torch.cuda.synchronize()
        B, T = q.shape[0], k.shape[1]
        plan = da.dense_plan(B, Hkv, 1, D, T, q.element_size(), da._sm_count(0), splits,
                             max_length)
        name = (f"decode_attention zamba {label} B={B} T={T} D={D} {str(q.dtype)[6:]} "
                f"splits={plan[0]}{' (plan)' if splits is None else ''} stages={plan[1]}")
        err = max(err, check_close(name, out, dref.decode_attention_ref(*case)))
        check_close(f"{name} vs split plain", out,
                    dref.decode_attention_split_ref(*case, plan[0]))
        if not (out[case[3] == 0] == 0).all():
            raise AssertionError(f"{name}: a length-0 row is not exactly 0")

    T, _ = zamba_shapes()["trace"]
    lens = [0, 1, T - 1, 77, 48, 16, 15, 9]
    for splits in (None, *da.SPLITS):
        run("forced" if splits else "", dense_case(8, T, Hq, Hkv, D, lens, seed=800), splits,
            max(lens))
    for splits in (1, 2):
        run("ring wraps", dense_case(3, 1024, Hq, Hkv, D, [1000, 0, 37], seed=801), splits)
    q, k, v, lengths = dense_case(8, T, Hq, Hkv, D, lens, seed=802)
    past = torch.arange(T, device="cuda")[None, :] >= lengths[:, None]
    k[past], v[past] = 1e4, -1e4
    for splits in (None, 1, 4):
        run("1e4 past the lengths", (q, k, v, lengths), splits)
    for splits in (None, 1, 2):
        run("f32", dense_case(8, T, Hq, Hkv, D, lens, seed=803, dtype=torch.float32), splits,
            max(lens))
    for label, (T, length) in zamba_shapes().items():
        case = dense_case(8, T, Hq, Hkv, D, [length] * 8, seed=804 + T)
        run(f"{label} at length {length}", case, None, length)
        run(f"{label} at length {length}, the static plan", case)
    return {"decode_attention": err}


def phase_timing_zamba(torch):
    """The dense kernel at zamba's shared attention, as phase 4 times its
    own: the trace's cache at its median and its longest attended length,
    beside SDPA with a length mask and the bytes bound."""
    T, length = zamba_shapes()["trace"]
    out = {"decode_attention zamba": time_dense(torch, [length] * 8, 810, T=T,
                                                heads=ZAMBA_HEADS),
           "decode_attention zamba longest": time_dense(torch, [T - 1] * 8, 811, T=T,
                                                        heads=ZAMBA_HEADS)}
    for name, r in out.items():
        log(f"  {name} (T {T}, length {length if name.endswith('zamba') else T - 1}): "
            f"{timing_line(r)}; {plan_line(r)}")
    return out



# ---------------------------------------------------------------------------
# Phase 15: seamless-m4t-large-v2 (encdec) at full width and depth: encoded,
# decoded greedily with cross-attention on the dense decode kernel, and
# trained; the logit softcap on the static path
# ---------------------------------------------------------------------------

ENCDEC_ARCH = "seamless-m4t-large-v2"
ENCDEC_SHAPE = (8, 256, 48)        # (a): rows, source frames, target tokens
ENCDEC_FEED = 8                    # (a), (b): target tokens fed before the greedy steps
ENCDEC_MAX_LEN = 64                # (a), (b): the self caches' positions
ENCDEC_PROFILE_TOKENS = 16         # (a): a profiled loop's target tokens
ENCDEC_CUT_LAYERS = 2              # (b): encoder and decoder layers, card and CPU
ENCDEC_CPU_SHAPE = (4, 256, 24)    # (b): rows, source frames, target tokens
ENCDEC_TRAIN_ARGS = ["--arch", ENCDEC_ARCH, "--batch", "4", "--seq", "256", "--log-every", "1"]
ENCDEC_TRAIN_STEPS = 2
ENCDEC_REFUSALS = {"static": "use encdec.init_state with real memory for concrete states",
                   "continuous": "encdec needs per-request encoder memory"}
SOFTCAP = 5.0                      # phase 3 and 4: the dense kernel's cap
SOFTCAP_SCORE = 20.0               # phase 3: q scaled so that the largest scores reach about this
STATIC_SOFTCAP = 0.5               # (e): m6-base's cap, of the order of its random scores


def vocab_whole(last, cfg):
    """(B, V_pad) logits from a rank's vocab columns under the active rules
    (all-gathered over the vocab's axis, as the static engine gathers
    them), or as they are."""
    from repro_torch.distributed import collectives
    from repro_torch.distributed.sharding import tensor_parallel
    from repro_torch.nn.spec import padded_vocab

    if last.shape[-1] == padded_vocab(cfg.vocab_size):
        return last
    return collectives.all_gather(last, tensor_parallel("vocab")[0], dim=-1)


def encdec_greedy(torch, cfg, params, frames, feed, total, tap=False):
    """``encode`` the frames, ``init_state(ENCDEC_MAX_LEN)``, feed the (B,
    F) tokens one ``decode_step`` at a time, then greedy steps to ``total``
    tokens (total - 1 steps); under rules that shard the vocab, argmax over
    the gathered logits.  Returns (the generated tokens {row: list},
    their top-two gaps {(row, index): (gap, top logit)} if ``tap``, encode
    ms, decode ms), host clock, synced."""
    from repro_torch.models import encdec as ED

    B, F = feed.shape
    V = cfg.vocab_size
    table = params["embed"]["table"]
    with torch.inference_mode():
        sync(torch, table)
        t0 = time.perf_counter()
        memory = ED.encode(params, frames, cfg)
        sync(torch, table)
        encode_ms = (time.perf_counter() - t0) * 1e3
        state = ED.init_state(params, memory, cfg, ENCDEC_MAX_LEN)
        sync(torch, table)
        toks, tops = [feed[:, i] for i in range(F)], []
        t0 = time.perf_counter()
        for i in range(total - 1):
            logits, state = ED.decode_step(params, toks[i][:, None], state, cfg)
            if i + 1 >= F:
                last = vocab_whole(logits[:, -1].float(), cfg)[:, :V]
                toks.append(last.argmax(dim=-1))
                if tap:
                    tops.append(torch.topk(last, 2, dim=-1).values)
        sync(torch, table)
        decode_ms = (time.perf_counter() - t0) * 1e3
    gen = torch.stack(toks[F:], dim=1).cpu()
    margins = {}
    for p, top2 in enumerate(tops):
        top2 = top2.cpu()
        for r in range(B):
            margins[r, p] = (float(top2[r, 0] - top2[r, 1]), float(top2[r, 0]))
    return {r: gen[r].tolist() for r in range(B)}, margins, encode_ms, decode_ms


def encdec_batch(torch, cfg, shape, device):
    """``SyntheticSeq2Seq(V, d, B, src_len, tgt_len, seed=0).batch_at(0)``:
    (frames on ``device``, target tokens (B, tgt_len) on ``device``)."""
    from repro_torch.data.pipeline import SyntheticSeq2Seq

    B, src, tgt = shape
    b = SyntheticSeq2Seq(cfg.vocab_size, cfg.d_model, B, src_len=src, tgt_len=tgt,
                         seed=0).batch_at(0)
    return (torch.from_numpy(b["frames"]).to(device),
            torch.from_numpy(b["tokens"]).long().to(device))


def encdec_decode(torch, cfg, params, shape, feed, device, label="(a) decode"):
    """(a): ``encdec_greedy`` over ``encdec_batch``: on the card the dense
    kernel launched 2 x layers x steps times (self- and cross-attention)
    and nothing else; logits finite (every greedy token in the vocabulary);
    the tokens equal to the same loop's on the plain versions but at
    near-ties of its top two logits.  Returns (report, launches)."""
    B, src, total = shape
    steps = total - 1
    frames, toks = encdec_batch(torch, cfg, shape, device)
    encdec_greedy(torch, cfg, params, frames[:, :16], toks[:, :2], 4)      # warm-up
    cuda = device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    launches = {}
    with counted_launches(launches):
        got, _, enc_ms, dec_ms = encdec_greedy(torch, cfg, params, frames, toks[:, :feed], total)
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    if cuda:
        expect_launches(label, launches, {"decode_attention": 2 * cfg.num_layers * steps})
    if any(not 0 <= t < cfg.vocab_size for row in got.values() for t in row):
        raise AssertionError(f"{label}: a greedy token outside the vocabulary (non-finite logits)")
    t0 = time.perf_counter()
    with plain_versions():
        base, margins, _, _ = encdec_greedy(torch, cfg, params, frames, toks[:, :feed], total,
                                            tap=True)
    plain_s = time.perf_counter() - t0
    if any(not math.isfinite(g) for g, _ in margins.values()):
        raise AssertionError(f"{label}: non-finite logits on the plain versions")
    div = divergences(base, got, lambda r, p: margins[r, p], f"{label} kernels vs plain")
    shown = {n: launches[n] for n in KERNEL_NAMES if launches[n]}
    peak_text = f", peak memory {peak:.2f} GB" if cuda else ""
    log(f"  {label}: {B} rows, {src} frames, {feed} tokens fed then greedy to {total} "
        f"({steps} decode steps, max_len {ENCDEC_MAX_LEN}): {B - len(div)} of {B} rows equal "
        f"to the plain versions' (their run {plain_s:.1f} s); encode {enc_ms:.2f} ms, mean "
        f"step {dec_ms / steps:.2f} ms, {B * steps / (dec_ms / 1e3):.1f} tokens/s (host clock, "
        f"synced){peak_text}; launches {shown}")
    return dict(rows=B, src_len=src, fed=feed, tokens=total, steps=steps, encode_ms=enc_ms,
                mean_step_ms=dec_ms / steps, decode_ms=dec_ms,
                decode_tokens_per_s=B * steps / (dec_ms / 1e3), peak_memory_gb=peak,
                rows_equal_to_plain=B - len(div), plain_run_s=plain_s,
                divergences=[dict(row=k, token=p, gap=g) for k, p, g in div],
                launches=shown), launches


def encdec_card_vs_cpu(torch, cfg, shape, feed, cut_layers):
    """(b): ``cfg`` cut to ``cut_layers`` encoder and decoder layers, random
    params from seed 0 on the card and a copy on the CPU: the card's greedy
    tokens (dense kernel 2 x layers x steps) equal to the CPU's but at
    near-ties of the CPU run's top two logits."""
    from repro_torch.nn import count_params, init_params

    cut = cfg.replace(num_layers=cut_layers, num_encoder_layers=cut_layers)
    params = init_params(cut, seed=0, device="cuda")
    B, src, total = shape
    frames, toks = encdec_batch(torch, cut, shape, "cuda")
    launches = {}
    with counted_launches(launches):
        got, _, _, dec_ms = encdec_greedy(torch, cut, params, frames, toks[:, :feed], total)
    expect_launches("(b) card", launches, {"decode_attention": 2 * cut_layers * (total - 1)})
    t0 = time.perf_counter()
    base, margins, _, _ = encdec_greedy(torch, cut, _to_cpu(params), frames.cpu(),
                                        toks[:, :feed].cpu(), total, tap=True)
    cpu_s = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()
    div = divergences(base, got, lambda r, p: margins[r, p], "(b) card vs CPU")
    log(f"  (b) {cut_layers} + {cut_layers} layers ({count_params(cut) / 1e9:.3f} B params), "
        f"{B} rows of {src} frames, greedy to {total} tokens: {B - len(div)} of {B} rows on "
        f"the card equal to the CPU's (card decode {dec_ms:.0f} ms, CPU {cpu_s:.1f} s)")
    return dict(layers=cut_layers, params_b=count_params(cut) / 1e9, rows=B,
                rows_equal=B - len(div), card_decode_ms=dec_ms, cpu_s=cpu_s,
                divergences=[dict(row=k, token=p, gap=g) for k, p, g in div])


def encdec_profile(torch, cfg, params, shape, feed):
    """(a): the busy share of a profiled greedy loop (the card's activity
    alone) over ENCDEC_PROFILE_TOKENS target tokens."""
    B, src, _ = shape
    frames, toks = encdec_batch(torch, cfg, shape, "cuda")
    return busy_share(
        torch, lambda: encdec_greedy(torch, cfg, params, frames, toks[:, :feed],
                                     ENCDEC_PROFILE_TOKENS),
        f"one encode and {ENCDEC_PROFILE_TOKENS - 1} decode steps of {B} rows", cpu=False)


def encdec_cli_refusals(torch, cli_argv, device):
    """(d): the serve CLI refuses the encdec id under both engines with the
    reference's reasons, launching no kernel.  Returns {engine: message}."""
    from repro_torch.launch import serve as serve_cli

    out, launches = {}, {}
    for engine, want in ENCDEC_REFUSALS.items():
        with counted_launches(launches):
            try:
                serve_cli.main(list(cli_argv) + ["--engine", engine, "--device", device])
            except NotImplementedError as e:
                out[engine] = str(e)
            else:
                raise AssertionError(f"(d): --engine {engine} served {cli_argv[1]}")
        if want not in out[engine]:
            raise AssertionError(f"(d): --engine {engine} refused with {out[engine]!r}, not "
                                 f"the reference's reason ({want!r})")
        if any(launches[n] for n in KERNEL_NAMES):
            raise AssertionError(f"(d): --engine {engine} launched {launches}")
        if device == "cuda":
            torch.cuda.empty_cache()
        log(f"  (d) serve CLI --engine {engine}: refused: {out[engine]}")
    return out


def encdec_runs(torch, cfg, device, train_argv, static_cfg, cli_argv=("--arch", ENCDEC_ARCH),
                shape=ENCDEC_SHAPE, feed=ENCDEC_FEED, cut_layers=ENCDEC_CUT_LAYERS,
                cpu_shape=ENCDEC_CPU_SHAPE, train_steps=ENCDEC_TRAIN_STEPS,
                static_shape=(STATIC_BATCH, STATIC_PROMPT, STATIC_GEN)):
    """(a)-(e) over ``cfg`` (seamless-m4t-large-v2, or its smoke config
    with ``--smoke`` in ``cli_argv`` and ``train_argv`` for a CPU
    rehearsal) and ``static_cfg`` (softcapped m6), random params from seed
    0.  Returns (report, launches)."""
    import numpy as np

    from repro_torch.nn import count_params, init_params

    total, report = {}, {}

    def add(got):
        for k, v in got.items():
            total[k] = total.get(k, 0) + v

    cuda = device == "cuda"
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=device)
    sync(torch, params["embed"]["table"])
    log(f"  (a) {cfg.name}: {cfg.num_encoder_layers} encoder + {cfg.num_layers} decoder "
        f"layers, d {cfg.d_model}, {cfg.num_heads} heads of {cfg.resolved_head_dim}, "
        f"{count_params(cfg):,} params, random init in {time.perf_counter() - t0:.1f} s")
    report["params"] = count_params(cfg)
    report["(a) decode"], got = encdec_decode(torch, cfg, params, shape, feed, device)
    add(got)
    if cuda:
        report["(a) profile"] = encdec_profile(torch, cfg, params, shape, feed)
    del params
    if cuda:
        torch.cuda.empty_cache()
        report["(b) card vs CPU"] = encdec_card_vs_cpu(torch, cfg, cpu_shape, feed, cut_layers)
    report["(c) train"], got = edited_train(torch, train_argv, lambda c: c, train_steps, device,
                                            "(c) encdec train", compare=False,
                                            against_eager=True)
    add(got)
    report["(d) serve CLI refusals"] = encdec_cli_refusals(torch, cli_argv, device)
    # (e): the static engine under a softcap (dense kernel layers x decode
    # steps, the ragged FFN MoE layers x (prefill + decode steps))
    sparams = init_params(static_cfg, seed=0, device=device)
    B, S, gen = static_shape
    prompts = np.random.default_rng(STATIC_SEED).integers(
        0, static_cfg.vocab_size, (B, S)).astype(np.int32)
    report["(e) static softcap"], got = generate_vs_plain(
        torch, static_cfg, sparams, prompts, gen, device,
        f"(e) softcap {static_cfg.attn_logit_softcap}",
        {"decode_attention": static_cfg.num_layers * (gen - 1),
         "ragged_ffn": moe_layers(static_cfg) * gen}, gen - 1)
    add(got)
    return report, total


def phase_encdec(torch):
    """Phase 15: seamless-m4t-large-v2 decoded greedily at full width and
    depth, the card against the CPU at 2 + 2 layers, trained at full depth,
    refused by both serving engines; m6-base's static engine under a
    softcap.  Returns (report, launches)."""
    from repro_torch.configs import registry
    from repro_torch.configs.m6 import M6_BASE

    log(f"phase 15: {ENCDEC_ARCH}: greedy decode at full width and depth, the card against "
        f"the CPU, training, the serve CLI's refusals; the softcap on the static path "
        f"({card_line()})")
    static_cfg = M6_BASE.replace_moe(impl="dropless", capacity_factor=None).replace(
        attn_logit_softcap=STATIC_SOFTCAP)
    return encdec_runs(torch, registry.get_config(ENCDEC_ARCH), "cuda", ENCDEC_TRAIN_ARGS,
                       static_cfg)


def check_encdec_kernel(torch):
    """Phase 15's shapes of the dense kernel against its plain and
    split-and-merge plain versions at TOL: cross-attention over the memory
    (B 8, Hkv 16, G 1, D 64, every row at T = S_src = 256, and at T = 250,
    whose last TMA box runs past T), the plan and every split forced, bf16
    and f32; then a softcap of SOFTCAP on q scaled so that the scores reach
    about +-SOFTCAP_SCORE, at m6's static trace shape and zamba's D = 224,
    with every row at one length (the engines' steps) and at mixed lengths
    with a length-0 row (exactly 0).  Returns {"encdec decode_attention":
    max abs err, "softcap decode_attention": max abs err}."""
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.decode_attention import ref as dref

    errs = {"encdec decode_attention": 0.0, "softcap decode_attention": 0.0}

    def run(key, label, case, splits, softcap=0.0):
        q, k, _, lengths = case
        max_length = int(lengths.max())
        out = da.decode_attention(*case, splits=splits, max_length=max_length, softcap=softcap)
        torch.cuda.synchronize()
        B, Hq, D = q.shape
        T, Hkv = k.shape[1], k.shape[2]
        plan = da.dense_plan(B, Hkv, Hq // Hkv, D, T, q.element_size(), da._sm_count(0), splits,
                             max_length)
        name = (f"decode_attention {label} B={B} T={T} Hkv={Hkv} D={D} {str(q.dtype)[6:]} "
                f"splits={plan[0]}{' (plan)' if splits is None else ''} stages={plan[1]}")
        want = dref.decode_attention_ref(*case, softcap=softcap)
        errs[key] = max(errs[key], check_close(name, out, want))
        check_close(f"{name} vs split plain", out,
                    dref.decode_attention_split_ref(*case, plan[0], softcap=softcap))
        if not (out[lengths == 0] == 0).all():
            raise AssertionError(f"{name}: a length-0 row is not exactly 0")

    for T in (256, 250):
        for dtype in (torch.bfloat16, torch.float32):
            for splits in (None, *da.SPLITS):
                run("encdec decode_attention", "cross-attention",
                    dense_case(8, T, 16, 16, 64, [T] * 8, seed=900 + T, dtype=dtype), splits)
    T, length = static_shapes()["trace"]
    zT, zlen = zamba_shapes()["trace"]
    for label, (Hq, Hkv, D), T, length in (("m6 static", (16, 16, 64), T, length),
                                           ("zamba", ZAMBA_HEADS, zT, zlen)):
        for lens in ([length] * 8, [0, 1, T - 1, length, 48, 16, 15, 9]):
            q, k, v, lengths = dense_case(8, T, Hq, Hkv, D, lens, seed=910 + T)
            q = q * (SOFTCAP_SCORE / 4.0)          # unit scores * 5: about 4 sigma reach 20
            s = torch.einsum("bhd,bthd->bth", q.float(), k.float()) * D ** -0.5   # G = 1
            top = float(s[torch.arange(T, device="cuda")[None, :] < lengths[:, None]].abs().max())
            for splits in (None, 1, 2, 4):
                run("softcap decode_attention", f"softcap {SOFTCAP} {label} (|s| <= {top:.1f})",
                    (q, k, v, lengths), splits, SOFTCAP)
    return errs


def phase_timing_encdec(torch):
    """The dense kernel at encdec's cross-attention (B 8, Hkv 16, D 64, every
    row at T = S_src = 256, and at 250) and at m6's static trace shape under
    the softcap, as phase 4 times its own (the static shape without a cap is
    ``decode_attention static``)."""
    T, length = static_shapes()["trace"]
    out = {"decode_attention encdec cross": time_dense(torch, [256] * 8, 920, T=256),
           "decode_attention encdec cross T=250": time_dense(torch, [250] * 8, 921, T=250),
           "decode_attention static softcap": time_dense(torch, [length] * 8, 164, T=T,
                                                         softcap=SOFTCAP)}
    for name, r in out.items():
        log(f"  {name}: {timing_line(r)}")
    return out


# ---------------------------------------------------------------------------
# Phase 16: serving on a (data, expert) mesh
# ---------------------------------------------------------------------------

MESH_TRIVIAL = (("data", 1), ("expert", 1))
MESH_RANKS = (("data", 2), ("expert", 2))     # (b): four processes that share the card
MESH_SPAWN_TIMEOUT = 600
# the step clocks of phase 5's run ("bf16") and phase 7 (a)'s int8 run
# ("int8"): phase 16 replays them, so that its engines admit as those runs
# did and every step's rows, and so every kernel's shapes, are theirs
STEP_CLOCKS = {}
# (b)'s kernel shapes, a shard's: 4 decode rows, or 4 + a 32-row chunk, on a
# pool slice of 64 blocks + garbage; the ragged FFN's received rows of one-
# token groups (bx = 8, R = 232), 2 (decode) or 18 (mixed) groups from each
# of 2 source ranks, on 16 of 32 experts
MESH_DECODE_LENS = [21, 56, 112, 9]
MESH_CHUNK = (40, 32)                           # the chunk's first position, rows
MESH_FFN_GROUPS = {"decode": 2, "mixed": 18}


@contextmanager
def recorded_clocks(store: list):
    """Every ``ContinuousEngine.step`` call's clock appended to ``store``."""
    from repro_torch.serving.continuous import ContinuousEngine

    real = ContinuousEngine.step

    def step(self, clock_ms: float = 0.0):
        store.append(clock_ms)
        return real(self, clock_ms)

    ContinuousEngine.step = step
    try:
        yield store
    finally:
        ContinuousEngine.step = real


def replay(torch, engine, requests, clocks):
    """Serve ``requests`` on ``engine`` stepping at ``clocks``, an earlier
    run's step clocks: the same admissions, so the same rows at every step.
    Returns ({uid: tokens}, wall ms)."""
    table = engine.params["embed"]["table"]
    for r in requests:
        engine.scheduler.add(r)
    out = {}
    sync(torch, table)
    t0 = time.perf_counter()
    for clock in clocks:
        for st in engine.step(clock):
            out[st.request.uid] = list(st.generated)
    sync(torch, table)
    wall_ms = (time.perf_counter() - t0) * 1e3
    if engine.scheduler.has_work() or len(out) != len(requests):
        raise AssertionError(f"replay: {len(out)} of {len(requests)} requests done after "
                             f"{len(clocks)} steps")
    check_census(engine, "replay")
    return out, wall_ms


def mesh_shard_case(seed, chunk=True, quant=None, dtype=None):
    """A shard's attention inputs in (b): ``MESH_DECODE_LENS`` decode rows
    (the last slot's masked when ``chunk``: it prefills) and, with
    ``chunk``, the 32 chunk rows of that slot, which share its table; a pool
    slice of 64 blocks + garbage (``shard_blocks + 1``)."""
    import torch

    dtype = dtype or torch.bfloat16
    Hq = Hkv = 16
    D, bs, MB, P = 64, 16, 16, 65
    g = torch.Generator(device="cuda").manual_seed(seed)
    lens = list(MESH_DECODE_LENS)
    start, n = MESH_CHUNK
    if chunk:
        lens[-1] = 0
        lens += [start + j + 1 for j in range(n)]
    N = len(lens)
    kp = torch.randn((P, Hkv, bs, D), generator=g, device="cuda").to(dtype)
    vp = torch.randn((P, Hkv, bs, D), generator=g, device="cuda").to(dtype)
    q = torch.randn((N, Hq, D), generator=g, device="cuda").to(dtype)
    perm = torch.randperm(P - 1, generator=g, device="cuda").reshape(4, MB).int()
    slot = [0, 1, 2, 3] + [3] * (N - 4)
    tables = perm[torch.tensor(slot, device="cuda")]
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    used = torch.arange(MB, device="cuda")[None, :] * bs < lengths[:, None]
    tables = torch.where(used, tables, torch.full_like(tables, P - 1)).contiguous()
    if quant is None:
        return q, kp, vp, tables, lengths
    kc, ks, vc, vs = quantize_pools(kp, vp, quant)
    return q, kc, vc, ks, vs, tables, lengths


def mesh_ffn_case(groups, seed, weights=None, ne=2, shard=0, E=32, M=1024, I=4096, tokens=1,
                  bx=8):
    """The rows expert shard ``shard`` of ``ne`` receives in a ragged
    all_to_all, built as ``dropless.ragged_ep_dispatch`` packs them: from
    each of ``ne`` source ranks, ``groups`` groups of ``tokens`` tokens
    routed top-1 over E experts (phase 16 (b): one-token groups, bx 8,
    R = 232 rows a group), each group's rows of this shard's experts at the
    front of its R-row slot, the rest zero rows of local expert 0.  Returns
    (xs, local block experts, this shard's weights, live rows, the flat
    indices of the routed row blocks, the liveness the receiving kernel
    reads: a slot row's local expert id, -1 on the padding, int64 as
    shipped)."""
    import torch

    from repro_torch.configs.base import MoEConfig
    from repro_torch.core.routers.topk import topk_plan

    g = torch.Generator(device="cuda").manual_seed(seed)
    G = ne * groups
    logits = torch.randn((G, tokens, E), generator=g, device="cuda")
    plan = topk_plan(logits, MoEConfig(num_experts=E, top_k=1, aux_loss_coef=0.0), tokens)
    rag = plan.ragged(bx)
    R = rag.token.shape[1]
    epl = E // ne
    x = torch.randn((G, tokens, M), generator=g, device="cuda").to(torch.bfloat16)
    xs = torch.zeros((G, R, M), dtype=torch.bfloat16, device="cuda")
    be = torch.zeros((G, R // bx), dtype=torch.int32, device="cuda")
    tags = torch.full((G, R), -1, dtype=torch.int64, device="cuda")
    live, routed = 0, []
    for i in range(G):
        lo = int(rag.expert_offsets[i, shard * epl])
        hi = int(rag.expert_offsets[i, (shard + 1) * epl])
        tok = rag.token[i, lo:hi]
        xs[i, :hi - lo] = torch.where((tok >= 0)[:, None], x[i][tok.clamp(min=0).long()],
                                      torch.zeros_like(x[i, 0])[None, :])
        be[i, :(hi - lo) // bx] = rag.block_expert[i, lo // bx:hi // bx] - shard * epl
        tags[i, :hi - lo] = be[i, :(hi - lo) // bx].repeat_interleave(bx)
        live += int((tok >= 0).sum())
        routed.append(i * (R // bx) + torch.arange((hi - lo) // bx, device="cuda"))
    if weights is None:
        def w(*shape):
            return (torch.randn(shape, generator=g, device="cuda") * 0.02).to(torch.bfloat16)

        weights = (w(epl, M, I), None, w(epl, I, M))
    return (xs.reshape(G * R, M), be.reshape(-1).contiguous(), weights, live,
            torch.cat(routed), tags)


def mesh_ffn_bound(xs, be, weights, live, routed):
    """The live rows read and written, the routed blocks' expert ids and
    the routed experts' weights (``ffn_bound`` for a received buffer: the
    padding blocks, parked on local expert 0, add neither rows nor an
    expert)."""
    M = xs.shape[1]
    w_up, w_gate, w_down = weights
    I = w_up.shape[2]
    mats = 3 if w_gate is not None else 2
    experts = int(be[routed].unique().numel())
    nbytes = (2 * live * M * xs.element_size() + routed.numel() * 4
              + experts * mats * M * I * w_up.element_size())
    return roofline(nbytes, 2.0 * live * M * I * mats)


def check_mesh_kernels(torch):
    """Phase 16's shard shapes against the plain versions at TOL: the paged
    and int8 kernels over a shard's pool slice at (b)'s decode and mixed
    rows (length-0 rows exactly 0), the ragged FFN at (b)'s received
    buffers on the tensor cores (also within one bf16 ulp of split-h),
    without the liveness and with it as the dispatcher passes it (a dead
    block's id -1; once more with the dead rows NaN); the packing's
    liveness on the card.  Returns each kernel's max abs err."""
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.decode_attention import ref as dref
    from repro_torch.kernels.moe_dropless import ops as rffn
    from repro_torch.kernels.moe_dropless.ref import (
        live_blocks,
        ragged_ffn_ref,
        ragged_ffn_split_ref,
    )
    from repro_torch.quant import get_kv_quant

    errs = {"paged_decode_attention": 0.0, "quantized_paged_decode_attention": 0.0,
            "ragged_ffn": 0.0}
    for i, chunk in enumerate((False, True)):
        label = "mixed" if chunk else "decode"
        case = mesh_shard_case(1600 + i, chunk)
        out = da.paged_decode_attention(*case)
        torch.cuda.synchronize()
        errs["paged_decode_attention"] = max(errs["paged_decode_attention"], check_close(
            f"paged_decode_attention mesh {label} N={case[0].shape[0]}", out,
            dref.paged_decode_attention_ref(*case)))
        if not (out[case[4] == 0] == 0).all():
            raise AssertionError("paged_decode_attention: a length-0 row is not exactly 0")
        qcase = mesh_shard_case(1610 + i, chunk, quant="int8")
        pol = get_kv_quant("int8")
        out = da.quantized_paged_decode_attention(*qcase, policy=pol)
        torch.cuda.synchronize()
        errs["quantized_paged_decode_attention"] = max(
            errs["quantized_paged_decode_attention"], check_close(
                f"quantized_paged_decode_attention int8 mesh {label}", out,
                dref.quantized_paged_decode_attention_ref(*qcase, policy=pol)))
        if not (out[qcase[6] == 0] == 0).all():
            raise AssertionError("quantized_paged_decode_attention: a length-0 row is not 0")
    weights = None
    for label, groups in MESH_FFN_GROUPS.items():
        xs, be, weights, live, routed, tags = mesh_ffn_case(groups, 1620, weights)
        log(f"  ragged_ffn mesh {label}: {xs.shape[0]} received rows, {live} live, "
            f"{routed.numel()} routed blocks of {be.numel()} on "
            f"{be[routed].unique().numel()} of {weights[0].shape[0]} local experts")
        err, _ = check_routed(
            f"ragged_ffn mesh {label}", rffn.ragged_ffn,
            lambda *a: rffn.ragged_ffn(*a, "gelu", block_x=8), (xs, be, *weights),
            lambda *a: ragged_ffn_ref(*a, "gelu"), lambda *a: ragged_ffn_split_ref(*a, "gelu"),
            True)
        errs["ragged_ffn"] = max(errs["ragged_ffn"], err)
        # as the dispatcher calls it: a dead block's id -1 as shipped, its rows NaN
        dead = ~live_blocks(tags, be.numel())
        be_live = be.masked_fill(dead, -1)
        x_nan = xs.masked_fill(dead.repeat_interleave(8)[:, None], float("nan"))
        for xin, what in ((xs, ""), (x_nan, ", dead rows NaN")):
            err, _ = check_ragged(torch, f"mesh {label}{what}", xin, be_live, weights, "gelu", 8,
                                  tags, case_tile(1, 32, 8, groups=2 * groups))
            errs["ragged_ffn"] = max(errs["ragged_ffn"], err)
    check_mesh_packing(torch)
    return errs


def check_mesh_packing(torch):
    """``ragged_ep_dispatch``'s packing on the card under the sync-debug
    mode "error" (the liveness it ships adds no read to the host), at
    phase 16 (b)'s decode step: each shard's received ids, read as the
    kernel reads them, live exactly on the slots' first ``seglen`` rows."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.core.dispatch import dropless
    from repro_torch.core.routers.topk import topk_plan
    from repro_torch.kernels.moe_dropless.ref import live_blocks

    g = torch.Generator(device="cuda").manual_seed(1630)
    E, ne, bx = 32, 2, 8
    logits = torch.randn((2 * MESH_FFN_GROUPS["decode"], 1, E), generator=g, device="cuda")
    plan = topk_plan(logits, MoEConfig(num_experts=E, top_k=1, aux_loss_coef=0.0), 1)
    rag = plan.ragged(bx)
    G, R = rag.token.shape
    with no_sync(torch):
        offsets = rag.expert_offsets.long()
        src, valid = dropless.shard_slots(offsets, E // ne, R)
        ebuf = dropless.slot_expert_ids(rag.block_expert.long().repeat_interleave(bx, dim=1),
                                        src, valid, E // ne)
        got = torch.stack([live_blocks(ebuf[:, s], G * R // bx) for s in range(ne)])
    seglen = offsets[:, ::E // ne].diff(dim=1)                     # (G, ne)
    want = (torch.arange(R // bx, device="cuda")[None, None, :] * bx
            < seglen.t()[:, :, None]).reshape(ne, -1)
    if not torch.equal(got, want):
        raise AssertionError("mesh packing: the received liveness is not the slots' prefix")
    log(f"  mesh packing (G={G}, {ne} shards): {int(got.sum())} live received blocks of "
        f"{got.numel()}, the slots' prefixes; no sync")


def time_mesh_ffn(torch, groups, seed, tokens=1, bx=8):
    """Kernel, plain and grouped_mm times of the ragged FFN over a received
    buffer (phase 16 (b)'s by default; ``mesh_ffn_case``'s arguments)."""
    from repro_torch.kernels.moe_dropless.ref import live_blocks

    xs, be, weights, live, routed, tags = mesh_ffn_case(groups, seed, tokens=tokens, bx=bx)
    as_shipped = (tags, be.masked_fill(~live_blocks(tags, be.numel()), -1),
                  case_tile(tokens, 32, bx, groups=2 * groups))
    out = time_sorted_ffn(torch, xs, be, weights, bx,
                          *mesh_ffn_bound(xs, be, weights, live, routed), as_shipped)
    out.update(rows=int(xs.shape[0]), live_rows=live,
               routed_experts=int(be[routed].unique().numel()))
    return out


def time_sorted_ffn(torch, xs, be, weights, bx, bound, by, as_called):
    """Kernel, plain and grouped_mm times of the ragged FFN (gelu) over
    ``xs``: the kernel as the dispatcher calls it (``as_called`` = (the
    liveness, the block experts it passes, the tile)) and without the
    liveness over ``be``; grouped_mm over the same rows sorted by expert
    (its offsets need each expert's rows contiguous, whatever the
    groups)."""
    import torch.nn.functional as F

    from repro_torch.kernels.moe_dropless import ops as rffn
    from repro_torch.kernels.moe_dropless.ref import ragged_ffn_ref

    w_up, _, w_down = weights
    tags, be_live, tile = as_called

    def kern():
        return rffn.ragged_ffn(xs, be_live, *weights, "gelu", block_x=bx, live=tags, tile=tile)

    def kern_all():
        return rffn.ragged_ffn(xs, be, *weights, "gelu", block_x=bx)

    k_ms, k_dev = cuda_ms(kern), device_ms(kern, bound_ms=bound)
    all_ms, all_dev = cuda_ms(kern_all), device_ms(kern_all, bound_ms=bound)
    p_ms = cuda_ms(lambda: ragged_ffn_ref(xs, be_live, *weights, "gelu", tags), reps=5)
    rows_e = be.long().repeat_interleave(bx)
    order = torch.argsort(rows_e, stable=True)
    xsort = xs[order].contiguous()
    offs = torch.bincount(rows_e, minlength=w_up.shape[0]).cumsum(0).int()
    lib_ms = lib_dev = None
    try:
        def grouped():
            h = F.gelu(F.grouped_mm(xsort, w_up, offs=offs), approximate="tanh")
            return F.grouped_mm(h, w_down, offs=offs)

        lib_ms, lib_dev = cuda_ms(grouped), device_ms(grouped, bound_ms=bound)
    except (RuntimeError, TypeError) as exc:
        log(f"  grouped_mm does not take these shapes ({type(exc).__name__}: "
            f"{str(exc).splitlines()[0][:160]}): library_ms null")
    return dict(ms=k_ms, device_ms=k_dev, plain_ms=p_ms, library_ms=lib_ms,
                library_device_ms=lib_dev, bound_ms=bound, bound_by=by, tile=tile,
                without_liveness_ms=all_ms, without_liveness_device_ms=all_dev,
                pass_ms=pass_ms(torch, kern, bound_ms=bound))


def time_mesh_attention(torch, chunk, seed, quant=None):
    """Kernel, plain and SDPA times of the paged (or int8) kernel at a
    shard's rows over its pool slice (16 rotating copies)."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.decode_attention import ref as dref
    from repro_torch.quant import get_kv_quant

    copies = [mesh_shard_case(seed + c, chunk, quant=quant) for c in range(16)]
    it = iter(range(1 << 30))
    pol = get_kv_quant(quant) if quant else None

    def nxt():
        return copies[next(it) % len(copies)]

    first = copies[0]
    lengths = first[-1]
    if quant is None:
        q, kp, vp, tables, _ = first
        bound, by = attention_bound(q, kp, tables, lengths)

        def kern():                  # the engine's plan: static shapes
            return da.paged_decode_attention(*nxt())

        def plain():
            return dref.paged_decode_attention_ref(*nxt())

        k_all, v_all = kp, vp
    else:
        q, kc, vc, ks, vs, tables, _ = first
        bound, by = quant_attention_bound(q, kc, tables, lengths)

        def kern():
            return da.quantized_paged_decode_attention(*nxt(), policy=pol)

        def plain():
            return dref.quantized_paged_decode_attention_ref(*nxt(), policy=pol)

    N, Hq, D = q.shape
    Hkv, bs, MB = first[1].shape[1], first[1].shape[2], tables.shape[1]
    tbl = tables.long()
    mask = (torch.arange(MB * bs, device="cuda")[None, :] < lengths[:, None])[:, None, None, :]

    def gathered(k_pool, v_pool):
        return (k_pool[tbl].permute(0, 2, 1, 3, 4).reshape(N, Hkv, MB * bs, D),
                v_pool[tbl].permute(0, 2, 1, 3, 4).reshape(N, Hkv, MB * bs, D))

    if quant is None:
        kk, vv = gathered(kp, vp)

        def sdpa():
            return F.scaled_dot_product_attention(q[:, :, None, :], kk, vv, attn_mask=mask)
    else:
        def sdpa():                  # dequantize the rows' blocks, then SDPA (phase 4's way)
            kk, vv = gathered((pol.decode(kc) * ks[..., None, None]).to(q.dtype),
                              (pol.decode(vc) * vs[..., None, None]).to(q.dtype))
            return F.scaled_dot_product_attention(q[:, :, None, :], kk, vv, attn_mask=mask)

    return dict(ms=cuda_ms(kern), device_ms=device_ms(kern, bound_ms=bound),
                plain_ms=cuda_ms(plain), library_ms=cuda_ms(sdpa),
                library_device_ms=device_ms(sdpa, bound_ms=bound), bound_ms=bound, bound_by=by,
                plan=da.launch_plan(q, first[1], tables))


MESH_TIMING = {"paged_decode_attention": ["paged_decode_attention mesh decode",
                                          "paged_decode_attention mesh mixed"],
               "quantized_paged_decode_attention": ["quantized_paged_decode_attention mesh decode",
                                                    "quantized_paged_decode_attention mesh mixed"],
               "ragged_ffn": ["ragged_ffn mesh decode", "ragged_ffn mesh mixed"],
               "ragged_combine": ["ragged_combine mesh decode", "ragged_combine mesh mixed"]}


def phase_timing_mesh(torch):
    """Phase 16's shard shapes timed as phase 4 times its own (the SDPA
    yardstick dequantizes the int8 pool outside its timing)."""
    out = {}
    for i, chunk in enumerate((False, True)):
        label = "mixed" if chunk else "decode"
        out[f"paged_decode_attention mesh {label}"] = time_mesh_attention(torch, chunk, 1640 + i)
        out[f"quantized_paged_decode_attention mesh {label}"] = time_mesh_attention(
            torch, chunk, 1650 + i, quant="int8")
    for j, (label, groups) in enumerate(MESH_FFN_GROUPS.items()):
        out[f"ragged_ffn mesh {label}"] = time_mesh_ffn(torch, groups, 1660 + j)
    for name, r in out.items():
        log(f"  mesh {name}: {timing_line(r)}")
    return out


def mesh_trivial_runs(torch, cfg, params, requests, base_tokens, int8_tokens, device="cuda",
                      max_len=256):
    """(a): the (1, 1) mesh in this process on a world-1 group (NCCL on the
    card): phase 5's and phase 7 (a)'s runs replayed at their step clocks
    over bf16 and int8 pools, tokens identical to theirs, every kernel
    launched layers x steps (the ragged FFN on the tensor cores), no
    all_to_all (the expert axis is 1), conservation after every step; the
    bf16 replay in two rounds with and without the per-step checks on the
    mesh and without them on a single-device engine, for what the checks
    and the mesh cost a step; then an unreplayed run of the bf16 engine for
    tokens/s and p50/p95."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs.base import ServeConfig
    from repro_torch.distributed import collectives
    from repro_torch.distributed.sharding import make_rules, shard_params
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.serving.continuous import ContinuousEngine
    from repro_torch.serving.trace import latency_line

    on_card = torch.device(device).type == "cuda"
    mesh = make_serve_mesh(MESH_TRIVIAL, device)
    log(f"  (a) {mesh}, backend {dist.get_backend()}")
    placed = shard_params(params, make_rules(cfg, mesh, expert_axis="expert"), mesh.coord,
                          keep=("router",))
    serve = ServeConfig(max_len=max(max_len, max(r.total_len for r in requests)),
                        mesh=MESH_TRIVIAL)
    report, launches = {}, {}
    attn = {"none": "paged_decode_attention", "int8": "quantized_paged_decode_attention"}
    try:
        for kv_quant, want, key in (("none", base_tokens, "bf16"),
                                    ("int8", int8_tokens, "int8")):
            eng = ContinuousEngine(cfg, placed, dataclasses.replace(serve, kv_quant=kv_quant),
                                   device=device, check_invariants=True, mesh=mesh)
            got = {}
            collectives.reset_counters()
            with counted_launches(got):
                out, wall_ms = replay(torch, eng, requests, STEP_CLOCKS[key])
            steps = eng.steps
            if on_card:
                expect_launches(f"(a) {key}", got, {attn[kv_quant]: cfg.num_layers * steps,
                                                    "ragged_ffn": cfg.num_layers * steps})
            if collectives.all_to_all.launches:
                raise AssertionError(f"(a) {key}: all_to_all ran on a 1 x 1 mesh")
            differ = sorted(u for u in want if want[u] != out[u])
            if differ:
                raise AssertionError(f"(a) {key}: requests {differ} differ from the single-device "
                                     f"run's tokens")
            eng.cache.check_conservation()
            launches[attn[kv_quant]] = got[attn[kv_quant]]
            for name in ("ragged_ffn", "ragged_combine"):
                launches[name] = launches.get(name, 0) + got[name]
            log(f"  (a) {key} pools: {steps} steps replayed at phase "
                f"{'5' if key == 'bf16' else '7 (a)'}'s clocks, tokens identical to that run's; "
                f"mean step {wall_ms / steps:.3f} ms (host clock); launches "
                f"{ {n: v for n, v in got.items() if v} }")
            report[key] = dict(steps=steps, replay_mean_step_ms=wall_ms / steps,
                               tokens_identical=True)
        # what the per-step checks and the mesh cost a step: the bf16 replay
        # in two rounds of three variants, so that the host's drift spreads
        variants = (("checked_mesh", True, True), ("unchecked_mesh", False, True),
                    ("unchecked_single_device", False, False))
        costs = {name: [] for name, _, _ in variants}
        for _ in range(2):
            for name, checked, on_mesh in variants:
                eng = ContinuousEngine(
                    cfg, placed if on_mesh else params,
                    dataclasses.replace(serve, mesh=MESH_TRIVIAL if on_mesh else None),
                    device=device, check_invariants=checked, mesh=mesh if on_mesh else None)
                out, wall_ms = replay(torch, eng, requests, STEP_CLOCKS["bf16"])
                if out != base_tokens:
                    raise AssertionError(f"(a) {name}: tokens differ from phase 5's")
                costs[name].append(wall_ms / eng.steps)
        log("  (a) bf16 replayed in two rounds, mean step (host clock): " + "; ".join(
            f"{name} {' / '.join(f'{v:.3f}' for v in vals)} ms" for name, vals in costs.items()))
        report["bf16"]["variant_mean_step_ms"] = costs
        out, stats, eng, wall_ms = serve_once(torch, cfg, placed, serve, requests, device,
                                              check_invariants=True, mesh=mesh)
        steps = eng.steps
        log(f"  (a) unreplayed: {latency_line(stats)}; {steps} steps, mean step "
            f"{wall_ms / steps:.3f} ms (host clock); token match against phase 5 "
            f"{token_match(base_tokens, out):.4f}")
        report["run"] = dict(tokens_per_s=stats["generated_tokens_per_s"], p50_ms=stats["p50_ms"],
                             p95_ms=stats["p95_ms"], mean_step_ms=wall_ms / steps, steps=steps,
                             token_match_vs_phase5=token_match(base_tokens, out))
    finally:
        dist.destroy_process_group()
    return report, launches


def mesh_rank(rank, world, cfg, serve, requests, clocks, device):
    """(b): one rank of the (2, 2) mesh, in a process of its own (gloo on
    the card's CUDA tensors): m6-base's weights drawn leaf by leaf (this
    rank's slices only), phase 5's trace replayed at its clocks with
    ``check_invariants`` (conservation each step, every rank's tokens
    all-gathered and compared); then the trace served once more through
    ``ContinuousEngine.run`` unreplayed, the ranks agreeing on each step's
    clock (``agree_max``).  Returns what phase 16 gates and reports."""
    import torch

    from repro_torch.distributed import collectives
    from repro_torch.distributed.sharding import make_rules, placement
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.nn import init_params
    from repro_torch.serving.continuous import ContinuousEngine

    if torch.device(device).type == "cuda":
        torch.cuda.set_device(device)
    mesh = make_serve_mesh(MESH_RANKS, device, backend="gloo")
    rules = make_rules(cfg, mesh, expert_axis="expert")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=device,
                         place=placement(rules, mesh.coord, keep=("router",)))
    init_s = time.perf_counter() - t0
    eng = ContinuousEngine(cfg, params, serve, device=device, check_invariants=True, mesh=mesh)
    steps = []
    real = eng._paged_host_step

    def counted(clock_ms):
        before = collectives.all_to_all.launches
        done = real(clock_ms)
        steps.append(collectives.all_to_all.launches - before)
        return done

    eng._paged_host_step = counted
    got = {}
    collectives.reset_counters()
    with counted_launches(got):
        out, wall_ms = replay(torch, eng, requests, clocks)
    tokens = sum(len(v) for v in out.values())
    rep = dict(rank=rank, coord=mesh.coord, tokens=out, steps=eng.steps, a2a_steps=steps,
               launches=got, wall_ms=wall_ms, tokens_per_s=tokens / (wall_ms / 1e3),
               a2a_s=collectives.all_to_all.seconds, all_gather_s=collectives.all_gather.seconds,
               a2a_launches=collectives.all_to_all.launches,
               all_gather_launches=collectives.all_gather.launches,
               experts=int(params["blocks"]["ffn"]["up"].shape[1]),
               pool_rows=int(eng.cache.k_pool.shape[1]), shard_blocks=eng.cache.shard_blocks,
               init_s=init_s)
    eng._paged_host_step = real
    first = eng.steps
    run_out, stats = eng.run(requests)
    rep.update(run_tokens=run_out, run_steps=eng.steps - first,
               run_tokens_per_s=stats["generated_tokens_per_s"], run_p50_ms=stats["p50_ms"],
               run_p95_ms=stats["p95_ms"])
    return rep


def r0_run(ranks) -> str:
    """The unreplayed run of (b) per rank: steps, tokens/s, p50/p95."""
    return "; ".join(f"rank {r['rank']} {r['run_steps']} steps {r['run_tokens_per_s']:.1f} "
                     f"tokens/s p50 {r['run_p50_ms']:.1f} p95 {r['run_p95_ms']:.1f} ms"
                     for r in ranks)


def mesh_rank_runs(torch, cfg, requests, base_tokens, device="cuda", spawn_dir=None,
                   max_len=256):
    """(b): the (2, 2) mesh as four processes that share the card, against
    a single-device run of the same ``group_size=1`` config in this process
    (phase 5's weights, replayed at phase 5's clocks, tapped for the top-two
    logit gaps): every rank holds 16 of the 32 experts and a pool slice of
    ``shard_blocks + 1`` rows, all_to_all ran 3 times in every MoE layer of
    every step, the paged kernel and the ragged FFN launched layers x steps
    on each rank (the FFN on the tensor cores), every rank's tokens equal,
    and equal to the single-device run's but at near-ties; the unreplayed
    run's tokens equal on every rank and every budget met."""
    import numpy as np

    from repro_torch.configs.base import ServeConfig
    from repro_torch.launch.mesh import spawn
    from repro_torch.nn import init_params
    from repro_torch.serving.continuous import ContinuousEngine

    on_card = torch.device(device).type == "cuda"
    V = cfg.vocab_size
    serve = ServeConfig(max_len=max(max_len, max(r.total_len for r in requests)))
    params = init_params(cfg, seed=0, device=device)            # phase 5's weights
    margins, holder = {}, []

    def tap(lg, slots, pos, lens):
        running = holder[0].scheduler.running
        for i in np.flatnonzero(lens > 0):
            top2 = np.partition(lg[i, :V], V - 2)[V - 2:]
            margins[running[int(slots[i])].request.uid, int(pos[i])] = (
                float(top2[1] - top2[0]), float(top2[1]))

    single = ContinuousEngine(cfg, params, serve, device=device, logit_tap=tap)
    holder.append(single)
    base, single_ms = replay(torch, single, requests, STEP_CLOCKS["bf16"])
    single_steps = single.steps
    del single, holder[:], params
    if on_card:
        torch.cuda.empty_cache()
    import dataclasses
    import tempfile

    mesh_serve = dataclasses.replace(serve, mesh=MESH_RANKS)
    if spawn_dir is not None:
        Path(spawn_dir).mkdir(parents=True, exist_ok=True)
    init = str(Path(tempfile.mkdtemp(dir=spawn_dir)) / "init")
    t0 = time.perf_counter()
    ranks = spawn(mesh_rank, 4, backend="gloo", init_file=init, timeout=MESH_SPAWN_TIMEOUT,
                  args=(cfg, mesh_serve, requests, STEP_CLOCKS["bf16"],
                        "cuda:0" if on_card else "cpu"))
    spawn_s = time.perf_counter() - t0
    E, L = cfg.moe.num_experts, cfg.num_layers
    for r in ranks:
        label = f"(b) rank {r['rank']} {r['coord']}"
        if r["experts"] != E // 2 or r["pool_rows"] != r["shard_blocks"] + 1:
            raise AssertionError(f"{label}: {r['experts']} experts, a pool of {r['pool_rows']} rows "
                                 f"(shard_blocks {r['shard_blocks']})")
        if r["steps"] != single_steps or any(n != 3 * L for n in r["a2a_steps"]):
            raise AssertionError(f"{label}: {r['steps']} steps (single device {single_steps}), "
                                 f"all_to_all per step {sorted(set(r['a2a_steps']))}, expected "
                                 f"3 x {L} MoE layers at every step")
        if on_card:
            expect_launches(label, r["launches"], {"paged_decode_attention": L * r["steps"],
                                                   "ragged_ffn": L * r["steps"]})
        if r["tokens"] != ranks[0]["tokens"]:
            raise AssertionError(f"{label}: tokens differ from rank 0's")
        if r["run_tokens"] != ranks[0]["run_tokens"] or any(
                len(r["run_tokens"].get(q.uid, ())) != q.max_new_tokens for q in requests):
            raise AssertionError(f"{label}: the unreplayed run's tokens differ from rank 0's "
                                 f"or fall short of a budget")
    plen = {r.uid: r.prompt_len for r in requests}
    flips = divergences(base, ranks[0]["tokens"],
                        lambda uid, p: margins[uid, plen[uid] - 1 + p], "(b) vs single device")
    same5 = all(base_tokens[u] == ranks[0]["tokens"][u] for u in base_tokens)
    for r in ranks:
        log(f"  (b) rank {r['rank']} {r['coord']}: {r['experts']} experts, pool "
            f"{r['pool_rows']} rows; {r['steps']} steps, mean step {r['wall_ms'] / r['steps']:.3f} "
            f"ms, {r['tokens_per_s']:.1f} tokens/s (host clock); all_to_all "
            f"{r['a2a_launches']} launches {r['a2a_s']:.3f} s, all_gather "
            f"{r['all_gather_launches']} launches {r['all_gather_s']:.3f} s; launches "
            f"{ {n: v for n, v in r['launches'].items() if v} }; weights drawn in "
            f"{r['init_s']:.1f} s")
    run_match = token_match(ranks[0]["tokens"], ranks[0]["run_tokens"])
    log(f"  (b) unreplayed run (ContinuousEngine.run, clocks agreed): {r0_run(ranks)}; every "
        f"rank's tokens equal; token match against the replay {run_match:.4f}")
    log(f"  (b) single device (group_size 1, this process): {single_steps} steps, mean step "
        f"{single_ms / single_steps:.3f} ms; the ranks' tokens equal its tokens but at "
        f"{len(flips)} near-tie flips; equal to phase 5's: {same5}; spawn to join "
        f"{spawn_s:.1f} s")
    r0 = ranks[0]
    report = dict(
        ranks=[{k: r[k] for k in ("coord", "steps", "wall_ms", "tokens_per_s", "a2a_s",
                                  "all_gather_s", "a2a_launches", "all_gather_launches",
                                  "experts", "pool_rows", "init_s")} for r in ranks],
        mean_step_ms=[r["wall_ms"] / r["steps"] for r in ranks],
        single_device_mean_step_ms=single_ms / single_steps, steps=single_steps,
        flips=[(u, p, g) for u, p, g in flips], tokens_equal_phase5=same5, spawn_s=spawn_s,
        run=[{k: r[k] for k in ("run_steps", "run_tokens_per_s", "run_p50_ms", "run_p95_ms")}
             for r in ranks], run_token_match_vs_replay=run_match)
    launches = {n: r0["launches"][n]
                for n in ("paged_decode_attention", "ragged_ffn", "ragged_combine")}
    return report, launches


def phase_mesh(torch, base_tokens, int8_tokens):
    """Phase 16: serving on a (data, expert) mesh (see the module doc).
    Returns (report, {kernel: {mesh: launches}})."""
    from repro_torch.configs.m6 import M6_BASE
    from repro_torch.nn import init_params
    from repro_torch.serving.trace import synthetic_trace

    log(f"phase 16: m6-base served on a (data, expert) mesh ({card_line()})")
    cfg = M6_BASE.replace_moe(impl="dropless", capacity_factor=None)
    requests = synthetic_trace(16, cfg.vocab_size, seed=0)      # phase 5's trace
    params = init_params(cfg, seed=0, device="cuda")            # phase 5's weights
    report, mesh_launches = {}, {}
    report["trivial"], launches = mesh_trivial_runs(torch, cfg, params, requests, base_tokens,
                                                    int8_tokens)
    for name, n in launches.items():
        mesh_launches.setdefault(name, {})["1x1"] = n
    del params
    torch.cuda.empty_cache()
    report["ranks"], launches = mesh_rank_runs(
        torch, cfg.replace_moe(group_size=1), requests, base_tokens,
        spawn_dir=str(ROOT / "build"))
    for name, n in launches.items():
        mesh_launches.setdefault(name, {})["2x2 rank 0"] = n
    return report, mesh_launches


# ---------------------------------------------------------------------------
# Phase 17: training on a (data, model) mesh
# ---------------------------------------------------------------------------

MESH_TRAIN_SHAPE = (2, 2)       # (b): data x model, four processes that share the card
MESH_TRAIN_ARGS = ["--arch", "m6-base", "--batch", "16", "--seq", "256", "--log-every", "1"]
# (label, flags, layers, steps): 16 x 256 = 4096 tokens, G = 4 groups of the paper's 1024, two a
# data rank, one a model rank; every run cut to 2 of m6-base's 5 layers (the script's time)
MESH_TRAIN_RUNS = (
    ("alltoall top-1", ["--moe-impl", "alltoall"], 2, 3),
    ("alltoall 4 top-1", ["--moe-impl", "alltoall", "--routing", "prototype", "--k", "4"], 2, 2),
    ("dropless", ["--moe-impl", "dropless", "--capacity-factor", "none"], 2, 2),
    ("pallas", ["--moe-impl", "pallas"], 2, 2),
)
# all_to_all a MoE layer a step: forward, remat recompute and backward of the capacity path's
# two exchanges; of the ragged path's three, whose expert ids have no backward; none where the
# experts are gathered whole
MESH_TRAIN_A2A = {"alltoall": 6, "dropless": 8, "pallas": 0}
# (b), after the runs in the same world: Fig. 4's MoE attention (``fig4_edits``) on the mesh,
# (label, flags, layers, steps, Fig. 4 edit): top-1 at 16 x 256 (G = 4, two groups a data rank:
# the attention experts split over "model") and 2 top-1 at phase 13's 8 x 144 (G = 1: one global
# group, straddling the data ranks)
MESH_TRAIN_FIG4 = (
    ("moe attention top-1", ["--moe-impl", "pallas"], 2, 2, "top-1"),
    ("moe attention 2 top-1", ["--moe-impl", "pallas", "--batch", "8", "--seq", "144"], 2, 2,
     "2 top-1"),
)
MESH_TRAIN_TIMEOUT = 900
# phase 18 (c): after the runs, this run again with ``cfg.fsdp`` in the same world
MESH_TRAIN_FSDP = "pallas"
# (b)'s kernel shapes, held against the plain versions in phase 3 and timed in phase 4
# (``mesh_train_ranks`` fails where a run launches either kernel at another shape): moe_ffn
# over the gathered experts (pallas) at X = 2 groups x C 40 on a rank and 4 groups on one
# device, and at the straddling 2 top-1 run's one global group, C = 90, on a rank and on one
# device; the ragged FFN (dropless: groups of 1024 tokens, bx 32, R 2016 rows a group) over a
# rank's received buffer, one group from each model rank on its 16 of 32 experts, and over one
# device's 4 groups
MESH_TRAIN_MOE_X = {"rank": 80, "single device": 160, "straddling 2 top-1": 90}
MESH_TRAIN_GROUP, MESH_TRAIN_BX, MESH_TRAIN_R = 1024, 32, 2016
MESH_TRAIN_RAGGED_ROWS = {"rank": 2 * MESH_TRAIN_R, "single device": 4 * MESH_TRAIN_R}
MESH_TRAIN_TIMING = {"moe_ffn": [f"moe_ffn mesh train {k}" for k in MESH_TRAIN_MOE_X],
                     "ragged_ffn": [f"ragged_ffn mesh train {k}" for k in MESH_TRAIN_RAGGED_ROWS]}


def mesh_train_shapes() -> set:
    """The grouped-FFN shapes phase 3 checks for (b), as
    ``recorded_ffn_shapes`` keys them."""
    return ({("moe_ffn", 32, X, 1024) for X in MESH_TRAIN_MOE_X.values()}
            | {("ragged_ffn", rows, MESH_TRAIN_BX) for rows in MESH_TRAIN_RAGGED_ROWS.values()})


def check_mesh_train_kernels(torch):
    """Phase 3 at (b)'s shapes (``MESH_TRAIN_MOE_X``,
    ``MESH_TRAIN_RAGGED_ROWS``): each kernel on the tensor cores and
    against its plain version at TOL; the ragged FFN also with the
    liveness as the dispatcher passes it (a received buffer's dead blocks'
    ids -1), dead rows exactly 0.  Its split-h plain version is
    compared too and the elements beyond SPLIT_ATOL / SPLIT_RTOL are
    reported, not gated: over these 4-8 M outputs one or two land there,
    small outputs of cancelling sums (``ffn_accuracy.py`` sets each beside
    an f64 sum).  Returns each kernel's max abs err against the plain
    version."""
    from repro_torch.kernels.moe_dropless import ops as rffn
    from repro_torch.kernels.moe_dropless.ref import (
        live_blocks,
        ragged_ffn_ref,
        ragged_ffn_split_ref,
    )
    from repro_torch.kernels.moe_ffn import ops as mf
    from repro_torch.kernels.moe_ffn.ref import moe_ffn_ref, moe_ffn_split_ref

    def check(name, wrapper, call, args, ref, split_ref):
        before = wrapper.tc_launches
        out = call(*args)
        torch.cuda.synchronize()
        if wrapper.tc_launches - before != 1:
            raise AssertionError(f"{name}: took the CUDA-core route, expected the tensor cores")
        err = check_close(f"{name} [tensor cores] vs plain", out, ref(*args))
        want = split_ref(*args).float()
        diff = (out.float() - want).abs()
        beyond = diff > SPLIT_ATOL + SPLIT_RTOL * want.abs()
        worst = ""
        if beyond.any():
            i = int(torch.where(beyond, diff, torch.zeros_like(diff)).argmax())
            worst = (f" (the largest there {float(diff.flatten()[i]):.3g} at |y| "
                     f"{float(want.flatten()[i].abs()):.3g})")
        log(f"    vs split-h plain: {float((out.float() == want).float().mean()):.4f} of the "
            f"elements bit-equal, {int(beyond.sum())} of {out.numel()} beyond atol "
            f"{SPLIT_ATOL:g} + rtol {SPLIT_RTOL:g}{worst}")
        return err

    errs = {"moe_ffn": 0.0, "ragged_ffn": 0.0}
    for i, (label, X) in enumerate(MESH_TRAIN_MOE_X.items()):
        case = moe_case(32, X, 1024, 4096, seed=1700 + i)
        err = check(f"moe_ffn mesh train {label} E=32 X={X}", mf.moe_ffn,
                    lambda *a: mf.moe_ffn(*a, "gelu"), case, lambda *a: moe_ffn_ref(*a, "gelu"),
                    lambda *a: moe_ffn_split_ref(*a, "gelu"))
        errs["moe_ffn"] = max(errs["moe_ffn"], err)
        del case
    for i, label in enumerate(MESH_TRAIN_RAGGED_ROWS):
        # a rank's buffer: one group from each of the 2 model ranks; one device: 4 groups
        tile = case_tile(MESH_TRAIN_GROUP, 32, MESH_TRAIN_BX,
                         groups=MESH_TRAIN_RAGGED_ROWS[label] // MESH_TRAIN_R)
        if label == "rank":
            xs, be, weights, live, _, tags = mesh_ffn_case(1, 1710, tokens=MESH_TRAIN_GROUP,
                                                           bx=MESH_TRAIN_BX)
        else:
            xs, be, weights, rag, _ = ffn_case(MESH_TRAIN_GROUP, 32, 1024, 4096, seed=1711,
                                               groups=4, bx=MESH_TRAIN_BX)
            live, tags = int((rag.token >= 0).sum()), rag.token
        if xs.shape[0] != MESH_TRAIN_RAGGED_ROWS[label]:
            raise AssertionError(f"ragged_ffn mesh train {label}: {xs.shape[0]} rows, expected "
                                 f"{MESH_TRAIN_RAGGED_ROWS[label]}")
        name = (f"ragged_ffn mesh train {label} ({xs.shape[0]} rows, {live} live, bx "
                f"{MESH_TRAIN_BX}, {weights[0].shape[0]} experts)")
        err = check(name, rffn.ragged_ffn,
                    lambda *a: rffn.ragged_ffn(*a, "gelu", block_x=MESH_TRAIN_BX),
                    (xs, be, *weights), lambda *a: ragged_ffn_ref(*a, "gelu"),
                    lambda *a: ragged_ffn_split_ref(*a, "gelu"))
        errs["ragged_ffn"] = max(errs["ragged_ffn"], err)
        if label == "rank":      # as shipped: a received dead block's id is -1
            be = be.masked_fill(~live_blocks(tags, be.numel()), -1)

        def call(*a, tags=tags, tile=tile):
            with no_sync(torch):
                return rffn.ragged_ffn(*a, "gelu", block_x=MESH_TRAIN_BX, live=tags, tile=tile)

        err = check(f"{name} with liveness, tile {tile}", rffn.ragged_ffn, call,
                    (xs, be, *weights), lambda *a, tags=tags: ragged_ffn_ref(*a, "gelu", tags),
                    lambda *a, tags=tags: ragged_ffn_split_ref(*a, "gelu", tags))
        dead = ~live_blocks(tags, be.numel()).repeat_interleave(MESH_TRAIN_BX)
        if not (call(xs, be, *weights)[dead] == 0).all():
            raise AssertionError(f"{name}: a dead block's row is not exactly 0")
        errs["ragged_ffn"] = max(errs["ragged_ffn"], err)
        del xs, be, weights
    return errs


def phase_timing_mesh_train(torch):
    """(b)'s kernel shapes timed as phase 4 times the others."""
    out = {}
    for i, (label, X) in enumerate(MESH_TRAIN_MOE_X.items()):
        out[f"moe_ffn mesh train {label}"] = time_moe_ffn(torch, X, seed=1720 + i)
    out["ragged_ffn mesh train rank"] = time_mesh_ffn(torch, 1, 1730, tokens=MESH_TRAIN_GROUP,
                                                      bx=MESH_TRAIN_BX)
    xs, be, weights, rag, bx = ffn_case(MESH_TRAIN_GROUP, 32, 1024, 4096, seed=1731, groups=4,
                                        bx=MESH_TRAIN_BX)
    out["ragged_ffn mesh train single device"] = time_sorted_ffn(
        torch, xs, be, weights, bx, *ffn_bound(xs, be, weights, rag, bx),
        (rag.token, be, case_tile(MESH_TRAIN_GROUP, 32, bx, groups=4)))
    for name, r in out.items():
        log(f"  {name}: {timing_line(r)}")
    return out


def fmt_gb(x) -> str:
    return "not measured (CPU)" if x is None else f"{x:.1f} GB"


def mesh_train_trivial(torch):
    """(a): phase 6's 8 top-1 ``pallas`` steps again through the train CLI on
    the (1, 1) mesh (``--mesh-backend nccl``: a world-1 NCCL group in this
    process): losses and final params bit-equal to phase 6's, no
    collective run, ``moe_ffn`` launched as in phase 6 and nothing else."""
    from repro_torch.distributed import collectives
    from repro_torch.launch.train import build_parser, run
    from repro_torch.nn import flat_params

    collectives.reset_counters()
    got = {}
    with counted_launches(got):
        logs, state = run(build_parser().parse_args(
            TRAIN_ARGS + ["--steps", "8", "--mesh-backend", "nccl"]))
    torch.cuda.synchronize()
    losses = [m["loss"] for m in logs]
    if losses != PHASE6_TOP1["losses"]:
        raise AssertionError(f"(a) losses {losses} differ from phase 6's {PHASE6_TOP1['losses']}")
    differ = [k for k, p in flat_params(state.params).items()
              if not torch.equal(p.detach().cpu().view(torch.int32),
                                 PHASE6_TOP1[k].view(torch.int32))]
    if differ:
        raise AssertionError(f"(a) final params differ from phase 6's: {differ}")
    expect_launches("(a)", got, {"moe_ffn": 5 * 8 * 2})
    ran = {fn.__name__: fn.launches for fn in collectives.COUNTED if fn.launches}
    if ran:
        raise AssertionError(f"(a) collectives ran on the (1, 1) mesh: {ran}")
    step_ms = sum(m["step_time_s"] for m in logs[1:]) / (len(logs) - 1) * 1e3
    log(f"  (a) (1, 1) mesh, world-1 NCCL group: 8 top-1 steps, losses and all "
        f"{len(PHASE6_TOP1) - 1} final param leaves bit-equal to phase 6's; moe_ffn "
        f"{got['moe_ffn']} launches, all on the tensor cores; no collective; mean step "
        f"{step_ms:.1f} ms over steps 1-7 (host clock, synced)")
    del state
    PHASE6_TOP1.clear()
    torch.cuda.empty_cache()
    return dict(losses=losses, mean_step_ms=step_ms, moe_ffn_launches=got["moe_ffn"]), got


def mesh_train_edit(layers, fig4=None):
    """A (b) run's config edit: ``layers`` deep, with Fig. 4's MoE attention
    edit of ``fig4_edits`` labelled ``fig4`` (none: as the flags build it)."""
    edit = dict(fig4_edits()).get(fig4, lambda cfg: cfg)
    return lambda cfg: edit(cfg.replace(num_layers=layers))


def route_calls(cfg) -> int:
    """A forward's routing calls: one an MoE layer, two with MoE attention."""
    return moe_layers(cfg) * (2 if cfg.moe.moe_attention else 1)


def moe_attention_collectives(cfg, straddling: bool) -> dict:
    """A train step's collectives of the MoE-attention layers, by kind and
    axis, as ``core.moe_attention``'s module doc predicts them with the
    experts split over "model" under remat (none without MoE attention): a
    layer's 2 all-reduces over "model" forward, 2 in the recompute and 3 in
    the backward; with its groups on the data rank, the loads' all-reduce
    over "data" forward and in the recompute; straddling, 3 all-gathers
    over "data" forward and in the recompute and 2 reduce-scatters in the
    backward."""
    n = moe_layers(cfg) if cfg.moe.moe_attention else 0
    if not n:
        return {}
    if straddling:
        return {"all-reduce": {"model": 7 * n}, "all-gather": {"data": 6 * n},
                "reduce-scatter": {"data": 2 * n}}
    return {"all-reduce": {"model": 7 * n, "data": 2 * n}}


def placed_bytes(torch, cfg, rules, train: bool) -> int:
    """The bytes of a rank's parameters under ``rules``' placement (the
    router whole)."""
    from repro_torch.configs.base import torch_dtype
    from repro_torch.distributed.sharding import param_shardings
    from repro_torch.nn import flat_params, model_shapes

    shapes = flat_params(model_shapes(cfg, train=train))
    return sum(math.prod(sh.local_shape(shapes[k].shape))
               * torch.empty((), dtype=torch_dtype(shapes[k].dtype)).element_size()
               for k, sh in flat_params(param_shardings(model_shapes(cfg, train=train), rules,
                                                        keep=("router",))).items())


def mesh_train_single(torch, flags, layers, path, device="cuda", base_args=MESH_TRAIN_ARGS,
                      fig4=None):
    """The single-device port on the card at a run's config and batch 0
    (``compare_train_step``'s quantities): loss, gradient norm and each
    forward routing call's routes and margins; the gradients written to
    ``path`` in bf16, by flat path, for the ranks to compare against."""
    from repro_torch.core.moe import group_count
    from repro_torch.launch.train import build_parser, device_batch, setup
    from repro_torch.nn import flat_params
    from repro_torch.train.trainer import make_loss_fn

    with built_config(mesh_train_edit(layers, fig4)):
        cfg, _, _, state, pipeline = setup(build_parser().parse_args(
            base_args + flags + ["--device", device]))
    batch = device_batch(pipeline.batch_at(0), device)
    flat = flat_params(state.params)
    routes, shapes = [], {}
    with recorded_routing(routes), recorded_ffn_shapes(shapes):
        loss, _ = make_loss_fn(cfg)(state.params, batch)
        grads = torch.autograd.grad(loss, list(flat.values()))
    norm = math.sqrt(sum(float(g.float().square().sum()) for g in grads))
    torch.save({k: g.to(torch.bfloat16).cpu() for k, g in zip(flat, grads)}, path)
    positions = batch["tokens"].shape[0] * (batch["tokens"].shape[1]
                                            + batch["patch_embeds"].shape[1])
    out = dict(loss=float(loss.detach()), grad_norm=norm, tokens=batch["labels"].numel(),
               batch_positions=positions, groups=group_count(positions, cfg.moe),
               experts=cfg.moe.num_experts, kernel_shapes=set(shapes),
               seq=batch["tokens"].shape[1] + batch["patch_embeds"].shape[1],
               routes=[tuple(t.cpu() for t in r) for r in routes[:route_calls(cfg)]])
    del state, grads, flat, loss
    if sync(torch, batch["tokens"]):
        torch.cuda.empty_cache()
    return out


def mesh_cosines(torch, layout, grads, single) -> dict:
    """Each leaf's gradient cosine between the rank's reduced gradient
    blocks and the single-device gradient's same blocks (``single``, whole
    leaves on the host), the model-sharded leaves' sums all-reduced over
    "model" (uncounted: a measurement); leaves whose single-device gradient
    is 0 are left out, as ``compare_train_step`` leaves them."""
    import torch.distributed as dist

    from repro_torch.distributed.sharding import Sharding

    sums, sharded = {}, []
    for k, g in grads.items():
        ref = Sharding(layout.mesh, layout.spec[k]).slice(single[k], layout.mesh.coord)
        a, b = g.float(), ref.to(g.device).float()
        sums[k] = torch.stack([(a * b).sum(), a.square().sum(), b.square().sum(),
                               b.abs().amax()])
        if any("model" in (e if isinstance(e, tuple) else (e,)) for e in layout.spec[k] if e):
            sharded.append(k)
    if sharded:
        both = torch.stack([sums[k] for k in sharded])
        dist.all_reduce(both, group=layout.mesh.group("model"))
        sums.update(zip(sharded, both.unbind(0)))
    return {k: float(t[0] / (t[1] * t[2]).sqrt()) for k, t in sums.items() if float(t[3]) > 0}


def mesh_train_rank(rank, world, runs, device, base_args=MESH_TRAIN_ARGS):
    """(b): one rank of the (2, 2) mesh, in a process of its own (gloo on the
    card's CUDA tensors): each run (``(label, flags, layers, steps, the
    single device's gradients, Fig. 4 edit)``) through the train CLI's
    parts with this rank's blocks of the seed's weights, its gradient
    cosines at step 0 against the single-device run's, its routes,
    launches, collectives (the MoE-attention layers' apart), step times,
    peak memory, parameter bytes and ZeRO-1 state; then the
    ``MESH_TRAIN_FSDP`` run with ``cfg.fsdp``."""
    from unittest import mock

    import torch

    from repro_torch.core.moe_attention import SCOPE
    from repro_torch.distributed import collectives
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.nn import flat_params
    from repro_torch.train import trainer
    from repro_torch.train.layout import MeshLayout

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_debug_mesh(*MESH_TRAIN_SHAPE, device=device, backend="gloo")
    out, fsdp_base = [], None
    for label, flags, layers, steps, path, fig4 in runs:
        args = train_mod.build_parser().parse_args(
            base_args + flags + ["--steps", str(steps), "--device", device])
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with built_config(mesh_train_edit(layers, fig4)):
            cfg = train_mod.build(args)
            layout = MeshLayout(cfg, make_rules(cfg, mesh, batch_sharded=True))
            _, _, step_fn, state, pipeline = train_mod.setup(args, layout)
        init_s = time.perf_counter() - t0
        single = torch.load(path, mmap=True)
        cos = {}
        real_clip = trainer.clip_by_global_norm

        def clip(grads, max_norm, sum_squares=None, cos=cos, single=single, layout=layout):
            if not cos:
                cos.update(mesh_cosines(torch, layout, grads, single))
            return real_clip(grads, max_norm, sum_squares)

        routes, losses, norms, step_ms, a2a, gathers, got = [], [], [], [], [], [], {}
        shapes, step_collectives, step_scoped = {}, [], []
        state_bytes = (tensor_bytes(state.params), tensor_bytes(state.opt_state))
        collectives.reset_counters()
        with counted_launches(got), recorded_ffn_shapes(shapes), \
                mock.patch.object(trainer, "clip_by_global_norm", clip):
            for step in range(steps):
                batch = train_mod.device_batch(pipeline.batch_at(step), device)
                before = (collectives.all_to_all.launches, collectives.all_gather.launches)
                counted, scoped = collective_counts(collectives), collectives.scoped(SCOPE)
                sync(torch, batch["tokens"])
                t0 = time.perf_counter()
                if step == 0:
                    with recorded_routing(routes):
                        state, m = step_fn(state, batch)
                else:
                    state, m = step_fn(state, batch)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
                sync(torch, batch["tokens"])
                step_ms.append((time.perf_counter() - t0) * 1e3)
                a2a.append(collectives.all_to_all.launches - before[0])
                gathers.append(collectives.all_gather.launches - before[1])
                step_collectives.append(counts_since(collective_counts(collectives), counted))
                step_scoped.append(scoped_since(collectives.scoped(SCOPE), scoped))
        flat = flat_params(state.params)
        if label == MESH_TRAIN_FSDP:
            fsdp_base = dict(args=args, edit=mesh_train_edit(layers), steps=steps,
                             losses=losses, launches=got,
                             peak_gb=torch.cuda.max_memory_allocated() / 1e9 if on_card else None,
                             params={k: p.detach().cpu() for k, p in flat.items()})
        zeroed = [k for k in flat if layout.zdim[k] is not None]
        halved = [k for k in zeroed
                  if state.opt_state["mu"][k].numel() * layout.nd == flat[k].numel()]
        out.append(dict(
            label=label, rank=rank, coord=mesh.coord, losses=losses, grad_norms=norms,
            step_ms=step_ms, a2a=a2a, all_gathers=gathers, launches=got, cos=cos,
            kernel_shapes=set(shapes),
            routes=[tuple(t.cpu() for t in r) for r in routes[:route_calls(cfg)]],
            collective_s={fn.__name__: fn.seconds for fn in collectives.COUNTED},
            collective_launches={fn.__name__: fn.launches for fn in collectives.COUNTED},
            peak_gb=torch.cuda.max_memory_allocated() / 1e9 if on_card else None,
            init_s=init_s,
            zero_leaves=len(zeroed), zero_halved=len(halved), leaves=len(flat),
            local_params=sum(p.numel() for p in flat.values()),
            state_elems=sum(t.numel() for sub in state.opt_state.values() for t in sub.values()),
            param_bytes=state_bytes[0], opt_state_bytes=state_bytes[1],
            placed_bytes=placed_bytes(torch, cfg, layout.rules, train=True),
            attn_experts=flat["blocks/attn/wq"].shape[1] if "blocks/attn/wq" in flat else None,
            step_collectives=step_collectives, step_moe_attention=step_scoped))
        del state, step_fn, flat, single
        if on_card:
            torch.cuda.empty_cache()
    if fsdp_base is not None:
        out.append(mesh_train_fsdp(torch, mesh, device, fsdp_base))
    return out


def tensor_bytes(tree) -> int:
    """The bytes of every tensor in a nested dict / list / tuple."""
    import torch

    if torch.is_tensor(tree):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tensor_bytes(v) for v in tree)
    return 0


def collective_counts(collectives) -> dict:
    """The counters' launches and wire bytes (by mesh axis) by kind."""
    return {collectives.KINDS[fn.__name__]: (fn.launches, dict(fn.bytes))
            for fn in collectives.COUNTED}


def counts_since(now: dict, before: dict) -> dict:
    """{kind: {"launches": n, "bytes": {axis: b}}} between two snapshots."""
    out = {}
    for kind, (n, by) in now.items():
        n0, by0 = before[kind]
        out[kind] = {"launches": n - n0,
                     "bytes": {a: b - by0.get(a, 0) for a, b in by.items() if b - by0.get(a, 0)}}
    return out


def scoped_since(now: dict, before: dict) -> dict:
    """{kind: {axis: launches}} of ``collectives.scoped`` between two
    snapshots."""
    out = {}
    for kind, by in now.items():
        d = {a: n - before.get(kind, {}).get(a, 0) for a, n in by.items()}
        d = {a: n for a, n in d.items() if n}
        if d:
            out[kind] = d
    return out


def mesh_train_fsdp(torch, mesh, device, base):
    """A run again with ``cfg.fsdp`` (the "embed" dim over "data", gathered
    at each use), on a rank of the world that ran it (phase 18 (c): the
    ``MESH_TRAIN_FSDP`` run of 17 (b); phase 19 (b): each family's): its
    losses and launches, and whether each of its final parameter blocks
    equals the same block of that run's bit for bit.  ``base``: that run's
    flags (``args``), config edit, steps, losses, launches, peak GB and
    final parameters on the host."""
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.launch import train as train_mod
    from repro_torch.nn import flat_params
    from repro_torch.train.layout import MeshLayout

    args, edit, steps, base_params = base["args"], base["edit"], base["steps"], base["params"]
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    with built_config(lambda cfg: edit(cfg).replace(fsdp=True)):
        cfg = train_mod.build(args)
        layout = MeshLayout(cfg, make_rules(cfg, mesh, batch_sharded=True))
        _, _, step_fn, state, pipeline = train_mod.setup(args, layout)
    losses, got, step_ms = [], {}, []
    with counted_launches(got):
        for step in range(steps):
            batch = train_mod.device_batch(pipeline.batch_at(step), device)
            sync(torch, batch["tokens"])
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            losses.append(float(m["loss"]))
            sync(torch, batch["tokens"])
            step_ms.append((time.perf_counter() - t0) * 1e3)
    d = mesh.coord["data"]
    differ, blocks = [], 0
    for k, p in flat_params(state.params).items():
        want = base_params[k]
        if k in layout.fsdp:
            dim = layout.fsdp[k]
            c = p.shape[dim]
            want = want.narrow(dim, d * c, c)
            blocks += 1
        if not torch.equal(p.detach().cpu().view(torch.int32), want.view(torch.int32)):
            differ.append(k)
    return dict(label="fsdp", losses=losses, base_losses=base["losses"], launches=got,
                base_launches=base["launches"], differ=differ, fsdp_leaves=blocks,
                leaves=len(base_params), step_ms=step_ms,
                local_params=sum(p.numel() for p in flat_params(state.params).values()),
                peak_gb=torch.cuda.max_memory_allocated() / 1e9 if on_card else None,
                base_peak_gb=base["peak_gb"])


def mesh_train_ranks(torch, spawn_dir, device="cuda", base_args=MESH_TRAIN_ARGS,
                     train_runs=MESH_TRAIN_RUNS, fig4_runs=MESH_TRAIN_FIG4):
    """(b): every run single-device on the card first (loss, gradients and
    routes of batch 0), then the (2, 2) mesh as four processes that share
    the card, each running every run in turn (``train_runs``, then Fig. 4's
    MoE attention, ``fig4_runs``, then the FSDP run).  Gates: every rank's
    loss equal at every step; against the single-device run,
    ``compare_train_step``'s (loss within 1e-3 + 10 / tokens per flipped
    token, gradient norm within 2e-2, every leaf's gradient cosine >= 0.99,
    0.9 with flips; flips, of every routing call, reported with their
    margins); all_to_all a step = MoE layers x ``MESH_TRAIN_A2A``;
    ``moe_ffn`` (pallas) and the ragged FFN (dropless) launched 2 x layers
    x steps, all on the tensor cores, and no other kernel; every leaf with a
    free divisible dim keeps half its AdamW state on a rank; a rank's
    parameter bytes its placement's (MoE attention: E / 2 attention experts
    a rank), and the MoE-attention layers' collectives a step
    ``moe_attention_collectives``'."""
    import shutil
    import tempfile

    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import spawn

    Path(spawn_dir).mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=spawn_dir))
    on_card = torch.device(device).type == "cuda"
    runs = [(*r, None) for r in train_runs] + list(fig4_runs)
    singles, spawned = {}, []
    for i, (label, flags, layers, steps, fig4) in enumerate(runs):
        path = work / f"grads-{i}.pt"
        singles[label] = mesh_train_single(torch, flags, layers, str(path), device, base_args,
                                           fig4)
        spawned.append((label, flags, layers, steps, str(path), fig4))
    t0 = time.perf_counter()
    try:
        ranks = spawn(mesh_train_rank, 4, backend="gloo", init_file=str(work / "init"),
                      timeout=MESH_TRAIN_TIMEOUT,
                      args=(spawned, "cuda:0" if on_card else device, base_args))
    finally:
        shutil.rmtree(work, ignore_errors=True)      # the gradient files, 6.2 GB at full width
    spawn_s = time.perf_counter() - t0
    D, M = MESH_TRAIN_SHAPE
    report, launches = {}, {"moe_ffn": 0, "ragged_ffn": 0}
    for i, (label, flags, layers, steps, fig4) in enumerate(runs):
        reps = [r[i] for r in ranks]
        one = singles[label]
        for r in reps:
            if r["losses"] != reps[0]["losses"]:
                raise AssertionError(f"(b) {label}: rank {r['rank']}'s losses {r['losses']} "
                                     f"differ from rank 0's {reps[0]['losses']}")
        straddling = one["groups"] % D != 0
        # a data rank's routes are its own groups', or, where the groups
        # straddle, every group's (model coordinate 0)
        data_ranks = [reps[d * M] for d in range(1 if straddling else D)]
        calls = len(one["routes"])
        mesh_routes = [tuple(torch.cat([dr["routes"][c][j] for dr in data_ranks])
                             for j in range(3)) for c in range(calls)]
        flips, _ = _flip_report(one["routes"], mesh_routes, calls, one["seq"],
                                f"(b) {label}, single device vs mesh")
        loss_tol = 1e-3 + 10.0 * len({r for _, r, _ in flips}) / one["tokens"]
        loss, norm = reps[0]["losses"][0], reps[0]["grad_norms"][0]
        cos = reps[0]["cos"]
        worst = min(cos, key=cos.get)
        log(f"  (b) {label} ({layers} layers, {steps} steps{', straddling' if straddling else ''}"
            f"): step-0 loss {loss:.6f} vs single device {one['loss']:.6f} (|diff| "
            f"{abs(loss - one['loss']):.3g}, tolerance {loss_tol:.3g}); grad norm {norm:.5f} vs "
            f"{one['grad_norm']:.5f}; lowest leaf gradient cosine {cos[worst]:.6f} ({worst}); "
            f"{len(flips)} routing flips over {calls} routing calls; losses "
            f"{[round(x, 4) for x in reps[0]['losses']]} on every rank")
        if abs(loss - one["loss"]) > loss_tol:
            raise AssertionError(f"(b) {label}: loss {loss} vs single device {one['loss']}")
        if abs(norm - one["grad_norm"]) > 2e-2 * one["grad_norm"]:
            raise AssertionError(f"(b) {label}: grad norm {norm} vs single device "
                                 f"{one['grad_norm']}")
        if cos[worst] < (0.9 if flips else 0.99):
            raise AssertionError(f"(b) {label}: gradient of {worst}: cosine {cos[worst]}")
        impl = flags[flags.index("--moe-impl") + 1]
        want_a2a = MESH_TRAIN_A2A[impl] * layers
        E = singles[label]["experts"]
        with built_config(mesh_train_edit(layers, fig4)):
            cfg = train_mod.build(train_mod.build_parser().parse_args(base_args + flags))
        want_scoped = moe_attention_collectives(cfg, straddling)
        want = {"pallas": {"moe_ffn": 2 * layers * steps},
                "dropless": {"ragged_ffn": 2 * layers * steps}}.get(impl, {}) if on_card else {}
        if on_card:
            ran = set(one["kernel_shapes"]).union(*(r["kernel_shapes"] for r in reps))
            unchecked = sorted(ran - mesh_train_shapes())
            if unchecked:
                raise AssertionError(f"(b) {label}: grouped-FFN shapes {unchecked} that phase 3 "
                                     f"does not check")
            log(f"    grouped-FFN shapes launched (each held against its plain version in "
                f"phase 3): {sorted(ran)}")
        for r in reps:
            tag = f"(b) {label} rank {r['rank']} {r['coord']}"
            if any(n != want_a2a for n in r["a2a"]):
                raise AssertionError(f"{tag}: all_to_all a step {r['a2a']}, expected {want_a2a}")
            expect_launches(tag, r["launches"], want)
            if r["zero_halved"] != r["zero_leaves"] or not r["zero_leaves"]:
                raise AssertionError(f"{tag}: {r['zero_halved']} of {r['zero_leaves']} leaves "
                                     f"with a free divisible dim keep half their AdamW state")
            if r["param_bytes"] != r["placed_bytes"]:
                raise AssertionError(f"{tag}: {r['param_bytes']} parameter bytes, its "
                                     f"placement's {r['placed_bytes']}")
            if fig4 is not None and r["attn_experts"] != E // M:
                raise AssertionError(f"{tag}: {r['attn_experts']} attention experts, expected "
                                     f"{E // M} of {E}")
            if any(n != want_scoped for n in r["step_moe_attention"]):
                raise AssertionError(f"{tag}: the MoE-attention layers' collectives a step "
                                     f"{r['step_moe_attention']}, predicted {want_scoped}")
        for name in launches:
            launches[name] += reps[0]["launches"][name]
        tokens = one["batch_positions"]
        rows = []
        for r in reps:
            steady = r["step_ms"][1:]
            ms = sum(steady) / len(steady)
            share = sum(r["collective_s"].values()) / (sum(r["step_ms"]) / 1e3)
            rows.append(dict(coord=r["coord"], mean_step_ms=ms, tokens_per_s=tokens / (ms / 1e3),
                             first_step_ms=r["step_ms"][0], step_ms=r["step_ms"],
                             collective_s=r["collective_s"], collective_share=share,
                             collective_launches=r["collective_launches"],
                             peak_gb=r["peak_gb"], init_s=r["init_s"],
                             local_params=r["local_params"], adamw_state_elems=r["state_elems"]))
            log(f"    rank {r['rank']} {r['coord']}: mean step {ms:.1f} ms over steps 1-"
                f"{steps - 1}, {tokens / (ms / 1e3):.0f} tokens/s (host clock, synced; the "
                f"{tokens} positions of the global batch a step); collective s "
                f"{ {k: round(v, 3) for k, v in r['collective_s'].items() if v} } "
                f"({100 * share:.1f} % of the steps); launches "
                f"{ {k: v for k, v in r['collective_launches'].items() if v} }; peak "
                f"{fmt_gb(r['peak_gb'])}; {r['local_params'] / 1e6:.1f} M params held "
                f"({r['param_bytes'] / 1e9:.3f} GB, its placement's), AdamW "
                f"state {r['state_elems'] / 1e6:.1f} M elements ({r['zero_halved']} of "
                f"{r['leaves']} leaves halved); kernels "
                f"{ {k: v for k, v in r['launches'].items() if v} }")
        if want_scoped:
            log(f"    the MoE-attention layers' collectives a step, as predicted: {want_scoped}; "
                f"{reps[0]['attn_experts']} of {E} attention experts a rank")
        report[label] = dict(
            rank0={k: reps[0][k] for k in ("param_bytes", "opt_state_bytes", "step_collectives",
                                           "peak_gb")},
            layers=layers, steps=steps, experts_a_rank=E // M, losses=reps[0]["losses"],
            straddling=straddling, moe_attention_collectives_a_step=want_scoped,
            single_device_loss=one["loss"], single_device_grad_norm=one["grad_norm"],
            grad_norm=norm, min_grad_cosine=cos[worst], min_cosine_leaf=worst,
            routing_flips=[(layer, tok, margin) for layer, tok, margin in flips],
            all_to_all_a_step=reps[0]["a2a"], all_gather_a_step=reps[0]["all_gathers"],
            ranks=rows)
    fsdp = [r[len(runs)] for r in ranks if len(r) > len(runs)]
    if fsdp:
        report["fsdp"] = check_mesh_train_fsdp(fsdp, f"18 (c) {MESH_TRAIN_FSDP}")
    log(f"  (b) spawn to join {spawn_s:.1f} s (four processes, every run)")
    report["spawn_s"] = spawn_s
    return report, launches


def check_mesh_train_fsdp(ranks, label: str) -> dict:
    """The gates over the ranks' ``mesh_train_fsdp`` results of one run
    (``label``: phase 18 (c)'s, or a family's in 19 (b)): losses and every
    final parameter block bit-equal to the run without FSDP, the same
    kernel launches (and tensor-core routes), some leaves FSDP blocks."""
    for r in ranks:
        tag = f"{label} rank {ranks.index(r)}"
        if r["losses"] != r["base_losses"]:
            raise AssertionError(f"{tag}: FSDP losses {r['losses']} differ from "
                                 f"{r['base_losses']} without FSDP")
        if r["differ"]:
            raise AssertionError(f"{tag}: final params differ from the run without FSDP: "
                                 f"{r['differ'][:5]}")
        if r["launches"] != r["base_launches"]:
            raise AssertionError(f"{tag}: launches {r['launches']} vs {r['base_launches']} "
                                 f"without FSDP")
        if not r["fsdp_leaves"]:
            raise AssertionError(f"{tag}: no leaf placed by FSDP")
    r = ranks[0]
    launched = {k: v for k, v in r["launches"].items() if v}
    log(f"  {label} with cfg.fsdp, {len(r['losses'])} steps: losses "
        f"{[round(x, 5) for x in r['losses']]} and all {r['leaves']} final param blocks "
        f"bit-equal to the run without FSDP on every rank ({r['fsdp_leaves']} leaves FSDP "
        f"blocks); launches {launched} as without FSDP; peak a rank "
        f"{[fmt_gb(x['peak_gb']) for x in ranks]} (without FSDP "
        f"{[fmt_gb(x['base_peak_gb']) for x in ranks]}); {r['local_params'] / 1e6:.1f} M "
        f"params held by rank 0; steps {[round(x) for x in r['step_ms']]} ms")
    return dict(losses=r["losses"], launches=launched, fsdp_leaves=r["fsdp_leaves"],
                leaves=r["leaves"], peak_gb=[x["peak_gb"] for x in ranks],
                base_peak_gb=[x["base_peak_gb"] for x in ranks],
                local_params=r["local_params"], step_ms=[x["step_ms"] for x in ranks])


def phase_mesh_train(torch):
    """Phase 17: training on a (data, model) mesh (see ``mesh_train_trivial``
    and ``mesh_train_ranks``).  Returns (report, {kernel: launches in
    (b)})."""
    log(f"phase 17: m6-base trained on a (data, model) mesh ({card_line()})")
    report = {}
    report["trivial"], _ = mesh_train_trivial(torch)
    report["ranks"], launches = mesh_train_ranks(torch, str(ROOT / "build"))
    return report, launches


# ---------------------------------------------------------------------------
# Phase 18: the analysis tooling
# ---------------------------------------------------------------------------

# the dry run's cells (``repro_torch.launch.dryrun.trace_cell``): label -> (the train CLI's
# flags, seq, batch, mesh axes, layers: None for the config's) of phase 6's top-1 run on one
# device and of phase 17 (b)'s first run as rank 0 of (data 2, model 2)
TOOLING_CELLS = {
    "phase 6": (TRAIN_ARGS, 144, 8, (("data", 1), ("model", 1)), None),
    "phase 17 (b)": (MESH_TRAIN_ARGS + MESH_TRAIN_RUNS[0][1], 256, 16,
                     (("data", 2), ("model", 2)), MESH_TRAIN_RUNS[0][2]),
}
DRYRUN_OUT = ROOT / "build" / "phase18-dryrun.json"


def dryrun_child(path: str) -> None:
    """The dry run of ``TOOLING_CELLS`` (on ``meta`` tensors, as rank 0 of a
    ``fake`` process group: no card), written to ``path`` as JSON.  Runs in
    a CPU process of its own, which ``start_dryrun`` starts early."""
    import torch

    torch.set_num_threads(1)
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import trace_cell
    from repro_torch.launch.train import build, build_parser

    out = {}
    for label, (argv, seq, batch, axes, layers) in TOOLING_CELLS.items():
        cfg = build(build_parser().parse_args(argv))
        if layers is not None:
            cfg = cfg.replace(num_layers=layers)
        out[label] = trace_cell(cfg, ShapeConfig(label, seq, batch, "train"), axes)
    Path(path).write_text(json.dumps(out))


def start_dryrun():
    """Start ``dryrun_child`` in a CPU process (no card visible to it); its
    log goes beside the result.  Returns (process, start time)."""
    import atexit

    DRYRUN_OUT.parent.mkdir(parents=True, exist_ok=True)
    DRYRUN_OUT.unlink(missing_ok=True)
    code = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]; "
            f"import chip_smoke; chip_smoke.dryrun_child({str(DRYRUN_OUT)!r})")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    with open(DRYRUN_OUT.with_suffix(".log"), "w") as err:      # the child keeps its own fd
        proc = subprocess.Popen([sys.executable, "-c", code], env=env, stdout=err, stderr=err)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, time.perf_counter()


def analytic_cell(cfg, shape, measured_ms: float) -> dict:
    """``flops_for``, ``bytes_for`` and the one-card roofline of a cell
    beside its measured step, and the achieved model-FLOPs share."""
    from repro_torch.distributed.costs import bytes_for, flops_for
    from repro_torch.distributed.roofline import (
        PEAK_FLOPS,
        Roofline,
        model_flops_forward,
        model_flops_train,
    )
    from repro_torch.launch.dryrun import active_param_count
    from repro_torch.nn import count_params

    active = active_param_count(cfg)
    tokens = shape.tokens if shape.kind != "decode" else shape.global_batch
    mf = (model_flops_train if shape.kind == "train" else model_flops_forward)(active, tokens)
    rl = Roofline(flops=flops_for(cfg, shape), bytes_accessed=bytes_for(cfg, shape,
                                                                        count_params(cfg)),
                  collective_bytes=0.0, chips=1, model_flops=mf)
    return dict(flops=rl.flops, bytes=rl.bytes_accessed, bound_ms=rl.bound_time * 1e3,
                dominant=rl.dominant, measured_ms=measured_ms,
                measured_over_bound=measured_ms / (rl.bound_time * 1e3),
                model_flops=mf, mfu=mf / (measured_ms / 1e3 * PEAK_FLOPS))


def phase_tooling(torch, serve, train, mesh_train, dry):
    """Phase 18: (a) the analytic models of phase 6's top-1 cell and phase
    5's decode step beside their measured steps, and the achieved
    model-FLOPs share; (b) the dry run (``dry``: ``start_dryrun``'s
    process) of phase 6's cell and of phase 17 (b)'s rank 0 against the
    card: parameter and optimizer-state bytes, and every step's
    collective launches and bytes by kind and axis, equal exactly; the
    predicted peak beside the measured one; (c) is phase 17's FSDP run,
    reported here."""
    from repro_torch.configs.base import ServeConfig, ShapeConfig
    from repro_torch.configs.m6 import M6_BASE
    from repro_torch.launch.train import build, build_parser

    log(f"phase 18: the analysis tooling ({card_line()})")
    out = {}
    # (a)
    cfg = build(build_parser().parse_args(TRAIN_ARGS))
    out["phase 6 analytic"] = analytic_cell(cfg, ShapeConfig("phase 6", 144, 8, "train"),
                                            train["top-1"]["mean_step_ms"])
    decode_cfg = M6_BASE.replace_moe(impl="dropless", capacity_factor=None)
    slots = ServeConfig().max_slots
    out["phase 5 analytic"] = analytic_cell(
        decode_cfg, ShapeConfig("phase 5", 256, slots, "decode"), serve["mean_step_ms"])
    for label in ("phase 6 analytic", "phase 5 analytic"):
        a = out[label]
        log(f"  (a) {label}: flops_for {a['flops'] / 1e12:.4f} TFLOP, bytes_for "
            f"{a['bytes'] / 1e9:.3f} GB, bound {a['bound_ms']:.4f} ms ({a['dominant']}; "
            f"H100 SXM datasheet peaks) vs measured {a['measured_ms']:.2f} ms "
            f"({a['measured_over_bound']:.1f}x); model FLOPs {a['model_flops'] / 1e12:.4f} T, "
            f"achieved share of the bf16 peak {a['mfu']:.4f}")
    # (b)
    proc, t0 = dry
    rc = proc.wait(timeout=max(60.0, 600.0 - (time.perf_counter() - t0)))
    if rc != 0 or not DRYRUN_OUT.exists():
        raise AssertionError(f"the dry run exited {rc}: "
                             f"{DRYRUN_OUT.with_suffix('.log').read_text()[-2000:]}")
    cells = json.loads(DRYRUN_OUT.read_text())
    rank0 = mesh_train["ranks"]["alltoall top-1"]["rank0"]
    measured = {"phase 6": dict(peak_gb=train["top-1"]["peak_memory_gb"]),
                "phase 17 (b)": rank0}
    for label, rec in cells.items():
        mem, coll = rec["memory"], rec["collectives"]
        real = measured[label]
        if "param_bytes" in real:
            got = (real["param_bytes"], real["opt_state_bytes"])
            want = (mem["param_bytes_per_device"], mem["opt_state_bytes_per_device"])
            if got != want:
                raise AssertionError(f"(b) {label}: rank 0 holds {got} param / optimizer-state "
                                     f"bytes, the dry run {want}")
            for i, step in enumerate(real["step_collectives"]):
                for kind, c in step.items():
                    dry_bytes = {a: b for a, b in coll["bytes"][kind].items() if b}
                    if c["launches"] != coll["launches"][kind] or c["bytes"] != dry_bytes:
                        raise AssertionError(
                            f"(b) {label} step {i}: {kind} {c} on the card, the dry run "
                            f"{coll['launches'][kind]} launches, {dry_bytes}")
        peak = mem["peak_bytes_per_device"] / 1e9
        rec["measured_peak_gb"] = real["peak_gb"]
        rec["peak_ratio"] = peak / real["peak_gb"]
        log(f"  (b) {label} ({rec['chips']} rank(s), traced on meta in {rec['trace_s']} s): "
            f"predicted peak {peak:.2f} GB vs measured {real['peak_gb']:.2f} GB "
            f"(ratio {rec['peak_ratio']:.3f}); params {mem['param_bytes_per_device'] / 1e9:.3f} "
            f"GB, optimizer state {mem['opt_state_bytes_per_device'] / 1e9:.3f} GB"
            + (" (both equal rank 0's on the card); every step's collectives "
               f"{ {k: v for k, v in coll['launches'].items() if v} } with their bytes by "
               "kind and axis equal rank 0's" if "param_bytes" in real else "")
            + f"; counted {rec['counted']['flops'] * rec['chips'] / 1e12:.4f} TFLOP over the "
            f"ranks vs flops_for {rec['roofline']['flops'] / 1e12:.4f}")
    out["dry run"] = cells
    # (c)
    out["fsdp"] = mesh_train["ranks"].get("fsdp")
    if out["fsdp"] is None:
        raise AssertionError("18 (c): phase 17 ran no FSDP run")
    return out


# ---------------------------------------------------------------------------
# Phase 19: the xLSTM, zamba and encdec trees on a model axis
# ---------------------------------------------------------------------------

MF_SERVE_MESH = (1, 4)          # (a): data x model, four processes that share the card
MF_TRAIN_MESH = (2, 2)          # (b)
MF_ARCHS = ("zamba2-7b", ENCDEC_ARCH, "xlstm-125m")
MF_SERVE = (8, 8, 8)            # (a) zamba, xlstm: rows, prompt tokens (a token a step), generated
# (a)'s depth a family where it is cut (the script's time): zamba2-7b at 27 of its 81 layers,
# 5 shared applications (14 at full depth); full width
MF_SERVE_LAYERS = {"zamba2-7b": 27}
MF_ENCDEC = (8, 256, 16)        # (a) encdec: rows, source frames, target tokens (ENCDEC_FEED fed)
# (b): the train CLI's flags and the config's depth, a family (zamba at phase 14's 7 layers)
MF_TRAIN = {"xlstm-125m": (["--batch", "4", "--seq", "128"], {"num_layers": XLSTM_TRAIN_LAYERS}),
            "zamba2-7b": (["--batch", "4", "--seq", "512"], {"num_layers": ZAMBA_CUT_LAYERS}),
            ENCDEC_ARCH: (["--batch", "4", "--seq", "256"],
                          {"num_layers": 4, "num_encoder_layers": 4})}
MF_TRAIN_STEPS = 2
MF_SPAWN_TIMEOUT = 600


def mf_config(arch, smoke=False):
    """(a)'s config of ``arch``: its smoke config, or the full one at
    ``MF_SERVE_LAYERS``' depth."""
    from repro_torch.configs import registry

    if smoke:
        return registry.get_smoke_config(arch)
    cfg = registry.get_config(arch)
    return cfg.replace(num_layers=MF_SERVE_LAYERS[arch]) if arch in MF_SERVE_LAYERS else cfg


def mf_decode_launches(cfg) -> int:
    """(a)'s dense kernel launches a run: zamba's shared applications x
    steps (prompt tokens too), encdec's 2 x layers x steps, xLSTM none."""
    from repro_torch.models.zamba import _n_shared

    if cfg.family == "zamba":
        B, S, gen = MF_SERVE
        return _n_shared(cfg) * (S + gen - 1)
    if cfg.family == "encdec":
        return 2 * cfg.num_layers * (MF_ENCDEC[2] - 1)
    return 0


def mf_kernel_shapes():
    """The dense kernel's shapes on (a)'s ranks, (label, B, T, Hq, Hkv, D,
    the longest attended length): zamba2-7b's shared attention (8 of 32
    heads of 224 a rank, the engine's cache), seamless's self-attention
    (4 of 16 heads of 64, the ENCDEC_MAX_LEN cache) and cross-attention
    (4 heads over the 256-frame memory)."""
    B, S, gen = MF_SERVE
    Hq, _, D = ZAMBA_HEADS
    n = MF_SERVE_MESH[1]
    return [("zamba rank", B, S + gen + 1, Hq // n, Hq // n, D, S + gen - 1),
            ("encdec self rank", MF_ENCDEC[0], ENCDEC_MAX_LEN, 16 // n, 16 // n, 64,
             MF_ENCDEC[2] - 1),
            ("encdec cross rank", MF_ENCDEC[0], MF_ENCDEC[1], 16 // n, 16 // n, 64,
             MF_ENCDEC[1])]


@contextmanager
def recorded_dense_shapes(store: set):
    """Record (B, T, Hq, Hkv, D) of every dense decode kernel call the models
    make (``attention._decode_attention`` imports the package's name at
    each call); the wrapper itself still counts the launches."""
    from unittest import mock

    import repro_torch.kernels.decode_attention as pkg

    real = pkg.decode_attention

    def rec(q, k, v, *a, **kw):
        store.add((q.shape[0], k.shape[1], q.shape[1], k.shape[2], q.shape[2]))
        return real(q, k, v, *a, **kw)

    with mock.patch.object(pkg, "decode_attention", rec):
        yield


def check_mesh_family_kernel(torch):
    """Phase 19 (a)'s dense kernel shapes (``mf_kernel_shapes``) against the
    plain version at TOL and the split-and-merge plain version: bf16, the
    plan and every split forced, rows at the run's lengths (every row at
    one length, as the engine runs them) and at mixed ones, length 0
    exactly 0.  Returns {"decode_attention": max abs err}."""
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.decode_attention import ref as dref

    err = 0.0
    for label, B, T, Hq, Hkv, D, longest in mf_kernel_shapes():
        mixed = [0, 1, longest, longest // 2, 7, 16, 15, 3][:B]
        for lens in ([longest] * B, mixed):
            for splits in (None, *da.SPLITS):
                case = dense_case(B, T, Hq, Hkv, D, lens, seed=900 + T + len(set(lens)))
                out = da.decode_attention(*case, splits=splits, max_length=max(lens))
                torch.cuda.synchronize()
                plan = da.dense_plan(B, Hkv, Hq // Hkv, D, T, 2, da._sm_count(0), splits,
                                     max(lens))
                name = (f"decode_attention {label} B={B} T={T} Hq={Hq} D={D} lengths "
                        f"{'equal' if len(set(lens)) == 1 else 'mixed'} splits={plan[0]}"
                        f"{' (plan)' if splits is None else ''}")
                err = max(err, check_close(name, out, dref.decode_attention_ref(*case)))
                check_close(f"{name} vs split plain", out,
                            dref.decode_attention_split_ref(*case, plan[0]))
                if not (out[case[3] == 0] == 0).all():
                    raise AssertionError(f"{name}: a length-0 row is not exactly 0")
    return {"decode_attention": err}


def mf_checked_shapes() -> set:
    """(B, T, Hq, Hkv, D) of every shape ``check_mesh_family_kernel`` holds."""
    return {(B, T, Hq, Hkv, D) for _, B, T, Hq, Hkv, D, _ in mf_kernel_shapes()}


def phase_timing_mesh_families(torch):
    """The dense kernel at (a)'s rank shapes, every row at the run's median
    (zamba, encdec self) or only (cross) attended length, as phase 4 times
    its own: events, device time, the plain version, SDPA with a length
    mask and the bound (``roofline.kernel_bound``)."""
    out = {}
    for label, B, T, Hq, Hkv, D, longest in mf_kernel_shapes():
        length = longest if label.endswith("cross rank") else (longest + 1) // 2
        r = time_dense(torch, [length] * B, 920 + T, T=T, heads=(Hq, Hkv, D))
        out[f"decode_attention {label}"] = r
        log(f"  decode_attention {label} (B {B}, T {T}, {Hq} heads of {D}, length {length}): "
            f"{timing_line(r)}")
    return out


def mf_generate(torch, cfg, params, device, rules=None, tap=False, measured=None):
    """(a)'s greedy run of one family under ``rules`` (None: one device):
    zamba and xLSTM through the static engine (the prompt a token a step;
    ``tap``: its sampler tapped, one device only), encdec through
    ``encdec_greedy`` (the frames encoded, ENCDEC_FEED tokens fed); a
    short warm-up first, then the run inside ``measured()`` where given.
    Returns ({row: tokens}, {(row, token): (top-two gap, top)} with
    ``tap``, decode steps, the mean decode step in ms, tokens/s)."""
    import numpy as np

    from contextlib import nullcontext

    from repro_torch.distributed.sharding import use_rules
    from repro_torch.serving.engine import ServingEngine

    measured = measured or nullcontext
    if cfg.family == "encdec":
        B, src, total = MF_ENCDEC
        frames, tgt = encdec_batch(torch, cfg, MF_ENCDEC, device)
        with use_rules(rules):
            encdec_greedy(torch, cfg, params, frames[:, :16], tgt[:, :2], 4)      # warm-up
            with measured():
                toks, margins, _, dec_ms = encdec_greedy(torch, cfg, params, frames,
                                                         tgt[:, :ENCDEC_FEED], total, tap=tap)
        steps = total - 1
        return toks, margins, steps, dec_ms / steps, B * steps / (dec_ms / 1e3)
    B, S, gen = MF_SERVE
    prompts = np.random.default_rng(STATIC_SEED).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    eng = ServingEngine(cfg, params, max_len=S + gen + 1, rules=rules, graphs=False)
    eng.generate(prompts[:, :2], 2)                                            # warm-up
    margins = {}
    with measured():
        if tap:
            toks, margins, stats = tapped_generate(torch, cfg, params, prompts, gen, eng=eng)
        else:
            toks, stats = eng.generate(prompts, gen)
    return ({i: toks[i].tolist() for i in range(B)}, margins, S + gen - 1,
            stats["decode_s"] * 1e3 / (gen - 1), stats["decode_tokens_per_s"])


def mf_serve_single(torch, arch, device, smoke=False):
    """(a)'s single-device run of one family on the card, the sampler
    tapped: its tokens and their top-two margins."""
    from repro_torch.nn import init_params

    cfg = mf_config(arch, smoke)
    params = init_params(cfg, seed=0, device=device)
    toks, margins, _, step_ms, tps = mf_generate(torch, cfg, params, device, tap=True)
    del params
    if device == "cuda":
        torch.cuda.empty_cache()
    return dict(tokens=toks, margins=margins, mean_step_ms=step_ms, tokens_per_s=tps)


def mf_serve_rank(torch, mesh, arch, device, smoke=False):
    """(a) on one rank of the (1, 4) mesh: its blocks of the seed's weights
    drawn leaf by leaf (the router whole; the ranks in turn), their bytes beside the
    placement's, then ``mf_generate`` under ``make_rules(cfg, mesh)`` with
    the kernel counters and the collective counters from 0, the dense
    kernel's call shapes recorded; the peak memory of the rank's process."""
    from repro_torch.distributed import collectives
    from repro_torch.distributed.sharding import make_rules, placement
    from repro_torch.nn import init_params

    cfg = mf_config(arch, smoke)
    rules = make_rules(cfg, mesh)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for turn in range(math.prod(mesh.sizes)):      # one rank draws at a time: a whole f32
        if turn == mesh.rank:                      # leaf is 8.3 GB at zamba2-7b
            params = init_params(cfg, seed=0, device=device,
                                 place=placement(rules, mesh.coord, keep=("router",)))
            if cuda:
                torch.cuda.empty_cache()
        torch.distributed.barrier()
    init_s = time.perf_counter() - t0
    placed = placed_bytes(torch, cfg, rules, train=False)
    got, calls, wall = {}, set(), []

    @contextmanager
    def measured():
        collectives.reset_counters()
        with counted_launches(got), recorded_dense_shapes(calls):
            t0 = time.perf_counter()
            yield
            if cuda:
                torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)

    toks, _, steps, step_ms, tps = mf_generate(torch, cfg, params, device, rules,
                                               measured=measured)
    out = dict(rank=mesh.rank, coord=dict(mesh.coord), tokens=toks, launches=got,
               dense_shapes=calls, steps=steps, mean_step_ms=step_ms, tokens_per_s=tps,
               wall_s=wall[0],
               collective_s={fn.__name__: fn.seconds for fn in collectives.COUNTED},
               collective_launches={fn.__name__: fn.launches for fn in collectives.COUNTED},
               param_bytes=tensor_bytes(params), placed_bytes=placed, init_s=init_s,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9 if cuda else None)
    del params
    if cuda:
        torch.cuda.empty_cache()
    return out


def mf_train_args(arch, device, smoke=False):
    flags, _ = MF_TRAIN[arch]
    return (["--arch", arch, *flags, "--log-every", "1", "--steps", str(MF_TRAIN_STEPS),
             "--device", device] + (["--smoke", "--seq", "32"] if smoke else []))


def mf_train_edit(arch, smoke=False):
    return lambda cfg: cfg if smoke else cfg.replace(**MF_TRAIN[arch][1])


def mf_train_single(torch, arch, path, device, smoke=False):
    """(b)'s single device on the card at a family's config and batch 0:
    loss, gradient norm, and the gradients written to ``path`` in bf16 by
    flat path, for the ranks' per-leaf cosines."""
    from repro_torch.launch.train import build_parser, device_batch, setup
    from repro_torch.nn import flat_params
    from repro_torch.train.trainer import make_loss_fn

    with built_config(mf_train_edit(arch, smoke)):
        cfg, _, _, state, pipeline = setup(build_parser().parse_args(
            mf_train_args(arch, device, smoke)))
    batch = device_batch(pipeline.batch_at(0), device)
    flat = flat_params(state.params)
    loss, _ = make_loss_fn(cfg)(state.params, batch)
    grads = torch.autograd.grad(loss, list(flat.values()))
    norm = math.sqrt(sum(float(g.float().square().sum()) for g in grads))
    torch.save({k: g.to(torch.bfloat16).cpu() for k, g in zip(flat, grads)}, path)
    out = dict(loss=float(loss.detach()), grad_norm=norm, layers=cfg.num_layers,
               tokens=batch["labels"].numel())
    del state, grads, flat, loss
    if sync(torch, batch["tokens"]):
        torch.cuda.empty_cache()
    return out


def mf_train_rank(torch, mesh, arch, path, device, smoke=False):
    """(b) on one rank of the (2, 2) mesh: the train CLI's parts with the
    rank's blocks of the seed's weights, AdamW with ZeRO-1; step 0's
    gradient cosines a leaf against the single device's (``path``), every
    step's loss, gradient norm and host time, the kernel launches, the
    collectives, the peak memory and the ZeRO-1 state a leaf.  Returns
    (those, the run as ``mesh_train_fsdp`` takes it)."""
    from unittest import mock

    from repro_torch.distributed import collectives
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.launch import train as train_mod
    from repro_torch.nn import flat_params
    from repro_torch.train import trainer
    from repro_torch.train.layout import MeshLayout

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    args = train_mod.build_parser().parse_args(mf_train_args(arch, device, smoke))
    with built_config(mf_train_edit(arch, smoke)):
        cfg = train_mod.build(args)
        layout = MeshLayout(cfg, make_rules(cfg, mesh, batch_sharded=True))
        _, _, step_fn, state, pipeline = train_mod.setup(args, layout)
    single = torch.load(path, mmap=True)
    cos = {}
    real_clip = trainer.clip_by_global_norm

    def clip(grads, max_norm, sum_squares=None):
        if not cos:
            cos.update(mesh_cosines(torch, layout, grads, single))
        return real_clip(grads, max_norm, sum_squares)

    losses, norms, step_ms, got = [], [], [], {}
    collectives.reset_counters()
    with counted_launches(got), mock.patch.object(trainer, "clip_by_global_norm", clip):
        for step in range(MF_TRAIN_STEPS):
            batch = train_mod.device_batch(pipeline.batch_at(step), device)
            sync(torch, batch["tokens"])
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            sync(torch, batch["tokens"])
            step_ms.append((time.perf_counter() - t0) * 1e3)
    flat = flat_params(state.params)
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    base = dict(args=args, edit=mf_train_edit(arch, smoke), steps=MF_TRAIN_STEPS, losses=losses,
                launches=got, peak_gb=peak, params={k: p.detach().cpu() for k, p in flat.items()})
    zeroed = [k for k in flat if layout.zdim[k] is not None]
    halved = [k for k in zeroed
              if state.opt_state["mu"][k].numel() * layout.nd == flat[k].numel()]
    out = dict(rank=mesh.rank, coord=dict(mesh.coord), losses=losses, grad_norms=norms,
               step_ms=step_ms, launches=got, cos=cos, layers=cfg.num_layers,
               collective_s={fn.__name__: fn.seconds for fn in collectives.COUNTED},
               collective_launches={fn.__name__: fn.launches for fn in collectives.COUNTED},
               zero_leaves=len(zeroed), zero_halved=len(halved), leaves=len(flat),
               local_params=sum(p.numel() for p in flat.values()), peak_gb=peak)
    del state, step_fn, flat, single
    if cuda:
        torch.cuda.empty_cache()
    return out, base


def mesh_family_rank(rank, world, train_paths, device, smoke=False):
    """One of phase 19's four processes: (a) every family served on the
    (1, 4) mesh, then (b) every family trained on the (2, 2) mesh, and
    again with ``cfg.fsdp`` (``mesh_train_fsdp``), in one gloo world that
    shares the card."""
    import torch

    from repro_torch.launch.mesh import make_debug_mesh

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"serve": {}, "train": {}, "fsdp": {}}
    mesh = make_debug_mesh(*MF_SERVE_MESH, device=device, backend="gloo")
    for arch in MF_ARCHS:
        out["serve"][arch] = mf_serve_rank(torch, mesh, arch, device, smoke)
    mesh = make_debug_mesh(*MF_TRAIN_MESH, device=device, backend="gloo")
    for arch, path in train_paths.items():
        out["train"][arch], base = mf_train_rank(torch, mesh, arch, path, device, smoke)
        out["fsdp"][arch] = mesh_train_fsdp(torch, mesh, device, base)
        del base
    return out


def mf_serve_report(arch, cfg, single, reps, device):
    """(a)'s gates for one family over its ranks: tokens equal on every
    rank, and to one device's but at near-ties of its top two logits; on
    the card the dense kernel launched ``mf_decode_launches`` times a rank
    at shapes phase 3 holds, at the rank's head count, and nothing else;
    every rank's parameter bytes its placement's."""
    n = MF_SERVE_MESH[1]
    for r in reps:
        if r["tokens"] != reps[0]["tokens"]:
            raise AssertionError(f"(a) {arch}: rank {r['rank']}'s tokens differ from rank 0's")
        if r["param_bytes"] != r["placed_bytes"]:
            raise AssertionError(f"(a) {arch} rank {r['rank']}: {r['param_bytes']} parameter "
                                 f"bytes, its placement's {r['placed_bytes']}")
        if device == "cuda":
            want = mf_decode_launches(cfg)
            expect_launches(f"(a) {arch} rank {r['rank']}",
                            r["launches"], {"decode_attention": want} if want else {})
            heads = {s[2] for s in r["dense_shapes"]}
            whole = cfg.num_heads
            if heads and heads != {whole // n}:
                raise AssertionError(f"(a) {arch}: dense kernel at {heads} q heads a rank, "
                                     f"expected {whole // n} of {whole}")
            unchecked = sorted(r["dense_shapes"] - mf_checked_shapes())
            if unchecked:
                raise AssertionError(f"(a) {arch}: dense kernel shapes {unchecked} that phase "
                                     f"3 does not check")
    div = divergences(single["tokens"], reps[0]["tokens"],
                      lambda k, p: single["margins"][k, p], f"(a) {arch} mesh vs one device")
    B = len(single["tokens"])
    rows = []
    for r in reps:
        steps = r["steps"]
        per_step = {k: v / steps for k, v in r["collective_launches"].items() if v}
        share = sum(r["collective_s"].values()) / r["wall_s"]
        rows.append(dict(coord=r["coord"], mean_step_ms=r["mean_step_ms"],
                         tokens_per_s=r["tokens_per_s"], collective_s=r["collective_s"],
                         collective_share=share, wall_s=r["wall_s"],
                         collective_launches_a_step=per_step, peak_gb=r["peak_gb"],
                         param_bytes=r["param_bytes"], init_s=r["init_s"]))
        log(f"    rank {r['rank']}: mean decode step {r['mean_step_ms']:.2f} ms, "
            f"{r['tokens_per_s']:.1f} tokens/s (host clock, synced), collective s "
            f"{ {k: round(v, 3) for k, v in r['collective_s'].items() if v} } of the run's "
            f"{r['wall_s']:.2f} s ({100 * share:.1f} %; {steps} steps), launches a "
            f"step { {k: round(v, 2) for k, v in per_step.items()} }, peak "
            f"{fmt_gb(r['peak_gb'])}, {r['param_bytes'] / 1e9:.3f} GB of params (its "
            f"placement's), drawn in {r['init_s']:.1f} s")
    launched = {k: v for k, v in reps[0]["launches"].items() if v and k in KERNEL_NAMES}
    log(f"  (a) {arch}: {B - len(div)} of {B} rows equal to one device's "
        f"({single['mean_step_ms']:.2f} ms a step there), tokens equal on all {len(reps)} "
        f"ranks; launches a rank {launched}; dense kernel shapes "
        f"{sorted(reps[0]['dense_shapes'])}")
    return dict(rows=B, rows_equal_to_one_device=B - len(div),
                divergences=[dict(row=k, token=p, gap=g) for k, p, g in div],
                one_device_mean_step_ms=single["mean_step_ms"],
                one_device_tokens_per_s=single["tokens_per_s"], steps=reps[0]["steps"],
                launches=launched, dense_shapes=sorted(reps[0]["dense_shapes"]),
                ranks=rows)


def mf_train_report(arch, one, reps, device):
    """(b)'s gates for one family: every rank's loss equal at every step;
    step 0 within ``compare_train_step``'s gates of one device (loss within
    1e-3, gradient norm within 2e-2, every leaf's cosine >= 0.99: no
    routing); no kernel launched; every leaf with a free divisible dim
    keeps half its AdamW state on a rank."""
    for r in reps:
        if r["losses"] != reps[0]["losses"]:
            raise AssertionError(f"(b) {arch}: rank {r['rank']}'s losses {r['losses']} differ "
                                 f"from rank 0's {reps[0]['losses']}")
        tag = f"(b) {arch} rank {r['rank']}"
        if device == "cuda":
            expect_launches(tag, r["launches"], {})
        if r["zero_halved"] != r["zero_leaves"] or not r["zero_leaves"]:
            raise AssertionError(f"{tag}: {r['zero_halved']} of {r['zero_leaves']} leaves with "
                                 f"a free divisible dim keep half their AdamW state")
        if not all(math.isfinite(x) for x in r["losses"] + r["grad_norms"]):
            raise AssertionError(f"{tag}: a non-finite loss or gradient norm")
    loss, norm, cos = reps[0]["losses"][0], reps[0]["grad_norms"][0], reps[0]["cos"]
    worst = min(cos, key=cos.get)
    log(f"  (b) {arch} ({reps[0]['layers']} layers, {MF_TRAIN_STEPS} steps): step-0 loss "
        f"{loss:.6f} vs one device {one['loss']:.6f} (|diff| {abs(loss - one['loss']):.3g}); "
        f"grad norm {norm:.5f} vs {one['grad_norm']:.5f}; lowest leaf gradient cosine "
        f"{cos[worst]:.6f} ({worst}); losses {[round(x, 4) for x in reps[0]['losses']]} on "
        f"every rank")
    if abs(loss - one["loss"]) > 1e-3:
        raise AssertionError(f"(b) {arch}: loss {loss} vs one device {one['loss']}")
    if abs(norm - one["grad_norm"]) > 2e-2 * one["grad_norm"]:
        raise AssertionError(f"(b) {arch}: grad norm {norm} vs one device {one['grad_norm']}")
    if cos[worst] < 0.99:
        raise AssertionError(f"(b) {arch}: gradient of {worst}: cosine {cos[worst]}")
    rows = []
    for r in reps:
        steady = r["step_ms"][1:] or r["step_ms"]
        ms = sum(steady) / len(steady)
        share = sum(r["collective_s"].values()) / (sum(r["step_ms"]) / 1e3)
        rows.append(dict(coord=r["coord"], step_ms=r["step_ms"], mean_step_ms=ms,
                         collective_s=r["collective_s"], collective_share=share,
                         collective_launches=r["collective_launches"], peak_gb=r["peak_gb"],
                         local_params=r["local_params"], zero_halved=r["zero_halved"],
                         leaves=r["leaves"]))
        log(f"    rank {r['rank']} {r['coord']}: steps {[round(x) for x in r['step_ms']]} ms "
            f"(host clock, synced), collective s "
            f"{ {k: round(v, 3) for k, v in r['collective_s'].items() if v} } "
            f"({100 * share:.1f} % of the steps), peak "
            f"{fmt_gb(r['peak_gb'])}, {r['local_params'] / 1e6:.1f} M params held, "
            f"{r['zero_halved']} of {r['leaves']} leaves' AdamW state halved")
    return dict(layers=reps[0]["layers"], losses=reps[0]["losses"], loss=loss,
                one_device_loss=one["loss"], grad_norm=norm, one_device_grad_norm=one["grad_norm"],
                min_grad_cosine=cos[worst], min_cosine_leaf=worst, ranks=rows)


def mesh_family_runs(torch, spawn_dir, device="cuda", smoke=False):
    """(a) and (b): every family first on one device (the card's tokens and
    margins; the train step's loss and gradients), then the four ranks.
    Returns (report, {kernel: launches a rank in (a)})."""
    import shutil
    import tempfile

    from repro_torch.launch.mesh import spawn

    Path(spawn_dir).mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=spawn_dir))
    t0 = time.perf_counter()
    singles = {arch: mf_serve_single(torch, arch, device, smoke) for arch in MF_ARCHS}
    paths, trains = {}, {}
    for i, arch in enumerate(MF_TRAIN):
        paths[arch] = str(work / f"grads-{i}.pt")
        trains[arch] = mf_train_single(torch, arch, paths[arch], device, smoke)
    single_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    try:
        ranks = spawn(mesh_family_rank, 4, backend="gloo", init_file=str(work / "init"),
                      timeout=MF_SPAWN_TIMEOUT,
                      args=(paths, "cuda:0" if device == "cuda" else device, smoke))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    spawn_s = time.perf_counter() - t0
    report, launches = {"serve": {}, "train": {}}, {}
    for arch in MF_ARCHS:
        cfg = mf_config(arch, smoke)
        reps = [r["serve"][arch] for r in ranks]
        report["serve"][arch] = mf_serve_report(arch, cfg, singles[arch], reps, device)
        for k in KERNEL_NAMES:
            launches[k] = launches.get(k, 0) + reps[0]["launches"][k]
    report["fsdp"] = {}
    for arch in MF_TRAIN:
        report["train"][arch] = mf_train_report(arch, trains[arch],
                                                [r["train"][arch] for r in ranks], device)
        report["fsdp"][arch] = check_mesh_train_fsdp([r["fsdp"][arch] for r in ranks],
                                                     f"(b) {arch}")
    log(f"  one device first {single_s:.1f} s; the four ranks' spawn to join {spawn_s:.1f} s")
    report.update(single_s=single_s, spawn_s=spawn_s)
    return report, launches


def phase_mesh_families(torch):
    """Phase 19: the xLSTM, zamba and encdec trees on a model axis (see
    ``mesh_family_runs``).  Returns (report, {kernel: launches a rank})."""
    log(f"phase 19: xlstm-125m, zamba2-7b and {ENCDEC_ARCH} on a model axis: served on (data "
        f"{MF_SERVE_MESH[0]}, model {MF_SERVE_MESH[1]}), trained on (data {MF_TRAIN_MESH[0]}, "
        f"model {MF_TRAIN_MESH[1]}) ({card_line()})")
    return mesh_family_runs(torch, str(ROOT / "build"))


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))

    log("phase 1: device")
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    log(f"  {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"  torch.backends.cuda.matmul.allow_tf32 = {torch.backends.cuda.matmul.allow_tf32}, "
        f"torch.backends.cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}")

    log("phase 2: build")
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    reports = build.build()
    build_s = time.perf_counter() - t0
    log(f"  built {', '.join(reports)} in {build_s:.1f} s (nvcc, sm_90a)")
    for name, rep in reports.items():
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", rep)]
        spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", rep)]
        log(f"  {name}: {len(regs)} kernels, registers {min(regs)}-{max(regs)}, "
            f"spill stores up to {max(spills)} bytes (ptxas -v)")
        tc = ptxas_functions(rep, TC_KERNELS.get(name, "-"))
        if tc:
            log(f"    tensor-core kernels: {len(tc)}, registers "
                f"{min(r for r, _ in tc.values())}-{max(r for r, _ in tc.values())}, spill "
                f"stores up to {max(sp for _, sp in tc.values())} bytes")
            spilled = [f for f, (_, sp) in tc.items() if sp]
            if spilled:
                raise AssertionError(f"{name}: tensor-core kernels spill: {spilled}")
        if name == "flash_attention":
            for fn, (regs, sp) in sorted(tc.items()):
                log(f"      {fn}: {regs} registers, {sp} bytes spill stores")
        if name in DECODE_LIBS:
            fns = ptxas_functions(rep, DECODE_KERNEL)
            if not fns:
                raise AssertionError(f"{name}: no {DECODE_KERNEL} in its ptxas report")
            spilled = [f for f, (_, sp) in fns.items() if sp]
            if spilled:
                raise AssertionError(f"{name}: decode kernels spill: {spilled}")
            log(f"    decode kernels: {len(fns)}, registers {min(r for r, _ in fns.values())}-"
                f"{max(r for r, _ in fns.values())}, no spill stores")
        for line in rep.splitlines():
            if "wgmma" in line.lower() and "warning" in line.lower():
                log(f"    ptxas: {line.strip()[:200]}")
    check_sass(build)
    dry = start_dryrun()            # phase 18's dry run, on the CPU meanwhile

    t0 = time.perf_counter()
    errs, ffn_weights = phase_check(torch)
    check_s = time.perf_counter() - t0
    log(f"  check phase {check_s:.1f} s")
    t0 = time.perf_counter()
    timing, timing_mixed = phase_timing(torch, ffn_weights)
    timing.update(phase_timing_training(torch))
    timing.update(phase_timing_static(torch, ffn_weights))
    timing.update(phase_timing_families(torch))
    timing.update(phase_timing_zamba(torch))
    timing.update(phase_timing_encdec(torch))
    timing.update(phase_timing_mesh(torch))
    timing.update(phase_timing_mesh_train(torch))
    timing.update(phase_timing_mesh_families(torch))
    timing.update(phase_timing_combine(torch))
    again = remeasure(torch, timing, ffn_weights)
    timing_s = time.perf_counter() - t0
    log(f"  timing phase {timing_s:.1f} s")
    del ffn_weights
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launches, e2e, base_tokens = phase_serve(torch)
    serve_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train_launches, train = phase_train(torch)
    train_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    kv_launches, kv, kv_tokens = phase_kv(torch, base_tokens)
    kv_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    log("phase 8: checkpoints and restarts, m6-base widths at 2 layers")
    t0 = time.perf_counter()
    ckpt = checkpoint_phase(torch, TRAIN_ARGS)
    ckpt_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    spec = phase_spec(torch, base_tokens, kv_tokens["int8"], e2e, kv)
    spec_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    slo, slo_launches = phase_slo(torch)
    slo_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    static, static_launches, router_launches = phase_static(torch, e2e)
    static_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    families, family_launches = phase_families(torch)
    families_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    more, more_launches = phase_more_families(torch)
    more_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    zamba, zamba_launches = phase_zamba(torch)
    zamba_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    encdec, encdec_launches = phase_encdec(torch)
    encdec_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mesh, mesh_launches = phase_mesh(torch, base_tokens, kv_tokens["int8"])
    mesh_s = time.perf_counter() - t0
    log(f"  mesh phase {mesh_s:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mesh_train, mesh_train_launches = phase_mesh_train(torch)
    mesh_train_s = time.perf_counter() - t0
    log(f"  mesh training phase {mesh_train_s:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tooling = phase_tooling(torch, e2e, train, mesh_train, dry)
    tooling_s = time.perf_counter() - t0
    log(f"  tooling phase {tooling_s:.1f} s (the dry run's CPU process started after phase 2)")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mesh_families, mesh_family_launches = phase_mesh_families(torch)
    mesh_families_s = time.perf_counter() - t0
    log(f"  mesh families phase {mesh_families_s:.1f} s")
    log(f"  serve phase {serve_s:.1f} s, train phase {train_s:.1f} s, kv phase {kv_s:.1f} s, "
        f"checkpoint phase {ckpt_s:.1f} s, speculative phase {spec_s:.1f} s, slo phase "
        f"{slo_s:.1f} s, static phase {static_s:.1f} s, families phase {families_s:.1f} s, "
        f"more families phase {more_s:.1f} s, zamba phase {zamba_s:.1f} s, encdec phase "
        f"{encdec_s:.1f} s, mesh phase {mesh_s:.1f} s, mesh training phase {mesh_train_s:.1f} s, "
        f"mesh families phase {mesh_families_s:.1f} s; {time.perf_counter() - START:.1f} s "
        f"since the script started")
    log("phase 20: report")

    sources = {
        "paged_decode_attention": (
            "src/repro_torch/kernels/decode_attention/csrc/paged_decode_attention.cu",
            "src/repro/kernels/decode_attention/kernel.py:143", launches),
        "ragged_ffn": (GROUPED_FFN_SM90, "src/repro/kernels/moe_dropless/kernel.py:80",
                       launches),
        # no Pallas kernel: the reference's combine is XLA's scatter-add
        "ragged_combine": ("src/repro_torch/kernels/moe_dropless/csrc/ragged_combine.cu",
                           "src/repro/core/dispatch/dropless.py:176", launches),
        "moe_ffn": (GROUPED_FFN_SM90, "src/repro/kernels/moe_ffn/kernel.py:72", train_launches),
        "flash_attention": (FLASH_SM90, "src/repro/kernels/flash_attention/kernel.py:66",
                            {"flash_attention": train["flash"]["launches"]}),
        "quantized_paged_decode_attention": (
            "src/repro_torch/kernels/decode_attention/csrc/quantized_paged_decode_attention.cu",
            "src/repro/kernels/decode_attention/kernel.py:226", kv_launches),
        "decode_attention": ("src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention/kernel.py:63", static_launches),
    }
    # phase 11's shapes of the kernels that run there
    static_timing = {"decode_attention": ["decode_attention static"],
                     "moe_ffn": ["moe_ffn X=1", "moe_ffn X=15"],
                     "ragged_ffn": ["ragged_ffn static prefill", "ragged_ffn expert choice"]}
    # phase 12's shapes of the kernels that run there
    family_timing = {
        "paged_decode_attention": [f"paged_decode_attention {g}" for g in FAMILY_HEADS],
        "quantized_paged_decode_attention": [f"quantized_paged_decode_attention {q} {g}"
                                             for q in ("int8", "fp8") for g in FAMILY_HEADS],
        "decode_attention": [f"decode_attention {g}" for g in FAMILY_HEADS],
        "moe_ffn": ["moe_ffn granite train"],
        "ragged_ffn": [f"ragged_ffn {label}" for label in FAMILY_FFN]}
    kernels = []
    for name, (src, replaces, counts) in sources.items():
        if counts[name] <= 0:
            raise AssertionError(f"{name}: launched no time on its path")
        # the dense kernel's path is the static engine: its times at that shape
        t = timing["decode_attention static" if name == "decode_attention" else name]
        entry = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                 "launches": counts[name], "max_abs_err": errs[name],
                 "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                 "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                 "device_ms": t["device_ms"], "library_device_ms": t["library_device_ms"]}
        if src == GROUPED_FFN_SM90:       # the grouped FFN's tensor-core route
            entry.update(device_code="tensor cores (wgmma, TMA), bf16 h hi + lo",
                         entry_point=f"{name}_tc", max_abs_err_split_h=errs[f"{name} split"],
                         cuda_core_ms=t["cuda_core_ms"])
        if name == "ragged_ffn":          # with the liveness (the path's call) and without
            entry.update(schedule="a device-built work list of live runs, persistent passes",
                         tile=t["tile"], without_liveness_ms=t["without_liveness_ms"],
                         without_liveness_device_ms=t["without_liveness_device_ms"],
                         dispatch_syncs=DISPATCH_SYNCS)
        if name == "ragged_combine":      # no TPU kernel; its shapes beside the decode step's
            entry.update(note="replaces XLA's scatter-add (.at[gi, tok].add), not a Pallas "
                              "kernel; library_ms is the index_put_(accumulate=True) scatter-add "
                              "it replaced",
                         index_add_ms=t["index_add_ms"],
                         index_add_device_ms=t["index_add_device_ms"],
                         shapes={label: {k: timing[f"ragged_combine {label}"][k]
                                         for k in ("shape", "ms", "device_ms", "plain_ms",
                                                   "bound_ms", "bound_by", "library_ms",
                                                   "library_device_ms", "index_add_ms",
                                                   "index_add_device_ms")}
                                 for label in COMBINE_SHAPES},
                         phase5_profile_ms=e2e.get("combine_device_ms"),
                         phase5_profile_calls=e2e.get("combine_calls"))
        if src == FLASH_SM90:             # flash attention's tensor-core route
            entry.update(device_code="tensor cores (wgmma, TMA), P from registers as bf16 hi + lo",
                         entry_point="flash_attention_tc",
                         max_abs_err_split_p=errs["flash_attention split"],
                         tc_launches=train["flash"]["tc_launches"],
                         cuda_core_ms=t["cuda_core_ms"],
                         cuda_core_device_ms=t["cuda_core_device_ms"])
        if "plan" in t:                   # the decode kernels' ring and cluster split
            copies = ("TMA boxes of a tensor map, the first pass's issued before the length "
                      "is read"
                      if name == "decode_attention" else "bulk copies of whole KV tiles")
            entry.update(device_code=f"{copies}, into a ring of stages, split over a "
                                     f"thread-block cluster",
                         header=DECODE_SM90, splits=t["plan"][0], stages=t["plan"][1])
        v = spec["timing"].get(name)
        if v is not None:                 # phase 9: the verify step's shape
            entry.update(verify_launches=sum(
                r["launches"][name] for r in spec["greedy"].values()),
                verify_ms=v["ms"], verify_device_ms=v["device_ms"],
                verify_plain_ms=v["plain_ms"], verify_bound_ms=v["bound_ms"],
                verify_library_device_ms=v["library_device_ms"])
        if name in static_timing:         # phase 11: the static engine and router training
            entry["static_launches"] = static_launches[name]
            if name != "decode_attention":
                entry["router_train_launches"] = router_launches[name]
            entry["static_shapes"] = {
                label: {k: timing[label][k] for k in ("device_ms", "plain_ms", "bound_ms",
                                                      "library_device_ms")}
                for label in static_timing[name]}
        if name == "decode_attention":   # phase 4's 8 x 256 cache and phase 7's engine pools
            # the static plan every path takes since PR 33, the per-length plan beside it
            entry.update(per_length_plan=t["per_length_plan"], per_length_ms=t["per_length_ms"],
                         per_length_device_ms=t["per_length_device_ms"])
            entry.update(t256_device_ms=timing[name]["device_ms"],
                         t256_bound_ms=timing[name]["bound_ms"],
                         engine_pool_launches=kv_launches[name])
        if name in slo_launches:          # phase 10: the SLO runs
            if slo_launches[name] <= 0:
                raise AssertionError(f"{name}: launched no time in phase 10")
            entry["slo_launches"] = slo_launches[name]
        if name in family_timing:         # phase 12: the families' shapes and runs
            # (the dense kernel's path is the static engine: phase 3 holds it at G = 3, 5)
            if name != "decode_attention" and family_launches[name] <= 0:
                raise AssertionError(f"{name}: launched no time in phase 12")
            entry["family_launches"] = family_launches[name]
            entry["family_max_abs_err"] = errs[f"family {name}"]
            entry["family_shapes"] = {
                label: {k: timing[label][k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                                      "bound_by", "library_ms",
                                                      "library_device_ms")}
                for label in family_timing[name]}
        # phase 13: Fig. 4's training (moe_ffn), the mixed stack's serving
        # (paged, ragged, dense) and training (moe_ffn); xlstm runs no kernel
        entry["more_families_launches"] = more_launches[name]
        if name in MORE_FAMILIES_KERNELS and more_launches[name] <= 0:
            raise AssertionError(f"{name}: launched no time in phase 13")
        # phase 14: zamba's shared attention, the dense kernel at D = 224
        entry["zamba_launches"] = zamba_launches[name]
        if name == "decode_attention":
            if zamba_launches[name] <= 0:
                raise AssertionError(f"{name}: launched no time in phase 14")
            entry["zamba_max_abs_err"] = errs[f"zamba {name}"]
            entry["zamba_shapes"] = {
                label: {k: timing[label][k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                                      "bound_by", "library_ms",
                                                      "library_device_ms", "plan",
                                                      "per_length_plan", "per_length_device_ms")}
                for label in ("decode_attention zamba", "decode_attention zamba longest")}
        # phase 15: encdec's self- and cross-attention decode and the softcap,
        # the dense kernel's
        entry["encdec_launches"] = encdec_launches[name]
        if name == "decode_attention":
            if encdec_launches[name] <= 0:
                raise AssertionError(f"{name}: launched no time in phase 15")
            entry["encdec_max_abs_err"] = errs[f"encdec {name}"]
            entry["softcap_max_abs_err"] = errs[f"softcap {name}"]
            for key, labels in (("encdec_shapes", ("decode_attention encdec cross",
                                                   "decode_attention encdec cross T=250")),
                                ("softcap_shapes", ("decode_attention static softcap",))):
                entry[key] = {
                    label: {k: timing[label][k] for k in ("ms", "device_ms", "plain_ms",
                                                          "bound_ms", "bound_by", "library_ms",
                                                          "library_device_ms", "plan")}
                    for label in labels}
        # phase 16: the mesh's launches (rows 3-5) and a shard's shapes
        if name in MESH_TIMING:
            entry["mesh_launches"] = mesh_launches.get(name, {})
            if not entry["mesh_launches"] or min(entry["mesh_launches"].values()) <= 0:
                raise AssertionError(f"{name}: launched no time in phase 16: "
                                     f"{entry['mesh_launches']}")
            entry["mesh_max_abs_err"] = errs[f"mesh {name}"]
            entry["mesh_shapes"] = {
                label: {k: timing[label][k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                                      "bound_by", "library_ms",
                                                      "library_device_ms")}
                for label in MESH_TIMING[name]}
        # phase 17 (b): the mesh training runs' launches (rows 1 and 3), and
        # their shapes held against the plain versions and timed
        if name in mesh_train_launches:
            entry["mesh_train_launches"] = mesh_train_launches[name]
            if mesh_train_launches[name] <= 0:
                raise AssertionError(f"{name}: launched no time in phase 17")
            if name in MESH_TRAIN_TIMING:
                entry["mesh_train_max_abs_err"] = errs[f"mesh_train {name}"]
                entry["mesh_train_shapes"] = {
                    label: {k: timing[label][k] for k in ("ms", "device_ms", "plain_ms",
                                                          "bound_ms", "bound_by", "library_ms",
                                                          "library_device_ms")}
                    for label in MESH_TRAIN_TIMING[name]}
        # phase 19 (a): the dense kernel a rank of the (1, 4) mesh, zamba's
        # shared attention and encdec's self- and cross-attention
        entry["mesh_families_launches"] = mesh_family_launches[name]
        if name == "decode_attention":
            if mesh_family_launches[name] <= 0:
                raise AssertionError(f"{name}: launched no time in phase 19")
            entry["mesh_families_max_abs_err"] = errs[f"mesh_families {name}"]
            entry["mesh_families_shapes"] = {
                label: {k: timing[label][k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                                      "bound_by", "library_ms",
                                                      "library_device_ms", "plan")}
                for label in (f"decode_attention {x[0]}" for x in mf_kernel_shapes())}
        kernels.append(entry)
    print(json.dumps({"serve": e2e, "train": train, "kv": kv, "checkpoint": ckpt,
                      "spec": spec, "slo": slo, "static": static, "families": families,
                      "more_families": more, "zamba": zamba, "encdec": encdec, "mesh": mesh,
                      "build_s": build_s, "check_s": check_s, "timing_s": timing_s,
                      "serve_s": serve_s, "train_s": train_s, "kv_s": kv_s,
                      "checkpoint_s": ckpt_s, "spec_s": spec_s, "slo_s": slo_s,
                      "static_s": static_s, "families_s": families_s,
                      "more_families_s": more_s, "zamba_s": zamba_s, "encdec_s": encdec_s,
                      "mesh_s": mesh_s, "mesh_train": mesh_train, "mesh_train_s": mesh_train_s,
                      "tooling": tooling, "tooling_s": tooling_s,
                      "mesh_families": mesh_families, "mesh_families_s": mesh_families_s,
                      "mixed_step_kernels": timing_mixed,
                      "moe_ffn_x180": timing["moe_ffn X=180"],
                      "flash_attention_s256": timing["flash_attention S=256"],
                      "quantized_fp8": timing["quantized_paged_decode_attention fp8"],
                      "paged_splits": timing["splits"], "remeasure": again}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
