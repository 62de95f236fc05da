#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card::

    python3 chip_smoke.py

Phases (any failure exits non-zero, before the result lines):

1. the device: name, count, ``nvidia-smi`` name and power limit; TF32 off;
2. build the CUDA kernels (``gru_sequence``, ``gru_sequence_q8``,
   ``gru_cell_q8``, ``slstm_cell``, ``flash_attn``, ``decode_attn``,
   ``gru_cell``, ``rowwise_matvec`` and ``gru_shard``, one ``nvcc`` each,
   started together) and print ``-Xptxas -v``'s report (``gru_shard``'s
   functions, rows 16 and 18's among them, ``gru_sequence_kernel``'s, both
   routes, ``gru_step_q8``'s warp route, the two fused decode kernels'
   warp routes, ``gru_stack_sequence_kernel``'s warp route, its 4
   instances, and the q8 prefills' warp routes, ``gru_sequence_q8_kernel``'s
   and ``gru_stack_sequence_q8_kernel``'s 4 each, the single step's
   new routes, ``gru_step_warp_k``'s 12 and ``gru_step_wide_k``'s 24
   instances, and the sLSTM pair's warp route, ``slstm_stack_warp_k``'s
   3, must not spill; the prefill warp routes', the step's new routes'
   and the sLSTM warp route's registers are printed)
   and each kernel's dynamic
   shared memory (the attention and row-wise kernels' as the wrappers
   compute it and as the CUDA sources do, which must agree), the row-wise
   matmuls' launch plans at qwen3-0.6b's shapes, and check that the bf16
   ``flash_attention`` and row-wise/cascade kernels' SASS holds tensor-core
   instructions (HGMMA, HMMA) and the fp32 matmuls' none;
3. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes (gru-jet L=1 H=20, gru-jet-deep L=3 H=32, and the
   chain's depth-1 layers of H=20 and H=32; B in {1, 8, 64}; T in {8, 16,
   32}; v1 and v3; masked and not): largest absolute error at most 1e-5,
   for the three fp32 kernels, the two fused q8 kernels, the q8 chain's
   two kernels (int8 weight rows quantized on the card) and the two sLSTM
   kernels (slstm-jet L=1 H=20 and L=3 H=32; a fully masked row, whose
   leaves, ``m = M_INIT`` included, must come out bit for bit);
   ``gru_sequence_kernel`` must launch the route ``seq_plan`` names (the
   warp route at these widths), and its block route, forced through the C
   entry at every shape beside it, must agree with the plain version too;
   the largest difference between the two routes is reported;
   ``gru_step_q8`` likewise must launch the route ``step_q8_plan`` names
   (the warp route at these widths), and its block route, forced beside
   it, must agree with the plain version and equal it bit for bit; so
   must ``gru_stack_decode_kernel`` and ``gru_stack_decode_q8_kernel``
   (``decode_plan``, ``decode_q8_plan``: the warp route at gru-jet's L=1
   H=20 and gru-jet-deep's L=3 H=32), and ``gru_stack_sequence_kernel``
   (``stack_seq_plan``: the warp route at gru-jet-deep's L=3 H=32, B 1, 8
   and 64, T 8, 16 and 32, v1 and v3, masked and not), and the q8
   prefills, ``gru_stack_sequence_q8_kernel`` (``stack_seq_q8_plan``: the
   warp route at L=1 H=20 and L=3 H=32) and ``gru_sequence_q8_kernel``
   (``seq_q8_plan``: the warp route at H=20 and 32), and the two sLSTM
   kernels (``slstm_decode_plan``, ``slstm_stack_seq_plan``: the warp
   route at slstm-jet's L=1 H=20 and the L=3 H=32 stack), each equal to
   its block route bit for bit, the largest difference between the routes
   reported;
3b. hold the seven shard kernels (the ``cuda_sharded`` backend's per-rank
   steps) against their plain versions on the card at gru-jet's (H=20)
   and gru-jet-deep's (H=32) shard widths and at wide shards (H 64, 256,
   512) over 1, 2 and 4 ranks (Hl = H, H/2, H/4), B 1 and 8, with the mesh
   path's row-strided gate slices: largest absolute error at most 1e-5;
   the five redesigned kernels (``gru_rowwise_shard_step``,
   ``gru_rowwise_shard_zr``, ``gru_rowwise_shard_candidate``,
   ``gru_shard_matvec``, ``gru_cascade_shard_zr``) must launch the route
   ``shard_plan`` names (direct or column tile);
   ``gru_cascade_shard_gates`` runs as the mesh step calls it (gate views
   of the full (B,3H) gates and projection, b's view) and must equal the
   sequence it replaced (+ b, two slice copies, the contiguous call) bit
   for bit; so must ``gru_cascade_shard_update`` (column slices of the
   psum'd (B,H) partial, of xp's candidate gate and of b) against its old
   sequence (two adds, the contiguous call), on every rank of each mesh;
4. serve gru-jet and gru-jet-deep through ``ServeEngine`` with
   ``backend="cuda"`` (12 requests over 8 slots, ragged prompts of 1-20
   vectors, 16 decode steps each): every prefill and decode step must be
   attributed to ``cuda_fused``, the launch counters (zeroed just before)
   must rise by the prefills and steps served, no plain version may run,
   the class streams must equal the ``eager`` engine's on the card, and
   the prefill logits must be finite and agree with the dense reference on
   a small batch; every served call of ``gru_stack_decode_kernel`` and of
   ``gru_stack_sequence_kernel`` must launch the warp route;
5. serve both configs again, pinned to ``cuda_fused_q8`` (the int8
   datapath), with the counters zeroed just before: both q8 kernels must
   launch once per prefill and per step, no fp32 kernel and no plain
   version may run, the class streams and prefill logits must equal the
   CPU run of the same pin; every served call of
   ``gru_stack_decode_q8_kernel`` and of ``gru_stack_sequence_q8_kernel``
   must launch the warp route; the share of
   tokens on which the q8 and fp32 streams agree is reported only;
6. serve both configs and a heterogeneous stack (gru-jet-deep with
   ``layer_dims=(32, 32, 20)``) through the per-layer chain, with the
   counters zeroed just before: the two configs pinned to ``cuda_chain``,
   the heterogeneous stack under ``backend="cuda"``; every prefill and
   step must be attributed to ``cuda_chain``, ``gru_sequence_kernel`` must
   launch L times per prefill and L times per step, no other kernel and no
   plain version may run, and the class streams must equal the ``eager``
   engine's on the card; every served call of ``gru_sequence_kernel``
   (phases 4 and 6) must launch the warp route;
7. the same three pinned to ``cuda_chain_q8``: ``gru_sequence_q8_kernel``
   must launch L times per prefill and ``gru_step_q8`` L times per step,
   no other kernel and no plain version may run, and the class streams and
   prefill logits must equal the CPU run of the same pin; every served
   call of ``gru_step_q8`` and of ``gru_sequence_q8_kernel`` must launch
   the warp route;
8. serve the sLSTM family: slstm-jet and slstm-jet with ``num_layers=3,
   hidden_dim=32`` through ``ServeEngine`` with ``backend="cuda"``, with
   the counters zeroed just before: every prefill and step attributed to
   ``cuda_fused``, the sequence kernel launched once per prefill and the
   decode kernel once per step, no GRU kernel and no plain version run,
   class streams equal to the ``eager`` engine's on the card, prefill
   logits within 1e-5 of the dense reference; every served call of either
   kernel on its warp route (each kernel's ``last_plan`` printed, the
   decode reading the served state in place through its table of
   per-layer pointers); every GRU phase above
   counts the sLSTM and attention kernels among its other kernels (none
   may run);
8b. the tuning loop (counters zeroed just before, plain versions
   watched): gru-jet-deep served at 8 slots (``SystemClock``) pinned to
   ``cuda_fused``, ``cuda_chain`` and ``eager``; their served decode p50s
   (host clock, synchronized) become a ``CostModel``, and
   ``compile(backend="cuda", batch=8, mode="decode")`` must choose the
   faster of the two kernel backends; then that table with the two
   swapped is installed between two waves of an autotuned engine
   (recalibration off): the second wave must run on the other backend
   (``decode_backend_steps``), launching its kernel (row 1 for
   ``cuda_chain``, row 3 for ``cuda_fused``), with class streams equal to
   an untuned engine's; then slstm-jet is served pinned to ``cuda_fused``
   and ``eager``, their p50s seed a ``CostModel``, and an autotuned
   slstm-jet engine under ``backend="auto"`` with recalibration on serves
   three waves (its decisions and the cost epoch printed): after each
   wave ``compile(mode="decode")`` must choose by measured cost
   (``cost_source == "measured"``) the backend the table in force prices
   lower, and its streams must equal the untuned and eager engines'.
   Afterwards (its counts already read) every sLSTM call the phase served,
   the ragged T of the tuned bucket ladders included, is held against its
   plain version by phase 3's rules. Its launches of rows 1-3, 8 and 9
   are added to the kernels line's counts;
8c. the serving fleet (``repro_torch.serve.fleet``, full width, seed 0,
   counters zeroed just before each part, plain versions watched, every
   prefill and step of every engine recorded, those of killed replicas
   too): (a) gru-jet-deep under ``backend="cuda"`` on a ``FleetRouter``
   of 2 replicas of 8 slots under a ``SystemClock``, ``FleetConfig()``
   defaults, depth routing, 24 requests with ragged prompts of 1-20
   vectors and 16 decode steps: every request completes, none fails or is
   shed, the class streams equal one engine's at 8 slots on the card and
   the ``eager`` engine's; (b) the same requests on 3 replicas under a
   ``ManualClock``, replica0 killed while it holds flights and restored
   later, replica1 slowed 6x for a window (three replicas, since the
   straggler monitor compares with the median of the replicas' medians):
   kills, restores, retries and hedges each at least 1, every request
   completed, the streams equal (a)'s, the restart releases the dropped
   engine (``torch.cuda.memory_allocated()`` no higher after it; printed
   before and after the run) and the restored replica serves steps again
   on ``cuda_fused``; (c) gru-jet through ``AsyncFleetClient`` (2
   replicas, ``SystemClock``), 16 concurrent client coroutines, one
   cancelled mid-stream: that ticket ends ``cancelled``, every other
   stream equals its ``request.out`` and one engine's, and every prefill
   and step ran on the front end's ``fleet-tick`` worker thread; (d)
   slstm-jet on 2 replicas with a kill and a restore under a
   ``ManualClock``: streams equal one engine's; (e) the CLI's
   ``--replicas 2 --inject-faults`` run of gru-jet-deep, sync and
   ``--async``, each in its own process (both started together), must
   exit 0 with every request completed. In each of (a)-(d) the prefill
   row (1, 2 or 8) launches once per prefill and the decode row (3 or 9)
   once per decode step served, on the warp route, every prefill and step
   is on ``cuda_fused``, and no other kernel and no plain version runs;
   each part prints its e2e p50/p99, queue-wait p99, each replica's
   decode p50/p99, retries and hedges. Every served shape phase 3 did not
   cover is then held against its plain version by phase 3's rules. Its
   launches of rows 1-3, 8 and 9 are added to the kernels line's counts;
8d. training on the card (counters zeroed just before each part, plain
   versions watched; training itself must launch no kernel and run no
   plain version: it is eager with autograd): (a) gru-jet through the
   port's train CLI in this process, 300 steps at batch 64, lr 3e-3, a
   checkpoint every 100 into a temporary directory, then ``--resume`` to
   320; the first run's state carried on in memory over steps 300-319
   under the resumed run's schedule (the run that never stops) must
   equal the resumed params within 1e-6 (the largest difference printed);
   the loss at step 319 below step 0's; ``batch_at(10_001)`` (256 rows)
   classified under ``torch.no_grad()`` through ``eager`` (accuracy above
   0.5) and ``cuda_fused``: logits within 1e-5, the same classes, row 1
   launched once, nothing else; (b) gru-jet-deep and slstm-jet, 50 steps
   each, the loss falling; ``microbatches=2`` against 1 from one state:
   the step-0 gradients within rtol 1e-5, the params after 5 steps
   within 1e-5 on every element whose two step-0 gradients agree to 1e-3
   (the rest, gradients at noise level that AdamW turns into +-lr
   steps, counted and printed); the trained gru-jet-deep through
   ``cuda_fused`` (row 2) as in (a); (c) qwen3-0.6b at full width (fp32
   params, bf16 compute, ``attn_impl="chunked"``), 8 steps at batch 4 x
   seq 256, the loss finite and falling, the step time, tokens/s, the
   gradient and AdamW parts of 3 more steps and the peak memory
   printed; a config on ``attn_impl="cuda"`` (and gru-jet on
   ``cuda_fused``) must raise "has no backward" at ``make_train_step``
   and, under autograd, at the kernel wrapper; (d) the q8 harness
   (``repro_torch.quant.accuracy.run``) at gru-jet and at L=3 H=32, its
   artifact in a temporary directory: each backend's errors, argmax
   matches, ties and ``passed`` printed (a ``passed: false`` is a
   measurement, not a failure); each pin's logits on the card within
   1e-5 of the CPU run of the same pin on the same trained params; rows
   4 and 6 launched 8 and 8L times (one per eval batch and layer), no
   plain version; a passing artifact loaded with ``load_quant_accuracy``
   opens the port's gate, which makes both q8 backends legal for
   ``quant="int8"``, and ``compile(quant="int8", backend="cuda")`` then
   chooses by a table of this card's decode p50s (``eager``, the two
   fp32 and the two q8 backends at 8 rows): the backend it measures
   fastest; the gate and the cost table in force before are restored.
   Its launches of rows 1, 2, 4 and 6 are added to the kernels line's
   counts;
9. hold the dense LM's attention kernels against their plain versions on
   the card, in fp32 (at most 1e-5) and bf16 (flash attention, whose
   output is bf16: within rtol = atol = 2**-7, one bf16 ulp; flash decode,
   whose output is fp32: at most 1e-5): qwen3-0.6b's heads (Hq 16, Hkv 8,
   D 128) at S = 12, 128 and 2048, a window, Sq and Sk off the tiles,
   rows with no valid key (exactly 0); decode with C = S + 64, a wrapped
   ring, a window, empty slots and a fully masked cache (exactly 0); then
   at the LM zoo's heads (``ZOO_HEADS``: qwen2-moe-a2.7b's 16/16x128,
   G = 1; qwen3-moe-235b-a22b's 64/4x128, G = 16; phi4-mini-3.8b's
   24/8x128, G = 3; qwen2.5-3b's 16/2x128 and command-r-35b's 64/8x128,
   G = 8) at the served waves' shapes (prefill S = 12 and 128, decode C =
   76 and 192), and at hymba-1.5b's 25/5x64 (G = 5) at phase 10c's
   shapes (prefill S = 1280 with its window of 1024 and without, S = 128
   and 12 under the window; decode against a full wrapped window ring of
   C = 1024, a global layer's C = 1344 and the short prompts' rings), at
   whisper-large-v3's 20/20x64 (G = 1) at phase 10d's shapes (the
   encoder's S = 1500 non-causal, and causal; the decoder's causal S = 4
   and 64; cross-attention Sq = 4 and 64 against Sk = 1500; decode at the
   self rings' C = S + 64 and against the 1500-slot cross cache with every
   slot valid) and at llava-next-mistral-7b's 32/8x128 (G = 4: prefill S
   = 640, decode C = 704), under the same tolerances;
10. serve qwen3-0.6b at full width (28 layers, d_model 1024, vocab
   151,936; fp32 params from seed 0, bf16 compute, ``attn_impl="cuda"``)
   through ``ServeEngine.generate``: two waves of 4 requests (prompt
   lengths 12, and 128 and 12), 16 new tokens each, with the counters
   zeroed just before: flash attention must launch 28 times per prefill
   and flash decode 28 times per decode step, no plain version and no
   recurrent kernel may run; then the same waves in fp32 through
   ``attn_impl="chunked"``: logits along the served tokens within
   ``LM_LOGIT_TOL`` of the bf16 run, and the token streams equal or,
   where they part, the fp32 run's two top logits within that tolerance;
10b. serve the MoE family: qwen2-moe-a2.7b at full width and full depth
   (24 layers, d_model 2048, 60 experts padded to 64, top-4, shared
   expert 5632, vocab 151,936; seed 0, built leaf by leaf on the host into
   the served bf16 tree, ``init_prepared``, which equals ``prepare_params``
   of the fp32 tree; the host's ``MemAvailable``, the init time and the
   peak device memory printed), bf16 compute, ``attn_impl="cuda"``,
   through ``ServeEngine.generate``: phase 10's two waves, counters zeroed
   just before: flash attention 24 launches per prefill, flash decode 24
   per decode step, no plain version and no recurrent kernel; decode-step
   p50/p99 (host clock); then the same waves again through the kernels
   and through ``attn_impl="chunked"`` on the same bf16 params, logits
   and routings recorded: the streams equal or, where they part, the
   chunked run's two top logits within ``MOE_TOP2_TOL``; the count of
   (token, layer) top-k sets that differ between the two runs (routing
   flips) printed, as is the largest logit difference (not held: a flip
   moves a token's logits); one decode step profiled, split into
   ``flash_decode``, the expert products (``aten::bmm``) and the rest,
   beside the step's byte bound. Then qwen3-moe-235b-a22b at full width
   with its depth cut to 2 (reduced; 6.2 B parameters): one wave of 4
   (prompt lengths 128 and 12), flash attention 2 per prefill, flash
   decode 2 per step at G = 16, nothing else;
10c. serve the recurrent LMs: hymba-1.5b at full width and full depth
   (32 layers, d_model 1600, 25/5 heads of 64, a window of 1024 on 29
   layers, SSM heads of state 16, vocab 32,001; seed 0, built leaf by
   leaf into the served bf16 tree), bf16, ``attn_impl="cuda"``, through
   ``ServeEngine.generate``: a wave of 4 prompts of 1280 tokens (past the
   window: the window masks in prefill and the rings wrap) and one of 128
   and 12 (under it: the ring repair), 16 new tokens each, counters
   zeroed just before: flash attention 32 launches per prefill, flash
   decode 32 per decode step, no plain version and no other kernel; then
   the same waves recorded through the kernels (a second cuda run's
   streams equal the first's) and through ``attn_impl="chunked"`` on the
   same params: the streams equal or, where they part, the chunked run's
   top two logits within ``HYMBA_TOP2_TOL``; every served prefill's and
   step's logits against teacher-forced ``forward`` s over the prompts and
   the generated tokens, bf16 and fp32 (the same seed's fp32 tree): the
   served logits depart from either by at most ``BF16_SERVED_FACTOR``
   times the bf16 forward's own departure from the fp32 one; the same
   waves served in fp32 through the kernels' fp32 paths, against their
   fp32 teacher-forced forward, within ``FP32_SERVED_TOL`` (the windowed
   rings on the card); one decode step profiled (wall, device busy, idle
   share); step p50/p99 and peak memory printed. Then xlstm-125m at full
   width (12 layers, d_model 768, vocab 50,304; seed 0) in bf16: one wave
   of 4 prompts of 128 tokens, 16 new tokens, no kernel and no plain
   version run; the bf16 and fp32 teacher-forced rules as hymba's (the
   bf16 logits held against fp32 forwards of the same params and the fp32
   serve against its own); one decode step profiled; p50/p99 and peak
   memory printed;
10d. the encoder-decoder and vision-language families, through the model
   API (``get_api(cfg).prefill``, then greedy ``decode_step`` s as the
   engine serves an LM wave; JAX's engine serves neither family), seed 0,
   built leaf by leaf into the served bf16 tree, ``attn_impl="cuda"``,
   counters zeroed just before, plain versions watched: whisper-large-v3
   at full width and depth (32 encoder and 32 decoder layers, d_model
   1280, 20/20 heads of 64, 1500 frames, vocab 51,866), two aligned waves
   of 4 (prompts of 4 and 64 tokens, random frame embeddings), 16 new
   tokens each: flash attention exactly 96 launches a prefill (the
   encoder's, the decoder's causal self-attention and the cross-attention
   at Sq != Sk), flash decode 64 a step (the self ring and the cross cache
   with every slot valid), no plain version and no other kernel; the same
   waves through ``attn_impl="chunked"`` on the same params: the streams
   equal or, where they part, the chunked run's top two logits within
   ``LM_LOGIT_TOL``; the same seed's fp32 tree served through the
   kernels' fp32 paths, its logits within ``FP32_SERVED_TOL`` of its own
   teacher-forced ``forward`` (the self ring's 64 empty slots: the repair
   of JAX's prefill); then llava-next-mistral-7b at full width and depth
   (32 layers, d_model 4096, 32/8 heads of 128, 576 patches of 1024,
   vocab 32,000; its fp32 tree is never built), one wave of 4 at S = 640
   (576 patch positions and 64 text tokens), 16 new tokens: flash
   attention 32 a prefill, flash decode 32 a step at G = 4, nothing else;
   bf16 ``cuda`` against bf16 ``chunked`` under ``MOE_TOP2_TOL``, the
   largest logit difference printed. For each: parameters, GB served,
   build time, peak device memory, prefill ms, decode p50/p99 (host
   clock) and one profiled decode step's device busy and idle share
   beside its bytes' bound;
11. the paper's row-wise primitives through their entry points, with the
   counters zeroed just before: ``gru_step_cuda`` at gru-jet's H=20 and
   gru-jet-deep's H=32 (B 1 and 8, v1 and v3, fp32 and bf16 u), at
   H=1024 and 2048 v1 (fp32; bf16 at 2048), at H=1024 v3 and H=1000 v1;
   ``rowwise`` and ``cascade`` at JAX's test shapes, the paper's matvec
   (B=8, K=32, N=96; also a 1-D x), qwen3-0.6b's MLP matvecs (B=4, K
   1024 -> N 3072 and 3072 -> 1024), fp32 and bf16, and ragged shapes
   (bf16 N = 20 and 100, fp32 K = 1000). Each call must launch exactly the
   kernel JAX's dispatch rule names (``gru_step_fused`` or
   ``gru_step_blocked``; ``rowwise_matmul``, ``cascade_matmul``) on the
   route its plan names (the step: ``step_plan``'s warp route at H <= 32,
   its wide route for v1 at H 1000 and up, the column tile for v3 there,
   checked on ``last_plan`` after every call; the matmuls: plain loads
   exactly where TMA cannot read the operands), no plain version and no
   other kernel may run; then each output is held against its plain
   version on the card (step: fp32 1e-5, bf16 u 1e-2; matmuls rtol = atol
   2e-4 fp32, 2e-2 bf16), and each step also against the column tile it
   took before (forced through the C entries) within the same tolerance,
   the largest difference printed, and against a second launch (the same
   bits);
11b. the mesh path: after the build, the script starts itself once per
   rank (``--mesh-rank``) for a 2-rank and a 4-rank mesh on the one card
   (gloo, since NCCL refuses two ranks on one device; the collectives go
   through the host) and a 1-rank NCCL group; each rank serves gru-jet-deep
   and its v3 twin through ``ServeEngine(..., ctx=ShardCtx(mesh))`` pinned
   to ``cuda_sharded`` (12 requests over 8 slots, ragged prompts of 1-20
   vectors, 16 decode steps; counters zeroed just before): every prefill
   and step attributed to ``cuda_sharded``; per step each v1 row-wise
   layer launches the z/r and candidate kernels once, the v1 cascade layer
   the matvec, its middle phase and its update once, a v3 row-wise layer
   the step kernel once, the v3 cascade layer the matvec and its gates
   once, a prefill T times that; no plain version and no other kernel;
   only this rank's slices on the card; streams equal to the ``eager``
   engine's and across ranks; prefill logits within 1e-5 of the dense
   reference (v3: the eager stack); the v3 cascade layer's step, 20 calls
   under ``torch.profiler`` on each rank, must launch the matvec and
   ``gru_cascade_shard_gates`` once a call and no cat or add kernel
   around them; the v1 cascade layer's the matvec, the middle phase and
   ``gru_cascade_shard_update`` once a call and one add kernel (the psum
   + b beside the middle phase). Then once under ``backend="cuda"``:
   prefill on ``cuda_sharded``, decode on ``cuda_fused``, every decode
   call on ``gru_stack_decode_kernel``'s warp route (its launches go to
   the kernel's row as ``mesh_launches``, apart from phase 4's
   ``launches``). Each mesh also
   profiles a served ``cuda_sharded`` decode step (reported in phase 12).
   A rank that fails fails the script;
11c. MoE under a named mesh, run right after phase 10b (its tree still on
   the card): four ranks share the one card over gloo (the collectives go
   through the host, so no collective time is a claim); rank 0 is this
   process, serving from phase 10b's served bf16 tree of qwen2-moe-a2.7b
   (full width and depth, seed 0; its experts as views, nothing copied),
   ranks 1-3 the script started again (``--moe-rank``); rank 0 broadcasts
   the dense leaves and scatters each rank its expert blocks layer by
   layer through the host (hand-out times and rank 1's GB printed): no
   other rank holds the whole expert tree. (a) On {data 4} (expert-
   parallel: 16 experts a rank, the capacity buffer by ``all_to_all``)
   phase 10's two waves through ``ServeEngine.generate`` under
   ``ShardCtx(mesh)``, counters zeroed just before: on every rank flash
   attention 24 launches a prefill and flash decode 24 a step, no plain
   version and no other kernel; the dropped (token, choice) pairs per
   wave, decode p50/p99 (host clock) and one profiled step's device busy
   and idle share; (c) the same waves at capacity factor 16, where nothing
   drops: the streams equal the one-process engine's at that factor
   (served on phase 10b's tree after the other ranks have exited) or,
   where they part, its top two logits within ``MOE_TOP2_TOL``; routing
   flips counted; (b) on {data 2, model 2} (each rank 32 experts' halves
   of the hidden dim) one wave of 4 and ``MOE_TP_NEW`` steps for each of
   ``tp_mode`` ``gather`` (the config's), ``psum``, and ``gather`` under
   profile ``sp`` (the ``gather_sp`` branch, checked on the dispatch),
   each with the launch checks, its step times printed; (d)
   ``pipeline_apply`` over {pod 4} at JAX's test shapes (4 stages of 16, 8
   microbatches of 4) and at d = 1024, within ``PIPE_TOL`` of
   ``sequential_reference`` on the card. Every run's streams must be equal
   on the four ranks, and every rank must exit 0;
12. time each kernel and its plain version with CUDA events, on the device
   (calls captured in a CUDA graph and replayed, so the host's per-call
   cost is left out) and per call from Python; the bound is the bytes over
   3.35 TB/s or the operations over their type's peak (67 TFLOP/s fp32,
   989 TFLOP/s bf16, 1,979 TOP/s int8), whichever is larger; the attention
   kernels beside one ``scaled_dot_product_attention`` call on the same
   inputs (also in bf16 at the S = 128 wave at each of the LM zoo's heads,
   and at hymba-1.5b's S = 1280 with its window and without, each beside
   its decode at C = 1024 and 1344; whisper-large-v3's encoder at S =
   1500 beside its cross decode at C = 1500, its cross-attention at Sq =
   64 beside its self decode at C = 128; llava-next-mistral-7b's S = 640
   beside its decode at C = 704; the rows' ``zoo_heads``) and the matmuls beside one ``torch.matmul`` (TF32 off) where it
   computes the same function, ``torch.mm(..., out_dtype=float32)`` for
   the bf16 cascade (timed only; the port never calls either);
   ``gru_step_fused`` and ``gru_step_blocked`` beside the column tile
   they launched before, forced at the same shapes (also phase 11's
   shapes one by one, with launches x (device - bound) both ways);
   ``gru_sequence_kernel`` beside its block route forced at the same
   shapes (its served shapes split by launches) and beside one
   ``torch.nn.GRU`` (cuDNN) call on the v3 unmasked work at T=32 B=8 H=32,
   ``gru_cascade_shard_zr`` beside its old column tile (timed only);
   ``gru_step_q8`` beside its block route forced at the same shapes (its
   served shapes split by launches), the two fused decode kernels likewise
   (their served shapes from phases 4, 5 and 11b), and
   ``gru_stack_sequence_kernel`` likewise (its served shapes from phase
   4), the two q8 prefills likewise (their served shapes from phases 5 and
   7; also at 8 slots and T 16 and 32, row 6 at H 32 and 20, row 4 at L=3
   H=32 and L=1 H=20), the two sLSTM kernels likewise (at L=1 H=20 and
   L=3 H=32, B 1, 8 and 64, the prefill at T=16, and by phase 8's served
   shapes, its prefills at their prompt bucket), and ``torch.nn.GRU``
   (cuDNN) on rows 2 and 3's v3 work over L
   layers (T=16 and the served T=32, row 2's block route beside; T=1),
   ``gru_cascade_shard_gates`` beside
   the epilogue it replaced (+ b, two slice copies, the kernel) and the
   kernel on contiguous slices, ``gru_cascade_shard_update`` beside its
   old epilogue (two adds, the kernel) and the kernel on a contiguous
   pre-activation; the served gru-jet-deep ``cuda_chain_q8`` decode step
   and its v3 twin's and its own one-rank ``cuda_sharded`` steps with
   the old route forced and the new, in turns (profiler);
   the shard kernels at the mesh path's shapes (``torch.matmul`` beside
   the matvec; each kernel's route printed); the served ``cuda_sharded``
   decode step on a one-rank mesh without a group (no collective; v1 and
   v3) beside phase 11b's meshes, split into
   the shard kernels' device time and the host time in the collectives
   (one card's: no measure of NCCL across cards); the served gru-jet-deep
   ``cuda`` and ``cuda_fused_q8`` decode steps with both fused decode
   kernels' block routes forced and with the plans, in turns old, new,
   new, old (profiler); the served slstm-jet and L=3 H=32 sLSTM decode
   steps likewise, the decode's block route (and the stacking of the state
   it needs) forced against the plan, where the warp route's step must run
   no ``aten::stack`` or ``aten::cat``; and profile a served
   decode step of gru-jet-deep through ``cuda_fused``, ``cuda_fused_q8``,
   ``cuda_chain`` and ``cuda_chain_q8``, of slstm-jet through
   ``cuda_fused``, and of qwen3-0.6b through ``attn_impl="cuda"``. The
   engine's decode-step p50/p99 come from phases 4-8 and 10 (host clock).

Then it prints one ``{"kernels": [...]}`` JSON line, the ``nvidia-smi``
line, and as the last line ``{"ok": true, "device": {...}}``. A row's
``launches`` sums the serving phases that drove it with the counters
zeroed just before: rows 1-9 phases 4-8, 8b and 8c, rows 1, 2, 4 and
6 also phase 8d (row 3's phase-11b
``backend="cuda"`` launches kept apart as ``mesh_launches``), the
attention rows phases 10, 10b, 10c, 10d and 11c (every rank's counted
runs), rows 10, 11, 19 and 20 phase 11, and the shard
rows phase 11b. Without a
card, or outside a checkout of the repository, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
FP32_FLOP_PER_S = 67e12            # H100 SXM fp32 outside the tensor cores
INT8_OP_PER_S = 1979e12            # H100 SXM int8, dense (tensor cores)
BF16_FLOP_PER_S = 989e12           # H100 SXM bf16, dense (tensor cores)
TOL = 1e-5
BF16_TOL = 2.0 ** -7               # one bf16 ulp of an output near 1
SLOTS, REQUESTS, MAX_PROMPT, MAX_NEW = 8, 12, 20, 16
KERNEL_SOURCE = {
    "gru_sequence_kernel": "src/repro_torch/csrc/gru_sequence.cu",
    "gru_stack_sequence_kernel": "src/repro_torch/csrc/gru_sequence.cu",
    "gru_stack_decode_kernel": "src/repro_torch/csrc/gru_sequence.cu",
    "gru_stack_sequence_q8_kernel": "src/repro_torch/csrc/gru_sequence_q8.cu",
    "gru_stack_decode_q8_kernel": "src/repro_torch/csrc/gru_sequence_q8.cu",
    "gru_sequence_q8_kernel": "src/repro_torch/csrc/gru_sequence_q8.cu",
    "gru_step_q8": "src/repro_torch/csrc/gru_cell_q8.cu",
    "slstm_stack_sequence_kernel": "src/repro_torch/csrc/slstm_cell.cu",
    "slstm_stack_decode_kernel": "src/repro_torch/csrc/slstm_cell.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attn.cu",
    "flash_decode": "src/repro_torch/csrc/decode_attn.cu",
    "gru_step_fused": "src/repro_torch/csrc/gru_cell.cu",
    "gru_step_blocked": "src/repro_torch/csrc/gru_cell.cu",
    "rowwise_matmul": "src/repro_torch/csrc/rowwise_matvec.cu",
    "cascade_matmul": "src/repro_torch/csrc/rowwise_matvec.cu",
    "gru_rowwise_shard_step": "src/repro_torch/csrc/gru_shard.cu",
    "gru_rowwise_shard_zr": "src/repro_torch/csrc/gru_shard.cu",
    "gru_rowwise_shard_candidate": "src/repro_torch/csrc/gru_shard.cu",
    "gru_shard_matvec": "src/repro_torch/csrc/gru_shard.cu",
    "gru_cascade_shard_gates": "src/repro_torch/csrc/gru_shard.cu",
    "gru_cascade_shard_zr": "src/repro_torch/csrc/gru_shard.cu",
    "gru_cascade_shard_update": "src/repro_torch/csrc/gru_shard.cu",
}
REPLACES = {
    "gru_sequence_kernel": "src/repro/kernels/gru_sequence/kernel.py:125",
    "gru_stack_sequence_kernel": "src/repro/kernels/gru_sequence/kernel.py:211",
    "gru_stack_decode_kernel": "src/repro/kernels/gru_sequence/kernel.py:291",
    "gru_stack_sequence_q8_kernel":
        "src/repro/kernels/gru_sequence/kernel.py:505",
    "gru_stack_decode_q8_kernel":
        "src/repro/kernels/gru_sequence/kernel.py:575",
    "gru_sequence_q8_kernel": "src/repro/kernels/gru_sequence/kernel.py:420",
    "gru_step_q8": "src/repro/kernels/gru_cell/kernel.py:179",
    "slstm_stack_sequence_kernel":
        "src/repro/kernels/slstm_cell/kernel.py:130",
    "slstm_stack_decode_kernel": "src/repro/kernels/slstm_cell/kernel.py:215",
    "flash_attention": "src/repro/kernels/flash_attn/kernel.py:81",
    "flash_decode": "src/repro/kernels/decode_attn/kernel.py:59",
    "gru_step_fused": "src/repro/kernels/gru_cell/kernel.py:58",
    "gru_step_blocked": "src/repro/kernels/gru_cell/kernel.py:105",
    "rowwise_matmul": "src/repro/kernels/rowwise_matvec/kernel.py:37",
    "cascade_matmul": "src/repro/kernels/rowwise_matvec/kernel.py:74",
    "gru_rowwise_shard_step": "src/repro/kernels/gru_sequence/kernel.py:702",
    "gru_rowwise_shard_zr": "src/repro/kernels/gru_sequence/kernel.py:714",
    "gru_rowwise_shard_candidate":
        "src/repro/kernels/gru_sequence/kernel.py:723",
    "gru_shard_matvec": "src/repro/kernels/gru_sequence/kernel.py:733",
    "gru_cascade_shard_gates": "src/repro/kernels/gru_sequence/kernel.py:741",
    "gru_cascade_shard_zr": "src/repro/kernels/gru_sequence/kernel.py:749",
    "gru_cascade_shard_update":
        "src/repro/kernels/gru_sequence/kernel.py:759",
}
Q8 = ("gru_stack_sequence_q8_kernel", "gru_stack_decode_q8_kernel",
      "gru_sequence_q8_kernel", "gru_step_q8")
DECODE = ("gru_stack_decode_kernel", "gru_stack_decode_q8_kernel",
          "gru_step_q8", "slstm_stack_decode_kernel")
STEP_TOO = ("gru_sequence_kernel",)  # also at T=1 unmasked: chain decode
CHAIN_Q8 = ("gru_sequence_q8_kernel", "gru_step_q8")
SLSTM = ("slstm_stack_sequence_kernel", "slstm_stack_decode_kernel")
ATTN = ("flash_attention", "flash_decode")
ROWWISE = ("gru_step_fused", "gru_step_blocked", "rowwise_matmul",
           "cascade_matmul")
SHARD = ("gru_rowwise_shard_step", "gru_rowwise_shard_zr",
         "gru_rowwise_shard_candidate", "gru_shard_matvec",
         "gru_cascade_shard_gates", "gru_cascade_shard_zr",
         "gru_cascade_shard_update")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def device_info(torch):
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {kind} (count {count}); torch {torch.__version__} "
          f"cuda {torch.version.cuda}; tf32 off", flush=True)
    return kind, count, smi_line


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------

def build_kernels():
    from repro_torch.kernels import _build
    from repro_torch.kernels.gru_sequence import kernel as K
    t0 = time.monotonic()
    paths = _build.build()
    print(f"built {sorted(paths)} in {time.monotonic() - t0:.1f} s (nvcc "
          f"wall seconds each, in parallel: "
          f"{ {n: round(t, 1) for n, t in _build.BUILD_SECONDS.items()} })",
          flush=True)
    for name in paths:
        for line in _build.build_log(name).splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling",
                                       "smem")):
                print(f"  ptxas[{name}]: {line.strip()}")
    frames = spill_frames("gru_shard")
    spills = [f for f, ln in frames if not no_spill(ln)]
    check(frames and not spills, f"gru_shard: ptxas reports spills in "
          f"{spills[:3]}")
    check(any("cascade_update_k" in f for f, _ in frames), "gru_shard: "
          "ptxas reports no row 18 kernel (cascade_update_k)")
    print(f"  gru_shard: {len(frames)} functions (row 16's cascade_gates_k "
          f"and row 18's cascade_update_k among them), no spills (ptxas)")
    # row 1's two routes (the block route's kernel, gru_sequence_k, and
    # every gru_sequence_warp_k instance)
    frames = [(f, ln) for f, ln in spill_frames("gru_sequence")
              if "gru_sequence_warp_k" in f or "14gru_sequence_k" in f]
    spills = [f for f, ln in frames if not no_spill(ln)]
    check(len(frames) > 1 and not spills, f"gru_sequence: ptxas reports "
          f"spills in row 1's kernels {spills[:3]}")
    print(f"  gru_sequence: row 1's {len(frames)} functions (block route "
          f"and warp route instances), no spills (ptxas)")
    # row 7's warp route: its four instances (v1/v3, word/byte loads)
    frames = [(f, ln) for f, ln in spill_frames("gru_cell_q8")
              if "gru_step_q8_warp_k" in f]
    spills = [f for f, ln in frames if not no_spill(ln)]
    check(len(frames) == 4 and not spills, f"gru_cell_q8: ptxas reports "
          f"spills in row 7's warp route {spills[:3]} ({len(frames)} "
          f"instances)")
    print(f"  gru_cell_q8: row 7's {len(frames)} warp-route instances, no "
          f"spills (ptxas)")
    # rows 3 and 5's warp routes: the fp32 instances (v1/v3, H 20, 32 or
    # any) and the q8 ones (v1/v3, word/cover loads, one layer or three);
    # row 2's warp route: v1/v3, H 32 or any; rows 6 and 4's: v1/v3,
    # word/cover loads
    for lib, fn, want in (("gru_sequence", "gru_stack_decode_warp_k", 6),
                          ("gru_sequence_q8", "gru_stack_decode_q8_warp_k",
                           8),
                          ("gru_sequence", "gru_stack_sequence_warp_k",
                           4),
                          ("gru_sequence_q8", "gru_sequence_q8_warp_k", 4),
                          ("gru_sequence_q8", "gru_stack_sequence_q8_warp_k",
                           4)):
        frames = [(f, ln) for f, ln in spill_frames(lib) if fn in f]
        spills = [f for f, ln in frames if not no_spill(ln)]
        check(len(frames) == want and not spills, f"{lib}: ptxas reports "
              f"spills in {fn} {spills[:3]} ({len(frames)} instances)")
        print(f"  {lib}: {fn}'s {len(frames)} instances, no spills (ptxas)")
    # rows 10 and 11's new routes: the warp route's instances (v1/v3, H 20,
    # 32 or any, fp32/bf16 u) and the wide route's (1, 2, 4 or 8 rows a
    # pass; 4, 8 or 16 columns a gate; fp32/bf16 u)
    for fn, want in (("gru_step_warp_k", 12), ("gru_step_wide_k", 24)):
        frames = [(f, ln) for f, ln in spill_frames("gru_cell") if fn in f]
        spills = [f for f, ln in frames if not no_spill(ln)]
        check(len(frames) == want and not spills, f"gru_cell: ptxas reports "
              f"spills in {fn} {spills[:3]} ({len(frames)} instances)")
        regs = [n for f, n in register_counts("gru_cell") if fn in f]
        print(f"  gru_cell: {fn}'s {len(frames)} instances, no spills "
              f"(ptxas), {min(regs)}-{max(regs)} registers")
    # rows 9 and 8's warp route (one kernel, the decode its T = 1): its
    # instances (H 20, 32 or any), their registers by instance; no stack
    # frame either (its table of leaf pointers is read in place)
    fn = "slstm_stack_warp_k"
    frames = [(f, ln) for f, ln in spill_frames("slstm_cell") if fn in f]
    spills = [f for f, ln in frames if not re.search(
        r"\b0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        ln)]
    check(len(frames) == 3 and not spills, f"slstm_cell: ptxas reports "
          f"a stack frame or spills in {fn} {spills[:3]} ({len(frames)} "
          f"instances)")
    regs = [n for f, n in register_counts("slstm_cell") if fn in f]
    print(f"  slstm_cell: {fn}'s {len(frames)} instances, no spills "
          f"(ptxas), registers by instance {regs}")
    # the registers of the prefill warp routes (row 2's speed hangs on
    # ptxas's choice: 147 and 158 at H=32 where it was timed; PERF.md)
    for lib, fn in (("gru_sequence", "gru_stack_sequence_warp_k"),
                    ("gru_sequence_q8", "gru_stack_sequence_q8_warp_k"),
                    ("gru_sequence_q8", "gru_sequence_q8_warp_k")):
        print(f"  {lib}: {fn} registers by instance: "
              f"{[n for f, n in register_counts(lib) if fn in f]}")
    # all shared memory but row 2's warp route's slots (static, 3.75 KB a
    # block, in ptxas's report above) is dynamic, so ptxas does not report
    # it
    from repro_torch.kernels.gru_cell import kernel as CK
    from repro_torch.kernels.slstm_cell import kernel as SK
    bt = K.DEFAULT_BATCH_BLOCK
    for cfg_name, L, H in (("gru-jet", 1, 20), ("gru-jet-deep", 3, 32)):
        print(f"  dynamic shared memory per block, {cfg_name} (L={L} H={H}, "
              f"{bt}-row tile): {K.smem_bytes(L, H, bt)} bytes fp32, "
              f"{K.smem_bytes_q8(L, H, bt)} bytes q8; one chain layer: "
              f"{K.smem_bytes(1, H, bt)} fp32, "
              f"{K.smem_bytes_seq_q8(H, bt)} q8 sequence, "
              f"{CK.smem_bytes_step_q8(H, bt)} q8 step "
              f"(limit {K.SMEM_LIMIT})")
    for cfg_name, L, H in (("slstm-jet", 1, 20), ("slstm L=3 H=32", 3, 32)):
        print(f"  dynamic shared memory per block, {cfg_name} ({bt}-row "
              f"tile): {SK.smem_bytes(L, H, bt)} bytes, both sLSTM kernels "
              f"(limit {K.SMEM_LIMIT})")
    import ctypes
    from repro_torch.kernels.decode_attn import kernel as DK
    from repro_torch.kernels.flash_attn import kernel as FK
    fa = _build.load("flash_attn").flash_attention_smem_bytes
    fd = _build.load("decode_attn").flash_decode_smem_bytes
    fa.argtypes = [ctypes.c_int] * 2
    fd.argtypes = [ctypes.c_int] * 2
    import torch
    for bf16, dt in ((0, torch.float32), (1, torch.bfloat16)):
        for D in (16, 18, 64, 65, 128):
            check(fa(D, bf16) == FK.smem_bytes(D, dt), f"flash_attention "
                  f"smem {dt} D={D}: CUDA {fa(D, bf16)} != wrapper "
                  f"{FK.smem_bytes(D, dt)}")
            check(fd(D, bf16) == DK.smem_bytes(D, dt), f"flash_decode smem "
                  f"{dt} D={D}: CUDA {fd(D, bf16)} != wrapper "
                  f"{DK.smem_bytes(D, dt)}")
    b16, f32 = torch.bfloat16, torch.float32
    print(f"  dynamic shared memory per block, qwen3-0.6b heads (D=128, "
          f"G=2): flash_attention {FK.smem_bytes(128, b16)} bytes bf16 (64 "
          f"query rows, 2 stages of 64 keys), "
          f"{FK.smem_bytes(128, f32)} fp32 (32 rows, 64 keys); "
          f"flash_decode {DK.smem_bytes(128, b16)} bytes bf16 (3 stages of "
          f"64 slots), {DK.smem_bytes(128, f32)} fp32 (3 stages) (limit "
          f"{K.SMEM_LIMIT}); CUDA sources agree")
    sass = _build.sass("flash_attn")
    hgmma = {name: body.count("HGMMA") for name, body in sass.items()}
    tc = {n: c for n, c in hgmma.items() if "flash_attention_tc" in n}
    check(len(tc) == 2 and all(tc.values()), f"flash_attention bf16: no "
          f"tensor-core (HGMMA) instructions in its SASS: {hgmma}")
    print(f"  flash_attention bf16 kernels on the tensor cores: HGMMA "
          f"instructions in the SASS {sorted(tc.values())} (D <= 64, "
          f"D <= 128); fp32 kernel "
          f"{sum(c for n, c in hgmma.items() if n not in tc)}", flush=True)
    from repro_torch.kernels.rowwise_matvec import kernel as MK
    gs = _build.load("gru_cell").gru_cell_smem_bytes
    ms = _build.load("rowwise_matvec").rowwise_smem_bytes
    gs.argtypes, ms.argtypes = [ctypes.c_int] * 4, [ctypes.c_int] * 8
    gs.restype = ms.restype = ctypes.c_size_t
    ws = _build.load("gru_cell").gru_step_wide_smem_bytes
    ws.argtypes, ws.restype = [ctypes.c_int] * 6, ctypes.c_size_t
    for bf16, dt in ((0, torch.float32), (1, torch.bfloat16)):
        for H in (20, 1000, 1001, 2048):
            for bt, cw, kc, st in ((1, 4, 128, 2), (8, 8, 512, 3),
                                   (4, 16, 1024, 32)):
                want = CK.wide_smem(H, bt, cw, kc, st, dt)
                check(ws(H, bt, cw, kc, st, bf16) == want, f"gru_cell wide "
                      f"smem H={H} bt={bt} cw={cw} kc={kc} stages={st} {dt}: "
                      f"CUDA {ws(H, bt, cw, kc, st, bf16)} != wrapper {want}")
    for code, kind in enumerate(("v1", "v3", "blocked")):
        for H in (20, 32, 1000, 1024, 2048):
            for bt in (1, 2, 4, 8):
                for ct in (8, 16, 32):
                    want = CK.smem_bytes_step(kind, H, bt, ct)
                    check(gs(code, H, bt, ct) == want, f"gru_cell smem "
                          f"{kind} H={H} bt={bt} ct={ct}: CUDA "
                          f"{gs(code, H, bt, ct)} != wrapper {want}")
    for bf16, dt in ((0, torch.float32), (1, torch.bfloat16)):
        for B, K_, bk in ((1, 32, 32), (3, 1000, 8), (4, 3072, 512),
                          (8, 3072, 3072), (12, 384, 96)):
            for ct in MK.COLUMN_TILES:
                for warps in (1, 4, 8):
                    kc = MK.stage_rows(dt, bk)
                    for stages in (1, 8, 48):
                        want = MK.smem_bytes(dt, B, K_, bk, ct, kc, stages,
                                             warps)
                        got = ms(bf16, B, K_, bk, ct, kc, stages, warps)
                        check(got == want, f"rowwise_matvec smem {dt} B={B} "
                              f"K={K_} bk={bk} ct={ct} warps={warps} "
                              f"stages={stages}: CUDA {got} != wrapper {want}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dt in (torch.bfloat16, torch.float32):
        for K_, N in ((1024, 3072), (3072, 1024)):
            x, w = (torch.empty(4, K_, dtype=dt, device="cuda"),
                    torch.empty(K_, N, dtype=dt, device="cuda"))
            print(f"  rowwise/cascade plan B=4 K={K_} N={N} {dt}: "
                  f"{MK.plan(x, w, K_, sms)}")
    print(f"  dynamic shared memory per block, gru_step_fused v1 H=32 8 rows:"
          f" {CK.smem_bytes_step('v1', 32, 8, 32)} bytes; "
          f"gru_step_blocked H=2048 8 rows: "
          f"{CK.smem_bytes_step('blocked', 2048, 8, 8)} bytes; CUDA sources "
          f"agree", flush=True)
    sass = _build.sass("rowwise_matvec")
    hmma = {name: body.count("HMMA") for name, body in sass.items()
            if "matmul_k" in name}
    bf16_k = {n: c for n, c in hmma.items() if "nv_bfloat16" in n}
    check(len(bf16_k) == 8 and all(bf16_k.values()), f"rowwise/cascade "
          f"bf16: no tensor-core (HMMA) instructions in its SASS: {hmma}")
    check(not any(c for n, c in hmma.items() if n not in bf16_k),
          f"rowwise/cascade fp32 kernels issue HMMA: {hmma}")
    print(f"  rowwise/cascade bf16 kernels on the tensor cores: HMMA "
          f"instructions in the SASS of all {len(bf16_k)} "
          f"({sorted(bf16_k.values())}); fp32 kernels "
          f"{len(hmma) - len(bf16_k)}, none", flush=True)


def spill_frames(library):
    """(function, ptxas's stack/spill line) of each kernel of ``library``'s
    build log."""
    from repro_torch.kernels import _build
    out, fn = [], None
    for ln in _build.build_log(library).splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1]
        elif "spill stores" in ln and fn is not None:
            out.append((fn, ln.strip()))
            fn = None
    return out


def register_counts(library):
    """(function, registers a thread) of each kernel of ``library``'s build
    log, from ptxas's "Used N registers" line."""
    from repro_torch.kernels import _build
    out, fn = [], None
    for ln in _build.build_log(library).splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1]
        elif "Used" in ln and "registers" in ln and fn is not None:
            out.append((fn, int(ln.split("Used")[1].split()[0])))
            fn = None
    return out


def no_spill(line) -> bool:
    return "0 bytes spill stores, 0 bytes spill loads" in line


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------

def make_inputs(torch, L, H, B, T, seed, dev):
    from repro_torch.core.params import quantize_gru_cells
    g = torch.Generator().manual_seed(seed)

    def rand(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g)).to(dev)
    mask = torch.ones(T, B)
    lens = torch.randint(1, T + 1, (B,), generator=g)
    for i in range(B):                      # left padding, as the engine
        mask[: T - int(lens[i]), i] = 0.0
    a = dict(
        h0=rand(L, B, H, scale=0.5), xp=rand(T, B, 3 * H),
        u=rand(L, H, 3 * H, scale=H ** -0.5),
        wd=(rand(L - 1, H, 3 * H, scale=H ** -0.5) if L > 1
            else torch.zeros(1, 1, 3 * H, device=dev)),
        b=rand(L, 3 * H, scale=0.3), mask=mask.to(dev))
    # the q8 kernels' int8 views of the same weights, quantized on the card
    st = quantize_gru_cells(
        [{"w": a["wd"][max(l - 1, 0)], "u": a["u"][l], "b": a["b"][l]}
         for l in range(L)]).stacked
    a["q8"] = tuple(st[k] for k in ("u_q", "u_eff", "wd_q", "wd_eff", "b"))
    return a


def make_slstm_inputs(torch, L, H, B, T, seed, dev):
    """The sLSTM kernels' operands: a mid-sequence state (n > 0) with row
    0 at the engine's initial state (c = n = h = 0, m = M_INIT), and a
    ragged left-padded (T,B) mask whose row 0 is fully masked when B > 1
    (an empty slot), so its leaves must come out bit for bit."""
    from repro_torch.core.slstm import M_INIT
    g = torch.Generator().manual_seed(seed)

    def rand(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g)
    leaves = [rand(L, B, H, scale=0.5), rand(L, B, H).abs() + 0.5,
              rand(L, B, H), rand(L, B, H, scale=0.5)]
    for k, v in enumerate((0.0, 0.0, M_INIT, 0.0)):
        leaves[k][:, 0] = v
    mask = torch.ones(T, B)
    lens = torch.randint(1, T + 1, (B,), generator=g)
    for i in range(B):
        mask[: T - int(lens[i]), i] = 0.0
    if B > 1:
        mask[:, 0] = 0.0
    leaves = [x.to(dev) for x in leaves]
    return dict(leaves=leaves, h0=leaves[3], xp=rand(T, B, 4 * H).to(dev),
                u=rand(L, H, 4 * H, scale=H ** -0.5).to(dev),
                wd=(rand(L - 1, H, 4 * H, scale=H ** -0.5) if L > 1
                    else torch.zeros(1, 1, 4 * H)).to(dev),
                b=rand(L, 4 * H, scale=0.3).to(dev), mask=mask.to(dev))


def run_slstm_kernel(name, a, masked, plain):
    from repro_torch.kernels.slstm_cell import kernel as SK
    from repro_torch.kernels.slstm_cell import ref as sref
    w = (a["u"], a["wd"], a["b"])
    if name == "slstm_stack_decode_kernel":
        args = (*a["leaves"], a["xp"][0], *w)
        if plain:
            return sref.slstm_stack_decode_ref(*args)
        return SK.slstm_stack_decode_kernel(*args)
    args = (*a["leaves"], a["xp"], *w, a["mask"] if masked else None)
    if plain:
        return sref.slstm_stack_sequence_ref(*args)
    return SK.slstm_stack_sequence_kernel(*args)


def slstm_route_fn(torch, name, a, masked, plan):
    """A call of sLSTM kernel ``name`` on ``a`` (:func:`make_slstm_inputs`)
    at an explicit plan (``kernel.warp_plan`` or ``block_plan``) through
    ``kernel.launch_decode`` / ``launch_sequence``, into fresh outputs:
    the route forced, for phase 3's check of both routes, the before/after
    times of phase 12 and ``tools/slstm_tiles.py``. Reads the current
    stream at each call, so a CUDA-graph capture records it; raises if the
    launch is refused."""
    from repro_torch.kernels.slstm_cell import kernel as SK
    w = (a["u"], a["wd"], a["b"])
    if name == "slstm_stack_decode_kernel":
        args = (*a["leaves"], a["xp"][0], *w)
        return lambda: SK.launch_decode(plan, *args)
    args = (*a["leaves"], a["xp"], *w, a["mask"] if masked else None)
    return lambda: SK.launch_sequence(plan, *args)


def slstm_routes(torch, name, a, masked):
    """For sLSTM kernel ``name`` on ``a``: the launch its plan names, and a
    call of its block route forced at the tile the wrapper gave it before
    the warp routes (``min(B, DEFAULT_BATCH_BLOCK)`` rows)."""
    from repro_torch.kernels import _launch
    from repro_torch.kernels.slstm_cell import kernel as SK
    L, B, H = a["leaves"][3].shape
    T = a["xp"].shape[0]
    plan = (SK.slstm_decode_plan(B, H, L)
            if name == "slstm_stack_decode_kernel"
            else SK.slstm_stack_seq_plan(B, T, H, L))
    blk = SK.block_plan(B, H, L, min(B, _launch.DEFAULT_BATCH_BLOCK))
    return plan, slstm_route_fn(torch, name, a, masked, blk)


def run_kernel(K, ref, name, a, variant, masked, plain):
    from repro_torch.kernels.gru_cell import kernel as CK
    from repro_torch.kernels.gru_cell import ref as cref
    if name in SLSTM:
        return run_slstm_kernel(name, a, masked, plain)
    m = a["mask"] if masked else None
    if name in CHAIN_Q8:              # one layer's own int8 rows (L = 1)
        u_q, u_eff, _, _, b = (x[0] for x in a["q8"])
        if name == "gru_step_q8":
            args = q8_step_args(a)
            if plain:
                return (cref.gru_step_q8_ref(*args, variant),)
            return (CK.gru_step_q8(*args, variant=variant),)
        args = (a["h0"][0], a["xp"], u_q, u_eff, b, m)
        if plain:
            return (ref.gru_sequence_q8_ref(*args, variant),)
        return (K.gru_sequence_q8_kernel(*args, variant=variant),)
    if name == "gru_sequence_kernel":
        args = (a["h0"][0], a["xp"], a["u"][0], a["b"][0], m)
        if plain:
            return (ref.gru_sequence_ref(*args, variant),)
        return (K.gru_sequence_kernel(*args, variant=variant),)
    if name == "gru_stack_sequence_kernel":
        args = (a["h0"], a["xp"], a["u"], a["wd"], a["b"], m)
        if plain:
            return ref.gru_stack_sequence_ref(*args, variant)
        return K.gru_stack_sequence_kernel(*args, variant=variant)
    if name == "gru_stack_sequence_q8_kernel":
        args = (a["h0"], a["xp"], *a["q8"], m)
        if plain:
            return ref.gru_stack_sequence_q8_ref(*args, variant)
        return K.gru_stack_sequence_q8_kernel(*args, variant=variant)
    if name == "gru_stack_decode_q8_kernel":
        args = (a["h0"], a["xp"][0], *a["q8"])
        if plain:
            return (ref.gru_stack_decode_q8_ref(*args, variant),)
        return (K.gru_stack_decode_q8_kernel(*args, variant=variant),)
    args = (a["h0"], a["xp"][0], a["u"], a["wd"], a["b"])
    if plain:
        return (ref.gru_stack_decode_ref(*args, variant),)
    return (K.gru_stack_decode_kernel(*args, variant=variant),)


BOTH = [(1, 20), (3, 32)]
MAIN_SHAPES = {                    # kernel -> (L, H) on the main path
    "gru_sequence_kernel": [(1, 20), (1, 32)],   # gru-jet; chain layers
    "gru_stack_sequence_kernel": [(3, 32)],      # gru-jet-deep prefill
    "gru_stack_decode_kernel": BOTH,             # both configs' decode
    "gru_stack_sequence_q8_kernel": BOTH,        # both configs' q8 prefill
    "gru_stack_decode_q8_kernel": BOTH,          # both configs' q8 decode
    "gru_sequence_q8_kernel": [(1, 20), (1, 32)],  # q8 chain prefill layers
    "gru_step_q8": [(1, 20), (1, 32)],             # q8 chain decode layers
    "slstm_stack_sequence_kernel": BOTH,         # slstm-jet; L=3 H=32
    "slstm_stack_decode_kernel": BOTH,
}


def inputs_for(torch, name, L, H, B, T, seed, dev):
    if name in SLSTM:
        return make_slstm_inputs(torch, L, H, B, T, seed, dev)
    return make_inputs(torch, L, H, B, T, seed, dev)


def seq_route_fn(torch, a, variant, masked, plan):
    """A call of the depth-1 sequence kernel's C entry on ``a`` (the L = 1
    operands of :func:`make_inputs`) at an explicit plan
    (``kernel.warp_plan`` or ``kernel.block_plan``): the route forced, for
    phase 3's check of both routes and the before/after times of phase 12
    and ``tools/seq_tiles.py``. Reads the current stream at each call, so a
    CUDA-graph capture records it; raises if the launch is refused."""
    from repro_torch.kernels import _launch
    from repro_torch.kernels.gru_sequence import kernel as K
    h0, xp, u, b = a["h0"][0], a["xp"], a["u"][0], a["b"][0]
    T, B, H = xp.shape[0], xp.shape[1], h0.shape[1]
    out = torch.empty(T, B, H, device=xp.device)
    head = (h0.data_ptr(), xp.data_ptr(), u.data_ptr(), b.data_ptr(),
            a["mask"].data_ptr() if masked else None, out.data_ptr(), T, B,
            H, int(variant == "v3"))
    if plan.route == "warp":
        fn = K._launcher("gru_sequence_warp_launch")
        tail = (plan.rows, plan.warps, plan.depth)
    else:
        fn = K._launcher("gru_sequence_launch")
        tail = (plan.rows,)

    def call():
        _launch.raise_on(fn(*head, *tail, _launch.stream(xp.device)),
                         f"gru_sequence forced {plan}")
        return out
    return call


def block_route(K, B, H):
    """The block route (``run_stack``) at the tile the wrapper gave it
    before the warp route: ``min(B, DEFAULT_BATCH_BLOCK)`` rows."""
    return K.block_plan(B, H, min(B, K.DEFAULT_BATCH_BLOCK))


def step_q8_route_fn(torch, step, variant, plan, vec=None):
    """A call of the q8 step's C entry on ``step`` (h, xp, u_q, u_eff, b) at
    an explicit plan (``kernel.step_q8_warp_plan`` or
    ``kernel.step_q8_block_plan``; ``vec``: the warp route's word loads of
    U, None for the wrapper's choice), into a fresh output: the route
    forced, for phase 3's check of both routes, the before/after times of
    phase 12 and ``tools/step_q8_tiles.py``. Reads the current stream at
    each call, so a CUDA-graph capture records it; raises if the launch is
    refused."""
    from repro_torch.kernels import _launch
    from repro_torch.kernels.gru_cell import kernel as CK
    h, xp, u_q, u_eff, b = step
    B, H = h.shape
    out = torch.empty(B, H, device=h.device)
    head = (h.data_ptr(), xp.data_ptr(), u_q.data_ptr(), u_eff.data_ptr(),
            b.data_ptr(), out.data_ptr(), B, H, int(variant == "v3"))
    if plan.route == "warp":
        fn = _launch.launcher("gru_cell_q8", "gru_step_q8_warp_launch",
                              CK._WARP_ARGS)
        tail = (plan.warps, CK.q8_words(H, u_q) if vec is None else vec)
    else:
        fn = _launch.launcher("gru_cell_q8", "gru_step_q8_launch",
                              CK._ARGTYPES)
        tail = (plan.rows,)

    def call():
        _launch.raise_on(fn(*head, *tail, _launch.stream(h.device)),
                         f"gru_step_q8 forced {plan}")
        return out
    return call


def step_q8_block_route(B, H):
    """The q8 step's block route at the tile the wrapper gave it before the
    warp route: ``min(B, DEFAULT_BATCH_BLOCK)`` rows."""
    from repro_torch.kernels import _launch
    from repro_torch.kernels.gru_cell import kernel as CK
    return CK.step_q8_block_plan(B, H, min(B, _launch.DEFAULT_BATCH_BLOCK))


def step_route_fn(torch, step, variant, plan, blocked=False):
    """A call of the fp32/bf16 step's C entries on ``step`` (h, xp, u, b)
    at an explicit plan (``kernel.warp_step_plan``, ``wide_step_plan`` or
    ``tile_step_plan``; ``blocked``: the blocked step's order of additions
    and, on the tile route, its two kernels), into a fresh output: the
    route forced, for phase 11's check of both routes, the before/after
    times of phase 12 and ``tools/step_tiles.py``. Reads the current stream
    at each call, so a CUDA-graph capture records it; raises if the launch
    is refused."""
    from repro_torch.kernels.gru_cell import kernel as CK

    def call():
        return CK.launch_step(plan, *step, variant, blocked)
    return call


def step_old_route(B, H, variant, u_dtype, kernel):
    """The column-tile route each step kernel launched before the warp and
    wide routes (``kernel.tile_step_plan``)."""
    from repro_torch.kernels.gru_cell import kernel as CK
    kind = "blocked" if kernel == "gru_step_blocked" else variant
    return CK.tile_step_plan(kind, B, H, u_dtype)


def decode_route_fn(torch, a, variant, plan, q8=False, vec=None):
    """A call of a fused decode kernel's C entry on ``a`` (the operands of
    :func:`make_inputs`: h0, xp's first step, u, wd, b; q8: the int8 rows
    of ``a["q8"]``) at an explicit plan (``kernel.decode_warp_plan`` or
    ``kernel.decode_block_plan``; ``vec``: the q8 warp route's word loads,
    None for the wrapper's choice), into a fresh output: the route forced,
    for phase 3's check of both routes, the before/after times of phase 12
    and ``tools/decode_tiles.py``. Reads the current stream at each call,
    so a CUDA-graph capture records it; raises if the launch is refused."""
    from repro_torch.kernels import _launch
    from repro_torch.kernels.gru_sequence import kernel as K
    h, xp = a["h0"], a["xp"][0]
    L, B, H = h.shape
    out = torch.empty(L, B, H, device=h.device)
    ws = a["q8"] if q8 else (a["u"], a["wd"], a["b"])
    head = (h.data_ptr(), xp.data_ptr(), *(w.data_ptr() for w in ws),
            out.data_ptr(), B, H, L, int(variant == "v3"))
    name = "gru_stack_decode_q8" if q8 else "gru_stack_decode"
    if plan.route == "warp":
        fn = K._launcher(f"{name}_warp_launch")
        tail = (plan.warps,) + ((K.decode_q8_words(H, ws[0], ws[2])
                                 if vec is None else vec,) if q8 else ())
    else:
        fn = K._launcher(f"{name}_launch")
        tail = (plan.rows,)

    def call():
        _launch.raise_on(fn(*head, *tail, _launch.stream(h.device)),
                         f"{name} forced {plan}")
        return out
    return call


def decode_block_route(K, B, H, L, q8=False):
    """A fused decode kernel's block route at the tile the wrapper gave it
    before the warp route: ``min(B, DEFAULT_BATCH_BLOCK)`` rows."""
    return K.decode_block_plan(B, H, L, min(B, K.DEFAULT_BATCH_BLOCK), q8)


def stack_route_fn(torch, a, variant, masked, plan):
    """A call of the fused prefill's C entry on ``a`` (the operands of
    :func:`make_inputs`) at an explicit plan (``kernel.stack_seq_warp_plan``
    or ``kernel.stack_seq_block_plan``), into fresh outputs: the route
    forced, for phase 3's check of both routes, the before/after times of
    phase 12 and ``tools/stack_seq_tiles.py``. Reads the current stream at
    each call, so a CUDA-graph capture records it; raises if the launch is
    refused."""
    from repro_torch.kernels import _launch
    from repro_torch.kernels.gru_sequence import kernel as K
    h0, xp = a["h0"], a["xp"]
    L, B, H = h0.shape
    T = xp.shape[0]
    out = torch.empty(T, B, H, device=xp.device)
    finals = torch.empty(L, B, H, device=xp.device)
    head = (h0.data_ptr(), xp.data_ptr(), a["u"].data_ptr(),
            a["wd"].data_ptr(), a["b"].data_ptr(),
            a["mask"].data_ptr() if masked else None, out.data_ptr(),
            finals.data_ptr(), T, B, H, L, int(variant == "v3"))
    if plan.route == "warp":
        fn = K._launcher("gru_stack_sequence_warp_launch")
        tail = ()
    else:
        fn = K._launcher("gru_stack_sequence_launch")
        tail = (plan.rows,)

    def call():
        _launch.raise_on(fn(*head, *tail, _launch.stream(xp.device)),
                         f"gru_stack_sequence forced {plan}")
        return out, finals
    return call


def stack_block_route(K, B, H, L):
    """The fused prefill's block route at the tile the wrapper gave it
    before the warp route: ``min(B, DEFAULT_BATCH_BLOCK)`` rows."""
    return K.stack_seq_block_plan(B, H, L, min(B, K.DEFAULT_BATCH_BLOCK))


def seq_q8_route_fn(torch, a, variant, masked, plan, vec=None):
    """A call of the depth-1 q8 sequence's C entry on ``a`` (the L = 1
    operands of :func:`make_inputs`, the layer's int8 rows) at an explicit
    plan (``kernel.warp_plan`` or ``kernel.block_plan(..., q8=True)``;
    ``vec``: the warp route's word loads of U, None for the wrapper's
    choice), into a fresh output: the route forced, for phase 3's check of
    both routes, the before/after times of phase 12 and
    ``tools/seq_q8_tiles.py``. Reads the current stream at each call, so a
    CUDA-graph capture records it; raises if the launch is refused."""
    from repro_torch.kernels import _launch
    from repro_torch.kernels.gru_sequence import kernel as K
    h0, xp = a["h0"][0], a["xp"]
    u_q, u_eff, _, _, b = (x[0] for x in a["q8"])
    T, B, H = xp.shape[0], xp.shape[1], h0.shape[1]
    out = torch.empty(T, B, H, device=xp.device)
    head = (h0.data_ptr(), xp.data_ptr(), u_q.data_ptr(), u_eff.data_ptr(),
            b.data_ptr(), a["mask"].data_ptr() if masked else None,
            out.data_ptr(), T, B, H, int(variant == "v3"))
    if plan.route == "warp":
        fn = K._launcher("gru_sequence_q8_warp_launch")
        tail = (plan.warps, K.q8_words(H, u_q) if vec is None else vec)
    else:
        fn = K._launcher("gru_sequence_q8_launch")
        tail = (plan.rows,)

    def call():
        _launch.raise_on(fn(*head, *tail, _launch.stream(xp.device)),
                         f"gru_sequence_q8 forced {plan}")
        return out
    return call


def seq_q8_block_route(K, B, H):
    """The depth-1 q8 sequence's block route at the tile the wrapper gave
    it before the warp route: ``min(B, DEFAULT_BATCH_BLOCK)`` rows."""
    return K.block_plan(B, H, min(B, K.DEFAULT_BATCH_BLOCK), q8=True)


def stack_q8_route_fn(torch, a, variant, masked, plan, vec=None):
    """A call of the fused q8 prefill's C entry on ``a`` (the operands of
    :func:`make_inputs`, its int8 rows ``a["q8"]``) at an explicit plan
    (``kernel.stack_seq_warp_plan`` or ``kernel.stack_seq_block_plan(...,
    q8=True)``; ``vec``: the warp route's word loads, None for the
    wrapper's choice), into fresh outputs: the route forced, as
    :func:`stack_route_fn` forces row 2's."""
    from repro_torch.kernels import _launch
    from repro_torch.kernels.gru_sequence import kernel as K
    h0, xp = a["h0"], a["xp"]
    L, B, H = h0.shape
    T = xp.shape[0]
    out = torch.empty(T, B, H, device=xp.device)
    finals = torch.empty(L, B, H, device=xp.device)
    q = a["q8"]
    head = (h0.data_ptr(), xp.data_ptr(), *(w.data_ptr() for w in q),
            a["mask"].data_ptr() if masked else None, out.data_ptr(),
            finals.data_ptr(), T, B, H, L, int(variant == "v3"))
    if plan.route == "warp":
        fn = K._launcher("gru_stack_sequence_q8_warp_launch")
        tail = (K.decode_q8_words(H, q[0], q[2]) if vec is None else vec,)
    else:
        fn = K._launcher("gru_stack_sequence_q8_launch")
        tail = (plan.rows,)

    def call():
        _launch.raise_on(fn(*head, *tail, _launch.stream(xp.device)),
                         f"gru_stack_sequence_q8 forced {plan}")
        return out, finals
    return call


def stack_q8_block_route(K, B, H, L):
    """The fused q8 prefill's block route at the tile the wrapper gave it
    before the warp route: ``min(B, DEFAULT_BATCH_BLOCK)`` rows."""
    return K.stack_seq_block_plan(B, H, L, min(B, K.DEFAULT_BATCH_BLOCK),
                                  q8=True)


# the prefill kernels with a warp route and a block route: rows 2, 4 and 6
PREFILLS = ("gru_stack_sequence_kernel", "gru_stack_sequence_q8_kernel",
            "gru_sequence_q8_kernel")


def prefill_routes(torch, K, name, a, variant, masked):
    """For prefill kernel ``name`` (:data:`PREFILLS`) on ``a``: the launch its
    plan names, and a call of its block route forced at the tile the
    wrapper gave it before the warp route (returning the kernel's outputs
    as a tuple)."""
    L, B, H = a["h0"].shape
    T = a["xp"].shape[0]
    if name == "gru_stack_sequence_kernel":
        return (K.stack_seq_plan(B, T, H, L, variant), stack_route_fn(
            torch, a, variant, masked, stack_block_route(K, B, H, L)))
    if name == "gru_stack_sequence_q8_kernel":
        return (K.stack_seq_q8_plan(B, T, H, L, variant), stack_q8_route_fn(
            torch, a, variant, masked, stack_q8_block_route(K, B, H, L)))
    call = seq_q8_route_fn(torch, a, variant, masked,
                           seq_q8_block_route(K, B, H))
    return K.seq_q8_plan(B, T, H, variant), lambda: (call(),)


def q8_step_args(a):
    """The q8 step's operands from :func:`make_inputs` (L = 1): h, xp of the
    first step, the layer's int8 rows, scales and bias."""
    u_q, u_eff, _, _, b = (x[0] for x in a["q8"])
    return (a["h0"][0], a["xp"][0], u_q, u_eff, b)


def check_kernels(torch, dev):
    from repro_torch.kernels.gru_sequence import kernel as K
    from repro_torch.kernels.gru_sequence import ref
    err = {n: 0.0 for n in MAIN_SHAPES}
    checks = {n: 0 for n in MAIN_SHAPES}
    err_step = {n: 0.0 for n in STEP_TOO}    # the T=1 unmasked cases alone
    frozen_rows = {n: 0 for n in SLSTM}      # fully masked rows held bitwise
    # row 1: the route each call launched, the block route forced beside it
    seq_routes, err_block, route_diff, same_bits = {}, 0.0, 0.0, 0
    # row 7 likewise; its two routes must agree bit for bit
    q8_routes, err_q8_block, q8_same = {}, 0.0, 0
    # rows 3 and 5 likewise: route launched, block route forced beside it
    # rows 2, 4 and 6 likewise
    # rows 9 and 8 likewise
    dec = {n: {"routes": {}, "err_block": 0.0, "diff": 0.0, "same": 0}
           for n in FUSED_DECODE + PREFILLS + SLSTM}
    from repro_torch.kernels.gru_cell import kernel as CK
    from repro_torch.kernels.slstm_cell import kernel as SK
    for name, shapes in MAIN_SHAPES.items():
        Ts = ((1,) if name in DECODE else (8, 16, 32))
        if name in STEP_TOO:
            Ts = (1,) + Ts
        for (L, H) in shapes:
            for B in (1, 8, 64):
                for T in Ts:
                    a = inputs_for(torch, name, L, H, B, T, B * 100 + T,
                                   dev)
                    for variant in ((None,) if name in SLSTM
                                    else ("v1", "v3")):
                        for masked in ((False,) if T == 1 else (False, True)):
                            got = run_kernel(K, ref, name, a, variant,
                                             masked, plain=False)
                            want = run_kernel(K, ref, name, a, variant,
                                              masked, plain=True)
                            torch.cuda.synchronize()
                            for g_, w_ in zip(got, want):
                                check(bool(torch.isfinite(g_).all()),
                                      f"{name}: non-finite output")
                                e = (g_ - w_).abs().max().item()
                                err[name] = max(err[name], e)
                                if name in STEP_TOO and T == 1:
                                    err_step[name] = max(err_step[name], e)
                                check(e <= TOL, f"{name} L={L} H={H} B={B} "
                                      f"T={T} {variant} masked={masked}: "
                                      f"max |err| {e:.3g} > {TOL}")
                            if name == "gru_sequence_kernel":
                                p = K.gru_sequence_kernel.last_plan
                                check(p == K.seq_plan(B, T, H, variant),
                                      f"{name} B={B} T={T} H={H}: launched "
                                      f"{p}, seq_plan names "
                                      f"{K.seq_plan(B, T, H, variant)}")
                                seq_routes[p.route] = seq_routes.get(
                                    p.route, 0) + 1
                                blk = seq_route_fn(torch, a, variant, masked,
                                                   block_route(K, B, H))()
                                torch.cuda.synchronize()
                                e = (blk - want[0]).abs().max().item()
                                err_block = max(err_block, e)
                                check(e <= TOL, f"{name} block route L={L} "
                                      f"H={H} B={B} T={T} {variant} masked="
                                      f"{masked}: max |err| {e:.3g} > {TOL}")
                                route_diff = max(route_diff, (
                                    got[0] - blk).abs().max().item())
                                same_bits += int(torch.equal(got[0], blk))
                            if name == "gru_step_q8":
                                p = CK.gru_step_q8.last_plan
                                check(p == CK.step_q8_plan(B, H, variant),
                                      f"{name} B={B} H={H}: launched {p}, "
                                      f"step_q8_plan names "
                                      f"{CK.step_q8_plan(B, H, variant)}")
                                q8_routes[p.route] = q8_routes.get(
                                    p.route, 0) + 1
                                blk = step_q8_route_fn(
                                    torch, q8_step_args(a), variant,
                                    step_q8_block_route(B, H))()
                                torch.cuda.synchronize()
                                e = (blk - want[0]).abs().max().item()
                                err_q8_block = max(err_q8_block, e)
                                check(e <= TOL, f"{name} block route H={H} "
                                      f"B={B} {variant}: max |err| {e:.3g} "
                                      f"> {TOL}")
                                check(torch.equal(got[0], blk), f"{name} "
                                      f"H={H} B={B} {variant}: the {p.route}"
                                      f" route differs from the block route")
                                q8_same += 1
                            if name in FUSED_DECODE:
                                q8 = name == "gru_stack_decode_q8_kernel"
                                p = getattr(K, name).last_plan
                                plan = (K.decode_q8_plan if q8 else
                                        K.decode_plan)(B, H, L, variant)
                                check(p == plan, f"{name} L={L} B={B} H={H}"
                                      f": launched {p}, its plan names "
                                      f"{plan}")
                                d = dec[name]
                                d["routes"][p.route] = d["routes"].get(
                                    p.route, 0) + 1
                                blk = decode_route_fn(
                                    torch, a, variant,
                                    decode_block_route(K, B, H, L, q8), q8)()
                                torch.cuda.synchronize()
                                e = (blk - want[0]).abs().max().item()
                                d["err_block"] = max(d["err_block"], e)
                                check(e <= TOL, f"{name} block route L={L} "
                                      f"H={H} B={B} {variant}: max |err| "
                                      f"{e:.3g} > {TOL}")
                                d["diff"] = max(d["diff"], (
                                    got[0] - blk).abs().max().item())
                                check(torch.equal(got[0], blk), f"{name} "
                                      f"L={L} H={H} B={B} {variant}: the "
                                      f"{p.route} route differs from the "
                                      f"block route")
                                d["same"] += 1
                            if name in PREFILLS + SLSTM:
                                p = getattr(SK if name in SLSTM else K,
                                            name).last_plan
                                plan, forced = (
                                    slstm_routes(torch, name, a, masked)
                                    if name in SLSTM else prefill_routes(
                                        torch, K, name, a, variant, masked))
                                check(p == plan, f"{name} L={L} B={B} T={T}"
                                      f" H={H}: launched {p}, its plan names"
                                      f" {plan}")
                                d = dec[name]
                                d["routes"][p.route] = d["routes"].get(
                                    p.route, 0) + 1
                                blk = forced()
                                torch.cuda.synchronize()
                                e = max((x - w_).abs().max().item()
                                        for x, w_ in zip(blk, want))
                                d["err_block"] = max(d["err_block"], e)
                                check(e <= TOL, f"{name} block route L={L} "
                                      f"H={H} B={B} T={T} {variant} masked="
                                      f"{masked}: max |err| {e:.3g} > {TOL}")
                                d["diff"] = max([d["diff"]] + [
                                    (x - y).abs().max().item()
                                    for x, y in zip(got, blk)])
                                check(all(torch.equal(x, y) for x, y in
                                          zip(got, blk)), f"{name} L={L} "
                                      f"H={H} B={B} T={T} {variant} masked="
                                      f"{masked}: the {p.route} route "
                                      f"differs from the block route")
                                d["same"] += 1
                            if name in SLSTM and masked and B > 1:
                                frozen_rows[name] += 1
                                for k, leaf in enumerate(a["leaves"]):
                                    check(torch.equal(got[1 + k][:, 0],
                                                      leaf[:, 0]),
                                          f"{name} L={L} H={H} B={B} T={T}:"
                                          f" the fully masked row's leaf {k}"
                                          f" moved")
                            checks[name] += 1
    for n, e in err.items():
        print(f"  {n}: max |kernel - plain| = {e:.3g} (<= {TOL}) over "
              f"{checks[n]} comparisons")
    for n, e in err_step.items():
        print(f"  {n} at T=1 unmasked (the fp32 chain's decode layer): "
              f"max |kernel - plain| = {e:.3g} (<= {TOL})")
    n_seq = checks["gru_sequence_kernel"]
    print(f"  gru_sequence_kernel: routes launched {seq_routes} (seq_plan's);"
          f" the block route forced beside each call: max |block - plain| ="
          f" {err_block:.3g} (<= {TOL}); max |warp - block| = "
          f"{route_diff:.3g}, bit for bit in {same_bits} of {n_seq} "
          f"comparisons")
    print(f"  gru_step_q8: routes launched {q8_routes} (step_q8_plan's); "
          f"the block route forced beside each call: max |block - plain| = "
          f"{err_q8_block:.3g} (<= {TOL}); equal to the launched route bit "
          f"for bit in {q8_same} of {checks['gru_step_q8']} comparisons")
    for n, d in dec.items():
        print(f"  {n}: routes launched {d['routes']} (its plan's); the block "
              f"route forced beside each call: max |block - plain| = "
              f"{d['err_block']:.3g} (<= {TOL}); max |launched - block| = "
              f"{d['diff']:.3g}, bit for bit in {d['same']} of {checks[n]} "
              f"comparisons")
    print(f"  slstm_stack_sequence_kernel: the fully masked row (m = M_INIT)"
          f" kept all four leaves bit for bit in "
          f"{frozen_rows['slstm_stack_sequence_kernel']} masked comparisons")
    print(f"  {sum(checks.values())} kernel/plain comparisons passed",
          flush=True)
    return err


# ---------------------------------------------------------------------------
# 3b. the shard kernels against their plain versions
# ---------------------------------------------------------------------------

# (H, ranks): gru-jet's and gru-jet-deep's widths over 1, 2 and 4 ranks
# (Hl = 20, 10, 5 and 32, 16, 8), and wide shards (H 64, 256, 512: the
# step's contraction of 512 and the matvec's of 256 and 512 take the
# column tile, the rest the direct route)
SHARD_SHAPES = tuple((H, n) for H in (20, 32, 64, 256, 512)
                     for n in (1, 2, 4))
REDESIGNED = ("gru_rowwise_shard_step", "gru_rowwise_shard_zr",
              "gru_rowwise_shard_candidate", "gru_shard_matvec",
              "gru_cascade_shard_zr")


def shard_inputs(torch, H, n, B, seed, dev):
    """One rank's operands of the shard kernels as the mesh path passes
    them: the last rank (idx = n - 1), so the local slices sit off 0; the
    row-wise operands as gate slices of the shard's (B,3Hl) projection and
    (H,3Hl) rows of U (row-strided views), h_local a column slice of h; the
    v3 cascade epilogue's psum'd gates, projection and bias at full width
    (B,3H), (3H,), read through gate views; the v1 cascade epilogue's
    psum'd partial (B,H), read through its column slice with xp's and
    b's."""
    g = torch.Generator().manual_seed(seed)
    Hl = H // n
    idx = n - 1

    def rand(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g)).to(dev)
    h_full = rand(B, H, scale=0.5)
    a = dict(H=H, Hl=Hl, B=B, idx=idx, h_full=h_full,
             h_local=h_full[:, idx * Hl:(idx + 1) * Hl],
             rh_full=rand(B, H, scale=0.5), xp=rand(B, 3 * Hl),
             u=rand(H, 3 * Hl, scale=H ** -0.5), b=rand(3 * Hl, scale=0.3),
             z=torch.sigmoid(rand(B, Hl)), h_shard=rand(B, Hl, scale=0.5),
             u_rows=rand(Hl, 3 * H, scale=H ** -0.5), g_full=rand(B, 3 * H),
             xp_full=rand(B, 3 * H), b_full=rand(3 * H, scale=0.3),
             zr=rand(B, 2 * Hl), xp2=rand(B, 2 * Hl), ht_in=rand(B, Hl),
             ht_full=rand(B, H))
    return a


def old_epilogue(g, xp_full, b_full, h, idx):
    """The v3 cascade epilogue as the mesh step ran it before row 16 read
    its gates in place: g + b at full width (an add kernel), this rank's
    slices of g and xp copied out (``_local_gates``: two cat kernels),
    then the kernel on the contiguous slices."""
    from repro_torch.core import rowparallel as rp
    from repro_torch.kernels.gru_sequence import kernel as K
    H, Hl = xp_full.shape[-1] // 3, h.shape[1]
    return K.gru_cascade_shard_gates(
        rp._local_gates(g + b_full, 3, H, idx, Hl),
        rp._local_gates(xp_full, 3, H, idx, Hl), h)


def old_gates_fn(a):
    """:func:`old_epilogue` on :func:`shard_inputs`' operands, as a call
    (phase 3b's bitwise check and phase 12's "before")."""
    return lambda: old_epilogue(a["g_full"], a["xp_full"], a["b_full"],
                                a["h_shard"], a["idx"])


def update_views(a, idx):
    """Row 18's in-place operands on rank ``idx``, as the mesh step passes
    them: z, this rank's column slice of the psum'd partial, h, and the
    slices of xp's candidate gate and of b."""
    from repro_torch.core import rowparallel as rp
    H, Hl = a["H"], a["Hl"]
    s = 2 * H + idx * Hl
    return (a["z"], rp._local(a["ht_full"], idx * Hl, Hl), a["h_shard"],
            rp._local(a["xp_full"], s, Hl), a["b_full"][s:s + Hl])


def old_update_fn(a, idx):
    """The v1 cascade epilogue as the mesh step ran it before row 18 read
    its candidate in place: ``_ht_in``'s two adds (xp + psum, then + b),
    then the kernel on the contiguous pre-activation; as a call (phase 3b's
    bitwise check and phase 12's "before")."""
    from repro_torch.core import rowparallel as rp
    from repro_torch.kernels.gru_sequence import kernel as K
    return lambda: K.gru_cascade_shard_update(
        a["z"], rp._ht_in(a["xp_full"], a["ht_full"], a["b_full"], a["H"],
                          idx, a["Hl"]), a["h_shard"])


def shard_args(name, a, N=None):
    """The operands of shard kernel ``name`` (``N``: the matvec's width,
    3H (v3) or 2H (v1, a strided slice))."""
    Hl, H = a["Hl"], a["H"]
    if name == "gru_rowwise_shard_step":
        return (a["h_full"], a["h_local"], a["xp"], a["u"], a["b"])
    if name == "gru_rowwise_shard_zr":
        return (a["h_full"], a["h_local"], a["xp"][:, :2 * Hl],
                a["u"][:, :2 * Hl], a["b"][:2 * Hl])
    if name == "gru_rowwise_shard_candidate":
        return (a["rh_full"], a["h_local"], a["z"], a["xp"][:, 2 * Hl:],
                a["u"][:, 2 * Hl:], a["b"][2 * Hl:])
    if name == "gru_shard_matvec":
        return (a["h_shard"], a["u_rows"][:, :N or 3 * H])
    if name == "gru_cascade_shard_gates":     # in place, as the step calls it
        from repro_torch.core import rowparallel as rp
        views = [rp._gate_view(a[k], 3, H, a["idx"], Hl)
                 for k in ("g_full", "xp_full", "b_full")]
        return (views[0], views[1], a["h_shard"], views[2])
    if name == "gru_cascade_shard_zr":
        return (a["zr"], a["xp2"], a["h_shard"], a["u_rows"][:, 2 * H:])
    return update_views(a, a["idx"])          # in place, as the step calls it


def run_shard_kernel(name, args, plain):
    from repro_torch.kernels.gru_sequence import kernel as K
    from repro_torch.kernels.gru_sequence import ref
    fn = getattr(ref, name + "_ref") if plain else getattr(K, name)
    out = fn(*args)
    return out if isinstance(out, tuple) else (out,)


def check_shard_kernels(torch, dev):
    """The seven shard kernels against their plain versions on the card at
    the mesh path's shard shapes and wide ones (B 1 and 8; the matvec at N
    = 3H and 2H); the four redesigned kernels must launch the route the
    CPU rule (``shard_plan``) names. Returns {kernel: max |err|}."""
    from repro_torch.kernels.gru_sequence import kernel as K
    err = {n: 0.0 for n in SHARD}
    routes = {n: {} for n in REDESIGNED}
    n_checks = gates_same = update_same = 0
    for (H, n) in SHARD_SHAPES:
        for B in (1, 8):
            a = shard_inputs(torch, H, n, B, 1000 * n + H + B, dev)
            for name in SHARD:
                for N in ((3 * H, 2 * H) if name == "gru_shard_matvec"
                          else (None,)):
                    args = shard_args(name, a, N)
                    got = run_shard_kernel(name, args, plain=False)
                    if name in REDESIGNED:
                        p = getattr(K, name).last_plan
                        check(p == planned(K, name, args), f"{name} H={H} "
                              f"n={n} B={B}: launched {p}, the rule names "
                              f"{planned(K, name, args)}")
                        routes[name][p.route] = routes[name].get(
                            p.route, 0) + 1
                    want = run_shard_kernel(name, args, plain=True)
                    if name == "gru_cascade_shard_gates":
                        old = old_gates_fn(a)()
                        torch.cuda.synchronize()
                        check(torch.equal(got[0], old), f"{name} H={H} n={n}"
                              f" B={B}: the in-place call differs from the "
                              f"old sequence (+ b, slices, contiguous call)")
                        gates_same += 1
                    if name == "gru_cascade_shard_update":   # every rank
                        for idx in range(n):
                            new = K.gru_cascade_shard_update(
                                *update_views(a, idx))
                            old = old_update_fn(a, idx)()
                            torch.cuda.synchronize()
                            check(torch.equal(new, old), f"{name} H={H} "
                                  f"n={n} rank {idx} B={B}: the in-place "
                                  f"call differs from the old sequence "
                                  f"(two adds, contiguous call)")
                            update_same += 1
                    torch.cuda.synchronize()
                    for g_, w_ in zip(got, want):
                        check(g_.shape == w_.shape
                              and bool(torch.isfinite(g_).all()),
                              f"{name} H={H} n={n} B={B}: bad output")
                        e = (g_ - w_).abs().max().item()
                        err[name] = max(err[name], e)
                        check(e <= TOL, f"{name} H={H} ranks={n} B={B} "
                              f"N={N}: max |err| {e:.3g} > {TOL}")
                    n_checks += 1
    for name, e in err.items():
        print(f"  {name}: max |kernel - plain| = {e:.3g} (<= {TOL})"
              + (f"; routes launched {routes[name]}" if name in routes
                 else ""))
    print(f"  gru_cascade_shard_gates: the in-place call (gate views of g, "
          f"xp and b) equals the old sequence (+ b, two slice copies, the "
          f"contiguous call) bit for bit in {gates_same} of {gates_same} "
          f"comparisons")
    print(f"  gru_cascade_shard_update: the in-place call (column slices of "
          f"the psum, of xp and of b) equals the old sequence (two adds, "
          f"the contiguous call) bit for bit in {update_same} of "
          f"{update_same} comparisons (every rank of each mesh)")
    print(f"  {n_checks} shard kernel/plain comparisons passed (H 20, 32, "
          f"64, 256, 512 over 1, 2, 4 ranks; B 1 and 8)", flush=True)
    return err


def planned(K, name, args):
    """The launch ``shard_plan`` names for redesigned kernel ``name``."""
    if name == "gru_shard_matvec":
        x, w = args
        return K.shard_plan(x.shape[0], x.shape[1], 1, w.shape[1],
                            K._vector(w, w.stride(0), w.shape[1]), "matvec")
    if name == "gru_cascade_shard_zr":
        h, u = args[2], args[3]
        return K.shard_plan(h.shape[0], h.shape[1], 1, u.shape[1],
                            K._vector(u, u.stride(0), u.shape[1]),
                            "cascade_zr")
    kind = K._ROWWISE_MODES[name][1]
    G = K.KIND_GATES[kind]
    x, h_local, u = args[0], args[1], args[-2]
    return K.shard_plan(x.shape[0], x.shape[1], G, h_local.shape[1],
                        K._vector(u, u.stride(0), h_local.shape[1]), kind)


# ---------------------------------------------------------------------------
# 4. the main path: serve both configs through the kernels
# ---------------------------------------------------------------------------

ARCHS = ("gru-jet", "gru-jet-deep")
HETERO = "gru-jet-deep (32, 32, 20)"     # heterogeneous stack of phases 6-7
PLAIN = {                  # module of plain versions -> names the wrappers call
    "repro_torch.kernels.gru_sequence.ref": (
        "gru_sequence_ref", "gru_stack_sequence_ref", "gru_stack_decode_ref",
        "gru_stack_sequence_q8_ref", "gru_stack_decode_q8_ref",
        "gru_sequence_q8_ref"),
    "repro_torch.kernels.gru_cell.ref": ("gru_step_q8_ref", "gru_step_ref"),
    "repro_torch.kernels.rowwise_matvec.ref": ("rowwise_matmul_ref",
                                               "cascade_matmul_ref"),
    "repro_torch.kernels.slstm_cell.ref": ("slstm_stack_sequence_ref",
                                           "slstm_stack_decode_ref",
                                           "slstm_stack_decode_layers_ref"),
    "repro_torch.kernels.flash_attn.ref": ("flash_attention_plain",),
    "repro_torch.kernels.decode_attn.ref": ("flash_decode_plain",),
}


@contextlib.contextmanager
def plain_calls():
    """Count calls of the kernels' plain versions while the block runs (the
    wrappers reach them through their ``ref`` modules), so a run can show
    that none replaced a kernel."""
    import importlib
    counts, saved = {}, []
    for mod_name, names in PLAIN.items():
        mod = importlib.import_module(mod_name)
        for n in names:
            counts[n] = 0
            saved.append((mod, n, getattr(mod, n)))

    def counting(n, fn):
        def wrapped(*args, **kw):
            counts[n] += 1
            return fn(*args, **kw)
        return wrapped
    for mod, n, fn in saved:
        setattr(mod, n, counting(n, fn))
    try:
        yield counts
    finally:
        for mod, n, fn in saved:
            setattr(mod, n, fn)


# gru_sequence_kernel's served calls (phases 4 and 6) by (T, B, H): the
# gru-jet prefills and the fp32 chain's layers, for phase 12's split of
# its launches by shape; and the routes they launched, by shape
SEQ_SHAPES: dict = {}
SEQ_ROUTES: dict = {}


@contextlib.contextmanager
def sequence_shapes(counts):
    """Count the calls of ``gru_sequence_kernel`` that the serving path
    makes through its ops module, by (T, B, H), while the block runs, and
    note the route each launched (:data:`SEQ_ROUTES`)."""
    from repro_torch.kernels.gru_sequence import ops
    fn = ops.gru_sequence_kernel

    def recording(h0, x_proj, *args, **kw):
        key = tuple(x_proj.shape[:2]) + (h0.shape[-1],)
        counts[key] = counts.get(key, 0) + 1
        out = fn(h0, x_proj, *args, **kw)
        if x_proj.is_cuda:
            SEQ_ROUTES.setdefault(key, set()).add(fn.last_plan.route)
        return out
    ops.gru_sequence_kernel = recording
    try:
        yield counts
    finally:
        ops.gru_sequence_kernel = fn


# gru_step_q8's served calls (phase 7) by (B, H), for phase 12's launches
# x gap, and the routes they launched, by shape
STEP_Q8_SHAPES: dict = {}
STEP_Q8_ROUTES: dict = {}


@contextlib.contextmanager
def step_q8_calls():
    """Count the calls of ``gru_step_q8`` that the serving path makes
    through its ops module, by (B, H), while the block runs
    (:data:`STEP_Q8_SHAPES`), and note the route each launched
    (:data:`STEP_Q8_ROUTES`)."""
    from repro_torch.kernels.gru_cell import ops
    fn = ops.gru_step_q8

    def recording(h, *args, **kw):
        key = tuple(h.shape)
        STEP_Q8_SHAPES[key] = STEP_Q8_SHAPES.get(key, 0) + 1
        out = fn(h, *args, **kw)
        if h.is_cuda:
            STEP_Q8_ROUTES.setdefault(key, set()).add(fn.last_plan.route)
        return out
    ops.gru_step_q8 = recording
    try:
        yield
    finally:
        ops.gru_step_q8 = fn


# the fused decode kernels' served calls (phases 4 and 5, and phase 11b's
# backend="cuda" runs, whose ranks report theirs) by (L, B, H), for phase
# 12's launches x gap, and the routes they launched, by shape
FUSED_DECODE = ("gru_stack_decode_kernel", "gru_stack_decode_q8_kernel")
DECODE_SHAPES: dict = {n: {} for n in FUSED_DECODE}
DECODE_ROUTES: dict = {n: {} for n in FUSED_DECODE}


@contextlib.contextmanager
def decode_calls(shapes=DECODE_SHAPES, routes=DECODE_ROUTES):
    """Count the calls of the two fused decode kernels that the serving
    path makes through its ops module, by (L, B, H), while the block runs,
    and note the route each launched."""
    from repro_torch.kernels.gru_sequence import ops
    saved = {n: getattr(ops, n) for n in FUSED_DECODE}

    def recording(n, fn):
        def wrapped(h, *args, **kw):
            key = tuple(h.shape)
            shapes[n][key] = shapes[n].get(key, 0) + 1
            out = fn(h, *args, **kw)
            if h.is_cuda:
                routes[n].setdefault(key, set()).add(fn.last_plan.route)
            return out
        return wrapped
    for n, fn in saved.items():
        setattr(ops, n, recording(n, fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)


# the prefill kernels' served calls (phase 4: gru-jet-deep's fused
# prefills; phase 5: the fused q8 prefills, both by (L, T, B, H); phase 7:
# the q8 chain's layers by (T, B, H)), for phase 12's launches x gap, and
# the routes they launched, by shape
PREFILL_SHAPES: dict = {n: {} for n in PREFILLS}
PREFILL_ROUTES: dict = {n: {} for n in PREFILLS}


@contextlib.contextmanager
def prefill_calls():
    """Count the calls of the three prefill kernels (:data:`PREFILLS`) that
    the serving path makes through its ops module, by shape ((L, T, B, H)
    for the fused ones, (T, B, H) for the chain's layer), while the block
    runs, and note the route each launched."""
    from repro_torch.kernels.gru_sequence import ops
    saved = {n: getattr(ops, n) for n in PREFILLS}

    def recording(n, fn):
        def wrapped(h0, x_proj, *args, **kw):
            key = ((h0.shape[0],) if h0.dim() == 3 else ()) + tuple(
                x_proj.shape[:2]) + (h0.shape[-1],)
            shapes = PREFILL_SHAPES[n]
            shapes[key] = shapes.get(key, 0) + 1
            out = fn(h0, x_proj, *args, **kw)
            if x_proj.is_cuda:
                PREFILL_ROUTES[n].setdefault(key, set()).add(
                    fn.last_plan.route)
            return out
        return wrapped
    for n, fn in saved.items():
        setattr(ops, n, recording(n, fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)


# the sLSTM kernels' served calls (phase 8) by shape ((L, B, H) for the
# decode, (L, T, B, H) for the prefill), for phase 12's launches x gap, and
# the routes they launched, by shape
SLSTM_SHAPES: dict = {n: {} for n in SLSTM}
SLSTM_ROUTES: dict = {n: {} for n in SLSTM}


@contextlib.contextmanager
def slstm_calls():
    """Count the calls of the two sLSTM kernels that the serving path makes
    through its ops module (the decode through ``slstm_stack_decode_layers``,
    the per-layer entry of ``slstm_stack_decode_kernel``), by shape, while
    the block runs, and note the route each launched."""
    from repro_torch.kernels.slstm_cell import kernel as SK
    from repro_torch.kernels.slstm_cell import ops
    dec, seq = ops.slstm_stack_decode_layers, ops.slstm_stack_sequence_kernel

    def record(n, key, cuda):
        SLSTM_SHAPES[n][key] = SLSTM_SHAPES[n].get(key, 0) + 1
        if cuda:
            SLSTM_ROUTES[n].setdefault(key, set()).add(
                getattr(SK, n).last_plan.route)

    def decode(layers, x_proj, *args, **kw):
        out = dec(layers, x_proj, *args, **kw)
        record("slstm_stack_decode_kernel",
               (len(layers),) + tuple(layers[0][3].shape), x_proj.is_cuda)
        return out

    def sequence(c0, n0, m0, h0, x_proj, *args, **kw):
        out = seq(c0, n0, m0, h0, x_proj, *args, **kw)
        record("slstm_stack_sequence_kernel", (h0.shape[0],) + tuple(
            x_proj.shape[:2]) + (h0.shape[-1],), x_proj.is_cuda)
        return out
    ops.slstm_stack_decode_layers = decode
    ops.slstm_stack_sequence_kernel = sequence
    try:
        yield
    finally:
        ops.slstm_stack_decode_layers = dec
        ops.slstm_stack_sequence_kernel = seq


def check_prefill_routes(name, launches):
    """Every served call of prefill kernel ``name`` took the warp route (its
    plan's at every served shape), and the calls recorded by shape are all
    its ``launches``."""
    got, shapes = PREFILL_ROUTES[name], PREFILL_SHAPES[name]
    check(got and set(got) == set(shapes)
          and sum(shapes.values()) == launches
          and all(r == {"warp"} for r in got.values()),
          f"{name}: served calls {shapes} ({launches} launches) launched "
          f"{got}, not the warp route every time")
    print(f"  {name}: the warp route at every served call ({launches}; "
          f"{ {k: shapes[k] for k in sorted(shapes)} })", flush=True)


def check_decode_routes(name, routes=DECODE_ROUTES):
    """Every served call of fused decode kernel ``name`` took the warp
    route (its plan's at every served shape)."""
    got = routes[name]
    check(got and all(r == {"warp"} for r in got.values()),
          f"{name}: served calls launched {got}, not the warp route alone")
    print(f"  {name}: every served call took the warp route "
          f"({ {k: sorted(v) for k, v in got.items()} })", flush=True)


def serve(cfg, params, backend, dev):
    from repro_torch.launch.serve import make_requests
    from repro_torch.serve.engine import ServeEngine
    cfg = cfg.replace(gru=dataclasses.replace(cfg.gru, backend=backend))
    eng = ServeEngine(cfg, params, max_batch=SLOTS, device=dev)
    reqs = make_requests(cfg, REQUESTS, MAX_PROMPT, True, MAX_NEW, seed=3)
    done = eng.generate(reqs)
    return eng, [r.out for r in done]


def serve_all(K, cfgs, params, backend, dev, kernels, backends=None):
    """Serve every config of ``cfgs`` through ``backend`` (or
    ``backends[name]``) with all launch counters set to 0 just before;
    returns engines, streams, the launches of ``kernels`` per config and in
    all, every other kernel's launches, and the plain versions' calls."""
    K.reset_launch_counts()
    engines, streams, per_arch = {}, {}, {}
    before = [0] * len(kernels)
    with plain_calls() as plain, sequence_shapes(SEQ_SHAPES), \
            decode_calls(), prefill_calls(), slstm_calls():
        for a in cfgs:
            b = (backends or {}).get(a, backend)
            engines[a], streams[a] = serve(cfgs[a], params[a], b, dev)
            after = [k.launches for k in kernels]
            per_arch[a] = [x - y for x, y in zip(after, before)]
            before = after
    from repro_torch.kernels.slstm_cell import kernel as SK
    launches = dict(zip((k.__name__ for k in kernels), before))
    others = {k.__name__: k.launches
              for k in (K.KERNELS + K.Q8_KERNELS + K.CHAIN_Q8_KERNELS
                        + SK.SLSTM_KERNELS + K.ATTN_KERNELS
                        + K.ROWWISE_KERNELS + K.SHARD_KERNELS)
              if k not in kernels}
    print(f"  launches: {launches}; other kernels {others}; "
          f"plain versions {plain}", flush=True)
    check(not any(others.values()), f"{backend}: other kernels ran {others}")
    check(not any(plain.values()), f"{backend}: plain versions ran {plain}")
    return engines, streams, per_arch, launches


def check_served(a, eng, backend, per_arch, want):
    """Every prefill and recorded step on ``backend``; the launches equal
    ``want(prefills, steps run)``."""
    st = eng.latency_stats()
    prefills = len(eng.prefill_backends)
    steps_run = st["steps"] + 1     # the wave's one decode key: its
                                    # first step is not recorded
    check(set(eng.prefill_backends) == {backend},
          f"{a}: prefill backends {set(eng.prefill_backends)}")
    check(st["decode_backend_steps"] == {backend: st["steps"]},
          f"{a}: decode steps {st['decode_backend_steps']}")
    w = want(prefills, steps_run)
    check(per_arch == w, f"{a}: launches {per_arch} != {w} "
          f"({prefills} prefills, {steps_run} steps)")
    return st, prefills, steps_run


def run_main_path(torch, dev):
    from repro_torch.configs.base import get_config
    from repro_torch.core import gru as gru_core
    from repro_torch.core.params import init_params
    from repro_torch.kernels.gru_sequence import kernel as K
    from repro_torch.models import gru_lm

    cfgs = {a: get_config(a) for a in ARCHS}
    params = {a: init_params(gru_lm.lm_specs(cfgs[a]), seed=0, device=dev)
              for a in ARCHS}
    engines, streams, per_arch, launches = serve_all(        # the main path
        K, cfgs, params, "cuda", dev, K.KERNELS)

    report = {}
    for a in ARCHS:
        eng = engines[a]
        seq_i = 0 if cfgs[a].gru.resolved_num_layers == 1 else 1

        def want(prefills, steps):
            w = [0, 0, steps]
            w[seq_i] = prefills
            return w
        st, prefills, steps_run = check_served(a, eng, "cuda_fused",
                                               per_arch[a], want)
        _, eager_streams = serve(cfgs[a], params[a], "eager", dev)
        check(streams[a] == eager_streams,
              f"{a}: class streams differ from the eager engine")
        check(all(len(s) == MAX_NEW for s in streams[a]),
              f"{a}: stream lengths {[len(s) for s in streams[a]]}")
        # repo's own means: finite logits of the right shape that agree
        # with the dense reference on a small batch
        g = torch.Generator().manual_seed(5)
        xs = torch.randn(3, 7, cfgs[a].gru.input_dim, generator=g).to(dev)
        cfg_c = cfgs[a].replace(gru=dataclasses.replace(cfgs[a].gru,
                                                        backend="cuda"))
        logits, _ = gru_lm.prefill(eng.params, cfg_c, {"features": xs})
        h0s = gru_core.stack_h0(cfgs[a].gru, 3, device=dev)
        finals, _ = gru_core.gru_stack_reference(
            gru_core.stack_cell_params(params[a]), h0s, xs)
        want_logits = (finals[-1] @ params[a]["head"]["w"]
                       + params[a]["head"]["b"])
        check(tuple(logits.shape) == (3, cfgs[a].gru.num_classes)
              and bool(torch.isfinite(logits).all()), f"{a}: bad logits")
        e = (logits - want_logits).abs().max().item()
        check(e <= TOL, f"{a}: prefill logits vs reference {e:.3g}")
        report[a] = {"prefills": prefills, "decode_steps": steps_run,
                     "decode_p50_ms": st["p50_s"] * 1e3,
                     "decode_p99_ms": st["p99_s"] * 1e3,
                     "prefill_mean_ms": st["prefill_mean_s"] * 1e3,
                     "logits_err_vs_reference": e,
                     "streams_equal_eager": True}
        print(f"  {a}: {prefills} prefills, {steps_run} decode steps, all "
              f"cuda_fused; decode p50 {st['p50_s'] * 1e3:.4f} ms p99 "
              f"{st['p99_s'] * 1e3:.4f} ms (host clock, synchronized); "
              f"streams == eager; logits vs reference {e:.3g}", flush=True)
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the main path never launched: {launches}")
    check_decode_routes("gru_stack_decode_kernel")
    check_prefill_routes("gru_stack_sequence_kernel",
                         launches["gru_stack_sequence_kernel"])
    return launches, report, cfgs, params, streams


# ---------------------------------------------------------------------------
# 5. the int8 path: serve both configs through cuda_fused_q8
# ---------------------------------------------------------------------------

def to_device(tree, dev):
    """A copy of a nested dict/tuple of tensors on ``dev``."""
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_device(v, dev) for v in tree)
    return tree.to(dev)


def run_q8_path(torch, dev, cfgs, params, fp32_streams):
    from repro_torch.kernels.gru_sequence import kernel as K
    from repro_torch.models import gru_lm

    engines, streams, per_arch, launches = serve_all(        # the q8 path
        K, cfgs, params, "cuda_fused_q8", dev, K.Q8_KERNELS)
    cpu = torch.device("cpu")
    report = {}
    for a in ARCHS:
        eng = engines[a]
        st, prefills, steps_run = check_served(
            a, eng, "cuda_fused_q8", per_arch[a], lambda p, s: [p, s])
        check(st["served_dtype"] == "int8", f"{a}: {st['served_dtype']}")
        cpu_eng, cpu_streams = serve(cfgs[a], to_device(params[a], cpu),
                                     "cuda_fused_q8", cpu)
        check(streams[a] == cpu_streams,
              f"{a}: q8 class streams on the card differ from the CPU run")
        # finite logits of the right shape, equal to the plain versions'
        # on the CPU for the same prepared weights
        g = torch.Generator().manual_seed(5)
        xs = torch.randn(3, 7, cfgs[a].gru.input_dim, generator=g)
        cfg_q = cfgs[a].replace(gru=dataclasses.replace(
            cfgs[a].gru, backend="cuda_fused_q8"))
        logits, _ = gru_lm.prefill(eng.params, cfg_q, {"features": xs.to(dev)})
        want, _ = gru_lm.prefill(cpu_eng.params, cfg_q, {"features": xs})
        check(tuple(logits.shape) == (3, cfgs[a].gru.num_classes)
              and bool(torch.isfinite(logits).all()), f"{a}: bad q8 logits")
        e = (logits.cpu() - want).abs().max().item()
        check(e <= TOL, f"{a}: q8 prefill logits vs the CPU run {e:.3g}")
        tokens = [(x, y) for s, f in zip(streams[a], fp32_streams[a])
                  for x, y in zip(s, f)]
        agree = sum(x == y for x, y in tokens) / len(tokens)
        report[a] = {"prefills": prefills, "decode_steps": steps_run,
                     "decode_p50_ms": st["p50_s"] * 1e3,
                     "decode_p99_ms": st["p99_s"] * 1e3,
                     "prefill_mean_ms": st["prefill_mean_s"] * 1e3,
                     "logits_err_vs_cpu": e, "streams_equal_cpu": True,
                     "token_agreement_with_fp32": agree}
        print(f"  {a}: {prefills} prefills, {steps_run} decode steps, all "
              f"cuda_fused_q8 (int8); decode p50 {st['p50_s'] * 1e3:.4f} ms "
              f"p99 {st['p99_s'] * 1e3:.4f} ms (host clock, synchronized); "
              f"streams == CPU run; logits vs CPU run {e:.3g}; tokens equal "
              f"to fp32 cuda_fused: {agree:.4f} (report only)", flush=True)
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the q8 path never launched: {launches}")
    check_decode_routes("gru_stack_decode_q8_kernel")
    check_prefill_routes("gru_stack_sequence_q8_kernel",
                         launches["gru_stack_sequence_q8_kernel"])
    return launches, report


# ---------------------------------------------------------------------------
# 6-7. the per-layer chains: cuda_chain and cuda_chain_q8
# ---------------------------------------------------------------------------

def chain_configs(torch, dev, cfgs, params):
    """Both configs plus gru-jet-deep with heterogeneous ``layer_dims``
    (three layers keep its three ``layer_matvec_modes`` valid), random
    weights from seed 0."""
    from repro_torch.core.params import init_params
    from repro_torch.models import gru_lm
    deep = cfgs["gru-jet-deep"]
    het = deep.replace(gru=dataclasses.replace(deep.gru,
                                               layer_dims=(32, 32, 20)))
    ccfgs = dict(cfgs, **{HETERO: het})
    cparams = dict(params, **{HETERO: init_params(gru_lm.lm_specs(het),
                                                  seed=0, device=dev)})
    return ccfgs, cparams


def run_chain_path(torch, dev, cfgs, params):
    """The fp32 chain: the two configs pinned to ``cuda_chain``, the
    heterogeneous stack under the ``cuda`` preference (which must resolve
    to the chain)."""
    from repro_torch.kernels.gru_sequence import kernel as K
    backends = {HETERO: "cuda"}
    engines, streams, per_arch, launches = serve_all(
        K, cfgs, params, "cuda_chain", dev, (K.gru_sequence_kernel,),
        backends)
    report = {}
    for a in cfgs:
        L = cfgs[a].gru.resolved_num_layers
        st, prefills, steps_run = check_served(
            a, engines[a], "cuda_chain", per_arch[a],
            lambda p, s: [L * (p + s)])
        _, eager_streams = serve(cfgs[a], params[a], "eager", dev)
        check(streams[a] == eager_streams,
              f"{a}: cuda_chain class streams differ from the eager engine")
        report[a] = {"backend_asked": backends.get(a, "cuda_chain"),
                     "prefills": prefills, "decode_steps": steps_run,
                     "launches": per_arch[a][0],
                     "decode_p50_ms": st["p50_s"] * 1e3,
                     "decode_p99_ms": st["p99_s"] * 1e3,
                     "prefill_mean_ms": st["prefill_mean_s"] * 1e3,
                     "streams_equal_eager": True}
        print(f"  {a}: {prefills} prefills, {steps_run} decode steps, all "
              f"cuda_chain; gru_sequence_kernel launches {per_arch[a][0]} "
              f"= {L} x ({prefills} + {steps_run}); decode p50 "
              f"{st['p50_s'] * 1e3:.4f} ms p99 {st['p99_s'] * 1e3:.4f} ms "
              f"(host clock, synchronized); streams == eager", flush=True)
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the chain never launched: {launches}")
    check(set(SEQ_ROUTES) == set(SEQ_SHAPES) and all(
        r == {"warp"} for r in SEQ_ROUTES.values()), f"gru_sequence_kernel:"
          f" served shapes launched routes {SEQ_ROUTES}, not the warp route")
    print(f"  gru_sequence_kernel: the warp route at every served shape "
          f"(phases 4 and 6): {sorted(SEQ_SHAPES)}", flush=True)
    return launches, report


def run_chain_q8_path(torch, dev, cfgs, params):
    """The q8 chain: all three configs pinned to ``cuda_chain_q8``; class
    streams and prefill logits held against the CPU run of the same pin."""
    from repro_torch.kernels.gru_sequence import kernel as K
    from repro_torch.models import gru_lm
    with step_q8_calls():
        engines, streams, per_arch, launches = serve_all(
            K, cfgs, params, "cuda_chain_q8", dev, K.CHAIN_Q8_KERNELS)
    check(sum(STEP_Q8_SHAPES.values()) == launches["gru_step_q8"]
          and set(STEP_Q8_ROUTES) == set(STEP_Q8_SHAPES)
          and all(r == {"warp"} for r in STEP_Q8_ROUTES.values()),
          f"gru_step_q8: served calls {STEP_Q8_SHAPES} ({launches} "
          f"launches) launched routes {STEP_Q8_ROUTES}, not the warp route "
          f"every time")
    print(f"  gru_step_q8: the warp route at every served call "
          f"({sum(STEP_Q8_SHAPES.values())}; (B, H): {STEP_Q8_SHAPES})",
          flush=True)
    cpu = torch.device("cpu")
    report = {}
    for a in cfgs:
        L = cfgs[a].gru.resolved_num_layers
        eng = engines[a]
        st, prefills, steps_run = check_served(
            a, eng, "cuda_chain_q8", per_arch[a],
            lambda p, s: [L * p, L * s])
        check(st["served_dtype"] == "int8", f"{a}: {st['served_dtype']}")
        cpu_eng, cpu_streams = serve(cfgs[a], to_device(params[a], cpu),
                                     "cuda_chain_q8", cpu)
        same = [x == y for x, y in zip(streams[a], cpu_streams)]
        check(all(same), f"{a}: cuda_chain_q8 class streams on the card "
              f"differ from the CPU run in requests "
              f"{[i for i, ok in enumerate(same) if not ok]}")
        g = torch.Generator().manual_seed(5)
        xs = torch.randn(3, 7, cfgs[a].gru.input_dim, generator=g)
        cfg_q = cfgs[a].replace(gru=dataclasses.replace(
            cfgs[a].gru, backend="cuda_chain_q8"))
        logits, _ = gru_lm.prefill(eng.params, cfg_q, {"features": xs.to(dev)})
        want, _ = gru_lm.prefill(cpu_eng.params, cfg_q, {"features": xs})
        check(tuple(logits.shape) == (3, cfgs[a].gru.num_classes)
              and bool(torch.isfinite(logits).all()), f"{a}: bad q8 logits")
        e = (logits.cpu() - want).abs().max().item()
        check(e <= TOL, f"{a}: q8 chain prefill logits vs the CPU run {e:.3g}")
        report[a] = {"prefills": prefills, "decode_steps": steps_run,
                     "launches": per_arch[a],
                     "decode_p50_ms": st["p50_s"] * 1e3,
                     "decode_p99_ms": st["p99_s"] * 1e3,
                     "prefill_mean_ms": st["prefill_mean_s"] * 1e3,
                     "logits_err_vs_cpu": e, "streams_equal_cpu": True}
        print(f"  {a}: {prefills} prefills, {steps_run} decode steps, all "
              f"cuda_chain_q8 (int8); launches {per_arch[a]} = {L} x "
              f"({prefills}, {steps_run}); decode p50 "
              f"{st['p50_s'] * 1e3:.4f} ms p99 {st['p99_s'] * 1e3:.4f} ms "
              f"(host clock, synchronized); streams == CPU run; logits vs "
              f"CPU run {e:.3g}", flush=True)
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the q8 chain never launched: {launches}")
    check_prefill_routes("gru_sequence_q8_kernel",
                         launches["gru_sequence_q8_kernel"])
    return launches, report


# ---------------------------------------------------------------------------
# 8. the sLSTM family: serve slstm-jet and a deep stack through cuda_fused
# ---------------------------------------------------------------------------

SLSTM_ARCHS = ("slstm-jet", "slstm-jet L=3 H=32")


def slstm_configs() -> dict:
    """slstm-jet and its uniform deep stack (``num_layers=3,
    hidden_dim=32``), by :data:`SLSTM_ARCHS` name."""
    from repro_torch.configs.base import get_config
    base = get_config("slstm-jet")
    return {SLSTM_ARCHS[0]: base,
            SLSTM_ARCHS[1]: base.replace(gru=dataclasses.replace(
                base.gru, num_layers=3, hidden_dim=32))}


def run_slstm_path(torch, dev):
    """slstm-jet and its uniform deep stack (``num_layers=3,
    hidden_dim=32``) under ``backend="cuda"``: one sequence launch per
    prefill, one decode launch per step, class streams equal to the eager
    engine's, prefill logits against the dense reference; every served
    call of either kernel on its warp route."""
    from repro_torch.core import slstm as slstm_core
    from repro_torch.core.params import init_params
    from repro_torch.kernels.gru_sequence import kernel as K
    from repro_torch.kernels.slstm_cell import kernel as SK
    from repro_torch.models import slstm_lm
    cfgs = slstm_configs()
    params = {a: init_params(slstm_lm.lm_specs(c), seed=0, device=dev)
              for a, c in cfgs.items()}
    engines, streams, per_arch, launches = serve_all(
        K, cfgs, params, "cuda", dev, SK.SLSTM_KERNELS)
    report = {}
    for a, cfg in cfgs.items():
        st, prefills, steps_run = check_served(
            a, engines[a], "cuda_fused", per_arch[a], lambda p, s: [p, s])
        _, eager_streams = serve(cfg, params[a], "eager", dev)
        check(streams[a] == eager_streams,
              f"{a}: class streams differ from the eager engine")
        check(all(len(x) == MAX_NEW for x in streams[a]),
              f"{a}: stream lengths {[len(x) for x in streams[a]]}")
        g = torch.Generator().manual_seed(5)
        xs = torch.randn(3, 7, cfg.gru.input_dim, generator=g).to(dev)
        cfg_c = cfg.replace(gru=dataclasses.replace(cfg.gru, backend="cuda"))
        logits, _ = slstm_lm.prefill(engines[a].params, cfg_c,
                                     {"features": xs})
        finals, _ = slstm_core.slstm_stack_reference(
            params[a]["cells"],
            slstm_core.stack_state0(cfg.gru, 3, device=dev), xs)
        want_logits = (finals[-1] @ params[a]["head"]["w"]
                       + params[a]["head"]["b"])
        check(tuple(logits.shape) == (3, cfg.gru.num_classes)
              and bool(torch.isfinite(logits).all()), f"{a}: bad logits")
        e = (logits - want_logits).abs().max().item()
        check(e <= TOL, f"{a}: prefill logits vs reference {e:.3g}")
        report[a] = {"prefills": prefills, "decode_steps": steps_run,
                     "launches": per_arch[a],
                     "decode_p50_ms": st["p50_s"] * 1e3,
                     "decode_p99_ms": st["p99_s"] * 1e3,
                     "prefill_mean_ms": st["prefill_mean_s"] * 1e3,
                     "logits_err_vs_reference": e,
                     "streams_equal_eager": True}
        print(f"  {a}: {prefills} prefills, {steps_run} decode steps, all "
              f"cuda_fused; launches {per_arch[a]} = ({prefills}, "
              f"{steps_run}); decode p50 {st['p50_s'] * 1e3:.4f} ms p99 "
              f"{st['p99_s'] * 1e3:.4f} ms (host clock, synchronized); "
              f"streams == eager; logits vs reference {e:.3g}", flush=True)
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the sLSTM path never launched: {launches}")
    for n in SLSTM:              # rows 9 and 8: the warp route every call
        got, shapes = SLSTM_ROUTES[n], SLSTM_SHAPES[n]
        check(got and set(got) == set(shapes)
              and sum(shapes.values()) == launches[n]
              and all(r == {"warp"} for r in got.values()),
              f"{n}: served calls {shapes} ({launches[n]} launches) "
              f"launched {got}, not the warp route every time")
        print(f"  {n}: the warp route at every served call ({launches[n]};"
              f" {dict(sorted(shapes.items()))}); last_plan "
              f"{getattr(SK, n).last_plan}", flush=True)
    return launches, report


# ---------------------------------------------------------------------------
# 8b. the tuning loop: served timings choose the backend, wave and buckets
# ---------------------------------------------------------------------------

TUNE_ARCH = "gru-jet-deep"
TUNE_RECAL_STEPS = 16          # slstm-jet's fold threshold (warm steps)
SLSTM_TUNE_WAVES = (3, 4, 5)   # slstm-jet's request seeds, a wave each


def tuning_rows(cfg, p50_us: dict) -> list:
    """Calibration rows (the CostModel's schema) of ``cfg``'s decode at
    :data:`SLOTS`, one per served backend."""
    g = cfg.gru
    return [{"family": g.family, "backend": b, "op": "decode",
             "depth": g.resolved_num_layers,
             "hidden_dim": g.resolved_layer_dims[0], "batch": SLOTS,
             "p50_us": us} for b, us in p50_us.items()]


def stream_waves(eng, cfg, seeds):
    """Serve one wave of :data:`REQUESTS` requests per seed; the class
    streams of all of them."""
    from repro_torch.launch.serve import make_requests
    out = []
    for seed in seeds:
        reqs = make_requests(cfg, REQUESTS, MAX_PROMPT, True, MAX_NEW, seed)
        out += [r.out for r in eng.generate(reqs)]
    return out


def run_tuning_path(torch, dev):
    """The measured table, a forced flip and a real recalibration, with
    every launch counter set to 0 just before and the plain versions
    watched: (1) gru-jet-deep served at 8 slots pinned to cuda_fused,
    cuda_chain and eager (SystemClock); their p50s become a CostModel, and
    ``compile(backend="cuda", batch=8, mode="decode")`` must choose the
    faster kernel backend; (2) that table swapped between the two kernel
    backends: an autotuned engine (recalibration off) must serve its next
    wave on the other one, launching its kernel, with streams equal to an
    untuned engine's; (3) slstm-jet served at 8 slots pinned to cuda_fused
    and eager, their p50s a CostModel; an autotuned engine under "auto"
    with recalibration on serves three waves, and after each the table in
    force (folds included) must choose its decode backend by measured cost;
    streams equal to the untuned and eager engines'; then every sLSTM
    call the phase served is held against its plain version."""
    from repro_torch.configs.base import get_config
    from repro_torch.core import runtime
    from repro_torch.core.params import init_params
    from repro_torch.kernels.gru_sequence import kernel as K
    from repro_torch.kernels.slstm_cell import kernel as SK
    from repro_torch.models import gru_lm, slstm_lm
    from repro_torch.serve.autotune import AutoTuneConfig, AutoTuner
    from repro_torch.serve.engine import ServeEngine
    kernels = K.KERNELS + SK.SLSTM_KERNELS
    static = runtime.CostModel({}, source="<chip_smoke: static>")
    runtime.set_cost_model(static)
    cfg = get_config(TUNE_ARCH)
    params = init_params(gru_lm.lm_specs(cfg), seed=0, device=dev)
    ccfg = cfg.replace(gru=dataclasses.replace(cfg.gru, backend="cuda"))
    scfg = get_config("slstm-jet")
    scfg = scfg.replace(gru=dataclasses.replace(scfg.gru, backend="auto"))
    sparams = init_params(slstm_lm.lm_specs(scfg), seed=0, device=dev)
    report = {}
    before = {n: dict(SLSTM_SHAPES[n]) for n in SLSTM}
    K.reset_launch_counts()
    with plain_calls() as plain, sequence_shapes(SEQ_SHAPES), \
            decode_calls(), prefill_calls(), slstm_calls():
        # (1) the measured table
        p50 = {}
        for b in ("cuda_fused", "cuda_chain", "eager"):
            eng, _ = serve(cfg, params, b, dev)
            st = eng.latency_stats()
            check(st["decode_backend_steps"] == {b: st["steps"]},
                  f"8b: {b} steps {st['decode_backend_steps']}")
            p50[b] = st["p50_s"] * 1e6
        rows = tuning_rows(cfg, p50)
        runtime.set_cost_model(runtime.CostModel.from_entries(
            rows, source="<chip_smoke: served p50>"))
        exe = runtime.compile(ccfg.gru, batch=SLOTS, mode="decode")
        won = min(("cuda_fused", "cuda_chain"), key=p50.get)
        lost = ({"cuda_fused", "cuda_chain"} - {won}).pop()
        check(exe.decode_backend == won and exe.cost_source == "measured",
              f"8b: measured table {p50} chose {exe.describe()}")
        print(f"  {TUNE_ARCH} at {SLOTS} slots, served decode p50 (host "
              f"clock, synchronized): " + ", ".join(
                  f"{b} {us:.2f} us" for b, us in p50.items())
              + f"; compile(backend='cuda', batch={SLOTS}, mode='decode') "
              f"-> {exe.decode_backend} (measured)", flush=True)
        report["served_p50_us"] = p50
        report["measured_choice"] = exe.decode_backend
        # (2) the forced flip at the next boundary
        tuner = AutoTuner(AutoTuneConfig(recalibrate=False,
                                         tune_wave_size=False,
                                         tune_buckets=False))
        eng = ServeEngine(ccfg, params, max_batch=SLOTS, device=dev,
                          tuner=tuner)
        tuned = stream_waves(eng, ccfg, (3,))
        steps1 = dict(eng.latency_stats()["decode_backend_steps"])
        check(steps1 == {won: eng.latency_stats()["steps"]},
              f"8b: first wave's steps {steps1}, not all {won}")
        inverted = {won: p50[lost], lost: p50[won], "eager": p50["eager"]}
        runtime.set_cost_model(runtime.CostModel.from_entries(
            tuning_rows(cfg, inverted), source="<chip_smoke: inverted>"))
        check(eng.refresh_executables(), "8b: the inverted table changed "
              "no frozen executable at the boundary")
        row = ("gru_sequence_kernel" if lost == "cuda_chain"
               else "gru_stack_decode_kernel")
        n0 = getattr(K, row).launches
        tuned += stream_waves(eng, ccfg, (4,))
        flip_launches = getattr(K, row).launches - n0
        steps = eng.latency_stats()["decode_backend_steps"]
        n2 = eng.latency_stats()["steps"] - sum(steps1.values())
        check(steps.get(lost, 0) == n2 > 0 and steps.get(won) == steps1[won]
              and flip_launches > 0,
              f"8b: after the inverted table, steps {steps} ({n2} in the "
              f"second wave), {row} launched {flip_launches} times")
        runtime.set_cost_model(static)
        untuned = stream_waves(ServeEngine(ccfg, params, max_batch=SLOTS,
                                           device=dev), ccfg, (3, 4))
        check(tuned == untuned, "8b: the flipped engine's class streams "
              "differ from an untuned engine's")
        print(f"  forced flip: wave 1 on {won}, inverted table, wave 2 on "
              f"{lost} ({n2} steps, {row} launched {flip_launches} times); "
              f"decode_backend_steps {steps}; streams == untuned", flush=True)
        report["flip"] = {"from": won, "to": lost, "steps": steps,
                          "flip_row": row, "flip_launches": flip_launches,
                          "streams_equal_untuned": True}
        # (3) a real recalibration on slstm-jet: a measured table seeded
        # with the served p50s of both its backends, under "auto"
        runtime.set_cost_model(static)
        s_streams, s_p50 = {}, {}
        for b in ("cuda_fused", "eager"):
            bcfg = scfg.replace(gru=dataclasses.replace(scfg.gru, backend=b))
            beng = ServeEngine(bcfg, sparams, max_batch=SLOTS, device=dev)
            s_streams[b] = stream_waves(beng, bcfg, SLSTM_TUNE_WAVES)
            s_p50[b] = beng.latency_stats()["p50_s"] * 1e6
        check(s_streams["cuda_fused"] == s_streams["eager"], "8b: slstm-jet's"
              " cuda_fused streams differ from the eager engine's")
        runtime.set_cost_model(runtime.CostModel.from_entries(
            tuning_rows(scfg, s_p50), source="<chip_smoke: slstm p50>"))
        stuner = AutoTuner(AutoTuneConfig(recal_min_steps=TUNE_RECAL_STEPS))
        seng = ServeEngine(scfg, sparams, max_batch=SLOTS, device=dev,
                           tuner=stuner)
        epoch0 = runtime.cost_epoch()
        s_tuned, choices, seen = [], [], 0
        for seed in SLSTM_TUNE_WAVES:
            s_tuned += stream_waves(seng, scfg, (seed,))
            folds = sum(d["kind"] == "recalibrate"
                        for d in stuner.decisions[seen:])
            seen = len(stuner.decisions)
            exe = runtime.compile(scfg.gru, batch=seng.max_batch,
                                  mode="decode")
            model = runtime.cost_model()
            g = scfg.gru
            priced = {b: model.lookup(b, "decode",
                                      depth=g.resolved_num_layers,
                                      batch=seng.max_batch,
                                      hidden=g.resolved_layer_dims[0],
                                      family=g.family)
                      for b in ("cuda_fused", "eager")}
            check(exe.cost_source == "measured"
                  and exe.decode_backend == min(priced, key=priced.get),
                  f"8b: slstm-jet after wave {seed} ({folds} folds): "
                  f"{exe.describe()} under {priced}")
            choices.append({"wave": seed, "folds": folds,
                            "epoch": runtime.cost_epoch(),
                            "priced_us": priced,
                            "choice": exe.decode_backend})
        check(s_tuned == s_streams["cuda_fused"], "8b: slstm-jet's "
              "recalibrating engine's class streams differ from an untuned "
              "engine's and the eager engine's")
        decisions = stuner.decisions
        check(any(d["kind"] == "recalibrate" for d in decisions),
              f"8b: slstm-jet folded no served timing: {decisions}")
        for d in decisions:
            print(f"  slstm-jet [{d['kind']}] {d['from']} -> {d['to']} "
                  f"({d['measurement'].get('rule', '')})", flush=True)
        sst = seng.latency_stats()
        folded = [(e["backend"], e["batch"], round(e["p50_us"], 2))
                  for d in decisions if d["kind"] == "recalibrate"
                  for e in d["measurement"]["entries"]]
        print(f"  slstm-jet at {SLOTS} slots, served decode p50 (host clock, "
              f"synchronized): " + ", ".join(
                  f"{b} {us:.2f} us" for b, us in s_p50.items())
              + "; measured choice after each wave (backend='auto'): "
              + "; ".join(f"wave {c['wave']} ({c['folds']} folds, epoch "
                          f"{c['epoch']}) {c['choice']} under "
                          + ", ".join(f"{b} {us:.2f}" for b, us in
                                      c["priced_us"].items())
                          for c in choices), flush=True)
        print(f"  slstm-jet: cost epoch {epoch0} -> {runtime.cost_epoch()}; "
              f"wave {sst['autotune']['wave_size']}, buckets "
              f"{sst['autotune']['bucket_ladder'] or 'pow2'}; decode steps "
              f"{sst['decode_backend_steps']}; folded rows (backend, batch, "
              f"p50 us) {folded}; streams == untuned == eager", flush=True)
        report["slstm_recalibration"] = {
            "served_p50_us": s_p50, "choices": choices,
            "epoch_from": epoch0, "epoch_to": runtime.cost_epoch(),
            "decisions": [{k: d[k] for k in ("kind", "from", "to")}
                          for d in decisions],
            "decode_backend_steps": sst["decode_backend_steps"],
            "streams_equal_untuned_and_eager": True}
    runtime.set_cost_model(static)
    launches = {k.__name__: k.launches for k in kernels}
    others = {k.__name__: k.launches
              for k in (K.Q8_KERNELS + K.CHAIN_Q8_KERNELS + K.ATTN_KERNELS
                        + K.ROWWISE_KERNELS + K.SHARD_KERNELS)}
    print(f"  launches: {launches}; other kernels {others}; plain versions "
          f"{plain}", flush=True)
    check(not any(others.values()), f"8b: other kernels ran {others}")
    check(not any(plain.values()), f"8b: plain versions ran {plain}")
    check(all(n > 0 for n in launches.values()),
          f"8b: a kernel of the tuning path never launched: {launches}")
    report["launches"] = launches
    # every sLSTM call this phase served (the tuned ladders give ragged T),
    # held against its plain version: made after the counts were read
    served = {n: {k: c - before[n].get(k, 0)
                  for k, c in SLSTM_SHAPES[n].items()
                  if c > before[n].get(k, 0)} for n in SLSTM}
    report["served_shape_err"] = check_slstm_shapes(torch, dev, served)
    return launches, report


def check_slstm_shapes(torch, dev, served) -> dict:
    """Hold each sLSTM kernel against its plain version at every served
    shape in ``served`` (``{name: {(L, B, H) or (L, T, B, H): calls}}``),
    by phase 3's rules: finite, within :data:`TOL`, the launch its plan
    names, bit for bit its forced block route, and (masked, B > 1) the
    fully masked row's leaves unmoved; masked and unmasked where T > 1.
    The largest error per kernel."""
    from repro_torch.kernels.slstm_cell import kernel as SK
    err, n_checks = {n: 0.0 for n in SLSTM}, 0
    for name, shapes in served.items():
        for key in sorted(shapes):
            L, T, B, H = ((key[0], 1) + key[1:] if len(key) == 3 else key)
            a = make_slstm_inputs(torch, L, H, B, T, B * 100 + T, dev)
            for masked in ((False,) if T == 1 else (False, True)):
                got = run_slstm_kernel(name, a, masked, plain=False)
                want = run_slstm_kernel(name, a, masked, plain=True)
                plan, forced = slstm_routes(torch, name, a, masked)
                p = getattr(SK, name).last_plan
                blk = forced()
                torch.cuda.synchronize()
                where = f"{name} L={L} T={T} B={B} H={H} masked={masked}"
                check(all(bool(torch.isfinite(g_).all()) for g_ in got),
                      f"{where}: non-finite output")
                e = max((g_ - w_).abs().max().item()
                        for g_, w_ in zip(got, want))
                err[name] = max(err[name], e)
                check(e <= TOL, f"{where}: max |err| {e:.3g} > {TOL}")
                check(p == plan, f"{where}: launched {p}, its plan {plan}")
                check(all(torch.equal(x, y) for x, y in zip(got, blk)),
                      f"{where}: the launch {p} differs from the block "
                      f"route")
                if name == "slstm_stack_sequence_kernel" and masked and B > 1:
                    for k, leaf in enumerate(a["leaves"]):
                        check(torch.equal(got[1 + k][:, 0], leaf[:, 0]),
                              f"{where}: the fully masked row's leaf {k} "
                              f"moved")
                n_checks += 1
        print(f"  {name} at the {len(shapes)} shapes this phase served "
              f"({dict(sorted(shapes.items()))}): max |kernel - plain| = "
              f"{err[name]:.3g} (<= {TOL}), bit for bit its block route",
              flush=True)
    check(all(served.values()), f"8b: an sLSTM kernel served no call {served}")
    print(f"  {n_checks} served-shape kernel/plain comparisons passed",
          flush=True)
    return err


# ---------------------------------------------------------------------------
# 8c. the serving fleet: replicas, faults and the asyncio front end
# ---------------------------------------------------------------------------

FLEET_REQUESTS, FLEET_CLIENTS = 24, 16
FLEET_ROWS = ("gru_sequence_kernel", "gru_stack_sequence_kernel",
              "gru_stack_decode_kernel") + SLSTM
CLI_TIMEOUT_S = 300


@contextlib.contextmanager
def engine_calls():
    """Record every prefill and decode step that any ``ServeEngine`` serves
    while the block runs (the engines of killed replicas too): the backend
    each ran on and the thread that ran it."""
    import threading
    from repro_torch.serve.engine import ServeEngine
    seen = {"prefills": [], "steps": [], "threads": set()}
    prefill, step = ServeEngine._gru_prefill, ServeEngine.gru_wave_step

    def counted_prefill(self, prompts):
        out = prefill(self, prompts)
        seen["prefills"].append(self.prefill_backends[-1])
        seen["threads"].add(threading.current_thread().name)
        return out

    def counted_step(self):
        stepping = self._wave is not None
        out = step(self)
        if stepping:
            seen["steps"].append(self.decode_backend)
            seen["threads"].add(threading.current_thread().name)
        return out
    ServeEngine._gru_prefill = counted_prefill
    ServeEngine.gru_wave_step = counted_step
    try:
        yield seen
    finally:
        ServeEngine._gru_prefill = prefill
        ServeEngine.gru_wave_step = step


def fleet_shape_counts() -> dict:
    """The calls of rows 1, 2, 3, 8 and 9 recorded so far, by shape."""
    return {"gru_sequence_kernel": dict(SEQ_SHAPES),
            "gru_stack_sequence_kernel": dict(
                PREFILL_SHAPES["gru_stack_sequence_kernel"]),
            "gru_stack_decode_kernel": dict(
                DECODE_SHAPES["gru_stack_decode_kernel"]),
            **{n: dict(SLSTM_SHAPES[n]) for n in SLSTM}}


def fleet_routes(name) -> dict:
    if name == "gru_sequence_kernel":
        return SEQ_ROUTES
    if name in SLSTM:
        return SLSTM_ROUTES[name]
    if name in PREFILLS:
        return PREFILL_ROUTES[name]
    return DECODE_ROUTES[name]


def counted_fleet_run(label, fn, want_rows):
    """Run ``fn()`` with every launch counter at 0 just before, the plain
    versions watched and every engine's prefills and steps recorded; the
    kernels of ``want_rows`` (``(prefill row, decode row)``) must launch
    once per prefill and per decode step served, no other kernel and no
    plain version may run, every prefill and step must be on
    ``cuda_fused`` and every served call on its warp route. Returns
    ``fn``'s result, the launches of rows 1, 2, 3, 8 and 9, the engine
    record and the calls by shape."""
    from repro_torch.kernels.gru_sequence import kernel as K
    from repro_torch.kernels.slstm_cell import kernel as SK
    before = fleet_shape_counts()
    K.reset_launch_counts()
    with plain_calls() as plain, sequence_shapes(SEQ_SHAPES), \
            decode_calls(), prefill_calls(), slstm_calls(), \
            engine_calls() as seen:
        result = fn()
    every = (K.KERNELS + K.Q8_KERNELS + K.CHAIN_Q8_KERNELS
             + SK.SLSTM_KERNELS + K.ATTN_KERNELS + K.ROWWISE_KERNELS
             + K.SHARD_KERNELS)
    counts = {k.__name__: k.launches for k in every}
    launches = {n: counts[n] for n in FLEET_ROWS}
    want = {n: 0 for n in counts}
    want[want_rows[0]] = len(seen["prefills"])
    want[want_rows[1]] = len(seen["steps"])
    print(f"  {label}: {len(seen['prefills'])} prefills, "
          f"{len(seen['steps'])} decode steps; launches "
          f"{ {n: c for n, c in counts.items() if c} }; plain versions "
          f"{ {n: c for n, c in plain.items() if c} }", flush=True)
    check(counts == want, f"8c {label}: launches {counts} != one "
          f"{want_rows[0]} per prefill and one {want_rows[1]} per decode "
          f"step ({len(seen['prefills'])}, {len(seen['steps'])})")
    check(not any(plain.values()), f"8c {label}: plain versions ran {plain}")
    check(seen["prefills"] and seen["steps"]
          and set(seen["prefills"]) == set(seen["steps"]) == {"cuda_fused"},
          f"8c {label}: prefills on {set(seen['prefills'])}, steps on "
          f"{set(seen['steps'])}, not all cuda_fused")
    after = fleet_shape_counts()
    served = {n: {k: c - before[n].get(k, 0) for k, c in after[n].items()
                  if c > before[n].get(k, 0)} for n in FLEET_ROWS}
    for n in want_rows:
        routes = fleet_routes(n)
        got = {k: routes.get(k) for k in served[n]}
        check(sum(served[n].values()) == launches[n]
              and all(r == {"warp"} for r in got.values()),
              f"8c {label}: {n}'s served calls {served[n]} "
              f"({launches[n]} launches) launched {got}, not the warp "
              f"route every time")
    return result, launches, seen, served


def fleet_line(label, s, clock_name):
    """The printed summary of one fleet run: e2e and queue-wait tails, each
    replica's decode tails, retries and hedges."""
    reps = "; ".join(
        f"{name} decode p50 {r['decode_p50_s'] * 1e3:.4f} ms p99 "
        f"{r['decode_p99_s'] * 1e3:.4f} ms ({r['steps']} steps, "
        f"{r['restarts']} restarts)" for name, r in s["replicas"].items())
    print(f"  {label} [{clock_name}]: completed {s['completed']}/"
          f"{s['submitted']}, failed {s['failed']}, cancelled "
          f"{s['cancelled']}, shed {s['shed']}; e2e p50 "
          f"{s['e2e_p50_s'] * 1e3:.4f} ms p99 {s['e2e_p99_s'] * 1e3:.4f} "
          f"ms; queue wait p99 {s['queue_wait_p99_s'] * 1e3:.4f} ms; "
          f"retries {s['retries']}, hedges {s['hedges']} "
          f"({s['hedges_cancelled']} cancelled), kills {s['kills']}, "
          f"restores {s['restores']}; {reps}", flush=True)


def fleet_report(s) -> dict:
    keys = ("submitted", "completed", "failed", "cancelled", "retries",
            "hedges", "hedges_cancelled", "kills", "restores", "ticks",
            "e2e_p50_s", "e2e_p99_s", "queue_wait_p99_s")
    return {**{k: s[k] for k in keys}, "shed": s["shed"],
            "replicas": {n: {k: r[k] for k in ("steps", "restarts",
                                               "decode_p50_s",
                                               "decode_p99_s")}
                         for n, r in s["replicas"].items()}}


def fleet_requests(cfg, n, seed):
    from repro_torch.launch.serve import make_requests
    return make_requests(cfg, n, MAX_PROMPT, True, MAX_NEW, seed)


def engine_streams(cfg, params, dev, n, seed, backend="cuda"):
    """The class streams of one engine at :data:`SLOTS` slots."""
    from repro_torch.serve.engine import ServeEngine
    cfg = cfg.replace(gru=dataclasses.replace(cfg.gru, backend=backend))
    return [r.out for r in ServeEngine(cfg, params, max_batch=SLOTS,
                                       device=dev).generate(
        fleet_requests(cfg, n, seed))]


@contextlib.contextmanager
def restart_watch(torch, dev):
    """Record every replica restart while the block runs: the device memory
    allocated just before and just after it, and whether the dropped engine
    was released (nothing holds it once replaced)."""
    import gc
    import weakref
    from repro_torch.serve.fleet import FleetReplica
    restarts, restart = [], FleetReplica.restart

    def allocated():
        return (torch.cuda.memory_allocated(dev) if dev.type == "cuda"
                else 0)

    def watched(self):
        old = weakref.ref(self.engine)
        m0 = allocated()
        restart(self)
        gc.collect()
        restarts.append({"replica": self.name, "steps": self.steps,
                         "allocated_before": m0,
                         "allocated_after": allocated(),
                         "released": old() is None})
    FleetReplica.restart = watched
    try:
        yield restarts
    finally:
        FleetReplica.restart = restart


def run_fleet_path(torch, dev):
    """Phase 8c: (a) gru-jet-deep on a two-replica fleet under the real
    clock; (b) the same requests on three replicas under a ManualClock with
    replica0 killed and restored and replica1 slowed (hedges); (c) gru-jet
    through the asyncio front end, 16 client coroutines, one cancelled
    mid-stream; (d) slstm-jet with a kill and a restore; (e) the CLI's
    fleet modes in their own processes. Counters are zeroed just before
    each part; every served shape not in phase 3 is then held against its
    plain version."""
    import asyncio
    import gc
    from repro_torch.configs.base import get_config
    from repro_torch.core.params import init_params
    from repro_torch.models import gru_lm, slstm_lm
    from repro_torch.serve.async_frontend import AsyncFleetClient
    from repro_torch.serve.clock import ManualClock
    from repro_torch.serve.fleet import (FaultEvent, FaultInjector,
                                         FleetConfig, FleetRouter)
    t_phase = time.monotonic()
    total = {n: 0 for n in FLEET_ROWS}
    served_all = {n: {} for n in FLEET_ROWS}
    report = {}

    def add(launches, served):
        for n in FLEET_ROWS:
            total[n] += launches[n]
            for k, c in served[n].items():
                served_all[n][k] = served_all[n].get(k, 0) + c

    def cuda(cfg):
        return cfg.replace(gru=dataclasses.replace(cfg.gru, backend="cuda"))

    deep = cuda(get_config("gru-jet-deep"))
    deep_params = init_params(gru_lm.lm_specs(deep), seed=0, device=dev)
    rows_gru_deep = ("gru_stack_sequence_kernel", "gru_stack_decode_kernel")

    def engine_s(router):
        """Host seconds of the replicas' recorded prefills and steps."""
        return sum(sum(r.engine.step_times) + sum(r.engine.prefill_times)
                   for r in router.replicas)

    # (a) fault-free, real clock, FleetConfig() defaults, depth routing
    def part_a():
        router = FleetRouter(deep, deep_params, replicas=2, max_batch=SLOTS,
                             config=FleetConfig(), device=dev)
        reqs = fleet_requests(deep, FLEET_REQUESTS, seed=8)
        t0 = time.monotonic()
        router.generate(reqs)
        return router, reqs, time.monotonic() - t0
    t_part = time.monotonic()
    (router, reqs, wall), launches, seen, served = counted_fleet_run(
        "(a) gru-jet-deep, 2 replicas, SystemClock", part_a, rows_gru_deep)
    add(launches, served)
    s = router.stats()
    fleet_line("(a) gru-jet-deep, 2 replicas", s, "host clock")
    print(f"  (a) generate() {wall * 1e3:.4f} ms over {s['ticks']} ticks "
          f"({wall / s['ticks'] * 1e3:.4f} ms a tick); the replicas' "
          f"recorded prefills and steps {engine_s(router) * 1e3:.4f} ms "
          f"of it (host clock)", flush=True)
    streams_a = [r.out for r in reqs]
    check(s["completed"] == s["submitted"] == FLEET_REQUESTS
          and s["failed"] == 0 and not s["shed"],
          f"8c (a): {fleet_report(s)}")
    check(len(seen["steps"]) == sum(r.steps for r in router.replicas),
          "8c (a): the engines' steps differ from the replicas' count")
    solo = engine_streams(deep, deep_params, dev, FLEET_REQUESTS, 8)
    eager = engine_streams(deep, deep_params, dev, FLEET_REQUESTS, 8,
                           "eager")
    check(streams_a == solo == eager, "8c (a): the fleet's class streams "
          "differ from one engine's at 8 slots or the eager engine's")
    check(all(len(x) == MAX_NEW for x in streams_a),
          f"8c (a): stream lengths {[len(x) for x in streams_a]}")
    report["a"] = {**fleet_report(s), "launches": launches,
                   "streams_equal_engine_and_eager": True, "wall_s": wall,
                   "engine_s": engine_s(router),
                   "part_s": time.monotonic() - t_part}
    del router

    # (b) ManualClock: kill replica0 while it holds flights, restore it,
    # slow replica1 6x. Three replicas: the straggler monitor compares a
    # replica's median step with the median of all replicas' medians, and
    # of two replicas neither median can exceed 3x their mean.
    def part_b():
        schedule = FaultInjector([
            FaultEvent(t=0.05, kind="kill", replica="replica0"),
            FaultEvent(t=0.06, kind="slow", replica="replica1", factor=6.0),
            FaultEvent(t=0.20, kind="restore", replica="replica0"),
            FaultEvent(t=0.80, kind="slow", replica="replica1", factor=1.0)])
        router = FleetRouter(deep, deep_params, replicas=3, max_batch=SLOTS,
                             clock=ManualClock(),
                             config=FleetConfig(heartbeat_timeout_s=0.05,
                                                tick_s=0.01),
                             injector=schedule, device=dev)
        reqs = fleet_requests(deep, FLEET_REQUESTS, seed=8)
        with restart_watch(torch, dev) as restarts:
            router.generate(reqs)
        return router, reqs, restarts
    gc.collect()
    t_part = time.monotonic()
    m_before = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    (router, reqs, restarts), launches, seen, served = counted_fleet_run(
        "(b) gru-jet-deep, 3 replicas, ManualClock, kill/restore/slow",
        part_b, rows_gru_deep)
    add(launches, served)
    s = router.stats()
    fleet_line("(b) gru-jet-deep, 3 replicas, faults", s, "virtual clock")
    rep0 = router.replicas[0]
    check(s["kills"] >= 1 and s["restores"] >= 1 and s["hedges"] >= 1
          and s["retries"] >= 1, f"8c (b): a fault did not act: "
          f"{fleet_report(s)}")
    check(s["completed"] == s["submitted"] == FLEET_REQUESTS
          and s["failed"] == 0, f"8c (b): {fleet_report(s)}")
    check([r.out for r in reqs] == streams_a,
          "8c (b): the faulted fleet's class streams differ from (a)'s")
    check(len(restarts) == 1 and restarts[0]["released"]
          and restarts[0]["allocated_after"]
          <= restarts[0]["allocated_before"],
          f"8c (b): the restart kept the dropped engine's tensors: "
          f"{restarts}")
    check(rep0.steps > restarts[0]["steps"]
          and set(rep0.engine.prefill_backends) == {"cuda_fused"}
          and set(rep0.engine.decode_backends) == {"cuda_fused"},
          f"8c (b): the restored replica served "
          f"{rep0.steps - restarts[0]['steps']} steps after its restart, on "
          f"{set(rep0.engine.decode_backends)}")
    m_after = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    del router, rep0
    gc.collect()
    m_freed = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    print(f"  (b) torch.cuda.memory_allocated: {m_before} B before, "
          f"{m_after} B after the run, {m_freed} B once the router is "
          f"dropped; at the restart {restarts[0]['allocated_before']} B -> "
          f"{restarts[0]['allocated_after']} B (the dropped engine "
          f"released); replica0 served "
          f"{s['replicas']['replica0']['steps'] - restarts[0]['steps']} "
          f"steps after it, all cuda_fused", flush=True)
    report["b"] = {**fleet_report(s), "launches": launches,
                   "memory_allocated": [m_before, m_after, m_freed],
                   "restart": restarts[0], "streams_equal_a": True,
                   "part_s": time.monotonic() - t_part}

    # (c) the asyncio front end: gru-jet, 16 concurrent clients, one gone
    jet = cuda(get_config("gru-jet"))
    jet_params = init_params(gru_lm.lm_specs(jet), seed=0, device=dev)

    def part_c():
        router = FleetRouter(jet, jet_params, replicas=2, max_batch=SLOTS,
                             device=dev)
        reqs = fleet_requests(jet, FLEET_CLIENTS, seed=9)
        streamed = [None] * len(reqs)
        tick, in_ticks = router.tick, []

        def timed_tick(*a, **kw):       # on the worker thread
            t0 = time.monotonic()
            out = tick(*a, **kw)
            in_ticks.append(time.monotonic() - t0)
            return out
        router.tick = timed_tick

        async def client(c, i, first_token):
            handle = await c.submit(reqs[i])
            toks = streamed[i] = []
            async for tok in handle:
                toks.append(tok)
                first_token.set()
            streamed[i] = toks

        async def main():
            async with AsyncFleetClient(router) as c:
                first = asyncio.Event()
                victim = asyncio.create_task(client(c, 0, first))
                others = [asyncio.create_task(client(c, i, asyncio.Event()))
                          for i in range(1, len(reqs))]
                await first.wait()
                victim.cancel()
                await asyncio.gather(victim, *others,
                                     return_exceptions=True)
        t0 = time.monotonic()
        asyncio.run(main())        # the counters are read after it closed
        return router, reqs, streamed, time.monotonic() - t0, sum(in_ticks)
    t_part = time.monotonic()
    (router, reqs, streamed, wall, ticking), launches, seen, served = \
        counted_fleet_run("(c) gru-jet, async front end, 16 clients",
                          part_c, ("gru_sequence_kernel",
                                   "gru_stack_decode_kernel"))
    add(launches, served)
    s = router.stats()
    fleet_line("(c) gru-jet, 2 replicas, async front end", s, "host clock")
    print(f"  (c) asyncio.run {wall * 1e3:.4f} ms, {s['ticks']} ticks "
          f"taking {ticking * 1e3:.4f} ms on the worker thread, the "
          f"replicas' recorded prefills and steps "
          f"{engine_s(router) * 1e3:.4f} ms of them (host clock)",
          flush=True)
    solo = engine_streams(jet, jet_params, dev, FLEET_CLIENTS, 9)
    victim = router.tickets[[t.request for t in router.tickets].index(
        reqs[0])]
    check(victim.status == "cancelled" and not reqs[0].done
          and s["cancelled"] == 1 and 0 < len(streamed[0]) < MAX_NEW,
          f"8c (c): the disconnected client's ticket is {victim.status}")
    check(all(streamed[i] == reqs[i].out == solo[i]
              for i in range(1, len(reqs))),
          "8c (c): a client's stream differs from its request.out or from "
          "one engine's stream")
    check(s["completed"] == FLEET_CLIENTS - 1 and s["failed"] == 0,
          f"8c (c): {fleet_report(s)}")
    check(seen["threads"] and all(t.startswith("fleet-tick")
                                  for t in seen["threads"]),
          f"8c (c): prefills and steps ran on {seen['threads']}, not the "
          f"front end's worker thread")
    print(f"  (c) every prefill and step on thread(s) "
          f"{sorted(seen['threads'])}; client 0 cancelled after "
          f"{len(streamed[0])} of its {MAX_NEW} classes streamed, "
          f"{FLEET_CLIENTS - 1} streams == request.out == one engine's",
          flush=True)
    report["c"] = {**fleet_report(s), "launches": launches,
                   "threads": sorted(seen["threads"]), "wall_s": wall,
                   "tick_s": ticking, "engine_s": engine_s(router),
                   "part_s": time.monotonic() - t_part}
    del router

    # (d) slstm-jet: 2 replicas, kill and restore under a ManualClock
    sj = cuda(get_config("slstm-jet"))
    sj_params = init_params(slstm_lm.lm_specs(sj), seed=0, device=dev)

    def part_d():
        router = FleetRouter(sj, sj_params, replicas=2, max_batch=SLOTS,
                             clock=ManualClock(),
                             config=FleetConfig(heartbeat_timeout_s=0.05,
                                                tick_s=0.01),
                             injector=FaultInjector([
                                 FaultEvent(t=0.05, kind="kill",
                                            replica="replica0"),
                                 FaultEvent(t=0.20, kind="restore",
                                            replica="replica0")]),
                             device=dev)
        reqs = fleet_requests(sj, FLEET_REQUESTS, seed=10)
        router.generate(reqs)
        return router, reqs
    t_part = time.monotonic()
    (router, reqs), launches, seen, served = counted_fleet_run(
        "(d) slstm-jet, 2 replicas, ManualClock, kill/restore", part_d,
        SLSTM)
    add(launches, served)
    s = router.stats()
    fleet_line("(d) slstm-jet, 2 replicas, faults", s, "virtual clock")
    solo = engine_streams(sj, sj_params, dev, FLEET_REQUESTS, 10)
    check(s["kills"] == 1 and s["restores"] == 1 and s["failed"] == 0
          and s["completed"] == FLEET_REQUESTS, f"8c (d): {fleet_report(s)}")
    check([r.out for r in reqs] == solo, "8c (d): slstm-jet's fleet "
          "streams differ from one engine's")
    report["d"] = {**fleet_report(s), "launches": launches,
                   "part_s": time.monotonic() - t_part}
    del router

    # (e) the CLI's fleet modes, in their own processes (their launches are
    # theirs): both at once
    t_part = time.monotonic()
    report["e"] = run_fleet_cli()
    report["e"]["part_s"] = time.monotonic() - t_part

    # every served shape that phase 3 did not hold against its plain
    # version, held now (after the counts were read)
    report["served_shapes"] = {n: len(v) for n, v in served_all.items()}
    report["served_shape_err"] = check_fleet_shapes(torch, dev, served_all)
    check(all(total[n] > 0 for n in FLEET_ROWS),
          f"8c: a kernel of the fleet path never launched: {total}")
    report["launches"] = total
    report["phase_s"] = time.monotonic() - t_phase
    print(f"  phase 8c: {report['phase_s']:.1f} s (parts: " + ", ".join(
        f"{k} {report[k]['part_s']:.1f}" for k in "abcde") + ")",
        flush=True)
    return total, report


def phase3_covers(name, key) -> bool:
    """Whether phase 3 held kernel ``name`` against its plain version at
    served shape ``key`` (rows 1, 2, 3, 8, 9)."""
    if name == "gru_sequence_kernel":
        T, B, H = key
        return (T in (1, 8, 16, 32) and B in (1, 8, 64)
                and (1, H) in MAIN_SHAPES[name])
    if len(key) == 3:                  # a decode: (L, B, H)
        L, B, H = key
        return B in (1, 8, 64) and (L, H) in MAIN_SHAPES[name]
    L, T, B, H = key
    return (T in (8, 16, 32) and B in (1, 8, 64)
            and (L, H) in MAIN_SHAPES[name])


def check_fleet_shapes(torch, dev, served) -> dict:
    """Hold each fleet row against its plain version at every served shape
    phase 3 did not cover, by phase 3's rules (sLSTM: as phase 8b does);
    the largest error per kernel."""
    from repro_torch.kernels.gru_sequence import kernel as K
    from repro_torch.kernels.gru_sequence import ref
    new = {n: {k: c for k, c in shapes.items() if not phase3_covers(n, k)}
           for n, shapes in served.items()}
    print(f"  served shapes outside phase 3: "
          f"{ {n: sorted(v) for n, v in new.items() if v} or 'none'}",
          flush=True)
    err = {n: 0.0 for n in FLEET_ROWS}
    sl = {n: new[n] for n in SLSTM if new[n]}
    if sl:
        err.update(check_slstm_shapes(torch, dev, sl))
    for name in FLEET_ROWS[:3]:
        for key in sorted(new[name]):
            if name == "gru_sequence_kernel":
                (T, B, H), L = key, 1
            elif len(key) == 3:
                (L, B, H), T = key, 1
            else:
                L, T, B, H = key
            a = make_inputs(torch, L, H, B, T, B * 100 + T, dev)
            for masked in ((False,) if T == 1 else (False, True)):
                got = run_kernel(K, ref, name, a, "v1", masked, plain=False)
                want = run_kernel(K, ref, name, a, "v1", masked, plain=True)
                torch.cuda.synchronize()
                e = max((g_ - w_).abs().max().item()
                        for g_, w_ in zip(got, want))
                check(all(bool(torch.isfinite(g_).all()) for g_ in got)
                      and e <= TOL, f"{name} at served {key} masked="
                      f"{masked}: max |err| {e:.3g} > {TOL}")
                err[name] = max(err[name], e)
    return err


def run_fleet_cli() -> dict:
    """``repro_torch.launch.serve`` in fleet mode, sync and ``--async``,
    each in its own process, both started together: each must exit 0 with
    every request completed."""
    import os
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
            "gru-jet-deep", "--gru-backend", "cuda", "--replicas", "2",
            "--inject-faults", "--requests", "16", "--vary-prompt"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    runs = {"sync": base, "async": base + ["--async"]}
    procs = {k: subprocess.Popen(v, cwd=ROOT, env=env, text=True,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT)
             for k, v in runs.items()}
    out = {}
    try:
        for k, p in procs.items():
            text, _ = p.communicate(timeout=CLI_TIMEOUT_S)
            out[k] = (p.returncode, text)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    report = {}
    for k, (rc, text) in out.items():
        lines = text.splitlines()
        fleet = [ln for ln in lines if ln.startswith("fleet (")]
        print(f"  (e) CLI {k}: exit {rc}; {lines[0] if lines else ''}",
              flush=True)
        for ln in fleet + [ln for ln in lines if ln.startswith("  replica")]:
            print(f"    {ln.strip()}", flush=True)
        check(rc == 0 and fleet and "completed=16/16 failed=0" in fleet[0],
              f"8c (e): the CLI ({k}) exited {rc}:\n" + text[-3000:])
        report[k] = {"exit": rc, "fleet": fleet[0]}
    return report


# ---------------------------------------------------------------------------
# 8d. training on the card: the train CLI, checkpoints, the q8 harness
# ---------------------------------------------------------------------------

TRAIN_STEPS, RESUME_STEPS, TRAIN_BATCH = 300, 320, 64
HELD_OUT = 10_001                   # batch_at step of the held-out rows
LM_TRAIN_STEPS, LM_TRAIN_B, LM_TRAIN_S = 8, 4, 256
Q8_RUNS = (("gru-jet", {}), ("gru-jet L=3 H=32", {"depth": 3, "hidden": 32}))
COST_BATCH = SLOTS                  # the decode table's batch (tuning_rows)


@contextlib.contextmanager
def watched():
    """Every counter set to 0, the plain versions counted and the served
    shapes of rows 1, 2, 4 and 6 recorded (for phase 12) while the block
    runs: yields the plain-call counts."""
    from repro_torch.kernels.gru_sequence import kernel as K
    K.reset_launch_counts()
    with plain_calls() as plain, sequence_shapes(SEQ_SHAPES), \
            prefill_calls(), decode_calls(), step_q8_calls(), slstm_calls():
        yield plain


def launch_counts() -> dict:
    return {n: k.launches for n, k in all_kernels().items()}


def max_param_diff(a, b) -> float:
    from repro_torch.core.params import flatten
    fa, fb = flatten(a), flatten(b)
    check(set(fa) == set(fb), f"param trees differ: {set(fa) ^ set(fb)}")
    return max((fa[k].detach() - fb[k].detach()).abs().max().item()
               for k in fa)


def run_train_cli(argv):
    """``repro_torch.launch.train.main(argv)`` in this process, its lines
    echoed; returns (final state, {step: loss} of the printed lines)."""
    import io
    from repro_torch.launch.train import main as train_main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        state = train_main(argv)
    losses = {}
    for ln in buf.getvalue().splitlines():
        print(f"    {ln}", flush=True)
        m = re.match(r"step\s+(\d+) loss=(\S+)", ln)
        if m:
            losses[int(m.group(1))] = float(m.group(2))
    return state, losses


def eval_both(torch, params, arch, dev, row):
    """``params`` of ``arch`` on ``batch_at(HELD_OUT)`` (256 rows) through
    ``eager`` and through ``cuda_fused`` under ``torch.no_grad()``: the
    kernel's logits within TOL of eager's, the same classes, ``row``
    launched once for the call and nothing else, no plain version."""
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.core import gru as gru_core
    from repro_torch.data.pipeline import SyntheticStream, shard_batch
    cfg = get_config(arch)
    batch = shard_batch(SyntheticStream(cfg, ShapeConfig(
        "held_out", cfg.gru.seq_len, 256, "train")).batch_at(HELD_OUT),
        device=dev)
    out = {}
    for b in ("eager", "cuda_fused"):
        gcfg = dataclasses.replace(cfg.gru, backend=b)
        with torch.no_grad():
            before = launch_counts()
            out[b] = gru_core.gru_classify(params, batch["features"],
                                           cfg=gcfg)
            torch.cuda.synchronize()
            ran = {n: c - before[n] for n, c in launch_counts().items()
                   if c != before[n]}
        want = {} if b == "eager" else {row: 1}
        check(ran == want, f"8d: {arch} through {b} launched {ran}, "
              f"expected {want}")
    labels = batch["labels"].long()
    acc = {b: float((v.argmax(-1) == labels).float().mean())
           for b, v in out.items()}
    err = (out["cuda_fused"] - out["eager"]).abs().max().item()
    check(bool(torch.isfinite(out["eager"]).all())
          and tuple(out["eager"].shape) == (256, cfg.gru.num_classes),
          f"8d: {arch} held-out logits bad")
    check(err <= TOL, f"8d: {arch} cuda_fused logits vs eager {err:.3g}")
    check(torch.equal(out["cuda_fused"].argmax(-1), out["eager"].argmax(-1)),
          f"8d: {arch} cuda_fused classes differ from eager's")
    return acc, err, getattr(all_kernels()[row], "last_plan", None)


def train_steps(torch, cfg, tcfg, state, stream, dev, steps, start=0):
    """``steps`` steps of ``make_train_step(cfg, tcfg)`` from ``state`` on
    the stream's batches ``start..``: (state, losses, per-step seconds,
    synchronized)."""
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.train import trainer
    step_fn = trainer.make_train_step(cfg, tcfg)
    losses, secs = [], []
    for s in range(start, start + steps):
        batch = shard_batch(stream.batch_at(s), device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t0)
    return state, losses, secs


def check_no_backward(cfg, batch, dev, what):
    """A config that trains through a kernel raises at make_train_step,
    and its loss under autograd raises at the kernel wrapper, with the
    wrappers' no-backward message, on the card."""
    from repro_torch.models import api as mapi
    from repro_torch.train import trainer
    msg = "has no backward; train on backend='eager' / attn_impl='chunked'"
    params = trainer.init_state(cfg, _tcfg(5), device=dev)["params"]
    for where, fn in (
            ("make_train_step", lambda: trainer.make_train_step(
                cfg, _tcfg(5))),
            ("the kernel wrapper", lambda: mapi.get_api(cfg).loss_fn(
                params, cfg, batch))):
        try:
            fn()
        except RuntimeError as e:
            check(msg in str(e), f"8d: {what} at {where}: {e}")
            print(f"  {what}: {where} raised: {e}", flush=True)
            continue
        fail(f"8d: {what} trained through a kernel at {where} without "
             f"raising")


def _tcfg(total, lr=3e-3, warmup=5, micro=1):
    from repro_torch.configs.base import TrainConfig
    return TrainConfig(learning_rate=lr, warmup_steps=warmup,
                       total_steps=total, microbatches=micro)


def run_jet_training(torch, dev, tmp) -> dict:
    """(a): gru-jet through the train CLI, 300 steps with checkpoints,
    resumed to 320; the same state carried on in memory; held-out
    accuracy through eager and cuda_fused."""
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.core.params import map_trees
    from repro_torch.data.pipeline import SyntheticStream
    common = ["--arch", "gru-jet", "--batch", str(TRAIN_BATCH), "--lr",
              "3e-3", "--device", str(dev)]
    ck = str(tmp / "ck_gru_jet")
    with watched() as plain:
        t0 = time.perf_counter()
        first, l1 = run_train_cli(common + [
            "--steps", str(TRAIN_STEPS), "--checkpoint-dir", ck,
            "--checkpoint-every", "100", "--log-every", "100"])
        t_first = time.perf_counter() - t0
        resumed, l2 = run_train_cli(common + [
            "--steps", str(RESUME_STEPS), "--checkpoint-dir", ck, "--resume",
            "--log-every", "10"])
        ran = {n: c for n, c in launch_counts().items() if c}
        check(not ran and not any(plain.values()),
              f"8d (a): training ran kernels {ran} or plain versions "
              f"{plain}")
    # the run that never stops: the first run's state carried on in
    # memory over steps 300-319 under the resumed run's schedule
    cfg = get_config("gru-jet")
    stream = SyntheticStream(cfg, ShapeConfig("cli", cfg.gru.seq_len,
                                              TRAIN_BATCH, "train"))
    tcfg = _tcfg(RESUME_STEPS, warmup=min(20, RESUME_STEPS // 10 + 1))
    straight, _, secs = train_steps(torch, cfg, tcfg, first, stream, dev,
                                    RESUME_STEPS - TRAIN_STEPS, TRAIN_STEPS)
    step_ms = float(np.median(secs[1:])) * 1e3
    check(int(resumed["step"]) == RESUME_STEPS == int(straight["step"]),
          f"8d (a): steps {int(resumed['step'])}, {int(straight['step'])}")
    diff = max_param_diff(resumed["params"], straight["params"])
    check(diff <= 1e-6, f"8d (a): resumed params vs the straight run "
          f"{diff:.3g}")
    check(l2[RESUME_STEPS - 1] < l1[0], f"8d (a): loss at step 319 "
          f"{l2[RESUME_STEPS - 1]} not below step 0's {l1[0]}")
    params = map_trees(lambda p: p.detach(), resumed["params"])
    with watched() as plain:
        acc, err, plan = eval_both(torch, params, "gru-jet", dev,
                                   "gru_sequence_kernel")
        ran = {k: v for k, v in launch_counts().items() if v}
        check(not any(plain.values()), f"8d (a): plain versions {plain}")
    check(acc["eager"] > 0.5, f"8d (a): held-out accuracy {acc}")
    print(f"  (a) gru-jet: {TRAIN_STEPS} steps in {t_first:.2f} s "
          f"({t_first / TRAIN_STEPS * 1e3:.2f} ms/step, CLI wall clock, "
          f"checkpoints and logging included; {step_ms:.2f} ms median over "
          f"the straight run's steps, host clock, synchronized), resumed "
          f"to {RESUME_STEPS}; "
          f"loss {l1[0]} -> {l2[RESUME_STEPS - 1]}; resumed vs straight "
          f"params max diff {diff:.3g}; held-out accuracy eager "
          f"{acc['eager']:.4f} cuda_fused {acc['cuda_fused']:.4f}, logits "
          f"diff {err:.3g}; row 1 plan {plan}", flush=True)
    return {"launches": ran,
            "report": {"loss_step0": l1[0], "step_ms": step_ms,
                       "loss_step319": l2[RESUME_STEPS - 1],
                       "resume_vs_straight_max_diff": diff,
                       "cli_ms_per_step": t_first / TRAIN_STEPS * 1e3,
                       "held_out_acc": acc, "cuda_fused_logit_err": err},
            "params": params}


def micro_equivalence(torch, cfg, state0, stream, dev):
    """``microbatches=2`` against ``1`` from ``state0``: the step-0
    gradients must agree within rtol 1e-5 (atol 1e-7), and the params
    after 5 steps within 1e-5 on every element whose two step-0 gradients
    agree to 1e-3 of their size. The other elements carry gradients at
    the noise level (the sLSTM's bias, ~1e-10), where AdamW's
    mu/sqrt(nu) is +-1 in either summation order and a step differs by
    up to 2 lr: they are counted and their difference printed, not held.
    Returns (grad diff, held params diff, noise elements, params diff
    over all elements)."""
    from repro_torch.core.params import flatten
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.train import trainer
    loss_fn = trainer._loss_fn(cfg)
    batch = shard_batch(stream.batch_at(0), device=dev)
    g = {m: flatten(trainer._micro_grads(loss_fn, state0["params"], batch,
                                         m)[0]) for m in (1, 2)}
    gdiff, noise, mdiff, raw = 0.0, 0, 0.0, 0.0
    runs = {m: flatten(train_steps(torch, cfg, _tcfg(5, micro=m), state0,
                                   stream, dev, 5)[0]["params"])
            for m in (1, 2)}
    for k, g1 in g[1].items():
        d = (g1 - g[2][k]).abs()
        check(bool((d <= 1e-5 * g1.abs() + 1e-7).all()),
              f"8d (b): {cfg.name} {k}: step-0 grads of microbatches 2 vs 1 "
              f"differ by {d.max().item():.3g}")
        gdiff = max(gdiff, d.max().item())
        held = d <= 1e-3 * g1.abs()
        noise += int((~held).sum())
        pd = (runs[1][k] - runs[2][k]).abs()
        raw = max(raw, pd.max().item())
        if held.any():
            mdiff = max(mdiff, pd[held].max().item())
    check(mdiff <= 1e-5, f"8d (b): {cfg.name} microbatches 2 vs 1 over 5 "
          f"steps: {mdiff:.3g}")
    return gdiff, mdiff, noise, raw


def run_deep_training(torch, dev) -> dict:
    """(b): gru-jet-deep and slstm-jet, 50 steps each; microbatches 2
    against 1 over 5 steps from one state; the trained gru-jet-deep through
    cuda_fused (row 2) against eager."""
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.core.params import map_trees
    from repro_torch.data.pipeline import SyntheticStream
    from repro_torch.train import trainer
    out, launches = {}, {}
    for arch in ("gru-jet-deep", "slstm-jet"):
        cfg = get_config(arch)
        stream = SyntheticStream(cfg, ShapeConfig("t", cfg.gru.seq_len,
                                                  TRAIN_BATCH, "train"))
        state0 = trainer.init_state(cfg, _tcfg(50), device=dev)
        with watched() as plain:
            state, losses, secs = train_steps(torch, cfg, _tcfg(50), state0,
                                              stream, dev, 50)
            ran = {n: c for n, c in launch_counts().items() if c}
            check(not ran and not any(plain.values()),
                  f"8d (b): {arch} training ran kernels {ran} or plain "
                  f"versions {plain}")
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"8d (b): {arch} loss {losses[0]} -> {losses[-1]}")
        gdiff, mdiff, noise, raw = micro_equivalence(torch, cfg, state0,
                                                     stream, dev)
        rep = {"loss_first": losses[0], "loss_last": losses[-1],
               "ms_per_step": float(np.median(secs[1:])) * 1e3,
               "micro2_vs_micro1_grad_diff": gdiff,
               "micro2_vs_micro1_max_diff": mdiff,
               "micro2_vs_micro1_max_diff_all": raw,
               "noise_level_elements": noise}
        line = (f"  (b) {arch}: 50 steps, loss {losses[0]:.4f} -> "
                f"{losses[-1]:.4f}, step median {rep['ms_per_step']:.2f} ms "
                f"(host clock, synchronized); microbatches 2 vs 1: step-0 "
                f"grads max diff {gdiff:.3g}, params after 5 steps max diff "
                f"{mdiff:.3g} ({raw:.3g} with the {noise} noise-level "
                f"elements)")
        if arch == "gru-jet-deep":
            params = map_trees(lambda p: p.detach(), state["params"])
            with watched() as plain:
                acc, err, plan = eval_both(torch, params, arch, dev,
                                           "gru_stack_sequence_kernel")
                launches = {k: v for k, v in launch_counts().items() if v}
                check(not any(plain.values()),
                      f"8d (b): plain versions {plain}")
            rep.update(held_out_acc=acc, cuda_fused_logit_err=err)
            line += (f"; held-out eager {acc['eager']:.4f}, cuda_fused "
                     f"logits diff {err:.3g}, row 2 plan {plan}")
        out[arch] = rep
        print(line, flush=True)
    return {"launches": launches, "report": out}


def run_lm_training(torch, dev) -> dict:
    """(c): qwen3-0.6b at full width, fp32 params and bf16 compute on
    ``attn_impl="chunked"``: 8 steps at batch 4 x seq 256, then 3 steps
    timed in two parts (gradients, AdamW); ``attn_impl="cuda"`` raises."""
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.core.params import leaves
    from repro_torch.data.pipeline import SyntheticStream, shard_batch
    from repro_torch.optim import adamw
    from repro_torch.train import trainer
    cfg = get_config(LM_ARCH).replace(attn_impl="chunked")
    check(cfg.num_layers == 28 and cfg.d_model == 1024
          and cfg.vocab_size == 151_936 and cfg.dtype == "bfloat16"
          and cfg.param_dtype == "float32", f"8d (c): config {cfg}")
    stream = SyntheticStream(cfg, ShapeConfig("t", LM_TRAIN_S, LM_TRAIN_B,
                                              "train"))
    tcfg = _tcfg(LM_TRAIN_STEPS + 3, lr=1e-3, warmup=2)
    torch.cuda.reset_peak_memory_stats(dev)
    mem0 = torch.cuda.memory_allocated(dev)
    state = trainer.init_state(cfg, tcfg, device=dev)
    with watched() as plain:
        state, losses, secs = train_steps(torch, cfg, tcfg, state, stream,
                                          dev, LM_TRAIN_STEPS)
        ran = {n: c for n, c in launch_counts().items() if c}
        check(not ran and not any(plain.values()),
              f"8d (c): training ran kernels {ran} or plain versions {plain}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"8d (c): loss {losses}")
    # the same step in two timed parts: gradients, then the optimizer
    loss_fn = trainer._loss_fn(cfg)
    grad_s, opt_s = [], []
    for s in range(LM_TRAIN_STEPS, LM_TRAIN_STEPS + 3):
        batch = shard_batch(stream.batch_at(s), device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grads, _, _ = trainer._micro_grads(loss_fn, state["params"], batch, 1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        p2, o2, _ = adamw.adamw_update(state["params"], grads, state["opt"],
                                       state["step"], tcfg)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        state = {"params": p2, "opt": o2, "step": state["step"] + 1}
        del grads
        grad_s.append(t1 - t0)
        opt_s.append(t2 - t1)
    peak = torch.cuda.max_memory_allocated(dev) - mem0
    step_s = float(np.median(secs[1:]))
    opt_share = float(np.median(opt_s)) / (float(np.median(grad_s))
                                           + float(np.median(opt_s)))
    tokens = LM_TRAIN_B * LM_TRAIN_S
    n_params = sum(p.numel() for p in leaves(state["params"]))
    # AdamW's least time: fp32 p, g, mu, nu read once, p, mu, nu written
    adamw_bound = 7 * 4 * n_params / HBM_BYTES_PER_S * 1e3
    print(f"  (c) {LM_ARCH} full width ({n_params:,} params), batch "
          f"{LM_TRAIN_B} x seq {LM_TRAIN_S}: loss "
          + " ".join(f"{x:.4f}" for x in losses)
          + f"; step median {step_s * 1e3:.2f} ms (steps 1-{LM_TRAIN_STEPS - 1},"
          f" host clock, synchronized), {tokens / step_s:,.0f} tokens/s; "
          f"gradients {np.median(grad_s) * 1e3:.2f} ms + AdamW "
          f"{np.median(opt_s) * 1e3:.2f} ms (bound {adamw_bound:.2f} ms, "
          f"bytes): optimizer share {opt_share:.4f}; peak memory "
          f"{peak / 2**30:.2f} GiB above the {mem0 / 2**30:.2f} GiB held "
          f"before", flush=True)
    small = shard_batch(SyntheticStream(cfg, ShapeConfig(
        "t", 16, 2, "train")).batch_at(0), device=dev)
    del state
    torch.cuda.empty_cache()
    check_no_backward(cfg.replace(attn_impl="cuda", num_layers=2), small,
                      dev, "qwen3-0.6b attn_impl='cuda' (2 of its layers)")
    return {"report": {"losses": losses, "step_ms": step_s * 1e3,
                       "tokens_per_s": tokens / step_s,
                       "grad_ms": float(np.median(grad_s)) * 1e3,
                       "adamw_ms": float(np.median(opt_s)) * 1e3,
                       "adamw_bound_ms": adamw_bound,
                       "optimizer_share": opt_share,
                       "peak_bytes_above_start": peak,
                       "params": n_params}}


def decode_p50_us(torch, cfg, params, backend, dev, iters=50) -> float:
    """Median host time (synchronized) of one decode step of ``cfg``
    through ``backend`` at :data:`COST_BATCH` rows."""
    from repro_torch.core import gru as gru_core
    from repro_torch.core import runtime
    g = dataclasses.replace(cfg.gru, backend=backend)
    exe = runtime.compile(g, batch=COST_BATCH, mode="decode")
    sp = exe.prepare(params, device=dev)
    hs = gru_core.stack_h0(g, COST_BATCH, device=dev)
    x = torch.randn(COST_BATCH, g.input_dim, device=dev)
    ts = []
    with torch.no_grad():
        for i in range(iters + 5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            exe.decode(sp, hs, x)
            torch.cuda.synchronize()
            if i >= 5:
                ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e6


def run_q8_harness(torch, dev, tmp) -> dict:
    """(d): the q8 harness at gru-jet and at L=3 H=32 on the card: its
    numbers, each pin's logits against the CPU run of the same pin on the
    same trained params, rows 4 and 6 launched, no plain version; a passing
    artifact opens the port's gate, and ``compile(quant="int8",
    backend="cuda")`` then chooses by a table of this card's measured
    decode steps, the q8 backends among the candidates."""
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.core import runtime
    from repro_torch.core.params import map_trees
    from repro_torch.data.pipeline import SyntheticStream, shard_batch
    from repro_torch.quant import accuracy
    cpu = torch.device("cpu")
    report, launches = {}, {}
    saved_gate, saved_costs = runtime.quant_accuracy(), runtime.cost_model()
    for label, kw in Q8_RUNS:
        path = tmp / f"quant_{len(report)}.json"
        with watched() as plain:
            art, params = accuracy.run(arch="gru-jet", json_path=str(path),
                                       csv=False, device=dev,
                                       return_params=True, **kw)
            ran = {n: c for n, c in launch_counts().items() if c}
            check(not any(plain.values()), f"8d (d): plain versions {plain}")
        L = kw.get("depth", 1)
        want = {"gru_stack_sequence_q8_kernel": 8, "gru_sequence_q8_kernel":
                8 * L}
        check(ran == want, f"8d (d) {label}: launches {ran}, expected {want}")
        for k, v in ran.items():
            launches[k] = launches.get(k, 0) + v
        mcfg = get_config("gru-jet")
        gcfg = dataclasses.replace(
            mcfg.gru, num_layers=L, hidden_dim=kw.get("hidden",
                                                      mcfg.gru.hidden_dim))
        xs = shard_batch(SyntheticStream(mcfg.replace(gru=gcfg), ShapeConfig(
            "quant_eval", gcfg.seq_len, 64, "prefill")).batch_at(10_000),
            device=dev)["features"]
        pcpu = map_trees(lambda p: p.to(cpu), params)
        pin_err = {}
        for b in accuracy.Q8_BACKENDS:
            q = dataclasses.replace(gcfg, backend=b)
            got = accuracy._eval_logits(params, q, xs)
            want_l = accuracy._eval_logits(pcpu, q, xs.to(cpu))
            pin_err[b] = float(np.abs(got - want_l).max())
            check(pin_err[b] <= TOL, f"8d (d) {label}: {b} on the card vs "
                  f"the CPU run {pin_err[b]:.3g}")
        for b, m in art["backends"].items():
            print(f"  (d) {label} {b}: max_abs_logit_err "
                  f"{m['max_abs_logit_err']} argmax_match "
                  f"{m['argmax_match']} confident "
                  f"{m['argmax_match_confident']} ties {m['ties']} passed "
                  f"{m['passed']}; card vs CPU {pin_err[b]:.3g}", flush=True)
        print(f"  (d) {label}: final loss {art['final_loss']}, passed "
              f"{art['passed']} (device {art['device']})", flush=True)
        rep = {"final_loss": art["final_loss"], "passed": art["passed"],
               "backends": art["backends"], "card_vs_cpu": pin_err}
        if art["passed"]:
            cfg = mcfg.replace(gru=dataclasses.replace(
                gcfg, quant="int8", backend="cuda"))
            runtime.set_quant_accuracy(runtime.QuantAccuracy(
                {}, source="<chip_smoke 8d: closed>"))
            runtime.set_cost_model(runtime.CostModel({}, source="<static>"))
            check(not runtime.quant_gate_open(), "8d (d): gate not closed")
            runtime.load_quant_accuracy(path)
            check(runtime.quant_gate_open(), f"8d (d): {path} did not open "
                  f"the gate")
            legal = {s.name for s in runtime._REGISTRY.values()
                     if runtime._legal(s, cfg.gru, op="decode", masked=False,
                                       batch=COST_BATCH, mesh=None)}
            check({"cuda_fused_q8", "cuda_chain_q8"} <= legal,
                  f"8d (d): the open gate left the q8 backends out: {legal}")
            p50 = {b: decode_p50_us(torch, cfg, params, b, dev)
                   for b in ("eager", "cuda_fused", "cuda_chain",
                             "cuda_fused_q8", "cuda_chain_q8")}
            runtime.set_cost_model(runtime.CostModel.from_entries(
                tuning_rows(cfg, p50), source="<chip_smoke 8d: decode p50>"))
            exe = runtime.compile(cfg.gru, batch=COST_BATCH, mode="decode")
            won = min(("cuda_fused", "cuda_chain", "cuda_fused_q8",
                       "cuda_chain_q8"), key=p50.get)
            check(exe.decode_backend == won
                  and exe.cost_source == "measured",
                  f"8d (d): measured table {p50} chose {exe.describe()}")
            print(f"  (d) {label}: gate open from the artifact; decode p50 at "
                  f"{COST_BATCH} rows (host clock, synchronized): "
                  + ", ".join(f"{b} {us:.2f} us" for b, us in p50.items())
                  + f"; compile(quant='int8', backend='cuda') -> "
                  f"{exe.decode_backend} (measured)", flush=True)
            rep.update(gate_opened=True, decode_p50_us=p50,
                       chosen=exe.decode_backend)
            runtime.set_quant_accuracy(saved_gate)
            runtime.set_cost_model(saved_costs)
            check(not runtime.quant_gate_open(), "8d (d): gate left open")
        report[label] = rep
    return {"launches": launches, "report": report}


def run_training_path(torch, dev):
    """Phase 8d: (a) gru-jet trained through the train CLI with
    checkpoints and a resume; (b) gru-jet-deep and slstm-jet; (c)
    qwen3-0.6b at full width; (d) the q8 harness. Counters are zeroed just
    before each part and the plain versions watched; the launches of the
    kernel-backend evaluations go to the kernels line."""
    import tempfile
    launches, report, secs = {}, {}, {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        parts = {}
        for k, fn in (("a", lambda: run_jet_training(torch, dev, tmp)),
                      ("b", lambda: run_deep_training(torch, dev)),
                      ("c", lambda: run_lm_training(torch, dev)),
                      ("d", lambda: run_q8_harness(torch, dev, tmp))):
            t = time.perf_counter()
            parts[k] = fn()
            secs[k] = time.perf_counter() - t
    a, b, c, d = (parts[k] for k in "abcd")
    from repro_torch.configs.base import get_config
    jet = get_config("gru-jet")
    batch = {"features": torch.zeros(2, 3, jet.gru.input_dim, device=dev),
             "labels": torch.zeros(2, dtype=torch.int32, device=dev)}
    check_no_backward(jet.replace(gru=dataclasses.replace(
        jet.gru, backend="cuda_fused")), batch, dev,
        "gru-jet backend='cuda_fused'")
    for part in (a, b, d):
        for k, v in part["launches"].items():
            launches[k] = launches.get(k, 0) + v
    report.update(jet=a["report"], deep=b["report"], lm=c["report"],
                  q8=d["report"])
    print(f"  launches: {launches}", flush=True)
    print(f"  phase 8d: {time.perf_counter() - t0:.1f} s (parts: "
          + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()) + ")",
          flush=True)
    return launches, report


# ---------------------------------------------------------------------------
# 9. the dense LM's attention kernels against their plain versions
# ---------------------------------------------------------------------------

LM_ARCH = "qwen3-0.6b"
LM_SLOTS, LM_NEW = 4, 16
LM_WAVES = ((12, 12, 12, 12), (128, 12, 128, 12))   # prompt lengths
LM_LOGIT_TOL = 0.25       # |bf16 cuda - fp32 chunked| logits, 28 layers
HQ, HKV, HD = 16, 8, 128                            # qwen3-0.6b's heads
# (B, Sq, Sk, causal, window): the served prefills (S = 12, 128), S = 2048
# with and without a window, a window, Sq and Sk off the 64-key and the
# 32- and 64-row tiles, Sq > Sk under a window (rows with no valid key)
FLASH_CHECKS = ((4, 12, 12, True, 0), (4, 128, 128, True, 0),
                (1, 2048, 2048, True, 0), (1, 2048, 2048, True, 256),
                (2, 200, 200, True, 64), (2, 77, 45, False, 0),
                (1, 300, 40, True, 16))
# (B, C, written positions (first, last) or None, pos, window): the
# served caches (C = S + 64 after prefill and the first decode write), S =
# 2048, a wrapped ring, a window over it, empty slots, a fully masked
# cache, C just above one tile, valid slots only in the last split
DECODE_CHECKS = ((4, 76, (0, 12), 12, 0), (4, 192, (0, 128), 128, 0),
                 (1, 2112, (0, 2048), 2048, 0), (4, 192, (100, 400), 400, 0),
                 (4, 192, (100, 400), 400, 100), (4, 192, (0, 50), 50, 0),
                 (2, 76, None, 0, 0), (2, 65, (0, 64), 64, 0),
                 (1, 2112, (1990, 2100), 2100, 0))
# the LM zoo's heads (Hq, Hkv, D): MHA (G = 1), flash decode's largest
# group (G = 16, MAX_G), G = 3 and G = 8; held in phase 9 at the served
# waves' shapes (prefill S = 12 and 128, decode C = 76 and 192), timed in
# phase 12 at the S = 128 wave
ZOO_HEADS = {"qwen2-moe-a2.7b": (16, 16, 128),
             "qwen3-moe-235b-a22b": (64, 4, 128),
             "phi4-mini-3.8b": (24, 8, 128),
             "qwen2.5-3b": (16, 2, 128),
             "command-r-35b": (64, 8, 128),
             "hymba-1.5b": (25, 5, 64),
             "whisper-large-v3": (20, 20, 64),
             "llava-next-mistral-7b": (32, 8, 128)}
ZOO_FLASH = ((4, 12, 12, True, 0), (4, 128, 128, True, 0))
ZOO_DECODE = ((4, 76, (0, 12), 12, 0), (4, 192, (0, 128), 128, 0))
# hymba-1.5b (D = 64: the bf16 kernel's 64-wide instance; G = 5: flash
# decode's 16-query bucket) at phase 10c's shapes: prefill S = 1280 with
# its window of 1024 and without (the global layers), S = 128 and 12
# under the window; decode against a full wrapped window ring (C = 1024),
# a global layer's cache (C = 1280 + 64) and the short prompts' rings
# (min(1024, S + 64) slots)
HYMBA_FLASH = ((4, 1280, 1280, True, 1024), (4, 1280, 1280, True, 0),
               (4, 128, 128, True, 1024), (4, 12, 12, True, 1024))
HYMBA_DECODE = ((4, 1024, (257, 1295), 1295, 1024),
                (4, 1344, (0, 1295), 1295, 0),
                (4, 192, (0, 143), 143, 1024), (4, 76, (0, 27), 27, 1024))
# whisper-large-v3 (20/20x64, G = 1) at phase 10d's shapes: the
# encoder's non-causal self-attention over 1500 frames (and causal, the
# kernel's other mask at that length), the decoder's causal prefills (S =
# 4 and 64) and its cross-attention (Sq = 4 and 64 against Sk = 1500, off
# every tile); decode against the self rings (C = S + 64) and the cross
# cache (C = 1500, every slot valid whatever the position: ``pos`` None).
# llava-next-mistral-7b (32/8x128, G = 4): the S = 640 prefill (576
# patches, 64 text tokens) and its decode at C = 704
WHISPER_FLASH = ((4, 1500, 1500, False, 0), (4, 1500, 1500, True, 0),
                 (4, 4, 4, True, 0), (4, 64, 64, True, 0),
                 (4, 4, 1500, False, 0), (4, 64, 1500, False, 0))
WHISPER_DECODE = ((4, 68, (0, 4), 4, 0), (4, 128, (0, 79), 79, 0),
                  (4, 1500, (0, 1499), None, 0))
LLAVA_FLASH = ((4, 640, 640, True, 0),)
LLAVA_DECODE = ((4, 704, (0, 640), 640, 0), (4, 704, (0, 655), 655, 0))
ZOO_CASES = {"hymba-1.5b": (HYMBA_FLASH, HYMBA_DECODE),
             "whisper-large-v3": (WHISPER_FLASH, WHISPER_DECODE),
             "llava-next-mistral-7b": (LLAVA_FLASH, LLAVA_DECODE)}
# phase 12's timed zoo shapes: the S = 128 wave (ATTN_ROW) at each
# transformer's heads; hymba at its served S = 1280 with the window and
# without, each beside its decode (window ring C = 1024; global C = 1344);
# whisper's encoder (S = 1500, non-causal) beside its cross decode (C =
# 1500, all valid), its cross prefill at Sq = 64 beside the self decode
# after that prompt (C = 128); llava's S = 640 prefill beside its decode
# at C = 704
OWN_TIMED = ("hymba-1.5b", "whisper-large-v3", "llava-next-mistral-7b")
ZOO_TIMED = ([(a, h, None, None) for a, h in ZOO_HEADS.items()
              if a not in OWN_TIMED]
             + [("hymba-1.5b window 1024", ZOO_HEADS["hymba-1.5b"],
                 (4, 1280, 1280, True, 1024),
                 (4, 1024, (257, 1280), 1280, 1024)),
                ("hymba-1.5b window 0", ZOO_HEADS["hymba-1.5b"],
                 (4, 1280, 1280, True, 0), (4, 1344, (0, 1280), 1280, 0)),
                ("whisper-large-v3 encoder / cross decode",
                 ZOO_HEADS["whisper-large-v3"], (4, 1500, 1500, False, 0),
                 (4, 1500, (0, 1499), None, 0)),
                ("whisper-large-v3 cross Sq=64 / self decode",
                 ZOO_HEADS["whisper-large-v3"], (4, 64, 1500, False, 0),
                 (4, 128, (0, 64), 64, 0)),
                ("llava-next-mistral-7b", ZOO_HEADS["llava-next-mistral-7b"],
                 (4, 640, 640, True, 0), (4, 704, (0, 640), 640, 0))])


def attn_inputs(torch, B, Sq, Sk, dtype, seed, dev, heads=(HQ, HKV, HD)):
    hq, hkv, hd = heads
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(*shape, generator=g).to(dev).to(dtype)
                 for shape in ((B, hq, Sq, hd), (B, hkv, Sk, hd),
                               (B, hkv, Sk, hd)))


def decode_inputs(torch, B, C, written, pos, window, dtype, seed, dev,
                  heads=(HQ, HKV, HD)):
    from repro_torch.kernels.decode_attn.ops import valid_slots
    hq, hkv, hd = heads
    g = torch.Generator().manual_seed(seed)
    q, kc, vc = (torch.randn(*shape, generator=g).to(dev).to(dtype)
                 for shape in ((B, hkv, hq // hkv, hd), (B, hkv, C, hd),
                               (B, hkv, C, hd)))
    slot_pos = torch.full((C,), -1, dtype=torch.int32)
    if written is not None:
        for p in range(written[0], written[1] + 1):
            slot_pos[p % C] = p
    # pos None: a cross-attention cache (every written slot valid)
    return q, kc, vc, valid_slots(slot_pos.to(dev), pos, window,
                                  cross=pos is None)


def check_flash(torch, dev, dtype, case, heads, seed):
    """One flash-attention launch against its plain version (and a second
    launch, bit for bit); returns max |err|."""
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.flash_attn import ref as fref
    B, Sq, Sk, causal, window = case
    hq, hkv, hd = heads
    dn = str(dtype).split(".")[-1]
    tol = TOL if dtype == torch.float32 else BF16_TOL
    q, k, v = attn_inputs(torch, B, Sq, Sk, dtype, seed, dev, heads)
    got = FK.flash_attention(q, k, v, causal=causal, window=window)
    want = fref.flash_attention_plain(q, k, v, causal, window)
    again = FK.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    check(got.dtype == dtype and bool(torch.isfinite(got).all()),
          f"flash_attention {dn} S={Sq}/{Sk} heads {heads}: bad output")
    check(torch.equal(got, again), f"flash_attention {dn} S={Sq}/{Sk} heads "
          f"{heads}: two launches gave different bits")
    e = (got.float() - want.float()).abs().max().item()
    check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
          f"flash_attention {dn} B={B} heads {heads} Sq={Sq} Sk={Sk} causal="
          f"{causal} window={window}: max |err| {e:.3g} (tol {tol})")
    no_key = ~fref._mask(Sq, 0, Sk, causal, window, dev).any(-1)
    check(int(torch.count_nonzero(got[:, :, no_key])) == 0,
          f"flash_attention S={Sq}/{Sk}: a row with no valid key is not 0")
    print(f"  flash_attention {dn:8s} B={B} Hq={hq} Hkv={hkv} D={hd} "
          f"Sq={Sq:4d} Sk={Sk:4d} causal={causal!s:5} window={window:3d}: "
          f"max |kernel - plain| {e:.3g} (rows without a key: "
          f"{int(no_key.sum())}, exactly 0; two launches bitwise equal)",
          flush=True)
    return e


def check_decode(torch, dev, dtype, case, heads, seed):
    """One flash-decode launch against its plain version (and a second
    launch, bit for bit); returns max |err|."""
    from repro_torch.kernels.decode_attn import kernel as DK
    from repro_torch.kernels.decode_attn import ref as dref
    B, C, written, pos, window = case
    hq, hkv, hd = heads
    dn = str(dtype).split(".")[-1]
    q, kc, vc, mask = decode_inputs(torch, B, C, written, pos, window, dtype,
                                    seed, dev, heads)
    got = DK.flash_decode(q, kc, vc, mask)
    want = dref.flash_decode_plain(q, kc, vc, mask)
    again = DK.flash_decode(q, kc, vc, mask)
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"flash_decode {dn} C={C} heads {heads}: "
          f"two launches gave different bits")
    e = (got - want).abs().max().item()
    check(got.dtype == torch.float32 and e <= TOL,
          f"flash_decode {dn} B={B} heads {heads} C={C} written={written} "
          f"pos={pos} window={window}: max |err| {e:.3g} (tol {TOL})")
    if written is None:
        check(int(torch.count_nonzero(got)) == 0,
              "flash_decode: a fully masked cache is not 0")
    splits = DK.num_splits(B, hkv, C, DK.sm_count(dev))
    print(f"  flash_decode    {dn:8s} B={B} Hkv={hkv} G={hq // hkv} D={hd} "
          f"C={C:4d} valid={int(mask.sum()):4d} window={window:3d}"
          f"{' (cross)' if pos is None else ''}: max "
          f"|kernel - plain| {e:.3g} ({splits} splits, {B * hkv * splits} "
          f"blocks; two launches bitwise equal)", flush=True)
    return e


def check_attention_kernels(torch, dev):
    """Both attention kernels against their plain versions on the card, in
    fp32 and bf16, at qwen3-0.6b's heads and then at the LM zoo's
    (``ZOO_HEADS``); returns {kernel: {dtype name: max |err|}} over all,
    and the zoo's maxima by config."""
    from repro_torch.kernels.decode_attn import kernel as DK
    err = {n: {"float32": 0.0, "bfloat16": 0.0} for n in ATTN}
    zoo = {a: {n: {"float32": 0.0, "bfloat16": 0.0} for n in ATTN}
           for a in ZOO_HEADS}
    n_checks = 0
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        runs = [(None, (HQ, HKV, HD), FLASH_CHECKS, DECODE_CHECKS)]
        runs += [(a, h) + ZOO_CASES.get(a, (ZOO_FLASH, ZOO_DECODE))
                 for a, h in ZOO_HEADS.items()]
        for arch, heads, flash_cases, decode_cases in runs:
            salt = 0 if arch is None else sum(heads)   # qwen3's seeds kept
            if arch is not None:
                print(f"  -- {arch}'s heads {heads}", flush=True)
            for case in flash_cases:
                e = check_flash(torch, dev, dtype, case, heads,
                                case[1] + case[2] + salt)
                err["flash_attention"][dn] = max(err["flash_attention"][dn],
                                                 e)
                if arch is not None:
                    z = zoo[arch]["flash_attention"]
                    z[dn] = max(z[dn], e)
                n_checks += 1
            for case in decode_cases:
                e = check_decode(torch, dev, dtype, case, heads,
                                 case[1] + (case[3] or 0) + salt)
                err["flash_decode"][dn] = max(err["flash_decode"][dn], e)
                if arch is not None:
                    z = zoo[arch]["flash_decode"]
                    z[dn] = max(z[dn], e)
                n_checks += 1
    check(HKV * DK.num_splits(1, HKV, 2112, DK.sm_count(dev)) > HKV,
          "flash_decode at B=1 "
          "C=2112 runs no more blocks than (b, kv-head) pairs")
    print(f"  {n_checks} attention kernel/plain comparisons passed; fp32 "
          f"tol {TOL}, bf16 tol {BF16_TOL:.4g} (flash_attention, bf16 "
          f"output) and {TOL} (flash_decode, fp32 output)", flush=True)
    return err, zoo


# ---------------------------------------------------------------------------
# 10. the dense LM: serve qwen3-0.6b at full width
# ---------------------------------------------------------------------------

def lm_requests(cfg, wave: int, waves=LM_WAVES, new=LM_NEW):
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(100 + wave)
    return [Request(prompt=rng.integers(0, cfg.vocab_size, size=n)
                    .astype(np.int32), max_new_tokens=new)
            for n in waves[wave]]


def record_logits(eng):
    """Route ``eng``'s model calls through recorders: returns the list that
    collects each prefill's and decode step's fp32 logits, in call order."""
    from types import SimpleNamespace
    log = []
    api = eng.api

    def prefill(p, cfg, batch, **kw):
        out = api.prefill(p, cfg, batch, **kw)
        log.append(out[0].float().clone())
        return out

    def decode_step(p, cfg, cache, tok, **kw):
        out = api.decode_step(p, cfg, cache, tok, **kw)
        log.append(out[0].float().clone())
        return out
    eng.api = SimpleNamespace(**dict(vars(api), prefill=prefill,
                                     decode_step=decode_step))
    return log


def serve_lm(eng, cfg, waves=LM_WAVES, new=LM_NEW):
    """Every wave through one engine; returns streams per wave."""
    return [[r.out for r in eng.generate(lm_requests(cfg, w, waves, new))]
            for w in range(len(waves))]


def compare_lm_runs(streams_a, logs_a, streams_b, logs_b, waves=LM_WAVES):
    """Hold run a (bf16, cuda) against run b (fp32, chunked) per request:
    the logits that chose each token while both streams agree (index t of
    a wave's log chose token t), and at the first token where they part,
    run b's top-2 gap. Returns (max |logit diff|, parted list)."""
    worst, parted = 0.0, []
    for w in range(len(waves)):
        wave_logs_a = logs_a[w * (LM_NEW + 1):(w + 1) * (LM_NEW + 1)]
        wave_logs_b = logs_b[w * (LM_NEW + 1):(w + 1) * (LM_NEW + 1)]
        for i, (sa, sb) in enumerate(zip(streams_a[w], streams_b[w])):
            d = next((t for t, (x, y) in enumerate(zip(sa, sb)) if x != y),
                     None)
            last = len(sa) - 1 if d is None else d
            for t in range(last + 1):
                e = (wave_logs_a[t][i] - wave_logs_b[t][i]).abs().max().item()
                worst = max(worst, e)
            if d is not None:
                top2 = wave_logs_b[d][i].topk(2).values
                gap = (top2[0] - top2[1]).item()
                parted.append({"wave": w, "request": i, "token": d,
                               "top2_gap": gap})
    return worst, parted


def run_lm_path(torch, dev, cfg=None):
    """qwen3-0.6b at full width through ``ServeEngine.generate`` (``cfg``:
    a smaller same-family config for a CPU rehearsal)."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.params import init_params
    from repro_torch.kernels.gru_sequence import kernel as K
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ServeEngine
    cfg = cfg or get_config(LM_ARCH)
    check(cfg.attn_impl == "cuda" and cfg.dtype == "bfloat16"
          and cfg.param_dtype == "float32", f"{LM_ARCH}: config {cfg}")
    L = cfg.num_layers
    t0 = time.monotonic()
    params = init_params(transformer.lm_specs(cfg), seed=0, device=dev)
    n_params = sum(x.numel() for x in _leaves(params))
    print(f"  {cfg.name}: {L} layers, d_model {cfg.d_model}, heads "
          f"{cfg.num_heads}/{cfg.num_kv_heads}x{cfg.resolved_head_dim}, "
          f"vocab {cfg.vocab_size}: {n_params} parameters (fp32) made from "
          f"seed 0 in {time.monotonic() - t0:.1f} s", flush=True)
    eng = ServeEngine(cfg, params, max_batch=LM_SLOTS, device=dev)
    K.reset_launch_counts()                                  # the LM path
    with plain_calls() as plain:
        streams = serve_lm(eng, cfg)
    from repro_torch.kernels.slstm_cell import kernel as SK
    launches, others = served_launches(K, SK)
    st = eng.latency_stats()
    prefills, steps_run = st["prefills"], st["steps"] + 1   # one decode key
    from repro_torch.kernels.decode_attn import kernel as DK
    splits = {C: DK.num_splits(LM_SLOTS, cfg.num_kv_heads, C,
                               DK.sm_count(dev))
              for C in sorted({max(w) + 64 for w in LM_WAVES})}
    print(f"  launches: {launches}; other kernels {others}; plain versions "
          f"{plain}; flash_decode splits at the served caches (C = S + "
          f"64): {splits}", flush=True)
    check(not any(plain.values()), f"{LM_ARCH}: plain versions ran {plain}")
    check(not any(others.values()), f"{LM_ARCH}: other kernels ran {others}")
    check(launches == {"flash_attention": L * prefills,
                       "flash_decode": L * steps_run},
          f"{LM_ARCH}: launches {launches} != {L} x ({prefills} prefills, "
          f"{steps_run} steps)")
    check(all(len(s) == LM_NEW for w in streams for s in w),
          f"{LM_ARCH}: stream lengths {[[len(s) for s in w] for w in streams]}")
    check(st["served_dtype"] == "bfloat16", f"served {st['served_dtype']}")
    print(f"  {LM_ARCH}: {prefills} prefills (S = "
          f"{[max(w) for w in LM_WAVES]}, {LM_SLOTS} requests each), "
          f"{steps_run} decode steps; flash_attention {L} per prefill, "
          f"flash_decode {L} per step; prefill mean "
          f"{st['prefill_mean_s'] * 1e3:.4f} ms, decode p50 "
          f"{st['p50_s'] * 1e3:.4f} ms p99 {st['p99_s'] * 1e3:.4f} ms "
          f"(host clock, synchronized)", flush=True)
    # the same waves, recorded, in bf16 through the kernels and in fp32
    # through the plain chunked attention
    log_a = record_logits(eng)
    again = serve_lm(eng, cfg)
    check(again == streams, f"{LM_ARCH}: a second bf16 run gave other "
          f"streams")
    cfg32 = cfg.replace(dtype="float32", attn_impl="chunked")
    eng32 = ServeEngine(cfg32, params, max_batch=LM_SLOTS, device=dev)
    log_b = record_logits(eng32)
    streams32 = serve_lm(eng32, cfg32)
    for log in (log_a, log_b):
        check(all(bool(torch.isfinite(x).all()) and
                  tuple(x.shape) == (LM_SLOTS, cfg.vocab_size) for x in log),
              f"{LM_ARCH}: non-finite or misshapen logits")
    worst, parted = compare_lm_runs(streams, log_a, streams32, log_b)
    check(worst <= LM_LOGIT_TOL, f"{LM_ARCH}: bf16 cuda logits differ from "
          f"fp32 chunked by {worst:.4g} > {LM_LOGIT_TOL}")
    check(all(p["top2_gap"] <= LM_LOGIT_TOL for p in parted),
          f"{LM_ARCH}: streams part where fp32's top two logits are more "
          f"than {LM_LOGIT_TOL} apart: {parted}")
    equal = not parted
    print(f"  bf16 cuda vs fp32 chunked: logits along the served tokens "
          f"within {worst:.4g} (tol {LM_LOGIT_TOL}); token streams "
          + ("equal" if equal else
             f"part in {len(parted)} of {LM_SLOTS * len(LM_WAVES)} requests,"
             f" each where fp32's top two logits are within "
             f"{max(p['top2_gap'] for p in parted):.4g}: {parted}"),
          flush=True)
    report = {"arch": LM_ARCH, "layers": L, "d_model": cfg.d_model,
              "vocab": cfg.vocab_size, "params": n_params,
              "prefills": prefills, "decode_steps": steps_run,
              "launches": launches,
              "prefill_mean_ms": st["prefill_mean_s"] * 1e3,
              "decode_p50_ms": st["p50_s"] * 1e3,
              "decode_p99_ms": st["p99_s"] * 1e3,
              "logits_vs_fp32_chunked": worst, "streams_equal": equal,
              "parted": parted}
    return launches, report, params


# ---------------------------------------------------------------------------
# 10b. the MoE family: qwen2-moe-a2.7b at full width and full depth, then
# qwen3-moe-235b-a22b at full width with its depth cut to 2
# ---------------------------------------------------------------------------

MOE_ARCH = "qwen2-moe-a2.7b"
MOE_WIDE = "qwen3-moe-235b-a22b"
MOE_WIDE_LAYERS = 2       # reduced: 94 layers -> 2 (235 B params; 2: 6.2 B)
# bf16 cuda vs bf16 chunked on the same params: where the streams part,
# the chunked run's two top logits lie within this (as LM_LOGIT_TOL for
# qwen3-0.6b's bf16 vs fp32); the logits themselves are reported, not
# held, since a routing flip (a token's top-k set changed by the other
# attention's rounding) may move a token's logits far
MOE_TOP2_TOL = 0.25


@contextlib.contextmanager
def recorded_routes(log):
    """Append every MoE layer's chosen experts (top_i, sorted per token,
    left on the device) to ``log`` while the block runs."""
    from repro_torch.models import moe as moe_mod
    route = moe_mod.route

    def rec(p, m, xf):
        out = route(p, m, xf)
        log.append(out[2].sort(-1).values)
        return out
    moe_mod.route = rec
    try:
        yield log
    finally:
        moe_mod.route = route


def routing_flips(routes_a, routes_b, streams_a, streams_b, L):
    """(flipped, compared) (token, layer) routings between two runs of
    ``LM_WAVES``: in each wave the calls made on the same inputs (the
    prefill and the steps up to the first token where a stream parts)."""
    flips = total = 0
    per_wave = L * (LM_NEW + 1)
    for w in range(len(LM_WAVES)):
        parts = [next((t for t, (x, y) in enumerate(zip(sa, sb)) if x != y),
                      None) for sa, sb in zip(streams_a[w], streams_b[w])]
        parts = [d for d in parts if d is not None]
        last = min(parts) if parts else LM_NEW
        for c in range(last + 1):
            for i in range(L):
                a = routes_a[w * per_wave + c * L + i]
                b = routes_b[w * per_wave + c * L + i]
                diff = (a != b).any(-1)
                flips += int(diff.sum())
                total += diff.numel()
    return flips, total


def step_bytes(params, cfg, B, valid):
    """Bytes one decode step must move: every leaf read once but an untied
    embedding table (its B rows), and the valid slots' K and V of every
    layer."""
    from repro_torch.core.params import flatten
    n = 0
    for path, x in flatten(params).items():
        if path == "embed" and not cfg.tie_embeddings:
            n += B * x.shape[1] * x.element_size()
        else:
            n += x.numel() * x.element_size()
    kv = 2 * cfg.num_layers * B * cfg.num_kv_heads * valid \
        * cfg.resolved_head_dim * 2
    return n + kv


def profile_moe_step(torch, dev, params, cfg, ctx=None):
    """One warm decode step of 4 requests after a 12-token prefill under
    ``torch.profiler``: its wall time and device time split into
    ``flash_decode`` (row 22), the expert products (``aten::bmm``'s
    kernels) and the rest, beside the step's byte bound (of this rank's
    tree under a mesh ``ctx``)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.distributed import NO_SHARD
    from repro_torch.models import transformer
    ctx = ctx or NO_SHARD
    rng = np.random.default_rng(7)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(
        LM_SLOTS, 12)).astype(np.int32)).to(dev)
    with torch.no_grad():
        logits, cache = transformer.prefill(params, cfg, toks, ctx=ctx)
        nxt = logits.argmax(-1)
        for _ in range(3):
            logits, cache = transformer.decode_step(params, cfg, cache, nxt,
                                                    ctx=ctx)
            nxt = logits.argmax(-1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            transformer.decode_step(params, cfg, cache, nxt, ctx=ctx)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
    kernels = device_kernels(prof)
    valid = 12 + 4
    bound = step_bytes(params, cfg, LM_SLOTS, valid) / HBM_BYTES_PER_S * 1e3
    experts = sum(x.numel() * x.element_size()
                  for k in ("wg", "wu", "wd")
                  for x in [params["blocks"]["moe"][k]])
    expert_bound = experts / HBM_BYTES_PER_S * 1e3
    if not kernels:
        print("  profiler: no device time recorded -> the step's split not "
              "measured", flush=True)
        return {"wall_ms": wall * 1e3, "bound_ms": bound}
    total = sum(kernels.values()) / 1e3
    decode = sum(us for k, us in kernels.items() if "flash_decode_k" in k)
    bmm = [e for e in prof.key_averages() if e.key == "aten::bmm"]
    bmm_ms = sum(getattr(e, "device_time_total", 0.0) or
                 getattr(e, "self_device_time_total", 0.0)
                 for e in bmm) / 1e3
    bmm_n = sum(e.count for e in bmm)
    rest = total - decode / 1e3 - bmm_ms
    print(f"  decode step ({cfg.name}, cuda, {LM_SLOTS} requests, cache of "
          f"{valid} positions; profiler): wall {wall * 1e3:.4f} ms, device "
          f"busy {total:.4f} ms ({total / (wall * 1e3):.3%}): flash_decode "
          f"(row 22) {decode / 1e3:.4f} ms, expert products ({bmm_n} "
          f"aten::bmm) {bmm_ms:.4f} ms (bound {expert_bound:.4f} ms: "
          f"{experts / 1e9:.3f} GB of expert weights over 3.35 TB/s), the "
          f"rest {rest:.4f} ms; the step's byte bound {bound:.4f} ms", flush=True)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    for k, us in top:
        print(f"    {us:10.2f} us  {k[:90]}")
    return {"wall_ms": wall * 1e3, "device_busy_ms": total,
            "device_idle_share": 1 - total / (wall * 1e3),
            "flash_decode_ms": decode / 1e3, "expert_bmm_ms": bmm_ms,
            "expert_bmm_launches": bmm_n, "rest_ms": rest,
            "bound_ms": bound, "expert_bound_ms": expert_bound}


def moe_params(torch, dev, cfg, label):
    """The served bf16 tree of ``cfg`` from seed 0, built leaf by leaf
    (``init_prepared``: ``prepare_params`` of the fp32 tree value for
    value, with neither tree whole in fp32 on the host or the card)."""
    from repro_torch.core.params import draw_workers, mem_available
    from repro_torch.models import transformer
    avail = mem_available()
    workers = draw_workers(transformer.lm_specs(cfg), cfg.param_dtype)
    print(f"  {label}: host MemAvailable "
          f"{'not readable' if avail is None else f'{avail / 2**30:.2f} GiB'}"
          f"; drawing {workers} leaves at a time", flush=True)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    params = transformer.init_prepared(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    n = sum(x.numel() for x in _leaves(params))
    nbytes = sum(x.numel() * x.element_size() for x in _leaves(params))
    print(f"  {label}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"heads {cfg.num_heads}/{cfg.num_kv_heads}x"
          f"{cfg.resolved_head_dim}, {cfg.moe.num_experts} experts (padded "
          f"to {params['blocks']['moe']['wg'].shape[1]}) top-"
          f"{cfg.moe.top_k}, shared {cfg.moe.shared_d_ff}, vocab "
          f"{cfg.vocab_size}: {n} parameters, {nbytes / 1e9:.3f} GB served "
          f"({params['blocks']['moe']['wg'].dtype}), made from seed 0 in "
          f"{init_s:.1f} s", flush=True)
    return params, {"params": n, "served_gb": nbytes / 1e9,
                    "init_s": init_s, "draw_workers": workers,
                    "host_mem_available_gib": (None if avail is None
                                               else avail / 2**30)}


def served_launches(K, SK):
    launches = {k.__name__: k.launches for k in K.ATTN_KERNELS}
    others = {k.__name__: k.launches for k in
              K.KERNELS + K.Q8_KERNELS + K.CHAIN_Q8_KERNELS
              + SK.SLSTM_KERNELS + K.ROWWISE_KERNELS + K.SHARD_KERNELS}
    return launches, others


def run_moe_path(torch, dev, cfg=None, keep=False):
    """qwen2-moe-a2.7b at full width and full depth through
    ``ServeEngine.generate`` (``cfg``: a smaller same-family config for a
    CPU rehearsal). ``keep``: also return the served tree (phase 11c
    serves from it)."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.gru_sequence import kernel as K
    from repro_torch.kernels.slstm_cell import kernel as SK
    from repro_torch.serve.engine import ServeEngine
    cfg = cfg or get_config(MOE_ARCH)
    check(cfg.attn_impl == "cuda" and cfg.dtype == "bfloat16"
          and cfg.family == "moe", f"{MOE_ARCH}: config {cfg}")
    L = cfg.num_layers
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, report = moe_params(torch, dev, cfg, MOE_ARCH)
    eng = ServeEngine(cfg, params, max_batch=LM_SLOTS, device=dev)
    check(eng.params["blocks"]["moe"]["wg"] is params["blocks"]["moe"]["wg"],
          f"{MOE_ARCH}: the engine copied the prepared experts")
    K.reset_launch_counts()                                  # the MoE path
    with plain_calls() as plain:
        streams = serve_lm(eng, cfg)
    launches, others = served_launches(K, SK)
    st = eng.latency_stats()
    prefills, steps_run = st["prefills"], st["steps"] + 1   # one decode key
    print(f"  launches: {launches}; other kernels {others}; plain versions "
          f"{plain}", flush=True)
    check(not any(plain.values()), f"{MOE_ARCH}: plain versions ran {plain}")
    check(not any(others.values()), f"{MOE_ARCH}: other kernels ran {others}")
    check(launches == {"flash_attention": L * prefills,
                       "flash_decode": L * steps_run},
          f"{MOE_ARCH}: launches {launches} != {L} x ({prefills} prefills, "
          f"{steps_run} steps)")
    check(all(len(s) == LM_NEW for w in streams for s in w),
          f"{MOE_ARCH}: stream lengths {[[len(s) for s in w] for w in streams]}")
    check(st["served_dtype"] == "bfloat16", f"served {st['served_dtype']}")
    print(f"  {MOE_ARCH}: {prefills} prefills (S = "
          f"{[max(w) for w in LM_WAVES]}, {LM_SLOTS} requests each), "
          f"{steps_run} decode steps; flash_attention {L} per prefill, "
          f"flash_decode {L} per step; prefill mean "
          f"{st['prefill_mean_s'] * 1e3:.4f} ms, decode p50 "
          f"{st['p50_s'] * 1e3:.4f} ms p99 {st['p99_s'] * 1e3:.4f} ms "
          f"(host clock, synchronized)", flush=True)
    # the same waves, recorded (logits and routings), through the kernels
    # and through the plain chunked attention, both bf16 on these params
    log_a, routes_a = record_logits(eng), []
    with recorded_routes(routes_a):
        again = serve_lm(eng, cfg)
    cfg_c = cfg.replace(attn_impl="chunked")
    eng_c = ServeEngine(cfg_c, params, max_batch=LM_SLOTS, device=dev)
    log_c, routes_c = record_logits(eng_c), []
    with recorded_routes(routes_c):
        streams_c = serve_lm(eng_c, cfg_c)
    for log in (log_a, log_c):
        check(all(bool(torch.isfinite(x).all()) and
                  tuple(x.shape) == (LM_SLOTS, cfg.vocab_size) for x in log),
              f"{MOE_ARCH}: non-finite or misshapen logits")
    worst, parted = compare_lm_runs(again, log_a, streams_c, log_c)
    flips, compared = routing_flips(routes_a, routes_c, again, streams_c, L)
    check(all(p["top2_gap"] <= MOE_TOP2_TOL for p in parted),
          f"{MOE_ARCH}: streams part where chunked's top two logits are more "
          f"than {MOE_TOP2_TOL} apart: {parted}")
    print(f"  a second cuda run: streams "
          f"{'equal to the first' if again == streams else 'differ from the first'}"
          f"; bf16 cuda vs bf16 chunked: logits along the served tokens "
          f"within {worst:.4g} (reported, not held); token streams "
          + ("equal" if not parted else
             f"part in {len(parted)} of {LM_SLOTS * len(LM_WAVES)} requests,"
             f" each where chunked's top two logits are within "
             f"{max(p['top2_gap'] for p in parted):.4g} (tol "
             f"{MOE_TOP2_TOL}): {parted}")
          + f"; routing flips: {flips} of {compared} (token, layer) top-"
          f"{cfg.moe.top_k} sets differ", flush=True)
    prof = profile_moe_step(torch, dev, params, cfg)
    peak = torch.cuda.max_memory_allocated()
    print(f"  {MOE_ARCH}: peak device memory {peak / 2**30:.3f} GiB "
          f"(max_memory_allocated, from before the params were built)",
          flush=True)
    report.update({
        "arch": MOE_ARCH, "layers": L, "d_model": cfg.d_model,
        "vocab": cfg.vocab_size, "prefills": prefills,
        "decode_steps": steps_run, "launches": launches,
        "prefill_mean_ms": st["prefill_mean_s"] * 1e3,
        "decode_p50_ms": st["p50_s"] * 1e3,
        "decode_p99_ms": st["p99_s"] * 1e3,
        "second_run_streams_equal": again == streams,
        "logits_vs_chunked": worst, "streams_equal": not parted,
        "parted": parted, "routing_flips": flips,
        "routings_compared": compared, "peak_gib": peak / 2**30,
        "profile_decode": prof})
    del eng, eng_c
    if keep:
        return launches, report, params
    del params
    torch.cuda.empty_cache()
    return launches, report


def run_moe_wide(torch, dev, cfg=None):
    """qwen3-moe-235b-a22b at full width, depth cut to ``MOE_WIDE_LAYERS``
    (reduced), one wave of 4 through ``ServeEngine.generate``: flash decode
    at G = 16."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.gru_sequence import kernel as K
    from repro_torch.kernels.slstm_cell import kernel as SK
    from repro_torch.serve.engine import ServeEngine
    cfg = cfg or get_config(MOE_WIDE).replace(num_layers=MOE_WIDE_LAYERS)
    L = cfg.num_layers
    check(cfg.num_heads // cfg.num_kv_heads == 16,
          f"{MOE_WIDE}: G = {cfg.num_heads // cfg.num_kv_heads}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, report = moe_params(torch, dev, cfg,
                                f"{MOE_WIDE} (depth {L}, reduced)")
    eng = ServeEngine(cfg, params, max_batch=LM_SLOTS, device=dev)
    K.reset_launch_counts()                            # the MoE path, again
    with plain_calls() as plain:
        streams = [r.out for r in eng.generate(lm_requests(cfg, 1))]
    launches, others = served_launches(K, SK)
    st = eng.latency_stats()
    prefills, steps_run = st["prefills"], st["steps"] + 1
    check(not any(plain.values()), f"{MOE_WIDE}: plain versions ran {plain}")
    check(not any(others.values()), f"{MOE_WIDE}: other kernels ran {others}")
    check(launches == {"flash_attention": L * prefills,
                       "flash_decode": L * steps_run},
          f"{MOE_WIDE}: launches {launches} != {L} x ({prefills} prefills, "
          f"{steps_run} steps)")
    check(all(len(s) == LM_NEW for s in streams),
          f"{MOE_WIDE}: stream lengths {[len(s) for s in streams]}")
    peak = torch.cuda.max_memory_allocated()
    print(f"  {MOE_WIDE} (depth {L} of 94, reduced): launches {launches} "
          f"({prefills} prefill of S = {max(LM_WAVES[1])}, {steps_run} "
          f"steps; G = 16); prefill {st['prefill_mean_s'] * 1e3:.4f} ms, "
          f"decode p50 {st['p50_s'] * 1e3:.4f} ms p99 "
          f"{st['p99_s'] * 1e3:.4f} ms (host clock); peak device memory "
          f"{peak / 2**30:.3f} GiB; streams {[s[:6] for s in streams]}",
          flush=True)
    report.update({"arch": MOE_WIDE, "layers": L, "reduced": "depth 94 -> "
                   f"{L}", "launches": launches, "prefills": prefills,
                   "decode_steps": steps_run,
                   "prefill_mean_ms": st["prefill_mean_s"] * 1e3,
                   "decode_p50_ms": st["p50_s"] * 1e3,
                   "decode_p99_ms": st["p99_s"] * 1e3,
                   "peak_gib": peak / 2**30})
    del eng, params
    torch.cuda.empty_cache()
    return launches, report


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# 10c. the recurrent LMs: hymba-1.5b at full width and depth through the
# windowed attention kernels, xlstm-125m at full width (no kernel)
# ---------------------------------------------------------------------------

HYMBA_ARCH = "hymba-1.5b"
XLSTM_ARCH = "xlstm-125m"
# wave 1: longer than the 1024 window (the window masks in prefill, the
# rings wrap); wave 2: shorter (the ring repair); 16 new tokens each
HYMBA_WAVES = ((1280, 1280, 1280, 1280), (128, 12, 128, 12))
XLSTM_WAVES = ((128, 128, 128, 128),)
# bf16 cuda vs bf16 chunked on the same params: where the streams part,
# chunked's two top logits lie within this (phase 10b's rule). The two
# attention paths' bf16 logits differ by up to 0.59 along their shared
# prefixes at 32 layers (H100, PERF.md), so near-ties part early
HYMBA_TOP2_TOL = 0.5
# bf16 served logits against teacher-forced forwards on the served
# tokens: serving (a prefill, then the rings and recurrent states step by
# step) may depart from the fp32 ``forward`` and from the bf16 one by at
# most this factor times the bf16 ``forward``'s own departure from the
# fp32 one (CPU SMOKE: ratios 0.8-1.1)
BF16_SERVED_FACTOR = 2.0
# fp32 served logits against the fp32 teacher-forced ``forward``: the
# same function in other summation orders (the kernels' fp32 paths for
# hymba; CPU SMOKE 5e-6)
FP32_SERVED_TOL = 1e-3


def api_batches(torch, cfg, waves, dev):
    """Each wave's model inputs on ``dev``: its prompts (``lm_requests``),
    left-padded with zeros to the longest, and by family random frame
    (whisper) or patch (llava) embeddings in fp32 from the wave's seed
    (the model casts them to its compute dtype)."""
    out = []
    for w in range(len(waves)):
        ps = [r.prompt for r in lm_requests(cfg, w, waves)]
        S = max(len(p) for p in ps)
        toks = np.zeros((len(ps), S), np.int32)
        for i, p in enumerate(ps):
            toks[i, S - len(p):] = p
        batch = {"tokens": torch.from_numpy(toks).to(dev)}
        if cfg.family in ("audio", "vlm"):
            key, shape = (("frames", (cfg.encoder.num_frames, cfg.d_model))
                          if cfg.family == "audio" else
                          ("patches", (cfg.vision.num_patches,
                                       cfg.vision.embed_dim)))
            x = np.random.default_rng(200 + w).standard_normal(
                (len(ps),) + shape, dtype=np.float32)
            batch[key] = torch.from_numpy(x).to(dev)
        out.append(batch)
    return out


def forced_logits(torch, api, params, cfg, batches, streams):
    """Teacher-forced ``api.forward`` logits at every served position,
    stacked like a recorded log (``LM_NEW + 1`` calls a wave, each (B,
    V)): per wave, the batch's prompts and the generated tokens, at the
    positions that chose each token (the last decode step's too)."""
    out = []
    with torch.no_grad():
        for batch, ss in zip(batches, streams):
            S = batch["tokens"].shape[1]
            gen = torch.tensor(ss, dtype=batch["tokens"].dtype,
                               device=batch["tokens"].device)
            full = api.forward(params, cfg, dict(
                batch, tokens=torch.cat([batch["tokens"], gen], 1)))
            out.append(full[:, S - 1:S + LM_NEW].transpose(0, 1).clone())
            del full
    return torch.cat(out)


def max_diff(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def served_vs_forced(torch, cfg, params16, params32, waves, streams,
                     log16, dev, label):
    """The bf16 served logits (``log16``, one entry a call) against
    teacher-forced forwards on the served tokens, bf16 and fp32; then an
    fp32 serve of the same waves against its own teacher-forced forward.
    Checks both rules; returns the errors."""
    from repro_torch.models import api as mapi
    from repro_torch.serve.engine import ServeEngine
    cfg32 = cfg.replace(dtype="float32")
    api, batches = mapi.get_api(cfg), api_batches(torch, cfg, waves, dev)
    served = torch.stack(log16)
    f16 = forced_logits(torch, api, params16, cfg, batches, streams)
    f32 = forced_logits(torch, api, params32, cfg32, batches, streams)
    e_fwd, e_served = max_diff(f16, f32), max_diff(served, f32)
    e_direct = max_diff(served, f16)
    last = max_diff(served[LM_NEW::LM_NEW + 1], f16[LM_NEW::LM_NEW + 1])
    check(max(e_served, e_direct) <= BF16_SERVED_FACTOR * e_fwd,
          f"{label}: bf16 served logits depart from the fp32 forward by "
          f"{e_served:.4g} and from the bf16 forward by {e_direct:.4g}, "
          f"more than {BF16_SERVED_FACTOR} x the bf16 forward's own "
          f"{e_fwd:.4g}")
    del f16, f32, served
    eng32 = ServeEngine(cfg32, params32, max_batch=LM_SLOTS, device=dev)
    log32 = record_logits(eng32)
    streams32 = serve_lm(eng32, cfg32, waves)
    e32 = max_diff(torch.stack(log32),
                   forced_logits(torch, api, params32, cfg32, batches,
                                 streams32))
    check(e32 <= FP32_SERVED_TOL, f"{label}: fp32 served logits differ "
          f"from the fp32 teacher-forced forward by {e32:.4g} > "
          f"{FP32_SERVED_TOL}")
    print(f"  {label}, against teacher-forced forwards on the served "
          f"tokens: bf16 served vs bf16 forward {e_direct:.4g} (last step "
          f"{last:.4g}), vs fp32 forward {e_served:.4g}; the bf16 forward "
          f"vs the fp32 forward {e_fwd:.4g} (tol {BF16_SERVED_FACTOR} x "
          f"that); fp32 served vs fp32 forward {e32:.4g} (tol "
          f"{FP32_SERVED_TOL}); fp32 streams "
          f"{'equal' if streams32 == streams else 'differ from'} the bf16 "
          f"streams", flush=True)
    del eng32
    return {"bf16_vs_bf16_forward": e_direct,
            "bf16_vs_bf16_forward_last_step": last,
            "bf16_vs_fp32_forward": e_served,
            "bf16_forward_vs_fp32_forward": e_fwd,
            "fp32_vs_fp32_forward": e32,
            "fp32_streams_equal_bf16": streams32 == streams}


def recurrent_params(torch, dev, cfg, mod, label):
    """``served_params`` and the fp32 tree it is cast from
    (``init_params``, the same seed), both on the card."""
    from repro_torch.core.params import init_params
    params, report = served_params(torch, dev, cfg, mod, label)
    params32 = init_params(mod.lm_specs(cfg), seed=0, device=dev)
    return params, params32, report


def tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in _leaves(tree))


def served_params(torch, dev, cfg, mod, label):
    """The served bf16 tree of ``cfg`` from seed 0, built leaf by leaf
    (``init_prepared``: the dense weights cast on the way)."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    params = mod.init_prepared(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    n = sum(x.numel() for x in _leaves(params))
    nbytes = tree_bytes(params)
    print(f"  {label}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"heads {cfg.num_heads}/{cfg.num_kv_heads}x"
          f"{cfg.resolved_head_dim}, vocab {cfg.vocab_size}: {n} "
          f"parameters, {nbytes / 1e9:.3f} GB served (bf16 dense weights), "
          f"made from seed 0 leaf by leaf in {init_s:.1f} s", flush=True)
    return params, {"params": n, "served_gb": nbytes / 1e9,
                    "init_s": init_s}


def profile_decode_step(torch, api, params, cfg, batch, p50_ms,
                        weights=None):
    """One warm decode step of the batch's requests after its prefill and
    three steps, under ``torch.profiler``: wall, device busy and idle
    share (of the profiled wall, and of ``p50_ms``, the unprofiled decode
    p50 on the host clock), the top kernels and ``flash_decode``'s part.
    ``weights`` (the bytes of the parameters a step reads) adds the step's
    bytes' bound: those and the valid K/V slots of every cache group, over
    3.35 TB/s."""
    from torch.profiler import ProfilerActivity, profile
    B, S = batch["tokens"].shape
    with torch.no_grad():
        logits, cache = api.prefill(params, cfg, batch)
        for _ in range(3):
            logits, cache = api.decode_step(params, cfg, cache,
                                            logits.argmax(-1))
        nxt = logits.argmax(-1)
        kv_bytes = 0
        for group in cache.values():
            if isinstance(group, dict) and "slot_pos" in group:
                valid = int((group["slot_pos"][0] >= 0).sum()) + 1
                for k in ("k", "v"):
                    x = group[k]
                    kv_bytes += x.numel() // x.shape[-2] * min(
                        valid, x.shape[-2]) * x.element_size()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            api.decode_step(params, cfg, cache, nxt)
            torch.cuda.synchronize()
            wall = (time.monotonic() - t0) * 1e3
    out = {"wall_ms": wall}
    head = (f"  decode step ({cfg.name}, {cfg.attn_impl}, {B} requests "
            f"after a {S}-token prefill; profiler): wall {wall:.4f} ms")
    if weights is not None:
        bound = (weights + kv_bytes) / HBM_BYTES_PER_S * 1e3
        out.update({"bound_ms": bound, "weight_bytes": weights,
                    "kv_bytes": kv_bytes})
        head += (f"; bytes' bound {bound:.4f} ms ({weights / 1e9:.3f} GB "
                 f"of weights, {kv_bytes / 1e9:.3f} GB of K/V)")
    kernels = device_kernels(prof)
    if not kernels:
        print(head + "; no device time recorded -> the step's split not "
              "measured", flush=True)
        return out
    busy = sum(kernels.values()) / 1e3
    decode = sum(us for k, us in kernels.items()
                 if "flash_decode_k" in k) / 1e3
    print(head + f", device busy {busy:.4f} ms (of the profiled wall "
          f"{busy / wall:.3%}, idle {1 - busy / wall:.3%}; of the "
          f"unprofiled p50 {p50_ms:.4f} ms {busy / p50_ms:.3%}, idle "
          f"{1 - busy / p50_ms:.3%}"
          + (f"; {busy / out['bound_ms']:.2f}x the bound"
             if weights is not None else "")
          + f"), flash_decode {decode:.4f} ms", flush=True)
    for k, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:6]:
        print(f"    {us:10.2f} us  {k[:90]}")
    out.update({"device_busy_ms": busy, "device_idle_share": 1 - busy / wall,
                "idle_share_of_p50": 1 - busy / p50_ms,
                "flash_decode_ms": decode})
    return out


def random_prompts(torch, cfg, dev, S=12):
    """The profiled step's batch for the recurrent LMs: ``LM_SLOTS``
    random prompts of S tokens."""
    rng = np.random.default_rng(7)
    return {"tokens": torch.from_numpy(rng.integers(
        1, cfg.vocab_size, size=(LM_SLOTS, S)).astype(np.int32)).to(dev)}


def run_hymba_path(torch, dev, cfg=None):
    """hymba-1.5b at full width and depth through ``ServeEngine.generate``
    (``cfg``: a smaller same-family config for a CPU rehearsal): the
    windowed flash attention at prefill, flash decode against the rings."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.gru_sequence import kernel as K
    from repro_torch.kernels.slstm_cell import kernel as SK
    from repro_torch.models import api as mapi
    from repro_torch.models import hymba
    from repro_torch.serve.engine import ServeEngine
    cfg = cfg or get_config(HYMBA_ARCH)
    check(cfg.attn_impl == "cuda" and cfg.dtype == "bfloat16"
          and cfg.family == "hybrid", f"{HYMBA_ARCH}: config {cfg}")
    L = cfg.num_layers
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, params32, report = recurrent_params(torch, dev, cfg, hymba,
                                                HYMBA_ARCH)
    eng = ServeEngine(cfg, params, max_batch=LM_SLOTS, device=dev)
    K.reset_launch_counts()                              # the hymba path
    t0 = time.monotonic()
    with plain_calls() as plain:
        streams = serve_lm(eng, cfg, HYMBA_WAVES)
    torch.cuda.synchronize()
    served_s = time.monotonic() - t0
    launches, others = served_launches(K, SK)
    st = eng.latency_stats()
    prefill_ms = [x * 1e3 for x in eng.prefill_times]
    prefills, steps_run = st["prefills"], st["steps"] + 1   # one decode key
    print(f"  launches: {launches}; other kernels {others}; plain versions "
          f"{plain}", flush=True)
    check(not any(plain.values()), f"{HYMBA_ARCH}: plain versions ran {plain}")
    check(not any(others.values()),
          f"{HYMBA_ARCH}: other kernels ran {others}")
    check(launches == {"flash_attention": L * prefills,
                       "flash_decode": L * steps_run},
          f"{HYMBA_ARCH}: launches {launches} != {L} x ({prefills} "
          f"prefills, {steps_run} steps)")
    check(all(len(s) == LM_NEW for w in streams for s in w),
          f"{HYMBA_ARCH}: stream lengths "
          f"{[[len(s) for s in w] for w in streams]}")
    check(st["served_dtype"] == "bfloat16", f"served {st['served_dtype']}")
    print(f"  {HYMBA_ARCH}: {prefills} prefills (S = "
          f"{[max(w) for w in HYMBA_WAVES]}, {LM_SLOTS} requests each), "
          f"{steps_run} decode steps in {served_s:.1f} s; flash_attention "
          f"{L} per prefill, flash_decode {L} per step; prefill "
          f"{[round(x, 4) for x in prefill_ms]} ms, decode p50 "
          f"{st['p50_s'] * 1e3:.4f} ms p99 {st['p99_s'] * 1e3:.4f} ms (host "
          f"clock, synchronized)", flush=True)
    # the same waves recorded through the kernels, then through the plain
    # chunked attention on these bf16 params
    log_a = record_logits(eng)
    again = serve_lm(eng, cfg, HYMBA_WAVES)
    check(again == streams, f"{HYMBA_ARCH}: a second cuda run gave other "
          f"streams")
    cfg_c = cfg.replace(attn_impl="chunked")
    eng_c = ServeEngine(cfg_c, params, max_batch=LM_SLOTS, device=dev)
    log_c = record_logits(eng_c)
    streams_c = serve_lm(eng_c, cfg_c, HYMBA_WAVES)
    del eng_c
    for log in (log_a, log_c):
        check(all(bool(torch.isfinite(x).all()) and
                  tuple(x.shape) == (LM_SLOTS, cfg.vocab_size) for x in log),
              f"{HYMBA_ARCH}: non-finite or misshapen logits")
    worst, parted = compare_lm_runs(again, log_a, streams_c, log_c,
                                    HYMBA_WAVES)
    check(all(p["top2_gap"] <= HYMBA_TOP2_TOL for p in parted),
          f"{HYMBA_ARCH}: streams part where chunked's top two logits are "
          f"more than {HYMBA_TOP2_TOL} apart: {parted}")
    print(f"  a second cuda run: streams equal to the first; bf16 cuda vs "
          f"bf16 chunked: logits along the served tokens within "
          f"{worst:.4g} (reported); token streams "
          + ("equal" if not parted else
             f"part in {len(parted)} of {LM_SLOTS * len(HYMBA_WAVES)} "
             f"requests, each where chunked's top two logits are within "
             f"{max(p['top2_gap'] for p in parted):.4g} (tol "
             f"{HYMBA_TOP2_TOL}): {parted}"), flush=True)
    del log_c
    forced = served_vs_forced(torch, cfg, params, params32,
                              HYMBA_WAVES, again, log_a, dev, HYMBA_ARCH)
    del params32, log_a
    prof = profile_decode_step(torch, mapi.get_api(cfg), params, cfg,
                               random_prompts(torch, cfg, dev),
                               st["p50_s"] * 1e3)
    peak = torch.cuda.max_memory_allocated()
    print(f"  {HYMBA_ARCH}: peak device memory {peak / 2**30:.3f} GiB "
          f"(max_memory_allocated, from before the params were built; the "
          f"fp32 tree beside the served one)", flush=True)
    report.update({
        "arch": HYMBA_ARCH, "layers": L, "d_model": cfg.d_model,
        "heads": [cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim],
        "window": cfg.sliding_window, "vocab": cfg.vocab_size,
        "waves": [list(w) for w in HYMBA_WAVES], "prefills": prefills,
        "decode_steps": steps_run, "launches": launches,
        "prefill_ms": prefill_ms, "decode_p50_ms": st["p50_s"] * 1e3,
        "decode_p99_ms": st["p99_s"] * 1e3,
        "logits_vs_chunked": worst, "streams_equal_chunked": not parted,
        "parted": parted, "teacher_forced": forced,
        "peak_gib": peak / 2**30, "profile_decode": prof})
    del eng, params
    torch.cuda.empty_cache()
    return launches, report


def run_xlstm_path(torch, dev, cfg=None):
    """xlstm-125m at full width through ``ServeEngine.generate`` in bf16,
    held against fp32 forwards of the same params (seed 0) and an fp32
    serve; no kernel and no plain version may run."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.gru_sequence import kernel as K
    from repro_torch.kernels.slstm_cell import kernel as SK
    from repro_torch.models import api as mapi
    from repro_torch.models import xlstm
    from repro_torch.serve.engine import ServeEngine
    cfg = cfg or get_config(XLSTM_ARCH)
    check(cfg.dtype == "bfloat16" and cfg.family == "ssm",
          f"{XLSTM_ARCH}: config {cfg}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, params32, report = recurrent_params(torch, dev, cfg, xlstm,
                                                XLSTM_ARCH)
    eng = ServeEngine(cfg, params, max_batch=LM_SLOTS, device=dev)
    K.reset_launch_counts()                              # the xLSTM path
    log_a = record_logits(eng)
    with plain_calls() as plain:
        streams = serve_lm(eng, cfg, XLSTM_WAVES)
    launches, others = served_launches(K, SK)
    st = eng.latency_stats()
    check(not any(plain.values()), f"{XLSTM_ARCH}: plain versions ran {plain}")
    check(not any(launches.values()) and not any(others.values()),
          f"{XLSTM_ARCH}: kernels ran {launches} {others}")
    check(all(len(s) == LM_NEW for w in streams for s in w),
          f"{XLSTM_ARCH}: stream lengths")
    check(st["served_dtype"] == "bfloat16", f"served {st['served_dtype']}")
    check(all(bool(torch.isfinite(x).all()) and
              tuple(x.shape) == (LM_SLOTS, cfg.vocab_size) for x in log_a),
          f"{XLSTM_ARCH}: non-finite or misshapen logits")
    print(f"  {XLSTM_ARCH}: 1 prefill (S = 128, {LM_SLOTS} requests), "
          f"{st['steps'] + 1} decode steps; no kernel, no plain version; "
          f"prefill {eng.prefill_times[0] * 1e3:.4f} ms, decode p50 "
          f"{st['p50_s'] * 1e3:.4f} ms p99 {st['p99_s'] * 1e3:.4f} ms (host "
          f"clock, synchronized)", flush=True)
    forced = served_vs_forced(torch, cfg, params, params32,
                              XLSTM_WAVES, streams, log_a, dev, XLSTM_ARCH)
    prof = profile_decode_step(torch, mapi.get_api(cfg), params, cfg,
                               random_prompts(torch, cfg, dev),
                               st["p50_s"] * 1e3)
    peak = torch.cuda.max_memory_allocated()
    print(f"  {XLSTM_ARCH}: peak device memory {peak / 2**30:.3f} GiB",
          flush=True)
    report.update({"arch": XLSTM_ARCH, "layers": cfg.num_layers,
                   "d_model": cfg.d_model, "vocab": cfg.vocab_size,
                   "launches": launches,
                   "prefill_ms": eng.prefill_times[0] * 1e3,
                   "decode_p50_ms": st["p50_s"] * 1e3,
                   "decode_p99_ms": st["p99_s"] * 1e3,
                   "teacher_forced": forced, "peak_gib": peak / 2**30,
                   "profile_decode": prof})
    del eng, params, params32
    torch.cuda.empty_cache()
    return report


# ---------------------------------------------------------------------------
# 10d. the encoder-decoder and vision-language families: whisper-large-v3
# and llava-next-mistral-7b at full width and depth through the model API
# (the engine serves neither, as in JAX)
# ---------------------------------------------------------------------------

WHISPER_ARCH = "whisper-large-v3"
LLAVA_ARCH = "llava-next-mistral-7b"
# aligned waves of 4 prompts (their lengths), LM_NEW new tokens each
WHISPER_WAVES = ((4, 4, 4, 4), (64, 64, 64, 64))
LLAVA_WAVES = ((640, 640, 640, 640),)      # 576 patches + 64 text tokens


def serve_api(torch, api, params, cfg, batches, log=None):
    """Each batch through ``api.prefill`` and ``LM_NEW`` greedy
    ``decode_step`` s, as the engine serves an LM wave (the prefill picks
    the first token; the last step's logits go unused). Returns the
    streams per wave, the prefill times (ms) and the decode-step times (s;
    each wave's first step left out, as in the engine's statistics), host
    clock to a synchronize; ``log`` collects every call's fp32 logits."""
    streams, prefill_ms, steps = [], [], []
    with torch.no_grad():
        for batch in batches:
            torch.cuda.synchronize()
            t0 = time.monotonic()
            logits, cache = api.prefill(params, cfg, batch)
            torch.cuda.synchronize()
            prefill_ms.append((time.monotonic() - t0) * 1e3)
            toks = []
            for t in range(LM_NEW):
                if log is not None:
                    log.append(logits.float().clone())
                toks.append(logits.argmax(-1))
                t0 = time.monotonic()
                logits, cache = api.decode_step(params, cfg, cache, toks[-1])
                torch.cuda.synchronize()
                if t:
                    steps.append(time.monotonic() - t0)
            if log is not None:
                log.append(logits.float().clone())
            streams.append(torch.stack(toks, 1).cpu().tolist())
            del cache
    return streams, prefill_ms, steps


def serve_api_counted(torch, api, params, cfg, batches, label, per_prefill,
                      per_step):
    """The waves through the kernels with the counters zeroed just before
    and the plain versions watched: exactly ``per_prefill`` flash
    attention launches a prefill and ``per_step`` flash decode launches a
    step, no plain version, no other kernel. Returns the streams, the
    log, the launches and the times."""
    from repro_torch.kernels.gru_sequence import kernel as K
    from repro_torch.kernels.slstm_cell import kernel as SK
    log = []
    K.reset_launch_counts()
    t0 = time.monotonic()
    with plain_calls() as plain:
        streams, prefill_ms, steps = serve_api(torch, api, params, cfg,
                                               batches, log)
    served_s = time.monotonic() - t0
    launches, others = served_launches(K, SK)
    n_pre, n_steps = len(batches), len(batches) * LM_NEW
    print(f"  launches: {launches}; other kernels {others}; plain versions "
          f"{plain}", flush=True)
    check(not any(plain.values()), f"{label}: plain versions ran {plain}")
    check(not any(others.values()), f"{label}: other kernels ran {others}")
    check(launches == {"flash_attention": per_prefill * n_pre,
                       "flash_decode": per_step * n_steps},
          f"{label}: launches {launches} != ({per_prefill} x {n_pre} "
          f"prefills, {per_step} x {n_steps} steps)")
    check(all(len(s) == LM_NEW for w in streams for s in w),
          f"{label}: stream lengths")
    check(all(bool(torch.isfinite(x).all()) and
              tuple(x.shape) == (LM_SLOTS, cfg.vocab_size) for x in log),
          f"{label}: non-finite or misshapen logits")
    p50, p99 = (float(np.percentile(steps, q)) * 1e3 for q in (50, 99))
    print(f"  {label}: {n_pre} prefills (S = "
          f"{[b['tokens'].shape[1] for b in batches]}, {LM_SLOTS} requests "
          f"each), {n_steps} decode steps in {served_s:.1f} s; "
          f"flash_attention {per_prefill} per prefill, flash_decode "
          f"{per_step} per step; prefill "
          f"{[round(x, 4) for x in prefill_ms]} ms, decode p50 {p50:.4f} ms "
          f"p99 {p99:.4f} ms (host clock, synchronized)", flush=True)
    return streams, log, launches, {"prefill_ms": prefill_ms,
                                    "decode_p50_ms": p50,
                                    "decode_p99_ms": p99}


def chunked_rule(torch, api, params, cfg, batches, streams, log, waves, tol,
                 label):
    """The same waves through ``attn_impl="chunked"`` on the same params:
    the streams equal or, where they part, the chunked run's top two
    logits within ``tol``; returns the largest logit difference along the
    shared prefixes and the partings."""
    cfg_c = cfg.replace(attn_impl="chunked")
    log_c = []
    streams_c, _, _ = serve_api(torch, api, params, cfg_c, batches, log_c)
    worst, parted = compare_lm_runs(streams, log, streams_c, log_c, waves)
    check(all(p["top2_gap"] <= tol for p in parted),
          f"{label}: streams part where chunked's top two logits are more "
          f"than {tol} apart: {parted}")
    print(f"  bf16 cuda vs bf16 chunked: logits along the served tokens "
          f"within {worst:.4g} (reported); token streams "
          + ("equal" if not parted else
             f"part in {len(parted)} of {LM_SLOTS * len(waves)} requests, "
             f"each where chunked's top two logits are within "
             f"{max(p['top2_gap'] for p in parted):.4g} (tol {tol}): "
             f"{parted}"), flush=True)
    return worst, parted


def run_whisper_path(torch, dev, cfg=None):
    """whisper-large-v3 at full width and depth through the model API
    (``cfg``: a smaller same-family config for a CPU rehearsal): flash
    attention for the encoder, the decoder's causal prefill and the
    cross-attention, flash decode for the self ring and the cross cache;
    bf16 against chunked, and fp32 served against the fp32 teacher-forced
    forward (the self ring's headroom on the card)."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.params import init_params
    from repro_torch.models import api as mapi
    from repro_torch.models import whisper
    cfg = cfg or get_config(WHISPER_ARCH)
    check(cfg.attn_impl == "cuda" and cfg.dtype == "bfloat16"
          and cfg.family == "audio", f"{WHISPER_ARCH}: config {cfg}")
    L, Le = cfg.num_layers, cfg.encoder.num_layers
    api = mapi.get_api(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, report = served_params(torch, dev, cfg, whisper,
                                   WHISPER_ARCH)
    batches = api_batches(torch, cfg, WHISPER_WAVES, dev)
    streams, log_a, launches, times = serve_api_counted(
        torch, api, params, cfg, batches, WHISPER_ARCH, Le + 2 * L, 2 * L)
    worst, parted = chunked_rule(torch, api, params, cfg, batches, streams,
                                 log_a, WHISPER_WAVES, LM_LOGIT_TOL,
                                 WHISPER_ARCH)
    # a decode step reads the decoder's weights but the cross-attention's
    # K/V projections (the cross K/V were projected at prefill), and the
    # tied embedding whole (the unembedding)
    cross = params["dec_blocks"]["cross_attn"]
    weights = sum(tree_bytes(params[k]) for k in ("dec_blocks", "embed",
                                                  "final_norm")) - \
        tree_bytes(cross["wk"]) - tree_bytes(cross["wv"])
    prof = profile_decode_step(torch, api, params, cfg, batches[1],
                               times["decode_p50_ms"], weights)
    peak16 = torch.cuda.max_memory_allocated()
    del params
    torch.cuda.empty_cache()
    # fp32: the same seed's fp32 tree, served through the kernels' fp32
    # paths and held against its own teacher-forced forward
    params32 = init_params(whisper.lm_specs(cfg), seed=0, device=dev)
    cfg32 = cfg.replace(dtype="float32")
    log32 = []
    streams32, _, _ = serve_api(torch, api, params32, cfg32, batches, log32)
    e32 = max_diff(torch.stack(log32), forced_logits(
        torch, api, params32, cfg32, batches, streams32))
    check(e32 <= FP32_SERVED_TOL, f"{WHISPER_ARCH}: fp32 served logits "
          f"differ from the fp32 teacher-forced forward by {e32:.4g} > "
          f"{FP32_SERVED_TOL}")
    e16 = max_diff(torch.stack(log_a), forced_logits(
        torch, api, params32, cfg32, batches, streams))
    print(f"  fp32 served vs the fp32 teacher-forced forward {e32:.4g} (tol "
          f"{FP32_SERVED_TOL}; the self ring's 64 empty slots, the cross "
          f"cache); bf16 served vs the fp32 forward on the bf16 streams "
          f"{e16:.4g} (reported); fp32 streams "
          f"{'equal' if streams32 == streams else 'differ from'} the bf16 "
          f"streams", flush=True)
    peak = max(peak16, torch.cuda.max_memory_allocated())
    print(f"  {WHISPER_ARCH}: peak device memory {peak / 2**30:.3f} GiB "
          f"(bf16 run {peak16 / 2**30:.3f}; then the fp32 tree alone)",
          flush=True)
    report.update({
        "arch": WHISPER_ARCH, "layers": [Le, L], "d_model": cfg.d_model,
        "heads": [cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim],
        "frames": cfg.encoder.num_frames, "vocab": cfg.vocab_size,
        "waves": [list(w) for w in WHISPER_WAVES], "launches": launches,
        **times, "logits_vs_chunked": worst,
        "streams_equal_chunked": not parted, "parted": parted,
        "fp32_vs_fp32_forward": e32, "bf16_vs_fp32_forward": e16,
        "fp32_streams_equal_bf16": streams32 == streams,
        "peak_gib": peak / 2**30, "profile_decode": prof})
    del params32
    torch.cuda.empty_cache()
    return launches, report


def run_llava_path(torch, dev, cfg=None):
    """llava-next-mistral-7b at full width and depth through the model API
    (``cfg``: a smaller same-family config for a CPU rehearsal): the
    projector's patches in the first 576 positions of a 640-token prefill
    through flash attention, flash decode at G = 4; bf16 against chunked
    on the same params (the fp32 tree, 29 GB, is never built)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import api as mapi
    from repro_torch.models import llava
    cfg = cfg or get_config(LLAVA_ARCH)
    check(cfg.attn_impl == "cuda" and cfg.dtype == "bfloat16"
          and cfg.family == "vlm", f"{LLAVA_ARCH}: config {cfg}")
    L = cfg.num_layers
    api = mapi.get_api(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, report = served_params(torch, dev, cfg, llava, LLAVA_ARCH)
    batches = api_batches(torch, cfg, LLAVA_WAVES, dev)
    streams, log_a, launches, times = serve_api_counted(
        torch, api, params, cfg, batches, LLAVA_ARCH, L, L)
    worst, parted = chunked_rule(torch, api, params, cfg, batches, streams,
                                 log_a, LLAVA_WAVES, MOE_TOP2_TOL, LLAVA_ARCH)
    # a decode step reads every weight but the projector's and the
    # embedding's (B rows of it)
    weights = tree_bytes(params) - tree_bytes(params["projector"]) - \
        tree_bytes(params["embed"]) + LM_SLOTS * cfg.d_model * 2
    prof = profile_decode_step(torch, api, params, cfg, batches[0],
                               times["decode_p50_ms"], weights)
    peak = torch.cuda.max_memory_allocated()
    print(f"  {LLAVA_ARCH}: peak device memory {peak / 2**30:.3f} GiB",
          flush=True)
    report.update({
        "arch": LLAVA_ARCH, "layers": L, "d_model": cfg.d_model,
        "heads": [cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim],
        "patches": [cfg.vision.num_patches, cfg.vision.embed_dim],
        "vocab": cfg.vocab_size, "waves": [list(w) for w in LLAVA_WAVES],
        "launches": launches, **times, "logits_vs_chunked": worst,
        "streams_equal_chunked": not parted, "parted": parted,
        "peak_gib": peak / 2**30, "profile_decode": prof})
    del params
    torch.cuda.empty_cache()
    return launches, report


# ---------------------------------------------------------------------------
# 11. the paper's row-wise primitives through their entry points
# ---------------------------------------------------------------------------

STEP_BF16_TOL = 1e-2    # bf16 u: r*h may round to the other bf16 neighbour
MM_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
# (B, H, variant, u dtype, the kernel JAX's dispatch rule names): the
# paper's configs (gru-jet H=20, gru-jet-deep H=32), the widths JAX's
# 12 MiB rule sends to the blocked kernel, v3 and an H that block_n = 256
# does not divide (fused at any width)
STEP_SHAPES = (
    [(B, H, v, dt, "gru_step_fused") for B in (1, 8) for H in (20, 32)
     for v in ("v1", "v3") for dt in ("float32", "bfloat16")]
    + [(B, H, "v1", "float32", "gru_step_blocked") for B in (1, 8)
       for H in (1024, 2048)]
    + [(B, 2048, "v1", "bfloat16", "gru_step_blocked") for B in (1, 8)]
    + [(B, 1024, "v3", "float32", "gru_step_fused") for B in (1, 8)]
    + [(B, 1000, "v1", "float32", "gru_step_fused") for B in (1, 8)])
# (B, K, N, dtype, 1-D x): JAX's test shapes, the paper's matvec (also as
# a 1-D x), qwen3-0.6b's MLP up and down matvecs at 4 requests, and ragged
# shapes whose rows 16-byte copies cannot read (bf16 N = 20 and 100: the
# plain-load route)
MATMUL_SHAPES = (
    [(B, K_, N, dt, False) for (B, K_, N) in ((1, 16, 32), (4, 96, 256),
                                              (8, 128, 128), (2, 64, 512))
     for dt in ("float32", "bfloat16")]
    + [(8, 32, 96, "float32", False), (1, 32, 96, "float32", True)]
    + [(4, K_, N, dt, False) for (K_, N) in ((1024, 3072), (3072, 1024))
       for dt in ("bfloat16", "float32")]
    + [(3, 40, 20, "bfloat16", False), (5, 1000, 100, "bfloat16", False),
       (1, 1000, 20, "float32", False)])


def step_inputs(torch, B, H, dtype, seed, dev):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, H, generator=g).to(dev),
            torch.randn(B, 3 * H, generator=g).to(dev),
            (torch.randn(H, 3 * H, generator=g) * H ** -0.5).to(dev)
            .to(getattr(torch, dtype)),
            (0.1 * torch.randn(3 * H, generator=g)).to(dev))


def mm_inputs(torch, B, K_, N, dtype, seed, dev):
    g = torch.Generator().manual_seed(seed)
    dt = getattr(torch, dtype)
    return (torch.randn(B, K_, generator=g).to(dev).to(dt),
            (torch.randn(K_, N, generator=g) * K_ ** -0.5).to(dev).to(dt))


def run_rowwise_path(torch, dev):
    """Every shape through ``gru_step_cuda``, ``rowwise`` and ``cascade``
    with the counters zeroed just before: each call must raise exactly its
    kernel's counter by one (the kernel JAX's rule names), no plain version
    and no other kernel may run; then every output is held against its
    plain version on the card. Returns the launches and {kernel: {dtype:
    max |err|}}."""
    from repro_torch.kernels.gru_cell import ops as cops
    from repro_torch.kernels.gru_cell import ref as cref
    from repro_torch.kernels.gru_sequence import kernel as K
    from repro_torch.kernels.rowwise_matvec import kernel as MK
    from repro_torch.kernels.rowwise_matvec import ops as mops
    from repro_torch.kernels.rowwise_matvec import ref as mref
    from repro_torch.kernels.slstm_cell import kernel as SK
    steps = [(c, step_inputs(torch, c[0], c[1], c[3], i, dev))
             for i, c in enumerate(STEP_SHAPES)]
    mms = []
    for i, c in enumerate(MATMUL_SHAPES):
        x, w = mm_inputs(torch, c[0], c[1], c[2], c[3], 100 + i, dev)
        mms.append((c, (x[0] if c[4] else x, w)))
    counters = {k.__name__: k for k in K.ROWWISE_KERNELS}

    def call(fn, want):
        before = {n: k.launches for n, k in counters.items()}
        out = fn()
        delta = {n: k.launches - before[n] for n, k in counters.items()}
        check(delta == {n: int(n == want) for n in counters},
              f"{want}: launches {delta}")
        return out
    from repro_torch.kernels.gru_cell import kernel as CK
    sms = CK.sm_count(dev)
    K.reset_launch_counts()                          # the row-wise path
    got, plans = [], []
    with plain_calls() as plain:
        for (B, H, v, dt, kern), a in steps:
            got.append(call(lambda: cops.gru_step_cuda(*a, v), kern))
            plans.append(getattr(CK, kern).last_plan)
        for c, (x, w) in mms:
            got.append((call(lambda: mops.rowwise(x, w), "rowwise_matmul"),
                        call(lambda: mops.cascade(x, w), "cascade_matmul"),
                        (MK.rowwise_matmul.last_plan.route,
                         MK.cascade_matmul.last_plan.route)))
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in counters.items()}
    others = {k.__name__: k.launches
              for k in (K.KERNELS + K.Q8_KERNELS + K.CHAIN_Q8_KERNELS
                        + SK.SLSTM_KERNELS + K.ATTN_KERNELS
                        + K.SHARD_KERNELS)}
    print(f"  launches: {launches}; other kernels {others}; plain versions "
          f"{plain}", flush=True)
    check(not any(plain.values()), f"row-wise path: plain versions ran "
          f"{plain}")
    check(not any(others.values()), f"row-wise path: other kernels ran "
          f"{others}")
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the row-wise path never launched: {launches}")
    err = {n: {"float32": 0.0, "bfloat16": 0.0} for n in ROWWISE}
    for ((B, H, v, dt, kern), a), y, p in zip(steps, got, plans):
        want = cref.gru_step_ref(*a, v)
        tol = TOL if dt == "float32" else STEP_BF16_TOL
        e = (y - want).abs().max().item()
        err[kern][dt] = max(err[kern][dt], e)
        head = f"{kern} B={B} H={H} {v} u {dt}"
        check(y.dtype == torch.float32 and bool(torch.isfinite(y).all())
              and torch.allclose(y, want, rtol=tol, atol=tol),
              f"{head}: max |err| {e:.3g} (tol {tol})")
        # the plan's route, against the column tile the step took before
        # (forced through the C entries; no counter moves) and against a
        # second launch of itself
        check(p == CK.step_plan(B, H, v, a[2].dtype, kern, sms),
              f"{head}: launched {p}, the plan names "
              f"{CK.step_plan(B, H, v, a[2].dtype, kern, sms)}")
        blocked = kern == "gru_step_blocked"
        old = step_route_fn(torch, a, v, step_old_route(B, H, v, a[2].dtype,
                                                        kern), blocked)()
        again = step_route_fn(torch, a, v, p, blocked)()
        torch.cuda.synchronize()
        e_old = (y - old).abs().max().item()
        check(torch.allclose(old, want, rtol=tol, atol=tol)
              and torch.allclose(y, old, rtol=tol, atol=tol),
              f"{head}: old route max |err| "
              f"{(old - want).abs().max().item():.3g}, new - old {e_old:.3g}"
              f" (tol {tol})")
        check(torch.equal(y, again), f"{head}: two launches of {p.route} "
              f"differ")
        print(f"  gru_step_cuda B={B} H={H:4d} {v} u {dt:8s} -> {kern} "
              f"({p.route}): max |kernel - plain| {e:.3g}, |new - old route| "
              f"{e_old:.3g}", flush=True)
    for ((B, K_, N, dt, vec), (x, w)), (yr, yc, routes) in zip(
            mms, got[len(steps):]):
        x2 = x[None] if vec else x
        bk = mops.auto_blocks(x2.shape[0], K_, N, x2.element_size())[2]
        es = []
        for name, y, want in (
                ("rowwise_matmul", yr, mref.rowwise_matmul_ref(x2, w)),
                ("cascade_matmul", yc,
                 mref.cascade_matmul_ref(x2, w, bk).to(x.dtype))):
            y = y[None] if vec else y
            e = (y.float() - want.float()).abs().max().item()
            err[name][dt] = max(err[name][dt], e)
            es.append(e)
            check(y.dtype == x.dtype and bool(torch.isfinite(y.float()).all())
                  and torch.allclose(y.float(), want.float(),
                                     rtol=MM_TOL[dt], atol=MM_TOL[dt]),
                  f"{name} B={B} K={K_} N={N} {dt}: max |err| {e:.3g}")
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        want = (MK.plan(x2, w, K_, sms).route, MK.plan(x2, w, bk, sms).route)
        check(routes == want and ((routes[0] == "plain")
                                  == (not MK.aligned(x2, w))),
              f"rowwise / cascade B={B} K={K_} N={N} {dt}: routes {routes}, "
              f"expected {want}, plain loads exactly where unaligned")
        print(f"  rowwise / cascade B={B} K={K_:4d} N={N:4d} {dt:8s}"
              f"{' (1-D x)' if vec else ''}: max |kernel - plain| "
              f"{es[0]:.3g} / {es[1]:.3g} ({routes[0]})", flush=True)
    print(f"  {len(steps)} steps and {len(mms)} x 2 matmuls, each on the "
          f"kernel JAX's rule names and the route its plan names, within "
          f"tolerance of its plain version (step fp32 {TOL}, bf16 u "
          f"{STEP_BF16_TOL}; matmuls {MM_TOL}); each step also of the "
          f"column tile forced beside it, and equal to a second launch",
          flush=True)
    return launches, err


# ---------------------------------------------------------------------------
# 11b. the mesh path: gru-jet-deep split across ranks on the one card
# ---------------------------------------------------------------------------

MESHES = ((2, "gloo"), (4, "gloo"), (1, "nccl"))   # (ranks, backend)
MESH_ARCHS = ("gru-jet-deep", "gru-jet-deep v3")
MESH_TIMEOUT_S = 420
# shard kernel launches per step of gru-jet-deep (row-wise, cascade,
# row-wise): v1 row-wise layers run the z/r and candidate kernels, the v1
# cascade layer the matvec, its middle phase and its update; v3 row-wise
# layers one step kernel, the v3 cascade layer the matvec and its gates
PER_STEP = {
    "gru-jet-deep": {"gru_rowwise_shard_zr": 2,
                     "gru_rowwise_shard_candidate": 2,
                     "gru_shard_matvec": 1, "gru_cascade_shard_zr": 1,
                     "gru_cascade_shard_update": 1},
    "gru-jet-deep v3": {"gru_rowwise_shard_step": 2, "gru_shard_matvec": 1,
                        "gru_cascade_shard_gates": 1},
}


def mesh_configs():
    from repro_torch.configs.base import get_config
    deep = get_config("gru-jet-deep")
    return {MESH_ARCHS[0]: deep,
            MESH_ARCHS[1]: deep.replace(gru=dataclasses.replace(
                deep.gru, variant="v3"))}


def all_kernels():
    """Every kernel wrapper of the port, by name."""
    from repro_torch.kernels.gru_sequence import kernel as K
    from repro_torch.kernels.slstm_cell import kernel as SK
    return {k.__name__: k for k in (
        K.KERNELS + K.Q8_KERNELS + K.CHAIN_Q8_KERNELS + SK.SLSTM_KERNELS
        + K.ATTN_KERNELS + K.ROWWISE_KERNELS + K.SHARD_KERNELS)}


def serve_on_mesh(torch, cfg, params, backend, dev, ctx):
    """One wave through ``ServeEngine`` on this rank, with every counter
    zeroed just before: (engine, streams, launches by kernel, plain calls,
    prefill buckets)."""
    from repro_torch.kernels.gru_sequence import kernel as K
    from repro_torch.launch.serve import make_requests
    from repro_torch.serve.engine import ServeEngine
    cfg = cfg.replace(gru=dataclasses.replace(cfg.gru, backend=backend))
    eng = ServeEngine(cfg, params, max_batch=SLOTS, device=dev, ctx=ctx)
    buckets = []
    record = eng._record_prefill

    def recording(S, dt):
        buckets.append(S)
        record(S, dt)
    eng._record_prefill = recording
    reqs = make_requests(cfg, REQUESTS, MAX_PROMPT, True, MAX_NEW, seed=3)
    K.reset_launch_counts()                         # the mesh path
    with plain_calls() as plain:
        done = eng.generate(reqs)
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in all_kernels().items()}
    return eng, [r.out for r in done], launches, dict(plain), buckets


def time_collectives(mesh_cls, torch):
    """Host time spent in the mesh's collectives (each synchronized on
    return) while the block runs: a dict that fills as it goes."""
    spent = {"s": 0.0, "calls": 0}
    saved = (mesh_cls.all_gather, mesh_cls.psum)

    def timed(fn):
        def wrapped(self, *args):
            t0 = time.perf_counter()
            out = fn(self, *args)
            torch.cuda.synchronize()
            spent["s"] += time.perf_counter() - t0
            spent["calls"] += 1
            return out
        return wrapped
    mesh_cls.all_gather, mesh_cls.psum = map(timed, saved)
    return spent, saved


def profile_mesh_decode(torch, cfg, params, dev, ctx):
    """A served cuda_sharded decode step of gru-jet-deep on this rank, 8
    slots, after 10 warm steps: 20 steps timed on the host clock with the
    host time inside the collectives summed (each synchronized on return),
    then 20 under ``torch.profiler`` for the device time (the profiler
    slows the collectives, so it times none). Every rank runs it; the
    collectives keep the ranks in step."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.launch.serve import make_requests
    from repro_torch.serve.engine import ServeEngine
    cfg = cfg.replace(gru=dataclasses.replace(cfg.gru,
                                              backend="cuda_sharded"))
    eng = ServeEngine(cfg, params, max_batch=SLOTS, device=dev, ctx=ctx)
    eng.gru_wave_begin(make_requests(cfg, SLOTS, 10, False, 64, seed=1))
    for _ in range(10):
        eng.gru_wave_step()
    torch.cuda.synchronize()
    spent, saved = time_collectives(Mesh, torch)
    try:
        t0 = time.monotonic()
        for _ in range(20):
            eng.gru_wave_step()
        torch.cuda.synchronize()
        wall = (time.monotonic() - t0) / 20
    finally:
        Mesh.all_gather, Mesh.psum = saved
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            eng.gru_wave_step()
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    shard = {k: us for k, us in kernels.items()      # gru_shard.cu's
             if "shard" in k or "cascade_" in k}
    mesh = ctx.mesh
    route = ("none (one rank, no group: identities)" if mesh.group is None
             else f"{dist_backend(mesh)}, {mesh.size} rank(s) on one card"
             + (" (through the host)" if dist_backend(mesh) == "gloo"
                else ""))
    busy = sum(kernels.values()) / 20 / 1e6
    return {"wall_ms_per_step": wall * 1e3,
            "shard_kernels_ms_per_step": sum(shard.values()) / 20 / 1e3,
            "device_busy_ms_per_step": busy * 1e3,
            "device_idle_share": 1 - busy / wall,
            "collectives_ms_per_step": spent["s"] / 20 * 1e3,
            "collectives_per_step": spent["calls"] / 20,
            "collective_route": route,
            "top_device": sorted(((k[:60], us / 20) for k, us in
                                  kernels.items()), key=lambda kv: -kv[1])[:6]}


def cascade_layer_kernels(torch, cfg, params, dev, mesh, steps=20):
    """What the cascade layer's step puts on the card on this rank:
    ``rowparallel._cascade_step_cuda`` at gru-jet-deep's (v1) or its v3
    twin's cascade layer (this rank's placed views, 8 slots), ``steps``
    calls under ``torch.profiler``. v3: each step launches the partial
    product (row 15) and the gates epilogue (row 16) once and no cat or
    add kernel (the slice copies and the bias add that ran around row 16
    before). v1: each step launches the partial product, the middle phase
    (row 17) and the update (row 18) once, and one add kernel (the psum +
    b beside row 17; ``_ht_in``'s two adds before row 18 are gone). The
    psum's own entries (its copy, NCCL's kernel, gloo's memcpys) may run.
    Returns the wrappers' launch counts over the recorded steps and the
    profile's device entries' counts by name."""
    from torch.autograd import DeviceType
    from repro_torch.core import gru as gru_core
    from repro_torch.core import rowparallel as rp
    from repro_torch.kernels.gru_sequence import kernel as K
    gcfg = cfg.gru
    layers = rp.prepare_sharded_layers(gru_core.stack_cell_params(params),
                                       gcfg, mesh=mesh)
    l = next(i for i in range(len(layers))
             if gcfg.layer_matvec_mode(i) == "cascade")
    a = layers[l]
    H = a["w"].shape[1] // 3
    g = torch.Generator().manual_seed(9)
    h = (0.5 * torch.randn(SLOTS, H // mesh.size, generator=g)).to(dev)
    xp = torch.randn(SLOTS, 3 * H, generator=g).to(dev)

    variant = gcfg.variant
    # the wrappers' own launch counters beside the profile: the kernels a
    # step of this variant launches, and those it must not
    wrappers = {"shard_matvec": K.gru_shard_matvec,
                "cascade_gates_k": K.gru_cascade_shard_gates,
                "cascade_zr": K.gru_cascade_shard_zr,
                "cascade_update_k": K.gru_cascade_shard_update}
    expected = ({"shard_matvec": steps, "cascade_gates_k": 0,
                 "cascade_zr": steps, "cascade_update_k": steps}
                if variant == "v1" else
                {"shard_matvec": steps, "cascade_gates_k": steps,
                 "cascade_zr": 0, "cascade_update_k": 0})

    def step():
        return rp._cascade_step_cuda(h, xp, a["u"], a["b"], mesh.rank,
                                     mesh=mesh, variant=variant)
    step()
    torch.cuda.synchronize()
    window = []

    def body():
        before = {k: w.launches for k, w in wrappers.items()}
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        window.append({k: w.launches - before[k]
                       for k, w in wrappers.items()})
    who = f"rank {mesh.rank}/{mesh.size}"
    prof = profiled(torch, body)
    counted = window[-1]            # the recorded cycle's launches
    counts = {e.key: e.count for e in prof.key_averages()
              if getattr(e, "device_type", None) == DeviceType.CUDA
              and e.count}

    def launched(part):
        return sum(c for k, c in counts.items() if part in k)
    check(counts, f"{who}: the profiler recorded no device entry of the "
          f"{variant} cascade layer")
    check(counted == expected, f"{who}: the {variant} cascade layer's "
          f"{steps} steps launched {counted} by the wrappers' counters, "
          f"not {expected}")
    # the kernels' counts are the wrappers' (exact by construction); the
    # profile must hold each launched kernel's entries, never more than its
    # wrapper launched and at most one fewer (a record of the first step
    # lost by the profiler while its wrapper counted the launch: seen with
    # four ranks profiling one card), printed beside both counts
    seen = {k: launched(k) for k in wrappers}
    check(all(n - 1 <= seen[k] <= n for k, n in counted.items() if n)
          and not any(seen[k] for k, n in counted.items() if not n),
          f"{who}: the profile's {variant} cascade entries {seen} against "
          f"the wrappers' launches {counted}")
    if seen != counted:
        print(f"    {who}: the profile recorded {seen} device entries of "
              f"the {variant} cascade kernels where their wrappers counted "
              f"{counted} launches in the same window: device records "
              f"lost by the profiler", flush=True)
    out = {"wrapper_launches": counted, "profile": counts}
    if variant == "v1":
        adds = sum(c for k, c in counts.items() if "add" in k.lower())
        check(adds == steps, f"{who}: {adds} add kernels in the v1 cascade "
              f"layer's {steps} steps, not one a step (the psum + b beside "
              f"row 17): {counts}")
        return out
    around = [k for k in counts if "cat" in k.lower() or "add" in k.lower()]
    check(not around, f"{who}: cat or add kernels around row 16 in the v3 "
          f"cascade layer: {around}")
    return out


def dist_backend(mesh) -> str:
    import torch.distributed as dist
    return str(dist.get_backend(mesh.group))


def mesh_rank_main(rank: int, n: int, backend: str, store: str,
                   out: str) -> None:
    """One rank of the mesh path (``chip_smoke.py --mesh-rank``): serve
    gru-jet-deep v1 and v3 pinned to ``cuda_sharded`` through
    ``ServeEngine(..., ctx=ShardCtx(mesh))`` and check this rank's
    launches, attribution, streams (against the replicated eager engine on
    the card) and prefill logits; then once under ``backend="cuda"``.
    Writes this rank's results to ``out`` as JSON; any failure exits
    non-zero."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.core import gru as gru_core
    from repro_torch.core.params import init_params
    from repro_torch.distributed import ShardCtx, init_mesh
    from repro_torch.models import gru_lm
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    mesh = init_mesh(n, rank, init_file=store, device=dev, backend=backend,
                     timeout_s=120)
    ctx = ShardCtx(mesh)
    who = f"rank {rank}/{n} ({backend})"
    result = {"rank": rank, "ranks": n, "backend": backend, "runs": {}}
    cpu = torch.device("cpu")
    for a, cfg in mesh_configs().items():
        # made on the host: a pinned mesh engine puts only this rank's
        # slices on the card
        params = init_params(gru_lm.lm_specs(cfg), seed=0, device=cpu)
        eng, streams, launches, plain, buckets = serve_on_mesh(
            torch, cfg, params, "cuda_sharded", dev, ctx)
        st = eng.latency_stats()
        steps_run = st["steps"] + 1
        check(set(eng.prefill_backends) == {"cuda_sharded"},
              f"{who} {a}: prefill backends {set(eng.prefill_backends)}")
        check(st["decode_backend_steps"] == {"cuda_sharded": st["steps"]},
              f"{who} {a}: decode steps {st['decode_backend_steps']}")
        check(all(t.device == cpu for c in eng.params["cells"]
                  for t in c.values())
              and all(t.device == dev for c in eng.params["placed_cells"]
                      for t in c.values()),
              f"{who} {a}: the full cells went to the card")
        per_step = PER_STEP[a]
        want = {k: per_step.get(k, 0) * (sum(buckets) + steps_run)
                for k in launches}
        check(launches == want, f"{who} {a}: launches {launches} != {want} "
              f"(buckets {buckets}, {steps_run} steps)")
        check(not any(plain.values()), f"{who} {a}: plain versions ran "
              f"{plain}")
        params = to_device(params, dev)
        _, eager = serve(cfg, params, "eager", dev)
        check(streams == eager, f"{who} {a}: streams differ from the eager "
              f"engine")
        # prefill logits against the dense v1 oracle (v3: the eager stack)
        g = torch.Generator().manual_seed(5)
        xs = torch.randn(3, 7, cfg.gru.input_dim, generator=g).to(dev)
        cfg_s = cfg.replace(gru=dataclasses.replace(cfg.gru,
                                                    backend="cuda_sharded"))
        logits, _ = gru_lm.prefill(eng.params, cfg_s, {"features": xs},
                                   ctx=ctx)
        h0s = gru_core.stack_h0(cfg.gru, 3, device=dev)
        cells = gru_core.stack_cell_params(params)
        if cfg.gru.variant == "v1":
            finals, _ = gru_core.gru_stack_reference(cells, h0s, xs)
        else:
            finals, _ = gru_core.gru_stack_sequence_eager(cells, h0s, xs,
                                                          cfg=cfg.gru)
        want_logits = finals[-1] @ params["head"]["w"] + params["head"]["b"]
        e = (logits - want_logits).abs().max().item()
        check(tuple(logits.shape) == (3, cfg.gru.num_classes)
              and bool(torch.isfinite(logits).all()) and e <= TOL,
              f"{who} {a}: prefill logits vs reference {e:.3g}")
        result[f"cascade_layer_{cfg.gru.variant}"] = cascade_layer_kernels(
            torch, cfg, params, dev, mesh)
        result["runs"][a] = {
            "streams": streams, "buckets": buckets, "steps_run": steps_run,
            "launches": {k: v for k, v in launches.items() if v},
            "logits_err_vs_reference": e,
            "decode_p50_ms": st["p50_s"] * 1e3,
            "decode_p99_ms": st["p99_s"] * 1e3,
            "prefill_mean_ms": st["prefill_mean_s"] * 1e3}
    # backend="cuda" under the mesh: the split serves prefill, decode stays
    # replicated on the fused kernel (decode_cost), as JAX's rule has it
    a, cfg = MESH_ARCHS[0], mesh_configs()[MESH_ARCHS[0]]
    params = init_params(gru_lm.lm_specs(cfg), seed=0, device=cpu)
    shapes, routes = {n: {} for n in FUSED_DECODE}, {n: {} for n in
                                                     FUSED_DECODE}
    with decode_calls(shapes, routes):
        eng, streams, launches, plain, buckets = serve_on_mesh(
            torch, cfg, params, "cuda", dev, ctx)
    check_decode_routes("gru_stack_decode_kernel", routes)
    st = eng.latency_stats()
    steps_run = st["steps"] + 1
    check(set(eng.prefill_backends) == {"cuda_sharded"},
          f"{who} cuda: prefill backends {set(eng.prefill_backends)}")
    check(st["decode_backend_steps"] == {"cuda_fused": st["steps"]},
          f"{who} cuda: decode steps {st['decode_backend_steps']}")
    want = {k: PER_STEP[a].get(k, 0) * sum(buckets) for k in launches}
    want["gru_stack_decode_kernel"] = steps_run
    check(launches == want, f"{who} cuda: launches {launches} != {want}")
    check(not any(plain.values()), f"{who} cuda: plain versions ran {plain}")
    check(streams == result["runs"][a]["streams"],
          f"{who} cuda: streams differ from the cuda_sharded run")
    result["cuda_run"] = {"launches": {k: v for k, v in launches.items()
                                       if v}, "buckets": buckets,
                          "steps_run": steps_run,
                          "decode_shapes": [
                              [list(k), n] for k, n in
                              shapes["gru_stack_decode_kernel"].items()]}
    result["profile"] = profile_mesh_decode(torch, cfg, params, dev, ctx)
    check("jax" not in sys.modules and "repro" not in sys.modules,
          f"{who}: the JAX package was imported")
    Path(out).write_text(json.dumps(result))
    dist.destroy_process_group()


def profile_mesh_steps(torch, dev, mesh_report):
    """The served cuda_sharded decode step of gru-jet-deep: on a one-rank
    mesh without a group (this process; the collectives are identities),
    v1 and its v3 twin (whose row-wise layers run the step kernel), and,
    from phase 11b's rank 0 (v1), over a 1-rank NCCL group and 2- and
    4-rank gloo meshes sharing the card. Returns the profiles by mesh."""
    from repro_torch.core.params import init_params
    from repro_torch.distributed import ShardCtx, local_mesh
    from repro_torch.models import gru_lm
    out = {}
    for a, cfg in mesh_configs().items():     # v1, then v3 (the step kernel)
        params = init_params(gru_lm.lm_specs(cfg), seed=0,
                             device=torch.device("cpu"))
        out["local" + a[len(MESH_ARCHS[0]):]] = profile_mesh_decode(
            torch, cfg, params, dev, ShardCtx(local_mesh(dev)))
    for n, backend in MESHES:
        out[f"{n}x{backend}"] = mesh_report[f"{n}x{backend}"]["profile"]
    for name, pr in out.items():
        variant = "v3" if name.endswith("v3") else "v1"
        print(f"  decode step (gru-jet-deep {variant}, cuda_sharded, {SLOTS} "
              f"slots, mesh {name}, rank 0, 20 steps): wall "
              f"{pr['wall_ms_per_step']:.4f} ms/step; shard kernels "
              f"{pr['shard_kernels_ms_per_step']:.4f} ms/step, all device "
              f"work {pr['device_busy_ms_per_step']:.4f} ms/step (idle "
              f"{pr['device_idle_share']:.3%}); host time in the "
              f"collectives {pr['collectives_ms_per_step']:.4f} ms/step over"
              f" {pr['collectives_per_step']:.0f} calls; route: "
              f"{pr['collective_route']}", flush=True)
        for k, us in pr["top_device"]:
            print(f"    {us:9.2f} us/step  {k}")
    print("  the collectives' times are one card's (gloo through the host, "
          "or a one-rank NCCL group): no measure of NCCL across cards",
          flush=True)
    return out


def cascade_step_before(h_shard, xp_full, u_rows, b_full, idx, *, mesh,
                        variant):
    """``rowparallel._cascade_step_cuda`` as it ran before rows 16 and 18
    read their operands in place: v3's psum + b, this rank's slices of g
    and xp copied out, the contiguous call; v1's candidate pre-activation
    added by ``_ht_in``'s two adds before the contiguous update: phase 12's
    "before" of the served v3 and v1 steps."""
    from repro_torch.core import rowparallel as rp
    from repro_torch.kernels.gru_sequence import kernel as K
    h32 = h_shard.float()
    if variant == "v3":
        return old_epilogue(mesh.psum(K.gru_shard_matvec(h32, u_rows)),
                            xp_full, b_full, h32, idx)
    H, Hl = xp_full.shape[-1] // 3, h32.shape[1]
    zr = (mesh.psum(K.gru_shard_matvec(h32, u_rows[:, :2 * H]))
          + b_full[:2 * H])
    z, ht_p = K.gru_cascade_shard_zr(
        rp._local_gates(zr, 2, H, idx, Hl),
        rp._local_gates(xp_full, 2, H, idx, Hl), h32, u_rows[:, 2 * H:])
    return K.gru_cascade_shard_update(
        z, rp._ht_in(xp_full, mesh.psum(ht_p), b_full, H, idx, Hl), h32)


def steps_both_ways(torch, dev):
    """The served steps rows 7, 16 and 18 sit in, each with the old route
    forced and with the new, in turns old, new, new, old: gru-jet-deep's
    ``cuda_chain_q8`` decode step (``profile_decode``; old: the q8 step's
    block route at its old tile) and its v3 twin's and its own (v1)
    ``cuda_sharded`` steps on a one-rank mesh without a group
    (``profile_mesh_decode``; old: :func:`cascade_step_before`). Returns
    {step: [(which, profile)]}."""
    from repro_torch.core import rowparallel as rp
    from repro_torch.core.params import init_params
    from repro_torch.distributed import ShardCtx, local_mesh
    from repro_torch.kernels.gru_cell import kernel as CK
    from repro_torch.models import gru_lm
    out = {"cuda_chain_q8": [], "cuda_sharded v3": [],
           "cuda_sharded v1": []}
    planner, impls = CK.step_q8_plan, dict(rp._STEP_IMPLS)

    def block_plan(B, H, variant):
        return step_q8_block_route(B, H)
    meshed = {}
    for step, arch in (("cuda_sharded v3", MESH_ARCHS[1]),
                       ("cuda_sharded v1", MESH_ARCHS[0])):
        cfg = mesh_configs()[arch]
        meshed[step] = (cfg, init_params(gru_lm.lm_specs(cfg), seed=0,
                                         device=torch.device("cpu")))
    for which in ("old", "new", "new", "old"):
        try:
            if which == "old":
                CK.step_q8_plan = block_plan
                rp._STEP_IMPLS["cuda"] = (impls["cuda"][0],
                                          cascade_step_before)
            out["cuda_chain_q8"].append((which, profile_decode(
                torch, dev, "cuda_chain_q8")))
            for step, (cfg, params) in meshed.items():
                out[step].append((which, profile_mesh_decode(
                    torch, cfg, params, dev, ShardCtx(local_mesh(dev)))))
        finally:
            CK.step_q8_plan = planner
            rp._STEP_IMPLS.update(impls)
    for step, runs in out.items():
        for which, pr in runs:
            if pr is None:
                print(f"  served step {step} {which}: not measured (no device"
                      f" time recorded)", flush=True)
                continue
            extra = (f", shard kernels {pr['shard_kernels_ms_per_step']:.4f}"
                     f" ms/step" if "shard_kernels_ms_per_step" in pr else "")
            print(f"  served step gru-jet-deep {step} ({SLOTS} slots, 20 "
                  f"steps) {which}: wall {pr['wall_ms_per_step']:.4f} ms/step,"
                  f" device busy {pr['device_busy_ms_per_step']:.4f} ms/step"
                  f"{extra} (idle {pr['device_idle_share']:.3%})", flush=True)
    return out


def decode_steps_both_ways(torch, dev):
    """The served gru-jet-deep decode steps rows 3 and 5 sit in (``cuda``,
    which serves it through ``cuda_fused``, and ``cuda_fused_q8``), each
    with both fused decode kernels' block routes forced (at their old
    tiles) and with the plans, in turns old, new, new, old
    (``profile_decode``). Returns {backend: [(which, profile)]}."""
    from repro_torch.kernels.gru_sequence import kernel as K
    out = {"cuda": [], "cuda_fused_q8": []}
    plans = K.decode_plan, K.decode_q8_plan

    def forced(q8):
        def plan(B, H, L, variant, batch_block=0):
            return decode_block_route(K, B, H, L, q8)
        return plan
    for which in ("old", "new", "new", "old"):
        try:
            if which == "old":
                K.decode_plan, K.decode_q8_plan = forced(False), forced(True)
            for backend in out:
                out[backend].append((which, profile_decode(torch, dev,
                                                           backend)))
        finally:
            K.decode_plan, K.decode_q8_plan = plans
    for backend, runs in out.items():
        for which, pr in runs:
            if pr is None:
                print(f"  served step {backend} {which}: not measured (no "
                      f"device time recorded)", flush=True)
                continue
            print(f"  served step gru-jet-deep {backend} ({SLOTS} slots, 20 "
                  f"steps) {which}: wall {pr['wall_ms_per_step']:.4f} ms/step,"
                  f" device busy {pr['device_busy_ms_per_step']:.4f} ms/step "
                  f"(idle {pr['device_idle_share']:.3%})", flush=True)
    return out


def slstm_steps_both_ways(torch, dev):
    """The served sLSTM decode steps row 9 sits in (slstm-jet and the L=3
    H=32 stack through ``cuda_fused``), with the decode's block route
    forced at its old tile (which reads (L,B,H) stacks, so the state is
    stacked around it, as it was before the table of per-layer pointers)
    and with the plan, in turns old, new, new, old (``profile_decode``). On
    the warp route the step must run no copy of its state: no
    ``aten::stack`` or ``aten::cat`` in its profile. Returns {arch:
    [(which, profile)]}."""
    from repro_torch.kernels import _launch
    from repro_torch.kernels.slstm_cell import kernel as SK
    cfgs = slstm_configs()
    out = {a: [] for a in SLSTM_ARCHS}
    planner = SK.slstm_decode_plan

    def forced(B, H, L, batch_block=0):
        return SK.block_plan(B, H, L, min(B, _launch.DEFAULT_BATCH_BLOCK))
    for which in ("old", "new", "new", "old"):
        try:
            if which == "old":
                SK.slstm_decode_plan = forced
            for a in out:
                out[a].append((which, profile_decode(
                    torch, dev, "cuda_fused", a, cfgs[a])))
        finally:
            SK.slstm_decode_plan = planner
    for a, runs in out.items():
        for which, pr in runs:
            check(which == "old" or pr is not None, f"{a}: the served decode "
                  f"step on the warp route was not profiled (no device time "
                  f"recorded), so its copies were not counted")
            if pr is None:
                print(f"  served step {a} {which}: not measured (no device "
                      f"time recorded)", flush=True)
                continue
            copies = pr["stack_ops_per_step"] + pr["cat_ops_per_step"]
            check(which == "old" or copies == 0, f"{a}: the served decode "
                  f"step on the warp route copies its state ({copies:g} "
                  f"aten::stack/aten::cat ops a step)")
            print(f"  served step {a} cuda_fused ({SLOTS} slots, 20 steps) "
                  f"{which}: wall {pr['wall_ms_per_step']:.4f} ms/step, "
                  f"device busy {pr['device_busy_ms_per_step']:.4f} ms/step "
                  f"(idle {pr['device_idle_share']:.3%}), aten::stack "
                  f"{pr['stack_ops_per_step']:g} and aten::cat "
                  f"{pr['cat_ops_per_step']:g} a step", flush=True)
    return out


def run_mesh_path(torch):
    """Spawn each mesh of ``MESHES`` on the one card (the libraries are
    built), wait for its ranks, and hold them against each other: every
    rank exits 0, and all ranks of all meshes serve the same streams.
    Returns (launches summed over the pinned runs of every rank, the
    report)."""
    import tempfile
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    report, streams = {}, None
    launches = {n: 0 for n in SHARD + ("gru_stack_decode_kernel",)}
    for n, backend in MESHES:
        t0 = time.monotonic()
        procs = []
        try:
            for r in range(n):
                procs.append(subprocess.Popen(
                    [sys.executable, str(ROOT / "chip_smoke.py"),
                     "--mesh-rank", str(r), str(n), backend,
                     str(work / f"store{n}{backend}"),
                     str(work / f"rank{n}{backend}{r}.json")]))
            deadline = time.monotonic() + MESH_TIMEOUT_S
            for p in procs:
                p.wait(timeout=max(deadline - time.monotonic(), 1.0))
        except subprocess.TimeoutExpired:
            fail(f"mesh of {n} ({backend}): a rank did not end within "
                 f"{MESH_TIMEOUT_S} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        codes = [p.returncode for p in procs]
        check(codes == [0] * n, f"mesh of {n} ({backend}): rank exit codes "
              f"{codes}")
        ranks = [json.loads((work / f"rank{n}{backend}{r}.json").read_text())
                 for r in range(n)]
        for res in ranks:
            got = {a: res["runs"][a]["streams"] for a in MESH_ARCHS}
            streams = streams or got
            check(got == streams, f"mesh of {n}: rank {res['rank']}'s "
                  f"streams differ from rank 0 of the first mesh")
            for a in MESH_ARCHS:
                for k, v in res["runs"][a]["launches"].items():
                    launches[k] += v
            # backend="cuda": decode on row 3, counted beside phase 4's
            launches["gru_stack_decode_kernel"] += res["cuda_run"][
                "launches"]["gru_stack_decode_kernel"]
            for key, count in res["cuda_run"]["decode_shapes"]:
                served = DECODE_SHAPES["gru_stack_decode_kernel"]
                served[tuple(key)] = served.get(tuple(key), 0) + count
        r0 = ranks[0]
        print(f"  mesh of {n} ranks ({backend}, one card): every rank exit "
              f"0 in {time.monotonic() - t0:.1f} s; streams equal across "
              f"ranks and to the eager engine", flush=True)
        for a in MESH_ARCHS:
            run = r0["runs"][a]
            print(f"    {a}: buckets {run['buckets']}, {run['steps_run']} "
                  f"steps, rank 0 launches {run['launches']}; logits vs "
                  f"reference {run['logits_err_vs_reference']:.3g}; decode "
                  f"p50 {run['decode_p50_ms']:.4f} ms p99 "
                  f"{run['decode_p99_ms']:.4f} ms (host clock)", flush=True)
        print(f"    backend=cuda: prefill cuda_sharded, decode cuda_fused; "
              f"rank 0 launches {r0['cuda_run']['launches']}", flush=True)
        for v, what in (("v3", "row 16 once a step, no cat or add kernel "
                               "around it"),
                        ("v1", "row 18 once a step, one add a step (the "
                               "psum + b beside row 17)")):
            c = r0[f"cascade_layer_{v}"]
            print(f"    {v} cascade layer, 20 steps under the profiler "
                  f"(rank 0): wrappers' launches {c['wrapper_launches']}; "
                  f"profile {c['profile']} -- {what}", flush=True)
        report[f"{n}x{backend}"] = r0
    check(all(v > 0 for v in launches.values()),
          f"a shard kernel never launched on the mesh path: {launches}")
    return launches, report


# ---------------------------------------------------------------------------
# 11c. MoE under a named mesh: qwen2-moe-a2.7b at full width on four ranks
# ---------------------------------------------------------------------------

MOE_MESH_RANKS = 4
MOE_MESH_TIMEOUT_S = 600
MOE_MESH_CAPACITY = 16.0      # (c): no (token, choice) pair can drop
# (b) on {data 2, model 2}: (tp_mode, profile); "gather" under "sp" takes
# the gather_sp branch. One wave of 4 prompts of 12 tokens and two steps
# (the first step of a wave is left out of the step times): the gather
# modes all-gather each rank's expert F-slices through the host every layer
# of every call (about 15 s a call, PR 37)
MOE_TP_RUNS = (("gather", "default"), ("psum", "default"), ("gather", "sp"))
MOE_TP_WAVES = ((12, 12, 12, 12),)
MOE_TP_NEW = 2
# (d): (d, microbatches, microbatch rows) over 4 stages: JAX's test shapes
# and d = 1024
PIPE_SHAPES = ((16, 8, 4), (1024, 8, 4))
PIPE_TOL = 1e-5
_EXPERT_KEYS = ("wg", "wu", "wd")
_CHUNK = 1 << 28              # bytes a broadcast moves at once


@contextlib.contextmanager
def moe_dispatches(log):
    """Record every dispatch of ``models.moe`` while the block runs: each
    call's (tp_mode, whether it splits over the model axis) and, for the
    calls that fill a capacity buffer, its dropped (token, choice) pairs
    (a device scalar: no sync)."""
    import torch
    from repro_torch.models import moe as moe_mod
    real = moe_mod._dispatch_compute_combine

    def rec(x, probs, eidx, *a, E, C, tp_axis=None, tp_mode="psum",
            tp_size=1, **kw):
        fills = (tp_axis is None or tp_size <= 1 or tp_mode == "psum"
                 or (tp_mode == "gather" and x.shape[0] % tp_size))
        drops = None
        if fills:
            counts = torch.bincount(eidx.reshape(-1), minlength=E)
            drops = (counts - C).clamp(min=0).sum()
        log.append((tp_mode, tp_axis is not None and tp_size > 1, drops))
        return real(x, probs, eidx, *a, E=E, C=C, tp_axis=tp_axis,
                    tp_mode=tp_mode, tp_size=tp_size, **kw)
    moe_mod._dispatch_compute_combine = rec
    try:
        yield log
    finally:
        moe_mod._dispatch_compute_combine = real


def rank_block(x, ps, mesh, r: int):
    """Rank r's block of ``x`` under partition spec ``ps`` on ``mesh``
    (ranks row-major): a view."""
    from repro_torch.distributed.sharding import block
    shape = mesh.shape
    return block(x, ps, mesh, dict(zip(shape, np.unravel_index(
        r, tuple(shape.values())))))


def share_experts(torch, dist, tree, cfg, ctx, dev):
    """This rank's blocks of the experts (``wg``, ``wu``, ``wd``) by JAX's
    in-specs on ``ctx``'s mesh: rank 0 keeps views of its whole tree
    ``tree`` (on the card) and scatters the other ranks' blocks layer by
    layer through the host; the others receive theirs onto ``dev``."""
    from repro_torch.distributed.sharding import resolve_pspec
    from repro_torch.models import moe as moe_mod
    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = ctx.mesh
    out = {}
    for k in _EXPERT_KEYS:
        whole = moe_mod.expert_shapes(cfg)[k]
        ps = resolve_pspec(moe_mod.EXPERT_AXES[k], whole, ctx)
        if rank == 0:
            leaf = tree["blocks"]["moe"][k]
            out[k] = rank_block(leaf, (None,) + tuple(ps), mesh, 0)
            for layer in range(cfg.num_layers):
                parts = [rank_block(leaf[layer], ps, mesh, r).contiguous()
                         .cpu().reshape(-1).view(torch.uint8)
                         for r in range(world)]
                dist.scatter(parts[0].clone(), parts, src=0)
            continue
        mine = rank_block(torch.empty(whole, device="meta"), ps, mesh, rank)
        recv = torch.empty((cfg.num_layers,) + tuple(mine.shape),
                           dtype=torch.bfloat16)
        for layer in range(cfg.num_layers):
            dist.scatter(recv[layer].reshape(-1).view(torch.uint8), None,
                         src=0)
        out[k] = recv.to(dev)
        del recv
    return out


def share_moe_tree(torch, dist, tree, cfg, ctx, dev):
    """Every rank's served tree: the dense leaves whole (rank 0's own, the
    others' broadcast from its card through the host in pieces of
    ``_CHUNK`` bytes) and this rank's expert blocks."""
    from repro_torch.core.params import flatten, unflatten
    from repro_torch.models import transformer
    rank = dist.get_rank()
    box = [None if rank else {p: (tuple(x.shape), str(x.dtype))
                              for p, x in flatten(tree).items()}]
    dist.broadcast_object_list(box, src=0)
    flat = {}
    for path, (shape, dt) in box[0].items():
        if path.split("/")[-1] in _EXPERT_KEYS:
            continue
        if rank == 0:
            flat[path] = flatten(tree)[path]
            buf = flat[path].cpu()
        else:
            buf = torch.empty(shape, dtype=getattr(torch, dt.split(".")[-1]))
        wire = buf.reshape(-1).view(torch.uint8)
        for i in range(0, wire.numel(), _CHUNK):
            dist.broadcast(wire[i:i + _CHUNK], src=0)
        if rank:
            flat[path] = buf.to(dev)
    for k, v in share_experts(torch, dist, tree, cfg, ctx, dev).items():
        flat[f"blocks/moe/{k}"] = v
    return unflatten(transformer.lm_specs(cfg), flat)


def moe_rank_serve(torch, cfg, params, dev, ctx, waves, new, who):
    """One engine on this rank under ``ctx`` serving ``waves`` with every
    counter zeroed just before: (streams, attention launches, dispatch
    log, latency stats)."""
    from repro_torch.kernels.gru_sequence import kernel as K
    from repro_torch.kernels.slstm_cell import kernel as SK
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(cfg, params, max_batch=LM_SLOTS, device=dev, ctx=ctx)
    check(eng.params["blocks"]["moe"]["wg"] is params["blocks"]["moe"]["wg"],
          f"{who}: the engine copied this rank's experts")
    log = []
    K.reset_launch_counts()                           # the MoE mesh path
    with plain_calls() as plain, moe_dispatches(log):
        streams = serve_lm(eng, cfg, waves, new)
    torch.cuda.synchronize()
    launches, others = served_launches(K, SK)
    st = eng.latency_stats()
    L = cfg.num_layers
    prefills, steps_run = st["prefills"], st["steps"] + 1   # one decode key
    check(not any(plain.values()), f"{who}: plain versions ran {plain}")
    check(not any(others.values()), f"{who}: other kernels ran {others}")
    check(launches == {"flash_attention": L * prefills,
                       "flash_decode": L * steps_run},
          f"{who}: launches {launches} != {L} x ({prefills} prefills, "
          f"{steps_run} steps)")
    check(all(len(s) == new for w in streams for s in w),
          f"{who}: stream lengths {[[len(s) for s in w] for w in streams]}")
    return streams, launches, log, st


def moe_mesh_rank(torch, rank: int, n: int, dev, tree=None) -> dict:
    """One rank of phase 11c, in the world ``init_mesh`` joined: rank 0
    (this script's own process, ``tree`` phase 10b's served tree on the
    card) hands every other rank the dense leaves and its expert blocks;
    then (a) the waves on {data n}, (c) the same at capacity factor 16,
    (b) one wave of each TP mode on {data 2, model n/2}, (d) the pipeline
    over {pod n}. Returns this rank's results (rank 0's (c) logits and
    routings under ``"c_logs"``, ``"c_routes"``)."""
    import torch.distributed as dist
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import ShardCtx, named_mesh
    from repro_torch.distributed import pipeline as pp
    from repro_torch.serve.engine import ServeEngine
    meshes = {"data": named_mesh({"data": n}, device=dev),
              "2x2": named_mesh({"data": 2, "model": n // 2}, device=dev),
              "pod": named_mesh({"pod": n}, device=dev)}
    cfg = get_config(MOE_ARCH)
    L = cfg.num_layers
    who = f"rank {rank}/{n}"
    result = {"rank": rank}
    ctx_a = ShardCtx(meshes["data"])
    t0 = time.monotonic()
    params = share_moe_tree(torch, dist, tree, cfg, ctx_a, dev)
    torch.cuda.synchronize()
    share_s = time.monotonic() - t0
    experts = sum(params["blocks"]["moe"][k].numel() * 2
                  for k in _EXPERT_KEYS)
    result["build"] = {"share_s": share_s, "expert_gb": experts / 1e9,
                       "rank_gb": sum(x.numel() * x.element_size()
                                      for x in _leaves(params)) / 1e9,
                       "expert_shape": list(params["blocks"]["moe"]["wg"]
                                            .shape)}
    # (a) expert-parallel on {data n}: phase 10b's waves
    streams, launches, log, st = moe_rank_serve(
        torch, cfg, params, dev, ctx_a, LM_WAVES, LM_NEW, f"{who} (a)")
    check({m for m, _, _ in log} == {cfg.moe.tp_mode}
          and not any(split for _, split, _ in log),
          f"{who} (a): dispatches {set((m, s) for m, s, _ in log)}")
    calls = L * (1 + LM_NEW)                 # a prefill and LM_NEW steps
    drops = [int(sum(d for _, _, d in log[w * calls:(w + 1) * calls]))
             for w in range(len(LM_WAVES))]
    if rank == 0:
        prof = profile_moe_step(torch, dev, params, cfg, ctx=ctx_a)
    else:
        import io
        with contextlib.redirect_stdout(io.StringIO()):   # in step with 0
            prof = profile_moe_step(torch, dev, params, cfg, ctx=ctx_a)
    result["a"] = {"streams": streams, "launches": launches,
                   "dropped_pairs_per_wave": drops,
                   "prefill_mean_ms": st["prefill_mean_s"] * 1e3,
                   "decode_p50_ms": st["p50_s"] * 1e3,
                   "decode_p99_ms": st["p99_s"] * 1e3,
                   "profile_decode": prof}
    # (c) the same waves at capacity factor 16: nothing can drop
    cfg16 = cfg.replace(moe=dataclasses.replace(
        cfg.moe, capacity_factor=MOE_MESH_CAPACITY))
    eng = ServeEngine(cfg16, params, max_batch=LM_SLOTS, device=dev,
                      ctx=ctx_a)
    logs, routes, log = record_logits(eng), [], []
    with recorded_routes(routes), moe_dispatches(log):
        streams16 = serve_lm(eng, cfg16)
    drops16 = int(sum(d for _, _, d in log if d is not None))
    check(drops16 == 0, f"{who} (c): {drops16} pairs dropped at capacity "
          f"factor {MOE_MESH_CAPACITY}")
    result["c"] = {"streams": streams16}
    if rank == 0:                  # held against the one-process run, here
        result["c_logs"], result["c_routes"] = logs, routes
    del eng, logs, routes
    # (b) {data 2, model n/2}: the experts cut again, one wave per TP mode
    for k in _EXPERT_KEYS:
        del params["blocks"]["moe"][k]
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    params["blocks"]["moe"].update(share_experts(
        torch, dist, tree, cfg, ShardCtx(meshes["2x2"]), dev))
    torch.cuda.synchronize()
    result["b_share_s"] = time.monotonic() - t0
    result["b_expert_shape"] = list(params["blocks"]["moe"]["wg"].shape)
    result["b"] = {}
    for mode, profile in MOE_TP_RUNS:
        cfg_b = cfg.replace(moe=dataclasses.replace(cfg.moe, tp_mode=mode))
        label = f"{mode}/{profile}"
        streams_b, launches_b, log, st = moe_rank_serve(
            torch, cfg_b, params, dev, ShardCtx(meshes["2x2"], profile),
            MOE_TP_WAVES, MOE_TP_NEW, f"{who} (b) {label}")
        branch = "gather_sp" if profile == "sp" else mode
        check(bool(log) and log[0][0] == branch and log[0][1],
              f"{who} (b) {label}: first dispatch {log[:1]}, want "
              f"{branch} over the model axis")
        result["b"][label] = {
            "streams": streams_b, "launches": launches_b,
            "prefill_mean_ms": st["prefill_mean_s"] * 1e3,
            "decode_p50_ms": st["p50_s"] * 1e3}
    del params
    torch.cuda.empty_cache()
    # (d) the pipeline over {pod n}: each rank its stage's params
    pod = meshes["pod"]

    def stage_fn(p, x):
        return torch.tanh(x @ p["w"] + p["b"])
    result["d"] = {}
    for d, M, mb in PIPE_SHAPES:
        rng = np.random.default_rng(d)
        scale = 0.5 if d == 16 else d ** -0.5
        whole = {"w": torch.from_numpy((rng.normal(size=(n, d, d)) * scale)
                                       .astype(np.float32)).to(dev),
                 "b": torch.from_numpy((rng.normal(size=(n, d)) * 0.1)
                                       .astype(np.float32)).to(dev)}
        xs = torch.from_numpy(rng.normal(size=(M, mb, d)).astype(
            np.float32)).to(dev)
        stage = {k: v[pod.axis_index("pod")] for k, v in whole.items()}
        torch.cuda.synchronize()
        t0 = time.monotonic()
        got = pp.pipeline_apply(stage_fn, stage, xs, mesh=pod, axis="pod")
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        want = pp.sequential_reference(stage_fn, whole, xs)
        e = (got - want).abs().max().item()
        check(tuple(got.shape) == (M, mb, d) and bool(torch.isfinite(
            got).all()) and e <= PIPE_TOL,
              f"{who} (d) d={d}: pipeline vs sequential {e:.3g}")
        result["d"][f"d{d}"] = {"err": e, "wall_ms": wall * 1e3,
                                "checksum": float(got.double().sum())}
    return result


def moe_rank_main(rank: int, n: int, store: str, out: str) -> None:
    """Ranks 1..n-1 of phase 11c (``chip_smoke.py --moe-rank``): join the
    world of the script's own process (rank 0) on the card and run
    :func:`moe_mesh_rank`; write the results to ``out`` (JSON). Any
    failure exits non-zero."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import init_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    init_mesh(n, rank, init_file=store, device=dev, backend="gloo",
              timeout_s=MOE_MESH_TIMEOUT_S)
    result = moe_mesh_rank(torch, rank, n, dev)
    check("jax" not in sys.modules and "repro" not in sys.modules,
          f"rank {rank}: the JAX package was imported")
    Path(out).write_text(json.dumps(result))
    dist.destroy_process_group()


def run_moe_mesh_path(torch, dev, tree):
    """Phase 11c: this process is rank 0 of four ranks on the one card
    (gloo), serving from phase 10b's served tree ``tree`` (its experts as
    views, nothing copied); ranks 1-3 are this script started again. Then,
    the other ranks gone, the one-process engine serves (c)'s waves on
    ``tree`` at the same capacity factor. Returns (rows 21-22's launches
    summed over every rank's counted runs, the report)."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import init_mesh
    from repro_torch.serve.engine import ServeEngine
    torch.cuda.empty_cache()
    n = MOE_MESH_RANKS
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_moe_mesh_"))
    outs = {r: work / f"rank{r}.json" for r in range(1, n)}
    t0 = time.monotonic()
    procs, logs = [], []
    try:
        for r in range(1, n):
            logs.append(open(work / f"rank{r}.log", "w"))
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--moe-rank",
                 str(r), str(n), str(work / "store"), str(outs[r])],
                stdout=logs[-1], stderr=subprocess.STDOUT))
        init_mesh(n, 0, init_file=str(work / "store"), device=dev,
                  backend="gloo", timeout_s=MOE_MESH_TIMEOUT_S)
        r0 = moe_mesh_rank(torch, 0, n, dev, tree)
        dist.destroy_process_group()
        deadline = time.monotonic() + 120
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        fail("phase 11c: a rank did not end within 120 s of rank 0")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
        codes = [p.returncode for p in procs]
        if any(codes):
            for r in range(1, n):
                print(f"  rank {r} log:\n" + (work / f"rank{r}.log")
                      .read_text()[-3000:], flush=True)
    check(codes == [0] * (n - 1), f"phase 11c: ranks 1-3 exit codes {codes}")
    wall = time.monotonic() - t0
    ranks = [r0] + [json.loads(outs[r].read_text()) for r in range(1, n)]
    for res in ranks[1:]:
        check(res["a"]["streams"] == r0["a"]["streams"],
              f"(a): rank {res['rank']}'s streams differ from rank 0's")
        check(res["c"]["streams"] == r0["c"]["streams"],
              f"(c): rank {res['rank']}'s streams differ from rank 0's")
        for label, b in res["b"].items():
            check(b["streams"] == r0["b"][label]["streams"],
                  f"(b) {label}: rank {res['rank']}'s streams differ")
    cfg = get_config(MOE_ARCH)
    L = cfg.num_layers
    launches = {k: 0 for k in ATTN}
    for res in ranks:
        for run in [res["a"]] + list(res["b"].values()):
            for k in ATTN:
                launches[k] += run["launches"][k]
    b, b1 = r0["build"], ranks[1]["build"]
    print(f"  four ranks (gloo, one card; rank 0 this process, from phase "
          f"10b's tree) done in {wall:.1f} s; rank 1 holds "
          f"{b1['rank_gb']:.3f} GB ({b1['expert_gb']:.3f} GB of experts, wg "
          f"{tuple(b1['expert_shape'])} on {{data 4}}, "
          f"{tuple(ranks[1]['b_expert_shape'])} on {{data 2, model 2}}), "
          f"handed out in {b['share_s']:.1f} s and {r0['b_share_s']:.1f} s",
          flush=True)
    a = r0["a"]
    drops = [sum(res["a"]["dropped_pairs_per_wave"][w] for res in ranks)
             for w in range(len(LM_WAVES))]
    print(f"  (a) {{data 4}}, capacity factor 1.25: streams equal on the "
          f"four ranks; flash_attention {L} a prefill, flash_decode {L} a "
          f"step on every rank ({a['launches']} on rank 0), no plain "
          f"version, no other kernel; dropped (token, choice) pairs per "
          f"wave (the ranks' token blocks summed): {drops}; prefill mean {a['prefill_mean_ms']:.4f} ms, decode p50 "
          f"{a['decode_p50_ms']:.4f} ms p99 {a['decode_p99_ms']:.4f} ms "
          f"(host clock, rank 0; gloo through the host on one card: no "
          f"collective time is a claim)", flush=True)
    for label, run in r0["b"].items():
        print(f"  (b) {{data 2, model 2}} {label}: streams equal on the four "
              f"ranks; launches {run['launches']}; prefill "
              f"{run['prefill_mean_ms']:.4f} ms, decode "
              f"{run['decode_p50_ms']:.4f} ms (host clock, rank 0)",
              flush=True)
    # (c) against the one-process engine at the same factor, on ``tree``
    cfg16 = cfg.replace(moe=dataclasses.replace(
        cfg.moe, capacity_factor=MOE_MESH_CAPACITY))
    eng = ServeEngine(cfg16, tree, max_batch=LM_SLOTS, device=dev)
    ref_logs, ref_routes = record_logits(eng), []
    with recorded_routes(ref_routes):
        ref_streams = serve_lm(eng, cfg16)
    del eng
    worst, parted = compare_lm_runs(r0["c"]["streams"], r0.pop("c_logs"),
                                    ref_streams, ref_logs)
    flips, compared = routing_flips(r0.pop("c_routes"), ref_routes,
                                    r0["c"]["streams"], ref_streams, L)
    check(all(p["top2_gap"] <= MOE_TOP2_TOL for p in parted),
          f"(c): streams part from the one-process run where its top two "
          f"logits are more than {MOE_TOP2_TOL} apart: {parted}")
    print(f"  (c) capacity factor {MOE_MESH_CAPACITY:g} on {{data 4}} vs the "
          f"one-process engine at that factor: token streams "
          + ("equal" if not parted else
             f"part in {len(parted)} of {LM_SLOTS * len(LM_WAVES)} requests, "
             f"each where the one-process run's top two logits are within "
             f"{max(p['top2_gap'] for p in parted):.4g} (tol {MOE_TOP2_TOL})")
          + f"; logits along the shared tokens within {worst:.4g} "
          f"(reported); routing flips {flips} of {compared} (token, layer) "
          f"top-k sets", flush=True)
    for key, d in r0["d"].items():
        sums = {res["d"][key]["checksum"] for res in ranks}
        check(len(sums) == 1, f"(d) {key}: ranks' outputs differ {sums}")
        print(f"  (d) pipeline over {{pod 4}}, {key}: within {d['err']:.3g} "
              f"of sequential_reference on the card (tol {PIPE_TOL}), the "
              f"same on every rank; {d['wall_ms']:.3f} ms (host clock)",
              flush=True)
    report = {"wall_s": wall, "build": b, "rank1_build": b1,
              "a": {k: v for k, v in a.items() if k != "streams"},
              "dropped_pairs_per_wave": drops,
              "b": {k: {x: y for x, y in v.items() if x != "streams"}
                    for k, v in r0["b"].items()},
              "c": {"parted": parted, "logits_vs_one_process": worst,
                    "routing_flips": flips, "routings_compared": compared},
              "d": r0["d"], "launches": launches}
    return launches, report


# ---------------------------------------------------------------------------
# 12. timing
# ---------------------------------------------------------------------------

def call_time_ms(torch, fn, iters: int, warmup: int = 5) -> float:
    """Per call, launched from Python one after another: CUDA events around
    the loop. Includes the host's cost of each call (checks, ctypes,
    allocation) wherever that exceeds the device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_time_ms(torch, fn, per_graph: int, replays: int = 5) -> float:
    """Device time per call: ``per_graph`` calls captured in one CUDA graph
    (measurement only; the port launches eagerly), CUDA events around
    ``replays`` replays, so the host's per-call cost is not in the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (replays * per_graph)


def bound_ms(name, a, masked=None):
    """Least time for the same work: every input read once and every output
    written once over 3.35 TB/s, or the operations the live (unmasked)
    steps need over their type's peak (fp32 67 TFLOP/s, int8 1,979 TOP/s),
    whichever is larger. Decode kernels and ``masked=False`` calls read no
    mask."""
    L, B, H = a["h0"].shape
    decode = name in DECODE
    T = 1 if decode else a["xp"].shape[0]
    masked = not decode if masked is None else masked
    # gate columns, state leaves per layer, elementwise flops per unit
    G, S, E = (4 * H, 4, 32) if name in SLSTM else (3 * H, 1, 14)
    live = float(a["mask"].sum().item()) if masked else B
    # weights, scales and bias: fp32 U, W_deep, b; q8 int8 rows + f32 eff
    w_bytes = (4 * (L * H * G + (L - 1) * H * G + L * G)
               if name not in Q8 else
               (L * G * H + (L - 1) * G * H) + 4 * (L * G + (L - 1) * G
                                                    + L * G))
    n_in = S * L * B * H + T * B * G + (T * B if masked else 0)
    n_out = {"gru_sequence_kernel": T * B * H,
             "gru_sequence_q8_kernel": T * B * H}.get(
        name, S * L * B * H if decode else T * B * H + S * L * B * H)
    nbytes = w_bytes + 4 * (n_in + n_out)
    # per live (row, step): the U matvecs 2*H*G per layer and the next
    # layer's W matvec 2*H*G below the top; elementwise E*H per layer (GRU
    # 14, sLSTM 32 counting each exp, log1p, tanh and division as one; q8
    # adds the dequant 6H, two activation quantizations 8H per layer and
    # the deep projection's 3H + 4H)
    mac_ops = live * (L * 2 * H * G + (L - 1) * 2 * H * G)
    if name in Q8:
        f32_ops = live * (L * 28 * H + (L - 1) * 7 * H)
        t_ops = (mac_ops / INT8_OP_PER_S + f32_ops / FP32_FLOP_PER_S) * 1e3
    else:
        t_ops = (mac_ops + live * L * E * H) / FP32_FLOP_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cudnn_gru_ms(torch, dev, T=32, B=SLOTS, H=32, L=1):
    """Device time (graph replay) of one ``torch.nn.GRU`` call (cuDNN) on
    the v3 unmasked work of an L-layer stack at (T, B, H): row 1's (L = 1,
    T = 32), row 2's and, at T = 1, row 3's; a yardstick, timed here only
    (the port never calls it; it has no v1). The kernels' operands mapped
    as ROADMAP's ground rules say: torch's gate order r, z, n; its z is 1 -
    v3's z, so the z rows of its weights and bias are negated; each U and
    b go to ``weight_hh`` and ``bias_hh``, ``bias_ih`` is 0; x_proj is its
    input, through a ``weight_ih_l0`` that is an exact signed permutation
    (so cuDNN does one (T*B, 3H) x (3H, 3H) product more than the kernel),
    and each deep layer's ``weight_ih`` is its W (``w_deep``), mapped the
    same way. Its output is first held against the plain v3 version
    within TOL."""
    from repro_torch.kernels.gru_sequence import ref
    a = make_inputs(torch, L, H, B, T, seed=7, dev=dev)
    h0, xp, u, wd, b = a["h0"], a["xp"], a["u"], a["wd"], a["b"]
    eye, zero = torch.eye(H, device=dev), torch.zeros(H, H, device=dev)

    def gates(m):          # (K, 3H) [z | r | h] -> torch's (3H, K) [r|z|n]
        return torch.cat([m[:, H:2 * H].T, -m[:, :H].T, m[:, 2 * H:].T])
    gru = torch.nn.GRU(3 * H, H, num_layers=L).to(dev)
    with torch.no_grad():
        gru.weight_ih_l0.copy_(torch.cat([torch.cat([zero, eye, zero], 1),
                                          torch.cat([-eye, zero, zero], 1),
                                          torch.cat([zero, zero, eye], 1)]))
        for l in range(L):
            if l:
                getattr(gru, f"weight_ih_l{l}").copy_(gates(wd[l - 1]))
            getattr(gru, f"weight_hh_l{l}").copy_(gates(u[l]))
            getattr(gru, f"bias_ih_l{l}").zero_()
            getattr(gru, f"bias_hh_l{l}").copy_(gates(b[l][None])[:, 0])
        out, hn = gru(xp, h0)
        if L == 1:
            want = ref.gru_sequence_ref(h0[0], xp, u[0], b[0], None, "v3")
            e = (out - want).abs().max().item()
        elif T == 1:
            want = ref.gru_stack_decode_ref(h0, xp[0], u, wd, b, "v3")
            e = (hn - want).abs().max().item()
        else:
            want = ref.gru_stack_sequence_ref(h0, xp, u, wd, b, None, "v3")
            e = max((out - want[0]).abs().max().item(),
                    (hn - want[1]).abs().max().item())
        check(e <= TOL, f"torch.nn.GRU mapping (L={L} T={T}): max |GRU - "
              f"plain v3| {e:.3g} > {TOL}")
        return device_time_ms(torch, lambda: gru(xp, h0), per_graph=50)


TIMED = (("gru_sequence_kernel", (1, 20)),
         ("gru_stack_sequence_kernel", (3, 32)),
         ("gru_stack_decode_kernel", (3, 32)),
         ("gru_stack_decode_kernel", (1, 20)),
         ("gru_stack_sequence_q8_kernel", (3, 32)),
         ("gru_stack_sequence_q8_kernel", (1, 20)),
         ("gru_stack_decode_q8_kernel", (3, 32)),
         ("gru_stack_decode_q8_kernel", (1, 20)),
         ("gru_sequence_q8_kernel", (1, 32)),
         ("gru_sequence_q8_kernel", (1, 20)),
         ("gru_step_q8", (1, 32)),
         ("gru_step_q8", (1, 20)),
         ("slstm_stack_sequence_kernel", (1, 20)),
         ("slstm_stack_sequence_kernel", (3, 32)),
         ("slstm_stack_decode_kernel", (1, 20)),
         ("slstm_stack_decode_kernel", (3, 32)))


def time_kernels(torch, dev, err, launches, mesh_launches):
    """Kernel, plain-version and bound times at the main path's shapes;
    the JSON rows are the 8-slot shapes (gru-jet fp32 prefill, gru-jet-deep
    for the others: L=3 for the fused kernels, one H=32 layer for the q8
    chain's; slstm-jet, L=1 H=20, for the sLSTM kernels). ``launches``:
    each kernel's count from its main path's run; ``mesh_launches``: the
    fused decode kernels' from phase 11b's ``backend="cuda"`` runs, kept
    apart in their rows and counted beside ``launches`` in the served
    launches x gap."""
    from repro_torch.kernels.gru_cell import kernel as CK
    from repro_torch.kernels.gru_sequence import kernel as K
    from repro_torch.kernels.gru_sequence import ref
    from repro_torch.kernels.slstm_cell import kernel as SK
    rows = []
    # main-path shapes: 8 slots, a 16-step bucket, v1 (the configs' variant)
    for name, (L, H) in TIMED:
        for B in (1, SLOTS, 64):
            decode = name in DECODE
            T = 1 if decode else 16
            a = inputs_for(torch, name, L, H, B, T, 7, dev)

            def kern():
                return run_kernel(K, ref, name, a, "v1", not decode,
                                  plain=False)

            def plain_fn():
                return run_kernel(K, ref, name, a, "v1", not decode,
                                  plain=True)
            ms = device_time_ms(torch, kern, per_graph=200)
            plain = device_time_ms(torch, plain_fn, per_graph=4 if T > 1
                                   else 50)
            call = call_time_ms(torch, kern, iters=300)
            plain_call = call_time_ms(torch, plain_fn, iters=10)
            bms, by = bound_ms(name, a)
            before = ""
            if name == "gru_sequence_kernel":
                blk = device_time_ms(torch, seq_route_fn(
                    torch, a, "v1", True, block_route(K, B, H)),
                    per_graph=200)
                before = (f"  block route {blk * 1e3:8.2f} us; plan "
                          f"{K.gru_sequence_kernel.last_plan}")
            if name == "gru_step_q8":
                blk = device_time_ms(torch, step_q8_route_fn(
                    torch, q8_step_args(a), "v1", step_q8_block_route(B, H)),
                    per_graph=200)
                before = (f"  block route {blk * 1e3:8.2f} us; plan "
                          f"{CK.gru_step_q8.last_plan}")
            if name in FUSED_DECODE:
                q8 = name == "gru_stack_decode_q8_kernel"
                blk = device_time_ms(torch, decode_route_fn(
                    torch, a, "v1", decode_block_route(K, B, H, L, q8), q8),
                    per_graph=200)
                before = (f"  block route {blk * 1e3:8.2f} us; plan "
                          f"{getattr(K, name).last_plan}")
            if name in PREFILLS:
                blk = device_time_ms(torch, prefill_routes(
                    torch, K, name, a, "v1", True)[1], per_graph=200)
                before = (f"  block route {blk * 1e3:8.2f} us; plan "
                          f"{getattr(K, name).last_plan}")
            if name in SLSTM:
                blk = device_time_ms(torch, slstm_routes(
                    torch, name, a, not decode)[1], per_graph=200)
                before = (f"  block route {blk * 1e3:8.2f} us; plan "
                          f"{getattr(SK, name).last_plan}")
            print(f"  {name:28s} L={L} H={H} B={B:2d} T={T:2d}: device "
                  f"{ms * 1e3:8.2f} us (per call {call * 1e3:7.2f})  plain "
                  f"{plain * 1e3:9.2f} us (per call {plain_call * 1e3:9.2f})"
                  f"  bound {bms * 1e6:7.2f} ns ({by}){before}", flush=True)
            if B == SLOTS and (
                    (name in SLSTM and L == 1) or (name not in SLSTM and (
                        name == "gru_sequence_kernel" or L == 3
                        or (name in CHAIN_Q8 and H == 32)))):
                rows.append({
                    "name": name, "route": "cuda",
                    "source": KERNEL_SOURCE[name],
                    "replaces": REPLACES[name],
                    "launches": launches[name], "max_abs_err": err[name],
                    "ms": ms, "plain_ms": plain, "bound_ms": bms,
                    "bound_by": by, "library_ms": None,
                    "call_ms": call, "plain_call_ms": plain_call,
                    "shape": {"L": L, "H": H, "B": B, "T": T,
                              "variant": None if name in SLSTM else "v1"}})
                if name == "gru_sequence_kernel":
                    rows[-1]["plan"] = str(K.gru_sequence_kernel.last_plan)
                    rows[-1]["block_route_ms"] = blk
                if name == "gru_step_q8":
                    rows[-1]["plan"] = str(CK.gru_step_q8.last_plan)
                    rows[-1]["block_route_ms"] = blk
                if name in FUSED_DECODE:
                    rows[-1]["plan"] = str(getattr(K, name).last_plan)
                    rows[-1]["block_route_ms"] = blk
                    rows[-1]["mesh_launches"] = mesh_launches.get(name, 0)
                if name in PREFILLS or name in SLSTM:
                    rows[-1]["plan"] = str(getattr(
                        SK if name in SLSTM else K, name).last_plan)
                    rows[-1]["block_route_ms"] = blk
    # the fp32 chain's decode layer: the depth-1 sequence kernel at T=1,
    # unmasked (a row of PERF.md, not of the JSON line)
    for H in (32, 20):
        for B in (1, SLOTS, 64):
            a = make_inputs(torch, 1, H, B, 1, seed=7, dev=dev)

            def step(plain):
                return run_kernel(K, ref, "gru_sequence_kernel", a, "v1",
                                  False, plain=plain)
            ms = device_time_ms(torch, lambda: step(False), per_graph=200)
            plain = device_time_ms(torch, lambda: step(True), per_graph=50)
            call = call_time_ms(torch, lambda: step(False), iters=300)
            blk = device_time_ms(torch, seq_route_fn(
                torch, a, "v1", False, block_route(K, B, H)), per_graph=200)
            bms, by = bound_ms("gru_sequence_kernel", a, masked=False)
            print(f"  {'gru_sequence_kernel (chain decode)':28s} L=1 H={H} "
                  f"B={B:2d} T= 1: device {ms * 1e3:8.2f} us (per call "
                  f"{call * 1e3:7.2f})  plain {plain * 1e3:9.2f} us  bound "
                  f"{bms * 1e6:7.2f} ns ({by})  block route "
                  f"{blk * 1e3:8.2f} us", flush=True)
    # row 1's served launches by shape (phases 4 and 6: the gru-jet
    # prefills, the chain's layers by T): device time, bound, and the
    # launches times the gap summed over the shapes
    check(sum(SEQ_SHAPES.values()) == launches["gru_sequence_kernel"],
          f"gru_sequence_kernel: served calls by shape {SEQ_SHAPES} do not "
          f"sum to its {launches['gru_sequence_kernel']} launches")
    gap_us = gap_block_us = 0.0
    for (T, B, H), count in sorted(SEQ_SHAPES.items()):
        a = make_inputs(torch, 1, H, B, T, seed=7, dev=dev)
        ms = device_time_ms(torch, lambda: run_kernel(
            K, ref, "gru_sequence_kernel", a, "v1", T > 1, plain=False),
            per_graph=50)
        plan = K.gru_sequence_kernel.last_plan
        blk = device_time_ms(torch, seq_route_fn(
            torch, a, "v1", T > 1, block_route(K, B, H)), per_graph=50)
        bms, _ = bound_ms("gru_sequence_kernel", a, masked=T > 1)
        gap_us += count * (ms - bms) * 1e3
        gap_block_us += count * (blk - bms) * 1e3
        print(f"  gru_sequence_kernel served T={T:2d} B={B} H={H}: {count:3d} "
              f"launches, device {ms * 1e3:7.2f} us ({plan.route} rows="
              f"{plan.rows} warps={plan.warps} depth={plan.depth}), block "
              f"route {blk * 1e3:7.2f} us, bound {bms * 1e6:6.2f} ns",
              flush=True)
    print(f"  gru_sequence_kernel: launches x (device - bound) over its "
          f"{sum(SEQ_SHAPES.values())} served launches = {gap_us:.0f} us "
          f"(block route forced: {gap_block_us:.0f} us)", flush=True)
    # row 7's served launches by shape (phase 7: the q8 chain's decode
    # layers), likewise
    check(sum(STEP_Q8_SHAPES.values()) == launches["gru_step_q8"],
          f"gru_step_q8: served calls by shape {STEP_Q8_SHAPES} do not sum "
          f"to its {launches['gru_step_q8']} launches")
    gap_us = gap_block_us = 0.0
    for (B, H), count in sorted(STEP_Q8_SHAPES.items()):
        a = make_inputs(torch, 1, H, B, 1, seed=7, dev=dev)
        ms = device_time_ms(torch, lambda: run_kernel(
            K, ref, "gru_step_q8", a, "v1", False, plain=False),
            per_graph=200)
        plan = CK.gru_step_q8.last_plan
        blk = device_time_ms(torch, step_q8_route_fn(
            torch, q8_step_args(a), "v1", step_q8_block_route(B, H)),
            per_graph=200)
        bms, _ = bound_ms("gru_step_q8", a)
        gap_us += count * (ms - bms) * 1e3
        gap_block_us += count * (blk - bms) * 1e3
        print(f"  gru_step_q8 served B={B} H={H}: {count:3d} launches, device "
              f"{ms * 1e3:7.2f} us ({plan.route} warps={plan.warps}), block "
              f"route {blk * 1e3:7.2f} us, bound {bms * 1e6:6.2f} ns",
              flush=True)
    print(f"  gru_step_q8: launches x (device - bound) over its "
          f"{sum(STEP_Q8_SHAPES.values())} served launches = {gap_us:.0f} us "
          f"(block route forced: {gap_block_us:.0f} us)", flush=True)
    # rows 3 and 5's served launches by shape (phase 4 and phase 11b's
    # backend="cuda" ranks; phase 5), likewise, the block route forced
    for name in FUSED_DECODE:
        q8 = name == "gru_stack_decode_q8_kernel"
        served = DECODE_SHAPES[name]
        total = launches[name] + mesh_launches.get(name, 0)
        check(sum(served.values()) == total, f"{name}: served calls by "
              f"shape {served} do not sum to its {launches[name]} main-path "
              f"and {mesh_launches.get(name, 0)} mesh launches")
        gap_us = gap_block_us = 0.0
        for (L, B, H), count in sorted(served.items()):
            a = make_inputs(torch, L, H, B, 1, seed=7, dev=dev)
            ms = device_time_ms(torch, lambda: run_kernel(
                K, ref, name, a, "v1", False, plain=False), per_graph=200)
            plan = getattr(K, name).last_plan
            blk = device_time_ms(torch, decode_route_fn(
                torch, a, "v1", decode_block_route(K, B, H, L, q8), q8),
                per_graph=200)
            bms, _ = bound_ms(name, a)
            gap_us += count * (ms - bms) * 1e3
            gap_block_us += count * (blk - bms) * 1e3
            print(f"  {name} served L={L} B={B} H={H}: {count:3d} launches, "
                  f"device {ms * 1e3:7.2f} us ({plan.route} warps="
                  f"{plan.warps}), block route "
                  f"{blk * 1e3:7.2f} us, bound {bms * 1e6:6.2f} ns",
                  flush=True)
        print(f"  {name}: launches x (device - bound) over its "
              f"{sum(served.values())} served launches = {gap_us:.0f} us "
              f"(block route forced: {gap_block_us:.0f} us)", flush=True)
    # rows 2, 4 and 6's served launches by shape (phase 4: gru-jet-deep's
    # prefills; phase 5: both configs' q8 prefills; phase 7: the q8 chain's
    # layers), likewise, the block route forced
    for name in PREFILLS:
        served = PREFILL_SHAPES[name]
        check(sum(served.values()) == launches[name], f"{name}: served "
              f"calls by shape {served} do not sum to its "
              f"{launches[name]} launches")
        gap_us = gap_block_us = 0.0
        for key, count in sorted(served.items()):
            L, (T, B, H) = (key[0], key[1:]) if len(key) == 4 else (1, key)
            a = make_inputs(torch, L, H, B, T, seed=7, dev=dev)
            ms = device_time_ms(torch, lambda: run_kernel(
                K, ref, name, a, "v1", True, plain=False), per_graph=50)
            plan = getattr(K, name).last_plan
            blk = device_time_ms(torch, prefill_routes(
                torch, K, name, a, "v1", True)[1], per_graph=50)
            bms, _ = bound_ms(name, a)
            gap_us += count * (ms - bms) * 1e3
            gap_block_us += count * (blk - bms) * 1e3
            print(f"  {name} served L={L} T={T} B={B} H={H}: {count:3d} "
                  f"launches, device {ms * 1e3:7.2f} us ({plan.route} route, "
                  f"{plan.grid} blocks of {plan.warps} warps), block "
                  f"route {blk * 1e3:7.2f} us, bound {bms * 1e6:6.2f} ns",
                  flush=True)
        print(f"  {name}: launches x (device - bound) over its "
              f"{sum(served.values())} served launches = {gap_us:.0f} us "
              f"(block route forced: {gap_block_us:.0f} us)", flush=True)
    # rows 9 and 8's served launches by shape (phase 8: slstm-jet and the
    # L=3 H=32 stack; the prefills at their served prompt bucket),
    # likewise, the block route forced
    for name in SLSTM:
        served = SLSTM_SHAPES[name]
        check(sum(served.values()) == launches[name], f"{name}: served "
              f"calls by shape {served} do not sum to its "
              f"{launches[name]} launches")
        gap_us = gap_block_us = 0.0
        for key, count in sorted(served.items()):
            L, T, B, H = key if len(key) == 4 else (key[0], 1) + key[1:]
            a = make_slstm_inputs(torch, L, H, B, T, seed=7, dev=dev)
            masked = name == "slstm_stack_sequence_kernel"
            ms = device_time_ms(torch, lambda: run_slstm_kernel(
                name, a, masked, plain=False), per_graph=50)
            plan = getattr(SK, name).last_plan
            blk = device_time_ms(torch, slstm_routes(torch, name, a,
                                                     masked)[1],
                                 per_graph=50)
            bms, _ = bound_ms(name, a)
            gap_us += count * (ms - bms) * 1e3
            gap_block_us += count * (blk - bms) * 1e3
            print(f"  {name} served L={L} T={T} B={B} H={H}: {count:3d} "
                  f"launches, device {ms * 1e3:7.2f} us ({plan.route} route,"
                  f" {plan.grid} blocks of {plan.threads // 32} warps), "
                  f"block route "
                  f"{blk * 1e3:7.2f} us, bound {bms * 1e6:6.2f} ns",
                  flush=True)
        print(f"  {name}: launches x (device - bound) over its "
              f"{sum(served.values())} served launches = {gap_us:.0f} us "
              f"(block route forced: {gap_block_us:.0f} us)", flush=True)
    # rows 4 and 6 at 8 slots, v1 masked, at the T=16 bucket and the served
    # T=32, both routes (the JSON rows are T=16)
    for name, L, H in (("gru_sequence_q8_kernel", 1, 32),
                       ("gru_sequence_q8_kernel", 1, 20),
                       ("gru_stack_sequence_q8_kernel", 3, 32),
                       ("gru_stack_sequence_q8_kernel", 1, 20)):
        for T in (16, 32):
            a = make_inputs(torch, L, H, SLOTS, T, seed=7, dev=dev)
            ms = device_time_ms(torch, lambda: run_kernel(
                K, ref, name, a, "v1", True, plain=False), per_graph=50)
            blk = device_time_ms(torch, prefill_routes(
                torch, K, name, a, "v1", True)[1], per_graph=50)
            bms, _ = bound_ms(name, a)
            print(f"  {name} L={L} H={H} B={SLOTS} T={T} v1 masked: "
                  f"{getattr(K, name).last_plan.route} route {ms * 1e3:.2f} "
                  f"us, block route {blk * 1e3:.2f} us, bound "
                  f"{bms * 1e6:.2f} ns", flush=True)
    print(f"  torch.nn.GRU (cuDNN) yardstick, v3 T=32 B={SLOTS} H=32: "
          f"{cudnn_gru_ms(torch, dev) * 1e3:.2f} us", flush=True)
    # rows 2 and 3's yardstick: torch.nn.GRU over L layers on the same v3
    # unmasked work, beside the kernel on it (row 2 at its T=16 bucket and
    # the served T=32, with its block route forced beside)
    for name, L, H, T in (("gru_stack_sequence_kernel", 3, 32, 16),
                          ("gru_stack_sequence_kernel", 3, 32, 32),
                          ("gru_stack_decode_kernel", 3, 32, 1),
                          ("gru_stack_decode_kernel", 1, 20, 1)):
        a = make_inputs(torch, L, H, SLOTS, T, seed=7, dev=dev)
        ms = device_time_ms(torch, lambda: run_kernel(
            K, ref, name, a, "v3", False, plain=False), per_graph=200)
        lib = cudnn_gru_ms(torch, dev, T=T, H=H, L=L)
        blk = ""
        if name == "gru_stack_sequence_kernel":
            t_blk = device_time_ms(torch, stack_route_fn(
                torch, a, "v3", False, stack_block_route(K, SLOTS, H, L)),
                per_graph=50)
            blk = f"; its block route {t_blk * 1e3:.2f} us"
        print(f"  torch.nn.GRU (cuDNN) yardstick for {name}, v3 L={L} H={H} "
              f"B={SLOTS} T={T}: {lib * 1e3:.2f} us; the kernel on the same "
              f"work {ms * 1e3:.2f} us{blk}", flush=True)
    print("  library_ms: null -- no single PyTorch call computes the v1 "
          "(paper) GRU recurrence or step these kernels run, in fp32 or on "
          "int8 weight rows; nor the exponential-gated sLSTM (torch.nn.LSTM "
          "has neither its exponential gates nor its stabilizer)",
          flush=True)
    return rows


# the attention kernels' timing rows: (B, Sq/Sk or C, ...) at the served
# shapes (S = 12 and 128, 4 requests) and at S = 2048, bf16 (the served
# compute dtype); the JSON row is the S = 128 wave's
ATTN_TIMED = (("flash_attention", (4, 12, 12, True, 0)),
              ("flash_attention", (4, 128, 128, True, 0)),
              ("flash_attention", (1, 2048, 2048, True, 0)),
              ("flash_decode", (4, 76, (0, 12), 12, 0)),
              ("flash_decode", (4, 192, (0, 128), 128, 0)),
              ("flash_decode", (1, 2112, (0, 2048), 2048, 0)))
ATTN_ROW = {"flash_attention": (4, 128, 128, True, 0),
            "flash_decode": (4, 192, (0, 128), 128, 0)}


def decode_ops_per_call(torch, fn, B):
    """What one warm call of the flash-decode wrapper ``fn`` puts on the
    card, read from a ``torch.profiler`` trace of that call: the count of
    its CUDA kernels (``flash_decode_k`` and any other), memsets and copies,
    and the grid of each ``flash_decode_k`` launch (blocks = x * y). Checks
    that ``flash_decode_k`` ran exactly once and, at B = 1, on more blocks
    than (b, kv-head) pairs. Counts are None where the profiler recorded
    no device activity."""
    import os
    import tempfile
    fn()
    torch.cuda.synchronize()

    def body():
        fn()
        torch.cuda.synchronize()
    prof = profiled(torch, body)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    dev_ev = [e for e in events if e.get("ph") == "X" and e.get("cat") in
              ("kernel", "gpu_memset", "gpu_memcpy")]
    if not dev_ev:
        return {"counts": None, "text": "device ops per call not measured "
                "(the profiler recorded no device activity)"}
    kernels = [e for e in dev_ev if e["cat"] == "kernel"]
    ours = [e for e in kernels if "flash_decode_k" in e["name"]]
    grids = [e.get("args", {}).get("grid") for e in ours]
    blocks = [g[0] * g[1] * g[2] if g else None for g in grids]
    counts = {"cuda_kernels": len(kernels),
              "flash_decode_k": len(ours),
              "other_kernels": sorted(e["name"][:60] for e in kernels
                                      if e not in ours),
              "memsets": sum(e["cat"] == "gpu_memset" for e in dev_ev),
              "copies": sum(e["cat"] == "gpu_memcpy" for e in dev_ev),
              "grids": grids, "blocks": blocks}
    check(len(ours) == 1, f"flash_decode: {len(ours)} flash_decode_k "
          f"launches in one wrapper call")
    if B == 1 and blocks[0] is not None:
        check(blocks[0] > HKV, f"flash_decode at B=1 ran {blocks[0]} "
              f"blocks, no more than its {HKV} (b, kv-head) pairs")
    text = (f"device ops per call (profiler): {len(kernels)} CUDA "
            f"kernel(s) ({len(ours)} flash_decode_k, grid {grids[0]}, "
            f"{blocks[0]} blocks"
            + (f"; others {counts['other_kernels']}"
               if counts["other_kernels"] else "")
            + f"), {counts['memsets']} memset(s), {counts['copies']} "
            f"copies")
    return {"counts": counts, "text": text}


def attn_bound_ms(name, shape, itemsize, valid=None, heads=(HQ, HKV, HD)):
    """Least time: q, k, v read once and the output written once over
    3.35 TB/s, or 4*D flops per valid (query, key) pair and head over the
    peak of the inputs' type (bf16 989, fp32 67 TFLOP/s), the larger.
    Flash decode counts only the valid slots' K and V (what this cache's
    data needs), its byte mask and its fp32 output."""
    from repro_torch.kernels.flash_attn import ref as fref
    hq, hkv, hd = heads
    peak = BF16_FLOP_PER_S if itemsize == 2 else FP32_FLOP_PER_S
    if name == "flash_attention":
        B, Sq, Sk, causal, window = shape
        pairs = int(fref._mask(Sq, 0, Sk, causal, window, "cpu").sum())
        flops = 4 * hd * pairs * B * hq
        nbytes = itemsize * (2 * B * hq * Sq * hd + 2 * B * hkv * Sk * hd)
    else:
        B, C = shape[:2]
        flops = 4 * hd * valid * B * hq
        nbytes = (itemsize * (B * hq * hd + 2 * B * hkv * valid * hd) + C
                  + 4 * B * hq * hd)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_zoo_heads(torch, dev):
    """Rows 21-22 in bf16 at the LM zoo's heads (``ZOO_TIMED``): the
    served S = 128 wave (``ATTN_ROW``'s shapes) at each transformer's
    heads, hymba's served S = 1280 prefill with its window and without,
    each beside its decode: device time, plain version, sdpa and bound, by
    config."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attn import kernel as DK
    from repro_torch.kernels.decode_attn import ref as dref
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.flash_attn import ref as fref
    out = {}
    for label, heads, fshape, dshape in ZOO_TIMED:
        hq, hkv, hd = heads
        fshape = fshape or ATTN_ROW["flash_attention"]
        dshape = dshape or ATTN_ROW["flash_decode"]
        row = {}
        B, Sq, Sk, causal, window = fshape
        q, k, v = attn_inputs(torch, B, Sq, Sk, torch.bfloat16, 11, dev,
                              heads)
        if window:
            # sdpa takes a window only as a mask (its flash path refuses
            # one): the boolean (Sq, Sk) mask of the kernel's rule
            wmask = fref._mask(Sq, 0, Sk, causal, window, dev)

            def library():
                return F.scaled_dot_product_attention(
                    q, k, v, attn_mask=wmask, enable_gqa=True)
        else:
            def library():
                return F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=True)
        fns = {"flash_attention": (
            lambda: FK.flash_attention(q, k, v, causal=causal, window=window),
            lambda: fref.flash_attention_plain(q, k, v, causal, window),
            library, None, fshape)}
        Bd, C, written, pos, dwin = dshape
        qd, kc, vc, mask = decode_inputs(torch, Bd, C, written, pos, dwin,
                                         torch.bfloat16, 11, dev, heads)
        qh = qd.reshape(Bd, hq, 1, hd)
        amask = mask[None, None, None, :]
        fns["flash_decode"] = (
            lambda: DK.flash_decode(qd, kc, vc, mask),
            lambda: dref.flash_decode_plain(qd, kc, vc, mask),
            lambda: F.scaled_dot_product_attention(qh, kc, vc,
                                                   attn_mask=amask,
                                                   enable_gqa=True),
            int(mask.sum()), dshape)
        for name, (kern, plain_fn, lib_fn, valid, shape) in fns.items():
            ms = device_time_ms(torch, kern, per_graph=50)
            plain = device_time_ms(torch, plain_fn, per_graph=2)
            lib = device_time_ms(torch, lib_fn, per_graph=50)
            bms, by = attn_bound_ms(name, shape, 2, valid, heads)
            row[name] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                         "bound_ms": bms, "bound_by": by,
                         "shape": [list(x) if isinstance(x, tuple) else x
                                   for x in shape]}
            print(f"  {name:15s} bf16 {label} heads {heads} {shape}: device "
                  f"{ms * 1e3:9.2f} us  plain {plain * 1e3:10.2f} us  sdpa "
                  f"{lib * 1e3:8.2f} us  bound {bms * 1e3:8.3f} us ({by})",
                  flush=True)
        out[label] = {"heads": list(heads), **row}
    return out


def time_attention(torch, dev, err, launches):
    """Kernel, plain-version, library and bound times of the two attention
    kernels at every ``ATTN_TIMED`` shape, bf16 then fp32; returns the two
    JSON rows (bf16, the S = 128 wave, with the fp32 times beside)."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attn import kernel as DK
    from repro_torch.kernels.decode_attn import ref as dref
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.flash_attn import ref as fref
    rows, fp32_at_row, ops_at = [], {}, {}
    for name, shape in ATTN_TIMED:
        for dtype in (torch.bfloat16, torch.float32):
            dn = "bf16" if dtype == torch.bfloat16 else "fp32"
            extra = ""
            if name == "flash_attention":
                B, Sq, Sk, causal, window = shape
                q, k, v = attn_inputs(torch, B, Sq, Sk, dtype, 11, dev)
                valid = None

                def kern():
                    return FK.flash_attention(q, k, v, causal=causal,
                                              window=window)

                def plain_fn():
                    return fref.flash_attention_plain(q, k, v, causal,
                                                      window)

                def library():
                    return F.scaled_dot_product_attention(
                        q, k, v, is_causal=causal, enable_gqa=True)
                label = f"B={B} Sq={Sq:4d} Sk={Sk:4d}"
            else:
                B, C, written, pos, window = shape
                q, kc, vc, mask = decode_inputs(torch, B, C, written, pos,
                                                window, dtype, 11, dev)
                valid = int(mask.sum())
                qh = q.reshape(B, HQ, 1, HD)
                amask = mask[None, None, None, :]

                def kern():
                    return DK.flash_decode(q, kc, vc, mask)

                def plain_fn():
                    return dref.flash_decode_plain(q, kc, vc, mask)

                def library():
                    return F.scaled_dot_product_attention(
                        qh, kc, vc, attn_mask=amask, enable_gqa=True)
                label = f"B={B} C={C:4d} valid={valid:4d}"
                sp = DK.num_splits(B, HKV, C, DK.sm_count(dev))
                ops = decode_ops_per_call(torch, kern, B)
                extra = f"  splits {sp}; {ops['text']}"
                if dtype == torch.bfloat16:
                    ops_at[f"B={B} C={C}"] = ops["counts"]
            lib_out, want = library(), plain_fn()
            lib_err = (lib_out.float().reshape(want.shape)
                       - want.float()).abs().max().item()
            ms = device_time_ms(torch, kern, per_graph=50)
            plain = device_time_ms(torch, plain_fn, per_graph=2)
            lib = device_time_ms(torch, library, per_graph=50)
            call = call_time_ms(torch, kern, iters=200)
            bms, by = attn_bound_ms(name, shape, dtype.itemsize, valid)
            print(f"  {name:15s} {dn} {label}: device {ms * 1e3:9.2f} us "
                  f"(per call {call * 1e3:8.2f})  plain {plain * 1e3:10.2f} "
                  f"us  sdpa {lib * 1e3:8.2f} us (|sdpa - plain| "
                  f"{lib_err:.3g})  bound {bms * 1e3:8.3f} us ({by})"
                  + extra, flush=True)
            if shape != ATTN_ROW[name]:
                continue
            if dtype == torch.float32:
                fp32_at_row[name] = {"ms_fp32": ms, "plain_ms_fp32": plain,
                                     "library_ms_fp32": lib,
                                     "bound_ms_fp32": bms}
                continue
            row = {
                "name": name, "route": "cuda",
                "source": KERNEL_SOURCE[name], "replaces": REPLACES[name],
                "launches": launches[name],
                "max_abs_err": err[name]["float32"],
                "max_abs_err_bf16": err[name]["bfloat16"],
                "ms": ms, "plain_ms": plain, "bound_ms": bms,
                "bound_by": by, "library_ms": lib, "call_ms": call,
                "shape": {"heads": [HQ, HKV, HD], "shape": list(shape),
                          "dtype": "bfloat16"}}
            rows.append(row)
    zoo = time_zoo_heads(torch, dev)
    for row in rows:
        row.update(fp32_at_row[row["name"]])
        row["zoo_heads"] = {a: {"heads": z["heads"], **z[row["name"]]}
                            for a, z in zoo.items()}
        if row["name"] == "flash_decode":
            # measured by the profiler at every timed shape (bf16)
            row["device_ops_per_call"] = ops_at
    print("  library_ms: torch.nn.functional.scaled_dot_product_attention "
          "(enable_gqa; is_causal for prefill, the validity mask for "
          "decode) on the same inputs, timed only", flush=True)
    return rows


# the row-wise primitives' timing rows: (kernel, (B, H or K, N or None,
# variant or None, dtype)); the JSON rows are marked
ROWWISE_TIMED = (
    ("gru_step_fused", (8, 20, None, "v1", "float32")),
    ("gru_step_fused", (8, 32, None, "v1", "float32")),     # JSON row
    ("gru_step_fused", (8, 32, None, "v3", "float32")),
    ("gru_step_fused", (8, 32, None, "v1", "bfloat16")),
    ("gru_step_fused", (1, 1000, None, "v1", "float32")),
    ("gru_step_fused", (8, 1000, None, "v1", "float32")),
    ("gru_step_fused", (8, 1024, None, "v3", "float32")),
    ("gru_step_blocked", (1, 1024, None, "v1", "float32")),
    ("gru_step_blocked", (8, 1024, None, "v1", "float32")),  # JSON row
    ("gru_step_blocked", (8, 2048, None, "v1", "float32")),
    ("gru_step_blocked", (8, 2048, None, "v1", "bfloat16")),
    ("rowwise_matmul", (8, 32, 96, None, "float32")),
    ("rowwise_matmul", (4, 1024, 3072, None, "bfloat16")),   # JSON row
    ("rowwise_matmul", (4, 1024, 3072, None, "float32")),
    ("rowwise_matmul", (4, 3072, 1024, None, "bfloat16")),
    ("rowwise_matmul", (4, 3072, 1024, None, "float32")),
    ("cascade_matmul", (8, 32, 96, None, "float32")),
    ("cascade_matmul", (4, 1024, 3072, None, "float32")),    # JSON row
    ("cascade_matmul", (4, 1024, 3072, None, "bfloat16")),
    ("cascade_matmul", (4, 3072, 1024, None, "float32")),
    ("cascade_matmul", (4, 3072, 1024, None, "bfloat16")))
ROWWISE_ROW = {"gru_step_fused": (8, 32, None, "v1", "float32"),
               "gru_step_blocked": (8, 1024, None, "v1", "float32"),
               "rowwise_matmul": (4, 1024, 3072, None, "bfloat16"),
               "cascade_matmul": (4, 1024, 3072, None, "float32")}


def rowwise_bound_ms(name, shape):
    """Least time: every input read once and the output written once over
    3.35 TB/s, or the products over the peak of the weights' type (bf16's
    989 TFLOP/s on the tensor cores, fp32's 67) plus the step's 14
    elementwise flops per unit at 67 TFLOP/s, whichever is larger."""
    B, n, N, _, dtype = shape
    item = 2 if dtype == "bfloat16" else 4
    peak = BF16_FLOP_PER_S if item == 2 else FP32_FLOP_PER_S
    if name in ("gru_step_fused", "gru_step_blocked"):
        H = n                  # u (H,3H); h, x_proj, b and out float32
        nbytes = item * 3 * H * H + 4 * (B * H + 3 * B * H + 3 * H + B * H)
        t_ops = (2 * B * 3 * H * H / peak + 14 * B * H / FP32_FLOP_PER_S)
    else:
        K_ = n                 # x (B,K), w (K,N); rowwise out in x's dtype
        out_item = item if name == "rowwise_matmul" else 4
        nbytes = item * (B * K_ + K_ * N) + out_item * B * N
        t_ops = 2 * B * K_ * N / peak
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops *= 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_rowwise(torch, dev, err, launches):
    """Kernel, plain-version, library and bound times of the four row-wise
    primitives, each kernel called through its wrapper with the blocks its
    entry point picks (the two steps also with their old column tile
    forced, and by phase 11's shapes: ``step_gaps``); returns the four
    JSON rows."""
    from repro_torch.kernels.gru_cell import kernel as CK
    from repro_torch.kernels.gru_cell import ref as cref
    from repro_torch.kernels.rowwise_matvec import kernel as MK
    from repro_torch.kernels.rowwise_matvec import ops as mops
    from repro_torch.kernels.rowwise_matvec import ref as mref
    rows = []
    for name, shape in ROWWISE_TIMED:
        B, n, N, v, dtype = shape
        library = None
        if name.startswith("gru_step"):
            h, xp, u, b = step_inputs(torch, B, n, dtype, 13, dev)
            if name == "gru_step_fused":
                def kern():
                    return CK.gru_step_fused(h, xp, u, b, variant=v)
            else:
                def kern():
                    return CK.gru_step_blocked(h, xp, u, b, block_n=256)

            def plain_fn():
                return cref.gru_step_ref(h, xp, u, b, v)
            label = f"B={B} H={n:4d} {v} u {dtype}"
        else:
            x, w = mm_inputs(torch, B, n, N, dtype, 13, dev)
            bb, bn, bk = mops.auto_blocks(B, n, N, x.element_size())
            if name == "rowwise_matmul":
                def kern():
                    return MK.rowwise_matmul(x, w, block_b=bb, block_n=bn)

                def plain_fn():
                    return mref.rowwise_matmul_ref(x, w)
            else:
                def kern():
                    return MK.cascade_matmul(x, w, block_b=bb, block_n=bn,
                                             block_k=bk)

                def plain_fn():
                    return mref.cascade_matmul_ref(x, w, bk)
            # one torch.matmul computes the same function; for the bf16
            # cascade (fp32 output) torch.mm with out_dtype=float32
            # (aten::mm.dtype), where the card's torch has it
            if name == "rowwise_matmul" or dtype == "float32":
                def library():
                    return torch.matmul(x, w)
            else:
                def library():
                    return torch.mm(x, w, out_dtype=torch.float32)
                try:
                    library()
                except (TypeError, RuntimeError) as e:
                    print(f"  torch.mm(..., out_dtype=torch.float32) "
                          f"refused: {type(e).__name__}: {e}", flush=True)
                    library = None
            label = f"B={B} K={n:4d} N={N:4d} {dtype}"
        ms = device_time_ms(torch, kern, per_graph=50)
        plain = device_time_ms(torch, plain_fn, per_graph=10)
        lib = (device_time_ms(torch, library, per_graph=50)
               if library is not None else None)
        call = call_time_ms(torch, kern, iters=200)
        bms, by = rowwise_bound_ms(name, shape)
        lib_s = f"{lib * 1e3:8.2f} us" if lib is not None else "    n/a"
        plan = ""
        old_ms = None
        if name.endswith("matmul"):
            p = getattr(MK, name).last_plan
            plan = (f"  [{p.route} ct={p.ct} kc={p.kc} stages={p.stages} "
                    f"warps={p.warps} grid={p.grid}]")
        else:
            p = getattr(CK, name).last_plan
            old_ms = device_time_ms(torch, step_route_fn(
                torch, (h, xp, u, b), v, step_old_route(B, n, v, u.dtype,
                                                        name),
                name == "gru_step_blocked"), per_graph=50)
            plan = (f"  [{step_plan_str(p)}; old column tile "
                    f"{old_ms * 1e3:.2f} us]")
        print(f"  {name:16s} {label}: device {ms * 1e3:9.2f} us (per call "
              f"{call * 1e3:8.2f})  plain {plain * 1e3:9.2f} us  matmul "
              f"{lib_s}  bound {bms * 1e3:8.4f} us ({by}){plan}", flush=True)
        if shape == ROWWISE_ROW[name]:
            rows.append({
                "name": name, "route": "cuda",
                "source": KERNEL_SOURCE[name], "replaces": REPLACES[name],
                "launches": launches[name],
                "max_abs_err": err[name]["float32"],
                "max_abs_err_bf16": err[name]["bfloat16"],
                "ms": ms, "plain_ms": plain, "bound_ms": bms,
                "bound_by": by, "library_ms": lib, "call_ms": call,
                "shape": {"B": B, ("H" if N is None else "K"): n, "N": N,
                          "variant": v, "dtype": dtype}})
            if old_ms is not None:
                rows[-1]["plan"] = str(p)
                rows[-1]["old_route_ms"] = old_ms
    step_gaps(torch, dev, launches)
    print("  library_ms: torch.matmul on the same inputs (TF32 off) where it "
          "computes the same function (rowwise; fp32 cascade), torch.mm with "
          "out_dtype=float32 for the bf16 cascade; null for the GRU steps -- "
          "torch.nn.GRUCell computes neither v1 nor JAX's v3 from a given "
          "x_proj", flush=True)
    return rows


def step_plan_str(p):
    """A step plan's route and knobs, short."""
    if p.route == "warp":
        return f"warp warps={p.warps}"
    if p.route == "wide":
        return (f"wide cw={p.ct} kc={p.kc} stages={p.stages} rows={p.rows} "
                f"grid={p.grid}")
    return f"tile ct={p.ct} rows={p.rows} grid={p.grid}"


def step_gaps(torch, dev, launches):
    """Rows 10 and 11's launches in phase 11 by shape (``STEP_SHAPES``, one
    call each): device time under the plan and with the old column tile
    forced, the bound, and launches x (device - bound) summed by kernel
    both ways."""
    from repro_torch.kernels.gru_cell import kernel as CK
    from repro_torch.kernels.gru_cell import ops as cops
    for name in ("gru_step_fused", "gru_step_blocked"):
        shapes = [c for c in STEP_SHAPES if c[4] == name]
        check(len(shapes) == launches[name], f"{name}: phase 11's shapes "
              f"{len(shapes)} do not match its {launches[name]} launches")
        gap = gap_old = 0.0
        for B, H, v, dt, _ in shapes:
            a = step_inputs(torch, B, H, dt, 17, dev)
            ms = device_time_ms(torch, lambda: cops.gru_step_cuda(*a, v),
                                per_graph=50)
            p = getattr(CK, name).last_plan
            old = device_time_ms(torch, step_route_fn(
                torch, a, v, step_old_route(B, H, v, a[2].dtype, name),
                name == "gru_step_blocked"), per_graph=50)
            bms, _ = rowwise_bound_ms(name, (B, H, None, v, dt))
            gap += (ms - bms) * 1e3
            gap_old += (old - bms) * 1e3
            print(f"  {name} served B={B} H={H:4d} {v} u {dt:8s}: 1 launch, "
                  f"device {ms * 1e3:7.2f} us ({step_plan_str(p)}), old "
                  f"column tile {old * 1e3:7.2f} us, bound "
                  f"{bms * 1e3:.4f} us", flush=True)
        print(f"  {name}: launches x (device - bound) over its {len(shapes)} "
              f"phase-11 launches = {gap:.0f} us (old column tile forced: "
              f"{gap_old:.0f} us)", flush=True)


# elementwise operations per output unit of each shard kernel (a sigmoid
# or tanh counted as one): the bodies' adds, products, nonlinearities and
# the convex update
SHARD_ELEMENTWISE = {"gru_rowwise_shard_step": 14, "gru_rowwise_shard_zr": 7,
                     "gru_rowwise_shard_candidate": 7, "gru_shard_matvec": 0,
                     "gru_cascade_shard_gates": 11,
                     "gru_cascade_shard_zr": 5,
                     "gru_cascade_shard_update": 7}
# (H, ranks) timed; the JSON rows are gru-jet-deep's at 2 ranks, 8 slots
SHARD_TIMED = ((32, 2), (32, 4), (32, 1), (20, 2), (20, 4))
SHARD_ROW = (32, 2)


def shard_bound_ms(name, args, outs):
    """Least time: every operand read once and every output written once
    over 3.35 TB/s, or the products (2 B K N for each matvec) plus the
    elementwise operations over fp32's 67 TFLOP/s, the larger. A strided
    gate slice counts only its own elements."""
    nbytes = 4 * (sum(a.numel() for a in args) + sum(o.numel() for o in
                                                     outs))
    B, Hl = outs[0].shape[0], outs[0].shape[-1]
    ops = SHARD_ELEMENTWISE[name] * B * Hl
    if name.startswith("gru_rowwise"):
        x, u = args[0], args[3]
        ops += 2 * B * x.shape[1] * u.shape[1]
    elif name in ("gru_shard_matvec", "gru_cascade_shard_zr"):
        w = args[-1]
        ops += 2 * B * w.shape[0] * w.shape[1]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def czr_tile_fn(torch, args):
    """A call of ``gru_cascade_shard_zr``'s column-tile C entry on ``args``
    at ``kernel.shard_tiles``'s tile (its launch before the direct route),
    into fresh outputs; reads the current stream at each call."""
    from repro_torch.kernels import _launch
    from repro_torch.kernels.gru_sequence import kernel as K
    zr, xp, h, u = args
    B, Hl, N = h.shape[0], h.shape[1], u.shape[1]
    z = torch.empty(B, Hl, device=h.device)
    p = torch.empty(B, N, device=h.device)
    fn = K._shard_launcher("gru_cascade_shard_zr_launch", K._CZR_ARGS)
    head = (zr.data_ptr(), xp.data_ptr(), h.data_ptr(), u.data_ptr(),
            u.stride(0), z.data_ptr(), p.data_ptr(), B, Hl, N,
            *K.shard_tiles(B, Hl, 1, N), K._vector(u, u.stride(0), N))

    def call():
        _launch.raise_on(fn(*head, _launch.stream(h.device)),
                         "gru_cascade_shard_zr old tile")
        return z, p
    return call


def shard_route(name) -> str:
    """The route of a shard kernel's last launch: the five redesigned
    kernels' plan (``last_plan``); the two epilogues run one thread an
    output, reading their operands in place."""
    from repro_torch.kernels.gru_sequence import kernel as K
    if name in REDESIGNED:
        p = getattr(K, name).last_plan
        return (f"direct S={p.slices} R={p.rows} warps={p.warps} grid="
                f"{p.grid}" if p.route == "direct" else
                f"tile bt={p.rows} ct={p.ct} grid={p.grid}")
    return "one thread an output, in place"


def time_shard_kernels(torch, dev, err, launches):
    """Device, per-call, plain-version and bound times of the seven shard
    kernels at the mesh path's shard shapes (8 slots; the matvec at v1's
    N = 2H); ``torch.matmul`` beside the matvec (TF32 off), the one
    kernel a single PyTorch call computes; row 16 as the mesh step calls
    it (gate views and b, one launch) beside the epilogue it replaced (+ b,
    two slice copies, the kernel) and the kernel on contiguous slices; row
    18 likewise (its in-place call beside ``_ht_in``'s two adds and the
    contiguous call, and that call alone). Returns the seven JSON rows."""
    from repro_torch.kernels.gru_sequence import kernel as K
    rows = []
    for (H, n) in SHARD_TIMED:
        a = shard_inputs(torch, H, n, SLOTS, 77, dev)
        for name in SHARD:
            args = shard_args(name, a, 2 * H)

            def kern():
                return run_shard_kernel(name, args, plain=False)

            def plain_fn():
                return run_shard_kernel(name, args, plain=True)
            library = None
            if name == "gru_shard_matvec":
                def library():
                    return torch.matmul(*args)
            ms = device_time_ms(torch, kern, per_graph=200)
            plain = device_time_ms(torch, plain_fn, per_graph=50)
            lib = (device_time_ms(torch, library, per_graph=200)
                   if library is not None else None)
            call = call_time_ms(torch, kern, iters=300)
            bms, by = shard_bound_ms(name, args, kern())
            plan = shard_route(name)
            lib_s = f"{lib * 1e3:7.2f} us" if lib is not None else "    n/a"
            old = ""
            if name == "gru_cascade_shard_zr":    # its launch before the
                tile = device_time_ms(torch, czr_tile_fn(torch, args),
                                      per_graph=200)   # direct route
                old = f"  old tile {tile * 1e3:6.2f} us"
            if name == "gru_cascade_shard_gates":   # the epilogue before
                epi = device_time_ms(torch, old_gates_fn(a), per_graph=200)
                local = [t.reshape(SLOTS, -1).contiguous() for t in args[:2]]
                contig = device_time_ms(
                    torch, lambda: K.gru_cascade_shard_gates(
                        *local, a["h_shard"]), per_graph=200)
                old = (f"  old epilogue (+ b, 2 cats, kernel) {epi * 1e3:6.2f}"
                       f" us; kernel on contiguous slices, no b "
                       f"{contig * 1e3:6.2f} us")
            if name == "gru_cascade_shard_update":  # the epilogue before
                epi = device_time_ms(torch, old_update_fn(a, a["idx"]),
                                     per_graph=200)
                ht_in = args[1].contiguous()
                contig = device_time_ms(
                    torch, lambda: K.gru_cascade_shard_update(
                        a["z"], ht_in, a["h_shard"]), per_graph=200)
                old = (f"  old epilogue (2 adds, kernel) {epi * 1e3:6.2f} us;"
                       f" kernel on a contiguous pre-activation, no adds "
                       f"{contig * 1e3:6.2f} us")
            print(f"  {name:28s} H={H} ranks={n} Hl={H // n:2d} B={SLOTS}: "
                  f"device {ms * 1e3:6.2f} us (per call {call * 1e3:6.2f})  "
                  f"plain {plain * 1e3:7.2f} us  matmul {lib_s}  bound "
                  f"{bms * 1e6:6.2f} ns ({by})  route {plan}{old}",
                  flush=True)
            if (H, n) == SHARD_ROW:
                rows.append({
                    "name": name, "route": "cuda",
                    "source": KERNEL_SOURCE[name],
                    "replaces": REPLACES[name],
                    "launches": launches[name], "max_abs_err": err[name],
                    "ms": ms, "plain_ms": plain, "bound_ms": bms,
                    "bound_by": by, "library_ms": lib, "call_ms": call,
                    "plan": plan,
                    "shape": {"H": H, "ranks": n, "Hl": H // n, "B": SLOTS}})
                if name == "gru_cascade_shard_zr":
                    rows[-1]["old_tile_ms"] = tile
                if name in ("gru_cascade_shard_gates",
                            "gru_cascade_shard_update"):
                    rows[-1]["old_epilogue_ms"] = epi
                    rows[-1]["contiguous_ms"] = contig
    print("  library_ms: torch.matmul on the matvec's operands (TF32 off); "
          "null for the other six -- no single PyTorch call computes a "
          "shard step's gate math", flush=True)
    return rows


def profiled(torch, body):
    """``torch.profiler`` over ``body`` (which ends synchronized), its
    events kept whole: a first cycle runs ``body`` with the profiler
    started and throws its events away (CUPTI can lose the first device
    activities after it starts), then ``body`` runs again, recorded."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            body()
            prof.step()
    return prof


def device_kernels(prof) -> dict:
    """Device time (us) by name of what ran on the card (kernels, copies),
    from a profile: only the device entries, since a host op's entry
    carries the device time of the kernels it launched too."""
    from torch.autograd import DeviceType
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if us > 0 and getattr(e, "device_type", None) == DeviceType.CUDA:
            out[e.key] = us
    return out


def profile_lm_decode(torch, dev, params):
    """Device busy share of a served qwen3-0.6b decode step: two profiled
    waves of 4 requests (12-token prompts) through ``attn_impl="cuda"``,
    one with 1 new token and one with 41, so their difference is 40
    decode steps (the prefill cancels); busy = the kernels' summed device
    time, over the host wall time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import get_config
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = get_config(LM_ARCH)
    eng = ServeEngine(cfg, params, max_batch=LM_SLOTS, device=dev)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, size=12).astype(np.int32)
               for _ in range(LM_SLOTS)]

    def wave(new):
        return [Request(prompt=p, max_new_tokens=new) for p in prompts]
    eng.generate(wave(4))                        # warm
    torch.cuda.synchronize()
    runs = {}
    for new in (1, 41):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            eng.generate(wave(new))
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        kernels = device_kernels(prof)
        runs[new] = (wall, sum(kernels.values()) / 1e6, kernels)
    if not runs[41][2]:
        print("  profiler: no device time recorded -> busy share not "
              "measured", flush=True)
        return None
    steps = 40
    wall = (runs[41][0] - runs[1][0]) / steps
    busy = (runs[41][1] - runs[1][1]) / steps
    print(f"  decode step ({LM_ARCH}, cuda, {LM_SLOTS} requests, 40 steps "
          f"by difference): wall {wall * 1e3:.4f} ms/step, device busy "
          f"{busy * 1e3:.4f} ms/step = {busy / wall:.3%} (idle "
          f"{1 - busy / wall:.3%})", flush=True)
    k41, k1 = runs[41][2], runs[1][2]
    diff = {k: (us - k1.get(k, 0.0)) / steps for k, us in k41.items()}
    for k, us in sorted(diff.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {us:9.2f} us/step  {k[:90]}")
    decode_us = sum(us for k, us in diff.items() if "flash_decode_k" in k)
    print(f"    flash_decode_k: {decode_us:.2f} us/step", flush=True)
    return {"wall_ms_per_step": wall * 1e3,
            "device_busy_ms_per_step": busy * 1e3,
            "device_idle_share": 1 - busy / wall,
            "flash_decode_us_per_step": decode_us}


def profile_decode(torch, dev, backend, arch="gru-jet-deep", cfg=None):
    """Device busy share of the served decode step: ``torch.profiler`` over
    20 warm steps of a full 8-slot ``arch`` wave (``cfg`` if given, ``arch``
    its name) through ``backend``; busy = the kernels' summed device time
    over the steps' wall time; also the ``aten::stack`` and ``aten::cat``
    ops a step (a stack runs a cat inside it)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import get_config
    from repro_torch.core.params import init_params
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import api
    from repro_torch.serve.engine import ServeEngine
    cfg = cfg or get_config(arch)
    cfg = cfg.replace(gru=dataclasses.replace(cfg.gru, backend=backend))
    params = init_params(api.get_api(cfg).specs(cfg), seed=0, device=dev)
    eng = ServeEngine(cfg, params, max_batch=SLOTS, device=dev)
    eng.gru_wave_begin(make_requests(cfg, SLOTS, 10, False, 64, seed=1))
    for _ in range(10):
        eng.gru_wave_step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(20):
            eng.gru_wave_step()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    kernels = device_kernels(prof)
    busy = sum(kernels.values()) / 1e6
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    if not kernels:
        print("  profiler: no device time recorded -> busy share not "
              "measured", flush=True)
        return None
    every_key = sum(getattr(e, "self_device_time_total", 0.0)
                    for e in prof.key_averages()) / 1e6
    print(f"  (summing every profiler key, the host ops' device time "
          f"beside their kernels' as PRs 11-15 did: {every_key / 20 * 1e3:.4f}"
          f" ms/step)", flush=True)
    print(f"  decode step ({arch}, {backend}, {SLOTS} slots, 20 "
          f"steps): wall {wall / 20 * 1e3:.4f} ms/step, device busy "
          f"{busy / 20 * 1e3:.4f} ms/step = {busy / wall:.3%} (idle "
          f"{1 - busy / wall:.3%})", flush=True)
    for k, us in top:
        print(f"    {us / 20:9.2f} us/step  {k[:90]}")
    ops = {e.key: e.count for e in prof.key_averages()
           if e.key in ("aten::stack", "aten::cat")}
    return {"wall_ms_per_step": wall / 20 * 1e3,
            "device_busy_ms_per_step": busy / 20 * 1e3,
            "device_idle_share": 1 - busy / wall,
            "stack_ops_per_step": ops.get("aten::stack", 0) / 20,
            "cat_ops_per_step": ops.get("aten::cat", 0) / 20}


def main() -> None:
    if sys.argv[1:2] == ["--mesh-rank"]:
        rank, n, backend, store, out = sys.argv[2:7]
        mesh_rank_main(int(rank), int(n), backend, store, out)
        return
    if sys.argv[1:2] == ["--moe-rank"]:
        rank, n, store, out = sys.argv[2:6]
        moe_rank_main(int(rank), int(n), store, out)
        return
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    phase("1. device")
    kind, count, smi_line = device_info(torch)
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port is not here ({e}); run from the repository root")
    dev = torch.device("cuda", 0)
    phase("2. build")
    build_kernels()
    phase("3. kernels vs plain versions")
    err = check_kernels(torch, dev)
    phase("3b. shard kernels vs plain versions (gru-jet, gru-jet-deep over "
          "1, 2, 4 ranks)")
    shard_err = check_shard_kernels(torch, dev)
    phase("4. main path: serve gru-jet and gru-jet-deep through cuda_fused")
    launches, report, cfgs, params, streams = run_main_path(torch, dev)
    phase("5. int8 path: serve gru-jet and gru-jet-deep through "
          "cuda_fused_q8")
    q8_launches, q8_report = run_q8_path(torch, dev, cfgs, params, streams)
    launches.update(q8_launches)
    ccfgs, cparams = chain_configs(torch, dev, cfgs, params)
    phase("6. per-layer chain: serve both configs and a heterogeneous stack "
          "through cuda_chain")
    chain_launches, chain_report = run_chain_path(torch, dev, ccfgs, cparams)
    phase("7. int8 per-layer chain: the same through cuda_chain_q8")
    cq8_launches, cq8_report = run_chain_q8_path(torch, dev, ccfgs, cparams)
    for k, n in list(chain_launches.items()) + list(cq8_launches.items()):
        launches[k] = launches.get(k, 0) + n
    phase("8. sLSTM: serve slstm-jet and an L=3 H=32 stack through "
          "cuda_fused")
    slstm_launches, slstm_report = run_slstm_path(torch, dev)
    launches.update(slstm_launches)
    phase("8b. the tuning loop: a measured table, a forced flip and a "
          "recalibrating slstm-jet engine")
    tune_launches, tune_report = run_tuning_path(torch, dev)
    for k, n in tune_launches.items():
        launches[k] = launches.get(k, 0) + n
    for k, e in tune_report.pop("served_shape_err").items():
        err[k] = max(err[k], e)
    phase("8c. the serving fleet: gru-jet-deep on replicas with faults, "
          "gru-jet through the asyncio front end, slstm-jet, the CLI")
    fleet_launches, fleet_report_ = run_fleet_path(torch, dev)
    for k, n in fleet_launches.items():
        launches[k] = launches.get(k, 0) + n
    for k, e in fleet_report_.pop("served_shape_err").items():
        err[k] = max(err[k], e)
    phase("8d. training on the card: gru-jet through the train CLI with a "
          "resume, gru-jet-deep, slstm-jet, qwen3-0.6b at full width, the "
          "q8 harness")
    train_launches, train_report = run_training_path(torch, dev)
    for k, n in train_launches.items():
        launches[k] = launches.get(k, 0) + n
    phase("9. attention kernels vs plain versions (qwen3-0.6b heads)")
    attn_err, zoo_err = check_attention_kernels(torch, dev)
    phase("10. dense LM: serve qwen3-0.6b at full width through the "
          "attention kernels")
    lm_launches, lm_report, lm_params = run_lm_path(torch, dev)
    launches.update(lm_launches)
    phase("10b. MoE: serve qwen2-moe-a2.7b at full width and depth, then "
          "qwen3-moe-235b-a22b at full width and depth 2, through the "
          "attention kernels")
    moe_launches, moe_report, moe_tree = run_moe_path(torch, dev, keep=True)
    wide_launches, wide_report = run_moe_wide(torch, dev)
    for k in ATTN:
        launches[k] += moe_launches[k] + wide_launches[k]
    phase("11c. MoE under a named mesh (run here, from 10b's tree): "
          "qwen2-moe-a2.7b at full width on 4 ranks (gloo, one card): "
          "expert-parallel, the TP modes on 2x2, capacity 16 against one "
          "process, the GPipe pipeline")
    moe_mesh_launches, moe_mesh_report = run_moe_mesh_path(torch, dev,
                                                           moe_tree)
    del moe_tree
    torch.cuda.empty_cache()
    for k in ATTN:
        launches[k] += moe_mesh_launches[k]
    phase("10c. recurrent LMs: serve hymba-1.5b at full width and depth "
          "through the windowed attention kernels, then xlstm-125m at full "
          "width")
    hymba_launches, hymba_report = run_hymba_path(torch, dev)
    xlstm_report = run_xlstm_path(torch, dev)
    for k in ATTN:
        launches[k] += hymba_launches[k]
    phase("10d. encoder-decoder and vision-language: whisper-large-v3 and "
          "llava-next-mistral-7b at full width and depth through the model "
          "API, cross-attention through the attention kernels")
    whisper_launches, whisper_report = run_whisper_path(torch, dev)
    llava_launches, llava_report = run_llava_path(torch, dev)
    for k in ATTN:
        launches[k] += whisper_launches[k] + llava_launches[k]
    phase("11. the paper's row-wise primitives through gru_step_cuda, "
          "rowwise and cascade")
    rw_launches, rw_err = run_rowwise_path(torch, dev)
    launches.update(rw_launches)
    phase("11b. mesh path: gru-jet-deep v1 and v3 through cuda_sharded on "
          "2 and 4 ranks (gloo) and 1 rank (NCCL), one card")
    mesh_launches, mesh_report = run_mesh_path(torch)
    # row 3's decode launches under backend="cuda", kept apart from phase 4's
    mesh_decode = {"gru_stack_decode_kernel":
                   mesh_launches.pop("gru_stack_decode_kernel")}
    launches.update(mesh_launches)
    phase("12. timing (CUDA events: device via graph replay, and per call)")
    rows = time_kernels(torch, dev, err, launches, mesh_decode)
    rows += time_attention(torch, dev, attn_err, launches)
    rows += time_rowwise(torch, dev, rw_err, launches)
    rows += time_shard_kernels(torch, dev, shard_err, launches)
    for rep, backend in ((report, "cuda"), (q8_report, "cuda_fused_q8"),
                         (chain_report, "cuda_chain"),
                         (cq8_report, "cuda_chain_q8")):
        rep["profile_gru_jet_deep_decode"] = profile_decode(torch, dev,
                                                            backend)
    slstm_report["profile_slstm_jet_decode"] = profile_decode(
        torch, dev, "cuda_fused", "slstm-jet")
    slstm_report["step_both_ways"] = slstm_steps_both_ways(torch, dev)
    lm_report["profile_decode"] = profile_lm_decode(torch, dev, lm_params)
    mesh_report["profiles"] = profile_mesh_steps(torch, dev, mesh_report)
    both = steps_both_ways(torch, dev)
    cq8_report["step_both_ways"] = both["cuda_chain_q8"]
    mesh_report["v3_step_both_ways"] = both["cuda_sharded v3"]
    mesh_report["v1_step_both_ways"] = both["cuda_sharded v1"]
    both = decode_steps_both_ways(torch, dev)
    report["step_both_ways"] = both["cuda"]
    q8_report["step_both_ways"] = both["cuda_fused_q8"]
    check("jax" not in sys.modules and "repro" not in sys.modules,
          "the JAX package was imported")
    print(json.dumps({"serve": report, "serve_q8": q8_report,
                      "serve_chain": chain_report,
                      "serve_chain_q8": cq8_report,
                      "serve_slstm": slstm_report,
                      "serve_tuning": tune_report,
                      "serve_fleet": fleet_report_,
                      "train": train_report, "serve_lm": lm_report,
                      "serve_moe": moe_report, "serve_moe_wide": wide_report,
                      "serve_hymba": hymba_report,
                      "serve_xlstm": xlstm_report,
                      "serve_whisper": whisper_report,
                      "serve_llava": llava_report,
                      "attention_zoo_err": zoo_err,
                      "rowwise_launches": rw_launches,
                      "serve_mesh": mesh_report,
                      "serve_moe_mesh": moe_mesh_report}))
    print(json.dumps({"kernels": rows}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
