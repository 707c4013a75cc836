#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

  python3 chip_smoke.py [--parent-source PATH [PATH ...]]

Phases; any failure exits non-zero:

1. build — compile every CUDA source of the port (one ``nvcc`` each, all
   started together) and print the seconds it took; then, for each
   ``flash_attention`` kernel, ``ptxas``'s registers and spills and the
   dynamic shared memory its launch grants, and the count of ``HGMMA``
   instructions in each kernel's SASS (``cuobjdump -sass`` of the built
   library); ``ptxas``'s registers, spills and shared memory of every
   ``neighbor_agg``, ``gather_aggregate``, ``cache_gather`` and
   ``reservoir_topm`` kernel, and the atomics in the SASS of the
   ``neighbor_agg`` backward's and the ``reservoir_topm`` kernels.  Fails
   if the bf16 kernel at Dh=128 has no ``HGMMA``, if a bf16 or reservoir
   kernel spills, or if the backward or a reservoir kernel adds a float
   atomically; the same for the ``flash_attention`` backward's kernels
   (``csrc/flash_attention_bwd.cu``: registers, spills, shared memory,
   SASS atomics, and each bf16 instance's HGMMA count and highest
   register; fails on a spill or a float atomic, or if the bf16 Dh=128
   ``dq`` or ``dkv`` kernel has no HGMMA); a machine with no
   ``cuobjdump`` gets a line saying so;
2. cache_gather — call the wrapper at the shapes the serving path gives
   it (its 4,096- and 128-row chunks among them), hold the result bit-exact
   against its plain PyTorch version, then time kernel, plain version and
   the library yardstick with CUDA events (median of 50 launches, L2
   flushed before each) beside the bytes bound, and the same harness's
   floor (a one-float ``zero_``);
3. the serving slice at full width — ``repro_torch.launch.serve`` for
   graphsage-products with the device feature plane: 4 warm-up train
   steps, 64 node queries at batch 4, a streamed feature update and a
   re-query.  Launch counts are zeroed just before and read just after,
   and the outputs are checked (finite logits, every query done, the
   forward agreeing with the same forward on the CPU on a small batch);
4. the fused training slice at full width — ``repro_torch.launch.train
   --arch graphsage-products --sampling-device device --fused-gather-agg
   --steps 8`` through ``run_gnn``, launch counts zeroed just before and
   read just after; then one fused step each for gcn, gat and gin on the
   same graph (the sum, weighted-forward and weighted-backward paths).
   The first step's loss and gradients on the card are held against the
   same step on the CPU, from the same parameters and batch, and two card
   steps from that state are compared bit for bit (reported, not failed);
5. gather_aggregate and neighbor_agg (forward and backward) at the shapes
   of that first batch, plus GAT's weighted shapes, odd widths and the
   fused read's miss path (the batch's ``enc`` re-encoded so that half its
   distinct rows come from the sideband): held against their plain
   versions (``h_dst`` and the backward's ``dh`` bit-equal, the backward
   against the plain version on the CPU, two launches bit-equal), the
   forwards' means and sums bit-equal to the reference order written out,
   and every output bit-equal to the parent commit's kernels (built from
   ``git show HEAD~1``, or from ``--parent-source``: a directory holding
   its ``segment_agg.cu``, ``fused_gather_agg.cu``, ``reservoir.cu``,
   ``flash_attention.cu`` and ``flash_attention_bwd.cu`` (and any
   ``*.cuh`` they include), or its checkout root, or the files);
   each hop's segment lengths printed; each timed as in phase 2, with
   ``F.embedding_bag`` as the yardstick of ``neighbor_agg``, in turns
   with the parent's kernel (parent, kernel, kernel, parent), and each
   profiled over ``PROFILE_CALLS`` calls for its own device time;
6. flash_attention at the LM slices' shapes (the qwen3-4b, llama3.2-3b,
   zamba2-7b, qwen2-moe-a2.7b and qwen2-vl-2b prefills, the whisper-medium
   encoder (non-causal over 1500 frames) and decoder prefill, bf16; the
   edges of its 128-row tiles, S = 127, 129 and 4097;
   Dh=64 at S=1000; the widths run on a wider template, Dh 112 and Dh 8,
   bf16 and f32, causal and not, GQA; odd lengths, f32 and non-causal):
   held against its plain version (bf16 by an output-scaled bound that
   must also refuse two faulty outputs, a skipped KV tile and a 3%
   normaliser error), and the qwen3-4b, llama3.2-3b, zamba2-7b (Dh 112)
   and qwen2-vl-2b (a GQA group of 6) prefills and the whisper-medium
   encoder timed as in phase 2 with ``F.scaled_dot_product_attention``
   as the yardstick (the port never calls it), each with its TFLOP/s and
   share of the bound (Dh 112 also against the 128-wide template's work);
7. the LM serving slice at full width — qwen3-4b with seeded weights on the
   card: ``Model.prefill`` of ``tokens (2, 4096)`` (36 flash_attention
   launches, counted; its allocator peak held to its memory trace on
   ``meta`` within ``footprint.peak_tolerance`` and below the arguments
   plus two sets of K and V caches), then ``run_lm_serve``'s engine on 8
   requests at batch 8 (prompts <= 8 tokens, 32 new), greedy (no
   flash_attention launch: decode is plain torch),
   each with the counts zeroed just before and read just after; the device
   time of a prefill and a decode step by kernel; then at f32 on a
   64-token prompt, the prefill through the kernel against the prefill
   through the plain version, and the engine's first token against the
   prefill's argmax;
8. reservoir_topm at the sampler's shapes — every padded-width bucket of
   hops 2 and 3 of phase 4's first batch, formed as
   ``NeighborSampler._sample_one_hop`` forms them (γ-bias weights, seeded
   float32 uniforms, ``mask = col < size``), one launch each, the counts
   zeroed before each hop and read after it; held
   bit-exact (idx, and keys bit for bit) against its plain version and
   against the parent commit's kernel with the hub row and odd shapes;
   inclusion frequencies of 2^20 rows against the exact probabilities (5
   standard errors); each bucket timed as in phase 2, in turns with the
   parent's kernel (parent, kernel, kernel, parent), with ``torch.topk``
   over precomputed keys as the yardstick of the selection alone and the
   bytes bound over valid lanes (w and u read where the mask is set; the
   padded-lane figure printed beside it); the hub row's time on a line of
   its own, its device time and that of the bucket of most rows profiled;
   each hop's sums (kernel, parent, ``torch.topk``, bound) beside the host
   numpy time of its ``_sample_one_hop``.  Phases 3, 4, 7 and 9 launch it
   0 times: no path of the port, as none of the JAX package, selects on
   the card;
9. the multi-partition slice at full width — ``repro_torch.launch.train
   --arch graphsage-products --partitions 2 --halo-budget 4096
   --sampling-device device --fused-gather-agg --steps 8`` through
   ``run_gnn`` (a locality plan with a bounded halo, 8 gradient-synchronised
   global steps of two partitions on the card under ``fit_supervised``
   with a checkpoint every 4, then a fresh trainer that restores the
   committed checkpoint), launch counts zeroed just before and read just
   after (``gather_aggregate`` partitions × global steps, ``neighbor_agg``
   and its backward that × 2 hops, nothing else).  It prints the plan, the
   host seconds of planning, global steps/s, each partition's stage split,
   the checkpoint write and restore seconds, the modeled memory, accuracy
   and the hit rates, and fails unless: the restored trainer's params and
   ``opt_state`` are ``torch.equal`` to the writer's and to the committed
   npz, with ``global_steps`` and the cache and halo statistics back, and
   one further global step runs; the first global step's all-reduced
   gradient on the card is within rel 1e-4 of the CPU's from the same
   parameters and batches; every halo row in each partition's device plane
   is bit-equal to the owner's row; ``fit_supervised`` with a failure
   injected at step 3 of 4 ends at step 4 with one failure and one
   restore; and a 4-step unfused run launches one ``cache_gather`` per
   chunk of each partition's plane fetch and no other kernel.  It also
   prints the device time by kernel of 2 warm global steps
   (``torch.profiler``) against the median of 3 un-profiled ones.
   Checkpoints go to temporary directories that the phase removes;
10. the online auto-tuner at full width — (a) ``repro_torch.launch.train
   --arch graphsage-products --sampling-device device --fused-gather-agg
   --autotune --episodes-autotune 4 --steps 10`` through ``run_gnn``, launch
   counts zeroed just before and read just after (2 warm-up and 4 × 10
   fused steps: ``gather_aggregate`` 42, ``neighbor_agg`` and its backward
   84 each, nothing else); per episode the configuration, the measured
   throughput, memory and accuracy, the hit rate, the surrogate's predicted
   point and the host seconds of PROPOSE, RECONFIGURE and MEASURE (the
   controller's ``propose``, ``_apply_config`` and ``measure``, wrapped by
   this script); the PPO agent's parameters on the card, and one PPO update
   on the card within 1e-5 of the same update on the CPU; (b) one
   controller (``tune_sampling_device``, ``max_partitions=2``,
   ``max_halo_budget=4096``) on a fresh full-width trainer: the plane
   flipped device → cpu → device over one cache, one fused step from one
   state and batch on each plane, losses and updated parameters bit-equal
   (``gather_aggregate``'s table path against its all-sideband path); a
   restart to 2 partitions with a 4096-row halo (params and ``opt_state``
   ``torch.equal`` across it; the checkpoint write, planning and restore
   seconds) and a 4-global-step episode; the halo budget swapped live to
   0 on the same trainer; a restart back to 1 partition, again
   ``torch.equal``, and one step;
11. the serving fabric at full width — (a) ``repro_torch.launch.serve
   --gnn --arch graphsage-products --sampling-device device --partitions 2
   --replicas 2 --train-steps 4 --queries 64 --batch 4 --slo-p99-ms 600``
   through ``run_gnn_serve``: 4 warm-up global steps, each replica stepped
   once, 64 queries, a trainer step with ``refresh_weights`` and a
   re-query, a 512-query burst; the launch counts zeroed just before and
   read just after, and each part's ``cache_gather`` launches (the
   launcher's per-part counts) equal to the gather chunks its planes
   issued, no other kernel launched.  It prints the plan and its planning
   seconds, q/s, p50 and p99, the per-partition and per-replica counts,
   the burst's shed fraction and deferrals and the host time of a fabric
   step split into its engines' sample, fetch, pad and forward (the
   fabric's ``step`` and the engine's stages wrapped by this script), and
   fails unless the load is served whole with finite logits, each query by
   a replica of its owner, the audit balances, every replica held the
   warm tree until the hand-off and the re-query's logits are bit-equal to
   a fresh engine's forward with the trainer's new tree on the same batch,
   and the burst both sheds and serves; (b) chaos: two fabrics of SimHost
   replicas on a ``VirtualClock`` (``from_plan`` on the plan re-budgeted to
   a 4,096-row halo, 2 ms a response, timeout 8 ms, replica 0/0 killed
   after its 3rd response, 48 queries 4 a step) and a twin on the CPU from
   the same parameters: the audit balanced, 0/0 down with timeouts and
   retries, the two card runs' traces identical and logits bit-equal, the
   CPU's (rid, partition, replica, status) trace identical with equal
   predictions and logits within 1e-4, one launch per gather chunk, and
   every halo row resident in each card plane, bit-equal to the owner's;
12. the MoE, hybrid and SSM LM families at full width, each with seeded
   weights: qwen2-moe-a2.7b drawn on the card in bf16 (f32 masters and a
   copy would not fit), zamba2-7b and mamba2-1.3b through the CLI path
   (``run_lm_serve`` drawing its own f32 masters).  For each: a bf16
   block prefill of ``tokens (2, 4096)`` (24 / 13 / 0 flash_attention
   launches and nothing else, counted; a warm-up, in which every
   flash_attention call is held against the plain version on its own
   inputs by the bf16 bound, and the counted run compared bit for bit,
   which must hold for the MoE; one profiled); 4 requests served at
   batch 4 (prompts <= 8, 8 new tokens, no kernel launched, every token
   in range) and the decode step's time (median of 30) and profile; for
   zamba2 and mamba2 at f32 on a 64-token prompt, at full depth every
   flash_attention call against the plain version on its own inputs, the
   chaos of the seeded stack (the logits' move under 1e-6 relative noise
   on the embedding table, at full depth and at the cut), then (zamba2 cut
   to 12 layers: its seeded 81-layer stack is chaotic) the prefill through
   the kernel against the plain attention and the engine's first token
   against the prefill's argmax (the MoE engine is
   held against the JAX engine's streams in the CPU tests instead: a block
   prefill drops tokens past an expert's capacity, decode drops none);
   each decode step's device busy time and idle share;
13. the encoder-decoder and VLM families at full width, whisper-medium and
   qwen2-vl-2b through the CLI path (``run_lm_serve``: f32 masters, a bf16
   copy), as phase 12: 4 requests served at batch 4 (no kernel launched)
   and the decode step; a bf16 block prefill, whisper's of
   ``audio_embeds (2, 1500, 1024)`` N(0, 1) and ``tokens (2, 448)`` (48
   flash_attention launches: 24 non-causal in the encoder, 24 causal in the
   decoder), qwen2-vl's of ``tokens (2, 4096)`` with ``vision_embeds (2,
   1024, 1536)`` and Qwen2-VL's grid positions (28), each call of the
   warm-up held against the plain version, the counted run compared bit
   for bit and profiled; at f32 on a 64-token prompt, as phase 12 (every
   call in situ at full depth, the chaos probe, the whole prefill at the
   depth ``F32_CHECK_LAYERS`` allows: both seeded stacks are chaotic, so
   qwen2-vl's runs 3 layers and whisper's 1 + 1, its noise on the audio
   embeddings), qwen2-vl's engine's first token against the prefill's
   argmax, whisper's engine's greedy streams on the card against the same
   engine's on the CPU (the engine never encodes);
14. LM training at full width and full depth — (a) the forward's ``O``
   and log-sum-exp bit-equal to the parent commit's kernel at the
   llama3.2-3b and qwen3-4b prefills (bf16 causal); the
   ``flash_attention`` backward kernel alone: at every head width, causal
   and full, GQA and ragged lengths, f32 and bf16, the forward's ``O``
   and log-sum-exp held first against ``flash_attention_ref`` (``O`` by
   the f32 tolerance or the bf16 bound, the log-sum-exp within 1e-5 of
   its row's scale), then the backward against ``flash_attention_bwd_ref``
   fed the reference's own ``O`` and log-sum-exp (f32 within 1e-5 of the
   largest gradient entry; bf16 within 2^-6 of it over the whole tensors
   and no worse than twice the plain version's own bf16 error against an
   f64 autograd witness), run twice bit-equal, the forward's ``O``
   bit-equal with and without its log-sum-exp; timed (as phase 2) at
   llama3.2-3b's prefill (2, 4096, 24, 8, 128) and at the train step's
   (8, 128, 24, 8, 128), bf16 causal, in turns with the parent commit's
   kernel (parent, kernel, kernel, parent), beside the plain version,
   SDPA's backward (forward + backward less the forward) and the bound
   (2.5 x the forward's FLOP), each with its TFLOP/s and share of the
   bound; (b) ``repro_torch.launch.train --arch
   llama3.2-3b --steps 6 --batch 8 --seq 128 --workers 2 --layers 4``
   through ``run_lm``, full width cut to 4 of 28 layers (each checkpoint
   and the read-back move 12 bytes a parameter through the disk: 9.6 GB
   at 4 layers, 38.5 GB at 28) (seeded f32 masters on the card, AdamW
   updated in place,
   remat "dots", checkpoints at steps 2, 4 and 6, keep 2, asynchronous),
   its ``--ckpt-dir`` on the filesystem (``build/`` or TMPDIR) with the
   most room, the free bytes and the host memory for two snapshots
   printed first (fails without room for one checkpoint; with room for
   fewer than three, steps 2 and 4 are removed once verified, so keep 2
   prunes nothing); launches zeroed just before and read just after (8
   ``flash_attention`` and 4 backward a step, nothing else), finite
   losses and gradient norms, steps/s and tokens/s over steps 2-6, each
   step's seconds, peak memory, the checkpoint snapshot, write and wait
   seconds (``CheckpointManager`` wrapped by this script), the committed
   steps, and step 6 read back and compared leaf by leaf with the run's
   final state; (c) the first step's 4 calls held in situ as in (a);
   (d) the full 28-layer step on seeded f32 masters and AdamW state built
   on the card as ``run_lm`` builds them: one step with a
   ``grad_transform`` that fails on a non-finite gradient, 3 timed (their
   median is the step time of the idle share and of phase 15's FLOP
   rate), one profiled (its own peak read in a window of its own, held in
   phase 15 (a); device busy, idle share, the backward kernels' device
   time in the step); (e) a
   full-width llama3.2-3b cut to 2 layers in f32: loss and every gradient
   through the kernels against the same through the plain attention on
   the card, within 1e-4 with the attention weights at their whole
   fan-in; as seeded (largest score printed) against the same step on
   the CPU, no further from it than twice the plain card path is;
15. the dry-run's accounting and the distributed shims — (a) llama3.2-3b's
   seeded f32 masters and AdamW state built on the card as phase 14
   builds them: the growth of ``torch.cuda.memory_allocated()`` equal to
   ``launch/dryrun.py``'s ``argument_bytes`` for the host mesh at phase
   14's 8 x 128 train shape, less the batch, within 512 B a tensor (the
   allocator's rounding); the dry-run's FLOPs of that step over phase
   14's median step, as TFLOP/s and a share of 989 TFLOP/s; the peak of
   a 2- and a 4-layer step at that shape, each in a window of its own
   (``footprint.step_peak``), and of phase 14 (d)'s 28-layer step, each
   held to the dry-run's memory trace of the same step on ``meta``
   (``dryrun.trace_unsharded``) within ``footprint.peak_tolerance`` (3%
   or 64 MiB), the line through the 2- and 4-layer traces printed beside
   the direct 28-layer trace (the dry-run traces at full depth); (b) the
   shims on the card, each held to the CPU: int8 quantization, top-k
   sparsification, both error-feedback schemes and ``compressed_psum_int8``
   over 8 host-simulated members bit-equal, ``flash_decode_attention``
   over 8 members at qwen3-4b's decode shape (batch 8, a 4,096-token
   cache, 32 heads of 128) within 1e-5 of the full masked softmax
   attention in f32; ``make_pipeline_fn`` over llama3.2-3b's 28 seeded
   bf16 layers in 4 stages of 7, 8 microbatches of 1 x 128 tokens:
   bit-equal to the same layers run in sequence on each microbatch, its
   gap to the sequence on the whole batch printed, 28 x 8
   ``flash_attention`` launches counted; (c) the dry-run of every LM arch
   x applicable shape x ``single`` and ``multi`` (params, argument GiB a
   device, FLOPs a device, host seconds; fails on any cell that errors),
   run in a child process started before phase 14 and read here; then
   the phase's seconds;
16. the partition mesh as a ``torch.distributed`` group — (a) phase 9's
   arguments as 2 ``gloo`` ranks sharing the card, spawned by
   ``launch/group.spawn_partitions`` with the launcher's rank code
   (``launch.train.gnn_rank``: ``run_gnn_multipartition`` in each rank,
   one partition a process): each partition's losses, the final params
   and ``opt_state``, the restored trainer's, the accuracy, the hit
   rates, each partition's halo rows through its plane, the committed
   checkpoint and its manifest held bit-equal to phase 9's run (read
   right after it), the launches summed over the ranks equal to phase
   9's, each rank's median of 3 warm global steps printed beside phase
   9's; (b) every group collective (``grad_allreduce``,
   ``compressed_psum_int8``, the cross-pod transform,
   ``flash_decode_attention`` at qwen3-4b's decode shape,
   ``all_gather_objects``) over a one-rank ``nccl`` group on the card and
   (c) over 2 ``gloo`` ranks (both in a thread, beside (a)), bit-equal to their host-simulated forms
   on the card; a line saying that the two-rank ``nccl`` run needs a
   second card (``scripts/group_nccl.py`` runs it where there are two);
   no rank may import JAX or the JAX package.  The script drives one
   card: with more it stops at once (``CUDA_VISIBLE_DEVICES=0`` runs it);
17. the fleet's live reconfiguration as a process group — 2 ``gloo``
   ranks sharing the card, spawned by ``launch/group.spawn_partitions``
   with the launcher's rank code (``launch.train.autotune_rank``) at
   phase 9's full width (``--partitions 2 --halo-budget 4096
   --halo-refresh-interval 2``, the static cache), against the same
   sequence host-simulated in this process on the card (in a thread,
   while the ranks run): (a)
   one 2-partition trainer, 2 global steps after each of the halo budget
   swapped 4096 -> 0 -> 4096, 50,000 seeded edges added on every rank and
   ``rebalance_partitions``, a streamed ``update_rows`` of 64 halo rows of
   each partition (the periodic refresh fires in the second step); (b) a
   scripted auto-tuner run on it (partitions 2 -> 1 -> 2 through the
   restart, the halo budget, γ and Θ moved, ``w_throughput=0``; the best
   episode, the one-partition one, is applied at the end); (c) an
   unscripted run of 3 episodes of 4 steps on what (b) left.  Each
   partition's losses, params, ``opt_state``, hit rates, manifests,
   episodes (but their clock's throughput) and halo rows through the
   planes are held bit-equal to the reference through (b); for (c) the
   ranks must agree (rank 0's episodes broadcast); the launches summed
   over the ranks equal the reference's and the steps run (one
   ``gather_aggregate``, two ``neighbor_agg`` and two backward a
   partition's step; ``flash_attention`` and ``reservoir_topm`` 0); each
   operation's host seconds per rank (the periodic refresh's and each
   restart's apart), each episode's fleet throughput beside the
   reference's with each rank's own MEASURE wall; no rank may import JAX
   or the JAX package;
18. the GPipe pipeline over a stage group — llama3.2-3b at full width,
   ``PIPE_GROUP``'s 8 seeded bf16 layers in 2 stages of 4 (cut from 28
   to make room for phase 19's zamba2 and whisper runs within the time
   limit), 8 microbatches of 1 x 128
   tokens, forward and the hand-written backward of ``(out.float() **
   2).mean()``: first host-simulated in this process on the card (the
   reference: a warm-up run, then a timed one; its values kept on the
   host as per-leaf SHA-256 digests), then as 2 ``gloo`` ranks sharing
   the card (``launch.group.pipeline_rank``: rank s builds the stack,
   keeps stage s, and runs the same two runs).  The outputs, every
   stage's parameter gradients and the gradient of the microbatches
   must match the reference's digests (a mismatch prints the first
   differing leaf and its max |diff|); ``flash_attention`` and its
   backward launched 64 times each, summed over the ranks, as in the
   reference, and no other kernel; each rank's forward + backward wall
   beside the reference's, the bytes each boundary between ticks sends
   and the phase's seconds; no rank may import JAX or the JAX package.
   ``scripts/group_nccl.py`` step 6 runs it over 2 ``nccl`` cards.
19. the sharded LM step — (a) the dry-run's collective bytes
   (``launch.dryrun.collectives``: the port's step traced on ``meta``
   DTensors over a fake group, both depth probes, in one child process)
   of llama3.2-3b and qwen2-moe-a2.7b ``train_4k`` on the (16, 16) and
   (2, 16, 16) production meshes, per op, with each trace's host seconds;
   (b) ``launch.group.sharded_lm_rank`` as 2 ``gloo`` ranks sharing the
   card on a (1, 2) ``(data, model)`` mesh (``gloo-host``: DTensor's
   collectives of card tensors run gloo's on a host copy of the buffer,
   ``launch.group.stage_collectives_through_host``; gloo faults on card
   tensors in the card's PyTorch) for each of ``SHARDED_RUNS``:
   llama3.2-3b at full width (``SHARDED_LM``: 4 bf16 layers of tame
   seeded weights, each N(0, 1 / its whole fan-in; a batch of 2 x 1024
   tokens; 12 q and 4 kv heads a rank, the vocab and the MLP split in
   two), zamba2-7b (``SHARDED_ZAMBA``: 6 Mamba2 layers and one
   application of the shared attention block, 16 of 32 heads of Dh 112
   a rank, the SSD scan per head shard) and whisper-medium
   (``SHARDED_WHISPER``: 2 encoder and 2 decoder layers over 2 x 1,500
   frames and 2 x 448 tokens, 8 of 16 heads a rank), the step sharded as
   DTensors for 3 or 2 AdamW steps and held to the same steps unsharded
   in this process on the card: the first loss within
   ``SHARDED_LOSS_REL``, every gradient leaf within ``SHARDED_GRAD_REL``
   (||g - g_ref|| / ||g_ref||) and every parameter leaf after the steps
   within ``SHARDED_PARAM_REL`` of the unsharded step's own move (bf16:
   the partial sums over the model axis are rounded and added in another
   order; ``scripts/sharded_fault.py`` plants faults that these bounds
   catch), the bytes each rank's collectives moved in its first step,
   by op, equal to the ``meta`` trace of the same config, shape and
   mesh, the hand-written ``flash_attention`` forward and backward
   launched on each rank's head shard (the run's ``flash``: llama3.2-3b
   and whisper twice and once a layer a step, the ``dots`` recompute;
   zamba2's shared block once and once), each rank's last step's own
   peak held to the same ``meta`` trace's peak within
   ``footprint.peak_tolerance``, each rank's peak allocation over the
   run beside the unsharded step's and its wall (this run checks the step
   and times no rank: its collectives' buffers pass through the host);
   no rank may import JAX or the JAX package.
   ``scripts/group_nccl.py`` step 7 runs it over 4 ``nccl`` cards as
   (2, 2) and times each rank's step.

Every line with a time, rate or size carries the card's name and power
limit.  The next-to-last line is a JSON list of the ported kernels (the
``flash_attention`` entry with ``path_launches`` of phases 12 and 13's
prefills and the forward's ``train_launches`` of phase 14; the backward's
own entry, ``flash_attention_bwd``; the GNN training kernels'
``group_launches`` of phase 16 and ``live_launches`` of phase 17, summed
over the ranks; both flash entries' ``pipeline_group_launches`` of phase
18 and the ``sharded_launches`` of phase 19, summed over its runs and
ranks, with ``sharded_launches_a_rank`` by arch) and the last line is ``{"ok": true,
"device": {...}}``.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
ARCH = "graphsage-products"
SERVE_ARGS = ["--gnn", "--arch", ARCH, "--sampling-device", "device",
              "--train-steps", "4", "--queries", "64", "--batch", "4"]
TRAIN_ARGS = ["--arch", ARCH, "--sampling-device", "device",
              "--fused-gather-agg", "--steps", "8"]
MULTIPART_ARGS = ["--arch", ARCH, "--partitions", "2", "--halo-budget",
                  "4096", "--sampling-device", "device", "--fused-gather-agg",
                  "--steps", "8"]
FABRIC_ARGS = ["--gnn", "--arch", ARCH, "--sampling-device", "device",
               "--partitions", "2", "--replicas", "2", "--train-steps", "4",
               "--queries", "64", "--batch", "4", "--slo-p99-ms", "600"]
FABRIC_HALO = 4096               # the chaos fabrics' plan: halo rows kept
CHAOS_QUERIES = 48
AUTOTUNE_EPISODES, AUTOTUNE_STEPS = 4, 10
AUTOTUNE_ARGS = ["--arch", ARCH, "--sampling-device", "device",
                 "--fused-gather-agg", "--autotune", "--episodes-autotune",
                 str(AUTOTUNE_EPISODES), "--steps", str(AUTOTUNE_STEPS)]
TIMED_LAUNCHES = 50
PROFILE_CALLS = 20               # calls in a profiled window of a small kernel
PROFILE_TRIES = 3                # windows before an empty profile fails
SPIN_CYCLES = 1_000_000          # ~0.5 ms of device clock ahead of each call
# data-sheet HBM rates (NVIDIA), matched against the card's name in order
HBM_BYTES_PER_S = [("H200", 4.8e12), ("H100 NVL", 3.9e12),
                   ("H100 PCIe", 2.0e12), ("H100", 3.35e12)]
F32_FLOP_PER_S = 67e12        # H100 SXM f32 outside the tensor cores
BF16_FLOP_PER_S = 989e12      # H100 SXM bf16 dense tensor cores
LM_ARCH = "qwen3-4b"
# the engine prefills a prompt a token at a time through full-batch decode
# steps (as the JAX engine): the prompts' length sets the phase's seconds
LM_SERVE_ARGS = ["--arch", LM_ARCH, "--requests", "8", "--batch", "8",
                 "--max-len", "512", "--prompt-len", "8", "--max-new", "32"]
PREFILL_SHAPE = (2, 4096)
# flash_attention against its plain version: f32 to |diff| <= 2e-5; bf16 by
# ``bf16_excess`` (kernels/flash_attention/ref.py): per element rtol 1e-2
# plus 2^-8 (P |v|), the bound of rounding P to bf16, and per row 1e-2 of
# the row's norm
FLASH_F32_ATOL = 2e-5
LOGITS_REL_TOL = 1e-4      # f32 prefill, kernel vs plain attention


def fail(msg: str):
    print(f"[fail] {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def card_stamp() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def hbm_rate(name: str) -> float:
    for key, rate in HBM_BYTES_PER_S:
        if key in name:
            return rate
    fail(f"no data-sheet memory rate for {name!r}")


def time_ms(torch, fn, flush) -> float:
    """Median device time of one call, over TIMED_LAUNCHES calls after a
    warm-up, with the L2 cache flushed before each.  A spin kernel ahead of
    the start event keeps the card busy while the host enqueues the call,
    so host-side launch cost does not land between the two events."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(TIMED_LAUNCHES):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def host_us(torch, fn) -> float:
    """Host time to issue one call (enqueue only), mean of TIMED_LAUNCHES."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_LAUNCHES):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / TIMED_LAUNCHES * 1e6


def phase_build(stamp: str):
    from repro_torch.kernels.build import BUILD_DIR, build, sources
    t0 = time.perf_counter()
    built = build(sources())
    print(f"[build] {sources()} (compiled {built}) in "
          f"{time.perf_counter() - t0:.2f} s  [{stamp}]", flush=True)
    flash_report()
    flash_bwd_report()
    gnn_report("segment_agg")
    gnn_report("fused_gather_agg")
    gnn_report("gather")
    for name, info in gnn_report("reservoir").items():
        spilled = re.search(r"(\d+) bytes spill stores", info.get("spills", ""))
        if spilled and int(spilled.group(1)) > 0:
            fail(f"reservoir {name} spills registers: {info['spills']}")
    for lib, prefix, what in (("segment_agg", "bwd_", "the neighbor_agg "
                               "backward"), ("reservoir", "topm_",
                                             "reservoir_topm")):
        floats = float_atomics(BUILD_DIR / f"lib{lib}.so", prefix)
        if floats is None:
            print(f"[build] no cuobjdump on this machine (toolkit or "
                  f"triton): the float-atomic check of {what} was not made",
                  flush=True)
        elif floats:
            fail(f"{what} adds floats atomically: {floats}")


def _short_name(mangled: str) -> str:
    """``bwd_short_kernel<4,2>`` / ``cache_gather_kernel<uint4,4>`` /
    ``topm_chunk_kernel<4,u8>`` for the mangled name of a GNN or
    reservoir kernel instance."""
    m = re.search(r"\d+((?:bwd|agg|cache|gather|topm)_\w+?_kernel)", mangled)
    if not m:
        return mangled
    rest = mangled[m.end():].split("EEv")[0] + "E"
    word = re.match(r"I(t|j|5uint4)", rest)
    args = ([{"t": "u16", "j": "u32", "5uint4": "uint4"}[word.group(1)]]
            if word else [])
    args += re.findall(r"Li(\d+)E", rest) if rest.startswith("I") else []
    mask = re.search(r"E([hi])E$", rest) if m.group(1).startswith("topm") \
        else None
    args += [{"h": "u8", "i": "i32"}[mask.group(1)]] if mask else []
    return f"{m.group(1)}<{','.join(args)}>" if args else m.group(1)


def ptxas_report(lib: str, rename) -> dict:
    """ptxas's ``Used`` and spill lines of each kernel in the build log of
    ``csrc/<lib>.cu``, by ``rename(mangled name)``, and its C7512 warnings
    (wgmma serialised)."""
    from repro_torch.kernels.build import build_log
    log = build_log(lib)
    ptxas, name = {}, None
    for line in (log.read_text() if log.exists() else "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = rename(m.group(1))
            ptxas.setdefault(name, {})
        elif "C7512" in line:      # wgmma serialised: names its function
            m = re.search(r"function '(\S+)'", line)
            ptxas.setdefault(rename(m.group(1) if m else ""), {})[
                "warning"] = line.split(":", 1)[1].strip()
        elif name and "spill stores" in line:
            ptxas[name]["spills"] = line.strip()
        elif name and "Used" in line and "registers" in line:
            ptxas[name]["used"] = line.split(":", 1)[1].strip()
    if not ptxas:
        print(f"[build] no ptxas report in {log} (the library was not "
              f"rebuilt in this run)", flush=True)
    return ptxas


def gnn_report(lib: str) -> dict:
    """ptxas's registers and spills of each kernel of ``csrc/<lib>.cu``,
    printed and returned by kernel."""
    report = ptxas_report(lib, _short_name)
    for name, info in sorted(report.items()):
        print(f"[build] {lib}: {name}: ptxas {info.get('used', 'not reported')}"
              f"; {info.get('spills', 'spills not reported')}", flush=True)
    return report


def sass_lines(lib: Path):
    """(function name, line) over ``cuobjdump -sass`` of a built library;
    None when no cuobjdump is found."""
    tool = _cuobjdump()
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    out, name = [], ""
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
        else:
            out.append((name, line))
    return out


# global (REDG, ATOMG), shared (ATOMS) and generic (RED, ATOM) atomics;
# float ones carry a .F16/.BF16/.F32/.F64 type (REDG.E.ADD.F32.FTZ.RN...)
FLOAT_ATOMIC = re.compile(r"\b(?:RED|REDG|ATOM|ATOMG|ATOMS)\.[\w.]*?\.B?F(?:16|32|64)")
ANY_ATOMIC = re.compile(r"\b(?:RED|REDG|ATOM|ATOMG|ATOMS)\.")


def float_atomics(lib: Path, prefix: str, rename=None):
    """The float atomic instructions (``REDG.E.ADD.F32`` ...) in the SASS of
    the kernels of ``lib`` whose short name (``rename``, by default
    ``_short_name``, of the mangled one) starts with ``prefix``, by kernel,
    and a line with every kernel's atomic counts; None when no cuobjdump is
    found."""
    lines = sass_lines(lib)
    if lines is None:
        return None
    floats, counts = {}, {}
    for mangled, line in lines:
        name = (rename or _short_name)(mangled)
        if not name.startswith(prefix):
            continue
        n_any, n_float = counts.get(name, (0, 0))
        hit = FLOAT_ATOMIC.search(line)
        counts[name] = (n_any + bool(ANY_ATOMIC.search(line)),
                        n_float + bool(hit))
        if hit:
            floats.setdefault(name, []).append(hit.group(0))
    print(f"[build] {lib.name} SASS, kernels {prefix}*: atomics (all, "
          f"float) {counts}", flush=True)
    return floats


def _kernel_name(mangled: str) -> str:
    """``flash_fwd_wgmma<128>`` / ``flash_fwd_f32<128,pad>`` for the
    mangled name of that instance (``pad``: its columns past dh masked)."""
    m = re.search(r"(flash_fwd_\w+?)ILi(\d+)E(Lb1E)?", mangled)
    return (f"{m.group(1)}<{m.group(2)}{',pad' if m.group(3) else ''}>"
            if m else mangled)


def _cuobjdump():
    for cand in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if cand and Path(cand).exists():
            return cand
    spec = importlib.util.find_spec("triton")
    for loc in (spec.submodule_search_locations or []) if spec else []:
        cand = Path(loc) / "backends" / "nvidia" / "bin" / "cuobjdump"
        if cand.exists():
            return str(cand)
    return None


def flash_report():
    """ptxas's registers and spills, the granted shared memory and the
    HGMMA count of each flash_attention kernel; fails if the bf16 kernel
    at Dh=128 has no HGMMA or a bf16 kernel spills."""
    import ctypes

    from repro_torch.kernels.build import BUILD_DIR, load
    smem = load("flash_attention").flash_attention_smem_bytes
    smem.argtypes, smem.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    ptxas = ptxas_report("flash_attention", _kernel_name)
    lines = sass_lines(BUILD_DIR / "libflash_attention.so")
    hgmma, top_reg = {}, {}
    if lines is None:
        print("[build] no cuobjdump on this machine (toolkit or triton): "
              "the HGMMA check of flash_attention was not made", flush=True)
    for mangled, line in lines or []:
        name = _kernel_name(mangled)
        hgmma[name] = hgmma.get(name, 0) + ("HGMMA" in line)
        regs = [int(r) for r in re.findall(r"\bR(\d+)\b", line)]
        top_reg[name] = max([top_reg.get(name, -1), *regs])
    for name in sorted(n for n in set(ptxas) | set(hgmma) if "<" in n):
        width = int(re.search(r"<(\d+)", name).group(1))
        bf16 = "wgmma" in name
        info = ptxas.get(name, {})
        print(f"[build] {name} ({'bf16' if bf16 else 'f32'}): ptxas "
              f"{info.get('used', 'not reported')}; "
              f"{info.get('spills', 'spills not reported')}; dynamic shared "
              f"memory {smem(width, int(bf16))} B; SASS: HGMMA "
              f"{hgmma.get(name, 'not counted')}, highest register "
              f"R{top_reg.get(name, '?')}"
              + (f"; {info['warning']}" if "warning" in info else ""),
              flush=True)
        spilled = re.search(r"(\d+) bytes spill stores", info.get("spills", ""))
        if bf16 and spilled and int(spilled.group(1)) > 0:
            fail(f"{name} spills registers: {info['spills']}")
    if lines is not None and not hgmma.get("flash_fwd_wgmma<128>"):
        fail("the bf16 flash_attention kernel at Dh=128 has no HGMMA in its "
             "SASS")


def phase_kernels(torch, stamp: str) -> dict:
    """cache_gather against its plain version; returns the JSON entry."""
    from repro_torch.kernels.gather.ops import cache_gather
    from repro_torch.kernels.gather.ref import cache_gather_ref
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)

    def inputs(n, C, F, dtype):
        cache = torch.randn((C, F), generator=g).to(dev, dtype)
        slots = torch.randint(0, C, (n,), generator=g, dtype=torch.int32)
        slots[torch.rand(n, generator=g) < 0.25] = -1     # ~25% misses
        return slots.to(dev), cache

    # (label, n, C, F, dtype, timed): the serving step's input level, one
    # 4,096-row chunk and the 128-row tail chunk of a serving step, a whole
    # training batch, and the F=602 contract
    cases = [("serve_step", 4224, 98000, 100, torch.float32, True),
             ("chunk", 4096, 98000, 100, torch.float32, True),
             ("chunk_tail", 128, 98000, 100, torch.float32, True),
             ("train_batch", 75489, 98000, 100, torch.float32, True),
             ("f602_f32", 37, 1000, 602, torch.float32, False),
             ("f602_bf16", 37, 1000, 602, torch.bfloat16, False),
             ("f37_bf16", 37, 1000, 37, torch.bfloat16, False)]  # 2-byte words
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)  # > L2
    rate = hbm_rate(torch.cuda.get_device_name(0))
    one = torch.zeros(1, device=dev)
    print(f"[time] harness floor: a one-float zero_ takes "
          f"{time_ms(torch, one.zero_, flush)} ms here  [{stamp}]", flush=True)
    max_err, timed_at = 0.0, {}
    for label, n, C, F, dtype, timed in cases:
        slots, cache = inputs(n, C, F, dtype)
        out, miss = cache_gather(slots, cache)
        ref_out, ref_miss = cache_gather_ref(slots, cache)
        torch.cuda.synchronize()
        exact = torch.equal(out, ref_out) and torch.equal(miss, ref_miss)
        err = float((out.float() - ref_out.float()).abs().max())
        max_err = max(max_err, err)
        print(f"[kernel] cache_gather {label} n={n} C={C} F={F} {dtype}: "
              f"bit-exact={exact} max_abs_err={err}", flush=True)
        if not exact:
            fail(f"cache_gather disagrees with its plain version at {label}")
        if not timed:
            continue
        clamped = slots.clamp(min=0).long()
        hits = int((slots >= 0).sum())
        isz = cache.element_size()
        nbytes = (hits + n) * F * isz + 8 * n     # rows read + written, ids
        t = {"ms": time_ms(torch, lambda: cache_gather(slots, cache), flush),
             "plain_ms": time_ms(torch, lambda: cache_gather_ref(slots, cache),
                                 flush),
             "library_ms": time_ms(
                 torch, lambda: torch.index_select(cache, 0, clamped), flush),
             "bound_ms": nbytes / rate * 1e3}
        call_us = host_us(torch, lambda: cache_gather(slots, cache))
        _profile(torch, lambda: cache_gather(slots, cache), stamp,
                 f"cache_gather {label}", calls=PROFILE_CALLS)
        print(f"[time] cache_gather {label} n={n} F={F}: kernel "
              f"{t['ms']} ms, plain {t['plain_ms']} ms, index_select "
              f"{t['library_ms']} ms, bytes bound {t['bound_ms']} ms "
              f"({nbytes} B at {rate / 1e12} TB/s); wrapper host cost "
              f"{call_us:.1f} us/call  [{stamp}]", flush=True)
        timed_at[label] = t
    return {"name": "cache_gather", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/gather.cu",
            "replaces": "src/repro/kernels/gather/kernel.py:39",
            "max_abs_err": max_err, "bound_by": "bytes", **timed_at["chunk"],
            **{f"{k}_ms": timed_at[k]["ms"] for k in ("chunk_tail",
                                                      "train_batch")}}


def phase_slice(torch, stamp: str) -> dict:
    """The serving slice at full width; returns the launch counts."""
    import numpy as np

    from repro_torch.core.sampling import NeighborSampler
    from repro_torch.graph.batch import generate_batch, inference_arrays
    from repro_torch.launch.serve import build_parser, run_gnn_serve
    from repro_torch.models.gnn import gnn_forward
    from repro_torch.models.params import leaves

    args = build_parser().parse_args(SERVE_ARGS)
    buf = io.StringIO()
    counts = _zero_counts()
    with contextlib.redirect_stdout(buf):
        rep = run_gnn_serve(args)
    torch.cuda.synchronize()
    launches = counts()
    for line in buf.getvalue().splitlines():
        print(f"{line}  [{stamp}]", flush=True)
    if launches["reservoir_topm"] != 0:       # no serving path selects on it
        fail(f"serving launched {launches}")

    tr, eng = rep["trainer"], rep["engine"]
    if not all(p.is_cuda for p in leaves(tr.params)):
        fail("trainer parameters are not on cuda")
    warm = rep["warmup"]
    if len(warm.losses) != 4 or not all(map(math.isfinite, warm.losses)):
        fail(f"warm-up losses {warm.losses}")
    served = rep["served"]
    if len(served) != 64 or any(r.status != "done" for r in served):
        fail(f"{sum(r.status == 'done' for r in served)}/64 queries done")
    ncls = tr.cfg.num_classes
    if not all(r.logits.shape == (ncls,) and
               bool(torch.isfinite(torch.from_numpy(r.logits)).all())
               for r in served):
        fail("served logits are not finite (num_classes,) vectors")
    rq = rep["requery"]
    if rq.rid != 64 or rq.status != "done":
        fail("the streamed update's re-query did not run")
    if rep["launches_warmup"] <= 0 or rep["launches_serve"] <= 0:
        fail(f"cache_gather launches: warm-up {rep['launches_warmup']}, "
             f"serving {rep['launches_serve']}")
    s = rep["stats"]
    print(f"[slice] {ARCH} full width: losses {warm.losses}; "
          f"{len(served)} queries done at {s['queries_per_s']:.1f} q/s, "
          f"p50 {s['p50_ms']:.2f} ms p99 {s['p99_ms']:.2f} ms; "
          f"cache_gather launches warm-up {rep['launches_warmup']} "
          f"serving {rep['launches_serve']} total "
          f"{launches['cache_gather']}  [{stamp}]", flush=True)
    n = max(warm.steps, 1)
    print(f"[breakdown] warm-up train step: sample {warm.t_sample / n * 1e3:.1f} "
          f"ms, batch (plane fetch) {warm.t_batch / n * 1e3:.1f} ms, train "
          f"{warm.t_train / n * 1e3:.1f} ms  [{stamp}]", flush=True)

    # outputs against a reference: the device plane's rows equal the host
    # store, and the forward on the card agrees with the CPU forward
    g = tr.graph
    nodes = np.array([r.node for r in served[:4]], dtype=np.int64)
    mb = NeighborSampler(g, tr.cfg.fanout, seed=7).sample(nodes)
    mb = generate_batch(mb, eng.plane, g)
    if not (mb.features == g.features[mb.input_ids]).all():
        fail("device-plane rows differ from the host feature store")
    arrays = inference_arrays(mb)
    cpu_params = {"layers": [{k: v.cpu() for k, v in layer.items()}
                             for layer in tr.params["layers"]]}
    with torch.inference_mode():
        on_card = eng._fwd(tr.params, arrays["features"],
                           arrays["neigh_idxs"])
        on_cpu = gnn_forward(
            cpu_params, torch.from_numpy(arrays["features"]),
            [torch.from_numpy(i) for i in arrays["neigh_idxs"]],
            tr.cfg).numpy()
    diff = float(abs(on_card - on_cpu).max())
    print(f"[check] nodes {nodes.tolist()}: plane rows bit-exact; forward "
          f"cuda vs cpu max_abs_diff={diff}", flush=True)
    if not diff <= 1e-4:
        fail(f"forward on the card differs from the CPU by {diff}")
    serving_breakdown(torch, eng, served, stamp)
    return launches


def serving_breakdown(torch, eng, served, stamp: str):
    """Host-clock split of a serving step (4 seeds) into its stages, the
    median over 16 steps: each stage ends in a copy to the host, so the
    card's work is inside the stage that issued it."""
    import numpy as np

    from repro_torch.graph.batch import generate_batch, inference_arrays
    stages = {"sample": [], "plane_fetch": [], "pad": [], "forward": []}
    for i in range(16):
        seeds = np.array([r.node for r in served[4 * i:4 * i + 4]],
                         dtype=np.int64)
        t0 = time.perf_counter()
        mb = eng.sampler.sample(seeds)
        t1 = time.perf_counter()
        mb = generate_batch(mb, eng.plane, eng.graph)
        t2 = time.perf_counter()
        arrays = inference_arrays(mb, level_caps=eng._level_caps)
        t3 = time.perf_counter()
        eng._fwd(eng.params, arrays["features"], arrays["neigh_idxs"])
        t4 = time.perf_counter()
        for k, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            stages[k].append(dt * 1e3)
    parts = ", ".join(f"{k} {float(np.median(v)):.3f} ms"
                      for k, v in stages.items())
    print(f"[breakdown] serving step (4 seeds, median of 16): {parts}  "
          f"[{stamp}]", flush=True)


def _zero_counts():
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.fused_gather_agg.ops import gather_aggregate
    from repro_torch.kernels.gather.ops import cache_gather
    from repro_torch.kernels.reservoir.ops import reservoir_topm
    from repro_torch.kernels.segment_agg.ops import (neighbor_agg,
                                                     neighbor_agg_backward)
    fns = {"cache_gather": cache_gather, "gather_aggregate": gather_aggregate,
           "neighbor_agg": neighbor_agg,
           "neighbor_agg_backward": neighbor_agg_backward,
           "flash_attention": flash_attention,
           "reservoir_topm": reservoir_topm}
    for fn in fns.values():
        fn.launches = 0
    return lambda: {k: fn.launches for k, fn in fns.items()}


def _close(got, want) -> float:
    """Largest |got - want| / (|want| + max|want|): a relative error that
    holds entries near zero to the tensor's largest."""
    want = want.float()
    scale = want.abs() + want.abs().max()
    return float(((got.float() - want).abs() / scale.clamp(min=1e-30)).max())


def phase_train(torch, stamp: str) -> dict:
    """The fused training slice at full width; returns the launch counts of
    the main path and the first batch's inputs for the kernel phase."""
    import numpy as np

    from repro_torch.core.a3gnn import A3GNNTrainer
    from repro_torch.core.feature_plane import DeviceFeaturePlane
    from repro_torch.core.sampling import NeighborSampler, seed_loader
    from repro_torch.graph.batch import (batch_device_arrays,
                                         compute_level_caps)
    from repro_torch.launch.train import build_parser, run_gnn
    from repro_torch.models.gnn import gnn_loss_allfused
    from repro_torch.models.params import init_params, leaves

    args = build_parser().parse_args(TRAIN_ARGS)
    buf = io.StringIO()
    counts = _zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rep = run_gnn(args)
    torch.cuda.synchronize()
    launches = counts()
    wall = time.perf_counter() - t0
    for line in buf.getvalue().splitlines():
        print(f"{line}  [{stamp}]", flush=True)
    tr, res = rep["trainer"], rep["result"]
    st, steps = res.stats, res.stats.steps
    if steps != 8 or not all(map(math.isfinite, st.losses)):
        fail(f"training: {steps} steps, losses {st.losses}")
    if not all(p.is_cuda for p in leaves(tr.params)):
        fail("trainer parameters are not on cuda")
    want = {"cache_gather": 0, "gather_aggregate": steps,
            "neighbor_agg": 2 * steps, "neighbor_agg_backward": 2 * steps,
            "flash_attention": 0, "reservoir_topm": 0}
    print(f"[train] {ARCH} fused, full width: {steps} steps, losses "
          f"{st.losses}; {res.throughput_steps_s} steps/s wall clock; "
          f"launches {launches} (expected {want}); run_gnn incl. evaluate "
          f"{wall:.2f} s  [{stamp}]", flush=True)
    if launches != want:
        fail(f"training launches {launches}, expected {want}")
    n = max(steps, 1)
    print(f"[stages] fused train step, mean of {steps} (the first incl. "
          f"one-time set-up): sample {st.t_sample / n * 1e3:.3f} ms, batch "
          f"{st.t_batch / n * 1e3:.3f} ms, train {st.t_train / n * 1e3:.3f} "
          f"ms  [{stamp}]", flush=True)

    # steady state: 8 more steps on the warm trainer (outside the counted
    # run), with the trainer's own split of each fused train stage
    for part in tr.fused_parts.values():
        part.clear()
    pipe = tr.make_pipeline()
    try:
        warm = pipe.run(max_steps=8)
    finally:
        pipe.shutdown()
    n = max(warm.steps, 1)
    print(f"[stages] fused train step, steady state, mean of {warm.steps}: "
          f"sample {warm.t_sample / n * 1e3:.3f} ms, batch "
          f"{warm.t_batch / n * 1e3:.3f} ms, train "
          f"{warm.t_train / n * 1e3:.3f} ms; "
          f"{warm.throughput_steps_per_s()} steps/s  [{stamp}]", flush=True)
    if any(len(v) != warm.steps for v in tr.fused_parts.values()):
        fail(f"fused train stage split has {tr.fused_parts} for "
             f"{warm.steps} steps")
    split = ", ".join(f"{k} {float(np.median(v)) * 1e3:.3f} ms"
                      for k, v in tr.fused_parts.items())
    print(f"[breakdown] fused train stage (A3GNNTrainer.fused_parts, median "
          f"of the {warm.steps} steady steps): {split}  [{stamp}]", flush=True)
    device_breakdown(torch, tr, warm.t_wall / n, stamp)

    # the other model families, one fused step each on the same graph
    for model in ("gcn", "gat", "gin"):
        mt = A3GNNTrainer(tr.full_graph, tr.cfg.replace(model=model),
                          seed=args.seed, device="cuda")
        pipe = mt.make_pipeline()
        counts = _zero_counts()
        try:
            one = pipe.run(max_steps=1)
        finally:
            pipe.shutdown()
        torch.cuda.synchronize()
        got = counts()
        layers = mt.cfg.num_layers
        want = {"cache_gather": 0, "flash_attention": 0, "reservoir_topm": 0,
                "gather_aggregate": 0 if model == "gat" else 1,
                "neighbor_agg": layers if model == "gat" else layers - 1}
        want["neighbor_agg_backward"] = want["neighbor_agg"]
        print(f"[train] {model} fused, one step: loss {one.losses}, "
              f"launches {got}  [{stamp}]", flush=True)
        if got != want or not all(map(math.isfinite, one.losses)):
            fail(f"{model}: launches {got} (expected {want}), "
                 f"losses {one.losses}")

    # the first step on the card against the same step on the CPU: the same
    # initial parameters (re-drawn from the seed) and the same first batch
    cfg, g = tr.cfg, tr.graph
    sampler = NeighborSampler(g, cfg.fanout, weight_fn=tr.weight_fn,
                              seed=args.seed)
    seeds = next(iter(seed_loader(g, cfg.batch_size, args.seed)))
    mb = sampler.sample(seeds)
    caps = compute_level_caps(len(seeds), cfg.fanout, g.num_nodes)
    arrays = batch_device_arrays(mb, level_caps=caps)
    plane = DeviceFeaturePlane(g, tr.cache, device="cuda")
    enc, aux, table = plane.fused_inputs(mb.input_ids, arrays["pads"][0])
    batch = {"enc": enc, "aux": aux, "table": table,
             "neigh_idxs": [torch.from_numpy(i).cuda()
                            for i in arrays["neigh_idxs"]],
             "labels": torch.from_numpy(arrays["labels"]).cuda()}
    runs = []                          # (loss, grads): card, card, CPU
    for dev in ("cuda", "cuda", "cpu"):
        params = init_params(tr.decls, torch.Generator().manual_seed(
            args.seed), dev)
        flat = [p.requires_grad_(True) for p in leaves(params)]
        loss, _ = gnn_loss_allfused(
            params, enc.to(dev), aux.to(dev), table.to(dev),
            [i.to(dev) for i in batch["neigh_idxs"]],
            batch["labels"].to(dev), cfg)
        grads = torch.autograd.grad(loss, flat)
        runs.append((float(loss.detach()), [x.cpu() for x in grads]))
    (card_loss, card_grads), (_, again), (cpu_loss, cpu_grads) = runs
    names = _leaf_names(tr.params)
    differ = [n for n, a, b in zip(names, card_grads, again)
              if not torch.equal(a, b)]
    print(f"[check] two fused {ARCH} steps on the card from the same "
          f"parameters and batch: gradients bit-equal={not differ}"
          + (f" (first differing parameter {differ[0]}, {len(differ)} of "
             f"{len(names)} differ)" if differ else
             f" ({len(names)} parameters)"), flush=True)
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    step1_rel = abs(st.losses[0] - cpu_loss) / abs(cpu_loss)
    grad_rel = max(_close(a, b) for a, b in zip(card_grads, cpu_grads))
    print(f"[check] first step, {len(mb.input_ids)} input ids, level caps "
          f"{caps}: loss cuda {card_loss} vs cpu {cpu_loss} (rel "
          f"{loss_rel:.2e}; the run's first loss {st.losses[0]}, rel "
          f"{step1_rel:.2e}); gradients rel {grad_rel:.2e} (tolerance 1e-4)",
          flush=True)
    if not (loss_rel <= 1e-4 and step1_rel <= 1e-4 and grad_rel <= 1e-4):
        fail("the first step on the card differs from the CPU beyond 1e-4")
    batch["input_ids"] = len(mb.input_ids)
    batch["real_rows"] = [len(b.dst_ids) for b in mb.blocks]
    return {"launches": launches, "batch": batch, "graph": g, "mb": mb,
            "weight_fn": tr.weight_fn, "fanout": cfg.fanout}


def _leaf_names(tree, prefix: str = "") -> list:
    """Dotted names of ``models.params.leaves(tree)``, in its order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f"{prefix}{i}.")]
    return [prefix.rstrip(".")]


def device_breakdown(torch, tr, step_s: float, stamp: str):
    """Device time by kernel over 4 warm fused steps (``torch.profiler``,
    device activity only), and the busy share of an un-profiled steady
    step of ``step_s`` seconds (the profiler slows the host, so its own
    window's wall time is not the step's)."""
    from torch.profiler import ProfilerActivity, profile
    pipe = tr.make_pipeline()
    try:
        pipe.run(max_steps=1)                          # warm the path
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            pipe.run(max_steps=4)
            torch.cuda.synchronize()
    finally:
        pipe.shutdown()
    rows = device_rows(prof)
    if not rows:
        fail("the profiler recorded no device time over 4 fused steps")
    busy_ms = sum(r[1] for r in rows) / 4e3
    top = "; ".join(f"{k[:60]} {t / 4e3:.3f} ms/step ({c // 4}/step)"
                    for k, t, c in rows[:10])
    print(f"[profile] 4 fused steps: device busy {busy_ms:.3f} ms/step "
          f"(kernels and copies summed), {100 * busy_ms / (step_s * 1e3):.2f}"
          f"% of the {step_s * 1e3:.1f} ms steady step; top: {top}  "
          f"[{stamp}]", flush=True)


def device_rows(prof) -> list:
    """(name, device µs, count) of the device-side events of a profile
    (kernels, copies, memsets), largest first."""
    rows = [(e.key, getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0)),
             e.count) for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]
    return sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])


def _bag_inputs(torch, idx, h):
    """``F.embedding_bag`` form of a padded fanout: −1 → an appended zero
    row at index Ns, which ``padding_idx`` leaves out of the reduction."""
    ns = h.shape[0]
    bag = torch.where(idx < 0, torch.full_like(idx, ns), idx).long()
    return bag, torch.cat([h, torch.zeros_like(h[:1])])


PARENT_SOURCES = ("segment_agg.cu", "fused_gather_agg.cu", "reservoir.cu",
                  "flash_attention.cu", "flash_attention_bwd.cu")
PARENT_CSRC = "src/repro_torch/kernels/csrc"


def _parent_paths(source: list) -> dict:
    """The parent's kernel sources named by ``--parent-source``: a
    directory that holds them (or a checkout root, with them under
    ``src/repro_torch/kernels/csrc/``), or the files themselves; with the
    headers (``*.cuh``) beside them, which the sources may include."""
    paths = [Path(x) for x in source]
    if len(paths) == 1 and paths[0].is_dir():
        for where in (paths[0], paths[0] / PARENT_CSRC):
            found = {n: where / n for n in PARENT_SOURCES}
            if all(x.is_file() for x in found.values()):
                return {**found, **{x.name: x for x in where.glob("*.cuh")}}
        fail(f"--parent-source {paths[0]} holds no {' and '.join(PARENT_SOURCES)}")
    found = {x.name: x for x in paths}
    if sorted(n for n in found if not n.endswith(".cuh")) != sorted(
            PARENT_SOURCES) or not all(x.is_file() for x in found.values()):
        fail(f"--parent-source names a directory or the files "
             f"{' and '.join(PARENT_SOURCES)} (and any headers), not {source}")
    return found


def _git_parent(name: str):
    """``git show HEAD~1:<csrc>/<name>`` of this checkout, or None."""
    try:
        got = subprocess.run(["git", "-C", str(ROOT), "show",
                              f"HEAD~1:{PARENT_CSRC}/{name}"],
                             capture_output=True, text=True, timeout=60)
    except FileNotFoundError:
        return None
    return got.stdout if got.returncode == 0 else None


def parent_kernels(torch, source):
    """The parent commit's ``neighbor_agg`` (forward and backward),
    ``gather_aggregate``, ``reservoir_topm`` and ``flash_attention``
    (forward and backward), built from ``csrc/segment_agg.cu``,
    ``csrc/fused_gather_agg.cu``, ``csrc/reservoir.cu``,
    ``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu`` (with
    any ``csrc/*.cuh`` they include) as ``git show HEAD~1`` gives them (or
    as ``source``, the ``--parent-source`` list, names them) into
    ``build/repro_torch/parent/`` (one ``nvcc`` each, started together) and
    bound with ctypes.  Returns a namespace of ``forward(idx, h, mode, w)``,
    ``backward(idx, dout, h, mode, w) -> (dh, dw)``,
    ``gather_aggregate(enc, idx, table, aux, mode) -> (h_dst, agg)``,
    ``reservoir_topm(w, u, mask, m) -> (idx, keys)``,
    ``flash_forward(q, k, v, causal) -> (o, lse)`` and
    ``flash_backward(q, k, v, o, lse, do, causal) -> (dq, dk, dv)``, or
    None where neither the history nor ``source`` is at hand.  The
    backward's SASS float atomics are counted, which shows that phase 1's
    check finds them in a kernel that has them."""
    import ctypes
    import types

    from repro_torch.kernels.build import BUILD_DIR, NVCC_FLAGS, _nvcc
    out = BUILD_DIR / "parent"
    out.mkdir(parents=True, exist_ok=True)
    if source:
        for name, path in _parent_paths(source).items():
            shutil.copyfile(path, out / name)
    else:
        listed = subprocess.run(
            ["git", "-C", str(ROOT), "ls-tree", "--name-only", "HEAD~1",
             f"{PARENT_CSRC}/"], capture_output=True, text=True, timeout=60)
        headers = [Path(x).name for x in listed.stdout.split()
                   if x.endswith(".cuh")] if listed.returncode == 0 else []
        for name in (*PARENT_SOURCES, *headers):
            text = _git_parent(name)
            if text is None:
                print("[time] the parent's kernels are neither timed nor "
                      "compared: no git history here and no --parent-source",
                      flush=True)
                return None
            (out / name).write_text(text)
    procs = [(name, subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(out / f"lib{Path(name).stem}.so"),
         str(out / name)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)) for name in PARENT_SOURCES]
    for name, proc in procs:
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            fail(f"the parent's {name} does not build:\n{log}")
    seg = ctypes.CDLL(str(out / "libsegment_agg.so"))
    ga_fn = ctypes.CDLL(str(out / "libfused_gather_agg.so")).gather_aggregate_launch
    ga_fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 2
                      + [ctypes.c_int] + [ctypes.c_longlong] * 3
                      + [ctypes.c_int, ctypes.c_void_p])
    fwd_fn = seg.neighbor_agg_fwd_launch
    fwd_fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int]
                       + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p])
    bwd_fn = seg.neighbor_agg_bwd_launch
    # two backward interfaces: the atomic kernel's (no scratch), and since
    # the bucket design one with a scratch buffer sized by the library
    scratch_bytes = getattr(seg, "neighbor_agg_bwd_scratch_bytes", None)
    if scratch_bytes is not None:
        scratch_bytes.argtypes = [ctypes.c_longlong, ctypes.c_int,
                                  ctypes.c_longlong]
        scratch_bytes.restype = ctypes.c_longlong
    pointers = 6 if scratch_bytes is None else 7
    bwd_fn.argtypes = ([ctypes.c_void_p] * pointers
                       + [ctypes.c_longlong, ctypes.c_int]
                       + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p])
    for fn in (ga_fn, fwd_fn, bwd_fn):
        fn.restype = ctypes.c_int
    res = ctypes.CDLL(str(out / "libreservoir.so"))
    res_fn = res.reservoir_topm_launch
    # two interfaces: a launch of (R, N, m) alone, and since the chunked
    # design one given the launcher's layout, its scratch and counters
    res_bytes = getattr(res, "reservoir_topm_scratch_bytes", None)
    if res_bytes is None:
        res_fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                           + [ctypes.c_void_p] * 2
                           + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p])
    else:
        res_bytes.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 7
        res_bytes.restype = ctypes.c_longlong
        res_fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                           + [ctypes.c_void_p] * 2 + [ctypes.c_longlong]
                           + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 3)
    res_fn.restype = ctypes.c_int
    res_counters = []    # the new interface's row counters, kept zeroed
    fa_fn = ctypes.CDLL(str(out / "libflash_attention.so")).flash_attention_launch
    fa_fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                      + [ctypes.c_float, ctypes.c_void_p])
    fb_fn = ctypes.CDLL(str(out / "libflash_attention_bwd.so")) \
        .flash_attention_bwd_launch
    fb_fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                      + [ctypes.c_float, ctypes.c_void_p])
    fa_fn.restype = fb_fn.restype = ctypes.c_int
    floats = float_atomics(out / "libsegment_agg.so",
                           "agg_bwd" if scratch_bytes is None else "bwd_")
    print(f"[build] the parent's kernels ({', '.join(PARENT_SOURCES)}): float "
          f"atomics in its backward's SASS "
          f"{None if floats is None else sum(map(len, floats.values()))}",
          flush=True)

    def ptr(t):
        return None if t is None else t.data_ptr()

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def code(mode, w):
        return 2 if w is not None else {"mean": 0, "sum": 1}[mode]

    def forward(idx, h, mode, w):
        (nd, fan), (ns, d) = idx.shape, h.shape
        out_ = torch.empty((nd, d), dtype=h.dtype, device=h.device)
        err = fwd_fn(ptr(idx), ptr(h), ptr(w), ptr(out_), nd, fan, ns, d,
                     code(mode, w), stream())
        if err:
            fail(f"the parent's neighbor_agg forward: CUDA error {err}")
        return out_

    def backward(idx, dout, h, mode, w):
        (nd, fan), (ns, d) = idx.shape, h.shape
        dh = torch.empty_like(h)
        dw = None if w is None else torch.empty_like(w)
        buf = (None if scratch_bytes is None else torch.empty(
            scratch_bytes(nd, fan, ns), dtype=torch.uint8, device=h.device))
        scratch = [] if buf is None else [buf.data_ptr()]
        err = bwd_fn(ptr(idx), ptr(dout), ptr(h), ptr(w), ptr(dh), ptr(dw),
                     *scratch, nd, fan, ns, d, code(mode, w), stream())
        if err:
            fail(f"the parent's neighbor_agg backward: CUDA error {err}")
        return dh, dw

    def gather_aggregate(enc, idx, table, aux, mode):
        (nd, fan), (c, f) = idx.shape, table.shape
        h_dst = torch.empty((nd, f), dtype=table.dtype, device=table.device)
        agg = torch.empty((nd, f), dtype=table.dtype, device=table.device)
        err = ga_fn(ptr(enc), ptr(idx), ptr(table), ptr(aux), ptr(h_dst),
                    ptr(agg), enc.shape[0], nd, fan, c, aux.shape[0], f,
                    {"mean": 0, "sum": 1}[mode], stream())
        if err:
            fail(f"the parent's gather_aggregate: CUDA error {err}")
        return h_dst, agg

    def reservoir_topm(w, u, mask, m):
        from repro_torch.kernels.reservoir.ops import layout
        (R, N), dev = w.shape, w.device
        mask_bytes = mask.element_size()
        mask = mask.view(torch.uint8) if mask_bytes == 1 else mask
        idx = torch.empty((R, m), dtype=torch.int32, device=dev)
        keys = torch.empty((R, m), dtype=torch.float32, device=dev)
        args = [ptr(w), ptr(u), ptr(mask), mask_bytes, ptr(idx), ptr(keys),
                R, N, m]
        if res_bytes is not None:    # this launcher's layout for its kernel
            plan = layout(N)
            buf = torch.empty(max(res_bytes(R, N, m, *plan), 0),
                              dtype=torch.uint8, device=dev)
            if not res_counters or res_counters[0].numel() < R:
                res_counters[:] = [torch.zeros(R, dtype=torch.int32,
                                               device=dev)]
            args += [*plan, ptr(buf), ptr(res_counters[0])]
        err = res_fn(*args, stream())
        if err:
            fail(f"the parent's reservoir_topm: CUDA error {err}")
        return idx, keys

    def flash_forward(q, k, v, causal):
        from repro_torch.kernels.flash_attention.ops import TEMPLATE_WIDTH
        B, S, H, Dh = q.shape
        o = torch.empty_like(q)
        lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        err = fa_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    lse.data_ptr(), B, S, H, k.shape[2], Dh,
                    TEMPLATE_WIDTH[Dh], int(q.dtype == torch.bfloat16),
                    int(causal), Dh ** -0.5 * math.log2(math.e), stream())
        if err:
            fail(f"the parent's flash_attention: error {err}")
        return o, lse

    def flash_backward(q, k, v, o, lse, do, causal):
        from repro_torch.kernels.flash_attention.ops import TEMPLATE_WIDTH
        B, S, H, Dh = q.shape
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        d_rows = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        err = fb_fn(*(t.data_ptr() for t in (q, k, v, o, lse, do, dq, dk, dv,
                                             d_rows)),
                    B, S, H, k.shape[2], Dh, TEMPLATE_WIDTH[Dh],
                    int(q.dtype == torch.bfloat16), int(causal), Dh ** -0.5,
                    stream())
        if err:
            fail(f"the parent's flash_attention_bwd: error {err}")
        return dq, dk, dv
    return types.SimpleNamespace(forward=forward, backward=backward,
                                 gather_aggregate=gather_aggregate,
                                 reservoir_topm=reservoir_topm,
                                 flash_forward=flash_forward,
                                 flash_backward=flash_backward)


def _in_order(torch, rows, idx, mode: str):
    """The reference order written out, on the card: from +0, acc = acc +
    where(valid_f, row_f, 0) over ascending f, then / max(cnt, 1) for the
    mean; f32, one rounding per operation.  Indices past the rows clamp."""
    valid = idx >= 0
    safe = idx.clamp(0, rows.shape[0] - 1).long()
    zero = torch.zeros((), dtype=rows.dtype, device=rows.device)
    acc = torch.zeros((idx.shape[0], rows.shape[1]), dtype=rows.dtype,
                      device=rows.device)
    for f in range(idx.shape[1]):
        acc = acc + torch.where(valid[:, f, None], rows[safe[:, f]], zero)
    if mode == "mean":
        acc = acc / valid.sum(1, keepdim=True).clamp(min=1).to(rows.dtype)
    return acc


def _half_from_sideband(torch, enc, table, aux):
    """``enc`` re-encoded so that every other distinct slot it names is read
    from the sideband instead: ``(enc', aux')``, ``aux'`` being ``aux``
    followed by those slots' rows.  Every id resolves to the same row as
    before (entries already in the sideband, padding among them, keep their
    rows)."""
    slots = torch.unique(enc[enc >= 0])
    moved = slots[::2]
    where = torch.full((table.shape[0],), -1, dtype=torch.int64,
                       device=enc.device)
    where[moved] = torch.arange(moved.numel(), device=enc.device)
    at = where[enc.clamp(min=0).long()]
    enc2 = torch.where((enc >= 0) & (at >= 0),
                       (-(aux.shape[0] + at) - 1).to(enc.dtype), enc)
    return enc2.contiguous(), torch.cat([aux, table[moved]]).contiguous()


def _turns(torch, new, old, flush) -> list:
    """``old`` / ``new`` / ``new`` / ``old``, each timed as in phase 2;
    None in the parent's slots where there is no parent."""
    if old is None:
        return [None, time_ms(torch, new, flush), time_ms(torch, new, flush),
                None]
    return [time_ms(torch, fn, flush) for fn in (old, new, new, old)]


def phase_agg(torch, stamp: str, batch: dict, launches: dict,
              parent) -> list:
    """gather_aggregate and neighbor_agg at the first batch's shapes (and a
    re-encoding of the batch with half its rows in the sideband), held
    against their plain versions, against the reference order written out
    and bit for bit against the parent commit's kernels, and timed (the
    forwards and the backward in turns with the parent's); returns the JSON
    entries."""
    import torch.nn.functional as F

    from repro_torch.kernels.fused_gather_agg.ops import gather_aggregate
    from repro_torch.kernels.fused_gather_agg.ref import (gather_aggregate_ref,
                                                          resolve_rows_ref)
    from repro_torch.kernels.segment_agg.ops import (neighbor_agg,
                                                     neighbor_agg_backward)
    from repro_torch.kernels.segment_agg.ref import (neighbor_agg_bwd_ref,
                                                     neighbor_agg_ref)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rate = hbm_rate(torch.cuda.get_device_name(0))
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    enc, aux, table = batch["enc"], batch["aux"], batch["table"]
    idxs = batch["neigh_idxs"]

    def bound(nbytes, flops):
        t_b, t_f = nbytes / rate * 1e3, flops / F32_FLOP_PER_S * 1e3
        return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")

    # -- gather_aggregate: layer 0 (mean: graphsage/gcn; sum: gin), with
    # every row resident (as the trainer runs it) and with half the
    # distinct rows re-encoded into the sideband (the miss path) ----------
    idx0 = idxs[0]
    nd, fan = idx0.shape
    f = table.shape[1]
    enc_m, aux_m = _half_from_sideband(torch, enc, table, aux)
    ga_cases = {"resident": (enc, aux), "half_sideband": (enc_m, aux_m)}
    ga_err, timed_ga = 0.0, {}
    for label, (e, x) in ga_cases.items():
        for mode in ("mean", "sum"):
            h, a = gather_aggregate(e, idx0, table, x, mode=mode)
            h_r, a_r = gather_aggregate_ref(e, idx0, table, x, mode=mode)
            order = _in_order(torch, resolve_rows_ref(e, table, x), idx0, mode)
            old = (None if parent is None
                   else parent.gather_aggregate(e, idx0, table, x, mode))
            torch.cuda.synchronize()
            exact = torch.equal(h, h_r)
            err = float((a - a_r).abs().max())
            ok = bool(torch.allclose(a, a_r, atol=1e-5, rtol=1e-5))
            same_order = torch.equal(a, order)
            same_parent = old is None or (torch.equal(h, old[0])
                                          and torch.equal(a, old[1]))
            ga_err = max(ga_err, err)
            print(f"[kernel] gather_aggregate {label} {mode} enc "
                  f"({e.shape[0]},) ({int((e < 0).sum())} from the sideband) "
                  f"idx {tuple(idx0.shape)} table {tuple(table.shape)} aux "
                  f"{tuple(x.shape)}: h_dst bit-exact={exact}, agg "
                  f"max_abs_err={err} (tolerance 1e-5), agg bit-equal to the "
                  f"reference order={same_order}, both outputs bit-equal to "
                  f"the parent's kernel="
                  f"{'not compared' if old is None else same_parent}",
                  flush=True)
            if not (exact and ok and same_order and same_parent):
                fail(f"gather_aggregate {label} {mode} disagrees")
        # bytes the call needs: the distinct rows it resolves, the enc
        # entries it reads, the indices, and the two outputs
        valid = idx0 >= 0
        refs = torch.cat([torch.arange(nd, device=dev), idx0[valid].long()])
        pos = torch.unique(refs)
        rows = int(torch.unique(e[pos]).numel())
        nbytes = rows * f * 4 + pos.numel() * 4 + nd * fan * 4 + 2 * nd * f * 4
        b_ms, b_by = bound(nbytes, int(valid.sum()) * f)
        t = _turns(torch, lambda: gather_aggregate(e, idx0, table, x),
                   None if parent is None else
                   lambda: parent.gather_aggregate(e, idx0, table, x, "mean"),
                   flush)
        plain = time_ms(torch, lambda: gather_aggregate_ref(e, idx0, table, x),
                        flush)
        _profile(torch, lambda: gather_aggregate(e, idx0, table, x), stamp,
                 f"gather_aggregate {label} mean", calls=PROFILE_CALLS)
        print(f"[time] gather_aggregate {label} mean idx {tuple(idx0.shape)} "
              f"F={f}: kernel {t[1]} ms, plain {plain} ms, no library call, "
              f"{b_by} bound {b_ms} ms ({nbytes} B: {rows} distinct rows); "
              f"turns parent / kernel / kernel / parent {t} ms  [{stamp}]",
              flush=True)
        timed_ga[label] = {"ms": t[1], "plain_ms": plain, "bound_ms": b_ms,
                           "bound_by": b_by, "parent_ms": t[0]}
    ga = {"name": "gather_aggregate", "route": "cuda",
          "source": "src/repro_torch/kernels/csrc/fused_gather_agg.cu",
          "replaces": "src/repro/kernels/fused_gather_agg/kernel.py:63",
          "launches": launches["gather_aggregate"], "max_abs_err": ga_err,
          "library_ms": None, **timed_ga["resident"],
          "half_sideband_ms": timed_ga["half_sideband"]["ms"],
          "half_sideband_parent_ms": timed_ga["half_sideband"]["parent_ms"]}

    # -- neighbor_agg, forward and backward ---------------------------------
    # (label, idx, Ns, D, mode, timed): the graphsage hops at their level
    # caps, GAT's weighted layer 0 and last hop (D=47), and an odd width
    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    cases = [("hop1", idxs[1], idxs[0].shape[0], 256, "mean", True),
             ("hop2", idxs[2], idxs[1].shape[0], 256, "mean", True),
             ("gin_hop1", idxs[1], idxs[0].shape[0], 256, "sum", False),
             ("gat_layer0", idx0, enc.shape[0], 256, "weighted", True),
             ("gat_last", idxs[2], idxs[1].shape[0], 47, "weighted", False)]
    odd = torch.randint(-1, 20, (9, 4), generator=g, device=dev,
                        dtype=torch.int32)
    cases += [("odd_602_" + m, odd, 20, 602, m, False)
              for m in ("mean", "sum", "weighted")]
    fwd_err, bwd_err, entry = 0.0, 0.0, {}
    for label, idx, ns, d, mode, timed in cases:
        h, dout = rnd(ns, d), rnd(idx.shape[0], d)
        w = (torch.rand(idx.shape, generator=g, device=dev)
             if mode == "weighted" else None)
        m = "sum" if w is not None else mode
        out = neighbor_agg(idx, h, m, w)
        dh, dw = neighbor_agg_backward(idx, dout, h, m, w)
        dh2, dw2 = neighbor_agg_backward(idx, dout, h, m, w)
        ref = neighbor_agg_ref(idx, h, m, w)
        # the forward's oracles: the reference order written out (mean and
        # sum; the weighted multiply-add is one fma in the kernels, two
        # roundings in torch) and the parent's kernel, bit for bit
        order = _in_order(torch, h, idx, m) if w is None else None
        old = None if parent is None else parent.forward(idx, h, m, w)
        # the backward's oracle: the plain version on the CPU (index_add_ in
        # ascending entry order), which dh must equal bit for bit
        dh_c, dw_c = neighbor_agg_bwd_ref(
            idx.cpu(), dout.cpu(), h.cpu(), m, None if w is None else w.cpu())
        torch.cuda.synchronize()
        err_f = float((out - ref).abs().max())
        ok_f = bool(torch.allclose(out, ref, atol=1e-5, rtol=1e-5))
        same_order = order is None or torch.equal(out, order)
        same_parent = old is None or torch.equal(out, old)
        exact = torch.equal(dh.cpu(), dh_c)
        again = torch.equal(dh, dh2) and (w is None or torch.equal(dw, dw2))
        rel_w = _close(dw.cpu(), dw_c) if w is not None else 0.0
        err_b = float((dh.cpu() - dh_c).abs().max())
        fwd_err, bwd_err = max(fwd_err, err_f), max(bwd_err, err_b)
        valid = idx >= 0
        seg = torch.bincount(idx[valid].clamp(max=ns - 1).long(), minlength=ns)
        seg = seg[seg > 0]
        over = seg > 32
        print(f"[kernel] neighbor_agg {label} {mode} idx {tuple(idx.shape)} "
              f"h ({ns}, {d}): forward max_abs_err={err_f} (tolerance 1e-5), "
              f"bit-equal to the reference order="
              f"{'weighted: not compared' if order is None else same_order}, "
              f"to the parent's kernel="
              f"{'not compared' if old is None else same_parent}; "
              f"backward dh bit-equal to the CPU plain version={exact} "
              f"(max_abs_err={err_b}), two launches bit-equal={again}"
              + (f", dw rel {rel_w:.2e} (tolerance rel 1e-5)" if w is not None
                 else "") + f"; segments: {seg.numel()}, longest "
              f"{int(seg.max()) if seg.numel() else 0}, {int(over.sum())} "
              f"over 32 ({int(seg[over].sum())} of {int(seg.sum())} entries)",
              flush=True)
        if not (ok_f and same_order and same_parent and exact and again
                and rel_w <= 1e-5):
            fail(f"neighbor_agg {label} disagrees")
        if not timed:
            continue
        nd, fan = idx.shape
        nv = int(valid.sum())
        rows = seg.numel()
        wbytes = nd * fan * 4 if w is not None else 0
        fb = rows * d * 4 + nd * d * 4 + nd * fan * 4 + wbytes
        bb = (nd * d * 4 + nd * fan * 4 + ns * d * 4
              + (wbytes + rows * d * 4 + nd * fan * 4 if w is not None else 0))
        fwd_b = bound(fb, nv * d * (2 if w is not None else 1))
        bwd_b = bound(bb, nv * d * (4 if w is not None else 1))
        bag, hp = _bag_inputs(torch, idx, h)
        lib = lambda: F.embedding_bag(bag, hp, mode=m,  # noqa: E731
                                      per_sample_weights=w, padding_idx=ns)
        lib_err = float((lib() - ref).abs().max())
        hp_g = hp.detach().requires_grad_(True)
        lib_out = F.embedding_bag(bag, hp_g, mode=m, per_sample_weights=w,
                                  padding_idx=ns)
        # each direction beside the parent's kernel, in turns: parent,
        # kernel, kernel, parent
        f_turns = _turns(torch, lambda: neighbor_agg(idx, h, m, w),
                         None if parent is None else
                         lambda: parent.forward(idx, h, m, w), flush)
        tf = {"ms": f_turns[1],
              "plain_ms": time_ms(torch, lambda: neighbor_agg_ref(
                  idx, h, m, w), flush),
              "library_ms": time_ms(torch, lib, flush),
              "bound_ms": fwd_b[0], "bound_by": fwd_b[1],
              "parent_ms": f_turns[0]}
        b_turns = _turns(torch, lambda: neighbor_agg_backward(
            idx, dout, h, m, w), None if parent is None else
            lambda: parent.backward(idx, dout, h, m, w), flush)
        tb = {"ms": b_turns[1],
              "plain_ms": time_ms(torch, lambda: neighbor_agg_bwd_ref(
                  idx, dout, h, m, w), flush),
              "library_ms": time_ms(torch, lambda: torch.autograd.grad(
                  lib_out, [hp_g], dout, retain_graph=True), flush),
              "bound_ms": bwd_b[0], "bound_by": bwd_b[1],
              "parent_ms": b_turns[0]}
        _profile(torch, lambda: neighbor_agg(idx, h, m, w), stamp,
                 f"neighbor_agg forward {label}", calls=PROFILE_CALLS)
        _profile(torch, lambda: neighbor_agg_backward(idx, dout, h, m, w),
                 stamp, f"neighbor_agg backward {label}", calls=PROFILE_CALLS)
        print(f"[time] neighbor_agg {label} {mode} idx ({nd}, {fan}) h "
              f"({ns}, {d}), {nv} valid entries, {rows} distinct rows: "
              f"forward kernel {tf['ms']} ms, plain {tf['plain_ms']} ms, "
              f"embedding_bag {tf['library_ms']} ms (max diff {lib_err}), "
              f"{fwd_b[1]} bound {fwd_b[0]} ms ({fb} B), turns parent / "
              f"kernel / kernel / parent {f_turns} ms; backward kernel "
              f"{tb['ms']} ms, plain {tb['plain_ms']} ms, embedding_bag "
              f"autograd {tb['library_ms']} ms, {bwd_b[1]} bound "
              f"{bwd_b[0]} ms ({bb} B), turns parent / kernel / kernel / "
              f"parent {b_turns} ms  [{stamp}]", flush=True)
        if label == "hop1":
            entry.update(tf)
            entry.update({f"backward_{k}": v for k, v in tb.items()})
        else:
            entry.update({f"{label}_{k}": v for k, v in tf.items()
                          if k in ("ms", "bound_ms", "parent_ms")})
    na = {"name": "neighbor_agg", "route": "cuda",
          "source": "src/repro_torch/kernels/csrc/segment_agg.cu",
          "replaces": "src/repro/kernels/segment_agg/kernel.py:56",
          "launches": launches["neighbor_agg"],
          "backward_launches": launches["neighbor_agg_backward"],
          "max_abs_err": fwd_err, "backward_max_abs_err": bwd_err, **entry}
    return [ga, na]


def hop_buckets(graph, dst_ids, fanout: int, weight_fn, rng) -> list:
    """The rows that ``NeighborSampler._sample_one_hop`` hands to top-m
    selection for ``dst_ids``, in its own buckets (``topm_buckets``): a list
    of ``(width, w, u, mask)``, ``w`` the bias weights of each row's
    neighbours and ``u`` uniforms from ``rng``, both (R, width) float32,
    ``mask`` (R, width) bool (``col < size``)."""
    import numpy as np

    from repro_torch.core.sampling import hop_edges, topm_buckets
    indptr, indices = graph.adj()
    nb_all, row_start, sizes = hop_edges(indptr, indices, dst_ids)
    w_all = weight_fn(nb_all)
    return [(src.shape[1], w_all[src].astype(np.float32),
             rng.random(valid.shape, dtype=np.float32), valid)
            for _, src, valid in topm_buckets(sizes, row_start, fanout)]


def inclusion_probability(w):
    """Exact inclusion probability of each lane in a weighted sample of 2
    without replacement: p_i = w_i/W + Σ_{j≠i} (w_j/W)·w_i/(W − w_j)."""
    W = sum(w)
    return [wi / W + sum(wj / W * wi / (W - wj)
                         for j, wj in enumerate(w) if j != i)
            for i, wi in enumerate(w)]


def _reservoir_odd_cases(torch, dev, g, weight_fn, rng) -> list:
    """(label, m, w, u, mask) on the card: the hub row unpadded (m = 5, 10
    and 40, the last past the per-thread list of 32), N = 37, m > N,
    all-masked rows and a wide row with fewer valid lanes than m, exact
    ties from duplicated u, u = 0 lanes and int32 masks."""
    import numpy as np
    indptr, indices = g.adj()
    hub = int(np.argmax(np.diff(indptr)))
    nb = indices[indptr[hub]:indptr[hub + 1]]

    def rand(R, N, density=0.8, mask_dtype=bool):
        w = rng.uniform(0.5, 4.0, (R, N)).astype(np.float32)
        u = rng.random((R, N), dtype=np.float32)
        return w, u, (rng.random((R, N)) < density).astype(mask_dtype)

    def ties(R, N):
        w = np.where(rng.random((R, N)) < 0.5, 1.0, 4.0).astype(np.float32)
        u = np.array([0.0, 0.2, 0.5, 0.7, 0.9], np.float32)[
            rng.integers(0, 5, (R, N))]
        return w, u, rng.random((R, N)) < 0.9

    hub_in = (weight_fn(nb)[None].astype(np.float32),
              rng.random((1, len(nb)), dtype=np.float32),
              np.ones((1, len(nb)), bool))
    cases = [(f"hub_n{len(nb)}_m{m}", m, *hub_in) for m in (5, 10, 40)]
    cases += [("n37", 5, *rand(13, 37)), ("m_gt_n", 9, *rand(4, 5)),
              ("n1", 3, *rand(6, 1)),
              ("sparse_wide_m40", 40, *rand(3, 4096, density=0.005)),
              ("ties", 10, *ties(64, 256)), ("ties_wide", 15, *ties(4, 8192)),
              ("int32_mask", 10, *rand(13, 100, mask_dtype=np.int32)),
              ("int32_mask_wide", 15, *rand(5, 1500, mask_dtype=np.int32))]
    w, u, mask = rand(8, 64)
    mask[3] = False
    cases.append(("all_masked_row", 5, w, u, mask))
    w, u, mask = rand(3, 2048)
    mask[1] = False
    cases.append(("all_masked_row_wide", 10, w, u, mask))
    w, u, mask = rand(32, 128)
    u[rng.random(u.shape) < 0.3] = 0.0
    cases.append(("u_zero", 10, w, u, mask))
    return [(label, m, *(torch.from_numpy(x).to(dev) for x in xs))
            for label, m, *xs in cases]


def reservoir_hops(torch, train: dict, rng) -> dict:
    """Phase 8's buckets: hops 2 and 3 of the first batch, in that order,
    with uniforms from ``rng``: ``{hop: {"m", "dst", "cases"}}``, each case
    ``(label, m, w, u, mask)`` on the card."""
    dev = torch.device("cuda")
    g, mb, weight_fn = train["graph"], train["mb"], train["weight_fn"]
    hops = {}
    for hop in (2, 3):                      # hop 1 is nearest the output
        m = train["fanout"][hop - 1]
        dst = mb.blocks[-hop].dst_ids
        cases = [(f"hop{hop}_w{width}", m,
                  *(torch.from_numpy(x).to(dev) for x in (w, u, mask)))
                 for width, w, u, mask in hop_buckets(g, dst, m, weight_fn,
                                                      rng)]
        hops[hop] = {"m": m, "dst": dst, "cases": cases}
    return hops


def phase_reservoir(torch, stamp: str, train: dict, parent) -> dict:
    """reservoir_topm at the sampler's hop shapes: every bucket of hops 2
    and 3 of the first full-width batch (each hop's launches counted), the
    hub row and odd shapes, each bit-exact against the plain version on the
    card and against the parent commit's kernel (``parent``, from
    ``parent_kernels``; None: not compared); the inclusion frequencies of
    2^20 rows against the exact probabilities; each bucket timed in turns
    with the parent's kernel (parent / kernel / kernel / parent) beside the
    plain version and ``torch.topk``, the widest bucket (the hub row) on a
    line of its own, its device time and that of the bucket of most rows
    profiled, and each hop's sums beside the host numpy time of that hop's
    ``_sample_one_hop``.  Returns the JSON entry."""
    import numpy as np

    from repro_torch.core.sampling import NeighborSampler
    from repro_torch.kernels.reservoir.ops import layout, reservoir_topm
    from repro_torch.kernels.reservoir.ref import NEG, reservoir_topm_ref
    dev = torch.device("cuda")
    rate = hbm_rate(torch.cuda.get_device_name(0))
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    g, weight_fn = train["graph"], train["weight_fn"]
    rng = np.random.default_rng(0)
    hops = reservoir_hops(torch, train, rng)

    # the counted runs: one launch per bucket, as a GPU sampler would issue,
    # each hop counted on its own
    outs, hop_launches = {}, {}
    for hop, h in hops.items():
        torch.cuda.synchronize()
        counts = _zero_counts()
        outs[hop] = [reservoir_topm(w, u, mask, m)
                     for _, m, w, u, mask in h["cases"]]
        torch.cuda.synchronize()
        launches = counts()
        want = {k: 0 for k in launches}
        want["reservoir_topm"] = len(h["cases"])
        print(f"[reservoir] hop {hop} of the first batch: {len(h['cases'])} "
              f"buckets, launches {launches} (expected {want})", flush=True)
        if launches != want:
            fail(f"reservoir hop {hop} launches {launches}, expected {want}")
        hop_launches[hop] = launches["reservoir_topm"]

    max_err = 0.0

    def same(a, b):
        return torch.equal(a[0], b[0]) and torch.equal(
            a[1].view(torch.int32), b[1].view(torch.int32))

    def check(label, m, w, u, mask, got):
        nonlocal max_err
        idx, keys = got
        ref = reservoir_topm_ref(w, u, mask, m)
        old = None if parent is None else parent.reservoir_topm(w, u, mask, m)
        torch.cuda.synchronize()
        exact = same(got, ref)
        same_parent = old is None or same(got, old)
        err = float((keys - ref[1]).abs().max())
        max_err = max(max_err, err)
        spent = int((idx == w.shape[1]).sum())
        print(f"[kernel] reservoir_topm {label} ({w.shape[0]}, {w.shape[1]}) "
              f"m={m} mask {mask.dtype} layout "
              f"{tuple(layout(w.shape[1]))}: bit-exact={exact} (idx "
              f"equal, keys equal bit for bit), max_abs_err={err}, {spent} "
              f"exhausted slots; bit-equal to the parent's kernel="
              f"{'not compared' if old is None else same_parent}", flush=True)
        if not (exact and same_parent) or not bool(
                (keys[idx == w.shape[1]] == NEG).all()):
            fail(f"reservoir_topm disagrees with its plain version or the "
                 f"parent's kernel at {label}")

    for hop, h in hops.items():
        for case, got in zip(h["cases"], outs[hop]):
            check(*case, got)
    for case in _reservoir_odd_cases(torch, dev, g, weight_fn, rng):
        check(*case, reservoir_topm(*case[2:], case[1]))

    # inclusion frequencies of w = [4, 4, 1, 1, 1, 1, 1, 1], m = 2
    T = 1 << 20
    wd = [4.0, 4.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0]
    gen = torch.Generator(device=dev).manual_seed(0)
    idx, _ = reservoir_topm(
        torch.tensor(wd, device=dev).expand(T, 8).contiguous(),
        torch.rand((T, 8), generator=gen, device=dev),
        torch.ones((T, 8), dtype=torch.bool, device=dev), 2)
    freq = (torch.bincount(idx.flatten().long(), minlength=9).cpu().numpy()
            / T)
    p = np.array(inclusion_probability(wd))
    z = np.abs(freq[:8] - p) / np.sqrt(p * (1 - p) / T)
    print(f"[kernel] reservoir_topm distribution over {T} rows of {wd}, "
          f"m=2: frequency {freq[:8].round(5).tolist()} against exact "
          f"{p.round(5).tolist()}, largest |z| {z.max():.2f} (tolerance 5)",
          flush=True)
    if z.max() > 5 or freq[8] != 0:
        fail("reservoir_topm inclusion frequencies differ from the exact "
             "probabilities")

    totals = {}
    for hop, h in hops.items():
        tot = {"ms": 0.0, "parent_ms": 0.0, "plain_ms": 0.0,
               "library_ms": 0.0, "bound_ms": 0.0, "padded_bound_ms": 0.0}
        rows = lanes = 0
        widest = most = None
        for label, m, w, u, mask in h["cases"]:
            R, N = w.shape
            km = (torch.log(u.clamp(min=1e-30)) / w.clamp(min=1e-9)
                  ).masked_fill(~mask, NEG)
            # the mask is read whole; w and u only where it is set (a masked
            # lane's key is thrown away); idx and keys written once
            valid = int(mask.sum())
            nbytes = R * N * mask.element_size() + 8 * valid + 8 * R * m
            padded = R * N * (8 + mask.element_size()) + 8 * R * m
            turns = _turns(
                torch, lambda: reservoir_topm(w, u, mask, m),
                None if parent is None else
                lambda: parent.reservoir_topm(w, u, mask, m), flush)
            t = {"ms": turns[1], "parent_ms": turns[0],
                 "plain_ms": time_ms(torch, lambda: reservoir_topm_ref(
                     w, u, mask, m), flush),
                 "library_ms": time_ms(torch, lambda: torch.topk(km, m, dim=1),
                                       flush),
                 "bound_ms": nbytes / rate * 1e3,
                 "padded_bound_ms": padded / rate * 1e3}
            for k in tot:
                tot[k] = None if t[k] is None or tot[k] is None \
                    else tot[k] + t[k]
            rows, lanes = rows + R, lanes + R * N
            line = (f"{label} ({R}, {N}) m={m} layout "
                    f"{tuple(layout(N))}: kernel {t['ms']} ms, "
                    f"parent {t['parent_ms']} ms (turns parent / kernel / "
                    f"kernel / parent {turns} ms), plain {t['plain_ms']} ms, "
                    f"torch.topk over precomputed keys (selection only) "
                    f"{t['library_ms']} ms, bytes bound {t['bound_ms']} ms "
                    f"({nbytes} B, {valid} valid lanes, at {rate / 1e12} "
                    f"TB/s; {t['padded_bound_ms']} ms counting w and u of "
                    f"every padded lane)")
            print(f"[time] reservoir_topm {line}  [{stamp}]", flush=True)
            if widest is None or N > widest[0]:
                widest = (N, line, (label, m, w, u, mask))
            if most is None or R > most[0]:
                most = (R, (label, m, w, u, mask))
        print(f"[time] reservoir_topm hub row of hop {hop}, {widest[1]}  "
              f"[{stamp}]", flush=True)
        # device time of a call, without the harness: the hub row and the
        # bucket of most rows
        for label, m, w, u, mask in (widest[2], most[1]):
            _profile(torch, lambda: reservoir_topm(w, u, mask, m), stamp,
                     f"reservoir_topm {label} ({w.shape[0]}, {w.shape[1]})",
                     calls=PROFILE_CALLS)
        sampler = NeighborSampler(g, train["fanout"], weight_fn=weight_fn,
                                  seed=0)
        host = []
        for _ in range(5):
            t0 = time.perf_counter()
            sampler._sample_one_hop(h["dst"], h["m"])
            host.append((time.perf_counter() - t0) * 1e3)
        tot["host_numpy_ms"] = float(np.median(host))
        tot["launches"] = hop_launches[hop]
        totals[hop] = tot
        print(f"[time] reservoir_topm hop {hop} (m={h['m']}), sum over "
              f"{len(h['cases'])} buckets ({rows} rows, {lanes} lanes): "
              f"kernel {tot['ms']} ms, parent {tot['parent_ms']} ms, plain "
              f"{tot['plain_ms']} ms, torch.topk (selection only) "
              f"{tot['library_ms']} ms, bytes bound {tot['bound_ms']} ms "
              f"(valid lanes; {tot['padded_bound_ms']} ms padded), launches "
              f"{tot['launches']}; host numpy time of the hop's "
              f"_sample_one_hop on the same {len(h['dst'])} rows (keys, "
              f"buckets and selection), median of 5: {tot['host_numpy_ms']} "
              f"ms  [{stamp}]", flush=True)
    t3 = totals[3]
    return {"name": "reservoir_topm", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/reservoir.cu",
            "replaces": "src/repro/kernels/reservoir/kernel.py:45",
            "launches": t3["launches"], "max_abs_err": max_err,
            "ms": t3["ms"], "plain_ms": t3["plain_ms"],
            "bound_ms": t3["bound_ms"], "bound_by": "bytes",
            "library_ms": t3["library_ms"], "parent_ms": t3["parent_ms"],
            "host_numpy_ms": t3["host_numpy_ms"], "hop2": totals[2]}


def _bf16_bound_rejects_faults(torch, out, q, k, v):
    """The bf16 check must refuse the kernel's causal output with one KV
    tile dropped from the last query block, and with the normaliser of the
    later rows 3% off; else it could not tell such a kernel from rounding."""
    from repro_torch.kernels.flash_attention.ref import bf16_excess
    B, S, H, Dh = q.shape
    r0, lo = S - 64, S // 2
    G = H // k.shape[2]
    kf, vf = (x.float().repeat_interleave(G, dim=2) for x in (k, v))
    sc = torch.einsum("bqhd,bkhd->bhqk", q[:, r0:].float(), kf) * Dh ** -0.5
    key = torch.arange(S, device=q.device)
    row = torch.arange(r0, S, device=q.device)[:, None]
    keep = (key <= row) & ((key < lo) | (key >= lo + 64))
    p = torch.softmax(sc.masked_fill(~keep, -1e30), dim=-1)
    skipped = out.clone()
    skipped[:, r0:] = torch.einsum("bhqk,bkhd->bqhd", p, vf).to(out.dtype)
    renormed = out.clone()
    renormed[:, S // 2:] = (out[:, S // 2:].float() * 1.03).to(out.dtype)
    for fault, bad in ((f"keys {lo}..{lo + 63} skipped for rows {r0}.."
                        f"{S - 1}", skipped),
                       (f"rows {S // 2}.. scaled by 1.03", renormed)):
        elem, row_x = bf16_excess(bad, q, k, v, True)
        print(f"[kernel] flash_attention bf16 bound on a faulty output "
              f"({fault}): element {elem:.3f}, row {row_x:.3f} of their "
              f"limits (must exceed 1)", flush=True)
        if max(elem, row_x) <= 1:
            fail(f"the bf16 check of flash_attention passes a faulty output "
                 f"({fault})")


def phase_flash(torch, stamp: str) -> dict:
    """flash_attention at the LM slices' shapes against its plain version,
    timed at the qwen3-4b, llama3.2-3b, zamba2-7b and qwen2-vl-2b prefills
    and the whisper-medium encoder; returns the JSON entry (the qwen3-4b
    prefill's numbers, the others beside them)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import (bf16_excess,
                                                         flash_attention_ref)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rate = hbm_rate(torch.cuda.get_device_name(0))
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    B, S = PREFILL_SHAPE
    # (label, B, S, H, Hkv, Dh, dtype, causal, timed): the timed prefills
    # (qwen3-4b, llama3.2-3b, zamba2-7b; the whisper-medium encoder,
    # non-causal over 1500 frames, a ragged last KV tile; qwen2-vl-2b, a
    # GQA group of 6) and the qwen2-moe-a2.7b and whisper-medium decoder
    # prefills' shapes; the edges of the
    # bf16 kernel's 128-row tiles (a partial diagonal, one row past a tile,
    # a partial last KV tile) and its Dh=64 instance; odd lengths, f32 and
    # non-causal; the widths run on a wider template, Dh 112 (zamba2-7b,
    # kimi-k2's GQA) and Dh 8 (glm4-9b's smoke config), in both types
    bf16 = torch.bfloat16
    cases = [("qwen3_prefill", B, S, 32, 8, 128, bf16, True, True),
             ("llama3_prefill", B, S, 24, 8, 128, bf16, True, True),
             ("zamba2_prefill", B, S, 32, 32, 112, bf16, True, True),
             ("qwen2_moe_prefill", B, S, 16, 16, 128, bf16, True, False),
             ("whisper_encoder", B, 1500, 16, 16, 64, bf16, False, True),
             ("qwen2vl_prefill", B, S, 12, 2, 128, bf16, True, True),
             ("whisper_decoder", B, 448, 16, 16, 64, bf16, True, False),
             ("s257_dh112_gqa_bf16", 1, 257, 8, 2, 112, bf16, True, False),
             ("s300_dh112_full_bf16", 1, 300, 4, 2, 112, bf16, False, False),
             ("s257_dh112_f32", 1, 257, 8, 2, 112, torch.float32, True,
              False),
             ("s300_dh112_full_f32", 1, 300, 4, 4, 112, torch.float32, False,
              False),
             ("s130_dh8_bf16", 2, 130, 8, 2, 8, bf16, True, False),
             ("s200_dh8_full_bf16", 1, 200, 4, 4, 8, bf16, False, False),
             ("s130_dh8_f32", 2, 130, 8, 2, 8, torch.float32, True, False),
             ("s200_dh8_full_f32", 1, 200, 4, 4, 8, torch.float32, False,
              False),
             ("s127_bf16", 1, 127, 32, 8, 128, bf16, True, False),
             ("s129_bf16", 1, 129, 32, 8, 128, bf16, True, False),
             ("s4097_bf16", 1, 4097, 32, 8, 128, bf16, True, False),
             ("s1000_dh64_bf16", 1, 1000, 32, 8, 64, bf16, True, False),
             ("s37_f32", 1, 37, 32, 8, 128, torch.float32, True, False),
             ("s1000_f32", 1, 1000, 32, 8, 128, torch.float32, True, True),
             ("s256_full_f32", 1, 256, 32, 32, 128, torch.float32, False,
              False),
             ("s256_full_bf16", 1, 256, 32, 32, 128, torch.bfloat16, False,
              False)]
    max_err, timed_at = 0.0, {}
    for label, b, s, h, hkv, dh, dtype, causal, timed in cases:
        q = torch.randn((b, s, h, dh), generator=g, device=dev).to(dtype)
        k, v = (torch.randn((b, s, hkv, dh), generator=g, device=dev).to(dtype)
                for _ in range(2))
        out = flash_attention(q, k, v, causal)
        ref = flash_attention_ref(q, k, v, causal)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        max_err = max(max_err, err)
        if dtype == torch.bfloat16:
            elem, row = bf16_excess(out, q, k, v, causal)
            ok = max(elem, row) <= 1
            how = (f"bf16 bound: element {elem:.3f}, row {row:.3f} of their "
                   f"limits")
        else:
            ok = err <= FLASH_F32_ATOL
            how = f"tolerance {FLASH_F32_ATOL}"
        print(f"[kernel] flash_attention {label} q ({b}, {s}, {h}, {dh}) kv "
              f"heads {hkv} {dtype} causal={causal}: max_abs_err={err} "
              f"({how})", flush=True)
        if not (ok and bool(torch.isfinite(out).all())):
            fail(f"flash_attention disagrees with its plain version at "
                 f"{label}")
        if label in ("qwen3_prefill", "zamba2_prefill"):
            _bf16_bound_rejects_faults(torch, out, q, k, v)
        if not timed:
            continue
        pairs = s * (s + 1) // 2 if causal else s * s
        flops = 4 * b * h * dh * pairs
        # the template the kernel runs: Dh 112 is computed 128 wide
        done = 4 * b * h * (128 if dh == 112 else dh) * pairs
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S
        t_f, t_b = flops / peak * 1e3, nbytes / rate * 1e3
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))   # (B, H, S, Dh)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=causal, enable_gqa=hkv != h)
        lib_err = float((lib().transpose(1, 2).float() - ref.float()).abs().max())
        t = {"ms": time_ms(torch, lambda: flash_attention(q, k, v, causal),
                           flush),
             "plain_ms": time_ms(torch, lambda: flash_attention_ref(
                 q, k, v, causal), flush),
             "library_ms": time_ms(torch, lib, flush),
             "bound_ms": max(t_f, t_b),
             "bound_by": "operations" if t_f >= t_b else "bytes"}
        print(f"[time] flash_attention {label} q ({b}, {s}, {h}, {dh}) kv "
              f"heads {hkv} {dtype}: kernel {t['ms']} ms "
              f"({flops / t['ms'] / 1e9:.1f} TFLOP/s, "
              f"{t['bound_ms'] / t['ms']:.1%} of the bound"
              + (f"; {done / t['ms'] / 1e9:.1f} TFLOP/s of the 128-wide "
                 f"template's {done} FLOP" if done != flops else "")
              + "), plain "
              f"{t['plain_ms']} ms, scaled_dot_product_attention "
              f"{t['library_ms']} ms ({flops / t['library_ms'] / 1e9:.1f} "
              f"TFLOP/s, {t['bound_ms'] / t['library_ms']:.1%} of the bound; "
              f"max diff {lib_err}); bound {t['bound_ms']} ms by "
              f"{t['bound_by']}: {flops} FLOP at {peak / 1e12} TFLOP/s = "
              f"{t_f} ms, {nbytes} B at {rate / 1e12} TB/s = {t_b} ms  "
              f"[{stamp}]", flush=True)
        timed_at[label] = t
    def brief(label):
        return {k: timed_at[label][k] for k in ("ms", "library_ms",
                                                "bound_ms")}
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:60",
            "max_abs_err": max_err, **timed_at["qwen3_prefill"],
            "llama3_2_3b_prefill": brief("llama3_prefill"),
            "zamba2_7b_prefill": brief("zamba2_prefill"),
            "whisper_medium_encoder": brief("whisper_encoder"),
            "qwen2_vl_2b_prefill": brief("qwen2vl_prefill")}


def _profile(torch, fn, stamp: str, label: str, calls: int = 1,
             rows_out=None):
    """Device time per call of ``fn`` by kernel (``torch.profiler``), over a
    window of ``calls`` calls; returns the device busy ms per call, and
    extends ``rows_out`` with the window's (name, device µs, count) rows.
    A window of a few microseconds of device work now and then comes back
    with no device events, so an empty window is profiled again, up to
    ``PROFILE_TRIES`` windows, before the phase fails."""
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = device_rows(prof)
        if rows:
            break
        print(f"[profile] {label}: window {attempt} of {PROFILE_TRIES} "
              f"recorded no device time", flush=True)
    else:
        fail(f"the profiler recorded no device time over {label} in "
             f"{PROFILE_TRIES} windows")
    if rows_out is not None:
        rows_out.extend(rows)
    busy = sum(r[1] for r in rows) / 1e3 / calls
    top = "; ".join(f"{k[:60]} {t / 1e3 / calls:.3f} ms ({c / calls:g})"
                    for k, t, c in rows[:8])
    print(f"[profile] {label}: device busy {busy:.3f} ms per call over "
          f"{calls} call(s); top: {top}  [{stamp}]", flush=True)
    return busy


def _hold_prefill_peak(torch, cfg, cparams, batch, peak: int, stamp: str):
    """The bf16 prefill's allocator peak (``footprint.step_peak`` over the
    counted call) against its memory trace on ``meta``
    (``dryrun.trace_unsharded``, the weights in the compute dtype) within
    ``footprint.peak_tolerance``, and below the arguments plus two sets of
    K and V caches, which a prefill that held its caches twice (a list of
    layers, then their stack) reached at its end."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.footprint import held_bytes, peak_tolerance
    B, S = batch["tokens"].shape
    t0 = time.perf_counter()
    want = dryrun.trace_unsharded(cfg.replace(param_dtype=cfg.compute_dtype),
                                  ShapeConfig("phase7", "prefill", S, B))
    traced_s = time.perf_counter() - t0
    cache = 2 * cfg.num_layers * B * S * cfg.num_kv_heads * cfg.head_dim * 2
    two = held_bytes(cparams, batch) + 2 * cache
    diff, tol = want["peak_bytes"] - peak, peak_tolerance(peak)
    print(f"[memory] prefill ({B}, {S}) bf16: step peak {peak} B on the card "
          f"against its trace {want['peak_bytes']} B ({diff:+d} B, "
          f"{diff / peak:+.4%}; bound {tol:.0f} B; traced on meta in "
          f"{traced_s:.1f} s of host); the arguments and two sets of K and V "
          f"caches ({cache} B a set) {two} B, {two - peak} B above the "
          f"peak  [{stamp}]", flush=True)
    if abs(diff) > tol:
        fail(f"prefill peak {peak} B, its trace {want['peak_bytes']} B")
    if not peak < two:
        fail(f"the prefill peaks {peak} B, at or above the arguments and two "
             f"sets of caches, {two} B: it holds its caches twice")


def phase_lm(torch, stamp: str) -> dict:
    """The LM serving slice at full width; returns the launch counts of the
    prefill and of the serving run."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.launch.footprint import step_peak, window_start
    from repro_torch.launch.serve import build_parser, run_lm_serve
    from repro_torch.models import layers
    from repro_torch.models.api import build, compute_params
    from repro_torch.models.params import init_params
    from repro_torch.serve.engine import Engine, Request

    dev = torch.device("cuda")
    cfg = get_config(LM_ARCH)
    model = build(cfg)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(model.decls, gen, dev)
    cparams = compute_params(params, cfg)
    torch.cuda.synchronize()
    print(f"[lm] {LM_ARCH} full width, {cfg.num_layers} layers: "
          f"{cfg.param_count()} parameters drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s (f32 masters and a bf16 copy); "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated  "
          f"[{stamp}]", flush=True)

    B, S = PREFILL_SHAPE
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                     device=dev)}
    with torch.no_grad():
        model.prefill(cparams, batch)                 # warm-up, not counted
        torch.cuda.synchronize()
        base = window_start()
        counts = _zero_counts()
        t0 = time.perf_counter()
        logits, caches = model.prefill(cparams, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        prefill_launches = counts()
        peak = step_peak(base, cparams, batch)
    want = {"cache_gather": 0, "gather_aggregate": 0, "neighbor_agg": 0,
            "neighbor_agg_backward": 0, "flash_attention": cfg.num_layers,
            "reservoir_topm": 0}
    print(f"[lm] prefill tokens ({B}, {S}): {dt * 1e3:.1f} ms, "
          f"{B * S / dt:.0f} tokens/s; launches {prefill_launches} (expected "
          f"{want})  [{stamp}]", flush=True)
    if prefill_launches != want:
        fail(f"prefill launches {prefill_launches}, expected {want}")
    kv_shape = (cfg.num_layers, B, S, cfg.num_kv_heads, cfg.head_dim)
    if not (logits.shape == (B, cfg.vocab_size)
            and bool(torch.isfinite(logits).all())
            and tuple(caches["k"].shape) == kv_shape):
        fail(f"prefill logits {tuple(logits.shape)} (finite: "
             f"{bool(torch.isfinite(logits).all())}), caches "
             f"{tuple(caches['k'].shape)}")
    del caches, logits
    _hold_prefill_peak(torch, cfg, cparams, batch, peak, stamp)
    with torch.no_grad():
        _profile(torch, lambda: model.prefill(cparams, batch), stamp,
                 f"one prefill of ({B}, {S})")
    del cparams

    args = build_parser().parse_args(LM_SERVE_ARGS)
    buf = io.StringIO()
    counts = _zero_counts()
    with contextlib.redirect_stdout(buf):
        rep = run_lm_serve(args, params=params)
    torch.cuda.synchronize()
    serve_launches = counts()
    for line in buf.getvalue().splitlines():
        print(f"{line}  [{stamp}]", flush=True)
    eng, st = rep["engine"], rep["stats"]
    done = eng.completed
    if not (st["completed"] == args.requests == len(done)
            and all(r.status == "done" and len(r.out_tokens) == args.max_new
                    and all(0 <= t < cfg.vocab_size for t in r.out_tokens)
                    for r in done)):
        fail(f"{st['completed']}/{args.requests} requests completed")
    if any(serve_launches.values()):
        fail(f"serving launched {serve_launches}: decode is plain torch")
    # one decode step with every slot busy at position max_len / 2
    step = {"token": torch.ones(args.batch, dtype=torch.int32, device=dev),
            "pos": torch.full((args.batch,), args.max_len // 2,
                              dtype=torch.int32, device=dev)}
    times = []
    with torch.no_grad():
        for _ in range(20):
            t0 = time.perf_counter()
            lg, _ = eng.model.decode(eng._cparams, eng.kv.caches, step)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        if not bool(torch.isfinite(lg).all()):
            fail("decode-step logits are not finite")
        _profile(torch, lambda: eng.model.decode(eng._cparams, eng.kv.caches,
                                                 step), stamp,
                 f"one decode step at batch {args.batch}")
    print(f"[lm] serving {args.requests} requests at batch {args.batch}: "
          f"{st['tokens']} tokens in {st['seconds']:.2f} s, "
          f"{st['tokens_per_s']:.1f} tokens/s; TTFT p50 "
          f"{st['ttft_p50_ms']:.1f} ms p99 {st['ttft_p99_ms']:.1f} ms; "
          f"decode step (batch {args.batch}, position {args.max_len // 2}) "
          f"median of 20 {float(np.median(times)):.2f} ms; launches "
          f"{serve_launches}  [{stamp}]", flush=True)
    del eng, rep

    # f32 on a 64-token prompt: the kernel's prefill against the plain
    # version's, and the engine's first greedy token against its argmax
    cfg32 = cfg.replace(compute_dtype="float32")
    m32 = build(cfg32)
    prompt = np.random.default_rng(1).integers(1, cfg.vocab_size, 64
                                               ).astype(np.int32)
    toks = {"tokens": torch.from_numpy(prompt)[None].to(dev)}
    with torch.no_grad():
        got, _ = m32.prefill(params, toks)
        kernel = layers.flash_attention
        layers.flash_attention = flash_attention_ref
        try:
            want_logits, _ = m32.prefill(params, toks)
        finally:
            layers.flash_attention = kernel
    rel = float((got - want_logits).abs().max() / want_logits.abs().max())
    eng = Engine(cfg32, params=params, batch=1, max_len=128, device=dev)
    eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=1))
    eng.run_to_completion()
    first, top = eng.completed[0].out_tokens[0], int(got[0].argmax())
    print(f"[check] f32 prefill of 64 tokens: kernel vs plain attention max "
          f"|diff| / max |logit| = {rel:.2e} (tolerance "
          f"{LOGITS_REL_TOL}); engine first token {first}, prefill argmax "
          f"{top}", flush=True)
    if not (rel <= LOGITS_REL_TOL and bool(torch.isfinite(got).all())):
        fail("the f32 prefill through the kernel differs from the plain one")
    if first != top:
        fail("the engine's first token is not the prefill's argmax")
    return {"prefill": prefill_launches, "serve": serve_launches}


def _run_multipart(torch, argv: list, stamp: str):
    """``run_gnn`` of ``repro_torch.launch.train`` with ``argv`` and a
    fresh checkpoint directory; the launch counts zeroed just before and
    read just after.  Returns (what run_gnn returns, launches, seconds)."""
    from repro_torch.launch.train import build_parser, run_gnn
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    args = build_parser().parse_args(argv + ["--ckpt-dir", ckpt])
    buf = io.StringIO()
    counts = _zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rep = run_gnn(args)
    torch.cuda.synchronize()
    launches = counts()
    wall = time.perf_counter() - t0
    for line in buf.getvalue().splitlines():
        print(f"{line}  [{stamp}]", flush=True)
    return rep, launches, wall


def phase_multipart(torch, stamp: str) -> dict:
    """The multi-partition slice at full width (phase 9); returns the launch
    counts of the fused run and of the unfused run."""
    import numpy as np

    from repro_torch.core.multipart import MultiPipeline
    from repro_torch.core.pipeline import PipelineStats
    from repro_torch.core.sampling import NeighborSampler, seed_loader
    from repro_torch.distributed.collectives import grad_allreduce
    from repro_torch.graph.batch import (batch_device_arrays,
                                         compute_level_caps)
    from repro_torch.launch.mesh import HostSimMesh
    from repro_torch.launch.train import multipartition_summary
    from repro_torch.models.gnn import make_grad_fn_allfused
    from repro_torch.models.params import init_params, leaves
    from repro_torch.train.checkpoint import CheckpointManager

    rep, launches, wall = _run_multipart(torch, MULTIPART_ARGS, stamp)
    tr, tr2, sup = rep["trainer"], rep["restored"], rep["report"]
    # what phase 16's group run is held to, read before any check below
    # moves the trainer or reads through its planes
    ref = multipartition_summary(rep)
    cfg, plan, parts = tr.cfg, tr.plan, tr.plan.parts
    steps = sup.steps_run
    try:
        if not (steps == 8 and sup.checkpoints == 2 and sup.failures == 0
                and tr.global_steps == 8 and parts == 2):
            fail(f"multi-partition run: {sup}, {tr.global_steps} global "
                 f"steps, {parts} partitions")
        layers = cfg.num_layers
        want = {"cache_gather": 0, "gather_aggregate": parts * steps,
                "neighbor_agg": parts * steps * (layers - 1),
                "neighbor_agg_backward": parts * steps * (layers - 1),
                "flash_attention": 0, "reservoir_topm": 0}
        print(f"[multipart] {ARCH} fused, full width, {parts} partitions: "
              f"{steps} global steps under fit_supervised; launches "
              f"{launches} (expected {want}); run_gnn incl. both trainers' "
              f"builds and evaluations {wall:.2f} s  [{stamp}]", flush=True)
        if launches != want:
            fail(f"multi-partition launches {launches}, expected {want}")
        for slot in tr.slots:
            st = slot.pipe.stats
            if (st.steps != steps or len(st.losses) != steps
                    or not all(map(math.isfinite, st.losses))):
                fail(f"partition {slot.index}: {st.steps} steps, losses "
                     f"{st.losses}")
            if slot.pipe.plane.device.type != "cuda":
                fail(f"partition {slot.index}'s plane is on "
                     f"{slot.pipe.plane.device}")
        if not all(p.is_cuda for p in leaves(tr.params)):
            fail("multi-partition parameters are not on cuda")
        secs = rep["seconds"]
        print(f"[multipart] plan: sizes {[len(ns) for ns in plan.node_sets]}, "
              f"edge locality {plan.edge_locality(tr.full_graph)}, kept "
              f"information {plan.kept_information(tr.full_graph)}, halo "
              f"rows kept {[len(hs) for hs in plan.halo_sets]} "
              f"({plan.halo_rows} in all, budget {plan.halo_budget}), "
              f"exchange {tr.halo_exchange_bytes} B; host seconds: planning "
              f"{tr.plan_seconds} (the restored trainer's "
              f"{tr2.plan_seconds}), trainer build {secs['build']} (the "
              f"restored trainer's {secs['rebuild']})  [{stamp}]", flush=True)
        print(f"[multipart] {steps} global steps in {secs['fit']} s: "
              f"{steps / secs['fit']} global steps/s wall clock (the first "
              f"incl. one-time set-up, 2 checkpoint writes incl.)  "
              f"[{stamp}]", flush=True)
        for slot in tr.slots:
            st, n = slot.pipe.stats, max(slot.pipe.stats.steps, 1)
            print(f"[multipart] partition {slot.index}: mean of {st.steps} "
                  f"steps: sample {st.t_sample / n * 1e3:.3f} ms, batch "
                  f"{st.t_batch / n * 1e3:.3f} ms, train "
                  f"{st.t_train / n * 1e3:.3f} ms; losses {st.losses}; "
                  f"cache hit rate {slot.cache.stats.hit_rate}, halo hit "
                  f"rate {slot.halo_stats.hit_rate}  [{stamp}]", flush=True)
        agg = PipelineStats()
        MultiPipeline(tr)._aggregate(agg)
        print(f"[multipart] modeled memory {tr.modeled_memory(agg)} B "
              f"({parts} partitions, {cfg.parallel_mode}); accuracy "
              f"{tr.evaluate()}, restored {tr2.evaluate()}; cache hit rate "
              f"{tr.cache_hit_rate}, halo hit rate {tr.halo_hit_rate}  "
              f"[{stamp}]", flush=True)

        # 1. restore: the restored trainer holds the committed step's state
        mgr = CheckpointManager(rep["ckpt_dir"], async_save=False)
        step = mgr.latest_step()
        with np.load(Path(rep["ckpt_dir"]) / f"step_{step:09d}" /
                     "shard_0.npz") as z:
            on_disk = {k: z[k] for k in z.files}
        ref["ckpt"], ref["manifest"] = on_disk, mgr.read_manifest(step)
        from repro_torch.train.checkpoint import _flatten_with_names
        disk_ok = all(
            np.array_equal(on_disk[f"{g}/{n}".replace("/", "__")],
                           x.cpu().numpy() if isinstance(x, torch.Tensor)
                           else np.asarray(x, np.int32))
            for g, tree in tr2.state_dict().items()
            for n, x in _flatten_with_names(tree))
        stats_ok = (
            [s.cache.stats for s in tr2.slots] ==
            [s.cache.stats for s in tr.slots]
            and [s.halo_stats for s in tr2.slots] ==
            [s.halo_stats for s in tr.slots])
        mine, theirs = leaves(tr2.state_dict()), leaves(tr.state_dict())
        equal = len(mine) == len(theirs) and all(
            torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
            for x, y in zip(mine, theirs))
        print(f"[check] restore: step {step}, global_steps "
              f"{tr2.global_steps}, params and opt_state torch.equal to the "
              f"writer's={equal} and to the committed npz={disk_ok}; cache "
              f"and halo statistics back={stats_ok}; restore "
              f"{secs['restore']} s host  [{stamp}]", flush=True)
        if not (step == 8 and tr2.global_steps == 8 and equal and disk_ok
                and stats_ok and all(p.is_cuda for p in leaves(tr2.params))):
            fail("the restored trainer differs from the committed checkpoint")
        counts = _zero_counts()
        tr2.global_step()
        torch.cuda.synchronize()
        after = counts()
        if not (tr2.global_steps == 9 and after["gather_aggregate"] == parts
                and all(math.isfinite(s.pipe.stats.losses[-1])
                        for s in tr2.slots)):
            fail(f"the global step after the restore: {after}, "
                 f"global_steps {tr2.global_steps}")
        save_dir = tempfile.mkdtemp(prefix="chip_smoke_save_")
        try:
            t0 = time.perf_counter()
            tr.save(CheckpointManager(save_dir, async_save=False), step=8)
            t_save = time.perf_counter() - t0
        finally:
            shutil.rmtree(save_dir, ignore_errors=True)
        nbytes = sum(np.asarray(x.cpu() if isinstance(x, torch.Tensor)
                                else x).nbytes
                     for x in leaves(tr.state_dict()))
        print(f"[multipart] checkpoint write (synchronous, {nbytes} B of "
              f"params and opt_state) {t_save} s, restore {secs['restore']} "
              f"s; one global step after the restore: launches {after}  "
              f"[{stamp}]", flush=True)

        # 2. the first global step's all-reduced gradient, card against CPU,
        # from the initial parameters (re-drawn from the seed) and the two
        # partitions' first batches (re-derived as each pipeline drew them)
        batches = []
        for slot in tr.slots:
            g = slot.graph
            seeds = next(iter(seed_loader(g, cfg.batch_size,
                                          tr.seed + slot.index)))
            mb = NeighborSampler(g, cfg.fanout, weight_fn=slot.weight_fn,
                                 seed=tr.seed + slot.index).sample(seeds)
            caps = compute_level_caps(len(seeds), cfg.fanout, g.num_nodes)
            arrays = batch_device_arrays(mb, level_caps=caps)
            enc, aux, table = slot.pipe.plane.fused_inputs(
                mb.input_ids, arrays["pads"][0])
            batches.append({
                "inputs": (enc.cpu(), aux.cpu(), table.cpu(),
                           [torch.from_numpy(i) for i in arrays["neigh_idxs"]],
                           torch.from_numpy(arrays["labels"])),
                "n": len(mb.input_ids)})
        means, losses = {}, {}
        for label, dev in (("card", "cuda"), ("host", "cpu")):
            params = init_params(tr.decls, torch.Generator().manual_seed(
                tr.seed), dev)
            gfn = make_grad_fn_allfused(cfg)
            grads, ls = [], []
            for b in batches:
                enc, aux, table, idxs, labels = b["inputs"]
                gr, loss, _ = gfn(params, enc.to(dev), aux.to(dev),
                                  table.to(dev), [i.to(dev) for i in idxs],
                                  labels.to(dev))
                grads.append(gr)
                ls.append(float(loss))
            means[label] = [x.cpu() for x in
                            leaves(grad_allreduce(HostSimMesh(parts))(grads))]
            losses[label] = ls
        grad_rel = max(_close(a, b) for a, b in zip(means["card"],
                                                    means["host"]))
        run_first = [s.pipe.stats.losses[0] for s in tr.slots]
        loss_rel = max(abs(a - b) / abs(b) for a, b in
                       zip(losses["card"] + run_first,
                           losses["host"] + losses["host"]))
        print(f"[check] first global step, input ids "
              f"{[b['n'] for b in batches]}: losses cuda {losses['card']} "
              f"cpu {losses['host']} (the run's first {run_first}); "
              f"all-reduced gradient cuda vs cpu rel {grad_rel:.2e}, losses "
              f"rel {loss_rel:.2e} (tolerance 1e-4)", flush=True)
        if not (grad_rel <= 1e-4 and loss_rel <= 1e-4):
            fail("the first global step on the card differs from the CPU "
                 "beyond 1e-4")

        # 3. halo rows in each partition's device plane equal the owner's
        owner_local = plan.local_ids()
        halo_ok = []
        for slot, ns, hs in zip(tr.slots, plan.node_sets, plan.halo_sets):
            local = np.arange(len(ns), len(ns) + len(hs))
            resident = int(slot.cache.is_cached(local).sum())
            got = slot.pipe.plane.fetch(local)
            want_rows = np.stack([plan.subgraphs[q].features[owner_local[v]]
                                  for q, v in zip(plan.owner[hs], hs)])
            halo_ok.append((len(hs), resident,
                            bool(np.array_equal(got, want_rows))))
            ref.setdefault("halo_rows", {})[slot.index] = got
        print(f"[check] halo rows (rows, resident on the card, bit-equal to "
              f"the owner's) per partition: {halo_ok}", flush=True)
        if not all(ok and n == res for n, res, ok in halo_ok):
            fail(f"halo rows in the device planes: {halo_ok}")

        # 4. the failure path on the same trainer, in a new directory
        fail_dir = tempfile.mkdtemp(prefix="chip_smoke_fail_")
        counts = _zero_counts()
        try:
            t0 = time.perf_counter()
            frep = tr.fit_supervised(4, fail_dir, ckpt_every=2,
                                     fail_at_step=3)
            torch.cuda.synchronize()
            t_fail = time.perf_counter() - t0
        finally:
            shutil.rmtree(fail_dir, ignore_errors=True)
        fl = counts()
        print(f"[check] failure path: fit_supervised(4, fail_at_step=3): "
              f"{frep}; launches {fl}; {t_fail} s  [{stamp}]", flush=True)
        if not (frep.final_step == 4 and frep.failures == 1
                and frep.restores == 1 and frep.steps_run == 5
                and fl["gather_aggregate"] == parts * frep.steps_run):
            fail(f"failure path: {frep}, launches {fl}")

        # device busy share of a warm global step: 3 un-profiled steps on
        # the host clock, then 2 profiled ones for the device time by kernel
        from torch.profiler import ProfilerActivity, profile
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            tr.global_step()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                tr.global_step()
            torch.cuda.synchronize()
        rows = device_rows(prof)
        if not rows:
            fail("the profiler recorded no device time over 2 global steps")
        busy_ms = sum(r[1] for r in rows) / 2e3
        step_ms = float(np.median(walls)) * 1e3
        ref["step_ms"], ref["busy_ms"] = step_ms, busy_ms
        top = "; ".join(f"{k[:60]} {t / 2e3:.3f} ms/step ({c // 2}/step)"
                        for k, t, c in rows[:8])
        print(f"[profile] 2 warm global steps: device busy {busy_ms:.3f} "
              f"ms/step (kernels and copies summed), {100 * busy_ms / step_ms:.2f}"
              f"% of the {step_ms:.1f} ms median un-profiled global step "
              f"(of 3: {[round(w * 1e3, 1) for w in walls]} ms); top: {top}  "
              f"[{stamp}]", flush=True)
    finally:
        shutil.rmtree(rep["ckpt_dir"], ignore_errors=True)
        for t in (tr, tr2):
            for slot in t.slots:
                slot.pipe.shutdown()

    # 5. the unfused path: each partition's plane fetch launches cache_gather
    unfused = [a for a in MULTIPART_ARGS if a != "--fused-gather-agg"]
    unfused[unfused.index("--steps") + 1] = "4"
    urep, ulaunch, uwall = _run_multipart(torch, unfused, stamp)
    utr = urep["trainer"]
    try:
        dispatches = sum(s.pipe.plane.gather_dispatches for s in utr.slots)
        inputs = [s.halo_stats.inputs for s in utr.slots]
        uwant = {"cache_gather": dispatches, "gather_aggregate": 0,
                 "neighbor_agg": 0, "neighbor_agg_backward": 0,
                 "flash_attention": 0, "reservoir_topm": 0}
        print(f"[multipart] unfused, {urep['report'].steps_run} global "
              f"steps: launches {ulaunch} (expected {uwant}: one "
              f"cache_gather per {4096}-row chunk of each plane fetch, "
              f"{inputs} input rows per partition); run_gnn {uwall:.2f} s  "
              f"[{stamp}]", flush=True)
        if not (urep["report"].steps_run == 4 and ulaunch == uwant
                and dispatches >= 2 * 4):
            fail(f"unfused multi-partition launches {ulaunch}, expected "
                 f"{uwant}")
    finally:
        shutil.rmtree(urep["ckpt_dir"], ignore_errors=True)
        for t in (utr, urep["restored"]):
            for slot in t.slots:
                slot.pipe.shutdown()
    return {"fused": launches, "unfused": ulaunch, "ref": ref}


@contextlib.contextmanager
def _timed(torch, cls, names, log: list):
    """Wrap each method ``names`` of ``cls`` so that a call appends (name,
    host seconds up to a synchronised card, the instance, the arguments) to
    ``log``; the methods are restored on exit."""
    saved = {n: cls.__dict__[n] for n in names}

    def wrap(name, fn):
        def timed(self, *a, **k):
            t0 = time.perf_counter()
            out = fn(self, *a, **k)
            torch.cuda.synchronize()
            log.append((name, time.perf_counter() - t0, self, a))
            return out
        return timed
    for n, fn in saved.items():
        setattr(cls, n, wrap(n, fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(cls, n, fn)


def _clone(torch, tree):
    """A copy of a trainer's ``state_dict()`` whose tensors are new."""
    from repro_torch.models.params import tree_map
    return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor)
                    else x, tree)


def _state_equal(torch, tr, state) -> bool:
    from repro_torch.models.params import leaves
    mine, want = leaves(tr.state_dict()), leaves(state)
    return len(mine) == len(want) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(mine, want))


def phase_autotune(torch, stamp: str) -> dict:
    """The online auto-tuner at full width (phase 10): (a) the CLI path,
    (b) a scripted plane flip, restarts and a halo swap on one controller.
    Returns the launch counts of (a)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.configs.gnn import AutotuneConfig
    from repro_torch.core.a3gnn import A3GNNTrainer
    from repro_torch.core.autotune.controller import (AutotuneController,
                                                      episode_space)
    from repro_torch.core.autotune.ppo import PPOAgent, PPOConfig
    from repro_torch.core.feature_plane import (DeviceFeaturePlane,
                                                HostFeaturePlane)
    from repro_torch.core.multipart import MultiPartitionTrainer
    from repro_torch.core.sampling import NeighborSampler, seed_loader
    from repro_torch.graph.batch import generate_batch
    from repro_torch.launch.train import build_parser, run_gnn
    from repro_torch.models.params import leaves
    from repro_torch.train.checkpoint import TrainerCheckpointMixin

    # (a) the CLI path, every controller phase timed on the host
    args = build_parser().parse_args(AUTOTUNE_ARGS)
    log: list = []
    buf = io.StringIO()
    with _timed(torch, AutotuneController,
                ("propose", "_apply_config", "measure"), log):
        counts = _zero_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            out = run_gnn(args)
        torch.cuda.synchronize()
        launches = counts()
        wall = time.perf_counter() - t0
    for line in buf.getvalue().splitlines():
        print(f"{line}  [{stamp}]", flush=True)
    rep, tr = out["report"], out["trainer"]
    ctrl = log[-1][2]
    # warm-up (AutotuneConfig.warmup_steps, seq) and every episode's steps
    # are fused steps: 1 gather_aggregate, (layers - 1) neighbor_agg
    # forwards and as many backwards each; evaluate() runs the unfused
    # forward (plain torch) and fused_inputs no cache_gather
    steps = AutotuneConfig().warmup_steps + AUTOTUNE_EPISODES * AUTOTUNE_STEPS
    hops = tr.cfg.num_layers - 1
    want = {"cache_gather": 0, "gather_aggregate": steps,
            "neighbor_agg": hops * steps, "neighbor_agg_backward": hops * steps,
            "flash_attention": 0, "reservoir_topm": 0}
    print(f"[autotune] {ARCH} fused, full width: {len(rep.episodes)} "
          f"episodes x {AUTOTUNE_STEPS} steps after {ctrl.acfg.warmup_steps} "
          f"warm-up steps; launches {launches} (expected {want}); run_gnn "
          f"incl. the trainer build {wall:.2f} s  [{stamp}]", flush=True)
    if launches != want:
        fail(f"autotune launches {launches}, expected {want}")
    if [ep.steps for ep in rep.episodes] != [AUTOTUNE_STEPS] * \
            AUTOTUNE_EPISODES:
        fail(f"autotune episodes ran {[ep.steps for ep in rep.episodes]} "
             f"steps")
    pending = {"propose": 0.0, "_apply_config": 0.0}
    for name, secs, _, a in log:
        if name != "measure":
            pending[name] += secs
            continue
        ep = rep.episodes[a[0]]
        m, pred = ep.metrics, ep.predicted
        print(f"[autotune] episode {ep.index}: config {ep.config}; measured "
              f"throughput {m['throughput']} steps/s, memory {m['memory']} B, "
              f"accuracy {m['accuracy']}; hit rate {ep.cache_hit_rate}; "
              f"surrogate predicted {pred}; host seconds: propose "
              f"{pending['propose']}, reconfigure {pending['_apply_config']}, "
              f"measure {secs}  [{stamp}]", flush=True)
        if not all(map(math.isfinite, m.values())):
            fail(f"episode {ep.index}: metrics {m}")
        pending = {"propose": 0.0, "_apply_config": 0.0}
    print(f"[autotune] best episode {rep.best.index} (feasible "
          f"{rep.best_feasible}); reconfigure to it {pending['_apply_config']}"
          f" s; trainer left on {tr.cfg.parallel_mode}, workers "
          f"{tr.cfg.workers}, Θ {tr.cfg.cache_volume_mb} MB  [{stamp}]",
          flush=True)
    agent = ctrl.agent
    on_card = all(p.is_cuda for p in agent.parameters())
    if not (on_card and all(p.is_cuda for p in leaves(tr.params))):
        fail("the PPO agent or the trainer is not on cuda")

    # one PPO update on the card against the same update on the CPU, from
    # one seed and one rollout against the run's surrogate
    def agent_on(dev):
        return PPOAgent(episode_space(ctrl.acfg), ctrl._surrogate_eval,
                        agent.w, ctrl.feasible,
                        PPOConfig(horizon=ctrl.acfg.ppo_horizon, seed=0),
                        device=dev)
    host, card = agent_on("cpu"), agent_on("cuda")
    same_init = all(torch.equal(x.cpu(), y) for x, y in
                    zip(card.parameters(), host.parameters()))
    s, a, logp, r, v = host._rollout(
        np.random.default_rng(0).random(host.space.dim))
    adv, ret = host._gae(r, v)
    for ag in (host, card):
        ag._update((s, a, logp, ret, adv))
    ppo_err = max(float((x.detach().cpu() - y.detach()).abs().max())
                  for x, y in zip(card.parameters(), host.parameters()))
    n_ppo = sum(p.numel() for p in agent.parameters())
    print(f"[check] PPO agent on {agent.device} ({n_ppo} parameters); one "
          f"update on the card vs the "
          f"CPU from one seed (initial weights equal={same_init}): max abs "
          f"diff {ppo_err:.2e} (tolerance 1e-5)", flush=True)
    if not (same_init and ppo_err <= 1e-5):
        fail("the PPO update on the card differs from the CPU")

    # (b) a scripted run on one controller at full width
    cfg = get_config(ARCH).replace(sampling_device="device",
                                   fused_gather_agg=True)
    tb = A3GNNTrainer(tr.full_graph, cfg, seed=0, device="cuda")
    restart_dir = tempfile.mkdtemp(prefix="chip_smoke_restart_")
    ctrl = AutotuneController(tb, tb.make_pipeline(), AutotuneConfig(
        steps_per_episode=4, warmup_steps=0, tune_sampling_device=True,
        max_partitions=2, max_halo_budget=4096, restart_dir=restart_dir,
        seed=0))
    try:
        # 1. device -> cpu -> device planes over one cache: one fused step
        # from one state and batch, the table path against the sideband
        seeds = next(iter(seed_loader(tb.graph, cfg.batch_size, 0)))
        mb = generate_batch(NeighborSampler(tb.graph, cfg.fanout,
                                            weight_fn=tb.weight_fn,
                                            seed=0).sample(seeds),
                            ctrl.pipe.plane, tb.graph, fused=True)
        if mb.features is not None:
            fail("the fused batch carries features")
        state = _clone(torch, tb.state_dict())
        flips = []
        counts = _zero_counts()
        for dev, kind in (("device", DeviceFeaturePlane),
                          ("cpu", HostFeaturePlane),
                          ("device", DeviceFeaturePlane)):
            t0 = time.perf_counter()
            ctrl._apply_config({"sampling_device": dev})
            t_swap = time.perf_counter() - t0
            plane = ctrl.pipe.plane
            if not (isinstance(plane, kind) and plane.cache is tb.cache):
                fail(f"sampling_device={dev}: plane {plane}")
            tb.load_state_dict(_clone(torch, state))
            loss, _ = tb._train_fn(mb, plane)
            flips.append((dev, loss, t_swap, [p.clone() for p in
                                              leaves(tb.params)]))
        torch.cuda.synchronize()
        fl = counts()
        same = all(f[1] == flips[0][1] and all(
            torch.equal(x, y) for x, y in zip(f[3], flips[0][3]))
            for f in flips)
        print(f"[check] plane flip device -> cpu -> device, one cache, "
              f"{len(mb.input_ids)} input ids: fused-step losses "
              f"{[f[1] for f in flips]}, updated params bit-equal={same}; "
              f"swap host seconds {[round(f[2], 6) for f in flips]}; "
              f"launches {fl}  [{stamp}]", flush=True)
        if not (same and fl["gather_aggregate"] == 3):
            fail("the fused step differs between the device and cpu planes")
        tb.load_state_dict(state)

        # 2. restart to 2 partitions with a 4096-row halo budget
        tlog: list = []
        before = _clone(torch, tb.state_dict())
        with _timed(torch, TrainerCheckpointMixin, ("save", "restore"),
                    tlog):
            t0 = time.perf_counter()
            ctrl._apply_config({"partitions": 2, "halo_budget": 4096})
            t_restart = time.perf_counter() - t0
        mp = ctrl.tr
        secs = {name: t for name, t, _, _ in tlog}
        carried = _state_equal(torch, mp, before)
        print(f"[autotune] restart 1 -> 2 partitions, halo budget 4096: "
              f"{t_restart} s host, of which checkpoint write {secs['save']}"
              f", planning {mp.plan_seconds}, restore {secs['restore']}; "
              f"params and opt_state torch.equal={carried}  [{stamp}]",
              flush=True)
        if not (isinstance(mp, MultiPartitionTrainer) and mp.plan.parts == 2
                and mp.plan.halo_budget == 4096 and carried
                and mp.device.type == "cuda" and ctrl.restarts == 1):
            fail("the restart to 2 partitions did not carry the state over")
        counts = _zero_counts()
        ep = ctrl.measure(1, ctrl._current_config())
        torch.cuda.synchronize()
        got = counts()
        ewant = {"cache_gather": 0, "gather_aggregate": 8,
                 "neighbor_agg": 8 * hops, "neighbor_agg_backward": 8 * hops,
                 "flash_attention": 0, "reservoir_topm": 0}
        print(f"[autotune] episode at 2 partitions, 4 global steps: "
              f"{ep.steps} partition steps, metrics {ep.metrics}, hit rate "
              f"{ep.cache_hit_rate}, halo hit rate {mp.halo_hit_rate}; "
              f"launches {got} (expected {ewant})  [{stamp}]", flush=True)
        if not (ep.steps == 8 and got == ewant
                and all(map(math.isfinite, ep.metrics.values()))):
            fail(f"the 2-partition episode: {ep.steps} steps, {got}")

        # 3. the halo budget swapped live to 0: no restart
        before = _clone(torch, mp.state_dict())
        t0 = time.perf_counter()
        ctrl._apply_config({"halo_budget": 0})
        t_halo = time.perf_counter() - t0
        ok = (ctrl.tr is mp and mp.plan.halo_budget == 0
              and ctrl.restarts == 1 and _state_equal(torch, mp, before))
        print(f"[autotune] halo budget 4096 -> 0 live: {t_halo} s host, the "
              f"same trainer, state carried={ok}  [{stamp}]", flush=True)
        if not ok:
            fail("the live halo swap rebuilt the trainer or lost its state")

        # 4. restart back to 1 partition
        before = _clone(torch, mp.state_dict())
        t0 = time.perf_counter()
        ctrl._apply_config({"partitions": 1})
        t_back = time.perf_counter() - t0
        back = ctrl.tr
        carried = _state_equal(torch, back, before)
        counts = _zero_counts()
        one = ctrl.pipe.run(max_steps=1)
        torch.cuda.synchronize()
        got = counts()
        print(f"[autotune] restart 2 -> 1 partition: {t_back} s host; params "
              f"and opt_state torch.equal={carried}; one step after: loss "
              f"{one.losses}, launches {got}  [{stamp}]", flush=True)
        if not (isinstance(back, A3GNNTrainer) and carried
                and ctrl.restarts == 2 and back.device.type == "cuda"
                and got["gather_aggregate"] == 1
                and all(map(math.isfinite, one.losses))):
            fail("the restart back to 1 partition did not carry the state")
    finally:
        ctrl.pipe.shutdown()
        shutil.rmtree(restart_dir, ignore_errors=True)
    return launches


FABRIC_PARTS = ("train", "warm", "load", "refresh", "burst")


@contextlib.contextmanager
def _fabric_probe(watch_rid: int):
    """Wrap ``ServingFabric.step`` and the four stages of an engine step
    (``NeighborSampler.sample``, the plane fetch in ``generate_batch``, the
    padding in ``inference_arrays``, ``GNNInferenceEngine._fwd``), so that
    each fabric step appends its wall seconds, the host seconds of each
    stage summed over the engines it stepped, and their count to ``steps``.
    The fetch and the forward each end in a copy to the host, so the card's
    work is inside the stage that issued it; ``t0`` is the step's start.
    A forward whose engine holds request ``watch_rid`` appends (engine,
    params, features, index arrays, logits, the request's row) to
    ``seen``.  Restored on exit."""
    from repro_torch.core.sampling import NeighborSampler
    from repro_torch.serve import gnn_engine
    from repro_torch.serve.fabric import ServingFabric
    steps, seen, cur = [], [], {}
    saved = [(NeighborSampler, "sample"), (gnn_engine, "generate_batch"),
             (gnn_engine, "inference_arrays"),
             (gnn_engine.GNNInferenceEngine, "_fwd"), (ServingFabric, "step")]
    orig = [getattr(owner, name) for owner, name in saved]

    def timed(stage, fn):
        def wrap(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            cur[stage] = cur.get(stage, 0.0) + time.perf_counter() - t0
            return out
        return wrap

    fwd = timed("forward", orig[3])

    def forward(self, params, feats, idxs):
        out = fwd(self, params, feats, idxs)
        cur["engines"] = cur.get("engines", 0) + 1
        rids = [self.running[s].rid for s in sorted(self.running)]
        if watch_rid in rids:
            seen.append((self, params, feats.copy(),
                         [i.copy() for i in idxs], out.copy(),
                         rids.index(watch_rid)))
        return out

    def step(self):
        cur.clear()
        t0 = time.perf_counter()
        n = orig[4](self)
        steps.append({"t0": t0, "wall": time.perf_counter() - t0, **cur})
        return n

    for (owner, name), fn in zip(saved, (
            timed("sample", orig[0]), timed("fetch", orig[1]),
            timed("pad", orig[2]), forward, step)):
        setattr(owner, name, fn)
    try:
        yield steps, seen
    finally:
        for (owner, name), fn in zip(saved, orig):
            setattr(owner, name, fn)


def phase_fabric(torch, stamp: str) -> dict:
    """The partition-routed serving fabric at full width (phase 11); returns
    the ``cache_gather`` launches of each part of (a) and of the chaos run,
    and every kernel's launches over (a)."""
    import numpy as np

    from repro_torch.launch.serve import build_parser, run_gnn_serve
    from repro_torch.models.params import leaves, tree_map
    from repro_torch.serve.fabric import ServingFabric
    from repro_torch.serve.gnn_engine import GNNInferenceEngine, GNNRequest
    from repro_torch.serve.transport import (FaultSpec, VirtualClock,
                                             sim_host_factory)

    # (a) the CLI path
    args = build_parser().parse_args(FABRIC_ARGS)
    buf = io.StringIO()
    counts = _zero_counts()
    t0 = time.perf_counter()
    with _fabric_probe(args.queries) as (steps, seen), \
            contextlib.redirect_stdout(buf):
        rep = run_gnn_serve(args)
    torch.cuda.synchronize()
    total = counts()
    wall = time.perf_counter() - t0
    for line in buf.getvalue().splitlines():
        print(f"{line}  [{stamp}]", flush=True)
    tr, fab = rep["trainer"], rep["fabric"]
    plan, cfg, parts = tr.plan, tr.cfg, tr.plan.parts
    launches, chunks = rep["launches"], rep["dispatches"]
    print(f"[fabric] plan: sizes {[len(ns) for ns in plan.node_sets]}, edge "
          f"locality {plan.edge_locality(tr.full_graph)}, halo rows "
          f"{plan.halo_rows}; planning {tr.plan_seconds} s host; "
          f"{parts}×{fab.replicas} replicas, batch {fab.engine_batch}; "
          f"launches of the whole run {total}; per part: cache_gather "
          f"{launches}, gather chunks the planes issued {chunks}, host "
          f"seconds {rep['seconds']}; run_gnn_serve {wall:.2f} s  "
          f"[{stamp}]", flush=True)
    others = {k: v for k, v in total.items() if k != "cache_gather"}
    if any(others.values()):
        fail(f"the fabric run launched other kernels: {others}")
    if sum(launches.values()) != total["cache_gather"]:
        fail(f"cache_gather launches by part {launches} do not sum to the "
             f"run's {total['cache_gather']}")
    for name in FABRIC_PARTS:
        if not (launches[name] == chunks[name] > 0):
            fail(f"{name}: cache_gather launches {launches[name]}, gather "
                 f"chunks {chunks[name]}")
    engines = fab.all_engines
    if not (all(e.device.type == "cuda" for e in engines)
            and all(p.is_cuda for p in leaves(tr.params))
            and all(part[0].plane.device.type == "cuda"
                    and all(e.plane is part[0].plane for e in part)
                    for part in fab.engines)):
        fail("a replica, its plane or the parameters are not on cuda")

    # the load: whole, finite, routed to the owner, conserved
    served, nodes, ncls = rep["served"], rep["nodes"], cfg.num_classes
    owners = plan.owner_of(nodes)
    if not (len(served) == args.queries
            and all(r.status == "done" for r in served)
            and all(r.logits.shape == (ncls,)
                    and bool(np.isfinite(r.logits).all()) for r in served)):
        fail(f"{sum(r.status == 'done' for r in served)}/{args.queries} "
             f"queries done with finite logits")
    if not (all(r.partition == owners[r.rid]
                and 0 <= r.replica < fab.replicas for r in served)
            and rep["per_partition"] == np.bincount(
                owners, minlength=parts).tolist()):
        fail(f"routing: per partition {rep['per_partition']}, owners "
             f"{np.bincount(owners, minlength=parts).tolist()}")
    # the replicas' warm-up requests were stepped on the engines directly,
    # never offered to the fabric: they retire in ``done`` alone
    audit, warm_served = fab.audit(), rep["warm_served"]
    if not (audit["pending"] == audit["inflight"] == 0
            and audit["offered"] + warm_served
            == audit["done"] + audit["shed"] + audit["timed_out"]):
        fail(f"audit does not balance: {audit}, {warm_served} warm-up "
             f"requests")
    per_replica = {f"{p}/{r}": st.completed for (p, r), st in
                   sorted(fab.replica_state.items())}
    s = rep["stats"]
    load_steps = steps[:s["fabric_steps"]]
    # a replica's engine re-stamps ``t_submit`` when the request reaches
    # it, so the fabric's percentiles run from dispatch; the whole load was
    # queued before its first fabric step, which bounds the queue wait
    e2e = np.array([r.t_done - load_steps[0]["t0"] for r in served]) * 1e3
    print(f"[fabric] load: {s['completed']} queries at "
          f"{s['queries_per_s']} q/s, p50 {s['p50_ms']} ms, p99 "
          f"{s['p99_ms']} ms from dispatch; from the first fabric step p50 "
          f"{float(np.percentile(e2e, 50))} ms, p99 "
          f"{float(np.percentile(e2e, 99))} ms; {s['fabric_steps']} fabric "
          f"steps; per "
          f"partition {rep['per_partition']}; per replica over the run "
          f"{per_replica}; audit {audit} ({warm_served} warm-up requests "
          f"in done)  [{stamp}]", flush=True)
    full = [st for st in load_steps if st.get("engines") == len(engines)]
    pick = full or load_steps
    split = ", ".join(
        f"{k} {float(np.mean([st.get(k, 0.0) for st in pick])) * 1e3:.3f}"
        for k in ("sample", "fetch", "pad", "forward"))
    print(f"[breakdown] fabric step of the load (mean of {len(pick)} steps "
          f"with {'every' if full else 'any'} replica busy): wall "
          f"{float(np.mean([st['wall'] for st in pick])) * 1e3:.3f} ms = "
          f"its engines' steps, summed: {split} ms; engines stepped "
          f"{[st.get('engines', 0) for st in load_steps]}; fabric-step "
          f"walls {[round(st['wall'] * 1e3, 2) for st in load_steps]} ms  "
          f"[{stamp}]", flush=True)

    # the refresh: stale until the hand-off, then the trainer's new tree
    rq, warm = rep["requery"], rep["warm_params"]
    if not (all(h is warm for h in rep["held_before_refresh"])
            and warm is not tr.params
            and all(e.params is tr.params for e in engines)):
        fail("before refresh_weights every replica must hold the warm tree, "
             "after it the trainer's")
    if not (rq.rid == args.queries and rq.status == "done"
            and len(seen) == 1 and seen[0][1] is tr.params):
        fail(f"the re-query: {rq.status}, {len(seen)} forwards seen")
    eng, _, feats, idxs, logits, row = seen[0]
    fresh = GNNInferenceEngine(eng.graph, cfg, tr.params, plane=eng.plane,
                               batch=eng.batch, node_map=eng.node_map,
                               device=eng.device)
    again = fresh._fwd(tr.params, feats, idxs)[row]
    stale = fresh._fwd(warm, feats, idxs)[row]
    print(f"[check] re-query rid {rq.rid} on replica "
          f"{rq.partition}/{rq.replica}: logits bit-equal to a fresh "
          f"engine's forward with the trainer's new tree on the same batch="
          f"{bool(np.array_equal(again, rq.logits))} (and to the probe's "
          f"{bool(np.array_equal(logits[row], rq.logits))}); the warm tree "
          f"on that batch differs by {float(abs(stale - rq.logits).max())}",
          flush=True)
    if not (np.array_equal(again, rq.logits)
            and np.array_equal(logits[row], rq.logits)
            and not np.array_equal(stale, rq.logits)):
        fail("the re-query is not the trainer's new tree on its batch")

    # the burst: explicit degradation
    b = rep["burst"]
    print(f"[fabric] burst: offered {b['offered']}, served {b['completed']}, "
          f"shed {b['shed']} (fraction {b['shed_fraction']}), deferrals "
          f"{b['deferrals']}, {b['fabric_steps']} fabric steps in "
          f"{b['seconds']} s at target {fab.slo.slo_p99_ms} ms; served p50 "
          f"{b['p50_ms']} ms p99 {b['p99_ms']} ms  [{stamp}]", flush=True)
    if not (b["shed"] > 0 and b["completed"] > 0):
        fail(f"the burst must shed and serve: {b}")

    # (b) chaos on the card: SimHost replicas on a virtual clock, one killed
    t0 = time.perf_counter()
    plan_h = plan.with_halo_budget(tr.full_graph, FABRIC_HALO)
    t_plan = time.perf_counter() - t0
    rng = np.random.default_rng(tr.seed)
    chaos_nodes = rng.choice(np.flatnonzero(tr.full_graph.test_mask),
                             CHAOS_QUERIES, replace=False)
    host_params = tree_map(lambda t: t.cpu(), tr.params)

    def chaos(device, params):
        fab_c = ServingFabric.from_plan(
            tr.full_graph, plan_h, cfg, params, batch=4, replicas=2, seed=0,
            transport_factory=sim_host_factory(
                faults={(0, 0): FaultSpec(added_latency_ms=2,
                                          down_after_responses=3)},
                base=FaultSpec(added_latency_ms=2), seed=0),
            clock=VirtualClock(tick_s=1e-3), timeout_ms=8,
            record_trace=True, device=device)
        d0 = sum(p[0].plane.gather_dispatches for p in fab_c.engines)
        counts = _zero_counts()
        t0 = time.perf_counter()
        for i in range(0, len(chaos_nodes), 4):
            for rid in range(i, min(i + 4, len(chaos_nodes))):
                fab_c.submit(GNNRequest(rid=rid, node=int(chaos_nodes[rid])))
            fab_c.step()
        fab_c.drain()
        if device == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        return (fab_c, counts(), secs,
                sum(p[0].plane.gather_dispatches for p in fab_c.engines) - d0)

    runs = [chaos("cuda", tr.params), chaos("cuda", tr.params),
            chaos("cpu", host_params)]
    (c1, l1, s1, d1), (c2, l2, _, _), (c3, _, s3, _) = runs
    a1 = c1.audit()
    st00 = c1.replica_state[(0, 0)]
    done = [{r.rid: r for r in c.completed} for c, _, _, _ in runs]
    logits_eq = done[0].keys() == done[1].keys() and all(
        np.array_equal(r.logits, done[1][k].logits)
        for k, r in done[0].items())
    host_trace = [e[:4] for e in c3.request_trace]
    cpu_diff = max((float(abs(r.logits - done[2][k].logits).max())
                    for k, r in done[0].items()), default=0.0)
    preds_eq = all(r.pred == done[2][k].pred for k, r in done[0].items())
    print(f"[chaos] {CHAOS_QUERIES} queries 4 a step over SimHost replicas "
          f"on a virtual clock (2 ms a response, timeout 8 ms, replica 0/0 "
          f"killed after its 3rd response), halo budget {FABRIC_HALO} "
          f"(re-budgeted in {t_plan:.3f} s): audit {a1}; {c1.fstats.asdict()}"
          f"; 0/0 {st00.state}, timeouts {st00.timeouts}; launches {l1} "
          f"(gather chunks {d1}); {s1:.3f} s on the card, {s3:.3f} s on the "
          f"CPU  [{stamp}]", flush=True)
    print(f"[check] chaos: trace identical run to run="
          f"{c1.request_trace == c2.request_trace}, logits bit-equal="
          f"{logits_eq}; card vs CPU: (rid, partition, replica, status) "
          f"identical={[e[:4] for e in c1.request_trace] == host_trace}, "
          f"preds equal={preds_eq}, logits max_abs_diff={cpu_diff} "
          f"(tolerance 1e-4)", flush=True)
    if not (a1["pending"] == a1["inflight"] == 0 and a1["offered"]
            == a1["done"] + a1["shed"] + a1["timed_out"] == CHAOS_QUERIES):
        fail(f"chaos audit does not balance: {a1}")
    if not (st00.state == "down" and c1.fstats.timeouts > 0
            and c1.fstats.retries > 0):
        fail(f"chaos: replica 0/0 {st00.state}, {c1.fstats.asdict()}")
    if not (c1.request_trace == c2.request_trace and logits_eq
            and len(c1.request_trace) == CHAOS_QUERIES):
        fail("chaos: two runs on the card differ")
    if not ([e[:4] for e in c1.request_trace] == host_trace and preds_eq
            and cpu_diff <= 1e-4):
        fail("chaos: the card and the CPU differ")
    if not (l1["cache_gather"] == d1 > 0
            and sum(l1.values()) == l1["cache_gather"]):
        fail(f"chaos launches {l1}, gather chunks {d1}")

    # the halo rows in each card plane equal the owner's
    owner_local = plan_h.local_ids()
    halo_ok = []
    for p, (ns, hs) in enumerate(zip(plan_h.node_sets, plan_h.halo_sets)):
        plane = c1.engines[p][0].plane
        local = np.arange(len(ns), len(ns) + len(hs))
        resident = int(plane.cache.is_cached(local).sum())
        want = np.stack([plan_h.subgraphs[q].features[owner_local[v]]
                         for q, v in zip(plan_h.owner[hs], hs)])
        slots = torch.from_numpy(plane.cache.device_map[local]).long()
        table = plane._dev_table[slots.to(plane.device)].cpu().numpy()
        halo_ok.append((len(hs), resident,
                        bool(np.array_equal(plane.fetch(local), want)),
                        bool(np.array_equal(table, want))))
    print(f"[check] chaos fabric halo rows (rows, resident on the card, "
          f"fetched bit-equal to the owner's, card table bit-equal) per "
          f"partition: {halo_ok}", flush=True)
    if not all(n == res > 0 and ok and tab for n, res, ok, tab in halo_ok):
        fail(f"halo rows in the fabric's device planes: {halo_ok}")
    for slot in tr.slots:
        slot.pipe.shutdown()
    return {"parts": launches, "chaos": l1["cache_gather"], "total": total}


# phase 12: (family, arch, flash_attention launches a (2, 4096) prefill)
FAMILIES = (("moe", "qwen2-moe-a2.7b", 24), ("hybrid", "zamba2-7b", 13),
            ("ssm", "mamba2-1.3b", 0))
FAMILY_SERVE_ARGS = ["--requests", "4", "--batch", "4", "--max-len", "64",
                     "--prompt-len", "8", "--max-new", "8"]
DECODE_STEPS = 30      # the decode step's time is the median of these


def _family_prefill(torch, family: str, model, cparams, want_flash: int,
                    stamp: str, batch=None) -> dict:
    """A bf16 block prefill of ``batch`` (default: tokens of PREFILL_SHAPE):
    one warm-up, in which every flash_attention call is held against the
    plain version on its own inputs (``bf16_excess``), then one counted run
    (counts zeroed just before, read just after); the two outputs compared
    bit for bit (an MoE must be bit-equal: its sum back over the experts is
    a gather in a fixed order); one profiled.  Returns the launches,
    seconds and tokens/s (an encoder's frames counted with the tokens)."""
    from repro_torch.kernels.flash_attention.ref import bf16_excess
    from repro_torch.models import layers
    cfg = model.cfg
    dev = torch.device("cuda")
    if batch is None:
        gen = torch.Generator(device=dev).manual_seed(1)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, PREFILL_SHAPE,
                                         generator=gen, device=dev)}
    B, S = batch["tokens"].shape
    frames = (batch["audio_embeds"].shape[0] * batch["audio_embeds"].shape[1]
              if "audio_embeds" in batch else 0)
    what = f"tokens ({B}, {S})" + (f" and {frames} frames" if frames else "")
    kernel, excess = layers.flash_attention, []

    def in_situ(q, k, v, causal=True):
        out = kernel(q, k, v, causal)
        excess.append(max(bf16_excess(out, q, k, v, causal)))
        return out

    with torch.no_grad():
        layers.flash_attention = in_situ
        try:
            first, caches1 = model.prefill(cparams, batch)    # warm-up
        finally:
            layers.flash_attention = kernel
        worst = max(excess, default=0.0)
        print(f"[check] {family} bf16 prefill of {what}: {len(excess)} "
              f"flash_attention calls, each against the plain version on "
              f"its own inputs, worst {worst:.3f} of the bf16 bound",
              flush=True)
        if len(excess) != want_flash or worst > 1:
            fail(f"{family} prefill: {len(excess)} flash_attention calls "
                 f"(expected {want_flash}), worst {worst} of the bf16 bound")
        torch.cuda.synchronize()
        counts = _zero_counts()
        t0 = time.perf_counter()
        logits, caches = model.prefill(cparams, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = counts()
    want = {"cache_gather": 0, "gather_aggregate": 0, "neighbor_agg": 0,
            "neighbor_agg_backward": 0, "flash_attention": want_flash,
            "reservoir_topm": 0}
    same = (torch.equal(first, logits)
            and all(torch.equal(caches1[k], caches[k]) for k in caches))
    n = B * S + frames
    print(f"[{family}] {cfg.name} prefill of {what} bf16: "
          f"{dt * 1e3:.1f} ms, {n / dt:.0f} tokens/s"
          + (" (frames and tokens)" if frames else "") + "; launches "
          f"{launches} (expected {want}); two prefills bit-equal: {same}; "
          f"caches {{{', '.join(f'{k}: {tuple(v.shape)}' for k, v in caches.items())}}}"
          f"  [{stamp}]", flush=True)
    if launches != want:
        fail(f"{family} prefill launches {launches}, expected {want}")
    if not (logits.shape == (B, cfg.vocab_size)
            and bool(torch.isfinite(logits).all())):
        fail(f"{family} prefill logits {tuple(logits.shape)} not finite or "
             f"misshapen")
    if family == "moe" and not same:
        fail("two MoE prefills on the card differ")
    del first, caches1, logits, caches
    with torch.no_grad():
        _profile(torch, lambda: model.prefill(cparams, batch), stamp,
                 f"{family}: one prefill of {what}")
    return {"launches": launches, "ms": dt * 1e3, "tokens_per_s": n / dt}


def _family_serve(torch, family: str, args, stamp: str, params=None):
    """``run_lm_serve`` (with ``params``, or the CLI path drawing its own),
    counts zeroed just before and read just after: every request served,
    every token in range, no kernel launched; then the decode step's time
    at batch ``args.batch`` with every slot at position max_len / 2.
    Returns (the engine, the stats, the launches, decode-step ms)."""
    from repro_torch.launch.serve import run_lm_serve
    buf = io.StringIO()
    counts = _zero_counts()
    with contextlib.redirect_stdout(buf):
        rep = run_lm_serve(args, params=params)
    torch.cuda.synchronize()
    launches = counts()
    for line in buf.getvalue().splitlines():
        print(f"[{family}] {line}  [{stamp}]", flush=True)
    eng, st = rep["engine"], rep["stats"]
    V = eng.cfg.vocab_size
    done = eng.completed
    if not (st["completed"] == args.requests == len(done)
            and all(r.status == "done" and len(r.out_tokens) == args.max_new
                    and all(0 <= t < V for t in r.out_tokens) for r in done)):
        fail(f"{family}: {st['completed']}/{args.requests} requests served")
    if any(launches.values()):
        fail(f"{family} serving launched {launches}: decode is plain torch")
    dev = eng.device
    step = {"token": torch.ones(args.batch, dtype=torch.int32, device=dev),
            "pos": torch.full((args.batch,), args.max_len // 2,
                              dtype=torch.int32, device=dev)}
    if eng.cfg.mrope_sections:     # each slot's position on all 3 streams
        step["positions"] = step["pos"][None, :, None].expand(
            3, args.batch, 1)
    times = []
    with torch.no_grad():
        for _ in range(DECODE_STEPS):
            t0 = time.perf_counter()
            lg, _ = eng.model.decode(eng._cparams, eng.kv.caches, step)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        if not bool(torch.isfinite(lg).all()):
            fail(f"{family} decode-step logits are not finite")
        busy = _profile(torch, lambda: eng.model.decode(
            eng._cparams, eng.kv.caches, step), stamp,
            f"{family}: one decode step at batch {args.batch}")
    times.sort()
    step_ms = times[len(times) // 2]
    print(f"[{family}] serving {args.requests} requests at batch "
          f"{args.batch}: {st['tokens']} tokens in {st['seconds']:.2f} s, "
          f"{st['tokens_per_s']:.1f} tokens/s; TTFT p50 "
          f"{st['ttft_p50_ms']:.1f} ms p99 {st['ttft_p99_ms']:.1f} ms; decode "
          f"step (batch {args.batch}, position {args.max_len // 2}) median "
          f"of {DECODE_STEPS} {step_ms:.2f} ms (min {times[0]:.2f}, max "
          f"{times[-1]:.2f}), device busy {busy:.3f} ms, idle share "
          f"{1 - busy / step_ms:.1%}; launches {launches}  [{stamp}]",
          flush=True)
    return eng, st, launches, step_ms


# the f32 checks of the whole prefill run a seeded stack at a cut depth
# where it is chaotic: 1e-6 relative noise on its input moves the logits
# of the 81-layer zamba2-7b by about a quarter of their largest, of the
# 28-layer qwen2-vl-2b by all of it (2e-4 at 3 layers) and of the 24 + 24-
# layer whisper-medium by more (1e-4 at 1 + 1), on the H100 (PERF.md), so
# no two f32 summation orders agree to LOGITS_REL_TOL there.  The probe is
# printed at full depth and at the cut.  At full depth each attention call
# is held against the plain version on its own inputs.
F32_CHECK_LAYERS = {"hybrid": 12, "vlm": 3, "encdec": 1}
# the stacked layer trees a cut takes (default: "layers")
LAYER_STACKS = {"hybrid": ("mamba",), "encdec": ("encoder", "decoder")}
CHAOS_NOISE = 1e-6     # relative noise on the input of the chaos probe


def cut_depth(family: str, cfg, params, n: int):
    """The config and parameters at n layers (the encoder-decoder: n
    encoder and n decoder layers), as views of the full stacks."""
    from repro_torch.models.params import tree_map
    stacks = {k: tree_map(lambda a: a[:n], params[k])
              for k in LAYER_STACKS.get(family, ("layers",))}
    more = {"encoder_layers": n} if family == "encdec" else {}
    return cfg.replace(num_layers=n, **more), {**params, **stacks}


def prefill_with(torch, cfg, params, batch, attend):
    """The block prefill's logits with ``layers.flash_attention`` swapped
    for ``attend``."""
    from repro_torch.models import layers
    from repro_torch.models.api import build
    kernel = layers.flash_attention
    layers.flash_attention = attend
    try:
        with torch.no_grad():
            return build(cfg).prefill(params, batch)[0]
    finally:
        layers.flash_attention = kernel


def _noisy(torch, x, seed: int):
    gen = torch.Generator(device=x.device).manual_seed(seed)
    return x * (1 + CHAOS_NOISE * torch.randn(x.shape, generator=gen,
                                               device=x.device))


def f32_inputs(torch, family: str, cfg):
    """The f32 checks' inputs: a 64-token prompt (numpy), its prefill batch
    (the VLM's text-only, its positions ``arange`` on all three streams, as
    the engine feeds them; whisper's over 1500 audio frames N(0, 1)) and
    the chaos probe's perturbation, ``noisy(params, batch) -> (params,
    batch)``: CHAOS_NOISE relative noise on the audio embeddings, or on the
    embedding table."""
    import numpy as np
    dev = torch.device("cuda")
    prompt = np.random.default_rng(1).integers(1, cfg.vocab_size, 64
                                               ).astype(np.int32)
    batch = {"tokens": torch.from_numpy(prompt)[None].to(dev)}
    if family == "encdec":
        gen = torch.Generator(device=dev).manual_seed(2)
        batch["audio_embeds"] = torch.randn(
            (1, cfg.encoder_seq, cfg.d_model), generator=gen, device=dev)

        def noisy(p, b):
            return p, {**b, "audio_embeds": _noisy(torch, b["audio_embeds"],
                                                   3)}
        return prompt, batch, noisy
    if cfg.mrope_sections:
        batch["positions"] = torch.arange(64, device=dev)[None, None].expand(
            3, 1, 64)

    def noisy(p, b):
        return {**p, "embed": {**p["embed"], "tok": _noisy(
            torch, p["embed"]["tok"], 3)}}, b
    return prompt, batch, noisy


def _f32_checks(torch, family: str, cfg, params):
    """The f32 prefill of ``f32_inputs``: every flash_attention call at
    full depth against the plain version on its own inputs; the chaos
    probe (the prefill with its input perturbed, both through the plain
    attention) at full depth and at ``F32_CHECK_LAYERS``; the prefill
    through the kernel against the one through the plain attention at
    that depth.  Returns the prompt, the cut config and parameters and
    the kernel's logits."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models import layers
    kernel, calls = layers.flash_attention, []
    prompt, batch, noisy = f32_inputs(torch, family, cfg)

    def in_situ(q, k, v, causal=True):
        out = kernel(q, k, v, causal)
        ref = flash_attention_ref(q, k, v, causal)
        calls.append(float((out - ref).abs().max() / ref.abs().max()))
        return out

    def depth(m):
        return f"{m} + {m}" if family == "encdec" else f"{m}"

    cfg32 = cfg.replace(compute_dtype="float32")
    prefill_with(torch, cfg32, params, batch, in_situ)
    worst = max(calls, default=0.0)
    print(f"[check] {family} f32 prefill of 64 tokens, "
          f"{depth(cfg.num_layers)} layers: "
          f"{len(calls)} flash_attention calls, each against the plain "
          f"version on its own inputs, worst max |diff| / max |out| "
          f"{worst:.2e} (tolerance {LOGITS_REL_TOL})", flush=True)
    if worst > LOGITS_REL_TOL:
        fail(f"a {family} flash_attention call differs from the plain "
             f"version on its own inputs")
    n = F32_CHECK_LAYERS.get(family, cfg.num_layers)
    for m in sorted({cfg.num_layers, n}, reverse=True):
        c, p = cut_depth(family, cfg32, params, m)
        base = prefill_with(torch, c, p, batch, flash_attention_ref)
        moved = prefill_with(torch, c, *noisy(p, batch), flash_attention_ref)
        print(f"[chaos] {family} f32 at {depth(m)} layers: {CHAOS_NOISE:g} "
              f"relative noise on the input moves the logits "
              f"{float((moved - base).abs().max() / base.abs().max()):.2e} of "
              f"their largest", flush=True)
    c, p = cut_depth(family, cfg32, params, n)
    got = prefill_with(torch, c, p, batch, kernel)
    want = prefill_with(torch, c, p, batch, flash_attention_ref)
    rel = float((got - want).abs().max() / want.abs().max())
    print(f"[check] {family} f32 prefill of 64 tokens, {depth(n)} layers: "
          f"kernel vs plain attention max |diff| / max |logit| = {rel:.2e} "
          f"(tolerance {LOGITS_REL_TOL})", flush=True)
    if not (rel <= LOGITS_REL_TOL and bool(torch.isfinite(got).all())):
        fail(f"the {family} f32 prefill through the kernel differs from "
             f"the plain one")
    return prompt, c, p, got


def _family_f32_checks(torch, family: str, cfg, params):
    """``_f32_checks``, then at the cut depth the engine's first greedy
    token against the prefill's argmax (for the SSM families the
    sequential recurrence against the chunked SSD)."""
    from repro_torch.serve.engine import Engine, Request
    prompt, c, p, got = _f32_checks(torch, family, cfg, params)
    eng = Engine(c, params=p, batch=1, max_len=128, device="cuda")
    eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=1))
    eng.run_to_completion()
    first, top = eng.completed[0].out_tokens[0], int(got[0].argmax())
    print(f"[check] {family} f32 engine at {c.num_layers} layers: first "
          f"token {first}, prefill argmax {top}", flush=True)
    if first != top:
        fail(f"the {family} engine's first token is not the prefill's "
             f"argmax")


def _encdec_f32_checks(torch, cfg, params):
    """whisper-medium: ``_f32_checks``, then the engine's greedy streams on
    the card against the same engine's on the CPU from the same f32
    masters (the engine never encodes: its cross caches are zero, so its
    first token is no prefill's argmax)."""
    import numpy as np

    from repro_torch.models.params import tree_map
    from repro_torch.serve.engine import Engine, Request
    _f32_checks(torch, "encdec", cfg, params)
    cfg32 = cfg.replace(compute_dtype="float32")
    streams, host = [], tree_map(lambda t: t.cpu(), params)
    for where, p in (("cuda", params), ("cpu", host)):
        eng = Engine(cfg32, params=p, batch=2, max_len=32, device=where)
        rng = np.random.default_rng(0)
        for rid in range(2):
            eng.submit(Request(rid=rid, prompt=rng.integers(
                1, cfg.vocab_size, 4).astype(np.int32), max_new_tokens=4))
        eng.run_to_completion()
        streams.append({r.rid: r.out_tokens for r in eng.completed})
    print(f"[check] encdec f32 engine at {cfg.encoder_layers} + "
          f"{cfg.num_layers} layers, 2 requests at batch 2: greedy streams "
          f"on the card {streams[0]}, on the CPU {streams[1]}", flush=True)
    if streams[0] != streams[1]:
        fail("the encdec engine's greedy streams differ between the card "
             "and the CPU")


def phase_families(torch, stamp: str) -> dict:
    """The MoE, hybrid and SSM LM families at full width (phase 12); returns
    each family's prefill and serving launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_parser
    from repro_torch.models.api import build, compute_params
    from repro_torch.models.params import init_params

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    out = {}
    for family, arch, want_flash in FAMILIES:
        cfg = get_config(arch)
        model = build(cfg)
        args = build_parser().parse_args(["--arch", arch,
                                          *FAMILY_SERVE_ARGS])
        t0 = time.perf_counter()
        if family == "moe":
            # f32 masters and a bf16 copy (~86 GB) do not fit the card:
            # the tree is drawn in bf16, as JAX's launcher draws at
            # param_dtype, and compute_params copies nothing
            params = init_params(model.decls,
                                 torch.Generator(device=dev).manual_seed(0),
                                 dev, dtype_override=torch.bfloat16)
            torch.cuda.synchronize()
            how = "drawn on the card in bf16"
            eng, st, serve, step_ms = None, None, None, None
        else:
            # the CLI path itself: the engine draws its f32 masters and
            # keeps a bf16 copy
            eng, st, serve, step_ms = _family_serve(torch, family, args,
                                                    stamp)
            params = eng.params
            how = "drawn by the engine (f32 masters, a bf16 copy)"
        print(f"[{family}] {arch} full width, {cfg.num_layers} layers: "
              f"{cfg.param_count()} parameters {how} in "
              f"{time.perf_counter() - t0:.1f} s; "
              f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated, "
              f"peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB  "
              f"[{stamp}]", flush=True)
        cparams = (eng._cparams if eng is not None
                   else compute_params(params, cfg))
        prefill = _family_prefill(torch, family, model, cparams, want_flash,
                                  stamp)
        del cparams
        if eng is None:
            eng, st, serve, step_ms = _family_serve(torch, family, args,
                                                    stamp, params=params)
            print(f"[check] {family}: the engine's first token is held "
                  f"against the JAX engine's greedy streams on the CPU "
                  f"(tests/test_torch_moe.py): a block prefill drops tokens "
                  f"past an expert's capacity, decode drops none", flush=True)
        else:
            _family_f32_checks(torch, family, cfg, params)
        out[family] = {"prefill": prefill["launches"], "serve": serve,
                       "prefill_ms": prefill["ms"],
                       "tokens_per_s": prefill["tokens_per_s"],
                       "decode_step_ms": step_ms,
                       "ttft_p50_ms": st["ttft_p50_ms"]}
        del eng, params, model
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    print(f"[families] phase 12 in {time.perf_counter() - t_phase:.1f} s  "
          f"[{stamp}]", flush=True)
    return out


# phase 13: (family, arch, flash_attention launches of its block prefill:
# whisper-medium 24 non-causal in the encoder and 24 causal in the decoder)
ENCDEC_VLM = (("encdec", "whisper-medium", 48), ("vlm", "qwen2-vl-2b", 28))
WHISPER_TOKENS = 448   # whisper's own decoder cap
VISION_SIDE = 32       # the 1024 stubbed patches as a 32 x 32 grid at t = 0


def grid_positions(torch, B: int, S: int, vp: int, side: int, dev):
    """(3, B, S) int32, as Qwen2-VL builds them: the vp patches a side x side
    grid at t = 0 (h = i // side, w = i % side), text token j >= vp at
    side + (j - vp) on all three streams."""
    i = torch.arange(S, device=dev)
    text = side + i - vp
    t = torch.where(i < vp, 0, text)
    h = torch.where(i < vp, i // side, text)
    w = torch.where(i < vp, i % side, text)
    return torch.stack([t, h, w])[:, None].expand(3, B, S).to(torch.int32)


def _encdec_vlm_batch(torch, family: str, cfg, dev) -> dict:
    """The bf16 block prefill's inputs: whisper's audio embeddings
    (B, 1500, D) N(0, 1) and tokens (B, 448); qwen2-vl's tokens (B, 4096),
    vision embeddings (B, 1024, D) N(0, 1) and grid positions."""
    from repro_torch.models.api import VISION_PREFIX
    B, S = PREFILL_SHAPE
    gen = torch.Generator(device=dev).manual_seed(1)
    if family == "encdec":
        return {"audio_embeds": torch.randn(
                    (B, cfg.encoder_seq, cfg.d_model), generator=gen,
                    device=dev),
                "tokens": torch.randint(0, cfg.vocab_size,
                                        (B, WHISPER_TOKENS), generator=gen,
                                        device=dev)}
    return {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                    device=dev),
            "vision_embeds": torch.randn((B, VISION_PREFIX, cfg.d_model),
                                         generator=gen, device=dev),
            "positions": grid_positions(torch, B, S, VISION_PREFIX,
                                        VISION_SIDE, dev)}


def phase_encdec_vlm(torch, stamp: str) -> dict:
    """The encoder-decoder and VLM families at full width (phase 13), each
    through the CLI path (``run_lm_serve``: f32 masters and a bf16 copy);
    returns each family's prefill and serving launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_parser

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    out = {}
    for family, arch, want_flash in ENCDEC_VLM:
        cfg = get_config(arch)
        args = build_parser().parse_args(["--arch", arch,
                                          *FAMILY_SERVE_ARGS])
        t0 = time.perf_counter()
        eng, st, serve, step_ms = _family_serve(torch, family, args, stamp)
        print(f"[{family}] {arch} full width, {cfg.encoder_layers} + "
              f"{cfg.num_layers} layers: {cfg.param_count()} parameters "
              f"drawn by the engine (f32 masters, a bf16 copy), served in "
              f"{time.perf_counter() - t0:.1f} s; "
              f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated, "
              f"peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB  "
              f"[{stamp}]", flush=True)
        batch = _encdec_vlm_batch(torch, family, cfg, dev)
        prefill = _family_prefill(torch, family, eng.model, eng._cparams,
                                  want_flash, stamp, batch)
        del batch
        if family == "encdec":
            _encdec_f32_checks(torch, cfg, eng.params)
        else:
            _family_f32_checks(torch, family, cfg, eng.params)
        out[family] = {"prefill": prefill["launches"], "serve": serve,
                       "prefill_ms": prefill["ms"],
                       "tokens_per_s": prefill["tokens_per_s"],
                       "decode_step_ms": step_ms,
                       "ttft_p50_ms": st["ttft_p50_ms"]}
        del eng
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    print(f"[encdec-vlm] phase 13 in {time.perf_counter() - t_phase:.1f} s  "
          f"[{stamp}]", flush=True)
    return out


# phase 14: LM training at full width and full depth
TRAIN_ARCH = "llama3.2-3b"
# (b)'s CLI run is cut in depth: its three checkpoints and the read-back
# move 12 bytes a parameter through the disk each, 38.5 GB at 28 layers
TRAIN_CLI_LAYERS = 4
LM_TRAIN_ARGS = ["--arch", TRAIN_ARCH, "--steps", "6", "--batch", "8",
                 "--seq", "128", "--workers", "2", "--layers",
                 str(TRAIN_CLI_LAYERS)]
TRAIN_TIMED_STEPS = 3      # (d)'s un-profiled 28-layer steps, timed
# flash_attention_bwd timed at llama3.2-3b's prefill (B, S, H, Hkv, Dh),
# causal bf16, and at the train step's own shape
BWD_TIMED = (("llama3_prefill", (2, 4096, 24, 8, 128)),
             ("llama3_train_step", (8, 128, 24, 8, 128)))
# held against the plain version: every head width (8 and 112 on the 16-
# and 128-wide templates), causal and full, GQA, ragged lengths
BWD_CASES = [(2, 37, 4, 2, 8, True), (1, 200, 4, 4, 8, False),
             (2, 130, 4, 1, 16, True), (2, 65, 6, 2, 32, True),
             (2, 1500, 4, 4, 64, False), (1, 257, 8, 2, 112, True),
             (1, 300, 4, 2, 112, False), (2, 1000, 8, 2, 128, True),
             (8, 128, 24, 8, 128, True), (2, 4096, 24, 8, 128, True)]
BWD_F32_REL = 1e-5         # f32 backward: |kernel - plain| / max |grad|
# bf16 backward over whole tensors: the kernel rounds to bf16 once (2^-8
# of an entry), the plain version not at all; each lies within 2^-7 of the
# f64 gradient (the f64 check's factor 2), so they differ by at most 2^-6
BWD_BF16_REL = 4 * 2.0 ** -8
LSE_REL = 1e-5             # the forward's log-sum-exp (``_hold_fwd``)
TRAIN_F32_LAYERS = 2       # the f32 kernel-vs-plain step at full width
TRAIN_REL_TOL = 1e-4


def _bwd_kernel_name(mangled: str) -> str:
    """``flash_bwd_dkv<64,f32>`` (the SIMT kernels, templated on the type)
    or ``flash_bwd_dq_wgmma<128>`` (the bf16 Hopper kernels) for the
    mangled name of that instance."""
    m = re.search(r"(flash_bwd_\w+?)ILi(\d+)E(?:(f|13__nv_bfloat16)E)?",
                  mangled)
    if not m:
        return mangled
    if m.group(3) is None:
        return f"{m.group(1)}<{m.group(2)}>"
    return (f"{m.group(1)}<{m.group(2)},"
            f"{'f32' if m.group(3) == 'f' else 'bf16'}>")


# the bf16 backward's kernels at Dh 128 (llama3.2-3b's): HGMMA or fail
BWD_HOPPER_128 = ("flash_bwd_dq_wgmma<128>", "flash_bwd_dkv_wgmma<128>")


def flash_bwd_report():
    """ptxas's registers, spills and the granted shared memory of each
    flash_attention backward kernel, the HGMMA count and highest register
    of each bf16 (wgmma) instance's SASS, and the atomics in their SASS
    (``float_atomics``); fails on a spill or a float atomic, or if a kernel
    of ``BWD_HOPPER_128`` has no HGMMA."""
    import ctypes

    from repro_torch.kernels.build import BUILD_DIR, load
    smem = load("flash_attention_bwd").flash_attention_bwd_smem_bytes
    smem.argtypes, smem.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    lines = sass_lines(BUILD_DIR / "libflash_attention_bwd.so")
    hgmma, top_reg = {}, {}
    for mangled, line in lines or []:
        name = _bwd_kernel_name(mangled)
        hgmma[name] = hgmma.get(name, 0) + ("HGMMA" in line)
        regs = [int(r) for r in re.findall(r"\bR(\d+)\b", line)]
        top_reg[name] = max([top_reg.get(name, -1), *regs])
    for name, info in sorted(ptxas_report("flash_attention_bwd",
                                          _bwd_kernel_name).items()):
        width = int(re.search(r"<(\d+)", name).group(1)) if "<" in name else 0
        hopper = "wgmma" in name
        # the library's codes: 0 / 1 the f32 dq / dkv kernel, 2 / 3 the bf16
        sass = (f"; SASS: HGMMA {hgmma.get(name, 'not counted')}, highest "
                f"register R{top_reg.get(name, '?')}" if hopper else "")
        print(f"[build] {name}: ptxas {info.get('used', 'not reported')}; "
              f"{info.get('spills', 'spills not reported')}; dynamic shared "
              f"memory {smem(width, 2 * hopper + ('dkv' in name))} B{sass}"
              + (f"; {info['warning']}" if "warning" in info else ""),
              flush=True)
        spilled = re.search(r"(\d+) bytes spill stores", info.get("spills", ""))
        if spilled and int(spilled.group(1)) > 0:
            fail(f"{name} spills registers: {info['spills']}")
    if lines is None:
        print("[build] no cuobjdump on this machine (toolkit or triton): "
              "the HGMMA check of flash_attention_bwd was not made",
              flush=True)
    for name in BWD_HOPPER_128:
        if lines is not None and not hgmma.get(name):
            fail(f"the bf16 flash_attention backward kernel {name} has no "
                 f"HGMMA in its SASS")
    floats = float_atomics(BUILD_DIR / "libflash_attention_bwd.so",
                           "flash_bwd", _bwd_kernel_name)
    if floats is None:
        print("[build] no cuobjdump on this machine (toolkit or triton): "
              "the float-atomic check of flash_attention_bwd was not made",
              flush=True)
    elif floats:
        fail(f"the flash_attention backward adds floats atomically: {floats}")


def _bwd_inputs(torch, shape, dtype, seed=0):
    """(q, k, v, o, lse, do, causal): seeded inputs, and the forward
    kernel's output and log-sum-exp."""
    from repro_torch.kernels.flash_attention.ops import _forward
    B, S, H, Hkv, Dh, causal = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(s, generator=g, device="cuda").to(dtype)
                   for s in ((B, S, H, Dh), (B, S, Hkv, Dh), (B, S, Hkv, Dh),
                             (B, S, H, Dh)))
    o, lse = _forward(q, k, v, causal, with_lse=True)
    return q, k, v, o, lse, do, causal


def _exact_attention(torch, q, k, v, causal: bool):
    """The attention of q (B, S, H, Dh), k/v (B, S, Hkv, Dh) in f64, kv
    repeated: o (B, S, H, Dh) and the rows' log-sum-exp (B, H, S).
    Differentiable by autograd: the f64 witness of the backward."""
    B, S, H, Dh = q.shape
    G = H // k.shape[2]
    qd, kd, vd = (t.double().transpose(1, 2) for t in
                  (q, k.repeat_interleave(G, 2), v.repeat_interleave(G, 2)))
    sc = qd @ kd.transpose(-1, -2) * Dh ** -0.5
    if causal:
        keep = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        sc = sc.masked_fill(~keep, float("-inf"))
    lse = torch.logsumexp(sc, -1)
    return (torch.exp(sc - lse[..., None]) @ vd).transpose(1, 2), lse


def _hold_fwd(torch, q, k, v, o, lse, causal, label: str):
    """The forward's O and log-sum-exp, as the backward receives them,
    against ``flash_attention_ref`` on the same inputs: O within
    FLASH_F32_ATOL (f32) or the bf16 bound (``bf16_excess``); each row's
    log-sum-exp within LSE_REL of the largest of 1, |lse| and the row's
    Cauchy-Schwarz bound on its scores (|q| max |k| Dh^-1/2: a score's f32
    rounding grows with it).  Returns the reference's (o, lse)."""
    from repro_torch.kernels.flash_attention.ref import (bf16_excess,
                                                         flash_attention_ref)
    o_ref, lse_ref = flash_attention_ref(q, k, v, causal, with_lse=True)
    B, S, H, Dh = q.shape
    G = H // k.shape[2]
    k_top = k.float().norm(dim=-1).amax(1).repeat_interleave(G, 1)  # (B, H)
    row = q.float().norm(dim=-1).transpose(1, 2) * k_top[..., None] \
        * Dh ** -0.5
    scale = torch.maximum(lse_ref.abs(), row).clamp_min(1)
    lse_x = float(((lse - lse_ref).abs() / scale).max())
    if q.dtype == torch.float32:
        o_err = float((o - o_ref).abs().max())
        o_ok = o_err <= FLASH_F32_ATOL
        how = f"O max_abs_err={o_err} (limit {FLASH_F32_ATOL})"
    else:
        elem, rw = bf16_excess(o, q, k, v, causal)
        o_ok = max(elem, rw) <= 1
        how = f"O bf16 bound: element {elem:.3f}, row {rw:.3f} of the limits"
    print(f"[kernel] flash_attention with log-sum-exp {label}: {how}; lse "
          f"{lse_x:.3e} of the row scale (limit {LSE_REL})", flush=True)
    if not (o_ok and lse_x <= LSE_REL and bool(torch.isfinite(lse).all())):
        fail(f"flash_attention's O or log-sum-exp disagrees with the plain "
             f"version at {label}")
    return o_ref, lse_ref


def _hold_bwd(torch, args, got, label: str) -> float:
    """Holds a backward's (dq, dk, dv) against ``flash_attention_bwd_ref``
    on the same inputs and returns the max abs difference.  The forward's
    O and log-sum-exp in ``args`` are held first (``_hold_fwd``), and the
    plain backward reads the plain forward's own, so a fault of the
    forward cannot cancel out.  f32: within BWD_F32_REL of the largest
    gradient entry; bf16: within BWD_BF16_REL of it over the whole tensors,
    and each gradient's error against an f64 witness (``_exact_attention``
    under autograd) no worse than twice the plain version's own (computed
    in f32, rounded to bf16), on batch 0 and kv head 0's group of q heads
    where the whole f64 problem is large (the group is a problem of its
    own: its dq reads that kv head alone)."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref
    q, k, v, o, lse, do = (t.detach() for t in args[:6])
    causal = args[6]
    got = tuple(t.detach() for t in got)
    o_ref, lse_ref = _hold_fwd(torch, q, k, v, o, lse, causal, label)
    plain = flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                    o_ref.float(), lse_ref, do.float(), causal)
    err = max(float((a.float() - b).abs().max()) for a, b in zip(got, plain))
    top = max(float(b.abs().max()) for b in plain)
    if q.dtype == torch.float32:
        ok = err <= BWD_F32_REL * top
        how = f"{err / top:.3e} of the largest entry (limit {BWD_F32_REL})"
    else:
        B, S, H, _ = q.shape
        G = H // k.shape[2]
        if B * H * S * S > 2**27:
            part = (slice(0, 1), slice(None), slice(0, G))
            kvp = (slice(0, 1), slice(None), slice(0, 1))
            q, o_ref, do = (t[part] for t in (q, o_ref, do))
            k, v = k[kvp], v[kvp]
            got = (got[0][part], got[1][kvp], got[2][kvp])
            plain = (plain[0][part], plain[1][kvp], plain[2][kvp])
        with torch.enable_grad():
            leaves64 = [t.double().requires_grad_() for t in (q, k, v)]
            o64, _ = _exact_attention(torch, *leaves64, causal)
            exact = torch.autograd.grad(o64, leaves64, do.double())
        del o64, leaves64
        ratio = 0.0
        for a, p, e in zip(got, plain, exact):
            own = float((p.to(a.dtype).double() - e).abs().max())
            mine = float((a.double() - e).abs().max())
            ratio = max(ratio, mine / max(2 * own, 1e-6 * top))
        ok = ratio <= 1 and err <= BWD_BF16_REL * top
        how = (f"{err / top:.3e} of the largest entry (limit "
               f"{BWD_BF16_REL}); error against f64 {ratio:.3f} of twice "
               f"the plain version's own bf16 error")
    print(f"[kernel] flash_attention_bwd {label}: max_abs_err={err} ({how})",
          flush=True)
    if not (ok and all(bool(torch.isfinite(t).all()) for t in got)):
        fail(f"flash_attention_bwd disagrees with its plain version at "
             f"{label}")
    return err


def _time_bwd(torch, label, shape, flush, rate, stamp, parent) -> dict:
    """The backward at a timed shape (bf16, causal): kernel and the parent
    commit's kernel in turns (parent, kernel, kernel, parent), the plain
    version and SDPA's backward (forward + backward less the forward, the
    port never calls it) beside the bound, each the median of TIMED_LAUNCHES
    calls with L2 flushed, each with its TFLOP/s and share of the bound;
    and the device time of its dq and dkv kernels (``torch.profiler``, five
    calls)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import flash_attention_bwd
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref
    B, S, H, Hkv, Dh = shape
    args = _bwd_inputs(torch, (*shape, True), torch.bfloat16)
    q, k, v, o, lse, do, _ = args
    flops = 2.5 * 4 * B * H * Dh * S * (S + 1) // 2
    nbytes = ((3 * q.numel() + 4 * k.numel() + o.numel()) * q.element_size()
              + lse.numel() * 4)          # q k v o do in, dq dk dv out
    t_f, t_b = flops / BF16_FLOP_PER_S * 1e3, nbytes / rate * 1e3
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2)

    def sdpa(grad: bool):
        with torch.set_grad_enabled(grad):
            out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                 enable_gqa=Hkv != H)
            if grad:
                torch.autograd.grad(out, (qt, kt, vt), dot)
    before = flash_attention_bwd.launches
    turns = _turns(torch, lambda: flash_attention_bwd(*args),
                   None if parent is None
                   else lambda: parent.flash_backward(*args), flush)
    t = {"ms": turns[1], "parent_ms": turns[0],
         "plain_ms": time_ms(torch, lambda: flash_attention_bwd_ref(*args),
                             flush),
         "bound_ms": max(t_f, t_b),
         "bound_by": "operations" if t_f >= t_b else "bytes"}
    rows = []       # the device time of each of the call's two kernels
    _profile(torch, lambda: flash_attention_bwd(*args), stamp,
             f"flash_attention_bwd {label}", calls=5, rows_out=rows)
    for part in ("dq", "dkv"):
        t[f"{part}_ms"] = sum(n for k, n, _ in rows
                              if f"flash_bwd_{part}_" in k) / 1e3 / 5
    flash_attention_bwd.launches = before       # timing is not the path
    fwd_bwd = time_ms(torch, lambda: sdpa(True), flush)
    fwd = time_ms(torch, lambda: sdpa(False), flush)
    t["library_ms"] = fwd_bwd - fwd

    def rate_of(ms):
        return ("not timed" if ms is None else
                f"{ms} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
                f"{t['bound_ms'] / ms:.1%} of the bound)")
    print(f"[time] flash_attention_bwd {label} q ({B}, {S}, {H}, {Dh}) kv "
          f"heads {Hkv} bf16 causal: kernel {rate_of(t['ms'])}; parent "
          f"{rate_of(t['parent_ms'])} (turns parent / kernel / kernel / "
          f"parent {turns} ms); plain {rate_of(t['plain_ms'])}; "
          f"scaled_dot_product_attention backward {rate_of(t['library_ms'])} "
          f"(forward + backward {fwd_bwd} ms less the forward {fwd} ms); "
          f"bound {t['bound_ms']} ms by {t['bound_by']}: {flops} FLOP at "
          f"{BF16_FLOP_PER_S / 1e12} TFLOP/s = {t_f} ms, {nbytes} B at "
          f"{rate / 1e12} TB/s = {t_b} ms  [{stamp}]", flush=True)
    return t


# the forward held bit-equal to the parent commit's kernel, bf16 causal:
# the llama3.2-3b and qwen3-4b prefills (B, S, H, Hkv, Dh)
FWD_PARENT_SHAPES = (("llama3.2-3b", (2, 4096, 24, 8, 128)),
                     ("qwen3-4b", (2, 4096, 32, 8, 128)))


def _hold_fwd_to_parent(torch, parent):
    """The forward's O and log-sum-exp bit-equal to the parent commit's
    kernel on the same inputs (the helpers moved to ``hopper.cuh``; the
    arithmetic is unchanged)."""
    from repro_torch.kernels.flash_attention.ops import _forward
    if parent is None:
        print("[check] the forward was not held to the parent's kernel: no "
              "parent at hand", flush=True)
        return
    for label, (B, S, H, Hkv, Dh) in FWD_PARENT_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(3)
        q, k, v = (torch.randn(x, generator=g, device="cuda")
                   .to(torch.bfloat16)
                   for x in ((B, S, H, Dh), (B, S, Hkv, Dh), (B, S, Hkv, Dh)))
        o, lse = _forward(q, k, v, True, with_lse=True)
        o_p, lse_p = parent.flash_forward(q, k, v, True)
        same = torch.equal(o, o_p) and torch.equal(lse, lse_p)
        print(f"[check] flash_attention {label} prefill ({B}, {S}, {H}, "
              f"{Hkv}, {Dh}) bf16 causal: O and log-sum-exp bit-equal to the "
              f"parent's kernel: {same}", flush=True)
        if not same:
            fail(f"the forward's O or log-sum-exp differs from the parent's "
                 f"kernel at the {label} prefill")


def _ckpt_room(torch, ckpt_bytes: int, stamp: str):
    """(directory, keep): a checkpoint directory inside the checkout
    (``build/``) or under TMPDIR, whichever filesystem has more free bytes,
    and whether the run's checkpoints can stay there.  Keep 2 needs room
    for 3 (two committed, one being written); where the disk holds fewer,
    the phase verifies and then removes each committed checkpoint but the
    last (``_verify_and_drop``; the program is unchanged, but its keep-2
    pruning then finds nothing to prune), so room for one must be there.
    Fails unless it is, and unless the host's available memory holds two
    host copies (a new snapshot while the last one is written) and then
    the last checkpoint read back."""
    cands = [ROOT / "build" / "ckpt_lm",
             Path(tempfile.gettempdir()) / "repro_torch_ckpt_lm"]
    free = {c: shutil.disk_usage(c.parent if c.parent.exists() else ROOT).free
            for c in cands}
    best = max(cands, key=lambda c: free[c])
    avail = 0
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                avail = int(line.split()[1]) * 1024
    keep = free[best] >= 3 * ckpt_bytes
    print(f"[train] checkpoint: params, m and v in f32 = {ckpt_bytes} B a "
          f"save; keep 2 needs up to 3 on disk at once ({3 * ckpt_bytes} B); "
          f"free: " + ", ".join(f"{c.parent} {free[c]} B" for c in cands)
          + f"; host memory available {avail} B for up to 2 host copies "
          f"({2 * ckpt_bytes} B); "
          + ("the checkpoints stay" if keep else
             "too little disk for keep 2: each committed checkpoint but "
             "the last is verified, then removed by this script; the last "
             "is read back and compared leaf by leaf")
          + f"  [{stamp}]", flush=True)
    if free[best] < 1.05 * ckpt_bytes:
        fail(f"no filesystem with room for one checkpoint of {ckpt_bytes} B "
             f"(largest free: {free[best]} B at {best.parent})")
    if avail < 2 * ckpt_bytes:
        fail(f"host memory available ({avail} B) holds fewer than two "
             f"checkpoint snapshots of {ckpt_bytes} B")
    shutil.rmtree(best, ignore_errors=True)
    return best, keep


@contextlib.contextmanager
def _verify_and_drop(n_leaves: int, keep: bool, last: int, log: list):
    """Wrap ``CheckpointManager._write``: time the write and, once it has
    committed, check the step's ``_COMMITTED`` marker, its manifest's leaf
    count and its bytes on disk (appended to ``log`` as (step, seconds,
    bytes)); unless ``keep``, then remove the step's directory, except the
    ``last`` step's, which the phase reads back.  Restored on exit."""
    from repro_torch.train.checkpoint import CheckpointManager
    write = CheckpointManager._write

    def wrapped(self, step, host_state, extra):
        t0 = time.perf_counter()
        write(self, step, host_state, extra)
        dt = time.perf_counter() - t0
        d = self.dir / f"step_{step:09d}"
        if self._error is None:
            manifest = json.loads((d / "MANIFEST.json").read_text())
            if not (d / "_COMMITTED").exists() or \
                    len(manifest["leaves"]) != n_leaves:
                self._error = RuntimeError(f"checkpoint step {step} is not "
                                           f"whole")
            log.append((step, dt, sum(f.stat().st_size
                                      for f in d.iterdir())))
            if not keep and step != last:
                shutil.rmtree(d)
    CheckpointManager._write = wrapped
    try:
        yield
    finally:
        CheckpointManager._write = write


def _read_back(torch, ckpt, state, stamp: str):
    """Restores the last committed checkpoint onto the host and holds it
    leaf by leaf against the run's final state on the card (params, AdamW's
    m and v, bit for bit; the step count equal)."""
    from repro_torch.models.params import leaves, tree_map
    t0 = time.perf_counter()
    # host leaves of the state's shapes that hold no memory of their own
    template = tree_map(lambda x: torch.zeros(()).expand(x.shape)
                        if isinstance(x, torch.Tensor) else x, state)
    back, step = ckpt.restore(template)
    t_read = time.perf_counter() - t0
    n, bad = 0, []
    for group in state:
        for a, b in zip(leaves(back[group]), leaves(state[group])):
            same = (torch.equal(a, b.cpu()) if isinstance(b, torch.Tensor)
                    else a == b)
            n += 1
            if not same:
                bad.append(f"{group} leaf {n}")
    del back
    print(f"[check] checkpoint step {step} read back in {t_read:.1f} s: "
          f"{n} leaves, each equal to the run's final state on the card="
          f"{not bad}  [{stamp}]", flush=True)
    if bad:
        fail(f"the checkpoint of step {step} differs from the run's state: "
             f"{bad[:5]}")


def _whole_fan_in(params):
    """The attention weights of a seeded tree rescaled in place to N(0, 1 /
    their whole fan-in): the initializer (JAX's) reads the fan-in of
    ``wq``/``wk``/``wv`` (L, D, heads, Dh) from the heads and of ``wo``
    (L, H, Dh, D) from Dh, which leaves the seeded stack's scores in the
    thousands (``tests/test_torch_cuda.py``'s ``_fan_in_params``)."""
    for name, w in params["layers"]["attn"].items():
        if name in ("wq", "wk", "wv"):
            w.mul_((w.shape[-2] / w.shape[-3]) ** 0.5)
        elif name == "wo":
            w.mul_(w.shape[-3] ** -0.5)


def _f32_step_vs_plain(torch, stamp: str):
    """A full-width llama3.2-3b cut to TRAIN_F32_LAYERS layers, f32, seeded
    on the card: loss and every gradient through the flash kernels (forward
    and backward) against the same through the plain attention on the
    card.  With the seeded weights the scores reach the thousands, where
    one f32 ulp of a score moves its probability by ~1e-3; there the same
    step on the CPU (the port's CPU path, plain attention) is the witness:
    the kernels' distance to it is held to no more than twice the plain
    card path's own, or TRAIN_REL_TOL.  With the attention weights at
    their whole fan-in the kernels are held to TRAIN_REL_TOL of the plain
    card path directly."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import flash_attention_bwd
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models import layers
    from repro_torch.models.api import build
    from repro_torch.models.params import init_params, leaves, unflatten
    cfg = get_config(TRAIN_ARCH).replace(num_layers=TRAIN_F32_LAYERS,
                                         compute_dtype="float32")
    model = build(cfg)
    params = init_params(model.decls,
                         torch.Generator(device="cuda").manual_seed(1), "cuda")
    g = torch.Generator(device="cuda").manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (8, 129), generator=g,
                         device="cuda", dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    top_score = [0.0]

    def plain_attention(q, k, v, causal=True):
        # flash_attention_ref, noting the largest |score| it sees
        with torch.no_grad():
            kr = k.repeat_interleave(q.shape[2] // k.shape[2], 2)
            sc = torch.einsum("bqhd,bkhd->bhqk", q, kr) * q.shape[-1] ** -0.5
            if causal:
                sc = sc.tril()
            top_score[0] = max(top_score[0], float(sc.abs().max()))
        return flash_attention_ref(q, k, v, causal)

    def run(tree, data, attention=None):
        p_l = [p.detach().requires_grad_() for p in leaves(tree)]
        flash = layers.flash_attention
        layers.flash_attention = attention or flash
        try:
            loss, _ = model.loss_fn(unflatten(tree, p_l), data)
            grads = torch.autograd.grad(loss, p_l)
        finally:
            layers.flash_attention = flash
        return float(loss.detach()), grads

    def gap(a_run, b_run):
        (la, ga), (lb, gb) = a_run, b_run
        worst = max(float((a.to(b.device) - b).abs().max()
                          / b.abs().max().clamp(min=1e-30))
                    for a, b in zip(ga, gb))
        return abs(la - lb) / abs(lb), worst

    def kernel_and_plain(label):
        before = flash_attention_bwd.launches
        kern = run(params, batch)
        launched = flash_attention_bwd.launches - before
        top_score[0] = 0.0
        plain = run(params, batch, plain_attention)
        dl, worst = gap(kern, plain)
        print(f"[check] f32 train step at full width, {TRAIN_F32_LAYERS} "
              f"layers, {label}: loss {kern[0]} (kernel) vs {plain[0]} "
              f"(plain attention), rel {dl:.2e}; gradients (every leaf) max "
              f"|diff| / max |grad| {worst:.2e}; largest |score| "
              f"{top_score[0]:.1f}; {launched} backward launches  [{stamp}]",
              flush=True)
        if launched != TRAIN_F32_LAYERS:
            fail(f"the f32 train step launched flash_attention_bwd "
                 f"{launched} times, not {TRAIN_F32_LAYERS}")
        return kern, plain, dl, worst

    kern, plain, dl, worst = kernel_and_plain("seeded weights")
    t0 = time.perf_counter()
    cpu = run(unflatten(params, [p.cpu() for p in leaves(params)]),
              {k: t.cpu() for k, t in batch.items()})
    (dl_k, w_k), (dl_p, w_p) = gap(kern, cpu), gap(plain, cpu)
    print(f"[check] the same step on the CPU (plain attention, f32, "
          f"{time.perf_counter() - t0:.1f} s) as witness: kernels vs CPU "
          f"loss rel {dl_k:.2e}, gradients {w_k:.2e}; plain attention on "
          f"the card vs CPU loss rel {dl_p:.2e}, gradients {w_p:.2e} "
          f"(limit: each of the kernels' gaps at most max({TRAIN_REL_TOL}, "
          f"twice the plain card path's))  [{stamp}]", flush=True)
    del kern, plain, cpu
    if dl_k > max(TRAIN_REL_TOL, 2 * dl_p) or \
            w_k > max(TRAIN_REL_TOL, 2 * w_p):
        fail("at the seeded weights the f32 train step through the kernels "
             "lies further from the CPU witness than the plain attention "
             "on the card does")
    with torch.no_grad():
        _whole_fan_in(params)
    _, _, dl, worst = kernel_and_plain(f"attention weights at their whole "
                                       f"fan-in (limit {TRAIN_REL_TOL})")
    if dl > TRAIN_REL_TOL or worst > TRAIN_REL_TOL:
        fail("the f32 train step through the kernels disagrees with the "
             "plain attention")


def phase_lm_train(torch, stamp: str, parent) -> dict:
    """LM training at full width and full depth (phase 14); returns the
    flash_attention_bwd JSON entry, the launches of the forward and the
    peak of (d)'s profiled step in a window of its own."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch.footprint import step_peak, window_start
    from repro_torch.launch.train import build_parser, run_lm
    from repro_torch.models.api import build
    from repro_torch.models.params import init_params, leaves
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.data import SyntheticTokens, to_device
    from repro_torch.train.trainer import make_train_step

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    rate = hbm_rate(torch.cuda.get_device_name(0))
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")

    # (a) the forward bit-equal to the parent's kernel; the backward kernel
    # alone: held, deterministic, O unchanged by the log-sum-exp, and timed
    _hold_fwd_to_parent(torch, parent)
    errs = []
    for shape in BWD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            args = _bwd_inputs(torch, shape, dtype)
            q, k, v, o, lse, do, causal = args
            if not torch.equal(o, fa._forward(q, k, v, causal, False)):
                fail(f"flash_attention's O changes with the log-sum-exp at "
                     f"{shape} {dtype}")
            got = fa.flash_attention_bwd(*args)
            again = fa.flash_attention_bwd(*args)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail(f"two flash_attention_bwd runs differ at {shape} {dtype}")
            errs.append(_hold_bwd(torch, args, got,
                                  f"{'x'.join(map(str, shape))} {dtype}"))
            del args, got, again
    print(f"[check] flash_attention_bwd: {2 * len(BWD_CASES)} cases held, "
          f"each run twice bit-equal; O bit-equal with and without the "
          f"log-sum-exp", flush=True)
    timed = {label: _time_bwd(torch, label, shape, flush, rate, stamp,
                              parent)
             for label, shape in BWD_TIMED}
    del flush
    torch.cuda.empty_cache()

    # (b) the CLI path at full width, cut in depth: the seeded f32 masters,
    # AdamW, 6 steps through the supervisor, checkpoints at 2, 4 and 6
    full = get_config(TRAIN_ARCH)
    cfg = full.replace(num_layers=TRAIN_CLI_LAYERS)
    n_params = cfg.param_count()
    ckpt_bytes = 3 * 4 * n_params
    ckpt_dir, keep = _ckpt_room(torch, ckpt_bytes, stamp)
    args = build_parser().parse_args([*LM_TRAIN_ARGS, "--ckpt-dir",
                                      str(ckpt_dir)])
    recorded = []
    bwd, backward = fa.flash_attention_bwd, fa.FlashAttention.backward

    def record(ctx, do):
        # FlashAttention.backward, keeping the first step's calls (a
        # checkpointed tensor unpacks once, so this is the whole backward)
        q, k, v, o, lse = ctx.saved_tensors
        call = (q, k, v, o, lse, do.contiguous(), ctx.causal)
        if len(recorded) < cfg.num_layers:
            recorded.append(call)
        return (*bwd(*call), None)
    ck_log, writes = [], []
    n_leaves = 3 * len(leaves(build(cfg).decls)) + 1      # params, m, v, count
    torch.cuda.reset_peak_memory_stats()
    counts = _zero_counts()
    bwd.launches = 0
    fa.FlashAttention.backward = staticmethod(record)
    try:
        with _verify_and_drop(n_leaves, keep, args.steps, writes), \
                _timed(torch, CheckpointManager, ("save", "wait"), ck_log):
            out = run_lm(args)
    finally:
        fa.FlashAttention.backward = staticmethod(backward)
    launches = counts()
    launches["flash_attention_bwd"] = bwd.launches
    peak = torch.cuda.max_memory_allocated()
    hist = out["history"]
    steps = len(hist)
    want = {"flash_attention": 2 * cfg.num_layers * steps,
            "flash_attention_bwd": cfg.num_layers * steps}
    print(f"[train] {TRAIN_ARCH} full width, {cfg.num_layers} of "
          f"{full.num_layers} layers, {n_params} parameters: launches {launches} over {steps} steps "
          f"(predicted {want}: remat 'dots' recomputes each layer's forward "
          f"once in the backward)  [{stamp}]", flush=True)
    if any(launches[k] != n for k, n in want.items()) or any(
            n for k, n in launches.items() if k not in want):
        fail(f"train launches {launches}, expected {want} and nothing else")
    losses = [h[1] for h in hist]
    gnorms = [h[2] for h in hist]
    if not all(math.isfinite(x) for x in losses + gnorms):
        fail(f"non-finite loss or gradient norm: {losses} {gnorms}")
    tokens = args.batch * args.seq
    step_s = [h[4] - h[3] for h in hist]
    window = hist[-1][4] - hist[0][4]           # steps 2..6, wall
    saves = [s for n, s, *_ in ck_log if n == "save"]
    waits = [s for n, s, *_ in ck_log if n == "wait"]
    print(f"[train] losses {losses}; gradient norms {gnorms}", flush=True)
    print(f"[train] steps 2-{steps}: {(steps - 1) / window:.4f} steps/s, "
          f"{(steps - 1) * tokens / window:.1f} tokens/s over {window:.3f} s "
          f"wall (the checkpoint snapshots at steps 2 and 4 inside it); each "
          f"step's own seconds {[round(s, 4) for s in step_s]} (median of "
          f"steps 2-{steps} {sorted(step_s[1:])[(steps - 1) // 2]:.4f} s = "
          f"{tokens / sorted(step_s[1:])[(steps - 1) // 2]:.1f} tokens/s); "
          f"whole run {out['seconds']:.2f} s; peak memory allocated "
          f"{peak} B ({peak / 2**30:.2f} GiB)  [{stamp}]", flush=True)
    left = CheckpointManager(ckpt_dir).all_steps()
    print(f"[train] checkpoints {out['report'].checkpoints} of {ckpt_bytes} "
          f"B to {ckpt_dir}: save (host snapshot, on the step's thread) "
          f"{[round(s, 3) for s in saves]} s; write (the background thread; "
          f"step, s, bytes on disk) "
          f"{[(st, round(s, 3), b) for st, s, b in writes]}; wait "
          f"{[round(s, 3) for s in waits]} s; committed and verified steps "
          f"{[w[0] for w in writes]}, left on disk {left}  [{stamp}]",
          flush=True)
    if out["report"].checkpoints != 3 or [w[0] for w in writes] != [2, 4, 6] \
            or left != ([4, 6] if keep else [6]):
        fail("the supervisor did not commit steps 2, 4 and 6 (keep 2)")
    _read_back(torch, CheckpointManager(ckpt_dir), out["state"], stamp)
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    # (c) the first step's backward calls held in situ
    for i, a in enumerate(recorded):
        _hold_bwd(torch, a, bwd(*a), f"in situ, step 1 layer call {i}")
    if len(recorded) != cfg.num_layers:
        fail(f"recorded {len(recorded)} backward calls, not {cfg.num_layers}")
    del recorded

    # (d) the full-depth step on seeded f32 masters and AdamW state built
    # on the card as run_lm builds them: one step with every gradient
    # finite (the grad_transform hook), TRAIN_TIMED_STEPS timed, then one
    # profiled: device busy and idle share, and its own peak
    del out
    torch.cuda.empty_cache()
    cfg = full
    model = build(cfg)
    params = init_params(model.decls,
                         torch.Generator(device="cuda").manual_seed(0),
                         "cuda", dtype_override=getattr(torch,
                                                        cfg.param_dtype))
    data = SyntheticTokens(cfg.vocab_size, args.batch, args.seq, seed=7,
                           n_batches=TRAIN_TIMED_STEPS + 2)

    def finite(tree):
        bad = [i for i, g in enumerate(leaves(tree))
               if not bool(torch.isfinite(g).all())]
        if bad:
            fail(f"non-finite gradients in leaves {bad}")
        return tree
    step, opt = make_train_step(model, cfg, grad_transform=finite)
    opt_state = opt.init(params)
    step(params, opt_state, to_device(data.make(0), "cuda"))
    print(f"[check] {cfg.num_layers} layers: every one of the "
          f"{len(leaves(params))} leaves' gradients finite", flush=True)
    step, _ = make_train_step(model, cfg)
    full_s = []
    for i in range(TRAIN_TIMED_STEPS):
        batch = to_device(data.make(1 + i), "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, opt_state, batch)
        torch.cuda.synchronize()
        full_s.append(time.perf_counter() - t0)
    step_ms = sorted(full_s)[TRAIN_TIMED_STEPS // 2] * 1e3
    rows = []
    # the profiled step's own peak, as the dry-run's memory trace counts it
    # (not the first step's: its check's torch.isfinite holds an f32 |g|
    # and bool copies of a stacked leaf beside every gradient, 2.11 GB)
    base = window_start()
    busy = _profile(torch, lambda: step(params, opt_state, batch), stamp,
                    "one train step", rows_out=rows)
    clean_peak = step_peak(base, params, opt_state, batch)
    print(f"[train] {cfg.num_layers} layers: the profiled step's own peak "
          f"{clean_peak} B ({clean_peak / 2**30:.3f} GiB: "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()} B over "
          f"it, {base} B at its start)  [{stamp}]", flush=True)
    idle = 1 - busy / step_ms
    bwd_rows = [r for r in rows if "flash_bwd" in r[0]]
    bwd_ms = sum(r[1] for r in bwd_rows) / 1e3
    print(f"[train] {cfg.num_layers} layers, one profiled step: device busy "
          f"{busy:.3f} ms against the median of {TRAIN_TIMED_STEPS} "
          f"un-profiled steps ({[round(x * 1e3, 3) for x in full_s]} ms, "
          f"the batch already on the card) {step_ms:.3f} ms: idle "
          f"{idle:.1%}; the flash_attention backward's kernels in it "
          f"{bwd_ms:.4f} ms "
          f"({', '.join(f'{n[:40]} {t / 1e3:.4f} ms x {c}' for n, t, c in bwd_rows)})"
          f"  [{stamp}]", flush=True)
    del model, params, opt_state, step, batch
    torch.cuda.empty_cache()

    # (e) the f32 step through the kernels against the plain attention
    _f32_step_vs_plain(torch, stamp)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    print(f"[train] phase 14 in {time.perf_counter() - t_phase:.1f} s  "
          f"[{stamp}]", flush=True)
    prefill = timed["llama3_prefill"]
    entry = {"name": "flash_attention_bwd", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
             "replaces": "src/repro/kernels/flash_attention/kernel.py:60",
             "note": "the backward of that kernel's function; the TPU "
                     "kernel has none (JAX differentiates jnp attention)",
             "launches": launches["flash_attention_bwd"],
             "max_abs_err": max(errs), **prefill,
             "llama3_2_3b_train_step": timed["llama3_train_step"],
             "train": {"cli_layers": TRAIN_CLI_LAYERS,
                       "steps_per_s": (steps - 1) / window,
                       "tokens_per_s": (steps - 1) * tokens / window,
                       "step_ms": step_ms, "device_busy_ms": busy,
                       "bwd_in_situ_ms": bwd_ms,
                       "idle_share": idle, "peak_bytes": peak,
                       "ckpt_save_s": saves,
                       "ckpt_write_s": [w[1] for w in writes],
                       "ckpt_wait_s": waits}}
    return {"entry": entry, "flash_attention": launches["flash_attention"],
            "step_peak": clean_peak}


PIPE_STAGES, PIPE_MICRO, PIPE_TOKENS = 4, 8, 128
DECODE_ARCH, DECODE_BATCH, DECODE_CACHE = LM_ARCH, 8, 4096
PEAK_LAYERS = (2, 4)


def _account_vs_card(torch, stamp: str, train_entry: dict,
                     step_peak_28: int):
    """(a): the dry-run's argument bytes, FLOPs and traced peak memory
    against llama3.2-3b on the card: 2- and 4-layer steps here, and
    ``step_peak_28``, the 28-layer step's own peak in phase 14 (d)."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.footprint import (allocator_block,
                                              allocator_slack,
                                              peak_tolerance, step_peak,
                                              window_start)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.api import build
    from repro_torch.models.params import init_params, leaves
    from repro_torch.train.data import SyntheticTokens, to_device
    from repro_torch.train.optimizer import get_optimizer
    from repro_torch.train.trainer import make_train_step

    cfg = get_config(TRAIN_ARCH)
    batch, seq = 8, 128
    shape = ShapeConfig("phase14", "train", seq, batch)
    mesh = make_host_mesh()
    mem = dryrun.memory(cfg, shape, mesh)
    want = mem["argument_bytes"] - mem["parts"]["batch"]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model = build(cfg)
    params = init_params(model.decls,
                         torch.Generator(device="cuda").manual_seed(0), "cuda")
    state = get_optimizer(cfg).init(params)
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - base
    tensors = leaves(params) + leaves(state["m"]) + leaves(state["v"])
    held = sum(t.untyped_storage().nbytes() for t in tensors)
    blocks = sum(allocator_block(t.untyped_storage().nbytes())
                 for t in tensors)
    # the port keeps AdamW's step count as a Python int, where the dry-run
    # counts JAX's int32 scalar: 4 bytes
    count = 4
    print(f"[account] {TRAIN_ARCH} f32 masters + AdamW state on the card: "
          f"{len(tensors)} tensors holding {held} B; the dry-run's "
          f"argument_bytes less the batch and the 4-byte step count "
          f"{want - count} B (params {mem['parts']['params']}, state "
          f"{mem['parts']['opt_state']}, batch {mem['parts']['batch']}); "
          f"memory_allocated grew {grown} B, {grown - held} B over the "
          f"tensors' bytes, where the allocator's blocks predict {blocks} B "
          f"({blocks - held} B of rounding: 512 B a tensor, and an unsplit "
          f"segment remainder of at most 1 MiB a block over 1 MiB)  "
          f"[{stamp}]", flush=True)
    if held != want - count:
        fail(f"argument bytes {want - count} against {held} held on the card")
    slack = sum(allocator_slack(t.untyped_storage().nbytes())
                for t in tensors)
    if not 0 <= grown - held <= slack:
        fail(f"memory_allocated grew {grown} B for {held} B of tensors, "
             f"beyond the allocator's {slack} B of rounding")
    del params, state, model
    torch.cuda.empty_cache()

    acc = dryrun.account(cfg, shape, mesh)
    step_s = train_entry["train"]["step_ms"] / 1e3
    rate = acc["flops"] / step_s
    print(f"[account] the dry-run's FLOPs of one {TRAIN_ARCH} step at "
          f"{batch} x {seq}: {acc['flops']:.6e} ({acc['product_flops']:.6e} "
          f"in matrix products; probes at depths {acc['probe_depths']}, "
          f"{acc['t_probe_s']:.2f} s of host); over phase 14's median step "
          f"of {step_s * 1e3:.3f} ms: {rate / 1e12:.2f} TFLOP/s, "
          f"{rate / BF16_FLOP_PER_S:.2%} of 989 TFLOP/s  [{stamp}]",
          flush=True)

    # each step's own peak on the card against the dry-run's memory trace
    # of the same step on meta: 2 and 4 layers here, 28 in phase 14 (d)
    peaks, traced = [], []
    data = SyntheticTokens(cfg.vocab_size, batch, seq, seed=7, n_batches=2)
    for n in PEAK_LAYERS:
        c = cfg.replace(num_layers=n)
        m = build(c)
        p = init_params(m.decls, torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
        step, opt = make_train_step(m, c)
        st = opt.init(p)
        step(p, st, to_device(data.make(0), "cuda"))
        b = to_device(data.make(1), "cuda")
        base = window_start()
        step(p, st, b)
        torch.cuda.synchronize()
        peaks.append(step_peak(base, p, st, b))
        del m, p, st, step, b
        torch.cuda.empty_cache()
        traced.append(dryrun.trace_unsharded(c, shape)["peak_bytes"])
    t0 = time.perf_counter()
    direct = dryrun.trace_unsharded(cfg, shape)["peak_bytes"]
    t_direct = time.perf_counter() - t0
    # the dry-run traces a cell's peak at full depth: two probes' line
    # misses it where the program point holding the peak moves with depth
    line = dryrun._extrapolate(*traced, *PEAK_LAYERS, cfg.num_layers)
    rows = list(zip([f"{n} layers" for n in PEAK_LAYERS], peaks, traced))
    rows.append((f"{cfg.num_layers} layers (phase 14 (d))", step_peak_28,
                 direct))
    for label, got, want in rows:
        tol = peak_tolerance(got)
        print(f"[account] {TRAIN_ARCH} {label} at {batch} x {seq}: the "
              f"step's own peak on the card {got} B ({got / 2**30:.3f} GiB), "
              f"the dry-run's trace on meta {want} B: {want - got:+d} B "
              f"({(want - got) / got:+.3%}; bound {tol:.0f} B)  [{stamp}]",
              flush=True)
        if abs(want - got) > tol:
            fail(f"the traced peak of {TRAIN_ARCH} at {label}, {want} B, "
                 f"misses the card's {got} B by more than {tol:.0f} B")
    print(f"[account] {TRAIN_ARCH} {cfg.num_layers} layers: the direct "
          f"trace {direct} B ({t_direct:.2f} s of host); the line through "
          f"the {PEAK_LAYERS[0]}- and {PEAK_LAYERS[1]}-layer traces {line:.0f}"
          f" B ({(line - direct) / direct:+.3%}, not used)  [{stamp}]",
          flush=True)
    return {"argument_bytes": want, "allocated_bytes": grown,
            "step_flops": acc["flops"], "tflops_per_s": rate / 1e12,
            "peaks": peaks, "traced": traced, "peak_28": step_peak_28,
            "traced_28": direct}


def _shims_vs_cpu(torch, stamp: str):
    """(b): the compression shims and the flash-decode combine on the card
    against the CPU and the full attention."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.collectives import flash_decode_attention
    from repro_torch.launch.mesh import HostSimMesh
    from repro_torch.train import compression as C

    g = torch.Generator().manual_seed(3)
    xs = [torch.randn(1024, 3072, generator=g) for _ in range(8)]
    xs[1][:5] = 0.5                                  # ties for the top-k
    checks = []

    def same(label, got, want):
        got = got if isinstance(got, (tuple, list)) else (got,)
        want = want if isinstance(want, (tuple, list)) else (want,)
        for a, b in zip(got, want):
            if a.dtype != b.dtype or not torch.equal(a.cpu(), b):
                fail(f"{label} on the card differs from the CPU")
        checks.append(label)
    x, xc = xs[1], xs[1].cuda()
    same("quantize_int8", C.quantize_int8(xc), C.quantize_int8(x))
    q, sc = C.quantize_int8(x)
    same("dequantize_int8", C.dequantize_int8(q.cuda(), sc.cuda()),
         C.dequantize_int8(q, sc))
    for frac in (0.01, 0.05):
        v, i = C.topk_sparsify(xc, frac)
        same(f"topk_sparsify {frac}", (v, i), C.topk_sparsify(x, frac))
        same(f"topk_densify {frac}", C.topk_densify(v, i, x.shape),
             C.topk_densify(*C.topk_sparsify(x, frac), x.shape))
    for name, fn in (("ef_compress_int8", C.ef_compress_int8),
                     ("ef_compress_topk", C.ef_compress_topk)):
        res_c, res_g = C.ef_init({"w": x}), C.ef_init({"w": xc})
        for step in range(2):
            sent_c, res_c = fn({"w": xs[step]}, res_c)
            sent_g, res_g = fn({"w": xs[step].cuda()}, res_g)
            same(f"{name} step {step}", (sent_g["w"], res_g["w"]),
                 (sent_c["w"], res_c["w"]))
    mesh = HostSimMesh(8, "pod")
    t0 = time.perf_counter()
    got = C.compressed_psum_int8([t.cuda() for t in xs], mesh)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    same("compressed_psum_int8 over 8", got, C.compressed_psum_int8(xs, mesh))
    print(f"[shims] bit-equal on the card and the CPU: {', '.join(checks)} "
          f"(1024 x 3072 f32; compressed_psum_int8 of 8 members "
          f"{dt * 1e3:.2f} ms of host)  [{stamp}]", flush=True)

    cfg = get_config(DECODE_ARCH)
    B, T, H, Dh = DECODE_BATCH, DECODE_CACHE, cfg.num_heads, cfg.head_dim
    gd = torch.Generator(device="cuda").manual_seed(4)
    # the query as a caller passes it: the combine takes raw q.k scores, so
    # the attention's Dh^-0.5 is folded into q
    q = torch.randn(B, H, Dh, generator=gd, device="cuda") * Dh ** -0.5
    k = torch.randn(B, T, H, Dh, generator=gd, device="cuda")
    v = torch.randn(B, T, H, Dh, generator=gd, device="cuda")
    pos = torch.tensor([0, 511, 512, 1000, 2047, 2048, 4000, T - 1][:B],
                       dtype=torch.int32, device="cuda")
    fn = flash_decode_attention(HostSimMesh(8, "model"), "model")
    out = fn(q, k, v, pos)
    s = torch.einsum("bhe,bthe->bht", q, k)
    mask = torch.arange(T, device="cuda")[None, :] <= pos[:, None]
    s = torch.where(mask[:, None, :], s, torch.full((), -1e30,
                                                    device="cuda"))
    ref = torch.einsum("bht,bthe->bhe", torch.softmax(s, -1), v)
    err = float((out - ref).abs().max())
    s64 = torch.where(mask[:, None, :], torch.einsum(
        "bhe,bthe->bht", q.double(), k.double()), -1e30)
    exact = torch.einsum("bht,bthe->bhe", torch.softmax(s64, -1), v.double())
    print(f"[shims] flash_decode_attention over 8 members at {DECODE_ARCH}'s "
          f"decode shape (B {B}, cache {T}, H {H}, Dh {Dh}), f32: max |diff| "
          f"to the full masked softmax attention in f32 {err:.3e} (limit "
          f"1e-5); to the same in f64 {float((out - exact).abs().max()):.3e}, "
          f"the f32 attention's own {float((ref - exact).abs().max()):.3e}  "
          f"[{stamp}]", flush=True)
    if not err <= 1e-5:
        fail(f"flash_decode_attention {err} from the full attention")
    return {"checks": checks, "flash_decode_err": err}


def _pipeline(torch, stamp: str):
    """(b): llama3.2-3b's 28 seeded bf16 layers through the GPipe schedule
    against the same layers in sequence."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.pp import make_pipeline_fn
    from repro_torch.launch.mesh import HostSimMesh
    from repro_torch.models.params import init_params, stack_decls, tree_map
    from repro_torch.models.transformer import decls_layer, pipeline_stage

    cfg = get_config(TRAIN_ARCH)
    n, per = cfg.num_layers, cfg.num_layers // PIPE_STAGES
    stack = init_params(stack_decls(decls_layer(cfg), n),
                        torch.Generator(device="cuda").manual_seed(5), "cuda",
                        dtype_override=torch.bfloat16)
    staged = tree_map(lambda a: a.view(PIPE_STAGES, per, *a.shape[1:]), stack)
    g = torch.Generator(device="cuda").manual_seed(6)
    h = torch.randn(PIPE_MICRO, 1, PIPE_TOKENS, cfg.d_model, generator=g,
                    device="cuda").to(torch.bfloat16)

    run_layers = pipeline_stage(cfg)
    pipe = make_pipeline_fn(run_layers, PIPE_STAGES, PIPE_MICRO,
                            HostSimMesh(PIPE_STAGES, "stage"))
    with torch.no_grad():
        pipe(staged, h)                                   # warm-up
        torch.cuda.synchronize()
        counts = _zero_counts()
        t0 = time.perf_counter()
        got = pipe(staged, h)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = counts()
        seq = []
        for mb in h:
            for s in range(PIPE_STAGES):
                mb = run_layers(tree_map(lambda a, s=s: a[s], staged), mb)
            seq.append(mb)
        seq = torch.stack(seq)
        whole = run_layers(stack, h.reshape(PIPE_MICRO, PIPE_TOKENS,
                                            cfg.d_model)).view_as(h)
    torch.cuda.synchronize()
    gap = float((got.float() - whole.float()).abs().max()
                / whole.float().abs().max())
    want = n * PIPE_MICRO
    print(f"[pipeline] {TRAIN_ARCH}'s {n} seeded bf16 layers, "
          f"{PIPE_STAGES} stages of {per}, {PIPE_MICRO} microbatches of 1 x "
          f"{PIPE_TOKENS}: {PIPE_STAGES + PIPE_MICRO - 1} ticks in "
          f"{dt * 1e3:.1f} ms; launches {launches} (flash_attention "
          f"expected {want}); bit-equal to the layers in sequence on each "
          f"microbatch: {torch.equal(got, seq)}; gap to the sequence on the "
          f"whole batch {gap:.3e} of its largest  [{stamp}]", flush=True)
    if not torch.isfinite(got).all():
        fail("the pipeline's outputs are not finite")
    if not torch.equal(got, seq):
        fail("the pipeline differs from the layers run in sequence")
    if launches["flash_attention"] != want or any(
            c for k, c in launches.items() if k != "flash_attention"):
        fail(f"pipeline launches {launches}, expected {want} flash_attention")
    return {"flash_attention": launches["flash_attention"], "ms": dt * 1e3,
            "whole_batch_gap": gap}


def _dryrun_rows() -> tuple:
    """(c) in a child process: the dry-run of every LM arch x applicable
    shape x mesh, as (its lines, the cells that failed, its seconds)."""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    from repro_torch.configs import SHAPES_BY_NAME
    from repro_torch.launch import dryrun

    lines, errors = [], []
    t0 = time.perf_counter()
    for mesh in ("single", "multi"):
        for arch in dryrun.lm_archs():
            for shape in SHAPES_BY_NAME:
                t = time.perf_counter()
                try:
                    res = dryrun.run_cell(arch, shape, mesh, traced=False)
                except Exception as e:  # noqa: BLE001 — every cell is tried
                    errors.append(f"{mesh}/{arch}/{shape}: "
                                  f"{type(e).__name__}: {e}")
                    continue
                if res["skipped"]:
                    continue
                lines.append(
                    f"[dryrun] {mesh}/{arch}/{shape}: params "
                    f"{res['params_total']}, argument "
                    f"{res['memory']['argument_bytes'] / 2**30:.3f} GiB a "
                    f"device, {res['cost']['flops_per_device']:.4e} FLOP a "
                    f"device, {time.perf_counter() - t:.2f} s of host")
    return lines, errors, time.perf_counter() - t0


def _dryrun_child(conn):
    try:
        conn.send(("ok", _dryrun_rows()))
    except BaseException as e:                  # reported by the parent
        conn.send(("error", f"{type(e).__name__}: {e}"))
    conn.close()


def start_dryrun_cells():
    """Starts (c) in a child process (spawned, daemonic), so that its host
    work runs beside phase 14 and 15 (a)-(b); ``_dryrun_cells`` reads it."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    conn, child = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=_dryrun_child, args=(child,),
                       name="dry-run cells", daemon=True)
    proc.start()
    child.close()
    return proc, conn, time.perf_counter()


def _dryrun_cells(stamp: str, job) -> int:
    """(c): the child's lines printed; fails on any cell that failed."""
    proc, conn, t_start = job
    t0 = time.perf_counter()
    if not conn.poll(DRYRUN_CELLS_S):
        proc.kill()
        fail(f"the dry-run's cells gave no result in {DRYRUN_CELLS_S} s")
    status, got = conn.recv()
    proc.join(30)
    if status != "ok":
        fail(f"the dry-run's cells: {got}")
    lines, errors, secs = got
    for line in lines:
        print(line, flush=True)
    if errors:
        fail(f"dry-run cells failed: {errors}")
    print(f"[dryrun] {len(lines)} cells in {secs:.1f} s of host, in a child "
          f"process started {t0 - t_start:.1f} s before this phase read it "
          f"(waited {time.perf_counter() - t0:.1f} s)", flush=True)
    return len(lines)


def phase_accounting(torch, stamp: str, train_entry: dict,
                     step_peak_28: int, cells_job) -> dict:
    """Phase 15: the dry-run's accounting held against the card, the
    distributed shims held to the CPU, the pipeline, every dry-run cell."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    card = _account_vs_card(torch, stamp, train_entry, step_peak_28)
    torch.cuda.empty_cache()
    shims = _shims_vs_cpu(torch, stamp)
    torch.cuda.empty_cache()
    pipe = _pipeline(torch, stamp)
    torch.cuda.empty_cache()
    cells = _dryrun_cells(stamp, cells_job)
    print(f"[account] phase 15 in {time.perf_counter() - t_phase:.1f} s  "
          f"[{stamp}]", flush=True)
    return {"card": card, "shims": shims, "pipeline": pipe,
            "cells": cells}


GROUP_TIMED_STEPS = 3       # each rank's warm global steps, as phase 9's
GROUP_JOIN_S = 600          # a spawn's join timeout
DRYRUN_CELLS_S = 600        # phase 15 (c)'s child, once phase 15 reads it


def _same(a, b) -> bool:
    """Bit-equal: dtype, shape and bytes (a -0.0 is not a +0.0)."""
    import numpy as np
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def _first_difference(got: dict, want: dict, label: str):
    """The first leaf (in name order) where two named-array dicts differ,
    with its size, or None."""
    import numpy as np
    if got.keys() != want.keys():
        return f"{label}: leaves {sorted(set(got) ^ set(want))} differ"
    for k in sorted(want):
        if not _same(got[k], want[k]):
            a, b = np.asarray(got[k], np.float64), np.asarray(want[k],
                                                             np.float64)
            size = (float(np.abs(a - b).max()) if a.shape == b.shape
                    else f"shapes {a.shape} {b.shape}")
            return f"{label}: first leaf {k} differs, max |diff| {size}"
    return None


def _hold_group_rank(r: int, got: dict, ref: dict) -> list:
    """Where rank r's run differs from phase 9's partition r."""
    import numpy as np
    bad = []
    a, b = got["losses"][r], ref["losses"][r]
    if not _same(np.array(a), np.array(b)):
        step = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                    min(len(a), len(b)))
        bad.append(f"rank {r}: losses first differ at step {step} "
                   f"({a[step:step + 1]} vs {b[step:step + 1]})")
    for key in ("state", "restored_state"):
        diff = _first_difference(got[key], ref[key], f"rank {r} {key}")
        if diff:
            bad.append(diff)
    for key in ("report", "global_steps", "acc", "restored_acc",
                "restored_step", "restored_global_steps", "cache_hit_rate",
                "halo_hit_rate", "halo_exchange_bytes", "fused_grad_calls"):
        if got[key] != ref[key]:
            bad.append(f"rank {r}: {key} {got[key]} vs {ref[key]}")
    if not _same(got["halo_rows"][r], ref["halo_rows"][r]):
        bad.append(f"rank {r}: halo rows differ")
    return bad


def _group_train(torch, stamp: str, multipart: dict) -> dict:
    """(a): phase 9's run as 2 gloo ranks sharing the card."""
    import numpy as np

    from repro_torch.launch.group import spawn_partitions
    from repro_torch.launch.train import build_parser, gnn_rank
    ref = multipart["ref"]
    ckpt = Path(tempfile.mkdtemp(prefix="chip_smoke_group_"))
    try:
        args = build_parser().parse_args(MULTIPART_ARGS +
                                         ["--ckpt-dir", str(ckpt)])
        t0 = time.perf_counter()
        ranks = spawn_partitions(gnn_rank, 2, "gloo", ["cuda:0", "cuda:0"],
                                 args=(args, None, GROUP_TIMED_STEPS, True),
                                 timeout=GROUP_JOIN_S)
        wall = time.perf_counter() - t0
        step = ranks[0]["restored_step"]
        with np.load(ckpt / f"step_{step:09d}" / "shard_0.npz") as z:
            disk = {k: z[k] for k in z.files}
        manifest = json.loads(
            (ckpt / f"step_{step:09d}" / "MANIFEST.json").read_text())
        shards = sorted(p.name for p in ckpt.glob("step_*/shard_*.npz"))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    for line in ranks[0]["stdout"].splitlines():
        print(f"{line}  [rank 0 of 2, gloo; {stamp}]", flush=True)
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
    print(f"[group] (a) {ARCH} fused, full width, 2 gloo ranks sharing "
          f"cuda:0 (phase 9's arguments, run_gnn_multipartition as each "
          f"rank's code): launches by rank {[r['launches'] for r in ranks]}, "
          f"summed {launches} (phase 9: {multipart['fused']}); spawn to "
          f"both results {wall:.2f} s host, incl. each rank's start, graph, "
          f"two plans and {GROUP_TIMED_STEPS} timed steps  [{stamp}]",
          flush=True)
    if launches != multipart["fused"]:
        fail(f"the group run's launches {launches}, phase 9's "
             f"{multipart['fused']}")
    bad = [d for r, got in enumerate(ranks)
           for d in _hold_group_rank(r, got, ref)]
    diff = _first_difference(disk, ref["ckpt"], f"checkpoint step {step}")
    if diff:
        bad.append(diff)
    manifest.pop("time")
    want_manifest = {k: v for k, v in ref["manifest"].items() if k != "time"}
    if manifest != want_manifest:
        bad.append("the checkpoint's MANIFEST.json differs")
    leaked = sorted({m for r in ranks for m in r["modules"]}
                    & {"jax", "repro"})
    print(f"[check] (a) against phase 9's host-simulated run on the same "
          f"card: each partition's {len(ref['losses'][0])} losses, params "
          f"and opt_state ({len(ref['state'])} leaves), the restored "
          f"trainer's, accuracy {ranks[0]['acc']} (phase 9 {ref['acc']}), "
          f"cache hit rate {ranks[0]['cache_hit_rate']}, halo hit rate "
          f"{ranks[0]['halo_hit_rate']}, each partition's halo rows through "
          f"its plane ({[len(ref['halo_rows'][p]) for p in (0, 1)]}), the "
          f"step-{step} checkpoint ({shards}, {len(disk)} arrays) and its "
          f"manifest: {'bit-equal' if not bad else bad}; the ranks imported "
          f"{leaked or 'neither jax nor repro'}", flush=True)
    if bad:
        fail(f"the group run differs from phase 9: {bad[0]}")
    if leaked:
        fail(f"a rank imported {leaked}")
    meds = [float(np.median(r["step_seconds"])) * 1e3 for r in ranks]
    print(f"[group] (a) median of {GROUP_TIMED_STEPS} warm global steps: "
          f"rank 0 {meds[0]:.1f} ms, rank 1 {meds[1]:.1f} ms (each "
          f"{[round(w * 1e3, 1) for w in ranks[0]['step_seconds']]}, "
          f"{[round(w * 1e3, 1) for w in ranks[1]['step_seconds']]}); phase "
          f"9's 2 partitions in one process {ref['step_ms']:.1f} ms  "
          f"[{stamp}]", flush=True)
    return {"launches": launches, "step_ms": meds, "wall": wall}


def _group_shim_inputs(torch, n: int, seed: int) -> dict:
    import numpy as np

    from repro_torch.configs import get_config
    cfg = get_config(DECODE_ARCH)
    g = torch.Generator().manual_seed(seed)
    x = [torch.randn(1024, 3072, generator=g).numpy() for _ in range(n)]
    return {"compress": x, "crosspod": [{"w": a[:256]} for a in x],
            "grad_trees": [{"w": a[:64], "z": np.full(8, -0.0, np.float32)}
                           for a in x],
            "decode": {"shape": (DECODE_BATCH, DECODE_CACHE, cfg.num_heads,
                                 cfg.head_dim), "seed": seed},
            "objects": f"{n} ranks"}


def _hold_group_shims(torch, got: list, inputs: dict, n: int) -> list:
    """Each rank's outputs against the host-simulated forms on the card."""
    from repro_torch.distributed.collectives import (flash_decode_attention,
                                                     grad_allreduce)
    from repro_torch.launch.group import decode_inputs
    from repro_torch.launch.mesh import HostSimMesh
    from repro_torch.train.compression import compressed_psum_int8

    def cuda(a):
        return torch.from_numpy(a).cuda()

    want = {
        "compress": compressed_psum_int8(
            [cuda(a) for a in inputs["compress"]], HostSimMesh(n, "pod")),
        "crosspod": compressed_psum_int8(
            [cuda(t["w"]) for t in inputs["crosspod"]],
            HostSimMesh(n, "pod")),
        "decode": flash_decode_attention(HostSimMesh(n, "model"), "model")(
            *decode_inputs(inputs["decode"]["shape"],
                           inputs["decode"]["seed"], "cuda"))}
    mean = grad_allreduce(HostSimMesh(n))(
        [{k: cuda(v) for k, v in t.items()} for t in inputs["grad_trees"]])
    bad = []
    for r, out in enumerate(got):
        for key in ("compress", "decode"):
            if not _same(out[key], want[key].cpu().numpy()):
                bad.append(f"rank {r}: {key}")
        if not _same(out["crosspod"]["w"], want["crosspod"].cpu().numpy()):
            bad.append(f"rank {r}: crosspod")
        for k, v in mean.items():
            if not _same(out["grad_trees"][k], v.cpu().numpy()):
                bad.append(f"rank {r}: grad_allreduce {k}")
        if out["objects"] != [(q, inputs["objects"]) for q in range(n)]:
            bad.append(f"rank {r}: all_gather_objects {out['objects']}")
        leaked = {"jax", "repro"} & set(out["modules"])
        if leaked:
            bad.append(f"rank {r} imported {sorted(leaked)}")
    return bad


def _group_shims(torch, stamp: str, n: int, backend: str) -> dict:
    """(b) and (c): every group collective over ``n`` ranks on cuda:0."""
    from repro_torch.launch.group import collectives_rank, spawn_partitions
    inputs = _group_shim_inputs(torch, n, 16 + n)
    t0 = time.perf_counter()
    got = spawn_partitions(collectives_rank, n, backend, ["cuda:0"] * n,
                           args=(inputs,), timeout=GROUP_JOIN_S)
    wall = time.perf_counter() - t0
    bad = _hold_group_shims(torch, got, inputs, n)
    B, T, H, Dh = inputs["decode"]["shape"]
    verdict = ("each bit-equal to its host-simulated form on the card"
               if not bad else bad)
    print(f"[group] ({'b' if backend == 'nccl' else 'c'}) {n} {backend} "
          f"rank(s) on cuda:0: grad_allreduce (one all_gather of the "
          f"tree's bytes, uint8; a leaf of -0.0), compressed_psum_int8 and "
          f"the cross-pod transform (f32 all_reduce MAX, int8 all_gather; "
          f"1024 x 3072 f32 a member), flash_decode_attention at "
          f"{DECODE_ARCH}'s decode shape (B {B}, cache {T}, H {H}, Dh {Dh}, "
          f"f32 all_gather of the partials), all_gather_objects: "
          f"{verdict}; "
          f"spawn to results {wall:.2f} s host  [{stamp}]", flush=True)
    if bad:
        fail(f"group collectives over {n} {backend} rank(s): {bad[0]}")
    return {"wall": wall}


def phase_group(torch, stamp: str, multipart: dict) -> dict:
    """Phase 16: the partition mesh as a torch.distributed group on the
    card."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    # (b) and (c), one spawn after the other, beside (a)'s ranks
    with _beside(lambda: (_group_shims(torch, stamp, 1, "nccl"),
                          _group_shims(torch, stamp, 2, "gloo"))) as shims:
        train = _group_train(torch, stamp, multipart)
    nccl, shims = shims["result"]
    print("[group] halo_all_to_all over one member moves no row (a "
          "one-partition plan has no halo); over nccl it runs in the "
          "two-rank run", flush=True)
    if torch.cuda.device_count() < 2:
        print(f"[group] the two-rank NCCL run needs a second card: this "
              f"machine has {torch.cuda.device_count()} "
              f"(scripts/group_nccl.py runs (a) and the collectives over "
              f"nccl, a card a rank, where there are two)", flush=True)
    print(f"[group] phase 16 in {time.perf_counter() - t_phase:.1f} s  "
          f"[{stamp}]", flush=True)
    return {"train": train, "nccl": nccl, "shims": shims}


# phase 17: the fleet's live reconfiguration as 2 gloo ranks on the card
LIVE_EPISODE_STEPS = 4      # global steps an auto-tuner episode
LIVE_ARGS = ["--arch", ARCH, "--partitions", "2", "--halo-budget", "4096",
             "--sampling-device", "device", "--fused-gather-agg",
             "--halo-refresh-interval", "2", "--steps",
             str(LIVE_EPISODE_STEPS), "--episodes-autotune", "3"]
LIVE_EDGES = 50_000         # seeded random edges added on every rank
LIVE_STREAMED = 64          # halo rows of each partition updated
LIVE_OPS = [("halo", 0), ("steps", 2), ("halo", 4096), ("steps", 2),
            ("edges", (17, LIVE_EDGES)), ("rebalance", None), ("steps", 2),
            ("update", (19, LIVE_STREAMED)), ("steps", 2), ("snapshot", None)]
# (b): episodes 1..; episode 0 measures the seed configuration (2
# partitions, a 4,096-row halo, γ 2, Θ 40 MB)
LIVE_SCRIPT = [dict(bias_rate=4.0, cache_volume_mb=20.0, partitions=1,
                    halo_budget=0),
               dict(bias_rate=1.5, cache_volume_mb=40.0, partitions=2,
                    halo_budget=2048),
               dict(bias_rate=2.0, cache_volume_mb=30.0, partitions=2,
                    halo_budget=4096)]
LIVE_SCRIPT = [dict(c, parallel_mode="seq", workers=1) for c in LIVE_SCRIPT]
LIVE_TUNER = dict(presample=32, surrogate_trees=8, ppo_updates=1,
                  ppo_horizon=4)
LIVE_SCRIPTED = dict(LIVE_TUNER, episodes=len(LIVE_SCRIPT) + 1,
                     warmup_steps=1, max_partitions=2, max_halo_budget=4096,
                     w_throughput=0.0, w_memory=1.0, w_accuracy=0.0,
                     throughput_source="wallclock", script=LIVE_SCRIPT)
LIVE_UNSCRIPTED = dict(LIVE_TUNER, episodes=3, warmup_steps=0,
                       throughput_source="wallclock")
LIVE_SEQUENCE = LIVE_OPS + [("autotune", LIVE_SCRIPTED), ("snapshot", None),
                            ("autotune", LIVE_UNSCRIPTED)]
EPISODE_KEYS = ("index", "config", "reward", "cache_hit_rate", "steps")


@contextlib.contextmanager
def _beside(fn):
    """Runs ``fn()`` in a thread while the ``with`` body runs; on exit,
    joins it and fills the yielded dict's ``result`` and ``seconds`` (or
    raises what ``fn`` raised)."""
    import threading
    box = {}

    def run():
        t0 = time.perf_counter()
        try:
            box["result"] = fn()
        except BaseException as e:              # re-raised in the caller
            box["error"] = e
        box["seconds"] = time.perf_counter() - t0
    th = threading.Thread(target=run, name="beside", daemon=True)
    th.start()
    try:
        yield box
    finally:
        th.join()
    if "error" in box:
        raise box["error"]


def _hold_summary(r: int, got: dict, want: dict, label: str) -> list:
    """Where rank r's ``fleet_summary`` differs from the reference's."""
    bad = []
    if (got["partitions"], got["held"]) != (want["partitions"],
                                            r < want["partitions"]):
        return [f"{label}: rank {r} holds {got['partitions'], got['held']}"]
    if not got["held"]:
        return bad
    diff = _first_difference(got["state"], want["state"],
                             f"{label} rank {r} state")
    bad += [diff] if diff else []
    for key in ("cache_hit_rate", "halo_hit_rate", "manifest"):
        if got[key] != want[key]:
            bad.append(f"{label}: rank {r} {key} {got[key]} vs {want[key]}")
    if "halo_rows" in want and not _same(got["halo_rows"][r],
                                         want["halo_rows"][r]):
        bad.append(f"{label}: rank {r} halo rows differ")
    return bad


def _hold_live_rank(r: int, got: dict, ref: dict) -> list:
    """Where rank r's ``autotune_rank`` run of ``LIVE_SEQUENCE`` differs
    from the host-simulated reference's, up to the unscripted run (c)."""
    import numpy as np
    bad = []
    for i, (g, w) in enumerate(zip(got["ops"], ref["ops"])):
        label = f"op {i} {w['op']}"
        if w["op"] == "snapshot":
            bad += _hold_summary(r, g, w, label)
        elif w["op"] == "autotune" and "script" in LIVE_SEQUENCE[i][1]:
            for eg, ew in zip(g["episodes"], w["episodes"], strict=True):
                for key in EPISODE_KEYS:
                    if eg[key] != ew[key]:
                        bad.append(f"{label} episode {ew['index']}: rank {r} "
                                   f"{key} {eg[key]} vs {ew[key]}")
                for key in ("memory", "accuracy"):
                    if eg["metrics"][key] != ew["metrics"][key]:
                        bad.append(f"{label} episode {ew['index']}: rank {r} "
                                   f"{key} {eg['metrics'][key]} vs "
                                   f"{ew['metrics'][key]}")
            for k, (lg, lw) in enumerate(zip(g["losses"], w["losses"])):
                holds = w["episodes"][k]["config"]["partitions"] > r
                if holds and not _same(np.array(lg), np.array(lw)):
                    bad.append(f"{label} episode {k}: rank {r} losses")
            for key in ("best", "manifests"):
                if g[key] != w[key]:
                    bad.append(f"{label}: rank {r} {key} differs")
        elif w["op"] != "autotune":
            for key, value in w.items():
                if key.endswith("seconds"):
                    continue
                if key == "losses":
                    if not _same(np.array(g[key][r]), np.array(value[r])):
                        bad.append(f"{label}: rank {r} losses "
                                   f"{g[key][r]} vs {value[r]}")
                elif g[key] != value:
                    bad.append(f"{label}: rank {r} {key} {g[key]} vs "
                               f"{value}")
    return bad


def predicted_launches(run: dict, parts: int) -> int:
    """``gather_aggregate`` launches of a run of ``LIVE_SEQUENCE`` summed
    over the partitions: one a partition's fused step (the global steps
    of the live operations, each auto-tuner run's warm-up steps at its
    starting partition count and its episodes' per-partition steps)."""
    n = 0
    for (name, arg), rec in zip(LIVE_SEQUENCE, run["ops"]):
        if name == "steps":
            n += int(arg) * parts
        elif name == "autotune":
            n += arg.get("warmup_steps", 0) * \
                rec["episodes"][0]["config"].get("partitions", parts)
            n += sum(ep["steps"] for ep in rec["episodes"])
            parts = rec["episodes"][rec["best"]]["config"].get("partitions",
                                                                parts)
    return n


def _live_lines(ranks: list, ref: dict, stamp: str):
    """Each operation's host seconds, each episode's broadcast throughput
    beside the reference's and each rank's own MEASURE wall."""
    for i, (name, _) in enumerate(LIVE_SEQUENCE[:len(ref["ops"])]):
        w = ref["ops"][i]
        secs = [r["ops"][i]["seconds"] for r in ranks]
        extra = ""
        if name == "steps" and w.get("refresh_seconds"):
            extra = (f"; periodic halo refresh "
                     f"{[[round(s, 4) for s in r['ops'][i]['refresh_seconds']] for r in ranks]}"
                     f" s (reference "
                     f"{[round(s, 4) for s in w['refresh_seconds']]})")
        if name == "autotune":
            def restarts(rec):
                return [round(s, 3) for k, s in rec["reconfigure_seconds"]
                        if k == "restart"]
            extra = (f"; restarts by rank "
                     f"{[restarts(r['ops'][i]) for r in ranks]} s "
                     f"(reference {restarts(w)})")
        print(f"[live] op {i} {name}: host s rank 0 {secs[0]:.3f}, rank 1 "
              f"{secs[1]:.3f}, reference {w['seconds']:.3f}{extra}  "
              f"[{stamp}]", flush=True)
        if name != "autotune":
            continue
        for k, ep in enumerate(ranks[0]["ops"][i]["episodes"]):
            c = ep["config"]
            walls = [r["ops"][i]["t_walls"][k] for r in ranks]
            print(f"[live]   episode {k}: p={c.get('partitions')} "
                  f"halo={c.get('halo_budget')} γ={c['bias_rate']:.2f} "
                  f"Θ={c['cache_volume_mb']:.2f}MB mode={c['parallel_mode']}"
                  f" w={int(c['workers'])} | fleet "
                  f"{ep['metrics']['throughput']:.2f} mini-batches/s "
                  f"(reference {w['episodes'][k]['metrics']['throughput']:.2f}"
                  f"; rank walls "
                  f"{['no partition' if t is None else round(t, 3) for t in walls]}"
                  f" s) mem={ep['metrics']['memory'] / 2**20:.1f} MiB "
                  f"acc={ep['metrics']['accuracy']:.4f} "
                  f"hit={ep['cache_hit_rate']:.3f}  [{stamp}]", flush=True)


def hold_live(ranks: list, ref: dict, stamp: str, label: str):
    """Print and hold ranks' ``autotune_rank`` runs of ``LIVE_SEQUENCE``
    (or its first ops) against the host-simulated reference ``ref``: the
    launches summed over the ranks equal to the reference's and to the
    steps run, each rank bit-equal to the reference up to the unscripted
    run (c), which the ranks must agree on.  Returns the summed launches
    and the differences found."""
    _live_lines(ranks, ref, stamp)
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
    fused = predicted_launches(ref, 2)
    want = {"gather_aggregate": fused, "neighbor_agg": 2 * fused,
            "neighbor_agg_backward": 2 * fused, "flash_attention": 0,
            "reservoir_topm": 0}
    print(f"[live] {label}: launches by rank "
          f"{[r['launches'] for r in ranks]}, summed {launches}; the "
          f"reference's {ref['launches']}; predicted from the steps run "
          f"{want} (cache_gather: the halo rows read back through the "
          f"planes)  [{stamp}]", flush=True)
    bad = [f"launches {k}: {launches[k]} (reference {ref['launches'][k]}), "
           f"predicted {n}" for k, n in want.items()
           if not launches[k] == ref["launches"][k] == n]
    if launches["cache_gather"] != ref["launches"]["cache_gather"]:
        bad.append(f"cache_gather {launches['cache_gather']} vs the "
                   f"reference's {ref['launches']['cache_gather']}")
    bad += [d for r, got in enumerate(ranks)
            for d in _hold_live_rank(r, got, ref)]
    if len(ref["ops"]) == len(LIVE_SEQUENCE):               # (c) ran
        tuned = [r["ops"][-1] for r in ranks]
        if any(t["episodes"] != tuned[0]["episodes"]
               or t["best"] != tuned[0]["best"] for t in tuned):
            bad.append("(c): the ranks' reports differ")
        if ranks[1]["held"] and _first_difference(
                ranks[1]["state"], ranks[0]["state"], "(c)"):
            bad.append("(c): the ranks' final states differ")
    leaked = sorted({m for r in ranks for m in r["modules"]}
                    & {"jax", "repro"})
    if leaked:
        bad.append(f"a rank imported {leaked}")
    w = ref["ops"]
    print(f"[check] {label}: (a) halo 4096 -> 0 -> 4096, {LIVE_EDGES} edges "
          f"and a rebalance ({w[5]['moved_nodes']} nodes moved, cut "
          f"{w[5]['cut_before']:.4f} -> {w[5]['cut_after']:.4f}), "
          f"{w[7]['rows']} streamed rows refreshed "
          f"{w[8]['halo_refreshes']} time(s); (b) {len(LIVE_SCRIPT) + 1} "
          f"scripted episodes, partitions "
          f"{[e['config']['partitions'] for e in w[10]['episodes']]}, "
          f"{len(w[10]['manifests'])} restarts, best episode "
          f"{w[10]['best']}: every partition's losses, params and "
          f"opt_state, hit rates, manifests and halo rows against the "
          f"host-simulated reference, (c) across the ranks where it ran: "
          f"{'bit-equal' if not bad else bad}; the ranks imported "
          f"{leaked or 'neither jax nor repro'}", flush=True)
    return launches, bad


def phase_live(torch, stamp: str) -> dict:
    """Phase 17: the fleet's live reconfiguration as 2 gloo ranks sharing
    the card, against the same sequence host-simulated in this process."""
    from repro_torch.launch.group import spawn_partitions
    from repro_torch.launch.train import autotune_rank, build_parser
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    args = build_parser().parse_args(LIVE_ARGS)
    # the reference runs in a thread of this process while the ranks run
    # (the holds compare states and counts, never a clock across the two)
    with _beside(lambda: autotune_rank(0, "cuda:0", args,
                                       ops=LIVE_SEQUENCE)) as reference:
        t0 = time.perf_counter()
        ranks = spawn_partitions(autotune_rank, 2, "gloo",
                                 ["cuda:0", "cuda:0"],
                                 args=(args, None, None, LIVE_SEQUENCE),
                                 timeout=GROUP_JOIN_S)
        t_group = time.perf_counter() - t0
    ref, t_ref = reference["result"], reference["seconds"]
    launches, bad = hold_live(ranks, ref, stamp, "2 gloo ranks on cuda:0")
    if bad:
        fail(f"phase 17: {bad[0]}")
    secs = time.perf_counter() - t_phase
    print(f"[live] phase 17 in {secs:.1f} s (reference {t_ref:.1f} s, spawn "
          f"to both results {t_group:.1f} s)  [{stamp}]", flush=True)
    return {"launches": launches, "seconds": secs}

# phase 18: the GPipe pipeline over a stage group: llama3.2-3b's seeded
# bf16 layers (seeds 5 and 6) in 2 stages: 8 layers, cut from 28 so that
# the script keeps to its time limit with phase 19's three runs (the
# schedule, the send/recv between ticks and the hand-written backward are
# the same at any depth; phase 15 still runs the 28-layer pipeline)
PIPE_GROUP = {"stages": 2, "micro": PIPE_MICRO, "loss": "mean", "runs": 2,
              "lm": {"arch": TRAIN_ARCH, "num_layers": 8,
                     "dtype": "bfloat16", "seed": 5, "x_seed": 6,
                     "micro": PIPE_MICRO, "mb": 1, "tokens": PIPE_TOKENS}}


def _pipeline_launches(launches: dict, label: str) -> list:
    """Where a pipeline run's launches are not ``flash_attention`` forward
    and backward once a layer and microbatch each and nothing else."""
    want = PIPE_GROUP["lm"]["num_layers"] * PIPE_GROUP["micro"]
    return [f"{label}: {k} launched {n}, expected "
            f"{want if k.startswith('flash_attention') else 0}"
            for k, n in launches.items()
            if n != (want if k.startswith("flash_attention") else 0)]


def phase_pipeline(torch, stamp: str, backend: str = "gloo",
                   devices=("cuda:0", "cuda:0")) -> dict:
    """Phase 18: the pipeline as 2 ranks (``backend`` over ``devices``)
    held to the host-simulated pipeline on ``devices[0]``."""
    from repro_torch.launch.group import (pipeline_rank, spawn_partitions,
                                          tensor_digest)
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    ref = pipeline_rank(0, devices[0], PIPE_GROUP)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    want = {k: tensor_digest(v) for k, v in ref["values"].items()}
    t_digest = time.perf_counter() - t0
    bad = _pipeline_launches(ref["launches"], "the reference")
    t0 = time.perf_counter()
    ranks = spawn_partitions(pipeline_rank, 2, backend, list(devices),
                             args=({**PIPE_GROUP, "digest": True,
                                    "want": want},),
                             timeout=GROUP_JOIN_S)
    t_group = time.perf_counter() - t0
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
    bad += _pipeline_launches(launches, "summed over the ranks")
    if launches != ref["launches"]:
        bad.append(f"launches {launches}, the reference's {ref['launches']}")
    seen = set()
    for r, got in enumerate(ranks):
        seen |= set(got["values"])
        if got["differs"]:
            key, t = got["differs"]
            diff = float((t.float() - ref["values"][key].float()).abs().max())
            bad.append(f"rank {r}: first differing leaf {key}, max |diff| "
                       f"{diff:.3e}")
        bad += [f"rank {r}: {k} absent from the reference"
                for k in set(got["values"]) - set(want)]
    if seen != set(want):
        bad.append(f"no rank holds {sorted(set(want) - seen)}")
    leaked = sorted({m for r in ranks for m in r["modules"]}
                    & {"jax", "repro"})
    if leaked:
        bad.append(f"a rank imported {leaked}")
    del ref["values"]
    cfg = PIPE_GROUP["lm"]
    grads = sum(k.startswith("grad/") for k in want)
    print(f"[pipeline] {TRAIN_ARCH}'s {cfg['num_layers']} seeded bf16 "
          f"layers in 2 stages of {cfg['num_layers'] // 2}, "
          f"{PIPE_GROUP['micro']} microbatches of 1 x {cfg['tokens']}, "
          f"forward + backward of mean(out.float() ** 2), 2 {backend} ranks "
          f"on {', '.join(devices)}: launches by rank "
          f"{[r['launches'] for r in ranks]}, summed {launches} (the "
          f"host-simulated reference's {ref['launches']})  [{stamp}]",
          flush=True)
    print(f"[check] the outputs, the gradient of the microbatches and "
          f"{grads} parameter-gradient leaves (2 stages) against the "
          f"host-simulated pipeline on {devices[0]}, by SHA-256: "
          f"{'bit-equal' if not bad else bad}; the ranks imported "
          f"{leaked or 'neither jax nor repro'}", flush=True)
    for r, got in enumerate(ranks):
        for pass_ in ("forward", "backward"):
            ticks = [(t, sent) for p, t, sent, _ in got["traffic"]
                     if p == pass_ and sent]
            print(f"[pipeline] rank {r} {pass_}: sends "
                  f"{sum(n for _, n in ticks)} B over {len(ticks)} "
                  f"boundaries ({sorted({n for _, n in ticks})} B each, "
                  f"before ticks {[t for t, _ in ticks]})", flush=True)
    walls = [[round(w * 1e3, 1) for w in r["seconds"]] for r in ranks]
    ref_ms = [round(w * 1e3, 1) for w in ref["seconds"]]
    print(f"[pipeline] forward + backward wall (ms; warm-up, timed): rank 0 "
          f"{walls[0]}, rank 1 {walls[1]}; the host-simulated reference "
          f"{ref_ms}; reference digests {t_digest:.1f} s host, spawn to "
          f"both results {t_group:.1f} s  [{stamp}]", flush=True)
    if bad:
        fail(f"phase 18: {bad[0]}")
    secs = time.perf_counter() - t_phase
    print(f"[pipeline] phase 18 in {secs:.1f} s  [{stamp}]", flush=True)
    return {"flash_attention": launches["flash_attention"],
            "flash_attention_bwd": launches["flash_attention_bwd"],
            "rank_ms": [w[-1] for w in walls], "ref_ms": ref_ms[-1],
            "seconds": secs}


# phase 19: the sharded LM step over a (1, 2) mesh of 2 gloo ranks, from
# tame weights (``init_params``' seeded stack is chaotic: its loss 245.9,
# where ln V is 11.8, and a bf16 step's own gradient error the size of the
# gradient)
SHARDED_LM = {"arch": TRAIN_ARCH, "num_layers": 4, "dtype": "bfloat16",
              "seed": 11, "init": "fan_in", "batch": 2, "seq": 1024,
              "mesh": (1, 2), "steps": 3, "flash": (8, 4)}
# the hybrid and the encoder-decoder at full width, as SHARDED_LM: zamba2-7b
# with 6 Mamba2 layers (one application of the shared attention block,
# Dh 112, 16 of 32 heads a rank), whisper-medium with 2 + 2 layers over
# 1,500 frames and 2 x 448 tokens (its vocabulary of 51,865 is odd, so the
# embedding stays whole on the model axis).  ``flash``: the forward and
# backward flash_attention launches a rank in the first step (the "dots"
# recompute runs a remat'd layer's forward twice; zamba2's shared block is
# not remat'd)
SHARDED_ZAMBA = {"arch": "zamba2-7b", "num_layers": 6, "dtype": "bfloat16",
                 "seed": 13, "init": "fan_in", "batch": 2, "seq": 1024,
                 "mesh": (1, 2), "steps": 2, "flash": (1, 1),
                 "bounds": {"grad": 0.09, "param": 0.5}}
SHARDED_WHISPER = {"arch": "whisper-medium", "num_layers": 2,
                   "overrides": {"encoder_layers": 2}, "dtype": "bfloat16",
                   "seed": 17, "init": "fan_in", "batch": 2,
                   "seq": WHISPER_TOKENS, "mesh": (1, 2), "steps": 2,
                   "flash": (8, 4)}
SHARDED_RUNS = (SHARDED_LM, SHARDED_ZAMBA, SHARDED_WHISPER)
# a rank against the unsharded bf16 step from the same weights: the first
# step's loss, relative; each gradient leaf's ||g - g_ref|| / ||g_ref||;
# each parameter leaf's ||p - p_ref|| after the steps over the unsharded
# step's own move.  Set from readings on the card (PERF.md, PR 30): sound
# runs read loss 3.0e-5, gradients 1.85e-2 at worst, parameters 9.2e-2;
# with a fault planted (scripts/sharded_fault.py) the gradients read 0.72
# (the norm scales' all-reduce left out) and 0.105 (dK 10% off).  AdamW's
# sign-like steps hide both from the parameters (0.092, 0.101): their
# bound catches a gross fault only (a leaf left unchanged reads 1).
# whisper-medium reads within them (gradients 1.27e-2 sound, 0.73 and
# 0.1025 with the faults).  zamba2-7b reads wider (seeds 13 / 29:
# gradients 6.64e-2 / 7.19e-2 sound at ``conv_w``, 0.75 / 0.74 and
# 0.113 / 0.115 with the faults; parameters 0.306 / 0.319 sound), so its
# run carries its own ``bounds`` between those readings.  The width is the
# bf16 step's own: the unsharded bf16 step is itself 0.099 / 0.102 from an
# f32 witness at ``conv_w``, the sharded one 0.101 / 0.112, and the x
# columns, which no rank sums with another's, read as wide as B and C
# (scripts/sharded_grad_error.py; PERF.md).  Its parameter bound,
# as the shared one, catches a gross fault only.
SHARDED_LOSS_REL = 2 ** -10
SHARDED_GRAD_REL = 2 ** -4
SHARDED_PARAM_REL = 2 ** -2
SHARDED_CELLS = [(arch, multi) for arch in (TRAIN_ARCH, "qwen2-moe-a2.7b")
                 for multi in (False, True)]


def _sharded_counts(stamp: str, tracer) -> list:
    """(a): the collective bytes of the production train_4k cells."""
    from repro_torch.configs import SHAPES_BY_NAME, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    rows = []
    for arch, multi in SHARDED_CELLS:
        mesh = make_production_mesh(multi_pod=multi)
        t0 = time.perf_counter()
        got = dryrun.collectives(get_config(arch), SHAPES_BY_NAME["train_4k"],
                                 mesh, tracer)
        secs = time.perf_counter() - t0
        if not got["per_op"] or min(got["per_op"].values()) < 0 or \
                not set(got["per_op"]) <= set(dryrun.COLLECTIVE_OPS):
            fail(f"phase 19: {arch} {mesh.sizes} counted {got['per_op']}")
        probes = [round(c["seconds"], 2) for c in got["probes"]]
        ops = ", ".join(f"{k} {v / 2**30:.3f}"
                        for k, v in got["per_op"].items())
        print(f"[sharded] dry-run collectives, {arch} train_4k on "
              f"{mesh.sizes}: {got['total'] / 2**30:.3f} GiB a device a "
              f"step ({ops} GiB), probe traces {probes} s, {secs:.1f} s of "
              f"host  [{stamp}]", flush=True)
        rows.append({"arch": arch, "mesh": mesh.sizes,
                     "per_op": got["per_op"], "seconds": secs})
    return rows


def phase_sharded(torch, stamp: str, devices=("cuda:0", "cuda:0"),
                  backend: str = "gloo-host", specs=None,
                  cells: bool = True, rank=None) -> dict:
    """Phase 19: (a) the dry-run's collective bytes (where ``cells``), (b)
    the sharded step of each of ``specs`` (``SHARDED_RUNS`` by default) as
    a rank (``rank``, ``sharded_lm_rank`` by default) on each of
    ``devices`` over ``backend``, held to the unsharded step on
    ``devices[0]``: the references in this process (each kept in a temp
    file), and one spawn whose ranks run every spec in turn
    (``launch.group.sharded_runs_rank``); the dry-run's traces in the
    tracer's children meanwhile.  Over ``gloo-host`` every collective's
    buffer passes through the host, so that run checks the step and
    times no rank, and its references run in a thread beside the ranks;
    elsewhere they run first (``scripts/group_nccl.py`` step 7 times the
    ranks over ``nccl``)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.group import (HOST_STAGED, lm_config,
                                          sharded_lm_rank,
                                          sharded_runs_rank,
                                          spawn_partitions)
    from repro_torch.launch.mesh import AbstractMesh
    t_phase = time.perf_counter()
    specs = specs or SHARDED_RUNS

    def traces():
        # host work in the tracer's child processes, beside the card's
        with dryrun.CollectiveTracer() as tracer:
            rows = _sharded_counts(stamp, tracer) if cells else []
            return rows, [dryrun.count_collectives(
                lm_config(spec),
                ShapeConfig("sharded", "train", spec["seq"], spec["batch"]),
                AbstractMesh(spec["mesh"], ("data", "model")), tracer)
                for spec in specs]
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_sharded_"))
    paths = [tmp / f"ref{i}.pt" for i in range(len(specs))]

    def references():
        # each file renamed into place whole: a rank reads a spec's once
        # its own run of that spec is done (launch.group.when_written)
        refs = []
        try:
            for spec, path in zip(specs, paths):
                torch.cuda.empty_cache()
                ref = sharded_lm_rank(0, devices[0], spec)
                part = path.with_name(path.name + ".part")
                torch.save({"grads": ref.pop("grads"),
                            "params": ref.pop("params"),
                            "moves": ref["moves"]}, part)
                part.replace(path)
                refs.append(ref)
        except BaseException as e:
            for path in paths[len(refs):]:
                path.with_name(path.name + ".failed").write_text(
                    f"{type(e).__name__}: {e}")
            raise
        return refs
    with _beside(traces) as traced:
        try:
            # where no rank is timed, the references run beside the ranks
            refd = (_beside(references) if backend == HOST_STAGED else
                    contextlib.nullcontext({"result": references()}))
            with refd as referenced:
                t0 = time.perf_counter()
                ranks = spawn_partitions(
                    sharded_runs_rank, len(devices), backend, list(devices),
                    args=([{**spec, "ref": str(path)}
                           for spec, path in zip(specs, paths)], rank),
                    timeout=GROUP_JOIN_S)
                t_group = time.perf_counter() - t0
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    refs = referenced["result"]
    cells, wants = traced["result"]
    print(f"[sharded] the dry-run's traces, in the tracer's children "
          f"beside the card's runs: {traced['seconds']:.1f} s  [{stamp}]",
          flush=True)
    print(f"[sharded] {len(devices)} {backend} ranks: spawn to every "
          f"result of {len(specs)} runs {t_group:.1f} s  [{stamp}]",
          flush=True)
    runs = [_hold_sharded(stamp, devices, backend, spec, want, ref,
                          [r[i] for r in ranks])
            for i, (spec, want, ref) in enumerate(zip(specs, wants, refs))]
    secs = time.perf_counter() - t_phase
    print(f"[sharded] phase 19 in {secs:.1f} s  [{stamp}]", flush=True)
    return {"cells": cells, "runs": runs,
            "flash_attention": sum(r["flash_attention"] for r in runs),
            "flash_attention_bwd": sum(r["flash_attention_bwd"]
                                       for r in runs),
            "seconds": secs}


def _hold_sharded(stamp: str, devices, backend: str, spec: dict,
                  want: dict, ref: dict, ranks: list) -> dict:
    """Phase 19 (b) of one ``spec``: each rank's result held to the
    unsharded step ``ref`` and to the trace ``want`` (its collective bytes
    and its peak memory)."""
    from repro_torch.launch.footprint import peak_tolerance
    from repro_torch.launch.group import HOST_STAGED
    n = len(devices)
    arch, L = spec["arch"], spec["num_layers"]
    fwd, bwd = spec["flash"]
    bounds = {"grad_err": SHARDED_GRAD_REL, "param_err": SHARDED_PARAM_REL}
    bounds.update({f"{k}_err": v for k, v in spec.get("bounds", {}).items()})
    flash = {"flash_attention": fwd, "flash_attention_bwd": bwd}
    bad = []
    for r, got in enumerate(ranks):
        loss_rel = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
        worst = {key: sorted(got[key].items(), key=lambda kv: -kv[1])[:3]
                 for key in ("grad_err", "param_err")}
        print(f"[sharded] {arch} rank {r}: loss {got['loss']:.6f} against "
              f"the unsharded step's {ref['loss']:.6f} (relative "
              f"{loss_rel:.3e}, bound {SHARDED_LOSS_REL:.3e}); worst "
              f"gradient leaves ||g - g_ref|| / ||g_ref|| "
              f"{[(k, f'{v:.3e}') for k, v in worst['grad_err']]} (bound "
              f"{bounds['grad_err']:.3e}); worst parameter leaves after "
              f"{spec['steps']} steps, ||p - p_ref|| over the unsharded "
              f"step's move {[(k, f'{v:.3e}') for k, v in worst['param_err']]}"
              f" (bound {bounds['param_err']:.3e})", flush=True)
        if not loss_rel <= SHARDED_LOSS_REL:
            bad.append(f"rank {r}: loss {got['loss']} against {ref['loss']}")
        for key, bound in bounds.items():
            k, v = worst[key][0]
            if not v <= bound:
                bad.append(f"rank {r}: {key} of {k} {v:.3e} past {bound:.3e}")
        if got["traffic"]["per_op"] != want["per_op"]:
            bad.append(f"rank {r}: moved {got['traffic']['per_op']}, the "
                       f"trace counts {want['per_op']}")
        if got["launches"] != flash:
            bad.append(f"rank {r}: launches {got['launches']}, expected "
                       f"{fwd} forward and {bwd} backward")
        if {"jax", "repro"} & set(got["modules"]):
            bad.append(f"rank {r} imported jax or repro")
    if ref["launches"] != flash:
        bad.append(f"the unsharded step launched {ref['launches']}")
    # the step windows are read on the card (a CPU rehearsal has none)
    for r, got in enumerate(ranks if devices[0].startswith("cuda") else []):
        step = got["step_peak_bytes"]
        tol = peak_tolerance(step)
        print(f"[sharded] {arch} rank {r}: its last step's own peak {step} B "
              f"({step / 2**30:.3f} GiB), the dry-run's trace of the same "
              f"step on meta {want['peak_bytes']} B: "
              f"{want['peak_bytes'] - step:+d} B "
              f"({(want['peak_bytes'] - step) / step:+.3%}; bound "
              f"{tol:.0f} B)  [{stamp}]", flush=True)
        if abs(want["peak_bytes"] - step) > tol:
            bad.append(f"rank {r}: the step's peak {step} B, the trace's "
                       f"{want['peak_bytes']} B")
    peaks = [f"{got['peak_bytes'] / 2**30:.2f}" for got in ranks]
    ms = [[round(w * 1e3, 1) for w in got["seconds"]] for got in ranks]
    walls = ("no rank timed: each collective's buffer passes through the "
             "host" if backend == HOST_STAGED else
             f"step walls (ms; {spec['steps']} steps) by rank {ms}")
    print(f"[sharded] {arch} full width, {L} bf16 layers"
          f"{'' if not spec.get('overrides') else ' ' + str(spec['overrides'])}"
          f" ({spec.get('init', 'seeded')} weights), batch {spec['batch']} "
          f"x {spec['seq']}, mesh (data, model) = {spec['mesh']} as {n} "
          f"{backend} ranks on {', '.join(devices)}: {walls}; unsharded "
          f"{[round(w * 1e3, 1) for w in ref['seconds']]}; peak allocation "
          f"by rank {peaks} GiB, unsharded "
          f"{ref['peak_bytes'] / 2**30:.2f} GiB  [{stamp}]", flush=True)
    moved = [r["traffic"]["per_op"] for r in ranks]
    calls = [r["traffic"]["counts"] for r in ranks]
    print(f"[sharded] {arch}: bytes a rank's collectives moved in its first "
          f"step: {moved} ({calls} calls); the dry-run's trace of the same "
          f"step on meta: {want['per_op']}; launches by rank "
          f"{[r['launches'] for r in ranks]}  [{stamp}]", flush=True)
    if bad:
        fail(f"phase 19 ({arch}): {bad[0]}")
    return {"arch": arch,
            "launches": [r["launches"] for r in ranks],
            "peak_bytes": [r["peak_bytes"] for r in ranks],
            "step_peak_bytes": [r["step_peak_bytes"] for r in ranks],
            "traced_peak_bytes": want["peak_bytes"],
            "flash_attention": sum(r["launches"]["flash_attention"]
                                   for r in ranks),
            "flash_attention_bwd": sum(r["launches"]["flash_attention_bwd"]
                                       for r in ranks)}


def main() -> int:
    import argparse
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-source", default=None, nargs="+",
                    metavar="PATH",
                    help="the parent commit's csrc/segment_agg.cu, "
                         "csrc/fused_gather_agg.cu, csrc/reservoir.cu, "
                         "csrc/flash_attention.cu and "
                         "csrc/flash_attention_bwd.cu (with the headers "
                         "they include), or a directory that holds them "
                         "(or its checkout root), where this checkout has "
                         "no git history")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on a GPU")
    if torch.cuda.device_count() > 1:
        fail(f"{torch.cuda.device_count()} cards: this script drives one "
             f"(run it with CUDA_VISIBLE_DEVICES=0: with a card a partition "
             f"the launcher spawns a process each, which phases 9-11's "
             f"in-process trainers do not take); scripts/group_nccl.py runs "
             f"the two-rank NCCL check")
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} is missing: run from a checkout")
    sys.path.insert(0, str(SRC))
    import repro_torch  # noqa: F401  (sets full-f32 matmuls on the card)

    stamp = card_stamp()
    print(f"[card] {stamp}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    def lap(done: str):
        print(f"[elapsed] {time.perf_counter() - t_start:.1f} s since the "
              f"start, after {done}  [{stamp}]", flush=True)
    phase_build(stamp)
    lap("phase 1")
    entry = phase_kernels(torch, stamp)
    lap("phase 2")
    launches = phase_slice(torch, stamp)
    lap("phase 3")
    entry["launches"] = launches["cache_gather"]
    train = phase_train(torch, stamp)
    lap("phase 4")
    parent = parent_kernels(torch, args.parent_source)
    entries = [entry] + phase_agg(torch, stamp, train["batch"],
                                  train["launches"], parent)
    lap("phase 5")
    flash = phase_flash(torch, stamp)
    lap("phase 6")
    lm = phase_lm(torch, stamp)
    lap("phase 7")
    reservoir = phase_reservoir(torch, stamp, train, parent)
    lap("phase 8")
    flash["launches"] = lm["prefill"]["flash_attention"]
    flash["decode_launches"] = lm["serve"]["flash_attention"]
    reservoir["path_launches"] = {
        "gnn_serve": launches["reservoir_topm"],
        "train": train["launches"]["reservoir_topm"],
        "lm_prefill": lm["prefill"]["reservoir_topm"],
        "lm_serve": lm["serve"]["reservoir_topm"]}
    multipart = phase_multipart(torch, stamp)
    lap("phase 9")
    entry["multipart_unfused_launches"] = multipart["unfused"]["cache_gather"]
    entries[1]["multipart_launches"] = multipart["fused"]["gather_aggregate"]
    entries[2]["multipart_launches"] = multipart["fused"]["neighbor_agg"]
    entries[2]["multipart_backward_launches"] = \
        multipart["fused"]["neighbor_agg_backward"]
    reservoir["path_launches"]["multipart"] = \
        multipart["fused"]["reservoir_topm"]
    autotune = phase_autotune(torch, stamp)
    lap("phase 10")
    entry["autotune_launches"] = autotune["cache_gather"]
    entries[1]["autotune_launches"] = autotune["gather_aggregate"]
    entries[2]["autotune_launches"] = autotune["neighbor_agg"]
    entries[2]["autotune_backward_launches"] = \
        autotune["neighbor_agg_backward"]
    reservoir["path_launches"]["autotune"] = autotune["reservoir_topm"]
    fabric = phase_fabric(torch, stamp)
    lap("phase 11")
    families = phase_families(torch, stamp)
    lap("phase 12")
    families.update(phase_encdec_vlm(torch, stamp))
    lap("phase 13")
    cells_job = start_dryrun_cells()
    train_lm = phase_lm_train(torch, stamp, parent)
    lap("phase 14")
    flash["train_launches"] = train_lm["flash_attention"]
    accounting = phase_accounting(torch, stamp, train_lm["entry"],
                                  train_lm["step_peak"], cells_job)
    flash["pipeline_launches"] = accounting["pipeline"]["flash_attention"]
    lap("phase 15")
    group = phase_group(torch, stamp, multipart)
    lap("phase 16")
    group_launches = group["train"]["launches"]
    entries[1]["group_launches"] = group_launches["gather_aggregate"]
    entries[2]["group_launches"] = group_launches["neighbor_agg"]
    entries[2]["group_backward_launches"] = \
        group_launches["neighbor_agg_backward"]
    live = phase_live(torch, stamp)["launches"]
    lap("phase 17")
    pipeline = phase_pipeline(torch, stamp)
    lap("phase 18")
    flash["pipeline_group_launches"] = pipeline["flash_attention"]
    train_lm["entry"]["pipeline_group_launches"] = \
        pipeline["flash_attention_bwd"]
    sharded = phase_sharded(torch, stamp)
    lap("phase 19")
    flash["sharded_launches"] = sharded["flash_attention"]
    train_lm["entry"]["sharded_launches"] = sharded["flash_attention_bwd"]
    for key, e in (("flash_attention", flash),
                   ("flash_attention_bwd", train_lm["entry"])):
        e["sharded_launches_a_rank"] = {
            run["arch"]: [r[key] for r in run["launches"]]
            for run in sharded["runs"]}
    entry["live_launches"] = live["cache_gather"]
    entries[1]["live_launches"] = live["gather_aggregate"]
    entries[2]["live_launches"] = live["neighbor_agg"]
    entries[2]["live_backward_launches"] = live["neighbor_agg_backward"]
    entry["fabric_launches"] = sum(n for k, n in fabric["parts"].items()
                                   if k != "train")
    entry["fabric_warmup_train_launches"] = fabric["parts"]["train"]
    entry["fabric_chaos_launches"] = fabric["chaos"]
    reservoir["path_launches"]["fabric"] = fabric["total"]["reservoir_topm"]
    flash["path_launches"] = {f: families[f]["prefill"]["flash_attention"]
                              for f in families}
    flash["family_decode_launches"] = {
        f: families[f]["serve"]["flash_attention"] for f in families}
    reservoir["path_launches"]["lm_families"] = sum(
        families[f][part]["reservoir_topm"] for f in families
        for part in ("prefill", "serve"))
    entries += [flash, train_lm["entry"], reservoir]
    for mod in ("jax", "repro"):
        if mod in sys.modules:
            fail(f"{mod} was imported")
    print(f"[card] {stamp}")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
