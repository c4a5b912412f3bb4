#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``apex_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card

    python3 chip_smoke.py --phases kernels,train   # the training slice
    python3 chip_smoke.py --phases spec            # speculative decoding
    python3 chip_smoke.py --phases dp              # DDP and ZeRO, dp = 2
    python3 chip_smoke.py --phases pp_train        # pipelined, pp = 2
    python3 chip_smoke.py --phases cp_train        # context parallel, cp = 2
    python3 chip_smoke.py --phases moe_train,cp_train   # MoE at ep = 2

1. **Build.**  Prints the card's name and power limit, compiles the
   port's CUDA kernels from ``apex_tpu_torch/csrc`` (``nvcc``, sm_90a)
   and prints the build time, each source's ``ptxas`` resource summary
   and, for the flash sources, each template instance's registers and
   spill bytes (and any note of ptxas serialising ``wgmma`` products).
2. **Kernels.**  Runs each kernel of the serving and training paths
   against its plain PyTorch version on the card at the shapes the
   main paths give it (RMSNorm forward ``[2048, 4096]`` and its backward
   with fp32 weights; causal flash attention forward and backward
   ``[1, 32, 2048, 128]`` with k/v broadcast from 8 kv heads; paged
   decode over 8 slots of page size 64 with lengths 0..4096 in a
   32-layer pool; the fused decode block, one random Llama-3-8B layer
   over the same pool; the amp unscale, Adam, the L2 norm, LAMB's phase
   1, SGD and Adagrad over the 1.923e9-element flat fp32 buffers of the
   4-layer training model, with the norm's run-to-run bit identity and
   the update kernels' noop bit identity; the split flash backward's dq
   and dk/dv kernels at causal ``[1, 32, 8192, 128]``, held against
   their plain halves 4 heads at a time, bit for bit from run to run,
   and timed beside the one-pass kernel forced onto the same shape and
   SDPA's backward; the ``multi_tensor_apply`` shim's axpby and fused
   scale-and-norm kernels over the same flat length, fp32 and bf16,
   with the norm's bit identity and an inf raising each flag; the flash
   forward again at causal ``[1, 32, 8192, 128]`` and ``[1, 32, 128,
   128]``, held against its plain version a few heads at a time and
   timed beside SDPA; the flash forward's masked instance (with its
   tile pre-pass) at the dense decode shape ``[8, 32, 1, 8192]`` with a
   per-batch length mask over k/v broadcast to the query heads, at
   BERT-large's padding ``[8, 16, 512, 64]`` and with a per-head mask
   under causal ``[1, 32, 2048, 128]``, each timed beside SDPA with
   the boolean ``attn_mask``; ``decode_attention``'s kernel branch at
   the same decode shape over 8 kv heads, reading one layer of a
   strided dense cache in place, its peak memory rise over the call
   (under 64 MB: no broadcast), timed beside SDPA with ``enable_gqa``
   on the same cache and bounded by the cache's live bytes (the
   ``flash_attention_masked`` record); the fused block's GPT instance, one
   random GPT-3 1.3B layer over 8 slots of lengths 0..2048, page 64,
   with its phase clock; the flash kernels' mask and dropout instances
   at the training paths' shapes, dropout 0.1: the forward (#3d) and
   one-pass backward (#4d) at GPT-3 1.3B's causal ``[4, 16, 2048,
   128]``, the masked forward (#3md) and backward (#4md) at
   BERT-large's ``[16, 16, 512, 64]`` with a padding mask of lengths
   128..512, the split pair (#5md, #6md) at causal ``[1, 32, 8192,
   128]`` with a per-head mask (and the split route's whole time, one
   mask pre-pass for both, beside the two kernels' called alone) and
   with dropout alone at ``gpt_train_8k``'s causal ``[1, 16, 8192,
   128]``, each backward held by the flash
   backward's gate against the exact gradient with the same keep mask
   (two wrong plain backwards, the keep mask transposed and the seed +
   1, must fail it) and each row within 2^-6 of its own max, timed
   beside SDPA with ``dropout_p`` and the same family without dropout;
   then each instance's keep pattern bit for bit against the plain
   keep mask, with q = 0, v = I and dO = I); the wide family (#3w, #5w
   and #6w on the tensor cores, fp32 up to head dim 128 as three bf16
   planes and six bf16 products a product; the plain versions' fp32
   products with TF32 off, stated in the phase): #3w, #5w and #6w at
   GPT-3 1.3B's causal ``[1, 16, 2048, 128]`` and BERT-large's padded
   ``[16, 16, 512, 64]`` in fp32 with dropout 0.1, fp32 causal ``[1, 16,
   8192, 128]`` (the split route's shape), bf16 at head dim 256 and fp16,
   the pair twice bit for bit, their keep patterns in each type; the
   padded bf16 routes (d 80 through #3d/#4d, d 32 with a mask through
   #3md/#4md) against the plain versions at the real head dim, and d
   80's time beside d 128's; #7w on GPT-3 1.3B's fp32 decode pool, a
   bf16 pool at group 16 and head dim 64, head dim 80, pages 8 and 256,
   fp16 pools at GPT-3 1.3B's and Llama-3-8B's decode shapes (beside #7
   on the same pools in bf16), each with the mode the host predicate
   picks (TMA, or CUDA cores); the verify step's attention,
   ``paged_slab_attention`` folded into 8 x 5 virtual slots of one paged
   decode call, at Llama-3-8B's serve (#7: 8 slots, S = 5, lengths
   0..4096, one slot ending within S rows of its window) and GPT-3 1.3B's
   fp32 pool (#7w), against the kernel's plain version on the folded
   operands and against the plain slab function, timed beside the plain
   version, the same kernel's q_len-1 decode and a bound that reads the
   live k/v once; and F4's layouts: a bf16 pool at #7's shape 8 bytes
   into its buffer and with a page stride of 4 mod 8 (both on #7w's
   CUDA-core mode), a dense bf16 cache at ``[8, 32, 1, 8192]`` whose slot
   stride the decode kernel cannot step (the kernel on a contiguous
   copy); and the fp32-output instances of #3, #3d, #4 and #4d that ring
   attention runs, at its shard pair ``[1, 16, 4096, 128]`` bf16 (cp = 2
   of 8192 tokens): the locally causal pair without dropout and the full
   pair with dropout 0.1 at the second step's seed offsets (rows from
   4096, keys from 0), each against its plain version with fp32 outputs
   (the backward by the flash backward's gate against the exact float64
   gradient, and two wrong plain backwards refused) and against its
   bf16 twin (out, lse, dk and dv round to the twin's bits, dq within
   one bf16 ulp), timed beside the twin and SDPA; and the split pair's
   fp32-output instances (#5 and #6, #5md's and #6md's with dropout) that
   ring attention runs past the one-pass gate, at its shard pair ``[1,
   16, 8192, 128]`` bf16 (cp = 2 of 16384 tokens), causal without
   dropout and full with dropout 0.1 at rows from 8192, each against its
   plain version by the flash backward's gate and against its bf16 twin
   (dq, dk and dv round to the twin's bits), timed beside the twin, the
   plain half and SDPA's backward.
   Prints
   the max
   |diff| against its stated limit, the kernel's time, its bound (the
   larger of bytes over 3.35 TB/s and operations over the peak rate of
   their type — 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s fp32
   — counted from this run's inputs), the plain version's time and,
   where one PyTorch call computes the same function, that call's
   time.  The fused block is timed over 40 calls queued behind a
   sleeping card between CUDA events (its cooperative launch is not
   captured into a graph, and its host cost can exceed its device
   time), with the eager time, host included, beside it; on a line of
   its own, the port's unfused layer on the same inputs.
3. **Serve.**  Llama-3-8B at full width and depth (random bf16 weights
   from a seeded ``torch.Generator``) served by ``InferenceEngine`` on
   the paged pool through ``engine.generate``: 8 seeded prompts of
   128..2048 tokens, 32 new tokens each, greedy.  The kernels' launch
   counters are zeroed just before and read just after; each must be
   above 0.  Prints TTFT, decode tokens/s and peak device memory.  Then
   the same prompts through a second engine on the same weights with
   ``decode_fusion="1"``: every decode layer must be one fused-block
   launch (32 per decode step) and paged attention must not launch.
   Then the same prompts on the dense slot cache at ``max_seq`` 8192
   (no paged kwarg): past ``decode_attention``'s 4096 crossover every
   decode layer must launch its decode kernel (counted as
   ``flash_attention_masked``) once (32 per step), and neither paged
   kernel.
4. **Check.**  For two of the requests, the decode logits of an
   engine prefill + decode run are held against the port's own
   full-forward prefill of prompt + generated tokens, for all three
   engines
   (and, for one request, the fused engine with the fused block's plain
   version in place of its kernel); the fused decode logits are also
   printed against the unfused ones.
5. **Profile.**  Where the serve's time goes: one 2048-token prefill
   and one 8-slot decode step of each engine, each timed on the host
   clock and then under ``torch.profiler``: wall time, the device's
   busy share and the kernels that take the most device time.  With
   ``train``, the same for one training step.
6. **Train.**  After the serve's engine is freed: Llama-3-8B widths cut
   to 4 layers (1.923e9 parameters; the fp32 master and Adam moments of
   all 32 layers would not fit in 80 GB), bf16 parameters from a seeded
   ``torch.Generator`` at the JAX package's init scales, an fp32
   master, ``fused_adam(lr=1e-4)`` and ``loss_scale="dynamic"``, six
   ``make_train_step`` steps on one fixed batch of 2048 seeded tokens;
   the loss must fall and stay finite.  Then three steps of the same
   model and rule on 8192 seeded tokens (Llama-3-8B's context), whose
   backward takes the split flash pair: each split kernel must launch
   once per layer and step, the one-pass kernel never (and every
   2048-token run the reverse).  Then the same six steps under
   ``fused_lamb(lr=1e-4, weight_decay=0.01, max_grad_norm=1.0)``, which
   must launch its phase 1 once and the norm 1 + 2 per leaf times a
   step; then 1 layer, three steps each, under ``fused_sgd`` (momentum
   0.9, nesterov, no loss scale, ``contrib.clip_grad_norm_`` as the
   grad transform) and ``fused_adagrad(lr=1e-2)``.  In every run the
   segment from the end of the backward to the new state runs under
   ``torch.cuda.set_sync_debug_mode("error")``.  Prints each run's step
   time (median of steps 2 on), tokens/s, the model-flops share of the
   step, peak device memory and the launches per step; each run's
   kernels must have launched.
7. **Train-check.**  The same widths with 1 layer: one step's flat
   grads and loss through the kernels against the same step recomputed
   through the plain versions (a relative L2 limit on every parameter's
   slice of the flat grads, an absolute loss limit).  Then for LAMB,
   SGD and Adagrad: one update from two clones of a warm state, through
   the kernels and through their plain versions, every leaf of master
   and slots within a relative limit.  Then one 8192-token step of the
   1-layer model through the split backward against the same step with
   the gate raised so the one-pass kernel takes it (both on the card):
   the loss and every leaf's flat grads within a relative L2 limit.
   Then one step of a 1-layer BERT-large-wide model with the padding
   mask and dropout 0.1 through the kernels against the same step
   through the plain versions, from the same seeds and generator
   state: every leaf within the same relative L2 limit.
8. **A/B** (``--phases ab --baseline DIR``, not in the default run).
   Another version's kernels (``DIR/apex_tpu_torch/csrc``) built into a
   library of their own beside this tree's and swapped in turn, A B B A
   in one process, with that version's paged-decode and norm-backward
   wrappers while its library is in: the flash rows (#3 at 128, 2048
   and 8192, #4 at 2048, #5 and #6 at 8192), paged decode #7 at the
   kernels phase's lengths and at the serve's, the norm backward #2 at
   ``[2048, 4096]`` and ``[8192, 4096]`` (RMSNorm and LayerNorm), the
   unfused 8-slot decode step and the 4-layer Adam steps at 2048 and
   8192 tokens, the masked forward #3m at its three shapes and
   ``decode_attention``'s whole kernel branch at ``[8, 32, 1, 8192]``
   (with each version's peak memory rise; the version's own masked and
   decode wrappers), the fused blocks #8 and #8g for one layer each
   with their phase clocks, the fused GPT-3 1.3B and dense
   Llama-3-8B (8192 positions) decode steps, and the mask and dropout
   instances at the training paths' shapes (#5md, #6md and the split
   route through each version's own ``_dq_kernel``, ``_dkv_kernel`` and
   ``_bwd`` at causal ``[1, 32, 8192, 128]`` with a per-head mask and
   at ``[1, 16, 8192, 128]`` with dropout alone; #3d, #3md, #4d, #4md,
   #3 and #4 at 2048, #5 and #6 at 8192 as controls) with the
   full-depth ``gpt_train``, ``bert_train`` and ``gpt_train_8k`` steps
   (``--ab-rows`` picks among flash, paged, norm, steps, masked, fused,
   md, wide, wide_paged and partial; ``wide_paged``: #7w at each of its
   rows, #7 and the dense decode with the same bits from both versions,
   and the ``width`` serves' decode steps; ``partial``: the fused
   block's rank-partial instances, V6, at the tp = 2 and tp = 4 shards
   of Llama-3-8B and GPT-3 1.3B with their phase clocks).
9. **Shim.**  One backward of the 1-layer model, then
   ``multi_tensor_applier`` with each of its four ops over the model's
   real grad list (11 leaves, bf16 and fp32), one kernel launch a call,
   against the same calls through the plain versions; ``noop_flag`` 1
   and an inf in one grad must raise every flag.

10. **Optim** (after train).  Apex's optimizer classes
   (:mod:`apex_tpu_torch.optimizers`) at Llama-3-8B widths, every
   update kernel held to launch and no plain update version allowed to
   run: ``FusedAdam(model.parameters(), lr=1e-4)`` must be the
   ``FusedAdamTorch`` twin, six rounds of ``loss.backward();
   opt.step(); opt.zero_grad()`` on the 4-layer model and the 2048-token
   batch (the loss falls; one ``fused_adam`` launch a step; each step
   under ``set_sync_debug_mode("error")``), its step time and peak
   memory beside ``make_train_step``'s with no loss scale, and the
   time of the twin's grad-buffer copy pass; one twin step against one
   functional step from one warm state (1 layer: two optimizer states
   side by side), fed the same grads, every leaf's master and moments
   within 1e-6; the LAMB twin (decay and no-decay groups), SGD and
   Adagrad twins at 1 layer with their launches a step; ``FusedLAMB``
   over the 1-layer model's tree, three ``step(grads)`` calls against
   the functional update; and the handoff: the 4-layer model trained
   three ``make_train_step`` steps, served through
   ``InferenceEngine.from_train_state`` (8 prompts, 32 greedy tokens,
   page 64) with two requests' decode logits held against the full
   forward, and an engine from ``from_state_dict`` giving the same
   weights and tokens.  Its launches are added to the ``kernels``
   line's counts.

11. **GPT** (after serve).  GPT-3 1.3B at full width and depth (hidden
   2048, 24 layers, 16 heads, vocab 51200; random bf16 weights from a
   seed) served by ``InferenceEngine("gpt", ...)`` three ways: the
   paged pool (24 ``paged_attention`` launches a decode step), the
   paged pool with ``decode_fusion="1"`` (24 ``fused_block_decode_gpt``)
   and the dense cache (neither); 8 prompts of 128..1536 tokens, 32
   greedy tokens each: TTFT, decode tokens/s, peak memory, and two
   requests' decode logits against ``GPTModel``'s full forward.
12. **BERT** (after GPT).  BERT-large ``encode`` on ``[8, 512]`` (24
   flash launches) and ``BertModel`` with a padding mask over the same
   weights (24 masked launches), each held against the same forward
   through the plain versions.
13. **BERT and GPT training** (``bert_train``, ``gpt_train``,
   ``gpt_train_8k``; after
   BERT).  BERT-large pretraining as ``examples/bert/pretrain_bert.py``
   runs it (``BertConfig()``, no NSP head, ``fused_lamb(lr=1e-4,
   weight_decay=0.01, max_grad_norm=1.0)``) on one padded MLM batch of
   16 x 512 tokens (lengths 128..512, 15% of each sequence's positions
   predicted), and GPT-3 1.3B (``fused_adam(lr=1e-4)``) on 4 x 2048
   tokens, both at full width and depth, bf16 parameters from their
   initializers and a seed, dynamic loss scale, dropout 0.1 on hidden
   activations and attention probabilities, six ``make_train_step``
   steps with a fresh generator in each step's batch.  Every step must
   launch the forward's dropout instance and the backward's mask or
   dropout instance once a layer and no other flash kernel, no plain
   attention version may run, the tail of the step runs under
   ``set_sync_debug_mode("error")``, and the loss must fall.  Prints
   step time, tokens/s (BERT: sequences/s), the model-flops share and
   peak memory.  ``gpt_train_8k``: the same GPT-3 1.3B run with its
   context raised to 8192 on 1 x 8192 causal tokens, whose backward
   takes the split pair: each step must launch the forward's dropout
   instance and the split pair's dropout instances (#5md, #6md) once a
   layer and no other flash kernel.
14. **Lean train** (``lean_train``, after train).  The loss side of
   training.  The LM head alone at Llama-3-8B's shape (hidden ``[8192,
   4096]``, ``lm_head`` ``[128256, 4096]`` bf16, seeded labels), forward
   and backward: the unfused head (``lm_head_xentropy_reference``), the
   chunked fused head at token chunk 1024, the same with the vocab in 8
   slices, and ``F.linear`` + ``F.cross_entropy`` as a yardstick; each
   one's time, its peak memory rise and (fused) its loss, dh and dW
   against the unfused head's; each fused rise at most half the
   unfused one.  Then ``adam 8192 lean``: the train phase's 8192-token
   Adam run with ``fused_head_xent=1024`` and ``remat=True``, three
   steps; its first loss against the same weights' unfused, non-remat
   loss, #3 launched twice a layer and step and the split pair once,
   its peak memory below ``adam 8192``'s of the same process.  Then
   ``gpt_train lean`` (GPT-3 1.3B, ``remat`` and the fused head) and
   ``bert_train lean`` (BERT-large, ``remat`` and
   ``ce_half_residuals``), three steps each after three steps of the
   plain route from the same weights and generator seeds: the first
   steps' flat grads within 3e-2 relative L2 leaf by leaf and their
   losses within 1e-3 relative, the forward's dropout instance launched
   twice a layer.  Prints each run's step time, tokens/s and peak
   memory beside the same process's plain runs.

15. **Width** (after train-check).  GPT-3 1.3B at the JAX package's
   default fp32 parameters: served paged and unfused on an fp32 pool (8
   requests, 128..1536 tokens, 32 greedy tokens; prefill on #3w, every
   decode layer one #7w launch, logits against the full forward) and
   trained six ``fused_adam`` steps on 1 x 2048 causal tokens with
   dropout 0.1 (#3w, #5w, #6w once a layer and step, no other flash
   kernel; the first step's flat grads within 3e-2 of the same step
   through the plain versions); BERT-large at fp32 (the ``bert_train``
   recipe: the wide family with the padding mask and dropout); GPT-3
   2.7B (Brown et al. 2020, Table 2.1: d_head 80) in bf16, served at
   full depth (prefill on the padded #3, decode on #7w) and trained six
   steps at 4 layers, its only cut (the padded #3d, #4d).

16. **Spec** (after width).  Speculative decoding (``spec_k=4``)
   through the scheduler's verify waves on the paged pool: Llama-3-8B
   at full width and depth (the serve's seed, weights and geometry)
   with the default n-gram drafter, with a ``ReplayDrafter`` scripted
   from a non-spec serve of the same prompts and with one scripted from
   the n-gram serve's own streams; GPT-3 1.3B in
   fp32 (#7w) with an ``EngineDrafter`` on a dense fp32 engine over the
   same weight tensors (a self-draft; the tensors shared, peak memory
   printed).  Each serve: its path kernel launched once a layer and
   verify step (the other paged kernel never), the streams equal the
   non-spec serve's up to a first difference at a token of top-2 margin
   at most 0.5, the first and last requests' verify logits (two rounds
   of 5) within TOL_LOGITS of the full forward, the scheduler's
   conservation law; prints the verify steps, acceptance, the verify
   steps' and the end-to-end tokens/s beside the non-spec serve's, a
   verify step's wall time and peak memory, each beside the card's name
   and power limit.  Its launches are added to the ``kernels`` line's
   counts.

17. **TP** (after spec).  Tensor-parallel serving at tp = 2 on the one
   card: two spawned ranks, both on cuda:0 over gloo (NCCL needs one
   card a rank; the phase asks NCCL for two ranks on the card and
   prints its answer), each building its engines one rank after the
   other from the same seeded weights and keeping its shard:
   Llama-3-8B (the serve phase's weights and geometry) unfused (#7 on
   the rank's pool shard) and with ``decode_fusion="1"`` (the fused
   block's rank-partial instance, V6: 16 heads over 4 kv heads a rank),
   GPT-3 1.3B (the gpt phase's) fused (V6's GPT instance, 8 heads a
   rank) and unfused with ``spec_k=4`` and the n-gram drafter (the
   verify fold on the shard); the first four prompts, 11 greedy tokens
   (the spec check's two slabs of 5 and one row more; 16 before the
   moe_train phase).
   Each serve: the ranks' streams equal bit for bit and equal to the
   single card's (served first, in the parent) up to a first difference
   at a top-2 margin of at most 0.5; the first and last requests'
   decode (spec: verify) logits within TOL_LOGITS of the single card's
   full forward; each rank's path kernel once a layer a step, #3 once a
   layer a prefill, the other paths' kernels never; the spec serve's
   conservation law.  Prints each rank's decode tokens/s, step time and
   peak memory beside the single card's, and one gloo all_reduce at
   ``[8, 4096]`` and ``[2048, 4096]`` bf16 (host-staged: not NCCL
   figures), each beside the card.  The kernels phase holds V6 at both
   shards (each rank's partial against its plain version, the two
   partials summed against the whole attention-only block) with its
   time, plain time, bound and phase clock; the ranks' launches are
   added to the ``kernels`` line's counts.

18. **Tier** (after tp).  The host page tier, prefix hits and chunked
   prefill: Llama-3-8B at full width and depth (seeded bf16 weights), 8
   slots, ``max_seq`` 4096, a pool of 128 pages of 64 (8 MiB a page)
   and a 2 GiB host tier; 8 shared prefixes of 1024 tokens, each with a
   suffix of 64..256 tokens, in two rounds (32 greedy tokens a
   request).  Served unfused, then fused with ``prefill_chunk`` 256,
   each beside the same traffic with the prefix cache off, under a swap
   audit (device digests of every page at swap-out and after swap-in;
   at each deferred ``resolve()``, of its pages on the card then and of
   the host slabs it returns).  Gates: round 1 swaps out at least 64
   pages and round 2 hits the host tier at least 4 times; one swap
   dispatch a ``swap_batch_pages`` pages of each call; every page
   swapped in equal to a page swapped out; deferred swap-outs whose
   pages a prefill overwrote before ``resolve()`` still resolve to the
   old bits; the books after each wave; the streams equal the
   prefix-cache-off serve's up to a near tie; #1, #3 and #7 (#8 fused)
   launched.  The unfused serve runs once more without the audit, on the
   pinned blocks the first left cached.  Prints each serve's TTFT,
   decode tokens/s and peak memory;
   one request's TTFT cold, as an HBM hit and as a host hit; swap-out
   and swap-in GB/s beside a pinned ``copy_`` of the same bytes; the
   eviction path's host time, deferred (on fresh and on cached pinned
   blocks) against eager; a host hit's host copies piece by piece;
   ``prefix_window_attention``'s time a layer at the warm shapes.
19. **Fleet** (after tier).  ``build_fleet`` over two unfused
   Llama-3-8B engines on one weight tree (64 pages each) serves the
   tier traffic, round 2 rotated by one prefix, under ``round_robin``
   and then ``prefix_affinity``: the conservation law after every wave,
   affinity routing more prefix tokens to hits than round robin, the
   streams the single engine's up to a near tie.  Prints each policy's
   TTFT and decode tokens/s, and ``required_replicas`` and
   ``drift_ratio`` from a ``ServiceProfile`` of the run's own prefill
   and decode times.  The tier and fleet serves' launches are added to
   the ``kernels`` line's counts.

20. **DP** (after tp, before tier).  Data parallelism and ZeRO at dp = 2 on the
   one card: two spawned ranks on cuda:0 over gloo (the phase asks NCCL
   for two ranks on the card, or reuses the tp phase's answer, and
   prints it; then it asks gloo for an all-reduce, a reduce-scatter and
   an all-gather on CUDA tensors and prints each answer: the port stages
   nothing, so a refusal fails the phase).  Llama-3-8B widths at 1
   layer (1.269e9 parameters; one layer leaves room for cp_train's
   time, and two ranks' dense DDP state at 4 layers would not fit twice
   in 80 GB), bf16 parameters, dynamic loss scale.
   The parent first takes 1 dense ``fused_adam`` step on a global
   batch of 2 x 2048 tokens and 1 ``FusedLAMB`` step (the class, over
   the model's tree) from the same weights, keeping the losses and a
   digest of the master (every 997th element), and frees them.  Each
   rank takes its row of the same batch: (a) DDP, the dense step with
   ``grad_transform=DistributedDataParallel().reduce_gradients`` (the
   ranks' masters bit for bit, the mean loss and the master digest
   against the reference); (b) ZeRO, ``init_train_state(...,
   shard=("data", 2), prefetch=4)`` and ``make_train_step(zero=True)``
   (the reassembled digest against DDP's); (c) one more ZeRO step whose
   inf only rank 1's loss carries, landing in one rank's shard: master
   and slots bit-identical on both ranks, the count advanced, the scale
   halved; (d) ``DistributedFusedLAMB`` 1 step against the one-card
   ``FusedLAMB``; (e) ``SyncBatchNorm`` forward and backward on
   ``[32, 56, 56, 256]`` fp32 channel-last a rank against torch's batch
   norm over the 64 images.  Each step's averaged grads of ZeRO's
   shards, and the first step's of ``DistributedFusedLAMB``'s (times
   DDP's loss scale), are held against DDP's all-reduced grads of the
   same batch as a least-squares scale (1 within TOL_DP_GRAD: a grad
   left undivided by dp, or divided twice, is off by 2x), the first
   step's also by its relative L2 error; each step's master digest is
   printed against DDP's.  The
   unscale (#9) and Adam (#13) must launch once a step a rank at the
   shard's length (the whole master under DDP), LAMB's phase 1 (#16)
   once a step at its shard's length and the norm (#11) 1 + 2 per leaf
   window a step.  Prints each rank's step times, peak memory and shard
   length, each step's gloo collectives (gloo copies CUDA tensors
   through the host inside the call: not NCCL figures), the kernels'
   launches, each beside the card's name and power limit; the ranks'
   launches are added to the ``kernels`` line's counts.
21. **TP train** (``tp_train``, after dp, before tier).  Tensor-parallel
   training at tp = 2 on the one card: two spawned ranks on cuda:0 over
   gloo, one process a rank (the phase prints NCCL's answer for two
   ranks on the card, and what gloo's ``send``/``recv`` make of CUDA
   tensors, asked in two processes of their own; the port's ring hop
   copies through host tensors over gloo on CUDA, and the phase prints
   that).  Llama-3-8B widths at 4 layers (1.923e9 parameters, ~9.6e8 a
   rank), 2048 tokens a step, bf16 parameters, fp32 master,
   ``fused_adam``, dynamic loss scale, through ``make_train_step``.
   The parent first takes 2 steps at tp = 1 from the train phase's
   seeded weights on the phase's 2 batches, keeping the losses, a
   digest of the step-0 grads and of the master after the last step
   (every 997th element of each leaf), and frees them.  Each rank builds
   the same weights, one rank after the other, keeps its shard
   (``shard_llama_params``) and gets the batches from tensor rank 0
   (``broadcast_data``): (a) the column-parallel head, 2 steps; (b) the
   fused vocab-parallel head (token chunk 1024), 1 step; (c)
   ``APEX_TPU_TP_OVERLAP_CHUNKS=2`` at construction, 1 step from (a)'s
   first weights and batch; (d) ``RowParallelLinear`` alone at ``[2048,
   1, 7168] -> 4096`` bf16, the ring against the fused all-reduce,
   forward and backward, with and without
   ``gradient_accumulation_fusion``, and ``ring_psum`` of a ``[2048,
   4096]`` bf16 tensor against ``all_reduce``; (e) sequence parallelism:
   ``ColumnParallelLinear -> GELU -> RowParallelLinear`` with
   ``sequence_parallel_enabled=True`` on ``[2048, 1, 2048] -> 8192 ->
   2048`` bf16 a rank (GPT-3 1.3B's MLP at 4096 tokens) against the same
   pair without it on the gathered input, forward and the input and
   weight grads.  Gates: the ranks'
   losses equal bit for bit; each loss within TOL_TP_LOSS of the
   reference's; the step-0 grads (the ranks' shards put together at the
   digest's elements) within TOL_TP_GRAD_REL relative L2 of the
   reference's and their least-squares scale within 1 +- TOL_DP_GRAD;
   at most TOL_DP_MASTER_SHARE of the master digest off the reference's
   by more than lr/8 after the first step, and no element by more than
   2 lr a step (and 2 fp32 ulps of 1) after each; the norm weights'
   masters equal on both ranks bit
   for bit after every run; (b)'s losses within TOL_TP_LOSS of (a)'s
   and its step-0 grads held to the reference's as (a)'s are;
   (c)'s loss within TOL_TP_LOSS of (a)'s first and its grads within
   TOL_DP_GRAD of (a)'s first; (d)'s backward (dx, dw) equal bit for
   bit, its forward within TOL_TP_RING_FWD of the fused one's max (and
   whether it is equal bit for bit printed), the fp32 ``dw`` within
   TOL_TP_WGRAD_FP32 relative L2 of an fp32 product of the same bf16
   operands, ``ring_psum`` equal to ``all_reduce`` bit for bit; (e)'s
   output, input grad and weight grads within TOL_TP_RING_FWD of the
   plain pair's max (and whether equal printed); a rank
   launches #3 and #4 once a layer a step, #1 and #2 2 x layers + 1
   times a step, #9 and #13 once a step at the rank's flat length, #5
   and #6 never.  Prints each rank's step times against the
   reference's, peak memory against tp = 1's, each step's gloo
   collectives (count and seconds by kind), the launches, each beside
   the card's name and power limit; the ranks' launches are added to
   the ``kernels`` line's counts.
22. **PP train** (``pp_train``, after tp_train, before tier).  Pipelined
   training at pp = 2 on the one card: two spawned ranks on cuda:0 over
   gloo, one process a rank, the pipe ring's hops staged through host
   tensors (``parallel._comm.ring_hop``).  Llama-3-8B widths at 4
   layers, two a rank (the last rank also the final norm and the head),
   built from ``LlamaBlock`` and applied with
   ``torch.func.functional_call`` to the stage's param tree; the
   embedding lookup is the frozen ``input_fn``; 8 microbatches of ``[1,
   2048]`` tokens a step (16384 tokens).  The parent first runs
   ``forward_backward_no_pipelining`` over all four layers on the same
   seeded weights and batches, with ``GradScaler.unscale_`` (#9) and
   ``FusedAdam`` (#13), 2 steps, keeping the losses, the digest of the
   step-0 grads (every 997th element of each leaf) and of the master
   after each step, and frees them.  Each rank, on the first weights and
   batch: (b) the GPipe oracle (``use_1f1b=False``), (d)
   ``forward_only``, (c) the interleaved executor at v = 2 (rank 0 holds
   layers 0 and 2, rank 1 layers 1 and 3; the norm and head a frozen
   closure of a 2-argument loss); then (a) 2 steps of
   ``forward_backward_pipelining_without_interleaving``, the unscale and
   ``FusedAdam`` over the rank's stage; and (e) one more step with an inf
   written into rank 0's grads before the unscale.  Gates: the ranks'
   losses equal; the losses of (a)'s first step, (b), (c) and (d) within
   TOL_DP_LOSS of the reference's; the step-0 grads of (a) and (b), and
   (c)'s layer grads, within TOL_PP_GRAD relative L2 of the reference's
   (and their least-squares scale within 1 +- TOL_DP_GRAD); at most
   2 (pp - 1) + 1 microbatch graphs in flight on a rank in (a), all 8 on
   rank 0 in (b), and (a)'s executor adding less memory than (b)'s on
   rank 0; each run's launches equal to those worked out from the stage
   (#1 and #2 twice a layer and microbatch and the final norm once a
   microbatch on the last rank, #3 and #4 once a layer and microbatch,
   #9 and #13 once a step at the stage's flat length, #5 and #6 never);
   (a)'s masters within 2 lr a step and 2 fp32 ulps of the reference's;
   (e) skipped on both ranks (found_inf 1, master and moments unchanged
   bit for bit, the step count advanced, the scale halved).  Prints each
   rank's step times beside the reference's, each step's hops and 10
   hops alone each way (gloo, staged: not an NCCL figure), the peak a
   rank, and the measured bubble share of (a) and (c) beside the
   schedule's, each beside the card's name and power limit; the ranks' launches are added to the
   ``kernels`` line's counts.
23. **CP train** (``cp_train``, after pp_train, before tier).  Context
   parallelism at cp = 2 on the one card: GPT-3 1.3B widths (hidden
   2048, 16 heads of 128, vocab 51200, LayerNorm, GELU) at CP_LAYERS = 2
   layers (4 before the moe_train phase),
   its context raised to 8192, bf16 parameters from the seed, one
   sequence of 8192 tokens from the seed.  The parent runs (a) cp = 1:
   one forward and backward with attention dropout 0.1 and no hidden
   dropout, keeping the loss and a digest of the grads (every 997th
   element of each leaf); then the same
   weights in the ``scan_layers`` layout (``to_scan_layout``) with the
   same generator, whose loss and grads must equal the loop layout's bit
   for bit; and flash_attention's times at ``[1, 16, 8192, 128]``.  Two
   spawned ranks on cuda:0 over gloo (4096 tokens a rank; ring hops
   staged through the host, the all-to-all copied through it inside
   gloo): (b) the same forward and backward with ``context_parallel``
   (ring attention, the same attention seeds), the loss averaged over
   the context group and the grads over ``get_dense_param_grad_axes()``'s
   group; one ring attention call timed; (c) CP_ADAM_STEPS
   ``fused_adam`` steps through ``make_train_step`` (fp32 masters,
   dynamic loss scale, the grads all-reduced in ``grad_transform``) with
   hidden dropout 0.1 (each rank's masks its own) and no attention
   dropout, so the ring runs the instances without dropout; (d)
   ``ulysses_attention`` at ``[1, 16, 4096, 128]`` bf16 a rank, causal,
   forward and backward, against flash_attention on the gathered
   ``[1, 16, 8192, 128]``; (f) one ``ring_attention`` call on a rank's
   8192 tokens of a ``[1, 16, 16384, 128]`` bf16 sequence, causal,
   without and with dropout 0.1 (the seed at global coordinates),
   forward and backward, against flash_attention on the gathered
   sequence.  Gates: (a)'s layouts bit for bit and its
   launches (#3d and the split pair's dropout instances once a layer);
   (b)'s loss within TOL_CP_LOSS of (a)'s and its grads within
   TOL_CP_GRAD_REL relative L2, over all and leaf by leaf (the leaves
   up to CP_WHOLE_LEAF elements whole); (c)'s loss falling, the ranks'
   masters equal bit for bit after each step, #9 and #13 once a step at
   the flat length; (d) and (f) within TOL_ATTN_OUT and
   TOL_FLASH_BWD_REL_L2 (bit equality printed); each run's launches those
   worked out from the
   ring's schedule: rank r computes r + 1 causal pairs a layer, so #3's
   and #4's fp32-output instances (with dropout in (b), without in (c))
   launch CP_LAYERS (r + 1) times a step each, #1 and #2 2 CP_LAYERS +
   1 times, and no bf16
   flash instance inside the ring; Ulysses #3, #5 and #6 once; in (f)
   #3's (or #3d's) fp32-output instance and the split pair's (5f and 6f,
   or 5df and 6df) r + 1 times each, no bf16 split instance.  Prints
   (a)'s and a rank's times and peaks, each hop's seconds, the grads'
   all-reduces, a ring call's forward and backward beside
   flash_attention's at 8192, the all-to-alls' seconds, each beside the
   card's name and power limit; the ranks' launches are added to the
   ``kernels`` line's counts.
24. **MoE train** (``moe_train``, after cp_train, before tier).  Expert
   parallelism at ep = 2 on the one card: GPT-3 1.3B widths (hidden
   2048, 16 heads of 128, ffn 8192, vocab 51200) at 4 layers with the
   FFN made MoE at Mixtral 8x7B's routing (8 experts, top-2; capacity
   factor 1.25, ``aux_loss`` routing), bf16 parameters from the seed and
   the router fp32, one 2048-token sequence a rank.  Two spawned ranks
   on cuda:0 over gloo, 4 experts each (the all-to-alls and all-reduces
   copied through the host inside gloo).  Each rank runs (a) the ep = 1
   model on both ranks' sequences, dropout off: each loss, each layer's
   aux losses, the grads of loss + 0.01 sum(lb) + 0.001 sum(z) averaged
   over the two sequences; (b) ep = 2 on the same weights
   (``shard_moe_params``) on its sequence, its grads reduced by
   ``reduce_moe_grads``; (c) MOE_ADAM_STEPS ``fused_adam`` steps through
   ``make_train_step`` (fp32 masters, dynamic loss scale,
   ``reduce_moe_grads`` over the flat grads' leaf windows) with
   attention dropout 0.1; (d) one ``MoELayer`` at DeepSpeed-MoE's
   1.3B+MoE-128 (128 experts, top-1) at the same widths, 2048 tokens a
   rank, forward and backward under ``gather`` and ``onehot`` on the
   same weights and tokens.  Gates: (b)'s loss within TOL_MOE_LOSS of
   (a)'s on the rank's sequence and each layer's aux losses within
   TOL_MOE_LOSS relative; its grads within TOL_MOE_GRAD_REL relative L2
   of (a)'s average (the expert leaves the rank's slice), over all and
   leaf by leaf (bit equality printed); the reduced dense and router
   grads equal bit for bit on both ranks; (c)'s loss falling and the
   dense and router masters equal bit for bit after each step; (d)
   ``"auto"`` resolving to ``gather``, both forms' slots, drops and loads
   equal exactly, y within TOL_MOE_WIDE_OUT and the grads within
   TOL_FLASH_BWD_REL_L2 (bit equality printed); the launches of (a)-(c)
   those worked out from the model: #1 and #2 9 times a forward and
   backward, #3 and #4 (#3d and #4d in (c)) 4 times, #9 and #13 once a
   step.  Prints each run's time, the peaks, the all-to-alls and
   all-reduces apart, each beside the card's name and power limit; the
   ranks' launches of (b) and (c) are added to the ``kernels`` line's
   counts.

Then one ``{"kernels": [...]}`` line and, last, the
``{"ok": true, "device": {...}}`` line.  Any failed phase raises, so the
script exits non-zero and prints no result; so does a machine without
CUDA, or a directory without the ``apex_tpu_torch`` package.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import itertools
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
#: the card's sleep before queued calls (``_queued_ms``): about 0.1 s at
#: the H100's clocks, longer than the host takes to queue 40 fused blocks
QUEUE_SLEEP_CYCLES = 200_000_000
BF16_FLOPS_PER_S = 989e12        # H100 SXM dense bf16 tensor cores
FP32_FLOPS_PER_S = 67e12         # H100 SXM fp32, outside the tensor cores
#: The dropout instances' third bound term, the keep hash on the CUDA
#: cores: instructions a live element needs, by the pipe that runs them.
#: ``_keep_mask`` (attention.py) is murmur3's finalizer over seed ^ bh H1
#: ^ row H2 ^ col H3; with the row's and the column's parts folded
#: through its first xor-shift once a row and a column (fold16), an
#: element takes the xor of the two parts, two multiplies, two shifts and
#: two xors, the compare of the top 24 bits (h >= threshold << 8) and the
#: select that zeroes a dropped p: 9 (flash_fwd_ws_kernel's SASS: LOP3,
#: IMAD, SHF, LOP3, IMAD, SHF, LOP3, ISETP, FSEL).  The two IMADs issue on
#: the FMA pipe, the other 7 on the integer ALU pipe (64 lanes an SM);
#: all 9 take an issue slot (4 warp schedulers of 32 lanes an SM).  The
#: term is the larger of the two.
HASH_ALU_OPS = 7
HASH_ALL_OPS = 9
ALU_OPS_PER_CLOCK_SM = 64        # integer ALU lanes an SM (Hopper)
DISPATCH_PER_CLOCK_SM = 128      # thread-instructions issued an SM a clock
FULL_CFG = dict(vocab_size=128256, hidden_size=4096, num_layers=32,
                num_attention_heads=32, num_kv_heads=8,
                ffn_hidden_size=14336, max_seq_length=8192,
                rope_theta=500000.0, rms_eps=1e-5)
PROMPT_LENS = (128, 256, 384, 512, 1024, 1536, 1800, 2048)
NEW_TOKENS = 32
#: speculative decoding (the spec phase and the verify rows): drafts a
#: round, the verify slab's rows, and the verify rounds whose logits are
#: held against the full forward
SPEC_K = 4
SPEC_S = SPEC_K + 1
SPEC_CHECK_ROUNDS = 2
#: the self-drafting GPT serve's acceptance floor (the JAX package's
#: EngineDrafter test: only a request's last, short rounds reject)
SPEC_SELF_ACCEPT = 0.7
#: max |diff| limits, kernel vs plain version on the same bf16 inputs.
#: Both compute in fp32 and round to bf16; they differ by reduction
#: order and by one bf16 rounding of the output (2^-8 relative), so the
#: limits are a few output ulps at the outputs' magnitudes.
TOL_RMS_REL = 2.0 ** -6          # x max|ref| (rows scaled by rsqrt)
TOL_ATTN_OUT = 2e-2              # |out| <= ~3: weighted means of N(0,1)
TOL_ATTN_LSE = 1e-3              # base-2 lse, fp32 on both sides
#: paged decode and the masked flash forward: x each slot's (each query
#: row's) own max|ref| (a long slot's outputs average thousands of tokens
#: and read ~0.05, so a dropped page or tile of it moves them by more
#: than this and less than any one absolute limit)
TOL_PAGED_OUT = 2.0 ** -6
#: the folded verify slab against the plain slab function (the JAX
#: package's: the window gathered, p normalised in base e, then rounded
#: to the pool's type): the kernel's own plain version rounds p before
#: normalising, in base 2, and the two plain versions alone differ by up
#: to 2^-7 of a row's max at bf16 (2^-20 at fp32); the fold is also held
#: to TOL_PAGED_OUT (TOL_WIDE_OUT at fp32) against the kernel's plain
#: version on the folded operands
TOL_SLAB_PLAIN = 2.0 ** -5
#: the fused decode block (y, k_tok, v_tok, bf16): a few ulps of each
#: output's magnitude, and a relative L2 (the kernel and its plain
#: version round the same values at the same points; sums run in
#: another order and p rounds against a split's running maximum)
TOL_FUSED_REL = 2.0 ** -6
TOL_FUSED_REL_L2 = 1e-2
#: the two tp ranks' partial out-projections (V6) summed, plus x (and
#: bo), against the whole attention-only block: each partial rounds to
#: bf16 once before the sum, the whole block once after it, so a few
#: ulps of the output's magnitude
TOL_PARTIAL_SUM = 2.0 ** -5
#: training kernels: norm dx a few bf16 ulps, dw fp32 row sums in
#: another order; the unscale is one fp32 multiply on both sides
#: (exact); Adam may contract multiply-adds into FMAs (a few fp32 ulps
#: of |p| <= ~5)
TOL_NORM_DW_REL = 1e-3
TOL_ADAM = 2e-6
#: the optimizer family: the L2 norm's fp32 sum of squares over 1.9e9
#: elements in another order than the plain version's (1e-6 relative);
#: LAMB phase 1, SGD, Adagrad as Adam (a multiply-add contracted or
#: not), each output within 1e-6 of its largest magnitude
TOL_L2NORM_REL = 1e-6
TOL_UPDATE_REL = 1e-6
#: flash dq/dk/dv (fp32 accumulation, p and ds rounded to bf16 on both
#: sides, dq summed in any order) are held against the exact float64
#: gradient at both lengths, causal [1, 32, 2048, 128] (the one-pass
#: kernel) and [1, 32, 8192, 128] (the split pair), and each output as a
#: whole within a relative L2 difference of the plain version.  The
#: element rule |got - ref| <= RTOL |ref| + ATOL (two bf16 ulps of the
#: element, and an absolute floor) is printed beside, not gated: its
#: floor (2^-9) is smaller than one bf16 rounding step of a p in [0.5, 1)
#: times |dO| ~ 1, and the kernels and the plain version, whose fp32
#: scores differ in their last bits, round a few such p to different
#: sides (at 8192 both the split and the one-pass kernel read 1.157 on
#: dv).  Each output's error against the exact gradient must stay within
#: 5% (relative L2) and 25% (max |err|) of the plain version's own
#: error; both round the same values, so the ratios sit near 1, and an
#: independent error of 7e-4 relative L2 moves the first past its limit.
TOL_FLASH_BWD_RTOL = 2.0 ** -6
TOL_FLASH_BWD_ATOL = 2.0 ** -9
TOL_FLASH_BWD_REL_L2 = 1e-2
TOL_FLASH_EXACT_L2 = 1.05
TOL_FLASH_EXACT_MAX = 1.25
#: the shim's two kernels against their plain versions: axpby rounds
#: each product before the sum, as the plain version's separate
#: multiplies do, and the fused scale writes one fp32 multiply, so both
#: outputs are exact; the fused norm is an fp32 sum in another order
#: (as TOL_L2NORM_REL)
TOL_AXPBY = 0.0
TOL_L2NORM_SCALE_OUT = 0.0
#: train-check of the split backward: one 8192-token step through the
#: split pair against the same step through the one-pass kernel.  The
#: forward is the same (the loss bit for bit), dk and dv are the same
#: products; dq differs by the order of its fp32 adds before its
#: bf16 rounding (an ulp of some elements), which the rest of the
#: backward carries into every leaf: each leaf within 1e-2 relative L2
TOL_SPLIT_GRAD_REL_L2 = 1e-2
#: the kernels each main path must launch; a kernel's "launches" in the
#: JSON line is the count of the path it was ported for (the forward
#: norm and flash kernels: the serve)
SERVE_KERNELS = ("layer_norm", "flash_attention", "paged_attention",
                 "fused_block_decode")
#: the serve kernels only the fused engine launches, and those it must not
FUSED_ONLY = ("fused_block_decode",)
UNFUSED_ONLY = ("paged_attention",)
TRAIN_KERNELS = ("layer_norm", "layer_norm_bwd", "flash_attention",
                 "flash_attention_bwd", "fused_scale", "fused_adam")
#: the split flash backward, which the 8192-token run must launch once
#: each per layer and step in place of the one-pass kernel
SPLIT_KERNELS = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")
SPLIT_TRAIN_KERNELS = tuple(k for k in TRAIN_KERNELS
                            if k != "flash_attention_bwd") + SPLIT_KERNELS
#: the kernels only the multi_tensor_apply shim reaches
SHIM_KERNELS = ("fused_axpby", "fused_l2norm_scale")
#: the kernels only the serving paths of the dense cache and GPT reach:
#: the masked flash forward (the dense LLaMA serve) and the GPT block
SERVE_ONLY = ("flash_attention_masked", "fused_block_decode_gpt")
#: the optimizer runs of the train phase: the kernels each must launch,
#: and the run whose launches each kernel reports (the rest: "adam")
RULE_KERNELS = {"lamb": ("fused_l2norm", "fused_lamb1"),
                "sgd": ("fused_l2norm", "fused_sgd"),
                "adagrad": ("fused_adagrad",)}
KERNEL_RUN = {"fused_l2norm": "lamb", "fused_lamb1": "lamb",
              "fused_sgd": "sgd", "fused_adagrad": "adagrad",
              "flash_attention_bwd_dq": "adam8k",
              "flash_attention_bwd_dkv": "adam8k"}
#: the optim phase (Apex's optimizer classes): the 1-layer twins and
#: the tree-class LAMB take three steps each; the handoff trains three
#: steps before serving; a twin step and a tree step are held to the
#: functional update within 1e-6 of each leaf's magnitude (the same
#: kernel on the same values: bit for bit is expected)
OPTIM_RULE_STEPS = 3
OPTIM_TREE_STEPS = 3
HANDOFF_STEPS = 3
TOL_TWIN_REL = 1e-6
HANDOFF_SERVE_KERNELS = ("layer_norm", "flash_attention", "paged_attention")
#: the 4-layer training model (Llama-3-8B widths) and its batch
TRAIN_LAYERS = 4
TRAIN_SEQ = 2048
TRAIN_STEPS = 6
#: the 8192-token run (Llama-3-8B's published context): the same model
#: and Adam, three steps; sq * d * 4 = 4 MiB passes the one-pass gate
#: (2 MiB), so the split backward takes every layer
SPLIT_SEQ = 8192
SPLIT_STEPS = 3
TRAIN_LR = 1e-4
#: the LAMB run (4 layers, six steps) and the 1-layer SGD (with the grad
#: clipper, no loss scale) and Adagrad runs, three steps each
LAMB_KW = dict(lr=TRAIN_LR, weight_decay=0.01, max_grad_norm=1.0)
SGD_KW = dict(lr=0.1, momentum=0.9, nesterov=True)
ADAGRAD_KW = dict(lr=1e-2)
SGD_CLIP = 1.0
RULE_LAYERS, RULE_STEPS = 1, 3
#: train-check of the update rules (1 layer): one update through the
#: kernels vs the same update through the plain versions, from clones of
#: one state, each leaf of master and slots within 1e-6 of its largest
#: magnitude (the norms are summed in another order: LAMB's clip factor
#: and trust ratios agree to a few fp32 ulps)
TOL_RULE_CHECK_REL = 1e-6
#: train-check (1 layer): flat grads through the kernels vs through the
#: plain versions, bf16 activations rounded at different points in the
#: two (and dq's adds in any order), so a relative L2 of a few 1e-3 in
#: every leaf (the worst leaf is held to the limit); the loss (~12 nats)
#: within 2e-2
TOL_TRAIN_GRAD_REL_L2 = 3e-2
TOL_TRAIN_LOSS = 2e-2
#: GPT-3 1.3B (the repo's GPT flagship: hidden 2048, 24 layers, 16 heads
#: of 128, ffn 8192, context 2048, vocab 51200), its eight prompts, and
#: the BERT-large encode batch; the dense LLaMA serve's window
GPT_CFG = dict(vocab_size=51200, hidden_size=2048, num_layers=24,
               num_attention_heads=16, max_seq_length=2048,
               hidden_dropout=0.0, attention_dropout=0.0)
GPT_PROMPT_LENS = (128, 256, 384, 512, 768, 1024, 1280, 1536)
BERT_BATCH, BERT_SEQ = 8, 512
DENSE_MAX_SEQ = 8192
#: BERT-large pretraining and GPT-3 1.3B training (the bert_train and
#: gpt_train phases): full width and depth, dropout on the hidden
#: activations and the attention probabilities (the reference recipe's
#: 0.1), six steps; BERT's sequences are 128..512 tokens long in 512
LM_DROPOUT = 0.1
BERT_TRAIN_BATCH, BERT_TRAIN_SEQ, BERT_MIN_LEN = 16, 512, 128
GPT_TRAIN_BATCH, GPT_TRAIN_SEQ = 4, 2048
#: GPT-3 1.3B's long-context training (gpt_train_8k): its widths and
#: depth with the context alone raised to 8192 (the published context is
#: 2048), one sequence of 8192 causal tokens a step; past the 2 MiB gate
#: its backward runs the split pair
GPT8K_TRAIN_BATCH, GPT8K_TRAIN_SEQ = 1, 8192
LM_TRAIN_STEPS = 6
#: the flash instances each run launches once a layer and step (and no
#: other flash kernel): the masked forward with dropout and the masked
#: one-pass backward (BERT), the forward and one-pass backward with
#: dropout (GPT), the forward with dropout and the split pair's dropout
#: instances (GPT at 8192)
BERT_TRAIN_KERNELS = ("flash_attention_masked_drop",
                      "flash_attention_bwd_masked")
GPT_TRAIN_KERNELS = ("flash_attention_drop", "flash_attention_bwd_drop")
GPT8K_TRAIN_KERNELS = ("flash_attention_drop", "flash_attention_bwd_dq_md",
                       "flash_attention_bwd_dkv_md")
MD_KERNELS = BERT_TRAIN_KERNELS + GPT_TRAIN_KERNELS + (
    "flash_attention_bwd_dq_md", "flash_attention_bwd_dkv_md")
#: the training phases with dropout: (phase, its kernels, batch, tokens)
LM_RUNS = {"bert": ("bert_train", BERT_TRAIN_KERNELS, BERT_TRAIN_BATCH,
                    BERT_TRAIN_SEQ),
           "gpt": ("gpt_train", GPT_TRAIN_KERNELS, GPT_TRAIN_BATCH,
                   GPT_TRAIN_SEQ),
           "gpt8k": ("gpt_train_8k", GPT8K_TRAIN_KERNELS, GPT8K_TRAIN_BATCH,
                     GPT8K_TRAIN_SEQ)}
#: the width slice: the wide family (#3w, #5w, #6w, #7w) and the padded
#: bf16 routes.  An fp32 kernel against its fp32 plain version (TF32 off,
#: as ``main`` sets it): out and lse within 2e-5 of max|ref|, grads
#: within 1e-4 (sums in another order, exp2 by ex2.approx)
TOL_WIDE_OUT = 2e-5
TOL_WIDE_GRAD = 1e-4
WIDE_FLASH = ("flash_attention_wide", "flash_attention_wide_dq",
              "flash_attention_wide_dkv")
WIDE_KERNELS = WIDE_FLASH + ("paged_attention_wide",)
#: GPT-3 2.7B (Brown et al. 2020, "Language Models are Few-Shot
#: Learners", Table 2.1: 32 layers, d_model 2560, 32 heads of 80, context
#: 2048); ffn 4 x d_model, the vocab padded to 51200 as GPT_CFG pads
#: 50257; its training run cut to 4 layers
GPT27_CFG = dict(vocab_size=51200, hidden_size=2560, num_layers=32,
                 num_attention_heads=32, ffn_hidden_size=10240,
                 max_seq_length=2048, hidden_dropout=0.0,
                 attention_dropout=0.0)
GPT27_TRAIN_LAYERS = 4
#: the width phase's training runs, as LM_RUNS: GPT-3 1.3B and BERT-large
#: at the JAX package's default fp32 parameters (the wide family, once a
#: layer each), GPT-3 2.7B's d_head 80 in bf16 (the padded #3d and #4d)
WIDTH_RUNS = {"gpt_fp32": ("width gpt fp32 train", WIDE_FLASH, 1,
                           GPT_TRAIN_SEQ),
              "bert_fp32": ("width bert fp32 train", WIDE_FLASH,
                            BERT_TRAIN_BATCH, BERT_TRAIN_SEQ),
              "gpt27": ("width gpt27 train", GPT_TRAIN_KERNELS,
                        GPT_TRAIN_BATCH, GPT_TRAIN_SEQ)}
WIDTH_MODEL = {"gpt_fp32": dict(params_dtype=torch.float32),
               "bert_fp32": dict(params_dtype=torch.float32),
               "gpt27": dict({k: v for k, v in GPT27_CFG.items()
                              if "dropout" not in k},
                             num_layers=GPT27_TRAIN_LAYERS)}
_LM_ALL = {**LM_RUNS, **WIDTH_RUNS}
#: decode-vs-full-forward logit limit for the serve check: bf16
#: activations rounded at every op of 32 layers, along two different
#: kernel/matmul paths (paged decode vs causal flash prefill); the
#: fused engine is held to the same limit
TOL_LOGITS = 0.25
#: BERT encode, kernels against plain versions on the same bf16 weights:
#: beside TOL_LOGITS, each sequence's logits within this relative L2 of
#: the plain route's.  The run prints the plain route's own distance
#: from an fp32 control (bf16 alone) and forwards with one wrong layer:
#: a wrong first layer must land past the limit; a wrong deeper one
#: moves the logits less than bf16 rounding (with random weights every
#: position carries nearly the same vector past the first layer, so
#: attention there averages equal rows whatever its mask)
TOL_BERT_REL_L2 = 3e-2
#: the loss side of training (lean_train): the chunked fused LM head at
#: token chunk 1024 (8 chunks of Llama-3-8B's 8192 tokens), with and
#: without the vocab in 8 slices of 128256 / 8, and remat on every
#: layer; three steps a run.  The head alone is held to the unfused
#: head: the loss within 1e-3 relative, dh and dW within 1.6e-2 of
#: their largest element (the JAX suite's bf16 limit at unit scale);
#: each fused version's peak rise at most half the unfused one's
LEAN_CHUNK = 1024
LEAN_VOCAB_CHUNK = 16032
LEAN_STEPS = 3
TOL_LEAN_LOSS_REL = 1e-3
TOL_LEAN_HEAD_GRAD = 1.6e-2
LEAN_HEAD_TOKENS = 8192
LEAN_HEAD_W_STD = 0.03          # logits of order 2 from unit hidden rows


def _smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int) -> float:
    """Mean device time of one call of ``fn``: ``iters`` calls captured
    in one CUDA graph, the graph replayed between two CUDA events.  The
    graph keeps the host's per-call Python and dispatch cost out of the
    number, which for a call of tens of microseconds would otherwise be
    the time measured."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                        # warm-up, off-graph
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()                                  # warm the replay
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    del graph
    torch.cuda.empty_cache()
    return ms


def _eager_ms(fn, iters: int) -> float:
    """Mean wall time of one eager call, host dispatch included (CUDA
    events around ``iters`` back-to-back calls)."""
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


def _queued_ms(fn, iters: int) -> float:
    """Mean device time of one call of ``fn`` when the host is slower
    than the card: the card sleeps (``torch.cuda._sleep``, about 0.1 s)
    while the host queues ``iters`` calls behind it, so the calls run
    back to back between two CUDA events.  For the fused block, whose
    cooperative launch is not captured into a graph and whose host
    cost a call can exceed its device time."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(nbytes: float, flops: float, rate: float = BF16_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _sm_clock_hz() -> float:
    """The SM clock the card reaches (``nvidia-smi``'s clocks.max.sm)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def _md_bound(nbytes: float, flops: float, live_elements: float):
    """A dropout instance's bound: the largest of its bytes over the
    memory rate, its products over the bf16 tensor-core rate and the keep
    hash over the CUDA cores (``HASH_ALU_OPS`` a live element over the
    card's SMs x 64 ALU lanes a clock, or ``HASH_ALL_OPS`` over x 128
    issue slots, whichever is slower) at the SM clock: ``(ms, "bytes" or
    "operations", (bytes ms, tensor ms, hash ms))``."""
    sm_clocks = (torch.cuda.get_device_properties(0).multi_processor_count
                 * _sm_clock_hz())
    per_clock = max(HASH_ALU_OPS / ALU_OPS_PER_CLOCK_SM,
                    HASH_ALL_OPS / DISPATCH_PER_CLOCK_SM)
    hash_s = live_elements * per_clock / sm_clocks
    terms = (nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3,
             hash_s * 1e3)
    by = "bytes" if terms[0] >= max(terms[1:]) else "operations"
    return max(terms), by, terms


def _terms(terms) -> str:
    return (f"bytes {terms[0]:.4f}, tensor {terms[1]:.4f}, hash "
            f"{terms[2]:.4f} ms")


def _check(name: str, err: float, tol: float) -> None:
    ok = err <= tol
    print(f"  {name}: max|diff| {err:.6g} (limit {tol:.6g}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: max|diff| {err} over limit {tol}")


def _slot_rel(got, ref) -> float:
    """Paged decode against its plain version: the largest over slots of
    the slot's max |diff| over its own max |ref| (0 where both are 0, inf
    where only the reference is)."""
    diff = (got.float() - ref.float()).abs().flatten(1).amax(1)
    mag = ref.float().abs().flatten(1).amax(1)
    return torch.where(diff == 0, torch.zeros_like(diff),
                       diff / mag).max().item()


def _elementwise(got, ref, rtol: float, atol: float):
    """The worst ratio of ``|got - ref|`` to ``rtol |ref| + atol`` over
    the elements (at most 1 passes), and the relative L2 difference."""
    g, r = got.float(), ref.float()
    ratio = ((g - r).abs() / (rtol * r.abs() + atol)).max().item()
    return ratio, ((g - r).norm() / r.norm()).item()


def _exact_errors(got, exact):
    """Per output: (relative L2, max |err|) of ``got`` against ``exact``."""
    out = []
    for g_, x_ in zip(got, exact):
        e = g_.double() - x_
        out.append(((e.norm() / x_.norm()).item(), e.abs().max().item()))
    return out


def _check_flash_bwd_exact(label, got, ref, exact) -> float:
    """The flash backward gate (2048 and 8192 tokens): each output's
    error against the exact float64 gradient within TOL_FLASH_EXACT_* of
    the plain version's own error, and within TOL_FLASH_BWD_REL_L2 of the
    plain version; the element rule's reading is printed beside.
    Returns the largest max |diff| against the plain version."""
    err, failed = 0.0, []
    for nm, g_, r_, (gl2, gmax), (rl2, rmax) in zip(
            ("dq", "dk", "dv"), got, ref, _exact_errors(got, exact),
            _exact_errors(ref, exact)):
        ratio, rel = _elementwise(g_, r_, TOL_FLASH_BWD_RTOL,
                                  TOL_FLASH_BWD_ATOL)
        e = (g_.float() - r_.float()).abs().max().item()
        ok = gl2 <= TOL_FLASH_EXACT_L2 * rl2 \
            and gmax <= TOL_FLASH_EXACT_MAX * rmax \
            and rel <= TOL_FLASH_BWD_REL_L2
        print(f"  {label} {nm}: against the exact gradient relative L2 "
              f"{gl2:.5g} (plain {rl2:.5g}, limit x{TOL_FLASH_EXACT_L2}), "
              f"max|err| {gmax:.5g} (plain {rmax:.5g}, limit "
              f"x{TOL_FLASH_EXACT_MAX}); against the plain version max|diff| "
              f"{e:.6g}, relative L2 {rel:.4g} (limit {TOL_FLASH_BWD_REL_L2}), "
              f"worst |diff| / (2^-6 |ref| + 2^-9) {ratio:.4g} "
              f"{'ok' if ok else 'FAIL'}")
        failed += [] if ok else [nm]
        err = max(err, e)
    if failed:
        raise AssertionError(f"{label} {failed}: less accurate than the plain "
                             f"version")
    return err


def _hold_wrong_backwards(plain, ref, exact, s: int) -> None:
    """What the flash backward gate reads for two plainly wrong
    backwards: ``plain(**kw)``, the plain version with its causal
    boundary one 64-key tile late and with the keys of the second half
    dropped.  Each must fail the gate (:func:`_refuse_wrong`)."""
    _refuse_wrong((("causal boundary +64", lambda: plain(causal_off=64)),
                   (f"keys >= {s // 2} dropped",
                    lambda: plain(valid=(s, s // 2)))), ref, exact)


def phase_build():
    from apex_tpu_torch.ops import _build
    t0 = time.perf_counter()
    so = _build.build()
    _build.library()
    print(f"build: {so.name} in {time.perf_counter() - t0:.1f} s")
    # ptxas's resource lines, one summary a source (each template
    # instance is a function of its own)
    for src in _build.SOURCES:
        log = _build.BUILD_DIR / f"{src}.log"
        if log.exists():
            text = log.read_text()
            regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
            spills = sum(int(b) for b in re.findall(
                r"(\d+) bytes spill (?:stores|loads)", text))
            if regs:
                print(f"  {src}: {len(regs)} functions, {min(regs)}-"
                      f"{max(regs)} registers, {spills} bytes of spills")
            if src.startswith("flash_"):
                for name, n_regs, n_spill in _ptxas_instances(text):
                    print(f"    {name}: {n_regs} registers, {n_spill} "
                          f"bytes of spills")
                # ptxas's note where it had to serialise wgmma products
                for line in sorted(set(re.findall(
                        r".*Performance Loss.*", text))):
                    print(f"    ptxas: {line.strip()[:200]}")


def _ptxas_instances(text: str):
    """``(instance, registers, spill bytes)`` for each kernel entry in an
    ``nvcc -Xptxas -v`` log, the instance named by its kernel and its
    template arguments read from the mangled name (``Li128E`` 128,
    ``Lb0E`` false)."""
    out = []
    for part in text.split("Compiling entry function '")[1:]:
        mangled = part.split("'", 1)[0]
        m = re.search(r"\d([a-z][a-z_]*_kernel)I((?:L[ib]\d+E)+)E", mangled)
        if m:
            args = [{"b0": "false", "b1": "true"}.get(a, a[1:])
                    for a in re.findall(r"L([ib]\d+)E", m.group(2))]
            name = f"{m.group(1)}<{', '.join(args)}>"
        else:
            plain = re.search(r"\d([a-z][a-z_]*_kernel)", mangled)
            name = plain.group(1) if plain else mangled
        regs = re.search(r"Used (\d+) registers", part)
        spill = sum(int(b) for b in re.findall(
            r"(\d+) bytes spill (?:stores|loads)", part))
        out.append((name, int(regs.group(1)) if regs else -1, spill))
    return out


def phase_kernels(dev, gen):
    """Each kernel against its plain version at the main path's shapes;
    returns the kernels' records (launches filled in by the serve)."""
    # modules by name: the package re-exports functions of the same names
    ln = importlib.import_module("apex_tpu_torch.ops.layer_norm")
    attn = importlib.import_module("apex_tpu_torch.ops.attention")
    pa = importlib.import_module("apex_tpu_torch.ops.paged_attention")
    bf = torch.bfloat16
    recs = {}

    # -- RMSNorm [2048, 4096] (a 2048-token prefill's norm) --------------
    rows, hidden = 2048, 4096
    x = torch.randn(rows, hidden, generator=gen, device=dev).to(bf)
    w = (1 + 0.1 * torch.randn(hidden, generator=gen, device=dev)).to(bf)
    got = ln.rms_norm(x, w, eps=1e-5)
    ref = ln.rms_norm_reference(x, w, eps=1e-5)
    err = (got.float() - ref.float()).abs().max().item()
    print("rms_norm [2048, 4096] bf16")
    _check("rms_norm", err, TOL_RMS_REL * ref.float().abs().max().item())
    # the kernel's other branches: LayerNorm with bias, fp32 weights, a
    # hidden size that is no multiple of 8 (element-wise loads), fp32 x
    bias = (0.1 * torch.randn(hidden, generator=gen, device=dev)).to(bf)
    ref_ln = ln.layer_norm_reference(x, w, bias)
    _check("layer_norm (bias)", (ln.layer_norm(x, w, bias).float()
                                 - ref_ln.float()).abs().max().item(),
           TOL_RMS_REL * ref_ln.float().abs().max().item())
    for xx, ww in ((x[:, :1001].contiguous(), w[:1001].float()),
                   (x.float(), w.float())):
        ref_o = ln.rms_norm_reference(xx, ww)
        _check(f"rms_norm {tuple(xx.shape)} {xx.dtype}/{ww.dtype}",
               (ln.rms_norm(xx, ww).float()
                - ref_o.float()).abs().max().item(),
               TOL_RMS_REL * ref_o.float().abs().max().item())
    nbytes = 2 * x.numel() * 2 + hidden * 2
    bound, by = _bound(nbytes, 4 * x.numel())
    # timed over 4 inputs in turn (64 MB, more than the 50 MB L2), so
    # each call reads its input from device memory as a prefill does
    xs = itertools.cycle([x] + [torch.randn(rows, hidden, generator=gen,
                                            device=dev).to(bf)
                                for _ in range(3)])
    recs["layer_norm"] = dict(
        name="rms_norm", route="cuda",
        source="apex_tpu_torch/csrc/layer_norm.cu",
        replaces="apex_tpu/ops/layer_norm.py:100", max_abs_err=err,
        ms=_time_ms(lambda: ln.rms_norm(next(xs), w, eps=1e-5), 48),
        plain_ms=_time_ms(
            lambda: ln.rms_norm_reference(next(xs), w, eps=1e-5), 20),
        bound_ms=bound, bound_by=by,
        library_ms=_time_ms(
            lambda: F.rms_norm(next(xs), (hidden,), w, 1e-5), 48),
        eager_ms=_eager_ms(lambda: ln.rms_norm(x, w, eps=1e-5), 50))
    del xs

    # -- causal flash attention [1, 32, 2048, 128], kv from 8 heads -----
    b, h, kvh, s, d = 1, 32, 8, 2048, 128
    q = torch.randn(b, h, s, d, generator=gen, device=dev).to(bf)
    kk = torch.randn(b, kvh, s, d, generator=gen, device=dev).to(bf)
    vv = torch.randn(b, kvh, s, d, generator=gen, device=dev).to(bf)
    k, v = (t[:, :, None].expand(b, kvh, h // kvh, s, d).reshape(b, h, s, d)
            for t in (kk, vv))
    scale = d ** -0.5
    q3, k3, v3 = (t.reshape(b * h, s, d).contiguous() for t in (q, k, v))
    out, lse = attn._fwd(q3, k3, v3, True, scale)
    ref_out, ref_lse = attn._fwd_reference(q3, k3, v3, True, scale)
    err = (out.float() - ref_out.float()).abs().max().item()
    err_lse = (lse - ref_lse).abs().max().item()
    got_pub = attn.flash_attention(q, k, v, causal=True)
    err_pub = (got_pub.float().reshape(b * h, s, d)
               - ref_out.float()).abs().max().item()
    print("flash_attention causal [1, 32, 2048, 128] bf16")
    _check("flash out", max(err, err_pub), TOL_ATTN_OUT)
    _check("flash lse (base 2)", err_lse, TOL_ATTN_LSE)
    del ref_out, ref_lse
    nbytes = 4 * q.numel() * 2 + b * h * s * 4          # q k v o + lse
    flops = 4 * s * s * d * h / 2                       # causal half
    bound, by = _bound(nbytes, flops)
    recs["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="apex_tpu_torch/csrc/flash_attention.cu",
        replaces="apex_tpu/ops/attention.py:210", max_abs_err=max(err, err_pub),
        ms=_time_ms(lambda: attn._fwd(q3, k3, v3, True, scale), 10),
        eager_ms=_eager_ms(lambda: attn._fwd(q3, k3, v3, True, scale), 10),
        plain_ms=_time_ms(
            lambda: attn._fwd_reference(q3, k3, v3, True, scale), 3),
        bound_ms=bound, bound_by=by,
        library_ms=_time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), 10))
    del q, k, v, q3, k3, v3, kk, vv, out, lse, got_pub

    # -- paged decode: 8 slots, page 64, one layer of a 32-layer pool ----
    slots, layers, ps, mpps = 8, 32, 64, 64
    lengths_l = [0, 1, 64, 65, 1500, 2048, 3000, 4096]
    n_pages = slots * mpps
    pool_shape = (n_pages + 1, layers, kvh, ps, d)
    pool_k = torch.randn(pool_shape, generator=gen, device=dev).to(bf)
    pool_v = torch.randn(pool_shape, generator=gen, device=dev).to(bf)
    perm = torch.randperm(n_pages, generator=gen, device=dev).to(torch.int32)
    table = torch.full((slots, mpps), n_pages, dtype=torch.int32, device=dev)
    cursor = 0
    for i, ln_i in enumerate(lengths_l):
        need = -(-ln_i // ps)
        table[i, :need] = perm[cursor:cursor + need]
        cursor += need
    lengths = torch.tensor(lengths_l, dtype=torch.int32, device=dev)
    qd = torch.randn(slots, h, d, generator=gen, device=dev).to(bf)
    layer = 5
    kp, vp = pool_k[:, layer], pool_v[:, layer]         # strided views
    got = pa.paged_decode_attention(qd, kp, vp, table, lengths)
    ref = pa.paged_decode_reference(qd, kp, vp, table, lengths, scale)
    err = (got.float() - ref.float()).abs().max().item()
    plan = pa._plan_splits(slots, kvh, h // kvh, d, ps, mpps,
                           pa._sm_count(qd.device))
    print("paged_decode_attention 8 slots, lengths "
          f"{lengths_l}, page 64, pool [513, 32, 8, 64, 128] bf16 (splits "
          f"of {plan.pages_per_split} pages, {plan.nsplit} a window)")
    _check("paged out (x each slot's max|ref|)", _slot_rel(got, ref),
           TOL_PAGED_OUT)
    if got[0].abs().max().item() != 0.0:
        raise AssertionError("a length-0 slot must emit zeros")
    if not torch.equal(got, pa.paged_decode_attention(qd, kp, vp, table,
                                                      lengths)):
        raise AssertionError("paged decode did not repeat bit for bit")
    # a window of one split (8 pages): the kernel writes its output
    # without the merge pass
    short_len = torch.clamp(lengths, max=8 * ps)
    got = pa.paged_decode_attention(qd, kp, vp, table[:, :8].contiguous(),
                                    short_len)
    ref = pa.paged_decode_reference(qd, kp, vp, table[:, :8], short_len,
                                    scale)
    _check("paged out, one split (x each slot's max|ref|)",
           _slot_rel(got, ref), TOL_PAGED_OUT)
    live_tokens = sum(lengths_l)
    nbytes = live_tokens * kvh * d * 2 * 2 + 2 * qd.numel() * 2 \
        + table.numel() * 4 + slots * 4
    flops = 4 * live_tokens * h * d
    bound, by = _bound(nbytes, flops)
    # timed over 4 layers of the pool in turn (4 x 44 MB of live k/v), so
    # each call reads its pages from device memory as a decode step does
    views = itertools.cycle([(pool_k[:, i], pool_v[:, i])
                             for i in range(layer, layer + 4)])
    recs["paged_attention"] = dict(
        name="paged_decode_attention", route="cuda",
        source="apex_tpu_torch/csrc/paged_attention.cu",
        replaces="apex_tpu/ops/paged_attention.py:108", max_abs_err=err,
        ms=_time_ms(lambda: pa.paged_decode_attention(
            qd, *next(views), table, lengths), 48),
        plain_ms=_time_ms(lambda: pa.paged_decode_reference(
            qd, *next(views), table, lengths, scale), 4),
        bound_ms=bound, bound_by=by, library_ms=None,
        eager_ms=_eager_ms(lambda: pa.paged_decode_attention(
            qd, kp, vp, table, lengths), 50))
    del views
    # its own generator: the later kernels keep the inputs they had
    fgen = torch.Generator(device=dev)
    fgen.manual_seed(gen.initial_seed() + 1)
    _fused_kernel(dev, fgen, recs, pool_k, pool_v, table, lengths)
    del pool_k, pool_v, kp, vp
    torch.cuda.empty_cache()
    _train_kernels(dev, gen, recs)
    # its own generator again: the kernels above keep their inputs
    ogen = torch.Generator(device=dev)
    ogen.manual_seed(gen.initial_seed() + 2)
    _optimizer_kernels(dev, ogen, recs)
    # and for each of the last slices' kernel pairs and rows
    for off, check in ((3, _split_kernels), (4, _shim_kernels),
                       (5, _flash_fwd_rows), (6, _masked_rows),
                       (7, _fused_gpt_kernel), (8, _md_rows),
                       (9, _wide_rows), (10, _verify_rows),
                       (11, _f32out_rows), (12, _split_f32out_rows)):
        sgen = torch.Generator(device=dev)
        sgen.manual_seed(gen.initial_seed() + off)
        check(dev, sgen, recs)
    for r in recs.values():
        nodrop = r.pop("nodrop_ms", None)
        twin = r.pop("twin_ms", None)
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms (eager call, host "
              f"included, {r.pop('eager_ms'):.4f} ms"
              + ("" if nodrop is None else
                 f"; without dropout {nodrop:.4f} ms")
              + ("" if twin is None else
                 f"; its bf16-output twin {twin:.4f} ms") + "), bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']}")
    torch.cuda.empty_cache()
    return recs


def _flash_fwd_rows(dev, gen, recs):
    """The flash forward (#3) at causal [1, 32, 8192, 128] (the 8192-token
    training run's shape) and [1, 32, 128, 128] (the shortest serving
    bucket), k/v from 8 kv heads: out and lse against the plain version
    (4 heads at a time at 8192, whose [h, s, s] fp32 scores are 256 MiB a
    head), then the kernel's time beside SDPA's and the bound.  The
    kernel's record stays the 2048-token prefill's."""
    attn = importlib.import_module("apex_tpu_torch.ops.attention")
    bf = torch.bfloat16
    b_, h, kvh, d = 1, 32, 8, 128
    scale = d ** -0.5
    for s in (SPLIT_SEQ, 128):
        q = torch.randn(b_, h, s, d, generator=gen, device=dev).to(bf)
        kk = torch.randn(b_, kvh, s, d, generator=gen, device=dev).to(bf)
        vv = torch.randn(b_, kvh, s, d, generator=gen, device=dev).to(bf)
        k, v = (t[:, :, None].expand(b_, kvh, h // kvh, s, d)
                .reshape(b_, h, s, d) for t in (kk, vv))
        q3, k3, v3 = (t.reshape(b_ * h, s, d).contiguous()
                      for t in (q, k, v))
        out, lse = attn._fwd(q3, k3, v3, True, scale)
        ref_out, ref_lse = _by_heads(lambda sl: attn._fwd_reference(
            q3[sl], k3[sl], v3[sl], True, scale), b_ * h, 4)
        print(f"flash_attention causal [{b_}, {h}, {s}, {d}] bf16")
        _check("flash out", (out.float() - ref_out.float()).abs().max()
               .item(), TOL_ATTN_OUT)
        _check("flash lse (base 2)", (lse - ref_lse).abs().max().item(),
               TOL_ATTN_LSE)
        del ref_out, ref_lse
        bound, by = _bound(4 * q.numel() * 2 + b_ * h * s * 4,
                           4 * s * s * d * h / 2)
        iters = 10 if s == SPLIT_SEQ else 48
        ms = _time_ms(lambda: attn._fwd(q3, k3, v3, True, scale), iters)
        lib = _time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), iters)
        print(f"  flash_attention causal [{b_}, {h}, {s}, {d}] on {_smi()}: "
              f"kernel {ms:.4f} ms, SDPA {lib:.4f} ms, bound {bound:.4f} "
              f"ms ({by}), {100 * bound / ms:.1f}% of the bound")
        del q, kk, vv, k, v, q3, k3, v3, out, lse
        torch.cuda.empty_cache()


def _masked_case(attn, label, q, k, v, mask, causal, iters):
    """One masked flash-forward shape: the public entry (one
    ``flash_attention_masked`` launch, no unmasked one) and ``_fwd`` on
    its mask3 against the plain version, fully masked rows 0; the
    kernel's time, the plain version's and SDPA's with the boolean
    ``attn_mask`` (True = keep, so the mask inverted, and the causal
    triangle folded in: timed only, its fully masked rows are NaN).
    Returns ``(max |err|, ms, plain_ms, library_ms)``."""
    from apex_tpu_torch.ops import _build
    b, h, sq, d = q.shape
    sk = k.shape[2]
    scale = d ** -0.5
    counts = _build.launch_counts()
    out = attn.flash_attention(q, k, v, causal=causal, mask=mask)
    after = _build.launch_counts()
    if after["flash_attention_masked"] != counts["flash_attention_masked"] \
            + 1 or after["flash_attention"] != counts["flash_attention"]:
        raise AssertionError(f"{label}: the masked entry did not take the "
                             f"masked kernel alone")
    mask3 = attn._mask3(mask, b, h, sq, sk)
    q3, k3, v3 = (t.reshape(b * h, -1, d).contiguous() for t in (q, k, v))
    got, lse = attn._fwd(q3, k3, v3, causal, scale, mask3=mask3)
    ref, ref_lse = attn._fwd_reference(q3, k3, v3, causal, scale,
                                       mask3=mask3)
    out = out.reshape(b * h, sq, d)
    err = max((got.float() - ref.float()).abs().max().item(),
              (out.float() - ref.float()).abs().max().item())
    rows = (lambda t: t.reshape(-1, d))
    row_rel = max(_slot_rel(rows(got), rows(ref)),
                  _slot_rel(rows(out), rows(ref)))
    dead = ref_lse <= -0.5e30
    print(f"flash_attention masked {label} [{b}, {h}, {sq}, {sk}] bf16, "
          f"mask {tuple(mask.shape)}, {int(dead.sum())} fully masked rows")
    _check("masked flash out", err, TOL_ATTN_OUT)
    _check("masked flash out (x each row's max|ref|)", row_rel,
           TOL_PAGED_OUT)
    _check("masked flash lse (base 2)", (lse - ref_lse).abs().max().item(),
           TOL_ATTN_LSE)
    if not bool((got[dead] == 0).all()):
        raise AssertionError(f"{label}: a fully masked row is not 0")
    del ref, ref_lse, out
    ms = _time_ms(lambda: attn._fwd(q3, k3, v3, causal, scale, mask3=mask3),
                  iters)
    plain_ms = _time_ms(lambda: attn._fwd_reference(
        q3, k3, v3, causal, scale, mask3=mask3), 3)
    keep = ~mask
    if causal:
        keep = keep & torch.ones(sq, sk, dtype=torch.bool,
                                 device=q.device).tril(sk - sq)
    lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=keep), iters)
    return err, ms, plain_ms, lib_ms


DECODE_LENGTHS = [0, 1, 100, 1000, 4097, 6000, 8000, 8192]


def _masked_shapes(dev, gen):
    """The masked flash forward's (#3m) three shapes, one at a time:
    ``(label, q, k, v, mask, causal, iters, bound_bytes, flops)``.
    Dense-cache decode as the JAX package's kernel branch gives it (sq =
    1 against 8192 cached positions, 8 slots, k/v broadcast from 8 kv
    heads to 32, a per-batch length mask with a length-0 slot),
    BERT-large's padding mask (``[8, 16, 512, 64]``, non causal,
    per-batch key padding) and a per-head mask under causal at ``[1, 32,
    2048, 128]``.  Bytes: q and out, the live keys' k/v, the mask, lse
    (the decode shape's mask is key-only: one byte a key)."""
    bf = torch.bfloat16
    b, h, kvh, s, d = 8, 32, 8, 8192, 128
    q = torch.randn(b, h, 1, d, generator=gen, device=dev).to(bf)
    kk = torch.randn(b, kvh, s, d, generator=gen, device=dev).to(bf)
    vv = torch.randn(b, kvh, s, d, generator=gen, device=dev).to(bf)
    k, v = (t[:, :, None].expand(b, kvh, h // kvh, s, d).reshape(b, h, s, d)
            for t in (kk, vv))
    del kk, vv
    lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device=dev)
    mask = (torch.arange(s, device=dev)[None, None, None, :]
            >= lengths[:, None, None, None])
    live = sum(DECODE_LENGTHS)
    yield ("decode", q, k, v, mask, False, 20,
           2 * live * h * d * 2 + 2 * q.numel() * 2 + b * s + b * h * 4,
           4 * live * h * d)
    del q, k, v, mask
    torch.cuda.empty_cache()
    b, h, s, d = 8, 16, 512, 64
    q, k, v = (torch.randn(b, h, s, d, generator=gen, device=dev).to(bf)
               for _ in range(3))
    keep = torch.tensor([512, 500, 384, 256, 128, 64, 1, 0], device=dev)
    mask = (torch.arange(s, device=dev)[None, None, None, :]
            >= keep[:, None, None, None]).expand(b, 1, s, s)
    live = int(keep.sum())
    yield ("BERT padding", q, k, v, mask, False, 48,
           2 * q.numel() * 2 + 2 * live * h * d * 2 + b * s * s
           + b * h * s * 4, 4 * live * s * h * d)
    del q, k, v, mask
    b, h, s, d = 1, 32, 2048, 128
    q, k, v = (torch.randn(b, h, s, d, generator=gen, device=dev).to(bf)
               for _ in range(3))
    mask = torch.rand(b, h, s, s, generator=gen, device=dev) < 0.1
    mask[:, :, 5] = True                        # a fully masked row a head
    yield ("per-head causal", q, k, v, mask, True, 10,
           4 * q.numel() * 2 + mask.numel() + b * h * s * 4,
           4 * s * s * d * h / 2)
    del q, k, v, mask
    torch.cuda.empty_cache()


def _decode_case(dev, gen):
    """Llama-3-8B's dense decode at 8192 positions: q ``[8, 32, 1, 128]``
    against one layer's view of an 8-slot, 2-layer ``[slots, layers, 8,
    8192, 128]`` cache (strided, read in place), lengths
    :data:`DECODE_LENGTHS`.  Returns ``(q, k, v, lengths, bound_bytes,
    flops)``: the bytes the function needs are the live keys' k and v
    in the cache, q, out and the lengths."""
    bf = torch.bfloat16
    b, h, kvh, s, d = 8, 32, 8, 8192, 128
    q = torch.randn(b, h, 1, d, generator=gen, device=dev).to(bf)
    ck = torch.randn(b, 2, kvh, s, d, generator=gen, device=dev).to(bf)
    cv = torch.randn(b, 2, kvh, s, d, generator=gen, device=dev).to(bf)
    lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device=dev)
    live = sum(DECODE_LENGTHS)
    return (q, ck[:, 1], cv[:, 1], lengths,
            2 * live * kvh * d * 2 + 2 * q.numel() * 2 + b * 4,
            4 * live * h * d)


def _masked_rows(dev, gen, recs):
    """The masked flash forward (#3 with its mask3 operand, after its
    tile pre-pass) at :func:`_masked_shapes`, and ``decode_attention``'s
    kernel branch at Llama-3-8B's dense decode (:func:`_decode_case`),
    the q_len-1 kernel that reads the cache in place with no broadcast:
    the kernel record (the dense LLaMA serve's path).  Its yardsticks:
    SDPA with ``enable_gqa=True`` on the same un-broadcast cache (the
    record's), SDPA with ``attn_mask`` on the broadcast operands (the
    JAX package's formulation), and the bound on the cache's own live
    bytes beside the bound on the broadcast operands' live keys."""
    attn = importlib.import_module("apex_tpu_torch.ops.attention")
    for (label, q, k, v, mask, causal, iters, nbytes,
         flops) in _masked_shapes(dev, gen):
        err, ms, plain_ms, lib_ms = _masked_case(attn, label, q, k, v, mask,
                                                 causal, iters)
        bound, by = _bound(nbytes, flops)
        print(f"  flash_attention masked {label} on {_smi()}: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, "
              f"bound {bound:.4f} ms ({by}), {100 * bound / ms:.1f}% of the "
              f"bound")
        if label == "decode":
            b, h, _, d = q.shape
            s = k.shape[2]
            broadcast_bound, sdpa_mask_ms = bound, lib_ms
            # a 128-key tile of the 8192-key slot left out: its outputs
            # move past the per-row limit
            mask3 = attn._mask3(mask, b, h, 1, s)
            q3, k3, v3 = (t.reshape(b * h, -1, d) for t in (q, k, v))
            ref = attn._fwd_reference(q3, k3, v3, False, d ** -0.5,
                                      mask3=mask3)[0]
            drop = mask3.clone()
            drop[b - 1, :, 4096:4224] = True
            off = attn._fwd_reference(q3, k3, v3, False, d ** -0.5,
                                      mask3=drop)[0]
            off_rel = _slot_rel(off, ref)
            print(f"  a dropped 128-key tile of the 8192-key slot: "
                  f"{off_rel:.4g} of each row's max|ref| (limit "
                  f"{TOL_PAGED_OUT}), max|diff| "
                  f"{(off.float() - ref.float()).abs().max().item():.4g}")
            if off_rel <= TOL_PAGED_OUT:
                raise AssertionError("masked decode: the per-row limit does "
                                     "not see a dropped tile")
            del mask3, drop, ref, off, q3, k3, v3
        del q, k, v, mask
    torch.cuda.empty_cache()
    # -- decode_attention's kernel branch: no broadcast ------------------
    q, k, v, lengths, nbytes, flops = _decode_case(dev, gen)
    b, h, _, d = q.shape
    kvh, s = k.shape[1], k.shape[2]
    scale = d ** -0.5
    qg = q.reshape(b, kvh, h // kvh, d)
    from apex_tpu_torch.ops import _build
    counts = _build.launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    got = attn.decode_attention(q, k, v, lengths, use_kernel=True)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - start
    after = _build.launch_counts()
    if after["flash_attention_masked"] != \
            counts["flash_attention_masked"] + 1 \
            or after["flash_attention"] != counts["flash_attention"]:
        raise AssertionError("decode_attention's kernel branch did not "
                             "launch the decode kernel alone")
    ref = attn._decode_reference(qg, k, v, lengths, scale)
    got = got.reshape(ref.shape)
    err = (got.float() - ref.float()).abs().max().item()
    rows = (lambda t: t.reshape(-1, d))
    print(f"decode_attention kernel branch [{b}, {h}, 1, {s}] over {kvh} kv "
          f"heads, lengths {DECODE_LENGTHS}, one layer of a strided "
          f"[{b}, 2, {kvh}, {s}, {d}] cache; peak memory rise over the call "
          f"{rise / 2 ** 20:.2f} MiB (the broadcast k/v would be "
          f"{2 * b * h * s * d * 2 / 2 ** 30:.2f} GiB)")
    _check("decode kernel out", err, TOL_ATTN_OUT)
    _check("decode kernel out (x each row's max|ref|)",
           _slot_rel(rows(got), rows(ref)), TOL_PAGED_OUT)
    if rise >= 64 * 2 ** 20:
        raise AssertionError(f"the decode branch allocated {rise} bytes")
    # a 64-position tile of the 8192-position slot left out
    cut = slice(4096, 4160)
    keep_cols = torch.cat([torch.arange(0, cut.start, device=dev),
                           torch.arange(cut.stop, s, device=dev)])
    off = attn._decode_reference(
        qg, k[:, :, keep_cols], v[:, :, keep_cols],
        torch.where(lengths > cut.start,
                    lengths - (torch.clamp(lengths, max=cut.stop)
                               - cut.start), lengths), scale)
    off_rel = _slot_rel(rows(off[b - 1]), rows(ref[b - 1]))
    print(f"  a dropped 64-position tile of the 8192-position slot: "
          f"{off_rel:.4g} of each row's max|ref| (limit {TOL_PAGED_OUT})")
    if off_rel <= TOL_PAGED_OUT:
        raise AssertionError("decode kernel: the per-row limit does not see "
                             "a dropped tile")
    del off, ref, got
    bound, by = _bound(nbytes, flops)
    ms = _time_ms(lambda: attn.decode_attention(q, k, v, lengths,
                                                use_kernel=True), 20)
    plain_ms = _time_ms(lambda: attn._decode_reference(qg, k, v, lengths,
                                                       scale), 3)
    keep = (torch.arange(s, device=dev)[None, None, None, :]
            < lengths[:, None, None, None])
    lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=keep, enable_gqa=True), 20)
    print(f"  decode_attention kernel branch on {_smi()}: {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, SDPA enable_gqa on the cache "
          f"{lib_ms:.4f} ms, SDPA attn_mask on the broadcast k/v "
          f"{sdpa_mask_ms:.4f} ms; bound {bound:.4f} ms ({by}: the cache's "
          f"live k/v {nbytes / 1e9:.4f} GB), {100 * bound / ms:.1f}% of it; "
          f"the broadcast operands' live-key bound {broadcast_bound:.4f} ms")
    recs["flash_attention_masked"] = dict(
        name="flash_attention_masked", route="cuda",
        source="apex_tpu_torch/csrc/flash_attention.cu",
        replaces="apex_tpu/ops/attention.py:210", max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=lib_ms,
        eager_ms=_eager_ms(lambda: attn.decode_attention(
            q, k, v, lengths, use_kernel=True), 10))
    del q, k, v, qg
    torch.cuda.empty_cache()


def _exact_md(q3, k3, v3, do3, causal, scale, mask3=None, rate=0.0,
              seed3=None, bh0=0):
    """The backward in float64 from the bf16 operands, with the mask and
    (``rate`` > 0) the keep mask, p, the dropped p and ds unrounded: the
    exact gradient that the kernels and their plain versions both
    approximate."""
    attn = importlib.import_module("apex_tpu_torch.ops.attention")
    bh, sq, sk = q3.shape[0], q3.shape[1], k3.shape[1]
    q_, k_, v_, do_ = (t.double() for t in (q3, k3, v3, do3))
    live = attn._live3(bh, sq, sk, causal, sk - sq, None, mask3, q3.device)
    s_ = torch.matmul(q_, k_.transpose(1, 2)) * scale
    p = torch.softmax(s_.masked_fill_(~live, float("-inf")), dim=-1)
    del s_, live
    p = p.nan_to_num_(0.0)
    dp = torch.matmul(do_, v_.transpose(1, 2))
    pv = p
    if rate:
        keep = attn._keep3(seed3, bh, sq, sk, rate, q3.device, bh0)
        inv = 1.0 / (1.0 - rate)
        pv = torch.where(keep, p * inv, 0.0)
        dp = torch.where(keep, dp * inv, 0.0)
        del keep
    delta = (do_ * torch.matmul(pv, v_)).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    del p, dp
    return (scale * torch.matmul(ds, k_),
            scale * torch.matmul(ds.transpose(1, 2), q_),
            torch.matmul(pv.transpose(1, 2), do_))


@contextlib.contextmanager
def _keep_transposed():
    """The plain versions' keep mask with its rows and columns swapped
    (the key-major kernels' trap: their accumulators hold S^T)."""
    attn = importlib.import_module("apex_tpu_torch.ops.attention")
    keep3 = attn._keep3
    attn._keep3 = (lambda seed3, bh, sq, sk, rate, device, bh0=0: keep3(
        seed3, bh, sk, sq, rate, device, bh0).transpose(1, 2))
    try:
        yield
    finally:
        attn._keep3 = keep3


def _check_md_bwd(label, got, ref, exact) -> float:
    """The flash backward gate (:func:`_check_flash_bwd_exact`) and, per
    row of each output (a query's dq, a key's dk and dv), its max |diff|
    within 2^-6 of the row's own max |ref| (a dropped or misplaced
    element moves its row by more).  Returns the largest max |diff|."""
    err = _check_flash_bwd_exact(label, got, ref, exact)
    for nm, g_, r_ in zip(("dq", "dk", "dv"), got, ref):
        _check(f"{label} {nm} (x each row's max|ref|)",
               _slot_rel(g_.reshape(-1, g_.shape[-1]),
                         r_.reshape(-1, r_.shape[-1])), TOL_PAGED_OUT)
    return err


def _refuse_wrong(cases, ref, exact) -> None:
    """Each ``(label, thunk)`` in ``cases`` computes a plainly wrong
    backward; the flash backward gate must fail it."""
    plain_err = _exact_errors(ref, exact)
    for label, wrong in cases:
        bad = wrong()
        readings = [_elementwise(g_, r_, TOL_FLASH_BWD_RTOL,
                                 TOL_FLASH_BWD_ATOL)
                    for g_, r_ in zip(bad, ref)]
        bad_err = _exact_errors(bad, exact)
        print(f"  wrong backward ({label}): relative L2 against the exact "
              f"gradient over the plain version's, of dq, dk, dv "
              f"{[round(b2[0] / p2[0], 4) for b2, p2 in zip(bad_err, plain_err)]}; "
              f"(worst element ratio, relative L2) against the plain version "
              f"{[(round(a, 4), round(r, 4)) for a, r in readings]}")
        if all(b2[0] <= TOL_FLASH_EXACT_L2 * p2[0]
               and b2[1] <= TOL_FLASH_EXACT_MAX * p2[1]
               and r <= TOL_FLASH_BWD_REL_L2
               for b2, p2, (_, r) in zip(bad_err, plain_err, readings)):
            raise AssertionError(f"the flash backward gate passes a wrong "
                                 f"backward ({label})")
        del bad


def _bert_lengths(rng, b: int, s: int):
    """Per-sequence lengths of a padded BERT batch: ``BERT_MIN_LEN`` to
    ``s``, the first sequence full."""
    lengths = rng.randint(BERT_MIN_LEN, s + 1, size=b)
    lengths[0] = s
    return lengths


def _md_shapes(dev, gen):
    """The mask and dropout instances' shapes on the training paths:
    ``(tag, label, q3, k3, v3, do3, mask3, causal, mask_bytes, live_keys,
    heads)``: GPT-3 1.3B's causal ``[4, 16, 2048, 128]`` (3d, 4d) and
    BERT-large's ``[16, 16, 512, 64]`` with a padding mask of lengths
    128..512 (3md, 4md)."""
    bf = torch.bfloat16
    b, h, s, d = GPT_TRAIN_BATCH, GPT_CFG["num_attention_heads"], \
        GPT_TRAIN_SEQ, GPT_CFG["hidden_size"] // GPT_CFG["num_attention_heads"]
    q3, k3, v3, do3 = (torch.randn(b * h, s, d, generator=gen, device=dev)
                       .to(bf) for _ in range(4))
    yield ("gpt", f"causal [{b}, {h}, {s}, {d}]", q3, k3, v3, do3, None,
           True, 0, None, h)
    del q3, k3, v3, do3
    b, h, s, d = BERT_TRAIN_BATCH, 16, BERT_TRAIN_SEQ, 64
    q3, k3, v3, do3 = (torch.randn(b * h, s, d, generator=gen, device=dev)
                       .to(bf) for _ in range(4))
    lengths = _bert_lengths(np.random.RandomState(int(gen.initial_seed())
                                                  % 2 ** 31), b, s)
    keep = torch.arange(s, device=dev)[None, :] < torch.as_tensor(
        lengths, device=dev)[:, None]
    mask3 = (~keep)[:, None, :].expand(b, s, s).contiguous()
    yield ("bert", f"padding [{b}, {h}, {s}, {d}], lengths "
           f"{sorted(lengths.tolist())}", q3, k3, v3, do3, mask3, False,
           mask3.numel(), int(lengths.sum()), h)


def _counts_since(before: dict) -> dict:
    """The launch counters that moved since ``before``
    (``_build.launch_counts()``), by how much."""
    from apex_tpu_torch.ops import _build
    return {k: v - before[k] for k, v in _build.launch_counts().items()
            if v != before[k]}


def _md_rows(dev, gen, recs):
    """The flash kernels' mask and dropout instances at the training
    paths' shapes (:func:`_md_shapes`, rate 0.1): the forward with
    dropout (3d at GPT's, 3md at BERT's with its padding mask) and the
    one-pass backward (4d, 4md), each against its plain version (the
    forward as the masked forward is held, the backward by the flash
    backward's gate against the exact float64 gradient with the same
    keep mask, plus each row within 2^-6 of its own max), with two wrong
    plain backwards (the keep mask transposed, the seed + 1) that the
    gate must refuse; then the split pair's (5md, 6md) at causal [1, 32,
    8192, 128] with a per-head mask and dropout; then the keep patterns
    bit for bit (:func:`_keep_patterns`).  Each row's time beside its
    bound, its plain version's, SDPA's with ``dropout_p=0.1`` (and the
    boolean ``attn_mask`` where masked; time only, its bits differ) and
    the same instance family's time without dropout."""
    attn = importlib.import_module("apex_tpu_torch.ops.attention")
    from apex_tpu_torch.ops import _build
    rate = LM_DROPOUT
    seed3 = attn._seed_operand(-2 ** 31 + 12345, device=dev)
    for (tag, label, q3, k3, v3, do3, mask3, causal, mask_bytes, live,
         h) in _md_shapes(dev, gen):
        bh, s, d = q3.shape
        b = bh // h
        scale = d ** -0.5
        md = dict(mask3=mask3, rate=rate, seed3=seed3)
        fwd_name = "flash_attention_drop" if mask3 is None \
            else "flash_attention_masked_drop"
        bwd_name = "flash_attention_bwd_drop" if mask3 is None \
            else "flash_attention_bwd_masked"
        before = _build.launch_counts()
        out, lse = attn._fwd(q3, k3, v3, causal, scale, **md)
        got = attn._bwd(q3, k3, v3, out, lse, do3, causal, scale, **md)
        counts = _counts_since(before)
        if counts != {fwd_name: 1, bwd_name: 1}:
            raise AssertionError(f"{tag}: the md instances did not launch "
                                 f"alone: {counts}")
        step = 16 if tag == "gpt" else bh

        def plain_fwd(sl):
            m3 = None if mask3 is None else mask3[sl.start // h:
                                                  sl.stop // h]
            return attn._fwd_reference(q3[sl], k3[sl], v3[sl], causal, scale,
                                       mask3=m3, rate=rate, seed3=seed3,
                                       bh0=sl.start)

        def plain_bwd(sl, seed_op=seed3):
            m3 = None if mask3 is None else mask3[sl.start // h:
                                                  sl.stop // h]
            return attn._bwd_reference(
                q3[sl], k3[sl], v3[sl], out[sl], lse[sl], do3[sl], causal,
                scale, mask3=m3, rate=rate, seed3=seed_op, bh0=sl.start)

        ref_out, ref_lse = _by_heads(plain_fwd, bh, step)
        print(f"flash_attention with dropout {rate} ({tag}, {label}) bf16")
        err_f = (out.float() - ref_out.float()).abs().max().item()
        _check(f"{fwd_name} out", err_f, TOL_ATTN_OUT)
        _check(f"{fwd_name} out (x each row's max|ref|)",
               _slot_rel(out.reshape(-1, d), ref_out.reshape(-1, d)),
               TOL_PAGED_OUT)
        _check(f"{fwd_name} lse (base 2)",
               (lse - ref_lse).abs().max().item(), TOL_ATTN_LSE)
        del ref_out, ref_lse
        ref = _by_heads(plain_bwd, bh, step)
        exact = _by_heads(lambda sl: _exact_md(
            q3[sl], k3[sl], v3[sl], do3[sl], causal, scale,
            None if mask3 is None else mask3[sl.start // h:sl.stop // h],
            rate, seed3, sl.start), bh, 8 if tag == "gpt" else 64)
        # the dropout instances also row by row, as #4d is held; a
        # causal pair's first query, whose exact dq is 0, is held by the
        # gate alone, as #4 is
        err_b = (_check_md_bwd if rate else _check_flash_bwd_exact)(
            bwd_name, got, ref, exact)
        wrong_seed = seed3 + torch.tensor([1, 0, 0], dtype=torch.int32,
                                          device=dev)

        def transposed():
            with _keep_transposed():
                return _by_heads(plain_bwd, bh, step)

        _refuse_wrong((("keep mask transposed", transposed),
                       ("seed + 1", lambda: _by_heads(
                           lambda sl: plain_bwd(sl, wrong_seed), bh, step))),
                      ref, exact)
        del got, ref, exact
        # times: the instance, its plain version, SDPA with dropout, the
        # same family without dropout
        q4, k4, v4, do4 = (t.reshape(b, h, s, d) for t in (q3, k3, v3, do3))
        sdpa_mask = None
        if mask3 is not None:
            sdpa_mask = (~mask3)[:, None]              # True = keep
        sdpa = dict(attn_mask=sdpa_mask, dropout_p=rate,
                    is_causal=causal and sdpa_mask is None)
        fwd_ms = _time_ms(lambda: attn._fwd(q3, k3, v3, causal, scale, **md),
                          10)
        fwd_nodrop = _time_ms(lambda: attn._fwd(q3, k3, v3, causal, scale,
                                                mask3=mask3), 10)
        fwd_plain = _eager_ms(lambda: _by_heads(plain_fwd, bh, step), 1)
        lib_f = _time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, **sdpa), 10)
        bwd_ms = _time_ms(lambda: attn._bwd(q3, k3, v3, out, lse, do3, causal,
                                            scale, **md), 10)
        bwd_nodrop = _time_ms(lambda: attn._bwd(q3, k3, v3, out, lse, do3,
                                                causal, scale, mask3=mask3),
                              10)
        bwd_plain = _eager_ms(lambda: _by_heads(plain_bwd, bh, step), 1)
        qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q4, k4, v4))
        lib_fb = _time_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(qr, kr, vr, **sdpa), (qr, kr, vr),
            do4), 10)
        del qr, kr, vr
        if mask3 is None:        # causal: half the score matrix
            f_flops = 4 * s * s * d * bh / 2
            b_flops = 5 * s * s * d * bh
            elements = bh * s * (s + 1) / 2
        else:                    # every query against its live keys
            f_flops = 4 * s * live * h * d
            b_flops = 10 * s * live * h * d
            elements = s * live * h
        live_kv = 2 * (bh * s if mask3 is None else live * h) * d * 2
        f_bound = _md_bound(2 * q3.numel() * 2 + live_kv + mask_bytes
                            + bh * s * 4 + 12, f_flops, elements)
        b_bound = _md_bound(4 * q3.numel() * 2 + 2 * live_kv + mask_bytes
                            + 2 * bh * s * 4 + 12, b_flops, elements)
        rows = (("3" + ("md" if mask3 is not None else "d"), fwd_name,
                 "apex_tpu_torch/csrc/flash_attention_md.cu",
                 "apex_tpu/ops/attention.py:321", err_f, fwd_ms, fwd_plain,
                 f_bound, lib_f, fwd_nodrop),
                ("4" + ("md" if mask3 is not None else "d"), bwd_name,
                 "apex_tpu_torch/csrc/flash_attention_bwd_md.cu",
                 "apex_tpu/ops/attention.py:580", err_b, bwd_ms, bwd_plain,
                 b_bound, lib_fb - lib_f, bwd_nodrop))
        for (row, name, src, repl, err, ms, plain_ms, (bound, by, terms), lib,
             nodrop) in rows:
            print(f"  #{row} {name} ({tag}) on {_smi()}: kernel {ms:.4f} ms, "
                  f"without dropout {nodrop:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"SDPA (dropout_p {rate}) {lib:.4f} ms, bound {bound:.4f} ms "
                  f"({by}; {_terms(terms)}), {100 * bound / ms:.1f}% of the "
                  f"bound")
            recs[name] = dict(
                name=name, route="cuda", source=src, replaces=repl,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=lib, nodrop_ms=nodrop,
                eager_ms=_eager_ms(
                    (lambda: attn._fwd(q3, k3, v3, causal, scale, **md))
                    if row.startswith("3") else
                    (lambda: attn._bwd(q3, k3, v3, out, lse, do3, causal,
                                       scale, **md)), 4))
        del q3, k3, v3, do3, q4, k4, v4, do4, out, lse, mask3
        torch.cuda.empty_cache()
    _md_split_rows(dev, gen, recs, seed3)
    _md_split_gpt8k(dev, gen, recs, seed3)
    _keep_patterns(dev, seed3)
    torch.cuda.empty_cache()


def _md_split_rows(dev, gen, recs, seed3):
    """The split pair's mask and dropout instances (5md, 6md) at causal
    [1, 32, 8192, 128] with a per-head mask (10% of each head's elements
    and one row masked) and dropout 0.1: the route (one launch of each,
    none of the plain pair), the outputs against the plain halves 4
    heads at a time and the exact gradient 2 at a time, the two wrong
    plain backwards refused, two runs bit for bit, and each kernel's
    time beside its bound, plain version, SDPA's backward with dropout
    and the mask, and the same kernel without dropout."""
    attn = importlib.import_module("apex_tpu_torch.ops.attention")
    from apex_tpu_torch.ops import _build
    bf = torch.bfloat16
    rate = LM_DROPOUT
    bh, s, d = 32, SPLIT_SEQ, 128
    q3, k3, v3, do3 = (torch.randn(bh, s, d, generator=gen, device=dev)
                       .to(bf) for _ in range(4))
    mask3 = torch.rand(bh, s, s, generator=gen, device=dev) < 0.1
    mask3[:, 5] = True
    scale = d ** -0.5
    md = dict(mask3=mask3, rate=rate, seed3=seed3)
    out, lse = attn._fwd(q3, k3, v3, True, scale, **md)
    delta = attn._delta(out, do3)
    args = (q3, k3, v3, lse, delta, do3, True, scale)
    if not attn._split_bwd(s, d):
        raise AssertionError(f"sq {s}, d {d} must take the split route")
    before = _build.launch_counts()
    got = attn._bwd(q3, k3, v3, out, lse, do3, True, scale, **md)
    counts = _counts_since(before)
    if counts != {"flash_attention_bwd_dq_md": 1,
                  "flash_attention_bwd_dkv_md": 1}:
        raise AssertionError(f"the 8192 md backward did not take the split "
                             f"md route: {counts}")

    def plain(sl, seed_op=seed3):
        part = tuple(t[sl] for t in args[:6]) + args[6:]
        kw = dict(mask3=mask3[sl], rate=rate, seed3=seed_op, bh0=sl.start)
        return (attn._dq_reference(*part, **kw),
                *attn._dkv_reference(*part, **kw))

    step = 4
    ref = _by_heads(plain, bh, step)
    exact = _by_heads(lambda sl: _exact_md(
        q3[sl], k3[sl], v3[sl], do3[sl], True, scale, mask3[sl], rate, seed3,
        sl.start), bh, 2)
    print(f"flash_attention backward, split route with a per-head mask and "
          f"dropout {rate}, causal [1, {bh}, {s}, {d}] bf16")
    _check_md_bwd("flash bwd split md", got, ref, exact)
    errs = [(g_.float() - r_.float()).abs().max().item()
            for g_, r_ in zip(got, ref)]
    wrong_seed = seed3 + torch.tensor([1, 0, 0], dtype=torch.int32,
                                      device=dev)

    def transposed():
        with _keep_transposed():
            return _by_heads(plain, bh, step)

    _refuse_wrong((("keep mask transposed", transposed),
                   ("seed + 1", lambda: _by_heads(
                       lambda sl: plain(sl, wrong_seed), bh, step))),
                  ref, exact)
    del ref, exact
    again = attn._bwd(q3, k3, v3, out, lse, do3, True, scale, **md)
    same = [torch.equal(a_, b2) for a_, b2 in zip(got, again)]
    print(f"  a second run of the split md route: dq, dk, dv bit-identical "
          f"{same}")
    if not all(same):
        raise AssertionError("the split md backward differs from run to run")
    del again
    q4, k4, v4, do4 = (t[None] for t in (q3, k3, v3, do3))
    keep4 = ~mask3[None] & torch.ones(s, s, dtype=torch.bool,
                                      device=dev).tril()
    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q4, k4, v4))
    sdpa = dict(attn_mask=keep4, dropout_p=rate)
    lib_fb = _time_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qr, kr, vr, **sdpa), (qr, kr, vr),
        do4), 2)
    lib_f = _time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, **sdpa), 2)
    del qr, kr, vr, keep4
    product = s * s * d * bh
    elem = q3.numel() * 2
    stats = 2 * bh * s * 4
    # the elements the causal and per-head masks leave live (each kernel
    # hashes each once)
    tril = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
    elements = sum(int((~mask3[i] & tril).sum()) for i in range(bh))
    del tril
    for name, fn, ref_fn, products, outs, err in (
            ("flash_attention_bwd_dq_md", attn._dq_kernel, attn._dq_reference,
             3, 1, errs[0]),
            ("flash_attention_bwd_dkv_md", attn._dkv_kernel,
             attn._dkv_reference, 4, 2, max(errs[1:]))):
        ms = _time_ms(lambda: fn(*args, **md), 4)
        nodrop = _time_ms(lambda: fn(*args, mask3=mask3), 4)
        bound, by, terms = _md_bound(
            4 * elem + stats + outs * elem + mask3.numel() + 12,
            products * product, elements)
        print(f"  #{'5' if outs == 1 else '6'}md {name} on {_smi()}: kernel "
              f"{ms:.4f} ms, without dropout {nodrop:.4f} ms, bound "
              f"{bound:.4f} ms ({by}; {_terms(terms)}), "
              f"{100 * bound / ms:.1f}% of the bound; "
              f"SDPA backward (fwd+bwd - fwd, dropout_p {rate}, attn_mask) "
              f"{lib_fb - lib_f:.4f} ms")
        recs[name] = dict(
            name=name, route="cuda",
            source=("apex_tpu_torch/csrc/flash_attention_md.cu" if outs == 1
                    else "apex_tpu_torch/csrc/flash_attention_bwd_md.cu"),
            replaces=("apex_tpu/ops/attention.py:622" if outs == 1 else
                      "apex_tpu/ops/attention.py:636"),
            max_abs_err=err, ms=ms,
            plain_ms=_eager_ms(lambda: _by_heads(
                lambda sl: ref_fn(*(t[sl] for t in args[:6]), *args[6:],
                                  mask3=mask3[sl], rate=rate, seed3=seed3,
                                  bh0=sl.start), bh, step), 1),
            bound_ms=bound, bound_by=by, library_ms=lib_fb - lib_f,
            nodrop_ms=nodrop, eager_ms=_eager_ms(lambda: fn(*args, **md), 2))
    # the route runs the mask pre-pass once for both kernels
    route = _time_ms(lambda: attn._bwd(q3, k3, v3, out, lse, do3, True,
                                       scale, **md), 4)
    alone = sum(recs[n]["ms"] for n in ("flash_attention_bwd_dq_md",
                                        "flash_attention_bwd_dkv_md"))
    print(f"  the split route (_bwd: delta, one pre-pass, both kernels) "
          f"{route:.4f} ms; the two kernels called alone, each with its "
          f"pre-pass, {alone:.4f} ms")
    recs["flash_attention_bwd_dkv_md"]["route_ms"] = route
    del q3, k3, v3, do3, q4, k4, v4, do4, out, lse, delta, got, args, mask3
    torch.cuda.empty_cache()


def _md_split_gpt8k(dev, gen, recs, seed3):
    """The split pair's dropout instances at ``gpt_train_8k``'s shape,
    causal [1, 16, 8192, 128] with dropout 0.1 and no mask: the route
    (one launch of each), the outputs against the plain halves 4 heads at
    a time and the exact gradient 2 at a time, two runs bit for bit, and
    each kernel's time beside its bound and SDPA's backward with
    ``dropout_p`` (kept in the kernel's record as ``gpt8k_*``)."""
    attn = importlib.import_module("apex_tpu_torch.ops.attention")
    from apex_tpu_torch.ops import _build
    bf = torch.bfloat16
    rate = LM_DROPOUT
    bh = GPT_CFG["num_attention_heads"]
    s, d = GPT8K_TRAIN_SEQ, GPT_CFG["hidden_size"] // bh
    q3, k3, v3, do3 = (torch.randn(bh, s, d, generator=gen, device=dev)
                       .to(bf) for _ in range(4))
    scale = d ** -0.5
    md = dict(rate=rate, seed3=seed3)
    out, lse = attn._fwd(q3, k3, v3, True, scale, **md)
    delta = attn._delta(out, do3)
    args = (q3, k3, v3, lse, delta, do3, True, scale)
    before = _build.launch_counts()
    got = attn._bwd(q3, k3, v3, out, lse, do3, True, scale, **md)
    counts = _counts_since(before)
    if counts != {"flash_attention_bwd_dq_md": 1,
                  "flash_attention_bwd_dkv_md": 1}:
        raise AssertionError(f"the gpt_train_8k backward did not take the "
                             f"split md route: {counts}")

    def plain(sl):
        part = tuple(t[sl] for t in args[:6]) + args[6:]
        kw = dict(rate=rate, seed3=seed3, bh0=sl.start)
        return (attn._dq_reference(*part, **kw),
                *attn._dkv_reference(*part, **kw))

    ref = _by_heads(plain, bh, 4)
    exact = _by_heads(lambda sl: _exact_md(
        q3[sl], k3[sl], v3[sl], do3[sl], True, scale, None, rate, seed3,
        sl.start), bh, 2)
    print(f"flash_attention backward, split route with dropout {rate}, "
          f"causal [1, {bh}, {s}, {d}] bf16 (gpt_train_8k's)")
    _check_md_bwd("flash bwd split d", got, ref, exact)
    errs = [(g_.float() - r_.float()).abs().max().item()
            for g_, r_ in zip(got, ref)]
    del ref, exact
    again = attn._bwd(q3, k3, v3, out, lse, do3, True, scale, **md)
    same = [torch.equal(a_, b2) for a_, b2 in zip(got, again)]
    print(f"  a second run of the split d route: dq, dk, dv bit-identical "
          f"{same}")
    if not all(same):
        raise AssertionError("the split d backward differs from run to run")
    del again, got
    q4, k4, v4, do4 = (t[None] for t in (q3, k3, v3, do3))
    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q4, k4, v4))
    sdpa = dict(is_causal=True, dropout_p=rate)
    lib_fb = _time_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qr, kr, vr, **sdpa), (qr, kr, vr),
        do4), 2)
    lib_f = _time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, **sdpa), 2)
    del qr, kr, vr
    product = s * s * d * bh
    elem = q3.numel() * 2
    stats = 2 * bh * s * 4
    elements = bh * s * (s + 1) // 2          # causal: each hashed once
    for name, fn, products, outs, err in (
            ("flash_attention_bwd_dq_md", attn._dq_kernel, 3, 1, errs[0]),
            ("flash_attention_bwd_dkv_md", attn._dkv_kernel, 4, 2,
             max(errs[1:]))):
        ms = _time_ms(lambda: fn(*args, **md), 4)
        bound, by, terms = _md_bound(4 * elem + stats + outs * elem + 12,
                                     products * product, elements)
        print(f"  #{'5' if outs == 1 else '6'}md {name} (dropout alone) on "
              f"{_smi()}: kernel {ms:.4f} ms, bound {bound:.4f} ms ({by}; "
              f"{_terms(terms)}), {100 * bound / ms:.1f}% of the bound; "
              f"SDPA backward (fwd+bwd - fwd, dropout_p {rate}) "
              f"{lib_fb - lib_f:.4f} ms")
        recs[name].update(gpt8k_ms=ms, gpt8k_bound_ms=bound,
                          gpt8k_library_ms=lib_fb - lib_f,
                          gpt8k_max_abs_err=err)
    route = _time_ms(lambda: attn._bwd(q3, k3, v3, out, lse, do3, True,
                                       scale, **md), 4)
    pair = sum(recs[n]["gpt8k_ms"] for n in ("flash_attention_bwd_dq_md",
                                             "flash_attention_bwd_dkv_md"))
    print(f"  the split route (_bwd) {route:.4f} ms; the two kernels "
          f"{pair:.4f} ms")
    del q3, k3, v3, do3, q4, k4, v4, do4, out, lse, delta, args
    torch.cuda.empty_cache()


def _keep_patterns(dev, seed3) -> None:
    """The keep mask of each instance, bit for bit: with q = 0 every live
    p of a row is equal, so with v = I (sk = d) the forward's out[i, j]
    is positive exactly where (i, j) is kept and live, and with dO = I
    (sq = d) the backward's dv[j, i] is.  At d 128 without a mask (the
    GPT instances) and d 64 with a per-batch padding mask read by 16
    heads (BERT's): #3 and #3m by out, #4 (one-pass) and #6 (split) by
    dv, each equal to the plain keep mask; #5 (split dq) against its
    plain version."""
    attn = importlib.import_module("apex_tpu_torch.ops.attention")
    rate = LM_DROPOUT
    for d, bh, masked in ((128, 64, False), (64, 256, True)):
        s = d
        q = torch.zeros(bh, s, d, dtype=torch.bfloat16, device=dev)
        k = torch.randn(bh, s, d, device=dev).to(torch.bfloat16)
        eye = torch.eye(d, dtype=torch.bfloat16, device=dev).expand(
            bh, d, d).contiguous()
        keep = attn._keep3(seed3, bh, s, s, rate, dev)
        mask3 = None
        if masked:
            lengths = torch.arange(bh // 16, device=dev) * 3 % s + 1
            mask3 = (torch.arange(s, device=dev)[None, None, :]
                     >= lengths[:, None, None]).expand(bh // 16, s, s)
            mask3 = mask3.contiguous()
            keep = keep & ~mask3.repeat_interleave(16, dim=0)
        md = dict(mask3=mask3, rate=rate, seed3=seed3)
        out, lse = attn._fwd(q, k, eye, False, d ** -0.5, **md)
        res = {"#3m" if masked else "#3": torch.equal(out > 0, keep)}
        saved = attn._FUSED_BWD_MAX_BYTES
        for split in (False, True):
            attn._FUSED_BWD_MAX_BYTES = 0 if split else saved
            try:
                dq, _, dv = attn._bwd(q, k, eye, out, lse, eye, False,
                                      d ** -0.5, **md)
            finally:
                attn._FUSED_BWD_MAX_BYTES = saved
            res["#6" if split else "#4"] = torch.equal(
                dv.transpose(1, 2) > 0, keep)
            if split:
                ref_dq = attn._dq_reference(q, k, eye, lse,
                                            attn._delta(out, eye), eye, False,
                                            d ** -0.5, **md)
                rel = ((dq.float() - ref_dq.float()).norm()
                       / ref_dq.float().norm()).item()
                res["#5 dq relative L2 <= 1e-2"] = rel <= TOL_FLASH_BWD_REL_L2
        print(f"keep patterns (d {d}, {bh} batch-heads, "
              f"{'a padding mask, ' if masked else ''}rate {rate}, "
              f"{int(keep.sum())} of {keep.numel()} kept): {res}")
        if not all(res.values()):
            raise AssertionError(f"a kernel's keep pattern differs from the "
                                 f"plain keep mask: {res}")


#: ring attention's shard pair at cp = 2 of GPT-3 1.3B's 8192 tokens
#: (the cp_train phase's): [1, 16, 4096, 128] bf16, the second step's
#: seed offsets (queries from 4096, keys from 0)
F32_PAIR = (1, 16, 4096, 128)
F32_OFFSETS = (4096, 0)
#: the fp32-output instances, by counter: (row, source, replaced kernel)
F32_KERNELS = {
    "flash_attention_f32out": (
        "3", "apex_tpu_torch/csrc/flash_attention_f32out.cu",
        "apex_tpu/ops/attention.py:210"),
    "flash_attention_drop_f32out": (
        "3d", "apex_tpu_torch/csrc/flash_attention_f32out.cu",
        "apex_tpu/ops/attention.py:210"),
    "flash_attention_bwd_f32out": (
        "4", "apex_tpu_torch/csrc/flash_attention_bwd_f32out.cu",
        "apex_tpu/ops/attention.py:472"),
    "flash_attention_bwd_drop_f32out": (
        "4d", "apex_tpu_torch/csrc/flash_attention_bwd_f32out.cu",
        "apex_tpu/ops/attention.py:472")}


def _f32_near_twin(got32, twin) -> float:
    """The largest |bf16(got32) - twin| over one bf16 ulp of the larger
    magnitude plus 2^-16 of twin's max (dq's partials add in any order,
    and near 0 a sum cancels): at most 1 passes (a rounding one fp32 ulp
    flips is one bf16 ulp)."""
    a, b = got32.to(torch.bfloat16).float(), twin.float()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    ulp = torch.ldexp(torch.ones_like(a), e - 8)
    return ((a - b).abs() / (ulp + 2.0 ** -16 * b.abs().max())).max().item()


def _f32out_rows(dev, gen, recs):
    """The fp32-output instances of #3, #3d, #4 and #4d at ring
    attention's shard pair (F32_PAIR, cp = 2 of 8192 tokens): the first
    step's locally causal pair without dropout (#3's, #4's instances)
    and the second step's full pair with dropout 0.1 at its seed
    offsets F32_OFFSETS (#3d's, #4d's), the backward from the global
    bf16 out and lse as the ring runs it.  Each against its plain
    version with fp32 outputs (the forward as the masked forward is
    held; the backward by the flash backward's gate against the exact
    float64 gradient, each row within 2^-6 of its own max, and two wrong
    plain backwards that the gate must refuse: a causal boundary 64
    keys late and half the keys dropped, or with dropout the keep mask
    transposed and the seed + 1), and against its bf16 twin on the same
    operands (the same accumulators: out, lse, dk and dv round to the
    twin's bits; dq within one bf16 ulp, :func:`_f32_near_twin`).  Each
    instance's time beside its twin's, its plain version's and SDPA's
    (with ``dropout_p`` where it drops; time only)."""
    attn = importlib.import_module("apex_tpu_torch.ops.attention")
    from apex_tpu_torch.ops import _build
    bf = torch.bfloat16
    f32 = torch.float32
    b, h, s, d = F32_PAIR
    bh, scale = b * h, d ** -0.5
    q3, k3, v3, do3 = (torch.randn(bh, s, d, generator=gen, device=dev)
                       .to(bf) for _ in range(4))
    q4, k4, v4, do4 = (t.reshape(b, h, s, d) for t in (q3, k3, v3, do3))
    seed3 = attn._seed_operand(-2 ** 31 + 2828, *F32_OFFSETS, device=dev)
    step = 4
    for causal, rate in ((True, 0.0), (False, LM_DROPOUT)):
        md = dict(rate=rate, seed3=seed3 if rate else None)
        tag = "d" if rate else ""
        pair = ("t = 0, locally causal" if causal else
                f"t = 1, full, dropout {rate} at offsets {F32_OFFSETS}")
        before = _build.launch_counts()
        out32, lse = attn._fwd(q3, k3, v3, causal, scale, **md,
                               out_dtype=f32)
        twin, twin_lse = attn._fwd(q3, k3, v3, causal, scale, **md)
        got = attn._bwd(q3, k3, v3, twin, lse, do3, causal, scale, **md,
                        out_dtype=f32)
        twin_g = attn._bwd(q3, k3, v3, twin, lse, do3, causal, scale, **md)
        counts = _counts_since(before)
        fwd_name = f"flash_attention{'_drop' if rate else ''}_f32out"
        bwd_name = f"flash_attention_bwd{'_drop' if rate else ''}_f32out"
        twins = (("flash_attention_drop", "flash_attention_bwd_drop")
                 if rate else ("flash_attention", "flash_attention_bwd"))
        if counts != {fwd_name: 1, bwd_name: 1, twins[0]: 1, twins[1]: 1}:
            raise AssertionError(f"fp32 outputs ({pair}): the launches are "
                                 f"{counts}")
        print(f"flash fp32 outputs, ring pair {pair} {list(F32_PAIR)} bf16")

        def plain_fwd(sl):
            return attn._fwd_reference(q3[sl], k3[sl], v3[sl], causal, scale,
                                       **md, bh0=sl.start, out_dtype=f32)

        def plain_bwd(sl, seed_op=md["seed3"], **kw):
            return attn._bwd_reference(
                q3[sl], k3[sl], v3[sl], twin[sl], lse[sl], do3[sl], causal,
                scale, rate=rate, seed3=seed_op, bh0=sl.start, out_dtype=f32,
                **kw)

        ref_out, ref_lse = _by_heads(plain_fwd, bh, step)
        err_f = (out32 - ref_out).abs().max().item()
        _check(f"{fwd_name} out", err_f, TOL_ATTN_OUT)
        _check(f"{fwd_name} out (x each row's max|ref|)",
               _slot_rel(out32.reshape(-1, d), ref_out.reshape(-1, d)),
               TOL_PAGED_OUT)
        _check(f"{fwd_name} lse (base 2)",
               (lse - ref_lse).abs().max().item(), TOL_ATTN_LSE)
        same = (torch.equal(out32.to(bf), twin), torch.equal(lse, twin_lse))
        print(f"  {fwd_name} against its bf16 twin: out rounds to its bits "
              f"{same[0]}, lse equal {same[1]}; fp32 values off the bf16 "
              f"grid {bool((out32 != out32.to(bf).float()).any())}")
        if not all(same) or out32.dtype != f32:
            raise AssertionError(f"{fwd_name} is not its twin's accumulator")
        del ref_out, ref_lse
        ref = _by_heads(plain_bwd, bh, step)
        exact = _by_heads(lambda sl: _exact_md(
            q3[sl], k3[sl], v3[sl], do3[sl], causal, scale, None, rate,
            md["seed3"], sl.start), bh, 2)
        # the dropout instances also row by row, as #4d is held; a
        # causal pair's first query, whose exact dq is 0, is held by the
        # gate alone, as #4 is
        err_b = (_check_md_bwd if rate else _check_flash_bwd_exact)(
            bwd_name, got, ref, exact)
        near = _f32_near_twin(got[0], twin_g[0])
        same = [torch.equal(g_.to(bf), t_) for g_, t_ in zip(got[1:],
                                                             twin_g[1:])]
        print(f"  {bwd_name} against its bf16 twin: dk, dv round to its "
              f"bits {same}; dq within one bf16 ulp (worst ratio "
              f"{near:.4g}, limit 1)")
        if not all(same) or near > 1 or any(g_.dtype != f32 for g_ in got):
            raise AssertionError(f"{bwd_name} is not its twin's "
                                 f"accumulators")
        if rate:
            wrong_seed = seed3 + torch.tensor([1, 0, 0], dtype=torch.int32,
                                              device=dev)

            def transposed():
                with _keep_transposed():
                    return _by_heads(plain_bwd, bh, step)

            _refuse_wrong((("keep mask transposed", transposed),
                           ("seed + 1", lambda: _by_heads(
                               lambda sl: plain_bwd(sl, wrong_seed), bh,
                               step))), ref, exact)
        else:
            _hold_wrong_backwards(lambda **kw: _by_heads(
                lambda sl: plain_bwd(sl, **kw), bh, step), ref, exact, s)
        del ref, exact
        # times: the instance, its bf16 twin, its plain version, SDPA
        sdpa = dict(dropout_p=rate, is_causal=causal)
        fwd_ms = _time_ms(lambda: attn._fwd(q3, k3, v3, causal, scale, **md,
                                            out_dtype=f32), 10)
        fwd_twin = _time_ms(lambda: attn._fwd(q3, k3, v3, causal, scale,
                                              **md), 10)
        fwd_plain = _eager_ms(lambda: _by_heads(plain_fwd, bh, step), 1)
        lib_f = _time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, **sdpa), 10)
        bwd_ms = _time_ms(lambda: attn._bwd(q3, k3, v3, twin, lse, do3,
                                            causal, scale, **md,
                                            out_dtype=f32), 10)
        bwd_twin = _time_ms(lambda: attn._bwd(q3, k3, v3, twin, lse, do3,
                                              causal, scale, **md), 10)
        bwd_plain = _eager_ms(lambda: _by_heads(plain_bwd, bh, step), 1)
        qr, kr, vr = (t.detach().clone().requires_grad_()
                      for t in (q4, k4, v4))
        lib_fb = _time_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(qr, kr, vr, **sdpa),
            (qr, kr, vr), do4), 10)
        del qr, kr, vr
        # a causal pair scores half its s^2 elements
        live = bh * s * (s + 1) / 2 if causal else bh * s * s
        elem = q3.numel()
        # bytes: q, k, v (and dO) bf16 once, the fp32 outputs once, lse
        # (and delta) fp32
        f_bytes = 3 * elem * 2 + elem * 4 + bh * s * 4
        b_bytes = 4 * elem * 2 + 3 * elem * 4 + 2 * bh * s * 4
        if rate:
            f_bound, f_by, f_terms = _md_bound(f_bytes, 4 * d * live, live)
            b_bound, b_by, b_terms = _md_bound(b_bytes, 10 * d * live, live)
        else:
            (f_bound, f_by), (b_bound, b_by) = (
                _bound(f_bytes, 4 * d * live), _bound(b_bytes, 10 * d * live))
            f_terms = b_terms = None
        for name, err, ms, twin_ms, plain_ms, bound, by, terms, lib in (
                (fwd_name, err_f, fwd_ms, fwd_twin, fwd_plain, f_bound,
                 f_by, f_terms, lib_f),
                (bwd_name, err_b, bwd_ms, bwd_twin, bwd_plain, b_bound,
                 b_by, b_terms, lib_fb - lib_f)):
            row, src, repl = F32_KERNELS[name]
            print(f"  #{row} fp32 out {name} ({pair}) on {_smi()}: kernel "
                  f"{ms:.4f} ms, bf16 twin {twin_ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, SDPA{f' (dropout_p {rate})' if rate else ''} "
                  f"{lib:.4f} ms, bound {bound:.4f} ms ({by}"
                  + (f"; {_terms(terms)}" if terms else "") + f"), "
                  f"{100 * bound / ms:.1f}% of the bound")
            recs[name] = dict(
                name=name, route="cuda", source=src, replaces=repl,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=lib, twin_ms=twin_ms,
                eager_ms=_eager_ms(
                    (lambda: attn._fwd(q3, k3, v3, causal, scale, **md,
                                       out_dtype=f32))
                    if name == fwd_name else
                    (lambda: attn._bwd(q3, k3, v3, twin, lse, do3, causal,
                                       scale, **md, out_dtype=f32)), 4))
        del out32, lse, twin, twin_lse, got, twin_g
        torch.cuda.empty_cache()
    del q3, k3, v3, do3, q4, k4, v4, do4


#: the split pair's fp32-output instances at ring attention's shard pair
#: past the one-pass gate: cp = 2 of a 16384-token sequence (8192 a
#: rank, d 128: sq * d * 4 = 4 MiB), GPT-3 1.3B's 16 heads; the second
#: step's full pair drops at rows from 8192
F32_SPLIT_PAIR = (1, 16, 8192, 128)
F32_SPLIT_OFFSETS = (8192, 0)
F32_SPLIT_KERNELS = {
    "flash_attention_bwd_dq_f32out": (
        "5f", "apex_tpu_torch/csrc/flash_attention_f32out.cu",
        "apex_tpu/ops/attention.py:376", 3, 1),
    "flash_attention_bwd_dkv_f32out": (
        "6f", "apex_tpu_torch/csrc/flash_attention_bwd_f32out.cu",
        "apex_tpu/ops/attention.py:408", 4, 2),
    "flash_attention_bwd_dq_drop_f32out": (
        "5df", "apex_tpu_torch/csrc/flash_attention_f32out.cu",
        "apex_tpu/ops/attention.py:376", 3, 1),
    "flash_attention_bwd_dkv_drop_f32out": (
        "6df", "apex_tpu_torch/csrc/flash_attention_bwd_f32out.cu",
        "apex_tpu/ops/attention.py:408", 4, 2)}


def _split_f32out_rows(dev, gen, recs):
    """The split pair's fp32-output instances (5f, 6f; with dropout 5df,
    6df) at ring attention's shard pair past the one-pass gate
    (F32_SPLIT_PAIR): the first step's locally causal pair without
    dropout, the second step's full pair with dropout 0.1 at the seed
    offsets F32_SPLIT_OFFSETS, the backward from the bf16 out and lse as
    the ring runs it.  Each kernel against its plain version with fp32
    outputs (the flash backward's gate against the exact float64
    gradient, and each row within 2^-6 of its own max where it drops),
    and against its bf16 twin on the same operands (#5 and #6, #5md and
    #6md: the same accumulators, so dq, dk and dv round to the twin's
    bits); each one's time beside its twin's, its plain version's and
    SDPA's backward at the shape (with ``dropout_p`` where it drops;
    time only)."""
    attn = importlib.import_module("apex_tpu_torch.ops.attention")
    from apex_tpu_torch.ops import _build
    bf, f32 = torch.bfloat16, torch.float32
    b, h, s, d = F32_SPLIT_PAIR
    bh, scale = b * h, d ** -0.5
    q3, k3, v3, do3 = (torch.randn(bh, s, d, generator=gen, device=dev)
                       .to(bf) for _ in range(4))
    q4, k4, v4, do4 = (t.reshape(b, h, s, d) for t in (q3, k3, v3, do3))
    seed3 = attn._seed_operand(-2 ** 31 + 2929, *F32_SPLIT_OFFSETS,
                               device=dev)
    for causal, rate in ((True, 0.0), (False, LM_DROPOUT)):
        md = dict(rate=rate, seed3=seed3 if rate else None)
        drop = "_drop" if rate else ""
        names = (f"flash_attention_bwd_dq{drop}_f32out",
                 f"flash_attention_bwd_dkv{drop}_f32out")
        twins = (("flash_attention_bwd_dq_md", "flash_attention_bwd_dkv_md")
                 if rate else ("flash_attention_bwd_dq",
                               "flash_attention_bwd_dkv"))
        pair = ("t = 0, locally causal" if causal else
                f"t = 1, full, dropout {rate} at offsets {F32_SPLIT_OFFSETS}")
        out, lse = attn._fwd(q3, k3, v3, causal, scale, **md)
        delta = attn._delta(out, do3)
        args = (q3, k3, v3, lse, delta, do3, causal, scale)
        before = _build.launch_counts()
        got = attn._bwd(q3, k3, v3, out, lse, do3, causal, scale, **md,
                        out_dtype=f32)
        twin = attn._bwd(q3, k3, v3, out, lse, do3, causal, scale, **md)
        counts = _counts_since(before)
        if counts != {names[0]: 1, names[1]: 1, twins[0]: 1, twins[1]: 1}:
            raise AssertionError(f"split fp32 outputs ({pair}): the "
                                 f"launches are {counts}")
        print(f"flash split backward, fp32 outputs, ring pair {pair} "
              f"{list(F32_SPLIT_PAIR)} bf16")

        def plain(sl):
            return attn._bwd_reference(
                q3[sl], k3[sl], v3[sl], out[sl], lse[sl], do3[sl], causal,
                scale, rate=rate, seed3=md["seed3"], bh0=sl.start,
                out_dtype=f32)

        ref = _by_heads(plain, bh, 4)
        exact = _by_heads(lambda sl: _exact_md(
            q3[sl], k3[sl], v3[sl], do3[sl], causal, scale, None, rate,
            md["seed3"], sl.start), bh, 2)
        (_check_md_bwd if rate else _check_flash_bwd_exact)(
            f"split fp32 ({pair})", got, ref, exact)
        errs = [(g_ - r_).abs().max().item() for g_, r_ in zip(got, ref)]
        same = [torch.equal(g_.to(bf), t_) for g_, t_ in zip(got, twin)]
        print(f"  against the bf16 twins {twins}: dq, dk, dv round to their "
              f"bits {same}; fp32 dq off the bf16 grid "
              f"{bool((got[0] != got[0].to(bf).float()).any())}")
        if not all(same) or any(g_.dtype != f32 for g_ in got):
            raise AssertionError(f"split fp32 ({pair}) is not its twins' "
                                 f"accumulators")
        del ref, exact, got, twin
        # times: each kernel, its bf16 twin, its plain half, SDPA's backward
        sdpa = dict(dropout_p=rate, is_causal=causal)
        qr, kr, vr = (t.detach().clone().requires_grad_()
                      for t in (q4, k4, v4))
        lib_fb = _time_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(qr, kr, vr, **sdpa),
            (qr, kr, vr), do4), 4)
        lib_f = _time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, **sdpa), 4)
        del qr, kr, vr
        live = bh * s * (s + 1) / 2 if causal else bh * s * s
        elem = q3.numel()
        for name, fn, half, err in (
                (names[0], attn._dq_kernel, attn._dq_reference, errs[0]),
                (names[1], attn._dkv_kernel, attn._dkv_reference,
                 max(errs[1:]))):
            row, src, repl, products, outs = F32_SPLIT_KERNELS[name]
            ms = _time_ms(lambda: fn(*args, **md, f32=True), 4)
            twin_ms = _time_ms(lambda: fn(*args, **md), 4)
            plain_ms = _eager_ms(lambda: _by_heads(
                lambda sl: half(*(t[sl] for t in args[:6]), *args[6:],
                                rate=rate, seed3=md["seed3"], bh0=sl.start,
                                out_dtype=f32), bh, 4), 1)
            # bytes: q, k, v, dO bf16 once, lse and delta fp32, the fp32
            # outputs once
            nbytes = 4 * elem * 2 + 2 * bh * s * 4 + outs * elem * 4
            flops = 2 * products * d * live
            if rate:
                bound, by, terms = _md_bound(nbytes, flops, live)
            else:
                (bound, by), terms = _bound(nbytes, flops), None
            print(f"  #{row} split fp32 out {name} ({pair}) on {_smi()}: "
                  f"kernel {ms:.4f} ms, bf16 twin {twin_ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, SDPA's backward"
                  f"{f' (dropout_p {rate})' if rate else ''} "
                  f"{lib_fb - lib_f:.4f} ms, bound {bound:.4f} ms ({by}"
                  + (f"; {_terms(terms)}" if terms else "") + f"), "
                  f"{100 * bound / ms:.1f}% of the bound")
            recs[name] = dict(
                name=name, route="cuda", source=src, replaces=repl,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=lib_fb - lib_f, twin_ms=twin_ms,
                eager_ms=_eager_ms(lambda: fn(*args, **md, f32=True), 4))
        del out, lse, delta, args
        torch.cuda.empty_cache()
    del q3, k3, v3, do3, q4, k4, v4, do4


def _fused_gpt_kernel(dev, gen, recs):
    """The fused decode block's GPT instance at GPT-3 1.3B width (hidden
    2048, 16 heads of 128, ffn 8192): one random layer in the model
    tree's layout, re-laid-out by ``fused_layer_params``, 8 slots of
    lengths 0..2048 over one layer of a 4-layer pool of page 64, against
    its plain version; its time over the 4 layers in turn, its phase
    clock."""
    from apex_tpu_torch.inference import models
    from apex_tpu_torch.transformer.testing import GPTConfig
    pa = importlib.import_module("apex_tpu_torch.ops.paged_attention")
    cfg = GPTConfig(**dict(GPT_CFG, num_layers=1))
    tree = _random_gpt(cfg, dev, int(torch.randint(
        1 << 30, (1,), generator=gen, device=dev)))
    blk = models.fused_layer_params("gpt", cfg, tree)[0]
    del tree
    slots, ps, mpps, layers = 8, 64, 32, 4
    hidden, h, d = cfg.hidden_size, cfg.num_attention_heads, 128
    lengths_l = [0, 1, 64, 65, 700, 1024, 1500, 2048]
    n_pages = slots * mpps
    bf = torch.bfloat16
    pool_k = torch.randn(n_pages + 1, layers, h, ps, d, generator=gen,
                         device=dev).to(bf)
    pool_v = torch.randn(n_pages + 1, layers, h, ps, d, generator=gen,
                         device=dev).to(bf)
    perm = torch.randperm(n_pages, generator=gen, device=dev).to(torch.int32)
    table = torch.full((slots, mpps), n_pages, dtype=torch.int32, device=dev)
    cursor = 0
    for i, n in enumerate(lengths_l):
        need = -(-n // ps)
        table[i, :need] = perm[cursor:cursor + need]
        cursor += need
    lengths = torch.tensor(lengths_l, dtype=torch.int32, device=dev)
    x = torch.randn(slots, hidden, generator=gen, device=dev).to(bf)
    kw = dict(kind="gpt", eps=1e-5)
    kp, vp = pool_k[:, 0], pool_v[:, 0]
    got = pa.fused_block_decode(x, blk, kp, vp, table, lengths, **kw)
    ref = pa.fused_block_reference(x, blk, kp, vp, table, lengths, **kw)
    print(f"fused_block_decode (GPT): one GPT-3 1.3B layer (hidden {hidden}, "
          f"{h} heads of {d}, ffn {cfg.ffn}), 8 slots, lengths {lengths_l}, "
          f"page {ps}")
    err = 0.0
    for name, g_, r_ in zip(("y", "k_tok", "v_tok"), got, ref):
        e = (g_.float() - r_.float()).abs().max().item()
        rel = ((g_.float() - r_.float()).norm() / r_.float().norm()).item()
        _check(f"fused GPT {name}", e,
               TOL_FUSED_REL * r_.float().abs().max().item())
        print(f"    relative L2 {rel:.4g} (limit {TOL_FUSED_REL_L2})")
        if rel > TOL_FUSED_REL_L2:
            raise AssertionError(f"fused GPT {name}: relative L2 {rel}")
        err = max(err, e)
    del got, ref
    mats = sum(t.numel() for n, t in blk.items() if n.startswith("w"))
    vecs = sum(t.numel() for n, t in blk.items() if not n.startswith("w"))
    live = sum(lengths_l)
    nbytes = 2 * mats + 4 * vecs + live * h * d * 2 * 2 \
        + 2 * 2 * x.numel() + 2 * 2 * slots * h * d + 4 * table.numel() \
        + 4 * slots
    bound, by = _bound(nbytes, 2 * slots * mats + 4 * (live + slots) * h * d)
    views = itertools.cycle([(pool_k[:, i], pool_v[:, i])
                             for i in range(layers)])
    ms = _queued_ms(lambda: pa.fused_block_decode(
        x, blk, *next(views), table, lengths, **kw), 40)
    eager = _eager_ms(lambda: pa.fused_block_decode(
        x, blk, *next(views), table, lengths, **kw), 40)
    plain_ms = _eager_ms(lambda: pa.fused_block_reference(
        x, blk, *next(views), table, lengths, **kw), 3)
    print(f"  fused_block_decode (GPT) on {_smi()}: {mats} weights "
          f"({2 * mats / 1e6:.1f} MB) + {live} live tokens' k/v; {ms:.4f} ms "
          f"per call (40 calls queued behind a sleeping card; eager, host "
          f"included, {eager:.4f} ms), plain {plain_ms:.4f} ms, bound "
          f"{bound:.4f} ms ({by}), {100 * bound / ms:.1f}% of the bound")
    kvh, ps_, d_, h_ = pa._fused_geometry(x, blk, kp, vp, table, lengths,
                                          "gpt", None, None, False)
    clock = torch.zeros(len(FUSED_PHASES) + 1, dtype=torch.int64,
                        device=dev)
    runs = []
    for _ in range(10):
        clock.zero_()
        pa._fused_kernel_call(x, blk, kp, vp, table, lengths, None, None,
                              1e-5, d ** -0.5, True, kvh, ps_, d_, h_,
                              clock=clock, kind="gpt")
        runs.append(np.diff(np.asarray(clock.tolist(), np.int64)) / 1e3)
    us = np.median(np.stack(runs), axis=0)
    print(f"  fused_block_decode (GPT) phases (median of 10 launches, "
          f"{us.sum():.1f} us in all): " + ", ".join(
              f"{n} {t:.1f} us" for n, t in zip(GPT_FUSED_PHASES, us)))
    recs["fused_block_decode_gpt"] = dict(
        name="fused_block_decode_gpt", route="cuda",
        source="apex_tpu_torch/csrc/fused_block_decode.cu",
        replaces="apex_tpu/ops/paged_attention.py:445", max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
        library_ms=None, eager_ms=eager)
    _partial_rows(dev, recs, "gpt", blk, x, pool_k, pool_v, 0, table,
                  lengths, kw)
    del blk, pool_k, pool_v, views
    torch.cuda.empty_cache()


def _fused_kernel(dev, gen, recs, pool_k, pool_v, table, lengths):
    """The fused decode block at Llama-3-8B width: one random layer
    (built in the model tree's layout and re-laid-out by
    ``fused_layer_params``, as the engine does) over one layer of the
    paged case's 32-layer pool, 8 slots, against its plain version; and
    the port's unfused layer on the same inputs, for comparison."""
    from apex_tpu_torch.inference import kv_cache, models
    from apex_tpu_torch.transformer.testing import LlamaConfig
    from apex_tpu_torch.transformer.testing.standalone_llama import (
        _rope_cos_sin)
    pa = importlib.import_module("apex_tpu_torch.ops.paged_attention")
    cfg = LlamaConfig(**dict(FULL_CFG, num_layers=1))
    lp = _random_llama(cfg, dev, int(torch.randint(1 << 30, (1,),
                                                    generator=gen,
                                                    device=dev)),
                       only="layer_0")["layer_0"]
    blk = models.fused_layer_params("llama", cfg, {"layer_0": lp})[0]
    slots, hidden = table.shape[0], cfg.hidden_size
    d, kvh = pool_k.shape[4], pool_k.shape[2]
    h = cfg.num_attention_heads
    window = table.shape[1] * pool_k.shape[3]
    x = torch.randn(slots, hidden, generator=gen, device=dev).to(torch.bfloat16)
    cos_t, sin_t = _rope_cos_sin(window, d, cfg.rope_theta, device=dev)
    pos = torch.clamp(lengths.long(), max=window - 1)
    cos, sin = cos_t.reshape(window, d)[pos], sin_t.reshape(window, d)[pos]
    layer = 9
    kp, vp = pool_k[:, layer], pool_v[:, layer]
    kw = dict(kind="llama", eps=cfg.rms_eps, cos=cos, sin=sin)
    got = pa.fused_block_decode(x, blk, kp, vp, table, lengths, **kw)
    ref = pa.fused_block_reference(x, blk, kp, vp, table, lengths, **kw)
    print(f"fused_block_decode: one Llama-3-8B layer (hidden {hidden}, "
          f"{h} heads over {kvh}, ffn {cfg.ffn}), 8 slots, lengths "
          f"{lengths.tolist()}, layer {layer} of the pool")
    err = 0.0
    for name, g_, r_ in zip(("y", "k_tok", "v_tok"), got, ref):
        e = (g_.float() - r_.float()).abs().max().item()
        rel = ((g_.float() - r_.float()).norm() / r_.float().norm()).item()
        _check(f"fused {name}", e,
               TOL_FUSED_REL * r_.float().abs().max().item())
        print(f"    relative L2 {rel:.4g} (limit {TOL_FUSED_REL_L2})")
        if rel > TOL_FUSED_REL_L2:
            raise AssertionError(f"fused {name}: relative L2 {rel}")
        err = max(err, e)
    del got, ref
    weights = sum(t.numel() for t in blk.values())
    live = int(torch.clamp(lengths, max=window).sum())
    nbytes = 2 * weights + live * kvh * d * 2 * 2 + 2 * 2 * x.numel() \
        + 2 * 2 * slots * kvh * d + 2 * 4 * cos.numel() \
        + 4 * table.numel() + 4 * slots
    flops = 2 * slots * weights + 4 * (live + slots) * h * d
    bound, by = _bound(nbytes, flops)
    # four layers of the pool in turn, as a decode step reads them; the
    # 436 MB of weights never fit in the 50 MB L2
    views = itertools.cycle([(pool_k[:, i], pool_v[:, i])
                             for i in range(layer, layer + 4)])
    ms = _queued_ms(lambda: pa.fused_block_decode(
        x, blk, *next(views), table, lengths, **kw), 40)
    eager = _eager_ms(lambda: pa.fused_block_decode(
        x, blk, *next(views), table, lengths, **kw), 40)
    plain_ms = _eager_ms(lambda: pa.fused_block_reference(
        x, blk, *next(views), table, lengths, **kw), 3)
    print(f"  fused_block_decode: {weights} weights ({2 * weights / 1e6:.1f} "
          f"MB) + {live} live tokens' k/v; {ms:.4f} ms per call (40 calls "
          f"queued behind a sleeping card; eager, host included, "
          f"{eager:.4f} ms), bound {bound:.4f} ms ({by}), "
          f"{nbytes / ms / 1e6:.1f} GB/s")
    _fused_phases(pa, x, blk, kp, vp, table, lengths, kw)
    _partial_rows(dev, recs, "llama", blk, x, pool_k, pool_v, layer, table,
                  lengths, kw)
    # the port's unfused layer on the same inputs: the per-op path with
    # the pool append (which writes each slot's next row, so it runs
    # last) and paged attention over lengths + 1
    cache = kv_cache.PagedKVCache(
        k=pool_k, v=pool_v, page_table=table, lengths=lengths.clone(),
        capacity=torch.full_like(lengths, window))
    dims = models.tp_dims("llama", cfg, 1)
    targets = kv_cache.append_targets(cache)

    def unfused():
        return models._llama_decode_layer(
            lp, x, cache, layer, cos[:, None], sin[:, None], lengths + 1,
            targets, dims, cfg.rms_eps)

    un_eager = _eager_ms(unfused, 40)
    un_graph = _time_ms(unfused, 20)
    print(f"  unfused layer (the port's per-op decode layer, same inputs): "
          f"{un_eager:.4f} ms per eager call, {un_graph:.4f} ms per call "
          f"in CUDA-graph replay; fused / unfused eager "
          f"{ms / un_eager:.3f}")
    recs["fused_block_decode"] = dict(
        name="fused_block_decode", route="cuda",
        source="apex_tpu_torch/csrc/fused_block_decode.cu",
        replaces="apex_tpu/ops/paged_attention.py:445", max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
        library_ms=None, eager_ms=eager)
    del blk, lp, cache, views
    torch.cuda.empty_cache()


def _partial_rows(dev, recs, kind, blk, x, pool_k, pool_v, layer, table,
                  lengths, kw):
    """The fused block's rank-partial instance (V6) at a tp = 2 shard of
    the whole layer ``blk``: each rank's slice (``fused_partition_specs``,
    ``shard_tree``, as the engine cuts it) and its half of the pool's kv
    heads against ``fused_block_reference(partial_out=True)``; the two
    partials summed, plus x (and bo), against the whole layer's
    attention-only block (#8 / #8g, ``fuse_mlp=False``); rank 0's time
    over four layers of the pool in turn, its plain time, its bound
    (the rank's weight slices and its heads' live k/v once) and its
    phase clock (:func:`_partial_clock`)."""
    from apex_tpu_torch.inference import models
    pa = importlib.import_module("apex_tpu_torch.ops.paged_attention")
    name = ("fused_block_decode_gpt" if kind == "gpt"
            else "fused_block_decode") + "_partial"
    tp, kvh = 2, pool_k.shape[2]
    half = kvh // tp
    spec = models.fused_partition_specs([blk], tp)[0]
    shards = [models.shard_tree(blk, spec, tp, r) for r in range(tp)]

    def views(r, i=layer):
        return (pool_k[:, i, r * half:(r + 1) * half],
                pool_v[:, i, r * half:(r + 1) * half])

    whole = pa.fused_block_decode(x, blk, pool_k[:, layer], pool_v[:, layer],
                                  table, lengths, fuse_mlp=False, **kw)[0]
    total = x.float() + (blk["bo"] if kind == "gpt" else 0)
    err = 0.0
    for r, shard in enumerate(shards):
        got = pa.fused_block_decode(x, shard, *views(r), table, lengths,
                                    fuse_mlp=False, partial_out=True, **kw)
        ref = pa.fused_block_reference(x, shard, *views(r), table, lengths,
                                       fuse_mlp=False, partial_out=True, **kw)
        for out, g_, r_ in zip(("partial", "k_tok", "v_tok"), got, ref):
            e = (g_.float() - r_.float()).abs().max().item()
            rel = ((g_.float() - r_.float()).norm()
                   / r_.float().norm()).item()
            _check(f"{name} rank {r} {out}", e,
                   TOL_FUSED_REL * r_.float().abs().max().item())
            if rel > TOL_FUSED_REL_L2:
                raise AssertionError(f"{name} rank {r} {out}: relative L2 "
                                     f"{rel}")
            err = max(err, e)
        total = total + got[0].float()
        del got, ref
    d_sum = (total - whole.float()).abs().max().item()
    rel_sum = ((total - whole.float()).norm() / whole.float().norm()).item()
    print(f"  {name}: the two ranks' partials + x"
          + (" + bo" if kind == "gpt" else "") + f" against the whole "
          f"attention-only block: max|diff| {d_sum:.4g} (limit "
          f"{TOL_PARTIAL_SUM * whole.float().abs().max().item():.4g}), "
          f"relative L2 {rel_sum:.4g}")
    if d_sum > TOL_PARTIAL_SUM * whole.float().abs().max().item() \
            or rel_sum > TOL_FUSED_REL_L2:
        raise AssertionError(f"{name}: the ranks' partials do not sum to "
                             f"the block")
    shard = shards[0]
    d = pool_k.shape[4]
    h = shard["wq"].shape[1] // d
    slots = x.shape[0]
    window = table.shape[1] * pool_k.shape[3]
    live = int(torch.clamp(lengths, max=window).sum())
    mats = sum(shard[n].numel() for n in ("wq", "wk", "wv", "wo"))
    read = ("ln1_w", "ln1_b", "bq", "bk", "bv") if kind == "gpt" \
        else ("ln1_w",)
    vecs = sum(shard[n].numel() * shard[n].element_size() for n in read)
    rope = 0 if kind == "gpt" else 2 * 4 * kw["cos"].numel()
    nbytes = 2 * mats + vecs + live * half * d * 2 * 2 + 2 * 2 * x.numel() \
        + 2 * 2 * slots * half * d + rope + 4 * table.numel() + 4 * slots
    bound, by = _bound(nbytes, 2 * slots * mats + 4 * (live + slots) * h * d)
    cyc = itertools.cycle([views(0, i) for i in range(layer, layer + 4)])
    ms = _queued_ms(lambda: pa.fused_block_decode(
        x, shard, *next(cyc), table, lengths, fuse_mlp=False,
        partial_out=True, **kw), 40)
    eager = _eager_ms(lambda: pa.fused_block_decode(
        x, shard, *next(cyc), table, lengths, fuse_mlp=False,
        partial_out=True, **kw), 40)
    plain_ms = _eager_ms(lambda: pa.fused_block_reference(
        x, shard, *next(cyc), table, lengths, fuse_mlp=False,
        partial_out=True, **kw), 3)
    print(f"  {name} on {_smi()}: a rank of tp = 2, {h} heads over {half} kv "
          f"heads, {mats} weights ({2 * mats / 1e6:.1f} MB) + {live} live "
          f"tokens' k/v of its heads; {ms:.4f} ms per call (40 calls queued "
          f"behind a sleeping card; eager, host included, {eager:.4f} ms), "
          f"plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by}), "
          f"{100 * bound / ms:.1f}% of the bound")
    _print_partial_clock(f"{name} stages (phase clock)", _partial_clock(
        x, shard, *views(0), table, lengths, kw))
    recs[name] = dict(
        name=name, route="cuda",
        source="apex_tpu_torch/csrc/fused_block_partial.cu",
        replaces="apex_tpu/ops/paged_attention.py:445", max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
        library_ms=None, eager_ms=eager)
    del shards, whole, total, cyc


FUSED_PHASES = ("q/k/v", "q/k/v sums + RoPE", "attention",
                "merge + fold + o", "x2 + norm2", "gate/up", "down", "y")
GPT_FUSED_PHASES = ("q/k/v", "q/k/v sums + biases", "attention",
                    "merge + fold + o", "x2 + norm2", "up", "gelu + down",
                    "y")


#: the rank-partial kernel's stages (csrc/fused_block_partial.cu), each
#: from the one before: the last block's norm1 statistics and item plan
#: (its attention items' size from the lengths); the last end of a q/k/v
#: item, of an attention item (with the q/k/v sums, RoPE or biases it
#: reads, and its (slot, kv head)'s merge and fold) and of an o item
#: (with its tile's sums into y); the last block's exit
PARTIAL_STAGES = ("norm1 stats + plan", "q/k/v", "q/k/v sums + attention",
                  "o + y", "exit")
#: the phases of the rank-partial instance as the whole layer's kernel
#: ran it (fused_block_kernel with a partial_out flag, before the kernel
#: of its own: its clock's slots 1-4 and its end in slot 8), for an A/B
#: against such a library
PARTIAL_PHASES_BARRIERS = ("q/k/v", "q/k/v sums", "attention",
                           "merge + fold + o", "y")
PARTIAL_ITEMS = ("q/k/v", "attention", "o")


def _partial_clock(x, blk, kp, vp, table, lengths, kw, runs: int = 10):
    """The rank-partial instance's phase clock, the median over ``runs``
    launches: ``({stage: us}, {item class: (items, us working, us
    waiting on counters, each a mean over the class's items)})``, for
    whatever version of the kernel the library holds (the whole layer's
    kernel with its partial_out flag fills its clock's slots 0-4 and 8,
    and has no items; the kernel of its own slots 0-14)."""
    pa = importlib.import_module("apex_tpu_torch.ops.paged_attention")
    kvh, ps, d, h = pa._fused_geometry(x, blk, kp, vp, table, lengths,
                                       kw["kind"], kw.get("cos"),
                                       kw.get("sin"), True, False)
    clock = torch.zeros(16, dtype=torch.int64, device=x.device)
    got, items, old = [], [], False
    for _ in range(runs):
        clock.zero_()
        pa._fused_kernel_call(x, blk, kp, vp, table, lengths, kw.get("cos"),
                              kw.get("sin"), kw["eps"], d ** -0.5, False,
                              kvh, ps, d, h, clock=clock, kind=kw["kind"],
                              partial_out=True)
        t = np.asarray(clock.tolist(), np.int64)
        old = not t[5]
        if old:
            got.append(np.diff(t[t != 0]) / 1e3)
        else:
            got.append(np.diff(t[:6]) / 1e3)
            sums = t[6:15].reshape(3, 3)
            items.append([(c, w / c / 1e3, wt / c / 1e3) for w, wt, c in sums])
    us = np.median(np.stack(got), axis=0)
    names = PARTIAL_PHASES_BARRIERS if old else PARTIAL_STAGES
    if len(us) != len(names):
        names = [f"stage {i + 1}" for i in range(len(us))]
    per = {} if old else {
        n: tuple(np.median(np.asarray([r[i] for r in items]), axis=0))
        for i, n in enumerate(PARTIAL_ITEMS)}
    return dict(zip(names, us.tolist())), per


def _print_partial_clock(label, clock):
    stages, per = clock
    print(f"  {label} (median of 10 launches, {sum(stages.values()):.1f} us "
          f"in all): " + ", ".join(f"{n} {t:.1f} us"
                                   for n, t in stages.items()))
    if per:
        print(f"    items (a mean an item: working, waiting on counters): "
              + "; ".join(f"{n} x{int(c)} {w:.2f} us, {wt:.2f} us"
                          for n, (c, w, wt) in per.items()))


def _fused_phases(pa, x, blk, kp, vp, table, lengths, kw):
    """Where the fused block's time goes: the kernel's phase clock (block
    0 reads the global timer as it leaves each grid barrier; the last
    block to finish sets the end), the median over 10 launches."""
    kvh, ps, d, h = pa._fused_geometry(x, blk, kp, vp, table, lengths,
                                       kw["kind"], kw["cos"], kw["sin"],
                                       False)
    clock = torch.zeros(len(FUSED_PHASES) + 1, dtype=torch.int64,
                        device=x.device)
    runs = []
    for _ in range(10):
        clock.zero_()
        pa._fused_kernel_call(x, blk, kp, vp, table, lengths, kw["cos"],
                              kw["sin"], kw["eps"], d ** -0.5, True, kvh, ps,
                              d, h, clock=clock)
        runs.append(np.diff(np.asarray(clock.tolist(), np.int64)) / 1e3)
    us = np.median(np.stack(runs), axis=0)
    print(f"  fused_block_decode phases (phase clock, median of 10 launches, "
          f"{us.sum():.1f} us in all): " + ", ".join(
              f"{n} {t:.1f} us" for n, t in zip(FUSED_PHASES, us)))
    return dict(zip(FUSED_PHASES, us.tolist()))


def _chunked(fn, n: int, chunk: int) -> None:
    """``fn(slice)`` over ``[0, n)`` in chunks, results dropped: a plain
    version over a buffer whose full-size temporaries would not fit."""
    for i in range(0, n, chunk):
        fn(slice(i, i + chunk))


def _train_numel() -> int:
    """Elements of the 4-layer training model's flat master."""
    from apex_tpu_torch.inference.weights import llama_param_shapes
    from apex_tpu_torch.transformer.testing import LlamaConfig
    shapes = llama_param_shapes(LlamaConfig(**dict(
        FULL_CFG, num_layers=TRAIN_LAYERS)))
    return sum(int(np.prod(shape)) for shape in shapes.values())


def _train_kernels(dev, gen, recs):
    """The training path's four kernels against their plain versions at
    the train phase's shapes."""
    ln = importlib.import_module("apex_tpu_torch.ops.layer_norm")
    attn = importlib.import_module("apex_tpu_torch.ops.attention")
    fu = importlib.import_module("apex_tpu_torch.ops.fused_update")
    bf = torch.bfloat16

    # -- RMSNorm backward [2048, 4096] bf16, fp32 weight ------------------
    rows, hidden = TRAIN_SEQ, 4096
    x = torch.randn(rows, hidden, generator=gen, device=dev).to(bf)
    dy = torch.randn(rows, hidden, generator=gen, device=dev).to(bf)
    w = 1 + 0.1 * torch.randn(hidden, generator=gen, device=dev)
    dx, dw, _ = ln._bwd_2d(x, w, dy, 1e-5, True)
    rdx, rdw, _ = ln._bwd_reference(x, w, dy, 1e-5, True)
    print("rms_norm backward [2048, 4096] bf16, fp32 weight")
    err = (dx.float() - rdx.float()).abs().max().item()
    _check("rms_norm bwd dx", err, TOL_RMS_REL * rdx.float().abs().max()
           .item())
    _check("rms_norm bwd dw", (dw - rdw).abs().max().item(),
           TOL_NORM_DW_REL * rdw.abs().max().item())
    dx2, dw2, _ = ln._bwd_2d(x, w, dy, 1e-5, True)
    if not (torch.equal(dx, dx2) and torch.equal(dw, dw2)):
        raise AssertionError("the norm backward did not repeat bit for bit")
    del dx2, dw2
    b = 0.1 * torch.randn(hidden, generator=gen, device=dev)
    got, ref = ln._bwd_2d(x, w, dy, 1e-5, False), \
        ln._bwd_reference(x, w, dy, 1e-5, False)
    _check("layer_norm bwd dx", (got[0].float() - ref[0].float()).abs()
           .max().item(), TOL_RMS_REL * ref[0].float().abs().max().item())
    _check("layer_norm bwd db", (got[2] - ref[2]).abs().max().item(),
           TOL_NORM_DW_REL * ref[2].abs().max().item())
    del b, got, ref
    nbytes = 3 * x.numel() * 2 + 2 * hidden * 4
    bound, by = _bound(nbytes, 10 * x.numel(), FP32_FLOPS_PER_S)
    xr = x.clone().requires_grad_()
    wr = w.clone().requires_grad_()
    lib_fb = _time_ms(lambda: torch.autograd.grad(
        F.rms_norm(xr, (hidden,), wr, 1e-5), (xr, wr), dy), 48)
    lib_f = _time_ms(lambda: F.rms_norm(x, (hidden,), w, 1e-5), 48)
    recs["layer_norm_bwd"] = dict(
        name="rms_norm_bwd", route="cuda",
        source="apex_tpu_torch/csrc/layer_norm.cu",
        replaces="apex_tpu/ops/layer_norm.py:114", max_abs_err=err,
        ms=_time_ms(lambda: ln._bwd_2d(x, w, dy, 1e-5, True), 48),
        plain_ms=_time_ms(lambda: ln._bwd_reference(x, w, dy, 1e-5, True),
                          10),
        bound_ms=bound, bound_by=by, library_ms=lib_fb - lib_f,
        eager_ms=_eager_ms(lambda: ln._bwd_2d(x, w, dy, 1e-5, True), 50))
    # where the row's time goes: the row kernel and the partials' reduce
    _device_breakdown("rms_norm backward [2048, 4096] (_bwd_2d)",
                      lambda: ln._bwd_2d(x, w, dy, 1e-5, True), 20, top=3)
    del x, dy, w, dx, dw, rdx, rdw, xr, wr

    # -- flash backward, causal [1, 32, 2048, 128], kv from 8 heads -------
    b_, h, kvh, s, d = 1, 32, 8, TRAIN_SEQ, 128
    q = torch.randn(b_, h, s, d, generator=gen, device=dev).to(bf)
    kk = torch.randn(b_, kvh, s, d, generator=gen, device=dev).to(bf)
    vv = torch.randn(b_, kvh, s, d, generator=gen, device=dev).to(bf)
    do = torch.randn(b_, h, s, d, generator=gen, device=dev).to(bf)
    k, v = (t[:, :, None].expand(b_, kvh, h // kvh, s, d)
            .reshape(b_, h, s, d) for t in (kk, vv))
    scale = d ** -0.5
    q3, k3, v3, do3 = (t.reshape(b_ * h, s, d).contiguous()
                       for t in (q, k, v, do))
    out, lse = attn._fwd(q3, k3, v3, True, scale)
    got = attn._bwd(q3, k3, v3, out, lse, do3, True, scale)
    ref = attn._bwd_reference(q3, k3, v3, out, lse, do3, True, scale)
    exact = _by_heads(lambda sl: _exact_md(q3[sl], k3[sl], v3[sl], do3[sl],
                                           True, scale), b_ * h, 8)
    print("flash_attention backward causal [1, 32, 2048, 128] bf16")
    err = _check_flash_bwd_exact("flash bwd", got, ref, exact)
    _hold_wrong_backwards(lambda **kw: attn._bwd_reference(
        q3, k3, v3, out, lse, do3, True, scale, **kw), ref, exact, s)
    del got, ref, exact
    nbytes = 8 * q3.numel() * 2 + 2 * b_ * h * s * 4
    bound, by = _bound(nbytes, 5 * s * s * d * h)     # 5 products, causal
    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
    lib_fb = _time_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qr, kr, vr, is_causal=True),
        (qr, kr, vr), do), 10)
    lib_f = _time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), 10)
    recs["flash_attention_bwd"] = dict(
        name="flash_attention_bwd", route="cuda",
        source="apex_tpu_torch/csrc/flash_attention_bwd.cu",
        replaces="apex_tpu/ops/attention.py:472", max_abs_err=err,
        ms=_time_ms(lambda: attn._bwd(q3, k3, v3, out, lse, do3, True,
                                      scale), 10),
        plain_ms=_time_ms(lambda: attn._bwd_reference(
            q3, k3, v3, out, lse, do3, True, scale), 3),
        bound_ms=bound, bound_by=by, library_ms=lib_fb - lib_f,
        eager_ms=_eager_ms(lambda: attn._bwd(q3, k3, v3, out, lse, do3,
                                             True, scale), 10))
    # where the row's time goes: delta, the fp32 dq scratch, the kernel
    # and the dq cast
    _device_breakdown("flash backward causal [1, 32, 2048, 128] (_bwd)",
                      lambda: attn._bwd(q3, k3, v3, out, lse, do3, True,
                                        scale), 10, top=6)
    del q, k, v, kk, vv, do, q3, k3, v3, do3, out, lse, qr, kr, vr
    torch.cuda.empty_cache()

    # -- the amp unscale over the flat fp32 grads [1.923e9] ----------------
    n = _train_numel()
    print(f"fused_scale (unscale) over the flat fp32 grads [{n}]")
    g = torch.randn(n, generator=gen, device=dev).mul_(1000.0)
    inv = torch.full((), 2.0 ** -16, device=dev)
    outk, flag = fu.fused_scale(g, inv)
    chunk = 1 << 27
    err = 0.0
    for i in range(0, n, chunk):
        ref, _ = fu._scale_reference(g[i:i + chunk], inv, torch.float32)
        err = max(err, (outk[i:i + chunk] - ref).abs().max().item())
    _check("fused_scale out", err, 0.0)
    if flag.item() != 0.0:
        raise AssertionError("a finite buffer raised the overflow flag")
    g[n - 5] = float("inf")                      # past 2^32 bytes
    _, flag = fu.fused_scale(g, inv, out=outk)
    if flag.item() != 1.0:
        raise AssertionError("an inf past 2^32 bytes was not flagged")
    g[n - 5] = 0.0
    del outk
    found = torch.zeros((), device=dev)
    recs["fused_scale"] = dict(
        name="fused_scale", route="cuda",
        source="apex_tpu_torch/csrc/fused_update.cu",
        replaces="apex_tpu/ops/fused_update.py:132", max_abs_err=err,
        ms=_time_ms(lambda: fu.fused_scale(g, inv, out=g), 4),
        plain_ms=_time_ms(lambda: _chunked(lambda sl: fu._scale_reference(
            g[sl], inv, torch.float32), n, chunk), 1),
        library_ms=_time_ms(
            lambda: torch._amp_foreach_non_finite_check_and_unscale_(
                [g], found, inv), 4),
        eager_ms=_eager_ms(lambda: fu.fused_scale(g, inv, out=g), 4))
    recs["fused_scale"]["bound_ms"], recs["fused_scale"]["bound_by"] = \
        _bound(8 * n, n, FP32_FLOPS_PER_S)
    del g
    torch.cuda.empty_cache()

    # -- Adam over the flat fp32 master, grads, moments [1.923e9] ----------
    print(f"fused_adam_flat over flat fp32 p, g, m, v [{n}]")
    p = torch.randn(n, generator=gen, device=dev)
    g = torch.randn(n, generator=gen, device=dev)
    m = 0.1 * torch.randn(n, generator=gen, device=dev)
    v = torch.rand(n, generator=gen, device=dev).mul_(0.01)
    kw = dict(lr=TRAIN_LR, beta1=0.9, beta2=0.999, eps=1e-8,
              weight_decay=0.01, step=torch.full((), 3.0, device=dev))
    p0, m0, v0 = p.clone(), m.clone(), v.clone()
    fu.fused_adam_flat(p, g, m, v, **kw)
    hp = fu._adam_hparams(dev, noop_flag=0.0, bias_correction=True,
                          grad_scale=1.0, **{k_: kw[k_] for k_ in (
                              "lr", "beta1", "beta2", "eps",
                              "weight_decay", "step")})
    err = 0.0
    for i in range(0, n, chunk):
        sl = slice(i, i + chunk)
        rp, rm, rv = fu._adam_kernel_reference(p0[sl], g[sl], m0[sl],
                                               v0[sl], hp, True)
        err = max(err, (p[sl] - rp).abs().max().item(),
                  (m[sl] - rm).abs().max().item(),
                  (v[sl] - rv).abs().max().item())
    _check("fused_adam p/m/v", err, TOL_ADAM)
    snap = p.clone()
    fu.fused_adam_flat(p, g, m, v, noop_flag=torch.ones((), device=dev),
                       **kw)
    if not torch.equal(p, snap):
        raise AssertionError("the noop flag changed p")
    del p0, m0, v0, snap
    steps = torch.full((), 3.0, device=dev)
    recs["fused_adam"] = dict(
        name="fused_adam", route="cuda",
        source="apex_tpu_torch/csrc/fused_update.cu",
        replaces="apex_tpu/ops/fused_update.py:274", max_abs_err=err,
        ms=_time_ms(lambda: fu.fused_adam_flat(p, g, m, v, **kw), 4),
        plain_ms=_time_ms(lambda: _chunked(
            lambda sl: fu._adam_kernel_reference(p[sl], g[sl], m[sl], v[sl],
                                                 hp, True), n, chunk), 1),
        library_ms=_time_ms(lambda: torch._fused_adamw_(
            [p], [g], [m], [v], [], [steps], lr=TRAIN_LR, beta1=0.9,
            beta2=0.999, weight_decay=0.01, eps=1e-8, amsgrad=False,
            maximize=False), 4),
        eager_ms=_eager_ms(lambda: fu.fused_adam_flat(p, g, m, v, **kw), 4))
    recs["fused_adam"]["bound_ms"], recs["fused_adam"]["bound_by"] = \
        _bound(28 * n, 15 * n, FP32_FLOPS_PER_S)
    del p, g, m, v
    torch.cuda.empty_cache()


def _max_rel_err(pairs):
    """``(max |got - ref|, max |ref|)`` over ``(got, ref)`` pairs."""
    err = ref_max = 0.0
    for got, ref in pairs:
        err = max(err, (got - ref).abs().max().item())
        ref_max = max(ref_max, ref.abs().max().item())
    return err, ref_max


def _check_update(name, fu_ref, outs, ins, hp, flags, n, chunk):
    """Hold each output of an update kernel against its plain version,
    slice by slice (``fu_ref(*ins, hp, *flags)`` on the same slices);
    returns the largest max |diff|."""
    worst = 0.0
    for k, out in enumerate(outs):
        err, ref_max = _max_rel_err(
            (out[i:i + chunk],
             fu_ref(*(t[i:i + chunk] for t in ins), hp, *flags)[k])
            for i in range(0, n, chunk))
        _check(f"{name} output {k}", err, TOL_UPDATE_REL * ref_max)
        worst = max(worst, err)
    return worst


def _optimizer_kernels(dev, gen, recs):
    """The optimizer family's four kernels against their plain versions
    at the train phase's flat shape (1.923e9 fp32 elements), with the
    noop bit-identity of the three update kernels."""
    fu = importlib.import_module("apex_tpu_torch.ops.fused_update")
    n = _train_numel()
    chunk = 1 << 27
    one = torch.ones((), device=dev)
    src = "apex_tpu_torch/csrc/fused_update.cu"

    # -- the L2 norm (LAMB's global and per-leaf norms, the clipper) ------
    print(f"fused_l2norm over a flat fp32 buffer [{n}]")
    x = torch.randn(n, generator=gen, device=dev)
    got = fu.fused_l2norm(x)
    ref = torch.empty((), device=dev)
    fu._l2norm_plain(x, ref)
    err = abs(got.item() - ref.item())
    _check("fused_l2norm", err, TOL_L2NORM_REL * ref.item())
    if not all(torch.equal(fu.fused_l2norm(x), got) for _ in range(3)):
        raise AssertionError("fused_l2norm differs from run to run")
    print(f"  norm {got.item():.9g}, the same bits in 3 more runs")
    recs["fused_l2norm"] = dict(
        name="fused_l2norm", route="cuda", source=src,
        replaces="apex_tpu/ops/fused_update.py:206", max_abs_err=err,
        ms=_time_ms(lambda: fu.fused_l2norm(x), 8),
        plain_ms=_time_ms(lambda: fu._l2norm_plain(x, ref), 1),
        library_ms=_time_ms(lambda: torch.linalg.vector_norm(x), 8),
        eager_ms=_eager_ms(lambda: fu.fused_l2norm(x), 8))
    recs["fused_l2norm"]["bound_ms"], recs["fused_l2norm"]["bound_by"] = \
        _bound(4 * n, 2 * n, FP32_FLOPS_PER_S)
    del x
    torch.cuda.empty_cache()

    # -- LAMB phase 1 over p, g, m, v -> m, v, u [1.923e9] -----------------
    print(f"fused_lamb_phase1_flat over flat fp32 p, g, m, v, u [{n}]")
    p = torch.randn(n, generator=gen, device=dev)
    g = torch.randn(n, generator=gen, device=dev)
    m = 0.1 * torch.randn(n, generator=gen, device=dev)
    v = torch.rand(n, generator=gen, device=dev).mul_(0.01).add_(0.01)
    u = torch.empty_like(p)
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-6, weight_decay=0.01,
              step=torch.full((), 3.0, device=dev),
              grad_scale=torch.full((), 0.5, device=dev))
    hp = fu._lamb1_hparams(dev, noop_flag=0.0, bias_correction=True,
                           grad_averaging=True, **kw)
    m0, v0 = m.clone(), v.clone()
    fu.fused_lamb_phase1_flat(p, g, m, v, u=u, **kw)
    err = _check_update("fused_lamb1", fu._lamb1_kernel_reference,
                        (m, v, u), (p, g, m0, v0), hp, (), n, chunk)
    m0.copy_(m)
    v0.copy_(v)
    fu.fused_lamb_phase1_flat(p, g, m, v, u=u, noop_flag=one, **kw)
    if not (torch.equal(m, m0) and torch.equal(v, v0)
            and not bool(u.any())):
        raise AssertionError("the LAMB noop changed m or v, or left u")
    del m0, v0
    recs["fused_lamb1"] = dict(
        name="fused_lamb_phase1", route="cuda", source=src,
        replaces="apex_tpu/ops/fused_update.py:495", max_abs_err=err,
        ms=_time_ms(lambda: fu.fused_lamb_phase1_flat(p, g, m, v, u=u, **kw),
                    4),
        plain_ms=_time_ms(lambda: _chunked(
            lambda sl: fu._lamb1_kernel_reference(p[sl], g[sl], m[sl], v[sl],
                                                  hp), n, chunk), 1),
        library_ms=None,
        eager_ms=_eager_ms(lambda: fu.fused_lamb_phase1_flat(
            p, g, m, v, u=u, **kw), 4))
    recs["fused_lamb1"]["bound_ms"], recs["fused_lamb1"]["bound_by"] = \
        _bound(28 * n, 16 * n, FP32_FLOPS_PER_S)
    del m, v, u
    torch.cuda.empty_cache()

    # -- SGD (momentum 0.9, nesterov) over p, g, buf [1.923e9] -------------
    print(f"fused_sgd_flat over flat fp32 p, g, buf [{n}]")
    buf = torch.randn(n, generator=gen, device=dev)
    kw = dict(lr=SGD_KW["lr"], momentum=SGD_KW["momentum"], dampening=0.0,
              weight_decay=0.0, first_run=torch.zeros((), device=dev),
              grad_scale=1.0)
    hp = fu._sgd_hparams(dev, noop_flag=0.0, **kw)
    p0, b0 = p.clone(), buf.clone()
    fu.fused_sgd_flat(p, g, buf, nesterov=True, **kw)
    err = _check_update("fused_sgd", fu._sgd_kernel_reference, (p, buf),
                        (p0, g, b0), hp, (True, False), n, chunk)
    p0.copy_(p)
    b0.copy_(buf)
    fu.fused_sgd_flat(p, g, buf, nesterov=True, noop_flag=one, **kw)
    if not (torch.equal(p, p0) and torch.equal(buf, b0)):
        raise AssertionError("the SGD noop changed p or buf")
    del p0, b0
    recs["fused_sgd"] = dict(
        name="fused_sgd", route="cuda", source=src,
        replaces="apex_tpu/ops/fused_update.py:427", max_abs_err=err,
        ms=_time_ms(lambda: fu.fused_sgd_flat(p, g, buf, nesterov=True,
                                              **kw), 4),
        plain_ms=_time_ms(lambda: _chunked(
            lambda sl: fu._sgd_kernel_reference(p[sl], g[sl], buf[sl], hp,
                                                True, False), n, chunk), 1),
        library_ms=_time_ms(lambda: torch._fused_sgd_(
            [p], [g], [buf], weight_decay=0.0, momentum=SGD_KW["momentum"],
            lr=SGD_KW["lr"], dampening=0.0, nesterov=True, maximize=False,
            is_first_step=False), 4),
        eager_ms=_eager_ms(lambda: fu.fused_sgd_flat(p, g, buf,
                                                     nesterov=True, **kw), 4))
    recs["fused_sgd"]["bound_ms"], recs["fused_sgd"]["bound_by"] = \
        _bound(20 * n, 7 * n, FP32_FLOPS_PER_S)
    del buf
    torch.cuda.empty_cache()

    # -- Adagrad over p, g, h [1.923e9] ------------------------------------
    print(f"fused_adagrad_flat over flat fp32 p, g, h [{n}]")
    h = torch.rand(n, generator=gen, device=dev)
    kw = dict(lr=ADAGRAD_KW["lr"], eps=1e-10, weight_decay=0.0,
              grad_scale=1.0)
    hp = fu._adagrad_hparams(dev, noop_flag=0.0, **kw)
    p0, h0 = p.clone(), h.clone()
    fu.fused_adagrad_flat(p, g, h, **kw)
    err = _check_update("fused_adagrad", fu._adagrad_kernel_reference,
                        (p, h), (p0, g, h0), hp, (False,), n, chunk)
    p0.copy_(p)
    h0.copy_(h)
    fu.fused_adagrad_flat(p, g, h, noop_flag=one, **kw)
    if not (torch.equal(p, p0) and torch.equal(h, h0)):
        raise AssertionError("the Adagrad noop changed p or h")
    del p0, h0
    steps = torch.zeros((), device=dev)
    recs["fused_adagrad"] = dict(
        name="fused_adagrad", route="cuda", source=src,
        replaces="apex_tpu/ops/fused_update.py:375", max_abs_err=err,
        ms=_time_ms(lambda: fu.fused_adagrad_flat(p, g, h, **kw), 4),
        plain_ms=_time_ms(lambda: _chunked(
            lambda sl: fu._adagrad_kernel_reference(p[sl], g[sl], h[sl], hp,
                                                    False), n, chunk), 1),
        library_ms=_time_ms(lambda: torch._fused_adagrad_(
            [p], [g], [h], [steps], lr=ADAGRAD_KW["lr"], lr_decay=0.0,
            weight_decay=0.0, eps=1e-10, maximize=False), 4),
        eager_ms=_eager_ms(lambda: fu.fused_adagrad_flat(p, g, h, **kw), 4))
    recs["fused_adagrad"]["bound_ms"], recs["fused_adagrad"]["bound_by"] = \
        _bound(20 * n, 7 * n, FP32_FLOPS_PER_S)
    del p, g, h
    torch.cuda.empty_cache()


def _by_heads(fn, n: int, step: int):
    """``fn(slice)`` over ``[0, n)`` in slices of ``step`` heads, the
    results concatenated (a tuple of outputs each along dim 0)."""
    parts = [fn(slice(i, i + step)) for i in range(0, n, step)]
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts)
    return tuple(torch.cat(p) for p in zip(*parts))


def _split_kernels(dev, gen, recs):
    """The split flash backward (#5 dq, #6 dk/dv) at causal [1, 32,
    8192, 128] bf16 with k/v from 8 kv heads, the 8192-token training
    run's shape: against their plain versions computed 4 heads at a time
    (the plain version's [h, 8192, 8192] fp32 temporaries are 1 GiB
    each at 4 heads) and the exact float64 gradient 2 heads at a time
    (``_check_flash_bwd_exact``), with the one-pass backward's two wrong
    backwards, which must fail that gate; two runs bit for bit; and the
    route's time beside the one-pass kernel forced onto the same shape
    and SDPA's backward."""
    from apex_tpu_torch.ops import _build
    attn = importlib.import_module("apex_tpu_torch.ops.attention")
    bf = torch.bfloat16
    b_, h, kvh, s, d = 1, 32, 8, SPLIT_SEQ, 128
    q = torch.randn(b_, h, s, d, generator=gen, device=dev).to(bf)
    kk = torch.randn(b_, kvh, s, d, generator=gen, device=dev).to(bf)
    vv = torch.randn(b_, kvh, s, d, generator=gen, device=dev).to(bf)
    do = torch.randn(b_, h, s, d, generator=gen, device=dev).to(bf)
    k, v = (t[:, :, None].expand(b_, kvh, h // kvh, s, d)
            .reshape(b_, h, s, d) for t in (kk, vv))
    scale = d ** -0.5
    q3, k3, v3, do3 = (t.reshape(b_ * h, s, d).contiguous()
                       for t in (q, k, v, do))
    out, lse = attn._fwd(q3, k3, v3, True, scale)
    delta = attn._delta(out, do3)
    args = (q3, k3, v3, lse, delta, do3, True, scale)
    if not attn._split_bwd(s, d):
        raise AssertionError(f"sq {s}, d {d} must take the split route")
    before = _build.launch_counts()
    got = attn._bwd(q3, k3, v3, out, lse, do3, True, scale)
    counts = {k_: v_ - before[k_] for k_, v_ in _build.launch_counts().items()}
    if counts["flash_attention_bwd_dq"] != 1 \
            or counts["flash_attention_bwd_dkv"] != 1 \
            or counts["flash_attention_bwd"] != 0:
        raise AssertionError(f"the 8192 backward did not take the split "
                             f"route: {counts}")

    def plain(sl, **kw):
        part = tuple(t[sl] for t in args[:6]) + args[6:]
        return (attn._dq_reference(*part, **kw),
                *attn._dkv_reference(*part, **kw))

    step = 4
    ref = _by_heads(plain, b_ * h, step)
    exact = _by_heads(lambda sl: _exact_md(q3[sl], k3[sl], v3[sl], do3[sl],
                                           True, scale), b_ * h, 2)
    print(f"flash_attention backward, split route (dq kernel + dk/dv "
          f"kernel), causal [{b_}, {h}, {s}, {d}] bf16, kv from {kvh} heads")
    _check_flash_bwd_exact("flash bwd split", got, ref, exact)
    errs = [(g_.float() - r_.float()).abs().max().item()
            for g_, r_ in zip(got, ref)]
    _hold_wrong_backwards(lambda **kw: _by_heads(lambda sl: plain(sl, **kw),
                                                 b_ * h, step),
                          ref, exact, s)
    del ref, exact
    again = attn._bwd(q3, k3, v3, out, lse, do3, True, scale)
    same = [torch.equal(a_, b2) for a_, b2 in zip(got, again)]
    print(f"  a second run of the split route: dq, dk, dv bit-identical "
          f"{same}")
    if not all(same):
        raise AssertionError("the split backward differs from run to run")
    saved = attn._FUSED_BWD_MAX_BYTES
    attn._FUSED_BWD_MAX_BYTES = 1 << 62      # force the one-pass kernel
    try:
        one = attn._bwd(q3, k3, v3, out, lse, do3, True, scale)
        one_ms = _time_ms(lambda: attn._bwd(q3, k3, v3, out, lse, do3, True,
                                            scale), 4)
    finally:
        attn._FUSED_BWD_MAX_BYTES = saved
    same = [torch.equal(a_, b2) for a_, b2 in zip(got, one)]
    print("  split vs the one-pass kernel on the same inputs: "
          + ", ".join(f"{nm} bit-identical {eq}, relative "
                      f"L2 {((a_.float() - b2.float()).norm() / b2.float().norm()).item():.3e}"
                      for nm, eq, a_, b2 in zip(("dq", "dk", "dv"), same, got,
                                                one)))
    if not (same[1] and same[2]):
        raise AssertionError("split dk/dv differ from the one-pass kernel's")
    del again, one
    split_ms = _time_ms(lambda: attn._bwd(q3, k3, v3, out, lse, do3, True,
                                          scale), 4)
    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
    lib_fb = _time_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qr, kr, vr, is_causal=True),
        (qr, kr, vr), do), 4)
    lib_f = _time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), 4)
    del qr, kr, vr
    dq_ms = _time_ms(lambda: attn._dq_kernel(*args), 4)
    dkv_ms = _time_ms(lambda: attn._dkv_kernel(*args), 4)
    print(f"  the route on {_smi()}: split (delta, dq kernel, dk/dv kernel) "
          f"{split_ms:.4f} ms = dq {dq_ms:.4f} + dk/dv {dkv_ms:.4f} ms; the "
          f"one-pass kernel forced onto this shape {one_ms:.4f} ms; SDPA "
          f"backward (fwd+bwd - fwd) {lib_fb - lib_f:.4f} ms")
    _device_breakdown(f"flash backward split route causal [1, 32, {s}, 128] "
                      f"(_bwd)", lambda: attn._bwd(q3, k3, v3, out, lse, do3,
                                                   True, scale), 4, top=6)
    # one causal product of the shape: 2 s^2 d h / 2 flops
    product = s * s * d * h
    elem = q3.numel() * 2
    stats = 2 * b_ * h * s * 4                          # lse, delta
    for name, fn, ref_fn, products, outs, ms, err in (
            ("flash_attention_bwd_dq", attn._dq_kernel, attn._dq_reference,
             3, 1, dq_ms, errs[0]),
            ("flash_attention_bwd_dkv", attn._dkv_kernel,
             attn._dkv_reference, 4, 2, dkv_ms, max(errs[1:]))):
        bound, by = _bound(4 * elem + stats + outs * elem, products * product)
        recs[name] = dict(
            name=name, route="cuda",
            source="apex_tpu_torch/csrc/flash_attention_bwd.cu",
            replaces=("apex_tpu/ops/attention.py:376" if outs == 1 else
                      "apex_tpu/ops/attention.py:408"),
            max_abs_err=err, ms=ms,
            plain_ms=_eager_ms(lambda: _by_heads(
                lambda sl: ref_fn(*(t[sl] for t in args[:6]), *args[6:]),
                b_ * h, step), 1),
            bound_ms=bound, bound_by=by, library_ms=lib_fb - lib_f,
            eager_ms=_eager_ms(lambda: fn(*args), 4))
    del q, k, v, kk, vv, do, q3, k3, v3, do3, out, lse, delta, got, args
    torch.cuda.empty_cache()


def _shim_kernels(dev, gen, recs):
    """The multi_tensor_apply shim's two kernels (#10 axpby, #12 the
    fused scale and norm) over the 4-layer training model's flat length
    (1.923e9 fp32 elements) against their plain versions slice by slice,
    a bf16-in, bf16-out case of each, the norm's run-to-run bit
    identity, and an inf past 2^32 bytes raising each flag."""
    fu = importlib.import_module("apex_tpu_torch.ops.fused_update")
    n = _train_numel()
    chunk = 1 << 27
    src = "apex_tpu_torch/csrc/fused_update.cu"
    f32, bf = torch.float32, torch.bfloat16

    # -- axpby: out = a x + b y ---------------------------------------------
    print(f"fused_axpby over flat fp32 x, y [{n}]")
    x = torch.randn(n, generator=gen, device=dev)
    y = torch.randn(n, generator=gen, device=dev)
    a_, b_ = torch.full((), 0.75, device=dev), torch.full((), -1.5, device=dev)
    ab = torch.stack([a_, b_])

    def held(label, out, flag, ref_of, limit):
        err = 0.0
        for i in range(0, n, chunk):
            r = ref_of(slice(i, i + chunk))
            err = max(err, (out[i:i + chunk].float() - r.float()).abs()
                      .max().item())
        _check(label, err, limit)
        if flag.item() != 0.0:
            raise AssertionError(f"{label}: a finite buffer raised the flag")
        return err

    out, flag = fu.fused_axpby(a_, x, b_, y)
    err = held("fused_axpby fp32", out, flag, lambda sl: fu._axpby_reference(
        x[sl], y[sl], ab, f32)[0], TOL_AXPBY)
    del out
    xb, yb = x.to(bf), y.to(bf)
    out, flag = fu.fused_axpby(a_, xb, b_, yb)
    err = max(err, held("fused_axpby bf16 -> bf16", out, flag,
                        lambda sl: fu._axpby_reference(xb[sl], yb[sl], ab,
                                                       bf)[0], TOL_AXPBY))
    del out, xb, yb
    y[n - 5] = float("inf")                      # past 2^32 bytes
    _, flag = fu.fused_axpby(a_, x, b_, y)
    if flag.item() != 1.0:
        raise AssertionError("fused_axpby: an inf past 2^32 bytes was not "
                             "flagged")
    y[n - 5] = 0.0
    add_ms = _time_ms(lambda: torch.add(x, y, alpha=-1.5), 4)
    recs["fused_axpby"] = dict(
        name="fused_axpby", route="cuda", source=src,
        replaces="apex_tpu/ops/fused_update.py:167", max_abs_err=err,
        ms=_time_ms(lambda: fu.fused_axpby(a_, x, b_, y), 4),
        plain_ms=_time_ms(lambda: _chunked(lambda sl: fu._axpby_reference(
            x[sl], y[sl], ab, f32), n, chunk), 1),
        library_ms=None,
        eager_ms=_eager_ms(lambda: fu.fused_axpby(a_, x, b_, y), 4))
    recs["fused_axpby"]["bound_ms"], recs["fused_axpby"]["bound_by"] = \
        _bound(12 * n, 3 * n, FP32_FLOPS_PER_S)
    print(f"  for orientation only (no flag, a = 1): torch.add(x, y, "
          f"alpha=b) {add_ms:.4f} ms")
    del y
    torch.cuda.empty_cache()

    # -- the fused scale and norm: out = x * scale, ||x * scale|| -----------
    print(f"fused_l2norm_scale over a flat fp32 buffer [{n}]")
    x.mul_(1000.0)
    inv = torch.full((), 2.0 ** -16, device=dev)
    out, norm, flag = fu.fused_l2norm_scale(x, inv)
    err = held("fused_l2norm_scale out", out, flag,
               lambda sl: fu._l2norm_scale_reference(x[sl], inv, f32)[0],
               TOL_L2NORM_SCALE_OUT)
    rout = torch.empty_like(out)
    rnorm, rflag = torch.empty((), device=dev), torch.zeros((), device=dev)
    fu._l2norm_scale_plain(x, inv, rout, rnorm, rflag)
    del rout
    nerr = abs(norm.item() - rnorm.item())
    _check("fused_l2norm_scale norm", nerr, TOL_L2NORM_REL * rnorm.item())
    if not all(torch.equal(fu.fused_l2norm_scale(x, inv)[1], norm)
               for _ in range(2)):
        raise AssertionError("fused_l2norm_scale's norm differs from run to "
                             "run")
    print(f"  norm {norm.item():.9g}, the same bits in 2 more runs")
    del out
    xb = x.to(bf)
    outb, normb, flag = fu.fused_l2norm_scale(xb, inv)
    held("fused_l2norm_scale bf16 -> bf16 out", outb, flag,
         lambda sl: fu._l2norm_scale_reference(xb[sl], inv, bf)[0],
         TOL_L2NORM_SCALE_OUT)
    rout = torch.empty_like(outb)
    fu._l2norm_scale_plain(xb, inv, rout, rnorm, rflag)
    _check("fused_l2norm_scale bf16 norm", abs(normb.item() - rnorm.item()),
           TOL_L2NORM_REL * rnorm.item())
    del outb, rout, xb
    x[n - 5] = float("inf")
    _, _, flag = fu.fused_l2norm_scale(x, inv)
    if flag.item() != 1.0:
        raise AssertionError("fused_l2norm_scale: an inf past 2^32 bytes was "
                             "not flagged")
    x[n - 5] = 0.0
    recs["fused_l2norm_scale"] = dict(
        name="fused_l2norm_scale", route="cuda", source=src,
        replaces="apex_tpu/ops/fused_update.py:232", max_abs_err=max(err, nerr),
        ms=_time_ms(lambda: fu.fused_l2norm_scale(x, inv), 4),
        plain_ms=_time_ms(lambda: _chunked(
            lambda sl: fu._l2norm_scale_reference(x[sl], inv, f32), n, chunk),
            1),
        library_ms=None,
        eager_ms=_eager_ms(lambda: fu.fused_l2norm_scale(x, inv), 4))
    recs["fused_l2norm_scale"]["bound_ms"], \
        recs["fused_l2norm_scale"]["bound_by"] = \
        _bound(8 * n, 3 * n, FP32_FLOPS_PER_S)
    del x, rnorm, rflag
    torch.cuda.empty_cache()


def _random_llama(cfg, dev, seed: int, only=None):
    """Llama-3-8B-shaped tree of random bf16 weights from a seeded
    generator: linears N(0, 1/fan_in), norms 1 + N(0, 0.1^2), the
    embedding N(0, 1).  ``only``: the one top-level key to build."""
    from apex_tpu_torch.inference.weights import llama_param_shapes
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    tree: dict = {}
    for path, shape in sorted(llama_param_shapes(cfg).items()):
        if only is not None and path[0] != only:
            continue
        if len(shape) == 1:
            t = 1 + 0.1 * torch.randn(shape, generator=gen, device=dev)
        elif path[0] == "embed_tokens":
            t = torch.randn(shape, generator=gen, device=dev)
        else:
            t = torch.randn(shape, generator=gen, device=dev) \
                * shape[1] ** -0.5
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t.to(torch.bfloat16)
        del t
    return tree


def _random_tree(shapes, dev, seed: int, embed_std: float = 1.0,
                 dtype=torch.bfloat16):
    """A tree of random bf16 weights for ``{path: shape}`` from a seeded
    generator: linear weights ``[out, in]`` N(0, 1/fan_in) (flax
    ``Dense`` kernels ``[in, out]`` likewise), norm weights 1 + N(0,
    0.1^2), biases (norm and linear) N(0, 0.02^2), embeddings and
    position tables N(0, embed_std^2)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    tree: dict = {}
    for path, shape in sorted(shapes.items()):
        t = torch.randn(shape, generator=gen, device=dev)
        if path[-1] == "bias":
            t = 0.02 * t
        elif len(shape) == 1:
            t = 1 + 0.1 * t
        elif "embed" in "/".join(path) or path[-1] == "embedding":
            t = embed_std * t
        elif path[-1] == "kernel":
            t = t * shape[0] ** -0.5
        else:
            t = t * shape[1] ** -0.5
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t.to(dtype)
        del t
    return tree


def _random_gpt(cfg, dev, seed: int, dtype=torch.bfloat16):
    """A GPT tree of random bf16 weights (:func:`_random_tree`); the word
    embedding (the tied head) and the position table N(0, 0.02^2), the
    JAX initialisers' scale, so the logits are of order 1."""
    from apex_tpu_torch.inference.weights import gpt_param_shapes
    return _random_tree(gpt_param_shapes(cfg), dev, seed, embed_std=0.02,
                        dtype=dtype)


def _random_bert(cfg, dev, seed: int):
    from apex_tpu_torch.inference.weights import bert_param_shapes
    return _random_tree(bert_param_shapes(cfg), dev, seed, embed_std=0.02)


def _serve(engine, prompts, label: str, new_tokens: int = NEW_TOKENS):
    """``engine.generate`` over the prompts with the launch counters and
    the telemetry registry zeroed just before; returns the outputs, the
    launch counts, the registry and the peak device memory."""
    from apex_tpu_torch import observability as obs
    from apex_tpu_torch.ops import _build
    reg = obs.reset_global_registry()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    outs = engine.generate(prompts, max_new_tokens=new_tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    ttft = reg.declared("serve_ttft_seconds")
    dec = reg.declared("serve_decode_token_seconds")
    gen_tokens = sum(len(o) for o in outs)
    decode_tokens = gen_tokens - len(outs)
    decode_s = dec.sum()
    print(f"{label}: {len(prompts)} requests, prompts "
          f"{[len(p) for p in prompts]}, {gen_tokens} tokens in {wall:.3f} s")
    print(f"  TTFT mean {ttft.sum() / ttft.count():.4f} s, p50<= "
          f"{ttft.quantile(0.5)} s, p99<= {ttft.quantile(0.99)} s")
    print(f"  decode: {dec.count()} steps, {decode_tokens} tokens in "
          f"{decode_s:.4f} s = {decode_tokens / decode_s:.1f} tokens/s")
    print(f"  peak device memory {peak / 2**30:.2f} GiB "
          f"(KV pool {engine.cache_hbm_bytes() / 2**30:.2f} GiB)")
    print(f"  kernel launches during the serve: {launches}")
    if any(len(o) != new_tokens for o in outs):
        raise AssertionError(f"expected {new_tokens} tokens per request, "
                             f"got {[len(o) for o in outs]}")
    if any(not 0 <= t < engine.cfg.vocab_size for o in outs for t in o):
        raise AssertionError("a generated token is outside the vocab")
    return dict(outs=outs, launches=launches, reg=reg, peak_bytes=peak,
                ttft_mean_s=ttft.sum() / ttft.count(),
                decode_tokens_per_s=decode_tokens / decode_s, wall_s=wall,
                decode_step_s=decode_s / dec.count())


N_CHECK = 8


def _decode_logits(engine, prompt, forced=None):
    """Prefill one prompt into slot 0 and decode ``N_CHECK - 1`` steps:
    the ``[N_CHECK, vocab]`` logits, the engine's greedy token at each
    step, and the tokens fed (``forced`` when given, else its own)."""
    cache = engine.init_cache()
    pages = None
    if engine.paged:
        alloc = engine.new_allocator()
        pages = alloc.acquire(alloc.pages_needed(len(prompt) + N_CHECK))
    cache, tok, last = engine.prefill(cache, prompt, 0, pages=pages)
    dec_logits, toks = [last], [int(tok)]
    fed = [forced[0] if forced else toks[0]]
    active = np.zeros((engine.slots,), bool)
    active[0] = True
    for i in range(1, N_CHECK):
        feed = np.zeros((engine.slots,), np.int32)
        feed[0] = fed[-1]
        cache, nxt, logits, _ = engine.decode(cache, feed, active)
        dec_logits.append(logits[0])
        toks.append(int(nxt[0]))
        fed.append(forced[i] if forced else toks[-1])
    return torch.stack(dec_logits), toks, fed


def _full_forward(engine, seq):
    """The full forward ``[s, 1, vocab]`` of a sequence over the engine's
    weights: LLaMA through the port's own full-forward prefill, GPT
    through ``GPTModel`` (built on the meta device, run over the
    engine's tree with ``functional_call``)."""
    from apex_tpu_torch.inference import models
    if engine.kind == "llama":
        return models.prefill_forward("llama", engine.cfg, engine.params,
                                      seq)[0]
    from apex_tpu_torch.transformer.testing import gpt_model_provider
    from apex_tpu_torch.utils import tree_leaves_with_path
    model = gpt_model_provider(engine.cfg, device="meta")
    state = {".".join(path): t for path, t in tree_leaves_with_path(
        models._params_subtree(engine.params))}
    return torch.func.functional_call(model, state, (seq,))


def _check_logits(label, engine, prompt, outs_row, limit, forced=None):
    """Hold one request's engine decode logits against the full forward
    (:func:`_full_forward`) of the prompt and the tokens fed; returns the
    decode logits, the distance and the tokens fed."""
    got, toks, fed = _decode_logits(engine, prompt, forced)
    seq = torch.tensor([prompt + fed[:-1]], dtype=torch.int32,
                       device=engine.device)
    with torch.no_grad():
        full = _full_forward(engine, seq)
    ref = full[len(prompt) - 1:, 0].float()              # [N_CHECK, v]
    del full
    if not torch.isfinite(got).all() or got.shape != ref.shape:
        raise AssertionError(f"{label}: decode logits not finite or "
                             f"misshaped")
    diff = (got - ref).abs().max().item()
    top2 = ref.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * limit
    agree = ref.argmax(-1).cpu() == torch.tensor(toks)
    print(f"check {label} (prompt {len(prompt)}): max|decode - full| "
          f"{diff:.4f} (limit {limit}), tokens equal at "
          f"{int(agree.sum())}/{N_CHECK} positions, {int(decided.sum())} "
          f"with top-2 margin > {2 * limit}; engine.generate tokens equal: "
          f"{toks == outs_row[:N_CHECK]}")
    if diff > limit:
        raise AssertionError(f"{label}: decode logits off by {diff}")
    if not bool(agree[decided.cpu()].all()):
        raise AssertionError(f"{label}: a token with a clear top-2 margin "
                             f"differs")
    return got, diff, fed


@contextlib.contextmanager
def _plain_fused_block():
    """Route the fused decode layers to the fused block's plain version
    (looked up by the model module at call time)."""
    from apex_tpu_torch.inference import models
    pa = importlib.import_module("apex_tpu_torch.ops.paged_attention")
    saved = models.fused_block_decode
    models.fused_block_decode = pa.fused_block_reference
    try:
        yield
    finally:
        models.fused_block_decode = saved


def phase_serve(dev, seed: int, profile: bool = False):
    from apex_tpu_torch.inference import InferenceEngine
    from apex_tpu_torch.transformer.testing import LlamaConfig

    cfg = LlamaConfig(**FULL_CFG)
    t0 = time.perf_counter()
    params = _random_llama(cfg, dev, seed)
    torch.cuda.synchronize()
    print(f"serve: Llama-3-8B random bf16 weights in "
          f"{time.perf_counter() - t0:.1f} s")
    geometry = dict(slots=8, max_seq=4096, page_size=64, num_pages=512,
                    device=dev)
    engine = InferenceEngine("llama", cfg, params, **geometry)
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).tolist()
               for n in PROMPT_LENS]
    served = _serve(engine, prompts, "serve")
    launches = served["launches"]
    missing = [k for k in SERVE_KERNELS
               if k not in FUSED_ONLY and launches[k] <= 0]
    if missing:
        raise AssertionError(f"the serve launched no {missing} kernel")

    # -- the same prompts through a fused engine on the same weights ------
    t0 = time.perf_counter()
    fused = InferenceEngine("llama", cfg, engine.params, decode_fusion="1",
                            **geometry)
    torch.cuda.synchronize()
    layer_bytes = sum(t.numel() * t.element_size()
                      for t in fused._fused_layers[0].values())
    print(f"fused engine: fused layout built in "
          f"{time.perf_counter() - t0:.1f} s, {layer_bytes / 1e6:.1f} MB a "
          f"layer, {cfg.num_layers * layer_bytes / 1e9:.2f} GB in all")
    fserved = _serve(fused, prompts, "fused serve")
    flaunch = fserved["launches"]
    steps = int(fserved["reg"].declared(
        "infer_decode_fused_dispatch_total").total())
    print(f"  fused decode steps {steps}: fused_block_decode launched "
          f"{flaunch['fused_block_decode']} times (want "
          f"{cfg.num_layers} x {steps}), paged_attention "
          f"{flaunch['paged_attention']} times (want 0)")
    if steps <= 0 or flaunch["fused_block_decode"] != cfg.num_layers * steps:
        raise AssertionError("the fused serve did not run one fused block "
                             "per layer per decode step")
    if any(flaunch[k] for k in UNFUSED_ONLY):
        raise AssertionError(f"the fused serve launched the unfused path: "
                             f"{flaunch}")
    missing = [k for k in SERVE_KERNELS
               if k not in UNFUSED_ONLY and flaunch[k] <= 0]
    if missing:
        raise AssertionError(f"the fused serve launched no {missing} kernel")
    launches = dict(launches, **{k: flaunch[k] for k in FUSED_ONLY})

    # -- check: engine prefill + decode against the full forward --------
    # (the fused engine is fed the unfused engine's tokens, so the two
    # decode the same stream and their logits compare position by position)
    worst = worst_fused = 0.0
    for idx in (0, len(prompts) - 1):
        un, d_un, fed = _check_logits(f"request {idx}", engine, prompts[idx],
                                      served["outs"][idx], TOL_LOGITS)
        fu, d_fu, _ = _check_logits(f"request {idx}, fused", fused,
                                    prompts[idx], fserved["outs"][idx],
                                    TOL_LOGITS, forced=fed)
        print(f"  request {idx}: max|fused - unfused decode logits| "
              f"{(fu - un).abs().max().item():.4f} (same tokens fed)")
        worst, worst_fused = max(worst, d_un), max(worst_fused, d_fu)
        del un, fu
    # the same check with the fused block's plain version in place of its
    # kernel: the distance it reads is the algorithm's, not the kernel's
    with _plain_fused_block():
        _, d_plain, _ = _check_logits(
            f"request {len(prompts) - 1}, fused, plain version", fused,
            prompts[-1], fserved["outs"][-1], TOL_LOGITS, forced=fed)
    if profile:
        _profile(engine, prompts, "unfused")
        _profile(fused, prompts, "fused", prefill=False)
    del fused
    torch.cuda.empty_cache()

    # -- the same prompts on the dense slot cache at max_seq 8192 ---------
    # (above decode_attention's 4096 crossover: every decode layer is one
    # launch of the decode kernel, counted as flash_attention_masked,
    # reading the cache in place)
    dense = InferenceEngine("llama", cfg, engine.params, slots=8,
                            max_seq=DENSE_MAX_SEQ, device=dev)
    dserved = _serve(dense, prompts, "dense serve")
    dl = dserved["launches"]
    steps = int(dserved["reg"].declared("infer_decode_dispatch_total")
                .total())
    print(f"  dense decode steps {steps}: flash_attention_masked launched "
          f"{dl['flash_attention_masked']} times (want {cfg.num_layers} x "
          f"{steps}), paged_attention {dl['paged_attention']} and "
          f"fused_block_decode {dl['fused_block_decode']} (want 0)")
    if steps <= 0 or dl["flash_attention_masked"] != cfg.num_layers * steps:
        raise AssertionError("the dense serve did not run one masked flash "
                             "forward per layer per decode step")
    if dl["paged_attention"] or dl["fused_block_decode"] \
            or not dl["layer_norm"] or not dl["flash_attention"]:
        raise AssertionError(f"the dense serve's launches are off: {dl}")
    worst_dense = 0.0
    for idx in (0, len(prompts) - 1):
        _, d_dense, _ = _check_logits(f"request {idx}, dense", dense,
                                      prompts[idx], dserved["outs"][idx],
                                      TOL_LOGITS)
        worst_dense = max(worst_dense, d_dense)
    launches["flash_attention_masked"] = dl["flash_attention_masked"]
    del dense
    torch.cuda.empty_cache()
    return dict(launches=launches, ttft_mean_s=served["ttft_mean_s"],
                decode_tokens_per_s=served["decode_tokens_per_s"],
                peak_bytes=served["peak_bytes"], logit_err=worst,
                fused_logit_err=worst_fused, plain_fused_logit_err=d_plain,
                fused_decode_tokens_per_s=fserved["decode_tokens_per_s"],
                dense_logit_err=worst_dense,
                dense_decode_tokens_per_s=dserved["decode_tokens_per_s"])


def _spec_serve(engine, prompts, label: str, smi: str, drafter=None,
                new_tokens: int = NEW_TOKENS):
    """The scheduler's speculative serve (``engine.spec_k`` > 0, the
    drafter given or the default n-gram one) with the launch counters
    and the telemetry registry zeroed just before: prints the verify
    steps, the drafted, accepted and emitted tokens, the verify steps'
    mean wall time and their tokens/s (emitted over the verify steps'
    wall, the token read included, drafting not), the end-to-end
    tokens/s (generated over the serve's wall) and peak memory, each
    beside the card; holds the scheduler's conservation law (every
    emitted token reached a request: emitted = generated - requests;
    accepted <= drafted)."""
    from apex_tpu_torch import observability as obs
    from apex_tpu_torch.inference import SlotScheduler
    from apex_tpu_torch.ops import _build
    reg = obs.reset_global_registry()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    sched = SlotScheduler(engine, drafter=drafter)
    uids = [sched.submit(p, max_new_tokens=new_tokens) for p in prompts]
    done = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    outs = [done[u] for u in uids]
    launches = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    tel = sched.telemetry
    steps = int(reg.declared("infer_verify_dispatch_total").total())
    drafted, accepted, emitted, generated = (
        int(c.total()) for c in (tel.spec_drafted, tel.spec_accepted,
                                 tel.spec_emitted, tel.tokens_generated))
    verify_s = tel.spec_step_seconds
    print(f"{label}: {len(prompts)} requests, prompts "
          f"{[len(p) for p in prompts]}, spec_k {engine.spec_k}, drafter "
          f"{type(sched.drafter).__name__}, {generated} tokens in "
          f"{wall:.3f} s = {generated / wall:.1f} tokens/s end to end "
          f"[{smi}]")
    print(f"  {steps} verify steps: drafted {drafted}, accepted {accepted} "
          f"(acceptance {accepted / max(drafted, 1):.3f}), emitted "
          f"{emitted} ({emitted / steps:.2f} a step); a verify step "
          f"{1e3 * verify_s / steps:.2f} ms, {emitted / verify_s:.1f} "
          f"tokens/s over the verify steps [{smi}]")
    print(f"  peak device memory {peak / 2**30:.2f} GiB [{smi}]; kernel "
          f"launches during the serve: {launches}")
    if any(len(o) != new_tokens for o in outs) or any(
            not 0 <= t < engine.cfg.vocab_size for o in outs for t in o):
        raise AssertionError(f"{label}: expected {new_tokens} in-vocab "
                             f"tokens per request")
    if steps <= 0 or emitted != generated - len(prompts) \
            or accepted > drafted:
        raise AssertionError(f"{label}: the speculation counts break the "
                             f"scheduler's conservation law")
    return dict(outs=outs, launches=launches, reg=reg, peak_bytes=peak,
                steps=steps, drafted=drafted, accepted=accepted,
                emitted=emitted, wall_s=wall, verify_s=verify_s,
                tokens_per_s=generated / wall,
                verify_tokens_per_s=emitted / verify_s)


def _hold_stream(label, engine, prompt, got, want) -> bool:
    """The speculative stream against the non-spec serve's: equal, or
    first differing at a token whose full-forward top-2 margin is at most
    2 x TOL_LOGITS (the verify step's products run at another batch
    shape and round differently, so a near tie may fall either way, and
    the streams part there).  Returns whether the streams are equal."""
    n = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
             len(want))
    if n == len(want):
        return True
    seq = torch.tensor([prompt + want[:n]], dtype=torch.int32,
                       device=engine.device)
    with torch.no_grad():
        last = _full_forward(engine, seq)[-1, 0].float()
    top2 = last.topk(2).values
    margin = float(top2[0] - top2[1])
    print(f"  {label} (prompt {len(prompt)}): streams part at token {n} "
          f"(top-2 margin {margin:.4f}, limit {2 * TOL_LOGITS})")
    if margin > 2 * TOL_LOGITS:
        raise AssertionError(f"{label}: the speculative stream differs at a "
                             f"decided token")
    return False


def _check_verify_logits(label, engine, prompt, fed):
    """Prefill ``prompt`` into slot 0, then ``SPEC_CHECK_ROUNDS`` verify
    forwards (the function the engine's verify step runs) of slabs of
    the non-spec serve's tokens ``fed``, each followed by the slot's
    advance by ``S``: the ``[rounds x S, vocab]`` verify logits against
    the full forward of the prompt and those tokens (within TOL_LOGITS;
    the argmax equal where the top-2 margin exceeds 2 x TOL_LOGITS)."""
    n_fed = SPEC_CHECK_ROUNDS * SPEC_S
    got = _verify_logits(engine, prompt, fed)
    seq = torch.tensor([prompt + list(fed[:n_fed])], dtype=torch.int32,
                       device=engine.device)
    with torch.no_grad():
        ref = _full_forward(engine, seq)[len(prompt):, 0].float()
    return _hold_rows(f"{label} (prompt {len(prompt)}): "
                      f"{SPEC_CHECK_ROUNDS} verify rounds of {SPEC_S}",
                      got, ref)


def _verify_logits(engine, prompt, fed):
    """Prefill ``prompt`` into slot 0, then ``SPEC_CHECK_ROUNDS`` verify
    forwards of slabs of ``fed`` (the engine's own, at its ``tp``), each
    followed by the slot's advance by ``S``: the ``[rounds x S, vocab]``
    fp32 verify logits."""
    from apex_tpu_torch.inference import kv_cache, models
    cache = engine.init_cache()
    pages = None
    if engine.paged:
        alloc = engine.new_allocator()
        pages = alloc.acquire(alloc.pages_needed(
            len(prompt) + SPEC_CHECK_ROUNDS * SPEC_S))
    cache, _, _ = engine.prefill(cache, prompt, 0, pages=pages)
    active = torch.zeros(engine.slots, dtype=torch.bool, device=engine.device)
    active[0] = True
    rows = []
    for r in range(SPEC_CHECK_ROUNDS):
        slab = torch.zeros((engine.slots, SPEC_S), dtype=torch.int32,
                           device=engine.device)
        slab[0] = torch.tensor(fed[r * SPEC_S:(r + 1) * SPEC_S])
        with torch.no_grad():
            logits, cache = models.verify_forward(
                engine.kind, engine.cfg, engine.params, cache, slab,
                tp=engine.tp, group=engine.group)
        rows.append(logits[0].float())
        cache, _ = kv_cache.advance_by(cache, active, SPEC_S)
    return torch.cat(rows)


def _hold_rows(label, got, ref, limit=TOL_LOGITS):
    """Logit rows against the full forward's: within ``limit``, and the
    argmax equal wherever the full forward's top-2 margin exceeds 2 x
    ``limit``.  Returns the distance."""
    if not torch.isfinite(got).all() or got.shape != ref.shape:
        raise AssertionError(f"{label}: logits not finite or misshaped")
    diff = (got - ref).abs().max().item()
    top2 = ref.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * limit
    agree = ref.argmax(-1) == got.argmax(-1)
    print(f"check {label}: max|got - full| {diff:.4f} (limit {limit}), "
          f"argmax equal at {int(agree.sum())}/{len(ref)} positions, "
          f"{int(decided.sum())} with top-2 margin > {2 * limit}")
    if diff > limit:
        raise AssertionError(f"{label}: logits off by {diff}")
    if not bool(agree[decided].all()):
        raise AssertionError(f"{label}: a token with a clear top-2 margin "
                             f"differs")
    return diff


def _spec_gates(label, engine, prompts, spec, base, kernel, layers):
    """What every speculative serve is held to: its path kernel launched
    once a layer and verify step and the other paged kernel never, the
    streams against the non-spec serve's (:func:`_hold_stream`), and the
    first and last requests' verify logits against the full forward
    (:func:`_check_verify_logits`)."""
    other = ({"paged_attention", "paged_attention_wide"} - {kernel}).pop()
    got = spec["launches"]
    print(f"  {label}: {kernel} launched {got[kernel]} times (want "
          f"{layers} x {spec['steps']} verify steps), {other} {got[other]} "
          f"(want 0)")
    if got[kernel] != layers * spec["steps"] or got[other]:
        raise AssertionError(f"{label}: the verify steps did not run one "
                             f"{kernel} launch a layer")
    equal = sum(_hold_stream(f"{label} request {i}", engine, p, g, w)
                for i, (p, g, w) in enumerate(zip(prompts, spec["outs"],
                                                  base["outs"])))
    print(f"  {label}: {equal}/{len(prompts)} streams equal the non-spec "
          f"serve's whole")
    return max(_check_verify_logits(f"{label} request {i}", engine,
                                    prompts[i], base["outs"][i])
               for i in (0, len(prompts) - 1))


def phase_spec(dev, seed: int):
    """Speculative decoding on the paged pool, ``spec_k`` = 4, through the
    scheduler's verify waves (every decode token comes from a verify
    step): Llama-3-8B at full width and depth (the serve phase's seed,
    weights and geometry) with the default n-gram drafter, with a
    ``ReplayDrafter`` scripted from the non-spec serve's own outputs and
    with one scripted from the n-gram serve's (the verify path's own
    stream: acceptance near its ceiling);
    GPT-3 1.3B in fp32 (the JAX package's default parameters; its pool
    runs #7w) with an ``EngineDrafter`` on a dense fp32 engine over the
    same weight tensors (a self-draft).  Each beside a non-spec serve of
    the same prompts on the same weights, held by :func:`_spec_gates`;
    returns the launches of the speculative serves."""
    from apex_tpu_torch.inference import (EngineDrafter, InferenceEngine,
                                          ReplayDrafter)
    from apex_tpu_torch.transformer.testing import GPTConfig, LlamaConfig
    from apex_tpu_torch.utils import tree_leaves_with_path
    smi = _smi()
    total: dict = {}

    def add(launches):
        for k_, n in launches.items():
            total[k_] = total.get(k_, 0) + n

    cfg = LlamaConfig(**FULL_CFG)
    params = _random_llama(cfg, dev, seed)
    geometry = dict(slots=8, max_seq=4096, page_size=64, num_pages=512,
                    device=dev)
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).tolist()
               for n in PROMPT_LENS]
    base = _serve(InferenceEngine("llama", cfg, params, **geometry), prompts,
                  "spec base (Llama-3-8B, no speculation)")
    print(f"  spec base: decode {base['decode_tokens_per_s']:.1f} tokens/s, "
          f"{sum(map(len, base['outs'])) / base['wall_s']:.1f} tokens/s end "
          f"to end [{smi}]")
    engine = InferenceEngine("llama", cfg, params, spec_k=SPEC_K, **geometry)
    runs = {}
    # the replayed scripts: the non-spec serve's streams, then the n-gram
    # spec serve's own (random bf16 streams part at near ties, where the
    # verify step's products at another batch shape round differently)
    for label in ("spec llama ngram", "spec llama replay",
                  "spec llama replay own"):
        script = {"spec llama replay": base["outs"],
                  "spec llama replay own": runs.get(
                      "spec llama ngram", {}).get("outs")}.get(label)
        drafter = None if script is None else ReplayDrafter(
            dict(zip(map(tuple, prompts), script)))
        spec = _spec_serve(engine, prompts, label, smi, drafter)
        if int(spec["reg"].declared("infer_decode_dispatch_total").total()):
            raise AssertionError(f"{label}: a decode step ran")
        spec["logit_err"] = _spec_gates(label, engine, prompts, spec, base,
                                        "paged_attention", cfg.num_layers)
        add(spec["launches"])
        runs[label] = spec
    if runs["spec llama replay"]["accepted"] <= 0:
        raise AssertionError("the replayed script was never accepted")
    same = sum(a == b for a, b in zip(runs["spec llama replay own"]["outs"],
                                      runs["spec llama ngram"]["outs"]))
    print(f"  spec llama replay own: {same}/{len(prompts)} streams equal the "
          f"n-gram spec serve's, whose streams it replayed")
    del engine, params, base
    torch.cuda.empty_cache()

    gcfg = GPTConfig(**GPT_CFG)
    gparams = _random_gpt(gcfg, dev, seed + 10, dtype=torch.float32)
    rng = np.random.RandomState(seed + 10)
    gprompts = [rng.randint(0, gcfg.vocab_size, size=n).tolist()
                for n in GPT_PROMPT_LENS]
    ggeo = dict(slots=8, max_seq=gcfg.max_seq_length,
                cache_dtype=torch.float32, device=dev)
    gbase = _serve(InferenceEngine("gpt", gcfg, gparams, page_size=64,
                                   **ggeo), gprompts,
                   "spec base (GPT-3 1.3B fp32, no speculation)")
    print(f"  spec base: decode {gbase['decode_tokens_per_s']:.1f} "
          f"tokens/s, {sum(map(len, gbase['outs'])) / gbase['wall_s']:.1f} "
          f"tokens/s end to end [{smi}]")
    target = InferenceEngine("gpt", gcfg, gparams, page_size=64,
                             spec_k=SPEC_K, **ggeo)
    draft = InferenceEngine("gpt", gcfg, gparams, **ggeo)
    shared = all(a.data_ptr() == b.data_ptr() for (_, a), (_, b) in zip(
        tree_leaves_with_path(draft.params),
        tree_leaves_with_path(target.params)))
    weights = sum(t.numel() * t.element_size()
                  for _, t in tree_leaves_with_path(gparams))
    print(f"spec gpt: the draft engine shares the target's weight tensors: "
          f"{shared} ({weights / 2**30:.2f} GiB once); target pool "
          f"{target.cache_hbm_bytes() / 2**30:.2f} GiB, draft cache "
          f"{draft.cache_hbm_bytes() / 2**30:.2f} GiB")
    if not shared:
        raise AssertionError("the draft engine copied the weights")
    spec = _spec_serve(target, gprompts, "spec gpt self-draft", smi,
                       EngineDrafter(draft))
    want_peak = weights + target.cache_hbm_bytes() + draft.cache_hbm_bytes()
    print(f"  spec gpt self-draft: peak {spec['peak_bytes'] / 2**30:.2f} GiB "
          f"against weights + pool + draft cache "
          f"{want_peak / 2**30:.2f} GiB [{smi}]")
    spec["logit_err"] = _spec_gates("spec gpt self-draft", target, gprompts,
                                    spec, gbase, "paged_attention_wide",
                                    gcfg.num_layers)
    rate = spec["accepted"] / spec["drafted"]
    if rate < SPEC_SELF_ACCEPT:
        raise AssertionError(f"the self-draft's acceptance {rate:.3f} is "
                             f"under {SPEC_SELF_ACCEPT}")
    add(spec["launches"])
    runs["spec gpt self-draft"] = spec
    del target, draft, gparams, gbase
    torch.cuda.empty_cache()
    return dict(launches=total, runs=runs)


#: the three GPT serves: the paged pool unfused, the paged pool with
#: fused-block decode, the dense slot cache; per decode step each must
#: launch 24 (layers) of its path's kernel and none of the others'
GPT_SERVES = (("gpt paged", dict(page_size=64), "paged_attention"),
              ("gpt fused", dict(page_size=64, decode_fusion="1"),
               "fused_block_decode_gpt"),
              ("gpt dense", {}, None))
GPT_DECODE_KERNELS = ("paged_attention", "fused_block_decode_gpt",
                      "fused_block_decode", "flash_attention_masked")


def phase_gpt(dev, seed: int):
    """GPT-3 1.3B at full width and depth (random bf16 weights) served
    three ways by ``InferenceEngine("gpt", ...)`` (:data:`GPT_SERVES`),
    8 slots, max_seq 2048, page 64, 8 prompts of 128..1536 tokens, 32
    greedy tokens each: TTFT, decode tokens/s, peak memory and the
    kernels launched a decode step; then two requests' decode logits
    against ``GPTModel``'s full forward (the later engines fed the first
    one's tokens, so their logits also compare with each other)."""
    from apex_tpu_torch.inference import InferenceEngine
    from apex_tpu_torch.transformer.testing import GPTConfig
    cfg = GPTConfig(**GPT_CFG)
    t0 = time.perf_counter()
    params = _random_gpt(cfg, dev, seed + 10)
    torch.cuda.synchronize()
    from apex_tpu_torch.utils import tree_leaves_with_path
    n_params = sum(t.numel() for _, t in tree_leaves_with_path(params))
    print(f"gpt: GPT-3 1.3B ({n_params / 1e9:.3f}e9 parameters) random bf16 "
          f"weights in {time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(seed + 10)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).tolist()
               for n in GPT_PROMPT_LENS]
    out, fed, first = {}, {}, {}
    for label, kw, path_kernel in GPT_SERVES:
        engine = InferenceEngine("gpt", cfg, params, slots=8,
                                 max_seq=cfg.max_seq_length, device=dev,
                                 **kw)
        served = _serve(engine, prompts, label)
        launches = served["launches"]
        steps = int(served["reg"].declared("infer_decode_dispatch_total")
                    .total())
        want = {k: (cfg.num_layers * steps if k == path_kernel else 0)
                for k in GPT_DECODE_KERNELS}
        got = {k: launches[k] for k in GPT_DECODE_KERNELS}
        print(f"  {label}: {steps} decode steps, launches {got} (want "
              f"{want}); layer_norm {launches['layer_norm']}, "
              f"flash_attention {launches['flash_attention']}")
        if steps <= 0 or got != want or not launches["layer_norm"] \
                or not launches["flash_attention"]:
            raise AssertionError(f"{label}: launches off: {launches}")
        for idx in (0, len(prompts) - 1):
            logits, d_, fed_i = _check_logits(
                f"{label} request {idx}", engine, prompts[idx],
                served["outs"][idx], TOL_LOGITS, forced=fed.get(idx))
            if idx in first:
                print(f"  {label} request {idx}: max|decode logits - "
                      f"{GPT_SERVES[0][0]}'s| "
                      f"{(logits - first[idx]).abs().max().item():.4f} "
                      f"(same tokens fed)")
            else:
                first[idx], fed[idx] = logits, fed_i
            served[f"logit_err_{idx}"] = d_
        out[label] = {k: served[k] for k in (
            "launches", "ttft_mean_s", "decode_tokens_per_s", "peak_bytes",
            "logit_err_0", f"logit_err_{len(prompts) - 1}")}
        del engine, served
        torch.cuda.empty_cache()
    del params, first
    torch.cuda.empty_cache()
    return dict(runs=out, launches={
        "fused_block_decode_gpt":
            out["gpt fused"]["launches"]["fused_block_decode_gpt"]})


#: tensor-parallel serving (the tp phase): two ranks on the one card,
#: each serving the first four prompts, 16 greedy tokens a request
TP = 2
TP_PROMPTS = 4
#: 16 until the moe_train phase came: a tp decode step is 0.1-0.7 s of
#: gloo.  The spec serve's check re-feeds SPEC_CHECK_ROUNDS slabs of
#: SPEC_S stream tokens and holds them to the single card's logits one
#: row later, so one token more than those slabs keeps every gate (the
#: streams, the logits along them, the launches a step)
TP_NEW_TOKENS = SPEC_CHECK_ROUNDS * SPEC_S + 1
#: Llama-3-8B and GPT-3 1.3B at the serve and gpt phases' geometry
TP_LLAMA_GEO = dict(slots=8, max_seq=4096, page_size=64, num_pages=512)
TP_GPT_GEO = dict(slots=8, max_seq=2048, page_size=64)
#: the tp serves: (label, model, engine kwargs, the kernel each decode or
#: verify step launches once a layer, the kernels it must not launch)
TP_SERVES = (
    ("tp llama", "llama", {}, "paged_attention",
     ("fused_block_decode", "fused_block_decode_partial")),
    ("tp llama fused", "llama", dict(decode_fusion="1"),
     "fused_block_decode_partial", ("fused_block_decode", "paged_attention")),
    ("tp gpt fused", "gpt", dict(decode_fusion="1"),
     "fused_block_decode_gpt_partial",
     ("fused_block_decode_gpt", "paged_attention")),
    ("tp gpt spec", "gpt", dict(spec_k=SPEC_K), "paged_attention",
     ("fused_block_decode_gpt_partial", "paged_attention_wide")))
#: the gloo all_reduce timed in the ranks: a decode step's [8, 4096] and
#: a 2048-token prefill's [2048, 4096] bf16
TP_ALLREDUCE = ((8, 4096), (2048, 4096))


def _tp_model(kind, dev, seed):
    """The tp phase's weights and config: Llama-3-8B (the serve phase's
    seed) or GPT-3 1.3B (the gpt phase's), random bf16 on the card."""
    from apex_tpu_torch.transformer.testing import GPTConfig, LlamaConfig
    if kind == "llama":
        cfg = LlamaConfig(**FULL_CFG)
        return cfg, _random_llama(cfg, dev, seed), TP_LLAMA_GEO
    cfg = GPTConfig(**GPT_CFG)
    return cfg, _random_gpt(cfg, dev, seed + 10), TP_GPT_GEO


def _tp_prompts(kind, cfg, seed):
    """The serve (Llama) or gpt phase's prompts, the first four."""
    rng = np.random.RandomState(seed if kind == "llama" else seed + 10)
    lens = PROMPT_LENS if kind == "llama" else GPT_PROMPT_LENS
    return [rng.randint(0, cfg.vocab_size, size=n).tolist()
            for n in lens][:TP_PROMPTS]


def _tp_reference(kind, dev, seed):
    """The single-card serve the ranks are held to: its streams, decode
    tokens/s, step time and peak memory, and for every request the
    full forward's logits along its stream (``[TP_NEW_TOKENS, vocab]``:
    row j after the prompt and the stream's first j tokens) as top-2
    margins, whole for the first and last request.  The engine and weights are freed
    before it returns."""
    from apex_tpu_torch.inference import InferenceEngine
    cfg, params, geo = _tp_model(kind, dev, seed)
    engine = InferenceEngine(kind, cfg, params, device=dev, **geo)
    prompts = _tp_prompts(kind, cfg, seed)
    served = _serve(engine, prompts, f"tp reference ({kind}, one rank)",
                    TP_NEW_TOKENS)
    margins, rows = [], {}
    for i, (p, o) in enumerate(zip(prompts, served["outs"])):
        seq = torch.tensor([p + o[:-1]], dtype=torch.int32, device=dev)
        with torch.no_grad():
            full = _full_forward(engine, seq)[len(p) - 1:, 0].float()
        top2 = full.topk(2, dim=-1).values
        margins.append((top2[:, 0] - top2[:, 1]).cpu().tolist())
        if i in (0, TP_PROMPTS - 1):
            rows[i] = full.cpu()
        del full
    ref = dict(outs=served["outs"], margins=margins, rows=rows,
               peak_bytes=served["peak_bytes"],
               decode_tokens_per_s=served["decode_tokens_per_s"],
               decode_step_s=served["decode_step_s"])
    del engine, params, served
    torch.cuda.empty_cache()
    return ref


def _nccl_probe_rank(rank, store, queue):
    """One of two NCCL ranks on cuda:0, one all_reduce; reports what NCCL
    said (the tp phase's note on its backend)."""
    import datetime
    import torch.distributed as dist
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", store=dist.FileStore(store, 2),
                                rank=rank, world_size=2,
                                timeout=datetime.timedelta(seconds=40))
        t = torch.ones(4, device="cuda")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        dist.destroy_process_group()
        queue.put((rank, "took them", t.tolist()))
    except Exception as e:      # the probe reports NCCL's refusal
        queue.put((rank, "refused", f"{type(e).__name__}: {str(e)[:300]}"))


#: NCCL's answer on this card, once asked (the tp and dp phases share it)
_NCCL_ANSWER: dict = {}


def _nccl_probe(tmp: Path) -> str:
    """Whether NCCL takes two ranks on the one card (it needs one card a
    rank), answered by two spawned processes within 90 s; every process
    it starts is ended before it returns.  Asked once a run: a later
    call returns the first answer."""
    if "answer" in _NCCL_ANSWER:
        return _NCCL_ANSWER["answer"] + " (asked earlier in this run)"
    import queue as queue_mod
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_nccl_probe_rank,
                         args=(r, str(tmp / "nccl_store"), q))
             for r in range(2)]
    for proc in procs:
        proc.start()
    got, t0 = [], time.perf_counter()
    while len(got) < 2 and time.perf_counter() - t0 < 90:
        try:
            got.append(q.get(timeout=5))
        except queue_mod.Empty:
            pass
    for proc in procs:
        proc.join(timeout=10)
        if proc.is_alive():
            proc.kill()
            proc.join()
    _NCCL_ANSWER["answer"] = repr(sorted(got)) if got else \
        "no answer in 90 s"
    return _NCCL_ANSWER["answer"]


def _tp_rank(rank, tmp, seed, refs):
    """One rank of the tp phase, on cuda:0 over gloo: builds its engines
    one rank after the other (a barrier between, so two whole Llama-3-8B
    trees are never alive at once), times the gloo all_reduce, serves
    each of :data:`TP_SERVES` and the checked requests' decode (spec:
    verify) logits fed the single-card streams, and writes what it saw
    to ``tmp/rank<rank>.pt`` for the parent to hold."""
    import datetime
    import torch.distributed as dist
    from apex_tpu_torch.inference import InferenceEngine
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(Path(tmp) / "store"), TP), rank=rank, world_size=TP,
        timeout=datetime.timedelta(seconds=600))
    smi = _smi()
    out = {"serves": {}, "allreduce_ms": {}}
    try:
        for kind in ("llama", "gpt"):
            engines = {}
            for r in range(TP):
                if r == rank:
                    cfg, params, geo = _tp_model(kind, dev, seed)
                    torch.cuda.reset_peak_memory_stats()
                    for label, k_, kw, _, _ in TP_SERVES:
                        if k_ == kind:
                            engines[label] = InferenceEngine(
                                kind, cfg, params, device=dev, tp=TP, **geo,
                                **kw)
                    out[f"{kind} build peak"] = \
                        torch.cuda.max_memory_allocated()
                    del params
                    torch.cuda.empty_cache()
                dist.barrier()
            if kind == "llama":
                # on the card, and the same gloo call on a host tensor
                # (what the card's staging adds)
                for shape, where in itertools.product(TP_ALLREDUCE,
                                                      (dev, "cpu")):
                    t = torch.ones(shape, dtype=torch.bfloat16, device=where)
                    n = 20 if shape[0] < 64 else 5
                    dist.all_reduce(t)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(n):
                        dist.all_reduce(t)
                    torch.cuda.synchronize()
                    out["allreduce_ms"][shape, t.device.type] = \
                        1e3 * (time.perf_counter() - t0) / n
            prompts = _tp_prompts(kind, cfg, seed)
            for label, engine in engines.items():
                tag = f"{label} (rank {rank}) [{smi}]"
                if engine.spec_k:
                    served = _spec_serve(engine, prompts, tag, smi,
                                         new_tokens=TP_NEW_TOKENS)
                else:
                    served = _serve(engine, prompts, tag, TP_NEW_TOKENS)
                reg = served["reg"]
                res = {k: served[k] for k in served if k != "reg"}
                res.update(
                    decode_steps=int(reg.declared(
                        "infer_decode_dispatch_total").total()),
                    verify_steps=int(reg.declared(
                        "infer_verify_dispatch_total").total()),
                    prefills=int(reg.declared(
                        "infer_prefill_dispatch_total").total()),
                    pool_bytes=engine.cache_hbm_bytes(), logits={})
                stream = refs[kind]["outs"]
                for i in (0, TP_PROMPTS - 1):
                    if engine.spec_k:
                        got = _verify_logits(engine, prompts[i], stream[i])
                    else:
                        got = _decode_logits(engine, prompts[i],
                                             forced=stream[i][:N_CHECK])[0]
                    res["logits"][i] = got.float().cpu()
                out["serves"][label] = res
            del engines
            torch.cuda.empty_cache()
            dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(out, Path(tmp) / f"rank{rank}.pt")


def _tp_gates(label, ranks, ref, layers, kernel, never):
    """What the parent holds each tp serve to: every rank's streams equal
    bit for bit, and equal to the single card's up to a first difference
    at a token of top-2 margin at most 2 x TOL_LOGITS; the checked
    requests' logits within TOL_LOGITS of the single card's full forward;
    each rank's kernel once a layer a decode (spec: verify) step and #3
    once a layer a prefill, the other paths' kernels never.  Returns the
    worst logit distance."""
    first = ranks[0]["serves"][label]
    for r in ranks[1:]:
        if r["serves"][label]["outs"] != first["outs"]:
            raise AssertionError(f"{label}: the ranks' streams differ")
    equal = 0
    for i, (got, want) in enumerate(zip(first["outs"], ref["outs"])):
        n = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
                 len(want))
        if n == len(want):
            equal += 1
            continue
        margin = ref["margins"][i][n]
        print(f"  {label} request {i}: streams part at token {n} (top-2 "
              f"margin {margin:.4f}, limit {2 * TOL_LOGITS})")
        if margin > 2 * TOL_LOGITS:
            raise AssertionError(f"{label}: the tp stream differs from the "
                                 f"single card's at a decided token")
    print(f"  {label}: {equal}/{len(ref['outs'])} streams equal the single "
          f"card's whole; the {TP} ranks' streams equal bit for bit")
    worst = 0.0
    spec = "spec" in label
    for i, got in first["logits"].items():
        # decode row j follows the prompt and j stream tokens; verify
        # row j follows j + 1 (the slab starts with the first token)
        want = ref["rows"][i][int(spec):int(spec) + len(got)]
        worst = max(worst, _hold_rows(
            f"{label} request {i}, {'verify' if spec else 'decode'} logits "
            f"against the single card's full forward", got, want))
    for rank, r in enumerate(ranks):
        res = r["serves"][label]
        steps = res["verify_steps"] if spec else res["decode_steps"]
        launches = res["launches"]
        print(f"  {label} rank {rank}: {kernel} {launches[kernel]} (want "
              f"{layers} x {steps} steps), flash_attention "
              f"{launches['flash_attention']} (want {layers} x "
              f"{res['prefills']} prefills), "
              + ", ".join(f"{k} {launches[k]}" for k in never) + " (want 0)")
        if steps <= 0 or launches[kernel] != layers * steps \
                or launches["flash_attention"] != layers * res["prefills"] \
                or any(launches[k] for k in never):
            raise AssertionError(f"{label} rank {rank}: launches off: "
                                 f"{launches}")
        if spec and res["decode_steps"]:
            raise AssertionError(f"{label} rank {rank}: a decode step ran")
    return worst


def phase_tp(dev, seed: int):
    """Tensor-parallel serving, tp = 2, on the one card: both ranks on
    cuda:0 over gloo (NCCL takes one card a rank; the phase asks it and
    prints its answer).  The parent first serves the first four prompts
    on one rank (Llama-3-8B, GPT-3 1.3B) for the streams, the full
    forward's logits along them and the single card's tokens/s and peak
    memory, frees everything, then spawns the two ranks
    (:func:`_tp_rank`) and holds what they report (:func:`_tp_gates`).
    Returns the ranks' launches of the serves, summed."""
    import tempfile
    import torch.multiprocessing as mp
    smi = _smi()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as tmp_dir:
        tmp = Path(tmp_dir)
        nccl = _nccl_probe(tmp)
        print(f"tp: {TP} ranks on cuda:0 over gloo (one card: NCCL needs one "
              f"card a rank; NCCL asked for two ranks on this card: {nccl}); "
              f"gloo stages every collective through the host [{smi}]")
        refs = {kind: _tp_reference(kind, dev, seed)
                for kind in ("llama", "gpt")}
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        mp.start_processes(
            _tp_rank, nprocs=TP, start_method="spawn",
            args=(str(tmp), seed,
                  {k: {"outs": v["outs"]} for k, v in refs.items()}))
        print(f"tp: the ranks ran in {time.perf_counter() - t0:.1f} s, the "
              f"phase {time.perf_counter() - t_phase:.1f} s")
        ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                 for r in range(TP)]
    layers = {"llama": FULL_CFG["num_layers"], "gpt": GPT_CFG["num_layers"]}
    total: dict = {}
    for (shape, where), ms in ranks[0]["allreduce_ms"].items():
        print(f"tp: one gloo all_reduce of {list(shape)} bf16 "
              + ("on the card (staged through the host; not an NCCL figure)"
                 if where == "cuda" else "on a host tensor") + ": "
              + ", ".join(f"rank {i} {r['allreduce_ms'][shape, where]:.3f} "
                          f"ms" for i, r in enumerate(ranks)) + f" [{smi}]")
    for label, kind, _, kernel, never in TP_SERVES:
        ref = refs[kind]
        worst = _tp_gates(label, ranks, ref, layers[kind], kernel, never)
        for rank, r in enumerate(ranks):
            res = r["serves"][label]
            rate = res.get("tokens_per_s") if "spec" in label \
                else res["decode_tokens_per_s"]
            print(f"  {label} rank {rank}: "
                  + (f"{rate:.1f} tokens/s end to end, verify steps "
                     f"{res['steps']}, acceptance "
                     f"{res['accepted'] / max(res['drafted'], 1):.3f}"
                     if "spec" in label else
                     f"decode {rate:.1f} tokens/s, a decode step "
                     f"{1e3 * res['decode_step_s']:.2f} ms")
                  + f" (one card: decode {ref['decode_tokens_per_s']:.1f} "
                  f"tokens/s, a step {1e3 * ref['decode_step_s']:.2f} ms); "
                  f"peak {res['peak_bytes'] / 2**30:.2f} GiB, pool "
                  f"{res['pool_bytes'] / 2**30:.2f} GiB, built at "
                  f"{r[f'{kind} build peak'] / 2**30:.2f} GiB (one card's "
                  f"serve: peak {ref['peak_bytes'] / 2**30:.2f} GiB); logits "
                  f"within {worst:.4f} [{smi}]")
            for k, n in res["launches"].items():
                total[k] = total.get(k, 0) + n
    return dict(launches=total)


def phase_bert(dev, seed: int):
    """BERT-large (the ``BertConfig`` default, random bf16 weights):
    ``InferenceEngine("bert", ...).encode`` on ``[8, 512]`` tokens, its
    time and launches (one flash forward and LayerNorms a layer), its
    logits against the same forward with every kernel swapped for its
    plain version; then ``BertModel`` with a padding mask over the
    engine's weights (one masked flash forward a layer), held the same
    way."""
    from apex_tpu_torch.inference import InferenceEngine
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.transformer.testing import BertConfig
    cfg = BertConfig()
    params = _random_bert(cfg, dev, seed + 20)
    engine = InferenceEngine("bert", cfg, params, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 20)
    tokens = torch.randint(0, cfg.vocab_size, (BERT_BATCH, BERT_SEQ),
                           generator=gen, device=dev, dtype=torch.int32)
    types = torch.randint(0, 2, tokens.shape, generator=gen, device=dev,
                          dtype=torch.int32)
    engine.encode(tokens, types)                        # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    logits, nsp = engine.encode(tokens, types)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"bert: BERT-large encode [{BERT_BATCH}, {BERT_SEQ}] in "
          f"{wall * 1e3:.2f} ms ({BERT_BATCH * BERT_SEQ / wall:.0f} tokens/s), "
          f"peak device memory {peak / 2**30:.2f} GiB; launches {launches}")
    if nsp is not None or tuple(logits.shape) != (BERT_SEQ, BERT_BATCH,
                                                  cfg.vocab_size) \
            or not torch.isfinite(logits).all():
        raise AssertionError("bert: encode's output is misshaped or not "
                             "finite")
    if launches["flash_attention"] != cfg.num_layers \
            or launches["layer_norm"] <= 0 \
            or launches["flash_attention_masked"]:
        raise AssertionError(f"bert: encode's launches are off: {launches}")
    # live lengths 512, 448, ..., 64 and, last, a single token
    keep = torch.tensor([BERT_SEQ - i * BERT_SEQ // BERT_BATCH
                         for i in range(BERT_BATCH - 1)] + [1], device=dev)
    pad = (torch.arange(BERT_SEQ, device=dev)[None, :]
           < keep[:, None]).to(torch.int32)

    def padded():
        return torch.func.functional_call(
            engine._bert, engine._bert_state, (tokens, types, pad))[0]

    def forwards(route, state=None):
        """Both forwards (``encode``'s and the padded one), each inside a
        context ``route()``: their logits as ``[b, s, vocab]``."""
        state = engine._bert_state if state is None else state
        outs = []
        for args in ((tokens, types), (tokens, types, pad)):
            with route(), torch.no_grad():
                outs.append(torch.func.functional_call(
                    engine._bert, state, args)[0].transpose(0, 1))
        return outs

    _build.reset_launch_counts()
    with torch.no_grad():
        masked = padded()
    plaunch = _build.launch_counts()
    if plaunch["flash_attention_masked"] != cfg.num_layers \
            or plaunch["flash_attention"]:
        raise AssertionError(f"bert: the padded forward's launches are "
                             f"off: {plaunch}")
    _build.reset_launch_counts()
    plain = forwards(_plain_kernels)
    if any(_build.launch_counts().values()):
        raise AssertionError("bert: the plain route launched a kernel")
    kern = forwards(contextlib.nullcontext)
    # the control: the plain route on the same weights in fp32
    fp32 = forwards(_plain_kernels, {
        n: t.float() for n, t in engine._bert_state.items()})
    # one wrong layer on the kernels' route, the first or the 13th: its
    # attention causal (encode), or without its padding mask (padded)
    wrong = {n: [forwards(lambda: _wrong_attention(n, causal=True))[0],
                 forwards(lambda: _wrong_attention(n, mask3=None))[1]]
             for n in (0, 12)}
    errs = []
    for i, label in enumerate(("encode", "padded")):
        g_, r_ = kern[i], plain[i]
        e = (g_.float() - r_.float()).abs().max().item()
        rel = _seq_rel_l2(g_, r_, BERT_BATCH)
        off = {n: _seq_rel_l2(w[i], r_, BERT_BATCH) for n, w in wrong.items()}
        print(f"  bert {label}: max|kernels - plain| {e:.4f} (limit "
              f"{TOL_LOGITS}), relative L2 {rel:.4e} (the worst sequence; "
              f"limit {TOL_BERT_REL_L2}); plain bf16 against plain fp32 "
              f"{_seq_rel_l2(fp32[i], r_, BERT_BATCH):.4e}; a wrong layer 0 "
              f"{off[0]:.4e}, a wrong layer 12 {off[12]:.4e}")
        _check(f"bert {label} logits", e, TOL_LOGITS)
        _check(f"bert {label} logits (relative L2)", rel, TOL_BERT_REL_L2)
        if off[0] <= TOL_BERT_REL_L2:
            raise AssertionError(f"bert {label}: the relative L2 limit does "
                                 f"not see a wrong first layer")
        errs.append(e)
    del engine, params, logits, masked, plain, kern, fp32, wrong
    torch.cuda.empty_cache()
    return dict(wall_s=wall, peak_bytes=peak, logit_err=max(errs),
                launches=launches)


def _lm_model(kind: str, dev, seed: int, layers=None, cfg_kw=None):
    """BERT-large (``BertConfig()``, no NSP head, as
    ``examples/bert/pretrain_bert.py`` builds it) or GPT-3 1.3B
    (``GPT_CFG``; ``"gpt8k"``: its context raised to 8192), bf16
    parameters drawn by the modules' own initializers from ``seed``,
    dropout ``LM_DROPOUT`` on hidden activations and on attention
    probabilities; ``layers`` cuts the depth, ``cfg_kw`` sets options
    that draw no parameter (``remat``, the fused head, half residuals)."""
    from apex_tpu_torch.models import (BertConfig, GPTConfig,
                                       bert_model_provider,
                                       gpt_model_provider)
    torch.manual_seed(seed)
    kw = dict(hidden_dropout=LM_DROPOUT, attention_dropout=LM_DROPOUT,
              params_dtype=torch.bfloat16)
    kw.update(WIDTH_MODEL.get(kind, {}))
    if layers is not None:
        kw["num_layers"] = layers
    kw.update(cfg_kw or {})
    if kind.startswith("bert"):
        cfg = BertConfig(**kw)
        return cfg, bert_model_provider(cfg, add_binary_head=False,
                                        device=dev)
    if kind == "gpt8k":
        kw["max_seq_length"] = GPT8K_TRAIN_SEQ
    cfg = GPTConfig(**dict(GPT_CFG, **kw))
    return cfg, gpt_model_provider(cfg, device=dev)


def _lm_batch(kind: str, cfg, dev, seed: int) -> dict:
    """One fixed batch from ``seed``.  BERT: ``BERT_TRAIN_BATCH`` x
    ``BERT_TRAIN_SEQ`` tokens shaped as ``examples/bert/pretrain_bert.py::
    synthetic_mlm_batch`` makes them (15% of each sequence's positions
    past the first replaced by the [MASK] id 3, their labels ``(7 p +
    13) % vocab``, weighted by ``loss_mask``), with per-sequence lengths
    ``BERT_MIN_LEN``..``BERT_TRAIN_SEQ`` (the rest padding, id 0, out of
    the padding ``attention_mask``) and token types 0 then 1 from each
    sequence's middle.  GPT: ``LM_RUNS[kind]``'s batch of sequences and
    their successors (4 x 2048 tokens; ``"gpt8k"`` 1 x 8192)."""
    rng = np.random.RandomState(seed)
    v = cfg.vocab_size
    if not kind.startswith("bert"):
        _, _, b, s = _LM_ALL[kind]
        toks = rng.randint(0, v, size=(b, s + 1))
        toks = torch.from_numpy(toks.astype(np.int64)).to(dev)
        return {"tokens": toks[:, :-1].contiguous(),
                "labels": toks[:, 1:].contiguous()}
    b, s = BERT_TRAIN_BATCH, BERT_TRAIN_SEQ
    lengths = _bert_lengths(rng, b, s)
    pos = np.arange(s)[None, :]
    pad = pos < lengths[:, None]
    toks = np.where(pad, rng.randint(4, v, size=(b, s)), 0)
    labels = np.zeros((b, s), np.int64)
    loss_mask = np.zeros((b, s), np.float32)
    for i, n in enumerate(lengths):
        at = rng.choice(np.arange(1, n), size=max(1, int(0.15 * n)),
                        replace=False)
        labels[i, at] = (7 * at + 13) % v
        toks[i, at] = 3
        loss_mask[i, at] = 1.0
    types = (pos >= lengths[:, None] // 2) & pad
    as_t = (lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(
        dev, dt))
    return {"tokens": as_t(toks, torch.int64),
            "types": as_t(types, torch.int64),
            "pad": as_t(pad, torch.int32),
            "labels": as_t(labels, torch.int64),
            "loss_mask": as_t(loss_mask, torch.float32),
            "lengths": lengths}


def _bert_loss(model, batch):
    return model(batch["tokens"], batch["types"], batch["pad"],
                 batch["labels"], deterministic=False,
                 loss_mask=batch["loss_mask"],
                 generator=batch["generator"])[0]


def _gpt_loss(model, batch):
    return model(batch["tokens"], batch["labels"], deterministic=False,
                 generator=batch["generator"])


@contextlib.contextmanager
def _plain_attention_refused():
    """Every plain version of the flash kernels (and the plain chain of
    ``use_kernel=False``) raises inside the context: a training run on
    the card must not reach one."""
    attn = importlib.import_module("apex_tpu_torch.ops.attention")
    names = ("_fwd_reference", "_bwd_reference", "_dq_reference",
             "_dkv_reference", "_recompute_p", "_xla_attention",
             "mha_reference")
    saved = [(n, getattr(attn, n)) for n in names]

    def refuse(name):
        def f(*a, **k):
            raise AssertionError(f"a plain attention version ran: {name}")
        return f

    for n in names:
        setattr(attn, n, refuse(n))
    try:
        yield
    finally:
        for n, f in saved:
            setattr(attn, n, f)


def phase_lm_train(dev, seed: int, kind: str, cfg_kw=None,
                   steps: int = LM_TRAIN_STEPS, keep=None, tag=None,
                   profile: bool = False, plain: bool = False):
    """BERT-large pretraining (``kind="bert"``: LAMB, ``LAMB_KW``) or
    GPT-3 1.3B training (``"gpt"``: Adam, ``TRAIN_LR``; ``"gpt8k"``: the
    same at 1 x 8192 tokens, ``gpt_train_8k``) at full width and depth
    through ``make_train_step`` with dynamic loss scaling and dropout 0.1,
    ``LM_TRAIN_STEPS`` steps on one fixed batch (:func:`_lm_batch`), each
    step with a generator of its own seed in the batch.  Each step must
    launch the forward's dropout instance and the backward's mask or
    dropout instance (at 8192 tokens the split pair's two) once a layer
    and no other flash kernel, no plain attention version may run, and
    the segment from the backward's flat grads to the new state runs
    under ``set_sync_debug_mode("error")``.  The loss must fall and stay
    finite.  Prints step time (median of steps 2 on), tokens/s (BERT:
    sequences/s too), the model-flops share and peak memory.

    ``cfg_kw`` sets model options (the ``lean_train`` runs: ``remat``,
    under which the forward's instance launches twice a layer, and the
    fused head), ``steps`` the step count, ``keep``, a list, gets a host
    copy of the first step's flat grads, ``tag`` names the run, and
    ``profile`` breaks two more steps down by kernel.  The width phase's
    kinds (:data:`WIDTH_RUNS`): ``"gpt_fp32"`` and ``"bert_fp32"`` at
    fp32 parameters, ``"gpt27"``; ``plain`` runs the steps through the
    plain versions (:func:`_plain_kernels`) and holds no launch."""
    from apex_tpu_torch import train_step
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.optimizers import functional
    from apex_tpu_torch.utils import tree_leaves_with_path
    t0 = time.perf_counter()
    cfg, model = _lm_model(kind, dev, seed, cfg_kw=cfg_kw)
    batch = _lm_batch(kind, cfg, dev, seed)
    bert = kind.startswith("bert")
    tx = functional.fused_lamb(**LAMB_KW) if bert \
        else functional.fused_adam(lr=TRAIN_LR)
    state = train_step.init_train_state(tx, model, loss_scale="dynamic")
    torch.cuda.synchronize()
    n = state.opt.master.numel()
    b, s = batch["tokens"].shape
    layers = cfg.num_layers
    phase, kernels, _, _ = _LM_ALL[kind]
    label = ("BERT-large pretraining" if bert
             else "GPT-3 2.7B training (d_head 80)" if kind == "gpt27"
             else "GPT-3 1.3B long-context training "
             f"(context {cfg.max_seq_length})" if kind == "gpt8k"
             else "GPT-3 1.3B training")
    pdtype = next(model.parameters()).dtype
    if tag:
        phase = f"{phase} {tag}"
    if cfg_kw:
        label += f" with {cfg_kw}"
    print(f"{phase}: {label}, {layers} layers, hidden "
          f"{cfg.hidden_size}, {cfg.num_attention_heads} heads, vocab "
          f"{cfg.vocab_size}, [{b}, {s}] tokens a step"
          + (f" (lengths {sorted(batch['lengths'].tolist())})" if bert
             else ", causal")
          + f", dropout {LM_DROPOUT}, {n} parameters "
          f"({str(pdtype).replace('torch.', '')}, fp32 master), "
          f"{type(tx).__name__.strip('_')}, dynamic loss scale; set up in "
          f"{time.perf_counter() - t0:.1f} s")

    def strict(flat_grads):
        if keep is not None and not keep:
            keep.append(flat_grads.to("cpu"))
        torch.cuda.set_sync_debug_mode("error")
        return flat_grads

    step = train_step.make_train_step(_bert_loss if bert else _gpt_loss, tx,
                                      grad_transform=strict)
    want = {} if plain else dict.fromkeys(kernels, layers)
    if cfg.remat and not plain:   # the forward again in each recompute
        want[kernels[0]] = 2 * layers
    losses, times, off = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    with _plain_kernels() if plain else _plain_attention_refused():
        for i in range(steps):
            before = _build.launch_counts()
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed * 1000 + i)
            t1 = time.perf_counter()
            try:
                state, loss = step(state, dict(batch, generator=gen))
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
            losses.append(loss.item())
            flash = {k: v - before[k]
                     for k, v in _build.launch_counts().items()
                     if k.startswith("flash_attention") and v != before[k]}
            if flash != want:
                off.append((i, flash))
    launches = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    step_s = float(np.median(times[1:] or times))
    tokens = b * s
    heads = cfg.num_attention_heads
    hd = cfg.hidden_size // heads
    matmul = sum(p.numel() for name, p in model.named_parameters()
                 if p.dim() == 2 and "position" not in name
                 and "tokentype" not in name)
    attn_flops = 4 * s * s * hd * heads * b * (1 if bert else 0.5)
    model_flops = 6 * matmul * tokens + 3 * attn_flops * layers
    # fp32 parameters run fp32 products (TF32 off): the CUDA cores' peak
    peak_rate = FP32_FLOPS_PER_S if pdtype == torch.float32 \
        else BF16_FLOPS_PER_S
    print(f"{phase} on {_smi()}: losses {[round(x, 4) for x in losses]}")
    print(f"  step times {[round(t, 4) for t in times]} s; "
          + (f"median of steps 2-{steps}" if steps > 1 else "the step")
          + f" {step_s:.4f} s = {tokens / step_s:.1f} "
          f"tokens/s" + (f", {b / step_s:.2f} sequences/s" if bert else ""))
    print(f"  model flops {model_flops / 1e12:.3f} TFLOP per step = "
          f"{100 * model_flops / step_s / peak_rate:.1f}% of "
          f"{peak_rate / 1e12:.0f} TFLOP/s; peak device memory "
          f"{peak / 2**30:.2f} GiB")
    print(f"  kernel launches per step: "
          f"{ {k: v / steps for k, v in launches.items() if v} }")
    print(f"  loss scale {state.scaler.loss_scale.item()}, count "
          f"{state.opt.count.item()}")
    if off:
        raise AssertionError(f"{phase}: the flash launches of a step "
                             f"are not {want}: {off}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{phase}: non-finite loss: {losses}")
    if steps > 1 and not losses[-1] < losses[0]:
        raise AssertionError(f"{phase}: the loss did not fall: {losses}")
    if profile:
        plain_step = train_step.make_train_step(
            _bert_loss if bert else _gpt_loss, tx)

        def one():
            nonlocal state
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed * 1000 + steps)
            state, _ = plain_step(state, dict(batch, generator=gen))
        _device_breakdown(f"{phase} step", one, 2, top=12)
    leaves = [(".".join(path), t.numel())
              for path, t in tree_leaves_with_path(model)]
    del model, state, step, batch
    torch.cuda.empty_cache()
    return dict(launches=launches, step_s=step_s, peak_bytes=peak,
                losses=losses, tokens=tokens, leaves=leaves)


def _bert_step_grads(dev, seed: int, route):
    """One LAMB step of the 1-layer BERT-large-wide model on
    :func:`_lm_batch`'s padded batch with dropout, inside the context
    ``route``, from a generator seeded alike on every call: its flat
    grads, loss, launch counts and ``(leaf name, size)`` list."""
    from apex_tpu_torch import train_step
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.optimizers import functional
    from apex_tpu_torch.utils import tree_leaves_with_path
    cfg, model = _lm_model("bert", dev, seed, layers=1)
    batch = _lm_batch("bert", cfg, dev, seed)
    tx = functional.fused_lamb(**LAMB_KW)
    state = train_step.init_train_state(tx, model, loss_scale="dynamic")
    leaves = [(".".join(path), t.numel())
              for path, t in tree_leaves_with_path(model)]
    keep = []
    step = train_step.make_train_step(
        _bert_loss, tx, grad_transform=lambda g: keep.append(
            g.clone()) or g)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 5)
    _build.reset_launch_counts()
    with route:
        _, loss = step(state, dict(batch, generator=gen))
    counts = _build.launch_counts()
    grads, loss = keep[0], loss.item()
    del model, state, step, keep
    torch.cuda.empty_cache()
    return grads, loss, counts, leaves


def phase_bert_train_check(dev, seed: int):
    """One step of the 1-layer BERT-large-wide model with the padding
    mask and dropout through the kernels against the same step through
    the plain versions, from the same seeds and generator state: the
    flat grads leaf by leaf and the loss."""
    got, loss_k, ck, leaves = _bert_step_grads(dev, seed,
                                               contextlib.nullcontext())
    ref, loss_p, counts, _ = _bert_step_grads(dev, seed, _plain_kernels())
    from apex_tpu_torch.ops import _build
    flash = [k for k in _build.KERNELS if k.startswith("flash_attention")]
    if any(counts[k] for k in flash) or counts["layer_norm"] \
            or counts["layer_norm_bwd"]:
        raise AssertionError(f"the plain BERT step launched a kernel: "
                             f"{counts}")
    if ck["flash_attention_masked_drop"] != 1 \
            or ck["flash_attention_bwd_masked"] != 1:
        raise AssertionError(f"the BERT step did not take the md "
                             f"instances: {ck}")
    print("train-check BERT (1 layer, BERT-large widths, padding mask, "
          f"dropout {LM_DROPOUT}): kernels, then plain versions")
    rels = _hold_grads("bert train-check", got, ref, leaves,
                       [loss_k, loss_p], TOL_TRAIN_GRAD_REL_L2)
    del got, ref
    torch.cuda.empty_cache()
    return dict(grad_rel_l2=rels, losses=[loss_k, loss_p])


def _train_model(dev, seed: int, layers: int, seq: int = TRAIN_SEQ,
                 cfg_kw=None):
    """The training model at Llama-3-8B widths and ``layers`` deep, bf16
    parameters drawn from a seeded generator, and one fixed batch of
    ``seq`` seeded tokens from the same generator; ``cfg_kw`` sets
    options that draw no parameter (``remat``, the fused head)."""
    from apex_tpu_torch.transformer.testing import (LlamaConfig,
                                                    llama_model_provider)
    cfg = LlamaConfig(**dict(FULL_CFG, num_layers=layers,
                             params_dtype=torch.bfloat16, **(cfg_kw or {})))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    model = llama_model_provider(cfg, device=dev)
    model.reset_parameters(generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (1, seq + 1),
                           generator=gen, device=dev)
    batch = {"tokens": tokens[:, :-1].contiguous(),
             "labels": tokens[:, 1:].contiguous()}
    return cfg, model, batch


def _train_setup(dev, seed: int, layers: int, tx=None,
                 loss_scale="dynamic", seq: int = TRAIN_SEQ, cfg_kw=None):
    """:func:`_train_model` and its train state for ``tx`` (default:
    Adam)."""
    from apex_tpu_torch import train_step
    from apex_tpu_torch.optimizers import functional
    cfg, model, batch = _train_model(dev, seed, layers, seq, cfg_kw)
    tx = functional.fused_adam(lr=TRAIN_LR) if tx is None else tx
    state = train_step.init_train_state(tx, model, loss_scale=loss_scale)
    return cfg, model, tx, state, batch, train_step


def _train_loss(model, batch):
    return model(batch["tokens"], batch["labels"])


def _train_run(dev, seed: int, label: str, tx, layers: int, steps: int,
               loss_scale, kernels, transform=None, profile: bool = False,
               seq: int = TRAIN_SEQ, cfg_kw=None):
    """``steps`` steps of the ``layers``-deep model under ``tx`` on one
    batch of ``seq`` tokens with the launch counters zeroed just before;
    the segment from the flat grads (``transform``, then the unscale,
    the update and the scale update) runs under
    ``set_sync_debug_mode("error")``.  Returns the launch counts, step
    time, peak memory, losses, the leaf count and the tokens a step."""
    from apex_tpu_torch.ops import _build
    t0 = time.perf_counter()
    cfg, model, tx, state, batch, train_step = _train_setup(
        dev, seed, layers, tx, loss_scale, seq, cfg_kw)
    torch.cuda.synchronize()
    n = state.opt.master.numel()
    leaves = len(state.opt.sizes)
    print(f"train {label}: Llama-3-8B widths, {layers} layers, {seq} "
          f"tokens a step" + (f", {cfg_kw}" if cfg_kw else "") + f", {n} "
          f"parameters in {leaves} leaves (bf16 params, fp32 master), "
          f"{type(tx).__name__.strip('_')}, loss scale {loss_scale}, set up "
          f"in {time.perf_counter() - t0:.1f} s")

    def strict(flat_grads):
        # from here (the flat grads of the backward) to the new state:
        # the transform, unscale, update and scale update must not sync
        torch.cuda.set_sync_debug_mode("error")
        return flat_grads if transform is None else transform(flat_grads)

    step = train_step.make_train_step(_train_loss, tx, grad_transform=strict)
    losses, times = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    for _ in range(steps):
        t0 = time.perf_counter()
        try:
            state, loss = step(state, batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    launches = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    step_s = float(np.median(times[1:]))
    tokens = seq
    heads = cfg.num_attention_heads
    hd = cfg.hidden_size // heads
    matmul_params = n - cfg.vocab_size * cfg.hidden_size \
        - (2 * layers + 1) * cfg.hidden_size
    # 6 N T for the weight GEMMs (the embedding table and norms do no
    # GEMM), and 3x the causal forward's two attention products
    model_flops = 6 * matmul_params * tokens + 3 * (
        4 * seq * seq * hd * heads / 2) * layers
    print(f"train {label} on {_smi()}: losses "
          f"{[round(x, 4) for x in losses]}")
    print(f"  step times {[round(t, 4) for t in times]} s; median of steps "
          f"2-{steps} {step_s:.4f} s = {tokens / step_s:.1f} tokens/s")
    print(f"  model flops {model_flops / 1e12:.3f} TFLOP per step = "
          f"{100 * model_flops / step_s / BF16_FLOPS_PER_S:.1f}% of 989 "
          f"TFLOP/s")
    print(f"  peak device memory {peak / 2**30:.2f} GiB")
    print(f"  kernel launches per step: "
          f"{ {k: v / steps for k, v in launches.items() if v} }")
    scale = "none" if state.scaler is None else state.scaler.loss_scale.item()
    print(f"  loss scale {scale}, count {state.opt.count.item()}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{label}: non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: the loss did not fall: {losses}")
    missing = [k for k in kernels if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{label}: the train steps launched no "
                             f"{missing} kernel")
    if profile:
        def one():
            nonlocal state
            state, _ = train_step.make_train_step(_train_loss, tx)(state,
                                                                   batch)
        _device_breakdown(f"train step ({label}, {layers} layers, "
                          f"{seq} tokens)", one, 2, top=16)
    del model, state, step
    torch.cuda.empty_cache()
    return dict(launches=launches, step_s=step_s, peak_bytes=peak,
                losses=losses, leaves=leaves, tokens=seq)


def phase_train(dev, seed: int, profile: bool = False):
    """The 4-layer model six steps under Adam and under LAMB, then the
    1-layer model three steps under SGD (nesterov, with the grad clipper
    as the grad transform, no loss scale) and under Adagrad; returns each
    run's record by rule."""
    from apex_tpu_torch.contrib import clip_grad_norm_
    from apex_tpu_torch.optimizers import functional
    runs = {"adam": _train_run(
        dev, seed, "adam", functional.fused_adam(lr=TRAIN_LR), TRAIN_LAYERS,
        TRAIN_STEPS, "dynamic", TRAIN_KERNELS, profile=profile)}
    # the 8192-token run: every layer's backward through the split pair
    runs["adam8k"] = _train_run(
        dev, seed, "adam 8192", functional.fused_adam(lr=TRAIN_LR),
        TRAIN_LAYERS, SPLIT_STEPS, "dynamic", SPLIT_TRAIN_KERNELS,
        profile=profile, seq=SPLIT_SEQ)
    split = runs["adam8k"]["launches"]
    want = TRAIN_LAYERS * SPLIT_STEPS
    print(f"  adam 8192: flash_attention_bwd_dq launched "
          f"{split['flash_attention_bwd_dq']} times, flash_attention_bwd_dkv "
          f"{split['flash_attention_bwd_dkv']} (want {TRAIN_LAYERS} layers x "
          f"{SPLIT_STEPS} steps = {want} each), flash_attention_bwd "
          f"{split['flash_attention_bwd']} (want 0)")
    if any(split[k] != want for k in SPLIT_KERNELS) \
            or split["flash_attention_bwd"]:
        raise AssertionError("the 8192-token steps did not run the split "
                             "backward once per layer and step")
    runs["lamb"] = _train_run(
        dev, seed, "lamb", functional.fused_lamb(**LAMB_KW), TRAIN_LAYERS,
        TRAIN_STEPS, "dynamic", RULE_KERNELS["lamb"], profile=profile)
    lamb = runs["lamb"]["launches"]
    want = (1 + 2 * runs["lamb"]["leaves"]) * TRAIN_STEPS
    print(f"  lamb: fused_l2norm launched {lamb['fused_l2norm']} times (want "
          f"(1 + 2 x {runs['lamb']['leaves']} leaves) x {TRAIN_STEPS} = "
          f"{want}), fused_lamb1 {lamb['fused_lamb1']} (want {TRAIN_STEPS})")
    if lamb["fused_l2norm"] != want or lamb["fused_lamb1"] != TRAIN_STEPS:
        raise AssertionError("the LAMB steps did not run one phase-1 and "
                             "1 + 2 per leaf norm launches per step")
    runs["sgd"] = _train_run(
        dev, seed, "sgd", functional.fused_sgd(**SGD_KW), RULE_LAYERS,
        RULE_STEPS, None, RULE_KERNELS["sgd"],
        transform=lambda g: clip_grad_norm_(g, SGD_CLIP)[0])
    runs["adagrad"] = _train_run(
        dev, seed, "adagrad", functional.fused_adagrad(**ADAGRAD_KW),
        RULE_LAYERS, RULE_STEPS, "dynamic", RULE_KERNELS["adagrad"])
    for label, r in runs.items():
        if label != "adam8k" and (any(r["launches"][k] for k in SPLIT_KERNELS)
                                  or not r["launches"]["flash_attention_bwd"]):
            raise AssertionError(f"{label}: a {TRAIN_SEQ}-token run must take "
                                 f"the one-pass backward: {r['launches']}")
    print("train summary (step time, tokens/s, peak device memory):")
    for label, r in runs.items():
        print(f"  {label}: {r['step_s']:.4f} s, "
              f"{r['tokens'] / r['step_s']:.1f} tokens/s, "
              f"{r['peak_bytes'] / 2**30:.2f} GiB")
    return runs


def _head_row(label, fn, h, w, labels, iters: int, ref=None):
    """One version of the LM head and its loss, forward and backward
    (``fn(h, w, labels).sum()``): its peak device memory rise over what
    is allocated before (the first call, the grads included), then its
    time (CUDA events, median of ``iters`` calls).  Returns the row and
    ``(loss, dh, dW)`` of the first call; held against ``ref``'s."""
    def once():
        hh = h.detach().requires_grad_()
        ww = w.detach().requires_grad_()
        loss = fn(hh, ww, labels).sum()
        loss.backward()
        return loss.detach(), hh.grad, ww.grad

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = once()
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        once()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    row = dict(label=label, ms=float(np.median(times)), rise_bytes=rise,
               loss=out[0].item())
    line = (f"  head {label}: {row['ms']:.4f} ms forward + backward, peak "
            f"rise {rise / 1e9:.3f} GB, loss {row['loss']:.6f}")
    if ref is not None:
        row["loss_rel"] = abs(row["loss"] - ref[0].item()) / abs(
            ref[0].item())
        for name, got, want in (("dh", out[1], ref[1]), ("dW", out[2],
                                                          ref[2])):
            row[name] = ((got.float() - want.float()).abs().max()
                         / want.float().abs().max()).item()
        line += (f"; against unfused: loss {row['loss_rel']:.3e} relative, "
                 f"dh {row['dh']:.3e}, dW {row['dW']:.3e} of max|ref|")
    print(line)
    return row, out


def _lean_head(dev, seed: int):
    """The LM head alone at Llama-3-8B's shape: hidden ``[8192, 4096]``
    and ``lm_head`` ``[128256, 4096]`` bf16, seeded labels; unfused
    (``lm_head_xentropy_reference`` + autograd), fused at token chunk
    1024, fused with the vocab in 8 slices, and one PyTorch call chain
    (``F.linear`` + ``F.cross_entropy``) as a yardstick."""
    from apex_tpu_torch.ops import fused_lm_xent as fx
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 16)
    v, hd, n = FULL_CFG["vocab_size"], FULL_CFG["hidden_size"], \
        LEAN_HEAD_TOKENS
    h = torch.randn(n, hd, generator=gen, device=dev).bfloat16()
    w = (torch.randn(v, hd, generator=gen, device=dev)
         * LEAN_HEAD_W_STD).bfloat16()
    labels = torch.randint(0, v, (n,), generator=gen, device=dev)
    torch.matmul(h[:128], w[:128].T)              # the GEMM library's set-up
    flops = 3 * 2 * n * hd * v                    # logits, dh, dW
    nbytes = 2 * (2 * n * hd + 2 * v * hd) + 8 * n
    bound, by = _bound(nbytes, flops)
    print(f"lean_train head on {_smi()}: [{n}, {hd}] x [{v}, {hd}] bf16, "
          f"forward + backward of the summed loss; bound {bound:.4f} ms "
          f"({by}: {flops / 1e12:.2f} TFLOP, {nbytes / 1e9:.3f} GB)")
    rows = {}
    rows["unfused"], ref = _head_row(
        "unfused", fx.lm_head_xentropy_reference, h, w, labels, 3)
    for label, vc in ((f"fused {LEAN_CHUNK}", 0),
                      (f"fused {LEAN_CHUNK} + vocab {LEAN_VOCAB_CHUNK}",
                       LEAN_VOCAB_CHUNK)):
        rows[label], _ = _head_row(
            label, lambda a, b, y, vc=vc: fx.fused_lm_head_cross_entropy(
                a, b, y, token_chunk=LEAN_CHUNK, vocab_chunk=vc),
            h, w, labels, 3, ref)
    rows["torch"], _ = _head_row(
        "F.linear + F.cross_entropy",
        lambda a, b, y: F.cross_entropy(F.linear(a, b).float(), y,
                                        reduction="none"),
        h, w, labels, 3, ref)
    del ref
    torch.cuda.empty_cache()
    unfused = rows["unfused"]["rise_bytes"]
    for label, r in rows.items():
        if not label.startswith("fused"):
            continue
        if not (r["loss_rel"] <= TOL_LEAN_LOSS_REL
                and r["dh"] <= TOL_LEAN_HEAD_GRAD
                and r["dW"] <= TOL_LEAN_HEAD_GRAD):
            raise AssertionError(f"lean_train head {label} is off the "
                                 f"unfused head: {r}")
        if not r["rise_bytes"] <= unfused / 2:
            raise AssertionError(
                f"lean_train head {label}: peak rise {r['rise_bytes']} is "
                f"not at most half the unfused head's {unfused}")
    return dict(rows=rows, bound_ms=bound)


def _lean_llama(dev, seed: int, adam8k=None, profile: bool = False):
    """``adam 8192 lean``: the 4-layer Llama-3-8B-wide model on
    ``SPLIT_SEQ`` tokens as the train phase's ``adam 8192``, with the
    fused head at ``LEAN_CHUNK`` and ``remat``.  Its first loss within
    1e-3 relative of the same weights' unfused, non-remat loss; each
    step launches #3 twice a layer (forward and recompute), the split
    pair once and the one-pass backward never."""
    from apex_tpu_torch.optimizers import functional
    _, model, batch = _train_model(dev, seed, TRAIN_LAYERS, SPLIT_SEQ)
    with torch.no_grad():
        ref_loss = _train_loss(model, batch).item()
    del model, batch
    torch.cuda.empty_cache()
    run = _train_run(dev, seed, "adam 8192 lean",
                     functional.fused_adam(lr=TRAIN_LR), TRAIN_LAYERS,
                     LEAN_STEPS, "dynamic", SPLIT_TRAIN_KERNELS,
                     profile=profile, seq=SPLIT_SEQ,
                     cfg_kw=dict(fused_head_xent=LEAN_CHUNK, remat=True))
    got = run["launches"]
    want = {"flash_attention": 2 * TRAIN_LAYERS * LEAN_STEPS,
            "flash_attention_bwd_dq": TRAIN_LAYERS * LEAN_STEPS,
            "flash_attention_bwd_dkv": TRAIN_LAYERS * LEAN_STEPS,
            "flash_attention_bwd": 0}
    rel = abs(run["losses"][0] - ref_loss) / abs(ref_loss)
    print(f"  adam 8192 lean: first loss {run['losses'][0]:.6f} against the "
          f"unfused, non-remat loss {ref_loss:.6f} on the same weights: "
          f"{rel:.3e} relative (limit {TOL_LEAN_LOSS_REL}); flash launches "
          f"{ {k: got[k] for k in want} } (want {want})")
    if rel > TOL_LEAN_LOSS_REL:
        raise AssertionError(f"adam 8192 lean: first loss {rel} off the "
                             f"unfused loss")
    if any(got[k] != n for k, n in want.items()):
        raise AssertionError(f"adam 8192 lean: the recompute's launches "
                             f"are not {want}: {got}")
    if adam8k is not None:
        print(f"  adam 8192 (this process): {adam8k['step_s']:.4f} s, "
              f"{adam8k['tokens'] / adam8k['step_s']:.1f} tokens/s, "
              f"{adam8k['peak_bytes'] / 2**30:.2f} GiB; lean "
              f"{run['step_s']:.4f} s, {run['tokens'] / run['step_s']:.1f} "
              f"tokens/s, {run['peak_bytes'] / 2**30:.2f} GiB")
        if not run["peak_bytes"] < adam8k["peak_bytes"]:
            raise AssertionError("adam 8192 lean: its peak device memory is "
                                 "not below adam 8192's")
    return run


def _lean_lm(dev, seed: int, kind: str, lean_kw: dict, lm=None,
             profile: bool = False):
    """GPT-3 1.3B (``gpt_train``'s batch, dropout and Adam) or BERT-large
    (``bert_train``'s) for ``LEAN_STEPS`` steps twice from the same
    weights and generator seeds: the plain route, then ``lean_kw``.  The
    first steps' flat grads within ``TOL_TRAIN_GRAD_REL_L2`` leaf by leaf
    and their losses within 1e-3 relative; each step's flash launches as
    :func:`phase_lm_train` holds them (the forward's instance twice a
    layer under ``remat``).  ``lm``: the six-step run of this process,
    printed beside; ``profile`` breaks both routes' steps down."""
    plain_g, lean_g = [], []
    plain = phase_lm_train(dev, seed, kind, steps=LEAN_STEPS, keep=plain_g,
                           tag=f"plain ({LEAN_STEPS} steps)", profile=profile)
    lean = phase_lm_train(dev, seed, kind, cfg_kw=lean_kw, steps=LEAN_STEPS,
                          keep=lean_g, tag="lean", profile=profile)
    phase = LM_RUNS[kind][0]
    print(f"{phase} lean against plain, first step:")
    losses = [lean["losses"][0], plain["losses"][0]]
    rel = abs(losses[0] - losses[1]) / abs(losses[1])
    got, ref = lean_g[0].to(dev), plain_g[0].to(dev)
    del lean_g, plain_g
    rels = _hold_grads(f"{phase} lean", got, ref, lean["leaves"], losses,
                       TOL_TRAIN_GRAD_REL_L2, top=8)
    del got, ref
    torch.cuda.empty_cache()
    print(f"  first losses {rel:.3e} relative (limit {TOL_LEAN_LOSS_REL})")
    if rel > TOL_LEAN_LOSS_REL:
        raise AssertionError(f"{phase} lean: first loss {rel} off the plain "
                             f"route's")
    runs = dict(plain=plain, lean=lean)
    if lm is not None:
        runs[f"{LM_TRAIN_STEPS} steps"] = lm
    for label, r in runs.items():
        print(f"  {phase} {label}: {r['step_s']:.4f} s, "
              f"{r['tokens'] / r['step_s']:.1f} tokens/s, "
              f"{r['peak_bytes'] / 2**30:.2f} GiB")
    return dict(lean, grad_rel_l2=max(rels.values()), plain=plain)


def phase_lean_train(dev, seed: int, adam8k=None, lm_runs=None,
                     profile: bool = False):
    """The loss side of training: the LM head alone (unfused, fused, fused
    with vocab slices), ``adam 8192 lean`` (the fused head and remat on
    the 4-layer Llama-3-8B-wide model at 8192 tokens), ``gpt_train lean``
    (GPT-3 1.3B with remat and the fused head) and ``bert_train lean``
    (BERT-large with remat and ``ce_half_residuals``), each of the last
    two against its plain route (``profile``: each run's steps broken
    down by kernel).  Returns the launch counts of the three runs, added
    together, and each part's record."""
    lm_runs = lm_runs or {}
    head = _lean_head(dev, seed)
    llama = _lean_llama(dev, seed, adam8k, profile)
    gpt = _lean_lm(dev, seed, "gpt",
                   dict(remat=True, fused_head_xent=LEAN_CHUNK),
                   lm_runs.get("gpt"), profile)
    bert = _lean_lm(dev, seed, "bert",
                    dict(remat=True, ce_half_residuals=True),
                    lm_runs.get("bert"), profile)
    launches = {k: llama["launches"][k] + gpt["launches"][k]
                + bert["launches"][k] for k in llama["launches"]}
    print("lean_train summary (step time, tokens/s, peak device memory):")
    for label, r in (("adam 8192 lean", llama), ("gpt_train lean", gpt),
                     ("bert_train lean", bert)):
        print(f"  {label}: {r['step_s']:.4f} s, "
              f"{r['tokens'] / r['step_s']:.1f} tokens/s, "
              f"{r['peak_bytes'] / 2**30:.2f} GiB")
    return dict(launches=launches, head=head, llama=llama, gpt=gpt,
                bert=bert)


def _seq_rel_l2(got, ref, b: int) -> float:
    """The largest over the ``b`` sequences of the relative L2 difference
    of their parts of a tensor that leads with them (``[b, s, vocab]``
    logits, ``[b*h, s, d]`` flash outputs)."""
    got, ref = got.float().reshape(b, -1), ref.float().reshape(b, -1)
    return ((got - ref).norm(dim=1) / ref.norm(dim=1)).max().item()


@contextlib.contextmanager
def _wrong_attention(n: int, **override):
    """The ``n``-th flash forward (from 0) inside the context runs with
    ``override`` in its keyword arguments (``causal``, ``mask3``): one
    wrong layer, for showing that a check sees it."""
    attn = importlib.import_module("apex_tpu_torch.ops.attention")
    fwd, calls = attn._fwd, itertools.count()

    def wrong(q3, k3, v3, causal, scale, **kw):
        if next(calls) == n:
            kw = {**kw, "causal": causal, **override}
            causal = kw.pop("causal")
        return fwd(q3, k3, v3, causal, scale, **kw)

    attn._fwd = wrong
    try:
        yield
    finally:
        attn._fwd = fwd


@contextlib.contextmanager
def _plain_kernels():
    """Route the model's kernel calls to their plain versions (for the
    train-check's reference step): the norm and flash dispatchers are
    module functions looked up at call time."""
    ln = importlib.import_module("apex_tpu_torch.ops.layer_norm")
    attn = importlib.import_module("apex_tpu_torch.ops.attention")
    saved = (ln._fwd_2d, ln._bwd_2d, attn._fwd, attn._bwd)

    def fwd_2d(x2, w, b, eps, rms):
        return (ln.rms_norm_reference(x2, w, eps) if rms
                else ln.layer_norm_reference(x2, w, b, eps))

    def bwd(*args, head_dim=None, **kw):    # the plain backward has no gate
        return attn._bwd_reference(*args, **kw)

    ln._fwd_2d, ln._bwd_2d = fwd_2d, ln._bwd_reference
    attn._fwd, attn._bwd = attn._fwd_reference, bwd
    try:
        yield
    finally:
        ln._fwd_2d, ln._bwd_2d, attn._fwd, attn._bwd = saved


def _step_grads(dev, seed: int, seq: int, route):
    """One step of the 1-layer model on ``seq`` tokens inside the
    context ``route``: its flat grads (cloned from the grad transform),
    loss, launch counts and ``(leaf name, size)`` list."""
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.utils import tree_leaves_with_path
    _, model, tx, state, batch, train_step = _train_setup(dev, seed, 1,
                                                          seq=seq)
    leaves = [(".".join(path), t.numel())
              for path, t in tree_leaves_with_path(model)]
    keep = []
    step = train_step.make_train_step(
        _train_loss, tx, grad_transform=lambda g: keep.append(
            g.clone()) or g)
    _build.reset_launch_counts()
    with route:
        _, loss = step(state, batch)
    counts = _build.launch_counts()
    grads, loss = keep[0], loss.item()
    del model, state, step, keep
    torch.cuda.empty_cache()
    return grads, loss, counts, leaves


def _hold_grads(label, got, ref, leaves, losses, limit, top=None):
    """Hold the flat grads ``got`` against ``ref``: the relative L2 on
    every leaf's slice (the worst within ``limit``), finite values, and
    the two losses within TOL_TRAIN_LOSS; returns the leaves' readings.
    ``top`` prints only that many of the worst leaves."""
    rels, off = {}, 0
    for name, size in leaves:
        g_, r_ = got[off:off + size], ref[off:off + size]
        rels[name] = ((g_ - r_).norm() / r_.norm()).item()
        off += size
    rel = ((got - ref).norm() / ref.norm()).item()
    worst = max(rels, key=rels.get)
    finite = bool(torch.isfinite(got).all())
    print(f"  losses {losses[0]:.6f} and {losses[1]:.6f}; flat grads "
          f"relative L2 {rel:.3e} in all, by leaf"
          + ("" if top is None else f" (the worst {top})") + ":")
    shown = rels if top is None else dict(
        sorted(rels.items(), key=lambda kv: -kv[1])[:top])
    for name, r in shown.items():
        print(f"    {r:.3e}  {name}")
    print(f"  worst leaf {worst} {rels[worst]:.3e} (limit {limit}), finite "
          f"{finite}")
    if not finite or not rels[worst] <= limit:
        raise AssertionError(f"{label}: flat grads off: relative L2 "
                             f"{rels[worst]} in {worst}")
    if abs(losses[0] - losses[1]) > TOL_TRAIN_LOSS:
        raise AssertionError(f"{label}: losses differ: {losses}")
    return rels


def phase_train_check(dev, seed: int):
    """One step of the 1-layer model through the kernels against the
    same step through the plain versions: the flat grads leaf by leaf,
    and the loss."""
    got, loss_k, _, leaves = _step_grads(dev, seed, TRAIN_SEQ,
                                         contextlib.nullcontext())
    ref, loss_p, counts, _ = _step_grads(dev, seed, TRAIN_SEQ,
                                         _plain_kernels())
    routed = [k for k in ("layer_norm", "layer_norm_bwd", "flash_attention",
                          "flash_attention_bwd") + SPLIT_KERNELS
              if counts[k]]
    if routed:
        raise AssertionError(f"the plain step launched {routed}: {counts}")
    print("train-check (1 layer): kernels, then plain versions")
    rels = _hold_grads("train-check", got, ref, leaves, [loss_k, loss_p],
                       TOL_TRAIN_GRAD_REL_L2)
    del got, ref
    torch.cuda.empty_cache()
    return dict(grad_rel_l2=rels, losses=[loss_k, loss_p])


@contextlib.contextmanager
def _one_pass_backward():
    """Raise the flash backward's gate so the one-pass kernel takes every
    length (the module reads it at call time)."""
    attn = importlib.import_module("apex_tpu_torch.ops.attention")
    saved = attn._FUSED_BWD_MAX_BYTES
    attn._FUSED_BWD_MAX_BYTES = 1 << 62
    try:
        yield
    finally:
        attn._FUSED_BWD_MAX_BYTES = saved


def phase_split_check(dev, seed: int):
    """One 8192-token step of the 1-layer model through the split
    backward against the same step with the gate raised, so the one-pass
    kernel takes it: both on the card (the plain route would need tens
    of GiB of score temporaries), the flat grads leaf by leaf and the
    loss."""
    got, loss_s, cs, leaves = _step_grads(dev, seed, SPLIT_SEQ,
                                          contextlib.nullcontext())
    ref, loss_o, co, _ = _step_grads(dev, seed, SPLIT_SEQ,
                                     _one_pass_backward())
    print(f"split-check (1 layer, {SPLIT_SEQ} tokens): split route launched "
          f"{ {k: cs[k] for k in ('flash_attention_bwd',) + SPLIT_KERNELS} }, "
          f"one-pass route "
          f"{ {k: co[k] for k in ('flash_attention_bwd',) + SPLIT_KERNELS} }")
    if any(cs[k] != 1 for k in SPLIT_KERNELS) or cs["flash_attention_bwd"] \
            or co["flash_attention_bwd"] != 1 \
            or any(co[k] for k in SPLIT_KERNELS):
        raise AssertionError("the split check did not take its two routes")
    print("  split route, then one-pass route")
    rels = _hold_grads("split-check", got, ref, leaves, [loss_s, loss_o],
                       TOL_SPLIT_GRAD_REL_L2)
    del got, ref
    torch.cuda.empty_cache()
    return dict(grad_rel_l2=rels, losses=[loss_s, loss_o])


@contextlib.contextmanager
def _plain_shim():
    """Route the shim's kernels to their plain versions: the axpby, norm
    and fused scale-and-norm wrappers look up their kernel functions at
    call time, and the shim looks up ``fused_scale``."""
    fu = importlib.import_module("apex_tpu_torch.ops.fused_update")
    names = ("_axpby", "_l2norm", "_l2norm_scale")
    saved = [getattr(fu, f"{nm}_kernel") for nm in names] + [fu.fused_scale]
    for nm in names:
        setattr(fu, f"{nm}_kernel", getattr(fu, f"{nm}_plain"))
    fu.fused_scale = lambda flat, scale, out_dtype=None: fu._scale_reference(
        flat, fu._scalar(scale, flat.device), out_dtype or flat.dtype)
    try:
        yield
    finally:
        for nm, fn in zip(names, saved):
            setattr(fu, f"{nm}_kernel", fn)
        fu.fused_scale = saved[-1]


def phase_shim(dev, seed: int):
    """Apex's ``multi_tensor_applier`` over a real grad list: one
    backward of the 1-layer model (2048 tokens), then each of the four
    ops over its 11 grads (bf16 linears, fp32 norms) through the kernels,
    against the same calls through the plain versions on the card; an
    inf in one grad must raise every flag, and ``noop_flag`` must pass
    through.  Returns the launch counts of the kernel calls."""
    from apex_tpu_torch.multi_tensor_apply import (
        multi_tensor_applier, multi_tensor_axpby, multi_tensor_l2norm,
        multi_tensor_l2norm_scale, multi_tensor_scale)
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.utils import tree_leaves_with_path
    _, model, batch = _train_model(dev, seed, 1)
    _train_loss(model, batch).backward()
    named = tree_leaves_with_path(model)
    grads = [p.grad for _, p in named]
    params = [p.detach() for _, p in named]
    print(f"shim: multi_tensor_applier over the 1-layer model's "
          f"{len(grads)} grads ({sum(g.numel() for g in grads)} elements; "
          f"dtypes {sorted({str(g.dtype) for g in grads})})")
    calls = (("multi_tensor_scale", multi_tensor_scale, [grads], (0.5,)),
             ("multi_tensor_axpby", multi_tensor_axpby, [grads, params],
              (2.0, -0.5)),
             ("multi_tensor_l2norm", multi_tensor_l2norm, [grads], (True,)),
             ("multi_tensor_l2norm_scale", multi_tensor_l2norm_scale,
              [grads], (0.5, True)))

    def run_all(noop=0.0):
        return [multi_tensor_applier(op, noop, lists, *args)
                for _, op, lists, args in calls]

    torch.cuda.synchronize()
    _build.reset_launch_counts()
    got = run_all()
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    with _plain_shim():
        ref = run_all()
    if _build.launch_counts() != launches:
        raise AssertionError("the plain shim route launched a kernel")
    want = {"fused_scale": 1, "fused_axpby": 1, "fused_l2norm": 1,
            "fused_l2norm_scale": 1}
    print(f"  kernel launches of the four calls "
          f"{ {k: v for k, v in launches.items() if v} } (want {want})")
    if {k: v for k, v in launches.items() if v} != want:
        raise AssertionError("the shim did not launch one kernel a call")

    def flat(x):
        if isinstance(x, torch.Tensor):
            return [x]
        if isinstance(x, (list, tuple)):
            return [t for item in x for t in flat(item)]
        return []

    worst = {}
    for (name, *_), g_, r_ in zip(calls, got, ref):
        gt, rt = flat(g_), flat(r_)
        if len(gt) != len(rt):
            raise AssertionError(f"{name}: outputs differ in structure")
        err = 0.0
        for a_, b_ in zip(gt, rt):
            if a_.shape != b_.shape or a_.dtype != b_.dtype:
                raise AssertionError(f"{name}: {a_.shape} {a_.dtype} against "
                                     f"{b_.shape} {b_.dtype}")
            rel = ((a_.float() - b_.float()).abs().max()
                   / b_.float().abs().max().clamp_min(1e-30)).item() \
                if a_.numel() else 0.0
            err = max(err, rel)
        worst[name] = err
        print(f"  {name}: worst max|diff| / max|ref| over its outputs "
              f"{err:.3e} (limit {TOL_L2NORM_REL})")
    if any(v > TOL_L2NORM_REL for v in worst.values()):
        raise AssertionError(f"the shim is off its plain route: {worst}")
    del got, ref
    noop = run_all(torch.ones((), device=dev))
    flags = [noop[0][1].item(), noop[1][1].item(), noop[3][3].item()]
    grads[3].view(-1)[0] = float("inf")
    poisoned = run_all()
    pflags = [poisoned[0][1].item(), poisoned[1][1].item(),
              poisoned[3][3].item()]
    print(f"  noop_flag 1 passed through: found_inf {flags}; an inf in "
          f"grad 3: found_inf of scale, axpby, l2norm_scale {pflags}, "
          f"global norm {poisoned[2][0].item()}")
    if flags != [1.0, 1.0, 1.0] or pflags != [1.0, 1.0, 1.0]:
        raise AssertionError("a shim flag did not rise")
    del model, grads, params, noop, poisoned
    torch.cuda.empty_cache()
    return dict(launches=launches, worst=worst)


@contextlib.contextmanager
def _plain_updates():
    """Route the optimizer kernels to their plain versions (the wrappers
    look up their kernel functions at call time)."""
    fu = importlib.import_module("apex_tpu_torch.ops.fused_update")
    names = ("_l2norm", "_lamb1", "_sgd", "_adagrad")
    saved = [getattr(fu, f"{nm}_kernel") for nm in names]
    for nm in names:
        setattr(fu, f"{nm}_kernel", getattr(fu, f"{nm}_plain"))
    try:
        yield
    finally:
        for nm, fn in zip(names, saved):
            setattr(fu, f"{nm}_kernel", fn)


def phase_rule_check(dev, seed: int):
    """For LAMB, SGD and Adagrad: one step of the 1-layer model (no loss
    scale) gives warm slots and its flat grads; then ``tx.update`` from
    two clones of that state with those grads, once through the kernels
    and once through their plain versions, master and slots held leaf by
    leaf."""
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.optimizers import functional
    from apex_tpu_torch.utils import tree_leaves_with_path
    rules = (("lamb", functional.fused_lamb(**LAMB_KW)),
             ("sgd", functional.fused_sgd(**SGD_KW)),
             ("adagrad", functional.fused_adagrad(**ADAGRAD_KW)))
    worst_all = {}
    for label, tx in rules:
        _, model, tx, state, batch, train_step = _train_setup(
            dev, seed, RULE_LAYERS, tx, None)
        leaves = [(".".join(path), t.numel())
                  for path, t in tree_leaves_with_path(model)]
        state, _ = train_step.make_train_step(_train_loss, tx)(state, batch)
        grads = state.flat.flat_grads.clone()
        opt = state.opt
        del model, state
        clones = [opt.replace(master=opt.master.clone(),
                              slots={k: t.clone()
                                     for k, t in opt.slots.items()})
                  for _ in range(2)]
        del opt
        torch.cuda.empty_cache()
        _build.reset_launch_counts()
        got = tx.update(clones[0], grads)
        counts = _build.launch_counts()
        with _plain_updates():
            ref = tx.update(clones[1], grads)
        if _build.launch_counts() != counts or not any(counts.values()):
            raise AssertionError(f"{label}: the kernel route launched "
                                 f"{counts}, the plain route "
                                 f"{_build.launch_counts()}")
        worst = {}
        for name, a, b in [("master", got.master, ref.master)] + [
                (k, got.slots[k], ref.slots[k]) for k in sorted(got.slots)
                if got.slots[k].dim() == 1]:
            off, rel = 0, {}
            for leaf, size in leaves:
                ga, rb = a[off:off + size], b[off:off + size]
                scale = max(rb.abs().max().item(), 1e-30)
                rel[leaf] = (ga - rb).abs().max().item() / scale
                off += size
            key = max(rel, key=rel.get)
            worst[name] = (key, rel[key])
        for k in got.slots:
            if got.slots[k].dim() == 0 and not torch.equal(got.slots[k],
                                                           ref.slots[k]):
                raise AssertionError(f"{label}: slot {k} differs")
        print(f"rule check {label} (1 layer, one update from a warm state, "
              f"kernels vs plain; launches "
              f"{ {k: v for k, v in counts.items() if v} }): worst leaf "
              f"max|diff| / "
              f"max|ref| by buffer: "
              + ", ".join(f"{nm} {v:.3e} ({leaf})"
                          for nm, (leaf, v) in worst.items())
              + f" (limit {TOL_RULE_CHECK_REL})")
        del got, ref, clones, grads
        torch.cuda.empty_cache()
        bad = {nm: v for nm, v in worst.items()
               if not v[1] <= TOL_RULE_CHECK_REL}
        if bad:
            raise AssertionError(f"{label}: update off its plain route: {bad}")
        worst_all[label] = worst
    return worst_all


@contextlib.contextmanager
def _plain_updates_refused():
    """Make every plain version of the update kernels raise: a class-API
    step on the card that reached one would fail the phase."""
    fu = importlib.import_module("apex_tpu_torch.ops.fused_update")
    saved = {n: getattr(fu, n) for n in dir(fu) if n.endswith("_plain")}

    def refuse(name):
        def plain(*args, **kwargs):
            raise AssertionError(f"{name} ran on the card")
        return plain

    for name in saved:
        setattr(fu, name, refuse(name))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(fu, name, fn)


def _strict_step(opt, **kw):
    """``opt.step()`` under ``set_sync_debug_mode("error")``: from the
    end of the backward to the new parameters, nothing reads back."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        opt.step(**kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _add_counts(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def _twin_loop(dev, seed: int):
    """Apex's own loop on the 4-layer model: ``FusedAdam(model.
    parameters())``, then six rounds of ``loss.backward(); opt.step();
    opt.zero_grad()``.  Returns the launch counts, step time, peak memory
    and the time of the grad-buffer copy pass."""
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.optimizers._torch_mode import FusedAdamTorch
    t0 = time.perf_counter()
    cfg, model, batch = _train_model(dev, seed, TRAIN_LAYERS)
    opt = FusedAdam(model.parameters(), lr=TRAIN_LR)
    if type(opt) is not FusedAdamTorch:
        raise AssertionError(f"FusedAdam(model.parameters()) gave "
                             f"{type(opt).__name__}")
    n = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    print(f"optim twin adam: FusedAdam(model.parameters()) is "
          f"{type(opt).__name__}; Llama-3-8B widths, {TRAIN_LAYERS} layers, "
          f"{n} parameters, {TRAIN_SEQ} tokens a step, set up in "
          f"{time.perf_counter() - t0:.1f} s")
    losses, times = [], []
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = _train_loss(model, batch)
        loss.backward()
        _strict_step(opt)
        opt.zero_grad()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    launches = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    step_s = float(np.median(times[1:]))
    print(f"  losses {[round(x, 4) for x in losses]}")
    print(f"  step times {[round(t, 4) for t in times]} s; median of steps "
          f"2-{TRAIN_STEPS} {step_s:.4f} s = {TRAIN_SEQ / step_s:.1f} "
          f"tokens/s; peak device memory {peak / 2**30:.2f} GiB")
    print(f"  kernel launches per step: "
          f"{ {k: v / TRAIN_STEPS for k, v in launches.items() if v} }")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"twin adam: the loss did not fall: {losses}")
    if launches["fused_adam"] != TRAIN_STEPS:
        raise AssertionError(f"twin adam: fused_adam launched "
                             f"{launches['fused_adam']} times in "
                             f"{TRAIN_STEPS} steps")
    # the pass the functional step does not have: each fresh grad copied
    # into its slot of the grad buffer (zero_grad set the grads to None)
    _train_loss(model, batch).backward()
    fg = opt._groups[0]
    pairs = [(gv, p.grad) for p, gv in zip(fg.params, fg.flat.grad_views)]
    grad_bytes = sum(g.numel() * g.element_size() for _, g in pairs)
    copy_ms = _time_ms(lambda: [gv.copy_(g) for gv, g in pairs], 5)
    cast_ms = _time_ms(fg.flat.cast_grads, 5)
    load_ms = _time_ms(lambda: fg.flat.load(fg.master), 5)
    print(f"  twin step passes: grad-buffer copy {copy_ms:.4f} ms ("
          f"{len(pairs)} copies, {grad_bytes / 1e9:.3f} GB each way, bound "
          f"{2 * grad_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms), grad cast "
          f"{cast_ms:.4f} ms, master cast into the parameters "
          f"{load_ms:.4f} ms")
    del pairs, opt, model, fg
    torch.cuda.empty_cache()
    return dict(launches=launches, step_s=step_s, peak_bytes=peak,
                losses=losses, copy_ms=copy_ms)


def _leaf_key(name: str) -> str:
    return "".join(f"[{k!r}]" for k in name.split("."))


def _twin_against_functional(dev, seed: int):
    """From one warm state (two functional Adam steps, no loss scale, on
    the 1-layer model), one ``make_train_step`` step and one step of a
    ``FusedAdam`` twin on a second copy of the model, fed the functional
    step's grads (the one-pass flash backward adds dq in any order, so
    two backwards differ in their last bits): master, ``exp_avg`` and
    ``exp_avg_sq`` of every leaf, and the update launches, must agree."""
    from apex_tpu_torch import train_step
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.optimizers import FusedAdam, functional
    tx = functional.fused_adam(lr=TRAIN_LR)
    _, model_f, batch = _train_model(dev, seed, RULE_LAYERS)
    state = train_step.init_train_state(tx, model_f)
    step = train_step.make_train_step(_train_loss, tx)
    for _ in range(2):
        state, _ = step(state, batch)
    _, model_t, _ = _train_model(dev, seed, RULE_LAYERS)
    opt = FusedAdam(model_t.parameters(), lr=TRAIN_LR)
    offsets = train_step.leaf_offsets(model_f)
    count = int(state.opt.count.item())
    ref = {"master": state.opt.master, **state.opt.slots}
    # each twin leaf's slice of the functional flat buffers
    leaves = [(name, p, *offsets[_leaf_key(name)])
              for name, p in model_t.named_parameters()]
    sd = opt.state_dict()
    for i, (_, p, off, size, shape) in enumerate(leaves):
        sd["state"][i] = {"step": count, **{
            k: buf[off:off + size].view(shape) for k, buf in ref.items()}}
    opt.load_state_dict(sd)
    with torch.no_grad():
        for _, p, off, size, shape in leaves:
            p.copy_(ref["master"][off:off + size].view(shape))
    _build.reset_launch_counts()
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    f_counts = _build.launch_counts()
    # the functional step's grads, as autograd would hand them over
    views = dict(zip(offsets, state.flat.grad_views))
    for name, p, *_ in leaves:
        p.grad = views[_leaf_key(name)]
    _build.reset_launch_counts()
    _strict_step(opt)
    torch.cuda.synchronize()
    t_counts = _build.launch_counts()
    worst = {}
    for name, p, off, size, shape in leaves:
        st = opt.state[p]
        for k, buf in ref.items():
            a = st.get(k, p)                 # an fp32 leaf is its master
            b = buf[off:off + size].view(shape)
            rel = (a.float() - b).abs().max().item() / max(
                b.abs().max().item(), 1e-30)
            if rel >= worst.get(k, (-1.0,))[0]:
                worst[k] = (rel, name)
    upd = {k: (f_counts[k], t_counts[k]) for k in ("fused_adam",)}
    print(f"optim twin vs functional (1 layer, one Adam step from a warm "
          f"state at step {count}, the functional step's grads): worst "
          f"leaf max|diff| / max|ref|: "
          + ", ".join(f"{k} {v:.3e} ({leaf})" for k, (v, leaf)
                      in worst.items())
          + f" (limit {TOL_TWIN_REL}); update launches functional/twin "
          f"{upd}; the twin step launched "
          f"{ {k: v for k, v in t_counts.items() if v} }")
    bad = {k: v for k, v in worst.items() if not v[0] <= TOL_TWIN_REL}
    if bad:
        raise AssertionError(f"twin step off the functional step: {bad}")
    if not f_counts["fused_adam"] == t_counts["fused_adam"] == 1 or any(
            v for k, v in t_counts.items() if k != "fused_adam"):
        raise AssertionError(f"launches differ: functional {f_counts}, "
                             f"twin {t_counts}")
    del opt, model_t, model_f, state, step, views, ref, leaves
    torch.cuda.empty_cache()
    return worst


def _other_twins(dev, seed: int):
    """LAMB (two groups: decay and no-decay), SGD and Adagrad twins on the
    1-layer model, ``OPTIM_RULE_STEPS`` rounds each: each rule's kernel
    once per group and step; LAMB's norm 2 per leaf plus at most 2 per
    group a step."""
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.optimizers import FusedAdagrad, FusedLAMB, FusedSGD
    out = {}
    for label, cls, kw, kernel in (
            ("lamb", FusedLAMB, LAMB_KW, "fused_lamb1"),
            ("sgd", FusedSGD, SGD_KW, "fused_sgd"),
            ("adagrad", FusedAdagrad, ADAGRAD_KW, "fused_adagrad")):
        _, model, batch = _train_model(dev, seed, RULE_LAYERS)
        named = list(model.named_parameters())
        groups = [{"params": [p for n, p in named if "norm" not in n]},
                  {"params": [p for n, p in named if "norm" in n],
                   "weight_decay": 0.0}]
        opt = cls(groups if label == "lamb" else model.parameters(), **kw)
        n_groups = len(opt.param_groups)
        losses = []
        _build.reset_launch_counts()
        for _ in range(OPTIM_RULE_STEPS):
            loss = _train_loss(model, batch)
            loss.backward()
            _strict_step(opt)
            opt.zero_grad()
            losses.append(loss.item())
        launches = _build.launch_counts()
        per_step = {k: v / OPTIM_RULE_STEPS for k, v in launches.items()
                    if v}
        print(f"optim twin {label} ({type(opt).__name__}, 1 layer, "
              f"{len(named)} leaves in {n_groups} group(s)): losses "
              f"{[round(x, 4) for x in losses]}; launches per step "
              f"{per_step}")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"twin {label}: non-finite loss {losses}")
        if launches[kernel] != n_groups * OPTIM_RULE_STEPS:
            raise AssertionError(f"twin {label}: {kernel} launched "
                                 f"{launches[kernel]} times")
        if label == "lamb":
            norms = launches["fused_l2norm"] / OPTIM_RULE_STEPS
            if not 2 * len(named) < norms <= 2 * len(named) + 2 * n_groups:
                raise AssertionError(f"twin lamb: {norms} norm launches a "
                                     f"step for {len(named)} leaves")
        out[label] = launches
        del opt, model, groups, named
        torch.cuda.empty_cache()
    return out


def _tree_lamb(dev, seed: int):
    """``FusedLAMB(tree).step(grads_tree)`` over the 1-layer model's
    parameter tree, three steps, against the functional LAMB update on
    the same flat grads from a clone of the same state."""
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.optimizers import FusedLAMB, functional
    from apex_tpu_torch.utils import tree_leaves_with_path, tree_ravel
    _, model, batch = _train_model(dev, seed, RULE_LAYERS)

    def tree_of(tensors):
        tree: dict = {}
        for (path, _), t in zip(tree_leaves_with_path(model), tensors):
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = t
        return tree

    leaves = tree_leaves_with_path(model)
    params = tree_of([p.detach() for _, p in leaves])
    opt = FusedLAMB(params, **LAMB_KW)
    if type(opt) is not FusedLAMB:
        raise AssertionError(f"FusedLAMB(tree) gave {type(opt).__name__}")
    tx = functional.fused_lamb(**LAMB_KW)
    ref = tx.init(params)
    launches, worst = {}, {}
    for i in range(OPTIM_TREE_STEPS):
        model.zero_grad(set_to_none=True)
        _train_loss(model, batch).backward()
        grads = tree_of([p.grad for _, p in leaves])
        _build.reset_launch_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            opt.step(grads)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        _add_counts(launches, _build.launch_counts())
        ref = tx.update(ref, tree_ravel(grads)[0])
        group = opt.param_groups[0]
        for k, a, b in [("master", group.master, ref.master)] + [
                (k, group.state[k], ref.slots[k]) for k in ref.slots]:
            off = 0
            for (path, t) in leaves:
                n = t.numel()
                rb = b[off:off + n]
                rel = (a[off:off + n] - rb).abs().max().item() / max(
                    rb.abs().max().item(), 1e-30)
                if rel >= worst.get(k, (-1.0,))[0]:
                    worst[k] = (rel, ".".join(path))
                off += n
        del grads
    per_step = {k: v / OPTIM_TREE_STEPS for k, v in launches.items() if v}
    print(f"optim tree lamb (FusedLAMB(tree).step(grads), 1 layer, "
          f"{len(leaves)} leaves, {OPTIM_TREE_STEPS} steps): launches per "
          f"step {per_step}; against the functional update, worst leaf "
          f"max|diff| / max|ref|: "
          + ", ".join(f"{k} {v:.3e} ({leaf})" for k, (v, leaf)
                      in worst.items()) + f" (limit {TOL_TWIN_REL})")
    bad = {k: v for k, v in worst.items() if not v[0] <= TOL_TWIN_REL}
    if bad:
        raise AssertionError(f"tree lamb off the functional update: {bad}")
    if launches["fused_lamb1"] != OPTIM_TREE_STEPS or launches[
            "fused_l2norm"] != (1 + 2 * len(leaves)) * OPTIM_TREE_STEPS:
        raise AssertionError(f"tree lamb launches: {launches}")
    del opt, ref, model, params
    torch.cuda.empty_cache()
    return launches


def _handoff(dev, seed: int):
    """Train the 4-layer model three ``make_train_step`` steps (Adam,
    dynamic loss scale), hand the state to ``InferenceEngine.
    from_train_state``, free the optimizer, serve the eight prompts; hold
    two requests' decode logits against the full forward; an engine
    from ``from_state_dict`` gives the same tokens."""
    from apex_tpu_torch.inference import InferenceEngine
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.optimizers import functional
    from apex_tpu_torch.utils import tree_leaves_with_path
    cfg, model, tx, state, batch, train_step = _train_setup(
        dev, seed, TRAIN_LAYERS, functional.fused_adam(lr=TRAIN_LR),
        "dynamic")
    step = train_step.make_train_step(_train_loss, tx)
    _build.reset_launch_counts()
    losses = []
    for _ in range(HANDOFF_STEPS):
        state, loss = step(state, batch)
        losses.append(loss.item())
    train_launches = _build.launch_counts()
    print(f"optim handoff: trained {TRAIN_LAYERS} layers {HANDOFF_STEPS} "
          f"steps (fused_adam, dynamic loss scale): losses "
          f"{[round(x, 4) for x in losses]}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"handoff training: the loss did not fall "
                             f"{losses}")
    geometry = dict(slots=8, max_seq=4096, page_size=64, num_pages=512,
                    device=dev)
    t0 = time.perf_counter()
    engine = InferenceEngine.from_train_state("llama", cfg, state,
                                              **geometry)
    torch.cuda.synchronize()
    print(f"  InferenceEngine.from_train_state in "
          f"{time.perf_counter() - t0:.2f} s")
    # free the training state but the master (for from_state_dict) and
    # the model (its template)
    master = state.opt.master
    for p in model.parameters():
        p.grad = None
    del state, step
    torch.cuda.empty_cache()
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).tolist()
               for n in PROMPT_LENS]
    served = _serve(engine, prompts, "handoff serve")
    missing = [k for k in HANDOFF_SERVE_KERNELS if served["launches"][k] <= 0]
    if missing:
        raise AssertionError(f"the handoff serve launched no {missing}")
    worst = 0.0
    for idx in (0, len(prompts) - 1):
        _, d, _ = _check_logits(f"handoff request {idx}", engine,
                                prompts[idx], served["outs"][idx],
                                TOL_LOGITS)
        worst = max(worst, d)
    other = InferenceEngine.from_state_dict("llama", cfg, {"master": master},
                                            model, **geometry)
    same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        tree_leaves_with_path(engine.params),
        tree_leaves_with_path(other.params)))
    outs = other.generate(prompts, max_new_tokens=NEW_TOKENS)
    print(f"  from_state_dict engine: weights equal {same}, greedy tokens "
          f"equal {outs == served['outs']}")
    if not same or outs != served["outs"]:
        raise AssertionError("from_state_dict gave another engine than "
                             "from_train_state")
    del engine, other, master, model
    torch.cuda.empty_cache()
    launches = dict(train_launches)
    _add_counts(launches, served["launches"])
    return dict(launches=launches, ttft_mean_s=served["ttft_mean_s"],
                decode_tokens_per_s=served["decode_tokens_per_s"],
                peak_bytes=served["peak_bytes"], logit_err=worst)


def phase_optim(dev, seed: int):
    """Apex's optimizer classes on the card (see the module docstring,
    phase 10); returns the launch counts of the phase's paths by kernel
    and its records."""
    from apex_tpu_torch.optimizers import functional
    launches: dict = {}
    with _plain_updates_refused():
        twin = _twin_loop(dev, seed)
        _add_counts(launches, twin["launches"])
        func = _train_run(dev, seed, "adam, no loss scale (beside the twin)",
                          functional.fused_adam(lr=TRAIN_LR), TRAIN_LAYERS,
                          TRAIN_STEPS, None, ("fused_adam",))
        print(f"optim: twin Adam step {twin['step_s']:.4f} s, peak "
              f"{twin['peak_bytes'] / 2**30:.2f} GiB; functional step "
              f"{func['step_s']:.4f} s, peak "
              f"{func['peak_bytes'] / 2**30:.2f} GiB (no loss scale; "
              f"{TRAIN_LAYERS} layers, {TRAIN_SEQ} tokens; {_smi()})")
        _twin_against_functional(dev, seed)
        for counts in _other_twins(dev, seed).values():
            _add_counts(launches, counts)
        _add_counts(launches, _tree_lamb(dev, seed))
        handoff = _handoff(dev, seed)
        _add_counts(launches, handoff["launches"])
    return dict(launches=launches, twin=twin, functional=func,
                handoff=handoff)


def _library_of(csrc: Path, build_dir: Path, signatures=None,
                sources=None):
    """The kernel library built from another copy of the kernel sources
    (``csrc``, its sources ``sources``: that copy's ``_build.SOURCES``)
    into ``build_dir``, its entries typed by ``signatures`` (that copy's
    ``_build._SIGNATURES``); the current library is left as it was."""
    from apex_tpu_torch.ops import _build
    saved = (_build.CSRC, _build.BUILD_DIR, _build._LIB, _build._SIGNATURES,
             _build.SOURCES)
    _build.CSRC, _build.BUILD_DIR, _build._LIB = csrc, build_dir, None
    _build._SIGNATURES = signatures or saved[3]
    _build.SOURCES = sources or saved[4]
    try:
        return _build.library()
    finally:
        (_build.CSRC, _build.BUILD_DIR, _build._LIB, _build._SIGNATURES,
         _build.SOURCES) = saved


def _baseline_module(baseline: Path, name: str):
    """``apex_tpu_torch/ops/<name>.py`` of another checkout, loaded under
    a name of its own (it imports the rest from this tree's package)."""
    import importlib.util
    path = baseline / "apex_tpu_torch" / "ops" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_ab_baseline_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Version(NamedTuple):
    """One side of an A/B: its kernel library and the wrapper functions
    it swaps into this tree's modules (``(module, name, function)``:
    the wrappers whose C entries differ between the versions)."""
    lib: object
    patches: tuple = ()


@contextlib.contextmanager
def _as_version(version: _Version):
    from apex_tpu_torch.ops import _build
    saved = [(m, n, getattr(m, n)) for m, n, _ in version.patches]
    own = _build._LIB
    _build._LIB = version.lib
    for m, n, f in version.patches:
        setattr(m, n, f)
    try:
        yield
    finally:
        _build._LIB = own
        for m, n, f in saved:
            setattr(m, n, f)


def _ab(versions, fn, turns: str = "ABBA"):
    """``fn()`` (a time) under each version in turn, A B B A; the mean
    of each version's two turns."""
    got = {"A": [], "B": []}
    for turn in turns:
        with _as_version(versions[turn]):
            got[turn].append(fn())
    return {t: float(np.mean(v)) for t, v in got.items()}, got


def _turns(each):
    return [round(x, 5) for x in each["A"][:1] + each["B"] + each["A"][1:]]


AB_ROWS = ("flash", "paged", "norm", "steps", "masked", "fused", "md",
           "wide", "wide_paged", "partial")


def phase_ab(dev, seed: int, baseline: Path, rows=AB_ROWS):
    """A/B of the kernels against another version of the kernel sources
    (``baseline``, the root of a checkout holding ``apex_tpu_torch``), in
    one process on one card: each version built into a library of its
    own and swapped in turn, A (baseline) B (this tree) B A, with the
    baseline's paged-decode and norm-backward wrappers while its
    library is in (their C entries changed in this tree).  ``rows``:
    ``flash`` times #3 (the forward, ``_fwd``) at causal [1, 32, 128,
    128], [1, 32, 2048, 128] and [1, 32, 8192, 128], #4 (``_bwd``, the
    row's time: delta, dq scratch, kernel, cast) at 2048, #5 (the split
    dq kernel) and #6 (the split dk/dv kernel) at 8192; ``paged`` #7 at
    the kernels phase's lengths and at the serve's (8 slots, window
    4096, lengths 160..2080); ``norm`` #2 at [2048, 4096] and [8192,
    4096] bf16 with an fp32 weight, RMSNorm and LayerNorm; ``steps``
    the unfused 8-slot Llama-3-8B decode step (sixteen turns, median of
    8 a turn) and three 4-layer Adam steps a turn at 2048 and at 8192
    tokens (eight turns, median a turn); ``masked`` #3m at its three
    shapes and ``decode_attention``'s whole kernel branch at Llama-3-8B's
    dense decode (with each version's peak memory rise); ``fused`` #8
    and #8g for one layer each with their phase clocks, the fused GPT-3
    1.3B decode step and the dense Llama-3-8B decode step at 8192
    positions; ``md`` the mask and dropout instances at the training
    paths' shapes and the training steps that run them
    (:func:`_ab_md`); ``wide`` the wide forward, dq and dk/dv (#3w,
    #5w, #6w) at every :func:`_wide_flash_shapes` shape and the ``width
    gpt fp32 train`` step (:func:`_ab_wide`); ``wide_paged`` #7w at every
    :func:`_wide_paged_cases` row, #7 and the dense decode (their bits
    the same from both versions) and the ``width`` serves' decode steps
    (:func:`_ab_wide_paged`); ``partial`` the fused block's rank-partial
    instances (V6) at the tp = 2 and tp = 4 shards of Llama-3-8B and
    GPT-3 1.3B with their phase clocks (:func:`_ab_partial`).  Each row's
    two versions are held against each
    other (and against the plain version) before they are timed.  The
    baseline's own wrappers stand in for this tree's where their C
    entries differ (paged decode and #7w, the norm backward, the masked
    forward and the decode branch) and for the flash backward's (``_bwd``,
    ``_dq_kernel``, ``_dkv_kernel``)."""
    from apex_tpu_torch.ops import _build
    attn = importlib.import_module("apex_tpu_torch.ops.attention")
    pa = importlib.import_module("apex_tpu_torch.ops.paged_attention")
    ln = importlib.import_module("apex_tpu_torch.ops.layer_norm")
    t0 = time.perf_counter()
    base_pa = _baseline_module(baseline, "paged_attention")
    base_ln = _baseline_module(baseline, "layer_norm")
    base_attn = _baseline_module(baseline, "attention")
    models = importlib.import_module("apex_tpu_torch.inference.models")
    # the baseline's masked forward and decode branch, where it has them
    attn_patches = tuple(
        (mod, name, getattr(base_attn, name))
        for mod, name in ((attn, "_fwd"), (attn, "decode_attention"),
                          (models, "decode_attention"), (attn, "_bwd"),
                          (attn, "_dq_kernel"), (attn, "_dkv_kernel"),
                          (attn, "_fwd_wide"), (attn, "_dq_wide"),
                          (attn, "_dkv_wide"))
        if hasattr(base_attn, name))
    base_build = _baseline_module(baseline, "_build")
    versions = {
        "A": _Version(
            _library_of(baseline / "apex_tpu_torch" / "csrc",
                        _build.BUILD_DIR.parent / "ab_baseline",
                        base_build._SIGNATURES, base_build.SOURCES),
            ((pa, "_kernel_call", base_pa._kernel_call),
             (pa, "_wide_call", base_pa._wide_call),
             (ln, "_bwd_2d", base_ln._bwd_2d),
             # the fused blocks' workspace sizes, asked of each library
             (pa, "_WS_BYTES", {})) + attn_patches),
        "B": _Version(_build.library())}
    print(f"ab: baseline {baseline} built in "
          f"{time.perf_counter() - t0:.1f} s; A = baseline, B = this tree, "
          f"on {_smi()}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 7)
    bf = torch.bfloat16
    flash_rows = ((128, "flash_attention"),
                  (TRAIN_SEQ, "flash_attention"),
                  (SPLIT_SEQ, "flash_attention"),
                  (TRAIN_SEQ, "flash_attention_bwd"),
                  (SPLIT_SEQ, "flash_attention_bwd_dq"),
                  (SPLIT_SEQ, "flash_attention_bwd_dkv"))
    for s, name in flash_rows if "flash" in rows else ():
        h, d = 32, 128
        q3, k3, v3, do3 = (torch.randn(h, s, d, generator=gen, device=dev)
                           .to(bf) for _ in range(4))
        scale = d ** -0.5
        out, lse = attn._fwd(q3, k3, v3, True, scale)
        delta = attn._delta(out, do3)
        call = {
            "flash_attention": lambda: attn._fwd(q3, k3, v3, True, scale),
            "flash_attention_bwd": lambda: attn._bwd(q3, k3, v3, out, lse,
                                                     do3, True, scale),
            "flash_attention_bwd_dq": lambda: (attn._dq_kernel(
                q3, k3, v3, lse, delta, do3, True, scale),),
            "flash_attention_bwd_dkv": lambda: attn._dkv_kernel(
                q3, k3, v3, lse, delta, do3, True, scale)}[name]
        # both versions against each other first: the forward's out and
        # lse within the kernel limits, the backward's outputs within the
        # flash backward's relative L2 (their fp32 sums run in another
        # order)
        got = {}
        for turn in "AB":
            with _as_version(versions[turn]):
                got[turn] = call()
        torch.cuda.synchronize()
        if name == "flash_attention":
            err = [(got["A"][0].float() - got["B"][0].float()).abs().max()
                   .item(), (got["A"][1] - got["B"][1]).abs().max().item()]
            print(f"  {name} causal [1, {h}, {s}, {d}]: B against A max|diff| "
                  f"out {err[0]:.3e}, lse {err[1]:.3e}")
            if err[0] > TOL_ATTN_OUT or err[1] > TOL_ATTN_LSE:
                raise AssertionError(f"ab: {name} differs between the "
                                     f"versions")
        else:
            rel = [((a_.float() - b2.float()).norm()
                    / a_.float().norm()).item()
                   for a_, b2 in zip(got["A"], got["B"])]
            print(f"  {name} causal [1, {h}, {s}, {d}]: B against A "
                  f"relative L2 {[f'{r:.3e}' for r in rel]}")
            if max(rel) > TOL_FLASH_BWD_REL_L2:
                raise AssertionError(f"ab: {name} differs between the "
                                     f"versions")
        del got
        iters = {128: 48, TRAIN_SEQ: 10}.get(s, 4)
        mean, each = _ab(versions, lambda: _time_ms(call, iters))
        print(f"  {name} causal [1, {h}, {s}, {d}]: A {mean['A']:.4f} ms, "
              f"B {mean['B']:.4f} ms (turns A B B A: {_turns(each)})")
        del q3, k3, v3, do3, out, lse, delta, call
        torch.cuda.empty_cache()
    if "paged" in rows:
        _ab_paged(dev, gen, versions)
    if "norm" in rows:
        _ab_norm(dev, gen, versions)
    if "masked" in rows:
        _ab_masked(dev, gen, versions)
    if "fused" in rows:
        _ab_fused(dev, seed, gen, versions)
    if "md" in rows:
        _ab_md(dev, seed, gen, versions)
    if "wide" in rows:
        _ab_wide(dev, seed, gen, versions)
    if "wide_paged" in rows:
        _ab_wide_paged(dev, seed, gen, versions)
    if "partial" in rows:
        _ab_partial(dev, seed, gen, versions)
    if "steps" not in rows:
        return
    _ab_decode_step(dev, seed, versions)
    for seq in (TRAIN_SEQ, SPLIT_SEQ):
        cfg, model, tx, state, batch, train_step = _train_setup(
            dev, seed, TRAIN_LAYERS, None, "dynamic", seq)
        step = train_step.make_train_step(_train_loss, tx)
        box = {"state": step(state, batch)[0]}
        del state

        def steps():
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                box["state"], _ = step(box["state"], batch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t1)
            return float(np.median(times))

        mean, each = _ab(versions, steps, "ABBAABBA")
        print(f"  adam step, {TRAIN_LAYERS} layers, {seq} tokens: A "
              f"{mean['A']:.4f} s, B {mean['B']:.4f} s (turns A B B A A B "
              f"B A, medians of 3 steps: A "
              f"{[round(x, 5) for x in each['A']]}, B "
              f"{[round(x, 5) for x in each['B']]})")
        del model, box, step, batch
        torch.cuda.empty_cache()


def _rel_l2(got, ref) -> float:
    return ((got.float() - ref.float()).norm() / ref.float().norm()).item()


def _ab_md(dev, seed: int, gen, versions):
    """The mask and dropout instances' A/B at the training paths' shapes
    (:func:`_md_shapes`, rate 0.1): the controls #3d and #3md (the
    forward with dropout, each version through its own ``_fwd``, the
    pre-pass included), #4d and #4md (the one-pass backward, each version
    through its own ``_bwd``: delta, dq scratch, pre-pass, kernel, cast)
    and, at BERT's shape, #3m (the masked forward without dropout), each
    version held against the plain version (the forward's rows within
    2^-6 of their max and lse within 1e-3; the backward's outputs within
    the flash backward's relative L2 and each row within 2^-6 of its max)
    and against the other version; then the controls #3 and #4 at causal
    [1, 32, 2048, 128] and #5 and #6 at causal [1, 32, 8192, 128]; the
    subjects #5md and #6md (each version's own ``_dq_kernel`` and
    ``_dkv_kernel``, each with its pre-pass) and the split route (its own
    ``_bwd``) at causal [1, 32, 8192, 128] with a per-head mask and
    dropout and at ``gpt_train_8k``'s causal [1, 16, 8192, 128] with
    dropout (B's first four heads against the plain version); then the
    ``gpt_train``, ``bert_train`` and ``gpt_train_8k`` steps at full depth
    (:func:`_ab_lm_steps`)."""
    attn = importlib.import_module("apex_tpu_torch.ops.attention")
    rate = LM_DROPOUT
    seed3 = attn._seed_operand(-2 ** 31 + 12345, device=dev)
    for (tag, label, q3, k3, v3, do3, mask3, causal, _mb, _live,
         h) in _md_shapes(dev, gen):
        bh, s, d = q3.shape
        scale = d ** -0.5
        md = dict(mask3=mask3, rate=rate, seed3=seed3)
        step = 16 if tag == "gpt" else bh

        def m3(sl):
            return None if mask3 is None else mask3[sl.start // h:
                                                    sl.stop // h]

        out, lse = attn._fwd(q3, k3, v3, causal, scale, **md)
        ref_f = _by_heads(lambda sl: attn._fwd_reference(
            q3[sl], k3[sl], v3[sl], causal, scale, mask3=m3(sl), rate=rate,
            seed3=seed3, bh0=sl.start), bh, step)
        ref_b = _by_heads(lambda sl: attn._bwd_reference(
            q3[sl], k3[sl], v3[sl], out[sl], lse[sl], do3[sl], causal, scale,
            mask3=m3(sl), rate=rate, seed3=seed3, bh0=sl.start), bh, step)
        sfx = "md" if mask3 is not None else "d"
        calls = (("3" + sfx, lambda: attn._fwd(q3, k3, v3, causal, scale,
                                               **md)),
                 ("4" + sfx, lambda: attn._bwd(q3, k3, v3, out, lse, do3,
                                               causal, scale, **md)))
        if mask3 is not None:
            ref_m = _by_heads(lambda sl: attn._fwd_reference(
                q3[sl], k3[sl], v3[sl], causal, scale, mask3=m3(sl)), bh,
                step)
            calls += (("3m", lambda: attn._fwd(q3, k3, v3, causal, scale,
                                               mask3=mask3)),)
        for row, call in calls:
            got = {}
            for turn in "AB":
                with _as_version(versions[turn]):
                    got[turn] = call()
            torch.cuda.synchronize()
            if row.startswith("3"):
                ref_ = ref_m if row == "3m" else ref_f
                errs = [_slot_rel(got[t][0].reshape(-1, d),
                                  ref_[0].reshape(-1, d)) for t in "AB"]
                lse_err = max((got[t][1] - ref_[1]).abs().max().item()
                              for t in "AB")
                ok = max(errs) <= TOL_PAGED_OUT and lse_err <= TOL_ATTN_LSE
                detail = (f"each row's max|diff| / max|ref| A {errs[0]:.3e}, "
                          f"B {errs[1]:.3e}; lse max|diff| {lse_err:.3e}")
            else:
                rel = {t: [_rel_l2(g_, r_) for g_, r_ in zip(got[t], ref_b)]
                       for t in "AB"}
                rows_ = {t: max(_slot_rel(g_.reshape(-1, d),
                                          r_.reshape(-1, d))
                                for g_, r_ in zip(got[t], ref_b))
                         for t in "AB"}
                ab = [_rel_l2(b_, a_) for a_, b_ in zip(got["A"], got["B"])]
                ok = (max(rel["A"] + rel["B"] + ab) <= TOL_FLASH_BWD_REL_L2
                      and max(rows_.values()) <= TOL_PAGED_OUT)
                detail = (f"relative L2 of dq, dk, dv against the plain "
                          f"version A {[f'{r:.3e}' for r in rel['A']]}, B "
                          f"{[f'{r:.3e}' for r in rel['B']]}, B against A "
                          f"{[f'{r:.3e}' for r in ab]}; each row's max|diff| "
                          f"/ max|ref| A {rows_['A']:.3e}, B {rows_['B']:.3e}")
            print(f"  #{row} ({tag}, {label}): {detail}")
            if not ok:
                raise AssertionError(f"ab: #{row} ({tag}) is off")
            del got
            mean, each = _ab(versions, lambda: _time_ms(call, 10))
            what = "without dropout" if row == "3m" else f"dropout {rate}"
            print(f"  #{row} ({tag}) {what}: A {mean['A']:.4f} ms, B "
                  f"{mean['B']:.4f} ms (turns A B B A: {_turns(each)})")
        del q3, k3, v3, do3, out, lse, ref_f, ref_b, mask3, calls
        if sfx == "md":
            del ref_m
        torch.cuda.empty_cache()
    bf = torch.bfloat16
    # the controls #3 and #4 at causal [1, 32, 2048, 128], #5 and #6 at
    # causal [1, 32, 8192, 128] (no mask, no dropout); the subjects #5md,
    # #6md (each kernel called alone: its own pre-pass) and the split
    # route (_bwd: delta, one pre-pass, both kernels) at the kernels
    # phase's shape (a per-head mask, dropout) and at gpt_train_8k's
    # (causal [1, 16, 8192, 128], dropout)
    for tag, bh, s, masked, dropped in (
            ("#4", 32, TRAIN_SEQ, False, False),
            ("#5, #6", 32, SPLIT_SEQ, False, False),
            ("md", 32, SPLIT_SEQ, True, True),
            ("d", GPT_CFG["num_attention_heads"], GPT8K_TRAIN_SEQ, False,
             True)):
        d = 128
        scale = d ** -0.5
        q3, k3, v3, do3 = (torch.randn(bh, s, d, generator=gen, device=dev)
                           .to(bf) for _ in range(4))
        mask3, md = None, {}
        if masked:
            mask3 = torch.rand(bh, s, s, generator=gen, device=dev) < 0.1
            mask3[:, 5] = True
        if dropped:
            md = dict(mask3=mask3, rate=rate, seed3=seed3)
        out, lse = attn._fwd(q3, k3, v3, True, scale, **md)
        delta = attn._delta(out, do3)
        args = (q3, k3, v3, lse, delta, do3, True, scale)
        shape = (f"causal [1, {bh}, {s}, {d}]"
                 + (", a per-head mask" if masked else "")
                 + (f", dropout {rate}" if dropped else ""))
        if tag == "#4":
            def fwd():
                return attn._fwd(q3, k3, v3, True, scale)

            got = {}
            for turn in "AB":
                with _as_version(versions[turn]):
                    got[turn] = fwd()
            torch.cuda.synchronize()
            err = [(got["A"][0].float() - got["B"][0].float()).abs().max()
                   .item(), (got["A"][1] - got["B"][1]).abs().max().item()]
            print(f"  #3 {shape}: B against A max|diff| out {err[0]:.3e}, "
                  f"lse {err[1]:.3e}")
            if err[0] > TOL_ATTN_OUT or err[1] > TOL_ATTN_LSE:
                raise AssertionError("ab: #3 differs between the versions")
            mean, each = _ab(versions, lambda: _time_ms(fwd, 10))
            print(f"  #3 {shape}: A {mean['A']:.4f} ms, B {mean['B']:.4f} "
                  f"ms (turns A B B A: {_turns(each)})")
            calls = (("#4", lambda: attn._bwd(q3, k3, v3, out, lse, do3,
                                              True, scale)),)
        elif tag == "#5, #6":
            calls = (("#5", lambda: (attn._dq_kernel(*args),)),
                     ("#6", lambda: attn._dkv_kernel(*args)))
        else:
            calls = (("#5" + tag, lambda: (attn._dq_kernel(*args, **md),)),
                     ("#6" + tag, lambda: attn._dkv_kernel(*args, **md)),
                     ("the split route " + tag, lambda: attn._bwd(
                         q3, k3, v3, out, lse, do3, True, scale, **md)))
        for row, call in calls:
            got = {}
            for turn in "AB":
                with _as_version(versions[turn]):
                    got[turn] = call()
            torch.cuda.synchronize()
            ab = [_rel_l2(b_, a_) for a_, b_ in zip(got["A"], got["B"])]
            same = [torch.equal(a_, b_) for a_, b_ in zip(got["A"], got["B"])]
            detail = ""
            if dropped:
                sl = slice(0, 4)
                part = tuple(t[sl] for t in args[:6]) + args[6:]
                kw = dict(mask3=None if mask3 is None else mask3[sl],
                          rate=rate, seed3=seed3)
                ref = ()
                if not row.startswith("#6"):
                    ref += (attn._dq_reference(*part, **kw),)
                if not row.startswith("#5"):
                    ref += attn._dkv_reference(*part, **kw)
                plain = [_rel_l2(g_[sl], r_) for g_, r_ in zip(got["B"], ref)]
                detail = (f"; B's first 4 heads against the plain version "
                          f"{[f'{r:.3e}' for r in plain]}")
                ab += plain
                del ref
            print(f"  {row} {shape}: B against A relative L2 "
                  f"{[f'{r:.3e}' for r in ab[:len(same)]]}, bit-identical "
                  f"{same}{detail}")
            if max(ab) > TOL_FLASH_BWD_REL_L2:
                raise AssertionError(f"ab: {row} differs between the "
                                     f"versions or from its plain version")
            del got
            mean, each = _ab(versions, lambda: _time_ms(
                call, 10 if s == TRAIN_SEQ else 4))
            print(f"  {row} {shape}: A {mean['A']:.4f} ms, B "
                  f"{mean['B']:.4f} ms (turns A B B A: {_turns(each)})")
        del q3, k3, v3, do3, out, lse, delta, md, calls, args, mask3
        torch.cuda.empty_cache()
    for kind in ("gpt", "bert", "gpt8k"):
        _ab_lm_steps(dev, seed, kind, versions)


def _ab_lm_steps(dev, seed: int, kind: str, versions):
    """The ``gpt_train`` / ``bert_train`` / ``gpt_train_8k`` step (full
    depth, dropout 0.1, the phase's batch and optimizer) under each
    version: each version's step must launch the phase's flash instances
    once a layer and no other flash kernel; then eight turns A B B A A B
    B A of three steps, each turn's median."""
    from apex_tpu_torch import train_step
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.optimizers import functional
    cfg, model = _lm_model(kind, dev, seed)
    batch = _lm_batch(kind, cfg, dev, seed)
    bert = kind.startswith("bert")
    tx = functional.fused_lamb(**LAMB_KW) if bert \
        else functional.fused_adam(lr=TRAIN_LR)
    box = {"state": train_step.init_train_state(tx, model,
                                                loss_scale="dynamic"),
           "i": 0}
    step = train_step.make_train_step(_bert_loss if bert else _gpt_loss, tx)
    phase, kernels, _, _ = _LM_ALL[kind]
    want = dict.fromkeys(kernels, cfg.num_layers)

    def one():
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed * 1000 + box["i"])
        box["i"] += 1
        box["state"], loss = step(box["state"], dict(batch, generator=gen))
        return loss

    for turn in "AB":
        with _as_version(versions[turn]):
            before = _build.launch_counts()
            loss = one().item()
            flash = {k: v - before[k]
                     for k, v in _build.launch_counts().items()
                     if k.startswith("flash_attention") and v != before[k]}
        print(f"  {phase} step ({turn}): loss {loss:.4f}, flash "
              f"launches {flash}")
        if flash != want or not np.isfinite(loss):
            raise AssertionError(f"ab: the {phase} step ({turn}) "
                                 f"launched {flash}, loss {loss}")

    def steps():
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            one()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
        return float(np.median(times))

    mean, each = _ab(versions, steps, "ABBAABBA")
    print(f"  {phase} step, {cfg.num_layers} layers: A {mean['A']:.4f} "
          f"s, B {mean['B']:.4f} s (turns A B B A A B B A, medians of 3 "
          f"steps: A {[round(x, 5) for x in each['A']]}, B "
          f"{[round(x, 5) for x in each['B']]})")
    del model, box, step, batch
    torch.cuda.empty_cache()


def _ab_wide(dev, seed: int, gen, versions):
    """The wide flash kernels' A/B (#3w, #5w, #6w, each version through
    its own ``_fwd_wide``, ``_dq_wide`` and ``_dkv_wide``: B's fp32 calls
    with their split into planes) at every :func:`_wide_flash_shapes`
    shape: both versions' out and lse against the plain version, and
    both versions' dq, dk and dv from B's out and lse against the plain
    ones on those (fp32 within TOL_WIDE_OUT and TOL_WIDE_GRAD of
    max|ref|, 16-bit as :func:`_wide_rows` holds them) and against each
    other; then each timed in turns A B B A; then the ``width gpt fp32
    train`` step, GPT-3 1.3B at fp32 parameters (:func:`_ab_lm_steps`)."""
    attn = importlib.import_module("apex_tpu_torch.ops.attention")
    seed3 = attn._seed_operand(-2 ** 31 + 777, device=dev)
    for tag, dt, b, h, s, d, causal, masked, rate in _wide_flash_shapes():
        bh, scale, fp32 = b * h, d ** -0.5, dt == torch.float32
        q3, k3, v3, do3, mask3, _, _, md, step = _wide_inputs(
            dev, gen, seed3, dt, b, h, s, d, masked, rate)

        def sl_kw(sl):
            return dict(mask3=None if mask3 is None else
                        mask3[sl.start // h:sl.stop // h], rate=rate,
                        seed3=seed3, bh0=sl.start)

        fwd = {}
        for turn in "AB":
            with _as_version(versions[turn]):
                fwd[turn] = attn._fwd_wide(q3, k3, v3, causal, scale, **md)
        out, lse = fwd["B"]
        delta = attn._delta(out, do3)
        args = (q3, k3, v3, lse, delta, do3, causal, scale)
        dq, dkv = {}, {}
        for turn in "AB":
            with _as_version(versions[turn]):
                dq[turn] = attn._dq_wide(*args, **md)
                dkv[turn] = attn._dkv_wide(*args, **md)
        ref_out, ref_lse = _by_heads(lambda sl: attn._fwd_reference(
            q3[sl], k3[sl], v3[sl], causal, scale, **sl_kw(sl)), bh, step)
        ref_dq = _by_heads(lambda sl: attn._dq_reference(
            q3[sl], k3[sl], v3[sl], lse[sl], delta[sl], do3[sl], causal,
            scale, **sl_kw(sl)), bh, step)
        ref_dkv = _by_heads(lambda sl: attn._dkv_reference(
            q3[sl], k3[sl], v3[sl], lse[sl], delta[sl], do3[sl], causal,
            scale, **sl_kw(sl)), bh, step)
        label = (f"{'padding' if masked else 'causal'} [{b}, {h}, {s}, {d}] "
                 f"{str(dt).replace('torch.', '')}"
                 + (f", dropout {rate}" if rate else ""))
        print(f"  wide ({tag}: {label}):")
        livel = ref_lse > -1e29
        for turn in "AB":
            o_, l_ = fwd[turn]
            err_o = (o_.float() - ref_out.float()).abs().max().item()
            err_l = (l_ - ref_lse)[livel].abs().max().item()
            err_q = (dq[turn].float() - ref_dq.float()).abs().max().item()
            if fp32:
                _check(f"{turn} #3w out", err_o,
                       TOL_WIDE_OUT * ref_out.abs().max().item())
                _check(f"{turn} #3w lse", err_l,
                       TOL_WIDE_OUT * ref_lse[livel].abs().max().item())
                _check(f"{turn} #5w dq", err_q,
                       TOL_WIDE_GRAD * ref_dq.abs().max().item())
            else:
                _check(f"{turn} #3w out", err_o, TOL_ATTN_OUT)
                _check(f"{turn} #3w lse", err_l, TOL_ATTN_LSE)
                _check(f"{turn} #5w dq relative L2", _rel_l2(dq[turn], ref_dq),
                       TOL_FLASH_BWD_REL_L2)
                _check(f"{turn} #5w dq (x each row's max|ref|, at least "
                       f"1e-3 of the output's)", _row_rel(dq[turn], ref_dq),
                       TOL_PAGED_OUT)
            _wide_grads_check(f"{turn} #6w", dkv[turn], ref_dkv, fp32,
                              ("dk", "dv"))
            if not torch.equal(l_ > -1e29, livel):
                raise AssertionError(f"ab wide {tag}: {turn}'s fully masked "
                                     f"rows differ")
        dkv_diff = max((a_.float() - b_.float()).abs().max().item()
                       for a_, b_ in zip(dkv["A"], dkv["B"]))
        print(f"    B against A max|diff|: out "
              f"{(fwd['A'][0].float() - out.float()).abs().max().item():.3e}"
              f", lse {(fwd['A'][1] - lse)[livel].abs().max().item():.3e}, "
              f"dq {(dq['A'].float() - dq['B'].float()).abs().max().item():.3e}"
              f", dk/dv {dkv_diff:.3e}")
        del fwd, dq, dkv, ref_out, ref_lse, ref_dq, ref_dkv
        iters = 3 if s > 4096 else 10
        for row, fn in (("#3w", lambda: attn._fwd_wide(q3, k3, v3, causal,
                                                       scale, **md)),
                        ("#5w", lambda: attn._dq_wide(*args, **md)),
                        ("#6w", lambda: attn._dkv_wide(*args, **md))):
            mean, each = _ab(versions, lambda: _time_ms(fn, iters))
            print(f"    {row} on {_smi()}: A {mean['A']:.4f} ms, B "
                  f"{mean['B']:.4f} ms, B/A {mean['B'] / mean['A']:.3f} "
                  f"(turns A B B A: {_turns(each)})")
        del q3, k3, v3, do3, out, lse, delta, args, mask3
        torch.cuda.empty_cache()
    _ab_lm_steps(dev, seed, "gpt_fp32", versions)


def _ab_wide_paged(dev, seed: int, gen, versions):
    """#7w's A/B at every :func:`_wide_paged_cases` row (each version
    through its own ``_wide_call``): both against the plain version
    (fp32 within TOL_WIDE_OUT, 16-bit TOL_PAGED_OUT of each slot's max),
    then timed over four layers in turn, A B B A; then #7
    (:func:`_ab_paged`: the kernels phase's and the serve's lengths, the
    same bits from both versions) and the dense decode's kernel
    (``decode_attention``'s branch at Llama-3-8B's dense decode, the
    same bits); then the ``width`` serves' unfused decode steps, GPT-3
    1.3B on an fp32 pool and GPT-3 2.7B on a bf16 one (:func:`_ab_steps`,
    #7w once a layer)."""
    from apex_tpu_torch.inference import InferenceEngine
    from apex_tpu_torch.transformer.testing import GPTConfig
    pa = importlib.import_module("apex_tpu_torch.ops.paged_attention")
    attn = importlib.import_module("apex_tpu_torch.ops.attention")
    for tag, dt, kvh, group, d, ps, lengths_l in _wide_paged_cases():
        q, views, table, lengths = _wide_paged_inputs(
            dev, gen, dt, kvh, group, d, ps, lengths_l)

        def call(kp, vp):
            return pa.paged_decode_attention(q, kp, vp, table, lengths)

        got = {}
        for turn in "AB":
            with _as_version(versions[turn]):
                got[turn] = call(*views[0])
        ref = pa.paged_decode_reference(q, *views[0], table, lengths,
                                        d ** -0.5)
        errs = [_slot_rel(got[t], ref) for t in "AB"]
        tol = TOL_WIDE_OUT if dt == torch.float32 else TOL_PAGED_OUT
        print(f"  #7w {tag} ({_wide_paged_mode(pa, *views[0])} in B): "
              f"against the plain version max|diff| / the slot's max|ref| "
              f"A {errs[0]:.3e}, B {errs[1]:.3e}; B against A max|diff| "
              f"{(got['A'].float() - got['B'].float()).abs().max().item():.3e}")
        if max(errs) > tol:
            raise AssertionError(f"ab: #7w ({tag}) is off its plain version")
        cyc = itertools.cycle(views)
        mean, each = _ab(versions, lambda: _time_ms(
            lambda: call(*next(cyc)), 48))
        print(f"  #7w {tag} on {_smi()}: A {mean['A']:.5f} ms, B "
              f"{mean['B']:.5f} ms, B/A {mean['B'] / mean['A']:.3f} (turns "
              f"A B B A: {_turns(each)})")
        del q, views, got, ref, cyc
        torch.cuda.empty_cache()
    _ab_paged(dev, gen, versions)
    q, k, v, lengths, nbytes, flops = _decode_case(dev, gen)

    def branch():
        return attn.decode_attention(q, k, v, lengths, use_kernel=True)

    got = {}
    for turn in "AB":
        with _as_version(versions[turn]):
            got[turn] = branch()
    torch.cuda.synchronize()
    if not torch.equal(got["A"], got["B"]):
        raise AssertionError("ab: the dense decode's bits differ")
    mean, each = _ab(versions, lambda: _time_ms(branch, 20))
    print(f"  dense decode kernel (DENSE) [{q.shape[0]}, {q.shape[1]}, 1, "
          f"{k.shape[2]}]: the same bits from A and B; A {mean['A']:.4f} ms,"
          f" B {mean['B']:.4f} ms (turns A B B A: {_turns(each)})")
    del q, k, v, got
    torch.cuda.empty_cache()
    for label, cfg_kw, dtype in (
            ("width gpt fp32 serve decode step", GPT_CFG, torch.float32),
            ("width gpt27 serve decode step", GPT27_CFG, torch.bfloat16)):
        cfg = GPTConfig(**cfg_kw)
        engine = InferenceEngine(
            "gpt", cfg, _random_gpt(cfg, dev, seed + 10, dtype=dtype),
            slots=8, max_seq=cfg.max_seq_length, device=dev, page_size=64,
            cache_dtype=dtype, decode_fusion="0")
        _ab_steps(label, engine, GPT_PROMPT_LENS, seed, versions,
                  "paged_attention_wide")
        del engine
        torch.cuda.empty_cache()


def _paged_table(dev, gen, lengths_l, ps: int, mpps: int):
    """A page table for the lengths over a pool of ``len(lengths) *
    mpps`` pages (and the trash page after them), pages shuffled."""
    slots = len(lengths_l)
    n_pages = slots * mpps
    perm = torch.randperm(n_pages, generator=gen, device=dev).to(torch.int32)
    table = torch.full((slots, mpps), n_pages, dtype=torch.int32, device=dev)
    cursor = 0
    for i, n in enumerate(lengths_l):
        need = min(-(-n // ps), mpps)
        table[i, :need] = perm[cursor:cursor + need]
        cursor += need
    return table, torch.tensor(lengths_l, dtype=torch.int32, device=dev)


def _ab_paged(dev, gen, versions):
    """#7 A/B: 8 slots of a 32-layer pool (page 64, window 4096), timed
    over 4 layers in turn as the kernels phase times it, at the kernels
    phase's lengths and at the serve's (each prompt plus its 32 new
    tokens)."""
    pa = importlib.import_module("apex_tpu_torch.ops.paged_attention")
    bf = torch.bfloat16
    slots, layers, h, kvh, ps, mpps, d = 8, 32, 32, 8, 64, 64, 128
    scale = d ** -0.5
    shape = (slots * mpps + 1, layers, kvh, ps, d)
    pool_k = torch.randn(shape, generator=gen, device=dev).to(bf)
    pool_v = torch.randn(shape, generator=gen, device=dev).to(bf)
    qd = torch.randn(slots, h, d, generator=gen, device=dev).to(bf)
    views = [(pool_k[:, i], pool_v[:, i]) for i in range(4)]
    for label, lengths_l in (
            ("kernels-phase lengths", [0, 1, 64, 65, 1500, 2048, 3000,
                                       4096]),
            ("serve lengths", [n + NEW_TOKENS for n in PROMPT_LENS])):
        table, lengths = _paged_table(dev, gen, lengths_l, ps, mpps)

        def call(kp, vp):
            return pa.paged_decode_attention(qd, kp, vp, table, lengths)

        got = {}
        for turn in "AB":
            with _as_version(versions[turn]):
                got[turn] = call(*views[0])
        ref = pa.paged_decode_reference(qd, *views[0], table, lengths, scale)
        errs = [_slot_rel(got[t], ref) for t in "AB"]
        ab_err = (got["A"].float() - got["B"].float()).abs().max().item()
        print(f"  paged_decode_attention 8 slots, {label} {lengths_l}: "
              f"against the plain version max|diff| / the slot's max|ref| "
              f"A {errs[0]:.3e}, B {errs[1]:.3e}; B against A max|diff| "
              f"{ab_err:.3e}")
        if max(errs) > TOL_PAGED_OUT:
            raise AssertionError(f"ab: paged decode ({label}) is off its "
                                 f"plain version")
        if not torch.equal(got["A"], got["B"]):
            raise AssertionError(f"ab: #7's bits ({label}) differ between "
                                 f"the versions")
        live = sum(lengths_l)
        bound, by = _bound(live * kvh * d * 2 * 2 + 2 * qd.numel() * 2
                           + table.numel() * 4 + slots * 4,
                           4 * live * h * d)
        cyc = itertools.cycle(views)
        mean, each = _ab(versions, lambda: _time_ms(
            lambda: call(*next(cyc)), 48))
        print(f"  paged_decode_attention 8 slots, {label}: A "
              f"{mean['A']:.5f} ms, B {mean['B']:.5f} ms, bound "
              f"{bound:.5f} ms ({by}) (turns A B B A: {_turns(each)})")
        # the wrapper's host cost with it: eager calls, as a decode step
        # makes them
        mean, each = _ab(versions, lambda: _eager_ms(
            lambda: call(*next(cyc)), 50))
        print(f"  paged_decode_attention 8 slots, {label}, eager calls "
              f"(host included): A {mean['A']:.5f} ms, B {mean['B']:.5f} "
              f"ms (turns A B B A: {_turns(each)})")
    del pool_k, pool_v, views
    torch.cuda.empty_cache()


def _ab_norm(dev, gen, versions):
    """#2 A/B at [2048, 4096] and [8192, 4096] (the two training steps'
    rows) bf16 with an fp32 weight, RMSNorm and LayerNorm: one input
    timed again and again (as the kernels phase times it; at 2048 rows
    x and dy, 33.5 MB, stay in the 50 MB L2) and three inputs in turn
    (read from device memory as a training step does)."""
    ln = importlib.import_module("apex_tpu_torch.ops.layer_norm")
    hidden = 4096
    w = 1 + 0.1 * torch.randn(hidden, generator=gen, device=dev)
    for rows in (TRAIN_SEQ, SPLIT_SEQ):
        _ab_norm_rows(ln, dev, gen, versions, rows, w)


def _ab_norm_rows(ln, dev, gen, versions, rows, w):
    hidden = w.numel()
    shape = f"[{rows}, {hidden}]"
    ins = [(torch.randn(rows, hidden, generator=gen, device=dev)
            .to(torch.bfloat16),
            torch.randn(rows, hidden, generator=gen, device=dev)
            .to(torch.bfloat16)) for _ in range(3)]
    bound, by = _bound(3 * rows * hidden * 2 + 2 * hidden * 4,
                       10 * rows * hidden, FP32_FLOPS_PER_S)
    for rms in (True, False):
        label = "rms_norm" if rms else "layer_norm"
        x, dy = ins[0]
        got = {}
        for turn in "AB":
            with _as_version(versions[turn]):
                got[turn] = ln._bwd_2d(x, w, dy, 1e-5, rms)
        ref = ln._bwd_reference(x, w, dy, 1e-5, rms)
        for t in "AB":
            dx, dw, db = got[t]
            errs = [(dx.float() - ref[0].float()).abs().max().item()
                    / ref[0].float().abs().max().item(),
                    (dw - ref[1]).abs().max().item()
                    / ref[1].abs().max().item()]
            if not rms:
                errs.append((db - ref[2]).abs().max().item()
                            / ref[2].abs().max().item())
            print(f"  {label} bwd {shape} {t}: against the plain "
                  f"version max|diff| / max|ref| dx, dw(, db) "
                  f"{[f'{e:.3e}' for e in errs]}")
            if errs[0] > TOL_RMS_REL or max(errs[1:]) > TOL_NORM_DW_REL:
                raise AssertionError(f"ab: {label} bwd ({t}) is off its "
                                     f"plain version")
        del got, ref
        for how, fn in (
                ("one input", lambda: ln._bwd_2d(x, w, dy, 1e-5, rms)),
                ("3 inputs in turn", lambda: ln._bwd_2d(
                    *next(cyc_in), 1e-5, rms))):
            cyc_in = itertools.cycle([(a, w, b) for a, b in ins])
            mean, each = _ab(versions, lambda: _time_ms(fn, 48))
            print(f"  {label} bwd {shape} bf16, fp32 weight, {how}: A "
                  f"{mean['A']:.5f} ms, B {mean['B']:.5f} ms, bound "
                  f"{bound:.5f} ms ({by}) (turns A B B A: {_turns(each)})")
    del ins
    torch.cuda.empty_cache()


def _ab_decode_step(dev, seed: int, versions):
    """The unfused 8-slot Llama-3-8B decode step (32 layers, the serve's
    prompts prefilled once): each version's step must launch #7 once per
    layer."""
    from apex_tpu_torch.inference import InferenceEngine
    from apex_tpu_torch.transformer.testing import LlamaConfig
    cfg = LlamaConfig(**FULL_CFG)
    engine = InferenceEngine("llama", cfg, _random_llama(cfg, dev, seed),
                             slots=8, max_seq=4096, page_size=64,
                             num_pages=512, device=dev)
    _ab_steps("unfused decode step, 8 slots, Llama-3-8B", engine,
              PROMPT_LENS, seed, versions, "paged_attention")
    del engine
    torch.cuda.empty_cache()


def _ab_steps(label, engine, prompt_lens, seed: int, versions,
              kernel: str):
    """A decode step of ``engine`` (prompts of ``prompt_lens`` prefilled
    once), eight steps a turn, sixteen turns A B B A A B B A ...: the
    mean of a version's turn medians and the median of all its steps;
    each version's step must launch ``kernel`` once per layer."""
    from apex_tpu_torch.ops import _build
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, engine.cfg.vocab_size, size=n).tolist()
               for n in prompt_lens]
    cache = engine.init_cache()
    alloc = engine.new_allocator() if engine.paged else None
    last = np.zeros((engine.slots,), np.int32)
    for slot, p in enumerate(prompts):
        kw = {}
        if alloc is not None:
            kw["pages"] = alloc.acquire(alloc.pages_needed(len(p) + 256))
        cache, tok, _ = engine.prefill(cache, p, slot, **kw)
        last[slot] = int(tok)
    state = {"cache": cache, "last": last}
    layers = engine.cfg.num_layers

    def step():
        c, nxt, _, _ = engine.decode(state["cache"], state["last"])
        state["cache"], state["last"] = c, nxt.numpy()

    for turn in "AB":
        with _as_version(versions[turn]):
            _build.reset_launch_counts()
            step()
            n = _build.launch_counts()[kernel]
            for _ in range(4):              # warm-up off the clock
                step()
        if n != layers:
            raise AssertionError(f"ab: {label} ({turn}) launched {kernel} "
                                 f"{n} times")

    # the step is host-bound and its host time drifts: four rounds of
    # turns, each turn's median, and the median of every step
    every = {"A": [], "B": []}

    def steps():
        times = []
        for _ in range(8):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
        every["B" if _build._LIB is versions["B"].lib else "A"] += times
        return float(np.median(times))

    mean, each = _ab(versions, steps, "ABBA" * 4)
    print(f"  {label}: A {mean['A']:.3f} ms, B {mean['B']:.3f} ms (mean of "
          f"8 turn medians of 8 steps; median of all 64 steps A "
          f"{np.median(every['A']):.3f}, B {np.median(every['B']):.3f}; "
          f"{engine.slots / np.median(every['A']) * 1e3:.1f} / "
          f"{engine.slots / np.median(every['B']) * 1e3:.1f} decode "
          f"tokens/s; turns A {[round(x, 3) for x in each['A']]}, B "
          f"{[round(x, 3) for x in each['B']]})")
    del state, cache


def _ab_masked(dev, gen, versions):
    """#3m A/B at its three shapes (``_fwd`` on the mask3; the baseline's
    own ``_fwd`` while its library is in), then ``decode_attention``'s
    whole kernel branch at Llama-3-8B's dense decode: the baseline's
    broadcast, mask and kernel against this tree's decode kernel, with
    each version's peak memory rise over one call."""
    attn = importlib.import_module("apex_tpu_torch.ops.attention")
    for (label, q, k, v, mask, causal, iters, nbytes,
         flops) in _masked_shapes(dev, gen):
        b, h, sq, d = q.shape
        sk = k.shape[2]
        mask3 = attn._mask3(mask, b, h, sq, sk)
        q3, k3, v3 = (t.reshape(b * h, -1, d).contiguous()
                      for t in (q, k, v))
        scale = d ** -0.5

        def call():
            return attn._fwd(q3, k3, v3, causal, scale, mask3=mask3)

        got = {}
        for turn in "AB":
            with _as_version(versions[turn]):
                got[turn] = call()
        ref, _ = attn._fwd_reference(q3, k3, v3, causal, scale, mask3=mask3)
        rows = (lambda t: t.reshape(-1, d))
        errs = [_slot_rel(rows(got[t][0]), rows(ref)) for t in "AB"]
        lse_err = (got["A"][1] - got["B"][1]).abs().max().item()
        print(f"  flash_attention masked {label} [{b}, {h}, {sq}, {sk}]: "
              f"against the plain version, each row's max|diff| / max|ref| "
              f"A {errs[0]:.3e}, B {errs[1]:.3e}; B against A lse "
              f"{lse_err:.3e}")
        if max(errs) > TOL_PAGED_OUT or lse_err > TOL_ATTN_LSE:
            raise AssertionError(f"ab: masked flash ({label}) is off")
        del got, ref
        bound, by = _bound(nbytes, flops)
        mean, each = _ab(versions, lambda: _time_ms(call, iters))
        print(f"  flash_attention masked {label}: A {mean['A']:.4f} ms, B "
              f"{mean['B']:.4f} ms, bound {bound:.4f} ms ({by}) (turns A B "
              f"B A: {_turns(each)})")
        del q, k, v, mask, mask3, q3, k3, v3
    torch.cuda.empty_cache()
    q, k, v, lengths, nbytes, flops = _decode_case(dev, gen)
    b, h, _, d = q.shape
    kvh = k.shape[1]

    def branch():
        return attn.decode_attention(q, k, v, lengths, use_kernel=True)

    ref = attn._decode_reference(q.reshape(b, kvh, h // kvh, d), k, v,
                                 lengths, d ** -0.5)
    for turn in "AB":
        with _as_version(versions[turn]):
            branch()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.memory_allocated()
            got = branch()
            torch.cuda.synchronize()
            rise = torch.cuda.max_memory_allocated() - start
        rel = _slot_rel(got.reshape(-1, d), ref.reshape(-1, d))
        print(f"  decode_attention kernel branch [{b}, {h}, 1, "
              f"{k.shape[2]}] ({turn}): each row's max|diff| / max|ref| "
              f"{rel:.3e}; peak memory rise over the call "
              f"{rise / 2 ** 20:.2f} MiB")
        if rel > TOL_PAGED_OUT:
            raise AssertionError(f"ab: the decode branch ({turn}) is off")
    bound, by = _bound(nbytes, flops)
    mean, each = _ab(versions, lambda: _time_ms(branch, 20))
    print(f"  decode_attention kernel branch: A {mean['A']:.4f} ms, B "
          f"{mean['B']:.4f} ms, bound {bound:.4f} ms ({by}: the cache's live "
          f"k/v) (turns A B B A: {_turns(each)})")
    del q, k, v, ref, got
    torch.cuda.empty_cache()


def _ab_partial(dev, seed: int, gen, versions):
    """V6 A/B: the fused block's rank-partial instances (8p, 8gp) on rank
    0 of a tp = 2 and a tp = 4 shard of one Llama-3-8B layer (8 slots,
    lengths 0..4096, page 64) and of one GPT-3 1.3B layer (lengths
    0..2048), cut as the engine cuts them (``fused_partition_specs``,
    ``shard_tree``) over a 4-layer pool of the rank's kv heads: each
    version against the plain version, its time over the 4 layers in
    turn (40 queued calls a turn, A B B A) beside the bound (the shard's
    weights and its heads' live k/v once), and its phase clock (median
    of 10 launches)."""
    from apex_tpu_torch.inference import models
    from apex_tpu_torch.transformer.testing import GPTConfig, LlamaConfig
    from apex_tpu_torch.transformer.testing.standalone_llama import (
        _rope_cos_sin)
    pa = importlib.import_module("apex_tpu_torch.ops.paged_attention")
    bf = torch.bfloat16
    slots, ps, layers = 8, 64, 4
    for kind in ("llama", "gpt"):
        if kind == "llama":
            cfg = LlamaConfig(**dict(FULL_CFG, num_layers=1))
            tree = {"layer_0": _random_llama(cfg, dev, seed, only="layer_0")[
                "layer_0"]}
            lengths_l, mpps = [0, 1, 64, 65, 1500, 2048, 3000, 4096], 64
            kvh, d = cfg.num_kv_heads, cfg.hidden_size // \
                cfg.num_attention_heads
        else:
            cfg = GPTConfig(**dict(GPT_CFG, num_layers=1))
            tree = _random_gpt(cfg, dev, seed + 10)
            lengths_l, mpps = [0, 1, 64, 65, 700, 1024, 1500, 2048], 32
            kvh, d = cfg.num_attention_heads, 128
        blk = models.fused_layer_params(kind, cfg, tree)[0]
        del tree
        table, lengths = _paged_table(dev, gen, lengths_l, ps, mpps)
        x = torch.randn(slots, cfg.hidden_size, generator=gen,
                        device=dev).to(bf)
        kw = dict(kind=kind, eps=1e-5)
        if kind == "llama":
            window = mpps * ps
            cos_t, sin_t = _rope_cos_sin(window, d, cfg.rope_theta,
                                         device=dev)
            pos = torch.clamp(lengths.long(), max=window - 1)
            kw.update(cos=cos_t.reshape(window, d)[pos],
                      sin=sin_t.reshape(window, d)[pos], eps=cfg.rms_eps)
        for tp in (2, 4):
            shard = models.shard_tree(
                blk, models.fused_partition_specs([blk], tp)[0], tp, 0)
            kvr = kvh // tp
            shape = (slots * mpps + 1, layers, kvr, ps, d)
            pool_k = torch.randn(shape, generator=gen, device=dev).to(bf)
            pool_v = torch.randn(shape, generator=gen, device=dev).to(bf)
            views = [(pool_k[:, i], pool_v[:, i]) for i in range(layers)]
            h = shard["wq"].shape[1] // d
            tag = f"{kind} tp = {tp} ({h} heads over {kvr} kv heads)"
            ref = pa.fused_block_reference(x, shard, *views[0], table,
                                           lengths, fuse_mlp=False,
                                           partial_out=True, **kw)
            for turn in "AB":
                with _as_version(versions[turn]):
                    got = pa.fused_block_decode(x, shard, *views[0], table,
                                                lengths, fuse_mlp=False,
                                                partial_out=True, **kw)
                rel = max(_rel_l2(g, r) for g, r in zip(got, ref))
                err = max((g.float() - r.float()).abs().max().item()
                          / r.float().abs().max().item()
                          for g, r in zip(got, ref))
                print(f"  partial {tag} ({turn}) against the plain version: "
                      f"max|diff| / max|ref| {err:.3e}, relative L2 "
                      f"{rel:.3e}")
                if err > TOL_FUSED_REL or rel > TOL_FUSED_REL_L2:
                    raise AssertionError(f"ab: partial {tag} ({turn}) is "
                                         f"off")
            del ref, got
            live = int(torch.clamp(lengths, max=mpps * ps).sum())
            mats = sum(shard[n].numel() for n in ("wq", "wk", "wv", "wo"))
            read = ("ln1_w", "ln1_b", "bq", "bk", "bv") if kind == "gpt" \
                else ("ln1_w",)
            vecs = sum(shard[n].numel() * shard[n].element_size()
                       for n in read)
            rope = 0 if kind == "gpt" else 2 * 4 * kw["cos"].numel()
            nbytes = 2 * mats + vecs + live * kvr * d * 2 * 2 \
                + 2 * 2 * x.numel() + 2 * 2 * slots * kvr * d + rope \
                + 4 * table.numel() + 4 * slots
            bound, by = _bound(nbytes,
                               2 * slots * mats + 4 * (live + slots) * h * d)
            cyc = itertools.cycle(views)
            mean, each = _ab(versions, lambda: _queued_ms(
                lambda: pa.fused_block_decode(
                    x, shard, *next(cyc), table, lengths, fuse_mlp=False,
                    partial_out=True, **kw), 40))
            print(f"  partial {tag}: A {mean['A']:.4f} ms, B "
                  f"{mean['B']:.4f} ms, bound {bound:.4f} ms ({by}; A "
                  f"{100 * bound / mean['A']:.1f}%, B "
                  f"{100 * bound / mean['B']:.1f}% of it; 40 queued calls a "
                  f"turn over 4 layers; turns A B B A: {_turns(each)})")
            for turn in "AB":
                with _as_version(versions[turn]):
                    clock = _partial_clock(x, shard, *views[0], table,
                                           lengths, kw)
                _print_partial_clock(f"partial {tag} stages ({turn})", clock)
            del shard, pool_k, pool_v, views, cyc
            torch.cuda.empty_cache()
        del blk, x
        torch.cuda.empty_cache()


def _ab_fused(dev, seed: int, gen, versions):
    """#8 and #8g A/B: one Llama-3-8B layer over a 4-layer pool (8 slots,
    lengths 0..4096, page 64) and one GPT-3 1.3B layer (lengths 0..2048),
    each version against the plain version, its time over the 4 layers
    in turn (40 eager calls) and its phase clock; then the fused GPT-3
    1.3B decode step and the dense Llama-3-8B decode step at 8192
    positions (:func:`_ab_steps`)."""
    from apex_tpu_torch.inference import InferenceEngine, models
    from apex_tpu_torch.transformer.testing import GPTConfig, LlamaConfig
    from apex_tpu_torch.transformer.testing.standalone_llama import (
        _rope_cos_sin)
    pa = importlib.import_module("apex_tpu_torch.ops.paged_attention")
    bf = torch.bfloat16
    slots, ps, layers = 8, 64, 4
    for kind in ("llama", "gpt"):
        if kind == "llama":
            cfg = LlamaConfig(**dict(FULL_CFG, num_layers=1))
            tree = {"layer_0": _random_llama(cfg, dev, seed, only="layer_0")[
                "layer_0"]}
            lengths_l, mpps = [0, 1, 64, 65, 1500, 2048, 3000, 4096], 64
            kvh, d = cfg.num_kv_heads, cfg.hidden_size // \
                cfg.num_attention_heads
            phases = FUSED_PHASES
        else:
            cfg = GPTConfig(**dict(GPT_CFG, num_layers=1))
            tree = _random_gpt(cfg, dev, seed + 10)
            lengths_l, mpps = [0, 1, 64, 65, 700, 1024, 1500, 2048], 32
            kvh, d = cfg.num_attention_heads, 128
            phases = GPT_FUSED_PHASES
        blk = models.fused_layer_params(kind, cfg, tree)[0]
        del tree
        table, lengths = _paged_table(dev, gen, lengths_l, ps, mpps)
        shape = (slots * mpps + 1, layers, kvh, ps, d)
        pool_k = torch.randn(shape, generator=gen, device=dev).to(bf)
        pool_v = torch.randn(shape, generator=gen, device=dev).to(bf)
        x = torch.randn(slots, cfg.hidden_size, generator=gen,
                        device=dev).to(bf)
        kw = dict(kind=kind, eps=1e-5)
        cos = sin = None
        if kind == "llama":
            window = mpps * ps
            cos_t, sin_t = _rope_cos_sin(window, d, cfg.rope_theta,
                                         device=dev)
            pos = torch.clamp(lengths.long(), max=window - 1)
            cos = cos_t.reshape(window, d)[pos]
            sin = sin_t.reshape(window, d)[pos]
            kw.update(cos=cos, sin=sin, eps=cfg.rms_eps)
        views = [(pool_k[:, i], pool_v[:, i]) for i in range(layers)]
        ref = pa.fused_block_reference(x, blk, *views[0], table, lengths,
                                       **kw)
        for turn in "AB":
            with _as_version(versions[turn]):
                got = pa.fused_block_decode(x, blk, *views[0], table,
                                            lengths, **kw)
            rel = max(((g.float() - r.float()).norm() / r.float().norm())
                      .item() for g, r in zip(got, ref))
            err = max((g.float() - r.float()).abs().max().item()
                      / r.float().abs().max().item()
                      for g, r in zip(got, ref))
            print(f"  fused_block_decode {kind} ({turn}) against the plain "
                  f"version: max|diff| / max|ref| {err:.3e}, relative L2 "
                  f"{rel:.3e}")
            if err > TOL_FUSED_REL or rel > TOL_FUSED_REL_L2:
                raise AssertionError(f"ab: fused {kind} ({turn}) is off")
        del ref, got
        cyc = itertools.cycle(views)
        for how, timer in (("queued", _queued_ms), ("eager", _eager_ms)):
            mean, each = _ab(versions, lambda: timer(
                lambda: pa.fused_block_decode(x, blk, *next(cyc), table,
                                              lengths, **kw), 40))
            print(f"  fused_block_decode {kind}, one layer, {how}: A "
                  f"{mean['A']:.4f} ms, B {mean['B']:.4f} ms (40 calls a "
                  f"turn over 4 layers; turns A B B A: {_turns(each)})")
        geo = pa._fused_geometry(x, blk, *views[0], table, lengths, kind,
                                 cos, sin, False)
        # room for either version's clock: a version writes its start,
        # its phases' ends and its end, and leaves the rest 0
        clock = torch.zeros(16, dtype=torch.int64, device=dev)
        for turn in "AB":
            with _as_version(versions[turn]):
                runs = []
                for _ in range(10):
                    clock.zero_()
                    pa._fused_kernel_call(x, blk, *views[0], table, lengths,
                                          cos, sin, kw["eps"], d ** -0.5,
                                          True, *geo, clock=clock,
                                          kind=kind)
                    t = np.asarray(clock.tolist(), np.int64)
                    runs.append(np.diff(t[:int(np.count_nonzero(t))]) / 1e3)
            us = np.median(np.stack(runs), axis=0)
            names = phases if len(us) == len(phases) else [
                f"phase {i + 1}" for i in range(len(us))]
            print(f"  fused_block_decode {kind} phases ({turn}, median of 10 "
                  f"launches, {us.sum():.1f} us in all): " + ", ".join(
                      f"{n} {t:.1f} us" for n, t in zip(names, us)))
        del blk, pool_k, pool_v, views, x
        torch.cuda.empty_cache()
    gcfg = GPTConfig(**GPT_CFG)
    engine = InferenceEngine("gpt", gcfg, _random_gpt(gcfg, dev, seed + 10),
                             slots=8, max_seq=gcfg.max_seq_length,
                             page_size=64, decode_fusion="1", device=dev)
    _ab_steps("fused decode step, 8 slots, GPT-3 1.3B", engine,
              GPT_PROMPT_LENS, seed + 10, versions, "fused_block_decode_gpt")
    del engine
    torch.cuda.empty_cache()
    lcfg = LlamaConfig(**FULL_CFG)
    engine = InferenceEngine("llama", lcfg, _random_llama(lcfg, dev, seed),
                             slots=8, max_seq=DENSE_MAX_SEQ, device=dev)
    _ab_steps("dense decode step, 8 slots at 8192 positions, Llama-3-8B",
              engine, PROMPT_LENS, seed, versions, "flash_attention_masked")
    del engine
    torch.cuda.empty_cache()


def _device_breakdown(label, fn, reps: int, top: int = 10):
    """Run ``fn`` ``reps`` times unprofiled (host clock, synchronised),
    then once more ``reps`` times under ``torch.profiler``; print the
    wall time per call, the device's busy share of it (kernel time over
    wall time) and the kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    # device-side events only: the kernels and copies themselves, not
    # the host ops and the annotated ranges that launched them
    rows = [(e.key, e.self_device_time_total / 1e3 / reps, e.count / reps)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("apex_tpu_torch.")]
    busy_ms = sum(r[1] for r in rows)
    print(f"profile {label}: {wall_ms:.3f} ms per call, device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%)")
    for name, ms, n in sorted(rows, key=lambda r: -r[1])[:top]:
        print(f"    {ms:9.4f} ms {n:6.0f}x  {name[:90]}")


def _profile(engine, prompts, label: str, prefill: bool = True):
    """Where the serve's time goes: one 2048-token cold prefill, and a
    decode step with all eight slots live."""
    cache = engine.init_cache()
    alloc = engine.new_allocator()
    last = np.zeros((engine.slots,), np.int32)
    for slot, p in enumerate(prompts[:engine.slots]):
        pages = alloc.acquire(alloc.pages_needed(len(p) + 16))
        cache, tok, _ = engine.prefill(cache, p, slot, pages=pages)
        last[slot] = int(tok)
    if prefill:
        longest = max(prompts, key=len)
        spare = alloc.acquire(alloc.pages_needed(len(longest) + 16))
        _device_breakdown(f"prefill ({len(longest)} tokens)",
                          lambda: engine.prefill(cache, longest, 0,
                                                 pages=spare), 3)
    state = {"cache": cache, "last": last}

    def step():
        c, nxt, _, _ = engine.decode(state["cache"], state["last"])
        state["cache"], state["last"] = c, nxt.numpy()

    step()
    _device_breakdown(f"decode step (8 slots, {label})", step, 5)


def _wide_flash_shapes():
    """The wide forward and backward's shapes (#3w, #5w, #6w): ``(tag,
    dtype, b, h, s, d, causal, masked, rate)``: GPT-3 1.3B's causal
    ``[1, 16, 2048, 128]`` and BERT-large's ``[16, 16, 512, 64]`` with a
    padding mask of lengths 137..512, both fp32 with dropout 0.1 (the
    width phase's training runs); fp32 causal ``[1, 16, 8192, 128]``,
    where ``sq * d * 4`` = 4 MiB takes the JAX split route; bf16 at
    Gemma-7B's head dim 256 and fp16, causal ``[1, 16, 2048, ...]``; fp16
    at head dim 100, rows TMA cannot copy (the row-copying route)."""
    f32 = torch.float32
    h = GPT_CFG["num_attention_heads"]
    d = GPT_CFG["hidden_size"] // h
    yield ("gpt fp32", f32, 1, h, GPT_TRAIN_SEQ, d, True, False, LM_DROPOUT)
    yield ("bert fp32", f32, BERT_TRAIN_BATCH, 16, BERT_TRAIN_SEQ, 64, False,
           True, LM_DROPOUT)
    yield ("8192 fp32", f32, 1, h, GPT8K_TRAIN_SEQ, d, True, False, 0.0)
    yield ("d 256 bf16", torch.bfloat16, 1, 16, GPT_TRAIN_SEQ, 256, True,
           False, 0.0)
    yield ("fp16", torch.float16, 1, 16, GPT_TRAIN_SEQ, 128, True, False, 0.0)
    yield ("fp16 d 100", torch.float16, 1, 16, GPT_TRAIN_SEQ, 100, True,
           False, 0.0)


def _wide_inputs(dev, gen, seed3, dt, b, h, s, d, masked, rate):
    """One :func:`_wide_flash_shapes` row's operands: ``(q3, k3, v3, do3,
    mask3, live, mask_bytes, md, step)``; BERT's padding mask3 ``[b, s,
    s]`` from :func:`_bert_lengths` (``live`` its live keys over the
    batch, ``mask_bytes`` its size; None, 0 and 0 without one), ``md``
    the kernels' mask and dropout keywords, ``step`` the batch-heads a
    plain version takes at a time (:func:`_by_heads`)."""
    bh = b * h
    q3, k3, v3, do3 = (torch.randn(bh, s, d, generator=gen, device=dev)
                       .to(dt) for _ in range(4))
    mask3, live, mask_bytes = None, 0, 0
    if masked:
        lengths = _bert_lengths(np.random.RandomState(s), b, s)
        keep = torch.arange(s, device=dev)[None, :] < torch.as_tensor(
            lengths, device=dev)[:, None]
        mask3 = (~keep)[:, None, :].expand(b, s, s).contiguous()
        live, mask_bytes = int(lengths.sum()), mask3.numel()
    md = dict(mask3=mask3, rate=rate, seed3=seed3 if rate else None)
    step = h if masked else max(1, min(bh, 2 ** 28 // (s * s * 4)))
    return q3, k3, v3, do3, mask3, live, mask_bytes, md, step


def _row_rel(got, ref, floor: float = 1e-3) -> float:
    """The largest over rows of a row's max |diff| over its own max |ref|,
    that max taken no smaller than ``floor`` of the whole output's: a row
    whose gradient is zero up to rounding (the first causal query's dq,
    one key: ds = p (dp - delta) with out = v) reads its rounding against
    the output's scale, not against 0."""
    g, r = (t.float().reshape(-1, t.shape[-1]) for t in (got, ref))
    mag = r.abs().amax(1).clamp_min(floor * r.abs().max())
    return ((g - r).abs().amax(1) / mag).max().item()


def _wide_grads_check(tag, got, ref, fp32: bool,
                      names=("dq", "dk", "dv")) -> float:
    """fp32: each output within TOL_WIDE_GRAD of its max|ref|; 16-bit:
    within TOL_FLASH_BWD_REL_L2 relative L2 and each row within 2^-6 of
    its own max|ref| (:func:`_row_rel`).  Returns the largest max
    |diff|."""
    err = 0.0
    for nm, g_, r_ in zip(names, got, ref):
        e = (g_.float() - r_.float()).abs().max().item()
        err = max(err, e)
        if fp32:
            _check(f"{tag} {nm}", e,
                   TOL_WIDE_GRAD * r_.float().abs().max().item())
            continue
        rel = ((g_.float() - r_.float()).norm() / r_.float().norm()).item()
        _check(f"{tag} {nm} relative L2", rel, TOL_FLASH_BWD_REL_L2)
        _check(f"{tag} {nm} (x each row's max|ref|, at least 1e-3 of "
               f"the output's)", _row_rel(g_, r_), TOL_PAGED_OUT)
    return err


def _wide_rows(dev, gen, recs):
    """The wide family's flash kernels (#3w, #5w, #6w) at
    :func:`_wide_flash_shapes`, each against its plain version on the
    same inputs (the backward's on the kernels' own out and lse; fp32
    with TF32 off, stated by ``main``), the pair twice bit for bit, the
    route (``_fwd`` and ``_bwd`` launch the wide kernels and no
    instance); each kernel's time beside its bound (16-bit over 989
    TFLOP/s; fp32 on the tensor cores over 989 / 6, six bf16 products a
    product, with the CUDA cores' 67 TFLOP/s beside it; fp32 on the CUDA
    cores over 67), its plain version's
    and SDPA's (forward, and forward + backward less the forward for
    the backward pair).  The records are GPT-3 1.3B fp32's.  Then the
    keep patterns (:func:`_wide_keep_patterns`), the padded bf16 routes
    (:func:`_padded_rows`) and paged decode's #7w
    (:func:`_wide_paged_rows`)."""
    attn = importlib.import_module("apex_tpu_torch.ops.attention")
    from apex_tpu_torch.ops import _build
    print(f"wide kernels: #3w, #5w and #6w on the tensor cores (fp32 up to "
          f"head dim 128 as three bf16 planes, six bf16 products a "
          f"product); the plain versions' fp32 products with "
          f"TF32 {'on' if torch.backends.cuda.matmul.allow_tf32 else 'off'}"
          f" (torch.backends.cuda.matmul.allow_tf32)")
    seed3 = attn._seed_operand(-2 ** 31 + 777, device=dev)
    for tag, dt, b, h, s, d, causal, masked, rate in _wide_flash_shapes():
        bh, scale, fp32 = b * h, d ** -0.5, dt == torch.float32
        q3, k3, v3, do3, mask3, live, mask_bytes, md, step = _wide_inputs(
            dev, gen, seed3, dt, b, h, s, d, masked, rate)
        before = _build.launch_counts()
        out, lse = attn._fwd(q3, k3, v3, causal, scale, **md)
        routed = attn._bwd(q3, k3, v3, out, lse, do3, causal, scale, **md)
        counts = {k_: v_ - before[k_] for k_, v_ in
                  _build.launch_counts().items() if v_ != before[k_]}
        if counts != dict.fromkeys(WIDE_FLASH, 1):
            raise AssertionError(f"wide {tag}: _fwd and _bwd did not take "
                                 f"the wide kernels alone: {counts}")
        delta = attn._delta(out, do3)
        args = (q3, k3, v3, lse, delta, do3, causal, scale)
        got = (attn._dq_wide(*args, **md), *attn._dkv_wide(*args, **md))
        if not all(torch.equal(a, r) for a, r in zip(got, routed)):
            raise AssertionError(f"wide {tag}: #5w + #6w differ from run to "
                                 f"run")
        del routed

        def sl_mask(sl):
            return None if mask3 is None else mask3[sl.start // h:
                                                    sl.stop // h]

        def plain_fwd(sl):
            return attn._fwd_reference(q3[sl], k3[sl], v3[sl], causal, scale,
                                       mask3=sl_mask(sl), rate=rate,
                                       seed3=seed3, bh0=sl.start)

        def plain_bwd(sl):
            a = (q3[sl], k3[sl], v3[sl], lse[sl], delta[sl], do3[sl], causal,
                 scale)
            kw = dict(mask3=sl_mask(sl), rate=rate, seed3=seed3,
                      bh0=sl.start)
            return (attn._dq_reference(*a, **kw),
                    *attn._dkv_reference(*a, **kw))

        ref_out, ref_lse = _by_heads(plain_fwd, bh, step)
        label = (f"{'padding' if masked else 'causal'} [{b}, {h}, {s}, {d}] "
                 f"{str(dt).replace('torch.', '')}"
                 + (f", dropout {rate}" if rate else ""))
        on_tc = attn._wide_on_tensor_cores(dt, d)
        print(f"wide flash ({tag}: {label}; #3w, #5w and #6w on the "
              f"{'tensor' if on_tc else 'CUDA'} cores)")
        livel = ref_lse > -1e29
        err_f = (out.float() - ref_out.float()).abs().max().item()
        if fp32:
            _check("flash_attention_wide out", err_f,
                   TOL_WIDE_OUT * ref_out.abs().max().item())
            _check("flash_attention_wide lse (base 2)",
                   (lse - ref_lse)[livel].abs().max().item(),
                   TOL_WIDE_OUT * ref_lse[livel].abs().max().item())
        else:
            _check("flash_attention_wide out", err_f, TOL_ATTN_OUT)
            _check("flash_attention_wide out (x each row's max|ref|)",
                   _slot_rel(out.reshape(-1, d), ref_out.reshape(-1, d)),
                   TOL_PAGED_OUT)
            _check("flash_attention_wide lse (base 2)",
                   (lse - ref_lse)[livel].abs().max().item(), TOL_ATTN_LSE)
        if not torch.equal(livel, lse > -1e29):
            raise AssertionError(f"wide {tag}: fully masked rows differ")
        del ref_out, ref_lse
        err_b = _wide_grads_check("flash_attention_wide_dq/dkv", got,
                                  _by_heads(plain_bwd, bh, step), fp32)
        # times: the kernels, their plain versions, SDPA
        iters = 3 if s > 4096 else 10
        fwd_ms = _time_ms(lambda: attn._fwd_wide(q3, k3, v3, causal, scale,
                                                 **md), iters)
        dq_ms = _time_ms(lambda: attn._dq_wide(*args, **md), iters)
        dkv_ms = _time_ms(lambda: attn._dkv_wide(*args, **md), iters)
        fwd_plain = _eager_ms(lambda: _by_heads(plain_fwd, bh, step), 1)
        dq_plain = _eager_ms(lambda: _by_heads(
            lambda sl: plain_bwd(sl)[0], bh, step), 1)
        dkv_plain = _eager_ms(lambda: _by_heads(
            lambda sl: plain_bwd(sl)[1:], bh, step), 1)
        q4, k4, v4, do4 = (t.reshape(b, h, s, d) for t in (q3, k3, v3, do3))
        sdpa = dict(attn_mask=None if mask3 is None else (~mask3)[:, None],
                    dropout_p=rate, is_causal=causal and mask3 is None)
        lib_f = _time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, **sdpa), iters)
        qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q4, k4, v4))
        lib_fb = _time_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(qr, kr, vr, **sdpa), (qr, kr, vr),
            do4), iters)
        del qr, kr, vr
        # bounds: every operand read once, every output written once; the
        # products of the live elements (causal: half the score matrix)
        item = q3.element_size()
        elems = (bh * s * (s + 1) / 2 if causal and mask3 is None
                 else s * live * h if mask3 is not None else bh * s * s)
        kv_bytes = 2 * (bh * s if mask3 is None else live * h) * d * item
        rows = (
            ("3w", "flash_attention_wide", "apex_tpu/ops/attention.py:210",
             fwd_ms, fwd_plain, 2 * q3.numel() * item + kv_bytes
             + bh * s * 4 + mask_bytes, 4 * d * elems, lib_f, err_f),
            ("5w", "flash_attention_wide_dq", "apex_tpu/ops/attention.py:376",
             dq_ms, dq_plain, 3 * q3.numel() * item + kv_bytes
             + 2 * bh * s * 4 + mask_bytes, 6 * d * elems, lib_fb - lib_f,
             err_b),
            ("6w", "flash_attention_wide_dkv",
             "apex_tpu/ops/attention.py:408", dkv_ms, dkv_plain,
             2 * q3.numel() * item + 2 * kv_bytes + 2 * bh * s * 4
             + mask_bytes, 8 * d * elems, lib_fb - lib_f, err_b))
        for row, name, repl, ms, plain_ms, nbytes, ops, lib, err in rows:
            # fp32 on the tensor cores: the operations at the rate of six
            # bf16 products (989 / 6 TFLOP/s), the CUDA cores' beside it
            six = fp32 and on_tc
            bound, by = _bound(nbytes, ops, BF16_FLOPS_PER_S / 6 if six
                               else FP32_FLOPS_PER_S if fp32
                               else BF16_FLOPS_PER_S)
            cores = ""
            if six:
                b67, by67 = _bound(nbytes, ops, FP32_FLOPS_PER_S)
                cores = (f"; at the CUDA cores' 67 TFLOP/s {b67:.4f} ms "
                         f"({by67}), {100 * b67 / ms:.1f}% of it")
            print(f"  #{row} {name} ({tag}) on {_smi()}: kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, SDPA {lib:.4f} ms, bound "
                  f"{bound:.4f} ms ({by}{', six bf16 products' if six else ''}"
                  f"), {100 * bound / ms:.1f}% of the bound{cores}")
            if tag == "gpt fp32":
                # flash_wide.cu's entries launch the wide modes of the
                # persistent kernel (#3w, #5w) and of the key-major
                # warp-specialized one (#6w)
                recs[name] = dict(
                    name=name, route="cuda",
                    source="apex_tpu_torch/csrc/" + (
                        "flash_kmajor_ws.cuh" if row == "6w"
                        else "flash_qmajor_ws.cuh"),
                    replaces=repl, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound, bound_by=by, library_ms=lib,
                    eager_ms=_eager_ms(
                        (lambda: attn._fwd_wide(q3, k3, v3, causal, scale,
                                                **md)) if row == "3w" else
                        (lambda: attn._dq_wide(*args, **md)) if row == "5w"
                        else (lambda: attn._dkv_wide(*args, **md)), 4))
        del q3, k3, v3, do3, q4, k4, v4, do4, out, lse, delta, got, mask3
        torch.cuda.empty_cache()
    _wide_keep_patterns(dev, seed3)
    _padded_rows(dev, gen)
    _wide_paged_rows(dev, gen, recs)


def _wide_keep_patterns(dev, seed3) -> None:
    """#3w's, #6w's keep patterns bit for bit, as :func:`_keep_patterns`
    holds the instances' (q = 0, v = I: out > 0 where kept; dO = I: dv),
    with and without a padding mask, in each operand type; #5w's dq
    against its plain version."""
    attn = importlib.import_module("apex_tpu_torch.ops.attention")
    rate, d, bh = LM_DROPOUT, 128, 32
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        for masked in (False, True):
            s = d
            q = torch.zeros(bh, s, d, dtype=dt, device=dev)
            k = torch.randn(bh, s, d, device=dev).to(dt)
            eye = torch.eye(d, dtype=dt, device=dev).expand(
                bh, d, d).contiguous()
            keep = attn._keep3(seed3, bh, s, s, rate, dev)
            mask3 = None
            if masked:
                lengths = torch.arange(bh // 16, device=dev) * 37 % s + 1
                mask3 = (torch.arange(s, device=dev)[None, None, :]
                         >= lengths[:, None, None]).expand(bh // 16, s, s)
                mask3 = mask3.contiguous()
                keep = keep & ~mask3.repeat_interleave(16, dim=0)
            md = dict(mask3=mask3, rate=rate, seed3=seed3)
            out, lse = attn._fwd_wide(q, k, eye, False, d ** -0.5, **md)
            args = (q, k, eye, lse, attn._delta(out, eye), eye, False,
                    d ** -0.5)
            dq = attn._dq_wide(*args, **md)
            _, dv = attn._dkv_wide(*args, **md)
            ref_dq = attn._dq_reference(*args, **md)
            rel = ((dq.float() - ref_dq.float()).norm()
                   / ref_dq.float().norm()).item()
            res = {"#3w": torch.equal(out > 0, keep),
                   "#6w": torch.equal(dv.transpose(1, 2) > 0, keep),
                   "#5w dq relative L2 <= 1e-2": rel <= TOL_FLASH_BWD_REL_L2}
            print(f"wide keep patterns ({str(dt).replace('torch.', '')}, d "
                  f"{d}, {bh} batch-heads, "
                  f"{'a padding mask, ' if masked else ''}rate {rate}, {int(keep.sum())} of {keep.numel()} kept): "
                  f"{res}")
            if not all(res.values()):
                raise AssertionError(f"a wide kernel's keep pattern differs "
                                     f"from the plain keep mask: {res}")


def _padded_rows(dev, gen) -> None:
    """The padded bf16 routes through the public ``flash_attention``: d 80
    causal with dropout 0.1 at GPT-3 2.7B's ``[1, 32, 2048, 80]`` (the
    #3d and #4d instances at 128) and d 32 with a padding mask and
    dropout at ``[16, 16, 512, 32]`` (#3md, #4md at 64), each held
    against the plain versions at the real head dim (forward, and the
    backward from the plain forward's out and lse); then the d 80 route's
    time (forward, forward + backward) beside the same call at d 128."""
    attn = importlib.import_module("apex_tpu_torch.ops.attention")
    from apex_tpu_torch.ops import _build
    bf, rate = torch.bfloat16, LM_DROPOUT
    seed = torch.tensor(-99, dtype=torch.int32, device=dev)
    seed3 = attn._seed_operand(seed)
    h27 = GPT27_CFG["num_attention_heads"]
    cases = (("d 80", 1, h27, GPT_TRAIN_SEQ, 80, True, False,
              ("flash_attention_drop", "flash_attention_bwd_drop")),
             ("d 32 masked", 16, 16, BERT_TRAIN_SEQ, 32, False, True,
              ("flash_attention_masked_drop", "flash_attention_bwd_masked")))
    for tag, b, h, s, d, causal, masked, names in cases:
        q, k, v, do = (torch.randn(b, h, s, d, generator=gen, device=dev)
                       .to(bf) for _ in range(4))
        mask = mask3 = None
        if masked:
            lengths = _bert_lengths(np.random.RandomState(d), b, s)
            keep = torch.arange(s, device=dev)[None, :] < torch.as_tensor(
                lengths, device=dev)[:, None]
            mask = (~keep)[:, None, None, :].expand(b, 1, s, s)
            mask3 = attn._mask3(mask, b, h, s, s)
        kw = dict(causal=causal, mask=mask, dropout_rate=rate,
                  dropout_seed=seed)
        qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
        _build.reset_launch_counts()
        out = attn.flash_attention(qs, ks, vs, **kw)
        grads = torch.autograd.grad(out, (qs, ks, vs), do)
        counts = {k_: v_ for k_, v_ in _build.launch_counts().items() if v_}
        if counts != dict.fromkeys(names, 1):
            raise AssertionError(f"padded {tag}: launches {counts}, want "
                                 f"{names}")
        bh = b * h
        q3, k3, v3, do3 = (t.reshape(bh, s, d) for t in (q, k, v, do))
        step = h if masked else 8
        scale = d ** -0.5

        def plain(sl):
            m3 = None if mask3 is None else mask3[sl.start // h:sl.stop // h]
            o, lse = attn._fwd_reference(q3[sl], k3[sl], v3[sl], causal,
                                         scale, mask3=m3, rate=rate,
                                         seed3=seed3, bh0=sl.start)
            return (o, *attn._bwd_reference(
                q3[sl], k3[sl], v3[sl], o, lse, do3[sl], causal, scale,
                mask3=m3, rate=rate, seed3=seed3, bh0=sl.start))

        ref = _by_heads(plain, bh, step)
        print(f"padded route ({tag}: [{b}, {h}, {s}, {d}] bf16, "
              f"{'padding mask, ' if masked else 'causal, '}dropout {rate}; "
              f"launches {counts})")
        _check(f"padded {tag} out", (out.reshape(bh, s, d).float()
                                     - ref[0].float()).abs().max().item(),
               TOL_ATTN_OUT)
        _wide_grads_check(f"padded {tag}", [g.reshape(bh, s, d)
                                            for g in grads], ref[1:], False)
        del ref, grads, out
        if tag != "d 80":
            continue
        times = {}
        for dd in (80, 128):
            qq, kk, vv, dd_o = (t[..., :dd] if dd <= d else torch.randn(
                b, h, s, dd, generator=gen, device=dev).to(bf)
                for t in (q, k, v, do))
            qq, kk, vv = (t.contiguous().requires_grad_()
                          for t in (qq, kk, vv))
            dd_o = dd_o.contiguous()
            fwd = (lambda: attn.flash_attention(qq, kk, vv, **kw))
            times[dd] = (_time_ms(fwd, 10), _time_ms(
                lambda: torch.autograd.grad(fwd(), (qq, kk, vv), dd_o), 10))
        print(f"  padded d 80 route on {_smi()}: forward {times[80][0]:.4f} "
              f"ms, forward + backward {times[80][1]:.4f} ms; the same at d "
              f"128: {times[128][0]:.4f} ms, {times[128][1]:.4f} ms")
        torch.cuda.empty_cache()


#: #7w's rows: (tag, pool type, kv heads, group, head dim, page, lengths)
#: -- GPT-3 1.3B's fp32 pool (16 kv heads, group 1, head dim 128, page 64:
#: the record), a bf16 pool at group 16 and head dim 64, GPT-3 2.7B's head
#: dim 80 (32 kv heads), GPT-3 1.3B's bf16 pool at pages of 8 and 256,
#: its fp16 pool at page 64, and an fp16 pool at #7's kernels-phase shape
#: (Llama-3-8B: 8 kv heads of group 4, head dim 128, lengths 0..4096)
def _wide_paged_cases():
    gh = GPT_CFG["num_attention_heads"]
    gpt = [0, 128, 300, 512, 1000, 1536, 1800, 2048]
    bf, f16 = torch.bfloat16, torch.float16
    return (("gpt fp32", torch.float32, gh, 1, 128, 64, gpt),
            ("group 16 bf16", bf, 8, 16, 64, 64, gpt),
            ("d 80 bf16", bf, GPT27_CFG["num_attention_heads"], 1, 80, 64,
             gpt),
            ("page 8 bf16", bf, gh, 1, 128, 8, gpt),
            ("page 256 bf16", bf, gh, 1, 128, 256, gpt),
            ("gpt fp16", f16, gh, 1, 128, 64, gpt),
            ("llama fp16", f16, 8, 4, 128, 64,
             [0, 1, 64, 65, 1500, 2048, 3000, 4096]))


def _wide_paged_inputs(dev, gen, dt, kvh, group, d, ps, lengths_l,
                       layers: int = 4, mpps=None, rows=None):
    """8 slots of ``lengths_l`` over a ``layers``-layer pool of ``dt``
    holding only the live pages (and a trash page), pages shuffled: q,
    each layer's strided view, the page table and the lengths.  With
    ``rows``, a verify slab of that many rows a slot: q ``[slots, h,
    rows, d]`` and the pages its rows reach in a window of ``mpps``
    pages."""
    mpps = mpps or -(-max(lengths_l) // ps)
    need = [-(-min(n + (rows or 0), mpps * ps) // ps) for n in lengths_l]
    n_pages = sum(need) + 1
    pool_k, pool_v = (torch.randn(n_pages, layers, kvh, ps, d, generator=gen,
                                  device=dev).to(dt) for _ in range(2))
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev)
    table = torch.full((len(lengths_l), mpps), n_pages - 1,
                       dtype=torch.int32, device=dev)
    cursor = 0
    for i, n in enumerate(need):
        table[i, :n] = perm[cursor:cursor + n].to(torch.int32)
        cursor += n
    lengths = torch.tensor(lengths_l, dtype=torch.int32, device=dev)
    q = torch.randn(len(lengths_l), kvh * group, *((rows,) if rows else ()),
                    d, generator=gen, device=dev).to(dt)
    views = [(pool_k[:, i], pool_v[:, i]) for i in range(layers)]
    return q, views, table, lengths


def _wide_paged_mode(pa, kp, vp) -> str:
    """The mode the host predicate sends the pool to."""
    tma = pa._wide_paged_tma(kp.dtype, kp.shape[3], kp.shape[2],
                             kp.stride(0), kp.data_ptr(), vp.data_ptr())
    return "TMA" if tma else "CUDA cores"


def _wide_paged_rows(dev, gen, recs) -> None:
    """Paged decode's #7w against its plain version at
    :func:`_wide_paged_cases`, reading one layer of a four-layer pool in
    place.  Each: the mode the host predicate picks (printed), the route
    (one #7w launch, no #7), each slot within its own max (fp32
    TOL_WIDE_OUT, 16-bit TOL_PAGED_OUT), a second call the same bits, an
    empty slot 0; the time over the four layers in turn (so each call
    reads its pages from device memory, as a decode step does) beside the
    bound (the live tokens' k and v read once: bytes; the products at the
    CUDA cores' rate for fp32, the tensor cores' for 16-bit) and the
    plain version's; the fp16 rows beside #7's bf16 instance on the same
    pool cast to bf16.  No PyTorch call computes paged decode through a
    page table (row #7's reason): library null."""
    pa = importlib.import_module("apex_tpu_torch.ops.paged_attention")
    from apex_tpu_torch.ops import _build
    for tag, dt, kvh, group, d, ps, lengths_l in _wide_paged_cases():
        q, views, table, lengths = _wide_paged_inputs(
            dev, gen, dt, kvh, group, d, ps, lengths_l)
        kp, vp = views[1]
        mode = _wide_paged_mode(pa, kp, vp)
        before = _build.launch_counts()
        got = pa.paged_decode_attention(q, kp, vp, table, lengths)
        again = pa.paged_decode_attention(q, kp, vp, table, lengths)
        after = _build.launch_counts()
        if after["paged_attention_wide"] - before["paged_attention_wide"] \
                != 2 or after["paged_attention"] != before["paged_attention"]:
            raise AssertionError(f"#7w {tag}: the route took another kernel")
        ref = pa.paged_decode_reference(q, kp, vp, table, lengths, d ** -0.5)
        print(f"wide paged decode ({tag}: 8 slots, {kvh} kv heads, group "
              f"{group}, head dim {d}, page {ps}, lengths {lengths_l}): "
              f"{mode} mode")
        fp32 = dt == torch.float32
        _check("paged_attention_wide out (x each slot's max|ref|)",
               _slot_rel(got, ref), TOL_WIDE_OUT if fp32 else TOL_PAGED_OUT)
        if not torch.equal(got, again) or not bool((got[0] == 0).all()):
            raise AssertionError(f"#7w {tag}: not the same bits twice, or an "
                                 f"empty slot not 0")
        err = (got.float() - ref.float()).abs().max().item()
        cyc = itertools.cycle(views)
        ms = _time_ms(lambda: pa.paged_decode_attention(
            q, *next(cyc), table, lengths), 48)
        plain_ms = _eager_ms(lambda: pa.paged_decode_reference(
            q, kp, vp, table, lengths, d ** -0.5), 5)
        live = sum(lengths_l)
        item = q.element_size()
        bound, by = _bound(2 * live * kvh * d * item + 2 * q.numel() * item,
                           4 * live * kvh * group * d,
                           FP32_FLOPS_PER_S if fp32 else BF16_FLOPS_PER_S)
        print(f"  #7w paged_attention_wide ({tag}, {mode}) on {_smi()}: "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound:.4f} ms ({by}), {100 * bound / ms:.1f}% of the bound")
        if dt == torch.float16:
            bviews = [(k_.to(torch.bfloat16), v_.to(torch.bfloat16))
                      for k_, v_ in views]
            qb = q.to(torch.bfloat16)
            if pa._paged_route(qb.dtype, qb.dtype, group, d, ps) \
                    == "paged_attention":
                bcyc = itertools.cycle(bviews)
                bms = _time_ms(lambda: pa.paged_decode_attention(
                    qb, *next(bcyc), table, lengths), 48)
                print(f"  #7's bf16 instance on the same pool in bf16: "
                      f"{bms:.4f} ms (fp16 / bf16 {ms / bms:.3f})")
            del bviews
        if tag == "gpt fp32":
            recs["paged_attention_wide"] = dict(
                name="paged_attention_wide", route="cuda",
                source="apex_tpu_torch/csrc/kv_decode.cuh",
                replaces="apex_tpu/ops/paged_attention.py:108",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=None,
                eager_ms=_eager_ms(lambda: pa.paged_decode_attention(
                    q, kp, vp, table, lengths), 20))
        del views, kp, vp, got, again, ref, cyc
        torch.cuda.empty_cache()


def _slab_rows(t):
    """``[slots, h, S, d]`` as ``[slots * S, h, d]``: a slab row a slot."""
    return t.transpose(1, 2).reshape(-1, t.shape[1], t.shape[3])


#: the folded verify slab's rows: Llama-3-8B's serve (8 slots, group 4,
#: page 64, a 4096-position window) on #7, GPT-3 1.3B's fp32 pool (group
#: 1, page 64, 2048 positions) on #7w; one slot ends within S rows of its
#: window, one at it
VERIFY_CASES = (
    ("llama bf16", torch.bfloat16, 8, 4, 128, 64, 64, "paged_attention",
     [0, 1, 64, 1500, 2048, 3000, 4093, 4096]),
    ("gpt fp32", torch.float32, 16, 1, 128, 64, 32, "paged_attention_wide",
     [0, 1, 128, 512, 1000, 1536, 2045, 2048]))


def _verify_rows(dev, gen, recs) -> None:
    """The verify step's attention, :func:`paged_slab_attention` (the
    slab folded into 8 x S virtual slots of one paged decode call), at
    :data:`VERIFY_CASES`, one layer of a four-layer pool read in place:
    one launch of the case's kernel and none of the other, each slab row
    within its own max of the plain version (the gathered window through
    ``slab_decode_attention``; fp32 TOL_WIDE_OUT, bf16 TOL_PAGED_OUT),
    rows past the window 0, the same bits twice; the fold's time over
    the four layers in turn beside the plain version's, the same
    kernel's q_len-1 decode on the pool, and the bound: the live k/v
    bytes (each slot's ``min(length + S, window)`` tokens) read once and
    q and the output once over 3.35 TB/s, against each row's products at
    the type's rate.  Then F4's layouts: a bf16 pool at #7's shape 8
    bytes into its buffer, and with a page stride of a multiple of 4
    elements and not 8, each on #7w (no #7 launch) against the plain
    version, timed beside #7 on the aligned pool; a dense bf16 cache at
    the decode kernel's ``[8, 32, 1, 8192]`` with a slot stride the
    kernel cannot step, one decode-kernel launch on a contiguous copy,
    timed (the copy included) beside the same cache read in place."""
    pa = importlib.import_module("apex_tpu_torch.ops.paged_attention")
    attn = importlib.import_module("apex_tpu_torch.ops.attention")
    from apex_tpu_torch.ops import _build
    smi = _smi()
    for tag, dt, kvh, group, d, ps, mpps, kernel, lengths_l in VERIFY_CASES:
        q, views, table, lengths = _wide_paged_inputs(
            dev, gen, dt, kvh, group, d, ps, lengths_l, mpps=mpps,
            rows=SPEC_S)
        kp, vp = views[1]
        other = ({"paged_attention", "paged_attention_wide"}
                 - {kernel}).pop()
        before = _build.launch_counts()
        got = pa.paged_slab_attention(q, kp, vp, table, lengths)
        again = pa.paged_slab_attention(q, kp, vp, table, lengths)
        after = _build.launch_counts()
        if after[kernel] - before[kernel] != 2 \
                or after[other] != before[other]:
            raise AssertionError(f"verify slab {tag}: the fold did not run "
                                 f"one {kernel} launch a call")
        ref = pa.paged_slab_reference(q, kp, vp, table, lengths, d ** -0.5)
        win = mpps * ps
        q3, fold_table, live_l = pa._slab_fold(q, table, lengths, win)
        own = pa.paged_decode_reference(q3, kp, vp, fold_table, live_l,
                                        d ** -0.5)
        print(f"verify slab ({tag}: 8 slots x S {SPEC_S} rows, {kvh} kv "
              f"heads, group {group}, head dim {d}, page {ps}, window "
              f"{win}, lengths {lengths_l}): folded into "
              f"{8 * SPEC_S} virtual slots on {kernel}")
        fp32 = dt == torch.float32
        _check("verify slab out against the kernel's plain version (x each "
               "row's max|ref|)", _slot_rel(_slab_rows(got), own),
               TOL_WIDE_OUT if fp32 else TOL_PAGED_OUT)
        _check("verify slab out against plain paged_slab_attention (x each "
               "row's max|ref|)", _slot_rel(_slab_rows(got), _slab_rows(ref)),
               TOL_WIDE_OUT if fp32 else TOL_SLAB_PLAIN)
        past = torch.tensor([[n + r >= win for r in range(SPEC_S)]
                             for n in lengths_l], device=dev)
        if not torch.equal(got, again) \
                or not bool((got.transpose(1, 2)[past] == 0).all()):
            raise AssertionError(f"verify slab {tag}: not the same bits "
                                 f"twice, or a row past the window not 0")
        cyc = itertools.cycle(views)
        ms = _time_ms(lambda: pa.paged_slab_attention(
            q, *next(cyc), table, lengths), 24)
        plain_ms = _eager_ms(lambda: pa.paged_slab_reference(
            q, kp, vp, table, lengths, d ** -0.5), 3)
        q1 = q[:, :, 0].contiguous()
        dec_ms = _time_ms(lambda: pa.paged_decode_attention(
            q1, *next(cyc), table, lengths), 24)
        live = sum(min(n + SPEC_S, win) for n in lengths_l)
        rows = sum(min(n + r + 1, win) * (n + r < win)
                   for n in lengths_l for r in range(SPEC_S))
        item = q.element_size()
        bound, by = _bound(2 * live * kvh * d * item + 2 * q.numel() * item,
                           4 * rows * kvh * group * d,
                           FP32_FLOPS_PER_S if fp32 else BF16_FLOPS_PER_S)
        print(f"  verify slab ({tag}) on {smi}: fold {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by}; live k/v "
              f"{2 * live * kvh * d * item / 1e6:.1f} MB once), "
              f"{100 * bound / ms:.1f}% of the bound; the same kernel's "
              f"q_len-1 decode on the pool {dec_ms:.4f} ms (fold / decode "
              f"{ms / dec_ms:.2f})")
        if tag == "llama bf16":
            # F4: the same pool, at #7's shape, in layouts #7 cannot read
            flat = [torch.empty(kp.numel() + 4, dtype=dt, device=dev)
                    for _ in range(2)]
            ku, vu = (f_[4:].view(kp.shape) for f_ in flat)
            ku.copy_(kp)
            vu.copy_(vp)
            inner = kp[0].numel()
            odd = [torch.empty(kp.shape[0], inner + 4, dtype=dt, device=dev)
                   for _ in range(2)]
            ks, vs = (b_.as_strided(kp.shape, (inner + 4,) + kp.stride()[1:])
                      for b_ in odd)
            ks.copy_(kp)
            vs.copy_(vp)
            for name, (k_, v_) in (("8 bytes into its buffer", (ku, vu)),
                                   ("page stride % 8 == 4", (ks, vs))):
                before = _build.launch_counts()
                got1 = pa.paged_decode_attention(q1, k_, v_, table, lengths)
                after = _build.launch_counts()
                if after["paged_attention_wide"] \
                        != before["paged_attention_wide"] + 1 \
                        or after["paged_attention"] \
                        != before["paged_attention"]:
                    raise AssertionError(f"F4 pool {name}: not on #7w")
                ref1 = pa.paged_decode_reference(q1, k_, v_, table, lengths,
                                                 d ** -0.5)
                print(f"F4: bf16 pool at #7's shape, {name}: #7w "
                      f"{_wide_paged_mode(pa, k_, v_)} mode")
                _check("paged_attention_wide out (x each slot's max|ref|)",
                       _slot_rel(got1, ref1), TOL_PAGED_OUT)
                f4_ms = _time_ms(lambda: pa.paged_decode_attention(
                    q1, k_, v_, table, lengths), 24)
                n_live = sum(lengths_l)
                f4_bound, f4_by = _bound(
                    2 * n_live * kvh * d * item + 2 * q1.numel() * item,
                    4 * n_live * kvh * group * d)
                print(f"  F4 pool ({name}) on {smi}: #7w {f4_ms:.4f} ms, "
                      f"bound {f4_bound:.4f} ms ({f4_by}), #7 on the "
                      f"aligned pool {dec_ms:.4f} ms")
            del flat, ku, vu, odd, ks, vs, got1, ref1
        del views, kp, vp, got, again, ref, cyc, q, q1
        torch.cuda.empty_cache()
    # F4, the dense decode: [8, 32, 1, 8192] over 8 kv heads, a slot
    # stride 4 elements past whole rows
    b, kvh, group, s_cache, d = 8, 8, 4, DENSE_MAX_SEQ, 128
    lens = torch.tensor([0, 1, 100, 1000, 4097, 6000, 8000, 8192],
                        dtype=torch.int32, device=dev)
    inner = kvh * s_cache * d
    bufs = [torch.randn(b, inner + 4, generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2)]
    k, v = (b_.as_strided((b, kvh, s_cache, d), (inner + 4, s_cache * d, d,
                                                  1)) for b_ in bufs)
    qd = torch.randn(b, kvh * group, 1, d, generator=gen, device=dev).to(
        torch.bfloat16)
    if attn._decode_in_place(k, v):
        raise AssertionError("F4 dense: the layout is one the kernel reads")
    before = _build.launch_counts()
    got = attn.decode_attention(qd, k, v, lens, use_kernel=True)
    after = _build.launch_counts()
    if after["flash_attention_masked"] != \
            before["flash_attention_masked"] + 1:
        raise AssertionError("F4 dense: not one decode-kernel launch")
    ref = attn._decode_reference(qd.reshape(b, kvh, group, d), k, v, lens,
                                 d ** -0.5)
    print("F4: dense decode [8, 32, 1, 8192] on a bf16 cache with a slot "
          "stride 4 elements past whole rows: the decode kernel on a "
          "contiguous copy")
    _check("decode out (x each slot's max|ref|)",
           _slot_rel(got.reshape(b, kvh, group, d), ref), TOL_PAGED_OUT)
    kc, vc = k.contiguous(), v.contiguous()
    copy_ms = _time_ms(lambda: attn.decode_attention(
        qd, k, v, lens, use_kernel=True), 8)
    place_ms = _time_ms(lambda: attn.decode_attention(
        qd, kc, vc, lens, use_kernel=True), 8)
    n_live = int(torch.clamp(lens, max=s_cache).sum())
    bound, by = _bound(2 * n_live * kvh * d * 2 + 2 * qd.numel() * 2,
                       4 * n_live * kvh * group * d)
    print(f"  F4 dense decode on {smi}: {copy_ms:.4f} ms with the copy, "
          f"{place_ms:.4f} ms on the same cache read in place, bound "
          f"{bound:.4f} ms ({by}: the live k/v once)")
    del bufs, k, v, kc, vc, got, ref
    torch.cuda.empty_cache()


def _width_serve(dev, seed: int, label: str, cfg_kw: dict, dtype,
                 prefill_kernel: str):
    """One GPT model at full width and depth (random weights in
    ``dtype`` from a seed) served paged and unfused with a pool of the
    same type, page 64, 8 requests of 128..1536 tokens, 32 greedy tokens:
    as :func:`phase_gpt`'s paged serve, with each decode step launching
    #7w once a layer (and no other paged kernel) and the prefill the
    flash route of its type; two requests' decode logits against the
    full forward.  Returns the serve's record."""
    from apex_tpu_torch.inference import InferenceEngine
    from apex_tpu_torch.transformer.testing import GPTConfig
    from apex_tpu_torch.utils import tree_leaves_with_path
    cfg = GPTConfig(**cfg_kw)
    t0 = time.perf_counter()
    params = _random_gpt(cfg, dev, seed + 10, dtype=dtype)
    torch.cuda.synchronize()
    n = sum(t.numel() for _, t in tree_leaves_with_path(params))
    print(f"{label}: {n / 1e9:.3f}e9 parameters, random "
          f"{str(dtype).replace('torch.', '')} weights in "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(seed + 10)
    prompts = [rng.randint(0, cfg.vocab_size, size=n_).tolist()
               for n_ in GPT_PROMPT_LENS]
    engine = InferenceEngine("gpt", cfg, params, slots=8,
                             max_seq=cfg.max_seq_length, device=dev,
                             page_size=64, cache_dtype=dtype,
                             decode_fusion="0")
    served = _serve(engine, prompts, label)
    launches = served["launches"]
    steps = int(served["reg"].declared("infer_decode_dispatch_total").total())
    want = dict.fromkeys(GPT_DECODE_KERNELS, 0)
    want["paged_attention_wide"] = cfg.num_layers * steps
    got = {k: launches[k] for k in want}
    print(f"  {label}: {steps} decode steps, launches by kernel "
          f"{ {k: v for k, v in launches.items() if v} } (decode: want "
          f"{want}; prefill: {prefill_kernel})")
    if steps <= 0 or got != want or not launches[prefill_kernel] \
            or not launches["layer_norm"]:
        raise AssertionError(f"{label}: launches off: {launches}")
    for idx in (0, len(prompts) - 1):
        _, d_, _ = _check_logits(f"{label} request {idx}", engine,
                                 prompts[idx], served["outs"][idx],
                                 TOL_LOGITS)
        served[f"logit_err_{idx}"] = d_
    rec = {k: served[k] for k in ("launches", "ttft_mean_s",
                                  "decode_tokens_per_s", "peak_bytes")}
    del engine, served, params
    torch.cuda.empty_cache()
    return rec


def phase_width(dev, seed: int):
    """The width slice at full width: GPT-3 1.3B at the JAX package's
    default fp32 parameters served (an fp32 pool; prefill on #3w, decode
    on #7w) and trained (six ``fused_adam`` steps on 1 x 2048 causal
    tokens, dropout 0.1, #3w, #5w and #6w once a layer and step; the
    first step's flat grads against the same step through the plain
    versions from the same weights and generator seed, within
    TOL_TRAIN_GRAD_REL_L2 leaf by leaf); BERT-large at fp32 (the
    ``bert_train`` recipe: ``fused_lamb``, 16 x 512 behind the padding
    mask, dropout 0.1, six steps, the wide family with mask3 and
    dropout); GPT-3 2.7B in bf16 (d_head 80) served at full depth
    (prefill on the padded #3, decode on #7w) and trained six steps at 4
    layers (:data:`GPT27_TRAIN_LAYERS`, the only cut) on 4 x 2048 tokens
    with dropout 0.1 (the padded #3d and #4d).  Returns the launches of
    the wide kernels over the phase and each run's record."""
    from apex_tpu_torch.ops import _build
    total = dict.fromkeys(WIDE_KERNELS, 0)
    runs = {}

    def add(launches):
        for k_ in total:
            total[k_] += launches[k_]

    runs["gpt fp32 serve"] = _width_serve(dev, seed, "width gpt fp32 serve",
                                          GPT_CFG, torch.float32,
                                          "flash_attention_wide")
    add(runs["gpt fp32 serve"]["launches"])
    keep, plain_g = [], []
    run = phase_lm_train(dev, seed, "gpt_fp32", keep=keep)
    add(run["launches"])
    plain = phase_lm_train(dev, seed, "gpt_fp32", steps=1, keep=plain_g,
                           tag="plain (1 step)", plain=True)
    if any(plain["launches"][k_] for k_ in WIDE_FLASH):
        raise AssertionError("the plain step launched a wide kernel")
    print("width gpt fp32 train against the plain step, first step:")
    got, ref = keep[0].to(dev), plain_g[0].to(dev)
    del keep, plain_g
    rels = _hold_grads("width gpt fp32 train", got, ref, run["leaves"],
                       [run["losses"][0], plain["losses"][0]],
                       TOL_TRAIN_GRAD_REL_L2, top=8)
    del got, ref
    torch.cuda.empty_cache()
    runs["gpt fp32 train"] = dict(run, grad_rel_l2=max(rels.values()))
    run = phase_lm_train(dev, seed, "bert_fp32")
    add(run["launches"])
    runs["bert fp32 train"] = run
    runs["gpt27 serve"] = _width_serve(dev, seed, "width gpt27 serve",
                                       GPT27_CFG, torch.bfloat16,
                                       "flash_attention")
    add(runs["gpt27 serve"]["launches"])
    run = phase_lm_train(dev, seed, "gpt27")
    runs["gpt27 train"] = run
    print("width summary:")
    for label, r in runs.items():
        if "step_s" in r:
            print(f"  {label}: {r['step_s']:.4f} s a step, "
                  f"{r['tokens'] / r['step_s']:.1f} tokens/s, peak "
                  f"{r['peak_bytes'] / 2**30:.2f} GiB")
        else:
            print(f"  {label}: TTFT mean {r['ttft_mean_s']:.4f} s, decode "
                  f"{r['decode_tokens_per_s']:.1f} tokens/s, peak "
                  f"{r['peak_bytes'] / 2**30:.2f} GiB")
    print(f"  wide kernel launches over the phase: {total}")
    for k_, v_ in total.items():
        if not v_:
            raise AssertionError(f"width: {k_} never launched")
    _build.reset_launch_counts()
    return dict(launches=total, runs=runs)


#: the host page tier (the tier and fleet phases): Llama-3-8B at the
#: serve phase's widths and geometry but a pool of TIER_PAGES pages of 64
#: (8 MiB a page), which round 1's later prefixes overflow (they push the
#: earlier ones out of the pool), and a host tier of 2 GiB that holds
#: them; 8 shared prefixes of 1024 tokens (16 pages), each followed by a
#: suffix of 64..256 tokens, in two rounds of one request a prefix
TIER_PREFIXES, TIER_PREFIX_LEN, TIER_SUFFIX = 8, 1024, (64, 256)
TIER_GEOMETRY = dict(slots=8, max_seq=4096, page_size=64, num_pages=128,
                     host_tier_bytes=2 << 30)
#: the fleet's replicas: the same geometry with half the pool each, so
#: each replica's share of the traffic overflows its pool too
FLEET_GEOMETRY = dict(TIER_GEOMETRY, num_pages=64)
#: the fused run's chunked prefill (tokens a chunk)
TIER_CHUNK = 256
#: round 1 must swap out at least this many pages, round 2 must hit the
#: host tier at least this many times
TIER_MIN_SWAP_OUT, TIER_MIN_HOST_HITS = 64, 4
#: the bandwidth and eviction rows move one prefix's pages (128 MiB)
TIER_SWAP_PAGES = 16
TIER_TTFT_REPS = 3
#: prefix_window_attention's warm shapes: the suffixes' lengths over a
#: 1024-token prefix in a 4096-position window, Llama-3-8B's heads
TIER_WINDOW_ROWS = (64, 256)
_TIER_MODEL: dict = {}


def _tier_model(dev, seed: int):
    """Llama-3-8B's config and one tree of seeded bf16 weights, built once
    for the tier and fleet phases."""
    from apex_tpu_torch.transformer.testing import LlamaConfig
    if not _TIER_MODEL:
        cfg = LlamaConfig(**FULL_CFG)
        t0 = time.perf_counter()
        _TIER_MODEL.update(cfg=cfg, params=_random_llama(cfg, dev, seed))
        torch.cuda.synchronize()
        print(f"tier: Llama-3-8B random bf16 weights in "
              f"{time.perf_counter() - t0:.1f} s")
    return _TIER_MODEL["cfg"], _TIER_MODEL["params"]


def _tier_traffic(vocab: int, seed: int):
    """Two rounds of one request a shared prefix: the prefix (1024 seeded
    tokens) and a suffix of 64..256 seeded tokens, new in each round."""
    rng = np.random.RandomState(seed + 24)
    prefixes = [rng.randint(0, vocab, TIER_PREFIX_LEN).tolist()
                for _ in range(TIER_PREFIXES)]
    return [[p + rng.randint(0, vocab, int(rng.randint(
        TIER_SUFFIX[0], TIER_SUFFIX[1] + 1))).tolist() for p in prefixes]
            for _ in range(2)]


def _page_digests(cache, ids, w):
    """``[n, 2]`` int64 fingerprints of pages ``ids`` (k, v) of a 16-bit
    pool: each page's bits as int16 times fixed weights in [1, 2^16),
    summed in int64 (exact, so equal bits give equal digests on any
    device; a changed element moves the digest)."""
    idx = torch.as_tensor(list(ids), device=cache.device)
    return torch.stack([
        (pool[idx].reshape(len(idx), -1).view(torch.int16).to(torch.int64)
         * w).sum(dim=1) for pool in (cache.k, cache.v)], dim=1)


class _SwapAudit:
    """The tier phase's swap gates, by wrapping one engine's swap methods
    and ``PendingSwapOut.resolve``: device digests of every page as its
    swap-out is called and after each swap-in (every page swapped in must
    equal a page swapped out), each swap-out call's page count and
    dispatches (one a ``swap_batch_pages``), and at each deferred
    swap-out's ``resolve()``: its pages' digests on the device then
    (pages acquired again and overwritten by a prefill since) and of the
    host slabs it returns, which must be the swap-out's."""

    def __init__(self, engine):
        page = engine.page_host_bytes() // (2 * torch.empty(
            (), dtype=engine.cache_dtype).element_size())
        gen = torch.Generator(device=engine.device)
        gen.manual_seed(24)
        self.w = torch.randint(1, 1 << 16, (page,), generator=gen,
                               device=engine.device, dtype=torch.int64)
        self.engine = engine
        self.out, self.ins = [], []
        self.calls = {"out": [], "in": []}
        self.pending: dict = {}
        self.resolved = dict(pages=0, overwritten=0, wrong=0)
        self._out, self._in = engine.swap_out_pages, engine.swap_in_pages

    def swap_out(self, cache, page_ids, defer=False):
        d = _page_digests(cache, page_ids, self.w)
        res = self._out(cache, page_ids, defer=defer)
        self.out.append(d)
        self.calls["out"].append(len(page_ids))
        if defer:
            self.pending[id(res)] = (cache, list(page_ids), d)
        else:
            self._hold_host(res, d, None)
        return res

    def swap_in(self, cache, page_ids, k, v):
        cache = self._in(cache, page_ids, k, v)
        self.ins.append(_page_digests(cache, page_ids, self.w))
        self.calls["in"].append(len(page_ids))
        return cache

    def resolve(self, pending, original):
        entry = None if pending.done else self.pending.pop(id(pending), None)
        now = (None if entry is None
               else _page_digests(entry[0], entry[1], self.w))
        res = original(pending)
        if entry is not None:
            self._hold_host(res, entry[2], now)
        return res

    def _hold_host(self, slabs, want, now):
        dev = self.engine.device
        got = torch.stack([
            (torch.from_numpy(s.view(np.int16).reshape(len(s), -1)).to(dev)
             .to(torch.int64) * self.w).sum(dim=1) for s in slabs], dim=1)
        self.resolved["pages"] += len(want)
        self.resolved["wrong"] += int((got != want).any(dim=1).sum())
        if now is not None:
            self.resolved["overwritten"] += int((now != want).any(
                dim=1).sum())

    def dispatches(self, kind: str) -> int:
        b = self.engine.swap_batch_pages
        return sum(-(-n // b) for n in self.calls[kind])

    def hold(self, label: str) -> None:
        """Every page swapped in equals one swapped out, bit for bit (by
        digest); no host slab differs from its swap-out."""
        out = {tuple(d) for d in torch.cat(self.out).tolist()} \
            if self.out else set()
        ins = torch.cat(self.ins).tolist() if self.ins else []
        bad = sum(tuple(d) not in out for d in ins)
        r = self.resolved
        print(f"  {label} swap audit: {len(ins)} pages swapped in, {bad} "
              f"unlike every page swapped out; deferred swap-outs resolved "
              f"{r['pages']} pages, {r['overwritten']} of them overwritten on "
              f"the card before resolve(), {r['wrong']} host slabs unlike "
              f"their swap-out")
        if bad or r["wrong"]:
            raise AssertionError(f"{label}: a swapped page changed")


@contextlib.contextmanager
def _audited(engine):
    emod = importlib.import_module("apex_tpu_torch.inference.engine")
    audit = _SwapAudit(engine)
    original = emod.PendingSwapOut.resolve
    engine.swap_out_pages, engine.swap_in_pages = (audit.swap_out,
                                                   audit.swap_in)
    emod.PendingSwapOut.resolve = lambda self: audit.resolve(self, original)
    try:
        yield audit
    finally:
        emod.PendingSwapOut.resolve = original
        del engine.swap_out_pages, engine.swap_in_pages


def _tier_serve(engine, rounds, label: str, prefix_cache: bool = True,
                prefill_chunk: int = 0, audit=None):
    """The rounds as waves of one scheduler (global registry zeroed just
    before, launch counters too): each wave's books (``live + free ==
    num_pages``; the host store's pages equal the prefix cache's host
    edges) and swap counters; returns the streams by round, the
    launches, the registry and the serve's TTFT, decode tokens/s and
    peak memory."""
    from apex_tpu_torch import observability as obs
    from apex_tpu_torch.inference import SlotScheduler
    from apex_tpu_torch.ops import _build
    reg = obs.reset_global_registry()
    sched = SlotScheduler(engine, prefix_cache=prefix_cache,
                          prefill_chunk=prefill_chunk)
    tel = sched.telemetry
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    outs, waves = [], []
    t0 = time.perf_counter()
    for i, prompts in enumerate(rounds):
        uids = [sched.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
        res = sched.run()
        outs.append([res[u] for u in uids])
        al = sched.alloc
        w = dict(swap_out=int(tel.swap_out_pages.total()),
                 swap_in=int(tel.swap_in_pages.total()),
                 host_hits=int(tel.prefix_host_hits.total()),
                 hits=int(tel.prefix_hits.total()),
                 hit_tokens=int(tel.prefix_hit_tokens.total()),
                 chunks=int(tel.prefill_chunks.total()),
                 live=al.live_pages, free=al.free_pages,
                 host_pages=(sched.host_store.pages
                             if sched.host_store is not None else 0),
                 host_edges=(sched.prefix.host_pages
                             if sched.prefix is not None else 0))
        waves.append(w)
        print(f"  {label} round {i + 1}: swapped out {w['swap_out']} pages, "
              f"in {w['swap_in']}, prefix hits {w['hits']} ({w['host_hits']} "
              f"on the host tier, {w['hit_tokens']} tokens), prefill chunks "
              f"{w['chunks']}; pages live {w['live']} + free {w['free']} "
              f"(pool {al.num_pages}), host pages {w['host_pages']} (prefix "
              f"cache host edges {w['host_edges']})")
        if w["live"] + w["free"] != al.num_pages \
                or w["host_pages"] != w["host_edges"]:
            raise AssertionError(f"{label} round {i + 1}: the books do not "
                                 f"balance")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    ttft = reg.declared("serve_ttft_seconds")
    dec = reg.declared("serve_decode_token_seconds")
    tokens = sum(len(o) for r in outs for o in r)
    decode_tokens = tokens - sum(len(r) for r in outs)
    run = dict(outs=outs, waves=waves, launches=launches, reg=reg,
               wall_s=wall, peak_bytes=peak,
               ttft_mean_s=ttft.sum() / ttft.count(),
               decode_tokens_per_s=decode_tokens / dec.sum(),
               decode_step_s=dec.sum() / dec.count())
    print(f"  {label}: {tokens} tokens in {wall:.3f} s, TTFT mean "
          f"{run['ttft_mean_s']:.4f} s, decode {dec.count()} steps, "
          f"{run['decode_tokens_per_s']:.1f} tokens/s, peak device memory "
          f"{peak / 2**30:.2f} GiB{' (swap audit on)' if audit else ''}")
    print(f"  {label}: kernel launches {launches}")
    if any(len(o) != NEW_TOKENS for r in outs for o in r):
        raise AssertionError(f"{label}: a request did not get "
                             f"{NEW_TOKENS} tokens")
    return run


def _tier_run(engine, rounds, label: str, smi: str, kernel: str,
              prefill_chunk: int = 0):
    """One tier serve under the swap audit beside the same traffic with
    the prefix cache off, and its gates."""
    with _audited(engine) as audit:
        run = _tier_serve(engine, rounds, label, prefill_chunk=prefill_chunk,
                          audit=audit)
        audit.hold(label)
    reg, (w1, w2) = run["reg"], run["waves"]
    dispatch = {k_: int(reg.declared(f"infer_swap_{k_}_dispatch_total")
                        .total()) for k_ in ("out", "in")}
    want = {k_: audit.dispatches(k_) for k_ in ("out", "in")}
    print(f"  {label}: swap dispatches out {dispatch['out']}, in "
          f"{dispatch['in']} (want {want['out']}, {want['in']}: one a "
          f"{engine.swap_batch_pages} pages of each call) [{smi}]")
    if dispatch != want or not dispatch["in"]:
        raise AssertionError(f"{label}: the swap dispatches are off")
    if w1["swap_out"] < TIER_MIN_SWAP_OUT \
            or w2["host_hits"] - w1["host_hits"] < TIER_MIN_HOST_HITS \
            or w2["swap_in"] <= w1["swap_in"]:
        raise AssertionError(
            f"{label}: round 1 swapped out {w1['swap_out']} pages (want >= "
            f"{TIER_MIN_SWAP_OUT}), round 2 hit the host tier "
            f"{w2['host_hits'] - w1['host_hits']} times (want >= "
            f"{TIER_MIN_HOST_HITS})")
    if not audit.resolved["overwritten"]:
        raise AssertionError(f"{label}: no deferred swap-out saw its pages "
                             f"overwritten before resolve()")
    la = run["launches"]
    never = "paged_attention" if kernel == "fused_block_decode" else \
        "fused_block_decode"
    if not (la["layer_norm"] and la["flash_attention"] and la[kernel]) \
            or la[never]:
        raise AssertionError(f"{label}: the launches are off: {la}")
    if prefill_chunk and w2["chunks"] <= 2 * sum(map(len, rounds)):
        raise AssertionError(f"{label}: chunked prefill did not chunk")
    ref = _tier_serve(engine, rounds, f"{label} (prefix cache off)",
                      prefix_cache=False, prefill_chunk=prefill_chunk)
    parted = 0
    for r, (got_r, want_r) in enumerate(zip(run["outs"], ref["outs"])):
        for i, (got, want) in enumerate(zip(got_r, want_r)):
            parted += not _hold_stream(f"{label} round {r + 1} request {i}",
                                       engine, rounds[r][i], got, want)
    print(f"  {label}: {sum(map(len, rounds)) - parted}/"
          f"{sum(map(len, rounds))} streams equal the prefix-cache-off "
          f"serve's, the rest part at a near tie")
    return run, ref


def _tier_ttft(engine, cfg, seed: int, smi: str):
    """TTFT of one request (a 1024-token prefix and a 256-token suffix)
    as a cold prefill, as an HBM hit (the prefix's pages in the pool) and
    as a host hit (every page evicted to the host tier, the drains
    resolved), each on a fresh scheduler's prefix cache, over
    ``TIER_TTFT_REPS`` prefixes; returns the medians."""
    from apex_tpu_torch import observability as obs
    from apex_tpu_torch.inference import SlotScheduler
    rng = np.random.RandomState(seed + 25)
    got = {"cold": [], "HBM hit": [], "host hit": []}
    for _ in range(TIER_TTFT_REPS):
        obs.reset_global_registry()
        sched = SlotScheduler(engine)
        prefix = rng.randint(0, cfg.vocab_size, TIER_PREFIX_LEN).tolist()
        for kind in got:
            if kind == "host hit":
                sched.prefix.evict_lru(engine.num_pages)
                sched.drain_pending_swaps()
            t = sched.telemetry.ttft
            s0 = t.sum()
            sched.submit(prefix + rng.randint(0, cfg.vocab_size,
                                              256).tolist(),
                         max_new_tokens=2)
            sched.run()
            got[kind].append(t.sum() - s0)
        if int(sched.telemetry.prefix_host_hits.total()) != 1:
            raise AssertionError("the host-hit request did not hit the "
                                 "host tier")
    med = {k_: float(np.median(v)) for k_, v in got.items()}
    for k_, v in got.items():
        print(f"  TTFT {k_} (prompt {TIER_PREFIX_LEN + 256}): "
              f"{' '.join(f'{x * 1e3:.3f}' for x in v)} ms, median "
              f"{med[k_] * 1e3:.3f} ms [{smi}]")
    return med


def _tier_bandwidth(engine, smi: str):
    """Swap-out and swap-in GB/s of one prefix's pages beside a plain
    pinned ``copy_`` of the same bytes each way; the host time of the
    eviction path's swap-out, deferred against eager (medians of 5)."""
    cache = engine.init_cache()
    gen = torch.Generator(device=engine.device)
    gen.manual_seed(26)
    for pool in (cache.k, cache.v):
        pool.copy_(torch.randn(pool.shape, generator=gen,
                               device=engine.device))
    ids = list(range(TIER_SWAP_PAGES))
    dst = list(range(TIER_SWAP_PAGES, 2 * TIER_SWAP_PAGES))
    nbytes = TIER_SWAP_PAGES * engine.page_host_bytes()

    def timed(fn, reps=5):
        ts = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        return float(np.median(ts))

    slabs = engine.swap_out_pages(cache, ids)
    t_out = timed(lambda: engine.swap_out_pages(cache, ids))
    t_in = timed(lambda: (engine.swap_in_pages(cache, dst, *slabs),
                          torch.cuda.synchronize()))
    for pool in (cache.k, cache.v):
        if not torch.equal(pool[dst].view(torch.int16),
                           pool[ids].view(torch.int16)):
            raise AssertionError("tier: the swapped pages came back changed")
    dev_buf = torch.empty(nbytes // 2, dtype=torch.bfloat16,
                          device=engine.device)
    host_buf = torch.empty(nbytes // 2, dtype=torch.bfloat16,
                           pin_memory=True)
    t_d2h = timed(lambda: (host_buf.copy_(dev_buf, non_blocking=True),
                           torch.cuda.synchronize()))
    t_h2d = timed(lambda: (dev_buf.copy_(host_buf, non_blocking=True),
                           torch.cuda.synchronize()))
    # the eviction path: deferred with fresh pinned buffers (the earlier
    # drains still held, as a wave's evictions hold theirs), deferred
    # with the allocator's cached blocks (each drain resolved and dropped
    # first), eager
    pend = []
    t_fresh = timed(lambda: pend.append(engine.swap_out_pages(
        cache, ids, defer=True)))
    for p in pend:
        p.resolve()
    del pend[:]
    ts = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = engine.swap_out_pages(cache, ids, defer=True)
        ts.append(time.perf_counter() - t0)
        p.resolve()
        del p                       # its pinned blocks go back to the cache
    t_defer = float(np.median(ts))
    t_eager = timed(lambda: engine.swap_out_pages(cache, ids))
    # a host hit's host copies, piece by piece: the store's materialize
    # (a copy a page), the scheduler's np.stack, the upload
    k_r, v_r = engine.swap_out_pages(cache, ids, defer=True).resolve()
    t_mat = timed(lambda: [(k_r[i].copy(), v_r[i].copy())
                           for i in range(TIER_SWAP_PAGES)])
    pages = [(k_r[i].copy(), v_r[i].copy()) for i in range(TIER_SWAP_PAGES)]
    t_stack = timed(lambda: (np.stack([p_[0] for p_ in pages]),
                             np.stack([p_[1] for p_ in pages])))
    gb = nbytes / 1e9
    print(f"  swap of {TIER_SWAP_PAGES} pages ({nbytes / 2**20:.0f} MiB, "
          f"batches of {engine.swap_batch_pages}): out {gb / t_out:.2f} GB/s "
          f"({t_out * 1e3:.3f} ms), in {gb / t_in:.2f} GB/s "
          f"({t_in * 1e3:.3f} ms); a pinned copy_ of the same bytes: "
          f"device to host {gb / t_d2h:.2f} GB/s, host to device "
          f"{gb / t_h2d:.2f} GB/s [{smi}]")
    print(f"  eviction path host time, {TIER_SWAP_PAGES} pages: deferred "
          f"{t_fresh * 1e3:.3f} ms with fresh pinned buffers, "
          f"{t_defer * 1e3:.3f} ms on the allocator's cached blocks, eager "
          f"{t_eager * 1e3:.3f} ms [{smi}]")
    print(f"  a host hit's host copies, {TIER_SWAP_PAGES} pages: the store's "
          f"materialize {t_mat * 1e3:.3f} ms ({gb / t_mat:.2f} GB/s), "
          f"np.stack {t_stack * 1e3:.3f} ms ({gb / t_stack:.2f} GB/s), "
          f"swap_in_pages {t_in * 1e3:.3f} ms [{smi}]")
    del cache, dev_buf, host_buf, pend, pages, k_r, v_r
    torch.cuda.empty_cache()
    return dict(out_gbps=gb / t_out, in_gbps=gb / t_in,
                d2h_gbps=gb / t_d2h, h2d_gbps=gb / t_h2d,
                fresh_ms=t_fresh * 1e3, defer_ms=t_defer * 1e3,
                eager_ms=t_eager * 1e3)


def _window_rows(dev, cfg, smi: str) -> None:
    """``prefix_window_attention`` (plain PyTorch: the JAX package
    computes the warm suffix's attention in XLA) per layer at the warm
    shapes: each suffix length over a 1024-token prefix in the slot's
    4096-position window, Llama-3-8B's 32 heads over 8 kv heads of 128;
    eager calls between CUDA events, beside a bound for the live work
    (the prefix rows once, the causal suffix)."""
    from apex_tpu_torch.ops.attention import prefix_window_attention
    h, kvh, d = cfg.num_attention_heads, cfg.num_kv_heads, \
        cfg.hidden_size // cfg.num_attention_heads
    gen = torch.Generator(device=dev)
    gen.manual_seed(27)
    win = TIER_GEOMETRY["max_seq"]
    wk, wv = (torch.randn(1, kvh, win, d, generator=gen, device=dev)
              .to(torch.bfloat16) for _ in range(2))
    for s in TIER_WINDOW_ROWS:
        q = torch.randn(1, h, s, d, generator=gen, device=dev).to(
            torch.bfloat16)
        k, v = (torch.randn(1, kvh, s, d, generator=gen, device=dev)
                .to(torch.bfloat16) for _ in range(2))
        out = prefix_window_attention(q, k, v, wk, wv, TIER_PREFIX_LEN)
        if not torch.isfinite(out.float()).all():
            raise AssertionError("prefix_window_attention: not finite")
        ms = _eager_ms(lambda: prefix_window_attention(
            q, k, v, wk, wv, TIER_PREFIX_LEN), 20)
        live = TIER_PREFIX_LEN * s + s * (s + 1) / 2
        nbytes = 2 * (2 * kvh * (TIER_PREFIX_LEN + s) * d + 2 * h * s * d)
        bound, by = _bound(nbytes, 4 * h * d * live)
        print(f"  prefix_window_attention, suffix {s} over prefix "
              f"{TIER_PREFIX_LEN} (window {win}): {ms:.4f} ms a layer "
              f"(eager), {ms * cfg.num_layers:.3f} ms over "
              f"{cfg.num_layers} layers; bound {bound:.4f} ms ({by}) [{smi}]")


def phase_tier(dev, seed: int):
    """The host page tier on Llama-3-8B (:data:`TIER_GEOMETRY`, the
    traffic of :func:`_tier_traffic`): served unfused, then fused
    (``decode_fusion="1"``) with chunked prefill (``TIER_CHUNK``), each
    under the swap audit and held by :func:`_tier_run` (the unfused
    serve again without the audit); then one
    request's TTFT cold, as an HBM hit and as a host hit, the swap
    bandwidth beside pinned copies, the eviction path's host time, and
    ``prefix_window_attention`` at the warm shapes.  Returns the tier
    serves' launches and the unfused prefix-cache-off streams."""
    from apex_tpu_torch.inference import InferenceEngine
    smi = _smi()
    cfg, params = _tier_model(dev, seed)
    rounds = _tier_traffic(cfg.vocab_size, seed)
    total: dict = {}

    def add(launches):
        for k_, n in launches.items():
            total[k_] = total.get(k_, 0) + n

    engine = InferenceEngine("llama", cfg, params, device=dev,
                             **TIER_GEOMETRY)
    print(f"tier: Llama-3-8B, pool {engine.num_pages} pages of "
          f"{engine.page_size} ({engine.cache_hbm_bytes() / 2**30:.2f} GiB), "
          f"a page {engine.page_host_bytes() / 2**20:.0f} MiB, host tier "
          f"{engine.host_tier_bytes / 2**30:.0f} GiB, swap batches of "
          f"{engine.swap_batch_pages}; prompts "
          f"{[[len(p) for p in r] for r in rounds]}")
    run, ref = _tier_run(engine, rounds, "tier unfused", smi,
                         "paged_attention")
    add(run["launches"])
    # the same serve again without the audit, on the pinned blocks the
    # first left in the caching host allocator
    warm = _tier_serve(engine, rounds, "tier unfused, no audit, pinned "
                       "blocks cached")
    fused = InferenceEngine("llama", cfg, params, device=dev,
                            decode_fusion="1", **TIER_GEOMETRY)
    frun, _ = _tier_run(fused, rounds, "tier fused, chunked", smi,
                        "fused_block_decode", prefill_chunk=TIER_CHUNK)
    add(frun["launches"])
    del fused
    torch.cuda.empty_cache()
    ttft = _tier_ttft(engine, cfg, seed, smi)
    bw = _tier_bandwidth(engine, smi)
    _window_rows(dev, cfg, smi)
    print(f"tier summary [{smi}]: unfused TTFT mean {run['ttft_mean_s']:.4f} "
          f"s, decode {run['decode_tokens_per_s']:.1f} tokens/s, peak "
          f"{run['peak_bytes'] / 2**30:.2f} GiB (no audit, pinned blocks "
          f"cached: {warm['ttft_mean_s']:.4f} s, "
          f"{warm['decode_tokens_per_s']:.1f}; prefix cache off: "
          f"{ref['ttft_mean_s']:.4f} s, {ref['decode_tokens_per_s']:.1f}); "
          f"fused + chunked {frun['ttft_mean_s']:.4f} s, "
          f"{frun['decode_tokens_per_s']:.1f} tokens/s, peak "
          f"{frun['peak_bytes'] / 2**30:.2f} GiB; one request's TTFT cold "
          f"{ttft['cold'] * 1e3:.3f} ms, HBM hit {ttft['HBM hit'] * 1e3:.3f}, "
          f"host hit {ttft['host hit'] * 1e3:.3f}; swap out "
          f"{bw['out_gbps']:.2f} GB/s, in {bw['in_gbps']:.2f} (pinned copies "
          f"{bw['d2h_gbps']:.2f}, {bw['h2d_gbps']:.2f})")
    del engine
    torch.cuda.empty_cache()
    return dict(launches=total, ref=ref["outs"])


def _fleet_order(rounds):
    """The fleet's waves: round 1 in prefix order, round 2 rotated by one
    prefix, so round robin over two replicas sends each prefix's second
    request to the replica its first did not go to."""
    return [list(rounds[0]), rounds[1][1:] + rounds[1][:1]]


def phase_fleet(dev, seed: int, ref=None):
    """Two replicas on the one card (``build_fleet`` over two unfused
    Llama-3-8B engines of :data:`FLEET_GEOMETRY` on one weight tree) serve
    the tier phase's traffic (:func:`_fleet_order`) under
    ``round_robin``, then ``prefix_affinity``: the conservation law after
    every wave, affinity routing more prefix tokens to hits than round
    robin, the streams the single engine's (the tier phase's
    prefix-cache-off serve) up to a near tie.  Prints each policy's TTFT
    and decode tokens/s, and ``required_replicas`` and ``drift_ratio``
    from a ``ServiceProfile`` of this run's own prefill and decode
    times.  Returns the fleet serves' launches."""
    from apex_tpu_torch.fleet import (ServiceProfile, build_fleet,
                                      drift_ratio, required_replicas,
                                      simulate)
    from apex_tpu_torch.inference import InferenceEngine
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.utils import tree_leaves_with_path
    smi = _smi()
    cfg, params = _tier_model(dev, seed)
    rounds = _tier_traffic(cfg.vocab_size, seed)
    engines = [InferenceEngine("llama", cfg, params, device=dev,
                               **FLEET_GEOMETRY) for _ in range(2)]
    leaves = [dict(tree_leaves_with_path(e.params)) for e in engines]
    shared = all(t.data_ptr() == leaves[1][p].data_ptr() == s.data_ptr()
                 for (p, t), (_, s) in zip(leaves[0].items(),
                                           tree_leaves_with_path(params)))
    print(f"fleet: 2 replicas on one card share one weight tree: {shared}")
    if not shared:
        raise AssertionError("fleet: a replica copied the weights")
    if ref is None:
        ref = _tier_serve(engines[0], rounds, "fleet reference (one "
                          "engine, prefix cache off)", prefix_cache=False)[
                              "outs"]
    want = {tuple(p): o for r, outs in zip(rounds, ref)
            for p, o in zip(r, outs)}
    waves = _fleet_order(rounds)
    total: dict = {}
    runs = {}
    for policy in ("round_robin", "prefix_affinity"):
        fleet = build_fleet(engines, policy=policy)
        _build.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        parted = 0
        for w, prompts in enumerate(waves):
            uids = [fleet.submit(p, max_new_tokens=NEW_TOKENS)
                    for p in prompts]
            out = fleet.run()
            law = fleet.conservation()
            if not law["holds"]:
                raise AssertionError(f"fleet {policy} wave {w + 1}: the "
                                     f"conservation law fails: {law}")
            for u, p in zip(uids, prompts):
                parted += not _hold_stream(f"fleet {policy} uid {u}",
                                           engines[0], p, out[u],
                                           want[tuple(p)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for k_, n in _build.launch_counts().items():
            total[k_] = total.get(k_, 0) + n
        tels = [rep.telemetry for rep in fleet.replicas]
        ttft_s = sum(t.ttft.sum() for t in tels)
        ttft_n = sum(t.ttft.count() for t in tels)
        dec_s = sum(t.decode_token_seconds.sum() for t in tels)
        dec_n = sum(t.decode_token_seconds.count() for t in tels)
        tokens = NEW_TOKENS * sum(map(len, waves))
        decode_tokens = tokens - sum(map(len, waves))
        prefill_s = sum(t.prefill_seconds.sum() for t in tels)
        hit_tokens = sum(int(t.prefix_hit_tokens.total()) for t in tels)
        r = dict(
            ttft_mean_s=ttft_s / ttft_n, decode_tokens_per_s=decode_tokens
            / dec_s, decode_step_us=dec_s / dec_n * 1e6, wall_s=wall,
            hit_tokens=hit_tokens, host_hits=sum(
                int(t.prefix_host_hits.total()) for t in tels),
            routed_prefix_tokens=int(
                fleet.telemetry.routed_prefix_tokens.total()),
            affinity_hits=int(fleet.telemetry.affinity_hits.total()),
            placements=[fleet.placements[u][0] for u in sorted(
                fleet.placements)],
            prefill_us_per_token=prefill_s * 1e6 / (sum(
                len(p) for wv in waves for p in wv) - hit_tokens))
        runs[policy] = r
        print(f"fleet {policy}: placements {r['placements']}, {wall:.3f} s; "
              f"TTFT mean {r['ttft_mean_s']:.4f} s, decode "
              f"{r['decode_tokens_per_s']:.1f} tokens/s (the replicas run "
              f"one after the other); replicas' prefix-hit tokens "
              f"{hit_tokens} ({r['host_hits']} host hits), "
              f"fleet_routed_prefix_tokens_total "
              f"{r['routed_prefix_tokens']}, fleet_prefix_affinity_hits_total "
              f"{r['affinity_hits']}; {sum(map(len, waves)) - parted}/"
              f"{sum(map(len, waves))} streams equal the single engine's "
              f"[{smi}]")
        del fleet
        torch.cuda.empty_cache()
    rr, aff = runs["round_robin"], runs["prefix_affinity"]
    if not (total["paged_attention"] and total["flash_attention"]):
        raise AssertionError(f"fleet: the launches are off: {total}")
    if not (aff["routed_prefix_tokens"] > rr["routed_prefix_tokens"]
            and aff["affinity_hits"] > 0
            and aff["hit_tokens"] > rr["hit_tokens"]):
        raise AssertionError("fleet: prefix_affinity routed no more prefix "
                             "tokens to hits than round_robin")
    prompts = [len(p) for wv in waves for p in wv]
    prof = ServiceProfile(rr["prefill_us_per_token"], rr["decode_step_us"],
                          "measured:chip_smoke fleet round_robin")
    slo_us = 4 * rr["ttft_mean_s"] * 1e6
    need = required_replicas(prof, slots=TIER_GEOMETRY["slots"],
                             slo_ttft_us=slo_us, n_requests=256,
                             interarrival_us=20_000.0,
                             prompt_tokens=prompts,
                             decode_tokens=NEW_TOKENS, seed=seed)
    pred = simulate(prof, replicas=2, slots=TIER_GEOMETRY["slots"],
                    n_requests=len(prompts), interarrival_us=0.0,
                    prompt_tokens=prompts, decode_tokens=NEW_TOKENS)
    drift = drift_ratio(pred["ttft_p50_us"], aff["ttft_mean_s"] * 1e6)
    print(f"fleet capacity ({prof.provenance}: prefill "
          f"{prof.prefill_us_per_token:.2f} us a token, decode "
          f"{prof.decode_us_per_token:.1f} us a token): required_replicas at "
          f"a TTFT p99 SLO of {slo_us / 1e3:.1f} ms, 50 requests/s of these "
          f"prompts: {need['replicas']} (simulated p99 "
          f"{need['ttft_p99_us'] / 1e3:.3f} ms); "
          f"simulated TTFT p50 of this run's {len(prompts)} requests on 2 "
          f"replicas {pred['ttft_p50_us'] / 1e3:.3f} ms against the measured "
          f"affinity mean {aff['ttft_mean_s'] * 1e3:.3f} ms: drift_ratio "
          f"{drift:.3f} [{smi}]")
    del engines
    torch.cuda.empty_cache()
    return dict(launches=total, runs=runs)


#: data parallelism and ZeRO (the dp phase): two ranks on the one card,
#: Llama-3-8B widths at 1 layer (1.269e9 parameters; one layer leaves the
#: default run room for cp_train).  Two ranks' dense
#: DDP state at the train phase's 4 layers (fp32 master, m and v, bf16
#: params and grads, the flat fp32 grads: ~38.5 GB a rank before
#: activations) does not fit twice in 80 GB; at 2 layers it is ~30 GB.
DP = 2
DP_LAYERS = 1
DP_STEPS = 1
DP_LAMB_STEPS = 1
#: the ZeRO state's prefetch spans (gathered and reduce-scattered one span
#: at a time, so no full-length flat temporary is ever made)
DP_PREFETCH = 4
#: every DP_SAMPLE-th element of the master is the digest held against
#: the reference (1.269e9 / 997 ~ 1.3e6 elements)
DP_SAMPLE = 997
#: ResNet-50's stage-1 width: [32, 56, 56, 256] fp32 channel-last a rank
DP_BN_SHAPE = (32, 56, 56, 256)
#: the masters against the one-rank reference: bf16 grads of another
#: batch split move an element by at most ~lr a step (Adam's first steps
#: move each by about lr * sign(g), so a grad near 0 whose sign the split
#: flips moves it by 2 lr: the max is a bound, the share is the gate),
#: and few elements by more than lr/8 (0.175% measured)
TOL_DP_MASTER_MAX = 2 * TRAIN_LR * DP_STEPS
TOL_DP_MASTER_SHARE = 0.01
#: the mean losses against the reference's (4096 tokens' mean in fp32)
TOL_DP_LOSS = 1e-3
#: the averaged grad shards (ZeRO's each step, DistributedFusedLAMB's
#: first) against DDP's all-reduced grads of the same batch: the
#: least-squares scale within 1 +- this (a grad left undivided by dp, or
#: divided twice, is off by 2x), and on the first step, from the same
#: weights, the relative L2 error below it (the model's flat dtype is
#: fp32, its norm weights': ZeRO's sums are DDP's).  ZeRO's master is
#: held to DDP's, and to the reference, as DDP's is to the reference: the
#: two-rank steps are not bit-reproducible from run to run (the per-step
#: digests show where they part)
TOL_DP_GRAD = 1e-2
#: SyncBatchNorm against one rank's BatchNorm over the 64 images (fp32):
#: y and dx within this share of their largest magnitude, dw and db
#: relative L2
TOL_SBN_REL = 1e-4
#: the update kernels of the dp phase, by the counter their wrapper adds
#: to
DP_KERNELS = ("fused_scale", "fused_adam", "fused_lamb1", "fused_l2norm")


@contextlib.contextmanager
def _kernel_lengths():
    """Record the length of every launch of the dp phase's update kernels
    (the unscale, Adam, LAMB's phase 1 and the L2 norm) while the block
    runs: ``{counter: [numel, ...]}``.  The wrappers still launch (and
    count) as they do."""
    import apex_tpu_torch.amp.scaler as scaler_mod
    from apex_tpu_torch.ops import fused_update as fu
    seen = {k: [] for k in DP_KERNELS}
    saved = {}

    def wrap(mod, attr, key):
        orig = getattr(mod, attr)
        saved[mod, attr] = orig

        def rec(flat, *args, **kw):
            if flat.is_cuda:
                seen[key].append(flat.numel())
            return orig(flat, *args, **kw)
        setattr(mod, attr, rec)

    wrap(scaler_mod, "fused_scale", "fused_scale")
    wrap(fu, "_adam_kernel", "fused_adam")
    wrap(fu, "_lamb1_kernel", "fused_lamb1")
    wrap(fu, "_l2norm_kernel", "fused_l2norm")
    try:
        yield seen
    finally:
        for (mod, attr), orig in saved.items():
            setattr(mod, attr, orig)


@contextlib.contextmanager
def _timed_collectives():
    """Time every collective of ``apex_tpu_torch.parallel._comm`` while the
    block runs (a ``torch.cuda.synchronize()`` before and after each):
    ``[(collective, seconds), ...]``, which the caller may clear."""
    from apex_tpu_torch.parallel import _comm
    rec: list = []
    run = _comm._run

    def timed(name, out, inp, group, op):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(name, out, inp, group, op)
        torch.cuda.synchronize()
        rec.append((name, time.perf_counter() - t0))
    _comm._run = timed
    try:
        yield rec
    finally:
        _comm._run = run


def _dp_tokens(dev, seed: int):
    """The phase's global batches: ``[DP_STEPS + 1, DP, TRAIN_SEQ + 1]``
    seeded tokens (the last step's for the overflow step)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 25)
    return torch.randint(0, FULL_CFG["vocab_size"],
                         (DP_STEPS + 1, DP, TRAIN_SEQ + 1), generator=gen,
                         device=dev)


def _dp_batch(tokens, step: int, rows, poison: float = 0.0) -> dict:
    t = tokens[step, rows]
    return {"tokens": t[:, :-1].contiguous(), "labels": t[:, 1:].contiguous(),
            "poison": poison}


def _dp_loss(model, batch):
    """The train loss, plus ``poison`` times the final norm's weights (0:
    the loss itself; 1e38: an inf in that leaf's scaled grads)."""
    return model(batch["tokens"], batch["labels"]) + \
        model.final_norm.weight.sum() * batch["poison"]


def _dp_sample_idx(n: int, dev):
    return torch.arange(0, n, DP_SAMPLE, device=dev)


def _dp_shard_sample(opt, buf, idx) -> torch.Tensor:
    """Every ``idx`` element of the GLOBAL unpadded vector whose rank
    shard is ``buf`` (a master or a grad shard in ``opt``'s layout), as
    fp32 on the device: the elements this rank's span windows hold
    (mapped back to global indices), zeros elsewhere.  The ranks'
    partials sum to the whole sample."""
    out = torch.zeros(idx.numel(), dtype=torch.float32, device=buf.device)
    rank, dp, off = opt.shard_rank(), opt.shard_dp, 0
    for start, size, padded in opt.span_windows():
        lk = padded // dp
        lo, hi = start + rank * lk, start + min((rank + 1) * lk, size)
        sel = (idx >= lo) & (idx < hi)
        out[sel] = buf[off + idx[sel] - lo].float()
        off += lk
    return out


def _dp_sample(opt, dev) -> torch.Tensor:
    """The digest: every DP_SAMPLE-th element of the GLOBAL unpadded
    master, on the host (a sharded state's ranks sum their partials over
    the group)."""
    from apex_tpu_torch.parallel import _comm
    idx = _dp_sample_idx(opt.global_numel, dev)
    if not opt.shard or opt.shard_dp == 1:
        return opt.master[idx].cpu()
    return _comm.all_reduce(_dp_shard_sample(opt, opt.master, idx),
                            opt.group()).cpu()


def _bits_digest(t: torch.Tensor) -> tuple:
    """Two int64 sums of a buffer's 32-bit words (plain and position
    weighted), chunk by chunk: equal buffers give equal digests."""
    words = t.view(torch.int32)
    plain = weighted = 0
    for i in range(0, words.numel(), 1 << 26):
        w = words[i:i + (1 << 26)].to(torch.int64)
        plain += int(w.sum())
        pos = torch.arange(i, i + w.numel(), device=t.device) % 65521 + 1
        weighted += int((w * pos).sum())
    return plain, weighted


def _dp_reference(dev, seed: int):
    """The one-rank reference in the parent: ``DP_STEPS`` dense Adam
    steps on the global batches (2 x 2048 tokens) of the 2-layer model,
    then ``DP_LAMB_STEPS`` ``FusedLAMB`` steps (the class over the
    model's tree) from the same
    weights; each one's losses and master digest.  Everything is freed
    before it returns."""
    from apex_tpu_torch import train_step
    from apex_tpu_torch.optimizers import FusedLAMB, functional
    tokens = _dp_tokens(dev, seed)
    rows = slice(0, DP)
    _, model, _ = _train_model(dev, seed, DP_LAYERS)
    tx = functional.fused_adam(lr=TRAIN_LR)
    state = train_step.init_train_state(tx, model, loss_scale="dynamic")
    step = train_step.make_train_step(_dp_loss, tx)
    t0 = time.perf_counter()
    losses = []
    for i in range(DP_STEPS):
        state, loss = step(state, _dp_batch(tokens, i, rows))
        losses.append(loss.item())
    torch.cuda.synchronize()
    adam_s = (time.perf_counter() - t0) / DP_STEPS
    ref = dict(losses=losses, sample=_dp_sample(state.opt, dev),
               n=state.opt.global_numel, adam_s=adam_s)
    del model, state, step
    torch.cuda.empty_cache()
    _, model, _ = _train_model(dev, seed, DP_LAYERS)
    opt = FusedLAMB(_param_tree(model), **LAMB_KW)
    lamb_losses = []
    for i in range(DP_LAMB_STEPS):
        model.zero_grad(set_to_none=True)
        loss = _dp_loss(model, _dp_batch(tokens, i, rows))
        loss.backward()
        _load_tree(model, opt.step(_param_tree(model, grads=True)))
        lamb_losses.append(loss.item())
    ref.update(lamb_losses=lamb_losses, lamb_sample=opt.param_groups[0]
               .master[_dp_sample_idx(ref["n"], dev)].cpu())
    del model, opt
    torch.cuda.empty_cache()
    return ref


def _param_tree(model, grads: bool = False) -> dict:
    """The model's parameters (or their grads) as the nested dict of its
    key paths: the tree the optimizer classes take."""
    from apex_tpu_torch.utils import tree_leaves_with_path
    tree: dict = {}
    for path, p in tree_leaves_with_path(model):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = p.grad if grads else p.detach()
    return tree


def _load_tree(model, tree) -> None:
    from apex_tpu_torch.utils import tree_leaves_with_path
    with torch.no_grad():
        for (_, p), (_, t) in zip(tree_leaves_with_path(model),
                                  tree_leaves_with_path(tree)):
            p.copy_(t)


def _dp_train(dev, seed: int, rank: int, tokens, zero: bool):
    """(a) DDP or (b) ZeRO, then with ZeRO (c) the rank-local overflow:
    ``DP_STEPS`` Adam steps on this rank's row of each global batch with
    the launch counts zeroed just before and each update kernel's lengths
    recorded; the collectives timed.  Each step's grads as they reach the
    transform (DDP's all-reduced, or this rank's ZeRO shard, each
    averaged over the ranks) and the master after it are sampled at the
    digest's elements (a shard's as its partial of the global sample)."""
    from apex_tpu_torch import train_step
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.optimizers import functional
    from apex_tpu_torch.parallel import DistributedDataParallel
    t0 = time.perf_counter()
    _, model, _ = _train_model(dev, seed, DP_LAYERS)
    tx = functional.fused_adam(lr=TRAIN_LR)
    finite, grads, masters = [], [], []
    if zero:
        state = train_step.init_train_state(
            tx, model, loss_scale="dynamic", shard=("data", DP),
            prefetch=DP_PREFETCH)

        def transform(g):
            finite.append(torch.isfinite(g).all())
            grads.append(_dp_shard_sample(state.opt, g, idx))
            return g
    else:
        state = train_step.init_train_state(tx, model, loss_scale="dynamic")
        ddp = DistributedDataParallel()

        def transform(g):
            g = ddp.reduce_gradients(g)
            grads.append(g[idx].clone())
            return g
    idx = _dp_sample_idx(state.opt.global_numel, dev)
    step = train_step.make_train_step(_dp_loss, tx, grad_transform=transform,
                                      zero=zero)
    rows = slice(rank, rank + 1)
    out = dict(setup_s=time.perf_counter() - t0, losses=[], step_s=[],
               shard_len=state.opt.master.numel(), spans=state.opt.spans,
               coll=[], scale0=state.scaler.loss_scale.item())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    with _kernel_lengths() as lengths, _timed_collectives() as coll:
        for i in range(DP_STEPS):
            coll.clear()
            t0 = time.perf_counter()
            state, loss = step(state, _dp_batch(tokens, i, rows))
            torch.cuda.synchronize()
            out["step_s"].append(time.perf_counter() - t0)
            out["losses"].append(loss.item())
            out["coll"].append(list(coll))
            masters.append(_dp_shard_sample(state.opt, state.opt.master, idx)
                           if zero else state.opt.master[idx].clone())
    out.update(launches=_build.launch_counts(), lengths=lengths,
               peak=torch.cuda.max_memory_allocated(),
               sample=_dp_sample(state.opt, dev),
               digest=_bits_digest(state.opt.master),
               scale=state.scaler.loss_scale.item(),
               flat_dtype=str(state.opt.flat_dtype),
               grads=[g.cpu() for g in grads],
               masters=[m.cpu() for m in masters])
    if zero:
        out["overflow"] = _dp_overflow(state, step, tokens, rank, finite)
    del model, state, step
    torch.cuda.empty_cache()
    return out


def _dp_overflow(state, step, tokens, rank: int, finite):
    """(c) One more ZeRO step whose batch poisons rank 1's loss alone (an
    inf in its final-norm grads): master and slots must come out
    bit-identical on every rank, the count advanced, the scale halved."""
    from apex_tpu_torch.ops import _build
    bufs = (state.opt.master, state.opt.slots["exp_avg"],
            state.opt.slots["exp_avg_sq"])
    before = [b.clone() for b in bufs]      # on the card: no host copy
    count, scale = state.opt.count.item(), state.scaler.loss_scale.item()
    finite.clear()
    _build.reset_launch_counts()
    with _kernel_lengths() as lengths:
        state, loss = step(state, _dp_batch(
            tokens, DP_STEPS, slice(rank, rank + 1),
            poison=1e38 if rank == 1 else 0.0))
        torch.cuda.synchronize()
    same = all(torch.equal(b, a) for b, a in zip(bufs, before))
    del before
    return dict(same=same, count=(count, state.opt.count.item()),
                scale=(scale, state.scaler.loss_scale.item()),
                shard_finite=bool(finite[0]), loss=loss.item(),
                launches=_build.launch_counts(), lengths=lengths)


def _dp_lamb(dev, seed: int, rank: int, tokens):
    """(d) ``DistributedFusedLAMB`` for ``DP_LAMB_STEPS`` steps on this
    rank's rows: the per-rank grads (no loss scale) reduce-scattered, the
    LAMB update of the shard, the params all-gathered into the model.
    The first step's averaged grad shard (what ``_shard_grads`` returns)
    is sampled at the digest's elements."""
    from apex_tpu_torch.contrib.optimizers import DistributedFusedLAMB
    from apex_tpu_torch.ops import _build
    _, model, _ = _train_model(dev, seed, DP_LAYERS)
    opt = DistributedFusedLAMB(DP, **LAMB_KW)
    state = opt.init_state(_param_tree(model))
    layout = opt._flat_state(state, opt._sizes)
    idx = _dp_sample_idx(layout.global_numel, dev)
    grads, shard_grads = [], opt._shard_grads

    def record(tree):
        gshard, n, unravel = shard_grads(tree)
        if not grads:
            grads.append(_dp_shard_sample(layout, gshard, idx))
        return gshard, n, unravel
    opt._shard_grads = record
    out = dict(losses=[], step_s=[], coll=[],
               shard_len=state["master"].numel())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    with _kernel_lengths() as lengths, _timed_collectives() as coll:
        for i in range(DP_LAMB_STEPS):
            coll.clear()
            t0 = time.perf_counter()
            model.zero_grad(set_to_none=True)
            loss = _dp_loss(model, _dp_batch(tokens, i,
                                             slice(rank, rank + 1)))
            loss.backward()
            params, state = opt.step(state, _param_tree(model, grads=True))
            _load_tree(model, params)
            del params
            torch.cuda.synchronize()
            out["step_s"].append(time.perf_counter() - t0)
            out["losses"].append(loss.item())
            out["coll"].append(list(coll))
    from apex_tpu_torch.optimizers.base import rank_spans
    fs = opt._flat_state(state, opt._sizes)
    out.update(launches=_build.launch_counts(), lengths=lengths,
               peak=torch.cuda.max_memory_allocated(),
               sample=_dp_sample(fs, dev), grads=[grads[0].cpu()],
               windows=len(rank_spans(opt._sizes, dp=DP,
                                      shard_len=fs.shard_len, rank=rank)))
    del model, opt, state, fs, layout
    torch.cuda.empty_cache()
    return out


def _dp_syncbn(dev, seed: int, rank: int):
    """(e) ``SyncBatchNorm`` forward and backward on this rank's 32 of 64
    seeded images (``DP_BN_SHAPE`` channel-last, fp32) against torch's
    batch norm over all 64 on this rank (the weight and bias grads summed
    over the group); the running statistics too; its time."""
    import torch.distributed as dist
    from apex_tpu_torch.parallel import SyncBatchNorm
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 26)
    shape = (DP * DP_BN_SHAPE[0],) + DP_BN_SHAPE[1:]
    x = torch.randn(shape, generator=gen, device=dev)
    cot = torch.randn(shape, generator=gen, device=dev)
    rows = slice(rank * DP_BN_SHAPE[0], (rank + 1) * DP_BN_SHAPE[0])
    c = DP_BN_SHAPE[-1]
    bn = SyncBatchNorm(c, device=dev)
    times = []
    for _ in range(3):
        bn.weight.grad = bn.bias.grad = None
        xr = x[rows].clone().requires_grad_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = bn(xr)
        (y * cot[rows]).sum().backward()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    # the reference: BatchNorm over the 64 images, NCHW views of NHWC
    xf = x.clone().requires_grad_()
    w = torch.ones(c, device=dev, requires_grad=True)
    b = torch.zeros(c, device=dev, requires_grad=True)
    rm, rv = torch.zeros(c, device=dev), torch.ones(c, device=dev)
    for _ in range(3):
        yf = F.batch_norm(xf.permute(0, 3, 1, 2), rm, rv, w, b,
                          training=True, momentum=0.1,
                          eps=1e-5).permute(0, 2, 3, 1)
    (yf * cot).sum().backward()
    dw, db = bn.weight.grad.clone(), bn.bias.grad.clone()
    dist.all_reduce(dw)
    dist.all_reduce(db)

    def rel_max(got, want):
        return float((got - want).abs().max() / want.abs().max())

    def rel_l2(got, want):
        return float(torch.linalg.vector_norm(got - want)
                     / torch.linalg.vector_norm(want))

    return dict(y=rel_max(y.detach(), yf.detach()[rows]),
                dx=rel_max(xr.grad, xf.grad[rows]), dw=rel_l2(dw, w.grad),
                db=rel_l2(db, b.grad),
                stats=max(rel_max(bn.running_mean, rm),
                          rel_max(bn.running_var, rv)),
                ms=1e3 * float(np.median(times[1:])))


def _gloo_cuda_probe(group) -> dict:
    """Ask gloo for each collective the port issues, on tiny CUDA tensors
    of this rank's card: ``{collective: "takes CUDA tensors" | gloo's
    refusal}``.  Printed only: the port stages nothing, so a collective
    gloo refuses fails the sub-phase that issues it."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    out = {}
    for name in ("all_reduce", "reduce_scatter_tensor",
                 "all_gather_into_tensor"):
        big = torch.ones(2 * n, device="cuda")
        small = torch.ones(2, device="cuda")
        try:
            if name == "all_reduce":
                dist.all_reduce(small, group=group)
            elif name == "reduce_scatter_tensor":
                dist.reduce_scatter_tensor(small, big, group=group)
            else:
                dist.all_gather_into_tensor(big, small, group=group)
            torch.cuda.synchronize()
            out[name] = "takes CUDA tensors"
        except (RuntimeError, ValueError, NotImplementedError) as e:
            out[name] = f"refused ({type(e).__name__}: {str(e)[:160]})"
    return out


def _dp_rank(rank, tmp, seed):
    """One rank of the dp phase, on cuda:0 over gloo: probes gloo on CUDA
    tensors, then runs (a) DDP, (b) ZeRO with (c) the rank-local overflow,
    (d) DistributedFusedLAMB and (e) SyncBatchNorm, one after the other
    (each frees what it built), and writes what it saw to
    ``tmp/rank<rank>.pt`` for the parent to hold."""
    import datetime
    import os
    import torch.distributed as dist
    from apex_tpu_torch.transformer import parallel_state
    # two ranks share the card: segments that grow in place keep the
    # freed blocks of one sub-phase usable by the next one's large
    # temporaries (gloo's copy of a collective's input among them)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(
        str(Path(tmp) / "store"), DP), rank=rank, world_size=DP,
        timeout=datetime.timedelta(seconds=900))
    out = {}
    try:
        parallel_state.initialize_model_parallel()
        out["probe"] = _gloo_cuda_probe(parallel_state.resolve_group("data"))
        tokens = _dp_tokens(dev, seed)
        for key, run in (
                ("ddp", lambda: _dp_train(dev, seed, rank, tokens, False)),
                ("zero", lambda: _dp_train(dev, seed, rank, tokens, True)),
                ("lamb", lambda: _dp_lamb(dev, seed, rank, tokens)),
                ("syncbn", lambda: _dp_syncbn(dev, seed, rank))):
            out[key] = run()
            res = out[key]
            print(f"dp rank {rank}: {key} ran: "
                  + (f"losses {[round(x, 4) for x in res['losses']]}, step "
                     f"times {[round(t, 3) for t in res['step_s']]} s, peak "
                     f"{res['peak'] / 2**30:.2f} GiB"
                     if "losses" in res else f"{res}"), flush=True)
    finally:
        parallel_state.destroy_model_parallel()
        dist.destroy_process_group()
    torch.save(out, Path(tmp) / f"rank{rank}.pt")


def _master_hold(label, got, want, max_tol, share_tol, share_at):
    diff = (got - want).abs()
    worst = float(diff.max())
    share = float((diff > share_at).float().mean())
    print(f"  {label}: master digest ({got.numel()} elements) max |diff| "
          f"{worst:.3e} (limit {max_tol:.1e}), share above {share_at:.1e} "
          f"{share:.5f} (limit {share_tol})")
    if not worst <= max_tol or not share <= share_tol:
        raise AssertionError(f"{label}: the master is off the reference")


def _grad_hold(label, got, want, rel_gate: bool, against: str = "DDP's",
               rel_tol: float = TOL_DP_GRAD) -> None:
    """A step's grads, sampled, against ``against`` (DDP's all-reduced
    grads of the same batch, by default): the least-squares scale within
    TOL_DP_GRAD of 1, and with ``rel_gate`` the relative L2 error below
    ``rel_tol``."""
    got, want = got.double(), want.double()
    nonzero = int((want != 0).sum())
    scale = float((got * want).sum() / (want * want).sum())
    rel = float(torch.linalg.vector_norm(got - want)
                / torch.linalg.vector_norm(want))
    print(f"  {label}: grads ({got.numel()} sampled, {nonzero} "
          f"nonzero) against {against}: scale {scale:.6f} (limit 1 +- "
          f"{TOL_DP_GRAD}), relative L2 error {rel:.3e}"
          + (f" (limit {rel_tol})" if rel_gate else ""))
    if nonzero == 0 or not abs(scale - 1) <= TOL_DP_GRAD \
            or (rel_gate and not rel <= rel_tol):
        raise AssertionError(f"{label}: the grads are off {against}")


def _coll_line(rec) -> str:
    """A step's gloo collectives: count and seconds by collective."""
    by: dict = {}
    for name, s in rec:
        n, t = by.get(name, (0, 0.0))
        by[name] = (n + 1, t + s)
    return ", ".join(f"{name} x{n} {t:.3f} s" for name, (n, t) in
                     sorted(by.items())) or "none"


def _hold_lengths(label, run, want: dict) -> None:
    """Each update kernel launched the wanted number of times a step at
    the wanted lengths (``want[counter] = (launches, length or None)``)."""
    for key, (n, length) in want.items():
        got = run["lengths"][key]
        print(f"  {label}: {key} launched {run['launches'][key]} times "
              f"(want {n}), lengths {sorted(set(got))[:4]}"
              + (f" (want {length})" if length else ""))
        if run["launches"][key] != n or len(got) != n or (
                length is not None and set(got) != {length}):
            raise AssertionError(f"{label}: {key} did not run {n} times at "
                                 f"the shard's length")


def _card_memory(when: str) -> None:
    """Collect the garbage (engines of earlier phases hold their weights
    in reference cycles), return the cached blocks, and print what the
    card has free (the dp phase's two ranks need ~67 GiB of it)."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"memory: {when}: the card has {free / 2**30:.2f} of "
          f"{total / 2**30:.2f} GiB free; this process holds "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"({torch.cuda.memory_reserved() / 2**30:.2f} reserved)")


def phase_dp(dev, seed: int):
    """Data parallelism and ZeRO at dp = 2 on the one card: both ranks on
    cuda:0 over gloo (NCCL takes one card a rank; the phase asks it and
    prints its answer).  The parent first runs the one-rank reference
    (:func:`_dp_reference`), frees it, then spawns the two ranks
    (:func:`_dp_rank`) and holds what they report.  Returns the ranks'
    launches, summed."""
    import tempfile
    import torch.multiprocessing as mp
    smi = _smi()
    t_phase = time.perf_counter()
    _card_memory("dp, before the reference")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp_dir:
        tmp = Path(tmp_dir)
        nccl = _nccl_probe(tmp)
        print(f"dp: {DP} ranks on cuda:0 over gloo (NCCL asked for two ranks "
              f"on this card: {nccl}) [{smi}]")
        ref = _dp_reference(dev, seed)
        n = ref["n"]
        print(f"dp reference (one rank, Llama-3-8B widths, {DP_LAYERS} "
              f"layers, {n} parameters, global batch {DP} x {TRAIN_SEQ} "
              f"tokens): Adam losses {[round(x, 4) for x in ref['losses']]}"
              f", {ref['adam_s']:.3f} s a step; FusedLAMB losses "
              f"{[round(x, 4) for x in ref['lamb_losses']]} [{smi}]")
        _card_memory("dp, before the ranks")
        t0 = time.perf_counter()
        mp.start_processes(_dp_rank, nprocs=DP, start_method="spawn",
                           args=(str(tmp), seed))
        ranks_s = time.perf_counter() - t0
        ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                 for r in range(DP)]
    for name, answer in ranks[0]["probe"].items():
        print(f"dp: gloo {name} on CUDA tensors: {answer}")
    print("dp: the port issues every collective on the CUDA tensors and "
          "stages nothing; gloo copies them through the host inside the "
          "call")
    total: dict = {}
    # (a) DDP
    for rank, r in enumerate(ranks):
        run = r["ddp"]
        _hold_lengths(f"dp ddp rank {rank}", run, {
            "fused_scale": (DP_STEPS, n), "fused_adam": (DP_STEPS, n)})
    if ranks[0]["ddp"]["digest"] != ranks[1]["ddp"]["digest"]:
        raise AssertionError("dp ddp: the ranks' masters differ")
    print("dp ddp: the two ranks' masters are equal bit for bit (digest "
          f"{ranks[0]['ddp']['digest']})")
    ddp_losses = [sum(r["ddp"]["losses"][i] for r in ranks) / DP
                  for i in range(DP_STEPS)]
    worst = max(abs(a - b) for a, b in zip(ddp_losses, ref["losses"]))
    print(f"  dp ddp: mean losses {[round(x, 4) for x in ddp_losses]} "
          f"against the reference's: max |diff| {worst:.4f} (limit "
          f"{TOL_DP_LOSS})")
    if not worst <= TOL_DP_LOSS:
        raise AssertionError("dp ddp: the losses are off the reference")
    _master_hold("dp ddp against one rank", ranks[0]["ddp"]["sample"],
                 ref["sample"], TOL_DP_MASTER_MAX, TOL_DP_MASTER_SHARE,
                 TRAIN_LR / 8)
    # (b) ZeRO
    shard = ranks[0]["zero"]["shard_len"]
    for rank, r in enumerate(ranks):
        _hold_lengths(f"dp zero rank {rank}", r["zero"], {
            "fused_scale": (DP_STEPS, shard), "fused_adam": (DP_STEPS, shard)})
        if r["zero"]["losses"] != ranks[0]["zero"]["losses"]:
            raise AssertionError("dp zero: the ranks report other losses")
    ddp = ranks[0]["ddp"]
    print(f"  dp: the flat dtype (of the reduce-scatter and the all-gather) "
          f"{ranks[0]['zero']['flat_dtype']}")
    for i in range(DP_STEPS):
        _grad_hold(f"dp zero step {i}", sum(r["zero"]["grads"][i]
                                            for r in ranks),
                   ddp["grads"][i], rel_gate=i == 0)
        diff = (sum(r["zero"]["masters"][i] for r in ranks)
                - ddp["masters"][i]).abs()
        print(f"  dp zero step {i}: the master after it against DDP's: max "
              f"|diff| {float(diff.max()):.3e}, share above 1e-6 "
              f"{float((diff > 1e-6).float().mean()):.5f}, above lr/8 "
              f"{float((diff > TRAIN_LR / 8).float().mean()):.5f}")
    _master_hold("dp zero against ddp", ranks[0]["zero"]["sample"],
                 ddp["sample"], TOL_DP_MASTER_MAX, TOL_DP_MASTER_SHARE,
                 TRAIN_LR / 8)
    _master_hold("dp zero against one rank", ranks[0]["zero"]["sample"],
                 ref["sample"], TOL_DP_MASTER_MAX, TOL_DP_MASTER_SHARE,
                 TRAIN_LR / 8)
    worst = max(abs(a - b) for a, b in zip(ranks[0]["zero"]["losses"],
                                            ddp_losses))
    print(f"  dp zero: losses {[round(x, 4) for x in ranks[0]['zero']['losses']]}"
          f" (spans {ranks[0]['zero']['spans']}), against ddp's: max |diff| "
          f"{worst:.2e} (limit {TOL_DP_LOSS})")
    if not worst <= TOL_DP_LOSS:
        raise AssertionError("dp zero: the losses are off ddp's")
    # (c) the rank-local overflow
    for rank, r in enumerate(ranks):
        ov = r["zero"]["overflow"]
        print(f"  dp zero overflow rank {rank}: shard finite "
              f"{ov['shard_finite']}, master and slots unchanged "
              f"{ov['same']}, count {ov['count']}, scale {ov['scale']}")
        _hold_lengths(f"dp zero overflow rank {rank}", ov, {
            "fused_scale": (1, shard), "fused_adam": (1, shard)})
        if not ov["same"] or ov["count"][1] != ov["count"][0] + 1 \
                or ov["scale"][1] != ov["scale"][0] / 2:
            raise AssertionError(f"dp zero overflow rank {rank}: the step "
                                 f"was not skipped")
    if all(r["zero"]["overflow"]["shard_finite"] for r in ranks) or \
            not any(r["zero"]["overflow"]["shard_finite"] for r in ranks):
        raise AssertionError("dp zero overflow: the inf must land in one "
                             "rank's shard alone")
    # (d) DistributedFusedLAMB
    lshard = ranks[0]["lamb"]["shard_len"]
    for rank, r in enumerate(ranks):
        run = r["lamb"]
        _hold_lengths(f"dp lamb rank {rank}", run, {
            "fused_lamb1": (DP_LAMB_STEPS, lshard),
            "fused_l2norm": (DP_LAMB_STEPS * (1 + 2 * run["windows"]),
                             None)})
        if max(run["lengths"]["fused_l2norm"]) != lshard:
            raise AssertionError("dp lamb: the grad norm is not over the "
                                 "shard")
    # LAMB's grads carry no loss scale: DDP's first step's, a power of 2
    _grad_hold("dp lamb step 0", sum(r["lamb"]["grads"][0] for r in ranks)
               * ddp["scale0"], ddp["grads"][0], rel_gate=True)
    lamb_losses = [sum(r["lamb"]["losses"][i] for r in ranks) / DP
                   for i in range(DP_LAMB_STEPS)]
    worst = max(abs(a - b) for a, b in zip(lamb_losses, ref["lamb_losses"]))
    print(f"  dp lamb: mean losses {[round(x, 4) for x in lamb_losses]} "
          f"against FusedLAMB's: max |diff| {worst:.4f} (limit "
          f"{TOL_DP_LOSS})")
    if not worst <= TOL_DP_LOSS:
        raise AssertionError("dp lamb: the losses are off FusedLAMB's")
    _master_hold("dp lamb against FusedLAMB", ranks[0]["lamb"]["sample"],
                 ref["lamb_sample"], 2 * TRAIN_LR * DP_LAMB_STEPS,
                 TOL_DP_MASTER_SHARE, TRAIN_LR / 8)
    # (e) SyncBatchNorm
    for rank, r in enumerate(ranks):
        sb = r["syncbn"]
        print(f"  dp syncbn rank {rank} {list(DP_BN_SHAPE)} fp32: y "
              f"{sb['y']:.2e}, dx {sb['dx']:.2e} (of their max), dw "
              f"{sb['dw']:.2e}, db {sb['db']:.2e} (relative L2), running "
              f"stats {sb['stats']:.2e}; limit {TOL_SBN_REL}; forward + "
              f"backward {sb['ms']:.3f} ms [{smi}]")
        if not max(sb["y"], sb["dx"], sb["dw"], sb["db"],
                   sb["stats"]) <= TOL_SBN_REL:
            raise AssertionError(f"dp syncbn rank {rank}: off BatchNorm "
                                 f"over the whole batch")
    # the numbers
    for label, key in (("ddp", "ddp"), ("zero", "zero"), ("lamb", "lamb")):
        for rank, r in enumerate(ranks):
            run = r[key]
            print(f"dp {label} rank {rank}: step times "
                  f"{[round(t, 3) for t in run['step_s']]} s, peak "
                  f"{run['peak'] / 2**30:.2f} GiB, shard length "
                  f"{run['shard_len']} [{smi}]")
            for i, rec in enumerate(run["coll"]):
                print(f"  step {i}: gloo collectives (host copies inside "
                      f"gloo; not an NCCL figure): {_coll_line(rec)}")
            for k, v in run["launches"].items():
                total[k] = total.get(k, 0) + v
    for r in ranks:
        for k, v in r["zero"]["overflow"]["launches"].items():
            total[k] = total.get(k, 0) + v
    print(f"dp: launches of the update kernels in the ranks: "
          f"{ {k: total.get(k, 0) for k in DP_KERNELS} }")
    print(f"dp: the ranks ran in {ranks_s:.1f} s, the phase "
          f"{time.perf_counter() - t_phase:.1f} s [{smi}]")
    return dict(launches=total)


#: tensor-parallel training (the tp_train phase): two ranks on the one
#: card, Llama-3-8B widths at the train phase's 4 layers and 2048 tokens
TP_TRAIN = 2
#: (a) the column-parallel head's steps, (b) the fused head's, (c) the
#: ring's (from (a)'s first weights and batch)
TP_TRAIN_STEPS = 2
TP_TRAIN_FUSED_STEPS = 1
TP_TRAIN_FUSED_CHUNK = 1024
TP_TRAIN_OVERLAP = 2
#: a loss against another's (the reference's, (a)'s): the mean of 2048
#: tokens' fp32 losses, which the row-parallel outputs' two bf16-rounded
#: partials (tp = 1 rounds once) move by ~7e-5 on an H100 (PERF.md)
TOL_TP_LOSS = TOL_DP_LOSS
#: the step-0 grads against the tp = 1 reference's (relative L2 of the
#: digest): two bf16 computations of the same grads, the row-parallel
#: outputs rounded as two partials, part by 1.30-1.46% at hidden 64-1024
#: (the port on the CPU), not by TOL_DP_GRAD's 1%; the scale is
#: held to 1 +- TOL_DP_GRAD (a grad all-reduced twice, or not at all, is
#: off by 2x)
TOL_TP_GRAD_REL = 3e-2
#: (d) the ring's forward against the fused all-reduce's, as a share of
#: the fused output's max: the chunk GEMMs may take another cuBLAS
#: algorithm than the whole GEMM (another M), a bf16 ulp of a partial
TOL_TP_RING_FWD = 2.0 ** -6
#: (d) the fp32 wgrad against an fp32 product of the same bf16 operands
#: (relative L2): the same products, summed in fp32 in another order over
#: K = 2048 tokens of random sign, part by ~sqrt(K) * 2^-24 ~ 3e-6 (2.14e-6
#: on an H100, PERF.md); a wgrad rounded to bf16 is off by
#: ~2^-9, 200x this limit
TOL_TP_WGRAD_FP32 = 1e-5
#: (d)'s shape: a 2048-token down projection's rank shard
TP_ROW_SHAPE = (TRAIN_SEQ, 1, 14336 // 2)


def _tp_train_tokens(dev, seed: int):
    """The phase's batches: ``[TP_TRAIN_STEPS, 1, TRAIN_SEQ + 1]`` seeded
    tokens."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 27)
    return torch.randint(0, FULL_CFG["vocab_size"],
                         (TP_TRAIN_STEPS, 1, TRAIN_SEQ + 1), generator=gen,
                         device=dev)


def _tp_batch(tokens, i: int) -> dict:
    t = tokens[i]
    return {"tokens": t[:, :-1].contiguous(), "labels": t[:, 1:].contiguous()}


def _tp_sample_idx(gshapes, dev) -> dict:
    """Every DP_SAMPLE-th element of each tp = 1 leaf of ``gshapes`` (its
    flat row-major index), by leaf key."""
    return {key: torch.arange(0, math.prod(shape), DP_SAMPLE, device=dev)
            for key, shape in gshapes.items()}


def _tp_sample(flat, offsets, gshapes, idx, rank: int) -> torch.Tensor:
    """The digest's elements of a flat buffer (grads or master) in
    ``offsets``' layout, as fp32: a rank's shard gives the elements it
    holds and zeros elsewhere (a replicated leaf: rank 0's), so the
    ranks' samples sum to the tp = 1 sample.  ``gshapes`` are the tp = 1
    leaf shapes; at tp = 1 the layout is theirs."""
    out = []
    for key, (off, size, lshape) in offsets.items():
        gshape, i = gshapes[key], idx[key]
        leaf = flat[off:off + size]
        if tuple(lshape) == tuple(gshape):
            part = leaf[i].float() if rank == 0 else \
                torch.zeros(i.numel(), device=flat.device)
        else:
            cols = gshape[1]
            row, col = i // cols, i % cols
            if lshape[0] != gshape[0]:
                owner = row // lshape[0]
                local = (row - owner * lshape[0]) * cols + col
            else:
                owner = col // lshape[1]
                local = row * lshape[1] + (col - owner * lshape[1])
            mine = owner == rank
            part = torch.zeros(i.numel(), device=flat.device)
            part[mine] = leaf[local[mine]].float()
        out.append(part)
    return torch.cat(out).cpu()


def _tp_train_reference(dev, seed: int):
    """The tp = 1 reference in the parent: TP_TRAIN_STEPS Adam steps of
    the 4-layer model from the train phase's seeded weights on the
    phase's batches; the losses, the digest of the step-0 grads and of
    the master after each step, the step time and the peak memory.
    Everything is freed before it returns."""
    from apex_tpu_torch import train_step
    from apex_tpu_torch.optimizers import functional
    tokens = _tp_train_tokens(dev, seed)
    _, model, _ = _train_model(dev, seed, TRAIN_LAYERS)
    tx = functional.fused_adam(lr=TRAIN_LR)
    state = train_step.init_train_state(tx, model, loss_scale="dynamic")
    offsets = train_step.leaf_offsets(model)
    gshapes = {k: shape for k, (_, _, shape) in offsets.items()}
    idx = _tp_sample_idx(gshapes, dev)
    grads = []
    step = train_step.make_train_step(
        _train_loss, tx, grad_transform=lambda g: grads.append(
            _tp_sample(g, offsets, gshapes, idx, 0)) or g)
    losses, times, masters = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(TP_TRAIN_STEPS):
        t0 = time.perf_counter()
        state, loss = step(state, _tp_batch(tokens, i))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
        masters.append(_tp_sample(state.opt.master, offsets, gshapes, idx, 0))
    ref = dict(losses=losses, grads=grads[0], gshapes=gshapes,
               masters=masters, step_s=times,
               peak=torch.cuda.max_memory_allocated(),
               n=state.opt.global_numel)
    del model, state, step
    torch.cuda.empty_cache()
    return ref


def _norm_digests(master, offsets) -> dict:
    """The bits digest of each norm weight's master slice."""
    return {k: _bits_digest(master[off:off + size])
            for k, (off, size, _) in offsets.items() if "norm" in k}


def _tp_run(label, model, batches, steps: int, rank: int, gshapes,
            grads_at=(0,)):
    """``steps`` Adam steps of the tp model (a fresh state from its
    current weights) with the launch counters zeroed just before and
    the update kernels' lengths and the collectives recorded; the
    losses, step times, the digest of the grads at the steps
    ``grads_at`` and of the master after each step, the norm weights'
    master digests, launches and peak memory."""
    from apex_tpu_torch import train_step
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.optimizers import functional
    tx = functional.fused_adam(lr=TRAIN_LR)
    state = train_step.init_train_state(tx, model, loss_scale="dynamic")
    offsets = train_step.leaf_offsets(model)
    idx = _tp_sample_idx(gshapes, batches[0]["tokens"].device)
    grads, count = {}, [0]

    def transform(g):
        if count[0] in grads_at:
            grads[count[0]] = _tp_sample(g, offsets, gshapes, idx, rank)
        count[0] += 1
        return g

    step = train_step.make_train_step(_train_loss, tx,
                                      grad_transform=transform)
    out = dict(losses=[], step_s=[], coll=[], masters=[],
               n=state.opt.global_numel)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    with _kernel_lengths() as lengths, _timed_collectives() as coll:
        for i in range(steps):
            coll.clear()
            t0 = time.perf_counter()
            state, loss = step(state, batches[i])
            torch.cuda.synchronize()
            out["step_s"].append(time.perf_counter() - t0)
            out["losses"].append(loss.item())
            out["coll"].append(list(coll))
            out["masters"].append(_tp_sample(state.opt.master, offsets,
                                             gshapes, idx, rank))
    out.update(launches=_build.launch_counts(), lengths=lengths,
               peak=torch.cuda.max_memory_allocated(), grads=grads,
               norms=_norm_digests(state.opt.master, offsets),
               scale=state.scaler.loss_scale.item())
    print(f"tp_train rank {rank}: {label}: losses "
          f"{[round(x, 5) for x in out['losses']]}, step times "
          f"{[round(t, 3) for t in out['step_s']]} s, peak "
          f"{out['peak'] / 2**30:.2f} GiB", flush=True)
    del state, step
    torch.cuda.empty_cache()
    return out


def _tp_row_linear(dev, seed: int, rank: int):
    """(d) ``RowParallelLinear`` alone at TP_ROW_SHAPE -> 4096 bf16: the
    ring (``overlap_chunks=2``) against the fused all-reduce, forward and
    backward, with and without ``gradient_accumulation_fusion`` (an fp32
    weight); ``ring_psum`` of a ``[2048, 4096]`` bf16 tensor against
    ``dist.all_reduce``."""
    import torch.distributed as dist
    from apex_tpu_torch.parallel import _comm
    from apex_tpu_torch.transformer import parallel_state
    from apex_tpu_torch.transformer.tensor_parallel import (
        RowParallelLinear, mappings)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 28 + rank)
    s, b, k = TP_ROW_SHAPE
    hidden = FULL_CFG["hidden_size"]
    x = torch.randn(TP_ROW_SHAPE, generator=gen, device=dev).to(
        torch.bfloat16)
    dy = torch.randn(s, b, hidden, generator=gen, device=dev).to(
        torch.bfloat16)
    w = torch.randn(hidden, k, generator=gen, device=dev) * k ** -0.5
    out = {"staged": _comm.hop_staged(x, parallel_state.resolve_group(
        "tensor"))}
    for fusion in (False, True):
        res = {}
        for chunks in (1, TP_TRAIN_OVERLAP):
            layer = RowParallelLinear(
                TP_TRAIN * k, hidden, bias=False, input_is_parallel=True,
                params_dtype=torch.float32 if fusion else torch.bfloat16,
                device=dev, gradient_accumulation_fusion=fusion,
                overlap_chunks=chunks)
            with torch.no_grad():
                layer.weight.copy_(w)
            xi = x.clone().requires_grad_()
            y, _ = layer(xi)
            y.backward(dy)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                yy, _ = layer(xi)
            torch.cuda.synchronize()
            res[chunks] = dict(y=y.detach(), dx=xi.grad, dw=layer.weight.grad,
                               fwd_s=(time.perf_counter() - t0) / 3)
            del layer, yy
        f, r = res[1], res[TP_TRAIN_OVERLAP]
        tag = "fused" if fusion else "bf16"
        out[tag] = dict(
            fwd_equal=torch.equal(r["y"], f["y"]),
            fwd_err=float((r["y"].float() - f["y"].float()).abs().max()
                          / f["y"].float().abs().max()),
            dx_equal=torch.equal(r["dx"], f["dx"]),
            dw_equal=torch.equal(r["dw"], f["dw"]),
            dw_dtype=str(f["dw"].dtype), fwd_s=(f["fwd_s"], r["fwd_s"]))
        if fusion:
            want = dy.reshape(-1, hidden).float().T @ x.reshape(-1, k).float()
            out[tag]["wgrad_rel"] = float(
                torch.linalg.vector_norm(f["dw"] - want)
                / torch.linalg.vector_norm(want))
        del res, f, r
    t = torch.randn(TRAIN_SEQ, hidden, generator=gen, device=dev).to(
        torch.bfloat16)
    want = t.clone()
    dist.all_reduce(want, group=parallel_state.resolve_group("tensor"))
    got = mappings.ring_psum(t, "tensor", chunks=TP_TRAIN_OVERLAP)
    out["ring_psum_equal"] = torch.equal(got, want)
    return out


#: (e) the sequence-parallel pair's shape: GPT-3 1.3B's MLP at 4096
#: tokens, 2048 a rank
TP_SP_TOKENS, TP_SP_HIDDEN, TP_SP_FFN = 4096, 2048, 8192


def _tp_sp_pair(dev, seed: int, rank: int):
    """(e) ``ColumnParallelLinear -> GELU -> RowParallelLinear`` with
    ``sequence_parallel_enabled=True`` on this rank's ``[TP_SP_TOKENS /
    TP_TRAIN, 1, 2048]`` rows (-> 8192 -> 2048, bf16, this rank's weight
    shards), forward and backward, and the same pair without sequence
    parallelism on the gathered input: each output's, input grad's and
    weight grad's max |diff| as a share of the pair's max (the rank's
    rows), whether they are equal, and both forward + backward times."""
    from apex_tpu_torch.transformer.tensor_parallel import (
        ColumnParallelLinear, RowParallelLinear)
    from apex_tpu_torch.transformer.testing.standalone_gpt import gelu
    bf = torch.bfloat16
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 32)
    s, hid, ffn = TP_SP_TOKENS, TP_SP_HIDDEN, TP_SP_FFN
    x = torch.randn(s, 1, hid, generator=gen, device=dev).to(bf)
    dy = torch.randn(s, 1, hid, generator=gen, device=dev).to(bf)
    wc = (torch.randn(ffn, hid, generator=gen, device=dev) * hid ** -0.5)
    bc = 0.1 * torch.randn(ffn, generator=gen, device=dev)
    wr = (torch.randn(hid, ffn, generator=gen, device=dev) * ffn ** -0.5)
    br = 0.1 * torch.randn(hid, generator=gen, device=dev)
    o, rows = ffn // TP_TRAIN, s // TP_TRAIN
    cols = slice(rank * o, (rank + 1) * o)
    mine = slice(rank * rows, (rank + 1) * rows)
    res = {}
    for sp in (True, False):
        col = ColumnParallelLinear(hid, ffn, gather_output=False,
                                   params_dtype=bf, device=dev,
                                   sequence_parallel_enabled=sp)
        row = RowParallelLinear(ffn, hid, input_is_parallel=True,
                                params_dtype=bf, device=dev,
                                sequence_parallel_enabled=sp)
        with torch.no_grad():
            col.weight.copy_(wc[cols])
            col.bias.copy_(bc[cols])
            row.weight.copy_(wr[:, cols])
            row.bias.copy_(br)
        xi = (x[mine] if sp else x).clone().requires_grad_()
        dyi = (dy[mine] if sp else dy).contiguous()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h, _ = col(xi)
        y, _ = row(gelu(h))
        y.backward(dyi)
        torch.cuda.synchronize()
        res[sp] = dict(y=y.detach(), dx=xi.grad, dwc=col.weight.grad,
                       dwr=row.weight.grad, s=time.perf_counter() - t0)
    out = dict(s=(res[True]["s"], res[False]["s"]))
    for key in ("y", "dx", "dwc", "dwr"):
        got, want = res[True][key], res[False][key]
        if key in ("y", "dx"):
            want = want[mine]
        out[key] = ((got.float() - want.float()).abs().max().item()
                    / want.float().abs().max().item(),
                    torch.equal(got, want))
    return out


def _tp_train_rank(rank, tmp, seed):
    """One rank of the tp_train phase, on cuda:0 over gloo: builds the
    train phase's seeded tp = 1 weights and keeps its shard (one rank
    after the other, a barrier between), initialises the topology, gets
    the batches from tensor rank 0 (``broadcast_data``), runs (a)-(d)
    and writes what it saw to ``tmp/rank<rank>.pt``."""
    import dataclasses
    import datetime
    import os
    import torch.distributed as dist
    from apex_tpu_torch.inference.weights import shard_llama_params
    from apex_tpu_torch.train_step import leaf_offsets
    from apex_tpu_torch.transformer import parallel_state
    from apex_tpu_torch.transformer.tensor_parallel import broadcast_data
    from apex_tpu_torch.transformer.testing import llama_model_provider
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(
        str(Path(tmp) / "store"), TP_TRAIN), rank=rank, world_size=TP_TRAIN,
        timeout=datetime.timedelta(seconds=600))
    out = {}
    try:
        t0 = time.perf_counter()
        for r in range(TP_TRAIN):
            if r == rank:         # the tp = 1 weights, before the topology
                cfg, model, _ = _train_model(dev, seed, TRAIN_LAYERS)
                gshapes = {k: shape for k, (_, _, shape) in
                           leaf_offsets(model).items()}
                shard = shard_llama_params(_param_tree(model), cfg, TP_TRAIN,
                                           rank)
                del model
                torch.cuda.empty_cache()
            dist.barrier()
        parallel_state.initialize_model_parallel(TP_TRAIN)
        tokens = _tp_train_tokens(dev, seed) if rank == 0 else torch.zeros(
            (TP_TRAIN_STEPS, 1, TRAIN_SEQ + 1), dtype=torch.int64, device=dev)
        tokens = broadcast_data(["tokens"], {"tokens": tokens},
                                torch.int64)["tokens"]
        batches = [_tp_batch(tokens, i) for i in range(TP_TRAIN_STEPS)]
        model = llama_model_provider(cfg, device=dev)
        _load_tree(model, shard)
        out["setup_s"] = time.perf_counter() - t0
        out["a"] = _tp_run("(a) column-parallel head", model, batches,
                           TP_TRAIN_STEPS, rank, gshapes)
        _load_tree(model, shard)
        model.cfg = dataclasses.replace(
            cfg, fused_head_xent=TP_TRAIN_FUSED_CHUNK)
        out["b"] = _tp_run("(b) fused vocab-parallel head", model, batches,
                           TP_TRAIN_FUSED_STEPS, rank, gshapes)
        del model
        torch.cuda.empty_cache()
        os.environ["APEX_TPU_TP_OVERLAP_CHUNKS"] = str(TP_TRAIN_OVERLAP)
        model = llama_model_provider(cfg, device=dev)
        del os.environ["APEX_TPU_TP_OVERLAP_CHUNKS"]
        out["c_chunks"] = model.layer_0.mlp.down_proj.overlap_chunks
        _load_tree(model, shard)
        out["c"] = _tp_run(f"(c) overlap_chunks={TP_TRAIN_OVERLAP}", model,
                           batches, 1, rank, gshapes)
        del model, shard
        torch.cuda.empty_cache()
        out["d"] = _tp_row_linear(dev, seed, rank)
        out["e"] = _tp_sp_pair(dev, seed, rank)
    finally:
        parallel_state.destroy_model_parallel()
        dist.destroy_process_group()
    torch.save(out, Path(tmp) / f"rank{rank}.pt")


def _gloo_p2p_probe_rank(rank, store, queue):
    """One of two gloo ranks on cuda:0: ``send``/``recv`` of a CUDA
    tensor, unstaged; reports what arrived, or gloo's refusal."""
    import datetime
    import torch.distributed as dist
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                                rank=rank, world_size=2,
                                timeout=datetime.timedelta(seconds=30))
        t = torch.full((4,), float(rank + 1), device="cuda")
        if rank == 0:
            dist.send(t, 1)
            queue.put((rank, "sent", t.tolist()))
        else:
            dist.recv(t, 0)
            torch.cuda.synchronize()
            queue.put((rank, "delivered right" if t.tolist() == [1.0] * 4
                       else "delivered wrong values", t.tolist()))
        dist.destroy_process_group()
    except Exception as e:      # the probe reports gloo's refusal
        queue.put((rank, "refused", f"{type(e).__name__}: {str(e)[:300]}"))


def _gloo_p2p_probe(tmp: Path) -> str:
    """What gloo's ``send``/``recv`` do with CUDA tensors, asked by two
    spawned processes within 60 s (a process that dies is reported by
    its exit code); every process it starts is ended before it
    returns."""
    import queue as queue_mod
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_gloo_p2p_probe_rank,
                         args=(r, str(tmp / "p2p_store"), q))
             for r in range(2)]
    for proc in procs:
        proc.start()
    got, t0 = [], time.perf_counter()
    while len(got) < 2 and time.perf_counter() - t0 < 60:
        if len(got) + sum(not p.is_alive() and p.exitcode not in (0, None)
                          for p in procs) >= 2:
            break
        try:
            got.append(q.get(timeout=2))
        except queue_mod.Empty:
            pass
    for proc in procs:
        proc.join(timeout=10)
        if proc.is_alive():
            proc.kill()
            proc.join()
    dead = [f"rank {r} exited {p.exitcode}" for r, p in enumerate(procs)
            if p.exitcode not in (0, None)]
    return repr(sorted(got)) + (f"; {', '.join(dead)}" if dead else "")


def _tp_hold_losses(label, got, want, tol) -> None:
    worst = max(abs(a - b) for a, b in zip(got, want))
    print(f"  {label}: losses {[round(x, 5) for x in got]} against "
          f"{[round(x, 5) for x in want]}: max |diff| {worst:.2e} (limit "
          f"{tol})")
    if not worst <= tol:
        raise AssertionError(f"{label}: the losses are off")


def _tp_hold_launches(label, run, steps: int, n_local: int) -> None:
    """A rank's launches a step: #3 and #4 once a layer, #1 and #2 2 x
    layers + 1 times, #9 and #13 once at the rank's flat length, #5 and
    #6 never."""
    want = {"flash_attention": TRAIN_LAYERS, "flash_attention_bwd":
            TRAIN_LAYERS, "layer_norm": 2 * TRAIN_LAYERS + 1,
            "layer_norm_bwd": 2 * TRAIN_LAYERS + 1}
    got = {k: run["launches"][k] / steps for k in want}
    print(f"  {label}: launches a step {got} (want {want}), "
          + ", ".join(f"{k} {run['launches'][k]}" for k in SPLIT_KERNELS)
          + " (want 0)")
    if got != want or any(run["launches"][k] for k in SPLIT_KERNELS):
        raise AssertionError(f"{label}: launches off: {run['launches']}")
    _hold_lengths(label, run, {"fused_scale": (steps, n_local),
                               "fused_adam": (steps, n_local)})


def _tp_train_gates(ranks, ref, runs, smi) -> None:
    """What the parent holds the tp_train ranks to (the module
    docstring's item 21); ``runs`` maps each run to its steps."""
    d0 = ranks[0]["d"]
    print(f"tp_train: the ring hop over gloo on CUDA tensors copies through "
          f"host tensors: {d0['staged']}")
    for key, steps in runs.items():
        if any(r[key]["losses"] != ranks[0][key]["losses"] for r in ranks):
            raise AssertionError(f"tp_train ({key}): the ranks' losses differ")
        for name in ranks[0][key]["norms"]:
            if len({str(r[key]["norms"][name]) for r in ranks}) != 1:
                raise AssertionError(f"tp_train ({key}): the norm master "
                                     f"{name} differs between the ranks")
        print(f"tp_train ({key}): the {TP_TRAIN} ranks' losses equal bit for "
              f"bit; the {len(ranks[0][key]['norms'])} norm weights' masters "
              f"equal bit for bit")
        for rank, r in enumerate(ranks):
            _tp_hold_launches(f"tp_train ({key}) rank {rank}", r[key], steps,
                              r[key]["n"])
    # (a) the column-parallel head
    a = [r["a"] for r in ranks]
    _tp_hold_losses("tp_train (a) against the tp = 1 reference",
                    a[0]["losses"], ref["losses"], TOL_TP_LOSS)
    _grad_hold("tp_train (a) step 0", sum(r["grads"][0] for r in a),
               ref["grads"], rel_gate=True, against="the tp = 1 reference's",
               rel_tol=TOL_TP_GRAD_REL)
    # the first step moves an element by about lr * sign(g): only grads
    # inside the bf16 noise band flip, and the share is held there; each
    # later step flips such elements anew (1.37% after 3 steps on an
    # H100, PERF.md), so later steps hold the bound and print the share
    # an element moves at most ~lr a step, so two runs part by at most
    # 2 lr a step, plus the fp32 rounding of a master near 1 (2 ulps)
    slack = 2 * float(np.spacing(np.float32(1)))
    _master_hold("tp_train (a) against tp = 1 after step 1",
                 sum(r["masters"][0] for r in a), ref["masters"][0],
                 2 * TRAIN_LR + slack, TOL_DP_MASTER_SHARE, TRAIN_LR / 8)
    for i in range(1, TP_TRAIN_STEPS):
        diff = (sum(r["masters"][i] for r in a) - ref["masters"][i]).abs()
        worst, limit = float(diff.max()), 2 * TRAIN_LR * (i + 1) + slack
        print(f"  tp_train (a) against tp = 1 after step {i + 1}: master "
              f"digest max |diff| {worst:.3e} (limit {limit:.4e}), share "
              f"above {TRAIN_LR / 8:.1e} "
              f"{float((diff > TRAIN_LR / 8).float().mean()):.5f}")
        if not worst <= limit:
            raise AssertionError(f"tp_train (a): the master after step "
                                 f"{i + 1} is off the reference")
    # (b) the fused vocab-parallel head
    _tp_hold_losses("tp_train (b) fused head against (a)",
                    ranks[0]["b"]["losses"],
                    a[0]["losses"][:TP_TRAIN_FUSED_STEPS], TOL_TP_LOSS)
    # one step: its grads hold the fused head's backward
    _grad_hold("tp_train (b) step 0", sum(r["b"]["grads"][0] for r in ranks),
               ref["grads"], rel_gate=True, against="the tp = 1 reference's",
               rel_tol=TOL_TP_GRAD_REL)
    # (c) the ring
    print(f"tp_train (c): overlap_chunks read at construction: "
          f"{ranks[0]['c_chunks']}")
    if ranks[0]["c_chunks"] != TP_TRAIN_OVERLAP:
        raise AssertionError("tp_train (c): the env knob was not read")
    _tp_hold_losses("tp_train (c) ring against (a)'s first step",
                    ranks[0]["c"]["losses"], a[0]["losses"][:1], TOL_TP_LOSS)
    _grad_hold("tp_train (c) step 0", sum(r["c"]["grads"][0] for r in ranks),
               sum(r["grads"][0] for r in a), rel_gate=True,
               against="(a)'s")
    # (d) RowParallelLinear alone and ring_psum
    for rank, r in enumerate(ranks):
        d = r["d"]
        for tag in ("bf16", "fused"):
            e = d[tag]
            print(f"  tp_train (d) rank {rank} {tag}: ring forward equal "
                  f"{e['fwd_equal']}, max |diff| / max {e['fwd_err']:.3e} "
                  f"(limit {TOL_TP_RING_FWD:.3e}); dx equal {e['dx_equal']}, "
                  f"dw ({e['dw_dtype']}) equal {e['dw_equal']}; forward "
                  f"fused {1e3 * e['fwd_s'][0]:.2f} ms, ring "
                  f"{1e3 * e['fwd_s'][1]:.2f} ms (gloo, staged hops) [{smi}]"
                  + (f"; fp32 wgrad against the fp32 product: relative L2 "
                     f"{e['wgrad_rel']:.2e} (limit {TOL_TP_WGRAD_FP32})"
                     if tag == "fused" else ""))
            if not (e["dx_equal"] and e["dw_equal"]
                    and e["fwd_err"] <= TOL_TP_RING_FWD):
                raise AssertionError(f"tp_train (d) {tag}: the ring is off "
                                     f"the fused path")
            if tag == "fused" and not (e["dw_dtype"] == "torch.float32"
                                       and e["wgrad_rel"]
                                       <= TOL_TP_WGRAD_FP32):
                raise AssertionError("tp_train (d): the fp32 wgrad is off")
        print(f"  tp_train (d) rank {rank}: ring_psum of [{TRAIN_SEQ}, "
              f"{FULL_CFG['hidden_size']}] bf16 equals all_reduce bit for "
              f"bit: {d['ring_psum_equal']}")
        if not d["ring_psum_equal"]:
            raise AssertionError("tp_train (d): ring_psum is not all_reduce")
    # (e) sequence parallelism against the pair without it
    for rank, r in enumerate(ranks):
        e = r["e"]
        print(f"  tp_train (e) rank {rank}: Column -> GELU -> Row with "
              f"sequence parallelism on [{TP_SP_TOKENS // TP_TRAIN}, 1, "
              f"{TP_SP_HIDDEN}] -> {TP_SP_FFN} -> {TP_SP_HIDDEN} bf16 against "
              f"the pair without it on the gathered [{TP_SP_TOKENS}, 1, "
              f"{TP_SP_HIDDEN}]: (max |diff| / max, equal) "
              + ", ".join(f"{k} ({e[k][0]:.3e}, {e[k][1]})"
                          for k in ("y", "dx", "dwc", "dwr"))
              + f" (limit {TOL_TP_RING_FWD:.3e}); forward + backward "
              f"{1e3 * e['s'][0]:.2f} ms with, {1e3 * e['s'][1]:.2f} ms "
              f"without (gloo) [{smi}]")
        if not all(e[k][0] <= TOL_TP_RING_FWD
                   for k in ("y", "dx", "dwc", "dwr")):
            raise AssertionError("tp_train (e): sequence parallelism is off "
                                 "the pair without it")


def phase_tp_train(dev, seed: int):
    """Tensor-parallel training at tp = 2 on the one card (the module
    docstring's item 21): the tp = 1 reference in the parent
    (:func:`_tp_train_reference`), freed, then the two ranks
    (:func:`_tp_train_rank`) on cuda:0 over gloo, held here.  Returns the
    ranks' launches of (a)-(c), summed."""
    import tempfile
    import torch.multiprocessing as mp
    smi = _smi()
    t_phase = time.perf_counter()
    _card_memory("tp_train, before the reference")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tpt_") as tmp_dir:
        tmp = Path(tmp_dir)
        nccl = _nccl_probe(tmp)
        p2p = _gloo_p2p_probe(tmp)
        print(f"tp_train: {TP_TRAIN} ranks on cuda:0 over gloo (NCCL asked "
              f"for two ranks on this card: {nccl}); gloo send/recv of an "
              f"unstaged CUDA tensor: {p2p} [{smi}]")
        ref = _tp_train_reference(dev, seed)
        print(f"tp_train reference (tp = 1, Llama-3-8B widths, "
              f"{TRAIN_LAYERS} layers, {ref['n']} parameters, {TRAIN_SEQ} "
              f"tokens a step): losses {[round(x, 5) for x in ref['losses']]}"
              f", step times {[round(t, 3) for t in ref['step_s']]} s, peak "
              f"{ref['peak'] / 2**30:.2f} GiB [{smi}]")
        _card_memory("tp_train, before the ranks")
        t0 = time.perf_counter()
        mp.start_processes(_tp_train_rank, nprocs=TP_TRAIN,
                           start_method="spawn", args=(str(tmp), seed))
        ranks_s = time.perf_counter() - t0
        ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                 for r in range(TP_TRAIN)]
    runs = {"a": TP_TRAIN_STEPS, "b": TP_TRAIN_FUSED_STEPS, "c": 1}
    _tp_train_gates(ranks, ref, runs, smi)
    # the numbers
    total: dict = {}
    for key, steps in runs.items():
        for rank, r in enumerate(ranks):
            run = r[key]
            print(f"tp_train ({key}) rank {rank}: step times "
                  f"{[round(t, 3) for t in run['step_s']]} s (tp = 1: "
                  f"{[round(t, 3) for t in ref['step_s']]}), peak "
                  f"{run['peak'] / 2**30:.2f} GiB (tp = 1: "
                  f"{ref['peak'] / 2**30:.2f}), flat length {run['n']} "
                  f"[{smi}]")
            for i, rec in enumerate(run["coll"]):
                print(f"  step {i}: gloo collectives (host copies inside "
                      f"gloo or staged; not an NCCL figure): "
                      f"{_coll_line(rec)}")
            for k, v in run["launches"].items():
                total[k] = total.get(k, 0) + v
    print(f"tp_train: the ranks set up in "
          f"{max(r['setup_s'] for r in ranks):.1f} s and ran in "
          f"{ranks_s:.1f} s, the phase {time.perf_counter() - t_phase:.1f} s "
          f"[{smi}]")
    return dict(launches=total)


#: pipelined training (the pp_train phase): two ranks on the one card,
#: Llama-3-8B widths at the train phase's 4 layers, two a rank
PP_TRAIN = 2
#: microbatches of [1, TRAIN_SEQ] tokens a step: 16384 tokens a step
PP_MICRO = 8
#: (a)'s 1F1B steps (the second on the phase's second batch)
PP_STEPS = 2
#: (c)'s chunks a rank: chunk c of rank r is layer c * PP_TRAIN + r
PP_V = 2
#: the pipelined grads against the reference's (relative L2 of the
#: digest; the least-squares scale within 1 +- TOL_DP_GRAD): both sides
#: run the same kernels on the same operands in the same order, and the
#: loss cotangent 1/8 and the scale 2^16 are powers of 2, so on the CPU
#: (the port, bf16, same shapes cut to hidden 64) they agree bit for bit;
#: on the card #4's dq, added by bulk reductions in any order, parts them
#: (PERF.md).  TOL_DP_GRAD is the ceiling
TOL_PP_GRAD = TOL_DP_GRAD


def _pp_tokens(dev, seed: int):
    """The phase's batches: ``[PP_STEPS, PP_MICRO, 1, TRAIN_SEQ + 1]``
    seeded tokens (every rank draws the same)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 29)
    return torch.randint(0, FULL_CFG["vocab_size"],
                         (PP_STEPS, PP_MICRO, 1, TRAIN_SEQ + 1),
                         generator=gen, device=dev)


def _pp_batch(tokens, i: int) -> dict:
    t = tokens[i]
    return {"tokens": t[..., :-1].contiguous(),
            "labels": t[..., 1:].contiguous()}


#: the LlamaBlock whose parameters ``torch.func.functional_call`` swaps
#: for a stage's
_PP_BLOCK: list = []


def _pp_flat(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_pp_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _pp_stage(p, x, mb):
    """A stage: its layers (``p["layers"]``, by global name, in order)."""
    for layer in p["layers"].values():
        x = torch.func.functional_call(_PP_BLOCK[0], _pp_flat(layer), (x,))
    return x


def _pp_chunk_stage(p, x, mb):
    """An interleaved chunk: one layer."""
    return torch.func.functional_call(_PP_BLOCK[0], _pp_flat(p["layer"]),
                                      (x,))


def _pp_head(y, mb, norm_w, head_w):
    """The final RMSNorm, the head and the cross entropy of
    ``LlamaModel.forward`` (fp32 logits)."""
    from apex_tpu_torch.normalization import fused_rms_norm
    from apex_tpu_torch.transformer.tensor_parallel import (
        vocab_parallel_cross_entropy)
    h = fused_rms_norm(y, (FULL_CFG["hidden_size"],), norm_w, 1e-5)
    logits = F.linear(h, head_w)
    return vocab_parallel_cross_entropy(logits.float(),
                                        mb["labels"].T).mean()


def _pp_loss(scale):
    """The 3-arg loss (the last stage's norm and head train), times the
    loss scale."""
    def loss(y, mb, p):
        return _pp_head(y, mb, p["final_norm"]["weight"],
                        p["lm_head"]["weight"]) * scale
    return loss


def _pp_input(embed):
    """The frozen embedding lookup, ``[s, b, h]``."""
    return lambda mb: F.embedding(mb["tokens"], embed).transpose(0, 1)


def _pp_digest(tree, divide=1.0, prefix: str = "") -> dict:
    """Every DP_SAMPLE-th element of each leaf of a grad tree (by dotted
    name), over ``divide``, as fp32 on the host."""
    return {k: (v.reshape(-1)[::DP_SAMPLE].float() / divide).cpu()
            for k, v in _pp_flat(tree, prefix).items()}


def _pp_master_digest(opt, tree) -> dict:
    """The same elements of the optimizer's fp32 master, by the leaf
    names of ``tree`` (the tree it was built on)."""
    from apex_tpu_torch.utils import tree_leaves_with_path
    g = opt.param_groups[0]
    return {".".join(path): g.master[off:off + size][::DP_SAMPLE].cpu()
            for (path, _), off, size in zip(tree_leaves_with_path(tree),
                                            g.offsets, g.sizes)}


def _pp_train_reference(dev, seed: int):
    """The reference in the parent: ``forward_backward_no_pipelining``
    over all four layers and the same 8 microbatches on the same seeded
    weights, then ``GradScaler.unscale_`` and ``FusedAdam``, PP_STEPS
    steps; the losses, the digest of the step-0 grads and of the master
    after each step, the step times and the peak.  Everything is freed
    before it returns."""
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.transformer import pipeline_parallel as tpp
    from apex_tpu_torch.transformer.amp import GradScaler
    tokens = _pp_tokens(dev, seed)
    _, model, _ = _train_model(dev, seed, TRAIN_LAYERS)
    tree = _param_tree(model)
    params = {"layers": {f"layer_{i}": tree[f"layer_{i}"]
                         for i in range(TRAIN_LAYERS)},
              "final_norm": tree["final_norm"], "lm_head": tree["lm_head"]}
    input_fn = _pp_input(tree["embed_tokens"]["weight"])
    _PP_BLOCK[:] = [model.layer_0]
    scaler = GradScaler(device=dev)
    st = scaler.init()
    opt = FusedAdam(params, lr=TRAIN_LR)
    out = dict(losses=[], step_s=[], masters=[])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(PP_STEPS):
        t0 = time.perf_counter()
        scale = st.loss_scale.item()
        loss, grads = tpp.forward_backward_no_pipelining(
            _pp_stage, _pp_loss(st.loss_scale), params, _pp_batch(tokens, i),
            num_microbatches=PP_MICRO, input_fn=input_fn)
        grads, st = scaler.unscale_(grads, st)
        params = opt.step(grads, noop_flag=st.found_inf)
        st = scaler.update(st)
        torch.cuda.synchronize()
        out["step_s"].append(time.perf_counter() - t0)
        out["losses"].append(loss.item() / scale)
        if i == 0:
            out["grads"] = _pp_digest(grads)
        out["masters"].append(_pp_master_digest(opt, params))
        del grads
    out.update(peak=torch.cuda.max_memory_allocated(),
               n=opt.param_groups[0].numel)
    _PP_BLOCK.clear()
    del model, tree, params, opt
    torch.cuda.empty_cache()
    return out


def _pp_measure(fn) -> dict:
    """``fn(timeline)`` (an executor call) with the collectives timed:
    its seconds, the peak memory it added, its ticks' compute, the most
    microbatch graphs it held, its collectives."""
    from apex_tpu_torch.transformer.pipeline_parallel import schedules
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    timeline: list = []
    with _timed_collectives() as coll:
        t0 = time.perf_counter()
        out = fn(timeline)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    return dict(out=out, s=secs, timeline=timeline, coll=list(coll),
                rise=torch.cuda.max_memory_allocated() - base,
                in_flight=schedules.last_run_stats()["max_in_flight"])


def _pp_runs(rank, stage, chunks, head, input_fn, tokens, dev):
    """(b) the GPipe oracle, (d) forward only, (c) interleaved, all on
    the first weights and batch; then (a) PP_STEPS 1F1B steps with
    ``GradScaler`` and ``FusedAdam``, and (e) one step with an inf in
    rank 0's grads.  Each run's launches counted from 0."""
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.transformer import pipeline_parallel as tpp
    from apex_tpu_torch.transformer.amp import GradScaler
    f = tpp.forward_backward_pipelining_without_interleaving
    kw = dict(num_microbatches=PP_MICRO, input_fn=input_fn)
    batch0 = _pp_batch(tokens, 0)
    scaler = GradScaler(device=dev)
    st = scaler.init()
    scale = st.loss_scale.item()
    out = {}
    # (b) the GPipe oracle
    _build.reset_launch_counts()
    m = _pp_measure(lambda tl: f(_pp_stage, _pp_loss(st.loss_scale), stage,
                                 batch0, use_1f1b=False, timeline=tl, **kw))
    loss, grads = m.pop("out")
    out["b"] = dict(m, loss=loss.item() / scale,
                    grads=_pp_digest(grads, scale),
                    launches=_build.launch_counts())
    del grads
    # (d) forward only
    _build.reset_launch_counts()
    m = _pp_measure(lambda tl: f(_pp_stage, _pp_loss(st.loss_scale), stage,
                                 batch0, forward_only=True, timeline=tl,
                                 **kw))
    loss, grads = m.pop("out")
    out["d"] = dict(m, loss=loss.item() / scale, grads_none=grads is None,
                    launches=_build.launch_counts())
    # (c) interleaved, v = PP_V: the norm and head a frozen closure
    _build.reset_launch_counts()
    m = _pp_measure(lambda tl: tpp.forward_backward_pipelining_with_interleaving(
        _pp_chunk_stage, lambda y, mb: _pp_head(y, mb, *head) * st.loss_scale,
        chunks, batch0, virtual_pipeline_model_parallel_size=PP_V,
        timeline=tl, **kw))
    loss, grads = m.pop("out")
    digest = {}
    for c in range(PP_V):
        layer = tpp.utils.tree_map(lambda g, c=c: g[c], grads["layer"])
        digest.update(_pp_digest(
            layer, scale, f"layers.layer_{c * PP_TRAIN + rank}."))
    out["c"] = dict(m, loss=loss.item() / scale, grads=digest,
                    launches=_build.launch_counts())
    del grads, layer
    # (a) 1F1B steps
    opt = FusedAdam(stage, lr=TRAIN_LR)
    n_local = opt.param_groups[0].numel
    params = stage
    a = dict(losses=[], step_s=[], steps=[], masters=[], n=n_local)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    peak = 0
    with _kernel_lengths() as lengths:
        for i in range(PP_STEPS):
            t0 = time.perf_counter()
            scale = st.loss_scale.item()
            m = _pp_measure(lambda tl: f(
                _pp_stage, _pp_loss(st.loss_scale), params,
                _pp_batch(tokens, i), timeline=tl, **kw))
            peak = max(peak, torch.cuda.max_memory_allocated())
            loss, grads = m.pop("out")
            grads, st = scaler.unscale_(grads, st)
            params = opt.step(grads, noop_flag=st.found_inf)
            st = scaler.update(st)
            torch.cuda.synchronize()
            peak = max(peak, torch.cuda.max_memory_allocated())
            a["step_s"].append(time.perf_counter() - t0)
            a["losses"].append(loss.item() / scale)
            a["steps"].append(m)
            if i == 0:
                a["grads"] = _pp_digest(grads)
            a["masters"].append(_pp_master_digest(opt, params))
            del grads
    a.update(launches=_build.launch_counts(), lengths=lengths, peak=peak,
             scale=st.loss_scale.item())
    out["a"] = a
    # (e) the overflow: an inf in rank 0's grads before the unscale
    g0 = opt.param_groups[0]
    bufs = (g0.master, g0.state["exp_avg"], g0.state["exp_avg_sq"])
    before = [b.clone() for b in bufs]
    count, scale = opt.step_count, st.loss_scale.item()
    _build.reset_launch_counts()
    with _kernel_lengths() as lengths:
        loss, grads = f(_pp_stage, _pp_loss(st.loss_scale), params, batch0,
                        **kw)
        if rank == 0:
            first = tpp.utils.tree_leaves(grads)[0]
            first.view(-1)[0] = float("inf")
        grads, st = scaler.unscale_(grads, st)
        found = st.found_inf.item()
        opt.step(grads, noop_flag=st.found_inf)
        st = scaler.update(st)
        torch.cuda.synchronize()
    g0 = opt.param_groups[0]
    after = (g0.master, g0.state["exp_avg"], g0.state["exp_avg_sq"])
    out["e"] = dict(same=all(torch.equal(x, y) for x, y in
                             zip(after, before)),
                    found_inf=found, count=(count, opt.step_count),
                    scale=(scale, st.loss_scale.item()),
                    launches=_build.launch_counts(), lengths=lengths,
                    n=n_local)
    del before, grads, opt, params
    torch.cuda.empty_cache()
    return out


#: the timed hops of each direction, alone (a barrier first, the device
#: synchronised around each), of one microbatch's activation
PP_HOPS = 10


def _pp_hop_times(dev) -> dict:
    """Seconds of PP_HOPS back-to-back hops of a ``[TRAIN_SEQ, 1,
    hidden]`` bf16 payload each way around the pipe ring, both ranks
    starting together: the staged transfer without a peer to wait
    for."""
    import torch.distributed as dist
    from apex_tpu_torch.transformer.pipeline_parallel import (
        p2p_communication as p2p)
    payload = torch.ones(TRAIN_SEQ, 1, FULL_CFG["hidden_size"],
                         dtype=torch.bfloat16, device=dev)
    out = {}
    for name, hop in (("forward", p2p.send_forward_recv_forward),
                      ("backward", p2p.send_backward_recv_backward)):
        hop(payload)                                  # warm the pair
        dist.barrier()
        times = []
        for _ in range(PP_HOPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hop(payload)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out[name] = times
    return out


def _pp_train_rank(rank, tmp, seed):
    """One rank of the pp_train phase, on cuda:0 over gloo: builds the
    train phase's seeded weights and keeps its stage (layers 2r and
    2r + 1; the last rank also the final norm and the head), its
    interleaved chunks (layers r and r + 2, stacked) and the frozen
    embedding, one rank after the other, initialises the topology at pp
    = PP_TRAIN, runs (a)-(e) and writes what it saw to
    ``tmp/rank<rank>.pt``."""
    import datetime
    import os
    import torch.distributed as dist
    from apex_tpu_torch.parallel import _comm
    from apex_tpu_torch.transformer import parallel_state
    from apex_tpu_torch.transformer import pipeline_parallel as tpp
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(
        str(Path(tmp) / "store"), PP_TRAIN), rank=rank, world_size=PP_TRAIN,
        timeout=datetime.timedelta(seconds=600))
    out = {}
    try:
        t0 = time.perf_counter()
        per = TRAIN_LAYERS // PP_TRAIN
        last = rank == PP_TRAIN - 1
        for r in range(PP_TRAIN):
            if r == rank:
                _, model, _ = _train_model(dev, seed, TRAIN_LAYERS)
                tree = _param_tree(model)
                stage = {"layers": {f"layer_{rank * per + i}":
                                    tree[f"layer_{rank * per + i}"]
                                    for i in range(per)}}
                if last:
                    stage.update(final_norm=tree["final_norm"],
                                 lm_head=tree["lm_head"])
                chunks = {"layer": tpp.utils.tree_map(
                    lambda *a: torch.stack(a),
                    *[tree[f"layer_{c * PP_TRAIN + rank}"]
                      for c in range(PP_V)])}
                head = (tree["final_norm"]["weight"],
                        tree["lm_head"]["weight"]) if last else None
                input_fn = _pp_input(tree["embed_tokens"]["weight"])
                _PP_BLOCK[:] = [model.layer_0]
                del model, tree
                torch.cuda.empty_cache()
            dist.barrier()
        parallel_state.initialize_model_parallel(1, PP_TRAIN)
        group = parallel_state.get_pipeline_model_parallel_group()
        tokens = _pp_tokens(dev, seed)
        out["staged"] = _comm.hop_staged(tokens, group)
        out["setup_s"] = time.perf_counter() - t0
        out.update(_pp_runs(rank, stage, chunks, head, input_fn, tokens,
                            dev))
        out["hop_s"] = _pp_hop_times(dev)
    finally:
        parallel_state.destroy_model_parallel()
        dist.destroy_process_group()
    torch.save(out, Path(tmp) / f"rank{rank}.pt")


def _pp_bubble(timelines) -> list:
    """The measured bubble share of each rank: over the ticks, the time
    a rank computes nothing while the busiest rank of the tick computes,
    as a share of the busiest ranks' time (hops left out)."""
    busy = [[(f or 0.0) + (b or 0.0) for _, f, b in tl] for tl in timelines]
    crit = [max(ticks) for ticks in zip(*busy)]
    total = sum(crit)
    return [sum(c - x for c, x in zip(crit, ticks)) / total for ticks in busy]


def _pp_hops(coll) -> str:
    """A run's hops: count, median, range and sum (a hop's seconds
    include its wait for the peer to reach it)."""
    hops = [s for name, s in coll if name == "ring_hop"]
    if not hops:
        return "no hops"
    return (f"{len(hops)} hops, {1e3 * float(np.median(hops)):.2f} ms "
            f"median, {1e3 * min(hops):.2f}-{1e3 * max(hops):.2f} ms, "
            f"{sum(hops):.3f} s in all")


def _pp_want_launches(rank: int, steps: int, forward: bool = True,
                      backward: bool = True, update: bool = False,
                      chunks: bool = False) -> dict:
    """A rank's launches for ``steps`` passes over PP_MICRO
    microbatches: #1 (and, with the backward, #2) twice a layer and
    microbatch, plus the final norm once a microbatch on the last rank;
    #3 (and #4) once a layer and microbatch; #9 and #13 once a step with
    ``update``; #5 and #6 never.  ``chunks``: the interleaved layout,
    one layer a chunk."""
    layers = PP_V if chunks else TRAIN_LAYERS // PP_TRAIN
    norms = 2 * layers + (1 if rank == PP_TRAIN - 1 else 0)
    per = PP_MICRO * steps
    want = {"layer_norm": norms * per, "flash_attention": layers * per,
            "layer_norm_bwd": norms * per if backward else 0,
            "flash_attention_bwd": layers * per if backward else 0,
            "fused_scale": steps if update else 0,
            "fused_adam": steps if update else 0}
    want.update({k: 0 for k in SPLIT_KERNELS})
    return want


def _pp_hold_launches(label, launches, want) -> None:
    got = {k: launches[k] for k in want}
    print(f"  {label}: launches {got} (worked out from the stage: {want})")
    if got != want:
        raise AssertionError(f"{label}: launches off")


def _pp_hold_grads(label, ranks_digests, ref, keys) -> None:
    got = {}
    for d in ranks_digests:
        got.update(d)
    if set(got) != set(keys):
        raise AssertionError(f"{label}: the ranks' grads cover "
                             f"{sorted(set(got) ^ set(keys))[:4]} wrongly")
    _grad_hold(label, torch.cat([got[k] for k in sorted(keys)]),
               torch.cat([ref[k] for k in sorted(keys)]), rel_gate=True,
               against="the reference's", rel_tol=TOL_PP_GRAD)


def _pp_train_gates(ranks, ref, smi) -> None:
    """What the parent holds the pp_train ranks to (the module
    docstring's item 22)."""
    print(f"pp_train: the pipe ring's hops over gloo on CUDA tensors copy "
          f"through host tensors: {ranks[0]['staged']}")
    if not ranks[0]["staged"]:
        raise AssertionError("pp_train: the hop is not staged over gloo")
    # the losses: every rank the same, each run against the reference
    for key in "bcd":
        if len({r[key]["loss"] for r in ranks}) != 1:
            raise AssertionError(f"pp_train ({key}): the ranks' losses "
                                 f"differ")
    if len({tuple(r["a"]["losses"]) for r in ranks}) != 1:
        raise AssertionError("pp_train (a): the ranks' losses differ")
    for label, got in (("(a) 1F1B step 0", ranks[0]["a"]["losses"][0]),
                       ("(b) GPipe", ranks[0]["b"]["loss"]),
                       ("(c) interleaved", ranks[0]["c"]["loss"]),
                       ("(d) forward only", ranks[0]["d"]["loss"])):
        _tp_hold_losses(f"pp_train {label} against the reference",
                        [got], ref["losses"][:1], TOL_DP_LOSS)
    print(f"  pp_train (a) step 1: loss {ranks[0]['a']['losses'][1]:.5f} "
          f"(the reference's {ref['losses'][1]:.5f})")
    # the grads
    all_keys = list(ref["grads"])
    layer_keys = [k for k in all_keys if k.startswith("layers.")]
    _pp_hold_grads("pp_train (a) step 0", [r["a"]["grads"] for r in ranks],
                   ref["grads"], all_keys)
    _pp_hold_grads("pp_train (b) GPipe", [r["b"]["grads"] for r in ranks],
                   ref["grads"], all_keys)
    _pp_hold_grads("pp_train (c) interleaved (layers)",
                   [r["c"]["grads"] for r in ranks], ref["grads"], layer_keys)
    # the in-flight graphs and the peaks
    bound = 2 * (PP_TRAIN - 1) + 1
    for rank, r in enumerate(ranks):
        flights = [s["in_flight"] for s in r["a"]["steps"]]
        print(f"  pp_train rank {rank}: in-flight microbatch graphs (a) "
              f"{flights} (limit {bound}), (b) {r['b']['in_flight']}, (c) "
              f"{r['c']['in_flight']} (limit {2 * PP_V * PP_TRAIN})")
        if max(flights) > bound or r["c"]["in_flight"] > 2 * PP_V * PP_TRAIN:
            raise AssertionError(f"pp_train rank {rank}: too many graphs in "
                                 f"flight")
    if ranks[0]["b"]["in_flight"] != PP_MICRO:
        raise AssertionError("pp_train (b): the GPipe oracle must hold every "
                             "microbatch on rank 0")
    a_rise, b_rise = ranks[0]["a"]["steps"][0]["rise"], ranks[0]["b"]["rise"]
    print(f"  pp_train rank 0: memory the executor added, (a) 1F1B "
          f"{a_rise / 2**30:.2f} GiB, (b) GPipe {b_rise / 2**30:.2f} GiB")
    if not a_rise < b_rise:
        raise AssertionError("pp_train: 1F1B's peak is not below GPipe's")
    # the launches
    for rank, r in enumerate(ranks):
        _pp_hold_launches(f"pp_train (a) rank {rank}", r["a"]["launches"],
                          _pp_want_launches(rank, PP_STEPS, update=True))
        _hold_lengths(f"pp_train (a) rank {rank}", r["a"], {
            "fused_scale": (PP_STEPS, r["a"]["n"]),
            "fused_adam": (PP_STEPS, r["a"]["n"])})
        _pp_hold_launches(f"pp_train (b) rank {rank}", r["b"]["launches"],
                          _pp_want_launches(rank, 1))
        _pp_hold_launches(f"pp_train (c) rank {rank}", r["c"]["launches"],
                          _pp_want_launches(rank, 1, chunks=True))
        _pp_hold_launches(f"pp_train (d) rank {rank}", r["d"]["launches"],
                          _pp_want_launches(rank, 1, backward=False))
        _pp_hold_launches(f"pp_train (e) rank {rank}", r["e"]["launches"],
                          _pp_want_launches(rank, 1, update=True))
        if not r["d"]["grads_none"]:
            raise AssertionError("pp_train (d): forward_only returned grads")
    # the masters after (a)'s steps: at most 2 lr a step (and 2 fp32 ulps
    # of 1) off the reference's
    slack = 2 * float(np.spacing(np.float32(1)))
    for i in range(PP_STEPS):
        got = {}
        for r in ranks:
            got.update(r["a"]["masters"][i])
        keys = sorted(ref["masters"][i])
        if sorted(got) != keys:
            raise AssertionError("pp_train (a): the masters' leaves differ")
        diff = (torch.cat([got[k] for k in keys])
                - torch.cat([ref["masters"][i][k] for k in keys])).abs()
        worst, limit = float(diff.max()), 2 * TRAIN_LR * (i + 1) + slack
        print(f"  pp_train (a) against the reference after step {i + 1}: "
              f"master digest ({diff.numel()} elements) max |diff| "
              f"{worst:.3e} (limit {limit:.4e}), share above "
              f"{TRAIN_LR / 8:.1e} {float((diff > TRAIN_LR / 8).float().mean()):.5f}")
        if not worst <= limit:
            raise AssertionError(f"pp_train (a): the master after step "
                                 f"{i + 1} is off the reference")
    # (e) the overflow
    for rank, r in enumerate(ranks):
        e = r["e"]
        print(f"  pp_train (e) rank {rank}: found_inf {e['found_inf']}, "
              f"master and moments unchanged {e['same']}, step count "
              f"{e['count']}, scale {e['scale']}")
        _hold_lengths(f"pp_train (e) rank {rank}", e, {
            "fused_scale": (1, e["n"]), "fused_adam": (1, e["n"])})
        if not (e["same"] and e["found_inf"] == 1.0
                and e["count"][1] == e["count"][0] + 1
                and e["scale"][1] == e["scale"][0] / 2):
            raise AssertionError(f"pp_train (e) rank {rank}: the step was "
                                 f"not skipped")


def phase_pp_train(dev, seed: int):
    """Pipelined training at pp = 2 on the one card (the module
    docstring's item 22): the reference in the parent
    (:func:`_pp_train_reference`), freed, then the two ranks
    (:func:`_pp_train_rank`) on cuda:0 over gloo, held here.  Returns the
    ranks' launches, summed."""
    import tempfile
    import torch.multiprocessing as mp
    from apex_tpu_torch.transformer.pipeline_parallel import (
        interleaved_phase_ticks)
    smi = _smi()
    t_phase = time.perf_counter()
    _card_memory("pp_train, before the reference")
    ref = _pp_train_reference(dev, seed)
    print(f"pp_train reference (forward_backward_no_pipelining, Llama-3-8B "
          f"widths, {TRAIN_LAYERS} layers, {ref['n']} trained parameters, "
          f"{PP_MICRO} microbatches of {TRAIN_SEQ} tokens a step): losses "
          f"{[round(x, 5) for x in ref['losses']]}, step times "
          f"{[round(t, 3) for t in ref['step_s']]} s, peak "
          f"{ref['peak'] / 2**30:.2f} GiB [{smi}]")
    _card_memory("pp_train, before the ranks")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ppt_") as tmp_dir:
        tmp = Path(tmp_dir)
        t0 = time.perf_counter()
        mp.start_processes(_pp_train_rank, nprocs=PP_TRAIN,
                           start_method="spawn", args=(str(tmp), seed))
        ranks_s = time.perf_counter() - t0
        ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                 for r in range(PP_TRAIN)]
    _pp_train_gates(ranks, ref, smi)
    # the numbers
    n, pp = PP_MICRO, PP_TRAIN
    warm, steady, cool = interleaved_phase_ticks(n, pp, PP_V)
    bubble_i = (warm + cool) / (2 * PP_V) + steady / PP_V - n
    for label, tls, theory in (
            ("(a) 1F1B, last step", [r["a"]["steps"][-1]["timeline"]
                                     for r in ranks],
             (pp - 1) / (n + pp - 1)),
            (f"(c) interleaved v = {PP_V}", [r["c"]["timeline"]
                                             for r in ranks],
             bubble_i / (n + bubble_i))):
        shares = _pp_bubble(tls)
        work = [(sum(f or 0.0 for _, f, _ in tl), sum(b or 0.0 for *_, b in tl))
                for tl in tls]
        print(f"pp_train {label}: measured bubble share by rank "
              f"{[round(s, 4) for s in shares]} (mean "
              f"{sum(shares) / len(shares):.4f}; the schedule's "
              f"{theory:.4f}; interleaved_phase_ticks({n}, {pp}, {PP_V}) = "
              f"{(warm, steady, cool)}); each rank's compute, forwards and "
              f"backwards: "
              + ", ".join(f"rank {r} {f:.3f} + {b:.3f} s"
                          for r, (f, b) in enumerate(work)) + f" [{smi}]")
    for rank, r in enumerate(ranks):
        print(f"pp_train rank {rank}: {PP_HOPS} hops alone of a [{TRAIN_SEQ}, "
              f"1, {FULL_CFG['hidden_size']}] bf16 activation (gloo, staged "
              f"through the host; not an NCCL figure): "
              + ", ".join(f"{k} median {1e3 * float(np.median(v)):.2f} ms "
                          f"({1e3 * min(v):.2f}-{1e3 * max(v):.2f})"
                          for k, v in r["hop_s"].items()) + f" [{smi}]")
    total: dict = {}
    for rank, r in enumerate(ranks):
        a = r["a"]
        print(f"pp_train (a) rank {rank}: step times "
              f"{[round(t, 3) for t in a['step_s']]} s (the executor "
              f"{[round(s['s'], 3) for s in a['steps']]}; the reference "
              f"{[round(t, 3) for t in ref['step_s']]}), peak "
              f"{a['peak'] / 2**30:.2f} GiB (the reference "
              f"{ref['peak'] / 2**30:.2f}), stage length {a['n']} [{smi}]")
        for i, s in enumerate(a["steps"]):
            print(f"  step {i}: the pipe ring (gloo, staged through the host; "
                  f"not an NCCL figure): {_pp_hops(s['coll'])}; "
                  f"collectives {_coll_line(s['coll'])}")
        for key, label in (("b", "(b) GPipe"), ("c", "(c) interleaved"),
                           ("d", "(d) forward only")):
            print(f"pp_train {label} rank {rank}: {r[key]['s']:.3f} s, "
                  f"{_pp_hops(r[key]['coll'])}, executor peak rise "
                  f"{r[key]['rise'] / 2**30:.2f} GiB [{smi}]")
        for key in "abcde":
            for k, v in r[key]["launches"].items():
                total[k] = total.get(k, 0) + v
    print(f"pp_train: the ranks set up in "
          f"{max(r['setup_s'] for r in ranks):.1f} s and ran in "
          f"{ranks_s:.1f} s, the phase {time.perf_counter() - t_phase:.1f} s "
          f"[{smi}]")
    return dict(launches=total)


#: context-parallel training (the cp_train phase): GPT-3 1.3B widths
#: (hidden 2048, 16 heads of 128, vocab 51200, LayerNorm, GELU) at 4
#: layers with the context raised to 8192, bf16 parameters drawn from the
#: seed, fp32 masters in (c); one sequence of 8192 tokens from the seed,
#: 4096 a rank over cp = 2 ranks on the one card
CP_TRAIN = 2
#: 4 until the moe_train phase came (the phase's depth cut first, every
#: gate kept: the launches follow it)
CP_LAYERS = 2
CP_SEQ = 8192
#: (c)'s FusedAdam steps
CP_ADAM_STEPS = 2
#: (b) against (a): the loss, a mean of 8192 tokens' fp32 losses, and the
#: grads (relative L2 of all of them and of each leaf).  Two bf16
#: computations of one function: the ring rounds each layer's attention
#: output once after an fp32 merge where cp = 1's kernel rounds its own,
#: and the grads come through the fp32-output backward where cp = 1's
#: split pair rounds dq, dk and dv to bf16, so the activations part as
#: tp = 2's two rounded partials part from tp = 1's (TOL_TP_LOSS,
#: TOL_TP_GRAD_REL).  In fp32 on the CPU the port's cp = 2 and 4 runs
#: hold cp = 1's loss within 2e-5 relative and its grads within 2e-5 of
#: each leaf's largest magnitude (tests/test_torch_context_parallel.py)
TOL_CP_LOSS = TOL_TP_LOSS
TOL_CP_GRAD_REL = TOL_TP_GRAD_REL
#: a leaf this long or shorter goes into (b)'s digest whole, so that the
#: limit holds each leaf as well as all of them (a bias sampled every
#: DP_SAMPLE-th element keeps 2-8 elements)
CP_WHOLE_LEAF = 1 << 16
#: (d) Ulysses against flash_attention on the gathered sequence: the
#: flash forward's and backward's limits (TOL_ATTN_OUT on the output,
#: TOL_FLASH_BWD_REL_L2 on each grad); each head runs the same kernels on
#: the same rows either way, so the bits are printed too
#: (f) one ring attention call past the one-pass gate: a sequence of
#: this many tokens, CP_LONG_SEQ / CP_TRAIN a rank (each pair's backward
#: the split pair's fp32-output instances), held against flash_attention
#: on the gathered sequence by the flash limits, as (d) is
CP_LONG_SEQ = 16384
#: (e) sequence parallelism inside tp_train: each output against the
#: pair without it, as a share of its largest magnitude (TOL_TP_RING_FWD:
#: the same GEMMs, and the reduce-scatter sums the all-reduce's two
#: partials)


def _cp_model(dev, seed: int, **kw):
    """The phase's GPT (:data:`CP_LAYERS` deep, context :data:`CP_SEQ`,
    bf16 parameters drawn by the modules' initializers from ``seed``,
    attention dropout ``LM_DROPOUT``, no hidden dropout unless ``kw``
    sets it)."""
    from apex_tpu_torch.models import GPTConfig, gpt_model_provider
    torch.manual_seed(seed)
    cfg = GPTConfig(**{**GPT_CFG, "num_layers": CP_LAYERS,
                       "max_seq_length": CP_SEQ,
                       "params_dtype": torch.bfloat16,
                       "hidden_dropout": 0.0,
                       "attention_dropout": LM_DROPOUT, **kw})
    return cfg, gpt_model_provider(cfg, device=dev)


def _cp_tokens(dev, seed: int):
    """The phase's sequence and its successors, ``[1, CP_SEQ]`` each."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 29)
    t = torch.randint(0, GPT_CFG["vocab_size"], (1, CP_SEQ + 1),
                      generator=gen, device=dev)
    return t[:, :-1].contiguous(), t[:, 1:].contiguous()


def _cp_generator(dev, seed: int):
    """The attention-dropout stream of (a) and (b), the same on every
    rank."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 30)
    return gen


def _cp_fwd_bwd(model, toks, labels, gen):
    """One forward and backward in training mode: the loss, the seconds
    and the flash launches."""
    from apex_tpu_torch.ops import _build
    model.zero_grad(set_to_none=True)
    before = _build.launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = model(toks, labels, deterministic=False, generator=gen)
    loss.backward()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return loss.detach(), seconds, {
        k: v - before[k] for k, v in _build.launch_counts().items()
        if v != before[k]}


def _cp_attention_times(dev, seed: int, ring: bool):
    """One attention call's forward and forward + backward seconds on
    random ``[1, 16, s, 128]`` bf16, causal, dropout ``LM_DROPOUT``: ring
    attention over the context group at s = 4096 a rank, or
    ``flash_attention`` at s = 8192 (cp = 1)."""
    from apex_tpu_torch.ops import flash_attention, ring_attention
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 33)
    s = CP_SEQ // CP_TRAIN if ring else CP_SEQ
    q, k, v, do = (torch.randn(1, 16, s, 128, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    fn = ring_attention if ring else flash_attention
    kw = dict(causal=True, dropout_rate=LM_DROPOUT, dropout_seed=1234)
    # CUDA events around eager calls: the hops' host copies are the gaps
    fwd = _eager_ms(lambda: fn(q, k, v, **kw), 3) / 1e3
    both = _eager_ms(lambda: torch.autograd.grad(
        fn(qr, kr, vr, **kw), (qr, kr, vr), do), 3) / 1e3
    return fwd, both - fwd


def _cp_reference(dev, seed: int):
    """(a) cp = 1 in the parent: one forward and backward of the phase's
    GPT on the whole sequence with attention dropout; its loss, grads
    (their digest, :func:`_cp_digest`), seconds, launches and peak;
    then the same weights in the scan layout (``to_scan_layout``) with
    the same generator, whose loss and grads must equal the loop
    layout's bit for bit; and flash_attention's times at 8192.  Frees
    everything it built."""
    from apex_tpu_torch.inference.weights import (load_jax_params,
                                                  to_scan_layout)
    toks, labels = _cp_tokens(dev, seed)
    cfg, model = _cp_model(dev, seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss, seconds, launches = _cp_fwd_bwd(model, toks, labels,
                                          _cp_generator(dev, seed))
    peak = torch.cuda.max_memory_allocated()
    grads = {n: p.grad for n, p in model.named_parameters()}
    _, scan = _cp_model(dev, seed, scan_layers=True)
    load_jax_params(scan, to_scan_layout(_param_tree(model), CP_LAYERS))
    sloss, sseconds, slaunches = _cp_fwd_bwd(scan, toks, labels,
                                             _cp_generator(dev, seed))
    stacked = {n: p.grad for n, p in scan.named_parameters()}
    unequal = []
    for name, g in grads.items():
        if name.startswith("layer_"):
            i, rest = name.split(".", 1)
            other = stacked["layers.layer." + rest][int(i[len("layer_"):])]
        else:
            other = stacked[name]
        if not torch.equal(g, other):
            unequal.append(name)
    out = dict(loss=loss.item(), scan_loss=sloss.item(), unequal=unequal,
               seconds=seconds, scan_seconds=sseconds, launches=launches,
               scan_launches=slaunches, peak=peak,
               n=sum(p.numel() for p in model.parameters()),
               grads=_cp_digest(grads))
    del model, scan, grads, stacked
    torch.cuda.empty_cache()
    out["flash_s"] = _cp_attention_times(dev, seed, ring=False)
    torch.cuda.empty_cache()
    return out


def _cp_digest(grads: dict) -> dict:
    """Each grad leaf, fp32 on the host, whole up to CP_WHOLE_LEAF
    elements (the biases and norms) and every DP_SAMPLE-th element of
    a larger one: the digest (b) is held to (a) on, leaf by leaf
    (~4.3e5 of 3.2e8 elements)."""
    return {k: g.detach().float().flatten()[
        ::1 if g.numel() <= CP_WHOLE_LEAF else DP_SAMPLE].cpu()
        for k, g in grads.items()}


def _cp_launches_want(rank: int, drop: bool, steps: int = 1,
                      update: bool = False) -> dict:
    """A context rank's launches: its ring pairs' fp32-output instances
    (rank r computes r + 1 pairs a layer: the causal ring skips the
    rest), the norms, and with ``update`` the unscale and Adam; no
    other flash kernel."""
    suffix = "_drop" if drop else ""
    pairs = CP_LAYERS * (rank + 1) * steps
    want = {f"flash_attention{suffix}_f32out": pairs,
            f"flash_attention_bwd{suffix}_f32out": pairs,
            "layer_norm": (2 * CP_LAYERS + 1) * steps,
            "layer_norm_bwd": (2 * CP_LAYERS + 1) * steps}
    if update:
        want.update(fused_scale=steps, fused_adam=steps)
    return want


def _cp_train_rank(rank, tmp, seed):
    """One context rank of the cp_train phase, on cuda:0 over gloo:
    builds the seeded weights, initialises the topology at cp =
    CP_TRAIN, takes its 4096 tokens of the sequence and runs (b) one
    forward and backward (attention dropout, the generator of (a)), the
    loss averaged over the context group and the grads over
    ``get_dense_param_grad_axes()``'s group (their digest kept,
    :func:`_cp_digest`); one ring attention call timed; (c) CP_ADAM_STEPS
    FusedAdam steps with hidden dropout (per-rank masks) and no
    attention dropout; (d) Ulysses attention against flash_attention on
    the gathered sequence.  Writes what it saw to ``tmp/rank<rank>.pt``."""
    import datetime
    import os
    import torch.distributed as dist
    from apex_tpu_torch import train_step
    from apex_tpu_torch.ops import _build, flash_attention, ulysses_attention
    from apex_tpu_torch.optimizers import functional
    from apex_tpu_torch.parallel import _comm
    from apex_tpu_torch.transformer import parallel_state
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(
        str(Path(tmp) / "store"), CP_TRAIN), rank=rank, world_size=CP_TRAIN,
        timeout=datetime.timedelta(seconds=600))
    out = {}
    try:
        t0 = time.perf_counter()
        parallel_state.initialize_model_parallel(
            context_parallel_size_=CP_TRAIN)
        cgroup = parallel_state.get_context_parallel_group()
        dgroup = parallel_state.resolve_group(
            parallel_state.get_dense_param_grad_axes())
        n = dist.get_world_size(dgroup)
        s = CP_SEQ // CP_TRAIN
        mine = slice(rank * s, (rank + 1) * s)
        toks, labels = (t[:, mine].contiguous()
                        for t in _cp_tokens(dev, seed))
        out["staged"] = _comm.hop_staged(toks, cgroup)

        def group_mean(x):
            x = x.detach().float().reshape(1).clone()
            return _comm.all_reduce(x, cgroup).item() / CP_TRAIN

        # (b) one forward and backward against (a)
        _, model = _cp_model(dev, seed, context_parallel=True)
        out["setup_s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with _timed_collectives() as coll:
            loss, seconds, launches = _cp_fwd_bwd(
                model, toks, labels, _cp_generator(dev, seed))
        peak = torch.cuda.max_memory_allocated()
        grads = {k: p.grad.float() for k, p in model.named_parameters()}
        t1 = time.perf_counter()
        for g in grads.values():
            _comm.all_reduce(g, dgroup).div_(n)
        torch.cuda.synchronize()
        reduce_s = time.perf_counter() - t1
        out["b"] = dict(loss=group_mean(loss), local=loss.item(),
                        seconds=seconds, coll=list(coll), launches=launches,
                        peak=peak, reduce_s=reduce_s,
                        grads=_cp_digest(grads))
        del model, grads
        torch.cuda.empty_cache()
        out["ring_s"] = _cp_attention_times(dev, seed, ring=True)
        # (c) FusedAdam steps, hidden dropout, no attention dropout
        _, model = _cp_model(dev, seed, context_parallel=True,
                             hidden_dropout=LM_DROPOUT, attention_dropout=0.0)
        tx = functional.fused_adam(lr=TRAIN_LR)
        state = train_step.init_train_state(tx, model, loss_scale="dynamic")

        def reduce(flat_grads):
            return _comm.all_reduce(flat_grads, dgroup).div_(n)

        step = train_step.make_train_step(
            lambda m, b: m(b["tokens"], b["labels"], deterministic=False,
                           generator=b["generator"]), tx,
            grad_transform=reduce)
        c = dict(losses=[], local=[], step_s=[], digests=[], coll=[])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        with _kernel_lengths() as lengths:
            for i in range(CP_ADAM_STEPS):
                gen = torch.Generator(device=dev)
                gen.manual_seed(seed * 1000 + i)
                # the first step's collectives timed; the last step's time
                # is the rank's step time
                timed = _timed_collectives() if i == 0 \
                    else contextlib.nullcontext([])
                with timed as rec:
                    t1 = time.perf_counter()
                    state, loss = step(state, dict(tokens=toks,
                                                   labels=labels,
                                                   generator=gen))
                    torch.cuda.synchronize()
                    c["step_s"].append(time.perf_counter() - t1)
                c["coll"].append(list(rec))
                c["local"].append(loss.item())
                c["losses"].append(group_mean(loss))
                c["digests"].append(_bits_digest(state.opt.master))
        c.update(launches=_build.launch_counts(), lengths=lengths,
                 n=state.opt.master.numel(),
                 peak=torch.cuda.max_memory_allocated(),
                 scale=state.scaler.loss_scale.item())
        out["c"] = c
        del state, step, model
        torch.cuda.empty_cache()
        # (d) Ulysses attention against flash_attention on the gathered
        # sequence (the comparison's launches are not the main path's:
        # (d)'s are counted before it)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 31)
        full = [torch.randn(1, 16, CP_SEQ, 128, generator=gen, device=dev)
                .to(torch.bfloat16) for _ in range(4)]
        q, k, v = (t[:, :, mine].contiguous().requires_grad_()
                   for t in full[:3])
        before = _build.launch_counts()
        with _timed_collectives() as coll:
            t1 = time.perf_counter()
            o = ulysses_attention(q, k, v, causal=True)
            o.backward(full[3][:, :, mine].contiguous())
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t1
        launches = _counts_since(before)
        qd, kd, vd = (t.clone().requires_grad_() for t in full[:3])
        od = flash_attention(qd, kd, vd, causal=True)
        od.backward(full[3])
        torch.cuda.synchronize()
        d = dict(seconds=seconds, launches=launches,
                 a2a=[t_ for name, t_ in coll if name == "all_to_all"],
                 out_err=(o.float() - od[:, :, mine].float()).abs().max()
                 .item(),
                 out_equal=torch.equal(o, od[:, :, mine]), rel=[], equal=[])
        for mine_t, dense_t in zip((q, k, v), (qd, kd, vd)):
            ref = dense_t.grad[:, :, mine].float()
            d["rel"].append(((mine_t.grad.float() - ref).norm()
                             / ref.norm()).item())
            d["equal"].append(torch.equal(mine_t.grad,
                                          dense_t.grad[:, :, mine]))
        out["d"] = d
        del full, q, k, v, qd, kd, vd, o, od
        torch.cuda.empty_cache()
        out["f"] = _cp_long_ring(dev, seed, rank)
    finally:
        parallel_state.destroy_model_parallel()
        dist.destroy_process_group()
    torch.save(out, Path(tmp) / f"rank{rank}.pt")


def _cp_long_ring(dev, seed: int, rank: int) -> dict:
    """(f) on a context rank: one ring attention call on its CP_LONG_SEQ /
    CP_TRAIN tokens of a random ``[1, 16, CP_LONG_SEQ, 128]`` bf16
    sequence, causal, without and then with dropout LM_DROPOUT (the seed
    at global coordinates), forward and backward, its launches and
    hops; then flash_attention on the gathered sequence (cp = 1, its
    launches not counted), the shard held against it."""
    from apex_tpu_torch.ops import _build, flash_attention, ring_attention
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 34)
    full = [torch.randn(1, 16, CP_LONG_SEQ, 128, generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(4)]
    s = CP_LONG_SEQ // CP_TRAIN
    mine = slice(rank * s, (rank + 1) * s)
    runs = {}
    for rate in (0.0, LM_DROPOUT):
        kw = dict(causal=True, dropout_rate=rate,
                  dropout_seed=4321 if rate else None)
        q, k, v = (t[:, :, mine].contiguous().requires_grad_()
                   for t in full[:3])
        before = _build.launch_counts()
        with _timed_collectives() as coll:
            t1 = time.perf_counter()
            o = ring_attention(q, k, v, **kw)
            o.backward(full[3][:, :, mine].contiguous())
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t1
        launches = _counts_since(before)
        qd, kd, vd = (t.clone().requires_grad_() for t in full[:3])
        od = flash_attention(qd, kd, vd, **kw)
        od.backward(full[3])
        torch.cuda.synchronize()
        f = dict(seconds=seconds, launches=launches, coll=list(coll),
                 out_err=(o.float() - od[:, :, mine].float()).abs().max()
                 .item(), out_equal=torch.equal(o, od[:, :, mine]), rel=[])
        for mine_t, dense_t in zip((q, k, v), (qd, kd, vd)):
            ref = dense_t.grad[:, :, mine].float()
            f["rel"].append(((mine_t.grad.float() - ref).norm()
                             / ref.norm()).item())
        runs[rate] = f
        del q, k, v, qd, kd, vd, o, od
        torch.cuda.empty_cache()
    return runs


def _cp_hold_launches(label, got: dict, want: dict) -> None:
    """The flash, norm and update counters of a run are the wanted ones
    (a flash counter not wanted must be 0: the bf16 instances do not
    launch inside the ring)."""
    keys = [k for k in got if k.startswith("flash_attention")] + list(want)
    seen = {k: got.get(k, 0) for k in keys if got.get(k, 0) or k in want}
    print(f"  {label}: launches {seen} (want {want})")
    if seen != want:
        raise AssertionError(f"{label}: the launches are off")


def _cp_train_gates(ranks, ref, smi) -> None:
    """What the parent holds the cp_train ranks to (the module
    docstring's item 23)."""
    # (a) the scan layout against the loop layout
    print(f"cp_train (a) scan layout against the loop layout: loss "
          f"{ref['scan_loss']!r} against {ref['loss']!r}, "
          f"{len(ref['grads']) - len(ref['unequal'])}/{len(ref['grads'])} "
          f"grads equal bit for bit")
    if ref["scan_loss"] != ref["loss"] or ref["unequal"]:
        raise AssertionError(f"cp_train (a): the scan layout is not the "
                             f"loop's: {ref['unequal'][:5]}")
    want_a = {"flash_attention_drop": CP_LAYERS,
              "flash_attention_bwd_dq_md": CP_LAYERS,
              "flash_attention_bwd_dkv_md": CP_LAYERS,
              "layer_norm": 2 * CP_LAYERS + 1,
              "layer_norm_bwd": 2 * CP_LAYERS + 1}
    for label, got in (("(a) loop", ref["launches"]),
                       ("(a) scan", ref["scan_launches"])):
        _cp_hold_launches(f"cp_train {label}", got, want_a)
    # (b) against (a)
    b = [r["b"] for r in ranks]
    if len({x["loss"] for x in b}) != 1:
        raise AssertionError("cp_train (b): the ranks' mean losses differ")
    diff = abs(b[0]["loss"] - ref["loss"])
    print(f"cp_train (b) cp = {CP_TRAIN} against (a) cp = 1: loss "
          f"{b[0]['loss']:.6f} (the ranks' {[round(x['local'], 6) for x in b]})"
          f" against {ref['loss']:.6f}: |diff| {diff:.3e} (limit "
          f"{TOL_CP_LOSS})")
    if not diff <= TOL_CP_LOSS:
        raise AssertionError("cp_train (b): the loss is off cp = 1's")
    grads_b = b[0]["grads"]
    if any(not torch.equal(x["grads"][k], grads_b[k]) for x in b
           for k in grads_b):
        raise AssertionError("cp_train (b): the ranks' reduced grads differ")
    num = den = 0.0
    worst = (0.0, "")
    for name, want in ref["grads"].items():
        e = float((grads_b[name] - want).double().norm() ** 2)
        w = float(want.double().norm() ** 2)
        num, den = num + e, den + w
        leaf = (e / w) ** 0.5 if w > 0 else (math.inf if e > 0 else 0.0)
        if leaf > worst[0] or not worst[1]:
            worst = (leaf, name)
    rel = (num / den) ** 0.5
    print(f"  cp_train (b) grads, averaged over the data and context "
          f"group (equal on the ranks), against (a)'s, every "
          f"{DP_SAMPLE}th element of each leaf past {CP_WHOLE_LEAF}, the "
          f"others whole "
          f"({sum(g.numel() for g in grads_b.values())}): relative L2 "
          f"{rel:.4e} over all, the worst leaf {worst[1]} {worst[0]:.4e} "
          f"(limit {TOL_CP_GRAD_REL} on each)")
    if not (rel <= TOL_CP_GRAD_REL and worst[0] <= TOL_CP_GRAD_REL):
        raise AssertionError("cp_train (b): the grads are off cp = 1's")
    for rank, r in enumerate(ranks):
        _cp_hold_launches(f"cp_train (b) rank {rank}", r["b"]["launches"],
                          _cp_launches_want(rank, drop=True))
    # (c) FusedAdam steps
    c = [r["c"] for r in ranks]
    losses = c[0]["losses"]
    print(f"cp_train (c) {CP_ADAM_STEPS} FusedAdam steps, hidden dropout "
          f"{LM_DROPOUT} (per-rank masks): losses averaged over the context "
          f"group {[round(x, 5) for x in losses]} (the ranks' own "
          f"{[[round(x, 5) for x in r['local']] for r in c]})")
    if any(r["losses"] != losses for r in c):
        raise AssertionError("cp_train (c): the ranks' mean losses differ")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"cp_train (c): the loss did not fall: {losses}")
    for i in range(CP_ADAM_STEPS):
        if len({r["digests"][i] for r in c}) != 1:
            raise AssertionError(f"cp_train (c): the ranks' masters differ "
                                 f"after step {i + 1}")
    print(f"  cp_train (c): the {CP_TRAIN} ranks' fp32 masters equal bit for "
          f"bit after each step ({c[0]['n']} elements)")
    for rank, r in enumerate(c):
        _cp_hold_launches(f"cp_train (c) rank {rank}", r["launches"],
                          _cp_launches_want(rank, drop=False,
                                            steps=CP_ADAM_STEPS, update=True))
        _hold_lengths(f"cp_train (c) rank {rank}", r, {
            "fused_scale": (CP_ADAM_STEPS, r["n"]),
            "fused_adam": (CP_ADAM_STEPS, r["n"])})
    # (d) Ulysses
    for rank, r in enumerate(ranks):
        d = r["d"]
        print(f"cp_train (d) rank {rank}: Ulysses [1, 16, {CP_SEQ // CP_TRAIN}"
              f", 128] bf16 causal against flash_attention on [1, 16, "
              f"{CP_SEQ}, 128]: out max|diff| {d['out_err']:.3e} (limit "
              f"{TOL_ATTN_OUT}, equal {d['out_equal']}); dq, dk, dv relative "
              f"L2 {[f'{x:.3e}' for x in d['rel']]} (limit "
              f"{TOL_FLASH_BWD_REL_L2}, equal {d['equal']})")
        if not (d["out_err"] <= TOL_ATTN_OUT
                and max(d["rel"]) <= TOL_FLASH_BWD_REL_L2):
            raise AssertionError("cp_train (d): Ulysses is off the dense run")
        _cp_hold_launches(f"cp_train (d) rank {rank}", d["launches"],
                          {"flash_attention": 1,
                           "flash_attention_bwd_dq": 1,
                           "flash_attention_bwd_dkv": 1})
    # (f) the ring past the one-pass gate
    for rank, r in enumerate(ranks):
        for rate, f in r["f"].items():
            label = (f"cp_train (f) rank {rank}, dropout {rate}" if rate
                     else f"cp_train (f) rank {rank}")
            print(f"{label}: ring attention [1, 16, "
                  f"{CP_LONG_SEQ // CP_TRAIN}, 128] bf16 causal against "
                  f"flash_attention on [1, 16, {CP_LONG_SEQ}, 128]: out "
                  f"max|diff| {f['out_err']:.3e} (limit {TOL_ATTN_OUT}, "
                  f"equal {f['out_equal']}); dq, dk, dv relative L2 "
                  f"{[f'{x:.3e}' for x in f['rel']]} (limit "
                  f"{TOL_FLASH_BWD_REL_L2})")
            if not (f["out_err"] <= TOL_ATTN_OUT
                    and max(f["rel"]) <= TOL_FLASH_BWD_REL_L2):
                raise AssertionError(f"{label}: the ring is off the dense "
                                     f"run")
            drop = "_drop" if rate else ""
            pairs = rank + 1
            _cp_hold_launches(label, f["launches"], {
                f"flash_attention{drop}_f32out": pairs,
                f"flash_attention_bwd_dq{drop}_f32out": pairs,
                f"flash_attention_bwd_dkv{drop}_f32out": pairs})


def phase_cp_train(dev, seed: int):
    """Context-parallel training at cp = 2 on the one card (the module
    docstring's item 23): the cp = 1 reference and the scan layout in the
    parent (:func:`_cp_reference`), freed, then the two ranks
    (:func:`_cp_train_rank`) on cuda:0 over gloo, held here.  Returns the
    ranks' launches of (b), (c) and (d), summed."""
    import tempfile
    import torch.multiprocessing as mp
    smi = _smi()
    t_phase = time.perf_counter()
    _card_memory("cp_train, before the reference")
    ref = _cp_reference(dev, seed)
    print(f"cp_train reference (a) (cp = 1, GPT-3 1.3B widths, {CP_LAYERS} "
          f"layers, {ref['n']} parameters, bf16, one sequence of {CP_SEQ} "
          f"tokens, attention dropout {LM_DROPOUT}): loss {ref['loss']:.6f}, "
          f"forward + backward {ref['seconds']:.3f} s (scan layout "
          f"{ref['scan_seconds']:.3f} s), peak {ref['peak'] / 2**30:.2f} GiB "
          f"[{smi}]")
    _card_memory("cp_train, before the ranks")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cpt_") as tmp_dir:
        tmp = Path(tmp_dir)
        t0 = time.perf_counter()
        mp.start_processes(_cp_train_rank, nprocs=CP_TRAIN,
                           start_method="spawn", args=(str(tmp), seed))
        ranks_s = time.perf_counter() - t0
        ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                 for r in range(CP_TRAIN)]
    print(f"cp_train: ring hops over gloo on CUDA tensors copy through host "
          f"tensors: {ranks[0]['staged']}")
    _cp_train_gates(ranks, ref, smi)
    # the numbers
    total: dict = {}
    for rank, r in enumerate(ranks):
        b, c, d = r["b"], r["c"], r["d"]
        print(f"cp_train rank {rank}: (b) forward + backward {b['seconds']:.3f}"
              f" s (cp = 1: {ref['seconds']:.3f} s), peak "
              f"{b['peak'] / 2**30:.2f} GiB (cp = 1: "
              f"{ref['peak'] / 2**30:.2f}); its ring hops (gloo, staged "
              f"through the host; not an NCCL figure): {_pp_hops(b['coll'])};"
              f" the grads' all-reduces {b['reduce_s']:.3f} s [{smi}]")
        print(f"  (c) step times {[round(t, 3) for t in c['step_s']]} s (the "
              f"last without timed collectives: the rank's step time), peak "
              f"{c['peak'] / 2**30:.2f} GiB, flat length {c['n']}; step 1's "
              f"collectives {_coll_line(c['coll'][0])}; {_pp_hops(c['coll'][0])}"
              f" [{smi}]")
        print(f"  one ring attention call [1, 16, {CP_SEQ // CP_TRAIN}, 128] "
              f"bf16 causal, dropout {LM_DROPOUT}: forward "
              f"{1e3 * r['ring_s'][0]:.2f} ms, backward "
              f"{1e3 * r['ring_s'][1]:.2f} ms; flash_attention at {CP_SEQ} "
              f"(cp = 1, the parent alone on the card): forward "
              f"{1e3 * ref['flash_s'][0]:.2f} ms, backward "
              f"{1e3 * ref['flash_s'][1]:.2f} ms (eager calls between CUDA "
              f"events; the ranks share the card) [{smi}]")
        print(f"  (d) Ulysses forward + backward {d['seconds']:.3f} s, its "
              f"all-to-alls {[round(1e3 * t, 2) for t in d['a2a']]} ms "
              f"(gloo, copied through the host inside the call) [{smi}]")
        for rate, f in r["f"].items():
            print(f"  (f) one ring call [1, 16, {CP_LONG_SEQ // CP_TRAIN}, "
                  f"128], dropout {rate}: forward + backward "
                  f"{f['seconds']:.3f} s, {_pp_hops(f['coll'])} [{smi}]")
        for run in (b["launches"], c["launches"], d["launches"],
                    *(f["launches"] for f in r["f"].values())):
            for k, v in run.items():
                total[k] = total.get(k, 0) + v
    print(f"cp_train: the ranks set up in "
          f"{max(r['setup_s'] for r in ranks):.1f} s and ran in "
          f"{ranks_s:.1f} s, the phase {time.perf_counter() - t_phase:.1f} s "
          f"[{smi}]")
    return dict(launches=total)


MOE_EP = 2
MOE_LAYERS = 4
#: Mixtral 8x7B's routing (Jiang et al. 2024, arXiv:2401.04088): 8
#: experts, the top 2 a token
MOE_EXPERTS, MOE_TOP_K = 8, 2
#: a rank's sequence (GPT-3 1.3B's context)
MOE_SEQ = 2048
MOE_ADAM_STEPS = 2
#: the aux losses' coefficients in (c)'s loss (Switch's load-balancing
#: 0.01, ST-MoE's z-loss 0.001)
MOE_LB_COEFF, MOE_Z_COEFF = 0.01, 0.001
#: (d): DeepSpeed-MoE's "1.3B+MoE-128" (Rajbhandari et al. 2022,
#: arXiv:2201.05596): 128 experts, top-1, at GPT-3 1.3B's widths
MOE_WIDE_EXPERTS, MOE_WIDE_TOP_K = 128, 1
#: (b) against (a): the loss (a mean over 2048 tokens) and each layer's
#: aux losses (relative), and the grads (relative L2 over all and each
#: leaf).  Two bf16 computations of one function: the dense layers run
#: the same products on the same rows, the experts' GEMMs other shapes
#: ([4, 1280, h] a rank at ep = 2 against [8, 640, h]), so the rows may
#: round apart as tp = 2's partials round apart from tp = 1 (TOL_TP_LOSS,
#: TOL_TP_GRAD_REL); in fp32 on the CPU the port's ep = 2 GPT holds the
#: JAX GPT's loss within 2e-5 and its grads within 2e-5 of each leaf's
#: largest magnitude (tests/test_torch_moe_parallel.py)
TOL_MOE_LOSS = TOL_TP_LOSS
TOL_MOE_GRAD_REL = TOL_TP_GRAD_REL
#: (d) gather against onehot on one layer's weights and tokens: the same
#: routing exactly; y within 2^-6 of its largest magnitude (one bf16
#: rounding of the same products) and each grad within
#: TOL_FLASH_BWD_REL_L2 relative L2
TOL_MOE_WIDE_OUT = 2.0 ** -6


def _moe_model(dev, seed: int, **kw):
    """The phase's GPT with the MoE FFN (GPT-3 1.3B widths, MOE_LAYERS
    deep, MOE_EXPERTS experts top MOE_TOP_K, capacity factor 1.25, bf16
    parameters from ``seed``, the router fp32; no dropout unless ``kw``
    sets it)."""
    from apex_tpu_torch.models import GPTConfig, gpt_model_provider
    torch.manual_seed(seed)
    cfg = GPTConfig(**{**GPT_CFG, "num_layers": MOE_LAYERS,
                       "max_seq_length": MOE_SEQ,
                       "params_dtype": torch.bfloat16,
                       "num_moe_experts": MOE_EXPERTS,
                       "moe_top_k": MOE_TOP_K, **kw})
    return cfg, gpt_model_provider(cfg, device=dev)


def _moe_tokens(dev, seed: int):
    """The ranks' sequences and their successors, ``[MOE_EP, MOE_SEQ]``
    each (row r is rank r's)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 37)
    t = torch.randint(0, GPT_CFG["vocab_size"], (MOE_EP, MOE_SEQ + 1),
                      generator=gen, device=dev)
    return t[:, :-1].contiguous(), t[:, 1:].contiguous()


def _moe_loss(model, toks, labels, **kw):
    """``(loss + MOE_LB_COEFF sum(lb) + MOE_Z_COEFF sum(z), loss, lb, z)``
    of one forward, ``lb`` and ``z`` the layers' aux losses
    ``[MOE_LAYERS]`` (the model's ``intermediates``)."""
    inter: dict = {}
    loss = model(toks, labels, intermediates=inter, **kw)
    lb = torch.stack([inter[f"layer_{i}.moe_lb_loss"]
                      for i in range(MOE_LAYERS)])
    z = torch.stack([inter[f"layer_{i}.moe_z_loss"]
                     for i in range(MOE_LAYERS)])
    return (loss + MOE_LB_COEFF * lb.sum() + MOE_Z_COEFF * z.sum(), loss,
            lb.detach(), z.detach())


def _moe_dense_digests(named: dict) -> dict:
    """The bit digests (:func:`_bits_digest`) of every leaf not under
    ``experts``: the leaves the ranks hold alike."""
    return {n: _bits_digest(t.contiguous().reshape(-1))
            for n, t in named.items()
            if ".experts." not in n}


def _moe_wide(dev, seed: int, rank: int) -> dict:
    """(d) on an expert rank: one MoELayer at GPT-3 1.3B's widths with
    MOE_WIDE_EXPERTS experts, top MOE_WIDE_TOP_K, ep = MOE_EP (bf16, the
    router fp32, capacity factor 1.25), on the rank's MOE_SEQ random
    tokens: the routing in both forms, then forward and backward under
    ``gather`` and under ``onehot`` on the same weights and tokens."""
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.transformer.moe import (MoELayer,
                                                resolve_dispatch_mode)
    from apex_tpu_torch.transformer.moe.layer import (
        compute_dispatch_and_combine, compute_dispatch_indices)
    bf = torch.bfloat16
    h = GPT_CFG["hidden_size"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 40)
    layer = MoELayer(MOE_WIDE_EXPERTS, h, 4 * h, top_k=MOE_WIDE_TOP_K,
                     expert_parallel_size=MOE_EP, params_dtype=bf,
                     device=dev, generator=gen)
    cap = layer.capacity_for(MOE_SEQ)
    xgen = torch.Generator(device=dev)
    xgen.manual_seed(seed + 41 + rank)
    x, dy = (torch.randn(MOE_SEQ, h, generator=xgen, device=dev).to(bf)
             for _ in range(2))
    e = MOE_WIDE_EXPERTS
    with torch.no_grad():
        gates, idx, _ = layer.router(x)
        slot_token, token_slot, _ = compute_dispatch_indices(gates, idx, e,
                                                             cap)
        dispatch, _ = compute_dispatch_and_combine(gates, idx, e, cap)
    filled = slot_token < MOE_SEQ
    ee, cc = filled.nonzero(as_tuple=True)
    kept = token_slot < e * cap
    ss, kk = kept.nonzero(as_tuple=True)
    slots_equal = (
        int(dispatch.sum()) == int(filled.sum()) == int(kept.sum())
        and bool((dispatch[slot_token[ee, cc], ee, cc] == 1).all())
        and bool((dispatch[ss, token_slot[ss, kk] // cap,
                           token_slot[ss, kk] % cap] == 1).all()))
    del dispatch, gates, idx
    out = dict(auto=resolve_dispatch_mode("auto", e, MOE_SEQ, cap, h),
               layer_mode=layer.dispatch_mode, cap=cap,
               slots_equal=slots_equal, filled=int(filled.sum()),
               n=sum(p.numel() for p in layer.parameters()))
    # one untimed pass a mode first: the first products of these shapes
    # in the process pay their one-time setup
    for mode in ("gather", "onehot"):
        layer.dispatch_mode = mode
        y, _ = layer(x.clone().requires_grad_())
        y.backward(dy)
    del y
    first = None
    for mode in ("gather", "onehot"):
        layer.dispatch_mode = mode
        layer.zero_grad(set_to_none=True)
        xr = x.clone().requires_grad_()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = _build.launch_counts()
        with _timed_collectives() as coll:
            t1 = time.perf_counter()
            y, aux = layer(xr)
            y.backward(dy)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t1
        run = dict(y=y.detach(), gx=xr.grad,
                   grads={n: p.grad.clone() for n, p in
                          layer.named_parameters()},
                   load=aux["expert_load"].cpu(),
                   dropped=aux["dropped_fraction"].item())
        out[mode] = dict(seconds=seconds, peak=torch.cuda.max_memory_allocated(),
                         a2a=[t_ for n_, t_ in coll if n_ == "all_to_all"],
                         launches=_counts_since(before),
                         dropped=run["dropped"])
        if first is None:
            first = run
            continue
        out["load_equal"] = torch.equal(first["load"], run["load"])
        out["dropped_equal"] = first["dropped"] == run["dropped"]
        out["y_err"] = ((first["y"].float() - run["y"].float()).abs().max()
                        / first["y"].float().abs().max()).item()
        out["rel"], out["equal"] = {}, {}
        for name, a_, b_ in [("x", first["gx"], run["gx"])] + [
                (n, first["grads"][n], run["grads"][n])
                for n in first["grads"]]:
            out["rel"][name] = ((a_.float() - b_.float()).norm()
                                / a_.float().norm()).item()
            out["equal"][name] = torch.equal(a_, b_)
        out["equal"]["y"] = torch.equal(first["y"], run["y"])
    del layer, first, run
    torch.cuda.empty_cache()
    return out


def _moe_train_rank(rank, tmp, seed):
    """One expert rank of the moe_train phase, on cuda:0 over gloo: (a)
    the ep = 1 model on both ranks' sequences, (b) the ep = MOE_EP model
    on the same weights (``shard_moe_params``) on its own, its grads
    reduced by ``reduce_moe_grads`` and held to (a)'s here (so no grads
    cross the process), (c) MOE_ADAM_STEPS ``fused_adam`` steps with
    attention dropout, (d) the 128-expert layer.  Writes what it saw to
    ``tmp/rank<rank>.pt``."""
    import datetime
    import os
    import torch.distributed as dist
    from apex_tpu_torch import train_step
    from apex_tpu_torch.inference.weights import (load_jax_params,
                                                  shard_moe_params)
    from apex_tpu_torch.optimizers import functional
    from apex_tpu_torch.parallel import _comm
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.transformer import parallel_state
    from apex_tpu_torch.transformer.moe import reduce_moe_grads
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(
        str(Path(tmp) / "store"), MOE_EP), rank=rank, world_size=MOE_EP,
        timeout=datetime.timedelta(seconds=600))
    out = {}
    try:
        t0 = time.perf_counter()
        parallel_state.initialize_model_parallel(
            expert_model_parallel_size_=MOE_EP)
        dgroup = parallel_state.resolve_group(
            parallel_state.get_dense_param_grad_axes())
        toks, labels = _moe_tokens(dev, seed)
        n_local = MOE_EXPERTS // MOE_EP
        mine = slice(rank * n_local, (rank + 1) * n_local)

        def group_mean(x):
            x = x.detach().float().reshape(1).clone()
            return _comm.all_reduce(x, dgroup).item() / MOE_EP

        # (a) ep = 1, each rank's sequence in turn, the grads averaged
        _, ref = _moe_model(dev, seed)
        out["setup_s"] = time.perf_counter() - t0
        out["n"] = sum(p.numel() for p in ref.parameters())
        before = _build.launch_counts()
        a = dict(loss=[], lb=[], z=[])
        avg: dict = {}
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i in range(MOE_EP):
            ref.zero_grad(set_to_none=True)
            total, loss, lb, z = _moe_loss(ref, toks[i:i + 1],
                                           labels[i:i + 1])
            total.backward()
            a["loss"].append(loss.item())
            a["lb"].append(lb.float().cpu())
            a["z"].append(z.float().cpu())
            for n, p in ref.named_parameters():
                if n in avg:
                    avg[n].add_(p.grad.float())
                else:
                    avg[n] = p.grad.float()
        for g in avg.values():
            g.div_(MOE_EP)
        torch.cuda.synchronize()
        a.update(seconds=time.perf_counter() - t1,
                 launches=_counts_since(before))
        out["a"] = a
        tree = _param_tree(ref)
        del ref
        torch.cuda.empty_cache()
        # (b) ep = MOE_EP on the same weights, this rank's sequence
        _, model = _moe_model(dev, seed, expert_model_parallel=True)
        load_jax_params(model, shard_moe_params(tree, MOE_EP, rank))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = _build.launch_counts()
        with _timed_collectives() as coll:
            t1 = time.perf_counter()
            total, loss, lb, z = _moe_loss(model, toks[rank:rank + 1],
                                           labels[rank:rank + 1])
            total.backward()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t1
        launches = _counts_since(before)
        peak = torch.cuda.max_memory_allocated()
        grads = {n: p.grad.float() for n, p in model.named_parameters()}
        t1 = time.perf_counter()
        with _timed_collectives() as rcoll:
            reduce_moe_grads(grads)
            torch.cuda.synchronize()
        reduce_s = time.perf_counter() - t1
        num = den = 0.0
        worst, equal = (0.0, ""), True
        for n, g in grads.items():
            want = avg[n][mine] if ".experts." in n else avg[n]
            e_ = float((g - want).double().norm() ** 2)
            w_ = float(want.double().norm() ** 2)
            num, den = num + e_, den + w_
            leaf = (e_ / w_) ** 0.5 if w_ > 0 else (math.inf if e_ else 0.0)
            if leaf > worst[0] or not worst[1]:
                worst = (leaf, n)
            equal = equal and torch.equal(g, want)
        out["b"] = dict(loss=loss.item(), lb=lb.float().cpu(),
                        z=z.float().cpu(), mean=group_mean(loss),
                        seconds=seconds, coll=list(coll), rcoll=list(rcoll),
                        peak=peak, reduce_s=reduce_s, launches=launches,
                        rel=(num / den) ** 0.5, worst=worst, equal=equal,
                        digests=_moe_dense_digests(grads),
                        n=sum(p.numel() for p in model.parameters()))
        del model, grads, avg
        torch.cuda.empty_cache()
        # (c) FusedAdam steps at ep = MOE_EP, attention dropout
        _, model = _moe_model(dev, seed, expert_model_parallel=True,
                              attention_dropout=LM_DROPOUT)
        load_jax_params(model, shard_moe_params(tree, MOE_EP, rank))
        del tree
        tx = functional.fused_adam(lr=TRAIN_LR)
        state = train_step.init_train_state(tx, model, loss_scale="dynamic")
        offsets = {".".join(re.findall(r"\['([^']*)'\]", key)): (o, n)
                   for key, (o, n, _) in
                   train_step.leaf_offsets(model).items()}

        def reduce(flat):
            reduce_moe_grads({k: flat[o:o + n]
                              for k, (o, n) in offsets.items()})
            return flat

        step = train_step.make_train_step(
            lambda m, b: _moe_loss(m, b["tokens"], b["labels"],
                                   deterministic=False,
                                   generator=b["generator"])[0],
            tx, grad_transform=reduce)
        c = dict(losses=[], local=[], step_s=[], digests=[], coll=[])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = _build.launch_counts()
        for i in range(MOE_ADAM_STEPS):
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed * 1000 + 10 * i + rank)
            # the first step's collectives timed; the last step's time is
            # the rank's step time
            timed = _timed_collectives() if i == 0 \
                else contextlib.nullcontext([])
            with timed as rec:
                t1 = time.perf_counter()
                state, loss = step(state, dict(tokens=toks[rank:rank + 1],
                                               labels=labels[rank:rank + 1],
                                               generator=gen))
                torch.cuda.synchronize()
                c["step_s"].append(time.perf_counter() - t1)
            c["coll"].append(list(rec))
            c["local"].append(loss.item())
            c["losses"].append(group_mean(loss))
            master = state.opt.master
            c["digests"].append(_moe_dense_digests(
                {k: master[o:o + n] for k, (o, n) in offsets.items()}))
        c.update(launches=_counts_since(before), n=state.opt.master.numel(),
                 peak=torch.cuda.max_memory_allocated())
        out["c"] = c
        del state, step, model
        torch.cuda.empty_cache()
        # (d) the 128-expert layer, both dispatch modes
        out["d"] = _moe_wide(dev, seed, rank)
    finally:
        parallel_state.destroy_model_parallel()
        dist.destroy_process_group()
    torch.save(out, Path(tmp) / f"rank{rank}.pt")


def _moe_coll(rec) -> str:
    """The all-to-alls and the all-reduces of a run: count and seconds."""
    return _coll_line([(n, t) for n, t in rec
                       if n in ("all_to_all", "all_reduce")])


def _moe_train_gates(ranks, smi) -> None:
    """What the parent holds the moe_train ranks to (the module
    docstring's item 24)."""
    fwd = dict(layer_norm=2 * MOE_LAYERS + 1, flash_attention=MOE_LAYERS)
    bwd = dict(layer_norm_bwd=2 * MOE_LAYERS + 1,
               flash_attention_bwd=MOE_LAYERS)
    for rank, r in enumerate(ranks):
        a, b = r["a"], r["b"]
        # (a) and (b): the loss and each layer's aux losses
        loss_a = a["loss"][rank]
        print(f"moe_train (b) rank {rank}, ep = {MOE_EP} against (a) ep = 1 "
              f"on its sequence: loss {b['loss']:.6f} against {loss_a:.6f} "
              f"(|diff| {abs(b['loss'] - loss_a):.3e}, limit {TOL_MOE_LOSS}); "
              f"lb {[round(float(x), 6) for x in b['lb']]} against "
              f"{[round(float(x), 6) for x in a['lb'][rank]]}; z "
              f"{[round(float(x), 5) for x in b['z']]} against "
              f"{[round(float(x), 5) for x in a['z'][rank]]}")
        if not abs(b["loss"] - loss_a) <= TOL_MOE_LOSS:
            raise AssertionError(f"moe_train (b) rank {rank}: the loss is "
                                 f"off ep = 1's")
        for name in ("lb", "z"):
            diff = (b[name] - a[name][rank]).abs()
            lim = TOL_MOE_LOSS * torch.clamp(a[name][rank].abs(), min=1.0)
            if not bool((diff <= lim).all()):
                raise AssertionError(f"moe_train (b) rank {rank}: the "
                                     f"layers' {name} losses are off ep = 1's")
        print(f"  moe_train (b) rank {rank}: grads after reduce_moe_grads "
              f"against (a)'s average over the two sequences (the experts "
              f"the rank's slice), all {b['n']} elements: relative L2 "
              f"{b['rel']:.4e} over all, the worst leaf {b['worst'][1]} "
              f"{b['worst'][0]:.4e} (limit {TOL_MOE_GRAD_REL} on each); "
              f"equal to (a) bit for bit {b['equal']}")
        if not (b["rel"] <= TOL_MOE_GRAD_REL
                and b["worst"][0] <= TOL_MOE_GRAD_REL):
            raise AssertionError(f"moe_train (b) rank {rank}: the grads are "
                                 f"off ep = 1's")
        _cp_hold_launches(f"moe_train (a) rank {rank}", a["launches"],
                          {k: MOE_EP * v for k, v in {**fwd, **bwd}.items()})
        _cp_hold_launches(f"moe_train (b) rank {rank}", b["launches"],
                          {**fwd, **bwd})
    if any(r["b"]["digests"] != ranks[0]["b"]["digests"] for r in ranks):
        raise AssertionError("moe_train (b): the reduced dense and router "
                             "grads differ between the ranks")
    print(f"  moe_train (b): the reduced dense and router grads equal bit for "
          f"bit on the {MOE_EP} ranks ({len(ranks[0]['b']['digests'])} "
          f"leaves); (b)'s mean loss {ranks[0]['b']['mean']:.6f}")
    # (c) FusedAdam steps
    c = [r["c"] for r in ranks]
    losses = c[0]["losses"]
    print(f"moe_train (c) {MOE_ADAM_STEPS} FusedAdam steps at ep = {MOE_EP}, "
          f"attention dropout {LM_DROPOUT}, loss + {MOE_LB_COEFF} sum(lb) + "
          f"{MOE_Z_COEFF} sum(z) averaged over the ranks "
          f"{[round(x, 5) for x in losses]} (the ranks' own "
          f"{[[round(x, 5) for x in r['local']] for r in c]})")
    if any(r["losses"] != losses for r in c):
        raise AssertionError("moe_train (c): the ranks' mean losses differ")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"moe_train (c): the loss did not fall: "
                             f"{losses}")
    for i in range(MOE_ADAM_STEPS):
        if any(r["digests"][i] != c[0]["digests"][i] for r in c):
            raise AssertionError(f"moe_train (c): the ranks' dense or router "
                                 f"masters differ after step {i + 1}")
    print(f"  moe_train (c): the dense and router fp32 masters equal bit for "
          f"bit on the {MOE_EP} ranks after each step "
          f"({len(c[0]['digests'][0])} leaves; a rank's flat length "
          f"{c[0]['n']})")
    for rank, r in enumerate(c):
        _cp_hold_launches(f"moe_train (c) rank {rank}", r["launches"], {
            "layer_norm": MOE_ADAM_STEPS * fwd["layer_norm"],
            "layer_norm_bwd": MOE_ADAM_STEPS * bwd["layer_norm_bwd"],
            "flash_attention_drop": MOE_ADAM_STEPS * MOE_LAYERS,
            "flash_attention_bwd_drop": MOE_ADAM_STEPS * MOE_LAYERS,
            "fused_scale": MOE_ADAM_STEPS, "fused_adam": MOE_ADAM_STEPS})
    # (d) the 128-expert layer
    for rank, r in enumerate(ranks):
        d = r["d"]
        print(f"moe_train (d) rank {rank}: MoELayer {MOE_WIDE_EXPERTS} experts "
              f"top-{MOE_WIDE_TOP_K}, [{MOE_SEQ}, {GPT_CFG['hidden_size']}] "
              f"bf16 a rank, ep = {MOE_EP} ({d['n']} parameters a rank), "
              f"capacity {d['cap']}: \"auto\" resolves to {d['auto']!r}; "
              f"both forms route alike {d['slots_equal']} ({d['filled']} "
              f"slots filled), drops {d['gather']['dropped']:.4f} / "
              f"{d['onehot']['dropped']:.4f}, loads equal {d['load_equal']}; "
              f"gather against onehot: y max|diff| {d['y_err']:.3e} of its "
              f"max (limit {TOL_MOE_WIDE_OUT:.3e}), the grads' relative L2 "
              f"at most {max(d['rel'].values()):.3e} (limit "
              f"{TOL_FLASH_BWD_REL_L2}); bit for bit "
              f"{sorted(k for k, v in d['equal'].items() if v)}, not "
              f"{sorted(k for k, v in d['equal'].items() if not v)}")
        if d["auto"] != "gather" or d["layer_mode"] != "auto":
            raise AssertionError("moe_train (d): \"auto\" did not pick gather "
                                 "at 128 experts")
        if not (d["slots_equal"] and d["load_equal"] and d["dropped_equal"]):
            raise AssertionError("moe_train (d): gather and onehot route "
                                 "differently")
        if not (d["y_err"] <= TOL_MOE_WIDE_OUT
                and max(d["rel"].values()) <= TOL_FLASH_BWD_REL_L2):
            raise AssertionError("moe_train (d): gather and onehot disagree")


def phase_moe_train(dev, seed: int):
    """MoE training at ep = 2 on the one card (the module docstring's
    item 24): two spawned ranks on cuda:0 over gloo
    (:func:`_moe_train_rank`), held here.  Returns the ranks' launches of
    (b) and (c), summed."""
    import tempfile
    import torch.multiprocessing as mp
    smi = _smi()
    t_phase = time.perf_counter()
    _card_memory("moe_train, before the ranks")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_moe_") as tmp_dir:
        tmp = Path(tmp_dir)
        t0 = time.perf_counter()
        mp.start_processes(_moe_train_rank, nprocs=MOE_EP,
                           start_method="spawn", args=(str(tmp), seed))
        ranks_s = time.perf_counter() - t0
        ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                 for r in range(MOE_EP)]
    _moe_train_gates(ranks, smi)
    total: dict = {}
    for rank, r in enumerate(ranks):
        a, b, c, d = r["a"], r["b"], r["c"], r["d"]
        print(f"moe_train rank {rank} (GPT-3 1.3B widths, {MOE_LAYERS} "
              f"layers, {MOE_EXPERTS} experts top-{MOE_TOP_K}, {r['n']} "
              f"parameters at ep = 1, bf16): (a) ep = 1 forward + backward "
              f"of both sequences {a['seconds']:.3f} s; (b) ep = {MOE_EP} "
              f"forward + backward {b['seconds']:.3f} s, peak "
              f"{b['peak'] / 2**30:.2f} GiB, {_moe_coll(b['coll'])}; "
              f"reduce_moe_grads {b['reduce_s']:.3f} s "
              f"({_moe_coll(b['rcoll'])}) [{smi}]")
        print(f"  (c) step times {[round(t, 3) for t in c['step_s']]} s (the "
              f"last without timed collectives: the rank's step time), peak "
              f"{c['peak'] / 2**30:.2f} GiB; step 1's {_moe_coll(c['coll'][0])}"
              f" (gloo, copied through the host inside the call; not an NCCL "
              f"figure) [{smi}]")
        for mode in ("gather", "onehot"):
            print(f"  (d) {mode}: forward + backward {d[mode]['seconds']:.3f} "
                  f"s, peak {d[mode]['peak'] / 2**30:.2f} GiB, its "
                  f"all-to-alls {[round(1e3 * t, 2) for t in d[mode]['a2a']]}"
                  f" ms [{smi}]")
        for run in (b["launches"], c["launches"]):
            for k, v in run.items():
                total[k] = total.get(k, 0) + v
    print(f"moe_train: the ranks set up in "
          f"{max(r['setup_s'] for r in ranks):.1f} s and ran in "
          f"{ranks_s:.1f} s, the phase {time.perf_counter() - t_phase:.1f} s "
          f"[{smi}]")
    return dict(launches=total)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases",
                    default="kernels,serve,gpt,bert,bert_train,gpt_train,"
                            "gpt_train_8k,profile,train,lean_train,optim,"
                            "train-check,width,spec,tp,dp,tp_train,"
                            "pp_train,cp_train,moe_train,tier,fleet,shim",
                    help="comma list of kernels, serve, gpt, bert, "
                         "bert_train, gpt_train, gpt_train_8k, profile, "
                         "train, lean_train, optim, train-check, width, "
                         "spec, tp, dp, tp_train, pp_train, cp_train, "
                         "moe_train, tier, fleet, shim, ab "
                         "(build always "
                         "runs; profile profiles the serve and the train "
                         "phases that run)")
    ap.add_argument("--baseline", type=Path, default=None,
                    help="root of a checkout of another version: with the "
                         "ab phase, time its kernels and this tree's, A/B "
                         "in this process")
    ap.add_argument("--ab-rows", default=",".join(AB_ROWS),
                    help=f"comma list of the ab phase's rows, of "
                         f"{', '.join(AB_ROWS)}")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from apex_tpu_torch import resolve_device
    dev = resolve_device(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(_smi())                    # the card's name and power limit
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    phases = set(args.phases.split(","))
    clock = [time.perf_counter(), time.perf_counter()]

    def lap(name: str) -> None:
        """Print the seconds since the last lap, under ``name``."""
        now = time.perf_counter()
        print(f"chip_smoke: {name} took {now - clock[1]:.1f} s "
              f"({now - clock[0]:.1f} s in all)", flush=True)
        clock[1] = now
    phase_build()
    lap("build")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    recs = phase_kernels(dev, gen) if "kernels" in phases else {}
    lap("kernels")
    if "serve" in phases:
        served = phase_serve(dev, args.seed, "profile" in phases)
        for key, r in recs.items():
            if key in SERVE_KERNELS + ("flash_attention_masked",):
                r["launches"] = served["launches"][key]
        del served
        torch.cuda.empty_cache()
    lap("serve")
    if "gpt" in phases:
        gpt = phase_gpt(dev, args.seed)
        if "fused_block_decode_gpt" in recs:
            recs["fused_block_decode_gpt"]["launches"] = gpt["launches"][
                "fused_block_decode_gpt"]
        del gpt
    lap("gpt")
    if "bert" in phases:
        phase_bert(dev, args.seed)
    lap("bert")
    lm_runs, adam8k = {}, None
    for kind, (phase, *_) in LM_RUNS.items():
        if phase in phases:
            run = phase_lm_train(dev, args.seed, kind)
            for key in MD_KERNELS:
                if key in recs:
                    recs[key]["launches"] = (recs[key].get("launches") or 0) \
                        + run["launches"][key]
            lm_runs[kind] = {k: run[k] for k in ("step_s", "peak_bytes",
                                                 "tokens")}
            del run
    lap("the lm train phases")
    if "train" in phases:
        runs = phase_train(dev, args.seed, "profile" in phases)
        for key, r in recs.items():
            if key not in SERVE_KERNELS + SHIM_KERNELS + SERVE_ONLY \
                    + MD_KERNELS:
                r["launches"] = runs[KERNEL_RUN.get(key, "adam")][
                    "launches"][key]
        adam8k = runs["adam8k"]
        del runs
    lap("train")
    if "lean_train" in phases:
        lean = phase_lean_train(dev, args.seed, adam8k, lm_runs,
                                "profile" in phases)
        for key, r in recs.items():
            r["launches"] = (r.get("launches") or 0) + lean["launches"].get(
                key, 0)
        del lean
        torch.cuda.empty_cache()
    lap("lean_train")
    if "optim" in phases:
        optim = phase_optim(dev, args.seed)
        for key, r in recs.items():
            r["launches"] = (r.get("launches") or 0) + optim["launches"].get(
                key, 0)
        del optim
        torch.cuda.empty_cache()
    lap("optim")
    if "train-check" in phases:
        phase_train_check(dev, args.seed)
        phase_bert_train_check(dev, args.seed)
        phase_split_check(dev, args.seed)
        phase_rule_check(dev, args.seed)
    lap("train-check")
    if "width" in phases:
        width = phase_width(dev, args.seed)
        for key in WIDE_KERNELS:
            if key in recs:
                recs[key]["launches"] = width["launches"][key]
        del width
        torch.cuda.empty_cache()
    lap("width")
    if "spec" in phases:
        spec = phase_spec(dev, args.seed)
        for key, r in recs.items():
            r["launches"] = (r.get("launches") or 0) + spec["launches"].get(
                key, 0)
        del spec
        torch.cuda.empty_cache()
    lap("spec")
    if "tp" in phases:
        tp = phase_tp(dev, args.seed)
        for key, r in recs.items():
            r["launches"] = (r.get("launches") or 0) + tp["launches"].get(
                key, 0)
        del tp
        torch.cuda.empty_cache()
    lap("tp")
    if "dp" in phases:
        dp = phase_dp(dev, args.seed)
        for key, r in recs.items():
            r["launches"] = (r.get("launches") or 0) + dp["launches"].get(
                key, 0)
        del dp
        torch.cuda.empty_cache()
    lap("dp")
    if "tp_train" in phases:
        tpt = phase_tp_train(dev, args.seed)
        for key, r in recs.items():
            r["launches"] = (r.get("launches") or 0) + tpt["launches"].get(
                key, 0)
        del tpt
        torch.cuda.empty_cache()
    lap("tp_train")
    if "pp_train" in phases:
        ppt = phase_pp_train(dev, args.seed)
        for key, r in recs.items():
            r["launches"] = (r.get("launches") or 0) + ppt["launches"].get(
                key, 0)
        del ppt
        torch.cuda.empty_cache()
    lap("pp_train")
    if "cp_train" in phases:
        cpt = phase_cp_train(dev, args.seed)
        for key, r in recs.items():
            r["launches"] = (r.get("launches") or 0) + cpt["launches"].get(
                key, 0)
        del cpt
        torch.cuda.empty_cache()
    lap("cp_train")
    if "moe_train" in phases:
        moe = phase_moe_train(dev, args.seed)
        for key, r in recs.items():
            r["launches"] = (r.get("launches") or 0) + moe["launches"].get(
                key, 0)
        del moe
        torch.cuda.empty_cache()
    lap("moe_train")
    tier_ref = None
    for phase in ("tier", "fleet"):
        if phase not in phases:
            continue
        run = (phase_tier(dev, args.seed) if phase == "tier"
               else phase_fleet(dev, args.seed, tier_ref))
        tier_ref = run.get("ref")
        for key, r in recs.items():
            r["launches"] = (r.get("launches") or 0) + run["launches"].get(
                key, 0)
        del run
    if phases & {"tier", "fleet"}:
        _card_memory("after tier and fleet, their model still cached")
    _TIER_MODEL.clear()
    tier_ref = None
    if phases & {"tier", "fleet"}:
        _card_memory("after the tier model's cache is cleared")
    torch.cuda.empty_cache()
    lap("tier and fleet")
    if "ab" in phases:
        if args.baseline is None:
            raise SystemExit("the ab phase needs --baseline")
        phase_ab(dev, args.seed, args.baseline.resolve(),
                 tuple(args.ab_rows.split(",")))
    lap("ab")
    if "shim" in phases:
        shim = phase_shim(dev, args.seed)
        for key in SHIM_KERNELS:
            if key in recs:
                recs[key]["launches"] = shim["launches"][key]
    lap("shim")
    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    print(json.dumps({"kernels": [{k: r.get(k) for k in order}
                                  for r in recs.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
