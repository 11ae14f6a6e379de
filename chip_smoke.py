#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``easydl_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

1. device: a CUDA GPU must be present; prints its ``nvidia-smi`` name and
   power limit;
2. build: compiles the flash-attention kernels from
   ``easydl_tpu_torch/ops/csrc/`` with ``nvcc`` (one process per source, all
   at once) and prints the build time, each kernel's registers and spills
   and, where the toolkit has ``cuobjdump``, its count of ``HGMMA`` (wgmma),
   ``UTMALDG`` (TMA load) and ``HMMA.1688.F32.TF32`` (mma.sync in TF32)
   instructions; fails if a tensor-core kernel spills, if a bf16 one shows
   no HGMMA or no UTMALDG, or if an f32 one shows no TF32 HMMA;
3. kernels: holds ``flash_fwd`` (O and lse), ``flash_bwd_dq`` (dq and
   Δ = rowsum(dO∘O)) and ``flash_bwd_dkv`` (dk and dv) against their plain
   PyTorch versions on the card, at the GPT-2 345M shape ([128, 1024, 64]
   bf16, causal) and at small f32 and bf16 cases (a rectangular causal one
   with dead rows and ragged tails in both lengths, a bidirectional one
   with ragged tails), at the shape 13c's Ulysses ranks give the f32
   kernels ([16, 1024, 64] f32, causal: 2 rows x 8 local heads), with the
   bounds in ``TOL``, and against autograd of
   the reference attention on the f32 upcast of the same inputs
   (``REF_TOL``); dead rows must give dq = 0 exactly; prints every reading;
   times each kernel, its plain version and
   ``F.scaled_dot_product_attention`` (the yardstick only) with CUDA
   events over windows of back-to-back calls (``cuda_ms``), prints the
   host time per call beside them, and reckons each kernel's bound from
   its shapes;
4. main path: GPT-2 345M at full width (24 layers, d_model 1024, 16 heads,
   vocab 50304, seq 1024), bf16 model dtype, f32 masters, AdamW(2e-4,
   weight decay 0.01), global batch 16 with grad_accum 2 (the set-up in
   ``easydl_tpu_torch/scripts/gpt345m.py``), through the registry's bundle and ``Trainer.train_step``: 1 warm-up step and 3 timed
   steps; asserts finite losses near ln(vocab) and that every attention call
   launched the kernels (24 layers x 2 microbatches x 4 steps each); step
   time is the timed window's total over its 3 steps; then one more step
   under ``torch.profiler`` for device time by kernel;
5. model check: the trained model's bf16 logits with flash attention
   against the reference attention, elementwise and in relative L2, and
   their losses (bounds in ``MODEL_CHECK``); then one microbatch's
   backward through both, and through the plain backward, every
   parameter's gradient in relative L2 (``GRAD_REL``, ``QK_REF_REL``);
6. bench configuration: ``bench.py``'s model options on the same set-up
   (``gpt345m.BENCH``: remat of every block under the "dots" policy), with
   the phase 4-5 objects freed first:
   a. 1 warm-up and 3 timed steps; each attention call launches
      ``flash_fwd`` twice (the backward recomputes the forward) and each
      backward kernel once; step time, tokens/s, MFU and peak memory beside
      phase 4's; the losses equal to phase 4's, step for step (the same
      weights, batches and kernels); one microbatch's gradients against the
      model without remat on the same weights, within ``DOTS_REL`` in
      relative L2;
   b. the chunked loss (``fused_loss=True``) on the trained weights and one
      microbatch, against the same loss with the tied head's product in f32
      over the full logits (``gpt345m.f32_head_loss``: the f32 sums that
      the chunked loss must keep): loss within ``FUSED_LOSS_REL``, the
      gradients of the hidden states and the head within
      ``FUSED_HEAD_GRAD_REL``
      and every parameter's within ``FUSED_GRAD_REL``; prints the logits
      path's readings (its head product rounds to bf16) beside them; a peak
      memory at least the f32 logits' bytes below the logits path's;
   c. a checkpoint of the trained state (params and both Adam moments) in a
      ``tempfile.mkdtemp()`` directory, restored into a fresh ``Trainer``:
      every tensor bit-equal, and one more step from each gives the same
      loss and parameters; prints bytes, save seconds (snapshot, then the
      background write) and restore seconds;
   d. ``Evaluator.poll_once`` on that directory: its loss equals the eval
      step's on the live state; the directory is removed afterwards;
   e. the port's bench (``python -m easydl_tpu_torch.scripts.bench``:
      ``bench.py``'s b256/a32 with remat "dots") in a subprocess, after
      phase 6's objects are freed, at one warm-up and one timed step
      (``BENCH_STEPS``, a cut for the time limit); prints its JSON line;
7. the distributed path (``core/mesh.py``, ``core/sharding.py``, FSDP2), with
   phase 6's objects freed; the kernels were built in phase 2, before any
   rank starts, and ranks only load the library:
   a. phase 4's set-up through ``core.mesh.init_distributed`` in an NCCL
      group of one rank, mesh dp 1 x fsdp 1 (FSDP2 over each block and the
      root): 1 warm-up and 3 timed steps; losses within ``DIST_LOSS_ABS``
      of phase 4's, step for step (expected equal), and the same launches;
      step time, tokens/s, MFU and peak memory beside phase 4's; one more
      step under the profiler, in which the step's collectives must go
      through NCCL (at one rank NCCL launches no kernel of its own: it
      copies, or does nothing), and which prints their and FSDP2's
      annotated host and device time; FSDP2 must keep the gradients of a
      skipped reduction in f32;
   b. two ranks as two processes on ``cuda:0`` (``chip_smoke.py --rank R
      DIR``) over gloo, named explicitly since NCCL refuses two ranks on one
      device: ``DIST_STEPS`` steps at dp 2 and at dp 1 x fsdp 2 of GPT-2
      345M's width at ``DIST_LAYERS`` layers (a cut of depth for the time
      limit), losses within ``DIST_LOSS_ABS`` of one process's on the same
      batches, the parameters within ``DIST_PARAM_REL`` (relative L2) of
      its after the same steps; the same at fsdp 2 under an uneven mask, sound and with a
      planted fault, which must fail the bound; every run launches each
      kernel once per layer and microbatch on each rank;
   c. the fsdp 2 ranks' checkpoint (each rank its own chunks, rank 0
      commits) restored into one process: every parameter and Adam moment
      bit-equal (sha256) to the ranks' state; prints save and restore
      seconds;
   d. tensor parallelism: four ranks as four processes on ``cuda:0``
      (``chip_smoke.py --tp-rank R DIR``) over gloo, ``DIST_STEPS`` steps
      at fsdp 2 x tp 2 and at dp 2 x tp 2 (each rank its batch
      coordinate's rows, a tp group the same ones) of GPT-2 345M's width
      at ``DIST_LAYERS`` layers (a cut of depth for the time limit): losses
      within ``DIST_LOSS_ABS`` of one process's on the same
      batches, the parameters within ``DIST_PARAM_REL`` of its after the same steps, and a
      planted fault (the column-parallel inputs' gradient left un-reduced
      over tp) above it; every rank launches each bf16 kernel once a layer
      and microbatch, on its local heads only ([4·8, 1024, 64]); step
      seconds and each rank's peak memory; the fsdp 2 x tp 2 ranks save
      and take one more step, the save restores bit-equal (sha256) in one
      process and that process's next step is the ranks' (loss within
      ``DIST_LOSS_ABS``, parameters within ``DIST_PARAM_REL``);
8. the elastic worker (``elastic/worker.py``) under the port's master
   and agents (``elastic/master.py``, ``elastic/agent.py``), with phase
   7's objects freed: ``job.json`` is phase 4's set-up at ``DIST_LAYERS``
   layers (``WORKER_JOB``, GPT size ``SHALLOW``: a cut of depth for the
   time limit; Adam(2e-4) as the JAX worker's), world 1 on ``cuda:0``, the
   agents' worker command ``python -m
   easydl_tpu_torch.scripts.instrumented_worker DIR --gpt-size ...``
   (which records each rank's launches and the hashes of every state it
   saves or restores, and adds the size in each of its processes). Agent
   a0 runs generation 1; a replacement agent a1 on the same card registers
   as a standby. Once the metrics show step 2, a0 gets the host's
   preemption notice (``Agent.notify_preemption``, its SIGTERM handler):
   the master drains it by a QUIESCE directive, its worker exits 0 with a
   committed checkpoint at its quiesce step q, and the master starts
   generation 2 on a1, which restores q and trains to step 16 (the final
   save, ``DONE``). One card holds one rank a
   generation (two agents cannot share it in one NCCL group), so the
   generation switch comes from a preemption, not a resize. Checks: the
   master ended the job (``wait_done``) at generation 2 on a1 after one
   ``preemption`` reshape, a0 quiesced and a1 spawned generation 2; no
   step lost or repeated; every record has the protocol's keys
   and an MFU; each generation launched each kernel ``DIST_LAYERS``
   layers x 2 microbatches x its steps; the state restored at q is
   bit-equal (sha256) to the state saved at q; each generation's first
   loss within ``DIST_LOSS_ABS`` of the same step in this process (from
   the init, or ``Trainer.restore_from`` of q; the first batch of
   ``make_data(16, seed=0)``). Prints the worker's step time, tokens/s and
   MFU, the generation switch from both agents' timelines (from the
   notice, and ``quiesce_ckpt_begin`` to ``first_step_done``), the seconds
   from the notice to the master's quiesce directive (a0's
   ``quiesce_sent``), and whether the Brain's policy runs its native core
   (``brain_core.cc``) on this host;
9. file-backed token data and the worker's recovery paths, phase 8's job
   on ``FILE_TOKENS`` seeded ids (vocab 50304) in two ``tokens-*.npy``
   shards written by ``data.write_token_shards``, a 5% val split, 14 steps
   over three generations played by ``instrumented_worker`` (without its
   state hashes, so the worker's own save and restore are timed) as the
   agent: generation 1 cold, SIGUSR1 at step 2; generation 2 promoted from
   a warm standby started with generation 1; generation 3 from a preflight
   started as generation 2 is promoted (which straggles
   ``FILE_STRAGGLE_S`` a step through the chaos hook, so that it still
   trains when the preflight is ready), SIGUSR1 to generation 2 once it
   has trained a step and the preflight is ready, then the go; then the evaluator pod on the workdir.
   Checks: steps 1-14, none lost or repeated, each generation with one; the
   batch of every step bit-equal (sha256) to an uninterrupted
   ``TokenFileDataset``'s; each generation's first loss within
   ``DIST_LOSS_ABS`` of a step in this process from the same state (the
   init, or the checkpoint it restored) on the same batch; generations 2
   and 3 restored every chunk from the host chunk cache and none from
   storage; the kernels launched ``DIST_LAYERS`` x 2 times a step, and the
   preflight's own as many; only generation 2's steps straggled; the pod
   (``chip_smoke.py --evaluator``, which adds the size) evaluated step 14, its
   loss within ``DIST_LOSS_ABS`` of this process's on the val split's first
   batch. Prints each switch by timeline phase (the warm and the preflight
   one beside phase 8's cold one), the restore seconds against phase 8's,
   one restore in this process from the cache against one from storage
   (alternated, two each), and what the preflight held on the card while
   it waited;
10. BERT-base masked-LM pretraining (BASELINE config 3), with phase 9's
   objects freed: 12 layers, d_model 768, 12 heads of 64, seq 512, vocab
   30720, the model in f32 as the JAX bundle has it, so that attention runs
   the f32 kernels (``flash_fwd_f32_sm90.cu`` and ``flash_bwd_f32_sm90.cu``,
   on the tensor cores in 3xTF32), non-causal; TF32 stays off for the
   model's own products (the
   bundle's loss refuses it on the card); a-c run in a process of their own
   (``chip_smoke.py --bert CARD OUT``), whose profiler sees the card:
   a. the three f32 kernels against their plain versions and the reference
      attention's autograd at [96, 512, 64] (a microbatch of 8 x 12 heads),
      within ``TOL`` and ``REF_TOL`` in f32; O also within ``F32_FWD_REL``
      and dq, dk and dv within ``F32_GRAD_REL`` of the plain versions in
      relative L2, where the same kernels fed q, k, v (and dO) rounded to
      TF32 (``tf32_round``, a planted fault: what a kernel that dropped the
      small parts of the split would give) must read above it; O, lse, dq,
      Δ, dk and dv of two calls on the same inputs bit-equal; timed as in
      phase 3 beside
      ``F.scaled_dot_product_attention`` in f32, their bounds reckoned at
      the 3xTF32 rate (``TF32X3_PEAK_FLOPS``) and at the CUDA cores' f32
      rate (``F32_PEAK_FLOPS``). The small f32 cases of phase 3 hold the
      same bound, fault and determinism;
   b. through the registry's bundle and ``Trainer.train_step``: bf16
      compute cast, phase 4's optimizer, global batch 32 in 4 microbatches
      (16,384 tokens a step), 1 warm-up and 3 timed steps; finite losses,
      the first within 1.0 of ln(30720); each f32 kernel launched 12 layers
      x 4 microbatches x 4 steps times and no bf16 kernel; every
      microbatch's mask, drawn on the card, bit-equal to ``core/prng.py``'s
      draw on the CPU for its (seed, step, microbatch); step time, tokens/s
      and peak memory; one step under the profiler and its idle share;
   c. the trained model's logits and one microbatch's gradients through
      the f32 kernels against the reference attention's, in relative L2
      (``BERT_MODEL_REL``), between the sound reading and a planted
      fault's (q, k and v rounded to bf16);
   d. the elastic worker (``instrumented_worker``, state hashes on) on a
      BERT-base job over ``BERT_TOKENS`` seeded ids in token shards, 6
      steps, a periodic save every 2, under the port's master and one
      agent (``control_plane``): the agent's worker SIGKILLed
      (``Agent.kill_worker_hard``) once its metrics show step
      ``BERT_KILL_AT`` and step 2 is committed; the agent reports it, the
      master reshapes (``member-lost``) and starts generation 2 on the same
      agent, which restores the newest committed step and replays the
      rest. Checks: the master ended the job at generation 2 on a0 after
      one such reshape; no step lost;
      no ``mfu`` key (BERT has no MFU numerator, as in the JAX worker); the
      restored state bit-equal (sha256) to the saved one; each replayed
      loss within ``BERT_REPLAY_ABS`` of the killed generation's, and the
      first replayed step with the mask of the step after it (in this
      process, from the same checkpoint and batch) above that bound;
      generation 2's launches. Prints the recovery, seconds from the kill
      to each timeline phase of generation 2, and the steps replayed;
11. ResNet-50, BASELINE config 2 ("ResNet-50/ImageNet all-reduce DDP"),
   with phase 10's objects freed, in a process of its own (``chip_smoke.py
   --resnet CARD OUT``): 224x224x3 images, 1000 classes, width 64, stages
   (3, 4, 6, 3) of bottleneck blocks with GroupNorm, through the
   registry's bundle and ``Trainer.train_step``, the runner's AdamW (lr
   1e-3, weight decay 1e-4), the bf16 compute cast over f32 masters, the
   model computing in f32 with TF32 off; no flash kernel on its path (the
   JAX model reaches no Pallas kernel either):
   a. global batch 64 in 2 microbatches of 32, the batches drawn before
      the clock, 1 warm-up and 3 timed steps: finite losses, the first
      within ``RESNET_FIRST_LOSS_ABS`` of ln(1000) (the head is zero at
      init), no flash kernel launched, the JAX tree's parameter count
      (``RESNET_PARAMS``, reckoned through the bundle's layout); step time,
      images/s, peak memory; one step under the profiler, its device time
      by the host op that launched each kernel (convolutions with their
      SAME pads, GroupNorm, head and loss, the rest) and the idle share;
   d. a checkpoint of the trained state in a ``tempfile.mkdtemp()``
      directory restored into a fresh ``Trainer``: every tensor bit-equal
      (sha256), and one more step from each (cuDNN's deterministic
      algorithms) the same loss and parameters; bytes, save and restore
      seconds;
   b. the same seeded ResNet-50 (with a seeded head, so that every
      gradient flows) and 4 images at 224: the card's f32 logits and whole
      gradient against the CPU's, in relative L2, within
      ``RESNET_CPU_REL``, which the same run with cuDNN's TF32 allowed (a
      planted fault) must exceed; the CPU's f32 against its f64 beside;
   c. config 2's all-reduce: two ranks as two processes on ``cuda:0``
      (``chip_smoke.py --resnet-rank R DIR``) over gloo at dp 2 (FSDP2's
      HSDP: each rank's gradients all-reduced over dp), ``RESNET_DIST_STEPS``
      steps, each rank its 32 rows of each global batch: the parameters
      within ``RESNET_DIST_REL`` (relative L2) of one process's after the
      same steps, and the same ranks with FSDP2's all-reduce skipped (a
      planted fault) above it; losses within ``DIST_LOSS_ABS`` of 11a's;
12. DeepFM, BASELINE config 5's model ("async PS with sparse embedding
   tables"; its PS mode is phase 14), with its table on the card, in
   a process of its own (``chip_smoke.py --deepfm CARD OUT``): the JAX
   defaults (26 sparse fields, 13 dense, vocab 1,000,000, dim 16, tower
   (400, 400, 400), FM on), seed-0 weights, ``SyntheticClicks``, the
   runner's AdamW (lr 1e-3, weight decay 1e-4), the bf16 compute cast over
   f32 masters, the tower in f32 (TF32 off); no flash kernel on its path
   (the JAX DeepFM reaches no Pallas kernel either):
   a. global batch 4096 in 2 microbatches of 2048, the batches drawn before
      the clock, 1 warm-up and 3 timed steps: finite losses, no flash
      kernel launched, the JAX tree's parameter count (``DEEPFM_PARAMS``);
      step time, examples/s, peak memory; one step under the profiler, its
      device time by the host op that launched each kernel (the bf16
      casts, the gather and its backward, FM and the loss, the products,
      AdamW, the batch upload, the rest) and the idle share;
   c. the table's bf16 gradient on one microbatch of 12a's model,
      bit-equal across two calls;
   b. ``DEEPFM_CHECK_ROWS`` rows of a seeded Criteo-style TSV
      (``data.clicks.write_criteo_tsv``: hex ids above 2**31, FNV-hashed
      tokens, blank and junk cells) encoded with the port's encoder: the
      card's f32 logits and whole gradient against the CPU's, in relative
      L2, for deepfm and widedeep, within ``DEEPFM_CPU_REL``, which the
      ids folded with an int64 modulo (a planted fault) must exceed; the
      same with cuBLAS's TF32 allowed printed beside, and at bf16 compute
      the gap of the hot row (blank cells fold to id 0) and of the rest of
      the table's gradient (the CPU rounds each add in bf16, CUDA sums in
      f32);
   d. 4 steps at global batch 64 through ``ClickLogDataset`` on that
      directory, a checkpoint at step 2 with the data cursor in its
      manifest, restored into a fresh ``Trainer``: every tensor bit-equal
      (sha256), the cursor at step 2, and step 3 from the restored state
      and cursor the same loss as the first run's;
   e. two ranks as two processes on ``cuda:0`` (``chip_smoke.py
      --deepfm-rank R DIR``) over gloo at fsdp 2 (the table split on its
      ``embed`` dim), ``DEEPFM_DIST_STEPS`` steps, each rank its 2048 rows
      of each microbatch: the parameters within ``DEEPFM_DIST_REL``
      (relative L2) of one process's after the same steps, and the same
      ranks with FSDP2's reduce-scatter of the gradients handing each rank
      its own unsummed shard (a planted fault) above it; the ranks' save
      restored in one process bit-equal;
13. mixture of experts and sequence parallelism, in a process of its own
   (``chip_smoke.py --moe CARD OUT``):
   a. ``gpt_moe`` at GPT-2 345M's full width (``MOE_MODEL``: 8 experts,
      top-2, capacity factor 1.25; 1.76B parameters), bf16, f32 masters,
      phase 4's AdamW and b16/a2, 1 warm-up and 3 timed steps (remat
      "dots" only if it does not fit): finite losses, every attention
      call through the bf16 kernels, ``moe_balance`` in (0.5, experts];
      step time, tokens/s (no MFU: the bundle's FLOPs count every
      expert's parameters, as the JAX bundle's does), peak memory; one
      step under the profiler, its device time by ``moe_groups`` (the
      experts' products, dispatch and combine, routing with its
      backward, the other products, flash, AdamW, casts, the rest) and
      the idle share;
   b. one MoE layer at that width in f32 on the card against the CPU
      (``MOE_CPU_REL``, between the sound reading and cuBLAS TF32's); the
      routing of the CPU's router logits bit-equal on both;
   d. 13a's model at ``MOE_CKPT_LAYERS`` layers (a cut of depth for the time
      limit), one step from its init, saved, restored into a fresh trainer
      bit-equal, and the next step's loss and parameters the live state's;
   c. two ranks as two processes on ``cuda:0`` (``chip_smoke.py
      --moe-rank R DIR``) over gloo, 345M's width at ``MOE_DIST_LAYERS``
      layers, f32: ``gpt_moe`` at ep 2, GPT at sp 2 with Ulysses and with
      ring attention, against one process (``MOE_DIST_REL``), each with a
      planted fault above it (the experts' outputs unsummed over ep, the
      replicated gradients unsummed over sp); the f32 flash launches of
      every rank (none under ring);
14. the parameter-server path, BASELINE config 5's deployment ("async PS
   with sparse embedding tables"), in a process of its own (``chip_smoke.py
   --ps CARD OUT``): phase 12's model with ``embedding="ps"`` (the dense
   part on the card, the 1,000,000 x 16 table on two of the port's PS pods,
   ``python -m easydl_tpu_torch.ps`` subprocesses, WAL on as the pod
   default), b4096 in one microbatch (``PsTrainer`` refuses more), the bf16
   compute cast over f32 masters with the pulled rows in f32; no flash
   kernel on its path, and none in the JAX package's PS path either (its
   lookup is host code):
   a. through a ``ShardedPsClient`` from the registry, ``PS_WARMUP``
      strict steps (pull -> step -> push), ``PS_STEPS`` timed strict steps
      and ``PS_STEPS`` timed pipelined ones (the next pull prefetched, the
      pushes behind a write-behind queue of depth ``PS_QUEUE``): finite
      losses, no flash kernel launched; step time and examples/s of both,
      the pull, upload, download and push milliseconds of a strict step,
      the card's idle share of one traced strict step, peak memory, the
      rows each shard holds, and which store each shard's table ran, which
      must be the native one;
   b. ``PS_CHECK_STEPS`` strict steps at f32 compute from the same weights,
      on the card and on the CPU, each on a fresh ``LocalPsClient(2,
      "native")``, SGD over the dense part and the table: the dense
      parameters' and the touched rows' movement from their init in
      relative L2 within ``PS_CHECK_REL``, which the card's run with the
      rows' gradient pushed at scale 2 (a planted fault) must exceed; the
      same with phase 12's AdamW over the dense part printed beside;
   c. the elastic worker in PS mode (``PS_JOB``, at 14a's width) against
      two fresh pods, two generations, each a warm standby promoted
      (``instrumented_worker.start_gated``: generation 1's imports while
      14a-14b run, generation 2's while generation 1 trains): generation 1
      gets SIGUSR1 once its metrics show step ``PS_QUIESCE_AT``, drains its
      pushes and saves ``ps-ckpt`` beside the dense state; generation 2
      restores both (the dense state's hashes the saved ones'), and its
      first loss equals, bit for bit, the loss this process computes from
      that step's checkpoint and ``ps-ckpt`` on the worker's first batch;
      at the end the pods' rows are bit-equal to the last ``ps-ckpt``;
15. the serving tier with BASELINE config 5's model, in a process of its
   own (``chip_smoke.py --serve CARD OUT``): DeepFM's dense tower at the
   JAX defaults (26 sparse fields, dim 16, 13 dense features, tower (400,
   400, 400)) scoring on the card (``serve.frontend.make_deepfm_forward``,
   f32, TF32 off), its rows pulled from two of the port's PS pods (phase
   14's table spec); no flash kernel on its path, and none in the JAX
   package's (its scorer is a jitted flax module):
   a. the forward on the card against the same forward on the CPU, the
      params given in the JAX layout, on the same pulled rows at 1, 37 and
      256 rows, within ``SERVE_CPU_REL``, which the CPU's forward on the
      rows rounded to TF32 must exceed;
   b. two in-process ``ServeFrontend``s (gRPC, ``HotIdCache`` each) behind
      the port's ``ServeRouter``: ``SERVE_THREADS`` closed-loop clients,
      ``SERVE_WARMUP`` then ``SERVE_REQUESTS`` requests of ``SERVE_ROWS``
      rows (Zipf ids, dense features); prints p50/p99, QPS by replica and
      for the fleet, sheds, hard errors (none allowed), mean rows a batch,
      a batch's pull (host clock) and forward (CUDA events, the copies
      included) ms, the cache's hit ratio, and the card's idle share over
      ``SERVE_PROFILED`` more requests under the profiler;
   c. acknowledged pushes to the traffic's hottest ids: each next read
      through a replica's cache bit-equal to a direct pull;
   d. v1 and v2 (a perturbed tower) published with ``loop.publish``; a
      ``ModelVersionWatcher`` builds each forward on its thread and swaps
      it in: the next batch scores as v2's CPU forward; the ``Rollout``
      RPC's rollback brings back v1's scores; a v3 with one byte flipped is
      quarantined unbuilt and v2 served again;
   e. one ``python -m easydl_tpu_torch.serve --deepfm`` replica on the
      card (``serve.launch.spawn_replicas``, started with the phase so that
      its start runs beside 15a-15d) answers ``Infer`` RPCs within
      ``SERVE_CPU_REL`` of the same-seed forward on the CPU, and on SIGTERM
      exits 0 and removes its discovery file;
16. pipeline parallelism (``ops/pipeline.py``), with phase 15's objects
   freed, on two ranks as two processes on ``cuda:0`` over gloo
   (``chip_smoke.py --pp-rank R DIR``), held against phase 4's parameters
   after its first ``PP_STEPS`` steps (kept on the host, the reference):
   a. GPT-2 345M at full width at pp 2 (dp 1), each rank its stage's 12
      layers (its blocks alone built and drawn from the seed as the whole
      model draws them), ``PP_MICROBATCHES`` pipeline microbatches inside
      each of the 2 microbatches, no remat (each stage apply a checkpoint
      region), ``PP_STEPS`` steps (the first a warm-up): losses within
      ``DIST_LOSS_ABS`` of phase 4's, each stage's view of the parameters
      (``instrumented_worker.stage_views``) within ``DIST_PARAM_REL`` of
      phase 4's, and the same run with a planted fault (the embedding's
      gradient left unsummed over pp) above it, in all and in the
      embedding alone;
   b. from the timed steps: the step (the slower rank's), tokens/s, each
      rank's peak memory against phase 4's, each rank's launches a step
      against the schedule's (96 forward, 48 of each backward kernel), and
      the exchange's milliseconds a tick (each shift timed between two
      syncs);
   c. the ranks' save, each chunk written by one rank, restored in this
      process (beside the ranks' fault run) bit-equal (sha256), its next
      loss the ranks' within ``DIST_LOSS_ABS``; that state saved again from
      this process and restored onto pp 2 bit-equal;
17. the online loop of BASELINE config 5 (serve -> feedback -> train ->
   push -> served score), in a process of its own (``chip_smoke.py --loop
   CARD OUT``): two of the port's PS pods (WAL on, ``EASYDL_PS_SHM`` on in
   the pods alone) holding phase 14's table; one in-process
   ``ServeFrontend`` scoring with phase 15's tower on the card
   (``HotIdCache``), its feedback hook the port's ``FeedbackWriter``
   (``LabelingWriter``: each request's labels, a fixed function of its ids
   and ``LOOP_SEED``, follow its event), ``LOOP_THREADS`` closed-loop
   clients sending phase 15's draw; the port's worker
   (``instrumented_worker``) in PS mode on the spool (``LOOP_JOB``:
   ``feedback_spools``, ``LOOP_EVENTS`` events of 32 rows a step, 4096
   rows, strict steps, a save every ``LOOP_CKPT`` steps with the spool
   cursor in its manifest) under the port's master and one agent, which
   keeps a warm standby (``Agent(warm_start=True)``); no flash kernel on
   its path:
   a. ``LOOP_PROBES`` probes of the loop's lag (``scripts/bench_loop.py``'s):
      fresh sentinel ids scored, then scored again every ``LOOP_RESCORE_S``
      until the served score changes (their event trained and pushed),
      while the clients send one step's events behind each probe;
      p50 and p99 (host clock), the worker's strict step and its pull and
      push ms, the feedback writer's drops and the serving's hard errors
      (none allowed);
   b. the clients paused and resumed to a step count that leaves the
      worker past its last save; SIGKILL; the master restarts it, and
      generation 2 restores the dense state (its hashes the saved ones'),
      the tier's ``ps-ckpt`` and the cursor, and trains to ``LOOP_STEPS``:
      no step lost, the replayed ones redone, the cursor in each manifest;
      the final dense state (every parameter, Adam moment and count,
      sha256) and the touched rows (Adagrad's slots included) bit-equal
      to one uninterrupted ``PsTrainer.train_continuous`` in this process
      on the card over the same spool from the same init on a fresh
      ``LocalPsClient``; a planted fault (the resume without the cursor
      restored, so the first batches train twice) must break the equality,
      and its reading is printed;
   c. ``pull_shm`` on the same pods: a 4096-row batch's ids pulled through
      the shard's shared-memory mirrors bit-equal to the gRPC pull, both
      timed (medians of ``LOOP_SHM_REPEATS``) beside 14a's pull;
18. BASELINE config 3 submitted the reference's way, in a process of its
   own (``chip_smoke.py --operator CARD OUT``): an ElasticJob built with the
   port's ``JobSpec`` (``spec.command`` the port's runner: BERT-base at full
   width on phase 10d's token shards, ``OPERATOR_STEPS`` steps, a save every
   ``OPERATOR_CKPT``) through the port's operator
   (``scripts/operator_lifecycle.py``: ``CrStore``, ``ElasticJobController``,
   ``LocalProcessPodApi``, the standalone ``ingest`` pump; the Brain pod over
   gRPC); the pods are the port's: the trainer pod (one worker), the agent
   (``--platform cuda``) running the real ``elastic.worker``, the evaluator
   pod on the card:
   a. the operator starts the trainer pod first and alone;
   b. the trainer applies the JobResource; the operator starts one worker
      and one evaluator pod;
   c. at step ``BERT_KILL_AT`` with a save committed the worker pod (its
      agent, worker and rank) is SIGKILLed; the operator replaces it under
      a fresh name at once, and the master forms generation 2 on the new
      agent alone after one reshape;
   d. generation 2 restores the committed step and replays the steps after
      it, each loss within ``BERT_REPLAY_ABS`` of the killed generation's,
      to the last step;
   e. every pod and the job end ``Succeeded``, the pods unchanged over four
      more reconcile ticks, the last step checkpointed and evaluated;
   f. the operator decided with its native core, the port's own library;
   g. no process of a pod's or the Brain's process group is left;
   prints the seconds from the submit and from the kill beside 10d's
   same-agent restart, and the job's wall time; its workers count no
   launches (``null`` in the ``kernels`` line);
19. summary: a ``kernels`` JSON line (with each phase's launches, 7b's,
   7d's, 13c's and 16's summed over their ranks and runs, 8's, 9's, 14c's
   and 17's over their generations; the f32 kernels' rows from phase 10,
   their launches 10b's; phases 11's, 12's, 14's, 15's and 17's zeros,
   18's null), the card line, then the result line.

Each phase prints its seconds.

Where the environment tells the interpreter not to write bytecode
(``PYTHONDONTWRITEBYTECODE``), each child process would compile torch's
sources anew; the children write their bytecode to a directory of this
run's own (``PYTHONPYCACHEPREFIX``), removed at its end, so that it is
compiled once. The children of this script (the phases' own processes and
ranks, 6e's bench, 9's evaluator pod) run in spares (``Spares``):
interpreters started a phase or more before, which have imported torch and
the port by the time their child's command line comes.

Imports only the port, torch and numpy.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import hashlib
import itertools
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from unittest import mock

import numpy as np
import torch

from easydl_tpu_torch.core import jax_state, prng
from easydl_tpu_torch.core.checkpoint import CheckpointManager
from easydl_tpu_torch.core.evaluator import Evaluator
from easydl_tpu_torch.core.train_loop import fsdp_params
from easydl_tpu_torch.core.mfu import mfu, peak_flops_per_chip
from easydl_tpu_torch.models import bert
from easydl_tpu_torch.models.gpt import lm_loss
from easydl_tpu_torch.ops import build
from easydl_tpu_torch.ops import flash_attention as fa
from easydl_tpu_torch.ops.attention import reference_attention
from easydl_tpu_torch.scripts import gpt345m
from easydl_tpu_torch.scripts import instrumented_worker as iw
from easydl_tpu_torch.scripts.instrumented_worker import (read_jsonl, stage_views,
                                                          state_hashes, whole)
from easydl_tpu_torch.scripts.gpt345m import MICROBATCHES, STEPS

# H100 SXM memory rate (NVIDIA data sheet); the FLOP peak is core/mfu's
PEAK_BYTES_PER_S = 3.35e12

MAIN_BH, MAIN_S, MAIN_D = 128, 1024, 64  # 345M: microbatch 8 x 16 heads
N_LAYERS = 24
# (atol, rtol) of O and of the gradients, by dtype. bf16: the tensor-core
# kernels round P (forward), dS (dq), Pᵀ and dSᵀ (dk/dv) to bf16 before
# their second product (as the TPU kernel's default-precision dot does), the
# plain versions keep them in f32; on an H100 SXM (700 W) at the main-path
# shape that measured max |err| 0.0156 (O, dk) and 0.0312 (dv), 0.95 / 1.22
# / 1.56 of an earlier 4e-3 + 1e-2·|x|, so the bound is 1e-2 + 1e-2·|x|;
# dq reads 0.0156 there, 0.52 of it. f32: the JAX flash tests' own (2e-5
# forward, 5e-4 grads). lse and Δ are f32 on both sides and always take the
# f32 forward bound.
TOL = {torch.bfloat16: {"fwd": (1e-2, 1e-2), "grad": (1e-2, 1e-2)},
       torch.float32: {"fwd": (2e-5, 2e-5), "grad": (5e-4, 5e-4)}}
# flash vs reference attention in the trained 345M model, bf16: logits within
# LOGIT_ULPS bf16 ulps of the largest |logit| elementwise and LOGIT_REL in
# relative L2; losses within LOSS_ABS. Measured on an H100 SXM (700 W): 1.0
# ulp of the largest |logit| 2.64, relative L2 0.0035 (logit std 0.61),
# loss |diff| 2.1e-5; the bounds leave about 2x (5x for the loss).
MODEL_CHECK = {"LOGIT_ULPS": 2, "LOGIT_REL": 7e-3, "LOSS_ABS": 1e-4}
# One microbatch's backward through the trained 345M model in bf16: every
# parameter's gradient within GRAD_REL in relative L2, the bound
# tests/test_torch_gpt.py::test_bf16_model_dtype_matches_jax holds bf16
# gradients to, (1) against reference attention and (2) against the same
# forward kernel with the backward through the plain versions. The key
# biases are in neither: their gradient is 0 in exact arithmetic (softmax
# ignores a per-row shift of the scores), so it is rounding noise on every
# side. The query and key projections are not in (1): a few steps from
# the initialisation the attention is near uniform, so dS = P∘(dP − Δ) is a
# small difference, and Δ = rowsum(dO∘O) over the bf16 O (the JAX package's
# einsum, and cuDNN's) carries a rounding error that dominates it. Measured
# on an H100 against an f32 model (easydl_tpu_torch/scripts/
# attention_grad_precision.py): every flash backward that takes Δ from the
# bf16 O (these kernels, their plain versions, cuDNN's) is off the q/k
# gradients by 32.6-35.4 in relative L2, the bf16 reference einsum by 0.33;
# every other gradient by 0.06 on all sides. (2) holds the q/k gradients of
# the kernels to those of the plain versions, which share that Δ, and (1)
# holds them within QK_REF_REL of the reference's: on the same card they
# read 55.4 (q.weight, q.bias) and 55.0 (k.weight), so a kernel that does
# worse than the algorithm itself fails.
GRAD_REL = 4e-2
QK_PROJ = (".q.weight", ".q.bias", ".k.weight")
QK_REF_REL = 80.0
# flash vs autograd of the reference attention on the f32-upcast inputs, for
# the bf16 cases: the JAX flash tests' bf16 tolerance (2e-2, absolute and
# relative); in f32 the gradient tolerance above.
REF_TOL = {torch.bfloat16: (2e-2, 2e-2), torch.float32: TOL[torch.float32]["grad"]}
# Phase 6. "dots" against no remat, one microbatch's gradients in relative L2:
# the recompute reruns the same deterministic kernels on the same inputs, so
# 0 is expected; 1e-3 is the bound. The chunked loss against the same loss
# with the head product in f32 over the full logits (its f32 sums), on one
# microbatch of the trained weights; the readings on an H100 of the sound
# loss and of one whose product rounds to bf16 (PERF.md, PR 4):
# - the loss, FUSED_LOSS_REL relative: 0 sound, 3.5e-7 (4 f32 ulps) rounded;
# - the gradient of the hidden states, relative L2: 1.24e-4 sound, 2.9e-4
#   rounded;
# - the head's gradient: 7.5e-3 either way, since the chunks' head gradients
#   are summed in bf16, as the JAX op's scan sums them; its bound catches
#   gross faults only;
# - every parameter's gradient through the bf16 model, FUSED_GRAD_REL, key
#   biases left out as in GRAD_REL: 0.013-0.014 either way, the model's own
#   rounding noise.
DOTS_REL = 1e-3
FUSED_LOSS_REL, FUSED_GRAD_REL = 1e-7, 2e-2
FUSED_HEAD_GRAD_REL = {"hidden": 2e-4, "head": 1e-2}
# Phase 7, the distributed path on the one card. 7a runs phase 4's set-up
# through an NCCL group of one rank (mesh dp 1 x fsdp 1): the same weights,
# batches and kernels, so its losses are expected equal to phase 4's;
# DIST_LOSS_ABS is the bound. 7b runs two ranks as two processes on cuda:0
# over gloo (NCCL refuses two ranks on one device) for DIST_STEPS steps at
# dp 2 and at dp 1 x fsdp 2, at DIST_LAYERS layers: losses within
# DIST_LOSS_ABS of one process's; the parameters after the steps within
# DIST_PARAM_REL, in relative L2, of one process's on the same batches. The
# same at fsdp 2 under an uneven mask of the targets (the first rank of
# each microbatch keeps 64 targets a row, the second all 1024), sound and
# with a planted fault (each rank's local mean, averaged), shows what the
# bound tells apart: on an H100 SXM (700 W), at DIST_LAYERS = 4, the sound
# runs read 2.738e-4 (dp 2, fsdp 2) and 2.52e-4 (uneven), the fault
# 1.374e-2; the bound sits between, 7.3x above the one and 6.9x below the
# other (at 24 layers: 3.40e-4, 3.19e-4 and 1.77e-2). bf16 rounds each
# rank's product over its half of the rows, so the sound reading is not 0.
DIST_LOSS_ABS = 2e-3
DIST_STEPS = 2
DIST_PARAM_REL = 2e-3
DIST_DEADLINE_S = 600  # 7b's two ranks, from their start to their exit
DIST_MASK_KEEP = 64
# 7d runs four ranks on cuda:0 over gloo, at fsdp 2 x tp 2 and dp 2 x tp 2,
# with the bounds of 7b; its planted fault (the column-parallel inputs'
# gradient left un-reduced over tp) must read above DIST_PARAM_REL. On an
# H100 SXM (700 W), at DIST_LAYERS = 4, both meshes read 8.732e-4 and the
# fault 1.305e-2: the bound sits 2.3x above the one and 6.5x below the
# other (at 24 layers: 1.656e-3 and 1.673e-2).
TP_WORLD = 4
# 7b's, 7d's, 8's and 9's depth: cut from 24 for the time limit (13d's:
# MOE_CKPT_LAYERS)
DIST_LAYERS = 4
# the GPT size of phases 8 and 9 (see shallow_345m), which each of their
# processes adds
SHALLOW = "345m-shallow"
WORKER_ARGS = ["--gpt-size", f"{SHALLOW}={DIST_LAYERS},1024,16"]
# Phase 8, the elastic worker under the port's master and agents: phase 4's
# set-up at DIST_LAYERS layers as the job, with the worker's Adam(2e-4); its
# first losses are held to the in-process runs' by DIST_LOSS_ABS (expected
# equal: the same weights, batches and kernels). 16 steps: a step takes
# ~0.06 s, and the notice reaches the worker through the agent's next
# heartbeat (0.3 s), the master's directive and the quiesce consensus, so
# generation 1 quiesces 1-7 steps after step 2 (at 5 and at 9 on the card).
# No periodic save: one that falls on the quiesce step saves (and hashes)
# the same state twice.
WORKER_JOB = {"model": "gpt", "model_kwargs": {"size": SHALLOW, "seq_len": gpt345m.SEQ,
                                               "vocab": gpt345m.VOCAB, "dtype": "bfloat16"},
              "global_batch": gpt345m.GLOBAL_BATCH, "grad_accum": MICROBATCHES, "lr": 2e-4,
              "seed": 0, "sync_every": 1, "ckpt_interval": -1, "total_steps": 16}
WORKER_QUIESCE_AT = 2  # the preemption notice once the metrics show this step
# The switch (quiesce_ckpt_begin to first_step_done) and 10d's recovery (the
# kill to first_step_done), in seconds, under the agent this script played
# before the port had a control plane: PERF.md's PR 15 runs (H100 80GB HBM3,
# 700 W), printed beside this run's
EMULATED_SWITCH_S = (23.95, 31.64, 26.29)
EMULATED_RECOVERY_S = (24.09, 18.93, 20.24)
WORKER_DEADLINE_S = 300  # a generation, from its start to its exit
WORKER_KEYS = {"step", "loss", "step_time_s", "samples_per_sec", "world_size", "generation",
               "mesh", "t", "mfu"}
BENCH_DEADLINE_S = 300
# 6e's steps at b256/a32, ~11 s each: one warm-up and one timed (the bench's
# own default is 2 and 3), a cut for the script's time limit
BENCH_STEPS = ["--warmup", "1", "--timed", "1"]
# Phase 9, file-backed token data and the worker's recovery paths: phase 8's
# job on FILE_TOKENS seeded ids (vocab 50304, uint16) in two token shards
# with a 5% val split, FILE_JOB's total_steps over three generations: the first
# cold, the second promoted from a warm standby, the third from a preflight
# started as the second is promoted. The second generation straggles
# FILE_STRAGGLE_S a step (the chaos hook, on the card) so that it is still
# training when the preflight is ready, as under the master, which drains
# only then. The straggle is a cut for the time limit: a preflight started
# once generation 2 had trained a step was ready ~20 s later, 4-7 steps of
# 5 s (NVIDIA H100, its 8-core host); started with the promotion, it gets
# ready beside generation 2's restore and first step.
FILE_TOKENS = 4_200_000
FILE_JOB = {**WORKER_JOB, "total_steps": 14, "ckpt_interval": -1, "val_fraction": 0.05}
FILE_QUIESCE_AT = 2  # generation 1 gets SIGUSR1 once its metrics show this step
FILE_STRAGGLE_S = 5.0
FILE_DEADLINE_S = 240  # each wait of the phase
# Phase 10, BERT-base masked-LM pretraining (BASELINE config 3): 12 layers,
# d_model 768, 12 heads of 64, seq 512, vocab 30720, the model in f32 as the
# JAX bundle has it, so that attention runs the f32 kernels, non-causal, at
# [microbatch 8 x 12 heads, 512, 64]; phase 4's optimizer, global batch 32
# in 4 microbatches (16,384 tokens a step).
BERT_LAYERS, BERT_HEADS = 12, 12
BERT_GLOBAL_BATCH, BERT_MICROBATCHES = 32, 4
BERT_BH = BERT_GLOBAL_BATCH // BERT_MICROBATCHES * BERT_HEADS
# The FP32 rate of an H100 SXM outside the tensor cores (NVIDIA's data
# sheet). The tensor cores take TF32 (10 explicit mantissa bits) at 495
# TFLOP/s dense; split into a big and a small TF32 part, an f32 product
# costs three TF32 products at f32-level accuracy (3xTF32, the f32
# kernels), so f32-accurate work can run at 495/3 TFLOP/s: the f32 rows'
# bound, with the CUDA cores' beside it.
F32_PEAK_FLOPS = 67e12
TF32X3_PEAK_FLOPS = 495e12 / 3
# The f32 backward kernels against their plain versions: dq, dk and dv in
# relative L2. F32_GRAD_REL sits between the sound reading and a planted
# fault's: the same kernels fed q, k, v and dO rounded to TF32 (what a
# kernel that dropped the small parts would give). TOL's f32 gradient bound
# (5e-4 + 5e-4·|x|) passes that fault: its largest err/bound read 0.008-0.01
# on the sound kernels. On an H100 SXM (700 W) the sound kernels read
# 4.4-4.8e-6 at BERT-base's [96, 512, 64] (8.5e-7 to 2.2e-6 on phase 3's
# small cases), the fault 3.6-5.2e-4 everywhere; the bound sits 8x above
# the one and 9x below the other.
F32_GRAD_REL = 4e-5
# The f32 forward kernel against its plain version: O in relative L2, with
# the bound between the sound reading and the same planted fault's (q, k
# and v rounded to TF32). On an H100 SXM (700 W) the sound kernel read
# 5.62e-7 at BERT-base's [96, 512, 64] (1.9e-7 and 3.93e-7 on phase 3's
# small cases), the fault 2.95-3.74e-4. The same kernel with each product
# summed in one tensor-core accumulator (which truncates every step) read
# 4.03e-6 there (3.68e-7 and 1.4e-6), and failed 10c's gradient bound. The
# bound sits 3.6x above the sound reading at BERT-base's shape, 2x below
# that one-accumulator kernel's and 150x below the fault's.
F32_FWD_REL = 2e-6
# 10c: the trained BERT-base through the f32 kernels against the reference
# attention (f32 einsums, TF32 off), one microbatch: the logits and every
# parameter's gradient (key biases left out, see GRAD_REL) in relative L2,
# with the bound between the sound reading and that of a planted fault (q,
# k and v rounded to bf16 before the kernels). On an H100 SXM (700 W) the
# sound run read 4.02e-7 (logits) and 2.01e-4 (largest gradient, a key
# projection's: near uniform attention, see GRAD_REL), the fault 1.64e-5
# and 4.66e-3; each bound sits 5-7x above the one and 5x below the other.
# With the 3xTF32 backward kernels the same card read 4.03e-7 and 3.81e-4
# (the fault 1.64e-5 and 4.95e-3): the gradient bound now sits 2.6x above
# the sound reading and 5x below the fault's.
BERT_MODEL_REL = {"logits": 3e-6, "grads": 1e-3}
# 10d: the elastic worker on a BERT-base job over token shards, SIGKILLed
# once its metrics show step BERT_KILL_AT and the periodic save of step 2 is
# committed; the restart replays the steps after the newest committed save
# on the same batches (the checkpoint's cursor) and masks (the state's key
# and step): each replayed loss within BERT_REPLAY_ABS of the killed
# generation's, and the same step with the mask of the step after it above
BERT_JOB = {"model": "bert", "model_kwargs": {"size": "base"},
            "global_batch": BERT_GLOBAL_BATCH, "grad_accum": BERT_MICROBATCHES, "lr": 2e-4,
            "seed": 0, "sync_every": 1, "ckpt_interval": 2, "total_steps": 6}
BERT_TOKENS = 400_000
BERT_KILL_AT = 3
BERT_REPLAY_ABS = 1e-5
BERT_DEADLINE_S = 240  # each wait of 10d
# Phase 11, ResNet-50 (BASELINE config 2, "ResNet-50/ImageNet all-reduce
# DDP, static 8-worker job"): 224x224x3 images, 1000 classes, width 64,
# stages (3, 4, 6, 3) of bottleneck blocks, GroupNorm; global batch 64 in 2
# microbatches of 32 (Goyal et al.'s 32 images a GPU, for the config's 8
# workers x 32), the runner's AdamW (lr 1e-3, weight decay 1e-4), the bf16
# compute cast over f32 masters, the model computing in f32 (TF32 off). The
# head is zero at init, so the first loss is ln(1000) to f32 rounding.
RESNET_MODEL = {"size": "50"}
RESNET_GLOBAL_BATCH, RESNET_MICROBATCHES, RESNET_LR = 64, 2, 1e-3
#: the JAX tree's parameter count (tests/test_torch_resnet.py holds the
#: layout's leaves to jax.eval_shape of the JAX bundle's init)
RESNET_PARAMS = 25_557_032
RESNET_FIRST_LOSS_ABS = 1e-4
# 11b: the card's logits and gradients against the CPU's, f32, one batch of
# RESNET_CHECK_BATCH images, in relative L2 (the logits, and the gradient
# of every parameter as one vector); the planted fault is the same run with
# cuDNN's TF32 allowed. On an H100 SXM (700 W) the sound run read 7.84e-7
# (logits) and 5.07e-3 (gradient), the fault 7.33e-4 and 8.78e-2; each
# bound sits 4-25x above the one and 4-37x below the other. The gradient's
# sound reading is the model's own f32 conditioning at init, not the
# card's: the CPU's f32 gradient reads 5.1e-3 from its f64 one (its worst
# parameter 1.8e-2, a GroupNorm bias, where the card's reads 1.9e-2), so
# no single parameter is held.
RESNET_CHECK_BATCH = 4
RESNET_CPU_REL = {"logits": 2e-5, "grads": 2e-2}
# 11c: two gloo ranks on cuda:0 at dp 2 against one process, the
# parameters after RESNET_DIST_STEPS steps in relative L2; the planted fault
# is the same ranks with FSDP2's all-reduce of the gradients skipped. On an
# H100 SXM (700 W) the sound ranks read 2.24e-4 (each rank's gradient is
# rounded to bf16 before the f32 sum), the fault 6.78e-3; the bound sits
# 5.4x above the one and 5.6x below the other.
RESNET_DIST_STEPS = 2
RESNET_DIST_REL = 1.2e-3
RESNET_DEADLINE_S = 600  # 11a-11d in their process
# the profile's groups of 11a: device time by the outermost host op that
# launched it (a kernel of neither group is "the rest": ReLU, residual adds,
# the max-pool, the casts, AdamW, the grad norm)
RESNET_GROUPS = {
    "GroupNorm": ("_GroupNorm",),
    "convolutions and their SAME pads": ("conv2d", "ConvolutionBackward", "aten::pad",
                                         "ConstantPadNd"),
    "head and loss": ("aten::linear", "AddmmBackward", "aten::mean", "MeanBackward",
                      "cross_entropy", "NllLoss", "LogSoftmax"),
}
# Phase 12, DeepFM (BASELINE config 5's model) with its table on the card:
# the JAX defaults (vocab 1,000,000 x dim 16: a 64 MB f32 table, 16M of the
# model's 16.5M parameters), global batch 4096 in 2 microbatches of 2048
# (106,496 ids through the gather a step), the runner's AdamW, the bf16
# compute cast over f32 masters, the tower in f32 (TF32 off).
DEEPFM_GLOBAL_BATCH, DEEPFM_MICROBATCHES, DEEPFM_LR = 4096, 2, 1e-3
#: the JAX tree's parameter count (tests/test_torch_deepfm.py holds the
#: layout's leaves to jax.eval_shape of the JAX bundle's init)
DEEPFM_PARAMS = 16_493_618
# 12b: the card's logits and gradients against the CPU's, f32, on
# DEEPFM_CHECK_ROWS encoded rows, in relative L2 (the logits, and the
# gradient of every parameter as one vector); the planted fault is the ids
# folded with an int64 modulo instead of the JAX package's int32 wrap. On an
# H100 SXM (700 W) the sound runs read 7.4-7.5e-7 (logits) and 1.8-1.9e-7
# (gradient), the fault 1.34e-2 and 2.52e-2 at the least (widedeep), cuBLAS's
# TF32 8.6e-4 and 7.4e-3; each bound sits 13x and 520x above the sound
# readings and 1300x and 250x below the fault's.
DEEPFM_CHECK_ROWS = 256
DEEPFM_CPU_REL = {"logits": 1e-5, "grads": 1e-4}
# 12d: the file-data run's global batch (4 batches an epoch of the 256 rows)
DEEPFM_FILE_BATCH = 64
# 12e: two gloo ranks on cuda:0 at fsdp 2 against one process, the
# parameters after DEEPFM_DIST_STEPS steps in relative L2; the planted
# fault hands each rank its own unsummed shard of the gradients. On an H100
# SXM (700 W) the sound ranks read 5.42e-4 (each rank's gradient of the
# bf16 weights is rounded to bf16 before the f32 sum), the fault 3.38e-2;
# the bound sits 3.7x above the one and 17x below the other.
DEEPFM_DIST_STEPS = 2
DEEPFM_DIST_REL = 2e-3
DEEPFM_DEADLINE_S = 600  # 12a-12e in their process
# the profile's groups of 12a: device time by the outermost host op that
# launched it (the batch upload by its copies' name; a kernel of no group
# is "the rest": ReLU, the concatenation, the adds, zero_grad, the grad norm)
DEEPFM_GROUPS = {
    "the bf16 casts and their backward (the table's 16M elements)": (
        "aten::to", "aten::_to_copy", "ToCopyBackward"),
    "the gather and its backward": ("aten::embedding", "EmbeddingBackward", "aten::remainder"),
    "FM and the loss": ("aten::sum", "aten::square", "aten::pow", "aten::sub", "aten::rsub",
                        "aten::mul", "aten::neg", "aten::log_sigmoid", "SumBackward",
                        "PowBackward", "SubBackward", "RsubBackward", "MulBackward",
                        "NegBackward", "LogSigmoidBackward"),
    "the products (tower and wide)": ("aten::linear", "aten::addmm", "aten::mm",
                                      "AddmmBackward", "MmBackward"),
    "AdamW (the table's 16M of 16.5M parameters)": ("Optimizer.step",),
}
# Phase 13, mixture of experts (gpt_moe) and sequence parallelism. 13a:
# gpt_moe at GPT-2 345M's full width (24 layers, d_model 1024, 16 heads of
# 64, d_ff 4096, vocab 50304, seq 1024) with 8 experts, top-2, capacity
# factor 1.25 (320 slots an expert a row), bf16 model, f32 masters, phase
# 4's AdamW and b16/a2; no remat unless it does not fit (then "dots").
MOE_MODEL = {"size": "345m", "seq_len": gpt345m.SEQ, "vocab": gpt345m.VOCAB,
             "moe_experts": 8, "moe_k": 2, "moe_capacity_factor": 1.25, "dtype": "bfloat16"}
MOE_LAYERS, MOE_D_FF = 24, 4096
# 13b: one MoE layer at that width in f32 on the card against the CPU, the
# same weights and input (MOE_CPU_ROWS rows of 1024 tokens): the output and
# every gradient in relative L2 within MOE_CPU_REL, which the same layer
# with cuBLAS's TF32 allowed (a planted fault) must exceed; the routing of
# the CPU's router logits bit-equal on both. On an H100 SXM (700 W) the
# sound layer read 7.1e-7 to 1.29e-6, TF32 5.26e-4 to 1.40e-2: the bound
# sits 39x above the one and 10.5x below the other.
MOE_CPU_ROWS = 2
MOE_CPU_REL = 5e-5
# 13c: two gloo ranks on cuda:0 at 345M's width and MOE_DIST_LAYERS layers,
# f32 compute (TF32 off), global batch 4 in 2 microbatches, MOE_DIST_STEPS
# steps: gpt_moe at ep 2, GPT at sp 2 with Ulysses (the f32 flash kernels on
# each rank's 8 heads) and with ring attention; the parameters within
# MOE_DIST_REL (relative L2) of one process's after the same steps, which a
# skipped reduction (the experts' outputs not summed over ep; the
# replicated gradients not summed over sp) must exceed. On an H100 SXM
# (700 W): ep 2 7.1e-6, Ulysses 1.2e-6, ring 2.2e-6; the faults 1.88e-2
# (ep) and 9.7e-3 (sp): the bound sits 140x above the worst sound reading
# and 9.7x below the smaller fault.
MOE_DIST_LAYERS, MOE_DIST_STEPS, MOE_DIST_BATCH, MOE_DIST_MICRO = 2, 2, 4, 2
# 13d's depth: cut from DIST_LAYERS (4) for the time limit
MOE_CKPT_LAYERS = 2
MOE_DIST_REL = 1e-3
# a 13c Ulysses rank's flash calls: a microbatch's 2 rows x 8 of the 16 heads
ULYSSES_BH = MOE_DIST_BATCH // MOE_DIST_MICRO * 16 // 2
MOE_DEADLINE_S = 600  # 13a-13d in their process
# Phase 14, the parameter-server path (BASELINE config 5, "async PS with
# sparse embedding tables"): phase 12's model with embedding="ps" (the dense
# part on the card, the 1,000,000 x 16 table on PS_SHARDS of the port's PS
# pods), b4096 in one microbatch (PsTrainer refuses more), phase 12's bf16
# compute cast and AdamW; the table the worker's default, Adagrad, at the JAX
# TableSpec's lr.
PS_SHARDS = 2
PS_TABLE = {"name": "emb", "dim": 16, "optimizer": "adagrad", "lr": 0.05}
PS_WARMUP, PS_STEPS, PS_QUEUE = 2, 8, 2
PS_POD_START_S = 120  # the pods, from their start to the registry listing both
# 14b: PS_CHECK_STEPS strict steps at f32 compute from the same weights, the
# card against the CPU, each on a fresh LocalPsClient(2, "native"): the
# dense parameters' and the touched rows' movement from their init, in
# relative L2. SGD over both, whose moves are linear in the gradients:
# Adagrad's first update, lr * g / sqrt(g^2), is the same for g and 2g, so
# its rows would not show the planted fault (the rows' gradient pushed at
# scale 2); AdamW's, lr * g / |g| at the first step, flips where a
# gradient's sum cancels to near 0, and the flips move the next steps'
# gradients (printed beside, not held). What the sound run reads is set by
# ReLU: a row whose tower unit sits at the kink, which the card's and the
# CPU's rounding put on either side, carries the difference
# (``scripts/ps_precision.py`` reads it row by row). On an H100 SXM (700 W)
# 3 steps read 2.94e-4 on the dense movement and 1.94e-4 on the rows' (AdamW
# 7.76e-3 and 6.04e-3), the x2 push 1.0; the bounds sit 7-10x above the
# sound readings and 500x below the fault's.
PS_CHECK_STEPS = 3
PS_CHECK_TABLE = {"name": "emb", "dim": 16, "optimizer": "sgd", "lr": 0.05}
PS_CHECK_REL = {"dense": 2e-3, "rows": 2e-3}
# 14c: the elastic worker in PS mode at 14a's width, two generations, each
# a promoted warm standby: SIGUSR1 once the metrics show PS_QUIESCE_AT
PS_JOB = {"model": "deepfm", "model_kwargs": {"embedding": "ps", "dim": 16},
          "global_batch": DEEPFM_GLOBAL_BATCH, "grad_accum": 1, "lr": 1e-3, "seed": 0,
          "total_steps": 8, "ckpt_interval": -1, "sync_every": 1, "ps_table": "emb"}
PS_QUIESCE_AT = 2
PS_GEN_DEADLINE_S = 240  # each generation of 14c, from its start to its exit
PS_DEADLINE_S = 600  # 14a-14c in their process
# Phase 15, the serving tier with BASELINE config 5's model: DeepFM's dense
# tower at the JAX defaults (26 sparse fields, dim 16, 13 dense features,
# tower (400, 400, 400)) scoring on the card, the rows pulled from PS_TABLE
# on PS_SHARDS of the port's PS pods. 15b's traffic: SERVE_THREADS
# closed-loop clients through the port's ServeRouter in front of two
# in-process ServeFrontends (HotIdCache of SERVE_CACHE_BYTES each, gRPC),
# SERVE_WARMUP then SERVE_REQUESTS requests of SERVE_ROWS rows, ids drawn
# Zipf(SERVE_ZIPF) over SERVE_VOCAB from a seed (``scripts/bench_serve.py``'s
# draw), standard-normal dense features; then SERVE_PROFILED more under the
# profiler for the card's idle share.
SERVE_FIELDS, SERVE_DIM, SERVE_DENSE, SERVE_HIDDEN = 26, 16, 13, (400, 400, 400)
SERVE_VOCAB, SERVE_ZIPF, SERVE_ROWS = 1_000_000, 1.1, 32
SERVE_THREADS, SERVE_WARMUP, SERVE_REQUESTS, SERVE_PROFILED = 4, 120, 1200, 100
SERVE_MAX_BATCH, SERVE_MAX_WAIT_MS, SERVE_CACHE_BYTES = 256, 2.0, 64 << 20
# 15a: the card's forward against the CPU's on the same pulled rows and the
# same params (given in the JAX layout), at each of SERVE_CHECK_ROWS rows, in
# relative L2; beside it the CPU's forward on the rows rounded to TF32 (the
# products' input rounding TF32 would add). The bound sits between the two
# readings; 15d and 15e hold their scores to it too.
# On an H100 SXM (700 W) the card read 8.5e-8 to 2.6e-7 and the TF32-rounded
# rows 1.9e-5 to 4.6e-5; the bound sits 7.6x above the one and 9.6x below
# the other.
SERVE_CHECK_ROWS = (1, 37, 256)
SERVE_CPU_REL = 2e-6
# 15c: SERVE_PUSHES acknowledged pushes to the SERVE_HOT_IDS hottest ids
SERVE_HOT_IDS, SERVE_PUSHES = 256, 4
SERVE_DEADLINE_S = 300  # 15a-15e in their process
# Phase 16, pipeline parallelism: GPT-2 345M at full width on two
# gloo ranks on cuda:0 at pp 2 (dp 1), each rank its stage's 12 layers,
# phase 4's weights, batches and b16/a2, PP_MICROBATCHES pipeline
# microbatches inside each trainer microbatch (the JAX runner's and
# worker's default), no remat, so each stage apply is a checkpoint region
# and its forward runs again in the backward: every rank launches the
# forward kernel 2 x 12 x 2 x 2 = 96 times a step and each backward kernel
# 48. PP_STEPS steps, the first a warm-up; the losses within DIST_LOSS_ABS
# of phase 4's, the parameters within DIST_PARAM_REL of phase 4's after the
# same steps, and the planted fault (the embedding's gradient left unsummed
# over pp) above that bound, in all and in the embedding alone.
PP_MICROBATCHES = 2
PP_STEPS = 3
PP_LAYERS = N_LAYERS // 2
# Phase 17, the online loop of config 5 on phase 15's serving and phase 14's
# PS tier. A step of the worker is LOOP_EVENTS served requests of
# SERVE_ROWS rows (global batch 4096 rows); the job's global_batch counts
# events, as the JAX worker's feedback mode does.
LOOP_EVENTS, LOOP_STEPS, LOOP_CKPT = 128, 16, 3
LOOP_JOB = {"model": "deepfm", "model_kwargs": {"embedding": "ps", "dim": PS_TABLE["dim"]},
            "global_batch": LOOP_EVENTS, "grad_accum": 1, "lr": 1e-3, "seed": 0,
            "total_steps": LOOP_STEPS, "ckpt_interval": LOOP_CKPT, "sync_every": 1,
            "ps_table": PS_TABLE["name"], "ps_lr": PS_TABLE["lr"],
            "feedback_dense_dim": SERVE_DENSE, "feedback_batch_timeout_s": 1.0}
LOOP_SEED, LOOP_THREADS, LOOP_PROBES = 17, 4, 6
LOOP_SENTINEL = 10_000_000  # the probes' ids, disjoint from the draw's
LOOP_PROBE_TIMEOUT_S, LOOP_RESCORE_S = 30.0, 0.05
# A probe's score has moved when a row's moves by more than LOOP_SCORE_MOVE.
# The tower's f32 products round differently in another batch (cuBLAS picks
# its kernel by shape), which moves a row's score with no training: 5.6e-9
# on an H100 SXM (700 W), and an exact comparison "saw" moves in 73-130 ms,
# under one strict step. A trained event moves its rows by about the
# table's lr (Adagrad's first step) and its score by 3.7-11 there.
LOOP_SCORE_MOVE = 1e-3
LOOP_SHM_REPEATS = 5
LOOP_WORKER_S = 180  # each wait on the worker
LOOP_DEADLINE_S = 420  # 17a-17c in their process
# Phase 18, BASELINE config 3 submitted the reference's way: an ElasticJob
# through the port's operator (scripts/operator_lifecycle.py), BERT-base at
# full width on BERT_TOKENS token shards, phase 10's global batch in one
# microbatch (the runner has no flag for grad_accum), OPERATOR_STEPS steps, a
# save every OPERATOR_CKPT. The killed worker pod's steps straggle
# OPERATOR_STRAGGLE_S each (the chaos hook, that pod's agent only) so that its
# kill at step BERT_KILL_AT lands before its save of step 4 commits; the
# replacement's steps do not straggle.
OPERATOR_STEPS, OPERATOR_CKPT = 8, 2
OPERATOR_STRAGGLE_S = 0.5
OPERATOR_STAGE_S = 180  # each wait of the lifecycle
OPERATOR_DEADLINE_S = 300  # phase 18 in its process
RESTART_10D_S = (15.5, 20.4)  # 10d's kill -> first step (PERF.md section 6)
CSRC = "easydl_tpu_torch/ops/csrc/"
SOURCE = {  # by kernel: fa.launches' names
    "flash_fwd": CSRC + "flash_fwd_sm90.cu",
    "flash_bwd_dq": CSRC + "flash_bwd_dq_sm90.cu",
    "flash_bwd_dkv": CSRC + "flash_bwd_dkv_sm90.cu",
    "flash_fwd_f32": CSRC + "flash_fwd_f32_sm90.cu",
    "flash_bwd_dq_f32": CSRC + "flash_bwd_f32_sm90.cu",
    "flash_bwd_dkv_f32": CSRC + "flash_bwd_f32_sm90.cu",
}
# the tensor-core kernels, in the order of easydl_flash_sm90_ctas_per_sm's
# index, with the SASS instructions each must show: wgmma (HGMMA) and TMA
# loads (UTMALDG) in bf16, TF32 mma.sync (HMMA.1688.F32.TF32) in f32; none
# may spill
BF16_SASS, F32_SASS = ("HGMMA", "UTMALDG"), ("HMMA.1688.F32.TF32",)
TC_KERNELS = {"flash_fwd_sm90_kernel": BF16_SASS, "flash_bwd_dkv_sm90_kernel": BF16_SASS,
              "flash_bwd_dq_sm90_kernel": BF16_SASS, "flash_bwd_dkv_f32_sm90_kernel": F32_SASS,
              "flash_bwd_dq_f32_sm90_kernel": F32_SASS, "flash_fwd_f32_sm90_kernel": F32_SASS}
SASS_OPS = BF16_SASS + F32_SASS
REPLACES = {
    "flash_fwd": "easydl_tpu/ops/flash_attention.py:59",
    "flash_bwd_dq": "easydl_tpu/ops/flash_attention.py:157",
    "flash_bwd_dkv": "easydl_tpu/ops/flash_attention.py:200",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, calls: int = 20, windows: int = 7):
    """(device ms, host ms) per call. After 2 warm-up calls, ``windows``
    windows of ``calls`` back-to-back calls, each window between one CUDA
    event pair; the median over the windows of the device time and of the
    host time spent issuing the window, each over ``calls``. A host time
    below the device time says the window was device-bound: the launches
    queued up ahead of the card and their cost is not in the device time."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    events, host = [], []
    for _ in range(windows):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host.append((time.perf_counter() - t0) * 1e3 / calls)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return (statistics.median(s.elapsed_time(e) / calls for s, e in events),
            statistics.median(host))


def queued_ms(fn, calls: int = 10) -> float:
    """Device ms per call of ``fn`` from one CUDA event pair around
    ``calls`` calls that the host queued behind a sleeping kernel: the
    window starts only once every launch is queued, so the host's cost of
    issuing them is outside it. The sleep doubles until the start event is
    still pending when the host has issued the window."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    cycles = 20_000_000  # about 10 ms at the H100's 1.98 GHz boost clock
    for _ in range(8):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        queued = not start.query()
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(end) / calls
        cycles *= 2
    raise AssertionError("the card reached the timed window before the host had issued it")


def device_ms(fn, calls: int = 10):
    """(ms per call, how it was read, the events' reading): the device time
    of every kernel that ``calls`` calls of ``fn`` launched, summed by
    ``torch.profiler``, over ``calls``; and ``queued_ms``'s reading of the
    same calls. For a library call through autograd, whose host cost can
    exceed its device time, so that a window of back-to-back calls would
    time the host. The profiler's sum where it saw device time, else the
    events' (a profiler session on the card has come back empty)."""
    from torch.profiler import ProfilerActivity, profile

    events = queued_ms(fn, calls)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [(e.key, e.self_device_time_total) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0 and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        return events, "CUDA events behind a sleep (the profiler saw no device time)", events
    return (sum(t for _, t in kernels) / 1e3 / calls,
            "torch.profiler in " + "; ".join(sorted(k[:60] for k, _ in kernels)), events)


def ptxas_report(nvcc_log: str):
    """{kernel: (registers, spill store bytes, spill load bytes)} from
    ``-Xptxas -v``, kernels named as ``name<dtype, head_dim>``."""
    out, name = {}, None
    for line in nvcc_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = kernel_name(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name] = [None, int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name in out:
            out[name][0] = int(m.group(1))
            name = None
    return out


def kernel_name(mangled: str) -> str:
    m = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)(_f32)?_sm90_kernel)ILi(\d+)E", mangled)
    if not m:
        return mangled
    return f"{m.group(1)}<{'f32' if m.group(2) else 'bf16'}, {m.group(3)}>"


def sass_counts(lib_path) -> dict:
    """{kernel: {op: count}} of each of ``SASS_OPS`` in the library's SASS,
    or {} where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.isfile(tool):
        return {}
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            name = kernel_name(m.group(1))
            counts[name] = dict.fromkeys(SASS_OPS, 0)
        elif name:
            for op in SASS_OPS:
                counts[name][op] += op in line
    return counts


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 explicit mantissa bits) as ``cvt.rna.tf32.f32``
    does: to nearest, ties away from zero; inf and nan pass through."""
    bits = x.float().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x.float())


def visible_pairs(s_q: int, s_k: int, causal: bool) -> int:
    """(row, col) pairs the bottom-right causal mask leaves visible."""
    if not causal:
        return s_q * s_k
    offset = s_k - s_q
    return sum(min(max(r + offset + 1, 0), s_k) for r in range(s_q))


def bound(name: str, bh: int, s_q: int, s_k: int, d: int, causal: bool, itemsize: int,
          peak_flops: float):
    """(bound_ms, bound_by): the larger of bytes moved (each input read once,
    each output written once) over the memory rate and the visible-pair
    FLOPs over the peak rate."""
    pairs = visible_pairs(s_q, s_k, causal) * bh
    q_bytes, kv_bytes, row_bytes = bh * s_q * d * itemsize, bh * s_k * d * itemsize, bh * s_q * 4
    flops, nbytes = {
        # S = QKᵀ, O = PV; reads q k v, writes O and lse
        "flash_fwd": (4 * d * pairs, 2 * q_bytes + 2 * kv_bytes + row_bytes),
        # Δ = rowsum(dO∘O), S, dP = dO Vᵀ, dq = dS K; reads q k v O dO lse,
        # writes dq Δ
        "flash_bwd_dq": (6 * d * pairs + 2 * d * bh * s_q,
                         4 * q_bytes + 2 * kv_bytes + 2 * row_bytes),
        # S, dP, dv = Pᵀ dO, dk = dSᵀ Q; reads q k v dO lse Δ, writes dk dv
        "flash_bwd_dkv": (8 * d * pairs, 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes),
    }[name]
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def check_kernels(bh, s_q, s_k, d, dtype, causal, seed, timed, peak_flops=None, heads=16,
                  fp32_flops=None):
    """Each kernel against its plain version on the same card inputs and
    against autograd of the reference attention on their f32 upcast; in
    f32 also the kernels' relative L2 (``F32_FWD_REL``, ``F32_GRAD_REL``,
    with the TF32-rounded fault above each) and two calls bit-equal; every
    reading is
    printed before a failure is raised. ``timed``: also times each kernel,
    its plain version and ``F.scaled_dot_product_attention`` over
    ``bh // heads`` sequences of ``heads`` heads, and returns the kernels'
    rows of the ``kernels`` line, named by kernel; with ``fp32_flops`` each
    row also carries its bound at that rate (``bound_ms_fp32``)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(bh, s_q, d, generator=g, device="cuda").to(dtype)
    k = torch.randn(bh, s_k, d, generator=g, device="cuda").to(dtype)
    v = torch.randn(bh, s_k, d, generator=g, device="cuda").to(dtype)
    do = torch.randn(bh, s_q, d, generator=g, device="cuda").to(dtype)
    scale = d ** -0.5
    tol_fwd, tol_grad, tol_lse = TOL[dtype]["fwd"], TOL[dtype]["grad"], TOL[torch.float32]["fwd"]
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal, scale)
    dq_args = (q, k, v, o_ref, do, lse_ref, causal, scale)
    dq_ref, delta_ref = fa.flash_bwd_dq_plain(*dq_args)
    args = (q, k, v, do, lse_ref, delta_ref, causal, scale)
    dk_ref, dv_ref = fa.flash_bwd_dkv_plain(*args)
    o, lse = fa.flash_fwd(q, k, v, causal, scale)
    dq, delta = fa.flash_bwd_dq(*dq_args)
    dk, dv = fa.flash_bwd_dkv(*args)
    torch.cuda.synchronize()
    failures = []

    def err(a, b, tol, what):
        """max |a - b|, and the worst |a - b| / (atol + rtol·|b|): above 1 fails."""
        a, b = a.float(), b.float()
        if not torch.isfinite(a).all():
            failures.append(f"{what}: non-finite kernel output")
            return float("nan"), float("nan")
        atol, rtol = tol
        e = (a - b).abs()
        worst = (e / (atol + rtol * b.abs())).max().item()
        if worst > 1:
            failures.append(f"{what}: max |err| {e.max().item():.3g}, worst err/bound "
                            f"{worst:.3g} over {atol} + {rtol}*|x|")
        return e.max().item(), worst

    live = lse_ref < 1e38  # dead rows: both give +FLT_MAX exactly
    if not torch.equal(lse[~live], lse_ref[~live]):
        failures.append("flash_fwd: dead rows' lse differs")
    if dq[~live].any():
        failures.append("flash_bwd_dq: dead rows' dq is not 0")
    readings = {
        "O": err(o, o_ref, tol_fwd, "flash_fwd O"),
        "lse": err(lse[live], lse_ref[live], tol_lse, "flash_fwd lse"),
        "dq": err(dq, dq_ref, tol_grad, "flash_bwd_dq"),
        "Δ": err(delta, delta_ref, tol_lse, "flash_bwd_dq Δ"),
        "dk": err(dk, dk_ref, tol_grad, "flash_bwd_dkv dk"),
        "dv": err(dv, dv_ref, tol_grad, "flash_bwd_dkv dv"),
    }
    errs = {"flash_fwd": max(readings["O"][0], readings["lse"][0]),
            "flash_bwd_dq": max(readings["dq"][0], readings["Δ"][0]),
            "flash_bwd_dkv": max(readings["dk"][0], readings["dv"][0])}
    log(f"kernels vs plain [{bh},{s_q}/{s_k},{d}] {str(dtype)[6:]} causal={causal}: "
        + ", ".join(f"{n} max|err| {e:.3g} (err/bound {w:.3g})" for n, (e, w) in readings.items()))
    # and against autograd through the einsum reference attention on the f32
    # upcast of the inputs, which shares no code with the kernels or the
    # plain versions
    qkv = [x.float().view(bh, -1, 1, d).detach().requires_grad_() for x in (q, k, v)]
    out = reference_attention(*qkv, causal=causal, scale=scale)
    grads = torch.autograd.grad(out, qkv, do.float().view_as(out))
    vs_ref = {what: err(a, b.view_as(a), REF_TOL[dtype], f"{what} vs autograd of the reference")
              for what, a, b in (("O", o, out), ("dq", dq, grads[0]), ("dk", dk, grads[1]),
                                 ("dv", dv, grads[2]))}
    log(f"  ... vs autograd of the reference attention (f32, within {REF_TOL[dtype]}): "
        + ", ".join(f"{n} max|err| {e:.3g}" for n, (e, _) in vs_ref.items()))
    if dtype == torch.float32:
        failures += f32_forward_check((q, k, v, causal, scale), (o, lse), o_ref)
        failures += f32_backward_checks(dq_args, args, (dq, delta, dk, dv), (dq_ref, dk_ref, dv_ref))
    if failures:
        raise AssertionError("; ".join(failures))
    log("  ... ok")
    if not timed:
        return None
    calls = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, causal, scale),
                      lambda: fa.flash_fwd_plain(q, k, v, causal, scale)),
        "flash_bwd_dq": (lambda: fa.flash_bwd_dq(*dq_args),
                         lambda: fa.flash_bwd_dq_plain(*dq_args)),
        "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(*args), lambda: fa.flash_bwd_dkv_plain(*args)),
    }
    # the yardstick: one PyTorch call for the same attention, [B, H, S, d]
    qs, ks, vs = (x.view(bh // heads, heads, -1, d).detach().requires_grad_() for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
    lib_fwd = device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, is_causal=causal))
    lib_bwd = device_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), do.view_as(out),
                                                    retain_graph=True))
    for what, (ms, how, events) in (("forward", lib_fwd), ("backward", lib_bwd)):
        log(f"sdpa {what}: {ms:.4f} ms of device time a call by {how}; {events:.4f} ms "
            "by CUDA events behind a sleep")
    # the same calls timed as the kernels are: a window whose host time per
    # call exceeds its device time per call timed the host, not the card
    win_fwd = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, is_causal=causal))
    win_bwd = cuda_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), do.view_as(out),
                                                  retain_graph=True))
    log(f"sdpa in windows of back-to-back calls: forward {win_fwd[0]:.4f} ms (host "
        f"{win_fwd[1]:.4f}), backward {win_bwd[0]:.4f} ms (host {win_bwd[1]:.4f})")
    rows, host = [], {}
    for name, (kern, plain) in calls.items():
        b_ms, b_by = bound(name, bh, s_q, s_k, d, causal, q.element_size(), peak_flops)
        ms, host[name] = cuda_ms(kern)
        kernel = fa.KERNELS[dtype][fa.WRAPPERS.index(name)]
        rows.append({
            "name": kernel, "route": "cuda", "source": SOURCE[kernel], "replaces": REPLACES[name],
            "max_abs_err": errs[name], "ms": ms,
            "plain_ms": cuda_ms(plain, calls=2, windows=3)[0],
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": (lib_fwd if name == "flash_fwd" else lib_bwd)[0],
        })
        if fp32_flops:
            rows[-1]["bound_ms_fp32"] = bound(name, bh, s_q, s_k, d, causal, q.element_size(),
                                              fp32_flops)[0]
    log("host ms per call while the windows were issued: "
        + ", ".join(f"{n} {t:.4f}" for n, t in host.items()))
    return rows


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """|a − b| / |b| in L2, in f64."""
    return ((a.double() - b.double()).norm() / b.double().norm()).item()


def f32_forward_check(args, got, want) -> list:
    """The f32 forward kernel's outputs ``got`` (O, lse) from ``args`` (q, k,
    v, causal, scale): O within ``F32_FWD_REL`` of the plain version's
    ``want`` in relative L2, and the same kernel on q, k and v rounded to
    TF32 above it; a second call bit-equal to the first. (``check_kernels``
    holds O and lse to ``TOL``.) Prints the readings; returns the
    failures."""
    q, k, v, causal, scale = args
    fault, _ = fa.flash_fwd(*(tf32_round(x) for x in (q, k, v)), causal, scale)
    again = fa.flash_fwd(*args)
    torch.cuda.synchronize()
    sound, planted = rel_err(got[0], want), rel_err(fault, want)
    equal = [torch.equal(a, b) for a, b in zip(got, again)]
    log(f"  ... f32 forward, O's relative L2 vs plain (bound {F32_FWD_REL}): {sound:.3g}; with "
        f"q, k, v rounded to TF32 (planted fault): {planted:.3g}; a second call bit-equal "
        f"(O, lse): {equal}")
    failures = [] if sound <= F32_FWD_REL else [
        f"f32 forward O: relative L2 {sound:.3g} > {F32_FWD_REL}"]
    if not planted > F32_FWD_REL:
        failures.append(f"f32 forward O: the TF32-rounded fault reads {planted:.3g}, not above "
                        f"{F32_FWD_REL}")
    if not all(equal):
        failures.append(f"f32 forward: a second call differs (O, lse equal: {equal})")
    return failures


def f32_backward_checks(dq_args, dkv_args, got, want) -> list:
    """The f32 backward kernels' outputs ``got`` (dq, Δ, dk, dv) from
    ``dq_args`` and ``dkv_args``: dq, dk and dv within ``F32_GRAD_REL`` of
    the plain versions' ``want`` in relative L2, and the same kernels on q,
    k, v and dO rounded to TF32 above it; a second call bit-equal to the
    first. Prints the readings; returns the failures."""
    q, k, v, o, do, lse, causal, scale = dq_args
    rq, rk, rv, rdo = (tf32_round(x) for x in (q, k, v, do))
    fault_dq, fault_delta = fa.flash_bwd_dq(rq, rk, rv, o, rdo, lse, causal, scale)
    fault = (fault_dq, *fa.flash_bwd_dkv(rq, rk, rv, rdo, lse, fault_delta, causal, scale))
    again = (*fa.flash_bwd_dq(*dq_args), *fa.flash_bwd_dkv(*dkv_args))
    torch.cuda.synchronize()
    names = ("dq", "dk", "dv")
    sound = dict(zip(names, (rel_err(a, b) for a, b in zip(got[:1] + got[2:], want))))
    planted = dict(zip(names, (rel_err(a, b) for a, b in zip(fault, want))))
    equal = [torch.equal(a, b) for a, b in zip(got, again)]
    log(f"  ... f32 backward, relative L2 vs plain (bound {F32_GRAD_REL}): "
        + ", ".join(f"{n} {sound[n]:.3g}" for n in names)
        + "; with q, k, v, dO rounded to TF32 (planted fault): "
        + ", ".join(f"{n} {planted[n]:.3g}" for n in names)
        + f"; a second call bit-equal (dq, Δ, dk, dv): {equal}")
    failures = [f"f32 backward {n}: relative L2 {sound[n]:.3g} > {F32_GRAD_REL}"
                for n in names if not sound[n] <= F32_GRAD_REL]
    failures += [f"f32 backward {n}: the TF32-rounded fault reads {planted[n]:.3g}, not above "
                 f"{F32_GRAD_REL}" for n in names if not planted[n] > F32_GRAD_REL]
    if not all(equal):
        failures.append(f"f32 backward: a second call differs (dq, Δ, dk, dv equal: {equal})")
    return failures


def build_kernels() -> None:
    """Builds the kernels' library; prints each kernel's registers and
    spills (ptxas) and, where cuobjdump exists, its count of each of
    ``SASS_OPS``; fails if a tensor-core kernel spills, if a bf16 one shows
    no wgmma or TMA load, or if an f32 one shows no TF32 mma.sync."""
    t0 = time.perf_counter()
    path, nvcc_log = build.build(fa.KERNEL_SOURCES)
    log(f"build: {path.name} from {', '.join(fa.KERNEL_SOURCES)} in "
        f"{time.perf_counter() - t0:.1f}s")
    ptxas, sass = ptxas_report(nvcc_log), sass_counts(path)
    for name, (regs, st, ld) in sorted(ptxas.items()):
        counts = sass.get(name)
        log(f"  {name}: {regs} registers, spill stores {st} B, loads {ld} B"
            + ("; SASS: " + ", ".join(f"{c} {op}" for op, c in counts.items())
               if counts else ""))
    lib = fa._lib()
    log("  CTAs per SM: " + ", ".join(
        f"{kernel}<{'f32' if ops == F32_SASS else 'bf16'}, {d}> "
        f"{lib.easydl_flash_sm90_ctas_per_sm(i, d)}"
        for i, (kernel, ops) in enumerate(TC_KERNELS.items()) for d in fa.HEAD_DIMS))
    if not nvcc_log:
        log("  (the library was built before: no ptxas report)")
    if not sass:
        log("  (no cuobjdump in this toolkit: SASS not counted)")
    for kernel, ops in TC_KERNELS.items():
        mine = [n for n in ptxas if n.startswith(kernel + "<")]
        if nvcc_log and (not mine or any(ptxas[n][1] or ptxas[n][2] for n in mine)):
            raise AssertionError(f"{kernel}: missing from ptxas's report or spills: "
                                 f"{ {n: ptxas[n] for n in mine} }")
        in_sass = [n for n in sass if n.startswith(kernel + "<")]
        if sass and not (in_sass and all(sass[n][op] for n in in_sass for op in ops)):
            raise AssertionError(f"{kernel}: not every one of {ops} in its SASS")


def grad_check(model, ref, batch) -> None:
    """One backward of the same batch through ``model`` (flash attention),
    through ``model`` with the backward kernels swapped for their plain
    versions, and through ``ref`` (reference attention, same weights); fails
    if a parameter's gradient differs by more than its bound in relative L2:
    GRAD_REL, or QK_REF_REL for the q/k projections against the reference
    (the key biases are left out: see GRAD_REL)."""
    flash = gpt345m.grads(model, batch)
    with mock.patch.multiple(fa, flash_bwd_dq=fa.flash_bwd_dq_plain,
                             flash_bwd_dkv=fa.flash_bwd_dkv_plain):
        plain = gpt345m.grads(model, batch)
    reference = gpt345m.grads(ref, batch)
    k_bias = [n for n in flash if n.endswith(".k.bias")]
    failures = []
    for label, want, qk_bound in (("reference attention", reference, QK_REF_REL),
                                  ("the plain backward", plain, GRAD_REL)):
        rel = {n: ((flash[n] - g).norm() / g.norm()).item() for n, g in want.items()
               if n not in k_bias}
        limit = {n: qk_bound if n.endswith(QK_PROJ) else GRAD_REL for n in rel}
        by_kind = {}
        for n, r in rel.items():
            kind = re.sub(r"^blocks\.\d+\.", "blocks.*.", n)
            by_kind[kind] = max(by_kind.get(kind, 0.0), r)
        bad = [n for n, r in rel.items() if not r <= limit[n]]
        worst = max(rel, key=lambda n: (n in bad, rel[n] / limit[n]))
        log(f"gradient check ({batch['inputs'].shape[0]} sequences), flash kernels vs {label}: "
            f"relative L2 per parameter, largest over the {len(model.blocks)} blocks: "
            + ", ".join(f"{k} {r:.3g}" for k, r in by_kind.items())
            + f"; bounds: q/k projections {qk_bound}, the rest {GRAD_REL}; nearest its bound "
            f"{worst} {rel[worst]:.3g}")
        failures += [f"{n} vs {label}: {rel[n]:.3g} (bound {limit[n]})" for n in bad]
    log("  key-bias gradient norms (0 in exact arithmetic), flash / plain / reference: largest "
        + " / ".join(f"{max(g[n].norm().item() for n in k_bias):.3g}"
                     for g in (flash, plain, reference)))
    if failures:
        raise AssertionError("gradients differ beyond their bounds in relative L2: "
                             + "; ".join(failures))


def profile_step(trainer, state, host_batch, step_time: float, label: str = "profile") -> dict:
    """Device time by kernel over one traced step, grouped into attention
    kernels, matrix products and the rest; busy share = summed kernel time
    over the untraced step time; and the host's operators with the most
    CPU time of their own. Returns the step's annotated ranges: on the
    device (``"device"``: name, ms, count) and the host time of the
    optimizer's, FSDP2's and the collectives' (``"host"``: name -> ms)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, metrics = trainer.train_step(state, host_batch)
        float(metrics["loss"])
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False)]  # annotations span kernels
    spans = [(e.key, max(e.self_device_time_total, e.device_time_total) / 1e3, e.count)
             for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and getattr(e, "is_user_annotation", False)]
    ranges: dict = {}  # host time of annotated ranges, summed over blocks
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CPU and (
                e.key.startswith(("Optimizer.step", "FSDP::", "nccl:"))):
            name = e.key.split(" (")[0]
            ranges[name] = ranges.get(name, 0.0) + e.cpu_time_total / 1e3
    if not kernels:
        log("profile: the profiler saw no device time; breakdown not measured")
        return {"device": spans, "host": ranges, "busy": None}
    groups = {"flash attention kernels": 0.0, "matrix products": 0.0, "other": 0.0}
    for name, ms, _ in kernels:
        low = name.lower()
        if "flash_" in low:
            groups["flash attention kernels"] += ms
        elif any(t in low for t in ("gemm", "xmma", "cutlass", "nvjet")):  # cuBLAS kernels
            groups["matrix products"] += ms
        else:
            groups["other"] += ms
    total = sum(groups.values())
    log(f"{label}: {total:.1f} ms of kernels in one step ({total / 1e3 / step_time:.3f} of the "
        f"untraced step time): " + ", ".join(f"{g} {ms:.1f} ms" for g, ms in groups.items()))
    for name, ms, count in sorted(kernels, key=lambda k: -k[1])[:12]:
        log(f"  {ms:9.3f} ms  x{count:<5d} {name[:110]}")
    host = sorted((e for e in prof.key_averages() if e.self_cpu_time_total > 0),
                  key=lambda e: -e.self_cpu_time_total)[:8]
    log(f"{label}, host: the operators with the most CPU time of their own (traced): "
        + "; ".join(f"{e.key[:40]} {e.self_cpu_time_total / 1e3:.1f} ms x{e.count}"
                    for e in host))
    log(f"{label}, host time of annotated ranges (traced, with what they call): "
        + "; ".join(f"{n} {ms:.1f} ms" for n, ms in sorted(ranges.items(), key=lambda kv: -kv[1])))
    return {"device": spans, "host": ranges, "busy": total / 1e3 / step_time}


class Phase:
    """Prints a phase's seconds when it ends."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        log(f"phase {self.name}: {time.perf_counter() - self.t0:.1f}s")


def rel_l2(got: dict, want: dict, skip=()) -> dict:
    return {n: ((got[n] - g).norm() / g.norm()).item() for n, g in want.items()
            if not n.endswith(skip)}


def train_timed(trainer, state, data, extras=None, after=None):
    """STEPS steps from ``state``; returns (losses, grad norms, seconds of
    each step, launches, peak GiB) with the launch counts and the peak
    memory reset just before; ``extras`` (metric name -> list) gets each
    step's value of those metrics; ``after(step, state)`` runs after each
    step (counted from 1), untimed."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    losses, norms, step_s = [], [], []
    for step in range(1, STEPS + 1):
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, next(data))
        losses.append(float(metrics["loss"]))  # syncs
        norms.append(float(metrics["grad_norm"]))
        for key, values in (extras or {}).items():
            values.append(float(metrics[key]))
        step_s.append(time.perf_counter() - t0)
        if after is not None:
            after(step, state)
    counts = dict(fa.launches)
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"non-finite loss or grad norm: {losses} {norms}")
    return losses, norms, step_s, counts, torch.cuda.max_memory_allocated() / 2**30


def step_report(bundle, step_s, kind, peak_gib):
    """(step time over the timed window, tokens/s, MFU, peak GiB)."""
    step_time = sum(step_s[1:]) / len(step_s[1:])
    tokens_per_s = gpt345m.GLOBAL_BATCH * gpt345m.SEQ / step_time
    util = mfu(bundle.flops_per_sample_hint * gpt345m.GLOBAL_BATCH / step_time, 1, kind)
    return {"step_s": step_time, "tokens_per_s": tokens_per_s, "mfu": util,
            "peak_gib": peak_gib}


def bench_configuration(kind: str, card: str, phase4: dict) -> dict:
    """Phase 6 (see the module docstring). Returns each sub-phase's launches."""
    launches = {}
    micro = gpt345m.GLOBAL_BATCH // MICROBATCHES
    # -- 6a. remat "dots"
    with Phase("6a (remat dots)"):
        bundle = gpt345m.bundle(**gpt345m.BENCH)
        trainer = gpt345m.trainer(bundle)
        state = trainer.init_state()
        data = iter(bundle.make_data(gpt345m.GLOBAL_BATCH, seed=0))
        losses, norms, step_s, counts, peak_gib = train_timed(trainer, state, data)
        launches["6a"] = counts
        per_call = N_LAYERS * MICROBATCHES * STEPS
        want = {**fa.expected_launches(bf16=per_call), "flash_fwd": 2 * per_call}
        report = step_report(bundle, step_s, kind, peak_gib)
        log(f"6a bench configuration (remat dots): losses {losses} (phase 4: "
            f"{phase4['losses']}), grad norms {norms}, launches {counts} (want {want})")
        log("6a step: " + ", ".join(
            f"{k} {report[k]:.4f} (phase 4 {phase4[k]:.4f})" for k in report)
            + f"; timed steps {step_s[1:]}; on {card}")
        if counts != want:
            raise AssertionError(f"remat dots launch counts {counts}, want {want}")
        if losses != phase4["losses"]:
            raise AssertionError(f"remat dots losses {losses} differ from phase 4's "
                                 f"{phase4['losses']} on the same weights and batches")
        profile_step(trainer, state, next(data), report["step_s"], label="6a profile")
        plain = gpt345m.bundle().init_fn(1, trainer.device)  # phase 4's model: no remat
        plain.load_state_dict(state.model.state_dict())
        batch = trainer.to_device(next(data))
        mb = {k: v[:micro] for k, v in batch.items()}
        rel = rel_l2(gpt345m.grads(state.model, mb), gpt345m.grads(plain, mb))
        k_bias = max(r for n, r in rel.items() if n.endswith(".k.bias"))
        rel = {n: r for n, r in rel.items() if not n.endswith(".k.bias")}
        worst = max(rel, key=rel.get)
        log(f"6a gradients, remat dots vs no remat on the same weights ({micro} sequences): "
            f"largest relative L2 {rel[worst]:.3g} ({worst}; bound {DOTS_REL}); key biases "
            f"(rounding noise, see GRAD_REL) {k_bias:.3g}")
        if not rel[worst] <= DOTS_REL:
            raise AssertionError(f"remat dots gradients differ: {worst} {rel[worst]:.3g}")

    # -- 6b. the chunked loss against the f32-head reference, same weights
    with Phase("6b (fused loss)"):
        fa.reset_launches()
        out = {}
        for name, loss_fn in (("logits", gpt345m.logits_loss),
                              ("fused", gpt345m.bundle(fused_loss=True).loss_fn),
                              ("f32 head", gpt345m.f32_head_loss)):
            plain.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            loss, _ = loss_fn(plain, mb)
            loss.backward()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - resident
            grads = {n: p.grad.float() for n, p in plain.named_parameters()}
            times = []
            for _ in range(3):
                plain.zero_grad(set_to_none=True)
                t0 = time.perf_counter()
                loss_fn(plain, mb)[0].backward()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            out[name] = {"loss": loss.item(), "grads": grads, "peak": peak,
                         "ms": statistics.median(times) * 1e3}
        plain.zero_grad(set_to_none=True)
        launches["6b"] = dict(fa.launches)
        ref = out["f32 head"]
        for r in (out["fused"], out["logits"]):
            rel = rel_l2(r["grads"], ref["grads"], skip=(".k.bias",))
            r["worst"] = max(rel, key=rel.get)
            r["grad_rel"] = rel[r["worst"]]
        # the loss function's own gradients (hidden states, head), where a
        # head product rounded to bf16 shows above the model's bf16 noise
        head = {n: gpt345m.head_loss_grads(plain, mb, fn) for n, fn in gpt345m.HEAD_LOSSES.items()}
        for n in ("fused", "logits"):
            out[n]["loss_rel"] = abs(head[n][0] - head["f32 head"][0]) / abs(head["f32 head"][0])
            out[n]["head_rel"] = rel_l2(head[n][1], head["f32 head"][1])
        fused, logits = out["fused"], out["logits"]
        logits_f32 = micro * gpt345m.SEQ * gpt345m.VOCAB * 4
        log(f"6b fused loss vs the f32-head reference ({micro} sequences): loss "
            f"{head['fused'][0]!r} vs {head['f32 head'][0]!r} (relative "
            f"{fused['loss_rel']:.3g}, bound {FUSED_LOSS_REL}); gradients of the hidden "
            f"states and head, relative L2 {fused['head_rel']} (bound {FUSED_HEAD_GRAD_REL}); "
            f"through the model, largest relative L2 {fused['grad_rel']:.3g} "
            f"({fused['worst']}; bound {FUSED_GRAD_REL})")
        log(f"6b the logits path (head product rounded to bf16) vs the same: loss "
            f"{head['logits'][0]!r} (relative {logits['loss_rel']:.3g}); hidden states and "
            f"head {logits['head_rel']}; through the model {logits['grad_rel']:.3g} "
            f"({logits['worst']})")
        log("6b peak above resident GiB / loss+backward ms (median of 3): " + ", ".join(
            f"{n} {r['peak'] / 2**30:.3f} / {r['ms']:.1f}" for n, r in out.items())
            + f" (f32 logits {logits_f32 / 2**30:.3f} GiB); on {card}")
        if not (fused["loss_rel"] <= FUSED_LOSS_REL
                and all(r <= FUSED_HEAD_GRAD_REL[k] for k, r in fused["head_rel"].items())
                and fused["grad_rel"] <= FUSED_GRAD_REL):
            raise AssertionError("the chunked loss lost the f32 sums of its head product")
        if not fused["peak"] <= logits["peak"] - logits_f32:
            raise AssertionError("the chunked loss saves less than the f32 logits")
        del plain, out, fused, logits, ref, grads, head

    # -- 6c. checkpoint round trip, 6d. the evaluator on it
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        with Phase("6c (checkpoint)"):
            shapes = trainer.leaf_shapes(state)
            nbytes = sum(int(np.prod(s)) * d.itemsize for s, d in shapes.values())
            free = shutil.disk_usage(tmp).free
            if free < 2 * nbytes:
                raise AssertionError(f"{tmp}: {free} bytes free, under twice the state's "
                                     f"{nbytes} bytes")
            mgr = CheckpointManager(tmp)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mgr.save(state.step, trainer.state_leaves(state))
            t_snap = time.perf_counter() - t0
            mgr.wait()
            t_io = time.perf_counter() - t0 - t_snap
            on_disk = sum(os.path.getsize(os.path.join(d, f))
                          for d, _, files in os.walk(tmp) for f in files)
            restorer = gpt345m.trainer(bundle)
            t0 = time.perf_counter()
            restored = restorer.restore_from(mgr)
            torch.cuda.synchronize()
            t_restore = time.perf_counter() - t0
            log(f"6c checkpoint of step {state.step}: {nbytes} bytes of leaves, {on_disk} on "
                f"disk; save {t_snap:.2f}s snapshot + {t_io:.2f}s background write; restore "
                f"{t_restore:.2f}s; {free / 2**30:.0f} GiB were free in the temp dir")
            differ = [n for n, p in state.model.named_parameters()
                      if not torch.equal(p, restored.model.get_parameter(n))]
            opt_a, opt_b = state.optimizer.state, restored.optimizer.state
            for p, q in zip(state.model.parameters(), restored.model.parameters()):
                differ += [f"{k} of a parameter" for k in ("step", "exp_avg", "exp_avg_sq")
                           if not torch.equal(opt_a[p][k], opt_b[q][k])]
            if restored.step != state.step or differ:
                raise AssertionError(f"restored step {restored.step} vs {state.step}; "
                                     f"tensors that differ: {differ[:8]}")

            def with_loss(module, batch, rng):
                loss, _ = bundle.eval_fn(module, batch, rng)
                return loss, {"loss": loss}

            eval_step = trainer.build_eval_step(with_loss)
            held_out = iter(bundle.make_data(micro, seed=1))
            live = 0.0
            for _ in range(2):
                live += float(eval_step(state, next(held_out))["loss"])
            live /= 2
            fa.reset_launches()
            host_batch = next(data)
            _, m_live = trainer.train_step(state, host_batch)
            _, m_restored = restorer.train_step(restored, host_batch)
            launches["6c"] = dict(fa.launches)
            after = max((p - restored.model.get_parameter(n)).abs().max().item()
                        for n, p in state.model.named_parameters())
            log(f"6c one more step: loss {float(m_live['loss']):.6f} live vs "
                f"{float(m_restored['loss']):.6f} restored; parameters after it differ by "
                f"{after:.3g} at most")
            if float(m_live["loss"]) != float(m_restored["loss"]) or after != 0:
                raise AssertionError("the restored state trains on differently")
            del restored, restorer

        with Phase("6d (evaluator)"):
            fa.reset_launches()
            ev = Evaluator(gpt345m.trainer(bundle), mgr,
                           iter(bundle.make_data(micro, seed=1)), eval_fn=bundle.eval_fn,
                           batches_per_eval=2)
            result = ev.poll_once()
            launches["6d"] = dict(fa.launches)
            log(f"6d evaluator on step {state.step - 1}: {result}; eval step on the live "
                f"state {live!r}")
            if result is None or result["loss"] != live or result["step"] != state.step - 1:
                raise AssertionError(f"evaluator {result} vs the live eval step {live!r}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def uneven(batch: dict) -> dict:
    """Phase 7b's uneven mask: in each microbatch the first rank's rows keep
    DIST_MASK_KEEP targets, the second rank's all of them."""
    targets = batch["targets"].copy()
    micro = gpt345m.GLOBAL_BATCH // MICROBATCHES
    for i in range(MICROBATCHES):
        targets[i * micro:i * micro + micro // 2, DIST_MASK_KEEP:] = -1
    return {"inputs": batch["inputs"], "targets": targets}


def mean_of_local_means(total, count):
    """7b's planted fault, in ``models.gpt.lm_loss``'s place of ``batch_sum``:
    each rank's own masked mean, averaged over the two ranks."""
    from easydl_tpu_torch.core.mesh import batch_sum

    (mean,) = batch_sum(total / count.clamp_min(1.0))
    return mean / 2, torch.ones_like(count)


def rank_main(rank: int, work: str) -> int:
    """One of 7b's two ranks (``chip_smoke.py --rank R WORKDIR``): joins a
    gloo group of two on cuda:0, runs the runs of ``WORKDIR/spec.json`` and
    rank 0 writes their readings to ``WORKDIR/result.json``. The kernels'
    library was built by the parent: this process only loads it."""
    import faulthandler
    from datetime import timedelta

    import torch.distributed as dist

    from easydl_tpu_torch.core.mesh import MeshSpec, init_distributed
    from easydl_tpu_torch.models import gpt

    faulthandler.enable()  # a crash in a collective leaves its stack in the rank's log

    with open(os.path.join(work, "spec.json")) as f:
        runs = json.load(f)["runs"]
    init_distributed("cuda:0", backend="gloo", rank=rank, world_size=2,
                     store=dist.FileStore(os.path.join(work, "store"), 2),
                     timeout=timedelta(seconds=DIST_DEADLINE_S))
    fa._lib()
    rows = slice(rank * gpt345m.GLOBAL_BATCH // 2, (rank + 1) * gpt345m.GLOBAL_BATCH // 2)
    refs, one_losses = {}, {}
    if rank == 0:  # one process's losses and parameters after the same steps and batches
        for masked in sorted({run["uneven"] for run in runs}):
            bundle = shallow_gpt(DIST_LAYERS)
            trainer = gpt345m.trainer(bundle, device="cuda:0")
            state = trainer.init_state()
            data = iter(bundle.make_data(gpt345m.GLOBAL_BATCH, seed=0))
            one_losses[masked] = []
            for _ in range(DIST_STEPS):
                batch = next(data)
                state, metrics = trainer.train_step(state, uneven(batch) if masked else batch)
                one_losses[masked].append(float(metrics["loss"]))
            refs[masked] = {n: p.detach() for n, p in state.model.named_parameters()}
            del state, trainer
    dist.barrier()
    out = {}
    real_batch_sum = gpt.batch_sum
    for run in runs:
        bundle = shallow_gpt(DIST_LAYERS)
        if run["fault"]:
            gpt.batch_sum = mean_of_local_means
        trainer = gpt345m.trainer(bundle, device="cuda:0", mesh_spec=MeshSpec(**run["mesh"]))
        state = trainer.init_state()
        data = iter(bundle.make_data(gpt345m.GLOBAL_BATCH, seed=0))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        losses, t0 = [], time.perf_counter()
        for _ in range(DIST_STEPS):
            batch = next(data)
            batch = uneven(batch) if run["uneven"] else batch
            state, metrics = trainer.train_step(state, {k: v[rows] for k, v in batch.items()})
            losses.append(float(metrics["loss"]))
        seconds = time.perf_counter() - t0
        launches = [None, None]
        dist.all_gather_object(launches, dict(fa.launches))
        gpt.batch_sum = real_batch_sum
        diff = norm = 0.0
        for name, p in state.model.named_parameters():
            full = whole(p)
            if rank == 0:
                diff += (full - refs[run["uneven"]][name]).square().sum().item()
                norm += refs[run["uneven"]][name].square().sum().item()
        res = {"losses": losses, "seconds": seconds, "launches": launches,
               "one_losses": one_losses.get(run["uneven"]),
               "rel": math.sqrt(diff / norm) if norm else None,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        if run["save"]:
            mgr = CheckpointManager(run["save"])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mgr.save(state.step, trainer.state_leaves(state))
            t_snap = time.perf_counter() - t0
            mgr.wait()
            res["save_s"] = [t_snap, time.perf_counter() - t0 - t_snap]
            res["hashes"] = state_hashes(state)
        out[run["name"]] = res
        del state, trainer
        gc.collect()
        torch.cuda.empty_cache()
    if rank == 0:
        with open(os.path.join(work, "result.json"), "w") as f:
            json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def nccl_world1(kind: str, card: str, phase4: dict) -> dict:
    """7a (see the module docstring). Returns its launches."""
    import torch.distributed as dist

    from easydl_tpu_torch.core.mesh import MeshSpec, init_distributed

    store = tempfile.mkdtemp(prefix="chip_smoke_store_")
    init_distributed("cuda:0", rank=0, world_size=1, local_rank=0,
                     store=dist.FileStore(os.path.join(store, "store"), 1))
    try:
        bundle = gpt345m.bundle()
        trainer = gpt345m.trainer(bundle, mesh_spec=MeshSpec(dp=1))
        state = trainer.init_state()
        data = iter(bundle.make_data(gpt345m.GLOBAL_BATCH, seed=0))
        losses, norms, step_s, counts, peak_gib = train_timed(trainer, state, data)
        report = step_report(bundle, step_s, kind, peak_gib)
        log(f"7a NCCL world 1, dp 1 x fsdp 1 (backend {dist.get_backend()}): losses {losses} "
            f"(phase 4: {phase4['losses']}), grad norms {norms}, launches {counts}")
        log("7a vs phase 4, " + ", ".join(
            f"{k} {report[k]:.4f} (phase 4 {phase4[k]:.4f})" for k in report) + f", on {card}")
        worst = max(abs(a - b) for a, b in zip(losses, phase4["losses"]))
        if worst > DIST_LOSS_ABS:
            raise AssertionError(f"7a losses {losses} differ from phase 4's {phase4['losses']} "
                                 f"by {worst:.3g} > {DIST_LOSS_ABS}")
        if counts != phase4["counts"]:
            raise AssertionError(f"7a launches {counts} != phase 4's {phase4['counts']}")
        ranges = profile_step(trainer, state, next(data), report["step_s"], label="7a profile")
        nccl, fsdp = {}, {}  # name -> [device ms, count], FSDP2's summed over blocks
        for n, ms, c in ranges["device"]:
            group = nccl if n.startswith("nccl:") else fsdp if n.startswith("FSDP::") else None
            if group is not None:
                acc = group.setdefault(n.split(" (")[0], [0.0, 0])
                acc[0] += ms
                acc[1] += c
        issued = sorted(n for n in ranges["host"] if n.startswith("nccl:"))
        log(f"7a profile: NCCL collectives issued {issued}; device time of the annotated "
            "ranges: NCCL " + (", ".join(f"{n} {ms:.3f} ms x{c}" for n, (ms, c) in nccl.items())
                               or "none caught (at one rank NCCL copies or does nothing)")
            + "; FSDP2 " + ", ".join(f"{n} {ms:.3f} ms x{c}" for n, (ms, c) in fsdp.items()))
        # at one rank NCCL launches no kernel of its own: the check is that
        # the step's collectives went through the NCCL process group
        if dist.get_backend() != "nccl" or not issued:
            raise AssertionError(f"no NCCL collective in the profiled step (backend "
                                 f"{dist.get_backend()}): {sorted(ranges['host'])}")
        # FSDP2 keeps the gradients it does not reduce yet in its reduce dtype
        batch = trainer.to_device(next(data))
        state.model.set_requires_gradient_sync(False)
        loss, _ = bundle.loss_fn(state.model, {k: v[:2] for k, v in batch.items()})
        loss.backward()
        dtypes = sorted({str(fp.unsharded_accumulated_grad.dtype)
                         for fp in fsdp_params(state.model)})
        log(f"7a gradients of a skipped reduction accumulate in {dtypes} "
            f"(torch {torch.__version__})")
        if dtypes != ["torch.float32"]:
            raise AssertionError(f"FSDP2 accumulates skipped reductions in {dtypes}, not f32")
        del state, trainer
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    return counts


def two_ranks() -> dict:
    """7b and 7c (see the module docstring). Returns 7b's launches."""
    work = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    ckpt = os.path.join(work, "ckpt")
    runs = [{"name": "dp 2", "mesh": {"dp": 2}, "uneven": False, "fault": False, "save": ""},
            {"name": "fsdp 2", "mesh": {"fsdp": 2}, "uneven": False, "fault": False,
             "save": ckpt},
            {"name": "fsdp 2 uneven", "mesh": {"fsdp": 2}, "uneven": True, "fault": False,
             "save": ""},
            {"name": "fsdp 2 uneven, planted fault", "mesh": {"fsdp": 2}, "uneven": True,
             "fault": True, "save": ""}]
    try:
        with Phase("7b (two ranks over gloo)"):
            with open(os.path.join(work, "spec.json"), "w") as f:
                json.dump({"runs": runs}, f)
            start_ranks("--rank", 2, work, "7b")
            with open(os.path.join(work, "result.json")) as f:
                res = json.load(f)
            per_rank = DIST_LAYERS * MICROBATCHES * DIST_STEPS
            total = {k: 0 for k in fa.launches}
            failures = []
            for run in runs:
                r = res[run["name"]]
                log(f"7b {run['name']} ({DIST_LAYERS} layers): losses {r['losses']} (one "
                    f"process: {r['one_losses']}), {r['seconds']:.2f}s for "
                    f"{DIST_STEPS} steps, peak mem {r['peak_gib']:.2f} GiB (rank 0), parameters "
                    f"vs one process relative L2 {r['rel']:.4g} (bound {DIST_PARAM_REL}), "
                    f"launches by rank {r['launches']}")
                for counts in r["launches"]:
                    for k, v in counts.items():
                        total[k] += v
                    if counts != fa.expected_launches(bf16=per_rank):
                        failures.append(f"{run['name']}: launches {counts}, want {per_rank}")
                if run["fault"]:
                    if r["rel"] <= DIST_PARAM_REL:
                        failures.append(f"the planted fault passes: {r['rel']:.4g}")
                    continue
                if not r["rel"] <= DIST_PARAM_REL:
                    failures.append(f"{run['name']}: parameters {r['rel']:.4g} from one process's")
                worst = max(abs(a - b) for a, b in zip(r["losses"], r["one_losses"]))
                if worst > DIST_LOSS_ABS:
                    failures.append(f"{run['name']}: losses {r['losses']} vs one process's "
                                    f"{r['one_losses']}")
            if failures:
                raise AssertionError("7b: " + "; ".join(failures))

        with Phase("7c (the two-rank save restored in one process)"):
            saved = res["fsdp 2"]
            restorer = gpt345m.trainer(shallow_gpt(DIST_LAYERS))
            t0 = time.perf_counter()
            restored = restorer.restore_from(CheckpointManager(ckpt))
            torch.cuda.synchronize()
            t_restore = time.perf_counter() - t0
            got = state_hashes(restored)
            differ = [k for k in saved["hashes"] if got.get(k) != saved["hashes"][k]]
            log(f"7c checkpoint of the fsdp 2 ranks at step {saved['hashes']['step']}: save "
                f"{saved['save_s'][0]:.2f}s snapshot + {saved['save_s'][1]:.2f}s write and "
                f"commit; restore in one process {t_restore:.2f}s; {len(got) - 1} tensors and "
                f"counts compared, {len(differ)} differ {differ[:6]}")
            if differ or set(got) != set(saved["hashes"]):
                raise AssertionError("7c: the restored state is not the saved one")
            del restored, restorer
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return total


def column_input_unreduced(x, group):
    """7d's planted fault, in ``models.transformer``'s place of
    ``copy_to_tp``: the input of every column-parallel product passed on
    without the all-reduce of its gradient over tp."""
    return x


def tp_rank_main(rank: int, work: str) -> int:
    """One of 7d's four ranks (``chip_smoke.py --tp-rank R WORKDIR``): joins
    a gloo group of four on cuda:0, runs the runs of ``WORKDIR/spec.json``
    and rank 0 writes their readings to ``WORKDIR/result.json``; after the
    saving run's checkpoint it takes one more step and rank 0 writes the
    parameters to ``WORKDIR/next.pt``. The kernels' library was built by
    the parent: this process only loads it."""
    import faulthandler
    from datetime import timedelta

    import torch.distributed as dist

    from easydl_tpu_torch.core.mesh import MeshSpec, init_distributed
    from easydl_tpu_torch.models import transformer

    faulthandler.enable()
    with open(os.path.join(work, "spec.json")) as f:
        runs = json.load(f)["runs"]
    world = TP_WORLD
    init_distributed("cuda:0", backend="gloo", rank=rank, world_size=world,
                     store=dist.FileStore(os.path.join(work, "store"), world),
                     timeout=timedelta(seconds=DIST_DEADLINE_S))
    fa._lib()
    shapes = set()  # (kernel wrapper, q's shape, dtype) of every launch
    real_launch = fa._launch

    def launch(name, fn, q, *args):
        shapes.add((name, tuple(q.shape), str(q.dtype)))
        return real_launch(name, fn, q, *args)

    fa._launch = launch
    batches = list(itertools.islice(gpt345m.bundle().make_data(gpt345m.GLOBAL_BATCH, seed=0),
                                    DIST_STEPS + 1))
    ref, one_losses = None, []
    if rank == 0:  # one process's losses and parameters after the same steps and batches
        trainer = gpt345m.trainer(shallow_gpt(DIST_LAYERS), device="cuda:0")
        state = trainer.init_state()
        for batch in batches[:DIST_STEPS]:
            state, metrics = trainer.train_step(state, batch)
            one_losses.append(float(metrics["loss"]))
        ref = {n: p.detach() for n, p in state.model.named_parameters()}
        del state, trainer
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    out = {}
    real_copy = transformer.copy_to_tp
    for run in runs:
        if run["fault"]:
            transformer.copy_to_tp = column_input_unreduced
        trainer = gpt345m.trainer(shallow_gpt(DIST_LAYERS), device="cuda:0",
                                  mesh_spec=MeshSpec(**run["mesh"]))
        state = trainer.init_state()
        share = gpt345m.GLOBAL_BATCH // trainer.ranks
        rows = slice(trainer.rank * share, (trainer.rank + 1) * share)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        shapes.clear()
        losses, step_s = [], []
        for batch in batches[:DIST_STEPS]:
            t0 = time.perf_counter()
            state, metrics = trainer.train_step(state, {k: v[rows] for k, v in batch.items()})
            losses.append(float(metrics["loss"]))
            step_s.append(time.perf_counter() - t0)
        transformer.copy_to_tp = real_copy
        res = {"losses": losses, "step_s": step_s, "rank": trainer.rank}
        for key, mine in (("launches", dict(fa.launches)), ("shapes", sorted(shapes)),
                          ("peak_gib", torch.cuda.max_memory_allocated() / 2**30)):
            res[key] = [None] * world
            dist.all_gather_object(res[key], mine)
        diff = norm = 0.0
        for name, p in state.model.named_parameters():
            full = whole(p)
            if rank == 0:
                diff += (full - ref[name]).square().sum().item()
                norm += ref[name].square().sum().item()
        res["rel"] = math.sqrt(diff / norm) if rank == 0 else None
        if run["save"]:
            mgr = CheckpointManager(run["save"])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mgr.save(state.step, trainer.state_leaves(state))
            mgr.wait()
            res["save_s"] = time.perf_counter() - t0
            res["hashes"] = state_hashes(state)
            state, metrics = trainer.train_step(
                state, {k: v[rows] for k, v in batches[DIST_STEPS].items()})
            res["next_loss"] = float(metrics["loss"])
            params = {n: whole(p).cpu() for n, p in state.model.named_parameters()}
            if rank == 0:
                torch.save(params, os.path.join(work, "next.pt"))
            res["next_launches"] = [None] * world
            dist.all_gather_object(res["next_launches"], dict(fa.launches))
        out[run["name"]] = res
        del state, trainer
        gc.collect()
        torch.cuda.empty_cache()
    if rank == 0:
        with open(os.path.join(work, "result.json"), "w") as f:
            json.dump({**out, "one_losses": one_losses}, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


class Spares:
    """Interpreters that have imported this script (torch and the port:
    most of a child's start) and wait, idle and off the card, for a child's
    command line (``chip_smoke.py --spare GATE PID``, :func:`take_command`). A
    child placed in one starts at once; :meth:`popen` starts a fresh
    process where none is idle or the child's output goes to a pipe."""

    def __init__(self):
        self.idle: list = []
        self.dir, self.started = None, 0

    def fill(self, n: int) -> None:
        """Starts spares until ``n`` are idle."""
        self.idle = [(p, gate) for p, gate in self.idle if p.poll() is None]
        if self.dir is None:
            self.dir = tempfile.mkdtemp(prefix="chip_smoke_spares_")
        while len(self.idle) < n:
            self.started += 1
            gate = os.path.join(self.dir, f"{self.started}.json")
            proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--spare", gate,
                                     str(os.getpid())])
            self.idle.append((proc, gate))

    def popen(self, cmd: list, stdout=None, stderr=None):
        """``subprocess.Popen(cmd, stdout=stdout, stderr=stderr)`` for
        ``[sys.executable, this script or "-m", ...]`` with the output
        inherited or to a file, in a spare when one is idle (with this
        process's environment and directory)."""
        out = getattr(stdout, "name", None)
        placeable = (cmd[0] == sys.executable and stderr in (None, subprocess.STDOUT)
                     and (stdout is None or isinstance(out, str)))
        while placeable and self.idle:
            proc, gate = self.idle.pop(0)
            if proc.poll() is not None:
                continue
            with open(gate + ".tmp", "w") as f:
                json.dump({"argv": cmd[1:], "env": dict(os.environ), "cwd": os.getcwd(),
                           "out": out, "err_to_out": stderr == subprocess.STDOUT}, f)
            os.replace(gate + ".tmp", gate)
            return proc
        return subprocess.Popen(cmd, stdout=stdout, stderr=stderr)

    def stop(self) -> None:
        """Ends the idle spares."""
        for proc, _ in self.idle:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
        self.idle = []
        if self.dir is not None:
            shutil.rmtree(self.dir, ignore_errors=True)
            self.dir = None


SPARES = Spares()


def take_command(gate: str, parent: int) -> None:
    """A spare's wait (:class:`Spares`): until ``gate`` holds a child's
    command line, then takes its environment, directory, output and
    arguments (``sys.argv``). Exits if its parent (pid ``parent``) goes
    first."""
    while not os.path.exists(gate):
        if os.getppid() != parent:
            sys.exit(1)
        time.sleep(0.02)
    with open(gate) as f:
        cmd = json.load(f)
    os.environ.clear()
    os.environ.update(cmd["env"])
    os.chdir(cmd["cwd"])
    if cmd["out"] is not None:
        fd = os.open(cmd["out"], os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
        os.dup2(fd, 1)
        os.close(fd)
    if cmd["err_to_out"]:
        os.dup2(1, 2)
    sys.argv = cmd["argv"]


def run_child(args: list, timeout: float, stdout=None, stderr=None) -> int:
    """``chip_smoke.py ARGS`` (``python ARGS`` when ARGS start with
    ``-m``) to its end, in a spare when one is idle; returns its exit code,
    or kills it and raises ``subprocess.TimeoutExpired`` at ``timeout``."""
    script = [] if args[0] == "-m" else [os.path.abspath(__file__)]
    proc = SPARES.popen([sys.executable, *script, *args], stdout=stdout, stderr=stderr)
    try:
        return proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise


def start_ranks(flag: str, world: int, work: str, label: str, beside=None) -> None:
    """Runs ``chip_smoke.py FLAG R WORK`` for R < ``world`` to their end (at
    most ``DIST_DEADLINE_S``), in spares where they are idle; on a failure
    prints each rank's log and raises. ``beside(failed)``, when given, runs
    in this process while the ranks run; ``failed()`` says whether a rank
    failed or the deadline passed."""
    logs = [open(os.path.join(work, f"rank{r}.log"), "w") for r in range(world)]
    procs = [SPARES.popen([sys.executable, os.path.abspath(__file__), flag, str(r), work],
                          stdout=logs[r], stderr=subprocess.STDOUT) for r in range(world)]
    deadline = time.monotonic() + DIST_DEADLINE_S
    try:
        if beside is not None:
            beside(lambda: (any(p.poll() not in (None, 0) for p in procs)
                            or time.monotonic() > deadline))
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    rcs = [p.returncode for p in procs]
    if rcs != [0] * world:
        for r in range(world):
            with open(os.path.join(work, f"rank{r}.log")) as f:
                print(f"--- {label} rank {r} (rc {rcs[r]}):\n{f.read()[-4000:]}", file=sys.stderr)
        raise AssertionError(f"{label} ranks exited {rcs} (killed at the {DIST_DEADLINE_S}s "
                             "deadline if negative)")


def tp_ranks(card: str) -> dict:
    """7d (see the module docstring). Returns its launches."""
    work = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    ckpt = os.path.join(work, "ckpt")
    runs = [{"name": "fsdp 2 x tp 2", "mesh": {"fsdp": 2, "tp": 2}, "fault": False,
             "save": ckpt},
            {"name": "dp 2 x tp 2", "mesh": {"dp": 2, "tp": 2}, "fault": False, "save": ""},
            {"name": "fsdp 2 x tp 2, planted fault", "mesh": {"fsdp": 2, "tp": 2},
             "fault": True, "save": ""}]
    micro_rows = gpt345m.GLOBAL_BATCH // MICROBATCHES // 2  # two batch ranks in each mesh
    local_heads = [micro_rows * 16 // 2, gpt345m.SEQ, 64]  # [B·H/tp, S, d]
    try:
        with Phase("7d (tp: four ranks over gloo)"):
            with open(os.path.join(work, "spec.json"), "w") as f:
                json.dump({"runs": runs}, f)
            start_ranks("--tp-rank", TP_WORLD, work, "7d")
            with open(os.path.join(work, "result.json")) as f:
                res = json.load(f)
            total = {k: 0 for k in fa.launches}
            failures = []
            one_losses = res["one_losses"]
            for run in runs:
                r = res[run["name"]]
                steps = DIST_STEPS + (1 if run["save"] else 0)
                log(f"7d {run['name']} ({DIST_LAYERS} layers): losses {r['losses']} (one process: "
                    f"{one_losses}), step seconds {r['step_s']}, peak mem "
                    f"by rank {[round(g, 2) for g in r['peak_gib']]} GiB, parameters vs one "
                    f"process relative L2 {r['rel']:.4g} (bound {DIST_PARAM_REL}), launches by "
                    f"rank {r.get('next_launches', r['launches'])}, flash shapes "
                    f"{r['shapes'][0]}, on {card}")
                for counts in r.get("next_launches", r["launches"]):
                    for k, v in counts.items():
                        total[k] += v
                    if counts != fa.expected_launches(bf16=DIST_LAYERS * MICROBATCHES * steps):
                        failures.append(f"{run['name']}: launches {counts}")
                want_shapes = [[name, local_heads, "torch.bfloat16"]
                               for name in ("flash_bwd_dkv", "flash_bwd_dq", "flash_fwd")]
                if any(sh != want_shapes for sh in r["shapes"]):
                    failures.append(f"{run['name']}: flash shapes {r['shapes']}, want "
                                    f"{want_shapes} on every rank")
                if run["fault"]:
                    if r["rel"] <= DIST_PARAM_REL:
                        failures.append(f"the planted fault passes: {r['rel']:.4g}")
                    continue
                if not r["rel"] <= DIST_PARAM_REL:
                    failures.append(f"{run['name']}: parameters {r['rel']:.4g} from one process's")
                worst = max(abs(a - b) for a, b in zip(r["losses"], one_losses))
                if worst > DIST_LOSS_ABS:
                    failures.append(f"{run['name']}: losses {r['losses']} vs one process's "
                                    f"{one_losses}")
            if failures:
                raise AssertionError("7d: " + "; ".join(failures))

            saved = res["fsdp 2 x tp 2"]
            restorer = gpt345m.trainer(shallow_gpt(DIST_LAYERS))
            t0 = time.perf_counter()
            restored = restorer.restore_from(CheckpointManager(ckpt))
            torch.cuda.synchronize()
            t_restore = time.perf_counter() - t0
            got = state_hashes(restored)
            differ = [k for k in saved["hashes"] if got.get(k) != saved["hashes"][k]]
            batch = list(itertools.islice(gpt345m.bundle().make_data(
                gpt345m.GLOBAL_BATCH, seed=0), DIST_STEPS + 1))[-1]
            restored, metrics = restorer.train_step(restored, batch)
            ranks_next = torch.load(os.path.join(work, "next.pt"))
            diff = norm = 0.0
            for name, p in restored.model.named_parameters():
                theirs = ranks_next[name].to(p.device)
                diff += (p.detach() - theirs).square().sum().item()
                norm += theirs.square().sum().item()
            rel_next = math.sqrt(diff / norm)
            log(f"7d the fsdp 2 x tp 2 checkpoint at step {saved['hashes']['step']}: save "
                f"{saved['save_s']:.2f}s, restore in one process {t_restore:.2f}s; "
                f"{len(got) - 1} tensors and counts compared, {len(differ)} differ "
                f"{differ[:6]}; the next step: loss {float(metrics['loss']):.6f} in one "
                f"process, {saved['next_loss']:.6f} on the ranks, parameters relative L2 "
                f"{rel_next:.4g} (bound {DIST_PARAM_REL})")
            if differ or set(got) != set(saved["hashes"]):
                raise AssertionError("7d: the restored state is not the saved one")
            if not (abs(float(metrics["loss"]) - saved["next_loss"]) <= DIST_LOSS_ABS
                    and rel_next <= DIST_PARAM_REL):
                raise AssertionError("7d: one process's next step is not the ranks'")
            del restored, restorer, ranks_next
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return total


def port_bench(card: str) -> None:
    """6e: the port's bench (``scripts/bench.py``) in a subprocess; prints its
    line and fails unless it ran on this card with a finite loss."""
    with tempfile.NamedTemporaryFile("w+", prefix="chip_smoke_bench_") as f:
        rc = run_child(["-m", "easydl_tpu_torch.scripts.bench", *BENCH_STEPS],
                       BENCH_DEADLINE_S, stdout=f)
        f.seek(0)
        lines = f.read().strip().splitlines()
    if rc:
        raise AssertionError(f"scripts/bench.py exited {rc}")
    line = lines[-1]
    rec = json.loads(line)
    log(f"6e the port's bench (scripts/bench.py {' '.join(BENCH_STEPS)}, b256/a32, remat "
        f"dots): {line}; on {card}")
    if not (math.isfinite(rec["loss"]) and rec["value"] > 0
            and rec["device_kind"] == torch.cuda.get_device_name(0)):
        raise AssertionError(f"the bench's record is not a reading of this card: {rec}")


@contextlib.contextmanager
def control_plane(work: str, job: dict, device: str = "cuda"):
    """The port's master (``elastic/master.py``) for ``job`` over ``work``,
    one worker wanted, preflight off (the card holds one generation at a
    time), and a starter of the port's agents (``elastic/agent.py``) on
    ``device``'s platform: ``start(agent_id, worker_argv, **agent_options)``.
    Stops every agent (and so its worker) and the master at the end."""
    from easydl_tpu_torch.elastic.agent import Agent
    from easydl_tpu_torch.elastic.master import Master

    master = Master(job_name=os.path.basename(work), workdir=work, desired_workers=1,
                    min_workers=1, worker_config=job, prepare_timeout_s=0.0).start()
    agents = []

    def start(agent_id: str, worker_argv: list, **options):
        agents.append(Agent(agent_id, master.address, work, slots=1, worker_argv=worker_argv,
                            platform="cpu" if device == "cpu" else "cuda", **options).start())
        return agents[-1]

    try:
        yield master, start
    finally:
        for a in agents:
            a.stop()
        master.stop()


def print_worker_logs(work: str, agents=("a0",)) -> None:
    """The tail of each agent's workers' log in ``work``, to stderr."""
    for a in agents:
        path = os.path.join(work, f"worker-{a}.log")
        if os.path.exists(path):
            with open(path, errors="replace") as f:
                print(f"--- agent {a}'s workers:\n{f.read()[-6000:]}", file=sys.stderr)


def await_state(cond, what: str, deadline_s: float, work: str, agents=("a0",)) -> None:
    """Waits for ``cond()``; past ``deadline_s`` prints the agents' worker
    logs and raises."""
    end = time.monotonic() + deadline_s
    while not cond():
        if time.monotonic() > end:
            print_worker_logs(work, agents)
            raise AssertionError(f"no {what} within {deadline_s}s")
        time.sleep(0.05)


def merged_timeline(work: str, out: str) -> str:
    """Every agent's timeline in ``work`` (the worker's phases and the
    agent's own) in one JSONL file ``out``, by time."""
    records = [r for name in sorted(os.listdir(work)) if name.startswith("timeline-a")
               for r in read_jsonl(os.path.join(work, name))]
    with open(out, "w") as f:
        for r in sorted(records, key=lambda r: r["t"]):
            f.write(json.dumps(r) + "\n")
    return out


def elastic_worker(card: str, cold: dict, device: str = "cuda", job: dict = WORKER_JOB) -> dict:
    """Phase 8 (see the module docstring). Returns the worker's launches,
    summed over both generations; puts the switch's seconds (``switch_s``)
    and the restore's (``restore_s``: with and without the check's hash)
    into ``cold``."""
    from easydl_tpu_torch.brain.policy import native_core_loaded, startup_plan
    from easydl_tpu_torch.proto import easydl_pb2 as pb

    work = tempfile.mkdtemp(prefix="chip_smoke_worker_")
    counts_dir = os.path.join(work, "counts")
    os.makedirs(counts_dir)
    metrics = {a: os.path.join(work, f"metrics-{a}.jsonl") for a in ("a0", "a1")}
    argv = [sys.executable, "-m", iw.__name__, counts_dir, *WORKER_ARGS]
    try:
        with Phase("8 (the elastic worker under the port's master and agents)"):
            with control_plane(work, job, device) as (master, start):
                a0 = start("a0", argv)
                await_state(lambda: master.status()["members"] == ["a0"],
                            "generation 1 on agent a0", WORKER_DEADLINE_S, work)
                start("a1", argv)  # the replacement on the same card: a standby
                await_state(lambda: "a1" in master.status()["agents"], "agent a1 registered",
                            WORKER_DEADLINE_S, work)
                await_state(lambda: any(r["step"] >= WORKER_QUIESCE_AT
                                        for r in read_jsonl(metrics["a0"])),
                            f"step {WORKER_QUIESCE_AT} of generation 1", WORKER_DEADLINE_S, work)
                notice_step = read_jsonl(metrics["a0"])[-1]["step"]
                t_notice = time.time()
                a0.notify_preemption()  # the host's notice, as the agent's SIGTERM handler
                done = master.wait_done(timeout=2 * WORKER_DEADLINE_S)
                status = master.status()
            if not done:
                print_worker_logs(work, ("a0", "a1"))
                raise AssertionError(f"8: the job did not end under the master: {status}")
            records = read_jsonl(metrics["a0"]) + read_jsonl(metrics["a1"])
            by_gen = {g: [r for r in records if r["generation"] == g] for g in (1, 2)}
            if not (by_gen[1] and by_gen[2]):
                raise AssertionError(f"8: generations {[r['generation'] for r in records]}: "
                                     "no switch before the job's end")
            q = by_gen[1][-1]["step"]
            mgr = CheckpointManager(os.path.join(work, "ckpt"), async_save=False)
            states = {g: read_jsonl(os.path.join(counts_dir, f"states-g{g}.jsonl"))
                      for g in (1, 2)}
            launches = {}
            for g in (1, 2):
                with open(os.path.join(counts_dir, f"launches-g{g}-a0-l0.json")) as f:
                    launches[g] = json.load(f)
            saved = [h for h in states[1] if h["kind"] == "saved" and h["step"] == q]
            restored = [h for h in states[2] if h["kind"] == "restored"]
            tl = {a: read_jsonl(os.path.join(work, f"timeline-{a}.jsonl")) for a in ("a0", "a1")}
            with open(os.path.join(work, "events.jsonl")) as f:
                events = [json.loads(line) for line in f if line.strip()]
            failures = []
            if [r["step"] for r in records] != list(range(1, job["total_steps"] + 1)):
                failures.append(f"steps {[r['step'] for r in records]}: work lost or repeated")
            if by_gen[2][0]["step"] != q + 1:
                failures.append(f"generation 2 starts at {by_gen[2][0]['step']}, not {q + 1}")
            if q not in mgr.steps() or not os.path.exists(os.path.join(work, "DONE")):
                failures.append(f"committed {mgr.steps()}, DONE "
                                f"{os.path.exists(os.path.join(work, 'DONE'))}")
            keys = WORKER_KEYS if device == "cuda" else WORKER_KEYS - {"mfu"}  # no peak on a CPU
            bad_keys = [r for r in records if set(r) != keys]
            if bad_keys:
                failures.append(f"records without the protocol's keys: {bad_keys[:2]}")
            for g, steps in ((1, q), (2, job["total_steps"] - q)):
                want = DIST_LAYERS * MICROBATCHES * steps
                if device == "cuda" and launches[g] != fa.expected_launches(bf16=want):
                    failures.append(f"generation {g} launched {launches[g]}, want {want} each")
            if not (saved and [h["step"] for h in restored] == [q]
                    and iw.hashed_state(restored[0]) == iw.hashed_state(saved[0])):
                failures.append(f"the state restored at step {q} is not the one saved "
                                f"({len(saved)} saves, restores at {[h['step'] for h in restored]})")
            # the runtime's own part: the master drained a0 on its notice and
            # started generation 2 on a1, and the job ended under it
            quiesced = [e for e in tl["a0"] if e["phase"] == "quiesce_sent" and e["gen"] == 1]
            spawned = [e for e in tl["a1"] if e["phase"] == "spawn" and e["gen"] == 2]
            reshapes = [e["reason"] for e in events if e["kind"] == "reshape"]
            if not (status["phase"] == "done" and status["generation"] == 2
                    and status["members"] == ["a1"] and quiesced and spawned
                    and reshapes == ["preemption"] and by_gen[2]
                    and {r["generation"] for r in read_jsonl(metrics["a1"])} == {2}):
                failures.append(f"not one switch by the master from a0 to a1: status {status}, "
                                f"a0 quiesced {quiesced}, a1 spawned {spawned}, reshapes "
                                f"{reshapes}")
            # each generation's first step in this process, from the same
            # state (the init, or the checkpoint) on the same batch
            with shallow_345m(DIST_LAYERS):
                bundle, trainer = job_trainer(job, device)
            first_batch = next(iter(bundle.make_data(job["global_batch"], seed=0)))
            in_process = {}
            for g, begin in ((1, 0), (2, q)):
                state = trainer.init_state() if begin == 0 else trainer.restore_from(mgr, begin)
                _, m = trainer.train_step(state, first_batch)
                in_process[g] = float(m["loss"])
                del state
            del trainer
            first = {g: by_gen[g][0]["loss"] for g in (1, 2)}
            if any(abs(first[g] - in_process[g]) > DIST_LOSS_ABS for g in first):
                failures.append(f"first losses {first} vs {in_process} in process")
            timed = [r for g in (1, 2) for r in by_gen[g][1:]]  # each generation's first: warm-up
            step_s = statistics.mean(r["step_time_s"] for r in timed)
            report = {"step_s": step_s,
                      "tokens_per_s": job["global_batch"] * gpt345m.SEQ / step_s,
                      "mfu": statistics.mean(r.get("mfu", 0.0) for r in timed)}
            plan = startup_plan(pb.JobFeatures(job_name="gpt-345m", model_family="gpt",
                                               model_params=gpt345m.bundle().param_count_hint,
                                               per_host_batch=job["global_batch"]))
            log(f"8 elastic worker ({DIST_LAYERS} layers) under the port's master and agents: "
                f"a0's preemption notice after step {notice_step}, the master's quiesce, a0's "
                f"worker saved step {q}; generation 2 started by agent a1 on the "
                f"master's directive restored it and trained steps "
                f"{by_gen[2][0]['step']}-{by_gen[2][-1]['step']}; master: {status['phase']}, "
                f"generation {status['generation']}, members {status['members']}, reshapes "
                f"{reshapes}; losses {[r['loss'] for r in records]} (in process, from the init "
                f"and from step {q}: {in_process}); launches by generation {launches}; committed "
                f"steps {mgr.steps()}; the state saved and restored at step {q}: "
                f"{len(iw.hashed_state(saved[0])) - 1 if saved else 0} tensors and counts "
                f"hashed; seconds the hashes took (not the worker's own): "
                f"{[(h['kind'], h['step'], round(h['hash_s'], 2)) for h in states[1] + states[2]]}")
            log(f"8 worker step ({DIST_LAYERS} layers; mean of steps after each generation's "
                "first): " + ", ".join(f"{k} {report[k]:.4f}" for k in report)
                + f"; step times {[round(r['step_time_s'], 4) for r in records]}; on {card}")
            merged = merged_timeline(work, os.path.join(work, "timeline-merged.jsonl"))
            switch = [e for e in read_jsonl(merged) if e["t"] >= t_notice]
            log("8 generation switch under the master, seconds from a0's preemption notice "
                "(agent, phase, generation): " + ", ".join(
                    f"{e['phase']} (g{e['gen']}) {e['t'] - t_notice:.2f}" for e in switch
                    if e["phase"] != "step"))
            log("8 generation switch, seconds from quiesce_ckpt_begin (and from the phase "
                f"before): {iw.switch(merged)} (to first_step_done under the emulated agent: "
                f"{' / '.join(map(str, EMULATED_SWITCH_S))})")
            log(f"8 the preemption notice to the master's quiesce directive (a0's "
                f"quiesce_sent): {quiesced[0]['t'] - t_notice:.3f}s; the Brain's policy on "
                f"this host: {'native brain_core' if native_core_loaded() else 'Python twin'}, "
                f"a startup plan of {plan.replicas('worker')} workers for GPT-2 345M; on {card}")
            at = iw.switch_phases(merged, 2)
            cold.update(switch_s=at["first_step_done"] - at["quiesce_ckpt_begin"],
                        restore_s=restore_seconds(merged, states[2], 2))
            if failures:
                raise AssertionError("8: " + "; ".join(failures))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {k: launches[1][k] + launches[2][k] for k in launches[1]}


def job_trainer(job: dict, device):
    """The bundle and the ``Trainer`` the elastic worker builds for ``job`` at
    one device (``torch.optim.Adam``, the JAX worker's ``optax.adam``)."""
    from easydl_tpu_torch.core.train_loop import TrainConfig, Trainer
    from easydl_tpu_torch.models.registry import get_model

    bundle = get_model(job["model"], **job["model_kwargs"])
    return bundle, Trainer(
        init_fn=bundle.init_fn, loss_fn=bundle.loss_fn,
        optimizer=functools.partial(torch.optim.Adam, lr=job["lr"]),
        config=TrainConfig(global_batch=job["global_batch"], grad_accum=job["grad_accum"],
                           seed=job["seed"]),
        device=device, jax_layout=bundle.jax_layout, param_axes=bundle.param_axes)


def restore_seconds(timeline, states: list, gen: int) -> tuple:
    """(seconds from the last ``restore_agreed`` to ``restored`` of ``gen``
    on ``timeline``, the same without the instrumented hash of the restored
    state)."""
    at = {e["phase"]: e["t"] for e in read_jsonl(timeline) if e["gen"] == gen}
    hashed = sum(h["hash_s"] for h in states if h["kind"] == "restored")
    return at["restored"] - at["restore_agreed"], at["restored"] - at["restore_agreed"] - hashed


def file_worker(card: str, cold: dict, device: str = "cuda", job: dict = FILE_JOB,
                tokens: int = FILE_TOKENS, n_layers: int = DIST_LAYERS,
                straggle_s: float = FILE_STRAGGLE_S) -> dict:
    """Phase 9 (see the module docstring); ``cold`` is phase 8's switch.
    Returns the worker's launches, summed over the generations (the
    preflight's step included)."""
    from easydl_tpu_torch.data import TokenFileDataset, write_token_shards

    work = tempfile.mkdtemp(prefix="chip_smoke_files_")
    counts_dir, data_dir = os.path.join(work, "counts"), os.path.join(work, "tokens")
    os.makedirs(counts_dir)
    vocab, seq = job["model_kwargs"]["vocab"], job["model_kwargs"]["seq_len"]
    write_token_shards(np.random.default_rng(0).integers(0, vocab, tokens), data_dir,
                       shard_size=-(-tokens // 2))
    job = {**job, "data_dir": data_dir}
    with open(os.path.join(work, "job.json"), "w") as f:
        json.dump(job, f)
    metrics, tl = os.path.join(work, "metrics-a0.jsonl"), os.path.join(work, "timeline-a0.jsonl")
    spec = os.path.join(work, "chaos.json")

    def straggle(t0) -> None:  # the harness's spec: agent a0 sleeps from t0 (None: inert)
        with open(spec + ".tmp", "w") as f:
            json.dump({"scenario": "chip_smoke", "seed": 0, "t0": t0, "events": [
                {"id": 0, "kind": "straggler", "start_s": 0, "end_s": 3600,
                 "target": {"agent": "a0"}, "params": {"sleep_s": straggle_s}}]}, f)
        os.replace(spec + ".tmp", spec)

    def steps_of(g: int) -> list:
        return [r for r in read_jsonl(metrics) if r["generation"] == g]

    def fail(msg: str) -> None:
        with open(os.path.join(work, "worker-a0.log"), errors="replace") as f:
            print(f"--- the workers' log:\n{f.read()[-6000:]}", file=sys.stderr)
        raise AssertionError(f"9: {msg}")

    def wait_until(cond, what: str, proc) -> None:
        end = time.monotonic() + FILE_DEADLINE_S
        while not cond():
            if proc.poll() is not None or time.monotonic() > end:
                fail(f"no {what} (worker rc {proc.poll()})")
            time.sleep(0.05)

    def exited(proc, what: str) -> None:
        try:
            rc = proc.wait(timeout=FILE_DEADLINE_S)
        except subprocess.TimeoutExpired:
            rc = None
        if rc != 0:
            fail(f"{what} exited {rc}")

    args, env = [*WORKER_ARGS, "--device", device], {"EASYDL_CHAOS_SPEC": spec}
    procs = []
    straggle(None)
    try:
        with Phase("9 (file data; warm standby, preflight)"):
            standby, warm_file = iw.start_gated(counts_dir, work, "warm", args=args, env=env,
                                                hashes=False)
            gen1 = iw.start(counts_dir, work, gen=1, coord=f"localhost:{iw.free_port()}",
                            args=args, env=env, hashes=False)
            procs += [standby, gen1]
            wait_until(lambda: len(steps_of(1)) >= FILE_QUIESCE_AT, "generation 1 step", gen1)
            gen1.send_signal(signal.SIGUSR1)
            exited(gen1, "generation 1")
            wait_until(lambda: os.path.exists(warm_file + ".ready"), "warm standby", standby)
            straggle(time.time())
            iw.promote(warm_file, iw.generation_env(work, gen=2,
                                                    coord=f"localhost:{iw.free_port()}"))
            coord3 = f"localhost:{iw.free_port()}"
            preflight, go_file = iw.start_gated(
                counts_dir, work, "go", args=args, hashes=False,
                env={**env, **iw.generation_env(work, gen=3, coord=coord3)})
            procs.append(preflight)
            wait_until(lambda: steps_of(2), "generation 2 step", standby)
            wait_until(lambda: os.path.exists(go_file + ".ready"), "ready preflight", preflight)
            standby.send_signal(signal.SIGUSR1)
            exited(standby, "generation 2 (the promoted standby)")
            straggle(None)
            iw.promote(go_file, {"generation": 3, "coordinator": coord3})
            exited(preflight, "generation 3 (the promoted preflight)")
            with open(os.path.join(work, "evaluator.log"), "w+") as f:
                rc = run_child(["--evaluator", "--workdir", work, "--device", device,
                                "--batches-per-eval", "1"], FILE_DEADLINE_S,
                               stdout=f, stderr=subprocess.STDOUT)
                if rc:
                    f.seek(0)
                    print(f.read()[-4000:], file=sys.stderr)
                    raise AssertionError(f"9: the evaluator pod exited {rc}")

            records = read_jsonl(metrics)
            total = job["total_steps"]
            q1, q2 = steps_of(1)[-1]["step"], steps_of(2)[-1]["step"]
            failures = []
            if [r["step"] for r in records] != list(range(1, total + 1)) or not (
                    0 < q1 < q2 < total):
                failures.append(f"steps {[(r['step'], r['generation']) for r in records]}: "
                                "work lost or repeated, or a generation without a step")
            mgr = CheckpointManager(os.path.join(work, "ckpt"), async_save=False)
            if not {q1, q2, total} <= set(mgr.steps()) \
                    or not os.path.exists(os.path.join(work, "DONE")):
                failures.append(f"committed {mgr.steps()}, DONE "
                                f"{os.path.exists(os.path.join(work, 'DONE'))}")
            marks = [(e["phase"], e["gen"]) for e in read_jsonl(tl)]
            for mark in (("standby_warm_ready", -1), ("preflight_ready", 3),
                         ("preflight_go", 3)):
                if mark not in marks:
                    failures.append(f"no {mark} on the timeline")

            def counts(name: str) -> dict:
                with open(os.path.join(counts_dir, name)) as f:
                    return json.load(f)

            launches = {g: counts(f"launches-g{g}-a0-l0.json") for g in (1, 2, 3)}
            pre_launches = counts("launches-preflight-g3-a0-l0.json")
            per_step = n_layers * MICROBATCHES
            want = {1: per_step * q1, 2: per_step * (q2 - q1), 3: per_step * (total - q2 + 1)}
            if device == "cuda" and (
                    any(launches[g] != fa.expected_launches(bf16=want[g]) for g in want)
                    or pre_launches != fa.expected_launches(bf16=per_step)):
                failures.append(f"launches {launches}, the preflight's {pre_launches}; want "
                                f"{want} and {per_step} each")
            reads = {g: counts(f"reads-g{g}-a0-l0.json") for g in (2, 3)}
            if any(r["storage"] != 0 or r["cache"] == 0 for r in reads.values()):
                failures.append(f"restore chunk reads {reads}: generations 2 and 3 must read "
                                "every chunk from the host cache")
            straggled = [r["step_time_s"] for r in steps_of(2)]
            if min(straggled) < straggle_s or max(
                    r["step_time_s"] for r in steps_of(1) + steps_of(3)) >= straggle_s:
                failures.append(f"step times {[r['step_time_s'] for r in records]}: only "
                                f"generation 2 straggles {straggle_s}s a step")
            # every batch against an uninterrupted reading of the same files
            gb = job["global_batch"]
            uninterrupted = TokenFileDataset(data_dir, batch_size=gb, seq_len=seq,
                                             split="train", val_fraction=job["val_fraction"])
            stream = iter(uninterrupted)
            want_batches = {k: next(stream) for k in range(1, total + 1)}
            sha = {k: {n: hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()
                       for n, v in b.items()} for k, b in want_batches.items()}
            got = {g: read_jsonl(os.path.join(counts_dir, f"batches-g{g}.jsonl"))
                   for g in (1, 2, 3)}
            trained = {r["step"]: {n: r[n] for n in ("inputs", "targets")}
                       for g in got for r in got[g] if not r["preflight"]}
            if trained != sha:
                failures.append("batches differ from an uninterrupted reading at steps "
                                f"{sorted(k for k in sha if trained.get(k) != sha[k])}")
            if [r["preflight"] for r in got[3]][:1] != [True]:
                failures.append("the preflight ran no discarded step before its go")
            # each generation's first loss against this process, from the same
            # state (init, or the checkpoint it restored) on the same batch
            with shallow_345m(n_layers):
                bundle, trainer = job_trainer(job, device)
            in_process = {}
            for g, start in ((1, 0), (2, q1), (3, q2)):
                state = trainer.init_state() if start == 0 else trainer.restore_from(mgr, start)
                _, m = trainer.train_step(state, want_batches[start + 1])
                in_process[g] = float(m["loss"])
                del state
            # the cache against storage for one restore in this process, warm,
            # the same step each way, alternated: seconds until the state is
            # on the card
            cache, restore_s = mgr.cache, {"cache": [], "storage": []}
            for source in ("storage", "cache", "cache", "storage"):
                mgr.cache = cache if source == "cache" else None
                t0 = time.perf_counter()
                state = trainer.restore_from(mgr, q2)
                if device == "cuda":
                    torch.cuda.synchronize()
                restore_s[source].append(round(time.perf_counter() - t0, 3))
                del state
            mgr.cache = cache
            first = {g: steps_of(g)[0]["loss"] for g in (1, 2, 3)}
            if any(abs(first[g] - in_process[g]) > DIST_LOSS_ABS for g in first):
                failures.append(f"first losses {first} vs {in_process} in process")
            evals = read_jsonl(os.path.join(work, "eval.jsonl"))
            val = iter(TokenFileDataset(data_dir, batch_size=gb, seq_len=seq, seed=1,
                                        split="val", val_fraction=job["val_fraction"]))
            state = trainer.restore_from(mgr, total)
            # the eval's loss, as ln(perplexity)
            live = math.log(float(trainer.build_eval_step(bundle.eval_fn)(
                state, next(val))["perplexity"]))
            del state, trainer
            if not evals or evals[-1]["step"] != total \
                    or abs(math.log(evals[-1]["perplexity"]) - live) > DIST_LOSS_ABS:
                failures.append(f"evaluator pod {evals[-1:]} vs the val split's first batch at "
                                f"step {total} in process: loss {live}")

            states = {g: read_jsonl(os.path.join(counts_dir, f"states-g{g}.jsonl"))
                      for g in (2, 3)}
            memory = counts("memory-preflight-g3-a0-l0.json") if device == "cuda" else {}
            log(f"9 file data: {tokens} token ids in 2 shards ({uninterrupted.num_windows} "
                f"windows of {seq + 1}, {uninterrupted.batches_per_epoch} train batches an "
                f"epoch); generation 1 (cold) trained 1-{q1}, 2 (warm standby) {q1 + 1}-{q2} "
                f"straggling {straggle_s}s a step, 3 (preflight) {q2 + 1}-{total}; losses "
                f"{[r['loss'] for r in records]}, first losses {first}, in process "
                f"{in_process}; evaluator pod {evals[-1:]} (in process: loss {live}); launches "
                f"{launches}, the preflight's {pre_launches}; restore chunk reads {reads}")
            for g, kind in ((2, "warm"), (3, "preflight")):
                at = iw.switch_phases(tl, g)
                log(f"9 {kind} switch into generation {g}, seconds from quiesce_ckpt_begin "
                    f"(and from the phase before): {iw.switch(tl, g)}; quiesce_ckpt_begin to "
                    f"first_step_done {at['first_step_done'] - at['quiesce_ckpt_begin']:.2f} "
                    f"(cold, phase 8: {cold['switch_s']:.2f})")
                raw, unhashed = restore_seconds(tl, states[g], g)
                log(f"9 {kind} restore {raw:.2f}s, {unhashed:.2f}s without the check's hash "
                    f"(cold, phase 8: {cold['restore_s'][0]:.2f}, {cold['restore_s'][1]:.2f}); "
                    f"chunks from the host cache {reads[g]['cache']}, from storage "
                    f"{reads[g]['storage']}")
            log(f"9 one restore of step {q2} in this process, seconds: from the host cache "
                f"{restore_s['cache']}, from storage {restore_s['storage']} (storage then cache, "
                "cache, storage)")
            if memory:
                log(f"9 the preflight held while it waited, on {card}: allocated "
                    f"{memory['allocated'] / 2**30:.2f} GiB, reserved "
                    f"{memory['reserved'] / 2**30:.2f} GiB (its discarded step's peak "
                    f"{memory['peak'] / 2**30:.2f} GiB)")
            if failures:
                raise AssertionError("9: " + "; ".join(failures))
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
        shutil.rmtree(work, ignore_errors=True)
    return {k: sum(launches[g][k] for g in launches) for k in launches[1]}


def bert_trainer(**model_options):
    """Phase 10's bundle and ``Trainer``: BERT-base (f32) with phase 4's
    optimizer, global batch 32 in 4 microbatches."""
    from easydl_tpu_torch.core.train_loop import TrainConfig
    from easydl_tpu_torch.models.registry import get_model

    bundle = get_model("bert", size="base", **model_options)
    return bundle, gpt345m.trainer(bundle, config=TrainConfig(
        global_batch=BERT_GLOBAL_BATCH, grad_accum=BERT_MICROBATCHES))


def bert_model_check(bundle, model, batch) -> None:
    """10c (see the module docstring)."""
    ref = bert_trainer(attention_impl="reference")[0].init_fn(1, "cuda")
    ref.load_state_dict(model.state_dict())
    rng = prng.BatchKey(prng.fold_in(prng.PRNGKey(0), 1000))

    def readings(net):
        with torch.no_grad():
            logits = net(batch["inputs"]).float()
        net.zero_grad(set_to_none=True)
        bundle.loss_fn(net, batch, rng)[0].backward()
        grads = {n: p.grad.float() for n, p in net.named_parameters()}
        net.zero_grad(set_to_none=True)
        return logits, grads

    want_logits, want_grads = readings(ref)
    real = fa.flash_attention

    def rounded(q, k, v, **kwargs):  # the planted fault: bf16 operands
        return real(*(x.to(torch.bfloat16).float() for x in (q, k, v)), **kwargs)

    out = {}
    for name, attention in (("sound", real), ("planted fault", rounded)):
        with mock.patch.object(fa, "flash_attention", attention):
            logits, grads = readings(model)
        rel = rel_l2(grads, want_grads, skip=(".k.bias",))
        worst = max(rel, key=rel.get)
        out[name] = {"logits": ((logits - want_logits).norm() / want_logits.norm()).item(),
                     "grads": rel[worst], "worst": worst}
    log(f"10c model check ({batch['inputs'].shape[0]} sequences), f32 kernels vs the reference "
        f"attention, relative L2: " + "; ".join(
            f"{n}: logits {r['logits']:.3g}, largest gradient {r['grads']:.3g} ({r['worst']})"
            for n, r in out.items()) + f"; bounds {BERT_MODEL_REL}")
    for key, bound in BERT_MODEL_REL.items():
        if not out["sound"][key] <= bound < out["planted fault"][key]:
            raise AssertionError(f"10c {key}: sound {out['sound'][key]:.3g}, planted fault "
                                 f"{out['planted fault'][key]:.3g}, bound {bound}")


def bert_preemption(card: str, device: str = "cuda", job: dict = BERT_JOB,
                    tokens: int = BERT_TOKENS) -> dict:
    """10d (see the module docstring). Returns generation 2's launches."""
    from easydl_tpu_torch.data import TokenFileDataset, write_token_shards

    work = tempfile.mkdtemp(prefix="chip_smoke_bert_")
    counts_dir, data_dir = os.path.join(work, "counts"), os.path.join(work, "tokens")
    os.makedirs(counts_dir)
    vocab = bert.make_bert(**job["model_kwargs"]).make_data(1).vocab
    write_token_shards(np.random.default_rng(0).integers(0, vocab, tokens), data_dir)
    job = {**job, "data_dir": data_dir}
    with open(os.path.join(work, "job.json"), "w") as f:
        json.dump(job, f)
    metrics, tl = os.path.join(work, "metrics-a0.jsonl"), os.path.join(work, "timeline-a0.jsonl")
    mgr = CheckpointManager(os.path.join(work, "ckpt"), async_save=False)

    def steps_of(g: int) -> list:
        return [r for r in read_jsonl(metrics) if r["generation"] == g]

    try:
        with control_plane(work, job, device) as (master, start):
            a0 = start("a0", [sys.executable, "-m", iw.__name__, counts_dir])
            await_state(lambda: len(steps_of(1)) >= BERT_KILL_AT and 2 in mgr.steps(),
                        f"step {BERT_KILL_AT} of generation 1 after a committed save of step 2",
                        BERT_DEADLINE_S, work)
            a0.kill_worker_hard()  # SIGKILL, no notice; its ranks die with it
            t_kill = time.time()
            killed = {r["step"]: r["loss"] for r in steps_of(1)}
            saved = mgr.steps()[-1]
            done = master.wait_done(timeout=BERT_DEADLINE_S)
            status = master.status()
        if not done:
            print_worker_logs(work)
            raise AssertionError(f"10d: the job did not end under the master: {status}")
        with open(os.path.join(work, "events.jsonl")) as f:
            reshapes = [json.loads(line)["reason"] for line in f
                        if json.loads(line)["kind"] == "reshape"]
        spawns = [e["gen"] for e in read_jsonl(tl) if e["phase"] == "spawn"]

        records = read_jsonl(metrics)
        total = job["total_steps"]
        replayed = [s for s in killed if s > saved]
        again = {r["step"]: r["loss"] for r in steps_of(2)}
        failures = []
        if not (status["phase"] == "done" and status["generation"] == 2
                and status["members"] == ["a0"] and spawns == [1, 2]
                and reshapes == ["member-lost"]):
            failures.append(f"not one restart by the master on agent a0: status {status}, a0 "
                            f"spawned generations {spawns}, reshapes {reshapes}")
        if list(killed) != list(range(1, len(killed) + 1)) or list(again) != list(
                range(saved + 1, total + 1)) or not replayed:
            failures.append(f"steps {[(r['step'], r['generation']) for r in records]} with step "
                            f"{saved} committed at the kill: work lost, or no step replayed")
        if total not in mgr.steps() or not os.path.exists(os.path.join(work, "DONE")):
            failures.append(f"committed {mgr.steps()}, DONE "
                            f"{os.path.exists(os.path.join(work, 'DONE'))}")
        bad_keys = [r for r in records if set(r) != WORKER_KEYS - {"mfu"}]
        if bad_keys:  # BERT has no MFU numerator: no mfu key, as in the JAX worker
            failures.append(f"records without the protocol's keys, or with an mfu: "
                            f"{bad_keys[:2]}")
        states = {g: read_jsonl(os.path.join(counts_dir, f"states-g{g}.jsonl")) for g in (1, 2)}
        hashed = [h for h in states[1] if h["kind"] == "saved" and h["step"] == saved]
        restored = [h for h in states[2] if h["kind"] == "restored"]
        if not (hashed and [h["step"] for h in restored] == [saved]
                and iw.hashed_state(restored[0]) == iw.hashed_state(hashed[0])):
            failures.append(f"the state restored at step {saved} is not the one saved")
        with open(os.path.join(counts_dir, "launches-g2-a0-l0.json")) as f:
            launches = json.load(f)
        n_layers = bert.SIZES[job["model_kwargs"]["size"]][0]
        want = fa.expected_launches(f32=n_layers * job["grad_accum"] * (total - saved))
        if device == "cuda" and launches != want:
            failures.append(f"generation 2 launched {launches}, want {want}")
        replay_err = max((abs(again[s] - killed[s]) for s in replayed), default=float("nan"))
        if not replay_err <= BERT_REPLAY_ABS:
            failures.append(f"replayed losses {[again.get(s) for s in replayed]} vs the killed "
                            f"generation's {[killed[s] for s in replayed]}")
        # the first replayed step in this process, from the same checkpoint
        # and batch, with its own mask and with the mask of the step after
        bundle, trainer = job_trainer(job, device)
        source = TokenFileDataset(data_dir, batch_size=job["global_batch"],
                                  seq_len=bundle.make_data(1).seq_len)
        source.restore_state(mgr.metadata(saved)["metadata"]["data_state"])
        batch = next(iter(source))
        readings = {}
        for name, step in (("sound", saved), ("mask of the step after", saved + 1)):
            state = trainer.restore_from(mgr, saved)
            state.step = step  # the step the key chain folds in
            _, m = trainer.train_step(state, batch)
            readings[name] = abs(float(m["loss"]) - killed[saved + 1])
            del state
        del trainer
        if not readings["mask of the step after"] > BERT_REPLAY_ABS:
            failures.append(f"a wrong mask passes the replay bound: {readings}")
        at = {e["phase"]: e["t"] for e in read_jsonl(tl) if e["gen"] == 2}
        raw, unhashed = restore_seconds(tl, states[2], 2)
        log(f"10d BERT-base worker preemption: SIGKILL at step {max(killed)} with step {saved} "
            f"committed; generation 2 restored step {saved}, replayed steps {replayed} and "
            f"trained to {total}; losses generation 1 {killed}, generation 2 {again}; replayed "
            f"vs killed max |diff| {replay_err!r} (bound {BERT_REPLAY_ABS}); in this process "
            f"from step {saved}: {readings}; generation 2 launches {launches}")
        log("10d recovery, seconds from the kill: " + ", ".join(
            f"{p} {at[p] - t_kill:.2f}" for p in sorted(at, key=at.get))
            + f"; the restore {raw:.2f}s ({unhashed:.2f}s without the check's hash); "
            f"{len(replayed)} steps replayed; under the port's master and agent (generation 2 "
            f"started by a0 on the master's directive after a {reshapes[0]} reshape; to "
            f"first_step_done under the emulated agent: "
            f"{' / '.join(map(str, EMULATED_RECOVERY_S))}); on {card}")
        if failures:
            raise AssertionError("10d: " + "; ".join(failures))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches


def bert_train(card: str, out: str) -> int:
    """10a-10c (see the module docstring), as ``chip_smoke.py --bert CARD
    OUT``: writes the f32 kernels' rows of the ``kernels`` line and 10b's
    launches to ``OUT``. The kernels' library was built by the parent."""
    torch.backends.cuda.matmul.allow_tf32 = False  # BERT's products are f32
    torch.backends.cudnn.allow_tf32 = False
    fa._lib()
    with Phase("10a (f32 kernels at BERT-base's shape)"):
        rows = check_kernels(BERT_BH, 512, 512, 64, torch.float32, False, seed=6, timed=True,
                             peak_flops=TF32X3_PEAK_FLOPS, heads=BERT_HEADS,
                             fp32_flops=F32_PEAK_FLOPS)
        for r in rows:
            log(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound "
                f"{r['bound_ms']:.4f} by {r['bound_by']} at 3xTF32, share "
                f"{r['bound_ms'] / r['ms']:.3f}; {r['bound_ms_fp32']:.4f} at the CUDA cores' "
                f"f32 rate, share {r['bound_ms_fp32'] / r['ms']:.3f}; sdpa f32 "
                f"{r['library_ms']:.4f}) on {card}")
    with Phase("10b-c (BERT-base training, model check)"):
        bundle, trainer = bert_trainer()
        state = trainer.init_state()
        data = iter(bundle.make_data(BERT_GLOBAL_BATCH, seed=0))
        drawn, real_mask = [], bert.mlm_mask

        def recorded(rng, tokens, mask_prob):  # keeps the mask on the card: no sync
            mask = real_mask(rng, tokens, mask_prob)
            drawn.append((rng, mask.clone()))
            return mask

        with mock.patch.object(bert, "mlm_mask", recorded):
            losses, norms, step_s, counts, peak_gib = train_timed(trainer, state, data)
        seq, vocab = state.model.cfg.max_seq, state.model.cfg.vocab
        step_time = statistics.mean(step_s[1:])
        tokens_per_s = BERT_GLOBAL_BATCH * seq / step_time
        keys = [prng.fold_in(prng.fold_in(prng.PRNGKey(0), s), i)
                for s in range(STEPS) for i in range(BERT_MICROBATCHES)]
        micro = (BERT_GLOBAL_BATCH // BERT_MICROBATCHES, seq)
        unequal = [n for n, ((rng, mask), key) in enumerate(zip(drawn, keys))
                   if rng.key != key or not torch.equal(mask.cpu(), prng.bernoulli(key, 0.15,
                                                                                   micro))]
        want = fa.expected_launches(f32=BERT_LAYERS * BERT_MICROBATCHES * STEPS)
        log(f"10b bert-base b{BERT_GLOBAL_BATCH}/a{BERT_MICROBATCHES} seq {seq} f32 model, bf16 "
            f"compute cast: losses {losses} (ln vocab {math.log(vocab):.4f}), grad norms {norms}, "
            f"launches {counts}; {len(drawn)} masks drawn on the card, "
            f"{len(drawn) - len(unequal)} bit-equal to core/prng.py's on the CPU for their "
            f"(seed, step, microbatch)")
        log(f"10b step {step_time:.4f}s (timed steps {step_s[1:]}), {tokens_per_s:.0f} tokens/s, "
            f"peak mem {peak_gib:.2f} GiB, on {card}")
        if abs(losses[0] - math.log(vocab)) > 1.0:
            raise AssertionError(f"first loss {losses[0]} far from ln(vocab)")
        if counts != want:
            raise AssertionError(f"10b launches {counts}, want {want}")
        if len(drawn) != len(keys) or unequal:
            raise AssertionError(f"10b masks: {len(drawn)} drawn, want {len(keys)}; "
                                 f"unequal at {unequal}")
        busy = profile_step(trainer, state, next(data), step_time, label="10b profile")["busy"]
        log(f"10b device idle share of the step: "
            f"{'not measured' if busy is None else f'{1 - busy:.3f}'}")
        batch = trainer.to_device(next(data))
        bert_model_check(bundle, state.model, {k: v[:micro[0]] for k, v in batch.items()})
    with open(out, "w") as f:
        json.dump({"rows": rows, "launches": counts}, f)
    return 0


def bert_base(card: str) -> tuple:
    """Phase 10 (see the module docstring). Returns (the f32 kernels' rows
    of the ``kernels`` line, each sub-phase's launches). 10a-10c run in a
    process of their own: in the process that ran phases 2-9,
    ``torch.profiler`` once saw no device time in 10a (H100, torch 2.11),
    where a fresh process sees it."""
    fd, out = tempfile.mkstemp(prefix="chip_smoke_bert_", suffix=".json")
    os.close(fd)
    try:
        rc = run_child(["--bert", card, out], BERT_DEADLINE_S)
        if rc:
            raise AssertionError(f"10a-10c exited {rc}")
        with open(out) as f:
            res = json.load(f)
    finally:
        os.remove(out)
    phases = {"10b": res["launches"]}
    with Phase("10d (BERT-base worker under the master, SIGKILL and replay)"):
        phases["10d"] = bert_preemption(card)
    return res["rows"], phases


def resnet_trainer(**options):
    """Phase 11's bundle and ``Trainer``: ResNet-50 with the runner's AdamW,
    global batch 64 in 2 microbatches, on the card; ``options`` go to
    ``Trainer`` (``mesh_spec``, ``device``)."""
    from easydl_tpu_torch.core.train_loop import TrainConfig, Trainer
    from easydl_tpu_torch.models.registry import get_model
    from easydl_tpu_torch.models.run import ADAMW_WEIGHT_DECAY

    bundle = get_model("resnet", **RESNET_MODEL)
    return bundle, Trainer(**{
        "init_fn": bundle.init_fn, "loss_fn": bundle.loss_fn,
        "optimizer": functools.partial(torch.optim.AdamW, lr=RESNET_LR,
                                       weight_decay=ADAMW_WEIGHT_DECAY),
        "config": TrainConfig(global_batch=RESNET_GLOBAL_BATCH, grad_accum=RESNET_MICROBATCHES),
        "device": "cuda", "jax_layout": bundle.jax_layout, "param_axes": bundle.param_axes,
        **options})


def resnet_batches(bundle, n: int) -> list:
    """The first ``n`` global batches of the bundle's stream (seed 0), drawn
    before any clock starts: 9.6M normal floats a batch is host time no
    user pays."""
    data = iter(bundle.make_data(RESNET_GLOBAL_BATCH, seed=0))
    return [next(data) for _ in range(n)]


def resnet_profile(trainer, state, host_batch, step_time: float, card: str) -> dict:
    """11a's profile: one traced step's device time by ``RESNET_GROUPS``
    (each kernel under the outermost host op that launched it), the largest
    kernels, and the busy share of the untraced step."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, metrics = trainer.train_step(state, host_batch)
        float(metrics["loss"])
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False)]
    device = sum(ms for _, ms, _ in kernels)
    groups = dict.fromkeys([*RESNET_GROUPS, "the rest"], 0.0)
    for e in prof.events():
        ms = sum(k.duration for k in e.kernels) / 1e3
        if not ms:
            continue
        root = e
        while root.cpu_parent is not None:
            root = root.cpu_parent
        groups[next((g for g, keys in RESNET_GROUPS.items()
                     if any(k in root.name for k in keys)), "the rest")] += ms
    if not device:
        log("11a profile: the profiler saw no device time; breakdown not measured")
        return {"groups": None, "busy": None}
    linked = sum(groups.values())
    busy = device / 1e3 / step_time
    log(f"11a profile: {device:.1f} ms of kernels in one step ({busy:.3f} of the untraced step "
        f"{step_time:.4f}s; idle share {1 - busy:.3f}) on {card}; by the host op that launched "
        f"them ({linked:.1f} ms linked): " + ", ".join(
            f"{g} {ms:.1f} ms ({ms / max(linked, 1e-9):.3f})" for g, ms in groups.items()))
    for name, ms, count in sorted(kernels, key=lambda k: -k[1])[:12]:
        log(f"  {ms:9.3f} ms  x{count:<5d} {name[:110]}")
    return {"groups": groups, "busy": busy}


def resnet_card_vs_cpu(bundle) -> None:
    """11b (see the module docstring)."""
    import copy

    import torch.nn.functional as F

    cpu = bundle.init_fn(1, "cpu")
    with torch.no_grad():  # a head that passes gradients on (the init's is zero)
        cpu.head.weight.normal_(0.0, 0.01, generator=torch.Generator().manual_seed(2))
    card = bundle.init_fn(1, "cuda")
    card.load_state_dict(cpu.state_dict())
    batch = next(iter(bundle.make_data(RESNET_CHECK_BATCH, seed=3)))

    def readings(model, device, dtype=torch.float32):
        image = torch.from_numpy(batch["image"]).to(device, dtype)
        model.zero_grad(set_to_none=True)
        logits = model(image)
        F.cross_entropy(logits, torch.from_numpy(batch["label"]).to(device).long()).backward()
        return logits.detach().cpu().double(), {n: p.grad.cpu().double()
                                                for n, p in model.named_parameters()}

    def gaps(got, want) -> dict:
        (logits, grads), (want_logits, want_grads) = got, want
        rel = rel_l2(grads, want_grads)
        worst = max(rel, key=rel.get)
        flat = [torch.cat([g[n].flatten() for n in want_grads]) for g in (grads, want_grads)]
        return {"logits": ((logits - want_logits).norm() / want_logits.norm()).item(),
                "grads": ((flat[0] - flat[1]).norm() / flat[1].norm()).item(),
                "worst": f"{rel[worst]:.3g} ({worst})"}

    t0 = time.perf_counter()
    want = readings(cpu, "cpu")
    cpu_s = time.perf_counter() - t0
    out = {"the CPU's f32 against its f64": gaps(want, readings(copy.deepcopy(cpu).double(),
                                                                 "cpu", torch.float64))}
    for name, tf32 in (("sound", False), ("planted fault (cuDNN's TF32 allowed)", True)):
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            out[name] = gaps(readings(card, "cuda"), want)
        finally:
            torch.backends.cudnn.allow_tf32 = False
    log(f"11b resnet-50, {RESNET_CHECK_BATCH} images at {batch['image'].shape[1]}, the card "
        f"against the CPU's f32 ({cpu_s:.1f}s on the CPU), relative L2 of the logits and of "
        f"the whole gradient (its worst parameter beside): " + "; ".join(
            f"{n}: logits {r['logits']:.3g}, gradient {r['grads']:.3g}, worst {r['worst']}"
            for n, r in out.items()) + f"; bounds {RESNET_CPU_REL}")
    fault = out["planted fault (cuDNN's TF32 allowed)"]
    for key, bound in RESNET_CPU_REL.items():
        if not out["sound"][key] <= bound < fault[key]:
            raise AssertionError(f"11b {key}: sound {out['sound'][key]:.3g}, planted fault "
                                 f"{fault[key]:.3g}, bound {bound}")


def resnet_rank_main(rank: int, work: str) -> int:
    """One of 11c's two ranks (``chip_smoke.py --resnet-rank R WORKDIR``):
    joins a gloo group of two on cuda:0, trains ``RESNET_DIST_STEPS`` steps
    at dp 2, sound and with the planted fault, and rank 0 writes each run's
    gap to one process's parameters (``WORKDIR/ref.pt``) to
    ``WORKDIR/result.json``."""
    import faulthandler
    from datetime import timedelta

    import torch.distributed as dist
    from torch.distributed.fsdp._fully_shard import _fsdp_collectives

    from easydl_tpu_torch.core.mesh import MeshSpec, init_distributed

    class SkipAllReduce:
        """The planted fault, as FSDP2's collectives see ``torch.distributed``:
        its all-reduce of the gradients over dp (HSDP's replicas) does
        nothing, so each rank steps on its own rows' gradient."""

        def __getattr__(self, name):
            return getattr(dist, name)

        @staticmethod
        def all_reduce(*args, **kwargs):
            return None

    faulthandler.enable()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed("cuda:0", backend="gloo", rank=rank, world_size=2,
                     store=dist.FileStore(os.path.join(work, "store"), 2),
                     timeout=timedelta(seconds=DIST_DEADLINE_S))
    ref = torch.load(os.path.join(work, "ref.pt")) if rank == 0 else None
    rows = slice(rank * RESNET_GLOBAL_BATCH // 2, (rank + 1) * RESNET_GLOBAL_BATCH // 2)
    out = {}
    for name, fault in (("dp 2", False), ("dp 2, planted fault: no gradient all-reduce", True)):
        bundle, trainer = resnet_trainer(device="cuda:0", mesh_spec=MeshSpec(dp=2))
        state = trainer.init_state()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, t0 = [], time.perf_counter()
        with mock.patch.object(_fsdp_collectives, "dist", SkipAllReduce()) if fault \
                else contextlib.nullcontext():
            for batch in resnet_batches(bundle, RESNET_DIST_STEPS):
                state, metrics = trainer.train_step(state, {k: v[rows] for k, v in batch.items()})
                losses.append(float(metrics["loss"]))
        seconds = time.perf_counter() - t0
        diff = norm = 0.0
        for n, p in state.model.named_parameters():
            full = whole(p)
            if rank == 0:
                want = ref[n].to(full.device)
                diff += (full - want).double().square().sum().item()
                norm += want.double().square().sum().item()
        out[name] = {"losses": losses, "seconds": seconds, "fault": fault,
                     "rel": math.sqrt(diff / norm) if norm else None,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        del state, trainer
        gc.collect()
        torch.cuda.empty_cache()
    if rank == 0:
        with open(os.path.join(work, "result.json"), "w") as f:
            json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def resnet_all_reduce(losses: list) -> None:
    """11c (see the module docstring): ``losses`` are 11a's, from the same
    init on the same batches."""
    work = tempfile.mkdtemp(prefix="chip_smoke_resnet_ranks_")
    try:
        bundle, trainer = resnet_trainer()
        state = trainer.init_state()
        for batch in resnet_batches(bundle, RESNET_DIST_STEPS):
            state, _ = trainer.train_step(state, batch)
        torch.save({n: p.detach().cpu() for n, p in state.model.named_parameters()},
                   os.path.join(work, "ref.pt"))
        del state, trainer
        gc.collect()
        torch.cuda.empty_cache()
        start_ranks("--resnet-rank", 2, work, "11c")
        with open(os.path.join(work, "result.json")) as f:
            res = json.load(f)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    failures = []
    for name, r in res.items():
        log(f"11c {name}: losses {r['losses']} (11a's {losses[:RESNET_DIST_STEPS]}), "
            f"{r['seconds']:.2f}s for {RESNET_DIST_STEPS} steps, peak mem {r['peak_gib']:.2f} GiB "
            f"(rank 0), parameters vs one process relative L2 {r['rel']:.4g} (bound "
            f"{RESNET_DIST_REL})")
        if r["fault"] != (r["rel"] > RESNET_DIST_REL):
            failures.append(f"{name}: {r['rel']:.4g} against the bound {RESNET_DIST_REL}")
        worst = max(abs(a - b) for a, b in zip(r["losses"], losses))
        if not r["fault"] and worst > DIST_LOSS_ABS:
            failures.append(f"{name}: losses {r['losses']} vs 11a's {losses}")
    if failures:
        raise AssertionError("11c: " + "; ".join(failures))


def resnet_checkpoint(trainer, state, host_batch) -> None:
    """11d (see the module docstring)."""
    work = tempfile.mkdtemp(prefix="chip_smoke_resnet_ckpt_")
    try:
        mgr = CheckpointManager(work)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(state.step, trainer.state_leaves(state))
        t_snap = time.perf_counter() - t0
        mgr.wait()
        t_save = time.perf_counter() - t0
        saved = state_hashes(state)
        restorer = resnet_trainer()[1]
        t0 = time.perf_counter()
        restored = restorer.restore_from(CheckpointManager(work))
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        got = state_hashes(restored)
        differ = [k for k in saved if got.get(k) != saved[k]]
        nbytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(work)
                     for f in fs)
        # the next step from each: cuDNN's backward may sum in another order
        # from call to call, so deterministic algorithms for both
        with torch.backends.cudnn.flags(enabled=True, deterministic=True, allow_tf32=False):
            _, m1 = trainer.train_step(state, host_batch)
            _, m2 = restorer.train_step(restored, host_batch)
        a, b = float(m1["loss"]), float(m2["loss"])
        gap = math.sqrt(sum((p - q).double().square().sum().item() for p, q in
                            zip(state.model.parameters(), restored.model.parameters()))
                        / sum(p.double().square().sum().item() for p in state.model.parameters()))
        log(f"11d checkpoint of step {saved['step']}: {nbytes / 2**20:.1f} MiB, save "
            f"{t_snap:.2f}s snapshot + {t_save - t_snap:.2f}s write and commit, restore "
            f"{t_restore:.2f}s; {len(got) - 1} tensors and counts compared, {len(differ)} differ "
            f"{differ[:6]}; the next step from each: losses {a!r} / {b!r}, parameters "
            f"{gap:.3g} apart in relative L2")
        if differ or set(got) != set(saved):
            raise AssertionError("11d: the restored state is not the saved one")
        if a != b or gap > 1e-6:
            raise AssertionError(f"11d: the next step differs: {a!r} / {b!r}, {gap:.3g}")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def resnet_train(card: str, out: str) -> int:
    """11a-11d (see the module docstring), as ``chip_smoke.py --resnet CARD
    OUT``: writes 11a's readings and launches to ``OUT``."""
    torch.backends.cuda.matmul.allow_tf32 = False  # the model's f32 stays f32
    torch.backends.cudnn.allow_tf32 = False
    res = {}
    with Phase("11a (ResNet-50 training)"):
        bundle, trainer = resnet_trainer()
        state = trainer.init_state()
        batches = resnet_batches(bundle, STEPS + 2)
        losses, norms, step_s, counts, peak_gib = train_timed(trainer, state,
                                                              iter(batches[:STEPS]))
        jax_count = sum(math.prod(shape) for key, (shape, _) in
                        jax_state.leaf_shapes(state.model, bundle.jax_layout).items()
                        if key.startswith(".params"))
        step_time = statistics.mean(step_s[1:])
        log(f"11a resnet-50 b{RESNET_GLOBAL_BATCH}/a{RESNET_MICROBATCHES} 224x224, bf16 compute "
            f"cast, f32 model: losses {losses} (ln 1000 {math.log(1000):.6f}), grad norms "
            f"{norms}, launches {counts}; {jax_count} parameters in the JAX tree "
            f"({sum(p.numel() for p in state.model.parameters())} in the port's)")
        log(f"11a step {step_time:.4f}s (timed steps {step_s[1:]}), "
            f"{RESNET_GLOBAL_BATCH / step_time:.1f} images/s, peak mem {peak_gib:.2f} GiB, on "
            f"{card}")
        if abs(losses[0] - math.log(1000)) > RESNET_FIRST_LOSS_ABS:
            raise AssertionError(f"11a first loss {losses[0]}, want ln(1000) within "
                                 f"{RESNET_FIRST_LOSS_ABS}")
        if any(counts.values()):
            raise AssertionError(f"11a launched flash kernels: {counts}")
        if jax_count != RESNET_PARAMS:
            raise AssertionError(f"11a: {jax_count} parameters, the JAX tree has {RESNET_PARAMS}")
        res.update(launches=counts, step_s=step_time, losses=losses, peak_gib=peak_gib,
                   **resnet_profile(trainer, state, batches[STEPS], step_time, card))
    with Phase("11d (ResNet-50 checkpoint round trip)"):
        resnet_checkpoint(trainer, state, batches[STEPS + 1])
    del state, trainer
    gc.collect()
    torch.cuda.empty_cache()
    with Phase("11b (ResNet-50, the card against the CPU)"):
        resnet_card_vs_cpu(bundle)
    gc.collect()
    torch.cuda.empty_cache()
    with Phase("11c (ResNet-50 all-reduce, two gloo ranks at dp 2)"):
        resnet_all_reduce(losses)
    with open(out, "w") as f:
        json.dump(res, f)
    return 0


def resnet_50(card: str) -> dict:
    """Phase 11 (see the module docstring), in a process of its own; returns
    11a's launches."""
    fd, out = tempfile.mkstemp(prefix="chip_smoke_resnet_", suffix=".json")
    os.close(fd)
    try:
        with Phase("11 (ResNet-50, BASELINE config 2)"):
            rc = run_child(["--resnet", card, out], RESNET_DEADLINE_S)
            if rc:
                raise AssertionError(f"phase 11 exited {rc}")
        with open(out) as f:
            return json.load(f)["launches"]
    finally:
        os.remove(out)


def deepfm_trainer(name: str = "deepfm", global_batch: int = DEEPFM_GLOBAL_BATCH,
                   grad_accum: int = DEEPFM_MICROBATCHES, **options):
    """Phase 12's bundle and ``Trainer``: the JAX defaults with the runner's
    AdamW, bf16 compute, on the card; ``options`` go to ``Trainer``
    (``mesh_spec``, ``device``)."""
    from easydl_tpu_torch.core.train_loop import TrainConfig, Trainer
    from easydl_tpu_torch.models.registry import get_model
    from easydl_tpu_torch.models.run import ADAMW_WEIGHT_DECAY

    bundle = get_model(name)
    return bundle, Trainer(**{
        "init_fn": bundle.init_fn, "loss_fn": bundle.loss_fn,
        "optimizer": functools.partial(torch.optim.AdamW, lr=DEEPFM_LR,
                                       weight_decay=ADAMW_WEIGHT_DECAY),
        "config": TrainConfig(global_batch=global_batch, grad_accum=grad_accum),
        "device": "cuda", "jax_layout": bundle.jax_layout, "param_axes": bundle.param_axes,
        **options})


def deepfm_batches(bundle, n: int) -> list:
    """The first ``n`` global batches of the bundle's stream (seed 0), drawn
    before any clock starts."""
    data = iter(bundle.make_data(DEEPFM_GLOBAL_BATCH, seed=0))
    return [next(data) for _ in range(n)]


def deepfm_profile(trainer, state, host_batch, step_time: float, card: str) -> dict:
    """12a's profile: one traced step's device time by ``DEEPFM_GROUPS``
    (each kernel under the outermost host op that launched it, the copies
    of the batch upload by name), the largest kernels, and the busy share
    of the untraced step."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, metrics = trainer.train_step(state, host_batch)
        float(metrics["loss"])
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False)]
    device = sum(ms for _, ms, _ in kernels)
    upload = "the batch upload (host to device copies)"
    groups = dict.fromkeys([*DEEPFM_GROUPS, upload, "the rest"], 0.0)
    for e in prof.events():
        for k in e.kernels:
            root = e
            while root.cpu_parent is not None:
                root = root.cpu_parent
            group = upload if "HtoD" in k.name else next(
                (g for g, keys in DEEPFM_GROUPS.items() if any(n in root.name for n in keys)),
                "the rest")
            groups[group] += k.duration / 1e3
    if not device:
        log("12a profile: the profiler saw no device time; breakdown not measured")
        return {"groups": None, "busy": None}
    linked = sum(groups.values())
    busy = device / 1e3 / step_time
    log(f"12a profile: {device:.2f} ms of kernels in one step ({busy:.3f} of the untraced step "
        f"{step_time:.4f}s; idle share {1 - busy:.3f}) on {card}; by the host op that launched "
        f"them ({linked:.2f} ms linked): " + ", ".join(
            f"{g} {ms:.2f} ms ({ms / max(linked, 1e-9):.3f})" for g, ms in groups.items()))
    for name, ms, count in sorted(kernels, key=lambda k: -k[1])[:12]:
        log(f"  {ms:9.3f} ms  x{count:<5d} {name[:110]}")
    return {"groups": groups, "busy": busy}


def deepfm_table_gradient(model, batch: dict) -> torch.Tensor:
    """The table's gradient of one microbatch's loss, the parameters cast
    to bf16 as the trainer casts them."""
    from torch.func import functional_call

    from easydl_tpu_torch.models.deepfm import click_loss

    model.zero_grad(set_to_none=True)
    cast = {n: p.to(torch.bfloat16) for n, p in model.named_parameters()}
    logits = functional_call(model, cast, (batch["sparse_ids"], batch["dense"]))
    click_loss(logits, batch["label"])[0].backward()
    return model.embedding.table.grad.clone()


def deepfm_determinism(model, host_batch: dict) -> None:
    """12c (see the module docstring)."""
    micro = DEEPFM_GLOBAL_BATCH // DEEPFM_MICROBATCHES
    batch = {k: torch.from_numpy(v[:micro]).cuda() for k, v in host_batch.items()}
    first, second = (deepfm_table_gradient(model, batch) for _ in range(2))
    rows = int(first.ne(0).any(1).sum())
    log(f"12c the table's bf16 gradient of one microbatch of {micro} rows, twice: "
        f"{rows} rows touched, bit-equal {torch.equal(first, second)}")
    if not torch.equal(first, second):
        raise AssertionError("12c: the table's gradient differs between two calls")
    model.zero_grad(set_to_none=True)


def int64_fold(self, ids):
    """12b's planted fault: the ids folded with an int64 modulo, where the
    JAX package wraps them to int32 first."""
    import torch.nn.functional as F

    return F.embedding(ids % self.vocab, self.table)


def deepfm_card_vs_cpu(encoded: str) -> None:
    """12b (see the module docstring)."""
    from torch.func import functional_call

    from easydl_tpu_torch.data import ClickLogDataset
    from easydl_tpu_torch.models import deepfm
    from easydl_tpu_torch.models.registry import get_model

    host = next(iter(ClickLogDataset(encoded, batch_size=DEEPFM_CHECK_ROWS, loop=False)))
    failures = []
    for name in ("deepfm", "widedeep"):
        bundle = get_model(name)
        cpu = bundle.init_fn(0, "cpu")
        rows = host["sparse_ids"].astype(np.int32) % cpu.embedding.vocab  # the JAX fold
        hot = int(np.bincount(rows.ravel()).argmax())
        card = bundle.init_fn(0, "cuda")
        card.load_state_dict(cpu.state_dict())

        def readings(model, device, dtype=torch.float32):
            batch = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
            model.zero_grad(set_to_none=True)
            cast = {n: p.to(dtype) for n, p in model.named_parameters()}
            logits = functional_call(model, cast, (batch["sparse_ids"], batch["dense"]))
            deepfm.click_loss(logits, batch["label"])[0].backward()
            grads = {n: p.grad.cpu().double() for n, p in model.named_parameters()}
            return logits.detach().float().cpu().double(), grads

        def gaps(got, want) -> dict:
            (logits, grads), (want_logits, want_grads) = got, want
            flat = [torch.cat([g[n].flatten() for n in want_grads]) for g in (grads, want_grads)]
            return {"logits": ((logits - want_logits).norm() / want_logits.norm()).item(),
                    "grads": ((flat[0] - flat[1]).norm() / flat[1].norm()).item()}

        t0 = time.perf_counter()
        want = readings(cpu, "cpu")
        cpu_s = time.perf_counter() - t0
        out = {"sound": gaps(readings(card, "cuda"), want)}
        with mock.patch.object(deepfm.DeviceEmbedding, "forward", int64_fold):
            out["planted fault (int64 modulo)"] = gaps(readings(card, "cuda"), want)
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            out["cuBLAS's TF32 allowed"] = gaps(readings(card, "cuda"), want)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        # bf16 compute: the table's gradient, its hot row apart from the rest
        (_, got16), (_, want16) = readings(card, "cuda", torch.bfloat16), readings(
            cpu, "cpu", torch.bfloat16)
        table, want_table = got16["embedding.table"], want16["embedding.table"]
        rest = torch.ones(len(table), dtype=torch.bool)
        rest[hot] = False
        hot_gap = ((table[hot] - want_table[hot]).norm() / want_table[hot].norm()).item()
        rest_gap = ((table[rest] - want_table[rest]).norm() / want_table[rest].norm()).item()
        log(f"12b {name}, {DEEPFM_CHECK_ROWS} encoded rows, the card against the CPU's f32 "
            f"({cpu_s:.1f}s on the CPU), relative L2 of the logits and of the whole gradient: "
            + "; ".join(f"{n}: logits {r['logits']:.3g}, gradient {r['grads']:.3g}"
                        for n, r in out.items()) + f"; bounds {DEEPFM_CPU_REL}. At bf16 "
            f"compute, the table's gradient: the hot row {hot} ({int((rows == hot).sum())} "
            f"ids) {hot_gap:.3g}, the rest {rest_gap:.3g}")
        fault = out["planted fault (int64 modulo)"]
        for key, bound in DEEPFM_CPU_REL.items():
            if not out["sound"][key] <= bound < fault[key]:
                failures.append(f"{name} {key}: sound {out['sound'][key]:.3g}, planted fault "
                                f"{fault[key]:.3g}, bound {bound}")
        del cpu, card
    if failures:
        raise AssertionError("12b: " + "; ".join(failures))


def deepfm_file_checkpoint(encoded: str) -> None:
    """12d (see the module docstring)."""
    from easydl_tpu_torch.data import ClickLogDataset

    work = tempfile.mkdtemp(prefix="chip_smoke_deepfm_ckpt_")
    try:
        _, trainer = deepfm_trainer(global_batch=DEEPFM_FILE_BATCH, grad_accum=1)
        data = ClickLogDataset(encoded, batch_size=DEEPFM_FILE_BATCH)
        stream, state, losses = iter(data), trainer.init_state(), []
        mgr = CheckpointManager(work)
        for _ in range(4):
            state, metrics = trainer.train_step(state, next(stream))
            losses.append(float(metrics["loss"]))
            if state.step == 2:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mgr.save(state.step, trainer.state_leaves(state),
                         metadata={"data_state": data.state()})
                t_snap = time.perf_counter() - t0
                saved = state_hashes(state)
        mgr.wait()
        cursor = CheckpointManager(work).metadata(2)["metadata"]["data_state"]
        restorer = deepfm_trainer(global_batch=DEEPFM_FILE_BATCH, grad_accum=1)[1]
        t0 = time.perf_counter()
        restored = restorer.restore_from(CheckpointManager(work))
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        got = state_hashes(restored)
        differ = [k for k in saved if got.get(k) != saved[k]]
        resumed = ClickLogDataset(encoded, batch_size=DEEPFM_FILE_BATCH)
        resumed.restore_state(cursor)
        _, metrics = restorer.train_step(restored, next(iter(resumed)))
        again = float(metrics["loss"])
        nbytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(work)
                     for f in fs)
        log(f"12d deepfm on {data.batches_per_epoch} batches an epoch of {DEEPFM_FILE_BATCH} "
            f"encoded rows: losses {losses}; the checkpoint of step 2: {nbytes / 2**20:.1f} MiB, "
            f"snapshot {t_snap:.2f}s, restore {t_restore:.2f}s, cursor {cursor}; "
            f"{len(got) - 1} tensors and counts compared, {len(differ)} differ {differ[:6]}; "
            f"step 3 from the restored state and cursor: loss {again!r} (first run {losses[2]!r})")
        if differ or set(got) != set(saved):
            raise AssertionError("12d: the restored state is not the saved one")
        if cursor != {"epoch": 0, "cursor": 2, "world": 1, "batch": DEEPFM_FILE_BATCH}:
            raise AssertionError(f"12d: the manifest's cursor {cursor}")
        if again != losses[2] or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"12d: step 3's loss {again!r} after the restore, {losses[2]!r} "
                                 "before it")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def deepfm_rank_main(rank: int, work: str) -> int:
    """One of 12e's two ranks (``chip_smoke.py --deepfm-rank R WORKDIR``):
    joins a gloo group of two on cuda:0, trains ``DEEPFM_DIST_STEPS`` steps
    at fsdp 2, sound (then saves to ``WORKDIR/ckpt``) and with the planted
    fault, and rank 0 writes each run's gap to one process's parameters
    (``WORKDIR/ref.pt``) to ``WORKDIR/result.json``."""
    import faulthandler
    from datetime import timedelta

    import torch.distributed as dist
    from torch.distributed.fsdp._fully_shard import _fsdp_collectives

    from easydl_tpu_torch.core.mesh import MeshSpec, init_distributed

    class UnsummedShards:
        """The planted fault, as FSDP2's collectives see ``torch.distributed``:
        its reduce-scatter of the gradients hands each rank its own shard of
        its own gradient, not summed over the ranks."""

        def __getattr__(self, name):
            return getattr(dist, name)

        @staticmethod
        def reduce_scatter_tensor(output, input, op=None, group=None, async_op=False):
            mine = input.reshape(dist.get_world_size(group), -1)[dist.get_rank(group)]
            output.copy_(mine.view_as(output))

        reduce_scatter_single = reduce_scatter_tensor

    faulthandler.enable()
    torch.backends.cuda.matmul.allow_tf32 = False  # the tower's f32 stays f32
    torch.backends.cudnn.allow_tf32 = False
    init_distributed("cuda:0", backend="gloo", rank=rank, world_size=2,
                     store=dist.FileStore(os.path.join(work, "store"), 2),
                     timeout=timedelta(seconds=DIST_DEADLINE_S))
    ref = torch.load(os.path.join(work, "ref.pt")) if rank == 0 else None
    rows = slice(rank * DEEPFM_GLOBAL_BATCH // 2, (rank + 1) * DEEPFM_GLOBAL_BATCH // 2)
    out = {}
    for name, fault in (("fsdp 2", False),
                        ("fsdp 2, planted fault: the gradients' shards unsummed", True)):
        bundle, trainer = deepfm_trainer(device="cuda:0", mesh_spec=MeshSpec(fsdp=2))
        state = trainer.init_state()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, t0 = [], time.perf_counter()
        with mock.patch.object(_fsdp_collectives, "dist", UnsummedShards()) if fault \
                else contextlib.nullcontext():
            for batch in deepfm_batches(bundle, DEEPFM_DIST_STEPS):
                state, metrics = trainer.train_step(state, {k: v[rows] for k, v in batch.items()})
                losses.append(float(metrics["loss"]))
        seconds = time.perf_counter() - t0
        diff = norm = 0.0
        for n, p in state.model.named_parameters():
            full = whole(p)
            if rank == 0:
                want = ref[n].to(full.device)
                diff += (full - want).double().square().sum().item()
                norm += want.double().square().sum().item()
        out[name] = {"losses": losses, "seconds": seconds, "fault": fault,
                     "rel": math.sqrt(diff / norm) if norm else None,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        if not fault:
            mgr = CheckpointManager(os.path.join(work, "ckpt"))
            mgr.save(state.step, trainer.state_leaves(state))
            mgr.wait()
            out[name]["hashes"] = state_hashes(state)
        del state, trainer
        gc.collect()
        torch.cuda.empty_cache()
    if rank == 0:
        with open(os.path.join(work, "result.json"), "w") as f:
            json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def deepfm_fsdp(losses: list) -> None:
    """12e (see the module docstring): ``losses`` are 12a's, from the same
    init on the same batches."""
    work = tempfile.mkdtemp(prefix="chip_smoke_deepfm_ranks_")
    try:
        bundle, trainer = deepfm_trainer()
        state = trainer.init_state()
        for batch in deepfm_batches(bundle, DEEPFM_DIST_STEPS):
            state, _ = trainer.train_step(state, batch)
        torch.save({n: p.detach().cpu() for n, p in state.model.named_parameters()},
                   os.path.join(work, "ref.pt"))
        del state, trainer
        gc.collect()
        torch.cuda.empty_cache()
        start_ranks("--deepfm-rank", 2, work, "12e")
        with open(os.path.join(work, "result.json")) as f:
            res = json.load(f)
        failures = []
        for name, r in res.items():
            log(f"12e {name}: losses {r['losses']} (12a's {losses[:DEEPFM_DIST_STEPS]}), "
                f"{r['seconds']:.2f}s for {DEEPFM_DIST_STEPS} steps, peak mem "
                f"{r['peak_gib']:.2f} GiB (rank 0), parameters vs one process relative L2 "
                f"{r['rel']:.4g} (bound {DEEPFM_DIST_REL})")
            if r["fault"] != (r["rel"] > DEEPFM_DIST_REL):
                failures.append(f"{name}: {r['rel']:.4g} against the bound {DEEPFM_DIST_REL}")
            worst = max(abs(a - b) for a, b in zip(r["losses"], losses))
            if not r["fault"] and worst > DIST_LOSS_ABS:
                failures.append(f"{name}: losses {r['losses']} vs 12a's {losses}")
        saved = res["fsdp 2"]["hashes"]
        restorer = deepfm_trainer()[1]
        got = state_hashes(restorer.restore_from(CheckpointManager(os.path.join(work, "ckpt"))))
        differ = [k for k in saved if got.get(k) != saved[k]]
        log(f"12e the fsdp 2 ranks' save of step {saved['step']} restored in one process: "
            f"{len(got) - 1} tensors and counts compared, {len(differ)} differ {differ[:6]}")
        if differ or set(got) != set(saved):
            failures.append("the ranks' save restores to another state in one process")
        if failures:
            raise AssertionError("12e: " + "; ".join(failures))
    finally:
        shutil.rmtree(work, ignore_errors=True)


def deepfm_train(card: str, out: str) -> int:
    """12a-12e (see the module docstring), as ``chip_smoke.py --deepfm CARD
    OUT``: writes 12a's readings and launches to ``OUT``."""
    from easydl_tpu_torch.data import encode_click_tsv, write_criteo_tsv

    torch.backends.cuda.matmul.allow_tf32 = False  # the tower's f32 stays f32
    torch.backends.cudnn.allow_tf32 = False
    res = {}
    with Phase("12a (DeepFM training)"):
        bundle, trainer = deepfm_trainer()
        state = trainer.init_state()
        batches = deepfm_batches(bundle, STEPS + 1)
        losses, norms, step_s, counts, peak_gib = train_timed(trainer, state,
                                                              iter(batches[:STEPS]))
        jax_count = sum(math.prod(shape) for key, (shape, _) in
                        jax_state.leaf_shapes(state.model, bundle.jax_layout).items()
                        if key.startswith(".params"))
        step_time = statistics.mean(step_s[1:])
        log(f"12a deepfm b{DEEPFM_GLOBAL_BATCH}/a{DEEPFM_MICROBATCHES}, vocab 1,000,000 x 16, "
            f"bf16 compute cast, f32 tower: losses {losses}, grad norms {norms}, launches "
            f"{counts}; {jax_count} parameters in the JAX tree")
        log(f"12a step {step_time:.4f}s (timed steps {step_s[1:]}), "
            f"{DEEPFM_GLOBAL_BATCH / step_time:.1f} examples/s, peak mem {peak_gib:.2f} GiB, on "
            f"{card}")
        if any(counts.values()):
            raise AssertionError(f"12a launched flash kernels: {counts}")
        if jax_count != DEEPFM_PARAMS:
            raise AssertionError(f"12a: {jax_count} parameters, the JAX tree has {DEEPFM_PARAMS}")
        res.update(launches=counts, step_s=step_time, losses=losses, peak_gib=peak_gib,
                   **deepfm_profile(trainer, state, batches[STEPS], step_time, card))
    with Phase("12c (the table's gradient, twice)"):
        deepfm_determinism(state.model, batches[0])
    del state, trainer
    gc.collect()
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="chip_smoke_clicks_")
    try:
        write_criteo_tsv(os.path.join(work, "day_0.tsv"), DEEPFM_CHECK_ROWS, seed=0)
        encoded = os.path.join(work, "encoded")
        encode_click_tsv([os.path.join(work, "day_0.tsv")], encoded)
        with Phase("12b (DeepFM, the card against the CPU)"):
            deepfm_card_vs_cpu(encoded)
        gc.collect()
        torch.cuda.empty_cache()
        with Phase("12d (file data and a checkpoint round trip)"):
            deepfm_file_checkpoint(encoded)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    with Phase("12e (DeepFM at fsdp 2, two gloo ranks)"):
        deepfm_fsdp(losses)
    with open(out, "w") as f:
        json.dump(res, f)
    return 0


def deepfm_phase(card: str) -> dict:
    """Phase 12 (see the module docstring), in a process of its own; returns
    12a's launches."""
    fd, out = tempfile.mkstemp(prefix="chip_smoke_deepfm_", suffix=".json")
    os.close(fd)
    try:
        with Phase("12 (DeepFM, BASELINE config 5's model)"):
            rc = run_child(["--deepfm", card, out], DEEPFM_DEADLINE_S)
            if rc:
                raise AssertionError(f"phase 12 exited {rc}")
        with open(out) as f:
            return json.load(f)["launches"]
    finally:
        os.remove(out)


def moe_bundle(**options):
    """gpt_moe at 345M's width (``MOE_MODEL``); ``options`` go to the factory."""
    from easydl_tpu_torch.models.registry import get_model

    return get_model("gpt_moe", **{**MOE_MODEL, **options})


@contextlib.contextmanager
def shallow_345m(layers: int):
    """While open, the GPT size "345m-shallow": 345M's width, ``layers``
    layers (a cut of depth for the ranks of 7d and 13c)."""
    from easydl_tpu_torch.models import gpt

    with mock.patch.dict(gpt.SIZES, {"345m-shallow": (layers, 1024, 16)}):
        yield "345m-shallow"


def shallow_gpt(layers: int, **options):
    """``gpt345m``'s bundle (bf16, seq 1024, vocab 50304) at ``layers`` layers."""
    from easydl_tpu_torch.models.registry import get_model

    with shallow_345m(layers) as size:
        return get_model("gpt", size=size, seq_len=gpt345m.SEQ, vocab=gpt345m.VOCAB,
                         dtype="bfloat16", **options)


def moe_groups(prof, d_ff: int) -> dict:
    """13a's profile: device time by group. Each kernel goes by the op that
    launched it: the flash kernels by name; AdamW under ``Optimizer.step``;
    the routing (``ops/moe._routing``, run inside a ``moe::routing`` range)
    and the backward of its ops (linked to them by sequence number); batched
    products through ``d_ff`` (the experts') and the other batched products
    (dispatch and combine); the other products (attention's projections,
    the head, the router); the casts; the batch upload; the rest."""
    names = ["flash attention kernels", "expert products", "dispatch and combine einsums",
             "routing (elementwise, with its backward)", "other products (q/k/v/out, head, "
             "router)", "AdamW", "casts (bf16 and back)", "batch upload", "the rest"]
    groups = dict.fromkeys(names, 0.0)
    events = prof.events()
    seqs = set()
    for e in events:
        if e.name == "moe::routing":
            stack = list(e.cpu_children)
            while stack:
                c = stack.pop()
                if getattr(c, "sequence_nr", -1) >= 0:
                    seqs.add(c.sequence_nr)
                stack.extend(c.cpu_children)
    for e in events:
        chain, node = [], e
        while node is not None:
            chain.append(node)
            node = node.cpu_parent
        for k in e.kernels:
            if "flash_" in k.name:
                g = names[0]
            elif "HtoD" in k.name:
                g = names[7]
            elif chain[-1].name.startswith("Optimizer.step"):
                g = names[5]
            elif any(n.name == "moe::routing" or (
                    n.name.startswith("autograd::engine::evaluate_function")
                    and getattr(n, "sequence_nr", -1) in seqs) for n in chain):
                g = names[3]
            elif e.name == "aten::bmm":
                g = names[1] if str(d_ff) in str(e.input_shapes) else names[2]
            elif e.name in ("aten::mm", "aten::addmm"):
                g = names[4]
            elif e.name in ("aten::copy_", "aten::_to_copy"):
                g = names[6]
            else:
                g = names[8]
            groups[g] += k.duration / 1e3
    return groups


def moe_profile(trainer, state, host_batch, step_time: float, card: str) -> dict:
    """13a's profile: one traced step's device time by :func:`moe_groups`,
    the flash launches, the largest kernels and the idle share."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from easydl_tpu_torch.ops import moe

    real = moe._routing

    def ranged(*args):
        with record_function("moe::routing"):
            return real(*args)

    fa.reset_launches()
    with mock.patch.object(moe, "_routing", ranged), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
        _, metrics = trainer.train_step(state, host_batch)
        float(metrics["loss"])
    launched = dict(fa.launches)
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False)]
    device = sum(ms for _, ms, _ in kernels)
    if not device:
        log("13a profile: the profiler saw no device time; breakdown not measured")
        return {"groups": None, "busy": None}
    groups = moe_groups(prof, MOE_D_FF)
    linked = sum(groups.values())
    busy = device / 1e3 / step_time
    log(f"13a profile: {device:.1f} ms of kernels in one step ({busy:.3f} of the untraced step "
        f"{step_time:.4f}s; idle share {1 - busy:.3f}) on {card}; flash launches in it "
        f"{launched}; by group ({linked:.1f} ms linked): " + ", ".join(
            f"{g} {ms:.1f} ms ({ms / max(linked, 1e-9):.3f})" for g, ms in groups.items()))
    for name, ms, count in sorted(kernels, key=lambda k: -k[1])[:12]:
        log(f"  {ms:9.3f} ms  x{count:<5d} {name[:110]}")
    return {"groups": groups, "busy": busy}


def moe_card_vs_cpu() -> None:
    """13b (see the module docstring)."""
    from easydl_tpu_torch.ops import moe

    gen = torch.Generator().manual_seed(13)
    layer = moe.MoeMlp(1024, MOE_D_FF, 8, k=2, capacity_factor=1.25,
                       out_init_scale=(2 * MOE_LAYERS) ** -0.5)
    layer.init_weights(gen)
    x = torch.randn(MOE_CPU_ROWS, gpt345m.SEQ, 1024, generator=gen)
    w = torch.randn(MOE_CPU_ROWS, gpt345m.SEQ, 1024, generator=gen)

    def run(device):
        mod = moe.MoeMlp(1024, MOE_D_FF, 8, k=2, capacity_factor=1.25).to(device)
        mod.load_state_dict(layer.state_dict())
        xs = x.detach().clone().to(device).requires_grad_()  # a leaf on each device
        y, aux = mod(xs)
        ((y * w.to(device)).sum() + 0.01 * aux).backward()
        return {"y": y.detach().cpu(), "router": mod.router.grad.cpu(),
                "w_in": mod.w_in.grad.cpu(), "w_out": mod.w_out.grad.cpu(), "x": xs.grad.cpu()}

    cpu = run("cpu")
    sound = {k: rel_err(v, cpu[k]) for k, v in run("cuda").items()}
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        fault = {k: rel_err(v, cpu[k]) for k, v in run("cuda").items()}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():
        logits = x @ layer.router
    capacity = moe.capacity_of(gpt345m.SEQ, 8, 2, 1.25)
    d_cpu, c_cpu, _ = moe._routing(logits, 2, capacity)
    d_gpu, c_gpu, _ = moe._routing(logits.cuda(), 2, capacity)
    masks_equal = torch.equal(d_gpu.cpu(), d_cpu)
    combine_rel = rel_err(c_gpu.cpu(), c_cpu)
    log(f"13b MoE layer in f32, card vs CPU, relative L2: {sound} (bound {MOE_CPU_REL}); with "
        f"TF32 on: {fault}; the routing of the CPU's router logits: dispatch "
        f"{'bit-equal' if masks_equal else 'DIFFERENT'} ({int(d_cpu.sum())} slots filled of "
        f"{MOE_CPU_ROWS * gpt345m.SEQ * 2}), combine {combine_rel:.3g}")
    if not (max(sound.values()) <= MOE_CPU_REL < min(fault.values()) and masks_equal
            and combine_rel <= 1e-6):
        raise AssertionError("13b: the card's MoE layer is not the CPU's, or the bound does "
                             "not tell the TF32 fault apart")


def moe_rank_main(rank: int, work: str) -> int:
    """One of 13c's two ranks (``chip_smoke.py --moe-rank R WORKDIR``): joins
    a gloo group of two on cuda:0, runs ``WORKDIR/spec.json``'s runs, and
    rank 0 writes their readings to ``WORKDIR/result.json``. Rank 0 first
    takes one process's steps of each model on the same batches."""
    from datetime import timedelta

    import torch.distributed as dist

    from easydl_tpu_torch.core.mesh import MeshSpec, build_mesh, init_distributed
    from easydl_tpu_torch.core.train_loop import TrainConfig, Trainer
    from easydl_tpu_torch.models.registry import get_model
    from easydl_tpu_torch.ops import moe
    from easydl_tpu_torch.ops.sequence_parallel import make_sp_attention

    with open(os.path.join(work, "spec.json")) as f:
        runs = json.load(f)["runs"]
    init_distributed("cuda:0", backend="gloo", rank=rank, world_size=2,
                     store=dist.FileStore(os.path.join(work, "store"), 2),
                     timeout=timedelta(seconds=DIST_DEADLINE_S))
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 compute: TF32 would round it
    torch.backends.cudnn.allow_tf32 = False
    fa._lib()

    def trainer(model, mesh=None, kind=None):
        with shallow_345m(MOE_DIST_LAYERS) as size:
            options = dict(MOE_MODEL, size=size, dtype="float32") if model == "gpt_moe" else dict(
                size=size, seq_len=gpt345m.SEQ, vocab=gpt345m.VOCAB)
            if kind:
                options["attention_fn"] = make_sp_attention(mesh, kind)
            bundle = get_model(model, **options)
        return bundle, Trainer(
            init_fn=bundle.init_fn, loss_fn=bundle.loss_fn,
            optimizer=functools.partial(torch.optim.AdamW, lr=2e-4, weight_decay=0.01),
            config=TrainConfig(global_batch=MOE_DIST_BATCH, grad_accum=MOE_DIST_MICRO,
                               compute_dtype=torch.float32),
            device="cuda:0", jax_layout=bundle.jax_layout, mesh=mesh,
            param_axes=bundle.param_axes)

    batches = list(itertools.islice(moe_bundle().make_data(MOE_DIST_BATCH, seed=0),
                                    MOE_DIST_STEPS))
    refs = {}
    if rank == 0:  # one process's parameters after the same steps
        for model in ("gpt_moe", "gpt"):
            _, tr = trainer(model)
            state = tr.init_state()
            for batch in batches:
                state, _ = tr.train_step(state, batch)
            refs[model] = {n: p.detach() for n, p in state.model.named_parameters()}
            del state, tr
    dist.barrier()
    out = {}
    real_reduce, real_sum = moe.reduce_from_tp, Trainer._sum_over_sp
    for run in runs:
        mesh = build_mesh(MeshSpec(**run["mesh"]), "cuda")
        if run["fault"] == "ep":
            moe.reduce_from_tp = lambda x, group: x
        elif run["fault"] == "sp":
            Trainer._sum_over_sp = lambda self, grads: None
        try:
            _, tr = trainer(run["model"], mesh, run["kind"])
            state = tr.init_state()
            fa.reset_launches()
            losses, step_s = [], []
            for batch in batches:
                t0 = time.perf_counter()
                state, metrics = tr.train_step(state, batch)  # ep and sp ranks take every row
                losses.append(float(metrics["loss"]))
                step_s.append(time.perf_counter() - t0)
        finally:
            moe.reduce_from_tp, Trainer._sum_over_sp = real_reduce, real_sum
        res = {"losses": losses, "step_s": step_s}
        res["launches"] = [None, None]
        dist.all_gather_object(res["launches"], dict(fa.launches))
        diff = norm = 0.0
        for name, p in state.model.named_parameters():
            full = whole(p)
            if rank == 0:
                ref = refs[run["model"]][name]
                diff += (full - ref).square().sum().item()
                norm += ref.square().sum().item()
        res["rel"] = math.sqrt(diff / norm) if rank == 0 else None
        out[run["name"]] = res
        del state, tr
        gc.collect()
        torch.cuda.empty_cache()
    if rank == 0:
        with open(os.path.join(work, "result.json"), "w") as f:
            json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def moe_ranks(card: str) -> dict:
    """13c (see the module docstring). Returns the ranks' launches, summed."""
    work = tempfile.mkdtemp(prefix="chip_smoke_moe_")
    runs = [{"name": "ep 2", "mesh": {"ep": 2}, "model": "gpt_moe", "kind": None, "fault": None},
            {"name": "ep 2, planted fault", "mesh": {"ep": 2}, "model": "gpt_moe", "kind": None,
             "fault": "ep"},
            {"name": "sp 2 Ulysses", "mesh": {"sp": 2}, "model": "gpt", "kind": "ulysses",
             "fault": None},
            {"name": "sp 2 Ulysses, planted fault", "mesh": {"sp": 2}, "model": "gpt",
             "kind": "ulysses", "fault": "sp"},
            {"name": "sp 2 ring", "mesh": {"sp": 2}, "model": "gpt", "kind": "ring",
             "fault": None}]
    # the f32 flash kernels in every block, but under ring attention
    f32_attention = fa.expected_launches(f32=MOE_DIST_LAYERS * MOE_DIST_MICRO * MOE_DIST_STEPS)
    try:
        with Phase("13c (ep 2 and sp 2: two ranks over gloo)"):
            with open(os.path.join(work, "spec.json"), "w") as f:
                json.dump({"runs": runs}, f)
            start_ranks("--moe-rank", 2, work, "13c")
            with open(os.path.join(work, "result.json")) as f:
                res = json.load(f)
            total = {k: 0 for k in fa.launches}
            failures = []
            for run in runs:
                r = res[run["name"]]
                log(f"13c {run['name']}: losses {r['losses']}, step seconds {r['step_s']}, "
                    f"parameters vs one process relative L2 {r['rel']:.4g} (bound "
                    f"{MOE_DIST_REL}), flash launches by rank {r['launches']}, on {card}")
                want = fa.expected_launches() if run["kind"] == "ring" else f32_attention
                for counts in r["launches"]:
                    for k, v in counts.items():
                        total[k] += v
                    if counts != want:
                        failures.append(f"{run['name']}: launches {counts}, want {want}")
                if run["fault"] is None and not r["rel"] <= MOE_DIST_REL:
                    failures.append(f"{run['name']}: parameters {r['rel']:.4g} from one process's")
                if run["fault"] is not None and r["rel"] <= MOE_DIST_REL:
                    failures.append(f"the planted fault passes: {run['name']} {r['rel']:.4g}")
            if failures:
                raise AssertionError("13c: " + "; ".join(failures))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return total


def moe_checkpoint(bundle, trainer, state, host_batch) -> None:
    """13d (see the module docstring): ``state`` saved and restored into a
    fresh trainer, every tensor bit-equal, and the next step's loss and
    parameters the live state's. The live state goes to the host before the
    restore (two states of 13a's size do not fit the card)."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_moe_ckpt_")
    cache = os.environ.get("EASYDL_CHUNK_CACHE")
    os.environ["EASYDL_CHUNK_CACHE"] = "off"  # phase 9 covers the cache
    try:
        shapes = trainer.leaf_shapes(state)
        nbytes = sum(int(np.prod(s)) * d.itemsize for s, d in shapes.values())
        free = shutil.disk_usage(tmp).free
        if free < 1.2 * nbytes:
            raise AssertionError(f"{tmp}: {free} bytes free for the state's {nbytes}")
        opt = state.optimizer.state
        saved = {n: [t.detach().to("cpu", copy=True)
                     for t in (p, opt[p]["exp_avg"], opt[p]["exp_avg_sq"])]
                 for n, p in state.model.named_parameters()}
        mgr = CheckpointManager(tmp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(state.step, trainer.state_leaves(state))
        t_snap = time.perf_counter() - t0
        mgr.wait()
        t_io = time.perf_counter() - t0 - t_snap
        step = state.step
        _, m_live = trainer.train_step(state, host_batch)
        live_loss = float(m_live["loss"])
        after = {n: p.detach().to("cpu", copy=True) for n, p in state.model.named_parameters()}
        del state.model, state.optimizer, m_live
        gc.collect()
        torch.cuda.empty_cache()
        restorer = gpt345m.trainer(bundle)
        t0 = time.perf_counter()
        restored = restorer.restore_from(mgr)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        restored_step = restored.step
        opt = restored.optimizer.state
        differ = [n for n, p in restored.model.named_parameters()  # compared on the card
                  if not all(torch.equal(t.detach(), s.to(t.device)) for t, s in zip(
                      (p, opt[p]["exp_avg"], opt[p]["exp_avg_sq"]), saved[n]))]
        _, m_restored = restorer.train_step(restored, host_batch)
        moved = [n for n, p in restored.model.named_parameters()
                 if not torch.equal(p.detach(), after[n].to(p.device))]
        log(f"13d checkpoint of step {step}: {nbytes / 2**30:.2f} GiB of leaves; save "
            f"{t_snap:.2f}s snapshot + {t_io:.2f}s write; restore {t_restore:.2f}s; "
            f"{free / 2**30:.0f} GiB were free; tensors that differ {differ[:6]}; the next step: "
            f"loss {live_loss:.6f} live vs {float(m_restored['loss']):.6f} restored, "
            f"parameters that differ after it {moved[:6]}")
        if restored_step != step or differ or moved or live_loss != float(m_restored["loss"]):
            raise AssertionError("13d: the restored state is not the saved one, or trains on "
                                 "differently")
    finally:
        if cache is not None:
            os.environ["EASYDL_CHUNK_CACHE"] = cache
        shutil.rmtree(tmp, ignore_errors=True)


def moe_steps(bundle) -> tuple:
    """13a's steps: (bundle, trainer, state, data, moe_balance by step,
    ``train_timed``'s readings)."""
    trainer = gpt345m.trainer(bundle)
    state = trainer.init_state()
    data = iter(bundle.make_data(gpt345m.GLOBAL_BATCH, seed=0))
    balance = []
    timed = train_timed(trainer, state, data, extras={"moe_balance": balance})
    return bundle, trainer, state, data, balance, timed


def moe_train(card: str, out: str) -> int:
    """13a-13d (see the module docstring), as ``chip_smoke.py --moe CARD
    OUT``: writes 13a's and 13c's launches to ``OUT``. The kernels' library
    was built by the parent."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fa._lib()
    launches = {}
    with Phase("13a (gpt_moe at full width)"):
        remat, oom = {}, None
        try:
            bundle, trainer, state, data, balance, timed = moe_steps(moe_bundle())
        except torch.cuda.OutOfMemoryError as e:
            oom = str(e)[:160]
        if oom is not None:  # outside the handler: its traceback holds the first try's tensors
            log(f"13a does not fit without remat ({oom}); again with remat \"dots\"")
            gc.collect()
            torch.cuda.empty_cache()
            remat = gpt345m.BENCH
            bundle, trainer, state, data, balance, timed = moe_steps(moe_bundle(**remat))
        losses, norms, step_s, counts, peak_gib = timed
        n_params = sum(p.numel() for p in state.model.parameters())
        step_time = sum(step_s[1:]) / len(step_s[1:])
        tokens_per_s = gpt345m.GLOBAL_BATCH * gpt345m.SEQ / step_time
        attention = MOE_LAYERS * MICROBATCHES * STEPS
        want = fa.expected_launches(bf16=attention) if not remat else {
            **fa.expected_launches(bf16=attention), "flash_fwd": 2 * attention}
        log(f"13a {bundle.name} ({n_params:,} parameters, the bundle's count "
            f"{bundle.param_count_hint:,}), b{gpt345m.GLOBAL_BATCH}/a{MICROBATCHES} seq "
            f"{gpt345m.SEQ} bf16{', remat dots' if remat else ''}: losses {losses}, grad norms "
            f"{norms}, moe_balance {balance}, launches {counts}")
        log(f"13a step {step_time:.4f}s (timed steps {step_s[1:]}), {tokens_per_s:.0f} tokens/s, "
            f"peak mem {peak_gib:.2f} GiB, on {card}")
        if abs(losses[0] - math.log(gpt345m.VOCAB)) > 1.0:
            raise AssertionError(f"13a first loss {losses[0]} far from ln(vocab)")
        if counts != want:
            raise AssertionError(f"13a launches {counts}, want {want}")
        if not all(0.5 < b <= MOE_MODEL["moe_experts"] for b in balance):
            raise AssertionError(f"13a moe_balance {balance} outside (0.5, experts]")
        launches["13a"] = counts
        moe_profile(trainer, state, next(data), step_time, card)
    with Phase("13b (an MoE layer, card vs CPU)"):
        moe_card_vs_cpu()
    del state, trainer
    gc.collect()
    torch.cuda.empty_cache()
    with Phase(f"13d (checkpoint of 13a's model at {MOE_CKPT_LAYERS} layers)"):
        with shallow_345m(MOE_CKPT_LAYERS) as size:
            bundle = moe_bundle(size=size)
        trainer = gpt345m.trainer(bundle)
        state = trainer.init_state()
        data = iter(bundle.make_data(gpt345m.GLOBAL_BATCH, seed=0))
        trainer.train_step(state, next(data))
        moe_checkpoint(bundle, trainer, state, next(data))
    del state, trainer
    gc.collect()
    torch.cuda.empty_cache()
    launches["13c"] = moe_ranks(card)
    with open(out, "w") as f:
        json.dump({"launches": launches}, f)
    return 0


def moe_phase(card: str) -> dict:
    """Phase 13 (see the module docstring), in a process of its own;
    returns 13a's and 13c's launches."""
    fd, out = tempfile.mkstemp(prefix="chip_smoke_moe_", suffix=".json")
    os.close(fd)
    try:
        with Phase("13 (gpt_moe, ep and sp)"):
            rc = run_child(["--moe", card, out], MOE_DEADLINE_S)
            if rc:
                raise AssertionError(f"phase 13 exited {rc}")
        with open(out) as f:
            return json.load(f)["launches"]
    finally:
        os.remove(out)


# ------------------------------------------------------------------ phase 14
def ps_pods(workdir: str, log_path: str, shards: int = PS_SHARDS, env: dict = None) -> list:
    """``shards`` of the port's PS pods (``python -m easydl_tpu_torch.ps``,
    WAL on, the pod default) serving under ``workdir``, their output in
    ``log_path``, ``env`` added to their environment; returns them once the
    registry lists every shard."""
    from easydl_tpu_torch.ps import registry

    os.makedirs(workdir, exist_ok=True)
    with open(log_path, "ab") as log_file:
        pods = [subprocess.Popen([sys.executable, "-m", "easydl_tpu_torch.ps", "--name",
                                  f"ps-{i}", "--workdir", workdir, "--num-shards", str(shards),
                                  "--shard-index", str(i)],
                                 cwd=os.path.dirname(os.path.abspath(__file__)),
                                 env=None if env is None else {**os.environ, **env},
                                 stdout=log_file, stderr=subprocess.STDOUT)
                for i in range(shards)]
    try:
        registry.discover(workdir, timeout=PS_POD_START_S)
    except TimeoutError:
        stop_pods(pods)
        with open(log_path) as f:
            print(f"--- the PS pods:\n{f.read()[-4000:]}", file=sys.stderr)
        raise
    return pods


def stop_pods(pods: list) -> None:
    for p in pods:
        if p.poll() is None:
            p.terminate()
    for p in pods:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def pod_stores(log_path: str) -> dict:
    """Which store each shard's tables run on, from the pods' log: shard ->
    {"native", "numpy"}."""
    with open(log_path) as f:
        found = re.findall(r"ps shard (\d+): table '[^']*' on the (\w+) store", f.read())
    stores = {}
    for shard, store in found:
        stores.setdefault(int(shard), set()).add(store)
    return stores


def ps_trainer(client, device="cuda", dtype=torch.bfloat16, table: dict = PS_TABLE,
               init: dict = None, optimizer=None, **options):
    """Phase 14's bundle and ``PsTrainer``: deepfm at the JAX defaults with
    ``embedding="ps"``, phase 12's AdamW over the dense part (or
    ``optimizer``), ``table`` on ``client``; ``init`` (a state dict)
    replaces the seed-0 weights."""
    from easydl_tpu_torch.core.train_loop import TrainConfig
    from easydl_tpu_torch.models.registry import get_model
    from easydl_tpu_torch.models.run import ADAMW_WEIGHT_DECAY
    from easydl_tpu_torch.ps.table import TableSpec
    from easydl_tpu_torch.ps.trainer import PsTrainer

    bundle = get_model("deepfm", embedding="ps")

    def init_fn(seed, dev):
        module = bundle.init_fn(seed, dev)
        if init is not None:
            module.load_state_dict(init)
        return module

    return bundle, PsTrainer(
        init_fn=init_fn, loss_fn=bundle.loss_fn,
        optimizer=optimizer or functools.partial(torch.optim.AdamW, lr=DEEPFM_LR,
                                                 weight_decay=ADAMW_WEIGHT_DECAY),
        config=TrainConfig(global_batch=DEEPFM_GLOBAL_BATCH, compute_dtype=dtype),
        client=client, table=TableSpec(**table), device=device,
        jax_layout=bundle.jax_layout, param_axes=bundle.param_axes, **options)


def worker_ps_trainer(job: dict, client, table, device="cuda"):
    """The bundle and the ``PsTrainer`` the elastic worker builds for the PS
    job ``job`` at one device (``torch.optim.Adam``, the JAX worker's
    ``optax.adam``), on ``client`` with the table ``table``."""
    from easydl_tpu_torch.core.train_loop import TrainConfig
    from easydl_tpu_torch.models.registry import get_model
    from easydl_tpu_torch.ps.trainer import PsTrainer

    bundle = get_model(job["model"], **job["model_kwargs"])
    return bundle, PsTrainer(
        init_fn=bundle.init_fn, loss_fn=bundle.loss_fn,
        optimizer=functools.partial(torch.optim.Adam, lr=job["lr"]),
        config=TrainConfig(global_batch=job["global_batch"], seed=job["seed"]),
        client=client, table=table, device=device, jax_layout=bundle.jax_layout)


def ps_profile(trainer, state, host_batch, step_time: float) -> float | None:
    """The busy share of a strict step (one traced step's device time over
    the untraced step), or None where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, metrics = trainer.train_step(state, host_batch)
        float(metrics["loss"])
    device = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)) / 1e3
    return device / 1e3 / step_time if device else None


def ps_training(card: str, work: str) -> dict:
    """14a (see the module docstring)."""
    from easydl_tpu_torch.ps.client import ShardedPsClient

    log_path = os.path.join(work, "pods.log")
    pods = ps_pods(work, log_path)
    client = ShardedPsClient.from_registry(work, PS_SHARDS, wait_s=30)
    try:
        bundle, trainer = ps_trainer(client, push_queue_depth=PS_QUEUE)
        data = iter(bundle.make_data(DEEPFM_GLOBAL_BATCH, seed=0))
        batches = [next(data) for _ in range(PS_WARMUP + 2 * PS_STEPS + 1)]
        ids = batches[0]["sparse_ids"]
        uniq = len(np.unique(ids))
        state = trainer.init_state()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        losses, step_s, times = [], [], []
        for i, batch in enumerate(batches[:PS_WARMUP + PS_STEPS]):
            t0 = time.perf_counter()
            state, m = trainer.train_step(state, batch)
            losses.append(float(m["loss"]))
            if i >= PS_WARMUP:
                step_s.append(time.perf_counter() - t0)
                times.append(dict(trainer.times))
        strict = statistics.mean(step_s)
        parts = {k: statistics.mean(t[k] for t in times) for k in times[0]}
        # one more than it steps: the prefetch draws the next batch ahead
        rest = batches[PS_WARMUP + PS_STEPS:]
        seen = []
        t0 = time.perf_counter()
        state, m = trainer.train_steps(state, iter(rest), PS_STEPS,
                                       on_metrics=lambda m: seen.append(float(m["loss"])))
        pipelined = (time.perf_counter() - t0) / PS_STEPS
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        busy = ps_profile(trainer, state, batches[-1], strict)
        counts = dict(fa.launches)
        rows = {st.shard_index: sum(t.rows for t in st.tables if t.name == PS_TABLE["name"])
                for st in client.stats()}
        stores = pod_stores(log_path)
    finally:
        client.close()
        stop_pods(pods)
    wire = uniq * PS_TABLE["dim"] * 4
    log(f"14a deepfm (PS mode) b{DEEPFM_GLOBAL_BATCH}/a1, vocab 1,000,000 x 16 on "
        f"{PS_SHARDS} PS pods (WAL on), bf16 compute cast, the rows f32: losses {losses}, "
        f"pipelined {seen}, launches {counts}")
    log(f"14a a step's ids: {ids.size} ({uniq} distinct): the rows uploaded and their "
        f"gradient downloaded, {ids.size * PS_TABLE['dim'] * 4 / 1e6:.2f} MB each way on the "
        f"card; {wire / 1e6:.2f} MB of f32 rows each way on the wire")
    log(f"14a strict step (pull -> step -> push) {strict:.4f}s ({step_s}), "
        f"{DEEPFM_GLOBAL_BATCH / strict:.1f} examples/s: pull {parts['pull']:.2f} ms, upload "
        f"{parts['upload']:.3f} ms, download {parts['download']:.3f} ms, push "
        f"{parts['push']:.2f} ms; pipelined (queue depth {PS_QUEUE}) {pipelined:.4f}s, "
        f"{DEEPFM_GLOBAL_BATCH / pipelined:.1f} examples/s; the card's idle share of a strict "
        f"step {'not measured' if busy is None else f'{1 - busy:.3f}'}; peak mem "
        f"{peak_gib:.3f} GiB; rows by shard {rows}; stores by shard {stores}; on {card}")
    failures = []
    if not all(math.isfinite(x) for x in losses + seen):
        failures.append(f"non-finite losses {losses} {seen}")
    if any(counts.values()):
        failures.append(f"flash kernels launched: {counts}")
    if stores != {i: {"native"} for i in range(PS_SHARDS)}:
        failures.append(f"the shards' stores {stores}: each must run the native store")
    if sorted(rows) != list(range(PS_SHARDS)) or not all(rows.values()):
        failures.append(f"rows by shard {rows}")
    if failures:
        raise AssertionError("14a: " + "; ".join(failures))
    return {"launches": counts, "strict_s": strict, "pipelined_s": pipelined, "parts": parts,
            "busy": busy, "peak_gib": peak_gib, "rows": rows, "losses": losses}


def ps_moved(client) -> tuple:
    """(ids, rows) of every row of ``client``'s table, sorted by id, as moved
    from their init (``init_rows``, the store's lazy init)."""
    from easydl_tpu_torch.ps.table import init_rows

    ids, rows = zip(*(s.table(PS_CHECK_TABLE["name"]).export_rows() for s in client.shards))
    ids, rows = np.concatenate(ids), np.concatenate(rows)
    order = np.argsort(ids)
    ids, rows = ids[order], rows[order]
    dim = PS_CHECK_TABLE["dim"]
    return ids, rows - init_rows(ids, dim, dim, 0, 0.01)


def ps_check_run(device, batches, init, optimizer, push_scale: float = 1.0) -> tuple:
    """14b's run: PS_CHECK_STEPS strict f32 steps on a fresh in-process
    cluster, ``optimizer`` over the dense part; (the dense parameters'
    movement from ``init`` and the touched rows' from theirs, on the host)."""
    from easydl_tpu_torch.ps.client import LocalPsClient

    client = LocalPsClient(PS_SHARDS, backend="native")
    _, trainer = ps_trainer(client, device=device, dtype=torch.float32, table=PS_CHECK_TABLE,
                            init=init, push_scale=push_scale, optimizer=optimizer)
    state = trainer.init_state()
    for batch in batches:
        state, _ = trainer.train_step(state, batch)
    dense = torch.cat([(p.detach().cpu() - init[n]).flatten()
                       for n, p in sorted(state.model.named_parameters())])
    return dense.numpy(), ps_moved(client)


def ps_card_vs_cpu() -> None:
    """14b (see the module docstring)."""
    from easydl_tpu_torch.models.registry import get_model

    bundle = get_model("deepfm", embedding="ps")
    init = bundle.init_fn(0, "cpu").state_dict()
    data = iter(bundle.make_data(DEEPFM_GLOBAL_BATCH, seed=1))
    batches = [next(data) for _ in range(PS_CHECK_STEPS)]
    sgd = functools.partial(torch.optim.SGD, lr=DEEPFM_LR)
    runs = {key: ps_check_run(device, batches, init, opt, scale) for key, device, opt, scale in (
        ("card", "cuda", sgd, 1.0), ("cpu", "cpu", sgd, 1.0), ("fault", "cuda", sgd, 2.0),
        ("card adamw", "cuda", None, 1.0), ("cpu adamw", "cpu", None, 1.0))}

    def rel(key, of=0, want="cpu"):
        got, ref = runs[key][of], runs[want][of]
        if of:  # the rows: (ids, movement)
            if not np.array_equal(got[0], ref[0]):
                raise AssertionError(f"14b: the {key} run touched other rows than the CPU's")
            got, ref = got[1], ref[1]
        return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))

    dense, rows, fault = rel("card"), rel("card", 1), rel("fault", 1)
    adamw = (rel("card adamw", 0, "cpu adamw"), rel("card adamw", 1, "cpu adamw"))
    log(f"14b {PS_CHECK_STEPS} strict f32 steps from the same weights, each side on a fresh "
        f"LocalPsClient({PS_SHARDS}, native), SGD over the dense part and the table: the "
        f"card against the CPU in relative L2, the dense parameters' movement {dense:.3g}, "
        f"the {len(runs['cpu'][1][0])} touched rows' movement {rows:.3g}; the rows' gradient "
        f"pushed at scale 2 (a planted fault) {fault:.3g}; bounds {PS_CHECK_REL}; with "
        f"phase 12's AdamW over the dense part (not held) {adamw[0]:.3g} and {adamw[1]:.3g}")
    failures = []
    if not dense <= PS_CHECK_REL["dense"]:
        failures.append(f"dense parameters {dense:.3g} > {PS_CHECK_REL['dense']}")
    if not rows <= PS_CHECK_REL["rows"]:
        failures.append(f"rows {rows:.3g} > {PS_CHECK_REL['rows']}")
    if not fault > PS_CHECK_REL["rows"]:
        failures.append(f"the planted fault {fault:.3g} is inside the rows' bound")
    if failures:
        raise AssertionError("14b: " + "; ".join(failures))


def ps_worker(card: str, work: str, counts_dir: str, standbys: list) -> dict:
    """14c (see the module docstring), generation 1 the warm standby in
    ``standbys`` (``instrumented_worker.start_gated``'s (process, gate
    file)), started in ``work`` with ``counts_dir`` before 14a; appends
    generation 2's. Returns the workers' launches, summed over both
    generations."""
    from easydl_tpu_torch.ps.client import LocalPsClient, ShardedPsClient
    from easydl_tpu_torch.ps.server import PsShard

    log_path = os.path.join(work, "pods.log")
    with open(os.path.join(work, "job.json"), "w") as f:
        json.dump(PS_JOB, f)
    pods = ps_pods(work, log_path)
    try:
        for gen in (1, 2):
            proc, warm_file = standbys[-1]
            iw.promote(warm_file, iw.generation_env(work, gen=gen,
                                                    coord=f"localhost:{iw.free_port()}"))
            if gen == 1:  # generation 2's standby imports while generation 1 trains
                await_state(lambda: read_jsonl(os.path.join(work, "metrics-a0.jsonl")),
                            "generation 1's first step", PS_GEN_DEADLINE_S, work)
                standbys.append(iw.start_gated(counts_dir, work, "warm"))
            iw.await_generation([proc], work, gen=gen, deadline_s=PS_GEN_DEADLINE_S,
                                quiesce_at=PS_QUIESCE_AT if gen == 1 else None)
        records = read_jsonl(os.path.join(work, "metrics-a0.jsonl"))
        by_gen = {g: [r for r in records if r["generation"] == g] for g in (1, 2)}
        q, total = by_gen[1][-1]["step"], PS_JOB["total_steps"]
        ckpt = os.path.join(work, "ps-ckpt")
        ps_steps = PsShard.saved_steps(ckpt)
        states = {g: read_jsonl(os.path.join(counts_dir, f"states-g{g}.jsonl")) for g in (1, 2)}
        saved = [h for h in states[1] if h["kind"] == "saved" and h["step"] == q]
        restored = [h for h in states[2] if h["kind"] == "restored"]
        launches = {}
        for g in (1, 2):
            with open(os.path.join(counts_dir, f"launches-g{g}-a0-l0.json")) as f:
                launches[g] = json.load(f)
        with open(os.path.join(work, "worker-a0.log")) as f:
            worker_log = f.read()
        # generation 2's first loss in this process: the dense state and the
        # tier's snapshot at step q, and the worker's first batch
        snap = LocalPsClient(PS_SHARDS, backend="native")
        snap.restore(ckpt, step=q)
        # the worker's table as the pods hold it (its floats came over the wire)
        table = snap.shards[0].table(PS_JOB["ps_table"]).spec
        bundle, trainer = worker_ps_trainer(PS_JOB, snap, table)
        state = trainer.restore_from(CheckpointManager(os.path.join(work, "ckpt")), q)
        first = next(iter(bundle.make_data(PS_JOB["global_batch"], seed=PS_JOB["seed"])))
        _, m = trainer.train_step(state, first)
        in_process = float(m["loss"])
        del state, trainer
        # the rows the pods hold at the end: the final snapshot's, bit for bit
        final = LocalPsClient(PS_SHARDS, backend="native")
        final.restore(ckpt, step=total)
        ids = np.concatenate([s.table(table.name).export_rows()[0] for s in final.shards])
        live = ShardedPsClient.from_registry(work, PS_SHARDS, wait_s=30)
        try:
            equal = np.array_equal(live.pull(table.name, ids), final.pull(table.name, ids))
        finally:
            live.close()
        stores = pod_stores(log_path)
    finally:
        stop_pods(pods)
    log(f"14c worker in PS mode: quiesced at step {q} (SIGUSR1 at step {PS_QUIESCE_AT}), "
        f"generation 2 restored the dense state and the tier and trained steps "
        f"{by_gen[2][0]['step']}-{by_gen[2][-1]['step']}; losses "
        f"{[r['loss'] for r in records]}; generation 2's first loss {by_gen[2][0]['loss']!r}, "
        f"in process from step {q}'s checkpoint and ps-ckpt {in_process!r}; ps-ckpt steps "
        f"{ps_steps}; the pods' {len(ids)} rows at the end bit-equal to the step-{total} "
        f"ps-ckpt: {equal}; stores by shard {stores}; step times "
        f"{[round(r['step_time_s'], 4) for r in records]}; on {card}")
    failures = []
    if [r["step"] for r in records] != list(range(1, total + 1)):
        failures.append(f"steps {[r['step'] for r in records]}: work lost or repeated")
    if by_gen[2][0]["step"] != q + 1 or not {q, total} <= set(ps_steps):
        failures.append(f"generation 2 starts at {by_gen[2][0]['step']}; ps-ckpt {ps_steps}")
    if not (saved and [h["step"] for h in restored] == [q]
            and iw.hashed_state(restored[0]) == iw.hashed_state(saved[0])):
        failures.append(f"the dense state restored at step {q} is not the one saved")
    if f"ps tier restored to step {q}" not in worker_log:
        failures.append(f"generation 2 did not restore the tier to step {q}")
    if by_gen[2][0]["loss"] != in_process:
        failures.append(f"generation 2's first loss {by_gen[2][0]['loss']!r}, in process "
                        f"{in_process!r}")
    if not equal:
        failures.append(f"the pods' rows at the end are not the step-{total} ps-ckpt's")
    if stores != {i: {"native"} for i in range(PS_SHARDS)}:
        failures.append(f"the shards' stores {stores}")
    if failures:
        raise AssertionError("14c: " + "; ".join(failures))
    return {k: launches[1][k] + launches[2][k] for k in launches[1]}


def ps_train(card: str, out: str) -> int:
    """14a-14c (see the module docstring), as ``chip_smoke.py --ps CARD OUT``:
    writes the phase's launches and 14a's readings to ``OUT``."""
    torch.backends.cuda.matmul.allow_tf32 = False  # the tower's f32 stays f32
    torch.backends.cudnn.allow_tf32 = False
    work = tempfile.mkdtemp(prefix="chip_smoke_ps_")
    work_c, counts_dir = os.path.join(work, "c"), os.path.join(work, "c", "counts")
    os.makedirs(counts_dir)
    # 14c's first generation, a warm standby that imports while 14a-14b run
    standbys = [iw.start_gated(counts_dir, work_c, "warm")]
    try:
        with Phase("14a (DeepFM on two PS pods)"):
            res = ps_training(card, os.path.join(work, "a"))
        gc.collect()
        torch.cuda.empty_cache()
        with Phase("14b (PS mode, the card against the CPU)"):
            ps_card_vs_cpu()
        gc.collect()
        torch.cuda.empty_cache()
        with Phase("14c (the worker's PS mode, two generations)"):
            worker = ps_worker(card, work_c, counts_dir, standbys)
    finally:
        for proc, _ in standbys:  # each in its own process group
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        shutil.rmtree(work, ignore_errors=True)
    res["launches"] = {k: res["launches"][k] + worker[k] for k in worker}
    with open(out, "w") as f:
        json.dump(res, f)
    return 0


def ps_phase(card: str) -> dict:
    """Phase 14 (see the module docstring), in a process of its own; returns
    its launches and 14a's readings."""
    fd, out = tempfile.mkstemp(prefix="chip_smoke_ps_", suffix=".json")
    os.close(fd)
    try:
        with Phase("14 (the parameter-server path, BASELINE config 5)"):
            rc = run_child(["--ps", card, out], PS_DEADLINE_S)
            if rc:
                raise AssertionError(f"phase 14 exited {rc}")
        with open(out) as f:
            return json.load(f)
    finally:
        os.remove(out)


# ------------------------------------------------------------------ phase 15
def serve_requests(n: int, seed: int) -> list:
    """``n`` requests of SERVE_ROWS rows: (ids, dense), ids Zipf(SERVE_ZIPF)
    folded into SERVE_VOCAB, as ``scripts/bench_serve.py`` draws them."""
    rng = np.random.default_rng(seed)
    return [((rng.zipf(SERVE_ZIPF, SERVE_ROWS * SERVE_FIELDS) % SERVE_VOCAB)
             .astype(np.int64).reshape(SERVE_ROWS, SERVE_FIELDS),
             rng.standard_normal((SERVE_ROWS, SERVE_DENSE)).astype(np.float32))
            for _ in range(n)]


def serve_params(seed: int, perturb: float = 0.0) -> dict:
    """A DeepFM tower's params at phase 15's widths in the JAX layout (the
    flax ``DeepFMDense`` tree of numpy arrays): the port's init from
    ``seed``, the wide kernel drawn too (it is zero at init, which would
    leave the embeddings only FM's term), then, where ``perturb`` is set,
    the tower's kernels scaled by ``1 + perturb * N(0, 1)`` elementwise
    (v2 and v3 of 15d: v1's tower perturbed)."""
    from easydl_tpu_torch import convert
    from easydl_tpu_torch.models.deepfm import DeepFMConfig, DeepFMDense

    model = DeepFMDense(DeepFMConfig(num_sparse=SERVE_FIELDS, dim=SERVE_DIM,
                                     num_dense=SERVE_DENSE, hidden=SERVE_HIDDEN))
    model.init_weights(torch.Generator().manual_seed(seed))
    tree = convert.deepfm_params_to_jax(
        {f"dense.{k}": v for k, v in model.state_dict().items()})["dense"]
    rng = np.random.default_rng(seed)
    tree["wide"]["kernel"] = (0.05 * rng.standard_normal(tree["wide"]["kernel"].shape)
                              ).astype(np.float32)
    if perturb:
        for name, leaf in tree.items():
            if name.startswith("deep_"):
                leaf["kernel"] = (leaf["kernel"] * (
                    1 + perturb * rng.standard_normal(leaf["kernel"].shape))).astype(np.float32)
    return tree


def serve_forward(params=None, device="cuda"):
    """``serve.frontend.make_deepfm_forward`` at phase 15's widths."""
    from easydl_tpu_torch.serve.frontend import make_deepfm_forward

    return make_deepfm_forward(SERVE_FIELDS, SERVE_DIM, SERVE_DENSE, hidden=SERVE_HIDDEN,
                               max_batch=SERVE_MAX_BATCH, params=params, device=device)


def flat_params(tree: dict) -> dict:
    """A params tree as ``publish_version``'s payload: ``layer.leaf`` -> array."""
    return {f"{layer}.{leaf}": a for layer, leaves in tree.items() for leaf, a in leaves.items()}


def tree_params(arrays: dict) -> dict:
    """Inverse of :func:`flat_params`: published arrays back into the tree."""
    tree = {}
    for key, a in arrays.items():
        layer, leaf = key.split(".")
        tree.setdefault(layer, {})[leaf] = a
    return tree


class TimedForward:
    """A replica's forward, timed with CUDA events (upload and download
    included) and the host clock; counts the rows of each call."""

    def __init__(self, forward):
        self.forward = forward
        self.reset()

    def reset(self):
        self.ms, self.host_ms, self.rows = [], [], []

    def __call__(self, emb, dense):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = self.forward(emb, dense)
        end.record()
        end.synchronize()
        self.host_ms.append((time.perf_counter() - t0) * 1e3)
        self.ms.append(start.elapsed_time(end))
        self.rows.append(len(emb))
        return out


class TimedReads:
    """A replica's read client with each batch's pull timed on the host."""

    def __init__(self, reads):
        self.reads = reads
        self.cache = reads.cache
        self.ms = []

    def pull(self, table, ids):
        t0 = time.perf_counter()
        out = self.reads.pull(table, ids)
        self.ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def __getattr__(self, name):
        return getattr(self.reads, name)


def serve_scorer(card_line: str, writer, requests: list, params: dict) -> None:
    """15a (see the module docstring)."""
    card, cpu = serve_forward(params), serve_forward(params, device="cpu")
    ids = np.concatenate([r[0] for r in requests])
    dense = np.concatenate([r[1] for r in requests])
    emb = writer.pull(PS_TABLE["name"], ids[:max(SERVE_CHECK_ROWS)])
    sound, rounded = {}, {}
    for n in SERVE_CHECK_ROWS:
        got, want = card(emb[:n], dense[:n]), cpu(emb[:n], dense[:n])
        if got.shape != (n,) or got.dtype != np.float32 or not np.isfinite(got).all():
            raise AssertionError(f"15a: {n} rows scored {got.shape} {got.dtype}, finite "
                                 f"{np.isfinite(got).all()}")
        sound[n] = rel_err(torch.from_numpy(got), torch.from_numpy(want))
        tf32 = cpu(tf32_round(torch.from_numpy(emb[:n])).numpy(), dense[:n])
        rounded[n] = rel_err(torch.from_numpy(tf32), torch.from_numpy(want))
    log(f"15a DeepFM's tower at config 5's widths ({SERVE_FIELDS} fields x {SERVE_DIM}, "
        f"{SERVE_DENSE} dense, tower {SERVE_HIDDEN}), f32, params in the JAX layout: the card "
        f"against the CPU on the same pulled rows, relative L2 by rows {sound}; the CPU on the "
        f"rows rounded to TF32 {rounded}; bound SERVE_CPU_REL {SERVE_CPU_REL:g}; on {card_line}")
    if max(sound.values()) > SERVE_CPU_REL or min(rounded.values()) <= SERVE_CPU_REL:
        raise AssertionError(f"15a: the card's scores {sound} and the TF32 reading {rounded} "
                             f"against the bound {SERVE_CPU_REL:g}")


def drive(router, requests: list, threads: int) -> tuple:
    """Closed loop: ``threads`` clients take the next request until all are
    sent; returns (latencies in s, results, wall seconds)."""
    import threading

    nxt = itertools.count()
    lat, results = [None] * len(requests), [None] * len(requests)

    def client():
        while (i := next(nxt)) < len(requests):
            t0 = time.perf_counter()
            results[i] = router.infer(*requests[i])
            lat[i] = time.perf_counter() - t0

    workers = [threading.Thread(target=client) for _ in range(threads)]
    t0 = time.perf_counter()
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    return lat, results, time.perf_counter() - t0


def idle_share(router, requests: list) -> tuple:
    """(1 - the card's busy time over the wall time, the busy seconds) of a
    window that serves ``requests`` through ``router``; (None, 0) where the
    profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, wall = drive(router, requests, SERVE_THREADS)
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)) / 1e6
    return (1 - busy / wall if busy else None), busy


def serve_load(card_line: str, work: str, requests: list, params: dict, frontends: list,
               servers: list) -> np.ndarray:
    """15b (see the module docstring): appends its two replicas to
    ``frontends`` and their gRPC servers to ``servers``; returns the
    traffic's SERVE_HOT_IDS hottest ids."""
    from easydl_tpu_torch.ps.client import ShardedPsClient
    from easydl_tpu_torch.ps.read_client import PsReadClient
    from easydl_tpu_torch.serve import HotIdCache, ServeConfig, ServeFrontend, ServeRouter

    forwards = []
    for i in range(2):
        reads = TimedReads(PsReadClient(ShardedPsClient.from_registry(work, PS_SHARDS, wait_s=30),
                                        cache=HotIdCache(SERVE_CACHE_BYTES)))
        forwards.append(TimedForward(serve_forward(params)))
        frontends.append(ServeFrontend(
            reads, ServeConfig(table=PS_TABLE["name"], fields=SERVE_FIELDS,
                               dense_dim=SERVE_DENSE, max_batch=SERVE_MAX_BATCH,
                               max_wait_ms=SERVE_MAX_WAIT_MS),
            forward=forwards[-1], name=f"serve-{i}"))
        servers.append(frontends[-1].serve(port=0))
    router = ServeRouter(addresses={fe.name: sv.address for fe, sv in zip(frontends, servers)})
    warm, timed = requests[:SERVE_WARMUP], requests[SERVE_WARMUP:SERVE_WARMUP + SERVE_REQUESTS]
    profiled = requests[SERVE_WARMUP + SERVE_REQUESTS:]
    try:
        drive(router, warm, SERVE_THREADS)
        for fe, fwd in zip(frontends, forwards):
            fwd.reset()
            fe.reads.ms.clear()
        before = [fe.reads.cache.stats() for fe in frontends]
        counters = dict(router.counters)
        lat, results, wall = drive(router, timed, SERVE_THREADS)
        after = [fe.reads.cache.stats() for fe in frontends]
        routed = {k: router.counters[k] - counters[k] for k in counters}
        fwd_ms = [m for f in forwards for m in f.ms]
        host_ms = [m for f in forwards for m in f.host_ms]
        pull_ms = [m for fe in frontends for m in fe.reads.ms]
        rows = [sum(f.rows) for f in forwards]
        batches = sum(len(f.rows) for f in forwards)
        hits = sum(a["hits"] - b["hits"] for a, b in zip(after, before))
        misses = sum(a["misses"] - b["misses"] for a, b in zip(after, before))
        profiled_from = sum(len(f.rows) for f in forwards)
        idle, busy = idle_share(router, profiled)
        profiled_batches = sum(len(f.rows) for f in forwards) - profiled_from
    finally:
        router.stop()
    shed = sum(1 for r in results if not r.ok and r.retriable)
    hard = [r.verdict for r in results if not r.ok and not r.retriable]
    ms = sorted(x * 1e3 for x in lat)
    p50, p99 = ms[len(ms) // 2], ms[min(len(ms) - 1, int(0.99 * len(ms)))]
    log(f"15b {len(timed)} requests of {SERVE_ROWS} rows x {SERVE_FIELDS} ids (Zipf "
        f"{SERVE_ZIPF} over {SERVE_VOCAB:,}) and {SERVE_DENSE} dense features, "
        f"{SERVE_THREADS} closed-loop clients, the port's ServeRouter over 2 ServeFrontends "
        f"(gRPC, HotIdCache {SERVE_CACHE_BYTES >> 20} MB each, max_batch {SERVE_MAX_BATCH}, "
        f"max_wait {SERVE_MAX_WAIT_MS} ms) on {PS_SHARDS} PS pods: p50 {p50:.3f} ms, p99 "
        f"{p99:.3f} ms; fleet {len(timed) / wall:.1f} QPS over {wall:.3f} s, by replica "
        f"{[round(r / SERVE_ROWS / wall, 1) for r in rows]} QPS (hedges included); shed "
        f"{shed}, hard errors {len(hard)}; router {routed}")
    log(f"15b {batches} batches, mean {sum(rows) / batches:.1f} rows; a batch's pull "
        f"{statistics.mean(pull_ms):.3f} ms (median {statistics.median(pull_ms):.3f}), its "
        f"forward {statistics.mean(fwd_ms):.3f} ms by CUDA events (median "
        f"{statistics.median(fwd_ms):.3f}; host {statistics.mean(host_ms):.3f}), upload and "
        f"download included; cache hit ratio {hits / (hits + misses):.4f} ({hits:.0f} of "
        f"{hits + misses:.0f} ids); the card's idle share over {len(profiled)} profiled "
        f"requests ({profiled_batches} batches) "
        f"{'not measured' if idle is None else f'{idle:.4f}'}, its busy time a batch "
        f"{busy * 1e3 / max(profiled_batches, 1):.4f} ms; on {card_line}")
    if hard:
        raise AssertionError(f"15b: {len(hard)} hard errors, e.g. {hard[:3]}")
    if not all(np.isfinite(r.scores).all() and r.scores.shape == (SERVE_ROWS,)
               for r in results if r.ok):
        raise AssertionError("15b: scores not finite or of the wrong shape")
    ids, counts = np.unique(np.concatenate([r[0] for r in requests]), return_counts=True)
    return ids[np.argsort(-counts, kind="stable")[:SERVE_HOT_IDS]]


def serve_freshness(reads, writer, hot: np.ndarray) -> None:
    """15c (see the module docstring): ``scripts/bench_serve.py``'s
    ``stale_check`` on a 15b replica's read client."""
    table = PS_TABLE["name"]
    rng = np.random.default_rng(5)
    before = reads.pull(table, hot)
    slots, _, _ = reads.cache.lookup(table, hot)
    mismatches, moved = 0, 0
    for _ in range(SERVE_PUSHES):
        writer.push(table, hot, rng.standard_normal((len(hot), PS_TABLE["dim"]))
                    .astype(np.float32), scale=0.5)  # returns once acknowledged
        via_cache, direct = reads.pull(table, hot), writer.pull(table, hot)
        mismatches += not np.array_equal(via_cache, direct)
        moved += not np.array_equal(via_cache, before)
        before = via_cache
    log(f"15c {SERVE_PUSHES} acknowledged pushes to the {len(hot)} hottest ids "
        f"({int((slots >= 0).sum())} of them cached before the first): reads through the "
        f"cache that differ from a direct pull {mismatches}, reads that moved {moved}")
    if mismatches or moved != SERVE_PUSHES or not (slots >= 0).all():
        raise AssertionError(f"15c: {mismatches} stale reads, {moved} of {SERVE_PUSHES} "
                             f"moved, {int((slots < 0).sum())} hot ids uncached")


def serve_rollout(work: str, frontend, server, writer, request, params: dict) -> None:
    """15d (see the module docstring), on a 15b replica."""
    from easydl_tpu_torch.loop import publish as pub
    from easydl_tpu_torch.proto import easydl_pb2 as pb
    from easydl_tpu_torch.serve.frontend import SERVE_SERVICE
    from easydl_tpu_torch.utils.rpc import GRPC_MSG_OPTIONS, RpcClient

    models = os.path.join(work, "models")
    trees = {1: params, 2: serve_params(0, perturb=0.1)}
    loaded = []

    def loader(manifest, arrays):  # built on the watcher's thread
        loaded.append(manifest["version"])
        return serve_forward(tree_params(arrays))

    ids, dense = request
    emb = writer.pull(PS_TABLE["name"], ids)
    cpu = {v: serve_forward(t, device="cpu")(emb, dense) for v, t in trees.items()}

    def served(version):
        r = frontend.infer(ids, dense)
        if not r.ok:
            raise AssertionError(f"15d: {r.verdict}")
        got = torch.from_numpy(r.scores)
        return {v: rel_err(got, torch.from_numpy(c)) for v, c in cpu.items()}, \
            frontend.model_versions()["control"]

    readings, failures = {}, []
    pub.publish_version(models, flat_params(trees[1]), keep=8)
    watcher = pub.ModelVersionWatcher(models, loader, on_swap=frontend.set_model,
                                      replica=frontend.name, poll_s=0.05)
    frontend.attach_rollout(watcher)
    rpc = RpcClient(SERVE_SERVICE, server.address, timeout=30.0, options=GRPC_MSG_OPTIONS)
    try:
        watcher.start()
        pub.publish_version(models, flat_params(trees[2]), keep=8)
        deadline = time.monotonic() + 30
        while watcher.current != 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        readings["swap"] = served(2)
        back = rpc.Rollout(pb.RolloutRequest(action="rollback"))
        readings["rollback"] = served(1)
        v3 = pub.publish_version(models, flat_params(serve_params(0, perturb=0.2)), keep=8)
        path = os.path.join(models, f"v_{v3:08d}", "deep_0.kernel.npy")
        with open(path, "r+b") as f:  # one byte of the payload, past the header
            f.seek(-1000, os.SEEK_END)
            byte = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([byte[0] ^ 0x40]))
        cleared = rpc.Rollout(pb.RolloutRequest(action="clear"))
        readings["clear"] = served(2)
    finally:
        watcher.stop()
        rpc.close()
    log(f"15d hot swap through a ModelVersionWatcher (forwards built on its thread), the "
        f"Rollout RPC's rollback, a v3 with one byte flipped: (relative L2 to v1's and v2's "
        f"CPU forwards, the version served) {readings}; rollback {back.ok} "
        f"'{back.message}', clear {cleared.ok} '{cleared.message}'; loaded {loaded}, "
        f"quarantined {watcher.quarantined}, committed {pub.list_versions(models)}")
    for step, want in (("swap", 2), ("rollback", 1), ("clear", 2)):
        rels, version = readings[step]
        other = 3 - want
        if version != want or rels[want] > SERVE_CPU_REL or rels[other] <= 1e3 * SERVE_CPU_REL:
            failures.append(f"{step}: served v{version}, {rels}")
    if not (back.ok and back.active_version == 1 and cleared.ok and cleared.active_version == 2):
        failures.append(f"the Rollout RPC answered {back} / {cleared}")
    if v3 in loaded or v3 not in watcher.quarantined or v3 in pub.list_versions(models) \
            or not os.path.exists(os.path.join(models, f"v_{v3:08d}", "CORRUPT")):
        failures.append(f"v{v3} was not quarantined before it was built")
    if failures:
        raise AssertionError("15d: " + "; ".join(failures))


def start_replica(work: str):
    """15e's replica process, ``python -m easydl_tpu_torch.serve --deepfm``
    on the card through ``spawn_replicas``, on a thread of its own so that
    its start (the torch import, CUDA's init) runs beside 15a-15d; returns
    the future of ({name: process}, seconds until its discovery file)."""
    from concurrent.futures import ThreadPoolExecutor

    from easydl_tpu_torch.serve.launch import spawn_replicas

    def spawn():
        t0 = time.perf_counter()
        procs = spawn_replicas(
            1, work, PS_TABLE["name"], SERVE_FIELDS, max_batch=SERVE_MAX_BATCH,
            max_wait_ms=SERVE_MAX_WAIT_MS, name_prefix="serve-e", wait_s=120,
            extra_args=["--deepfm", "--dim", str(SERVE_DIM), "--dense-dim", str(SERVE_DENSE),
                        "--hidden", ",".join(map(str, SERVE_HIDDEN))],
            log_path=os.path.join(work, "replica.log"))
        return procs, time.perf_counter() - t0

    pool = ThreadPoolExecutor(1)
    try:
        return pool.submit(spawn)
    finally:
        pool.shutdown(wait=False)


def serve_entry_point(work: str, writer, requests: list, started) -> None:
    """15e (see the module docstring) on the replica ``start_replica``
    started."""
    from easydl_tpu_torch.proto import easydl_pb2 as pb
    from easydl_tpu_torch.serve.frontend import SERVE_SERVICE
    from easydl_tpu_torch.utils.rpc import GRPC_MSG_OPTIONS, RpcClient

    log_path = os.path.join(work, "replica.log")
    try:
        procs, up = started.result()
    except TimeoutError:
        with open(log_path) as f:
            print(f"--- the replica:\n{f.read()[-4000:]}", file=sys.stderr)
        raise
    (name, proc), = procs.items()
    discovery = os.path.join(work, "serve", f"{name}.json")
    with open(discovery) as f:
        address = json.load(f)["address"]
    same_seed = serve_forward(device="cpu")
    rpc = RpcClient(SERVE_SERVICE, address, timeout=60.0, options=GRPC_MSG_OPTIONS)
    rels, failures = [], []
    try:
        for ids, dense in requests:
            resp = rpc.Infer(pb.InferRequest(raw_ids=ids.astype("<i8").tobytes(),
                                             fields=SERVE_FIELDS, dense=dense.tobytes(),
                                             dense_dim=SERVE_DENSE))
            scores = np.frombuffer(resp.scores, "<f4")
            if not resp.ok or scores.shape != (len(ids),) or not np.isfinite(scores).all():
                failures.append(f"answered ok={resp.ok} '{resp.verdict}', {scores.shape}")
                continue
            want = same_seed(writer.pull(PS_TABLE["name"], ids), dense)
            rels.append(rel_err(torch.from_numpy(scores.copy()), torch.from_numpy(want)))
    finally:
        rpc.close()
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
    log(f"15e `python -m easydl_tpu_torch.serve --deepfm` (tower {SERVE_HIDDEN}, seed 0) up in "
        f"{up:.1f} s (started with the phase); {len(requests)} Infer RPCs against the same-seed forward on the CPU, "
        f"relative L2 {rels}; SIGTERM -> exit {rc}, discovery file left "
        f"{os.path.exists(discovery)}")
    if len(rels) != len(requests) or max(rels, default=1.0) > SERVE_CPU_REL:
        failures.append(f"scores {rels} against the bound {SERVE_CPU_REL:g}")
    if rc != 0 or os.path.exists(discovery):
        failures.append(f"exit {rc}, discovery file left {os.path.exists(discovery)}")
    if failures:
        with open(log_path) as f:
            print(f"--- the replica:\n{f.read()[-4000:]}", file=sys.stderr)
        raise AssertionError("15e: " + "; ".join(failures))


def serve_train(card: str, out: str) -> int:
    """15a-15e (see the module docstring), as ``chip_smoke.py --serve CARD
    OUT``: writes the phase's launches to ``OUT``."""
    from easydl_tpu_torch.ps.client import ShardedPsClient
    from easydl_tpu_torch.ps.table import TableSpec

    torch.backends.cuda.matmul.allow_tf32 = False  # the tower's f32 stays f32
    torch.backends.cudnn.allow_tf32 = False
    work = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    fa.reset_launches()
    pods, frontends, servers, writer, started = [], [], [], None, None
    try:
        with Phase("15 (the PS pods up)"):
            pods = ps_pods(work, os.path.join(work, "pods.log"))
            writer = ShardedPsClient.from_registry(work, PS_SHARDS, wait_s=30)
            writer.create_table(TableSpec(**PS_TABLE))
        started = start_replica(work)
        requests = serve_requests(SERVE_WARMUP + SERVE_REQUESTS + SERVE_PROFILED, seed=0)
        params = serve_params(0)
        with Phase("15a (the scorer, the card against the CPU)"):
            serve_scorer(card, writer, requests, params)
        with Phase("15b (two replicas behind the router, under load)"):
            hot = serve_load(card, work, requests, params, frontends, servers)
        with Phase("15c (freshness through the hot-id cache)"):
            serve_freshness(frontends[0].reads.reads, writer, hot)
        with Phase("15d (hot swap, rollback, quarantine)"):
            serve_rollout(work, frontends[0], servers[0], writer, requests[0], params)
        with Phase("15e (the replica process)"):
            serve_entry_point(work, writer, requests[:3], started)
    finally:
        if started is not None:  # the replica, wherever the phase stopped
            with contextlib.suppress(Exception):
                for proc in started.result(timeout=150)[0].values():
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
        for fe in frontends:
            fe.stop()
            fe.reads.close()
        if writer is not None:
            writer.close()
        stop_pods(pods)
        shutil.rmtree(work, ignore_errors=True)
    with open(out, "w") as f:
        json.dump({"launches": dict(fa.launches)}, f)
    return 0


def serve_phase(card: str) -> dict:
    """Phase 15 (see the module docstring), in a process of its own; returns
    its launches."""
    fd, out = tempfile.mkstemp(prefix="chip_smoke_serve_", suffix=".json")
    os.close(fd)
    try:
        with Phase("15 (the serving tier, BASELINE config 5's model)"):
            rc = run_child(["--serve", card, out], SERVE_DEADLINE_S)
            if rc:
                raise AssertionError(f"phase 15 exited {rc}")
        with open(out) as f:
            return json.load(f)["launches"]
    finally:
        os.remove(out)


def pp_rank_main(rank: int, work: str) -> int:
    """One of phase 16's two ranks (``chip_smoke.py --pp-rank R WORKDIR``):
    16a-16b's runs at pp 2, the ranks' save (rank 0 writes its hashes and
    the next loss to ``WORKDIR/saved.json``) and, once the parent has saved
    that state again from one process (``WORKDIR/one.ready``), its restore
    onto pp 2; rank 0 writes the readings to ``WORKDIR/result.json``."""
    import faulthandler
    from datetime import timedelta

    import torch.distributed as dist

    from easydl_tpu_torch.core.checkpoint import Shards
    from easydl_tpu_torch.core.mesh import MeshSpec, build_mesh, init_distributed
    from easydl_tpu_torch.ops import pipeline

    faulthandler.enable()
    os.environ["EASYDL_CHUNK_CACHE"] = "off"  # phase 9 covers the cache
    fa._lib()
    data = iter(gpt345m.bundle().make_data(gpt345m.GLOBAL_BATCH, seed=0))
    batches = [next(data) for _ in range(PP_STEPS + 1)]
    res: dict = {"seconds": {}}
    one: dict = {}
    t_part = time.perf_counter()

    def part(name: str) -> None:  # the seconds since the last part ended
        nonlocal t_part
        now = time.perf_counter()
        res["seconds"][name] = round(now - t_part, 2)
        t_part = now

    if rank == 0:  # phase 4's parameters after the same steps: the reference
        one = torch.load(os.path.join(work, "one.pt"))
        part("the reference loaded")
    init_distributed("cuda:0", backend="gloo", rank=rank, world_size=2,
                     store=dist.FileStore(os.path.join(work, "store"), 2),
                     timeout=timedelta(seconds=DIST_DEADLINE_S))
    mesh = build_mesh(MeshSpec(pp=2), "cuda:0")
    group = mesh.get_group("pp")
    part("the group")

    def pp_trainer():
        options, _ = pipeline.apply_pipeline_config("gpt", {}, mesh, PP_MICROBATCHES)
        return gpt345m.trainer(gpt345m.bundle(**options), device="cuda:0", mesh=mesh)

    def param_rel(model) -> dict:
        """Each stage's view of the parameters against one process's,
        relative L2, of them all and of the embedding alone (rank 0
        reckons; NaN on the other)."""
        rels: dict = {"all": [], "tok_emb.weight": []}
        for params in stage_views(model, group):
            sums = {key: [0.0, 0.0] for key in rels}
            for name, ref in one.items():
                ref = ref.to(params[name].device).float()
                diff = (params[name].float() - ref).square().sum().item()
                norm = ref.square().sum().item()
                for key in {"all", name} & set(sums):
                    sums[key][0] += diff
                    sums[key][1] += norm
            for key, (diff, norm) in sums.items():
                rels[key].append(math.sqrt(diff / norm) if norm else float("nan"))
        return rels

    real_shift, real_copy = pipeline.shift, pipeline.copy_to_pp
    exchange = {"calls": 0, "s": 0.0}

    def timed_shift(x, grp, hops):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = real_shift(x, grp, hops)
        torch.cuda.synchronize()
        exchange["s"] += time.perf_counter() - t0
        exchange["calls"] += 1
        return y

    launches = dict.fromkeys(fa.launches, 0)
    for run in ("sound", "fault"):
        if run == "fault":
            pipeline.copy_to_pp = lambda x, grp: x  # the embedding's gradient left unsummed
        trainer = pp_trainer()
        state = trainer.init_state()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, step_s, per_step = [], [], []
        for i, batch in enumerate(batches[:PP_STEPS]):
            timed = run == "sound" and i > 0
            pipeline.shift = timed_shift if timed else real_shift
            fa.reset_launches()
            t0 = time.perf_counter()
            state, metrics = trainer.train_step(state, batch)
            losses.append(float(metrics["loss"]))  # syncs
            step_s.append(time.perf_counter() - t0)
            per_step.append(dict(fa.launches))
            for k, v in fa.launches.items():
                launches[k] += v
        pipeline.shift, pipeline.copy_to_pp = real_shift, real_copy
        part(f"{run} run")
        res[run] = {"losses": losses, "step_s": step_s, "launches": per_step,
                    "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                    "rel": param_rel(state.model)}
        part(f"{run} parameters compared")
        if run == "sound":
            res["exchange"] = dict(exchange)
            mgr = CheckpointManager(os.path.join(work, "ckpt_pp"))
            leaves = trainer.state_leaves(state)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mgr.save(state.step, leaves)
            mgr.wait()
            res["save_s"] = time.perf_counter() - t0
            res["chunks"] = {k: [b for b, _ in v.chunks] for k, v in leaves.items()
                             if isinstance(v, Shards)}
            part("the save")
            hashes = state_hashes(state)
            part("the save's hashes")
            del leaves
            fa.reset_launches()
            state, metrics = trainer.train_step(state, batches[PP_STEPS])
            for k, v in fa.launches.items():
                launches[k] += v
            part("the next step")
            saved = [None, None]
            dist.all_gather_object(saved, {"hashes": hashes, "chunks": res["chunks"],
                                           "next_loss": float(metrics["loss"])})
            if rank == 0:  # for the parent's 16c, beside the ranks' fault run
                with open(os.path.join(work, "saved.json.tmp"), "w") as f:
                    json.dump(saved, f)
                os.replace(os.path.join(work, "saved.json.tmp"), os.path.join(work, "saved.json"))
        del state, trainer
        gc.collect()
        torch.cuda.empty_cache()
    # 16c: the one-process save of the parent restored onto pp 2
    ready = os.path.join(work, "one.ready")
    deadline = time.monotonic() + DIST_DEADLINE_S
    while not os.path.exists(ready):
        if time.monotonic() > deadline:
            raise TimeoutError("the parent's one-process save never came")
        time.sleep(0.1)
    part("waiting for the one-process save")
    t0 = time.perf_counter()
    restored = pp_trainer().restore_from(CheckpointManager(os.path.join(work, "ckpt_one")))
    torch.cuda.synchronize()
    res["restore_one_s"] = time.perf_counter() - t0
    part("the one-process save restored")
    res["from_one"] = state_hashes(restored)
    part("the restored hashes")
    res["launches"] = launches
    gathered = [None, None]
    dist.all_gather_object(gathered, res)
    if rank == 0:
        merged = {key: [g[key] for g in gathered]
                  for key in ("sound", "fault", "from_one", "exchange", "save_s",
                              "restore_one_s", "launches", "seconds")}
        with open(os.path.join(work, "result.json"), "w") as f:
            json.dump(merged, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def pp_one_process(work: str, failed) -> dict:
    """16c's parent side, beside the ranks' fault run: once the ranks' save
    is in (``saved.json``), restores it in one process (bit-equal to the
    ranks' state, and its next loss theirs), saves that state again from
    this process for the ranks to restore onto pp 2 (``one.ready``), and
    returns the readings; an empty dict when a rank failed first."""
    path = os.path.join(work, "saved.json")
    while not os.path.exists(path):
        if failed():
            return {}
        time.sleep(0.1)
    with open(path) as f:
        saved = json.load(f)
    union = {**saved[0]["hashes"], **saved[1]["hashes"]}
    restorer = gpt345m.trainer(gpt345m.bundle())
    t0 = time.perf_counter()
    restored = restorer.restore_from(CheckpointManager(os.path.join(work, "ckpt_pp")))
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    got = state_hashes(restored)
    differ = [k for k in union if got.get(k) != union[k]]
    if differ or set(got) != set(union):
        raise AssertionError(f"16c: the restored state is not the ranks' saved one: {differ[:6]}")
    cache = os.environ.get("EASYDL_CHUNK_CACHE")
    os.environ["EASYDL_CHUNK_CACHE"] = "off"  # phase 9 covers the cache
    try:
        mgr = CheckpointManager(os.path.join(work, "ckpt_one"))
        mgr.save(restored.step, restorer.state_leaves(restored))
        mgr.wait()
    finally:
        if cache is not None:
            os.environ["EASYDL_CHUNK_CACHE"] = cache
    with open(os.path.join(work, "one.ready"), "w") as f:
        f.write(str(restored.step))
    data = iter(gpt345m.bundle().make_data(gpt345m.GLOBAL_BATCH, seed=0))
    for _ in range(PP_STEPS):
        next(data)
    _, metrics = restorer.train_step(restored, next(data))
    return {"saved": saved, "hashes": got, "restore_s": t_restore,
            "next_loss": float(metrics["loss"])}


def pp_phase(card: str, phase4: dict, one: dict) -> dict:
    """Phase 16 (see the module docstring); ``one`` is phase 4's parameters
    after ``PP_STEPS`` steps. Returns the launches of its ranks' runs,
    summed."""
    work = tempfile.mkdtemp(prefix="chip_smoke_pp_")
    per_step = PP_LAYERS * MICROBATCHES * PP_MICROBATCHES
    want = fa.expected_launches(bf16=per_step)
    want[fa.KERNELS[torch.bfloat16][0]] *= 2  # the checkpointed stage's forward runs again
    beside: dict = {}
    try:
        with Phase("16 (GPT-2 345M at pp 2 on two ranks; 16c in this process beside them)"):
            torch.save(one, os.path.join(work, "one.pt"))
            start_ranks("--pp-rank", 2, work, "16",
                        beside=lambda failed: beside.update(pp_one_process(work, failed)))
            with open(os.path.join(work, "result.json")) as f:
                res = json.load(f)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    sound, fault, saved = res["sound"], res["fault"], beside["saved"]
    failures = []
    losses = sound[0]["losses"]
    worst = max(abs(a - b) for a, b in zip(losses, phase4["losses"]))
    rel, fault_rel = sound[0]["rel"], fault[0]["rel"]
    log(f"16a pp 2 ({PP_LAYERS} layers a stage, {PP_MICROBATCHES} pipeline microbatches "
        f"a trainer microbatch): losses {losses} (phase 4: {phase4['losses'][:PP_STEPS]}, "
        f"worst {worst:.3g}, bound {DIST_LOSS_ABS}); parameters vs phase 4's after the same "
        f"steps, relative L2, each stage's view {rel['all']} (bound {DIST_PARAM_REL}), the "
        f"embedding's alone {rel['tok_emb.weight']}; planted fault (the embedding's gradient "
        f"unsummed over pp) {fault_rel['all']}, the embedding's alone "
        f"{fault_rel['tok_emb.weight']}, losses {fault[0]['losses']}")
    if worst > DIST_LOSS_ABS:
        failures.append(f"losses {losses} vs phase 4's {phase4['losses']}")
    if not max(rel["all"]) <= DIST_PARAM_REL:
        failures.append(f"parameters {rel['all']} from one process's")
    if not (max(fault_rel["all"]) > DIST_PARAM_REL
            and max(fault_rel["tok_emb.weight"]) > DIST_PARAM_REL):
        failures.append(f"the planted fault passes: {fault_rel}")
    for r in range(2):
        for i, counts in enumerate(sound[r]["launches"] + fault[r]["launches"]):
            if counts != want:
                failures.append(f"rank {r} step {i}: launches {counts}, want {want}")
    timed = [sum(s["step_s"][1:]) / (PP_STEPS - 1) for s in sound]
    step = max(timed)
    calls = [e["calls"] for e in res["exchange"]]
    tick_ms = [1e3 * e["s"] / max(e["calls"], 1) for e in res["exchange"]]
    log(f"16b step {step:.4f} s (ranks {timed}; phase 4 {phase4['step_s']:.4f}), "
        f"{gpt345m.GLOBAL_BATCH * gpt345m.SEQ / step:.0f} tokens/s (phase 4 "
        f"{phase4['tokens_per_s']:.0f}); peak memory by rank "
        f"{[round(s['peak_gib'], 2) for s in sound]} GiB (phase 4 "
        f"{phase4['peak_gib']:.2f}); bf16 "
        f"flash launches a rank and step {sound[0]['launches'][-1]} (predicted {want}); "
        f"the exchange {tick_ms[0]:.3f} / {tick_ms[1]:.3f} ms a tick by rank "
        f"({calls} exchanges over the {PP_STEPS - 1} timed steps, [rows 4, 1024, 1024] "
        f"bf16, through the host), on {card}")
    chunks = {}
    for r, by_rank in enumerate(saved):
        for key, bounds in by_rank["chunks"].items():
            for b in bounds:
                chunks.setdefault((key, json.dumps(b)), []).append(r)
    twice = [k for k, ranks in chunks.items() if len(ranks) > 1]
    if twice:
        failures.append(f"chunks written by more than one rank: {twice[:4]}")
    loss, ranks_loss = beside["next_loss"], saved[0]["next_loss"]
    log(f"16c the ranks' save at step {beside['hashes']['step']}: {len(chunks)} chunks, each "
        f"written by one rank ({len(twice)} twice), in {res['save_s'][0]:.2f} s; restored in "
        f"one process in {beside['restore_s']:.2f} s, {len(beside['hashes']) - 1} tensors and "
        f"counts bit-equal to the ranks'; next loss {loss:.6f} in one process vs "
        f"{ranks_loss:.6f} on the ranks (|diff| {abs(loss - ranks_loss):.3g}, bound "
        f"{DIST_LOSS_ABS})")
    if abs(loss - ranks_loss) > DIST_LOSS_ABS:
        failures.append(f"16c: next loss {loss} in one process vs the ranks' {ranks_loss}")
    from_one = {**res["from_one"][0], **res["from_one"][1]}
    differ = [k for k in beside["hashes"] if from_one.get(k) != beside["hashes"][k]]
    log(f"16c that state saved from one process, restored onto pp 2 in "
        f"{max(res['restore_one_s']):.2f} s: {len(differ)} of the tensors and counts differ "
        f"{differ[:6]}; rank seconds by part: {res['seconds']}")
    if differ or set(from_one) != set(beside["hashes"]):
        failures.append("the one-process save restored onto pp 2 is not its state")
    if failures:
        raise AssertionError("16: " + "; ".join(failures))
    total = dict.fromkeys(fa.launches, 0)
    for counts in res["launches"]:
        for k, v in counts.items():
            total[k] += v
    return total


# ------------------------------------------------------------------ phase 18
def operator_train(card: str, out: str) -> int:
    """Phase 18 (see the module docstring), as ``chip_smoke.py --operator
    CARD OUT``: writes its seconds to ``OUT``."""
    from easydl_tpu_torch.data import write_token_shards
    from easydl_tpu_torch.scripts import operator_lifecycle as lifecycle

    fa._lib()  # the worker ranks load the library the parent built (built here when alone)
    work = tempfile.mkdtemp(prefix="chip_smoke_operator_")
    try:
        tokens, spec = os.path.join(work, "tokens"), os.path.join(work, "chaos.json")
        vocab = bert.make_bert(**BERT_JOB["model_kwargs"]).make_data(1).vocab
        write_token_shards(np.random.default_rng(0).integers(0, vocab, BERT_TOKENS), tokens)
        with open(spec, "w") as f:
            json.dump({"scenario": "chip_smoke", "seed": 0, "t0": time.time(), "events": [
                {"id": 0, "kind": "straggler", "start_s": 0, "end_s": 3600,
                 "target": {"agent": f"{lifecycle.JOB}-worker-0"},
                 "params": {"sleep_s": OPERATOR_STRAGGLE_S}}]}, f)
        args = (f"--model bert --model-arg size={BERT_JOB['model_kwargs']['size']} --data-dir "
                f"{tokens} --batch {BERT_GLOBAL_BATCH} --steps {OPERATOR_STEPS} --ckpt-every "
                f"{OPERATOR_CKPT} --lr {BERT_JOB['lr']}")
        rec = lifecycle.run(work, args, OPERATOR_STEPS, BERT_KILL_AT, "cuda", OPERATOR_STAGE_S,
                            pod_env={"EASYDL_CHAOS_SPEC": spec})
        failed = lifecycle.failures(rec, BERT_REPLAY_ABS)
        again = {r["step"]: r["loss"] for r in rec.metrics.get(rec.replacement, [])
                 if r["generation"] == 2}
        log(f"18 the operator's lifecycle (BASELINE config 3): pods created "
            f"{ {n: (role, round(t, 2)) for n, (role, t, _) in rec.created.items()} }; "
            f"{rec.killed_pod} SIGKILLed at step {max(rec.killed_losses)} with step {rec.saved} "
            f"committed, replaced by {rec.replacement}; the master's reshapes {rec.reshapes}; "
            f"losses generation 1 {rec.killed_losses}, generation 2 {again}; committed "
            f"{rec.committed}, evaluated {rec.eval_steps}; pods at the end {rec.final_pods}, "
            f"stable {rec.stable}, job {rec.job_status.get('phase')}; reconcile core "
            f"{'native' if rec.native_core else 'python'} ({rec.native_library}), Brain core "
            f"{rec.brain_core}; processes left {rec.leftover}")
        log("18 seconds from the submit: " + ", ".join(
            f"{k} {v:.2f}" for k, v in rec.since_submit.items())
            + "; from the kill: " + ", ".join(f"{k} {v:.2f}" for k, v in rec.since_kill.items())
            + f" (10d's same-agent restart, kill -> first step: "
            f"{' - '.join(map(str, RESTART_10D_S))}); the job's wall time {rec.wall_s:.2f}; "
            f"on {card}")
        if failed:
            raise AssertionError("18: " + "; ".join(failed))
        with open(out, "w") as f:
            json.dump({"since_submit": rec.since_submit, "since_kill": rec.since_kill,
                       "wall_s": rec.wall_s}, f)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


def operator_phase(card: str) -> dict:
    """Phase 18 (see the module docstring), in a process of its own; returns
    its seconds."""
    fd, out = tempfile.mkstemp(prefix="chip_smoke_operator_", suffix=".json")
    os.close(fd)
    try:
        with Phase("18 (the operator's lifecycle, BASELINE config 3)"):
            rc = run_child(["--operator", card, out], OPERATOR_DEADLINE_S)
            if rc:
                raise AssertionError(f"phase 18 exited {rc}")
        with open(out) as f:
            return json.load(f)
    finally:
        os.remove(out)


# ------------------------------------------------------------------ phase 17
def loop_labels(ids: np.ndarray) -> np.ndarray:
    """A request's labels: a click where its first field's id, hashed with
    LOOP_SEED, is odd (a fixed function of the ids, so the stream is
    learnable and the same in every run)."""
    from easydl_tpu_torch.ps.table import splitmix64

    return (splitmix64(ids[:, 0].astype(np.uint64) ^ np.uint64(LOOP_SEED)) & np.uint64(1)
            ).astype(np.float32)


class LabelingWriter:
    """The replica's feedback hook: the port's ``FeedbackWriter``, each
    served request's labels (:func:`loop_labels`) emitted right after its
    event, as a label producer that learned the request id would."""

    def __init__(self, writer):
        self.writer = writer

    def emit_serve(self, request_id, session_id, arm, model_version, ids, scores, t=None):
        ok = self.writer.emit_serve(request_id, session_id, arm, model_version, ids, scores, t=t)
        if ok:
            self.writer.emit_labels(request_id, loop_labels(ids))
        return ok

    def __getattr__(self, name):
        return getattr(self.writer, name)


class LoopLoad:
    """Closed-loop clients through one ``ServeFrontend``, each request
    phase 15's draw, until ``goal`` requests have been answered (the probes'
    included): each answered request is one event in the spool."""

    def __init__(self, frontend, requests: list, threads: int):
        self.frontend, self.requests = frontend, requests
        self.cv = threading.Condition()
        self.goal, self.ok, self.inflight, self.sent, self.stopped = 0, 0, 0, 0, False
        self.shed, self.hard = 0, []
        self.threads = [threading.Thread(target=self._client, args=(i,), daemon=True)
                        for i in range(threads)]
        for t in self.threads:
            t.start()

    def infer(self, ids, dense, session: str):
        r = self.frontend.infer(ids, dense, session_id=session)
        with self.cv:
            if r.ok:
                self.ok += 1
            elif r.retriable:
                self.shed += 1
            else:
                self.hard.append(r.verdict)
            self.cv.notify_all()
        return r

    def _client(self, i: int) -> None:
        while True:
            with self.cv:
                while not self.stopped and self.ok + self.inflight >= self.goal:
                    self.cv.wait()
                if self.stopped:
                    return
                self.inflight += 1
                n, self.sent = self.sent, self.sent + 1
            ids, dense = self.requests[n % len(self.requests)]
            try:
                self.infer(ids, dense, f"s{n % 16}")
            finally:
                with self.cv:
                    self.inflight -= 1
                    self.cv.notify_all()

    def reach(self, goal: float) -> None:
        """Sends until ``goal`` requests in all have been answered."""
        with self.cv:
            self.goal = goal
            self.cv.notify_all()

    def pause(self) -> int:
        """Stops sending; returns the answered requests once none is in flight."""
        with self.cv:
            self.goal = 0
            while self.inflight:
                self.cv.wait()
            return self.ok

    def stop(self) -> None:
        with self.cv:
            self.stopped = True
            self.cv.notify_all()
        for t in self.threads:
            t.join(timeout=60)


def loop_probe(load, k: int):
    """One lag sample: fresh sentinel ids scored, then again every
    LOOP_RESCORE_S until a row's score moves by more than LOOP_SCORE_MOVE
    (their event trained and its rows pushed), while the clients send a
    step's events (LOOP_EVENTS requests) behind it. Returns (seconds or
    None past LOOP_PROBE_TIMEOUT_S, the largest move before, the move)."""
    ids = (LOOP_SENTINEL + k * 10_000 + np.arange(SERVE_ROWS * SERVE_FIELDS)).reshape(
        SERVE_ROWS, SERVE_FIELDS).astype(np.int64)
    dense = np.zeros((SERVE_ROWS, SERVE_DENSE), np.float32)
    t0 = time.monotonic()
    first = load.infer(ids, dense, "probe")
    if not first.ok:
        raise AssertionError(f"17a: probe {k} not answered: {first.verdict}")
    load.reach(load.ok + LOOP_EVENTS)
    noise = 0.0
    try:
        while time.monotonic() < t0 + LOOP_PROBE_TIMEOUT_S:
            time.sleep(LOOP_RESCORE_S)
            r = load.infer(ids, dense, "probe")
            if not r.ok:
                continue
            move = float(np.abs(r.scores - first.scores).max())
            if move > LOOP_SCORE_MOVE:
                return time.monotonic() - t0, noise, move
            noise = max(noise, move)
        return None, noise, 0.0
    finally:
        load.pause()


def tier_rows(directory: str, step: int, table: str = PS_TABLE["name"]) -> tuple:
    """A saved PS tier's (ids, rows) of ``table`` merged over its shards and
    sorted by id; the rows carry the optimizer's slots."""
    d = os.path.join(directory, f"step_{step:010d}")
    parts = []
    for name in sorted(os.listdir(d)):
        if name.startswith(table + ".shard-") and name.endswith(".npz"):
            with np.load(os.path.join(d, name)) as z:
                parts.append((z["ids"], z["rows"]))
    ids = np.concatenate([p[0] for p in parts])
    order = np.argsort(ids)
    return ids[order], np.concatenate([p[1] for p in parts])[order]


def loop_replay(spool: str, table, steps: int, start=None) -> tuple:
    """``steps`` strict steps of ``PsTrainer.train_continuous`` over
    ``spool`` on a fresh ``LocalPsClient`` on the card: from the init, or,
    with ``start`` = (a directory, step), from that step's dense checkpoint
    and ``ps-ckpt`` under it with the spool read from its start (the
    planted fault). Returns (state hashes, the touched rows)."""
    from easydl_tpu_torch.loop.feedback import FeedbackDataset
    from easydl_tpu_torch.ps.client import LocalPsClient

    client = LocalPsClient(PS_SHARDS, backend="native")
    if start is not None:
        client.restore(os.path.join(start[0], "ps-ckpt"), step=start[1])
    _, trainer = worker_ps_trainer(LOOP_JOB, client, table)
    state = (trainer.init_state() if start is None else
             trainer.restore_from(CheckpointManager(os.path.join(start[0], "ckpt")), start[1]))
    data = FeedbackDataset([spool], batch_size=LOOP_JOB["global_batch"],
                           dense_dim=LOOP_JOB["feedback_dense_dim"],
                           batch_timeout_s=LOOP_JOB["feedback_batch_timeout_s"])
    state, _ = trainer.train_continuous(state, data, steps_per_round=steps, rounds=1)
    hashes = state_hashes(state)
    work = tempfile.mkdtemp(prefix="chip_smoke_loop_ref_")
    try:
        client.save(work, 1)
        rows = tier_rows(work, 1)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return hashes, rows


def loop_shm(card: str, work: str) -> dict:
    """17c (see the module docstring)."""
    from easydl_tpu_torch.ps import client as ps_client

    rng = np.random.default_rng(3)
    ids = (rng.zipf(SERVE_ZIPF, DEEPFM_GLOBAL_BATCH * SERVE_FIELDS) % SERVE_VOCAB).astype(
        np.int64)
    table = PS_TABLE["name"]
    shm = ps_client.ShardedPsClient.from_registry(work, PS_SHARDS, wait_s=30, pull_shm=True)
    wire = ps_client.ShardedPsClient.from_registry(work, PS_SHARDS, wait_s=30, pull_shm=False)
    served, _, fallbacks = ps_client._shm_metrics()
    try:
        wire.pull(table, ids)
        shm.pull(table, ids)  # the responses advertise the mirrors
        readers = sorted(s for s, _ in shm._shm_readers)
        before = served.value(table=table)
        ms = {"grpc": [], "shm": []}
        for _ in range(LOOP_SHM_REPEATS):
            for kind, client in (("grpc", wire), ("shm", shm)):
                t0 = time.perf_counter()
                client.pull(table, ids)
                ms[kind].append((time.perf_counter() - t0) * 1e3)
        by_shm = served.value(table=table) - before
        equal = np.array_equal(shm.pull(table, ids), wire.pull(table, ids))
        falls = {r: fallbacks.value(reason=r)
                 for r in ("open-failed", "revoked", "contention", "cold-miss")}
    finally:
        shm.close()
        wire.close()
    out = {k: statistics.median(v) for k, v in ms.items()}
    log(f"17c a {DEEPFM_GLOBAL_BATCH}-row batch's ids ({ids.size}, {len(np.unique(ids))} "
        f"distinct) from the {PS_SHARDS} pods: the shared-memory pull {out['shm']:.3f} ms, the "
        f"gRPC pull {out['grpc']:.3f} ms (medians of {LOOP_SHM_REPEATS}, host clock; "
        f"{ms}); shards read through their mirrors {readers}, shard pulls served by shm "
        f"{by_shm:.0f} of {LOOP_SHM_REPEATS * PS_SHARDS}; fallbacks {falls}; the rows "
        f"bit-equal: {equal}; on {card}")
    if not equal or readers != list(range(PS_SHARDS)) or by_shm != LOOP_SHM_REPEATS * PS_SHARDS:
        raise AssertionError(f"17c: shm rows equal {equal}, mirrors {readers}, served by shm "
                             f"{by_shm}")
    return out


def loop_train(card: str, out: str) -> int:
    """17a-17c (see the module docstring), as ``chip_smoke.py --loop CARD
    OUT``: writes the phase's launches and readings to ``OUT``."""
    from easydl_tpu_torch.loop.feedback import FeedbackWriter
    from easydl_tpu_torch.ps.client import LocalPsClient, ShardedPsClient
    from easydl_tpu_torch.ps.read_client import PsReadClient
    from easydl_tpu_torch.ps.table import TableSpec
    from easydl_tpu_torch.serve import HotIdCache, ServeConfig, ServeFrontend

    torch.backends.cuda.matmul.allow_tf32 = False  # the tower's f32 stays f32
    torch.backends.cudnn.allow_tf32 = False
    work = tempfile.mkdtemp(prefix="chip_smoke_loop_")
    fa.reset_launches()
    pods, frontend, load, writer = [], None, None, None
    res = {}
    try:
        with Phase("17 (the PS pods up, their mirrors on)"):
            pods = ps_pods(work, os.path.join(work, "pods.log"), env={"EASYDL_PS_SHM": "1"})
            writer = ShardedPsClient.from_registry(work, PS_SHARDS, wait_s=30)
            writer.create_table(TableSpec(**PS_TABLE))
        spool = os.path.join(work, "feedback", "serve-0")
        feedback = LabelingWriter(FeedbackWriter(spool, replica="serve-0", sync_s=0.05))
        reads = PsReadClient(ShardedPsClient.from_registry(work, PS_SHARDS, wait_s=30,
                                                           pull_shm=False),
                             cache=HotIdCache(SERVE_CACHE_BYTES))
        frontend = ServeFrontend(
            reads, ServeConfig(table=PS_TABLE["name"], fields=SERVE_FIELDS,
                               dense_dim=SERVE_DENSE, max_batch=SERVE_MAX_BATCH,
                               max_wait_ms=SERVE_MAX_WAIT_MS, request_timeout_s=60.0),
            forward=serve_forward(serve_params(0)), name="serve-0", feedback=feedback,
            canary_fraction=0.0)
        load = LoopLoad(frontend, serve_requests(4 * LOOP_EVENTS, seed=LOOP_SEED),
                        LOOP_THREADS)
        job = {**LOOP_JOB, "feedback_spools": [spool]}
        counts_dir = os.path.join(work, "counts")
        os.makedirs(counts_dir)
        metrics = os.path.join(work, "metrics-a0.jsonl")
        mgr = CheckpointManager(os.path.join(work, "ckpt"), async_save=False)

        def steps() -> int:
            return len(read_jsonl(metrics))

        def settled(answered: int) -> None:  # every answered request's event spooled
            await_state(lambda: feedback.stats["serve_events"] == answered,
                        f"{answered} events in the spool", 30, work)

        with control_plane(work, job) as (master, start):
            with Phase("17a (the loop's lag)"):
                # a warm standby: generation 2 starts from an interpreter
                # that imported torch and the port while generation 1 trained
                a0 = start("a0", [sys.executable, "-m", iw.__name__, counts_dir],
                           warm_start=True)
                load.reach(LOOP_EVENTS)  # the first step's events, while the worker starts
                await_state(lambda: steps() >= 1, "the worker's first step", LOOP_WORKER_S, work)
                t0 = time.monotonic()
                probes = [loop_probe(load, k) for k in range(LOOP_PROBES)]
                window = time.monotonic() - t0
                answered = load.pause()
                settled(answered)
                s = answered // LOOP_EVENTS
                await_state(lambda: steps() >= s, f"step {s} of the worker", LOOP_WORKER_S, work)
            with Phase("17b (exactly once across a kill)"):
                kill_at = s + 1
                while kill_at % LOOP_CKPT == 0 or kill_at <= LOOP_CKPT:
                    kill_at += 1
                if kill_at >= LOOP_STEPS:
                    raise AssertionError(f"17b: the worker is at step {s} after 17a, too close "
                                         f"to LOOP_STEPS {LOOP_STEPS} for a kill and a resume")
                saved = kill_at // LOOP_CKPT * LOOP_CKPT
                load.reach(kill_at * LOOP_EVENTS)
                await_state(lambda: steps() >= kill_at and saved in mgr.steps(),
                            f"step {kill_at} with step {saved} committed", LOOP_WORKER_S, work)
                killed = read_jsonl(metrics)
                a0.kill_worker_hard()  # SIGKILL, no notice, while it waits on the spool
                # the cut the fault resumes from, kept before generation 2's
                # saves retire it (the worker keeps its last 3)
                kept = os.path.join(work, "kept")
                for d, name in (("ckpt", f"step_{saved:08d}"), ("ps-ckpt", f"step_{saved:010d}")):
                    shutil.copytree(os.path.join(work, d, name), os.path.join(kept, d, name))
                load.reach(LOOP_STEPS * LOOP_EVENTS)
                done = master.wait_done(timeout=LOOP_WORKER_S)
                status = master.status()
                answered = load.pause()
                settled(answered)
        if not done:
            print_worker_logs(work)
            raise AssertionError(f"17b: the job did not end under the master: {status}")
        with Phase("17b (the uninterrupted replay and the planted fault)"):
            res.update(loop_checks(card, work, kept, spool, probes, window, killed, saved, load,
                                   feedback, counts_dir, mgr))
        with Phase("17c (the shared-memory pull)"):
            res.update(loop_shm(card, work))
    finally:
        if load is not None:
            load.stop()
        if frontend is not None:
            frontend.stop()
            frontend.reads.close()
        if writer is not None:
            writer.close()
        stop_pods(pods)
        shutil.rmtree(work, ignore_errors=True)
    res["launches"] = {k: res["launches"][k] + fa.launches[k] for k in fa.launches}
    with open(out, "w") as f:
        json.dump(res, f)
    return 0


def loop_checks(card, work, kept, spool, probes, window, killed, saved, load, feedback,
                counts_dir, mgr) -> dict:
    """17a's readings and 17b's checks (see the module docstring), after the
    job's end, ``kept`` holding the dense checkpoint and ``ps-ckpt`` of step
    ``saved``; returns the worker's launches and the lag's percentiles."""
    from easydl_tpu_torch.ps.client import LocalPsClient

    records = read_jsonl(os.path.join(work, "metrics-a0.jsonl"))
    by_gen = {g: [r for r in records if r["generation"] == g] for g in (1, 2)}
    times = read_jsonl(os.path.join(counts_dir, "ps-times-g1.jsonl"))
    states = {g: read_jsonl(os.path.join(counts_dir, f"states-g{g}.jsonl")) for g in (1, 2)}
    with open(os.path.join(counts_dir, "launches-g2-a0-l0.json")) as f:
        launches = json.load(f)  # generation 1 was killed before it could write its own
    with open(os.path.join(work, "worker-a0.log")) as f:
        worker_log = f.read()
    got = [lag for lag, _, _ in probes if lag is not None]
    ms = sorted(x * 1e3 for x in got)
    p50 = ms[len(ms) // 2] if ms else float("nan")
    p99 = ms[min(len(ms) - 1, int(0.99 * len(ms)))] if ms else float("nan")
    waited = [r["step_time_s"] for r in by_gen[1][1:]]
    parts = {k: statistics.mean(t[k] for t in times[1:]) for k in ("step", "pull", "upload",
                                                                 "download", "push")}
    drops = {k: feedback.stats[k] for k in ("dropped_bound", "dropped_error")}
    log(f"17a the loop's lag over {LOOP_PROBES} probes (sentinel ids scored, re-scored every "
        f"{LOOP_RESCORE_S * 1e3:.0f} ms until the served score moved), {LOOP_THREADS} "
        f"closed-loop clients of {SERVE_ROWS}-row requests on one ServeFrontend, the worker "
        f"at {LOOP_EVENTS} events ({LOOP_EVENTS * SERVE_ROWS} rows) a step: p50 {p50:.1f} ms, "
        f"p99 {p99:.1f} ms ({[round(x, 3) for x in ms]}), "
        f"{sum(lag is None for lag, _, _ in probes)} probes unresolved in "
        f"{LOOP_PROBE_TIMEOUT_S:.0f} s; a probe's largest move before its event trained "
        f"{max(n for _, n, _ in probes):.3g} (the batches' rounding), the moves that ended "
        f"them {[round(m, 4) for _, _, m in probes]} (bound {LOOP_SCORE_MOVE:g}); "
        f"{load.ok} requests answered in all, {window:.2f} s of probing; the worker's strict "
        f"step {parts['step']:.2f} ms (generation 1's mean after its first; with the wait "
        f"on the spool, its metrics' step {statistics.mean(waited):.4f} s), pull "
        f"{parts['pull']:.2f} ms, upload {parts['upload']:.3f} ms, download "
        f"{parts['download']:.3f} ms, push {parts['push']:.2f} ms; the feedback writer "
        f"{feedback.stats['serve_events']} events, drops {drops}; serving sheds {load.shed}, "
        f"hard errors {len(load.hard)}; on {card}")
    failures = []
    if load.hard:
        failures.append(f"{len(load.hard)} serving hard errors, e.g. {load.hard[:3]}")
    if len(got) != LOOP_PROBES:
        failures.append(f"{LOOP_PROBES - len(got)} probes saw no change of their score")
    if any(drops.values()):
        failures.append(f"feedback events dropped {drops}")
    # 17b: the run against one uninterrupted replay of the spool from the init
    kill_at = len(killed)
    gen2 = [r["step"] for r in by_gen[2]]
    manifests = {st: m.metadata(st)["metadata"]["data_state"]["spool_cursors"][spool]["events"]
                 for m, st in ((CheckpointManager(os.path.join(kept, "ckpt")), saved),
                               (mgr, LOOP_STEPS))}
    saved_state = [h for h in states[1] if h["kind"] == "saved" and h["step"] == saved]
    restored = [h for h in states[2] if h["kind"] == "restored"]
    final = [h for h in states[2] if h["kind"] == "saved" and h["step"] == LOOP_STEPS]
    spec_client = LocalPsClient(PS_SHARDS, backend="native")
    spec_client.restore(os.path.join(kept, "ps-ckpt"), step=saved)
    table = spec_client.shards[0].table(PS_TABLE["name"]).spec  # its floats came over the wire
    ref_hashes, ref_rows = loop_replay(spool, table, LOOP_STEPS)
    fault_hashes, fault_rows = loop_replay(spool, table, LOOP_STEPS - saved, start=(kept, saved))
    ids, rows = tier_rows(os.path.join(work, "ps-ckpt"), LOOP_STEPS)
    mine = np.isin(ids, ref_rows[0])
    got_rows = (ids[mine], rows[mine])

    def differ(hashes: dict) -> int:
        return sum(hashes.get(k) != v for k, v in ref_hashes.items())

    def rows_differ(r) -> int:
        if not np.array_equal(r[0], ref_rows[0]):
            return -1
        return int((r[1] != ref_rows[1]).any(axis=1).sum())

    def digest(r) -> str:
        return hashlib.blake2b(r[0].tobytes() + r[1].tobytes(), digest_size=8).hexdigest()

    worker_final = iw.hashed_state(final[0]) if final else {}
    log(f"17b killed after step {kill_at} (steps {[r['step'] for r in killed]}) with step "
        f"{saved} committed; generation 2 restored it (dense hashes equal to the saved ones: "
        f"{bool(saved_state and restored) and iw.hashed_state(restored[0]) == iw.hashed_state(saved_state[0])}; "
        f"'ps tier restored to step {saved}' logged: {f'ps tier restored to step {saved}' in worker_log}) "
        f"and trained steps {gen2}; the cursor in the manifests {manifests}; losses "
        f"{[(r['generation'], r['step'], round(r['loss'], 5)) for r in records]}")
    log(f"17b against one uninterrupted train_continuous of {LOOP_STEPS} steps over the same "
        f"spool on the card: the final dense state's {len(ref_hashes) - 1} hashes differ in "
        f"{differ(worker_final)} (the worker's) and {differ(fault_hashes)} (the planted fault: "
        f"the resume from step {saved} without the cursor, batches 1-{LOOP_STEPS - saved} "
        f"trained again); of the {len(ref_rows[0])} touched rows (Adagrad's slots included) "
        f"{rows_differ(got_rows)} differ (the pods' step-{LOOP_STEPS} ps-ckpt, digest "
        f"{digest(got_rows)} against {digest(ref_rows)}) and {rows_differ(fault_rows)} in the "
        f"fault's; generation 2's launches {launches}; on {card}")
    if kill_at <= saved or gen2 != list(range(saved + 1, LOOP_STEPS + 1)):
        failures.append(f"steps {[(r['generation'], r['step']) for r in records]} with step "
                        f"{saved} committed at the kill after {kill_at}: work lost, or none "
                        "replayed")
    if manifests != {saved: saved * LOOP_EVENTS, LOOP_STEPS: LOOP_STEPS * LOOP_EVENTS}:
        failures.append(f"the cursor in the manifests {manifests}")
    if not (saved_state and [h["step"] for h in restored] == [saved]
            and iw.hashed_state(restored[0]) == iw.hashed_state(saved_state[0])):
        failures.append(f"the dense state restored at step {saved} is not the one saved")
    if f"ps tier restored to step {saved}" not in worker_log:
        failures.append(f"generation 2 did not restore the tier to step {saved}")
    if not final or differ(worker_final) or rows_differ(got_rows):
        failures.append("the resumed run's final state is not the uninterrupted one's")
    if not differ(fault_hashes) or not rows_differ(fault_rows):
        failures.append("the planted fault left the final state equal")
    if failures:
        raise AssertionError("17: " + "; ".join(failures))
    return {"launches": launches, "lag_ms": {"p50": p50, "p99": p99}}


def loop_phase(card: str) -> dict:
    """Phase 17 (see the module docstring), in a process of its own; returns
    its launches and readings."""
    fd, out = tempfile.mkstemp(prefix="chip_smoke_loop_", suffix=".json")
    os.close(fd)
    try:
        with Phase("17 (the online loop, BASELINE config 5)"):
            rc = run_child(["--loop", card, out], LOOP_DEADLINE_S)
            if rc:
                raise AssertionError(f"phase 17 exited {rc}")
        with open(out) as f:
            return json.load(f)
    finally:
        os.remove(out)


def main() -> int:
    # -- 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: no CUDA GPU (torch.cuda.is_available() is False); "
              "this script needs one NVIDIA GPU", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    peak = peak_flops_per_chip(kind)
    log(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"peak {peak / 1e12:.0f} TFLOP/s bf16")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False

    # -- 2. build
    with Phase("2 (build)"):
        build_kernels()

    # -- 3. kernels against their plain versions
    with Phase("3 (kernels)"):
        check_kernels(6, 200, 72, 32, torch.float32, True, seed=1, timed=False)
        check_kernels(4, 136, 136, 64, torch.float32, False, seed=2, timed=False)
        # 13c's Ulysses ranks, whose one-process reference runs the same kernels
        check_kernels(ULYSSES_BH, gpt345m.SEQ, gpt345m.SEQ, 64, torch.float32, True, seed=7,
                      timed=False)
        check_kernels(6, 200, 72, 32, torch.bfloat16, True, seed=4, timed=False)
        check_kernels(4, 136, 136, 64, torch.bfloat16, False, seed=5, timed=False)
        check_kernels(8, 128, 128, 32, torch.bfloat16, True, seed=3, timed=False)
        rows = check_kernels(MAIN_BH, MAIN_S, MAIN_S, MAIN_D, torch.bfloat16, True,
                             seed=0, timed=True, peak_flops=peak)
        for r in rows:
            log(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound "
                f"{r['bound_ms']:.4f} by {r['bound_by']}, sdpa {r['library_ms']:.4f}) on {card}")

    # -- 4. main path: GPT-2 345M training steps
    t_phase = time.perf_counter()
    global_batch, seq, vocab = gpt345m.GLOBAL_BATCH, gpt345m.SEQ, gpt345m.VOCAB
    bundle = gpt345m.bundle()
    trainer = gpt345m.trainer(bundle)
    state = trainer.init_state()
    data = iter(bundle.make_data(global_batch, seed=0))
    pp_ref = {}  # the parameters after PP_STEPS steps: 16a's one process

    def keep(step, st):
        if step == PP_STEPS:
            pp_ref.update({n: p.detach().cpu() for n, p in st.model.named_parameters()})

    losses, norms, step_s, counts, peak_gib = train_timed(trainer, state, data, after=keep)
    want = N_LAYERS * MICROBATCHES * STEPS
    log(f"main path: gpt-345m b{global_batch}/a{MICROBATCHES} seq {seq} bf16: "
        f"losses {losses}, grad norms {norms}, launches {counts}")
    if abs(losses[0] - math.log(vocab)) > 1.0:
        raise AssertionError(f"first loss {losses[0]} far from ln(vocab) {math.log(vocab):.3f}")
    if counts != fa.expected_launches(bf16=want):
        raise AssertionError(f"launch counts {counts}, want {want} of each")
    phase4 = {**step_report(bundle, step_s, kind, peak_gib), "losses": losses}
    step_time = phase4["step_s"]
    log(f"main path: step {step_time:.4f}s (timed window {sum(step_s[1:]):.4f}s over "
        f"{len(step_s) - 1} steps {step_s[1:]}), {phase4['tokens_per_s']:.0f} "
        f"tokens/s, MFU {phase4['mfu']:.4f} vs {peak / 1e12:.0f} TFLOP/s bf16, peak mem "
        f"{peak_gib:.2f} GiB, on {card}")

    # -- 4b. where the time goes: one more step under the profiler
    profile_step(trainer, state, next(data), step_time)

    # -- 5. model check: flash against reference attention, same weights
    batch = trainer.to_device(next(data))
    ref = gpt345m.bundle(attention_impl="reference").init_fn(1, "cuda")
    ref.load_state_dict(state.model.state_dict())
    with torch.no_grad():
        logits_flash = state.model(batch["inputs"]).float()
        logits_ref = ref(batch["inputs"]).float()
        loss_flash = lm_loss(logits_flash, batch["targets"])[0].item()
        loss_ref = lm_loss(logits_ref, batch["targets"])[0].item()
        diff = (logits_flash - logits_ref).abs()
        max_err, rel = diff.max().item(), (diff.norm() / logits_ref.norm()).item()
        largest = logits_ref.abs().max().item()
    ulp = 2.0 ** (math.floor(math.log2(largest)) - 7)  # bf16 spacing at the largest logit
    log(f"model check: logits max|err| {max_err:.4g} ({max_err / ulp:.1f} bf16 ulps of the "
        f"largest |logit| {largest:.4g}), relative L2 {rel:.3g}, logit std "
        f"{logits_ref.std().item():.4g}; loss flash {loss_flash:.6f} vs reference "
        f"{loss_ref:.6f} (|diff| {abs(loss_flash - loss_ref):.3g})")
    if not (max_err <= MODEL_CHECK["LOGIT_ULPS"] * ulp and rel <= MODEL_CHECK["LOGIT_REL"]
            and abs(loss_flash - loss_ref) <= MODEL_CHECK["LOSS_ABS"]):
        raise AssertionError(f"flash and reference attention disagree beyond {MODEL_CHECK}")
    micro = global_batch // MICROBATCHES
    grad_check(state.model, ref, {k: v[:micro] for k, v in batch.items()})
    log(f"phase 4-5 (main path, model check): {time.perf_counter() - t_phase:.1f}s")

    # -- 6. bench configuration, with the phase 4-5 objects freed
    del state, trainer, ref, batch, logits_flash, logits_ref, diff
    gc.collect()
    torch.cuda.empty_cache()
    # the children's interpreters, each started a phase or more before its
    # child runs in it (Spares): 6e's bench, 7b's two ranks and 7d's four,
    # then one for each child phase and 16's two ranks
    SPARES.fill(4)
    phases = {"4": counts, **bench_configuration(kind, card, phase4)}
    gc.collect()
    torch.cuda.empty_cache()
    with Phase("6e (the port's bench)"):
        port_bench(card)
    SPARES.fill(4)

    # -- 7. the distributed path, with phase 6's objects freed
    gc.collect()
    torch.cuda.empty_cache()
    with Phase("7a (NCCL, world 1)"):
        phases["7a"] = nccl_world1(kind, card, {**phase4, "counts": counts})
    gc.collect()
    torch.cuda.empty_cache()
    phases["7b"] = two_ranks()
    SPARES.fill(4)
    gc.collect()
    torch.cuda.empty_cache()
    phases["7d"] = tp_ranks(card)
    SPARES.fill(3)  # 9's evaluator, 10, 11

    # -- 8. the elastic worker under the port's master and agents, with phase 7's objects freed
    gc.collect()
    torch.cuda.empty_cache()
    cold = {}
    clear_chunk_cache()
    phases["8"] = elastic_worker(card, cold)

    # -- 9. file data, the warm standby and the preflight
    gc.collect()
    torch.cuda.empty_cache()
    clear_chunk_cache()
    phases["9"] = file_worker(card, cold)

    # -- 10. BERT-base: the f32 kernels, training, the preemption
    gc.collect()
    torch.cuda.empty_cache()
    clear_chunk_cache()
    f32_rows, bert_phases = bert_base(card)
    phases.update(bert_phases)
    SPARES.fill(3)  # after 10a's timings: none imports beside them

    # -- 11. ResNet-50, BASELINE config 2: no flash kernel on its path
    gc.collect()
    torch.cuda.empty_cache()
    phases["11"] = resnet_50(card)
    SPARES.fill(3)

    # -- 12. DeepFM with its table on the card: no flash kernel on its path
    gc.collect()
    torch.cuda.empty_cache()
    phases["12"] = deepfm_phase(card)
    SPARES.fill(3)

    # -- 13. gpt_moe at full width, ep and sp on two ranks: the flash kernels
    gc.collect()
    torch.cuda.empty_cache()
    phases.update(moe_phase(card))
    SPARES.fill(3)

    # -- 14. the parameter-server path: DeepFM on two PS pods, no flash kernel
    gc.collect()
    torch.cuda.empty_cache()
    ps = ps_phase(card)
    phases["14"] = ps["launches"]
    SPARES.fill(3)  # 15, and 16's two ranks

    # -- 15. the serving tier: DeepFM's tower on the card behind the router
    gc.collect()
    torch.cuda.empty_cache()
    phases["15"] = serve_phase(card)
    SPARES.fill(3)  # 16's two ranks, 17

    # -- 16. pipeline parallelism: GPT-2 345M at pp 2 on two ranks, the flash kernels
    gc.collect()
    torch.cuda.empty_cache()
    clear_chunk_cache()
    phases["16"] = pp_phase(card, phase4, pp_ref)
    SPARES.fill(2)  # 17, 18

    # -- 17. the online loop: serve -> feedback -> train -> push, no flash kernel
    gc.collect()
    torch.cuda.empty_cache()
    clear_chunk_cache()
    loop = loop_phase(card)
    phases["17"] = loop["launches"]
    log(f"17c beside 14a: a {DEEPFM_GLOBAL_BATCH}-row batch's pull {loop['shm']:.3f} ms through "
        f"the shared-memory mirrors, {loop['grpc']:.3f} ms over gRPC; 14a's strict step pulled "
        f"in {ps['parts']['pull']:.3f} ms (through PsReadClient); the loop's lag p50 "
        f"{loop['lag_ms']['p50']:.1f} ms, p99 {loop['lag_ms']['p99']:.1f} ms; on {card}")

    # -- 18. the operator: config 3 submitted as an ElasticJob, a worker pod killed
    gc.collect()
    torch.cuda.empty_cache()
    clear_chunk_cache()
    op = operator_phase(card)
    phases["18"] = None  # the real worker counts no launches
    log(f"18 beside 10d: the kill to generation 2's first step "
        f"{op['since_kill']['generation 2 first step']:.2f} s on a fresh worker pod (10d, "
        f"the same agent: {' - '.join(map(str, RESTART_10D_S))} s); the job "
        f"{op['wall_s']:.2f} s from its submit; on {card}")

    # -- 19. summary
    for r in rows:
        r["launches"] = counts[r["name"]]
    for r in f32_rows:
        r["launches"] = phases["10b"][r["name"]]
    rows += f32_rows
    for r in rows:
        r["launches_by_phase"] = {p: None if c is None else c[r["name"]]
                                  for p, c in phases.items()}
    log(json.dumps({"kernels": rows}))
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def clear_chunk_cache() -> None:
    """Empties the host chunk cache of the phases before (its RAM)."""
    root = os.environ["EASYDL_CHUNK_CACHE"]
    for name in os.listdir(root):
        shutil.rmtree(os.path.join(root, name), ignore_errors=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--spare"]:
        take_command(sys.argv[2], int(sys.argv[3]))
        if sys.argv[0] == "-m":  # a module's command line
            import runpy
            import warnings

            sys.argv = sys.argv[1:]
            with warnings.catch_warnings():  # the module may be imported here already
                warnings.simplefilter("ignore", RuntimeWarning)
                runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
            sys.exit(0)
    if sys.argv[1:2] in (["--resnet"], ["--deepfm"], ["--moe"]):
        SPARES.fill(2)  # the phase's two ranks, imported while it trains alone
    try:
        if sys.argv[1:2] == ["--rank"]:
            sys.exit(rank_main(int(sys.argv[2]), sys.argv[3]))
        if sys.argv[1:2] == ["--pp-rank"]:
            sys.exit(pp_rank_main(int(sys.argv[2]), sys.argv[3]))
        if sys.argv[1:2] == ["--tp-rank"]:
            sys.exit(tp_rank_main(int(sys.argv[2]), sys.argv[3]))
        if sys.argv[1:2] == ["--bert"]:
            sys.exit(bert_train(sys.argv[2], sys.argv[3]))
        if sys.argv[1:2] == ["--resnet"]:
            sys.exit(resnet_train(sys.argv[2], sys.argv[3]))
        if sys.argv[1:2] == ["--resnet-rank"]:
            sys.exit(resnet_rank_main(int(sys.argv[2]), sys.argv[3]))
        if sys.argv[1:2] == ["--deepfm"]:
            sys.exit(deepfm_train(sys.argv[2], sys.argv[3]))
        if sys.argv[1:2] == ["--deepfm-rank"]:
            sys.exit(deepfm_rank_main(int(sys.argv[2]), sys.argv[3]))
        if sys.argv[1:2] == ["--moe"]:
            sys.exit(moe_train(sys.argv[2], sys.argv[3]))
        if sys.argv[1:2] == ["--moe-rank"]:
            sys.exit(moe_rank_main(int(sys.argv[2]), sys.argv[3]))
        if sys.argv[1:2] == ["--ps"]:
            sys.exit(ps_train(sys.argv[2], sys.argv[3]))
        if sys.argv[1:2] == ["--serve"]:
            sys.exit(serve_train(sys.argv[2], sys.argv[3]))
        if sys.argv[1:2] == ["--loop"]:
            sys.exit(loop_train(sys.argv[2], sys.argv[3]))
        if sys.argv[1:2] == ["--operator"]:
            sys.exit(operator_train(sys.argv[2], sys.argv[3]))
        if sys.argv[1:2] == ["--evaluator"]:  # phase 9's pod, with the worker's GPT size
            from easydl_tpu_torch.elastic import evaluator_main

            iw.add_gpt_size(WORKER_ARGS[1])
            sys.argv = ["evaluator_main", *sys.argv[2:]]
            sys.exit(evaluator_main.main())
        # the children's bytecode, compiled once (see the module docstring)
        pycache = tempfile.mkdtemp(prefix="chip_smoke_pycache_")
        os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
        os.environ["PYTHONPYCACHEPREFIX"] = pycache
        # the workers that the port's agents start (phases 8, 10d) import the
        # port from this checkout, wherever they run
        os.environ["PYTHONPATH"] = os.pathsep.join(
            p for p in (os.path.dirname(os.path.abspath(__file__)), os.environ.get("PYTHONPATH"))
            if p)
        # the checkpoints' host chunk cache (core/chunk_cache.py) in RAM where the
        # host has /dev/shm, as by default, but in a directory of this run's own
        # that goes with it
        cache_root = tempfile.mkdtemp(prefix="chip_smoke_chunk_cache_",
                                      dir="/dev/shm" if os.access("/dev/shm", os.W_OK) else None)
        os.environ["EASYDL_CHUNK_CACHE"] = cache_root
        try:
            rc = main()
        finally:
            shutil.rmtree(cache_root, ignore_errors=True)
            shutil.rmtree(pycache, ignore_errors=True)
        sys.exit(rc)
    finally:
        SPARES.stop()
