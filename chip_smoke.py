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
   with ragged tails), with the bounds in ``TOL``, and against autograd of
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
      phase 6's objects are freed; prints its JSON line;
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
      device: ``DIST_STEPS`` steps at dp 2 and at dp 1 x fsdp 2, losses
      within ``DIST_LOSS_ABS`` of phase 4's first ones, the parameters
      within ``DIST_PARAM_REL`` (relative L2) of one process's after the
      same steps; the same at fsdp 2 under an uneven mask, sound and with a
      planted fault, which must fail the bound; every run launches each
      kernel once per layer and microbatch on each rank;
   c. the fsdp 2 ranks' checkpoint (each rank its own chunks, rank 0
      commits) restored into one process: every parameter and Adam moment
      bit-equal (sha256) to the ranks' state; prints save and restore
      seconds;
8. the elastic worker (``elastic/worker.py``) under an agent that this
   script plays, with phase 7's objects freed: ``job.json`` is phase 4's
   set-up (``WORKER_JOB``, Adam(2e-4) as the JAX worker's), world 1 on
   ``cuda:0``, the worker started as ``python -m
   easydl_tpu_torch.scripts.instrumented_worker DIR`` (which records each
   rank's launches and the hashes of every state it saves or restores).
   Generation 1 gets SIGUSR1 once its metrics show step 2 and must exit 0
   with a committed checkpoint at its quiesce step q; generation 2 restores
   q and trains to step 6 (a periodic save at 3, the final one, ``DONE``).
   Checks: no step lost or repeated; every record has the protocol's keys
   and an MFU; each generation launched each kernel 24 layers x 2
   microbatches x its steps; the state restored at q is bit-equal (sha256)
   to the state saved at q; generation 1's first loss within
   ``DIST_LOSS_ABS`` of phase 4's, generation 2's within it of the same
   step in this process (``Trainer.restore_from`` of q, the first batch of
   ``make_data(16, seed=0)``). Prints the worker's step time, tokens/s and
   MFU beside phase 4's, and the generation switch from the timeline
   (``quiesce_ckpt_begin`` to ``first_step_done``);
9. file-backed token data and the worker's recovery paths, phase 8's job
   on ``FILE_TOKENS`` seeded ids (vocab 50304) in two ``tokens-*.npy``
   shards written by ``data.write_token_shards``, a 5% val split, 9 steps
   over three generations played by ``instrumented_worker`` (without its
   state hashes, so the worker's own save and restore are timed) as the
   agent: generation 1 cold, SIGUSR1 at step 2; generation 2 promoted from
   a warm standby started with generation 1; generation 3 from a preflight
   started once generation 2 has trained a step (which straggles
   ``FILE_STRAGGLE_S`` a step through the chaos hook, so that it still
   trains when the preflight is ready), SIGUSR1 to generation 2 once the
   preflight is ready, then the go; then the evaluator pod on the workdir.
   Checks: steps 1-9, none lost or repeated, each generation with one; the
   batch of every step bit-equal (sha256) to an uninterrupted
   ``TokenFileDataset``'s; each generation's first loss within
   ``DIST_LOSS_ABS`` of a step in this process from the same state (the
   init, or the checkpoint it restored) on the same batch; generations 2
   and 3 restored every chunk from the host chunk cache and none from
   storage; the kernels launched 48 times a step, and the preflight's own
   48; only generation 2's steps straggled; the pod evaluated step 9, its
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
      steps, a periodic save every 2: SIGKILL once its metrics show step
      ``BERT_KILL_AT`` and step 2 is committed; generation 2 restores the
      newest committed step and replays the rest. Checks: no step lost;
      no ``mfu`` key (BERT has no MFU numerator, as in the JAX worker); the
      restored state bit-equal (sha256) to the saved one; each replayed
      loss within ``BERT_REPLAY_ABS`` of the killed generation's, and the
      first replayed step with the mask of the step after it (in this
      process, from the same checkpoint and batch) above that bound;
      generation 2's launches. Prints the recovery, seconds from the kill
      to each timeline phase of generation 2, and the steps replayed;
11. summary: a ``kernels`` JSON line (with each phase's launches, 7b's
   summed over its ranks and runs, 8's and 9's over their generations; the
   f32 kernels' rows from phase 10, their launches 10b's), the card line,
   then the result line.

Each phase prints its seconds.

Imports only the port, torch and numpy.
"""

from __future__ import annotations

import functools
import gc
import hashlib
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
import time
from unittest import mock

import numpy as np
import torch

from easydl_tpu_torch.core import prng
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
from easydl_tpu_torch.scripts.instrumented_worker import read_jsonl, state_hashes, whole
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
# dp 2 and at dp 1 x fsdp 2: losses within DIST_LOSS_ABS of phase 4's first
# ones; the parameters after the steps within DIST_PARAM_REL, in relative
# L2, of one process's on the same batches. The same at fsdp 2 under an
# uneven mask of the targets (the first rank of each microbatch keeps 64
# targets a row, the second all 1024), sound and with a planted fault (each
# rank's local mean, averaged), shows what the bound tells apart: on an
# H100 SXM (700 W) the sound runs read 3.40e-4 (dp 2, fsdp 2) and 3.19e-4
# (uneven), the fault 1.77e-2; the bound sits between, 5.9x above the one
# and 8.8x below the other. bf16 rounds each rank's product over its half
# of the rows, so the sound reading is not 0.
DIST_LOSS_ABS = 2e-3
DIST_STEPS = 2
DIST_PARAM_REL = 2e-3
DIST_DEADLINE_S = 600  # 7b's two ranks, from their start to their exit
DIST_MASK_KEEP = 64
# Phase 8, the elastic worker under an emulated agent: phase 4's set-up as
# the job, with the worker's Adam(2e-4); its first losses are held to the
# in-process runs' by DIST_LOSS_ABS (expected equal: the same weights,
# batches and kernels).
WORKER_JOB = {"model": "gpt", "model_kwargs": {"size": "345m", "seq_len": gpt345m.SEQ,
                                               "vocab": gpt345m.VOCAB, "dtype": "bfloat16"},
              "global_batch": gpt345m.GLOBAL_BATCH, "grad_accum": MICROBATCHES, "lr": 2e-4,
              "seed": 0, "sync_every": 1, "ckpt_interval": 3, "total_steps": 6}
WORKER_QUIESCE_AT = 2  # SIGUSR1 once the metrics show this step
WORKER_DEADLINE_S = 300  # a generation, from its start to its exit
WORKER_KEYS = {"step", "loss", "step_time_s", "samples_per_sec", "world_size", "generation",
               "mesh", "t", "mfu"}
BENCH_DEADLINE_S = 300
# Phase 9, file-backed token data and the worker's recovery paths: phase 8's
# job on FILE_TOKENS seeded ids (vocab 50304, uint16) in two token shards
# with a 5% val split, FILE_STEPS steps over three generations: the first
# cold, the second promoted from a warm standby, the third from a preflight
# started while the second trains. The second generation straggles
# FILE_STRAGGLE_S a step (the chaos hook, on the card) so that it is still
# training when the preflight is ready, as under the master, which drains
# only then.
FILE_TOKENS = 4_200_000
FILE_JOB = {**WORKER_JOB, "total_steps": 9, "ckpt_interval": -1, "val_fraction": 0.05}
FILE_QUIESCE_AT = 2  # generation 1 gets SIGUSR1 once its metrics show this step
FILE_STRAGGLE_S = 10.0
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


def device_ms(fn, calls: int = 10):
    """(ms per call, kernel names): the device time of every kernel that
    ``calls`` calls of ``fn`` launched, summed by ``torch.profiler``, over
    ``calls``. For a library call through autograd, whose host cost can
    exceed its device time, so that a window of back-to-back calls would
    time the host."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [(e.key, e.self_device_time_total) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0 and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        raise AssertionError("the profiler saw no device time for the library call")
    return sum(t for _, t in kernels) / 1e3 / calls, sorted(k for k, _ in kernels)


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
    for what, (ms, names) in (("forward", lib_fwd), ("backward", lib_bwd)):
        log(f"sdpa {what}: {ms:.4f} ms of device time a call (torch.profiler) in "
            + "; ".join(n[:60] for n in names))
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


def train_timed(trainer, state, data):
    """STEPS steps from ``state``; returns (losses, grad norms, seconds of
    each step, launches, peak GiB) with the launch counts and the peak
    memory reset just before."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    losses, norms, step_s = [], [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, next(data))
        losses.append(float(metrics["loss"]))  # syncs
        norms.append(float(metrics["grad_norm"]))
        step_s.append(time.perf_counter() - t0)
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
    refs = {}
    if rank == 0:  # one process's parameters after the same steps on the same batches
        for masked in sorted({run["uneven"] for run in runs}):
            bundle = gpt345m.bundle()
            trainer = gpt345m.trainer(bundle, device="cuda:0")
            state = trainer.init_state()
            data = iter(bundle.make_data(gpt345m.GLOBAL_BATCH, seed=0))
            for _ in range(DIST_STEPS):
                batch = next(data)
                state, _ = trainer.train_step(state, uneven(batch) if masked else batch)
            refs[masked] = {n: p.detach() for n, p in state.model.named_parameters()}
            del state, trainer
    dist.barrier()
    out = {}
    real_batch_sum = gpt.batch_sum
    for run in runs:
        bundle = gpt345m.bundle()
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


def two_ranks(phase4: dict) -> dict:
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
            logs = [open(os.path.join(work, f"rank{r}.log"), "w") for r in range(2)]
            procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank",
                                       str(r), work], stdout=logs[r], stderr=subprocess.STDOUT)
                     for r in range(2)]
            deadline = time.monotonic() + DIST_DEADLINE_S
            try:
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
            if rcs != [0, 0]:
                for r in range(2):
                    with open(os.path.join(work, f"rank{r}.log")) as f:
                        print(f"--- 7b rank {r} (rc {rcs[r]}):\n{f.read()[-4000:]}",
                              file=sys.stderr)
                raise AssertionError(f"7b ranks exited {rcs} (killed at the {DIST_DEADLINE_S}s "
                                     "deadline if negative)")
            with open(os.path.join(work, "result.json")) as f:
                res = json.load(f)
            per_rank = N_LAYERS * MICROBATCHES * DIST_STEPS
            total = {k: 0 for k in fa.launches}
            failures = []
            for run in runs:
                r = res[run["name"]]
                log(f"7b {run['name']}: losses {r['losses']}, {r['seconds']:.2f}s for "
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
                if not run["uneven"]:
                    worst = max(abs(a - b) for a, b in zip(r["losses"], phase4["losses"]))
                    if worst > DIST_LOSS_ABS:
                        failures.append(f"{run['name']}: losses {r['losses']} vs phase 4's "
                                        f"{phase4['losses'][:DIST_STEPS]}")
            if failures:
                raise AssertionError("7b: " + "; ".join(failures))

        with Phase("7c (the two-rank save restored in one process)"):
            saved = res["fsdp 2"]
            restorer = gpt345m.trainer(gpt345m.bundle())
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


def port_bench(card: str) -> None:
    """6e: the port's bench (``scripts/bench.py``) in a subprocess; prints its
    line and fails unless it ran on this card with a finite loss."""
    r = subprocess.run([sys.executable, "-m", "easydl_tpu_torch.scripts.bench"],
                       capture_output=True, text=True, timeout=BENCH_DEADLINE_S,
                       env=dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__))))
    if r.returncode:
        print(r.stderr[-4000:], file=sys.stderr)
        raise AssertionError(f"scripts/bench.py exited {r.returncode}")
    line = r.stdout.strip().splitlines()[-1]
    rec = json.loads(line)
    log(f"6e the port's bench (scripts/bench.py, b256/a32, remat dots): {line}; on {card}")
    if not (math.isfinite(rec["loss"]) and rec["value"] > 0
            and rec["device_kind"] == torch.cuda.get_device_name(0)):
        raise AssertionError(f"the bench's record is not a reading of this card: {rec}")


def elastic_worker(card: str, phase4: dict, cold: dict) -> dict:
    """Phase 8 (see the module docstring). Returns the worker's launches,
    summed over both generations; puts the switch's seconds (``switch_s``)
    and the restore's (``restore_s``: with and without the check's hash)
    into ``cold``."""
    work = tempfile.mkdtemp(prefix="chip_smoke_worker_")
    counts_dir = os.path.join(work, "counts")
    os.makedirs(counts_dir)
    metrics, tl = os.path.join(work, "metrics-a0.jsonl"), os.path.join(work, "timeline-a0.jsonl")
    with open(os.path.join(work, "job.json"), "w") as f:
        json.dump(WORKER_JOB, f)
    try:
        with Phase("8 (the elastic worker, two generations)"):
            for gen in (1, 2):
                iw.run_generation(counts_dir, work, gen=gen, deadline_s=WORKER_DEADLINE_S,
                                  quiesce_at=WORKER_QUIESCE_AT if gen == 1 else None)
            records = read_jsonl(metrics)
            by_gen = {g: [r for r in records if r["generation"] == g] for g in (1, 2)}
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
            failures = []
            if [r["step"] for r in records] != list(range(1, WORKER_JOB["total_steps"] + 1)):
                failures.append(f"steps {[r['step'] for r in records]}: work lost or repeated")
            if by_gen[2][0]["step"] != q + 1:
                failures.append(f"generation 2 starts at {by_gen[2][0]['step']}, not {q + 1}")
            if q not in mgr.steps() or not os.path.exists(os.path.join(work, "DONE")):
                failures.append(f"committed {mgr.steps()}, DONE "
                                f"{os.path.exists(os.path.join(work, 'DONE'))}")
            bad_keys = [r for r in records if set(r) != WORKER_KEYS]
            if bad_keys:
                failures.append(f"records without the protocol's keys: {bad_keys[:2]}")
            for g, steps in ((1, q), (2, WORKER_JOB["total_steps"] - q)):
                want = N_LAYERS * MICROBATCHES * steps
                if launches[g] != fa.expected_launches(bf16=want):
                    failures.append(f"generation {g} launched {launches[g]}, want {want} each")
            if not (saved and [h["step"] for h in restored] == [q]
                    and iw.hashed_state(restored[0]) == iw.hashed_state(saved[0])):
                failures.append(f"the state restored at step {q} is not the one saved "
                                f"({len(saved)} saves, restores at {[h['step'] for h in restored]})")
            if abs(by_gen[1][0]["loss"] - phase4["losses"][0]) > DIST_LOSS_ABS:
                failures.append(f"generation 1's first loss {by_gen[1][0]['loss']} vs phase 4's "
                                f"{phase4['losses'][0]}")
            # the same step in this process, from the same checkpoint and batch
            bundle = gpt345m.bundle()
            trainer = gpt345m.trainer(bundle, optimizer=functools.partial(torch.optim.Adam,
                                                                          lr=WORKER_JOB["lr"]))
            state = trainer.restore_from(mgr, q)
            _, m = trainer.train_step(state, next(iter(bundle.make_data(gpt345m.GLOBAL_BATCH,
                                                                        seed=0))))
            in_process = float(m["loss"])
            del state, trainer
            if abs(by_gen[2][0]["loss"] - in_process) > DIST_LOSS_ABS:
                failures.append(f"generation 2's first loss {by_gen[2][0]['loss']} vs "
                                f"{in_process} in process")
            timed = [r for g in (1, 2) for r in by_gen[g][1:]]  # each generation's first: warm-up
            step_s = statistics.mean(r["step_time_s"] for r in timed)
            report = {"step_s": step_s, "tokens_per_s": gpt345m.GLOBAL_BATCH * gpt345m.SEQ / step_s,
                      "mfu": statistics.mean(r["mfu"] for r in timed)}
            log(f"8 elastic worker: quiesced at step {q} (SIGUSR1 at step {WORKER_QUIESCE_AT}), "
                f"generation 2 restored it and trained steps {by_gen[2][0]['step']}-"
                f"{by_gen[2][-1]['step']}; losses {[r['loss'] for r in records]} (phase 4's first "
                f"{phase4['losses'][0]}, in process from step {q} {in_process}); launches by "
                f"generation {launches}; committed steps {mgr.steps()}; the state saved and restored "
                f"at step {q}: {len(iw.hashed_state(saved[0])) - 1 if saved else 0} tensors and "
                f"counts hashed; seconds the hashes took (not the worker's own): "
                f"{[(h['kind'], h['step'], round(h['hash_s'], 2)) for h in states[1] + states[2]]}")
            log("8 worker step (mean of steps after each generation's first): " + ", ".join(
                f"{k} {report[k]:.4f} (phase 4 {phase4[k]:.4f})" for k in report)
                + f"; step times {[round(r['step_time_s'], 4) for r in records]}; on {card}")
            log("8 generation switch, seconds from quiesce_ckpt_begin (and from the phase "
                f"before): {iw.switch(tl)}")
            at = iw.switch_phases(tl, 2)
            cold.update(switch_s=at["first_step_done"] - at["quiesce_ckpt_begin"],
                        restore_s=restore_seconds(tl, states[2], 2))
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
                tokens: int = FILE_TOKENS, n_layers: int = N_LAYERS,
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

    args, env = ["--device", device], {"EASYDL_CHAOS_SPEC": spec}
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
            wait_until(lambda: steps_of(2), "generation 2 step", standby)
            coord3 = f"localhost:{iw.free_port()}"
            preflight, go_file = iw.start_gated(
                counts_dir, work, "go", args=args, hashes=False,
                env={**env, **iw.generation_env(work, gen=3, coord=coord3)})
            procs.append(preflight)
            wait_until(lambda: os.path.exists(go_file + ".ready"), "ready preflight", preflight)
            standby.send_signal(signal.SIGUSR1)
            exited(standby, "generation 2 (the promoted standby)")
            straggle(None)
            iw.promote(go_file, {"generation": 3, "coordinator": coord3})
            exited(preflight, "generation 3 (the promoted preflight)")
            pod = subprocess.run(
                [sys.executable, "-m", "easydl_tpu_torch.elastic.evaluator_main", "--workdir",
                 work, "--device", device, "--batches-per-eval", "1"],
                capture_output=True, text=True, timeout=FILE_DEADLINE_S, cwd=iw.REPO,
                env=dict(os.environ, PYTHONPATH=str(iw.REPO)))
            if pod.returncode:
                print(pod.stderr[-4000:], file=sys.stderr)
                raise AssertionError(f"9: the evaluator pod exited {pod.returncode}")

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
    procs = []

    def steps_of(g: int) -> list:
        return [r for r in read_jsonl(metrics) if r["generation"] == g]

    def fail(msg: str) -> None:
        with open(os.path.join(work, "worker-a0.log"), errors="replace") as f:
            print(f"--- the workers' log:\n{f.read()[-6000:]}", file=sys.stderr)
        raise AssertionError(f"10d: {msg}")

    try:
        args = ["--device", device]
        gen1 = iw.start(counts_dir, work, gen=1, coord=f"localhost:{iw.free_port()}", args=args)
        procs.append(gen1)
        end = time.monotonic() + BERT_DEADLINE_S
        while not (len(steps_of(1)) >= BERT_KILL_AT and 2 in mgr.steps()):
            if gen1.poll() is not None or time.monotonic() > end:
                fail(f"generation 1 reached no step {BERT_KILL_AT} after a committed save of "
                     f"step 2 (rc {gen1.poll()})")
            time.sleep(0.05)
        os.killpg(gen1.pid, signal.SIGKILL)
        t_kill = time.time()
        gen1.wait()
        killed = {r["step"]: r["loss"] for r in steps_of(1)}
        saved = mgr.steps()[-1]
        gen2 = iw.start(counts_dir, work, gen=2, coord=f"localhost:{iw.free_port()}", args=args)
        procs.append(gen2)
        try:
            rc = gen2.wait(timeout=BERT_DEADLINE_S)
        except subprocess.TimeoutExpired:
            rc = None
        if rc != 0:
            fail(f"generation 2 exited {rc}")

        records = read_jsonl(metrics)
        total = job["total_steps"]
        replayed = [s for s in killed if s > saved]
        again = {r["step"]: r["loss"] for r in steps_of(2)}
        failures = []
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
            f"{len(replayed)} steps replayed; on {card}")
        if failures:
            raise AssertionError("10d: " + "; ".join(failures))
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
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
        rc = subprocess.run([sys.executable, os.path.abspath(__file__), "--bert", card, out],
                            timeout=BERT_DEADLINE_S).returncode
        if rc:
            raise AssertionError(f"10a-10c exited {rc}")
        with open(out) as f:
            res = json.load(f)
    finally:
        os.remove(out)
    phases = {"10b": res["launches"]}
    with Phase("10d (BERT-base worker, SIGKILL and replay)"):
        phases["10d"] = bert_preemption(card)
    return res["rows"], phases


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
    losses, norms, step_s, counts, peak_gib = train_timed(trainer, state, data)
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
    phases = {"4": counts, **bench_configuration(kind, card, phase4)}
    gc.collect()
    torch.cuda.empty_cache()
    with Phase("6e (the port's bench)"):
        port_bench(card)

    # -- 7. the distributed path, with phase 6's objects freed
    gc.collect()
    torch.cuda.empty_cache()
    with Phase("7a (NCCL, world 1)"):
        phases["7a"] = nccl_world1(kind, card, {**phase4, "counts": counts})
    gc.collect()
    torch.cuda.empty_cache()
    phases["7b"] = two_ranks(phase4)

    # -- 8. the elastic worker under an emulated agent, with phase 7's objects freed
    gc.collect()
    torch.cuda.empty_cache()
    cold = {}
    clear_chunk_cache()
    phases["8"] = elastic_worker(card, phase4, cold)

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

    # -- 11. summary
    for r in rows:
        r["launches"] = counts[r["name"]]
    for r in f32_rows:
        r["launches"] = phases["10b"][r["name"]]
    rows += f32_rows
    for r in rows:
        r["launches_by_phase"] = {p: c[r["name"]] for p, c in phases.items()}
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
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(int(sys.argv[2]), sys.argv[3]))
    if sys.argv[1:2] == ["--bert"]:
        sys.exit(bert_train(sys.argv[2], sys.argv[3]))
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
    sys.exit(rc)
