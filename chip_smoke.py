#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``easydl_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

1. device: a CUDA GPU must be present; prints its ``nvidia-smi`` name and
   power limit;
2. build: compiles the flash-attention kernels from
   ``easydl_tpu_torch/ops/csrc/`` with ``nvcc`` (one process per source, all
   at once) and prints the build time, each kernel's registers and spills
   and, where the toolkit has ``cuobjdump``, its count of ``HGMMA`` (wgmma)
   and ``UTMALDG`` (TMA load) instructions; fails if a tensor-core kernel
   spills or shows none of either;
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
8. summary: a ``kernels`` JSON line (with each phase's launches, 7b's
   summed over its ranks and runs), the card line, then the result line.

Each phase prints its seconds.

Imports only the port, torch and numpy.
"""

from __future__ import annotations

import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

from easydl_tpu_torch.core.checkpoint import CheckpointManager
from easydl_tpu_torch.core.evaluator import Evaluator
from easydl_tpu_torch.core.train_loop import fsdp_params
from easydl_tpu_torch.core.mfu import mfu, peak_flops_per_chip
from easydl_tpu_torch.models.gpt import lm_loss
from easydl_tpu_torch.ops import build
from easydl_tpu_torch.ops import flash_attention as fa
from easydl_tpu_torch.ops.attention import reference_attention
from easydl_tpu_torch.scripts import gpt345m
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
CSRC = "easydl_tpu_torch/ops/csrc/"
SOURCE = {
    "flash_fwd": CSRC + "flash_fwd_sm90.cu",
    "flash_bwd_dq": CSRC + "flash_bwd_dq_sm90.cu",
    "flash_bwd_dkv": CSRC + "flash_bwd_dkv_sm90.cu",
}
# the tensor-core kernels, which must show wgmma (HGMMA) and TMA loads
# (UTMALDG) in their SASS and no ptxas spills
SM90_KERNELS = ("flash_fwd_sm90_kernel", "flash_bwd_dkv_sm90_kernel",
                "flash_bwd_dq_sm90_kernel")
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
    m = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)(?:_sm90)?_kernel)I(f|13__nv_bfloat16)?Li(\d+)E",
                  mangled)
    if not m:
        return mangled
    dtype = {"f": "f32", "13__nv_bfloat16": "bf16", None: "bf16"}[m.group(2)]
    return f"{m.group(1)}<{dtype}, {m.group(3)}>"


def sass_counts(lib_path) -> dict:
    """{kernel: (HGMMA, UTMALDG)} instruction counts in the library's SASS,
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
            counts[name] = [0, 0]
        elif name:
            counts[name][0] += "HGMMA" in line
            counts[name][1] += "UTMALDG" in line
    return counts


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


def check_kernels(bh, s_q, s_k, d, dtype, causal, seed, timed, peak_flops=None):
    """Each kernel against its plain version on the same card inputs and
    against autograd of the reference attention on their f32 upcast; every
    reading is printed before a failure is raised."""
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
    heads = (bh // 16, 16)
    qs, ks, vs = (x.view(*heads, -1, d).detach().requires_grad_() for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    lib_fwd = device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True))
    lib_bwd = device_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), do.view_as(out),
                                                    retain_graph=True))
    for what, (ms, names) in (("forward", lib_fwd), ("backward", lib_bwd)):
        log(f"sdpa {what}: {ms:.4f} ms of device time a call (torch.profiler) in "
            + "; ".join(n[:60] for n in names))
    # the same calls timed as the kernels are: a window whose host time per
    # call exceeds its device time per call timed the host, not the card
    win_fwd = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True))
    win_bwd = cuda_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), do.view_as(out),
                                                  retain_graph=True))
    log(f"sdpa in windows of back-to-back calls: forward {win_fwd[0]:.4f} ms (host "
        f"{win_fwd[1]:.4f}), backward {win_bwd[0]:.4f} ms (host {win_bwd[1]:.4f})")
    rows, host = [], {}
    for name, (kern, plain) in calls.items():
        b_ms, b_by = bound(name, bh, s_q, s_k, d, causal, q.element_size(), peak_flops)
        ms, host[name] = cuda_ms(kern)
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE[name], "replaces": REPLACES[name],
            "max_abs_err": errs[name], "ms": ms,
            "plain_ms": cuda_ms(plain, calls=2, windows=3)[0],
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": (lib_fwd if name == "flash_fwd" else lib_bwd)[0],
        })
    log("host ms per call while the windows were issued: "
        + ", ".join(f"{n} {t:.4f}" for n, t in host.items()))
    return rows


def build_kernels() -> None:
    """Builds the kernels' library; prints each kernel's registers and
    spills (ptxas) and, where cuobjdump exists, its HGMMA and UTMALDG count;
    fails if a tensor-core kernel spills or shows no wgmma or TMA load."""
    t0 = time.perf_counter()
    path, nvcc_log = build.build(fa.KERNEL_SOURCES)
    log(f"build: {path.name} from {', '.join(fa.KERNEL_SOURCES)} in "
        f"{time.perf_counter() - t0:.1f}s")
    ptxas, sass = ptxas_report(nvcc_log), sass_counts(path)
    for name, (regs, st, ld) in sorted(ptxas.items()):
        counts = sass.get(name)
        log(f"  {name}: {regs} registers, spill stores {st} B, loads {ld} B"
            + (f"; SASS: {counts[0]} HGMMA, {counts[1]} UTMALDG" if counts else ""))
    lib = fa._lib()
    log("  CTAs per SM: " + ", ".join(
        f"{kernel}<bf16, {d}> {lib.easydl_flash_sm90_ctas_per_sm(i, d)}"
        for i, kernel in enumerate(SM90_KERNELS) for d in fa.HEAD_DIMS))
    if not nvcc_log:
        log("  (the library was built before: no ptxas report)")
    if not sass:
        log("  (no cuobjdump in this toolkit: SASS not counted)")
    for kernel in SM90_KERNELS:
        mine = [n for n in ptxas if n.startswith(kernel + "<")]
        if nvcc_log and (not mine or any(ptxas[n][1] or ptxas[n][2] for n in mine)):
            raise AssertionError(f"{kernel}: missing from ptxas's report or spills: "
                                 f"{ {n: ptxas[n] for n in mine} }")
        in_sass = [n for n in sass if n.startswith(kernel + "<")]
        if sass and not (in_sass and all(sass[n][0] and sass[n][1] for n in in_sass)):
            raise AssertionError(f"{kernel}: no HGMMA or no UTMALDG in its SASS")


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
        return {"device": spans, "host": ranges}
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
    return {"device": spans, "host": ranges}


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
        want = {"flash_fwd": 2 * per_call, "flash_bwd_dq": per_call, "flash_bwd_dkv": per_call}
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

            def with_loss(module, batch):
                loss, _ = bundle.eval_fn(module, batch)
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


def whole(t: torch.Tensor) -> torch.Tensor:
    """``t`` whole on every rank (every rank calls this together): the shards
    of a sharded tensor all-gathered with the c10d collective, since
    ``DTensor.full_tensor``'s functional collectives crash (SIGSEGV) over
    gloo on CUDA tensors in torch 2.11."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(t, DTensor):
        return t
    local = t.to_local().detach()
    shards = [(pl.dim, m) for m, pl in enumerate(t.placements) if isinstance(pl, Shard)]
    if not shards:
        return local
    (dim, m), = shards
    parts = [torch.empty_like(local) for _ in range(t.device_mesh.size(m))]
    dist.all_gather(parts, local.contiguous(), group=t.device_mesh.get_group(m))
    out = torch.cat(parts, dim=dim)
    if out.shape != t.shape:
        raise AssertionError(f"uneven shards: {tuple(out.shape)} gathered, {tuple(t.shape)} held")
    return out


def state_hashes(state) -> dict:
    """sha256 of every parameter and Adam moment, whole (a sharded tensor is
    gathered first: every rank calls this together), and the Adam step."""
    import hashlib

    out = {"step": state.step}
    opt = state.optimizer.state
    for name, p in state.model.named_parameters():
        for kind, t in (("", p), (" exp_avg", opt[p]["exp_avg"]),
                        (" exp_avg_sq", opt[p]["exp_avg_sq"])):
            data = whole(t).detach().cpu().numpy().tobytes()
            out[name + kind] = hashlib.sha256(data).hexdigest()
        out[name + " count"] = int(opt[p]["step"])
    return out


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
                    if counts != {k: per_rank for k in counts}:
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
    if counts != {name: want for name in counts}:
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

    # -- 7. the distributed path, with phase 6's objects freed
    gc.collect()
    torch.cuda.empty_cache()
    with Phase("7a (NCCL, world 1)"):
        phases["7a"] = nccl_world1(kind, card, {**phase4, "counts": counts})
    gc.collect()
    torch.cuda.empty_cache()
    phases["7b"] = two_ranks(phase4)

    # -- 8. summary
    for r in rows:
        r["launches"] = counts[r["name"]]
        r["launches_by_phase"] = {p: c[r["name"]] for p, c in phases.items()}
    log(json.dumps({"kernels": rows}))
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(int(sys.argv[2]), sys.argv[3]))
    sys.exit(main())
