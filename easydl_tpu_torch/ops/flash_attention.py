"""Flash attention (forward + backward): hand-written CUDA kernels for Hopper,
and the plain PyTorch version of each.

Counterpart of ``easydl_tpu/ops/flash_attention.py``. Three kernels replace
its three Pallas kernels:

- ``flash_fwd``: one q-tile against streamed K/V tiles with an online softmax;
  writes O and the row logsumexp ``lse``;
- ``flash_bwd_dq``: computes Δ = rowsum(dO∘O) for its q-tile, then recomputes
  P = exp(q·kᵀ·scale − lse) per live K-tile and accumulates dq; returns Δ
  for dk/dv;
- ``flash_bwd_dkv``: per K-tile, loops the q-tiles that can see it and
  accumulates dk and dv.

In bf16, GPT's training path, all three are tensor-core kernels (``wgmma``
fed by TMA: ``ops/csrc/flash_fwd_sm90.cu``, ``ops/csrc/flash_bwd_dq_sm90.cu``,
``ops/csrc/flash_bwd_dkv_sm90.cu``) that round P and dS to bf16 before their
second product, as the TPU kernel's default-precision dot does. In f32,
BERT's path, all three are tensor-core kernels too, every product in 3xTF32
(each f32 operand split into two TF32 parts, three ``mma.sync`` products,
f32-level accuracy: ``ops/csrc/flash_fwd_f32_sm90.cu``,
``ops/csrc/flash_bwd_f32_sm90.cu``, their shared parts in
``ops/csrc/tf32x3.cuh``). All are built into one library and reached through
the C entry points of ``ops/csrc/flash_attention.cu``.

The rowwise ``delta = Σ dO∘O``, an einsum in front of the JAX package's
kernels, is computed inside the dq kernel, which already holds dO for its
rows, and written out for dk/dv; ``attention_delta`` is its plain version.

Each wrapper takes the kernel for a CUDA tensor and the plain version for a
CPU tensor, and only the tensor's device decides: on a CUDA tensor it
launches the kernel or raises. Each kernel launch adds one to its count in
:data:`launches`: the bf16 tensor-core kernel's under the wrapper's name
(``flash_fwd``), the f32 kernel's with ``_f32`` (``flash_fwd_f32``);
the plain versions count nothing.

Public shapes: [batch, seq, heads, head_dim]; the kernels run on a
contiguous [batch·heads, seq, head_dim] view.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from easydl_tpu_torch.ops import build
from easydl_tpu_torch.ops.attention import NEG_INF, reference_attention

KERNEL_SOURCES = ("flash_attention.cu", "flash_fwd_sm90.cu", "flash_bwd_dq_sm90.cu",
                  "flash_bwd_dkv_sm90.cu", "flash_fwd_f32_sm90.cu", "flash_bwd_f32_sm90.cu")
HEAD_DIMS = (32, 64)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535

WRAPPERS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
#: the kernels' counts in :data:`launches`, by the dtype they take
KERNELS = {torch.bfloat16: WRAPPERS, torch.float32: tuple(n + "_f32" for n in WRAPPERS)}
#: CUDA kernel launches since the last :func:`reset_launches`, by kernel
launches: Dict[str, int] = {k: 0 for names in KERNELS.values() for k in names}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def expected_launches(**per_kernel: int) -> Dict[str, int]:
    """:data:`launches` of a run that launched each kernel of a dtype
    (``bf16=``, ``f32=``) that many times and no other kernel."""
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    want = dict.fromkeys(launches, 0)
    for dtype, n in per_kernel.items():
        want.update(dict.fromkeys(KERNELS[dtypes[dtype]], n))
    return want


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load(KERNEL_SOURCES)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.easydl_flash_fwd.argtypes = [I, I, P, P, P, P, P, I, I, I, I, F, P]
    lib.easydl_flash_bwd_dq.argtypes = [I, I, P, P, P, P, P, P, P, P, I, I, I, I, F, P]
    lib.easydl_flash_bwd_dkv.argtypes = [I, I, P, P, P, P, P, P, P, P, I, I, I, I, F, P]
    for fn in (lib.easydl_flash_fwd, lib.easydl_flash_bwd_dq, lib.easydl_flash_bwd_dkv):
        fn.restype = I
    lib.easydl_flash_sm90_ctas_per_sm.argtypes = [I, I]
    lib.easydl_flash_sm90_ctas_per_sm.restype = I
    lib.easydl_cuda_error_string.argtypes = [I]
    lib.easydl_cuda_error_string.restype = ctypes.c_char_p
    return lib


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the reference for the kernels on the card)
# ---------------------------------------------------------------------------


def _scores(q, k, causal: bool, scale: float) -> torch.Tensor:
    """f32 q·kᵀ·scale; hidden positions (bottom-right causal) at NEG_INF."""
    s = torch.matmul(q.float() * scale, k.float().transpose(1, 2))
    if causal:
        s_q, s_k = q.shape[1], k.shape[1]
        mask = torch.ones(s_q, s_k, dtype=torch.bool, device=q.device).tril(s_k - s_q)
        s = s.masked_fill(~mask, NEG_INF)
    return s


def flash_fwd_plain(q, k, v, causal: bool, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O, lse) of ``_fwd_kernel``: rows that see no key give O = 0 and
    lse = +|NEG_INF|, so the backward's exp(s − lse) is 0 for them."""
    s = _scores(q, k, causal, scale)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    dead = m <= NEG_INF * 0.5
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.where(dead, 0.0, torch.matmul(p, v.float()) / l)
    lse = torch.where(dead, -NEG_INF, m + torch.log(l))
    return o.to(q.dtype), lse.squeeze(-1)


def _probs_and_dscores(q, k, v, do, lse, delta, causal, scale):
    p = torch.exp(_scores(q, k, causal, scale) - lse[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(1, 2))
    return p, p * (dp - delta[..., None])


def attention_delta(do: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """Δ = rowsum(dO∘O) in f32, [bh, s_q]."""
    return (do.float() * o.float()).sum(-1)


def flash_bwd_dq_plain(q, k, v, o, do, lse, causal: bool, scale: float):
    """(dq, Δ) of ``_bwd_dq_kernel`` and the einsum in front of it."""
    delta = attention_delta(do, o)
    _, ds = _probs_and_dscores(q, k, v, do, lse, delta, causal, scale)
    return (torch.matmul(ds, k.float()) * scale).to(q.dtype), delta


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool, scale: float):
    p, ds = _probs_and_dscores(q, k, v, do, lse, delta, causal, scale)
    dv = torch.matmul(p.transpose(1, 2), do.float())
    # q·scale is the operand, as in the kernel: dk needs no further scale
    dk = torch.matmul(ds.transpose(1, 2), q.float() * scale)
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _on_cpu(*tensors: torch.Tensor) -> bool:
    devices = {t.device.type for t in tensors}
    if devices == {"cpu"}:
        return True
    if devices != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(
            f"flash attention needs all tensors on the CPU or on one CUDA "
            f"device, got {sorted(str(t.device) for t in tensors)}")
    return False


def _check(q, k, v, like_q=(), rows=()) -> None:
    """like_q: tensors shaped and typed as q (O, dO); rows: f32 [bh, s_q]
    (lse, Δ)."""
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash kernels take float32 or bfloat16, got {q.dtype}")
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"want q [bh,s_q,d], k = v [bh,s_k,d]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    bh, s_q, d = q.shape
    if k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in the kernels' instantiations {HEAD_DIMS}")
    if min(bh, s_q, k.shape[1]) < 1 or bh > _MAX_GRID_Y:
        raise ValueError(f"empty or oversized attention: bh={bh} s_q={s_q} s_k={k.shape[1]}")
    for t in (k, v, *like_q):
        if t.dtype != q.dtype:
            raise ValueError(f"dtype mismatch: {t.dtype} vs q {q.dtype}")
    for t in like_q:
        if t.shape != q.shape:
            raise ValueError(f"O/dO {tuple(t.shape)} != q {tuple(q.shape)}")
    for t in rows:
        if t.dtype != torch.float32 or t.shape != (bh, s_q):
            raise ValueError(f"lse/delta must be float32 [{bh},{s_q}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    for t in (q, k, v, *like_q, *rows):
        if not t.is_contiguous():
            raise ValueError("flash kernels take contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError("flash kernels take 16-byte aligned tensors (TMA, cp.async)")


def _launch(name: str, fn, q, *args) -> None:
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*args, ctypes.c_void_p(stream))
    if err != 0:
        msg = _lib().easydl_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel failed: CUDA error {err} ({msg})")
    launches[KERNELS[q.dtype][WRAPPERS.index(name)]] += 1


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def flash_fwd(q, k, v, causal: bool, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O, lse) over [bh, s, d]; lse is [bh, s_q] f32."""
    if _on_cpu(q, k, v):
        return flash_fwd_plain(q, k, v, causal, scale)
    _check(q, k, v)
    bh, s_q, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, s_q), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", _lib().easydl_flash_fwd, q,
            _DTYPE_CODE[q.dtype], d, _ptr(q), _ptr(k), _ptr(v), _ptr(o), _ptr(lse),
            bh, s_q, k.shape[1], int(causal), float(scale))
    return o, lse


def flash_bwd_dq(q, k, v, o, do, lse, causal: bool, scale: float):
    """(dq, Δ): Δ = rowsum(dO∘O) is [bh, s_q] f32, the input of
    :func:`flash_bwd_dkv`."""
    if _on_cpu(q, k, v, o, do, lse):
        return flash_bwd_dq_plain(q, k, v, o, do, lse, causal, scale)
    _check(q, k, v, like_q=(o, do), rows=(lse,))
    bh, s_q, d = q.shape
    dq = torch.empty_like(q)
    delta = torch.empty((bh, s_q), dtype=torch.float32, device=q.device)
    _launch("flash_bwd_dq", _lib().easydl_flash_bwd_dq, q,
            _DTYPE_CODE[q.dtype], d, _ptr(q), _ptr(k), _ptr(v), _ptr(o), _ptr(do),
            _ptr(lse), _ptr(delta), _ptr(dq), bh, s_q, k.shape[1], int(causal), float(scale))
    return dq, delta


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool, scale: float):
    if _on_cpu(q, k, v, do, lse, delta):
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, scale)
    _check(q, k, v, like_q=(do,), rows=(lse, delta))
    bh, s_q, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_bwd_dkv", _lib().easydl_flash_bwd_dkv, q,
            _DTYPE_CODE[q.dtype], d, _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse),
            _ptr(delta), _ptr(dk), _ptr(dv), bh, s_q, k.shape[1], int(causal), float(scale))
    return dk, dv


class FlashAttention(torch.autograd.Function):
    """Counterpart of the JAX ``_flash`` custom_vjp over [bh, s, d] tensors:
    saves (q, k, v, O, lse) and runs the two backward kernels; dq's kernel
    computes Δ and hands it to dk/dv's."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        o, lse = flash_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        dq, delta = flash_bwd_dq(q, k, v, o, do, lse, ctx.causal, ctx.scale)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Flash attention over [batch, seq, heads, head_dim] tensors.

    A segment mask goes to the reference path, as in the JAX package; the
    kernels mask ragged lengths themselves, so no length needs a fallback."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if segment_ids is not None:
        return reference_attention(q, k, v, causal=causal, scale=scale,
                                   segment_ids=segment_ids)
    b, s, h, d = q.shape
    s_k = k.shape[1]

    def to_bh(x, sl):  # [B, S, H, d] -> contiguous [B*H, S, d]
        return x.transpose(1, 2).reshape(b * h, sl, d).contiguous()

    out = FlashAttention.apply(to_bh(q, s), to_bh(k, s_k), to_bh(v, s_k),
                               causal, float(scale))
    return out.reshape(b, h, s, d).transpose(1, 2)
